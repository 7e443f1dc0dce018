"""Weights of the port: reference-named state dicts and seeded init.

The port's modules carry the reference torch parameter names, the names
that gdm_tpu.train.import_torch.export_state_dict emits from the JAX
package's (params, batch_stats).  :func:`load_reference_state_dict` loads
such a dict (numpy or tensors) with ``strict=True``.  Two reference
layouts need care:

  * ``cnn.final`` is one module under two slots (ffb6d.py:76-81), so
    reference dicts hold its tensors under ``cnn_up_stages.2.0.0.*`` and
    ``cnn_up_stages.3.1.0.*``; the port registers it once, at 2.0.0, and
    takes the duplicate only when the first name is missing;
  * the DGCNN variant registers each edge conv's BN twice, as ``bnN`` and
    inside ``convN`` (dgcnn.py:67-100), so reference dicts hold it under
    ``{pcd_emb,model_emb}.bnN.*`` and ``.convN.1.*``; the port registers
    ``convN.1`` and folds ``bnN`` the same way;
  * point convs of torch checkpoints are stored as [out, in, 1] or
    [out, in, 1, 1]; the port's [out, in] takes them with their trailing
    unit dimensions dropped.  Any other shape difference raises, so a
    transposed or reordered weight never loads scrambled.

BatchNorm ``num_batches_tracked`` buffers are part of the port's state
and load like any other entry.  ``awl.params``, the loss weighting, exists
only in a training model (GeoMatch(awl=True)); an eval model leaves it
out of a checkpoint it loads.
"""

from __future__ import annotations

import math
import os.path as osp

import numpy as np
import torch
from torch import nn

from gdm_tpu_torch.losses.awl import AutomaticWeightedLoss
from gdm_tpu_torch.models.layers import BatchNorm
from gdm_tpu_torch.models.pspnet import PReLU

# duplicate name -> the name the port registers
ALIASES = {
    "pcd_emb.cnn_up_stages.3.1.0.weight": "pcd_emb.cnn_up_stages.2.0.0.weight",
    "pcd_emb.cnn_up_stages.3.1.0.bias": "pcd_emb.cnn_up_stages.2.0.0.bias",
}
ALIASES.update({
    f"{root}.bn{n}.{leaf}": f"{root}.conv{n}.1.{leaf}"
    for root in ("pcd_emb", "model_emb") for n in range(1, 9)
    for leaf in ("weight", "bias", "running_mean", "running_var",
                 "num_batches_tracked")})
# entries of a training checkpoint that an eval model does not hold
TRAIN_ONLY = ("awl.params",)


def read_reference_checkpoint(dir_or_file: str) -> dict:
    """The reference-named state dict of a reference checkpoint:
    ``<dir>/geomatch.pth.tar`` (train_lm.py:331-340) or the file itself,
    read with ``weights_only=True`` (a state dict needs no pickled code),
    under its ``model_state`` key when it has one.

    The JAX package imports such a file with ``strict=False`` and keeps
    its init for missing leaves; the port has no trained init to keep, so
    :func:`load_reference_state_dict` raises on a missing key."""
    path = dir_or_file
    if osp.isdir(path):
        path = osp.join(path, "geomatch.pth.tar")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("model_state", blob)


def load_reference_state_dict(module: nn.Module, state: dict) -> None:
    """Load a reference-named state dict into ``module``, strictly.

    Raises on a missing or unexpected key (aliases, and training-only
    entries for a module without them, excepted) and on a shape that does
    not match (unit dimensions of a point conv excepted)."""
    module.load_state_dict(to_port_names(module, state), strict=True)


def to_port_names(module: nn.Module, state: dict) -> dict:
    """A reference-named dict (numpy or tensors) as tensors under the
    names and shapes of ``module.state_dict()``: the duplicate names
    folded, point-conv unit dimensions dropped,
    training-only entries dropped when ``module`` lacks them."""
    own = module.state_dict()
    out = {}
    for key, val in state.items():
        if key in ALIASES:
            if ALIASES[key] in state:
                continue
            key = ALIASES[key]
        if key in TRAIN_ONLY and key not in own:
            continue
        t = val if isinstance(val, torch.Tensor) \
            else torch.tensor(np.asarray(val))
        if key in own and own[key].dim() == 2 and t.dim() > 2 \
                and t.shape[:2] == own[key].shape \
                and all(d == 1 for d in t.shape[2:]):
            t = t.reshape(own[key].shape)
        out[key] = t
    return out


def reference_state_dict(module: nn.Module) -> dict:
    """``module``'s state dict (CPU tensors) under the reference names,
    each shared module (``cnn.final``, DGCNN's ``bnN``) under both of its
    names, as the reference's own checkpoints hold it."""
    sd = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
    for dup, name in ALIASES.items():
        if name in sd:
            sd[dup] = sd[name]
    return sd


def load_train_state(model: nn.Module, optimizer, model_state: dict,
                     optimizer_state: dict) -> None:
    """Load reference-named weights and optimizer state (numpy or
    tensors; train/state.py's state dict layout) into a training model
    and its optimizer: the model strictly, Adam's mu and nu under the
    same names with the same layout handling.  A JAX TrainState carries
    over this way, its params, batch_stats and Adam moments exported to
    reference names by gdm_tpu.train.import_torch.export_state_dict, its
    count and apply_if_finite counters as they are."""
    load_reference_state_dict(model, model_state)
    opt = dict(optimizer_state)
    for k in ("mu", "nu"):
        opt[k] = to_port_names(model, opt[k])
    optimizer.load_state_dict(opt)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init, in place: every weight of rank >= 2 from
    N(0, 1/fan_in) (fan_in = product of all dims but the output one),
    biases 0, BN identity statistics, PReLU 0.25, loss weights 1.  The
    generator is the only source of randomness, so one seed gives the
    same weights on every device."""
    for mod in module.modules():
        if isinstance(mod, AutomaticWeightedLoss):
            mod.params.fill_(1.0)
            continue
        if isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
            continue
        if isinstance(mod, PReLU):
            mod.weight.fill_(0.25)
            continue
        for name, p in mod.named_parameters(recurse=False):
            if p.dim() < 2:
                p.zero_()
                continue
            # torch layouts: [out, in, ...]; SplineConv weight
            # [S, in, out] and root [in, out] keep `out` last
            out_dim = -1 if name == "root" or p.dim() == 3 else 0
            fan_in = p.numel() // p.shape[out_dim]
            w = torch.randn(p.shape, generator=generator,
                            device=generator.device)
            p.copy_(w / math.sqrt(fan_in))

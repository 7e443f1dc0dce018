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
  * point convs of torch checkpoints are stored as [out, in, 1] or
    [out, in, 1, 1]; the port's [out, in] takes them with their trailing
    unit dimensions dropped.  Any other shape difference raises, so a
    transposed or reordered weight never loads scrambled.

BatchNorm ``num_batches_tracked`` buffers are part of the port's state
and load like any other entry.
"""

from __future__ import annotations

import math
import os.path as osp

import numpy as np
import torch
from torch import nn

from gdm_tpu_torch.models.layers import BatchNorm
from gdm_tpu_torch.models.pspnet import PReLU

# duplicate name -> the name the port registers
ALIASES = {
    "pcd_emb.cnn_up_stages.3.1.0.weight": "pcd_emb.cnn_up_stages.2.0.0.weight",
    "pcd_emb.cnn_up_stages.3.1.0.bias": "pcd_emb.cnn_up_stages.2.0.0.bias",
}


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

    Raises on a missing or unexpected key (aliases excepted) and on a
    shape that does not match (unit dimensions of a point conv
    excepted)."""
    own = module.state_dict()
    out = {}
    for key, val in state.items():
        if key in ALIASES:
            if ALIASES[key] in state:
                continue
            key = ALIASES[key]
        t = val if isinstance(val, torch.Tensor) \
            else torch.tensor(np.asarray(val))
        if key in own and own[key].dim() == 2 and t.dim() > 2 \
                and t.shape[:2] == own[key].shape \
                and all(d == 1 for d in t.shape[2:]):
            t = t.reshape(own[key].shape)
        out[key] = t
    module.load_state_dict(out, strict=True)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init, in place: every weight of rank >= 2 from
    N(0, 1/fan_in) (fan_in = product of all dims but the output one),
    biases 0, BN identity statistics, PReLU 0.25.  The generator is the
    only source of randomness, so one seed gives the same weights on
    every device."""
    for mod in module.modules():
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

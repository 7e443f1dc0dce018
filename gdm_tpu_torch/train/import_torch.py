"""ImageNet init of the CNN branch from a torchvision ResNet checkpoint
(counterpart of gdm_tpu/train/import_torch.py's
``import_torchvision_resnet``, ``read_torchvision_state`` and
``load_pretrained_backbone``; ``cli train --pretrained-backbone``).

The reference trains its CNN branch from these weights
(models/cnn/pspnet.py:50-53 ``pretrained=True``) but loads them
positionally (extractors.py:25-29 zips two state dicts by order, which
misaligns once the target has ``num_batches_tracked`` buffers that the
file predates).  As the JAX package does, the port loads them by name.
The port's trunk carries the reference's names, not torchvision's:

  ``conv1``, ``bn1``        -> ``pcd_emb.cnn_pre_stages.{0,1}``
  ``layer1``, ``layer2``    -> ``pcd_emb.cnn_ds_stages.{0,1}``
  ``layer3``, ``layer4``    -> ``pcd_emb.cnn_ds_stages.2.{0,1}``

with the block names below them (``{b}.conv1``, ``{b}.bn2``,
``{b}.downsample.{0,1}``, ...) the same in both.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

# port prefix (under pcd_emb) -> torchvision prefix
_TRUNK = {
    "cnn_pre_stages.0": "conv1",
    "cnn_pre_stages.1": "bn1",
    "cnn_ds_stages.0": "layer1",
    "cnn_ds_stages.1": "layer2",
    "cnn_ds_stages.2.0": "layer3",
    "cnn_ds_stages.2.1": "layer4",
}


def torchvision_key(port_key: str) -> str | None:
    """The torchvision name of a port state-dict entry of the ResNet
    trunk, or None for an entry outside it."""
    if not port_key.startswith("pcd_emb."):
        return None
    rest = port_key[len("pcd_emb."):]
    for port, tv in _TRUNK.items():
        if rest.startswith(port + "."):
            return tv + rest[len(port):]
    return None


def read_torchvision_state(path: str) -> dict:
    """{name: ndarray} of a torchvision resnet checkpoint: a ``.pth``
    torch pickle (read ``weights_only``: a state dict needs no pickled
    code), under its ``state_dict`` key when it has one, or an ``.npz`` of
    the same tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


@torch.no_grad()
def import_torchvision_resnet(model: nn.Module, torch_state: dict) -> dict:
    """Copy a torchvision resnet state dict into ``model``'s ResNet trunk,
    in place, by name; every other entry of ``model`` stays as it was.

    Raises KeyError when the file lacks a trunk tensor and ValueError on
    a shape that differs (resnet34 weights into the resnet18 trunk).
    ``num_batches_tracked`` loads where the file has it (ImageNet files
    written before torch 0.4 have none).  Returns {'unused': the file's
    names that went nowhere, ``fc.*`` and ``num_batches_tracked``
    aside}."""
    used = set()
    own = model.state_dict()
    for key, dst in own.items():
        tv = torchvision_key(key)
        if tv is None:
            continue
        if tv not in torch_state:
            if tv.endswith("num_batches_tracked"):
                continue
            raise KeyError(f"torchvision checkpoint is missing {tv}")
        src = torch.as_tensor(np.asarray(torch_state[tv]))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"shape mismatch at {key} <- {tv}: torch {tuple(src.shape)} "
                f"vs the port's {tuple(dst.shape)} (wrong resnet depth?)")
        dst.copy_(src.to(dst.dtype))
        used.add(tv)
    if not used:
        raise KeyError("the model has no ResNet trunk under pcd_emb (is "
                       "model.backbone a CNN-branch architecture?)")
    return {"unused": sorted(
        k for k in set(torch_state) - used
        if not k.startswith("fc.") and not k.endswith("num_batches_tracked"))}


def load_pretrained_backbone(model: nn.Module, weights) -> nn.Module:
    """``model`` with its ResNet trunk initialised from a torchvision
    resnet checkpoint (the reference's ``pretrained=True`` ImageNet init).
    ``weights`` is a path (see :func:`read_torchvision_state`) or an
    already-read {name: ndarray} dict, to read a file once for many
    objects (``--cls-id all``)."""
    sd = (weights if isinstance(weights, dict)
          else read_torchvision_state(weights))
    report = import_torchvision_resnet(model, sd)
    if report["unused"]:
        warnings.warn("torchvision import: unused tensors "
                      f"{report['unused'][:5]}...")
    return model

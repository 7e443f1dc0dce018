"""Checkpoint save and load in the reference's own file format.

Counterpart of gdm_tpu/train/checkpoint.py, with its layout: one
directory per object (``<ckpt_root>/checkpoints/<obj>/``), an
``epoch_NNNN`` directory per saved epoch and a ``latest`` file naming
the newest.  Where the JAX package writes orbax trees, each epoch
directory holds the reference's ``geomatch.pth.tar`` (train_lm.py:102-154):
{epoch, step, model_state, optimizer_state}, the model state under the
reference parameter names (the shared ``cnn.final`` under both of its
names, ``awl.params`` included) and the optimizer state keyed by the same
names (train/state.py).  A copy of the newest goes to
``<obj dir>/geomatch.pth.tar``, where ``cli eval --torch-checkpoint
<ckpt_root>/checkpoints`` of either package reads it.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil

import torch

from gdm_tpu_torch import weights
from gdm_tpu_torch.train.state import TrainState

FILE = "geomatch.pth.tar"


def save_checkpoint(state: TrainState, ckpt_dir: str, epoch: int) -> str:
    """Write ``<ckpt_dir>/epoch_NNNN/geomatch.pth.tar``, copy it to
    ``<ckpt_dir>/geomatch.pth.tar`` and point ``latest`` at it; returns
    the epoch directory.  Each file is written to a temporary name and
    renamed, so a crash never leaves a half-written checkpoint."""
    ckpt_dir = osp.abspath(ckpt_dir)
    name = f"epoch_{epoch:04d}"
    path = osp.join(ckpt_dir, name)
    os.makedirs(path, exist_ok=True)
    blob = {"epoch": int(epoch), "step": int(state.step),
            "model_state": weights.reference_state_dict(state.model),
            "optimizer_state": state.optimizer.state_dict()}
    target = osp.join(path, FILE)
    torch.save(blob, target + ".tmp")
    os.replace(target + ".tmp", target)
    shutil.copyfile(target, osp.join(ckpt_dir, FILE + ".tmp"))
    os.replace(osp.join(ckpt_dir, FILE + ".tmp"), osp.join(ckpt_dir, FILE))
    with open(osp.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(name)
    os.replace(osp.join(ckpt_dir, "latest.tmp"), osp.join(ckpt_dir, "latest"))
    return path


def checkpoint_file(ckpt_dir: str, name: str | None = None) -> str | None:
    """``<ckpt_dir>/<name>/geomatch.pth.tar`` (default: the ``latest``
    epoch's), or None when there is none."""
    ckpt_dir = osp.abspath(ckpt_dir)
    if name is None:
        latest = osp.join(ckpt_dir, "latest")
        if not osp.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
    path = osp.join(ckpt_dir, name, FILE)
    return path if osp.exists(path) else None


def load_checkpoint(state: TrainState, ckpt_dir: str,
                    name: str | None = None):
    """Restore ``state`` in place from ``<ckpt_dir>/<name>`` (default: the
    ``latest`` one); returns (state, epoch), or (state, None) when there
    is no checkpoint (the reference's miss path, train_lm.py:118-146)."""
    path = checkpoint_file(ckpt_dir, name)
    if path is None:
        return state, None
    blob = torch.load(path, map_location="cpu", weights_only=True)
    weights.load_train_state(state.model, state.optimizer,
                             blob["model_state"], blob["optimizer_state"])
    state.step = int(blob["step"])
    return state, int(blob["epoch"])


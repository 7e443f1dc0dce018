"""The train step: inputs on the device, forward, backward, optimizer.

Counterpart of gdm_tpu/train/step.py (reference hot loop
train_lm.py:266-290).  One call of ``train_step(state, batch, mesh, rng)``:

  1. the loader's host batch goes to the device and is finalized
     (colour, backprojection, normals, point gather), and for GeoMatch
     the KNN index pyramid is built, all without autograd: no gradient
     flows through the neighbour indices (gdm_tpu/cli.py:529 builds them
     outside the differentiated graph too).  GeoMatchDGCNN
     (``needs_pyramid`` False) takes ``cld_rgb_nrm`` and the GT keys
     alone, ``origin_labels`` among them, and builds its graphs, also
     without autograd, in its forward;
  2. the forward in training mode (batch statistics, dropout) gives the
     loss; the BN momentum comes from the schedule at ``state.step`` and
     the dropout masks from a generator seeded by (rng, state.step), so
     a resumed run draws the same masks;
  3. backward, then the Adam(W) update of train/state.py.

TF32 stays off for matmuls and convolutions inside the step, and bf16
products accumulate in f32 (serve.full_f32).  Under
``model.compute_dtype=bfloat16`` the forward and backward run the
encoder in bf16 while the parameters, their gradients and the optimizer
stay f32, with no loss scaling, as in the JAX package.  The metrics stay
on the device (``loss``, ``seg_loss``, ``match_loss``,
``bn_momentum`` and, with the non-finite guard, ``total_notfinite``): the
caller reads them when it logs.
"""

from __future__ import annotations

import time

import torch

from gdm_tpu_torch.data.pipeline import build_pyramid, finalize_batch, \
    to_device
from gdm_tpu_torch.models.layers import set_train_step_state
from gdm_tpu_torch.serve import full_f32
from gdm_tpu_torch.train.state import TrainState

# host arrays of a loader batch that the step ships to the device (and
# dpt_filled when the dataset fills depth, origin_labels for DGCNN)
BATCH_KEYS = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose",
              "labels", "match_idx", "visible_flag", "RT")
# GeoMatchDGCNN's inputs (gdm_tpu/cli.py:262-265)
DGCNN_KEYS = ("cld_rgb_nrm", "labels", "origin_labels", "match_idx",
              "visible_flag", "RT")


def train_inputs(fin: dict, positive_r: float,
                 knn_chunk: int = 1024) -> dict:
    """Model inputs of a finalized batch: the tensors, the exact index
    pyramid and the training GT keys, and ``positive_r`` (it differs per
    object, so it rides in the inputs)."""
    inputs = {k: fin[k] for k in ("rgb", "cld_rgb_nrm", "choose", "labels",
                                  "match_idx", "visible_flag", "RT")}
    inputs.update(build_pyramid(fin["cld_rgb_nrm"][..., :3],
                                fin["xyz_img"], knn_chunk))
    inputs["positive_r"] = torch.tensor(positive_r, dtype=torch.float32,
                                        device=fin["rgb"].device)
    return inputs


def dropout_generator(rng: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step: seeded by (rng, step), as the
    JAX step folds the step into its dropout key."""
    g = torch.Generator(device=device)
    g.manual_seed((int(rng) << 32 | int(step)) & (2 ** 63 - 1))
    return g


def make_train_step(bn_momentum_fn, positive_r: float,
                    knn_chunk: int = 1024, fill_depth: bool = False,
                    needs_pyramid: bool = True):
    """Returns ``train_step(state, batch, mesh, rng, timing=None) ->
    metrics``.

    ``batch`` is a loader batch (numpy, the keys of BATCH_KEYS, and
    dpt_filled with ``fill_depth``: the normals come from it), or the
    model inputs made of one (:func:`train_inputs`, or DGCNN_KEYS of a
    finalized batch) on the model's device; ``mesh`` is the model's mesh
    input on that device (models/build.ModelSetup.mesh) and ``rng`` an
    integer seed.  ``needs_pyramid`` False trains GeoMatchDGCNN, whose
    graphs take ``knn_chunk`` queries per distance block.  With a ``timing`` dict the step synchronises the device
    between its phases and adds their milliseconds under 'inputs' (H2D,
    finalize and pyramid), 'forward' (forward and loss), 'backward' and
    'optimizer'.
    """

    keys = BATCH_KEYS + (("dpt_filled",) if fill_depth else ()) \
        + (() if needs_pyramid else ("origin_labels",))
    kw = {} if needs_pyramid else {"knn_chunk": knn_chunk}

    def train_step(state: TrainState, batch: dict, mesh, rng: int,
                   timing: dict | None = None) -> dict:
        model = state.model
        device = next(model.parameters()).device
        clock = _Clock(device, timing)
        momentum = float(bn_momentum_fn(state.step))
        with full_f32():
            if "cld_rgb_nrm" in batch:
                inputs = batch
            else:
                with torch.no_grad():
                    fin = finalize_batch(to_device(
                        {k: batch[k] for k in keys}, device), fill_depth)
                    inputs = (train_inputs(fin, positive_r, knn_chunk)
                              if needs_pyramid else
                              {k: fin[k] for k in DGCNN_KEYS})
            clock.lap("inputs")
            model.train()
            set_train_step_state(model, momentum, dropout_generator(
                rng, state.step, device))
            for p in model.parameters():
                p.grad = None
            out = model(inputs, mesh, train=True, **kw)
            clock.lap("forward")
            out["loss"].backward()
            clock.lap("backward")
            state.optimizer.step()
            clock.lap("optimizer")
        state.step += 1
        metrics = {k: out[k].detach() for k in ("loss", "seg_loss",
                                                "match_loss")}
        metrics["bn_momentum"] = momentum
        if state.optimizer.guarded:
            metrics["total_notfinite"] = state.optimizer.total_notfinite
        return metrics

    return train_step


class _Clock:
    """Synchronised phase times of one step, only when asked for."""

    def __init__(self, device, timing: dict | None):
        self.timing = timing
        self.sync = (torch.cuda.synchronize if torch.device(device).type
                     == "cuda" else (lambda: None))
        if timing is not None:
            self.sync()
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timing is None:
            return
        self.sync()
        now = time.perf_counter()
        self.timing[name] = self.timing.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now

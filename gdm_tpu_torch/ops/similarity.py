"""Cosine-similarity argmax: the correspondence step of the pose fit.

Replaces the Pallas kernel of gdm_tpu/ops/pallas/similarity.py
(``_make_kernel``, launched by ``_pallas_cosine_argmax``) with the
hand-written CUDA kernel in ``csrc/similarity.cu``.  It computes the
function the JAX main path runs, ``_xla_cosine_argmax``: the index of the
largest dot product of each scene row with the mesh rows (ties to the
lowest index) and that maximum as the score, to f32 accuracy.

Bound on the H100: at the eval shape, [128*4096, 128] x [4096, 128], the
call is 2*R*M*C = 550 GFLOP against ~270 MB read, so it is compute-bound.
The kernel runs the products on the tensor cores at f32 accuracy by the
three-way TF32 split (hi.hi + hi.lo + lo.hi, TF32 ``wgmma``), streams
TMA-loaded mesh tiles against scene rows held in shared memory and keeps
a running (max, argmax) per row, so the R x M matrix (8.6 GB at the eval
shape, written and read back by the plain version) never reaches device
memory.  Its scores stay within 1e-5 of the plain f32 product.

Dispatch: CPU tensors go to :func:`cosine_argmax_reference`, the plain
PyTorch version; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

MAX_C = 256     # the kernel's shared-memory tiles hold up to 256 channels


def cosine_argmax_reference(scene_f: torch.Tensor, mesh_f: torch.Tensor):
    """Plain version: [R, C] x [M, C] -> (idx [R] int64, score [R] f32).

    ``torch.max`` over a dim returns the first maximal index, so ties go
    to the lowest mesh row, as ``jnp.argmax`` does."""
    score, idx = torch.max(scene_f @ mesh_f.T, dim=-1)
    return idx, score


def _check(scene_f: torch.Tensor, mesh_f: torch.Tensor) -> None:
    for name, t in (("scene_f", scene_f), ("mesh_f", mesh_f)):
        if t.dim() != 2:
            raise ValueError(f"{name}: want a 2-D tensor, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    if scene_f.device != mesh_f.device:
        raise ValueError(f"scene_f on {scene_f.device}, mesh_f on "
                         f"{mesh_f.device}")
    c = scene_f.shape[1]
    if mesh_f.shape[1] != c:
        raise ValueError(f"channel mismatch: {c} vs {mesh_f.shape[1]}")
    if c > MAX_C or c % 4:
        raise ValueError(f"C={c}: the kernel takes C <= {MAX_C}, C % 4 == 0")
    if mesh_f.shape[0] == 0:
        raise ValueError("empty mesh")


def _library():
    from gdm_tpu_torch import _build

    lib = _build.load("similarity")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdm_cosine_argmax.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.gdm_cosine_argmax.restype = ctypes.c_int
    return lib


def _launch(scene_f: torch.Tensor, mesh_f: torch.Tensor):
    _check(scene_f, mesh_f)
    lib = _library()
    r, c = scene_f.shape
    m = mesh_f.shape[0]
    idx = torch.empty(r, dtype=torch.int64, device=scene_f.device)
    score = torch.empty(r, dtype=torch.float32, device=scene_f.device)
    # the mesh's TF32 hi and lo parts, written by the kernel's prepass
    scratch = torch.empty(2 * m * c, dtype=torch.float32,
                          device=scene_f.device)
    with torch.cuda.device(scene_f.device):
        stream = torch.cuda.current_stream(scene_f.device).cuda_stream
        rc = lib.gdm_cosine_argmax(
            scene_f.data_ptr(), mesh_f.data_ptr(), r, m, c,
            idx.data_ptr(), score.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        what = {-1: "the driver has no cuTensorMapEncodeTiled",
                -2: "a TMA tensor map was refused"}.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"cosine_argmax kernel launch failed: {what} at "
                           f"R={r}, M={m}, C={c}")
    cosine_argmax.launches += 1
    return idx, score


def cosine_argmax(scene_f: torch.Tensor, mesh_f: torch.Tensor):
    """Per-scene-row best mesh row under dot-product similarity.

    Args:
      scene_f: [R, C] f32 scene features (L2-normalised for cosine).
      mesh_f:  [M, C] f32 mesh features (L2-normalised).

    Returns:
      (idx [R] int64, score [R] f32).  CPU tensors take the plain
      version; CUDA tensors launch the kernel, whose launches are counted
      in ``cosine_argmax.launches``.
    """
    if scene_f.is_cuda or mesh_f.is_cuda:
        return _launch(scene_f, mesh_f)
    return cosine_argmax_reference(scene_f, mesh_f)


cosine_argmax.launches = 0


def cosine_argmax_batched(scene_f: torch.Tensor, mesh_f: torch.Tensor):
    """Batched rows against one shared mesh: [B, N, C] x [M, C].

    Rows are independent, so the batch folds into the row axis: one
    launch for the whole batch.  Returns (idx [B, N], score [B, N])."""
    b, n, c = scene_f.shape
    idx, score = cosine_argmax(scene_f.reshape(b * n, c), mesh_f)
    return idx.reshape(b, n), score.reshape(b, n)

"""Single-object pose engine for the HTTP service.

Counterpart of gdm_tpu/serve.py's ServingArtifact: the same ``meta``
(``raw_spec`` = {key: [shape, dtype]} of the loader's ship format),
``finalize``, ``infer`` and ``run(raw) -> numpy poses [B, 3, 4]``, so it
plugs into gdm_tpu_torch.server.PoseService (and, unchanged, into the JAX
package's).  Where the JAX artifact bakes a traced program, the engine
holds the model, the object's mesh graph and its mesh features, encoded
once at construction.

The configuration computes in f32.  cuDNN allows TF32 convolutions by
default, so the engine turns TF32 off for matmuls and convolutions around
its own device work (:func:`full_f32`) whatever the caller has set.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gdm_tpu_torch import weights
from gdm_tpu_torch.data.pipeline import finalize_batch, to_device
from gdm_tpu_torch.eval.infer import run_inference
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
from gdm_tpu_torch.models.spline_mesh import build_mesh_graph


@contextlib.contextmanager
def full_f32():
    """TF32 off for CUDA matmuls and cuDNN convolutions inside the block;
    the previous process-wide settings come back after it."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def raw_input_spec(batch: int, im_size: int, n_sample: int,
                   fill_depth: bool = False) -> dict:
    """{key: [shape, dtype]} of the raw request arrays, sorted by key, as
    gdm_tpu.serve.raw_input_spec(..., fill_depth, with_det=True) writes
    into meta.json: with ``fill_depth`` the depth-filled crop
    ``dpt_filled`` [batch, S, S] float32 metres rides beside the counts."""
    spec = {
        "K_crop": [[batch, 3, 3], "float32"],
        "choose": [[batch, n_sample], "int32"],
        "det": [[batch], "int32"],
        "dpt_scale": [[batch], "float32"],
        "dpt_u16": [[batch, im_size, im_size], "uint16"],
        "rgb_u8": [[batch, im_size, im_size, 3], "uint8"],
    }
    if fill_depth:
        spec["dpt_filled"] = [[batch, im_size, im_size], "float32"]
    return dict(sorted(spec.items()))


class PoseEngine:
    """GeoMatch inference for one object on one device.

    Args:
      config: shapes, model widths and ``data.fill_depth`` (the requests
        carry the depth-filled crop, whose normals the model reads)
        (gdm_tpu_torch.configs.Config).
      mesh_fps: [m, 9] object array (xyz mm | rgb | normal).
      state_dict: reference-named weights (numpy or tensors).
      device: torch device; "cuda" raises when CUDA is absent.
      batch: the served batch; PoseService pads shorter requests to it.
      knn_chunk: queries per distance block of the KNN pyramid (peak
        memory; no result changes with it).
      refine: None | 'ransac' | 'icp' | 'meanshift' (eval/pose_fit).
      icp_reject: the ICP correspondence gate in metres.
    """

    def __init__(self, config, mesh_fps: np.ndarray, state_dict: dict,
                 device, batch: int, knn_chunk: int = 1024,
                 refine: str | None = None, icp_reject: float = 0.01):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                               "not available")
        m = config.model
        self.model = GeoMatch(m.feat_dim, tuple(m.randla_d_out),
                              spline_kernel=m.spline_kernel)
        weights.load_reference_state_dict(self.model, state_dict)
        self.model.to(self.device).eval()
        self.knn_chunk = knn_chunk
        self.fill_depth = bool(config.data.fill_depth)
        self.refine, self.icp_reject = refine, float(icp_reject)
        graph = build_mesh_graph(mesh_fps, m.n_mesh_node,
                                 kernel_size=m.spline_kernel,
                                 k=m.mesh_knn_k)
        self.mesh = MeshArrays.from_graph(graph, self.device)
        self._encode_mesh()
        self.meta = {
            "raw_spec": raw_input_spec(batch, config.data.input_size,
                                       config.data.num_sample_points,
                                       self.fill_depth),
            "output": "poses [batch, 3, 4] (world->cam R|t, metres)",
            "device": str(self.device),
            "fill_depth": self.fill_depth,
            "exact_knn": True,
            "refine": refine,
            "icp_reject_m": self.icp_reject,
        }
        # what the pose fit used on the last batch (see run_inference)
        self.last_fit: dict | None = None

    def _encode_mesh(self) -> None:
        with torch.no_grad(), full_f32():
            self.mesh_feats = self.model.encode_mesh(self.mesh)

    def load_weights(self, state_dict: dict) -> None:
        """New reference-named weights (a training run validating its
        current state): loaded strictly, mesh features encoded again."""
        weights.load_reference_state_dict(self.model, state_dict)
        self._encode_mesh()

    @property
    def platforms(self):
        return (self.device.type,)

    def finalize(self, raw: dict) -> dict:
        """Host arrays (see meta['raw_spec']) -> finalized device batch."""
        return finalize_batch(to_device(raw, self.device), self.fill_depth)

    def infer(self, fin: dict) -> torch.Tensor:
        """Finalized batch -> poses [B, 3, 4] on the device."""
        with full_f32():
            poses, self.last_fit = run_inference(
                self.model, fin, self.mesh, self.mesh_feats, self.knn_chunk,
                self.refine, self.icp_reject)
        return poses

    def run(self, raw: dict) -> np.ndarray:
        """finalize + infer; numpy poses (PoseService calls np.asarray)."""
        return self.infer(self.finalize(raw)).cpu().numpy()

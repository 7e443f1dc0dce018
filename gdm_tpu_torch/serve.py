"""Single-object pose engine for the HTTP service, and its artifact.

Counterpart of gdm_tpu/serve.py's ServingArtifact: the same ``meta``
(``raw_spec`` = {key: [shape, dtype]} of the loader's ship format),
``finalize``, ``infer`` and ``run(raw) -> numpy poses [B, 3, 4]``, so it
plugs into gdm_tpu_torch.server.PoseService (and, unchanged, into the JAX
package's).  Where the JAX artifact bakes a traced program, the engine
holds the model that ``config.model.backbone`` names
(models/build.build_model), the object's mesh input (the flagship's
SplineCNN graph, or DGCNN's node features in metres) and its mesh
features, encoded once at construction.

The configuration computes in f32, or its encoder in bf16
(``model.compute_dtype``).  cuDNN allows TF32 convolutions by default,
and cuBLAS may reduce bf16 products' partial sums in bf16, so the engine
turns both off around its own device work (:func:`full_f32`) whatever the
caller has set: f32 products stay f32, and bf16 ones accumulate in f32,
as the JAX package's do.

A serving artifact (``cli export-serving``) is a directory that
:func:`load_artifact` turns back into a PoseEngine with no dataset tree:

  - ``meta.json``: every key of the JAX package's artifact meta but its
    ``platforms`` and ``jax_version`` (``format_version``, ``raw_spec``,
    ``output``, ``fill_depth``, ``needs_pyramid``, ``knn_chunk``,
    ``exact_knn``, ``refine``, ``icp_reject_m``, ``dataset``,
    ``obj_name``, ``cls_id``, ``diameter_m``), and ``format``
    ("gdm_tpu_torch"), ``opts`` (the ``--opt`` overrides of the dataset
    preset), ``config`` (the configuration they gave, from which a
    DGCNN or YCB-V artifact rebuilds its own model wherever it is
    loaded) and ``torch_version``;
  - ``weights.npz``: the reference-named state dict;
  - ``mesh_fps.npy``: the object's [m, 9] fps array, xyz in millimetres.

Where a JAX artifact holds traced StableHLO programs (``finalize.bin``,
``infer.bin``), the port's holds weights and rebuilds the model: it cannot
replay a JAX artifact, and refuses one by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import os.path as osp

import numpy as np
import torch

from gdm_tpu_torch import weights
from gdm_tpu_torch.data.pipeline import finalize_batch, to_device
from gdm_tpu_torch.eval.infer import run_inference
from gdm_tpu_torch.models.build import build_model

META, WEIGHTS, MESH = "meta.json", "weights.npz", "mesh_fps.npy"
# the JAX package's artifact format (gdm_tpu/serve.py _FORMAT_VERSION):
# depth ships as uint16 counts with a per-sample scale
FORMAT_VERSION = 2


@contextlib.contextmanager
def full_f32():
    """TF32 off for CUDA matmuls and cuDNN convolutions, and bf16 matmuls'
    reduced-precision reduction off, inside the block; the previous
    process-wide settings come back after it."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    mm, cd = matmul.allow_tf32, cudnn.allow_tf32
    bf = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_tf32 = mm
        cudnn.allow_tf32 = cd
        matmul.allow_bf16_reduced_precision_reduction = bf


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
    """GeoMatch (or GeoMatchDGCNN) inference for one object on one
    device.

    Args:
      config: shapes, backbone, model widths and ``data.fill_depth`` (the
        requests carry the depth-filled crop, whose normals the model
        reads) (gdm_tpu_torch.configs.Config).
      mesh_fps_mm: [m, 9] object array, xyz in **millimetres** | rgb |
        normal (the fps.npy layout; build_model refuses metres).
      state_dict: reference-named weights (numpy or tensors).
      device: torch device; "cuda" raises when CUDA is absent.
      batch: the served batch; PoseService pads shorter requests to it.
      knn_chunk: queries per distance block of the KNN pyramid or the
        DGCNN graphs (peak memory; no result changes with it).
      refine: None | 'ransac' | 'icp' | 'meanshift' (eval/pose_fit).
      icp_reject: the ICP correspondence gate in metres.
      grid: the ranks of a multi-process run (parallel/mesh.Grid): with
        model shards, each batch's correspondence argmax is split over
        the model row (every rank of the row runs the same batch).
    """

    def __init__(self, config, mesh_fps_mm: np.ndarray, state_dict: dict,
                 device, batch: int, knn_chunk: int = 1024,
                 refine: str | None = None, icp_reject: float = 0.01,
                 grid=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is "
                               "not available")
        self.model, self.mesh, self.mesh_xyz, self.needs_pyramid = \
            build_model(config, mesh_fps_mm, self.device)
        weights.load_reference_state_dict(self.model, state_dict)
        self.model.to(self.device).eval()
        self.knn_chunk = knn_chunk
        self.fill_depth = bool(config.data.fill_depth)
        self.refine, self.icp_reject = refine, float(icp_reject)
        self.grid = grid
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
                self.model, fin, self.mesh, self.mesh_xyz, self.mesh_feats,
                self.needs_pyramid, self.knn_chunk, self.refine,
                self.icp_reject, self.grid)
        return poses

    def run(self, raw: dict) -> np.ndarray:
        """finalize + infer; numpy poses (PoseService calls np.asarray)."""
        return self.infer(self.finalize(raw)).cpu().numpy()


def export_serving_artifact(out_dir: str, config, mesh_fps_mm: np.ndarray,
                            state_dict: dict, *, batch: int, knn_chunk: int,
                            refine: str | None, icp_reject: float,
                            dataset: str, opts, meta: dict) -> dict:
    """Write a serving artifact of one object (see the module docstring).

    ``state_dict`` is loaded strictly into the configured model first, so
    weights that do not fit ``config`` are refused before anything is
    written; the artifact holds them as that model's reference-named
    state dict.  ``meta`` (obj_name, cls_id, diameter_m) joins meta.json.
    Returns the meta written."""
    model, _, _, needs_pyramid = build_model(config, mesh_fps_mm, "cpu")
    weights.load_reference_state_dict(model, state_dict)
    fill_depth = bool(config.data.fill_depth)
    info = {
        "format": "gdm_tpu_torch",
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "raw_spec": raw_input_spec(batch, config.data.input_size,
                                   config.data.num_sample_points,
                                   fill_depth),
        "output": "poses [batch, 3, 4] (world->cam R|t, metres)",
        "fill_depth": fill_depth,
        "needs_pyramid": bool(needs_pyramid),
        "knn_chunk": int(knn_chunk),
        "exact_knn": True,
        "refine": refine,
        "icp_reject_m": float(icp_reject),
        "dataset": dataset,
        "opts": list(opts),
        "config": dataclasses.asdict(config),
        **meta,
    }
    os.makedirs(out_dir, exist_ok=True)
    np.savez(osp.join(out_dir, WEIGHTS), **{
        k: v.numpy() for k, v in weights.reference_state_dict(model).items()})
    np.save(osp.join(out_dir, MESH), np.asarray(mesh_fps_mm))
    with open(osp.join(out_dir, META), "w") as f:
        json.dump(info, f, indent=1, sort_keys=True)
    return info


def read_artifact_meta(path: str) -> dict:
    """meta.json of a port artifact directory.  A JAX artifact (traced
    programs, no weights) and a newer format are refused."""
    with open(osp.join(path, META)) as f:
        meta = json.load(f)
    if not osp.exists(osp.join(path, WEIGHTS)):
        jax_files = [f for f in ("finalize.bin", "infer.bin")
                     if osp.exists(osp.join(path, f))]
        if jax_files:
            raise ValueError(
                f"{path} is a JAX artifact ({', '.join(jax_files)}: traced "
                "StableHLO programs), which the port cannot replay; export "
                "it with python -m gdm_tpu_torch.cli export-serving")
        raise ValueError(f"{path}: no {WEIGHTS}")
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta['format_version']} is newer than this "
            f"loader ({FORMAT_VERSION})")
    return meta


def load_artifact(path: str, device) -> PoseEngine:
    """The PoseEngine of an artifact directory on ``device``, its meta
    the artifact's (plus ``device``)."""
    from gdm_tpu_torch.configs import config_from_dict

    meta = read_artifact_meta(path)
    config = config_from_dict(meta["config"])
    with np.load(osp.join(path, WEIGHTS)) as z:
        state = {k: z[k] for k in z.files}
    batch = next(iter(meta["raw_spec"].values()))[0][0]
    engine = PoseEngine(config, np.load(osp.join(path, MESH)), state, device,
                        batch=batch, knn_chunk=meta["knn_chunk"],
                        refine=meta["refine"], icp_reject=meta["icp_reject_m"])
    if engine.meta["raw_spec"] != meta["raw_spec"]:
        raise ValueError(f"{path}: its config serves "
                         f"{engine.meta['raw_spec']}, its raw_spec says "
                         f"{meta['raw_spec']}")
    engine.meta = dict(meta, device=str(engine.device))
    return engine

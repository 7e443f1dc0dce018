"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

One tiny problem, the shapes of __graft_entry__._build_problem (batch 2,
64 mesh vertices, 256 scene points, 64^2 crop), made with numpy from a
seed and fed to both packages.  Weights come from a flax init, go through
gdm_tpu.train.import_torch.export_state_dict and load into the port with
gdm_tpu_torch.weights.load_reference_state_dict.
"""

from __future__ import annotations

import numpy as np
import torch

import conftest  # noqa: F401  (JAX on the CPU platform)

B, N_MESH, N_SAMPLE, IM = 2, 64, 256, 64
KNN_CHUNK = 128


def intrinsics(im: int = IM) -> np.ndarray:
    return np.array([[572.4, 0, im / 2], [0, 573.6, im / 2], [0, 0, 1]],
                    np.float32)


def mesh_fps(seed: int = 0) -> np.ndarray:
    from gdm_tpu.data.synthetic import make_object

    return make_object(N_MESH, np.random.RandomState(seed), radius=0.08)


def raw_request(seed: int = 0, b: int = B) -> dict:
    """Loader ship format (scripts/bench_serve.py): random rgb, depth of
    4000-6000 counts at 10000 counts/m with a zero-depth block, LMO
    intrinsics, random sampled pixels, det = 1."""
    rng = np.random.RandomState(seed)
    dpt = (4000 + 2000 * rng.rand(b, IM, IM)).astype(np.uint16)
    dpt[:, 10:20, 30:45] = 0                      # invalid depth
    return {
        "rgb_u8": rng.randint(0, 255, (b, IM, IM, 3)).astype(np.uint8),
        "dpt_u16": dpt,
        "dpt_scale": np.full((b,), 10000.0, np.float32),
        "K_crop": np.tile(intrinsics(), (b, 1, 1)),
        "choose": rng.randint(0, IM * IM, (b, N_SAMPLE)).astype(np.int32),
        "det": np.ones((b,), np.int32),
    }


def to_torch(d: dict) -> dict:
    """numpy/jax arrays -> CPU tensors; integer arrays become int64."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(np.array(a))
    return out


def jax_model_and_variables(inputs: dict, mesh, seed: int = 0):
    """Flax GeoMatch and its eval-mode variables initialised on
    ``inputs`` (a full model-input dict)."""
    import jax

    from gdm_tpu.models import GeoMatch

    model = GeoMatch(positive_r=0.01)
    variables = jax.jit(
        lambda r, i, m: model.init(r, i, m, train=False))(
            jax.random.PRNGKey(seed), inputs, mesh)
    return model, variables


def port_model(variables):
    """The port's GeoMatch holding the flax variables (via the reference
    state-dict names)."""
    from gdm_tpu.train.import_torch import export_state_dict
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch import GeoMatch

    m = GeoMatch()
    weights.load_reference_state_dict(
        m, export_state_dict(variables["params"], variables["batch_stats"]))
    return m.eval()


def rel_err(a, ref) -> float:
    """max|a - ref| / max|ref|."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def top2_gap(scene: np.ndarray, mesh: np.ndarray) -> np.ndarray:
    """Gap between the two largest dot products of each scene row."""
    sim = scene.astype(np.float64) @ mesh.astype(np.float64).T
    top = np.sort(sim, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]

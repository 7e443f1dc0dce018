"""The train-to-pose demo's DGCNN path (``--backbone dgcnn``) against
scripts/train_synthetic_demo.py's, on the CPU at a tiny size (64^2 crops,
1024 points, a 128-vertex mesh, b=4): the first STEPS train steps of the
demo's 300 from JAX's initial weights (GeoMatchDGCNN with exact graphs,
which off the TPU is also what its default approx_max_k computes) on the
demo's inputs, with dropout off on both sides.

The scene points get 0.1 mm of depth-sensor noise on both sides: the
demo's background is an exact grid plane, whose tied distances each
package orders its own way in the first edge-conv graph
(tests/test_torch_dgcnn.py does the same).  Each loss is held within
8 s + LOSS_TOL of JAX's, s being the port's own spread under a relative
1e-7 move of its inputs (test_torch_train_synthetic_demo gives the
reason: near-tied graph neighbours and Adam's +-lr steps on gradients
that are rounding noise).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU platform)
from gdm_tpu_torch import train_synthetic_demo as demo
from gdm_tpu_torch import weights
from gdm_tpu_torch.models.layers import Dropout
from gdm_tpu_torch.train.step import DGCNN_KEYS

torch.set_num_threads(1)
ARGS = ["--device", "cpu", "--im", "64", "--n-sample", "1024", "--n-mesh",
        "128", "--batch", "4", "--n-train-frames", "8", "--backbone",
        "dgcnn"]
STEPS = 3
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def carried():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.models.geomatch_dgcnn import GeoMatchDGCNN as GeoMatchJ
    from gdm_tpu.train import bn_momentum_schedule, create_train_state, \
        cyclic_lr, make_train_step
    from gdm_tpu.train.import_torch import export_state_dict

    args = demo.build_parser().parse_args(ARGS)
    prob = demo.Problem(args, "cpu")
    noise = np.random.RandomState(1)
    cld = prob.train_data["cld_rgb_nrm"]
    cld[..., :3] += 1e-4 * noise.randn(*cld[..., :3].shape).astype(
        np.float32)
    n = args.n_train_frames // args.batch
    rows = [np.s_[i * args.batch:(i + 1) * args.batch] for i in range(n)]
    mesh_j = jnp.asarray(prob.mesh.numpy())
    mp = MonkeyPatch()
    mp.setattr(nn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        batches = [{k: jnp.asarray(prob.train_data[k][sl])
                    for k in DGCNN_KEYS} for sl in rows]
        state = create_train_state(
            GeoMatchJ(approx_knn=False), jax.random.PRNGKey(args.seed),
            batches[0], mesh_j, cyclic_lr(1e-5, 1e-3,
                                          max(args.steps // 6, 1)))
        sd = export_state_dict(state.params, state.batch_stats)
        step = make_train_step(bn_momentum_schedule(batch_size=args.batch),
                               build_pyramid_in_step=False, donate=False)
        rng = jax.random.PRNGKey(args.seed + 7)
        losses = []
        for it in range(STEPS):
            state, m = step(state, batches[it % n], mesh_j, rng)
            losses.append(float(m["loss"]))
    finally:
        mp.undo()
    for mod in prob.model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return {"args": args, "prob": prob, "sd": sd, "losses": losses,
            "batches": [prob.inputs(prob.train_data, sl) for sl in rows]}


def _port_losses(carried, batches):
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    args, prob = carried["args"], carried["prob"]
    weights.load_reference_state_dict(prob.model, carried["sd"])
    state = create_train_state(prob.model, cyclic_lr(
        1e-5, 1e-3, max(args.steps // 6, 1)))
    step = make_train_step(bn_momentum_schedule(batch_size=args.batch),
                           demo.POSITIVE_R, needs_pyramid=False)
    return np.array([float(step(state, batches[it % len(batches)],
                                prob.mesh, args.seed + 7)["loss"])
                     for it in range(STEPS)])


def test_dgcnn_first_steps_match_jax(carried):
    want = np.array(carried["losses"])
    got = _port_losses(carried, carried["batches"])
    rng = np.random.RandomState(11)
    spread = np.zeros(STEPS)
    for _ in range(2):
        moved = [{k: v * (1 + 1e-7 * torch.from_numpy(
            rng.randn(*v.shape)).float()) if v.is_floating_point() else v
            for k, v in b.items()} for b in carried["batches"]]
        spread = np.maximum(spread, np.abs(_port_losses(carried, moved)
                                           - got) / np.abs(got))
    assert (np.abs(got - want) <= (8 * spread + LOSS_TOL)
            * np.abs(want)).all(), (got, want, spread)
    assert spread.max() < 1e-3

"""The train-to-pose demo of the port (gdm_tpu_torch.train_synthetic_demo)
against scripts/train_synthetic_demo.py's JAX path, on the CPU at a tiny
size (64^2 crops, 1024 points, a 64-vertex mesh, b=4) and the full model
widths:

  * the demo's evaluation on weights carried from JAX's
    ``create_train_state``: Kabsch weights equal but where JAX's two seg
    logits lie within SEG_TIE, and correspondences equal on every row
    that neither package's rounding nor the forwards' feature gap can
    flip (test_torch_lmfull_cli.decided_rows' rule);
  * the first STEPS train steps of the demo's 300 from those weights on
    its batches (its cyclic LR and BN-momentum schedules, Adam, dropout
    off on both sides): the first loss within 1e-5 of JAX's
    make_train_step, and each loss within 8 s + 1e-5 of it, where s is
    the port's own spread (see test_first_steps_match_jax);
  * the whole demo (``run``) on one fixed batch at a smaller size: the
    loss falls, and the result holds every number it reports.
"""

import numpy as np
import pytest
import torch

import _torch_harness as H
import conftest  # noqa: F401  (JAX on the CPU platform)
from gdm_tpu_torch import train_synthetic_demo as demo
from gdm_tpu_torch import weights
from gdm_tpu_torch.models.layers import Dropout

torch.set_num_threads(1)
ARGS = ["--device", "cpu", "--im", "64", "--n-sample", "1024", "--n-mesh",
        "64", "--batch", "4", "--n-train-frames", "8"]
STEPS = 3
SEG_TIE = 1e-4
LOSS_TOL = 1e-5


def _no_dropout(monkeypatch):
    import flax.linen as nn

    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@pytest.fixture(scope="module")
def carried():
    """The demo's problem in both packages from the same arrays, JAX's
    initial train state and its first STEPS losses, and the port's model
    holding JAX's initial weights."""
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.data.pipeline import assemble_inputs
    from gdm_tpu.models import GeoMatch as GeoMatchJ
    from gdm_tpu.models.geomatch import MeshArrays as MeshArraysJ
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j
    from gdm_tpu.train import bn_momentum_schedule, create_train_state, \
        cyclic_lr, make_train_step
    from gdm_tpu.train.import_torch import export_state_dict

    args = demo.build_parser().parse_args(ARGS)
    prob = demo.Problem(args, "cpu")
    mesh_j = MeshArraysJ.from_graph(build_j(prob.mesh_fps, args.n_mesh))

    def inputs_j(d, sl=np.s_[:]):
        return assemble_inputs(
            jnp.asarray(d["rgb"][sl]), jnp.asarray(d["cld_rgb_nrm"][sl]),
            jnp.asarray(d["choose"][sl]), jnp.asarray(d["xyz_img"][sl]),
            labels=jnp.asarray(d["labels"][sl]),
            match_idx=jnp.asarray(d["match_idx"][sl]),
            visible_flag=jnp.asarray(d["visible_flag"][sl]),
            RT=jnp.asarray(d["RT"][sl]), knn_chunk=256)

    def to_port(inputs):
        out = H.to_torch(inputs)
        out["positive_r"] = torch.tensor(demo.POSITIVE_R)
        return out

    mp = MonkeyPatch()
    _no_dropout(mp)
    try:
        model = GeoMatchJ(positive_r=demo.POSITIVE_R)
        n = args.n_train_frames // args.batch
        batches = [inputs_j(prob.train_data,
                            np.s_[i * args.batch:(i + 1) * args.batch])
                   for i in range(n)]
        state = create_train_state(
            model, jax.random.PRNGKey(args.seed), batches[0], mesh_j,
            cyclic_lr(1e-5, 1e-3, max(args.steps // 6, 1)))
        sd = export_state_dict(state.params, state.batch_stats)
        out = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))(
            {"params": state.params, "batch_stats": state.batch_stats},
            inputs_j(prob.test_data), mesh_j)
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
    weights.load_reference_state_dict(prob.model, sd)
    return {"args": args, "prob": prob, "sd": sd, "losses": losses,
            "batches": [to_port(b) for b in batches],
            "out": {k: np.asarray(v) for k, v in out.items()
                    if k in ("seg", "rgbd", "mesh")},
            "mesh_xyz": np.asarray(mesh_j.xyz)}


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def test_evaluation_matches_jax_on_carried_weights(carried):
    import jax
    import jax.numpy as jnp

    from gdm_tpu.eval.pose_fit import fit_pose_single

    prob, out_j = carried["prob"], carried["out"]
    np.testing.assert_array_equal(carried["mesh_xyz"],
                                  prob.mesh_xyz.numpy())
    ev = prob.evaluate()
    _, w_j, idx_j = jax.vmap(lambda c, s, r: fit_pose_single(
        c, s, jnp.asarray(out_j["mesh"]), r, jnp.asarray(
            carried["mesh_xyz"]), jnp.float32(1.0)))(
        jnp.asarray(prob.test_data["cld_rgb_nrm"][..., :3]),
        jnp.asarray(out_j["seg"]), jnp.asarray(out_j["rgbd"]))
    w_j, idx_j = np.asarray(w_j), np.asarray(idx_j)
    w, idx = ev["weights"].numpy(), ev["idx"].numpy()
    seg_gap = np.abs(out_j["seg"][..., 1] - out_j["seg"][..., 0])
    sure_seg = seg_gap > SEG_TIE
    assert sure_seg.mean() > 0.99
    np.testing.assert_array_equal(w[sure_seg], w_j[sure_seg])
    # correspondences beyond near-ties: a score moves by at most
    # |dn| + max|dm| between the two forwards' unit features
    n_t, n_j = _unit(ev["rgbd"].numpy()), _unit(out_j["rgbd"])
    m_t, m_j = _unit(ev["mesh"].numpy()), _unit(out_j["mesh"])
    dn = np.linalg.norm(n_t - n_j, axis=-1)
    dm = np.linalg.norm(m_t - m_j, axis=-1).max()
    top = np.sort(n_j @ m_j.T, axis=-1)[..., -2:]
    decided = (top[..., 1] - top[..., 0]) > 1e-5 + 2 * (dn + dm)
    assert decided.mean() > 0.5, decided.mean()
    np.testing.assert_array_equal(idx[decided], idx_j[decided])
    assert np.isfinite(ev["poses"]).all()
    assert ev["poses"].shape == (carried["args"].batch, 3, 4)


def _port_losses(carried, batches):
    """The port's first STEPS losses from JAX's initial weights."""
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    args, prob = carried["args"], carried["prob"]
    weights.load_reference_state_dict(prob.model, carried["sd"])
    state = create_train_state(prob.model, cyclic_lr(
        1e-5, 1e-3, max(args.steps // 6, 1)))
    step = make_train_step(bn_momentum_schedule(batch_size=args.batch),
                           demo.POSITIVE_R)
    return np.array([float(step(state, batches[it % len(batches)],
                                prob.mesh, args.seed + 7)["loss"])
                     for it in range(STEPS)])


def test_first_steps_match_jax(carried):
    """The demo's schedules, optimizer and train step from JAX's initial
    state on the demo's batches, as JAX built them (the demo's background
    is an exact grid plane whose tied distances two pyramid builds order
    their own ways, which moves the features near them).

    The first loss is one f32 forward (within LOSS_TOL, as
    test_torch_train holds it).  The later ones are chaotic in f32: Adam
    moves every parameter by ~lr whatever its gradient's size (u = m /
    sqrt(v) is +-1 at the first step), so an entry whose gradient is
    rounding noise (a bias ahead of a train-mode BN) steps either way,
    and the port's own third loss moves by ~4e-3 when the inputs move by
    a relative 1e-7.  So each loss is held within 8 s + LOSS_TOL of
    JAX's, s being the largest change of the port's loss at that step
    over three such moves (the port's spread alone: JAX's error does not
    widen it)."""
    want = np.array(carried["losses"])
    got = _port_losses(carried, carried["batches"])
    assert abs(got[0] - want[0]) <= LOSS_TOL * abs(want[0])
    rng = np.random.RandomState(11)
    spread = np.zeros(STEPS)
    for _ in range(3):
        moved = [{k: v * (1 + 1e-7 * torch.from_numpy(
            rng.randn(*v.shape)).float())
            if v.is_floating_point() and k != "positive_r" else v
            for k, v in b.items()} for b in carried["batches"]]
        spread = np.maximum(spread, np.abs(_port_losses(carried, moved)
                                           - got) / np.abs(got))
    assert (np.abs(got - want) <= (8 * spread + LOSS_TOL)
            * np.abs(want)).all(), (got, want, spread)
    # the bound stays informative: far below the loss's fall
    assert spread.max() < 0.01 and got[-1] < got[0]


def test_demo_run_overfits_a_fixed_batch():
    """``run`` end to end on the CPU with one train batch: the logged
    loss falls over the steps, and the result holds the numbers the demo
    reports (no peak off the card)."""
    args = demo.build_parser().parse_args(
        ["--device", "cpu", "--im", "64", "--n-sample", "256", "--n-mesh",
         "64", "--batch", "2", "--n-train-frames", "2", "--steps", "12"])
    res = demo.run(args)
    (first, *_), (last, *_) = res["losses"][0][1:], res["losses"][-1][1:]
    assert [r[0] for r in res["losses"]] == [0, 11]
    assert last < first, res["losses"]
    for k in ("add_before", "add_after", "rot_before", "rot_after",
              "trans_before", "trans_after", "steps_per_s",
              "first_step_s", "render_s"):
        assert np.isfinite(res[k]) and res[k] >= 0, k
    assert res["peak_gib"] is None
    assert res["improved"] == (res["add_after"] < 0.5 * res["add_before"])
    # make_object(64, radius 0.06): bumps of +-30% over a 0.12 m sphere
    assert 0.08 < res["diameter"] < 0.16

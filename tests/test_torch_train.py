"""Training of the port against gdm_tpu on the CPU, on the tiny problem
of _torch_harness (batch 2, 64 mesh vertices, 256 points, 64^2 crop) at
the full model widths:

  * the train-mode forward and backward: loss values (|d|/|ref| <= 1e-5),
    the new BN running statistics (max|d|/max|ref| <= 1e-4) and every
    gradient (see test_every_gradient_matches_jax for how).  The JAX side
    runs exact KNN and its flax Dropout is made the identity inside the
    test; the port runs with dropout rates 0;
  * the port's dropout itself: rates, 1/(1-p) scaling, same mask for the
    same (seed, step);
  * the schedules, bit-equal over a sweep of steps;
  * Adam(W) with the non-finite guard against optax over 12 steps, NaN
    gradients up to and past max_consecutive_errors included;
  * a JAX TrainState carried over into the port after one JAX step: the
    port's loss there, and its Adam step on the JAX gradients (params
    after it: max|d|/max|ref| <= 1e-5);
  * the seeded init's per-tensor std against flax's initialisers.
"""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
from gdm_tpu_torch.models.layers import Dropout, set_train_step_state
from gdm_tpu_torch.models.spline_mesh import build_mesh_graph
from gdm_tpu_torch import weights
from gdm_tpu_torch.train import schedules, state as tstate
from gdm_tpu_torch.train.step import dropout_generator

torch.set_num_threads(1)
VAL_TOL, GRAD_TOL, ADAM_TOL = 1e-5, 1e-4, 1e-5
MOMENTUM = 0.3
POSITIVE_R = 0.01
# batch and points: every BN of the deepest RandLA level sees B * N / 256
# rows; with fewer, batch statistics of a handful of rows make the train
# forward ill-conditioned in f32 whatever the summation order
B, N_SAMPLE = 4, 1024


def _no_dropout(monkeypatch):
    """flax Dropout as the identity (the JAX package stays as it is)."""
    import flax.linen as nn

    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _named(tree_params, batch_stats):
    from gdm_tpu.train.import_torch import export_state_dict

    return export_state_dict(tree_params, batch_stats)


@pytest.fixture(scope="module")
def problem():
    return build_problem()


def build_problem():
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.data.pipeline import assemble_inputs
    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models import GeoMatch as GeoMatchJ
    from gdm_tpu.models.geomatch import MeshArrays as MeshArraysJ
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j

    mp = MonkeyPatch()
    _no_dropout(mp)
    try:
        fps = H.mesh_fps()
        mesh_j = MeshArraysJ.from_graph(build_j(fps, H.N_MESH))
        data, _ = make_batch(fps, B, H.intrinsics(), im_size=H.IM,
                             n_sample=N_SAMPLE, seed=0)
        inputs = assemble_inputs(
            jnp.asarray(data["rgb"]), jnp.asarray(data["cld_rgb_nrm"]),
            jnp.asarray(data["choose"]), jnp.asarray(data["xyz_img"]),
            labels=jnp.asarray(data["labels"], jnp.int32),
            match_idx=jnp.asarray(data["match_idx"], jnp.int32),
            visible_flag=jnp.asarray(data["visible_flag"]),
            RT=jnp.asarray(data["RT"]), knn_chunk=H.KNN_CHUNK, approx=False)
        inputs["positive_r"] = jnp.float32(POSITIVE_R)
        inputs = _centred(inputs)
        model = GeoMatchJ(positive_r=POSITIVE_R)
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda r, i, m: model.init(
            {"params": r, "dropout": r}, i, m, train=True))(
                key, inputs, mesh_j)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                inputs, mesh_j, train=True, momentum=MOMENTUM,
                mutable=["batch_stats"], rngs={"dropout": key})
            return out["loss"], (out, mut["batch_stats"])

        (loss, (out, new_stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        mesh_t = MeshArrays.from_graph(build_mesh_graph(fps, H.N_MESH),
                                       "cpu")
        return {
            "model": model, "variables": variables, "inputs": inputs,
            "mesh_j": mesh_j, "mesh_t": mesh_t, "key": key,
            "vals": {k: float(out[k]) for k in ("loss", "seg_loss",
                                                "match_loss")},
            "grads": _named(grads, variables["batch_stats"]),
            "stats": _named(variables["params"], new_stats),
            "sd": _named(variables["params"], variables["batch_stats"]),
        }
    finally:
        mp.undo()


def _centred(inputs):
    """The scene points moved so that they centre on the origin.

    Train-mode BN normalises with E[x^2] - E[x]^2 in f32.  The objects
    sit ~0.4 m from the camera and span ~5 cm, so on the raw coordinates
    the first point layers have |mean| >> std, and XLA's CPU reduction
    then loses ~1e-3 of the variance to cancellation (torch's pairwise
    sums lose ~1e-7); either package's answer moves by that much.
    Centring changes no neighbour index (the pyramid is built before)."""
    import jax.numpy as jnp

    c = jnp.mean(inputs["cld_xyz0"].reshape(-1, 3), axis=0)
    out = dict(inputs)
    for k, v in inputs.items():
        if k.startswith("cld_xyz"):
            out[k] = v - c
    out["cld_rgb_nrm"] = inputs["cld_rgb_nrm"].at[..., :3].add(-c)
    return out


def _without_dropout(model):
    """``model`` with every dropout rate set to 0."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return model


def _port_model(sd):
    m = _without_dropout(GeoMatch(awl=True))
    weights.load_reference_state_dict(m, sd)
    return m


def _port_forward_backward(sd, inputs, mesh, dtype=torch.float32):
    m = _port_model(sd).to(dtype)
    m.train()
    set_train_step_state(m, MOMENTUM, None)
    inputs = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in H.to_torch(inputs).items()}
    mesh = MeshArrays(*[x.to(dtype) if x is not None
                        and x.is_floating_point() else x for x in mesh])
    out = m(inputs, mesh, train=True)
    out["loss"].backward()
    return m, out


@pytest.fixture(scope="module")
def port_step(problem):
    return _port_forward_backward(problem["sd"], problem["inputs"],
                                  problem["mesh_t"])


@pytest.mark.parametrize("key", ["loss", "seg_loss", "match_loss"])
def test_train_loss_values_match_jax(problem, port_step, key):
    want, got = problem["vals"][key], float(port_step[1][key].detach())
    assert abs(got - want) <= VAL_TOL * abs(want), (got, want)


def test_every_gradient_matches_jax(problem, port_step):
    """Each gradient tensor agrees with JAX's to max|d|/max|ref| <= 1e-4,
    or else the port's and JAX's f32 gradients both lie within
    8 s_t + 1e-4 of the port's float64 gradient, where s_t is the port's
    own f32 spread for that tensor.

    A per-tensor 1e-4 between two f32 computations is out of reach at
    this problem: the train-mode backward of this deep model (stacked
    train-mode BN over as few as 16 rows, neighbour max-pools) amplifies
    rounding by ~1e5, so the port's own f32 gradient moves by ~1%
    (median over tensors, up to ~14% for a few ResNet layer-4 weights)
    when every float input moves by a relative 1e-7, and lies ~1% from
    its float64 gradient.  s_t is the largest change of the port's f32
    gradient of tensor t over four draws of such a move: the port's
    alone, so JAX's error does not widen it.  The bound stays below the error of a wrong gradient (a
    sign, a transposition or a missing term moves a tensor by ~1 or 2)
    for most tensors, and below a flipped sign's for all.
    Errors are max|d| over max|ref|, with max|ref| floored at 1e-6 of
    the largest gradient of the model (a bias right before a train-mode
    BN has a true gradient of 0 and holds rounding noise)."""
    model, _ = port_step
    sd, inputs, mesh = problem["sd"], problem["inputs"], problem["mesh_t"]
    m64, _ = _port_forward_backward(sd, inputs, mesh, torch.float64)
    exact = {k: p.grad.numpy() for k, p in m64.named_parameters()}
    floor = 1e-6 * max(np.abs(g).max() for g in exact.values())
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}

    def err(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), floor))

    rng = np.random.RandomState(11)
    spread = dict.fromkeys(exact, 0.0)
    for _ in range(4):
        moved = {k: (np.asarray(v) * (1 + 1e-7 * rng.randn(*np.shape(v)))
                     ).astype(np.float32)
                 if np.asarray(v).dtype == np.float32 and k != "positive_r"
                 else v for k, v in inputs.items()}
        m, _ = _port_forward_backward(sd, moved, mesh)
        for k, p in m.named_parameters():
            spread[k] = max(spread[k], err(p.grad.numpy(), grads[k]))
    direct, worse = 0, []
    for name, got in grads.items():
        assert np.isfinite(got).all(), name
        ref = np.asarray(problem["grads"][name]).reshape(got.shape)
        if H.rel_err(got, ref) <= GRAD_TOL:
            direct += 1
            continue
        bound = 8 * spread[name] + GRAD_TOL
        e_p, e_j = err(got, exact[name]), err(ref, exact[name])
        if e_p > bound or e_j > bound:
            worse.append((e_p, e_j, spread[name], name))
    assert not worse, worse
    assert direct >= 5 and len(exact) > 300
    # the bound stays informative: ~1 in the median, and below 2 (a
    # tensor of the wrong sign) for every tensor
    assert np.median(list(spread.values())) <= 0.03
    assert max(spread.values()) <= 0.2


def test_batch_norm_statistics_match_jax(problem, port_step):
    model, _ = port_step
    n = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            want = np.asarray(problem["stats"][name])
            assert H.rel_err(buf.numpy(), want) <= GRAD_TOL, name
            n += 1
    assert n > 100


def test_dropout_rates_scaling_and_seeding():
    m = GeoMatch(awl=True)
    rates = sorted(d.p for d in m.modules() if isinstance(d, Dropout))
    assert rates == [0.1, 0.15, 0.15, 0.3]
    drop = Dropout(0.3).train()
    x = torch.ones(200_000)
    drop.generator = dropout_generator(7, 3, "cpu")
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.all(y[kept] == 1.0 / 0.7)
    drop.generator = dropout_generator(7, 3, "cpu")
    assert torch.equal(drop(x), y)
    drop.generator = dropout_generator(7, 4, "cpu")
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


def test_schedules_bit_equal():
    import jax.numpy as jnp

    from gdm_tpu.train import schedules as sj

    steps = np.arange(0, 5000, 7, dtype=np.int32)
    for ss in (1, 5, 333):
        want = np.asarray(sj.cyclic_lr(1e-6, 1e-3, ss)(jnp.asarray(steps)))
        got = schedules.cyclic_lr(1e-6, 1e-3, ss)(torch.from_numpy(steps))
        np.testing.assert_array_equal(got.numpy(), want)
    steps = np.arange(0, 300000, 997, dtype=np.int32)
    for bs in (24, 8):
        want = np.asarray(sj.bn_momentum_schedule(batch_size=bs)(
            jnp.asarray(steps)))
        got = schedules.bn_momentum_schedule(batch_size=bs)(
            torch.from_numpy(steps))
        np.testing.assert_array_equal(got.numpy(), want)
    assert schedules.clr_step_size(50, 1000, 24) == sj.clr_step_size(
        50, 1000, 24)


@pytest.mark.parametrize("weight_decay,guard", [(0.0, 0), (0.0, 3),
                                                (1e-2, 3)])
def test_adam_matches_optax(weight_decay, guard):
    import jax.numpy as jnp
    import optax

    from gdm_tpu.train import schedules as sj
    from gdm_tpu.train.state import make_optimizer as make_j

    rng = np.random.RandomState(5)
    shapes = {"a": (7, 3), "b": (11,), "c": (2, 3, 4)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = make_j(sj.cyclic_lr(1e-4, 1e-2, 4), weight_decay, guard)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_j = tx.init(pj)
    params_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in p0.items()}
    opt_t = tstate.make_optimizer(params_t, schedules.cyclic_lr(
        1e-4, 1e-2, 4), weight_decay, guard)
    for it in range(12):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        if guard and it in (2, 5, 6, 7, 8):       # 4 in a row: past 3
            g["b"][3] = np.nan
        upd, opt_j = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               opt_j, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in params_t.items():
            p.grad = torch.from_numpy(g[k])
        opt_t.step()
        for k in shapes:
            want = np.asarray(pj[k])
            got = params_t[k].detach().numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            ok = ~np.isnan(want)
            if ok.any():
                assert H.rel_err(got[ok], want[ok]) <= ADAM_TOL, (it, k)
        if guard:
            assert int(opt_t.total_notfinite) == int(opt_j.total_notfinite)
            assert int(opt_t.notfinite_count) == int(opt_j.notfinite_count)
            assert int(opt_t.count) == int(opt_j.inner_state[0].count)
    if guard:
        assert int(opt_t.total_notfinite) == 5


def _optax_state_named(opt_state, batch_stats):
    """(mu, nu, count, guard counters) of a guarded optax Adam state,
    mu and nu under the reference names."""
    adam = opt_state.inner_state[0]
    return {"mu": _named(adam.mu, batch_stats),
            "nu": _named(adam.nu, batch_stats),
            "count": np.asarray(adam.count),
            "notfinite_count": np.asarray(opt_state.notfinite_count),
            "last_finite": np.asarray(opt_state.last_finite),
            "total_notfinite": np.asarray(opt_state.total_notfinite)}


def test_one_step_from_a_carried_over_state(problem, monkeypatch):
    """A JAX TrainState after one step (non-zero moments, moved BN
    statistics, a count of 1) goes into the port.  At that state the
    port's train-mode loss is JAX's, and the port's Adam step on JAX's
    next gradients gives JAX's next params (the gradients themselves are
    compared in test_every_gradient_matches_jax)."""
    import jax

    from gdm_tpu.train import schedules as sj
    from gdm_tpu.train.state import create_train_state, make_optimizer
    from gdm_tpu.train.step import make_train_step as make_step_j

    _no_dropout(monkeypatch)
    lr = sj.cyclic_lr(1e-6, 1e-3, 2)
    tx = make_optimizer(lr, 0.0, 5)
    st = create_train_state(problem["model"], problem["key"],
                            problem["inputs"], problem["mesh_j"], lr, tx=tx)
    bnm = sj.bn_momentum_schedule(batch_size=20000)   # moves every step
    step_j = make_step_j(bnm, build_pyramid_in_step=False, donate=False)
    st, _ = step_j(st, problem["inputs"], problem["mesh_j"], problem["key"])

    model = _without_dropout(GeoMatch(awl=True))
    ts = tstate.create_train_state(model, schedules.cyclic_lr(1e-6, 1e-3, 2),
                                   0.0, 5)
    weights.load_train_state(
        ts.model, ts.optimizer, _named(st.params, st.batch_stats),
        _optax_state_named(st.opt_state, st.batch_stats))
    ts.step = int(st.step)

    _, m_j = step_j(st, problem["inputs"], problem["mesh_j"],
                    problem["key"])
    grads_j = _grads_of_step(problem, st)
    st2 = st.apply_gradients(grads_j, st.batch_stats)
    mom = float(schedules.bn_momentum_schedule(batch_size=20000)(ts.step))
    assert mom == pytest.approx(float(m_j["bn_momentum"]), abs=0)
    model.train()
    set_train_step_state(model, mom, None)
    with torch.no_grad():
        out = model(H.to_torch(problem["inputs"]), problem["mesh_t"],
                    train=True)
    assert abs(float(out["loss"]) - float(m_j["loss"])) \
        <= VAL_TOL * abs(float(m_j["loss"]))
    grads = _named(grads_j, st.batch_stats)
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(np.asarray(grads[k]).reshape(p.shape))
    ts.optimizer.step()
    want = _named(st2.params, st2.batch_stats)
    errs = [(H.rel_err(p.detach().numpy(),
                       np.asarray(want[k]).reshape(p.shape)), k)
            for k, p in model.named_parameters()]
    assert max(errs)[0] <= ADAM_TOL, sorted(errs)[-3:]
    assert int(ts.optimizer.count) == int(st2.opt_state.inner_state[0].count)
    jax.block_until_ready(st2.params)


def _grads_of_step(problem, st):
    """The gradients JAX's train step takes at TrainState ``st``."""
    import jax

    def loss_fn(params):
        out, _ = st.apply_fn(
            {"params": params, "batch_stats": st.batch_stats},
            problem["inputs"], problem["mesh_j"], train=True,
            momentum=0.9, mutable=["batch_stats"],
            rngs={"dropout": problem["key"]})
        return out["loss"]

    return jax.jit(jax.grad(loss_fn))(st.params)


def test_init_std_follows_flax(problem):
    """init_random_ against the flax init of the same model, tensor by
    tensor: constants equal, random tensors' std within 10% (or within
    four standard errors of a sample std, 4 / sqrt(2 n), for a tensor
    of n < 800 values, where two draws differ by more than 10% by
    chance)."""
    ref = problem["sd"]
    m = GeoMatch(awl=True)
    weights.init_random_(m, torch.Generator().manual_seed(0))
    n_random = 0
    for name, p in m.state_dict().items():
        want = np.asarray(ref[name], np.float64)
        got = p.numpy().astype(np.float64)
        if name.endswith("num_batches_tracked"):
            continue
        if want.std() == 0.0:
            np.testing.assert_array_equal(got.ravel(), want.ravel(), name)
            continue
        n_random += 1
        tol = max(0.10, 4.0 / np.sqrt(2 * want.size))
        assert abs(got.std() / want.std() - 1.0) <= tol, (
            name, got.std(), want.std())
    assert n_random > 100

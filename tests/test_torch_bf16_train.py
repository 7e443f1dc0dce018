"""One training step of the port's flagship in bf16
(``model.compute_dtype`` and ``model.gather_bwd_dtype`` bfloat16) against
the JAX package's (DGCNN's: tests/test_torch_bf16_dgcnn_train.py), on the
tiny problem of _torch_harness at the full widths, JAX
jitted and dropout off in both.

The rule is tests/test_torch_bf16.py's: the port no further from JAX in
bf16 than GAP_FACTOR x JAX in bf16 is from JAX in f32, for each loss
value and each gradient tensor (max|d|), with the escape that
tests/test_torch_train.py gives the train-mode backward's amplified
rounding: or else within 8 s, where s is the port's own bf16 spread, the
largest change of its value when every float input moves by a relative
1e-7 (two draws).  In bf16 that spread is large: train-mode BN over a
few hundred rows turns a bf16 ulp flipped anywhere into a change
everywhere (the port's flagship loss moves by ~1% under such a move,
about JAX's own bf16-vs-f32 gap).

The step itself (train/step.make_train_step on a model that
models/build.build_model made from a bf16 configuration): the optimizer
updates f32 parameters from f32 gradients with no loss scaling, and the
checkpoint is dtype-agnostic: a bf16-trained state dict loads strictly
into an f32 model and back (the JAX package pins the same,
tests/test_models.py:243-247).
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_torch_train as TT
from test_torch_bf16 import GAP_FACTOR
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.models.build import build_model
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
from gdm_tpu_torch.models.layers import set_train_step_state
from gdm_tpu_torch.models.spline_mesh import build_mesh_graph
from gdm_tpu_torch.train.state import create_train_state
from gdm_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)
MOMENTUM = 0.3
SPREAD_X = 8.0      # x the port's own bf16 spread (test_torch_train's)
SPREAD_DRAWS = 2
VALUES = ("loss", "seg_loss", "match_loss")


def _jax_steps(model_cls, kw, variables, inputs, mesh, gather_bwd=None):
    """Loss values and reference-named gradients of one jitted JAX train
    step in f32 and in bf16 (with the gather backward's dtype
    ``gather_bwd``, set while the bf16 step is traced)."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.models.randla import set_gather_bwd_dtype

    out = {}
    for name, dt in (("32", jnp.float32), ("16", jnp.bfloat16)):
        model = model_cls(compute_dtype=dt, **kw)

        def loss_fn(params, model=model):
            o, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                inputs, mesh, train=True, momentum=MOMENTUM,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            return o["loss"], o

        try:
            set_gather_bwd_dtype(gather_bwd if name == "16" else None)
            (_, o), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
        finally:
            set_gather_bwd_dtype(None)
        out[name] = ({k: float(o[k]) for k in VALUES},
                     TT._named(g, variables["batch_stats"]))
    return out


def _port_step(make, inputs, mesh, seed=None):
    """Loss values and gradients of one port bf16 train step; with a seed,
    every float input moved by a relative 1e-7 first."""
    m = make()
    m.train()
    set_train_step_state(m, MOMENTUM, None)
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        inputs = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g))
                  if v.is_floating_point() and v.dim() else v
                  for k, v in inputs.items()}
    out = m(inputs, mesh, train=True)
    out["loss"].backward()
    return ({k: float(out[k].detach()) for k in VALUES},
            {n: p.grad.numpy() for n, p in m.named_parameters()
             if p.grad is not None}, m)


def _case(make, inputs, mesh, jax_out):
    vals, grads, model = _port_step(make, inputs, mesh)
    spread_v, spread_g = {}, {}
    for seed in range(SPREAD_DRAWS):
        v, g, _ = _port_step(make, inputs, mesh, seed)
        for k in v:
            spread_v[k] = max(spread_v.get(k, 0.0), abs(v[k] - vals[k]))
        for k in g:
            spread_g[k] = max(spread_g.get(k, 0.0),
                              float(np.abs(g[k] - grads[k]).max()))
    return {"vals": vals, "grads": grads, "model": model,
            "spread_v": spread_v, "spread_g": spread_g,
            "j32": jax_out["32"], "j16": jax_out["16"]}


@pytest.fixture(scope="module")
def flagship():
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.data.pipeline import assemble_inputs
    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models import GeoMatch as GeoMatchJ
    from gdm_tpu.models.geomatch import MeshArrays as MeshArraysJ
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j

    mp = MonkeyPatch()
    TT._no_dropout(mp)
    try:
        fps = H.mesh_fps()
        mesh_j = MeshArraysJ.from_graph(build_j(fps, H.N_MESH))
        data, _ = make_batch(fps, H.B, H.intrinsics(), im_size=H.IM,
                             n_sample=H.N_SAMPLE, seed=0)
        inputs = assemble_inputs(
            jnp.asarray(data["rgb"]), jnp.asarray(data["cld_rgb_nrm"]),
            jnp.asarray(data["choose"]), jnp.asarray(data["xyz_img"]),
            labels=jnp.asarray(data["labels"], jnp.int32),
            match_idx=jnp.asarray(data["match_idx"], jnp.int32),
            visible_flag=jnp.asarray(data["visible_flag"]),
            RT=jnp.asarray(data["RT"]), knn_chunk=H.KNN_CHUNK, approx=False)
        inputs["positive_r"] = jnp.float32(TT.POSITIVE_R)
        inputs = TT._centred(inputs)
        init = GeoMatchJ(positive_r=TT.POSITIVE_R)
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda r, i, m: init.init(
            {"params": r, "dropout": r}, i, m, train=True))(
                key, inputs, mesh_j)
        jax_out = _jax_steps(GeoMatchJ, {"positive_r": TT.POSITIVE_R},
                             variables, inputs, mesh_j, "bfloat16")
    finally:
        mp.undo()
    sd = TT._named(variables["params"], variables["batch_stats"])

    def make():
        m = TT._without_dropout(GeoMatch(
            awl=True, compute_dtype=torch.bfloat16,
            gather_bwd_dtype=torch.bfloat16))
        weights.load_reference_state_dict(m, sd)
        return m

    mesh_t = MeshArrays.from_graph(build_mesh_graph(fps, H.N_MESH), "cpu")
    case = _case(make, H.to_torch(inputs), mesh_t, jax_out)
    case.update(sd=sd, inputs=H.to_torch(inputs), mesh=mesh_t)
    return case


def check_loss_value(c, key):
    got, j16, j32 = c["vals"][key], c["j16"][0][key], c["j32"][0][key]
    assert np.isfinite(got)
    assert abs(got - j16) <= max(GAP_FACTOR * abs(j16 - j32),
                                 SPREAD_X * c["spread_v"][key]), \
        (got, j16, j32, c["spread_v"][key])


def check_gradients(c):
    g16, g32 = c["j16"][1], c["j32"][1]
    assert set(c["grads"]) <= set(g16)
    assert len(c["grads"]) > 50
    bad = []
    for k, g in c["grads"].items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), k
        err = float(np.abs(g - g16[k]).max())
        gap = float(np.abs(g16[k] - g32[k]).max())
        if err > max(GAP_FACTOR * gap, SPREAD_X * c["spread_g"][k]):
            bad.append((k, err, gap, c["spread_g"][k]))
    assert not bad, bad


@pytest.mark.parametrize("key", VALUES)
def test_loss_values_within_jax_bf16_gap(flagship, key):
    check_loss_value(flagship, key)


def test_every_gradient_within_jax_bf16_gap(flagship):
    check_gradients(flagship)


def test_train_step_updates_f32_params_and_checkpoints_are_dtype_agnostic(
        flagship):
    """make_train_step on a model that build_model made from a bf16
    configuration: one step changes the f32 parameters; its state dict
    loads strictly into the f32 model and an f32 state dict into it."""
    cfg = configs.get_config("lmo", ["model.compute_dtype=bfloat16",
                                     "model.gather_bwd_dtype=bfloat16"])
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_mesh_node=H.N_MESH))
    setup = build_model(cfg, H.mesh_fps(), "cpu", awl=True)
    model = TT._without_dropout(setup.model)
    assert model.compute_dtype is torch.bfloat16
    assert model.pcd_emb.gather_bwd_dtype is torch.bfloat16
    weights.load_reference_state_dict(model, flagship["sd"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, lambda count: 1e-3)
    step = make_train_step(lambda s: MOMENTUM, TT.POSITIVE_R)
    metrics = step(state, flagship["inputs"], flagship["mesh"], rng=0)
    assert np.isfinite(float(metrics["loss"]))
    after = model.state_dict()
    assert {v.dtype for k, v in after.items()
            if "num_batches" not in k} == {torch.float32}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert len(moved) > 100
    f32 = GeoMatch(awl=True)
    f32.load_state_dict(after, strict=True)
    back = GeoMatch(awl=True, compute_dtype=torch.bfloat16)
    back.load_state_dict(f32.state_dict(), strict=True)
    with torch.no_grad():
        o32 = f32.eval()(flagship["inputs"], flagship["mesh"])
        o16 = back.eval()(flagship["inputs"], flagship["mesh"])
    for k in ("seg", "rgbd"):
        assert o16[k].dtype == torch.float32
        assert H.rel_err(o16[k].numpy(), o32[k].numpy()) < 0.05

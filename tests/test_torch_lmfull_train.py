"""The train step's loss and gradients of the port against the JAX
package on one LM-full train batch, on the CPU: the mini LM-full tree of
tests/test_torch_lmfull.py, one batch of 6 (the preset's train batch;
two records of each of ``real``, ``fuse`` and ``renders``), 3072 points,
64^2 crops, the eggbox's circle-loss radius (0.02 of its diameter), GT
at nn_dist_th 0.01.

Both packages read the same loader items (bit-equal,
tests/test_torch_lmfull.py) and the port runs on JAX's model inputs,
its exact pyramid included: at LM-full's sampling density two pyramids
differ among near-ties (see tests/test_torch_lmfull_cli.py), and the
loss would follow.  Weights: the port's seeded random weights (flax's
initialisers' spreads), imported into JAX's tree by its strict import.
The rules are tests/test_torch_train.py's: losses within 1e-5
(relative), each gradient tensor within 1e-4 of JAX's, or else both f32
gradients within 8 s_t + 1e-4 of the port's float64 one (s_t: the port's
own f32 spread under a relative 1e-7 move of its float inputs, here over
two draws); JAX's f32 gradient alone misses that bound on a few deep
tensors of this batch, which are counted
(test_every_gradient_matches_jax).  Dropout is off in both (flax's Dropout made the identity,
the port's rates 0); scene points are centred (test_torch_train's
_centred: train-mode BN's E[x^2] - E[x]^2 in f32)."""

import os.path as osp

import numpy as np
import pytest
import torch

import _torch_harness as H
from test_torch_lmfull import OBJ, build_mini_root, mini_configs
from test_torch_lmfull_cli import seeded_jax_variables
from test_torch_train import MOMENTUM, _centred, _named, _no_dropout, \
    _port_forward_backward

torch.set_num_threads(1)
VAL_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH = (0, 1, 3, 4, 6, 7)        # two records of each train subset
JAX_OFF_MAX = 8      # tensors where only JAX's f32 misses the bound


def positive_r():
    from gdm_tpu_torch import refdata

    _, cfg = mini_configs()
    return cfg.model.neighbor_dis_th \
        * refdata.get("lm_full").diameters_mm_by_id[OBJ] / 1000.0


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.models.geomatch import MeshArrays as MeshArraysJ
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j
    from gdm_tpu_torch.cli import _fps_mm
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.geomatch import MeshArrays
    from gdm_tpu_torch.models.spline_mesh import build_mesh_graph

    root = build_mini_root(str(tmp_path_factory.mktemp("lmfull_train")))
    _, cfg = mini_configs()
    ds = PoseDataset(cfg, OBJ, "train", data_root=root,
                     rng=np.random.RandomState(0))
    items = [ds[i] for i in BATCH]
    assert {osp.basename(osp.dirname(osp.dirname(osp.dirname(
        r.rgb_file)))) for r in (ds.annos[i] for i in BATCH)} == \
        {"real", "fuse", "renders"}
    batch, _ = collate(items)
    fps_mm = _fps_mm(load_or_build_fps_mesh(root, OBJ, cfg.data.model_pt_num))
    n_mesh = cfg.data.model_pt_num
    mp = MonkeyPatch()
    _no_dropout(mp)
    try:
        mesh_j = MeshArraysJ.from_graph(build_j(fps_mm, n_mesh))
        fin = finalize_batch({k: jnp.asarray(batch[k]) for k in (
            "rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose")}
            | {"det": jnp.ones(len(BATCH), jnp.int32)})
        inputs = assemble_inputs(
            fin["rgb"], fin["cld_rgb_nrm"], fin["choose"], fin["xyz_img"],
            labels=jnp.asarray(batch["labels"], jnp.int32),
            match_idx=jnp.asarray(batch["match_idx"], jnp.int32),
            visible_flag=jnp.asarray(batch["visible_flag"]),
            RT=jnp.asarray(batch["RT"]), knn_chunk=1024, approx=False)
        inputs["positive_r"] = jnp.float32(positive_r())
        inputs = _centred(inputs)
        model, variables = seeded_jax_variables(
            inputs, mesh_j, train=True, positive_r=positive_r())
        params, stats = variables["params"], variables["batch_stats"]
        key = jax.random.PRNGKey(0)

        def loss_fn(p, x):
            out, _ = model.apply(
                {"params": p, "batch_stats": stats}, x, mesh_j,
                train=True, momentum=MOMENTUM, mutable=["batch_stats"],
                rngs={"dropout": key})
            return out["loss"], out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, inputs)
        return {
            "inputs": inputs, "labels": np.asarray(batch["labels"]),
            "mesh_t": MeshArrays.from_graph(build_mesh_graph(fps_mm, n_mesh),
                                            "cpu"),
            "vals": {k: float(out[k]) for k in ("loss", "seg_loss",
                                                "match_loss")},
            "grads": _named(grads, stats), "sd": _named(params, stats)}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_step(problem):
    return _port_forward_backward(problem["sd"], problem["inputs"],
                                  problem["mesh_t"])


def test_batch_is_an_lmfull_train_batch(problem):
    inputs = problem["inputs"]
    assert inputs["cld_xyz0"].shape == (len(BATCH), 3072, 3)
    assert inputs["cld_xyz3"].shape == (len(BATCH), 48, 3)
    assert inputs["rgb"].shape[1:3] == (64, 64)
    # foreground and background points in every item, matches in each
    assert all(0 < lab.mean() < 1 for lab in problem["labels"])
    assert np.asarray(inputs["match_idx"]).max() == 128     # no-match
    assert (np.asarray(inputs["match_idx"]) < 128).any(axis=1).all()


@pytest.mark.parametrize("key", ["loss", "seg_loss", "match_loss"])
def test_train_loss_values_match_jax(problem, port_step, key):
    want, got = problem["vals"][key], float(port_step[1][key].detach())
    assert np.isfinite(want) and want != 0.0
    assert abs(got - want) <= VAL_TOL * abs(want), (got, want)


def test_every_gradient_matches_jax(problem, port_step):
    """tests/test_torch_train.py's rule: each tensor within 1e-4 of
    JAX's, or else the port's and JAX's f32 gradients both within
    8 s_t + 1e-4 of the port's float64 gradient (s_t: the port's own f32
    spread over two relative 1e-7 moves of its float inputs).

    The port's clause holds for every tensor.  JAX's does not for 6 of
    this batch's tensors (measured: the last RandLA encoder stage's mlp2
    and shortcut weights, 18% and 27% off the float64 gradient; the
    up-path p2r pre-fusion layer 1's conv weight and BN bias, 12% and
    10%; the r2p pre-fusion layer 2's BN bias, 4.3%; the first mesh
    convolution's root, 2.5e-4), where the port's f32 gradient lies
    0.001-1.7% off and spreads 0.002-2.6%.  Those are counted (at most
    JAX_OFF_MAX), and each still lies within 0.5 of the float64
    gradient: a wrong gradient (a sign, a transposition, a missing term)
    is ~1 or 2 away.  (The circle loss detaches its weights, so the
    gradient is not the loss's derivative, and central differences
    cannot stand in.)"""
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
    for _ in range(2):
        moved = {k: (np.asarray(v) * (1 + 1e-7 * rng.randn(*np.shape(v)))
                     ).astype(np.float32)
                 if np.asarray(v).dtype == np.float32 and k != "positive_r"
                 else v for k, v in inputs.items()}
        m, _ = _port_forward_backward(sd, moved, mesh)
        for k, p in m.named_parameters():
            spread[k] = max(spread[k], err(p.grad.numpy(), grads[k]))
    direct, worse, jax_off = 0, [], {}
    for name, got in grads.items():
        assert np.isfinite(got).all(), name
        ref = np.asarray(problem["grads"][name]).reshape(got.shape)
        if H.rel_err(got, ref) <= GRAD_TOL:
            direct += 1
            continue
        bound = 8 * spread[name] + GRAD_TOL
        if err(got, exact[name]) > bound:
            worse.append((err(got, exact[name]), spread[name], name))
        elif err(ref, exact[name]) > bound:
            jax_off[name] = err(ref, exact[name])
    assert not worse, "\n".join(map(str, worse))
    assert direct >= 5 and len(exact) > 300
    assert max(spread.values()) <= 0.2
    assert len(jax_off) <= JAX_OFF_MAX, jax_off
    assert max(jax_off.values(), default=0.0) < 0.5, jax_off

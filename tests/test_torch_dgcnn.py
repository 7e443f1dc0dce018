"""The port's DGCNN variant (models/dgcnn.py, models/geomatch_dgcnn.py)
against gdm_tpu's on the CPU, on the tiny problem of _torch_harness
(batch 2, 256 scene points, 64 mesh vertices) at the real k (16 scene,
20 mesh), embed (1024) and feature (128) widths, JAX in its exact-graph
mode:

  * the graphs of graph_feature_b, all three layers of both branches on
    JAX's own features, equal to JAX's exact ``knn`` beyond near-ties,
    and the edge features bit-equal where the graphs are equal.  A
    near-tie is two neighbours whose float64 distances from point i
    differ by less than 1e-6 (|x_i|^2 + |x_j|^2): the scale at which the
    f32 expanded form |x_i|^2 - 2 x_i.x_j + |x_j|^2 rounds.  The row's
    k-th distance is no measure of it: scene points lie up to 0.8 m from
    the origin, where the two packages' f32 distances of 2.4e-4 m^2 were
    seen to differ by 4.2e-8 m^2;
  * eval forwards (each branch, and GeoMatchDGCNN's seg, rgbd and mesh
    end points) within max|d|/max|ref| <= 1e-4 on elements whose three
    graphs all agree, with the seeded case asserted to have agreeing
    graphs;
  * the training losses within 1e-5 (dropout off), the BN batch
    statistics within 1e-4 and every gradient by the rule of
    tests/test_torch_train.py (1e-4, or else within 8x the port's own f32
    spread + 1e-4 of its float64 gradient);
  * the weight bridge: the reference names, strict load of every value,
    each of the two BN names alone, the way back into JAX, seeded init.
"""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch import weights
from gdm_tpu_torch.models import dgcnn as dgcnn_t
from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN, mesh_input
from gdm_tpu_torch.models.layers import Dropout, set_train_step_state

torch.set_num_threads(1)
TOL, VAL_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
MOMENTUM = 0.3
TIE = 1e-6          # near-tie: a distance gap below TIE x |x_i|^2 + |x_j|^2
KEYS = ("cld_rgb_nrm", "labels", "origin_labels", "match_idx",
        "visible_flag", "RT")


def _no_dropout(monkeypatch):
    """flax Dropout as the identity (the JAX package stays as it is)."""
    import flax.linen as nn

    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _mesh_x():
    fps = H.mesh_fps()
    return mesh_input(np.concatenate([fps[:, :3] / 1000.0, fps[:, 3:]],
                                     axis=1))


@pytest.fixture(scope="module")
def problem():
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models.geomatch_dgcnn import GeoMatchDGCNN as GeoMatchJ
    from gdm_tpu.train.import_torch import export_state_dict

    mp = MonkeyPatch()
    _no_dropout(mp)
    try:
        data, _ = make_batch(H.mesh_fps(), H.B, H.intrinsics(), im_size=H.IM,
                             n_sample=H.N_SAMPLE, seed=0)
        inputs = {k: np.asarray(data[k]) for k in KEYS}
        for k in ("labels", "origin_labels", "match_idx"):
            inputs[k] = inputs[k].astype(np.int32)
        # centred scene points: XLA's CPU train-mode variance E[x^2] -
        # E[x]^2 loses ~1e-3 of it to cancellation on points 0.4 m away
        # (tests/test_torch_train.py _centred).  The renderer's background
        # is an exact grid plane at 1.5 m, whose equal distances each
        # package's f32 rounding orders its own way at the k-th neighbour
        # (the "grid" case of test_graphs_match_jax_knn); the model's
        # input gets 0.1 mm of depth-sensor noise, under which every
        # graph gives every point JAX's neighbour set (asserted below)
        cld = inputs["cld_rgb_nrm"].copy()
        grid = cld[..., :3] - cld[..., :3].reshape(-1, 3).mean(0)
        cld[..., :3] += 1e-4 * np.random.RandomState(1).randn(
            *cld[..., :3].shape)
        cld[..., :3] -= cld[..., :3].reshape(-1, 3).mean(0)
        inputs["cld_rgb_nrm"] = cld
        mesh_x = _mesh_x()
        ij = {k: jnp.asarray(v) for k, v in inputs.items()}
        mx = jnp.asarray(mesh_x)
        model = GeoMatchJ()
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda r, i, m: model.init(
            {"params": r, "dropout": r}, i, m, train=True))(key, ij, mx)
        out, inter = model.apply(
            variables, ij, mx, train=False,
            capture_intermediates=lambda mdl, _: mdl.name in ("conv2",
                                                              "conv4"))

        def loss_fn(params):
            o, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                ij, mx, train=True, momentum=MOMENTUM,
                mutable=["batch_stats"], rngs={"dropout": key})
            return o["loss"], (o, mut["batch_stats"])

        (_, (out_tr, new_stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        pooled = {}
        for br in ("pcd_emb", "model_emb"):
            tr = inter["intermediates"][br]["trunk"]
            pooled[br] = [np.asarray(tr[c]["__call__"][0]).max(axis=2)
                          for c in ("conv2", "conv4")]
        return {
            "model": model, "variables": variables, "inputs": inputs,
            "mesh_x": mesh_x, "grid": grid,
            "out": {k: np.asarray(v) for k, v in out.items()},
            "pooled": pooled,
            "vals": {k: float(out_tr[k]) for k in ("loss", "seg_loss",
                                                   "match_loss")},
            "sd": export_state_dict(variables["params"],
                                    variables["batch_stats"]),
            "grads": export_state_dict(grads, variables["batch_stats"]),
            "stats": export_state_dict(variables["params"], new_stats),
        }
    finally:
        mp.undo()


def _port_model(sd, awl=False, dtype=torch.float32):
    m = GeoMatchDGCNN(awl=awl)
    for mod in m.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    weights.load_reference_state_dict(m, sd)
    return m.to(dtype)


def _branch_input(problem, branch):
    """The branch's input, batched: [B, n, 9] or [1, M, 9]."""
    if branch == "pcd_emb":
        return problem["inputs"]["cld_rgb_nrm"]
    return problem["mesh_x"][None]


def _equal_beyond_near_ties(coords, idx_a, idx_b, k):
    """Wherever two graphs [B, n, k] on ``coords`` differ, the two
    neighbours at that rank lie at float64 distances from the row's point
    within TIE (|x_i|^2 + |x_j|^2) of each other (a near-tie, which f32
    rounding orders either way).  Returns the share of equal rows."""
    c = np.asarray(coords, np.float64)
    d = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    n2 = (c * c).sum(-1)
    da = np.take_along_axis(d, idx_a, -1)
    db = np.take_along_axis(d, idx_b, -1)
    scale = n2[..., None] + np.maximum(
        np.take_along_axis(n2[:, None, :].repeat(n2.shape[1], 1), idx_a, -1),
        np.take_along_axis(n2[:, None, :].repeat(n2.shape[1], 1), idx_b, -1))
    diff = idx_a != idx_b
    near = np.abs(da - db) <= TIE * scale
    assert near[diff].all(), (np.abs(da - db) / scale)[diff].max()
    return 1.0 - diff.any(-1).mean()


def _graph_coords(problem, branch):
    """The three graphs' coordinates of a branch, from JAX's forward:
    xyz, then the pooled features x1 and x2."""
    x = _branch_input(problem, branch)
    return [x[..., :3]] + problem["pooled"][branch]


@pytest.mark.parametrize("branch,layer", [
    ("pcd_emb", 0), ("pcd_emb", 1), ("pcd_emb", 2), ("model_emb", 0),
    ("model_emb", 1), ("model_emb", 2), ("grid", 0)])
def test_graphs_match_jax_knn(problem, branch, layer):
    """graph_feature_b's graph on JAX's coordinates against JAX's exact
    knn: equal beyond near-ties, and equal on > 90% of the rows; the edge
    features bit-equal to JAX's graph_feature_b where the graphs are
    equal.  "grid" is the rendered scene without its depth noise."""
    import jax.numpy as jnp

    from gdm_tpu.models.dgcnn import graph_feature_b as gf_j
    from gdm_tpu.ops.knn import knn

    k = 20 if branch == "model_emb" else 16
    if branch == "grid":
        feats = problem["grid"]
    else:
        feats = (_branch_input(problem, branch) if layer == 0
                 else problem["pooled"][branch][layer - 1])
    coords = feats[..., :3] if layer == 0 else feats
    pos = coords if layer == 0 else None
    e_t, idx_t = dgcnn_t.graph_feature_b(
        torch.from_numpy(np.ascontiguousarray(feats)), k,
        None if pos is None else torch.from_numpy(
            np.ascontiguousarray(pos)), knn_chunk=64)
    idx_j = np.stack([np.asarray(knn(jnp.asarray(c), jnp.asarray(c), k,
                                     chunk=1024)) for c in coords])
    equal = _equal_beyond_near_ties(coords, idx_t.numpy(), idx_j, k)
    assert equal > 0.9, equal
    assert (idx_t.numpy()[..., 0] == np.arange(coords.shape[1])).mean() \
        > 0.99                                   # the point itself first
    e_j = np.asarray(gf_j(jnp.asarray(feats), k, pos=None if pos is None
                          else jnp.asarray(pos)))
    same = (idx_t.numpy() == idx_j).all(-1)
    np.testing.assert_array_equal(e_t.numpy()[same], e_j[same])


def _port_graphs(trunk, x):
    """The three graphs the port's ``trunk`` builds on input ``x``."""
    pooled = []
    hooks = [getattr(trunk, c).register_forward_hook(
        lambda mod, inp, out: pooled.append(out.amax(dim=2)))
        for c in ("conv2", "conv4")]
    try:
        with torch.no_grad():
            dgcnn_t.DgcnnTrunk.forward(trunk, x)
    finally:
        for h in hooks:
            h.remove()
    return [dgcnn_t.graph_feature_b(c, trunk.k, knn_chunk=64)[1].numpy()
            for c in [x[..., :3]] + pooled]


@pytest.fixture(scope="module")
def port_eval(problem):
    import jax.numpy as jnp

    from gdm_tpu.ops.knn import knn

    m = _port_model(problem["sd"]).eval()
    inputs = H.to_torch(problem["inputs"])
    mesh_x = torch.from_numpy(problem["mesh_x"])
    with torch.no_grad():
        out = m(inputs, mesh_x)
        branches = {"pcd_emb": m.pcd_emb(inputs["cld_rgb_nrm"]).numpy(),
                    "model_emb": m.encode_mesh(mesh_x).numpy()}
    agree = {}
    for br, x in (("pcd_emb", inputs["cld_rgb_nrm"]),
                  ("model_emb", mesh_x[None])):
        k = getattr(m, br).k
        g_t = _port_graphs(getattr(m, br), x)
        g_j = _graph_coords(problem, br)
        g_j = [np.stack([np.asarray(knn(jnp.asarray(c), jnp.asarray(c), k,
                                        chunk=1024)) for c in co])
               for co in g_j]
        # the edge convs max-pool over the neighbours: a graph agrees
        # where each point has the same neighbour set
        agree[br] = np.stack([(np.sort(a, -1) == np.sort(b, -1)).all((1, 2))
                              for a, b in zip(g_t, g_j)]).all(0)
    return {"out": {k: v.numpy() for k, v in out.items()},
            "branches": branches, "agree": agree}


@pytest.mark.parametrize("branch", ["pcd_emb", "model_emb"])
def test_branch_forwards_match_jax(problem, port_eval, branch):
    """DgcnnPointEmb / DgcnnMeshEmb eval forwards within 1e-4 on the
    elements whose three graphs give every point JAX's neighbour set
    (all of them here)."""
    from gdm_tpu.models.dgcnn import DgcnnMeshEmb, DgcnnPointEmb

    v = problem["variables"]
    sub = {"params": v["params"][branch],
           "batch_stats": v["batch_stats"][branch]}
    x = _branch_input(problem, branch)
    if branch == "pcd_emb":
        want = np.asarray(DgcnnPointEmb(16).apply(sub, x, train=False))
    else:
        want = np.asarray(DgcnnMeshEmb(20).apply(sub, x[0], train=False))
    agree = port_eval["agree"][branch]
    assert agree.all(), agree
    got = port_eval["branches"][branch]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert H.rel_err(got, want) <= TOL, H.rel_err(got, want)


@pytest.mark.parametrize("key", ["seg", "rgbd", "mesh"])
def test_end_points_match_jax(problem, port_eval, key):
    assert port_eval["agree"]["pcd_emb"].all()
    assert port_eval["agree"]["model_emb"].all()
    got, want = port_eval["out"][key], problem["out"][key]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert H.rel_err(got, want) <= TOL, H.rel_err(got, want)


def test_mesh_input_is_the_jax_clis():
    """mesh_input of the fps array in metres equals the JAX CLI's DGCNN
    mesh input (gdm_tpu/cli.py _make_model) bit for bit."""
    import dataclasses

    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs.base import LMO

    cfg = dataclasses.replace(LMO, model=dataclasses.replace(
        LMO.model, backbone="dgcnn"))
    fps = H.mesh_fps()
    fps_m = np.concatenate([fps[:, :3] / 1000.0, fps[:, 3:]], axis=1)
    _, mx_j, xyz_j, needs = cli_j._make_model(cfg, 0.1, fps_m, None,
                                              exact_knn=True)
    np.testing.assert_array_equal(mesh_input(fps_m), np.asarray(mx_j))
    np.testing.assert_array_equal(mesh_input(fps_m)[:, :3],
                                  np.asarray(xyz_j))
    assert not needs


def _forward_backward(problem, inputs, dtype=torch.float32):
    m = _port_model(problem["sd"], awl=True, dtype=dtype)
    m.train()
    set_train_step_state(m, MOMENTUM, None)
    t = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in H.to_torch(inputs).items()}
    out = m(t, torch.from_numpy(problem["mesh_x"]).to(dtype), train=True)
    out["loss"].backward()
    return m, out


@pytest.fixture(scope="module")
def port_step(problem):
    return _forward_backward(problem, problem["inputs"])


@pytest.mark.parametrize("key", ["loss", "seg_loss", "match_loss"])
def test_train_loss_values_match_jax(problem, port_step, key):
    want, got = problem["vals"][key], float(port_step[1][key].detach())
    assert abs(got - want) <= VAL_TOL * abs(want), (got, want)


def test_batch_norm_statistics_match_jax(problem, port_step):
    n = 0
    for name, buf in port_step[0].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            want = np.asarray(problem["stats"][name])
            assert H.rel_err(buf.numpy(), want) <= GRAD_TOL, name
            n += 1
    assert n == 2 * (2 * 8 + 3 + 1 + 3)        # both trunks, the heads


def test_every_gradient_matches_jax(problem, port_step):
    """Each gradient tensor within max|d|/max|ref| <= 1e-4 of JAX's, or
    else the port's and JAX's f32 gradients both within 8 s_t + 1e-4 of
    the port's float64 gradient, s_t the port's own f32 spread (the
    largest change of its gradient when every float input moves by a
    relative 1e-7, over four draws): tests/test_torch_train.py's rule,
    max|ref| floored at 1e-6 of the largest gradient."""
    model = port_step[0]
    m64, _ = _forward_backward(problem, problem["inputs"], torch.float64)
    exact = {k: p.grad.numpy() for k, p in m64.named_parameters()}
    floor = 1e-6 * max(np.abs(g).max() for g in exact.values())
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}

    def err(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), floor))

    rng = np.random.RandomState(11)
    spread = dict.fromkeys(exact, 0.0)
    for _ in range(4):
        moved = {k: (v * (1 + 1e-7 * rng.randn(*v.shape))).astype(np.float32)
                 if v.dtype == np.float32 else v
                 for k, v in problem["inputs"].items()}
        m, _ = _forward_backward(problem, moved)
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
    assert direct >= 5 and len(exact) == len(list(model.parameters()))


# -- the weight bridge --------------------------------------------------------

def test_state_dict_keys_equal_export_minus_aliases(problem):
    """The port's names are the exported reference names without the
    bnN duplicates; its aliases of this backbone are the bnN names."""
    from gdm_tpu.train.import_torch import _ALIASES

    exported = problem["sd"]
    own = set(GeoMatchDGCNN(awl=True).state_dict())
    dup = {d: n for d, n in weights.ALIASES.items() if n in own}
    assert own == set(exported) - set(dup)
    assert len(dup) == 2 * 8 * 5 and set(dup) <= set(exported)
    assert {a: b for a, b in _ALIASES.items() if b in own} \
        == {d: n for d, n in dup.items()
            if not d.endswith("num_batches_tracked")}


def test_strict_load_keeps_every_value(problem):
    m = GeoMatchDGCNN(awl=True)
    weights.load_reference_state_dict(m, problem["sd"])
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(problem["sd"][k]),
                                      err_msg=k)


@pytest.mark.parametrize("keep", ["bnN", "convN.1"])
def test_each_bn_name_alone_loads(problem, keep):
    """A dict holding each DGCNN BN under one of its two names only."""
    own = GeoMatchDGCNN().state_dict()
    dup = {d: n for d, n in weights.ALIASES.items() if n in own}
    drop = set(dup.values()) if keep == "bnN" else set(dup)
    sd = {k: v for k, v in problem["sd"].items() if k not in drop}
    assert len(sd) == len(problem["sd"]) - 80
    m = GeoMatchDGCNN(awl=True)
    weights.load_reference_state_dict(m, sd)
    key = "pcd_emb.conv3.1.running_var"
    np.testing.assert_array_equal(m.state_dict()[key].numpy(),
                                  problem["sd"][key])


def test_reference_state_dict_loads_into_jax(problem):
    """The port's reference_state_dict holds both BN names and goes back
    through JAX's strict import with nothing missing or unused."""
    from gdm_tpu.train.import_torch import export_state_dict, \
        import_state_dict

    m = GeoMatchDGCNN(awl=True)
    weights.init_random_(m, torch.Generator().manual_seed(5))
    sd = weights.reference_state_dict(m)
    assert set(sd) == set(problem["sd"])
    v = problem["variables"]
    params, stats, report = import_state_dict(
        v["params"], v["batch_stats"], {k: t.numpy() for k, t in sd.items()},
        strict=True)
    assert report["missing"] == [] and report["unused"] == []
    back = weights.reference_state_dict(m)
    for k, t in export_state_dict(params, stats).items():
        np.testing.assert_array_equal(np.asarray(t).reshape(back[k].shape),
                                      back[k].numpy(), err_msg=k)


def test_seeded_init_is_reproducible_and_finite():
    a, b = GeoMatchDGCNN(awl=True), GeoMatchDGCNN(awl=True)
    weights.init_random_(a, torch.Generator().manual_seed(3))
    weights.init_random_(b, torch.Generator().manual_seed(3))
    n_random = 0
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        assert torch.isfinite(va.float()).all(), k
        n_random += va.dim() == 2
    assert n_random == 2 * 9 + 4 + 4 + 1

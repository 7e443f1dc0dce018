"""bf16 compute of the port (``model.compute_dtype``,
``model.gather_bwd_dtype``) against the JAX package's on the CPU, on the
tiny problem of _torch_harness at the full model widths, and the config
fields that carry it.

Forwards.  The port in bf16 is held against JAX in bf16 (both models
under one set of f32 weights, JAX jitted as its CLI runs it) by JAX's own
bf16 gap: max|port16 - jax16| / max|jax16| <= GAP_FACTOR x max|jax16 -
jax32| / max|jax32|, measured here on the same inputs, and <= CEILING on
``seg`` and ``rgbd``.  The flagship's ``mesh`` is an f32 branch: <= 1e-4.

GAP_FACTOR is 2, not 1, for an XLA-side cause.  XLA's CPU convolutions
sum their f32 products in another order than oneDNN's, so a product
within an f32 rounding of a bf16 rounding boundary rounds the other way
in one package (0.01% of the first layers' outputs here); each such flip
moves a value by a bf16 ulp, and the flips spread through the layers
after it.  By the last layers the two packages' bf16 roundings are about
as independent as either's is of f32, so their distance reaches about
sqrt(2) x the gap (seen here: up to 1.7x on ``rgbd``).  Every cast of the
JAX modules is mirrored (models/layers.py), including three places where
XLA rounds otherwise than torch would (the bias after the rounded
product, bf16(0.2) as LeakyReLU's slope, unrounded exp and products
under JAX's f32 reductions); with those, the ResNet stem and the first
RandLA block agree with jitted JAX bit for bit but for those flips.

DGCNN runs exact graphs (``approx_knn=False``).  Its first graph is over
f32 xyz in both packages and equal beyond near-ties (tests/
test_torch_dgcnn.py's rule); graphs 2 and 3 rank each package's own bf16
features widened to f32, and give the same neighbour sets on >= 90% of
the rows; ties of the widened distances go to the lower index.

Dtypes are read by forward hooks: every conv and dense input inside the
encoder and both DGCNN trunks is bf16; the heads' inputs, the flagship's
mesh branch, the KNN coordinates and every parameter are f32.

The gather's backward (models/layers.gather_rows) against JAX's
``gather_neighbours_b`` VJP under ``set_gather_bwd_dtype``: from n = 700
source rows (one-hot branch) and n = 256 (segment sum), f32 and bf16
features, both ``gather_bwd_dtype`` values.  Where the sum is f32 (n >=
512, or f32 features) both add identically rounded terms in f32: <= 1e-5
relative.  With bf16 features below 512 rows both sum in bf16 in their
own order (JAX's segment_sum adds in index order, rounding each add):
each entry of m terms within (m - 1) 2^-7 of the sum of its terms'
magnitudes, the two orders' recursive-summation bounds (m - 1) u sum|t|,
u = 2^-8, added.  2^-7 alone holds for m <= 2 only: on an entry of 11
terms here JAX's own sum is 0.008 sum|t| from the exact one.

Config: the port's field set is JAX's, walked from JAX's dataclasses;
every JAX field takes an override in both packages with equal results;
``model.randla_k`` other than 16 and dtypes other than float32 and
bfloat16 are refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_torch_dgcnn as TD
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.models import dgcnn as dgcnn_t
from gdm_tpu_torch.models.build import torch_dtype
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN
from gdm_tpu_torch.models.layers import ONEHOT_BWD_MIN_N, Dense, \
    gather_rows
from gdm_tpu_torch.models.resnet import Conv
from gdm_tpu_torch.models.spline_mesh import SplineConv, build_mesh_graph
from gdm_tpu_torch.ops.knn import pairwise_sqdist

torch.set_num_threads(1)
GAP_FACTOR = 2.0    # x JAX's own bf16-vs-f32 gap (module docstring)
CEILING = 2e-2      # max|d| / max|ref| on seg and rgbd, whatever the gap
MESH_TOL = 1e-4     # the flagship's f32 mesh branch
SUM_TOL = 1e-5      # gather backward where both sum in f32
HEADS = ("feature_encoding_layer", "normalize_feature_layer", "seg_layer")


class DtypeLog:
    """(input dtype, output dtype) of every conv, dense and spline conv of
    a model, by name, from forward hooks; a conv's output dtype is that of
    the operands it multiplied."""

    def __init__(self, model):
        self.seen = {}
        self.hooks = [m.register_forward_hook(self._hook(n))
                      for n, m in model.named_modules()
                      if isinstance(m, (Conv, Dense, SplineConv))]

    def _hook(self, name):
        def f(mod, args, out):
            self.seen.setdefault(name, set()).add((args[0].dtype, out.dtype))
        return f

    def remove(self):
        for h in self.hooks:
            h.remove()

    def under(self, prefix):
        return {n: d for n, d in self.seen.items() if n.startswith(prefix)}


BF16 = {(torch.bfloat16, torch.bfloat16)}
F32 = {(torch.float32, torch.float32)}


def _gaps(out_t, out_16, out_32, key):
    return H.rel_err(out_t[key], out_16[key]), \
        H.rel_err(out_16[key], out_32[key])


@pytest.fixture(scope="module")
def flagship():
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs
    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models import GeoMatch as GeoMatchJ
    from gdm_tpu.models.geomatch import MeshArrays as MeshArraysJ
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j
    from gdm_tpu.train.import_torch import export_state_dict

    fps = H.mesh_fps()
    mesh_j = MeshArraysJ.from_graph(build_j(fps, H.N_MESH))
    data, _ = make_batch(fps, H.B, H.intrinsics(), im_size=H.IM,
                         n_sample=H.N_SAMPLE, seed=0)
    inputs = assemble_inputs(
        jnp.asarray(data["rgb"]), jnp.asarray(data["cld_rgb_nrm"]),
        jnp.asarray(data["choose"]), jnp.asarray(data["xyz_img"]),
        knn_chunk=H.KNN_CHUNK, approx=False)
    model, variables = H.jax_model_and_variables(inputs, mesh_j)
    outs = {}
    for name, dt in (("32", jnp.float32), ("16", jnp.bfloat16)):
        m = GeoMatchJ(positive_r=0.01, compute_dtype=dt)
        o = jax.jit(lambda v, i, mj, m=m: m.apply(v, i, mj, train=False))(
            variables, inputs, mesh_j)
        outs[name] = {k: np.asarray(v) for k, v in o.items()}

    port = GeoMatch(compute_dtype=torch.bfloat16)
    weights.load_reference_state_dict(port, export_state_dict(
        variables["params"], variables["batch_stats"]))
    port.eval()
    log = DtypeLog(port)
    mesh_t = MeshArrays.from_graph(build_mesh_graph(fps, H.N_MESH), "cpu")
    with torch.no_grad():
        out_t = port(H.to_torch(inputs), mesh_t)
    log.remove()
    return {"out_t": out_t, "j16": outs["16"], "j32": outs["32"],
            "log": log, "model": port}


@pytest.mark.parametrize("key", ["seg", "rgbd"])
def test_flagship_forward_within_jax_bf16_gap(flagship, key):
    out_t = {k: v.numpy() for k, v in flagship["out_t"].items()}
    assert out_t[key].dtype == np.float32 and np.isfinite(out_t[key]).all()
    err, gap = _gaps(out_t, flagship["j16"], flagship["j32"], key)
    assert 0 < gap and err <= GAP_FACTOR * gap, (err, gap)
    assert err <= CEILING, err


def test_flagship_mesh_branch_stays_f32(flagship):
    mesh = flagship["out_t"]["mesh"].numpy()
    assert H.rel_err(mesh, flagship["j16"]["mesh"]) <= MESH_TOL
    assert H.rel_err(flagship["j16"]["mesh"], flagship["j32"]["mesh"]) == 0


def test_flagship_dtypes(flagship):
    log, model = flagship["log"], flagship["model"]
    enc = log.under("pcd_emb.")
    assert len(enc) == sum(isinstance(m, (Conv, Dense))
                           for m in model.pcd_emb.modules())
    # the PSP stages' 1x1 convs take the f32 pool of a bf16 map (the JAX
    # package's pooling matrices are f32) and multiply in bf16
    psp = {n for n in enc if ".stages." in n}
    assert len(psp) == 4
    assert all(enc[n] == {(torch.float32, torch.bfloat16)} for n in psp)
    assert all(d == BF16 for n, d in enc.items() if n not in psp), \
        {n: d for n, d in enc.items() if d != BF16}
    for prefix in HEADS + ("model_emb.",):
        got = log.under(prefix)
        assert got and all(d == F32 for d in got.values()), got
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for n, b in model.named_buffers()
            if "num_batches" not in n} == {torch.float32}
    assert {v.dtype for v in flagship["out_t"].values()} == {torch.float32}


@pytest.fixture(scope="module")
def dgcnn(monkeypatch_module):
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models.geomatch_dgcnn import GeoMatchDGCNN as GeoMatchJ
    from gdm_tpu.ops.knn import knn as knn_j
    from gdm_tpu.train.import_torch import export_state_dict

    data, _ = make_batch(H.mesh_fps(), H.B, H.intrinsics(), im_size=H.IM,
                         n_sample=H.N_SAMPLE, seed=0)
    cld = np.asarray(data["cld_rgb_nrm"]).copy()
    # 0.1 mm of depth noise off the renderer's exact grid plane, centred
    # (tests/test_torch_dgcnn.py)
    cld[..., :3] += 1e-4 * np.random.RandomState(1).randn(*cld[..., :3].shape)
    cld[..., :3] -= cld[..., :3].reshape(-1, 3).mean(0)
    mesh_x = TD._mesh_x()
    ij, mx = {"cld_rgb_nrm": jnp.asarray(cld)}, jnp.asarray(mesh_x)
    key = jax.random.PRNGKey(0)
    m32 = GeoMatchJ()
    variables = jax.jit(lambda r, i, m: m32.init(
        {"params": r, "dropout": r}, i, m, train=False))(key, ij, mx)
    outs, pooled = {}, None
    for name, dt in (("32", jnp.float32), ("16", jnp.bfloat16)):
        m = GeoMatchJ(compute_dtype=dt)
        o, inter = jax.jit(lambda v, i, mj, m=m: m.apply(
            v, i, mj, train=False, capture_intermediates=lambda mdl, _:
            mdl.name in ("conv2", "conv4")))(variables, ij, mx)
        outs[name] = {k: np.asarray(v) for k, v in o.items()}
        if name == "16":
            pooled = {br: [np.asarray(inter["intermediates"][br]["trunk"][c][
                "__call__"][0].astype(jnp.float32)).max(axis=2)
                for c in ("conv2", "conv4")]
                for br in ("pcd_emb", "model_emb")}

    port = GeoMatchDGCNN(compute_dtype=torch.bfloat16)
    weights.load_reference_state_dict(port, export_state_dict(
        variables["params"], variables["batch_stats"]))
    port.eval()
    coords, port_pooled = [], {"pcd_emb": [], "model_emb": []}
    real_knn = dgcnn_t.knn

    def knn_logged(support, query, k, chunk):
        coords.append((support.dtype, query.dtype))
        return real_knn(support, query, k, chunk)

    monkeypatch_module.setattr(dgcnn_t, "knn", knn_logged)
    hooks = [getattr(getattr(port, br), c).register_forward_hook(
        lambda mod, inp, out, br=br: port_pooled[br].append(out.amax(2)))
        for br in port_pooled for c in ("conv2", "conv4")]
    log = DtypeLog(port)
    with torch.no_grad():
        out_t = port({"cld_rgb_nrm": torch.from_numpy(cld)},
                     torch.from_numpy(mesh_x))
    log.remove()
    for h in hooks:
        h.remove()
    knn_dtypes = list(coords)
    graphs = {}
    for br, x in (("pcd_emb", cld), ("model_emb", mesh_x[None])):
        k = getattr(port, br).k
        xs_t = [torch.from_numpy(x[..., :3])] + port_pooled[br]
        xs_j = [x[..., :3]] + pooled[br]
        graphs[br] = [
            (c_t, dgcnn_t.graph_feature_b(c_t, k, knn_chunk=64)[1].numpy(),
             c_j, np.stack([np.asarray(knn_j(jnp.asarray(c), jnp.asarray(c),
                                             k, chunk=1024)) for c in c_j]))
            for c_t, c_j in zip(xs_t, xs_j)]
    return {"out_t": {k: v.numpy() for k, v in out_t.items()},
            "j16": outs["16"], "j32": outs["32"], "log": log,
            "model": port, "knn_dtypes": knn_dtypes, "graphs": graphs}


@pytest.fixture(scope="module")
def monkeypatch_module():
    from _pytest.monkeypatch import MonkeyPatch

    mp = MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("key", ["seg", "rgbd", "mesh"])
def test_dgcnn_forward_within_jax_bf16_gap(dgcnn, key):
    out_t = dgcnn["out_t"]
    assert out_t[key].dtype == np.float32 and np.isfinite(out_t[key]).all()
    err, gap = _gaps(out_t, dgcnn["j16"], dgcnn["j32"], key)
    assert 0 < gap and err <= GAP_FACTOR * gap, (err, gap)
    assert err <= CEILING, err


@pytest.mark.parametrize("branch", ["pcd_emb", "model_emb"])
def test_dgcnn_graphs(dgcnn, branch):
    """The xyz graph equal to JAX's beyond near-ties; graphs 2 and 3 (on
    each package's bf16 features, widened) equal as neighbour sets on >=
    90% of the rows; the port's ties to the lower index."""
    (c0, g0_t, c0_j, g0_j), *rest = dgcnn["graphs"][branch]
    k = g0_t.shape[-1]
    assert TD._equal_beyond_near_ties(c0.numpy(), g0_t, g0_j, k) > 0.9
    for c_t, g_t, _, g_j in rest:
        assert c_t.dtype == torch.bfloat16
        same = (np.sort(g_t, -1) == np.sort(g_j, -1)).all(-1)
        assert same.mean() >= 0.9, same.mean()
        d = pairwise_sqdist(c_t, c_t)
        dk = torch.gather(d, 2, torch.from_numpy(g_t)).numpy()
        tied = dk[..., 1:] == dk[..., :-1]
        assert (g_t[..., 1:] > g_t[..., :-1])[tied].all()


def test_dgcnn_dtypes(dgcnn):
    log, model = dgcnn["log"], dgcnn["model"]
    for br in ("pcd_emb.", "model_emb."):
        got = log.under(br)
        assert len(got) == 9
        assert all(d == BF16 for d in got.values()), got
    for prefix in HEADS:
        got = log.under(prefix)
        assert got and all(d == F32 for d in got.values()), got
    assert set(dgcnn["knn_dtypes"]) == {(torch.float32, torch.float32)}
    assert len(dgcnn["knn_dtypes"]) == 6
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("bwd", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [700, 256])
def test_gather_backward_matches_jax(n, feat, bwd):
    import jax
    import jax.numpy as jnp

    from gdm_tpu.models import randla

    assert (n >= ONEHOT_BWD_MIN_N) == (n >= randla._ONEHOT_BWD_MIN_N)
    rng = np.random.RandomState(3)
    f = rng.randn(2, n, 12).astype(np.float32)
    idx = rng.randint(0, n, (2, n, 5))
    ct = rng.randn(2, n, 5, 12).astype(np.float32)
    jdt, tdt = jnp.dtype(feat), getattr(torch, feat)
    try:
        randla.set_gather_bwd_dtype(bwd)
        _, vjp = jax.vjp(lambda x: randla.gather_neighbours_b(
            x, jnp.asarray(idx, jnp.int32)), jnp.asarray(f, jdt))
        (g_j,) = vjp(jnp.asarray(ct, jdt))
    finally:
        randla.set_gather_bwd_dtype(None)
    x = torch.from_numpy(f).to(tdt).requires_grad_()
    y = gather_rows(x, torch.from_numpy(idx), torch_dtype(bwd))
    xf = x.detach().float().numpy()
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.stack([xf[b][idx[b]] for b in (0, 1)]))
    y.backward(torch.from_numpy(ct).to(tdt))
    assert x.grad.dtype == tdt
    g_t = x.grad.float().numpy()
    g_j = np.asarray(g_j.astype(jnp.float32))
    if n >= ONEHOT_BWD_MIN_N or feat == "float32":
        assert H.rel_err(g_t, g_j) <= SUM_TOL, H.rel_err(g_t, g_j)
    else:
        terms, count = np.zeros_like(g_t), np.zeros(g_t.shape[:2] + (1,))
        mag = np.abs(torch.from_numpy(ct).to(tdt).float().numpy())
        for b in range(2):
            np.add.at(terms[b], idx[b].reshape(-1), mag[b].reshape(-1, 12))
            np.add.at(count[b], idx[b].reshape(-1), 1)
        assert count.max() > 2
        bound = np.maximum(count - 1, 1) * 2.0 ** -7 * terms
        assert (np.abs(g_t - g_j) <= bound).all()


def test_gather_backward_f32_is_autograds():
    """With f32 features (either bwd dtype below 512 rows, float32 above)
    the backward is autograd's index_select backward bit for bit."""
    rng = np.random.RandomState(4)
    for n in (700, 256):
        f = torch.from_numpy(rng.randn(2, n, 6).astype(np.float32))
        idx = torch.from_numpy(rng.randint(0, n, (2, 40, 3)))
        ct = torch.from_numpy(rng.randn(2, 40, 3, 6).astype(np.float32))
        a = f.clone().requires_grad_()
        gather_rows(a, idx).backward(ct)
        b = f.clone().requires_grad_()
        off = (torch.arange(2) * n).view(2, 1, 1)
        b.reshape(2 * n, 6).index_select(0, (idx + off).reshape(-1)).view(
            2, 40, 3, 6).backward(ct)
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def _override(value) -> str:
    """``value`` written as an --opt value of its field."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return "none"
    if isinstance(value, (tuple, list)):
        return ",".join(str(v) for v in value)
    return str(value)


def test_config_field_sets_are_jaxs():
    """Walked from JAX's dataclasses, section by section and at the top
    level."""
    from gdm_tpu.configs import base as cfg_j

    def names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    assert names(configs.Config) == names(cfg_j.Config)
    for cls_j, cls_t in ((cfg_j.DataConfig, configs.DataConfig),
                         (cfg_j.ModelConfig, configs.ModelConfig),
                         (cfg_j.SolverConfig, configs.SolverConfig)):
        missing = [n for n in names(cls_j) if n not in names(cls_t)]
        assert not missing, missing
        assert sorted(names(cls_t)) == sorted(names(cls_j))


@pytest.mark.parametrize("name", ["lmo", "lmfull", "ycbv"])
def test_every_jax_field_overrides_alike(name):
    """Every field of JAX's preset, walked from JAX's config: the port's
    default equals it, and an override of it parses to the same value in
    both packages."""
    from gdm_tpu.configs.base import get_config

    want = get_config(name)
    assert configs.get_config(name).checkpoints_dir == want.checkpoints_dir
    n = 0
    for part in ("data", "model", "solver"):
        for f in dataclasses.fields(getattr(want, part)):
            val = getattr(getattr(want, part), f.name)
            got = getattr(getattr(configs.get_config(name), part), f.name)
            assert got == val, (part, f.name)
            opt = [f"{part}.{f.name}={_override(val)}"]
            got = getattr(getattr(configs.get_config(name, opt), part),
                          f.name)
            assert got == getattr(getattr(get_config(name, opt), part),
                                  f.name), opt
            n += 1
    assert n == 44


def test_bf16_fields_parse_and_refusals():
    cfg = configs.get_config("ycbv", ["model.compute_dtype=bfloat16",
                                      "model.gather_bwd_dtype=bfloat16",
                                      "solver.num_workers=2"])
    assert (cfg.model.compute_dtype, cfg.model.gather_bwd_dtype,
            cfg.solver.num_workers) == ("bfloat16", "bfloat16", 2)
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is None
    for field in ("compute_dtype", "gather_bwd_dtype"):
        for bad in ("float16", "bf16", "float64"):
            with pytest.raises(ValueError, match=f"model.{field}"):
                configs.get_config("lmo", [f"model.{field}={bad}"])
    with pytest.raises(ValueError, match="float64"):
        torch_dtype("float64")
    assert cli_t.model_config("lmo", ["model.randla_k=16"]).model.randla_k \
        == 16
    with pytest.raises(ValueError, match="randla_k"):
        cli_t.model_config("lmo", ["model.randla_k=8"])
    d = dataclasses.asdict(dataclasses.replace(cfg, checkpoints_dir="x"))
    assert configs.config_from_dict(d) == dataclasses.replace(
        cfg, checkpoints_dir="x")
    del d["checkpoints_dir"], d["model"]["compute_dtype"]
    old = configs.config_from_dict(d)
    assert old.model.compute_dtype == "float32"
    assert old.checkpoints_dir == configs.Config.checkpoints_dir

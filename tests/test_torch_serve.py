"""The slice end to end: a raw request through the JAX package
(finalize_batch + run_inference(exact_knn=True, refine=None)) and through
the port's PoseEngine under the same weights.  The fg mask and the Kabsch
weights are equal and the correspondences agree up to near-ties; fitted
poses under random weights are not compared.  The engine then serves the
same request over the port's HTTP service, and over the JAX package's,
which it plugs into unchanged."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch import configs
from gdm_tpu_torch import server as server_t
from gdm_tpu_torch.serve import PoseEngine, full_f32, raw_input_spec

torch.set_num_threads(1)


def _tiny_config():
    lmo = configs.LMO
    return configs.Config(
        data=dataclasses.replace(lmo.data, input_size=H.IM,
                                 num_sample_points=H.N_SAMPLE),
        model=dataclasses.replace(lmo.model, n_mesh_node=H.N_MESH))


def _split_seg_bias(params, seg):
    """Shift the seg head's foreground bias so about half the points are
    foreground, at the widest gap between neighbouring logit margins near
    the median (random heads rarely call any point foreground; a wide gap
    keeps the mask stable under f32 reordering)."""
    d = np.sort((seg[..., 1] - seg[..., 0]).ravel())
    lo, hi = int(0.3 * d.size), int(0.7 * d.size)
    j = lo + int(np.argmax(np.diff(d[lo:hi + 1])))
    thr = 0.5 * (d[j] + d[j + 1])
    bias = np.array(params["seg_layer"]["DenseBNAct_3"]["Dense_0"]["bias"])
    bias[1] -= thr
    params = dict(params)
    params["seg_layer"] = dict(params["seg_layer"])
    head = dict(params["seg_layer"]["DenseBNAct_3"])
    head["Dense_0"] = dict(head["Dense_0"], bias=bias)
    params["seg_layer"]["DenseBNAct_3"] = head
    return params


@pytest.fixture(scope="module")
def slice_run():
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.infer import run_inference
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import export_state_dict

    fps = H.mesh_fps()
    raw = H.raw_request(seed=1)
    mesh = MeshArrays.from_graph(build_mesh_graph(fps, H.N_MESH))
    fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], approx=False)
    model, variables = H.jax_model_and_variables(inputs, mesh)
    mesh_feats = model.apply(variables, mesh, train=False,
                             method="encode_mesh")
    seg = model.apply(variables, inputs, mesh, train=False,
                      mesh_features=mesh_feats)["seg"]
    params = _split_seg_bias(variables["params"], np.asarray(seg))
    variables = {"params": params, "batch_stats": variables["batch_stats"]}

    out = model.apply(variables, inputs, mesh, train=False,
                      mesh_features=mesh_feats)
    _, w, idx = jax.vmap(lambda c, s, r, d: fit_pose_single(
        c, s, out["mesh"], r, mesh.xyz, d))(
            fin["cld_rgb_nrm"][..., :3], out["seg"], out["rgbd"],
            fin["det"])
    poses = run_inference(
        model.apply, variables, fin, mesh, mesh_feats, mesh.xyz,
        jnp.float32(0.01), needs_pyramid=True, knn_chunk=1024,
        exact_knn=True, refine=None)

    sd = export_state_dict(variables["params"], variables["batch_stats"])
    engine = PoseEngine(_tiny_config(), fps, sd, "cpu", batch=H.B)
    poses_t = engine.run(raw)
    rgbd = np.asarray(out["rgbd"])
    return {"raw": raw, "engine": engine, "poses_t": poses_t,
            "fit_t": {k: v.numpy() for k, v in engine.last_fit.items()},
            "w": np.asarray(w), "idx": np.asarray(idx),
            "fg": np.asarray(jnp.argmax(out["seg"], -1) == 1),
            "rgbd": rgbd, "mesh": np.asarray(out["mesh"]),
            "poses": np.asarray(poses)}


def test_fg_mask_and_weights_equal(slice_run):
    r = slice_run
    assert 0.2 < r["fg"].mean() < 0.8, r["fg"].mean()
    np.testing.assert_array_equal(r["fit_t"]["w"] > 0, r["fg"])
    np.testing.assert_array_equal(r["fit_t"]["w"], r["w"])


def test_correspondences_agree_up_to_near_ties(slice_run):
    r = slice_run
    c = r["rgbd"].shape[-1]
    f = r["rgbd"] / np.linalg.norm(r["rgbd"], axis=-1, keepdims=True)
    mf = r["mesh"] / np.linalg.norm(r["mesh"], axis=-1, keepdims=True)
    sure = H.top2_gap(f.reshape(-1, c), mf) > 1e-5
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(r["fit_t"]["idx"].reshape(-1)[sure],
                                  r["idx"].reshape(-1)[sure])


def test_rgbd_and_mesh_features_match(slice_run):
    r = slice_run
    assert H.rel_err(r["fit_t"]["rgbd"], r["rgbd"]) <= 1e-4
    assert H.rel_err(r["fit_t"]["mesh"], r["mesh"]) <= 1e-4


def test_poses_are_rotations_or_miss(slice_run):
    """Finite [B, 3, 4]; a fitted R is a rotation, as on the JAX side.
    Which frames miss follows from the (equal) weights."""
    r = slice_run
    p, pj = r["poses_t"], r["poses"]
    assert p.shape == pj.shape == (H.B, 3, 4) and np.isfinite(p).all()
    for rt, rt_j, w in zip(p, pj, r["w"]):
        miss = w.sum() < 5
        assert (rt[2, 3] == -1000.0) == miss == (rt_j[2, 3] == -1000.0)
        if not miss:
            R = rt[:, :3].astype(np.float64)
            np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
            assert abs(np.linalg.det(R) - 1) < 1e-5


def test_meta_raw_spec_matches_jax_artifact_spec():
    from gdm_tpu.serve import raw_input_spec as spec_j

    want = {k: [list(v.shape), str(v.dtype)] for k, v in sorted(
        spec_j(8, 256, 4096, fill_depth=False).items())}
    assert raw_input_spec(8, 256, 4096) == want


def test_engine_refuses_cuda_when_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch import GeoMatch

    m = GeoMatch()
    weights.init_random_(m, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseEngine(_tiny_config(), H.mesh_fps(), m.state_dict(), "cuda",
                   batch=H.B)


def _serve_and_compare(engine, raw, service_mod):
    """PoseService + make_server of ``service_mod`` on 127.0.0.1:0 over
    ``engine``: a full and a short (padded) request give the engine's
    poses."""
    service = service_mod.PoseService({"obj": engine})
    server = service_mod.make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
        poses, ms = service_mod.request_poses(url, raw)
        np.testing.assert_array_equal(poses, engine.run(raw))
        assert ms > 0
        short = {k: v[:1] for k, v in raw.items()}
        padded = {k: np.concatenate([v[:1], v[:1]]) for k, v in raw.items()}
        poses1, _ = service_mod.request_poses(url, short)
        np.testing.assert_array_equal(poses1, engine.run(padded)[:1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_http_service_answers_like_engine(slice_run):
    """The port's own HTTP service over the CPU engine."""
    _serve_and_compare(slice_run["engine"], slice_run["raw"], server_t)


def test_jax_package_service_serves_engine_unchanged(slice_run):
    """gdm_tpu.server takes the engine as it takes a JAX artifact."""
    from gdm_tpu import server as server_j

    _serve_and_compare(slice_run["engine"], slice_run["raw"], server_j)


def test_engine_computes_with_tf32_off(slice_run, monkeypatch):
    """infer runs the model with TF32 off for matmuls and convolutions,
    whatever the caller set, and leaves the caller's settings as they
    were."""
    import gdm_tpu_torch.serve as serve_t

    seen = []
    real = serve_t.run_inference

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*args)

    monkeypatch.setattr(serve_t, "run_inference", spy)
    engine = slice_run["engine"]
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        poses = engine.run(slice_run["raw"])
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError), full_f32():
            raise ValueError       # restored on the way out of an error
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
    np.testing.assert_array_equal(poses, slice_run["poses_t"])


def test_lmo_config_matches_jax_preset():
    """Every field of the port's LMO equals the JAX package's preset."""
    from gdm_tpu.configs.base import get_config

    ref = get_config("lmo")
    for part in ("data", "model"):
        for f in dataclasses.fields(getattr(configs.LMO, part)):
            want = getattr(getattr(ref, part), f.name)
            got = getattr(getattr(configs.LMO, part), f.name)
            assert tuple(got) == tuple(want) if isinstance(want, (
                tuple, list)) else got == want, (part, f.name)


class _FakeEngine:
    """meta + run, as PoseService needs; poses are the batch index."""

    def __init__(self, batch=4):
        self.meta = {"raw_spec": raw_input_spec(batch, 8, 16)}
        self.platforms = ("cpu",)

    def run(self, raw):
        b = raw["det"].shape[0]
        return np.arange(b, dtype=np.float32)[:, None, None] \
            * np.ones((b, 3, 4), np.float32)


@pytest.mark.parametrize("case,code", [
    ("missing", 400), ("extra", 400), ("dtype", 400), ("shape", 400),
    ("ragged_batch", 400), ("too_big", 400), ("unknown_obj", 404)])
def test_service_rejects_bad_requests(case, code):
    svc = server_t.PoseService({"a": _FakeEngine()})
    raw = server_t.synthetic_raw(raw_input_spec(2, 8, 16))
    obj = None
    if case == "missing":
        del raw["det"]
    elif case == "extra":
        raw["dpt_filled"] = np.zeros((2, 8, 8), np.float32)
    elif case == "dtype":
        raw["choose"] = raw["choose"].astype(np.int64)
    elif case == "shape":
        raw["rgb_u8"] = raw["rgb_u8"][:, :4]
    elif case == "ragged_batch":
        raw["det"] = raw["det"][:1]
    elif case == "too_big":
        raw = server_t.synthetic_raw(raw_input_spec(5, 8, 16))
    else:
        obj = "b"
    with pytest.raises(server_t.RequestError) as e:
        svc.run(obj, raw)
    assert e.value.code == code


def test_service_pads_short_batches_and_warms_up():
    svc = server_t.PoseService({"a": _FakeEngine()})
    raw = server_t.synthetic_raw(raw_input_spec(3, 8, 16))
    poses, ms = svc.run(None, raw)
    np.testing.assert_array_equal(poses, _FakeEngine().run(raw))
    assert ms >= 0
    svc.warmup()


def test_synthetic_raw_matches_jax_fill():
    from gdm_tpu.serve import synthetic_raw as fill_j

    spec = raw_input_spec(2, 16, 32)
    got, want = server_t.synthetic_raw(spec), fill_j(spec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

"""The port's ``cli export-serving`` and ``cli serve``, and ``--profile-dir``,
on the CPU, on the mini BOP tree of tests/test_data.py.

Weights are built as in tests/test_torch_cli.py (a flax init whose
feature heads are centred and whose seg head is split near the median,
so that matches spread and the fits are well posed), exported as
<ckpt>/ape/geomatch.pth.tar.  Both CLIs export the object at batch 2:

- the port's meta.json carries JAX's ``raw_spec``, ``icp_reject_m``,
  ``diameter_m``, ``obj_name`` and ``cls_id`` (equal), here and with
  ``--opt data.fill_depth=true`` and ``--opt model.backbone=dgcnn``;
- ``cli serve`` of the port's artifact answers the 4 infer frames, in
  batches of 2 over HTTP, with the poses of the port's ``cli infer
  --batch-size 2`` (within 1e-5);
- JAX's ServingArtifact runs on the same raw arrays: the served Kabsch
  weights equal those of JAX's fit of the same arrays within 1e-5, its
  correspondences agree beyond near-ties (top-2 gap <= 1e-5), and the
  served poses equal the JAX artifact's within 1e-4 on frames whose
  weighted correspondences all agree (under random weights one flipped
  near-tie can swing a Kabsch fit anywhere);
- a JAX artifact, a newer format and a duplicate name are refused, as
  tests/test_serve.py's tree layout test refuses them."""

import json
import os
import os.path as osp
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_data
from test_data import bop_root  # noqa: F401
from test_torch_cli import _read_csv, _spread_matches
from test_torch_dataset import port_config
from test_torch_serve import _split_seg_bias
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate
from gdm_tpu_torch.server import load_artifact_tree, request_poses

torch.set_num_threads(1)
BS = 2
META_KEYS = ("raw_spec", "icp_reject_m", "diameter_m", "obj_name", "cls_id")
RAW_KEYS = ("K_crop", "choose", "det", "dpt_scale", "dpt_u16", "rgb_u8")
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _export_args(root, ckpt, out, extra=()):
    return ["export-serving", "--dataset", "lmo", "--data-root", root,
            "--torch-checkpoint", ckpt, "--cls-id", "1", "--batch-size",
            str(BS), "--knn-chunk", "64", "--exact-knn", "--out", out,
            *extra]


def _jax_fit(model, variables, mesh, raw):
    """JAX's fit of raw arrays: Kabsch weights and correspondences [B, N],
    and the normalised scene and mesh features."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.pose_fit import fit_pose_single

    fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], approx=False)
    feats = model.apply(variables, mesh, train=False, method="encode_mesh")
    out = model.apply(variables, inputs, mesh, train=False,
                      mesh_features=feats)
    _, w, idx = jax.vmap(lambda c, s, r, d: fit_pose_single(
        c, s, out["mesh"], r, mesh.xyz, d))(
            fin["cld_rgb_nrm"][..., :3], out["seg"], out["rgbd"], fin["det"])
    return np.asarray(w), np.asarray(idx), np.asarray(out["rgbd"]), \
        np.asarray(out["mesh"])


@pytest.fixture(scope="module")
def presets():
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.configs import base as cfg_base

    mp = MonkeyPatch()
    cfg_j = test_data._mini_config()
    mp.setitem(cfg_base._PRESETS, "lmo", cfg_j)
    mp.setitem(configs._PRESETS, "lmo", port_config(cfg_j))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ckpt(bop_root, presets, tmp_path_factory):  # noqa: F811
    """Well-posed weights (see the module docstring) as a reference
    checkpoint, and the flax model, variables and mesh they came from."""
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import export_state_dict
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh

    cfg_t = configs.get_config("lmo")
    ds = PoseDataset(cfg_t, 1, "test", data_root=bop_root)
    batch, _ = collate([ds[i] for i in range(len(ds))])
    raw = {k: batch[k] for k in RAW_KEYS}
    fps = load_or_build_fps_mesh(bop_root, 1, test_data.N_MESH)
    mesh = MeshArrays.from_graph(build_mesh_graph(
        cli_t._fps_mm(fps), test_data.N_MESH))
    fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], approx=False)
    model, variables = H.jax_model_and_variables(inputs, mesh)
    variables = _spread_matches(model, variables, inputs, mesh)
    feats = model.apply(variables, mesh, train=False, method="encode_mesh")
    seg = model.apply(variables, inputs, mesh, train=False,
                      mesh_features=feats)["seg"]
    variables = {"params": _split_seg_bias(variables["params"],
                                           np.asarray(seg)),
                 "batch_stats": variables["batch_stats"]}
    sd = export_state_dict(variables["params"], variables["batch_stats"])
    d = str(tmp_path_factory.mktemp("serve_ckpt"))
    os.makedirs(osp.join(d, "ape"))
    torch.save({"model_state": {k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in sd.items()}},
               osp.join(d, "ape", "geomatch.pth.tar"))
    return {"dir": d, "model": model, "variables": variables, "mesh": mesh,
            "root": bop_root}


@pytest.fixture(scope="module")
def served(ckpt, tmp_path_factory):
    """Both CLIs' artifacts; the port's served by ``cli serve`` on a
    thread, the infer frames requested in batches of 2; the JAX artifact
    and JAX's fit on the same arrays; the port's ``cli infer``."""
    from gdm_tpu import cli as cli_j
    from gdm_tpu.serve import load_artifact as load_jax_artifact

    root = ckpt["root"]
    tmp = tmp_path_factory.mktemp("serving")
    art_j = str(tmp / "jax" / "ape")
    art_t = str(tmp / "serving" / "lmo" / "ape")
    meta_j = cli_j.main(_export_args(root, ckpt["dir"], art_j,
                                     ["--platforms", "cpu"]))
    meta_t = cli_t.main(_export_args(root, ckpt["dir"], art_t,
                                     ["--device", "cpu"]))
    jax_art = load_jax_artifact(art_j)

    infer_csv = str(tmp / "infer.csv")
    cli_t.main(["infer", "--dataset", "lmo", "--data-root", root,
                "--torch-checkpoint", ckpt["dir"], "--cls-id", "1",
                "--batch-size", str(BS), "--knn-chunk", "64", "--exact-knn",
                "--num-workers", "2", "--device", "cpu", "--output",
                infer_csv])

    ds = PoseDataset(configs.get_config("lmo"), 1, "infer", data_root=root)
    args = cli_t.build_parser().parse_args(
        ["serve", "--artifact", str(tmp / "serving" / "lmo"), "--device",
         "cpu", "--port", "0"])
    service, server = cli_t.start_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    engine = service.engines["ape"]
    out = {"poses": [], "w": [], "idx": [], "poses_j": [], "raw": [],
           "names": []}
    try:
        for lo in range(0, len(ds), BS):
            batch, meta = collate([ds[i] for i in range(lo, lo + BS)])
            raw = {k: batch[k] for k in RAW_KEYS}
            poses, _ = request_poses(url, raw, obj="ape")
            out["poses"].append(poses)
            out["w"].append(engine.last_fit["w"].numpy())
            out["idx"].append(engine.last_fit["idx"].numpy())
            out["poses_j"].append(np.asarray(jax_art.run(raw)))
            out["raw"].append(raw)
            out["names"] += [m["file_name"] for m in meta]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    for k in ("poses", "w", "idx", "poses_j"):
        out[k] = np.concatenate(out[k])
    # JAX's fit of all the frames at once (the batch that built the
    # weights: each frame's fit is its own)
    raws = out.pop("raw")
    out["w_j"], out["idx_j"], out["rgbd_j"], out["mesh_j"] = _jax_fit(
        ckpt["model"], ckpt["variables"], ckpt["mesh"],
        {k: np.concatenate([r[k] for r in raws]) for k in RAW_KEYS})
    out.update(meta_j=meta_j, meta_t=meta_t, art_j=art_j, art_t=art_t,
               infer_csv=infer_csv, tmp=tmp, root=root)
    return out


def test_artifact_files_and_meta(served):
    art = served["art_t"]
    assert sorted(os.listdir(art)) == ["mesh_fps.npy", "meta.json",
                                       "weights.npz"]
    meta = json.load(open(osp.join(art, "meta.json")))
    assert meta == json.loads(json.dumps(served["meta_t"]))
    assert meta["format"] == "gdm_tpu_torch" and meta["exact_knn"] is True
    # every key of the JAX artifact's meta but its platforms and version
    assert set(served["meta_j"]) - set(meta) == {"platforms", "jax_version"}
    for k in set(served["meta_j"]) - {"platforms", "jax_version"}:
        assert meta[k] == served["meta_j"][k], k


@pytest.mark.parametrize("extra", [
    ["--opt", "data.fill_depth=true"], ["--opt", "model.backbone=dgcnn"]],
    ids=["fill_depth", "dgcnn"])
def test_export_meta_matches_jax(ckpt, tmp_path, extra):
    """raw_spec (with dpt_filled under fill_depth), icp_reject_m,
    diameter_m, obj_name and cls_id equal JAX's export of the same tree
    and weights; DGCNN exports its own model (no pyramid).  (The LM-O
    case is test_artifact_files_and_meta's.)"""
    from gdm_tpu import cli as cli_j

    src = ckpt["dir"]
    if "model.backbone=dgcnn" in extra:
        from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN

        model = GeoMatchDGCNN(128)
        weights.init_random_(model, torch.Generator().manual_seed(1))
        src = str(tmp_path / "ckpt_dgcnn")
        os.makedirs(osp.join(src, "ape"))
        torch.save({"model_state": weights.reference_state_dict(model)},
                   osp.join(src, "ape", "geomatch.pth.tar"))
    meta_j = cli_j.main(_export_args(ckpt["root"], src, str(tmp_path / "j"),
                                     ["--platforms", "cpu", *extra]))
    meta_t = cli_t.main(_export_args(ckpt["root"], src, str(tmp_path / "t"),
                                     ["--device", "cpu", *extra]))
    for k in META_KEYS:
        assert meta_t[k] == meta_j[k], k
    assert meta_t["needs_pyramid"] == meta_j["needs_pyramid"]
    assert ("dpt_filled" in meta_t["raw_spec"]) == ("fill_depth" in str(
        extra))
    assert meta_t["opts"] == extra[1:]
    assert load_artifact_tree([str(tmp_path / "t")], "cpu")["ape"].meta[
        "raw_spec"] == meta_j["raw_spec"]


def test_served_poses_equal_cli_infer(served):
    rows, keys = _read_csv(served["infer_csv"])
    assert len(keys) == len(served["names"]) == 4
    for name, pose in zip(served["names"], served["poses"]):
        s, im = (int(v) for v in name.split("/"))
        R, t = rows[(s, im, 1)]
        np.testing.assert_allclose(pose[:, :3], R, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pose[:, 3], t, rtol=0, atol=1e-5)


def test_served_fit_matches_jax_on_the_same_arrays(served):
    w, w_j = served["w"], served["w_j"]
    assert 0.2 < (w_j > 0).mean() < 0.8
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-5)
    rgbd = served["rgbd_j"]
    c = rgbd.shape[-1]
    f = rgbd / np.linalg.norm(rgbd, axis=-1, keepdims=True)
    mf = served["mesh_j"] / np.linalg.norm(served["mesh_j"], axis=-1,
                                           keepdims=True)
    sure = (H.top2_gap(f.reshape(-1, c), mf) > 1e-5).reshape(w.shape)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(served["idx"][sure], served["idx_j"][sure])
    same = ((served["idx"] == served["idx_j"]) | (w_j == 0)).all(1)
    assert same.sum() >= 2
    np.testing.assert_allclose(served["poses"][same],
                               served["poses_j"][same], rtol=0, atol=1e-4)


def test_export_reads_the_newest_train_checkpoint(ckpt, tmp_path):
    """Without --torch-checkpoint the export reads <ckpt_root>/
    checkpoints/<obj>/latest (the layout cli train writes) and refuses a
    root without one."""
    src = osp.join(ckpt["dir"], "ape", "geomatch.pth.tar")
    obj = tmp_path / "train_log" / "checkpoints" / "ape"
    os.makedirs(obj / "epoch_0003")
    shutil.copy(src, obj / "epoch_0003" / "geomatch.pth.tar")
    (obj / "latest").write_text("epoch_0003")
    base = ["export-serving", "--dataset", "lmo", "--data-root",
            ckpt["root"], "--cls-id", "1", "--device", "cpu",
            "--batch-size", str(BS)]
    cli_t.main([*base, "--ckpt-root", str(tmp_path / "train_log"),
                "--out", str(tmp_path / "art")])
    want = weights.read_reference_checkpoint(src)
    with np.load(tmp_path / "art" / "weights.npz") as z:
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v.numpy(), err_msg=k)
    with pytest.raises(SystemExit, match="untrained"):
        cli_t.main([*base, "--ckpt-root", str(tmp_path / "empty"),
                    "--out", str(tmp_path / "art2")])


def test_artifact_tree_layout_and_refusals(served, tmp_path):
    """Direct dirs and a root of artifacts load; a duplicate name, an
    artifact-free root, a JAX artifact and a newer format are refused
    (tests/test_serve.py:213's cases, and the port's own)."""
    art = served["art_t"]
    root = osp.dirname(art)
    assert sorted(load_artifact_tree([art], "cpu")) == ["ape"]
    assert sorted(load_artifact_tree([root], "cpu")) == ["ape"]
    with pytest.raises(ValueError, match="duplicate"):
        load_artifact_tree([art, root], "cpu")
    with pytest.raises(ValueError, match="no artifact"):
        load_artifact_tree([str(tmp_path)], "cpu")
    with pytest.raises(ValueError, match="JAX artifact"):
        load_artifact_tree([served["art_j"]], "cpu")
    newer = str(tmp_path / "newer")
    shutil.copytree(art, newer)
    meta = json.load(open(osp.join(newer, "meta.json")))
    meta["format_version"] += 1
    json.dump(meta, open(osp.join(newer, "meta.json"), "w"))
    with pytest.raises(ValueError, match="newer"):
        load_artifact_tree([newer], "cpu")
    with pytest.raises(SystemExit, match="JAX artifact"):
        cli_t.main(["serve", "--artifact", served["art_j"], "--device",
                    "cpu", "--no-warmup"])


def test_serve_subprocess_answers_and_exits_on_sigint(served):
    """``python -m gdm_tpu_torch.cli serve`` in its own process (no JAX,
    no preset patched: the artifact carries its config) answers /healthz
    and one /pose with the in-process server's poses, then exits 0 on
    SIGINT."""
    from urllib.request import urlopen

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gdm_tpu_torch.cli", "serve", "--artifact",
         served["art_t"], "--device", "cpu", "--port", "0", "--no-warmup"],
        cwd=str(served["tmp"]), env=env, stderr=subprocess.PIPE, text=True)
    try:
        url = None
        for line in proc.stderr:
            if "serving 1 object(s) on " in line:
                url = line.split(" on ")[1].split()[0]
                break
        assert url, "no serving line"
        with urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["objects"] == ["ape"]
        ds = PoseDataset(configs.get_config("lmo"), 1, "infer",
                         data_root=served["root"])
        batch, _ = collate([ds[i] for i in range(BS)])
        poses, _ = request_poses(url, {k: batch[k] for k in RAW_KEYS})
        np.testing.assert_array_equal(poses, served["poses"][:BS])
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def test_profile_dir_writes_a_chrome_trace(ckpt, tmp_path):
    """``eval --device cpu --profile-dir`` writes one chrome trace that
    parses and holds the eval's operators; a CUDA trace where CUDA is
    absent raises rather than tracing the host alone."""
    prof = tmp_path / "prof"
    cli_t.main(["eval", "--dataset", "lmo", "--data-root", ckpt["root"],
                "--torch-checkpoint", ckpt["dir"], "--cls-id", "1",
                "--batch-size", str(BS), "--knn-chunk", "64", "--exact-knn",
                "--num-workers", "2", "--device", "cpu", "--output-dir",
                str(tmp_path / "out"), "--profile-dir", str(prof)])
    (trace,) = os.listdir(prof)
    events = json.load(open(prof / trace))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::conv2d" in names and "aten::linalg_svd" in names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_t.main(["eval", "--dataset", "lmo", "--data-root",
                        ckpt["root"], "--torch-checkpoint", ckpt["dir"],
                        "--profile-dir", str(tmp_path / "cuda_prof")])

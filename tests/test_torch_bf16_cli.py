"""The CLIs with ``--opt model.compute_dtype=bfloat16`` on the CPU, on the
mini BOP tree of tests/test_data.py, under the well-posed weights of
tests/test_torch_serve_cli.py (feature heads centred, seg head split):

- ``cli eval`` in both packages lists the same rows with valid poses; on
  the eval frames, in process, the port's bf16 engine and JAX's jitted
  bf16 forward and fit give the same foreground wherever JAX's seg margin
  exceeds twice the largest change of a seg logit between the packages,
  and the same correspondence wherever JAX's top-2 similarity gap of a
  scene point exceeds twice the largest change of its similarities
  between the two packages' bf16 features (beyond those no rounding can
  swap the outcome); poses are not compared (one flipped match swings a fit
  under random weights) (``cli train``:
  tests/test_torch_bf16_train_cli.py);
- ``cli export-serving`` -> ``cli serve`` of a bf16 artifact in the port:
  the artifact's config carries the dtype, the served engine computes in
  bf16, and its poses equal the port's ``cli infer`` in bf16 (1e-5).
"""

import os.path as osp
import threading

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_data
from test_data import bop_root  # noqa: F401
from test_torch_cli import _read_csv
from test_torch_serve_cli import BS, RAW_KEYS, _export_args, ckpt, \
    presets  # noqa: F401
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate
from gdm_tpu_torch.serve import PoseEngine
from gdm_tpu_torch.server import request_poses

torch.set_num_threads(1)
BF16 = ["--opt", "model.compute_dtype=bfloat16"]


def _common(ckpt):  # noqa: F811
    return ["--dataset", "lmo", "--data-root", ckpt["root"], "--cls-id",
            "1", "--batch-size", str(BS), "--num-workers", "2",
            "--knn-chunk", "64", "--exact-knn", "--torch-checkpoint",
            ckpt["dir"], *BF16]


def _jax_fit16(variables, mesh, raw):
    """JAX's jitted bf16 forward and fit of raw arrays: seg logits, Kabsch
    weights and correspondences, the scene and mesh features."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models import GeoMatch as GeoMatchJ

    model = GeoMatchJ(positive_r=0.01, compute_dtype=jnp.bfloat16)

    @jax.jit
    def run(variables, raw):
        fin = finalize_batch(raw)
        inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"],
                                 fin["choose"], fin["xyz_img"], approx=False)
        out = model.apply(variables, inputs, mesh, train=False)
        _, w, idx = jax.vmap(lambda c, s, r, d: fit_pose_single(
            c, s, out["mesh"], r, mesh.xyz, d))(
                fin["cld_rgb_nrm"][..., :3], out["seg"], out["rgbd"],
                fin["det"])
        return out["seg"], w, idx, out["rgbd"], out["mesh"]

    return [np.asarray(a) for a in run(
        variables, {k: jnp.asarray(v) for k, v in raw.items()})]


@pytest.fixture(scope="module")
def evals(ckpt, tmp_path_factory):  # noqa: F811
    from gdm_tpu import cli as cli_j

    out_j = str(tmp_path_factory.mktemp("bf16_eval_jax"))
    out_t = str(tmp_path_factory.mktemp("bf16_eval_port"))
    cli_j.main(["eval", *_common(ckpt), "--devices", "1", "--output-dir",
                out_j])
    cli_t.main(["eval", *_common(ckpt), "--device", "cpu", "--output-dir",
                out_t])

    root = ckpt["root"]
    cfg = configs.get_config("lmo", BF16[1:])
    ds = PoseDataset(cfg, 1, "test", data_root=root)
    batch, _ = collate([ds[i] for i in range(len(ds))])
    raw = {k: batch[k] for k in RAW_KEYS}
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    fps_mm = cli_t._fps_mm(load_or_build_fps_mesh(root, 1, test_data.N_MESH))
    engine = PoseEngine(cfg, fps_mm, weights.read_reference_checkpoint(
        osp.join(ckpt["dir"], "ape")), "cpu", batch=len(ds))
    got = {}
    hook = engine.model.register_forward_hook(
        lambda mod, inp, out: got.update(out))
    engine.run(raw)
    hook.remove()
    seg_j, w_j, idx_j, rgbd_j, mesh_j = _jax_fit16(
        ckpt["variables"], ckpt["mesh"], raw)
    return {"csv_j": osp.join(out_j, "gt_lmo-test.csv"),
            "csv_t": osp.join(out_t, "gt_lmo-test.csv"),
            "engine": engine, "rgbd_t": got["rgbd"].numpy(),
            "seg_t": got["seg"].numpy(), "mesh_t": engine.mesh_feats.numpy(),
            "seg_j": seg_j, "w_j": w_j, "idx_j": idx_j, "rgbd_j": rgbd_j,
            "mesh_j": mesh_j}


def test_eval_csv_rows_equal(evals):
    rows_j, keys_j = _read_csv(evals["csv_j"])
    rows_t, keys_t = _read_csv(evals["csv_t"])
    assert keys_t == keys_j and len(keys_t) == 4
    for k in keys_t:
        R, t = rows_t[k]
        assert np.isfinite(R).all() and np.isfinite(t).all()


def test_engine_computes_in_bf16(evals):
    model = evals["engine"].model
    assert model.compute_dtype is torch.bfloat16
    assert model.pcd_emb.cnn_pre_stages[0].dtype is torch.bfloat16
    assert evals["rgbd_t"].dtype == np.float32


def test_correspondences_agree_beyond_bf16_near_ties(evals):
    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    fit = evals["engine"].last_fit
    w_t, idx_t = fit["w"].numpy(), fit["idx"].numpy()
    # foreground: equal wherever JAX's seg margin exceeds twice the
    # largest change of a seg logit between the packages
    margin = np.abs(evals["seg_j"][..., 1] - evals["seg_j"][..., 0])
    dseg = np.abs(evals["seg_t"] - evals["seg_j"]).max()
    clear = margin > 2 * dseg
    assert 0 < dseg and clear.mean() > 0.5, (dseg, clear.mean())
    np.testing.assert_array_equal((w_t > 0)[clear], (evals["w_j"] > 0)[clear])
    c = evals["rgbd_j"].shape[-1]
    f_j = unit(evals["rgbd_j"]).reshape(-1, c).astype(np.float64)
    f_t = unit(evals["rgbd_t"]).reshape(-1, c).astype(np.float64)
    m_j, m_t = unit(evals["mesh_j"]), unit(evals["mesh_t"])
    dsim = np.abs(f_t @ m_t.T - f_j @ m_j.T).max(-1)
    sure = (H.top2_gap(f_j, m_j) > 2 * dsim).reshape(idx_t.shape) \
        & (evals["w_j"] > 0) & (w_t > 0)
    assert sure.sum() >= 10, (np.median(dsim), sure.sum())
    np.testing.assert_array_equal(idx_t[sure], evals["idx_j"][sure])
    # random weights leave most top-2 gaps inside the bf16 noise (median
    # change of a point's similarities ~0.015); still most matches agree
    # (85% here), where a wrong forward would agree on ~1 in 128
    both = (evals["w_j"] > 0) & (w_t > 0)
    assert (idx_t == evals["idx_j"])[both].mean() > 0.7


def test_bf16_artifact_serves_in_bf16(ckpt, tmp_path):  # noqa: F811
    root = ckpt["root"]
    art = str(tmp_path / "serving" / "lmo" / "ape")
    meta = cli_t.main(_export_args(root, ckpt["dir"], art,
                                   ["--device", "cpu", *BF16]))
    assert meta["config"]["model"]["compute_dtype"] == "bfloat16"
    assert meta["opts"] == BF16[1:]
    infer_csv = str(tmp_path / "infer.csv")
    cli_t.main(["infer", *_common(ckpt), "--device", "cpu", "--output",
                infer_csv])
    args = cli_t.build_parser().parse_args(
        ["serve", "--artifact", str(tmp_path / "serving" / "lmo"),
         "--device", "cpu", "--port", "0"])
    service, server = cli_t.start_server(args)
    assert service.engines["ape"].model.compute_dtype is torch.bfloat16
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    ds = PoseDataset(configs.get_config("lmo"), 1, "infer", data_root=root)
    poses, names = [], []
    try:
        for lo in range(0, len(ds), BS):
            batch, meta_b = collate([ds[i] for i in range(lo, lo + BS)])
            p, _ = request_poses(url, {k: batch[k] for k in RAW_KEYS},
                                 obj="ape")
            poses.append(p)
            names += [m["file_name"] for m in meta_b]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    rows, keys = _read_csv(infer_csv)
    assert len(keys) == len(names) == 4
    for name, pose in zip(names, np.concatenate(poses)):
        s, im = (int(v) for v in name.split("/"))
        R, t = rows[(s, im, 1)]
        np.testing.assert_allclose(pose[:, :3], R, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pose[:, 3], t, rtol=0, atol=1e-5)

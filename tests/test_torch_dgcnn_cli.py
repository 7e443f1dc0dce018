"""``cli train | eval | infer | score --opt model.backbone=dgcnn`` of the
port against the JAX package's CLI on the CPU, on the mini BOP tree of
tests/test_data.py.

  * The port trains a GeoMatchDGCNN for one epoch (batch 2, validating
    on the test split).  Its checkpoint loads strictly into both packages,
    and both packages' ``cli eval`` of it (JAX with ``--exact-knn``, the
    port's graphs are always exact) list the same CSV rows with the same
    poses; on one batch of the 4 test frames its seg, rgbd and mesh
    outputs agree within 1e-4.
  * Under weights that fit (a flax init whose feature heads are centred
    so that matches spread, and whose seg bias makes about half the points
    foreground, as tests/test_torch_cli.py does), both CLIs' ``eval``
    give the same rows; in process the Kabsch weights are equal, the
    correspondences equal beyond near-ties (top-2 gap <= 1e-5), and the
    poses agree within 1e-4 on frames whose weighted correspondences
    agree.  The port's ``infer`` gives the eval rows and poses, and its
    ``score`` of the eval CSV the eval recalls.
  * ``infer --stacked`` refuses the backbone, as the JAX CLI does, and
    the engine takes its mesh in millimetres and refuses metres.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_data
from test_data import N_MESH, bop_root  # noqa: F401
from test_torch_cli import _read_csv, jax_tree_copy
from test_torch_dataset import port_config
from test_torch_serve import _split_seg_bias
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate
from gdm_tpu_torch.serve import PoseEngine

torch.set_num_threads(1)
BS = 3
DGCNN = ["--opt", "model.backbone=dgcnn"]
RAW_KEYS = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose", "det")


def _jax_setup(root):
    """The JAX CLI's DGCNN model, mesh input and mesh points of object 1,
    and one finalized batch of the 4 test frames (the loader's)."""
    import dataclasses

    import jax.numpy as jnp

    from gdm_tpu import cli as cli_j
    from gdm_tpu.data.pipeline import finalize_batch

    cfg_j = test_data._mini_config()
    cfg_j = dataclasses.replace(cfg_j, model=dataclasses.replace(
        cfg_j.model, backbone="dgcnn"))
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh

    fps = load_or_build_fps_mesh(root, 1, N_MESH)
    model, mesh_x, mesh_xyz, needs = cli_j._make_model(
        cfg_j, 0.1, fps, None, exact_knn=True)
    assert not needs
    ds = PoseDataset(cli_t.model_config("lmo", ["model.backbone=dgcnn"]), 1,
                     "test", data_root=root)
    batch, meta = collate([ds[i] for i in range(len(ds))])
    raw = {k: batch[k] for k in RAW_KEYS}
    fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    return model, mesh_x, mesh_xyz, fps, raw, meta, fin


def _jax_init(model, fin, mesh_x):
    import jax
    import jax.numpy as jnp

    b, n = fin["cld_rgb_nrm"].shape[:2]
    inputs = {"cld_rgb_nrm": fin["cld_rgb_nrm"],
              "labels": jnp.zeros((b, n), jnp.int32),
              "origin_labels": jnp.zeros((b, n), jnp.int32),
              "match_idx": jnp.zeros((b, n), jnp.int32),
              "visible_flag": jnp.zeros((b, mesh_x.shape[0]), jnp.uint8),
              "RT": jnp.tile(jnp.eye(3, 4), (b, 1, 1))}
    return jax.jit(lambda r, i, m: model.init(
        {"params": r, "dropout": r}, i, m, train=True))(
            jax.random.PRNGKey(0), inputs, mesh_x)


def _spread_matches(model, variables, fin, mesh_x):
    """Centre the scene and mesh features by linear changes of their last
    layers (test_torch_cli._spread_matches, with DGCNN's mesh head: its
    last conv has no bias, so its input is projected off its mean
    direction, as the scene head's is)."""
    inputs = {"cld_rgb_nrm": fin["cld_rgb_nrm"]}
    _, state = model.apply(
        variables, inputs, mesh_x, train=False,
        capture_intermediates=lambda mdl, _: mdl.name in ("DenseBNAct_2",
                                                          "conv8"))
    inter = state["intermediates"]
    params = jax_tree_copy(variables["params"])
    for h, dense in (
            (inter["feature_encoding_layer"]["DenseBNAct_2"]["__call__"][0],
             params["feature_encoding_layer"]["DenseBNAct_3"]["Dense_0"]),
            (inter["model_emb"]["trunk"]["conv8"]["__call__"][0],
             params["model_emb"]["trunk"]["conv9"])):
        h = np.asarray(h, np.float64)
        h0 = h.reshape(-1, h.shape[-1]).mean(0)
        proj = np.eye(len(h0)) - np.outer(h0, h0) / (h0 @ h0)
        dense["kernel"] = (proj @ np.asarray(dense["kernel"], np.float64)
                           ).astype(np.float32)
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _jax_fit(model, variables, fin, mesh_x, mesh_xyz):
    import jax

    from gdm_tpu.eval.pose_fit import fit_pose_single

    out = model.apply(variables, {"cld_rgb_nrm": fin["cld_rgb_nrm"]},
                      mesh_x, train=False)
    _, w, idx = jax.vmap(lambda c, s, r, d: fit_pose_single(
        c, s, out["mesh"], r, mesh_xyz, d))(
            fin["cld_rgb_nrm"][..., :3], out["seg"], out["rgbd"], fin["det"])
    return out, np.asarray(w), np.asarray(idx)


def _fps_mm(fps):
    return np.concatenate([fps[:, :3] * 1000.0, fps[:, 3:]], axis=1)


@pytest.fixture(scope="module")
def runs(bop_root, tmp_path_factory):  # noqa: F811
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base
    from gdm_tpu.train.import_torch import export_state_dict

    mp = MonkeyPatch()
    cfg_j = test_data._mini_config()
    mp.setitem(cfg_base._PRESETS, "lmo", cfg_j)
    mp.setitem(configs._PRESETS, "lmo", port_config(cfg_j))
    try:
        root = bop_root
        model, mesh_x, mesh_xyz, fps, raw, meta, fin = _jax_setup(root)
        init = _jax_init(model, fin, mesh_x)
        common = ["--dataset", "lmo", "--data-root", root, "--cls-id", "1",
                  "--batch-size", str(BS), "--num-workers", "2",
                  "--knn-chunk", "64", *DGCNN]

        # 1. the port trains; both CLIs evaluate its checkpoint
        ckpt_root = str(tmp_path_factory.mktemp("dgcnn_train"))
        trained = cli_t.main([
            "train", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--batch-size", "2", "--epochs", "1", "--eval-every", "1",
            "--ckpt-root", ckpt_root, "--device", "cpu", "--num-workers",
            "2", "--knn-chunk", "64", *DGCNN])
        ckpt = osp.join(ckpt_root, "checkpoints")
        out = {}
        for tag, ck in (("trained", ckpt), ("spread", None)):
            if ck is None:
                variables = _spread_matches(model, init, fin, mesh_x)
                o = model.apply(variables, {"cld_rgb_nrm": fin["cld_rgb_nrm"]},
                                mesh_x, train=False)
                variables = {"params": _split_seg_bias(
                    variables["params"], np.asarray(o["seg"])),
                    "batch_stats": variables["batch_stats"]}
                sd = export_state_dict(variables["params"],
                                       variables["batch_stats"])
                ck = str(tmp_path_factory.mktemp("dgcnn_spread"))
                os.makedirs(osp.join(ck, "ape"))
                torch.save({"model_state": {
                    k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()}},
                    osp.join(ck, "ape", "geomatch.pth.tar"))
            out_j = str(tmp_path_factory.mktemp(f"dg_jax_{tag}"))
            out_t = str(tmp_path_factory.mktemp(f"dg_port_{tag}"))
            args = [*common, "--exact-knn", "--torch-checkpoint", ck]
            res_j = cli_j.main(["eval", *args, "--devices", "1",
                                "--output-dir", out_j])
            res_t = cli_t.main(["eval", *args, "--device", "cpu",
                                "--output-dir", out_t])
            engine = PoseEngine(
                cli_t.model_config("lmo", ["model.backbone=dgcnn"]),
                _fps_mm(fps), weights.read_reference_checkpoint(
                    osp.join(ck, "ape")), "cpu", batch=len(meta),
                knn_chunk=64)
            engine.run(raw)
            out[tag] = {"ckpt": ck, "res_j": res_j, "res_t": res_t,
                        "csv_j": osp.join(out_j, "gt_lmo-test.csv"),
                        "csv_t": osp.join(out_t, "gt_lmo-test.csv"),
                        "fit_t": {k: v.numpy()
                                  for k, v in engine.last_fit.items()}}
        # the trained checkpoint through JAX's strict import
        from gdm_tpu.train.import_torch import import_state_dict

        sd = weights.read_reference_checkpoint(osp.join(ckpt, "ape"))
        params, stats, report = import_state_dict(
            init["params"], init["batch_stats"],
            {k: v.numpy() for k, v in sd.items()}, strict=True)
        out["trained"]["report"] = report
        o, w, idx = _jax_fit(model, {"params": params, "batch_stats": stats},
                             fin, mesh_x, mesh_xyz)
        out["trained"]["jax"] = {k: np.asarray(v) for k, v in o.items()}
        port = engine.model.__class__()
        weights.load_reference_state_dict(port, sd)
        with torch.no_grad():
            o_t = port.eval()({"cld_rgb_nrm": torch.from_numpy(
                np.asarray(fin["cld_rgb_nrm"]))},
                torch.from_numpy(np.asarray(mesh_x)))
        out["trained"]["port"] = {k: v.numpy() for k, v in o_t.items()}
        o, w, idx = _jax_fit(model, variables, fin, mesh_x, mesh_xyz)
        out["spread"].update(jax={k: np.asarray(v) for k, v in o.items()},
                             w=w, idx=idx)

        infer_csv = str(tmp_path_factory.mktemp("dg_infer") / "infer.csv")
        args = [*common, "--exact-knn", "--torch-checkpoint",
                out["spread"]["ckpt"], "--device", "cpu"]
        out["infer"] = cli_t.main(["infer", *args, "--output", infer_csv])
        out["score"] = cli_t.main([
            "score", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--csv", out["spread"]["csv_t"], *DGCNN])
        yield {"out": out, "trained": trained, "meta": meta, "fps": fps,
               "args": args, "mesh_x": np.asarray(mesh_x)}
    finally:
        mp.undo()


def test_train_runs_validates_and_checkpoints(runs):
    obj = runs["trained"]["objects"]["ape"]
    assert obj["val"]["val_frames"] == 4
    assert len(runs["trained"]["timing"]) == 2            # 4 frames, b 2
    sd = weights.read_reference_checkpoint(
        osp.join(runs["out"]["trained"]["ckpt"], "ape"))
    assert "awl.params" in sd and "pcd_emb.bn3.running_var" in sd \
        and "pcd_emb.conv3.1.running_var" in sd
    assert all(torch.isfinite(v.float()).all() for v in sd.values())


def test_trained_checkpoint_loads_strictly_into_jax(runs):
    assert runs["out"]["trained"]["report"]["unused"] == []


@pytest.mark.parametrize("key", ["seg", "rgbd", "mesh"])
def test_trained_checkpoint_outputs_match_jax(runs, key):
    got = runs["out"]["trained"]["port"][key]
    ref = runs["out"]["trained"]["jax"][key]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert H.rel_err(got, ref) <= 1e-4, H.rel_err(got, ref)


@pytest.mark.parametrize("tag", ["trained", "spread"])
def test_eval_csv_rows_match_jax(runs, tag):
    r = runs["out"][tag]
    rows_j, keys_j = _read_csv(r["csv_j"])
    rows_t, keys_t = _read_csv(r["csv_t"])
    assert keys_t == keys_j and len(keys_t) == 4
    assert [b["n"] for b in r["res_t"]["timing"]] == [3, 1]
    if tag == "trained":
        for k in keys_t:
            np.testing.assert_allclose(rows_t[k][0], rows_j[k][0], atol=1e-4)
            np.testing.assert_allclose(rows_t[k][1], rows_j[k][1], atol=1e-4)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_fit_matches_jax(runs):
    """Spread weights: the fg mask and Kabsch weights equal, the
    correspondences equal beyond near-ties, the poses within 1e-4 on
    frames whose weighted correspondences agree."""
    r = runs["out"]["spread"]
    fit = r["fit_t"]
    fg = np.asarray(r["jax"]["seg"]).argmax(-1) == 1
    assert 0.2 < fg.mean() < 0.8, fg.mean()
    np.testing.assert_array_equal(fit["w"], r["w"])
    c = r["jax"]["rgbd"].shape[-1]
    gap = H.top2_gap(_unit(r["jax"]["rgbd"]).reshape(-1, c),
                     _unit(r["jax"]["mesh"])).reshape(fg.shape)
    sure = gap > 1e-5
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(fit["idx"][sure], r["idx"][sure])
    assert len(np.unique(r["idx"][fg])) > 10          # matches spread
    rows_j, _ = _read_csv(r["csv_j"])
    rows_t, _ = _read_csv(r["csv_t"])
    same = ((fit["idx"] == r["idx"]) | (r["w"] == 0)).all(1)
    assert same.sum() >= 2
    for i, m in enumerate(runs["meta"]):
        if same[i]:
            s, im = (int(v) for v in m["file_name"].split("/"))
            np.testing.assert_allclose(rows_t[(s, im, 1)][0],
                                       rows_j[(s, im, 1)][0], atol=1e-4)
            np.testing.assert_allclose(rows_t[(s, im, 1)][1],
                                       rows_j[(s, im, 1)][1], atol=1e-4)


def test_infer_and_score_reproduce_eval(runs):
    r = runs["out"]["spread"]
    rows_e, keys_e = _read_csv(r["csv_t"])
    rows_i, keys_i = _read_csv(runs["out"]["infer"]["csv"])
    assert keys_i == keys_e
    for k in keys_e:
        np.testing.assert_array_equal(rows_i[k][0], rows_e[k][0])
        np.testing.assert_allclose(rows_i[k][1], rows_e[k][1], atol=1e-12)
    sc = runs["out"]["score"]
    assert sc["recalls"]["ape"] == r["res_t"]["recalls"]["ape"]


def test_infer_stacked_refuses_dgcnn(runs):
    with pytest.raises(SystemExit, match="randla_spline"):
        cli_t.main(["infer", *runs["args"], "--stacked"])


def test_engine_takes_mm_and_refuses_metres(runs):
    """The DGCNN engine's mesh input is [xyz m | rgb | normal] of the fps
    array it was given in millimetres (one f32 rounding of the mm -> m
    division, against the JAX CLI's input from metres); an array in
    metres is refused."""
    fps = runs["fps"]
    cfg = cli_t.model_config("lmo", ["model.backbone=dgcnn"])
    sd = weights.read_reference_checkpoint(
        osp.join(runs["out"]["spread"]["ckpt"], "ape"))
    engine = PoseEngine(cfg, _fps_mm(fps), sd, "cpu", batch=1)
    got = engine.mesh.numpy()
    np.testing.assert_allclose(got, runs["mesh_x"], rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(got[:, 3:], runs["mesh_x"][:, 3:])
    assert engine.mesh_xyz.data_ptr() == engine.mesh.data_ptr()
    assert not engine.needs_pyramid
    with pytest.raises(ValueError, match="millimetres"):
        PoseEngine(cfg, fps, sd, "cpu", batch=1)

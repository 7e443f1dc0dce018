"""The port's ``cli eval | infer | score`` against the JAX package's CLI on
the mini BOP tree of tests/test_data.py, under the same weights: a flax
init (its seg head biased so that about half the points are foreground,
see below) exported with export_state_dict as <ckpt>/ape/geomatch.pth.tar.

Random weights match every scene point to one mesh vertex, where a
Kabsch fit has no defined rotation; the test weights centre the scene and
mesh features (linear changes of the two heads' last layers), so matches
spread over the mesh and the fits are well posed.

One JAX ``cli eval --exact-knn --torch-checkpoint`` and one port ``cli
eval --device cpu`` run per module.  Their CSVs list the same (scene,
image, object) rows.  On one loader batch, in process, the fg mask and
the Kabsch weights are equal and the correspondences agree up to
near-ties (top-2 gap <= 1e-5); poses are compared (1e-4) only on frames
whose weighted correspondences all agree: under random weights one
flipped near-tie can swing a Kabsch fit anywhere.  Each package's
``score`` of the other's CSV gives the other's recalls, and the port's
``infer`` CSV has the eval CSV's rows and poses."""

import os
import os.path as osp

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_data
from test_cli import bop_root_2obj  # noqa: F401
from test_data import N_MESH, bop_root  # noqa: F401
from test_torch_dataset import port_config
from test_torch_serve import _split_seg_bias
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate
from gdm_tpu_torch.serve import PoseEngine

torch.set_num_threads(1)
BS = 3          # 4 test frames: a full batch, then one padded to 3


def _spread_matches(model, variables, inputs, mesh):
    """Random weights send every scene point to one mesh vertex (scene
    and mesh features each share one dominant direction), and a Kabsch fit
    of a single vertex has no defined rotation.  Centre both feature sets
    by linear changes of their last layers: the scene head's last Dense
    (no bias) takes its input projected off the input's mean direction,
    the mesh head's last Dense subtracts the mean mesh feature.  Matches
    then spread over the mesh, with few near-ties, and the fits are well
    posed."""
    _, state = model.apply(
        variables, inputs, mesh, train=False,
        capture_intermediates=lambda mdl, _: mdl.name == "DenseBNAct_2")
    h = np.asarray(state["intermediates"]["feature_encoding_layer"][
        "DenseBNAct_2"]["__call__"][0], np.float64)
    h0 = h.reshape(-1, h.shape[-1]).mean(0)
    params = jax_tree_copy(variables["params"])
    dense = params["feature_encoding_layer"]["DenseBNAct_3"]["Dense_0"]
    proj = np.eye(len(h0)) - np.outer(h0, h0) / (h0 @ h0)
    dense["kernel"] = (proj @ np.asarray(dense["kernel"], np.float64)
                       ).astype(np.float32)
    feats = model.apply(variables, mesh, train=False, method="encode_mesh")
    head = params["model_emb"]["mesh_final"]
    head["bias"] = (np.asarray(head["bias"]) - np.asarray(feats).mean(0)
                    ).astype(np.float32)
    return {"params": params, "batch_stats": variables["batch_stats"]}


def jax_tree_copy(tree):
    """Nested dicts copied down to the leaves (flax params are read-only
    mappings)."""
    return {k: jax_tree_copy(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _read_csv(path):
    """{(scene, im, obj): (R [3,3], t [3] m)} and the row keys in order."""
    rows, keys = {}, []
    with open(path) as f:
        assert f.readline().startswith("scene_id,im_id,obj_id")
        for line in f:
            p = line.strip().split(",")
            key = (int(p[0]), int(p[1]), int(p[2]))
            keys.append(key)
            rows[key] = (np.array(p[4].split(), float).reshape(3, 3),
                         np.array(p[5].split(), float) / 1000.0)
    return rows, keys


@pytest.fixture(scope="module")
def runs(bop_root, tmp_path_factory):  # noqa: F811
    import jax
    import jax.numpy as jnp

    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base
    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import export_state_dict

    mp = MonkeyPatch()
    cfg_j = test_data._mini_config()
    cfg_t = port_config(cfg_j)
    mp.setitem(cfg_base._PRESETS, "lmo", cfg_j)
    mp.setitem(configs._PRESETS, "lmo", cfg_t)
    try:
        # one loader batch of all 4 frames, the CLI's mesh (fps in mm)
        ds = PoseDataset(cfg_t, 1, "test", data_root=bop_root)
        batch, meta = collate([ds[i] for i in range(len(ds))])
        raw = {k: batch[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale",
                                     "K_crop", "choose", "det")}
        from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
        mesh_fps = load_or_build_fps_mesh(bop_root, 1, N_MESH)
        fps_mm = np.concatenate([mesh_fps[:, :3] * 1000.0, mesh_fps[:, 3:]],
                                axis=1)
        mesh = MeshArrays.from_graph(build_mesh_graph(fps_mm, N_MESH))
        fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
        inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"],
                                 fin["choose"], fin["xyz_img"], approx=False)
        model, variables = H.jax_model_and_variables(inputs, mesh)
        variables = _spread_matches(model, variables, inputs, mesh)
        feats = model.apply(variables, mesh, train=False,
                            method="encode_mesh")
        seg = model.apply(variables, inputs, mesh, train=False,
                          mesh_features=feats)["seg"]
        variables = {"params": _split_seg_bias(variables["params"],
                                               np.asarray(seg)),
                     "batch_stats": variables["batch_stats"]}
        out = model.apply(variables, inputs, mesh, train=False,
                          mesh_features=feats)
        _, w, idx = jax.vmap(lambda c, s, r, d: fit_pose_single(
            c, s, out["mesh"], r, mesh.xyz, d))(
                fin["cld_rgb_nrm"][..., :3], out["seg"], out["rgbd"],
                fin["det"])

        sd = export_state_dict(variables["params"],
                               variables["batch_stats"])
        ckpt = str(tmp_path_factory.mktemp("torch_ckpt"))
        os.makedirs(osp.join(ckpt, "ape"))
        torch.save({"epoch": 0, "model_state": {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}},
            osp.join(ckpt, "ape", "geomatch.pth.tar"))

        engine = PoseEngine(cfg_t, fps_mm, weights.read_reference_checkpoint(
            osp.join(ckpt, "ape")), "cpu", batch=len(ds))
        engine.run(raw)
        fit_t = {k: v.numpy() for k, v in engine.last_fit.items()}

        common = ["--dataset", "lmo", "--data-root", bop_root, "--cls-id",
                  "1", "--batch-size", str(BS), "--num-workers", "2",
                  "--knn-chunk", "64", "--exact-knn", "--torch-checkpoint",
                  ckpt]
        out_j = str(tmp_path_factory.mktemp("out_jax"))
        out_t = str(tmp_path_factory.mktemp("out_port"))
        res_j = cli_j.main(["eval", *common, "--devices", "1",
                            "--output-dir", out_j])
        res_t = cli_t.main(["eval", *common, "--device", "cpu",
                            "--output-dir", out_t])
        out_ji = str(tmp_path_factory.mktemp("out_jax_icp"))
        out_ti = str(tmp_path_factory.mktemp("out_port_icp"))
        cli_j.main(["eval", *common, "--devices", "1", "--refine", "icp",
                    "--output-dir", out_ji])
        cli_t.main(["eval", *common, "--device", "cpu", "--refine", "icp",
                    "--output-dir", out_ti])
        infer_csv = str(tmp_path_factory.mktemp("infer") / "infer.csv")
        inf_t = cli_t.main(["infer", *common, "--device", "cpu",
                            "--output", infer_csv])
        csv_j = osp.join(out_j, "gt_lmo-test.csv")
        csv_t = osp.join(out_t, "gt_lmo-test.csv")
        score = ["--dataset", "lmo", "--data-root", bop_root]
        yield {
            "res_j": res_j, "res_t": res_t, "inf_t": inf_t,
            "csv_j": csv_j, "csv_t": csv_t, "out_t": out_t,
            "score_j_of_t": cli_j.main(["score", *score, "--csv", csv_t]),
            "score_t_of_j": cli_t.main(["score", *score, "--csv", csv_j]),
            "meta": meta, "fit_t": fit_t, "w": np.asarray(w),
            "idx": np.asarray(idx), "rgbd": np.asarray(out["rgbd"]),
            "mesh": np.asarray(out["mesh"]),
            "fg": np.asarray(jnp.argmax(out["seg"], -1) == 1),
            "common": common, "bop_root": bop_root, "ckpt": ckpt,
            "model": model, "variables": variables,
            "csv_j_icp": osp.join(out_ji, "gt_lmo-test.csv"),
            "csv_t_icp": osp.join(out_ti, "gt_lmo-test.csv"),
        }
    finally:
        mp.undo()


def _sure(r):
    """[B, N] rows whose similarity top-2 gap exceeds 1e-5."""
    c = r["rgbd"].shape[-1]
    f = r["rgbd"] / np.linalg.norm(r["rgbd"], axis=-1, keepdims=True)
    mf = r["mesh"] / np.linalg.norm(r["mesh"], axis=-1, keepdims=True)
    return (H.top2_gap(f.reshape(-1, c), mf) > 1e-5).reshape(
        r["idx"].shape)


def test_csv_rows_equal(runs):
    rows_j, keys_j = _read_csv(runs["csv_j"])
    rows_t, keys_t = _read_csv(runs["csv_t"])
    assert keys_t == keys_j and len(keys_t) == 4
    assert len(runs["res_t"]["errors"]["ape"]["ad"]) == 4
    for name in ("_lmo_tab.txt", "_lmo_errors.pkl", "_lmo_recalls.pkl"):
        assert osp.exists(osp.join(runs["out_t"], name))
    assert [b["n"] for b in runs["res_t"]["timing"]] == [3, 1]


def test_fg_mask_and_weights_equal(runs):
    assert 0.2 < runs["fg"].mean() < 0.8, runs["fg"].mean()
    np.testing.assert_array_equal(runs["fit_t"]["w"] > 0, runs["fg"])
    np.testing.assert_array_equal(runs["fit_t"]["w"], runs["w"])


def test_correspondences_agree_up_to_near_ties(runs):
    sure = _sure(runs)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(runs["fit_t"]["idx"][sure],
                                  runs["idx"][sure])


def test_poses_agree_where_correspondences_agree(runs):
    rows_j, _ = _read_csv(runs["csv_j"])
    rows_t, _ = _read_csv(runs["csv_t"])
    # only the weighted rows enter the fit
    same = ((runs["fit_t"]["idx"] == runs["idx"]) | (runs["w"] == 0)).all(1)
    assert same.sum() >= 2
    for i, m in enumerate(runs["meta"]):
        if not same[i]:
            continue
        s, im = (int(v) for v in m["file_name"].split("/"))
        (R_j, t_j), (R_t, t_t) = rows_j[(s, im, 1)], rows_t[(s, im, 1)]
        np.testing.assert_allclose(R_t, R_j, atol=1e-4)
        np.testing.assert_allclose(t_t, t_j, atol=1e-4)


def test_each_scorer_reproduces_the_other_runs_recalls(runs):
    for scored, ref in (("score_j_of_t", "res_t"), ("score_t_of_j", "res_j")):
        for m, vals in runs[ref]["recalls"]["ape"].items():
            assert runs[scored]["recalls"]["ape"][m] == vals, (scored, m)
        np.testing.assert_allclose(runs[scored]["errors"]["ape"]["ad"],
                                   runs[ref]["errors"]["ape"]["ad"],
                                   rtol=1e-9)
        assert runs[scored]["auc"]["ape"] == pytest.approx(
            runs[ref]["auc"]["ape"], abs=1e-9)


def test_infer_csv_has_the_eval_rows_and_poses(runs):
    rows_e, keys_e = _read_csv(runs["csv_t"])
    rows_i, keys_i = _read_csv(runs["inf_t"]["csv"])
    assert keys_i == keys_e
    for k in keys_e:
        np.testing.assert_array_equal(rows_i[k][0], rows_e[k][0])
        np.testing.assert_allclose(rows_i[k][1], rows_e[k][1], atol=1e-12)


def _same_frames(runs):
    """Frames of the in-process batch whose weighted correspondences are
    equal in both packages, as (scene, im) keys."""
    same = ((runs["fit_t"]["idx"] == runs["idx"]) | (runs["w"] == 0)).all(1)
    return [tuple(int(v) for v in m["file_name"].split("/"))
            for i, m in enumerate(runs["meta"]) if same[i]]


def test_refine_icp_csv_matches_jax(runs):
    """eval --refine icp: the JAX CLI's rows, and its refined poses within
    1e-4 on frames whose weighted correspondences agree (ICP starts from
    the same fit there); the refinement moved the poses."""
    rows_j, keys_j = _read_csv(runs["csv_j_icp"])
    rows_t, keys_t = _read_csv(runs["csv_t_icp"])
    plain, _ = _read_csv(runs["csv_t"])
    assert keys_t == keys_j and len(keys_t) == 4
    same = _same_frames(runs)
    assert len(same) >= 2
    for s, im in same:
        (R_j, t_j), (R_t, t_t) = rows_j[(s, im, 1)], rows_t[(s, im, 1)]
        np.testing.assert_allclose(R_t, R_j, atol=1e-4)
        np.testing.assert_allclose(t_t, t_j, atol=1e-4)
    assert any(np.abs(rows_t[k][1] - plain[k][1]).max() > 0 for k in keys_t)


@pytest.fixture(scope="module")
def vsd_runs(runs, tmp_path_factory):
    """Port ``eval --vsd`` (plain and ``--refine icp``) on the CPU, then
    the JAX CLI's and the port's ``score --vsd`` of each run's CSV: the
    JAX scorer gives the JAX package's VSD errors of the port's poses."""
    from gdm_tpu import cli as cli_j

    score = ["score", "--dataset", "lmo", "--data-root", runs["bop_root"],
             "--vsd"]
    out = {}
    for mode, extra in (("plain", []), ("icp", ["--refine", "icp"])):
        d = str(tmp_path_factory.mktemp(f"out_vsd_{mode}"))
        res = cli_t.main(["eval", *runs["common"], "--device", "cpu",
                          "--vsd", *extra, "--output-dir", d])
        csv = osp.join(d, "gt_lmo-test.csv")
        out[mode] = {
            "eval_t": res, "csv": csv,
            "score_j": cli_j.main([*score, "--csv", csv]),
            "score_t": cli_t.main([*score, "--device", "cpu", "--csv",
                                   csv])}
    return out


@pytest.mark.parametrize("mode", ["plain", "icp"])
def test_vsd_matches_jax_cli(vsd_runs, runs, mode):
    """``eval --vsd`` (``--refine icp --vsd``): per-frame VSD errors of the
    4 frames within 1e-6 of the JAX CLI's (its ``score --vsd`` of the
    port's CSV: t goes through mm and back), the same vsd recalls,
    ar_vsd and bop19_ar; the port's ``score --vsd`` of the CSV reproduces
    its eval run."""
    r = vsd_runs[mode]
    ev, sj, st = r["eval_t"], r["score_j"], r["score_t"]
    errs = np.asarray(ev["errors"]["ape"]["vsd"])
    assert errs.shape == (4, 10) and np.all((errs >= 0) & (errs <= 1))
    assert "vsd" in ev["table"] and "bop19_ar" in ev["table"]
    for other in (sj, st):
        np.testing.assert_allclose(
            np.asarray(other["errors"]["ape"]["vsd"]), errs, rtol=0,
            atol=1e-6)
        assert other["recalls"]["ape"]["vsd"] == ev["recalls"]["ape"]["vsd"]
        for key in ("ar_vsd", "ar_mssd", "ar_mspd", "bop19_ar"):
            assert other["bop19_ar"]["ape"][key] == pytest.approx(
                ev["bop19_ar"]["ape"][key], abs=1e-9), key
    # the run is the eval run of the same flags without --vsd, plus VSD
    plain, _ = _read_csv(runs["csv_t" if mode == "plain" else "csv_t_icp"])
    rows, _ = _read_csv(r["csv"])
    for k, (R, t) in rows.items():
        np.testing.assert_array_equal(R, plain[k][0])
        np.testing.assert_array_equal(t, plain[k][1])


@pytest.mark.parametrize("extra,err", [
    (["--multihost", "--devices", "2"], SystemExit),
    (["--model-shards", "2"], SystemExit),
    (["--device", "cuda"], RuntimeError)])
def test_unported_options_raise(runs, extra, err):
    """The layouts the JAX CLI refuses, with its messages: more than one
    device per process of a multihost run, and model shards that do not
    divide the ranks (one here); and CUDA where there is none.  (The
    multi-process runs themselves: tests/test_torch_mp_cli.py and
    tests/test_torch_sp_cli.py.)"""
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = ["eval", *runs["common"], "--device", "cpu", *extra]
    match = {"--multihost": r"--devices 2 out of range \(1\.\.1 per "
                            r"process\)",
             "--model-shards": "--model-shards 2 does not divide 1 "
                               "devices"}.get(extra[0])
    with pytest.raises(err, match=match):
        cli_t.main(args)


def test_infer_stacked_raises(runs):
    """--stacked and --model-shards exclude each other, as in the JAX
    CLI."""
    with pytest.raises(SystemExit, match="model-shards"):
        cli_t.main(["infer", *runs["common"], "--device", "cpu",
                    "--stacked", "--model-shards", "2"])


@pytest.mark.parametrize("cmd", ["eval", "infer"])
def test_unknown_refine_mode_refused(runs, cmd, capsys):
    with pytest.raises(SystemExit):
        cli_t.main([cmd, *runs["common"], "--device", "cpu", "--refine",
                    "lm"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.fixture(scope="module")
def stacked_runs(runs, bop_root_2obj, tmp_path_factory):  # noqa: F811
    """``infer --stacked`` of both CLIs on the two-object tree of
    tests/test_cli.py (objects 1 and 2, alternating frames), both objects
    under the checkpoint of ``runs``; the port also with the vmap
    schedule and with --refine icp, and per object.  In process, one
    mixed batch of all 4 frames through the port's MultiObjectEngine and
    through each frame's JAX model."""
    import dataclasses
    import shutil

    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base
    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.eval.multimodel import MultiObjectEngine

    root = bop_root_2obj
    cfg_j = test_data._mini_config()
    cfg_j = dataclasses.replace(
        cfg_j, data=dataclasses.replace(cfg_j.data, obj_ids=(1, 2)))
    cfg_t = port_config(cfg_j)
    mp = MonkeyPatch()
    mp.setitem(cfg_base._PRESETS, "lmo", cfg_j)
    mp.setitem(configs._PRESETS, "lmo", cfg_t)
    try:
        ckpt = str(tmp_path_factory.mktemp("ckpt_2obj"))
        for name in ("ape", "benchvise"):
            shutil.copytree(osp.join(runs["ckpt"], "ape"),
                            osp.join(ckpt, name))
        common = ["--dataset", "lmo", "--data-root", root, "--batch-size",
                  str(BS), "--num-workers", "2", "--knn-chunk", "64",
                  "--exact-knn", "--torch-checkpoint", ckpt]
        out = str(tmp_path_factory.mktemp("stacked"))
        csv = {k: osp.join(out, f"{k}.csv") for k in (
            "jax", "by_class", "vmap", "icp", "per_object")}
        cli_j.main(["infer", *common, "--stacked", "--output", csv["jax"]])
        port = ["infer", *common, "--device", "cpu", "--output"]
        res = {"by_class": cli_t.main(port + [csv["by_class"], "--stacked"]),
               "vmap": cli_t.main(port + [csv["vmap"], "--stacked",
                                          "--stacked-schedule", "vmap"]),
               "icp": cli_t.main(port + [csv["icp"], "--stacked",
                                         "--refine", "icp"]),
               "per_object": cli_t.main(port + [csv["per_object"]])}

        # one mixed batch of the 4 frames, in the CLI's round-robin order
        parts = [(c, PoseDataset(cfg_t, c, "infer", data_root=root))
                 for c in (1, 2)]
        mixed = cli_t.MixedInferDataset(parts)
        batch, meta = collate([mixed[k] for k in range(len(mixed))])
        engines, fps_mm = [], {}
        for c, name in ((1, "ape"), (2, "benchvise")):
            fps = load_or_build_fps_mesh(root, c, N_MESH)
            fps_mm[c] = np.concatenate([fps[:, :3] * 1000.0, fps[:, 3:]],
                                       axis=1)
            engines.append(PoseEngine(
                cfg_t, fps_mm[c], weights.read_reference_checkpoint(
                    osp.join(ckpt, name)), "cpu", batch=len(mixed)))
        keys = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose", "det")
        st = MultiObjectEngine(engines, "by_class", 4)
        st.run({k: batch[k] for k in keys + ("obj_pos",)})
        fit_t = {k: np.asarray(v) for k, v in st.last_fit.items()}

        fin = finalize_batch({k: jnp.asarray(batch[k]) for k in keys})
        inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"],
                                 fin["choose"], fin["xyz_img"], approx=False)
        model, variables = runs["model"], runs["variables"]
        w = np.zeros(fit_t["w"].shape, np.float32)
        idx = np.zeros(fit_t["idx"].shape, np.int64)
        rgbd = np.zeros(fit_t["rgbd"].shape, np.float32)
        mesh_f = {}
        for p, c in enumerate((1, 2)):
            mesh = MeshArrays.from_graph(build_mesh_graph(fps_mm[c], N_MESH))
            feats = model.apply(variables, mesh, train=False,
                                method="encode_mesh")
            o = model.apply(variables, inputs, mesh, train=False,
                            mesh_features=feats)
            _, w_c, idx_c = jax.vmap(lambda a, s, r, d: fit_pose_single(
                a, s, o["mesh"], r, mesh.xyz, d))(
                    fin["cld_rgb_nrm"][..., :3], o["seg"], o["rgbd"],
                    fin["det"])
            rows = batch["obj_pos"] == p
            w[rows], idx[rows] = np.asarray(w_c)[rows], np.asarray(idx_c)[rows]
            rgbd[rows] = np.asarray(o["rgbd"])[rows]
            mesh_f[c] = np.asarray(o["mesh"])
        yield {"csv": csv, "res": res, "meta": meta, "fit_t": fit_t,
               "w": w, "idx": idx, "rgbd": rgbd, "mesh_f": mesh_f,
               "obj_pos": batch["obj_pos"]}
    finally:
        mp.undo()


def test_infer_stacked_rows_match_jax(stacked_runs):
    """The JAX CLI's rows, in its order, from every schedule and with ICP,
    mixing both objects in one batch; the per-object run lists the same
    rows object by object."""
    _, keys_j = _read_csv(stacked_runs["csv"]["jax"])
    assert len(keys_j) == 4 and {k[2] for k in keys_j} == {1, 2}
    for run in ("by_class", "vmap", "icp"):
        _, keys = _read_csv(stacked_runs["csv"][run])
        assert keys == keys_j, run
    _, keys = _read_csv(stacked_runs["csv"]["per_object"])
    assert sorted(keys) == sorted(keys_j)
    assert [b["n"] for b in stacked_runs["res"]["by_class"]["timing"]] == \
        [3, 1]


def test_infer_stacked_fit_matches_jax(stacked_runs):
    """In process: the Kabsch weights equal; the correspondences equal
    on every point whose normalised feature the two packages computed
    within 1e-4 and whose top-2 gap exceeds 1e-5 (a near-tie).  A point
    whose feature differs more has a KNN near-tie in its neighbourhood
    (the pyramid's f32 distances round differently); they are under
    10%."""
    r = stacked_runs
    np.testing.assert_array_equal(r["fit_t"]["w"], r["w"])
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa
    f_j, f_t = unit(r["rgbd"]), unit(r["fit_t"]["rgbd"])
    same_f = np.abs(f_t - f_j).max(-1) <= 1e-4
    assert same_f.mean() > 0.9, same_f.mean()
    gap = np.stack([H.top2_gap(f_j[i], unit(r["mesh_f"][c]))
                    for i, c in enumerate(np.array([1, 2])[r["obj_pos"]])])
    sure = same_f & (gap > 1e-5)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(r["fit_t"]["idx"][sure], r["idx"][sure])


def test_infer_stacked_poses_match_jax(stacked_runs):
    """Poses within 1e-4 of the JAX CLI's on frames whose weighted
    correspondences agree; both port schedules and the port's
    per-object run give the same poses."""
    r = stacked_runs
    rows_j, _ = _read_csv(r["csv"]["jax"])
    runs_t = {k: _read_csv(r["csv"][k])[0]
              for k in ("by_class", "vmap", "per_object")}
    same = ((r["fit_t"]["idx"] == r["idx"]) | (r["w"] == 0)).all(1)
    assert same.sum() >= 1
    for i, m in enumerate(r["meta"]):
        s, im = (int(v) for v in m["file_name"].split("/"))
        key = (s, im, (1, 2)[r["obj_pos"][i]])
        for rows_t in runs_t.values():
            np.testing.assert_allclose(rows_t[key][0],
                                       runs_t["by_class"][key][0], atol=1e-5)
            np.testing.assert_allclose(rows_t[key][1],
                                       runs_t["by_class"][key][1], atol=1e-5)
        if same[i]:
            np.testing.assert_allclose(runs_t["by_class"][key][0],
                                       rows_j[key][0], atol=1e-4)
            np.testing.assert_allclose(runs_t["by_class"][key][1],
                                       rows_j[key][1], atol=1e-4)


def test_knn_chunk_lowered_only_at_large_batches():
    log = cli_t.get_logger("test")
    lmo = configs.LMO
    assert cli_t.knn_chunk_for(1024, 8, lmo, log) == 1024
    big = cli_t.knn_chunk_for(1024, 128, lmo, log)
    assert big < 1024 and big & (big - 1) == 0
    assert 128 * big * 128 ** 2 <= cli_t.KNN_BLOCK_ELEMS


def test_checkpoint_missing_key_raises(tmp_path):
    from gdm_tpu_torch.models.geomatch import GeoMatch

    m = GeoMatch(16, (8, 16, 16, 16))
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    torch.save({"model_state": sd}, str(tmp_path / "geomatch.pth.tar"))
    got = weights.read_reference_checkpoint(str(tmp_path))
    weights.load_reference_state_dict(GeoMatch(16, (8, 16, 16, 16)), got)
    del sd["seg_layer.3.conv.bias"]
    torch.save(sd, str(tmp_path / "bare.pth.tar"))
    with pytest.raises(RuntimeError, match="seg_layer.3.conv.bias"):
        weights.load_reference_state_dict(
            GeoMatch(16, (8, 16, 16, 16)),
            weights.read_reference_checkpoint(str(tmp_path / "bare.pth.tar")))



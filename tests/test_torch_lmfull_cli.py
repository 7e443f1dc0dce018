"""``cli eval | score --dataset lmfull`` of the port against the JAX
package's CLI, on the CPU, on the mini LM-full tree of
tests/test_torch_lmfull.py (the eggbox, 6 test frames, one val batch of
8 padded from 6, 3072 points, 64^2 crops, 1 mm of depth noise).

Weights are built as in tests/test_torch_cli.py, from the port's seeded
random weights (seeded_jax_variables) where that file takes a flax init:
their scene and mesh features are centred and whose seg head is split near the
median, so that matches spread and the fits are well posed, exported as
<ckpt>/eggbox/geomatch.pth.tar.  JAX's ``eval --exact-knn`` and the
port's ``eval --device cpu`` read it; in process, JAX's fit of the same
6 frames, and the port's fit as its CLI run made it (PoseEngine.infer
wrapped).  The two runs:

- list the same CSV rows;
- have the same fg mask and Kabsch weights;
- have equal correspondences on every row whose top-2 cosine gap
  exceeds 1e-5 plus what the two forwards' feature gap can move a score
  by (decided_rows);
- have poses within 1e-4 on frames whose weighted correspondences all
  agree;
- scored by the other package's ``score``, give their own recalls (the
  eggbox by ADD-S in both).

Why that rule: at LM-full's sampling density (3072 of the crop's
4096 pixels; 12800 of 16384 at full size) the scene points are nearly
the whole pixel lattice, and some neighbour sets differ between the two
packages among near-ties of the f32 expanded distances (0.4% of the
first level's rows here; tests/test_torch_lmfull.py holds every such
pick to the near-tie rule).  The points near such a pick get other
features (up to ~5% of the largest): on JAX's own pyramid the port's
forward agrees within ~2e-5 (test_forward_on_jaxs_pyramid).  Depth
noise keeps the pixel lattice from tying in exact arithmetic, as a
sensor's does; on noise-free synthetic depth the flips touch every
frame.

tests/test_torch_lmfull_knn_cli.py runs JAX's default KNN mode the same
way."""

import os
import os.path as osp

import numpy as np
import pytest
import torch

import _torch_harness as H
from test_torch_cli import _read_csv, _spread_matches
from test_torch_lmfull import N_MESH, N_TEST, OBJ, build_mini_root, \
    patch_presets
from test_torch_serve import _split_seg_bias
from test_torch_ycbv import _Jitted
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate

torch.set_num_threads(1)
NAME = "eggbox"
RAW_KEYS = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose", "det")


class KeptFits:
    """While active, every batch a port PoseEngine fits is kept (numpy),
    the CLI's warm-up batch first."""

    def __enter__(self):
        from gdm_tpu_torch.serve import PoseEngine

        self.orig, self.fits = PoseEngine.infer, []

        def infer(engine, fin):
            poses = self.orig(engine, fin)
            self.fits.append({k: v.numpy()
                              for k, v in engine.last_fit.items()})
            return poses

        PoseEngine.infer = infer
        return self

    def __exit__(self, *exc):
        from gdm_tpu_torch.serve import PoseEngine

        PoseEngine.infer = self.orig


def seeded_jax_variables(inputs, mesh, seed=0, train=False,
                         positive_r=0.01):
    """Flax GeoMatch and its variables holding the port's seeded random
    weights (weights.init_random_, flax's initialisers' spreads; with
    ``train``, the loss weights too), read by JAX's strict import into
    the tree that jax.eval_shape gives: flax's init is never compiled
    (~16 s on a cold cache at these shapes)."""
    import jax

    from gdm_tpu.models import GeoMatch as GeoMatchJ
    from gdm_tpu.train.import_torch import import_state_dict
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch import GeoMatch

    model = GeoMatchJ(positive_r=positive_r)
    key = jax.random.PRNGKey(seed)
    rngs = {"params": key, "dropout": key} if train else key
    tree = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: model.init(rngs, inputs, mesh, train=train)))
    port = GeoMatch(awl=train)
    weights.init_random_(port, torch.Generator().manual_seed(seed))
    params, stats, _ = import_state_dict(
        tree["params"], tree["batch_stats"],
        {k: v.numpy() for k, v in weights.reference_state_dict(port).items()},
        strict=True)
    return model, {"params": params, "batch_stats": stats}


def jax_weights_and_fit(root, cfg_t, ckpt_dir, approx):
    """Well-posed flax weights saved as <ckpt_dir>/eggbox/geomatch.pth.tar,
    and JAX's fit of the test frames under them (``approx``: its default
    pyramid, else --exact-knn's): {"w", "idx", "rgbd", "mesh", "fg",
    "inputs", "meta"}."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import export_state_dict
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh

    ds = PoseDataset(cfg_t, OBJ, "test", data_root=root)
    batch, meta = collate([ds[i] for i in range(len(ds))])
    mesh = MeshArrays.from_graph(build_mesh_graph(cli_t._fps_mm(
        load_or_build_fps_mesh(root, OBJ, N_MESH)), N_MESH))
    fin = finalize_batch({k: jnp.asarray(batch[k]) for k in RAW_KEYS})
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], approx=approx)
    model, variables = seeded_jax_variables(inputs, mesh)
    variables = _spread_matches(_Jitted(model), variables, inputs, mesh)
    forward = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))
    seg = forward(variables, inputs, mesh)["seg"]
    variables = {"params": _split_seg_bias(variables["params"],
                                           np.asarray(seg)),
                 "batch_stats": variables["batch_stats"]}
    out = forward(variables, inputs, mesh)
    _, w, idx = jax.vmap(lambda c, s, r, d: fit_pose_single(
        c, s, out["mesh"], r, mesh.xyz, d))(
            fin["cld_rgb_nrm"][..., :3], out["seg"], out["rgbd"],
            fin["det"])
    sd = export_state_dict(variables["params"], variables["batch_stats"])
    os.makedirs(osp.join(ckpt_dir, NAME))
    torch.save({"epoch": 0, "model_state": {
        k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
        osp.join(ckpt_dir, NAME, "geomatch.pth.tar"))
    return {"w": np.asarray(w), "idx": np.asarray(idx),
            "rgbd": np.asarray(out["rgbd"]), "mesh": np.asarray(out["mesh"]),
            "seg": np.asarray(out["seg"]),
            "fg": np.asarray(jnp.argmax(out["seg"], -1) == 1),
            "inputs": {k: np.asarray(v) for k, v in inputs.items()},
            "meta": meta}


def cli_runs(tmp_path_factory, approx):
    """The mini tree and weights, then JAX's ``cli eval`` (--exact-knn,
    or its default mode with ``approx``) and the port's ``cli eval
    --device cpu``, both presets patched."""
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j

    root = build_mini_root(str(tmp_path_factory.mktemp("lmfull_cli")))
    mp = MonkeyPatch()
    _, cfg_t = patch_presets(mp)
    try:
        ckpt = str(tmp_path_factory.mktemp("lmfull_ckpt"))
        fit_j = jax_weights_and_fit(root, cfg_t, ckpt, approx)
        common = ["--dataset", "lmfull", "--data-root", root, "--cls-id",
                  str(OBJ), "--num-workers", "2", "--torch-checkpoint", ckpt]
        out, csv = {}, {}
        for run, cli, extra in (
                ("jax", cli_j, ["--devices", "1"]
                 + ([] if approx else ["--exact-knn"])),
                ("port", cli_t, ["--device", "cpu"])):
            d = str(tmp_path_factory.mktemp(run))
            with KeptFits() as kept:
                out[run] = cli.main(["eval", *common, *extra,
                                     "--output-dir", d])
            csv[run] = osp.join(d, "gt_lmfull-test.csv")
        return {"root": root, "ckpt": ckpt, "fit_j": fit_j, "out": out,
                "csv": csv, "n_port_fits": len(kept.fits),
                "fit_t": {k: v if k == "mesh" else v[:N_TEST]
                          for k, v in kept.fits[-1].items()},
                "mp": mp}
    except BaseException:
        mp.undo()
        raise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from gdm_tpu import cli as cli_j

    r = cli_runs(tmp_path_factory, approx=False)
    try:
        score = ["score", "--dataset", "lmfull", "--data-root", r["root"],
                 "--cls-id", str(OBJ), "--csv"]
        r["score_j_of_t"] = cli_j.main([*score, r["csv"]["port"]])
        r["score_t_of_j"] = cli_t.main([*score, r["csv"]["jax"], "--device",
                                        "cpu"])
        yield r
    finally:
        r["mp"].undo()


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def decided_rows(fit_t, fit_j):
    """[B, N] rows whose correspondence neither package's rounding nor the
    two forwards' feature gap can flip: JAX's top-2 cosine gap exceeds
    1e-5 + 2 (|n_t - n_j| + max_m |m_t - m_j|) for the unit scene row
    features n and mesh features m (a score moves by at most that
    sum)."""
    n_t, n_j = _unit(fit_t["rgbd"]), _unit(fit_j["rgbd"])
    m_t, m_j = _unit(fit_t["mesh"]), _unit(fit_j["mesh"])
    dn = np.linalg.norm(n_t - n_j, axis=-1)
    dm = np.linalg.norm(m_t - m_j, axis=-1).max()
    c = n_j.shape[-1]
    gap = H.top2_gap(n_j.reshape(-1, c), m_j).reshape(dn.shape)
    return gap > 1e-5 + 2 * (dn + dm)


def agreeing_frames(fit_t, fit_j):
    """Frames whose Kabsch weights are equal and whose weighted
    correspondences are all equal."""
    return ((fit_t["w"] == fit_j["w"]) & ((fit_t["idx"] == fit_j["idx"])
                                          | (fit_j["w"] == 0))).all(1)


def check_rows_and_batches(r):
    keys_j, keys_t = _read_csv(r["csv"]["jax"])[1], _read_csv(
        r["csv"]["port"])[1]
    assert keys_t == keys_j and len(keys_t) == N_TEST
    assert {k[2] for k in keys_t} == {OBJ}
    # one val batch of 8 (6 frames and 2 padded rows), after the warm-up
    assert [b["n"] for b in r["out"]["port"]["timing"]] == [N_TEST]
    assert r["n_port_fits"] == 2
    assert len(r["out"]["port"]["errors"][NAME]["ad"]) == N_TEST


def check_fits(r):
    """fg mask and Kabsch weights equal; correspondences equal on the
    rows of the module docstring's rule."""
    ref, got = r["fit_j"], r["fit_t"]
    assert 0.2 < ref["fg"].mean() < 0.8, ref["fg"].mean()
    np.testing.assert_array_equal(got["w"] > 0, ref["fg"])
    np.testing.assert_allclose(got["w"], ref["w"], rtol=0, atol=1e-6)
    sure = decided_rows(got, ref)
    assert sure.mean() > 0.8, sure.mean()
    np.testing.assert_array_equal(got["idx"][sure], ref["idx"][sure])


def check_poses(r):
    rows_j, _ = _read_csv(r["csv"]["jax"])
    rows_t, _ = _read_csv(r["csv"]["port"])
    same = agreeing_frames(r["fit_t"], r["fit_j"])
    assert same.sum() >= N_TEST // 2, same
    for i, m in enumerate(r["fit_j"]["meta"]):
        if not same[i]:
            continue
        s, im = (int(v) for v in m["file_name"].split("/"))
        (R_j, t_j), (R_t, t_t) = rows_j[(s, im, OBJ)], rows_t[(s, im, OBJ)]
        np.testing.assert_allclose(R_t, R_j, atol=1e-4)
        np.testing.assert_allclose(t_t, t_j, atol=1e-4)


def test_csv_rows_and_batches(runs):
    check_rows_and_batches(runs)


def test_fits_agree_in_process(runs):
    check_fits(runs)


def test_poses_agree_where_correspondences_agree(runs):
    check_poses(runs)


def test_forward_on_jaxs_pyramid(runs):
    """The port's eval forward on JAX's model inputs (its pyramid
    included) under the checkpoint: seg, rgbd and mesh within 1e-4 of
    JAX's (max|d|/max|ref|)."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
    from gdm_tpu_torch.models.spline_mesh import build_mesh_graph

    model = GeoMatch().eval()
    weights.load_reference_state_dict(model, weights.read_reference_checkpoint(
        osp.join(runs["ckpt"], NAME)))
    mesh = MeshArrays.from_graph(build_mesh_graph(cli_t._fps_mm(
        load_or_build_fps_mesh(runs["root"], OBJ, N_MESH)), N_MESH), "cpu")
    with torch.no_grad():
        out = model(H.to_torch(runs["fit_j"]["inputs"]), mesh)
    for key in ("seg", "rgbd", "mesh"):
        err = H.rel_err(out[key].numpy(), runs["fit_j"][key])
        assert err <= 1e-4, (key, err)


def test_each_scorer_reproduces_the_other_runs_recalls(runs):
    """JAX's score of the port's CSV gives the port's recalls, and the
    port's score of JAX's CSV JAX's (ADD-S for the eggbox, lm_full's
    symmetric object)."""
    for scored, ref in ((runs["score_j_of_t"], runs["out"]["port"]),
                        (runs["score_t_of_j"], runs["out"]["jax"])):
        for m, vals in ref["recalls"][NAME].items():
            assert scored["recalls"][NAME][m] == vals, m
        np.testing.assert_allclose(scored["errors"][NAME]["ad"],
                                   ref["errors"][NAME]["ad"], rtol=1e-9)
        assert scored["auc"][NAME] == pytest.approx(ref["auc"][NAME],
                                                    abs=1e-9)


def test_eggbox_is_scored_by_add_s(runs):
    """The port's eval scores the eggbox (lm_full's symmetric object) by
    ADD-S: its ad errors are metrics.adi_err of the CSV's poses against
    the tree's GT over the fps points, not add_err."""
    import json

    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.eval import metrics

    pts = load_or_build_fps_mesh(runs["root"], OBJ, N_MESH)[:, :3]
    with open(osp.join(runs["root"], "test", "000000",
                       "scene_gt.json")) as f:
        gt = json.load(f)
    rows, keys = _read_csv(runs["csv"]["port"])
    adi, add = [], []
    for key in keys:
        R, t = rows[key]
        g = gt[str(key[1])][0]
        R_g = np.reshape(g["cam_R_m2c"], (3, 3))
        t_g = np.asarray(g["cam_t_m2c"]) / 1000.0
        adi.append(metrics.adi_err(R, t, R_g, t_g, pts))
        add.append(metrics.add_err(R, t, R_g, t_g, pts))
    np.testing.assert_allclose(runs["out"]["port"]["errors"][NAME]["ad"],
                               adi, rtol=1e-5, atol=1e-9)
    assert max(abs(a - b) for a, b in zip(adi, add)) > 1e-4

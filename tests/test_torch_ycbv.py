"""The YCB-V preset on the port against the JAX package, on the CPU: the
cv2-free depth fill and photometric primitives of data/augment against
OpenCV, the train and test items of the mini YCB-V tree of
tests/test_ycbv_e2e.py (2 objects, 120x160 frames, 64^2 crop),
finalize_batch(fill_depth=True), the served spec, and the CLIs.

Bounds, where an OpenCV call is not reproduced bit for bit:
  * cv2.bilateralFilter runs Intel IPP's filter, whose arithmetic the port
    does not reproduce; the port's OpenCV-algorithm filter agrees within
    BILATERAL_TOL metres (measured: <= 1.5e-6 m on the crops below).
    Dilation, closing, the 7x7 fill and the median are bit-equal.
  * cv2.filter2D computes kernels of >= 130 taps (motion blurs of side
    >= 12) by DFT; the port's direct sum differs there by at most one
    grey level on at most MOTION_SHARE of the pixels.  Every other
    primitive (BGR2HSV, HSV2BGR, the 3x3 sharpen, cv2.line,
    GaussianBlur) is bit-equal."""

import dataclasses
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

import test_ycbv_e2e
from test_data import IM_H, IM_W, N_MESH  # noqa: F401
from test_torch_dataset import _assert_same, port_config
from test_ycbv_e2e import BOWL, MUG, ycbv_root  # noqa: F401
from gdm_tpu_torch import configs
from gdm_tpu_torch.data import augment as aug_t
from gdm_tpu_torch.data.dataset import PoseDataset

torch.set_num_threads(1)
BILATERAL_TOL = 4e-6           # metres, fill_depth_fast after the bilateral
MOTION_SHARE = 0.1             # share of pixels one grey level off (DFT)


# -- the depth fill -----------------------------------------------------------

def _holey_crop(seed, s):
    r = np.random.RandomState(seed)
    d = (0.4 + 0.8 * r.rand(s, s)).astype(np.float32)
    d[r.rand(s, s) < 0.3] = 0.0
    d[s // 6:s // 3, s // 10:s // 2] = 0.0             # a large hole
    d[r.rand(s, s) < 0.02] = 0.05                      # below the 0.1 cut
    return d


def _fill_cases():
    hole = np.full((64, 64), 0.8, np.float32)
    hole[30:34, 30:34] = 0.0                            # TestFillDepth
    flat = np.full((32, 32), 0.7, np.float32)           # max - min < eps
    return {
        "interior_hole": hole,
        "all_empty": np.zeros((64, 64), np.float32),
        "flat": flat,
        **{f"random_{s}_{seed}": _holey_crop(seed, s)
           for s, seed in ((64, 0), (64, 1), (64, 2), (256, 3), (256, 4))},
    }


@pytest.mark.parametrize("case", sorted(_fill_cases()))
def test_fill_depth_fast_matches_cv2(case):
    from gdm_tpu.data.augment import fill_depth_fast as fill_j

    d = _fill_cases()[case]
    # the stages before the bilateral filter, each against its cv2 call
    x = d.copy()
    valid = x > 0.1
    x[valid] = 3.0 - x[valid]
    cross5 = cv2.getStructuringElement(cv2.MORPH_CROSS, (5, 5))
    want = cv2.dilate(x, cross5)
    np.testing.assert_array_equal(aug_t.dilate(x, aug_t._cross(5)), want)
    x = want
    want = cv2.morphologyEx(x, cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8))
    np.testing.assert_array_equal(
        aug_t.erode(aug_t.dilate(x, aug_t._square(5)), aug_t._square(5)),
        want)
    x = want
    np.testing.assert_array_equal(aug_t.dilate(x, aug_t._square(7)),
                                  cv2.dilate(x, np.ones((7, 7), np.uint8)))
    np.testing.assert_array_equal(aug_t.median_blur5(x),
                                  cv2.medianBlur(x, 5))
    # whole fill: bit-equal without the blur, within the bound with it
    np.testing.assert_array_equal(aug_t.fill_depth_fast(d, blur=False),
                                  fill_j(d, blur=False))
    got, ref = aug_t.fill_depth_fast(d), fill_j(d)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got > 0.1, ref > 0.1)
    assert float(np.abs(got - ref).max()) <= BILATERAL_TOL
    if case == "all_empty":
        np.testing.assert_array_equal(got, ref)
    if case == "flat":
        # OpenCV's algorithm copies an image whose max - min is below
        # FLT_EPSILON (IPP, which cv2 runs, filters it all the same)
        np.testing.assert_array_equal(aug_t.bilateral_filter(x), x)
    if case == "interior_hole":
        assert (got[31:33, 31:33] > 0.5).all()


# -- the rgb primitives -------------------------------------------------------

def _all_colours(part, parts=4):
    c = np.arange(part << 22, (part + 1) << 22, dtype=np.uint32)
    img = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1)
    return img.astype(np.uint8).reshape(1024, 4096, 3)


@pytest.mark.parametrize("part", range(4))
def test_hsv_conversions_bit_equal_on_every_colour(part):
    """Both conversions over a quarter of the 2^24 uint8 triples each."""
    img = _all_colours(part)
    np.testing.assert_array_equal(aug_t.bgr2hsv(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    np.testing.assert_array_equal(aug_t.hsv2bgr(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_sharpen_filter2d_and_gaussian_blur_bit_equal():
    rng = np.random.RandomState(0)
    for _ in range(60):
        img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        kernel = -np.ones((3, 3))
        kernel[1, 1] = rng.rand() * 3 + 9
        kernel /= kernel.sum()
        np.testing.assert_array_equal(aug_t.filter2d(img, kernel),
                                      cv2.filter2D(img, -1, kernel))
        k = 3 if rng.rand() > 0.2 else 5
        sigma = rng.rand()
        np.testing.assert_array_equal(aug_t.gaussian_blur(img, k, sigma),
                                      cv2.GaussianBlur(img, (k, k), sigma))
    for k in (3, 5):                     # sigma <= 0: derived from ksize
        np.testing.assert_array_equal(aug_t.gaussian_blur(img, k, 0.0),
                                      cv2.GaussianBlur(img, (k, k), 0.0))


def test_line_bit_equal():
    """Every motion kernel the augmentation can draw, and random segments
    that leave the image (clipping)."""
    for ang in range(360):
        for length in range(1, 16):
            rad = np.deg2rad(ang)
            dx, dy = np.cos(rad), np.sin(rad)
            a = int(max(abs(dx), abs(dy)) * length * 2)
            if a <= 0:
                continue
            c = a // 2
            p2 = (int(dx * length + c), int(dy * length + c))
            want = np.zeros((a, a))
            cv2.line(want, (c, c), p2, 1.0)
            got = aug_t.draw_line(np.zeros((a, a)), (c, c), p2, 1.0)
            np.testing.assert_array_equal(got, want, err_msg=str((ang,
                                                                  length)))
    rng = np.random.RandomState(1)
    for _ in range(500):
        p1, p2 = (tuple(int(v) for v in rng.randint(-8, 24, 2))
                  for _ in range(2))
        want = np.zeros((13, 17))
        cv2.line(want, p1, p2, 1.0)
        np.testing.assert_array_equal(
            aug_t.draw_line(np.zeros((13, 17)), p1, p2, 1.0), want,
            err_msg=str((p1, p2)))


def test_motion_blur_within_one_level():
    """Direct filter2D: bit-equal below 130 taps; the DFT path of larger
    kernels: at most one grey level on at most MOTION_SHARE of pixels."""
    from gdm_tpu.data.augment import _linear_motion_blur as blur_j

    rng = np.random.RandomState(2)
    worst = {}
    for ang in range(0, 360, 11):
        for length in range(1, 16):
            img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
            got = aug_t.linear_motion_blur(img, ang, length).astype(int)
            d = np.abs(got - blur_j(img, ang, length))
            rad = np.deg2rad(ang)
            a = int(max(abs(np.cos(rad)), abs(np.sin(rad))) * length * 2)
            if a * a < 130:
                assert d.max() == 0, (ang, length)
            assert d.max() <= 1 and (d > 0).mean() <= MOTION_SHARE
            worst[a] = max(worst.get(a, 0.0), float((d > 0).mean()))
    assert 0 < max(worst.values()) <= MOTION_SHARE   # the DFT path ran


@pytest.mark.parametrize("seed", range(6))
def test_rgb_add_noise_matches_jax(seed):
    """Same draws in the same order (the RandomState ends in the same
    state); the images agree within the motion-blur bound."""
    from gdm_tpu.data.augment import rgb_add_noise as noise_j

    img = np.random.RandomState(100 + seed).randint(
        0, 256, (64, 64, 3)).astype(np.uint8)
    for i in range(25):
        r_t, r_j = (np.random.RandomState(25 * seed + i) for _ in range(2))
        got, want = aug_t.rgb_add_noise(img, r_t), noise_j(img, r_j)
        assert got.dtype == want.dtype == np.uint8
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 1 and (d > 0).mean() <= MOTION_SHARE, i
        st_t, st_j = r_t.get_state(), r_j.get_state()
        assert st_t[2] == st_j[2]
        np.testing.assert_array_equal(st_t[1], st_j[1])


def test_add_real_background_matches_jax(ycbv_root):  # noqa: F811
    from gdm_tpu.data import bop as bop_j
    from gdm_tpu.data.augment import add_real_background as paste_j
    from gdm_tpu_torch.data import bop as bop_t

    recs_t, _ = bop_t.build_index(ycbv_root, "train_real", (BOWL, MUG),
                                  "train", im_hw=(IM_H, IM_W))
    recs_j, _ = bop_j.build_index(ycbv_root, "train_real", (BOWL, MUG),
                                  "train", im_hw=(IM_H, IM_W))
    rng = np.random.RandomState(5)
    for i in range(8):
        rgb = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        labels = (rng.rand(64, 64) < 0.3).astype(np.uint8)
        dpt = (rng.rand(64, 64) * (rng.rand(64, 64) < 0.6)).astype(
            np.float32)
        msk = (dpt > 0).astype(np.uint8)
        r_t, r_j = np.random.RandomState(i), np.random.RandomState(i)
        got = aug_t.add_real_background(rgb, labels, dpt, msk, recs_t, r_t,
                                        64, (IM_H, IM_W))
        want = paste_j(rgb, labels, dpt, msk, recs_j, r_j, 64, (IM_H, IM_W))
        for a, b in zip(got, want):
            _assert_same(a, b, i)
        assert r_t.randint(1 << 30) == r_j.randint(1 << 30)


# -- the dataset --------------------------------------------------------------

def _configs():
    cfg_j = test_ycbv_e2e._mini_ycbv_config()
    return cfg_j, port_config(cfg_j)


def _datasets(root, mode, cls_id=BOWL):
    from gdm_tpu.data.dataset import PoseDataset as PoseDatasetJ
    from gdm_tpu_torch import refdata

    cfg_j, cfg_t = _configs()
    diameter = refdata.get("ycbv").diameters_mm_by_id[cls_id] / 1000.0
    ds_t = PoseDataset(cfg_t, cls_id, mode, data_root=root,
                       rng=np.random.RandomState(0), diameter_m=diameter)
    ds_j = PoseDatasetJ(cfg_j, cls_id, mode, diameter_m=diameter,
                        data_root=root, rng=np.random.RandomState(0))
    return ds_t, ds_j


def _assert_items_agree(a, b, msg):
    """Counts, points and GT bit-equal; the filled depth within the
    bilateral bound; colour within the motion-blur bound."""
    assert set(a) <= set(b) and "dpt_filled" in a, msg
    for k in a:
        if k == "dpt_filled":
            assert a[k].dtype == b[k].dtype == np.float32
            assert float(np.abs(a[k] - b[k]).max()) <= BILATERAL_TOL, msg
        elif k == "rgb_u8":
            d = np.abs(a[k].astype(int) - b[k])
            assert d.max() <= 1 and (d > 0).mean() <= MOTION_SHARE, msg
        else:
            _assert_same(a[k], b[k], (msg, k))


def test_train_items_match_jax(ycbv_root):  # noqa: F811
    """Subset classing, the real/pbr picks, and every train item of two
    epochs: the synt items go through noise, the real background and the
    second noise, all items through the fill."""
    ds_t, ds_j = _datasets(ycbv_root, "train")
    assert (len(ds_t.real_annos), len(ds_t.pbr_annos)) == (8, 4)
    assert ds_t.mix_real == pytest.approx(0.8)
    assert ds_t.add_noise and ds_t.fill_depth
    assert ds_t.gt_match_th_m == ds_j.gt_match_th_m
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    picks = [(ds_t._pick_record(i % len(ds_t), rng_t).rgb_file,
              ds_j._pick_record(i % len(ds_j), rng_j).rgb_file)
             for i in range(200)]
    assert all(a == b for a, b in picks)
    types = set()
    for epoch in (0, 1):
        ds_t.set_epoch(epoch)
        ds_j.set_epoch(epoch)
        for i in range(len(ds_t)):
            _assert_items_agree(ds_t[i], ds_j[i], (epoch, i))
    for rec in ds_t.real_annos + ds_t.pbr_annos:
        types.add(rec.img_type)
        a = ds_t.get_item(rec, np.random.RandomState(7))
        b = ds_j.get_item([r for r in ds_j.annos
                           if r.rgb_file == rec.rgb_file][0],
                          rng=np.random.RandomState(7))
        assert (a is None) == (b is None)
        if a is not None:
            _assert_items_agree(a, b, rec.rgb_file)
    assert types == {"real", "synt", "pbr"}


@pytest.mark.parametrize("mode", ["test", "infer"])
def test_test_and_infer_items_match_jax(ycbv_root, mode):  # noqa: F811
    ds_t, ds_j = _datasets(ycbv_root, mode, MUG)
    assert len(ds_t) == len(ds_j) == 4
    for i in range(len(ds_t)):
        a, b = ds_t[i], ds_j[i]
        assert "labels" not in a
        _assert_items_agree(a, b, (mode, i))


def test_refusals_lifted_and_diameter_required(ycbv_root):  # noqa: F811
    _, cfg_t = _configs()
    with pytest.raises(ValueError, match="diameter"):
        PoseDataset(cfg_t, BOWL, "train", data_root=ycbv_root)
    ds = PoseDataset(dataclasses.replace(cfg_t, data=dataclasses.replace(
        cfg_t.data, fill_depth=False)), BOWL, "test", data_root=ycbv_root)
    assert "dpt_filled" not in ds[0]


def test_finalize_fill_depth_matches_jax():
    """finalize_batch(fill_depth=True): normals from the filled plane (hole
    pixels get unit normals), xyz from the raw counts, as in JAX
    (tests/test_ycbv_paths.py TestFinalizeFill)."""
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import finalize_batch as fin_j
    from gdm_tpu_torch.data.pipeline import finalize_batch, to_device

    S, N = 32, 64
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    dpt = np.full((S, S), 0.5, np.float32)
    dpt[10:14, 10:14] = 0.0
    raw = {
        "rgb_u8": np.zeros((1, S, S, 3), np.uint8),
        "dpt_u16": np.round(dpt * 10000).astype(np.uint16)[None],
        "dpt_scale": np.full((1,), 10000.0, np.float32),
        "dpt_filled": aug_t.fill_depth_fast(dpt)[None],
        "K_crop": K[None],
        "choose": (np.arange(N) + 10 * S + 8).astype(np.int32)[None],
    }
    hole = [i for i, c in enumerate(raw["choose"][0])
            if 10 <= c // S < 14 and 10 <= c % S < 14]
    assert hole
    for fill in (True, False):
        got = finalize_batch(to_device(raw, "cpu"), fill)["cld_rgb_nrm"]
        want = np.asarray(fin_j({k: jnp.asarray(v) for k, v in raw.items()},
                                fill_depth=fill)["cld_rgb_nrm"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        nrm = np.linalg.norm(got.numpy()[0, hole, 6:9], axis=1)
        assert (nrm > 0.9).all() if fill else (nrm < 1e-6).all()


def test_served_spec_and_meta_with_fill():
    from gdm_tpu.serve import raw_input_spec as spec_j
    from gdm_tpu_torch.serve import raw_input_spec

    want = {k: [list(v.shape), str(v.dtype)] for k, v in sorted(
        spec_j(8, 256, 4096, fill_depth=True).items())}
    assert raw_input_spec(8, 256, 4096, fill_depth=True) == want
    assert "dpt_filled" not in raw_input_spec(8, 256, 4096)


def test_synthetic_raw_fills_dpt_filled_like_jax():
    from gdm_tpu.serve import synthetic_raw as fill_j
    from gdm_tpu_torch import server as server_t
    from gdm_tpu_torch.serve import raw_input_spec

    spec = raw_input_spec(2, 16, 32, fill_depth=True)
    got, want = server_t.synthetic_raw(spec), fill_j(spec)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_same(got[k], want[k], k)


# -- the CLIs -----------------------------------------------------------------

BS = 3          # 4 test frames per object: a full batch, then a padded one
OBJ_NAMES = {BOWL: "024_bowl", MUG: "025_mug"}


class _Jitted:
    """A flax module whose ``apply`` is jitted (the keyword arguments
    closed over): the eager applies of the full model take tens of
    seconds on the CPU."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, **kw):
        import jax

        return jax.jit(lambda v, *a: self.model.apply(v, *a, **kw))(
            variables, *args)


@pytest.fixture(scope="module")
def cli_runs(ycbv_root, tmp_path_factory):  # noqa: F811
    """One shared checkpoint (a flax init whose heads fit well-posed
    poses, saved for both objects); the JAX CLI's and the port's ``eval``
    and ``infer`` of the bowl on it, the port's ``infer --stacked`` and
    per-object ``infer`` of both objects, and, in process, each package's
    fit of the bowl's four test frames from its own loader."""
    import jax
    import jax.numpy as jnp

    from _pytest.monkeypatch import MonkeyPatch

    from test_torch_cli import _spread_matches
    from test_torch_serve import _split_seg_bias
    import _torch_harness as H
    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base
    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import export_state_dict
    from gdm_tpu_torch import cli as cli_t
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.serve import PoseEngine

    cfg_j, cfg_t = _configs()
    mp = MonkeyPatch()
    mp.setitem(cfg_base._PRESETS, "ycbv", cfg_j)
    mp.setitem(configs._PRESETS, "ycbv", cfg_t)
    try:
        ds_t, ds_j = _datasets(ycbv_root, "test", BOWL)
        keys = ("rgb_u8", "dpt_u16", "dpt_scale", "dpt_filled", "K_crop",
                "choose", "det")
        batch_t, meta = collate([ds_t[i] for i in range(len(ds_t))])
        raw_t = {k: batch_t[k] for k in keys}
        raw_j = {k: np.stack([np.asarray(ds_j[i][k])
                              for i in range(len(ds_j))]) for k in keys}
        mesh_fps = load_or_build_fps_mesh(ycbv_root, BOWL, N_MESH)
        fps_mm = np.concatenate([mesh_fps[:, :3] * 1000.0, mesh_fps[:, 3:]],
                                axis=1)
        mesh = MeshArrays.from_graph(build_mesh_graph(fps_mm, N_MESH))
        fin = finalize_batch({k: jnp.asarray(v) for k, v in raw_j.items()},
                             fill_depth=True)
        inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"],
                                 fin["choose"], fin["xyz_img"], approx=False)
        model, variables = H.jax_model_and_variables(inputs, mesh)
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
        ckpt = str(tmp_path_factory.mktemp("ycbv_ckpt"))
        for name in OBJ_NAMES.values():
            os.makedirs(osp.join(ckpt, name))
            torch.save({"epoch": 0, "model_state": {
                k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}},
                osp.join(ckpt, name, "geomatch.pth.tar"))
        engine = PoseEngine(cfg_t, fps_mm, weights.read_reference_checkpoint(
            osp.join(ckpt, "024_bowl")), "cpu", batch=len(ds_t))
        assert engine.meta["fill_depth"] and "dpt_filled" in \
            engine.meta["raw_spec"]
        engine.run(raw_t)
        fit_t = {k: v.numpy() for k, v in engine.last_fit.items()}

        both = ["--dataset", "ycbv", "--data-root", ycbv_root,
                "--batch-size", str(BS), "--num-workers", "2",
                "--knn-chunk", "64", "--exact-knn", "--torch-checkpoint",
                ckpt]
        common = both + ["--cls-id", str(BOWL)]
        out = {"meta": meta, "fit_t": fit_t, "w": np.asarray(w),
               "idx": np.asarray(idx), "rgbd": np.asarray(out["rgbd"]),
               "mesh": np.asarray(out["mesh"]), "root": ycbv_root,
               "common": common}
        for pkg, cli, dev in (("j", cli_j, ["--devices", "1"]),
                              ("t", cli_t, ["--device", "cpu"])):
            d = str(tmp_path_factory.mktemp(f"yeval_{pkg}"))
            out[f"eval_{pkg}"] = cli.main(["eval", *common, *dev,
                                           "--output-dir", d])
            out[f"csv_{pkg}"] = osp.join(d, "gt_ycbv-test.csv")
            csv = str(tmp_path_factory.mktemp(f"yinf_{pkg}") / "i.csv")
            cli.main(["infer", *common, *dev, "--output", csv])
            out[f"infer_{pkg}"] = csv
        for mode in ("per", "stacked"):
            csv = str(tmp_path_factory.mktemp(f"y{mode}") / "i.csv")
            cli_t.main(["infer", *both, "--device", "cpu", "--output", csv,
                        *(["--stacked"] if mode == "stacked" else [])])
            out[mode] = csv
        yield out
    finally:
        mp.undo()


def _same_frames(r):
    """(scene, im) of the bowl's frames whose weighted correspondences
    are equal in both packages' in-process fits."""
    same = ((r["fit_t"]["idx"] == r["idx"]) | (r["w"] == 0)).all(1)
    return [tuple(int(v) for v in m["file_name"].split("/"))
            for i, m in enumerate(r["meta"]) if same[i]]


def test_cli_fits_agree_in_process(cli_runs):
    """Each package's own loader batch of the bowl: the same foreground
    and Kabsch weights, correspondences equal up to near-ties."""
    import _torch_harness as H

    r = cli_runs
    np.testing.assert_array_equal(r["fit_t"]["w"] > 0, r["w"] > 0)
    assert 0.2 < (r["w"] > 0).mean() < 0.8
    c = r["rgbd"].shape[-1]
    f = r["rgbd"] / np.linalg.norm(r["rgbd"], axis=-1, keepdims=True)
    mf = r["mesh"] / np.linalg.norm(r["mesh"], axis=-1, keepdims=True)
    sure = (H.top2_gap(f.reshape(-1, c), mf) > 1e-5).reshape(r["idx"].shape)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(r["fit_t"]["idx"][sure], r["idx"][sure])


@pytest.mark.parametrize("cmd", ["eval", "infer"])
def test_cli_csv_rows_match_jax(cli_runs, cmd):
    """The JAX CLI's rows; poses within 1e-4 on the frames whose weighted
    correspondences agree (one flipped near-tie can swing a Kabsch fit
    under random weights)."""
    from test_torch_cli import _read_csv

    r = cli_runs
    key = "csv" if cmd == "eval" else "infer"
    rows_j, keys_j = _read_csv(r[f"{key}_j"])
    rows_t, keys_t = _read_csv(r[f"{key}_t"])
    assert keys_t == keys_j and len(keys_t) == 4
    same = _same_frames(r)
    assert len(same) >= 2
    for s, im in same:
        (R_j, t_j), (R_t, t_t) = rows_j[(s, im, BOWL)], rows_t[(s, im, BOWL)]
        np.testing.assert_allclose(R_t, R_j, atol=1e-4)
        np.testing.assert_allclose(t_t, t_j, atol=1e-4)
    if cmd == "eval":
        assert len(r["eval_t"]["errors"]["024_bowl"]["ad"]) == 4
        assert [b["n"] for b in r["eval_t"]["timing"]] == [3, 1]


def test_cli_eval_vsd_errors_match_jax(cli_runs, tmp_path, monkeypatch):
    """cli eval --vsd --dataset ycbv of the bowl (its models_eval hull) on
    the CPU: the port's per-frame VSD errors equal the JAX package's
    vsd_err_batch on the same poses and test depths, which are the eval
    CSV's rows, the tree's GT poses and its depth PNGs."""
    import json

    from PIL import Image

    from test_torch_cli import _read_csv
    from gdm_tpu.eval.vsd import vsd_err_batch as vsd_err_batch_j
    from gdm_tpu_torch import cli as cli_t
    from gdm_tpu_torch.eval import vsd as vsd_t

    calls = []
    orig = vsd_t.vsd_err_batch

    def record(*args, **kw):
        out = orig(*args, **kw)
        # copies: the evaluator clears its lists after the call
        calls.append(([list(a) if isinstance(a, list) else a
                       for a in args], kw, out))
        return out

    monkeypatch.setattr(vsd_t, "vsd_err_batch", record)
    res = cli_t.main(["eval", *cli_runs["common"], "--device", "cpu",
                      "--vsd", "--output-dir", str(tmp_path)])
    errs = np.asarray(res["errors"][OBJ_NAMES[BOWL]]["vsd"])
    assert errs.shape == (4, 10) and len(calls) == 1
    (poses, depths, K, verts, faces, diameter), kw, out = calls[0]
    assert str(kw["device"]) == "cpu" and len(faces) > 0
    np.testing.assert_array_equal(out, errs)
    want = vsd_err_batch_j(poses, depths, K, verts, faces, diameter)
    np.testing.assert_array_equal(errs, want)
    assert 0 < errs.min() and errs.max() <= 1
    # the random-weight fits miss, so the same again with the GT poses as
    # the estimates, where the errors are small and spread over the taus
    at_gt = [(R_g, t_g, R_g, t_g) for _, _, R_g, t_g in poses]
    got = orig(at_gt, depths, K, verts, faces, diameter, device="cpu")
    np.testing.assert_array_equal(
        got, vsd_err_batch_j(at_gt, depths, K, verts, faces, diameter))
    assert got.max() < 0.5

    rows, keys = _read_csv(osp.join(str(tmp_path), "gt_ycbv-test.csv"))
    root = cli_runs["root"]
    for (scene, im, _), (R_e, t_e, R_g, t_g), depth in zip(keys, poses,
                                                          depths):
        np.testing.assert_array_equal(R_e, rows[(scene, im, BOWL)][0])
        np.testing.assert_allclose(t_e, rows[(scene, im, BOWL)][1],
                                   rtol=0, atol=1e-9)
        sdir = osp.join(root, "test", f"{scene:06d}")
        with open(osp.join(sdir, "scene_gt.json")) as f:
            gt = json.load(f)[str(im)][0]
        with open(osp.join(sdir, "scene_camera.json")) as f:
            cam = json.load(f)[str(im)]
        np.testing.assert_allclose(R_g, np.reshape(gt["cam_R_m2c"], (3, 3)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_g, np.asarray(gt["cam_t_m2c"]) / 1000.0,
                                   rtol=1e-7, atol=0)      # f32 metres
        png = np.asarray(Image.open(osp.join(sdir, f"depth/{im:06d}.png")))
        np.testing.assert_allclose(
            depth, png.astype(np.float32) * cam["depth_scale"] / 1000.0,
            rtol=1e-6, atol=0)


def test_cli_stacked_infer_equals_per_object(cli_runs):
    """infer --stacked over both objects (mixed batches) gives the
    per-object rows (tests/test_ycbv_e2e.py's stacked check)."""
    from test_torch_cli import _read_csv

    per, keys = _read_csv(cli_runs["per"])
    st, keys_s = _read_csv(cli_runs["stacked"])
    assert sorted(keys) == sorted(keys_s) and len(keys) == 8
    assert {k[2] for k in keys} == {BOWL, MUG}
    for k in keys:
        np.testing.assert_allclose(st[k][0], per[k][0], atol=1e-5)
        np.testing.assert_allclose(st[k][1], per[k][1], atol=1e-5)


def test_cli_train_checkpoint_loads_in_jax_eval(ycbv_root,  # noqa: F811
                                               tmp_path):
    """cli train --dataset ycbv (mix, noise, paste and fill; 1 epoch at
    b=2) writes a checkpoint that the JAX CLI's eval reads."""
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base
    from gdm_tpu_torch import cli as cli_t

    cfg_j, cfg_t = _configs()
    mp = MonkeyPatch()
    mp.setitem(cfg_base._PRESETS, "ycbv", cfg_j)
    mp.setitem(configs._PRESETS, "ycbv", cfg_t)
    try:
        res = cli_t.main([
            "train", "--dataset", "ycbv", "--data-root", ycbv_root,
            "--cls-id", str(BOWL), "--batch-size", "2", "--epochs", "1",
            "--ckpt-root", str(tmp_path), "--device", "cpu",
            "--num-workers", "2", "--knn-chunk", "64"])
        assert len(res["timing"]) == 6                  # 12 records / 2
        out = cli_j.main([
            "eval", "--dataset", "ycbv", "--data-root", ycbv_root,
            "--cls-id", str(BOWL), "--batch-size", str(BS), "--devices",
            "1", "--knn-chunk", "64", "--exact-knn", "--torch-checkpoint",
            osp.join(str(tmp_path), "checkpoints"), "--output-dir",
            str(tmp_path / "out")])
    finally:
        mp.undo()
    assert len(out["errors"]["024_bowl"]["ad"]) == 4
    rows = open(tmp_path / "out" / "gt_ycbv-test.csv").read().split("\n")
    assert len(rows) == 5


# -- the width repair ---------------------------------------------------------

@pytest.mark.parametrize("opt,err", [
    ("model.randla_d_out=16,32,64,128", ValueError),
    ("model.spline_kernel=3", ValueError),
    ("model.mesh_knn_k=6", ValueError),
    ("model.n_mesh_node=64", ValueError),
    ("model.backbone=pointnet", ValueError)])
@pytest.mark.parametrize("cmd", ["eval", "infer", "train"])
def test_cli_refuses_widths_the_reference_ignores(cmd, opt, err, tmp_path):
    from gdm_tpu_torch import cli as cli_t

    args = [cmd, "--dataset", "lmo", "--data-root", str(tmp_path),
            "--cls-id", "1", "--device", "cpu", "--opt", opt]
    if cmd != "train":
        args += ["--torch-checkpoint", str(tmp_path)]
    field = opt.split("=")[0]
    with pytest.raises(err, match=field):
        cli_t.main(args)


def test_model_config_keeps_the_reference_widths():
    from gdm_tpu_torch.cli import model_config

    cfg = model_config("lmo", ["model.backbone=randla_spline",
                                "model.n_mesh_node=4096"])
    assert cfg.model == configs.LMO.model
    with pytest.raises(ValueError, match="n_mesh_node"):
        model_config("lmo", ["data.model_pt_num=2048"])


def test_fill_engine_serves_through_both_services():
    """A PoseEngine of a filling config takes dpt_filled in its requests
    and plugs, unchanged, into the port's and the JAX package's
    PoseService (tests/test_torch_serve.py's HTTP round trip)."""
    import _torch_harness as H
    from test_torch_serve import _serve_and_compare, _tiny_config
    from gdm_tpu import server as server_j
    from gdm_tpu_torch import server as server_t
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch import GeoMatch
    from gdm_tpu_torch.serve import PoseEngine

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, fill_depth=True))
    model = GeoMatch()
    weights.init_random_(model, torch.Generator().manual_seed(0))
    engine = PoseEngine(cfg, H.mesh_fps(), model.state_dict(), "cpu",
                        batch=H.B)
    assert engine.meta["fill_depth"]
    raw = H.raw_request(seed=2)
    raw["dpt_filled"] = np.stack([aug_t.fill_depth_fast(d / 10000.0)
                                  for d in raw["dpt_u16"].astype(np.float32)])
    assert sorted(raw) == sorted(engine.meta["raw_spec"])
    for mod in (server_t, server_j):
        _serve_and_compare(engine, raw, mod)
    # the normals come from dpt_filled: the scene features move with it
    engine.run(raw)
    rgbd = engine.last_fit["rgbd"].clone()
    engine.run(dict(raw, dpt_filled=np.zeros_like(raw["dpt_filled"])))
    assert not torch.equal(engine.last_fit["rgbd"], rgbd)

"""The port's cv2-free pose overlays (gdm_tpu_torch/utils/viz.py) and
``--save-viz`` against the JAX package's (gdm_tpu/utils/viz.py: cv2's
circle and polylines, PNGs through PIL).

Every image is compared bit for bit: tests/test_viz.py's cases, filled
circles of several radii at and beyond the edges, and 400 seeded random
poses whose box corners fall off the crop (and behind the camera), where
cv2's ``clipLine`` decides the pixels.  ``cli eval`` and ``cli infer``
with ``--save-viz`` write JAX's file names (``_save_viz`` of the JAX CLI
called with the same arguments), and every PNG decodes (PIL) to the
array JAX writes."""

import os
import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

import test_data
from test_data import bop_root  # noqa: F401
from test_torch_dataset import port_config
from gdm_tpu.utils import viz as viz_j
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.data.imio import imread_rgb
from gdm_tpu_torch.models.geomatch import GeoMatch
from gdm_tpu_torch.utils import viz as viz_t

torch.set_num_threads(1)


def _K(f=100.0, c=32.0):
    return np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]], np.float32)


def _same(fn, *args, **kw):
    a = getattr(viz_t, fn)(*args, **kw)
    b = getattr(viz_j, fn)(*args, **kw)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b, err_msg=fn)
    return a


def _noise(h=64, w=64, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("case", [
    "project", "z_guard", "draw_points", "paste", "paste_colors",
    "label", "pose", "pose_no_box", "box"])
def test_viz_cases_match_jax(case):
    """tests/test_viz.py's cases, each on both packages."""
    img = np.zeros((64, 64, 3), np.uint8)
    p2ds = np.array([[10, 20], [63, 63], [-5, 70]])
    model = (np.random.RandomState(0).rand(50, 3).astype(np.float32)
             - 0.5) * 0.1
    if case == "project":
        pts = np.array([[0, 0, 1.0], [0.1, 0, 1.0], [0, -0.05, 0.5]])
        _same("project_p3d", pts, _K())
        _same("project_p3d", pts, _K(), 1000.0)
    elif case == "z_guard":
        _same("project_p3d", np.array([[2.0, 3.0, 0.0]]), _K())
    elif case == "draw_points":
        out = _same("draw_points", img, p2ds, r=1, color=(255, 0, 0))
        assert img.sum() == 0 and tuple(out[20, 10]) == (255, 0, 0)
    elif case == "paste":
        _same("paste_points", img, p2ds, color=(0, 128, 0))
    elif case == "paste_colors":
        _same("paste_points", img, p2ds[:2], color=[(1, 2, 3), (4, 5, 6)])
    elif case == "label":
        _same("draw_points_label", np.zeros((32, 32, 3), np.uint8),
              np.array([[5, 5], [10, 10]]), np.array([1, 2]), r=0)
    elif case in ("pose", "pose_no_box"):
        _same("draw_pose", img, model, np.eye(3), np.array([0, 0, 1.0]),
              _K(), color=(0, 255, 0), bbox=case == "pose")
    else:
        c = viz_t.box_corners(np.array([[0, 0, 0], [1, 2, 3.0]], np.float32))
        np.testing.assert_array_equal(c, viz_j.box_corners(
            np.array([[0, 0, 0], [1, 2, 3.0]], np.float32)))
        _same("draw_bbox_3d", img, viz_j.project_p3d(c + [0, 0, 2], _K()))


@pytest.mark.parametrize("r", [0, 1, 2, 3, 5, 8])
def test_filled_circles_match_cv2(r):
    """Circles inside, across each edge and at the corners, with one
    colour per point (later points overwrite earlier ones)."""
    rng = np.random.RandomState(r)
    p2ds = np.concatenate([rng.randint(-4, 68, (60, 2)),
                           [[0, 0], [63, 0], [0, 63], [63, 63], [2, 31]]])
    colors = [tuple(int(v) for v in c)
              for c in rng.randint(0, 256, (len(p2ds), 3))]
    _same("draw_points", _noise(64, 48, r), p2ds, r=r, color=colors)
    _same("draw_points_label", _noise(48, 64, r), p2ds,
          rng.randint(0, 30, len(p2ds)), r=r)


def test_random_poses_with_corners_off_the_crop():
    """400 seeded poses of a box around a random cloud, many of whose
    corners land off the 64^2 crop, some far off (the object grazing or
    behind the image plane), drawn by draw_pose and the wireframe
    alone."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(7)
    img = _noise()
    pts = (rng.rand(300, 3) - 0.5) * np.array([0.2, 0.1, 0.15])
    n_off = 0
    for i in range(400):
        R = Rotation.random(random_state=rng).as_matrix()
        t = rng.uniform([-0.3, -0.3, -0.05], [0.3, 0.3, 0.9])
        if i % 10 == 0:
            t[2] = rng.uniform(1e-4, 0.02)      # corners thousands off
        K = _K(rng.uniform(60, 400), rng.uniform(20, 44))
        _same("draw_pose", img, pts, R, t, K, color=(0, 255, 80))
        corners = viz_j.project_p3d(viz_j.box_corners(pts) @ R.T + t, K)
        _same("draw_bbox_3d", img, corners, color=(60, 120, 255))
        n_off += bool(((corners < 0) | (corners > 63)).any())
    assert n_off > 150
    far = np.array([[-100000, 5], [70000, 40], [30, -2 ** 31],
                    [-2 ** 31, -2 ** 31], [2 ** 31 - 1, 10], [5, 5],
                    [63, -1], [64, 64]], np.int32)
    _same("draw_bbox_3d", img, far)


def test_save_viz_names_and_inst_suffix(tmp_path):
    """Both CLIs' ``_save_viz`` on the same arguments: the same file
    names (a second detection of a frame gets ``_1``) and pixels."""
    from gdm_tpu import cli as cli_j

    rng = np.random.RandomState(3)
    pts = (rng.rand(3000, 3) - 0.5) * 0.1       # > max_pts: subsampled
    pose = np.hstack([np.eye(3), [[0.0], [0.0], [0.5]]])
    gt = np.hstack([np.eye(3), [[0.01], [0.0], [0.5]]]).astype(np.float32)
    for inst in (0, 1):
        for fn, d in ((cli_t._save_viz, "t"), (cli_j._save_viz, "j")):
            fn(str(tmp_path / d), "ape", "000002/000007", _noise(), _K(),
               pts, pose, gt, inst=inst)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["ape_000002_000007.png", "ape_000002_000007_1.png"]
    assert sorted(os.listdir(tmp_path / "t")) == names
    for n in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "t" / n)),
            np.asarray(Image.open(tmp_path / "j" / n)))


@pytest.fixture(scope="module")
def viz_runs(bop_root, tmp_path_factory):  # noqa: F811
    """``cli eval`` and ``cli infer`` with --save-viz on the mini tree
    (seeded random weights, --device cpu); each ``_save_viz`` call also
    goes to the JAX CLI's ``_save_viz`` with the same arguments."""
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j

    mp = MonkeyPatch()
    mp.setitem(configs._PRESETS, "lmo",
               port_config(test_data._mini_config()))
    calls = []
    save = cli_t._save_viz

    def both(viz_dir, *args, **kw):
        calls.append((viz_dir, args, kw))
        save(viz_dir, *args, **kw)
        cli_j._save_viz(viz_dir + "_jax", *args, **kw)

    mp.setattr(cli_t, "_save_viz", both)
    try:
        model = GeoMatch()
        weights.init_random_(model, torch.Generator().manual_seed(0))
        ckpt = str(tmp_path_factory.mktemp("viz_ckpt"))
        os.makedirs(osp.join(ckpt, "ape"))
        torch.save({"model_state": model.state_dict()},
                   osp.join(ckpt, "ape", "geomatch.pth.tar"))
        out = tmp_path_factory.mktemp("viz")
        common = ["--dataset", "lmo", "--data-root", bop_root,
                  "--torch-checkpoint", ckpt, "--cls-id", "1",
                  "--batch-size", "3", "--knn-chunk", "64",
                  "--num-workers", "2", "--device", "cpu"]
        runs = {}
        for cmd, extra in (("eval", ["--output-dir", str(out / "ev")]),
                           ("infer", ["--output", str(out / "inf.csv")])):
            n = len(calls)
            cli_t.main([cmd, *common, *extra, "--save-viz",
                        str(out / cmd)])
            runs[cmd] = calls[n:]
        yield out, runs
    finally:
        mp.undo()


@pytest.mark.parametrize("cmd", ["eval", "infer"])
def test_cli_save_viz_matches_jax(viz_runs, cmd):
    out, runs = viz_runs
    calls = runs[cmd]
    assert len(calls) == 4
    names = sorted(os.listdir(out / cmd))
    assert names == sorted(os.listdir(out / f"{cmd}_jax"))
    assert names == [f"ape_000000_{i:06d}.png" for i in range(4)]
    for viz_dir, args, kw in calls:
        obj, file_name, rgb, K, pts, pose = args[:6]
        gt = args[6] if len(args) > 6 else None
        assert (gt is not None) == (cmd == "eval") and len(pts) <= 2048
        want = np.ascontiguousarray(rgb)
        if gt is not None:
            want = viz_t.draw_pose(want, pts, gt[:, :3], gt[:, 3], K,
                                   color=(60, 120, 255))
        want = viz_t.draw_pose(want, pts, pose[:, :3], pose[:, 3], K,
                               color=(0, 255, 80))
        name = f"{obj}_{file_name.replace('/', '_')}.png"
        got = np.asarray(Image.open(out / cmd / name))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(out / f"{cmd}_jax" / name)))
        np.testing.assert_array_equal(imread_rgb(str(out / cmd / name)), got)

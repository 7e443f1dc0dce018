"""The port's training data against the JAX package's, bit for bit: the
radius NN (csrc/radius_nn.cpp vs gdm_tpu.native), HPR visibility,
pose_gt_info (labels, match_idx, visible_flag), the symmetric mesh
graph's sym_idx, train-mode PoseDataset items on the mini BOP tree of
tests/test_data.py (its train_pbr frames are PIL JPEGs) and the loader's
shuffled, sharded epoch order."""

import numpy as np
import pytest

import test_data
from test_data import bop_root  # noqa: F401
from test_torch_dataset import _assert_same, port_config
from gdm_tpu_torch.data import gt_gen
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import DataLoader
from gdm_tpu_torch.ops import visibility

GT_KEYS = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose", "labels",
           "origin_labels", "match_idx", "visible_flag", "RT", "K")


@pytest.mark.parametrize("radius", [0.002, 0.01, 0.05])
def test_radius_nn_matches_native(radius):
    from gdm_tpu import native

    rng = np.random.RandomState(int(radius * 1e4))
    support = (rng.randn(2000, 3) * 0.04).astype(np.float32)
    query = (rng.randn(3000, 3) * 0.05).astype(np.float32)
    query[:50] = support[:50]                       # exact hits
    got = gt_gen.radius_nn(support, query, radius)
    want = native.radius_nn(support, query, radius)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()
    with pytest.raises(ValueError, match="empty support"):
        gt_gen.radius_nn(support[:0], query, radius)


def _pose(rng, z=0.5):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(random_state=rng).as_matrix()
    return np.hstack([R, [[0.01], [-0.02], [z]]]).astype(np.float32)


@pytest.mark.parametrize("radius_param", [2.0, np.pi])
def test_visibility_equal(radius_param):
    from gdm_tpu.data.gt_gen import pose_visibility as vis_j
    from gdm_tpu.ops import visibility as visibility_j

    rng = np.random.RandomState(1)
    pts = test_data.make_object(400, rng, radius=0.05)[:, :3] / 1000.0
    cam = np.array([0.1, -0.3, 0.6])
    _assert_same(visibility.visible_points(pts, cam, radius_param),
                 visibility_j.visible_points(pts, cam, radius_param))
    pose = _pose(rng)
    _assert_same(gt_gen.pose_visibility(pose, pts, radius_param),
                 vis_j(pose, pts, radius_param))


@pytest.mark.parametrize("case", ["normal", "empty_fg", "no_match",
                                  "precomputed"])
def test_pose_gt_info_equal(case):
    from gdm_tpu.data.gt_gen import pose_gt_info as info_j

    rng = np.random.RandomState(2)
    mesh = test_data.make_object(300, rng, radius=0.05)[:, :3] / 1000.0
    pose = _pose(rng)
    cam = mesh @ pose[:, :3].T + pose[:, 3]
    cld = np.concatenate([cam[rng.randint(0, 300, 200)]
                          + rng.randn(200, 3) * 0.003,
                          rng.randn(56, 3) * 0.2 + [0, 0, 0.5]])
    cld = cld.astype(np.float32)
    labels = np.r_[np.ones(200), np.zeros(56)].astype(np.uint8)
    if case == "empty_fg":
        labels[:] = 0
    if case == "no_match":
        cld[:200] += 1.0
    vis = gt_gen.pose_visibility(pose, mesh) if case == "precomputed" \
        else None
    got = gt_gen.pose_gt_info(cld, labels, pose, mesh, 0.01, vis)
    want = info_j(cld, labels, pose, mesh, 0.01, vis)
    for a, b in zip(got[:3], want[:3]):
        _assert_same(a, b, case)
    assert got[3] == want[3] == (case in ("normal", "precomputed"))


def test_mesh_graph_sym_idx_equal():
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j
    from gdm_tpu_torch.models.spline_mesh import build_mesh_graph

    fps = test_data.make_object(128, np.random.RandomState(5), radius=0.05)
    sym = (np.diag([-1.0, -1.0, 1.0]), np.array([0.0, 0.0, 2.0]))
    a, b = build_mesh_graph(fps, 128, sym_transform=sym), build_j(
        fps, 128, sym_transform=sym)
    assert a.sym_idx is not None and a.sym_idx.dtype == np.int32
    _assert_same(a.sym_idx, b.sym_idx)
    assert build_mesh_graph(fps, 128).sym_idx is None


def _train_sets(root, seed=3):
    from gdm_tpu.data.dataset import PoseDataset as PoseDatasetJ

    cfg_j = test_data._mini_config()
    ds_t = PoseDataset(port_config(cfg_j), 1, "train", data_root=root,
                       rng=np.random.RandomState(seed))
    ds_j = PoseDatasetJ(cfg_j, 1, "train", diameter_m=0.1, data_root=root,
                        rng=np.random.RandomState(seed))
    return ds_t, ds_j


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_items_equal(bop_root, epoch):  # noqa: F811
    ds_t, ds_j = _train_sets(bop_root)
    assert len(ds_t) == len(ds_j) == 4
    ds_t.set_epoch(epoch)
    ds_j.set_epoch(epoch)
    for i in range(len(ds_j)):
        a, b = ds_t[i], ds_j[i]
        assert set(a) == set(GT_KEYS)
        for k in GT_KEYS:
            _assert_same(a[k], b[k], (epoch, i, k))
        assert a["labels"].sum() >= 3 and (a["match_idx"] < 128).any()
    again = ds_t[0]                                 # cached hull: same
    for k in GT_KEYS:
        _assert_same(again[k], ds_j[0][k], k)


def test_train_sample_rejection_redraws_like_jax(bop_root):  # noqa: F811
    """A sample with too few valid pixels is redrawn from the same rng:
    make index 0's depth empty and both packages pick the same stand-in."""
    import os.path as osp
    import shutil

    from PIL import Image

    ds_t, ds_j = _train_sets(bop_root, seed=9)
    root2 = osp.join(osp.dirname(bop_root), "mini_bop_holes")
    if not osp.exists(root2):
        shutil.copytree(bop_root, root2)
        dpt = osp.join(root2, "train_pbr", "000000", "depth", "000000.png")
        Image.fromarray(np.zeros((test_data.IM_H, test_data.IM_W),
                                 np.uint16)).save(dpt)
    ds_t, ds_j = _train_sets(root2, seed=9)
    a, b = ds_t[0], ds_j[0]
    for k in GT_KEYS:
        _assert_same(a[k], b[k], k)
    assert a["dpt_u16"].any()


@pytest.mark.parametrize("world", [1, 2])
def test_loader_epoch_order_equal(bop_root, world):  # noqa: F811
    from gdm_tpu.data.loader import DataLoader as DataLoaderJ

    ds_t, ds_j = _train_sets(bop_root)
    for rank in range(world):
        for epoch in (0, 1, 5):
            lt = DataLoader(ds_t, 1, shuffle=True, drop_last=True, seed=11,
                            rank=rank, world=world)
            lj = DataLoaderJ(ds_j, 1, shuffle=True, drop_last=True,
                             seed=11, rank=rank, world=world)
            lt.set_epoch(epoch)
            lj.set_epoch(epoch)
            _assert_same(lt.epoch_indices(), lj._epoch_indices())
            assert len(lt) == len(lj)
    lt = DataLoader(ds_t, 3, shuffle=True, drop_last=True, seed=11)
    assert len(lt) == 1 and len(DataLoader(ds_t, 3, drop_last=False)) == 2


def test_train_batches_equal_across_worker_kinds(bop_root):  # noqa: F811
    """Thread and (spawned) process workers give the JAX loader's train
    batches, bit for bit."""
    from gdm_tpu.data.loader import DataLoader as DataLoaderJ

    ds_t, ds_j = _train_sets(bop_root)
    lj = DataLoaderJ(ds_j, 2, shuffle=True, drop_last=True, seed=4,
                     num_workers=2)
    lj.set_epoch(1)
    want = [b for b, _ in lj]
    for kind in ("thread", "process"):
        lt = DataLoader(ds_t, 2, shuffle=True, drop_last=True, seed=4,
                        num_workers=2, workers=kind)
        lt.set_epoch(1)
        got = [b for b, _ in lt]
        assert len(got) == len(want) == 2
        for ba, bb in zip(got, want):
            for k in GT_KEYS:
                _assert_same(ba[k], bb[k], (kind, k))

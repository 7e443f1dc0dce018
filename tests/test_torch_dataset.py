"""The port's BOP loader against the JAX package's, on the mini BOP tree
of tests/test_data.py (120x160 frames, 64^2 crop, 256 points, 128-vertex
mesh): configs and refdata copies, the annotation index, every key of
PoseDataset items in test and infer mode (``choose`` and the crops
bit-equal), DataLoader batches with the padded tail, the fps mesh
loaders and the synthetic BOP writer."""

import dataclasses
import json
import os
import os.path as osp

import numpy as np
import pytest

import test_data
from test_data import IM_H, IM_W, IN_SIZE, N_MESH, bop_root  # noqa: F401
from gdm_tpu_torch import configs
from gdm_tpu_torch.data import bop as bop_t
from gdm_tpu_torch.data import ply as ply_t
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import DataLoader, collate, pad_batch

PORT_KEYS = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose", "RT",
             "K", "cls_id", "det", "file_name")


def port_config(cfg_j):
    """The port's Config holding the JAX config's values (every field the
    port has)."""
    parts = {}
    for part in ("data", "model", "solver"):
        cls = type(getattr(configs.LMO, part))
        sub = getattr(cfg_j, part)
        parts[part] = cls(**{f.name: getattr(sub, f.name)
                             for f in dataclasses.fields(cls)})
    return configs.Config(**parts)


def _assert_same(got, want, msg=""):
    if isinstance(want, (str, int, float)) or np.ndim(want) == 0:
        assert got == want, msg
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=str(msg))


@pytest.mark.parametrize("name", ["lmo", "lmfull", "ycbv"])
def test_presets_match_jax(name):
    from gdm_tpu.configs.base import get_config

    want, got = get_config(name), configs.get_config(name)
    for part in ("data", "model", "solver"):
        for f in dataclasses.fields(getattr(got, part)):
            _assert_same(getattr(getattr(got, part), f.name),
                         getattr(getattr(want, part), f.name),
                         (name, part, f.name))


def test_opt_overrides_parse_like_jax():
    from gdm_tpu.configs.base import get_config

    opts = ["solver.val_batch_size=16", "data.fill_depth=yes",
            "model.randla_d_out=16,32,64,128", "data.sym_objs=ape,can",
            "data.nn_dist_th=0.25", "data.obj_ids="]
    want, got = get_config("lmo", opts), configs.get_config("lmo", opts)
    for part, field in (("solver", "val_batch_size"), ("data", "fill_depth"),
                        ("model", "randla_d_out"), ("data", "sym_objs"),
                        ("data", "nn_dist_th"), ("data", "obj_ids")):
        assert getattr(getattr(got, part), field) == \
            getattr(getattr(want, part), field), field
    for bad, err in (("model.no_such_field=1", AttributeError),
                     ("not_an_assignment", ValueError),
                     ("data.fill_depth=Ture", ValueError)):
        with pytest.raises(err):
            configs.get_config("lmo", [bad])
    assert configs.get_config("lmo").solver.val_batch_size == 128


@pytest.mark.parametrize("name", ["lmo", "lm_full", "ycbv"])
def test_refdata_copy_equal(name, tmp_path):
    from gdm_tpu import refdata as ref_j
    from gdm_tpu.refdata import _base as base_j
    from gdm_tpu_torch import refdata as ref_t
    from gdm_tpu_torch.refdata import _base as base_t

    mj, mt = ref_j.get(name), ref_t.get(name)
    for attr in ("name", "objects", "id2obj", "obj2id", "diameters",
                 "diameters_mm_by_id", "width", "height", "camera_matrix",
                 "vertex_scale"):
        a, b = getattr(mt, attr), getattr(mj, attr)
        if isinstance(b, np.ndarray):
            _assert_same(a, b, attr)
        else:
            assert a == b, attr
    for fn in ("dataset_root", "model_dir", "model_eval_dir", "kps_dir"):
        assert getattr(mt, fn)("/data") == getattr(mj, fn)("/data")
    infos = [
        {"symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 5,
                                  0, 0, 0, 1]]},
        {"symmetries_continuous": [{"axis": [0, 0, 1],
                                    "offset": [0, 1, 2]}]},
        {"symmetries_discrete": [[1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0,
                                  0, 0, 0, 1]],
         "symmetries_continuous": [{"axis": [0, 1, 0]}]},
        {},
    ]
    for info in infos:
        a, b = base_t.symmetry_transform(info), base_j.symmetry_transform(info)
        assert (a is None) == (b is None)
        if a is not None:
            _assert_same(a[0], b[0])
            _assert_same(a[1], b[1])
        for step in (0.01, 0.5):
            ta = base_t.all_symmetry_transforms(info, step)
            tb = base_j.all_symmetry_transforms(info, step)
            assert len(ta) == len(tb)
            for (ra, sa), (rb, sb) in zip(ta, tb):
                _assert_same(ra, rb)
                _assert_same(sa, sb)
            _assert_same(base_t.all_symmetry_rotations(info, step),
                         base_j.all_symmetry_rotations(info, step))
    os.makedirs(tmp_path / "models")
    (tmp_path / "models" / "models_info.json").write_text(
        json.dumps({"1": infos[0]}))
    assert mt.load_models_info(str(tmp_path / "models")) == \
        mj.load_models_info(str(tmp_path / "models"))


def _records_equal(ra, rb):
    assert len(ra) == len(rb) > 0
    for a, b in zip(ra, rb):
        for f in dataclasses.fields(b):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f.name)


def test_index_records_equal(bop_root):  # noqa: F811
    from gdm_tpu.data import bop as bop_j

    dets_j = bop_j.load_detections(osp.join(bop_root, "test",
                                            "real_det.json"))
    dets_t = bop_t.load_detections(osp.join(bop_root, "test",
                                            "real_det.json"))
    assert dets_t == dets_j
    kw = dict(im_hw=(IM_H, IM_W))
    ra, sa = bop_t.build_index(bop_root, "test", (1,), "test",
                               detections=dets_t, **kw)
    rb, sb = bop_j.build_index(bop_root, "test", (1,), "test",
                               detections=dets_j, **kw)
    _records_equal(ra, rb)
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb)
    ra, sa = bop_t.build_index_infer(bop_root, "test", (1,),
                                     detections=dets_t, selected_id=1, **kw)
    rb, sb = bop_j.build_index_infer(bop_root, "test", (1,),
                                     detections=dets_j, selected_id=1, **kw)
    _records_equal(ra, rb)
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb)
    for rng_seed in (0, 1):
        ca = bop_t.aug_bbox_dzi((10, 20, 50, 81), np.random.RandomState(
            rng_seed), test=True)
        cb = bop_j.aug_bbox_dzi((10, 20, 50, 81), np.random.RandomState(
            rng_seed), test=True)
        _assert_same(ca[0], cb[0])
        assert ca[1] == cb[1]


@pytest.fixture(scope="module")
def det_file(bop_root, tmp_path_factory):  # noqa: F811
    """The mini tree's detections without frame 2's (a missed detection:
    det = 0, the crop falls back to the GT box)."""
    with open(osp.join(bop_root, "test", "real_det.json")) as f:
        dets = json.load(f)
    del dets["0/2"]
    path = str(tmp_path_factory.mktemp("dets") / "dets.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    return path


@pytest.mark.parametrize("mode,custom_dets", [
    ("test", False), ("test", True), ("infer", False)])
def test_dataset_items_equal(bop_root, det_file, mode,  # noqa: F811
                             custom_dets):
    from gdm_tpu.data.dataset import PoseDataset as PoseDatasetJ

    cfg_j = test_data._mini_config()
    dets = det_file if custom_dets else None
    ds_t = PoseDataset(port_config(cfg_j), 1, mode, data_root=bop_root,
                       detections_file=dets)
    ds_j = PoseDatasetJ(cfg_j, 1, mode, diameter_m=0.1, data_root=bop_root,
                        detections_file=dets)
    _records_equal(ds_t.annos, ds_j.annos)
    dets_seen = set()
    for i in range(len(ds_j)):
        a, b = ds_t[i], ds_j[i]
        assert set(a) == set(PORT_KEYS)
        for k in PORT_KEYS:
            _assert_same(a[k], b[k], (mode, i, k))
        dets_seen.add(int(a["det"]))
    assert dets_seen == ({0, 1} if custom_dets else {1})


def test_dataset_refuses_unported_modes(bop_root):  # noqa: F811
    """An unknown mode raises; the YCB-V options, once refused, now give
    the JAX package's items on the LM mini tree (a ycbv-named train set
    with the real/pbr mix, and the depth fill in test mode): counts,
    points and GT bit-equal, the filled plane within the bilateral
    filter's bound (tests/test_torch_ycbv.py)."""
    from gdm_tpu.data.dataset import PoseDataset as PoseDatasetJ
    from test_torch_ycbv import BILATERAL_TOL

    cfg_j = test_data._mini_config()
    cfg = port_config(cfg_j)
    with pytest.raises(ValueError, match="mode"):
        PoseDataset(cfg, 1, "val", data_root=bop_root)
    for mode, data in (
            ("train", dict(name="ycbv", real_pbr_mix=0.8, fill_depth=True)),
            ("test", dict(fill_depth=True))):
        cj = dataclasses.replace(cfg_j, data=dataclasses.replace(
            cfg_j.data, **data))
        ds_t = PoseDataset(port_config(cj), 1, mode, data_root=bop_root,
                           rng=np.random.RandomState(0), diameter_m=0.1)
        ds_j = PoseDatasetJ(cj, 1, mode, diameter_m=0.1, data_root=bop_root,
                            rng=np.random.RandomState(0))
        for i in range(len(ds_t)):
            a, b = ds_t[i], ds_j[i]
            assert "dpt_filled" in a and set(a) <= set(b)
            for k in a:
                if k == "dpt_filled":
                    assert np.abs(a[k] - b[k]).max() <= BILATERAL_TOL
                else:
                    _assert_same(a[k], b[k], (mode, i, k))


@pytest.mark.parametrize("bs", [3, 4])
def test_loader_batches_and_padded_tail_equal(bop_root, bs):  # noqa: F811
    from gdm_tpu.cli import _pad_batch
    from gdm_tpu.data.dataset import PoseDataset as PoseDatasetJ
    from gdm_tpu.data.loader import DataLoader as DataLoaderJ

    cfg_j = test_data._mini_config()
    ds_t = PoseDataset(port_config(cfg_j), 1, "test", data_root=bop_root)
    ds_j = PoseDatasetJ(cfg_j, 1, "test", diameter_m=0.1,
                        data_root=bop_root)
    got = list(DataLoader(ds_t, bs, num_workers=3))
    want = list(DataLoaderJ(ds_j, bs, shuffle=False, drop_last=False,
                            num_workers=3))
    assert len(got) == len(want) == len(DataLoader(ds_t, bs)) == -(-4 // bs)
    for (ba, ma), (bb, mb) in zip(got, want):
        assert ma == [{"file_name": m["file_name"]} for m in mb]
        for k in ba:
            _assert_same(ba[k], bb[k], k)
            _assert_same(pad_batch(ba, bs)[k], _pad_batch(bb, bs)[k], k)
        assert pad_batch(ba, bs)["rgb_u8"].shape[0] == bs
    one = collate([ds_t[0]])
    assert one[1] == [{"file_name": ds_t[0]["file_name"]}]


def test_loader_surfaces_worker_errors():
    class Broken:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            if i == 3:
                raise KeyError("sample 3")
            return {"x": np.full(2, i)}

    it = iter(DataLoader(Broken(), 2, num_workers=2))
    assert next(it)[0]["x"].shape == (2, 2)
    with pytest.raises(KeyError, match="sample 3"):
        list(it)


def test_fps_mesh_loaders_equal(bop_root, tmp_path):  # noqa: F811
    from gdm_tpu.data import ply as ply_j
    from gdm_tpu.data.synthetic import make_trefoil_mesh

    _assert_same(ply_t.load_or_build_fps_mesh(bop_root, 1, N_MESH),
                 ply_j.load_or_build_fps_mesh(bop_root, 1, N_MESH))
    _assert_same(ply_t.find_kps_mesh(bop_root, 1, 64),
                 ply_j.find_kps_mesh(bop_root, 1, 64))
    with pytest.raises(FileNotFoundError):
        ply_t.find_kps_mesh(str(tmp_path), 1, 64)
    # no kps: farthest-point sampling of the PLY, normals estimated from
    # the 16-NN (hull faces are not consistently wound) or from the faces
    # (the trefoil is)
    hull = str(tmp_path / "hull")
    os.makedirs(osp.join(hull, "models_eval"))
    src = osp.join(bop_root, "models_eval", "obj_000001.ply")
    with open(src, "rb") as f, open(
            osp.join(hull, "models_eval", "obj_000001.ply"), "wb") as g:
        g.write(f.read())
    knot = str(tmp_path / "knot")
    os.makedirs(osp.join(knot, "models"))
    verts, faces = make_trefoil_mesh(n_u=40, n_v=12)
    ply_t.write_ply(osp.join(knot, "models", "obj_000002.ply"),
                    verts * 1000.0, faces=faces)
    for root, oid, n in ((hull, 1, 64), (knot, 2, 200)):
        _assert_same(ply_t.load_or_build_fps_mesh(root, oid, n),
                     ply_j.load_or_build_fps_mesh(root, oid, n), root)
    pj = ply_j.load_ply(osp.join(knot, "models", "obj_000002.ply"))
    pt = ply_t.load_ply(osp.join(knot, "models", "obj_000002.ply"))
    assert sorted(pt) == sorted(pj)
    _assert_same(pt["pts"], pj["pts"])
    assert pt["faces"] == pj["faces"]


def test_synthetic_bop_root_decodes_like_jax(tmp_path):
    from gdm_tpu.data import synthetic as syn_j
    from gdm_tpu.data.imio import imread_mask, imread_rgb, imread_u16
    from gdm_tpu_torch.data import imio
    from gdm_tpu_torch.data import synthetic as syn_t

    mesh = syn_t.make_object(96, np.random.RandomState(4), radius=0.05)
    _assert_same(mesh, syn_j.make_object(96, np.random.RandomState(4),
                                         radius=0.05))
    kw = dict(n_frames=3, subsets=("test",), im_hw=(60, 80), seed=2,
              render_mult=4, eval_meshes=True)
    ra = syn_t.write_synthetic_bop_root(str(tmp_path / "t"), mesh, **kw)
    rb = syn_j.write_synthetic_bop_root(str(tmp_path / "j"), mesh, **kw)
    files = sorted(osp.relpath(osp.join(d, f), rb)
                   for d, _, fs in os.walk(rb) for f in fs)
    assert files == sorted(osp.relpath(osp.join(d, f), ra)
                           for d, _, fs in os.walk(ra) for f in fs)
    for rel in files:
        a, b = osp.join(ra, rel), osp.join(rb, rel)
        if "/rgb/" in rel:
            _assert_same(imio.imread_rgb(a), imread_rgb(b), rel)
        elif "/depth/" in rel:
            _assert_same(imio.imread_u16(a), imread_u16(b), rel)
        elif "/mask_visib/" in rel:
            _assert_same(imio.imread_mask(a), imread_mask(b), rel)
        elif rel.endswith(".npy"):
            _assert_same(np.load(a), np.load(b), rel)
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), rel
    # train_pbr: JPEG frames from the two encoders; the other files equal
    kw["subsets"] = ("train_pbr",)
    ra = syn_t.write_synthetic_bop_root(str(tmp_path / "pt"), mesh, **kw)
    rb = syn_j.write_synthetic_bop_root(str(tmp_path / "pj"), mesh, **kw)
    jpgs = [f for f in files if "/rgb/" in f]
    assert jpgs
    for rel in jpgs:
        rel = rel.replace("test/", "train_pbr/").replace(".png", ".jpg")
        a, b = imio.imread_rgb(osp.join(ra, rel)), imread_rgb(
            osp.join(rb, rel))
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b).mean() < 3.0, rel
        rel = rel.replace("/rgb/", "/depth/").replace(".jpg", ".png")
        _assert_same(imio.imread_u16(osp.join(ra, rel)),
                     imread_u16(osp.join(rb, rel)), rel)

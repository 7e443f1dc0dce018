"""The LM-full preset on the port against the JAX package, on the CPU, and
JAX's default (approximate) KNN mode against the port's exact one.

A mini LM-full preset (``mini_configs``) keeps LM-full's own fields: the
name ``lm_full``, the train subsets ``real``, ``fuse`` and ``renders``,
``nn_dist_th`` 0.01, eggbox's symmetry, train b=6 and val b=8.  It cuts
the scale to a 64^2 crop, 3072 points (0.75 of the crop's pixels, near
LM-full's 12800 of 128^2 = 0.78, and a multiple of 256, so that the
pyramid's n // 256 level holds) and a 128-vertex mesh.  Its tree
(``build_mini_root``: data/synthetic.write_synthetic_lmfull_root, object
10 = eggbox, 120x160 frames) holds ``test`` frames at depth_scale 0.1 and
``real``, ``fuse`` and ``renders`` frames in millimetres: the loaders
divide those subsets' depth by 1000 (data/bop._img_type), so a tree
written at 0.1 mm counts would be read 10x too deep.  ``real`` and
``fuse`` frames have a flat background behind the object, so their crops
hold more valid pixels than the sample and ``choose`` samples; ``test``
and ``renders`` frames hold the object alone, and ``choose`` wrap-pads.

Every depth carries 1 mm of noise.  Even so the background's pixels
are nearly a lattice on a plane (train depth is whole millimetres):
their distances tie, and the two packages' f32 expanded distances (and
JAX's own, fused one way or another) order those near-ties each their
own way.  The pyramid is held by the near-tie rule of
tests/test_torch_pipeline.py; the CLI tests' test frames carry no
background.

Off the TPU, ``lax.approx_max_k`` (JAX's default pyramid and DGCNN
graphs) computes the exact top-k: XLA's CPU backend lowers it to a sort,
and only the TPU backend lowers it to the recall-bounded partial
reduction.  The tests below hold JAX's approximate mode against the
port's exact top-k on blocks full of ties, where an order that differed
would show."""

import dataclasses
import importlib
import logging

import numpy as np
import pytest
import torch

from test_torch_dataset import _assert_same, port_config
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate
from gdm_tpu_torch.data import pipeline as P
from gdm_tpu_torch.ops import knn as K

torch.set_num_threads(1)
IM_H, IM_W = 120, 160
IN_SIZE, N_SAMPLE, N_MESH = 64, 3072, 128
OBJ = 10                       # eggbox, LM-full's symmetric object
N_TEST, N_TRAIN = 6, 3         # test frames; frames of each train subset
Z_RANGE = (0.4, 0.6)           # the writer's object depths (metres)
TRAIN_SUBSETS = ("real", "fuse", "renders")


def mini_configs():
    """(JAX config, port config): LM-full's preset at the mini scale."""
    from gdm_tpu.configs.base import LMFULL

    cfg_j = dataclasses.replace(
        LMFULL,
        data=dataclasses.replace(
            LMFULL.data, img_hw=(IM_H, IM_W), model_pt_num=N_MESH,
            num_sample_points=N_SAMPLE, input_size=IN_SIZE),
        model=dataclasses.replace(LMFULL.model, n_mesh_node=N_MESH))
    return cfg_j, port_config(cfg_j)


def intrinsics():
    return np.array([[140.0, 0, IM_W / 2], [0, 140.0, IM_H / 2], [0, 0, 1]],
                    np.float32)


def build_mini_root(root):
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_lmfull_root

    mesh = make_object(N_MESH, np.random.RandomState(3), radius=0.05)
    return write_synthetic_lmfull_root(
        root, mesh, N_TEST, N_TRAIN, im_hw=(IM_H, IM_W), K=intrinsics(),
        seed=1, obj_id=OBJ, background=("real", "fuse"))


def patch_presets(mp):
    """The mini preset as both packages' ``lmfull`` (and ``lm_full``)."""
    from gdm_tpu.configs import base as cfg_base

    cfg_j, cfg_t = mini_configs()
    for name in ("lmfull", "lm_full"):
        mp.setitem(cfg_base._PRESETS, name, cfg_j)
        mp.setitem(configs._PRESETS, name, cfg_t)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def lmfull_root(tmp_path_factory):
    return build_mini_root(str(tmp_path_factory.mktemp("mini_lmfull")))


def _datasets(root, mode):
    from gdm_tpu.data.dataset import PoseDataset as PoseDatasetJ

    cfg_j, cfg_t = mini_configs()
    return (PoseDataset(cfg_t, OBJ, mode, data_root=root,
                        rng=np.random.RandomState(0)),
            PoseDatasetJ(cfg_j, OBJ, mode, data_root=root,
                         rng=np.random.RandomState(0)))


def _valid_pixels(item):
    return int((item["dpt_u16"] > 0).sum())


# -- the preset ---------------------------------------------------------------

def test_mini_preset_keeps_lmfull_fields():
    full = configs.get_config("lmfull")
    _, cfg = mini_configs()
    for f in ("name", "train_subsets", "test_subsets", "nn_dist_th",
              "sym_objs", "obj_ids", "dzi_pad_ratio"):
        assert getattr(cfg.data, f) == getattr(full.data, f), f
    assert cfg.data.name == "lm_full" and cfg.data.nn_dist_th == 0.01
    assert cfg.data.train_subsets == TRAIN_SUBSETS
    assert (cfg.solver.train_batch_size, cfg.solver.val_batch_size) == (6, 8)
    assert cfg.solver == full.solver and cfg.model.neighbor_dis_th == 0.02
    full_ratio = full.data.num_sample_points / full.data.input_size ** 2
    ratio = N_SAMPLE / IN_SIZE ** 2
    assert (full.data.num_sample_points, full.data.input_size) == (12800, 128)
    assert abs(ratio - full_ratio) < 0.05 and N_SAMPLE % 256 == 0


def test_knn_chunk_at_lmfull_shapes():
    """The support is max((128 / 2)^2, 12800) = 12800 scene points; at the
    val batch of 8 and the train batch of 6 a 1024-query block holds
    8 x 1024 x 12800 f32 (420 MB) and stays; at b=128 it is lowered."""
    cfg = configs.get_config("lmfull")
    log = logging.getLogger("test")
    assert cli_t.knn_chunk_for(1024, 8, cfg, log) == 1024
    assert cli_t.knn_chunk_for(1024, 6, cfg, log) == 1024
    chunk = cli_t.knn_chunk_for(1024, 128, cfg, log)
    assert chunk == 512 and 128 * chunk * 12800 <= cli_t.KNN_BLOCK_ELEMS


# -- the dataset --------------------------------------------------------------

@pytest.mark.parametrize("subset", TRAIN_SUBSETS)
def test_train_items_match_jax(lmfull_root, subset):
    """Each record of the subset, in both packages from one seed: every
    key bit-equal (counts, crops, choose, labels, match_idx at
    nn_dist_th 0.01, visibility).  real and fuse crops hold more valid
    pixels than the 3072 samples (choose samples them), renders crops
    fewer (choose wrap-pads)."""
    ds_t, ds_j = _datasets(lmfull_root, "train")
    recs = [r for r in ds_t.annos if f"/{subset}/" in r.rgb_file]
    assert len(recs) == N_TRAIN and {r.img_type for r in recs} == {"real"}
    assert ds_t.gt_match_th_m == ds_j.gt_match_th_m
    for rec in recs:
        a = ds_t.get_item(rec, np.random.RandomState(7))
        b = ds_j.get_item([r for r in ds_j.annos
                           if r.rgb_file == rec.rgb_file][0],
                          rng=np.random.RandomState(7))
        assert a is not None and b is not None, rec.rgb_file
        assert set(a) == set(b), rec.rgb_file
        for k in a:
            _assert_same(a[k], b[k], (rec.rgb_file, k))
        assert a["choose"].shape == (N_SAMPLE,)
        assert a["labels"].any() and (a["labels"] == 0).any()
        sampled = _valid_pixels(a) > N_SAMPLE
        assert sampled == (subset != "renders"), (subset, _valid_pixels(a))
        if not sampled:       # wrap-padded: every valid pixel, repeated
            assert len(np.unique(a["choose"])) == _valid_pixels(a)


def test_train_epoch_items_match_jax(lmfull_root):
    """The dataset's own draws over two epochs (records of all three
    subsets)."""
    ds_t, ds_j = _datasets(lmfull_root, "train")
    assert len(ds_t) == len(ds_j) == 3 * N_TRAIN
    for epoch in (0, 1):
        ds_t.set_epoch(epoch)
        ds_j.set_epoch(epoch)
        for i in range(len(ds_t)):
            a, b = ds_t[i], ds_j[i]
            for k in a:
                _assert_same(a[k], b[k], (epoch, i, k))


@pytest.mark.parametrize("mode", ["test", "infer"])
def test_test_and_infer_items_match_jax(lmfull_root, mode):
    ds_t, ds_j = _datasets(lmfull_root, mode)
    assert len(ds_t) == len(ds_j) == N_TEST
    for i in range(N_TEST):
        a, b = ds_t[i], ds_j[i]
        for k in a:
            _assert_same(a[k], b[k], (mode, i, k))
        assert a["dpt_scale"] == 10000.0 and _valid_pixels(a) < N_SAMPLE


def _object_depths(item):
    """Depths (m) of the chosen pixels that the crop's mask calls the
    object."""
    z = item["dpt_u16"].ravel()[item["choose"]] / item["dpt_scale"]
    return z[item["origin_labels"] > 0]


def test_train_depth_is_read_in_millimetres(lmfull_root, tmp_path):
    """real, fuse and renders frames divide their depth by 1000: the
    object's points lie at the writer's depths.  The same frames written
    at 0.1 mm counts (depth_scale 0.1, as test frames are) are read 10x
    too deep by both packages alike, no scene point then lies within
    nn_dist_th of the posed mesh, and every train item is refused (the
    dataset's redraw loop would never end): the trap the tree avoids."""
    from gdm_tpu_torch.data.imio import imread_mask, imread_u16
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    ds_t, _ = _datasets(lmfull_root, "train")
    for i in range(len(ds_t)):
        item = ds_t[i]
        assert item["dpt_scale"] == 1000.0
        z = _object_depths(item)
        assert Z_RANGE[0] - 0.07 < z.min() and z.max() < Z_RANGE[1] + 0.07

    root = str(tmp_path)
    write_synthetic_bop_root(
        root, make_object(N_MESH, np.random.RandomState(3), radius=0.05),
        n_frames=1, subsets=TRAIN_SUBSETS, im_hw=(IM_H, IM_W),
        K=intrinsics(), seed=2, obj_id=OBJ)
    ds_t, ds_j = _datasets(root, "train")
    assert len(ds_t.annos) == len(TRAIN_SUBSETS)
    for rec, rec_j in zip(ds_t.annos, ds_j.annos):
        z = imread_u16(rec.depth_file)[imread_mask(rec.mask_file) > 0] \
            / 1000.0
        assert z.min() > 10 * (Z_RANGE[0] - 0.07)
        assert ds_t.get_item(rec, np.random.RandomState(7)) is None
        assert ds_j.get_item(rec_j, rng=np.random.RandomState(7)) is None


# -- finalize and the pyramid at the LM-full ratios ---------------------------

@pytest.fixture(scope="module")
def train_batch(lmfull_root):
    """One train batch of 6 (two records of each subset), finalized and
    given its pyramid by both packages; JAX's pyramid in its exact and
    its default mode."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import build_pyramid, finalize_batch

    ds_t, _ = _datasets(lmfull_root, "train")
    keys = ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop", "choose")
    batch, _ = collate([ds_t[i] for i in (0, 1, 3, 4, 6, 7)])
    raw = {k: batch[k] for k in keys}
    raw["det"] = np.ones(6, np.int32)
    fin_j = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    pyr = {}
    for approx in (False, True):
        p = jax.vmap(lambda c, x: build_pyramid(
            c, x, knn_chunk=1024, approx=approx))(
                fin_j["cld_rgb_nrm"][..., :3], fin_j["xyz_img"])
        pyr[approx] = {k: np.asarray(v) for k, v in p.items()}
    fin_t = P.finalize_batch(P.to_device(raw, "cpu"))
    pyr_t = P.build_pyramid(fin_t["cld_rgb_nrm"][..., :3], fin_t["xyz_img"],
                            knn_chunk=1024)
    return {"fin_j": {k: np.asarray(v) for k, v in fin_j.items()},
            "fin_t": fin_t, "exact_j": pyr[False], "approx_j": pyr[True],
            "pyr_t": {k: v.numpy() for k, v in pyr_t.items()}}


def test_finalize_matches_jax(train_batch):
    for key in ("rgb", "cld_rgb_nrm", "xyz_img", "choose"):
        np.testing.assert_allclose(train_batch["fin_t"][key].numpy(),
                                   train_batch["fin_j"][key], rtol=0,
                                   atol=1e-5, err_msg=key)


def test_pyramid_levels_at_the_lmfull_ratios(train_batch):
    """3072 / 768 / 192 / 48 / 12 points (LM-full: 12800 / 3200 / 800 /
    200 / 50) over the 16^2 / 8^2 / 32^2 grids of a 64^2 crop (LM-full's
    128^2: 32^2 / 16^2 / 64^2)."""
    pyr = train_batch["pyr_t"]
    assert [pyr[f"cld_xyz{i}"].shape[1] for i in range(4)] == \
        [N_SAMPLE, 768, 192, 48]
    assert pyr["cld_sub_idx3"].shape == (6, 12, 16)
    assert pyr["r2p_ds_nei_idx0"].shape == (6, 768, 16)
    assert int(pyr["r2p_ds_nei_idx0"].max()) < 16 ** 2
    assert int(pyr["r2p_ds_nei_idx1"].max()) < 8 ** 2
    assert int(pyr["r2p_up_nei_idx2"].max()) < 32 ** 2
    assert int(pyr["p2r_ds_nei_idx3"].max()) < 12


def _near_ties(got, want, key, fin):
    """Every index where ``got`` and ``want`` differ picks a point whose
    squared distance to the query lies within NEAR_TIE of the other's."""
    from test_torch_pipeline import NEAR_TIE, _query_support

    assert got.shape == want.shape, key
    query, support = _query_support(key, fin)
    for bi, r, j in zip(*np.nonzero(got != want)):
        q = query[bi, r].astype(np.float64)
        da = np.sum((support[bi, want[bi, r, j]] - q) ** 2)
        db = np.sum((support[bi, got[bi, r, j]] - q) ** 2)
        assert abs(da - db) < NEAR_TIE, (key, bi, r, j, da, db)
    return float((got != want).any(axis=-1).mean())


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_pyramid_matches_jax(train_batch, mode):
    """Every index of the port's pyramid against JAX's, in its exact and
    its default (approx_max_k) mode, and JAX's two modes against each
    other: equal but for near-tie picks (squared distances within 1e-6
    m^2).  On this batch such picks differ on up to ~30% of a level's rows
    (its depth is whole millimetres, so the background's pixel lattice
    still ties; the f32 expanded distances round each their own way in
    the port, in JAX and in each of JAX's two jits); on the same f32
    block, approx_max_k and the port's top-k are bit-equal
    (test_topk_block_approx_equals_the_ports_exact)."""
    ref, fin = train_batch[f"{mode}_j"], train_batch["fin_j"]
    keys = [k for k in ref if k.startswith(("cld_nei", "cld_sub",
                                            "cld_interp", "r2p", "p2r"))]
    assert len(keys) == 26
    for key in keys:
        _near_ties(train_batch["pyr_t"][key], ref[key], key, fin)
        _near_ties(ref[key], train_batch["exact_j"][key], key, fin)
    # the exact argmins away from the lattice agree on nearly every row
    assert _near_ties(train_batch["pyr_t"]["p2r_ds_nei_idx1"],
                      ref["p2r_ds_nei_idx1"], "p2r_ds_nei_idx1", fin) < 0.01


# -- JAX's default KNN mode: approx_max_k off the TPU -------------------------

def _knn_j():
    # gdm_tpu.ops re-exports the function ``knn`` under the module's name
    return importlib.import_module("gdm_tpu.ops.knn")


@pytest.mark.parametrize("shape,decimals", [((64, 12800), 2),
                                            ((512, 4096), 3),
                                            ((256, 3200), 1)])
@pytest.mark.parametrize("recall", [0.95, 0.85])
def test_topk_block_approx_equals_the_ports_exact(shape, decimals, recall):
    """``topk_block(approx=True)`` on a block of rounded distances (every
    row holds many exactly tied entries) gives the port's exact top-16:
    ascending, ties to the lowest index."""
    import jax.numpy as jnp

    d = np.round(np.random.RandomState(sum(shape)).rand(*shape),
                 decimals).astype(np.float32)
    got = np.asarray(_knn_j().topk_block(jnp.asarray(d), 16, approx=True,
                                         recall_target=recall))
    want = K.topk_block(torch.from_numpy(d), 16).numpy()
    assert (np.diff(np.sort(d, axis=-1)[:, :17], axis=-1) == 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_support,n_query", [(12800, 512), (3072, 3072)])
def test_knn_approx_equals_the_ports_exact(n_support, n_query):
    """``knn(approx=True)`` over integer-grid points (distances exact in
    f32 in both packages, and tied by the thousand) gives the port's
    exact neighbours, index for index."""
    import jax.numpy as jnp

    rng = np.random.RandomState(n_support)
    support = rng.randint(0, 8, (n_support, 3)).astype(np.float32)
    query = np.concatenate([support[:n_query // 2], rng.randint(
        0, 8, (n_query - n_query // 2, 3)).astype(np.float32)])
    for recall in (0.95, 0.85):
        got = np.asarray(_knn_j().knn(jnp.asarray(support),
                                      jnp.asarray(query), 16, chunk=512,
                                      approx=True, recall_target=recall))
        want = K.knn(torch.from_numpy(support)[None],
                     torch.from_numpy(query)[None], 16, 512)[0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("features", ["grid", "random"])
def test_dgcnn_graphs_approx_equal_the_ports(features):
    """JAX's DGCNN graphs in its default mode (``approx=True``: knn at
    recall_target 0.85, unless model.dgcnn_exact_knn) against the port's
    exact graphs, over 64-d features as the second and third graphs see
    them.  Integer features: the edge features bit-equal.  Random
    features: JAX's approximate graph equals its exact one, and the
    port's equals it but for near-ties at the f32 expanded form's scale
    (distance gap < 1e-6 (|x_i|^2 + |x_j|^2), tests/test_torch_dgcnn.py's
    rule)."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.models.dgcnn import graph_feature_b as graph_j
    from gdm_tpu_torch.models.dgcnn import graph_feature_b as graph_t

    rng = np.random.RandomState(5)
    if features == "grid":
        x = rng.randint(-2, 3, (2, 2048, 64)).astype(np.float32)
        edges_t, _ = graph_t(torch.from_numpy(x), 20)
        for approx in (True, False):
            got = jax.jit(lambda v, a=approx: graph_j(v, 20, approx=a))(
                jnp.asarray(x))
            np.testing.assert_array_equal(np.asarray(got), edges_t.numpy())
        return
    x = rng.randn(2, 2048, 64).astype(np.float32)
    _, idx_t = graph_t(torch.from_numpy(x), 20)
    idx_t = idx_t.numpy()
    idx = {a: np.asarray(jax.vmap(lambda c, a=a: _knn_j().knn(
        c, c, 20, chunk=1024, approx=a, recall_target=0.85))(
            jnp.asarray(x))) for a in (True, False)}
    np.testing.assert_array_equal(idx[True], idx[False])
    diff = idx_t != idx[True]
    assert diff.any(-1).mean() < 0.01
    x64 = x.astype(np.float64)
    for b, i, j in zip(*np.nonzero(diff)):
        a_, t_ = idx[True][b, i, j], idx_t[b, i, j]
        d_a = np.sum((x64[b, a_] - x64[b, i]) ** 2)
        d_t = np.sum((x64[b, t_] - x64[b, i]) ** 2)
        scale = np.sum(x64[b, i] ** 2) + max(np.sum(x64[b, a_] ** 2),
                                             np.sum(x64[b, t_] ** 2))
        assert abs(d_a - d_t) < 1e-6 * scale, (b, i, j, d_a, d_t)


@pytest.mark.parametrize("backbone,exact,want", [
    ("randla_spline", False, "the pyramid is the exact top-k"),
    ("randla_spline", True, None),
    ("dgcnn", False, "the DGCNN graphs are the exact top-k"),
    ("dgcnn", True, None)])
def test_default_knn_mode_is_logged_as_exact(backbone, exact, want,
                                             caplog):
    """Without --exact-knn the port says what it builds: the exact top-k,
    which is what JAX's default approx_max_k computes off the TPU."""
    import argparse

    cfg = configs.get_config("lmfull", [f"model.backbone={backbone}"])
    log = logging.getLogger("test_lmfull")
    with caplog.at_level(logging.INFO, logger="test_lmfull"):
        cli_t._log_exact_knn(argparse.Namespace(exact_knn=exact), cfg, log)
    text = caplog.text
    if want is None:
        assert text == ""
    else:
        assert want in text and "approx_max_k" in text and "TPU" in text

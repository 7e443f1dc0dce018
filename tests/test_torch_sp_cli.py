"""``--model-shards 2`` through the port's CLI on two gloo CPU ranks (one
model row: the ranks hold the same batch rows and split the 128 mesh
columns of the mini BOP tree, tests/test_data.py) against the dense
one-rank run:

  * ``train`` (the flagship, and DGCNN with its one-hot pad column and
    depth-scaled radius): the first step's metrics of the JAX CLI's
    tests/test_cli.py:70 and :572, here within 1e-5 relative for the
    loss and the matching loss (the sharded loss sums in another order)
    and 1e-6 for the seg loss (the same forward: data rank 0 draws the
    one-rank run's dropout masks);
  * ``eval`` and ``infer``: every batch's correspondences, taken from the
    argmax split over the two ranks, equal the dense argmax of the same
    features wherever the row's top-2 gap exceeds 1e-5, and the CSV
    holds the dense run's rows, poses within 1e-5 on the frames whose
    correspondences all agree.
"""

import json
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import _torch_harness as H
import _torch_mp
from _torch_mp_cases import MINI_OPTS
from test_data import bop_root  # noqa: F401
from test_torch_cli import _read_csv
from test_torch_mp_cli import fitting_checkpoint
from gdm_tpu_torch import cli as cli_t

torch.set_num_threads(1)
GAP, POSE_TOL = 1e-5, 1e-5
DGCNN = ["--opt", "model.backbone=dgcnn"]


def _train_argv(root, ckpt_root, *extra):
    return ["train", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--batch-size", "2", "--epochs", "1", "--ckpt-root",
            ckpt_root, "--device", "cpu", "--num-workers", "1",
            "--knn-chunk", "64", *MINI_OPTS, *extra]


def _first_step(ckpt_root):
    rows = [json.loads(line) for line in open(osp.join(
        ckpt_root, "metrics", "ape.jsonl"))]
    return next(r for r in rows if r.get("it") == 0 and "loss" in r)


@pytest.mark.parametrize("backbone", ["flagship", "dgcnn"])
def test_train_model_shards_matches_dense(bop_root, tmp_path,  # noqa: F811
                                          backbone):
    extra = DGCNN if backbone == "dgcnn" else []
    dense, sharded = str(tmp_path / "dense"), str(tmp_path / "sharded")
    try:
        cli_t.main(_train_argv(bop_root, dense, *extra))
        _torch_mp.run("_torch_mp_cases:cli_rank", 2, tmp_path, {
            "argv": _train_argv(bop_root, sharded, "--model-shards", "2",
                                *extra)})
        d, s = _first_step(dense), _first_step(sharded)
    finally:        # each checkpoint holds the model and Adam's moments
        shutil.rmtree(dense, ignore_errors=True)
        shutil.rmtree(sharded, ignore_errors=True)
    assert np.isfinite(d["loss"]) and d["match_loss"] > 0
    assert s["seg_loss"] == pytest.approx(d["seg_loss"], rel=1e-6)
    assert s["match_loss"] == pytest.approx(d["match_loss"], rel=1e-5)
    assert s["loss"] == pytest.approx(d["loss"], rel=1e-5)


@pytest.fixture(scope="module")
def fit_ckpt(bop_root, tmp_path_factory):  # noqa: F811
    ckpt = str(tmp_path_factory.mktemp("fit_ckpt"))
    fitting_checkpoint(bop_root, ckpt)
    return ckpt


def _run_argv(cmd, root, ckpt, out):
    argv = [cmd, "--dataset", "lmo", "--data-root", root, "--cls-id", "1",
            "--batch-size", "3", "--num-workers", "1", "--knn-chunk", "64",
            "--torch-checkpoint", ckpt, "--device", "cpu", *MINI_OPTS]
    if cmd == "eval":
        return argv + ["--output-dir", out]
    return argv + ["--output", osp.join(out, "gt_lmo-test.csv")]


@pytest.mark.parametrize("cmd", ["eval", "infer"])
def test_sharded_correspondences_match_dense(bop_root, fit_ckpt,  # noqa: F811
                                             tmp_path, cmd):
    dense, sharded = str(tmp_path / "dense"), str(tmp_path / "sharded")
    cli_t.main(_run_argv(cmd, bop_root, fit_ckpt, dense))
    ranks = _torch_mp.run("_torch_mp_cases:cli_rank", 2, tmp_path, {
        "argv": _run_argv(cmd, bop_root, fit_ckpt, sharded)
        + ["--model-shards", "2"]})
    fits = ranks[0]["fits"]
    assert len(fits) == 3            # the warm-up and two batches of 3
    assert len(ranks[1]["fits"]) == len(fits)
    for mine, other in zip(fits, ranks[1]["fits"]):   # one merged argmax
        np.testing.assert_array_equal(other["idx"], mine["idx"])
    agree = {}
    for fit in fits[1:]:
        f = fit["rgbd"] / np.linalg.norm(fit["rgbd"], axis=-1,
                                         keepdims=True)
        g = fit["mesh"] / np.linalg.norm(fit["mesh"], axis=-1,
                                         keepdims=True)
        dense_idx = np.einsum("bnc,mc->bnm", f.astype(np.float64),
                              g.astype(np.float64)).argmax(-1)
        gap = H.top2_gap(f.reshape(-1, f.shape[-1]), g).reshape(
            f.shape[:2])
        far = gap > GAP
        assert far.mean() > 0.9 and len(np.unique(fit["idx"])) > 10
        np.testing.assert_array_equal(fit["idx"][far], dense_idx[far])
        for row in (fit["idx"] == dense_idx).all(-1):
            agree[len(agree)] = bool(row)
    rows_d, keys_d = _read_csv(osp.join(dense, "gt_lmo-test.csv"))
    rows_s, keys_s = _read_csv(osp.join(sharded, "gt_lmo-test.csv"))
    assert keys_s == keys_d and len(keys_d) == 4
    for i, k in enumerate(keys_d):
        if agree[i]:
            np.testing.assert_allclose(rows_s[k][0], rows_d[k][0], rtol=0,
                                       atol=POSE_TOL)
            np.testing.assert_allclose(rows_s[k][1], rows_d[k][1], rtol=0,
                                       atol=POSE_TOL)
    assert any(agree.values())

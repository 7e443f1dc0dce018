"""``cli train --dataset lmfull`` of the port on the CPU, on the mini
LM-full tree of tests/test_torch_lmfull.py (9 train records, 3 of each of
``real``, ``fuse`` and ``renders``; the preset's batch of 6: one step an
epoch), then both packages' ``cli eval --torch-checkpoint`` of the
checkpoint it wrote (the pattern of tests/test_torch_train_cli.py): the
checkpoint layout, finite logged losses, and the same CSV rows from
both evals, every pose a rotation or the miss sentinel.  (Poses are
compared under well-posed weights in tests/test_torch_lmfull_cli.py.)"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from test_torch_cli import _read_csv
from test_torch_lmfull import N_TEST, OBJ, build_mini_root, patch_presets
from gdm_tpu_torch import cli as cli_t

torch.set_num_threads(1)
NAME = "eggbox"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j

    root = build_mini_root(str(tmp_path_factory.mktemp("lmfull_train")))
    ckpt_root = str(tmp_path_factory.mktemp("train_log"))
    mp = MonkeyPatch()
    patch_presets(mp)
    try:
        res = cli_t.main([
            "train", "--dataset", "lmfull", "--data-root", root, "--cls-id",
            str(OBJ), "--epochs", "1", "--ckpt-root", ckpt_root, "--device",
            "cpu", "--num-workers", "2", "--opt",
            "solver.checkpoint_every_epochs=1"])
        common = ["--dataset", "lmfull", "--data-root", root, "--cls-id",
                  str(OBJ), "--num-workers", "2", "--exact-knn",
                  "--torch-checkpoint", osp.join(ckpt_root, "checkpoints")]
        out = {}
        for run, cli, dev in (("jax", cli_j, ["--devices", "1"]),
                              ("port", cli_t, ["--device", "cpu"])):
            d = str(tmp_path_factory.mktemp(f"eval_{run}"))
            out[run] = (cli.main(["eval", *common, *dev, "--output-dir", d]),
                        osp.join(d, "gt_lmfull-test.csv"))
        yield {"res": res, "ckpt_root": ckpt_root, "eval": out}
    finally:
        mp.undo()


def test_one_step_at_the_lmfull_batch_with_finite_losses(runs):
    assert len(runs["res"]["timing"]) == 1          # 9 records // 6
    rows = [json.loads(line) for line in open(osp.join(
        runs["ckpt_root"], "metrics", f"{NAME}.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 1 and np.isfinite(losses).all()
    d = osp.join(runs["ckpt_root"], "checkpoints", NAME)
    assert sorted(os.listdir(d)) == ["epoch_0000", "geomatch.pth.tar",
                                     "latest"]
    blob = torch.load(osp.join(d, "epoch_0000", "geomatch.pth.tar"),
                      weights_only=True)
    assert blob["step"] == 1
    assert all(torch.isfinite(v).all() for v in blob["model_state"].values()
               if v.is_floating_point())


def test_both_packages_evaluate_the_trained_checkpoint(runs):
    (res_j, csv_j), (res_t, csv_t) = runs["eval"]["jax"], runs["eval"]["port"]
    rows_j, keys_j = _read_csv(csv_j)
    rows_t, keys_t = _read_csv(csv_t)
    assert keys_t == keys_j and len(keys_t) == N_TEST
    for rows in (rows_j, rows_t):
        for R, t in rows.values():
            assert np.isfinite(R).all() and np.isfinite(t).all()
            miss = t[2] <= -0.999
            assert miss or abs(np.linalg.det(R) - 1.0) < 1e-4
    assert len(res_t["errors"][NAME]["ad"]) == len(
        res_j["errors"][NAME]["ad"]) == N_TEST

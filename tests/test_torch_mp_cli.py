"""``cli train`` and ``cli eval`` of the port over two gloo CPU ranks on the
mini BOP tree of tests/test_data.py (4 train_pbr frames, 4 test frames),
against one rank.

  * ``train --multihost`` (the ranks' process group made by the test
    harness, tests/_torch_mp.py), global batch 4 (2 rows per rank), one
    epoch, dropout off in both runs, 1024 points, rank 1 given its own
    --ckpt-root: the first step's losses within 1e-5 relative, or 8x the
    port's own f32 spread (tests/test_torch_train.py's rule; the spread:
    the same one-rank step with the two ranks' rows swapped, whose batch
    norms sum in the other order), of one rank's train step on the same
    global rows (each rank's loader slice, augmented with the seed plus
    its rank); the exact agreement is tests/test_torch_dp.py's, in
    float64.  The batch-norm running
    statistics equal on both ranks and, by the same rule, within 1e-5 of
    that one-rank step's.  Only rank 0 wrote checkpoints and metrics;
    ``--resume --epochs 2`` on both ranks from rank 0's checkpoints
    continues from epoch 0 and ends equal on both, rank 1 still writing
    nothing; the checkpoint is read by the port's one-rank ``cli eval``
    and by the JAX package's ``cli eval --torch-checkpoint`` (equal CSV
    rows);
  * ``eval --devices 2`` (two spawned ranks, the gathered evaluator)
    writes the CSV rows and recalls of ``eval --devices 1`` under weights
    whose matches spread (poses within 1e-5: each rank runs its own batch
    of the frames).
"""

import json
import os
import os.path as osp
import pickle
import shutil

import numpy as np
import pytest
import torch

import _torch_harness as H
import _torch_mp
import test_data
from _torch_mp_cases import MINI_OPTS
from test_data import N_MESH, bop_root  # noqa: F401
from test_torch_cli import _read_csv
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights

torch.set_num_threads(1)
LOSS_TOL, STAT_TOL, POSE_TOL = 1e-5, 1e-5, 1e-5
BATCH = 4


# every batch norm of the deepest RandLA level sees B * N / 256 rows: at
# the tree's 256 points, 4, and an f32 train step of so few rows turns
# the last bits of the moments' summation order into ~1e-4 of the seg
# loss (tests/test_torch_train.py); at 1024 points, 16
TRAIN_OPTS = MINI_OPTS + ["--opt", "data.num_sample_points=1024"]


def _cfg(opts=MINI_OPTS):
    return configs.get_config("lmo", opts[1::2])


def _train_argv(root, ckpt_root, epochs, *extra):
    return ["train", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--batch-size", str(BATCH), "--epochs", str(epochs),
            "--ckpt-root", ckpt_root, "--device", "cpu", "--num-workers",
            "1", "--knn-chunk", "64", "--opt",
            "solver.checkpoint_every_epochs=1", *TRAIN_OPTS, *extra]


def _one_rank_step(root, order=(0, 1)):
    """One rank's first train step on the two ranks' rows: the CLI's
    model, schedules and seeds (cli.train), the global batch made of
    each rank's loader batch, in ``order``."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import DataLoader
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.models.layers import Dropout
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    cfg = _cfg(TRAIN_OPTS)
    sol = cfg.solver
    fps = load_or_build_fps_mesh(root, 1, N_MESH)
    diameter = refdata.get("lmo").diameters_mm_by_id[1] / 1000.0
    parts = []
    for r in range(2):
        ds = PoseDataset(cfg, 1, "train", mesh_fps=fps, data_root=root,
                         rng=np.random.RandomState(r), diameter_m=diameter)
        dl = DataLoader(ds, BATCH // 2, shuffle=True, drop_last=True,
                        num_workers=1, seed=0, rank=r, world=2)
        dl.set_epoch(0)
        parts.append(next(iter(dl))[0])
    batch = {k: np.concatenate([parts[r][k] for r in order])
             for k in parts[0]}
    model, mesh, _, _ = build_model(cfg, cli_t._fps_mm(fps), "cpu",
                                    awl=True)
    weights.init_random_(model, torch.Generator().manual_seed(1))
    # one epoch of one step per rank: epochs * len(dl) = 1
    lr = cyclic_lr(sol.base_lr, sol.max_lr, max(1 // sol.clr_div, 1))
    state = create_train_state(model, lr, sol.weight_decay,
                               sol.skip_nonfinite)
    step = make_train_step(
        bn_momentum_schedule(sol.bn_momentum, sol.bn_decay,
                             sol.bn_decay_step, BATCH, sol.bn_momentum_clip),
        cfg.model.neighbor_dis_th * diameter, 64)
    forward = Dropout.forward
    Dropout.forward = lambda self, x: x
    try:
        m = step(state, batch, mesh, 8)
    finally:
        Dropout.forward = forward
    return {k: float(m[k]) for k in ("loss", "seg_loss", "match_loss")}, \
        {k: v.numpy() for k, v in weights.reference_state_dict(model).items()}


@pytest.fixture(scope="module")
def trained(bop_root, tmp_path_factory):  # noqa: F811
    base = tmp_path_factory.mktemp("mp_train")
    first = _torch_mp.run("_torch_mp_cases:cli_rank", 2, base, {
        "argv": _train_argv(bop_root, str(base / "r{rank}"), 1),
        "no_dropout": True})
    metrics = open(osp.join(base, "r0", "metrics", "ape.jsonl")).read()
    r0 = str(base / "r0")
    resumed = _torch_mp.run("_torch_mp_cases:cli_rank", 2, base, {
        "argv": _train_argv(bop_root, r0, 2, "--resume"),
        "no_dropout": True})
    losses, ref_state = _one_rank_step(bop_root)
    swapped, swapped_state = _one_rank_step(bop_root, (1, 0))
    # each checkpoint holds the model and Adam's moments, ~340 MB
    try:
        yield {"base": base, "first": first, "resumed": resumed,
               "r0": r0, "metrics": metrics, "ref_losses": losses,
               "swapped": swapped, "ref_state": ref_state,
               "swapped_state": swapped_state, "root": bop_root}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def test_first_step_matches_one_rank(trained):
    rows = [json.loads(line) for line in trained["metrics"].splitlines()]
    first = next(r for r in rows if r.get("it") == 0 and "loss" in r)
    for k, want in trained["ref_losses"].items():
        assert np.isfinite(want)
        spread = abs(trained["swapped"][k] - want)
        tol = max(LOSS_TOL * abs(want), 8 * spread)
        assert abs(first[k] - want) <= tol, (k, first[k], want, spread)


def test_batch_norm_statistics_equal_on_ranks_and_to_one_rank(trained):
    s0, s1 = (r["objects"]["ape"]["state"] for r in trained["first"])
    stats = [k for k in s0 if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for k, v in s0.items():
        np.testing.assert_array_equal(s1[k], v, err_msg=k)
    for k in stats:
        ref = trained["ref_state"][k]
        spread = H.rel_err(trained["swapped_state"][k], ref)
        err = H.rel_err(s0[k], ref)
        assert err <= max(STAT_TOL, 8 * spread), (k, err, spread)


def test_rank_zero_alone_writes(trained):
    d0 = trained["r0"]
    assert sorted(os.listdir(osp.join(d0, "checkpoints", "ape"))) == [
        "epoch_0000", "epoch_0001", "geomatch.pth.tar", "latest"]
    assert len([ln for ln in trained["metrics"].splitlines()
                if '"loss"' in ln]) == 1       # epoch 0: one step of 4
    assert not osp.exists(osp.join(trained["base"], "r1"))


def test_resume_continues_on_both_ranks(trained):
    res = trained["resumed"]
    for r in res:
        assert {t["epoch"] for t in r["timing"]} == {1}
        assert r["objects"]["ape"]["step"] == 2
    s0, s1 = (r["objects"]["ape"]["state"] for r in res)
    for k, v in s0.items():
        np.testing.assert_array_equal(s1[k], v, err_msg=k)
    blob = torch.load(osp.join(trained["r0"], "checkpoints", "ape",
                               "epoch_0001", "geomatch.pth.tar"),
                      weights_only=True)
    assert blob["epoch"] == 1 and blob["step"] == 2
    for k, v in blob["model_state"].items():
        np.testing.assert_array_equal(v.numpy(), s0[k], err_msg=k)


def test_both_packages_evaluate_the_checkpoint(trained, tmp_path):
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base

    common = ["--dataset", "lmo", "--data-root", trained["root"],
              "--cls-id", "1", "--batch-size", "3", "--num-workers", "1",
              "--knn-chunk", "64", "--exact-knn", "--torch-checkpoint",
              osp.join(trained["r0"], "checkpoints")]
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    mp = MonkeyPatch()
    mp.setitem(cfg_base._PRESETS, "lmo", test_data._mini_config())
    try:
        cli_j.main(["eval", *common, "--devices", "1", "--output-dir",
                    out_j])
    finally:
        mp.undo()
    cli_t.main(["eval", *common, *MINI_OPTS, "--device", "cpu",
                "--output-dir", out_t])
    rows_j, keys_j = _read_csv(osp.join(out_j, "gt_lmo-test.csv"))
    rows_t, keys_t = _read_csv(osp.join(out_t, "gt_lmo-test.csv"))
    assert keys_t == keys_j and len(keys_t) == 4
    for k in keys_t:
        np.testing.assert_array_equal(rows_t[k][0], rows_j[k][0])
        np.testing.assert_array_equal(rows_t[k][1], rows_j[k][1])


def fitting_checkpoint(root, ckpt):
    """<ckpt>/ape/geomatch.pth.tar: seeded weights whose scene and mesh
    features are centred (the scene head's last layer takes its input
    projected off the input's mean direction, the mesh head's bias loses
    the mean mesh feature), so that matches spread over the mesh, and
    whose seg head calls every point foreground."""
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import assemble_inputs, \
        finalize_batch, to_device
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model

    cfg = _cfg()
    fps = load_or_build_fps_mesh(root, 1, N_MESH)
    model, mesh, _, _ = build_model(cfg, cli_t._fps_mm(fps), "cpu")
    weights.init_random_(model, torch.Generator().manual_seed(5))
    model.eval()
    ds = PoseDataset(cfg, 1, "test", data_root=root)
    batch, _ = collate([ds[i] for i in range(len(ds))])
    seen = []
    last = model.feature_encoding_layer[-1]
    hook = last.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach()))
    with torch.no_grad():
        fin = finalize_batch(to_device(
            {k: batch[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale",
                                   "K_crop", "choose", "det")}, "cpu"))
        model(assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                              fin["xyz_img"], 64), mesh)
        hook.remove()
        h0 = seen[0].reshape(-1, seen[0].shape[-1]).double().mean(0)
        proj = torch.eye(len(h0), dtype=torch.float64) \
            - torch.outer(h0, h0) / (h0 @ h0)
        w = last.conv.weight
        w.copy_((w.double() @ proj).float())
        head = model.model_emb.mesh_final
        head.bias -= model.encode_mesh(mesh).mean(0)
        model.seg_layer[-1].conv.bias.copy_(torch.tensor([-50.0, 50.0]))
    os.makedirs(osp.join(ckpt, "ape"))
    torch.save({"model_state": weights.reference_state_dict(model)},
               osp.join(ckpt, "ape", "geomatch.pth.tar"))


@pytest.fixture(scope="module")
def fit_ckpt(bop_root, tmp_path_factory):  # noqa: F811
    ckpt = str(tmp_path_factory.mktemp("fit_ckpt"))
    fitting_checkpoint(bop_root, ckpt)
    return ckpt


def _eval_argv(root, ckpt, out, *extra):
    return ["eval", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--batch-size", "2", "--num-workers", "1", "--knn-chunk",
            "64", "--torch-checkpoint", ckpt, "--device", "cpu",
            "--output-dir", out, *MINI_OPTS, *extra]


def test_eval_devices_2_matches_devices_1(
        bop_root, fit_ckpt, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the spawned ranks'
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    res = cli_t.main(_eval_argv(bop_root, fit_ckpt, one, "--devices", "1"))
    assert cli_t.main(_eval_argv(bop_root, fit_ckpt, two, "--devices",
                                 "2")) is None
    rows1, keys1 = _read_csv(osp.join(one, "gt_lmo-test.csv"))
    rows2, keys2 = _read_csv(osp.join(two, "gt_lmo-test.csv"))
    assert sorted(keys2) == sorted(keys1) and len(keys1) == 4
    hits = 0
    for k in keys1:
        hits += rows1[k][1][2] > -999
        np.testing.assert_allclose(rows2[k][0], rows1[k][0], rtol=0,
                                   atol=POSE_TOL)
        np.testing.assert_allclose(rows2[k][1], rows1[k][1], rtol=0,
                                   atol=POSE_TOL)
    assert hits == 4                      # every frame fitted a pose
    with open(osp.join(two, "_lmo_recalls.pkl"), "rb") as f:
        assert pickle.load(f) == res["recalls"]

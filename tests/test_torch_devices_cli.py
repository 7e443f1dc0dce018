"""``cli train --device cpu --devices 2`` of the port: the CLI's own spawn
(cli._spawn_ranks, two gloo ranks meeting through a file store) on a
tree of 5 ``train_pbr`` frames, which the two data ranks do not divide.

  * The loader cuts each epoch's order to a multiple of the data ranks
    before it slices it, so both ranks run the same steps (5 frames, one
    row per rank: 2 steps each; without the cut rank 0 would run a third
    step whose collectives meet nothing and the run would hang until the
    deadline); evaluation still reads every row.
  * The run equals, bit for bit, the same command run as two
    ``--multihost`` ranks whose process group the test harness made
    (tests/_torch_mp.py), dropout on in both: the first logged losses,
    rank 0's checkpoint (model and step) and the ranks' step count.
    tests/test_torch_mp_cli.py holds that ``--multihost`` run against one
    rank on the same global rows.
"""

import os
import os.path as osp
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mp
from _torch_mp_cases import MINI_OPTS
from gdm_tpu_torch.data.loader import DataLoader

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
N_FRAMES, BATCH = 5, 2
DEADLINE_S = 150


def _write_tree(root):
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    fps = make_object(128, np.random.RandomState(3), radius=0.05)
    k = np.array([[140.0, 0, 80.0], [0, 140.0, 60.0], [0, 0, 1]],
                 np.float32)
    write_synthetic_bop_root(root, fps, n_frames=N_FRAMES,
                             subsets=("train_pbr",), im_hw=(120, 160), K=k,
                             seed=5, obj_id=1)


def _argv(root, ckpt_root):
    return ["train", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--batch-size", str(BATCH), "--epochs", "1",
            "--ckpt-root", ckpt_root, "--device", "cpu", "--num-workers",
            "1", "--knn-chunk", "64", *MINI_OPTS]


def _first_logged(ckpt_root):
    import json

    with open(osp.join(ckpt_root, "metrics", "ape.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {k: v for k, v in rows[0].items()
            if k not in ("samples_per_sec", "ts")}


def _latest(ckpt_root):
    from gdm_tpu_torch.train.checkpoint import checkpoint_file

    return torch.load(checkpoint_file(osp.join(ckpt_root, "checkpoints",
                                               "ape")), weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("devices_cli")
    root = str(base / "tree")
    _write_tree(root)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    p = subprocess.Popen(
        [sys.executable, "-m", "gdm_tpu_torch.cli",
         *_argv(root, str(base / "devices")), "--devices", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        out, _ = p.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail("cli train --devices 2 passed its deadline of "
                    f"{DEADLINE_S} s:\n" + out.decode(errors="replace")[-3000:])
    assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    multihost = _torch_mp.run("_torch_mp_cases:cli_rank", 2, base, {
        "argv": _argv(root, str(base / "mh{rank}"))})
    try:
        yield {"base": base, "multihost": multihost,
               "devices": (_first_logged(str(base / "devices")),
                           _latest(str(base / "devices"))),
               "mh": (_first_logged(str(base / "mh0")),
                      _latest(str(base / "mh0")))}
    finally:
        shutil.rmtree(base, ignore_errors=True)


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("n", [5, 7, 8])
def test_loader_ranks_take_equal_steps(n):
    train = [DataLoader(_Rows(n), 1, shuffle=True, drop_last=True,
                        num_workers=1, seed=0, rank=r, world=2)
             for r in range(2)]
    lens = [len(dl) for dl in train]
    assert lens == [n // 2] * 2
    seen = np.concatenate([dl.epoch_indices() for dl in train])
    assert len(set(seen.tolist())) == n - n % 2
    evals = [DataLoader(_Rows(n), 1, rank=r, world=2) for r in range(2)]
    every = np.concatenate([dl.epoch_indices() for dl in evals])
    assert sorted(every.tolist()) == list(range(n))
    got = [int(b[0]["i"][0]) for b in evals[0]] + \
        [int(b[0]["i"][0]) for b in evals[1]]
    assert sorted(got) == list(range(n))


def test_devices_ranks_run_equal_steps(runs):
    for r in runs["multihost"]:
        assert len(r["timing"]) == N_FRAMES // BATCH
        assert r["objects"]["ape"]["step"] == N_FRAMES // BATCH
    assert runs["devices"][1]["step"] == N_FRAMES // BATCH
    assert not osp.exists(osp.join(runs["base"], "mh1"))


def test_devices_run_equals_multihost_ranks(runs):
    (log_d, ck_d), (log_m, ck_m) = runs["devices"], runs["mh"]
    assert log_d == log_m
    assert ck_d["epoch"] == ck_m["epoch"] == 0
    assert ck_d["model_state"].keys() == ck_m["model_state"].keys()
    for k, v in ck_d["model_state"].items():
        assert torch.equal(v, ck_m["model_state"][k]), k
    state = runs["multihost"][0]["objects"]["ape"]["state"]
    for k, v in ck_d["model_state"].items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)

"""``cli train`` with ``--opt model.compute_dtype=bfloat16 --opt
model.gather_bwd_dtype=bfloat16`` in both packages on the CPU, on the
mini BOP tree of tests/test_data.py from the weights of
tests/test_torch_serve_cli.py: one epoch each, finite losses, and the
port's checkpoint f32, which JAX's ``cli eval --torch-checkpoint`` reads
and evaluates in f32 (a bf16-trained checkpoint is dtype-agnostic).
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from test_data import bop_root  # noqa: F401
from test_torch_bf16_cli import BF16
from test_torch_serve_cli import ckpt, presets  # noqa: F401
from gdm_tpu_torch import cli as cli_t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trains(ckpt, tmp_path_factory):  # noqa: F811
    from gdm_tpu import cli as cli_j

    args = ["train", "--dataset", "lmo", "--data-root", ckpt["root"],
            "--cls-id", "1", "--batch-size", "2", "--epochs", "1",
            "--num-workers", "2", "--knn-chunk", "64", *BF16, "--opt",
            "model.gather_bwd_dtype=bfloat16"]
    roots = {}
    for name, cli, extra in (("jax", cli_j, ["--devices", "1"]),
                             ("port", cli_t, ["--device", "cpu"])):
        roots[name] = str(tmp_path_factory.mktemp(f"bf16_train_{name}"))
        cli.main(args + extra + ["--ckpt-root", roots[name]])
    return roots


def _losses(root):
    with open(osp.join(root, "metrics", "ape.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss"] for r in recs if "loss" in r]


def test_train_runs_in_both_packages(trains):
    for name, root in trains.items():
        losses = _losses(root)
        assert losses and np.isfinite(losses).all(), name


def test_bf16_trained_checkpoint_is_f32_and_evaluates_in_jax(
        trains, ckpt, tmp_path):  # noqa: F811
    from gdm_tpu import cli as cli_j

    ckpt_dir = osp.join(trains["port"], "checkpoints")
    blob = torch.load(osp.join(ckpt_dir, "ape", "geomatch.pth.tar"),
                      weights_only=True)
    assert {v.dtype for k, v in blob["model_state"].items()
            if "num_batches" not in k} == {torch.float32}
    res = cli_j.main(["eval", "--dataset", "lmo", "--data-root",
                      ckpt["root"], "--cls-id", "1", "--batch-size", "2",
                      "--num-workers", "2", "--knn-chunk", "64",
                      "--exact-knn", "--torch-checkpoint", ckpt_dir,
                      "--devices", "1", "--output-dir", str(tmp_path)])
    assert len(res["errors"]["ape"]["ad"]) == 4



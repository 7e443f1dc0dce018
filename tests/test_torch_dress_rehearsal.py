"""The port's dress rehearsal (gdm_tpu_torch.dress_rehearsal) on the CPU
at mini shapes (120x160 frames, 64^2 crops, 256 points, 128-vertex
meshes, the full model widths), 1 epoch of 4 train frames per object at
b=2: every stage runs through the port's cli.main and server, and the
rehearsal's own consistency checks hold at their bounds (eval against
infer + score, infer --stacked against per-object infer, served poses
against the eval CSV)."""

import os.path as osp

import numpy as np
import pytest
import torch

from gdm_tpu_torch import dress_rehearsal

torch.set_num_threads(1)
MINI = ["--device", "cpu", "--epochs", "1", "--frames", "4", "--batch", "2",
        "--opt", "data.img_hw=120,160", "--opt", "data.model_pt_num=128",
        "--opt", "data.num_sample_points=256", "--opt", "data.input_size=64",
        "--opt", "model.n_mesh_node=128", "--opt", "solver.val_batch_size=8"]
STAGES = ["fabricate", "fabricate-test", "train", "eval", "infer", "score",
          "infer-stacked", "export-ape", "export-can", "serve"]


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    d = tmp_path_factory.mktemp("rehearsal")
    out = str(d / "report.md")
    res = dress_rehearsal.run(dress_rehearsal.build_parser().parse_args(
        MINI + ["--out", out, "--keep-root", str(d / "root")]))
    return res, out, str(d / "root")


def test_every_stage_ran(rehearsal):
    res, _, _ = rehearsal
    assert [name for name, _ in res["stages"]] == STAGES
    assert all(s >= 0 for _, s in res["stages"])
    # 2 objects x 4 frames at b=2: 2 steps each
    assert [(r["obj"], r["it"]) for r in res["train"]["timing"]] == [
        ("ape", 0), ("ape", 1), ("can", 0), ("can", 1)]
    assert set(res["train"]["objects"]) == {"ape", "can"}


@pytest.mark.parametrize("check", list(dress_rehearsal.BOUNDS))
def test_consistency_checks_hold(rehearsal, check):
    worst, bound = rehearsal[0]["worst"][check]
    assert bound == dress_rehearsal.BOUNDS[check]
    assert 0.0 <= worst <= bound


def test_eval_ran_vsd_on_both_objects(rehearsal):
    ev = rehearsal[0]["eval"]
    for name in ("ape", "can"):
        assert len(ev["errors"][name]["ad"]) == dress_rehearsal.TEST_FRAMES
        assert np.isfinite(ev["errors"][name]["ad"]).all()
        assert name in ev["bop19_ar"]
    assert "vsd" in ev["table"] and "bop19_ar" in ev["table"]


def test_report_written_and_root_kept(rehearsal):
    res, out, root = rehearsal
    with open(out) as f:
        text = f.read()
    assert text.strip() == res["report"].strip()
    for name in STAGES:
        assert f"| {name} |" in text
    for check in dress_rehearsal.BOUNDS:
        assert check in text
    assert osp.isdir(osp.join(root, "train_pbr")) and osp.isdir(
        osp.join(root, "models_eval"))

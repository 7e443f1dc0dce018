"""``python -m gdm_tpu_torch.cli train`` on the CPU, on the mini BOP tree
of tests/test_data.py (4 train_pbr JPEG frames, batch 2): the metrics
JSONL holds the JAX CLI's keys, checkpoints follow the
``checkpoints/<obj>/epoch_NNNN`` + ``latest`` layout with a
``geomatch.pth.tar`` copy beside them, and a resumed run reproduces the
uninterrupted run's next epoch exactly.

The trained checkpoint goes through both packages' ``cli eval
--torch-checkpoint`` (equal CSV rows), and, on one batch of the four
test frames, through the JAX package's strict import (every flax leaf
must come from the file) and the port's loader, into each package's
eval forward on the same inputs: the seg logits and the scene and mesh
features agree within max|d|/max|ref| <= 1e-4.  After four steps of
training the seg head calls no point foreground, so both CSVs hold the
miss pose on every row; the seg logits' agreement is what makes that
equality mean something.  (Fitted poses and correspondences are
compared in tests/test_torch_cli.py, under weights that fit.)"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_data
from test_data import N_MESH, bop_root  # noqa: F401
from test_torch_cli import _read_csv
from test_torch_dataset import port_config
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights

torch.set_num_threads(1)
JSONL_KEYS = {"ts", "obj", "epoch", "it", "step", "loss", "seg_loss",
              "match_loss", "lr", "bn_momentum", "samples_per_sec",
              "total_notfinite"}


def _train(root, ckpt_root, epochs, resume=False, eval_every=None):
    args = ["train", "--dataset", "lmo", "--data-root", root, "--cls-id",
            "1", "--batch-size", "2", "--epochs", str(epochs),
            "--ckpt-root", ckpt_root, "--device", "cpu", "--num-workers",
            "2", "--knn-chunk", "64", "--opt",
            "solver.checkpoint_every_epochs=1"]
    if resume:
        args.append("--resume")
    if eval_every:
        args += ["--eval-every", str(eval_every)]
    return cli_t.main(args)


@pytest.fixture(scope="module")
def runs(bop_root, tmp_path_factory):  # noqa: F811
    from _pytest.monkeypatch import MonkeyPatch

    mp = MonkeyPatch()
    mp.setitem(configs._PRESETS, "lmo",
               port_config(test_data._mini_config()))
    try:
        straight = str(tmp_path_factory.mktemp("straight"))
        resumed = str(tmp_path_factory.mktemp("resumed"))
        res = _train(bop_root, straight, 2, eval_every=2)
        _train(bop_root, resumed, 1)
        res_r = _train(bop_root, resumed, 2, resume=True)
        yield {"root": bop_root, "straight": straight, "resumed": resumed,
               "res": res, "res_r": res_r, "mp": mp}
    finally:
        mp.undo()


def _blob(ckpt_root, name):
    return torch.load(osp.join(ckpt_root, "checkpoints", "ape", name,
                               "geomatch.pth.tar"), weights_only=True)


def test_checkpoint_layout(runs):
    d = osp.join(runs["straight"], "checkpoints", "ape")
    assert sorted(os.listdir(d)) == ["epoch_0000", "epoch_0001",
                                     "geomatch.pth.tar", "latest"]
    assert open(osp.join(d, "latest")).read() == "epoch_0001"
    blob = _blob(runs["straight"], "epoch_0001")
    assert set(blob) == {"epoch", "step", "model_state", "optimizer_state"}
    assert blob["epoch"] == 1 and blob["step"] == 4
    sd = blob["model_state"]
    assert "awl.params" in sd and "pcd_emb.cnn_up_stages.3.1.0.weight" in sd
    assert set(blob["optimizer_state"]["mu"]) <= set(sd)
    top = torch.load(osp.join(d, "geomatch.pth.tar"), weights_only=True)
    assert all(torch.equal(top["model_state"][k], v) for k, v in sd.items())


def test_metrics_jsonl_keys(runs):
    rows = [json.loads(line) for line in open(osp.join(
        runs["straight"], "metrics", "ape.jsonl"))]
    steps = [r for r in rows if "loss" in r]
    vals = [r for r in rows if "val_add_auc" in r]
    assert len(steps) == 2 and all(set(r) == JSONL_KEYS for r in steps)
    assert [r["step"] for r in steps] == [1, 3]
    assert all(np.isfinite(r["loss"]) for r in steps)
    assert len(vals) == 1 and set(vals[0]) == {
        "ts", "obj", "epoch", "val_add_auc", "val_ad_10", "val_frames"}
    assert vals[0]["val_frames"] == 4
    assert runs["res"]["objects"]["ape"]["val"]["val_frames"] == 4


def test_resume_reproduces_the_next_epoch_exactly(runs):
    a = _blob(runs["straight"], "epoch_0001")
    b = _blob(runs["resumed"], "epoch_0001")
    assert a["step"] == b["step"] == 4
    for k, v in a["model_state"].items():
        assert torch.equal(v, b["model_state"][k]), k
    for part in ("mu", "nu"):
        for k, v in a["optimizer_state"][part].items():
            assert torch.equal(v, b["optimizer_state"][part][k]), (part, k)
    assert int(a["optimizer_state"]["count"]) == 4
    assert len(runs["res_r"]["timing"]) == 2        # epoch 1 only


def test_both_packages_evaluate_the_trained_checkpoint(runs, tmp_path):
    from gdm_tpu import cli as cli_j
    from gdm_tpu.configs import base as cfg_base

    mp = runs["mp"]
    mp.setitem(cfg_base._PRESETS, "lmo", test_data._mini_config())
    common = ["--dataset", "lmo", "--data-root", runs["root"], "--cls-id",
              "1", "--batch-size", "3", "--num-workers", "2",
              "--knn-chunk", "64", "--exact-knn", "--torch-checkpoint",
              osp.join(runs["straight"], "checkpoints")]
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    cli_j.main(["eval", *common, "--devices", "1", "--output-dir", out_j])
    cli_t.main(["eval", *common, "--device", "cpu", "--output-dir", out_t])
    rows_j, keys_j = _read_csv(osp.join(out_j, "gt_lmo-test.csv"))
    rows_t, keys_t = _read_csv(osp.join(out_t, "gt_lmo-test.csv"))
    assert keys_t == keys_j and len(keys_t) == 4
    for k in keys_t:
        np.testing.assert_array_equal(rows_t[k][0], rows_j[k][0])
        np.testing.assert_array_equal(rows_t[k][1], rows_j[k][1])


@pytest.fixture(scope="module")
def trained_outputs(runs):
    """The trained top-level geomatch.pth.tar on one batch of the 4 test
    frames, through the JAX package (strict import into a flax init of
    the same model, eval forward) and through the port
    (weights.read_reference_checkpoint into GeoMatch, as the eval engine
    loads it, eval forward), on the same model inputs: two finalize + KNN
    runs could flip a near-tie neighbour."""
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import import_state_dict
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models import geomatch as geomatch_t
    from gdm_tpu_torch.models import spline_mesh as spline_mesh_t

    root, cfg = runs["root"], configs.get_config("lmo")
    ds = PoseDataset(cfg, 1, "test", data_root=root)
    batch, _ = collate([ds[i] for i in range(len(ds))])
    raw = {k: batch[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop",
                                 "choose", "det")}
    fps = load_or_build_fps_mesh(root, 1, N_MESH)
    fps_mm = np.concatenate([fps[:, :3] * 1000.0, fps[:, 3:]], axis=1)
    mesh = MeshArrays.from_graph(build_mesh_graph(fps_mm, N_MESH))
    fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], approx=False)
    model, init = H.jax_model_and_variables(inputs, mesh)
    sd = weights.read_reference_checkpoint(
        osp.join(runs["straight"], "checkpoints", "ape"))
    params, stats, report = import_state_dict(
        init["params"], init["batch_stats"],
        {k: v.numpy() for k, v in sd.items()}, strict=True)
    out = model.apply({"params": params, "batch_stats": stats}, inputs,
                      mesh, train=False)

    port = geomatch_t.GeoMatch().eval()
    weights.load_reference_state_dict(port, sd)
    mesh_t = geomatch_t.MeshArrays.from_graph(
        spline_mesh_t.build_mesh_graph(fps_mm, N_MESH), "cpu")
    with torch.no_grad():
        out_t = port(H.to_torch(inputs), mesh_t)
    return {"jax": {k: np.asarray(v) for k, v in out.items()},
            "port": {k: v.numpy() for k, v in out_t.items()},
            "unused": report["unused"]}


def test_jax_import_of_the_trained_checkpoint_is_complete(trained_outputs):
    # strict=True raised on any flax leaf missing from the file; of the
    # file, only the training-only loss weights have no eval leaf
    assert set(trained_outputs["unused"]) <= {"awl.params"}


@pytest.mark.parametrize("key", ["seg", "rgbd", "mesh"])
def test_trained_checkpoint_outputs_match_jax(trained_outputs, key):
    got, ref = trained_outputs["port"][key], trained_outputs["jax"][key]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert H.rel_err(got, ref) <= 1e-4, H.rel_err(got, ref)


REFUSED = {
    ("--devices", "100000"): r"--devices 100000 out of range \(1\.\.",
    ("--multihost", "--devices", "2"):
        r"--devices 2 out of range \(1\.\.1 per process\)",
    ("--devices", "2", "--batch-size", "3"):
        "batch 3 not divisible by the data-axis size 2",
    ("--model-shards", "2"): "--model-shards 2 does not divide 1 devices"}


@pytest.mark.parametrize("flag", [list(f) for f in REFUSED])
def test_unported_train_options_raise(runs, flag):
    """What the JAX CLI refuses before it trains, with its messages: more
    ranks than cores (cards, on a GPU), more than one device per process
    of a multihost run, a batch the data ranks do not divide, model shards
    that do not divide the ranks.  (Training on several ranks:
    tests/test_torch_mp_cli.py, tests/test_torch_sp_cli.py.)"""
    with pytest.raises(SystemExit, match=REFUSED[tuple(flag)]):
        cli_t.main(["train", "--dataset", "lmo", "--data-root",
                    runs["root"], "--cls-id", "1", "--device", "cpu",
                    *flag])

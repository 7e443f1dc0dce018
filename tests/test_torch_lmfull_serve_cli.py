"""``cli export-serving | serve --dataset lmfull`` of the port on the CPU,
on the mini LM-full tree of tests/test_torch_lmfull.py, at the preset's
val batch of 8: the artifact's meta carries JAX's export's
``raw_spec`` (64^2 crops, 3072 points), ``icp_reject_m``,
``diameter_m``, ``obj_name`` and ``cls_id``; ``cli serve`` of it answers
the 6 infer frames (one request, padded to 8) with the poses of the
port's ``cli infer`` at the same batch (within 1e-5).  Weights: the port's seeded random weights with the seg head set
so that every point is foreground (every frame runs the full fit)."""

import os
import os.path as osp
import threading

import numpy as np
import pytest
import torch

from test_torch_cli import _read_csv
from test_torch_lmfull import IN_SIZE, N_SAMPLE, N_TEST, OBJ, \
    build_mini_root, patch_presets
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.data.dataset import PoseDataset
from gdm_tpu_torch.data.loader import collate
from gdm_tpu_torch.server import request_poses

torch.set_num_threads(1)
NAME = "eggbox"
BS = 8
META_KEYS = ("raw_spec", "icp_reject_m", "diameter_m", "obj_name", "cls_id")
RAW_KEYS = ("K_crop", "choose", "det", "dpt_scale", "dpt_u16", "rgb_u8")


def all_foreground_weights(seed=0):
    """Seeded random GeoMatch weights whose last seg layer calls every
    point foreground."""
    from gdm_tpu_torch.models.geomatch import GeoMatch

    model = GeoMatch()
    weights.init_random_(model, torch.Generator().manual_seed(seed))
    sd = weights.reference_state_dict(model)
    sd["seg_layer.3.conv.weight"].zero_()
    sd["seg_layer.3.conv.bias"].copy_(torch.tensor([0.0, 1.0]))
    return sd


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu import cli as cli_j

    root = build_mini_root(str(tmp_path_factory.mktemp("lmfull_serve")))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    os.makedirs(osp.join(ckpt, NAME))
    torch.save({"model_state": all_foreground_weights()},
               osp.join(ckpt, NAME, "geomatch.pth.tar"))
    tmp = tmp_path_factory.mktemp("serving")
    mp = MonkeyPatch()
    patch_presets(mp)
    try:
        export = ["export-serving", "--dataset", "lmfull", "--data-root",
                  root, "--torch-checkpoint", ckpt, "--cls-id", str(OBJ),
                  "--batch-size", str(BS), "--exact-knn"]
        meta_j = cli_j.main([*export, "--platforms", "cpu", "--out",
                             str(tmp / "jax" / NAME)])
        meta_t = cli_t.main([*export, "--device", "cpu", "--out",
                             str(tmp / "serving" / NAME)])
        infer_csv = str(tmp / "infer.csv")
        cli_t.main(["infer", "--dataset", "lmfull", "--data-root", root,
                    "--torch-checkpoint", ckpt, "--cls-id", str(OBJ),
                    "--batch-size", str(BS), "--exact-knn", "--num-workers",
                    "2", "--device", "cpu", "--output", infer_csv])
        ds = PoseDataset(configs.get_config("lmfull"), OBJ, "infer",
                         data_root=root)
        batch, meta = collate([ds[i] for i in range(len(ds))])
        raw = {k: batch[k] for k in RAW_KEYS}
    finally:
        mp.undo()
    # the artifact rebuilds its model from its own config: no preset patch
    service, server = cli_t.start_server(cli_t.build_parser().parse_args(
        ["serve", "--artifact", str(tmp / "serving"), "--device", "cpu",
         "--port", "0"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    try:
        poses, _ = request_poses(url, raw, obj=NAME)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {"meta_j": meta_j, "meta_t": meta_t, "infer_csv": infer_csv,
            "names": [m["file_name"] for m in meta], "poses": poses,
            "engine": service.engines[NAME]}


def test_export_meta_matches_jax(served):
    meta_t, meta_j = served["meta_t"], served["meta_j"]
    for k in META_KEYS:
        assert meta_t[k] == meta_j[k], k
    spec = meta_t["raw_spec"]
    assert tuple(spec["choose"][0]) == (BS, N_SAMPLE)
    assert tuple(spec["rgb_u8"][0]) == (BS, IN_SIZE, IN_SIZE, 3)
    assert meta_t["obj_name"] == NAME and meta_t["cls_id"] == OBJ
    assert served["engine"].meta["raw_spec"] == meta_j["raw_spec"]


def test_served_poses_equal_cli_infer(served):
    rows, keys = _read_csv(served["infer_csv"])
    assert len(keys) == len(served["names"]) == N_TEST
    poses = served["poses"]
    assert poses.shape == (N_TEST, 3, 4)
    fitted = 0
    for name, pose in zip(served["names"], poses):
        s, im = (int(v) for v in name.split("/"))
        R, t = rows[(s, im, OBJ)]
        np.testing.assert_allclose(pose[:, :3], R, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pose[:, 3], t, rtol=0, atol=1e-5)
        fitted += pose[2, 3] > -999.0
    assert fitted == N_TEST

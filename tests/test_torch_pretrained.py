"""``--pretrained-backbone``: a torchvision-named ResNet state dict into
the port's CNN trunk (gdm_tpu_torch/train/import_torch.py) against the
JAX package's ``load_pretrained_backbone``.

The file is built as tests/test_import_torch.py builds it (random
tensors of the flax trunk's shapes under torchvision's names, with the
``fc`` head and one ``num_batches_tracked`` that a real file carries) and
saved as ``.pth`` and ``.npz``.  The port's GeoMatch holds the JAX init
(through export_state_dict); after the load every tensor of its trunk is
bit-equal to JAX's loaded trunk read through export_state_dict, every
other tensor is untouched, and ``bn1.num_batches_tracked`` is the
file's.  A shape mismatch and a missing key raise; ``cli train
--pretrained-backbone`` starts from the file's tensors."""

import os.path as osp

import numpy as np
import pytest
import torch

import test_data
from test_data import bop_root  # noqa: F401
import test_import_torch
from test_import_torch import trees  # noqa: F401
from test_torch_dataset import port_config
from gdm_tpu_torch import cli as cli_t
from gdm_tpu_torch import configs, weights
from gdm_tpu_torch.models.geomatch import GeoMatch
from gdm_tpu_torch.train import import_torch

torch.set_num_threads(1)


class _State:
    """The params / batch_stats / replace of a flax TrainState."""

    def __init__(self, params, batch_stats):
        self.params, self.batch_stats = params, batch_stats

    def replace(self, **kw):
        return _State(kw.get("params", self.params),
                      kw.get("batch_stats", self.batch_stats))


@pytest.fixture(scope="module")
def tv(trees, tmp_path_factory):  # noqa: F811
    """The torchvision-named file (.pth and .npz), the JAX init and JAX's
    load of the file, both as reference-named dicts."""
    from gdm_tpu.train.import_torch import (
        export_state_dict,
        load_pretrained_backbone,
    )

    params, stats = trees
    sd = test_import_torch.TestTorchvisionBackbone._tv_state(
        None, params, stats, np.random.RandomState(6))
    d = tmp_path_factory.mktemp("tv")
    np.savez(d / "resnet18.npz", **sd)
    torch.save({k: torch.from_numpy(np.asarray(v).copy())
                for k, v in sd.items()}, str(d / "resnet18.pth"))
    got = load_pretrained_backbone(_State(params, stats), sd)
    return {"sd": sd, "dir": d,
            "init": export_state_dict(params, stats),
            "jax": export_state_dict(got.params, got.batch_stats)}


def _port_model(init):
    model = GeoMatch().eval()
    weights.load_reference_state_dict(model, init)
    return model


@pytest.mark.parametrize("ext", ["pth", "npz"])
def test_trunk_bit_equal_to_jax_and_nothing_else_moves(tv, ext):
    model = _port_model(tv["init"])
    import_torch.load_pretrained_backbone(
        model, str(tv["dir"] / f"resnet18.{ext}"))
    got = weights.reference_state_dict(model)
    n_trunk = 0
    for k, v in got.items():
        tvk = import_torch.torchvision_key(k)
        if k.endswith("num_batches_tracked"):
            want = 7 if tvk == "bn1.num_batches_tracked" else 0
            assert int(v) == want, k
        elif tvk is not None:
            n_trunk += 1
            np.testing.assert_array_equal(v.numpy(), tv["jax"][k], err_msg=k)
            np.testing.assert_array_equal(v.numpy(), tv["sd"][tvk],
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), tv["init"][k],
                                          err_msg=k)
    # conv1, bn1 (4), 8 blocks x (2 convs + 2 BNs x 4), 3 downsamples
    # x (conv + BN x 4)
    assert n_trunk == 1 + 4 + 8 * 10 + 3 * 5


def test_report_leaves_out_the_head(tv):
    """fc.* and num_batches_tracked go unreported; any other name of the
    file that loads nowhere is reported."""
    sd = dict(tv["sd"], **{"extra.weight": np.zeros(3, np.float32)})
    assert import_torch.import_torchvision_resnet(
        _port_model(tv["init"]), sd) == {"unused": ["extra.weight"]}


@pytest.mark.parametrize("case", ["shape", "missing"])
def test_bad_file_raises(tv, case):
    sd = dict(tv["sd"])
    if case == "shape":     # resnet34's wider layer into resnet18's
        sd["layer1.0.conv1.weight"] = np.zeros((65, 64, 3, 3), np.float32)
        err, match = ValueError, "shape mismatch"
    else:
        del sd["layer3.1.bn2.running_var"]
        err, match = KeyError, "layer3.1.bn2.running_var"
    with pytest.raises(err, match=match):
        import_torch.import_torchvision_resnet(_port_model(tv["init"]), sd)


@pytest.fixture(scope="module")
def mini_preset():
    from _pytest.monkeypatch import MonkeyPatch

    mp = MonkeyPatch()
    mp.setitem(configs._PRESETS, "lmo",
               port_config(test_data._mini_config()))
    yield
    mp.undo()


def test_cli_train_starts_from_the_file(tv, bop_root,  # noqa: F811
                                        mini_preset, tmp_path, monkeypatch):
    """The model that train builds holds the file's trunk once loaded (a
    wrapper records it before the first step); the run trains on."""
    seen = []
    load = import_torch.load_pretrained_backbone

    def recording(model, w):
        out = load(model, w)
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        return out

    monkeypatch.setattr(import_torch, "load_pretrained_backbone", recording)
    args = ["train", "--dataset", "lmo", "--data-root", bop_root,
            "--cls-id", "1", "--batch-size", "2", "--epochs", "1",
            "--ckpt-root", str(tmp_path / "log"), "--device", "cpu",
            "--num-workers", "2", "--knn-chunk", "64",
            "--pretrained-backbone", str(tv["dir"] / "resnet18.pth")]
    res = cli_t.main(args)
    assert len(seen) == 1 and len(res["timing"]) == 2
    n = 0
    for k, v in seen[0].items():
        tvk = import_torch.torchvision_key(k)
        if tvk is not None and tvk in tv["sd"]:
            np.testing.assert_array_equal(v.numpy(), tv["sd"][tvk],
                                          err_msg=k)
            n += 1
    assert n == 101
    assert osp.exists(tmp_path / "log" / "checkpoints" / "ape" / "latest")
    with pytest.raises(SystemExit, match="randla_spline"):
        cli_t.main(args + ["--opt", "model.backbone=dgcnn"])

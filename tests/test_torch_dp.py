"""The port's train step (train/step.py) on gloo CPU ranks against one
rank on the same global batch, at the full model widths, in float64
without dropout: 4 train frames of the mini BOP tree (tests/test_data.py)
as one batch, two steps, on (data, model) grids of 2 x 1 (data
parallel), 1 x 2 (the matching loss's mesh columns split) and 2 x 2.

Each rank holds its data rank's rows; the batch norms take the global
batch's moments, the losses reduce over the data column (and the mesh
columns over the model row), and the gradients are averaged over every
rank (parallel/mesh.py).  Held: each step's losses within 1e-10
relative, every gradient tensor of the first step within 1e-8 (max|d| /
max|ref|; those that a batch norm cancels below 1e-12), and the
parameters and batch-norm running statistics after the second step equal
on every rank and within 1e-8 (the statistics) and 1e-6 (the parameters,
after Adam's normalised steps; not those whose gradient a batch norm
cancels) of the one-rank run's.  float64 makes the comparison tight: in
f32 the global moments' two-stage sums differ from the one-rank means
in the last bits, and a train step at these sizes amplifies that (see
tests/test_torch_train.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_harness as H
import _torch_mp
import _torch_mp_cases as C
import test_data
from test_data import N_MESH, bop_root  # noqa: F401
from test_torch_dataset import port_config

torch.set_num_threads(1)
LOSS_TOL, TOL = 1e-10, 1e-8
ZERO = 1e-12        # gradients the batch norms cancel (f64 rounding left)
# Adam divides each gradient by its own root mean square: the last bits
# of a small gradient move the parameter by a larger share of lr (and a
# gradient the batch norms cancel, by lr itself: those are not compared)
PARAM_TOL = 1e-6
GRIDS = [(2, 1), (1, 2), (2, 2)]               # (data, model)


@pytest.fixture(scope="module")
def problem(bop_root):  # noqa: F811
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import finalize_batch, to_device
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.train.step import BATCH_KEYS, train_inputs

    cfg = port_config(test_data._mini_config())
    ds = PoseDataset(cfg, 1, "train", data_root=bop_root,
                     rng=np.random.RandomState(0), diameter_m=0.1)
    batch, _ = collate([ds[i] for i in range(len(ds))])
    with torch.no_grad():
        fin = finalize_batch(to_device({k: batch[k] for k in BATCH_KEYS},
                                       "cpu"))
        inputs = train_inputs(fin, 0.02, knn_chunk=64)
    inputs = {k: (v.double() if v.is_floating_point() else v).numpy()
              for k, v in inputs.items()}
    fps = load_or_build_fps_mesh(bop_root, 1, N_MESH)
    payload = {"cfg": dataclasses.asdict(cfg), "seed": 3, "steps": 2,
               "inputs": inputs,
               "fps_mm": np.concatenate([fps[:, :3] * 1000.0, fps[:, 3:]],
                                        axis=1)}
    model, mesh, state = C.train_model(payload)
    return payload, C.run_steps(model, mesh, state, inputs, 2)


@pytest.fixture(scope="module", params=GRIDS, ids=["2x1", "1x2", "2x2"])
def ranks(request, problem, tmp_path_factory):
    data, model = request.param
    payload, _ = problem
    return _torch_mp.run("_torch_mp_cases:train_steps", data * model,
                         tmp_path_factory.mktemp("dp"),
                         dict(payload, shards=model))


def test_step_losses_match_one_rank(ranks, problem):
    ref = problem[1]["losses"]
    assert ref[0]["match_loss"] > 0 and np.isfinite(ref[1]["loss"])
    for r in ranks:
        for got, want in zip(r["losses"], ref):
            for k, v in want.items():
                assert abs(got[k] - v) <= LOSS_TOL * abs(v), (k, got[k], v)


def test_gradients_match_one_rank(ranks, problem):
    ref = problem[1]["grads"]
    for r in ranks:
        assert set(r["grads"]) == set(ref)
        for k, want in ref.items():
            if np.abs(want).max() < ZERO:
                # a bias ahead of a batch norm: zero but for rounding
                assert np.abs(r["grads"][k]).max() < ZERO, k
                continue
            assert H.rel_err(r["grads"][k], want) <= TOL, \
                (k, H.rel_err(r["grads"][k], want))


def test_state_after_steps_equal_on_ranks_and_to_one_rank(ranks, problem):
    ref = problem[1]["state"]
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    noise = {k for k, g in problem[1]["grads"].items()
             if np.abs(g).max() < ZERO}
    assert 0 < len(noise) < 10, noise
    for k, want in ref.items():
        got = ranks[0]["state"][k]
        if k in noise:
            # Adam scales a zero-but-for-rounding gradient to a step of lr
            continue
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            tol = TOL if k in stats else PARAM_TOL
            assert H.rel_err(got, want) <= tol, (k, H.rel_err(got, want))


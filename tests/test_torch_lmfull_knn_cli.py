"""JAX's ``cli eval --dataset lmfull`` in its default KNN mode (no
--exact-knn: ``lax.approx_max_k`` in the pyramid) against the port's
``cli eval --device cpu``, on the mini LM-full tree and weights of
tests/test_torch_lmfull_cli.py, under that file's rules: the same CSV
rows, fg mask and Kabsch weights, correspondences equal beyond near-ties
(and where the scene features agree), poses within 1e-4 on frames whose
weighted correspondences agree.  Off the TPU, approx_max_k is the exact
top-k (tests/test_torch_lmfull.py), so the port's one mode stands for
both of JAX's."""

import pytest
import torch

from test_torch_lmfull_cli import check_fits, check_poses, \
    check_rows_and_batches, cli_runs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = cli_runs(tmp_path_factory, approx=True)
    yield r
    r["mp"].undo()


def test_csv_rows_and_batches(runs):
    check_rows_and_batches(runs)


def test_fits_agree_in_process(runs):
    check_fits(runs)


def test_poses_agree_where_correspondences_agree(runs):
    check_poses(runs)

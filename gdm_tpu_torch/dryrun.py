"""Multi-rank dry runs of the port.

    python -m gdm_tpu_torch.dryrun [N]                # N cards, NCCL
    python -m gdm_tpu_torch.dryrun [N] --device cpu   # N gloo CPU ranks

N defaults to 4.  On ``cuda`` (the default) rank r runs on cuda:r and the
ranks meet over NCCL; ``--device cpu`` runs gloo ranks on the CPU.

Counterparts of __graft_entry__.py's ``dryrun_dp``, ``dryrun_model_axis``
and ``dryrun_mp_combined``, at their tiny shapes (64 mesh vertices, 256
points, a 64^2 crop; the full model widths) on random inputs made from a
seed.  Each stage starts its ranks (torch.multiprocessing, spawn), which
meet through a file store in a temporary directory:

  * ``dp``: N ranks, one full GeoMatch train step (forward, backward,
    the gradients' mean, Adam) on one row each; the loss is finite and
    equal on every rank;
  * ``model_axis``: a (N/2, 2) grid: the argmax split over the model row
    (parallel/sp.sharded_cosine_argmax; the similarity kernel on a card)
    equals the plain argmax over all columns beyond near-ties, then one full train step with the matching
    loss's mesh columns split (parallel/sp.sharded_matching_loss);
  * ``combined``: a (2, 2) grid, four ranks, both axes crossing process
    boundaries: the sharded matching loss and its gradients against the
    dense loss of the global batch computed on every rank (loss within
    2e-5 relative, gradients as the mean over ranks within 1e-4).

Rank 0 prints one line per stage; a failed check or rank fails the run.
"""

from __future__ import annotations

import argparse
import datetime
import os.path as osp
import tempfile

import numpy as np
import torch

N_MESH, N_SAMPLE, IM = 64, 256, 64
GAP = 1e-5      # a top-2 gap below this is a near-tie: either index holds


def _problem(batch: int, seed: int = 0):
    """(fps [m, 9] mm, loader-style train batch of ``batch`` rows)."""
    from gdm_tpu_torch.data.synthetic import make_object

    rng = np.random.RandomState(seed)
    fps = make_object(N_MESH, rng, radius=0.08)
    dpt = (4000 + 2000 * rng.rand(batch, IM, IM)).astype(np.uint16)
    k = np.array([[572.4, 0, IM / 2], [0, 573.6, IM / 2], [0, 0, 1]],
                 np.float32)
    rt = np.tile(np.hstack([np.eye(3), [[0.0], [0.0], [0.5]]]),
                 (batch, 1, 1)).astype(np.float32)
    return fps, {
        "rgb_u8": rng.randint(0, 255, (batch, IM, IM, 3)).astype(np.uint8),
        "dpt_u16": dpt,
        "dpt_scale": np.full((batch,), 10000.0, np.float32),
        "K_crop": np.tile(k, (batch, 1, 1)),
        "choose": rng.randint(0, IM * IM, (batch, N_SAMPLE)).astype(np.int32),
        "labels": (rng.rand(batch, N_SAMPLE) < 0.5).astype(np.uint8),
        "match_idx": rng.randint(0, N_MESH + 1, (batch, N_SAMPLE)).astype(
            np.uint16),
        "visible_flag": (rng.rand(batch, N_MESH) < 0.8).astype(np.uint8),
        "RT": rt,
    }


def _train_step(grid, batch_rows: int, device) -> float:
    """One train step of GeoMatch on this rank's rows of a global batch
    of ``batch_rows``; returns the (global) loss."""
    from gdm_tpu_torch import configs, weights
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.parallel import mesh as pmesh
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    cfg = configs.get_config("lmo", [
        f"data.model_pt_num={N_MESH}", f"model.n_mesh_node={N_MESH}",
        f"data.num_sample_points={N_SAMPLE}", f"data.input_size={IM}"])
    fps, batch = _problem(batch_rows)
    model, mesh, _, _ = build_model(cfg, fps, device, awl=True)
    weights.init_random_(model, torch.Generator().manual_seed(0))
    model.to(device)
    pmesh.attach(model, grid)
    pmesh.broadcast_module(model, grid)
    n = batch_rows // grid.data_size
    rows = slice(grid.data_rank * n, (grid.data_rank + 1) * n)
    step = make_train_step(lambda _: 0.1, 0.01, knn_chunk=128, grid=grid)
    state = create_train_state(model, lambda _: 1e-3)
    loss = float(step(state, {k: v[rows] for k, v in batch.items()}, mesh,
                      1)["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"rank {grid.rank}: loss {loss}")
    return loss


def _all_equal(value: float, grid) -> list:
    from gdm_tpu_torch.parallel.mesh import all_gather_host

    vals = all_gather_host(value, grid)
    if len(set(vals)) != 1:
        raise RuntimeError(f"ranks disagree: {vals}")
    return vals


def stage_dp(grid, device) -> str:
    loss = _train_step(grid, grid.world, device)
    _all_equal(loss, grid)
    return f"dp: {grid.world} ranks, full train step loss={loss:.4f} ok"


def stage_model_axis(grid, device) -> str:
    from gdm_tpu_torch.ops.similarity import cosine_argmax_reference
    from gdm_tpu_torch.parallel.sp import sharded_cosine_argmax

    rng = np.random.RandomState(0)
    b, npts, c, mcols = grid.data_size, 64, 16, 64
    scene = torch.from_numpy(rng.randn(b, npts, c).astype(np.float32))
    meshf = torch.from_numpy(rng.randn(mcols, c).astype(np.float32))
    rows = slice(grid.data_rank, grid.data_rank + 1)
    idx, score = sharded_cosine_argmax(scene[rows].to(device),
                                       meshf.to(device), grid)
    f = torch.nn.functional.normalize(scene[rows], dim=-1).reshape(-1, c)
    g = torch.nn.functional.normalize(meshf, dim=-1)
    want, want_score = cosine_argmax_reference(f, g)
    top2 = torch.topk(f @ g.T, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > GAP
    bad = int(((idx.reshape(-1).cpu() != want) & sure).sum())
    err = float((score.reshape(-1).cpu() - want_score).abs().max())
    if bad or err > GAP:
        raise RuntimeError(f"rank {grid.rank}: sharded argmax differs ({bad} "
                           f"indices beyond near-ties, |dscore| {err})")
    loss = _train_step(grid, max(2, grid.data_size), device)
    _all_equal(loss, grid)
    return (f"model_axis: ({grid.data_size}, {grid.model_shards}) grid, "
            f"argmax equal beyond near-ties, full sharded-loss train step "
            f"loss={loss:.4f} ok")


def stage_combined(grid, device) -> str:
    import torch.distributed as dist

    from gdm_tpu_torch.losses.matching import pointwise_matching_loss
    from gdm_tpu_torch.parallel.sp import sharded_matching_loss

    rng = np.random.RandomState(5)
    b, n, c, m = 4, 48, 16, 32
    rgbd, meshf, xyz, labels, midx, vis = (torch.from_numpy(a).to(device)
                                           for a in (
        rng.randn(b, n, c).astype(np.float32),
        rng.randn(m, c).astype(np.float32),
        ((rng.rand(m, 3) - 0.5) * 0.1).astype(np.float32),
        (rng.rand(b, n) < 0.7).astype(np.int64),
        rng.randint(0, m + 1, (b, n)),
        (rng.rand(b, m) < 0.8).astype(np.int64)))
    rows = slice(grid.data_rank * b // grid.data_size,
                 (grid.data_rank + 1) * b // grid.data_size)
    f = rgbd[rows].clone().requires_grad_()
    g = meshf.clone().requires_grad_()
    loss = sharded_matching_loss(f, g, xyz, labels[rows], midx[rows],
                                 vis[rows], 0.04, grid)
    loss.backward()
    fd, gd = rgbd.clone().requires_grad_(), meshf.clone().requires_grad_()
    ref = pointwise_matching_loss(fd, gd, xyz, labels, midx, vis, 0.04)
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    if abs(loss - ref) > 2e-5 * abs(ref):
        raise RuntimeError(f"rank {grid.rank}: loss {loss} against the "
                           f"dense {ref}")
    # the loss's gradient is the sum of the ranks' over the copies of a
    # tensor, over the number of ranks (parallel/mesh.py)
    gf = torch.zeros_like(rgbd)
    gf[rows] = f.grad
    gg = g.grad.clone()
    for t in (gf, gg):
        dist.all_reduce(t)
    for got, want in ((gf / grid.world, fd.grad), (gg / grid.world, gd.grad)):
        err = float((got - want).abs().max() / want.abs().max())
        if err > 1e-4:
            raise RuntimeError(f"rank {grid.rank}: gradient off by {err}")
    _all_equal(loss, grid)
    return (f"combined: (2, 2) grid, sharded loss={loss:.4f} and "
            "its gradients equal the dense ones ok")


STAGES = {"dp": (stage_dp, 1), "model_axis": (stage_model_axis, 2),
          "combined": (stage_combined, 2)}


def _rank(rank: int, world: int, store: str, stage: str,
          device: str) -> None:
    import torch.distributed as dist

    from gdm_tpu_torch.parallel.mesh import make_grid

    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        fn, shards = STAGES[stage]
        msg = fn(make_grid(shards),
                 torch.device("cuda", rank) if device == "cuda" else device)
        if rank == 0:
            print(f"dryrun {msg}", flush=True)
    finally:
        dist.destroy_process_group()


def run_stage(stage: str, world: int, device: str) -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(world, osp.join(d, "store"), stage,
                                        device),
                           nprocs=world, start_method="spawn")


def dryrun(n_ranks: int = 4, device: str = "cuda") -> None:
    """The stages that ``n_ranks`` allows: dp always, model_axis from 2
    (even), combined from 4; ``device`` 'cuda' (rank r on cuda:r, NCCL)
    or 'cpu' (gloo)."""
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device {device}: 'cuda' or 'cpu'")
    if device == "cuda":
        avail = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if not 1 <= n_ranks <= avail:
            raise SystemExit(f"{n_ranks} ranks out of range (1..{avail} "
                             "cards; pass --device cpu for gloo CPU ranks)")
    run_stage("dp", n_ranks, device)
    if n_ranks >= 2 and n_ranks % 2 == 0:
        run_stage("model_axis", n_ranks, device)
    if n_ranks >= 4:
        run_stage("combined", 4, device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m gdm_tpu_torch.dryrun")
    ap.add_argument("ranks", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r, NCCL) or cpu (gloo)")
    a = ap.parse_args()
    dryrun(a.ranks, a.device)

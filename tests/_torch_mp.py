"""Gloo CPU ranks for the port's multi-process tests.

``run(target, world, tmp_path, payload)`` starts ``world`` processes of
this file.  Each joins a gloo process group through a FileStore in a
fresh directory under ``tmp_path`` (never a fixed port, so parallel test
workers never collide), with its own collective timeout, calls
``target`` ("module:function", importable from tests/) as
``fn(rank, world, payload)`` and pickles what it returns.  The parent
waits for all of them within one deadline; a rank that fails, or the
deadline, kills the others and fails the test with each rank's log tail.

The ranks block jax, flax and gdm_tpu: only the port runs in them.
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import pickle
import subprocess
import sys
import tempfile
import time

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
DEADLINE_S = 150            # one run of ranks, start-up included
COLLECTIVE_TIMEOUT_S = 90   # one collective


def run(target: str, world: int, tmp_path, payload=None,
        deadline: float = DEADLINE_S, env: dict | None = None) -> list:
    """Every rank's result, in rank order."""
    d = tempfile.mkdtemp(prefix="ranks_", dir=str(tmp_path))
    with open(osp.join(d, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    full_env = dict(os.environ, OMP_NUM_THREADS="1",
                    PYTHONPATH=os.pathsep.join(
                        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    full_env.update(env or {})
    logs = [open(osp.join(d, f"log{r}.txt"), "wb") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, osp.abspath(__file__), target, str(r), str(world),
         d], env=full_env, cwd=ROOT, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    end = time.monotonic() + deadline
    failed = None
    try:
        pending = list(procs)
        while pending and failed is None:
            for p in list(pending):
                if p.poll() is not None:
                    pending.remove(p)
                    if p.returncode != 0:
                        failed = f"rank {procs.index(p)} exited " \
                                 f"{p.returncode}"
            if time.monotonic() > end:
                failed = f"deadline of {deadline} s passed"
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed is not None:
        tails = "\n".join(
            f"--- rank {r} ---\n" + open(osp.join(d, f"log{r}.txt"),
                                         errors="replace").read()[-3000:]
            for r in range(world))
        raise AssertionError(f"{target} on {world} ranks: {failed}\n{tails}")
    out = []
    for r in range(world):
        with open(osp.join(d, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank(target: str, rank: int, world: int, d: str) -> None:
    for name in ("jax", "flax", "gdm_tpu"):     # the port runs alone
        sys.modules[name] = None
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + osp.join(d, "store"), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        with open(osp.join(d, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        module, _, fn = target.partition(":")
        result = getattr(importlib.import_module(module), fn)(
            rank, world, payload)
        with open(osp.join(d, f"out{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(osp.join(d, f"out{rank}.pkl.tmp"),
                   osp.join(d, f"out{rank}.pkl"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

"""One b=128 eval batch of the port's engine on the card, YCB-V against
LM-O at the same widths, with and without the depth fill: each case's
engine run timed (5 runs after a warm-up) and profiled (top CUDA
kernels by device time).  Needs a CUDA card; run from the repo root:

    python3 scripts/profile_ycbv_eval.py
"""

import dataclasses
import os.path as osp
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (blocks jax, flax and gdm_tpu)
from gdm_tpu_torch import refdata  # noqa: E402
from gdm_tpu_torch.configs import LMO, YCBV  # noqa: E402
from gdm_tpu_torch.data.dataset import PoseDataset  # noqa: E402
from gdm_tpu_torch.data.loader import collate, pad_batch  # noqa: E402
from gdm_tpu_torch.data.ply import load_or_build_fps_mesh  # noqa: E402
from gdm_tpu_torch.data.synthetic import (  # noqa: E402
    make_object,
    write_synthetic_bop_root,
)
from gdm_tpu_torch.serve import PoseEngine  # noqa: E402

BATCH = 128


def engine_and_batch(cfg, root, n_real, fill):
    """A PoseEngine of object 1 (seeded random weights) and a loader
    batch of ``n_real`` frames padded to BATCH."""
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, fill_depth=fill))
    ds = PoseDataset(cfg, 1, "test", data_root=root)
    raw, _ = collate([ds[i] for i in range(n_real)])
    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    fps[:, :3] *= 1000.0
    engine = PoseEngine(cfg, fps, chip_smoke.random_weights(cfg), "cuda",
                        batch=BATCH, knn_chunk=512)
    return engine, pad_batch({k: raw[k] for k in engine.meta["raw_spec"]},
                             BATCH)


def time_and_profile(engine, raw, tag):
    from torch.profiler import ProfilerActivity, profile

    engine.run(raw)
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.run(raw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"{tag}: run ms {' '.join(f'{t:.2f}' for t in ms)}, median "
          f"{np.median(ms):.2f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run(raw)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=14, max_name_column_width=60),
          flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    diameter_mm = refdata.get("ycbv").diameters_mm_by_id[1]
    with tempfile.TemporaryDirectory() as wd:
        ycbv_root, lmo_root = osp.join(wd, "ycbv"), osp.join(wd, "lmo")
        write_synthetic_bop_root(ycbv_root, make_object(
            4096, np.random.RandomState(5), radius=diameter_mm / 2500.0),
            n_frames=16, seed=5)
        write_synthetic_bop_root(lmo_root, make_object(
            4096, np.random.RandomState(0)), n_frames=16, seed=0)
        for tag, cfg, root, n_real, fill in (
                ("lmo 16 real", LMO, lmo_root, 16, False),
                ("ycbv mesh, lmo preset (no fill) 16 real", LMO, ycbv_root,
                 16, False),
                ("ycbv preset, fill 16 real", YCBV, ycbv_root, 16, True),
                ("ycbv preset, no fill 16 real", YCBV, ycbv_root, 16, False),
                ("ycbv preset, fill 8 real", YCBV, ycbv_root, 8, True),
                ("lmo 8 real", LMO, lmo_root, 8, False)):
            engine, raw = engine_and_batch(cfg, root, n_real, fill)
            time_and_profile(engine, raw, tag)
            del engine
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

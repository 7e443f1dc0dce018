"""Where the train-to-pose demo's DGCNN loses its pose at LM-full's shapes:
the segmentation or the correspondences.

    python3 scripts/dgcnn_lmfull_seg.py [--repeats 3] [--frames 12,64]
        [--eval-at 120] [--backbone dgcnn] [demo flags ...]

Trains ``gdm_tpu_torch.train_synthetic_demo``'s problem (default: DGCNN
at LM-full's shapes, 12800 points, a 4096-vertex mesh, b=6, 120 steps)
``--repeats`` times from the same seed for each train-frame count in
``--frames``, on the card, and at each step of ``--eval-at`` prints for
the 6 test frames: the mean ADD and each frame's, the mean ADD of the
fit on the same correspondences with the GT foreground as the Kabsch
weights (what the correspondences alone give), the background points
called foreground and those of them beyond 1 m (the synthetic
background plane lies 1.5 m away), and the foreground points missed.
Repeats of one seed differ only by the card's nondeterministic
reductions.  Ends with the card's name and power limit.
"""

import argparse
import os.path as osp
import subprocess
import sys
import time

for _name in ("jax", "flax", "gdm_tpu"):   # the port runs alone
    sys.modules[_name] = None
sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

LMFULL = ["--im", "128", "--n-sample", "12800", "--n-mesh", "4096",
          "--batch", "6", "--steps", "120"]


def run(demo_argv, eval_at, tag):
    from gdm_tpu_torch import train_synthetic_demo as demo
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.eval.metrics import add_err
    from gdm_tpu_torch.ops.kabsch import weighted_kabsch
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    args = demo.build_parser().parse_args(demo_argv)
    prob = demo.Problem(args, "cuda")
    weights.init_random_(prob.model, torch.Generator().manual_seed(args.seed))
    prob.model.to("cuda")
    state = create_train_state(prob.model, cyclic_lr(
        1e-5, 1e-3, max(args.steps // 6, 1)))
    step = make_train_step(bn_momentum_schedule(batch_size=args.batch),
                           demo.POSITIVE_R, needs_pyramid=not prob.dgcnn)
    nb = args.n_train_frames // args.batch
    batches = [prob.inputs(prob.train_data,
                           np.s_[i * args.batch:(i + 1) * args.batch])
               for i in range(nb)]
    fg = prob.test_data["labels"] > 0
    far = prob.test_data["cld_rgb_nrm"][..., 2] > 1.0
    cld = torch.as_tensor(prob.test_data["cld_rgb_nrm"][..., :3],
                          device="cuda")
    gt = prob.test_poses
    t0 = time.perf_counter()
    for it in range(args.steps):
        m = step(state, batches[it % nb], prob.mesh, args.seed + 7)
        if it + 1 not in eval_at:
            continue
        ev = prob.evaluate()
        w = ev["weights"].cpu().numpy() > 0
        rt = weighted_kabsch(prob.mesh_xyz[ev["idx"]], cld, torch.as_tensor(
            fg, dtype=torch.float32, device="cuda"))
        oracle = np.mean([add_err(p[:, :3], p[:, 3], g[:, :3], g[:, 3],
                                  prob.mesh_pts)
                          for p, g in zip(rt.cpu().numpy().astype(
                              np.float64), gt)])
        frames = [round(add_err(p[:, :3], p[:, 3], g[:, :3], g[:, 3],
                                prob.mesh_pts) * 1e3, 1)
                  for p, g in zip(ev["poses"], gt)]
        print(f"{tag} step {it + 1}: ADD {ev['add'] * 1e3:.2f} mm (frames "
              f"{frames}); with the GT foreground as weights "
              f"{oracle * 1e3:.2f} mm; background called foreground "
              f"{int((w & ~fg).sum())} (beyond 1 m {int((w & far).sum())}),"
              f" foreground missed {int((~w & fg).sum())} of "
              f"{int(fg.sum())}; loss {float(m['loss']):.4f} seg "
              f"{float(m['seg_loss']):.4f} ({time.perf_counter() - t0:.1f}"
              " s)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--frames", default="12,64",
                    help="train-frame counts, comma-separated")
    ap.add_argument("--eval-at", default="120",
                    help="steps after which to evaluate, comma-separated")
    args, demo_argv = ap.parse_known_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from gdm_tpu_torch import _build

    _build.build_all(["similarity", "radius_nn"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    demo_argv = LMFULL + (demo_argv or ["--backbone", "dgcnn"])
    eval_at = {int(x) for x in args.eval_at.split(",")}
    for frames in args.frames.split(","):
        for r in range(args.repeats):
            run(demo_argv + ["--n-train-frames", frames], eval_at,
                f"{' '.join(demo_argv[10:])} {frames} frames, repeat {r}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

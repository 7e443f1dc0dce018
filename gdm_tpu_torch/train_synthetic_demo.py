"""Train-to-pose demonstration on synthetic data (no dataset needed).

    python -m gdm_tpu_torch.train_synthetic_demo [--steps 300] [--batch 8]
        [--backbone randla|dgcnn] [--bf16] [--device cuda|cpu]

Counterpart of scripts/train_synthetic_demo.py.  It trains GeoMatch (or
GeoMatchDGCNN) from seeded random weights on rendered frames of one
synthetic object (data/synthetic.make_batch) and reports ADD, rotation and
translation errors of the network's matches before and after training:
the whole learning loop (loss -> descriptors -> correspondences -> Kabsch)
end to end.  The fit runs through eval/pose_fit, so on the card every
evaluation launches the similarity kernel.  It exits 1 unless training
improves ADD at least 2x.

The defaults are the demo's shapes (128^2 crop, 1024 points, a 512-vertex
mesh, b=8, 64 train frames, 300 steps); LM-full's are ``--im 128
--n-sample 12800 --n-mesh 4096 --batch 6 --steps 120``.  :func:`run`
returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

POSITIVE_R = 0.008      # the circle loss's radius in metres (the flagship)
FOCAL = 280.0           # the crop intrinsics' focal length in pixels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m gdm_tpu_torch.train_synthetic_demo",
        description="Train on rendered frames of one synthetic object and "
                    "report ADD before and after; exit 1 unless ADD "
                    "improves at least 2x.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--im", type=int, default=128)
    ap.add_argument("--n-sample", type=int, default=1024)
    ap.add_argument("--n-mesh", type=int, default=512)
    ap.add_argument("--n-train-frames", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backbone", choices=("randla", "dgcnn"),
                    default="randla")
    ap.add_argument("--bf16", action="store_true",
                    help="model.compute_dtype=bfloat16")
    ap.add_argument("--hpr-param", type=float, default=2.0,
                    help="HPR flip exponent for GT visibility "
                         "(data.hpr_radius_param analogue; pi = the "
                         "reference's value)")
    ap.add_argument("--exact-knn", action="store_true",
                    help="accepted for the JAX script's command lines: the "
                         "port's DGCNN graphs are always exact, which off "
                         "the TPU is what JAX's approx_max_k gives too")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    return ap


def object_diameter(pts: np.ndarray, chunk: int = 1024) -> float:
    """Largest distance between two of ``pts`` [n, 3]."""
    pts = np.asarray(pts, np.float64)
    best = 0.0
    for i in range(0, len(pts), chunk):
        d = np.linalg.norm(pts[i:i + chunk, None] - pts[None], axis=-1)
        best = max(best, float(d.max()))
    return best


class Problem:
    """The demo's object, frames, model and mesh input on ``device``.

    ``inputs(data, sl)`` gives the model inputs of rows ``sl`` of a
    make_batch dict: for the flagship the exact KNN pyramid
    (pipeline.assemble_inputs, 256 queries per block), the GT keys and
    ``positive_r``; for DGCNN ``cld_rgb_nrm`` and the GT keys (its graphs
    are built in the forward)."""

    def __init__(self, args, device):
        from gdm_tpu_torch.data.synthetic import make_batch, make_object
        from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
        from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN, \
            mesh_input
        from gdm_tpu_torch.models.spline_mesh import build_mesh_graph

        self.args, self.device = args, torch.device(device)
        self.dgcnn = args.backbone == "dgcnn"
        im = args.im
        K = np.array([[FOCAL, 0, im / 2], [0, FOCAL, im / 2], [0, 0, 1]],
                     np.float32)
        rng = np.random.RandomState(args.seed)
        self.mesh_fps = make_object(args.n_mesh, rng, radius=0.06)
        self.mesh_pts = self.mesh_fps[:, :3] / 1000.0
        self.train_data, _ = make_batch(
            self.mesh_fps, args.n_train_frames, K, im_size=im,
            n_sample=args.n_sample, seed=args.seed,
            hpr_radius_param=args.hpr_param)
        self.test_data, self.test_poses = make_batch(
            self.mesh_fps, args.batch, K, im_size=im,
            n_sample=args.n_sample, seed=args.seed + 999,
            hpr_radius_param=args.hpr_param)
        dtype = torch.bfloat16 if args.bf16 else None
        if self.dgcnn:
            fps_m = np.concatenate([self.mesh_pts, self.mesh_fps[:, 3:]], 1)
            self.mesh = torch.as_tensor(mesh_input(fps_m), device=device)
            self.mesh_xyz = self.mesh[:, :3]
            self.model = GeoMatchDGCNN(awl=True, compute_dtype=dtype)
        else:
            self.mesh = MeshArrays.from_graph(
                build_mesh_graph(self.mesh_fps, args.n_mesh), device)
            self.mesh_xyz = self.mesh.xyz
            self.model = GeoMatch(awl=True, compute_dtype=dtype)

    def inputs(self, data: dict, sl=np.s_[:]) -> dict:
        from gdm_tpu_torch.data.pipeline import assemble_inputs
        from gdm_tpu_torch.serve import full_f32
        from gdm_tpu_torch.train.step import DGCNN_KEYS

        def t(key):
            a = np.asarray(data[key][sl])
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.int64)
            return torch.as_tensor(a, device=self.device)

        if self.dgcnn:
            return {k: t(k) for k in DGCNN_KEYS}
        with torch.no_grad(), full_f32():
            out = assemble_inputs(t("rgb"), t("cld_rgb_nrm"), t("choose"),
                                  t("xyz_img"), knn_chunk=256)
        out.update({k: t(k) for k in ("labels", "match_idx",
                                      "visible_flag", "RT")})
        out["positive_r"] = torch.tensor(POSITIVE_R, device=self.device)
        return out

    def evaluate(self) -> dict:
        """The test frames through the model in eval mode and
        eval/pose_fit: mean ADD, rotation (degrees) and translation errors
        (metres) against the GT poses, and the fit (poses, Kabsch weights,
        matched vertex ids, the features)."""
        from gdm_tpu_torch.eval.metrics import add_err, re_err, te_err
        from gdm_tpu_torch.eval.pose_fit import fit_poses_from_outputs
        from gdm_tpu_torch.serve import full_f32

        inputs = self.inputs(self.test_data)
        self.model.eval()
        with torch.no_grad(), full_f32():
            out = self.model(inputs, self.mesh)
            poses, w, idx = fit_poses_from_outputs(
                inputs["cld_rgb_nrm"][..., :3], out, self.mesh_xyz)
        poses_np = poses.cpu().numpy().astype(np.float64)
        gt = self.test_poses
        ads = [add_err(p[:, :3], p[:, 3], g[:, :3], g[:, 3], self.mesh_pts)
               for p, g in zip(poses_np, gt)]
        res = [re_err(p[:, :3], g[:, :3]) for p, g in zip(poses_np, gt)]
        tes = [te_err(p[:, 3], g[:, 3]) for p, g in zip(poses_np, gt)]
        return {"add": float(np.mean(ads)), "rot": float(np.mean(res)),
                "trans": float(np.mean(tes)), "poses": poses_np,
                "weights": w, "idx": idx, "rgbd": out["rgbd"],
                "mesh": out["mesh"]}


def run(args) -> dict:
    """The demo: returns {'add_before', 'add_after', 'rot_before',
    'rot_after', 'trans_before', 'trans_after' (metres and degrees),
    'diameter' (metres), 'losses' [(step, loss, seg, match)],
    'steps_per_s' (steps after the first), 'first_step_s', 'render_s',
    'peak_gib' (CUDA only, else None), 'improved'}."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    if args.steps < 1 or args.n_train_frames < args.batch:
        raise ValueError(f"want --steps >= 1 and --n-train-frames >= "
                         f"--batch, got {args.steps}, {args.n_train_frames}"
                         f" and {args.batch}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available "
                           "(pass --device cpu to run on the CPU)")
    cuda = device.type == "cuda"
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if cuda else ""))
    print(f"rendering {args.n_train_frames} train + {args.batch} test "
          f"frames ...", flush=True)
    t0 = time.perf_counter()
    prob = Problem(args, device)
    render_s = time.perf_counter() - t0
    weights.init_random_(prob.model, torch.Generator().manual_seed(args.seed))
    prob.model.to(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def report(tag, ev):
        print(f"[{tag}] ADD {ev['add'] * 1000:7.2f} mm | rot "
              f"{ev['rot']:7.2f} deg | t {ev['trans'] * 1000:6.2f} mm",
              flush=True)
        return ev

    before = report("untrained", prob.evaluate())
    state = create_train_state(prob.model, cyclic_lr(
        1e-5, 1e-3, max(args.steps // 6, 1)))
    step = make_train_step(bn_momentum_schedule(batch_size=args.batch),
                           POSITIVE_R, needs_pyramid=not prob.dgcnn)
    n_batches = args.n_train_frames // args.batch
    batches = [prob.inputs(prob.train_data,
                           np.s_[i * args.batch:(i + 1) * args.batch])
               for i in range(n_batches)]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    losses = []
    sync()
    t0 = time.perf_counter()
    t_first = None
    for it in range(args.steps):
        metrics = step(state, batches[it % n_batches], prob.mesh,
                       args.seed + 7)
        if it == 0:
            sync()
            t_first = time.perf_counter()
        if it % 50 == 0 or it == args.steps - 1:
            m = [float(metrics[k]) for k in ("loss", "seg_loss",
                                             "match_loss")]
            losses.append((it, *m))
            print(f"step {it:4d}  loss {m[0]:8.4f}  seg {m[1]:7.4f}  "
                  f"match {m[2]:8.4f}  ({time.perf_counter() - t0:5.1f}s)",
                  flush=True)
    sync()
    t_end = time.perf_counter()
    after = report("trained  ", prob.evaluate())
    improved = after["add"] < 0.5 * before["add"]
    print(f"ADD {before['add'] * 1000:.2f} -> {after['add'] * 1000:.2f} mm "
          f"({'OK: >=2x better' if improved else 'NO IMPROVEMENT'})")
    return {
        "add_before": before["add"], "add_after": after["add"],
        "rot_before": before["rot"], "rot_after": after["rot"],
        "trans_before": before["trans"], "trans_after": after["trans"],
        "diameter": object_diameter(prob.mesh_pts), "losses": losses,
        "steps_per_s": ((args.steps - 1) / (t_end - t_first)
                        if args.steps > 1 else None),
        "first_step_s": t_first - t0, "render_s": render_s,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if cuda else None),
        "improved": improved,
    }


def main(argv=None) -> int:
    return 0 if run(build_parser().parse_args(argv))["improved"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Full-surface dress rehearsal on one synthetic BOP root: every
user-facing path of the port once, with trained weights.

    python -m gdm_tpu_torch.dress_rehearsal [--epochs 60] [--frames 48]
        [--batch 24] [--out FILE] [--keep-root DIR] [--device cuda|cpu]
        [--opt KEY=VALUE ...]

Counterpart of scripts/dress_rehearsal.py, through the port's own
``cli.main`` and ``server``:

    fabricate a 2-object LM-O root (ape and can) -> cli train --cls-id
    all -> cli eval --vsd -> cli infer -> cli score -> cli infer
    --stacked -> cli export-serving (per object) -> HTTP serve + client

and it holds the paths against each other:

  * ``infer`` + ``score`` reproduce ``eval``'s ADD errors;
  * ``infer --stacked`` (mixed-object batches) gives the per-object
    ``infer`` poses, by the worst mesh-point displacement;
  * the served poses of each object's first test frames equal the eval
    CSV's rows.

Each worst case is printed beside its bound (BOUNDS); a check that
fails raises.
``--opt`` values go to every CLI call (the model's widths and the frame
size come from the LM-O preset they change).  ``--out`` writes the
stage-time and metrics tables to that file; by default they go to stdout
only.  :func:`run` returns the stage times, the worst cases, eval's
results and train's per-step timing.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import tempfile
import threading
import time

import numpy as np

OBJ_IDS = (1, 5)                    # LM-O ape and can (refdata diameters)
TEST_FRAMES = 8                     # test frames per object
SERVED_FRAMES = 8                   # served test frames per object
EVAL_SCORE = "eval vs infer+score ADD (m)"
STACKED = "stacked vs per-object displacement (m)"
SERVED = "served vs eval pose"
BOUNDS = {
    # |eval ADD - infer+score ADD|, as JAX's rehearsal holds it
    EVAL_SCORE: 1e-6,
    # worst mesh-point displacement between the two infer CSVs: the
    # card's f32 card-vs-CPU pose bound (JAX's rehearsal allows 2e-3)
    STACKED: 1e-4,
    # |served pose - eval pose| elementwise, same weights and engine
    # batch: the served-against-infer bound (JAX's rehearsal allows 5e-3)
    SERVED: 1e-5,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m gdm_tpu_torch.dress_rehearsal",
        description="Train on a synthetic 2-object LM-O root, then run "
                    "eval --vsd, infer, score, infer --stacked, "
                    "export-serving and HTTP serving of the trained "
                    "weights, holding the paths against each other.")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--frames", type=int, default=48,
                    help=f"train frames per object (the test split gets "
                         f"{TEST_FRAMES})")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="also write the results tables to this file")
    ap.add_argument("--keep-root", default=None,
                    help="fabricate the BOP root at this path and keep it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    ap.add_argument("--opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override given to every CLI call")
    return ap


def read_csv_poses(path) -> dict:
    """{(scene, im, obj): (R [3, 3], t [3] metres)} of a BOP results
    CSV."""
    out = {}
    with open(path) as f:
        next(f)
        for line in f:
            p = line.strip().split(",")
            R = np.array(p[4].split(), np.float64).reshape(3, 3)
            t = np.array(p[5].split(), np.float64) / 1000.0
            out[(int(p[0]), int(p[1]), int(p[2]))] = (R, t)
    return out


def _check(name, value, worst):
    """Record ``value`` as check ``name``'s worst case; raise beyond its
    bound."""
    worst[name] = (value, BOUNDS[name])
    msg = f"{name}: worst {value:.3g} (bound {BOUNDS[name]:g})"
    print(msg, flush=True)
    if not value <= BOUNDS[name]:
        raise RuntimeError(f"dress rehearsal: {msg} exceeds its bound")


def run(args) -> dict:
    """The rehearsal.  Returns {'stages': [(name, seconds)], 'worst':
    {check: (worst case, bound)}, 'eval': eval's results, 'train':
    train's result, 'report': the tables as text}."""
    from gdm_tpu_torch import cli, refdata, server
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    t_start = time.time()
    opts = [x for kv in [f"data.obj_ids={','.join(map(str, OBJ_IDS))}",
                         *args.opt] for x in ("--opt", kv)]
    cfg = cli.model_config("lmo", opts[1::2])
    refd = refdata.get("lmo")
    dev = ["--device", args.device]
    root = args.keep_root or tempfile.mkdtemp(prefix="gdm_rehearsal_")
    work = tempfile.mkdtemp(prefix="gdm_rehearsal_work_")
    ckpt_root = osp.join(work, "ckpt")
    ckpts = osp.join(ckpt_root, "checkpoints")
    out_dir = osp.join(work, "out")
    common = ["--dataset", "lmo", "--data-root", root]
    stages, worst = [], {}

    def stage(name, fn):
        t0 = time.time()
        r = fn()
        stages.append((name, time.time() - t0))
        print(f"[{name}] {stages[-1][1]:.1f} s", flush=True)
        return r

    try:
        rng = np.random.RandomState(args.seed)
        meshes = {oid: make_object(cfg.data.model_pt_num, rng, radius=0.05)
                  for oid in OBJ_IDS}
        hw = tuple(cfg.data.img_hw)
        stage("fabricate", lambda: write_synthetic_bop_root(
            root, meshes, n_frames=args.frames, subsets=("train_pbr",),
            im_hw=hw, seed=args.seed, z_range=(0.45, 0.6)))
        stage("fabricate-test", lambda: write_synthetic_bop_root(
            root, meshes, n_frames=TEST_FRAMES, subsets=("test",), im_hw=hw,
            seed=args.seed + 1, z_range=(0.45, 0.6), eval_meshes=True))

        trained = stage("train", lambda: cli.main([
            "train", *common, "--ckpt-root", ckpt_root, "--cls-id", "all",
            "--epochs", str(args.epochs), "--batch-size", str(args.batch),
            *dev, *opts]))
        results = stage("eval", lambda: cli.main([
            "eval", *common, "--torch-checkpoint", ckpts, "--output-dir",
            out_dir, "--vsd", *dev, *opts]))

        infer_csv = osp.join(work, "infer.csv")
        stage("infer", lambda: cli.main([
            "infer", *common, "--torch-checkpoint", ckpts, "--output",
            infer_csv, *dev, *opts]))
        scored = stage("score", lambda: cli.main([
            "score", *common, "--csv", infer_csv, *dev, *opts]))
        # the GT-less infer path reproduces the online eval's errors
        # (deterministic per-index sampling)
        _check(EVAL_SCORE, max(
            float(np.abs(np.asarray(results["errors"][refd.id2obj[o]]["ad"])
                         - np.asarray(scored["errors"][refd.id2obj[o]]["ad"])
                         ).max()) for o in OBJ_IDS), worst)

        # mixed-object batches through each object's trained model
        stacked_csv = osp.join(work, "infer_stacked.csv")
        stage("infer-stacked", lambda: cli.main([
            "infer", *common, "--torch-checkpoint", ckpts, "--output",
            stacked_csv, "--stacked", *dev, *opts]))
        per_rows, st_rows = read_csv_poses(infer_csv), \
            read_csv_poses(stacked_csv)
        if set(per_rows) != set(st_rows) or not per_rows:
            raise RuntimeError("dress rehearsal: infer --stacked rows "
                               f"{sorted(st_rows)} != infer's "
                               f"{sorted(per_rows)}")
        disp = 0.0
        for key, (R1, t1) in per_rows.items():
            R2, t2 = st_rows[key]
            pts = meshes[key[2]][:, :3].astype(np.float64) / 1000.0
            disp = max(disp, float(np.linalg.norm(
                (pts @ R1.T + t1) - (pts @ R2.T + t2), axis=1).max()))
        _check(STACKED, disp, worst)

        art_dirs = {}
        for oid in OBJ_IDS:
            name = refd.id2obj[oid]
            art_dirs[name] = osp.join(work, "serving", name)
            stage(f"export-{name}", lambda oid=oid, name=name: cli.main([
                "export-serving", *common, "--ckpt-root", ckpt_root,
                "--cls-id", str(oid), "--out", art_dirs[name], *dev,
                *opts]))

        def serve_roundtrip():
            svc = server.PoseService(server.load_artifact_tree(
                list(art_dirs.values()), args.device))
            svc.warmup()
            httpd = server.make_server(svc, port=0)
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            url = "http://%s:%d" % httpd.server_address[:2]
            eval_rows = read_csv_poses(osp.join(out_dir,
                                                "gt_lmo-test.csv"))
            dmax = 0.0
            try:
                for oid in OBJ_IDS:
                    name = refd.id2obj[oid]
                    ds = PoseDataset(cfg, oid, "test", data_root=root)
                    batch, meta = collate(
                        [ds[i] for i in range(min(SERVED_FRAMES, len(ds)))])
                    spec = svc.resolve(name).meta["raw_spec"]
                    poses, _ = server.request_poses(
                        url, {k: np.asarray(batch[k]) for k in spec},
                        obj=name)
                    for pose, m in zip(poses, meta):
                        scene_s, im_s = m["file_name"].split("/")[:2]
                        R, t = eval_rows[(int(scene_s), int(im_s), oid)]
                        dmax = max(dmax, float(np.abs(pose[:, :3] - R).max()),
                                   float(np.abs(pose[:, 3] - t).max()))
            finally:
                httpd.shutdown()
                httpd.server_close()
                th.join(timeout=30)
            return dmax

        _check(SERVED, stage("serve", serve_roundtrip), worst)

        lines = [
            "# Dress rehearsal of the port (full surface, trained weights)",
            "",
            f"Device: {args.device}; 2 objects "
            f"({', '.join(refd.id2obj[o] for o in OBJ_IDS)}), "
            f"{args.frames} train / {TEST_FRAMES} test frames each at "
            f"{hw[0]}x{hw[1]}, {cfg.data.input_size}^2 crop, "
            f"{cfg.data.num_sample_points} points, "
            f"{cfg.data.model_pt_num}-vertex meshes; {args.epochs} epochs, "
            f"batch {args.batch}.",
            "",
            "Chain: fabricate -> train -> eval --vsd -> infer -> score -> "
            "infer --stacked -> export-serving -> serve (HTTP).",
            "", *[f"- {k}: worst {v:.3g} (bound {b:g})"
                  for k, (v, b) in worst.items()], "",
            "| stage | wall time |", "|---|---|",
            *[f"| {n} | {dt:.1f} s |" for n, dt in stages],
            "", "## Metrics (synthetic 2-object set)", "", "```",
            results["table"], "```", ""]
        for oid in OBJ_IDS:
            name = refd.id2obj[oid]
            ar = results.get("bop19_ar", {}).get(name, {}).get("bop19_ar")
            lines.append(f"- {name}: ADD(-S) AUC {results['auc'][name]:.2f}"
                         + (f", BOP19 AR {ar:.3f}" if ar is not None
                            else ""))
        lines.append(f"\ntotal {time.time() - t_start:.1f} s")
        report = "\n".join(lines)
        if args.out:
            os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write(report + "\n")
        print(report, flush=True)
        return {"stages": stages, "worst": worst, "eval": results,
                "train": trained, "report": report}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if not args.keep_root:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Command line of the port: evaluation, deployment inference and
offline scoring of single-object GeoMatch on a BOP dataset.

    python -m gdm_tpu_torch.cli eval --dataset lmo --data-root DIR \\
        --torch-checkpoint CKPT --exact-knn [--cls-id 1]
    python -m gdm_tpu_torch.cli infer --dataset lmo --data-root DIR \\
        --torch-checkpoint CKPT --exact-knn --output results.csv
    python -m gdm_tpu_torch.cli score --dataset lmo --data-root DIR \\
        --csv results.csv

Counterpart of gdm_tpu/cli.py's ``eval``, ``infer`` (per-object loop)
and ``score``, with its flags wherever they apply.  ``CKPT/<object
name>/geomatch.pth.tar`` holds each object's reference-format weights
(orbax checkpoints are the JAX package's).  Each object gets one
serve.PoseEngine at the eval batch (``solver.val_batch_size``, 128 on
LM-O); the loader's batches are padded to it, the first is run once
more as a warm-up, and each frame's ``time`` is the batch's device time
(up to a synchronise) over the batch size.  The run is on the GPU unless
``--device cpu`` asks for the CPU; without CUDA, ``--device cuda``
raises.

The KNN pyramid is exact: it is the port's only mode.  What the JAX CLI
offers and the port does not yet (``--refine``, ``--vsd``, ``--save-viz``,
``--stacked``, ``--model-shards``) raises, naming the ROADMAP queue 1
item that brings it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import time

import numpy as np

# a distance block of the KNN pyramid holds at most this many f32
# entries (4 GiB); see knn_chunk_for
KNN_BLOCK_ELEMS = 1 << 30

_NOT_PORTED = {
    "refine": "refinement (ROADMAP queue 1 item 3)",
    "stacked": "stacked multi-model inference (ROADMAP queue 1 item 5)",
    "vsd": "VSD (ROADMAP queue 1 item 6)",
    "model_shards": "mesh-column sharding (ROADMAP queue 1 item 10)",
    "save_viz": "pose overlays (ROADMAP queue 1 item 11)",
}


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"gdm_tpu_torch.{name}")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s %(levelname)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def _device(args):
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def _refuse_unported(args, log):
    for flag, what in _NOT_PORTED.items():
        val = getattr(args, flag, None)
        if val and not (flag == "model_shards" and val == 1):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported")
    if not getattr(args, "exact_knn", True):
        log.info("approximate KNN is not ported: the pyramid is exact "
                 "(as with --exact-knn)")


def knn_chunk_for(requested: int, batch: int, cfg, log) -> int:
    """The KNN query chunk for an engine of ``batch``: ``requested``,
    lowered until the largest distance block of the pyramid (batch x
    chunk x support points, the support being the stride-2 CNN grid or
    the scene points) holds at most KNN_BLOCK_ELEMS entries.  The chunk
    bounds peak memory and changes no result."""
    support = max((cfg.data.input_size // 2) ** 2,
                  cfg.data.num_sample_points)
    fit = max(1, KNN_BLOCK_ELEMS // (batch * support))
    if fit >= requested:
        return requested
    chunk = 1 << (fit.bit_length() - 1)            # a power of two
    log.info("--knn-chunk %d lowered to %d at batch %d: a distance block "
             "of %d x %d x %d f32 would exceed %.1f GiB", requested, chunk,
             batch, batch, requested, support, KNN_BLOCK_ELEMS * 4 / 2**30)
    return chunk


def _eval_object_metadata(cfg, refd, cls_id, data_root, models_info,
                          fallback_pts=None):
    """Per-object eval metadata shared by evaluate() and score().

    Returns (obj_name, diameter_m, model points [m, 3] m, symmetry
    rotations or None, full BOP symmetry transforms [(R, t_m)] or None),
    as gdm_tpu/cli.py's helper of the same name does without VSD."""
    from gdm_tpu_torch.data.ply import find_kps_mesh, load_ply
    from gdm_tpu_torch.refdata._base import (
        all_symmetry_rotations,
        all_symmetry_transforms,
    )

    obj_name = refd.id2obj[cls_id]
    diameter = refd.diameters_mm_by_id[cls_id] / 1000.0
    eval_ply = osp.join(data_root, "models_eval", f"obj_{cls_id:06d}.ply")
    if osp.exists(eval_ply):
        pts = load_ply(eval_ply)["pts"] / 1000.0
    else:
        pts = (fallback_pts if fallback_pts is not None else
               find_kps_mesh(data_root, cls_id,
                             cfg.data.model_pt_num)[:, :3])
    sym = None
    sym_tf = None
    if str(cls_id) in models_info:
        if obj_name in cfg.data.sym_objs:
            sym = all_symmetry_rotations(models_info[str(cls_id)])
        # MSSD/MSPD use the models_info symmetry set for EVERY object
        # (identity-only when the model has none), translations -> metres
        sym_tf = [(R, t / 1000.0) for R, t in
                  all_symmetry_transforms(models_info[str(cls_id)])]
    return obj_name, diameter, pts, sym, sym_tf


def _load_targets(path):
    """BOP test-targets JSON -> {(scene_id, im_id, obj_id)} int triples
    (test_targets_bop19.json: [{scene_id, im_id, obj_id, inst_count}])."""
    with open(path) as f:
        targets = {(int(t["scene_id"]), int(t["im_id"]), int(t["obj_id"]))
                   for t in json.load(f)}
    if not targets:
        raise SystemExit(f"{path}: no targets parsed")
    return targets


def _filter_targets(annos, targets, cls_id):
    """Annotation records restricted to a BOP target set."""
    return [r for r in annos
            if (int(r.file_name.split("/")[0]),
                int(r.file_name.split("/")[1]), cls_id) in targets]


def _gts_from_annos(ds):
    """GT dict for the Evaluator (file_name -> pose/K/depth source)."""
    return {r.file_name: {"R": r.pose[:, :3], "t": r.pose[:, 3],
                          "K": r.cam_K, "depth_file": r.depth_file,
                          "depth_factor": r.depth_factor}
            for r in ds.annos}


def _models_info(refd, data_root):
    try:
        return refd.load_models_info(osp.join(data_root, "models"))
    except FileNotFoundError:
        return {}


def _object_engine(cfg, args, obj_name, mesh_fps, device, batch, log):
    """The PoseEngine of one object: its reference checkpoint, its mesh
    graph (from the fps layout, xyz in mm) and the eval batch."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.serve import PoseEngine

    state = weights.read_reference_checkpoint(
        osp.join(args.torch_checkpoint, obj_name))
    fps_mm = np.concatenate([mesh_fps[:, :3] * 1000.0, mesh_fps[:, 3:]],
                            axis=1)
    return PoseEngine(cfg, fps_mm, state, device, batch=batch,
                      knn_chunk=knn_chunk_for(args.knn_chunk, batch, cfg,
                                              log))


def _run_batches(engine, ds, batch_size, num_workers, timing):
    """Yield (meta row, det, pose [3, 4] float64, seconds per frame) for
    every sample of ``ds``, in order, through ``engine`` at its batch.

    The first batch runs once more as a warm-up (first-call CUDA, cuDNN
    and cuBLAS set-up stay out of the times).  Each batch appends
    {'n', 'wait_ms', 'device_ms'} to ``timing``: the time spent waiting on
    the loader and the engine's time up to a synchronise."""
    import torch

    from gdm_tpu_torch.data.loader import DataLoader, pad_batch

    keys = list(engine.meta["raw_spec"])
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    it = iter(DataLoader(ds, batch_size, num_workers=num_workers))
    warm = True
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        wait = time.perf_counter() - t0
        if item is None:
            return
        batch, meta = item
        n_real = batch["rgb_u8"].shape[0]
        raw = {k: batch[k] for k in keys}
        raw = pad_batch(raw, batch_size)
        if warm:
            engine.run(raw)
            sync()
            warm = False
        t0 = time.perf_counter()
        poses = engine.run(raw)
        sync()
        dev = time.perf_counter() - t0
        timing.append({"n": n_real, "wait_ms": wait * 1e3,
                       "device_ms": dev * 1e3})
        for i in range(n_real):
            yield (meta[i], int(batch["det"][i]),
                   np.asarray(poses[i], np.float64), dev / batch_size)


def _object_mesh(cfg, cls_id, data_root):
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh

    return load_or_build_fps_mesh(data_root, cls_id, cfg.data.model_pt_num)


def evaluate(args):
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import get_config
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.eval.evaluator import Evaluator

    log = get_logger("eval")
    _refuse_unported(args, log)
    device = _device(args)
    cfg = get_config(args.dataset, args.opt)
    refd = refdata.get(args.dataset)
    batch_size = args.batch_size or cfg.solver.val_batch_size
    cls_ids = [args.cls_id] if args.cls_id else list(cfg.data.obj_ids)
    targets = _load_targets(args.targets) if args.targets else None
    models_info = _models_info(refd, args.data_root)

    diameters, models_pts, sym_rots, sym_tfs = {}, {}, {}, {}
    evaluator = None
    gts = {}
    timing = []
    for cls_id in cls_ids:
        mesh_fps = _object_mesh(cfg, cls_id, args.data_root)
        obj_name, diameter, pts, sym, sym_tf = _eval_object_metadata(
            cfg, refd, cls_id, args.data_root, models_info,
            fallback_pts=mesh_fps[:, :3])
        diameters[obj_name] = diameter
        models_pts[obj_name] = pts
        if sym is not None:
            sym_rots[obj_name] = sym
        if sym_tf is not None:
            sym_tfs[obj_name] = sym_tf

        ds = PoseDataset(cfg, cls_id, "test", data_root=args.data_root)
        if targets is not None:
            # restrict both inference and scoring to the BOP target list
            ds.annos = _filter_targets(ds.annos, targets, cls_id)
        if len(ds) == 0:
            log.warning("no test annotations for %s%s", obj_name,
                        " (after --targets filter)" if targets else "")
            continue
        gts[obj_name] = _gts_from_annos(ds)
        if evaluator is None:
            # the Evaluator keeps these dicts, which later objects fill
            evaluator = Evaluator(
                args.dataset, [refd.id2obj[c] for c in cls_ids],
                diameters, models_pts, sym_objs=cfg.data.sym_objs,
                sym_rots=sym_rots, output_dir=args.output_dir,
                obj2id=refd.obj2id, sym_transforms=sym_tfs,
                im_w=cfg.data.img_hw[1])
        engine = _object_engine(cfg, args, obj_name, mesh_fps, device,
                                batch_size, log)
        n_done = 0
        for meta, det, pose, dt in _run_batches(
                engine, ds, batch_size, args.num_workers, timing):
            evaluator.add_prediction(obj_name, meta["file_name"],
                                     pose[:, :3], pose[:, 3], time=dt,
                                     det=det)
            n_done += 1
        log.info("%s: %d frames", obj_name, n_done)

    if evaluator is None:
        raise SystemExit("nothing evaluated")
    results = evaluator.evaluate(gts)
    print(results["table"])
    results["timing"] = timing
    return results


def _write_infer_csv(rows, args, log):
    """BOP-format results CSV; rows = (file_name, obj_id, pose [3,4] m,
    dt_seconds)."""
    if not rows:
        raise SystemExit("nothing inferred (no detections matched)")
    out_csv = args.output or osp.join(
        "output", f"infer_{args.dataset}.csv")
    os.makedirs(osp.dirname(osp.abspath(out_csv)), exist_ok=True)
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for file_name, obj_id, pose, dt in rows:
        scene_s, im_s = file_name.split("/")[:2]
        R, t_mm = pose[:, :3], pose[:, 3] * 1000.0
        lines.append(
            f"{int(scene_s)},{int(im_s)},{obj_id},-1,"
            f"{' '.join(map(str, R.flatten().tolist()))},"
            f"{' '.join(map(str, t_mm.flatten().tolist()))},"
            f"{dt:.6f}")
    with open(out_csv, "w") as f:
        f.write("\n".join(lines))
    log.info("%d predictions -> %s", len(rows), out_csv)
    return {"csv": out_csv, "n": len(rows)}


def infer(args):
    """GT-less deployment inference: frames + detections -> the BOP
    results CSV that ``score`` re-scores once GT exists."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import get_config
    from gdm_tpu_torch.data.dataset import PoseDataset

    log = get_logger("infer")
    _refuse_unported(args, log)
    device = _device(args)
    cfg = get_config(args.dataset, args.opt)
    refd = refdata.get(args.dataset)
    batch_size = args.batch_size or cfg.solver.val_batch_size
    cls_ids = [args.cls_id] if args.cls_id else list(cfg.data.obj_ids)
    targets = _load_targets(args.targets) if args.targets else None

    rows = []                       # (file_name, obj_id, pose [3,4], dt)
    timing = []
    for cls_id in cls_ids:
        obj_name = refd.id2obj[cls_id]
        ds = PoseDataset(cfg, cls_id, "infer", data_root=args.data_root,
                         detections_file=args.detections)
        if targets is not None:
            ds.annos = _filter_targets(ds.annos, targets, cls_id)
        if len(ds) == 0:
            log.warning("no detections for %s%s", obj_name,
                        " (after --targets filter)" if targets else "")
            continue
        engine = _object_engine(cfg, args, obj_name,
                                _object_mesh(cfg, cls_id, args.data_root),
                                device, batch_size, log)
        n_done = 0
        for meta, _, pose, dt in _run_batches(
                engine, ds, batch_size, args.num_workers, timing):
            rows.append((meta["file_name"], cls_id, pose, dt))
            n_done += 1
        log.info("%s: %d frames", obj_name, n_done)
    out = _write_infer_csv(rows, args, log)
    out["timing"] = timing
    return out


def score(args):
    """Offline re-scoring of a BOP-format results CSV (the file ``eval``
    or ``infer`` writes: scene_id,im_id,obj_id,score,R,t[mm],time)
    against the dataset GT, with the metric table ``eval`` prints.
    ``--targets`` restricts GT frames and predictions to a BOP
    test-targets JSON.  Of several rows per (scene, image, object), the
    best-scored one counts."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import get_config
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.eval.evaluator import Evaluator

    log = get_logger("score")
    _refuse_unported(args, log)
    cfg = get_config(args.dataset, args.opt)
    refd = refdata.get(args.dataset)
    cls_ids = [args.cls_id] if args.cls_id else list(cfg.data.obj_ids)
    models_info = _models_info(refd, args.data_root)
    targets = _load_targets(args.targets) if args.targets else None

    diameters, models_pts, sym_rots, sym_tfs, gts = {}, {}, {}, {}, {}
    for cls_id in cls_ids:
        obj_name, diameter, pts, sym, sym_tf = _eval_object_metadata(
            cfg, refd, cls_id, args.data_root, models_info)
        diameters[obj_name] = diameter
        models_pts[obj_name] = pts
        if sym is not None:
            sym_rots[obj_name] = sym
        if sym_tf is not None:
            sym_tfs[obj_name] = sym_tf
        ds = PoseDataset(cfg, cls_id, "test", data_root=args.data_root)
        if targets is not None:
            ds.annos = _filter_targets(ds.annos, targets, cls_id)
            if len(ds) == 0:
                log.info("%s: no targeted frames — skipped", obj_name)
                continue
        gts[obj_name] = _gts_from_annos(ds)

    if not gts:
        raise SystemExit("no GT frames to score (targets filtered "
                         "everything out?)")
    evaluator = Evaluator(
        args.dataset, list(gts), diameters, models_pts,
        sym_objs=cfg.data.sym_objs, sym_rots=sym_rots,
        output_dir=args.output_dir, obj2id=refd.obj2id,
        sym_transforms=sym_tfs, im_w=cfg.data.img_hw[1])

    best = {}
    with open(args.csv) as f:
        header = f.readline()
        if not header.strip().startswith("scene_id"):
            raise SystemExit(
                f"{args.csv}: expected a BOP results CSV starting with a "
                f"'scene_id,...' header, got: {header.strip()[:60]!r}")
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 7:
                continue
            scene, im, obj_id = parts[0], parts[1], int(parts[2])
            if obj_id not in refd.id2obj:
                continue
            s = float(parts[3])
            if (targets is not None
                    and (int(scene), int(im), obj_id) not in targets):
                continue
            key = (obj_id, int(scene), int(im))
            if key not in best or s > best[key][0]:
                best[key] = (s, parts)
    if not best:
        raise SystemExit(f"no result rows parsed from {args.csv}")
    for (obj_id, scene, im), (_, parts) in best.items():
        R = np.array([float(x) for x in parts[4].split()],
                     np.float64).reshape(3, 3)
        t = np.array([float(x) for x in parts[5].split()],
                     np.float64) / 1000.0
        evaluator.add_prediction(
            refd.id2obj[obj_id], f"{scene:06d}/{im:06d}", R, t,
            time=float(parts[6]))
    results = evaluator.evaluate(gts)
    print(results["table"])
    return results


def build_parser():
    p = argparse.ArgumentParser("gdm_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--dataset", required=True,
                        choices=["lmo", "lmfull", "lm_full", "ycbv"])
        sp.add_argument("--data-root", required=True)
        sp.add_argument("--cls-id", type=int, default=None,
                        help="single object (default: all in config)")
        sp.add_argument("--opt", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE",
                        help="config override, repeatable (e.g. "
                             "solver.val_batch_size=64)")
        sp.add_argument("--targets", default=None,
                        help="BOP test-targets JSON: only the listed "
                             "(scene, im, obj) instances")

    def run(sp):
        common(sp)
        sp.add_argument("--batch-size", type=int, default=None,
                        help="engine batch (default solver.val_batch_size)")
        sp.add_argument("--num-workers", type=int, default=8,
                        help="loader decode threads")
        sp.add_argument("--knn-chunk", type=int, default=1024,
                        help="KNN queries per distance block (lowered at "
                             "large batches to bound device memory)")
        sp.add_argument("--torch-checkpoint", required=True,
                        help="directory of <object name>/geomatch.pth.tar "
                             "reference checkpoints")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
        sp.add_argument("--exact-knn", action="store_true",
                        help="exact KNN pyramid (the port's only mode)")
        sp.add_argument("--refine", choices=["ransac", "icp", "meanshift"],
                        default=None, help="not ported")
        sp.add_argument("--save-viz", default=None, metavar="DIR",
                        help="not ported")
        sp.add_argument("--model-shards", type=int, default=1,
                        help="not ported")

    e = sub.add_parser("eval", help="evaluate on the test set")
    run(e)
    e.add_argument("--output-dir", default="output")
    e.add_argument("--vsd", action="store_true", help="not ported")

    i = sub.add_parser("infer", help="GT-less inference: rgb/depth + "
                                     "detections -> BOP results CSV")
    run(i)
    i.add_argument("--detections", default=None,
                   help="detection JSON (default <subset>/real_det.json)")
    i.add_argument("--output", default=None,
                   help="results CSV (default output/infer_<dataset>.csv)")
    i.add_argument("--stacked", action="store_true", help="not ported")

    s = sub.add_parser("score", help="offline re-scoring of a BOP results "
                                     "CSV")
    common(s)
    s.add_argument("--csv", required=True)
    s.add_argument("--output-dir", default=None)
    s.add_argument("--vsd", action="store_true", help="not ported")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "score":
        return score(args)
    if args.command == "infer":
        return infer(args)
    return evaluate(args)


if __name__ == "__main__":
    main()

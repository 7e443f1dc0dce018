"""Command line of the port: training, evaluation, deployment inference,
offline scoring and serving of single-object GeoMatch on a BOP dataset.

    python -m gdm_tpu_torch.cli train --dataset lmo --data-root DIR \\
        --cls-id 1 --ckpt-root train_log [--epochs 50] [--resume] \\
        [--eval-every 5] [--pretrained-backbone resnet18.pth]
    python -m gdm_tpu_torch.cli eval --dataset lmo --data-root DIR \\
        --torch-checkpoint CKPT --exact-knn [--cls-id 1] \\
        [--refine {ransac,icp,meanshift}] [--icp-reject M] [--vsd] \\
        [--save-viz DIR]
    python -m gdm_tpu_torch.cli infer --dataset lmo --data-root DIR \\
        --torch-checkpoint CKPT --exact-knn --output results.csv \\
        [--refine ...] [--save-viz DIR] [--stacked [--stacked-schedule \\
        by_class|vmap] [--stacked-group 4]]
    python -m gdm_tpu_torch.cli score --dataset lmo --data-root DIR \\
        --csv results.csv [--vsd]
    python -m gdm_tpu_torch.cli export-serving --dataset lmo \\
        --data-root DIR --cls-id 1 [--torch-checkpoint CKPT | \\
        --ckpt-root train_log] [--batch-size 8] [--out DIR]
    python -m gdm_tpu_torch.cli serve --artifact serving/lmo \\
        [--host 127.0.0.1] [--port 8360] [--no-warmup]

Counterpart of gdm_tpu/cli.py, with its flags wherever they apply and
``--device`` on every subcommand.  ``train`` writes
``<ckpt_root>/checkpoints/<object name>/`` (train/checkpoint.py), whose
``geomatch.pth.tar`` is what ``eval --torch-checkpoint
<ckpt_root>/checkpoints`` reads, and the metrics stream
``<ckpt_root>/metrics/<object name>.jsonl``;
``--pretrained-backbone`` (or ``model.pretrained_backbone``) starts its
ResNet trunk from a torchvision checkpoint (train/import_torch.py).
``CKPT/<object name>/geomatch.pth.tar`` holds each object's
reference-format weights (orbax checkpoints are the JAX package's).
Each object gets one serve.PoseEngine at the eval batch
(``solver.val_batch_size``, 128 on LM-O); the loader's batches are padded
to it, the first is run once more as a warm-up, and each frame's
``time`` is the batch's device time (up to a synchronise) over the batch
size.  The run is on the GPU unless ``--device cpu`` asks for the CPU;
without CUDA, ``--device cuda`` raises.

``--vsd`` adds the BOP VSD errors, their recall row and AR_VSD with the
combined BOP19 AR, for every object with a ``models_eval`` PLY that has
faces; the renders run on ``--device`` (eval/vsd.py).  ``--save-viz DIR``
writes one pose overlay per frame (utils/viz.py), prediction green and,
in ``eval``, the GT blue, as ``DIR/<object>_<scene>_<image>[_<n>].png``.

``--refine`` refines every fitted pose (eval/pose_fit.apply_refine); the
ICP gate is ``--icp-reject`` metres, or else ``data.nn_dist_th`` times
the object's diameter.  ``infer --stacked`` interleaves the objects'
frames round-robin, so that every batch mixes objects, and sends each
row to its object's model (eval/multimodel.MultiObjectEngine) with that
object's ICP gate.

``export-serving`` writes one object's serving artifact (serve.py: its
meta, weights and mesh; ``--platforms`` records nothing in the port) to
``--out`` or ``serving/<dataset>/<object name>``, from
``--torch-checkpoint`` or the newest checkpoint of ``train --ckpt-root``,
and refuses untrained weights.  ``serve`` builds one engine per artifact
(server.load_artifact_tree), warms each up unless ``--no-warmup``, and
answers ``POST /pose``, ``GET /healthz`` and ``GET /meta`` (server.py)
until SIGINT.  ``--profile-dir DIR`` (every subcommand) writes one
``torch.profiler`` chrome trace of the command into DIR
(utils/logging.profiler_trace).

The model is built as the JAX CLI builds it (models/build.build_model):
``--opt model.backbone=dgcnn`` gives GeoMatchDGCNN (config 5: no KNN
pyramid, the mesh as its node features in metres), the default
GeoMatch; the widths of the reference (``--opt`` values of
``model.randla_d_out``, ``model.spline_kernel`` and ``model.mesh_knn_k``
other than their defaults, or a ``model.n_mesh_node`` other than
``data.model_pt_num``, are refused: the JAX CLI ignores them), and the
mesh of ``data.model_pt_num`` vertices.  With ``data.fill_depth``
(YCB-V) the loader's depth-filled crop goes to the device beside the
counts.

The KNN pyramid and the DGCNN graphs are exact: it is the port's only
mode.  ``infer --stacked`` needs the randla_spline backbone, as in the
JAX CLI.

Several cards (``train``, ``eval``, ``infer``; parallel/): one process
per card over NCCL, or per CPU rank over gloo with ``--device cpu``.

  * ``--devices N`` starts N ranks on this host (``torch.multiprocessing``,
    cards cuda:0..N-1) and refuses an N beyond the cards present (the CPU's
    cores with ``--device cpu``).  The default is one card, where the JAX
    CLI takes every device of its platform;
  * ``--multihost``: this process is one rank of a torchrun-style run
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; its card is
    cuda:$LOCAL_RANK), or of the process group its caller already made;
  * ``--model-shards S`` lays the ranks out as a (world / S, S) grid,
    rank = d S + k (gdm_tpu/parallel/sp.py make_mesh_2d): the S ranks of
    a model row split the mesh columns of the matching loss and of the
    correspondence argmax (parallel/sp.py), the ranks of a data column
    split the batch.

Each rank loads only its rows of every batch (the loader's
``rank``/``world`` slice over the data column; ``--batch-size`` is the
global batch), ``train`` augments with the seed plus the data rank (the
JAX multi-process run's seed plus rank), takes the global batch's losses
and batch-norm moments and the ranks' mean gradient, and rank 0 alone
writes checkpoints and the metrics stream and validates
(``--eval-every``) on its card.  ``eval`` and ``infer`` gather the
predictions to rank 0, which writes the CSV and the table.  ``score``
and ``export-serving`` take ``--devices`` and ``--multihost`` and, as in
the JAX CLI, run in one process; ``infer --stacked`` is single-process.
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import os.path as osp
import time

import numpy as np

# a distance block of the KNN pyramid holds at most this many f32
# entries (4 GiB); see knn_chunk_for
KNN_BLOCK_ELEMS = 1 << 30
# what --save-viz draws on: the input crop, its intrinsics, the GT pose
VIZ_KEYS = ("rgb_u8", "K_crop", "RT")
# the profiler range (--profile-dir) of each timed engine batch
BATCH_SPAN = "gdm_tpu_torch.batch"

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


def _run_grid(args, batch_size: int | None = None):
    """(grid, device) of this process (gdm_tpu/cli.py _make_run_mesh):
    one rank on ``--device``, or under ``--multihost`` a rank of the
    process group on its card, laid out as a (data, model) grid of
    ``--model-shards`` columns; refuses the layouts the JAX CLI refuses,
    with its messages."""
    import torch.distributed as dist

    from gdm_tpu_torch.parallel import mesh as pmesh

    device = _device(args)
    world = 1
    if args.multihost:
        if (args.devices or 1) != 1:
            raise SystemExit(f"--devices {args.devices} out of range "
                             "(1..1 per process)")
        device = pmesh.rank_device(device)
        pmesh.init_process_group(device)
        world = dist.get_world_size()
    shards = getattr(args, "model_shards", 1) or 1
    _check_layout(world, shards, batch_size)
    grid = pmesh.make_grid(shards) if args.multihost else pmesh.Grid()
    return grid, device


def _check_layout(world: int, shards: int, batch_size: int | None):
    """The grid checks of gdm_tpu/cli.py _make_run_mesh, its messages."""
    if world % shards:
        raise SystemExit(f"--model-shards {shards} does not divide "
                         f"{world} devices")
    n_data = world // shards
    if batch_size is not None and batch_size % n_data:
        raise SystemExit(
            f"batch {batch_size} not divisible by the data-axis size "
            f"{n_data}" + (f" ({world} devices / {shards} model shards)"
                           if shards > 1 else ""))


def _check_stacked(args):
    """``infer --stacked`` refusals of the JAX CLI (gdm_tpu/cli.py
    _infer_stacked)."""
    if not getattr(args, "stacked", False):
        return
    if args.multihost or (args.devices or 1) > 1:
        raise SystemExit("--stacked is single-process (use the default "
                         "per-object loop for multihost runs)")
    if args.model_shards > 1:
        raise SystemExit("--stacked and --model-shards are exclusive")


def _spawn_ranks(argv, n: int, device) -> None:
    """``--devices N``: N ranks of this command on this host, rank r on
    cuda:r (NCCL) or a CPU rank (gloo), meeting through a file store in a
    temporary directory.  A rank that fails fails the run (the others
    are ended)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    device = torch.device(device)
    if device.type == "cuda":
        if device.index is not None:
            raise SystemExit(f"--devices {n} takes cuda:0..{n - 1}; pass "
                             "--device cuda")
        avail = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    else:
        avail = os.cpu_count() or 1
    if not 1 <= n <= avail:
        raise SystemExit(f"--devices {n} out of range (1..{avail} per "
                         "process)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_main, args=(list(argv), n,
                                             osp.join(d, "store"), backend),
                           nprocs=n, start_method="spawn")


def _rank_main(rank: int, argv, world: int, store: str, backend: str):
    """One rank of :func:`_spawn_ranks`: the command with --multihost in
    the process group of the file store."""
    import torch.distributed as dist

    from gdm_tpu_torch.parallel.mesh import TIMEOUT

    os.environ["LOCAL_RANK"] = str(rank)    # its card (torchrun layout)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        main(list(argv) + ["--devices", "1", "--multihost"])
    finally:
        dist.destroy_process_group()


def _log_exact_knn(args, cfg, log):
    """Say what the port builds where the JAX CLI calls
    ``lax.approx_max_k``: the pyramid without --exact-knn, DGCNN's graphs
    without --exact-knn or model.dgcnn_exact_knn (train too).  The port
    builds the exact top-k, and so does JAX's default off the TPU: XLA's
    CPU backend computes approx_max_k exactly, and only its TPU backend
    lowers it to a partial reduction at the recall target
    (tests/test_torch_lmfull.py holds the two equal)."""
    exact = getattr(args, "exact_knn", None)
    why = ("what the JAX CLI's default lax.approx_max_k computes off the "
           "TPU; on a TPU it is a partial reduction at the recall target")
    if cfg.model.backbone == "dgcnn":
        if not (exact or cfg.model.dgcnn_exact_knn):
            log.info("the DGCNN graphs are the exact top-k: %s", why)
    elif exact is False:
        log.info("the pyramid is the exact top-k: %s", why)


def model_config(dataset: str, opts):
    """The preset with its ``--opt`` overrides, refusing the model widths
    that the JAX CLI ignores (gdm_tpu/cli.py:105-106,166-170 build the
    default widths and a mesh graph of data.model_pt_num vertices), so
    that both CLIs build the same model from one configuration."""
    from gdm_tpu_torch.configs import ModelConfig, get_config

    cfg = get_config(dataset, opts)
    default = ModelConfig()
    for field in ("randla_d_out", "randla_k", "spline_kernel",
                  "mesh_knn_k"):
        val, want = getattr(cfg.model, field), getattr(default, field)
        if tuple(np.atleast_1d(val)) != tuple(np.atleast_1d(want)):
            raise ValueError(
                f"--opt model.{field}={val}: the reference CLI ignores "
                f"model.{field} and builds {want}; the port refuses other "
                "values so that both build the same model")
    if cfg.model.n_mesh_node != cfg.data.model_pt_num:
        raise ValueError(
            f"--opt model.n_mesh_node={cfg.model.n_mesh_node}: the "
            "reference CLI ignores model.n_mesh_node and builds the mesh "
            f"graph of data.model_pt_num={cfg.data.model_pt_num} vertices")
    return cfg


def knn_chunk_for(requested: int, batch: int, cfg, log) -> int:
    """The KNN query chunk for an engine of ``batch``: ``requested``,
    lowered until the largest distance block (batch x chunk x support
    points) holds at most KNN_BLOCK_ELEMS entries.  The support is the
    pyramid's stride-2 CNN grid or its scene points, or for DGCNN the
    scene points its graphs range over.  The chunk bounds peak memory and
    changes no result."""
    support = cfg.data.num_sample_points
    if cfg.model.backbone != "dgcnn":
        support = max((cfg.data.input_size // 2) ** 2, support)
    fit = max(1, KNN_BLOCK_ELEMS // (batch * support))
    if fit >= requested:
        return requested
    chunk = 1 << (fit.bit_length() - 1)            # a power of two
    log.info("--knn-chunk %d lowered to %d at batch %d: a distance block "
             "of %d x %d x %d f32 would exceed %.1f GiB", requested, chunk,
             batch, batch, requested, support, KNN_BLOCK_ELEMS * 4 / 2**30)
    return chunk


def _eval_object_metadata(cfg, refd, cls_id, data_root, want_vsd, log,
                          models_info, fallback_pts=None):
    """Per-object eval metadata shared by evaluate() and score().

    Returns (obj_name, diameter_m, model points [m, 3] m, (verts_m,
    faces) for VSD or None, symmetry rotations or None, full BOP symmetry
    transforms [(R, t_m)] or None), as gdm_tpu/cli.py's helper of the
    same name does.  The VSD mesh is models_eval/obj_*.ply; without it,
    or without faces in it, VSD is skipped for the object with a
    warning."""
    from gdm_tpu_torch.data.ply import find_kps_mesh, load_ply
    from gdm_tpu_torch.refdata._base import (
        all_symmetry_rotations,
        all_symmetry_transforms,
    )

    obj_name = refd.id2obj[cls_id]
    diameter = refd.diameters_mm_by_id[cls_id] / 1000.0
    eval_ply = osp.join(data_root, "models_eval", f"obj_{cls_id:06d}.ply")
    vsd_mesh = None
    if osp.exists(eval_ply):
        ply = load_ply(eval_ply)
        pts = ply["pts"] / 1000.0
        if want_vsd:
            if "faces" in ply:
                vsd_mesh = (pts, ply["faces"])
            else:
                log.warning("--vsd: %s has no faces — skipping VSD "
                            "for %s", eval_ply, obj_name)
    else:
        pts = (fallback_pts if fallback_pts is not None else
               find_kps_mesh(data_root, cls_id,
                             cfg.data.model_pt_num)[:, :3])
        if want_vsd:
            log.warning("--vsd: no faces for %s (missing %s) — "
                        "skipping VSD for this object", obj_name,
                        eval_ply)
    sym = None
    sym_tf = None
    if str(cls_id) in models_info:
        if obj_name in cfg.data.sym_objs:
            sym = all_symmetry_rotations(models_info[str(cls_id)])
        # MSSD/MSPD use the models_info symmetry set for EVERY object
        # (identity-only when the model has none), translations -> metres
        sym_tf = [(R, t / 1000.0) for R, t in
                  all_symmetry_transforms(models_info[str(cls_id)])]
    return obj_name, diameter, pts, vsd_mesh, sym, sym_tf


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


def _icp_gate(args, cfg, diameter_m):
    """The ICP correspondence gate of an object in metres: --icp-reject,
    or else the dataset's nn_dist_th x diameter (gdm_tpu/cli.py:849)."""
    if args.icp_reject is not None:
        return args.icp_reject
    return cfg.data.nn_dist_th * diameter_m


def _fps_mm(mesh_fps):
    """The fps array of ``load_or_build_fps_mesh`` (xyz in metres) in the
    obj_XXXXXX_fps.npy layout that build_model takes (xyz in mm)."""
    return np.concatenate([mesh_fps[:, :3] * 1000.0, mesh_fps[:, 3:]],
                          axis=1)


def _object_engine(cfg, args, obj_name, mesh_fps, device, batch, log,
                   icp_reject=0.01, grid=None):
    """The PoseEngine of one object: its reference checkpoint, its mesh
    (``mesh_fps`` in metres), the eval batch, --refine, the object's ICP
    gate and the run's grid (its correspondence argmax split over the
    model row)."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.serve import PoseEngine

    state = weights.read_reference_checkpoint(
        osp.join(args.torch_checkpoint, obj_name))
    return PoseEngine(cfg, _fps_mm(mesh_fps), state, device, batch=batch,
                      knn_chunk=knn_chunk_for(args.knn_chunk, batch, cfg,
                                              log),
                      refine=args.refine, icp_reject=icp_reject, grid=grid)


def _run_batches(engine, ds, batch_size, num_workers, timing, keep=(),
                 rank=0, world=1):
    """Yield (meta row, det, pose [3, 4] float64, seconds per frame) for
    every sample of ``ds`` (of its ``rank``::``world`` slice), in order,
    through ``engine`` at its batch.
    A sample's ``obj_pos`` (the stacked path's) and its arrays named in
    ``keep`` join its meta row.

    The first batch runs once more as a warm-up (first-call CUDA, cuDNN
    and cuBLAS set-up stay out of the times).  Each batch appends
    {'n', 'wait_ms', 'device_ms'} to ``timing``: the time spent waiting on
    the loader and the engine's time up to a synchronise, which a
    ``--profile-dir`` trace shows as a BATCH_SPAN range."""
    import torch

    from gdm_tpu_torch.data.loader import DataLoader, pad_batch

    keys = list(engine.meta["raw_spec"])
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    it = iter(DataLoader(ds, batch_size, num_workers=num_workers,
                         rank=rank, world=world))
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
        with torch.profiler.record_function(BATCH_SPAN):
            poses = engine.run(raw)
            sync()
        dev = time.perf_counter() - t0
        timing.append({"n": n_real, "wait_ms": wait * 1e3,
                       "device_ms": dev * 1e3})
        for i in range(n_real):
            m = dict(meta[i], **{k: batch[k][i] for k in keep})
            if "obj_pos" in batch:
                m["obj_pos"] = int(batch["obj_pos"][i])
            yield (m, int(batch["det"][i]), np.asarray(poses[i], np.float64),
                   dev / batch_size)


def _save_viz(viz_dir, obj_name, file_name, rgb_u8, K_crop, pts, pose,
              gt_rt=None, max_pts=2048, inst=0):
    """One pose-overlay PNG on the network's input crop (gdm_tpu/cli.py
    ``_save_viz``): the prediction in green over the GT in blue (when
    given and non-zero), at most ``max_pts`` model points.  ``inst``
    numbers the detections of one object in one frame (infer keeps every
    detection): ``<viz_dir>/<obj_name>_<scene>_<image>[_<inst>].png``."""
    from gdm_tpu_torch.data.imio import imwrite_png
    from gdm_tpu_torch.utils.viz import draw_pose

    os.makedirs(viz_dir, exist_ok=True)
    pts = np.asarray(pts)
    if len(pts) > max_pts:
        pts = pts[:: len(pts) // max_pts + 1]
    img = np.ascontiguousarray(rgb_u8)
    if gt_rt is not None and np.abs(gt_rt).sum() > 0:
        img = draw_pose(img, pts, gt_rt[:, :3], gt_rt[:, 3], K_crop,
                        color=(60, 120, 255))
    img = draw_pose(img, pts, pose[:, :3], pose[:, 3], K_crop,
                    color=(0, 255, 80))
    suffix = "" if inst == 0 else f"_{inst}"
    imwrite_png(osp.join(viz_dir, f"{obj_name}_{file_name.replace('/', '_')}"
                                  f"{suffix}.png"), img)


def _object_mesh(cfg, cls_id, data_root):
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh

    return load_or_build_fps_mesh(data_root, cls_id, cfg.data.model_pt_num)


def evaluate(args):
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.eval.evaluator import Evaluator
    from gdm_tpu_torch.parallel.mesh import all_gather_host

    log = get_logger("eval")
    cfg = model_config(args.dataset, args.opt)
    _log_exact_knn(args, cfg, log)
    refd = refdata.get(args.dataset)
    batch_size = args.batch_size or cfg.solver.val_batch_size
    grid, device = _run_grid(args, batch_size)
    host_bs = batch_size // grid.data_size      # this rank's rows
    cls_ids = [args.cls_id] if args.cls_id else list(cfg.data.obj_ids)
    targets = _load_targets(args.targets) if args.targets else None
    models_info = _models_info(refd, args.data_root)

    diameters, models_pts, sym_rots, sym_tfs = {}, {}, {}, {}
    vsd_meshes = {}
    evaluator = None
    gts = {}
    timing = []
    for cls_id in cls_ids:
        mesh_fps = _object_mesh(cfg, cls_id, args.data_root)
        obj_name, diameter, pts, vsd_mesh, sym, sym_tf = \
            _eval_object_metadata(cfg, refd, cls_id, args.data_root,
                                  args.vsd, log, models_info,
                                  fallback_pts=mesh_fps[:, :3])
        diameters[obj_name] = diameter
        models_pts[obj_name] = pts
        if vsd_mesh is not None:
            vsd_meshes[obj_name] = vsd_mesh
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
                obj2id=refd.obj2id, vsd_meshes=vsd_meshes,
                sym_transforms=sym_tfs, im_w=cfg.data.img_hw[1],
                device=device)
        engine = _object_engine(cfg, args, obj_name, mesh_fps, device,
                                host_bs, log, _icp_gate(args, cfg, diameter),
                                grid)
        n_done = 0
        viz_seen = collections.Counter()     # detections per frame
        for meta, det, pose, dt in _run_batches(
                engine, ds, host_bs, args.num_workers, timing,
                keep=VIZ_KEYS if args.save_viz else (),
                rank=grid.data_rank, world=grid.data_size):
            evaluator.add_prediction(obj_name, meta["file_name"],
                                     pose[:, :3], pose[:, 3], time=dt,
                                     det=det)
            if args.save_viz and grid.model_rank == 0:
                viz_seen[meta["file_name"]] += 1
                _save_viz(args.save_viz, obj_name, meta["file_name"],
                          meta["rgb_u8"], meta["K_crop"], pts, pose,
                          meta["RT"], inst=viz_seen[meta["file_name"]] - 1)
            n_done += 1
        log.info("%s: %d frames", obj_name, n_done)

    if evaluator is None:
        raise SystemExit("nothing evaluated")
    if grid.world > 1:
        # the ranks of a model row computed the same rows: one gives them
        evaluator.gather(lambda p: all_gather_host(
            p if grid.model_rank == 0 else {}, grid))
        if grid.rank != 0:
            return None
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


class MixedInferDataset:
    """Round-robin interleave of per-object infer datasets (gdm_tpu/cli.py
    _MixedInferDataset), so that consecutive batches mix objects.  Each
    sample gains ``obj_pos``, the position of its object in ``parts``."""

    def __init__(self, parts):
        self.parts = parts
        self.order = [(p, i)
                      for i in range(max(len(ds) for _, ds in parts))
                      for p, (_, ds) in enumerate(parts)
                      if i < len(ds)]

    def __len__(self):
        return len(self.order)

    def __getitem__(self, k):
        p, i = self.order[k]
        s = dict(self.parts[p][1][i])
        s["obj_pos"] = np.int32(p)
        return s


def infer(args):
    """GT-less deployment inference: frames + detections -> the BOP
    results CSV that ``score`` re-scores once GT exists.

    By default each object's frames go through its own engine in turn;
    ``--stacked`` serves the objects' frames interleaved, each batch
    mixing objects (the stream of a live feed of mixed detections)."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.parallel.mesh import all_gather_host

    log = get_logger("infer")
    _check_stacked(args)
    cfg = model_config(args.dataset, args.opt)
    if args.stacked and cfg.model.backbone != "randla_spline":
        raise SystemExit("--stacked requires the randla_spline backbone")
    _log_exact_knn(args, cfg, log)
    refd = refdata.get(args.dataset)
    batch_size = args.batch_size or cfg.solver.val_batch_size
    grid, device = _run_grid(args, batch_size)
    host_bs = batch_size // grid.data_size      # this rank's rows
    cls_ids = [args.cls_id] if args.cls_id else list(cfg.data.obj_ids)
    targets = _load_targets(args.targets) if args.targets else None

    rows = []                       # (file_name, obj_id, pose [3,4], dt)
    timing = []
    parts = []                      # (cls_id, dataset, engine)
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
        mesh_fps = _object_mesh(cfg, cls_id, args.data_root)
        engine = _object_engine(
            cfg, args, obj_name, mesh_fps, device, host_bs, log,
            _icp_gate(args, cfg, refd.diameters_mm_by_id[cls_id] / 1000.0),
            grid)
        if args.stacked:
            parts.append((cls_id, ds, engine))
            continue
        n_done = 0
        viz_seen = collections.Counter()     # detections per frame
        for meta, _, pose, dt in _run_batches(
                engine, ds, host_bs, args.num_workers, timing,
                keep=VIZ_KEYS[:2] if args.save_viz else (),
                rank=grid.data_rank, world=grid.data_size):
            rows.append((meta["file_name"], cls_id, pose, dt))
            if args.save_viz and grid.model_rank == 0:
                viz_seen[meta["file_name"]] += 1
                _save_viz(args.save_viz, obj_name, meta["file_name"],
                          meta["rgb_u8"], meta["K_crop"], mesh_fps[:, :3],
                          pose, inst=viz_seen[meta["file_name"]] - 1)
            n_done += 1
        log.info("%s: %d frames", obj_name, n_done)
    if parts:
        from gdm_tpu_torch.eval.multimodel import MultiObjectEngine

        engine = MultiObjectEngine([e for _, _, e in parts],
                                   args.stacked_schedule, args.stacked_group)
        mixed = MixedInferDataset([(c, ds) for c, ds, _ in parts])
        for meta, _, pose, dt in _run_batches(
                engine, mixed, batch_size, args.num_workers, timing):
            rows.append((meta["file_name"], parts[meta["obj_pos"]][0], pose,
                         dt))
        log.info("stacked (%s): %d frames of %d objects",
                 args.stacked_schedule, len(rows), len(parts))
    if grid.world > 1:
        rows = [r for sub in all_gather_host(
            rows if grid.model_rank == 0 else [], grid) for r in sub]
        if grid.rank != 0:
            return None
    out = _write_infer_csv(rows, args, log)
    out["timing"] = timing
    return out


def score(args):
    """Offline re-scoring of a BOP-format results CSV (the file ``eval``
    or ``infer`` writes: scene_id,im_id,obj_id,score,R,t[mm],time)
    against the dataset GT, with the metric table ``eval`` prints
    (``--vsd`` included: its renders run on ``--device``).
    ``--targets`` restricts GT frames and predictions to a BOP
    test-targets JSON.  Of several rows per (scene, image, object), the
    best-scored one counts."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import get_config
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.eval.evaluator import Evaluator

    log = get_logger("score")
    cfg = get_config(args.dataset, args.opt)
    refd = refdata.get(args.dataset)
    cls_ids = [args.cls_id] if args.cls_id else list(cfg.data.obj_ids)
    models_info = _models_info(refd, args.data_root)
    targets = _load_targets(args.targets) if args.targets else None

    diameters, models_pts, sym_rots, sym_tfs, gts = {}, {}, {}, {}, {}
    vsd_meshes = {}
    for cls_id in cls_ids:
        obj_name, diameter, pts, vsd_mesh, sym, sym_tf = \
            _eval_object_metadata(cfg, refd, cls_id, args.data_root,
                                  args.vsd, log, models_info)
        diameters[obj_name] = diameter
        models_pts[obj_name] = pts
        if vsd_mesh is not None:
            vsd_meshes[obj_name] = vsd_mesh
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
        vsd_meshes=vsd_meshes, sym_transforms=sym_tfs,
        im_w=cfg.data.img_hw[1],
        device=_device(args) if vsd_meshes else None)

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


def _sym_transform(cfg, refd, cls_id, obj_name, data_root):
    """The discrete symmetry (R, t_mm) of a symmetric object, whose table
    the flagship's mesh graph carries (gdm_tpu/cli.py
    _build_object_setup), or None."""
    from gdm_tpu_torch.refdata._base import symmetry_transform

    if obj_name in cfg.data.sym_objs:
        info = _models_info(refd, data_root)
        if str(cls_id) in info:
            return symmetry_transform(info[str(cls_id)])
    return None


class _ValContext:
    """Validation of ``train --eval-every`` on the object's test split
    (gdm_tpu/cli.py:401-480): the inference path of ``eval`` (a
    PoseEngine at the eval batch, the CUDA similarity kernel on the card)
    with the current weights, scored by ADD(-S) recall at 0.1 d and the
    VOC AUC.  Without a test split the run only warns."""

    def __init__(self, cfg, refd, cls_id, args, diameter_m, mesh_fps,
                 device, log):
        from gdm_tpu_torch.data.dataset import PoseDataset

        self.ok = False
        self.log = log
        try:
            self.ds = PoseDataset(cfg, cls_id, "test",
                                  data_root=args.data_root)
        except OSError as e:
            log.warning("--eval-every: test split unavailable (%s); "
                        "skipping validation", e)
            return
        if len(self.ds) == 0:
            log.warning("--eval-every: no test annotations for cls %d; "
                        "skipping validation", cls_id)
            return
        self.cfg, self.args, self.device = cfg, args, device
        self.bs = min(args.batch_size or cfg.solver.val_batch_size,
                      len(self.ds))
        self.is_sym = refd.id2obj[cls_id] in cfg.data.sym_objs
        self.diameter = diameter_m
        self.mesh_fps = mesh_fps
        self.gts = _gts_from_annos(self.ds)
        self.engine = None
        self.ok = True

    def run(self, model) -> dict | None:
        """{'val_add_auc', 'val_ad_10', 'val_frames'} of ``model``'s
        current weights, or None."""
        from gdm_tpu_torch import weights
        from gdm_tpu_torch.eval.metrics import add_err, adi_err, voc_auc
        from gdm_tpu_torch.serve import PoseEngine

        if not self.ok:
            return None
        sd = weights.reference_state_dict(model)
        if self.engine is None:
            self.engine = PoseEngine(
                self.cfg, _fps_mm(self.mesh_fps), sd, self.device,
                batch=self.bs,
                knn_chunk=knn_chunk_for(self.args.knn_chunk, self.bs,
                                        self.cfg, self.log))
        else:
            self.engine.load_weights(sd)
        errs = []
        for meta, _, pose, _ in _run_batches(
                self.engine, self.ds, self.bs, self.args.num_workers, []):
            gt = self.gts[meta["file_name"]]
            err_fn = adi_err if self.is_sym else add_err
            errs.append(err_fn(pose[:, :3], pose[:, 3], gt["R"], gt["t"],
                               self.mesh_fps[:, :3]))
        return {
            "val_add_auc": float(voc_auc(errs, max_dis=0.1)),
            "val_ad_10": float(np.mean(
                np.asarray(errs) < 0.1 * self.diameter) * 100.0),
            "val_frames": len(errs),
        }


def train(args):
    """Train one model per object (gdm_tpu/cli.py:481-733) on one device,
    or as one rank of several (``--multihost``; see the module docstring).

    Returns {'objects': {name: {'state', 'val'}}, 'timing': per-step
    {'obj', 'epoch', 'it', 'wait_ms', 'step_ms'}}: the host time waiting
    on the loader and the time to enqueue the step (the device runs
    asynchronously; the loss is read every 100 iterations)."""
    import torch

    from gdm_tpu_torch import refdata, weights
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import DataLoader
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.parallel import mesh as pmesh
    from gdm_tpu_torch.train.checkpoint import load_checkpoint, \
        save_checkpoint
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step
    from gdm_tpu_torch.utils.logging import JsonlLogger

    log = get_logger("train")
    cfg = model_config(args.dataset, args.opt)
    _log_exact_knn(args, cfg, log)
    refd = refdata.get(args.dataset)
    sol = cfg.solver
    epochs = args.epochs or sol.total_epochs
    batch_size = args.batch_size or sol.train_batch_size
    grid, device = _run_grid(args, batch_size)
    # the ranks of a model row load the same rows, those of a data
    # column the interleaved slices of each epoch's order
    d_rank, n_data = grid.data_rank, grid.data_size
    rank_bs = batch_size // n_data
    cls_ids = (list(cfg.data.obj_ids) if args.cls_id == "all"
               else [int(args.cls_id)])
    bnm = bn_momentum_schedule(sol.bn_momentum, sol.bn_decay,
                               sol.bn_decay_step, batch_size,
                               sol.bn_momentum_clip)
    lr = None
    result = {"objects": {}, "timing": []}
    pretrained = args.pretrained_backbone or cfg.model.pretrained_backbone
    pretrained_sd = None

    for cls_id in cls_ids:
        obj_name = refd.id2obj[cls_id]
        diameter_m = refd.diameters_mm_by_id[cls_id] / 1000.0
        mesh_fps = _object_mesh(cfg, cls_id, args.data_root)
        log.info("object %s (id %d), diameter %.3f m", obj_name, cls_id,
                 diameter_m)

        ds = PoseDataset(cfg, cls_id, "train", mesh_fps=mesh_fps,
                         data_root=args.data_root,
                         rng=np.random.RandomState(args.seed + d_rank),
                         diameter_m=diameter_m)
        dl = DataLoader(ds, rank_bs, shuffle=True, drop_last=True,
                        num_workers=args.num_workers, seed=args.seed,
                        rank=d_rank, world=n_data,
                        workers=args.loader_workers)
        log.info("%d samples, %d steps/epoch", len(ds), len(dl))
        if len(dl) == 0:
            raise SystemExit(f"{obj_name}: {len(ds)} samples is smaller "
                             f"than the batch {batch_size} (drop_last)")
        # one schedule for the run, sized by the first object (the JAX
        # CLI builds it once too): epochs * steps / clr_div
        if lr is None:
            lr = cyclic_lr(sol.base_lr, sol.max_lr,
                           max(epochs * len(dl) // sol.clr_div, 1))

        model, mesh, _, needs_pyramid = build_model(
            cfg, _fps_mm(mesh_fps), device, awl=True,
            sym_transform=_sym_transform(cfg, refd, cls_id, obj_name,
                                         args.data_root))
        weights.init_random_(model, torch.Generator().manual_seed(
            args.seed + cls_id))
        if pretrained:
            if not needs_pyramid:   # DGCNN has no CNN branch
                raise SystemExit("--pretrained-backbone needs the "
                                 "randla_spline (FFB6D) backbone")
            from gdm_tpu_torch.train.import_torch import (
                load_pretrained_backbone,
                read_torchvision_state,
            )

            if pretrained_sd is None:   # read once for --cls-id all
                pretrained_sd = read_torchvision_state(pretrained)
            load_pretrained_backbone(model, pretrained_sd)
            log.info("CNN backbone initialised from %s", pretrained)
        model.to(device)
        pmesh.attach(model, grid)
        pmesh.broadcast_module(model, grid)         # rank 0's start
        state = create_train_state(model, lr, sol.weight_decay,
                                   sol.skip_nonfinite)
        positive_r = cfg.model.neighbor_dis_th * diameter_m
        train_step = make_train_step(bnm, positive_r, args.knn_chunk,
                                     cfg.data.fill_depth, needs_pyramid,
                                     grid)

        ckpt_dir = osp.join(args.ckpt_root, "checkpoints", obj_name)
        start_epoch = 0
        if args.resume:
            state, ep = load_checkpoint(state, ckpt_dir)
            if ep is not None:
                start_epoch = ep + 1
                log.info("resumed from epoch %d", ep)
        # rank 0 alone validates (on its card, the whole test split),
        # writes the metrics stream and the checkpoints
        lead = grid.rank == 0
        val_ctx = (_ValContext(cfg, refd, cls_id, args, diameter_m,
                               mesh_fps, device, log)
                   if args.eval_every and lead else None)
        mlog = (JsonlLogger(osp.join(args.ckpt_root, "metrics",
                                     f"{obj_name}.jsonl")) if lead else None)
        notfinite_seen = 0
        rng = args.seed + 7 + cls_id
        val = None
        for epoch in range(start_epoch, epochs):
            dl.set_epoch(epoch)
            t0 = time.perf_counter()
            it_prev = 0
            it_dl = iter(dl)
            it = 0
            while True:
                tw = time.perf_counter()
                item = next(it_dl, None)
                wait = time.perf_counter() - tw
                if item is None:
                    break
                ts = time.perf_counter()
                metrics = train_step(state, item[0], mesh, rng)
                result["timing"].append({
                    "obj": obj_name, "epoch": epoch, "it": it,
                    "wait_ms": wait * 1e3,
                    "step_ms": (time.perf_counter() - ts) * 1e3})
                if it % 100 == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    sps = (it - it_prev + 1) * batch_size / max(dt, 1e-9)
                    step = state.step
                    log.info("epoch %d it %d loss %.4f (seg %.4f match %.4f) "
                             "%.2f s (%.1f samples/s)", epoch, it, m["loss"],
                             m["seg_loss"], m["match_loss"], dt, sps)
                    nf = int(m.get("total_notfinite", 0))
                    if nf > notfinite_seen:
                        log.warning("%d non-finite update(s) skipped so far "
                                    "(solver.skip_nonfinite guard)", nf)
                        notfinite_seen = nf
                    if not np.isfinite(m["loss"]):
                        log.warning("non-finite loss at epoch %d it %d",
                                    epoch, it)
                    if mlog is not None:
                        mlog.write({
                            "obj": obj_name, "epoch": epoch, "it": it,
                            "step": step, "loss": m["loss"],
                            "seg_loss": m["seg_loss"],
                            "match_loss": m["match_loss"],
                            # the update just logged read the schedule
                            # at step - 1
                            "lr": float(lr(max(step - 1, 0))),
                            "bn_momentum": m["bn_momentum"],
                            "samples_per_sec": round(sps, 2),
                            "total_notfinite": nf,
                        })
                    t0 = time.perf_counter()
                    it_prev = it + 1
                it += 1
            if lead and ((epoch + 1) % sol.checkpoint_every_epochs == 0
                         or epoch + 1 == epochs):
                path = save_checkpoint(state, ckpt_dir, epoch)
                log.info("checkpoint -> %s", path)
            if val_ctx is not None and ((epoch + 1) % args.eval_every == 0
                                        or epoch + 1 == epochs):
                val = val_ctx.run(state.model)
                if val is not None:
                    log.info("epoch %d val: add_auc %.2f ad_10 %.2f%% "
                             "(%d frames)", epoch, val["val_add_auc"],
                             val["val_ad_10"], val["val_frames"])
                    mlog.write({"obj": obj_name, "epoch": epoch, **val})
        if mlog is not None:
            mlog.close()
        result["objects"][obj_name] = {"state": state, "val": val}
    return result


def export_serving(args):
    """Write one object's serving artifact (serve.export_serving_artifact)
    at the engine batch ``--batch-size`` (default the eval batch), from
    ``--torch-checkpoint`` or ``<ckpt_root>/checkpoints/<object>``'s
    newest checkpoint; untrained weights are refused
    (gdm_tpu/cli.py:1497-1501).  Returns the artifact's meta."""
    from gdm_tpu_torch import refdata, weights
    from gdm_tpu_torch.serve import export_serving_artifact
    from gdm_tpu_torch.train.checkpoint import checkpoint_file

    log = get_logger("export-serving")
    _device(args)
    cfg = model_config(args.dataset, args.opt)
    _log_exact_knn(args, cfg, log)
    refd = refdata.get(args.dataset)
    cls_id = args.cls_id
    obj_name = refd.id2obj[cls_id]
    diameter = refd.diameters_mm_by_id[cls_id] / 1000.0
    batch = args.batch_size or cfg.solver.val_batch_size
    if args.torch_checkpoint:
        state = weights.read_reference_checkpoint(
            osp.join(args.torch_checkpoint, obj_name))
    else:
        ckpt_dir = osp.join(args.ckpt_root, "checkpoints", obj_name)
        path = checkpoint_file(ckpt_dir)
        if path is None:
            raise SystemExit(f"no checkpoint for {obj_name} in {ckpt_dir} "
                             "— refusing to export untrained weights")
        state = weights.read_reference_checkpoint(path)
    out_dir = args.out or osp.join("serving", args.dataset, obj_name)
    info = export_serving_artifact(
        out_dir, cfg, _fps_mm(_object_mesh(cfg, cls_id, args.data_root)),
        state, batch=batch,
        knn_chunk=knn_chunk_for(args.knn_chunk, batch, cfg, log),
        refine=args.refine, icp_reject=_icp_gate(args, cfg, diameter),
        dataset=args.dataset, opts=args.opt,
        meta={"obj_name": obj_name, "cls_id": cls_id,
              "diameter_m": diameter})
    log.info("exported %s -> %s (batch %d)", obj_name, out_dir, batch)
    return info


def start_server(args):
    """The PoseService of ``serve``'s artifacts (every engine built, and
    warmed up unless --no-warmup) and its bound HTTP server, not yet
    serving: the caller runs ``serve_forever()`` and ``shutdown()``s it."""
    from gdm_tpu_torch.server import PoseService, load_artifact_tree, \
        make_server

    log = get_logger("serve")
    device = _device(args)
    try:
        engines = load_artifact_tree(args.artifact, device)
    except (ValueError, OSError) as e:  # bad artifact, missing/non-dir path
        raise SystemExit(str(e))
    for name, eng in sorted(engines.items()):
        log.info("loaded %s (batch %d, %s)", name,
                 next(iter(eng.meta["raw_spec"].values()))[0][0], device)
    service = PoseService(engines)
    if not args.no_warmup:
        log.info("warming up %d object(s)...", len(engines))
        service.warmup()
    server = make_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    log.info("serving %d object(s) on http://%s:%d  (POST /pose, GET "
             "/healthz, GET /meta)", len(engines), host, port)
    return service, server


def serve_cmd(args):
    """HTTP pose service over exported artifacts until SIGINT."""
    _, server = start_server(args)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        get_logger("serve").info("shutting down")
    finally:
        server.server_close()


def build_parser():
    p = argparse.ArgumentParser("gdm_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def base(sp):
        sp.add_argument("--dataset", required=True,
                        choices=["lmo", "lmfull", "lm_full", "ycbv"])
        sp.add_argument("--data-root", required=True)
        sp.add_argument("--opt", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE",
                        help="config override, repeatable (e.g. "
                             "solver.val_batch_size=64)")
        sp.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler chrome trace of the "
                             "command here")

    def common(sp):
        base(sp)
        sp.add_argument("--cls-id", type=int, default=None,
                        help="single object (default: all in config)")
        sp.add_argument("--targets", default=None,
                        help="BOP test-targets JSON: only the listed "
                             "(scene, im, obj) instances")

    def device(sp, what="torch device"):
        sp.add_argument("--device", default="cuda",
                        help=f"{what} (default cuda; cpu on request)")

    def ranks(sp, shards=True):
        sp.add_argument("--devices", type=int, default=None,
                        help="start N ranks on this host, one per card "
                             "(NCCL) or CPU rank (gloo); default one")
        sp.add_argument("--multihost", action="store_true",
                        help="run as one rank of a torchrun-style run "
                             "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT) or of the caller's process "
                             "group")
        if shards:
            sp.add_argument("--model-shards", type=int, default=1,
                            help="split the mesh columns of the matching "
                                 "loss and the correspondence argmax over "
                                 "this many ranks (a (data, model) grid)")

    def engine(sp):
        sp.add_argument("--batch-size", type=int, default=None,
                        help="engine batch (default solver.val_batch_size)")
        sp.add_argument("--knn-chunk", type=int, default=1024,
                        help="KNN queries per distance block (lowered at "
                             "large batches to bound device memory)")
        device(sp)
        sp.add_argument("--exact-knn", action="store_true",
                        help="exact KNN pyramid and DGCNN graphs (the "
                             "port's only mode)")
        sp.add_argument("--refine", choices=["ransac", "icp", "meanshift"],
                        default=None, help="refine each fitted pose")
        sp.add_argument("--icp-reject", type=float, default=None,
                        help="ICP correspondence gate in metres (default "
                             "data.nn_dist_th x object diameter)")

    def run(sp):
        common(sp)
        engine(sp)
        ranks(sp)
        sp.add_argument("--num-workers", type=int, default=8,
                        help="loader decode threads")
        sp.add_argument("--torch-checkpoint", required=True,
                        help="directory of <object name>/geomatch.pth.tar "
                             "reference checkpoints")
        sp.add_argument("--save-viz", default=None, metavar="DIR",
                        help="write a pose-overlay PNG per frame onto its "
                             "input crop (prediction green; eval: GT blue)")

    t = sub.add_parser("train", help="train per-object models")
    base(t)
    t.add_argument("--cls-id", required=True,
                   help="object id, or 'all' for every object of the "
                        "config in turn")
    t.add_argument("--ckpt-root", default="train_log",
                   help="checkpoints/<object>/ and metrics/<object>.jsonl "
                        "go here")
    t.add_argument("--epochs", type=int, default=None,
                   help="default solver.total_epochs")
    t.add_argument("--batch-size", type=int, default=None,
                   help="default solver.train_batch_size (the validation "
                        "batch too)")
    t.add_argument("--resume", action="store_true",
                   help="continue from checkpoints/<object>/latest")
    t.add_argument("--eval-every", type=int, default=None,
                   help="validate on the test split every N epochs "
                        "(ADD(-S) recall at 0.1 d and VOC AUC)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--num-workers", type=int, default=8,
                   help="loader decode workers")
    t.add_argument("--loader-workers", choices=["thread", "process"],
                   default="thread",
                   help="decode worker kind: threads, or spawned processes")
    t.add_argument("--knn-chunk", type=int, default=1024,
                   help="KNN queries per distance block")
    device(t)
    t.add_argument("--pretrained-backbone", default=None,
                   help="torchvision resnet .pth/.npz: ImageNet init of "
                        "the CNN branch (overrides "
                        "model.pretrained_backbone)")
    ranks(t)

    e = sub.add_parser("eval", help="evaluate on the test set")
    run(e)
    e.add_argument("--output-dir", default="output")
    e.add_argument("--vsd", action="store_true",
                   help="BOP VSD errors, recall and AR (models_eval PLY "
                        "meshes)")

    i = sub.add_parser("infer", help="GT-less inference: rgb/depth + "
                                     "detections -> BOP results CSV")
    run(i)
    i.add_argument("--detections", default=None,
                   help="detection JSON (default <subset>/real_det.json)")
    i.add_argument("--output", default=None,
                   help="results CSV (default output/infer_<dataset>.csv)")
    i.add_argument("--stacked", action="store_true",
                   help="mixed-object batches, each row through its "
                        "object's model (eval/multimodel.py)")
    i.add_argument("--stacked-schedule", default="by_class",
                   choices=("by_class", "vmap"),
                   help="by_class: one forward per run of --stacked-group "
                        "same-object rows; vmap: one forward per row")
    i.add_argument("--stacked-group", type=int, default=4,
                   help="rows per forward of the by_class schedule")

    s = sub.add_parser("score", help="offline re-scoring of a BOP results "
                                     "CSV")
    common(s)
    s.add_argument("--csv", required=True)
    s.add_argument("--output-dir", default=None)
    s.add_argument("--vsd", action="store_true",
                   help="BOP VSD errors, recall and AR (models_eval PLY "
                        "meshes)")
    device(s, "torch device of the VSD renders")
    ranks(s, shards=False)

    x = sub.add_parser("export-serving",
                       help="write one object's serving artifact (meta, "
                            "weights, mesh) for cli serve")
    base(x)
    x.add_argument("--cls-id", type=int, required=True)
    engine(x)
    ranks(x, shards=False)
    x.add_argument("--ckpt-root", default="train_log",
                   help="read <ckpt_root>/checkpoints/<object>/latest "
                        "without --torch-checkpoint")
    x.add_argument("--torch-checkpoint", default=None,
                   help="directory of <object name>/geomatch.pth.tar "
                        "reference checkpoints")
    x.add_argument("--out", default=None,
                   help="artifact directory (default "
                        "serving/<dataset>/<object name>)")
    x.add_argument("--platforms", default="cuda,cpu",
                   help="recorded nothing: the artifact holds weights and "
                        "serves on any --device of serve")

    v = sub.add_parser("serve",
                       help="HTTP pose service over exported artifacts: "
                            "POST /pose (npz in, npz poses out) until "
                            "SIGINT")
    v.add_argument("--artifact", action="append", required=True,
                   metavar="DIR",
                   help="artifact directory (from export-serving), or a "
                        "root whose subdirectories are artifacts; "
                        "repeatable")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8360)
    v.add_argument("--no-warmup", action="store_true",
                   help="skip the synthetic warm-up batch per object (the "
                        "first request then pays the device's set-up)")
    device(v)
    v.add_argument("--profile-dir", default=None, help=argparse.SUPPRESS)
    return p


def _traces_cuda(args) -> bool:
    """Whether the command runs on the card: its --device is CUDA and,
    for score, it renders VSD."""
    import torch

    dev = getattr(args, "device", None)
    if dev is None or (args.command == "score" and not args.vsd):
        return False
    return torch.device(dev).type == "cuda"


def main(argv=None):
    import sys

    from gdm_tpu_torch.utils.logging import profiler_trace

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    n = getattr(args, "devices", None) or 1
    if n > 1 and args.command in ("train", "eval", "infer"):
        if args.multihost:
            raise SystemExit(f"--devices {n} out of range (1..1 per "
                             "process)")
        _check_stacked(args)
        _check_layout(n, getattr(args, "model_shards", 1), args.batch_size)
        # the ranks run the command; their outputs are rank 0's files
        return _spawn_ranks(argv, n, _device(args))
    commands = {"train": train, "eval": evaluate, "infer": infer,
                "score": score, "export-serving": export_serving,
                "serve": serve_cmd}
    with profiler_trace(args.profile_dir, cuda=bool(args.profile_dir)
                        and _traces_cuda(args)):
        return commands[args.command](args)


if __name__ == "__main__":
    main()

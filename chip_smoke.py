"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Setup: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, TF32 off for matmuls and convolutions, and the build of
   every CUDA kernel from the sources in this checkout (timed).
2. Kernel: ``cosine_argmax`` (the CUDA kernel) against
   ``cosine_argmax_reference`` on the same CUDA tensors, at the serving
   shape [8*4096, 128] x [4096, 128], at the eval shape [128*4096, 128] x
   [4096, 128], at a ragged [1100, 128] x [700, 128], with exactly tied
   mesh rows and with an all-zero scene row.  Scores agree within 1e-5,
   indices agree on every row whose plain top-2 gap exceeds 1e-5, ties go
   to the lowest index.  Median times of both at the two main-path shapes,
   beside the bound: 2*R*M*C over the f32 FMA peak of this card (SMs x 128
   lanes x 2 x its maximum SM clock).
3. Serving: GeoMatch at the LMO widths (4096 points, 4096 mesh vertices,
   256^2 crop, 128-d features) with seeded random weights, served by
   gdm_tpu_torch.server.PoseService over HTTP from a PoseEngine of batch 8.  A
   warm-up and three requests (batch 8, 3, 1) must give finite [b, 3, 4]
   poses whose R is orthonormal with det +1 (or the miss sentinel); the
   kernel must have launched once per served batch; the correspondences
   the engine used must match the plain argmax on the same features.
4. Eval: a synthetic BOP tree (LM-O object 1, 160 ``test`` frames at
   480x640, written by gdm_tpu_torch.data.synthetic) and seeded random
   weights as <ckpt>/ape/geomatch.pth.tar go through
   ``gdm_tpu_torch.cli eval`` at the LM-O preset and its eval batch of 128
   (a full batch and a padded one of 32).  The table, CSV (160 rows) and
   pickles must be written, every pose valid, and the kernel launched once
   per batch, the warm-up included.  ``cli infer`` on the same tree must
   give the eval CSV's rows and poses, and ``cli score`` of the eval CSV
   its recalls and AUC exactly.  Prints per-batch device ms, the loader's
   ms/sample, frames/s end to end and peak device memory.

Output: per-request latency lines, then one JSON line with the kernels,
the card's name and power limit, and the last line {"ok": true,
"device": {...}}.  Nothing of JAX or of the JAX package is imported: the
script blocks ``jax``, ``flax`` and ``gdm_tpu`` before any import, so
only ``gdm_tpu_torch`` runs.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import threading
import time

for _name in ("jax", "flax", "gdm_tpu"):   # the port runs alone
    sys.modules[_name] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

GAP = 1e-5          # top-2 gap below which an index flip is a near-tie
SCORE_TOL = 1e-5    # |kernel score - plain score|
POSE_TOL = 1e-5     # |infer pose - eval pose|, same frames and weights
SEED = 0
SERVE_SHAPE = (8 * 4096, 4096, 128)      # R, M, C at the served batch 8
EVAL_SHAPE = (128 * 4096, 4096, 128)     # R, M, C at the LM-O eval batch
EVAL_FRAMES = 160


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def median_ms(fn, *args, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_argmax(tag, idx, score, scene, mesh):
    """Kernel (idx, score) against the plain argmax of scene @ mesh.T;
    score None checks the indices alone.  Returns max |Δscore|."""
    from gdm_tpu_torch.ops.similarity import cosine_argmax_reference

    idx_ref, score_ref = cosine_argmax_reference(scene, mesh)
    top2 = torch.topk(scene @ mesh.T, min(2, mesh.shape[0]), dim=-1).values
    gap = top2[:, 0] - top2[:, -1]
    err = 0.0 if score is None else float((score - score_ref).abs().max())
    sure = gap > GAP
    bad = int(((idx != idx_ref) & sure).sum())
    log(f"  {tag}: rows {scene.shape[0]} x mesh {mesh.shape[0]}  "
        f"max|dscore| {err:.3g}  index mismatches {bad} of "
        f"{int(sure.sum())} rows with top-2 gap > {GAP}")
    if score is not None and not torch.isfinite(score).all():
        fail(f"{tag}: non-finite scores")
    if err > SCORE_TOL:
        fail(f"{tag}: |dscore| {err} > {SCORE_TOL}")
    if bad:
        fail(f"{tag}: {bad} index mismatches beyond near-ties")
    return err


def unit_rows(n, c, g):
    return torch.nn.functional.normalize(
        torch.randn(n, c, device="cuda", generator=g), dim=-1)


def fma_peak_flops() -> float:
    """f32 FMA peak of card 0: SMs x 128 lanes x 2 FLOP x max SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * 128 * 2 * float(mhz) * 1e6
    log(f"  f32 FMA peak: {sms} SMs x 128 x 2 x {mhz} MHz = "
        f"{peak / 1e12:.2f} TFLOP/s")
    return peak


def bound_ms(shape, peak) -> tuple[float, str]:
    """Least time for 2*R*M*C FLOP (the argmax of every scene row over
    every mesh row) or for moving the bytes (both inputs read once, idx
    and score written once) at 3.35 TB/s, whichever is larger."""
    r, m, c = shape
    ops_ms = 2.0 * r * m * c / peak * 1e3
    bytes_ms = ((r + m) * c * 4 + r * (8 + 4)) / 3.35e12 * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def time_shape(sim, tag, shape, g, peak, reps):
    """Kernel vs plain at ``shape``: agreement, median times, bound."""
    r, m, c = shape
    scene, mesh = unit_rows(r, c, g), unit_rows(m, c, g)
    idx, score = sim.cosine_argmax(scene, mesh)
    torch.cuda.synchronize()
    err = check_argmax(tag, idx, score, scene, mesh)
    del idx, score
    ms = median_ms(sim.cosine_argmax, scene, mesh, reps=reps)
    plain_ms = median_ms(sim.cosine_argmax_reference, scene, mesh,
                         reps=reps)
    bms, by = bound_ms(shape, peak)
    log(f"  median over {reps} launches at [{r},{c}]x[{m},{c}]: kernel "
        f"{ms:.4f} ms, plain (matmul + max) {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {2.0 * r * m * c / ms / 1e9:.2f} TFLOP/s "
        f"achieved)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def kernel_phase(sim):
    """Agreement everywhere; times at the serving and eval shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    peak = fma_peak_flops()
    errs = []
    at = {"serve": time_shape(sim, "serving shape", SERVE_SHAPE, g, peak,
                              reps=20),
          "eval": time_shape(sim, "eval shape", EVAL_SHAPE, g, peak,
                             reps=10)}
    errs += [at["serve"]["max_abs_err"], at["eval"]["max_abs_err"]]
    torch.cuda.empty_cache()

    scene, mesh = unit_rows(1100, 128, g), unit_rows(700, 128, g)
    errs.append(check_argmax("ragged", *sim.cosine_argmax(scene, mesh),
                             scene, mesh))

    base = unit_rows(300, 128, g)
    mesh = torch.cat([base, base[:150]])      # rows 300+i duplicate row i
    scene = base[:150].contiguous()
    idx, score = sim.cosine_argmax(scene, mesh)
    errs.append(check_argmax("exact ties", idx, score, scene, mesh))
    want = torch.arange(150, device="cuda")
    if not torch.equal(idx, want):
        fail(f"exact ties: {int((idx != want).sum())} rows did not take "
             "the lowest of two equal mesh rows")

    scene = unit_rows(64, 128, g)
    scene[5] = 0.0
    idx, score = sim.cosine_argmax(scene, unit_rows(500, 128, g))
    if int(idx[5]) != 0 or float(score[5]) != 0.0:
        fail(f"all-zero row: idx {int(idx[5])}, score {float(score[5])}")
    log("  exact ties -> lowest index; all-zero row -> index 0: ok")
    return max(errs), at


def random_weights(cfg):
    """Seeded random GeoMatch weights at ``cfg``'s widths.  Random seg
    heads rarely call any point foreground; the last seg layer is set so
    that every point is foreground and each frame runs the full fit (the
    miss path is covered by the CPU tests)."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch import GeoMatch

    model = GeoMatch(cfg.model.feat_dim, tuple(cfg.model.randla_d_out),
                     spline_kernel=cfg.model.spline_kernel)
    weights.init_random_(model, torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    sd["seg_layer.3.conv.weight"].zero_()
    sd["seg_layer.3.conv.bias"].copy_(torch.tensor([0.0, 1.0]))
    return sd


def make_request(b: int, im: int, n_sample: int, rng):
    """Loader ship format: random rgb, 4000-6000 depth counts at 10000
    counts/m, LMO-style intrinsics, random sampled pixels, det = 1."""
    K = np.array([[572.4, 0, im / 2], [0, 573.6, im / 2], [0, 0, 1]],
                 np.float32)
    return {
        "rgb_u8": rng.randint(0, 255, (b, im, im, 3)).astype(np.uint8),
        "dpt_u16": (4000 + 2000 * rng.rand(b, im, im)).astype(np.uint16),
        "dpt_scale": np.full((b,), 10000.0, np.float32),
        "K_crop": np.tile(K, (b, 1, 1)),
        "choose": rng.randint(0, im * im, (b, n_sample)).astype(np.int32),
        "det": np.ones((b,), np.int32),
    }


def check_poses(poses, b):
    if poses.shape != (b, 3, 4):
        fail(f"poses shape {poses.shape}, want {(b, 3, 4)}")
    if not np.isfinite(poses).all():
        fail("non-finite poses")
    miss = np.eye(3, 4)
    miss[2, 3] = -1000.0
    n_fit = 0
    for rt in poses:
        if rt[2, 3] <= -999.0:
            if not np.array_equal(rt, miss):
                fail(f"malformed miss pose {rt}")
            continue
        R = rt[:, :3].astype(np.float64)
        if np.abs(R @ R.T - np.eye(3)).max() > 1e-4 \
                or abs(np.linalg.det(R) - 1.0) > 1e-4:
            fail(f"R not a rotation: {R}")
        n_fit += 1
    return n_fit


def check_fit_indices(fit, sim, pose_fit):
    """The engine's correspondences against the plain argmax on the same
    features (launches of the plain version are not counted)."""
    f = pose_fit.l2_normalise(fit["rgbd"])
    mf = pose_fit.l2_normalise(fit["mesh"])
    idx = fit["idx"].reshape(-1)
    c = f.shape[-1]
    check_argmax("served batch", idx, None, f.reshape(-1, c), mf)


def slice_phase(sim):
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.synthetic import make_object
    from gdm_tpu_torch.eval import pose_fit
    from gdm_tpu_torch.serve import PoseEngine
    from gdm_tpu_torch.server import PoseService, make_server, request_poses

    im, n_sample = cfg.data.input_size, cfg.data.num_sample_points
    rng = np.random.RandomState(SEED)
    mesh_fps = make_object(cfg.model.n_mesh_node, rng, radius=0.08)
    sd = random_weights(cfg)

    t0 = time.perf_counter()
    engine = PoseEngine(cfg, mesh_fps, sd, "cuda", batch=8)
    torch.cuda.synchronize()
    log(f"  engine built (weights, mesh graph, mesh features) in "
        f"{time.perf_counter() - t0:.2f} s")
    service = PoseService({"lmo_synth": engine})
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    lat = {}
    try:
        sim.cosine_argmax.launches = 0
        t0 = time.perf_counter()
        service.warmup()
        log(f"  warm-up batch (b=8): {(time.perf_counter() - t0) * 1e3:.2f}"
            " ms")
        check_fit_indices(engine.last_fit, sim, pose_fit)
        for b in (8, 3, 1):
            raw = make_request(b, im, n_sample, rng)
            t0 = time.perf_counter()
            poses, compute_ms = request_poses(url, raw)
            ms = (time.perf_counter() - t0) * 1e3
            lat[b] = (ms, compute_ms)
            n_fit = check_poses(poses, b)
            log(f"  request b={b}: latency {ms:.2f} ms (server compute "
                f"{compute_ms:.2f} ms), {n_fit}/{b} frames fitted")
            check_fit_indices(engine.last_fit, sim, pose_fit)
        launches = sim.cosine_argmax.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if launches != 4:
        fail(f"cosine_argmax kernel launched {launches} times for 4 served "
             "batches (warm-up + 3 requests)")
    log(f"  kernel launches in the served run: {launches} (4 batches)")
    return launches


def read_csv_poses(path):
    """{(scene, im, obj): [3, 4] pose (t in metres)} of a BOP results CSV."""
    out = {}
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.strip().split(",")
            R = np.array(p[4].split(), float).reshape(3, 3)
            t = np.array(p[5].split(), float)[:, None] / 1000.0
            out[(int(p[0]), int(p[1]), int(p[2]))] = np.hstack([R, t])
    return out


def loader_ms_per_sample(cfg, root, batch, workers):
    """The loader alone (decode + crop + sampling, ``workers`` threads)
    over the eval frames, in batches of ``batch``."""
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import DataLoader

    ds = PoseDataset(cfg, 1, "test", data_root=root)
    t0 = time.perf_counter()
    n = sum(b["rgb_u8"].shape[0] for b, _ in DataLoader(ds, batch,
                                                        num_workers=workers))
    return (time.perf_counter() - t0) * 1e3 / n


def knn_chunk_sweep(cfg, root, ckpt, batch):
    """Peak device memory and time of one eval batch at KNN chunks 1024
    (the CLI's default), 512 (what it lowers to at batch 128) and 256.
    The chunk changes no result, only the distance blocks' size."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.serve import PoseEngine

    ds = PoseDataset(cfg, 1, "test", data_root=root)
    raw, _ = collate([ds[i] for i in range(batch)])
    raw = {k: raw[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop",
                               "choose", "det")}
    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    fps[:, :3] *= 1000.0
    engine = PoseEngine(cfg, fps, weights.read_reference_checkpoint(
        osp.join(ckpt, "ape")), "cuda", batch=batch)
    engine.run(raw)                                      # warm-up
    ref = None
    for chunk in (1024, 512, 256):
        engine.knn_chunk = chunk
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            poses = engine.run(raw)
        except torch.OutOfMemoryError:
            log(f"  knn chunk {chunk} at batch {batch}: out of device "
                "memory")
            continue
        ms = (time.perf_counter() - t0) * 1e3
        ref = poses if ref is None else ref
        log(f"  knn chunk {chunk} at batch {batch}: {ms:.2f} ms, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB, poses equal to the first chunk's: "
            f"{np.array_equal(poses, ref)}")
    del engine
    torch.cuda.empty_cache()


def eval_phase(sim, workdir):
    """cli eval | infer | score on a synthetic LM-O tree at batch 128.
    Returns the kernel launches of the eval run."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
    out, batch = osp.join(workdir, "out"), cfg.solver.val_batch_size
    t0 = time.perf_counter()
    write_synthetic_bop_root(
        root, make_object(cfg.data.model_pt_num, np.random.RandomState(SEED)),
        n_frames=EVAL_FRAMES, subsets=("test",), im_hw=cfg.data.img_hw,
        seed=SEED, obj_id=1)
    os.makedirs(osp.join(ckpt, "ape"))
    torch.save({"model_state": random_weights(cfg)},
               osp.join(ckpt, "ape", "geomatch.pth.tar"))
    log(f"  synthetic BOP tree ({EVAL_FRAMES} test frames, "
        f"{cfg.data.img_hw[0]}x{cfg.data.img_hw[1]}) and checkpoint written "
        f"in {time.perf_counter() - t0:.2f} s")
    workers = 8
    log(f"  host CPUs this process may run on: "
        f"{len(os.sched_getaffinity(0))} (os.cpu_count() {os.cpu_count()})")
    for n in (1, workers):
        log(f"  loader alone ({n} thread{'s' if n > 1 else ''}, batch "
            f"{batch}): {loader_ms_per_sample(cfg, root, batch, n):.3f} "
            "ms/sample")
    knn_chunk_sweep(cfg, root, ckpt, batch)

    common = ["--dataset", "lmo", "--data-root", root, "--torch-checkpoint",
              ckpt, "--cls-id", "1", "--exact-knn", "--num-workers",
              str(workers)]
    torch.cuda.reset_peak_memory_stats()
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    res = cli.main(["eval", *common, "--output-dir", out])
    wall = time.perf_counter() - t0
    launches = sim.cosine_argmax.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timing = res["timing"]
    for i, b in enumerate(timing):
        log(f"  eval batch {i}: {b['n']} frames (padded to {batch}), "
            f"device {b['device_ms']:.2f} ms, loader wait {b['wait_ms']:.2f}"
            f" ms ({b['wait_ms'] / (b['wait_ms'] + b['device_ms']):.1%} of "
            "the batch's wall time)")
    log(f"  eval: {EVAL_FRAMES} frames in {wall:.2f} s end to end = "
        f"{EVAL_FRAMES / wall:.2f} frames/s (engine build, warm-up and "
        f"scoring included); peak device memory {peak:.2f} GiB; kernel "
        f"launches {launches}")
    if launches != len(timing) + 1:
        fail(f"cosine_argmax launched {launches} times for {len(timing)} "
             "eval batches + the warm-up")
    for name in ("_lmo_tab.txt", "gt_lmo-test.csv", "_lmo_errors.pkl",
                 "_lmo_recalls.pkl"):
        if not osp.exists(osp.join(out, name)):
            fail(f"eval wrote no {name}")
    poses = read_csv_poses(osp.join(out, "gt_lmo-test.csv"))
    if len(poses) != EVAL_FRAMES:
        fail(f"eval CSV has {len(poses)} rows, want {EVAL_FRAMES}")
    n_fit = check_poses(np.stack(list(poses.values())), EVAL_FRAMES)
    log(f"  eval CSV: {len(poses)} rows, {n_fit} fitted, every R a rotation"
        " or the miss sentinel")

    infer_csv = osp.join(out, "infer.csv")
    sim.cosine_argmax.launches = 0
    cli.main(["infer", *common, "--output", infer_csv])
    if sim.cosine_argmax.launches != len(timing) + 1:
        fail(f"infer launched the kernel {sim.cosine_argmax.launches} times")
    inferred = read_csv_poses(infer_csv)
    if list(inferred) != list(poses):
        fail("infer CSV rows differ from eval's")
    dpose = max(float(np.abs(inferred[k] - poses[k]).max()) for k in poses)
    if dpose > POSE_TOL:
        fail(f"infer poses differ from eval's by {dpose}")
    log(f"  infer CSV: same {len(inferred)} rows, max |dpose| {dpose:.3g}")

    scored = cli.main(["score", "--dataset", "lmo", "--data-root", root,
                       "--cls-id", "1", "--csv",
                       osp.join(out, "gt_lmo-test.csv")])
    # the CSV carries t in mm, so t goes through *1000 and /1000: errors
    # may move in the last bit, hence the AUC tolerance
    dauc = abs(scored["auc"]["ape"] - res["auc"]["ape"])
    if scored["recalls"] != res["recalls"] or dauc > 1e-9:
        fail("score of the eval CSV does not reproduce eval's recalls/AUC")
    log(f"  score of the eval CSV reproduces eval's recalls exactly and its "
        f"AUC {res['auc']['ape']:.6f} to {dauc:.3g}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    log(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    from gdm_tpu_torch import _build
    from gdm_tpu_torch.ops import similarity as sim

    t0 = time.perf_counter()
    _build.load("similarity")
    log(f"kernel build: similarity {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _build.load("png_unfilter")
    log(f"host build: png_unfilter {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("similarity", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("kernel phase")
    err, at = kernel_phase(sim)
    log("serving phase")
    launches_serve = slice_phase(sim)
    log("eval phase")
    with tempfile.TemporaryDirectory() as workdir:
        launches_eval = eval_phase(sim, workdir)

    # one entry per kernel: the eval shape (batch 128, the main path the
    # package is scored by) first, then the serving shape
    log(json.dumps({"kernels": [{
        "name": "cosine_argmax",
        "route": "cuda",
        "source": "gdm_tpu_torch/csrc/similarity.cu",
        "replaces": "gdm_tpu/ops/pallas/similarity.py:89",
        "launches": launches_eval + launches_serve,
        "launches_eval": launches_eval,
        "launches_serve": launches_serve,
        "max_abs_err": err,
        "ms": at["eval"]["ms"],
        "plain_ms": at["eval"]["plain_ms"],
        "bound_ms": at["eval"]["bound_ms"],
        "bound_by": at["eval"]["bound_by"],
        "library_ms": None,
        "shape": list(EVAL_SHAPE),
        "serve": dict(at["serve"], shape=list(SERVE_SHAPE)),
    }]}))
    log(smi.splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

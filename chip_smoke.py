"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Setup: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, TF32 off for matmuls and convolutions, and the build of
   every CUDA kernel from the sources in this checkout (timed).
2. Kernel: ``cosine_argmax`` (the CUDA kernel) against
   ``cosine_argmax_reference`` on the same CUDA tensors, at the serving
   shape [8*4096, 128] x [4096, 128], at a ragged [1100, 128] x [700, 128],
   with exactly tied mesh rows and with an all-zero scene row.  Scores
   agree within 1e-5, indices agree on every row whose plain top-2 gap
   exceeds 1e-5, ties go to the lowest index.  Median times of both.
3. Slice: GeoMatch at the LMO widths (4096 points, 4096 mesh vertices,
   256^2 crop, 128-d features) with seeded random weights, served by
   gdm_tpu_torch.server.PoseService over HTTP from a PoseEngine of batch 8.  A
   warm-up and three requests (batch 8, 3, 1) must give finite [b, 3, 4]
   poses whose R is orthonormal with det +1 (or the miss sentinel); the
   kernel must have launched once per served batch; the correspondences
   the engine used must match the plain argmax on the same features.

Output: per-request latency lines, then one JSON line with the kernels,
then the last line {"ok": true, "device": {...}}.  Nothing of JAX or of
the JAX package is imported: the script blocks ``jax``, ``flax`` and
``gdm_tpu`` before any import, so only ``gdm_tpu_torch`` runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

for _name in ("jax", "flax", "gdm_tpu"):   # the port runs alone
    sys.modules[_name] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

GAP = 1e-5          # top-2 gap below which an index flip is a near-tie
SCORE_TOL = 1e-5    # |kernel score - plain score|
SEED = 0


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


def kernel_phase(sim):
    """Returns (max |Δscore|, kernel ms, plain ms) at the serving shape."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = []

    scene, mesh = unit_rows(8 * 4096, 128, g), unit_rows(4096, 128, g)
    idx, score = sim.cosine_argmax(scene, mesh)
    torch.cuda.synchronize()
    errs.append(check_argmax("serving shape", idx, score, scene, mesh))
    ms = median_ms(sim.cosine_argmax, scene, mesh)
    plain_ms = median_ms(sim.cosine_argmax_reference, scene, mesh)
    log(f"  median over 20 launches at [32768,128]x[4096,128]: kernel "
        f"{ms:.4f} ms, plain (matmul + max) {plain_ms:.4f} ms")

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
    return max(errs), ms, plain_ms


def make_mesh(n: int, rng: np.random.RandomState, radius: float = 0.08):
    """Roughly spherical object as an [n, 9] fps array (xyz mm | rgb |
    normal)."""
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.3 * np.sin(5 * dirs[:, 0]) * np.cos(5 * dirs[:, 1])
    pts = dirs * (radius * bump[:, None])
    rgb = ((dirs + 1) * 127.5).clip(0, 255)
    return np.concatenate([pts * 1000.0, rgb, dirs], 1).astype(np.float32)


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
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.eval import pose_fit
    from gdm_tpu_torch.models.geomatch import GeoMatch
    from gdm_tpu_torch.serve import PoseEngine
    from gdm_tpu_torch.server import PoseService, make_server, request_poses

    im, n_sample = cfg.data.input_size, cfg.data.num_sample_points
    rng = np.random.RandomState(SEED)
    mesh_fps = make_mesh(cfg.model.n_mesh_node, rng)

    model = GeoMatch(cfg.model.feat_dim, tuple(cfg.model.randla_d_out),
                     spline_kernel=cfg.model.spline_kernel)
    weights.init_random_(model, torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    # random seg heads rarely call any point foreground; make every point
    # foreground so each frame runs the full fit (the miss path is
    # covered by the CPU tests)
    sd["seg_layer.3.conv.weight"].zero_()
    sd["seg_layer.3.conv.bias"].copy_(torch.tensor([0.0, 1.0]))

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
    for line in _build.build_logs.get("similarity", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("kernel phase")
    err, ms, plain_ms = kernel_phase(sim)
    log("slice phase")
    launches = slice_phase(sim)

    log(json.dumps({"kernels": [{
        "name": "cosine_argmax",
        "route": "cuda",
        "source": "gdm_tpu_torch/csrc/similarity.cu",
        "replaces": "gdm_tpu/ops/pallas/similarity.py:89",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

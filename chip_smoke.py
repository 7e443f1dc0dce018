"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Setup: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, TF32 off for matmuls and convolutions, and the build of
   every CUDA kernel from the sources in this checkout (timed).
2. Kernel: ``cosine_argmax`` (the CUDA kernel) against
   ``cosine_argmax_reference`` on the same CUDA tensors, at the serving
   shape [8*4096, 128] x [4096, 128], at the eval shape [128*4096, 128] x
   [4096, 128], at the shape of train's validation [24*4096, 128] x
   [4096, 128], at a ragged [1100, 128] x [700, 128], with exactly tied
   mesh rows, with an all-zero scene row, at a ragged all-negative
   [1100, 128] x [700, 128] (every true score < 0, so a zero-filled mesh
   column would win if it were not masked), at C = 36 and 256 (a
   ragged k chunk; one consumer warpgroup) and at [100, 4] x [300, 4],
   [1, 128] x [700, 128] and [129, 128] x [1, 128].  Scores agree within 1e-5,
   indices agree on every row whose plain top-2 gap exceeds 1e-5, ties go
   to the lowest index.  The built library's SASS must hold HGMMA (the
   tensor cores' wgmma; cuobjdump), and ptxas's register and spill report
   is printed.  Median times of the kernel, the plain version and
   ``torch.matmul`` alone (cuBLAS's f32 GEMM, TF32 off: a yardstick the
   port never calls) at the three main-path shapes, beside the bound:
   3*2*R*M*C (the three TF32 passes of f32-accurate products) over the
   dense TF32 peak of this card (SMs x 1024 FMA x 2 x its maximum SM
   clock), with 2*R*M*C over the f32 FMA peak (SMs x 128 lanes x 2 x that
   clock) beside it.
3. Serving: a synthetic BOP tree (LM-O object 1, 160 ``test`` frames at
   480x640, written by gdm_tpu_torch.data.synthetic) and seeded random
   weights (GeoMatch at the LMO widths: 4096 points, 4096 mesh vertices,
   256^2 crop, 128-d features) as <ckpt>/ape/geomatch.pth.tar, the tree
   of the phases below.  ``cli export-serving --batch-size 8`` of the
   checkpoint, then ``cli serve`` of the artifact on a thread (its
   PoseService over HTTP).  A warm-up and three requests (batch 8, 3, 1),
   then 10 timed requests each at b=1 and b=8, must give finite [b, 3, 4]
   poses whose R is orthonormal with det +1 (or the miss sentinel); the
   kernel must have launched once per served batch, and every batch's
   correspondences must match the plain argmax on the same features.
   Prints p50 and p95 latency (client clock, HTTP included) at b=1 and
   b=8.  Then ``python -m gdm_tpu_torch.cli serve`` in a process of its
   own answers /healthz and one /pose, and exits 0 on SIGINT.
4. Eval: that tree and checkpoint go through ``gdm_tpu_torch.cli eval``
   at the LM-O preset and its eval batch of 128 (a full batch and a
   padded one of 32).  The table, CSV (160 rows) and pickles must be
   written, every pose valid, and the kernel launched once per batch, the
   warm-up included.  ``cli infer --save-viz`` on the same tree must give
   the eval CSV's rows and poses and 160 overlay PNGs that imio decodes,
   and ``cli score`` of the eval CSV its recalls and AUC exactly.  Prints
   per-batch device ms, the loader's ms/sample, frames/s end to end and
   peak device memory.  Profile: ``cli eval --profile-dir`` of the same
   tree; from the chrome trace's kernel (and copy) events, the share of
   each timed batch's window (its ``cli.BATCH_SPAN`` range) in which the
   device was busy, and kernel time by name; each traced batch's fit is
   held against the plain argmax after the trace.
5. Refine: ``cli eval --refine ransac|icp|meanshift`` at b=128 on the
   eval phase's tree and checkpoint: one kernel launch per batch plus the
   warm-up, every batch's correspondences held against the plain argmax,
   160 valid rows, the unrefined run's miss sentinels kept; per-batch
   device ms beside refine=None's and peak memory.  Then the refine ops
   on the card against the CPU on a well-posed problem (posed mesh
   points, 2 mm noise, 30% outliers, b=128 x 4096): equal RANSAC
   hypotheses, poses within REFINE_CARD_TOL, each op's time at b=128.
6. VSD: (a) ``cli eval --vsd`` at b=128 on the eval phase's tree (its
   object's models_eval PLY: the outward-wound convex hull of the fps
   points), then ``cli score --vsd`` of its CSV: the similarity kernel
   launched once per batch plus the warm-up, the scatter renderer (the
   stamp kernel) called and no host binning (bin_faces_to_slots and its
   kin wrapped, 0 calls), the vsd / ar_vsd / bop19_ar rows in the table,
   the same VSD errors (within 1e-6: t goes through mm) from both; the
   stamp held against its plain version on the eval's first chunk and
   timed there.  (b) bench.py's hard VSD workload at 32 frames: the
   20,480-face trefoil, cluttered 480x640 test depths whose GT is
   rendered by the stamp kernel (held against its plain version),
   through ``vsd_err_batch`` in pipelined chunks of at most 16 (one per
   window and z bucket): ms/frame of two runs (equal errors) and peak
   memory, no host binning; the gather form
   (``render_depth_window_gather``, the JAX package's VSD renderer) on
   every chunk, its slot table binned on the host, equal to the stamp's
   depths; the card's errors equal to the CPU's on 2 frames.  The stamp
   and gather kernels each held against its plain version bit for bit
   on the first chunk, and each one's and its plain version's time there
   (the whole wrapper call) beside its bound (18 flops per (face, pixel)
   test that its data needs, the pixels that each kept face can cover,
   over the f32 FMA peak, or the bytes at 3.35 TB/s).
7. Stacked: a synthetic tree of the 8 LM-O objects x 16 ``test`` frames,
   a seeded random checkpoint each, through ``cli infer --stacked``
   (by_class, group 4), ``--stacked-schedule vmap``, ``--stacked
   --refine icp`` and the per-object ``cli infer``: the same CSV rows,
   valid poses, kernel launches as scheduled (one per group, or per row,
   plus the warm-up); in process, one mixed batch of 128 through the
   stacked engine (both schedules) against each object's engine, each
   object's features centred so that its matches spread and its fits are
   well posed (every stacked correspondence held against the plain
   argmax, Kabsch weights equal, correspondences equal beyond near-ties,
   poses within STACKED_POSE_TOL where the weighted correspondences
   agree); frames/s and peak memory of each run.
8. Train: a synthetic LM-O tree (object 1, 240 JPEG ``train_pbr`` frames
   and 48 ``test`` frames) goes through ``gdm_tpu_torch.cli train`` at the
   LM-O widths and ``train_batch_size`` 24: two epochs validating each
   (the similarity kernel must launch), starting from a seeded state
   dict under torchvision's resnet18 names (``--pretrained-backbone``:
   every tensor but ``fc`` held in the model bit for bit before the first
   step), then ``--epochs 3 --resume``
   (one more epoch, from the checkpoint), then ``cli eval
   --torch-checkpoint <ckpt_root>/checkpoints`` of the result.  Every
   batch that validation and that eval fit is held against the plain
   argmax on the same features (FitChecks).  Per-step loader wait and
   step times, and the step loop's samples/s and loader-wait share in
   three groups of steps (step_loop_rates): cold, while the loader's
   threads decode, and after they finished the epoch.  Then: the
   train step on the card against the same step on the CPU from the same
   state and batch at a small size (in float64, each gradient tensor
   within 1e-3; in f32, the loss within 1e-4 and each gradient tensor
   within 8x the card's own f32 spread (its inputs moved by a relative
   1e-7), plus 1e-3, of the CPU's float64 gradient); 30 steps on one fixed batch of
   24 at full width, whose last 5 losses must average below the first
   5; the step split (inputs, forward, backward, optimizer) and
   device-only samples/s, the loader's ms/sample in train mode by stage
   and the train run's peak device memory.
9. DGCNN (``--opt model.backbone=dgcnn``, seeded random weights, seg
   head set so every point is foreground): ``cli eval`` at b=128 on the
   eval phase's tree (160 valid rows, one kernel launch per batch plus
   the warm-up, every batch held against the plain argmax), ``cli infer``
   (the same rows and poses) and ``cli score`` (the same recalls); ``cli
   train`` at b=24 on the train phase's tree, one epoch validating, then
   ``cli eval`` of its checkpoint (finite losses, every validation and
   eval batch held against the plain argmax).  The forward at b=128 with
   its three scene graphs' share (each synchronised) and the mesh
   branch's encode ms; the train step split and device-only samples/s at
   b=24 and peak memory.  The forward and one train step on the card
   against the CPU at full n and b=2: the card's graphs equal beyond
   near-ties to the CPU's top-k on the same coordinates, the CPU's
   forward on the card's graphs within 1e-4; the step on the CPU's
   graphs: loss within 1e-4, float64 gradients per tensor within 1e-3,
   f32 ones within 8 s_t + 1e-3 of the CPU's float64 (step_parity's
   rule, the mesh input moved too).
10. YCB-V: a synthetic YCB-V tree at 480x640 (the 21 objects, 128
   ``test`` frames: 8 of object 1, 6 of each other; 12 frames of object 1
   in each of ``train_real`` (PNG, depth in mm), ``train_pbr`` (JPEG) and
   ``train_synt``; models_info.json with 024_bowl's continuous symmetry)
   and one seeded random checkpoint for every object, at the YCB-V preset
   (``fill_depth``, the real/pbr mix): the loader's ms/sample with and
   without the depth fill (in turns, after an untimed pass) and the fill
   alone per 256^2 crop;
   ``finalize_batch(fill_depth=True)`` on the card against the CPU
   (within 1e-4), the chosen hole pixels taking their normals from the
   filled depth; ``cli eval --dataset ycbv --vsd`` at b=128 on object 1
   (its fps hull as models_eval; VSD errors equal to the CPU's on the
   same inputs, no host binning);
   ``cli infer --stacked`` (by_class, group 4) on one mixed batch of 128
   over the 21 objects, every row's correspondences held against the
   plain argmax of its object's mesh features; ``cli train --dataset
   ycbv`` at b=8 with train_synt added (records of every kind picked,
   the noise, background paste and fill run, finite losses), then ``cli
   eval`` of its checkpoint.  Device ms per batch (also without the
   plain checks' time), frames/s, step times and peak memory of each
   run.

11. bf16 (``--opt model.compute_dtype=bfloat16``) on the eval and train
   trees: ``cli eval`` at b=128 (per-batch device ms and peak memory
   beside the eval phase's f32 ones), ``cli eval --profile-dir`` (the
   convolution kernels of a traced batch beside the f32 profile's; none
   may be an f32 one), one full-width batch of 2 through GeoMatch in bf16
   on the card against the CPU (seg and rgbd within 2x the CPU's own
   bf16-vs-f32 gap and 2e-2; the f32 mesh branch within 1e-4), ``cli
   train`` at b=24 for one epoch with ``model.gather_bwd_dtype=bfloat16``
   too (finite losses), 15 steps on a fixed batch (the loss falls; the
   step split beside the train phase's f32 one; 3 traced steps: kernel
   time by name and the gather backward's index_add_ kernels), and DGCNN
   ``cli eval`` at b=128 beside the dgcnn phase's f32 batches.  Every
   batch fitted is held against the plain argmax (the traced runs' after
   the trace).

12. Parallel (after bf16, before YCB-V; ``torch.cuda.device_count()``
   is printed at the start): two ranks spawned on card 0 over gloo,
   each making the process group itself and then calling
   ``cli.main(... --device cuda:0 --multihost)``: ``cli train`` b=4 (2
   rows per rank, one epoch of 8 JPEG frames, rank 1 given its own
   --ckpt-root, dropout off), ``--resume`` to 2 epochs on both from rank
   0's checkpoints, ``cli eval`` of it at b=4 (the gathered evaluator),
   ``cli train --model-shards 2`` b=4 and ``cli eval --model-shards 2``
   b=32 on the eval tree (2048 mesh columns per rank).  Every similarity
   launch of the ranks is held against the plain argmax of its own
   inputs (a column shard's), every merged sharded argmax against the
   unsharded kernel over all 4096 columns (equal beyond near-ties,
   |dscore| <= 1e-5; that launch is not counted), rank 0 alone must
   have written checkpoints and metrics, and each run's first loss must
   lie within 1e-4 of one process's step on the same rows (its seg and
   matching losses printed beside that process's own spread under
   swapped rows).  Per rank: step ms, samples/s, peak memory, the
   sharded argmax's and the shard kernel's synchronised ms, the host
   gather's ms, per-batch device ms; the shard's launch alone at its
   shape beside its bound.  With two or more cards, the same runs and
   checks over NCCL on min(cards, 4) ranks, one card each (a 4 x 1 and a
   2 x 2 grid on four), then ``cli train --devices 2`` through the CLI's
   own spawn held against the same command run as two ``--multihost``
   NCCL ranks spawned here (dropout on and torch's TF32 defaults in both,
   as a user runs it): the first logged losses within DEVICES_TOL (equal
   but for rounding), the checkpoints' difference printed.  Last, the
   port's dry runs (``gdm_tpu_torch.dryrun``) on min(cards, 4) cards over
   NCCL (one card: the data-parallel stage on one rank).  A failed check
   or rank fails the run.

   With two or more cards, also ``cli train --dataset lmfull
   --model-shards 2`` at b=6 on two NCCL ranks for 2 steps (finite
   losses), each rank's peak device memory beside the same command's on
   one card.

13. LM-full (the preset at its own shapes: 12800 points, 128^2
   crops, 4096 mesh vertices, 128-d features, f32, exact pyramid,
   seeded random weights on object 1): a synthetic tree at 480x640
   (48 ``test`` frames, 24 each of ``real``, ``fuse`` and ``renders``
   with depth in millimetres, read /1000; a background behind the
   object in test, real and fuse frames; 1 mm of depth noise).
   Serving first: ``cli export-serving --dataset lmfull --batch-size 8``
   and ``cli serve`` of it on a thread, the warm-up, then 10 timed
   requests each at b=8 and b=1, every served batch held against the
   plain argmax (p50 and p95 printed).  ``cli eval | infer | score`` at
   b=8 (every batch held; infer's rows and poses equal eval's, score's
   recalls equal eval's; device ms per batch and peak memory).  ``cli
   train`` at b=6 for one epoch of the three train subsets, validating
   (every batch held; finite losses), then 15 steps on one fixed batch
   of 6 (finite losses; the step split and peak memory).  One
   full-width batch of 2 through GeoMatch on the card and on the CPU
   from the card's inputs and pyramid: seg, rgbd and mesh within
   LMFULL_TOL.  The kernel alone at [102400,128] x [4096,128] (served
   and eval b=8) and [76800,128] x [4096,128] (train validation, b=6)
   beside its plain version, torch.matmul and the bounds.

14. Convergence (last): ``python -m gdm_tpu_torch.train_synthetic_demo``
   in process at its default shapes (the flagship in f32: 64 rendered
   train frames and 8 test frames of one synthetic object, 128^2 crops,
   1024 points, a 512-vertex mesh, b=8, 300 steps from seeded weights):
   the untrained and the trained evaluation each launch the similarity
   kernel once, every launch held against the plain argmax
   (LaunchChecks), and the trained mean ADD must lie below 0.1 x the
   object's diameter and at most half the untrained one.  Prints ADD,
   rotation and translation before and after, steps/s and peak memory.

15. Surface (right after the eval phase, on its tree): every
   file of tests/data/imio/ (progressive JPEGs of each subsampling, with
   restart markers and successive approximation, Adam7 PNGs, EXIF
   orientations in JPEG and PNG, gAMA / sRGB PNGs that libpng reads gray
   through its gamma tables) read by the port with each of
   IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED to the sha256
   that cv2 gave (manifest.json; this host has no cv2).  Then a copy of
   the eval tree whose ``test`` rgb PNGs are rewritten as Adam7 with an
   eXIf orientation (1-8 in turn, the pixels stored pre-rotated by its
   inverse, so the decoded frame is unchanged) and whose depth PNGs as
   Adam7 (IMREAD_UNCHANGED ignores orientation), by this script's own
   writer: ``cli eval`` at b=128 on it must give the eval phase's CSV
   rows exactly (the time column aside), every batch held against the
   plain argmax.  Last, the device depth fill (ops/depth_fill:
   fill_in_fast and fill_in_multiscale on a 480x640 depth frame with 30%
   dropouts, within 1e-6 x max_depth: they filter max_depth - depth)
   and pointops (farthest_point_sample n 4096 m 1024, equal; ball_query
   of its 1024 centres, k 16, r 1 cm, and three_nn_interpolate of
   1024 x 128 features onto the 4096 points, equal beyond near-ties) on
   the card against the CPU, and the host native k-NN and voxel grid
   (gdm_tpu_torch.native) against their plain versions, each timed
   beside the card's name and power limit.

``python3 chip_smoke.py parallel`` runs the setup and phase 12 alone (on
a host with four cards: its NCCL runs on four ranks), then prints the
last line; ``python3 chip_smoke.py lmfull`` runs the setup and phase 13
alone; ``python3 chip_smoke.py surface`` runs the setup, the eval tree
and its ``cli eval``, then phase 15 alone; ``python3 chip_smoke.py
convergence`` runs the setup, phase 14's
check on every row of CONVERGENCE_ROWS (flagship and DGCNN, f32 and
bf16, at the demo's shapes and at LM-full's: 12800 points, 4096
vertices, b=6, 120 steps), reporting a failed row and going on, then
``python -m gdm_tpu_torch.dress_rehearsal`` at its default shapes for
REHEARSAL_EPOCHS epochs (every similarity launch held against the plain
argmax; its eval / infer + score, stacked / per-object and served /
eval checks at their bounds), the rehearsal's step rate with and
without the loader's decode, and fails at the end if any row failed.

Output: per-request latency lines, then one JSON line with the kernels
(``launches_serve`` the CLI-served batches, ``launches_profile`` the
traced eval's, ``launches_bf16`` the bf16 phase's, ``launches_parallel``
the parallel phase's ranks', ``launches_lmfull`` the LM-full phase's
served, eval, infer and validation batches, ``launches_convergence``
the convergence phase's two evaluations, ``launches_surface`` the
surface phase's eval batches), the card's name and power
limit, and the last line
{"ok": true, "device": {...}}.  Nothing of JAX or of the JAX package is imported: the
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

ROOT = osp.dirname(osp.abspath(__file__))
GAP = 1e-5          # top-2 gap below which an index flip is a near-tie
SCORE_TOL = 1e-5    # |kernel score - plain score|
POSE_TOL = 1e-5     # |infer pose - eval pose|, same frames and weights
SEED = 0
SERVE_BATCH = 8
LATENCY_REQUESTS = 10    # timed requests at each of b=1 and b=8
SERVE_SHAPE = (SERVE_BATCH * 4096, 4096, 128)   # R, M, C served
EVAL_SHAPE = (128 * 4096, 4096, 128)     # R, M, C at the LM-O eval batch
EVAL_FRAMES = 160
TRAIN_FRAMES, VAL_FRAMES, TRAIN_BATCH = 240, 48, 24
TRAIN_VAL_SHAPE = (TRAIN_BATCH * 4096, 4096, 128)   # train's validation
REFINE_MODES = ("ransac", "icp", "meanshift")
# frames of the card-against-CPU refine check (frame 1 has half of its
# weights 0); mean-shift takes ~0.2 s per shift and frame on 8 host cores
# and reaches its cap of 50 shifts here
REFINE_CPU_FRAMES = {"ransac": 8, "icp": 8, "meanshift": 2}
# |card pose - CPU pose| of a refine op.  Mean-shift's centre is the first
# of the shifted points tied for the most neighbours within the bandwidth;
# on the refine problem every frame reaches the 50-shift cap, and those
# points still spread over up to 2.7 mm (CPU, 3 frames): a count that
# differs by one at the bandwidth's edge picks another of them.
REFINE_CARD_TOL = {"ransac": 1e-4, "icp": 1e-4, "meanshift": 5e-3}
STACKED_FRAMES, STACKED_GROUP = 16, 4   # per object; rows per forward
STACKED_POSE_TOL = 1e-4   # |stacked pose - per-object pose|, same matches


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


def peak_flops(fma_per_sm: int = 128, what: str = "f32 FMA") -> float:
    """Peak of card 0: SMs x FMAs per SM and clock (128 f32 FMA lanes;
    1024 dense TF32 FMAs on the tensor cores) x 2 FLOP x max SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * fma_per_sm * 2 * mhz * 1e6
    log(f"  {what} peak: {sms} SMs x {fma_per_sm} x 2 x {mhz:.0f} MHz = "
        f"{peak / 1e12:.2f} TFLOP/s")
    return peak


def bound_ms(shape, tf32_peak, fma_peak) -> tuple[float, str, float]:
    """Least time for the argmax of every scene row over every mesh row
    with f32-accurate products: the three TF32 tensor-core passes,
    3*2*R*M*C FLOP over the dense TF32 peak, or moving the bytes (both
    inputs read once, idx and score written once) at 3.35 TB/s, whichever
    is larger; beside it, 2*R*M*C over the f32 FMA peak."""
    r, m, c = shape
    ops_ms = 3 * 2.0 * r * m * c / tf32_peak * 1e3
    bytes_ms = ((r + m) * c * 4 + r * (8 + 4)) / 3.35e12 * 1e3
    fma_ms = 2.0 * r * m * c / fma_peak * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", fma_ms
    return bytes_ms, "bytes", fma_ms


def time_shape(sim, tag, shape, g, peaks, reps):
    """Kernel vs plain at ``shape``: agreement, median times of the
    kernel, the plain version and the matmul alone, bound."""
    r, m, c = shape
    scene, mesh = unit_rows(r, c, g), unit_rows(m, c, g)
    idx, score = sim.cosine_argmax(scene, mesh)
    torch.cuda.synchronize()
    err = check_argmax(tag, idx, score, scene, mesh)
    del idx, score
    ms = median_ms(sim.cosine_argmax, scene, mesh, reps=reps)
    plain_ms = median_ms(sim.cosine_argmax_reference, scene, mesh,
                         reps=reps)
    matmul_ms = median_ms(lambda: torch.matmul(scene, mesh.T), reps=reps)
    bms, by, fma_ms = bound_ms(shape, *peaks)
    tflops = 3 * 2.0 * r * m * c / ms / 1e9
    log(f"  median over {reps} launches at [{r},{c}]x[{m},{c}]: kernel "
        f"{ms:.4f} ms, plain (matmul + max) {plain_ms:.4f} ms, matmul "
        f"alone {matmul_ms:.4f} ms; bound {bms:.4f} ms ({by}; 3 TF32 "
        f"passes), {100 * bms / ms:.1f}% of it; f32 FMA bound "
        f"{fma_ms:.4f} ms; {tflops:.2f} TF32 TFLOP/s achieved, "
        f"{100 * tflops * 1e12 / peaks[0]:.1f}% of the TF32 peak")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "bound_fma_ms": fma_ms,
            "matmul_ms": matmul_ms, "tf32_tflops": tflops}


def hgmma_count() -> int:
    """HGMMA instructions (the tensor cores' wgmma) in the SASS of the
    built similarity library; fails if there are none."""
    import shutil

    from gdm_tpu_torch import _build

    tool = shutil.which("cuobjdump") or osp.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = osp.join(_build.BUILD_DIR, "libsimilarity.so")
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    log(f"  SASS of {osp.basename(lib)}: {n} HGMMA instructions")
    if not n:
        fail("the similarity kernel's SASS holds no HGMMA")
    return n


def kernel_phase(sim):
    """Agreement everywhere; times at the three main-path shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n_hgmma = hgmma_count()
    peaks = (peak_flops(1024, "dense TF32"), peak_flops())
    errs = []
    at = {"serve": time_shape(sim, "serving shape", SERVE_SHAPE, g, peaks,
                              reps=20),
          "eval": time_shape(sim, "eval shape", EVAL_SHAPE, g, peaks,
                             reps=10),
          "train_val": time_shape(sim, "train validation shape",
                                  TRAIN_VAL_SHAPE, g, peaks, reps=20)}
    errs += [v["max_abs_err"] for v in at.values()]
    torch.cuda.empty_cache()

    scene, mesh = unit_rows(1100, 128, g), unit_rows(700, 128, g)
    errs.append(check_argmax("ragged", *sim.cosine_argmax(scene, mesh),
                             scene, mesh))

    # every true score < 0: a zero-filled column past M would score 0
    scene, mesh = -unit_rows(1100, 128, g).abs(), unit_rows(700, 128, g).abs()
    idx, score = sim.cosine_argmax(scene, mesh)
    errs.append(check_argmax("all-negative ragged", idx, score, scene, mesh))
    if int(idx.max()) >= 700 or float(score.max()) >= 0.0:
        fail(f"all-negative ragged: idx max {int(idx.max())}, score max "
             f"{float(score.max())}: a padded column won")

    # a ragged k chunk; one consumer warpgroup; a box wider than C; one
    # scene row; one mesh row
    for r, m, c in ((1100, 700, 36), (1100, 700, 256), (100, 300, 4),
                    (1, 700, 128), (129, 1, 128)):
        scene, mesh = unit_rows(r, c, g), unit_rows(m, c, g)
        errs.append(check_argmax(f"[{r},{c}]x[{m},{c}]",
                                 *sim.cosine_argmax(scene, mesh),
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
    return max(errs), at, n_hgmma


def random_weights(cfg, seed=SEED):
    """Seeded random GeoMatch weights at ``cfg``'s widths.  Random seg
    heads rarely call any point foreground; the last seg layer is set so
    that every point is foreground and each frame runs the full fit (the
    miss path is covered by the CPU tests)."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch import GeoMatch

    model = GeoMatch(cfg.model.feat_dim, tuple(cfg.model.randla_d_out),
                     spline_kernel=cfg.model.spline_kernel)
    weights.init_random_(model, torch.Generator().manual_seed(seed))
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


def check_fit_indices(fit, sim, pose_fit, tag="served batch"):
    """The engine's correspondences against the plain argmax on the same
    features (launches of the plain version are not counted)."""
    f = pose_fit.l2_normalise(fit["rgbd"])
    mf = pose_fit.l2_normalise(fit["mesh"])
    idx = fit["idx"].reshape(-1)
    c = f.shape[-1]
    check_argmax(tag, idx, None, f.reshape(-1, c), mf)


class FitChecks:
    """While active, every batch a PoseEngine fits is held against the
    plain argmax on the same features (check_fit_indices): PoseEngine.infer
    is wrapped for the duration.  Counts the batches checked and the
    seconds the checks took, and keeps each batch's check milliseconds
    (after a synchronise) for callers that subtract them from the batch's
    device time."""

    def __init__(self, sim, tag, defer=False):
        self.sim, self.tag = sim, tag
        self.n, self.seconds = 0, 0.0
        self.check_ms = []          # per batch, the warm-up's first
        # defer: keep each batch's fit and check them all on exit, so that
        # a traced run's batches hold no plain-check kernels
        self.defer, self.kept = defer, []

    def __enter__(self):
        from gdm_tpu_torch.eval import pose_fit
        from gdm_tpu_torch.serve import PoseEngine

        self.orig = orig = PoseEngine.infer

        def infer(engine, fin):
            poses = orig(engine, fin)
            if self.defer:
                self.kept.append(engine.last_fit)
                return poses
            if poses.is_cuda:           # the fit's own time stays out
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            check_fit_indices(engine.last_fit, self.sim, pose_fit,
                              f"{self.tag} batch {self.n}")
            self.check_ms.append((time.perf_counter() - t0) * 1e3)
            self.seconds += self.check_ms[-1] / 1e3
            self.n += 1
            return poses

        PoseEngine.infer = infer
        return self

    def __exit__(self, *exc):
        from gdm_tpu_torch.eval import pose_fit
        from gdm_tpu_torch.serve import PoseEngine

        PoseEngine.infer = self.orig
        for fit in self.kept:
            check_fit_indices(fit, self.sim, pose_fit,
                              f"{self.tag} batch {self.n}")
            self.n += 1
        self.kept = []


def write_eval_tree(workdir):
    """The synthetic LM-O tree (object 1, EVAL_FRAMES ``test`` frames at
    480x640) and its seeded random checkpoint <ckpt>/ape/geomatch.pth.tar
    that the serving, eval, refine, VSD and DGCNN phases read."""
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
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
    return root, ckpt


def serve_subprocess(art_root, im, n_sample, rng):
    """``python -m gdm_tpu_torch.cli serve`` as a process of its own:
    /healthz and one /pose request answered, then exit 0 on SIGINT."""
    import signal
    from urllib.request import urlopen

    from gdm_tpu_torch.server import request_poses

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gdm_tpu_torch.cli", "serve", "--artifact",
         art_root, "--port", "0"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stderr=subprocess.PIPE,
        text=True)
    watchdog = threading.Timer(300.0, proc.kill)
    watchdog.start()
    try:
        url = None
        for line in proc.stderr:
            if "serving 1 object(s) on " in line:
                url = line.split(" on ")[1].split()[0]
                break
        if url is None:
            fail(f"cli serve process gave no serving line (rc "
                 f"{proc.poll()})")
        ready = time.perf_counter() - t0
        with urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"] or health["objects"] != ["ape"]:
            fail(f"cli serve process /healthz: {health}")
        poses, _ = request_poses(url, make_request(1, im, n_sample, rng))
        check_poses(poses, 1)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    if rc != 0:
        fail(f"cli serve process exited {rc} on SIGINT")
    log(f"  python -m gdm_tpu_torch.cli serve: serving {ready:.2f} s after "
        f"start (build check, engine, warm-up), /healthz {health['objects']}"
        f", one /pose answered, exit {rc} on SIGINT")


def serving_phase(sim, workdir, smi):
    """``cli export-serving --batch-size 8`` of the eval tree's checkpoint,
    then ``cli serve`` of the artifact on a thread: the warm-up, requests
    of b=8, 3 and 1, then LATENCY_REQUESTS timed requests each at b=1 and
    b=8, every served batch's correspondences held against the plain
    argmax and every pose valid; then the CLI in a process of its own.
    Returns the kernel launches of the served run and the latencies."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.eval import pose_fit
    from gdm_tpu_torch.server import request_poses

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
    art_root = osp.join(workdir, "serving", "lmo")
    im, n_sample = cfg.data.input_size, cfg.data.num_sample_points
    t0 = time.perf_counter()
    meta = cli.main(["export-serving", "--dataset", "lmo", "--data-root",
                     root, "--torch-checkpoint", ckpt, "--cls-id", "1",
                     "--batch-size", str(SERVE_BATCH), "--exact-knn",
                     "--out", osp.join(art_root, "ape")])
    log(f"  cli export-serving in {time.perf_counter() - t0:.2f} s: "
        f"{sorted(os.listdir(osp.join(art_root, 'ape')))}, raw_spec "
        f"{meta['raw_spec']}")
    rng = np.random.RandomState(SEED)
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    service, server = cli.start_server(cli.build_parser().parse_args(
        ["serve", "--artifact", art_root, "--port", "0"]))
    torch.cuda.synchronize()
    log(f"  cli serve: engine built and warmed up (b={SERVE_BATCH}) in "
        f"{time.perf_counter() - t0:.2f} s")
    engine = service.engines["ape"]
    check_fit_indices(engine.last_fit, sim, pose_fit, "warm-up batch")
    n_batches = 1
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    lat = {}
    try:
        for b in (SERVE_BATCH, 3, 1):
            raw = make_request(b, im, n_sample, rng)
            t0 = time.perf_counter()
            poses, compute_ms = request_poses(url, raw)
            ms = (time.perf_counter() - t0) * 1e3
            n_fit = check_poses(poses, b)
            log(f"  request b={b}: latency {ms:.2f} ms (server compute "
                f"{compute_ms:.2f} ms), {n_fit}/{b} frames fitted")
            check_fit_indices(engine.last_fit, sim, pose_fit)
            n_batches += 1
        for b in (1, SERVE_BATCH):
            raws = [make_request(b, im, n_sample, rng)
                    for _ in range(LATENCY_REQUESTS)]
            ms, compute = [], []
            for raw in raws:
                t0 = time.perf_counter()
                poses, compute_ms = request_poses(url, raw)
                ms.append((time.perf_counter() - t0) * 1e3)
                compute.append(compute_ms)
                check_poses(poses, b)
                check_fit_indices(engine.last_fit, sim, pose_fit,
                                  f"latency b={b} batch {len(ms)}")
                n_batches += 1
            lat[b] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p95_ms": float(np.percentile(ms, 95)),
                      "compute_p50_ms": float(np.percentile(compute, 50))}
        launches = sim.cosine_argmax.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for b, v in lat.items():
        log(f"  {smi}: served latency at b={b} over {LATENCY_REQUESTS} "
            f"requests (client clock, HTTP included, each request's plain "
            f"check after its reply): p50 {v['p50_ms']:.2f} ms, p95 "
            f"{v['p95_ms']:.2f} ms (numpy percentiles); server compute p50 "
            f"{v['compute_p50_ms']:.2f} ms")
    if launches != n_batches:
        fail(f"cosine_argmax kernel launched {launches} times for "
             f"{n_batches} served batches")
    log(f"  kernel launches in the served run: {launches} ({n_batches} "
        "batches: the warm-up, 3 requests, 2 x "
        f"{LATENCY_REQUESTS} timed), each held against the plain argmax")
    serve_subprocess(art_root, im, n_sample, rng)
    return launches, lat


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
    Returns the kernel launches and the per-batch timing of the eval
    run."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.imio import imread_rgb

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
    out, batch = osp.join(workdir, "out"), cfg.solver.val_batch_size
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

    infer_csv, viz = osp.join(out, "infer.csv"), osp.join(out, "viz")
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    cli.main(["infer", *common, "--output", infer_csv, "--save-viz", viz])
    wall = time.perf_counter() - t0
    if sim.cosine_argmax.launches != len(timing) + 1:
        fail(f"infer launched the kernel {sim.cosine_argmax.launches} times")
    pngs = sorted(os.listdir(viz))
    shapes = {imread_rgb(osp.join(viz, n)).shape for n in pngs}
    if len(pngs) != EVAL_FRAMES or shapes != {(cfg.data.input_size,) * 2
                                              + (3,)}:
        fail(f"infer --save-viz: {len(pngs)} PNGs of shapes {shapes}")
    log(f"  infer --save-viz: {len(pngs)} PNGs ({pngs[0]} ...), each "
        f"decoded by imio to {shapes.pop()}; infer {wall:.2f} s end to end")
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
    return launches, timing, peak


def busy_share(events, lo, hi):
    """(device-busy microseconds, kernels) within [lo, hi]: the union of
    the trace's kernel, memcpy and memset intervals clipped to it."""
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, sum(1 for e in events if e.get("cat") == "kernel"
                     and lo <= e["ts"] < hi)


def profile_run(sim, workdir, smi, extra=(), tag="profile"):
    """``cli eval --profile-dir`` on the eval tree (one object, two b=128
    batches and the warm-up), with the ``extra`` arguments: the
    device-busy share of each timed batch's window (its BATCH_SPAN range
    on the host, which ends after a synchronise), from the trace's kernel
    events; each batch's fit held against the plain argmax after the run.
    Returns the kernel launches, the shares and the kernel microseconds
    by name over the timed batches."""
    from gdm_tpu_torch import cli

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
    prof = osp.join(workdir, tag)
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    with FitChecks(sim, f"traced eval ({tag})", defer=True) as fc:
        res = cli.main(["eval", "--dataset", "lmo", "--data-root", root,
                        "--torch-checkpoint", ckpt, "--cls-id", "1",
                        "--exact-knn", "--output-dir",
                        osp.join(workdir, f"out_{tag}"), "--profile-dir",
                        prof, *extra])
    wall = time.perf_counter() - t0
    launches = sim.cosine_argmax.launches
    if launches != len(res["timing"]) + 1 or fc.n != launches:
        fail(f"profiled eval launched the kernel {launches} times for "
             f"{len(res['timing'])} batches + the warm-up ({fc.n} held)")
    (trace,) = os.listdir(prof)
    path = osp.join(prof, trace)
    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == cli.BATCH_SPAN
                   and e.get("cat") == "user_annotation")
    if len(spans) != len(res["timing"]):
        fail(f"{len(spans)} batch ranges in the trace for "
             f"{len(res['timing'])} batches")
    log(f"  cli eval --profile-dir: {wall:.2f} s end to end, trace "
        f"{os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events "
        f"(read in {time.perf_counter() - t0:.2f} s)")
    shares, by_name = [], {}
    for i, ((lo, hi), b) in enumerate(zip(spans, res["timing"])):
        busy, n_kernels = busy_share(events, lo, hi)
        shares.append(busy / (hi - lo))
        log(f"  {smi}: traced eval batch {i} ({b['n']} frames padded to "
            f"the eval batch): window {(hi - lo) / 1e3:.2f} ms (host clock "
            f"{b['device_ms']:.2f} ms), {n_kernels} kernels, device busy "
            f"{busy / 1e3:.2f} ms = {shares[-1]:.1%}, idle "
            f"{1 - shares[-1]:.1%}")
        for e in events:
            if e.get("cat") == "kernel" and lo <= e["ts"] < hi:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    kernel time over the {len(spans)} batches: "
            f"{us / 1e3 / len(spans):.2f} ms per batch "
            f"({us / total:.1%}) {name[:100]}")
    return launches, shares, {k: v / len(spans) for k, v in by_name.items()}


def refine_eval_runs(sim, workdir, base_timing):
    """cli eval --refine {ransac,icp,meanshift} at b=128 on the eval
    phase's tree and checkpoint: kernel launches (one per batch plus the
    warm-up), every batch's correspondences against the plain argmax
    (FitChecks), 160 valid rows, the unrefined run's miss sentinels kept;
    per-batch device ms beside refine=None's and peak device memory.
    Returns the launches of the three runs."""
    from gdm_tpu_torch import cli

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
    plain = read_csv_poses(osp.join(workdir, "out", "gt_lmo-test.csv"))
    missed = [k for k, p in plain.items() if p[2, 3] <= -999.0]
    common = ["--dataset", "lmo", "--data-root", root, "--torch-checkpoint",
              ckpt, "--cls-id", "1", "--exact-knn", "--num-workers", "8"]
    base = ", ".join(f"{b['device_ms']:.2f}" for b in base_timing)
    launches = 0
    for mode in REFINE_MODES:
        out = osp.join(workdir, f"out_{mode}")
        torch.cuda.reset_peak_memory_stats()
        sim.cosine_argmax.launches = 0
        with FitChecks(sim, f"eval --refine {mode}") as fc:
            res = cli.main(["eval", *common, "--refine", mode,
                            "--output-dir", out])
        n_launch = sim.cosine_argmax.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timing = res["timing"]
        if n_launch != len(timing) + 1 or fc.n != n_launch:
            fail(f"eval --refine {mode}: {n_launch} kernel launches, "
                 f"{fc.n} batches checked, {len(timing)} batches")
        poses = read_csv_poses(osp.join(out, "gt_lmo-test.csv"))
        if list(poses) != list(plain):
            fail(f"eval --refine {mode}: CSV rows differ from eval's")
        n_fit = check_poses(np.stack(list(poses.values())), EVAL_FRAMES)
        if any(not np.array_equal(poses[k], plain[k]) for k in missed):
            fail(f"eval --refine {mode}: a miss sentinel was refined")
        launches += n_launch
        log(f"  eval --refine {mode}: per-batch device ms "
            + ", ".join(f"{b['device_ms']:.2f} ({b['device_ms'] - c:.2f} "
                        "without the plain check)"
                        for b, c in zip(timing, fc.check_ms[1:]))
            + f" (refine=None: {base}); peak device memory {peak:.2f} GiB; "
            f"kernel launches {n_launch}, each held against the plain "
            f"argmax; {len(poses)} rows, {n_fit} fitted, every R a "
            f"rotation or the miss sentinel; {len(missed)} sentinels of the "
            "unrefined run kept")
    return launches


def refine_problem(b, n, seed):
    """A well-posed problem at the LM-O widths (tests/test_torch_refine.py
    _problem): b frames of a 4096-vertex mesh (a Gaussian blob, 5 cm) under
    random poses, each scene point a posed vertex (each vertex once) with
    2 mm noise, the first 30% displaced by ~0.2 m; frame 1's weights half
    0.  Returns CPU tensors (cld [b,n,3], w [b,n], idx [b,n], mesh
    [n,3])."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    mesh = rng.randn(n, 3).astype(np.float32) * 0.05
    R = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    t = (np.array([0.02, -0.01, 0.5]) + 0.05 * rng.randn(b, 3)
         ).astype(np.float32)
    sel = np.stack([rng.permutation(n) for _ in range(b)])
    cld = np.einsum("bnj,bij->bni", mesh[sel], R) + t[:, None]
    cld = cld + rng.randn(b, n, 3).astype(np.float32) * 0.002
    cld[:, :int(0.3 * n)] += rng.randn(b, int(0.3 * n), 3).astype(
        np.float32) * 0.2
    w = np.ones((b, n), np.float32)
    w[1, ::2] = 0.0
    f = torch.from_numpy
    return (f(cld.astype(np.float32)), f(w), f(sel.astype(np.int64)),
            f(mesh))


def refine_parity():
    """The port's refine ops on the card against the CPU on the
    well-posed problem at b=128 x 4096 points: the RANSAC hypotheses
    (integer bits) equal on REFINE_CPU_FRAMES frames, each mode's poses
    within REFINE_CARD_TOL there, the mean-shift shifts per frame, and
    each mode's median time on the card for the whole batch (CUDA
    events).  Returns {mode: ms}."""
    from gdm_tpu_torch.eval import pose_fit
    from gdm_tpu_torch.ops import prng
    from gdm_tpu_torch.ops.kabsch import weighted_kabsch
    from gdm_tpu_torch.ops.meanshift import mean_shift

    cld, w, idx, mesh = refine_problem(EVAL_SHAPE[0] // EVAL_SHAPE[1],
                                       EVAL_SHAPE[1], SEED + 5)
    dev = [x.cuda() for x in (cld, w, idx, mesh)]

    def draw(c, wt, ix):
        keys = prng.fold_in(prng.prng_key(0, c.device), ix.sum(-1))
        g = prng.gumbel(keys, (32, c.shape[1])) + torch.log(
            torch.clamp_min(wt, 1e-9))[:, None]
        return torch.sort(torch.topk(g, 4, dim=-1).indices, -1).values

    k = REFINE_CPU_FRAMES["ransac"]
    same = torch.equal(draw(*dev[:3])[:k].cpu(),
                       draw(cld[:k], w[:k], idx[:k]))
    rt = weighted_kabsch(dev[3][dev[2]], dev[0], dev[1])
    votes = dev[0] - dev[3][dev[2]] @ rt[:, :, :3].transpose(1, 2)
    shifts = mean_shift(votes, 0.05, dev[1])[2]
    log(f"  mean-shift shifts per frame on the card: median "
        f"{float(shifts.float().median()):.0f}, max {int(shifts.max())} "
        f"(cap 50)")
    log(f"  RANSAC hypothesis indices (32 x 4 per frame), card against CPU "
        f"on {k} frames: {'equal' if same else 'DIFFERENT'}")
    if not same:
        fail("RANSAC drew other hypotheses on the card than on the CPU")
    times = {}
    for mode in REFINE_MODES:
        def run(c, wt, ix, m, mode=mode):
            rt = weighted_kabsch(m[ix], c, wt)
            return pose_fit.apply_refine(rt, wt, ix, c, m, mode)

        k = REFINE_CPU_FRAMES[mode]
        got = run(*dev)                                  # the warm-up
        ref = run(cld[:k], w[:k], idx[:k], mesh)
        d = (got[:k].cpu() - ref).abs().amax(dim=(1, 2))
        err = float(d.max())
        times[mode] = median_ms(run, *dev, reps=3, warmup=0)
        log(f"  {mode} on the card, b={cld.shape[0]} x {cld.shape[1]} "
            f"points: {times[mode]:.2f} ms (median of 3); poses against the "
            f"CPU's on {k} frames: max|d| {err:.3g} (tolerance "
            f"{REFINE_CARD_TOL[mode]}), {int((d > 1e-4).sum())} frames "
            "beyond 1e-4")
        if not torch.isfinite(got).all() or err > REFINE_CARD_TOL[mode]:
            fail(f"{mode}: card poses differ from the CPU's by {err}")
    return times


def refine_phase(sim, workdir, base_timing):
    launches = refine_eval_runs(sim, workdir, base_timing)
    times = refine_parity()
    return launches, times


VSD_FRAMES, VSD_GROUP = 32, 16   # workload (b): chunks that pipeline
VSD_CPU_FRAMES = 2               # card-vs-CPU frames of workload (b)
YCBV_VSD_CPU_FRAMES = 1          # of cli eval --vsd --dataset ycbv
VSD_CLI_TOL = 1e-6   # |eval --vsd - score --vsd|: t goes through mm
FLOPS_PER_TEST = 18  # f32 flops of one (face, pixel) edge test
TABLE_CAP = 64       # candidates per slot row of a host-binned table
# the kernels' entries in the result line, and the wrapper of each
RENDERERS = {"render_depth_gather": "render_depth_window_gather",
             "render_depth_scatter": "render_depth_window"}
# the host binning of the JAX package's VSD path, which the card's path
# must not call
HOST_BINNING = ("bin_faces_to_slots", "bin_faces_to_tiles",
                "_face_tile_pairs")


class Calls:
    """While active, eval/vsd's function ``name`` is wrapped: the inputs
    and the output of every call are kept (to hold a kernel against its
    plain version, or another renderer, on exactly those tensors)."""

    def __init__(self, name):
        self.name, self.calls = name, []

    @property
    def first(self):
        return self.calls[0]

    def __enter__(self):
        from gdm_tpu_torch.eval import vsd

        self.orig = orig = getattr(vsd, self.name)

        def call(*args, **kw):
            out = orig(*args, **kw)
            # lists copied: the evaluator clears its own after the call
            kept = tuple(list(a) if isinstance(a, list) else a for a in args)
            self.calls.append(((kept, kw), out.clone()
                               if torch.is_tensor(out) else out))
            return out

        setattr(vsd, self.name, call)
        return self

    def __exit__(self, *exc):
        from gdm_tpu_torch.eval import vsd

        setattr(vsd, self.name, self.orig)


class NoHostBinning:
    """Counts calls of the host binning functions (HOST_BINNING) of
    ops/render_depth while active; on exit, fails if there was one."""

    def __init__(self, tag):
        self.tag, self.n = tag, 0

    def __enter__(self):
        from gdm_tpu_torch.ops import render_depth as rd

        self.orig = {k: getattr(rd, k) for k in HOST_BINNING}
        for k, fn in self.orig.items():
            def call(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)
            setattr(rd, k, call)
        return self

    def __exit__(self, *exc):
        from gdm_tpu_torch.ops import render_depth as rd

        for k, fn in self.orig.items():
            setattr(rd, k, fn)
        if exc[0] is None and self.n:
            fail(f"{self.tag}: the host binning was called {self.n} times")


def render_plain(name, args, kw):
    """The plain version of renderer ``name`` on the recorded batch
    (per render, as the CPU path runs it), on the same card tensors."""
    from gdm_tpu_torch.ops import render_depth as rd

    verts, table, K, origin, window, tile = args
    n = verts.shape[0]
    if name == "render_depth_window_gather":
        st = kw.get("slot_tile")
        return torch.stack([rd.render_depth_window_gather_reference(
            verts[i], table[i], K, origin[i], window, tile,
            kw.get("cand_chunk", 256), None if st is None else st[i])
            for i in range(n)])
    return torch.stack([rd.render_depth_window_reference(
        verts[i], table[i], K, origin[i], window, tile,
        kw.get("face_chunk", 1024)) for i in range(n)])


def _stamp_tests(p, ok, tile):
    """Pixels that faces p [F, 3, 2] (kept where ok) can cover: each
    face's bbox widened by one pixel on the high side, at most tile x
    tile (the stamp's own tests)."""
    lo = torch.floor(p.min(dim=1).values)[ok]
    hi = torch.floor(p.max(dim=1).values)[ok]
    span = torch.clamp(hi - lo + 2, max=tile)
    return int((span[:, 0] * span[:, 1]).sum())


def render_tests(name, args, kw):
    """(face, pixel) tests that a recorded renderer call's data needs: for
    each face that it keeps (in front, |area| > eps), the pixels that the
    face can cover (_stamp_tests).  The table form computes the same
    function from the faces it lists, each counted once (a table lists a
    face under each of its tiles).  Also the tests that the JAX renderers
    make on the same data: every pixel of each kept face's stamp, or of
    each real table entry's tile."""
    from gdm_tpu_torch.ops import render_depth as rd

    verts, table, K, origin, window, tile = args
    gx, gy = window[1] // tile, window[0] // tile
    tests = full = 0
    for i in range(verts.shape[0]):
        pix, z = rd._project(verts[i], K, origin[i])
        tri = table[i].long()
        if name == "render_depth_window_gather":
            st = kw.get("slot_tile")
            rows = torch.arange(table.shape[1], device=verts.device) \
                if st is None else st[i].long()
            real = (tri != 0).any(-1) & (rows < gx * gy)[:, None]
            full += int(real.sum()) * tile * tile
            tri = torch.unique(tri[real], dim=0)
        p = pix[tri]
        ok, _ = rd._setup(p, z[tri])
        tests += _stamp_tests(p, ok, tile)
        if name != "render_depth_window_gather":
            full += int(ok.sum()) * tile * tile
    return tests, full


def render_bound(name, args, kw, peak):
    """Least time of a recorded renderer call: FLOPS_PER_TEST flops per
    test its data needs (render_tests) over the f32 FMA peak, or its
    inputs read once and its depth written once at 3.35 TB/s, whichever
    is larger.  Returns (ms, what bounds it, tests, the JAX renderers'
    tests)."""
    verts, table, _, origin, window, _ = args
    n_bytes = (verts.numel() + table.numel() + origin.numel() + 9) * 4 \
        + verts.shape[0] * window[0] * window[1] * 4
    st = kw.get("slot_tile")
    if st is not None:
        n_bytes += st.numel() * 4
    tests, full = render_tests(name, args, kw)
    ops_ms = FLOPS_PER_TEST * tests / peak * 1e3
    bytes_ms = n_bytes / 3.35e12 * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, tests, full


def hold_renderer(tag, name, call, peak, reps=5):
    """A recorded kernel call ((args, kw), out) against the plain version
    on the same card tensors (bit-equal), then both timed on them: the
    whole wrapper call, all of its launches."""
    from gdm_tpu_torch.ops import render_depth as rd

    (args, kw), out = call
    fn = getattr(rd, name)
    plain = render_plain(name, args, kw)
    torch.cuda.synchronize()
    n_diff = int((plain != out).sum())
    covered = int((plain > 0).sum())
    if n_diff or covered == 0:
        fail(f"{tag}: kernel and plain version differ on {n_diff} pixels "
             f"({covered} covered)")
    err = float((plain - out).abs().max())
    ms = median_ms(lambda: fn(*args, **kw), reps=reps, warmup=1)
    plain_ms = median_ms(lambda: render_plain(name, args, kw), reps=reps,
                         warmup=1)
    bms, by, tests, full = render_bound(name, args, kw, peak)
    verts, table = args[0], args[1]
    shape = [list(verts.shape), list(table.shape), list(args[4]), args[5]]
    log(f"  {tag}: kernel == plain on all {plain.numel()} pixels of "
        f"{verts.shape[0]} renders ({covered} covered); median over {reps}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
        f"({by}; {tests} tests x {FLOPS_PER_TEST} flops; kernel at "
        f"{100 * bms / ms:.1f}% of it; the JAX renderers test {full}: "
        f"{FLOPS_PER_TEST * full / peak * 1e3:.4f} ms of operations); verts, "
        f"table, window, tile {shape}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "shape": shape,
            "tests": tests, "tests_jax": full}


def outward_hull(pts):
    """Faces [F, 3] int32 of the convex hull of pts [P, 3], wound outward
    as BOP meshes are."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(pts)
    faces = hull.simplices.astype(np.int32)
    tri = pts[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("ij,ij->i", nrm, hull.equations[:, :3]) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return faces


def write_eval_mesh(root, obj_id=1):
    """models_eval/obj_*.ply of the eval tree: the convex hull of the
    object's fps points (mm), wound outward."""
    from gdm_tpu_torch.data.ply import write_ply

    pts = np.load(osp.join(root, "kps", f"obj_{obj_id:06d}_fps.npy"))[:, :3]
    faces = outward_hull(pts)
    os.makedirs(osp.join(root, "models_eval"), exist_ok=True)
    write_ply(osp.join(root, "models_eval", f"obj_{obj_id:06d}.ply"), pts,
              faces=faces)
    return len(faces)


def reset_counts(sim, rd):
    sim.cosine_argmax.launches = 0
    for fn in RENDERERS.values():
        getattr(rd, fn).launches = 0


def render_launches(rd):
    return {k: getattr(rd, fn).launches for k, fn in RENDERERS.items()}


def vsd_cli_runs(sim, workdir, eval_timing, peak_flops):
    """Workload (a): ``cli eval --vsd`` then ``cli score --vsd`` of its CSV
    on the eval phase's tree at b=128, with no host binning; the stamp
    kernel held against its plain version on the eval's first chunk and
    timed there (the hull's faces are larger than the trefoil's).
    Returns (the launches of both runs by kernel, the stamp's timing)."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.ops import render_depth as rd

    root, ckpt = osp.join(workdir, "lmo"), osp.join(workdir, "ckpt")
    out = osp.join(workdir, "out_vsd")
    n_faces = write_eval_mesh(root)
    common = ["--dataset", "lmo", "--data-root", root, "--cls-id", "1"]
    reset_counts(sim, rd)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with NoHostBinning("eval --vsd"), Calls("render_depth_window") as rec:
        res = cli.main(["eval", *common, "--torch-checkpoint", ckpt,
                        "--exact-knn", "--num-workers", "8", "--vsd",
                        "--output-dir", out])
    wall = time.perf_counter() - t0
    launches = dict(render_launches(rd),
                    cosine_argmax=sim.cosine_argmax.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches["cosine_argmax"] != len(res["timing"]) + 1:
        fail(f"eval --vsd: cosine_argmax launched "
             f"{launches['cosine_argmax']} times for {len(res['timing'])} "
             "batches + the warm-up")
    if launches["render_depth_scatter"] == 0 or \
            launches["render_depth_gather"]:
        fail(f"eval --vsd: renderer launches {launches}")
    errs = np.asarray(res["errors"]["ape"]["vsd"])
    if errs.shape != (EVAL_FRAMES, 10) or not np.isfinite(errs).all() \
            or errs.min() < 0 or errs.max() > 1:
        fail(f"eval --vsd: VSD errors of shape {errs.shape}, range "
             f"[{errs.min()}, {errs.max()}]")
    for row in ("vsd", "ar_vsd", "bop19_ar"):
        if not any(line.split()[:1] == [row]
                   for line in res["table"].splitlines()):
            fail(f"eval --vsd: no {row} row in the table")
    ar = res["bop19_ar"]["ape"]
    log(f"  eval --vsd ({n_faces}-face hull): {EVAL_FRAMES} frames in "
        f"{wall:.2f} s end to end (plain eval's device ms per batch: "
        + ", ".join(f"{b['device_ms']:.2f}" for b in eval_timing)
        + f"); stamp renderer calls {launches['render_depth_scatter']}, "
        f"host binning calls 0, similarity launches "
        f"{launches['cosine_argmax']}; peak device memory {peak:.2f} GiB; "
        f"ar_vsd {ar['ar_vsd']:.4f}, bop19_ar {ar['bop19_ar']:.4f}, mean "
        f"VSD error {errs.mean():.4f}")

    rd.render_depth_window.launches = 0
    t0 = time.perf_counter()
    with NoHostBinning("score --vsd"):
        scored = cli.main(["score", *common, "--vsd", "--csv",
                           osp.join(out, "gt_lmo-test.csv")])
    wall_s = time.perf_counter() - t0
    n_score = rd.render_depth_window.launches
    launches["render_depth_scatter"] += n_score
    d = float(np.abs(np.asarray(scored["errors"]["ape"]["vsd"])
                     - errs).max())
    if d > VSD_CLI_TOL or n_score == 0 or \
            scored["recalls"]["ape"]["vsd"] != res["recalls"]["ape"]["vsd"]:
        fail(f"score --vsd: VSD errors differ from eval --vsd by {d} "
             f"(tolerance {VSD_CLI_TOL}), stamp renderer calls {n_score}")
    log(f"  score --vsd of the eval CSV: {EVAL_FRAMES} frames in "
        f"{wall_s:.2f} s ({wall_s * 1e3 / EVAL_FRAMES:.2f} ms/frame, host "
        f"metrics included); VSD errors within {d:.3g} of eval --vsd, "
        f"recalls equal; stamp renderer calls {n_score}")
    timing = hold_renderer("stamp kernel, first chunk of (a)",
                           "render_depth_window", rec.first, peak_flops)
    return launches, timing


def hard_vsd_workload(n_frames=VSD_FRAMES, seed=4, mesh=None):
    """Workload (b), bench.py's measure_vsd_hard at 32 frames: the
    20,480-face trefoil (or ``mesh``, (verts, faces)) at z = 0.55 m,
    cluttered 480x640 test depths (the GT render, composited over a
    background plane, an occluder strip and 5% holes), GT rendered on the
    card by the scatter kernel in one call.  Returns (poses, depths, K,
    verts, faces, diameter, gt renders, their inputs)."""
    from gdm_tpu_torch.data.synthetic import make_trefoil_mesh
    from gdm_tpu_torch.ops import render_depth as rd

    verts, faces = make_trefoil_mesh() if mesh is None else mesh
    diameter = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    rng = np.random.RandomState(seed)
    v, f = rd.subdivide_max_edge(verts, faces, 0.01)
    poses, cams, strips = [], [], []
    for _ in range(n_frames):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        Rg = (q * np.sign(np.linalg.det(q))).astype(np.float32)
        tg = np.array([rng.uniform(-.04, .04), rng.uniform(-.04, .04),
                       0.55], np.float32)
        cams.append((v @ Rg.T + tg).astype(np.float32))
        strips.append(int(rng.uniform(200, 380)))
        dR, _ = np.linalg.qr(np.eye(3) + 0.05 * rng.randn(3, 3))
        Re = (dR * np.sign(np.linalg.det(dR))).astype(np.float32) @ Rg
        te = tg + rng.randn(3).astype(np.float32) * 0.005
        poses.append((Re, te, Rg, tg))
    gt_args = (torch.from_numpy(np.stack(cams)).cuda(),
               torch.from_numpy(np.ascontiguousarray(
                   np.broadcast_to(f, (n_frames,) + f.shape))).cuda(),
               torch.from_numpy(K).cuda(),
               torch.zeros(n_frames, 2, device="cuda"), (480, 640), 16)
    gt = rd.render_depth_window(*gt_args)
    depths = []
    for d, x0 in zip(gt.cpu().numpy(), strips):
        bg = np.full_like(d, 0.55 + 0.25)
        occ = np.full_like(d, 0.55 - 0.12)
        strip = np.zeros_like(d, bool)
        strip[:, x0:x0 + 60] = True
        out = np.where(d > 0, d, bg)
        out = np.where(strip, np.minimum(out, occ), out)
        out[rng.rand(*d.shape) < 0.05] = 0.0
        depths.append(out.astype(np.float32))
    return poses, depths, K, verts, faces, diameter, gt, gt_args


def vsd_chunks(poses, depths, K, verts):
    """{(window side, z bucket): chunks}: vsd_err_batch's device batches,
    one renderer call each."""
    from gdm_tpu_torch.eval.vsd import _prep_job

    sizes = {}
    for p, d in zip(poses, depths):
        j = _prep_job(*p, d, K, verts, 32)
        sizes[(j["side"], j["zb"])] = sizes.get((j["side"], j["zb"]), 0) + 1
    return {k: -(-n // VSD_GROUP) for k, n in sizes.items()}


def host_slot_table(args):
    """The JAX package's candidate table for a recorded stamp call: per
    render, bin_faces_to_slots (TABLE_CAP per row) on the host, of the
    faces the renderer keeps at their projection on the card; rows padded
    to the chunk's largest table with the sentinel tile G.  Returns card
    tensors (cand [N, S, TABLE_CAP, 3], slot_tile [N, S])."""
    from gdm_tpu_torch.ops import render_depth as rd

    verts, faces, K, origin, window, tile = args
    side, g = window[0], (window[0] // tile) * (window[1] // tile)
    tables = []
    for i in range(verts.shape[0]):
        pix, z = rd._project(verts[i], K, origin[i])
        fl = faces[i].long()
        ok, _ = rd._setup(pix[fl], z[fl])
        tables.append(rd.bin_faces_to_slots(
            pix[fl].cpu().numpy(), ok.cpu().numpy(), faces[i].cpu().numpy(),
            side, tile, TABLE_CAP))
    rows = max(len(c) for c, _ in tables)
    cand = np.zeros((len(tables), rows, TABLE_CAP, 3), np.int32)
    slot = np.full((len(tables), rows), g, np.int32)
    for i, (c, st) in enumerate(tables):
        cand[i, :len(c)] = c
        slot[i, :len(st)] = st
    return torch.from_numpy(cand).cuda(), torch.from_numpy(slot).cuda()


def table_runs(stamped):
    """The gather form (render_depth_window_gather, the JAX package's VSD
    renderer) on every chunk of a vsd_err_batch run, each chunk's slot
    table binned on the host (host_slot_table): each chunk's depth equal
    to the stamp's bit for bit.  Returns (launches, the first chunk's call
    ((args, kw), out), host ms per render of the binning)."""
    from gdm_tpu_torch.ops import render_depth as rd

    rd.render_depth_window_gather.launches = 0
    first, bin_s, renders = None, 0.0, 0
    for (args, _), want in stamped.calls:
        t0 = time.perf_counter()
        cand, st = host_slot_table(args)
        bin_s += time.perf_counter() - t0
        renders += args[0].shape[0]
        kw = {"slot_tile": st}
        got = rd.render_depth_window_gather(args[0], cand, *args[2:], **kw)
        if not torch.equal(got, want):
            fail(f"table form: {int((got != want).sum())} pixels differ "
                 "from the stamp's")
        if first is None:
            first = (((args[0], cand) + tuple(args[2:]), kw), got.clone())
    return rd.render_depth_window_gather.launches, first, \
        bin_s * 1e3 / renders


def vsd_batch_runs(peak_flops):
    """Workload (b) through vsd_err_batch (no host binning), the gather
    form on the run's chunks, each renderer held against its plain version
    on the first chunk and the GT render, the card against the CPU on
    VSD_CPU_FRAMES frames.  Returns (the main path's launches by kernel,
    per-kernel timing dicts, the gather form's launches)."""
    from gdm_tpu_torch.eval.vsd import vsd_err_batch
    from gdm_tpu_torch.ops import render_depth as rd

    t0 = time.perf_counter()
    rd.render_depth_window.launches = 0
    poses, depths, K, verts, faces, diam, gt, gt_args = hard_vsd_workload()
    gt_launches = rd.render_depth_window.launches
    log(f"  workload (b): {len(faces)}-face trefoil, {VSD_FRAMES} frames, "
        f"GT rendered by the stamp kernel ({gt_launches} call) and "
        f"cluttered in {time.perf_counter() - t0:.2f} s")
    gt_ref = torch.stack([rd.render_depth_window_reference(
        gt_args[0][i], gt_args[1][i], gt_args[2], gt_args[3][i],
        gt_args[4], gt_args[5]) for i in range(2)])
    if not torch.equal(gt_ref, gt[:2]) or float(gt[:2].max()) == 0:
        fail("GT render: stamp kernel differs from its plain version")
    args = (poses, depths, K, verts, faces, diam)
    kw = dict(group_cap=VSD_GROUP, device="cuda")
    vsd_err_batch(*args, **kw)                         # warm-up
    torch.cuda.synchronize()
    walls, runs = [], []
    for rep in range(2):
        rd.render_depth_window.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with Calls("render_depth_window") as rec, \
                NoHostBinning("vsd_err_batch") as nb:
            t0 = time.perf_counter()
            runs.append(vsd_err_batch(*args, **kw))
            walls.append(time.perf_counter() - t0)
        if rep == 0:
            stamped = rec
    errs = runs[0]
    n_stamp = rd.render_depth_window.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chunks = vsd_chunks(poses, depths, K, verts)
    if n_stamp != sum(chunks.values()):
        fail(f"vsd_err_batch: {n_stamp} stamp renderer calls for the "
             f"chunks {chunks}")
    if not np.array_equal(runs[1], errs):
        fail("vsd_err_batch: two runs give different errors")
    if not np.isfinite(errs).all() or errs.min() < 0 or errs.max() > 1:
        fail("vsd_err_batch: VSD errors out of [0, 1]")
    log(f"  vsd_err_batch (group_cap {VSD_GROUP}, pipeline depth 2): "
        + ", ".join(f"{w * 1e3 / VSD_FRAMES:.3f}" for w in walls)
        + f" ms/frame (two runs after a warm-up, equal errors); stamp "
        f"renderer calls {n_stamp} per run, one per chunk of (window, z "
        f"bucket): {chunks}; host binning calls {nb.n}; peak device memory "
        f"{peak:.2f} GiB; mean error {errs.mean():.4f}")

    n_table, table_first, bin_ms = table_runs(stamped)
    log(f"  gather form on the run's {len(stamped.calls)} chunks, slot "
        f"tables (cap {TABLE_CAP}) binned on the host ({bin_ms:.3f} ms per "
        f"render, projection on the card included): depth images equal to "
        f"the stamp's; gather calls {n_table}")

    t0 = time.perf_counter()
    n = VSD_CPU_FRAMES
    errs_cpu = vsd_err_batch(poses[:n], depths[:n], K, verts, faces, diam,
                             device="cpu")
    if not np.array_equal(errs_cpu, errs[:n]):
        fail(f"card vs CPU: VSD errors differ by "
             f"{np.abs(errs_cpu - errs[:n]).max()}")
    log(f"  card vs CPU on {n} frames: VSD errors equal (step cost), CPU "
        f"{time.perf_counter() - t0:.2f} s")
    timing = {}
    for key, tag, call in (
            ("render_depth_scatter", "stamp kernel", stamped.first),
            ("render_depth_gather", "gather kernel (slot rows)",
             table_first)):
        timing[key] = hold_renderer(f"{tag}, first chunk of (b)",
                                    RENDERERS[key], call, peak_flops)
        timing[key]["peak_gib"] = peak
    timing["render_depth_scatter"]["ms_per_frame"] = [
        w * 1e3 / VSD_FRAMES for w in walls]
    return ({"render_depth_scatter": n_stamp + gt_launches,
             "render_depth_gather": 0}, timing, n_table)


def vsd_phase(sim, workdir, eval_timing):
    """Workload (a) on the eval tree, then workload (b); launches by
    kernel summed over the main-path runs, and the renderers' timing (the
    gather form's launches, all by its check on (b)'s chunks, apart)."""
    peak = peak_flops()
    launches, timing_a = vsd_cli_runs(sim, workdir, eval_timing, peak)
    b_launches, timing, n_table = vsd_batch_runs(peak)
    for k, v in b_launches.items():
        launches[k] += v
    timing["render_depth_scatter"]["workload_a"] = {
        k: timing_a[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "shape", "tests")}
    timing["render_depth_gather"]["check_launches"] = n_table
    return launches, timing


def write_stacked_tree(root, ckpt):
    """STACKED_FRAMES test frames of each LM-O object (its own scene,
    a mesh of its diameter) and a seeded random checkpoint per object."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    refd = refdata.get("lmo")
    rng = np.random.RandomState(SEED + 3)
    meshes = {oid: make_object(cfg.data.model_pt_num, rng,
                               radius=refd.diameters_mm_by_id[oid] / 2500.0)
              for oid in cfg.data.obj_ids}
    write_synthetic_bop_root(root, meshes, n_frames=STACKED_FRAMES,
                             subsets=("test",), im_hw=cfg.data.img_hw,
                             seed=SEED + 3)
    for p, oid in enumerate(cfg.data.obj_ids):
        d = osp.join(ckpt, refd.id2obj[oid])
        os.makedirs(d)
        torch.save({"model_state": random_weights(cfg, SEED + 10 + p)},
                   osp.join(d, "geomatch.pth.tar"))


def stacked_launches(obj_pos, timing, batch, schedule):
    """Kernel launches of a stacked run: per loader batch (padded to
    ``batch`` with its last row) one per forward of ``schedule``, plus
    the first batch again for the warm-up."""
    from gdm_tpu_torch.eval.multimodel import row_groups

    n, s = [], 0
    for b in timing:
        rows = list(obj_pos[s:s + b["n"]])
        s += b["n"]
        rows += rows[-1:] * (batch - len(rows))
        n.append(len(row_groups(np.array(rows), schedule, STACKED_GROUP)))
    return sum(n) + n[0]


def spread_matches(engine, raw):
    """Random weights send every scene point to one mesh vertex (scene and
    mesh features each share one dominant direction), and a Kabsch fit of
    one vertex has no defined rotation.  Centre both feature sets by linear
    changes of the engine's last layers, as tests/test_torch_cli.py
    _spread_matches does: the scene head's last Dense takes its input
    projected off that input's mean over ``raw``'s frames, and the mesh
    head's last Dense subtracts the mean mesh feature."""
    head = engine.model.feature_encoding_layer
    seen = []
    hook = head[2].register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        engine.run(raw)
    finally:
        hook.remove()
    h0 = seen[0].reshape(-1, seen[0].shape[-1]).double().mean(0)
    proj = (torch.eye(len(h0), dtype=torch.float64, device=h0.device)
            - torch.outer(h0, h0) / (h0 @ h0))
    sd = {k: v.clone() for k, v in engine.model.state_dict().items()}
    w = "feature_encoding_layer.3.conv.weight"
    sd[w] = (sd[w].double() @ proj).float()
    sd["model_emb.mesh_final.bias"] -= engine.mesh_feats.mean(0)
    engine.load_weights(sd)


def stacked_fit_check(root, ckpt, batch):
    """One mixed batch of every frame, in process, through the stacked
    engine (by_class and vmap) and through each object's own engine, with
    each object's features centred (spread_matches) so that matches
    spread over its mesh: every stacked correspondence held against the
    plain argmax, the Kabsch weights equal to the per-object engines'
    on the same rows, the correspondences equal beyond near-ties (top-2
    gap <= GAP), and the poses within STACKED_POSE_TOL on frames whose
    weighted correspondences all agree."""
    from gdm_tpu_torch import cli, refdata, weights
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.eval import pose_fit
    from gdm_tpu_torch.eval.multimodel import MultiObjectEngine
    from gdm_tpu_torch.serve import PoseEngine

    refd = refdata.get("lmo")
    t0 = time.perf_counter()
    parts, engines = [], []
    for oid in cfg.data.obj_ids:
        parts.append((oid, PoseDataset(cfg, oid, "infer", data_root=root)))
        fps = load_or_build_fps_mesh(root, oid, cfg.data.model_pt_num)
        fps[:, :3] *= 1000.0
        engines.append(PoseEngine(
            cfg, fps, weights.read_reference_checkpoint(
                osp.join(ckpt, refd.id2obj[oid])), "cuda", batch=batch,
            knn_chunk=512))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed = cli.MixedInferDataset(parts)
    raw, _ = collate([mixed[k] for k in range(len(mixed))])
    raw = {k: raw[k] for k in engines[0].meta["raw_spec"]} | {
        "obj_pos": raw["obj_pos"]}
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = []
    for p, e in enumerate(engines):
        rows = np.nonzero(raw["obj_pos"] == p)[0]
        own = {k: v[rows] for k, v in raw.items() if k != "obj_pos"}
        spread_matches(e, own)
        refs.append((rows, e.run(own), e.last_fit))
    t_ref = time.perf_counter() - t0
    spread = [len(torch.unique(fit["idx"][j][fit["w"][j] > 0]))
              for _, _, fit in refs for j in range(len(fit["idx"]))]
    log(f"  in process: {len(engines)} engines built in {t_build:.2f} s, "
        f"the mixed batch of {len(mixed)} loaded in {t_load:.2f} s, features "
        f"centred and the per-object engines run in {t_ref:.2f} s; matched "
        f"vertices per frame: median {int(np.median(spread))}, min "
        f"{min(spread)}")
    for schedule in ("by_class", "vmap"):
        t0 = time.perf_counter()
        stacked = MultiObjectEngine(engines, schedule, STACKED_GROUP)
        poses = stacked.run(raw)
        got = stacked.last_fit
        n_ok, worst = 0, 0.0
        for p, (e, (rows, ref_poses, ref)) in enumerate(zip(engines, refs)):
            r = torch.as_tensor(rows, device=got["w"].device)
            mf = pose_fit.l2_normalise(e.mesh_feats)
            c = mf.shape[-1]
            check_argmax(f"stacked ({schedule}) object {p}",
                         got["idx"][r].reshape(-1), None,
                         pose_fit.l2_normalise(got["rgbd"][r]).reshape(-1, c),
                         mf)
            if not torch.equal(got["w"][r], ref["w"]):
                fail(f"stacked ({schedule}): Kabsch weights of object {p} "
                     "differ from its per-object engine's")
            f = pose_fit.l2_normalise(ref["rgbd"]).reshape(-1, c)
            top2 = torch.topk(f @ mf.T, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1] > GAP).reshape(ref["idx"].shape)
            bad = int(((got["idx"][r] != ref["idx"]) & sure).sum())
            if bad:
                fail(f"stacked ({schedule}): {bad} correspondences of object "
                     f"{p} differ beyond near-ties from its per-object "
                     "engine's")
            agree = ((got["idx"][r] == ref["idx"]) | (ref["w"] == 0)).all(1)
            for j in np.nonzero(agree.cpu().numpy())[0]:
                n_ok += 1
                worst = max(worst, float(np.abs(poses[rows[j]]
                                                - ref_poses[j]).max()))
        log(f"  stacked ({schedule}) against the per-object engines, one "
            f"mixed batch of {len(mixed)} in {time.perf_counter() - t0:.2f} "
            f"s: Kabsch weights equal, correspondences equal beyond "
            f"near-ties; weighted correspondences all equal on {n_ok} "
            f"frames, max |dpose| there {worst:.3g} (tolerance "
            f"{STACKED_POSE_TOL})")
        if worst > STACKED_POSE_TOL:
            fail(f"stacked ({schedule}) poses differ from the per-object "
                 f"ones by {worst}")
    del engines, stacked
    torch.cuda.empty_cache()


def stacked_phase(sim, workdir):
    """cli infer --stacked (by_class, vmap, --refine icp) and the
    per-object cli infer on the 8-object tree at b=128.  Returns the
    kernel launches of the stacked runs and their frames/s."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMO as cfg

    root, ckpt = osp.join(workdir, "lmo8"), osp.join(workdir, "ckpt8")
    batch = cfg.solver.val_batch_size
    t0 = time.perf_counter()
    write_stacked_tree(root, ckpt)
    log(f"  synthetic tree ({len(cfg.data.obj_ids)} objects x "
        f"{STACKED_FRAMES} test frames) and checkpoints written in "
        f"{time.perf_counter() - t0:.2f} s")
    common = ["infer", "--dataset", "lmo", "--data-root", root,
              "--torch-checkpoint", ckpt, "--exact-knn", "--num-workers",
              "8"]
    runs = {}
    for tag, extra in (
            ("by_class", ["--stacked"]),
            ("vmap", ["--stacked", "--stacked-schedule", "vmap"]),
            ("icp", ["--stacked", "--refine", "icp"]),
            ("per_object", [])):
        csv = osp.join(workdir, f"stacked_{tag}.csv")
        torch.cuda.reset_peak_memory_stats()
        sim.cosine_argmax.launches = 0
        t0 = time.perf_counter()
        res = cli.main(common + extra + ["--output", csv])
        wall = time.perf_counter() - t0
        timing = res["timing"]
        frames = sum(b["n"] for b in timing)
        dev_s = sum(b["device_ms"] for b in timing) / 1e3
        runs[tag] = {"poses": read_csv_poses(csv),
                     "launches": sim.cosine_argmax.launches,
                     "timing": timing, "fps_device": frames / dev_s,
                     "fps_wall": frames / wall}
        log(f"  infer {' '.join(extra) or '(per object)'}: {frames} frames "
            f"in {len(timing)} batches, device ms per batch "
            + ", ".join(f"{b['device_ms']:.2f}" for b in timing)
            + f"; {frames / dev_s:.2f} frames/s device, {frames / wall:.2f} "
            f"frames/s end to end (engine builds and warm-up included); "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel "
            f"launches {sim.cosine_argmax.launches}")
    keys = list(runs["by_class"]["poses"])
    n_frames = len(cfg.data.obj_ids) * STACKED_FRAMES
    if len(keys) != n_frames:
        fail(f"stacked CSV has {len(keys)} rows, want {n_frames}")
    for tag in ("vmap", "icp"):
        if list(runs[tag]["poses"]) != keys:
            fail(f"infer --stacked ({tag}): CSV rows differ from by_class's")
    if sorted(runs["per_object"]["poses"]) != sorted(keys):
        fail("per-object infer CSV rows differ from the stacked run's")
    for tag, r in runs.items():
        check_poses(np.stack(list(r["poses"].values())), n_frames)
    pos = {oid: p for p, oid in enumerate(cfg.data.obj_ids)}
    obj_pos = [pos[k[2]] for k in keys]
    for tag, schedule in (("by_class", "by_class"), ("vmap", "vmap"),
                          ("icp", "by_class")):
        want = stacked_launches(obj_pos, runs[tag]["timing"], batch,
                                schedule)
        if runs[tag]["launches"] != want:
            fail(f"infer --stacked ({tag}): {runs[tag]['launches']} kernel "
                 f"launches, want {want}")
    want = 2 * len(cfg.data.obj_ids)     # one batch + the warm-up each
    if runs["per_object"]["launches"] != want:
        fail(f"per-object infer: {runs['per_object']['launches']} kernel "
             f"launches, want {want}")
    log(f"  CSV rows equal in all four runs ({len(keys)}); every pose a "
        "rotation; kernel launches as scheduled (by_class: one per group of "
        f"<= {STACKED_GROUP} same-object rows, vmap: one per row, plus the "
        "warm-up batch)")
    stacked_fit_check(root, ckpt, batch)
    return sum(runs[t]["launches"] for t in ("by_class", "vmap", "icp")), {
        t: (r["fps_device"], r["fps_wall"]) for t, r in runs.items()}


def write_train_tree(root):
    """LM-O object 1: TRAIN_FRAMES JPEG train_pbr frames, VAL_FRAMES test
    frames (PNG, with detections) at 480x640."""
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    fps = make_object(cfg.data.model_pt_num, np.random.RandomState(SEED))
    write_synthetic_bop_root(root, fps, n_frames=TRAIN_FRAMES,
                             subsets=("train_pbr",), im_hw=cfg.data.img_hw,
                             seed=SEED + 1, obj_id=1)
    write_synthetic_bop_root(root, fps, n_frames=VAL_FRAMES,
                             subsets=("test",), im_hw=cfg.data.img_hw,
                             seed=SEED + 2, obj_id=1)


def loader_stages(cfg, root, n=24):
    """ms/sample of the train loader's stages on one thread: JPEG decode,
    the depth and mask decode, the three crops, the HPR hull, the
    radius-NN GT match, and whole samples (1 thread, then 8 threads over
    the first two batches and 2 processes over the first)."""
    from gdm_tpu_torch.data import bop, crop, gt_gen, imio
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import DataLoader

    ds = PoseDataset(cfg, 1, "train", data_root=root)
    recs = ds.annos[:n]
    t = {}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = [fn(r) for r in recs]
        t[name] = (time.perf_counter() - t0) * 1e3 / len(recs)
        return out

    rgbs = clock("jpeg decode (rgb)", lambda r: imio.imread_rgb(r.rgb_file))
    others = clock("png decode (depth + mask)", lambda r: (
        imio.imread_u16(r.depth_file), imio.imread_mask(r.mask_file)))
    frames = {id(r): (a, *b) for r, a, b in zip(recs, rgbs, others)}
    rng = np.random.RandomState(SEED)
    d, S = cfg.data, cfg.data.input_size

    def crops(r):
        rgb, dpt, mask = frames[id(r)]
        c, s = bop.aug_bbox_dzi(r.bbox, rng, d.dzi_scale_ratio,
                                d.dzi_shift_ratio, d.dzi_pad_ratio,
                                tuple(d.img_hw))
        crop.crop_resize_by_warp_affine(rgb, c, s, S,
                                        interpolation=crop.INTER_LINEAR)
        for img in (dpt, mask):
            crop.crop_resize_by_warp_affine(
                img, c, s, S, interpolation=crop.INTER_NEAREST)

    clock("crops (rgb linear, depth and mask nearest)", crops)
    vis = clock("HPR hull (pose_visibility)", lambda r: gt_gen.pose_visibility(
        r.pose, ds.mesh_pts, cfg.data.hpr_radius_param))
    pts = ds.mesh_pts @ recs[0].pose[:, :3].T + recs[0].pose[:, 3]
    t0 = time.perf_counter()
    for v in vis:
        gt_gen.radius_nn(pts[v > 0], pts, 0.01)
    t["radius NN (GT match)"] = (time.perf_counter() - t0) * 1e3 / len(vis)
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    t["whole sample, 1 thread (hull cached after its first use)"] = \
        (time.perf_counter() - t0) * 1e3 / n
    # two batches on 8 threads; one batch on 2 spawned processes, whose
    # start-up is nearly all of their time (8 processes took ~63-66 s on
    # the card's host, for one batch as for two)
    for kind, n, w in (("thread", 2, 8), ("process", 1, 2)):
        ds.annos = ds.annos[:n * TRAIN_BATCH]
        dl = DataLoader(ds, TRAIN_BATCH, num_workers=w, workers=kind)
        t0 = time.perf_counter()
        k = sum(b["rgb_u8"].shape[0] for b, _ in dl)
        t[f"whole sample, {w} {kind} workers, {k} samples (start-up "
          f"included)"] = (time.perf_counter() - t0) * 1e3 / k
    for name, ms in t.items():
        log(f"  loader (train mode) {name}: {ms:.3f} ms/sample")
    return t


def train_model(cfg):
    """Seeded random training GeoMatch at ``cfg``'s widths and dtypes."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.build import torch_dtype
    from gdm_tpu_torch.models.geomatch import GeoMatch

    model = GeoMatch(cfg.model.feat_dim, tuple(cfg.model.randla_d_out),
                     spline_kernel=cfg.model.spline_kernel, awl=True,
                     compute_dtype=torch_dtype(cfg.model.compute_dtype),
                     gather_bwd_dtype=torch_dtype(
                         cfg.model.gather_bwd_dtype))
    weights.init_random_(model, torch.Generator().manual_seed(SEED))
    return model


def without_dropout(model):
    """``model`` with every dropout rate set to 0."""
    from gdm_tpu_torch.models.layers import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return model


def object_mesh(cfg, root, device):
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.geomatch import MeshArrays
    from gdm_tpu_torch.models.spline_mesh import build_mesh_graph

    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    fps_mm = np.concatenate([fps[:, :3] * 1000.0, fps[:, 3:]], axis=1)
    return MeshArrays.from_graph(build_mesh_graph(
        fps_mm, cfg.model.n_mesh_node), device)


def step_parity(root):
    """The train step on the card against the CPU's from the same state
    and inputs, at a small size (B 4, 1024 points, 64^2 crop, 64 mesh
    vertices; full model widths; dropout off; TF32 off).  The inputs
    (finalize + KNN pyramid) are made once, on the CPU: the two devices'
    distance blocks round differently, and a flipped near-tie neighbour
    would change the function compared.

    In float64, where the gradient is defined far beyond 1e-3, every
    gradient tensor of the card must lie within max|d|/max|ref| <= 1e-3
    of the CPU's.  In f32, the loss must agree within 1e-4; the f32
    gradient of this model is only defined to ~1% per tensor (see
    tests/test_torch_train.py), so each f32 gradient tensor of the card
    must lie within 8 s_t + 1e-3 of the CPU's float64 one, where s_t is
    the card's own f32 spread for that tensor (the largest change of its
    f32 gradient when every float input moves by a relative 1e-7, over
    four draws).  max|ref| is floored at 1e-6 of the model's largest
    gradient (biases right before a train-mode BN have a true gradient of
    0)."""
    import copy

    from gdm_tpu_torch import configs
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import finalize_batch, to_device
    from gdm_tpu_torch.train import schedules
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import BATCH_KEYS, make_train_step, \
        train_inputs

    cfg = configs.get_config("lmo", [
        "data.input_size=64", "data.num_sample_points=1024",
        "data.model_pt_num=64", "model.n_mesh_node=64"])
    ds = PoseDataset(cfg, 1, "train", data_root=root)
    batch, _ = collate([ds[i] for i in range(4)])
    with torch.no_grad():
        inputs = train_inputs(finalize_batch(to_device(
            {k: batch[k] for k in BATCH_KEYS}, "cpu")), positive_r(cfg), 512)
    base = without_dropout(train_model(cfg))
    step = make_train_step(schedules.bn_momentum_schedule(),
                           positive_r(cfg), knn_chunk=512)

    def run(device, inp, dtype=torch.float32):
        model = copy.deepcopy(base).to(device, dtype)
        state = create_train_state(
            model, schedules.cyclic_lr(1e-6, 1e-3, 10), 0.0, 5)
        mesh = object_mesh(cfg, root, device)
        mesh = type(mesh)(*[x.to(dtype) if x is not None
                            and x.is_floating_point() else x for x in mesh])
        m = step(state, {k: v.to(device, dtype) if v.is_floating_point()
                         else v.to(device) for k, v in inp.items()},
                 mesh, SEED)
        return float(m["loss"]), {k: p.grad.detach().cpu().numpy()
                                  for k, p in model.named_parameters()}

    loss_g, g_gpu = run("cuda", inputs)
    loss_c, g_cpu = run("cpu", inputs)
    _, g_64 = run("cpu", inputs, torch.float64)
    _, g_gpu64 = run("cuda", inputs, torch.float64)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in g_64.values())
    gen = torch.Generator().manual_seed(SEED)
    spread = dict.fromkeys(g_gpu, 0.0)
    for _ in range(4):
        moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                 if v.is_floating_point() and k != "positive_r" else v
                 for k, v in inputs.items()}
        _, g = run("cuda", moved)
        for k in g_gpu:
            spread[k] = max(spread[k], rel(g[k], g_gpu[k], floor))
    dloss = abs(loss_g - loss_c) / abs(loss_c)
    e64 = {k: rel(g_gpu64[k], g_64[k], floor) for k in g_64}
    direct = sum(rel(g_gpu[k], g_cpu[k], floor) <= 1e-3 for k in g_cpu)
    to64 = {k: rel(g_gpu[k], g_64[k], floor) for k in g_64}
    cpu64 = {k: rel(g_cpu[k], g_64[k], floor) for k in g_64}
    worse = sorted((to64[k], spread[k], k) for k in to64
                   if to64[k] > 8 * spread[k] + 1e-3)
    log(f"  step parity (B 4, 1024 points, 64^2 crop, inputs made on the "
        f"CPU): float64 gradients, card against CPU, max|d|/max|ref| worst "
        f"{max(e64.values()):.3g} over {len(e64)} tensors; f32 loss GPU "
        f"{loss_g:.6f} CPU {loss_c:.6f} (|d|/|ref| {dloss:.3g}); f32 "
        f"gradient tensors within 1e-3 of the CPU's f32: {direct} of "
        f"{len(g_cpu)}; f32 to the CPU's float64, median over tensors: card "
        f"{np.median(list(to64.values())):.3g}, CPU "
        f"{np.median(list(cpu64.values())):.3g}; the card's own f32 spread "
        f"s_t: median {np.median(list(spread.values())):.3g}, max "
        f"{max(spread.values()):.3g}; card f32 tensors beyond 8 s_t + 1e-3 "
        f"of the float64 gradient: {len(worse)}")
    if max(e64.values()) > 1e-3:
        fail(f"step parity: float64 gradients of the card differ from the "
             f"CPU's by up to {max(e64.values()):.3g} (> 1e-3)")
    if dloss > 1e-4:
        fail(f"step parity: loss differs by {dloss:.3g} (> 1e-4)")
    if worse:
        fail(f"step parity: {len(worse)} f32 gradient tensors of the card "
             f"lie beyond 8 s_t + 1e-3 of the float64 gradient, worst "
             f"(err, s_t, name) {worse[-3:]}")
    return {"dloss": dloss, "max_err64": max(e64.values()),
            "direct": direct, "n": len(g_cpu),
            "median_to64": float(np.median(list(to64.values()))),
            "median_spread": float(np.median(list(spread.values())))}


def positive_r(cfg):
    """The circle-loss positive radius of object 1 (ape)."""
    from gdm_tpu_torch import refdata

    return cfg.model.neighbor_dis_th \
        * refdata.get("lmo").diameters_mm_by_id[1] / 1000.0


def rel(a, ref, floor=1e-30):
    """max|a - ref| / max|ref|, with max|ref| floored at ``floor``."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), floor))


def fixed_batch_steps(cfg, root, n_steps=30, trace=False,
                      batch_size=TRAIN_BATCH, pos_r=None, falls=True):
    """n_steps train steps on one fixed batch of ``batch_size`` at full
    width: every loss finite and, with ``falls``, the loss must fall
    (last 5 below the first 5 on average); the step split and device-only
    samples/s from synchronised timings.  ``pos_r``: the circle-loss
    radius (default LM-O's object 1's).  With ``trace``, 3 more steps
    under torch.profiler: kernel ms per step by name, and the gather
    backward's index_add_ kernels (indexFunc*)."""
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.train import schedules
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    ds = PoseDataset(cfg, 1, "train", data_root=root)
    batch, _ = collate([ds[i] for i in range(batch_size)])
    mesh = object_mesh(cfg, root, "cuda")
    model = train_model(cfg).to("cuda")
    state = create_train_state(model, schedules.cyclic_lr(1e-4, 1e-4, 1),
                               0.0, 5)
    step = make_train_step(schedules.bn_momentum_schedule(
        batch_size=batch_size), positive_r(cfg) if pos_r is None else pos_r,
        knn_chunk=1024)
    losses, timing = [], {}
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        t = {} if i >= 5 else None            # the first 5 warm up
        losses.append(float(step(state, batch, mesh, SEED, timing=t)["loss"]))
        if t is not None:
            for k, v in t.items():
                timing[k] = timing.get(k, 0.0) + v
    n = n_steps - 5
    split = {k: v / n for k, v in timing.items()}
    total = sum(split.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  fixed batch of {batch_size}, {n_steps} steps: mean loss of the "
        f"first 5 {first:.4f}, of the last 5 {last:.4f}")
    log(f"  step split (mean of steps 6-{n_steps}, synchronised): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f"; total {total:.2f} ms = {batch_size / total * 1e3:.2f} "
        f"samples/s device-only; peak device memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)):
        fail("non-finite train loss on the fixed batch")
    if falls and not last < first:
        fail(f"overfit check: last-5 mean loss {last} not below first-5 "
             f"mean {first}")
    if trace:
        kernel_ms = traced_steps(lambda: step(state, batch, mesh, SEED), 3)
        k_total = sum(kernel_ms.values())
        index_add = sum(v for k, v in kernel_ms.items() if "indexFunc" in k)
        log(f"  traced steps: {k_total:.2f} ms of kernels per step; "
            f"index_add_ (indexFunc*, the gather backward's sums) "
            f"{index_add:.2f} ms ({index_add / k_total:.1%})")
        for name, ms in sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:.2f} ms per step ({ms / k_total:.1%}) {name[:100]}")
    return {"split_ms": split, "device_sps": batch_size / total * 1e3,
            "first5": first, "last5": last, "peak_gib": peak}


def traced_steps(run, n):
    """Kernel milliseconds per call of ``run`` by kernel name, from
    torch.profiler over n calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / n
    if not out:
        fail("torch.profiler recorded no device time in the traced steps")
    return out


def step_loop_rates(steps, cold=2, prefetch=2):
    """samples/s, the loader-wait share and the median step of the cli
    train step loop, in three groups of each epoch's steps: cold (the
    first ``cold``: the loader's pipeline fills, and in a process's first
    epoch CUDA and cuDNN warm up); loader decoding (the steps during
    which the loader's threads still decode this epoch's samples, as they
    do throughout a long epoch); loader done (the last prefetch + 1 steps,
    whose batches were decoded before they began: the loader's queue
    holds ``prefetch`` batches and one more is in flight)."""
    per_epoch = max(r["it"] for r in steps) + 1
    late = per_epoch - (prefetch + 1)
    groups = (("cold", lambda it: it < cold),
              ("loader decoding", lambda it: cold <= it < late),
              ("loader done", lambda it: it >= max(late, cold)))
    out = {}
    for name, member in groups:
        part = [r for r in steps if member(r["it"])]
        wait = sum(r["wait_ms"] for r in part)
        busy = sum(r["wait_ms"] + r["step_ms"] for r in part)
        out[name] = {"steps": len(part),
                     "sps": len(part) * TRAIN_BATCH * 1e3 / busy,
                     "wait_share": wait / busy,
                     "median_step_ms": float(np.median(
                         [r["step_ms"] for r in part]))}
        its = sorted({r["it"] for r in part})
        log(f"  step loop, {name} ({len(part)} steps, it {its[0]}-{its[-1]} "
            f"of each epoch): {out[name]['sps']:.2f} samples/s, loader wait "
            f"{wait:.2f} of {busy:.2f} ms ({wait / busy:.1%}), median step "
            f"{out[name]['median_step_ms']:.2f} ms")
    return out


def write_torchvision_resnet18(path, seed=SEED):
    """A seeded state dict under torchvision's resnet18 names and shapes
    (its fc head and BN step counters included), saved as ``.pth``: what
    ``--pretrained-backbone`` reads from an ImageNet file."""
    g = np.random.RandomState(seed)
    sd = {}

    def conv(name, c_out, c_in, k):
        sd[f"{name}.weight"] = (g.randn(c_out, c_in, k, k)
                                * np.sqrt(2.0 / (c_in * k * k)))

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * g.randn(c)
        sd[f"{name}.bias"] = 0.1 * g.randn(c)
        sd[f"{name}.running_mean"] = 0.1 * g.randn(c)
        sd[f"{name}.running_var"] = g.uniform(0.5, 1.5, c)
        sd[f"{name}.num_batches_tracked"] = np.int64(g.randint(1, 10 ** 6))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    c_in = 64
    for layer, planes in enumerate((64, 128, 256, 512), 1):
        for blk in range(2):
            p = f"layer{layer}.{blk}"
            conv(f"{p}.conv1", planes, c_in, 3)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            if blk == 0 and c_in != planes:
                conv(f"{p}.downsample.0", planes, c_in, 1)
                bn(f"{p}.downsample.1", planes)
            c_in = planes
    sd["fc.weight"] = 0.01 * g.randn(1000, 512)
    sd["fc.bias"] = np.zeros(1000)
    sd = {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in sd.items()}
    torch.save(sd, path)
    return sd


class PretrainedCheck:
    """While active, each ``load_pretrained_backbone`` that ``cli train``
    makes is held against the file: every entry but ``fc.*`` loaded, bit
    for bit, into the model's trunk."""

    def __init__(self, sd):
        self.sd, self.n = sd, 0

    def __enter__(self):
        from gdm_tpu_torch.train import import_torch

        self.mod, self.orig = import_torch, import_torch.load_pretrained_backbone

        def load(model, w):
            out = self.orig(model, w)
            got = {import_torch.torchvision_key(k): v
                   for k, v in model.state_dict().items()
                   if import_torch.torchvision_key(k)}
            want = [k for k in self.sd if not k.startswith("fc.")]
            bad = [k for k in want if k not in got
                   or not torch.equal(got[k].cpu(), self.sd[k])]
            if bad:
                fail(f"--pretrained-backbone: {len(bad)} of {len(want)} "
                     f"tensors not loaded as in the file ({bad[:3]})")
            log(f"  --pretrained-backbone: all {len(want)} trunk tensors of "
                "the file in the model, bit for bit, before the first step")
            self.n += 1
            return out

        import_torch.load_pretrained_backbone = load
        return self

    def __exit__(self, *exc):
        self.mod.load_pretrained_backbone = self.orig


def train_phase(sim, workdir):
    """cli train (2 epochs, validating), --resume to 3 epochs, cli eval of
    the result; step parity; the fixed-batch overfit and timings.
    Returns the kernel launches of the two train runs."""
    import json as _json

    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMO as cfg

    root = osp.join(workdir, "lmo_train")
    ckpt_root = osp.join(workdir, "train_log")
    t0 = time.perf_counter()
    write_train_tree(root)
    log(f"  synthetic tree ({TRAIN_FRAMES} JPEG train_pbr + {VAL_FRAMES} "
        f"test frames, 480x640) written in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    loader_stages(cfg, root)
    log(f"  loader stages measured in {time.perf_counter() - t0:.2f} s")

    common = ["train", "--dataset", "lmo", "--data-root", root,
              "--cls-id", "1", "--batch-size", str(TRAIN_BATCH),
              "--eval-every", "1", "--ckpt-root", ckpt_root,
              "--num-workers", "8", "--opt",
              "solver.checkpoint_every_epochs=1"]
    tv_path = osp.join(workdir, "resnet18_torchvision.pth")
    tv = write_torchvision_resnet18(tv_path)
    launches, steps = 0, []
    for extra in (["--epochs", "2", "--pretrained-backbone", tv_path],
                  ["--epochs", "3", "--resume"]):
        torch.cuda.reset_peak_memory_stats()
        sim.cosine_argmax.launches = 0
        t0 = time.perf_counter()
        with FitChecks(sim, f"train {' '.join(extra)} validation") as fc, \
                PretrainedCheck(tv) as pc:
            res = cli.main(common + extra)
        if pc.n != ("--pretrained-backbone" in extra):
            fail(f"cli train {' '.join(extra)}: {pc.n} backbone loads")
        wall = time.perf_counter() - t0 - fc.seconds
        n_launch = sim.cosine_argmax.launches
        launches += n_launch
        timing = res["timing"]
        steps += timing
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_samples = len(timing) * TRAIN_BATCH
        val = res["objects"]["ape"]["val"]
        log(f"  cli train {' '.join(extra)}: {len(timing)} steps in "
            f"{wall:.2f} s end to end ({n_samples / wall:.2f} samples/s, "
            f"engine set-up and validation included, the plain checks of "
            f"validation's {fc.n} batches ({fc.seconds:.2f} s) not); "
            f"peak device memory {peak:.2f} GiB; similarity kernel launches "
            f"{n_launch}, each held against the plain argmax; validation "
            f"{val}")
        for r in timing:
            log(f"    epoch {r['epoch']} it {r['it']}: loader wait "
                f"{r['wait_ms']:.2f} ms, step {r['step_ms']:.2f} ms")
        if n_launch == 0:
            fail("validation did not launch the similarity kernel")
        if fc.n != n_launch:
            fail(f"{n_launch} kernel launches but {fc.n} batches checked")
        if val is None or val["val_frames"] != VAL_FRAMES:
            fail(f"validation result {val}")
    step_loop_rates(steps)
    ckpt_dir = osp.join(ckpt_root, "checkpoints", "ape")
    with open(osp.join(ckpt_dir, "latest")) as f:
        latest = f.read().strip()
    rows = [_json.loads(line) for line in open(
        osp.join(ckpt_root, "metrics", "ape.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    log(f"  checkpoints: {sorted(os.listdir(ckpt_dir))}, latest {latest}; "
        f"metrics lines {len(rows)}, losses {[round(x, 4) for x in losses]}")
    if latest != "epoch_0002" or not all(np.isfinite(losses)):
        fail(f"train: latest {latest}, losses {losses}")
    out = osp.join(workdir, "train_eval")
    sim.cosine_argmax.launches = 0
    with FitChecks(sim, "eval of the trained checkpoint") as fc:
        res = cli.main(["eval", "--dataset", "lmo", "--data-root", root,
                        "--torch-checkpoint",
                        osp.join(ckpt_root, "checkpoints"), "--cls-id", "1",
                        "--exact-knn", "--batch-size", str(TRAIN_BATCH),
                        "--output-dir", out])
    if fc.n != sim.cosine_argmax.launches:
        fail(f"{sim.cosine_argmax.launches} kernel launches but {fc.n} "
             "batches checked")
    poses = read_csv_poses(osp.join(out, "gt_lmo-test.csv"))
    if len(poses) != VAL_FRAMES:
        fail(f"eval of the trained checkpoint: {len(poses)} rows")
    log(f"  cli eval of the trained checkpoint: {len(poses)} rows, "
        f"ADD(-S) AUC {res['auc']['ape']:.4f}")
    parity = step_parity(root)
    fixed = fixed_batch_steps(cfg, root)
    return launches, {"parity": parity, "fixed": fixed}



DGCNN = ["--opt", "model.backbone=dgcnn"]
DGCNN_TOL = 1e-4    # card vs CPU: outputs and loss of the DGCNN variant
TIE = 1e-6          # graph near-tie: gap < TIE (|x_i|^2 + |x_j|^2), float64


class GraphTape:
    """While active, every graph that gdm_tpu_torch.models.dgcnn builds
    (each ``knn`` call, in order) is recorded with its coordinates, or,
    given ``replay``, taken from an earlier tape instead of searched; with
    ``timed`` each call is synchronised and its milliseconds kept."""

    def __init__(self, replay=None, timed=False):
        self.replay, self.timed = replay, timed
        self.graphs, self.coords, self.ms = [], [], []

    def __enter__(self):
        from gdm_tpu_torch.models import dgcnn

        self.mod, orig = dgcnn, dgcnn.knn

        def knn(support, query, k, chunk=1024):
            if self.timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if self.replay is not None:
                idx = self.replay[len(self.graphs)].to(query.device)
            else:
                idx = orig(support, query, k, chunk)
            if self.timed:
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
            else:
                self.graphs.append(idx)
                self.coords.append(query)
            return idx

        self.orig, dgcnn.knn = orig, knn
        return self

    def __exit__(self, *exc):
        self.mod.knn = self.orig


def graphs_beyond_near_ties(tag, tape):
    """The card's graphs of ``tape`` against the CPU's top-k on the same
    coordinates: wherever they differ, the two neighbours at that rank lie
    at float64 distances from the point within TIE (|x_i|^2 + |x_j|^2) of
    each other.  Returns (rows that differ, rows) over all graphs."""
    from gdm_tpu_torch.ops.knn import knn

    n_diff = n_rows = 0
    for a, x in zip(tape.graphs, tape.coords):
        x = x.cpu()
        a, b = a.cpu(), knn(x, x, a.shape[-1])
        x = x.double()
        diff = a != b
        n_diff += int(diff.any(-1).sum())
        n_rows += a.shape[0] * a.shape[1]
        if not diff.any():
            continue
        bi, ri, ki = diff.nonzero(as_tuple=True)
        xi = x[bi, ri]
        xa, xb = x[bi, a[bi, ri, ki]], x[bi, b[bi, ri, ki]]
        da = ((xa - xi) ** 2).sum(-1)
        db = ((xb - xi) ** 2).sum(-1)
        scale = (xi * xi).sum(-1) + torch.maximum((xa * xa).sum(-1),
                                                  (xb * xb).sum(-1))
        worst = float(((da - db).abs() / scale).max())
        if worst > TIE:
            fail(f"{tag}: graph neighbours differ beyond near-ties "
                 f"(gap {worst:.3g} of |x_i|^2 + |x_j|^2)")
    return n_diff, n_rows


def dgcnn_weights(cfg, seed=SEED, awl=False):
    """Seeded random GeoMatchDGCNN weights under the reference names (both
    BN names); the seg head calls every point foreground, as
    random_weights does for GeoMatch."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN

    model = GeoMatchDGCNN(cfg.model.feat_dim, awl=awl)
    weights.init_random_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.seg_layer[3].conv.weight.zero_()
        model.seg_layer[3].conv.bias.copy_(torch.tensor([0.0, 1.0]))
    return model


def checked_cli_run(sim, tag, args):
    """One ``cli`` run with every batch it fits held against the plain
    argmax (FitChecks); eval and infer launch the kernel once per batch
    plus the warm-up.  Returns (result, launches, peak GiB, check ms)."""
    from gdm_tpu_torch import cli

    torch.cuda.reset_peak_memory_stats()
    sim.cosine_argmax.launches = 0
    with FitChecks(sim, tag) as fc:
        res = cli.main(args)
    launches = sim.cosine_argmax.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches == 0 or fc.n != launches:
        fail(f"{tag}: {launches} kernel launches, {fc.n} batches checked")
    if args[0] != "train" and launches != len(res["timing"]) + 1:
        fail(f"{tag}: {launches} kernel launches for "
             f"{len(res['timing'])} batches + the warm-up")
    return res, launches, peak, fc.check_ms


def dgcnn_forward_costs(cfg, root, ckpt, batch):
    """On one eval batch of ``batch``: the forward's device ms, the three
    scene graphs' ms in it (each synchronised), and the mesh branch's
    encode ms (medians of 3 after a warm-up)."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.cli import get_logger, knn_chunk_for
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.serve import PoseEngine, full_f32

    ds = PoseDataset(cfg, 1, "test", data_root=root)
    raw, _ = collate([ds[i] for i in range(batch)])
    raw = {k: raw[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop",
                               "choose", "det")}
    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    fps[:, :3] *= 1000.0
    chunk = knn_chunk_for(1024, batch, cfg, get_logger("chip_smoke"))
    engine = PoseEngine(cfg, fps, weights.read_reference_checkpoint(
        osp.join(ckpt, "ape")), "cuda", batch=batch, knn_chunk=chunk)
    fin = engine.finalize(raw)
    model, x = engine.model, {"cld_rgb_nrm": fin["cld_rgb_nrm"]}

    def forward():
        return model(x, engine.mesh, mesh_features=engine.mesh_feats,
                     knn_chunk=chunk)

    def clocked(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.no_grad(), full_f32():
        forward()
        fwd = float(np.median([clocked(forward) for _ in range(3)]))
        graphs = []
        for _ in range(3):
            with GraphTape(timed=True) as tape:
                forward()
            graphs.append(sum(tape.ms))
        enc = float(np.median([clocked(lambda: model.encode_mesh(
            engine.mesh)) for _ in range(3)]))
    graph_ms = float(np.median(graphs))
    log(f"  DGCNN forward at b={batch} (knn chunk {chunk}): {fwd:.2f} ms; "
        f"its three scene graphs (exact top-16 of [{batch}, "
        f"{x['cld_rgb_nrm'].shape[1]}, {x['cld_rgb_nrm'].shape[1]}], "
        f"each synchronised) {graph_ms:.2f} ms = {graph_ms / fwd:.1%} of "
        f"the forward; mesh branch encode {enc:.2f} ms (once per object)")
    del engine, fin, x
    torch.cuda.empty_cache()
    return {"forward_ms": fwd, "graph_ms": graph_ms, "encode_ms": enc}


def dgcnn_parity(root):
    """GeoMatchDGCNN on the card against the CPU at full n (4096 points,
    4096 mesh vertices) and b=2, seeded random weights, dropout off.

    Eval forward: the card's graphs equal beyond near-ties to the CPU's
    top-k on the same coordinates; the CPU's forward on the card's graphs
    within DGCNN_TOL (seg, rgbd, mesh; max|d|/max|ref|).  Train step, every run on the graphs the CPU's
    f32 step built (the function compared stays one): loss within
    DGCNN_TOL, float64 gradients per tensor within 1e-3, f32 gradients
    within 8 s_t + 1e-3 of the CPU's float64 ones (step_parity's rule)."""
    import copy

    from gdm_tpu_torch import configs
    from gdm_tpu_torch.cli import _fps_mm
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import finalize_batch, to_device
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.serve import full_f32
    from gdm_tpu_torch.train import schedules
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import BATCH_KEYS, DGCNN_KEYS, \
        make_train_step

    cfg = configs.get_config("lmo", ["model.backbone=dgcnn"])
    ds = PoseDataset(cfg, 1, "train", data_root=root)
    batch, _ = collate([ds[i] for i in range(2)])
    with torch.no_grad():
        fin = finalize_batch(to_device(
            {k: batch[k] for k in BATCH_KEYS + ("origin_labels",)}, "cpu"))
    inputs = {k: fin[k] for k in DGCNN_KEYS}
    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    mesh_x = build_model(cfg, _fps_mm(fps), "cpu").mesh
    base = without_dropout(dgcnn_weights(cfg, awl=True))

    def forward(device, tape):
        m = copy.deepcopy(base).to(device).eval()
        with tape, torch.no_grad(), full_f32():
            out = m({"cld_rgb_nrm": inputs["cld_rgb_nrm"].to(device)},
                    mesh_x.to(device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    tape_g, tape_c = GraphTape(), GraphTape()
    out_g = forward("cuda", tape_g)
    out_c = forward("cpu", tape_c)
    n_diff, n_rows = graphs_beyond_near_ties("DGCNN forward, card vs CPU",
                                             tape_g)
    own_diff = sum(int((a.cpu() != b).any(-1).sum())
                   for a, b in zip(tape_g.graphs, tape_c.graphs))
    out_r = forward("cpu", GraphTape(replay=tape_g.graphs))
    errs = {k: rel(out_g[k], out_r[k]) for k in ("seg", "rgbd", "mesh")}
    own = {k: rel(out_g[k], out_c[k]) for k in errs}
    log(f"  DGCNN eval forward, card vs CPU (b=2, full n): the card's graph "
        f"rows that differ from the CPU's top-k on the same coordinates "
        f"{n_diff} of {n_rows}, all near-ties; on the card's graphs "
        f"max|d|/max|ref| " + ", ".join(f"{k} {v:.3g}" for k, v in
                                         errs.items())
        + f" (each device on its own graphs, whose rows differ in {own_diff} "
        f"of {n_rows} (near-ties of the first graph change the features "
        "the next two rank): " + ", ".join(
            f"{k} {v:.3g}" for k, v in own.items()) + ")")
    if max(errs.values()) > DGCNN_TOL:
        fail(f"DGCNN forward card vs CPU: {errs} > {DGCNN_TOL}")

    step = make_train_step(schedules.bn_momentum_schedule(), 0.0,
                           knn_chunk=1024, needs_pyramid=False)

    def run(device, inp, tape, dtype=torch.float32):
        """One step on ``inp`` (the batch's inputs and "mesh_x")."""
        model = copy.deepcopy(base).to(device, dtype)
        state = create_train_state(
            model, schedules.cyclic_lr(1e-6, 1e-3, 10), 0.0, 5)
        inp = {k: v.to(device, dtype) if v.is_floating_point()
               else v.to(device) for k, v in inp.items()}
        with tape:
            m = step(state, inp, inp.pop("mesh_x"), SEED)
        return float(m["loss"]), {k: p.grad.detach().cpu().numpy()
                                  for k, p in model.named_parameters()}

    inputs["mesh_x"] = mesh_x
    tape = GraphTape()
    loss_c, g_cpu = run("cpu", inputs, tape)
    graphs = [g.clone() for g in tape.graphs]

    def replay():
        return GraphTape(replay=graphs)

    loss_g, g_gpu = run("cuda", inputs, replay())
    _, g_64 = run("cpu", inputs, replay(), torch.float64)
    _, g_gpu64 = run("cuda", inputs, replay(), torch.float64)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in g_64.values())
    gen = torch.Generator().manual_seed(SEED)
    spread = dict.fromkeys(g_gpu, 0.0)
    for _ in range(4):          # the mesh input moves too
        moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                 if v.is_floating_point() else v for k, v in inputs.items()}
        _, g = run("cuda", moved, replay())
        for k in g_gpu:
            spread[k] = max(spread[k], rel(g[k], g_gpu[k], floor))
    dloss = abs(loss_g - loss_c) / abs(loss_c)
    e64 = {k: rel(g_gpu64[k], g_64[k], floor) for k in g_64}
    to64 = {k: rel(g_gpu[k], g_64[k], floor) for k in g_64}
    cpu64 = {k: rel(g_cpu[k], g_64[k], floor) for k in g_64}
    worse = sorted((to64[k], spread[k], k) for k in to64
                   if to64[k] > 8 * spread[k] + 1e-3)
    log(f"  DGCNN train step, card vs CPU (b=2, full n, the CPU's graphs): "
        f"loss {loss_g:.6f} vs {loss_c:.6f} (|d|/|ref| {dloss:.3g}); float64 "
        f"gradients worst {max(e64.values()):.3g} over {len(e64)} tensors; "
        f"f32 to the CPU's float64, median over tensors: card "
        f"{np.median(list(to64.values())):.3g} (worst "
        f"{max(to64.values()):.3g}), CPU {np.median(list(cpu64.values())):.3g}"
        f" (worst {max(cpu64.values()):.3g}); the card's own f32 spread median "
        f"{np.median(list(spread.values())):.3g}, max "
        f"{max(spread.values()):.3g}; beyond 8 s_t + 1e-3: {len(worse)}")
    if dloss > DGCNN_TOL or max(e64.values()) > 1e-3 or worse:
        fail(f"DGCNN step parity: dloss {dloss:.3g}, float64 worst "
             f"{max(e64.values()):.3g}, f32 beyond bound {worse[-3:]}")
    return {"forward_err": errs, "dloss": dloss,
            "max_err64": max(e64.values())}


def dgcnn_step_split(cfg, root, n_steps=10):
    """n_steps DGCNN train steps on one fixed batch of TRAIN_BATCH: the
    step split and device-only samples/s (synchronised, the first 3
    warm up), peak memory."""
    from gdm_tpu_torch.cli import _fps_mm
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.train import schedules
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    ds = PoseDataset(cfg, 1, "train", data_root=root)
    batch, _ = collate([ds[i] for i in range(TRAIN_BATCH)])
    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    mesh = build_model(cfg, _fps_mm(fps), "cuda").mesh
    model = dgcnn_weights(cfg, awl=True).to("cuda")
    state = create_train_state(model, schedules.cyclic_lr(1e-4, 1e-4, 1),
                               0.0, 5)
    step = make_train_step(schedules.bn_momentum_schedule(
        batch_size=TRAIN_BATCH), 0.0, knn_chunk=1024, needs_pyramid=False)
    timing, losses = {}, []
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        t = {} if i >= 3 else None
        losses.append(float(step(state, batch, mesh, SEED, timing=t)["loss"]))
        if t is not None:
            for k, v in t.items():
                timing[k] = timing.get(k, 0.0) + v
    split = {k: v / (n_steps - 3) for k, v in timing.items()}
    total = sum(split.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  DGCNN step split at b={TRAIN_BATCH} (mean of steps 4-{n_steps}, "
        "synchronised): " + ", ".join(f"{k} {v:.2f} ms"
                                      for k, v in split.items())
        + f"; total {total:.2f} ms = {TRAIN_BATCH / total * 1e3:.2f} "
        f"samples/s device-only; peak device memory {peak:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}")
    if not all(np.isfinite(losses)):
        fail("DGCNN: non-finite train loss on the fixed batch")
    return {"split_ms": split, "peak_gib": peak}


def dgcnn_phase(sim, eval_dir, train_dir):
    """The DGCNN backbone (--opt model.backbone=dgcnn) through cli eval |
    infer | score at b=128 on the eval phase's tree and cli train b=24 on
    the train phase's, then its costs and card-vs-CPU parity.  Returns
    the similarity kernel's launches in its CLI runs."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.configs import get_config

    cfg = get_config("lmo", ["model.backbone=dgcnn"])
    root, out = osp.join(eval_dir, "lmo"), osp.join(eval_dir, "out_dgcnn")
    ckpt = osp.join(eval_dir, "ckpt_dgcnn")
    os.makedirs(osp.join(ckpt, "ape"))
    torch.save({"model_state": weights.reference_state_dict(
        dgcnn_weights(cfg))}, osp.join(ckpt, "ape", "geomatch.pth.tar"))
    common = ["--dataset", "lmo", "--data-root", root, "--torch-checkpoint",
              ckpt, "--cls-id", "1", "--exact-knn", "--num-workers", "8",
              *DGCNN]
    res, launches, peak, check_ms = checked_cli_run(
        sim, "dgcnn eval", ["eval", *common, "--output-dir", out])
    timing = res["timing"]
    poses = read_csv_poses(osp.join(out, "gt_lmo-test.csv"))
    if len(poses) != EVAL_FRAMES:
        fail(f"dgcnn eval CSV has {len(poses)} rows, want {EVAL_FRAMES}")
    n_fit = check_poses(np.stack(list(poses.values())), EVAL_FRAMES)
    log("  dgcnn cli eval b=128: per-batch device ms " + ", ".join(
        f"{b['device_ms']:.2f} ({b['device_ms'] - c:.2f} without the plain "
        "check)" for b, c in zip(timing, check_ms[1:]))
        + f"; peak device memory {peak:.2f} GiB; kernel launches "
        f"{launches}, each held against the plain argmax; {len(poses)} "
        f"rows, {n_fit} fitted")
    infer_csv = osp.join(out, "infer.csv")
    _, n_inf, _, _ = checked_cli_run(sim, "dgcnn infer", [
        "infer", *common, "--output", infer_csv])
    inferred = read_csv_poses(infer_csv)
    if list(inferred) != list(poses):
        fail("dgcnn infer CSV rows differ from eval's")
    dpose = max(float(np.abs(inferred[k] - poses[k]).max()) for k in poses)
    if dpose > POSE_TOL:
        fail(f"dgcnn infer poses differ from eval's by {dpose}")
    scored = cli.main(["score", "--dataset", "lmo", "--data-root", root,
                       "--cls-id", "1", "--csv",
                       osp.join(out, "gt_lmo-test.csv"), *DGCNN])
    if scored["recalls"] != res["recalls"]:
        fail("dgcnn score of the eval CSV does not reproduce eval's recalls")
    log(f"  dgcnn cli infer: same rows, max |dpose| {dpose:.3g}, launches "
        f"{n_inf}; cli score reproduces eval's recalls")
    launches += n_inf

    troot = osp.join(train_dir, "lmo_train")
    ckpt_root = osp.join(train_dir, "train_log_dgcnn")
    t0 = time.perf_counter()
    res, n_val, peak, _ = checked_cli_run(sim, "dgcnn train validation", [
        "train", "--dataset", "lmo", "--data-root", troot, "--cls-id", "1",
        "--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--eval-every",
        "1", "--ckpt-root", ckpt_root, "--num-workers", "8", *DGCNN])
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(
        osp.join(ckpt_root, "metrics", "ape.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    val = res["objects"]["ape"]["val"]
    steps = res["timing"]
    if not losses or not all(np.isfinite(losses)) or val is None \
            or val["val_frames"] != VAL_FRAMES:
        fail(f"dgcnn train: losses {losses}, validation {val}")
    log(f"  dgcnn cli train b={TRAIN_BATCH}, 1 epoch: {len(steps)} steps in "
        f"{wall:.2f} s end to end (validation and its plain checks "
        f"included); step ms " + ", ".join(f"{r['step_ms']:.2f}"
                                          for r in steps)
        + f"; peak device memory {peak:.2f} GiB; losses {losses}; "
        f"validation {val}; kernel launches {n_val}")
    res, n_ev, _, _ = checked_cli_run(sim, "dgcnn eval of the trained "
                                     "checkpoint", [
        "eval", "--dataset", "lmo", "--data-root", troot,
        "--torch-checkpoint", osp.join(ckpt_root, "checkpoints"),
        "--cls-id", "1", "--exact-knn", "--batch-size", str(TRAIN_BATCH),
        "--output-dir", osp.join(train_dir, "dgcnn_eval"), *DGCNN])
    log(f"  dgcnn cli eval of the trained checkpoint: ADD(-S) AUC "
        f"{res['auc']['ape']:.4f}, kernel launches {n_ev}")
    launches += n_val + n_ev
    dgcnn_forward_costs(cfg, root, ckpt, 128)
    dgcnn_step_split(cfg, troot)
    dgcnn_parity(troot)
    return launches, [b["device_ms"] - c
                      for b, c in zip(timing, check_ms[1:])]


BF16 = ["--opt", "model.compute_dtype=bfloat16"]
BF16_GAP_FACTOR = 2.0   # card vs CPU, both bf16: x the CPU's bf16-vs-f32 gap
BF16_CEILING = 2e-2     # ... and at most this on seg and rgbd
# conv kernels by name (cuDNN's implicit GEMM, FFT and Winograd forms);
# f32 ones by their element types
CONV_TOKENS = ("fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_conv",
               "winograd", "convolve", "conv2d", "fft",
               "pointwise_mult_and_sum_complex")
F32_TOKENS = ("f32f32", "sgemm", "float2", "<float")


def conv_kernels(by_name):
    return {k: v for k, v in by_name.items()
            if any(t in k.lower() for t in CONV_TOKENS)}


def kernel_split(tag, by_name, n=6):
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]:
        log(f"    {tag}: {us / 1e3:.2f} ms per batch ({us / total:.1%}) "
            f"{name[:100]}")


def bf16_card_vs_cpu(root, b=2):
    """One full-width batch of ``b`` eval frames through GeoMatch in bf16
    on the card and on the CPU (and in f32 on the CPU), seeded random
    weights, the card's finalized inputs and pyramid for all three: the
    card within BF16_GAP_FACTOR x the CPU's own bf16-vs-f32 gap of the
    CPU's bf16 forward, and within BF16_CEILING, on seg and rgbd; the f32
    mesh branch within DGCNN_TOL."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.cli import _fps_mm
    from gdm_tpu_torch.configs import get_config
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import build_pyramid, finalize_batch, \
        to_device
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.serve import full_f32

    cfg = get_config("lmo", BF16[1:])
    ds = PoseDataset(cfg, 1, "test", data_root=root)
    batch, _ = collate([ds[i] for i in range(b)])
    raw = {k: batch[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop",
                                 "choose", "det")}
    fps_mm = _fps_mm(load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num))
    with torch.no_grad(), full_f32():
        fin = finalize_batch(to_device(raw, "cuda"))
        inputs = {k: fin[k] for k in ("rgb", "cld_rgb_nrm", "choose")}
        inputs.update(build_pyramid(fin["cld_rgb_nrm"][..., :3],
                                    fin["xyz_img"], 1024))
    sd = None
    outs = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "bfloat16"),
                       ("cpu", "float32")):
        t0 = time.perf_counter()
        c = get_config("lmo", [f"model.compute_dtype={dtype}"])
        setup = build_model(c, fps_mm, dev)
        if sd is None:
            weights.init_random_(setup.model,
                                 torch.Generator().manual_seed(SEED))
            sd = setup.model.state_dict()
        setup.model.load_state_dict(sd)
        model = setup.model.to(dev).eval()
        with torch.no_grad(), full_f32():
            out = model({k: v.to(dev) for k, v in inputs.items()},
                        setup.mesh)
        outs[(dev, dtype)] = {k: out[k].cpu().numpy()
                              for k in ("seg", "rgbd", "mesh")}
        log(f"  bf16 card vs CPU: the {dev} forward in {dtype} at b={b} "
            f"(full width) in {time.perf_counter() - t0:.2f} s")
    card, cpu, cpu32 = (outs[("cuda", "bfloat16")], outs[("cpu", "bfloat16")],
                        outs[("cpu", "float32")])
    for key in ("seg", "rgbd"):
        err, gap = rel(card[key], cpu[key]), rel(cpu[key], cpu32[key])
        log(f"  bf16 card vs CPU, {key}: max|d|/max|ref| {err:.3g}; the "
            f"CPU's own bf16-vs-f32 gap {gap:.3g}")
        if card[key].dtype != np.float32 or not np.isfinite(card[key]).all():
            fail(f"bf16 card {key}: dtype {card[key].dtype} or non-finite")
        if not (err <= BF16_GAP_FACTOR * gap and err <= BF16_CEILING):
            fail(f"bf16 card vs CPU {key}: {err} (gap {gap})")
    err = rel(card["mesh"], cpu["mesh"])
    log(f"  bf16 card vs CPU, mesh (an f32 branch): {err:.3g}")
    if err > DGCNN_TOL:
        fail(f"bf16 card vs CPU mesh: {err}")


def bf16_phase(sim, eval_dir, train_dir, smi, f32):
    """model.compute_dtype=bfloat16 on the eval and train phases' trees:
    cli eval b=128 (flagship) beside f32, its --profile-dir trace's
    convolution split (no f32 conv kernel left), the card against the CPU
    on one full-width batch, cli train b=24 with gather_bwd_dtype bf16 too
    and its fixed-batch step split and trace, DGCNN cli eval b=128.  Every
    fit held against the plain argmax.  Returns the kernel launches."""
    root, ckpt = osp.join(eval_dir, "lmo"), osp.join(eval_dir, "ckpt")
    common = ["--dataset", "lmo", "--data-root", root, "--cls-id", "1",
              "--exact-knn", "--num-workers", "8", *BF16]
    res, launches, peak, check_ms = checked_cli_run(
        sim, "bf16 eval", ["eval", *common, "--torch-checkpoint", ckpt,
                           "--output-dir", osp.join(eval_dir, "out_bf16")])
    timing = res["timing"]
    poses = read_csv_poses(osp.join(eval_dir, "out_bf16", "gt_lmo-test.csv"))
    if len(poses) != EVAL_FRAMES:
        fail(f"bf16 eval CSV has {len(poses)} rows, want {EVAL_FRAMES}")
    n_fit = check_poses(np.stack(list(poses.values())), EVAL_FRAMES)
    log(f"  {smi}: bf16 cli eval b=128: device ms per batch " + ", ".join(
        f"{b['device_ms'] - c:.2f}" for b, c in zip(timing, check_ms[1:]))
        + " (the plain checks' time taken out); f32 (eval phase): "
        + ", ".join(f"{b['device_ms']:.2f}" for b in f32["eval_timing"])
        + f"; peak device memory {peak:.2f} GiB (f32: "
        f"{f32['eval_peak']:.2f}); {len(poses)} rows, {n_fit} fitted; kernel"
        f" launches {launches}, each held against the plain argmax")

    n_prof, shares, by_name = profile_run(sim, eval_dir, smi, BF16,
                                          "profile_bf16")
    launches += n_prof
    conv16, conv32 = conv_kernels(by_name), conv_kernels(f32["kernels"])
    for tag, convs in (("f32", conv32), ("bf16", conv16)):
        total = sum(convs.values())
        log(f"  {smi}: conv kernels of a traced b=128 eval batch, {tag}: "
            f"{total / 1e3:.2f} ms per batch")
        kernel_split(f"{tag} conv", convs)
    f32_left = sorted(k for k in conv16 if k in conv32
                      or any(t in k for t in F32_TOKENS))
    if not conv16 or f32_left:
        fail(f"bf16 trace: conv kernels {sorted(conv16)[:4]}, f32 ones "
             f"among them {f32_left[:4]}")

    bf16_card_vs_cpu(root)

    from gdm_tpu_torch.configs import get_config

    troot = osp.join(train_dir, "lmo_train")
    ckpt_root = osp.join(train_dir, "train_log_bf16")
    both = [*BF16, "--opt", "model.gather_bwd_dtype=bfloat16"]
    t0 = time.perf_counter()
    res, n_val, peak, _ = checked_cli_run(sim, "bf16 train validation", [
        "train", "--dataset", "lmo", "--data-root", troot, "--cls-id", "1",
        "--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--eval-every",
        "1", "--ckpt-root", ckpt_root, "--num-workers", "8", *both])
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(
        osp.join(ckpt_root, "metrics", "ape.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    val = res["objects"]["ape"]["val"]
    if not losses or not all(np.isfinite(losses)) or val is None \
            or val["val_frames"] != VAL_FRAMES:
        fail(f"bf16 train: losses {losses}, validation {val}")
    log(f"  bf16 cli train b={TRAIN_BATCH}, 1 epoch: {len(res['timing'])} "
        f"steps in {wall:.2f} s end to end (validation and its plain checks "
        "included); step ms " + ", ".join(f"{r['step_ms']:.2f}"
                                          for r in res["timing"])
        + f"; peak device memory {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; kernel launches {n_val}")
    launches += n_val
    cfg = get_config("lmo", [o for o in both if o != "--opt"])
    fixed = fixed_batch_steps(cfg, troot, n_steps=15, trace=True)
    log(f"  {smi}: bf16 step split " + ", ".join(
        f"{k} {v:.2f}" for k, v in fixed["split_ms"].items())
        + f" ms, peak {fixed['peak_gib']:.2f} GiB; f32 (train phase) "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    f32["train_fixed"]["split_ms"].items())
        + f" ms, peak {f32['train_fixed']['peak_gib']:.2f} GiB")

    res, n_dg, peak, check_ms = checked_cli_run(sim, "bf16 dgcnn eval", [
        "eval", *common, *DGCNN, "--torch-checkpoint",
        osp.join(eval_dir, "ckpt_dgcnn"), "--output-dir",
        osp.join(eval_dir, "out_dgcnn_bf16")])
    log(f"  {smi}: bf16 dgcnn cli eval b=128: device ms per batch "
        + ", ".join(f"{b['device_ms'] - c:.2f}"
                    for b, c in zip(res["timing"], check_ms[1:]))
        + "; f32 (dgcnn phase): " + ", ".join(
            f"{ms:.2f}" for ms in f32["dgcnn_timing"])
        + f" (plain checks' time taken out); peak {peak:.2f} GiB; kernel "
        f"launches {n_dg}")
    return launches + n_dg


YCBV_TEST = {oid: 8 if oid == 1 else 6 for oid in range(1, 22)}   # 128
YCBV_TRAIN_FRAMES, YCBV_TRAIN_BATCH, YCBV_SYM = 12, 8, 13   # 024_bowl
FINALIZE_TOL = 1e-4      # |card - CPU| of finalize_batch(fill_depth=True)


class StackedChecks:
    """While active, every batch a MultiObjectEngine fits is held against
    the plain argmax, each row against its own object's mesh features
    (MultiObjectEngine.infer wrapped for the duration)."""

    def __init__(self, sim, tag):
        self.sim, self.tag = sim, tag
        self.n, self.seconds = 0, 0.0
        self.check_ms = []          # per batch, the warm-up's first

    def __enter__(self):
        from gdm_tpu_torch.eval import pose_fit
        from gdm_tpu_torch.eval.multimodel import MultiObjectEngine
        from gdm_tpu_torch.ops.similarity import cosine_argmax_reference

        self.orig = orig = MultiObjectEngine.infer

        def infer(engine, fin):
            poses = orig(engine, fin)
            if poses.is_cuda:           # the fit's own time stays out
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit, pos = engine.last_fit, np.asarray(fin["obj_pos"])
            rows = bad = sure = 0
            for p in np.unique(pos):
                r = torch.as_tensor(np.nonzero(pos == p)[0],
                                    device=fit["idx"].device)
                mf = pose_fit.l2_normalise(engine.engines[p].mesh_feats)
                f = pose_fit.l2_normalise(fit["rgbd"][r])
                f = f.reshape(-1, f.shape[-1])
                idx_ref, _ = cosine_argmax_reference(f, mf)
                top2 = torch.topk(f @ mf.T, 2, dim=-1).values
                ok = top2[:, 0] - top2[:, 1] > GAP
                bad += int(((fit["idx"][r].reshape(-1) != idx_ref)
                            & ok).sum())
                rows, sure = rows + len(ok), sure + int(ok.sum())
            log(f"  {self.tag} batch {self.n}: {len(np.unique(pos))} "
                f"objects, {rows} rows, index mismatches {bad} of {sure} "
                f"rows with top-2 gap > {GAP}")
            if bad:
                fail(f"{self.tag}: {bad} index mismatches beyond near-ties")
            self.check_ms.append((time.perf_counter() - t0) * 1e3)
            self.seconds += self.check_ms[-1] / 1e3
            self.n += 1
            return poses

        MultiObjectEngine.infer = infer
        return self

    def __exit__(self, *exc):
        from gdm_tpu_torch.eval.multimodel import MultiObjectEngine

        MultiObjectEngine.infer = self.orig


def write_ycbv_tree(root, ckpt):
    """The 21 YCB-V objects at 480x640 (a mesh of each one's diameter):
    YCBV_TEST test frames (128: one mixed batch), YCBV_TRAIN_FRAMES frames
    of object 1 in each of train_real, train_pbr and train_synt,
    models_info.json with 024_bowl's continuous symmetry, and one seeded
    random checkpoint linked for every object (the objects' meshes
    differ; the stacked phase runs distinct weights per object)."""
    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import YCBV as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_ycbv_root

    refd = refdata.get("ycbv")
    rng = np.random.RandomState(SEED + 5)
    meshes = {oid: make_object(cfg.data.model_pt_num, rng,
                               radius=refd.diameters_mm_by_id[oid] / 2500.0)
              for oid in cfg.data.obj_ids}
    write_synthetic_ycbv_root(
        root, meshes, YCBV_TEST, 1, YCBV_TRAIN_FRAMES, cfg.data.img_hw,
        seed=SEED + 5, diameters_mm=refd.diameters_mm_by_id,
        sym_ids=(YCBV_SYM,))
    os.makedirs(ckpt)
    blob = osp.join(ckpt, "geomatch.pth.tar")
    torch.save({"model_state": random_weights(cfg, SEED + 40)}, blob)
    for oid in cfg.data.obj_ids:
        d = osp.join(ckpt, refd.id2obj[oid])
        os.makedirs(d)
        os.symlink(blob, osp.join(d, "geomatch.pth.tar"))


def ycbv_host_costs(cfg, root):
    """Loader ms/sample over the 128 mixed frames (8 threads) with and
    without the depth fill, and the fill alone per crop."""
    import dataclasses

    from gdm_tpu_torch import cli
    from gdm_tpu_torch.data.augment import fill_depth_fast
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import DataLoader

    out = {True: [], False: []}
    # an untimed pass first (the frames' first reads), then in turns
    for k, fill in enumerate((False, True, False, True, False)):
        c = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, fill_depth=fill))
        mixed = cli.MixedInferDataset([
            (oid, PoseDataset(c, oid, "infer", data_root=root))
            for oid in cfg.data.obj_ids])
        t0 = time.perf_counter()
        n = sum(b["rgb_u8"].shape[0] for b, _ in DataLoader(
            mixed, len(mixed), num_workers=8))
        if k:
            out[fill].append((time.perf_counter() - t0) * 1e3 / n)
    crops = [mixed[k] for k in range(32)]
    t0 = time.perf_counter()
    for it in crops:
        fill_depth_fast(it["dpt_u16"].astype(np.float32) / it["dpt_scale"])
    out["fill"] = (time.perf_counter() - t0) * 1e3 / len(crops)
    log(f"  loader (infer mode, 8 threads, {n} mixed frames, in turns): "
        + ", ".join(f"{v:.3f}" for v in out[True]) + " ms/sample with the "
        "depth fill, " + ", ".join(f"{v:.3f}" for v in out[False])
        + f" without; the fill alone {out['fill']:.3f} ms per "
        f"{cfg.data.input_size}^2 crop (1 thread)")
    return out


def ycbv_finalize_check(cfg, root):
    """finalize_batch(fill_depth=True) of object 1's frames on the card
    against the CPU, and the normals of the chosen hole pixels (raw depth
    0, filled depth > 0)."""
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import finalize_batch, to_device

    ds = PoseDataset(cfg, 1, "test", data_root=root)
    raw, _ = collate([ds[i] for i in range(len(ds))])
    raw = {k: raw[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale",
                               "dpt_filled", "K_crop", "choose", "det")}
    dev = to_device(raw, "cuda")
    got = finalize_batch(dev, True)["cld_rgb_nrm"]
    want = finalize_batch(to_device(raw, "cpu"), True)["cld_rgb_nrm"]
    err = float((got.cpu() - want).abs().max())
    b = np.arange(len(ds))[:, None]
    hole = raw["dpt_u16"].reshape(len(ds), -1)[b, raw["choose"]] == 0
    nrm = got[..., 6:9].norm(dim=-1).cpu().numpy()[hole]
    nrm_raw = finalize_batch(dev, False)["cld_rgb_nrm"][..., 6:9].norm(
        dim=-1).cpu().numpy()[hole]
    lit = float((nrm > 0.5).mean()) if hole.any() else 0.0
    log(f"  finalize_batch(fill_depth=True), {len(ds)} frames: card vs CPU "
        f"max |d| {err:.3g} (tolerance {FINALIZE_TOL}); {int(hole.sum())} "
        f"chosen hole pixels (raw depth 0): {lit:.1%} of them get a unit "
        "normal from the filled depth, none from the raw depth (max |n| "
        f"{float(nrm_raw.max(initial=0.0)):.3g})")
    if err > FINALIZE_TOL:
        fail(f"finalize_batch(fill_depth=True) card vs CPU: {err}")
    if not hole.any() or lit < 0.5 or nrm_raw.max(initial=0.0) > 1e-6:
        fail(f"hole pixels: {int(hole.sum())}, normals from the fill on "
             f"{lit:.1%}, from the raw depth up to {nrm_raw.max()}")


def ycbv_train(sim, cfg, workdir, root):
    """cli train --dataset ycbv at b=8 with train_synt added (mix, noise,
    real backgrounds and fill all run), then cli eval of its checkpoint.
    Returns the similarity launches of the eval."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.data import dataset as ds_mod
    from gdm_tpu_torch.train import step as step_mod

    calls = {"noise": 0, "paste": 0, "fill": 0}
    picks, losses = [], []

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    orig = {k: getattr(ds_mod, k) for k in (
        "rgb_add_noise", "add_real_background", "fill_depth_fast")}
    orig_pick = ds_mod.PoseDataset._pick_record
    orig_make = step_mod.make_train_step

    def pick(ds, idx, rng):
        rec = orig_pick(ds, idx, rng)
        picks.append(rec.img_type)
        return rec

    def make(*a, **kw):
        step = orig_make(*a, **kw)

        def run(*sa, **skw):
            m = step(*sa, **skw)
            losses.append(float(m["loss"]))
            return m
        return run

    ds_mod.rgb_add_noise = counted("noise", orig["rgb_add_noise"])
    ds_mod.add_real_background = counted("paste",
                                         orig["add_real_background"])
    ds_mod.fill_depth_fast = counted("fill", orig["fill_depth_fast"])
    ds_mod.PoseDataset._pick_record = pick
    step_mod.make_train_step = make
    ckpt_root = osp.join(workdir, "ycbv_train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = cli.main([
            "train", "--dataset", "ycbv", "--data-root", root, "--cls-id",
            "1", "--epochs", "1", "--batch-size", str(YCBV_TRAIN_BATCH),
            "--ckpt-root", ckpt_root, "--num-workers", "8", "--opt",
            "data.train_subsets=train_real,train_pbr,train_synt", "--opt",
            "solver.checkpoint_every_epochs=1"])
    finally:
        for k, fn in orig.items():
            setattr(ds_mod, k, fn)
        ds_mod.PoseDataset._pick_record = orig_pick
        step_mod.make_train_step = orig_make
    wall = time.perf_counter() - t0
    steps = res["timing"]
    kinds = {k: picks.count(k) for k in ("real", "synt", "pbr")}
    log(f"  cli train --dataset ycbv: {len(steps)} steps of "
        f"{YCBV_TRAIN_BATCH} in {wall:.2f} s end to end; step ms "
        + ", ".join(f"{r['step_ms']:.2f}" for r in steps)
        + f"; loader wait ms " + ", ".join(f"{r['wait_ms']:.2f}"
                                            for r in steps)
        + f"; losses {[round(x, 4) for x in losses]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; records "
        f"picked {kinds}; rgb_add_noise {calls['noise']}, "
        f"add_real_background {calls['paste']}, fill_depth_fast "
        f"{calls['fill']} calls")
    if not steps or len(losses) != len(steps) \
            or not np.isfinite(losses).all():
        fail(f"ycbv train: {len(steps)} steps, losses {losses}")
    if min(kinds.values()) == 0 or calls["paste"] == 0 \
            or calls["noise"] < calls["paste"] or calls["fill"] == 0:
        fail(f"ycbv train: picks {kinds}, calls {calls}")
    out = osp.join(workdir, "ycbv_train_eval")
    sim.cosine_argmax.launches = 0
    with FitChecks(sim, "ycbv eval of the trained checkpoint") as fc:
        cli.main(["eval", "--dataset", "ycbv", "--data-root", root,
                  "--torch-checkpoint", osp.join(ckpt_root, "checkpoints"),
                  "--cls-id", "1", "--exact-knn", "--output-dir", out])
    n = sim.cosine_argmax.launches
    rows = read_csv_poses(osp.join(out, "gt_ycbv-test.csv"))
    if fc.n != n or len(rows) != YCBV_TEST[1]:
        fail(f"ycbv eval of the trained checkpoint: {n} launches, {fc.n} "
             f"checked, {len(rows)} rows")
    log(f"  cli eval of the ycbv checkpoint: {len(rows)} rows, {n} kernel "
        "launches held against the plain argmax")
    return n


def ycbv_vsd_check(res, vsd_calls, n_vsd, n_faces, n_rows):
    """``cli eval --vsd --dataset ycbv`` of object 1: one VSD error row per
    frame in [0, 1], the stamp renderer called, and on the first
    YCBV_VSD_CPU_FRAMES frames the card's errors equal to vsd_err_batch's
    on the CPU from the same inputs, at the eval's poses and at the GT
    poses (the plain renderer takes seconds per render of the hull)."""
    from gdm_tpu_torch.eval.vsd import vsd_err_batch

    (obj_errs,) = res["errors"].values()
    errs = np.asarray(obj_errs["vsd"])
    if errs.shape != (n_rows, 10) or not np.isfinite(errs).all() \
            or errs.min() < 0 or errs.max() > 1 or n_vsd == 0:
        fail(f"ycbv eval --vsd: errors of shape {errs.shape} for {n_rows} "
             f"rows, stamp renderer calls {n_vsd}")
    t0 = time.perf_counter()
    (args, kw), out = vsd_calls.first
    n = YCBV_VSD_CPU_FRAMES
    poses, depths, K = args[0][:n], args[1][:n], args[2][:n]
    # the random weights' poses miss (errors near 1): the GT poses as the
    # estimates give errors below 1 as well
    at_gt = [(R, t, R, t) for _, _, R, t in poses]
    card = vsd_err_batch(at_gt, depths, K, *args[3:], **kw)
    for tag, p, want in (("eval's poses", poses, out[:n]),
                         ("GT poses", at_gt, card)):
        cpu = vsd_err_batch(p, depths, K, *args[3:], **dict(kw, device="cpu"))
        if not np.array_equal(cpu, want):
            fail(f"ycbv eval --vsd at the {tag}: card and CPU errors differ "
                 f"by {np.abs(cpu - want).max()}")
    if card.min() >= 1:
        fail("ycbv VSD at the GT poses: every error is 1")
    log(f"  cli eval --vsd --dataset ycbv (object 1, {n_faces}-face hull): "
        f"{n_rows} VSD error rows, mean {errs.mean():.4f}; stamp renderer "
        f"calls {n_vsd}, host binning calls 0; on {n} frames the card's "
        f"errors equal the CPU's, at the eval's poses and at the GT poses "
        f"(mean {card.mean():.4f}) ({time.perf_counter() - t0:.2f} s)")


def ycbv_phase(sim, workdir):
    """The YCB-V preset (fill_depth, the real/pbr mix, noise and real
    backgrounds) at its widths: cli eval --vsd at b=128 on object 1, cli
    infer --stacked on one mixed batch of 128 over the 21 objects, cli
    train at b=8; finalize on the card against the CPU; the host costs.
    Returns the similarity launches of the eval, stacked and trained-eval
    runs, and the stamp renderer's calls of the eval."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import YCBV as cfg
    from gdm_tpu_torch.ops import render_depth as rd

    root, ckpt = osp.join(workdir, "ycbv"), osp.join(workdir, "ckpt_ycbv")
    batch = cfg.solver.val_batch_size
    t0 = time.perf_counter()
    write_ycbv_tree(root, ckpt)
    log(f"  synthetic YCB-V tree ({sum(YCBV_TEST.values())} test frames of "
        f"{len(cfg.data.obj_ids)} objects, {YCBV_TRAIN_FRAMES} frames of "
        "object 1 in each train subset, 480x640) and checkpoints written "
        f"in {time.perf_counter() - t0:.2f} s")
    ycbv_host_costs(cfg, root)
    ycbv_finalize_check(cfg, root)

    launches = 0
    common = ["--dataset", "ycbv", "--data-root", root, "--torch-checkpoint",
              ckpt, "--exact-knn", "--num-workers", "8"]
    out = osp.join(workdir, "ycbv_out")
    n_faces = write_eval_mesh(root)
    torch.cuda.reset_peak_memory_stats()
    sim.cosine_argmax.launches = 0
    rd.render_depth_window.launches = 0
    t0 = time.perf_counter()
    with FitChecks(sim, "ycbv eval") as fc, \
            Calls("vsd_err_batch") as vsd_calls, \
            NoHostBinning("ycbv eval --vsd"):
        res = cli.main(["eval", *common, "--cls-id", "1", "--vsd",
                        "--output-dir", out])
    wall = time.perf_counter() - t0 - fc.seconds
    n = sim.cosine_argmax.launches
    launches += n
    n_vsd = rd.render_depth_window.launches
    rows = read_csv_poses(osp.join(out, "gt_ycbv-test.csv"))
    ycbv_vsd_check(res, vsd_calls, n_vsd, n_faces, len(rows))
    log(f"  cli eval --dataset ycbv (object 1, b={batch}): device ms per "
        "batch " + ", ".join(
            f"{b['device_ms']:.2f} ({b['device_ms'] - c:.2f} without the "
            f"plain check's {c:.2f})"
            for b, c in zip(res["timing"], fc.check_ms[1:]))
        + f"; {len(rows)} rows in {wall:.2f} s end to end; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"kernel launches {n}, each held against the plain argmax")
    if n != len(res["timing"]) + 1 or fc.n != n or len(rows) != YCBV_TEST[1]:
        fail(f"ycbv eval: {n} launches, {fc.n} checked, {len(rows)} rows")
    check_poses(np.stack(list(rows.values())), len(rows))

    csv = osp.join(workdir, "ycbv_stacked.csv")
    torch.cuda.reset_peak_memory_stats()
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    with StackedChecks(sim, "ycbv stacked") as sc:
        res = cli.main(["infer", *common, "--stacked", "--stacked-group",
                        str(STACKED_GROUP), "--output", csv])
    wall = time.perf_counter() - t0 - sc.seconds
    n = sim.cosine_argmax.launches
    launches += n
    timing = res["timing"]
    rows = read_csv_poses(csv)
    frames = sum(b["n"] for b in timing)
    net = [b["device_ms"] - c for b, c in zip(timing, sc.check_ms[1:])]
    dev_s = sum(net) / 1e3
    pos = {oid: p for p, oid in enumerate(cfg.data.obj_ids)}
    want = stacked_launches([pos[k[2]] for k in rows], timing, batch,
                            "by_class")
    log(f"  cli infer --stacked --dataset ycbv (by_class, group "
        f"{STACKED_GROUP}): {frames} frames of {len({k[2] for k in rows})} "
        f"objects in {len(timing)} batch(es), device ms per batch "
        + ", ".join(f"{b['device_ms']:.2f} ({n:.2f} without the plain "
                    "checks)" for b, n in zip(timing, net))
        + f"; {frames / dev_s:.2f} frames/s device, {frames / wall:.2f} "
        "frames/s end to end (21 engine builds and the warm-up included); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel "
        f"launches {n} (want {want}), each held against the plain argmax")
    if len(rows) != sum(YCBV_TEST.values()) or len(timing) != 1 \
            or len({k[2] for k in rows}) != len(cfg.data.obj_ids):
        fail(f"ycbv stacked: {len(rows)} rows in {len(timing)} batches")
    if n != want or sc.n != len(timing) + 1:
        fail(f"ycbv stacked: {n} launches (want {want}), {sc.n} batches "
             "checked")
    check_poses(np.stack(list(rows.values())), len(rows))
    launches += ycbv_train(sim, cfg, workdir, root)
    return launches, n_vsd


LMFULL_TEST, LMFULL_TRAIN = 48, 24   # test frames; frames of each train subset
LMFULL_LATENCY_REQUESTS = 10         # timed requests at each of b=1 and b=8
LMFULL_SERVE_SHAPE = (8 * 12800, 4096, 128)     # served b=8 and eval b=8
LMFULL_VAL_SHAPE = (6 * 12800, 4096, 128)       # train validation, b=6
LMFULL_TOL = 1e-4    # card vs CPU forward on the card's inputs and pyramid


def write_lmfull_tree(root, ckpt, n_test=LMFULL_TEST, n_train=LMFULL_TRAIN):
    """A synthetic LM-full tree for object 1 (ape) at 480x640: ``n_test``
    ``test`` frames and ``n_train`` frames of each of ``real``, ``fuse``
    and ``renders`` (depth in mm, read /1000), a background behind the
    object in test, real and fuse frames, 1 mm of depth noise; and its
    seeded random checkpoint <ckpt>/ape/geomatch.pth.tar."""
    from gdm_tpu_torch.configs import LMFULL as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_lmfull_root

    write_synthetic_lmfull_root(
        root, make_object(cfg.data.model_pt_num, np.random.RandomState(SEED)),
        n_test, n_train, im_hw=cfg.data.img_hw, seed=SEED, obj_id=1)
    os.makedirs(osp.join(ckpt, "ape"), exist_ok=True)
    torch.save({"model_state": random_weights(cfg)},
               osp.join(ckpt, "ape", "geomatch.pth.tar"))


def lmfull_serving(sim, root, ckpt, workdir, smi):
    """``cli export-serving --dataset lmfull --batch-size 8`` and ``cli
    serve`` of the artifact on a thread: the warm-up, then
    LMFULL_LATENCY_REQUESTS timed requests each at b=8 and b=1 (128^2
    crops, 12800 points), every served batch held against the plain
    argmax and every pose valid.  Returns the launches and latencies."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMFULL as cfg
    from gdm_tpu_torch.eval import pose_fit
    from gdm_tpu_torch.server import request_poses

    art_root = osp.join(workdir, "serving_lmfull")
    im, n_sample = cfg.data.input_size, cfg.data.num_sample_points
    meta = cli.main(["export-serving", "--dataset", "lmfull", "--data-root",
                     root, "--torch-checkpoint", ckpt, "--cls-id", "1",
                     "--batch-size", str(cfg.solver.val_batch_size),
                     "--exact-knn", "--out", osp.join(art_root, "ape")])
    log(f"  cli export-serving --dataset lmfull: raw_spec {meta['raw_spec']}")
    rng = np.random.RandomState(SEED)
    torch.cuda.reset_peak_memory_stats()
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    service, server = cli.start_server(cli.build_parser().parse_args(
        ["serve", "--artifact", art_root, "--port", "0"]))
    torch.cuda.synchronize()
    log(f"  cli serve: engine built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s")
    engine = service.engines["ape"]
    check_fit_indices(engine.last_fit, sim, pose_fit, "lmfull warm-up")
    n_batches = 1
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    lat = {}
    try:
        for b in (cfg.solver.val_batch_size, 1):
            ms, compute = [], []
            for _ in range(LMFULL_LATENCY_REQUESTS):
                raw = make_request(b, im, n_sample, rng)
                t0 = time.perf_counter()
                poses, compute_ms = request_poses(url, raw)
                ms.append((time.perf_counter() - t0) * 1e3)
                compute.append(compute_ms)
                check_poses(poses, b)
                check_fit_indices(engine.last_fit, sim, pose_fit,
                                  f"lmfull b={b} request {len(ms)}")
                n_batches += 1
            lat[b] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p95_ms": float(np.percentile(ms, 95)),
                      "compute_p50_ms": float(np.percentile(compute, 50))}
        launches = sim.cosine_argmax.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for b, v in lat.items():
        log(f"  {smi}: LM-full served latency at b={b} over "
            f"{LMFULL_LATENCY_REQUESTS} requests (client clock, HTTP "
            f"included): p50 {v['p50_ms']:.2f} ms, p95 {v['p95_ms']:.2f} "
            f"ms; server compute p50 {v['compute_p50_ms']:.2f} ms")
    if launches != n_batches:
        fail(f"lmfull serving: {launches} launches for {n_batches} batches")
    log(f"  kernel launches in the served run: {launches} (the warm-up and "
        f"2 x {LMFULL_LATENCY_REQUESTS} requests, each held against the "
        f"plain argmax); peak device memory {peak:.2f} GiB")
    return launches, lat


def lmfull_eval(sim, root, ckpt, workdir):
    """``cli eval | infer | score --dataset lmfull`` at the val batch of 8:
    every batch held against the plain argmax, the infer CSV equal to the
    eval CSV, the score of it equal to eval's recalls.  Returns the
    launches, per-batch timing and peak GiB of the eval run."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.configs import LMFULL as cfg

    batch = cfg.solver.val_batch_size
    common = ["--dataset", "lmfull", "--data-root", root,
              "--torch-checkpoint", ckpt, "--cls-id", "1", "--exact-knn",
              "--num-workers", "8"]
    out = osp.join(workdir, "lmfull_out")
    t0 = time.perf_counter()
    res, launches, peak, check_ms = checked_cli_run(
        sim, "lmfull eval", ["eval", *common, "--output-dir", out])
    wall = time.perf_counter() - t0 - sum(check_ms) / 1e3
    timing = res["timing"]
    net = [b["device_ms"] - c for b, c in zip(timing, check_ms[1:])]
    log(f"  cli eval --dataset lmfull (b={batch}, 12800 points, 128^2 "
        "crops): device ms per batch without the plain checks "
        f"{np.round(net, 2).tolist()}, median {np.median(net):.2f}; "
        f"{LMFULL_TEST} frames in {wall:.2f} s end to end; peak device "
        f"memory {peak:.2f} GiB; kernel launches {launches}, each held "
        "against the plain argmax")
    csv = osp.join(out, "gt_lmfull-test.csv")
    poses = read_csv_poses(csv)
    if len(poses) != LMFULL_TEST:
        fail(f"lmfull eval CSV has {len(poses)} rows")
    check_poses(np.stack(list(poses.values())), LMFULL_TEST)
    infer_csv = osp.join(workdir, "lmfull_infer.csv")
    _, n, _, _ = checked_cli_run(sim, "lmfull infer",
                                 ["infer", *common, "--output", infer_csv])
    launches += n
    inferred = read_csv_poses(infer_csv)
    if list(inferred) != list(poses):
        fail("lmfull infer CSV rows differ from eval's")
    dpose = max(float(np.abs(inferred[k] - poses[k]).max()) for k in poses)
    if dpose > POSE_TOL:
        fail(f"lmfull infer poses differ from eval's by {dpose}")
    scored = cli.main(["score", "--dataset", "lmfull", "--data-root", root,
                       "--cls-id", "1", "--csv", csv])
    if scored["recalls"] != res["recalls"]:
        fail("lmfull score of the eval CSV does not reproduce its recalls")
    log(f"  cli infer: the eval CSV's {len(poses)} rows, max |dpose| "
        f"{dpose:.3g}; cli score of the eval CSV: eval's recalls")
    return launches, {"device_ms": net, "peak_gib": peak}


def lmfull_train(sim, root, workdir):
    """``cli train --dataset lmfull`` at b=6 for one epoch (the three
    train subsets), validating (every batch held against the plain
    argmax), finite losses; then 10 steps on one fixed batch of 6 for the
    step split and the peak.  Returns the launches and the numbers."""
    import json as _json

    from gdm_tpu_torch import refdata
    from gdm_tpu_torch.configs import LMFULL as cfg

    ckpt_root = osp.join(workdir, "lmfull_train_log")
    t0 = time.perf_counter()
    res, launches, peak, _ = checked_cli_run(sim, "lmfull train", [
        "train", "--dataset", "lmfull", "--data-root", root, "--cls-id", "1",
        "--epochs", "1", "--eval-every", "1", "--ckpt-root", ckpt_root,
        "--num-workers", "8"])
    wall = time.perf_counter() - t0
    steps = res["timing"]
    rows = [_json.loads(line) for line in open(
        osp.join(ckpt_root, "metrics", "ape.jsonl"))]
    losses = [r["loss"] for r in rows if "loss" in r]
    step_ms = [r["step_ms"] for r in steps]
    log(f"  cli train --dataset lmfull (b={cfg.solver.train_batch_size}, "
        f"{3 * LMFULL_TRAIN} records of real, fuse and renders): "
        f"{len(steps)} steps in {wall:.2f} s end to end (validation "
        f"included), step ms {np.round(step_ms, 2).tolist()}; logged losses "
        f"{[round(x, 4) for x in losses]}; peak device memory {peak:.2f} "
        f"GiB; validation launches {launches}, each held against the plain "
        f"argmax; validation {res['objects']['ape']['val']}")
    if len(steps) != 3 * LMFULL_TRAIN // cfg.solver.train_batch_size \
            or not losses or not np.isfinite(losses).all():
        fail(f"lmfull train: {len(steps)} steps, losses {losses}")
    pos_r = cfg.model.neighbor_dis_th \
        * refdata.get("lm_full").diameters_mm_by_id[1] / 1000.0
    fixed = fixed_batch_steps(cfg, root, n_steps=15,
                              batch_size=cfg.solver.train_batch_size,
                              pos_r=pos_r, falls=False)
    return launches, {"step_ms": step_ms, "cli_peak_gib": peak,
                      "fixed": fixed}


def lmfull_card_vs_cpu(root, b=2):
    """One full-width LM-full batch of ``b`` test frames (12800 points,
    128^2 crops) through GeoMatch on the card and on the CPU, from the
    card's finalized inputs and pyramid (a second pyramid would pick its
    own near-ties): seg, rgbd and mesh within LMFULL_TOL."""
    from gdm_tpu_torch import weights
    from gdm_tpu_torch.cli import _fps_mm
    from gdm_tpu_torch.configs import LMFULL as cfg
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import collate
    from gdm_tpu_torch.data.pipeline import build_pyramid, finalize_batch, \
        to_device
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.serve import full_f32

    ds = PoseDataset(cfg, 1, "test", data_root=root)
    batch, _ = collate([ds[i] for i in range(b)])
    raw = {k: batch[k] for k in ("rgb_u8", "dpt_u16", "dpt_scale", "K_crop",
                                 "choose", "det")}
    fps_mm = _fps_mm(load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num))
    with torch.no_grad(), full_f32():
        fin = finalize_batch(to_device(raw, "cuda"))
        inputs = {k: fin[k] for k in ("rgb", "cld_rgb_nrm", "choose")}
        inputs.update(build_pyramid(fin["cld_rgb_nrm"][..., :3],
                                    fin["xyz_img"], 1024))
    sd, outs = None, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        setup = build_model(cfg, fps_mm, dev)
        if sd is None:
            weights.init_random_(setup.model,
                                 torch.Generator().manual_seed(SEED))
            sd = setup.model.state_dict()
        setup.model.load_state_dict(sd)
        model = setup.model.to(dev).eval()
        with torch.no_grad(), full_f32():
            out = model({k: v.to(dev) for k, v in inputs.items()},
                        setup.mesh)
        outs[dev] = {k: out[k].cpu().numpy() for k in ("seg", "rgbd", "mesh")}
        log(f"  LM-full card vs CPU: the {dev} forward at b={b} (12800 "
            f"points, full width) in {time.perf_counter() - t0:.2f} s")
    errs = {}
    for key in ("seg", "rgbd", "mesh"):
        errs[key] = rel(outs["cuda"][key], outs["cpu"][key])
        if not np.isfinite(outs["cuda"][key]).all() \
                or errs[key] > LMFULL_TOL:
            fail(f"LM-full card vs CPU {key}: {errs[key]}")
    log("  LM-full card vs CPU on the card's pyramid, max|d|/max|ref|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (<= {LMFULL_TOL})")
    return errs


def lmfull_phase(sim, workdir, smi):
    """The LM-full preset at its own shapes (12800 points, 128^2 crops,
    4096 mesh vertices, 128-d features, f32, exact pyramid) on object 1:
    serving (b=8 and b=1), cli eval | infer | score at b=8, cli train at
    b=6 (validating), 15 fixed-batch steps, the card against the CPU on a
    full-width batch of 2, and the kernel alone at its two LM-full
    shapes.  Returns the main-path launches and the kernel-line fields."""
    root, ckpt = osp.join(workdir, "lmfull"), osp.join(workdir, "ckpt")
    t0 = time.perf_counter()
    write_lmfull_tree(root, ckpt)
    log(f"  synthetic LM-full tree ({LMFULL_TEST} test frames and "
        f"{LMFULL_TRAIN} each of real, fuse and renders, 480x640) and "
        f"checkpoint written in {time.perf_counter() - t0:.2f} s")
    n_serve, lat = lmfull_serving(sim, root, ckpt, workdir, smi)
    n_eval, ev = lmfull_eval(sim, root, ckpt, workdir)
    n_train, tr = lmfull_train(sim, root, workdir)
    errs = lmfull_card_vs_cpu(root)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    peaks = (peak_flops(1024, "dense TF32"), peak_flops())
    at = {"serve": time_shape(sim, "LM-full serving and eval shape",
                              LMFULL_SERVE_SHAPE, g, peaks, reps=20),
          "train_val": time_shape(sim, "LM-full train validation shape",
                                  LMFULL_VAL_SHAPE, g, peaks, reps=20)}
    torch.cuda.empty_cache()
    launches = n_serve + n_eval + n_train
    log(f"  {smi}: LM-full eval b=8 peak {ev['peak_gib']:.2f} GiB, train "
        f"b=6 peak {tr['fixed']['peak_gib']:.2f} GiB (fixed batch; cli "
        f"train {tr['cli_peak_gib']:.2f}); similarity launches on the "
        f"LM-full main path {launches} (serving {n_serve}, eval and infer "
        f"{n_eval}, train validation {n_train})")
    return launches, {
        "serve": dict(at["serve"], shape=list(LMFULL_SERVE_SHAPE)),
        "train_val": dict(at["train_val"], shape=list(LMFULL_VAL_SHAPE)),
        "latency": lat, "eval_peak_gib": ev["peak_gib"],
        "train_peak_gib": tr["fixed"]["peak_gib"],
        "card_vs_cpu": errs}


# the train-to-pose demo (gdm_tpu_torch.train_synthetic_demo): its own
# shapes (128^2 crop, 1024 points, 512-vertex mesh, b=8, 300 steps) and
# LM-full's (12800 points, 4096 vertices, b=6, 120 steps), each with the
# demo's 64 train frames.  docs/CONVERGENCE.md's LM-full row trained on
# 12 frames: there DGCNN's seg head calls up to thousands of points of
# the far background foreground in some runs of one seed and few in
# others, and the unweighted Kabsch follows them, so its mean ADD ranged
# over 7.89-136.64 mm on the card; on 64 frames 5.21-8.31 mm
# (scripts/dgcnn_lmfull_seg.py measures both)
LMFULL_DEMO = ["--im", "128", "--n-sample", "12800", "--n-mesh", "4096",
               "--batch", "6", "--steps", "120"]
DGCNN_DEMO = ["--backbone", "dgcnn"]
CONVERGENCE_ROWS = {
    "demo flagship f32": [],
    "demo flagship bf16": ["--bf16"],
    "demo DGCNN f32": DGCNN_DEMO,
    "demo DGCNN bf16": DGCNN_DEMO + ["--bf16"],
    "LM-full flagship f32": LMFULL_DEMO,
    "LM-full flagship bf16": LMFULL_DEMO + ["--bf16"],
    "LM-full DGCNN f32": LMFULL_DEMO + DGCNN_DEMO,
    "LM-full DGCNN bf16": LMFULL_DEMO + DGCNN_DEMO + ["--bf16"],
}
ADD_OF_DIAMETER = 0.1     # a trained row's mean ADD below this x diameter
# epochs of the rehearsal in ``python3 chip_smoke.py convergence``: the
# JAX rehearsal's 60 (2 steps an epoch per object at b=24)
REHEARSAL_EPOCHS = 60


class LaunchChecks:
    """While active, every similarity kernel launch is held against the
    plain argmax on its own inputs (check_argmax; the plain version's
    launches are not counted), from any thread."""

    def __init__(self, sim, tag):
        self.sim, self.tag = sim, tag
        self.n, self.max_abs_err = 0, 0.0
        self.lock = threading.Lock()

    def __enter__(self):
        self.orig = orig = self.sim._launch

        def launch(scene, mesh):
            idx, score = orig(scene, mesh)
            with self.lock:
                err = check_argmax(f"{self.tag} launch {self.n}", idx, score,
                                   scene, mesh)
                self.n += 1
                self.max_abs_err = max(self.max_abs_err, err)
            return idx, score

        self.sim._launch = launch
        return self

    def __exit__(self, *exc):
        self.sim._launch = self.orig


def convergence_row(sim, tag, argv, smi):
    """One train-to-pose demo run (``python -m
    gdm_tpu_torch.train_synthetic_demo`` with ``argv``) on the card, every
    similarity launch held against the plain argmax: its two evaluations
    must launch the kernel once each, and the trained mean ADD must lie
    below ADD_OF_DIAMETER x the object's diameter and at most half the
    untrained one.  Returns (launches, the row's numbers)."""
    from gdm_tpu_torch import train_synthetic_demo as demo

    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    with LaunchChecks(sim, tag) as lc:
        res = demo.run(demo.build_parser().parse_args(argv))
    wall = time.perf_counter() - t0
    launches = sim.cosine_argmax.launches
    row = {k: res[k] for k in (
        "add_before", "add_after", "rot_before", "rot_after", "trans_before",
        "trans_after", "diameter", "steps_per_s", "first_step_s",
        "render_s", "peak_gib")}
    row.update(argv=argv, wall_s=wall, launches=launches,
               max_abs_err=lc.max_abs_err,
               losses=[[round(x, 4) for x in r] for r in res["losses"]])
    log(f"  {smi}: {tag}: ADD {res['add_before'] * 1e3:.2f} -> "
        f"{res['add_after'] * 1e3:.2f} mm (diameter "
        f"{res['diameter'] * 1e3:.2f} mm), rot {res['rot_before']:.2f} -> "
        f"{res['rot_after']:.2f} deg, t {res['trans_before'] * 1e3:.2f} -> "
        f"{res['trans_after'] * 1e3:.2f} mm; {res['steps_per_s']:.2f} "
        f"steps/s after the first ({res['first_step_s']:.2f} s), peak "
        f"{res['peak_gib']:.2f} GiB, render {res['render_s']:.2f} s, wall "
        f"{wall:.2f} s; kernel launches {launches}, each held against the "
        f"plain argmax")
    if launches != 2 or lc.n != launches:
        fail(f"{tag}: {launches} kernel launches, {lc.n} checked (want 2)")
    if not (res["add_after"] < ADD_OF_DIAMETER * res["diameter"]
            and res["add_after"] <= 0.5 * res["add_before"]):
        fail(f"{tag}: trained ADD {res['add_after']} m against untrained "
             f"{res['add_before']} m and diameter {res['diameter']} m")
    return launches, row


def rehearsal_run(sim, workdir, smi):
    """``python -m gdm_tpu_torch.dress_rehearsal`` at its defaults (the JAX
    rehearsal's shapes: 480x640, 256^2 crop, 4096 points and vertices,
    b=24) for REHEARSAL_EPOCHS epochs, every similarity launch held
    against the plain argmax; then the train step's device-only rate on a
    fixed batch of the same tree.  Returns (launches, numbers)."""
    from gdm_tpu_torch import dress_rehearsal
    from gdm_tpu_torch.configs import LMO as cfg

    root = osp.join(workdir, "rehearsal_root")
    args = dress_rehearsal.build_parser().parse_args(
        ["--epochs", str(REHEARSAL_EPOCHS), "--keep-root", root])
    sim.cosine_argmax.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with LaunchChecks(sim, "rehearsal") as lc:
        res = dress_rehearsal.run(args)
    launches = sim.cosine_argmax.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches == 0 or lc.n != launches:
        fail(f"rehearsal: {launches} kernel launches, {lc.n} checked")
    steps = res["train"]["timing"]
    warm = [r for r in steps if r["epoch"] > 0]   # the first epoch warms up
    busy_ms = sum(r["wait_ms"] + r["step_ms"] for r in warm)
    with_decode = len(warm) / busy_ms * 1e3
    fixed = fixed_batch_steps(cfg, root, n_steps=15, falls=False)
    without = fixed["device_sps"] / TRAIN_BATCH
    stages = dict(res["stages"])
    log(f"  {smi}: rehearsal ({REHEARSAL_EPOCHS} epochs, {len(steps)} "
        f"steps of b={TRAIN_BATCH} over 2 objects): train {stages['train']:.1f} "
        f"s; the step loop after the first epoch {with_decode:.2f} steps/s "
        f"with the loader's decode in the window (wait "
        f"{sum(r['wait_ms'] for r in warm):.0f} of {busy_ms:.0f} ms), "
        f"{without:.2f} steps/s on a fixed batch (device only); peak "
        f"{peak:.2f} GiB; kernel launches {launches}, each held against the "
        f"plain argmax; worst cases "
        + ", ".join(f"{k} {v:.3g} (<= {b:g})"
                    for k, (v, b) in res["worst"].items()))
    return launches, {
        "epochs": REHEARSAL_EPOCHS, "stages_s": stages,
        "worst": res["worst"], "steps": len(steps),
        "steps_per_s_with_decode": with_decode,
        "steps_per_s_fixed_batch": without, "peak_gib": peak,
        "fixed_split_ms": fixed["split_ms"], "launches": launches,
        "max_abs_err": lc.max_abs_err,
        "auc": res["eval"]["auc"],
        "bop19_ar": {k: v["bop19_ar"] for k, v in
                     res["eval"].get("bop19_ar", {}).items()}}


PAR_TRAIN_FRAMES, PAR_VAL_FRAMES = 8, 8
PAR_BATCH = 4            # global: 2 rows per data rank, 2 steps an epoch
PAR_EVAL_BATCH = 32      # the sharded eval's (both ranks run its rows)
PAR_LOSS_TOL = 1e-4      # |two ranks - one rank| / |one rank|, first loss
DEVICES_TOL = 1e-6       # cli --devices 2 against --multihost, first losses


class ShardChecks:
    """In a rank of the parallel phase: every similarity launch held
    against the plain argmax of its own inputs (a column shard's, under
    model shards), every merged sharded argmax against the unsharded
    kernel over all columns (that launch is not counted), and the times
    of the launches, of the sharded argmax calls and of the host gathers
    (all synchronised)."""

    def __init__(self, sim, rank):
        from gdm_tpu_torch.eval import infer as infer_mod
        from gdm_tpu_torch.parallel import mesh as pmesh

        self.sim, self.rank = sim, rank
        self.orig_launch = sim._launch
        self.orig_sharded = infer_mod.sharded_cosine_argmax
        self.orig_gather = pmesh.all_gather_host
        self.comparing = False
        self.start("")
        sim._launch = self.launch
        infer_mod.sharded_cosine_argmax = self.sharded
        pmesh.all_gather_host = self.gather

    def start(self, tag):
        self.tag = tag
        self.stats = {"checked": 0, "max_abs_err": 0.0, "kernel_ms": [],
                      "sharded_ms": [], "merged_checked": 0,
                      "merged_err": 0.0, "gather_ms": [], "shapes": set()}

    def launch(self, scene, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, score = self.orig_launch(scene, mesh)
        torch.cuda.synchronize()
        if not self.comparing:
            self.stats["kernel_ms"].append((time.perf_counter() - t0) * 1e3)
            self.stats["shapes"].add((scene.shape[0], mesh.shape[0],
                                      scene.shape[1]))
        what = ("unsharded comparison" if self.comparing else
                f"launch {self.stats['checked']}")
        err = check_argmax(f"rank {self.rank} {self.tag} {what}", idx,
                           score, scene, mesh)
        if not self.comparing:
            self.stats["checked"] += 1
        self.stats["max_abs_err"] = max(self.stats["max_abs_err"], err)
        return idx, score

    def sharded(self, scene_f, mesh_f, grid):
        from gdm_tpu_torch.eval.pose_fit import l2_normalise

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, score = self.orig_sharded(scene_f, mesh_f, grid)
        torch.cuda.synchronize()
        self.stats["sharded_ms"].append((time.perf_counter() - t0) * 1e3)
        # the merged result against the unsharded kernel, all columns
        c = scene_f.shape[-1]
        f = l2_normalise(scene_f).reshape(-1, c).contiguous()
        g = l2_normalise(mesh_f).contiguous()
        n = self.sim.cosine_argmax.launches
        self.comparing = True
        full_idx, full_score = self.sim.cosine_argmax(f, g)
        self.comparing = False
        self.sim.cosine_argmax.launches = n
        err = float((score.reshape(-1) - full_score).abs().max())
        top2 = torch.topk(f @ g.T, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > GAP
        bad = int(((idx.reshape(-1) != full_idx) & sure).sum())
        log(f"  rank {self.rank} {self.tag} merged argmax "
            f"{self.stats['merged_checked']}: {f.shape[0]} rows over "
            f"{g.shape[0]} columns split {grid.model_shards} ways, "
            f"max|dscore| {err:.3g} against the unsharded kernel, index "
            f"mismatches {bad} of {int(sure.sum())} beyond near-ties")
        if err > SCORE_TOL or bad:
            fail(f"rank {self.rank} {self.tag}: merged argmax |dscore| "
                 f"{err}, {bad} index mismatches")
        self.stats["merged_checked"] += 1
        self.stats["merged_err"] = max(self.stats["merged_err"], err)
        return idx, score

    def gather(self, obj, grid):
        t0 = time.perf_counter()
        out = self.orig_gather(obj, grid)
        self.stats["gather_ms"].append((time.perf_counter() - t0) * 1e3)
        return out


def parallel_rank(rank, world, store, backend, runs, out_dir, plain=False):
    """One rank of the parallel phase (a spawned process): joins the
    process group itself, then ``cli.main(argv + ['--multihost'])`` for
    each run ('{rank}' in an argument becomes the rank), TF32 off and
    dropout off in the train runs (so that the first step compares with
    one rank's), or, ``plain``, with both as a user's run has them;
    writes what each run measured to <out_dir>/rank<r>.json."""
    import datetime

    import torch.distributed as dist

    from gdm_tpu_torch import cli
    from gdm_tpu_torch.models.layers import Dropout
    from gdm_tpu_torch.ops import similarity as sim

    if not plain:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = rank if backend == "nccl" else 0
    os.environ["LOCAL_RANK"] = str(card)
    torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    checks = ShardChecks(sim, rank)
    if not plain:
        Dropout.forward = lambda self, x: x
    out = {}
    try:
        for tag, argv in runs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sim.cosine_argmax.launches = 0
            checks.start(tag)
            t0 = time.perf_counter()
            res = cli.main([a.replace("{rank}", str(rank)) for a in argv]
                           + ["--multihost"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = checks.stats
            out[tag] = {
                "wall_s": wall, "launches": sim.cosine_argmax.launches,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "timing": None if res is None else res["timing"],
                **{k: v for k, v in st.items() if k != "shapes"},
                "shapes": sorted(st["shapes"])}
            if st["checked"] != sim.cosine_argmax.launches:
                fail(f"rank {rank} {tag}: {sim.cosine_argmax.launches} "
                     f"launches, {st['checked']} checked")
            dist.barrier()
        with open(osp.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def write_parallel_tree(root):
    """LM-O object 1: PAR_TRAIN_FRAMES JPEG train_pbr and PAR_VAL_FRAMES
    test frames at 480x640."""
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.synthetic import make_object, \
        write_synthetic_bop_root

    fps = make_object(cfg.data.model_pt_num, np.random.RandomState(SEED))
    write_synthetic_bop_root(root, fps, n_frames=PAR_TRAIN_FRAMES,
                             subsets=("train_pbr",), im_hw=cfg.data.img_hw,
                             seed=SEED + 3, obj_id=1)
    write_synthetic_bop_root(root, fps, n_frames=PAR_VAL_FRAMES,
                             subsets=("test",), im_hw=cfg.data.img_hw,
                             seed=SEED + 4, obj_id=1)


def one_rank_first_step(root, n_ranks, order):
    """One process's first train step of ``cli train --batch-size
    PAR_BATCH`` on the rows that ``n_ranks`` data ranks load at step 0
    (each rank's loader slice, augmented with the seed plus its rank),
    concatenated in ``order``: the CLI's model, seeds and schedules,
    dropout off.  Returns the step's losses."""
    from gdm_tpu_torch import cli, refdata, weights
    from gdm_tpu_torch.configs import LMO as cfg
    from gdm_tpu_torch.data.dataset import PoseDataset
    from gdm_tpu_torch.data.loader import DataLoader
    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.models.layers import Dropout
    from gdm_tpu_torch.train.schedules import bn_momentum_schedule, \
        cyclic_lr
    from gdm_tpu_torch.train.state import create_train_state
    from gdm_tpu_torch.train.step import make_train_step

    sol = cfg.solver
    fps = load_or_build_fps_mesh(root, 1, cfg.data.model_pt_num)
    diameter = refdata.get("lmo").diameters_mm_by_id[1] / 1000.0
    parts, steps = [], 0
    for r in range(n_ranks):
        ds = PoseDataset(cfg, 1, "train", mesh_fps=fps, data_root=root,
                         rng=np.random.RandomState(SEED + r),
                         diameter_m=diameter)
        dl = DataLoader(ds, PAR_BATCH // n_ranks, shuffle=True,
                        drop_last=True, num_workers=4, seed=SEED, rank=r,
                        world=n_ranks)
        dl.set_epoch(0)
        steps = len(dl)
        parts.append(next(iter(dl))[0])
    batch = {k: np.concatenate([parts[r][k] for r in order])
             for k in parts[0]}
    model, mesh, _, _ = build_model(cfg, cli._fps_mm(fps), "cuda", awl=True)
    weights.init_random_(model, torch.Generator().manual_seed(SEED + 1))
    model.to("cuda")
    lr = cyclic_lr(sol.base_lr, sol.max_lr, max(steps // sol.clr_div, 1))
    state = create_train_state(model, lr, sol.weight_decay,
                               sol.skip_nonfinite)
    step = make_train_step(
        bn_momentum_schedule(sol.bn_momentum, sol.bn_decay,
                             sol.bn_decay_step, PAR_BATCH,
                             sol.bn_momentum_clip),
        cfg.model.neighbor_dis_th * diameter)
    forward = Dropout.forward
    Dropout.forward = lambda self, x: x
    try:
        m = step(state, batch, mesh, SEED + 8)
    finally:
        Dropout.forward = forward
    return {k: float(m[k]) for k in ("loss", "seg_loss", "match_loss")}


def first_logged_step(ckpt_root):
    rows = [json.loads(line) for line in open(
        osp.join(ckpt_root, "metrics", "ape.jsonl"))]
    return next(r for r in rows if r.get("it") == 0 and "loss" in r)


def hold_first_step(tag, ckpt_root, root, n_ranks):
    """The logged first step of a multi-rank run against one process's
    step on the same rows: the loss within PAR_LOSS_TOL; the seg and
    matching losses printed beside the spread of the one-process step
    itself when the data ranks' rows are swapped (its batch norms then
    sum in another order)."""
    got = first_logged_step(ckpt_root)
    ref = one_rank_first_step(root, n_ranks, range(n_ranks))
    swapped = (one_rank_first_step(root, n_ranks, range(n_ranks)[::-1])
               if n_ranks > 1 else ref)
    for k, want in ref.items():
        rel_d = abs(got[k] - want) / abs(want)
        spread = abs(swapped[k] - want) / abs(want)
        log(f"  {tag} first step {k}: {got[k]:.6f} against one process's "
            f"{want:.6f} on the same rows (relative {rel_d:.3g}; the one "
            f"process's own spread under swapped rows {spread:.3g})")
        if not np.isfinite(got[k]):
            fail(f"{tag}: {k} {got[k]}")
    rel_d = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if rel_d > PAR_LOSS_TOL:
        fail(f"{tag}: first loss {got['loss']} against one process's "
             f"{ref['loss']} (relative {rel_d:.3g} > {PAR_LOSS_TOL})")
    return rel_d


def spawn_ranks(world, backend, runs, out_dir, plain=False):
    """``runs`` on ``world`` spawned parallel_rank processes; returns what
    each rank wrote."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(parallel_rank, args=(
            world, osp.join(d, "store"), backend, runs, out_dir, plain),
            nprocs=world, start_method="spawn")
    ranks = []
    for r in range(world):
        with open(osp.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def parallel_runs(backend, world, root, eval_root, ckpt, base):
    """The parallel phase's runs on ``world`` ranks over ``backend``
    (gloo: all on card 0; nccl: rank r on card r), spawned here, each
    joining the group itself (parallel_rank), and their checks.  Returns
    (launches, first-step relative differences, the ranks' results)."""
    shards = 2
    n_data, n_data_sp = world, world // shards
    device = "cuda:0" if backend == "gloo" else "cuda"
    train = ["train", "--dataset", "lmo", "--data-root", root, "--cls-id",
             "1", "--batch-size", str(PAR_BATCH), "--num-workers", "4",
             "--opt", "solver.checkpoint_every_epochs=1", "--device",
             device]
    r0 = osp.join(base, "r0")
    runs = [
        ("train", train + ["--epochs", "1", "--ckpt-root",
                           osp.join(base, "r{rank}")]),
        ("resume", train + ["--epochs", "2", "--resume", "--ckpt-root",
                            r0]),
        ("eval", ["eval", "--dataset", "lmo", "--data-root", root,
                  "--torch-checkpoint", osp.join(r0, "checkpoints"),
                  "--cls-id", "1", "--exact-knn", "--batch-size",
                  str(PAR_BATCH), "--output-dir", osp.join(base, "eval"),
                  "--device", device]),
        ("train_sharded", train + ["--epochs", "1", "--ckpt-root",
                                   osp.join(base, "s"), "--model-shards",
                                   str(shards)]),
        ("eval_sharded", ["eval", "--dataset", "lmo", "--data-root",
                          eval_root, "--torch-checkpoint", ckpt,
                          "--cls-id", "1", "--exact-knn", "--batch-size",
                          str(PAR_EVAL_BATCH), "--output-dir",
                          osp.join(base, "eval_sharded"), "--device",
                          device, "--model-shards", str(shards)])]
    out_dir = osp.join(base, "out")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    log(f"  backend {backend}: {world} ranks on "
        + ("cuda:0" if backend == "gloo" else f"cuda:0..{world - 1}")
        + " (spawned; each joins the group through a file store, then "
        "cli.main(... --multihost))")
    ranks = spawn_ranks(world, backend, runs, out_dir)
    log(f"  the {world} ranks ran in {time.perf_counter() - t0:.2f} s "
        "(start-up included)")

    # files: rank 0 alone writes; the resume continued rank 0's
    ck = sorted(os.listdir(osp.join(r0, "checkpoints", "ape")))
    others = [r for r in range(1, world)
              if osp.exists(osp.join(base, f"r{r}"))]
    if others or "epoch_0001" not in ck:
        fail(f"{backend}: ranks {others} wrote a --ckpt-root, or the resume "
             f"wrote no epoch 1: {ck}")
    log(f"  rank 0 alone wrote checkpoints ({ck}) and metrics; the other "
        "ranks' --ckpt-root stay empty")
    for r in ranks:
        if {t["epoch"] for t in r["resume"]["timing"]} != {1}:
            fail("the resume did not continue from epoch 0 on every rank")
    eval_rows = read_csv_poses(osp.join(base, "eval", "gt_lmo-test.csv"))
    sharded_rows = read_csv_poses(osp.join(base, "eval_sharded",
                                           "gt_lmo-test.csv"))
    if len(eval_rows) != PAR_VAL_FRAMES or len(sharded_rows) != EVAL_FRAMES:
        fail(f"gathered eval rows {len(eval_rows)}, sharded "
             f"{len(sharded_rows)}")
    for p in sharded_rows.values():
        if not np.isfinite(p).all():
            fail("sharded eval: a non-finite pose")
    log(f"  gathered evaluator: {len(eval_rows)} CSV rows (rank 0); sharded "
        f"eval: {len(sharded_rows)} rows")
    rel = [hold_first_step(f"{backend} data-parallel train", r0, root,
                           n_data),
           hold_first_step(f"{backend} model-sharded train",
                           osp.join(base, "s"), root, n_data_sp)]

    # per rank: launches, checks, times, memory
    launches = 0
    for tag, n_rows in (("train", n_data), ("resume", n_data),
                        ("train_sharded", n_data_sp)):
        rows = PAR_BATCH * len(ranks[0][tag]["timing"])
        wall = max(res[tag]["wall_s"] for res in ranks)
        log(f"  {tag}: {rows} samples over {world} ranks ({n_rows} data "
            f"ranks) in {wall:.2f} s, {rows / wall:.2f} samples/s in all end "
            "to end (model set-up included)")
    for r, res in enumerate(ranks):
        for tag, st in res.items():
            launches += st["launches"]
            steps = [t for t in (st["timing"] or []) if "step_ms" in t]
            line = (f"  rank {r} {tag}: {st['wall_s']:.2f} s, peak "
                    f"{st['peak_gib']:.2f} GiB, launches {st['launches']} "
                    f"(all held against the plain argmax of their inputs, "
                    f"max|dscore| {st['max_abs_err']:.3g})")
            if steps:
                ms = np.array([t["step_ms"] for t in steps])
                rows = PAR_BATCH // (n_data_sp if "sharded" in tag
                                     else n_data)
                line += (f"; {len(steps)} steps, step ms {ms.round(2)}, "
                         f"{len(steps) * rows / st['wall_s']:.2f} samples/s "
                         f"this rank end to end")
            if st["sharded_ms"]:
                kern = np.median(st["kernel_ms"])
                shd = np.median(st["sharded_ms"])
                line += (f"; sharded argmax median {shd:.3f} ms of which the "
                         f"shard's kernel {kern:.3f} ms (merge, normalise "
                         f"and slice {shd - kern:.3f} ms) at "
                         f"{st['shapes']}; merged results checked "
                         f"{st['merged_checked']}, max|dscore| "
                         f"{st['merged_err']:.3g}")
            if st["gather_ms"]:
                line += f"; host gather {np.round(st['gather_ms'], 2)} ms"
            if tag.startswith("eval") and st["timing"]:
                dev = [t["device_ms"] for t in st["timing"]]
                line += (f"; per-batch device ms {np.round(dev, 2)}")
            log(line)
        if res["eval_sharded"]["launches"] != \
                res["eval_sharded"]["merged_checked"]:
            fail(f"rank {r}: sharded eval launches "
                 f"{res['eval_sharded']['launches']}, merged checks "
                 f"{res['eval_sharded']['merged_checked']}")
        for tag in ("eval", "eval_sharded"):
            if res[tag]["launches"] == 0:
                fail(f"rank {r} {tag}: no similarity launch")
    return launches, rel, ranks


def lmfull_sharded_train(workdir):
    """``cli train --dataset lmfull --model-shards 2`` at b=6 on two NCCL
    ranks (cards 0 and 1; each rank holds 2048 of the 4096 mesh columns
    and all 6 rows) for one epoch of 2 steps, beside the same command on
    one card in this process: finite losses, and each rank's peak device
    memory printed beside the one card's.  Returns the peaks (GiB)."""
    import json as _json

    from gdm_tpu_torch import cli

    root, ckpt = osp.join(workdir, "lmfull_sp"), osp.join(workdir, "ck_sp")
    write_lmfull_tree(root, ckpt, n_test=8, n_train=4)   # 12 records
    train = ["train", "--dataset", "lmfull", "--data-root", root,
             "--cls-id", "1", "--epochs", "1", "--num-workers", "4"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_root = osp.join(workdir, "lmfull_one")
    res = cli.main(train + ["--ckpt-root", one_root])
    one = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "step_ms": [t["step_ms"] for t in res["timing"]]}
    torch.cuda.empty_cache()                 # rank 0 shares card 0
    out_dir = osp.join(workdir, "lmfull_sp_out")
    os.makedirs(out_dir)
    sp_root = osp.join(workdir, "lmfull_sp_log")
    ranks = spawn_ranks(2, "nccl", [("lmfull_sharded", train + [
        "--ckpt-root", sp_root, "--model-shards", "2", "--device",
        "cuda"])], out_dir)
    losses = [_json.loads(line)["loss"] for line in open(osp.join(
        sp_root, "metrics", "ape.jsonl")) if '"loss"' in line]
    peaks = [r["lmfull_sharded"]["peak_gib"] for r in ranks]
    steps = [len(r["lmfull_sharded"]["timing"]) for r in ranks]
    log(f"  LM-full cli train --model-shards 2 at b=6 on 2 NCCL ranks: "
        f"steps per rank {steps}, step ms "
        + ", ".join(str(np.round([t["step_ms"] for t in r["lmfull_sharded"]
                                  ["timing"]], 2).tolist()) for r in ranks)
        + f", logged losses {[round(x, 4) for x in losses]}; peak device "
        f"memory per rank {np.round(peaks, 2).tolist()} GiB beside "
        f"{one['peak_gib']:.2f} GiB on one card (step ms "
        f"{np.round(one['step_ms'], 2).tolist()})")
    if steps != [2, 2] or len(losses) == 0 or not np.isfinite(losses).all():
        fail(f"LM-full sharded train: steps {steps}, losses {losses}")
    return {"ranks_peak_gib": peaks, "one_card_peak_gib": one["peak_gib"]}


def cli_devices_check(root, workdir):
    """``cli train --devices 2`` through the CLI's own spawn (NCCL, cuda:0
    and cuda:1), run as a user runs it (dropout on, torch's TF32
    defaults), against the same command as two ``--multihost`` ranks
    spawned here with the same seeds (parallel_rank, ``plain``): the
    ranks draw the same dropout masks and augmentations, so the first
    logged losses must agree within DEVICES_TOL (the runs before it hold
    the --multihost ranks against one process).  Also held: the parent
    returns no result and rank 0 alone wrote the checkpoint and metrics.
    The two checkpoints' largest parameter difference is printed (the
    backward's atomics may round differently).  Returns the largest
    relative first-loss difference."""
    from gdm_tpu_torch import cli
    from gdm_tpu_torch.train.checkpoint import checkpoint_file

    def argv(ckpt_root):
        return ["train", "--dataset", "lmo", "--data-root", root,
                "--cls-id", "1", "--batch-size", str(PAR_BATCH), "--epochs",
                "1", "--ckpt-root", ckpt_root, "--num-workers", "4"]

    devices = osp.join(workdir, "devices_train")
    t0 = time.perf_counter()
    if cli.main(argv(devices) + ["--devices", "2"]) is not None:
        fail("cli train --devices 2 returned a result in the parent")
    t_dev = time.perf_counter() - t0
    out_dir = osp.join(workdir, "devices_ref_out")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    spawn_ranks(2, "nccl", [("train", argv(osp.join(workdir,
                                                    "devices_ref{rank}")))],
                out_dir, plain=True)
    t_ref = time.perf_counter() - t0
    ref_root = osp.join(workdir, "devices_ref0")
    if osp.exists(osp.join(workdir, "devices_ref1")):
        fail("--multihost rank 1 wrote a --ckpt-root")
    got, want = first_logged_step(devices), first_logged_step(ref_root)
    worst = 0.0
    for k in ("loss", "seg_loss", "match_loss"):
        if not np.isfinite(got[k]):
            fail(f"cli train --devices 2: {k} {got[k]}")
        d = abs(got[k] - want[k]) / abs(want[k])
        worst = max(worst, d)
        log(f"  cli train --devices 2 first {k} {got[k]!r} against "
            f"--multihost's {want[k]!r} (relative {d:.3g})")
    if worst > DEVICES_TOL:
        fail(f"cli train --devices 2: first losses {worst:.3g} off the "
             f"--multihost ranks' (> {DEVICES_TOL})")
    blobs = [torch.load(checkpoint_file(osp.join(r, "checkpoints", "ape")),
                        weights_only=True, map_location="cpu")
             for r in (devices, ref_root)]
    if blobs[0]["step"] != blobs[1]["step"]:
        fail(f"steps {blobs[0]['step']} and {blobs[1]['step']}")
    diff = max(float((v.double() - blobs[1]["model_state"][k].double())
                     .abs().max())
               for k, v in blobs[0]["model_state"].items()
               if v.is_floating_point())
    log(f"  cli train --devices 2 (NCCL, spawned by the CLI) in {t_dev:.2f} "
        f"s, the --multihost ranks in {t_ref:.2f} s: {blobs[0]['step']} "
        f"steps each, checkpoints' largest |dparameter| {diff:.3g}")
    return worst


def run_dryrun(n_cards):
    """``gdm_tpu_torch.dryrun`` on min(cards, 4) cards over NCCL."""
    from gdm_tpu_torch import dryrun

    n = min(n_cards, 4)
    t0 = time.perf_counter()
    dryrun.dryrun(n, "cuda")
    log(f"  dryrun on {n} card(s) over NCCL in "
        f"{time.perf_counter() - t0:.2f} s")
    return n


def parallel_phase(sim, eval_dir, workdir, smi):
    """The runs of parallel_runs on two gloo ranks sharing card 0, then,
    with two or more cards, on min(cards, 4) NCCL ranks and cli train
    --devices 2; the dry runs; the sharded launch alone timed at its
    shape beside its bound.  Returns (launches, kernel-line fields)."""
    import gc

    from gdm_tpu_torch.data.ply import load_or_build_fps_mesh

    gc.collect()
    torch.cuda.empty_cache()        # the ranks share card 0 with this one
    log(f"  this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
        "GiB of card 0")
    root = osp.join(workdir, "lmo_par")
    t0 = time.perf_counter()
    write_parallel_tree(root)
    load_or_build_fps_mesh(root, 1, 4096)      # once, before the ranks
    log(f"  tree ({PAR_TRAIN_FRAMES} JPEG train_pbr + {PAR_VAL_FRAMES} test "
        f"frames) written in {time.perf_counter() - t0:.2f} s")
    eval_root, ckpt = osp.join(eval_dir, "lmo"), osp.join(eval_dir, "ckpt")
    launches, rel, _ = parallel_runs("gloo", 2, root, eval_root, ckpt,
                                     osp.join(workdir, "gloo"))
    out = {"first_step_rel": rel}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        world = min(n_cards, 4)
        n, rel, _ = parallel_runs("nccl", world, root, eval_root, ckpt,
                                  osp.join(workdir, "nccl"))
        launches += n
        out["nccl"] = {"ranks": world, "first_step_rel": rel,
                       "cli_devices_rel": cli_devices_check(root, workdir),
                       "lmfull_sharded": lmfull_sharded_train(workdir)}
    else:
        log(f"  {n_cards} card: the NCCL runs need two and did not run")
    out["dryrun_cards"] = run_dryrun(n_cards)

    # the sharded launch alone, at its shape, beside the bound
    g = torch.Generator(device="cuda").manual_seed(SEED)
    r, m, c = PAR_EVAL_BATCH * 4096, 2048, 128
    peaks = (peak_flops(1024, "dense TF32"), peak_flops())
    scene, mesh = unit_rows(r, c, g), unit_rows(m, c, g)
    n = sim.cosine_argmax.launches
    ms = median_ms(sim.cosine_argmax, scene, mesh, reps=10)
    plain_ms = median_ms(sim.cosine_argmax_reference, scene, mesh, reps=10)
    sim.cosine_argmax.launches = n
    bms, by, _ = bound_ms((r, m, c), *peaks)
    log(f"  sharded launch shape [{r},{c}]x[{m},{c}]: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{100 * bms / ms:.1f}% of it ({smi})")
    return launches, dict(out, shard_shape=[r, m, c], shard_ms=ms,
                          shard_plain_ms=plain_ms, shard_bound_ms=bms)


# ---------------------------------------------------------------- surface

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
SURFACE_FILL_TOL = 1e-6   # depth fill, card against CPU, x max_depth
SURFACE_NEAR = 1e-6    # squared-distance gap of a near-tie (f32 expanded)


def adam7_png(path, img, orient=None):
    """Write 8-bit RGB [H, W, 3] or 16-bit gray [H, W] as an interlaced
    PNG (Adam7, every row filter 0), with an ``eXIf`` chunk holding the
    EXIF orientation ``orient`` (a little-endian TIFF block) if given."""
    import struct
    import zlib

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    h, w = img.shape[:2]
    depth, color_type = (16, 0) if img.dtype == np.uint16 else (8, 2)
    body = []
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            rows = (sub.astype(">u2") if depth == 16 else sub).reshape(
                sub.shape[0], -1).view(np.uint8)
            body.append(np.concatenate(
                [np.zeros((rows.shape[0], 1), np.uint8), rows], 1).tobytes())
    exif = b"" if orient is None else chunk(b"eXIf", b"II*\0" + struct.pack(
        "<IHHHIHHI", 8, 1, 0x0112, 3, 1, orient, 0, 0))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, color_type, 0, 0, 1)) + exif
            + chunk(b"IDAT", zlib.compress(b"".join(body), 1))
            + chunk(b"IEND", b""))


def stored_for(img, orient):
    """The array to store under EXIF ``orient`` so that a reader that
    applies the tag shows ``img`` (the tag's inverse, written with
    rot90 and flips rather than the port's exif module)."""
    return {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
            5: img.swapaxes(0, 1), 6: np.rot90(img, 1),
            7: img.swapaxes(0, 1)[::-1, ::-1], 8: np.rot90(img, -1)}[orient]


def csv_rows(path):
    """A BOP results CSV's rows without the time column."""
    with open(path) as f:
        return [line.strip().split(",")[:6] for line in f.readlines()[1:]]


def surface_fixtures():
    """Every file of tests/data/imio/ through the port's readers, each
    read flag's array to the sha256 that cv2 gave (manifest.json)."""
    import hashlib

    from gdm_tpu_torch.data import imio

    fixtures = osp.join(ROOT, "tests", "data", "imio")
    with open(osp.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    t0 = time.perf_counter()
    for name, flags in sorted(manifest.items()):
        for mode, want in flags.items():
            a = np.ascontiguousarray(imio.imread(osp.join(fixtures, name),
                                                 mode))
            got = [list(a.shape), str(a.dtype),
                   hashlib.sha256(a.tobytes()).hexdigest()]
            if got != [want["shape"], want["dtype"], want["sha256"]]:
                fail(f"surface: {name} read {mode} gives {got[:2]} "
                     f"{got[2][:12]}, cv2 gave {want['shape']} "
                     f"{want['dtype']} {want['sha256'][:12]}")
    log(f"  {len(manifest)} fixture files (progressive JPEG, Adam7 PNG, "
        f"EXIF, PNG gamma) x 3 read flags decoded to cv2's sha256 in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return len(manifest)


def surface_tree(eval_dir, workdir):
    """A copy of the eval tree whose ``test`` rgb PNGs are Adam7 with an
    eXIf orientation (1-8 in turn, the pixels stored pre-rotated) and
    whose depth PNGs are Adam7 without one (IMREAD_UNCHANGED ignores
    it); each rewritten file decodes to the original's array."""
    import glob
    import shutil

    from gdm_tpu_torch.data.imio import imread_rgb, imread_u16

    root = osp.join(workdir, "lmo")
    shutil.copytree(osp.join(eval_dir, "lmo"), root)
    t0 = time.perf_counter()
    rgbs = sorted(glob.glob(osp.join(root, "test", "*", "rgb", "*.png")))
    depths = sorted(glob.glob(osp.join(root, "test", "*", "depth", "*.png")))
    for i, path in enumerate(rgbs):
        img, orient = imread_rgb(path), 1 + i % 8
        adam7_png(path, np.ascontiguousarray(stored_for(img, orient)),
                  orient)
        if not np.array_equal(imread_rgb(path), img):
            fail(f"surface: {path} (Adam7, orientation {orient}) does not "
                 "decode to the frame written")
    for path in depths:
        dep = imread_u16(path)
        adam7_png(path, dep)
        if not np.array_equal(imread_u16(path), dep):
            fail(f"surface: {path} (Adam7 depth) does not decode")
    log(f"  tree copied: {len(rgbs)} rgb PNGs rewritten as Adam7 with EXIF "
        f"orientations 1-8, {len(depths)} depth PNGs as Adam7, each read "
        f"back equal, in {time.perf_counter() - t0:.2f} s")
    return root


def near_tie_rows(tag, got, want, d2, radius=None):
    """Rows of index arrays [m, k] that differ; each differing pick must
    be a near-tie in the float64 squared distances d2 [m, n] (or, with a
    radius, lie within SURFACE_NEAR of the radius squared)."""
    rows = np.nonzero((got != want).any(-1))[0]
    for r in rows:
        dg, dw = d2[r, got[r]], d2[r, want[r]]
        ok = (got[r] == want[r]) | (np.abs(dg - dw) <= SURFACE_NEAR)
        if radius is not None:
            ok |= (np.abs(dg - radius ** 2) <= SURFACE_NEAR) | (
                np.abs(dw - radius ** 2) <= SURFACE_NEAR)
        if not ok.all():
            fail(f"surface: {tag} row {r} differs beyond near-ties")
    if len(rows) > max(1, len(got) // 100):
        fail(f"surface: {tag} differs on {len(rows)} of {len(got)} rows")
    return len(rows)


def cpu_ms(fn, *args, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def surface_ops(root, smi_line):
    """The device depth fill (ops/depth_fill) on a 480x640 depth frame of
    the eval tree with dropouts, and farthest point sampling (n 4096, m
    1024), ball_query (1024 centres, k 16) and three_nn_interpolate (1024
    sources of 128 features onto 4096 points) on a seeded 0.1 m cloud:
    each on the card against the same call on the CPU, and timed."""
    import glob

    from gdm_tpu_torch.data.imio import imread_u16
    from gdm_tpu_torch.ops import depth_fill, pointops

    dep = imread_u16(sorted(glob.glob(osp.join(
        root, "test", "*", "depth", "*.png")))[0]).astype(np.float32) * 1e-4
    rng = np.random.RandomState(SEED)
    dep[rng.rand(*dep.shape) < 0.3] = 0.0
    out = {}
    d_cpu = torch.from_numpy(dep)
    d_gpu = d_cpu.cuda()
    for name, fn, max_depth in (
            ("fill_in_fast", depth_fill.fill_in_fast, 10.0),
            ("fill_in_multiscale", depth_fill.fill_in_multiscale, 3.0)):
        def call(d, fn=fn, max_depth=max_depth):
            return fn(d, max_depth=max_depth)
        want, got = call(d_cpu), call(d_gpu).cpu()
        # the fills filter max_depth - depth and invert back, so f32
        # rounding scales with max_depth, not with the depth
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        if not torch.isfinite(got).all() or err > SURFACE_FILL_TOL * max_depth:
            fail(f"surface: {name} card vs CPU: max |d| {err} m > "
                 f"{SURFACE_FILL_TOL} x max_depth {max_depth}")
        out[name] = {"ms": median_ms(call, d_gpu, reps=5, warmup=1),
                     "cpu_ms": cpu_ms(call, d_cpu), "max_abs_err": err,
                     "max_rel_err": rel, "max_depth": max_depth,
                     "shape": list(dep.shape)}
    xyz = (rng.rand(4096, 3) * 0.1).astype(np.float32)
    x_cpu = torch.from_numpy(xyz)
    x_gpu = x_cpu.cuda()
    fps = pointops.farthest_point_sample(x_gpu, 1024)
    fps_cpu = pointops.farthest_point_sample(x_cpu, 1024)
    if not torch.equal(fps.cpu(), fps_cpu):
        fail("surface: farthest_point_sample card vs CPU indices differ")
    out["farthest_point_sample"] = {
        "ms": median_ms(pointops.farthest_point_sample, x_gpu, 1024, reps=3,
                        warmup=1),
        "cpu_ms": cpu_ms(pointops.farthest_point_sample, x_cpu, 1024),
        "n": 4096, "m": 1024}
    cen = xyz[fps_cpu.numpy()]
    d2 = ((cen.astype(np.float64)[:, None] - xyz[None]) ** 2).sum(-1)
    c_cpu, c_gpu = torch.from_numpy(cen), torch.from_numpy(cen).cuda()
    radius, k = 0.01, 16
    bq = pointops.ball_query(x_gpu, c_gpu, radius, k).cpu().numpy()
    bq_cpu = pointops.ball_query(x_cpu, c_cpu, radius, k).numpy()
    flips = near_tie_rows("ball_query", bq, bq_cpu, d2, radius)
    out["ball_query"] = {
        "ms": median_ms(pointops.ball_query, x_gpu, c_gpu, radius, k),
        "cpu_ms": cpu_ms(pointops.ball_query, x_cpu, c_cpu, radius, k),
        "near_tie_rows": flips, "m": 1024, "n": 4096, "k": k,
        "radius": radius}
    feats = torch.from_numpy(rng.randn(1024, 128).astype(np.float32))
    f_gpu = feats.cuda()
    got = pointops.three_nn_interpolate(c_gpu, f_gpu, x_gpu).cpu()
    want = pointops.three_nn_interpolate(c_cpu, feats, x_cpu)
    from gdm_tpu_torch.ops.knn import knn
    nn_g = knn(c_gpu[None], x_gpu[None], 3)[0].cpu().numpy()
    nn_c = knn(c_cpu[None], x_cpu[None], 3)[0].numpy()
    d2x = ((xyz.astype(np.float64)[:, None] - cen[None]) ** 2).sum(-1)
    flips3 = near_tie_rows("three_nn_interpolate's neighbours", nn_g, nn_c,
                           d2x)
    same = torch.from_numpy((nn_g == nn_c).all(-1))
    err = float((got - want)[same].abs().max())
    if err > 1e-6 * float(want.abs().max()):
        fail(f"surface: three_nn_interpolate card vs CPU {err}")
    out["three_nn_interpolate"] = {
        "ms": median_ms(pointops.three_nn_interpolate, c_gpu, f_gpu, x_gpu),
        "cpu_ms": cpu_ms(pointops.three_nn_interpolate, c_cpu, feats, x_cpu),
        "max_abs_err": err, "near_tie_rows": flips3, "src": 1024,
        "dst": 4096, "c": 128}
    for name, r in out.items():
        log(f"  {name}: card {r['ms']:.3f} ms, CPU {r['cpu_ms']:.3f} ms "
            f"({smi_line})")
    from gdm_tpu_torch import native

    q = xyz[:1024] + np.float32(1e-3)
    idx, dist = native.knn(xyz, q, 16, return_dist=True)
    idx_p, dist_p = native.knn_plain(xyz, q, 16, return_dist=True)
    sub, sub_p = native.grid_subsample(xyz, 0.005), \
        native.grid_subsample_plain(xyz, 0.005)
    if not (np.array_equal(idx, idx_p) and np.array_equal(dist, dist_p)
            and np.array_equal(sub, sub_p)):
        fail("surface: gdm_tpu_torch.native differs from its plain version")
    out["native"] = {"knn_ms": cpu_ms(native.knn, xyz, q, 16),
                     "grid_subsample_ms": cpu_ms(native.grid_subsample, xyz,
                                                 0.005),
                     "voxels": len(sub)}
    log(f"  native (host): knn 4096 x 1024 queries k 16 "
        f"{out['native']['knn_ms']:.3f} ms, grid_subsample of 4096 points "
        f"to {len(sub)} voxels {out['native']['grid_subsample_ms']:.3f} ms, "
        "both equal to their plain versions")
    return out


def surface_phase(sim, eval_dir, eval_rows, workdir, smi_line):
    """The file forms and modules that close the port's surface: the
    committed fixtures to cv2's hashes, ``cli eval`` at the eval batch on
    an Adam7 + EXIF copy of the eval tree (the eval phase's CSV rows
    exactly, every batch held against the plain argmax), and the depth
    fill and pointops card against CPU."""
    from gdm_tpu_torch import cli

    n_files = surface_fixtures()
    root = surface_tree(eval_dir, workdir)
    out = osp.join(workdir, "out")
    sim.cosine_argmax.launches = 0
    t0 = time.perf_counter()
    with FitChecks(sim, "surface eval") as checks:
        res = cli.main(["eval", "--dataset", "lmo", "--data-root", root,
                        "--torch-checkpoint", osp.join(eval_dir, "ckpt"),
                        "--cls-id", "1", "--exact-knn", "--num-workers", "8",
                        "--output-dir", out])
    wall = time.perf_counter() - t0
    launches = sim.cosine_argmax.launches
    if launches != len(res["timing"]) + 1 or checks.n != launches:
        fail(f"surface eval: {launches} launches, {checks.n} checked, for "
             f"{len(res['timing'])} batches + the warm-up")
    rows = csv_rows(osp.join(out, "gt_lmo-test.csv"))
    if rows != eval_rows:
        n_diff = sum(a != b for a, b in zip(rows, eval_rows))
        fail(f"surface eval: {n_diff} CSV rows of {len(rows)} differ from "
             f"the eval phase's ({len(eval_rows)} rows)")
    log(f"  cli eval of the Adam7 + EXIF tree: {len(rows)} CSV rows equal "
        f"to the eval phase's, {launches} launches each held against the "
        f"plain argmax, {wall:.2f} s end to end")
    ops = surface_ops(root, smi_line)
    return launches, {"fixtures": n_files, "eval_rows": len(rows),
                      "eval_s": wall, "ops": ops}


def surface_alone(sim, smi_line):
    """``python3 chip_smoke.py surface``: the eval tree, its ``cli eval``
    for the reference rows, then the surface phase alone."""
    from gdm_tpu_torch import cli

    log("surface phase")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as eval_dir, \
            tempfile.TemporaryDirectory() as workdir:
        write_eval_tree(eval_dir)
        cli.main(["eval", "--dataset", "lmo", "--data-root",
                  osp.join(eval_dir, "lmo"), "--torch-checkpoint",
                  osp.join(eval_dir, "ckpt"), "--cls-id", "1",
                  "--exact-knn", "--num-workers", "8", "--output-dir",
                  osp.join(eval_dir, "out")])
        phase("surface")
        with tempfile.TemporaryDirectory() as workdir:
            launches_surface, surface = surface_phase(
                sim, eval_dir, csv_rows(osp.join(eval_dir, "out",
                                                 "gt_lmo-test.csv")),
                workdir, smi_line)
        t1 = time.perf_counter()
        launches, res = surface_phase(sim, eval_dir, eval_rows, workdir,
                                      smi_line)
        log(f"  surface phase alone {time.perf_counter() - t1:.1f} s")
    log(f"  phase wall time {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"surface": dict(res, launches=launches)}))
    log(smi_line)
    ok_line()
    return 0


def ok_line():
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def parallel_alone(sim, smi_line):
    """``python3 chip_smoke.py parallel``: the eval tree, then the parallel
    phase alone (with four cards, its NCCL runs on four ranks)."""
    log("parallel phase")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as eval_dir, \
            tempfile.TemporaryDirectory() as workdir:
        write_eval_tree(eval_dir)
        launches, par = parallel_phase(sim, eval_dir, workdir, smi_line)
    log(f"  phase wall time {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"parallel": dict(par, launches=launches)}))
    log(smi_line)
    ok_line()
    return 0


def lmfull_alone(sim, smi_line):
    """``python3 chip_smoke.py lmfull``: the LM-full phase alone."""
    log("lmfull phase")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches, lm = lmfull_phase(sim, workdir, smi_line)
    log(f"  phase wall time {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"lmfull": dict(lm, launches_lmfull=launches)}))
    log(smi_line)
    ok_line()
    return 0


def convergence_alone(sim, smi_line):
    """``python3 chip_smoke.py convergence``: every row of
    CONVERGENCE_ROWS, then the dress rehearsal.  A failed row is reported
    and the others still run; the run fails at the end if any did."""
    log("convergence phase")
    t0 = time.perf_counter()
    rows, failed = {}, []
    for tag, argv in CONVERGENCE_ROWS.items():
        try:
            _, rows[tag] = convergence_row(sim, tag, argv, smi_line)
        except (SystemExit, Exception) as e:      # report, run the rest
            log(f"  {tag} FAILED: {e!r}")
            failed.append(tag)
        torch.cuda.empty_cache()
    log(f"  matrix wall time {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        _, rehearsal = rehearsal_run(sim, workdir, smi_line)
    log(f"  phase wall time {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"convergence": rows, "rehearsal": rehearsal},
                   default=float))
    if failed:
        fail(f"convergence rows failed: {failed}")
    log(smi_line)
    ok_line()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["parallel"], ["lmfull"], ["convergence"],
                    ["surface"]):
        print("usage: python3 chip_smoke.py [parallel | lmfull | "
              "convergence | surface]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    log(smi_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    log(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    from gdm_tpu_torch import _build
    from gdm_tpu_torch.ops import similarity as sim

    t0 = time.perf_counter()
    secs = _build.build_all(["similarity", "render_depth", "png_unfilter",
                             "radius_nn", "jpeg", "depth_fill", "native"])
    log(f"builds, all at once, in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for name in ("similarity", "render_depth"):
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line or "wgmma" in line:
                log(f"  ptxas ({name}): {line.strip()}")

    t_phase = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        log(f"  phase wall time {now - t_phase[0]:.1f} s")
        t_phase[0] = now
        log(f"{name} phase")

    if argv == ["parallel"]:
        return parallel_alone(sim, smi_line)
    if argv == ["lmfull"]:
        return lmfull_alone(sim, smi_line)
    if argv == ["convergence"]:
        return convergence_alone(sim, smi_line)
    if argv == ["surface"]:
        return surface_alone(sim, smi_line)
    log("kernel phase")
    err, at, n_hgmma = kernel_phase(sim)
    phase("serving")
    # the serving, refine, vsd and dgcnn phases run on the eval phase's
    # tree, the dgcnn phase also on the train phase's
    with tempfile.TemporaryDirectory() as eval_dir, \
            tempfile.TemporaryDirectory() as train_dir:
        write_eval_tree(eval_dir)
        launches_serve, _ = serving_phase(sim, eval_dir, smi_line)
        phase("eval")
        launches_eval, eval_timing, eval_peak = eval_phase(sim, eval_dir)
        phase("surface")
        with tempfile.TemporaryDirectory() as workdir:
            launches_surface, surface = surface_phase(
                sim, eval_dir, csv_rows(osp.join(eval_dir, "out",
                                                 "gt_lmo-test.csv")),
                workdir, smi_line)
        phase("profile")
        launches_profile, _, f32_kernels = profile_run(sim, eval_dir,
                                                       smi_line)
        phase("refine")
        launches_refine, _ = refine_phase(sim, eval_dir, eval_timing)
        phase("vsd")
        launches_vsd, vsd_timing = vsd_phase(sim, eval_dir, eval_timing)
        phase("stacked")
        with tempfile.TemporaryDirectory() as workdir:
            launches_stacked, _ = stacked_phase(sim, workdir)
        phase("train")
        launches_train, train_res = train_phase(sim, train_dir)
        phase("dgcnn")
        launches_dgcnn, dgcnn_timing = dgcnn_phase(sim, eval_dir, train_dir)
        phase("bf16")
        launches_bf16 = bf16_phase(sim, eval_dir, train_dir, smi_line, {
            "eval_timing": eval_timing, "eval_peak": eval_peak,
            "kernels": f32_kernels, "train_fixed": train_res["fixed"],
            "dgcnn_timing": dgcnn_timing})
        phase("parallel")
        with tempfile.TemporaryDirectory() as workdir:
            launches_parallel, par = parallel_phase(sim, eval_dir, workdir,
                                                    smi_line)
    phase("ycbv")
    with tempfile.TemporaryDirectory() as workdir:
        launches_ycbv, ycbv_stamped = ycbv_phase(sim, workdir)
    launches_vsd["render_depth_scatter"] += ycbv_stamped
    phase("lmfull")
    with tempfile.TemporaryDirectory() as workdir:
        launches_lmfull, lmfull = lmfull_phase(sim, workdir, smi_line)
    phase("convergence")
    # the default run's train-to-pose row
    tag = "demo flagship f32"
    launches_convergence, convergence = convergence_row(
        sim, tag, CONVERGENCE_ROWS[tag], smi_line)
    err = max(err, lmfull["serve"]["max_abs_err"],
              lmfull["train_val"]["max_abs_err"],
              convergence["max_abs_err"])
    log(f"  phase wall time {time.perf_counter() - t_phase[0]:.1f} s")

    # one entry per kernel: the eval shape (batch 128, the main path the
    # package is scored by) first, then the serving shape and the shape
    # of train's validation (batch 24)
    log(json.dumps({"kernels": [{
        "name": "cosine_argmax",
        "route": "cuda",
        "source": "gdm_tpu_torch/csrc/similarity.cu",
        "replaces": "gdm_tpu/ops/pallas/similarity.py:89",
        "launches": (launches_eval + launches_serve + launches_train
                     + launches_refine + launches_stacked
                     + launches_vsd["cosine_argmax"] + launches_ycbv
                     + launches_dgcnn + launches_profile + launches_bf16
                     + launches_parallel + launches_lmfull
                     + launches_convergence + launches_surface),
        "launches_eval": launches_eval,
        "launches_serve": launches_serve,
        "launches_profile": launches_profile,
        "launches_train": launches_train,
        "launches_refine": launches_refine,
        "launches_stacked": launches_stacked,
        "launches_vsd": launches_vsd["cosine_argmax"],
        "launches_ycbv": launches_ycbv,
        "launches_dgcnn": launches_dgcnn,
        "launches_bf16": launches_bf16,
        "launches_parallel": launches_parallel,
        "launches_lmfull": launches_lmfull,
        "launches_convergence": launches_convergence,
        "launches_surface": launches_surface,
        "max_abs_err": err,
        "ms": at["eval"]["ms"],
        "plain_ms": at["eval"]["plain_ms"],
        "bound_ms": at["eval"]["bound_ms"],
        "bound_by": at["eval"]["bound_by"],
        "bound_fma_ms": at["eval"]["bound_fma_ms"],
        "matmul_ms": at["eval"]["matmul_ms"],
        "tf32_tflops": at["eval"]["tf32_tflops"],
        "library_ms": None,
        "sass_hgmma": n_hgmma,
        "shape": list(EVAL_SHAPE),
        "serve": dict(at["serve"], shape=list(SERVE_SHAPE)),
        "train_val": dict(at["train_val"], shape=list(TRAIN_VAL_SHAPE)),
        "parallel": par,
        "lmfull": lmfull,
        "convergence": convergence,
        "surface": surface,
    }] + [dict({
        "name": name,
        "route": "cuda",
        "source": "gdm_tpu_torch/csrc/render_depth.cu",
        "replaces": replaces,
        "launches": launches_vsd[name],
        "library_ms": None,
    }, **vsd_timing[name]) for name, replaces in (
        # the JAX package's VSD renderer, over host-binned tables; off the
        # port's main path (launches 0), held on (b)'s chunks
        # (check_launches)
        ("render_depth_gather", "gdm_tpu/ops/render_depth.py:347"),
        # what eval/vsd renders with
        ("render_depth_scatter", "gdm_tpu/ops/render_depth.py:96"))]}))
    log(smi_line)
    ok_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())

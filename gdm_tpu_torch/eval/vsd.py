"""Visible Surface Discrepancy (BOP VSD) on the card.

Counterpart of gdm_tpu/eval/vsd.py.  Reference: lib/pysixd/pose_error.py
:22-129 (vsd), lib/pysixd/visibility.py (bop19 visibility masks),
lib/pysixd/misc.py:571-591 (depth->distance image), with the defaults of
eval_calc_errors.py (delta=15mm, taus=0.05:0.05:0.5 of the diameter) and
eval_calc_scores.py (correct_th=0.3).  Both model renders and the
mask/cost math run on the device over a window covering the object
(outside it the model depth is 0, which the visibility masks read as "no
model"; pixels beyond the full image are zeroed, as a full-frame render
has none).

The host (numpy, a copy of the JAX package's) picks each frame's window
and subdivision bucket, crops the test depth, culls and bins faces to the
raster tiles (ops/render_depth.bin_faces_to_slots).  The device
transforms the mesh by both poses, renders both with the gather kernel
(csrc/render_depth.cu, one launch per chunk of frames) and scores them.
``vsd_err_batch`` prepares the next chunk on the host while the device
renders the previous one.

Arithmetic follows the JAX package's f32 program as XLA compiles it,
which fuses ``a*b + c`` into FMAs: the pose transform is
``fma(z, r2, fma(y, r1, x * r0)) + t`` (what numpy's matmul gives the
host's cull too), and the distance factor and differences of distance
images take an FMA where XLA's does (ops/render_depth.fma32).  Step costs
then agree exactly; tlinear costs to the order of the f32 sum.

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from gdm_tpu_torch.data.ply import _winding_orientation
from gdm_tpu_torch.ops.render_depth import (
    bin_faces_to_slots,
    fma32,
    render_depth_window,
    render_depth_window_gather,
    subdivide_max_edge,
)

BOP19_TAUS = tuple(float(t) for t in np.arange(0.05, 0.51, 0.05))
BOP19_DELTA = 0.015          # 15 mm (eval_calc_errors.py:37-48)
BOP19_CORRECT_TH = (0.3,)    # eval_calc_scores.py:18

_WINDOW_BUCKETS = (64, 128, 256, 512, 1024)
_FACE_BUCKET_MIN = 512       # face-count bucket floor (scatter renderer)
_FACE_CHUNK = 512            # faces per step of the plain scatter renderer
_CAND_CHUNK = 512            # memory knob of the plain gather renderer
# candidates per slot row (bin_faces_to_slots): table bytes follow the
# real candidate count; dense tiles spill into further rows
_SLOT_CAP = 64

# per-mesh subdivision cache: the raster tile bounds screen-space triangle
# size, so the required 3-D edge bound depends on how close the object can
# get; z is bucketed so one subdivision serves all frames in a range of
# distances
_MESH_CACHE: dict = {}      # insertion-ordered, LRU-bounded
_MESH_CACHE_MAX = 16


def _ray_angle_factor(K: np.ndarray, im_hw, margin: float) -> float:
    """1 + max(|x/z|, |y/z|) over the clipped render-window bounds.

    The raster window is clipped to the frame extended by `margin`, so
    the largest ray angle any rendered pixel can have is at those
    extended corners."""
    imh, imw = float(im_hw[0]), float(im_hw[1])
    rx = max(abs(-margin - K[0, 2]), abs(imw + margin - K[0, 2])) / K[0, 0]
    ry = max(abs(-margin - K[1, 2]), abs(imh + margin - K[1, 2])) / K[1, 1]
    return 1.0 + float(max(rx, ry))


def _z_bucket(z_min: float) -> float:
    """Bucket z_min in 1.25x steps: the subdivided face count scales with
    (1/zb)^2, so 1.25x steps cap the overshoot at ~1.56x.  Also the
    frame-grouping key of vsd_err_batch."""
    zq = max(z_min, 0.126)
    return float(max(0.125, 1.25 ** np.floor(np.log(zq) / np.log(1.25))))


def _face_bucket(n: int, base: int = _FACE_BUCKET_MIN) -> int:
    """Smallest base * {2^k, 3*2^(k-1)} >= n (two buckets per octave)."""
    m = 1
    while base * m < n:
        if m == 1:
            m = 2
        elif (m & (m - 1)) == 0:        # power of two -> 1.5x
            m = 3 * m // 2
        else:                            # 3*2^(k-1)   -> 4/3x
            m = 4 * m // 3
    return base * m


def _prepared_mesh(verts: np.ndarray, faces: np.ndarray, K: np.ndarray,
                   z_min: float, tile: int, ray_factor: float, device):
    """Subdivide (cached) so every triangle fits the raster tile at z_min.

    Returns (verts_np [V,3], faces_np [F,3], verts on ``device``,
    orient).  The JAX package pads the vertex count to a power of two so
    that its compiled programs are reused; no face indexes the padding,
    so the port leaves it out."""
    fx = float(max(K[0, 0], K[1, 1]))
    zb = _z_bucket(z_min)
    rf = float(1.25 ** np.ceil(np.log(max(ray_factor, 1.0))
                               / np.log(1.25)))
    key = (zlib.crc32(verts.tobytes()), zlib.crc32(faces.tobytes()),
           verts.shape[0], faces.shape[0], tile, zb, rf)
    if key not in _MESH_CACHE:
        # winding consistency is a property of the ORIGINAL mesh (the
        # subdivision leaves midpoints unwelded): check it first
        orient = _winding_orientation(verts, faces)
        # screen extent of a 3-D edge e at depth >= zb is bounded by
        # fx * e / zb * rf; the raster tile covers bboxes up to tile-2 px
        max_edge = (tile - 2) * zb / (fx * rf)
        v, f = subdivide_max_edge(verts, faces, max_edge)
        _MESH_CACHE[key] = (v, f, {}, orient)
        while len(_MESH_CACHE) > _MESH_CACHE_MAX:
            _MESH_CACHE.pop(next(iter(_MESH_CACHE)))
    else:
        _MESH_CACHE[key] = _MESH_CACHE.pop(key)     # refresh LRU order
    v, f, on_device, orient = _MESH_CACHE[key]
    dev = torch.device(device)
    if str(dev) not in on_device:       # resident: reused by every frame
        on_device[str(dev)] = _upload(v, dev)
    return v, f, on_device[str(dev)], orient


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  To the card from pinned
    memory, asynchronously: a pageable copy would wait for the render the
    device is running."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _project_visible(v_sub, f_sub, orient, R, t, K, origin, side, tile):
    """Per-face window projections + contribution mask for one render.

    Culls faces whose raster stamp cannot intersect the window or that
    the device drops anyway (behind the camera, zero screen area).  When
    `orient` is set (consistently wound closed mesh) also culls
    backfaces: with outward winding (orient=+1) a camera-facing triangle
    projects with NEGATIVE signed area in y-down image coordinates, and
    on a closed manifold the front surface always occludes the back.

    Returns (p [F,3,2] window-pixel coords, vis [F] bool).
    """
    eps = 1e-9
    vc = v_sub @ R.T + t[None, :]
    z = vc[:, 2]
    zs = np.maximum(z, eps)
    u = vc[:, 0] * K[0, 0] / zs + K[0, 2] - origin[0]
    w = vc[:, 1] * K[1, 1] / zs + K[1, 2] - origin[1]
    p = np.stack([u, w], axis=1)[f_sub]                     # [F,3,2]
    fz = z[f_sub]
    vis = (fz > eps).all(axis=1)                            # device 'front'
    d01 = p[:, 1] - p[:, 0]
    d02 = p[:, 2] - p[:, 0]
    area = d01[:, 0] * d02[:, 1] - d01[:, 1] * d02[:, 0]
    vis &= np.abs(area) > eps                               # device 'ok'
    if orient is not None:
        vis &= (area * orient) < 0
    bb0 = np.floor(p.min(axis=1))                           # stamp anchor
    vis &= ((bb0[:, 0] + tile > 0) & (bb0[:, 0] < side)
            & (bb0[:, 1] + tile > 0) & (bb0[:, 1] < side))
    return p, vis


def _visible_face_idx(v_sub, f_sub, orient, R, t, K, origin, side, tile):
    """Indices of subdivided faces that can contribute to this render."""
    _, vis = _project_visible(v_sub, f_sub, orient, R, t, K, origin,
                              side, tile)
    return np.where(vis)[0]


def _pixel_grid(origin, window):
    """Full-image x [B, 1, w] and y [B, h, 1] of each window's integer
    pixel grid (origin [B, 2])."""
    h, w = window
    dev = origin.device
    x = origin[:, 0, None, None] + torch.arange(w, dtype=torch.float32,
                                                device=dev)[None, None, :]
    y = origin[:, 1, None, None] + torch.arange(h, dtype=torch.float32,
                                                device=dev)[None, :, None]
    return x, y


def _dist_factor(origin, window, K):
    """Per-pixel depth->distance multiplier [B, h, w] at integer pixel
    coords (misc.py:571-591 uses the integer grid, not pixel centres)."""
    x, y = _pixel_grid(origin, window)
    xs = ((x - K[0, 2]) / K[0, 0]).expand(-1, window[0], -1)
    ys = ((y - K[1, 2]) / K[1, 1]).expand(-1, -1, window[1])
    return torch.sqrt(fma32(xs, xs, ys * ys) + 1.0)


def _transform(verts, R, t):
    """verts [V, 3] by poses R [N, 3, 3], t [N, 3] -> [N, V, 3], written
    out elementwise (no matmul, so no TF32 on the card):
    fma(z, r2, fma(y, r1, x * r0)) + t per output row."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    rows = [fma32(z, R[:, j, 2:3], fma32(y, R[:, j, 1:2], x * R[:, j, 0:1]))
            + t[:, j:j + 1] for j in range(3)]
    return torch.stack(rows, dim=-1)


def _vsd_core_batch(verts, lanes, R_est, t_est, R_gt, t_gt, K, origin,
                    depth_wins, im_hw, taus, delta, diameter,
                    window=(256, 256), tile=16, cost_type="step",
                    normalized_by_diameter=True, renderer="scatter"):
    """VSD errors [B, n_taus] of B frames of one mesh, on the device of
    the tensors.  ``lanes`` is [B, 2, Fb, 3] culled face lists (scatter)
    or a ([B, 2, S, cap, 3], [B, 2, S]) slot-row candidate table + slot
    -> tile map (gather); render 0 of a frame is the estimate, 1 the GT.
    One renderer launch covers the 2B renders."""
    b = R_est.shape[0]
    h, w = window
    v = _transform(verts, torch.stack([R_est, R_gt], 1).reshape(-1, 3, 3),
                   torch.stack([t_est, t_gt], 1).reshape(-1, 3))
    org2 = origin.repeat_interleave(2, dim=0)
    if renderer == "gather":
        cand, slots = lanes
        d = render_depth_window_gather(
            v, cand.reshape((2 * b,) + cand.shape[2:]), K, org2, window,
            tile, cand_chunk=_CAND_CHUNK,
            slot_tile=slots.reshape(2 * b, -1))
    else:
        d = render_depth_window(v, lanes.reshape((2 * b,) + lanes.shape[2:]),
                                K, org2, window, tile,
                                face_chunk=_FACE_CHUNK)
    d = d.reshape(b, 2, h, w)

    # zero model depth beyond the full image bounds (a full-frame render
    # has no such pixels)
    x, y = _pixel_grid(origin, window)
    in_im = (x >= 0) & (x < im_hw[1]) & (y >= 0) & (y < im_hw[0])
    d_est = torch.where(in_im, d[:, 0], 0.0)
    d_gt = torch.where(in_im, d[:, 1], 0.0)

    # depth -> distance images (misc.py:571-591); XLA fuses each
    # difference of two products into an FMA of the first
    f = _dist_factor(origin, window, K)
    dist_test = depth_wins * f
    dist_est = d_est * f
    dist_gt = d_gt * f

    # bop19 visibility (visibility.py:34-36,75-76)
    def visib(d_model, dist_model):
        return (((fma32(d_model, f, -dist_test) <= delta)
                 | (dist_test == 0)) & (dist_model > 0))

    visib_gt = visib(d_gt, dist_gt)
    visib_est = visib(d_est, dist_est) | (visib_gt & (dist_est > 0))
    inter = visib_gt & visib_est
    union_count = (visib_gt | visib_est).sum(dim=(1, 2))
    comp_count = union_count - inter.sum(dim=(1, 2))

    dists = fma32(d_gt, f, -dist_est).abs()
    if normalized_by_diameter:
        dists = dists / diameter
    tau = taus[None, :, None, None]
    if cost_type == "step":
        costs = (dists[:, None] >= tau).float()
    elif cost_type == "tlinear":
        costs = torch.minimum(dists[:, None] / tau, torch.ones_like(tau))
    else:
        raise ValueError(f"unknown cost_type {cost_type}")
    c = torch.where(inter[:, None], costs, 0.0).sum(dim=(2, 3))   # [B, T]
    err = ((c + comp_count[:, None].float())
           / union_count.clamp_min(1)[:, None].float())
    return torch.where(union_count[:, None] == 0, 1.0, err)


def _bucket(v, buckets):
    for b in buckets:
        if v <= b:
            return b
    # beyond the precomputed buckets (ITODD 1280x960, HB 1920x1440, or a
    # union bbox wider than 1024): grow by powers of two so the window
    # always covers the clipped bbox
    b = buckets[-1]
    while b < v:
        b *= 2
    return b


def vsd_err(R_est, t_est, R_gt, t_gt, depth_test, K, verts, faces,
            diameter, delta=BOP19_DELTA, taus=BOP19_TAUS,
            normalized_by_diameter=True, cost_type="step",
            tile=32, renderer="gather", device="cuda") -> np.ndarray:
    """VSD errors, one per tau (pose_error.py:22-129 semantics).

    Args:
      R_est/t_est/R_gt/t_gt: poses (metres).
      depth_test: [H, W] metric test depth (0 = missing).
      K: [3, 3] intrinsics.
      verts/faces: render mesh (metres, object frame), as loaded: the
        subdivision to the raster-tile bound is cached per mesh and
        distance bucket.
      tile: raster stamp size.
      renderer: "gather" (binned candidates, the default) or "scatter"
        (the bit-identical cross-check).
      device: where the renders and the scoring run.

    Returns: [len(taus)] f32 errors in [0, 1].
    """
    job = _prep_job(R_est, t_est, R_gt, t_gt, depth_test, K, verts, tile)
    errs = _run_group(
        [job], np.asarray(verts, np.float32),
        np.asarray(faces, np.int32), diameter, delta, taus, tile,
        cost_type, normalized_by_diameter, renderer=renderer,
        device=device)
    return errs[0].cpu().numpy()


def _prep_job(R_est, t_est, R_gt, t_gt, depth_test, K, verts, tile):
    """Host-side per-frame prep: window origin/size bucket, depth crop,
    and the subdivision z bucket.  Returns a compact job dict (the crop,
    not the full frame) keyed for grouping by (side, z_bucket)."""
    depth_test = np.asarray(depth_test, np.float32)
    imh, imw = depth_test.shape
    R_est = np.asarray(R_est, np.float32)
    R_gt = np.asarray(R_gt, np.float32)
    t_est = np.asarray(t_est, np.float32).reshape(3)
    t_gt = np.asarray(t_gt, np.float32).reshape(3)
    verts = np.asarray(verts, np.float32)
    Knp = np.asarray(K, np.float32)

    # window = union bbox of both projections + raster margin
    def proj(R, t):
        vc = verts @ R.T + t[None, :]
        z = np.maximum(vc[:, 2], 1e-9)
        u = vc[:, 0] * Knp[0, 0] / z + Knp[0, 2]
        v = vc[:, 1] * Knp[1, 1] / z + Knp[1, 2]
        return u, v

    ue, ve = proj(R_est, t_est)
    ug, vg = proj(R_gt, t_gt)
    u = np.concatenate([ue, ug])
    v = np.concatenate([ve, vg])
    m = tile + 2.0
    x0, x1 = np.floor(u.min() - m), np.ceil(u.max() + m)
    y0, y1 = np.floor(v.min() - m), np.ceil(v.max() + m)
    # pixels outside the image never contribute (masked in-core) — clip
    # the window to the frame so far-out-of-view estimates stay cheap
    x0, x1 = np.clip([x0, x1], -m, imw + m)
    y0, y1 = np.clip([y0, y1], -m, imh + m)
    side = _bucket(max(x1 - x0, y1 - y0, 1.0), _WINDOW_BUCKETS)

    # crop the test depth at the window (zero-padded outside the frame)
    win = np.zeros((side, side), np.float32)
    ox, oy = int(x0), int(y0)
    sx0, sy0 = max(0, ox), max(0, oy)
    sx1, sy1 = min(imw, ox + side), min(imh, oy + side)
    if sx1 > sx0 and sy1 > sy0:
        win[sy0 - oy:sy1 - oy, sx0 - ox:sx1 - ox] = \
            depth_test[sy0:sy1, sx0:sx1]

    # subdivision bound: only vertices in FRONT of the camera constrain
    # the raster tile — a behind-camera estimate (the failure-sentinel
    # pose at t_z = -1000) must not drive z_min to the worst bucket
    z_all = np.concatenate([(verts @ R_est.T + t_est)[:, 2],
                            (verts @ R_gt.T + t_gt)[:, 2]])
    z_pos = z_all[z_all > 1e-6]
    z_min = float(z_pos.min()) if z_pos.size else 1e3
    return {
        "R_est": R_est, "t_est": t_est, "R_gt": R_gt, "t_gt": t_gt,
        "origin": np.array([ox, oy], np.float32), "win": win,
        "side": side, "zb": _z_bucket(z_min), "z_min": z_min,
        "im_hw": np.array([imh, imw], np.float32), "margin": m,
        "K": Knp,
    }


def _run_group(jobs, verts, faces, diameter, delta, taus, tile,
               cost_type, normalized_by_diameter, renderer="gather",
               device="cuda"):
    """Run jobs that share (side, z bucket, K, im_hw) as ONE batch on
    ``device``: one renderer launch for all of their renders.

    Returns the [n, n_taus] errors as a device tensor without waiting for
    them, so that the caller prepares the next chunk on the host while
    the device renders this one.

    The JAX package pads the batch to a power of two and the slot rows to
    a _face_bucket, so that its compiled programs are reused.  The port
    runs the n real jobs and pads slot rows only to the chunk's largest
    table (padding rows carry the sentinel tile G, which the renderers
    drop): the plain renderer would compute every padding row.  Face
    lists keep JAX's bucket; their padding faces are all-zero, which the
    renderers skip.
    """
    dev = torch.device(device)
    n = len(jobs)
    side = jobs[0]["side"]
    Knp = jobs[0]["K"]
    imh, imw = jobs[0]["im_hw"]
    v_np, f_np, verts_dev, orient = _prepared_mesh(
        verts, faces, Knp, min(j["z_min"] for j in jobs), tile,
        _ray_angle_factor(Knp, (imh, imw), jobs[0]["margin"]), dev)
    proj = [[_project_visible(v_np, f_np, orient, j[f"R_{k}"],
                              j[f"t_{k}"], Knp, j["origin"], side, tile)
             for k in ("est", "gt")] for j in jobs]
    if renderer == "gather":
        g = side // tile
        slotted = [[bin_faces_to_slots(p, vis, f_np, side, tile,
                                       _SLOT_CAP)
                    for p, vis in renders] for renders in proj]
        sb = max(max(a[0].shape[0], b[0].shape[0]) for a, b in slotted)
        cand = np.zeros((n, 2, sb, _SLOT_CAP, 3), np.int32)
        slots = np.full((n, 2, sb), g * g, np.int32)   # pad sentinel
        for i, renders in enumerate(slotted):
            for r, (cd, st) in enumerate(renders):
                cand[i, r, :cd.shape[0]] = cd
                slots[i, r, :st.shape[0]] = st
        lanes = (_upload(cand, dev), _upload(slots, dev))
    else:
        vis = [[np.where(v)[0] for _, v in renders] for renders in proj]
        fb = _face_bucket(max(max(len(a), len(b)) for a, b in vis))
        fl = np.zeros((n, 2, fb, 3), np.int32)
        for i, (ia, ib) in enumerate(vis):
            fl[i, 0, :len(ia)] = f_np[ia]
            fl[i, 1, :len(ib)] = f_np[ib]
        lanes = _upload(fl, dev)
    st = {k: _upload(np.stack([j[k] for j in jobs]), dev)
          for k in ("R_est", "t_est", "R_gt", "t_gt", "origin", "win")}
    return _vsd_core_batch(
        verts_dev, lanes, st["R_est"], st["t_est"], st["R_gt"],
        st["t_gt"], _upload(Knp, dev), st["origin"], st["win"],
        _upload(jobs[0]["im_hw"], dev),
        _upload(np.asarray(list(taus), np.float32), dev),
        _upload(np.asarray(delta, np.float32), dev),
        _upload(np.asarray(diameter, np.float32), dev),
        window=(side, side), tile=tile, cost_type=cost_type,
        normalized_by_diameter=normalized_by_diameter, renderer=renderer)


def vsd_err_batch(poses, depth_tests, K, verts, faces, diameter,
                  delta=BOP19_DELTA, taus=BOP19_TAUS,
                  normalized_by_diameter=True, cost_type="step",
                  tile=32, group_cap=16, renderer="gather",
                  pipeline_depth=2, device="cuda") -> np.ndarray:
    """VSD errors for many frames of one object: [n, len(taus)] float64.

    Frames are grouped by (window bucket, subdivision z bucket, K, image
    size) and each group runs in chunks of at most ``group_cap`` frames,
    one device batch (one renderer launch) per chunk.

    Args:
      poses: sequence of (R_est, t_est, R_gt, t_gt).
      depth_tests: matching sequence of [H, W] metric test depths.
      K: one [3, 3] intrinsics shared by all frames, or a sequence of
        per-frame intrinsics (frames group by K as well).
      group_cap: max frames per device batch (bounds the in-flight
        window and candidate-table memory at roughly pipeline_depth+1
        chunks).
      pipeline_depth: chunks left on the device, unread, while the host
        prepares the next one (projection, culling and tile binning); 0
        reads each chunk before preparing the next.  Results do not
        depend on it.
      device: where the renders and the scoring run.
    """
    K = np.asarray(K, np.float32)
    Ks = ([K] * len(depth_tests)) if K.ndim == 2 else list(K)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    jobs = [_prep_job(R_e, t_e, R_g, t_g, d, Ki, verts, tile)
            for (R_e, t_e, R_g, t_g), d, Ki
            in zip(poses, depth_tests, Ks)]
    out = np.zeros((len(jobs), len(taus)), np.float64)
    groups: dict = {}
    for i, j in enumerate(jobs):
        groups.setdefault(
            (j["side"], j["zb"], j["K"].tobytes(),
             tuple(j["im_hw"])), []).append(i)
    pending: list = []    # (device errs [n, n_taus], frame indices)

    def drain(keep):
        while len(pending) > keep:
            errs_dev, sel = pending.pop(0)
            for row, i in zip(errs_dev.cpu().numpy(), sel):
                out[i] = row

    for idxs in groups.values():
        for s in range(0, len(idxs), group_cap):
            sel = idxs[s:s + group_cap]
            errs_dev = _run_group(
                [jobs[i] for i in sel], verts, faces, diameter,
                delta, taus, tile, cost_type, normalized_by_diameter,
                renderer=renderer, device=device)
            pending.append((errs_dev, sel))
            drain(pipeline_depth)
    drain(0)
    return out


def vsd_recall(errors_per_frame, correct_ths=BOP19_CORRECT_TH) -> float:
    """Mean recall over frames x taus x thresholds (eval_calc_scores.py
    :18 uses th=0.3; the BOP19 challenge also averages th over
    0.05:0.05:0.5 — pass correct_ths accordingly)."""
    errs = np.asarray(list(errors_per_frame), np.float64)  # [n, n_taus]
    if errs.size == 0:
        return 0.0
    hits = [(errs < th).mean() for th in correct_ths]
    return float(np.mean(hits))

"""Depth rendering of triangle meshes (z-buffer rasterizer) for BOP VSD.

Counterpart of gdm_tpu/ops/render_depth.py.  The host part (numpy) is a
copy: loop subdivision to the raster-tile bound and the binning of faces
to raster tiles.  The device part is two renderers, each a wrapper with a
plain PyTorch version beside it and a launch counter:

  * :func:`render_depth_window` (scatter form): each face stamps a
    ``tile`` x ``tile`` block at its bbox and a scatter-min z-buffer
    resolves overlaps;
  * :func:`render_depth_window_gather` (gather form): the host bins faces
    to the raster tiles their bbox touches, and each tile takes the min
    over its candidate faces, per pixel.  It is what VSD runs.

In JAX both are XLA programs, not Pallas kernels; PyTorch has no fused op
for either, and the plain gather materialises [rows, k, tile^2]
temporaries, so on the card each is a hand-written CUDA kernel in
``csrc/render_depth.cu``.  A CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises; there is no fallback.

Arithmetic: VSD compares depths, so the renderers are held bit-equal to
the JAX package's, whose f32 arithmetic the XLA CPU backend compiles
with fused multiply-adds: an edge function ``A*B - C*D`` is
``fma(A, B, -(C*D))``.  The plain versions reproduce that with
:func:`fma32` (an exactly rounded f32 FMA built from float64 operations),
and the kernels with ``__fmaf_rn`` and explicitly rounded operations
(nvcc's own contraction would fuse other pairs).  With the same
(face, pixel, z) set competing per pixel and an order-free f32 min, the
two renderers and the two layouts of the gather form give the same bits.

Both renderers take one render ([V, 3] vertices, [2] origin, -> [h, w])
or a batch of N renders with leading N axes (-> [N, h, w]): the kernels
cover the batch in one launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

EPS = 1e-9


def subdivide_max_edge(verts: np.ndarray, faces: np.ndarray,
                       max_edge: float,
                       max_faces: int = 4_000_000
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side 4-way loop subdivision until every edge is <= max_edge.

    One-time per-mesh preprocessing (numpy).  Each oversized triangle is
    split at its edge midpoints into 4 triangles; repeats until all edges
    are short enough.  Midpoints are NOT welded across faces — harmless
    for depth rendering (coincident geometry), and it keeps the pass a
    pure per-face map.

    Raises ValueError once the face count would exceed `max_faces`: a
    metre-scale max_edge applied to a millimetre-scale mesh quadruples
    the face count ~10 extra times (4^10x) and looks like a hang —
    fail fast with a units hint instead.

    Returns (verts [V',3] float32, faces [F',3] int32).
    """
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    for _ in range(32):  # hard stop; each pass halves edge lengths
        tri = verts[faces]                                   # [F,3,3]
        e = np.linalg.norm(tri - np.roll(tri, -1, axis=1), axis=2)
        big = e.max(axis=1) > max_edge
        if not big.any():
            break
        if len(faces) + 3 * int(big.sum()) > max_faces:
            ext = float(np.abs(verts).max())
            raise ValueError(
                f"subdivide_max_edge: face count would exceed "
                f"{max_faces} (now {len(faces)}, max edge "
                f"{e.max():.3g} vs target {max_edge:.3g}). Mesh extent "
                f"is {ext:.3g} — VSD expects metres; a ~1e3 extent "
                f"suggests millimetre vertices (divide by 1000).")
        keep = faces[~big]
        t = tri[big]                                         # [B,3,3]
        m01 = 0.5 * (t[:, 0] + t[:, 1])
        m12 = 0.5 * (t[:, 1] + t[:, 2])
        m20 = 0.5 * (t[:, 2] + t[:, 0])
        base = len(verts)
        newv = np.concatenate([m01, m12, m20], axis=0)
        b = len(t)
        i01 = np.arange(b) + base
        i12 = np.arange(b) + base + b
        i20 = np.arange(b) + base + 2 * b
        v0, v1, v2 = faces[big, 0], faces[big, 1], faces[big, 2]
        newf = np.concatenate([
            np.stack([v0, i01, i20], 1),
            np.stack([i01, v1, i12], 1),
            np.stack([i12, v2, i20], 1),
            np.stack([i01, i12, i20], 1),
        ], axis=0)
        verts = np.concatenate([verts, newv], axis=0).astype(np.float32)
        faces = np.concatenate([keep, newf], axis=0)
    return verts, faces.astype(np.int32)


def _face_tile_pairs(p: np.ndarray, valid: np.ndarray, side: int,
                     tile: int):
    """Shared (tile id, face id) enumeration for both binning layouts.

    Encodes the tile-2px bbox invariant (subdivide_max_edge bound): a
    valid face's bbox fits in tile-2 px, so it overlaps at most 2x2
    grid tiles — enumerated as the bbox-min tile plus optional +1 steps
    in x/y, with keep masks dropping duplicate steps when the bbox
    spans a single tile column/row.

    Returns:
      (tid_s, fid_s, counts): (tile, face) pairs stable-sorted by tile,
      and per-tile pair counts [g*g]; or None when no face is valid.
    """
    g = side // tile
    assert g * tile == side, (side, tile)
    vi = np.where(valid)[0]
    if len(vi) == 0:
        return None
    pv = p[vi]
    bmin = np.floor(pv.min(axis=1))                       # [f, 2]
    bmax = np.floor(pv.max(axis=1))
    tx0 = np.clip(bmin[:, 0] // tile, 0, g - 1).astype(np.int64)
    tx1 = np.clip(bmax[:, 0] // tile, 0, g - 1).astype(np.int64)
    ty0 = np.clip(bmin[:, 1] // tile, 0, g - 1).astype(np.int64)
    ty1 = np.clip(bmax[:, 1] // tile, 0, g - 1).astype(np.int64)
    pairs_t, pairs_f = [], []
    for dy in (0, 1):
        ty = np.minimum(ty0 + dy, ty1)
        for dx in (0, 1):
            tx = np.minimum(tx0 + dx, tx1)
            keep = np.ones(len(vi), bool)
            if dx:
                keep &= tx1 > tx0
            if dy:
                keep &= ty1 > ty0
            pairs_t.append(ty[keep] * g + tx[keep])
            pairs_f.append(vi[keep])
    tid = np.concatenate(pairs_t)
    fid = np.concatenate(pairs_f)
    counts = np.bincount(tid, minlength=g * g)
    order = np.argsort(tid, kind="stable")
    return tid[order], fid[order], counts


def bin_faces_to_tiles(p: np.ndarray, valid: np.ndarray, faces: np.ndarray,
                       side: int, tile: int,
                       k_pad: int | None = None) -> np.ndarray:
    """Host-side face->raster-tile binning for the gather renderer.

    Args:
      p:     [F, 3, 2] projected window-pixel vertex coords (numpy).
      valid: [F] bool — faces that can contribute (in front,
             non-degenerate, window-intersecting, optionally
             front-facing).
      faces: [F, 3] int32 vertex indices.
      side:  window side (multiple of `tile`).
      tile:  raster tile size; every valid face's bbox must fit in
             tile-2 px (subdivide_max_edge bound) so a face overlaps at
             most 2x2 grid tiles.
      k_pad: pad the per-tile candidate count to this (None = max
             occupancy).

    Returns:
      [G, k, 3] int32 candidate vertex-index triples per tile (G =
      (side/tile)^2, row-major tiles), zero-padded — an all-zero triple
      is degenerate and skipped by the renderer's area test.
    """
    g = side // tile
    pairs = _face_tile_pairs(p, valid, side, tile)
    if pairs is None:
        return np.zeros((g * g, k_pad or 1, 3), np.int32)
    tid_s, fid_s, counts = pairs
    k = int(counts.max())
    if k_pad is not None:
        assert k_pad >= k, (k_pad, k)
        k = k_pad
    starts = np.zeros(g * g + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(tid_s)) - starts[tid_s]
    cand = np.zeros((g * g, k, 3), np.int32)
    cand[tid_s, slot] = faces[fid_s]
    return cand


def bin_faces_to_slots(p: np.ndarray, valid: np.ndarray,
                       faces: np.ndarray, side: int, tile: int,
                       k_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """bin_faces_to_tiles with a FIXED per-row capacity: dense tiles
    spill into extra rows ("slots") instead of inflating a global
    max-occupancy pad.

    On dense tiny-face meshes one grazing-view tile can hold thousands of
    candidates while the mean is ~25; slot rows bound the padding at ~2x
    the real candidate count.  The renderer min-combines rows of the same
    tile afterwards (order-free f32 min — bit-identical to the dense
    layout).

    Returns:
      (cand [S, k_cap, 3] int32 zero-padded, slot_tile [S] int32 —
       row-major tile id of each slot row).  S = sum over non-empty
      tiles of ceil(occupancy / k_cap); 1 all-zero slot for an empty
      window.
    """
    g = side // tile
    pairs = _face_tile_pairs(p, valid, side, tile)
    if pairs is None:
        return (np.zeros((1, k_cap, 3), np.int32),
                np.zeros((1,), np.int32))
    tid_s, fid_s, counts = pairs
    starts = np.zeros(g * g + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(len(tid_s)) - starts[tid_s]       # pos in tile
    rows_per_tile = -(-counts // k_cap)                  # ceil
    row_starts = np.zeros(g * g + 1, np.int64)
    np.cumsum(rows_per_tile, out=row_starts[1:])
    S = int(row_starts[-1])
    slot = row_starts[tid_s] + within // k_cap
    col = within % k_cap
    cand = np.zeros((S, k_cap, 3), np.int32)
    cand[slot, col] = faces[fid_s]
    slot_tile = np.repeat(np.arange(g * g, dtype=np.int32),
                          rows_per_tile)
    return cand, slot_tile


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exactly rounded float32 ``a * b + c`` (what ``fmaf`` returns).

    The product of two f32 values is exact in float64; the f64 sum is
    rounded once, and rounding that to f32 would round twice only where
    the f64 sum lands exactly halfway between two f32 values while the
    exact sum does not.  There the f64 sum is moved one f64 step towards
    the exact sum (its rounding error, from TwoSum), which lies on the
    exact sum's side of the halfway point."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)                   # s + err is exact
    r = s.float()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))
    half = (s == (r.double() + other.double()) * 0.5) & (err != 0)
    inf64 = torch.full_like(s, float("inf"))
    s = torch.where(half, torch.nextafter(s, torch.where(err > 0, inf64,
                                                         -inf64)), s)
    return s.float()


def _project(verts_cam: torch.Tensor, K: torch.Tensor, origin: torch.Tensor):
    """Window-pixel coordinates [V, 2] and depths [V] of camera-frame
    vertices: ``x * fx / max(z, eps) + cx - ox`` in that order."""
    z = verts_cam[:, 2]
    zs = torch.clamp_min(z, EPS)
    u = verts_cam[:, 0] * K[0, 0] / zs + K[0, 2] - origin[0]
    v = verts_cam[:, 1] * K[1, 1] / zs + K[1, 2] - origin[1]
    return torch.stack([u, v], dim=1), z


def _edge(p, a, b, sx, sy):
    """Edge function of vertices a -> b at pixel centres (sx, sy), as
    XLA fuses it: fma(bx - ax, sy - ay, -((by - ay) * (sx - ax)))."""
    ax, ay = p[..., a, 0:1], p[..., a, 1:2]
    bx, by = p[..., b, 0:1], p[..., b, 1:2]
    return fma32(bx - ax, sy - ay, -((by - ay) * (sx - ax)))


def _setup(p, fz):
    """Per-face (ok, inv_a) from window coords [..., 3, 2] and depths
    [..., 3]: in front, and a signed double area above eps."""
    front = (fz > EPS).all(dim=-1)
    d01 = p[..., 1, :] - p[..., 0, :]
    d02 = p[..., 2, :] - p[..., 0, :]
    area = fma32(d01[..., 0], d02[..., 1], -(d01[..., 1] * d02[..., 0]))
    nz = area.abs() > EPS
    ok = front & nz
    inv_a = 1.0 / torch.where(nz, area, torch.ones_like(area))
    return ok, inv_a


def _zpix(p, fz, inv_a, sx, sy):
    """(inside, perspective-correct depth) at pixel centres (sx, sy) of
    faces p [..., 3, 2], fz [..., 3]; pixels broadcast on the last axis."""
    b0 = _edge(p, 1, 2, sx, sy) * inv_a[..., None]
    b1 = _edge(p, 2, 0, sx, sy) * inv_a[..., None]
    b2 = _edge(p, 0, 1, sx, sy) * inv_a[..., None]
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    invz = (b0 / fz[..., 0:1] + b1 / fz[..., 1:2] + b2 / fz[..., 2:3])
    zpix = 1.0 / torch.maximum(invz, torch.full_like(invz, EPS))
    return inside, zpix


def render_depth_window_reference(verts_cam, faces, K, origin,
                                  window=(256, 256), tile=16,
                                  face_chunk=1024):
    """Plain version of the scatter renderer for one render: the JAX
    package's ``render_depth_window`` op for op, with
    ``scatter_reduce_(amin)`` as the z-buffer.

    Args:
      verts_cam: [V, 3] f32 metres, camera frame.
      faces: [F, 3] int vertex indices; zero-area faces (all-zero
        padding rows) are skipped.
      K: [3, 3] f32 intrinsics of the full image.
      origin: [2] f32 (ox, oy) window origin in full-image pixels.
      window: (h, w); tile: raster block, every face's bbox must fit.
      face_chunk: faces stamped per step (bounds the [chunk, tile^2]
        temporaries).

    Returns [h, w] f32 depth, 0 where no surface."""
    h, w = window
    dev = verts_cam.device
    if faces.shape[0] == 0:
        return torch.zeros((h, w), dtype=torch.float32, device=dev)
    s = tile * tile
    pix, z = _project(verts_cam, K, origin)
    faces = faces.long()
    lane = torch.arange(s, device=dev)
    dx = (lane % tile).float()
    dy = (lane // tile).float()
    buf = torch.full((h * w + 1,), float("inf"), dtype=torch.float32,
                     device=dev)
    for f0 in range(0, faces.shape[0], face_chunk):
        fc = faces[f0:f0 + face_chunk]
        p = pix[fc]                                         # [c, 3, 2]
        fz = z[fc]                                          # [c, 3]
        ok, inv_a = _setup(p, fz)
        bb0 = torch.floor(p.min(dim=1).values)              # [c, 2]
        ix = bb0[:, 0:1] + dx                               # [c, s]
        iy = bb0[:, 1:2] + dy
        inside, zpix = _zpix(p, fz, inv_a, ix + 0.5, iy + 0.5)
        valid = (inside & ok[:, None] & (ix >= 0) & (ix < w) & (iy >= 0)
                 & (iy < h) & (zpix > EPS))
        flat = torch.where(valid, iy.long() * w + ix.long(), h * w)
        buf.scatter_reduce_(0, flat.reshape(-1),
                            torch.where(valid, zpix, float("inf"))
                            .reshape(-1), reduce="amin")
    depth = buf[:h * w].reshape(h, w)
    return torch.where(torch.isfinite(depth), depth, 0.0)


def render_depth_window_gather_reference(verts_cam, cand, K, origin,
                                         window=(256, 256), tile=32,
                                         cand_chunk=256, slot_tile=None):
    """Plain version of the gather renderer for one render: the JAX
    package's ``render_depth_window_gather`` op for op — [rows, k,
    tile^2] edge tests and a min over the candidates, chunked over k
    (dense layout) or over row blocks (slot layout) as JAX chunks it,
    then a scatter-min of slot rows onto their tiles.

    Args:
      verts_cam: [V, 3] camera-frame vertices.
      cand: [G, k, 3] per-tile candidate triples (bin_faces_to_tiles),
        or with ``slot_tile`` [S, k, 3] slot rows (bin_faces_to_slots).
      K, origin, window, tile: as in the scatter renderer; the window's
        sides are multiples of ``tile``.
      cand_chunk: memory knob (candidates per step, dense layout; row
        block 64*cand_chunk/k, slot layout).
      slot_tile: [S] tile id of each slot row; rows with tile id G
        (padding) are dropped.

    Returns [h, w] f32 depth, 0 where no surface."""
    h, w = window
    dev = verts_cam.device
    gx, gy = w // tile, h // tile
    G = gx * gy
    s = tile * tile
    pix, z = _project(verts_cam, K, origin)
    cand = cand.long()
    rows, kc = cand.shape[0], cand.shape[1]
    inf = float("inf")

    def tri_min(cand_c, sxp, syp):
        p = pix[cand_c]                                     # [R, k, 3, 2]
        fz = z[cand_c]                                      # [R, k, 3]
        ok, inv_a = _setup(p, fz)
        inside, zpix = _zpix(p, fz, inv_a, sxp[:, None, :], syp[:, None, :])
        valid = inside & ok[..., None] & (zpix > EPS)
        return torch.where(valid, zpix, inf).min(dim=1).values

    def row_coords(tg):
        lane = torch.arange(s, device=dev)
        sx = ((tg[:, None] % gx) * tile + lane % tile).float() + 0.5
        sy = ((tg[:, None] // gx) * tile + lane // tile).float() + 0.5
        return sx, sy

    if slot_tile is None:
        sx, sy = row_coords(torch.arange(rows, device=dev))
        acc = torch.full((rows, s), inf, dtype=torch.float32, device=dev)
        for k0 in range(0, kc, min(cand_chunk, kc)):
            acc = torch.minimum(acc, tri_min(
                cand[:, k0:k0 + cand_chunk], sx, sy))
    else:
        slot_tile = slot_tile.long()
        sx, sy = row_coords(slot_tile)
        rc = min(rows, max(1, (cand_chunk * 64) // kc))
        acc = torch.cat([tri_min(cand[r:r + rc], sx[r:r + rc],
                                 sy[r:r + rc])
                         for r in range(0, rows, rc)])
        acc = torch.full((G + 1, s), inf, dtype=torch.float32,
                         device=dev).scatter_reduce_(
            0, slot_tile[:, None].expand(-1, s), acc, "amin")[:G]
    depth = acc.reshape(gy, gx, tile, tile).transpose(1, 2).reshape(h, w)
    return torch.where(torch.isfinite(depth), depth, 0.0)


# ---------------------------------------------------------------------------
# wrappers

def _batched(verts_cam, table, origin):
    """(verts [N, V, 3], table [N, ...], origin [N, 2], single) from one
    render's or a batch's arguments."""
    single = verts_cam.dim() == 2
    if single:
        return verts_cam[None], table[None], origin[None], True
    return verts_cam, table, origin, False


def _check(name, t, dtype, dim, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: want {dim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, vertices on {device}")


def _library():
    from gdm_tpu_torch import _build

    lib = _build.load("render_depth")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdm_render_depth_gather.argtypes = [p, i, p, p, i, i, p, p, i, i,
                                            i, i, p, p]
    lib.gdm_render_depth_gather.restype = ctypes.c_int
    lib.gdm_render_depth_scatter.argtypes = [p, i, p, i, p, p, i, i, i, i,
                                             p, p]
    lib.gdm_render_depth_scatter.restype = ctypes.c_int
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_gather(verts, cand, K, origin, window, tile, slot_tile):
    n, v = verts.shape[0], verts.shape[1]
    h, w = window
    dev = verts.device
    _check("verts_cam", verts, torch.float32, 3, dev)
    _check("cand", cand, torch.int32, 4, dev)
    _check("K", K, torch.float32, 2, dev)
    _check("origin", origin, torch.float32, 2, dev)
    if cand.shape[0] != n or cand.shape[3] != 3 or origin.shape != (n, 2):
        raise ValueError(f"cand {tuple(cand.shape)} / origin "
                         f"{tuple(origin.shape)} do not fit {n} renders")
    if h % tile or w % tile or tile * tile > 1024:
        raise ValueError(f"window {window} with tile {tile}: sides must be "
                         "multiples of the tile, tile^2 <= 1024")
    rows, k = cand.shape[1], cand.shape[2]
    if slot_tile is not None:
        _check("slot_tile", slot_tile, torch.int32, 2, dev)
        if slot_tile.shape != (n, rows):
            raise ValueError(f"slot_tile {tuple(slot_tile.shape)}, want "
                             f"{(n, rows)}")
    elif rows != (h // tile) * (w // tile):
        raise ValueError(f"dense layout: {rows} rows, want one per tile")
    out = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    if k == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = _library().gdm_render_depth_gather(
            verts.data_ptr(), v, cand.data_ptr(),
            0 if slot_tile is None else slot_tile.data_ptr(), rows, k,
            K.data_ptr(), origin.data_ptr(), n, h, w, tile, out.data_ptr(),
            _stream(verts))
    if rc != 0:
        raise RuntimeError(f"render_depth_gather kernel launch failed: CUDA "
                           f"error {rc} at N={n}, rows={rows}, k={k}, "
                           f"window={window}, tile={tile}")
    render_depth_window_gather.launches += 1
    return out


def _launch_scatter(verts, faces, K, origin, window, tile):
    n, v = verts.shape[0], verts.shape[1]
    h, w = window
    dev = verts.device
    _check("verts_cam", verts, torch.float32, 3, dev)
    _check("faces", faces, torch.int32, 3, dev)
    _check("K", K, torch.float32, 2, dev)
    _check("origin", origin, torch.float32, 2, dev)
    if faces.shape[0] != n or faces.shape[2] != 3 or origin.shape != (n, 2):
        raise ValueError(f"faces {tuple(faces.shape)} / origin "
                         f"{tuple(origin.shape)} do not fit {n} renders")
    out = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    nf = faces.shape[1]
    if nf == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = _library().gdm_render_depth_scatter(
            verts.data_ptr(), v, faces.data_ptr(), nf, K.data_ptr(),
            origin.data_ptr(), n, h, w, tile, out.data_ptr(), _stream(verts))
    if rc != 0:
        raise RuntimeError(f"render_depth_scatter kernel launch failed: "
                           f"CUDA error {rc} at N={n}, F={nf}, "
                           f"window={window}, tile={tile}")
    render_depth_window.launches += 1
    return out


def render_depth_window(verts_cam, faces, K, origin, window=(256, 256),
                        tile=16, face_chunk=1024):
    """Scatter renderer: one render ([V, 3], [F, 3], origin [2] ->
    [h, w]) or N ([N, V, 3], [N, F, 3], [N, 2] -> [N, h, w]).

    CPU tensors take :func:`render_depth_window_reference` per render;
    CUDA tensors launch ``render_depth_scatter`` (csrc/render_depth.cu)
    once for the batch, counted in ``render_depth_window.launches``.
    ``face_chunk`` is the plain version's memory knob."""
    verts, faces_b, origin_b, single = _batched(verts_cam, faces, origin)
    if verts.is_cuda:
        out = _launch_scatter(verts, faces_b, K, origin_b, tuple(window),
                              tile)
    else:
        out = torch.stack([render_depth_window_reference(
            verts[i], faces_b[i], K, origin_b[i], window, tile, face_chunk)
            for i in range(verts.shape[0])])
    return out[0] if single else out


render_depth_window.launches = 0


def render_depth_window_gather(verts_cam, cand, K, origin,
                               window=(256, 256), tile=32, cand_chunk=256,
                               slot_tile=None):
    """Gather renderer: one render ([V, 3], cand [G|S, k, 3], origin [2],
    slot_tile [S] -> [h, w]) or N (leading N axes -> [N, h, w]).

    CPU tensors take :func:`render_depth_window_gather_reference` per
    render; CUDA tensors launch ``render_depth_gather``
    (csrc/render_depth.cu) once for the batch, counted in
    ``render_depth_window_gather.launches``.  ``cand_chunk`` is the plain
    version's memory knob."""
    verts, cand_b, origin_b, single = _batched(verts_cam, cand, origin)
    st = None if slot_tile is None else (
        slot_tile[None] if single else slot_tile)
    if verts.is_cuda:
        out = _launch_gather(verts, cand_b, K, origin_b, tuple(window), tile,
                             st)
    else:
        out = torch.stack([render_depth_window_gather_reference(
            verts[i], cand_b[i], K, origin_b[i], window, tile, cand_chunk,
            None if st is None else st[i])
            for i in range(verts.shape[0])])
    return out[0] if single else out


render_depth_window_gather.launches = 0

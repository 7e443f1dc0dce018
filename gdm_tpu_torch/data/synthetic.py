"""Synthetic data, for tests, the smoke run and the train-to-pose demo.

Counterpart of gdm_tpu/data/synthetic.py's ``make_object``,
``render_sample`` and ``make_batch`` (in-memory training batches with GT
correspondences, bit-equal to the JAX package's for the same arguments),
``make_trefoil_mesh`` (the concave VSD rendering workload) and
``write_synthetic_bop_root`` (a BOP dataset on disk): the same objects,
meshes, poses, frames, JSONs and detections from the same seed.  Frames
are written with the port's own encoders (data/imio) where the JAX
package calls PIL: PNG, whose files differ byte for byte but decode to
the same pixels, and, for ``train_pbr``, baseline JPEG at quality 95
with 4:2:0 chroma (the same settings), whose pixels differ by the two
encoders' rounding.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gdm_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from gdm_tpu_torch.data.gt_gen import pose_gt_info, pose_visibility
from gdm_tpu_torch.data.imio import imwrite_jpeg, imwrite_png


def make_object(n_pts: int, rng: np.random.RandomState,
                radius: float = 0.05) -> np.ndarray:
    """Random star-shaped object as an fps-style [n, 9] array
    (xyz mm | rgb | normal) — the obj_XXXXXX_fps.npy layout."""
    dirs = rng.randn(n_pts, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.3 * np.sin(5 * dirs[:, 0]) * np.cos(5 * dirs[:, 1])
    pts = dirs * (radius * bump[:, None])
    rgb = ((dirs + 1) * 127.5).clip(0, 255)
    nrm = dirs
    return np.concatenate(
        [pts * 1000.0, rgb, nrm], axis=1).astype(np.float32)


def render_sample(
    mesh_fps: np.ndarray,
    pose: np.ndarray,
    K: np.ndarray,
    im_size: int = 256,
    n_sample: int = 4096,
    bg_depth: float = 1.5,
    rng: np.random.RandomState | None = None,
    nn_dist_th: float = 0.01,
    splat: int = 2,
    render_pts: np.ndarray | None = None,
    hpr_radius_param: float = 2.0,
):
    """Render one training-style sample dict (host side): a far-to-near
    splat z-buffer of ``render_pts`` (default the mesh points) over a
    ``bg_depth`` background, the backprojected crop, normals from depth
    gradients, points sampled with wrap-pad + shuffle
    (linemod_pbr.py:476-503) and their GT correspondences (pose_gt_info
    with HPR visibility).

    Args:
      mesh_fps: [m, 9] object (xyz mm | rgb | normal).
      pose: [3, 4] GT pose, camera frame, metres.
      K: [3, 3] intrinsics for the im_size crop.

    Returns:
      dict with rgb [S,S,3] (imagenet-normalised), cld_rgb_nrm [N,9],
      choose [N], xyz_img [S,S,3], labels [N], origin_labels [N],
      match_idx [N], visible_flag [m], RT [3,4] (the model input
      contract) and valid (pose_gt_info's).
    """
    rng = rng or np.random.RandomState(0)
    pts = mesh_fps[:, :3] / 1000.0
    render = mesh_fps if render_pts is None else render_pts
    rpts = render[:, :3] / 1000.0
    colors = render[:, 3:6]

    cam_pts = rpts @ pose[:, :3].T + pose[:, 3][None, :]
    z = cam_pts[:, 2]
    u = (cam_pts[:, 0] * K[0, 0] / z + K[0, 2]).round().astype(int)
    v = (cam_pts[:, 1] * K[1, 1] / z + K[1, 2]).round().astype(int)

    depth = np.full((im_size, im_size), bg_depth, np.float32)
    rgb = np.full((im_size, im_size, 3), 128.0, np.float32)
    mask = np.zeros((im_size, im_size), np.uint8)
    order = np.argsort(-z)                                # far to near
    for du in range(splat):
        for dv in range(splat):
            uu = np.clip(u[order] + du, 0, im_size - 1)
            vv = np.clip(v[order] + dv, 0, im_size - 1)
            inside = (u[order] + du >= 0) & (u[order] + du < im_size) & \
                     (v[order] + dv >= 0) & (v[order] + dv < im_size)
            depth[vv[inside], uu[inside]] = z[order][inside]
            rgb[vv[inside], uu[inside]] = colors[order][inside]
            mask[vv[inside], uu[inside]] = 1

    vv_g, uu_g = np.mgrid[:im_size, :im_size].astype(np.float32)
    x = (uu_g - K[0, 2]) * depth / K[0, 0]
    y = (vv_g - K[1, 2]) * depth / K[1, 1]
    xyz_img = np.stack([x, y, depth], axis=-1).astype(np.float32)

    gy, gx = np.gradient(depth)
    nrm_img = np.stack([-gx, -gy, -np.ones_like(depth)], axis=-1)
    nrm_img /= np.linalg.norm(nrm_img, axis=-1, keepdims=True)

    choose = np.nonzero((depth > 1e-6).ravel())[0]
    if len(choose) > n_sample:
        c_mask = np.zeros(len(choose), int)
        c_mask[:n_sample] = 1
        rng.shuffle(c_mask)
        choose = choose[c_mask.nonzero()[0]]
    else:
        choose = np.pad(choose, (0, n_sample - len(choose)), "wrap")
    rng.shuffle(choose)

    cld = xyz_img.reshape(-1, 3)[choose]
    rgb_n = ((rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(
        np.float32)
    rgb_pt = rgb_n.reshape(-1, 3)[choose]
    nrm_pt = nrm_img.reshape(-1, 3)[choose]
    labels_pt = mask.ravel()[choose].astype(np.int32)

    labels, match_idx, visible_flag, valid = pose_gt_info(
        cld, labels_pt, pose, pts, nn_dist_th=nn_dist_th,
        visible_flag=lambda: pose_visibility(
            pose, pts, radius_param=hpr_radius_param))

    return {
        "rgb": rgb_n.astype(np.float32),
        "cld_rgb_nrm": np.concatenate(
            [cld, rgb_pt, nrm_pt], axis=1).astype(np.float32),
        "choose": choose.astype(np.int32),
        "xyz_img": xyz_img,
        "labels": labels.astype(np.int32),
        "origin_labels": labels_pt,
        "match_idx": match_idx.astype(np.int32),
        "visible_flag": visible_flag,
        "RT": pose.astype(np.float32),
        "valid": valid,
    }


def make_batch(
    mesh_fps: np.ndarray,
    batch: int,
    K: np.ndarray,
    im_size: int = 256,
    n_sample: int = 4096,
    seed: int = 0,
    nn_dist_th: float = 0.01,
    hpr_radius_param: float = 2.0,
):
    """Stacked batch of :func:`render_sample` at random poses: rotation i
    is scipy's ``Rotation.random(random_state=seed * 1000 + i)``, the
    translation and the sampling draw from ``RandomState(seed)``, the
    frames are rasterised from a dense point set on the same surface.

    Returns (host_arrays dict without ``valid``, poses [B, 3, 4]).
    """
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    # make_object's radius is a pure function of direction, so fresh
    # directions sample the same shape
    radius = float(np.linalg.norm(mesh_fps[:, :3], axis=1).max()) / 1300.0
    render_pts = make_object(
        max(16 * mesh_fps.shape[0], 8192), rng, radius=radius)
    samples = []
    for i in range(batch):
        R = Rotation.random(random_state=seed * 1000 + i).as_matrix()
        t = np.array([rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03),
                      rng.uniform(0.35, 0.5)])
        pose = np.hstack([R, t[:, None]]).astype(np.float32)
        samples.append(render_sample(
            mesh_fps, pose, K, im_size, n_sample, rng=rng,
            nn_dist_th=nn_dist_th, render_pts=render_pts,
            hpr_radius_param=hpr_radius_param))
    keys = [k for k in samples[0] if k != "valid"]
    batch_dict = {k: np.stack([s[k] for s in samples]) for k in keys}
    return batch_dict, batch_dict["RT"]


def make_trefoil_mesh(n_u: int = 160, n_v: int = 64, scale: float = 0.02,
                      tube_r: float = 0.011):
    """Concave, closed, consistently wound triangle mesh: a trefoil
    torus-knot tube.

    A procedurally generated "hard" rendering workload (2*n_u*n_v faces,
    deep self-occlusion from the knot crossings, strongly concave) that
    stands in for real BOP meshes, which are concave with 10k+ faces —
    unlike a convex hull.  No reference counterpart (the reference
    renders via the external bop_renderer C++ library,
    lib/pysixd/renderer_cpp.py).

    Returns (verts [n_u*n_v, 3] float32 metres, faces [2*n_u*n_v, 3]
    int32), wound outward (positive signed volume) so eval/vsd's
    winding check enables exact backface culling.

    The tube frame is parallel-transported along the knot and the
    residual holonomy angle is distributed linearly over u, so the
    u-seam closes without a twist (all edges stay O(curve_len/n_u) —
    no oversized seam faces).
    """
    t = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    C = np.stack([np.sin(t) + 2 * np.sin(2 * t),
                  np.cos(t) - 2 * np.cos(2 * t),
                  -np.sin(3 * t)], axis=1) * scale
    T = np.roll(C, -1, 0) - np.roll(C, 1, 0)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    # parallel transport an initial normal around the curve
    N = np.zeros_like(C)
    n0 = np.array([0.0, 0.0, 1.0])
    for i in range(n_u):
        n0 = n0 - T[i] * np.dot(n0, T[i])
        n0 /= np.linalg.norm(n0)
        N[i] = n0
    B = np.cross(T, N)
    # holonomy: transport once more across the seam and measure the
    # angle to N[0]; untwist by -theta*i/n_u so the seam closes clean
    n_end = n0 - T[0] * np.dot(n0, T[0])
    n_end /= np.linalg.norm(n_end)
    theta = np.arctan2(np.dot(np.cross(N[0], n_end), T[0]),
                       np.dot(N[0], n_end))
    a = -(theta * np.arange(n_u) / n_u)[:, None]
    N, B = (np.cos(a) * N + np.sin(a) * B,
            -np.sin(a) * N + np.cos(a) * B)
    phi = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * N[None] +
            np.sin(phi)[:, None, None] * B[None])     # [n_v, n_u, 3]
    verts = (C[None] + tube_r * ring).transpose(1, 0, 2).reshape(-1, 3)

    iu = np.arange(n_u)[:, None]
    iv = np.arange(n_v)[None, :]
    v00 = iu * n_v + iv
    v10 = ((iu + 1) % n_u) * n_v + iv
    v01 = iu * n_v + (iv + 1) % n_v
    v11 = ((iu + 1) % n_u) * n_v + (iv + 1) % n_v
    faces = np.concatenate([
        np.stack([v00, v10, v11], axis=-1).reshape(-1, 3),
        np.stack([v00, v11, v01], axis=-1).reshape(-1, 3),
    ]).astype(np.int32)
    # orient outward: flip all faces if the signed volume is negative
    v64 = verts.astype(np.float64)
    vol6 = np.einsum("ij,ij->i", v64[faces[:, 0]],
                     np.cross(v64[faces[:, 1]], v64[faces[:, 2]])).sum()
    if vol6 < 0:
        faces = faces[:, [0, 2, 1]]
    return verts.astype(np.float32), faces


def write_synthetic_bop_root(root, mesh_fps, n_frames=96,
                             subsets=("test",), im_hw=(480, 640),
                             K=None, seed=0, z_range=(0.4, 0.6),
                             obj_id=1, splat=3, render_mult=16,
                             eval_meshes=False, mm_depth=False,
                             background_z=None, depth_noise=0.0):
    """Fabricate a BOP-format dataset ON DISK at production shapes.

    Full-frame rgb / depth (uint16 png, depth_scale 0.1) / mask_visib
    renders of each object (make_object layout, xyz mm) at random poses
    — one SCENE per object — plus scene_gt / scene_gt_info /
    scene_camera JSONs, train.txt, a real_det.json detection file
    (GT-box-derived, score 0.9 + one decoy) and kps/obj_{id:06d}_fps.npy:
    everything data.bop.build_index / build_index_infer and PoseDataset
    read.

    Args:
      mesh_fps: a single [n, 9] fps array (written as `obj_id`), or a
        dict {obj_id: fps array} — each object gets its own scene.
      n_frames: frames per scene, or a dict {obj_id: frames}.
      subsets: subsets to write; 'train_pbr' frames are JPEG, the
        others PNG.
      eval_meshes: also write models_eval/obj_XXXXXX.ply (convex hull
        of the fps points, BOP millimetres).
      mm_depth: depth PNGs in millimetres (depth_scale 1, YCB-V's real
        and synt frames) instead of 0.1 mm counts (depth_scale 0.1).
      background_z: depth in metres of a flat background facing the
        camera wherever no object point lands (a captured frame's
        table and walls); None leaves those pixels without depth, as in
        an object-only render.  Colour and mask stay the object's.
      depth_noise: standard deviation in metres of Gaussian noise added
        to every pixel with depth (a depth sensor's), drawn from a
        generator of its own so the poses stay those of ``seed``.

    Returns the root path.
    """
    from scipy.spatial.transform import Rotation

    imh, imw = im_hw
    if K is None:
        K = np.array([[572.4, 0, imw / 2.0], [0, 573.6, imh / 2.0],
                      [0, 0, 1]], np.float32)
    meshes = mesh_fps if isinstance(mesh_fps, dict) else {obj_id: mesh_fps}
    rng = np.random.RandomState(seed)
    noise = np.random.RandomState(seed + 7919)
    os.makedirs(os.path.join(root, "kps"), exist_ok=True)
    renders = {}
    for oid, fps in meshes.items():
        np.save(os.path.join(root, "kps", f"obj_{oid:06d}_fps.npy"), fps)
        # dense same-surface point set for hole-free splatting
        # (make_object's radius is a pure function of direction)
        radius = float(np.linalg.norm(fps[:, :3], axis=1).max()) / 1300.0
        dense = make_object(max(render_mult * len(fps), 8192), rng,
                            radius=radius)
        renders[oid] = (dense[:, :3] / 1000.0,
                        dense[:, 3:6].astype(np.uint8))
        if eval_meshes:
            from scipy.spatial import ConvexHull

            from gdm_tpu_torch.data.ply import write_ply

            os.makedirs(os.path.join(root, "models_eval"), exist_ok=True)
            hull = ConvexHull(fps[:, :3])
            write_ply(os.path.join(root, "models_eval",
                                   f"obj_{oid:06d}.ply"),
                      fps[:, :3], faces=hull.simplices)

    for subset in subsets:
        ext = "jpg" if subset == "train_pbr" else "png"
        lines, det = [], {}
        for scene_id, (oid, (rpts, colors)) in enumerate(renders.items()):
            sdir = os.path.join(root, subset, f"{scene_id:06d}")
            for sub in ("rgb", "depth", "mask_visib"):
                os.makedirs(os.path.join(sdir, sub), exist_ok=True)
            gt, gt_info, cams = {}, {}, {}
            n = n_frames[oid] if isinstance(n_frames, dict) else n_frames
            for i in range(n):
                R = Rotation.random(
                    random_state=seed * 10000 + 997 * scene_id + i
                ).as_matrix()
                t = np.array([rng.uniform(-0.05, 0.05),
                              rng.uniform(-0.05, 0.05),
                              rng.uniform(*z_range)])
                cam = rpts @ R.T + t
                z = cam[:, 2]
                u = (cam[:, 0] * K[0, 0] / z + K[0, 2]).round().astype(int)
                v = (cam[:, 1] * K[1, 1] / z + K[1, 2]).round().astype(int)
                depth = np.zeros((imh, imw), np.float32)
                rgb = np.full((imh, imw, 3), 96, np.uint8)
                mask = np.zeros((imh, imw), np.uint8)
                order = np.argsort(-z)
                for du in range(splat):
                    for dv in range(splat):
                        uu = u[order] + du
                        vv = v[order] + dv
                        ok = (uu >= 0) & (uu < imw) & (vv >= 0) & (vv < imh)
                        depth[vv[ok], uu[ok]] = z[order][ok]
                        rgb[vv[ok], uu[ok]] = colors[order][ok]
                        mask[vv[ok], uu[ok]] = 255
                if background_z is not None:
                    depth[mask == 0] = background_z
                if depth_noise:
                    has = depth > 0
                    depth[has] += noise.normal(0.0, depth_noise,
                                               int(has.sum()))
                ys, xs = np.nonzero(mask)
                bbox = [int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min() + 1),
                        int(ys.max() - ys.min() + 1)]
                rgb_path = os.path.join(sdir, f"rgb/{i:06d}.{ext}")
                if ext == "jpg":
                    imwrite_jpeg(rgb_path, rgb, quality=95)
                else:
                    imwrite_png(rgb_path, rgb)
                imwrite_png(os.path.join(sdir, f"depth/{i:06d}.png"),
                            (depth * (1000 if mm_depth else 10000)
                             ).astype(np.uint16))
                imwrite_png(os.path.join(
                    sdir, f"mask_visib/{i:06d}_000000.png"), mask)
                gt[str(i)] = [{"obj_id": oid,
                               "cam_R_m2c": R.ravel().tolist(),
                               "cam_t_m2c": (t * 1000).tolist()}]
                gt_info[str(i)] = [{
                    "bbox_obj": bbox,
                    "px_count_visib": int((mask > 0).sum())}]
                cams[str(i)] = {"cam_K": np.asarray(K).ravel().tolist(),
                                "depth_scale": 1.0 if mm_depth else 0.1}
                x1, y1, w, h = bbox
                det[f"{scene_id}/{i}"] = {str(oid): [
                    {"score": 0.3, "bbox": [0, 0, 6, 6]},       # decoy
                    {"score": 0.9, "bbox": [x1, y1, x1 + w, y1 + h]},
                ]}
                lines.append(f"{scene_id:06d}/{i:06d}")
            for name, obj in (("scene_gt", gt),
                              ("scene_gt_info", gt_info),
                              ("scene_camera", cams)):
                with open(os.path.join(sdir, f"{name}.json"), "w") as f:
                    json.dump(obj, f)
        with open(os.path.join(root, subset, "train.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(root, subset, "real_det.json"), "w") as f:
            json.dump(det, f)
    return root


def write_synthetic_lmfull_root(root, mesh_fps, n_test, n_train,
                                im_hw=(480, 640), K=None, seed=0, obj_id=1,
                                background=("test", "real", "fuse")):
    """An LM-full-shaped BOP tree for one object: ``n_test`` ``test``
    frames (PNG, depth_scale 0.1) and ``n_train`` frames of each of the
    preset's train subsets ``real``, ``fuse`` and ``renders`` (PNG, depth
    in millimetres, depth_scale 1, as LINEMOD's are: the loaders divide
    those subsets' depth by 1000).  The subsets named in ``background``
    have a flat background 0.8 m away, so that a crop holds more valid
    depth than the object, as a captured or fused frame does; the others
    hold the object alone, as a render does.  Every depth carries 1 mm of
    noise, as a sensor's does: at LM-full's sampling density the points
    are nearly the whole pixel lattice, and noise-free depth makes their
    distances tie in exact arithmetic.

    Returns the root path."""
    for i, subset in enumerate(("test", "real", "fuse", "renders")):
        write_synthetic_bop_root(
            root, mesh_fps, n_train if i else n_test, subsets=(subset,),
            im_hw=im_hw, K=K, seed=seed + i, obj_id=obj_id,
            mm_depth=bool(i), depth_noise=0.001,
            background_z=0.8 if subset in background else None)
    return root


def write_synthetic_ycbv_root(root, meshes, n_test, train_obj, n_train,
                              im_hw=(480, 640), seed=0, diameters_mm=None,
                              sym_ids=()):
    """A YCB-V-shaped BOP tree (tests/test_ycbv_e2e.py's mini tree at any
    size): ``test`` frames of every object (``n_test``: frames per object,
    or {obj_id: frames}; PNG, depth_scale 0.1), and for ``train_obj``
    ``n_train`` frames of each train subset: ``train_real`` and
    ``train_synt`` (PNG, depth in millimetres) and ``train_pbr`` (JPEG,
    depth_scale 0.1), plus models/models_info.json (``diameters_mm``
    {obj_id: mm}, a continuous z symmetry for each of ``sym_ids``).

    Returns the root path."""
    kw = dict(im_hw=im_hw, seed=seed)
    write_synthetic_bop_root(root, meshes, n_test, subsets=("test",), **kw)
    one = {train_obj: meshes[train_obj]}
    write_synthetic_bop_root(root, one, n_train, subsets=("train_pbr",),
                             **kw)
    write_synthetic_bop_root(root, one, n_train,
                             subsets=("train_real", "train_synt"),
                             mm_depth=True, **kw)
    diameters_mm = diameters_mm or {}
    info = {str(oid): {"diameter": float(diameters_mm.get(
        oid, 2.0 * np.linalg.norm(fps[:, :3], axis=1).max()))}
        for oid, fps in meshes.items()}
    for oid in sym_ids:
        info[str(oid)]["symmetries_continuous"] = [
            {"axis": [0, 0, 1], "offset": [0, 0, 0]}]
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    with open(os.path.join(root, "models", "models_info.json"), "w") as f:
        json.dump(info, f)
    return root

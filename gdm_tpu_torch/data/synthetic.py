"""A synthetic BOP dataset on disk, for tests and the smoke run.

Counterpart of gdm_tpu/data/synthetic.py's ``make_object`` and
``write_synthetic_bop_root``: the same objects, poses, frames, JSONs and
detections from the same seed.  Frames are written with the port's PNG
encoder (data/imio.imwrite_png) in place of PIL, so the files differ
byte for byte but decode to the same pixels.  Only PNG subsets (the
``test`` split) are written: JPEG (``train_pbr``) waits for the training
slice.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gdm_tpu_torch.data.imio import imwrite_png


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


def write_synthetic_bop_root(root, mesh_fps, n_frames=96,
                             subsets=("test",), im_hw=(480, 640),
                             K=None, seed=0, z_range=(0.4, 0.6),
                             obj_id=1, splat=3, render_mult=16,
                             eval_meshes=False):
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
      subsets: PNG subsets to write (a 'pbr' subset, JPEG, raises).
      eval_meshes: also write models_eval/obj_XXXXXX.ply (convex hull
        of the fps points, BOP millimetres).

    Returns the root path.
    """
    from scipy.spatial.transform import Rotation

    for subset in subsets:
        if "pbr" in subset:
            raise NotImplementedError(
                f"subset {subset!r}: pbr frames are JPEG, and the port "
                "writes PNG only")
    imh, imw = im_hw
    if K is None:
        K = np.array([[572.4, 0, imw / 2.0], [0, 573.6, imh / 2.0],
                      [0, 0, 1]], np.float32)
    meshes = mesh_fps if isinstance(mesh_fps, dict) else {obj_id: mesh_fps}
    rng = np.random.RandomState(seed)
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
        lines, det = [], {}
        for scene_id, (oid, (rpts, colors)) in enumerate(renders.items()):
            sdir = os.path.join(root, subset, f"{scene_id:06d}")
            for sub in ("rgb", "depth", "mask_visib"):
                os.makedirs(os.path.join(sdir, sub), exist_ok=True)
            gt, gt_info, cams = {}, {}, {}
            for i in range(n_frames):
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
                ys, xs = np.nonzero(mask)
                bbox = [int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min() + 1),
                        int(ys.max() - ys.min() + 1)]
                imwrite_png(os.path.join(sdir, f"rgb/{i:06d}.png"), rgb)
                imwrite_png(os.path.join(sdir, f"depth/{i:06d}.png"),
                            (depth * 10000).astype(np.uint16))
                imwrite_png(os.path.join(
                    sdir, f"mask_visib/{i:06d}_000000.png"), mask)
                gt[str(i)] = [{"obj_id": oid,
                               "cam_R_m2c": R.ravel().tolist(),
                               "cam_t_m2c": (t * 1000).tolist()}]
                gt_info[str(i)] = [{
                    "bbox_obj": bbox,
                    "px_count_visib": int((mask > 0).sum())}]
                cams[str(i)] = {"cam_K": np.asarray(K).ravel().tolist(),
                                "depth_scale": 0.1}
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

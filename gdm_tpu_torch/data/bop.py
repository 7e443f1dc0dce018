"""BOP-format annotation index (host side).

A copy of gdm_tpu/data/bop.py (jax-free, but its package imports jax);
the tests hold the records equal field by field.

Reference: datasets/lm/linemod_pbr.py:123-267 (load_subset_dicts) and
datasets/ycbv/ycbv_pbr.py equivalents — scans a subset's ``train.txt``
frame index, loads the per-scene ``scene_gt.json`` / ``scene_gt_info.json``
/ ``scene_camera.json``, and (test mode) the Mask-RCNN detection file
``real_det.json``, producing one flat record per (frame, object instance).

Deviations from the reference (deliberate):
  * JSON caches are shared across subsets instead of re-read per call;
  * invalid-box / missing-detection counters are returned, not printed.
"""

from __future__ import annotations

import json
import os.path as osp
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Record:
    """One object instance in one frame."""

    rgb_file: str
    depth_file: str
    mask_file: str
    cam_K: np.ndarray            # [3, 3]
    depth_factor: float          # raw depth / depth_factor = metres
    bbox: tuple                  # GT xyxy, image-clipped
    pose: np.ndarray             # [3, 4] GT (R | t), metres
    obj_id: int
    img_type: str                # 'pbr' | 'real' | 'synt' | 'test'
    file_name: str = ""          # 'SSSSSS/IIIIII' (test)
    bbox_est: tuple | None = None  # detector box (test), None = missed
    scene_id: int = 0
    im_id: int = 0


@dataclass
class IndexStats:
    invalid_box: int = 0
    missed_det: dict = field(default_factory=dict)   # obj_id -> count
    found_det: dict = field(default_factory=dict)


def _load_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def load_detections(path: str) -> dict:
    """real_det.json: {'scene/im': {obj_id_str: [{'score', 'bbox'}]}}
    (linemod_pbr.py:129-133,203-221).  Returns the best box per object:
    {'scene/im': {obj_id int: xyxy int tuple}}."""
    raw = _load_json(path)
    best = {}
    for key, per_obj in raw.items():
        best[key] = {}
        for obj_s, dets in per_obj.items():
            top = max(dets, key=lambda d: d["score"], default=None)
            if top is not None:
                best[key][int(obj_s)] = tuple(
                    int(v) for v in top["bbox"])
    return best


def _read_frame_index(img_root: str) -> list[tuple[int, int]]:
    """Sorted (scene_id, im_id) pairs from the subset's train.txt."""
    pairs = []
    with open(osp.join(img_root, "train.txt"), "r") as f:
        for line in f:
            s, i = line.strip("\r\n").split("/")[:2]
            pairs.append((int(s), int(i)))
    return sorted(pairs)


def _frame_camera(cam_cache: dict, img_root: str, scene_id: int,
                  im_id: int):
    """(K [3,3] f32, depth_factor) from the scene_camera.json cache."""
    if scene_id not in cam_cache:
        cam_cache[scene_id] = _load_json(osp.join(
            img_root, f"{scene_id:06d}", "scene_camera.json"))
    cam = cam_cache[scene_id][str(im_id)]
    K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
    return K, 1000.0 / cam["depth_scale"]


def _clamp_box(x1, y1, x2, y2, im_w, im_h):
    """Image-clipped xyxy tuple, or None when degenerate (<=1 px side)."""
    box = (max(min(x1, im_w), 0), max(min(y1, im_h), 0),
           max(min(x2, im_w), 0), max(min(y2, im_h), 0))
    if box[2] - box[0] <= 1 or box[3] - box[1] <= 1:
        return None
    return box


def _img_type(subset: str, mode: str) -> str:
    """'pbr' | 'synt' | 'real' | 'test' per subset name.

    Depth-scaling parity note: non-pbr train frames divide depth by 1000
    here ('real'), while the reference's LM loader tags them "test" and
    divides by depth_factor = 1000/depth_scale (linemod_pbr.py:181-183,
    428-431).  Identical whenever scene_camera depth_scale == 1.0 — true
    for every LINEMOD-family BOP subset including lm_full's
    real/fuse/renders; YCB-V real frames use /1000 in the reference too
    (ycbv_pbr.py:190,429-433), which this rule matches exactly.
    """
    if mode == "test":
        return "test"
    if "pbr" in subset:
        return "pbr"
    if "synt" in subset:
        return "synt"
    return "real"


def build_index(
    data_root: str,
    subset: str,
    obj_ids,
    mode: str,
    im_hw=(480, 640),
    selected_id: int | None = None,
    min_visib_px: int = 30,
    detections: dict | None = None,
) -> tuple[list[Record], IndexStats]:
    """Scan one subset directory and emit Records.

    Args:
      data_root: dataset root; subset dir = data_root/subset.
      subset: e.g. 'train_pbr', 'train_real', 'test'.
      obj_ids: accepted object ids.
      mode: 'train' | 'test'.
      selected_id: train mode keeps only this object
        (linemod_pbr.py:192-193).
      detections: preloaded load_detections() result (test mode).
    """
    img_root = osp.join(data_root, subset)
    im_h, im_w = im_hw
    obj_ids = list(obj_ids)
    stats = IndexStats(
        missed_det={o: 0 for o in obj_ids},
        found_det={o: 0 for o in obj_ids})
    img_ext = "jpg" if "pbr" in subset else "png"

    gt_cache, info_cache, cam_cache = {}, {}, {}
    records = []
    for scene_id, im_id in _read_frame_index(img_root):
        if scene_id not in gt_cache:
            sdir = osp.join(img_root, f"{scene_id:06d}")
            gt_cache[scene_id] = _load_json(osp.join(sdir, "scene_gt.json"))
            info_cache[scene_id] = _load_json(
                osp.join(sdir, "scene_gt_info.json"))
        key = str(im_id)
        K, depth_factor = _frame_camera(cam_cache, img_root, scene_id,
                                        im_id)
        base = osp.join(img_root, f"{scene_id:06d}")
        rgb_path = osp.join(base, f"rgb/{im_id:06d}.{img_ext}")
        depth_path = osp.join(base, f"depth/{im_id:06d}.png")

        for anno_i, anno in enumerate(gt_cache[scene_id][key]):
            info = info_cache[scene_id][key][anno_i]
            obj_id = anno["obj_id"]
            if mode == "train" and selected_id is not None \
                    and obj_id != selected_id:
                continue
            if obj_id not in obj_ids or info["px_count_visib"] < min_visib_px:
                continue

            R = np.array(anno["cam_R_m2c"], np.float32).reshape(3, 3)
            t = np.array(anno["cam_t_m2c"], np.float32) / 1000.0
            pose = np.hstack([R, t.reshape(3, 1)])

            x1, y1, w, h = info["bbox_obj"]
            bbox = _clamp_box(x1, y1, x1 + w, y1 + h, im_w, im_h)
            if bbox is None:
                stats.invalid_box += 1
                continue

            rec = Record(
                rgb_file=rgb_path, depth_file=depth_path,
                mask_file=osp.join(
                    base, f"mask_visib/{im_id:06d}_{anno_i:06d}.png"),
                cam_K=K, depth_factor=depth_factor, bbox=bbox, pose=pose,
                obj_id=obj_id, img_type=_img_type(subset, mode),
                scene_id=scene_id, im_id=im_id)
            if mode == "test":
                rec.file_name = f"{scene_id:06d}/{im_id:06d}"
                det = (detections or {}).get(
                    f"{scene_id}/{im_id}", {}).get(obj_id)
                rec.bbox_est = det
                if det is None:
                    stats.missed_det[obj_id] += 1
                else:
                    stats.found_det[obj_id] += 1
            records.append(rec)
    return records, stats


def build_index_infer(
    data_root: str,
    subset: str,
    obj_ids,
    im_hw=(480, 640),
    detections: dict | None = None,
    selected_id: int | None = None,
) -> tuple[list[Record], IndexStats]:
    """GT-less index for deployment inference (`cli infer`).

    The reference cannot run without ground truth — its test loader
    reads scene_gt.json for masks and poses even at inference
    (linemod_pbr.py:145-201).  This scans only scene_camera.json plus a
    detection file, emitting one Record per detected object instance:
    pose/bbox/mask fields are placeholders, bbox_est carries the
    detector box.  Frames come from the subset's train.txt when present,
    else from the detection keys.
    """
    img_root = osp.join(data_root, subset)
    im_h, im_w = im_hw
    obj_ids = list(obj_ids)
    detections = detections or {}
    stats = IndexStats(
        missed_det={o: 0 for o in obj_ids},
        found_det={o: 0 for o in obj_ids})
    img_ext = "jpg" if "pbr" in subset else "png"

    if osp.exists(osp.join(img_root, "train.txt")):
        scene_im_ids = _read_frame_index(img_root)
    else:
        scene_im_ids = sorted(set(
            tuple(int(v) for v in key.split("/")[:2])
            for key in detections))

    cam_cache = {}
    records = []
    no_pose = np.zeros((3, 4), np.float32)
    for scene_id, im_id in scene_im_ids:
        K, depth_factor = _frame_camera(cam_cache, img_root, scene_id,
                                        im_id)
        base = osp.join(img_root, f"{scene_id:06d}")
        dets = detections.get(f"{scene_id}/{im_id}", {})
        for obj_id in obj_ids:
            if selected_id is not None and obj_id != selected_id:
                continue
            box = dets.get(obj_id)
            if box is None:
                stats.missed_det[obj_id] += 1
                continue
            x1, y1, x2, y2 = box
            box = _clamp_box(x1, y1, x2, y2, im_w, im_h)
            if box is None:
                stats.invalid_box += 1
                continue
            stats.found_det[obj_id] += 1
            records.append(Record(
                rgb_file=osp.join(base, f"rgb/{im_id:06d}.{img_ext}"),
                depth_file=osp.join(base, f"depth/{im_id:06d}.png"),
                mask_file="", cam_K=K, depth_factor=depth_factor,
                bbox=box, pose=no_pose, obj_id=obj_id, img_type="test",
                file_name=f"{scene_id:06d}/{im_id:06d}", bbox_est=box,
                scene_id=scene_id, im_id=im_id))
    return records, stats


def aug_bbox_dzi(
    bbox_xyxy,
    rng: np.random.RandomState,
    scale_ratio: float = 0.25,
    shift_ratio: float = 0.25,
    pad_ratio: float = 1.5,
    im_hw=(480, 640),
    test: bool = False,
):
    """Dynamic-zoom-in square crop window (linemod_pbr.py:99-120).

    Returns (center [2], scale float): the window is
    [center - scale/2, center + scale/2] in pixels.
    """
    x1, y1, x2, y2 = bbox_xyxy
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    if test:
        s_r, sh = 1.0, np.zeros(2)
    else:
        s_r = 1 + scale_ratio * (2 * rng.random_sample() - 1)
        sh = shift_ratio * (2 * rng.random_sample(2) - 1)
    center = np.array([cx + bw * sh[0], cy + bh * sh[1]], np.float32)
    scale = min(max(bh, bw) * s_r * pad_ratio, max(im_hw))
    return center, float(scale)

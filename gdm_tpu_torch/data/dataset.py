"""BOP pose-estimation dataset for evaluation and deployment inference.

Counterpart of gdm_tpu/data/dataset.py (reference
datasets/lm/linemod_pbr.py:24-670) in its ``test`` and ``infer`` modes.
The host decodes the frame (data/imio, a numpy PNG codec), crops the DZI
window (data/crop, bit-equal to cv2.warpAffine) and samples the scene
points; the device does the rest (data/pipeline).

Per-sample output keys (numpy), the ones inference and scoring read:
  rgb_u8 [S,S,3] uint8, dpt_u16 [S,S] uint16 (cropped raw counts),
  dpt_scale f32 scalar (dpt_m = dpt_u16 / dpt_scale), K_crop [3,3] f32,
  choose [N] i32, RT [3,4] f32 (GT pose; zeros in infer mode), K [3,3]
  f32, cls_id / det (i32) and file_name (str, via meta).

Sampling keeps the JAX package's per-index rng, RandomState((7919 * idx
+ 13) % 2**31), and its choose draw, so ``choose`` is bit-equal.

Not ported yet: ``train`` mode and the GT-generation keys (labels,
match_idx, visible_flag: the losses read them), so ``test`` mode reads no
mask; ``data.fill_depth`` (YCB-V's depth fill) raises.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from gdm_tpu_torch.configs import Config
from gdm_tpu_torch.data import bop
from gdm_tpu_torch.data.crop import (
    INTER_LINEAR,
    INTER_NEAREST,
    crop_affine_matrix,
    crop_resize_by_warp_affine,
)
from gdm_tpu_torch.data.imio import imread_rgb, imread_u16


class PoseDataset:
    """One-object BOP dataset (the reference runs one model per cls_id).

    Args:
      cfg: preset Config (gdm_tpu_torch.configs).
      cls_id: the selected object id.
      mode: 'test' (GT annotations + detections) or 'infer' (GT-less:
        scene_camera + a detection file only; RT is a zero placeholder).
      data_root: the BOP dataset directory (default cfg.data.data_root).
      detections_file: detection JSON (default <subset>/real_det.json).
    """

    def __init__(self, cfg: Config, cls_id: int, mode: str,
                 data_root: str | None = None,
                 detections_file: str | None = None):
        if mode not in ("test", "infer"):
            raise NotImplementedError(
                f"PoseDataset mode {mode!r}: only 'test' and 'infer' are "
                "ported (training comes with the training slice)")
        d = cfg.data
        if d.fill_depth:
            raise NotImplementedError(
                "data.fill_depth (depth fill of the crop, YCB-V) is not "
                "ported")
        self.cfg = cfg
        self.cls_id = int(cls_id)
        self.mode = mode
        self.in_size = d.input_size
        self.n_sample = d.num_sample_points
        self.im_hw = tuple(d.img_hw)
        root = data_root or d.data_root
        self.annos: list[bop.Record] = []
        for subset in d.test_subsets:
            dets = bop.load_detections(
                detections_file or osp.join(root, subset, "real_det.json"))
            if mode == "infer":
                recs, _ = bop.build_index_infer(
                    root, subset, d.obj_ids, im_hw=self.im_hw,
                    detections=dets, selected_id=cls_id)
            else:
                recs, _ = bop.build_index(
                    root, subset, d.obj_ids, mode, im_hw=self.im_hw,
                    detections=dets)
                # per-object evaluation keeps only cls_id's instances
                recs = [r for r in recs if r.obj_id == self.cls_id]
            self.annos += recs

    def __len__(self):
        return len(self.annos)

    def __getitem__(self, idx: int) -> dict:
        # per-index rng: point sampling is the same whatever the loader's
        # thread scheduling, and the same as the JAX package's
        return self.get_item(
            self.annos[idx],
            np.random.RandomState((7919 * idx + 13) % (2 ** 31)))

    def get_item(self, rec: bop.Record, rng: np.random.RandomState) -> dict:
        rgb = imread_rgb(rec.rgb_file)
        dpt_raw = imread_u16(rec.depth_file)        # counts, never metres
        # counts-per-metre divisor (linemod_pbr.py:428-431); test and
        # infer records are 'test' frames.  Depth stays uint16 through
        # the nearest-neighbour crop.
        divisor = float(rec.depth_factor)
        K = rec.cam_K

        det = 1
        if rec.bbox_est is not None and rec.bbox_est[2] != 0:
            bbox = rec.bbox_est
        else:
            det = 0
            bbox = rec.bbox

        dcfg = self.cfg.data
        center, scale = bop.aug_bbox_dzi(
            bbox, rng, dcfg.dzi_scale_ratio, dcfg.dzi_shift_ratio,
            dcfg.dzi_pad_ratio, self.im_hw, test=True)

        S = self.in_size
        rgb_c = crop_resize_by_warp_affine(
            rgb, center, scale, S, interpolation=INTER_LINEAR)
        dptc_u16 = crop_resize_by_warp_affine(
            dpt_raw, center, scale, S, interpolation=INTER_NEAREST)
        K_crop = (crop_affine_matrix(center, scale, S) @ K).astype(
            np.float32)

        choose = np.nonzero((dptc_u16 > 0).ravel())[0]
        if len(choose) == 0:
            choose = np.array([0])
        if len(choose) > self.n_sample:           # linemod_pbr.py:485-496
            keep = np.zeros(len(choose), int)
            keep[:self.n_sample] = 1
            rng.shuffle(keep)
            choose = choose[keep.nonzero()[0]]
        else:
            choose = np.pad(choose, (0, self.n_sample - len(choose)),
                            "wrap")
        rng.shuffle(choose)

        return {
            "rgb_u8": rgb_c,
            "dpt_u16": dptc_u16,
            "dpt_scale": np.float32(divisor),
            "K_crop": K_crop,
            "choose": choose.astype(np.int32),
            "RT": rec.pose.astype(np.float32),
            "K": K.astype(np.float32),
            "cls_id": np.int32(rec.obj_id),
            "det": np.int32(det),
            "file_name": rec.file_name,
        }

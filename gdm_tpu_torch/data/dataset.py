"""BOP pose-estimation dataset for training, evaluation and inference.

Counterpart of gdm_tpu/data/dataset.py (reference
datasets/lm/linemod_pbr.py:24-670) in its ``train``, ``test`` and
``infer`` modes.  The host decodes the frame (data/imio: PNG in numpy,
JPEG in C++), crops the DZI window (data/crop, bit-equal to
cv2.warpAffine), samples the scene points and, with GT, generates the
correspondences (data/gt_gen); the device does the rest (data/pipeline).

Per-sample output keys (numpy):
  rgb_u8 [S,S,3] uint8, dpt_u16 [S,S] uint16 (cropped raw counts),
  dpt_scale f32 scalar (dpt_m = dpt_u16 / dpt_scale), dpt_filled [S,S]
  f32 (the depth-filled crop in metres, only with data.fill_depth),
  K_crop [3,3] f32, choose [N] i32, RT [3,4] f32 (GT pose; zeros in
  infer mode), K [3,3] f32; train adds the GT keys the losses read:
  labels / origin_labels [N] u8, match_idx [N] u16 (i32 for meshes of
  >= 65535 vertices), visible_flag [M] u8; test and infer add cls_id / det (i32) and
  file_name (str, via meta).  Test mode reads no mask and generates no
  GT (the JAX package computes evaluator-side labels there that no
  consumer of the port reads; they would cost ~12 ms per sample).

As in the JAX package, and bit-equal to it:
  * ``test``/``infer`` sample with the per-index rng RandomState((7919 *
    idx + 13) % 2**31); ``train`` with a per-(seed, epoch, index) rng, so
    the train stream is the same whatever the loader's workers;
  * ``train`` crops a jittered DZI window, rejects samples with fewer
    than 200 valid pixels or no valid GT match and redraws another index
    from the same rng (linemod_pbr.py:479,509,662-670);
  * the GT match threshold is 0.01 m for LM-family training (the
    reference's hardcode, linemod_pbr.py:641), nn_dist_th x diameter for
    YCB-V;
  * each annotation's HPR visibility is computed once and cached
    bit-packed (data.cache_visibility);
  * YCB-V (ycbv_pbr.py:352-387,468-506,663-690): with
    ``data.real_pbr_mix`` a train item draws a real record with that
    probability, else a pbr one, whatever its index; a ``synt`` train
    crop gets the photometric noise, a real frame's background behind
    the object and, at p = 0.2, the noise again (data/augment); with
    ``data.fill_depth`` the points are chosen on the filled crop
    (``dpt_filled``), their xyz still coming from the raw counts.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from gdm_tpu_torch.configs import Config
from gdm_tpu_torch.data import bop
from gdm_tpu_torch.data.augment import (
    add_real_background,
    fill_depth_fast,
    rgb_add_noise,
)
from gdm_tpu_torch.data.crop import (
    INTER_LINEAR,
    INTER_NEAREST,
    crop_affine_matrix,
    crop_resize_by_warp_affine,
)
from gdm_tpu_torch.data.gt_gen import pose_gt_info, pose_visibility
from gdm_tpu_torch.data.imio import imread_mask, imread_rgb, imread_u16

class PoseDataset:
    """One-object BOP dataset (the reference runs one model per cls_id).

    Args:
      cfg: preset Config (gdm_tpu_torch.configs).
      cls_id: the selected object id.
      mode: 'train' (the train subsets, jittered crops, GT
        correspondences), 'test' (GT annotations + detections) or 'infer'
        (GT-less: scene_camera + a detection file only; the GT keys are
        placeholders).
      mesh_fps: optional preloaded [M, 9] fps mesh (xyz m | rgb | nrm)
        for GT generation; in train mode by default loaded from
        <data_root>/kps or built from the PLY.
      diameter_m: the object's diameter in metres; YCB-V training
        matches GT within data.nn_dist_th x diameter_m.
      rng: np.random.RandomState whose first draw seeds the train
        stream (default RandomState(0)).
      data_root: the BOP dataset directory (default cfg.data.data_root).
      detections_file: detection JSON (default <subset>/real_det.json).
    """

    def __init__(self, cfg: Config, cls_id: int, mode: str,
                 mesh_fps: np.ndarray | None = None,
                 rng: np.random.RandomState | None = None,
                 data_root: str | None = None,
                 detections_file: str | None = None,
                 diameter_m: float | None = None):
        if mode not in ("train", "test", "infer"):
            raise ValueError(f"PoseDataset mode {mode!r}")
        d = cfg.data
        self.cfg = cfg
        self.cls_id = int(cls_id)
        self.mode = mode
        self.in_size = d.input_size
        self.n_sample = d.num_sample_points
        self.im_hw = tuple(d.img_hw)
        self.rng = rng if rng is not None else np.random.RandomState(0)
        # base of the per-sample rng of train mode, drawn from the
        # caller's rng so that seeds and processes diverge
        self._seed_base = int(self.rng.randint(2 ** 31))
        self.epoch = 0
        root = data_root or d.data_root
        if mode == "train" and mesh_fps is None:
            from gdm_tpu_torch.data.ply import load_or_build_fps_mesh
            mesh_fps = load_or_build_fps_mesh(root, cls_id, d.model_pt_num)
        self.mesh_pts = None if mesh_fps is None else mesh_fps[:, :3]
        if mode == "train" and d.name == "ycbv":
            if diameter_m is None:
                raise ValueError("YCB-V training needs the object's "
                                 "diameter_m (GT match threshold)")
            self.gt_match_th_m = d.nn_dist_th * diameter_m
        else:
            self.gt_match_th_m = 0.01       # linemod_pbr.py:641 hardcode
        self.annos: list[bop.Record] = []
        self.real_annos: list[bop.Record] = []
        self.pbr_annos: list[bop.Record] = []
        subsets = d.train_subsets if mode == "train" else d.test_subsets
        for subset in subsets:
            if mode == "train":
                recs, _ = bop.build_index(
                    root, subset, d.obj_ids, mode, im_hw=self.im_hw,
                    selected_id=cls_id)
                self.annos += recs
                if "pbr" in subset:
                    self.pbr_annos += recs
                else:
                    self.real_annos += recs
                continue
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
        self.mix_real = d.real_pbr_mix if mode == "train" else None
        self.fill_depth = d.fill_depth
        self.add_noise = mode == "train" and d.name == "ycbv"
        # per-annotation HPR visibility, bit-packed (n_mesh / 8 bytes);
        # each loader worker process holds its own copy
        self._vis_cache: dict[int, np.ndarray] | None = (
            {} if d.cache_visibility else None)

    def __len__(self):
        return len(self.annos)

    def set_epoch(self, epoch: int):
        """Mix the epoch into the train rng (DataLoader.set_epoch)."""
        self.epoch = epoch

    def _pick_record(self, idx: int, rng: np.random.RandomState
                     ) -> bop.Record:
        """The train record of ``idx``: with the real/pbr mix, a real
        record with probability mix_real, else a pbr one, drawn from
        ``rng`` whatever ``idx`` is (ycbv_pbr.py:682-690)."""
        if self.mode != "train" or self.mix_real is None \
                or not self.real_annos or not self.pbr_annos:
            return self.annos[idx]
        if rng.rand() < self.mix_real:
            return self.real_annos[rng.randint(len(self.real_annos))]
        return self.pbr_annos[rng.randint(len(self.pbr_annos))]

    def __getitem__(self, idx: int) -> dict:
        if self.mode == "train":
            rng = np.random.RandomState(
                (self._seed_base + 7919 * idx + 104729 * self.epoch)
                % (2 ** 31))
            data = self.get_item(self._pick_record(idx, rng), rng)
            while data is None:
                data = self.get_item(
                    self._pick_record(rng.randint(len(self)), rng), rng)
            return data
        # per-index rng: point sampling is the same whatever the loader's
        # thread scheduling, and the same as the JAX package's
        return self.get_item(
            self.annos[idx],
            np.random.RandomState((7919 * idx + 13) % (2 ** 31)))

    def _visibility(self, rec: bop.Record) -> np.ndarray:
        """pose_visibility of ``rec``, cached by record identity."""
        rp = self.cfg.data.hpr_radius_param
        if self._vis_cache is None:
            return pose_visibility(rec.pose, self.mesh_pts, radius_param=rp)
        packed = self._vis_cache.get(id(rec))
        if packed is None:
            flag = pose_visibility(rec.pose, self.mesh_pts, radius_param=rp)
            self._vis_cache[id(rec)] = np.packbits(flag)
            return flag
        return np.unpackbits(packed, count=len(self.mesh_pts))

    def get_item(self, rec: bop.Record,
                 rng: np.random.RandomState) -> dict | None:
        """One sample of ``rec``, or None for a train sample to redraw."""
        train = self.mode == "train"
        rgb = imread_rgb(rec.rgb_file)
        dpt_raw = imread_u16(rec.depth_file)        # counts, never metres
        # counts-per-metre divisor (linemod_pbr.py:428-431).  Depth stays
        # uint16 through the nearest-neighbour crop.
        divisor = float(rec.depth_factor) \
            if rec.img_type in ("pbr", "test") else 1000.0
        K = rec.cam_K

        det = 1
        if train:
            bbox = rec.bbox
        elif rec.bbox_est is not None and rec.bbox_est[2] != 0:
            bbox = rec.bbox_est
        else:
            det = 0
            bbox = rec.bbox

        dcfg = self.cfg.data
        center, scale = bop.aug_bbox_dzi(
            bbox, rng, dcfg.dzi_scale_ratio, dcfg.dzi_shift_ratio,
            dcfg.dzi_pad_ratio, self.im_hw, test=not train)

        S = self.in_size
        rgb_c = crop_resize_by_warp_affine(
            rgb, center, scale, S, interpolation=INTER_LINEAR)
        dptc_u16 = crop_resize_by_warp_affine(
            dpt_raw, center, scale, S, interpolation=INTER_NEAREST)
        K_crop = (crop_affine_matrix(center, scale, S) @ K).astype(
            np.float32)
        mask_c = None
        if train:
            mask_c = crop_resize_by_warp_affine(
                imread_mask(rec.mask_file), center, scale, S,
                interpolation=INTER_NEAREST)

        if self.add_noise and rec.img_type == "synt":
            rgb_c = rgb_add_noise(rgb_c, rng)
            if self.real_annos:
                dpt_c = dptc_u16.astype(np.float32) / divisor
                rgb_c, dpt_c = add_real_background(
                    rgb_c, mask_c, dpt_c, (dptc_u16 > 0).astype(np.uint8),
                    self.real_annos, rng, S, self.im_hw)
                # back to counts: exact for the crop's own pixels, the
                # nearest count for pasted real depth
                dptc_u16 = np.clip(np.round(dpt_c * divisor), 0,
                                   65535).astype(np.uint16)
            if rng.rand() > 0.8:
                rgb_c = rgb_add_noise(rgb_c, rng)

        dpt_filled = None
        if self.fill_depth:
            dpt_filled = fill_depth_fast(
                dptc_u16.astype(np.float32) / divisor)
            valid_px = dpt_filled > 1e-6
        else:
            valid_px = dptc_u16 > 0           # counts >= 1 <=> > 1e-6 m

        choose = np.nonzero(valid_px.ravel())[0]
        if len(choose) < 200 and train:
            return None
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
        choose = choose.astype(np.int32)

        item = {
            "rgb_u8": rgb_c.astype(np.uint8, copy=False),
            "dpt_u16": dptc_u16,
            "dpt_scale": np.float32(divisor),
            "K_crop": K_crop,
            "choose": choose,
            "RT": rec.pose.astype(np.float32),
            "K": K.astype(np.float32),
        }
        if dpt_filled is not None:
            item["dpt_filled"] = dpt_filled
        if not train:
            item["cls_id"] = np.int32(rec.obj_id)
            item["det"] = np.int32(det)
            item["file_name"] = rec.file_name
            return item

        # backprojection of the chosen pixels only, for GT generation (the
        # device recomputes the full xyz image from the depth counts)
        z = dptc_u16.ravel()[choose].astype(np.float32) / divisor
        uu = (choose % S).astype(np.float32)
        vv = (choose // S).astype(np.float32)
        x = (uu - K_crop[0, 2]) * z / K_crop[0, 0]
        y = (vv - K_crop[1, 2]) * z / K_crop[1, 1]
        cld = np.nan_to_num(np.stack([x, y, z], -1), posinf=0.0,
                            neginf=0.0)
        labels_pt = mask_c.ravel()[choose]
        labels_pt[labels_pt == 255] = 1
        labels, match_idx, visible_flag, valid = pose_gt_info(
            cld, labels_pt, rec.pose, self.mesh_pts,
            nn_dist_th=self.gt_match_th_m,
            visible_flag=lambda: self._visibility(rec))
        if not valid:
            return None
        # the no-match sentinel is len(mesh_pts): u16 needs m + 1 values
        midx_dtype = np.uint16 if len(self.mesh_pts) < 65535 else np.int32
        item.update(
            labels=labels.astype(np.uint8, copy=False),
            origin_labels=labels_pt.astype(np.uint8, copy=False),
            match_idx=match_idx.astype(midx_dtype, copy=False),
            visible_flag=visible_flag)
        return item

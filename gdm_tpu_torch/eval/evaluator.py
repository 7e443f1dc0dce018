"""Pose evaluation bookkeeping (host side).

Reference: evaluator.py Evaluator (:140-486) — accumulates per-object pose
predictions, computes ADD/ADD-S + re/te/proj recalls at the reference's
thresholds (:321-338,408-427), prints a table (:468-473), dumps a
BOP-format CSV (:339,369-376,429-431) and errors/recalls pickles.

Counterpart of gdm_tpu/eval/evaluator.py, with the same recalls, errors,
AUC, BOP19 AR (MSSD, MSPD, and with ``vsd_meshes`` VSD and the combined
BOP19 AR), CSV and pickles.  The table is a plain fixed-width formatter
(the GPU host has no tabulate) that prints what tabulate's "plain" format
prints.  VSD renders on ``device`` (eval/vsd.py, the card unless the
caller asks for the CPU); test depth PNGs are read with data/imio.

As in the JAX package, ADD(-S) AUC (VOC style, 0.1m cap) is reported
directly: it is the headline number the papers quote, which the
reference computes only in its legacy eval utils.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from collections import OrderedDict

import numpy as np

from gdm_tpu_torch.eval.metrics import (
    add_err,
    adi_err,
    get_closest_rot,
    mspd_err,
    mssd_err,
    proj_err,
    proj_sym_err,
    re_err,
    re_sym_err,
    te_err,
    te_sym_err,
    voc_auc,
)

METRIC_NAMES = [
    "ad_2", "ad_5", "ad_10", "ad_0.1",
    "rete_2", "rete_5", "rete_10",
    "re_2", "re_5", "re_10",
    "te_2", "te_5", "te_10",
    "proj_2", "proj_5", "proj_10",
    # reference offline-eval single-threshold recalls
    # (eval_calc_scores.py:16-18 correct_th mssd=0.2, mspd=10)
    "mssd_0.2", "mspd_10",
]

# BOP19 average-recall threshold grids (bop.felk.cvut.cz/challenges/
# bop-challenge-2019; the reference computes the underlying errors at
# pose_error.py:131-180 and thresholds them in eval_calc_scores.py with
# mssd normalised by diameter and mspd by image width)
BOP19_MSSD_THS = tuple(float(t) for t in np.arange(0.05, 0.51, 0.05))
BOP19_MSPD_THS = tuple(float(t) for t in np.arange(5.0, 50.1, 5.0))
BOP19_VSD_THS = tuple(float(t) for t in np.arange(0.05, 0.51, 0.05))


class Evaluator:
    """Accumulate predictions; evaluate against GT annotations.

    Args:
      dataset_name: refdata key ('lmo'/'lm_full'/'ycbv').
      obj_names: evaluated object names.
      diameters: {obj_name: diameter_m}.
      models_pts: {obj_name: [n, 3] eval-model points (metres)}.
      sym_objs: names treated as symmetric (ADD-S + closest-rot).
      sym_rots: {obj_name: [K, 3, 3] symmetry rotations or None}.
      output_dir: where table/CSV/pickles are written (None = no files).
      obj2id: {obj_name: BOP object id} for the CSV.
      vsd_meshes: {obj_name: (verts_m [V, 3], faces [F, 3])} enables
        BOP VSD for those objects; their gt entries then carry the test
        depth ('depth' array, or 'depth_file' + 'depth_factor').
      sym_transforms: {obj_name: [(R, t_m)]} BOP symmetry transforms
        for MSSD/MSPD; objects without an entry use the identity.
      im_w: image width for the 640-px MSPD normalisation.
      device: where VSD renders and scores ('cuda' or 'cpu').
    """

    def __init__(self, dataset_name, obj_names, diameters, models_pts,
                 sym_objs=(), sym_rots=None, output_dir=None,
                 obj2id=None, vsd_meshes=None, sym_transforms=None,
                 im_w=640, device="cuda"):
        self.dataset_name = dataset_name
        self.obj_names = list(obj_names)
        self.diameters = diameters
        self.models_pts = models_pts
        self.sym_objs = set(sym_objs)
        # dict args keep the CALLER's dict object (not a copy, and not
        # replaced when empty): cli.evaluate() creates the Evaluator while
        # iterating objects and fills these dicts for later objects —
        # `sym_rots or {}` would silently detach them whenever the first
        # object happens to have no entry yet
        self.sym_rots = sym_rots if sym_rots is not None else {}
        self.output_dir = output_dir
        self.obj2id = obj2id if obj2id is not None else {}
        self.vsd_meshes = vsd_meshes if vsd_meshes is not None else {}
        # {obj_name: [(R [3,3], t_m [3]), ...]} full BOP symmetry
        # transforms (misc.get_symmetry_transformations, translations in
        # METRES) for MSSD/MSPD; objects without an entry use identity
        self.sym_transforms = (sym_transforms
                               if sym_transforms is not None else {})
        self.im_w = im_w   # MSPD pixel thresholds are defined at 640 px
        self.device = device
        self.reset()

    def reset(self):
        self._predictions = OrderedDict()

    def add_prediction(self, obj_name, file_name, R, t, time=0.0, det=1):
        self._predictions.setdefault(obj_name, OrderedDict())[file_name] = {
            "R": np.asarray(R, np.float64),
            "t": np.asarray(t, np.float64).reshape(3, 1),
            "time": time,
            "det": det,
        }

    def gather(self, allgather_fn):
        """Merge the predictions of every process (gdm_tpu/eval/
        evaluator.py gather): ``allgather_fn(predictions)`` returns every
        process's predictions dict (parallel/mesh.all_gather_host).  Each
        object's frames follow in rank order."""
        merged = OrderedDict()
        for preds in allgather_fn(self._predictions):
            for k, v in preds.items():
                merged.setdefault(k, OrderedDict()).update(v)
        self._predictions = merged

    def evaluate(self, gts):
        """gts: {obj_name: {file_name: {'R','t','K'}}} (evaluator.py:256-270).

        Returns {'recalls', 'errors', 'auc', 'table'} — recalls in percent.
        """
        recalls = OrderedDict()
        errors = OrderedDict()
        aucs = OrderedDict()
        ars = OrderedDict()
        csv_lines = ["scene_id,im_id,obj_id,score,R,t,time"]

        for obj_name, obj_gts in gts.items():
            # an object with NO predictions at all (crashed loop, empty
            # detector output) counts as all-miss through the per-frame
            # sentinel path below — silently skipping it would INFLATE
            # the averaged table/AUC/AR exactly when a whole object fails
            cur_preds = self._predictions.get(obj_name, {})
            rec = {m: [] for m in METRIC_NAMES}
            err = {e: [] for e in ("ad", "re", "te", "proj",
                                   "mssd", "mspd", "mspd_640",
                                   "re_sym", "te_sym", "proj_sym")}
            syms = self.sym_transforms.get(obj_name)
            diameter = self.diameters[obj_name]
            pts = self.models_pts[obj_name]
            is_sym = obj_name in self.sym_objs
            do_vsd = obj_name in self.vsd_meshes
            if do_vsd:
                from gdm_tpu_torch.eval.vsd import BOP19_TAUS

                rec["vsd"] = []
                err["vsd"] = []
                # VSD renders run batched after the frame loop (one device
                # batch per window/z/K group); slots mark where each
                # frame's result lands so ordering matches the other
                # metrics
                vsd_poses, vsd_depths, vsd_ks, vsd_slots = [], [], [], []

            for file_name, gt in obj_gts.items():
                if file_name not in cur_preds:
                    # a GT frame with no prediction counts as a failure in
                    # EVERY statistic: recalls get 0, error curves get a
                    # sentinel so voc_auc averages over all GT frames like
                    # the reference (it pushes an entry per frame via the
                    # sentinel pose, evaluator.py:70-97).  Table re/te
                    # means skip the non-finite sentinels.
                    for m in rec:
                        rec[m].append(0.0)
                    for e in err:
                        err[e].append(
                            np.full(len(BOP19_TAUS), np.inf)
                            if e == "vsd" else np.inf)
                    continue
                pred = cur_preds[file_name]
                R_pred, t_pred = pred["R"], pred["t"]
                R_gt, t_gt = np.asarray(gt["R"]), np.asarray(
                    gt["t"]).reshape(3, 1)
                K = np.asarray(gt["K"])

                if "/" in file_name:
                    scene_id, im_id = file_name.split("/")[:2]
                    csv_lines.append(
                        f"{int(scene_id)},{im_id},"
                        f"{self.obj2id.get(obj_name, -1)},-1,"
                        f"{' '.join(map(str, R_pred.flatten().tolist()))},"
                        f"{' '.join(map(str, (t_pred * 1000).flatten().tolist()))},"
                        f"{pred.get('time', -1)}")

                t_error = te_err(t_pred, t_gt)
                if is_sym:
                    R_gt_sym = get_closest_rot(
                        R_pred, R_gt, self.sym_rots.get(obj_name))
                    r_error = re_err(R_pred, R_gt_sym)
                    p_error = proj_err(R_pred, t_pred.ravel(), R_gt_sym,
                                       t_gt.ravel(), pts, K)
                    ad_error = adi_err(R_pred, t_pred.ravel(), R_gt,
                                       t_gt.ravel(), pts)
                else:
                    r_error = re_err(R_pred, R_gt)
                    p_error = proj_err(R_pred, t_pred.ravel(), R_gt,
                                       t_gt.ravel(), pts, K)
                    ad_error = add_err(R_pred, t_pred.ravel(), R_gt,
                                       t_gt.ravel(), pts)

                err["ad"].append(ad_error)
                err["re"].append(r_error)
                err["te"].append(t_error)
                err["proj"].append(p_error)

                mssd_e = mssd_err(R_pred, t_pred, R_gt, t_gt.ravel(),
                                  pts, syms)
                mspd_e = mspd_err(R_pred, t_pred, R_gt, t_gt.ravel(),
                                  pts, K, syms)
                err["mssd"].append(mssd_e)
                err["mspd"].append(mspd_e)
                # full-sym-transform error variants (the offline scorer's
                # reS/teS/projS, eval_calc_errors.py:431-450) — reported
                # in the errors pickle alongside the closest-rot online
                # variants above
                err["re_sym"].append(re_sym_err(R_pred, R_gt, syms))
                err["te_sym"].append(te_sym_err(t_pred, t_gt, R_gt, syms))
                err["proj_sym"].append(proj_sym_err(
                    R_pred, t_pred.ravel(), R_gt, t_gt.ravel(), pts, K,
                    syms))
                im_w = float(gt.get("im_w", self.im_w))
                # 640-width-normalised mspd stored per frame so AR_MSPD
                # honours per-frame image widths exactly like mspd_10
                # (pose_error.py mspd normalises by width per image)
                err["mspd_640"].append(mspd_e * 640.0 / im_w)
                rec["mssd_0.2"].append(float(mssd_e / diameter < 0.2))
                rec["mspd_10"].append(
                    float(mspd_e * 640.0 / im_w < 10.0))

                rec["ad_2"].append(float(ad_error < 0.02 * diameter))
                rec["ad_5"].append(float(ad_error < 0.05 * diameter))
                rec["ad_10"].append(float(ad_error < 0.10 * diameter))
                rec["ad_0.1"].append(float(ad_error < 0.1))
                rec["rete_2"].append(float(r_error < 2 and t_error < 0.02))
                rec["rete_5"].append(float(r_error < 5 and t_error < 0.05))
                rec["rete_10"].append(float(r_error < 10 and t_error < 0.1))
                rec["re_2"].append(float(r_error < 2))
                rec["re_5"].append(float(r_error < 5))
                rec["re_10"].append(float(r_error < 10))
                rec["te_2"].append(float(t_error < 0.02))
                rec["te_5"].append(float(t_error < 0.05))
                rec["te_10"].append(float(t_error < 0.1))
                rec["proj_2"].append(float(p_error < 2))
                rec["proj_5"].append(float(p_error < 5))
                rec["proj_10"].append(float(p_error < 10))

                if do_vsd:
                    depth = self._gt_depth(gt)
                    if depth is not None:
                        vsd_poses.append((R_pred, t_pred.ravel(),
                                          R_gt, t_gt.ravel()))
                        vsd_depths.append(depth)
                        vsd_ks.append(np.asarray(K, np.float64))
                        vsd_slots.append(len(err["vsd"]))
                        err["vsd"].append(None)
                        rec["vsd"].append(None)
                    # flush in bounded chunks: full-frame f32 depths are
                    # ~1.2 MB each, and vsd_err_batch crops each to a small
                    # window first
                    if len(vsd_poses) >= self._VSD_FLUSH:
                        self._flush_vsd(obj_name, diameter, vsd_poses,
                                        vsd_depths, vsd_ks, vsd_slots,
                                        err, rec)

            if do_vsd and vsd_poses:
                self._flush_vsd(obj_name, diameter, vsd_poses,
                                vsd_depths, vsd_ks, vsd_slots, err, rec)

            recalls[obj_name] = rec
            errors[obj_name] = err
            aucs[obj_name] = voc_auc(err["ad"], max_dis=0.1)
            ars[obj_name] = self._bop19_ar(err, diameter, do_vsd=do_vsd)

        table = self._format_table(recalls, errors, aucs, ars)
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(osp.join(self.output_dir,
                               f"_{self.dataset_name}_tab.txt"), "w") as f:
                f.write(table + "\n")
            with open(osp.join(self.output_dir,
                               f"gt_{self.dataset_name}-test.csv"),
                      "w") as f:
                f.write("\n".join(csv_lines))
            for nm, obj in (("errors", errors), ("recalls", recalls)):
                with open(osp.join(
                        self.output_dir,
                        f"_{self.dataset_name}_{nm}.pkl"), "wb") as f:
                    pickle.dump(obj, f)
        return {"recalls": recalls, "errors": errors, "auc": aucs,
                "bop19_ar": ars, "table": table}

    @staticmethod
    def _bop19_ar(err, diameter, do_vsd):
        """BOP19 average recalls for one object.

        AR_MSSD over thresholds 0.05..0.5 x diameter, AR_MSPD over
        5..50 px at 640-width normalisation, AR_VSD over thresholds
        0.05..0.5 x the tau grid, and their mean (the BOP19 AR) when VSD
        is available.  Missing-frame sentinels (inf) count as misses at
        every threshold.
        """
        out = {}
        mssd = np.asarray(err["mssd"], np.float64) / diameter
        out["ar_mssd"] = float(np.mean(
            [(mssd < th).mean() for th in BOP19_MSSD_THS])) \
            if mssd.size else 0.0
        mspd = np.asarray(err["mspd_640"], np.float64)
        out["ar_mspd"] = float(np.mean(
            [(mspd < th).mean() for th in BOP19_MSPD_THS])) \
            if mspd.size else 0.0
        if do_vsd and len(err.get("vsd", ())):
            vsd = np.stack([np.asarray(v, np.float64)
                            for v in err["vsd"]])       # [n, n_taus]
            out["ar_vsd"] = float(np.mean(
                [(vsd < th).mean() for th in BOP19_VSD_THS]))
            out["bop19_ar"] = float(np.mean(
                [out["ar_vsd"], out["ar_mssd"], out["ar_mspd"]]))
        return out

    @staticmethod
    def _gt_depth(gt):
        """Test depth (metres) for a gt entry, or None if unavailable."""
        if "depth" in gt:
            return np.asarray(gt["depth"], np.float32)
        if "depth_file" in gt:
            from gdm_tpu_torch.data.imio import imread_u16

            d = imread_u16(gt["depth_file"]).astype(np.float32)
            return d / float(gt.get("depth_factor", 1000.0))
        return None

    _VSD_FLUSH = 128    # frames per vsd_err_batch call (~150 MB depths)

    def _flush_vsd(self, obj_name, diameter, vsd_poses, vsd_depths,
                   vsd_ks, vsd_slots, err, rec):
        """Render+score the accumulated VSD frames, write their slots,
        and clear the accumulators (lists are mutated in place)."""
        from gdm_tpu_torch.eval.vsd import BOP19_CORRECT_TH, vsd_err_batch

        verts, faces_ = self.vsd_meshes[obj_name]
        ves = vsd_err_batch(vsd_poses, vsd_depths, np.stack(vsd_ks),
                            verts, faces_, diameter, device=self.device)
        for slot, ve in zip(vsd_slots, ves):
            # the full per-tau error vector (the reference's offline eval
            # stores errors per tau too)
            err["vsd"][slot] = np.asarray(ve, np.float64)
            rec["vsd"][slot] = float(np.mean(ve < BOP19_CORRECT_TH[0]))
        for acc in (vsd_poses, vsd_depths, vsd_ks, vsd_slots):
            acc.clear()

    @staticmethod
    def _format_table(recalls, errors, aucs, ars=None):
        obj_names = sorted(recalls.keys())
        header = ["objects"] + obj_names + [f"Avg({len(obj_names)})"]
        rows = [header]
        metric_names = list(METRIC_NAMES)
        if any("vsd" in recalls[o] for o in obj_names):
            metric_names.append("vsd")
        for m in metric_names:
            # same convention as the AR rows: objects that were never
            # evaluated on this metric print '-' and stay out of the
            # average instead of counting as 0.0
            vals = [100 * np.mean(recalls[o][m]) for o in obj_names
                    if recalls[o].get(m)]
            cells = [f"{100 * np.mean(recalls[o][m]):.2f}"
                     if recalls[o].get(m) else "-" for o in obj_names]
            rows.append([m] + cells
                        + [f"{np.mean(vals):.2f}" if vals else "-"])
        for e in ("re", "te"):
            # mean over predicted frames only (missing-frame sentinels
            # are inf; their failure is already counted in the recalls)
            vals = []
            for o in obj_names:
                a = np.asarray(errors[o][e], np.float64)
                a = a[np.isfinite(a)]
                vals.append(a.mean() if a.size else np.nan)
            rows.append([e] + [f"{v:.2f}" for v in vals]
                        + [f"{np.nanmean(vals):.2f}"])
        auc_vals = [aucs[o] for o in obj_names]
        rows.append(["auc_ad"] + [f"{v:.2f}" for v in auc_vals]
                    + [f"{np.mean(auc_vals):.2f}" if auc_vals else "0.00"])
        if ars:
            for key in ("ar_vsd", "ar_mssd", "ar_mspd", "bop19_ar"):
                if not any(key in ars.get(o, {}) for o in obj_names):
                    continue
                vals = [100 * ars[o][key] for o in obj_names
                        if key in ars.get(o, {})]
                cells = [f"{100 * ars[o][key]:.2f}"
                         if key in ars.get(o, {}) else "-"
                         for o in obj_names]
                rows.append([key] + cells + [f"{np.mean(vals):.2f}"])
        return plain_table(rows)


def plain_table(rows) -> str:
    """Rows of strings as tabulate's "plain" format lays them out when
    every column holds a string: cells left-aligned to the column's
    widest, two spaces between columns, trailing blanks cut."""
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    return "\n".join("  ".join(cell.ljust(w) for cell, w in zip(r, widths))
                     .rstrip() for r in rows)

"""Multi-object inference: a mixed-object batch, each row fitted with its
own object's model.

Counterpart of gdm_tpu/eval/multimodel.py.  The JAX package stacks every
object's parameters along an object axis and each row gathers its slice
inside one compiled program.  Here each object keeps its own
serve.PoseEngine (model, mesh graph, mesh features encoded once, ICP
gate), and the host, which knows every row's object from the loader
(``obj_pos``), sends the rows to their models: scheduling needs no value
from the device.  Two schedules, as in the JAX package:

* ``by_class`` (``make_multi_model_infer_by_class``, the CLI default):
  the rows are stably sorted by object, and each run of at most
  ``group`` same-object rows goes through one forward and one pose fit,
  i.e. one launch of the similarity kernel: sum over objects c of
  ceil(n_c / group) forwards per batch.
* ``vmap`` (``make_multi_model_infer``): what the JAX vmap computes, a
  forward and a pose fit of batch 1 per row.  The JAX package scans the
  rows in groups of gcd(batch, 16) to bound its gathered weights; a row
  here reaches its model directly, so nothing is grouped.

The index pyramid is built once for the whole batch, and the groups
take their rows of it.  Poses come back in row order.
"""

from __future__ import annotations

import numpy as np
import torch

from gdm_tpu_torch.data.pipeline import (
    assemble_inputs,
    finalize_batch,
    to_device,
)
from gdm_tpu_torch.eval.infer import forward_fit
from gdm_tpu_torch.serve import PoseEngine, full_f32

SCHEDULES = ("by_class", "vmap")


def row_groups(obj_idx: np.ndarray, schedule: str = "by_class",
               group: int = 4) -> list[tuple[int, np.ndarray]]:
    """The forwards of a batch: (object position, its row ids) each.

    by_class: a stable sort of the rows by object, cut into runs of at
    most ``group`` rows of one object; vmap: one row each, in row
    order."""
    obj_idx = np.asarray(obj_idx)
    if schedule == "vmap":
        return [(int(c), np.array([i])) for i, c in enumerate(obj_idx)]
    if schedule != "by_class":
        raise ValueError(f"schedule {schedule!r}: want one of {SCHEDULES}")
    order = np.argsort(obj_idx, kind="stable")
    out = []
    for c in np.unique(obj_idx):
        rows = order[obj_idx[order] == c]
        out += [(int(c), rows[s:s + group])
                for s in range(0, len(rows), group)]
    return out


class MultiObjectEngine:
    """Mixed-object GeoMatch inference on one device.

    Args:
      engines: one PoseEngine per object, on one device, built with the
        same batch, KNN chunk, refinement and depth fill; ``obj_pos`` p
        selects ``engines[p]``, whose ``icp_reject`` gates its rows' ICP.
      schedule: 'by_class' or 'vmap' (see the module docstring).
      group: rows per forward of the by_class schedule.

    ``meta['raw_spec']`` is the engines' plus ``obj_pos`` [batch] int32,
    so that serve-style callers hand the rows' objects in with the
    arrays.
    """

    def __init__(self, engines: list[PoseEngine], schedule: str = "by_class",
                 group: int = 4):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule {schedule!r}: want one of "
                             f"{SCHEDULES}")
        if group < 1:
            raise ValueError(f"group {group}: want >= 1")
        e0 = engines[0]
        for e in engines[1:]:
            if (e.device, e.knn_chunk, e.refine, e.fill_depth) != (
                    e0.device, e0.knn_chunk, e0.refine, e0.fill_depth):
                raise ValueError("engines differ in device, KNN chunk, "
                                 "refinement or depth fill")
        self.engines, self.schedule, self.group = engines, schedule, group
        self.device, self.knn_chunk = e0.device, e0.knn_chunk
        self.fill_depth = e0.fill_depth
        batch = e0.meta["raw_spec"]["choose"][0][0]
        self.meta = dict(e0.meta, schedule=schedule, group=group,
                         objects=len(engines),
                         icp_reject_m=[e.icp_reject for e in engines])
        self.meta["raw_spec"] = dict(sorted(dict(
            e0.meta["raw_spec"], obj_pos=[[batch], "int32"]).items()))
        # what each row's fit used on the last batch: 'idx', 'w', 'rgbd'
        # and 'obj_pos' (the row's mesh features are engines[p].mesh_feats)
        self.last_fit: dict | None = None

    def finalize(self, raw: dict) -> dict:
        """Host arrays (see meta['raw_spec']) -> finalized device batch;
        ``obj_pos`` stays on the host."""
        fin = finalize_batch(to_device(
            {k: v for k, v in raw.items() if k != "obj_pos"}, self.device),
            self.fill_depth)
        fin["obj_pos"] = np.asarray(raw["obj_pos"])
        return fin

    @torch.no_grad()
    def infer(self, fin: dict) -> torch.Tensor:
        """Finalized batch -> poses [B, 3, 4] on the device."""
        obj_pos = fin["obj_pos"]
        groups = row_groups(obj_pos, self.schedule, self.group)
        with full_f32():
            inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"],
                                     fin["choose"], fin["xyz_img"],
                                     self.knn_chunk)
            cld, det = fin["cld_rgb_nrm"][..., :3], fin.get("det")
            b, n = cld.shape[:2]
            poses = torch.empty(b, 3, 4, device=cld.device)
            w = torch.empty(b, n, device=cld.device)
            idx = torch.empty(b, n, dtype=torch.int64, device=cld.device)
            rgbd = None
            # one upload of every group's row ids
            rows_all = torch.as_tensor(np.concatenate([r for _, r in groups]),
                                       device=cld.device)
            s = 0
            for c, rows in groups:
                r = rows_all[s:s + len(rows)]
                s += len(rows)
                e = self.engines[c]
                p, fit = forward_fit(
                    e.model, {k: v[r] for k, v in inputs.items()}, cld[r],
                    None if det is None else det[r], e.mesh, e.mesh_feats,
                    e.refine, e.icp_reject)
                if rgbd is None:
                    rgbd = torch.empty(b, n, fit["rgbd"].shape[-1],
                                       device=cld.device)
                poses[r], w[r], idx[r], rgbd[r] = p, fit["w"], fit["idx"], \
                    fit["rgbd"]
        self.last_fit = {"idx": idx, "w": w, "rgbd": rgbd,
                         "obj_pos": obj_pos}
        return poses

    def run(self, raw: dict) -> np.ndarray:
        """finalize + infer; numpy poses."""
        return self.infer(self.finalize(raw)).cpu().numpy()

"""Shared metadata helpers (reference ref/*.py get_models_info)."""

from __future__ import annotations

import json
import os.path as osp


def load_models_info(model_dir: str) -> dict:
    """BOP models_info.json keyed by str(obj_id) (ref/lmo.py:90-95)."""
    path = osp.join(model_dir, "models_info.json")
    with open(path, "r") as f:
        return json.load(f)


def symmetry_transform(model_info: dict):
    """First discrete symmetry (R, t_mm) of a model, or None.

    Mirrors the usage at SplineCNN.py:163-169 / evaluator.py:49-55: the
    reference's cal_sys_idx uses sym_transforms[1] — the identity is [0],
    so [1] is the first nontrivial discrete symmetry.  Continuous
    symmetries are discretised by the caller.
    """
    import numpy as np

    if "symmetries_discrete" in model_info:
        m = np.array(model_info["symmetries_discrete"][0],
                     dtype=np.float64).reshape(4, 4)
        return m[:3, :3], m[:3, 3]
    if "symmetries_continuous" in model_info:
        axis = np.array(model_info["symmetries_continuous"][0]["axis"],
                        dtype=np.float64)
        offset = np.array(
            model_info["symmetries_continuous"][0].get("offset", [0, 0, 0]),
            dtype=np.float64)
        # discretise at pi (the dominant sym used by cal_sys_idx)
        from scipy.spatial.transform import Rotation

        R = Rotation.from_rotvec(axis * 3.141592653589793).as_matrix()
        t = offset - R @ offset
        return R, t
    return None


def all_symmetry_transforms(model_info: dict,
                            max_sym_disc_step: float = 0.01):
    """Full (R, t) symmetry set for BOP MSSD/MSPD
    (misc.get_symmetry_transformations parity, misc.py:206-255): discrete
    symmetries verbatim (identity first), continuous ones discretised to
    ceil(pi / max_sym_disc_step) steps, and the two sets composed.

    Returns a list of (R [3,3], t [3]) with t in the model's units (mm for
    BOP models_info) — divide by 1000 for metre-space eval.
    """
    import numpy as np

    disc = [(np.eye(3), np.zeros(3))]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.array(sym, dtype=np.float64).reshape(4, 4)
        disc.append((m[:3, :3], m[:3, 3]))

    cont = []
    for sym in model_info.get("symmetries_continuous", []):
        from scipy.spatial.transform import Rotation

        axis = np.array(sym["axis"], dtype=np.float64)
        offset = np.array(sym.get("offset", [0, 0, 0]), dtype=np.float64)
        n_steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / n_steps
        for i in range(1, n_steps):
            R = Rotation.from_rotvec(axis * (i * step)).as_matrix()
            cont.append((R, offset - R @ offset))

    if not cont:
        return disc
    out = []
    for Rd, td in disc:
        for Rc, tc in cont:
            out.append((Rc @ Rd, Rc @ td + tc))
    return out


def all_symmetry_rotations(model_info: dict, max_sym_disc_step: float = 0.01):
    """All symmetry rotations for eval (misc.get_symmetry_transformations
    parity: discrete ones verbatim; continuous discretised so that the
    max vertex displacement per step is max_sym_disc_step * diameter)."""
    import numpy as np

    Rs = [np.eye(3)]
    if "symmetries_discrete" in model_info:
        for m in model_info["symmetries_discrete"]:
            m = np.array(m, dtype=np.float64).reshape(4, 4)
            Rs.append(m[:3, :3])
    if "symmetries_continuous" in model_info:
        from scipy.spatial.transform import Rotation

        for sym in model_info["symmetries_continuous"]:
            axis = np.array(sym["axis"], dtype=np.float64)
            n_steps = max(int(np.ceil(np.pi / max_sym_disc_step)), 1)
            n_steps = min(n_steps, 64)
            for i in range(1, n_steps):
                ang = 2.0 * np.pi * i / n_steps
                Rs.append(Rotation.from_rotvec(axis * ang).as_matrix())
    return np.stack(Rs)

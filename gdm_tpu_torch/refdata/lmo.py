"""LineMOD-Occlusion metadata (reference ref/lmo.py)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from gdm_tpu_torch.refdata._base import load_models_info  # noqa: F401 (re-export)

name = "lmo"
objects = ["ape", "can", "cat", "driller", "duck", "eggbox", "glue",
           "holepuncher"]
id2obj = {
    1: "ape", 2: "benchvise", 3: "bowl", 4: "camera", 5: "can", 6: "cat",
    7: "cup", 8: "driller", 9: "duck", 10: "eggbox", 11: "glue",
    12: "holepuncher", 13: "iron", 14: "lamp", 15: "phone",
}
obj2id = {v: k for k, v in id2obj.items()}

# diameters (m) for the 8 lmo objects, ref/lmo.py:58-79
diameters = np.array(
    [102.099, 201.404, 154.546, 261.472, 108.999, 164.628, 175.889,
     145.543]) / 1000.0

# per-id diameters in mm for all 15 lm objects (config/lmo_cfg.py:6-23)
diameters_mm_by_id = {
    1: 102.099, 2: 247.506, 3: 167.355, 4: 172.492, 5: 201.404,
    6: 154.546, 7: 124.264, 8: 261.472, 9: 108.999, 10: 164.628,
    11: 175.889, 12: 145.543, 13: 278.078, 14: 282.601, 15: 212.358,
}

width, height = 640, 480
camera_matrix = np.array(
    [[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]])
vertex_scale = 0.001


def dataset_root(data_root: str) -> str:
    return osp.join(data_root, "lm", "linemod")


def model_dir(data_root: str) -> str:
    return osp.join(dataset_root(data_root), "models")


def model_eval_dir(data_root: str) -> str:
    return osp.join(dataset_root(data_root), "models_eval")


def kps_dir(data_root: str) -> str:
    return osp.join(dataset_root(data_root), "kps")


def get_models_info(data_root: str) -> dict:
    return load_models_info(model_dir(data_root))

"""LineMOD (full 13/15-object) metadata (reference ref/lm_full.py)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from gdm_tpu_torch.refdata._base import load_models_info  # noqa: F401

name = "lm_full"
objects = ["ape", "benchvise", "bowl", "camera", "can", "cat", "cup",
           "driller", "duck", "eggbox", "glue", "holepuncher", "iron",
           "lamp", "phone"]
id2obj = {i + 1: o for i, o in enumerate(objects)}
obj2id = {v: k for k, v in id2obj.items()}

diameters = np.array(
    [102.099, 247.506, 167.355, 172.492, 201.404, 154.546, 124.264,
     261.472, 108.999, 164.628, 175.889, 145.543, 278.078, 282.601,
     212.358]) / 1000.0
diameters_mm_by_id = {i + 1: float(d * 1000) for i, d in
                      enumerate(diameters)}

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

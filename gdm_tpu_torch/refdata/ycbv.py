"""YCB-Video metadata (reference ref/ycbv.py)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from gdm_tpu_torch.refdata._base import load_models_info  # noqa: F401

name = "ycbv"
id2obj = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle",
    6: "007_tuna_fish_can", 7: "008_pudding_box", 8: "009_gelatin_box",
    9: "010_potted_meat_can", 10: "011_banana", 11: "019_pitcher_base",
    12: "021_bleach_cleanser", 13: "024_bowl", 14: "025_mug",
    15: "035_power_drill", 16: "036_wood_block", 17: "037_scissors",
    18: "040_large_marker", 19: "051_large_clamp",
    20: "052_extra_large_clamp", 21: "061_foam_brick",
}
objects = sorted(id2obj.values())
obj2id = {v: k for k, v in id2obj.items()}

# indexed by obj_id - 1, metres (ref/ycbv.py:79-84)
_diam_mm = [172.063, 269.573, 198.377, 120.543, 196.463, 89.797, 142.543,
            114.053, 129.540, 197.796, 259.534, 259.566, 161.922, 124.990,
            226.170, 237.299, 203.973, 121.365, 174.746, 217.094, 102.903]
diameters = np.array([_diam_mm[obj2id[o] - 1] for o in objects]) / 1000.0
diameters_mm_by_id = {i + 1: d for i, d in enumerate(_diam_mm)}

width, height = 640, 480
# scenes 0000-0059 + synthetic (ref/ycbv.py:107)
camera_matrix = np.array(
    [[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0, 0, 1]])
cmu_camera_matrix = np.array(
    [[1077.836, 0.0, 323.7872], [0.0, 1078.189, 279.6921], [0, 0, 1]])
vertex_scale = 0.001
depth_factor = 10000.0

test_scenes = list(range(48, 60))
train_real_scenes = [i for i in range(92) if i not in test_scenes]
train_pbr_scenes = list(range(50))


def dataset_root(data_root: str) -> str:
    return osp.join(data_root, "ycbv", "ycbv")


def model_dir(data_root: str) -> str:
    return osp.join(dataset_root(data_root), "models")


def model_eval_dir(data_root: str) -> str:
    return osp.join(dataset_root(data_root), "models_eval")


def kps_dir(data_root: str) -> str:
    return osp.join(data_root, "ycb", "ycbv", "bop_ycb_kps")


def get_models_info(data_root: str) -> dict:
    return load_models_info(model_dir(data_root))

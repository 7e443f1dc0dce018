"""Shapes and widths of the served model.

Counterpart of the fields of gdm_tpu/configs/base.py that inference
reads, in the same ``config.data.*`` / ``config.model.*`` layout.
``LMO`` holds the values of the reference's LMO preset
(config/lmo_cfg.py).  Depth fill (ycbv) is not ported, so it has no
field here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    input_size: int = 256           # square crop side
    num_sample_points: int = 4096   # scene points sampled


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    feat_dim: int = 128
    n_mesh_node: int = 4096
    randla_d_out: Sequence[int] = (32, 64, 128, 256)
    mesh_knn_k: int = 4
    spline_kernel: int = 5


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig
    model: ModelConfig


LMO = Config(data=DataConfig(), model=ModelConfig())


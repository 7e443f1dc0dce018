"""Config dataclasses and the three dataset presets.

Counterpart of gdm_tpu/configs/base.py for the fields that inference,
the BOP loader and the eval CLI read, in the same ``config.data.*`` /
``config.model.*`` / ``config.solver.*`` layout and with the same preset
values (reference config/lmo_cfg.py, lmfull_cfg.py, ycbv_cfg.py).  Fields
of the training slice (train subsets, optimiser, schedules, backbone
choice) are not ported yet.  ``fill_depth`` is here because the YCB-V
preset sets it; the port's loader refuses it until depth fill is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DATASETS block (config/lmo_cfg.py:61-103)."""

    name: str                       # refdata registry key
    data_root: str = "datasets"
    test_subsets: Sequence[str] = ("test",)
    obj_ids: Sequence[int] = ()
    img_hw: tuple = (480, 640)
    dzi_scale_ratio: float = 0.25
    dzi_shift_ratio: float = 0.25
    dzi_pad_ratio: float = 1.5
    model_pt_num: int = 4096        # mesh vertices used
    num_sample_points: int = 4096   # scene points sampled
    nn_dist_th: float = 0.05        # x diameter: GT match outlier cutoff
    input_size: int = 256           # square crop side
    sym_objs: Sequence[str] = ()
    fill_depth: bool = False        # ycbv: ip_basic on the crop


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MODEL block (config/lmo_cfg.py:123-133), GeoMatch randla_spline."""

    feat_dim: int = 128
    n_mesh_node: int = 4096
    randla_d_out: Sequence[int] = (32, 64, 128, 256)
    mesh_knn_k: int = 4
    spline_kernel: int = 5


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    val_batch_size: int = 128       # the eval batch


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig
    model: ModelConfig
    solver: SolverConfig = SolverConfig()


LMO = Config(
    data=DataConfig(
        name="lmo",
        obj_ids=(1, 5, 6, 8, 9, 10, 11, 12),
        nn_dist_th=0.05,
        sym_objs=("eggbox",),
    ),
    model=ModelConfig(),
    solver=SolverConfig(val_batch_size=128),
)

LMFULL = Config(
    data=DataConfig(
        name="lm_full",
        obj_ids=tuple(range(1, 16)),
        num_sample_points=480 * 640 // 24,   # 12800 (lmfull_cfg.py:76)
        nn_dist_th=0.01,
        input_size=128,
        sym_objs=("eggbox",),
    ),
    model=ModelConfig(),
    solver=SolverConfig(val_batch_size=8),
)

YCBV = Config(
    data=DataConfig(
        name="ycbv",
        obj_ids=tuple(range(1, 22)),
        nn_dist_th=0.05,
        sym_objs=("024_bowl", "052_extra_large_clamp", "061_foam_brick"),
        fill_depth=True,
    ),
    model=ModelConfig(),
    solver=SolverConfig(val_batch_size=128),
)

_PRESETS = {"lmo": LMO, "lmfull": LMFULL, "lm_full": LMFULL, "ycbv": YCBV}


def _parse_value(path: str, old, raw: str):
    """``raw`` parsed with the type of the field's current value."""
    if isinstance(old, bool):
        low = raw.lower()
        if low in ("1", "true", "yes"):
            return True
        if low in ("0", "false", "no"):
            return False
        raise ValueError(f"--opt {path}: {raw!r} is not a boolean "
                         "(use true/false/1/0/yes/no)")
    if isinstance(old, (int, float)):
        return type(old)(raw)
    if isinstance(old, (tuple, list)):
        # each element takes the existing element type, so
        # model.randla_d_out=16,32 yields ints, not strings
        el = type(old[0]) if len(old) else str
        return type(old)(el(x) for x in raw.split(",")) if raw \
            else type(old)()
    return raw


def get_config(name: str, opts: Sequence[str] = ()) -> Config:
    """A preset, with optional 'section.field=value' overrides (cli
    --opt), each parsed with the existing field's type; a misspelt field
    raises AttributeError."""
    cfg = _PRESETS[name]
    for opt in opts:
        path, eq, raw = opt.partition("=")
        if not eq:
            raise ValueError(f"--opt needs key=value, got {opt!r}")
        section, _, field = path.partition(".")
        if not field:
            raise ValueError(f"--opt key must be section.field: {opt!r}")
        sub = getattr(cfg, section)
        val = _parse_value(path, getattr(sub, field), raw)
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: val})})
    return cfg

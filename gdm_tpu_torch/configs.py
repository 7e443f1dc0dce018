"""Config dataclasses and the three dataset presets.

Counterpart of gdm_tpu/configs/base.py for the fields that inference,
training, the BOP loader and the CLI read, in the same ``config.data.*``
/ ``config.model.*`` / ``config.solver.*`` layout and with the same
preset values (reference config/lmo_cfg.py, lmfull_cfg.py,
ycbv_cfg.py).  ``model.backbone`` picks the flagship ``randla_spline``
or ``dgcnn`` (config 5); any other name raises.  ``model.compute_dtype``
and ``model.gather_bwd_dtype`` take ``float32`` or ``bfloat16``; any
other value raises.  The field set is the JAX package's:
``model.randla_k``, ``solver.num_workers`` and ``checkpoints_dir`` are
taken and read by nothing (as there; the CLI refuses a ``randla_k`` other
than 16 and reads ``--num-workers``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DATASETS block (config/lmo_cfg.py:61-103)."""

    name: str                       # refdata registry key
    data_root: str = "datasets"
    train_subsets: Sequence[str] = ("train_pbr",)
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
    real_pbr_mix: float | None = None   # ycbv: p(real)=0.8 (ycbv_pbr.py:684)
    fill_depth: bool = False        # ycbv: ip_basic on the crop
    cache_visibility: bool = True   # cache each annotation's HPR visibility
    hpr_radius_param: float = 2.0   # HPR flip-radius exponent (the
    #   reference's pi: --opt data.hpr_radius_param=3.141592653589793)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MODEL block (config/lmo_cfg.py:123-133)."""

    feat_dim: int = 128
    n_mesh_node: int = 4096
    neighbor_dis_th: float = 0.02   # x diameter: circle-loss positive radius
    backbone: str = "randla_spline"  # or "dgcnn"
    compute_dtype: str = "float32"   # or "bfloat16": the encoder (both
    # DGCNN trunks) computes in it; parameters, BN statistics, heads,
    # losses and the flagship's mesh branch stay f32
    gather_bwd_dtype: str = "float32"  # or "bfloat16": the flagship's
    # neighbour-gather backward rounds each cotangent row to it (n >= 512)
    randla_d_out: Sequence[int] = (32, 64, 128, 256)
    randla_k: int = 16
    mesh_knn_k: int = 4
    spline_kernel: int = 5
    dgcnn_exact_knn: bool = False   # the JAX package's switch to exact
    # edge-conv graphs; the port's graphs are always exact
    pretrained_backbone: str = ""   # torchvision resnet .pth/.npz path:
    # ImageNet init of the CNN branch (cli train --pretrained-backbone)


BACKBONES = ("randla_spline", "dgcnn")
DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """SOLVER/DATALOADER blocks + what train_lm.py actually runs."""

    total_epochs: int = 50
    train_batch_size: int = 24
    val_batch_size: int = 128       # the eval batch
    base_lr: float = 1e-6           # CyclicLR (train_lm.py:441-447)
    max_lr: float = 1e-3
    clr_div: int = 6                # step_size = epochs*len/bs/div
    weight_decay: float = 0.0       # > 0: AdamW
    bn_momentum: float = 0.9        # torch convention (train_lm.py:53-57)
    bn_decay: float = 0.5
    bn_decay_step: float = 2e5
    bn_momentum_clip: float = 0.01
    checkpoint_every_epochs: int = 10
    num_workers: int = 4            # read by nothing: the CLI takes
    # --num-workers
    # non-finite-update guard (optax.apply_if_finite semantics): updates
    # whose gradients hold NaN/inf are skipped up to this many times in
    # a row, then pass through; 0 disables it
    skip_nonfinite: int = 5


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig
    model: ModelConfig
    solver: SolverConfig = SolverConfig()
    checkpoints_dir: str = "train_log/checkpoints"   # read by nothing


LMO = Config(
    data=DataConfig(
        name="lmo",
        obj_ids=(1, 5, 6, 8, 9, 10, 11, 12),
        nn_dist_th=0.05,
        sym_objs=("eggbox",),
    ),
    model=ModelConfig(neighbor_dis_th=0.02),
    solver=SolverConfig(total_epochs=50, train_batch_size=24,
                        val_batch_size=128),
)

LMFULL = Config(
    data=DataConfig(
        name="lm_full",
        train_subsets=("real", "fuse", "renders"),
        obj_ids=tuple(range(1, 16)),
        num_sample_points=480 * 640 // 24,   # 12800 (lmfull_cfg.py:76)
        nn_dist_th=0.01,
        input_size=128,
        sym_objs=("eggbox",),
    ),
    model=ModelConfig(neighbor_dis_th=0.02),
    solver=SolverConfig(total_epochs=50, train_batch_size=6,
                        val_batch_size=8),
)

YCBV = Config(
    data=DataConfig(
        name="ycbv",
        train_subsets=("train_real", "train_pbr"),
        obj_ids=tuple(range(1, 22)),
        nn_dist_th=0.05,
        sym_objs=("024_bowl", "052_extra_large_clamp", "061_foam_brick"),
        real_pbr_mix=0.8,
        fill_depth=True,
    ),
    model=ModelConfig(neighbor_dis_th=0.06),
    solver=SolverConfig(total_epochs=30, train_batch_size=8,
                        val_batch_size=128),
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
    if old is None:                 # an optional number (real_pbr_mix)
        return None if raw.lower() in ("none", "null") else float(raw)
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
        if path == "model.backbone" and raw not in BACKBONES:
            raise ValueError(f"--opt model.backbone={raw}: the backbones "
                             f"are {', '.join(BACKBONES)}")
        if path in ("model.compute_dtype", "model.gather_bwd_dtype") \
                and raw not in DTYPES:
            raise ValueError(f"--opt {path}={raw}: the dtypes are "
                             f"{', '.join(DTYPES)}")
        sub = getattr(cfg, section)
        val = _parse_value(path, getattr(sub, field), raw)
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: val})})
    return cfg


def config_from_dict(d: dict) -> Config:
    """The Config that ``dataclasses.asdict`` gave ``d`` (a serving
    artifact's meta.json): its lists back to tuples."""
    def part(cls, fields):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in fields.items()})

    return Config(data=part(DataConfig, d["data"]),
                  model=part(ModelConfig, d["model"]),
                  solver=part(SolverConfig, d["solver"]),
                  checkpoints_dir=d.get("checkpoints_dir",
                                        Config.checkpoints_dir))

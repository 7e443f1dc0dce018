"""Dataset metadata (the reference's ``ref/`` package: ref/lmo.py,
ref/lm_full.py, ref/ycbv.py) — ids, names, diameters, cameras, BOP
models_info loading.

A copy of gdm_tpu/refdata, which the port may not import; the tests
hold every value and function bit-equal to the original."""

from gdm_tpu_torch.refdata import lmo, lm_full, ycbv

REGISTRY = {"lmo": lmo, "lm_full": lm_full, "lmfull": lm_full, "ycbv": ycbv}


def get(name: str):
    return REGISTRY[name]

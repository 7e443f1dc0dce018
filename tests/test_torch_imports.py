"""The PyTorch port runs where JAX is not installed and without the JAX
package: every module of gdm_tpu_torch (the training, refinement, stacked,
VSD, YCB-V, serving-CLI and multi-process slices' included) loads with
jax, flax, gdm_tpu, cv2, PIL and tabulate blocked, and no source file of
the port (chip_smoke.py included) imports them: the GPU host has none of
them."""

import os
import os.path as osp
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PKG = osp.join(ROOT, "gdm_tpu_torch")


def _modules():
    import gdm_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        gdm_tpu_torch.__path__, "gdm_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "gdm_tpu_torch.serve" in mods and len(mods) >= 20
    for m in ("losses.matching", "train.step", "train.checkpoint",
              "train.state", "train.schedules", "data.gt_gen",
              "ops.visibility", "utils.logging", "ops.prng", "ops.ransac",
              "ops.meanshift", "eval.multimodel", "ops.render_depth",
              "eval.vsd", "data.augment", "train.import_torch",
              "utils.viz", "parallel", "parallel.mesh", "parallel.sp",
              "dryrun"):
        assert f"gdm_tpu_torch.{m}" in mods, m
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'gdm_tpu', 'cv2', 'PIL', "
            "'tabulate'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


SOURCES = [osp.relpath(osp.join(d, f), ROOT)
           for d, _, files in os.walk(PKG) for f in sorted(files)
           if f.endswith(".py")] + ["chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_source_never_imports_jax(path):
    src = open(osp.join(ROOT, path)).read()
    assert not re.search(
        r"^\s*(import (jax|flax|gdm_tpu)\b|from (jax|flax|gdm_tpu)\b)", src,
        re.M), path


@pytest.mark.parametrize("path", SOURCES)
def test_source_never_imports_cv2_pil_or_tabulate(path):
    """The GPU host has none of them: the port decodes PNGs, crops and
    formats tables itself."""
    src = open(osp.join(ROOT, path)).read()
    assert not re.search(
        r"^\s*(import (cv2|PIL|tabulate)\b|from (cv2|PIL|tabulate)\b)",
        src, re.M), path


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the smoke run exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, osp.join(ROOT, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

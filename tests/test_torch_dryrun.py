"""``python -m gdm_tpu_torch.dryrun 4 --device cpu``: the port's
counterparts of __graft_entry__.py's multi-device dry runs on four gloo
CPU ranks (the
data-parallel train step, the (2, 2) grid's sharded argmax and sharded-loss
train step, and the (2, 2) grid's sharded loss and gradients against the
dense ones), each stage's rank 0 printing its line; one process, within a
deadline.  Without ``--device`` it runs on the cards, and refuses more
ranks than there are."""

import os
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_dryrun_four_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "gdm_tpu_torch.dryrun", "4",
                        "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=150)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("dryrun")]
    assert [ln.split(":")[0] for ln in lines] == [
        "dryrun dp", "dryrun model_axis", "dryrun combined"], r.stdout
    assert all(ln.endswith(" ok") for ln in lines), lines
    assert "dp: 4 ranks" in lines[0] and "(2, 2) grid" in lines[1]


def test_dryrun_runs_on_the_cards_by_default(monkeypatch):
    import pytest
    import torch

    from gdm_tpu_torch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match=r"4 ranks out of range \(1\.\.2 "
                       r"cards; pass --device cpu"):
        dryrun.dryrun(4)

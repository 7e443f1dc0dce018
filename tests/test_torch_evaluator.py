"""The port's metrics and Evaluator against the JAX package's: every
metric bit-equal in float64 on seeded poses, and Evaluator.evaluate on the
same predictions gives equal recalls, errors, AUC and BOP19 AR, the same
CSV, pickles and table (a symmetric object with models_info symmetries,
a GT frame with no prediction and a miss-sentinel pose included); GT
poses score ad_10 = 100."""

import os.path as osp
import pickle

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import conftest  # noqa: F401
from gdm_tpu.eval import evaluator as ev_j
from gdm_tpu.eval import metrics as met_j
from gdm_tpu.refdata._base import (
    all_symmetry_rotations,
    all_symmetry_transforms,
)
from gdm_tpu_torch.eval import evaluator as ev_t
from gdm_tpu_torch.eval import metrics as met_t

K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899],
              [0, 0, 1]])
SYM_INFO = {"symmetries_discrete": [
    [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]],
    "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]}


def _pose(rng, noise=0.0):
    R = Rotation.random(random_state=rng.randint(1 << 30)).as_matrix()
    t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                  rng.uniform(0.5, 1.0)])
    if noise:
        R = Rotation.from_rotvec(rng.randn(3) * noise).as_matrix() @ R
        t = t + rng.randn(3) * noise * 0.1
    return R, t


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_bit_equal(seed):
    rng = np.random.RandomState(seed)
    pts = rng.randn(200, 3) * 0.05
    syms_tf = [(R, t / 1000.0) for R, t in all_symmetry_transforms(
        SYM_INFO, 0.3)]
    syms_dict = [{"R": R, "t": t} for R, t in syms_tf]
    rots = all_symmetry_rotations(SYM_INFO, 0.3)
    for _ in range(5):
        Rg, tg = _pose(rng)
        Re, te = _pose(rng, noise=0.2)
        for name, args in (
                ("transform_pts", (pts, Re, te)),
                ("add_err", (Re, te, Rg, tg, pts)),
                ("adi_err", (Re, te, Rg, tg, pts)),
                ("re_err", (Re, Rg)),
                ("te_err", (te, tg)),
                ("proj_err", (Re, te, Rg, tg, pts, K)),
                ("get_closest_rot", (Re, Rg, rots)),
                ("get_closest_rot", (Re, Rg, None))):
            _same(getattr(met_t, name)(*args), getattr(met_j, name)(*args))
        for syms in (None, syms_tf, syms_dict):
            for name, args in (
                    ("mssd_err", (Re, te, Rg, tg, pts, syms)),
                    ("mspd_err", (Re, te, Rg, tg, pts, K, syms)),
                    ("re_sym_err", (Re, Rg, syms)),
                    ("te_sym_err", (te, tg, Rg, syms)),
                    ("proj_sym_err", (Re, te, Rg, tg, pts, K, syms))):
                _same(getattr(met_t, name)(*args),
                      getattr(met_j, name)(*args))
    d = np.abs(rng.randn(50)) * 0.05
    d[::7] = np.inf
    for dist, cap in ((d, 0.1), (d, 0.03), ([], 0.1), ([np.inf], 0.1)):
        assert met_t.voc_auc(dist, max_dis=cap) == \
            met_j.voc_auc(dist, max_dis=cap)


def _evaluate(mod, out_dir, gts, preds, objs):
    rng = np.random.RandomState(9)
    pts = {o: rng.randn(120, 3) * 0.04 for o in objs}
    diam = {o: 0.15 + 0.01 * i for i, o in enumerate(objs)}
    sym_rots, sym_tfs = {}, {}
    ev = mod.Evaluator("lmo", objs, diam, pts, sym_objs=("eggbox",),
                       sym_rots=sym_rots, output_dir=out_dir,
                       obj2id={"ape": 1, "eggbox": 10},
                       sym_transforms=sym_tfs)
    # filled after construction, as cli.evaluate fills them
    sym_rots["eggbox"] = all_symmetry_rotations(SYM_INFO, 0.3)
    sym_tfs["eggbox"] = [(R, t / 1000.0) for R, t in
                         all_symmetry_transforms(SYM_INFO, 0.3)]
    for obj, fn, R, t, dt in preds:
        ev.add_prediction(obj, fn, R, t, time=dt)
    return ev.evaluate(gts)


def _case(seed, gt_poses=False):
    rng = np.random.RandomState(seed)
    objs = ["ape", "eggbox"]
    gts = {o: {} for o in objs}
    preds = []
    for o in objs:
        for i in range(12):
            fn = f"{i // 5:06d}/{i:06d}"
            Rg, tg = _pose(rng)
            gts[o][fn] = {"R": Rg, "t": tg, "K": K}
            if i == 3 and not gt_poses:
                continue                           # GT frame, no prediction
            if i == 5 and not gt_poses:            # the miss sentinel
                R, t = np.eye(3), np.array([0.0, 0.0, -1.0])
            elif gt_poses:
                R, t = Rg, tg
            else:
                R, t = _pose(rng, noise=rng.choice([0.005, 0.05, 0.5]))
                R, t = (R, t) if i % 4 else (Rg @ np.diag([-1, -1, 1]), tg)
            preds.append((o, fn, R, t, 0.001 * i))
    return gts, preds, objs


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_outputs_equal(seed, tmp_path):
    gts, preds, objs = _case(seed)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    rt = _evaluate(ev_t, out_t, gts, preds, objs)
    rj = _evaluate(ev_j, out_j, gts, preds, objs)
    for key in ("recalls", "errors", "auc", "bop19_ar"):
        _same(rt[key], rj[key])
    assert rt["table"] == rj["table"]
    assert "inf" not in rt["table"] and "nan" not in rt["table"]
    for name in ("gt_lmo-test.csv", "_lmo_tab.txt"):
        with open(osp.join(out_t, name)) as f, \
                open(osp.join(out_j, name)) as g:
            assert f.read() == g.read(), name
    for name in ("_lmo_errors.pkl", "_lmo_recalls.pkl"):
        with open(osp.join(out_t, name), "rb") as f, \
                open(osp.join(out_j, name), "rb") as g:
            _same(pickle.load(f), pickle.load(g))
    # the missing frame is a failure in every statistic
    assert rt["errors"]["ape"]["ad"][3] == np.inf
    assert rt["recalls"]["eggbox"]["ad_10"][3] == 0.0


def test_gt_poses_score_full_recall():
    gts, preds, objs = _case(3, gt_poses=True)
    r = _evaluate(ev_t, None, gts, preds, objs)
    for o in objs:
        assert 100 * np.mean(r["recalls"][o]["ad_10"]) == 100.0
        assert r["auc"][o] == pytest.approx(100.0)
    # (eggbox's discretised continuous symmetry set leaves out the
    # identity, as the JAX package's all_symmetry_transforms does)
    assert r["bop19_ar"]["ape"]["ar_mssd"] == 1.0
    assert r["bop19_ar"]["ape"]["ar_mspd"] == 1.0


def test_plain_table_lays_out_like_tabulate():
    from tabulate import tabulate

    rows = [["objects", "ape", "eggbox", "Avg(2)"],
            ["ad_2", "12.50", "-", "12.50"], ["auc_ad", "3.21", "100.00",
                                              "51.61"]]
    assert ev_t.plain_table(rows) == tabulate(rows, tablefmt="plain")


def test_vsd_refused():
    with pytest.raises(NotImplementedError, match="VSD"):
        ev_t.Evaluator("lmo", ["ape"], {"ape": 0.1}, {"ape": np.zeros((3, 3))},
                       vsd_meshes={"ape": (np.zeros((3, 3)),
                                           np.zeros((1, 3), int))})

"""The port's training losses against gdm_tpu.losses on the CPU: values
(|d|/|ref| <= 1e-5) and gradients (max|d|/max|ref| <= 1e-4) from
jax.value_and_grad and torch autograd on the same seeded numpy inputs,
including an empty positive mask, an element with fewer than 3
foreground rows, the symmetric mask, a chunked batch and the DGCNN
variant (one-hot padding column, depth-scaled radius).  The depth-scaled
mask is held equal to JAX's except where a squared distance lies within
4 f32 ulps of the terms that the radius test compares (the two packages
sum the small matmul of the depth in their own order)."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch import losses as L

torch.set_num_threads(1)
VAL_TOL, GRAD_TOL = 1e-5, 1e-4


def _jax_value_and_grad(fn, *args, argnums=0):
    import jax

    v, g = jax.value_and_grad(fn, argnums=argnums)(*args)
    if isinstance(argnums, int):
        g = (g,)
    return float(v), [np.asarray(x) for x in g]


def _torch_value_and_grad(fn, *args, argnums=(0,)):
    ts = [torch.tensor(a, requires_grad=i in argnums)
          if isinstance(a, np.ndarray) and a.dtype == np.float32
          else (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
          for i, a in enumerate(args)]
    v = fn(*ts)
    v.backward()
    return float(v.detach()), [ts[i].grad.numpy() for i in argnums]


def _check(vj, gj, vt, gt):
    assert abs(vt - vj) <= VAL_TOL * max(abs(vj), 1e-30), (vt, vj)
    for a, b in zip(gt, gj):
        assert np.isfinite(a).all()
        assert H.rel_err(a, b) <= GRAD_TOL, H.rel_err(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss(weighted):
    from gdm_tpu.losses import focal_loss

    rng = np.random.RandomState(0)
    logits = rng.randn(3, 50, 2).astype(np.float32) * 2
    tgt = rng.randint(0, 2, (3, 50)).astype(np.int32)
    w = (rng.rand(3, 50) > 0.3).astype(np.float32) if weighted else None
    vj, gj = _jax_value_and_grad(
        lambda x: focal_loss(x, tgt, 2.0, w), logits)
    vt, gt = _torch_value_and_grad(
        lambda x: L.focal_loss(x, torch.from_numpy(tgt).long(), 2.0,
                               None if w is None else torch.from_numpy(w)),
        logits)
    _check(vj, gj, vt, gt)


def test_masked_logsumexp_with_an_empty_row():
    from gdm_tpu.losses.circle import masked_logsumexp

    rng = np.random.RandomState(1)
    x = (rng.randn(6, 40) * 5).astype(np.float32)
    mask = rng.rand(6, 40) > 0.5
    mask[2] = False                                 # empty: finite, no grad
    vj, gj = _jax_value_and_grad(
        lambda a: masked_logsumexp(a, mask).sum(), x)
    vt, gt = _torch_value_and_grad(
        lambda a: L.masked_logsumexp(a, torch.from_numpy(mask)).sum(), x)
    _check(vj, gj, vt, gt)
    row = L.masked_logsumexp(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.isfinite(row).all() and gt[0][2].max() == 0.0


@pytest.mark.parametrize("row_valid", [False, True])
def test_circle_loss(row_valid):
    from gdm_tpu.losses import circle_loss

    rng = np.random.RandomState(2)
    sim = np.tanh(rng.randn(2, 30, 41)).astype(np.float32)
    pos = rng.rand(2, 30, 41) > 0.9
    pos[0, 3] = False                               # a row without positives
    rv = (rng.rand(2, 30) > 0.4).astype(np.float32) if row_valid else None
    vj, gj = _jax_value_and_grad(
        lambda s: circle_loss(s, pos, rv), sim)
    vt, gt = _torch_value_and_grad(
        lambda s: L.circle_loss(s, torch.from_numpy(pos),
                                None if rv is None else torch.from_numpy(rv)),
        sim)
    _check(vj, gj, vt, gt)


def _matching_problem(seed, b=4, n=96, m=40, c=16):
    rng = np.random.RandomState(seed)
    mesh_xyz = (rng.randn(m, 3) * 0.03).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    mesh_f = rng.randn(m, c).astype(np.float32)
    labels = (rng.rand(b, n) > 0.4).astype(np.int32)
    labels[1] = 0
    labels[1, :2] = 1                               # < 3 fg rows: left out
    match = rng.randint(0, m + 1, (b, n)).astype(np.int32)
    match[labels == 0] = m
    vis = (rng.rand(b, m) > 0.3).astype(np.uint8)
    vis[2] = 0                                      # no visible vertex:
    sym = rng.permutation(m).astype(np.int32)       # empty positive masks
    return feats, mesh_f, mesh_xyz, labels, match, vis, sym


def _gt_poses(seed, b=4):
    """[b, 3, 4] f32 poses: random rotations, the object 0.4-0.6 m in
    front of the camera."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    R = Rotation.random(b, random_state=seed).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.05, 0.05, b),
                  rng.uniform(0.4, 0.6, b)], axis=1)
    return np.concatenate([R, t[:, :, None]], axis=2).astype(np.float32)


@pytest.mark.parametrize("variant", ["plain", "sym", "chunked",
                                     "sym_chunked", "depth_scaled"])
def test_pointwise_matching_loss(variant):
    from gdm_tpu.losses import pointwise_matching_loss

    feats, mesh_f, mesh_xyz, labels, match, vis, sym = _matching_problem(3)
    use_sym = sym if "sym" in variant else None
    chunk = 2 if "chunked" in variant else None
    r = 0.02
    # the DGCNN variant (geomatch_dgcnn.py:96-104): e0 padding column,
    # radius 3 mm per metre of depth under the GT poses
    dgcnn = {}
    if variant == "depth_scaled":
        dgcnn = {"pad_onehot": True, "rt": _gt_poses(3),
                 "depth_scaled_r_mm": 3.0}
    vj, gj = _jax_value_and_grad(
        lambda f, mf: pointwise_matching_loss(
            f, mf, mesh_xyz, labels, match, vis, r, sym_idx=use_sym,
            batch_chunk=chunk, **dgcnn), feats, mesh_f, argnums=(0, 1))
    if dgcnn:
        dgcnn["rt"] = torch.from_numpy(dgcnn["rt"])

    def port(f, mf):
        return L.pointwise_matching_loss(
            f, mf, torch.from_numpy(mesh_xyz), torch.from_numpy(labels),
            torch.from_numpy(match).long(), torch.from_numpy(vis), r,
            sym_idx=None if use_sym is None else torch.from_numpy(use_sym),
            batch_chunk=chunk, **dgcnn)

    vt, gt = _torch_value_and_grad(port, feats, mesh_f, argnums=(0, 1))
    _check(vj, gj, vt, gt)
    assert np.abs(gt[0][1]).max() == 0.0      # the < 3 fg element is out


def test_positive_masks_equal():
    import jax

    from gdm_tpu.losses.matching import (
        matching_positive_mask,
        matching_positive_mask_depth_scaled,
        matching_positive_mask_sym,
    )

    feats, mesh_f, mesh_xyz, labels, match, vis, sym = _matching_problem(4)
    m = mesh_xyz.shape[0]
    want = np.asarray(jax.vmap(
        lambda mi, v: matching_positive_mask(mi, mesh_xyz, v, 0.02))(
            match, vis))
    got = L.matching_positive_mask(torch.from_numpy(match).long(),
                                   torch.from_numpy(mesh_xyz),
                                   torch.from_numpy(vis), 0.02).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.vmap(
        lambda mi: matching_positive_mask_sym(mi, sym, m))(match))
    got = L.matching_positive_mask_sym(torch.from_numpy(match).long(),
                                       torch.from_numpy(sym), m).numpy()
    np.testing.assert_array_equal(got, want)
    # depth-scaled (DGCNN): 40 mm per metre, so that each row has several
    # positives; equal but within 4 f32 ulps of the radius test's terms
    rt = _gt_poses(4)
    want = np.asarray(jax.vmap(
        lambda mi, v, p: matching_positive_mask_depth_scaled(
            mi, mesh_xyz, v, p, 40.0))(match, vis, rt))
    got = L.matching_positive_mask_depth_scaled(
        torch.from_numpy(match).long(), torch.from_numpy(mesh_xyz),
        torch.from_numpy(vis), torch.from_numpy(rt), 40.0).numpy()
    x = mesh_xyz.astype(np.float64)
    gt = x[np.clip(match, 0, m - 1)]                      # [b, n, 3]
    d2 = ((gt[:, :, None] - x[None, None]) ** 2).sum(-1)
    r2 = np.square(0.04 * (np.einsum("mk,bk->bm", x, rt[:, 2, :3])
                           + rt[:, 2, 3:4]))[:, None, :]
    n2 = (gt ** 2).sum(-1)[..., None] + (x ** 2).sum(-1)
    edge = np.abs(d2 - r2) <= 4 * np.finfo(np.float32).eps * (n2 + r2)
    assert edge.mean() < 0.01 and want[..., :m].sum() > 100
    np.testing.assert_array_equal(got[..., :m][~edge], want[..., :m][~edge])
    np.testing.assert_array_equal(got[..., m], want[..., m])


def test_automatic_weighted_loss():
    import jax.numpy as jnp

    from gdm_tpu.losses import AutomaticWeightedLoss

    p = np.array([0.7, 1.3], np.float32)
    a, b = np.float32(0.83), np.float32(2.41)
    mod = AutomaticWeightedLoss(2)

    def jfn(p, a, b):
        return mod.apply({"params": {"weights": p}}, a, b)

    vj, gj = _jax_value_and_grad(jfn, jnp.asarray(p), a, b,
                                 argnums=(0, 1, 2))
    awl = L.AutomaticWeightedLoss(2)
    with torch.no_grad():
        awl.params.copy_(torch.from_numpy(p))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    v = awl(ta, tb)
    v.backward()
    _check(vj, gj, float(v.detach()), [awl.params.grad.numpy(),
                                        ta.grad.numpy(),
                              tb.grad.numpy()])
    assert [n for n, _ in awl.named_parameters()] == ["params"]

"""Port of the similarity argmax (gdm_tpu_torch.ops.similarity) against
the JAX package: the plain version against _xla_cosine_argmax (the
function the JAX main path runs) and against the Pallas kernel in
interpret mode; the wrapper's dispatch and input checks.  The CUDA
kernel itself is compared with the plain version on the card."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu.ops.pallas.similarity import (
    _pallas_cosine_argmax,
    _xla_cosine_argmax,
)
from gdm_tpu_torch.ops import similarity as S

torch.set_num_threads(1)

GAP = 1e-5           # top-2 gap below which an index flip is a near-tie


def _unit(rng, n, c):
    x = rng.randn(n, c).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port(s, m):
    idx, score = S.cosine_argmax(torch.from_numpy(s), torch.from_numpy(m))
    return idx.numpy(), score.numpy()


@pytest.mark.parametrize("n,m", [(1024, 512), (1100, 700), (128, 128)])
def test_plain_matches_xla(n, m):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    s, mf = _unit(rng, n, 64), _unit(rng, m, 64)
    idx, score = _port(s, mf)
    idx_x, sc_x = (np.asarray(a) for a in
                   _xla_cosine_argmax(jnp.asarray(s), jnp.asarray(mf)))
    sure = H.top2_gap(s, mf) > GAP
    np.testing.assert_array_equal(idx[sure], idx_x[sure])
    np.testing.assert_allclose(score, sc_x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,m", [(1024, 512), (1100, 700), (128, 128)])
def test_plain_matches_pallas_interpret(n, m):
    """The Pallas kernel takes bf16 products: tests/test_pallas.py's
    tolerances (>= 98% equal indices, scores within 2e-2)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    s, mf = _unit(rng, n, 64), _unit(rng, m, 64)
    idx, score = _port(s, mf)
    idx_p, sc_p = (np.asarray(a) for a in _pallas_cosine_argmax(
        jnp.asarray(s), jnp.asarray(mf), interpret=True))
    assert (idx == idx_p).mean() >= 0.98
    np.testing.assert_allclose(score, sc_p, rtol=0, atol=2e-2)


def test_padding_never_wins():
    """All similarities negative: a zero-padded mesh column would score 0
    and win if it were there."""
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    s = -np.abs(_unit(rng, 64, 32))
    mf = np.abs(_unit(rng, 100, 32))
    idx, score = _port(s, mf)
    assert (idx < 100).all() and (score < 0).all()
    idx_p, _ = _pallas_cosine_argmax(jnp.asarray(s), jnp.asarray(mf),
                                     interpret=True)
    assert (np.asarray(idx_p) < 100).all()


def test_all_zero_row_and_exact_ties_take_lowest_index():
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    base = _unit(rng, 40, 16)
    mf = np.concatenate([base, base[:20]])        # rows 40+i == row i
    s = base[:20].copy()
    s[3] = 0.0
    idx, score = _port(s, mf)
    idx_x, _ = _xla_cosine_argmax(jnp.asarray(s), jnp.asarray(mf))
    want = np.arange(20)
    want[3] = 0
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(np.asarray(idx_x), want)
    assert score[3] == 0.0


def test_batched_folds_rows():
    rng = np.random.RandomState(3)
    s = _unit(rng, 3 * 50, 32).reshape(3, 50, 32)
    mf = _unit(rng, 70, 32)
    idx, score = S.cosine_argmax_batched(torch.from_numpy(s),
                                         torch.from_numpy(mf))
    assert idx.shape == (3, 50) and score.shape == (3, 50)
    for b in range(3):
        i1, s1 = _port(s[b], mf)
        np.testing.assert_array_equal(idx[b].numpy(), i1)
        np.testing.assert_array_equal(score[b].numpy(), s1)


def test_cpu_tensors_take_plain_version():
    """A CPU tensor never reaches the kernel: no launch is counted and no
    CUDA library is built."""
    rng = np.random.RandomState(4)
    before = S.cosine_argmax.launches
    _port(_unit(rng, 10, 8), _unit(rng, 12, 8))
    assert S.cosine_argmax.launches == before


@pytest.mark.parametrize("case", ["c_too_wide", "c_not_mult4", "f64",
                                  "non_contiguous", "empty_mesh",
                                  "channel_mismatch"])
def test_kernel_wrapper_rejects_bad_input(case):
    """The kernel path validates before it builds or launches anything."""
    f = torch.zeros
    scene, mesh = f(8, 16), f(4, 16)
    if case == "c_too_wide":
        scene, mesh = f(8, 260), f(4, 260)
    elif case == "c_not_mult4":
        scene, mesh = f(8, 18), f(4, 18)
    elif case == "f64":
        scene = scene.double()
    elif case == "non_contiguous":
        scene = f(16, 8).T
    elif case == "empty_mesh":
        mesh = f(0, 16)
    elif case == "channel_mismatch":
        mesh = f(4, 12)
    with pytest.raises((ValueError, TypeError)):
        S._launch(scene, mesh)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """CUDA kernel against the plain version on the same card tensors
    (runs where a CUDA device exists; chip_smoke.py covers the serving
    shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    s = torch.nn.functional.normalize(
        torch.randn(1100, 128, device="cuda", generator=g), dim=-1)
    m = torch.nn.functional.normalize(
        torch.randn(700, 128, device="cuda", generator=g), dim=-1)
    idx, score = S.cosine_argmax(s, m)
    idx_r, score_r = S.cosine_argmax_reference(s, m)
    sure = torch.from_numpy(H.top2_gap(s.cpu().numpy(), m.cpu().numpy())
                            > GAP).cuda()
    assert torch.equal(idx[sure], idx_r[sure])
    assert float((score - score_r).abs().max()) <= 1e-5


# --- the CUDA kernel's arithmetic, emulated on the CPU -------------------
# csrc/similarity.cu splits each f32 operand as x = hi + lo with
# hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) and sums
# lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on the tensor cores (TF32 wgmma, f32
# accumulators).  Here the split is exact and the three products are
# summed in float64, so what is left is the split's own error: the
# dropped lo.lo term and the rounding of lo, ~3 * 2^-22 for unit rows.

SPLIT_TOL = 1e-6     # |split dot - float64 dot| for unit rows


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
    (add half an ulp to the magnitude bits, clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _split_dot(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[R, M] dot products as the kernel forms them, summed in float64."""
    sh, sl = (t.double() for t in _split(s))
    mh, ml = (t.double() for t in _split(m))
    return sl @ mh.T + sh @ ml.T + sh @ mh.T


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie rounds away from 0
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # below the tie rounds down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),     # a tie above an odd ulp
    (0.0, 0.0),
])
def test_rna_tf32_rounds_ties_away_from_zero(x, want):
    got = _rna_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want
    assert int(got.view(torch.int32)[0]) & 0x1FFF == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_parts_are_tf32_and_exact(seed):
    """hi and lo carry 10 mantissa bits each, and hi + lo is within
    2^-22 |x| of x (lo rounded to TF32)."""
    x = torch.from_numpy(_unit(np.random.RandomState(seed), 64, 128))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_dot_within_1e6_of_float64(seed):
    rng = np.random.RandomState(seed)
    s, m = _unit(rng, 512, 128), _unit(rng, 700, 128)
    exact = torch.from_numpy(s).double() @ torch.from_numpy(m).double().T
    err = float((_split_dot(torch.from_numpy(s), torch.from_numpy(m))
                 - exact).abs().max())
    assert err <= SPLIT_TOL, err


@pytest.mark.parametrize("n,m", [(1024, 512), (1100, 700), (300, 4096)])
def test_split_argmax_matches_plain(n, m):
    """The emulated kernel's argmax and max against the plain f32 version
    (the contract chip_smoke.py holds the card to): equal indices beyond
    a 1e-5 top-2 gap, scores within 1e-5, ties to the lowest index."""
    rng = np.random.RandomState(5)
    s, mf = _unit(rng, n, 128), _unit(rng, m, 128)
    score_e, idx_e = torch.max(
        _split_dot(torch.from_numpy(s), torch.from_numpy(mf)), dim=-1)
    idx, score = _port(s, mf)
    sure = H.top2_gap(s, mf) > GAP
    np.testing.assert_array_equal(idx_e.numpy()[sure], idx[sure])
    np.testing.assert_allclose(score_e.numpy(), score, rtol=0, atol=1e-5)


def test_split_argmax_all_negative_ragged():
    """M = 700 (not a multiple of the kernel's 128-row mesh tiles) and
    every true score negative: the emulation and the plain version pick
    real mesh rows with negative scores."""
    rng = np.random.RandomState(6)
    s = -np.abs(_unit(rng, 256, 128))
    mf = np.abs(_unit(rng, 700, 128))
    score_e, idx_e = torch.max(
        _split_dot(torch.from_numpy(s), torch.from_numpy(mf)), dim=-1)
    idx, score = _port(s, mf)
    assert (score < 0).all() and (score_e.numpy() < 0).all()
    assert (idx < 700).all()
    sure = H.top2_gap(s, mf) > GAP
    np.testing.assert_array_equal(idx_e.numpy()[sure], idx[sure])


@pytest.mark.cuda
def test_kernel_all_negative_ragged_on_card():
    """A zero-filled mesh row past M would score 0 and beat every real
    row here; the kernel masks it by index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    s = -torch.nn.functional.normalize(
        torch.randn(1100, 128, device="cuda", generator=g), dim=-1).abs()
    m = torch.nn.functional.normalize(
        torch.randn(700, 128, device="cuda", generator=g), dim=-1).abs()
    idx, score = S.cosine_argmax(s, m)
    idx_r, score_r = S.cosine_argmax_reference(s, m)
    assert int(idx.max()) < 700 and float(score.max()) < 0
    sure = torch.from_numpy(H.top2_gap(s.cpu().numpy(), m.cpu().numpy())
                            > GAP).cuda()
    assert torch.equal(idx[sure], idx_r[sure])
    assert float((score - score_r).abs().max()) <= 1e-5

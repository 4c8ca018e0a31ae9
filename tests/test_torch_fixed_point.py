"""The deformable conv's deterministic scatter, replayed in numpy: the
fixed-point rule of ``aanet_torch/csrc/deform_conv.cu`` (its kernel note
above ``deform_bwd_data_kernel``), which only the card runs.

Each scattered term v (float32, at most T = G * W * M in size, the bound
of ``fixed_bound_kernel``) enters as q = rint(v * 2^e), e = bits - 1 -
E with T < 2^E, clamped to [-126, 127]; bits = min(62 - 2 L, 62 -
ceil(log2(taps * Ho * Wo))), L = ceil(log2(taps * P)). A block's shared
window holds q as two 32-bit words, lo = q mod 2^s (unsigned) and hi =
floor(q / 2^s) (signed), s = 32 - L; the flush adds hi * 2^s + lo to an
int64 sum, far corners add q there directly; the sum is rounded to float32
or bf16 once and scaled by 2^-e. A non-finite term sets its element's
flags (1 +inf, 2 -inf, 3 NaN) instead.

What is held: permuting the terms and cutting them into other blocks gives
the same bits; no 32-bit word and no int64 sum wraps at the bound; the
result is within n * 2^(1 - bits) * T of the exact (float64) sum of an
element's n float32 terms, plus the one rounding to the output's type;
and a NaN or infinite term leaves its element NaN or infinite, as float
adds would.
"""
import math

import numpy as np
import pytest


def ceil_log2(n):
    return (int(n) - 1).bit_length()


def term_bits(taps, pixels, npix):
    """(bits, s): the terms' bound in bits and the window's split bit."""
    lg = ceil_log2(taps * pixels)
    return min(62 - 2 * lg, 62 - ceil_log2(taps * npix)), 32 - lg


def exponent(bound, bits):
    """e of the scale 2^e (``fixed_exponent``)."""
    _, ex = math.frexp(bound)  # bound < 2^ex; 0 for a zero bound
    return max(-126, min(127, bits - 1 - ex))


def quantize(v, e):
    """rint(v * 2^e) of float32 terms: the product is exact (a power of two)."""
    return np.rint(v.astype(np.float32) * np.float32(2.0 ** e)).astype(np.int64)


def window_words(q, s):
    """q as the window's (lo, hi) words: lo in [0, 2^s), hi = floor(q / 2^s)."""
    return q & ((1 << s) - 1), q >> s


def scatter(v, idx, n, e, s, blocks, rng):
    """The kernel's sum of terms v at elements idx (n elements): the terms
    cut into ``blocks`` windows in a random order, each summed in its two
    32-bit words (checked not to wrap) and flushed into the int64 sums;
    a non-finite term sets its element's flags."""
    acc = np.zeros(n, np.int64)
    flags = np.zeros(n, np.int64)
    bad = ~np.isfinite(v)
    for i in np.flatnonzero(bad):
        flags[idx[i]] |= 3 if np.isnan(v[i]) else (1 if v[i] > 0 else 2)
    good = np.flatnonzero(~bad)
    order = rng.permutation(good)
    for part in np.array_split(order, blocks):
        q = quantize(v[part], e)
        lo, hi = window_words(q, s)
        lo_sum, hi_sum = np.zeros(n, np.int64), np.zeros(n, np.int64)
        np.add.at(lo_sum, idx[part], lo)
        np.add.at(hi_sum, idx[part], hi)
        assert lo_sum.max(initial=0) < 2**32 and np.abs(hi_sum).max(initial=0) < 2**31
        acc += hi_sum * (1 << s) + lo_sum
    return acc, flags


def to_float32(acc, flags, e):
    """Each int64 sum rounded to float32 once, scaled by 2^-e (exact);
    flagged elements +inf, -inf or NaN."""
    out = np.ldexp(acc.astype(np.float32), -e).astype(np.float32)  # int64 -> float32: one rounding
    out[flags == 1], out[flags == 2], out[flags == 3] = np.inf, -np.inf, np.nan
    return out


def to_bf16(acc, e):
    """Each int64 sum rounded to bf16 once (to nearest, ties to even, on
    the integer), scaled by 2^-e; as float32 values."""
    out = np.empty(acc.shape, np.float32)
    for i, a in enumerate(acc.tolist()):
        shift = max(abs(a).bit_length() - 8, 0)  # keep 8 significant bits
        q, r = divmod(abs(a), 1 << shift)
        half = 1 << shift >> 1
        if shift and (r > half or (r == half and q & 1)):
            q += 1
        out[i] = math.copysign(math.ldexp(q, shift - e), a)
    return out


def _terms(rng, n_elems, n_terms, scale):
    """Float32 terms of both signs and many magnitudes at random elements."""
    v = (rng.standard_normal(n_terms) * scale * 10.0 ** rng.uniform(-6, 0, n_terms)).astype(np.float32)
    return v, rng.integers(0, n_elems, n_terms)


@pytest.mark.parametrize("taps,pixels,npix", [(9, 64, 18432), (9, 128, 165888), (1, 64, 16)])
def test_no_word_or_sum_wraps_at_the_bound(taps, pixels, npix):
    """At the largest terms the bound allows, a window's words stay within
    32 bits for its taps * P terms and an element's int64 sum within 63
    bits for its taps * Ho * Wo terms."""
    bits, s = term_bits(taps, pixels, npix)
    assert bits >= 8
    top = (1 << bits) - 1  # |q| < 2^bits
    lo, hi = window_words(np.array([top, -top], np.int64), s)
    assert (lo < 2**s).all() and (lo >= 0).all()
    assert taps * pixels * (2**s - 1) < 2**32  # the unsigned lo word
    assert taps * pixels * max(abs(int(h)) for h in hi) < 2**31  # the signed hi word
    assert taps * npix * top < 2**63
    # the largest term the bound admits, after float32's rounding of gcol
    bound = 3.7
    e = exponent(bound, bits)
    assert abs(int(quantize(np.array([bound * (1 + 2**-20)]), e)[0])) < 2**bits


def test_exponent_clamps():
    bits = 40
    assert exponent(0.0, bits) == bits - 1  # all terms zero: any scale
    assert exponent(1.0, bits) == bits - 2
    assert exponent(1e-40, bits) == 127  # coarser for terms below 2^-88 of the bound
    assert exponent(1e60, bits) == -126  # finite float32 terms stay below 2^128
    assert quantize(np.array([3.0e38], np.float32), -126)[0] < 2**bits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_bits_in_any_order_and_within_the_bound(seed):
    """The sums and their float32 and bf16 values are the same bits for
    every order of the terms and every cut into blocks; each element is
    within n 2^(1 - bits) T of its terms' exact sum before its rounding."""
    rng = np.random.default_rng(seed)
    n, taps, pixels, npix = 64, 9, 64, 4096
    v, idx = _terms(rng, n, 20000, scale=3.0)
    bound = float(np.abs(v).max()) * 1.5  # T, as G * W * M bounds every term
    bits, s = term_bits(taps, pixels, npix)
    e = exponent(bound, bits)
    runs = [scatter(v, idx, n, e, s, blocks, np.random.default_rng(k))
            for k, blocks in enumerate((1, 7, 64))]
    for acc, flags in runs[1:]:
        assert np.array_equal(acc, runs[0][0]) and not flags.any()
    acc = runs[0][0]
    out32, out16 = to_float32(acc, runs[0][1], e), to_bf16(acc, e)
    exact = np.zeros(n)
    np.add.at(exact, idx, v.astype(np.float64))
    counts = np.bincount(idx, minlength=n)
    fixed = np.ldexp(acc.astype(np.float64), -e)  # exact below 2^53, as here
    assert (np.abs(fixed - exact) <= counts * 2.0 ** (1 - bits) * bound).all()
    ulp32 = np.spacing(np.abs(out32).astype(np.float32)).astype(np.float64)
    assert (np.abs(out32 - exact) <= counts * 2.0 ** (1 - bits) * bound + ulp32).all()
    ulp16 = 2.0 ** (np.floor(np.log2(np.abs(out16))) - 7)
    assert (np.abs(out16 - exact) <= counts * 2.0 ** (1 - bits) * bound + ulp16).all()
    # float32 adds in two orders give other bits: what the fixed point repairs
    a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for i in rng.permutation(len(v)):
        a[idx[i]] += v[i]
    for i in rng.permutation(len(v)):
        b[idx[i]] += v[i]
    assert not np.array_equal(a, b)


def test_non_finite_terms_stay_non_finite():
    """An element that a NaN or an infinite term reaches reads as float adds
    would leave it: +inf, -inf, or NaN where both signs or a NaN meet;
    the others keep their finite sums."""
    rng = np.random.default_rng(3)
    n = 8
    v, idx = _terms(rng, n, 400, scale=1.0)
    v = np.concatenate([v, np.float32([np.inf, np.inf, -np.inf, np.inf, -np.inf, np.nan])])
    idx = np.concatenate([idx, [1, 1, 2, 3, 3, 4]])
    bits, s = term_bits(9, 64, 256)
    finite = np.isfinite(v)
    e = exponent(float(np.abs(v[finite]).max()), bits)
    acc, flags = scatter(v, idx, n, e, s, 4, rng)
    out = to_float32(acc, flags, e)
    with np.errstate(invalid="ignore"):
        float_adds = np.zeros(n)
        np.add.at(float_adds, idx, v.astype(np.float64))
    assert out[1] == np.inf and out[2] == -np.inf and np.isnan(out[3]) and np.isnan(out[4])
    np.testing.assert_array_equal(np.isnan(out), np.isnan(float_adds))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(float_adds))
    assert np.isfinite(out[[0, 5, 6, 7]]).all()

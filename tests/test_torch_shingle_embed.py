"""Kernel B's arithmetic, on the CPU: a numpy twin of what each lane of
``csrc/shingle_embed.cu`` computes, in its order (staged passes of 64
shingles, squared norms by float32 ``fmaf`` steps in ascending j, the
division-free quotient, ascending-s sums, the fused mean-normalise
epilogue with its butterfly reduction), held against the reference
(``repro.kernels.ops.shingle_embed``, its Pallas kernel in interpret mode)
and against the port's plain version; and the quotient held bit for bit
against IEEE float32 division. The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).

``fmaf`` is emulated exactly: the float64 product of two float32 values is
exact, the float64 sum is rounded to odd (its exact error from a two-sum)
and then to float32 once, which is the correctly rounded result
(Boldo-Melquiond: 53 >= 24 + 2). Plain float64 arithmetic would round
twice.

Tolerance against the reference and the plain version: 1e-5 (float32 sums
in another order)."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.kernels import ops as ref_ops
from repro_torch.core import features
from repro_torch.kernels import ops

torch.set_num_threads(1)

PASS = 64             # shingles staged per pass (csrc kPass)
F32 = np.float32


def fmaf(a, b, c) -> np.ndarray:
    """Correctly rounded float32 a * b + c, elementwise."""
    p = np.asarray(a, F32).astype(np.float64) * np.asarray(b, F32).astype(np.float64)
    c = np.asarray(c, F32).astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)                   # s + err == p + c exactly
    bits = np.array(s, np.float64).view(np.int64)
    # round to odd: an inexact sum with an even last bit steps one ulp
    # toward the exact value (a step of the bit pattern moves the magnitude)
    step = np.where((err > 0) == (s > 0), 1, -1)
    bits = np.where((err != 0) & (bits % 2 == 0), bits + step, bits)
    return bits.view(np.float64).astype(F32)


def quotient(f, norm, rcp) -> np.ndarray:
    """The kernel's ``residual_quotient``: f = x * 2^31, norm, rcp = RN(1 /
    norm) -> RN(x / norm), in its units (norm * 2^31, rcp * 2^-31)."""
    n2, r2 = np.asarray(norm, F32) * F32(2.0**31), np.asarray(rcp, F32) * F32(2.0**-31)
    q = np.asarray(f, F32) * r2
    e = fmaf(-n2, q, f)
    return fmaf(e, r2, q)


def hash_values(ids: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ids [...] uint32 -> [..., M] float32 int32(a_j * id + b_j) = v * 2^31."""
    h = (ids[..., None].astype(np.uint64) * a.astype(np.uint64) + b) & np.uint64(0xFFFFFFFF)
    return h.astype(np.uint32).view(np.int32).astype(F32)


def kernel_twin(ids: np.ndarray, mask: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Every warp (row) at once: ids [B, S] uint32, mask [B, S] bool, a/b
    [M] uint32 -> [B, M] float32, in the kernel's order of operations."""
    rows, s_len = ids.shape
    m = a.shape[0]
    acc = np.zeros((rows, m), F32)
    for s0 in range(0, s_len, PASS):
        mk = mask[:, s0:s0 + PASS]
        # the warp's list: the pass's unmasked shingles in ascending s
        order = np.argsort(~mk, axis=1, kind="stable")
        listed = np.take_along_axis(ids[:, s0:s0 + PASS], order, axis=1)
        n = mk.sum(axis=1)
        f = hash_values(listed, a, b)                     # [B, slots, M]
        # norms by shingle: one fmaf chain over j ascending
        ss = np.zeros(f.shape[:2], F32)
        for j in range(m):
            ss = fmaf(f[..., j], f[..., j], ss)
        norm = np.sqrt(ss * F32(2.0**-62)) + F32(1e-12)
        rcp = F32(1) / norm
        # sums by component, slot by slot
        for k in range(f.shape[1]):
            q = quotient(f[:, k, :], norm[:, k, None], rcp[:, k, None])
            acc = np.where((k < n)[:, None], acc + q, acc)
    # epilogue: lane l holds components l, l + 32, ... (0 past M)
    feat = acc / np.maximum(mask.sum(axis=1), 1).astype(F32)[:, None]
    lanes = np.zeros((rows, 32 * -(-m // 32)), F32)
    lanes[:, :m] = feat
    lanes = lanes.reshape(rows, -1, 32)                   # [B, t, lane]
    sq = np.zeros((rows, 32), F32)
    for t in range(lanes.shape[1]):
        sq = fmaf(lanes[:, t], lanes[:, t], sq)
    for o in (16, 8, 4, 2, 1):
        sq = sq + sq[:, np.arange(32) ^ o]
    assert (sq == sq[:, :1]).all()                        # every lane holds the sum
    return feat / (np.sqrt(sq[:, 0]) + F32(1e-12))[:, None]


def _inputs(b, s, m, seed, unique=False):
    rng = np.random.Generator(np.random.PCG64(seed))
    if unique:
        # as unique_mask makes them: sorted ids, first occurrences
        ids = rng.integers(0, 2**32, size=(b, s), dtype=np.uint32)
        dup = rng.random((b, s)) < 0.3
        ids[:, 1:] = np.where(dup[:, 1:], ids[:, :-1], ids[:, 1:])
        sorted_ids, first = features.unique_mask(torch.from_numpy(ids.astype(np.int64)))
        ids, mask = sorted_ids.numpy().astype(np.uint32), first.numpy()
    else:
        ids = rng.integers(0, 2**32, size=(b, s), dtype=np.uint32)
        mask = rng.random((b, s)) < 0.8
    if b > 1:
        mask[-1] = False                                  # an all-masked row
    a, bb = ref_hashing.multiply_shift_params(m)
    return ids, mask, a, bb


def _bits(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


SHAPES = [(1, 61, 64), (8, 61, 64), (13, 61, 50), (32, 200, 80), (7, 130, 40), (3, 61, 256)]


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("b,s,m", SHAPES)
def test_twin_vs_reference_and_plain(b, s, m, unique):
    ids, mask, a, bb = _inputs(b, s, m, b * 100 + s + m, unique)
    got = kernel_twin(ids, mask, a, bb)
    want = np.asarray(ref_ops.shingle_embed(jnp.asarray(ids), jnp.asarray(mask),
                                            jnp.asarray(a), jnp.asarray(bb)))
    plain = ops.shingle_embed(_bits(ids), torch.from_numpy(mask), _bits(a), _bits(bb)).numpy()
    assert got.shape == want.shape == (b, m) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    if b > 1:
        assert np.array_equal(got[-1].view(np.uint32), np.zeros(m, np.uint32))   # +0.0 exactly
        assert np.abs(got[:-1]).max() > 0


def test_fmaf_emulation_is_exact():
    """Against exact rational arithmetic, rounded to nearest even by hand,
    on random triples and on triples that cancel."""
    rng = np.random.Generator(np.random.PCG64(7))
    a = rng.standard_normal(1500).astype(F32)
    b = rng.standard_normal(1500).astype(F32)
    c = np.concatenate([(rng.standard_normal(750) * 1e-3).astype(F32),
                        -(a[750:].astype(np.float64) * b[750:]).astype(F32)])
    got = fmaf(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = F32(float(exact))
        cands = [np.nextafter(near, F32(-np.inf)), near, np.nextafter(near, F32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.uint32)) & 1))
        assert np.array(g).view(np.uint32) == np.array(best).view(np.uint32)


def test_quotient_equals_ieee_division():
    """The division-free quotient against numpy's float32 x / norm, bit for
    bit, on 2^21 seed-fixed pairs from the kernel's range: x = h * 2^-31
    for any int32 h; norms log-uniform in [2^-10, 16] (||v|| <= 16 at
    M <= 256), uniform over [4, 8] (the main path's M = 64 gives about
    4.6), and every 8th float32 significand in [4, 8)."""
    rng = np.random.Generator(np.random.PCG64(18))
    k = 1 << 19
    norms = np.concatenate([
        np.exp2(rng.uniform(-10, 4, size=k)).astype(F32),
        rng.uniform(4, 8, size=k).astype(F32),
        (np.arange(0, 1 << 23, 8, dtype=np.uint32) | np.uint32(0x40800000)).view(F32),
    ]) + F32(1e-12)
    h = rng.integers(-2**31, 2**31, size=norms.shape[0], dtype=np.int64).astype(np.int32)
    h[:64] = [-2**31, 2**31 - 1, 0, 1, -1] + list(range(2**31 - 59, 2**31))
    f = h.astype(F32)
    x = f * F32(2.0**-31)
    got = quotient(f, norms, F32(1) / norms)
    want = x / norms
    assert norms.shape[0] >= 10**6
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # without the residual step the product alone is often one ulp off
    assert np.sum((x * (F32(1) / norms)).view(np.uint32) != want.view(np.uint32)) > k // 10

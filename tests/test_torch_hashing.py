"""Port hashing substrate vs the JAX reference: constants, the plain
versions of kernel A (gear / Rabin windowed sums, candidate words), and
u32 arithmetic carried in int64. Integer outputs are bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.kernels import gear_hash as ref_gear
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import hashing
from repro_torch.kernels import gear_hash, ops

torch.set_num_threads(1)


def _bytes(n, seed):
    return np.random.Generator(np.random.PCG64(seed)).integers(0, 256, size=n, dtype=np.uint8)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_constants_match_reference():
    assert np.array_equal(hashing.GEAR_TABLE, ref_hashing.GEAR_TABLE)
    assert np.array_equal(hashing.GEAR_WEIGHTS, ref_hashing.GEAR_WEIGHTS)
    assert hashing.POLY_P == ref_hashing.POLY_P
    assert hashing.RABIN_WINDOW == ref_hashing.RABIN_WINDOW
    assert hashing.GEAR_WINDOW == ref_hashing.GEAR_WINDOW
    assert np.array_equal(hashing.poly_powers(48), ref_hashing.poly_powers(48))
    for m in (40, 64):
        a, b = ref_hashing.multiply_shift_params(m)
        pa, pb = hashing.multiply_shift_params(m)
        assert np.array_equal(a, pa) and np.array_equal(b, pb)
    a, b = ref_hashing.multiply_shift_params(64)
    convert.check_constants(ref_hashing.GEAR_TABLE, a, b)
    with pytest.raises(AssertionError):
        convert.check_constants(ref_hashing.GEAR_TABLE ^ np.uint32(1), a, b)


@pytest.mark.parametrize("n", [100, 8192, 8193, 40000])
def test_gear_hashes_vs_reference(n):
    data = _bytes(n, n)
    got = _u32(ops.gear_hashes(torch.from_numpy(data)))
    assert np.array_equal(got, np.asarray(ref_ops.gear_hashes(jnp.asarray(data))))
    serial = ref_hashing.gear_hashes_serial_np(data)
    w = ref_hashing.GEAR_WINDOW
    assert np.array_equal(got[w:], serial[w:])


@pytest.mark.parametrize("n", [100, 8192, 8193, 40000])
def test_rabin_fps_vs_reference(n):
    data = _bytes(n, n + 1)
    got = _u32(ops.rabin_fps(torch.from_numpy(data)))
    assert np.array_equal(got, np.asarray(ref_ops.rabin_fps(jnp.asarray(data))))
    assert np.array_equal(got, ref_hashing.rabin_fps_np(data))


@pytest.mark.parametrize("taps", [4, 32, 48])
def test_windowed_sum_vs_pallas_rows(taps):
    """Kernel A's arithmetic over the flattened stream equals the Pallas
    kernel over its [R, C] row layout (row-0 halo zero)."""
    rng = np.random.Generator(np.random.PCG64(taps))
    g = rng.integers(0, 2**32, size=(3, 512), dtype=np.uint32)
    weights = tuple(int(w) for w in ref_hashing.poly_powers(taps))
    want = np.asarray(ref_gear.windowed_sum(jnp.asarray(g), weights, interpret=True))
    flat = torch.from_numpy(g.reshape(-1).astype(np.int64))
    got = _u32(hashing.to_i32_bits(
        hashing.windowed_weighted_sum(flat, np.asarray(weights, np.uint32))))
    assert np.array_equal(got, want.reshape(-1))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 8193])
def test_scan_candidate_words_roundtrip(n):
    data = _bytes(n, 7 * n)
    h, ws, wl = ops.scan_candidates(torch.from_numpy(data), 0xFF, 0xF)
    ref = ref_hashing.gear_hashes_np(data)
    assert np.array_equal(_u32(h), ref)
    assert ws.shape[0] == -(-n // 32)
    assert np.array_equal(gear_hash.unpack_bits(ws.numpy(), n), (ref & np.uint32(0xFF)) == 0)
    assert np.array_equal(gear_hash.unpack_bits(wl.numpy(), n), (ref & np.uint32(0xF)) == 0)


@pytest.mark.parametrize("size", [1, 7, 10_000])
def test_mul_u32_keeps_low_32_bits_through_int64_overflow(size):
    """A u32 x u32 product passes 2^63 in int64 and wraps; the low 32 bits
    stay exact (scalar and vectorised CPU loops alike)."""
    rng = np.random.Generator(np.random.PCG64(3))
    x = rng.integers(0, 2**32, size=size, dtype=np.uint32)
    m = rng.integers(0, 2**32, size=size, dtype=np.uint32)
    m[:4] = [0, 1, 0xFFFFFFFF, 0x80000000][:size]
    x[:4] = 0xFFFFFFFF
    tx, tm = torch.from_numpy(x.astype(np.int64)), torch.from_numpy(m.astype(np.int64))
    assert bool(((tx * tm) < 0).any()) == (size > 1)    # the product did wrap
    got = hashing.mul_u32(tx, tm)
    assert np.array_equal(got.numpy().astype(np.uint32), x * m)   # numpy wraps
    assert int(got.max()) < 2**32 and int(got.min()) >= 0
    scalar = hashing.mul_u32(tx, int(m[-1]))
    assert np.array_equal(scalar.numpy().astype(np.uint32), x * m[-1])


def test_i32_bits_roundtrip():
    vals = np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    t = hashing.u32_tensor(vals, "cpu")
    bits = hashing.to_i32_bits(t)
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), vals)
    assert torch.equal(hashing.from_i32_bits(bits), t)


def test_multiply_shift_unit_vs_reference():
    rng = np.random.Generator(np.random.PCG64(5))
    x = rng.integers(0, 2**32, size=(7, 13), dtype=np.uint32)
    a, b = ref_hashing.multiply_shift_params(64)
    want = np.asarray(ref_hashing.multiply_shift_unit_j(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    got = hashing.multiply_shift_unit(hashing.u32_tensor(x, "cpu"),
                                      hashing.u32_tensor(a, "cpu"),
                                      hashing.u32_tensor(b, "cpu"))
    assert np.array_equal(got.numpy(), want)

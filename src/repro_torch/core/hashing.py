"""Hashing substrate for CARD (port of ``repro.core.hashing``).

Every rolling hash the system uses is linear over Z/2^32, so each
position's windowed hash is a W-tap weighted correlation:

    h_i = sum_k  w_k * g_{i-k}      (mod 2^32)

which the scan kernel (``kernels/csrc/gear_hash.cu``) evaluates fully in
parallel. This module keeps its own copy of the tables and constants,
regenerated with numpy from the reference's seeds, and the plain-torch
versions of the reference's jnp functions.

PyTorch on the CPU has no uint32 ``+``, ``<<`` or ``max``, so plain-torch
code carries a 32-bit hash as int64 holding a value in [0, 2^32)
("u32 in int64"); that keeps unsigned order for the sub-chunk max.
Tensors that hold hashes at rest (the scan output, shingle ids handed to
the embed kernel) are int32 carrying the same 32 bits; ``to_i32_bits`` /
``from_i32_bits`` convert between the two.
"""
from __future__ import annotations

import numpy as np
import torch

# ----------------------------------------------------------------------------
# Deterministic tables / constants (same seeds as the reference)
# ----------------------------------------------------------------------------

_GEAR_SEED = 0xC0FFEE
GEAR_WINDOW = 32  # uint32: shifts >= 32 vanish, so the effective window is 32B

# Odd multiplier for polynomial hashes (invertible mod 2^32).
POLY_P = np.uint32(0x01000193)  # FNV prime, odd
RABIN_WINDOW = 48

_rng = np.random.Generator(np.random.PCG64(_GEAR_SEED))
GEAR_TABLE = _rng.integers(0, 2**32, size=256, dtype=np.uint32)

U32 = 0xFFFFFFFF


def modinv_pow2(a: int, bits: int = 32) -> int:
    """Inverse of odd ``a`` modulo 2**bits (Newton iteration)."""
    if a % 2 != 1:
        raise ValueError(f"{a} is even: it has no inverse mod 2^{bits}")
    x = a  # correct mod 2^3
    for _ in range(6):
        x = (x * (2 - a * x)) % (1 << bits)
    return x % (1 << bits)


POLY_P_INV = np.uint32(modinv_pow2(int(POLY_P)))


def poly_powers(n: int, p: np.uint32 = POLY_P) -> np.ndarray:
    """[p^0, p^1, ..., p^{n-1}] as uint32 (wrapping)."""
    out = np.empty(n, dtype=np.uint32)
    acc = np.uint32(1)
    for i in range(n):
        out[i] = acc
        acc = np.uint32((int(acc) * int(p)) & 0xFFFFFFFF)
    return out


GEAR_WEIGHTS = (np.uint32(1) << np.arange(GEAR_WINDOW, dtype=np.uint32))

# Multiply-shift universal hashing (used by shingle feature embedding).
_MS_SEED = 0xD00DFEED


def multiply_shift_params(m: int, seed: int = _MS_SEED) -> tuple[np.ndarray, np.ndarray]:
    """M pairs (a, b): h_i(x) = a_i * x + b_i (uint32, high bits are best)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    a = rng.integers(1, 2**32, size=m, dtype=np.uint32) | np.uint32(1)  # odd
    b = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    return a, b


# ----------------------------------------------------------------------------
# u32-in-int64 arithmetic
# ----------------------------------------------------------------------------

def mul_u32(x: torch.Tensor, m: int | torch.Tensor) -> torch.Tensor:
    """(x * m) mod 2^32 for x, m in [0, 2^32).

    The int64 product of two such values can pass 2^63 and wrap, but
    wraparound is mod 2^64, so its low 32 bits stay exact
    (``tests/test_torch_hashing.py`` pins this on the CPU; the card's
    64-bit multiply wraps the same way).
    """
    return (x * m) & U32


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32-in-int64 -> int32 holding the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def from_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 holding 32 hash bits -> u32-in-int64."""
    return x.to(torch.int64) & U32


def u32_tensor(values: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Host uint32 array -> u32-in-int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(values, np.uint32).astype(np.int64)).to(device)


# ----------------------------------------------------------------------------
# Plain-torch versions of the reference's jnp functions
# ----------------------------------------------------------------------------

def windowed_weighted_sum(g: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """h_i = sum_k weights[k] * g_{i-k} (mod 2^32) over the last axis.

    ``g`` is u32-in-int64 ([n] or [..., n]); positions before 0 contribute
    0. Returns u32-in-int64.
    """
    n = g.shape[-1]
    h = torch.zeros_like(g)
    for k, w in enumerate(np.asarray(weights, dtype=np.uint32)[:n]):
        # each term is < 2^32 and there are at most 64 of them: the sum
        # stays far inside int64, so one mask at the end suffices
        h[..., k:] += mul_u32(g[..., :n - k], int(w))
    return h & U32


def gear_hashes(data: torch.Tensor) -> torch.Tensor:
    """[n] uint8 -> [n] u32-in-int64 windowed gear hashes."""
    table = u32_tensor(GEAR_TABLE, data.device)
    return windowed_weighted_sum(table[data.long()], GEAR_WEIGHTS)


def rabin_fps(data: torch.Tensor, window: int = RABIN_WINDOW) -> torch.Tensor:
    """[n] uint8 -> [n] u32-in-int64 windowed polynomial fingerprints."""
    return windowed_weighted_sum(data.long(), poly_powers(window))


def pow_table(base: int, n: int, device: torch.device | str) -> torch.Tensor:
    """[base^0, base^1, ..., base^(n-1)] mod 2^32 as u32-in-int64 on
    ``device``, by doubling: the second half of a table of 2^j powers is
    its first half times base^(2^j), so the table takes log2(n) products
    and no loop over its entries."""
    out = torch.ones(max(n, 1), dtype=torch.int64, device=device)
    have, step = 1, int(base) & U32                 # step = base^have
    while have < n:
        take = min(have, n - have)
        out[have:have + take] = mul_u32(out[:take], step)
        have += take
        step = (step * step) & U32
    return out[:n]


def segment_poly_hashes(data: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Polynomial hash h = h*p + b (mod 2^32) of each segment
    [bounds[..., i], bounds[..., i+1]) of the byte buffer ``data`` ([n]
    uint8); ``bounds`` [..., S+1] int64 positions in [0, n], ascending
    along the last axis. Returns [..., S] u32-in-int64.

    Prefix-sum form, as the reference's ``segment_poly_hashes_np``:

        P_i = sum_{j<i} b_j * p^{-(j+1)}             (mod 2^32)
        hash(l, r) = (P_r - P_l) * p^r               (mod 2^32)

    The product depends on r - l and the bytes only, so the segments of
    many chunks laid end to end in one buffer hash in one prefix sum.
    Each term is below 2^40 and int64 wraparound is mod 2^64, so the low
    32 bits of the sum are exact at any length."""
    n = data.shape[0]
    dev = data.device
    ipows = mul_u32(pow_table(int(POLY_P_INV), n, dev), int(POLY_P_INV))   # p^-(j+1)
    prefix = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    prefix[1:] = torch.cumsum(data.long() * ipows, 0)
    prefix &= U32
    pows = pow_table(int(POLY_P), n + 1, dev)
    lo, hi = bounds[..., :-1], bounds[..., 1:]
    return mul_u32((prefix[hi] - prefix[lo]) & U32, pows[hi])


def poly_hash(data: torch.Tensor) -> int:
    """Whole-buffer polynomial hash h = h*p + b (mod 2^32) of [n] uint8."""
    bounds = torch.tensor([0, data.shape[0]], dtype=torch.int64, device=data.device)
    return int(segment_poly_hashes(data, bounds)[0])


def multiply_shift_unit(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Map u32-in-int64 x [...] through M hash funcs -> float32 [..., M] in [-1, 1).

    out[..., i] = int32(a_i * x + b_i) / 2^31, with ``a``/``b`` u32-in-int64 [M].
    """
    h = (mul_u32(x[..., None], a) + b) & U32
    signed = h - ((h >> 31) << 32)
    return signed.to(torch.float32) * (2.0 ** -31)

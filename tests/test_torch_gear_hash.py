"""Kernel A's rolling recurrence, on the CPU: a numpy twin of what each
thread of ``csrc/gear_hash.cu`` computes, held bit for bit against the
reference (``repro.kernels.gear_hash.windowed_sum`` in interpret mode
through ``repro.kernels.ops``, and the numpy hashes of
``repro.core.hashing``); and the launcher's refusal of taps that are not
geometric. The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.kernels import ops as ref_ops
from repro_torch.core import hashing
from repro_torch.kernels import gear_hash

torch.set_num_threads(1)

RUN = 32              # positions per thread (csrc kRun)
BLOCK = 256 * RUN     # positions per block (csrc kBlockPos)
HALO = 64             # staged bytes before a block (csrc kHalo)


def rolling_twin(g: np.ndarray, r: int, taps: int, subtract: bool,
                 masks: tuple[int, int]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every thread at once: g [n] uint32 -> (hashes [n], cand_s, cand_l
    words). Thread t owns positions s = 32t .. 32t+31; it warms up over
    s-(W-1) .. s-1 from h = 0 (g before position 0 is 0, so no clamp),
    then rolls h = r*h + g_i - r^W*g_{i-W}, subtracting nothing at i = s."""
    n = g.shape[0]
    threads = -(-n // RUN)
    ext = np.zeros(HALO + threads * RUN, np.uint32)   # ext[HALO + p] = g_p
    ext[HALO:HALO + n] = g
    s = HALO + RUN * np.arange(threads)
    r, r_w = np.uint32(r), np.uint32(pow(r, taps, 2**32))
    h = np.zeros(threads, np.uint32)
    for k in range(taps - 1, 0, -1):
        h = h * r + ext[s - k]
    out = np.empty((threads, RUN), np.uint32)
    for i in range(RUN):
        h = h * r + ext[s + i]
        if subtract and i > 0:
            h = h - r_w * ext[s + i - taps]
        out[:, i] = h
    keep = (np.arange(threads * RUN) < n).reshape(threads, RUN)
    shifts = np.arange(RUN, dtype=np.uint64)
    words = [((((out & np.uint32(m)) == 0) & keep).astype(np.uint64) << shifts)
             .sum(axis=1).astype(np.uint32) for m in masks]
    return out.reshape(-1)[:n], words[0], words[1]


SIZES = [1, 15, 16, 31, 32, 33, 47, 48, RUN - 1, RUN + 1, BLOCK - 1, BLOCK + 1, 70_000]
MASKS = (0x1FFF, 0x7F)


def _bytes(n: int) -> np.ndarray:
    return np.random.Generator(np.random.PCG64(1000 + n)).integers(0, 256, size=n, dtype=np.uint8)


def _words(h: np.ndarray, mask: int) -> np.ndarray:
    bits = torch.from_numpy((h & np.uint32(mask)) == 0)
    return gear_hash.pack_bits(bits).numpy().view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
def test_gear_twin_vs_reference(n):
    data = _bytes(n)
    r = gear_hash.geometric_ratio(hashing.GEAR_WEIGHTS)
    assert r == 2 and pow(r, hashing.GEAR_WINDOW, 2**32) == 0
    h, ws, wl = rolling_twin(hashing.GEAR_TABLE[data], r, hashing.GEAR_WINDOW,
                             subtract=False, masks=MASKS)
    want = ref_hashing.gear_hashes_np(data)
    assert np.array_equal(h, want)
    assert np.array_equal(h, np.asarray(ref_ops.gear_hashes(jnp.asarray(data))))
    assert np.array_equal(ws, _words(want, MASKS[0]))
    assert np.array_equal(wl, _words(want, MASKS[1]))


@pytest.mark.parametrize("window", [16, 48])
@pytest.mark.parametrize("n", SIZES)
def test_rabin_twin_vs_reference(n, window):
    data = _bytes(n)
    r = gear_hash.geometric_ratio(hashing.poly_powers(window))
    assert r == int(hashing.POLY_P)
    h, _, _ = rolling_twin(data.astype(np.uint32), r, window, subtract=True, masks=MASKS)
    want = ref_hashing.rabin_fps_np(data, window)
    assert np.array_equal(h, want)
    if n in (window - 1, window, BLOCK + 1):
        assert np.array_equal(h, np.asarray(ref_ops.rabin_fps(jnp.asarray(data), window)))


def test_wrapper_refuses_non_geometric_taps():
    """The launcher checks the taps before it touches the card, so a CPU
    tensor shows the refusal; no launch is counted."""
    data = torch.zeros(64, dtype=torch.uint8)
    bad = hashing.poly_powers(8).copy()
    bad[5] ^= np.uint32(1)
    for taps in (bad, np.asarray([1, 3, 5], np.uint32), np.asarray([2, 4], np.uint32),
                 np.zeros(0, np.uint32)):
        with pytest.raises(ValueError, match="geometric"):
            gear_hash.windowed_sum_cuda(data, taps, gear=False)
    assert gear_hash.geometric_ratio(np.asarray([1], np.uint32)) == 0

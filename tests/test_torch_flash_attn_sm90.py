"""The arithmetic of kernel D's tensor-core route (``csrc/flash_attn_sm90.cu``)
on the CPU, where the kernel itself cannot run.

``_sm90_twin`` repeats the kernel's schedule in plain torch: bf16 operands
with f32 products, 128-query blocks over key tiles of the kernel's width,
tiles wholly above the diagonal skipped, S multiplied by scale·log2(e)
after the product, the online softmax with exp2 and f32 (m, l, O), l
summed from the f32 P, P·V as ``bf16(P)·V + bf16(P - bf16(P))·V`` into
one f32 O, and ``O / max(l, 1e-20)`` rounded to bf16 once. It is held to
the Pallas kernel (interpret mode, bf16 in and out) within one bf16
rounding step: rtol 2^-7 of the value plus atol 2e-5 (``BF16_ULP``,
``F32_TOL`` of ``tests/test_torch_flash_attn.py``), the bound that
``chip_smoke.py`` holds the kernel to on the card. The same twin with P
rounded once to bf16 (the usual tensor-core recipe) breaks that bound,
which is why the kernel splits P. Inputs are numpy draws from fixed
seeds, so every run sees the same numbers.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as ref_fa
from repro_torch.kernels import flash_attn, ops

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_ULP = 2.0 ** -7
LOG2E = 1.4426950408889634
SOURCE = Path(__file__).resolve().parents[1] / flash_attn.SOURCE


def _tile(name: str) -> int:
    """A tile constant of the kernel's source (kBq, kBk)."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


Q_BLOCK, KEY_TILE = _tile("kBq"), _tile("kBk")


def _inputs(b, h, kv, tq, tk, hd, seed):
    """Model layout [B, T, heads, hd] f32 numpy, from a fixed seed."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.standard_normal((b, tq, h, hd)).astype(np.float32),
            rng.standard_normal((b, tk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, tk, kv, hd)).astype(np.float32))


def _sm90_twin(q, k, v, causal, split=True):
    """The kernel's arithmetic: model-layout numpy in, f32 numpy of the bf16
    output out (bf16(P) alone for P·V when ``split`` is False)."""
    qb, kb, vb = (torch.from_numpy(x).bfloat16().float().permute(0, 2, 1, 3)
                  for x in (q, k, v))                       # [B, heads, T, hd]
    b, h, tq, hd = qb.shape
    kvh, tk = kb.shape[1], kb.shape[2]
    kb, vb = (x.repeat_interleave(h // kvh, dim=1) for x in (kb, vb))
    scale_log2 = torch.tensor(flash_attn.scale_of(hd), dtype=torch.float32) * LOG2E
    out = torch.empty(b, h, tq, hd)
    for q0 in range(0, tq, Q_BLOCK):
        rows = qb[:, :, q0:q0 + Q_BLOCK]
        qpos = torch.arange(q0, q0 + rows.shape[2])[:, None]
        m = torch.full((b, h, rows.shape[2], 1), -1e30)
        l = torch.zeros(b, h, rows.shape[2], 1)
        o = torch.zeros(b, h, rows.shape[2], hd)
        k_end = min(tk, q0 + Q_BLOCK) if causal else tk
        for k0 in range(0, k_end, KEY_TILE):
            k1 = min(tk, k0 + KEY_TILE)
            s = (rows @ kb[:, :, k0:k1].transpose(-1, -2)) * scale_log2
            if causal:
                s.masked_fill_(torch.arange(k0, k1)[None, :] > qpos, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            hi = p.bfloat16().float()
            pv = hi @ vb[:, :, k0:k1]
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vb[:, :, k0:k1]
            o = o * alpha + pv
            m = m_new
        out[:, :, q0:q0 + rows.shape[2]] = (o / l.clamp_min(1e-20)).bfloat16().float()
    return out.permute(0, 2, 1, 3).numpy()


def _pallas_bf16(q, k, v, causal):
    """The reference kernel in interpret mode, bf16 in and out."""
    t = lambda x: jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3)
    out = ref_fa.flash_attention(t(q), t(k), t(v), causal=causal, block_q=128,
                                 block_k=128, interpret=True)
    return np.asarray(out.transpose(0, 2, 1, 3), np.float32)


def _bound_used(got, want) -> float:
    """The largest share of the one-rounding-step bound that ``got`` uses."""
    return float(np.max(np.abs(got - want) / (F32_TOL + BF16_ULP * np.abs(want))))


# granite-8b's GQA group of 4 and hd 128, heads cut 32/8 -> 8/2; one
# non-causal Tq != Tk case at the kernel's other hd; then the cross and
# encoder paths, non-causal: llama-vision's decode cross (Tq 1 over its
# 1601 image tokens, one key past a 64-key tile), whisper's encoder (GQA
# group 1 at hd 64, 300 frames: ragged against both tiles) and its cross
# (Tq >> Tk, group 1), and a ragged Tk under 128-query blocks at hd 128
CASES = [(1, 8, 2, 512, 512, 128, True),
         (1, 8, 2, 1024, 1024, 128, True),
         (1, 8, 2, 200, 520, 64, False),
         (1, 8, 2, 1, 1601, 128, False),
         (1, 8, 8, 300, 300, 64, False),
         (1, 8, 8, 600, 150, 64, False),
         (1, 8, 2, 256, 129, 128, False)]


@pytest.fixture(scope="module")
def reference():
    """Pallas outputs of CASES, computed once for the module."""
    return {c: _pallas_bf16(*_inputs(*c[:-1], seed=i), c[-1]) for i, c in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sm90_twin_within_one_rounding_step(reference, case):
    q, k, v = _inputs(*case[:-1], seed=CASES.index(case))
    got, want = _sm90_twin(q, k, v, case[-1]), reference[case]
    used = _bound_used(got, want)
    assert used <= 1.0, used
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_sm90_twin_needs_the_split(reference):
    """bf16-only P breaks the bound on granite's heads; the split keeps it."""
    case = CASES[0]
    q, k, v = _inputs(*case[:-1], seed=0)
    want = reference[case]
    split = _bound_used(_sm90_twin(q, k, v, True), want)
    bf16_only = _bound_used(_sm90_twin(q, k, v, True, split=False), want)
    assert split <= 1.0 < bf16_only, (split, bf16_only)


def test_twin_tiles_are_the_kernel_s():
    """The twin reads its tiles from the kernel source; both are what the
    kernel's comment and the launch assume: 128 query rows (two wgmma M of
    64) and key tiles of 64 or 128."""
    assert Q_BLOCK == 128 and KEY_TILE in (64, 128)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 100, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt")])
def test_route_follows_dtype_and_hd(dtype, hd, want):
    assert flash_attn.route(dtype, hd) == want


def test_cpu_bf16_takes_the_plain_version_on_either_route():
    ops.reset_launches()
    for hd in (128, 100):
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 4, 2, 40, 40, hd, 3))
        out = ops.flash_attention(q, k, v)
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_sm90"] == 0

"""Kernel D of the port: ``ops.flash_attention`` (its plain version on CPU
tensors) against three references of the JAX package — the Pallas kernel
in interpret mode, its model-layout wrapper, and the jnp twin
``models.layers._chunked_attention`` (``q_offset=0``) — over the shapes of
``tests/test_kernels.py::TestFlashAttention`` (T cut to <= 300 so Pallas
interpret mode stays fast); the wrapper's dispatch, launch counter and
input checks; and, on a machine with an NVIDIA card, the CUDA kernels
against their plain version, with the route each shape takes. The
tensor-core route's arithmetic is held on the CPU in
``tests/test_torch_flash_attn_sm90.py``.

Tolerances are those of ``TestFlashAttention``: f32 2e-5 and bf16 2e-2.
Measured on these inputs against the Pallas kernel: at most 4.8e-7 in
f32 (two orders of f32 sums over <= 300 keys), a 40x margin, and 9.8e-4
in bf16 (one bf16 rounding of outputs of size ~1, where an ulp is up to
7.8e-3), a 20x margin. The bf16 case is also held to one bf16 ulp of the
value plus F32_TOL (``BF16_ULP``), a bound from the arithmetic: 0.67 of it
is used, the 9.8e-4 being one ulp at a value in [0.125, 0.25).

Why not ``ref.flash_attention_ref``: it aligns the causal mask at the end
(``tril(k=tk - tq)``, ``kernels/ref.py:47``), while the kernel and
``_chunked_attention`` align it at the start (``kpos <= qpos``). The two
agree only when Tq == Tk, so a causal Tq != Tk case is held to the two
start-aligned references.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as ref_fa
from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attn, ops

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 2e-2
# Both sides compute in f32 and round the output to bf16 once, so they may
# differ by one bf16 ulp (at most 2**-7 of the value) plus the f32 results'
# own disagreement (F32_TOL): a far tighter hold on the bf16 load and store
# path than BF16_TOL.
BF16_ULP = 2.0 ** -7


def _inputs(b, h, kv, tq, tk, hd, seed):
    """Model layout [B, T, H, hd] in f32, from numpy."""
    rng = np.random.Generator(np.random.PCG64(seed))
    q = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, tk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, tk, kv, hd)).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return ops.flash_attention(*args, causal=causal).float().numpy()


def _pallas(q, k, v, causal, dtype=jnp.float32):
    """The reference kernel in interpret mode, in its [B, H, T, hd] layout."""
    t = lambda x: jnp.asarray(x, dtype).transpose(0, 2, 1, 3)
    out = ref_fa.flash_attention(t(q), t(k), t(v), causal=causal, block_q=128,
                                 block_k=128, interpret=True)
    return np.asarray(out.transpose(0, 2, 1, 3), np.float32)


SHAPES = [
    (2, 8, 4, 300, 300, 32, True),
    (1, 4, 4, 256, 256, 64, True),
    (2, 8, 2, 128, 288, 32, False),    # non-causal, Tq != Tk
    (1, 6, 3, 257, 257, 16, True),     # ragged vs the block size
    (1, 4, 2, 100, 260, 32, True),     # causal, Tq != Tk (start-aligned)
    # the cross-attention and encoder paths: non-causal throughout
    (2, 8, 2, 1, 160, 32, False),      # Tq 1: cross-attention in a decode step
    (1, 8, 8, 150, 150, 64, False),    # GQA group 1 (whisper), the encoder's self-attention
    (1, 4, 2, 96, 129, 32, False),     # ragged Tk, one key past a block (1601 = 25 * 64 + 1)
    (1, 4, 1, 300, 17, 32, False),     # Tq >> Tk: a long prompt over a short memory
]


@pytest.mark.parametrize("b,h,kv,tq,tk,hd,causal", SHAPES)
def test_plain_vs_pallas_kernel_f32(b, h, kv, tq, tk, hd, causal):
    q, k, v = _inputs(b, h, kv, tq, tk, hd, b * h + tq + tk)
    np.testing.assert_allclose(_port(q, k, v, causal), _pallas(q, k, v, causal),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_vs_pallas_kernel_bf16():
    q, k, v = _inputs(1, 8, 4, 256, 256, 64, 9)
    got = _port(q, k, v, True, torch.bfloat16)
    want = _pallas(q, k, v, True, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_vs_reference_model_layout_wrapper(causal):
    q, k, v = _inputs(2, 8, 2, 160, 160, 32, 11)
    want = np.asarray(ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(_port(q, k, v, causal), want,
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("b,h,kv,tq,tk,hd,causal",
                         [s for s in SHAPES if s[-1]], ids=str)
def test_plain_vs_chunked_attention(b, h, kv, tq, tk, hd, causal):
    """Causal only: ``_chunked_attention`` masks padded keys through the
    causal mask alone (its non-causal mask drops nothing past Tk)."""
    q, k, v = _inputs(b, h, kv, tq, tk, hd, 3 * tq + tk)
    want = np.asarray(ref_layers._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, q_offset=0,
        kv_block=128))
    np.testing.assert_allclose(_port(q, k, v, True), want, rtol=F32_TOL, atol=F32_TOL)


def test_causal_mask_is_start_aligned():
    """Query t sees keys 0..t even when Tq < Tk: changing keys past the
    last query position changes nothing."""
    q, k, v = _inputs(1, 4, 2, 50, 120, 16, 5)
    k2, v2 = k.copy(), v.copy()
    k2[:, 50:] += 3.0
    v2[:, 50:] -= 7.0
    assert np.array_equal(_port(q, k, v, True), _port(q, k2, v2, True))
    assert not np.array_equal(_port(q, k, v, False), _port(q, k2, v2, False))


def test_cpu_tensors_take_the_plain_version_without_launching():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 33, 33, 16, 1))
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_contiguous()
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_sm90"] == 0


@pytest.mark.parametrize("case", ["dtype", "mixed", "ndim", "stride", "groups",
                                  "kv_shape", "empty_keys", "empty_queries"])
def test_wrapper_rejects_bad_inputs(case):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 16, 16, 8, 2))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        q = q.bfloat16()
    elif case == "ndim":
        q = q[0]
    elif case == "stride":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "groups":
        q = torch.cat([q, q[:, :, :1]], dim=2)          # H = 5, KV = 2
    elif case == "kv_shape":
        v = v[:, :8].contiguous()
    elif case == "empty_keys":
        k, v = k[:, :0], v[:, :0]
    elif case == "empty_queries":
        q = q[:, :0]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Kernel D against its plain version on the card, f32 and bf16, over
    the CPU shapes and granite's heads (chip_smoke.py runs the same checks
    at full length), with the route each shape takes: bf16 at hd 64 or 128
    on the tensor cores (``flash_attention_sm90``), the rest on the SIMT
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops.reset_launches()
    shapes = SHAPES + [(1, 32, 8, 1000, 1000, 128, True), (1, 32, 8, 1000, 1000, 64, True),
                       (2, 32, 8, 700, 1500, 128, True), (1, 4, 4, 70, 70, 100, True)]
    sm90 = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for b, h, kv, tq, tk, hd, causal in shapes:
            q = torch.randn(b, tq, h, hd, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, tk, kv, hd, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, tk, kv, hd, device=dev, generator=gen).to(dtype)
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            tensor_cores = dtype == torch.bfloat16 and hd in (64, 128)
            assert flash_attn.route(dtype, hd) == ("sm90" if tensor_cores else "simt")
            assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
            assert (ops.LAUNCHES["flash_attention_sm90"]
                    == before["flash_attention_sm90"] + int(tensor_cores))
            sm90 += int(tensor_cores)
            want = flash_attn.flash_attention_plain(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal)
            torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                                       rtol=tol, atol=tol)
            if dtype == torch.bfloat16:
                torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                                           rtol=BF16_ULP, atol=F32_TOL)
    assert ops.LAUNCHES["flash_attention"] == 2 * len(shapes)
    assert ops.LAUNCHES["flash_attention_sm90"] == sm90 == sum(
        s[5] in (64, 128) for s in shapes)

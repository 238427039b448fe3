"""Kernel D's gradient in the port: ``ops.flash_attention`` on tensors that
require grad goes through ``ops._FlashAttention``, whose backward is
``flash_attn.flash_attention_plain_grad``. Held against ``jax.vjp`` of the
reference's ``models.layers._dense_attention`` (the function the
reference's train path differentiates; it never differentiates its Pallas
kernel) in f32: causal and not, GQA groups 1, 4 and 16, Tq != Tk both
ways, Tq 1 and a ragged Tk; the block loop split into many blocks of
query rows; bf16 inputs; the counters; and, on a machine with a card,
the kernel's forward with this backward against the CPU's.

Tolerances, from measured max errors on these inputs (gradients of
magnitude up to about 10):
- f32, ``F32_TOL`` = 2e-5 absolute plus 2e-5 relative: measured at most
  6.2e-6 absolute over the shapes, a 3x margin on the absolute part
  alone. The two packages sum the same products in other orders, nothing
  more.
- bf16: both sides compute in f32 from the same bf16-rounded inputs and
  the port rounds each gradient to bf16 once, so the port is within one
  bf16 ulp (2**-7 of the value, ``BF16_ULP``) plus ``F32_TOL`` of the f32
  reference on those inputs (measured at most 0.50 of that bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attn, ops

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_ULP = 2.0 ** -7

# (B, H, KV, Tq, Tk, hd, causal)
SHAPES = [
    (2, 4, 4, 37, 37, 32, True),      # GQA group 1
    (1, 8, 2, 50, 50, 64, True),      # group 4
    (1, 16, 1, 40, 40, 16, True),     # group 16
    (2, 4, 1, 20, 45, 32, True),      # Tq < Tk, start-aligned causal mask
    (1, 8, 2, 60, 33, 32, True),      # Tq > Tk
    (2, 8, 2, 1, 77, 64, False),      # Tq 1 (a decode step's cross)
    (1, 4, 4, 33, 129, 32, False),    # ragged Tk, one key past 128
    (1, 16, 4, 30, 17, 48, False),    # Tq > Tk, not causal, group 4
]
IDS = [f"b{b}h{h}kv{kv}q{tq}k{tk}d{hd}{'c' if c else 'n'}" for b, h, kv, tq, tk, hd, c in SHAPES]


def _inputs(b, h, kv, tq, tk, hd, seed):
    """q, k, v and the output gradient in model layout, f32, from numpy."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.standard_normal((b, tq, h, hd)).astype(np.float32),
            rng.standard_normal((b, tk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, tk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, tq, h, hd)).astype(np.float32))


def _reference(q, k, v, do, causal):
    """(out, dq, dk, dv) of the reference's ``_dense_attention`` in f32."""
    out, vjp = jax.vjp(lambda a, b_, c: ref_layers._dense_attention(a, b_, c, causal=causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _port(q, k, v, do, causal, dtype=torch.float32, device="cpu"):
    """(out, dq, dk, dv) of ``ops.flash_attention`` through autograd."""
    ts = [torch.from_numpy(x).to(device=device, dtype=dtype).requires_grad_(True)
          for x in (q, k, v)]
    out = ops.flash_attention(*ts, causal=causal)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do).to(device=device, dtype=dtype))
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


def _close(got, want, rtol, atol):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_grad_matches_reference_dense_attention(shape):
    *dims, causal = shape
    q, k, v, do = _inputs(*dims, seed=sum(dims))
    got = _port(q, k, v, do, causal)
    want = _reference(q, k, v, do, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
    _close(got, want, F32_TOL, F32_TOL)
    # each KV head gets a gradient from its whole group (a causal query 0
    # sees key 0 alone, so its softmax, and its dq, is constant)
    for grad in got[2:]:
        assert (np.abs(grad).sum(axis=(0, 1, 3)) > 0).all()


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4], SHAPES[6]], ids=[IDS[1], IDS[4], IDS[6]])
def test_grad_block_loop(shape, monkeypatch):
    """With room for a few query rows a block, the forward and the
    gradient walk many blocks (ragged last one included) and give what
    one block gives."""
    *dims, causal = shape
    q, k, v, do = _inputs(*dims, seed=3)
    whole = _port(q, k, v, do, causal)
    b, h, _, _, tk, _ = dims
    monkeypatch.setattr(flash_attn, "PLAIN_SCORE_ELEMS", b * h * tk * 7)
    blocks = _port(q, k, v, do, causal)
    _close(blocks, whole, 1e-6, 1e-6)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[5]], ids=[IDS[1], IDS[5]])
def test_grad_bf16_within_one_rounding_of_f32(shape):
    """bf16 inputs: gradients come back in bf16, each within one bf16
    rounding step of the f32 reference on the same rounded inputs."""
    *dims, causal = shape
    q, k, v, do = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in _inputs(*dims, seed=11))
    got = _port(q, k, v, do, causal, dtype=torch.bfloat16)
    want = _reference(q, k, v, do, causal)
    _close(got, want, BF16_ULP, F32_TOL)


def test_grad_dtypes_and_counters():
    """The gradients take their inputs' dtypes; on the CPU nothing is
    counted, with or without a graph; under no_grad the output has no
    graph."""
    q, k, v, _ = _inputs(1, 4, 2, 9, 9, 32, seed=5)
    ops.reset_launches()
    ts = [torch.from_numpy(x).bfloat16().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*ts)
    assert out.requires_grad and out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), ts)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [t.shape for t in ts]
    with torch.no_grad():
        assert not ops.flash_attention(*ts).requires_grad
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.cuda
def test_cuda_forward_kernel_with_plain_gradient():
    """On the card the forward is kernel D (one launch a call, none in
    the backward) and the gradient matches the CPU's: f32 on the SIMT
    route within ``F32_TOL`` (1e-4 relative, chip_smoke's bound), bf16 on
    the tensor cores within one rounding step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    for shape in (SHAPES[1], SHAPES[5], SHAPES[6]):
        *dims, causal = shape
        q, k, v, do = _inputs(*dims, seed=21)
        want = _port(q, k, v, do, causal)
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_ULP)):
            ops.reset_launches()
            got = _port(q, k, v, do, causal, dtype=dtype, device="cuda")
            assert ops.LAUNCHES["flash_attention"] == 1
            assert ops.LAUNCHES["flash_attention_sm90"] == int(
                flash_attn.route(dtype, dims[-1]) == "sm90")
            if dtype == torch.bfloat16:
                want = _port(*(torch.from_numpy(x).bfloat16().float().numpy()
                               for x in (q, k, v, do)), causal)
            _close(got, want, rtol, F32_TOL)

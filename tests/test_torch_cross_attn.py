"""Cross-attention and the audio encoder of the port against the JAX
package on the CPU: the cross sublayer (q from x, k / v from the memory,
nothing rotated, nothing masked) and the encoder's non-causal
self-attention (rotated at ``arange(T_frames)``), each against
``repro.models.layers.attention`` in f32 and bf16; the encoder stack
against ``_encode_audio``; ``extras``' rules (``memory`` wins over
``frames``, a block skips its cross sublayer without a memory, extras of
any dtype and device reach the model's); and which calls of kernel D's
wrapper a prefill and a decode step make. Kernel D's own cases at these
shapes (Tq 1, GQA group 1, a ragged non-causal Tk, Tq >> Tk) are in
``tests/test_torch_flash_attn.py`` and ``test_torch_flash_attn_sm90.py``.

Every input is a seeded numpy normal: zero images or frames give zero K /
V, and a cross output of 0 whatever the code does. The configs are the
``reduced()`` llama-3.2-vision-11b (4 / 1 heads, hd 32, 16 image tokens)
and whisper-base (4 / 4 heads, 32 frames).

Tolerances: f32 ``F32_TOL`` = 5e-5 (measured at most 7.2e-7 on these
sublayers at outputs up to 1.8, 1.7e-6 on the encoder stack at outputs
up to 4.7: the two packages sum in other orders); bf16 ``BF16_TOL`` =
2e-2, rtol and atol, as ``tests/test_torch_lm.py``'s attention sublayer
(measured at most 0.29 of it, one bf16 ulp of 7.8e-3): the reference
rounds q * scale and the probabilities to bf16, kernel D keeps both in
f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro_torch import convert
from repro_torch.configs import base as configs
from repro_torch.kernels import ops
from repro_torch.models import layers, transformer

torch.set_num_threads(1)

F32_TOL = 5e-5
BF16_TOL = 2e-2
ARCHS = ("llama-3.2-vision-11b", "whisper-base")


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(ref_get_config(arch).reduced(), dtype=dtype)
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _attn_pair(ref_cfg, cfg, seed=0):
    """The reference's attention params (``init_attention``) and the port's
    ``Attention`` holding them."""
    params = ref_layers.init_attention(jax.random.PRNGKey(seed), ref_cfg)
    port = layers.Attention(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, p in port.named_parameters():
        p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
    return params, port


def _both(x, dtype):
    """x as the reference's array and the port's tensor, of one dtype."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rtol = 0 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_sublayer_matches_reference(arch, dtype):
    """q from x at 40 positions, k / v from a memory of the arch's length;
    neither side is rotated, none of the memory is masked."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    params, port = _attn_pair(ref_cfg, cfg)
    n_mem = cfg.num_image_tokens or cfg.num_audio_frames
    jx, tx = _both(_normal((2, 40, cfg.d_model), 1), dtype)
    jm, tm = _both(_normal((2, n_mem, cfg.d_model), 2), dtype)
    want, _ = ref_layers.attention(params, jx, ref_cfg, memory=jm)
    got = port(tx, memory=tm)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def test_cross_sublayer_rotates_nothing_and_masks_nothing():
    """Shifting q's positions (a decode step's ``pos``) changes nothing, and
    the last query sees the whole memory (no causal mask): the memory's
    last row matters to the first query too."""
    _, cfg = _cfgs("llama-3.2-vision-11b")
    _, port = _attn_pair(*_cfgs("llama-3.2-vision-11b"))
    x = torch.from_numpy(_normal((1, 3, cfg.d_model), 3))
    mem = torch.from_numpy(_normal((1, 16, cfg.d_model), 4))
    full = port(x, memory=mem)
    step = port(x[:, :1], memory=mem, pos=37)
    torch.testing.assert_close(step, full[:, :1], rtol=0, atol=1e-6)
    mem2 = mem.clone()
    mem2[:, -1] += 1.0
    assert not torch.allclose(port(x[:, :1], memory=mem2), full[:, :1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_self_attention_matches_reference(dtype):
    """whisper's encoder sublayer: non-causal and rotated at arange(T)."""
    ref_cfg, cfg = _cfgs("whisper-base", dtype)
    params, port = _attn_pair(ref_cfg, cfg, seed=1)
    jx, tx = _both(_normal((2, 32, cfg.d_model), 5), dtype)
    want, _ = ref_layers.attention(params, jx, ref_cfg, causal=False)
    got = port(tx, causal=False)
    _close(got, want, dtype)
    # it is neither the causal function nor the unrotated one
    causal, _ = ref_layers.attention(params, jx, ref_cfg, causal=True)
    flat, _ = ref_layers.attention(params, jx, ref_cfg, causal=False, rope=False)
    for other in (causal, flat):
        diff = np.abs(got.float().numpy() - np.asarray(other, np.float32))
        assert diff.max() > 10 * BF16_TOL


@pytest.fixture(scope="module")
def whisper():
    """The reference's reduced whisper-base (f32), its params with every
    encoder norm scale drawn from a seeded normal, and the port's model
    holding them."""
    ref_cfg, cfg = _cfgs("whisper-base")
    params = ref_transformer.init_params(jax.random.PRNGKey(2), ref_cfg)
    leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    for i, tree in enumerate((leaves["encoder"]["ln1"], leaves["encoder"]["ln2"],
                              leaves["enc_norm"])):
        tree["scale"] = 1 + 0.3 * _normal(tree["scale"].shape, 10 + i)
    params = jax.tree_util.tree_map(jnp.asarray, leaves)
    return ref_cfg, params, convert.lm_params_from_jax(leaves, cfg, device="cpu")


def test_encoder_stack_matches_reference(whisper):
    ref_cfg, params, port = whisper
    frames = _normal((2, ref_cfg.num_audio_frames, ref_cfg.d_model), 6)
    want = ref_transformer._encode_audio(params, jnp.asarray(frames), ref_cfg)
    got = port.encode_audio(frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


def test_memory_wins_over_frames(whisper):
    """extras with both ``memory`` and ``frames`` use the memory, in both
    packages; the frames alone give other logits."""
    ref_cfg, params, port = whisper
    toks = np.random.default_rng(0).integers(0, ref_cfg.vocab_size, (2, 12))
    frames = _normal((2, ref_cfg.num_audio_frames, ref_cfg.d_model), 7)
    memory = _normal((2, 20, ref_cfg.d_model), 8)
    both = {"frames": frames, "memory": memory}
    want, _ = ref_transformer.Model(ref_cfg).forward(
        params, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in both.items()}, remat=False)
    got = port(torch.from_numpy(toks), both)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    assert torch.equal(got, port(torch.from_numpy(toks), {"memory": memory}))
    assert not torch.allclose(got, port(torch.from_numpy(toks), {"frames": frames}))


@pytest.mark.parametrize("arch", ARCHS)
def test_block_skips_its_cross_sublayer_without_memory(arch):
    """``_apply_sublayer`` with ``memory=None`` runs the mixer and the FFN
    only; the port's block (with its own cross params, or whisper's
    ``dec_cross`` entry as ``cross_extra``) does the same."""
    ref_cfg, cfg = _cfgs(arch)
    params = ref_transformer.init_params(jax.random.PRNGKey(3), ref_cfg)
    leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    model = convert.lm_params_from_jax(leaves, cfg, device="cpu")
    i = cfg.cross_attn_period - 1 if cfg.cross_attn_period else 0
    period = transformer.block_period(cfg)
    kind = ref_transformer.layer_kinds(ref_cfg)[i]
    p = jax.tree_util.tree_map(lambda a: a[i // period], params["blocks"][i % period])
    ce = (jax.tree_util.tree_map(lambda a: a[i // period], params["dec_cross"][i % period])
          if "dec_cross" in params else None)
    x = _normal((2, 10, cfg.d_model), 9)
    mem = _normal((2, 16, cfg.d_model), 10)
    extra = model.dec_cross[i] if cfg.encoder_layers else None
    for memory in (None, mem):
        want, _, _ = ref_transformer._apply_sublayer(
            jnp.asarray(x), p, kind, ref_cfg, memory=None if memory is None else
            jnp.asarray(memory), cross_extra=ce)
        got, _ = model.blocks[i](torch.from_numpy(x), memory=None if memory is None else
                                 torch.from_numpy(memory), cross_extra=extra)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
        if memory is None:
            skipped = got
    assert not torch.allclose(got, skipped)


@pytest.mark.parametrize("arch", ARCHS)
def test_extras_of_any_dtype_and_device_reach_the_model(arch):
    """A bf16 model given f32 numpy extras, or f32 tensors, computes what it
    computes from the same values as bf16 tensors on its device: the extra
    is cast to the model dtype once, as ``_memory_for`` casts."""
    _, cfg = _cfgs(arch, "bfloat16")
    model = transformer.Model(cfg, device="cpu", seed=1)
    key = "images" if cfg.family == "vlm" else "frames"
    n = cfg.num_image_tokens or cfg.num_audio_frames
    x = _normal((2, n, cfg.d_model), 11)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    want = model.prefill(toks, {key: torch.from_numpy(x).bfloat16()})
    assert want.dtype == torch.bfloat16
    for given in (x, torch.from_numpy(x)):
        assert torch.equal(model.prefill(toks, {key: given}), want)


@pytest.mark.parametrize("arch,prefill,decode", [
    # layers 0-3 self, layer 4 self then cross over the 16 image tokens
    ("llama-3.2-vision-11b", [(40, 40, True)] * 5 + [(40, 16, False)], [(1, 16, False)]),
    # the encoder's 2 layers over 32 frames, then self and cross at each of 4 layers
    ("whisper-base", [(32, 32, False)] * 2 + [(40, 40, True), (40, 32, False)] * 4,
     [(1, 32, False)] * 4),
])
def test_kernel_d_calls_of_a_prefill_and_a_decode_step(arch, prefill, decode, monkeypatch):
    """Every attention without a KV cache calls ``ops.flash_attention``
    once: (Tq, Tk, causal) of each call, in order. A decode step calls it
    for its cross sublayers only (at Tq 1); whisper's step with ``memory``
    runs no encoder. On the CPU nothing is launched."""
    _, cfg = _cfgs(arch)
    model = transformer.Model(cfg, device="cpu", seed=2)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, causal=True: calls.append(
        (q.shape[1], k.shape[1], causal)) or real(q, k, v, causal))
    n = cfg.num_image_tokens or cfg.num_audio_frames
    x = _normal((2, n, cfg.d_model), 12)
    extras = {"images": x} if cfg.family == "vlm" else {"frames": x}
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40)))
    ops.reset_launches()
    model.prefill(toks, extras)
    assert calls == prefill
    if cfg.family == "audio":
        extras = {"memory": model.encode_audio(x)}
    calls.clear()
    model.decode_step(toks[:, :1], model.init_cache(2, 4), extras)
    assert calls == decode
    assert ops.LAUNCHES["flash_attention"] == 0

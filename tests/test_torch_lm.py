"""The LM slice of the port (configs, layers, transformer, serving,
convert) against the JAX package on the CPU: granite-8b ``reduced()`` (4
layers, d 128, 4 heads, 1 KV head) in f32, with the reference's params
carried across by ``convert.lm_params_from_jax``; then the ``reduced()``
configs of granite-3-8b, phi3-medium-14b, chatglm3-6b, qwen3-moe-30b-a3b
and grok-1-314b (MoE, GeLU experts, two virtual experts each), and small
custom configs at GQA groups 8 and 16 and chatglm's half rotary (max
errors measured there: forward 8.5e-6, decode 4.3e-6, aux loss 4.8e-7,
held to the same tolerances); then the SSM and hybrid families:
mamba2-130m (attention-free, tied head) and jamba-v0.1-52b (one period of
8: seven SSM sublayers, one attention, MoE at odd layers), one period and
two, through the converter; then the cross-attention families:
llama-3.2-vision-11b (a cross sublayer at layer 4 of each period of 5;
one period and two) and whisper-base (an encoder of 2 layers over 32
frames, a ``dec_cross`` sublayer at each of its 4 decoder layers), fed
seeded normal ``images`` / ``frames`` (zero extras give zero K / V, and
the cross output would be 0 whatever the code did). Their sublayers alone
are held in ``tests/test_torch_cross_attn.py``.

Tolerances, each from a measured max error on these inputs (logits of
magnitude up to 4.3):
- f32 logits, ``F32_TOL`` = 5e-5 absolute. Measured: forward 6.1e-6,
  prefill 3.5e-6, 10 decode steps 2.9e-6, the port's prefill against its
  own decode 3.0e-6 — an 8x margin over the largest. The two packages sum
  in other orders (XLA's dots against torch's), nothing more.
- bf16, the attention sublayer at 2e-2 (rtol and atol, as
  ``tests/test_archs_smoke.py``): measured at most 0.31 of that bound
  (one bf16 ulp at outputs up to 3.2), a 3x margin. A whole bf16 forward
  is not held to 2e-2: the reference's dense attention rounds q * scale
  and the probabilities to bf16, kernel D keeps them in f32 (as the Pallas
  kernel does), and over 4 layers both bf16 forwards drift ~0.06 from the
  f32 function (measured 0.058 for the reference, 0.062 for the port). So
  the whole bf16 forward is held to that: no further from the f32 logits
  than twice the reference's own bf16 distance.
- greedy ``serve_loop`` tokens: equal.
- the SSM and hybrid ``reduced()`` configs (mamba2-130m, jamba-v0.1-52b,
  with random ``a_log`` / ``dt_bias`` / ``d_skip`` / ``conv_b``) at
  ``F32_TOL``: measured forward 9.8e-6 / 4.0e-5, decode 4.4e-6 / 3.2e-5
  at logits up to 2.1 / 4.2. Jamba's margin is 1.25x: its hidden states
  reach 17, and a float64 run of the reference puts both packages about
  as far from the exact function (port 3.9e-5, reference 2.8e-5).
- the two-period jamba (16 layers), ``TWO_PERIOD_TOL`` = 2e-4: measured
  7.0e-5 at its seed (5.7e-5 to 9.6e-5 over seeds 0-3; both packages
  about 4e-5 from a float64 run). A layer placed at the wrong depth moves
  the logits by O(1).
- llama-3.2-vision-11b and whisper-base ``reduced()`` with extras at
  ``F32_TOL``: measured forward 3.8e-6 / 2.5e-6, decode 2.9e-6 / 2.3e-6
  at logits up to 4.2 / 3.7, a 13x margin; the two-period VLM (10
  layers) the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models import make_model as ref_make_model
from repro.models import transformer as ref_transformer
from repro_torch import convert
from repro_torch.configs import base as configs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Model, make_model
from repro_torch.models import layers, transformer

torch.set_num_threads(1)

F32_TOL = 5e-5
TWO_PERIOD_TOL = 2e-4
BF16_TOL = 2e-2
# the archs ported beside granite-8b: attention stacks, then the SSM and
# hybrid families
NEW_ARCHS = ("granite-3-8b", "phi3-medium-14b", "chatglm3-6b", "qwen3-moe-30b-a3b",
             "grok-1-314b")
SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-base")


def _cfgs(dtype, ref=None):
    ref = dataclasses.replace(ref or ref_get_config("granite-8b").reduced(), dtype=dtype)
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _pair(dtype, seed=0, ref_cfg=None):
    """(reference config, model, params) and the port's model holding them.
    An SSM sublayer's ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b``
    (0, 0, 1 and 0 at init, values that hide a swap of heads or a
    misplaced bias) are drawn from a seeded normal in both packages, and
    so is each norm scale of a cross sublayer and of the encoder (1 at
    init: a scale taken from another layer would not show)."""
    ref_cfg, cfg = _cfgs(dtype, ref_cfg)
    ref = ref_make_model(ref_cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    rng = np.random.default_rng(seed + 20)
    for block in leaves["blocks"]:
        for name in ("a_log", "dt_bias", "d_skip", "conv_b") if "ssm" in block else ():
            block["ssm"][name] = (0.5 * rng.standard_normal(block["ssm"][name].shape)
                                  ).astype(np.float32)
    norms = [t for t in leaves["blocks"] + leaves.get("dec_cross", []) if "ln_cross" in t]
    norms += [leaves[k] for k in ("encoder", "enc_norm") if k in leaves]
    for tree in norms:
        for group in ("ln_cross", "ln1", "ln2", None):
            sub = tree if group is None else tree.get(group)
            if sub is not None and "scale" in sub:
                sub["scale"] = (1 + 0.3 * rng.standard_normal(sub["scale"].shape)
                                ).astype(np.float32)
    params = jax.tree_util.tree_map(lambda x, like: jnp.asarray(x, like.dtype), leaves, params)
    return ref_cfg, ref, params, convert.lm_params_from_jax(leaves, cfg, device="cpu")


def _extras(cfg, batch=2, seed=7):
    """Seeded normal extras as numpy f32 (``images`` for vlm, ``frames``
    for audio; none for the other families); ``_jnp`` gives the
    reference's copy."""
    n = {"vlm": cfg.num_image_tokens, "audio": cfg.num_audio_frames}.get(cfg.family)
    if n is None:
        return None
    x = np.random.default_rng(seed).standard_normal((batch, n, cfg.d_model))
    return {"images" if cfg.family == "vlm" else "frames": x.astype(np.float32)}


def _jnp(extras):
    return None if extras is None else {k: jnp.asarray(v) for k, v in extras.items()}


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, 40))


@pytest.fixture(scope="module")
def ref_forward(f32, tokens):
    _, ref, params, _ = f32
    fwd = jax.jit(lambda p, t: ref.forward(p, t, remat=False)[0])
    return np.asarray(fwd(params, jnp.asarray(tokens)))


def test_config_copy_matches_the_reference():
    port = configs.get_config("granite-8b")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref_get_config("granite-8b"))
    assert port.head_dim == 128 and port.reduced().num_kv_heads == 1
    for arch in NEW_ARCHS + SSM_ARCHS + CROSS_ARCHS:
        assert dataclasses.asdict(configs.get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch)), arch
    for arch in ARCH_IDS:
        ref = ref_get_config(arch)
        mine = configs.ModelConfig(**dataclasses.asdict(ref))
        assert (mine.is_attention_free, mine.supports_long_context) == \
            (ref.is_attention_free, ref.supports_long_context), arch
        assert mine.param_count() == ref.param_count(), arch
        assert mine.active_param_count() == ref.active_param_count(), arch
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced()), arch
        assert [dataclasses.astuple(k) for k in transformer.layer_kinds(mine)] == \
            [dataclasses.astuple(k) for k in ref_transformer.layer_kinds(ref)], arch
        assert transformer.block_period(mine) == ref_transformer.block_period(ref), arch
    assert configs.get_shape("prefill_32k").seq_len == 32_768


@pytest.mark.parametrize("fraction,positions", [(1.0, "1d"), (0.5, "2d"), (0.0, "1d")])
def test_rope_matches_reference(fraction, positions):
    """Full, partial (chatglm's 2D RoPE) and no rotary; [T] and [B, T]
    positions (the decode path's). Measured max error 2.4e-7; held to
    2e-6, an 8x margin."""
    x = np.random.default_rng(4).standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(100, 109) if positions == "1d" else np.full((2, 9), 37)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction, 1e4)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), fraction, 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_rope_uploads_its_frequencies_once_per_device():
    """A decode step runs RoPE twice per layer; a copy from host memory on
    each call would drain the stream every time on the card."""
    layers._freqs_on.cache_clear()
    x = torch.zeros(1, 3, 2, 16)
    for pos in range(4):
        layers.apply_rope(x, torch.full((1, 3), pos), 1.0, 1e4)
    assert layers._freqs_on.cache_info().misses == 1


@pytest.mark.parametrize("get", [configs.get_config, ref_get_config], ids=["port", "ref"])
def test_unknown_arch_raises(get):
    with pytest.raises(KeyError, match="unknown arch"):
        get("llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_equals_reference(arch):
    """The port's ``Model`` has the reference's param tree, leaf for leaf
    and shape for shape, at every arch's ``reduced()`` size: the converter
    takes the reference's tree (it raises on a missing, unexpected or
    misshapen leaf), and the leaf counts agree."""
    ref_cfg = ref_get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    shapes = jax.eval_shape(ref_make_model(ref_cfg).init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = convert.lm_params_from_jax(tree, cfg, device="cpu")
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_forward_matches_reference(f32, tokens, ref_forward):
    port = f32[3]
    got = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref_forward, rtol=0, atol=F32_TOL)


def test_prefill_matches_reference(f32, tokens):
    _, ref, params, port = f32
    want = np.asarray(jax.jit(ref.prefill)(params, jnp.asarray(tokens)))
    got = port.prefill(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_decode_steps_match_reference(f32, tokens):
    _, ref, params, port = f32
    cache, mine = ref.init_cache(2, 16), port.init_cache(2, 16)
    dec = jax.jit(ref.decode_step)
    for i in range(10):
        want, cache = dec(params, jnp.asarray(tokens[:, i:i + 1]), cache)
        got, mine = port.decode_step(torch.from_numpy(tokens[:, i:i + 1]), mine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
        assert mine["pos"] == int(cache["pos"]) == i + 1


def test_prefill_matches_own_decode(f32, tokens, ref_forward):
    """Kernel D's path (teacher forcing) == the dense cached path, step by
    step (after tests/test_archs_smoke.py::test_attention_prefill_matches_decode)."""
    port = f32[3]
    full = port(torch.from_numpy(tokens)).numpy()
    cache = port.init_cache(2, 16)
    for i in range(10):
        logit, cache = port.decode_step(torch.from_numpy(tokens[:, i:i + 1]), cache)
        np.testing.assert_allclose(logit.numpy(), full[:, i], rtol=0, atol=F32_TOL)


def test_greedy_serve_loop_tokens_equal_reference(f32):
    _, ref, params, port = f32
    prompts = np.random.default_rng(1).integers(0, 512, (3, 12))
    want, _, _ = ref_serve.serve_loop(ref, params, jnp.asarray(prompts), 16)
    got, prefill_s, decode_s = serve.serve_loop(port, torch.from_numpy(prompts), 16)
    assert got.shape == (3, 16) and prefill_s > 0 and decode_s > 0
    assert np.array_equal(got, want)


def test_sampled_serve_loop_is_seeded(f32):
    port = f32[3]
    prompts = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 4)))
    runs = [serve.serve_loop(port, prompts, 8, temperature=1.0,
                             generator=torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert np.array_equal(runs[0], runs[1]) and not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < 512)).all()


@pytest.fixture(scope="module")
def bf16():
    return _pair("bfloat16")


def test_bf16_attention_sublayer_matches_reference(bf16):
    ref_cfg, _, params, port = bf16
    x = np.random.default_rng(3).standard_normal((2, 40, 128)).astype(np.float32)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"][0]["attn"])
    want, _ = ref_layers.attention(layer0, jnp.asarray(x, jnp.bfloat16), ref_cfg)
    got = port.blocks[0].attn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_bf16_forward_is_as_close_to_f32_as_the_reference(bf16, tokens):
    ref_cfg, ref, params, port = bf16
    want = np.asarray(ref.forward(params, jnp.asarray(tokens), remat=False)[0], np.float32)
    f32_ref = ref_make_model(dataclasses.replace(ref_cfg, dtype="float32"))
    up = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    truth = np.asarray(f32_ref.forward(up, jnp.asarray(tokens), remat=False)[0])
    got = port(torch.from_numpy(tokens)).float().numpy()
    assert np.abs(got - truth).max() <= 2 * np.abs(want - truth).max()


def test_serve_main_runs_on_the_cpu(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "arch=granite-8b-reduced" in out and "decode  3 steps" in out


def test_model_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(_cfgs("float32")[1])


def test_prefill_goes_through_the_kernel_wrapper(f32, tokens, monkeypatch):
    """Every attention sublayer of a prefill calls ops.flash_attention
    once (on the CPU that is the plain version, and no launch is counted);
    decode calls it never."""
    port = f32[3]
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    ops.reset_launches()
    port.prefill(torch.from_numpy(tokens))
    assert calls == [(2, 40, 4, 32)] * 4
    port.decode_step(torch.from_numpy(tokens[:, :1]), port.init_cache(2, 4))
    assert len(calls) == 4 and ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("fault", ["shape", "layers", "missing", "moe_missing",
                                   "moe_shape", "mlp_for_moe", "two_positions",
                                   "ssm_missing", "ssm_shape", "tied_head", "one_position",
                                   "dec_cross_missing", "encoder_missing", "cross_shape",
                                   "cross_missing"])
def test_lm_params_from_jax_rejects_a_wrong_tree(request, fault):
    src = request.getfixturevalue(
        "moe_pair" if fault.startswith(("moe", "mlp")) else
        "mamba_pair" if fault.startswith(("ssm", "tied")) else
        "jamba_pair" if fault == "one_position" else
        "whisper_pair" if fault.startswith(("dec_cross", "encoder")) else
        "vlm_pair" if fault.startswith("cross") else "f32")
    cfg = configs.ModelConfig(**dataclasses.asdict(src[0]))
    params = jax.tree_util.tree_map(np.asarray, src[2])
    block = params["blocks"][0]
    if fault == "shape":
        block["attn"]["wq"] = block["attn"]["wq"][:, :, :2]
    elif fault == "layers":
        block["mlp"]["w_up"] = block["mlp"]["w_up"][:3]
    elif fault == "missing":
        del params["lm_head"]
    elif fault == "moe_missing":
        del block["moe"]["e_up"]
    elif fault == "moe_shape":
        block["moe"]["e_gate"] = block["moe"]["e_gate"][:, :2]
    elif fault == "mlp_for_moe":
        block["mlp"] = block.pop("moe")
    elif fault == "ssm_missing":
        del block["ssm"]["dt_bias"]
    elif fault == "ssm_shape":
        block["ssm"]["a_log"] = block["ssm"]["a_log"][:, :-1]
    elif fault == "tied_head":
        params["lm_head"] = params["embed"].T
    elif fault == "one_position":
        params["blocks"] = params["blocks"][:1]
    elif fault == "dec_cross_missing":
        del params["dec_cross"]
    elif fault == "encoder_missing":
        del params["encoder"]["mlp"]["w_in"]
    elif fault == "cross_shape":
        params["blocks"][4]["cross"]["wk"] = params["blocks"][4]["cross"]["wk"][..., :3]
    elif fault == "cross_missing":
        del params["blocks"][4]["ln_cross"]
    else:
        params["blocks"] = [block, block]
    with pytest.raises(ValueError):
        convert.lm_params_from_jax(params, cfg, device="cpu")


# --- the archs of this slice: reduced() configs and custom head layouts -------------

# (name, heads, kv heads, rope fraction): GQA groups 8 and 16 (the full
# chatglm3's 32 / 2), which every arch's reduced() config (4 / 1) never
# reaches, and chatglm's half rotary at group 16
CUSTOM_HEADS = [("g8", 16, 2, 1.0), ("g16", 16, 1, 1.0), ("g16_rope_half", 32, 2, 0.5)]


def _ref_cfg(name):
    if name == "gelu_mlp":          # a dense stack with GeLU MLPs (grok's activation)
        return dataclasses.replace(ref_get_config("granite-8b").reduced(),
                                   name="custom-gelu", num_layers=2, act="gelu")
    for tag, h, kv, frac in CUSTOM_HEADS:
        if name == tag:
            return dataclasses.replace(
                ref_get_config("chatglm3-6b").reduced(), name=f"custom-{tag}", num_layers=2,
                d_model=h * 16, num_heads=h, num_kv_heads=kv, rope_fraction=frac)
    return ref_get_config(name).reduced()


@pytest.fixture(scope="module")
def moe_pair():
    return _pair("float32", ref_cfg=ref_get_config("qwen3-moe-30b-a3b").reduced())


@pytest.fixture(scope="module")
def mamba_pair():
    return _pair("float32", ref_cfg=ref_get_config("mamba2-130m").reduced())


@pytest.fixture(scope="module")
def jamba_pair():
    return _pair("float32", ref_cfg=ref_get_config("jamba-v0.1-52b").reduced())


@pytest.fixture(scope="module")
def vlm_pair():
    return _pair("float32", ref_cfg=ref_get_config("llama-3.2-vision-11b").reduced())


@pytest.fixture(scope="module")
def whisper_pair():
    return _pair("float32", ref_cfg=ref_get_config("whisper-base").reduced())


_SHARED_PAIRS = {"qwen3-moe-30b-a3b": "moe_pair", "mamba2-130m": "mamba_pair",
                 "jamba-v0.1-52b": "jamba_pair", "llama-3.2-vision-11b": "vlm_pair",
                 "whisper-base": "whisper_pair"}


@pytest.fixture(scope="module",
                params=list(NEW_ARCHS + SSM_ARCHS + CROSS_ARCHS) + [c[0] for c in CUSTOM_HEADS]
                + ["gelu_mlp"])
def arch_pair(request):
    if request.param in _SHARED_PAIRS:
        return request.getfixturevalue(_SHARED_PAIRS[request.param])
    return _pair("float32", ref_cfg=_ref_cfg(request.param))


def test_arch_forward_prefill_and_aux_match_reference(arch_pair, tokens):
    ref_cfg, ref, params, port = arch_pair
    extras = _extras(ref_cfg)
    want, want_aux = jax.jit(lambda p, t, e: ref.forward(p, t, e, remat=False))(
        params, jnp.asarray(tokens), _jnp(extras))
    got, aux = port.logits_and_aux(torch.from_numpy(tokens), extras)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == bool(ref_cfg.num_experts)
    pre = port.prefill(torch.from_numpy(tokens), extras).numpy()
    np.testing.assert_allclose(pre, np.asarray(want)[:, -1], rtol=0, atol=F32_TOL)


def test_arch_decode_steps_match_reference(arch_pair, tokens):
    """Token by token, MoE included: at decode the capacity is the
    reference's at t = B (it drops assignments there too). whisper's
    steps take ``frames``, so each runs the encoder again, in both."""
    ref_cfg, ref, params, port = arch_pair
    extras = _extras(ref_cfg)
    cache, mine = ref.init_cache(2, 8), port.init_cache(2, 8)
    dec = jax.jit(ref.decode_step)
    for i in range(6):
        want, cache = dec(params, jnp.asarray(tokens[:, i:i + 1]), cache, _jnp(extras))
        got, mine = port.decode_step(torch.from_numpy(tokens[:, i:i + 1]), mine, extras)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


def test_dense_arch_prefill_matches_own_decode(arch_pair, tokens):
    """Kernel D's path against the dense cached path, the chunked SSD
    against the recurrent step (a stack without MoE only: an MoE prefill
    routes all B*T tokens under one capacity, decode B at a time, so the
    two differ in the reference too)."""
    ref_cfg, _, _, port = arch_pair
    if ref_cfg.num_experts:
        assert any(kind.moe for kind in transformer.layer_kinds(port.cfg))
        return
    extras = _extras(ref_cfg)
    full = port(torch.from_numpy(tokens[:, :6]), extras).numpy()
    cache = port.init_cache(2, 6)
    for i in range(6):
        logit, cache = port.decode_step(torch.from_numpy(tokens[:, i:i + 1]), cache, extras)
        np.testing.assert_allclose(logit.numpy(), full[:, i], rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS + SSM_ARCHS + CROSS_ARCHS)
def test_serve_main_runs_each_arch_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "3", "--gen", "2"]) == 0
    assert f"arch={arch}-reduced" in capsys.readouterr().out


# --- the SSM and hybrid families ------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", F32_TOL)])
def test_mamba_train_matches_decode(dtype, tol):
    """tests/test_archs_smoke.py::test_mamba_train_matches_decode on the
    port (its bf16 config and tolerance), and in f32 at this file's: the
    chunked SSD teacher-forced == the step-by-step recurrence."""
    cfg = dataclasses.replace(configs.get_config("mamba2-130m").reduced(), dtype=dtype)
    model = make_model(cfg, device="cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12)))
    full = model(toks).float().numpy()
    cache = model.init_cache(batch=1, max_len=16)
    outs = []
    for i in range(12):
        logit, cache = model.decode_step(toks[:, i:i + 1], cache)
        outs.append(logit.float().numpy())
    np.testing.assert_allclose(full, np.stack(outs, axis=1), rtol=tol, atol=tol)


def test_ssm_stacks_hold_their_kinds(mamba_pair, jamba_pair):
    """mamba2: SSM sublayers without an FFN and a tied head; jamba: seven
    SSM sublayers and one attention sublayer a period (the last), dense
    MLPs at even layers and MoE at odd ones; each cache entry by its kind."""
    mamba, jamba = mamba_pair[3], jamba_pair[3]
    assert not hasattr(mamba, "lm_head") and "lm_head" not in dict(mamba.named_parameters())
    assert all(hasattr(b, "ssm") and not hasattr(b, "ln2") for b in mamba.blocks)
    assert [("attn" if hasattr(b, "attn") else "ssm") + ("+moe" if hasattr(b, "moe") else "+mlp")
            for b in jamba.blocks] == ["ssm+mlp", "ssm+moe"] * 3 + ["ssm+mlp", "attn+moe"]
    cache = jamba.init_cache(2, 5)
    assert [sorted(c) for c in cache["layers"]] == [["ssm"]] * 7 + [["kv"]]
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache["layers"][0]["ssm"].items()} == {
        "conv": ((2, 3, 256 + 2 * 16), torch.float32), "h": ((2, 8, 16, 32), torch.float32)}


def test_prefill_of_a_hybrid_runs_kernel_d_once_a_period(jamba_pair, tokens, monkeypatch):
    port = jamba_pair[3]
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    port.prefill(torch.from_numpy(tokens))
    assert calls == [(2, 40, 4, 32)]


def test_two_period_jamba_converts_in_the_reference_order(tokens):
    """16 layers, two periods: each of the 8 positions stacks two layers,
    layer i being blocks[i % 8][i // 8]; reduced() has one period, where a
    wrong order cannot show."""
    ref_cfg = dataclasses.replace(ref_get_config("jamba-v0.1-52b").reduced(), num_layers=16)
    _, ref, params, port = _pair("float32", seed=3, ref_cfg=ref_cfg)
    assert len(params["blocks"]) == 8 and params["blocks"][0]["ssm"]["a_log"].shape[0] == 2
    want, want_aux = jax.jit(lambda p, t: ref.forward(p, t, remat=False))(
        params, jnp.asarray(tokens))
    got, aux = port.logits_and_aux(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TWO_PERIOD_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)


# --- the cross-attention families ---------------------------------------------------

def _ref_greedy(ref, params, prompts, gen_len, extras):
    """``repro.launch.serve.serve_loop``'s greedy loop with ``extras``
    passed to each step (the reference's loop passes none)."""
    cache = ref.init_cache(prompts.shape[0], prompts.shape[1] + gen_len)
    dec = jax.jit(ref.decode_step)
    for i in range(prompts.shape[1]):
        logits, cache = dec(params, jnp.asarray(prompts[:, i:i + 1]), cache, extras)
    toks, tok = [], jnp.argmax(logits, axis=-1)[:, None]
    for _ in range(gen_len):
        toks.append(np.asarray(tok)[:, 0])
        logits, cache = dec(params, tok, cache, extras)
        tok = jnp.argmax(logits, axis=-1)[:, None]
    return np.stack(toks, axis=1)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_arch_greedy_serve_loop_equals_reference(request, arch):
    """With extras (whisper's as ``memory``, the encoder's output, as
    ``serve.main`` serves it) the greedy tokens are the reference's;
    without, both packages' ``serve_loop`` raise ``KeyError``, as the
    reference's ``_memory_for`` does."""
    ref_cfg, ref, params, port = request.getfixturevalue(_SHARED_PAIRS[arch])
    prompts = np.random.default_rng(1).integers(0, 512, (2, 6))
    extras = _extras(ref_cfg)
    if ref_cfg.family == "audio":
        memory = ref_transformer._encode_audio(params, jnp.asarray(extras["frames"]), ref_cfg)
        extras = {"memory": np.array(memory)}
    want = _ref_greedy(ref, params, prompts, 8, _jnp(extras))
    got, _, _ = serve.serve_loop(port, torch.from_numpy(prompts), 8, extras=extras)
    assert np.array_equal(got, want)
    with pytest.raises(KeyError):
        ref_serve.serve_loop(ref, params, jnp.asarray(prompts), 2)
    with pytest.raises(KeyError):
        serve.serve_loop(port, torch.from_numpy(prompts), 2)


def test_two_period_vlm_converts_in_the_reference_order(tokens):
    """10 layers, two periods of 5: the cross sublayers sit at layers 4
    and 9, ``blocks[4]`` stacking both; reduced() has one period, where a
    wrong order cannot show."""
    ref_cfg = dataclasses.replace(ref_get_config("llama-3.2-vision-11b").reduced(),
                                  num_layers=10)
    _, ref, params, port = _pair("float32", seed=4, ref_cfg=ref_cfg)
    assert params["blocks"][4]["cross"]["wq"].shape[0] == 2
    assert [hasattr(b, "cross") for b in port.blocks] == [False] * 4 + [True] + \
        [False] * 4 + [True]
    extras = _extras(ref_cfg)
    want = jax.jit(lambda p, t, e: ref.forward(p, t, e, remat=False)[0])(
        params, jnp.asarray(tokens), _jnp(extras))
    got = port(torch.from_numpy(tokens), extras)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)

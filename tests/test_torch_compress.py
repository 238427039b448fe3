"""The port's int8 gradient compression (``repro_torch.distributed.compress``)
against the reference's ``repro.distributed.compress`` on the CPU, on the
same numpy inputs.

The quantizer is elementwise f32 arithmetic in the reference's order (a
max, a division by 127, an add, a division, a round half to even, a
clip), so the codes, the scales, the effective gradients and the
residuals must be bit-equal: lengths 1, 255, 256, 257 and 1000, an
all-zero leaf, a bf16 leaf, and 50 error-feedback steps over a grad dict.
Then the reference's four properties (``tests/test_compress.py``) on the
port, and one train step with ``GradCompressor`` against the reference's.

The train step: the two packages' raw gradients agree to float rounding
(``tests/test_torch_train.py``), and the quantizer turns that into the
same codes except where a value lies within rounding of a half-way point
between two codes: measured, 16 of reduced granite-8b's 689,280 codes
differ, each by one (26 of whisper-base's 1,181,952). The blocks are the
reference's: the port's per-layer grads are grouped into its stacked
leaves (``convert.lm_leaf_groups``). The metrics are held to ``test_torch_train.py``'s
``METRIC_RTOL``; the updated params and moments to its ``TOL`` rule at
every element whose codes agree; the elements whose codes differ must be
at most ``FLIP_SHARE`` of all, each one code apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.distributed import compress as ref_compress  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import compress  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.train import make_train_step, step  # noqa: E402
from test_torch_train import ADAMW, METRIC_RTOL, TOL, ref_tree, setup  # noqa: E402

torch.set_num_threads(1)

FLIP_SHARE = 1e-4
LEAF_CASES = {"n1": (1,), "n255": (255,), "n256": (256,), "n257": (257,), "n1000": (1000,),
              "2d_3x257": (3, 257), "zeros": (300,), "bf16": (17, 33)}


def _leaf(case: str, seed: int = 0, scale: float = 0.01) -> np.ndarray:
    shape = LEAF_CASES[case]
    if case == "zeros":
        return np.zeros(shape, np.float32)
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    if case == "bf16":        # values a bf16 leaf can hold, exact in f32
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _pair(x: np.ndarray, bf16: bool):
    if bf16:
        return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def _bits(a) -> np.ndarray:
    """f32 / bf16 / int8 values as raw integers, for bit-for-bit checks."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    else:
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a.view({4: np.uint32, 1: np.int8}[a.dtype.itemsize])


@pytest.mark.parametrize("case", LEAF_CASES)
def test_quantize_and_dequantize_bit_equal_reference(case):
    bf16 = case == "bf16"
    mine_in, ref_in = _pair(_leaf(case), bf16)
    codes, scale = compress._quantize_leaf(mine_in)
    rcodes, rscale = ref_compress._quantize_leaf(ref_in)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(codes.shape) == rcodes.shape and tuple(scale.shape) == rscale.shape
    assert np.array_equal(_bits(codes), _bits(rcodes))
    assert np.array_equal(_bits(scale), _bits(rscale))
    dtype = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    deq = compress._dequantize_leaf(codes, scale, tuple(mine_in.shape), dtype[0])
    rdeq = ref_compress._dequantize_leaf(rcodes, rscale, ref_in.shape, dtype[1])
    assert deq.dtype == dtype[0] and tuple(deq.shape) == rdeq.shape
    assert np.array_equal(_bits(deq), _bits(rdeq))
    if case == "zeros":
        assert not codes.any() and not deq.any()


GRAD_SHAPES = {"w": ((17, 33), False), "b": ((257,), False), "big": ((3, 1000), False),
               "one": ((1,), False), "emb": ((40, 8), True)}


def test_compress_decompress_50_steps_bit_equal_reference():
    """Fresh gradients every step, the residuals threaded through both
    packages: every step's effective gradients (in each leaf's dtype) and
    f32 residuals bit-equal."""
    rng = np.random.default_rng(3)
    res = ref_res = None
    for i in range(50):
        grads, ref_grads = {}, {}
        for k, (shape, bf16) in GRAD_SHAPES.items():
            x = (10.0 ** rng.uniform(-4, 0) * rng.standard_normal(shape)).astype(np.float32)
            grads[k], ref_grads[k] = _pair(x, bf16)
        eff, res = compress.compress_decompress(grads, res)
        ref_eff, ref_res = ref_compress.compress_decompress(ref_grads, ref_res)
        for k in GRAD_SHAPES:
            assert eff[k].dtype == grads[k].dtype and res[k].dtype == torch.float32
            assert np.array_equal(_bits(eff[k]), _bits(ref_eff[k])), (i, k)
            assert np.array_equal(_bits(res[k]), _bits(ref_res[k])), (i, k)


def test_grad_compressor_threads_its_residual():
    rng = np.random.default_rng(4)
    hook = compress.GradCompressor()
    res = None
    for _ in range(3):
        g = {"w": torch.from_numpy(rng.standard_normal(300).astype(np.float32))}
        got = hook(g)
        want, res = compress.compress_decompress(g, res)
        assert torch.equal(got["w"], want["w"]) and torch.equal(hook.residual["w"], res["w"])


@pytest.mark.parametrize("arch", ["whisper-base", "jamba-v0.1-52b"])
def test_leaf_groups_give_the_reference_blocks(arch):
    """Over ``convert.lm_leaf_groups``, three error-feedback steps on the
    port's grad dict equal the reference's on its stacked tree bit for bit
    (whisper: the encoder and ``dec_cross``; jamba: a block period of 8).
    Without the groups, a norm scale's 128 values fill a block alone."""
    model = make_model(get_config(arch).reduced(), device="cpu")
    rng = np.random.default_rng(5)
    res = ref_res = None
    for i in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)
                                     ).to(p.dtype) for k, p in model.named_parameters()}
        ref_grads = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                                  else jnp.float32),
            convert.lm_params_to_jax(model, grads))
        eff, res = compress.compress_decompress(grads, res, convert.lm_leaf_groups(model))
        if i == 0:
            first, first_grads = eff, grads
        ref_eff, ref_res = ref_compress.compress_decompress(ref_grads, ref_res)
        for mine, ref in ((eff, ref_eff), (res, ref_res)):
            flat = jax.tree_util.tree_leaves(convert.lm_params_to_jax(model, mine))
            ref_flat = jax.tree_util.tree_leaves(ref)
            assert len(flat) == len(ref_flat)
            for a, b in zip(flat, ref_flat):
                assert np.array_equal(_bits(a), _bits(b))
    if arch == "jamba-v0.1-52b":      # 8 layers, one period: a leaf holds one layer
        return
    scale = "blocks.0.ln1.scale"
    alone, _ = compress.compress_decompress({scale: first_grads[scale]})
    assert not torch.equal(alone[scale], first[scale])


# --- the reference's properties (tests/test_compress.py), on the port ------------

def test_quantize_roundtrip_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.standard_normal((1000,)) * 0.01).astype(np.float32))
    codes, scale = compress._quantize_leaf(g)
    deq = compress._dequantize_leaf(codes, scale, g.shape, torch.float32)
    blockmax = float(torch.max(torch.abs(g)))
    assert float(torch.max(torch.abs(deq - g))) <= blockmax / 127.0 + 1e-9


@given(st.integers(min_value=1, max_value=1000), st.floats(0.001, 100.0))
@settings(max_examples=20, deadline=None)
def test_quantize_any_shape(n, scale):
    rng = np.random.default_rng(n)
    g = torch.from_numpy((rng.standard_normal((n,)) * scale).astype(np.float32))
    codes, s = compress._quantize_leaf(g)
    deq = compress._dequantize_leaf(codes, s, g.shape, torch.float32)
    assert deq.shape == g.shape
    assert bool(torch.isfinite(deq).all())


def test_error_feedback_accumulates_unbiased():
    """Sum of effective grads -> sum of true grads (EF corrects drift)."""
    rng = np.random.default_rng(1)
    true_sum = torch.zeros(512)
    eff_sum = torch.zeros(512)
    res = None
    for _ in range(50):
        g = {"w": torch.from_numpy((rng.standard_normal(512) * 1e-3).astype(np.float32))}
        eff, res = compress.compress_decompress(g, res)
        true_sum = true_sum + g["w"]
        eff_sum = eff_sum + eff["w"]
    # the residual bounds the gap (it does not grow with the steps)
    gap = float(torch.max(torch.abs(true_sum - eff_sum)))
    assert gap <= float(torch.max(torch.abs(res["w"]))) + 1e-6


def test_training_with_compression_converges():
    cfg = get_config("granite-8b").reduced()
    model = make_model(cfg, device="cpu", seed=1)
    tx = optim.adamw(3e-3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(hook):
        state = step.init_state(step.model_params(model), tx)
        train_step = make_train_step(model, tx, compress_grads=hook)
        losses = []
        for _ in range(8):
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
        return losses

    plain = run(None)
    comp = run(compress.GradCompressor())
    assert comp[-1] < comp[0]
    assert abs(comp[-1] - plain[-1]) < 0.5 * plain[0]


# --- one train step with the hook, against the reference's ----------------------

def code_flips(grads: dict, other: dict, groups) -> dict[str, np.ndarray]:
    """Per param, where the int8 codes of ``grads`` and of ``other`` (the
    same names, numpy) differ, quantized over ``groups``; each differs by
    one code at most."""
    out = {}
    grouped = {k for names in groups for k in names}
    for names in [*groups, *([k] for k in grads if k not in grouped)]:
        mine = torch.cat([grads[k].reshape(-1).float() for k in names])
        theirs = jnp.concatenate([jnp.asarray(other[k]).reshape(-1) for k in names])
        diff = (compress._quantize_leaf(mine)[0].numpy().astype(np.int32).reshape(-1)
                - np.asarray(ref_compress._quantize_leaf(theirs)[0]).astype(np.int32)
                .reshape(-1))
        assert np.abs(diff).max() <= 1, names
        sizes = np.cumsum([0] + [grads[k].numel() for k in names])
        for k, a, b in zip(names, sizes[:-1], sizes[1:]):
            out[k] = (diff[a:b] != 0).reshape(grads[k].shape)
    return out


def test_train_step_with_compression_matches_reference():
    arch = "granite-8b"
    ref, params, model, batch = setup(arch)
    seen = {}

    class RefHook(ref_compress.GradCompressor):
        def __call__(self, grads):
            seen["ref_raw"] = grads
            return super().__call__(grads)

    class Hook(compress.GradCompressor):
        def __call__(self, grads):
            seen["raw"] = grads
            return super().__call__(grads)

    ref_tx = ref_optim.adamw(**ADAMW)
    ref_state, ref_metrics = ref_step.make_train_step(ref, ref_tx, compress_grads=RefHook())(
        ref_step.init_state(params, ref_tx), {k: jnp.asarray(v) for k, v in batch.items()})
    tx = optim.adamw(**ADAMW)
    hook = Hook(convert.lm_leaf_groups(model))
    state, metrics = step.make_train_step(model, tx, compress_grads=hook)(
        step.init_state(step.model_params(model), tx), batch)

    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(ref_metrics[k]), rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    # where the two packages' codes differ
    ref_raw = ref_tree(seen["ref_raw"], model)
    flipped = code_flips(seen["raw"], ref_raw, hook.groups)
    total = sum(g.numel() for g in seen["raw"].values())
    n_flipped = sum(int(m.sum()) for m in flipped.values())
    assert n_flipped <= FLIP_SHARE * total, n_flipped
    for what, mine, want_tree in (("params", state.params, ref_state.params),
                                  ("mu", state.opt_state.mu, ref_state.opt_state.mu),
                                  ("nu", state.opt_state.nu, ref_state.opt_state.nu)):
        want = ref_tree(want_tree, model)
        for k, w in want.items():
            atol = TOL * np.abs(w).max() + (100 * TOL * ADAMW["learning_rate"]
                                            if what == "params" else 0.0)
            keep = ~flipped[k]
            np.testing.assert_allclose(mine[k].numpy()[keep], w[keep], rtol=0, atol=atol,
                                       err_msg=f"{what} {k}")

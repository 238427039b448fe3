"""The port's dry-run cells (``repro_torch.launch.cells``,
``repro_torch.configs.cells``) against the reference's
(``repro.launch.cells``), in one process, for every one of the 32 cells
(each arch's ``cells``) on the shape-only production meshes, 16 x 16 and
2 x 16 x 16, as ``tests/test_torch_sharding.py`` holds the rules:

- ``configs.cells``: the same shapes for every arch (long_500k only where
  the arch is sub-quadratic);
- ``input_specs``: the rules field for field, every input's shape and
  dtype, its spec, and the cache's specs (the port's layer i against the
  reference's stacked entry i % period, without the stack axis);
- ``cell_specs``, what ``lower_cell`` lays the cell out by: the sanitized
  param specs against the reference's ``sanitize_pspecs`` of its
  ``param_pspecs`` (its ``lower_cell``'s ``in_shardings``), the train
  state's specs (``init_state_specs``), the inputs' and the cache's;
- ``_serve_fsdp``, ``_default_microbatches`` and ``_extras_specs``.

Specs compare as tuples. The reference's trees come from
``jax.eval_shape``; the port's model is built on ``meta``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP
from test_torch_sharding import MESHES, _assert_port_matches, _models, _paths, _t

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.launch import cells as ref_cells_mod
from repro_torch.configs import ARCH_IDS, cells, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells as cells_mod

torch.set_num_threads(1)

CELLS = [(a, s.name) for a in ARCH_IDS for s in cells(a)]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_cells_match_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        assert [dataclasses.asdict(s) for s in cells(arch)] == \
            [dataclasses.asdict(s) for s in ref_cells(arch)], arch
    assert len(CELLS) == 32
    assert sum(s == "long_500k" for _, s in CELLS) == 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_policy_knobs_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cells_mod._serve_fsdp(cfg) == ref_cells_mod._serve_fsdp(ref_cfg)
    assert cells_mod._default_microbatches(cfg) == ref_cells_mod._default_microbatches(ref_cfg)
    assert cells_mod._serve_fsdp(cfg) == (arch == "grok-1-314b")
    for kind in ("train", "prefill", "decode"):
        rules = shd.default_rules(cfg)
        mine = cells_mod._extras_specs(cfg, rules, kind)
        ref = ref_cells_mod._extras_specs(ref_cfg, ref_shd.ShardingRules(
            **dataclasses.asdict(rules)), kind)
        assert {k: _t(v) for k, v in mine.items()} == {k: _t(v) for k, v in ref.items()}


def _cache_matches(model, mine, ref, what):
    """The port's per-layer cache tree against the reference's stacked one."""
    period = len(ref["layers"])
    assert len(mine["layers"]) == model.cfg.num_layers
    for i, entry in enumerate(mine["layers"]):
        want = _paths(ref["layers"][i % period], is_leaf=lambda x: isinstance(x, RefP))
        got = _paths(entry, is_leaf=lambda x: isinstance(x, shd.P))
        assert set(got) == set(want), (what, i)
        for path, spec in got.items():
            assert _t(spec) == _t(want[path])[1:], (what, i, path)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cell_specs_match_reference(arch, shape, mesh_name):
    multi = mesh_name == "multi"
    mesh = MESHES[mesh_name]
    mine = cells_mod.input_specs(arch, shape, multi_pod=multi)
    ref = ref_cells_mod.input_specs(arch, shape, multi_pod=multi)
    assert dataclasses.asdict(mine["rules"]) == dataclasses.asdict(ref["rules"])
    assert dataclasses.asdict(mine["shape"]) == dataclasses.asdict(ref["shape"])
    assert set(mine["batch"]) == set(ref["batch"]) and set(mine["specs"]) == set(ref["specs"])
    for k, v in ref["batch"].items():
        if k == "__cache__":
            continue
        got = mine["batch"][k]
        assert tuple(got.shape) == tuple(v.shape) and _dtype(got) == str(v.dtype), k
        assert got.device.type == "meta"
        assert _t(mine["specs"][k]) == _t(ref["specs"][k]), k

    model, shapes = _models(arch)
    specs = cells_mod.cell_specs(mine, mesh)
    ref_rules = ref["rules"]
    ref_params = ref_shd.sanitize_pspecs(shapes, ref_shd.param_pspecs(shapes, ref_rules), mesh)
    _assert_port_matches(model, ref_params, specs["params"])
    batch = {k: v for k, v in ref["batch"].items() if k != "__cache__"}
    ref_batch = ref_shd.sanitize_pspecs(batch, {k: ref["specs"][k] for k in batch}, mesh)
    assert {k: _t(v) for k, v in specs["batch"].items()} == {
        k: _t(v) for k, v in ref_batch.items()}
    if "__cache__" in ref["batch"]:
        _cache_matches(model, mine["specs"]["__cache__"], ref["specs"]["__cache__"], "specs")
        ref_cache = ref_shd.sanitize_pspecs(ref["batch"]["__cache__"], ref["specs"]["__cache__"],
                                            mesh)
        _cache_matches(model, specs["cache"], ref_cache, "sanitized")
    else:
        assert "cache" not in specs
    if mine["shape"].kind == "train":
        state = specs["state"]
        ref_state = ref_cells_mod.init_state_specs(None, ref_params)
        assert type(state).__name__ == type(ref_state).__name__ == "TrainState"
        assert state._fields == ref_state._fields
        assert state.opt_state._fields == ref_state.opt_state._fields
        assert _t(state.step) == _t(ref_state.step) == ()
        assert _t(state.opt_state.step) == _t(ref_state.opt_state.step) == ()
        for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
            assert tree is specs["params"]
        _assert_port_matches(model, ref_state.opt_state.mu, state.opt_state.mu)
    else:
        assert "state" not in specs


@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-base", "jamba-v0.1-52b"])
def test_overrides_match_reference(arch):
    """``fsdp`` and explicit rules pass through as in the reference."""
    for shape in [s.name for s in cells(arch)]:
        for fsdp in (False, True):
            mine = cells_mod.input_specs(arch, shape, fsdp=fsdp)
            ref = ref_cells_mod.input_specs(arch, shape, fsdp=fsdp)
            assert dataclasses.asdict(mine["rules"]) == dataclasses.asdict(ref["rules"])
        rules = shd.ShardingRules(batch=None)
        mine = cells_mod.input_specs(arch, shape, rules=rules)
        assert mine["rules"] is rules
        assert np.all([_t(v)[0] is None for k, v in mine["specs"].items() if k != "__cache__"])


def test_meta_routes():
    """Kernel D's ``meta`` route gives the output's shape and dtype and
    adds the reference's attention FLOPs (``_attn_flops``: 4 H hd Tq Tk,
    halved when causal); a mix of ``meta`` with CPU tensors raises; a
    ``meta`` mesh needs a fake world the caller started."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as launch_mesh

    q = torch.empty(2, 16, 8, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device="meta")
    for causal in (True, False):
        before = ops.META_FLOPS["flash_attention"]
        launches = dict(ops.LAUNCHES)
        out = ops.flash_attention(q, kv, kv, causal=causal)
        assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
        want = 4.0 * 2 * 8 * 64 * 16 * 40 * (0.5 if causal else 1.0)
        assert ops.META_FLOPS["flash_attention"] - before == want
        assert ops.LAUNCHES == launches
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(q, torch.zeros(2, 40, 2, 64, dtype=torch.bfloat16), kv)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake world"):
        launch_mesh.make_mesh((1, 1), ("data", "model"), device="meta")
    assert not dist.is_initialized()

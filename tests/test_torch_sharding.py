"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), in one process, exactly:
``default_rules`` field for field for every arch and option,
``param_pspecs`` of every arch at full size (the port's model on the
``meta`` device, the reference's tree from ``jax.eval_shape``; each port
leaf is one layer of a stacked reference leaf, carried across by
``convert.lm_params_to_jax``, and its spec is the reference's without the
leading stack axis), ``cache_pspecs`` of ``init_cache``,
``sanitize_pspecs`` on fake meshes, ``activation_spec``, and the
placements a spec gives on a mesh. Specs compare as tuples.
"""
import dataclasses
import functools
import itertools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as RefP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import make_model as ref_make_model
from repro_torch import convert
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import make_model

torch.set_num_threads(1)


class FakeMesh:
    """A shape-only mesh, as the reference's ``TestSanitize`` makes one."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh(data=16, model=16), "multi": FakeMesh(pod=2, data=16, model=16)}
OPTIONS = list(itertools.product((False, True), repeat=3))      # multi_pod, fsdp, decode


def _rules(cfg, multi_pod, fsdp, decode, pkg):
    return pkg.default_rules(cfg, multi_pod=multi_pod, fsdp=fsdp, decode=decode)


def _t(spec) -> tuple:
    return tuple(spec)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(port meta model, reference shape tree) at full size."""
    model = make_model(get_config(arch), device="meta")
    shapes = jax.eval_shape(ref_make_model(ref_get_config(arch)).init, jax.random.PRNGKey(0))
    return model, shapes


def _paths(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _ref_names(model) -> dict[str, list[str]]:
    """reference path -> the port names stacked into that leaf, in order."""
    names = [k for k, _ in model.named_parameters()]
    index = {k: torch.tensor([i]) for i, k in enumerate(names)}
    tree = convert.lm_params_to_jax(model, index)
    return {path: [names[i] for i in t.reshape(-1).tolist()] for path, t in _paths(tree).items()}


def _assert_port_matches(model, ref_specs, port_specs):
    """Each port leaf's spec is its reference leaf's, the stack axis dropped."""
    want = _paths(ref_specs, is_leaf=lambda x: isinstance(x, RefP))
    groups = _ref_names(model)
    assert set(groups) == set(want)
    seen = set()
    for path, names in groups.items():
        stacked = path.startswith(("['blocks']", "['encoder']", "['dec_cross']"))
        ref = _t(want[path])
        for n in names:
            mine = _t(port_specs[n])
            assert mine == (ref[1:] if stacked else ref), (path, n, mine, ref)
            seen.add(n)
    assert seen == set(port_specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_rules_match_reference(arch):
    for opts in OPTIONS:
        mine = dataclasses.asdict(_rules(get_config(arch), *opts, shd))
        ref = dataclasses.asdict(_rules(ref_get_config(arch), *opts, ref_shd))
        assert mine == ref, (arch, opts)
    assert dataclasses.asdict(shd.default_rules()) == dataclasses.asdict(ref_shd.default_rules())
    assert dataclasses.asdict(shd.ShardingRules()) == dataclasses.asdict(ref_shd.ShardingRules())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_sanitized_pspecs_match_reference(arch):
    """param_pspecs under the default and the FSDP rules (single- and
    multi-pod), then sanitize_pspecs of both trees on the fake production
    mesh, for every leaf of the full-size model."""
    model, shapes = _models(arch)
    params = dict(model.named_parameters())
    for multi_pod, fsdp in itertools.product((False, True), repeat=2):
        mine_rules = _rules(get_config(arch), multi_pod, fsdp, False, shd)
        ref_rules = _rules(ref_get_config(arch), multi_pod, fsdp, False, ref_shd)
        mine = shd.param_pspecs(params, mine_rules)
        ref = ref_shd.param_pspecs(shapes, ref_rules)
        assert all(isinstance(s, shd.P) for s in mine.values())
        _assert_port_matches(model, ref, mine)
        mesh = MESHES["multi" if multi_pod else "single"]
        _assert_port_matches(model, ref_shd.sanitize_pspecs(shapes, ref, mesh),
                             shd.sanitize_pspecs(params, mine, mesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch):
    """Layer i of the port's cache is index i // period of the reference's
    entry i % period: its spec is that entry's without the stack axis."""
    model, _ = _models(arch)
    ref_model = ref_make_model(ref_get_config(arch))
    mine_cache = model.init_cache(2, 32)
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(2, 32))
    period = len(ref_cache["layers"])
    for decode in (False, True):
        mine = shd.cache_pspecs(mine_cache, _rules(get_config(arch), False, False, decode, shd))
        ref = ref_shd.cache_pspecs(ref_cache, _rules(ref_get_config(arch), False, False,
                                                     decode, ref_shd))
        assert _t(mine["pos"]) == _t(ref["pos"]) == ()
        for i, entry in enumerate(mine["layers"]):
            want = _paths(ref["layers"][i % period], is_leaf=lambda x: isinstance(x, RefP))
            got = _paths(entry, is_leaf=lambda x: isinstance(x, shd.P))
            assert set(got) == set(want)
            for path, spec in got.items():
                assert _t(spec) == _t(want[path])[1:], (arch, i, path)


def test_sanitize_matches_reference_cases():
    """The reference's ``TestSanitize`` cases: 40 heads on a 16-way axis
    shift to head_dim, vocab 51865 drops its axis, divisible dims stay."""
    mesh = MESHES["single"]
    shapes = {"wq": torch.empty(5120, 40, 128, device="meta"),
              "embed": torch.empty(51865, 512, device="meta"),
              "w": torch.empty(4096, 14336, device="meta")}
    specs = {"wq": shd.P("data", "model", None), "embed": shd.P("model", "data"),
             "w": shd.P("data", "model")}
    out = shd.sanitize_pspecs(shapes, specs, mesh)
    assert out == {"wq": shd.P("data", None, "model"), "embed": shd.P(None, "data"),
                   "w": shd.P("data", "model")}
    ref = ref_shd.sanitize_pspecs(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.float32) for k, v in shapes.items()},
        {k: RefP(*v) for k, v in specs.items()}, mesh)
    assert {k: _t(v) for k, v in ref.items()} == {k: _t(v) for k, v in out.items()}


def test_activation_spec_and_constrain_outside_rules():
    for rules in (shd.ShardingRules(), shd.default_rules(get_config("granite-8b"), fsdp=True),
                  shd.default_rules(get_config("grok-1-314b"), multi_pod=True, decode=True)):
        ref_rules = ref_shd.ShardingRules(**dataclasses.asdict(rules))
        for names in (("batch", "seq", "heads", None), ("batch", "cache_seq", "kv_heads", None),
                      ("batch", "seq", "vocab"), (None, "d_ff")):
            assert _t(shd.activation_spec(*names, rules=rules)) == _t(
                ref_shd.activation_spec(*names, rules=ref_rules))
    x = torch.randn(2, 3)
    assert shd.constrain(x, "batch", "d_model") is x
    with shd.use_rules(shd.ShardingRules()):       # rules without a mesh: nothing to lay out
        assert shd.constrain(x, "batch", "d_model") is x
        assert shd.current_rules() == shd.ShardingRules() and shd.current_mesh() is None
    assert shd.current_rules() is None
    with pytest.raises(ValueError, match="rules"):
        shd.activation_spec("batch")


def test_placements_of_a_spec():
    """Mesh dim j is Shard(i) where entry i names it, else Replicate; a dim
    over several axes must name them in mesh order."""
    mesh = MESHES["multi"]
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(), mesh) == (Replicate(),) * 3
    assert shd.named_shardings({"a": shd.P(None, "data")}, mesh) == {
        "a": (Replicate(), Shard(1), Replicate())}
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.placements(shd.P("data", "data"), mesh)
    with pytest.raises(ValueError, match="axis 'pod'"):
        shd.placements(shd.P("pod"), MESHES["single"])

"""The port's dry run (``repro_torch.launch.dryrun``, ``hillclimb``,
``distributed.roofline``) over a fake world, against the reference's
cells and roofline formulas.

Four subprocesses at once (each its own process group: a ``fake`` world
of 256 ranks, or 512) run ``dryrun.run_cell`` on every one of the 32 cells on the 16 x 16
production mesh and on grok-1-314b's 3 cells on 2 x 16 x 16, each at one
block period (the test's own monkeypatch of the port's
``configs.base.get_config``: ``num_layers`` one block period,
``encoder_layers`` at most 1; not a flag of ``dryrun``), and
``hillclimb.main`` on one cell with its overrides. The same subprocess
runs each cell's step off the mesh on ``meta`` under
``roofline.RankCounter``: the FLOPs of the whole program on one device.
Checks:

- every record is ``ok`` with the reference's fields;
- its ``argument_bytes`` equal the bytes of one rank's shards that the
  reference's sanitized specs give, from ``jax.eval_shape`` of the same
  cut config (``cells.input_specs`` and the train state of its
  ``lower_cell``; the cache's ``pos`` is an array there and a Python int
  in the port, so it is left out);
- ``roofline.model_flops`` / ``model_bytes`` equal the reference's for
  all 32 cells at full size;
- a rank's counted FLOPs (``RankCounter``: each local op DTensor runs,
  at its local shapes) equal, within ``FLOP_RTOL``, the figure its layout
  gives (``ByShards``, run over the same step: each op of the program at
  its global shapes, over the number of pieces the layout cuts its work
  into, those of the mesh axes along which its output is split, or is a
  partial sum of inputs split there), and no product runs whole over a
  partial sum that its input carried in (but after an SSM block: ROADMAP
  Queue 3, F8, open). Heads, kv heads or a vocabulary
  that "model" does not divide are left whole, so their products repeat
  on every "model" rank; remat runs each block's forward twice; both
  counts see that alike, and a count that prices DTensor's ops at their
  global shapes does not (``test_planted_counter_faults_fail``);
- the same count lies in [G / chips, ``MESH_EXTRA`` G], G the program's
  FLOPs off the mesh (a rank does at least its share of the program and
  at most all of it), and G is at least the reference's ``model_flops``
  less what no matmul over the text tokens computes (``_unpriced``: the
  embedding lookup, the head that the prefill runs on the last position
  alone, norm scales and SSM constants, the encoder's and the cross K / V
  products, which run over the frames or image tokens; remat, MoE
  capacity and the SSD's chunk products only add);
- ``hillclimb.main`` writes its record under ``--out`` with its overrides.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.distributed import roofline as ref_rl
from repro.distributed import sharding as ref_shd
from repro.launch import cells as ref_cells_mod
from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.distributed import roofline as rl

torch.set_num_threads(1)

CELLS = [(a, s.name) for a in ARCH_IDS for s in cells(a)]
MULTI = [("grok-1-314b", s.name) for s in cells("grok-1-314b")]
DEADLINE = 600
# the mesh path's own small products a rank adds to the program: the
# sharded decode's softmax combine, the SSM state update summed over N's
# shards (measured at most 11.5 %: mamba2-130m's long_500k, where every
# rank runs the whole batch of one)
MESH_EXTRA = 1.25
# a rank's count against its layout's figure: a rank holds the larger
# piece of a dim its shards do not divide (measured at most 2.3e-5:
# granite-3-8b's train_4k, vocabulary 49,155 over 16)
FLOP_RTOL = 1e-3
# the cell the planted counter faults run on, first in their process (a
# cold sharding-propagation cache)
PLANTED = ("granite-8b", "prefill_32k")


def _run_placements(func, args, kwargs) -> list:
    """The placements of the tensor inputs that DTensor runs ``func`` at:
    after the redistributions its sharding propagation picks."""
    from torch.distributed.tensor import DTensor

    d = DTensor._op_dispatcher
    info = d.unwrap_to_op_info(func, args, kwargs)
    d.sharding_propagator.propagate(info)
    schema = info.output_sharding.redistribute_schema or info.schema
    return [spec.placements for spec in schema.args_spec]


class ByShards(TorchDispatchMode):
    """A rank's FLOPs as its layout gives them: each op the program runs
    (above DTensor's dispatch), priced by ``torch.utils.flop_counter`` at
    its global shapes, over the pieces its work is cut into: the product
    of the mesh axes along which its output is split, or is a partial sum
    of inputs split along that axis (a contraction split); an output that
    is a partial sum of inputs that were already partial sums there is
    computed whole on each rank (``repeated`` sums what such ops add
    over their share). Ops on plain tensors (inside ``shard_map``) count
    whole. Kernel D's ``meta`` route adds its own."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.repeated = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        formula = flop_registry.get(getattr(func, "_overloadpacket", None))
        dt = any(issubclass(t, DTensor) for t in types)
        ins = _run_placements(func, args, kwargs) if formula is not None and dt else None
        out = func(*args, **kwargs)
        if formula is None:
            return out
        if not dt:
            self.flops += float(formula(*args, **kwargs, out_val=out))
            return out
        whole = lambda x: (torch.empty(x.shape, dtype=x.dtype, device="meta")
                           if isinstance(x, DTensor) else x)
        first = next(o for o in (out if isinstance(out, (tuple, list)) else [out])
                     if isinstance(o, DTensor))
        pieces, repeats = 1, 1
        for m, (n, p) in enumerate(zip(first.device_mesh.shape, first.placements)):
            if p.is_shard() or (p.is_partial() and any(pl[m].is_shard() for pl in ins)):
                pieces *= n
            elif p.is_partial():
                repeats *= n
        share = float(formula(*tree_map(whole, args), **kwargs,
                              out_val=tree_map(whole, out))) / pieces
        self.flops += share
        self.repeated += share * (1 - 1 / repeats)
        return out


def planted_counters():
    """Two faulty ``RankCounter``s: one entered above DTensor's dispatch
    (it prices every DTensor op at its global shapes) and one that also
    prices the ops on ``FakeTensor``s that DTensor's sharding propagation
    runs at global shapes (the count the dry run first had)."""
    from repro_torch.distributed import roofline as rl

    class AboveDTensor(rl.RankCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = self._registry.get(getattr(func, "_overloadpacket", None))
            if formula is not None:
                self.op_flops += float(formula(*args, **kwargs, out_val=out))
            return out

    class CountsPropagation(rl.RankCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor

            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = self._registry.get(getattr(func, "_overloadpacket", None))
            if formula is not None:
                self.op_flops += float(formula(*args, **kwargs, out_val=out))
            return out

    # the propagation runs on a cache miss alone: this one first
    return {"counts_propagation": CountsPropagation, "above_dtensor": AboveDTensor}


def agrees(rank: float, layout: float) -> bool:
    return abs(rank - layout) <= FLOP_RTOL * layout


class FakeMesh:
    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = {False: FakeMesh(data=16, model=16), True: FakeMesh(pod=2, data=16, model=16)}


def cut(cfg):
    """One block period of the decoder (and at most one encoder layer)."""
    import math

    period = 1
    for per in (cfg.moe_layer_period if cfg.num_experts else 1, cfg.attn_layer_period or 1,
                cfg.cross_attn_period or 1):
        period = math.lcm(period, per)
    return dataclasses.replace(cfg, num_layers=period,
                               encoder_layers=min(cfg.encoder_layers, 1))


# the subprocesses and the cells each runs (False: 16 x 16, True: 2 x 16 x 16;
# "hill": hillclimb.main), about equal in time
GROUPS = (
    [(False, "jamba-v0.1-52b", s.name) for s in cells("jamba-v0.1-52b")] + [(True, *c) for c in MULTI],
    [(False, a, s.name) for a in ("whisper-base", "llama-3.2-vision-11b", "mamba2-130m")
     for s in cells(a)],
    [(False, a, s.name) for a in ("phi3-medium-14b", "qwen3-moe-30b-a3b", "grok-1-314b")
     for s in cells(a)],
    ["planted"] + [(False, a, s.name) for a in ("granite-8b", "chatglm3-6b", "granite-3-8b")
                   for s in cells(a)] + ["hill"],
)

SCRIPT = textwrap.dedent("""
    import json, sys, warnings, logging
    warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
    from pathlib import Path
    import pytest, torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[2])
    from test_torch_dryrun import GROUPS, PLANTED, ByShards, cut, planted_counters
    from repro_torch.configs import base
    from repro_torch.distributed import roofline as rl
    from repro_torch.kernels import ops
    from repro_torch.launch import cells as cells_mod, dryrun, hillclimb
    from repro_torch.train import step as train
    from repro_torch import optim

    out, group = Path(sys.argv[1]), int(sys.argv[3])
    real = base.get_config
    lowered = {}

    def keep(*args, **kwargs):
        lowered["cell"], lowered["meta"] = cells_mod.lower_cell(*args, **kwargs)
        return lowered["cell"], lowered["meta"]

    def layout_flops():
        # the step run_cell just ran, once more, under ByShards
        m0 = ops.META_FLOPS["flash_attention"]
        with ByShards() as b:
            lowered["cell"].step()
        return b.flops + ops.META_FLOPS["flash_attention"] - m0, b.repeated

    def planted():
        # each counter over a fresh lowering of one cell
        dryrun.fake_world(256)
        mesh = dryrun.make_production_mesh(device="meta")
        rec = {}
        for name, counter in [*planted_counters().items(), ("rank_counter", rl.RankCounter)]:
            cell = cells_mod.lower_cell(*PLANTED, mesh)[0]
            with counter() as c:
                cell.step()
            rec[name] = c.flops
        lowered["cell"] = cells_mod.lower_cell(*PLANTED, mesh)[0]
        rec["layout"] = layout_flops()[0]
        return rec

    def program_flops(arch, shape):
        # the cell's step off the mesh; the counter prices matmul-like ops
        # alone, which microbatching does not change: one microbatch
        spec = cells_mod.input_specs(arch, shape)
        model, batch = spec["model"], dict(spec["batch"])
        cache = batch.pop("__cache__", None)
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels", "token")}
        with rl.RankCounter() as c:
            if spec["shape"].kind == "train":
                tx = optim.adamw(1e-3, max_grad_norm=1.0)
                fn = train.make_train_step(model, tx)
                fn(train.init_state(train.model_params(model), tx), batch)
            elif spec["shape"].kind == "prefill":
                model.prefill(batch["tokens"], extras or None)
            else:
                model.decode_step(batch["token"], cache, extras or None)
        return c.flops

    recs, hill, faults = {}, None, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(base, "get_config", lambda arch: cut(real(arch)))
        mp.setattr(dryrun, "lower_cell", keep)
        for item in GROUPS[group]:
            if item == "planted":
                faults = planted()
                continue
            if item == "hill":
                hill = hillclimb.main(["--arch", "whisper-base", "--shape", "train_4k",
                                       "--tag", "mb4", "--microbatches", "4", "--fsdp", "off",
                                       "--out", str(out / "hillclimb")])
                continue
            multi, arch, shape = item
            r = dryrun.run_cell(arch, shape, multi_pod=multi, out_dir=out / "dryrun",
                                verbose=False)
            r["layout_flops"], r["repeated_flops"] = layout_flops()
            r["program_flops"] = None if multi else program_flops(arch, shape)
            recs[f"{arch}.{shape}.{multi}"] = r
    json.dump({"cells": recs, "hill": hill, "planted": faults},
              open(out / f"summary{group}.json", "w"))
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The subprocesses of ``GROUPS`` at once, each killed past DEADLINE."""
    import time

    out = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    tests = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(out), tests, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for i in range(len(GROUPS))]
    deadline = time.time() + DEADLINE
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    summary = {"cells": {}, "hill": None, "planted": None}
    for i in range(len(GROUPS)):
        part = json.loads((out / f"summary{i}.json").read_text())
        summary["cells"].update(part["cells"])
        summary["hill"] = summary["hill"] or part["hill"]
        summary["planted"] = summary["planted"] or part["planted"]
    return out, summary


def _ref_argument_bytes(arch, shape, multi, monkeypatch) -> int:
    """One rank's bytes of the reference's arguments at the cut depth:
    each leaf's bytes over the mesh axes its sanitized spec names."""
    monkeypatch.setattr(ref_cells_mod, "get_config", lambda a: cut(ref_get_config(a)))
    spec = ref_cells_mod.input_specs(arch, shape, multi_pod=multi)
    mesh = MESHES[multi]
    params = jax.eval_shape(spec["model"].init, jax.random.PRNGKey(0))
    pspecs = ref_shd.param_pspecs(params, spec["rules"])
    batch = dict(spec["batch"])
    cache = batch.pop("__cache__", None)
    trees = [(batch, {k: spec["specs"][k] for k in batch})]
    cfg = spec["cfg"]
    if spec["shape"].kind == "train":
        m_dtype = jax.numpy.bfloat16 if cfg.param_count() > 1e11 else None
        mu = jax.tree_util.tree_map(
            lambda p: jax.ShapeDtypeStruct(p.shape, m_dtype or p.dtype), params)
        nu = jax.tree_util.tree_map(lambda p: jax.ShapeDtypeStruct(p.shape, np.float32), params)
        trees += [(params, pspecs), (mu, pspecs), (nu, pspecs)]
        scalars = 2 * 4                                   # the two int32 step counters
    else:
        trees.append((params, pspecs))
        scalars = 0
        if cache is not None:
            cache = {"layers": cache["layers"]}           # ``pos`` left out
            trees.append((cache, {"layers": spec["specs"]["__cache__"]["layers"]}))
    total = scalars
    for shapes, specs in trees:
        specs = ref_shd.sanitize_pspecs(shapes, specs, mesh)
        flat_s, _ = jax.tree_util.tree_flatten(shapes)
        flat_p = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for leaf, sp in zip(flat_s, flat_p, strict=True):
            n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
            for entry in sp:
                for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                    n //= mesh.shape[ax]
            total += n
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_bytes_match_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert rl.model_flops(cfg, get_shape(shape)) == ref_rl.model_flops(ref_cfg,
                                                                      ref_get_shape(shape))
    assert rl.model_bytes(cfg, get_shape(shape)) == ref_rl.model_bytes(ref_cfg,
                                                                      ref_get_shape(shape))
    assert rl._attn_layers(cfg) == ref_rl._attn_layers(ref_cfg)


def test_every_cell_is_listed():
    assert len(CELLS) == 32 == sum(len(ref_cells(a)) for a in ARCH_IDS)


@pytest.mark.parametrize("multi,arch,shape", [(False, *c) for c in CELLS]
                         + [(True, *c) for c in MULTI])
def test_cell_dry_runs(run, multi, arch, shape, monkeypatch):
    out, summary = run
    rec = summary["cells"][f"{arch}.{shape}.{multi}"]
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == (512 if multi else 256)
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["kind"] == get_shape(shape).kind
    tag = f"{arch}.{shape}.{'multi' if multi else 'single'}"
    assert json.loads((out / "dryrun" / f"{tag}.json").read_text())["ok"]
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["peak_is_lower_bound"]
    assert mem["output_bytes"] > 0
    assert mem["argument_bytes"] == _ref_argument_bytes(arch, shape, multi, monkeypatch)
    roof = rec["roofline"]
    assert roof["hbm_bytes_per_chip"] == mem["argument_bytes"]
    c = cut(get_config(arch))
    assert roof["model_flops_global"] == rl.model_flops(c, get_shape(shape))
    assert roof["model_bytes_global"] == rl.model_bytes(c, get_shape(shape))
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert agrees(roof["flops_per_chip"], rec["layout_flops"]), (roof["flops_per_chip"],
                                                                 rec["layout_flops"])
    # no product runs whole over a partial sum (a gradient's did); an SSM
    # block's out_proj still leaves its partial sums to the next block
    # (ROADMAP Queue 3, F8, open), so the ssm and hybrid cells are not held
    if get_config(arch).family not in ("ssm", "hybrid"):
        assert rec["repeated_flops"] == 0, rec["repeated_flops"]
    if not multi:
        g = rec["program_flops"]
        rank = roof["flops_per_chip"]
        assert g / rec["chips"] <= rank <= MESH_EXTRA * g, (rank, g)
        assert g >= roof["model_flops_global"] - _unpriced(c, get_shape(shape)), (
            g, roof["model_flops_global"])


def _unpriced(cfg, shape) -> float:
    """The part of ``model_flops`` (2 or 6 FLOPs a param a token) that no
    matmul of the program computes: the embedding (a lookup), the head
    (the prefill runs it on the last position alone) and the params no
    matmul uses (norm scales, the SSM's per-head constants, its conv
    taps), and the params that act on the extras, not the text tokens (the
    encoder's, the cross sublayers' ``wk`` / ``wv``)."""
    from repro_torch.models import make_model

    other = sum(p.numel() for n, p in make_model(cfg, device="meta").named_parameters()
                if p.dim() < 2 or n.endswith(("conv_w", "cross.wk", "cross.wv"))
                or n.startswith("encoder."))
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    per = 6 if shape.kind == "train" else 2
    return per * tokens * (2 * cfg.vocab_size * cfg.d_model + other)


def test_hillclimb_writes_its_record(run):
    out, summary = run
    hill = summary["hill"]
    assert hill["ok"], hill.get("error")
    assert hill["overrides"] == {"num_microbatches": "4", "fsdp": "False"}
    assert hill["num_microbatches"] == 4 and hill["fsdp"] is False
    rec = json.loads((out / "hillclimb" / "whisper-base.train_4k.mb4" /
                      "whisper-base.train_4k.single.json").read_text())
    assert rec == hill


def test_planted_counter_faults_fail(run):
    """The layout check fails a counter entered above DTensor (every
    DTensor op at its global shapes) and one that prices DTensor's
    sharding propagation, and passes ``RankCounter`` on the same cell."""
    _, summary = run
    got = summary["planted"]
    assert agrees(got["rank_counter"], got["layout"]), got
    for fault in planted_counters():
        assert not agrees(got[fault], got["layout"]), (fault, got)
        assert got[fault] > 2 * got["layout"], (fault, got)

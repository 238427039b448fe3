"""The VLM and audio families served on a device mesh against the
reference's mesh serve.

As ``tests/test_torch_mesh_serve_ssm.py``, through
``test_torch_mesh_uneven``'s harness: reduced llama-3.2-vision-11b and
whisper-base in f32 from the reference's ``init``, on 8 gloo ranks, a
(2, 4) ("data", "model") mesh, against the reference's jit on 8 XLA
devices with ``cells.lower_cell``'s shardings (the extras by ("batch",
None, None)):

- ``*_prefill``: ``Model.prefill`` under prefill_32k's rules, the VLM
  with its images, whisper with its frames (the encoder runs on the mesh);
- ``*_decode``: ``PROMPT`` prompt steps and ``GEN`` greedy steps under
  decode_32k's rules at batch 4 (the cache's sequence over "model");
- ``*_long``: the same under long_500k's rules at batch 1 (the batch
  whole, the sequence over both axes).

whisper decodes from a ``memory`` drawn at random, as
``cells._extras_shapes`` gives a decode cell; the VLM from its images.
Each cross sublayer of a decode step runs kernel D's plain version inside
``shard_map`` at Tq 1. Every step's logits match the reference's mesh
decode within ``LOGIT_TOL`` of the step's largest logit, the greedy
tokens are the same, the final cache gathered matches the reference's,
and every cache leaf keeps ``sanitize_pspecs(cache_pspecs(...))``'s
placements. The same serve off the mesh matches the reference's plain
serve and the port's mesh serve (no MoE: the mesh changes nothing).
"""
import numpy as np
import pytest
import torch
from test_torch_mesh_uneven import (GEN, PROMPT, assert_serve, cache_placements, run_jobs)

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

JOBS = {"vlm_prefill": ("llama-3.2-vision-11b", {}, "plain", "prefill", 4),
        "whisper_prefill": ("whisper-base", {}, "plain", "prefill", 4),
        "vlm_decode": ("llama-3.2-vision-11b", {}, "decode", "serve", 4),
        "vlm_long": ("llama-3.2-vision-11b", {}, "long", "serve", 1),
        "whisper_decode": ("whisper-base", {}, "decode", "serve", 4),
        "whisper_long": ("whisper-base", {}, "long", "serve", 1)}
SERVES = sorted(n for n, j in JOBS.items() if j[3] == "serve")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(JOBS, __name__, tmp_path_factory.mktemp("mesh_serve_cross"),
                    plain=tuple(JOBS))


@pytest.mark.parametrize("name", ["vlm_prefill", "whisper_prefill"])
def test_prefill_matches_reference(runs, name):
    from test_torch_mesh_serve import LOGIT_TOL

    ref, port, off = runs
    got, want = port[name]["prefill"], ref[name]["prefill"]
    assert got.shape == want.shape == (JOBS[name][4], 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    np.testing.assert_allclose(off[name]["prefill"], want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("name", SERVES)
def test_mesh_decode_matches_reference(runs, name):
    ref, port, _ = runs
    assert_serve(port[name], ref[name]["mesh"], f"{name} on the mesh")
    assert port[name]["pos"] == PROMPT + GEN


@pytest.mark.parametrize("name", SERVES)
def test_plain_decode_matches_reference_and_mesh(runs, name):
    ref, port, off = runs
    assert_serve(off[name], ref[name]["plain"], f"{name} off the mesh")
    assert_serve(port[name], off[name], f"{name} mesh against plain")


@pytest.mark.parametrize("name", SERVES)
def test_cache_keeps_the_reference_layout(runs, name):
    """Every KV leaf laid out by ``sanitize_pspecs(cache_pspecs(...))``:
    the sequence over "model" at batch 4 (the batch over "data"), over
    both axes at batch 1; every cache leaf written."""
    from torch.distributed.tensor import Shard

    _, port, _ = runs
    want = cache_placements(JOBS[name], JOBS[name][4])
    assert port[name]["placements"] == want
    batched = JOBS[name][4] > 1
    assert want["0.kv.k"] == ((Shard(0), Shard(1)) if batched else (Shard(1), Shard(1)))
    assert all(np.abs(v).max() > 0 for v in port[name]["cache"].values())

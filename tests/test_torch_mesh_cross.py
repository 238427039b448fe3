"""The VLM and audio families' train step on a device mesh against the
reference's 8-device step.

llama-3.2-vision-11b (a cross sublayer over the images every 5th layer)
and whisper-base (the encoder's non-causal self-attention, rotated, and a
cross sublayer over its output at every decoder layer), each reduced and
in f32, take one train step at ``MICRO`` microbatches under train_4k's
rules (``default_rules(cfg, fsdp=True)``) on 8 gloo ranks, a (2, 4)
("data", "model") mesh, from the reference's ``init``; the reference's
jitted step runs on 8 XLA devices (``test_torch_mesh_uneven``'s harness).
The images and frames are drawn at random and laid out by ("batch", None,
None), the reference's ``cells._extras_specs``. The cross sublayer runs
kernel D's plain version inside ``shard_map`` at Tq != Tk, non-causal and
unrotated; the encoder's self-attention at Tq == Tk, non-causal and
rotated. The metrics must match within ``test_torch_train.py``'s
``METRIC_RTOL``, the params and first moments within its ``TOL``, every
gradient nonzero; and the mesh step must match the port's own step off
the mesh.
"""
import numpy as np
import pytest
import torch
from test_torch_mesh_train import _assert_leaves
from test_torch_mesh_uneven import B, METRIC_RTOL, assert_step, run_jobs

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

JOBS = {"vlm_step": ("llama-3.2-vision-11b", {}, "fsdp", "step", B),
        "whisper_step": ("whisper-base", {}, "fsdp", "step", B)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(JOBS, __name__, tmp_path_factory.mktemp("mesh_cross"), plain=tuple(JOBS))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_step_matches_reference(runs, name):
    ref, port, _ = runs
    assert_step(port[name], ref[name], JOBS[name])


@pytest.mark.parametrize("name", sorted(JOBS))
def test_step_matches_step_off_the_mesh(runs, name):
    _, port, off = runs
    for k, w in off[name]["metrics"].items():
        np.testing.assert_allclose(port[name]["metrics"][k], w, rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)
    for what in ("params", "mu"):
        _assert_leaves(port[name][what], off[name][what], what)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_cross_and_encoder_params_trained(runs, name):
    """The cross sublayers' (and the encoder's) params got gradients on the
    mesh: the extras reached them. Reduced, the VLM has one cross sublayer
    (wq, wk, wv, wo); whisper four, and an encoder of 2 layers (ln1, the
    attention's 4, ln2, the GeLU MLP's 2) and its norm."""
    _, port, _ = runs
    mu = port[name]["mu"]
    cross = [k for k in mu if ".cross." in k or k.startswith(("encoder.", "enc_norm"))]
    assert len(cross) == {"vlm_step": 4, "whisper_step": 4 * 4 + 2 * 8 + 1}[name], sorted(cross)
    assert all(np.abs(mu[k]).max() > 0 for k in cross)

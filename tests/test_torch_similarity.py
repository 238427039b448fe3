"""Verdicts must not depend on the global TF32 settings.

The port's two cuBLAS fp32 products that decide verdicts (the small path
of ``CosineIndex.query`` and the detector's intra-stream ``feats @
feats.T``) go through ``similarity.exact_matmul``. With TF32 turned on
globally, through each of torch's three ways to do it, a spy on the
product sees TF32 off inside every call, the caller's settings come back
unchanged afterwards, and the verdicts equal those of a run with TF32
off. On the CPU the flags do not change a product, so the spy is what
shows the pinning; ``chip_smoke.py`` repeats the verdict check on the
card, where cuBLAS reads them."""
import numpy as np
import pytest
import torch

from repro.core import similarity as ref_similarity
from repro_torch.api.store import DedupStore
from repro_torch.core import chunking, context_model, features, pipeline, similarity
from repro_torch.data import workloads

torch.set_num_threads(1)

CUBLAS = torch.backends.cuda.matmul


def _settings() -> dict:
    """What a caller can read of the fp32 matmul settings (or which read raises)."""
    out = {}
    for name, read in (("precision", torch.get_float32_matmul_precision),
                       ("allow_tf32", lambda: CUBLAS.allow_tf32),
                       ("cuda_matmul", lambda: CUBLAS.fp32_precision),
                       ("mkldnn_matmul", lambda: torch.backends.mkldnn.matmul.fp32_precision)):
        try:
            out[name] = read()
        except (RuntimeError, AttributeError) as e:
            out[name] = f"raises {type(e).__name__}"
    return out


def _tf32_on(how: str) -> None:
    if how == "allow_tf32":
        CUBLAS.allow_tf32 = True
    elif how == "precision_high":
        torch.set_float32_matmul_precision("high")
    else:
        CUBLAS.fp32_precision = "tf32"


@pytest.fixture
def restore_settings():
    """Put the process's settings back as they were, whatever the test did."""
    precision = torch.get_float32_matmul_precision()
    knobs = [(CUBLAS, CUBLAS.fp32_precision),
             (torch.backends.mkldnn.matmul, torch.backends.mkldnn.matmul.fp32_precision)]
    yield
    torch.set_float32_matmul_precision(precision)
    for mod, value in knobs:
        mod.fp32_precision = value


def _ingest_verdicts(versions) -> list:
    det = pipeline.CARDDetector(
        feat_cfg=features.FeatureConfig(k=16, m=64, n=2),
        model_cfg=context_model.ContextModelConfig(m=64, d=50, steps=30),
        threshold=0.3, device="cpu")
    store = DedupStore(det, chunking.ChunkerConfig(avg_size=1024), device="cpu")
    store.fit(versions[:1])
    seen, score = [], det.score

    def recording(feats, batch):
        res = score(feats, batch)
        seen.append(res.base_ids.copy())
        return res

    det.score = recording
    for v in versions:
        store.ingest(v)
    return seen


@pytest.mark.parametrize("how", ["allow_tf32", "precision_high", "fp32_precision"])
def test_verdicts_ignore_global_tf32(monkeypatch, restore_settings, how):
    versions = workloads.make_workload(
        "kernel", workloads.WorkloadConfig(base_size=96 << 10, versions=3))
    want = _ingest_verdicts(versions)

    _tf32_on(how)
    outside = _settings()
    assert outside["cuda_matmul"] == "tf32"
    inside = []
    real = torch.matmul

    def spy(a, b):
        inside.append(_settings())
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    got = _ingest_verdicts(versions)
    monkeypatch.undo()

    # the index queries of versions 2 and 3, and every intra-stream pass
    assert len(inside) >= len(versions) + 2
    assert all(s["allow_tf32"] is False and s["cuda_matmul"] == "ieee" for s in inside), inside
    assert _settings() == outside
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert any((v >= 0).any() for v in want)


def test_small_query_matches_reference_with_tf32_on(restore_settings):
    rng = np.random.Generator(np.random.PCG64(8))
    rows = rng.standard_normal((300, 50)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = rows[:5] + 0.3 * rng.standard_normal((5, 50)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ref = ref_similarity.CosineIndex(50, use_kernel=False)
    ref.insert_batch(rows, np.arange(300))
    port = similarity.CosineIndex(50, device="cpu")
    port.insert_batch(torch.from_numpy(rows), np.arange(300))
    _tf32_on("allow_tf32")
    ids, scores = port.query(torch.from_numpy(q))
    want_ids, want_scores = ref.query(q)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-6, atol=1e-6)
    assert CUBLAS.allow_tf32 is True

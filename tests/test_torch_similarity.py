"""The port's indexes (``repro_torch.core.similarity``): verdicts that do
not depend on the global TF32 settings, and the banded index held to the
reference's.

Verdicts must not depend on the global TF32 settings.

The port's two cuBLAS fp32 products that decide verdicts (the small path
of ``CosineIndex.query`` and the detector's intra-stream ``feats @
feats.T``) go through ``similarity.exact_matmul``. With TF32 turned on
globally, through each of torch's three ways to do it, a spy on the
product sees TF32 off inside every call, the caller's settings come back
unchanged afterwards, and the verdicts equal those of a run with TF32
off. On the CPU the flags do not change a product, so the spy is what
shows the pinning; ``chip_smoke.py`` repeats the verdict check on the
card, where cuBLAS reads them.

``BandedLSHIndex`` takes the reference's planes, keys, tables and
answers on the same features, and a CARD store over it (by name or
through the ``use_lsh_bands`` alias) gives the reference's verdicts,
records and DCR."""
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


# --- the banded index ----------------------------------------------------------

def _unit_rows(seed: int, n: int, d: int = 50) -> np.ndarray:
    rows = np.random.Generator(np.random.PCG64(seed)).standard_normal((n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def test_banded_insert_batch_equals_serial_insert():
    rows = _unit_rows(1, 200)
    batch = similarity.BandedLSHIndex(50, device="cpu")
    batch.insert_batch(torch.from_numpy(rows), np.arange(200) + 7)
    serial = similarity.BandedLSHIndex(50, device="cpu")
    for i, r in enumerate(rows):
        serial.insert(r, i + 7)
    assert batch._tables == serial._tables
    assert all(np.array_equal(batch._feats[c], serial._feats[c]) for c in serial._feats)
    q = torch.from_numpy(rows[:20] + 0.1 * _unit_rows(2, 20))
    for a, b in zip(batch.query(q), serial.query(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bands,band_bits,seed", [(16, 6, 11), (8, 4, 3), (4, 10, 0)])
def test_banded_matches_reference(bands, band_bits, seed):
    """The same planes, keys, tables and answers as the reference's on the
    same features (near copies, unrelated rows, an empty bucket)."""
    rows = _unit_rows(seed + 5, 300)
    q = np.concatenate([rows[:40] + 0.2 * _unit_rows(seed + 6, 40), _unit_rows(seed + 7, 40)])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ref = ref_similarity.BandedLSHIndex(50, bands=bands, band_bits=band_bits, seed=seed)
    port = similarity.BandedLSHIndex(50, bands=bands, band_bits=band_bits, seed=seed,
                                     device="cpu")
    np.testing.assert_array_equal(port._planes, ref._planes)
    assert (port.query(torch.from_numpy(q))[0] == -1).all()        # empty index
    ref.insert_batch(rows, np.arange(300))
    port.insert_batch(torch.from_numpy(rows), np.arange(300))
    np.testing.assert_array_equal(port._keys_batch(q), ref._keys_batch(q))
    assert port._tables == ref._tables
    ids, scores = port.query(torch.from_numpy(q))
    want_ids, want_scores = ref.query(q)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)
    assert (ids >= 0).any() and (ids == -1).any()
    assert port.query_one(q[0]) == ref.query_one(q[0])


def _card_store_pair(port_kw: dict, ref_kw: dict):
    from repro.api.store import DedupStore as RefDedupStore
    from repro.core import chunking as ref_chunking
    from repro.core import context_model as ref_context_model
    from repro.core import features as ref_features
    from repro.core import pipeline as ref_pipeline
    feat, model = dict(k=16, m=64, n=2), dict(m=64, d=50, steps=30)
    port = DedupStore(pipeline.CARDDetector(
        features.FeatureConfig(**feat), context_model.ContextModelConfig(**model),
        device="cpu", **port_kw), chunking.ChunkerConfig(avg_size=1024), device="cpu")
    ref = RefDedupStore(ref_pipeline.CARDDetector(
        ref_features.FeatureConfig(**feat), ref_context_model.ContextModelConfig(**model),
        use_kernel=False, **ref_kw), ref_chunking.ChunkerConfig(avg_size=1024))
    return port, ref


@pytest.mark.parametrize("how", ["use_lsh_bands", "index"])
def test_card_with_banded_index_matches_reference(how):
    """CARD over the banded index, through the v0 alias and by name with
    index_args: the reference's verdicts, records, DCR and restores."""
    kw = ({"use_lsh_bands": True} if how == "use_lsh_bands"
          else {"index": "banded-lsh", "index_args": {"bands": 8, "band_bits": 5}})
    port, ref = _card_store_pair(kw, kw)
    assert type(port.detector.index) is similarity.BandedLSHIndex
    versions = workloads.make_workload(
        "kernel", workloads.WorkloadConfig(base_size=96 << 10, versions=3))
    for store in (port, ref):
        store.fit(versions[:1])
        for v in versions:
            store.ingest(v)
    key = lambda r: (r.bytes_stored, r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks)
    assert [key(r) for r in port.reports] == [key(r) for r in ref.reports]
    assert sorted(port.backend.chunk_ids()) == sorted(ref.backend.chunk_ids())
    for cid in ref.backend.chunk_ids():
        assert port.backend.record(cid) == ref.backend.record(cid)
    assert port.stats.dcr == ref.stats.dcr and port.stats.delta_chunks > 0
    for h, v in enumerate(versions):
        assert port.restore(h) == v


def test_cosine_index_use_kernel(monkeypatch):
    """``use_kernel=False`` changes nothing on the CPU and is refused on the
    card, where the port has no path that skips kernel C."""
    rows = _unit_rows(3, 600)
    off = similarity.CosineIndex(50, use_kernel=False, device="cpu")
    on = similarity.CosineIndex(50, device="cpu")
    for index in (off, on):
        index.insert_batch(torch.from_numpy(rows), np.arange(600))
    q = torch.from_numpy(rows[:16])
    for a, b in zip(off.query(q), on.query(q)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(similarity.ops, "resolve_device", lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="use_kernel=False"):
        similarity.CosineIndex(50, use_kernel=False)


def test_cosine_insert_matches_reference():
    """``CosineIndex.insert`` one row at a time, mixed with
    ``insert_batch``, holds the reference's rows and ids and answers its
    queries (past kernel C's gate too)."""
    rows = _unit_rows(7, 700)
    mine = similarity.CosineIndex(50, device="cpu")
    ref = ref_similarity.CosineIndex(50, use_kernel=False)
    for index, wrap in ((mine, torch.from_numpy), (ref, lambda a: a)):
        for i in range(5):
            index.insert(wrap(rows[i]), 100 + i)
        index.insert_batch(wrap(rows[5:690]), np.arange(105, 790))
        for i in range(690, 700):
            index.insert(rows[i], 100 + i)
    assert len(mine) == len(ref) == 700
    np.testing.assert_array_equal(mine._buf[:700].numpy(), ref._buf[:700])
    np.testing.assert_array_equal(mine._ids[:700], ref._ids[:700])
    q = rows[::37] + 0.01 * _unit_rows(8, 19)
    ids, scores = mine.query(torch.from_numpy(q.astype(np.float32)))
    ref_ids, ref_scores = ref.query(q.astype(np.float32))
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-6)

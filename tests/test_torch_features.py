"""The port's per-chunk feature path, the ``lsh="poly"`` ablation,
``normalize=False`` and the oversize route (``repro_torch.core.features``)
against the JAX package's ``repro.core.features``: the integer stages
(sub-chunk LSH, poly hashes) bit for bit, features within
``tests/test_kernels.py``'s 1e-5 (and the per-chunk path within
``tests/test_ingest_fast.py``'s 3e-7 of the fused one). Inputs are
seeded numpy bytes handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as ref_features
from repro.core import hashing as ref_hashing
from repro.kernels import ingest as ref_ingest
from repro_torch.core import features, hashing
from repro_torch.kernels import ingest, ops

torch.set_num_threads(1)

CPU = torch.device("cpu")
# test_ingest_fast.py:35's ragged sizes, several shorter than the 32-byte
# gear warm-up
RAGGED = [1, 2, 31, 32, 33, 5, 700, 8192, 40000, 17]


def _case(sizes, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    stream = rng.integers(0, 256, size=sum(sizes), dtype=np.uint8)
    offsets = np.cumsum([0] + list(sizes[:-1]))
    chunks = [stream[o:o + s].tobytes() for o, s in zip(offsets, sizes)]
    return chunks, ref_hashing.gear_hashes_np(stream), offsets


def _rand_chunks(seed, n=6, lo=2000, hi=30000):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, 256, size=int(s), dtype=np.uint8).tobytes()
            for s in rng.integers(lo, hi, size=n)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# --- hashing: the poly substrate ------------------------------------------------

def test_poly_constants_are_the_reference_s():
    assert hashing.POLY_P_INV == ref_hashing.POLY_P_INV
    for a in (1, 3, 0x01000193, 2**32 - 1):
        assert hashing.modinv_pow2(a) == ref_hashing.modinv_pow2(a)
    with pytest.raises(ValueError, match="even"):
        hashing.modinv_pow2(4)
    np.testing.assert_array_equal(
        hashing.pow_table(int(hashing.POLY_P), 1000, CPU).numpy().astype(np.uint32),
        ref_hashing.poly_powers(1000))


@pytest.mark.parametrize("n", [0, 1, 2, 31, 1000, 65_537])
def test_poly_hashes_bit_for_bit(n):
    rng = np.random.Generator(np.random.PCG64(n))
    data = rng.integers(0, 256, size=n, dtype=np.uint8)
    assert hashing.poly_hash(torch.from_numpy(data)) == ref_hashing.poly_hash_np(data)
    bounds = np.sort(rng.integers(0, n + 1, size=17))
    bounds[0], bounds[-1] = 0, n
    np.testing.assert_array_equal(
        _u32(hashing.segment_poly_hashes(torch.from_numpy(data), torch.from_numpy(bounds))),
        ref_hashing.segment_poly_hashes_np(data, bounds))


# --- sub-chunk LSH ---------------------------------------------------------------

@pytest.mark.parametrize("k", [32, 16, 5])
def test_per_chunk_lsh_bit_for_bit(k):
    """Each chunk alone (``subchunk_maxgear``, ``subchunk_poly``) and the
    batch with and without the stream scan, ragged chunks included."""
    chunks, h, offs = _case(RAGGED, seed=k)
    for c, o in zip(chunks, offs):
        np.testing.assert_array_equal(features.subchunk_maxgear(h[o:o + len(c)], k),
                                      ref_features.subchunk_maxgear_np(h[o:o + len(c)], k))
        np.testing.assert_array_equal(
            _u32(features.subchunk_poly(torch.frombuffer(bytearray(c), dtype=torch.uint8), k)),
            ref_features.subchunk_poly_np(c, k))
    for lsh in ("maxgear", "poly"):
        cfg = features.FeatureConfig(k=k, lsh=lsh)
        ref_cfg = ref_features.FeatureConfig(k=k, lsh=lsh)
        want = ref_features.batch_subchunk_lsh_np(chunks, ref_cfg)
        np.testing.assert_array_equal(
            _u32(features.batch_subchunk_lsh(chunks, cfg, device=CPU)), want)
        np.testing.assert_array_equal(
            _u32(features.batch_subchunk_lsh(chunks, cfg, h, offs, device=CPU)),
            ref_features.batch_subchunk_lsh_np(chunks, ref_cfg, h, offs))


def test_packed_gear_route_equals_per_chunk_scan():
    """Chunks given without a scan: one kernel A call over the chunks laid
    end to end (the plain version here) gives, at every position past a
    chunk's 31-byte warm-up, that chunk's own scan."""
    chunks, _, _ = _case(RAGGED, seed=9)
    packed, starts, lens = features.pack_chunk_bytes(chunks, CPU)
    assert packed.shape[0] % ingest.SCAN_ALIGN == 0
    gear = hashing.from_i32_bits(ops.gear_hashes(packed)).numpy()
    for c, s in zip(chunks, starts.tolist()):
        alone = ref_hashing.gear_hashes_np(np.frombuffer(c, np.uint8))
        np.testing.assert_array_equal(gear[s + 31:s + len(c)], alone[31:])


def test_batched_maxgear_matches_reference_j():
    chunks = _rand_chunks(6, n=5) + _case([3, 40], seed=1)[0]
    k = 32
    lmax = max(len(c) for c in chunks)
    gear = np.zeros((len(chunks), lmax), np.uint32)
    lens = np.array([len(c) for c in chunks], np.int32)
    for i, c in enumerate(chunks):
        gear[i, :len(c)] = ref_hashing.gear_hashes_np(np.frombuffer(c, np.uint8))
    want = np.asarray(ref_features.batch_subchunk_maxgear_j(
        jnp.asarray(gear), jnp.asarray(lens), k))
    got = features.batch_subchunk_maxgear(
        torch.from_numpy(gear.astype(np.int64)), torch.from_numpy(lens), k)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        want, ref_features.batch_subchunk_lsh_np(chunks, ref_features.FeatureConfig(k=k)))


@pytest.mark.parametrize("k", [16, 32])
def test_batched_poly_matches_reference_j(k):
    chunks = _rand_chunks(7, n=5) + _case([3, 40], seed=2)[0]
    lmax = max(len(c) for c in chunks)
    padded = np.zeros((len(chunks), lmax), np.uint8)
    lens = np.array([len(c) for c in chunks], np.int32)
    for i, c in enumerate(chunks):
        padded[i, :len(c)] = np.frombuffer(c, np.uint8)
    want = np.asarray(ref_features.batch_subchunk_poly_j(
        jnp.asarray(padded), jnp.asarray(lens), k))
    got = features.batch_subchunk_poly(torch.from_numpy(padded), torch.from_numpy(lens), k)
    np.testing.assert_array_equal(_u32(got), want)


# --- features --------------------------------------------------------------------

def test_embed_normalize_false_matches_reference():
    """The plain embed and ``ops.shingle_embed`` with ``normalize=False``
    against the reference's ``embed_shingles_j``; an all-masked row is 0."""
    rng = np.random.Generator(np.random.PCG64(11))
    ids = rng.integers(0, 2**32, size=(13, 61), dtype=np.uint32)
    mask = rng.random((13, 61)) < 0.8
    mask[0] = False
    a_np, b_np = ref_hashing.multiply_shift_params(50)
    ids_t = hashing.to_i32_bits(torch.from_numpy(ids.astype(np.int64)))
    a = hashing.to_i32_bits(hashing.u32_tensor(a_np, CPU))
    b = hashing.to_i32_bits(hashing.u32_tensor(b_np, CPU))
    for normalize in (False, True):
        want = np.asarray(ref_features.embed_shingles_j(
            jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(a_np), jnp.asarray(b_np),
            normalize))
        m = torch.from_numpy(mask)
        for got in (features.embed_shingles(ids_t, m, a, b, normalize),
                    ops.shingle_embed(ids_t, m, a, b, normalize=normalize)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
            assert float(got[0].abs().max()) == 0.0
        norms = np.linalg.norm(want[1:], axis=1)
        assert (np.abs(norms - 1) < 1e-5).all() == normalize


@pytest.mark.parametrize("lsh", ["maxgear", "poly"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("scan", [True, False])
def test_extractor_matches_reference(lsh, normalize, fused, scan):
    """Every route of ``FeatureExtractor.__call__`` against the reference's
    on the same chunks (ragged sizes), with and without the stream scan."""
    chunks, h, offs = _case(RAGGED, seed=3)
    kw = dict(lsh=lsh, normalize=normalize)
    args = (h, offs) if scan else ()
    want = ref_features.FeatureExtractor(ref_features.FeatureConfig(**kw), use_kernel=False,
                                         fused=fused)(chunks, *args)
    got = features.FeatureExtractor(features.FeatureConfig(**kw), device=CPU,
                                    fused=fused)(chunks, *args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_chunk_path_matches_fused(seed):
    """test_ingest_fast's pin on the port: the per-chunk path and the fused
    path give the same features within 3e-7 (ragged and random sizes)."""
    rng = np.random.Generator(np.random.PCG64(100 + seed))
    sizes = RAGGED if seed == 0 else [int(s) for s in rng.integers(1, 3000, size=12)]
    chunks, h, offs = _case(sizes, seed=seed)
    fused = features.FeatureExtractor(device=CPU, fused=True)(chunks, h, offs)
    per_chunk = features.FeatureExtractor(device=CPU, fused=False)(chunks, h, offs)
    no_scan = features.FeatureExtractor(device=CPU)(chunks)
    np.testing.assert_allclose(per_chunk.numpy(), fused.numpy(), atol=3e-7)
    np.testing.assert_allclose(no_scan.numpy(), fused.numpy(), atol=3e-7)


def test_features_from_subhashes_pads_as_the_reference():
    rng = np.random.Generator(np.random.PCG64(5))
    sub = rng.integers(0, 2**32, size=(21, 32), dtype=np.uint32)
    want = ref_features.FeatureExtractor(use_kernel=False).features_from_subhashes(sub)
    ext = features.FeatureExtractor(device=CPU)
    for given in (sub, hashing.u32_tensor(sub, CPU)):
        np.testing.assert_allclose(ext.features_from_subhashes(given).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_oversize_stream_takes_the_per_chunk_path(monkeypatch):
    """With both packages' FUSED_STREAM_LIMIT below the stream, both route
    to the per-chunk path (the fused extract is never entered and raises
    if called) and give the same features; below the limit the fused
    path runs."""
    chunks, h, offs = _case(RAGGED, seed=4)
    limit = len(h) - 1
    monkeypatch.setattr(ref_ingest, "FUSED_STREAM_LIMIT", limit)
    monkeypatch.setattr(ingest, "FUSED_STREAM_LIMIT", limit)
    entered = []
    real = ingest.extract_stream

    def spy(*args, **kwargs):
        entered.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ingest, "extract_stream", spy)
    want = ref_features.FeatureExtractor(use_kernel=False)(chunks, h, offs)
    got = features.FeatureExtractor(device=CPU)(chunks, h, offs)
    assert not entered
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    lens = np.asarray([len(c) for c in chunks], np.int64)
    ext = features.FeatureExtractor(device=CPU)
    with pytest.raises(ValueError, match="FUSED_STREAM_LIMIT"):
        real(h, offs, lens, ext._a, ext._b, k=32, n=2)
    with pytest.raises(ValueError, match="FUSED_STREAM_LIMIT"):
        a, b = ref_hashing.multiply_shift_params(64)
        ref_ingest.extract_stream(h, offs, lens, jnp.asarray(a), jnp.asarray(b), k=32, n=2)
    monkeypatch.setattr(ingest, "FUSED_STREAM_LIMIT", len(h))
    ext(chunks, h, offs)
    assert entered == [1]


def test_empty_batch():
    for fused in (True, False):
        out = features.FeatureExtractor(device=CPU, fused=fused)([])
        assert tuple(out.shape) == (0, 64) and out.dtype == torch.float32


class _FixedChunker:
    """A custom chunker (``api.store.chunk_with``'s ``chunk`` protocol) that
    cuts fixed 3000-byte chunks and gives no stream scan."""

    def __init__(self, chunking_module):
        self._chunking = chunking_module

    def chunk(self, stream: bytes):
        bounds = np.asarray(sorted({*range(0, len(stream), 3000), len(stream)}), np.int64)
        return self._chunking.chunks_from_bounds(stream, bounds), None


def test_custom_chunker_without_scan_takes_the_per_chunk_path(monkeypatch):
    """CARD over a chunker that gives no scan: the port takes the per-chunk
    path (packed gear route) as the reference does, with its verdicts,
    records and DCR."""
    from repro.api.store import DedupStore as RefDedupStore
    from repro.core import chunking as ref_chunking
    from repro.core import context_model as ref_context_model
    from repro.core import pipeline as ref_pipeline
    from repro_torch.api.store import DedupStore
    from repro_torch.core import chunking, context_model, pipeline
    from repro_torch.data import workloads
    versions = workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=200 << 10, versions=3))
    model = dict(m=64, d=50, steps=30)
    port = DedupStore(pipeline.CARDDetector(
        model_cfg=context_model.ContextModelConfig(**model), device=CPU),
        _FixedChunker(chunking), device=CPU)
    ref = RefDedupStore(ref_pipeline.CARDDetector(
        model_cfg=ref_context_model.ContextModelConfig(**model), use_kernel=False),
        _FixedChunker(ref_chunking))
    fused = []
    real = ingest.extract_stream
    monkeypatch.setattr(ingest, "extract_stream", lambda *a, **k: fused.append(1) or real(*a, **k))
    for store in (port, ref):
        store.fit(versions[:1])
        for v in versions:
            store.ingest(v)
    assert not fused
    key = lambda r: (r.bytes_stored, r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks)
    assert [key(r) for r in port.reports] == [key(r) for r in ref.reports]
    for cid in ref.backend.chunk_ids():
        assert port.backend.record(cid) == ref.backend.record(cid)
    assert port.stats.dcr == ref.stats.dcr and port.stats.delta_chunks > 0

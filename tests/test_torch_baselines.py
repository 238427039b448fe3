"""The port's N-transform / Finesse baselines against the JAX package's
``repro.core.baselines``, all integer, so every check is bit for bit:

- each scheme's per-chunk ``super_features`` on the chunk lengths where
  the Rabin warm-up (W 48) and Finesse's 12 sub-chunks change shape;
- the batched extract (the chunks packed with zero gaps, kernel A's Rabin
  route, here its plain version on the CPU, then range maxes) equal to
  the per-chunk function, chunk by chunk;
- Finesse's batched sub-chunk bounds against the reference's scalar
  ``np.linspace(0, n, t + 1).astype(np.int64)`` at every length up to the
  chunker's max;
- ``SuperFeatureIndex``'s overlay semantics, and the staged FirstFit
  detector against the v0 interleaved query/insert loop.

Data goes between the packages as bytes and numpy arrays only."""
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro_torch.core import baselines, chunking, pipeline
from repro_torch.data import workloads
from repro_torch.kernels import ingest

torch.set_num_threads(1)

CCFG = chunking.ChunkerConfig(avg_size=8192)
LENGTHS = [1, 11, 12, 47, 48, 49, 8192, CCFG.max_size]
SCHEMES = {"n-transform": (ref_baselines.NTransform, baselines.NTransform),
           "finesse": (ref_baselines.Finesse, baselines.Finesse)}


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _scan(stream: bytes) -> ingest.StreamScan:
    buf = np.frombuffer(stream, dtype=np.uint8)
    return ingest.scan_stream(buf, CCFG.mask_s, CCFG.mask_l, "cpu")[0]


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_super_features_match_reference(scheme, length):
    ref_cls, port_cls = SCHEMES[scheme]
    data = _bytes(length, length)
    want = ref_cls().super_features(data)
    got = port_cls().super_features(data)
    assert got == want
    assert all(type(v) is int for v in got)


@pytest.mark.parametrize("cfg", [dict(features_per_sf=2, sf_count=2, window=16),
                                 dict(features_per_sf=3, sf_count=4, window=48)],
                         ids=["g2_sf2_w16", "g3_sf4_w48"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_super_features_match_reference_other_configs(scheme, cfg):
    ref_cls, port_cls = SCHEMES[scheme]
    for length in (5, 100, 3000):
        data = _bytes(length, 7 * length)
        want = ref_cls(ref_baselines.SuperFeatureConfig(**cfg)).super_features(data)
        assert port_cls(baselines.SuperFeatureConfig(**cfg)).super_features(data) == want


def test_fnv64_matches_reference():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**63, (50, 4), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    got = baselines.fnv64(vals)
    assert got.tolist() == [ref_baselines._fnv64(r) for r in vals]


def _ragged_chunks(stream: bytes) -> list[chunking.Chunk]:
    """Chunks of every interesting length, end to end over ``stream``."""
    lens = LENGTHS[:-1] + [300, 2, 5000]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    assert bounds[-1] <= len(stream)
    return chunking.chunks_from_bounds(stream, bounds)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_batched_extract_equals_per_chunk(scheme):
    """Packed chunks with 47-byte zero gaps through the plain Rabin route:
    every chunk's super-features equal the per-chunk function's, including
    chunks shorter than the window and neighbours of them."""
    ref_cls, port_cls = SCHEMES[scheme]
    stream = _bytes(20_000, 3)
    chunks = _ragged_chunks(stream)
    det = pipeline.SuperFeatureDetector(port_cls(), scheme, device="cpu")
    ids = np.arange(len(chunks))
    batch = pipeline.DetectBatch(chunks=chunks, ids=ids, is_new=np.ones(len(chunks), bool),
                                 stream_hashes=_scan(stream))
    got = det.extract(batch)
    ref = ref_cls()
    assert got == [ref.super_features(c.data) for c in chunks]
    assert got == [port_cls().super_features(c.data) for c in chunks]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_batched_extract_on_fastcdc_chunks(scheme):
    """The same on the chunker's own chunks of a real workload stream."""
    ref_cls, port_cls = SCHEMES[scheme]
    stream = workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=256 << 10, versions=1))[0]
    from repro_torch.api.store import chunk_with
    chunks, scan = chunk_with(CCFG, stream, "cpu")
    det = pipeline.SuperFeatureDetector(port_cls(), scheme, device="cpu")
    ids = np.arange(len(chunks))
    batch = pipeline.DetectBatch(chunks=chunks, ids=ids, is_new=np.ones(len(chunks), bool),
                                 stream_hashes=scan)
    ref = ref_cls()
    assert det.extract(batch) == [ref.super_features(c.data) for c in chunks]


def test_packed_buffer_layout():
    """Chunk bytes land at their packed starts, everything else is zero,
    and the fingerprints there are each chunk's own scan."""
    stream = _bytes(4000, 11)
    offs = np.array([0, 100, 101, 160, 3000])
    lens = np.array([100, 1, 59, 2840, 1000])
    scan = _scan(stream)
    packed, starts = ingest.pack_chunks(scan.data, offs, lens, 47)
    assert packed.shape[0] == ingest.scan_length(lens.sum() + 47 * 4)
    assert starts.tolist() == [0, 147, 195, 301, 3188]
    rest = packed.clone()
    for o, n, s in zip(offs, lens, starts.tolist()):
        assert bytes(packed[s:s + n].numpy()) == stream[o:o + n]
        rest[s:s + n] = 0
    assert int(rest.abs().sum()) == 0
    fps, fstarts = ingest.chunk_rabin_fps(scan, offs, lens)
    assert torch.equal(fstarts, starts) and fps.shape == packed.shape
    for o, n, s in zip(offs, lens, starts.tolist()):
        want = baselines._chunk_fps(stream[o:o + n], 48)
        assert np.array_equal(fps[s:s + n].numpy().astype(np.uint64), want)


@pytest.mark.parametrize("t", [12, 4, 6])
def test_finesse_bounds_match_scalar_linspace(t):
    lengths = np.arange(1, CCFG.max_size + 1)
    got = baselines.finesse_bounds(lengths, t)
    want = np.stack([np.linspace(0, int(n), t + 1).astype(np.int64) for n in lengths])
    assert got.dtype == np.int64 and np.array_equal(got, want)
    with pytest.raises(ValueError, match=">= 1"):
        baselines.finesse_bounds(np.array([3, 0]), t)


@pytest.mark.parametrize("width", [20, 1000, 9000])
def test_range_max_matches_loop(width):
    """The two-tier range max the baselines share with the CARD extract:
    the dense path (widths <= 32) and the tiled one, with empty ranges,
    ranges at the buffer's ends and ranges of one tile or less."""
    rng = np.random.default_rng(width)
    n = ingest.scan_length(40_000)
    vals = rng.integers(0, 2**32, n, dtype=np.int64)
    s = rng.integers(0, n - width, (50, 3))
    e = s + rng.integers(0, width + 1, (50, 3))
    s[0], e[0] = [0, 5, n - width], [0, 5 + min(width, 3), n]
    got = ingest.range_max(torch.from_numpy(vals), torch.from_numpy(s),
                           torch.from_numpy(e), width).numpy()
    want = [[vals[a:b].max() if b > a else 0 for a, b in zip(ra, rb)] for ra, rb in zip(s, e)]
    assert got.tolist() == want


def test_ntransform_constants_match_reference():
    ref, port = ref_baselines.NTransform(), baselines.NTransform()
    assert np.array_equal(ref._m, port._m) and np.array_equal(ref._a, port._a)
    assert port._m.dtype == port._a.dtype == np.uint64


def test_super_feature_index_overlay_semantics():
    """Random query / stage / insert sequences: the port's index answers
    as the reference's, its tables equal, and a staged entry never shows
    in the tables; persistent entries win over staged ones."""
    rng = np.random.default_rng(9)
    ref, port = ref_baselines.SuperFeatureIndex(), baselines.SuperFeatureIndex()
    for step in range(400):
        overlay_r: list = []
        overlay_p: list = []
        for cid in range(step * 10, step * 10 + int(rng.integers(1, 8))):
            sfs = tuple(int(x) for x in rng.integers(0, 12, 3))
            assert ref.query(sfs, overlay_r) == port.query(sfs, overlay_p)
            assert ref.query(sfs) == port.query(sfs)
            ref.stage(sfs, cid, overlay_r)
            port.stage(sfs, cid, overlay_p)
            assert overlay_r == overlay_p
        if rng.random() < 0.5:
            for j, table in enumerate(overlay_p):
                for sf, cid in table.items():
                    sfs = tuple(sf if k == j else -1 for k in range(3))
                    ref.insert(sfs, cid)
                    port.insert(sfs, cid)
        assert ref._tables == port._tables

    idx = baselines.SuperFeatureIndex()
    idx.insert((1, 2, 3), 10)
    overlay: list = []
    idx.stage((1, 5, 6), 11, overlay)
    assert overlay == [{}, {5: 11}, {6: 11}]           # sf 1 is persistent: not staged
    assert idx._tables == [{1: 10}, {2: 10}, {3: 10}]  # stage mutates nothing
    assert idx.query((9, 5, 0), overlay) == 11
    assert idx.query((1, 5, 0), overlay) == 10         # first SF, persistent first
    assert idx.query((9, 9, 9), overlay) is None


class _V0SuperFeatureDetector:
    """The v0 monolithic FirstFit loop, verbatim: interleaved query/insert
    against the shared index, per-chunk super-features on the host."""

    def __init__(self, scheme, name):
        self._scheme = scheme
        self.name = name
        self.device = torch.device("cpu")
        self._index = baselines.SuperFeatureIndex()

    def fit(self, training_streams, cfg):
        pass

    def detect(self, chunks, ids, is_new, stream_hashes):
        out = np.full(len(chunks), -1, np.int64)
        for i, ck in enumerate(chunks):
            sfs = self._scheme.super_features(ck.data)
            if is_new[i]:
                hit = self._index.query(sfs)
                if hit is not None and hit != ids[i]:
                    out[i] = hit
            self._index.insert(sfs, int(ids[i]))
        return out


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_staged_firstfit_bit_identical_to_v0(scheme):
    _, port_cls = SCHEMES[scheme]
    versions = workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=256 << 10, versions=3))
    staged = pipeline.SuperFeatureDetector(port_cls(), scheme, device="cpu")
    v0 = _V0SuperFeatureDetector(port_cls(), scheme)
    key = lambda s: (s.bytes_in, s.bytes_stored, s.chunks, s.dup_chunks,
                     s.delta_chunks, s.raw_chunks)
    s_new = pipeline.run_workload(staged, versions, CCFG)
    s_old = pipeline.run_workload(v0, versions, CCFG)
    assert key(s_new) == key(s_old)
    assert s_new.delta_chunks > 0
    assert staged._index._tables == v0._index._tables

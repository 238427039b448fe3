"""The port's ``core.chunking.chunk_stream`` and ``api.store.chunk_with``
against the JAX package's: the same chunks (offsets, lengths, bytes) for
every workload and a few chunker widths, through the port's scan (kernel
A's plain version on the CPU) and from precomputed hashes (``hashes=``);
``candidate_bitmaps`` and the serial oracle ``chunk_boundaries_serial``
bit for bit; and ``chunk_with`` hands a chunker that has a ``chunk``
method the stream as the reference's does."""
import inspect

import numpy as np
import pytest
import torch

from repro.api import store as ref_store
from repro.core import chunking as ref_chunking
from repro.core import hashing as ref_hashing
from repro.data import workloads as ref_workloads
from repro_torch.api import config
from repro_torch.api.store import chunk_with
from repro_torch.core import chunking
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _key(chunks):
    return [(c.offset, c.length, c.data) for c in chunks]


@pytest.mark.parametrize("name", ["sql_dump", "vmdk", "kernel"])
@pytest.mark.parametrize("avg", [2048, 8192])
def test_chunk_stream_matches_reference(name, avg):
    stream = ref_workloads.make_workload(
        name, ref_workloads.WorkloadConfig(base_size=1 << 19, versions=1))[0]
    cfg = chunking.ChunkerConfig(avg_size=avg)
    ref_cfg = ref_chunking.ChunkerConfig(avg_size=avg)
    got = chunking.chunk_stream(stream, cfg, device="cpu")
    assert _key(got) == _key(ref_chunking.chunk_stream(stream, ref_cfg))
    assert b"".join(c.data for c in got) == stream
    arr = np.frombuffer(stream, np.uint8)
    assert _key(chunking.chunk_stream(arr, cfg, device="cpu")) == _key(got)
    assert _key(chunk_with(cfg, stream, "cpu")[0]) == _key(got)
    assert chunking.chunk_stream(b"", cfg, device="cpu") == []


def _stream(name, size=1 << 18):
    return ref_workloads.make_workload(
        name, ref_workloads.WorkloadConfig(base_size=size, versions=1))[0]


@pytest.mark.parametrize("name", ["sql_dump", "vmdk"])
@pytest.mark.parametrize("avg", [1024, 8192])
def test_chunk_stream_from_precomputed_hashes_matches_reference(name, avg):
    """``chunk_stream(data, cfg, hashes=h)``, the reference's signature,
    with the hashes as uint32 (the reference's oracle) or as the int32
    bits kernel A's wrapper returns; positional ``hashes`` too."""
    stream = _stream(name)
    cfg, ref_cfg = chunking.ChunkerConfig(avg_size=avg), ref_chunking.ChunkerConfig(avg_size=avg)
    h = ref_hashing.gear_hashes_np(np.frombuffer(stream, np.uint8))
    want = _key(ref_chunking.chunk_stream(stream, ref_cfg, hashes=h))
    assert _key(chunking.chunk_stream(stream, cfg, hashes=h)) == want
    assert _key(chunking.chunk_stream(stream, cfg, h)) == want
    bits = ops.gear_hashes(torch.from_numpy(np.frombuffer(stream, np.uint8).copy())).numpy()
    assert bits.dtype == np.int32
    assert _key(chunking.chunk_stream(np.frombuffer(stream, np.uint8), cfg, hashes=bits)) == want
    assert _key(chunking.chunk_stream(stream, cfg, device="cpu")) == want
    assert chunking.chunk_stream(b"", cfg, hashes=np.zeros(0, np.uint32)) == []


def test_chunk_stream_device_is_keyword_only():
    params = inspect.signature(chunking.chunk_stream).parameters
    assert list(params)[:3] == list(inspect.signature(ref_chunking.chunk_stream).parameters)
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("norm_level", [0, 2, 3])
def test_candidate_bitmaps_match_reference(norm_level):
    stream = _stream("kernel", 1 << 16)
    cfg = chunking.ChunkerConfig(avg_size=2048, norm_level=norm_level)
    ref_cfg = ref_chunking.ChunkerConfig(avg_size=2048, norm_level=norm_level)
    want = ref_chunking.candidate_bitmaps(stream, ref_cfg)
    h = ref_hashing.gear_hashes_np(np.frombuffer(stream, np.uint8))
    for got in (chunking.candidate_bitmaps(stream, cfg, device="cpu"),
                chunking.candidate_bitmaps(np.frombuffer(stream, np.uint8), cfg, h)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.bool_
            np.testing.assert_array_equal(g, w)
    assert want[0].sum() <= want[1].sum()           # the harder mask cuts no more


def _serial_inputs():
    """(data, avg, norm_level): the Queue 3 probe's cases, lengths 0, 1, 5,
    min, min + 1, avg, 3 avg and 50 avg + 7 over random, zero and 2-bit
    data."""
    rng = np.random.default_rng(9)
    cases = []
    for avg, level in ((64, 0), (256, 1), (1024, 2), (512, 3)):
        mn = chunking.ChunkerConfig(avg_size=avg).min_size
        for n in (0, 1, 5, mn, mn + 1, avg, 3 * avg, 50 * avg + 7):
            for kind in ("random", "zero", "two_bit"):
                data = {"random": rng.integers(0, 256, n, np.uint8),
                        "zero": np.zeros(n, np.uint8),
                        "two_bit": rng.integers(0, 4, n, np.uint8)}[kind]
                cases.append((data.tobytes(), avg, level))
    return cases


def test_chunk_boundaries_serial_matches_reference():
    for data, avg, level in _serial_inputs():
        cfg = chunking.ChunkerConfig(avg_size=avg, norm_level=level)
        want = ref_chunking.chunk_boundaries_serial(
            data, ref_chunking.ChunkerConfig(avg_size=avg, norm_level=level))
        got = chunking.chunk_boundaries_serial(data, cfg)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"n {len(data)}, avg {avg}")
        if data:   # the oracle agrees with the scan (min_size >= 64 > the 32-byte window)
            scanned = [0] + [c.offset + c.length for c in
                             chunking.chunk_stream(data, cfg, device="cpu")]
            np.testing.assert_array_equal(got, scanned)


class _FixedChunker:
    """A custom chunker: fixed 4 KiB pieces, no stream hashes."""

    def __init__(self, chunk_module):
        self.mod = chunk_module

    def chunk(self, stream):
        bounds = np.asarray(list(range(0, len(stream), 4096)) + [len(stream)], np.int64)
        return self.mod.chunks_from_bounds(stream, bounds), None


def test_chunk_with_dispatches_to_a_chunk_method():
    stream = bytes(np.random.default_rng(1).integers(0, 256, 50_000, np.uint8))
    got, hashes = chunk_with(_FixedChunker(chunking), stream, "cpu")
    want, _ = ref_store.chunk_with(_FixedChunker(ref_chunking), stream)
    assert _key(got) == _key(want) and hashes is None
    assert [c.length for c in got] == [4096] * 12 + [50_000 - 12 * 4096]
    store = config.build_store(config.DedupConfig.from_dict({"detector": "dedup-only"}),
                               device="cpu")
    store.cfg = _FixedChunker(chunking)
    twice = stream[:12 * 4096] * 2          # the second copy: 12 whole duplicates
    report = store.open_stream()
    report.write(twice)
    report = report.commit()
    assert (report.chunks, report.dup_chunks, report.raw_chunks) == (24, 12, 12)
    assert store.restore(report.handle) == twice

"""The port's ``core.chunking.chunk_stream`` and ``api.store.chunk_with``
against the JAX package's: the same chunks (offsets, lengths, bytes) for
every workload and a few chunker widths, through the port's scan (kernel
A's plain version on the CPU); and ``chunk_with`` hands a chunker that
has a ``chunk`` method the stream as the reference's does."""
import numpy as np
import pytest
import torch

from repro.api import store as ref_store
from repro.core import chunking as ref_chunking
from repro.data import workloads as ref_workloads
from repro_torch.api import config
from repro_torch.api.store import chunk_with
from repro_torch.core import chunking

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

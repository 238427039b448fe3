"""Value types of the detection & store API (port of ``repro.api.types``;
only the fields this port fills).

  DetectBatch    one stream's worth of chunks handed to a detector;
  DetectResult   per-chunk resemblance verdict (base chunk id, score);
  IngestReport   immutable per-stream accounting returned by
                 ``StreamSession.commit()``;
  RestoreReport  immutable per-restore accounting: bytes served against
                 container bytes read, read / decode time, decode-cache
                 hits and misses (``DedupStore.last_restore``);
  StoreStats     the store-lifetime aggregate (sum of every IngestReport
                 and RestoreReport plus offline fit time).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

if TYPE_CHECKING:  # chunking imports the kernels, which import core: no cycle at run time
    from repro_torch.core.chunking import Chunk


@dataclasses.dataclass
class DetectBatch:
    """One stream of chunks, exact dedup already resolved.

    chunks         the stream's chunks, in stream order
    ids            [n] int64 chunk id per chunk (duplicates share ids)
    is_new         [n] bool — True where the chunk's content was never
                   stored before (first occurrence wins inside a stream)
    stream_hashes  the chunker's scan of the whole stream
                   (``kernels.ingest.StreamScan``, on the device)
    """

    chunks: Sequence[Chunk]
    ids: np.ndarray
    is_new: np.ndarray
    stream_hashes: Any

    def __post_init__(self) -> None:
        self.ids = np.asarray(self.ids, np.int64)
        self.is_new = np.asarray(self.is_new, bool)
        if len(self.chunks) != self.ids.shape[0] or self.ids.shape != self.is_new.shape:
            raise ValueError(
                f"DetectBatch shape mismatch: {len(self.chunks)} chunks, "
                f"ids {self.ids.shape}, is_new {self.is_new.shape}")

    def __len__(self) -> int:
        return len(self.chunks)

    @property
    def offsets(self) -> np.ndarray:
        return np.asarray([c.offset for c in self.chunks], np.int64)


@dataclasses.dataclass
class DetectResult:
    """Per-chunk verdict: base chunk id to delta-encode against (-1 = store
    raw) and the resemblance score."""

    base_ids: np.ndarray
    scores: np.ndarray | None = None

    def __post_init__(self) -> None:
        self.base_ids = np.asarray(self.base_ids, np.int64)

    def __len__(self) -> int:
        return int(self.base_ids.shape[0])


@dataclasses.dataclass(frozen=True)
class IngestReport:
    """What one committed stream did to the store."""

    handle: int                 # pass to DedupStore.restore()
    bytes_in: int = 0
    bytes_stored: int = 0
    chunks: int = 0
    dup_chunks: int = 0
    delta_chunks: int = 0
    raw_chunks: int = 0
    detect_seconds: float = 0.0   # extract + score + observe
    chunk_seconds: float = 0.0
    delta_seconds: float = 0.0
    extract_seconds: float = 0.0
    score_seconds: float = 0.0
    observe_seconds: float = 0.0
    store_seconds: float = 0.0    # backend writes, excluding delta encodes

    @property
    def dcr(self) -> float:
        """This stream's own deduplication-compression ratio."""
        return self.bytes_in / max(1, self.bytes_stored)


@dataclasses.dataclass(frozen=True)
class RestoreReport:
    """What one restore (full, ranged, or fully-consumed iterator) cost.
    ``read_seconds``/``decode_seconds``/``bytes_read`` and the cache
    counters come from backend telemetry deltas; backends without
    counters (the in-memory one) report zeros there while
    ``seconds``/``bytes_out`` stay exact."""

    handle: int
    bytes_out: int = 0          # bytes served to the caller
    chunks: int = 0             # recipe slots touched
    seconds: float = 0.0        # end-to-end wall time
    read_seconds: float = 0.0   # container payload I/O, summed across
    #                             pooled readers (can exceed the wall
    #                             share once readahead overlaps decode)
    decode_seconds: float = 0.0  # delta-chain decoding
    bytes_read: int = 0         # container bytes fetched (vs bytes_out)
    cache_hits: int = 0
    cache_misses: int = 0
    # container bytes whose read was fully hidden behind decode work
    prefetch_bytes: int = 0
    # physical payload reads issued (preads / ranged GETs)
    requests: int = 0

    @property
    def read_amplification(self) -> float:
        """Container bytes read per byte served (< 1 once cache-warm)."""
        return self.bytes_read / max(1, self.bytes_out)


@dataclasses.dataclass
class StoreStats:
    """Store-lifetime aggregate: the sum of every committed IngestReport
    and RestoreReport plus offline model-fit time.

    The lifecycle fields are maintained by reclamation, not by
    ``absorb``: ``live_bytes`` / ``dead_bytes`` mirror the refcount table
    after every commit / delete / collect (``dead_bytes`` counts all a
    compaction can drop: unreferenced records plus records pinned only as
    delta bases, which rebasing frees); ``reclaimed_bytes`` sums the
    measured container shrink across compactions; ``chain_depth_hist`` is
    the live delta-chain depth histogram from the last ``collect()``."""

    bytes_in: int = 0
    bytes_stored: int = 0
    chunks: int = 0
    dup_chunks: int = 0
    delta_chunks: int = 0
    raw_chunks: int = 0
    detect_seconds: float = 0.0
    chunk_seconds: float = 0.0
    delta_seconds: float = 0.0
    extract_seconds: float = 0.0
    score_seconds: float = 0.0
    observe_seconds: float = 0.0
    store_seconds: float = 0.0
    fit_seconds: float = 0.0
    live_bytes: int = 0
    dead_bytes: int = 0
    reclaimed_bytes: int = 0
    chain_depth_hist: dict[int, int] = dataclasses.field(default_factory=dict)
    # restore telemetry: the running sum of every absorbed RestoreReport
    restores: int = 0
    restore_bytes_out: int = 0
    restore_bytes_read: int = 0
    restore_seconds: float = 0.0
    restore_read_seconds: float = 0.0
    restore_decode_seconds: float = 0.0
    restore_cache_hits: int = 0
    restore_cache_misses: int = 0
    restore_prefetch_bytes: int = 0
    restore_requests: int = 0

    @property
    def dcr(self) -> float:
        return self.bytes_in / max(1, self.bytes_stored)

    def absorb(self, report: IngestReport) -> None:
        for f in ("bytes_in", "bytes_stored", "chunks", "dup_chunks",
                  "delta_chunks", "raw_chunks", "detect_seconds",
                  "chunk_seconds", "delta_seconds", "extract_seconds",
                  "score_seconds", "observe_seconds", "store_seconds"):
            setattr(self, f, getattr(self, f) + getattr(report, f))

    def absorb_restore(self, report: RestoreReport) -> None:
        self.restores += 1
        self.restore_bytes_out += report.bytes_out
        self.restore_bytes_read += report.bytes_read
        self.restore_seconds += report.seconds
        self.restore_read_seconds += report.read_seconds
        self.restore_decode_seconds += report.decode_seconds
        self.restore_cache_hits += report.cache_hits
        self.restore_cache_misses += report.cache_misses
        self.restore_prefetch_bytes += report.prefetch_bytes
        self.restore_requests += report.requests

"""Value types of the detection & store API (port of ``repro.api.types``;
only the fields this port fills).

  DetectBatch    one stream's worth of chunks handed to a detector;
  DetectResult   per-chunk resemblance verdict (base chunk id, score);
  IngestReport   immutable per-stream accounting returned by
                 ``StreamSession.commit()``;
  StoreStats     the store-lifetime aggregate (sum of every IngestReport
                 plus offline fit time).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

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


@dataclasses.dataclass
class StoreStats:
    """Store-lifetime aggregate: the sum of every committed IngestReport
    plus offline model-fit time."""

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

    @property
    def dcr(self) -> float:
        return self.bytes_in / max(1, self.bytes_stored)

    def absorb(self, report: IngestReport) -> None:
        for f in ("bytes_in", "bytes_stored", "chunks", "dup_chunks",
                  "delta_chunks", "raw_chunks", "detect_seconds",
                  "chunk_seconds", "delta_seconds", "extract_seconds",
                  "score_seconds", "observe_seconds", "store_seconds"):
            setattr(self, f, getattr(self, f) + getattr(report, f))

"""Session-oriented dedup + delta-compression store (port of
``repro.api.store``: the ingest and restore path, without locks,
deadlines, observability, lifecycle or the file/objectstore backends).

    session = store.open_stream()
    session.write(part1); session.write(part2)   # stage bytes
    report = session.commit()                    # chunk/detect/store
    store.restore(report.handle)                 # byte-identical

Commit runs the reference's passes: 0 chunk (kernel A scan + host
boundary walk); 1 exact dedup by blake2b and id assignment; 2 extract,
score (kernels B and C); 3a delta-vs-raw decisions over a worklist;
3b one group write plus the recipe; then the detector observes the
stream. ``DedupStore`` runs on the CUDA device unless given
``device="cpu"``.
"""
from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.api import containers
from repro_torch.api.detect import is_staged
from repro_torch.api.types import DetectBatch, IngestReport, StoreStats
from repro_torch.core import chunking, delta
from repro_torch.kernels import ingest, ops


def chunk_with(cfg: chunking.ChunkerConfig, stream: bytes,
               device: torch.device | str):
    """FastCDC through the device scan: bytes go up, candidate words come
    back, and the returned stream hashes are a device-resident
    ``StreamScan`` the detector reads without a round-trip."""
    buf = np.frombuffer(stream, dtype=np.uint8)
    n = len(buf)
    if n == 0:
        return [], None
    scan, cand_s, cand_l = ingest.scan_stream(buf, cfg.mask_s, cfg.mask_l, device)
    bounds = chunking.select_boundaries(n, cand_s, cand_l, cfg)
    return chunking.chunks_from_bounds(stream, bounds), scan


class StreamSession:
    """Write-then-commit handle for ingesting one stream."""

    def __init__(self, store: "DedupStore") -> None:
        self._store = store
        self._parts: list[bytes] = []
        self._closed = False
        self.report: IngestReport | None = None

    def write(self, data: bytes) -> None:
        if self._closed:
            raise RuntimeError("stream session already committed/aborted")
        self._parts.append(bytes(data))

    def commit(self) -> IngestReport:
        if self._closed:
            raise RuntimeError("stream session already committed/aborted")
        self._closed = True
        self.report = self._store._commit_stream(b"".join(self._parts))
        return self.report

    def abort(self) -> None:
        self._closed = True
        self._parts.clear()

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._closed:
            if exc_type is None:
                self.commit()
            else:
                self.abort()


class DedupStore:
    """Container store with exact dedup + detector-driven delta compression."""

    def __init__(self, detector: Any,
                 chunker_cfg: chunking.ChunkerConfig | None = None,
                 backend: containers.InMemoryBackend | None = None,
                 device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)
        det_device = getattr(detector, "device", None)
        if det_device is not None and torch.device(det_device) != self.device:
            raise ValueError(f"detector runs on {det_device}, store on {self.device}")
        self.detector = detector
        self.cfg = chunker_cfg or chunking.ChunkerConfig()
        self.backend = backend if backend is not None else containers.InMemoryBackend()
        self.stats = StoreStats()
        self.reports: list[IngestReport] = []
        self._by_digest: dict[bytes, int] = {}
        self._next_id = 0

    def _clock(self) -> float:
        # stage timings end on the device: wait for queued kernels first
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def fit(self, training_streams: Sequence[bytes]) -> None:
        t0 = self._clock()
        self.detector.fit(training_streams, self.cfg)
        self.stats.fit_seconds += self._clock() - t0

    def open_stream(self) -> StreamSession:
        return StreamSession(self)

    def ingest(self, stream: bytes) -> StoreStats:
        """One-shot session commit; returns the aggregate."""
        session = self.open_stream()
        session.write(stream)
        session.commit()
        return self.stats

    def _commit_stream(self, stream: bytes) -> IngestReport:
        # pass 0: chunk
        t0 = self._clock()
        chunks, stream_hashes = chunk_with(self.cfg, stream, self.device)
        chunk_seconds = self._clock() - t0

        # pass 1: exact dedup; assign ids
        n = len(chunks)
        ids = np.empty(n, np.int64)
        is_new = np.zeros(n, bool)
        digests = [ck.digest for ck in chunks]
        seen_in_stream: dict[bytes, int] = {}
        for i, dig in enumerate(digests):
            ref = self._by_digest.get(dig)
            if ref is None:
                ref = seen_in_stream.get(dig)
            if ref is not None:
                ids[i] = ref
            else:
                ids[i] = self._next_id
                self._next_id += 1
                is_new[i] = True
                seen_in_stream[dig] = int(ids[i])

        # pass 2: resemblance detection; a staged detector's index
        # admission (observe) waits until the backend writes succeed, a
        # legacy single-call detector mutates inside detect()
        extract_seconds = score_seconds = observe_seconds = 0.0
        batch = DetectBatch(chunks=chunks, ids=ids, is_new=is_new,
                            stream_hashes=stream_hashes)
        staged = n > 0 and is_staged(self.detector)
        feats = None
        if n == 0:
            base_ids = np.empty(0, np.int64)
        elif staged:
            t0 = self._clock()
            feats = self.detector.extract(batch)
            extract_seconds = self._clock() - t0
            t0 = self._clock()
            base_ids = self.detector.score(feats, batch).base_ids
            score_seconds = self._clock() - t0
        else:
            t0 = self._clock()
            base_ids = np.asarray(
                self.detector.detect(chunks, ids, is_new, stream_hashes), np.int64)
            score_seconds = self._clock() - t0

        # pass 3a: delta-vs-raw decisions over a worklist; a same-stream
        # base that is not stored yet resolves from the staged records
        backend = self.backend
        bytes_in = sum(ck.length for ck in chunks)
        bytes_stored = 0
        dup_chunks = int(n - is_new.sum())
        delta_chunks = raw_chunks = 0
        delta_seconds = 0.0
        staged_data: dict[int, bytes] = {}
        records: list[tuple[int, int, bytes, bytes | None]] = []
        for i in np.flatnonzero(is_new):
            ck = chunks[i]
            cid = int(ids[i])
            entry = None
            base = int(base_ids[i])
            if base >= 0:
                base_data = staged_data.get(base)
                if base_data is None and backend.contains(base):
                    base_data = backend.get(base)
                if base_data is not None:
                    t0 = time.perf_counter()
                    d = delta.encode(ck.data, base_data)
                    delta_seconds += time.perf_counter() - t0
                    if len(d) < ck.length:
                        entry = (cid, base, d, ck.data)
                        bytes_stored += len(d)
                        delta_chunks += 1
            if entry is None:
                entry = (cid, -1, ck.data, None)
                bytes_stored += ck.length
                raw_chunks += 1
            records.append(entry)
            staged_data[cid] = ck.data

        # pass 3b: one batched backend write + recipe + flush; digests are
        # registered only after the writes succeed
        t0 = time.perf_counter()
        backend.put_many(records)
        for i, (cid, _base, _payload, _data) in zip(np.flatnonzero(is_new), records):
            self._by_digest[digests[i]] = cid
        handle = backend.add_recipe(ids)
        backend.flush()
        store_seconds = time.perf_counter() - t0

        if staged:
            t0 = self._clock()
            self.detector.observe(feats, batch)
            observe_seconds = self._clock() - t0

        report = IngestReport(
            handle=handle, bytes_in=bytes_in, bytes_stored=bytes_stored,
            chunks=n, dup_chunks=dup_chunks, delta_chunks=delta_chunks,
            raw_chunks=raw_chunks,
            detect_seconds=extract_seconds + score_seconds + observe_seconds,
            chunk_seconds=chunk_seconds, delta_seconds=delta_seconds,
            extract_seconds=extract_seconds, score_seconds=score_seconds,
            observe_seconds=observe_seconds, store_seconds=store_seconds)
        self.reports.append(report)
        self.stats.absorb(report)
        return report

    def restore(self, handle: int) -> bytes:
        """Reconstruct a committed stream byte for byte by its handle;
        each distinct chunk is materialised once."""
        recipe = self.backend.recipe(handle)
        uniq = list(dict.fromkeys(recipe))
        data = dict(zip(uniq, self.backend.get_many(uniq)))
        return b"".join(data[cid] for cid in recipe)

"""Record checksums, typed corruption errors and the scrub walk (port of
``repro.api.integrity``).

    crc32c()            the record checksum (Castagnoli CRC-32C);
                        ``google_crc32c`` when it imports, else the
                        pure-Python table, exactly as the reference
                        chooses, so the format never depends on an
                        optional wheel
    CorruptChunkError   a verified read found payload bytes that do not
                        match the stored checksum
    CorruptJournalError a malformed record in the *middle* of a recipe
                        journal (a torn tail is truncated; this is not)
    ScrubReport         what one fsck walk found (and, in repair mode,
                        did): per-chunk verdicts, transitive blast
                        radius, structural-consistency findings
    scrub(store)        the walk itself: ``DedupStore.scrub`` delegates
                        here under its exclusive lifecycle lock
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

try:                                # hardware CRC32C when the wheel exists
    from google_crc32c import value as _crc32c_native
except ImportError:                 # pragma: no cover - env-dependent
    _crc32c_native = None

_CRC32C_POLY = 0x82F63B78           # Castagnoli, reflected
_CRC32C_TABLE: list[int] | None = None


def _crc32c_table() -> list[int]:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
            table.append(crc)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def _crc32c_py(data: bytes) -> int:
    """Pure-Python CRC-32C, byte at a time: kept for correctness (and
    machines without ``google_crc32c``), not speed."""
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c_route() -> str:
    """Which implementation ``crc32c`` takes here: "native" or "python"."""
    return "python" if _crc32c_native is None else "native"


# calls, bytes and seconds spent in crc32c since the last reset: what the
# checksums cost a run on a machine without the native wheel
CRC32C_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_STATS_LOCK = threading.Lock()


def reset_crc32c_stats() -> None:
    with _STATS_LOCK:
        CRC32C_STATS.update(calls=0, bytes=0, seconds=0.0)


def crc32c(data: bytes | bytearray | memoryview) -> int:
    """CRC-32C (Castagnoli) of ``data`` as an unsigned 32-bit int: the
    checksum persisted in FileBackend record headers and
    ObjectStoreBackend journal rows."""
    t0 = time.perf_counter()
    if _crc32c_native is not None:
        crc = int(_crc32c_native(bytes(data)))
    else:
        crc = _crc32c_py(bytes(data))
    seconds = time.perf_counter() - t0
    with _STATS_LOCK:
        CRC32C_STATS["calls"] += 1
        CRC32C_STATS["bytes"] += len(data)
        CRC32C_STATS["seconds"] += seconds
    return crc


class CorruptChunkError(IOError):
    """A payload failed its checksum on a verified read. An ``IOError``,
    like the read engine's truncated-record error, with the forensics on
    it (cid, container, expected and actual crc)."""

    def __init__(self, cid: int, container: str,
                 expected: int, actual: int) -> None:
        super().__init__(
            f"corrupt chunk {cid}: payload crc32c {actual:#010x} != "
            f"stored {expected:#010x} ({container})")
        self.cid = int(cid)
        self.container = container
        self.expected = int(expected)
        self.actual = int(actual)


class CorruptJournalError(ValueError):
    """A recipe journal holds a malformed record *before* its final line.
    A torn tail (crash mid-append) is truncated on open; damage in the
    middle of the file is corruption, and dropping everything after it
    would lose committed streams, so the open fails instead."""

    def __init__(self, path: str, line_no: int, detail: str) -> None:
        super().__init__(f"corrupt journal {path}: line {line_no}: {detail}")
        self.path = str(path)
        self.line_no = int(line_no)
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class ScrubReport:
    """What one fsck walk over the store found (DESIGN.md §13.3).

    ``corrupt`` holds chunks whose stored payload failed its checksum or
    could not be read at all; ``lost`` additionally closes over delta
    dependents (a patch whose base — at any depth — is corrupt can never
    decode, even though its own bytes are fine). ``missing`` are chunks
    a live recipe names but the backend no longer holds.
    ``blast_radius`` maps each corrupt chunk to the number of live
    streams transitively unrestorable because of it — the §13
    amplification number. ``unverifiable`` counts records that predate
    checksums (pre-RCL2 logs, pre-checksum journal rows): intact as far
    as anyone can tell, but unprovable.

    In repair mode ``quarantined``/``retired_streams`` record what was
    durably dropped: corrupt+lost chunks via the backend's quarantine
    journal entries, affected streams via the recovery-retire tombstone
    machinery — after which a fresh scrub of the store is clean.

    ``payload_requests`` counts the backend payload requests the walk
    actually issued; ``payload_requests_naive`` is what a per-chunk walk
    would have issued (one GET per indexed chunk). Backends exposing
    ``scrub_stream`` (the object store, §14.5) serve one streamed GET
    per container object, so the gap between the two is the scrub's
    request savings."""

    chunks: int
    bytes_checked: int
    verified: int
    unverifiable: int
    corrupt: tuple[int, ...]
    lost: tuple[int, ...]
    missing: tuple[int, ...]
    streams: int
    streams_lost: tuple[int, ...]
    blast_radius: dict[int, int]
    structural_errors: tuple[str, ...]
    repaired: bool
    quarantined: tuple[int, ...]
    retired_streams: tuple[int, ...]
    seconds: float
    payload_requests: int = 0
    payload_requests_naive: int = 0

    @property
    def clean(self) -> bool:
        """No corruption, nothing lost or missing, structure consistent."""
        return not (self.corrupt or self.lost or self.missing
                    or self.streams_lost or self.structural_errors)


def _record_source(backend: Any, cids: list[int]) -> Any:
    """Per-chunk payload source for backends without ``scrub_stream``:
    yields ``(cid, payload | None, note)`` straight off the containers
    via ``backend.record`` — a ``None`` payload is unreadable-or-corrupt,
    a non-None ``note`` additionally flags a structural finding."""
    for cid in cids:
        try:
            _, _, payload = backend.record(cid)
        except CorruptChunkError:
            # a verify_reads backend checked for us; trust its verdict
            yield cid, None, None
        except (OSError, KeyError, IndexError) as e:
            yield cid, None, f"unreadable ({e})"
        else:
            yield cid, payload, None


def _dependents_closure(seeds: set[int], base_of: dict[int, int]) -> set[int]:
    """``seeds`` plus every chunk whose base chain passes through one."""
    out = set(seeds)
    changed = True
    while changed:
        changed = False
        for cid, base in base_of.items():
            if base in out and cid not in out:
                out.add(cid)
                changed = True
    return out


def scrub(store: Any, repair: bool = False) -> ScrubReport:
    """Verify every stored record, recipe reachability and refcount
    consistency; optionally quarantine what is damaged (§13.3).

    Runs under the store's exclusive lifecycle lock (the caller —
    ``DedupStore.scrub`` — takes it), so no reads or commits are in
    flight while records are walked or, in repair mode, while recipes
    are retired and chunks quarantined.

    The walk reads every indexed payload straight off the containers —
    never the decode cache or disk tier — preferring the backend's
    ``scrub_stream`` (one streamed GET per container object, §14.5) over
    per-chunk ``backend.record`` calls, and checks each payload
    against the persisted checksum (``backend.checksum_of``). Records
    without one (pre-checksum formats) count as ``unverifiable``.
    Structural checks: every delta base resolves (no dangling chains, no
    cycles), every live recipe's chunks exist, and a refcount table
    rebuilt from durable state matches the store's in-memory one.

    Repair quarantines ``corrupt + lost`` chunks through the backend's
    durable quarantine journal entries and retires every affected live
    stream through the same durable tombstone machinery crash recovery
    uses, then rebinds the store's derived views (refcounts, digest
    table, layouts). Untouched streams survive byte-identical; a
    follow-up scrub reports clean."""
    t0 = time.perf_counter()
    backend = store.backend
    backend.flush()
    checksum_of = getattr(backend, "checksum_of", None)

    cids = sorted(backend.chunk_ids())
    base_of: dict[int, int] = {cid: backend.base_of(cid) for cid in cids}
    corrupt: list[int] = []
    structural: list[str] = []
    verified = unverifiable = 0
    bytes_checked = 0

    # payload source: backends that can stream one GET per container
    # object (scrub_stream, §14.5) beat the naive one-request-per-chunk
    # walk by the dedup factor; everything downstream is order-independent
    # so the stream may yield in container order, not cid order.
    payload_requests_naive = len(cids)
    stream_fn = getattr(backend, "scrub_stream", None)
    if stream_fn is not None:
        payload_requests, stream = stream_fn()
        source = ((cid, payload,
                   None if payload is not None
                   else "unreadable (missing or short container object)")
                  for cid, payload in stream)
    else:
        payload_requests = payload_requests_naive
        source = _record_source(backend, cids)

    walked: set[int] = set()
    for cid, payload, note in source:
        walked.add(cid)
        if payload is None:
            corrupt.append(cid)
            if note is not None:
                structural.append(f"chunk {cid}: {note}")
            continue
        bytes_checked += len(payload)
        expected = checksum_of(cid) if checksum_of is not None else None
        if expected is None:
            unverifiable += 1
        elif crc32c(payload) != expected:
            corrupt.append(cid)
        else:
            verified += 1
    for cid in cids:                # indexed but never yielded: unreadable
        if cid not in walked:
            corrupt.append(cid)
            structural.append(f"chunk {cid}: unreadable (not in scrub walk)")
    corrupt.sort()

    # structural: dangling bases and base-chain cycles
    held = set(cids)
    dangling: set[int] = set()
    for cid, base in base_of.items():
        if base >= 0 and base not in held:
            dangling.add(cid)
            structural.append(f"chunk {cid}: dangling base {base}")
    depth_ok: set[int] = set()
    for cid in cids:
        seen: list[int] = []
        cur = cid
        while cur >= 0 and cur not in depth_ok:
            if cur in seen:
                structural.append(f"chunk {cid}: base-chain cycle at {cur}")
                dangling.add(cid)
                break
            seen.append(cur)
            cur = base_of.get(cur, -1)
        else:
            depth_ok.update(seen)

    # blast radius: corrupt/unreadable chunks plus every transitive
    # delta dependent (a fine patch on a rotten base cannot decode)
    lost = _dependents_closure(set(corrupt) | dangling, base_of)

    live = backend.live_handles()
    missing: set[int] = set()
    streams_lost: list[int] = []
    recipes: dict[int, list[int]] = {}
    for h in live:
        recipe = backend.recipe(h)
        recipes[h] = recipe
        absent = [c for c in recipe if c not in held]
        missing.update(absent)
        if absent or any(c in lost for c in recipe):
            streams_lost.append(h)

    blast: dict[int, int] = {}
    for cid in corrupt:
        reach = _dependents_closure({cid}, base_of)
        blast[cid] = sum(1 for h in live
                         if any(c in reach for c in recipes[h]))

    # refcount consistency: the in-memory table must match one rederived
    # from durable state (drift means deletes/compactions went unrecorded)
    from repro_torch.api.refcount import RefcountTable
    refs = getattr(store, "_refs", None)
    if refs is not None:
        fresh = RefcountTable.rebuild(backend)
        pairs = (("chunks", len(fresh), len(refs)),
                 ("live_bytes", fresh.live_bytes, refs.live_bytes),
                 ("pinned_bytes", fresh.pinned_bytes, refs.pinned_bytes),
                 ("dead_bytes", fresh.dead_bytes, refs.dead_bytes))
        for name, want, got in pairs:
            if want != got:
                structural.append(f"refcount drift: {name} durable={want} "
                                  f"in-memory={got}")

    quarantined: list[int] = []
    retired: list[int] = []
    if repair and (lost or missing or streams_lost):
        for h in streams_lost:
            backend.retire_recipe(h)    # durable tombstone (§10.6/§11.4)
            retired.append(h)
            getattr(store, "_layouts", {}).pop(h, None)
        drop = sorted(c for c in lost if c in held)
        drop_chunks = getattr(backend, "drop_chunks", None)
        if drop_chunks is not None:
            drop_chunks(drop)           # durable quarantine entries
            quarantined.extend(drop)
        else:                           # third-party backend: tombstones
            structural.append(          # alone still silence the streams
                "backend has no drop_chunks; corrupt records retired but "
                "not quarantined")
        backend.flush()
        from repro_torch.api.lifecycle import rebind_store_views
        rebind_store_views(store)

    seconds = time.perf_counter() - t0
    report = ScrubReport(
        chunks=len(cids), bytes_checked=bytes_checked, verified=verified,
        unverifiable=unverifiable, corrupt=tuple(corrupt),
        lost=tuple(sorted(lost)), missing=tuple(sorted(missing)),
        streams=len(live), streams_lost=tuple(streams_lost),
        blast_radius=blast, structural_errors=tuple(structural),
        repaired=bool(repair and (quarantined or retired)),
        quarantined=tuple(quarantined), retired_streams=tuple(retired),
        seconds=seconds, payload_requests=payload_requests,
        payload_requests_naive=payload_requests_naive)
    _observe_scrub(store, report)
    return report


def _observe_scrub(store: Any, report: ScrubReport) -> None:
    """Record the walk into the store's registry / tracer: duration,
    chunks by checksum outcome, quarantine totals. Tolerates stores
    without an Observability (test doubles)."""
    obs = getattr(store, "observe", None)
    if obs is None:
        return
    from repro_torch.api import observe as om
    m = obs.metrics
    m.histogram("repro_scrub_seconds", "Scrub walk duration (§13.3)",
                bounds=om.SECONDS_BUCKETS).observe(report.seconds)
    for outcome, n in (("verified", report.verified),
                       ("unverifiable", report.unverifiable),
                       ("corrupt", len(report.corrupt))):
        m.counter("repro_scrub_chunks_total",
                  "Scrubbed chunks by checksum outcome (§13.3)",
                  labels={"outcome": outcome}).inc(n)
    if report.repaired:
        m.counter("repro_scrub_quarantined_total",
                  "Chunks durably quarantined by scrub repair").inc(
                      len(report.quarantined))
        m.counter("repro_scrub_retired_streams_total",
                  "Streams retired by scrub repair").inc(
                      len(report.retired_streams))
    tr = obs.tracer
    if tr is not None:
        tr.record("scrub", report.seconds, chunks=report.chunks,
                  payload_requests=report.payload_requests,
                  verified=report.verified,
                  unverifiable=report.unverifiable,
                  corrupt=len(report.corrupt), lost=len(report.lost),
                  streams_lost=len(report.streams_lost),
                  repaired=report.repaired)

"""Record checksums and typed corruption errors (port of
``repro.api.integrity``; the scrub walk and ``ScrubReport`` are not
ported yet).

    crc32c()            the record checksum (Castagnoli CRC-32C);
                        ``google_crc32c`` when it imports, else the
                        pure-Python table, exactly as the reference
                        chooses, so the format never depends on an
                        optional wheel
    CorruptChunkError   a verified read found payload bytes that do not
                        match the stored checksum
    CorruptJournalError a malformed record in the *middle* of a recipe
                        journal (a torn tail is truncated; this is not)
"""
from __future__ import annotations

import threading
import time

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

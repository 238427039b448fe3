"""Synthetic versioned-backup workloads reproducing the paper's datasets.

The paper evaluates on (1) a SQL-dump backup series, (2) VMDK image backups,
(3) Linux-kernel source trees. Those traces aren't shipped, so we generate
version chains with the *edit statistics* each one exhibits:

  * sql_dump: record-structured text; each version appends rows and applies
    localized in-place edits to a small fraction of rows (backup-with-growth
    pattern — mostly appends, light churn).
  * vmdk: block-structured binary; each version rewrites randomly scattered
    blocks (random-modification pattern the paper calls out in §5.2).
  * kernel: many small structured files; each version inserts/deletes lines
    in a subset of files (shift-heavy pattern — the case that breaks
    content-only features, paper §3).

All generators are deterministic in `seed`. A copy of
``repro.data.workloads``: the same seeds give the same bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    base_size: int = 4 << 20   # bytes per version (approx)
    versions: int = 6
    seed: int = 1234


def _record(rng: np.random.Generator, width: int = 96) -> bytes:
    """One structured text 'row' (CSV-ish, compressible like a SQL dump)."""
    rid = rng.integers(0, 10**9)
    name = bytes(rng.integers(97, 123, size=12, dtype=np.uint8))
    blob = bytes(rng.integers(32, 127, size=width, dtype=np.uint8))
    return b"INSERT INTO t VALUES (%d,'%s','%s');\n" % (rid, name, blob)


def sql_dump_versions(cfg: WorkloadConfig = WorkloadConfig()) -> list[bytes]:
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    rows = []
    size = 0
    while size < cfg.base_size:
        r = _record(rng)
        rows.append(r)
        size += len(r)
    versions = []
    for _ in range(cfg.versions):
        versions.append(b"".join(rows))
        # churn: modify ~0.5% of rows in place, append ~2% new rows
        n = len(rows)
        for idx in rng.integers(0, n, size=max(1, n // 200)):
            rows[int(idx)] = _record(rng)
        for _ in range(max(1, n // 50)):
            rows.append(_record(rng))
    return versions


def vmdk_versions(cfg: WorkloadConfig = WorkloadConfig()) -> list[bytes]:
    rng = np.random.Generator(np.random.PCG64(cfg.seed + 1))
    block = 4096
    nblocks = cfg.base_size // block
    # half the image is low-entropy (zeros / repeated fs metadata), half random
    img = np.zeros((nblocks, block), dtype=np.uint8)
    data_blocks = rng.permutation(nblocks)[: nblocks // 2]
    img[data_blocks] = rng.integers(0, 256, size=(len(data_blocks), block), dtype=np.uint8)
    versions = []
    for _ in range(cfg.versions):
        versions.append(img.tobytes())
        # rewrite ~1% of blocks at random positions (random edit pattern)
        touch = rng.permutation(nblocks)[: max(1, nblocks // 100)]
        img = img.copy()
        img[touch] = rng.integers(0, 256, size=(len(touch), block), dtype=np.uint8)
    return versions


def _source_file(rng: np.random.Generator, lines: int) -> list[bytes]:
    out = []
    for _ in range(lines):
        indent = b" " * int(rng.integers(0, 12))
        body = bytes(rng.integers(97, 123, size=int(rng.integers(8, 60)), dtype=np.uint8))
        out.append(indent + body + b"();\n")
    return out


def kernel_versions(cfg: WorkloadConfig = WorkloadConfig()) -> list[bytes]:
    """Tar-like concatenation of many small files; line insert/delete churn.

    Line edits SHIFT all following bytes — the modification pattern that
    breaks content-only sub-chunk features (paper §3, Chunk_H case).
    """
    rng = np.random.Generator(np.random.PCG64(cfg.seed + 2))
    nfiles = max(8, cfg.base_size // (16 << 10))
    files = [_source_file(rng, int(rng.integers(100, 500))) for _ in range(nfiles)]
    versions = []
    for _ in range(cfg.versions):
        stream = bytearray()
        for i, f in enumerate(files):
            stream += b"==== file %d ====\n" % i
            for line in f:
                stream += line
        versions.append(bytes(stream))
        # edit ~10% of files: insert/delete/modify a few lines each
        for idx in rng.permutation(nfiles)[: max(1, nfiles // 10)]:
            f = files[int(idx)]
            for _ in range(int(rng.integers(1, 6))):
                op = rng.integers(0, 3)
                pos = int(rng.integers(0, max(1, len(f))))
                if op == 0 and f:            # delete
                    del f[pos % len(f)]
                elif op == 1:                 # insert
                    f.insert(pos, _source_file(rng, 1)[0])
                elif f:                       # modify
                    f[pos % len(f)] = _source_file(rng, 1)[0]
    return versions


_GENERATORS = {
    "sql_dump": sql_dump_versions,
    "vmdk": vmdk_versions,
    "kernel": kernel_versions,
}


def make_workload(name: str, cfg: WorkloadConfig | None = None) -> list[bytes]:
    if name not in _GENERATORS:
        raise KeyError(f"unknown workload {name!r}; options: {sorted(_GENERATORS)}")
    return _GENERATORS[name](cfg or WorkloadConfig())

"""In-memory container backend (port of ``repro.api.containers.InMemoryBackend``).

Records are ``(kind, base, payload)``: a raw chunk keeps its bytes, a
delta chunk keeps its base id and COPY/ADD patch. ``get`` rebuilds a
chunk by walking its delta chain down to a raw record and decoding back
up, so a restore exercises every stored patch.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.api.registry import register_backend
from repro_torch.core import delta

KIND_RAW = 0
KIND_DELTA = 1


@register_backend("memory")
class InMemoryBackend:
    """Chunk records and stream recipes in dicts."""

    def __init__(self) -> None:
        self._records: dict[int, tuple[int, int, bytes]] = {}
        self._recipes: list[list[int]] = []

    def put_many(self, records: Sequence[tuple[int, int, bytes, bytes | None]]) -> None:
        """Store ``(cid, base, payload, data)`` records; ``base < 0`` is raw."""
        for cid, base, payload, _data in records:
            if base < 0:
                self._records[cid] = (KIND_RAW, -1, payload)
            else:
                if base not in self._records:
                    raise KeyError(f"delta base {base} of chunk {cid} is not stored")
                self._records[cid] = (KIND_DELTA, base, payload)

    def get(self, cid: int) -> bytes:
        """Materialise a chunk: walk its chain to a raw record, decode up."""
        chain = []
        kind, base, payload = self._records[cid]
        while kind == KIND_DELTA:
            chain.append(payload)
            kind, base, payload = self._records[base]
        data = payload
        for patch in reversed(chain):
            data = delta.decode(patch, data)
        return data

    def get_many(self, cids: Sequence[int]) -> list[bytes]:
        return [self.get(c) for c in cids]

    def contains(self, cid: int) -> bool:
        return cid in self._records

    def chunk_ids(self) -> list[int]:
        return list(self._records)

    def record(self, cid: int) -> tuple[int, int, bytes]:
        return self._records[cid]

    def add_recipe(self, chunk_ids: Sequence[int]) -> int:
        self._recipes.append([int(c) for c in chunk_ids])
        return len(self._recipes) - 1

    def recipe(self, handle: int) -> list[int]:
        if not 0 <= handle < len(self._recipes):
            raise IndexError(f"unknown stream handle {handle}")
        return self._recipes[handle]

    def flush(self) -> None:
        pass

"""CARD-deduplicated delta-compressed checkpoint store (port of
``repro.checkpoint.dedup_store``).

Successive checkpoints of a training run are the versioned backup stream
the paper targets: step N+1's parameters are byte-similar to step N's.
Each checkpoint is serialised to the byte layout of ``checkpoint/store``
(optionally regrouped into byte planes), chunked with FastCDC,
exact-deduped and delta-compressed against CARD-detected bases by the
port's ``DedupStore``: on the card its ingest launches kernels A, B and
C. The stream, the handles and the DCR are the reference's for the same
tree; restore is value-exact (digest-checked).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api.containers import ContainerBackend
from repro_torch.api.store import DedupStore
from repro_torch.api.types import StoreStats
from repro_torch.checkpoint import store as base_store
from repro_torch.core import chunking, context_model, features, pipeline
from repro_torch.kernels import ops


def _default_detector(device: torch.device) -> pipeline.CARDDetector:
    """The reference's widths: k 32, m 64, n 2; d 50, 120 fit steps."""
    return pipeline.CARDDetector(
        feat_cfg=features.FeatureConfig(k=32, m=64, n=2),
        model_cfg=context_model.ContextModelConfig(m=64, d=50, steps=120),
        device=device)


def _byte_planes(raw: bytes, itemsize: int) -> bytes:
    """[v0b0 v0b1 ...] -> [all b_(n-1) planes ... all b0].

    Between adjacent training steps the sign / exponent / high-mantissa
    bytes of most parameters are unchanged while the low mantissa bytes
    are noise; grouping planes turns "every 4th byte differs" into long
    identical runs and a small noisy region. Little-endian, so the
    high-order byte is the last of each item."""
    if itemsize <= 1 or len(raw) % itemsize:
        return raw
    a = np.frombuffer(raw, np.uint8).reshape(-1, itemsize)
    return np.ascontiguousarray(a.T[::-1]).tobytes()


def _unbyte_planes(raw: bytes, itemsize: int) -> bytes:
    if itemsize <= 1 or len(raw) % itemsize:
        return raw
    a = np.frombuffer(raw, np.uint8).reshape(itemsize, -1)[::-1]
    return np.ascontiguousarray(a.T).tobytes()


def _itemsizes(manifest: dict) -> dict[str, int]:
    return {m["id"]: np.dtype(m["store_dtype"]).itemsize for m in manifest["leaves"]}


class DedupCheckpointStore:
    """Checkpoints of a tree of tensors, one deduplicated stream a step.
    Runs on the CUDA device unless given ``device="cpu"``; the first
    ``save`` fits the detector on its own stream."""

    def __init__(self, detector: Optional[Any] = None,
                 chunker_cfg: Optional[chunking.ChunkerConfig] = None,
                 byte_plane: bool = True,
                 backend: Optional[ContainerBackend] = None,
                 device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)
        self._store = DedupStore(
            detector or _default_detector(self.device),
            chunker_cfg or chunking.ChunkerConfig(avg_size=16 * 1024),
            backend=backend, device=self.device)
        self._steps: dict[int, tuple[int, dict]] = {}  # step -> (handle, manifest)
        self._fitted = False
        self._byte_plane = byte_plane

    def _to_stream(self, tree: Any) -> tuple[bytes, dict]:
        blobs, manifest = base_store.serialize(tree)
        sizes = _itemsizes(manifest)
        offsets = {}
        out = bytearray()
        for leaf_id, raw in blobs:
            if self._byte_plane:
                raw = _byte_planes(raw, sizes[leaf_id])
            offsets[leaf_id] = [len(out), len(raw)]
            out.extend(raw)
        manifest["offsets"] = offsets
        return bytes(out), manifest

    def save(self, tree: Any, step: int) -> StoreStats:
        stream, manifest = self._to_stream(tree)
        if not self._fitted:
            self._store.fit([stream])
            self._fitted = True
        session = self._store.open_stream()
        session.write(stream)
        report = session.commit()
        self._steps[step] = (report.handle, manifest)
        return self.stats

    def restore(self, like: Any, step: int) -> Any:
        """The tree saved at ``step``, in ``like``'s structure, each leaf
        on the device and in the dtype of ``like``'s."""
        handle, manifest = self._steps[step]
        stream = self._store.restore(handle)
        sizes = _itemsizes(manifest)
        blobs = {}
        for lid, (off, ln) in manifest["offsets"].items():
            raw = stream[off:off + ln]
            if self._byte_plane:
                raw = _unbyte_planes(raw, sizes[lid])
            blobs[lid] = raw
        return base_store.deserialize(blobs, manifest, like)

    @property
    def stats(self) -> StoreStats:
        return self._store.stats

    @property
    def steps(self) -> list[int]:
        return sorted(self._steps)

"""Staged detector protocol (port of ``repro.api.detect``).

    extract(batch)            -> features     pure; the heavy batched work
    score(features, batch)    -> DetectResult pure; no index mutation
    observe(features, batch)  -> None         the ONE mutating step

``score`` must behave as if every chunk of the batch were scored against
the index state at batch entry plus earlier chunks of the *same* batch
(what the v0 interleaved query/insert loop produced) without touching
the shared index, so an aborted stream admits nothing.

``run_detect`` drives either shape (staged detectors, or legacy ones that
only implement ``detect``), and ``LegacyDetectMixin`` gives staged
detectors the v0 ``detect`` method, bit-identical to the staged run.
"""
from __future__ import annotations

from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.api.types import DetectBatch, DetectResult


@runtime_checkable
class StagedDetector(Protocol):
    name: str

    def fit(self, training_streams: Sequence[bytes], cfg: Any) -> None: ...

    def extract(self, batch: DetectBatch) -> Any: ...

    def score(self, features: Any, batch: DetectBatch) -> DetectResult: ...

    def observe(self, features: Any, batch: DetectBatch) -> None: ...


def is_staged(detector: Any) -> bool:
    return (hasattr(detector, "extract") and hasattr(detector, "score")
            and hasattr(detector, "observe"))


def run_detect(detector: Any, batch: DetectBatch) -> DetectResult:
    """Full detection pass for one stream: extract -> score -> observe.

    Falls back to the legacy single-call protocol for detectors that only
    implement ``detect``."""
    if is_staged(detector):
        features = detector.extract(batch)
        result = detector.score(features, batch)
        detector.observe(features, batch)
        return result
    base_ids = detector.detect(list(batch.chunks), batch.ids, batch.is_new,
                               batch.stream_hashes)
    return DetectResult(base_ids=np.asarray(base_ids, np.int64))


class LegacyDetectMixin:
    """v0 compatibility shim: ``detect(chunks, ids, is_new, stream_hashes)``
    on top of the staged methods."""

    def detect(self, chunks, ids, is_new, stream_hashes) -> np.ndarray:
        batch = DetectBatch(chunks=list(chunks), ids=ids, is_new=is_new,
                            stream_hashes=stream_hashes)
        return run_detect(self, batch).base_ids

"""Detectors + the end-to-end dedup/delta pipeline (port of
``repro.core.pipeline``).

    stream -> FastCDC chunks -> exact dedup (blake2b)
           -> resemblance detection (pluggable: CARD / Finesse / N-transform)
           -> delta-encode against the detected base | store raw
           -> container backend; DCR = bytes_in / bytes_stored

Detectors implement the staged protocol the store drives
(``repro_torch.api.detect``): ``fit`` (offline training), ``extract``
(features, batched on the device), ``score`` (verdicts, pure) and
``observe`` (the one index-mutating step); ``LegacyDetectMixin`` adds the
v0 ``detect``. Each takes a ``device`` and runs on the CUDA device unless
given ``device="cpu"``. Detection time (the paper's speed metric) is the
wall time of the three stages.
"""
from __future__ import annotations

from typing import Any, Protocol, Sequence

import numpy as np
import torch

from repro_torch.api.detect import LegacyDetectMixin
from repro_torch.api.registry import get_index, register_detector
from repro_torch.api.store import DedupStore, StreamSession, chunk_with  # noqa: F401  (v0 surface)
from repro_torch.api.types import DetectBatch, DetectResult, IngestReport, StoreStats  # noqa: F401
from repro_torch.core import baselines, chunking, context_model, features, similarity
from repro_torch.kernels import ingest, ops


class Detector(Protocol):
    """v0 single-call protocol; still accepted everywhere (``run_detect``
    falls back to it for detectors that are not staged). ``stream_hashes``
    is the chunker's scan of the stream (``kernels.ingest.StreamScan``)."""

    name: str

    def fit(self, training_streams: Sequence[bytes],
            cfg: chunking.ChunkerConfig) -> None: ...

    def detect(self, chunks: list[chunking.Chunk], ids: np.ndarray,
               is_new: np.ndarray, stream_hashes: Any) -> np.ndarray: ...


class NullDetector(LegacyDetectMixin):
    """Exact dedup only (no delta compression)."""

    name = "dedup-only"

    def __init__(self, device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)

    def fit(self, training_streams, cfg):
        pass

    def extract(self, batch: DetectBatch) -> None:
        return None

    def score(self, feats: None, batch: DetectBatch) -> DetectResult:
        return DetectResult(np.full(len(batch), -1, np.int64))

    def observe(self, feats: None, batch: DetectBatch) -> None:
        pass


class SuperFeatureDetector(LegacyDetectMixin):
    """Shared FirstFit wrapper for N-transform / Finesse.

    ``extract`` takes every chunk's super-features at once: kernel A's
    Rabin route over the stream's chunks (``ingest.chunk_rabin_fps``),
    then the scheme's range maxes on the device. FirstFit is sequential
    (chunk i may delta against chunk j < i of the same stream), so
    ``score`` replays that order on the host against a *pure overlay* of
    the shared index, and ``observe`` admits the batch for real: every
    verdict and the final index are the v0 interleaved loop's.
    """

    def __init__(self, scheme, name: str, device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)
        self._scheme = scheme
        self.name = name
        self._index = baselines.SuperFeatureIndex()

    def fit(self, training_streams, cfg):
        pass  # content-only schemes have no training phase

    def extract(self, batch: DetectBatch) -> list[tuple[int, ...]]:
        offs = np.asarray([c.offset for c in batch.chunks], np.int64)
        lens = np.asarray([c.length for c in batch.chunks], np.int64)
        fps, starts = ingest.chunk_rabin_fps(batch.stream_hashes, offs, lens,
                                             self._scheme.cfg.window)
        return self._scheme.batch_super_features(fps, starts, lens)

    def score(self, sfs_list: list[tuple[int, ...]],
              batch: DetectBatch) -> DetectResult:
        n = len(batch)
        out = np.full(n, -1, np.int64)
        overlay: list[dict[int, int]] = []
        for i, sfs in enumerate(sfs_list):
            if batch.is_new[i]:
                hit = self._index.query(sfs, overlay=overlay)
                if hit is not None and hit != batch.ids[i]:
                    out[i] = hit
            self._index.stage(sfs, int(batch.ids[i]), overlay)
        return DetectResult(out)

    def observe(self, sfs_list: list[tuple[int, ...]],
                batch: DetectBatch) -> None:
        for sfs, cid in zip(sfs_list, batch.ids):
            self._index.insert(sfs, int(cid))


def ntransform_detector(cfg: baselines.SuperFeatureConfig | None = None,
                        device: str | torch.device | None = None):
    return SuperFeatureDetector(baselines.NTransform(cfg), "n-transform", device)


def finesse_detector(cfg: baselines.SuperFeatureConfig | None = None,
                     device: str | torch.device | None = None):
    return SuperFeatureDetector(baselines.Finesse(cfg), "finesse", device)


class CARDDetector(LegacyDetectMixin):
    """The paper's scheme: initial features -> context model -> cosine index.

    Batch two-phase search: one top-1 query of the stream's chunks against
    the stored index, plus one intra-stream similarity pass (earlier chunks
    of the same stream are eligible bases), then a single batched insert.
    The index is a registry name (``"exact"``, the default, or
    ``"banded-lsh"``; ``use_lsh_bands`` survives as the reference's v0
    alias) or an index object. ``fused=False`` takes the per-chunk feature
    path. Runs on the CUDA device unless given ``device="cpu"``;
    ``use_kernel=False`` names the reference's path that skips its
    kernels, which on the CPU changes nothing and on the card raises.
    """

    name = "card"

    def __init__(self,
                 feat_cfg: features.FeatureConfig | None = None,
                 model_cfg: context_model.ContextModelConfig | None = None,
                 threshold: float = 0.3,
                 use_lsh_bands: bool = False,
                 use_kernel: bool = True,
                 fused: bool = True,
                 index: str | Any | None = None,
                 index_args: dict | None = None,
                 device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)
        if not use_kernel and self.device.type == "cuda":
            raise ValueError("use_kernel=False: on the card the port runs its "
                             "kernels and has no path that skips them")
        self.feat_cfg = feat_cfg or features.FeatureConfig()
        self.model_cfg = model_cfg or context_model.ContextModelConfig(m=self.feat_cfg.m)
        if self.model_cfg.m != self.feat_cfg.m:
            raise ValueError(f"model m={self.model_cfg.m} != feature m={self.feat_cfg.m}")
        self.threshold = threshold
        self.fused = fused
        # the chunker's max chunk size pins the Lmax bucket (set by fit)
        self.lmax_floor = 0
        self.extractor = features.FeatureExtractor(self.feat_cfg, device=self.device,
                                                   fused=fused)
        self.model = context_model.ContextModel(self.model_cfg, device=self.device)
        if index is None:
            index = "banded-lsh" if use_lsh_bands else "exact"
        if isinstance(index, str):
            kwargs = dict(index_args or {})
            if index == "exact":
                kwargs.setdefault("use_kernel", use_kernel)
            self.index = get_index(index)(self.model_cfg.d, threshold=threshold,
                                          device=self.device, **kwargs)
        else:
            self.index = index

    def _initial_features(self, chunks, stream_hashes) -> torch.Tensor:
        offs = np.asarray([c.offset for c in chunks], np.int64)
        return self.extractor([c.data for c in chunks], stream_hashes, offs,
                              lmax_floor=self.lmax_floor)

    def fit(self, training_streams: Sequence[bytes], cfg: chunking.ChunkerConfig,
            init: tuple[np.ndarray, np.ndarray] | None = None) -> None:
        """Training process (paper Fig. 3 left): chunk the training data in
        stream order, extract initial features, train the CBOW model."""
        self.lmax_floor = int(getattr(cfg, "max_size", 0) or 0)
        feats = []
        for stream in training_streams:
            chunks, h = chunk_with(cfg, stream, self.device)
            if chunks:
                feats.append(self._initial_features(chunks, h))
        if not feats:
            raise ValueError("CARD needs at least one training stream")
        self.model.fit(torch.cat(feats, dim=0), init=init)

    def extract(self, batch: DetectBatch) -> torch.Tensor:
        init = self._initial_features(batch.chunks, batch.stream_hashes)
        if not self.fused:
            return self.model.transform(init)                      # [n, D]
        # the reference pads rows to a pow2 bucket before the projection
        # on its fused path; kept so both run the product at the same shape
        n = init.shape[0]
        pad = features.bucket_pow2(n, 16) - n
        if pad:
            init = torch.cat([init, init.new_zeros(pad, init.shape[1])])
        return self.model.transform(init)[:n]                      # [n, D]

    def score(self, feats: torch.Tensor, batch: DetectBatch) -> DetectResult:
        n = len(batch)
        out = np.full(n, -1, np.int64)

        # phase 1: against the stored index
        ext_ids, ext_scores = self.index.query(feats)

        # phase 2: intra-stream (earlier chunks of this stream: j < i)
        sims = similarity.exact_matmul(feats, feats.T)
        upper = torch.ones(n, n, dtype=torch.bool, device=sims.device).triu()
        sims = sims.masked_fill(upper, float("-inf"))
        intra_j_t = sims.argmax(dim=1)
        intra_s = sims.gather(1, intra_j_t[:, None])[:, 0].cpu().numpy()
        intra_j = intra_j_t.cpu().numpy()

        use_intra = intra_s >= np.maximum(ext_scores, self.threshold)
        best_id = np.where(use_intra, batch.ids[intra_j], ext_ids)
        best_sc = np.where(use_intra, intra_s, ext_scores)
        ok = (best_sc >= self.threshold) & batch.is_new & (best_id != batch.ids)
        out[ok] = best_id[ok]
        return DetectResult(out, scores=np.where(ok, best_sc, 0.0))

    def observe(self, feats: torch.Tensor, batch: DetectBatch) -> None:
        new = np.flatnonzero(batch.is_new)
        if new.size:
            sel = torch.from_numpy(new).to(feats.device)
            self.index.insert_batch(feats[sel], batch.ids[new])


# --- registry factories (repro_torch.api.config builds through these) --------

@register_detector("dedup-only")
def _build_null(device: str | torch.device | None = None) -> NullDetector:
    return NullDetector(device)


@register_detector("finesse")
def _build_finesse(device: str | torch.device | None = None,
                   **sf_args) -> SuperFeatureDetector:
    cfg = baselines.SuperFeatureConfig(**sf_args) if sf_args else None
    return finesse_detector(cfg, device)


@register_detector("n-transform")
def _build_ntransform(device: str | torch.device | None = None,
                      **sf_args) -> SuperFeatureDetector:
    cfg = baselines.SuperFeatureConfig(**sf_args) if sf_args else None
    return ntransform_detector(cfg, device)


@register_detector("card")
def _build_card(*, feat: dict | None = None, model: dict | None = None,
                threshold: float = 0.3, index: str | None = None,
                index_args: dict | None = None, use_kernel: bool = True,
                fused: bool = True,
                device: str | torch.device | None = None) -> CARDDetector:
    """The reference's ``"card"`` factory."""
    feat_cfg = features.FeatureConfig(**(feat or {}))
    model_kw = dict(model or {})
    model_kw.setdefault("m", feat_cfg.m)
    model_cfg = context_model.ContextModelConfig(**model_kw)
    return CARDDetector(feat_cfg=feat_cfg, model_cfg=model_cfg,
                        threshold=threshold, index=index,
                        index_args=index_args, use_kernel=use_kernel,
                        fused=fused, device=device)


def run_workload(detector: Any, versions: Sequence[bytes],
                 cfg: chunking.ChunkerConfig | None = None,
                 train_on: int = 1) -> StoreStats:
    """Paper experiment harness: fit on the first ``train_on`` versions,
    then ingest every version through a store on the detector's device;
    returns the final stats."""
    store = DedupStore(detector, cfg, device=getattr(detector, "device", None))
    store.fit(list(versions[:train_on]))
    for v in versions:
        store.ingest(v)
    return store.stats

"""The CARD detector (port of ``repro.core.pipeline.CARDDetector``).

    stream -> FastCDC chunks -> exact dedup (blake2b)
           -> CARD: initial features -> context model -> cosine index
           -> delta-encode against the detected base | store raw
           -> container backend; DCR = bytes_in / bytes_stored

The detector implements the staged protocol the store drives:
``fit`` (offline training), ``extract`` (features), ``score`` (verdicts,
pure) and ``observe`` (the one index-mutating step). Features stay on the
detector's device from extraction through the index query.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.api.store import chunk_with
from repro_torch.api.types import DetectBatch, DetectResult
from repro_torch.core import chunking, context_model, features, similarity
from repro_torch.kernels import ops


class CARDDetector:
    """The paper's scheme: initial features -> context model -> cosine index.

    Batch two-phase search: one top-1 query of the stream's chunks against
    the stored index, plus one intra-stream similarity pass (earlier chunks
    of the same stream are eligible bases), then a single batched insert.
    Runs on the CUDA device unless given ``device="cpu"``.
    """

    name = "card"

    def __init__(self,
                 feat_cfg: features.FeatureConfig | None = None,
                 model_cfg: context_model.ContextModelConfig | None = None,
                 threshold: float = 0.3,
                 device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)
        self.feat_cfg = feat_cfg or features.FeatureConfig()
        self.model_cfg = model_cfg or context_model.ContextModelConfig(m=self.feat_cfg.m)
        if self.model_cfg.m != self.feat_cfg.m:
            raise ValueError(f"model m={self.model_cfg.m} != feature m={self.feat_cfg.m}")
        self.threshold = threshold
        # the chunker's max chunk size pins the Lmax bucket (set by fit)
        self.lmax_floor = 0
        self.extractor = features.FeatureExtractor(self.feat_cfg, device=self.device)
        self.model = context_model.ContextModel(self.model_cfg, device=self.device)
        self.index = similarity.CosineIndex(self.model_cfg.d, threshold=threshold,
                                            device=self.device)

    def _initial_features(self, chunks, stream_hashes) -> torch.Tensor:
        offs = np.asarray([c.offset for c in chunks], np.int64)
        lens = np.asarray([c.length for c in chunks], np.int64)
        return self.extractor(stream_hashes, offs, lens, lmax_floor=self.lmax_floor)

    def fit(self, training_streams: Sequence[bytes], cfg: chunking.ChunkerConfig,
            init: tuple[np.ndarray, np.ndarray] | None = None) -> None:
        """Training process (paper Fig. 3 left): chunk the training data in
        stream order, extract initial features, train the CBOW model."""
        self.lmax_floor = int(cfg.max_size)
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
        # the reference pads rows to a pow2 bucket before the projection;
        # kept so both run the product at the same shape
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


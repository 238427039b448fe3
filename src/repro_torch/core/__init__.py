"""CARD core (port of ``repro.core``): the paper's contribution as a
composable library, re-exported under the reference's names.

  chunking       FastCDC with a parallel gear-hash candidate scan (kernel A)
  features       N-sub-chunk shingle initial features (Algorithm 1, kernel B)
  context_model  BP-NN (CBOW) chunk-context aware model (§4.3)
  baselines      N-transform + Finesse super-features (§2/§3)
  similarity     cosine (kernel C) / banded-LSH resemblance indexes
  delta          COPY/ADD byte delta codec
  pipeline       the detectors and the dedup + delta-compression store (§5)
"""
from repro_torch.core.chunking import Chunk, ChunkerConfig, chunk_stream  # noqa: F401
from repro_torch.core.features import FeatureConfig, FeatureExtractor  # noqa: F401
from repro_torch.core.context_model import ContextModel, ContextModelConfig  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    CARDDetector,
    DedupStore,
    NullDetector,
    StoreStats,
    finesse_detector,
    ntransform_detector,
    run_workload,
)

"""Store surface of the port, re-exported under the reference's names
(``repro.api``; each name here is one the reference exports too):

    from repro_torch import api
    store = api.build_store(api.DedupConfig.from_dict(
        {"detector": "card", "backend": "file",
         "backend_args": {"path": "/data/containers"}}))   # on the card
    store.fit([first_version])
    with store.open_stream() as s:
        s.write(first_version)
    assert store.restore(s.report.handle) == first_version
    store.delete(s.report.handle)         # retire the stream ...
    store.collect()
    store.compact()                       # ... and reclaim its bytes
    store.close()

    srv = api.build_server(api.DedupConfig.from_dict(
        {"detector": "card", "server_workers": 4,
         "tenant_args": {"quota_bytes": 1 << 30}}))      # on the card
    srv.store.fit([first_version])
    report = srv.ingest("tenant-a", first_version)
    srv.store.metrics().to_prometheus()

``scrub`` and the crash-script harness (``run_crash_script``,
``snapshot_dir``, ``check_crash_invariants``, ``abandon``, ``CrashRun``)
stay in ``api.integrity`` and ``api.faults``, where the reference keeps
them too. The object store (with ``S3ObjectClient``), observability and
serving names resolve lazily, as in the reference: ``python -m
repro_torch.api.objectstore`` / ``... .observe`` must find their module
not yet imported.
"""
from repro_torch.api.types import (  # noqa: F401
    DetectBatch,
    DetectResult,
    IngestReport,
    RestoreReport,
    StoreStats,
)
from repro_torch.api.restore import (  # noqa: F401
    DEFAULT_CACHE_BYTES,
    DEFAULT_CACHE_SHARDS,
    DecodeCache,
    RecipeLayout,
    RestorePlan,
    ShardedDecodeCache,
    coalesce_reads,
    plan_chains,
)
from repro_torch.api.concurrency import (  # noqa: F401
    DeadlineExceededError,
    IoTelemetry,
    LockTimeout,
    RWLock,
    check_deadline,
    current_deadline,
    deadline_scope,
    remaining_time,
)
from repro_torch.api.detect import (  # noqa: F401
    LegacyDetectMixin,
    StagedDetector,
    is_staged,
    run_detect,
)
from repro_torch.api.integrity import (  # noqa: F401
    CorruptChunkError,
    CorruptJournalError,
    ScrubReport,
    crc32c,
)
from repro_torch.api.faults import (  # noqa: F401
    FaultInjector,
    FaultSchedule,
    RetryBudgetExceeded,
    SimulatedCrash,
    TransientError,
    register_crashpoint,
    registered_crashpoints,
)
from repro_torch.api.containers import (  # noqa: F401
    ContainerBackend,
    FileBackend,
    InMemoryBackend,
    PlannedChainReader,
)
from repro_torch.api.refcount import RefcountTable  # noqa: F401
from repro_torch.api.store import DedupStore, StreamSession, chunk_with  # noqa: F401
from repro_torch.api.lifecycle import (  # noqa: F401
    CollectReport,
    CompactionRun,
    EagerPolicy,
    NeverPolicy,
    ReclamationPolicy,
    ThresholdPolicy,
)
from repro_torch.api.registry import (  # noqa: F401
    available_backends,
    available_chunkers,
    available_detectors,
    available_indexes,
    available_policies,
    get_backend,
    get_chunker,
    get_detector,
    get_index,
    get_policy,
    register_backend,
    register_chunker,
    register_detector,
    register_index,
    register_policy,
)
from repro_torch.api.config import (  # noqa: F401
    DedupConfig,
    build_backend,
    build_chunker,
    build_detector,
    build_policy,
    build_server,
    build_store,
)

# name -> module of the names resolved on first access (PEP 562)
_LAZY_EXPORTS = {
    **dict.fromkeys(("LocalObjectStore", "ObjectStoreBackend", "S3ObjectClient"),
                    "objectstore"),
    **dict.fromkeys(("MetricsRegistry", "Observability", "Tracer",
                     "parse_prometheus_text"), "observe"),
    **dict.fromkeys(("CircuitBreaker", "CircuitOpenError", "DedupServer",
                     "OverloadError", "QuotaExceededError", "RequestRejected",
                     "TenantConfig"), "serve"),
}


def __getattr__(name: str):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)

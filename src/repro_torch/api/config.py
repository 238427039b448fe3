"""Declarative pipeline construction: ``DedupConfig.from_dict`` ->
``build_store`` (port of ``repro.api.config``).

A plain-dict config names each component by its registry key (the port's
own registry, ``api/registry.py``) plus keyword arguments for its factory:

    cfg = DedupConfig.from_dict({
        "detector": "finesse",
        "chunker_args": {"avg_size": 8192},
    })
    store = build_store(cfg)                  # on the card
    store = build_store(cfg, device="cpu")    # the plain PyTorch path

``DedupConfig`` has the reference's fields, defaults and validation, and
``to_dict`` round-trips, so one dict means the same in both packages. The
device is an argument of the ``build_*`` functions, not a config key.

The serving knobs (``restore_*``, ``verify_reads``, ``retry_deadline``)
reach the backend factory as the reference forwards them; ``trace_path`` /
``trace_ring_events`` reach the store, and ``build_server`` wraps the store
in a ``DedupServer`` sized by ``server_workers`` / ``server_args`` /
``tenant_args``. Backends: ``"memory"``, ``"file"``, ``"objectstore"`` and
``"s3"`` (``backend_args`` ``{"bucket": ..., "prefix": ...}``; it needs
boto3 and raises the reference's ``RuntimeError`` without it). Every
knob of the reference builds.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any

import torch

from repro_torch.api import registry
from repro_torch.api.store import DedupStore

_KNOWN_KEYS = {"detector", "detector_args", "chunker", "chunker_args",
               "backend", "backend_args", "policy", "policy_args",
               "restore_cache_bytes", "restore_cache_shards",
               "restore_cache_policy", "restore_reader_fds",
               "restore_readahead", "restore_coalesce_gap",
               "restore_tier_path", "restore_tier_bytes",
               "verify_reads", "retry_deadline",
               "trace_path", "trace_ring_events",
               "server_workers", "server_args", "tenant_args"}

# integer knobs validated in from_dict: knob name -> smallest legal value
_INT_KNOB_FLOORS = {"restore_cache_bytes": 1, "restore_cache_shards": 1,
                    "restore_reader_fds": 1, "restore_readahead": 0,
                    "restore_coalesce_gap": 0, "restore_tier_bytes": 1}

# serving / integrity knobs -> backend factory kwargs; each is forwarded
# only when set and only to factories that declare the kwarg (the memory
# backend has no decode cache or reader pool and takes none)
_BACKEND_KNOBS = {"restore_cache_bytes": "cache_bytes",
                  "restore_cache_shards": "cache_shards",
                  "restore_cache_policy": "cache_policy",
                  "restore_reader_fds": "reader_fds",
                  "restore_readahead": "readahead",
                  "restore_coalesce_gap": "coalesce_gap",
                  "restore_tier_path": "tier_path",
                  "restore_tier_bytes": "tier_bytes",
                  "verify_reads": "verify_reads",
                  "retry_deadline": "retry_deadline"}

@dataclasses.dataclass
class DedupConfig:
    """The reference's config, field for field (see ``repro.api.config``
    for what each serving knob does there)."""

    detector: str = "card"
    detector_args: dict[str, Any] = dataclasses.field(default_factory=dict)
    chunker: str = "fastcdc"
    chunker_args: dict[str, Any] = dataclasses.field(default_factory=dict)
    backend: str = "memory"
    backend_args: dict[str, Any] = dataclasses.field(default_factory=dict)
    policy: str = "never"
    policy_args: dict[str, Any] = dataclasses.field(default_factory=dict)
    restore_cache_bytes: int | None = None
    restore_cache_shards: int | None = None
    restore_cache_policy: str | None = None
    restore_reader_fds: int | None = None
    restore_readahead: int | None = None
    restore_coalesce_gap: int | None = None
    restore_tier_path: str | None = None
    restore_tier_bytes: int | None = None
    verify_reads: bool | None = None
    retry_deadline: float | None = None
    server_workers: int | None = None
    server_args: dict[str, Any] = dataclasses.field(default_factory=dict)
    tenant_args: dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_path: str | None = None
    trace_ring_events: int | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DedupConfig":
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(f"unknown DedupConfig keys {sorted(unknown)}; "
                             f"known: {sorted(_KNOWN_KEYS)}")
        cfg = cls(**{k: dict(v) if isinstance(v, dict) else v
                     for k, v in d.items()})
        for name in ("detector", "chunker", "backend", "policy"):
            if not isinstance(getattr(cfg, name), str):
                raise TypeError(f"{name} must be a registry name (str)")
        for name, floor in _INT_KNOB_FLOORS.items():
            value = getattr(cfg, name)
            if value is None:
                continue
            # 0 is meaningful for readahead (serial reads) and for the
            # coalesce gap (merge exactly-adjacent reads only)
            if (not isinstance(value, int) or isinstance(value, bool)
                    or value < floor):
                raise ValueError(f"{name} must be an int >= {floor}, "
                                 f"got {value!r}")
        for name in ("restore_cache_policy", "restore_tier_path"):
            value = getattr(cfg, name)
            if value is not None and not isinstance(value, str):
                raise TypeError(f"{name} must be a str, got {value!r}")
        if cfg.verify_reads is not None and not isinstance(cfg.verify_reads,
                                                           bool):
            raise TypeError(f"verify_reads must be a bool, "
                            f"got {cfg.verify_reads!r}")
        deadline = cfg.retry_deadline
        if deadline is not None and (isinstance(deadline, bool)
                                     or not isinstance(deadline, (int, float))
                                     or deadline < 0):
            raise ValueError(f"retry_deadline must be a number >= 0 "
                             f"(seconds), got {deadline!r}")
        if cfg.trace_path is not None and not isinstance(cfg.trace_path,
                                                         str):
            raise TypeError("trace_path must be a str (JSONL sink path)")
        ring = cfg.trace_ring_events
        if ring is not None and (not isinstance(ring, int) or ring < 0):
            raise ValueError(f"trace_ring_events must be an int >= 0, "
                             f"got {ring!r}")
        workers = cfg.server_workers
        if workers is not None and (not isinstance(workers, int)
                                    or isinstance(workers, bool)
                                    or workers < 1):
            raise ValueError(f"server_workers must be an int >= 1, "
                             f"got {workers!r}")
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def build_detector(cfg: DedupConfig, device: str | torch.device | None = None) -> Any:
    return registry.get_detector(cfg.detector)(**cfg.detector_args, device=device)


def build_chunker(cfg: DedupConfig) -> Any:
    return registry.get_chunker(cfg.chunker)(**cfg.chunker_args)


def build_backend(cfg: DedupConfig) -> Any:
    """The backend factory with ``backend_args``, plus each serving knob
    that is set, under its factory kwarg, where the factory declares it
    (an uninspectable factory gets an error, never a dropped knob)."""
    factory = registry.get_backend(cfg.backend)
    args = dict(cfg.backend_args)
    wanted = {kwarg: getattr(cfg, name)
              for name, kwarg in _BACKEND_KNOBS.items()
              if getattr(cfg, name) is not None and kwarg not in args}
    if wanted:
        try:
            params = inspect.signature(factory).parameters
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"serving knobs {sorted(wanted)} are set but backend "
                f"{cfg.backend!r} has an uninspectable factory signature; "
                "pass them via backend_args instead") from e
        args.update({k: v for k, v in wanted.items() if k in params})
    return factory(**args)


def build_policy(cfg: DedupConfig) -> Any:
    return registry.get_policy(cfg.policy)(**cfg.policy_args)


def build_store(cfg: DedupConfig, device: str | torch.device | None = None) -> DedupStore:
    """Resolve every component through the port's registry and assemble
    the store on ``device`` (the CUDA device unless ``"cpu"``)."""
    return DedupStore(build_detector(cfg, device), build_chunker(cfg),
                      backend=build_backend(cfg), policy=build_policy(cfg),
                      trace_path=cfg.trace_path,
                      trace_ring_events=cfg.trace_ring_events, device=device)


def build_server(cfg: DedupConfig, store: DedupStore | None = None,
                 device: str | torch.device | None = None):
    """``build_store`` on ``device`` plus a ``DedupServer`` over it, sized
    by ``server_workers`` with ``tenant_args`` as the default per-tenant
    limits. Pass an existing ``store`` to front one that already serves."""
    from repro_torch.api.serve import DedupServer, TenantConfig
    if store is None:
        store = build_store(cfg, device=device)
    kwargs = dict(cfg.server_args)
    if cfg.server_workers is not None and "workers" not in kwargs:
        kwargs["workers"] = cfg.server_workers
    if cfg.tenant_args and "default_tenant" not in kwargs:
        kwargs["default_tenant"] = TenantConfig(**cfg.tenant_args)
    return DedupServer(store, **kwargs)

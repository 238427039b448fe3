"""Name -> factory registries of the port (port of ``repro.api.registry``).

Six tables, one per seam the pipeline varies along, with the reference's
names and error messages. They are the port's own: nothing here or
anywhere in the port registers into the reference's registry.

    detectors       "card", "finesse", "n-transform", "dedup-only"
    indexes         "exact" (cosine top-1), "banded-lsh" (SimHash bands)
    chunkers        "fastcdc" (a ChunkerConfig factory)
    backends        "memory", "file", "objectstore", "s3"
    policies        "eager", "threshold", "never" (api/lifecycle.py)
    cache policies  "lru", "arc" (decode-cache eviction, api/restore.py)

Built-ins register themselves with the decorators at their definition
site (e.g. ``@register_index("exact")`` in core/similarity.py). Factories
of components that live on a device (detectors, indexes) take a
``device`` keyword, which ``api/config.py`` passes through.

This module imports nothing of the port at module scope (core modules
import *it* for the decorators), so there is no import cycle; built-ins
are registered lazily on the first lookup.
"""
from __future__ import annotations

from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable[..., Any])

_DETECTORS: dict[str, Callable[..., Any]] = {}
_INDEXES: dict[str, Callable[..., Any]] = {}
_CHUNKERS: dict[str, Callable[..., Any]] = {}
_BACKENDS: dict[str, Callable[..., Any]] = {}
_POLICIES: dict[str, Callable[..., Any]] = {}
_CACHE_POLICIES: dict[str, Callable[..., Any]] = {}

_builtins_loaded = False


def _ensure_builtins() -> None:
    """Import the modules whose import side effect registers built-ins."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    from repro_torch.api import containers, lifecycle, objectstore, restore  # noqa: F401
    from repro_torch.core import chunking, pipeline, similarity  # noqa: F401
    _CHUNKERS.setdefault("fastcdc", chunking.ChunkerConfig)
    # only after every import succeeded: a failure above must surface
    # again on the next lookup, not leave the registries silently empty
    _builtins_loaded = True


def _make_register(table: dict[str, Callable[..., Any]],
                   kind: str) -> Callable[[str], Callable[[F], F]]:
    def register(name: str) -> Callable[[F], F]:
        def deco(factory: F) -> F:
            existing = table.get(name)
            if existing is not None and existing is not factory:
                raise ValueError(f"{kind} {name!r} already registered")
            table[name] = factory
            return factory
        return deco
    return register


def _make_get(table: dict[str, Callable[..., Any]],
              kind: str) -> Callable[[str], Callable[..., Any]]:
    def get(name: str) -> Callable[..., Any]:
        _ensure_builtins()
        try:
            return table[name]
        except KeyError:
            raise KeyError(
                f"unknown {kind} {name!r}; available: "
                f"{sorted(table)}") from None
    return get


def _make_available(table: dict[str, Callable[..., Any]]) -> Callable[[], list[str]]:
    def available() -> list[str]:
        _ensure_builtins()
        return sorted(table)
    return available


register_detector = _make_register(_DETECTORS, "detector")
register_index = _make_register(_INDEXES, "index")
register_chunker = _make_register(_CHUNKERS, "chunker")
register_backend = _make_register(_BACKENDS, "backend")
register_policy = _make_register(_POLICIES, "policy")
register_cache_policy = _make_register(_CACHE_POLICIES, "cache policy")

get_detector = _make_get(_DETECTORS, "detector")
get_index = _make_get(_INDEXES, "index")
get_chunker = _make_get(_CHUNKERS, "chunker")
get_backend = _make_get(_BACKENDS, "backend")
get_policy = _make_get(_POLICIES, "policy")
get_cache_policy = _make_get(_CACHE_POLICIES, "cache policy")

available_detectors = _make_available(_DETECTORS)
available_indexes = _make_available(_INDEXES)
available_chunkers = _make_available(_CHUNKERS)
available_backends = _make_available(_BACKENDS)
available_policies = _make_available(_POLICIES)
available_cache_policies = _make_available(_CACHE_POLICIES)

"""Metrics registry, trace layer and exporters (port of
``repro.api.observe``, whole; DESIGN.md §12).

Every ``DedupStore`` owns an ``Observability`` (``store.observe``;
``store.metrics()`` returns its registry):

    MetricsRegistry   counters, gauges and bounded log2-bucket histograms.
                      Each thread writes a private shard without locks; a
                      shard folds into the dead-thread aggregate on thread
                      exit or through ``fold_current()``. A snapshot merges
                      dead and live shards under the registry lock, and a
                      histogram's count is derived from its buckets, so a
                      snapshot never tears. Exporters: Prometheus text
                      (``to_prometheus``) and JSON (``to_json`` /
                      ``snapshot``).
    Tracer            per-operation spans (op, span id, parent id, thread
                      id, wall-clock start, duration, labels) in a ring of
                      ``trace_ring_events`` and / or appended as JSONL to
                      ``trace_path``. With neither knob set a store has no
                      tracer (``store.observe.tracer is None``).

Native metrics are recorded at the event (stage timings, lock waits,
read-run widths, request latencies); derived views copy a counter that
another structure owns (``StoreStats``, ``IoTelemetry`` totals, the decode
cache, the object client) in with ``set_total`` at snapshot time, so the
registry never holds a second copy that can drift. Names follow
``repro_<subsystem>_<name>{label="..."}``, the reference's, so one
dashboard reads both packages.

Everything here is host code. Stage seconds of a store on the card are
what its commit measured after synchronising the device.

CLI: ``python -m repro_torch.api.observe dump TRACE.jsonl`` pretty-prints a
recorded trace with a per-op roll-up; ``... tail TRACE.jsonl -f`` follows
a live sink. ``parse_prometheus_text`` is the strict exposition parser.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import sys
import threading
import time
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Sequence

__all__ = [
    "BYTES_BUCKETS", "COUNT_BUCKETS", "DEFAULT_RING_EVENTS",
    "SECONDS_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Observability", "Tracer", "log2_bounds", "parse_prometheus_text",
]

#: Ring size used when ``trace_path`` is set without ``trace_ring_events``.
DEFAULT_RING_EVENTS = 2048


def log2_bounds(lo: int, hi: int) -> tuple[float, ...]:
    """Histogram bucket upper bounds ``2**lo .. 2**hi`` (one per power of
    two) — observations beyond ``2**hi`` land in the implicit +Inf
    bucket. Log2 spacing gives constant relative resolution across the
    decades a latency or size distribution actually spans."""
    return tuple(float(2.0 ** e) for e in range(lo, hi + 1))


#: ~1 µs .. 32 s — covers a cache-hit probe through a full cold restore.
SECONDS_BUCKETS = log2_bounds(-20, 5)
#: 64 B .. 4 GiB — payload spans, ranged-GET sizes, coalesced-run widths.
BYTES_BUCKETS = log2_bounds(6, 32)
#: 1 .. 4096 — small cardinalities (records per run, chunks per op).
COUNT_BUCKETS = log2_bounds(0, 12)


def _label_key(labels: dict[str, Any] | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# --- per-thread shards (the IoTelemetry fold pattern, generalized) -----------


class _Shard:
    """One thread's slice of every metric in a registry. The owning
    thread mutates without locks (dict/list ops are GIL-atomic); readers
    copy via single C-level ``list(...)`` calls, which cannot observe a
    mid-operation state."""

    __slots__ = ("counters", "hists")

    def __init__(self) -> None:
        self.counters: dict[tuple, float] = {}
        # key -> [bucket counts (len(bounds)+1, last = +Inf), value sum]
        self.hists: dict[tuple, list] = {}


class _ShardFold:
    """Thread-local anchor folding its shard on thread exit — same
    mechanism as ``concurrency._Fold``; ``fold_current()`` is the
    explicit path that does not wait for GC."""

    __slots__ = ("_reg", "_shard")

    def __init__(self, reg: "MetricsRegistry", shard: _Shard) -> None:
        self._reg = reg
        self._shard = shard

    def __del__(self) -> None:
        try:
            self._reg._fold(self._shard)
        except Exception:       # interpreter teardown: nothing to save
            pass


# --- metric handles ----------------------------------------------------------


class Counter:
    """Monotonic counter child (one (family, labels) series). ``inc``
    writes this thread's shard; ``set_total`` is for snapshot callbacks
    re-exporting an externally-owned total (derived views)."""

    __slots__ = ("_reg", "_key")

    def __init__(self, reg: "MetricsRegistry", key: tuple) -> None:
        self._reg = reg
        self._key = key

    def inc(self, n: float = 1) -> None:
        c = self._reg._shard().counters
        k = self._key
        c[k] = c.get(k, 0) + n

    def set_total(self, value: float) -> None:
        """Override this series' exported value with an authoritative
        external total (snapshot-time derived views; see module doc)."""
        self._reg._views[self._key] = value


class Gauge:
    """Set-semantics value (current level, not a rate). Global per
    series under the registry lock — gauges are set at snapshot time or
    on slow paths, never in per-chunk loops."""

    __slots__ = ("_reg", "_key")

    def __init__(self, reg: "MetricsRegistry", key: tuple) -> None:
        self._reg = reg
        self._key = key

    def set(self, value: float) -> None:
        with self._reg._lock:
            self._reg._gauges[self._key] = value

    def inc(self, n: float = 1) -> None:
        with self._reg._lock:
            g = self._reg._gauges
            g[self._key] = g.get(self._key, 0) + n


class Histogram:
    """Log2-bucketed distribution child. ``observe`` costs one
    thread-local lookup, one bisect and two list writes — cheap enough
    for per-operation (not per-byte) paths."""

    __slots__ = ("_reg", "_key", "_bounds", "_nb")

    def __init__(self, reg: "MetricsRegistry", key: tuple,
                 bounds: tuple[float, ...]) -> None:
        self._reg = reg
        self._key = key
        self._bounds = bounds
        self._nb = len(bounds) + 1      # +Inf overflow bucket

    def observe(self, value: float) -> None:
        hists = self._reg._shard().hists
        h = hists.get(self._key)
        if h is None:
            h = hists[self._key] = [[0] * self._nb, 0.0]
        h[0][bisect_left(self._bounds, value)] += 1
        h[1] += value


class _Family:
    __slots__ = ("kind", "help", "bounds")

    def __init__(self, kind: str, help_text: str,
                 bounds: tuple[float, ...] | None) -> None:
        self.kind = kind
        self.help = help_text
        self.bounds = bounds


class MetricsRegistry:
    """Store-scoped metric namespace (module docstring). Handle creation
    (``counter``/``gauge``/``histogram``) is create-or-get and may run
    on any thread; handles are cheap to cache and safe to share."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._series: dict[tuple, str] = {}     # (name, labels) -> kind
        self._live: list[_Shard] = []
        self._dead = _Shard()
        self._gauges: dict[tuple, float] = {}
        self._views: dict[tuple, float] = {}    # set_total overrides
        self._callbacks: list[Callable[[], None]] = []
        self._tl = threading.local()

    # --- family / handle management -----------------------------------------

    def _register(self, name: str, kind: str, help_text: str,
                  labels: dict | None,
                  bounds: tuple[float, ...] | None = None) -> tuple:
        key = (name,) + _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                self._families[name] = _Family(kind, help_text, bounds)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            elif bounds is not None and fam.bounds != bounds:
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"different buckets")
            self._series.setdefault(key, kind)
        return key

    def counter(self, name: str, help_text: str = "",
                labels: dict | None = None) -> Counter:
        return Counter(self, self._register(name, "counter", help_text,
                                            labels))

    def gauge(self, name: str, help_text: str = "",
              labels: dict | None = None) -> Gauge:
        return Gauge(self, self._register(name, "gauge", help_text, labels))

    def histogram(self, name: str, help_text: str = "",
                  labels: dict | None = None,
                  bounds: Sequence[float] = SECONDS_BUCKETS) -> Histogram:
        bounds = tuple(float(b) for b in bounds)
        return Histogram(self, self._register(name, "histogram", help_text,
                                              labels, bounds), bounds)

    def register_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` at the start of every snapshot — the derived-view
        hook: copy authoritative external counters in via ``set_total``
        / ``Gauge.set``. Callbacks run *outside* the registry lock, so
        they may take their owners' (leaf) locks freely."""
        with self._lock:
            self._callbacks.append(fn)

    # --- per-thread shard plumbing -------------------------------------------

    def _shard(self) -> _Shard:
        sh = getattr(self._tl, "s", None)
        if sh is None:
            sh = _Shard()
            with self._lock:
                self._live.append(sh)
            self._tl.s = sh
            self._tl.fold = _ShardFold(self, sh)
        return sh

    def _fold(self, shard: _Shard) -> None:
        with self._lock:
            try:
                self._live.remove(shard)
            except ValueError:
                return              # already folded
            self._merge_shard_locked(self._dead, shard)

    def fold_current(self) -> None:
        """Fold the calling thread's shard into the dead aggregate now
        (idempotent; the thread-exit fold becomes a no-op). Pooled
        executors call this between tasks so lifetime totals never
        depend on ``__del__``/GC timing."""
        sh = getattr(self._tl, "s", None)
        if sh is None:
            return
        self._tl.s = None
        self._tl.fold = None
        self._fold(sh)

    @staticmethod
    def _merge_shard_locked(into: _Shard, shard: _Shard) -> None:
        for k, v in list(shard.counters.items()):
            into.counters[k] = into.counters.get(k, 0) + v
        for k, h in list(shard.hists.items()):
            counts = list(h[0])
            tgt = into.hists.get(k)
            if tgt is None:
                into.hists[k] = [counts, h[1]]
            else:
                tc = tgt[0]
                for i, n in enumerate(counts):
                    tc[i] += n
                tgt[1] += h[1]

    # --- snapshots / exporters ----------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time view of every series, as plain JSON-able data:

            {name: {"type": ..., "help": ..., "samples": [
                {"labels": {...}, "value": v}                  # counter/gauge
                {"labels": {...}, "buckets": [[le, n], ...],   # histogram
                 "count": N, "sum": S}                         # (le "+Inf"
            ]}}                                                #  included)

        Histogram ``count`` is derived from the copied bucket array, so
        a snapshot taken mid-hammer is internally consistent (count ==
        sum of buckets) — totals drift only by in-flight increments,
        the same guarantee ``IoTelemetry.totals`` gives."""
        for cb in list(self._callbacks):
            cb()
        with self._lock:
            merged = _Shard()
            self._merge_shard_locked(merged, self._dead)
            for sh in self._live:
                self._merge_shard_locked(merged, sh)
            gauges = dict(self._gauges)
            views = dict(self._views)
            series = dict(self._series)
            families = {name: (f.kind, f.help, f.bounds)
                        for name, f in self._families.items()}
        out: dict[str, dict] = {}
        for name, (kind, help_text, bounds) in sorted(families.items()):
            out[name] = {"type": kind, "help": help_text, "samples": []}
        for key in sorted(series):
            name, labels = key[0], dict(key[1:])
            kind = series[key]
            fam = out[name]
            if kind == "histogram":
                bounds = families[name][2] or ()
                h = merged.hists.get(key)
                counts = list(h[0]) if h else [0] * (len(bounds) + 1)
                total = h[1] if h else 0.0
                fam["samples"].append({
                    "labels": labels,
                    "buckets": [[b, n] for b, n in zip(bounds, counts)]
                    + [["+Inf", counts[-1]]],
                    "count": sum(counts), "sum": total})
            elif kind == "gauge":
                fam["samples"].append({"labels": labels,
                                       "value": gauges.get(key, 0)})
            else:
                value = merged.counters.get(key, 0) + views.get(key, 0)
                fam["samples"].append({"labels": labels, "value": value})
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent,
                          sort_keys=True) + "\n"

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4): HELP/TYPE
        lines per family; histogram series expand to cumulative
        ``_bucket{le=...}`` plus ``_sum``/``_count``. Label values are
        escaped per the spec (backslash, quote, newline)."""
        snap = self.snapshot()
        lines: list[str] = []
        for name, fam in snap.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["samples"]:
                base = _format_labels(s["labels"])
                if fam["type"] == "histogram":
                    cum = 0
                    for le, n in s["buckets"]:
                        cum += n
                        lbl = _format_labels(
                            dict(s["labels"], le=_format_float(le)))
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    lines.append(f"{name}_sum{base} "
                                 f"{_format_float(s['sum'])}")
                    lines.append(f"{name}_count{base} {s['count']}")
                else:
                    lines.append(f"{name}{base} "
                                 f"{_format_float(s['value'])}")
        return "\n".join(lines) + "\n"


def _format_float(v) -> str:
    if isinstance(v, str):          # the "+Inf" bucket bound
        return v
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _escape_label(v: str) -> str:
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _format_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


# --- exposition parser (the observe-smoke gate) ------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _parse_sample_line(line: str) -> tuple[str, dict, float]:
    i = 0
    while i < len(line) and line[i] not in "{ ":
        i += 1
    name = line[:i]
    if not _NAME_RE.match(name):
        raise ValueError(f"bad metric name in line {line!r}")
    labels: dict[str, str] = {}
    if i < len(line) and line[i] == "{":
        i += 1
        while i < len(line) and line[i] != "}":
            m = _LABEL_NAME_RE.match(line, i)
            if not m:
                raise ValueError(f"bad label name in line {line!r}")
            lname = m.group(0)
            i = m.end()
            if line[i:i + 2] != '="':
                raise ValueError(f"bad label syntax in line {line!r}")
            i += 2
            out: list[str] = []
            while True:
                if i >= len(line):
                    raise ValueError(f"unterminated label in {line!r}")
                ch = line[i]
                if ch == "\\":
                    esc = _ESCAPES.get(line[i + 1:i + 2])
                    if esc is None:
                        raise ValueError(f"bad escape in line {line!r}")
                    out.append(esc)
                    i += 2
                elif ch == '"':
                    i += 1
                    break
                else:
                    out.append(ch)
                    i += 1
            labels[lname] = "".join(out)
            if i < len(line) and line[i] == ",":
                i += 1
        if i >= len(line) or line[i] != "}":
            raise ValueError(f"unterminated label set in {line!r}")
        i += 1
    rest = line[i:].strip()
    if not rest or " " in rest:     # no timestamps in our exposition
        raise ValueError(f"bad sample value in line {line!r}")
    try:
        value = float(rest)
    except ValueError:
        raise ValueError(f"non-numeric sample value in line {line!r}") \
            from None
    return name, labels, value


def parse_prometheus_text(text: str) -> dict:
    """Strict parser/validator for ``to_prometheus`` output. Returns

        {"types": {family: kind},
         "samples": [(name, labels_dict, value), ...]}

    and raises ``ValueError`` on any malformed line, a sample whose
    family has no TYPE line, or a histogram whose cumulative buckets
    decrease / disagree with ``_count`` — the checks ``make
    observe-smoke`` runs against a live store's exposition."""
    types: dict[str, str] = {}
    samples: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"bad comment line {line!r}")
            if parts[1] == "TYPE":
                if parts[3] if len(parts) > 3 else "" not in (
                        "counter", "gauge", "histogram"):
                    kind = parts[3] if len(parts) > 3 else ""
                    if kind not in ("counter", "gauge", "histogram"):
                        raise ValueError(f"bad TYPE line {line!r}")
                types[parts[2]] = parts[3]
            continue
        samples.append(_parse_sample_line(line))

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                return base
        return name

    hist_buckets: dict[tuple, list[float]] = {}
    hist_counts: dict[tuple, float] = {}
    for name, labels, value in samples:
        fam = family_of(name)
        if fam not in types:
            raise ValueError(f"sample {name!r} has no TYPE line")
        if types[fam] == "histogram":
            series = (fam,) + _label_key(
                {k: v for k, v in labels.items() if k != "le"})
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise ValueError(f"histogram bucket without le: "
                                     f"{name} {labels}")
                hist_buckets.setdefault(series, []).append(value)
            elif name.endswith("_count"):
                hist_counts[series] = value
    for series, cums in hist_buckets.items():
        if any(b > a for a, b in zip(cums[1:], cums)):
            raise ValueError(f"non-cumulative histogram buckets for "
                             f"{series[0]}")
        count = hist_counts.get(series)
        if count is not None and cums and cums[-1] != count:
            raise ValueError(
                f"histogram {series[0]}: +Inf bucket {cums[-1]} != "
                f"_count {count}")
    return {"types": types, "samples": samples}


# --- trace layer -------------------------------------------------------------


class Tracer:
    """Structured per-operation spans (module docstring). ``record``
    books a completed operation retroactively (the instrumented code
    already timed it); ``span`` is the context-manager form for code
    that has no timer of its own. Events are plain dicts::

        {"op": str, "id": int, "parent": int|None, "tid": int,
         "t0": epoch-seconds, "s": duration-seconds, **labels}

    kept in a bounded ring (oldest evicted) and/or appended — one JSON
    object per line, flushed per event so ``tail -f``-style followers
    see them live — to a JSONL sink."""

    def __init__(self, ring_events: int = DEFAULT_RING_EVENTS,
                 path: str | None = None) -> None:
        self.ring_events = max(0, int(ring_events))
        self.path = path
        self._ring: deque | None = (deque(maxlen=self.ring_events)
                                    if self.ring_events else None)
        self._file = open(path, "a", encoding="utf-8") if path else None
        self._wlock = threading.Lock()
        self._ids = itertools.count(1)

    def record(self, op: str, seconds: float, *, t0: float | None = None,
               parent: int | None = None, **labels) -> int:
        """Book one completed span; returns its id (pass as ``parent``
        to attach stage children to an operation)."""
        span_id = next(self._ids)
        # structural fields win over same-named labels — a label called
        # "op" must not clobber the span's identity
        event = dict(labels)
        event.update({"op": op, "id": span_id, "parent": parent,
                      "tid": threading.get_ident(),
                      "t0": time.time() - seconds if t0 is None else t0,
                      "s": float(seconds)})
        ring = self._ring
        if ring is not None:
            ring.append(event)
        f = self._file
        if f is not None:
            line = json.dumps(event, default=str)
            with self._wlock:
                f.write(line + "\n")
                f.flush()
        return span_id

    @contextmanager
    def span(self, op: str, parent: int | None = None, **labels):
        """Time a block as one span; the yielded dict is the label set
        (mutate it to attach results discovered inside the block)."""
        lbl = dict(labels)
        t0 = time.time()
        t0p = time.perf_counter()
        try:
            yield lbl
        finally:
            self.record(op, time.perf_counter() - t0p, t0=t0,
                        parent=parent, **lbl)

    def events(self) -> list[dict]:
        """Ring contents, oldest first (empty if no ring configured)."""
        ring = self._ring
        return list(ring) if ring is not None else []

    def ops(self) -> dict[str, int]:
        """Per-op event counts over the current ring."""
        out: dict[str, int] = {}
        for e in self.events():
            out[e["op"]] = out.get(e["op"], 0) + 1
        return out

    def close(self) -> None:
        f, self._file = self._file, None
        if f is not None:
            with self._wlock:
                f.close()


class Observability:
    """What a ``DedupStore`` owns: always a registry, and a tracer only
    when tracing was asked for (``trace_path`` and/or
    ``trace_ring_events`` — a path alone gets the default ring too, so
    ``store.observe.tracer.events()`` works whenever tracing is on)."""

    def __init__(self, trace_path: str | None = None,
                 trace_ring_events: int | None = None) -> None:
        self.metrics = MetricsRegistry()
        ring = trace_ring_events
        if trace_path is not None and not ring:
            ring = DEFAULT_RING_EVENTS
        self.tracer = (Tracer(ring or 0, trace_path)
                       if (trace_path or ring) else None)

    def close(self) -> None:
        if self.tracer is not None:
            self.tracer.close()


# --- CLI: dump / tail over a JSONL trace sink (§12.4) ------------------------


def _iter_trace(path: str) -> Iterable[dict]:
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{lineno}: not JSONL ({e})")


def _format_event(e: dict) -> str:
    meta = {"op", "id", "parent", "tid", "t0", "s"}
    lbl = " ".join(f"{k}={e[k]}" for k in sorted(e) if k not in meta)
    clock = time.strftime("%H:%M:%S", time.localtime(e.get("t0", 0)))
    parent = f"<{e['parent']} " if e.get("parent") else ""
    return (f"{clock} tid={e.get('tid', '?'):<8} #{e.get('id', '?'):<5} "
            f"{parent}{e.get('op', '?'):<20} "
            f"{1e3 * float(e.get('s', 0)):>10.3f} ms  {lbl}")


def _cmd_dump(args) -> int:
    events = [e for e in _iter_trace(args.trace)
              if args.op is None or e.get("op") == args.op]
    shown = events[-args.limit:] if args.limit else events
    for e in shown:
        print(_format_event(e))
    by_op: dict[str, list[float]] = {}
    for e in events:
        by_op.setdefault(e.get("op", "?"), []).append(float(e.get("s", 0)))
    print(f"# {len(events)} spans, {len(by_op)} ops")
    for op in sorted(by_op):
        ss = sorted(by_op[op])
        print(f"#   {op:<22} n={len(ss):<6} total={sum(ss):.4f}s "
              f"p50={1e3 * ss[len(ss) // 2]:.3f}ms "
              f"max={1e3 * ss[-1]:.3f}ms")
    return 0


def _cmd_tail(args) -> int:
    deadline = (time.monotonic() + args.timeout) if args.timeout else None
    shown = 0
    with open(args.trace, "r", encoding="utf-8") as f:
        if not args.from_start:
            f.seek(0, 2)
        buf = ""
        while True:
            chunk = f.readline()
            if chunk:
                buf += chunk
                if not buf.endswith("\n"):      # partial line: keep waiting
                    continue
                line, buf = buf.strip(), ""
                if line:
                    try:
                        print(_format_event(json.loads(line)))
                    except json.JSONDecodeError:
                        print(f"? {line}")
                    shown += 1
                    if args.max_events and shown >= args.max_events:
                        return 0
                continue
            if not args.follow:
                return 0
            if deadline is not None and time.monotonic() >= deadline:
                return 0
            time.sleep(0.2)


def main(argv: Sequence[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api.observe",
        description="Pretty-print or follow a JSONL trace sink written "
                    "by a store with DedupConfig.trace_path set "
                    "(DESIGN.md §12.4).")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("dump", help="pretty-print a recorded trace "
                                     "with a per-op roll-up")
    dp.add_argument("trace", help="trace JSONL file")
    dp.add_argument("--op", default=None, help="show only this op")
    dp.add_argument("--limit", type=int, default=0,
                    help="show only the last N spans (0 = all)")
    tp = sub.add_parser("tail", help="print spans as they are appended")
    tp.add_argument("trace", help="trace JSONL file")
    tp.add_argument("-f", "--follow", action="store_true",
                    help="keep waiting for new spans (default: stop at "
                         "end of file)")
    tp.add_argument("--from-start", action="store_true",
                    help="start at the beginning, not the current end")
    tp.add_argument("--max-events", type=int, default=0,
                    help="stop after printing N spans (0 = unbounded)")
    tp.add_argument("--timeout", type=float, default=0,
                    help="stop following after S seconds (0 = forever)")
    args = ap.parse_args(argv)
    return {"dump": _cmd_dump, "tail": _cmd_tail}[args.cmd](args)


if __name__ == "__main__":      # pragma: no cover - thin; logic is main()
    # defer to the canonical module (same pattern as objectstore's CLI)
    from repro_torch.api import observe as _canonical
    sys.exit(_canonical.main(sys.argv[1:]))

"""Space reclamation of the port (``repro_torch.api.lifecycle``, the
store's ``delete`` / ``collect`` / ``compact``, the reclamation policies)
against the JAX package's ``repro.api``: each case of
``tests/test_lifecycle.py`` runs the same ops through both packages on the
memory, file and objectstore backends and records what comes out (reports
without ``seconds``, the ``StoreStats`` lifecycle fields, raised errors,
restores, and the bytes on disk after each compaction); the two records
must be equal. Data is made from a seed with numpy and crosses between the
packages as bytes."""
import dataclasses
import hashlib
import signal
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import chunking as ref_chunking
from repro_torch import api
from repro_torch.api import config
from repro_torch.core import chunking

torch.set_num_threads(1)


def time_limit(default: float, **limits: float):
    """An autouse fixture that fails a test running past its limit
    (``limits[test name]``, else ``default`` seconds), so a deadlock or a
    runaway loop fails the test instead of hanging the suite. SIGALRM
    interrupts the main thread's lock waits too."""

    @pytest.fixture(autouse=True)
    def _time_limit(request):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("time_limit needs the main thread")
        seconds = limits.get(request.node.originalname, default)

        def expire(signum, frame):
            raise TimeoutError(f"{request.node.name} ran past its {seconds} s limit")

        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    return _time_limit


_limit = time_limit(30, test_post_compaction_card_ingest_matches_reference=120)

CHUNK = 4096
N_CHUNKS = 8
BACKENDS = ["memory", "file", "objectstore"]
PKGS = {"ref": (ref_api, ref_chunking), "port": (api, chunking)}


# --- deterministic fixtures (those of tests/test_lifecycle.py) ---------------

class FixedChunker:
    """Fixed-size chunks of the package's own ``Chunk`` type: boundaries
    stay position-stable, so ``ChainDetector`` builds chains of known depth."""

    def __init__(self, chunk_cls, size=CHUNK):
        self.chunk_cls, self.size = chunk_cls, size

    def chunk(self, stream):
        return [self.chunk_cls(off, len(stream[off:off + self.size]),
                               stream[off:off + self.size])
                for off in range(0, len(stream), self.size)], None


class ChainDetector:
    """Deltas every chunk against the same-position chunk of the previous
    stream: stream k's chunks sit at delta-chain depth exactly k."""

    name = "chain"

    def __init__(self):
        self._prev = None

    def fit(self, training_streams, cfg):
        pass

    def detect(self, chunks, ids, is_new, stream_hashes):
        ids = np.asarray(ids, np.int64)
        out = np.full(len(chunks), -1, np.int64)
        if self._prev is not None:
            k = min(len(self._prev), len(chunks))
            out[:k] = self._prev[:k]
        out[~np.asarray(is_new, bool)] = -1
        out[out == ids] = -1
        self._prev = ids.copy()
        return out


class StarDetector(ChainDetector):
    """Deltas every later stream's chunks against the same-position chunk
    of the FIRST stream (the shape whose rebase would grow the container)."""

    name = "star"

    def detect(self, chunks, ids, is_new, stream_hashes):
        ids = np.asarray(ids, np.int64)
        out = np.full(len(chunks), -1, np.int64)
        if self._prev is None:
            self._prev = ids.copy()
            return out
        k = min(len(self._prev), len(chunks))
        out[:k] = self._prev[:k]
        out[~np.asarray(is_new, bool)] = -1
        out[out == ids] = -1
        return out


def rand(nbytes, seed):
    return np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def edit(data, seed, nedits=6, span=40):
    """A lightly edited copy of the same length."""
    rng = np.random.default_rng(seed)
    buf = bytearray(data)
    for _ in range(nedits):
        p = int(rng.integers(0, len(buf) - span))
        buf[p:p + span] = rand(span, int(rng.integers(1 << 30)))
    return bytes(buf)


def chain_versions(generations=3, seed=7):
    """v0 random; each later generation edits every chunk of the one before."""
    versions = [rand(N_CHUNKS * CHUNK, seed)]
    rng = np.random.default_rng(seed + 1)
    for _ in range(generations - 1):
        buf = bytearray(versions[-1])
        for c in range(N_CHUNKS):
            p = c * CHUNK + int(rng.integers(0, CHUNK - 16))
            buf[p:p + 16] = rand(16, int(rng.integers(1 << 30)))
        versions.append(bytes(buf))
    return versions


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def norm(value):
    """A comparable form: dataclass reports lose ``seconds``; tuples and
    dicts are kept as they are."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        d = dataclasses.asdict(value)
        d.pop("seconds", None)
        return type(value).__name__, d
    return value


def disk_bytes(root: Path) -> dict:
    """Every file under a persistent backend's directory, by relative path."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def lifecycle_stats(stats) -> dict:
    return {f: getattr(stats, f) for f in
            ("live_bytes", "dead_bytes", "reclaimed_bytes", "chain_depth_hist",
             "bytes_in", "bytes_stored", "chunks", "dup_chunks", "delta_chunks",
             "raw_chunks")}


class Env:
    """One package's store on one backend kind, plus the record of what
    every op returned or raised."""

    def __init__(self, which, backend_kind, root, detector=ChainDetector):
        self.which = which
        self.api, self.chunking = PKGS[which]
        self.kind = backend_kind
        self.root = Path(root) / which
        self.detector_cls = detector
        self.trace = []
        self.store = self.make_store()

    def make_backend(self):
        if self.kind == "memory":
            return self.api.InMemoryBackend()
        if self.kind == "file":
            return self.api.FileBackend(self.root)
        return self.api.ObjectStoreBackend(self.root)

    def make_store(self):
        kwargs = {"device": "cpu"} if self.which == "port" else {}
        return self.api.DedupStore(self.detector_cls(), FixedChunker(self.chunking.Chunk),
                                   backend=self.make_backend(), **kwargs)

    def build(self, d):
        """``build_store`` from a config dict (path filled in)."""
        d = dict(d)
        if self.kind != "memory":
            d["backend_args"] = {"path": str(self.root)}
        d["backend"] = self.kind
        if self.which == "port":
            return config.build_store(config.DedupConfig.from_dict(d), device="cpu")
        return ref_api.build_store(ref_api.DedupConfig.from_dict(d))

    def ingest(self, data):
        with self.store.open_stream() as s:
            s.write(data)
        self.rec("ingest", s.report.handle, s.report.bytes_stored, s.report.dup_chunks,
                 s.report.delta_chunks, s.report.raw_chunks)
        return s.report.handle

    def rec(self, *items):
        self.trace.append(tuple(norm(x) for x in items))

    def call(self, label, fn, *args):
        """Run ``fn`` and record its result, or the type and text of the
        lookup / value error it raised."""
        try:
            out = fn(*args)
        except (KeyError, IndexError, ValueError) as e:
            out = ("raises", type(e).__name__, str(e))
        self.rec(label, out)
        return out

    def state(self, label, handles=()):
        """Lifecycle stats, refcount classes, restores and disk bytes."""
        st, refs = self.store, self.store._refs
        self.rec(label, lifecycle_stats(st.stats),
                 (sorted(refs.live_cids()), sorted(refs.pinned_cids()),
                  sorted(refs.dead_cids())),
                 refs.chain_depth_hist(), st.backend.epoch, st.backend.storage_bytes())
        for h in handles:
            self.call(f"restore {h}", lambda h=h: sha(st.restore(h)))
        if self.kind != "memory":
            st.backend.flush()
            self.rec("disk", {k: sha(v) for k, v in disk_bytes(self.root).items()})

    def reopen(self):
        self.store.close()
        self.store = self.make_store()

    def close(self):
        self.store.close()


def assert_same(ref: Env, port: Env):
    assert len(port.trace) == len(ref.trace)
    for i, (r, p) in enumerate(zip(ref.trace, port.trace)):
        assert p == r, f"step {i} ({r[0]!r}) differs"


def run_both(scenario, backend, tmp_path, **kw):
    envs = []
    for which in ("ref", "port"):
        env = Env(which, backend, tmp_path, **kw)
        try:
            scenario(env)
        finally:
            env.close()
        envs.append(env)
    assert_same(*envs)
    return envs


# --- the cases of tests/test_lifecycle.py, through both packages --------------

def _end_to_end(env):
    """Delete the stream whose chunks are delta bases of the survivors."""
    shared = rand(12 * CHUNK, seed=1)
    s1 = shared + rand(20 * CHUNK, seed=2)
    s2, s3 = edit(shared, seed=3), edit(shared, seed=4)
    env.store.close()
    env.store = env.build({"detector": "finesse", "chunker_args": {"avg_size": CHUNK}})
    env.store.fit([s1])
    h1, h2, h3 = (env.ingest(s) for s in (s1, s2, s3))
    assert env.store.stats.delta_chunks > 0
    env.call("delete", env.store.delete, h1)
    env.call("collect", env.store.collect)
    env.call("compact", env.store.compact)
    env.state("after", [h1, h2, h3])


def _pinned_base(env):
    v0, v1 = chain_versions(2)
    h0, h1 = env.ingest(v0), env.ingest(v1)
    env.call("delete", env.store.delete, h0)
    env.state("v0 deleted", [h0, h1])
    env.call("delete", env.store.delete, h1)
    env.state("v1 deleted")


def _revive(env):
    v0, v1 = chain_versions(2)
    env.ingest(v0)
    h1 = env.ingest(v1)
    env.call("delete", env.store.delete, h1)
    env.state("dead")
    h1b = env.ingest(v1)            # dedups against the dead chunks
    env.state("revived")
    env.call("compact", env.store.compact)
    env.state("compacted", [h1b])


def _delete_semantics(env):
    v0, v1 = chain_versions(2)
    h0 = env.ingest(v0)
    env.ingest(v1)
    env.call("delete", env.store.delete, h0)
    env.call("restore deleted", env.store.restore, h0)
    env.call("double delete", env.store.delete, h0)
    env.call("never issued", env.store.delete, 99)
    env.call("negative", env.store.delete, -1)
    env.state("after", [1])


def _depth_hist(env):
    v0, v1, v2 = chain_versions(3)
    h0, h1, h2 = env.ingest(v0), env.ingest(v1), env.ingest(v2)
    env.call("collect", env.store.collect)
    env.call("delete", env.store.delete, h1)
    env.call("compact", env.store.compact)
    env.call("collect", env.store.collect)
    env.state("after", [h0, h1, h2])


def _dead_hops(env):
    for dropped in ((1, 2), (0, 2)):
        env.store.close()
        if env.kind != "memory":        # a fresh directory for each round
            env.root = env.root.with_name(f"{env.which}-{dropped[0]}")
        env.store = env.make_store()
        versions = chain_versions(4)
        handles = [env.ingest(v) for v in versions]
        for i in dropped:
            env.call("delete", env.store.delete, handles[i])
        env.call("compact", env.store.compact)
        env.call("collect", env.store.collect)
        env.state(f"dropped {dropped}", handles)


def _heat_placement(env):
    """Restores warm ``chunk_heat`` before the compaction, so the rewrite
    places hot chains first; the bytes on disk must still be the same."""
    versions = chain_versions(4, seed=21) + [rand(N_CHUNKS * CHUNK, seed=22)]
    handles = [env.ingest(v) for v in versions]
    for h, times in ((3, 3), (4, 5), (2, 1)):
        for _ in range(times):
            env.store.restore(handles[h])
    env.store.restore_range(handles[0], CHUNK, 3 * CHUNK)
    env.call("delete", env.store.delete, handles[1])
    env.call("compact", env.store.compact)
    env.state("after", handles)


def _skip_growth(env):
    """Rebasing many tiny patches to raw would grow the container: the
    sizing pass skips the rewrite (``skipped``, nothing reclaimed)."""
    v0 = rand(N_CHUNKS * CHUNK, seed=11)
    later = []
    for i in range(4):
        buf = bytearray(v0)
        for c in range(N_CHUNKS):
            p = c * CHUNK + (i * 97) % (CHUNK - 16)
            buf[p:p + 16] = rand(16, seed=100 + 10 * i + c)
        later.append(bytes(buf))
    h0 = env.ingest(v0)
    handles = [env.ingest(v) for v in later]
    env.call("delete", env.store.delete, h0)
    run = env.call("compact", env.store.compact)
    assert run.skipped and run.reclaimed_bytes == run.swept_chunks == 0
    env.state("skipped", handles)
    for h in handles[:3]:
        env.call("delete", env.store.delete, h)
    run = env.call("compact", env.store.compact)
    assert not run.skipped and run.reclaimed_bytes >= 0
    env.state("rewritten", handles)


SCENARIOS = {"end_to_end": (_end_to_end, ChainDetector),
             "pinned_base": (_pinned_base, ChainDetector),
             "revive_dead_chain": (_revive, ChainDetector),
             "delete_semantics": (_delete_semantics, ChainDetector),
             "depth_hist_rebase": (_depth_hist, ChainDetector),
             "multiple_dead_hops": (_dead_hops, ChainDetector),
             "heat_placement": (_heat_placement, ChainDetector),
             "skip_growth": (_skip_growth, StarDetector)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(tmp_path, name, backend):
    scenario, detector = SCENARIOS[name]
    ref, port = run_both(scenario, backend, tmp_path, detector=detector)
    assert any(step[0] in ("compact", "delete") for step in port.trace)


def test_heat_changes_placement(tmp_path):
    """The heat-warmed compaction lays the log out otherwise than a cold
    one would: the placement order is really exercised."""
    _, port = run_both(_heat_placement, "file", tmp_path)
    hot = [s for s in port.trace if s[0] == "disk"][-1][1]["chunks.log"]
    cold = Env("port", "file", tmp_path / "cold")
    versions = chain_versions(4, seed=21) + [rand(N_CHUNKS * CHUNK, seed=22)]
    handles = [cold.ingest(v) for v in versions]
    cold.store.delete(handles[1])
    cold.store.compact()
    cold.store.backend.flush()
    assert sha((cold.root / "chunks.log").read_bytes()) != hot
    cold.close()


@pytest.mark.parametrize("backend", ["file", "objectstore"])
def test_reopen_after_compaction_matches_reference(tmp_path, backend):
    def scenario(env):
        v0, v1, v2 = chain_versions(3)
        h0, h1, h2 = env.ingest(v0), env.ingest(v1), env.ingest(v2)
        env.call("delete", env.store.delete, h1)
        env.call("compact", env.store.compact)
        env.reopen()                    # refcounts rebuilt from the backend
        env.rec("reopened", env.store.backend.live_handles(), env.store.backend.epoch)
        env.state("reopened", [h0, h1, h2])
        h3 = env.ingest(rand(N_CHUNKS * CHUNK, seed=42))
        env.call("delete pre-reopen stream", env.store.delete, h0)
        env.call("compact", env.store.compact)
        env.state("after", [h0, h2, h3])

    run_both(scenario, backend, tmp_path)


def test_policies_registered_as_in_the_reference():
    assert api.available_policies() == ref_api.available_policies() == [
        "eager", "never", "threshold"]
    cfg = config.DedupConfig.from_dict({"detector": "dedup-only", "policy": "threshold",
                                        "policy_args": {"ratio": 0.5}})
    assert config.DedupConfig.from_dict(cfg.to_dict()) == cfg
    assert isinstance(config.build_policy(cfg), api.ThresholdPolicy)
    assert isinstance(api.ThresholdPolicy(), api.ReclamationPolicy)
    with pytest.raises(KeyError, match="available"):
        config.build_policy(config.DedupConfig.from_dict({"policy": "no-such"}))
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError) as ref_err:
            ref_api.ThresholdPolicy(ratio=bad)
        with pytest.raises(ValueError) as err:
            api.ThresholdPolicy(ratio=bad)
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("policy,policy_args", [
    ("eager", {}), ("never", {}), ("threshold", {"ratio": 0.3}),
    ("threshold", {"ratio": 0.9})])
@pytest.mark.parametrize("backend", ["memory", "file"])
def test_policy_governs_auto_compaction_as_the_reference(tmp_path, backend, policy,
                                                         policy_args):
    def scenario(env):
        env.store.close()
        env.store = env.build({"detector": "dedup-only", "chunker_args": {"avg_size": CHUNK},
                               "policy": policy, "policy_args": policy_args})
        h0 = env.ingest(rand(16 * CHUNK, seed=11))
        env.ingest(rand(16 * CHUNK, seed=12))
        env.call("delete", env.store.delete, h0)
        env.state("after", [h0, 1])

    ref, port = run_both(scenario, backend, tmp_path)
    epoch = [s for s in port.trace if s[0] == "after"][0][4]
    assert epoch == (1 if policy == "eager" or policy_args == {"ratio": 0.3} else 0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("backend", ["memory", "objectstore"])
def test_seeded_interleaving_matches_reference(tmp_path, backend, seed):
    """Seeded ingest / delete / collect+compact interleavings (after
    tests/test_lifecycle_property.py) with Finesse: same record, and every
    live stream's base chain held in full."""
    pool = [rand(16 * CHUNK, seed=100)]
    for i in range(4):
        pool.append(edit(pool[-1], seed=101 + i, nedits=8))
    ops = np.random.default_rng(seed).integers(0, 64, 12)

    def scenario(env):
        env.store.close()
        env.store = env.build({"detector": "finesse", "chunker_args": {"avg_size": CHUNK}})
        env.store.fit(pool[:1])
        live = []
        for i, op in enumerate(int(o) for o in ops):
            kind = op % 4
            if kind in (0, 1):
                live.append(env.ingest(pool[(op // 4 + i) % len(pool)]))
            elif kind == 2 and live:
                env.call("delete", env.store.delete, live.pop((op // 4) % len(live)))
            elif kind == 3:
                env.call("collect", env.store.collect)
                env.call("compact", env.store.compact)
        env.state("end", live)
        backend_ = env.store.backend
        for h in backend_.live_handles():
            for cid in backend_.recipe(h):
                cur = cid
                while cur >= 0:
                    assert backend_.contains(cur)
                    cur = backend_.base_of(cur)
        fresh = type(env.store._refs).rebuild(backend_)
        refs = env.store._refs
        assert (fresh.live_bytes, fresh.pinned_bytes, fresh.dead_bytes) == (
            refs.live_bytes, refs.pinned_bytes, refs.dead_bytes)

    run_both(scenario, backend, tmp_path)


# --- CARD: a post-compaction ingest scored against swept index rows -----------

CARD_DICT = {"detector": "card", "chunker_args": {"avg_size": 8192},
             "detector_args": {"feat": {"k": 32, "m": 64, "n": 2},
                               "model": {"m": 64, "d": 50, "steps": 60},
                               "use_kernel": False}}


def test_post_compaction_card_ingest_matches_reference(tmp_path):
    """sql_dump 512 KiB x 3 through CARD on a file backend: delete 0 and 1,
    compact, re-ingest version 0. Its chunks were swept and its digests
    dropped, but the CARD index still holds their feature rows, so the
    detector may propose a base that is gone; the commit's ``contains``
    guard turns those into raw records. Verdicts, records and reports
    equal the reference's."""
    from repro_torch.data import workloads
    versions = workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=1 << 19, versions=3))
    seen = {}

    def scenario(env):
        env.store.close()
        env.store = env.build(CARD_DICT)
        verdicts = seen[env.which] = []
        score = env.store.detector.score

        def recording(feats, batch):
            res = score(feats, batch)
            verdicts.append(res.base_ids.tolist())
            return res

        env.store.detector.score = recording
        env.store.fit(versions[:1])
        handles = [env.ingest(v) for v in versions]
        for h in handles[:2]:
            env.call("delete", env.store.delete, h)
        env.call("collect", env.store.collect)
        env.call("compact", env.store.compact)
        swept = set(range(env.store.backend.max_chunk_id() + 1)) - set(
            env.store.backend.chunk_ids())
        env.rec("swept", len(swept), len(env.store.digest_seeds()))
        h = env.ingest(versions[0])
        env.rec("proposed swept bases", sum(b in swept for b in verdicts[-1]))
        b = env.store.backend
        env.rec("records", [b.record(c) for c in sorted(b.chunk_ids())])
        env.state("after", handles + [h])

    ref, port = run_both(scenario, "file", tmp_path)
    assert seen["port"] == seen["ref"]
    assert [s for s in port.trace if s[0] == "swept"][0][1] > 0
    assert [s for s in port.trace if s[0] == "proposed swept bases"][0][1] > 0

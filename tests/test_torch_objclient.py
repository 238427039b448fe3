"""The port's ``S3ObjectClient`` and ``"s3"`` backend against the JAX
package's, with no boto3 and no network: each client drives its own copy of
``tests/test_objclient_conformance.py``'s ``_StubS3`` (an in-process fake
of the boto3 surface the adapter uses) through the ``client=`` seam. The
same calls give the same returns, the same errors (type and text) and the
same objects in the fake's bucket; a store over each gives the same
objects, DCR and restores; without boto3 both raise the same
``RuntimeError``."""
import sys

import pytest
import torch

from repro import api as ref_api
from repro.api import objectstore as ref_os
from repro.data import workloads as ref_workloads
from repro_torch import api
from repro_torch.api import config, objectstore
from repro_torch.api.store import DedupStore

torch.set_num_threads(1)


# --- a copy of test_objclient_conformance's fake, with an error schedule -------

class _NoSuchKey(Exception):
    """boto3 raises a generated class named ``NoSuchKey``; the adapter
    matches on ``type(e).__name__``."""


_NoSuchKey.__name__ = "NoSuchKey"


class _ClientError(Exception):
    """botocore-shaped error with the HTTP status where the adapter reads it."""

    def __init__(self, code: int, op: str, key: str) -> None:
        super().__init__(f"stub {op} failed with {code} for {key!r}")
        self.response = {"ResponseMetadata": {"HTTPStatusCode": code}}


class _Body:
    def __init__(self, data: bytes) -> None:
        self._data = data

    def read(self) -> bytes:
        return self._data


class _Paginator:
    def __init__(self, buckets: dict) -> None:
        self._buckets = buckets

    def paginate(self, Bucket: str, Prefix: str = ""):
        keys = sorted(k for k in self._buckets.get(Bucket, {}) if k.startswith(Prefix))
        for i in range(0, len(keys), 2):
            yield {"Contents": [{"Key": k, "Size": len(self._buckets[Bucket][k])}
                                for k in keys[i:i + 2]]}
        if not keys:
            yield {}


class _StubS3:
    """``_StubS3`` of the conformance suite; ``fail`` maps an operation to
    the HTTP status its next call fails with (once)."""

    def __init__(self) -> None:
        self._buckets: dict[str, dict[str, bytes]] = {}
        self.fail: dict[str, int] = {}

    def _maybe_fail(self, op: str, key: str) -> None:
        code = self.fail.pop(op, None)
        if code is not None:
            raise _ClientError(code, op, key)

    def put_object(self, Bucket: str, Key: str, Body: bytes) -> dict:
        self._maybe_fail("put_object", Key)
        self._buckets.setdefault(Bucket, {})[Key] = bytes(Body)
        return {"ResponseMetadata": {"HTTPStatusCode": 200}}

    def get_object(self, Bucket: str, Key: str, Range: str | None = None) -> dict:
        self._maybe_fail("get_object", Key)
        data = self._buckets.get(Bucket, {}).get(Key)
        if data is None:
            raise _NoSuchKey(f"NoSuchKey: {Key!r}")
        if Range is not None:
            start_s, _, end_s = Range.removeprefix("bytes=").partition("-")
            data = data[int(start_s):int(end_s) + 1]
        return {"Body": _Body(data), "ResponseMetadata": {"HTTPStatusCode": 200}}

    def head_object(self, Bucket: str, Key: str) -> dict:
        self._maybe_fail("head_object", Key)
        data = self._buckets.get(Bucket, {}).get(Key)
        if data is None:
            raise _ClientError(404, "head_object", Key)
        return {"ContentLength": len(data), "ResponseMetadata": {"HTTPStatusCode": 200}}

    def get_paginator(self, op: str) -> _Paginator:
        assert op == "list_objects_v2", op
        return _Paginator(self._buckets)

    def delete_object(self, Bucket: str, Key: str) -> dict:
        self._maybe_fail("delete_object", Key)
        self._buckets.get(Bucket, {}).pop(Key, None)
        return {"ResponseMetadata": {"HTTPStatusCode": 204}}


def _outcome(fn, *args):
    """What a call gives: its value, or its exception's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:     # noqa: BLE001 - the outcome is what is compared
        return ("raised", type(e).__name__, str(e))


def _clients(prefix):
    mine, ref = _StubS3(), _StubS3()
    return (objectstore.S3ObjectClient("bk", prefix, client=mine), mine,
            ref_os.S3ObjectClient("bk", prefix, client=ref), ref)


CALLS = [("put", "a/b", b"payload bytes"), ("put", "a/c", b"x" * 10), ("put", "z", b""),
         ("get", "a/b"), ("get", "missing"), ("get_range", "a/b", 2, 5),
         ("get_range", "a/b", 8, 100), ("get_range", "missing", 0, 1),
         ("head", "a/c"), ("head", "missing"), ("list", ""), ("list", "a/"),
         ("list", "nope"), ("delete_object", "a/c"), ("delete_object", "a/c"),
         ("list", ""), ("get", "a/c")]


@pytest.mark.parametrize("prefix", ["pfx", "", "/deep/pfx/"])
def test_client_calls_match_reference(prefix):
    mine, mine_stub, ref, ref_stub = _clients(prefix)
    for op, *args in CALLS:
        assert _outcome(getattr(mine, op), *args) == _outcome(getattr(ref, op), *args), op
    assert mine.prefix == ref.prefix
    assert mine_stub._buckets == ref_stub._buckets


@pytest.mark.parametrize("code", [429, 500, 502, 503, 504, 403])
@pytest.mark.parametrize("op,stub_op,args", [
    ("put", "put_object", ("k", b"v")), ("get", "get_object", ("k",)),
    ("get_range", "get_object", ("k", 0, 1)), ("head", "head_object", ("k",)),
    ("delete_object", "delete_object", ("k",))])
def test_service_errors_wrap_as_the_reference(code, op, stub_op, args):
    """429 and 5xx become the retryable ``TransientError``; anything else
    propagates untouched."""
    mine, mine_stub, ref, ref_stub = _clients("p")
    for client, stub in ((mine, mine_stub), (ref, ref_stub)):
        client.put("k", b"value")
        stub.fail[stub_op] = code
    got, want = _outcome(getattr(mine, op), *args), _outcome(getattr(ref, op), *args)
    assert got == want
    assert got[1] == ("TransientError" if code != 403 else "_ClientError")


def test_without_boto3_both_raise_the_same_runtime_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)     # import boto3 -> ImportError
    errors = []
    for make in (lambda: objectstore.S3ObjectClient("b"), lambda: ref_os.S3ObjectClient("b")):
        with pytest.raises(RuntimeError) as e:
            make()
        errors.append(str(e.value))
    d = {"detector": "dedup-only", "backend": "s3", "backend_args": {"bucket": "b"}}
    with pytest.raises(RuntimeError) as e:
        config.build_store(config.DedupConfig.from_dict(d), device="cpu")
    errors.append(str(e.value))
    with pytest.raises(RuntimeError) as e:
        ref_api.build_store(ref_api.DedupConfig.from_dict(d))
    errors.append(str(e.value))
    assert len(set(errors)) == 1
    assert errors[0].startswith("backend 's3' needs boto3")


def test_s3_is_a_registered_backend_under_the_reference_names():
    assert "s3" in config.registry.available_backends()
    assert api.S3ObjectClient is objectstore.S3ObjectClient
    assert config.registry.get_backend("s3") is objectstore._s3_backend


@pytest.fixture(scope="module")
def versions():
    return ref_workloads.make_workload(
        "sql_dump", ref_workloads.WorkloadConfig(base_size=256 << 10, versions=3))


@pytest.mark.parametrize("detector", ["dedup-only", "finesse"])
def test_store_over_the_fake_matches_reference(versions, detector):
    """A store on ``ObjectStoreBackend(client=S3ObjectClient(..., client=
    fake))`` in each package: the same objects in the bucket, DCR and
    counts; a second backend on the same bucket restores every version."""
    d = {"detector": detector, "chunker_args": {"avg_size": 8192}}
    mine_stub, ref_stub = _StubS3(), _StubS3()
    cfg, ref_cfg = config.DedupConfig.from_dict(d), ref_api.DedupConfig.from_dict(d)
    mine_backend = lambda: objectstore.ObjectStoreBackend(
        client=objectstore.S3ObjectClient("bk", "store", client=mine_stub))
    ref_backend = lambda: ref_os.ObjectStoreBackend(
        client=ref_os.S3ObjectClient("bk", "store", client=ref_stub))
    mine = DedupStore(config.build_detector(cfg, device="cpu"), config.build_chunker(cfg),
                      backend=mine_backend(), device="cpu")
    ref = ref_api.DedupStore(ref_api.build_detector(ref_cfg), ref_api.build_chunker(ref_cfg),
                             backend=ref_backend())
    for store in (mine, ref):
        store.fit(versions[:1])
        for v in versions:
            store.ingest(v)
        store.close()
    assert mine_stub._buckets == ref_stub._buckets and mine_stub._buckets["bk"]
    stats = lambda s: (s.stats.dcr, s.stats.chunks, s.stats.dup_chunks,
                       s.stats.delta_chunks, s.stats.raw_chunks, s.stats.bytes_stored)
    assert stats(mine) == stats(ref)
    again = DedupStore(config.build_detector(cfg, device="cpu"), config.build_chunker(cfg),
                       backend=mine_backend(), device="cpu")
    assert [again.restore(h) for h in range(len(versions))] == list(versions)
    again.close()

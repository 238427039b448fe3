"""The port's object-store CLI (``python -m repro_torch.api.objectstore``:
``cp`` / ``ls`` / ``stat`` / ``verify`` / ``scrub``) against the JAX
package's: each subcommand runs through both ``main``s on the same files
(the port's with ``--device cpu``), and the catalogs, the object trees and
the printed lines (store paths masked) must be equal. A root written by
one package's CLI is listed, verified, scrubbed and extended by the
other's, both ways round.

Data is made from a seed with numpy and crosses between the packages as
files."""
import hashlib
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import faults as ref_faults
from repro.api import objectstore as ref_osmod
from repro_torch.api import faults
from repro_torch.api import objectstore as osmod
from test_torch_lifecycle import time_limit

torch.set_num_threads(1)

_limit = time_limit(60)

MAINS = {"port": osmod.main, "ref": ref_osmod.main}
FLIP = {"port": faults.flip_bit, "ref": ref_faults.flip_bit}
# the subcommands that build a store take the port's --device
STORE_CMDS = ("cp", "verify", "scrub")


def cli(side: str, argv: list[str], capsys) -> tuple[int, list[str]]:
    """(exit code, printed lines with every tmp path masked)."""
    if side == "port" and argv[0] in STORE_CMDS:
        argv = [*argv, "--device", "cpu"]
    capsys.readouterr()
    rc = MAINS[side](argv)
    out = capsys.readouterr().out
    return rc, re.sub(r"/\S*?/(port|ref)-", "<tmp>/", out).splitlines()


def _data(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def _write(p: Path, data: bytes) -> str:
    p.write_bytes(data)
    return str(p)


def tree(root: Path) -> dict:
    """sha256 of every file under ``root``, by relative path."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def catalog(root: Path) -> dict:
    cat = json.loads((root / "catalog.json").read_text())
    return cat


def run_both(script, tmp_path, capsys) -> dict:
    """``script(side, root, cli)`` for each package, each in its own root;
    their transcripts, catalogs and object trees must be equal."""
    got = {}
    for side in MAINS:
        root = tmp_path / f"{side}-bk"
        got[side] = script(side, root, lambda argv: cli(side, argv, capsys))
        if (root / "catalog.json").is_file():
            got[side] = (got[side], catalog(root), tree(root / "objects"))
    assert got["port"] == got["ref"]
    return got["port"]


def test_cp_ls_stat_verify_roundtrip(tmp_path, capsys):
    a = _data(200 << 10, 31)
    b = a[:150 << 10] + _data(50 << 10, 32)
    src_a, src_b = _write(tmp_path / "a.bin", a), _write(tmp_path / "b.bin", b)

    def script(side, root, run):
        out = [run(["cp", src_a, src_b, f"obj://{root}"]), run(["ls", f"obj://{root}"]),
               run(["stat", f"obj://{root}"]), run(["verify", f"obj://{root}"])]
        restored = tmp_path / f"{side}-restored.bin"
        out.append(run(["cp", f"obj://{root}/a.bin", str(restored)]))
        assert restored.read_bytes() == a
        assert catalog(root)["files"]["b.bin"]["stored"] < len(b) // 2
        return out

    out = run_both(script, tmp_path, capsys)[0]
    assert all(rc == 0 for rc, _ in out)
    assert out[3][1][-1] == "2/2 objects verified"


def test_cross_invocation_dedup_and_verify_failure(tmp_path, capsys):
    data = _data(120 << 10, 37)
    src, src2 = _write(tmp_path / "orig.bin", data), _write(tmp_path / "copy.bin", data)

    def script(side, root, run):
        out = [run(["cp", src, f"obj://{root}"]), run(["cp", src2, f"obj://{root}"])]
        cat = catalog(root)
        assert cat["files"]["copy.bin"]["stored"] < len(data) // 20
        cat["files"]["copy.bin"]["sha256"] = "0" * 64
        (root / "catalog.json").write_text(json.dumps(cat))
        out.append(run(["verify", f"obj://{root}"]))
        return out

    out = run_both(script, tmp_path, capsys)[0]
    assert out[2][0] == 1 and any(line.startswith("FAIL  copy.bin") for line in out[2][1])


def test_cp_overwrite_replaces_object(tmp_path, capsys):
    v1, v2 = _data(50 << 10, 41), _data(60 << 10, 42)

    def script(side, root, run):
        src = tmp_path / f"{side}-in" / "f.bin"
        src.parent.mkdir()
        out = []
        for v in (v1, v2):
            src.write_bytes(v)
            out.append(run(["cp", str(src), f"obj://{root}"]))
        dst = tmp_path / f"{side}-out.bin"
        out.append(run(["cp", f"obj://{root}/f.bin", str(dst)]))
        assert dst.read_bytes() == v2
        out.append(run(["verify", f"obj://{root}", "f.bin"]))
        return [rc for rc, _ in out]

    assert run_both(script, tmp_path, capsys)[0] == [0, 0, 0, 0]


@pytest.mark.parametrize("argv", [["cp", "local1", "local2"],
                                  ["cp", "obj://{t}/x", "obj://{t}/y"],
                                  ["ls", "obj://{t}/nostore"],
                                  ["stat", "obj://{t}/nostore"],
                                  ["verify", "obj://{t}/nostore"]])
def test_rejects_ambiguous_transfers_alike(tmp_path, capsys, argv):
    msgs = []
    for side in MAINS:
        with pytest.raises(SystemExit) as ei:
            cli(side, [a.format(t=tmp_path) for a in argv], capsys)
        msgs.append(str(ei.value.code))
    assert msgs[0] == msgs[1]


def test_scrub_clean_then_dirty_then_repaired(tmp_path, capsys):
    data = _data(150_000, 13)
    src = _write(tmp_path / "in.bin", data)

    def script(side, root, run):
        url = f"obj://{root}"
        out = [run(["cp", src, url]), run(["scrub", url])]
        target = sorted((root / "objects").glob("e*/chunks/*"))[0]
        FLIP[side](target, os.path.getsize(target) // 2)
        out += [run(["scrub", url]), run(["verify", url]),
                run(["scrub", url, "--repair"]), run(["scrub", url])]
        return out

    out = run_both(script, tmp_path, capsys)[0]
    assert [rc for rc, _ in out] == [0, 0, 1, 1, 0, 0]
    assert out[1][1][-1] == "clean" and "DIRTY" in out[2][1][-1]


@pytest.mark.parametrize("detector", ["finesse", "dedup-only", "card"])
def test_detectors_give_the_reference_catalog(tmp_path, capsys, detector):
    """``cp --detector`` for each detector, then a second invocation into
    the same root (the catalog's digest seeds at work): every catalog
    entry's stored bytes and chunk counts are the reference's."""
    base = _data(96 << 10, 50)
    versions = [base, base[:30_000] + _data(3000, 51) + base[30_000:],
                base[:60_000] + _data(2000, 52) + base[61_000:]]
    srcs = [_write(tmp_path / f"v{i}.bin", v) for i, v in enumerate(versions)]

    def script(side, root, run):
        out = [run(["cp", *srcs[:2], f"obj://{root}", "--detector", detector,
                    "--chunk-size", "4096"]),
               run(["cp", srcs[2], f"obj://{root}"]), run(["verify", f"obj://{root}"])]
        return [rc for rc, _ in out]

    assert run_both(script, tmp_path, capsys)[0] == [0, 0, 0]


def test_cross_open_both_ways(tmp_path, capsys):
    """Each package's CLI lists, stats, verifies, scrubs and extends a root
    the other's wrote, with the lines the writer's own CLI prints."""
    a = _data(80 << 10, 60)
    b = a[:40 << 10] + _data(20 << 10, 61)
    src_a, src_b = _write(tmp_path / "a.bin", a), _write(tmp_path / "b.bin", b)
    for writer, reader in (("ref", "port"), ("port", "ref")):
        root = tmp_path / f"{writer}-x"
        assert cli(writer, ["cp", src_a, f"obj://{root}"], capsys)[0] == 0
        for argv in (["ls", f"obj://{root}"], ["stat", f"obj://{root}"],
                     ["verify", f"obj://{root}"], ["scrub", f"obj://{root}"]):
            mine, theirs = cli(reader, argv, capsys), cli(writer, argv, capsys)
            assert mine == theirs and mine[0] == 0, argv
        # the reader extends the root; the writer verifies what it added
        assert cli(reader, ["cp", src_b, f"obj://{root}"], capsys)[0] == 0
        rc, lines = cli(writer, ["verify", f"obj://{root}"], capsys)
        assert rc == 0 and lines[-1] == "2/2 objects verified"
        out = tmp_path / f"{writer}-b.bin"
        assert cli(writer, ["cp", f"obj://{root}/b.bin", str(out)], capsys)[0] == 0
        assert out.read_bytes() == b


def test_device_defaults_to_the_card(tmp_path, capsys, monkeypatch):
    """Without ``--device`` the port's CLI builds its store on the CUDA
    device, and raises where there is none; ``ls`` and ``stat`` build no
    store."""
    src = _write(tmp_path / "f.bin", _data(10_000, 70))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        osmod.main(["cp", src, f"obj://{tmp_path}/c"])
    assert cli("port", ["cp", src, f"obj://{tmp_path}/c"], capsys)[0] == 0
    assert osmod.main(["ls", f"obj://{tmp_path}/c"]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        osmod.main(["verify", f"obj://{tmp_path}/c"])

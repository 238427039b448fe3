"""The port stands alone and never hides a missing card: no module of
``src/repro_torch`` (nor ``chip_smoke.py``) imports JAX or the reference
package, and an entry point asked for its CUDA default raises where there
is no CUDA device instead of running on the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.api import config
from repro_torch.api.store import DedupStore
from repro_torch.core import chunking, context_model, features, pipeline, similarity
from repro_torch.kernels import ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_checker_sees_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import hashing\n"
                 "from repro_torch.core import hashing as h\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == ["jax.numpy", "repro.core"]


@pytest.mark.parametrize("make", [
    lambda: pipeline.CARDDetector(),
    lambda: features.FeatureExtractor(),
    lambda: context_model.ContextModel(),
    lambda: similarity.CosineIndex(8),
    lambda: DedupStore(pipeline.CARDDetector(device="cpu")),
    lambda: ops.resolve_device("cuda"),
    lambda: pipeline.NullDetector(),
    lambda: pipeline.finesse_detector(),
    lambda: pipeline.ntransform_detector(),
    lambda: config.build_store(config.DedupConfig(detector="dedup-only")),
    lambda: config.build_detector(config.DedupConfig()),
    lambda: chunking.chunk_stream(b"a stream"),
    lambda: config.build_store(config.DedupConfig(detector="dedup-only", backend="objectstore",
                                                  backend_args={"path": "never-made"})),
], ids=["detector", "extractor", "context_model", "index", "store", "resolve",
        "null_detector", "finesse", "n_transform", "build_store", "build_detector",
        "chunk_stream", "build_store_objectstore"])
def test_cuda_default_raises_without_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_cpu_is_taken_only_when_asked_for():
    assert ops.resolve_device("cpu") == torch.device("cpu")
    det = pipeline.CARDDetector(device="cpu")
    assert det.device.type == det.index.device.type == det.model.device.type == "cpu"

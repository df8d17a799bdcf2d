"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and an
entry point asked for the card without one raises instead of running on
the CPU."""
import ast
import pathlib

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.serving.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, (path, bad)


def test_the_scan_sees_the_port():
    names = {p.name for p in FILES}
    assert {"engine.py", "attention.py", "ops.py", "build.py",
            "chip_smoke.py"} <= names


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    cfg = get_config("tiny-toy")
    params = model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no(ne)? .*available|CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError):
        model.init(cfg)
    with pytest.raises(RuntimeError):
        model.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"

"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and an
entry point asked for the card without one raises instead of running on
the CPU."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import ast
import pathlib

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch import plan, serve, train
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
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
    assert {"engine.py", "attention.py", "ops.py", "build.py", "pool.py",
            "router.py", "serve.py", "elastic.py", "chip_smoke.py",
            "costmodel.py", "pipeline.py", "autosearch.py", "plan.py",
            "trainer.py", "optimizer.py", "data.py", "checkpoint.py",
            "compression.py", "train.py"} <= names


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
    with pytest.raises(RuntimeError):       # before the tree is read
        from_jax_params(cfg, {})
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):       # before any weight is drawn
        serve.main(["--arch", "tiny-toy", "--requests", "1"])
    with pytest.raises(RuntimeError):       # the train CLI, on cuda by default
        train.main(["--arch", "tiny-toy", "--steps", "1"])
    assert resolve_device("cpu").type == "cpu"



def test_plan_runs_without_a_card(monkeypatch, capsys):
    """The planner is host arithmetic: it prints its schedule with no card."""
    _no_card(monkeypatch)
    plan.main(["--arch", "qwen3-8b", "--hw", "H100", "--devices", "1"])
    out = capsys.readouterr().out
    assert "=== qwen3-8b @ 1xH100" in out
    assert "not measured" in out
    for line in ("classification:", "optimal (Eq.9):", "autosearch: nano_kqv=",
                 "iter time:", "modeled throughput:", "critical path: KQV",
                 "unit assignment", " UGD", "units="):
        assert line in out, line

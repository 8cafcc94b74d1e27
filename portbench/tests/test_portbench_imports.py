"""The benchmark loads no JAX and not the JAX package; the references
import nothing of the program."""
import ast
import sys
import types

import pytest

from portbench.harness import guard, spec

SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_forbidden_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(guard.FORBIDDEN), (path, tops)
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert guard.loaded() == [] or all(m.split(".")[0] in guard.FORBIDDEN for m in guard.loaded())
    monkeypatch.setitem(sys.modules, "repro.models", types.ModuleType("repro.models"))
    assert "repro.models" in guard.loaded()
    with pytest.raises(SystemExit):
        guard.check("in a test")

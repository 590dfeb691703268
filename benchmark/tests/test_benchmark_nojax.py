"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level module name: the port's name, torch_renderer_tpu_torch,
begins with the JAX package's."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchlib import runner

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "torch_renderer_tpu"}


def imported_top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    found = imported_top_levels(path) & BANNED
    assert not found, f"{path} imports {found}"


def test_whole_name_comparison(monkeypatch):
    assert "torch_renderer_tpu_torch" not in runner.jax_modules()
    monkeypatch.setitem(sys.modules, "torch_renderer_tpu_torch_x",
                        types.ModuleType("torch_renderer_tpu_torch_x"))
    assert runner.jax_modules() == []
    monkeypatch.setitem(sys.modules, "torch_renderer_tpu.ops",
                        types.ModuleType("torch_renderer_tpu.ops"))
    assert runner.jax_modules() == ["torch_renderer_tpu"]

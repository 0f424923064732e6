"""The import guard: no file of the benchmark imports JAX or the JAX
package (top-level names compared whole, so the port, whose name begins
with the JAX package's, passes), and the plain reference imports nothing
of the port either."""

from __future__ import annotations

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gslivm_tpu"}


def imported_top_levels(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in sources()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_port(path):
    assert "gslivm_tpu_torch" not in imported_top_levels(path)


def test_the_guard_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import gslivm_tpu_torch.pipeline\nfrom gslivm_tpu.ops import sh\nimport jaxtyping\n")
    assert imported_top_levels(str(p)) & FORBIDDEN == {"gslivm_tpu"}


def test_the_run_time_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    from benchmark import run as R

    assert "gslivm_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gslivm_tpu_torch_like", types.ModuleType("x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert R.forbidden_modules() == ["jax"]

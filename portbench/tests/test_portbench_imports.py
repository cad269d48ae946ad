"""No module of the benchmark imports JAX, a JAX library or the JAX package,
compared on the whole top-level name (``feartracker_tpu_torch`` is not
``feartracker_tpu``); the reference imports nothing of the program."""

import ast
import os

import pytest

from portbench import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH_DIR) for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, harness.BENCH_DIR) for p in FILES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p])
def test_reference_imports_nothing_of_the_program(path):
    assert "feartracker_tpu_torch" not in top_level_imports(path)
    assert "feartracker_tpu_torch" not in open(path).read()


def test_whole_name_comparison():
    assert harness.FORBIDDEN.count("feartracker_tpu") == 1
    assert "feartracker_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert top_level_imports(__file__) >= {"ast", "os", "pytest", "portbench"}


def test_the_guard_names_what_it_finds(monkeypatch):
    import sys
    import types

    assert harness.forbidden_modules() == [] or all(m.split(".")[0] in harness.FORBIDDEN
                                                   for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "feartracker_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "feartracker_tpu.sub", types.ModuleType("y"))
    found = harness.forbidden_modules()
    assert "feartracker_tpu.sub" in found and "feartracker_tpu_torch_fake" not in found

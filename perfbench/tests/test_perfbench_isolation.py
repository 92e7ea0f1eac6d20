"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name: the port, ``repro_torch``, begins with ``repro``),
and the plain reference imports nothing of the program."""

import ast

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "perfbench").rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, bad


def test_only_program_and_tests_import_the_port():
    users = {p.relative_to(ROOT).as_posix() for p in FILES
             if any(m.split(".")[0] == "repro_torch" for m in _imports(p))}
    assert {u for u in users if "/tests/" not in u} == {
        "perfbench/program.py"}


def test_reference_stands_alone():
    for p in (ROOT / "perfbench" / "reference").rglob("*.py"):
        mods = [m.split(".")[0] for m in _imports(p)]
        assert set(mods) <= {"torch", "numpy", "math", "contextlib", "perfbench",
                             "__future__"}, (p, mods)
        assert not any(m.startswith("perfbench.") and not m.startswith(
            "perfbench.reference") for m in _imports(p))

"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name: the port, ``repro_torch``, begins with ``repro``);
only the families' ``program.py`` files import the port; the plain
references import nothing of the program; and no shared module names a
model family, so a family is added as files alone."""

import ast
import re

import pytest

from conftest import ROOT

PB = ROOT / "perfbench"
FILES = sorted(PB.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}
FAMILIES = sorted(p.name for p in (PB / "families").iterdir() if p.is_dir()
                  and p.name != "__pycache__")
SHARED = [p for p in FILES
          if not {"families", "tests"} & set(p.relative_to(PB).parts)]
REFERENCES = sorted((PB / "reference").glob("*.py")) + sorted(
    (PB / "families").glob("*/reference.py"))
# what a reference may take from the benchmark: the seed's generators, the
# shared reference, and another family's reference
YARDSTICK = re.compile(r"perfbench\.(inputs|reference\..+"
                       r"|families\.\w+\.reference(\..+)?)")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _benchmark_imports(path):
    """The benchmark's own modules a file imports, by their full names
    (``from perfbench import inputs`` is ``perfbench.inputs``)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names
                        if a.name.startswith("perfbench"))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.startswith("perfbench"):
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, bad


def test_only_program_and_tests_import_the_port():
    users = {p.relative_to(ROOT).as_posix() for p in FILES
             if any(m.split(".")[0] == "repro_torch" for m in _imports(p))}
    programs = {u for u in users if "/tests/" not in u}
    assert programs and all(
        u.startswith("perfbench/families/") and u.endswith("/program.py")
        for u in programs), programs


def test_reference_stands_alone():
    for p in REFERENCES:
        mods = [m.split(".")[0] for m in _imports(p)]
        assert set(mods) <= {"torch", "numpy", "math", "contextlib", "types",
                             "perfbench", "__future__"}, (p, mods)
        for m in _benchmark_imports(p):
            assert YARDSTICK.fullmatch(m), (p, m)


@pytest.mark.parametrize("path", SHARED, ids=lambda p: str(p.relative_to(ROOT)))
def test_shared_module_names_no_family(path):
    """Harness, inputs, the shared reference, the trace and the readers
    find a family by the configuration's ``family`` alone: no string,
    name or import of theirs is a family's."""
    tree = ast.parse(path.read_text())
    named = {n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    named |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    named |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not named & set(FAMILIES), named & set(FAMILIES)
    assert not [m for m in _benchmark_imports(path)
                if m.startswith("perfbench.families")]

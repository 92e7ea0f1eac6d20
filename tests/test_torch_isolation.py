"""The port stands alone: no module of ``src/repro_torch/`` (every file
under it, new ones included), not ``chip_smoke.py`` and no port example
(``examples/*_torch.py``) imports ``jax``, ``jaxlib`` or the JAX package
``repro``, or any package the card's machine lacks (its ``ast`` is read,
so an import inside a function counts too)."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
BANNED = ("jax", "jaxlib", "repro")


def _banned(source: str) -> list:
    return [m for m in _imports(source) if m.split(".")[0] in BANNED]


def _imports(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    bad = _banned(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_banned_forms():
    src = ("import jax.numpy as jnp\nfrom repro.models import layers\n"
           "def f():\n    import jaxlib\nimport repro_torch\n"
           "from repro_torch.models import layers\n")
    assert sorted(_banned(src)) == ["jax.numpy", "jaxlib", "repro.models"]


# what the card's machine has: the standard library, torch, numpy, scipy,
# einops, triton and the port itself (msgpack, for one, is not there)
ALLOWED = {"torch", "numpy", "scipy", "einops", "triton", "repro_torch"}


def _foreign(source: str) -> list:
    return [m for m in _imports(source)
            if m.split(".")[0] not in ALLOWED
            and m.split(".")[0] not in sys.stdlib_module_names]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_only_what_the_card_machine_has(path):
    bad = _foreign(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_allowlist_sees_foreign_packages():
    src = ("import msgpack\nfrom __future__ import annotations\n"
           "import json, torch.nn\ndef f():\n    import triton.language\n"
           "from repro_torch.wire import codec\nfrom orbax import checkpoint\n")
    assert sorted(_foreign(src)) == ["msgpack", "orbax"]

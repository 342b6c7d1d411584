"""The port stands alone: no module of ``samnerf_tpu_torch/`` and nothing
in ``chip_smoke.py`` imports JAX, jaxlib, flax or the JAX package
(``samnerf_tpu``), at any depth (inside functions too).  Read with
``ast``, so nothing is imported to check it."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "samnerf_tpu"}
FILES = sorted((REPO / "samnerf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def forbidden_imports(source: str):
    """(line, module) of every import of a forbidden top-level package."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_guard_finds_what_it_looks_for():
    src = ("import os\nimport jax.numpy as jnp\nfrom flax import linen\n"
           "def f():\n    from samnerf_tpu.utils import synthetic\n"
           "    import samnerf_tpu_torch, jaxlib\nfrom . import jax\n")
    assert forbidden_imports(src) == [(2, "jax.numpy"), (3, "flax"),
                                      (5, "samnerf_tpu.utils"), (6, "jaxlib")]


def test_there_are_files_to_check():
    assert len(FILES) > 100 and (REPO / "chip_smoke.py") in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    assert forbidden_imports(path.read_text()) == []

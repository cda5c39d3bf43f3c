"""What the benchmark imports: nothing under ``portbench/`` imports JAX or
the JAX package (top-level names compared whole, so that the port's own
``visfly_tpu_torch`` is not taken for ``visfly_tpu``), and the plain
reference (``reference/`` and each configuration's ``configs/<name>.py``)
imports nothing of the port."""
import ast
import glob
import os

import pytest

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "visfly_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(glob.glob(os.path.join(HOME, "**", "*.py"), recursive=True))
REFERENCE = [f for f in FILES if os.sep + "reference" + os.sep in f
             or os.path.dirname(f) == os.path.join(HOME, "configs")]


def test_names_are_compared_whole():
    assert "visfly_tpu_torch".split(".")[0] not in BANNED
    assert "visfly_tpu.envs".split(".")[0] in BANNED


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HOME))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: os.path.relpath(p, HOME))
def test_reference_imports_nothing_of_the_port(path):
    assert "visfly_tpu_torch" not in top_level_imports(path)


def test_a_run_leaves_no_jax_loaded():
    from portbench.harness import banned_modules
    from portbench.tests import _fixture

    _fixture.run("crossing_tiny.rollout", seconds=0.5)
    assert banned_modules() == []

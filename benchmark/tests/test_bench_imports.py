"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "eesen_tpu"}


def _files():
    for d, _, names in os.walk(BENCH):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    bad = set(_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for n in os.listdir(ref):
        if n.endswith(".py"):
            mods = set(_imports(os.path.join(ref, n)))
            assert "eesen_tpu_torch" not in mods, n
            assert mods <= {"__future__", "math", "typing", "numpy", "torch",
                            "benchmark"}, (n, mods)


def test_the_checker_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom eesen_tpu.ops import a\n"
                 "import eesen_tpu_torch\n")
    assert set(_imports(str(p))) & FORBIDDEN == {"jax", "eesen_tpu"}

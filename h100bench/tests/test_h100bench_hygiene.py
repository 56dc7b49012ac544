"""Nothing the benchmark runs imports JAX or the JAX package, compared by whole
top-level module names; the reference imports nothing of the program."""
import ast
import os

import pytest

from h100bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(BENCH, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "pagnerf_tpu"}


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & {"pagnerf_tpu_torch", "pagnerf_tpu", "h100bench"}


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(["pagnerf_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "pagnerf_tpu.ops", "flax"]) == \
        ["flax", "jax.numpy", "pagnerf_tpu.ops"]

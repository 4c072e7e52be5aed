"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``gym_futbol_tpu_torch`` is not ``gym_futbol_tpu``."""

import ast
import os

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gym_futbol_tpu", "bench"}
PKG = os.path.join(ROOT, "futbench")


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        if os.sep + "tests" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    assert set(imported(path)) <= {"__future__", "dataclasses", "math", "types", "typing",
                                   "torch"}


def test_the_program_is_read_through_its_package_only():
    for path in sources():
        for name in imported(path):
            assert name in {"__future__", "argparse", "bisect", "dataclasses", "functools",
                            "importlib", "json", "math", "numpy", "os", "re", "socket",
                            "statistics", "subprocess", "sys", "time", "torch", "traceback",
                            "types", "typing", "futbench", "gym_futbol_tpu_torch"}, (path, name)

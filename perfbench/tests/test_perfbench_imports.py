"""Nothing under perfbench imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
references import nothing of the program."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_whole_names_are_compared():
    from perfbench import run
    assert set(run.FORBIDDEN) == FORBIDDEN
    assert run.loaded_forbidden(["repro_torch", "repro_torch.models",
                                 "jaxtyping", "flaxen.x"]) == []
    assert run.loaded_forbidden(["repro.core", "jax.numpy", "torch"]) == [
        "jax", "repro"]


_RUN = r"""
import sys
sys.path[:0] = [{root!r}, {tests!r}]
from pathlib import Path
import conftest
import torch
torch.set_num_threads(1)
from perfbench import spec
from perfbench.harness import run_cell
from perfbench.run import loaded_forbidden
root = conftest.make_bench(Path({tmp!r}))
for w in conftest.tiny_cells():
    res = run_cell(spec.load_cell(root, w, root / "perfbench"), 7, 1.5,
                   True, device="cpu")
    assert res["correct"], res["readings"]
print("forbidden:", loaded_forbidden())
"""


def test_a_run_loads_neither(tmp_path):
    code = _RUN.format(root=str(ROOT), tests=str(BENCH / "tests"),
                       tmp=str(tmp_path))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "forbidden: []" in out.stdout

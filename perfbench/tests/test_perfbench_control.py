"""The control: the reference computed in fp8 (e4m3 products) in the
program's place must come out as not correct under each cell's own
limits. Kept here at a size a test run holds (tiny fp32 models on the
CPU, three seeds); on the chip ``perfbench/control.py`` reads it at each
cell's own size."""
import pytest

from conftest import make_bench, tiny_cells
from perfbench import spec
from perfbench.harness import run_cell

CELLS = tiny_cells()
LIMIT = 1e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("control"), limit=LIMIT)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(root, cell):
    c = spec.load_cell(root, cell, root / "perfbench")
    (kind,) = c.data["limits"]
    for seed in (11, 2**31 + 12, 13):
        res = run_cell(c, seed, 1.5, False, device="cpu", control=True)
        r = res["readings"]
        assert res["correct"] and r[kind] <= LIMIT
        assert res["control_correct"] is False
        assert r["control_" + kind] > max(3 * r[kind], LIMIT)

"""The check sees a broken timed path. Each run skips only the look for a
chip and drives the rest of a run (set-up, window, check) on the CPU at a
tiny size, with a fault planted under the timed path: a served token
altered where it is produced, a decode step that returns its state
unchanged, the second half of the batch left out. Each cell is judged
by the kind of reading its own file limits. One chip has no exchange
between chips to leave out."""
import pytest

from conftest import make_bench, tiny_cells
from perfbench import spec
from perfbench.harness import FAULTS, run_cell

CELLS = tiny_cells()
#: fp32 program against the fp32 reference: a sound run reads ~0
LIMIT = 1e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("faults"), limit=LIMIT)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_fault_is_not_correct(root, cell, fault):
    c = spec.load_cell(root, cell, root / "perfbench")
    (kind,) = c.data["limits"]
    res = run_cell(c, 2**31 + 3, 1.5, False, device="cpu",
                   faults=() if fault is None else (fault,))
    assert res["n_compared"] > 0
    if fault is None:
        assert res["correct"], res["readings"]
    else:
        assert not res["correct"], res["readings"]
        assert res["readings"][kind] > 10 * LIMIT

"""An autouse fixture that keeps BLAS to one thread, for the port's
parity tests that run BO's Gaussian process.

BO's GP runs small BLAS calls; with every xdist worker's OpenBLAS pool
spinning on the same cores they run ~200x slower. A test module imports
``one_blas_thread`` and the fixture applies to each of its tests. The
limit comes from ``threadpoolctl``, a test dependency; a module that
imports this one is skipped where it is missing.
"""
import pytest

threadpoolctl = pytest.importorskip("threadpoolctl")


@pytest.fixture(autouse=True)
def one_blas_thread():
    with threadpoolctl.threadpool_limits(limits=1, user_api="blas"):
        yield

"""The end-to-end arithmetic on synthetic timelines."""
import numpy as np
import pytest

from perfbench import e2e
from perfbench.e2e import Timeline


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=137))
    for q in (50, 90, 95, 99):
        assert e2e.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    with pytest.raises(ValueError):
        e2e.percentile([], 50)


def test_ttft_counts_every_request_due_and_censors_the_waiting():
    t0, t_end = 100.0, 110.0
    tls = [Timeline(101.0, [101.5, 101.6]),        # 500 ms
           Timeline(108.0, [111.0]),               # first token after the end
           Timeline(109.0, []),                    # never served
           Timeline(99.0, [99.2]),                 # due before the window
           Timeline(110.0, [110.5]),               # due at the end: not in
           Timeline(None, [104.0])]                # closed loop: no TTFT
    got = e2e.ttft_ms(tls, t0, t_end)
    assert got == pytest.approx([500.0, 2000.0, 1000.0])


def test_itl_gaps_that_end_in_the_window():
    t0, t_end = 10.0, 20.0
    tls = [Timeline(None, [9.0, 10.5, 11.0, 11.0]),  # 1500, 500, 0 ms
           Timeline(None, [18.0, 19.0, 21.0]),       # 1000; 21 is after
           Timeline(None, [5.0, 6.0])]               # before the window
    got = sorted(e2e.itl_ms(tls, t0, t_end))
    assert got == pytest.approx(sorted([1500.0, 500.0, 0.0, 1000.0]))


def test_itl_leaves_out_gaps_touching_a_span():
    tls = [Timeline(None, [1.0, 2.0, 3.0, 4.0, 5.0])]
    got = e2e.itl_ms(tls, 0.0, 10.0, outside=(2.5, 3.5))
    assert got == pytest.approx([1000.0, 1000.0])


def test_window_accounting():
    t0, t_end = 0.0, 4.0
    tls = [Timeline(0.5, [1.0, 2.0, 3.0]), Timeline(None, [-1.0, 3.5, 4.5])]
    w = e2e.window_metrics(tls, t0, t_end)
    assert w["output_tokens_per_s"] == pytest.approx(4 / 4.0)
    assert w["n_ttft"] == 1 and w["ttft_p90_ms"] == pytest.approx(500.0)
    assert w["n_itl"] == 3

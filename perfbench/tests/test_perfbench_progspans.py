"""The reduction of the program's own spans (``progspans.py``) on synthetic
kineto events, and the tool's control flow on a tiny cell on the CPU.
The annotations' device-side mirrors are never device work, so the
harness's own reduction reads the same numbers with the program's spans
in the trace as without them."""
import pytest
from torch.autograd import DeviceType

from conftest import make_bench
from perfbench import devtrace, progspans, spec


class Ev:
    """A kineto event as ``split_events`` reads it."""

    def __init__(self, name, a, b, cuda=False, ann=False, corr=0):
        self._v = (name, a, b, cuda, ann, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def spans(items, cuda=False):
    return [Ev(n, a, b, cuda=cuda, ann=True) for n, a, b in items]


# the harness's synthetic trace of test_perfbench_flops.py
SPANS = [("pb.window", 0, 100), ("pb.engine", 10, 90), ("pb.decode", 20, 50),
         ("pb.bookkeeping", 90, 95), ("pb.sleep", 95, 100)]
DEVICE = [("gemm", 25, 40), ("gemm", 35, 60), ("flash_fwd_mma", 70, 80),
          ("late", 120, 130)]
RT = [("rt.decode", 21, 49), ("rt.attn", 22, 30), ("rt.moe", 30, 48),
      ("rt.readback", 52, 68), ("rt.sample", 68, 88)]
# what the profiler mirrors on the device: ranges over the kernels each
# span launched, one of them over the idle gap at 60-70
MIRRORS = [("pb.decode", 25, 60), ("rt.decode", 25, 60), ("rt.attn", 25, 40),
           ("rt.moe", 35, 60), ("rt.sample", 62, 68)]


def harness_events(with_rt: bool):
    evs = spans(SPANS) + [Ev(n, a, b, cuda=True, corr=i + 1)
                          for i, (n, a, b) in enumerate(DEVICE)]
    evs += spans(MIRRORS[:1], cuda=True)
    if with_rt:
        evs += spans(RT) + spans(MIRRORS[1:], cuda=True)
    return evs


@pytest.mark.parametrize("with_rt", [False, True])
def test_harness_numbers_unchanged_by_the_program_spans(with_rt):
    ev = progspans.split_events(harness_events(with_rt))
    tr = progspans.harness_trace(ev)
    old = devtrace.reduce(SPANS, DEVICE)
    assert tr.window_s == old.window_s == pytest.approx(100e-9)
    assert tr.busy_s == old.busy_s == pytest.approx(45e-9)
    assert tr.idle_by_label == old.idle_by_label
    assert tr.kernels("flash_fwd") == old.kernels("flash_fwd")
    assert tr.top_ops() == old.top_ops()
    assert len(ev.mirrors) == (5 if with_rt else 1)


def test_mirrors_are_not_device_work():
    """Counted as device work, the mirror over the idle gap at 60-70
    would read as 6 ns more busy time."""
    ev = progspans.split_events(harness_events(True))
    assert [d[0] for d in ev.device] == [d[0] for d in DEVICE]
    naive = devtrace.reduce(SPANS, DEVICE + MIRRORS)
    assert naive.busy_s == pytest.approx(51e-9)
    assert progspans.harness_trace(ev).busy_s == pytest.approx(45e-9)


# one decode step: the embedding's kernel under rt.decode itself, two
# attention kernels, an expert GEMM, the logits, then the read-back's copy
STEP_SPANS = [("pb.window", 0, 1000), ("pb.engine", 0, 1000),
              ("pb.decode", 100, 600)]
STEP_RT = [("rt.decode", 110, 590), ("rt.attn", 120, 300),
           ("rt.moe", 300, 520), ("rt.logits", 520, 580),
           ("rt.readback", 600, 700), ("rt.sample", 700, 800)]
LAUNCHES = [("cudaLaunchKernel", 115, 118, 6), ("cudaLaunchKernel", 130, 133, 1),
            ("cudaLaunchKernelExC", 140, 143, 2),
            ("cuLaunchKernel", 310, 313, 3), ("cudaLaunchKernel", 530, 533, 4),
            ("cudaMemcpyAsync", 605, 640, 5), ("cudaStreamSynchronize", 640,
                                               690, 0)]
KERNELS = [("embed", 150, 160, 6), ("q_proj", 200, 220, 1),
           ("direct_copy", 230, 260, 2), ("nvjet_expert", 400, 450, 3),
           ("unembed", 550, 570, 4), ("Memcpy DtoH", 650, 660, 5)]


def step_events(with_rt=True):
    evs = spans(STEP_SPANS) + [Ev(n, a, b, corr=c) for n, a, b, c in LAUNCHES]
    evs += [Ev(n, a, b, cuda=True, corr=c) for n, a, b, c in KERNELS]
    if with_rt:
        evs += spans(STEP_RT) + spans(STEP_RT, cuda=True)
    return progspans.split_events(evs)


def test_launches_and_device_time_follow_the_correlation_ids():
    ev = step_events()
    assert [x[3] for x in ev.launches] == [6, 1, 2, 3, 4, 5]
    dec = progspans.per_call(ev, "rt.decode")
    assert dec["calls"] == 1 and dec["launches_per_call"] == 5
    assert dec["device_events_matched"] == 5
    assert dec["device_ms_per_call"] == pytest.approx(
        {"decode": 10e-6, "attn": 50e-6, "moe": 50e-6, "logits": 20e-6})
    assert dec["top_kernels_ms"]["attn"] == [
        ["direct_copy", pytest.approx(30e-6)], ["q_proj", pytest.approx(20e-6)]]
    # the harness's span around the same call, the program's spans off
    off = progspans.per_call(step_events(with_rt=False), "pb.decode")
    assert off["launches_per_call"] == 5
    assert off["device_ms_per_call"] == pytest.approx({"pb.decode": 130e-6})
    assert progspans.per_call(ev, "rt.prefill") == {"calls": 0}


def test_idle_gaps_split_by_the_innermost_program_span():
    ev = step_events()
    split = progspans.idle_split(ev)
    assert split == pytest.approx(
        {"engine_other": (150 + 340) * 1e-9,
         "decode_step/attn": (40 + 10) * 1e-9,
         "decode_step/moe": (140 + 100) * 1e-9,
         "engine_other/readback": 80e-9})
    # the parts of each harness label sum to what it reads alone
    old = progspans.harness_trace(ev).idle_by_label
    summed = {}
    for label, s in split.items():
        head = label.split("/")[0]
        summed[head] = summed.get(head, 0.0) + s
    assert summed == pytest.approx(old)
    assert old == pytest.approx({"engine_other": 570e-9,
                                 "decode_step": 290e-9})
    # without the program's spans the labels are the harness's own
    assert progspans.idle_split(step_events(with_rt=False)) == \
        pytest.approx(old)


def test_innermost_span_of_nested_ranges():
    inner = progspans.Innermost([("a", 0, 100), ("b", 10, 40), ("c", 20, 30),
                                 ("d", 40, 60)])
    assert [inner.at(t)[0] for t in (5, 15, 25, 35, 45, 70)] == \
        ["a", "b", "c", "b", "d", "a"]
    assert inner.at(100) is None and inner.at(-1) is None


def test_calls_with_and_without_the_program_spans():
    evs = [Ev(*x, ann=True) for x in STEP_SPANS + [("pb.decode", 900, 990)]]
    evs += [Ev(*x, ann=True) for x in STEP_RT]
    evs += [Ev(n, a, b, corr=c) for n, a, b, c in LAUNCHES]
    evs += [Ev("cudaLaunchKernel", 910, 912, corr=7)]
    evs += [Ev(n, a, b, cuda=True, corr=c) for n, a, b, c in KERNELS]
    evs += [Ev("late_embed", 950, 970, cuda=True, corr=7)]
    ev = progspans.split_events(evs)
    sel = progspans.traced_calls(ev, "pb.decode", "rt.decode")
    on = progspans.per_call(ev, "pb.decode", sel.on)
    off = progspans.per_call(ev, "pb.decode", sel.off)
    assert on["calls"] == off["calls"] == 1
    assert on["wall_ms"] == pytest.approx(500e-6)
    assert off["wall_ms"] == pytest.approx(90e-6)
    assert (on["launches_per_call"], off["launches_per_call"]) == (5, 1)
    assert off["device_ms_per_call"] == pytest.approx({"pb.decode": 20e-6})


def test_the_tool_runs_a_tiny_cell_on_the_cpu(tmp_path):
    root = make_bench(tmp_path)
    cell = spec.load_cell(root, "granite-moe-3b-a800m.chat-closed",
                          root / "perfbench")
    res = progspans.measure(cell, 2 ** 31 + 11, 0.4, 0.4, "cpu")
    assert res["correct"], res["readings"]
    for split in (res["wall"], res["profile"]["engine"]):
        for on in (False, True):
            r = split[on]
            assert r["decode_steps"] > 0
            parts = (r["decode_enqueue_ms"] + r["decode_readback_ms"]
                     + r["decode_sample_ms"])
            assert parts == pytest.approx(r["decode_step_ms"])
            assert min(r["decode_enqueue_ms"], r["decode_readback_ms"],
                       r["decode_sample_ms"]) >= 0
    p = res["profile"]
    dec = p["decode"]
    assert dec["on"]["calls"] == dec["on_outer"]["calls"] == \
        p["engine"][True]["decode_steps"]
    assert dec["off"]["calls"] == p["engine"][False]["decode_steps"]
    st = p["moe"]["decode"]
    assert 0 < st["taken_pairs"] <= st["routed_pairs"]
    assert st["taken_pairs"] <= st["capacity_rows"]
    s = progspans.summary(res)
    assert 0 < s["decode_capacity_use"] <= 100
    assert s["decode_step_ms_on"] > 0 and s["decode_step_ms_off"] > 0

"""Exact comparison of the reference's and the port's fleet objects.

Each package has its own classes, so values are compared by structure:
arrays by dtype, shape and ``np.array_equal`` (NaN equal to NaN), floats
with ``==`` (NaN equal to NaN), dicts by keys and values, dataclasses by
class name and fields. A fleet report is compared field by field, through
every accessor, ``saturation()``, ``by_tenant()`` and its carry.
"""
import dataclasses
import math

import numpy as np

REPORT_ARRAYS = ("arrivals", "finishes", "latencies", "queue_delays",
                 "cold_delays", "costs", "failed_mask")
REPORT_VALUES = ("makespan", "cpu_utilization", "mem_utilization", "p50",
                 "p99", "total_cost", "total_queue_delay", "provision_cost",
                 "throughput", "total_retries", "total_timeouts",
                 "total_hedges", "total_failures", "tenants",
                 "queue_delay_by_function", "busy_by_function",
                 "spinups_by_function", "provision_by_function",
                 "replicas_by_function", "retries_by_function",
                 "timeouts_by_function", "hedges_by_function",
                 "failures_by_function", "carry", "instances")
PERCENTILES = (0.0, 10.0, 50.0, 90.0, 99.0, 100.0)


def differences(a, b, path="value"):
    """Where ``a`` and ``b`` differ, as a list of paths (empty: equal)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return [f"{path}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"]
        ok = np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
        return [] if ok else [f"{path}: {a!r} != {b!r}"]
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if type(a).__name__ != type(b).__name__:
            return [f"{path}: {type(a).__name__} != {type(b).__name__}"]
        return [d for f in dataclasses.fields(a)
                for d in differences(getattr(a, f.name), getattr(b, f.name),
                                     f"{path}.{f.name}")]
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            return [f"{path}: keys {list(a)} != "
                    f"{list(b) if isinstance(b, dict) else b!r}"]
        return [d for k in a for d in differences(a[k], b[k],
                                                  f"{path}[{k!r}]")]
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return [f"{path}: {a!r} != {b!r}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differences(x, y, f"{path}[{i}]")]
    if type(a) is not type(b):
        return [f"{path}: {type(a).__name__} {a!r} != "
                f"{type(b).__name__} {b!r}"]
    if isinstance(a, float) and math.isnan(a) and math.isnan(b):
        return []
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def assert_same(a, b, what="value"):
    diff = differences(a, b, what)
    assert not diff, "\n".join(diff[:20])


def report_view(rep, slos=(), tenants=True):
    """Everything a fleet report exposes, as plain values: its arrays, its
    accessors and ledgers, percentiles, attainment/goodput/completion at
    ``slos``, ``saturation()`` and, per tenant, ``by_tenant()``'s
    reports (whose own tenant slices are themselves)."""
    view = {"len": len(rep)}
    view.update({name: getattr(rep, name) for name in REPORT_ARRAYS})
    view.update({name: getattr(rep, name) for name in REPORT_VALUES})
    view["percentile"] = [rep.percentile(q) for q in PERCENTILES]
    for slo in slos:
        view[f"slo {slo}"] = (rep.slo_attainment(slo), rep.goodput(slo),
                              rep.completion(slo))
    view["saturation"] = rep.saturation()
    if tenants and rep.tenants is not None:
        view["by_tenant"] = {t: report_view(sub, slos, tenants=False)
                             for t, sub in rep.by_tenant().items()}
    return view


def assert_same_report(got, want, slos=(), what="report"):
    """``got`` (port) equals ``want`` (reference) in every field."""
    assert_same(report_view(got, slos), report_view(want, slos), what)


def assert_same_reports(got, want, slos=()):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_report(g, w, slos, what=f"reports[{i}]")


def node_states(wf):
    """Runtimes and failure flags a run wrote onto a workflow."""
    return [(n.name, n.config.cpu, n.config.mem, n.runtime, n.failed,
             n.fail_reason) for n in wf]

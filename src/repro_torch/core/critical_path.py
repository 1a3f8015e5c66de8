"""Graph queries used by Algorithm 1 (Table I of the paper).

* ``find_critical_path(G)``     — longest weighted path in the DAG.
* ``find_detour_subpath(G, L)`` — every sub-path that leaves the
  critical path and rejoins it, "defined by their start and end nodes
  within the critical path, and no intersections with other nodes".
* ``runtime_sum(G, L, start, end)`` — the duration window between two
  critical-path anchor nodes (the sub-SLO of Algorithm 1 line 12).

Sub-paths whose detour begins at a workflow source (no start anchor) or
ends at a sink (no end anchor) are handled by treating the window as
starting at t=0 / ending at the critical path's finish.

The port's copy of ``src/repro/core/critical_path.py`` (lines 1-138),
numpy and plain Python as there, so that its float operations run in the
same order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import Workflow

#: Safety cap on enumerated simple detour paths (serverless workflows are
#: small; property tests may generate branchier DAGs).
_MAX_SUBPATHS = 4096


def find_critical_path(wf: Workflow) -> List[str]:
    """Longest path (by node runtime) through the weighted DAG.

    Ties are broken deterministically by node name so repeated searches
    are stable.
    """
    order = wf.topological_order()
    dist: Dict[str, float] = {}
    prev: Dict[str, Optional[str]] = {}
    for name in order:
        preds = wf.predecessors(name)
        if not preds:
            dist[name] = wf.nodes[name].runtime
            prev[name] = None
        else:
            # max over predecessors, deterministic tie-break on name
            best = max(preds, key=lambda p: (dist[p], p))
            dist[name] = dist[best] + wf.nodes[name].runtime
            prev[name] = best
    if not dist:
        return []
    end = max(dist, key=lambda n: (dist[n], n))
    path: List[str] = []
    cur: Optional[str] = end
    while cur is not None:
        path.append(cur)
        cur = prev[cur]
    path.reverse()
    return path


@dataclasses.dataclass
class SubPath:
    """A detour: ``start``/``end`` are critical-path anchors (either may
    be ``None`` when the detour starts at a source / ends at a sink);
    ``interior`` is the ordered list of off-critical-path node names."""

    start: Optional[str]
    end: Optional[str]
    interior: List[str]

    def __repr__(self) -> str:  # pragma: no cover
        return f"SubPath({self.start}->{self.interior}->{self.end})"


def find_detour_subpath(wf: Workflow, critical_path: Sequence[str]) -> List[SubPath]:
    """Enumerate detour sub-paths connected to the critical path.

    A detour is a simple path ``a -> x1 -> ... -> xk -> b`` where
    ``a``/``b`` lie on the critical path (or are absent for detours
    rooted at sources / terminating at sinks) and every ``xi`` is off
    the critical path. Detours are returned longest-window-first so
    Algorithm 1 configures the most constrained functions with the most
    context; nodes shared between detours are deduplicated by the
    ``scheduled`` flag in Algorithm 1.
    """
    cp_set = set(critical_path)
    subpaths: List[SubPath] = []

    def extend(anchor: Optional[str], first_off: str) -> None:
        """DFS over off-CP nodes starting at ``first_off``."""
        stack: List[Tuple[str, List[str]]] = [(first_off, [first_off])]
        while stack:
            if len(subpaths) >= _MAX_SUBPATHS:  # pragma: no cover - cap
                return
            cur, path = stack.pop()
            succs = wf.successors(cur)
            if not succs:
                subpaths.append(SubPath(start=anchor, end=None, interior=list(path)))
                continue
            for nxt in succs:
                if nxt in cp_set:
                    subpaths.append(SubPath(start=anchor, end=nxt, interior=list(path)))
                elif nxt not in path:  # simple paths only
                    stack.append((nxt, path + [nxt]))

    # detours branching off critical-path nodes
    for anchor in critical_path:
        for succ in wf.successors(anchor):
            if succ not in cp_set:
                extend(anchor, succ)
    # detours rooted at off-CP sources
    for src in wf.sources():
        if src not in cp_set:
            extend(None, src)

    # deterministic, widest-window-first ordering
    pos = {n: i for i, n in enumerate(critical_path)}
    def window_key(sp: SubPath) -> Tuple:
        s = pos.get(sp.start, -1)
        e = pos.get(sp.end, len(critical_path))
        return (-(e - s), s, tuple(sp.interior))
    subpaths.sort(key=window_key)
    return subpaths


def runtime_sum(wf: Workflow, critical_path: Sequence[str],
                start: Optional[str], end: Optional[str]) -> float:
    """Duration window between two critical-path anchors (Table I).

    This is the time the detour may spend without delaying the critical
    path: the summed runtimes of critical-path nodes strictly between
    ``start`` and ``end``.  ``start=None`` opens the window at the
    path's beginning; ``end=None`` closes it at the path's finish.
    """
    if not critical_path:
        return 0.0
    pos = {n: i for i, n in enumerate(critical_path)}
    i = pos[start] + 1 if start is not None else 0
    j = pos[end] if end is not None else len(critical_path)
    if j < i:
        raise ValueError(f"anchors out of order: {start!r} -> {end!r}")
    return sum(wf.nodes[critical_path[k]].runtime for k in range(i, j))

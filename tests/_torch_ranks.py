"""Runs a piece of code on N ranks of a gloo process group, for the
port's multi-rank tests.

Every rank is a subprocess of its own. The ranks meet through a
``FileStore`` under the test's ``tmp_path`` (no TCP port to collide
with another test worker), start the group with a 120 s timeout, and run
on one thread each. The whole run has a deadline: when it passes, every
rank is killed and the test fails, so a hung rank stalls nothing. The
code sees ``RANK``, ``WORLD`` and ``OUT`` (a directory for its results)
and the started default group; it must not tear the group down.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PRELUDE = """\
import datetime, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["RANKS_OUT"]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["RANKS_STORE"], WORLD),
    rank=RANK, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
"""
_POSTLUDE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, tmp_path: Path, *,
              timeout: float = 150.0) -> Path:
    """Run ``code`` on ``world`` ranks; returns the results directory.
    Fails with every failing rank's stderr, or when the deadline
    passes."""
    out = tmp_path / "ranks_out"
    out.mkdir()
    store = tmp_path / "ranks_store"
    script = tmp_path / "rank_main.py"
    script.write_text(_PRELUDE + textwrap.dedent(code) + _POSTLUDE)
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE=str(world),
               RANKS_STORE=str(store), RANKS_OUT=str(out),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp_path / f"rank{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=dict(env, RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            os.killpg(p.pid, signal.SIGKILL)
        for p in hung:
            p.wait()
    failed = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed.append(f"--- rank {rank} (exit {p.returncode}) ---\n"
                          f"{text[-4000:]}")
    if failed:
        raise AssertionError("\n".join(
            (["ranks killed at the deadline"] if hung else []) + failed))
    return out

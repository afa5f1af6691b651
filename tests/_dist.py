"""Run a function in ``P`` processes of a ``torch.distributed`` gloo group.

``spawn(P, "module:function", tmp_path, *args)`` starts ``P`` Python
processes; each sets ``torch.set_num_threads(1)``, joins a gloo group of
``P`` ranks through a ``file://`` rendezvous in ``tmp_path`` (so parallel
test workers never race for a port) with a group ``timeout``, imports
``module`` (from ``tests/`` or ``src/``) and returns
``function(rank, P, *args)``.  The per-rank return values come back as a
list, by pickle.  A child that fails, or a run that outlasts ``timeout``,
fails the caller with every child's output; every child is ended first.
``ranks`` starts only some of the ``P`` ranks (a peer that never joins).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")

CHILD = """
import datetime, importlib, os, pickle, sys
sys.path[:0] = [{tests!r}, {src!r}]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = {rank}, {world}
dist.init_process_group("gloo", init_method="file://" + {rdzv!r}, world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds={group_timeout}))
with open({args!r}, "rb") as f:
    args = pickle.load(f)
mod, fn = {target!r}.split(":")
out = getattr(importlib.import_module(mod), fn)(rank, world, *args)
with open({out!r} + ".tmp", "wb") as f:
    pickle.dump(out, f)
os.replace({out!r} + ".tmp", {out!r})
dist.destroy_process_group()
"""


class SpawnError(AssertionError):
    """A child failed or the run timed out; ``rcs`` are the exit codes."""

    def __init__(self, msg, rcs):
        super().__init__(msg)
        self.rcs = rcs


def spawn(world: int, target: str, tmp_path, *args, timeout: float = 120,
          group_timeout: float = 60, ranks=None) -> list:
    tmp = os.path.join(str(tmp_path), f"dist-{time.monotonic_ns()}")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in (range(world) if ranks is None else ranks):
        code = CHILD.format(tests=TESTS, src=SRC, rank=r, world=world,
                            rdzv=os.path.join(tmp, "rendezvous"), group_timeout=group_timeout,
                            args=os.path.join(tmp, "args.pkl"), target=target,
                            out=os.path.join(tmp, f"out{r}.pkl"))
        log = open(os.path.join(tmp, f"log{r}.txt"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                      stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"--- rank {r} (rc={rcs[r]}) ---\n{log.read()[-6000:]}")
        for log in logs:
            log.close()
        raise SpawnError(f"{target} on {world} gloo processes failed: rcs {rcs}\n"
                         + "\n".join(out), rcs)
    for log in logs:
        log.close()
    results = []
    for r in (range(world) if ranks is None else ranks):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results

"""Group targets of the sweep: one target run in ``procs`` gloo processes.

The sweep's ``group/<target>`` entries run ``<target>`` (built on 2x2x2
blocks, so each of 2 processes holds 4) in processes of a gloo group of
their own, started here with a ``file://`` rendezvous in a temporary
directory.  Every process runs the check; the congruence rule compares
their collective sequences through the group's store.  The group's report
is the union of the processes' findings.  A process that fails, or a group
that outlasts ``timeout``, raises with every process's output.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

from .findings import Finding, Report

_CHILD = """
import datetime, pickle, sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + {rdzv!r}, world_size={world},
                        rank={rank}, timeout=datetime.timedelta(seconds={timeout}))
from repro_torch.analysis import driver
rep = driver.run_target({name!r}, device={device!r})
with open({out!r}, "wb") as f:
    pickle.dump([f.as_dict() for f in rep], f)
dist.destroy_process_group()
"""


def run(name: str, procs: int = 2, device: str = "cpu", timeout: float = 300) -> Report:
    """``name`` (a sweep target) checked in ``procs`` gloo processes."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="repro-torch-analysis-") as tmp:
        children, logs = [], []
        for r in range(procs):
            code = _CHILD.format(src=src, rdzv=os.path.join(tmp, "rendezvous"), world=procs,
                                 rank=r, timeout=int(timeout), name=name, device=device,
                                 out=os.path.join(tmp, f"out{r}.pkl"))
            log = open(os.path.join(tmp, f"log{r}.txt"), "w+")
            logs.append(log)
            children.append(subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                             stderr=subprocess.STDOUT,
                                             env=dict(os.environ, OMP_NUM_THREADS="1")))
        deadline = time.monotonic() + timeout
        try:
            for p in children:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in children:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in children]
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read()[-4000:])
            log.close()
        if any(rcs):
            raise RuntimeError(f"group target {name} on {procs} gloo processes failed: rcs {rcs}\n"
                               + "\n".join(f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
        rep = Report()
        for r in range(procs):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                rep.extend(Finding(d["rule"], d["severity"], d["site"], d["message"])
                           for d in pickle.load(f))
        return rep

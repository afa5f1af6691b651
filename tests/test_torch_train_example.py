"""``examples/torch_train_lm.py``, the twin of ``examples/train_lm.py``, on
the CPU at its quick model (~25M parameters) for a few steps: the
reference example's printed lines (the model line, the loss line against
the uniform floor, the straggler line) and ``OK``, the loss falling, a
second run resuming from the first's checkpoint, ``--dp`` refused in one
process and ``--dp 2 --tp 1`` training over 2 gloo processes."""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import torch_train_lm  # noqa: E402


def test_train_lm_twin_prints_the_reference_lines_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    out = torch_train_lm.main(["--device", "cpu", "--steps", "3", "--ckpt-dir", ckpt])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "model repro-25m: 15.7M params, 8 layers; devices: 1 (cpu)"
    assert re.fullmatch(r"loss: \d+\.\d{4} -> \d+\.\d{4} \(uniform floor = 9\.0109\)",
                        lines[-3]), lines[-3]
    assert lines[-2] == f"straggler events: {out['straggler_events']}; checkpoints in {ckpt}"
    assert lines[-1] == "OK"
    hist = out["history"]
    assert len(hist) == 3 and np.isfinite(hist).all() and hist[-1] < hist[0]
    # the final checkpoint is the newest (the watchdog may have saved earlier
    # steps too, where a loaded host made a step slow)
    assert max(os.listdir(ckpt)) == "step_00000003"
    again = torch_train_lm.main(["--device", "cpu", "--steps", "5", "--ckpt-dir", ckpt])
    assert "[trainer] resumed from step 3" in capsys.readouterr().out
    assert len(again["history"]) == 2


def test_train_lm_twin_refuses_sharding(tmp_path):
    """``--dp 2`` in one process raises (nothing falls back to one
    process); over 2 gloo processes ``--dp 2 --tp 1`` trains, both with the
    same falling losses."""
    with pytest.raises(ValueError, match="dp"):
        torch_train_lm.main(["--device", "cpu", "--dp", "2"])
    from _dist import spawn

    got = spawn(2, "test_torch_train_example:_twin", tmp_path, str(tmp_path / "ckpt"),
                timeout=180)
    assert got[0] == got[1] and len(got[0]) == 2 and got[0][-1] < got[0][0]


def _twin(rank, world, ckpt):
    """One process of the 2-process run: the twin's losses."""
    out = torch_train_lm.main(["--device", "cpu", "--steps", "2", "--dp", "2", "--tp", "1",
                               "--ckpt-dir", ckpt])
    return out["history"]

"""The analyzer under a process group: the sweep's ``group/`` targets (one
target per app — Poisson mgcg, Heat3D with hide, TwoPhase3D's pressure
solve, the Stokes stress-preconditioned velocity solve — each checked in 2
gloo processes of 4 blocks, with the processes' collective sequences
compared through the group's store) are clean, as the same targets are in
one process; and the CLI gates on a baseline in the JAX package's format.
"""

from __future__ import annotations

import json

import pytest

from repro_torch.analysis import driver
from repro_torch.analysis.__main__ import main


@pytest.mark.parametrize("name", driver.GROUP_TARGETS)
def test_group_target_clean(name):
    rep = driver.run_target(f"group/{name}")
    assert not rep, [str(f) for f in rep]


def test_cli_report_and_baseline(tmp_path, capsys):
    report, base = tmp_path / "report.json", tmp_path / "base.json"
    assert main(["--targets", "heat/step[nohide]", "kernels/library",
                 "--report", str(report)]) == 0
    out = capsys.readouterr().out
    assert "PASS: no new findings" in out and "TOTAL: clean" in out
    data = json.loads(report.read_text())
    assert data["version"] == 1 and sorted(data["targets"]) == ["heat/step[nohide]",
                                                                "kernels/library"]
    assert main(["--targets", "heat/step[nohide]", "--baseline", str(base),
                 "--write-baseline"]) == 0
    assert json.loads(base.read_text()) == {"version": 1, "findings": []}
    assert main(["--targets", "heat/step[nohide]", "--baseline", str(base)]) == 0

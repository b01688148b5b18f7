"""One short run of every one-card cell through the command the checker
runs, on a CUDA card (skips without one):

    python -m pytest -m cuda qoabench/tests/test_qoabench_card.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fixture-transcode", "esc50-transcode", "esc50-encode"])
@pytest.mark.parametrize("traced", [0, 1])
def test_short_run_is_correct(card, workload, traced):
    p = subprocess.run([sys.executable, "-m", "qoabench.run", "--workload", workload,
                        "--seed", str(2**31 + 99), "--seconds", "2", "--trace", str(traced)],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, p.stderr[-4000:]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"] and list(r)[-1] == "checks"
    if traced:
        assert r["device"]["busy_s"] > 0
        assert all(m["value"] <= 105 for n, m in r["metrics"].items() if "roofline" in n)

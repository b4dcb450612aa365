"""``repro_torch.launch.serve.run_serving_sim`` (the port's own copy of the
simulation loop, over its ``build_overlay`` on the CPU) against the
reference's ``benchmarks/serving_sim.run_serving_sim``: the same output
dict at 40 requests, rate 2.0, seed 1.  The port seeds Python's global
``random`` (the nodes' first sync delay) with the run's seed before it
builds the overlay; the reference is seeded the same way before its call.
All 12 cells take ~5 minutes on one core, so the four workloads run in
mode ``full`` and ``Mixed`` in every mode."""
import random
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.serving_sim import run_serving_sim as jrun  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SEED = 1
CELLS = [(w, "full") for w in ("ToolUse", "Coding", "LongQA", "Mixed")] + \
    [("Mixed", "lb_only"), ("Mixed", "none")]


@pytest.mark.parametrize("workload,mode", CELLS)
def test_run_serving_sim_equals_reference(workload, mode):
    random.seed(SEED)
    want = jrun(workload, mode, 2.0, n_requests=40, seed=SEED)
    got = serve.run_serving_sim(workload, mode, 2.0, n_requests=40, seed=SEED,
                                device="cpu")
    assert got == want
    assert got["completed"] == 40


def test_cli_choices_and_default_device():
    assert list(serve.WORKLOADS) == ["ToolUse", "Coding", "LongQA", "Mixed"]
    assert serve.MODES == ("full", "lb_only", "none")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.run_serving_sim("Coding", "none", 2.0, n_requests=2)

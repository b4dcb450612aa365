"""The harness end to end on the CPU: tiny cells made of new files alone,
driven through set-up, the open and the closed loop, the readers and the
check; and the plain reference against the port in float32."""
import hashlib
import time

import pytest

torch = pytest.importorskip("torch")

import tiny_cells  # noqa: E402
from harness import cell, program, spec, weights  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    with tiny_cells.one_thread():
        yield tiny_cells.make(tmp_path_factory.mktemp("portbench"))


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_alone(tiny):
    """Every file of this folder is in the copy unchanged; the tiny cells
    added files and entries only."""
    mine = {k: v for k, v in _digests(tiny_cells.HERE).items()
            if not k.name.startswith("test_")}
    theirs = _digests(tiny)
    assert all(theirs[k] == v for k, v in mine.items())
    added = set(theirs) - set(mine)
    assert {p.parts[0] for p in added} == {"configs", "traffic", "checks"}
    c = spec.cell(tiny.parent, "tiny_moe_open", tiny)
    assert c.traffic["loop"] == "open" and c.config["port"]["moe"]["num_experts"] == 4
    assert {m["name"] for m in c.end_to_end} == {"ttft_p90_s", "itl_p95_ms", "setup_s"}


@pytest.mark.parametrize("port", [tiny_cells.MOE, tiny_cells.DENSE], ids=["moe", "dense"])
def test_reference_agrees_with_the_port_in_f32(port):
    """The port's full forward (``LM.apply``) and the plain reference, on
    the benchmark's weights, at every position."""
    ref = spec.reference(tiny_cells.HERE, "decoder")
    cfg = program.arch_config("tiny", port)
    w = weights.draw(port, 2**31 + 17, torch.device("cpu"), torch.float32)
    toks = torch.randint(2, port["vocab"], (2, 50), generator=torch.Generator().manual_seed(3))
    got = program.LM(cfg, "cpu").apply(w, toks)
    want = ref.logits(port, w, toks.tolist(), [0, 0])
    for i in range(2):
        torch.testing.assert_close(got[i], want[i], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", sorted(tiny_cells.CELLS))
def test_a_tiny_cell_runs_and_is_correct(tiny, name):
    out = cell.run(tiny.parent, name, 2**31 + 5, 0.5, False, "cpu", time.monotonic(),
                   bench_dir=tiny)
    assert out["correct"], out["check"]
    assert all(value <= 1e-3 for value, _ in out["check"].values()), out["check"]
    metrics = out["line"]["metrics"]
    assert "setup_s" in metrics and len(metrics) >= 2
    assert out["line"]["attempted"] > 0 and out["served"] > 0
    # requests admitted in the window are among those checked
    assert 0 < out["scored"]["late_tokens"] <= out["scored"]["scored_tokens"]
    assert 0 < out["arena"]["peak_pages_used"] <= out["arena"]["pages"]

"""The control at a size a test run holds: the plain reference computed with
float8 operands, in the program's place, comes out not correct under the
cell's limits, through the same ``check.verdict`` as a run; the program
comes out correct.

The real cells' limits are set on the card at their own sizes, where
``control.py`` shows the control not correct under them (PERF.md gives the
readings).  The tiny cells carry limits of their own, set at this size
(``tiny_cells``)."""
import pytest

torch = pytest.importorskip("torch")

import tiny_cells  # noqa: E402
from harness import cell, check, spec  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    with tiny_cells.one_thread():
        yield tiny_cells.make(tmp_path_factory.mktemp("portbench_control"))


@pytest.mark.parametrize("name", sorted(tiny_cells.CELLS))
def test_the_float8_reference_is_not_correct(tiny, name):
    c = spec.cell(tiny.parent, name, tiny)
    b = cell.build(c, c.config["port"], 2**31 + 3, 1.0, False, torch.device("cpu"))
    win = cell.drive(b, c, 1.0)
    pairs = check.sample(cell.served_requests(b.sv, win["t0"]), 2**31 + 3,
                         c.check["sample_tokens"])
    got = check.compare(spec.reference(tiny, "decoder"), c.config["port"], b.w, pairs,
                        control=True)
    limits = c.check["limits"]
    _, correct = check.verdict(got | {"short_answers": cell.short_answers(b.sv)}, limits)
    low = got["control"] | {"short_answers": 0, "scored_tokens": got["scored_tokens"]}
    numbers, low_correct = check.verdict(low, limits)
    assert correct and not low_correct, numbers

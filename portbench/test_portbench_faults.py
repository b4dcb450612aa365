"""``correct`` comes out false when the timed path is broken underneath:
the harness runs a tiny cell on the CPU (no look for a card), held to its
limits (``tiny_cells``), with each fault a served model can have planted in
the program.  One card serves a model node, so no exchange between chips
exists to leave out."""
import time

import pytest

torch = pytest.importorskip("torch")

import tiny_cells  # noqa: E402
from harness import cell  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    with tiny_cells.one_thread():
        yield tiny_cells.make(tmp_path_factory.mktemp("portbench_faults"))


def _state_unchanged(mp):
    """Decoding writes no K/V: every step leaves the cache as it was."""
    mp.setattr(attention, "update_paged_cache", lambda ka, va, *a, **kw: (ka, va))


def _half_batch(mp):
    """The decode computes the first half of its rows; the others get the
    mean of those rows' logits."""
    decode = LM.decode_paged

    def half(self, *a, **kw):
        logits, arena = decode(self, *a, **kw)
        h = max(1, logits.shape[0] // 2)
        logits = logits.clone()
        logits[h:] = logits[:h].mean(0)
        return logits, arena
    mp.setattr(LM, "decode_paged", half)


def _token_altered(mp):
    """The greedy token is altered where it is produced."""
    argmax = Scheduler._argmax

    def altered(logits):
        return (argmax(logits) + 1) % logits[0].shape[-1]
    mp.setattr(Scheduler, "_argmax", staticmethod(altered))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", sorted(tiny_cells.CELLS))
def test_a_broken_step_is_not_correct(tiny, name, fault, monkeypatch):
    fault(monkeypatch)
    out = cell.run(tiny.parent, name, 2**31 + 99, 0.5, False, "cpu", time.monotonic(),
                   bench_dir=tiny)
    assert not out["correct"], out["check"]

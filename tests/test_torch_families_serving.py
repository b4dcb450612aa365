"""Port parity on the CPU for paged serving of the decoder-only families
of ``tests/test_torch_families.py``, reduced: ``test_torch_serving.py``'s
scenarios on the JAX engine and on the port's engine with the same
weights; tokens, every engine counter and the scheduler's metrics
identical.  ``h2o-danube-1.8b`` (a window on every layer) runs every
scenario, speculative decoding included, but ``dense_pool_memory``: its
dense cache is a ring of ``window`` slots a row, which the scenario's
bound (paged under a quarter of the dense pool) does not take into
account.  The other five run the paged scenarios without speculation,
the dense slot pool against the paged one, and ``dense_pool_memory``."""
import pytest

pytest.importorskip("torch")

from test_torch_serving import (SCENARIOS, _stacks, allocator_pressure,  # noqa: E402
                                batched_vs_sequential, dense_pool_memory,
                                dense_scheduler_vs_paged, prefix_hit_vs_cold)

NONSPEC = [batched_vs_sequential, prefix_hit_vs_cold, allocator_pressure,
           dense_scheduler_vs_paged, dense_pool_memory]
CASES = ([("h2o-danube-1.8b", s) for s in SCENARIOS if s is not dense_pool_memory]
         + [(name, s) for name in ("gemma2-9b", "yi-34b", "granite-20b",
                                   "dbrx-132b", "moonshot-v1-16b-a3b")
            for s in NONSPEC])
_STACKS = {}


def _stacks_of(name):
    if name not in _STACKS:
        _STACKS[name] = _stacks(name)
    return _STACKS[name]


@pytest.mark.parametrize("name,scenario", CASES,
                         ids=[f"{n}-{s.__name__}" for n, s in CASES])
def test_scenario_matches_reference(name, scenario):
    st = _stacks_of(name)
    assert scenario(st["torch"]) == scenario(st["jax"])

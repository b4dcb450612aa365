"""Port parity on the CPU for serving: scenarios of ``test_paged_kv.py``,
``test_batched_decode.py`` and ``test_spec_decode.py`` re-run on the JAX
engine and on the port's engine with the same weights, on the paged pool
and on the dense slot pool (``paged=False``, and the recurrent jamba and
xlstm, which cannot page).  Tokens, engine counters and scheduler metrics must be
identical."""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tscheduler  # noqa: E402

NAME = "gentorrent-llama3-8b"
COUNTERS = ("prefill_dispatches", "prefill_tokens", "spec_dispatches",
            "spec_drafted", "spec_accepted", "spec_tokens",
            "spec_draftless_rounds", "batched_traces",
            "batched_prefill_traces", "spec_traces")


def _stacks(name):
    jcfg = base.get_config(name).reduced()
    tcfg = configs.get_config(name).reduced()
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")

    def jax_engine(spec=False, **kw):
        cfg = dataclasses.replace(jcfg, spec_enabled=spec, spec_k=4)
        return jengine.RealEngine(cfg, build_model(cfg), jparams, **kw)

    def torch_engine(spec=False, **kw):
        cfg = dataclasses.replace(tcfg, spec_enabled=spec, spec_k=4)
        return tengine.RealEngine(cfg, LM(cfg, device="cpu"), tparams,
                                  device="cpu", **kw)

    return {
        "jax": types.SimpleNamespace(cfg=jcfg, engine=jax_engine,
                                     Request=jengine.Request,
                                     Scheduler=jscheduler.Scheduler),
        "torch": types.SimpleNamespace(cfg=tcfg, engine=torch_engine,
                                       Request=tengine.Request,
                                       Scheduler=tscheduler.Scheduler),
    }


@pytest.fixture(scope="module")
def stacks():
    return _stacks(NAME)


@pytest.fixture(scope="module")
def hybrid_stacks():
    return _stacks("jamba-v0.1-52b")


@pytest.fixture(scope="module")
def xlstm_stacks():
    return _stacks("xlstm-1.3b")


def _counters(eng, sched=None):
    c = {k: getattr(eng, k) for k in COUNTERS}
    c["paged"] = eng.paged
    if eng.paged:
        c["used_pages"] = eng.allocator.used_count
        eng.allocator.check()
    if sched is not None:
        c.update(sched.metrics)
        c["kv_bytes_in_use"] = sched.kv_bytes_in_use()
    return c


def _serve(st, eng, prompts, max_active, max_new, eos=-1):
    s = st.Scheduler(eng, max_active=max_active)
    for i, p in enumerate(prompts):
        s.submit(st.Request(i, p, max_new=max_new, eos_id=eos))
    return {r.req_id: r.output for r in s.run()}, _counters(eng, s)


def _prompts(vocab, n, lengths):
    return [[(37 * i + j) % vocab for j in range(lengths[i % len(lengths)])]
            for i in range(n)]


def _mixed_prompts(vocab):
    rep = [5, 9, 2, 7] * 10
    return [rep, [(37 + j) % vocab for j in range(20)], rep[:36],
            [(111 + j) % vocab for j in range(44)], [3] * 30,
            [(185 + j) % vocab for j in range(33)]]


# ---------------------------------------------------------------- scenarios
def batched_vs_sequential(st):
    prompts = _prompts(st.cfg.vocab, 6, (20, 40, 36, 20, 44))
    seq = st.engine(max_len=128)
    ref = {i: seq.generate(st.Request(i, p, max_new=8)).output
           for i, p in enumerate(prompts)}
    out, c = _serve(st, st.engine(max_len=128), prompts, 4, 8)
    assert out == ref
    return out, c, _counters(seq)


def prefix_hit_vs_cold(st):
    shared = [7] * 40
    cold = st.engine(max_len=128)
    a = cold.generate(st.Request(0, shared + [1, 2, 3], max_new=6))
    eng = st.engine(max_len=128)
    eng.generate(st.Request(1, shared + [9, 9], max_new=6))
    r = eng.generate(st.Request(2, shared + [1, 2, 3], max_new=6))
    assert r.cached_tokens >= 32 and r.output == a.output
    # full block-aligned hit: query-only replay of the last prompt token
    full = eng.generate(st.Request(3, [11] * 64, max_new=3)).output
    again = eng.generate(st.Request(4, [11] * 64, max_new=3))
    assert again.cached_tokens == 64 and again.output == full
    return (a.output, r.output, full), _counters(cold), _counters(eng)


def spec_vs_nonspec(st):
    prompts = _mixed_prompts(st.cfg.vocab)
    ref, c0 = _serve(st, st.engine(max_len=128), prompts, 4, 24)
    out, c1 = _serve(st, st.engine(spec=True, max_len=128), prompts, 4, 24)
    assert out == ref and c1["spec_accepted"] > 0 and c1["spec_traces"] == 1
    return out, c0, c1


def spec_draftless_fallback(st):
    prompts = [[(29 * (i + 1) + j) % st.cfg.vocab for j in range(17 + 5 * i)]
               for i in range(2)] + [[5, 9, 2, 7] * 10]
    ref, c0 = _serve(st, st.engine(max_len=128), prompts, 3, 16)
    out, c1 = _serve(st, st.engine(spec=True, max_len=128), prompts, 3, 16)
    assert out == ref and c1["spec_draftless_rounds"] > 0
    assert c1["spec_traces"] == 1 and c1["batched_traces"] == 1
    return out, c0, c1


def spec_prefix_hit_and_eos(st):
    shared = [3] * 64
    eng = st.engine(spec=True, max_len=128)
    first, _ = _serve(st, eng, [shared + [5]], 2, 2)
    s = st.Scheduler(eng, max_active=2)
    s.submit(st.Request(1, shared + [8] * 4, max_new=12))
    hit = s.run()[0].output
    base_out = st.engine(max_len=128).generate(
        st.Request(0, [5, 9, 2, 7] * 10, max_new=24)).output
    eos_out, c = _serve(st, st.engine(spec=True, max_len=128),
                        [[5, 9, 2, 7] * 10], 2, 24, eos=base_out[7])
    assert eos_out[0][-1] == base_out[7]
    return (first, hit, eos_out), _counters(eng), c


def allocator_pressure(st):
    eng = st.engine(max_len=128, num_pages=13)
    outs = [eng.generate(st.Request(i, [(53 * i + j) % st.cfg.vocab
                                        for j in range(40)], max_new=6)).output
            for i in range(6)]
    assert all(len(o) == 6 for o in outs)
    return outs, _counters(eng), eng.prefix_cache.hits


def midstream_and_near_max_len(st):
    prompts = _prompts(st.cfg.vocab, 4, (20, 40, 36, 20, 44))
    eng = st.engine(max_len=128)
    s = st.Scheduler(eng, max_active=3)
    for i in range(2):
        s.submit(st.Request(i, prompts[i], max_new=10))
    for _ in range(3):
        s.step()
    for i in range(2, 4):
        s.submit(st.Request(i, prompts[i], max_new=10))
    out = {r.req_id: r.output for r in s.run()}
    near, c = _serve(st, st.engine(spec=True, max_len=48), [[4, 6] * 16], 2, 40)
    return out, _counters(eng, s), near, c


def dense_generate_vs_paged(st):
    """test_paged_kv.py::test_paged_generate_matches_dense."""
    dense = st.engine(max_len=128, paged=False)
    paged = st.engine(max_len=128)
    assert paged.paged and not dense.paged
    outs = []
    for i, p in enumerate(_prompts(st.cfg.vocab, 5, (20, 40, 36, 33, 64))):
        rd = dense.generate(st.Request(i, p, max_new=8))
        rp = paged.generate(st.Request(i, p, max_new=8))
        assert rd.output == rp.output
        outs.append((rd.output, rd.cached_tokens))
    return outs, _counters(dense), _counters(paged)


def dense_scheduler_vs_paged(st):
    """test_paged_kv.py::test_paged_scheduler_matches_dense_scheduler."""
    prompts = _prompts(st.cfg.vocab, 6, (20, 40, 36, 33, 64))
    ref, c0 = _serve(st, st.engine(max_len=128, paged=False), prompts, 3, 8)
    out, c1 = _serve(st, st.engine(max_len=128), prompts, 3, 8)
    assert out == ref and c0["batched_traces"] == c1["batched_traces"] == 1
    return out, c0, c1


def dense_pool_memory(st):
    """test_paged_kv.py::test_pool_memory_scales_with_live_tokens."""
    sd = st.Scheduler(st.engine(max_len=128, paged=False), max_active=4)
    sp = st.Scheduler(st.engine(max_len=128), max_active=4)
    for s in (sd, sp):
        s.submit(st.Request(0, [5] * 20, max_new=4))
        s.step()                                       # one slot occupied
    used = (sd.kv_bytes_in_use(), sp.kv_bytes_in_use())
    assert used[1] < used[0] / 4
    return used, [r.output for r in sd.run() + sp.run()]


SCENARIOS = [batched_vs_sequential, prefix_hit_vs_cold, spec_vs_nonspec,
             spec_draftless_fallback, spec_prefix_hit_and_eos,
             allocator_pressure, midstream_and_near_max_len,
             dense_generate_vs_paged, dense_scheduler_vs_paged,
             dense_pool_memory]


def recurrent_batched_vs_sequential(st):
    """test_batched_decode.py::test_batched_matches_sequential_recurrent:
    the slot pool gives the sequential engine's tokens, and its one pool
    decode sees one input shape across occupancies."""
    prompts = [[(11 * i + j) % st.cfg.vocab for j in range(12)]
               for i in range(3)]
    seq = st.engine(max_len=64)
    ref = {i: seq.generate(st.Request(i, p, max_new=5)).output
           for i, p in enumerate(prompts)}
    out, c = _serve(st, st.engine(max_len=64), prompts, 2, 5)
    assert out == ref and c["batched_traces"] == 1 and not c["paged"]
    return out, c, _counters(seq)


def recurrent_long_prompts_and_eos(st):
    """Prompts past a block and past the Mamba chunk (boot prefill, then a
    teacher-forced decode per token; a recurrent model never reuses a
    prefix), a short prompt fully covered by the boot, and an eos stop."""
    prompts = [[(7 * i + 3 * j) % st.cfg.vocab for j in range(n)]
               for i, n in enumerate((40, 5, 33, 70))]
    eng = st.engine(max_len=128)
    first, c = _serve(st, eng, prompts, 3, 6)
    again, c2 = _serve(st, eng, prompts[:2], 2, 6)
    eos, c3 = _serve(st, st.engine(max_len=128), prompts[:1], 2, 6,
                     eos=first[0][2])
    assert again == {i: first[i] for i in range(2)} and eos[0] == first[0][:3]
    return first, c, c2, eos, c3


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(stacks, scenario):
    assert scenario(stacks["torch"]) == scenario(stacks["jax"])


@pytest.mark.parametrize("scenario", [recurrent_batched_vs_sequential,
                                      recurrent_long_prompts_and_eos],
                         ids=lambda f: f.__name__)
def test_hybrid_scenario_matches_reference(hybrid_stacks, scenario):
    assert scenario(hybrid_stacks["torch"]) == scenario(hybrid_stacks["jax"])


@pytest.mark.parametrize("scenario", [recurrent_batched_vs_sequential,
                                      recurrent_long_prompts_and_eos],
                         ids=lambda f: f.__name__)
def test_xlstm_scenario_matches_reference(xlstm_stacks, scenario):
    """The first is test_batched_decode.py:69-83's xlstm case."""
    assert scenario(xlstm_stacks["torch"]) == scenario(xlstm_stacks["jax"])


def test_xlstm_engine_never_speculates(xlstm_stacks):
    """test_spec_decode.py:232: with ``spec_enabled`` the xlstm engine
    still does not speculate (no per-position KV to roll back)."""
    for st in xlstm_stacks.values():
        eng = st.engine(spec=True, max_len=64)
        assert not eng.spec and not eng.paged
        assert not st.Scheduler(eng).spec


def test_step_issues_one_pool_dispatch(stacks):
    """Every spec round is ONE pool dispatch (verify or fallback decode),
    never a per-request decode."""
    st = stacks["torch"]
    eng = st.engine(spec=True, max_len=128)
    s = st.Scheduler(eng, max_active=3)
    for i in range(3):
        s.submit(st.Request(i, [7, 2] * 6 + [i], max_new=9))
    s.step()
    calls = []
    for name in ("_verify_paged_batched", "_decode_batched"):
        real = getattr(eng, name)
        setattr(eng, name, lambda *a, _r=real: calls.append(1) or _r(*a))

    def _no_single(*a):
        raise AssertionError("per-request decode dispatched from step()")
    eng._decode_paged = _no_single
    while s.active:
        n0 = len(calls)
        s.step()
        assert len(calls) - n0 == (1 if s.active else 0)
    assert calls and s.metrics["completed"] == 3
    assert eng.spec_traces == 1


@pytest.mark.parametrize("mixer", ["cross_attn"])
def test_unported_families_raise(mixer):
    """A config with cross-attention runs through ``LM.prefill(aux)`` and
    ``LM.decode`` (``tests/test_torch_encdec.py``), not the engine: neither
    package's ``RealEngine`` passes ``aux`` to the model, so both raise
    ``KeyError`` on the missing memory (ROADMAP queue 3)."""
    name = "llama-3.2-vision-11b"
    assert any(s.mixer == mixer for s in configs.get_config(name).pattern)
    st = _stacks(name)
    for side in ("jax", "torch"):
        eng = st[side].engine(max_len=64)
        assert not eng.paged
        with pytest.raises(KeyError, match="image_embeds"):
            eng.generate(st[side].Request(0, [1, 2, 3], max_new=2))

"""The yardstick's arithmetic against hand-worked values, and the readers
that divide it by a run's time."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from harness import bounds, readers, served, spec  # noqa: E402
from harness.spans import Call  # noqa: E402

DBRX = spec.load_json(spec.HERE / "configs" / "dbrx-132b-l8.json")["port"]
YI = spec.load_json(spec.HERE / "configs" / "yi-34b-l30.json")["port"]


def test_active_weights_per_token_and_layer():
    # yi: 7168*56*128 (q) + 2*7168*8*128 (k, v) + 56*128*7168 (o) + 3*7168*20480
    assert bounds.matmul_params(YI) == 102_760_448 + 14_680_064 + 440_401_920
    # dbrx: attention at 48 heads, the router, 4 of 16 SwiGLU experts of 10752
    assert bounds.matmul_params(DBRX) == 75_497_472 + 12_582_912 + 98_304 + 792_723_456
    # one token at context 1000 through yi's 30 layers, plus a logit row
    assert bounds.token_flops(YI, 1000) == 30 * (2 * 557_842_432 + 4 * 56 * 128 * 1000)
    assert bounds.logit_flops(YI) == 2 * 7168 * 64000
    # a chunk of 3 tokens at 64: contexts 65, 66, 67
    assert bounds.chunk_flops(YI, 64, 3) == sum(bounds.token_flops(YI, c) for c in (65, 66, 67))


def test_kernel_costs_by_hand():
    # one decode row of 1000 keys, dbrx's heads: q + out, K + V, 32 page ids, its length
    nbytes, flops = bounds.decode_cost([1000, 0], 48, 8, 128, 2)
    assert nbytes == 2 * 48 * 128 * 2 + 2 * 1000 * 8 * 128 * 2 + 4 * 32 + 4 == 4_120_708
    assert flops == 4 * 48 * 128 * 1000
    # one flash row: 20 real queries from position 64
    nbytes, flops = bounds.flash_cost([(64, 20)], 56, 8, 128, 2)
    assert nbytes == 2 * 20 * 56 * 128 * 2 + 8 + 2 * 84 * 8 * 128 * 2 + 4 * 3
    assert flops == 4 * 56 * 128 * sum(64 + i + 1 for i in range(20))
    assert bounds.least_s(3.35e12, 1.0) == 1.0
    assert bounds.least_s(1.0, 989e12) == 1.0


def test_costs_agree_with_the_frozen_arithmetic_on_live_full_chunks():
    """Where every row is live and every chunk full, the counts equal the
    frozen chip_smoke arithmetic."""
    pos0, n = torch.tensor([0, 256, 512, 960]), torch.tensor([32, 32, 32, 32])
    want = bounds._paged_flash_cost(pos0, n, 32, 48, 8, 128, 2)
    assert bounds.flash_cost([(p, 32) for p in pos0.tolist()], 48, 8, 128, 2) == want
    lengths = torch.tensor([1000, 517, 1, 33])
    assert bounds.decode_cost(lengths.tolist(), 48, 8, 128, 2)[0] == \
        bounds._paged_decode_bytes(lengths, 48, 8, 128, 2)


def _record(port, calls, trace):
    spans = SimpleNamespace(calls=calls, within=lambda name, a, b: [
        c for c in calls[name] if a <= c.t0 <= b])
    return served.Record(t0=0.0, t_end=10.0, t_exit=10.0, setup_s=1.0, served=None,
                         counters=({}, {}), port=port, node={"max_active": 2}, traffic={},
                         spans=spans, trace=trace)


def test_readers_divide_the_bound_by_the_run():
    port = dict(YI, n_layers=2)
    dec = Call("decode_paged", 1.0, 1.01, ms=10.0,
               args={"pos": [999, 5], "active": [True, False], "rows": 2})
    pre = Call("prefill_paged", 2.0, 2.05, ms=50.0,
               args={"pos0": [0, 64], "active": [False, True], "rows": 2})
    adm = Call("prefill_requests", 1.9, 2.1, ms=60.0,
               args={"req_ids": [7, 8], "lengths": [10, 84], "matched": [10, 64],
                     "grid": 2, "calls": (0, 1)})
    trace = {"by_name": {"void split_decode::decode_kernel<__nv_bfloat16, true>(Args)": 1e-3,
                         "void (anonymous namespace)::tc_kernel<true, 128, 2>(Args)": 2e-3,
                         "nvjet_gemm": 5.0},
             "busy_s": 4.0, "window_s": 10.0, "gaps": []}
    rec = _record(port, {"decode_paged": [dec], "prefill_paged": [pre],
                         "prefill_requests": [adm]}, trace)
    # the prefill call's one live row: 20 real tokens from 64, ending its prompt
    assert readers.prefill_rows(rec) == [(pre, [(64, 20, True)])]
    least_dec = 2 * bounds.least_s(*bounds.decode_cost([1000], 56, 8, 128, 2))
    assert readers.decode_roofline_pct(rec) == pytest.approx(100 * least_dec / 1e-3)
    least_fl = 2 * bounds.least_s(*bounds.flash_cost([(64, 20)], 56, 8, 128, 2))
    assert readers.flash_roofline_pct(rec) == pytest.approx(100 * least_fl / 2e-3)
    useful = (bounds.token_flops(port, 1000) + bounds.chunk_flops(port, 64, 20)
              + 2 * bounds.logit_flops(port))
    assert readers.mfu_pct(rec) == pytest.approx(100 * useful / (0.06 * 989e12))
    assert readers.idle_pct(rec) == pytest.approx(60.0)
    assert readers.mean_ms(rec, "decode_paged") == 10.0
    # nothing traced: no roofline, never a 0
    empty = _record(port, {"decode_paged": [], "prefill_paged": [],
                           "prefill_requests": []}, None)
    assert readers.decode_roofline_pct(empty) is None and readers.mfu_pct(empty) is None

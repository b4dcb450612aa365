"""What the metric readers (``metrics/<name>.py``) share.  Each returns
None where the run holds nothing to read (a reader never reports 0 for a
share of a roofline or of a peak)."""
from __future__ import annotations

import torch

from harness import bounds

# the device kernels behind the two paged wrappers, by demangled or mangled
# name (chip_smoke.py's PAGED_KERNELS)
FLASH_PAGED = ("tc_kernel<true", "tc_kernelILb1E", "scalar_kernel<true", "scalar_kernelILb1E")
PAGED_DECODE = ("decode_kernel<__nv_bfloat16, true>", "decode_kernel<float, true>",
                "decode_kernelI13__nv_bfloat16Lb1E", "decode_kernelIfLb1E")


# ---------------------------------------------------------------------------
# host clock
# ---------------------------------------------------------------------------
def ttft_s(rec) -> list:
    """Due time to first token, each request due in the window; one with
    no first token by the window's end counts the time it has waited."""
    out = []
    for r in rec.due_in_window():
        first = r.times[0] if r.times and r.times[0] <= rec.t_end else None
        out.append((first if first is not None else rec.t_end) - r.due)
    return out


def token_gaps_s(rec) -> list:
    """Every gap between successive tokens of a request, both inside the
    window."""
    out = []
    for r in rec.served.reqs.values():
        ts = [t for t in r.times if rec.t0 <= t <= rec.t_end]
        out += [b - a for a, b in zip(ts, ts[1:])]
    return out


def tokens_in_window(rec) -> int:
    """Tokens served by the window's steps: from its start to the return
    of its last step (``t_exit``), which may come after ``t_end``."""
    return sum(sum(rec.t0 <= t <= rec.t_exit for t in r.times) for r in rec.served.reqs.values())


def queue_wait_s(rec) -> list:
    """Due time to the ``prefill_requests`` call that admitted the request,
    each request due in the window; one not admitted by the window's end
    counts the time it has waited."""
    admitted = {}
    for c in rec.spans.calls["prefill_requests"] if rec.spans else []:
        for rid in c.args["req_ids"]:
            admitted.setdefault(rid, c.t0)
    out = []
    for rid, r in rec.served.reqs.items():
        if rec.t0 <= r.due < rec.t_end:
            t = admitted.get(rid)
            out.append((t if t is not None and t <= rec.t_end else rec.t_end) - r.due)
    return out


# ---------------------------------------------------------------------------
# spans: the model-step calls and the work each needs
# ---------------------------------------------------------------------------
def live_rows(call) -> list:
    """Row indices a call computes for: its live-row mask, or every row."""
    act = call.args.get("active")
    return [i for i in range(call.args["rows"]) if act is None or act[i]]


def prefill_rows(rec) -> list:
    """For each ``prefill_paged`` call in the window: (call, [(pos0, real
    tokens, ends the prompt)] of its live rows), the real tokens worked
    out from the admission that made the call: row i of step s holds
    min(32, suffix_i - 32 s) of request i's suffix past its prefix hit."""
    calls = rec.spans.calls["prefill_paged"] if rec.spans else []
    plan = {}
    for adm in rec.spans.calls["prefill_requests"] if rec.spans else []:
        lo, hi = adm.args["calls"]
        for s, k in enumerate(range(lo, hi)):
            rows = {}
            for i, (n, m) in enumerate(zip(adm.args["lengths"], adm.args["matched"])):
                left = n - m - bounds.BLK * s
                if left > 0:
                    rows[i] = (m + bounds.BLK * s, min(bounds.BLK, left), left <= bounds.BLK)
            plan[k] = rows
    out = []
    for k, c in enumerate(calls):
        if not (rec.t0 <= c.t0 <= rec.t_exit):
            continue
        rows = plan.get(k)
        if rows is None:        # not made by an admission: whole chunks
            rows = {i: (c.args["pos0"][i], bounds.BLK, True) for i in live_rows(c)}
        out.append((c, [rows[i] for i in live_rows(c) if i in rows]))
    return out


def decode_rows(rec) -> list:
    """For each ``decode_paged`` call in the window: (call, the keys each
    live row attends: its position + 1)."""
    return [(c, [c.args["pos"][i] + 1 for i in live_rows(c)]) for c in rec.calls("decode_paged")]


def mean_ms(rec, name: str):
    calls = rec.calls(name)
    return sum(c.ms for c in calls) / len(calls) if calls else None


def model_flops(rec, prefill=True, decode=True) -> tuple:
    """(useful FLOPs, CUDA-event seconds) of the window's model-step calls:
    the active weights, attention over each token's context, one logit row
    per request whose prompt ends in the chunk and per decoded token."""
    port, flops, secs = rec.port, 0, 0.0
    if prefill:
        for c, rows in prefill_rows(rec):
            secs += c.ms / 1e3
            for p, n, ends in rows:
                flops += bounds.chunk_flops(port, p, n) + ends * bounds.logit_flops(port)
    if decode:
        for c, lengths in decode_rows(rec):
            secs += c.ms / 1e3
            flops += sum(bounds.token_flops(port, n) + bounds.logit_flops(port) for n in lengths)
    return flops, secs


def mfu_pct(rec, prefill=True, decode=True):
    flops, secs = model_flops(rec, prefill, decode)
    return 100.0 * flops / (secs * bounds.PEAK_BF16) if secs > 0 and flops > 0 else None


# ---------------------------------------------------------------------------
# device trace
# ---------------------------------------------------------------------------
def kernel_s(rec, patterns) -> float:
    if not rec.trace:
        return 0.0
    return sum(s for name, s in rec.trace["by_name"].items() if any(p in name for p in patterns))


def _esize(port) -> int:
    return torch.empty((), dtype=getattr(torch, port.get("dtype", "bfloat16"))).element_size()


def flash_roofline_pct(rec, kernels=FLASH_PAGED):
    """The paged flash entry's least time over every launch in the window
    (one a layer of each ``prefill_paged`` call), over the device time of
    the kernels whose names hold one of ``kernels``."""
    port = rec.port
    least = sum(port["n_layers"] * bounds.least_s(*bounds.flash_cost(
        [(p, n) for p, n, _ in rows], port["n_heads"], port["n_kv_heads"], port["d_head"],
        _esize(port))) for _, rows in prefill_rows(rec) if rows)
    dev = kernel_s(rec, kernels)
    return 100.0 * least / dev if dev > 0 and least > 0 else None


def decode_roofline_pct(rec, kernels=PAGED_DECODE):
    """The paged decode's least time over every launch in the window (one
    a layer of each ``decode_paged`` call), over the device time of the
    kernels whose names hold one of ``kernels``."""
    port = rec.port
    least = sum(port["n_layers"] * bounds.least_s(*bounds.decode_cost(
        lengths, port["n_heads"], port["n_kv_heads"], port["d_head"], _esize(port)))
        for _, lengths in decode_rows(rec) if lengths)
    dev = kernel_s(rec, kernels)
    return 100.0 * least / dev if dev > 0 and least > 0 else None


def idle_pct(rec):
    t = rec.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None


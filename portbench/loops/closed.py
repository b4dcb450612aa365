"""Closed loop: ``clients`` callers, each sending its next request the
moment its last one finished (no think time), so the node always holds a
standing queue and schedules deterministically.

Every client sends at the start; the lead-in is the first step, which
admits the first wave (the mix draws its answers from the residual
distribution, so the wave finishes as a steady stream would).  The
window opens when that step returns.
"""
import time


def run(ctx) -> dict:
    served, mix = ctx.served, ctx.mix
    n = len(mix.shapes)
    nxt = 0

    def send():
        nonlocal nxt
        if nxt >= n:
            raise RuntimeError("the closed loop ran out of requests")
        served.submit(nxt, mix.prompt(nxt), mix.shapes[nxt].answer)
        nxt += 1

    def refill(done: int) -> int:
        for _ in served.finished[done:]:
            send()
        return len(served.finished)

    for _ in range(ctx.traffic["arrivals"]["clients"]):
        send()
    ctx.begin()
    served.step()                          # the lead-in: the first wave
    done = refill(0)
    t0 = time.monotonic()
    t_end = t0 + ctx.seconds
    at_t0 = ctx.snapshot()
    while time.monotonic() < t_end:
        served.step()
        done = refill(done)
    return {"t0": t0, "t_end": t_end, "t_exit": time.monotonic(), "at_t0": at_t0}

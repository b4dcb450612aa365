"""Open loop: requests are sent on their schedule (Poisson arrivals from
the mix), whatever the system's state, so a queue can grow.

The schedule starts ``lead_in_s`` before the window, so the window opens
on a loaded node; only requests due inside the window are judged.  Between
steps, every request whose due time has passed is submitted; with nothing
to serve, the loop sleeps until the next one is due.  The last step may
end after the window: what it served then lies outside.
"""
import time


def run(ctx) -> dict:
    served, mix = ctx.served, ctx.mix
    shapes = mix.shapes
    ctx.begin()
    t_start = time.monotonic()
    t0 = t_start + ctx.traffic.get("lead_in_s", 0.0)
    t_end = t0 + ctx.seconds
    at_t0 = None
    i = 0
    while True:
        now = time.monotonic()
        if at_t0 is None and now >= t0:
            at_t0 = ctx.snapshot()
        if now >= t_end:
            break
        while i < len(shapes) and t_start + shapes[i].due <= now:
            served.submit(i, mix.prompt(i), shapes[i].answer, due=t_start + shapes[i].due)
            i += 1
        if not served.pending():
            served.sleep_until(min(t_start + shapes[i].due, t_end) if i < len(shapes) else t_end)
            continue
        served.step()
    if i >= len(shapes):
        raise RuntimeError("the schedule ran out before the window closed")
    return {"t0": t0, "t_end": t_end, "t_exit": time.monotonic(), "at_t0": at_t0}

"""Process start to window start: torch and the card, the weights, the
warm-up (and, in a checkout's first run, the kernels' build), the arena,
the prefix-cache fill and the lead-in; seconds, host clock."""


def read(rec):
    return rec.setup_s

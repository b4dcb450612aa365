"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the run served, drawn from the seed, goes to the plain
reference (``reference/<name>.py``, on the same weights): each prompt with
the tokens served for it, from position 0.  The sample holds the longest
request, the longest of those admitted inside the window, and others in an
order drawn from the seed; a request still active at the close counts with
the tokens it has so far.  At each position that produced a served token,
the gap is the reference's best logit less the reference's logit of the
served token (0 where the program served the reference's own choice).
``verdict`` holds the numbers to the cell's limits (``checks/<cell>.json``):
``gap_max``, the widest gap over the sample, or ``gap_mean``, its mean over
every scored position, and ``short_answers``, the finished requests whose
answer is not the length they asked for (EOS is off), at 0.

The control (``control.py``) reads the same gaps for the token the
reference computed with float8 operands puts first, at the same
positions, and goes through the same ``verdict``.
"""
from __future__ import annotations

import numpy as np
import torch


def sample(served: list, seed: int, want_tokens: int) -> list:
    """``served``: (prompt, tokens, admitted in the window) of every request
    with a token.  The longest (prompt plus tokens), the longest admitted in
    the window, then others in an order drawn from the seed, until the
    sample holds ``want_tokens`` served tokens."""
    if not served:
        return []
    order = sorted(range(len(served)), key=lambda i: -(len(served[i][0]) + len(served[i][1])))
    late = [i for i in order if served[i][2]]
    head = order[:1] + [i for i in late[:1] if i != order[0]]
    rest = [i for i in order if i not in head]
    rest = [rest[i] for i in np.random.default_rng([seed, 3]).permutation(len(rest))]
    picked, n = [], 0
    for i in head + rest:
        picked.append(served[i])
        n += len(served[i][1])
        if n >= want_tokens:
            break
    return picked


def scored(pairs: list) -> tuple:
    """(sequences, first scored position, served tokens): a request's
    prompt and all but its last served token, scored from its last prompt
    position."""
    seqs = [list(p) + list(s[:-1]) for p, s, *_ in pairs]
    first = [len(p) - 1 for p, *_ in pairs]
    return seqs, first, [list(s) for _, s, *_ in pairs]


def gaps(ref_logits: list, tokens: list) -> torch.Tensor:
    """Best reference logit less the reference logit of ``tokens``, at
    every scored position of every sequence."""
    out = []
    for lg, tok in zip(ref_logits, tokens):
        t = torch.as_tensor(tok, device=lg.device, dtype=torch.long)
        out.append(lg.max(-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out)


def compare(reference, port: dict, weights: dict, pairs: list,
            control: bool = False) -> dict:
    """The gaps of the served tokens over ``pairs``: ``gap_max`` and
    ``gap_mean`` over every scored position, ``flips`` where it is not
    the reference's choice, ``scored_tokens`` and ``late_tokens`` (those of
    requests admitted in the window); with ``control``, under
    ``"control"`` the same gaps for the token the float8 reference puts
    first."""
    if not pairs:
        return {"gap_max": float("inf"), "gap_mean": float("inf"), "scored_tokens": 0,
                "late_tokens": 0}
    seqs, first, served = scored(pairs)
    ref = reference.logits(port, weights, seqs, first, "f32")
    out = {**_summary(gaps(ref, served)), "scored_tokens": sum(len(s) for s in served),
           "late_tokens": sum(len(s) for s, (*_, late) in zip(served, pairs) if late)}
    if control:
        low = reference.logits(port, weights, seqs, first, "fp8")
        out["control"] = _summary(gaps(ref, [lg.argmax(-1).tolist() for lg in low]))
    return out


def verdict(got: dict, limits: dict) -> tuple:
    """``({name: [number, limit]}, correct)``: ``correct`` where some token
    was scored and every number the limits name is at or under its limit."""
    numbers = {k: [got[k], lim] for k, lim in limits.items()}
    return numbers, got["scored_tokens"] > 0 and all(v <= lim for v, lim in numbers.values())


def _summary(g) -> dict:
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()), "flips": int((g > 0).sum())}

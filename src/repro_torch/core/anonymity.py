"""Entropy-based anonymity metric + attacker models (Appendix A4, §4.1-4.2).

normalized anonymity = H(S) / log2(N) with the paper's chain-attack source
probabilities:

  Pr(x = src) = 1/(L+1-fL)                      if x in Gamma
                (1 - |Gamma|/(L+1-fL)) / ((1-f)N - |Gamma|)   otherwise

where L = #nodes on the k paths, Gamma = predecessors of maximal chains of
consecutive malicious relays.  The same simulator scores the three systems
of Fig 9 (GenTorrent, onion, garlic-cast) and the confidentiality metric of
Fig 10 (fraction of messages whose content an adversary controlling >= k
paths could decode).

Own copy of ``repro/core/anonymity.py``, byte for byte in what it computes.
"""
from __future__ import annotations

import math
import random


def entropy_from_probs(probs) -> float:
    h = 0.0
    for p in probs:
        if p > 0:
            h -= p * math.log2(p)
    return h


def chain_predecessors(paths: list[list[int]], malicious: set) -> set:
    """Gamma: predecessor of every maximal malicious chain on each path.

    paths include the source at index 0 and proxy at the end."""
    gamma = set()
    for path in paths:
        i = 1
        while i < len(path):
            if path[i] in malicious and path[i - 1] not in malicious:
                gamma.add(path[i - 1])
                while i < len(path) and path[i] in malicious:
                    i += 1
            else:
                i += 1
    return gamma


def gentorrent_anonymity(N: int, f: float, k_paths: int, path_len: int,
                         rng: random.Random) -> float:
    """One trial: build k disjoint relay paths for a random source, sample
    malicious nodes, compute normalized entropy of the source distribution."""
    malicious = set(rng.sample(range(N), int(f * N)))
    src = rng.choice([x for x in range(N) if x not in malicious])
    nodes = [x for x in range(N) if x != src]
    paths = []
    used = set()
    for _ in range(k_paths):
        avail = [x for x in nodes if x not in used]
        relays = rng.sample(avail, path_len)
        used.update(relays)
        paths.append([src] + relays)
    L = sum(len(p) - 1 for p in paths)
    gamma = chain_predecessors(paths, malicious)
    denom = L + 1 - f * L
    p_gamma = 1.0 / denom
    honest_others = (1 - f) * N - len(gamma)
    rest = max(0.0, 1.0 - len(gamma) * p_gamma)
    probs = [p_gamma] * len(gamma)
    if honest_others > 0:
        probs += [rest / honest_others] * int(honest_others)
    return entropy_from_probs(probs) / math.log2(N)


def onion_anonymity(N: int, f: float, path_len: int,
                    rng: random.Random) -> float:
    """Single onion path (per-message): entry+exit collusion deanonymizes
    (traffic confirmation); a malicious entry alone makes its predecessor
    the prime suspect; a malicious middle/exit leaks partial timing info.
    The single path concentrates all trust — the structural weakness the
    paper's Fig 9 shows against multipath designs."""
    malicious = set(rng.sample(range(N), int(f * N)))
    src = rng.choice([x for x in range(N) if x not in malicious])
    relays = rng.sample([x for x in range(N) if x != src], path_len)
    entry_bad = relays[0] in malicious
    others_bad = any(r in malicious for r in relays[1:])
    honest = int((1 - f) * N)
    if entry_bad and others_bad:
        return 0.0  # traffic confirmation
    if entry_bad:
        probs = [0.8] + [0.2 / (honest - 1)] * (honest - 1)
        return entropy_from_probs(probs) / math.log2(N)
    if others_bad:
        # timing fingerprint narrows the candidate set
        half = max(1, honest // 4)
        probs = [3 / (4 * half)] * half + \
            [1 / (4 * (honest - half))] * (honest - half)
        return entropy_from_probs(probs) / math.log2(N)
    return entropy_from_probs([1.0 / honest] * honest) / math.log2(N)


def garlic_anonymity(N: int, f: float, k_paths: int, path_len: int,
                     rng: random.Random) -> float:
    """Garlic-cast: random-walk paths share an ID per message bundle, so
    colluding relays on DIFFERENT paths of the same message can link them
    (the weakness GenTorrent's per-path IDs remove)."""
    malicious = set(rng.sample(range(N), int(f * N)))
    src = rng.choice([x for x in range(N) if x not in malicious])
    paths = []
    for _ in range(k_paths):
        relays = rng.sample([x for x in range(N) if x != src], path_len)
        paths.append([src] + relays)
    # linkable: union of observations across all paths
    gamma = chain_predecessors(paths, malicious)
    # cross-path linking: if >= 2 paths observed, intersection exposes src
    touched = sum(1 for p in paths if any(x in malicious for x in p[1:]))
    if touched >= 2 and src in gamma:
        probs = [0.75] + [0.25 / ((1 - f) * N - 1)] * int((1 - f) * N - 1)
        return entropy_from_probs(probs) / math.log2(N)
    L = sum(len(p) - 1 for p in paths)
    denom = L + 1 - f * L
    p_gamma = 1.0 / denom
    honest_others = (1 - f) * N - len(gamma)
    rest = max(0.0, 1.0 - len(gamma) * p_gamma)
    probs = [p_gamma] * len(gamma)
    if honest_others > 0:
        probs += [rest / honest_others] * int(honest_others)
    return entropy_from_probs(probs) / math.log2(N)


def confidentiality(N: int, f: float, n_paths: int, k: int, path_len: int,
                    trials: int, rng: random.Random,
                    brute_force: bool = False) -> float:
    """Fraction of messages whose content stays confidential: an adversary
    must control relays on >= k of the n paths (and, without brute-force
    capability, also recover the interleaved fragment indices)."""
    ok = 0
    for _ in range(trials):
        malicious = set(rng.sample(range(N), int(f * N)))
        covered = 0
        for _ in range(n_paths):
            relays = rng.sample(range(N), path_len)
            if any(r in malicious for r in relays):
                covered += 1
        if covered < k:
            ok += 1
        elif not brute_force:
            # holds >= k cloves but path IDs differ: needs brute force
            ok += 1 if rng.random() < 0.98 else 0
    return ok / trials

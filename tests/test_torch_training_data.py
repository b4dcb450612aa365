"""The port's data pipelines (``repro_torch/training/data.py``) against
``repro/training/data.py``: the same seeds give the same token arrays and
the same serving queries; and the reference's own workload checks
(``tests/test_training.py``) on the port."""
from collections import Counter

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.training import data as jdata  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402


@pytest.mark.parametrize("vocab,seed,branching,noise", [(512, 0, 4, 0.1), (32000, 3, 2, 0.02)])
def test_markov_corpus_matches_reference(vocab, seed, branching, noise):
    """The transition table, ``sample`` from the corpus's own generator
    and from a given one, and ``batches``."""
    j = jdata.MarkovCorpus(vocab, seed=seed, branching=branching, noise=noise)
    t = tdata.MarkovCorpus(vocab, seed=seed, branching=branching, noise=noise)
    np.testing.assert_array_equal(t._next, j._next)
    np.testing.assert_array_equal(t.sample(3, 17), j.sample(3, 17))
    np.testing.assert_array_equal(t.sample(2, 9, np.random.default_rng(5)),
                                  j.sample(2, 9, np.random.default_rng(5)))
    for bt, bj in zip(t.batches(4, 32, 3, seed=100), j.batches(4, 32, 3, seed=100),
                      strict=True):
        assert bt.keys() == bj.keys() == {"tokens", "labels"}
        for k in bt:
            assert bt[k].dtype == bj[k].dtype == np.int32
            np.testing.assert_array_equal(bt[k], bj[k])


def _queries(gen, n):
    return [(q.tokens, q.prefix_id, q.workload, q.max_new, q.session)
            for q in (gen.sample() for _ in range(n))]


@pytest.mark.parametrize("spec", ["TOOLUSE", "CODING", "LONGQA"])
@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_workload_gen_matches_reference(spec, scale):
    j = jdata.WorkloadGen(getattr(jdata, spec), vocab=32_000, seed=7, scale=scale)
    t = tdata.WorkloadGen(getattr(tdata, spec), vocab=32_000, seed=7, scale=scale)
    assert t.spec == getattr(tdata, spec) and \
        tuple(vars(t.spec).values()) == tuple(vars(j.spec).values())
    assert t._prefixes == j._prefixes
    assert _queries(t, 40) == _queries(j, 40)


def test_mixed_workload_and_arrivals_match_reference():
    assert _queries(tdata.MixedWorkload(seed=2, scale=0.05), 120) == \
        _queries(jdata.MixedWorkload(seed=2, scale=0.05), 120)
    assert tdata.poisson_arrivals(10.0, 100, seed=4, t0=1.5) == \
        jdata.poisson_arrivals(10.0, 100, seed=4, t0=1.5)
    rng = np.random.default_rng(9), np.random.default_rng(9)
    assert [tdata._zipf_choice(rng[0], 64, 1.1) for _ in range(50)] == \
        [jdata._zipf_choice(rng[1], 64, 1.1) for _ in range(50)]


# ---------------------------------- tests/test_training.py's workload checks
def test_workload_statistics():
    g = tdata.WorkloadGen(tdata.TOOLUSE, seed=0, scale=0.1)
    qs = [g.sample() for _ in range(300)]
    lens = [len(q.tokens) for q in qs]
    # scaled mean ~ (6400 + 800) * 0.1
    assert 400 < np.mean(lens) < 1100
    # zipf: the most popular prefix dominates
    c = Counter(q.prefix_id for q in qs)
    assert c.most_common(1)[0][1] > len(qs) * 0.15


def test_mixed_workload_ratio():
    m = tdata.MixedWorkload(seed=0, scale=0.05)
    c = Counter(m.sample().workload for _ in range(600))
    assert c["Coding"] > c["ToolUse"] > c["LongQA"]


def test_poisson_arrivals_monotone():
    ts = tdata.poisson_arrivals(10.0, 100, seed=0)
    assert all(b > a for a, b in zip(ts, ts[1:]))
    assert 5 < ts[-1] < 20  # ~10s for 100 arrivals at 10/s

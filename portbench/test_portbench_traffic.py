"""The one traffic generator: each mix repeats from its seed, replays one
schedule of sizes and arrivals for every seed, and stays inside its stated
ranges."""
from collections import Counter

import pytest

np = pytest.importorskip("numpy")

from harness import frozen_data, spec, traffic  # noqa: E402

MIXES = {name: spec.load_json(spec.HERE / "traffic" / f"{name}.json")
         for name in ("chat_open", "coding_backlog")}
VOCAB = {"chat_open": 100352, "coding_backlog": 64000}
SEEDS = (0, 2**31 + 11, 987654321)


def _mix(name, seed, n=300):
    return traffic.Mix(MIXES[name], VOCAB[name], seed, n)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_a_seed_repeats_and_seeds_share_sizes(name):
    a, b = _mix(name, SEEDS[1]), _mix(name, SEEDS[1])
    assert [s.__dict__ for s in a.shapes] == [s.__dict__ for s in b.shapes]
    assert a.prompt(5) == b.prompt(5) and a.prompt(77) == b.prompt(77)
    c = _mix(name, SEEDS[2])
    assert a.prompt(5) != c.prompt(5)
    key = [(s.prefix, s.suffix, s.answer) for s in a.shapes]
    other = [(s.prefix, s.suffix, s.answer) for s in c.shapes]
    first = MIXES[name].get("first_wave", {}).get("count", 0)
    assert [s.due for s in a.shapes] == [s.due for s in c.shapes]
    # one schedule for every seed: a first wave's sizes in another order,
    # every later request's as they are
    assert (key[:first] != other[:first]) == (first > 1)
    assert sorted(key[:first]) == sorted(other[:first]) and key[first:] == other[first:]
    # a longer schedule extends the same one
    assert [s.__dict__ for s in _mix(name, 3, 600).shapes[:280]] == \
           [s.__dict__ for s in _mix(name, 3, 300).shapes[:280]]


def test_chat_ranges():
    m, mix = _mix("chat_open", SEEDS[0], 2000), MIXES["chat_open"]
    assert len(m.prefix_lens) == 16 and all(1024 <= n <= 2048 for n in m.prefix_lens)
    for s in m.shapes:
        assert 32 <= s.suffix <= 512 and 16 <= s.answer <= 128
        assert m.prefix_lens[s.prefix] + s.suffix + s.answer <= mix["max_total"] == 2688
    p = m.prompt(3)
    assert min(p) >= 2 and max(p) < VOCAB["chat_open"]
    assert p[:m.prefix_lens[m.shapes[3].prefix]] == m.prefix_tokens(m.shapes[3].prefix)
    # Zipf 1.1 over 16: the first prompt is the most used
    use = Counter(s.prefix for s in m.shapes)
    assert use.most_common(1)[0][0] == 0
    gaps = np.diff([s.due for s in m.shapes])
    assert abs(gaps.mean() * mix["arrivals"]["rate_per_s"] - 1) < 0.1
    med = np.median([s.suffix for s in m.shapes])
    assert 110 <= med <= 150


def test_coding_is_the_papers_mix_clipped():
    spec_, mix = frozen_data.CODING, MIXES["coding_backlog"]
    pre = mix["prefixes"]
    assert (pre["count"], pre["zipf_a"]) == (spec_.n_prefixes, spec_.zipf_a)
    assert (pre["length"]["mean"], pre["length"]["std"]) == \
           (spec_.prefix_len_mean, spec_.prefix_len_mean * 0.2)
    assert (mix["suffix"]["mean"], mix["suffix"]["std"]) == \
           (spec_.suffix_len_mean, spec_.suffix_len_mean * 0.3)
    assert mix["answer"]["max"] == spec_.output_cap
    m = _mix("coding_backlog", SEEDS[0], 3000)
    wave = mix["first_wave"]["count"]
    for i, s in enumerate(m.shapes):
        lo = 1 if i < wave else 100
        assert lo <= s.answer <= 1000
        assert m.prefix_lens[s.prefix] + s.suffix + s.answer <= 4096
    rest = np.array([s.suffix + m.prefix_lens[s.prefix] for s in m.shapes[wave:]])
    assert 1650 <= rest.mean() <= 1850
    # the residual first wave: shorter answers than a fresh one on average
    assert np.mean([s.answer for s in m.shapes[:wave]]) < 500


def test_schedules_cover_the_window():
    chat = MIXES["chat_open"]
    n = traffic.requests_needed(chat, 51)
    due = frozen_data.poisson_arrivals(chat["arrivals"]["rate_per_s"], n, chat["shape_seed"])
    assert due[-1] > 1.2 * (chat["lead_in_s"] + 51)
    assert traffic.requests_needed(MIXES["coding_backlog"], 51) > 4000

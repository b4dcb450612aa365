"""The chunk-hash kernel's plain version and ``preprocess_batch`` against
the JAX package: ``chunk_hash_pallas`` in interpret mode and its oracle
``chunk_hash_ref`` for fixed widths, and ``hrtree.preprocess`` /
``chunk_hash`` for the ranged entry.  Hashes are integers: every
comparison is exact."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hrtree as jhr  # noqa: E402
from repro.core.sentry import build_lengths  # noqa: E402
from repro.kernels.chunk_hash.kernel import chunk_hash_pallas  # noqa: E402
from repro.kernels.chunk_hash.ref import chunk_hash_ref  # noqa: E402
from repro_torch.core import hrtree as thr  # noqa: E402
from repro_torch.kernels.chunk_hash import ops  # noqa: E402

VOCAB = 128_256                         # llama3's vocabulary
TOP = 2**31 - 1                         # t + 1 wraps in uint32


@pytest.mark.parametrize("top", [VOCAB, TOP])
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("width", [8, 64, 128])
def test_fixed_matches_pallas_interpret(width, bits, top):
    rng = np.random.default_rng(width * bits)
    toks = rng.integers(0, top, (3, 256), endpoint=True).astype(np.int32)
    toks[0, :width] = top                # a whole chunk of the largest id
    got = ops.chunk_hash_fixed(torch.from_numpy(toks), width, bits)
    assert got.dtype == torch.int64 and got.shape == (3, 256 // width)
    want = np.asarray(chunk_hash_pallas(jnp.asarray(toks), width=width, bits=bits,
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), chunk_hash_ref(toks, width=width, bits=bits))


@pytest.mark.parametrize("bits", [1, 4, 8, 16, 32])
def test_ranged_matches_chunk_hash(bits):
    rng = np.random.default_rng(bits)
    flat = rng.integers(0, TOP, 1000, endpoint=True).astype(np.int32)
    spans = [(0, 1), (3, 0), (10, 200), (999, 1), (0, 1000), (500, 37), (64, 64)]
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32)
    lens = torch.tensor([n for _, n in spans], dtype=torch.int32)
    got = ops.chunk_hash_ranges(torch.from_numpy(flat), starts, lens, bits).tolist()
    assert got == [jhr.chunk_hash(flat[s:s + n], bits) for s, n in spans]


def test_ranged_outside_the_tokens_is_minus_one():
    flat = torch.arange(10, dtype=torch.int32)
    got = ops.chunk_hash_ranges(flat, torch.tensor([8, -1, 0, 2], dtype=torch.int32),
                                torch.tensor([3, 2, 10, -1], dtype=torch.int32), 8)
    assert got.tolist() == [-1, -1, jhr.chunk_hash(range(10), 8), -1]


def test_entries_check_their_inputs():
    t = torch.zeros(2, 64, dtype=torch.int32)
    for bits in (0, 33):
        with pytest.raises(ValueError):
            ops.chunk_hash_fixed(t, 64, bits)
    with pytest.raises(ValueError):
        ops.chunk_hash_fixed(t, 48, 8)
    with pytest.raises(TypeError):
        ops.chunk_hash_fixed(t.long(), 64, 8)
    with pytest.raises(TypeError):
        ops.chunk_hash_ranges(t.reshape(-1), torch.zeros(1, dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int32), 8)


def _lengths_cases():
    return {"sentry": build_lengths([40, 120, 200], 8),
            "sentry_close": build_lengths([32, 36, 300], 8),
            "default": [64],
            "empty": [],
            "overrun": [100],                # the partial-chunk quirk
            "nonpositive": [16, 0, 32],      # ln <= 0 ends the L loop
            "negative": [-5, 16]}


@pytest.mark.parametrize("bits", [8, 32])
@pytest.mark.parametrize("case", list(_lengths_cases()))
def test_preprocess_batch_matches_reference(case, bits):
    lengths = _lengths_cases()[case]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, n).tolist()
               for n in (0, 5, 63, 64, 80, 100, 129, 300, 600)]
    prompts.append([TOP] * 70)
    prompts.append(tuple(prompts[-2]))   # the Sentry keeps tuples
    want = [jhr.preprocess(p, lengths, bits) for p in prompts]
    got = thr.preprocess_batch(prompts, lengths, bits, device="cpu")
    assert got == want
    assert all(type(h) is int for hs in got for h in hs)
    assert [thr.preprocess(p, lengths, bits) for p in prompts] == want
    for p in prompts[:6]:
        assert thr.preprocess_batch([p], lengths, bits, device="cpu") == [jhr.preprocess(
            p, lengths, bits)]


def test_partial_chunk_quirk():
    """L=[100] on an 80-token prompt: the L loop stops, the 64-token tail
    loop still hashes tokens 0..63 (the reference's behaviour)."""
    toks = list(range(80))
    assert thr.chunk_spans(80, [100]) == [(0, 64)]
    assert thr.preprocess_batch([toks], [100], device="cpu") == [[jhr.chunk_hash(toks[:64])]]
    assert thr.chunk_spans(200, [16, 0, 32]) == [(0, 16), (16, 64), (80, 64)]
    assert thr.preprocess_batch([[1] * 10, []], [64], device="cpu") == [[], []]

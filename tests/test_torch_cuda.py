"""The port's CUDA kernels on the card, against their plain versions, and
the paged and dense-pool LM and scheduler (llama, jamba, xlstm), the
overlay's model nodes and the whole privacy overlay (``build_overlay``)
on the card against the same code on the CPU.

Every test here needs a CUDA card and skips itself from the ``card``
fixture where torch sees none (the kernels have no CPU mode).  The file
imports no JAX, so it runs on a card host that has none:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import hrtree  # noqa: E402
from repro_torch.core.forwarding import ForwardingConfig  # noqa: E402
from repro_torch.core.sentry import build_lengths  # noqa: E402
from repro_torch.kernels.chunk_hash import ops as hash_ops  # noqa: E402
from repro_torch.kernels.chunk_hash import ref as hash_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dense_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dense_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.paged_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm import ref as mlstm_ref  # noqa: E402
from repro_torch.kernels.paged_decode import ref as decode_ref  # noqa: E402
from repro_torch.kernels.tickets import BUFFERS as TICKETS  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.net.simnet import SimNet  # noqa: E402
from repro_torch.overlay.model_node import ModelNode  # noqa: E402
from repro_torch.overlay.network import OverlayConfig, build_overlay  # noqa: E402
from repro_torch.overlay.probe import ResponseSink, direct_payload  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving.engine import RealEngine, Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

pytestmark = pytest.mark.cuda

BLK = 32
NAME = "gentorrent-llama3-8b"
VARIANTS = [(None, None), (8, None), (None, 50.0), (8, 50.0)]
# float32: the kernel and the plain version sum in different orders;
# bfloat16: the kernel rounds its output to bf16, the plain version is f32
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _arena(rng, dev, P=200, Hkv=8, D=128, B=4, n_pg=32):
    ka, va = _randn(rng, P, BLK, Hkv, D), _randn(rng, P, BLK, Hkv, D)
    pt = torch.from_numpy(rng.integers(1, P, size=(B, n_pg)).astype(np.int32))
    return ka.to(dev), va.to(dev), pt.to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_paged_decode_kernel_matches_plain(card, dtype, window, softcap):
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(6)
    ka, va, pt = _arena(rng, card)
    q = _randn(rng, 4, 32, 128).to(card)
    lengths = torch.tensor([1000, 517, 0, 33], dtype=torch.int32, device=card)
    x = [t.to(dt) for t in (q, ka, va)]
    kw = dict(window=window, softcap=softcap)
    n0 = decode_ops.paged_decode_attention.launches
    got = decode_ops.paged_decode_attention(*x, pt, lengths, **kw)
    want = decode_ref.paged_decode_attention_ref(*[t.float() for t in x], pt,
                                                 lengths, **kw)
    torch.cuda.synchronize()
    assert decode_ops.paged_decode_attention.launches == n0 + 1
    live = lengths > 0
    torch.testing.assert_close(got.float()[live], want[live], **TOL[dtype])
    assert not got[~live].any()                         # dead row: zeros


def test_paged_decode_kernel_clamps_lengths_past_the_table(card):
    """A length past the page table reads no page past it: the row attends
    every position the table holds, as the plain version does."""
    rng = np.random.default_rng(9)
    ka, va, pt = _arena(rng, card, n_pg=4)
    q = _randn(rng, 4, 32, 128).to(card)
    lengths = torch.tensor([129, 500, 128, 1], dtype=torch.int32, device=card)
    for window in (None, 8):
        got = decode_ops.paged_decode_attention(q, ka, va, pt, lengths,
                                                window=window)
        want = decode_ref.paged_decode_attention_ref(q, ka, va, pt, lengths,
                                                     window=window)
        torch.cuda.synchronize()
        live = lengths - (window or 0) < 128        # a visible position left
        torch.testing.assert_close(got[live], want[live], **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [32, 5])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_paged_flash_kernel_matches_plain(card, dtype, C, window, softcap):
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(7)
    ka, va, pt = _arena(rng, card)
    q = _randn(rng, 4, C, 32, 128).to(card)
    pos0 = torch.tensor([0, 256, 512, 960] if C == 32 else [3, 300, 0, 1010],
                        dtype=torch.int32, device=card)
    active = torch.tensor([True, True, False, True], device=card)
    x = [t.to(dt) for t in (q, ka, va)]
    kw = dict(window=window, softcap=softcap)
    got = flash_ops.paged_flash_attention(*x, pt, pos0, active, **kw)
    want = flash_ref.paged_attention_ref(*[t.float() for t in x], pt, pos0,
                                         active, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_flash_kernel_matches_plain(card, dtype, causal, window, softcap):
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(8)
    q = _randn(rng, 2, 32, 200, 128).to(card)
    k, v = (_randn(rng, 2, 8, 200, 128).to(card) for _ in range(2))
    x = [t.to(dt) for t in (q, k, v)]
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_ops.flash_attention(*x, **kw)
    want = flash_ref.attention_ref(*[t.float() for t in x], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [8, 5, 200])
def test_flash_kernel_reads_strided_views(card, dtype, S):
    """The slot pool's prefill passes (B, S, H, D) tensors viewed as (B, H,
    S, D), as models/attention.py full_attention does; S = 8 is the
    engine's boot prefill.  The output keeps q's layout."""
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(9)
    q = _randn(rng, 1, S, 32, 128).to(card, dt).transpose(1, 2)
    k, v = (_randn(rng, 1, S, 8, 128).to(card, dt).transpose(1, 2) for _ in range(2))
    got = flash_ops.flash_attention(q, k, v)
    want = flash_ref.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [9, 100, 600])
def test_dense_decode_kernel_at_batch_one(card, dtype, length):
    """A teacher-forced prompt token: one row of jamba's attention (32 query
    heads on 8 KV heads) over a 1024-position cache, 32 splits, most of
    them empty."""
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(13)
    q = _randn(rng, 1, 32, 128).to(card, dt)
    k, v = (_randn(rng, 1, 1024, 8, 128).to(card, dt) for _ in range(2))
    assert dense_ops.n_splits(1, 8, 1024) == 32
    lengths = torch.tensor([length], dtype=torch.int32, device=card)
    got = dense_ops.decode_attention(q, k, v, lengths)
    want = dense_ref.decode_attention_ref(q.float(), k.float(), v.float(), lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1024, 1000])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_dense_decode_kernel_matches_plain(card, dtype, S, window, softcap):
    """The slot pool's layout (B, S, Hkv, D), a row longer than the cache
    is clamped to it, a dead row writes zeros; S = 1000 leaves a ragged
    last tile."""
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(10)
    q = _randn(rng, 4, 32, 128).to(card, dt)
    k, v = (_randn(rng, 4, S, 8, 128).to(card, dt) for _ in range(2))
    lengths = torch.tensor([S + 24, 517, 0, 33], dtype=torch.int32, device=card)
    kw = dict(window=window and 8 * window, softcap=softcap)
    n0 = dense_ops.decode_attention.launches
    got = dense_ops.decode_attention(q, k, v, lengths, **kw)
    want = dense_ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                          lengths, **kw)
    torch.cuda.synchronize()
    assert dense_ops.decode_attention.launches == n0 + 1
    live = lengths > 0
    torch.testing.assert_close(got.float()[live], want[live], **TOL[dtype])
    assert not got[~live].any()                         # dead row: zeros


# ------------------------------------------------------------------------
# The split-page paged decode: spans, empty splits, the in-launch combine's
# tickets; the bf16 tensor-core flash body at every head layout
# ------------------------------------------------------------------------
def _paged_decode_case(card, dtype, lengths, n_pg=32, window=None, seed=11):
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(seed)
    B = len(lengths)
    ka, va, pt = _arena(rng, card, B=B, n_pg=n_pg)
    q = _randn(rng, B, 32, 128).to(card)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
    x = [t.to(dt) for t in (q, ka, va)]
    n0 = decode_ops.paged_decode_attention.launches
    got = decode_ops.paged_decode_attention(*x, pt, lengths, window=window)
    want = decode_ref.paged_decode_attention_ref(*[t.float() for t in x], pt,
                                                 lengths, window=window)
    torch.cuda.synchronize()
    assert decode_ops.paged_decode_attention.launches == n0 + 1
    live = lengths > 0
    torch.testing.assert_close(got.float()[live], want[live], **TOL[dtype])
    assert not got[~live].any()                         # dead row: zeros
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [[1, 32, 33, 1000], [1024, 0, 1, 32]])
def test_paged_decode_splits_with_empty_spans(card, dtype, lengths):
    """Lengths of one position, one page, a page and one, most and all of
    the 32-page table: 9 or more splits each, so short rows leave most
    empty."""
    assert decode_ops.n_splits(len(lengths), 8, 32) >= 9
    _paged_decode_case(card, dtype, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_paged_decode_one_page_table(card, dtype, window):
    """n_pg = 1: one split, whose block combines its own partial."""
    assert decode_ops.n_splits(4, 8, 1) == 1
    _paged_decode_case(card, dtype, [1, 32, 17, 0], n_pg=1, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_window_starts_inside_a_span(card, dtype):
    """Windows of 600 and 45 start mid-page, so the first visible page is
    partly masked; at 600 (20 visible pages of the 1000-token row, 2 or
    more a split) the window starts inside a span."""
    lo, hi = decode_ops.split_spans(1000, 600, 32, decode_ops.n_splits(4, 8, 32))[0]
    assert lo == 12 and hi - lo >= 2
    _paged_decode_case(card, dtype, [1000, 700, 0, 333], window=600)
    _paged_decode_case(card, dtype, [1000, 45, 46, 999], window=45)


def test_paged_decode_tickets_reset_between_calls(card):
    """The combine's tickets are left zero: the same call twice gives the
    same output, and calls at other batch sizes (other ticket slots, more
    or fewer splits) stay right."""
    a = _paged_decode_case(card, "bfloat16", [1000, 517, 0, 33])
    b = _paged_decode_case(card, "bfloat16", [1000, 517, 0, 33])
    assert torch.equal(a, b)
    _paged_decode_case(card, "bfloat16", [700, 3])
    _paged_decode_case(card, "bfloat16", [1024, 1, 512, 0, 64, 900, 2, 31])
    _paged_decode_case(card, "float32", [1000, 517, 0, 33])
    assert not any(t.any() for t in TICKETS.values())


def _two_streams(card, call, want_of, lengths):
    """``call(q, lengths)`` 16 times, alternating between two streams that
    both wait on one event behind a sleep kernel, so the launches of the
    two streams run at once; every output must match ``want_of(q,
    lengths)``."""
    rng = np.random.default_rng(12)
    qs = [_randn(rng, 4, 32, 128).to(card, torch.bfloat16) for _ in range(16)]
    gate, *streams = (torch.cuda.Stream(card) for _ in range(3))
    torch.cuda.synchronize()
    with torch.cuda.stream(gate):
        torch.cuda._sleep(20_000_000)              # ~10 ms at the H100's clock
    ready = gate.record_event()
    for st in streams:
        st.wait_event(ready)
    outs = []
    for i, q in enumerate(qs):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(call(q, lengths[i % 2]))
    torch.cuda.synchronize()
    for i, (q, got) in enumerate(zip(qs, outs)):
        torch.testing.assert_close(got.float(), want_of(q, lengths[i % 2]),
                                   **TOL["bfloat16"])
    assert not any(t.any() for t in TICKETS.values())


def test_paged_decode_on_two_streams_at_once(card):
    """Calls on two streams at once keep their combines apart (a ticket
    buffer per stream).  Stream 0's calls are 4 rows x 8 KV heads x 9
    splits of four pages each (1152-token rows over a 36-page table): 288
    blocks, more than the card holds at once (two an SM), so a last wave of
    24 blocks runs after the first.  Stream 1's calls have the same grid
    over short rows, so most of their blocks are empty and finish while
    that last wave still runs: their tickets of a (row, KV group) are
    taken between stream 0's.  Every output matches the plain version."""
    rng = np.random.default_rng(12)
    ka, va, pt = (t.to(torch.bfloat16) if t.is_floating_point() else t
                  for t in _arena(rng, card, n_pg=36))
    splits = decode_ops.n_splits(4, 8, 36)
    assert all(hi - lo == 4 for lo, hi in decode_ops.split_spans(1152, None, 36, splits))
    lengths = [torch.tensor(n, dtype=torch.int32, device=card)
               for n in ([1152] * 4, [33, 1, 40, 64])]
    _two_streams(
        card, lambda q, n: decode_ops.paged_decode_attention(q, ka, va, pt, n),
        lambda q, n: decode_ref.paged_decode_attention_ref(q.float(), ka.float(),
                                                           va.float(), pt, n), lengths)


def test_dense_decode_on_two_streams_at_once(card):
    """The dense decode's in-launch combine on two streams at once, as the
    paged decode's: stream 0's calls are 4 full 1152-position rows (9
    splits of four tiles each, 288 blocks, two waves), stream 1's short
    rows whose live blocks finish between them."""
    rng = np.random.default_rng(15)
    k, v = (_randn(rng, 4, 1152, 8, 128).to(card, torch.bfloat16) for _ in range(2))
    splits = dense_ops.n_splits(4, 8, 1152)
    assert all(hi - lo == 4 for lo, hi in
               decode_ops.split_spans(1152, None, 36, splits, positions=1152))
    lengths = [torch.tensor(n, dtype=torch.int32, device=card)
               for n in ([1152] * 4, [33, 1, 40, 64])]
    _two_streams(card, lambda q, n: dense_ops.decode_attention(q, k, v, n),
                 lambda q, n: dense_ref.decode_attention_ref(q.float(), k.float(),
                                                             v.float(), n), lengths)


def test_dense_decode_leaves_its_tickets_at_zero(card):
    """One dense decode call (its live splits take and reset tickets; the
    empty ones take none) leaves every ticket zero, and the same call again
    gives the same output; calls at other batch sizes stay right."""
    rng = np.random.default_rng(16)
    q = _randn(rng, 4, 32, 128).to(card, torch.bfloat16)
    k, v = (_randn(rng, 4, 1024, 8, 128).to(card, torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([1000, 517, 0, 33], dtype=torch.int32, device=card)
    a = dense_ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert not any(t.any() for t in TICKETS.values())
    assert torch.equal(a, dense_ops.decode_attention(q, k, v, lengths))
    for n in ([100], [700, 3]):
        ln = torch.tensor(n, dtype=torch.int32, device=card)
        got = dense_ops.decode_attention(q[:len(n)], k[:len(n)], v[:len(n)], ln)
        want = dense_ref.decode_attention_ref(q[:len(n)].float(), k[:len(n)].float(),
                                              v[:len(n)].float(), ln)
        torch.testing.assert_close(got.float(), want, **TOL["bfloat16"])
    torch.cuda.synchronize()
    assert not any(t.any() for t in TICKETS.values())


@pytest.mark.parametrize("lengths", [[1000, 517, 0, 33], [100]])
def test_dense_decode_is_one_kernel_a_call(card, lengths):
    """The profiler sees exactly one device kernel per dense-decode call:
    the split decode, its partials combined in the same launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(17)
    B = len(lengths)
    q = _randn(rng, B, 32, 128).to(card, torch.bfloat16)
    k, v = (_randn(rng, B, 1024, 8, 128).to(card, torch.bfloat16) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    dense_ops.decode_attention(q, k, v, ln)              # tickets allocated, library loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            dense_ops.decode_attention(q, k, v, ln)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 3, [e.name for e in kernels]
    assert all("decode_kernel" in e.name for e in kernels), [e.name for e in kernels]


@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 6, 7, 8, 48])
def test_flash_bf16_every_head_layout(card, D, G):
    """The tensor-core body at every registered config's head dim (padded
    to 64, 128 or 256 in shared memory) and GQA group: the dense entry on
    (B, S, H, D) views and the paged entry on a prefill chunk, bf16 within
    2e-2 of the f32 plain version."""
    rng = np.random.default_rng(20 + D + G)
    Hkv = 2
    H = G * Hkv
    q = _randn(rng, 2, 100, H, D).to(card, torch.bfloat16).transpose(1, 2)
    k, v = (_randn(rng, 2, 100, Hkv, D).to(card, torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    for kw in (dict(), dict(window=40, softcap=30.0)):
        got = flash_ops.flash_attention(q, k, v, **kw)
        want = flash_ref.attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL["bfloat16"])
    ka, va, pt = (t.to(torch.bfloat16) if t.is_floating_point() else t
                  for t in _arena(rng, card, P=40, Hkv=Hkv, D=D, B=2, n_pg=8))
    qp = _randn(rng, 2, 32, H, D).to(card, torch.bfloat16)
    pos0 = torch.tensor([200, 37], dtype=torch.int32, device=card)
    got = flash_ops.paged_flash_attention(qp, ka, va, pt, pos0)
    want = flash_ref.paged_attention_ref(qp.float(), ka.float(), va.float(), pt, pos0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL["bfloat16"])


@pytest.mark.parametrize("Sq", [1, 5, 32, 33])
def test_paged_flash_bf16_query_lengths(card, Sq):
    """Verify windows and prefill chunks of 1, 5, 32 and 33 queries (33:
    a second query tile of one index), starting off a page boundary, with
    a dead row, over the 32-page table of the serving shape."""
    rng = np.random.default_rng(30 + Sq)
    ka, va, pt = (t.to(torch.bfloat16) if t.is_floating_point() else t
                  for t in _arena(rng, card))
    q = _randn(rng, 4, Sq, 32, 128).to(card, torch.bfloat16)
    pos0 = torch.tensor([3, 45, 0, 1024 - Sq - 7], dtype=torch.int32, device=card)
    active = torch.tensor([True, True, False, True], device=card)
    for kw in (dict(), dict(window=100, softcap=50.0)):
        got = flash_ops.paged_flash_attention(q, ka, va, pt, pos0, active, **kw)
        want = flash_ref.paged_attention_ref(q.float(), ka.float(), va.float(), pt,
                                             pos0, active, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL["bfloat16"])
        assert not got[~active].any()


@pytest.mark.parametrize("S", [5, 8, 200, 1024])
def test_flash_bf16_strided_views(card, S):
    """The slot pool's prefill at jamba's and llama's heads (32 on 8, D =
    128) on (B, S, H, D) views, two rows, up to the 1024-token prompt."""
    rng = np.random.default_rng(40 + S)
    q = _randn(rng, 2, S, 32, 128).to(card, torch.bfloat16).transpose(1, 2)
    k, v = (_randn(rng, 2, S, 8, 128).to(card, torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    got = flash_ops.flash_attention(q, k, v)
    want = flash_ref.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want, **TOL["bfloat16"])


def test_dense_decode_kernel_one_row_many_splits(card):
    """One row, one KV head: the most splits, most of them empty."""
    rng = np.random.default_rng(11)
    q = _randn(rng, 1, 4, 64).to(card)
    k, v = (_randn(rng, 1, 2048, 1, 64).to(card) for _ in range(2))
    assert dense_ops.n_splits(1, 1, 2048) == 64
    for n in (1, 31, 32, 33, 700, 2048):
        lengths = torch.tensor([n], dtype=torch.int32, device=card)
        got = dense_ops.decode_attention(q, k, v, lengths)
        want = dense_ref.decode_attention_ref(q, k, v, lengths)
        torch.testing.assert_close(got, want, **TOL["float32"])


# (B, S, H, P, N, chunk): the full-width prefill's chunk and head shape,
# a ragged tail, chunks shorter than 128, a prompt shorter than a chunk,
# the engine's boot prefill at full width (8 tokens, one chunk of 8), two
# rows of it (without h0: the bf16 boot path at B = 2), and 8 full-width
# chunks (the chunk launches' grid over chunks and heads)
SCAN_SHAPES = [(1, 512, 4, 128, 16, 128), (2, 300, 2, 128, 16, 128),
               (2, 37, 2, 32, 8, 16), (1, 96, 4, 64, 16, 32),
               (3, 5, 2, 128, 16, 128), (1, 8, 64, 128, 16, 128),
               (2, 8, 64, 128, 16, 128), (1, 1024, 8, 128, 16, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mamba_scan_kernel_matches_plain(card, dtype, with_h0, shape):
    B, S, H, P, N, chunk = shape
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(12)
    xbar = (_randn(rng, B, S, H, P) * 0.5).to(card, dt)
    loga = -torch.nn.functional.softplus(_randn(rng, B, S, H)).to(card)
    Bm, Cm = ((_randn(rng, B, S, N) * 0.5).to(card, dt) for _ in range(2))
    h0 = (_randn(rng, B, H, N, P) * 0.1).to(card) if with_h0 else None
    n0, b0 = scan_ops.mamba_scan.launches, scan_ops.mamba_scan.boot_launches
    y, h = scan_ops.mamba_scan(xbar, loga, Bm, Cm, h0, chunk=chunk)
    wy, wh = scan_ref.mamba_scan_ref(xbar.float(), loga, Bm.float(),
                                     Cm.float(), h0, chunk=chunk)
    torch.cuda.synchronize()
    assert scan_ops.mamba_scan.launches == n0 + 1
    boot = dtype == "bfloat16" and not with_h0 and S <= chunk
    assert scan_ops.mamba_scan.boot_launches == b0 + boot
    assert y.dtype == dt and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), wy, **TOL[dtype])
    torch.testing.assert_close(h, wh, **TOL[dtype])


def _scan_case(card, dt, B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return ((_randn(rng, B, S, H, P) * 0.5).to(card, dt),
            -torch.nn.functional.softplus(_randn(rng, B, S, H)).to(card),
            (_randn(rng, B, S, N) * 0.5).to(card, dt), (_randn(rng, B, S, N) * 0.5).to(card, dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_continues_its_own_state(card, dtype):
    """Two calls chained through the state equal one call: an 8-token boot
    (no state, one chunk: the bf16 boot path) continued by 300 tokens from
    its state (chunk states, state passing, chunk outputs), against one
    308-token call of the plain version, at jamba's width."""
    B, S1, S, H, P, N = 2, 8, 308, 8, 128, 16
    dt = configs.torch_dtype(dtype)
    x = _scan_case(card, dt, B, S, H, P, N, 19)
    y1, h1 = scan_ops.mamba_scan(*(t[:, :S1].contiguous() for t in x), chunk=128)
    y2, h2 = scan_ops.mamba_scan(*(t[:, S1:].contiguous() for t in x), h1, chunk=128)
    xbar, loga, Bm, Cm = x
    wy, wh = scan_ref.mamba_scan_ref(xbar.float(), loga, Bm.float(), Cm.float(), chunk=128)
    torch.cuda.synchronize()
    # the plain version chunks the 308 steps from 0, the chained calls from
    # 0 and from 8: the same function, other chunk boundaries
    torch.testing.assert_close(torch.cat([y1, y2], dim=1).float(), wy, **TOL[dtype])
    torch.testing.assert_close(h2, wh, **TOL[dtype])


@pytest.mark.parametrize("P,N,chunk", [(128, 12, 128), (36, 16, 128), (128, 16, 256)])
def test_mamba_scan_refuses_bf16_shapes_off_the_tensor_cores(card, P, N, chunk):
    """bf16 runs only on the tensor-core kernels (N 8 or 16, P a multiple of
    8 up to 128, chunks up to 128): another shape raises, no fallback."""
    x = _scan_case(card, torch.bfloat16, 1, 300, 2, P, N, 25)
    with pytest.raises(ValueError, match="unsupported bf16 scan shape"):
        scan_ops.mamba_scan(*x, chunk=chunk)


@pytest.mark.parametrize("S,with_h0,kernels", [(8, False, 1), (300, True, 3), (5, True, 3)])
def test_mamba_scan_device_kernels_a_call(card, S, with_h0, kernels):
    """The profiler sees one device kernel a bf16 call on the boot path (no
    state, one chunk: jamba's serving prefills) and three otherwise (chunk
    states, state passing, chunk outputs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, H, P, N = 1, 64, 128, 16
    x = _scan_case(card, torch.bfloat16, B, S, H, P, N, 23)
    h0 = (_randn(np.random.default_rng(24), B, H, N, P) * 0.1).to(card) if with_h0 else None
    scan_ops.mamba_scan(*x, h0, chunk=128)              # library loaded, smem limits raised
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            scan_ops.mamba_scan(*x, h0, chunk=128)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 3 * kernels, names
    assert all("chunk_tc" in n or "pass_states" in n for n in names), names
    if kernels == 1:
        assert all("chunk_tc" in n for n in names), names


# (B, S, H, dh, chunk): the reduced model's head width over a ragged tail
# and short chunks, the JAX kernel test's dh = 64, the full width (dh =
# 1024) over a ragged tail, the engine's boot prefill at full width (8
# tokens, one chunk of 8), and two rows of a 40-token boot (one chunk of
# 40, its K padded to 48; without a state, the bf16 boot path)
MLSTM_SHAPES = [(2, 37, 2, 32, 16), (1, 96, 4, 64, 32),
                (1, 300, 4, 1024, 64), (1, 8, 4, 1024, 64), (2, 40, 4, 1024, 64)]
# h is a ratio whose denominator cancels (|den| down to exp(-m)), which
# magnifies the different summation order of the kernel's and cuBLAS's
# sums over dh: in float32, h is held at the JAX kernel test's 2e-4
# (tests/test_kernels.py:143), the state at TOL
MLSTM_TOL_H = {"float32": dict(atol=2e-4, rtol=2e-4),
               "bfloat16": TOL["bfloat16"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("shape", MLSTM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mlstm_kernel_matches_plain(card, dtype, with_state, shape):
    B, S, H, dh, chunk = shape
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(14)
    q = (_randn(rng, B, S, H, dh) / dh ** 0.5).to(card, dt)    # the model's scale
    k, v = (_randn(rng, B, S, H, dh).to(card, dt) for _ in range(2))
    log_i = (_randn(rng, B, S, H) * 2).to(card)
    log_f = torch.nn.functional.logsigmoid(_randn(rng, B, S, H) + 4).to(card)
    state = None
    if with_state:
        state = ((_randn(rng, B, H, dh, dh) * 0.1).to(card),
                 (_randn(rng, B, H, dh) * 0.1).to(card), _randn(rng, B, H).to(card))
    n0, b0 = mlstm_ops.mlstm_chunkwise.launches, mlstm_ops.mlstm_chunkwise.boot_launches
    h, st = mlstm_ops.mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk=chunk)
    wh, wst = mlstm_ref.mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f,
                                  state, chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm_ops.mlstm_chunkwise.launches == n0 + 1
    boot = dtype == "bfloat16" and not with_state and S <= chunk
    assert mlstm_ops.mlstm_chunkwise.boot_launches == b0 + boot
    assert h.dtype == dt and all(t.dtype == torch.float32 for t in st)
    torch.testing.assert_close(h.float(), wh, **MLSTM_TOL_H[dtype])
    for got, want in zip(st, wst):
        torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_kernel_continues_its_own_state(card, dtype):
    """Two calls chained through the state equal one call: a 40-token boot
    (no state, one chunk: the bf16 boot path) continued by 200 tokens from
    its state (the recurrent walk), against one 240-token call of the
    plain version, at xlstm-1.3b's head width."""
    B, S1, S, H, dh = 2, 40, 240, 4, 1024
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(18)
    q = (_randn(rng, B, S, H, dh) / dh ** 0.5).to(card, dt)
    k, v = (_randn(rng, B, S, H, dh).to(card, dt) for _ in range(2))
    log_i = (_randn(rng, B, S, H) * 2).to(card)
    log_f = torch.nn.functional.logsigmoid(_randn(rng, B, S, H) + 4).to(card)
    x = (q, k, v, log_i, log_f)
    h1, st1 = mlstm_ops.mlstm_chunkwise(*(t[:, :S1].contiguous() for t in x), chunk=64)
    h2, st2 = mlstm_ops.mlstm_chunkwise(*(t[:, S1:].contiguous() for t in x), st1, chunk=64)
    wh, wst = mlstm_ref.mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f, chunk=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([h1, h2], dim=1).float(), wh, **MLSTM_TOL_H[dtype])
    for got, want in zip(st2, wst):
        torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", NAME, "xlstm-1.3b"])
def test_dense_serving_on_card_matches_cpu(card, name):
    """The dense slot pool on the card and on the CPU from the same
    weights: reduced jamba (Mamba scan, dense decode, flash dense entry,
    MoE), reduced llama with paged=False and reduced xlstm (mLSTM kernel,
    sLSTM) give the same tokens."""
    cfg = configs.get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[5, 9, 2, 7] * 10, list(range(20)), [3] * 5, list(range(7, 77))]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = RealEngine(cfg, LM(cfg, dev), _to(params, torch.device(dev)),
                         max_len=128, paged=False, device=dev)
        s = Scheduler(eng, max_active=3)
        for i, pr in enumerate(prompts):
            s.submit(Request(i, pr, max_new=12))
        outs[dev] = {r.req_id: r.output for r in s.run()}
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("window", [None, 8])
def test_serving_on_card_matches_cpu(card, window):
    """The reduced model served through the scheduler, with and without
    speculation: the card (kernels) and the CPU (plain versions) give the
    same tokens from the same weights."""
    base = configs.get_config(NAME).reduced()
    cfg = dataclasses.replace(base, n_layers=2, pattern=(
        dataclasses.replace(base.pattern[0], window=window),))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rep = [5, 9, 2, 7] * 10
    prompts = [rep, list(range(20)), rep[:36], [3] * 30, list(range(7, 51))]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, torch.device(dev))
        for spec in (False, True):
            scfg = dataclasses.replace(cfg, spec_enabled=spec, spec_k=4)
            eng = RealEngine(scfg, LM(scfg, dev), p, max_len=128, device=dev)
            s = Scheduler(eng, max_active=4)
            for i, pr in enumerate(prompts):
                s.submit(Request(i, pr, max_new=24))
            outs[dev, spec] = {r.req_id: r.output for r in s.run()}
    assert outs["cuda", False] == outs["cpu", False]
    assert outs["cuda", True] == outs["cpu", True] == outs["cpu", False]


TOP = 2**31 - 1                  # the largest int32 token: t + 1 wraps in uint32


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("width", [8, 64, 128, 100])
def test_chunk_hash_fixed_kernel_matches_plain(card, width, bits):
    """Hashes are integers: the kernel equals the plain version exactly."""
    rng = np.random.default_rng(width + bits)
    toks = torch.from_numpy(rng.integers(0, TOP, (5, 12 * width), endpoint=True)
                            .astype(np.int32))
    toks[0, :width] = TOP
    n = hash_ops.chunk_hash_fixed.launches
    got = hash_ops.chunk_hash_fixed(toks.to(card), width, bits)
    torch.cuda.synchronize()
    assert hash_ops.chunk_hash_fixed.launches == n + 1
    assert torch.equal(got.cpu(), hash_ref.chunk_hash_fixed_ref(toks, width, bits))


@pytest.mark.parametrize("bits", [1, 8, 32])
def test_chunk_hash_ranges_kernel_matches_plain(card, bits):
    """Ragged ranges: empty, shorter than a warp, across lane boundaries,
    long, overlapping, and outside the tokens (-1)."""
    rng = np.random.default_rng(bits)
    flat = torch.from_numpy(rng.integers(0, TOP, 9000, endpoint=True).astype(np.int32))
    lens = [0, 1, 5, 31, 32, 33, 63, 64, 65, 100, 257, 1000, 4000, 8999, 9000, 3, 10]
    starts = [int(rng.integers(0, 9001 - n)) for n in lens[:-2]] + [8998, -1]
    st, ln = (torch.tensor(x, dtype=torch.int32) for x in (starts, lens))
    n = hash_ops.chunk_hash_ranges.launches
    got = hash_ops.chunk_hash_ranges(flat.to(card), st.to(card), ln.to(card), bits)
    torch.cuda.synchronize()
    assert hash_ops.chunk_hash_ranges.launches == n + 1
    want = hash_ref.chunk_hash_ranges_ref(flat, st, ln, bits)
    assert torch.equal(got.cpu(), want) and want[-2:].tolist() == [-1, -1]
    assert got.cpu()[:-2].tolist() == [hrtree.chunk_hash(flat[s:s + k].tolist(), bits)
                                      for s, k in zip(starts, lens[:-2])]


@pytest.mark.parametrize("bits", [8, 32])
def test_chunk_hash_ranges_short_long_and_unaligned(card, bits):
    """Every length 0..40 (shorter than a round of the kernel's lane
    group) at each 4-byte slot of a 16-byte line, lengths past 1,024, and
    the same over a view of the tokens that starts mid-line: bit-exact."""
    rng = np.random.default_rng(40 + bits)
    base = torch.from_numpy(rng.integers(0, TOP, 6003, endpoint=True).astype(np.int32))
    base[7] = TOP
    lens = [n for n in range(41) for _ in range(4)] + [1025, 1100, 3000, 5990]
    starts = [100 + 9 * i + i % 4 for i in range(41 * 4)] + [3, 1, 2999, 0]
    st, ln = (torch.tensor(v, dtype=torch.int32) for v in (starts, lens))
    for off in (0, 1, 3):                  # the view's first token's slot in its line
        flat = base[off:6000 + off]
        got = hash_ops.chunk_hash_ranges(flat.to(card), st.to(card), ln.to(card), bits)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), hash_ref.chunk_hash_ranges_ref(flat, st, ln, bits))
        assert got.cpu().tolist() == [hrtree.chunk_hash(flat[s:s + k].tolist(), bits)
                                      for s, k in zip(starts, lens)]


@pytest.mark.parametrize("width", [1, 3, 5, 31, 1100])
def test_chunk_hash_fixed_short_and_long_widths(card, width):
    """Widths under a lane group's round and past 1,024, in rows that start
    at every 4-byte slot of a line (a view of a flat buffer): bit-exact."""
    rng = np.random.default_rng(width)
    B, S = 3, 4 * width
    flat = torch.from_numpy(rng.integers(0, TOP, B * S + 3, endpoint=True).astype(np.int32))
    for off in (0, 1, 2, 3):
        toks = flat[off:off + B * S].view(B, S)
        got = hash_ops.chunk_hash_fixed(flat.to(card)[off:off + B * S].view(B, S), width, 16)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), hash_ref.chunk_hash_fixed_ref(toks, width, 16))


def test_chunk_hash_launch_floor_runs(card):
    """The empty kernel with the ranged entry's launch shape runs."""
    hash_ops.launch_floor(44, card)
    torch.cuda.synchronize()


def test_preprocess_batch_on_card_matches_cpu(card):
    rng = np.random.default_rng(0)
    lengths = build_lengths([40, 120, 200], 8)
    prompts = [rng.integers(0, 128_256, n).tolist() for n in (0, 5, 64, 80, 300, 600, 2000)]
    for L in (lengths, [64], [100], []):
        got = hrtree.preprocess_batch(prompts, L, device=card)
        assert got == hrtree.preprocess_batch(prompts, L, device="cpu")
        assert got == [hrtree.preprocess(p, L) for p in prompts]


def _overlay_migration(cfg, params, dev):
    """The replicate scenario of tests/test_kv_migration.py with the
    port's nodes on ``dev``: seed a 96-token prefix on m0, make m0 look
    pressured, then three siblings at m1 pull its pages."""
    net = SimNet(seed=5)
    nodes = [ModelNode(f"m{i}", fwd_cfg=ForwardingConfig(), use_crypto=False,
                       real_engine=RealEngine(cfg, LM(cfg, dev), params, max_len=128,
                                              device=dev))
             for i in range(2)]
    for n in nodes:
        net.add_node(n.node_id, n)
        n.join_group(["m0", "m1"])
    sink = ResponseSink()
    net.add_node("sink", sink)
    shared = [7] * 96
    nodes[0]._process(net, direct_payload("seed", shared + [1] * 8, 2), forwarded=True)
    net.run_until(net.t + 30)
    for n in nodes:
        n.broadcast_state(net)
    net.run_until(net.t + 5)
    nodes[1].peers["m0"].active_requests = 6
    nodes[1].peers["m0"].kv_pressure = 0.95
    for i in range(3):
        net.call_after(0.01, nodes[1]._process, net,
                       direct_payload(f"sib{i}", shared + [10 + i] * 8, 4))
    net.run_until(net.t + 60)
    for n in nodes:
        assert n.hrtree.device.type == torch.device(dev).type
        n.real_engine.allocator.check()
    return sink.got, [n.metrics for n in nodes]


def test_overlay_on_card_matches_cpu(card):
    """Two model nodes on the card (trees hashing through the kernel) and
    on the CPU: the same outputs and the same node metrics, the simulated
    times included."""
    cfg = configs.get_config(NAME).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n = hash_ops.chunk_hash_ranges.launches
    got_card = _overlay_migration(cfg, _to(params, card), "cuda")
    assert hash_ops.chunk_hash_ranges.launches > n
    got_cpu = _overlay_migration(cfg, params, "cpu")
    assert got_card == got_cpu
    assert got_card[1][1]["kv_imported_pages"] == 3 and len(got_card[0]) == 4


def _privacy_overlay(cfg, params, dev, monkeypatch):
    """The port's whole overlay (onion proxies, S-IDA cloves, signed
    responses) over two model nodes with their own engines on ``dev``:
    four users send at once, two of them sharing a 64-token prefix.  Keys,
    path ids and sync start times come from one restarted stream."""
    monkeypatch.setattr(os, "urandom", random.Random(0).randbytes)
    random.seed(0)
    ov = build_overlay(OverlayConfig(n_users=12, n_models=2, use_crypto=True,
                                     sync_every=2.0, seed=0), device=dev)
    for m in ov.models:
        m.real_engine = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
        assert m.hrtree.device.type == torch.device(dev).type
    shared = [7] * 64
    prompts = [shared + [1] * 8, shared + [2] * 8, [3] * 40,
               [(37 * j) % cfg.vocab for j in range(50)]]
    got = {}
    for i, p in enumerate(prompts):
        u = ov.users[3 * i]
        u.on_response = lambda _n, pl, i=i: got.setdefault(i, pl)
        u.send_prompt(ov.net, p, extra_meta={"max_new": 8})
    ov.net.run_until(ov.net.t + 120)
    return got, {m.node_id: {"metrics": m.metrics,
                             "sched": m._real_sched and m._real_sched.metrics,
                             "engine": (m.real_engine.prefill_dispatches,
                                        m.real_engine.prefill_tokens,
                                        m.real_engine.batched_traces)}
                 for m in ov.models}


def test_privacy_overlay_on_card_matches_cpu(card, monkeypatch):
    """build_overlay's users and proxies over model nodes on the card and
    on the CPU: the same responses and tokens, node metrics and scheduler
    and engine counters."""
    cfg = configs.get_config(NAME).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n = hash_ops.chunk_hash_ranges.launches
    got_card = _privacy_overlay(cfg, _to(params, card), "cuda", monkeypatch)
    assert hash_ops.chunk_hash_ranges.launches > n
    got_cpu = _privacy_overlay(cfg, params, "cpu", monkeypatch)
    assert got_card == got_cpu
    assert len(got_card[0]) == 4 and all(len(r["output"]) == 8 for r in got_card[0].values())


def test_verifier_on_card_matches_cpu(card):
    """The log-prob verifier (``LM.apply`` through the flash kernel's dense
    entry, then ``log_softmax``) on the card and on the CPU from the same
    float32 weights: full-sequence logits, log-probs of every response,
    per pair and padded into one batch, within 2e-4; credibilities too."""
    from repro_torch.core import verification as ver
    cfg = configs.get_config(NAME).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(0, cfg.vocab, 16 + 8 * i).tolist(),
              rng.integers(0, cfg.vocab, 16).tolist()) for i in range(3)] + [([], [4, 2])]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 40)).astype(np.int32))
    vs = {dev: ver.VerifierModel(cfg, LM(cfg, dev), _to(params, torch.device(dev)))
          for dev in ("cpu", "cuda")}
    n = flash_ops.flash_attention.launches
    logits = {dev: v.model.apply(v.params, toks.to(dev)).cpu() for dev, v in vs.items()}
    assert flash_ops.flash_attention.launches == n + cfg.n_layers
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=2e-4, rtol=2e-4)
    for p, r in pairs:
        np.testing.assert_allclose(ver.response_logprobs(vs["cuda"], p, r),
                                   ver.response_logprobs(vs["cpu"], p, r), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ver.credibility_batch(vs["cuda"], pairs),
                               ver.credibility_batch(vs["cpu"], pairs), atol=1e-5, rtol=2e-4)
    np.testing.assert_allclose([ver.credibility(vs["cuda"], p, r) for p, r in pairs],
                               [ver.credibility(vs["cpu"], p, r) for p, r in pairs],
                               atol=1e-5, rtol=2e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


# ------------------------------------------------------------------------
# The other families: the dense entry without a causal mask and with keys
# of their own length (encoder, cross-attention), the dense decode over a
# static memory, the paged decode at every registered head layout, and one
# full-width float32 layer of each config on the card against the CPU
# ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,Hkv,D", [(24, 1600, 32, 8, 128), (200, 1600, 32, 8, 128),
                                            (24, 1500, 8, 8, 64), (200, 1500, 8, 8, 64)])
def test_flash_noncausal_keys_of_their_own_length(card, dtype, Sq, Skv, H, Hkv, D):
    """Cross-attention prefill as ``attention.full_attention(causal=False)``
    passes it: (B, S, H, D) views, Sq queries against Skv memory keys (the
    last 64-key tile ragged at 1500), vision's and whisper's heads."""
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(40 + Sq + Skv)
    q = _randn(rng, 2, Sq, H, D).to(card, dt).transpose(1, 2)
    k, v = (_randn(rng, 2, Skv, Hkv, D).to(card, dt).transpose(1, 2) for _ in range(2))
    for softcap in (None, 50.0):
        got = flash_ops.flash_attention(q, k, v, causal=False, softcap=softcap)
        want = flash_ref.attention_ref(q.float(), k.float(), v.float(), causal=False,
                                       softcap=softcap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 64, 1500), (32, 8, 128, 1600)])
def test_dense_decode_over_a_static_memory(card, dtype, H, Hkv, D, S):
    """A cross-attention decode: every row attends all S memory positions
    (whisper's 1500 frames at G=1, D=64; vision's 1600 image tokens at
    G=4, D=128)."""
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(50 + S)
    q = _randn(rng, 4, H, D).to(card, dt)
    k, v = (_randn(rng, 4, S, Hkv, D).to(card, dt) for _ in range(2))
    lengths = torch.full((4,), S, dtype=torch.int32, device=card)
    got = dense_ops.decode_attention(q, k, v, lengths)
    want = dense_ref.decode_attention_ref(q.float(), k.float(), v.float(), lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


def _decode_layouts():
    """(G, D) of every registered config's attention, full and reduced,
    with its padded query heads."""
    seen = set()
    for name in configs.list_configs():
        full = configs.get_config(name)
        for cfg in (full, full.reduced()):
            if any("attn" in s.mixer for s in cfg.pattern):
                seen.add(((cfg.n_heads + cfg.head_pad) // cfg.n_kv_heads, cfg.d_head))
    return sorted(seen)


@pytest.mark.parametrize("G,D", _decode_layouts(), ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_every_head_layout(card, G, D, dtype):
    """The paged decode at every registered config's GQA group and head
    dim (the twin of ``test_flash_bf16_every_head_layout``), with a window
    and a softcap too, lengths past a page and a dead row."""
    dt = configs.torch_dtype(dtype)
    rng = np.random.default_rng(60 + G + D)
    Hkv = 2
    ka, va, pt = (t.to(dt) if t.is_floating_point() else t
                  for t in _arena(rng, card, P=40, Hkv=Hkv, D=D, B=3, n_pg=8))
    q = _randn(rng, 3, G * Hkv, D).to(card, dt)
    lengths = torch.tensor([256, 37, 0], dtype=torch.int32, device=card)
    for kw in (dict(), dict(window=40, softcap=30.0)):
        got = decode_ops.paged_decode_attention(q, ka, va, pt, lengths, **kw)
        want = decode_ref.paged_decode_attention_ref(q.float(), ka.float(), va.float(), pt,
                                                     lengths, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float()[:2], want[:2], **TOL[dtype])
        assert not got[2].any()


# one layer of each config at full width: the pattern position that shows
# its family (gemma2's windowed one with the softcaps, vision's and
# whisper's cross-attention, whisper with one encoder layer)
FULL_WIDTH_LAYER = {"h2o-danube-1.8b": 0, "gemma2-9b": 0, "yi-34b": 0, "granite-20b": 0,
                    "dbrx-132b": 0, "moonshot-v1-16b-a3b": 0,
                    "llama-3.2-vision-11b": 4, "whisper-base": 1}


def _full_width_layer(name):
    full = configs.get_config(name)
    return dataclasses.replace(full, n_layers=1, pattern=(full.pattern[FULL_WIDTH_LAYER[name]],),
                               n_enc_layers=min(full.n_enc_layers, 1), dtype="float32",
                               param_dtype="float32")


@pytest.mark.parametrize("name", list(FULL_WIDTH_LAYER))
def test_full_width_layer_on_card_matches_cpu(card, name):
    """One float32 layer at the config's published widths, its embedding
    and head included, on the card (kernels) and on the CPU (plain
    versions) from the same weights, within 2e-4: the paged configs'
    ``prefill_paged``, ``decode_paged`` and ``verify_paged`` over an
    8-page arena; vision's and whisper's ``prefill(aux)`` over their full memory
    (1600 image tokens; 1500 frames through the encoder) and two
    ``decode`` steps."""
    cfg = _full_width_layer(name)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    rng = np.random.default_rng(70)
    tok = rng.integers(0, cfg.vocab, size=(2, BLK)).astype(np.int32)
    outs = {}
    if LM(cfg, "cpu").supports_paging():
        pt = np.array([[3, 5, 1, 7], [4, 2, 6, 0]], np.int32)
        calls = [("prefill_paged", (pt, tok, np.array([0, 0], np.int32))),
                 ("prefill_paged", (pt, tok[::-1].copy(), np.array([32, 32], np.int32))),
                 ("decode_paged", (pt, tok[:, :1].copy(), np.array([64, 64], np.int32))),
                 ("verify_paged", (pt, tok[:, 3:8].copy(), np.array([65, 65], np.int32),
                                   np.array([5, 5], np.int32)))]
        for dev in ("cuda", "cpu"):
            m, p = LM(cfg, dev), _to(params, torch.device(dev))
            arena = m.paged_arena_zeros(8, BLK)
            outs[dev] = [getattr(m, fn)(p, arena, *[torch.tensor(a, device=dev) for a in args])
                         [0].float().cpu() for fn, args in calls]
    else:
        mem = 1500 if cfg.is_encdec else cfg.n_image_tokens
        aux = rng.standard_normal((2, mem, cfg.d_model), dtype=np.float32)
        key = "frames" if cfg.is_encdec else "image_embeds"
        for dev in ("cuda", "cpu"):
            m, p = LM(cfg, dev), _to(params, torch.device(dev))
            t = torch.from_numpy(tok).to(dev)
            logits, cache = m.prefill(p, t[:, :24], aux={key: torch.from_numpy(aux).to(dev)},
                                      max_len=32)
            res = [logits.cpu()]
            for i in range(24, 26):
                logits, cache = m.decode(p, cache, t[:, i:i + 1],
                                         torch.full((2,), i, dtype=torch.int32, device=dev))
                res.append(logits.cpu())
            outs[dev] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


# ------------------------------------------------- training: flash backward
# (B, H, Hkv, Sq, Skv, D, causal, window, softcap): llama's training shape,
# danube's window and D=80, gemma2's D=256 with its softcap, granite's 48
# query heads on one KV head, a cross-attention over 1600 keys, whisper's
# encoder
BWD_SHAPES = [(2, 32, 8, 2048, 2048, 128, True, None, None),
              (1, 32, 8, 600, 600, 80, True, 256, None),
              (1, 16, 8, 512, 512, 256, True, None, 50.0),
              (1, 48, 1, 300, 300, 128, True, None, None),
              (2, 32, 8, 256, 1600, 128, False, None, None),
              (2, 8, 8, 300, 300, 64, False, None, None),
              # a softcap of 3, where 1 - tanh^2 moves dK and dQ by far more
              # than the gate (at 50 it stays above 0.98): dK/dV walks split
              # over the group's heads (the first two) and whole
              (1, 16, 8, 384, 384, 256, True, None, 3.0),
              (1, 48, 1, 400, 400, 128, True, None, 3.0),
              (2, 16, 8, 1024, 1024, 256, True, None, 3.0),
              (2, 32, 8, 1024, 1024, 128, True, None, 3.0)]
# each gradient against the plain version's, relative to its largest entry:
# float32 sums in another order (2e-5), bfloat16 inputs and outputs (2e-2)
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _bwd_case(card, shape, dtype, seed):
    B, H, Hkv, Sq, Skv, D, causal, window, softcap = shape
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device=card).to(dtype).transpose(1, 2)
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=card).to(dtype).transpose(1, 2)
            for _ in range(2))
    do = torch.randn(B, Sq, H, D, generator=g, device=card).to(dtype).transpose(1, 2)
    return q, k, v, do, dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_flash_bwd_kernel_matches_plain(card, dtype, shape):
    """``flash_attention_bwd`` (after the forward's lse) against
    ``attention_bwd_ref`` on the same bf16 or f32 inputs; the forward's
    lse against ``lse_ref``.  float32 runs at a quarter of the sequence
    (the plain version's (B, H, Sq, Skv) tensors)."""
    if dtype == "float32":
        B, H, Hkv, Sq, Skv, D, *rest = shape
        shape = (B, H, Hkv, max(Sq // 4, 1), Skv // 4 if Skv == Sq else Skv, D, *rest)
    q, k, v, do, kw = _bwd_case(card, shape, getattr(torch, dtype), 90)
    o, lse = flash_ops._dense_forward(q, k, v, kw["causal"], kw["window"], kw["softcap"],
                                      1 / q.shape[-1] ** 0.5, with_lse=True)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, flash_ref.lse_ref(q, k, **kw), atol=1e-4, rtol=1e-5)
    want = flash_ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape and a.stride() == t.stride()
        err = (a.float() - b).abs().max() / b.abs().max()
        assert err <= BWD_TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_flash_bwd_plan_mirrors_the_source(card, dtype, shape):
    """``bwd_plan``'s scratch and splits (the CPU tests' mirror) equal the
    built source's own plan, by which the wrapper sizes its scratch."""
    B, H, Hkv, Sq, Skv, D = shape[:6]
    mirror = flash_ops.bwd_plan(B, H, Hkv, Sq, Skv, D, getattr(torch, dtype))
    assert flash_ops.launch_plan(B, H, Hkv, Sq, Skv, D, getattr(torch, dtype)) == \
        (mirror["scratch"], mirror.get("splits", 1))


def test_flash_autograd_function_matches_float64(card):
    """The plain version passes ``torch.autograd.gradcheck`` in float64 at
    a tiny shape, and the kernel's ``FlashAttention`` (float32 on the card,
    GQA, a window and a softcap) gives its gradients within 2e-5: one
    forward and one backward launch per call."""
    g = torch.Generator().manual_seed(3)
    x64 = [torch.randn(1, n, 9, 8, generator=g, dtype=torch.float64) for n in (4, 2, 2)]
    kw = dict(causal=True, window=5, softcap=3.0)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_ref.attention_ref(q, k, v, **kw),
        [t.clone().requires_grad_(True) for t in x64])
    ref_in = [t.clone().requires_grad_(True) for t in x64]
    flash_ref.attention_ref(*ref_in, **kw).pow(2).sum().backward()
    cuda_in = [t.float().to(card).requires_grad_(True) for t in x64]
    f0, b0 = flash_ops.flash_attention.launches, flash_ops.flash_attention_bwd.launches
    out = flash_ops.flash_attention(*cuda_in, **kw)
    assert out.grad_fn is not None
    out.pow(2).sum().backward()
    assert (flash_ops.flash_attention.launches - f0,
            flash_ops.flash_attention_bwd.launches - b0) == (1, 1)
    for a, b in zip(cuda_in, ref_in):
        torch.testing.assert_close(a.grad.double().cpu(), b.grad, atol=2e-5, rtol=2e-5)
    with torch.no_grad():                       # serving calls: no lse, no graph
        assert flash_ops.flash_attention(*cuda_in, **kw).grad_fn is None


def test_kernels_without_a_backward_refuse_a_gradient(card):
    """The scan, the mLSTM, the paged flash entry and both decodes raise on
    the card where autograd would need their gradient; under no_grad they
    run."""
    x = torch.randn(1, 8, 2, 16, device=card, requires_grad=True)
    la = -torch.rand(1, 8, 2, device=card)
    bc = torch.randn(1, 8, 8, device=card)
    q = torch.randn(2, 4, 16, device=card, requires_grad=True)
    kv = torch.randn(2, 64, 2, 16, device=card)
    arena = torch.randn(6, BLK, 2, 16, device=card)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=card)
    lengths = torch.tensor([40, 9], dtype=torch.int32, device=card)
    calls = {
        "mamba_scan": lambda: scan_ops.mamba_scan(x, la, bc, bc, chunk=8),
        "mlstm": lambda: mlstm_ops.mlstm_chunkwise(
            x.repeat(1, 1, 1, 4), x.repeat(1, 1, 1, 4), x.repeat(1, 1, 1, 4), la, la,
            chunk=8),
        "paged_flash_attention": lambda: flash_ops.paged_flash_attention(
            x.reshape(2, 4, 2, 16), arena, arena, pt, torch.zeros(2, dtype=torch.int32,
                                                                   device=card)),
        "decode_attention": lambda: dense_ops.decode_attention(q, kv, kv, lengths),
        "paged_decode_attention": lambda: decode_ops.paged_decode_attention(
            q, arena, arena, pt, lengths)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward kernel"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", [NAME, "jamba-v0.1-52b"])
def test_lm_loss_backward_on_card_matches_cpu(card, name):
    """One ``lm_loss`` and its gradients for reduced llama, on the card (the
    flash kernel forward and backward) against the CPU within 2e-4; jamba's
    Mamba layers refuse a gradient on the card."""
    from repro_torch.models.lm import lm_loss
    cfg = configs.get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(80)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 40)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 40)).astype(np.int32))
    res = {}
    for dev in ("cuda", "cpu") if name == NAME else ("cuda",):
        leaves = []

        def graded(t):
            if isinstance(t, dict):
                return {k: graded(v) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(graded(v) for v in t)
            leaves.append(t.detach().clone().requires_grad_(True))
            return leaves[-1]
        p = graded(_to(params, torch.device(dev)))
        call = lambda: lm_loss(cfg, LM(cfg, dev), p, toks.to(dev), labels.to(dev))  # noqa: E731
        if name != NAME:
            with pytest.raises(RuntimeError, match="mamba_scan has no backward kernel"):
                call()
            return
        loss, _ = call()
        loss.backward()
        res[dev] = [loss.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)

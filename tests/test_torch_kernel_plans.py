"""What surrounds the port's hand-written kernels, on the CPU: the split
decodes' plan (the Python twin of the span arithmetic in
``include/split_decode.cuh``, shared by the paged and the dense decode),
the algebra of their in-launch combine against the unsplit plain version,
the flash kernel's launch plan (rows and shared memory) for every head
layout a registered config has, in both registries, and the mLSTM's
split (``kernels/mlstm/ref.py`` ``mlstm_tiled``: the gate pre-pass, the
state in tiles, the no-state boot path, the bf16 pairs) against the JAX
kernel and the plain version, with its launch plan.  A launch refused for
too much shared memory never runs, so these catch it before the card."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.mlstm.ops import mlstm_chunkwise as j_mlstm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dense_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dense_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm import ref as mlstm_ref  # noqa: E402
from repro_torch.kernels.paged_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.paged_decode import ref as decode_ref  # noqa: E402
from repro_torch.models.xlstm import mlstm_dims  # noqa: E402

BLK = 32


# ------------------------------------------------ paged decode: the split plan
@settings(max_examples=300, deadline=None)
@given(n_pg=st.integers(1, 64), data=st.data(),
       B=st.integers(1, 8), Hkv=st.sampled_from([1, 2, 8]))
def test_split_spans_cover_every_visible_page_once(n_pg, data, B, Hkv):
    length = data.draw(st.integers(0, n_pg * BLK + 40), label="length")
    window = data.draw(st.one_of(st.none(), st.integers(1, n_pg * BLK + 8)),
                       label="window")
    splits = decode_ops.n_splits(B, Hkv, n_pg)
    assert 1 <= splits <= n_pg, "never more splits than pages"
    spans = decode_ops.split_spans(length, window, n_pg, splits, BLK)
    assert len(spans) == splits
    # the visible positions, and the pages holding them
    first = max(0, length - window) if window else 0
    visible = range(first, min(length, n_pg * BLK))
    pages = sorted({p // BLK for p in visible})
    covered = [j for lo, hi in spans for j in range(lo, hi)]
    assert sorted(covered) == pages, "each visible page in exactly one span"
    for lo, hi in spans:
        assert lo <= hi
        if lo >= -(-min(length, n_pg * BLK) // BLK):
            assert hi == lo, "a span past the length is empty"
        assert lo == hi or (0 <= lo and hi <= n_pg), "a span reads only pages of the table"


def test_n_splits_fill_the_card_at_the_serving_shape():
    """The dense decode's rule: B=4 rows x 8 KV heads, 9 splits (288
    blocks, two an SM of 132) over a 32-page table; one row of one KV head
    at most one split a page."""
    assert decode_ops.n_splits(4, 8, 32) == 9
    assert decode_ops.n_splits(1, 8, 32) == 32
    assert decode_ops.n_splits(1, 1, 4) == 4
    assert decode_ops.n_splits(64, 8, 32) == 1


# ------------------------------------------- paged decode: the combine algebra
@pytest.mark.parametrize("window,softcap", [(None, None), (256, None), (None, 50.0),
                                            (300, 50.0)])
def test_combined_split_partials_equal_the_unsplit_plain_version(window, softcap):
    """Full width (B=4, H=32, Hkv=8, D=128) at the timed lengths [1000,
    517, 0, 33]: per-span plain partials, combined as the kernel combines
    them, equal the unsplit plain version within 1e-6 in float32.  Spans
    past the length are empty, row 2 is dead, a window of 300 starts
    inside a span."""
    rng = np.random.default_rng(3)
    B, H, Hkv, D, P, n_pg = 4, 32, 8, 128, 140, 32
    ka = torch.from_numpy(rng.normal(size=(P, BLK, Hkv, D)).astype(np.float32))
    va = torch.from_numpy(rng.normal(size=(P, BLK, Hkv, D)).astype(np.float32))
    pt = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * n_pg]
                          .reshape(B, n_pg).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    lengths = torch.tensor([1000, 517, 0, 33], dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, scale=D ** -0.5)
    splits = decode_ops.n_splits(B, Hkv, n_pg)
    spans = [decode_ops.split_spans(n, window, n_pg, splits, BLK) for n in lengths.tolist()]
    assert any(lo == hi for row in spans for lo, hi in row), "some span is empty"
    parts = [decode_ref.partials_ref(
        q, ka, va, pt, lengths, torch.tensor([row[sp][0] for row in spans]),
        torch.tensor([row[sp][1] for row in spans]), **kw) for sp in range(splits)]
    acc, m, l = (torch.stack([p[i] for p in parts], dim=2) for i in range(3))
    got = decode_ref.combine_partials(acc, m, l)
    want = decode_ref.paged_decode_attention_ref(q, ka, va, pt, lengths, **kw)
    live = lengths > 0
    torch.testing.assert_close(got[live], want[live], atol=1e-6, rtol=1e-6)
    assert not got[~live].any(), "a dead row combines to zeros"


# ---------------------------------------------------- flash: the launch plan
def _attention_layouts():
    """(name, G, D) of every registered config with attention layers, in
    both registries, full and reduced, with and without padded heads."""
    def has_attention(cfg):
        return any("attn" in spec.mixer for spec in cfg.pattern)

    seen = []
    for registry in (base, configs):
        names = registry.list_configs() if hasattr(registry, "list_configs") \
            else sorted(registry._REGISTRY)
        for name in names:
            full = registry.get_config(name)
            for cfg in (full, full.reduced()):
                if not has_attention(cfg):
                    continue
                for heads in {cfg.n_heads, cfg.n_heads + cfg.head_pad}:
                    entry = (name, heads // cfg.n_kv_heads, cfg.d_head)
                    if entry not in seen:
                        seen.append(entry)
    return seen


LAYOUTS = _attention_layouts()


def test_the_layouts_cover_every_group_and_head_dim():
    groups = {g for _, g, _ in LAYOUTS}
    dims = {d for _, _, d in LAYOUTS}
    assert {1, 2, 4, 6, 7, 48} <= groups and {16, 64, 80, 128, 256} <= dims


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,G,D", LAYOUTS, ids=[f"{n}-G{g}-D{d}" for n, g, d in LAYOUTS])
def test_flash_plan_fits_every_config(name, G, D, dtype):
    """The wrapper takes the shape, and at every query length the serving
    paths give (a decode-sized verify window, a prefill chunk, a boot
    prompt, a long prompt) the block's rows stay within the kernel's limit
    and its shared memory within the card's 232,448 bytes."""
    flash_ops.check_heads(G * 2, 2, D, dtype)
    for Sq in (1, 5, 8, 32, 33, 1024):
        p = flash_ops.plan(G, D, Sq, dtype)
        assert 1 <= p["tq"] <= Sq
        assert p["rows"] == G * p["tq"] <= p["max_rows"]
        assert p["smem"] <= flash_ops.SMEM_LIMIT, p
        if dtype == torch.bfloat16:      # whole 64-row warpgroups, two at most
            assert p["threads"] in (128, 256) and p["rows"] <= 64 * (p["threads"] // 128)
            if D > 128:
                assert p["threads"] == 128, "one warpgroup at D > 128"


def test_flash_plan_at_the_serving_shapes():
    """llama's prefill chunk (G=4, 32 queries) fills two warpgroups in
    bf16; gemma2's D=256 takes one; the float32 body keeps 64 rows."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert flash_ops.plan(4, 128, 32, bf16) == {
        "tq": 32, "rows": 128, "max_rows": 128, "threads": 256,
        "smem": 1024 + 128 * 128 * 2 + 3 * 2 * 64 * 128 * 2}
    assert flash_ops.plan(2, 256, 1024, bf16)["threads"] == 128
    assert flash_ops.plan(4, 128, 32, f32)["tq"] == 16
    assert flash_ops.padded_width(80) == 128 and flash_ops.padded_width(16) == 64


@pytest.mark.parametrize("H,Hkv,D,dtype", [(32, 8, 12, torch.bfloat16),
                                           (32, 8, 264, torch.bfloat16),
                                           (130, 1, 128, torch.bfloat16),
                                           (80, 1, 256, torch.bfloat16),
                                           (65, 1, 16, torch.float32),
                                           (30, 8, 128, torch.float32)])
def test_flash_refuses_shapes_no_config_has(H, Hkv, D, dtype):
    with pytest.raises(ValueError):
        flash_ops.check_heads(H, Hkv, D, dtype)


def _paged_decode_smem(G, D, blk, splits, esize):
    """Dynamic shared memory of one paged-decode block, as
    include/split_decode.cuh ``smem_bytes`` sums it: a ring of kStages (2
    in bf16, 3 in float32) K and V pages, then float32 q, scores, the
    kThreads (256) key groups' sums and the combine's weights."""
    stages = {2: 2, 4: 3}[esize]
    return (stages * 2 * blk * D * esize
            + 4 * (G * D + G * blk + 256 * (16 // esize + 1) + G * (splits + 1)))


def test_paged_decode_shared_memory_fits_every_config():
    """The paged decode's block (page ring, q, scores, sums, weights) fits
    the card for every registered layout at both dtypes, with the most
    splits a 1024-token table gives."""
    for _, G, D in LAYOUTS:
        assert G * D <= decode_ops.MAX_GROUP_DIMS
        for esize in (2, 4):
            assert _paged_decode_smem(G, D, BLK, 32, esize) <= flash_ops.SMEM_LIMIT



# ------------------------------------------ dense decode: spans and combine
@pytest.mark.parametrize("length", [9, 100, 600])
def test_dense_decode_one_row_combines_its_live_splits(length):
    """A teacher-forced prompt token of jamba's attention (B=1, H=32,
    Hkv=8, D=128) over a 1024-position cache: 32 splits of one tile each,
    most of them empty.  The live spans come first and cover every visible
    tile once; the plain partials of the live spans alone (the empty
    blocks return without a record), combined as the kernel combines them,
    equal the unsplit plain version within 1e-6 in float32."""
    rng = np.random.default_rng(length)
    B, H, Hkv, D, S = 1, 32, 8, 128, 1024
    tiles = S // BLK
    splits = dense_ops.n_splits(B, Hkv, S)
    assert splits == 32
    spans = decode_ops.split_spans(length, None, tiles, splits, BLK, positions=S)
    live = [lo < hi for lo, hi in spans]
    n_live = sum(live)
    assert live == [True] * n_live + [False] * (splits - n_live), "live spans first"
    assert n_live == -(-length // BLK) < splits, "most splits are empty"
    assert [j for lo, hi in spans for j in range(lo, hi)] == list(range(n_live))
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
            for _ in range(2))
    lengths = torch.tensor([length], dtype=torch.int32)
    # the dense cache as an arena of 32-position tiles, one table row a row
    arena = [t.reshape(B * tiles, BLK, Hkv, D) for t in (k, v)]
    table = torch.arange(B * tiles, dtype=torch.int32).reshape(B, tiles)
    parts = [decode_ref.partials_ref(q, *arena, table, lengths, torch.tensor([lo]),
                                     torch.tensor([hi]), scale=D ** -0.5)
             for lo, hi in spans[:n_live]]
    acc, m, l = (torch.stack([p[i] for p in parts], dim=2) for i in range(3))
    got = decode_ref.combine_partials(acc, m, l)
    want = dense_ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_dense_decode_spans_clamp_to_the_cache():
    """A length past a ragged cache (S = 1000) is clamped to S, as the
    kernel clamps it: a window that starts past the cache sees nothing."""
    tiles = -(-1000 // BLK)
    assert decode_ops.split_spans(1010, 5, tiles, 4, BLK, positions=1000) == [(31, 31)] * 4
    assert decode_ops.split_spans(1010, None, tiles, 4, BLK, positions=1000)[-1] == (24, 32)


# ------------------------------------------------- mLSTM: the kernels' split
def _mlstm_inputs(B, S, H, dh, seed, state):
    """The card tests' distributions (q at the model's 1/sqrt(dh) scale),
    made with numpy."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    q, k, v = f(B, S, H, dh, scale=dh ** -0.5), f(B, S, H, dh), f(B, S, H, dh)
    log_i = f(B, S, H, scale=2.0)
    log_f = torch.nn.functional.logsigmoid(f(B, S, H) + 4)
    st = (f(B, H, dh, dh, scale=0.1), f(B, H, dh, scale=0.1), f(B, H)) if state else None
    return q, k, v, log_i, log_f, st


def _to_jax_layout(x, L):
    """(B, S, H, ...) with S = C * L -> (B, H, C, L, ...) as numpy."""
    a = x.numpy()
    B, S, H = a.shape[:3]
    a = a.reshape(B, S // L, L, H, *a.shape[3:])
    return jnp.asarray(np.moveaxis(a, 3, 1))


@pytest.mark.parametrize("B,S,H,dh,L,state", [
    (2, 16, 2, 32, 16, False),     # the boot path: no state, one chunk
    (2, 48, 2, 32, 16, True),      # the recurrent walk from a state
    (1, 64, 2, 64, 32, False),     # the walk from an empty state, two chunks
], ids=["boot", "walk-state", "walk-empty"])
def test_mlstm_split_matches_the_jax_kernel(B, S, H, dh, L, state):
    """The split (gate pre-pass, tiles of C, the boot path) in float32
    against ``mlstm_pallas`` in interpret mode, at the JAX kernel test's
    tolerances (tests/test_kernels.py:139-147)."""
    q, k, v, gi, gf, st = _mlstm_inputs(B, S, H, dh, 21, state)
    assert (st is None and S <= L) == (L == S)
    h, (C, n, m) = mlstm_ref.mlstm_tiled(q, k, v, gi, gf, st, chunk=L, scale=0.17)
    jst = None if st is None else tuple(jnp.asarray(t.numpy()) for t in st)
    jh, (jC, jn, jm) = j_mlstm(*(_to_jax_layout(t, L) for t in (q, k, v, gi, gf)), jst,
                               impl="interpret", scale=0.17)
    jh = np.moveaxis(np.asarray(jh), 1, 3).reshape(B, S, H, dh)
    np.testing.assert_allclose(h.numpy(), jh, rtol=2e-4, atol=2e-4)
    for got, want in ((C, jC), (n, jn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)


def test_mlstm_gate_prepass_is_the_per_chunk_gates():
    """The gates worked out before any product, chunk summaries chained on
    one thread, are the ones the per-chunk walk of the plain version
    computes, bit for bit, and so is the final m."""
    _, _, _, gi, gf, st = _mlstm_inputs(2, 150, 3, 32, 22, True)
    (b, m_new, inter, w), m = mlstm_ref.chunk_gates(gi, gf, st[2], 64)
    mp = st[2]
    for t0 in range(0, 150, 64):
        sl = slice(t0, t0 + 64)
        bb = torch.cumsum(gf[:, sl], dim=1)
        run = torch.cummax(gi[:, sl] - bb, dim=1).values
        mn = bb + torch.maximum(mp[:, None], run)
        assert torch.equal(b[:, sl], bb) and torch.equal(m_new[:, sl], mn)
        assert torch.equal(inter[:, sl], torch.exp(bb + mp[:, None] - mn))
        assert torch.equal(w[:, sl], torch.exp(bb[:, -1:] - bb + gi[:, sl] - mn[:, -1:]))
        mp = mn[:, -1]
    assert torch.equal(m, mp)


BF16_TOL = dict(atol=2e-2, rtol=2e-2)    # the card tests' bf16 tolerance


def _tol_ratio(got, want):
    return ((got - want).abs() / (BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs())).max().item()


@pytest.mark.parametrize("B,S,state", [(2, 40, False), (1, 100, True)],
                         ids=["boot", "walk-state"])
def test_mlstm_bf16_pairs_hold_the_bf16_tolerance_at_full_width(B, S, state):
    """xlstm-1.3b's head width (dh = 1024, L = 64), bf16 inputs: the split
    with the bf16 kernels' operands (att, k o w and the copy of C as hi +
    lo pairs of bf16, h rounded to bf16) against the plain version in
    float32 within the card tests' bf16 tolerance, h and the state."""
    q, k, v, gi, gf, st = _mlstm_inputs(B, S, 1, 1024, 23, state)
    x = [t.to(torch.bfloat16) for t in (q, k, v)]
    h, fin = mlstm_ref.mlstm_tiled(*x, gi, gf, st, chunk=64, rounding="pair")
    wh, wfin = mlstm_ref.mlstm_ref(*[t.float() for t in x], gi, gf, st, chunk=64)
    assert h.dtype == torch.bfloat16
    torch.testing.assert_close(h.float(), wh, **BF16_TOL)
    for got, want in zip(fin, wfin):
        torch.testing.assert_close(got, want, **BF16_TOL)


def test_mlstm_one_bf16_rounding_misses_the_tolerance():
    """Why the pairs: h's denominator cancels, so one bf16 rounding of the
    float32 operands (att, k o w, C) puts h past the bf16 tolerance at the
    full width, while the pairs keep it well inside."""
    q, k, v, gi, gf, st = _mlstm_inputs(1, 100, 1, 1024, 23, True)
    x = [t.to(torch.bfloat16).float() for t in (q, k, v)]
    wh, _ = mlstm_ref.mlstm_ref(*x, gi, gf, st, chunk=64)
    once, _ = mlstm_ref.mlstm_tiled(*x, gi, gf, st, chunk=64, rounding="bf16")
    pair, _ = mlstm_ref.mlstm_tiled(*x, gi, gf, st, chunk=64, rounding="pair")
    assert _tol_ratio(once, wh) > 1 > 10 * _tol_ratio(pair, wh)


def _mlstm_head_dims():
    """Every mLSTM head width of the registered configs, full and reduced,
    and the JAX kernel test's 64."""
    dims = {64}
    for name in sorted(configs._REGISTRY):
        for cfg in (configs.get_config(name), configs.get_config(name).reduced()):
            if any(sp.mixer == "mlstm" for sp in cfg.pattern):
                dims.add(mlstm_dims(cfg)[2])
    return sorted(dims)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", _mlstm_head_dims())
def test_mlstm_plan_fits_every_config(dh, dtype):
    """At every mLSTM head width and chunk length L <= 64, with and without
    a state, one chunk or several: the path is the boot path exactly for
    bf16 with no state and one chunk, each kernel's shared memory fits the
    card's 232,448 bytes, and the grids cover the heads and columns."""
    assert {32, 1024} <= set(_mlstm_head_dims())
    for L in (1, 5, 8, 16, 32, 64):
        for S in (L, 3 * L + 1):
            for state in (False, True):
                p = mlstm_ops.plan(2, S, 4, dh, L, dtype, state)
                boot = dtype == torch.bfloat16 and not state and S <= L
                assert (p["path"] == "boot") == boot
                assert p["path"] == "scalar" or dtype == torch.bfloat16
                for kn in p["kernels"]:
                    assert kn["smem"] <= mlstm_ops.MAX_SMEM, (L, S, state, kn)
                    assert kn["threads"] <= 1024 and kn["threads"] % 128 == 0
                grids = [kn["grid"] for kn in p["kernels"]]
                if boot:   # the e-groups' blocks of C', one more of h
                    assert grids == [(8, -(-dh // 64), -(-dh // 256) + 1)]
                else:
                    assert grids == [(-(-S // L), 8), (8, dh // 32)]


def test_mlstm_plan_at_the_serving_shapes():
    """xlstm-1.3b's boot prefill (one launch over 4 heads x 16 column
    tiles x (4 e-groups + 1 of h)) and its 2048-token prefill (32 scores
    blocks, then 128 recurrent blocks of four warpgroups, 220 KB of shared
    memory)."""
    bf16 = torch.bfloat16
    boot = mlstm_ops.plan(1, 8, 4, 1024, 8, bf16, False)
    assert [(k["name"], k["grid"]) for k in boot["kernels"]] == [("boot_tc", (4, 16, 5))]
    walk = mlstm_ops.plan(1, 2048, 4, 1024, 64, bf16, True)
    assert [(k["name"], k["grid"], k["threads"]) for k in walk["kernels"]] == [
        ("scores_tc", (32, 4), 128), ("recurrent_tc<4,4>", (4, 32), 512)]
    assert walk["kernels"][1]["smem"] == 1024 + 4 * 32768 + 4096 + 8192 + 4 * 8192 + 4 * (
        3 * 2048 + 4 * 64 + 2 * 256 + 64 * 64 + 1024) == 225_280
    assert mlstm_ops.warpgroups(32) == (1, 1) and mlstm_ops.warpgroups(1024) == (4, 4)

"""What surrounds the port's hand-written kernels, on the CPU: the split
decodes' plan (the Python twin of the span arithmetic in
``include/split_decode.cuh``, shared by the paged and the dense decode),
the algebra of their in-launch combine against the unsplit plain version,
the flash kernel's launch plan (rows and shared memory) for every head
layout a registered config has, in both registries, the mLSTM's split
(``kernels/mlstm/ref.py`` ``mlstm_tiled``: the gate pre-pass, the state
in tiles, the no-state boot path, the bf16 pairs) and the SSD scan's
(``kernels/mamba_scan/ref.py`` ``mamba_scan_tiled``: chunk states, state
passing, chunk outputs, the boot path, the bf16 roundings) against the
JAX kernels and the plain versions, with their launch plans, and the
chunk hash's lane split (``kernels/chunk_hash/ref.py``
``chunk_hash_lanes``) against ``core/hrtree.chunk_hash``; and the launch
plans of the scan's and the mLSTM's backward kernels.  A launch
refused for too much shared memory never runs, so these catch it before
the card."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.mamba_scan.kernel import mamba_scan_pallas  # noqa: E402
from repro.kernels.mlstm.ops import mlstm_chunkwise as j_mlstm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import hrtree  # noqa: E402
from repro_torch.kernels.chunk_hash import ops as hash_ops  # noqa: E402
from repro_torch.kernels.chunk_hash import ref as hash_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dense_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dense_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm import ref as mlstm_ref  # noqa: E402
from repro_torch.kernels.paged_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.paged_decode import ref as decode_ref  # noqa: E402
from repro_torch.models import mamba as mamba_model  # noqa: E402
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


@pytest.mark.parametrize("name,G,D", LAYOUTS, ids=[f"{n}-G{g}-D{d}" for n, g, d in LAYOUTS])
def test_flash_bwd_plan_fits_every_config(name, G, D):
    """The backward kernel (csrc/flash_attention_bwd.cu) at every
    registered config's (G, D): its checks pass in both dtypes, and at the
    training shape, whisper's encoder, a cross-attention over 1600 keys and
    ragged lengths its plan (``bwd_plan``, the twin of ``launch_f32`` and
    ``launch_bf16``) keeps every launch's shared memory within the card's
    232,448 bytes.  float32: the scalar body, a dK/dV block per (row, KV
    head, 32 keys), a dQ block per (row, query head, 32 queries).  bf16: the
    wgmma body, a dK/dV block (one warpgroup) per (row, KV head, 64 keys,
    split of the group's heads; twice at D > 128, dV then dK), the split
    sum only where split, a dQ block per (row, KV head, tq query indices)
    with the forward's rows; the scratch holds Delta and the partials."""
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (f32, bf16):
        flash_ops.check_bwd(G * 2, 2, D, dtype)
    for Sq, Skv in ((2048, 2048), (1500, 1500), (256, 1600), (33, 33), (1, 5)):
        for dtype in (f32, bf16):
            p = flash_ops.bwd_plan(3, G * 2, 2, Sq, Skv, D, dtype)
            delta, *rest = p["launches"]
            assert delta["grid"] == (-(-3 * G * 2 * Sq // 8),) and delta["smem"] == 0
            assert all(k["smem"] <= flash_ops.SMEM_LIMIT for k in p["launches"])
            if dtype == f32:
                dkdv, dq = rest
                assert p["body"] == "scalar" and p["scratch"] == 3 * G * 2 * Sq
                assert dkdv["grid"] == (3 * 2, -(-Skv // flash_ops.BWD_BK))
                assert dq["grid"] == (3 * G * 2, -(-Sq // flash_ops.BWD_BQ))
                assert all(k["threads"] == 256 for k in p["launches"])
                continue
            splits, hps = p["splits"], p["heads_per_split"]
            assert p["body"] == "wgmma" and (splits - 1) * hps < G <= splits * hps
            walks = [k for k in rest if k["name"] == "dkdv_tc_kernel"]
            assert [k["pass"] for k in walks] == (["dv", "dk"] if D > 128 else ["dk+dv"])
            for k in walks:
                assert k["grid"] == (3 * 2, -(-Skv // flash_ops.BWD_TILE), splits)
                assert k["threads"] == 128
            n_grad = 3 * 2 * Skv * D
            assert [k["name"] for k in rest[len(walks):]] == \
                ["dkdv_sum_kernel"] * (splits > 1) + ["dq_tc_kernel"]
            assert p["scratch"] == -(-3 * G * 2 * Sq // 4) * 4 + 2 * splits * n_grad * (splits > 1)
            dq = rest[-1]
            fwd = flash_ops.plan(G, D, Sq, bf16)
            assert dq["tq"] == fwd["tq"] and G * dq["tq"] <= flash_ops.max_rows(D, bf16)
            assert dq["grid"] == (3 * 2, -(-Sq // dq["tq"])) and dq["threads"] == fwd["threads"]


def test_flash_bwd_smem_at_the_training_shapes():
    """Shared memory of the backward's blocks, as csrc/flash_attention_bwd.cu
    sizes it.  float32 (``launch_f32``): K, V, Q and dO tiles of 32 rows of
    D + 4, the dK and dV (or dQ) sums, P and dS tiles, lse and Delta.  bf16
    (``DkdvLayout``, ``DqLayout``): the dK/dV block's K and V tiles of 64
    keys x D padded to 128 or 256, two stages of Q and dO tiles and their
    lse and Delta, so two blocks an SM at llama's D=128 (one at gemma2's
    D=256); the dQ block's 128 (D=128) or 64 (D=256) rows of Q and dO and a
    ring of three (two at D=256) K/V tiles."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert flash_ops.bwd_smem_bytes(128, f32) == {
        "dkdv": 4 * (4 * 32 * 132 + 2 * 32 * 128 + 2 * 32 * 32 + 64),
        "dq": 4 * (4 * 32 * 132 + 32 * 128 + 32 * 32 + 64)} == \
        {"dkdv": 108_800, "dq": 88_320}
    assert flash_ops.bwd_smem_bytes(256, f32)["dkdv"] == 207_104 <= flash_ops.SMEM_LIMIT
    assert 2 * flash_ops.bwd_smem_bytes(128, f32)["dkdv"] <= 228 * 1024
    tile128, tile256 = 64 * 128 * 2, 64 * 256 * 2
    assert flash_ops.bwd_smem_bytes(128, bf16) == {
        "dkdv": 1024 + 2 * tile128 + 2 * (2 * tile128 + 512),
        "dq": 1024 + 2 * 128 * 128 * 2 + 3 * 2 * tile128} == \
        {"dkdv": 100_352, "dq": 164_864}
    assert flash_ops.bwd_smem_bytes(80, bf16) == flash_ops.bwd_smem_bytes(128, bf16)
    assert flash_ops.bwd_smem_bytes(256, bf16) == {
        "dkdv": 1024 + 2 * tile256 + 2 * (2 * tile256 + 512),
        "dq": 1024 + 2 * 64 * 256 * 2 + 2 * 2 * tile256} == \
        {"dkdv": 198_656, "dq": 197_632}
    assert 2 * (flash_ops.bwd_smem_bytes(128, bf16)["dkdv"] + 1024) <= 228 * 1024
    # the plan's dQ rows at the training shape: 4 heads x 32 queries
    train = flash_ops.bwd_plan(2, 32, 8, 2048, 2048, 128, bf16)
    assert train["launches"][-1]["smem"] == 164_864 and train["splits"] == 1


@pytest.mark.parametrize("B,H,Hkv,S,D,splits,hps", [
    (2, 32, 8, 2048, 128, 1, 4),      # llama's training shape: 512 blocks, no split
    (2, 48, 1, 2048, 128, 8, 6),      # granite: 64 blocks -> 512
    (1, 48, 1, 512, 128, 16, 3),      # granite, short: at most 16 splits
    (1, 32, 8, 600, 80, 4, 1),        # danube, 80 blocks: one head a split
    (2, 8, 8, 300, 64, 1, 1),         # whisper's encoder: G = 1 never splits
    (2, 16, 8, 2048, 256, 1, 2)])     # gemma2 at the training shape
def test_flash_bwd_splits_fill_the_card(B, H, Hkv, S, D, splits, hps):
    """``bwd_splits`` (``launch_bf16``'s rule): a dK/dV grid under one
    block an SM (132) splits the group's query heads to about four blocks
    an SM, at most 16 splits; the splits' partials follow Delta in the
    scratch, 16-byte aligned."""
    p = flash_ops.bwd_plan(B, H, Hkv, S, S, D, torch.bfloat16)
    assert (p["splits"], p["heads_per_split"]) == (splits, hps) == \
        flash_ops.bwd_splits(B, Hkv, H // Hkv, S)
    base = B * Hkv * -(-S // 64)
    walk = p["launches"][1]
    assert walk["grid"] == (B * Hkv, -(-S // 64), splits)
    assert splits == 1 or base < flash_ops.BWD_SMS
    assert splits == 1 or base * splits >= min(3 * flash_ops.BWD_SMS,
                                               base * min(H // Hkv, flash_ops.BWD_MAX_SPLITS))
    assert ("dkdv_sum_kernel" in [k["name"] for k in p["launches"]]) == (splits > 1)


@pytest.mark.parametrize("H,Hkv,D,dtype", [(32, 8, 12, torch.bfloat16),
                                           (32, 8, 264, torch.bfloat16),
                                           (30, 8, 128, torch.float32),
                                           (32, 8, 128, torch.float16),
                                           (130, 1, 128, torch.bfloat16),
                                           (80, 1, 256, torch.bfloat16)])
def test_flash_bwd_refuses_shapes_no_config_has(H, Hkv, D, dtype):
    with pytest.raises((ValueError, TypeError)):
        flash_ops.check_bwd(H, Hkv, D, dtype)


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


@pytest.mark.parametrize("H,Hkv,D,S", [(32, 8, 128, 1600), (8, 8, 64, 1500)],
                         ids=["vision", "whisper"])
def test_dense_decode_over_a_static_memory_combines_every_split(H, Hkv, D, S):
    """A cross-attention decode (B=4 rows, every one of S memory positions
    visible; S = 1500 leaves a ragged last tile): the splits' spans cover
    every tile once and their plain partials, combined as the kernel
    combines them, equal the unsplit plain version within 1e-6."""
    rng = np.random.default_rng(S)
    B = 4
    tiles = -(-S // BLK)
    splits = dense_ops.n_splits(B, Hkv, S)
    assert 1 < splits <= tiles
    spans = decode_ops.split_spans(S, None, tiles, splits, BLK, positions=S)
    assert [j for lo, hi in spans for j in range(lo, hi)] == list(range(tiles))
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
            for _ in range(2))
    lengths = torch.full((B,), S, dtype=torch.int32)
    pad = tiles * BLK - S                 # the ragged tile's missing positions
    arena = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).reshape(B * tiles, BLK, Hkv, D)
             for t in (k, v)]
    table = torch.arange(B * tiles, dtype=torch.int32).reshape(B, tiles)
    parts = [decode_ref.partials_ref(q, *arena, table, lengths, torch.full((B,), lo),
                                     torch.full((B,), hi), scale=D ** -0.5)
             for lo, hi in spans if lo < hi]
    acc, m, l = (torch.stack([p[i] for p in parts], dim=2) for i in range(3))
    got = decode_ref.combine_partials(acc, m, l)
    want = dense_ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G,D,Sq", [(1, 64, 1500), (1, 64, 24), (1, 64, 4), (4, 128, 256),
                                    (4, 128, 24)])
def test_flash_plan_at_the_encoder_and_cross_shapes(G, D, Sq, dtype):
    """Whisper's encoder (1500 queries, G=1, D=64) and its decoder prompts'
    cross-attention, vision's cross-attention prefill (G=4, D=128): the
    query tiles of the grid cover every query once, within the block's
    rows and shared memory; the keys' count does not enter the plan."""
    flash_ops.check_heads(G * 8, 8, D, dtype)
    p = flash_ops.plan(G, D, Sq, dtype)
    tiles = -(-Sq // p["tq"])
    assert (tiles - 1) * p["tq"] < Sq <= tiles * p["tq"]
    assert p["rows"] == G * p["tq"] <= p["max_rows"]
    assert p["smem"] <= flash_ops.SMEM_LIMIT


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dv", [32, 64, 256, 512])
def test_mlstm_plan_with_narrow_value_columns(dv, dtype):
    """v's (and h's and C's) columns narrower than q's and k's (dh = 1024,
    a tensor-parallel rank's share of every head): the scores kernels'
    grid is unchanged, the recurrent kernels have dv / 32 column blocks a
    head, the boot path's blocks cover dv in 64-column tiles, the shared
    memory is the full width's; dv = dh is the unsplit plan."""
    for S, L, state in ((2048, 64, False), (2048, 64, True), (40, 64, False), (8, 8, False)):
        full = mlstm_ops.plan(1, S, 4, 1024, L, dtype, state)
        p = mlstm_ops.plan(1, S, 4, 1024, L, dtype, state, dv)
        assert mlstm_ops.plan(1, S, 4, 1024, L, dtype, state, 1024) == full
        assert p["path"] == full["path"]
        for kn, kf in zip(p["kernels"], full["kernels"]):
            assert (kn["name"], kn["threads"], kn["smem"]) == \
                (kf["name"], kf["threads"], kf["smem"])
            if kn["name"].startswith("scores"):
                assert kn["grid"] == kf["grid"]
            elif kn["name"] == "boot_tc":
                assert kn["grid"] == (4, -(-dv // 64), kf["grid"][2])
            else:
                assert kn["grid"] == (4, dv // 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dv", [32, 64, 256])
def test_mlstm_bwd_plan_with_narrow_value_columns(dv, dtype):
    """The backward with dv < dh = 1024 (B=1 S=2048, a rank's training
    shape): the states and column sweeps have dv / 32 blocks a head, the
    row sweep dh / 32 (its blocks carry dC's rows over dv columns); the
    scratch holds the entering C at dh x dv (float32, or bf16 tiles of
    32 x 64 with the columns past dv zeros), X's shares a column block,
    dw's, d inter_L's and the final and start states' a row block; the
    shared memory is the full width's but for the scalar row sweep's,
    which carries dv + 1 columns; dv = dh is the unsplit plan; a dv that
    is no multiple of 32, or wider than dh, is refused."""
    B, S, H, dh, L = 1, 2048, 4, 1024, 64
    full = mlstm_ops.bwd_plan(B, S, H, dh, L, dtype)
    assert mlstm_ops.bwd_plan(B, S, H, dh, L, dtype, dh) == full
    p = mlstm_ops.bwd_plan(B, S, H, dh, L, dtype, dv)
    nc, nck, ncv = S // L, dh // 32, dv // 32
    assert [k["grid"] for k in p["kernels"]] == [
        (nc, 4, 1), (4, ncv, 1), (nc, 4, 1), (4, nck, 1), (4, ncv, 1), (nc, 4, 1)]
    for kn, kf in zip(p["kernels"], full["kernels"]):
        if kn["name"] == "reverse_rows":
            assert kf["smem"] - kn["smem"] == 4 * 32 * (dh - dv)
        else:
            assert kn["smem"] == kf["smem"], kn["name"]
    cst = dh * dv if dtype == torch.float32 else nck * -(-dv // 64) * 32 * 64 // 2
    assert mlstm_ops.cst_floats(dh, dtype, dv) == cst
    rec = -(-(9 * L + 3 * L * L) // 4) * 4
    assert p["scratch"] == B * H * nc * (rec + cst + dh + ncv * L + nck * L + nck) \
        + 2 * B * H * nck
    mlstm_ops.check_bwd(dh, L, dtype, dv)
    for bad in (dv + 16, 2048):
        with pytest.raises(ValueError):
            mlstm_ops.check_bwd(dh, L, dtype, bad)


# --------------------------------------------------- SSD scan: the kernels' split
def _scan_inputs(B, S, H, P, N, seed, h0=True):
    """The card tests' distributions, made with numpy: xbar (B, S, H, P),
    loga (B, S, H), Bm and Cm (B, S, N), h0 (B, H, N, P) or None."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    xbar, loga = f(B, S, H, P, scale=0.5), -torch.nn.functional.softplus(f(B, S, H))
    Bm, Cm = f(B, S, N, scale=0.5), f(B, S, N, scale=0.5)
    return xbar, loga, Bm, Cm, (f(B, H, N, P, scale=0.1) if h0 else None)


@pytest.mark.parametrize("B,S,H,P,N,L,h0", [
    (2, 16, 2, 32, 8, 16, False),      # the boot path: no start state, one chunk
    (2, 16, 2, 32, 8, 16, True),       # one chunk from a state: three launches
    (1, 96, 2, 64, 16, 32, True),      # chunks in parallel from a state
    (2, 59, 3, 32, 8, 16, False),      # from an empty state, a ragged tail
], ids=["boot", "one-chunk-h0", "chunks-h0", "ragged-empty"])
def test_scan_split_matches_the_jax_kernel(B, S, H, P, N, L, h0):
    """The split (chunk states, state passing, chunk outputs, or the boot
    path) in float32 against ``mamba_scan_pallas`` in interpret mode at the
    port's scan tolerance (tests/test_torch_mamba.py), the ragged tail
    zero-padded for the JAX kernel as its callers pad it."""
    xbar, loga, Bm, Cm, hs = _scan_inputs(B, S, H, P, N, 31, h0)
    y, h = scan_ref.mamba_scan_tiled(xbar, loga, Bm, Cm, hs, chunk=L)
    C = -(-S // L)
    pad = C * L - S
    jx = _to_jax_layout(torch.nn.functional.pad(xbar, (0, 0, 0, 0, 0, pad)), L)
    jl = _to_jax_layout(torch.nn.functional.pad(loga, (0, 0, 0, pad)), L)
    jb, jc = (jnp.asarray(torch.nn.functional.pad(t, (0, 0, 0, pad)).numpy()
                          .reshape(B, C, L, N)) for t in (Bm, Cm))
    jy, jh = mamba_scan_pallas(jx, jl, jb, jc, None if hs is None else jnp.asarray(hs.numpy()),
                               interpret=True)
    jy = np.moveaxis(np.asarray(jy), 1, 3).reshape(B, C * L, H, P)[:, :S]
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,P,N,L,h0", [
    (1, 300, 2, 128, 16, 128, True), (2, 8, 3, 128, 16, 128, False),
    (2, 37, 2, 32, 8, 16, True), (1, 96, 4, 64, 16, 32, False)])
def test_scan_split_is_the_plain_version_in_float32(B, S, H, P, N, L, h0):
    """Without the bf16 roundings the split computes the plain version's
    function: the chunks' states passed in order equal the walk's carry."""
    x = _scan_inputs(B, S, H, P, N, 32, h0)
    y, h = scan_ref.mamba_scan_tiled(*x, chunk=L)
    wy, wh = scan_ref.mamba_scan_ref(*x, chunk=L)
    torch.testing.assert_close(y, wy, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, wh, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,h0", [(1, 2048, 2, True), (2, 8, 4, False), (1, 300, 3, False)],
                         ids=["prefill-h0", "boot", "ragged"])
def test_scan_bf16_roundings_hold_the_bf16_tolerance_at_full_width(B, S, H, h0):
    """jamba's width (P = 128, N = 16, L = 128), bf16 inputs: the split
    with the bf16 kernels' roundings (att, B o w, C o exp(lcum) and the
    entering state each rounded to bf16 once, y rounded to bf16) against
    the plain version in float32, within the card tests' bf16 tolerance,
    y and the state.  att's rounding, the plain version's own, takes most
    of it: a single rounding of the state's operands suffices."""
    xbar, loga, Bm, Cm, hs = _scan_inputs(B, S, H, 128, 16, 33, h0)
    xb, bb, cb = (t.to(torch.bfloat16) for t in (xbar, Bm, Cm))
    y, h = scan_ref.mamba_scan_tiled(xb, loga, bb, cb, hs, chunk=128, rounding="bf16")
    wy, wh = scan_ref.mamba_scan_ref(xb.float(), loga, bb.float(), cb.float(), hs, chunk=128)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), wy, **BF16_TOL)
    torch.testing.assert_close(h, wh, **BF16_TOL)
    assert _tol_ratio(y.float(), wy) < 0.9 and _tol_ratio(h, wh) < 0.3


def _mamba_shapes():
    """(P, N, L) of every registered config with Mamba layers, full and
    reduced (d_model 64 and the port's tests' 128), and the card tests'
    narrow heads."""
    shapes = {(32, 8, 16), (64, 16, 32)}
    for name in sorted(configs._REGISTRY):
        full = configs.get_config(name)
        if full.mamba is None:
            continue
        for cfg in (full, full.reduced(), dataclasses.replace(full.reduced(), d_model=128)):
            _, _, P, N = mamba_model.dims(cfg)
            shapes.add((P, N, cfg.mamba.chunk))
    return sorted(shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("P,N,L", _mamba_shapes(), ids=lambda v: str(v))
def test_scan_plan_fits_every_config(P, N, L, dtype):
    """At every Mamba config's head width, state and chunk, for prompts of
    one step, one chunk and several, with and without a start state: bf16
    runs on the tensor-core kernels, the path is the boot path exactly for
    bf16 with no state and one chunk, each kernel's shared memory fits the
    card's 232,448 bytes, and the grids cover the chunks, heads and
    columns."""
    assert {(128, 16, 128), (128, 8, 16)} <= set(_mamba_shapes())
    for S in (1, 8, L, 3 * L + 1, 2048):
        for h0 in (False, True):
            Lc = min(L, S)
            p = scan_ops.plan(2, S, 4, P, N, Lc, dtype, h0)
            boot = dtype == torch.bfloat16 and not h0 and S <= L
            assert (p["path"] == "boot") == boot
            assert (p["path"] == "scalar") == (dtype == torch.float32)
            for kn in p["kernels"]:
                assert kn["smem"] <= scan_ops.MAX_SMEM, (S, h0, kn)
                assert kn["threads"] <= 1024 and kn["threads"] % 128 == 0
            n_chunks = -(-S // Lc)
            for kn in p["kernels"]:
                if kn["name"].startswith("chunk_tc"):
                    # two blocks fit an SM; the units cover the chunks, heads and
                    # columns, and the blocks take equal shares of them
                    assert scan_ops.BLOCKS_PER_SM * (kn["smem"] + 1024) <= scan_ops.SM_SMEM
                    rows, chunks, groups = kn["units"]
                    assert (rows, chunks) == (8, n_chunks)
                    assert groups * kn["cols"] >= P > (groups - 1) * kn["cols"]
                    n_units, (blocks,) = rows * chunks * groups, kn["grid"]
                    assert blocks <= scan_ops.BLOCKS_PER_SM * scan_ops.SMS
                    assert blocks * -(-n_units // blocks) >= n_units > (blocks - 1) * -(
                        -n_units // blocks)
            if p["path"] == "chunked":
                assert p["scratch"] == 3 * 8 * n_chunks * N * P // 2 + 8 * n_chunks


def test_scan_plan_at_the_serving_shapes():
    """jamba's boot prefill (one launch: 64 heads x 2 column groups, a
    block of one warpgroup each) and its 2048-token prefill (64 heads x 16
    chunks of all of P, 256 blocks of two warpgroups walking 4 each, two
    stages of 53,248 bytes; the state pass between)."""
    bf16 = torch.bfloat16
    boot = scan_ops.plan(1, 8, 64, 128, 16, 8, bf16, False)
    assert [(k["name"], k["units"], k["grid"], k["threads"]) for k in boot["kernels"]] == [
        ("chunk_tc<1,kBoot>", (64, 1, 2), (128,), 128)]
    walk = scan_ops.plan(1, 2048, 64, 128, 16, 128, bf16, True)
    assert [(k["name"], k["grid"], k["threads"]) for k in walk["kernels"]] == [
        ("chunk_tc<2,kStates>", (256,), 256), ("pass_states", (64, 2), 256),
        ("chunk_tc<2,kOutputs>", (256,), 256)]
    assert walk["kernels"][0]["units"] == (64, 16, 1)
    assert walk["kernels"][0]["smem"] == 1024 + 2 * (2 * 128 * 128 + 128 * 128 + 2 * 16 * 128) \
        + 3 * 128 * 4 == 109_056
    assert scan_ops.plan(1, 2048, 64, 128, 16, 128, torch.float32, True)["path"] == "scalar"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("P,N,L", _mamba_shapes(), ids=lambda v: str(v))
def test_scan_bwd_plan_fits_every_config(P, N, L, dtype):
    """The scan's backward (csrc/mamba_scan_bwd.cu) at every Mamba config's
    head width, state and chunk, for one step, one chunk and several, in
    both bodies: the wrapper takes the shape, each launch's shared memory
    fits the card's 232,448 bytes (the bf16 chunk launch twice over, its
    two blocks an SM), the chunk launches' grid is (chunks, B H), the pass
    one block a (b, h) (bf16: one a 1024 floats of its state), the heads'
    sum covers B S N, and the scratch holds G_c and the entering states,
    da, and each head's dB and dC (bf16: dH_c in bf16 too)."""
    for S in (1, 8, L, 3 * L + 1, 2048):
        Lc = min(L, S)
        scan_ops.check_bwd(P, N, Lc, dtype)
        p = scan_ops.bwd_plan(2, S, 4, P, N, Lc, dtype)
        n_chunks, n_st = -(-S // Lc), 8 * -(-S // Lc) * N * P
        nwg = 2 if Lc > 64 else 1
        names = ["grad_in", "pass_grads", "chunk_grads", "sum_heads"] \
            if dtype == torch.float32 else \
            [f"grad_in_tc<{nwg}>", "pass_tc", f"chunk_grads_tc<{nwg}>", "sum_heads"]
        assert [k["name"] for k in p["kernels"]] == names
        for kn in p["kernels"]:
            assert kn["smem"] <= scan_ops.MAX_SMEM and kn["threads"] <= 256, (S, kn)
        grids = [kn["grid"] for kn in p["kernels"]]
        assert grids[3][0] * 256 >= 2 * S * N > (grids[3][0] - 1) * 256
        if dtype == torch.float32:
            assert grids[:3] == [(n_chunks, 8, 1), (8, 1, 1), (n_chunks, 8, 1)]
            assert p["scratch"] == 2 * n_st + 8 * n_chunks + 2 * 8 * S * N
        else:
            ny = -(-N * P // 1024)
            assert grids[:3] == [(n_chunks, 8, 1), (8, ny, 1), (n_chunks, 8, 1)]
            assert 2 * (p["kernels"][2]["smem"] + 1024) <= scan_ops.SM_SMEM
            assert p["scratch"] == 2 * n_st + n_st // 2 + -(-8 * n_chunks * ny // 4) * 4 \
                + 2 * 8 * S * N


def test_scan_bwd_plan_at_the_training_shape():
    """jamba's training shape (B=2 S=2048, 64 heads of 128, N=16, chunks of
    128): the scalar body's 2,048 chunk blocks of 123,520 bytes (one an SM)
    and 128 blocks of the pass, 67 MB of scratch; the bf16 body's 2,048
    chunk blocks of two warpgroups and 102,912 bytes (two an SM), G's
    blocks of 50,176 bytes, the pass on 128 x 2 blocks, 75.5 MB of scratch;
    a shape past the kernels' limits is refused, in bf16 also N = 4 or P =
    136, which the forward's tensor cores refuse too."""
    p = scan_ops.bwd_plan(2, 2048, 64, 128, 16, 128, torch.float32)
    assert [(k["name"], k["grid"], k["smem"]) for k in p["kernels"]] == [
        ("grad_in", (16, 128, 1), 26_624), ("pass_grads", (128, 1, 1), 32),
        ("chunk_grads", (16, 128, 1), 123_520), ("sum_heads", (256, 1, 1), 0)]
    assert 4 * p["scratch"] == 67_117_056
    p = scan_ops.bwd_plan(2, 2048, 64, 128, 16, 128, torch.bfloat16)
    assert [(k["name"], k["grid"], k["threads"], k["smem"]) for k in p["kernels"]] == [
        ("grad_in_tc<2>", (16, 128, 1), 128, 50_176), ("pass_tc", (128, 2, 1), 256, 32),
        ("chunk_grads_tc<2>", (16, 128, 1), 256, 102_912), ("sum_heads", (256, 1, 1), 256, 0)]
    assert 4 * p["scratch"] == 75_513_856
    for dtype in (torch.float32, torch.bfloat16):
        for P, N, L in ((128, 32, 128), (256, 16, 128), (128, 16, 256)):
            with pytest.raises(ValueError):
                scan_ops.check_bwd(P, N, L, dtype)
    for P, N in ((128, 4), (136, 8)):
        scan_ops.check_bwd(P, N, 128, torch.float32)
        with pytest.raises(ValueError):
            scan_ops.check_bwd(P, N, 128, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", _mlstm_head_dims())
def test_mlstm_bwd_plan_fits_every_config(dh, dtype):
    """The mLSTM's backward (csrc/mlstm_bwd.cu) at every mLSTM head width
    and chunk length L <= 64, one chunk or several, in both bodies: the
    wrapper takes the shape, each launch's shared memory fits the card's
    232,448 bytes, the per-chunk launches' grid is (chunks, B H), the
    sweeps' (B H, dh / 32), and the scratch holds the records, the entering
    C (float32, or bf16 tiles of 32 x 64) and n, and the shares."""
    for L in (1, 5, 8, 16, 32, 64):
        for S in (L, 3 * L + 1):
            mlstm_ops.check_bwd(dh, L, dtype)
            p = mlstm_ops.bwd_plan(2, S, 4, dh, L, dtype)
            nc, ncb = -(-S // L), dh // 32
            for kn in p["kernels"]:
                assert kn["smem"] <= mlstm_ops.MAX_SMEM and kn["threads"] <= 1024, (L, S, kn)
                assert kn["smem"] >= kn["dynamic"]
            names = ("prep", "states", "steps", "reverse_rows", "reverse_cols", "gate_grads") \
                if dtype == torch.float32 else \
                ("prep_tc", "states_tc", "steps", "rows_tc", "cols_tc", "gate_grads")
            assert [(k["name"], k["grid"]) for k in p["kernels"]] == list(zip(names, [
                (nc, 8, 1), (8, ncb, 1), (nc, 8, 1), (8, ncb, 1), (8, ncb, 1), (nc, 8, 1)]))
            cst = dh * dh if dtype == torch.float32 else ncb * -(-dh // 64) * 32 * 64 // 2
            rec = -(-(9 * L + 3 * L * L) // 4) * 4
            assert p["scratch"] == 8 * nc * (rec + cst + dh + 2 * ncb * L + ncb) + 2 * 8 * ncb


def test_mlstm_bwd_plan_at_the_training_shape():
    """xlstm-1.3b's training shape (B=2 S=1024, 4 heads of 1024, chunks of
    64): sweeps of 8 x 32 blocks; the scalar body's row sweep has the most
    shared memory, 186,400 bytes, and 546 MB of scratch, 512 MB of it the
    recomputed entering states; the bf16 body's sweeps have four
    warpgroups, the row sweep 227,648 bytes (its v, dh and C_{c-1} rings),
    and 278 MB of scratch, the entering states 256 MB of bf16 tiles; head
    widths the forward refuses are refused."""
    p = mlstm_ops.bwd_plan(2, 1024, 4, 1024, 64, torch.float32)
    smem = {k["name"]: k["smem"] for k in p["kernels"]}
    assert max(smem.values()) == smem["reverse_rows"] == 186_400
    assert 4 * p["scratch"] == 546_097_152
    assert 4 * 8 * 16 * 1024 * 1024 == 536_870_912
    p = mlstm_ops.bwd_plan(2, 1024, 4, 1024, 64, torch.bfloat16)
    assert [(k["name"], k["threads"], k["smem"]) for k in p["kernels"]] == [
        ("prep_tc", 128, 68_868), ("states_tc", 512, 217_088), ("steps", 256, 17_408),
        ("rows_tc", 512, 227_648), ("cols_tc", 512, 206_592), ("gate_grads", 64, 1_288)]
    assert 4 * p["scratch"] == 277_661_696
    assert 4 * 8 * 16 * mlstm_ops.cst_floats(1024, torch.bfloat16) == 268_435_456
    for dtype in (torch.float32, torch.bfloat16):
        for dh, L in ((48, 64), (2048, 64), (1024, 128)):
            with pytest.raises(ValueError):
                mlstm_ops.check_bwd(dh, L, dtype)


# -------------------------------------------------- chunk hash: the lane split
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_chunk_hash_lane_split_matches_hrtree(group):
    """The kernel's partition (a group of lanes, each a segment of whole
    16-byte pieces from the start's 16-byte boundary folded into its
    (p, M^n) pair, the pairs combined in lane order by the shuffle tree)
    equals ``hrtree.chunk_hash`` at every length 0..300, starts at each
    4-byte slot of a 16-byte line, views that start mid-line, every
    ``bits`` 1..32, and token ids that wrap in uint32."""
    rng = np.random.default_rng(group)
    toks = rng.integers(-2**31, 2**31, 320).tolist()
    toks[5] = 2**31 - 1
    for length in range(301):
        for start in (4, 5, 6, 7):
            misalign = (length + start) % 4
            bits = 1 + (length + start) % 32
            assert hash_ref.chunk_hash_lanes(toks, start, length, group, bits, misalign) \
                == hrtree.chunk_hash(toks[start:start + length], bits), (length, start)


def test_chunk_hash_group_sizes():
    """The fixed entry's lanes a chunk: one 16-byte load a lane covers the
    width in a round, at most a warp (width 64: 16 lanes, two chunks a
    warp); the ranged entry takes a warp."""
    assert [hash_ops.group_size(w) for w in (1, 4, 5, 8, 9, 64, 65, 100, 128, 1100)] == \
        [1, 1, 2, 2, 4, 16, 32, 32, 32, 32]
    assert hash_ops.RANGED_GROUP == 32

"""What surrounds the port's two attention kernels, on the CPU: the paged
decode's split plan (the Python twin of the span arithmetic in
``paged_decode.cu``), the algebra of its in-launch combine against the
unsplit plain version, and the flash kernel's launch plan (rows and shared
memory) for every head layout a registered config has, in both
registries.  A launch refused for too much shared memory never runs, so
these catch it before the card."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import base  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.paged_decode import ref as decode_ref  # noqa: E402

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
    csrc/paged_decode.cu ``smem_bytes`` sums it: a ring of kStages (4 in
    bf16, 3 in float32) K and V pages, then float32 q, scores, the
    kThreads (256) key groups' sums and the combine's weights."""
    stages = {2: 4, 4: 3}[esize]
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


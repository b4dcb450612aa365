"""The bf16 flash backward's tiling on the CPU: ``ref.attention_bwd_tiled``
walks the 64-key x 64-query tiles that ``dkdv_tc_kernel`` and
``dq_tc_kernel`` (``csrc/flash_attention_bwd.cu``) walk, with their tile
bounds under the causal mask and the window, and with ``rounding="bf16"``
rounds P and dS where the kernels round them.  Without rounding it equals
the plain version and the reference's gradient (``jax.vjp`` of
``repro/kernels/flash_attention/ref.py``); with it, it stays inside the
card's gate."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402

# the card's bf16 gate: each gradient's largest error within 2e-2 of its
# largest entry (chip_smoke.py FLASH_BWD_TOL, tests/test_torch_cuda.py)
BF16_GATE = 2e-2


def _inputs(B, H, Hkv, Sq, Skv, D, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, D), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32))
            for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


def _rel_err(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


# (B, H, Hkv, Sq, Skv, D, causal, window, softcap)
TILED_CASES = {
    "causal": (2, 8, 2, 200, 200, 64, True, None, None),
    "window-danube": (1, 8, 2, 600, 600, 80, True, 256, None),
    "softcap-gemma2": (1, 4, 2, 160, 160, 256, True, None, 50.0),
    "granite-G48": (1, 48, 1, 200, 200, 128, True, None, None),
    "cross-256x1600": (1, 8, 2, 256, 1600, 128, False, None, None),
    "ragged-33": (2, 4, 2, 33, 33, 16, True, None, None),
    "ragged-300": (1, 8, 8, 300, 300, 64, False, None, None),
}


@pytest.mark.parametrize("case", TILED_CASES.values(), ids=TILED_CASES.keys())
def test_tiled_backward_equals_the_plain_version(case):
    """``rounding=None``: the tiled walk gives ``attention_bwd_ref``'s dQ,
    dK and dV within 1e-5 of each gradient's largest entry, in float32,
    over the causal mask, danube's 256-key window at D=80, gemma2's softcap
    at D=256, granite's 48 query heads on one KV head, a non-causal
    256 x 1600 cross-attention and ragged lengths."""
    B, H, Hkv, Sq, Skv, D, causal, window, softcap = case
    q, k, v, do = _inputs(B, H, Hkv, Sq, Skv, D, seed=Sq + D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o = flash_ref.attention_ref(q, k, v, **kw)
    lse = flash_ref.lse_ref(q, k, **kw)
    got = flash_ref.attention_bwd_tiled(q, k, v, o, do, lse, **kw)
    want = flash_ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.shape == t.shape and a.dtype == torch.float32
        assert _rel_err(a, b) <= 1e-5


def test_tiled_backward_equals_the_reference_vjp():
    """The tiled walk against ``jax.vjp`` of the reference's jnp attention
    (what the reference trains through) on the same numpy inputs: GQA, a
    window that starts inside a tile, a softcap, a ragged length; each
    gradient within 1e-5 of its largest entry."""
    B, H, Hkv, S, D = 1, 4, 2, 130, 32
    kw = dict(causal=True, window=50, softcap=20.0)
    q, k, v, do = _inputs(B, H, Hkv, S, S, D, seed=7)
    out, vjp = jax.vjp(lambda a, b, c: j_ref.attention_ref(a, b, c, **kw),
                       *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    o = torch.tensor(np.asarray(out))
    got = flash_ref.attention_bwd_tiled(q, k, v, o, do, flash_ref.lse_ref(q, k, **kw), **kw)
    for a, b in zip(got, want):
        assert _rel_err(a, torch.tensor(np.asarray(b))) <= 1e-5


def test_tiled_backward_in_bf16_stays_inside_the_card_gate():
    """``rounding="bf16"`` on bf16 inputs at llama's D=128, G=4, S=512
    causal, the gradients rounded to bf16 as the kernels store them: each
    within the card's 2e-2 of its largest entry against the float32 plain
    version, and well inside it (under 0.3 of it).  The roundings do move the
    result: far more than float32's sums in another order."""
    q, k, v, do = _inputs(1, 8, 2, 512, 512, 128, seed=11, dtype=torch.bfloat16)
    o = flash_ref.attention_ref(q, k, v, causal=True)          # bf16, as the forward's
    lse = flash_ref.lse_ref(q, k, causal=True)
    want = flash_ref.attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    got = flash_ref.attention_bwd_tiled(q, k, v, o, do, lse, causal=True, rounding="bf16")
    exact = flash_ref.attention_bwd_tiled(q, k, v, o, do, lse, causal=True)
    for name, a, e, b in zip(("dq", "dk", "dv"), got, exact, want):
        ratio = _rel_err(a.to(torch.bfloat16), b) / BF16_GATE
        assert ratio <= 0.3, (name, ratio)
        assert _rel_err(a, b) > 10 * _rel_err(e, b), name


@settings(max_examples=200, deadline=None)
@given(Sq=st.integers(1, 300), Skv=st.integers(1, 300), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 200)))
def test_query_tiles_are_exactly_those_that_see_the_key_tile(Sq, Skv, causal, window):
    """``bwd_query_tiles`` (the dK/dV walk's bounds): each 64-key tile
    walks every query tile holding a query that sees one of its keys, and
    no other (so the walk neither misses a pair nor wastes a step)."""
    T = flash_ref.BWD_TILE
    qp, kp = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    seen = np.ones((Sq, Skv), bool)
    if causal:
        seen &= kp <= qp
    if window is not None:
        seen &= qp - kp < window
    for k_lo in range(0, Skv, T):
        k_n = min(T, Skv - k_lo)
        want = sorted({q // T for q in np.nonzero(seen[:, k_lo:k_lo + k_n].any(1))[0]})
        assert list(flash_ref.bwd_query_tiles(k_lo, k_n, Sq, causal, window)) == want

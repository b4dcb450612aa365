"""The SSD scan's backward on the CPU (row 4b): autograd of the port's plain
version (``kernels/mamba_scan/ref.py`` ``mamba_scan_ref``) against
``jax.vjp`` of the JAX package's sequential oracle
(``repro/kernels/mamba_scan/ref.py``); the backward kernels' split
(``mamba_scan_bwd_tiled``: G_c, the reverse state pass from the forward's
chunk states, the chunk gradients, the heads' sum) against autograd of the
plain version in float64 and float32, through a ragged tail, with and
without h0 and the final state's gradient, and across a chunk whose summed
log decay is below -200; the bf16 kernels' roundings in the split at
jamba's width against the gate; and ``ops.MambaScan``'s plumbing with its
launches swapped for the plain versions."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_scan_seq  # noqa: E402
from repro_torch.kernels.mamba_scan import ops, ref  # noqa: E402

NAMES = ("dx", "dloga", "dB", "dC", "dh0")


def _inputs(seed, B, S, H, P, N, *, deep=False, dtype=np.float64):
    """x, loga (<= 0), B, C, h0, dy and dh from a numpy seed; ``deep`` puts a
    summed loga of -225 on the first 9 steps (one chunk at L <= 9)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)) * 0.5
    loga = -np.logaddexp(0.0, rng.normal(size=(B, S, H)))
    if deep:
        loga[:, :9] = -25.0
    Bm, Cm = (rng.normal(size=(B, S, N)) * 0.5 for _ in range(2))
    h0 = rng.normal(size=(B, H, N, P)) * 0.1
    dy = rng.normal(size=(B, S, H, P))
    dh = rng.normal(size=(B, H, N, P))
    return [torch.from_numpy(a.astype(dtype)) for a in (x, loga, Bm, Cm, h0, dy, dh)]


def _autograd(x, loga, Bm, Cm, h0, dy, dh, chunk):
    """Gradients of <y, dy> + <h, dh> through the plain version (dh or h0
    None: left out)."""
    leaves = [t.clone().requires_grad_(True) for t in (x, loga, Bm, Cm)]
    h0l = None if h0 is None else h0.clone().requires_grad_(True)
    y, h = ref.mamba_scan_ref(*leaves, h0l, chunk=chunk)
    loss = (y * dy).sum() + (0.0 if dh is None else (h * dh).sum())
    return torch.autograd.grad(loss, leaves + ([] if h0l is None else [h0l]))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


# ------------------------------------------------- (i) against jax.vjp
@pytest.mark.parametrize("B,S,H,P,N,L,with_h0", [
    (2, 32, 3, 16, 8, 8, True), (1, 48, 2, 32, 16, 16, False), (2, 24, 1, 8, 4, 24, True)])
def test_plain_gradients_match_jax_of_the_sequential_oracle(B, S, H, P, N, L, with_h0):
    """float32: every gradient of the plain version (chunked, L steps a
    chunk) within 2e-5 of its largest entry of ``jax.vjp`` of the JAX
    package's per-step oracle on the same inputs and cotangents (the two
    sum in different orders)."""
    x, loga, Bm, Cm, h0, dy, dh = _inputs(S + P, B, S, H, P, N, dtype=np.float32)
    h0 = h0 if with_h0 else None
    got = _autograd(x, loga, Bm, Cm, h0, dy, dh, L)
    C = S // L

    def seq(xj, laj, bj, cj, *h0j):
        # the oracle's layouts: (B, H, C, L, P), (B, H, C, L), (B, C, L, N)
        y, h = j_scan_seq(jnp.moveaxis(xj, 2, 1).reshape(B, H, C, L, P),
                          jnp.moveaxis(laj, 2, 1).reshape(B, H, C, L),
                          bj.reshape(B, C, L, N), cj.reshape(B, C, L, N), *h0j)
        return jnp.moveaxis(y.reshape(B, H, S, P), 1, 2), h
    args = [jnp.asarray(t.numpy()) for t in (x, loga, Bm, Cm)] \
        + ([jnp.asarray(h0.numpy())] if with_h0 else [])
    _, vjp = jax.vjp(seq, *args)
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dh.numpy())))
    for name, a, b in zip(NAMES, got, want):
        assert _rel(a, torch.from_numpy(np.array(b))) < 2e-5, name


# ------------------------------------- (ii) the split against autograd
CASES = {  # B, S, H, P, N, L, h0, dh, deep
    "ragged": (2, 13, 3, 8, 4, 4, False, False, False),
    "ragged_h0": (2, 13, 3, 8, 4, 4, True, False, False),
    "ragged_dh": (2, 13, 3, 8, 4, 4, False, True, False),
    "ragged_h0_dh": (2, 13, 3, 8, 4, 4, True, True, False),
    "one_chunk": (1, 6, 2, 16, 8, 16, False, False, False),
    "deep": (2, 37, 2, 16, 8, 16, True, True, True),
    "jamba_head": (1, 40, 1, 128, 16, 16, True, True, False),
}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_backward_is_autograd_of_the_plain_version(case, dtype, tol):
    """``mamba_scan_bwd_tiled`` (the kernels' split) against autograd of
    ``mamba_scan_ref``: each gradient within ``tol`` of its largest entry
    (float64 1e-10: the same function, summed in another order; float32
    1e-5), every entry finite, also where a chunk's summed loga is -225
    (its decays exp(lcum_s - lcum_t) above the diagonal would overflow)."""
    B, S, H, P, N, L, with_h0, with_dh, deep = CASES[case]
    x, loga, Bm, Cm, h0, dy, dh = _inputs(7, B, S, H, P, N, deep=deep, dtype=dtype)
    h0, dh = (h0 if with_h0 else None), (dh if with_dh else None)
    if deep:
        assert loga[:, :L].sum(1).max() < -200
    want = _autograd(x, loga, Bm, Cm, h0, dy, dh, L)
    got = ref.mamba_scan_bwd_tiled(x, loga, Bm, Cm, h0, dy, dh, chunk=L)
    assert (got[4] is None) == (h0 is None)
    for name, a, b in zip(NAMES, got, want):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        assert a.dtype == b.dtype, name
        assert _rel(a, b) < tol, (name, _rel(a, b))


def test_the_reference_form_turns_nan_where_the_split_does_not():
    """The trap row 4b names: exponentiating the decays before masking
    them (the JAX package's ssd_scan: exp, then where) gives a NaN
    gradient once a chunk's summed log decay passes -88; the plain
    version and the split mask first."""
    x, loga, Bm, Cm, _, dy, _ = _inputs(3, 1, 16, 1, 4, 2, deep=True, dtype=np.float32)
    la = loga.clone().requires_grad_(True)
    lcum = torch.cumsum(la, 1)
    dec = lcum[:, :, None, :] - lcum[:, None, :, :]
    mask = torch.tril(torch.ones((16, 16), dtype=torch.bool))[None, :, :, None]
    torch.where(mask, torch.exp(dec), 0.0).sum().backward()
    assert torch.isnan(la.grad).any()
    got = ref.mamba_scan_bwd_tiled(x, loga, Bm, Cm, None, dy, None, chunk=16)
    assert all(torch.isfinite(t).all() for t in got[:4])


def test_tiled_backward_in_bf16_holds_the_kernel_gate():
    """bf16 inputs: the split's gradients (f32 sums, bf16 dx, dB, dC)
    within 2e-2 of each largest entry of autograd of the float32 plain
    version on the same bf16 values (the card's gate)."""
    x, loga, Bm, Cm, h0, dy, dh = _inputs(9, 2, 40, 2, 32, 16, dtype=np.float32)
    xb, bb, cb, dyb = (t.to(torch.bfloat16) for t in (x, Bm, Cm, dy))
    want = _autograd(xb.float(), loga, bb.float(), cb.float(), h0, dyb.float(), dh, 16)
    got = ref.mamba_scan_bwd_tiled(xb, loga, bb, cb, h0, dyb, dh, chunk=16)
    assert got[0].dtype == got[2].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, a, b in zip(NAMES, got, want):
        assert _rel(a.float(), b) < 2e-2, name


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_bf16_roundings_hold_the_gate_at_full_width(with_h0):
    """jamba's head at full size (P = 128, N = 16, L = 128), three chunks
    and a ragged tail (S = 424), B = H = 1, bf16 inputs: the split with the
    bf16 kernels' roundings (``rounding="bf16"``: C o e, att, B o w, dH_c,
    h_{c-1} and datt o decay rounded once) holds every gradient within 2e-2
    of its largest entry of autograd of the float32 plain version (within a
    third of it), and the roundings move the gradients."""
    x, loga, Bm, Cm, h0, dy, dh = _inputs(4, 1, 3 * 128 + 40, 1, 128, 16, dtype=np.float32)
    xb, bb, cb, dyb = (t.to(torch.bfloat16) for t in (x, Bm, Cm, dy))
    h0, dh = (h0, dh) if with_h0 else (None, None)
    want = _autograd(xb.float(), loga, bb.float(), cb.float(), h0, dyb.float(), dh, 128)
    got = ref.mamba_scan_bwd_tiled(xb, loga, bb, cb, h0, dyb, dh, chunk=128, rounding="bf16")
    exact = ref.mamba_scan_bwd_tiled(xb, loga, bb, cb, h0, dyb, dh, chunk=128)
    for name, a, b, e in zip(NAMES, got, want, exact):
        assert _rel(a.float(), b) < 2e-2 / 3, name
        assert not torch.equal(a, e), name


# ------------------------------------------- (iii) MambaScan's plumbing
@pytest.fixture
def swapped(monkeypatch):
    """``ops._forward`` and ``ops.mamba_scan_bwd`` replaced by the plain
    version and the split, recording what the backward was handed."""
    seen = {}

    def forward(xbar, loga, Bm, Cm, h0, chunk, save):
        seen["save"] = save
        y, h = ref.mamba_scan_ref(xbar, loga, Bm, Cm, h0, chunk=chunk)
        seen["scratch"] = torch.zeros(3)
        return y, h, seen["scratch"]

    def backward(xbar, loga, Bm, Cm, h0, scratch, dy, dh, *, chunk, want_dh0=True):
        seen.update(scratch_in=scratch, dh=dh, want_dh0=want_dh0, chunk=chunk)
        dx, dla, dB, dC, dh0 = ref.mamba_scan_bwd_tiled(xbar, loga, Bm, Cm, h0, dy, dh,
                                                         chunk=chunk)
        return dx, dla, dB, dC, dh0 if want_dh0 else None
    monkeypatch.setattr(ops, "_forward", forward)
    monkeypatch.setattr(ops, "mamba_scan_bwd", backward)
    return seen


@pytest.mark.parametrize("with_h0,use_h", [(False, False), (True, True), (True, False)])
def test_mamba_scan_function_routes_gradients(swapped, with_h0, use_h):
    """``MambaScan``: the forward asks for the scratch and saves it, the
    backward gets it back with the chunk, dh is None where the final state
    is unused, h0 gets a gradient exactly where it requires one, and the
    gradients equal autograd of the plain version."""
    x, loga, Bm, Cm, h0, dy, dh = _inputs(5, 2, 11, 2, 8, 4)
    leaves = [t.clone().requires_grad_(True) for t in (x, loga, Bm, Cm)]
    h0l = h0.clone().requires_grad_(True) if with_h0 else None
    y, h = ops.MambaScan.apply(*leaves, h0l, 4)
    assert swapped["save"] is True
    assert y.grad_fn.saved_tensors[-1] is swapped["scratch"]
    loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0.0)
    got = torch.autograd.grad(loss, leaves + ([h0l] if with_h0 else []))
    assert swapped["scratch_in"] is swapped["scratch"] and swapped["chunk"] == 4
    assert (swapped["dh"] is None) == (not use_h)
    assert swapped["want_dh0"] == with_h0
    want = _autograd(x, loga, Bm, Cm, h0 if with_h0 else None, dy, dh if use_h else None, 4)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-10


def test_mamba_scan_function_leaves_h0_without_grad_alone(swapped):
    """An h0 that requires no gradient gets None, and the backward is not
    asked for one."""
    x, loga, Bm, Cm, h0, dy, _ = _inputs(6, 1, 9, 2, 8, 4)
    xl = x.clone().requires_grad_(True)
    y, _ = ops.MambaScan.apply(xl, loga, Bm, Cm, h0, 4)
    (y * dy).sum().backward()
    assert xl.grad is not None and swapped["want_dh0"] is False


def test_cpu_tensors_differentiate_the_plain_version():
    """On the CPU, ``mamba_scan`` is the plain version under autograd: no
    launch, no backward launch, gradients as autograd's."""
    x, loga, Bm, Cm, h0, dy, dh = _inputs(8, 1, 10, 2, 8, 4)
    f0, b0 = ops.mamba_scan.launches, ops.mamba_scan_bwd.launches
    xl = x.clone().requires_grad_(True)
    y, _ = ops.mamba_scan(xl, loga, Bm, Cm, h0, chunk=4)
    assert y.grad_fn is not None and not isinstance(y.grad_fn, ops.MambaScan._backward_cls)
    (y * dy).sum().backward()
    assert (ops.mamba_scan.launches, ops.mamba_scan_bwd.launches) == (f0, b0)
    assert _rel(xl.grad, _autograd(x, loga, Bm, Cm, h0, dy, None, 4)[0]) < 1e-12

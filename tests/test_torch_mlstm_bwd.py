"""The chunkwise mLSTM's backward on the CPU (row 5b): autograd of the
port's plain version (``kernels/mlstm/ref.py`` ``mlstm_ref``) against
``jax.vjp`` of the JAX package's chunkwise model path
(``repro/models/xlstm.py`` ``mlstm_forward``, the mixer) and of its
per-step oracle (``repro/kernels/mlstm/ref.py``, which takes |den| as the
chunkwise forms do); the backward kernels' split (``mlstm_bwd_tiled``: m,
m_new and inter held constant, the states sweep, the step scalars, the
reverse sweeps by rows and by columns, the gate gradients and the m terms)
against autograd of the plain version in float64 and float32, through a
ragged tail, with and without a start state and a final-state gradient,
on both branches of the denominator; the bf16 kernels' roundings in the
split at full width (dh = 1024) and at the training length against the
gate, and the two pairs they need; and ``ops.MLSTM``'s plumbing with its
launches swapped for the plain versions."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.mlstm.ref import mlstm_ref as j_mlstm_seq  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.mlstm import ops, ref  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

NAMES = ("dq", "dk", "dv", "dlog_i", "dlog_f", "dC0", "dn0", "dm0")


def _inputs(seed, B, S, H, D, *, small_q=False, dtype=np.float64):
    """q, k, v, log i, log f, a start state (C, n, m), dh and the final
    state's gradient from a numpy seed, in ``check_mlstm``'s distributions;
    ``small_q`` scales q by 1e-3 (exp(-m_new) then wins the denominator on
    many steps)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)) / D ** 0.5 * (1e-3 if small_q else 1.0)
    k, v = (rng.normal(size=(B, S, H, D)) for _ in range(2))
    gi = rng.normal(size=(B, S, H)) * 2
    gf = -np.logaddexp(0.0, -(rng.normal(size=(B, S, H)) + 4))
    state = (rng.normal(size=(B, H, D, D)) * 0.1, rng.normal(size=(B, H, D)) * 0.1,
             rng.normal(size=(B, H)))
    dh = rng.normal(size=(B, S, H, D))
    dstate = (rng.normal(size=(B, H, D, D)), rng.normal(size=(B, H, D)), rng.normal(size=(B, H)))
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=dtype))  # noqa: E731
    return ([t(a) for a in (q, k, v, gi, gf)], tuple(t(a) for a in state), t(dh),
            tuple(t(a) for a in dstate))


def _autograd(x, state, dh, dstate, chunk, scale=1.0):
    """Gradients of <h, dh> + <(C, n, m), dstate> through the plain version
    (state or dstate None: left out)."""
    leaves = [a.clone().requires_grad_(True) for a in x]
    sl = None if state is None else [a.clone().requires_grad_(True) for a in state]
    h, fin = ref.mlstm_ref(*leaves, None if sl is None else tuple(sl), chunk=chunk, scale=scale)
    loss = (h * dh).sum()
    if dstate is not None:
        loss = loss + sum((a * b).sum() for a, b in zip(fin, dstate))
    return torch.autograd.grad(loss, leaves + (sl or []))


def _flat(got):
    return [*got[:5], *(got[5] or ())]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _den_floor_share(x, state, chunk):
    """Of the steps, the share where exp(-m_new) wins the denominator."""
    q, k, v, gi, gf = x
    B, S, H, D = q.shape
    (b, m_new, inter, _), _ = ref.chunk_gates(gi, gf, None if state is None else state[2], chunk)
    wins = []
    C, n, _ = state if state is not None else ref.empty_state(B, H, D, "cpu", q.dtype)
    for t0 in range(0, S, chunk):
        sl = slice(t0, min(t0 + chunk, S))
        Lc = sl.stop - sl.start
        mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool))[None, :, :, None]
        gb, mn = b[:, sl], m_new[:, sl]
        gate = torch.where(mask, torch.exp(gb[:, :, None] - gb[:, None, :] + gi[:, None, sl]
                                           - mn[:, :, None]), 0.0)
        att = gate * torch.einsum("bshe,bthe->bsth", q[:, sl], k[:, sl])
        den = att.sum(2) + inter[:, sl] * torch.einsum("bshe,bhe->bsh", q[:, sl], n)
        wins.append(den.abs() < torch.exp(-mn))
        w = torch.exp(gb[:, -1:] - gb + gi[:, sl] - mn[:, -1:])
        C = inter[:, sl][:, -1][..., None, None] * C + torch.einsum(
            "bth,bthe,bthf->bhef", w, k[:, sl], v[:, sl])
        n = inter[:, sl][:, -1][..., None] * n + torch.einsum("bth,bthe->bhe", w, k[:, sl])
    return torch.cat(wins, 1).double().mean().item()


# ------------------------------------------------- (i) against jax.vjp
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_gradients_match_jax_of_the_per_step_oracle(with_state):
    """float32: every gradient of the plain version (chunks of 8, ragged:
    S = 20 padded to the oracle's 3 x 8 with log i = -60, log f = 0 and
    zero q, k, v, as the reference model pads) within 1e-4 of its largest
    entry of ``jax.vjp`` of the JAX per-step oracle, with h's and the final
    state's cotangents.  The oracle takes |den| (as the chunkwise forms),
    so no input needs den > 0."""
    B, H, D, L, S = 2, 2, 16, 8, 20
    x, state, dh, dstate = _inputs(21, B, S, H, D, dtype=np.float32)
    state = state if with_state else None
    got = _autograd(x, state, dh, dstate, L, scale=0.5)
    pad = 3 * L - S

    def padded(a, value=0.0):
        return jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2), constant_values=value)

    def seq(q, k, v, gi, gf, *st):
        q, k, v = (jnp.moveaxis(padded(a), 2, 1).reshape(B, H, 3, L, D) for a in (q, k, v))
        gi = jnp.moveaxis(padded(gi, -60.0), 2, 1).reshape(B, H, 3, L)
        gf = jnp.moveaxis(padded(gf), 2, 1).reshape(B, H, 3, L)
        h, fin = j_mlstm_seq(q, k, v, gi, gf, tuple(st) if st else None, scale=0.5)
        return jnp.moveaxis(h.reshape(B, H, 3 * L, D)[:, :, :S], 1, 2), fin
    args = [jnp.asarray(a.numpy()) for a in (*x, *(state or ()))]
    _, vjp = jax.vjp(seq, *args)
    want = vjp((jnp.asarray(dh.numpy()), tuple(jnp.asarray(a.numpy()) for a in dstate)))
    for name, a, b in zip(NAMES, got, want):
        assert _rel(a, torch.from_numpy(np.array(b))) < 1e-4, name


def test_mixer_gradients_match_jax_of_the_chunkwise_model():
    """The chunkwise model path: ``jax.vjp`` of the reference's
    ``mlstm_forward`` (reduced xlstm, S = 40 in chunks of 16: two whole and
    a ragged one) against autograd of the port's, which runs the plain
    version on the CPU: the input's and every weight's gradient within 2e-4
    of its largest entry."""
    NAME = "xlstm-1.3b"
    jcfg, tcfg = base.get_config(NAME).reduced(), configs.get_config(NAME).reduced()
    jp = jxlstm.init_mlstm(jcfg, jax.random.PRNGKey(5))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 40, jcfg.d_model)).astype(np.float32)
    dout = rng.normal(size=(2, 40, jcfg.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: jxlstm.mlstm_forward(jcfg, p, xx, chunk=16), jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dout))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = xlstm.mlstm_forward(tcfg, leaves, xt, chunk=16)
    (out * torch.from_numpy(dout)).sum().backward()
    assert _rel(xt.grad, torch.from_numpy(np.array(jgx))) < 2e-4
    for k, v in leaves.items():
        assert _rel(v.grad, torch.from_numpy(np.array(jgp[k]))) < 2e-4, k


# ------------------------------------- (ii) the split against autograd
CASES = {  # B, S, H, D, L, state, dstate, small q
    "ragged": (2, 13, 2, 8, 4, False, False, False),
    "ragged_state": (2, 13, 2, 8, 4, True, False, False),
    "ragged_dstate": (2, 13, 2, 8, 4, False, True, False),
    "ragged_state_dstate": (2, 13, 2, 8, 4, True, True, False),
    "one_chunk": (1, 7, 2, 16, 16, False, False, False),
    "floor": (2, 21, 2, 8, 8, True, True, True),
    "wide": (1, 40, 1, 64, 16, True, True, False),
}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_backward_is_autograd_of_the_plain_version(case, dtype, tol):
    """``mlstm_bwd_tiled`` (the kernels' split, m held constant) against
    autograd of ``mlstm_ref`` (which differentiates m through cummax and
    maximum): each gradient within ``tol`` of its largest entry.  float64
    at 1e-10 shows that the terms the split drops cancel up to rounding;
    in float32 their rounding stays under 1e-5 of the largest entry."""
    B, S, H, D, L, with_state, with_dstate, small_q = CASES[case]
    x, state, dh, dstate = _inputs(3, B, S, H, D, small_q=small_q, dtype=dtype)
    state = state if with_state else None
    dstate = dstate if with_dstate else None
    want = _autograd(x, state, dh, dstate, L, scale=0.7)
    got = ref.mlstm_bwd_tiled(*x, state, dh, dstate, chunk=L, scale=0.7)
    assert (got[5] is None) == (state is None)
    for name, a, b in zip(NAMES, _flat(got), want):
        assert torch.isfinite(a).all(), name
        assert a.dtype == b.dtype, name
        assert _rel(a, b) < tol, (name, _rel(a, b))


@pytest.mark.parametrize("small_q,lo,hi", [(False, 0.0, 0.3), (True, 0.7, 1.0)])
def test_both_branches_of_the_denominator_are_taken(small_q, lo, hi):
    """The ``floor`` case takes max(|den|, exp(-m_new)) at exp(-m_new) on
    most steps (there den gets no gradient), the others at |den| (sign(den)
    into den) on most: the cases above cover both branches."""
    x, state, _, _ = _inputs(3, 2, 21, 2, 8, small_q=small_q)
    assert lo <= _den_floor_share(x, state, 8) <= hi


def test_tiled_backward_in_bf16_holds_the_kernel_gate():
    """bf16 q, k, v and dh: the split's gradients (f32 sums, bf16 dq, dk,
    dv) within 2e-2 of each largest entry of autograd of the float32 plain
    version on the same bf16 values (the card's gate)."""
    x, state, dh, dstate = _inputs(9, 2, 40, 2, 64, dtype=np.float32)
    xb = [a.to(torch.bfloat16) for a in x[:3]]
    dhb = dh.to(torch.bfloat16)
    want = _autograd([*(a.float() for a in xb), *x[3:]], state, dhb.float(), dstate, 16)
    got = ref.mlstm_bwd_tiled(*xb, *x[3:], state, dhb, dstate, chunk=16)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    for name, a, b in zip(NAMES, _flat(got), want):
        assert _rel(a.float(), b) < 2e-2, name


# ------------------------------ (iv) the bf16 kernels' roundings
def _full_width(state):
    """xlstm's head width at full size (dh = 1024, L = 64), three chunks
    and a ragged tail (S = 200), B = H = 1: q, k, v and dh rounded to bf16
    (as float32 values), with a start state and the final state's gradient
    or neither, and the gradients of autograd of the float32 plain version."""
    x, st, dh, dst = _inputs(9, 1, 200, 1, 1024, dtype=np.float32)
    x = [a.to(torch.bfloat16).float() for a in x[:3]] + x[3:]
    dh = dh.to(torch.bfloat16).float()
    st, dst = (st, dst) if state else (None, None)
    return (x, st, dh, dst), _autograd(x, st, dh, dst, 64)


def _training_length(seed):
    """xlstm's head at its training length: dh = 1024, S = 1024 (16 chunks
    of 64), B = H = 1, no state, ``check_mlstm_bwd``'s distributions from
    numpy seed ``seed``, q, k, v and dh rounded to bf16 (as float32
    values); and the gradients of autograd of the float32 plain version."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    q = t(rng.normal(size=(1, 1024, 1, 1024)) / 32).to(torch.bfloat16).float()
    k, v = (t(rng.normal(size=(1, 1024, 1, 1024))).to(torch.bfloat16).float() for _ in range(2))
    gi = t(rng.normal(size=(1, 1024, 1)) * 2)
    gf = t(-np.logaddexp(0.0, -(rng.normal(size=(1, 1024, 1)) + 4)))
    dh = t(rng.normal(size=(1, 1024, 1, 1024))).to(torch.bfloat16).float()
    x = [q, k, v, gi, gf]
    return (x, None, dh, None), _autograd(x, None, dh, None, 64)


def _shares(args, want, rounding):
    """Each gradient's largest error against ``want`` over its largest entry,
    over the 2e-2 gate, with the split's ``rounding``."""
    x, st, dh, dst = args
    got = _flat(ref.mlstm_bwd_tiled(*x, st, dh, dst, chunk=64, rounding=rounding))
    return {n: _rel(a, b) / 2e-2 for n, a, b in zip(NAMES, got, want)}


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "state"])
def test_bf16_roundings_hold_the_gate_at_full_width(state):
    """The split with the bf16 kernels' roundings (``BWD_ROUNDING``: C and
    the column sweep's dC as hi + lo pairs, every other float32 operand of
    a tensor-core product rounded once to bf16) holds every gradient, the
    start state's too, within a third of the 2e-2 gate of autograd of the
    float32 plain version at full width, and the roundings are there: the
    gradients move."""
    args, want = _full_width(state)
    shares = _shares(args, want, ref.BWD_ROUNDING)
    assert max(shares.values()) < 1 / 3, shares
    exact = _shares(args, want, None)
    assert all(shares[n] > exact[n] for n in ("dq", "dk", "dv")), (shares, exact)


@pytest.mark.parametrize("seed", [105, 128])
def test_bf16_roundings_hold_the_gate_at_the_training_length(seed):
    """At the training length (16 chunks), where one rounding of a paired
    operand misses the gate (the seeds of the next test), the kernels'
    roundings keep every gradient within a third of it (a quarter over 40
    seeds, 100..139, when the pairs were chosen)."""
    args, want = _training_length(seed)
    shares = _shares(args, want, ref.BWD_ROUNDING)
    assert max(shares.values()) < 1 / 3, shares


@pytest.mark.parametrize("operand,seed", [("C", 128), ("dC_cols", 105)])
def test_one_rounding_of_each_paired_operand_misses_the_gate(operand, seed):
    """Why the two pairs: with every other operand as the kernels have it,
    one bf16 rounding of C (for Q C: X feeds dden = -(dh . num) / M^2) or of
    the column sweep's dC (for k dC) puts a gradient past the 2e-2 gate at
    the training length, more than three times the kernels' roundings' worst
    share there, as one rounding of the forward's att, k o w or C puts h
    past its gate (tests/test_torch_kernel_plans.py)."""
    assert {op for op, r in ref.BWD_ROUNDING.items() if r == "pair"} == {"C", "dC_cols"}
    args, want = _training_length(seed)
    once = max(_shares(args, want, {**ref.BWD_ROUNDING, operand: "bf16"}).values())
    chosen = max(_shares(args, want, ref.BWD_ROUNDING).values())
    assert once > 1 > 3 * chosen, (once, chosen)


# ---------------------------------------------- (iii) MLSTM's plumbing
@pytest.fixture
def swapped(monkeypatch):
    """``ops._forward`` and ``ops.mlstm_bwd`` replaced by the plain version
    and the split, recording what the backward was handed."""
    seen = {}

    def forward(q, k, v, log_i, log_f, state, chunk, scale):
        seen["fwd"] = (state, chunk, scale)
        return ref.mlstm_ref(q, k, v, log_i, log_f, state, chunk=chunk, scale=scale)

    def backward(q, k, v, log_i, log_f, state, dh, dstate=None, final=None, *, chunk,
                 scale=1.0, want_dstate=True):
        seen.update(dstate=dstate, final=final, want_dstate=want_dstate, chunk=chunk,
                    scale=scale)
        got = ref.mlstm_bwd_tiled(q, k, v, log_i, log_f, state, dh, dstate, chunk=chunk,
                                  scale=scale)
        return (*got[:5], got[5] if want_dstate else None)
    monkeypatch.setattr(ops, "_forward", forward)
    monkeypatch.setattr(ops, "mlstm_bwd", backward)
    return seen


@pytest.mark.parametrize("with_state,use_fin", [(False, False), (True, True), (True, False),
                                                (False, True)])
def test_mlstm_function_routes_gradients(swapped, with_state, use_fin):
    """``MLSTM``: the forward's final (C, n) is handed to the backward, the
    final state's gradients are None where unused, the start state gets
    gradients exactly where it requires them, and they equal autograd of
    the plain version."""
    x, state, dh, dstate = _inputs(5, 2, 11, 2, 32)
    leaves = [a.clone().requires_grad_(True) for a in x]
    sl = [a.clone().requires_grad_(True) for a in state] if with_state else [None] * 3
    h, C, n, m = ops.MLSTM.apply(*leaves, *sl, 4, 0.5)
    assert swapped["fwd"][1:] == (4, 0.5)
    loss = (h * dh).sum()
    if use_fin:
        loss = loss + (C * dstate[0]).sum() + (n * dstate[1]).sum() + (m * dstate[2]).sum()
    got = torch.autograd.grad(loss, leaves + (sl if with_state else []))
    assert swapped["chunk"] == 4 and swapped["scale"] == 0.5
    assert all((g is None) != use_fin for g in swapped["dstate"])
    assert [t.data_ptr() for t in swapped["final"]] == [C.data_ptr(), n.data_ptr()]
    assert swapped["want_dstate"] == with_state
    want = _autograd(x, state if with_state else None, dh, dstate if use_fin else None, 4,
                     scale=0.5)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-10


def test_mlstm_chunkwise_on_the_cpu_differentiates_the_plain_version():
    """On the CPU, ``mlstm_chunkwise`` is the plain version under autograd:
    no launch, no backward launch."""
    x, _, dh, _ = _inputs(8, 1, 10, 2, 8)
    f0, b0 = ops.mlstm_chunkwise.launches, ops.mlstm_bwd.launches
    q = x[0].clone().requires_grad_(True)
    h, _ = ops.mlstm_chunkwise(q, *x[1:], chunk=4)
    assert h.grad_fn is not None
    (h * dh).sum().backward()
    assert (ops.mlstm_chunkwise.launches, ops.mlstm_bwd.launches) == (f0, b0)
    assert _rel(q.grad, _autograd(x, None, dh, None, 4)[0]) < 1e-12

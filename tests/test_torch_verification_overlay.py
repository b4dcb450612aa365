"""Port parity on the CPU for serving-quality verification through the
anonymous overlay (§3.4): the dishonest model nodes of ``ModelNode``
(``behaviour`` = ``drop`` or ``swap_model``, and ``respond_fn``) and the
committee's epochs driven end to end, on both packages' ``build_overlay``
with the same deterministic ``os.urandom`` / ``random`` streams
(``test_torch_privacy_overlay.build``).

A verification node's ``send_challenges`` sends the agreed challenge
prompts through its anonymous client's proxies to the model nodes;
``collect()`` gathers the responses that came back from the node that was
challenged, ``missing()`` names the rest; the committee's ``run_epoch``
scores them with each package's own verifier (``core/verification.py``,
``credibility_batch`` over the honest weights).  Model nodes serve
locally here (``fwd_mode = "none"``): a challenge that a node forwards to
a peer comes back from the peer, and both packages count it missing (the
last test)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.gt_model import _quantize  # noqa: E402
from repro.configs import base  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import verification as jver  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import verification as tver  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from test_torch_privacy_overlay import (NAME, PKGS, _record_sigs,  # noqa: E402,F401
                                        _restore_urandom, build, roundtrip, summary)

CONS = {"jax": jcons, "torch": tcons}


def _local(ov):
    for m in ov.models:
        m.fwd_mode = "none"
    return ov


def _challenge(ov, challenges, max_new, wait=60):
    """The committee's leader sends ``challenges`` through the overlay;
    returns the leader and every response payload its client received."""
    leader = ov.verifiers[ov.committee.leader()]
    leader.send_challenges(ov.net, challenges, max_new=max_new)
    payloads, on_resp = [], leader.client.on_response

    def record(net, payload):
        payloads.append(payload)
        on_resp(net, payload)
    leader.client.on_response = record
    ov.net.run_until(ov.net.t + wait)
    return leader, payloads


# ------------------------------------------------- the dishonest behaviours
def test_drop_node_leaves_its_challenge_missing():
    """A ``drop`` node observes the prompt (its Sentry counts it) and never
    answers: its challenge is in ``missing()``, the honest node's in
    ``collect()``; the same on both packages."""
    out = {}
    for k, p in PKGS.items():
        ov = _local(build(p, n_users=12, n_models=2, use_crypto=False, seed=1,
                          score_fns=[lambda pairs: 0.5] * 4,
                          model_behaviours={"m1": "drop"}))
        assert [m.behaviour for m in ov.models] == ["honest", "drop"]
        chs = [CONS[k].Challenge("m0", tuple(range(20))),
               CONS[k].Challenge("m1", tuple(range(5, 30)))]
        ov.committee.agree_challenges(chs)
        leader, payloads = _challenge(ov, chs, max_new=4)
        got = [(r.model_node, r.prompt, r.response) for r in leader.collect()]
        assert leader.missing() == ["m1"] and [g[0] for g in got] == ["m0"]
        m1 = ov.models[1]
        assert m1.sentry._count == 1 and m1.sentry._buffer == [tuple(range(5, 30))]
        assert m1.metrics["served"] == 0 and m1.active_requests == 0
        out[k] = (got, leader.missing(), summary(ov, payloads))
    assert out["torch"] == out["jax"]


def test_swap_model_serves_as_honest():
    """``swap_model`` is a label in the reference: no branch reads it, so
    the node serves honestly; on the port too, byte for byte."""
    runs = {}
    for k, p in PKGS.items():
        for beh in ("honest", "swap_model"):
            ov = build(p, n_users=12, n_models=2, use_crypto=True, seed=2,
                       model_behaviours={"m0": beh, "m1": beh})
            sigs = _record_sigs(ov)
            got = [roundtrip(ov, i, [i + 1] * (30 + i)) for i in (0, 3, 6)]
            runs[k, beh] = (summary(ov, got), sigs)
    assert runs["torch", "swap_model"] == runs["torch", "honest"]
    assert runs["torch", "swap_model"] == runs["jax", "swap_model"]


@pytest.fixture(scope="module")
def llama():
    """The reduced llama of ``test_torch_privacy_overlay.py``'s ``llama``
    fixture, and the harsh impostor "m3" of ``benchmarks/gt_model.py``
    (one quantization level, noise 0.08) of its weights: engine factories
    and verifiers over the honest weights, for each package."""
    jcfg = base.get_config(NAME).reduced()
    tcfg = configs.get_config(NAME).reduced()
    jmodel = build_model(jcfg)
    honest = jmodel.init(jax.random.PRNGKey(0))
    weights = {"honest": honest, "impostor": _quantize(honest, levels=1, noise=0.08)}
    tweights = {n: from_jax_params(jax.tree.map(np.asarray, w), device="cpu")
                for n, w in weights.items()}
    tmodel = LM(tcfg, device="cpu")
    return {
        "jax": {"engine": lambda n: jengine.RealEngine(jcfg, jmodel, weights[n], max_len=128),
                "verifier": jver.VerifierModel(jcfg, jmodel, honest), "ver": jver,
                "request": jengine.Request},
        "torch": {"engine": lambda n: tengine.RealEngine(tcfg, tmodel, tweights[n],
                                                         max_len=128, device="cpu"),
                  "verifier": tver.VerifierModel(tcfg, tmodel, tweights["honest"]),
                  "ver": tver, "request": tengine.Request}}


def _respond_fn_scenario(p, eng, when):
    """One signed request to a real-engine node whose ``respond_fn`` is set
    before the request arrives (``before``), while it is in flight
    (``mid``: the engine's request is retired), or set at arrival and
    unset while in flight (``late``: the engine serves it at completion)."""
    ov = _local(build(p, n_users=8, n_models=2, use_crypto=True, seed=4))
    sigs = _record_sigs(ov)
    for m in ov.models:
        m.real_engine = eng

    def respond(toks):
        return [(t * 7 + 1) % 100 for t in toks[:6]]
    u, got = ov.users[0], []
    u.on_response = lambda _n, pl: got.append(pl)
    if when in ("before", "late"):
        for m in ov.models:
            m.respond_fn = respond
    prompt = [(11 * j) % 256 for j in range(40)]
    u.send_prompt(ov.net, prompt, extra_meta={"max_new": 6})
    while not any(m.metrics["served"] for m in ov.models):
        ov.net.run_until(ov.net.t + 0.01)
    for m in ov.models:
        m.respond_fn = respond if when == "mid" else None if when == "late" else m.respond_fn
    ov.net.run_until(ov.net.t + 60)
    return ov, got, sigs, respond(prompt)


@pytest.mark.parametrize("when", ["before", "mid", "late"])
def test_respond_fn_output_is_returned_and_signed(llama, when):
    out = {}
    for k, p in PKGS.items():
        eng = llama[k]["engine"]("honest")
        ov, got, sigs, fake = _respond_fn_scenario(p, eng, when)
        assert len(got) == 1
        if when == "late":
            fake = llama[k]["engine"]("honest").generate(llama[k]["request"](
                0, [(11 * j) % 256 for j in range(40)], max_new=6)).output
        assert got[0]["output"] == fake
        server = next(m for m in ov.models if m.node_id == got[0]["server"])
        sig = {s for node, mid, s in sigs if mid == got[0]["msg_id"]}
        assert len(sig) == 1
        assert p.ed.verify(server.public, p.encode(got[0]), bytes.fromhex(sig.pop()))
        sched = server._real_sched
        if when == "before":
            assert sched is None                       # never reached the engine
        else:
            assert not (sched.queue or sched.active) and sched.metrics["completed"] == 1
        assert server._rid_by_msg == {} and server._real_results == {}
        out[k] = (summary(ov, got), sigs)
    assert out["torch"] == out["jax"]


# --------------------------------------- committee epochs through the overlay
def _epochs(k, p, llama, use_crypto, n_epochs=3):
    """Two real-engine nodes, m0 on the honest weights and m1 on the
    impostor's; four verification nodes each scoring with its package's
    verifier through ``credibility_batch``.  Each epoch: agree on one new
    16-24-token challenge a node, the leader sends them through the
    overlay (8 tokens served), ``collect`` -> ``run_epoch``."""
    ver, v = llama[k]["ver"], llama[k]["verifier"]

    def score(pairs):
        return float(np.mean(ver.credibility_batch(v, pairs))) if pairs else 0.0
    ov = _local(build(p, n_users=12, n_models=2, use_crypto=use_crypto, seed=6,
                      score_fns=[score] * 4))
    sigs = _record_sigs(ov)
    for m, w in zip(ov.models, ("honest", "impostor")):
        m.real_engine = llama[k]["engine"](w)
    rng = np.random.default_rng(7)
    log = []
    for _ in range(n_epochs):
        chs = [CONS[k].Challenge(m.node_id, tuple(int(t) for t in rng.integers(
            0, 256, size=int(rng.integers(16, 25))))) for m in ov.models]
        ov.committee.agree_challenges(chs)
        leader, payloads = _challenge(ov, chs, max_new=8)
        assert leader.missing() == []
        responses = leader.collect()
        res = ov.committee.run_epoch(lambda _l, _c: responses)
        pubs = {m.node_id: m.public for m in ov.models}
        signed = [{s for _, mid, s in sigs if mid == pl["msg_id"]} for pl in payloads]
        verified = sum(len(ss) == 1 and all(s and p.ed.verify(
            pubs[pl["server"]], p.encode(pl), bytes.fromhex(s)) for s in ss)
            for pl, ss in zip(payloads, signed))
        log.append({"leader": res.leader, "committed": res.committed,
                    "responses": [(r.model_node, r.prompt, r.response) for r in responses],
                    "creds": {r.model_node: ver.credibility(v, list(r.prompt), list(r.response))
                              for r in responses},
                    "scores": res.scores, "reputations": res.reputations,
                    "signed": signed, "verified": verified})
    return log, ov.committee.untrusted(), summary(ov, [])


@pytest.mark.parametrize("use_crypto", [False, True], ids=["plain", "signed"])
def test_committee_epochs_through_the_overlay_match_reference(llama, use_crypto):
    """Responses, credibilities, scores, reputations and ``untrusted()``
    equal the reference's; every epoch commits, both challenges come back,
    signed responses verify (with crypto off every clove carries an empty
    signature), and the
    honest node out-scores the impostor."""
    out = {k: _epochs(k, p, llama, use_crypto) for k, p in PKGS.items()}
    (jlog, juntr, jsum), (tlog, tuntr, tsum) = out["jax"], out["torch"]
    assert tuntr == juntr and tsum == jsum
    for je, te in zip(jlog, tlog):
        assert te["committed"] and te["leader"] == je["leader"]
        assert te["responses"] == je["responses"] and len(te["responses"]) == 2
        assert te["signed"] == je["signed"] and te["verified"] == je["verified"]
        if use_crypto:
            assert te["verified"] == 2
        else:
            assert te["signed"] == [{""}, {""}]
        for key in ("creds", "scores", "reputations"):
            assert te[key].keys() == je[key].keys()
            np.testing.assert_allclose([te[key][n] for n in je[key]], list(je[key].values()),
                                       atol=1e-6, rtol=0, err_msg=key)
        assert te["creds"]["m0"] > te["creds"]["m1"], te["creds"]


def test_forwarded_challenge_counts_as_missing():
    """A reference quirk the port keeps: with forwarding on, a model node
    may pass a challenge to a peer; the response then names the peer as
    its server and ``send_challenges`` drops it, so the challenge shows up
    in ``missing()`` though it was answered."""
    out = {}
    for k, p in PKGS.items():
        ov = build(p, n_users=12, n_models=2, use_crypto=False, seed=1,
                   score_fns=[lambda pairs: 0.5] * 4)
        chs = [CONS[k].Challenge("m0", tuple(range(20))),
               CONS[k].Challenge("m1", tuple(range(5, 30)))]
        leader, payloads = _challenge(ov, chs, max_new=4)
        fwd = {m.node_id: m.metrics["forwarded_out"] for m in ov.models}
        assert sum(fwd.values()) >= 1 and len(payloads) == 2
        forwarded = [n for n, c in fwd.items() if c]
        assert sorted(leader.missing()) == sorted(forwarded)
        out[k] = (fwd, leader.missing(), summary(ov, payloads))
    assert out["torch"] == out["jax"]

"""Port parity on the CPU for the whole overlay: ``build_overlay`` of the
JAX package and of the port, driven through the same scenarios.

Every scenario of ``test_overlay_e2e.py`` (roundtrip, no user identity at
the model, session affinity, one dead path, HR-tree cache affinity, churn
survival, anonymity ordering) runs on both packages' overlays with
``LatencyEngine`` model nodes; the responses, every node metric (the
simulated TTFT and completion lists included), the user stats and the
network's counters must be equal.  So must the real-engine scenario of
``test_batched_decode.py`` (reduced float32 llama, weights carried across
by ``params.from_jax_params``): tokens and scheduler counters.  A small
overlay with ``use_crypto=True`` checks that every signed response
verifies under its model node's public key and that the run equals the
reference's.  The reference draws keys, path ids and bucket keys from
``os.urandom`` and start times from the global ``random``: both packages
read one deterministic stream of each, restarted before each build."""
import os
import random
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.core import anonymity as janon  # noqa: E402
from repro.core import ed25519 as jed  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.net import simnet as jsimnet  # noqa: E402
from repro.overlay import network as jnet  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import anonymity as tanon  # noqa: E402
from repro_torch.core import ed25519 as ted  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.net import simnet as tsimnet  # noqa: E402
from repro_torch.net import wire  # noqa: E402
from repro_torch.overlay import network as tnet  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

NAME = "gentorrent-llama3-8b"
PKGS = {
    "jax": types.SimpleNamespace(
        build=jnet.build_overlay, Config=jnet.OverlayConfig, Churn=jsimnet.ChurnProcess,
        anon=janon, ed=jed, encode=lambda o: msgpack.packb(o, use_bin_type=True)),
    "torch": types.SimpleNamespace(
        build=lambda cfg, **kw: tnet.build_overlay(cfg, device="cpu", **kw),
        Config=tnet.OverlayConfig, Churn=tsimnet.ChurnProcess, anon=tanon, ed=ted,
        encode=wire.packb),
}


def build(p, seed=0, score_fns=None, model_behaviours=None, **kw):
    """``p``'s overlay, with ``os.urandom`` and the global ``random``
    restarted from ``seed``."""
    os.urandom = random.Random(seed).randbytes
    random.seed(seed)
    return p.build(p.Config(**kw), score_fns=score_fns, model_behaviours=model_behaviours)


@pytest.fixture(autouse=True)
def _restore_urandom(monkeypatch):
    monkeypatch.setattr(os, "urandom", os.urandom)


def roundtrip(ov, i, tokens, session=None, max_new=4):
    """test_overlay_e2e.py::_roundtrip."""
    got = []
    u = ov.users[i]
    u.on_response = lambda _n, p: got.append(p)
    u.send_prompt(ov.net, tokens, session=session, extra_meta={"max_new": max_new})
    ov.net.run_until(ov.net.t + 60)
    return got


def summary(ov, got):
    return {"got": got, "t": ov.net.t, "delivered": ov.net.delivered,
            "dropped": ov.net.dropped,
            "models": {m.node_id: {"metrics": m.metrics, "active": m.active_requests,
                                   "tree": sorted(map(tuple, m.hrtree.export_paths(m.node_id))),
                                   "peers": {k: (v.active_requests, v.hw_score)
                                             for k, v in sorted(m.peers.items())}}
                       for m in ov.models},
            "users": {u.node_id: {"stats": u.stats, "sessions": u.sessions,
                                  "paths": [(pp.path_id, pp.proxy_id, pp.relays, pp.established)
                                            for pp in u.paths],
                                  "routes": len(u.relay.routes)}
                      for u in ov.users}}


# ------------------------------------------------------------ scenarios
def shared_overlay(p):
    """The module fixture of test_overlay_e2e.py (30 users, 4 models, seed
    3) through its three tests in order: roundtrip, no user identity at
    the model, session affinity."""
    ov = build(p, n_users=30, n_models=4, use_crypto=False, seed=3)
    got = [roundtrip(ov, 0, [1, 2, 3] * 30)]
    seen = {}
    m = ov.models[0]
    orig = m._process

    def spy(net, payload, forwarded=False, **kw):
        seen.update(payload)
        return orig(net, payload, forwarded=forwarded, **kw)
    m._process = spy
    got.append(roundtrip(ov, 5, [9] * 64))
    m._process = orig
    got.append(sorted(seen))
    got.append(roundtrip(ov, 7, [4] * 100, session="sess-x"))
    got.append(roundtrip(ov, 7, [4] * 100 + [5, 6], session="sess-x"))
    return ov, got


def dead_path(p):
    ov = build(p, n_users=30, n_models=2, n_proxies=6, sida_n=4, sida_k=3,
               use_crypto=False, seed=11)
    u = ov.users[0]
    victim = next(pp.first_hop for pp in u.live_paths() if pp.first_hop != u.node_id)
    ov.net.remove_node(victim)
    return ov, [victim, roundtrip(ov, 0, [3] * 50)]


def cache_affinity(p):
    ov = build(p, n_users=24, n_models=4, use_crypto=False, seed=5, sync_every=2.0)
    shared = list(range(200))
    got = [roundtrip(ov, 0, shared + [11] * 40)]
    ov.net.run_until(ov.net.t + 10)
    for i in (3, 6, 9):
        got.append(roundtrip(ov, i, shared + [100 + i] * 40))
    return ov, got


def churn(p):
    ov = build(p, n_users=40, n_models=2, n_proxies=6, use_crypto=False, seed=7)
    pool = [u.node_id for u in ov.users[10:]]
    events = []
    ch = p.Churn(ov.net, pool, rate_per_min=10, seed=2,
                 on_leave=lambda n: events.append(("leave", n, ov.net.t)),
                 on_join=lambda n: events.append(("join", n, ov.net.t)))
    ch.start()
    got = []
    for i in range(10):
        ov.users[i % 10].maintain(ov.net)
        ov.net.run_until(ov.net.t + 2)
        got.append(roundtrip(ov, i % 10, [i] * 60))
    return ov, [got, events, sorted(ch.offline)]


def _record_sigs(ov):
    """Every response clove a model node sends: (model, msg_id, sig)."""
    sigs = []
    send = ov.net.send
    models = {m.node_id for m in ov.models}

    def spy(src, dst, msg, size_bytes=1024):
        if src in models and msg.get("type") == "response_clove":
            sigs.append((src, msg["msg_id"], msg["sig"]))
        send(src, dst, msg, size_bytes)
    ov.net.send = spy
    return sigs


def crypto(p):
    """A small signed overlay: onion establishment, signed lists, four
    users (two prompts share a 64-token prefix, one user twice in one
    session), every response clove signed."""
    ov = build(p, n_users=12, n_models=2, use_crypto=True, seed=1, sync_every=2.0)
    sigs = _record_sigs(ov)
    shared = list(range(64))
    got = [roundtrip(ov, 0, shared + [1] * 20), roundtrip(ov, 4, shared + [2] * 30),
           roundtrip(ov, 8, [9] * 40, session="s"), roundtrip(ov, 8, [9] * 41, session="s"),
           roundtrip(ov, 11, [5, 6, 7] * 11)]
    pubs = {m.node_id: m.public for m in ov.models}
    verified = []
    for resp in (r for g in got for r in g):
        blob = p.encode(resp)
        mine = {s for node, mid, s in sigs if mid == resp["msg_id"]}
        assert len(mine) == 1, mine
        verified.append(p.ed.verify(pubs[resp["server"]], blob, bytes.fromhex(mine.pop())))
    return ov, [got, sigs, verified, pubs,
                [(u.node_id, u.dh_pub, u.sign_key.public) for u in ov.users]]


SCENARIOS = {"shared_overlay": shared_overlay, "dead_path": dead_path,
             "cache_affinity": cache_affinity, "churn": churn, "crypto": crypto}


@pytest.fixture(scope="module")
def runs():
    cache = {}
    real = os.urandom

    def get(name):
        if name not in cache:
            try:
                cache[name] = {k: SCENARIOS[name](p) for k, p in PKGS.items()}
            finally:
                os.urandom = real
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(runs, name):
    r = runs(name)
    (jov, jgot), (tov, tgot) = r["jax"], r["torch"]
    assert summary(tov, tgot) == summary(jov, jgot)


def test_roundtrip_and_no_user_identity(runs):
    """test_overlay_e2e.py: the response arrives; the payload a model node
    recovers names no sender, only the user's proxies."""
    _, (rt, _, seen_keys, s1, s2) = runs("shared_overlay")["torch"]
    assert len(rt) == 1 and rt[0]["output"] == [0, 1, 2, 3]
    assert "sender" not in seen_keys and "user" not in seen_keys
    assert s1 and s2 and s2[0]["server"] == s1[0]["server"]          # session affinity


def test_clove_delivery_survives_path_failure(runs):
    ov, (_, got) = runs("dead_path")["torch"]
    assert len(got) == 1, "k-of-n S-IDA must survive one dead path"


def test_hrtree_forwarding_cache_affinity(runs):
    ov, _ = runs("cache_affinity")["torch"]
    assert sum(m.metrics["cache_hits"] for m in ov.models) >= 2


def test_churn_survival_rate(runs):
    ov, (got, events, _) = runs("churn")["torch"]
    assert events and sum(1 for g in got if g) >= 6


def test_signed_responses_verify(runs):
    ov, (got, sigs, verified, pubs, _) = runs("crypto")["torch"]
    assert all(len(g) == 1 for g in got) and len(verified) == 5 and all(verified)
    assert len(set(pubs.values())) == 2 and bytes(32) not in pubs.values()
    # a tampered response fails
    resp = dict(got[0][0], output=[1, 2, 3])
    sig = next(s for _, mid, s in sigs if mid == resp["msg_id"])
    assert not ted.verify(pubs[resp["server"]], wire.packb(resp), bytes.fromhex(sig))


def test_crypto_overlay_rejects_a_forged_list():
    p = PKGS["torch"]
    ov = build(p, n_users=6, n_models=1, use_crypto=True, seed=2)
    ul, ml = ov.registry.user_list(), ov.registry.model_list()
    ul.records = ul.records[:-1]
    with pytest.raises(AssertionError, match="bad user list"):
        ov.users[0].load_lists(ul, ml, ov.registry.committee_pubs)


def test_anonymity_metric_ordering():
    out = {}
    for k, p in PKGS.items():
        rng = random.Random(0)
        N, f = 2000, 0.05
        gt = sum(p.anon.gentorrent_anonymity(N, f, 4, 3, rng) for _ in range(30)) / 30
        on = sum(p.anon.onion_anonymity(N, f, 3, rng) for _ in range(30)) / 30
        gc = sum(p.anon.garlic_anonymity(N, f, 4, 3, rng) for _ in range(30)) / 30
        out[k] = (gt, on, gc)
    assert out["torch"] == out["jax"]
    gt, on, gc = out["torch"]
    assert 0.0 <= on <= 1.0 and gt > 0.9 and gt >= gc


def test_model_nodes_sign_by_default():
    from repro_torch.overlay.model_node import ModelNode
    m = ModelNode("m0", device="cpu")
    assert m.use_crypto and m.public == m.sign_key.public
    assert ModelNode("m1", use_crypto=False, device="cpu").public == bytes(32)


# ------------------------------------------ test_batched_decode.py:186-209
@pytest.fixture(scope="module")
def llama():
    jcfg = base.get_config(NAME).reduced()
    tcfg = configs.get_config(NAME).reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return {"jax": lambda: jengine.RealEngine(jcfg, jmodel, jparams, max_len=128),
            "torch": lambda: tengine.RealEngine(tcfg, LM(tcfg, device="cpu"), tparams,
                                                max_len=128, device="cpu")}


REQUEST = {"jax": jengine.Request, "torch": tengine.Request}


@pytest.mark.parametrize("use_crypto", [False, True], ids=["plain", "signed"])
def test_real_engine_overlay_matches_reference(llama, use_crypto):
    """ModelNode's real-engine path serves through the batched scheduler
    behind the whole overlay: the same tokens as a direct generate, as the
    reference, and the same scheduler and engine counters."""
    prompts = [[5] * 20, [(37 * j) % 256 for j in range(44)], [5] * 20 + [6] * 12]
    out = {}
    for k, p in PKGS.items():
        ref = [llama[k]().generate(REQUEST[k](0, pr, max_new=4)).output for pr in prompts]
        ov = build(p, n_users=8, n_models=2, use_crypto=use_crypto, seed=5)
        eng = llama[k]()
        for m in ov.models:
            m.real_engine = eng
        got = [roundtrip(ov, i, pr) for i, pr in enumerate(prompts)]
        served = [m for m in ov.models if m._real_sched is not None]
        assert [g[0]["output"] for g in got] == ref
        out[k] = {"summary": summary(ov, got), "ref": ref,
                  "sched": {m.node_id: m._real_sched.metrics for m in served},
                  "engine": {c: getattr(eng, c) for c in ("prefill_dispatches",
                                                          "prefill_tokens",
                                                          "batched_traces")}}
    assert out["torch"] == out["jax"]
    sched = out["torch"]["sched"]
    assert sched and sum(s["decode_calls"] for s in sched.values()) > 0
    assert sum(s["completed"] for s in sched.values()) == len(prompts)

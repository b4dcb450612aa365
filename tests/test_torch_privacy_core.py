"""Port parity on the CPU for the privacy path's host code: Ed25519 and
X25519, the VRF, onion establishment, reputation and the verification
committee, the registry's signed lists, the anonymity metric, the wire
schema and framing, the TCP transport and the churn process.

The cases of ``test_onion_identity.py`` and ``test_transport_scheduler.py``
run on the port; everything the two packages compute from the same inputs
(signatures, VRF proofs, onion cells, signed lists, frames, reputations,
commits, leaders, abort reasons, churn schedules) must be equal to the
byte.  Where the reference draws from ``os.urandom``, both packages read
one deterministic stream, restarted before each package's run."""
import os
import random
import time
import types

import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import anonymity as janon  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import ed25519 as jed  # noqa: E402
from repro.core import onion as jonion  # noqa: E402
from repro.core import reputation as jrep  # noqa: E402
from repro.core import vrf as jvrf  # noqa: E402
from repro.net import messages as jmsg  # noqa: E402
from repro.net import simnet as jsimnet  # noqa: E402
from repro.overlay import registry as jreg  # noqa: E402
from repro_torch.core import anonymity as tanon  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import ed25519 as ted  # noqa: E402
from repro_torch.core import onion as tonion  # noqa: E402
from repro_torch.core import reputation as trep  # noqa: E402
from repro_torch.core import vrf as tvrf  # noqa: E402
from repro_torch.net import messages as tmsg  # noqa: E402
from repro_torch.net import simnet as tsimnet  # noqa: E402
from repro_torch.net.tcp import TcpNet  # noqa: E402
from repro_torch.overlay import registry as treg  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(ed=jed, vrf=jvrf, onion=jonion, rep=jrep,
                                 cons=jcons, anon=janon, msg=jmsg, reg=jreg,
                                 simnet=jsimnet),
    "torch": types.SimpleNamespace(ed=ted, vrf=tvrf, onion=tonion, rep=trep,
                                   cons=tcons, anon=tanon, msg=tmsg, reg=treg,
                                   simnet=tsimnet),
}


def urandom_stream(seed):
    """A deterministic stand-in for ``os.urandom``."""
    rng = random.Random(seed)
    return rng.randbytes


def both(fn, monkeypatch=None, seed=0):
    """``fn(pkg)`` once per package; with ``monkeypatch``, each run reads
    the same ``os.urandom`` stream from its start."""
    out = {}
    for name, pkg in PKGS.items():
        if monkeypatch is not None:
            monkeypatch.setattr(os, "urandom", urandom_stream(seed))
        out[name] = fn(pkg)
    return out


def assert_same(fn, monkeypatch=None, seed=0):
    r = both(fn, monkeypatch, seed)
    assert r["torch"] == r["jax"]
    return r["torch"]


# ------------------------------------------------------------ RFC vectors
RFC8032 = [  # RFC 8032 §7.1, tests 1 and 2: (secret, public, message, signature)
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
]


@pytest.mark.parametrize("case", range(len(RFC8032)))
def test_ed25519_rfc8032_vector(case):
    sk_hex, pk_hex, msg_hex, sig_hex = RFC8032[case]
    sk = ted.SigningKey(bytes.fromhex(sk_hex))
    msg = bytes.fromhex(msg_hex)
    assert sk.public.hex() == pk_hex
    assert sk.sign(msg).hex() == sig_hex
    assert ted.verify(sk.public, msg, bytes.fromhex(sig_hex))


def test_x25519_rfc7748_vectors():
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd"
                      "62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c"
                      "726624ec26b3353b10a903a6d0ab1c4c")
    assert ted.x25519(k, u) == bytes.fromhex("c3da55379de9c6908e94ea4df28d084f"
                                             "32eccf03491c71f754b4075577a28552")
    # §6.1: Alice and Bob
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    a_pub, b_pub = ted.x25519(a), ted.x25519(b)
    assert a_pub.hex() == "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    assert b_pub.hex() == "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert ted.x25519(a, b_pub).hex() == ted.x25519(b, a_pub).hex() == shared


# ------------------------------------------------ test_onion_identity.py
def test_ed25519_sign_verify():
    sk = ted.SigningKey(b"\x01" * 32)
    sig = sk.sign(b"hello")
    assert ted.verify(sk.public, b"hello", sig)
    assert not ted.verify(sk.public, b"hellO", sig)
    assert not ted.verify(sk.public, b"hello", sig[:-1] + b"\x00")
    assert not ted.verify(sk.public, b"hello", b"\xff" * 64)      # s >= L


def test_dh_agreement():
    a_sk, a_pub = ted.dh_keypair(b"\x02" * 32)
    b_sk, b_pub = ted.dh_keypair(b"\x03" * 32)
    assert ted.dh_shared(a_sk, b_pub) == ted.dh_shared(b_sk, a_pub)


def test_vrf_prove_verify():
    sk = ted.SigningKey(b"\x04" * 32)
    beta, proof = tvrf.prove(sk, b"epoch-seed")
    assert tvrf.verify(sk.public, b"epoch-seed", beta, proof)
    assert not tvrf.verify(sk.public, b"other-seed", beta, proof)
    sk2 = ted.SigningKey(b"\x05" * 32)
    assert not tvrf.verify(sk2.public, b"epoch-seed", beta, proof)


def test_vrf_leader_uniform():
    from collections import Counter
    c = Counter(tvrf.leader_index([bytes([i]) * 4], 4) for i in range(64))
    assert len(c) == 4


def _hops(seed0):
    hops, sks = [], {}
    for i in range(3):
        s, p = ted.dh_keypair(bytes([seed0 + i]) * 32)
        hops.append((f"r{i}", p))
        sks[f"r{i}"] = s
    return hops, sks


def test_onion_establishment_peel_chain():
    hops, sks = _hops(10)
    pid, first, blob = tonion.build_establishment("user", b"\xAA" * 32, hops)
    assert first == "r0"
    ids = ["user", "r0", "r1", "r2"]
    for i in range(3):
        p, pred, succ, inner, pay = tonion.peel_establishment(blob, sks[f"r{i}"])
        assert p == pid and pred == ids[i]
        if i < 2:
            assert succ == ids[i + 2]
            blob = inner
        else:
            assert succ is None
            assert pay[8:] == b"\xAA" * 32  # nonce || user pub


def test_onion_wrong_key_fails_or_garbage():
    hops, _ = _hops(20)
    _, _, blob = tonion.build_establishment("user", b"\xBB" * 32, hops)
    wrong_sk, _ = ted.dh_keypair(b"\x99" * 32)
    with pytest.raises(Exception):
        pid, pred, succ, inner, pay = tonion.peel_establishment(blob, wrong_sk)
        assert succ in ("r1",) and pred == "user"


def test_relay_state_bidirectional():
    rs = tonion.RelayState()
    rs.install(b"p" * 16, "prev", "next")
    assert rs.next_hop(b"p" * 16, "prev") == "next"
    assert rs.next_hop(b"p" * 16, "next") == "prev"
    assert rs.next_hop(b"p" * 16, "outside") == "prev"
    assert rs.next_hop(b"q" * 16, "prev") is None
    rs.drop_path(b"p" * 16)
    assert rs.next_hop(b"p" * 16, "prev") is None


# ------------------------------------------------ byte-equal to the reference
MESSAGES = [b"", b"hello", bytes(range(256)), b"\x00" * 1000]


@pytest.mark.parametrize("seed", [b"\x01" * 32, bytes(range(32)), None])
def test_signatures_match_reference(monkeypatch, seed):
    """Keys from a seed (or from the patched ``os.urandom``), signatures
    and verification of good and tampered signatures."""
    def run(p):
        sk = p.ed.SigningKey(seed)
        sigs = [sk.sign(m) for m in MESSAGES]
        return (sk.seed, sk.public, sigs,
                [p.ed.verify(sk.public, m, s) for m, s in zip(MESSAGES, sigs)],
                [p.ed.verify(sk.public, m + b"!", s) for m, s in zip(MESSAGES, sigs)])
    out = assert_same(run, monkeypatch)
    assert all(out[3]) and not any(out[4])


def test_dh_and_vrf_match_reference(monkeypatch):
    def run(p):
        pairs = [p.ed.dh_keypair(bytes([i]) * 32) for i in range(3)] + \
            [p.ed.dh_keypair() for _ in range(2)]
        shared = [p.ed.dh_shared(a[0], b[1]) for a in pairs for b in pairs]
        sk = p.ed.SigningKey(b"\x04" * 32)
        proofs = [p.vrf.prove(sk, alpha) for alpha in (b"genesis", b"epoch-1", b"")]
        leaders = [p.vrf.leader_index([bytes([i]) * 4, b"x"], n)
                   for i in range(32) for n in (4, 7)]
        return pairs, shared, proofs, leaders
    assert_same(run, monkeypatch)


@pytest.mark.parametrize("ids", [("user", "r0", "r1", "r2"),
                                 (b"\x01" * 8, 3, "r1", -7)],
                         ids=["str_ids", "mixed_ids"])
def test_onion_cells_match_reference(monkeypatch, ids):
    """The establishment onion (ephemeral keys and nonce from the patched
    stream) and every layer peeled from it."""
    def run(p):
        keys = [p.ed.dh_keypair(bytes([30 + i]) * 32) for i in range(3)]
        hops = [(ids[i + 1], keys[i][1]) for i in range(3)]
        pid, first, blob = p.onion.build_establishment(ids[0], b"\xCC" * 32, hops)
        layers = [(pid, first, blob)]
        for sk, _ in keys:
            layer = p.onion.peel_establishment(blob, sk)
            layers.append(layer)
            blob = layer[3]
        return layers
    layers = assert_same(run, monkeypatch)
    assert layers[-1][2] is None and layers[-1][4][8:] == b"\xCC" * 32


def _registry(p, n_vn, n_users, n_models, use_crypto=True):
    keys = {f"vn{i}": p.ed.SigningKey(bytes([50 + i]) * 32) for i in range(n_vn)}
    reg = p.reg.Registry(keys, use_crypto=use_crypto)
    for i in range(n_users):
        reg.register_user(p.reg.NodeRecord(f"u{i}", dh_pub=bytes([i]) * 32,
                                           region=f"r{i % 3}"))
    for i in range(n_models):
        reg.register_model(p.reg.NodeRecord(f"m{i}", pubkey=bytes([i]) * 32,
                                            llm="llama" if i % 4 else "mistral",
                                            region=f"r{i % 2}", hw_score=1.0 + i % 7))
    return reg


def _signed(sl, pubs):
    return (sl.digest(), sorted(sl.signatures.items()),
            [(str(r.node_id), r.region, r.llm) for r in sl.records], sl.verify(pubs))


@pytest.mark.parametrize("use_crypto", [True, False])
def test_signed_registry_lists_match_reference(use_crypto):
    def run(p):
        reg = _registry(p, 4, 7, 9, use_crypto)
        pubs = reg.committee_pubs
        out = [_signed(reg.user_list(), pubs), _signed(reg.user_list("r1"), pubs),
               _signed(reg.model_list(), pubs), _signed(reg.model_list("llama", "r1"), pubs)]
        reg.deregister("u3")
        reg.deregister("m2")
        out.append(_signed(reg.user_list(), pubs))
        out.append([[r.node_id for r in g] for g in reg.model_groups("llama")])
        return sorted(pubs.items()), out
    _, out = assert_same(run)
    assert all(o[3] for o in out[:5]) == use_crypto


FRAMES = [{"type": "hr_sync", "from": "m0", "paths": [[1, 2**32 - 1], []], "active": 3,
           "hw": 5.0, "kv_usage": 1 << 20, "kv_pressure": 0.25, "sketch": b"\x00\xff" * 40},
          {"type": "onion_create", "blob": bytes(range(256)) * 3},
          {"type": "onion_create_fast", "path_id": b"\x01" * 16, "chain": ["u1", "u2", "u3"],
           "origin": "u0", "hop": 0},
          {"type": "proxy_ack", "path_id": "ab" * 8},
          {"type": "clove_fwd", "path_id": "cd" * 16, "dest_model": "m1",
           "clove": b"\x07" * 300, "msg_key": "0011223344556677", "dir": "out"},
          {"type": "prompt_clove", "clove": b"", "msg_key": None, "proxy": "u9"},
          {"type": "response_clove", "path_id": "ef" * 16, "clove": b"\x01" * 70000,
           "msg_id": "u0:3", "sig": "ab" * 64},
          {"type": "fwd_request", "payload": b"\x93\x01\x02\x03", "kv_holder": "m0",
           "kv_depth": 3},
          {"type": "kv_fetch", "from": "m1", "fetch_id": 7, "chains": [b"\x02" * 16] * 3,
           "depth": 3},
          {"type": "kv_pages", "from": "m0", "fetch_id": 7, "ok": True, "seq": 0,
           "total": 2, "depth": 3, "data": b"\x05" * 65536},
          {"type": "bogus", "n": -(2**40), "f": -0.0, "_src": ["s", "u1"]}]


def test_message_frames_match_reference():
    def run(p):
        frames = [p.msg.encode(m) for m in FRAMES]
        stream = b"".join(frames)
        dec = p.msg.Decoder()
        got = []
        for i in range(0, len(stream), 4093):
            got.extend(dec.feed(stream[i:i + 4093]))
        return frames, got, [p.msg.validate(m) for m in FRAMES]
    frames, got, valid = assert_same(run)
    assert got == FRAMES
    assert valid == [True] * 10 + [False]


@pytest.mark.parametrize("msg", [{"type": "hr_sync", "from": "m0", "paths": [], "active": 0,
                                  "hw": 5, "kv_pressure": "high"},
                                 {"type": "fwd_request", "payload": b"", "kv_depth": 1.5},
                                 {"type": "kv_pages", "from": "m0", "fetch_id": 1, "ok": True,
                                  "data": "text"},
                                 {"type": "kv_fetch", "from": "m1", "chains": []},
                                 {"type": "hr_sync", "from": "m0", "paths": [], "active": 0,
                                  "hw": 5, "sketch": None},
                                 {"n": 1}],
                         ids=["bad_pressure", "bad_depth", "bad_data", "missing_field",
                              "none_optional", "no_type"])
def test_validate_matches_reference(msg):
    assert tmsg.validate(msg) == jmsg.validate(msg)


# ------------------------------------------------ reputation and committee
def _rep_run(p, cs, node="n"):
    tr = p.rep.ReputationTracker()
    scores = [tr.update(node, c) for c in cs]
    return scores, sorted(tr.trusted()), list(tr.nodes[node].history)


@given(st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=1, max_size=40))
@settings(max_examples=30, deadline=None)
def test_reputation_matches_reference(cs):
    r = {k: _rep_run(p, cs) for k, p in PKGS.items()}
    assert r["torch"] == r["jax"]
    assert all(0.0 <= s <= 1.0 for s in r["torch"][0])


def _mk_committee(p, n=4, spread=0.0, byzantine=None):
    def make_fn(i):
        def fn(pairs):
            base = sum(0.8 if sum(r) % 2 == 0 else 0.2 for _, r in pairs) / len(pairs)
            return float(base + spread * i)
        return fn
    return p.cons.VerificationCommittee(n, [make_fn(i) for i in range(n)],
                                        byzantine=byzantine)


def _collect(p, good=True, prompt=None, valid=True):
    def collect(leader_ix, challenges):
        return [p.cons.SignedResponse(c.model_node, prompt or c.prompt,
                                      (2, 2) if good else (1, 2), b"", valid)
                for c in challenges]
    return collect


def _epochs(com):
    return [(r.epoch, r.leader, r.committed, r.scores, r.reputations, r.aborted_reason)
            for r in com.log], com.commit_hash, sorted(com.untrusted())


def _scenario_commit(p):
    com = _mk_committee(p)
    com.agree_challenges([p.cons.Challenge("m0", (1, 2, 3)), p.cons.Challenge("m1", (4, 5, 6))])
    com.run_epoch(_collect(p))
    return _epochs(com)


def _scenario_mismatch(p):
    com = _mk_committee(p)
    com.agree_challenges([p.cons.Challenge("m0", (1, 2, 3))])
    com.run_epoch(_collect(p, prompt=(9, 9, 9)))
    return _epochs(com)


def _scenario_bad_signature(p):
    com = _mk_committee(p)
    com.agree_challenges([p.cons.Challenge("m0", (1, 2, 3))])
    com.run_epoch(_collect(p, valid=False))
    return _epochs(com)


def _scenario_byzantine_leader(p):
    com = _mk_committee(p)
    com.agree_challenges([p.cons.Challenge("m0", (1, 2, 3))])
    com.byzantine = {com.leader()}
    com.run_epoch(_collect(p))
    com.byzantine = set()
    com.agree_challenges([p.cons.Challenge("m0", (7, 8, 9))])
    com.run_epoch(_collect(p))
    return _epochs(com)


def _scenario_spread(p):
    com = _mk_committee(p, n=7, spread=0.02)
    for e in range(4):
        com.agree_challenges([p.cons.Challenge("m0", (e, 1)), p.cons.Challenge("m1", (e, 2))])
        com.run_epoch(_collect(p, good=e % 2 == 0))
    return _epochs(com)


def _scenario_dishonest(p):
    com = _mk_committee(p)
    for e in range(8):
        com.agree_challenges([p.cons.Challenge("good", (e, e, 2 * e)),
                              p.cons.Challenge("bad", (e, e, 2 * e + 1))])

        def collect(leader_ix, challenges):
            return [p.cons.SignedResponse(c.model_node, c.prompt,
                                          (2, 2) if c.model_node == "good" else (1, 2),
                                          b"", True) for c in challenges]
        com.run_epoch(collect)
    return _epochs(com)


def _scenario_reputation(p):
    """test_reputation_consensus.py's reputation dynamics."""
    out = [_rep_run(p, [0.8] * 20, "good"), _rep_run(p, [0.15] * 6, "bad"),
           _rep_run(p, [0.2] * 6, "x"), _rep_run(p, [0.1] * 6 + [0.9], "n")]
    return out


COMMITTEE = {"commit": _scenario_commit, "prompt_mismatch": _scenario_mismatch,
             "bad_signature": _scenario_bad_signature,
             "byzantine_leader": _scenario_byzantine_leader, "vote_spread": _scenario_spread,
             "dishonest_model": _scenario_dishonest, "reputation": _scenario_reputation}


@pytest.mark.parametrize("name", list(COMMITTEE))
def test_committee_scenario_matches_reference(name):
    out = assert_same(COMMITTEE[name])
    if name == "commit":
        assert out[0][0][2] and all(v > 0.5 for v in out[0][0][4].values())
    elif name in ("prompt_mismatch", "bad_signature"):
        assert not out[0][0][2]
        assert ("mismatch" if name == "prompt_mismatch" else "signature") in out[0][0][5]
    elif name == "byzantine_leader":
        assert not out[0][0][2] and out[0][1][2]
    elif name == "dishonest_model":
        assert out[2] == ["bad"]
    elif name == "reputation":
        good, bad, pun, rec = out
        assert good[0][-1] > 0.75 and bad[0][-1] < 0.4
        assert rec[0][-1] < 0.75 and rec[0][-1] >= rec[0][-2]


def test_unique_challenge_prompts_enforced():
    com = _mk_committee(PKGS["torch"])
    with pytest.raises(AssertionError):
        com.agree_challenges([tcons.Challenge("m0", (1, 2)), tcons.Challenge("m1", (1, 2))])


@given(st.integers(min_value=4, max_value=10), st.data())
@settings(max_examples=15, deadline=None)
def test_consensus_safety_matches_reference(n, data):
    """test_registry_properties.py::test_consensus_safety_under_f_byzantine
    on both packages: the same leaders, commits, scores and abort reasons."""
    f = (n - 1) // 3
    byz = set(data.draw(st.lists(st.integers(0, n - 1), max_size=f, unique=True)))

    def run(p):
        com = p.cons.VerificationCommittee(n, [lambda pairs: 0.7] * n, byzantine=byz)
        com.agree_challenges([p.cons.Challenge("m0", (1, 2, 3))])
        com.run_epoch(lambda ldr, ch: [p.cons.SignedResponse("m0", (1, 2, 3), (4, 5),
                                                             b"", True)])
        return _epochs(com)
    r = {k: run(p) for k, p in PKGS.items()}
    assert r["torch"] == r["jax"]
    (epoch, leader, committed, scores, _, _), = r["torch"][0]
    assert committed == (leader not in byz)
    if committed:
        assert abs(scores["m0"] - 0.7) < 1e-9


@given(st.integers(min_value=1, max_value=150), st.integers(min_value=1, max_value=4))
@settings(max_examples=15, deadline=None)
def test_model_groups_match_reference(n_models, n_regions):
    def run(p):
        reg = p.reg.Registry({}, use_crypto=False)
        for i in range(n_models):
            reg.register_model(p.reg.NodeRecord(f"m{i}", llm="llama", region=f"r{i % n_regions}"))
        return [[r.node_id for r in g] for g in reg.model_groups("llama")]
    r = {k: run(p) for k, p in PKGS.items()}
    assert r["torch"] == r["jax"]
    assert all(len(g) <= treg.MODEL_GROUP_MAX for g in r["torch"])
    assert sum(map(len, r["torch"])) == n_models


def test_minority_signatures_rejected():
    reg = _registry(PKGS["torch"], 4, 1, 0)
    sl = reg.user_list()
    assert sl.verify(reg.committee_pubs)
    sl.signatures = dict(list(sl.signatures.items())[:2])     # 2*3 <= 2*4
    assert not sl.verify(reg.committee_pubs)
    bad = treg.SignedList(reg.user_list().records[:-1], reg.user_list().signatures)
    assert not bad.verify(reg.committee_pubs)


@given(st.floats(min_value=0.0, max_value=0.3), st.integers(min_value=100, max_value=2000),
       st.integers(min_value=0, max_value=2**31))
@settings(max_examples=15, deadline=None)
def test_anonymity_metrics_match_reference(f, N, seed):
    def run(p):
        rng = random.Random(seed)
        return (p.anon.gentorrent_anonymity(N, f, 4, 3, rng),
                p.anon.onion_anonymity(N, f, 3, rng),
                p.anon.garlic_anonymity(N, f, 4, 3, rng),
                p.anon.confidentiality(N, f, 4, 3, 3, 5, rng),
                p.anon.confidentiality(N, f, 4, 3, 3, 5, rng, brute_force=True))
    r = {k: run(p) for k, p in PKGS.items()}
    assert r["torch"] == r["jax"]
    assert 0.0 <= r["torch"][0] <= 1.0 + 1e-9


# ------------------------------------------- test_transport_scheduler.py:16-78
def test_schema_validation():
    assert tmsg.validate({"type": "hr_sync", "from": "m0", "paths": [], "active": 0, "hw": 5})
    assert not tmsg.validate({"type": "hr_sync", "from": "m0"})
    assert not tmsg.validate({"type": "bogus"})


def test_framing_roundtrip_incremental():
    msgs = [{"type": "proxy_ack", "path_id": "ab", "n": i} for i in range(5)]
    stream = b"".join(tmsg.encode(m) for m in msgs)
    dec = tmsg.Decoder()
    got = []
    for i in range(0, len(stream), 7):
        got.extend(dec.feed(stream[i:i + 7]))
    assert got == msgs


class Echo:
    def __init__(self):
        self.got = []

    def on_message(self, net, src, msg):
        self.got.append((src, msg.get("n")))
        if msg.get("reply_to"):
            net.send("echo", msg["reply_to"], {"type": "proxy_ack", "path_id": "00",
                                               "n": msg["n"] + 100})


def test_tcp_roundtrip():
    net = TcpNet()
    a, b = Echo(), Echo()
    net.add_node("a", a)
    net.add_node("echo", b)
    for i in range(3):
        net.send("a", "echo", {"type": "proxy_ack", "path_id": "00", "n": i,
                               "reply_to": "a"}, 64)
    deadline = time.time() + 5
    while time.time() < deadline and len(a.got) < 3:
        time.sleep(0.02)
    net.close()
    assert sorted(n for _, n in b.got) == [0, 1, 2]
    assert sorted(n for _, n in a.got) == [100, 101, 102]
    assert all(src == "echo" for src, _ in a.got) and all(src == "a" for src, _ in b.got)


def test_tcp_send_to_dead_node_drops():
    net = TcpNet()
    net.add_node("a", Echo())
    net.send("a", "ghost", {"type": "proxy_ack", "path_id": "00"})
    assert net.dropped == 1
    net.close()


# ------------------------------------------------------------ churn
class _Node:
    def on_message(self, net, src, msg):
        pass


@pytest.mark.parametrize("seed,rate", [(2, 10.0), (7, 60.0), (1, 0.0)])
def test_churn_schedule_matches_reference(seed, rate):
    def run(p):
        net = p.simnet.SimNet(seed=seed)
        pool = [f"u{i}" for i in range(30)]
        for nid in pool:
            net.add_node(nid, _Node())
        log = []
        churn = p.simnet.ChurnProcess(net, pool[5:], rate_per_min=rate, seed=seed,
                                      on_leave=lambda n: log.append(("leave", n, net.t)),
                                      on_join=lambda n: log.append(("join", n, net.t)))
        churn.start()
        net.run_until(600.0)
        return log, sorted(net.nodes), sorted(churn.offline)
    log, alive, offline = assert_same(run)
    assert (len(log) > 0) == (rate > 0)
    assert set(alive).isdisjoint(offline) and len(alive) + len(offline) == 30

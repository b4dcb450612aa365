"""Port parity on the CPU for serving-quality verification (§3.4,
Algorithm 3): ``LM.apply`` against ``repro.models.lm.LM.apply`` for the
three registered configs, and the port's log-prob verifier
(``repro_torch.core.verification``) against ``repro/core/verification.py``
on the same weights (carried across by ``params.from_jax_params``):

* the random verifier of ``test_verification_batch.py`` (vocab 128,
  ``PRNGKey(0)``): log-probs, credibilities, batched and per pair, with
  the empty-prompt and empty-response edge cases;
* the trained GT model of ``test_verification_model.py`` (60 steps, trained
  once in JAX for the module): the credibilities of the GT's, a random
  impostor's and a quantized impostor's greedy responses;
* ``examples/dishonest_detection.py``'s committee over that model: every
  epoch's reputations and the untrusted set."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.gt_model import _quantize  # noqa: E402
from repro.configs import base  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import verification as jver  # noqa: E402
from repro.core.reputation import ReputationConfig as JRepCfg  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import verification as tver  # noqa: E402
from repro_torch.core.reputation import ReputationConfig as TRepCfg  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from test_verification_model import (_greedy, _quantize_params,  # noqa: E402,F401
                                     trained)

NAME = "gentorrent-llama3-8b"
LOGITS_TOL = dict(atol=2e-4, rtol=2e-4)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(jcfg, tcfg, key=0, jparams=None):
    """Both packages' verifiers over one set of weights."""
    jm = build_model(jcfg)
    if jparams is None:
        jparams = jm.init(jax.random.PRNGKey(key))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jver.VerifierModel(jcfg, jm, jparams),
            tver.VerifierModel(tcfg, LM(tcfg, device="cpu"), tparams))


# ------------------------------------------------------------- LM.apply
@pytest.mark.parametrize("name", [NAME, "jamba-v0.1-52b", "xlstm-1.3b"])
def test_apply_matches_reference(name):
    """Full-sequence logits at every position, two rows, float32."""
    jcfg, tcfg = base.get_config(name).reduced(), configs.get_config(name).reduced()
    jv, tv = _pair(jcfg, tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, size=(2, 37)).astype(np.int32)
    want = np.asarray(jv.model.apply(jv.params, jnp.asarray(toks)))
    got = tv.model.apply(tv.params, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


def test_apply_last_position_equals_prefill():
    """``apply``'s last position is ``prefill``'s logits (the port's own
    two full-sequence paths agree)."""
    cfg = configs.get_config(NAME).reduced()
    _, tv = _pair(base.get_config(NAME).reduced(), cfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(3, 20)).astype(np.int32))
    last, _ = tv.model.prefill(tv.params, toks)
    torch.testing.assert_close(tv.model.apply(tv.params, toks)[:, -1], last)


# ------------------------------------- test_verification_batch.py's verifier
@pytest.fixture(scope="module")
def verifiers():
    return _pair(dataclasses.replace(base.get_config(NAME).reduced(), vocab=128),
                 dataclasses.replace(configs.get_config(NAME).reduced(), vocab=128))


def _pairs():
    """test_verification_batch.py's four pairs, then an empty prompt (its
    first response token is read at position -1: numpy wraps it to the
    last position), an empty response, and both empty prompt and a
    one-token response."""
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 128, size=8 + i).tolist(),
              rng.integers(0, 128, size=5 + 2 * i).tolist()) for i in range(4)]
    return pairs + [([], [3, 9, 27]), ([1, 2, 3], []), ([], [5])]


@pytest.mark.parametrize("i", [0, 1, 2, 3, 4, 6])
def test_response_logprobs_match_reference(verifiers, i):
    jv, tv = verifiers
    p, r = _pairs()[i]
    want = jver.response_logprobs(jv, p, r)
    got = tver.response_logprobs(tv, p, r)
    assert got.dtype == want.dtype and got.shape == (len(r),)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got >= np.log(tver.EPS_PROB)).all()


def test_response_logprobs_of_an_empty_response(verifiers):
    """The reference indexes with ``np.asarray([])``, a float array, and
    raises; the port reads nothing.  Neither ``credibility`` nor
    ``credibility_batch`` gets there: both score an empty response 0.0."""
    jv, tv = verifiers
    with pytest.raises(IndexError):
        jver.response_logprobs(jv, [1, 2, 3], [])
    assert tver.response_logprobs(tv, [1, 2, 3], []).shape == (0,)


def test_credibility_matches_reference(verifiers):
    jv, tv = verifiers
    pairs = _pairs()
    want = [jver.credibility(jv, p, r) for p, r in pairs]
    got = [tver.credibility(tv, p, r) for p, r in pairs]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[5] == 0.0 and all(0.0 < c <= 1.0 for i, c in enumerate(got) if i != 5)
    np.testing.assert_allclose(tver.avg_credibility(tv, pairs),
                               jver.avg_credibility(jv, pairs), **TOL)
    assert tver.avg_credibility(tv, []) == 0.0 == jver.avg_credibility(jv, [])


def test_credibility_batch_matches_reference(verifiers):
    """One padded forward: equal to the reference's batch; the rows with
    a prompt also equal their per-pair score (the reference test's
    tolerance).  An empty prompt reads the padded row's last position in
    both packages, so it differs from its own per-pair score."""
    jv, tv = verifiers
    pairs = _pairs()
    got = tver.credibility_batch(tv, pairs)
    np.testing.assert_allclose(got, jver.credibility_batch(jv, pairs), **TOL)
    singles = [tver.credibility(tv, p, r) for p, r in pairs]
    with_prompt = [i for i, (p, _) in enumerate(pairs) if p]
    np.testing.assert_allclose([got[i] for i in with_prompt],
                               [singles[i] for i in with_prompt], rtol=2e-3, atol=1e-4)
    assert tver.credibility_batch(tv, []) == [] == jver.credibility_batch(jv, [])
    assert tver.credibility_batch(tv, [([1, 2], [])]) == [0.0]


# ------------------------------------- test_verification_model.py's GT model
@pytest.fixture(scope="module")
def gt(trained):
    """test_verification_model.py's trained GT model (its ``trained``
    fixture, once for this module: the reduced llama at vocab 256, 60
    AdamW steps on the Markov corpus) in both packages' verifiers."""
    cfg, _, params, corpus, loss = trained
    tcfg = dataclasses.replace(configs.get_config(NAME).reduced(), vocab=256)
    jv, tv = _pair(cfg, tcfg, jparams=params)
    return jv, tv, corpus, loss


def test_gt_scores_higher_than_impostors(gt):
    """test_verification_model.py's scenario: six prompts, each answered
    by the GT, a random impostor and a brutally quantized one; both
    packages score every response the same, and the GT scores higher."""
    jv, tv, corpus, loss = gt
    assert loss < 5.0
    models = {"gt": jv.params,
              "rand": jv.model.init(jax.random.PRNGKey(9)),
              "quant": _quantize_params(jv.params, levels=3)}
    scores = {k: [] for k in models}
    rng = np.random.default_rng(0)
    for _ in range(6):
        prompt = corpus.sample(1, 16, rng)[0, :16].tolist()
        for k, params in models.items():
            resp = _greedy(jv.model, params, prompt)
            want = jver.credibility(jv, prompt, resp)
            got = tver.credibility(tv, prompt, resp)
            np.testing.assert_allclose(got, want, **TOL)
            scores[k].append(got)
    assert np.mean(scores["gt"]) > np.mean(scores["rand"]), scores
    assert np.mean(scores["gt"]) > np.mean(scores["quant"]), scores


# ------------------------------------ examples/dishonest_detection.py
def test_dishonest_detection_committee_matches_reference(gt):
    """The example's committee (4 members, gamma 1/5, 8 epochs, 16-token
    challenges, 12-token greedy responses) over the trained GT model; the
    cheating node runs the harsh impostor "m3" of ``benchmarks/gt_model.py``.
    Each package's committee scores with its own verifier: every epoch's
    leader, scores and reputations agree, and the cheater is untrusted,
    its reputation below the honest node's.  (The 60-step model is less
    trained than the example's, so the honest node's credibility, and in
    the end its reputation, is low too: both packages mark it untrusted.)"""
    jv, tv, corpus, _ = gt
    node_params = {"honest-node": jv.params,
                   "cheating-node": _quantize(jv.params, levels=1, noise=0.08)}
    rng = np.random.default_rng(0)
    epochs = []
    for _ in range(8):
        prompts = {n: tuple(corpus.sample(1, 16, rng)[0, :16].tolist()) for n in node_params}
        epochs.append({n: (p, tuple(_greedy(jv.model, node_params[n], list(p), 12)))
                       for n, p in prompts.items()})
    logs = {}
    for pkg, cons, cred, v, rep in (("jax", jcons, jver.credibility, jv, JRepCfg),
                                    ("torch", tcons, tver.credibility, tv, TRepCfg)):
        def score_fn(pairs, cred=cred, v=v):
            return float(np.mean([cred(v, p, r) for p, r in pairs]))
        com = cons.VerificationCommittee(4, [score_fn] * 4, rep_cfg=rep(gamma=1 / 5))
        log = []
        for ep in epochs:
            com.agree_challenges([cons.Challenge(n, p) for n, (p, _) in ep.items()])
            res = com.run_epoch(lambda _l, ch, ep=ep, cons=cons: [
                cons.SignedResponse(c.model_node, c.prompt, ep[c.model_node][1], b"", True)
                for c in ch])
            log.append((res.epoch, res.leader, res.committed, res.scores, res.reputations))
        logs[pkg] = (log, com.untrusted())
    (jlog, juntrusted), (tlog, tuntrusted) = logs["jax"], logs["torch"]
    assert tuntrusted == juntrusted and "cheating-node" in tuntrusted
    final = tlog[-1][4]
    assert final["honest-node"] > final["cheating-node"], final
    for (je, jl, jc, js, jr), (te, tl, tc, ts, tr) in zip(jlog, tlog):
        assert (te, tl, tc) == (je, jl, jc) and tc
        assert ts.keys() == js.keys() and tr.keys() == jr.keys()
        np.testing.assert_allclose([ts[k] for k in js], list(js.values()), atol=1e-6, rtol=0)
        np.testing.assert_allclose([tr[k] for k in jr], list(jr.values()), atol=1e-6, rtol=0)

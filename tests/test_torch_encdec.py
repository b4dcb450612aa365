"""Port parity on the CPU for the encoder and cross-attention families:
``whisper-base`` (encoder over stub frames, learned positions, LayerNorm,
GELU) and ``llama-3.2-vision-11b`` (image embeddings as cross-attention
memory), reduced.  ``LM.apply``, ``LM.prefill(aux)`` then ``LM.decode``,
and ``encode`` of ``repro_torch.models.lm`` against ``repro.models.lm`` on
the same weights (``from_jax_params``) and the same ``aux``, made from
numpy as ``tests/test_models_smoke.py`` makes it; logits within 2e-4
(float32, different summation orders).  Also the sinusoidal positions,
the weight trees and the cross-attention cache layout."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common, lm  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
NAMES = ["whisper-base", "llama-3.2-vision-11b"]
B, S = 2, 24


class Models:
    """Both packages' LMs of one config, the reference's weights on both,
    and one batch of tokens with its ``aux``."""

    def __init__(self, name):
        self.jcfg = base.get_config(name).reduced()
        self.tcfg = configs.get_config(name).reduced()
        self.jm = jlm.LM(self.jcfg)
        self.jparams = self.jm.init(jax.random.PRNGKey(0))
        self.tm = lm.LM(self.tcfg, device="cpu")
        self.tparams = from_jax_params(jax.tree.map(np.asarray, self.jparams),
                                       device="cpu")
        rng = np.random.default_rng(3)
        d = self.tcfg.d_model
        self.tokens = rng.integers(0, self.tcfg.vocab, size=(B, S)).astype(np.int32)
        self.aux = {}
        if self.tcfg.is_encdec:            # stub conv frontend: S // 2 frames
            self.aux["frames"] = rng.normal(size=(B, S // 2, d)).astype(np.float32)
        if self.tcfg.n_image_tokens:
            self.aux["image_embeds"] = rng.normal(
                size=(B, self.tcfg.n_image_tokens, d)).astype(np.float32)

    def jaux(self):
        return {k: jnp.asarray(v) for k, v in self.aux.items()}

    def taux(self):
        return {k: torch.from_numpy(v) for k, v in self.aux.items()}


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    return Models(request.param)


def _close(got, want, live=slice(None)):
    np.testing.assert_allclose(np.asarray(got)[live], np.asarray(want)[live], **TOL)


def test_apply_matches_reference(models):
    m = models
    want = m.jm.apply(m.jparams, jnp.asarray(m.tokens), aux=m.jaux(), block_q=8)
    got = m.tm.apply(m.tparams, torch.from_numpy(m.tokens), aux=m.taux())
    assert got.shape == (B, S, m.tcfg.padded_vocab)
    _close(got.numpy(), want)


def test_prefill_and_decode_match_reference(models):
    """``test_models_smoke.py``'s scenario on both packages: prefill of
    S - 2 tokens with ``aux``, then two decode steps that read the memory
    from the cache; every step's logits within 2e-4."""
    m = models
    jl, jc = m.jm.prefill(m.jparams, jnp.asarray(m.tokens[:, :S - 2]),
                          aux=m.jaux(), max_len=S + 4, block_q=8)
    tl, tc = m.tm.prefill(m.tparams, torch.from_numpy(m.tokens[:, :S - 2]),
                          aux=m.taux(), max_len=S + 4)
    _close(tl.numpy(), jl)
    for t in range(S - 2, S):
        jl, jc = m.jm.decode(m.jparams, jc, jnp.asarray(m.tokens[:, t:t + 1]),
                             jnp.full((B,), t, jnp.int32))
        tl, tc = m.tm.decode(m.tparams, tc, torch.from_numpy(m.tokens[:, t:t + 1]),
                             torch.full((B,), t, dtype=torch.int32))
        _close(tl.numpy(), jl)
    # the caches: self-attention K/V, and the memory's K/V unchanged by decoding
    for tpos, jpos in zip(tc, jc):
        for n in ("k", "v"):
            _close(tpos[n].numpy(), jpos[n])


def test_decode_with_a_dead_row_matches_reference_on_the_live_row(models):
    m = models
    _, jc = m.jm.prefill(m.jparams, jnp.asarray(m.tokens[:, :8]), aux=m.jaux(),
                         max_len=16, block_q=8)
    _, tc = m.tm.prefill(m.tparams, torch.from_numpy(m.tokens[:, :8]),
                         aux=m.taux(), max_len=16)
    active = np.array([True, False])
    jl, _ = m.jm.decode(m.jparams, jc, jnp.asarray(m.tokens[:, 8:9]),
                        jnp.full((B,), 8, jnp.int32), active=jnp.asarray(active))
    tl, _ = m.tm.decode(m.tparams, tc, torch.from_numpy(m.tokens[:, 8:9]),
                        torch.full((B,), 8, dtype=torch.int32),
                        active=torch.from_numpy(active))
    _close(tl.numpy(), jl, active)


def test_apply_ends_where_prefill_does(models):
    """The last position of ``apply`` is ``prefill``'s logits, on the port
    alone (the two entry points share the layers)."""
    m = models
    toks = torch.from_numpy(m.tokens)
    last, _ = m.tm.prefill(m.tparams, toks, aux=m.taux())
    torch.testing.assert_close(m.tm.apply(m.tparams, toks, aux=m.taux())[:, -1], last)


def test_encode_matches_reference():
    m = Models("whisper-base")
    frames = m.aux["frames"]
    want = jlm.encode(m.jcfg, m.jparams["encoder"], jnp.asarray(frames), block_q=8)
    got = m.tm.encode(m.tparams, torch.from_numpy(frames))
    assert got.shape == frames.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("n,d", [(12, 64), (1500, 512), (7, 6)])
def test_sinusoidal_positions_match_reference(n, d):
    want = jcommon.sinusoidal_positions(n, d)
    got = common.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_learned_positions_clamp_at_the_table():
    """``_embed`` adds ``pos_embed`` rows for whisper (rope_theta 0), the
    position clamped to the table's last row, as the reference does."""
    m = Models("whisper-base")
    tok = np.array([[3, 4, 4]], np.int32)
    pos = np.array([[0, 65_535, 70_000]], np.int32)
    want = m.jm._embed(m.jparams, jnp.asarray(tok), jnp.asarray(pos))
    got = m.tm._embed(m.tparams, torch.from_numpy(tok), torch.from_numpy(pos))
    _close(got.numpy(), want)
    assert torch.equal(got[0, 1], got[0, 2])              # the same row


def test_from_jax_params_keeps_encoder_and_positions(models):
    m = models
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, m.jparams))
    tl, tdef = jax.tree.flatten(m.tparams)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())
    if m.tcfg.is_encdec:
        layers = m.tparams["encoder"]["layers"]
        assert layers["mixer"]["wq"].shape[0] == m.tcfg.n_enc_layers
        assert set(layers) == {"norm1", "mixer", "norm2", "ffn"}
        assert set(layers["norm1"]) == {"scale", "bias"}          # LayerNorm
    if m.tcfg.rope_theta <= 0:
        assert m.tparams["pos_embed"].shape == (lm.MAX_LEARNED_POS, m.tcfg.d_model)
    else:
        assert "pos_embed" not in m.tparams and "encoder" not in m.tparams


def test_init_params_matches_reference_layout(models):
    m = models
    got = init_params(m.tcfg, torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(m.jparams)
    tl, tdef = jax.tree.flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert b.dtype == torch.float32
    if m.tcfg.is_encdec:
        enc = got["encoder"]["layers"]
        assert torch.equal(enc["norm1"]["bias"], torch.zeros_like(enc["norm1"]["bias"]))
        std = enc["ffn"]["w_in"].std().item()
        assert abs(std * np.sqrt(m.tcfg.d_model) - 0.88) < 0.1   # trunc-normal(±2)
        assert abs(got["pos_embed"].std().item() - 0.02) < 0.002


def test_cache_zeros_matches_reference_layout(models):
    m = models
    T = 16 if m.tcfg.n_image_tokens else 10
    got, want = m.tm.cache_zeros(3, 40, T_mem=T), m.jm.cache_zeros(3, 40, T_mem=T)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for n in g:
            assert tuple(g[n].shape) == w[n].shape and not g[n].any()

"""Port parity on the CPU for the MoE FFN: ``repro_torch.models.moe.moe_ffn``
against ``repro/models/moe.py`` on the same weights and tokens, lossless
(the reduced config's capacity) and lossy (capacity drops)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

NAME = "jamba-v0.1-52b"


def _overflow(x, router, cfg, cf):
    """Whether some expert of some dispatch group gets more (token, k)
    slots than its capacity, i.e. whether slots are dropped."""
    m = cfg.moe
    B, S, d = x.shape
    G = np.gcd(16, B)
    Tg = B * S // G
    C = max(1, int(np.ceil(Tg * m.top_k / m.num_experts * cf)))
    top = np.argsort(-(x.reshape(G, Tg, d) @ router), axis=-1)[..., :m.top_k]
    return any(np.bincount(top[g].ravel(), minlength=m.num_experts).max() > C
               for g in range(G))


# (batch, seq, capacity factor, shared experts): the reduced capacity
# (2.0, lossless) at a prefill and at a slot-pool decode shape; the
# published 1.25 at the engine's 8-token boot prefill (drops, as at full
# width); 1.0 with many tokens (drops); and one shared expert
# (Moonlight-style configs)
CASES = {"lossless": (2, 16, None, 0), "decode": (4, 1, None, 0),
         "boot": (1, 8, 1.25, 0), "lossy": (2, 48, 1.0, 0),
         "shared": (2, 16, None, 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case):
    B, S, cf, shared = CASES[case]
    jcfg, tcfg = (c.reduced() for c in (base.get_config(NAME),
                                        configs.get_config(NAME)))
    if shared:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_shared=shared))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, num_shared=shared))
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(5))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(6).normal(size=(B, S, 64)).astype(np.float32)
    want = np.asarray(jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), capacity_factor=cf))
    got = moe.moe_ffn(tcfg, tp, torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    lossy = _overflow(x, np.asarray(jp["router"]), jcfg,
                      cf if cf is not None else jcfg.moe.capacity_factor)
    assert lossy == (case in ("boot", "lossy"))

"""Assemble a whole GenTorrent overlay on a simulated network.

build_overlay() wires: a verification committee (registry + consensus), a
population of user nodes (each also a relay), and a group of model nodes
with engines — then establishes proxies and starts state-sync timers.
This is the entry point used by examples/ and benchmarks/.  Own copy of
``repro/overlay/network.py``: model nodes get the port's ``LatencyEngine``
(attach a port ``RealEngine`` afterwards with ``m.real_engine = eng``),
and their HR-trees hash on ``device`` (the chunk-hash kernel on the card,
its plain version on the CPU).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch import require_device
from repro_torch.core import ed25519
from repro_torch.core.consensus import VerificationCommittee
from repro_torch.core.forwarding import ForwardingConfig
from repro_torch.core.reputation import ReputationConfig
from repro_torch.net.simnet import SimNet
from repro_torch.overlay.model_node import ModelNode
from repro_torch.overlay.registry import NodeRecord, Registry
from repro_torch.overlay.user_node import UserNode
from repro_torch.overlay.verification_node import VerificationNode
from repro_torch.serving.engine import LatencyEngine, LatencyEngineConfig


@dataclass
class OverlayConfig:
    n_users: int = 40
    n_models: int = 4
    n_verifiers: int = 4
    n_proxies: int = 4
    sida_n: int = 4
    sida_k: int = 3
    latency_s: float = 0.1           # paper: 100 ms per packet
    chunk_lengths: tuple = (64,)
    sync_every: float = 5.0
    use_crypto: bool = False         # pure-python crypto is O(ms)/op;
                                     # enable for the security tests
    cache_bytes: int = 1 << 28       # per-node KV cache budget: the
                                     # HR-tree's aggregate-capacity win
                                     # appears when the working set
                                     # exceeds one node's budget
    fwd_cfg: ForwardingConfig = field(default_factory=ForwardingConfig)
    rep_cfg: ReputationConfig = field(default_factory=ReputationConfig)
    engine_cfg: Callable = LatencyEngineConfig
    hw_scores: Optional[list] = None
    seed: int = 0


@dataclass
class Overlay:
    net: SimNet
    users: list
    models: list
    verifiers: list
    registry: Registry
    committee: Optional[VerificationCommittee]
    cfg: OverlayConfig

    def user(self, i) -> UserNode:
        return self.users[i]

    def warmup(self, t: float = 5.0):
        self.net.run_until(self.net.t + t)


def build_overlay(cfg: OverlayConfig, score_fns: Optional[list] = None,
                  model_behaviours: Optional[dict] = None,
                  device="cuda") -> Overlay:
    dev = require_device(device)
    rng = random.Random(cfg.seed)
    net = SimNet(default_latency=cfg.latency_s, seed=cfg.seed)

    # --- committee / registry ---
    vn_keys = {f"vn{i}": ed25519.SigningKey(bytes([7 + i]) * 32)
               for i in range(cfg.n_verifiers)}
    registry = Registry(vn_keys, use_crypto=cfg.use_crypto)

    # --- users (each also a relay) ---
    users = []
    for i in range(cfg.n_users):
        u = UserNode(f"u{i}", rng=random.Random(rng.random()),
                     n_proxies=cfg.n_proxies, sida_n=cfg.sida_n,
                     sida_k=cfg.sida_k, use_crypto=cfg.use_crypto)
        users.append(u)
        net.add_node(u.node_id, u)
        registry.register_user(NodeRecord(u.node_id, dh_pub=u.dh_pub))

    # --- model nodes ---
    models = []
    for i in range(cfg.n_models):
        hw = (cfg.hw_scores[i] if cfg.hw_scores else 5.0)
        beh = (model_behaviours or {}).get(f"m{i}", "honest")
        m = ModelNode(f"m{i}", llm="llm", hw_score=hw,
                      engine=LatencyEngine(cfg.engine_cfg(hw_score=hw),
                                           cache_bytes=cfg.cache_bytes),
                      fwd_cfg=cfg.fwd_cfg,
                      chunk_lengths=cfg.chunk_lengths,
                      sync_every=cfg.sync_every,
                      use_crypto=cfg.use_crypto, behaviour=beh, device=dev)
        models.append(m)
        net.add_node(m.node_id, m)
        registry.register_model(NodeRecord(m.node_id, hw_score=hw,
                                           llm="llm"))
    member_ids = [m.node_id for m in models]
    for m in models:
        m.join_group(member_ids)
        m.start(net)

    # --- verification nodes ---
    verifiers = []
    committee = None
    if score_fns is not None:
        assert len(score_fns) == cfg.n_verifiers
        for i in range(cfg.n_verifiers):
            v = VerificationNode(f"vn{i}", score_fns[i],
                                 rng=random.Random(1000 + i),
                                 use_crypto=cfg.use_crypto)
            verifiers.append(v)
            net.add_node(v.client.node_id, v)
        committee = VerificationCommittee(cfg.n_verifiers, score_fns,
                                          rep_cfg=cfg.rep_cfg)

    # --- bootstrap: lists + proxies ---
    ul = registry.user_list()
    ml = registry.model_list()
    pubs = registry.committee_pubs if cfg.use_crypto else None
    for u in users:
        u.load_lists(ul, ml, pubs)
        u.establish_proxies(net)
    for v in verifiers:
        v.client.load_lists(ul, ml, pubs)
        v.client.establish_proxies(net)
    net.run_until(5.0)  # let establishment + acks settle
    return Overlay(net, users, models, verifiers, registry, committee, cfg)

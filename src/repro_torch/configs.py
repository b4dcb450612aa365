"""Architecture configs for the port: the attention, MoE, Mamba and xLSTM
fields of ``repro/configs/base.py`` (``LayerSpec``, ``MoESpec``,
``MambaSpec``, ``XLSTMSpec``, ``ArchConfig``, ``reduced``), kept as an own
copy so the port never imports JAX.  The port has no ``use_kernels``: it
launches its kernels for every CUDA tensor and runs the plain versions for
every CPU tensor.

Encoder fields and the ``cross_attn`` mixer arrive with the slice that
ports that family; ``tests/test_torch_common.py`` holds every field here
equal to the reference config, full and reduced.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string (``"bfloat16"`` ...)."""
    return _DTYPES[name]


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating block pattern."""

    mixer: str = "attn"
    window: Optional[int] = None  # sliding-window size for local attention
    ffn: str = "dense"

    def __post_init__(self):
        if self.mixer not in MIXERS or self.ffn not in FFNS:
            raise NotImplementedError(
                f"{self.mixer}/{self.ffn} layers arrive with a later slice "
                "of the port (encoder and cross-attention)")


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25  # E/k => lossless (no token drops)


@dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128              # SSD chunk length


@dataclass(frozen=True)
class XLSTMSpec:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    d_head: Optional[int] = None  # default d_model // n_heads

    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None      # override 1/sqrt(d_head)
    double_norm: bool = False
    head_pad: int = 0             # zero query heads added per GQA group

    act: str = "silu"             # silu | gelu (tanh approximation)
    glu: bool = True
    norm: str = "rms"             # rms | ln
    tie_embeddings: bool = False
    embed_scale: bool = False

    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    xlstm: Optional[XLSTMSpec] = None

    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # storage dtype (serving casts to dtype)

    spec_enabled: bool = False    # speculative n-gram decode (serving policy)
    spec_k: int = 4

    source: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by pattern length {len(self.pattern)}")
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128; logits beyond ``vocab``
        are masked to -1e30."""
        return (self.vocab + 127) // 128 * 128

    @property
    def d_inner_mamba(self) -> int:
        return self.mamba.expand * self.d_model if self.mamba else 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family float32 config for CPU tests."""
        pattern = tuple(replace(s, window=8 if s.window is not None else None)
                        for s in self.pattern)
        kw = {}
        if self.moe:      # lossless capacity: reproducible smoke tests
            kw["moe"] = MoESpec(num_experts=4, top_k=2, d_ff_expert=64,
                                num_shared=min(self.moe.num_shared, 1),
                                capacity_factor=2.0)
        if self.mamba:
            kw["mamba"] = MambaSpec(d_state=8, d_conv=4, expand=2, chunk=16)
        return replace(
            self, name=self.name + "-reduced", n_layers=len(self.pattern),
            d_model=64, n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            d_head=16, d_ff=128 if self.d_ff else 0, vocab=512,
            pattern=pattern, dtype="float32", param_dtype="float32", **kw)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# The paper's own testbed model: Meta-Llama-3-8B (GenTorrent §5.1).
register(ArchConfig(
    name="gentorrent-llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    pattern=(LayerSpec(mixer="attn"),),
    rope_theta=500_000.0,
    source="paper §5.1 testbed (Meta-Llama-3-8B)",
))


def _jamba_pos(i: int) -> LayerSpec:
    """Attention at position 4 of 8, Mamba elsewhere (1:7); MoE on odd
    positions, dense FFN on even ones."""
    return LayerSpec(mixer="attn" if i == 4 else "mamba",
                     ffn="moe" if i % 2 == 1 else "dense")


# Hybrid Mamba + attention with MoE (arXiv:2403.19887).
register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=tuple(_jamba_pos(i) for i in range(8)),
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=14336, num_shared=0),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2, chunk=128),
    rope_theta=10_000.0,
    source="arXiv:2403.19887; hf",
))


# xLSTM[7:1] (arXiv:2405.04517): a repeating 8-layer block of 7 mLSTM
# layers and one sLSTM layer at position 7, no separate FFN.
register(ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=tuple([LayerSpec(mixer="mlstm", ffn="none")] * 7
                  + [LayerSpec(mixer="slstm", ffn="none")]),
    xlstm=XLSTMSpec(proj_factor_mlstm=2.0, proj_factor_slstm=4.0 / 3.0,
                    conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
))

"""Architecture configs for the port: the fields of
``repro/configs/base.py`` (``LayerSpec``, ``MoESpec``, ``MambaSpec``,
``XLSTMSpec``, ``ArchConfig``, ``reduced``) and its eleven registered
configs, kept as an own copy so the port never imports JAX, with the
reference's dry-run helpers: the long-context policy
(``long_context_ok``, ``supports_long_context``), ``param_counts``,
``ShapeSpec`` and ``SHAPES``, ``cell_is_runnable``, ``input_specs`` (meta
tensors in place of ``jax.ShapeDtypeStruct``), ``cfg_enc_frames`` and
``ASSIGNED``.  The port has no ``use_kernels``: it launches its kernels for
every CUDA tensor and runs the plain versions for every other tensor.

``tests/test_torch_common.py`` holds every field here equal to the
reference config, full and reduced, for all eleven.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

MIXERS = ("attn", "cross_attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string (``"bfloat16"`` ...)."""
    return _DTYPES[name]


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating block pattern."""

    mixer: str = "attn"           # attn | cross_attn | mamba | mlstm | slstm
    window: Optional[int] = None  # sliding-window size for local attention
    ffn: str = "dense"            # dense | moe | none

    def __post_init__(self):
        if self.mixer not in MIXERS or self.ffn not in FFNS:
            raise ValueError(f"unknown layer {self.mixer}/{self.ffn}: mixers "
                             f"{MIXERS}, FFNs {FFNS}")


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

    is_encdec: bool = False       # whisper: an encoder over ``frames``
    n_enc_layers: int = 0
    n_image_tokens: int = 0       # vision: cross-attention memory length

    # long-context policy: None = derive (every mixer sub-quadratic); the
    # hybrid opts in (its few full-attention layers shard KV over 'data')
    long_context_ok: Optional[bool] = None

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
    def supports_long_context(self) -> bool:
        """True iff the decode state is sub-quadratic (no full-attention
        layer), or the config opts in (``long_context_ok``)."""
        if self.long_context_ok is not None:
            return self.long_context_ok
        return not any(s.mixer == "attn" and s.window is None
                       for s in self.pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # every registered config is (or contains) a decoder

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
            n_enc_layers=(min(self.n_enc_layers, len(self.pattern))
                          if self.is_encdec else 0),
            n_image_tokens=16 if self.n_image_tokens else 0,
            pattern=pattern, dtype="float32", param_dtype="float32", **kw)

    def param_counts(self) -> dict:
        """{"total", "active"} parameters (dense, embeddings, experts; an
        MoE layer's active ones are its top-k and shared experts), for
        MODEL_FLOPS."""
        d, dh = self.d_model, self.d_head
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = active = 0
        for spec in self.pattern:
            p = 0
            if spec.mixer in ("attn", "cross_attn"):
                p += d * nq * dh + 2 * d * nkv * dh + nq * dh * d
            elif spec.mixer == "mamba":
                di, ds = self.d_inner_mamba, self.mamba.d_state
                p += d * 2 * di + di * self.mamba.d_conv + di * 2 * ds
                p += di * ds + di + di * d  # dt/B/C proj + A + out
            elif spec.mixer == "mlstm":
                di = int(self.xlstm.proj_factor_mlstm * d)
                p += d * 2 * di + 2 * di * di + 2 * di + di * d
            elif spec.mixer == "slstm":
                hdim = d // self.n_heads
                p += 4 * d * d + 4 * self.n_heads * hdim * hdim
                p += 3 * d * int(self.xlstm.proj_factor_slstm * d)
            a = p
            if spec.ffn == "dense" and self.d_ff:
                ff = (3 if self.glu else 2) * d * self.d_ff
                p += ff
                a += ff
            elif spec.ffn == "moe":
                m = self.moe
                per_e = 3 * d * m.d_ff_expert
                p += (m.num_experts + m.num_shared) * per_e + d * m.num_experts
                a += (m.top_k + m.num_shared) * per_e + d * m.num_experts
            total += p
            active += a
        total = emb + self.n_repeats * total
        active = emb + self.n_repeats * active
        if self.is_encdec:
            enc = self.n_enc_layers * (d * nq * dh * 2 + 2 * d * nkv * dh
                                       + (3 if self.glu else 2) * d * self.d_ff)
            total += enc
            active += enc
        return {"total": total, "active": active}


# --------------------------------------------------------------------------
# Shapes: the dry-run's input-shape set
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell applies; the reason when it does not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention: 500k-token decode state is "
                       "O(seq) KV with O(seq) attention per token — skipped "
                       "per the brief (not sub-quadratic)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta tensors standing in for every model input of this cell.

    train:   tokens/labels (B, S) int32   [+ frames / image embeddings]
    prefill: tokens (B, S) int32          [+ aux]
    decode:  tokens (B, 1) int32, pos (B,) int32; the cache is part of the
             step and comes from ``LM.cache_specs``.
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if shape.kind == "train":
        specs = {"tokens": spec((B, S)), "labels": spec((B, S))}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, S))}
    else:
        specs = {"tokens": spec((B, 1)), "pos": spec((B,))}
    if shape.kind != "decode":   # decode reads the memory from its cache
        if cfg.is_encdec:        # the stub frontend's frame embeddings
            specs["frames"] = spec((B, S // 2, cfg.d_model), cfg.compute_dtype)
        if cfg.n_image_tokens:
            specs["image_embeds"] = spec((B, cfg.n_image_tokens, cfg.d_model),
                                         cfg.compute_dtype)
    return specs


def cfg_enc_frames(cfg: ArchConfig, seq_len: int) -> int:
    return seq_len // 2


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    return sorted(_REGISTRY)


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
    long_context_ok=True,   # hybrid: 4 attention layers' KV shards over 'data'
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


# Sliding-window attention (mistral-style, window 4096) on every layer.
register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32_000,
    pattern=(LayerSpec(mixer="attn", window=4096),),
    rope_theta=10_000.0,
    source="arXiv:2401.16818; hf",
))


# Alternating local (4096-window) and global attention, attention softcap
# 50, final softcap 30, GeGLU, tied embeddings scaled by sqrt(d_model),
# sandwich norms.
register(ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=14336,
    vocab=256_000,
    pattern=(LayerSpec(mixer="attn", window=4096, ffn="dense"),
             LayerSpec(mixer="attn", window=None, ffn="dense")),
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    embed_scale=True,
    double_norm=True,
    source="arXiv:2408.00118; hf",
))


# Llama-architecture GQA; 56 query heads zero-padded to 64 per KV group.
register(ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64_000,
    pattern=(LayerSpec(mixer="attn"),),
    rope_theta=5_000_000.0,
    head_pad=8,
    source="arXiv:2403.04652; hf",
))


# Llama-architecture code model with one KV head (MQA, G = 48).
register(ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    pattern=(LayerSpec(mixer="attn"),),
    rope_theta=10_000.0,
    source="arXiv:2405.04324; hf",
))


# MoE on every layer: 16 experts, top-4.
register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoESpec(num_experts=16, top_k=4, d_ff_expert=10752, num_shared=0),
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base; unverified",
))


# Fine-grained MoE: 64 experts, top-6, and 2 shared experts.
register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoESpec(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
))


# Four self-attention layers, then one cross-attention layer over 1600
# image-embedding tokens (the vision frontend is a stub: the embeddings
# come in as ``aux["image_embeds"]``).
register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    pattern=tuple([LayerSpec(mixer="attn")] * 4
                  + [LayerSpec(mixer="cross_attn")]),
    rope_theta=500_000.0,
    n_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
))


# Encoder-decoder: 6 encoder layers over the frames of a stub conv frontend
# (``aux["frames"]``); a decoder layer is a self-attention position without
# FFN and a cross-attention position with one.  LayerNorm, plain GELU FFN,
# learned positions (rope_theta 0).
register(ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    pattern=(LayerSpec(mixer="attn", ffn="none"),
             LayerSpec(mixer="cross_attn", ffn="dense")),
    is_encdec=True,
    n_enc_layers=6,
    act="gelu",
    glu=False,
    norm="ln",
    rope_theta=0.0,
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
))


ASSIGNED = [
    "xlstm-1.3b", "gemma2-9b", "yi-34b", "h2o-danube-1.8b", "granite-20b",
    "llama-3.2-vision-11b", "moonshot-v1-16b-a3b", "dbrx-132b",
    "jamba-v0.1-52b", "whisper-base",
]

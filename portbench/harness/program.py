"""The system under test, built from a configuration file: the port's
``ArchConfig`` from the file's ``port`` block, its ``LM``, a paged
``RealEngine`` and a ``Scheduler``.  This module and the loops are the only
parts of the benchmark that import ``repro_torch``.

The entry points read: ``Scheduler.submit / step / active / done``,
``Result.output / cached_tokens / prompt_tokens``, ``RealEngine``'s
``prefill_requests`` and its counters ``prefill_dispatches`` /
``prefill_tokens``, and ``LM.prefill_paged / decode_paged`` (wrapped on
the model instance before the engine is built, in a traced run only).
"""
from __future__ import annotations

import gc

import torch

from repro_torch import configs
from repro_torch.models.lm import LM
from repro_torch.serving.engine import Request, RealEngine
from repro_torch.serving.prefix_cache import BLOCK
from repro_torch.serving.scheduler import Scheduler

_SPECS = {"moe": configs.MoESpec, "mamba": configs.MambaSpec, "xlstm": configs.XLSTMSpec}


def arch_config(name: str, port: dict) -> configs.ArchConfig:
    """The port's config as the file states it."""
    kw = dict(port)
    kw["pattern"] = tuple(configs.LayerSpec(**s) for s in port["pattern"])
    for key, cls in _SPECS.items():
        if kw.get(key) is not None:
            kw[key] = cls(**kw[key])
    return configs.ArchConfig(name=name, **kw)


def page_bytes(cfg) -> int:
    """KV bytes of one page over every layer (the engine's ``page_bytes``)."""
    return (cfg.n_layers * 2 * BLOCK * cfg.n_kv_heads * cfg.d_head
            * cfg.compute_dtype.itemsize)


def engine(cfg, model, params, node: dict, num_pages: int, device) -> RealEngine:
    """A paged engine whose prefix cache may hold every page of the arena:
    page pressure, not the byte limit, evicts."""
    return RealEngine(cfg, model, params, cache_bytes=num_pages * page_bytes(cfg),
                      max_len=node["max_len"], paged=True, num_pages=num_pages,
                      device=device)


def scheduler(eng, node: dict) -> Scheduler:
    return Scheduler(eng, max_active=node["max_active"])


def request(req_id: int, tokens: list, max_new: int) -> Request:
    """A greedy request with EOS off (``eos_id`` -1 is never produced)."""
    return Request(req_id, tokens, max_new=max_new, eos_id=-1)


def warm_up(cfg, params, node: dict, device, vocab: int) -> int:
    """Every shape the window uses, on a small engine of the same
    ``max_len`` and ``max_active``: the admission grid (max_active, BLOCK)
    and the pool decode (max_active, 1).  The grid admits a full batch
    whose prompts end at distinct chunk steps, as the fill and the traffic
    do: an admission holds each row's last chunk's logits until its end.
    Returns the bytes the warm-up added at its peak, over the weights and
    its arena."""
    model = LM(cfg, device)
    n = node["max_active"]
    eng = engine(cfg, model, params, node, 1 + n * (n + 2), device)
    base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sched = scheduler(eng, node)
    g = torch.Generator().manual_seed(0)
    for i in range(n):
        toks = torch.randint(2, vocab, ((i + 1) * BLOCK - 3,), generator=g).tolist()
        sched.submit(request(-1 - i, toks, 3))
    while len(sched.done) < n:
        sched.step()
    extra = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        extra = torch.cuda.max_memory_allocated(device) - base
    del sched, eng
    gc.collect()             # the engine and its prefix cache hold each other
    return extra


def arena_pages(cfg, node: dict, device, act_bytes: int) -> int:
    """Pages for the memory left after the weights and the warm-up's peak,
    less the configuration's headroom."""
    if device.type != "cuda":
        return node.get("cpu_pages", 256)
    total = torch.cuda.get_device_properties(device).total_memory
    free = (total - torch.cuda.memory_allocated(device) - act_bytes
            - int(node["kv_headroom_gib"] * 2**30))
    return max(1 + node["max_active"], free // page_bytes(cfg))

"""Dry-run of one (arch x shape x mesh) cell on a fake process group: the
port's counterpart of the reference's HLO dry-run
(``repro/launch/dryrun.py``), which it replaces.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ARCH \\
        --shape {train_4k,prefill_32k,decode_32k,long_500k} [--multi-pod] \\
        [--out results/dryrun_torch] [--force]

The reference compiles the step for 256 (or 512) placeholder devices and
reads XLA's partitioned HLO.  Here the process joins a fake process group
of 256 (or 512) ranks as rank 0 (``dist.init_process_group("fake")``:
collectives return at once and move nothing), builds the production mesh
over it, and runs the cell's step once, on DTensors whose local shards are
meta tensors in the sharding rules' placements, under
``distributed.trace_analysis``: per-device flops, bytes (eager, unfused:
an upper bound) and collective bytes, with the H100 data-sheet roofline
(``distributed.collectives``).  Meta tensors are not CUDA tensors, so the
model runs its kernels' plain versions, as the reference lowers its jnp
path.  Train cells run ``make_sharded_train_step``; prefill and decode
cells the serving entry points with bf16 weights sharded on 'model' only.
Both compute each rank's shard over 'model' (``constraints.model_shards``;
``distributed/tensor_parallel.py``): its heads, ``d_ff``, experts and
vocab rows, a Mamba mixer's heads, an mLSTM's value columns and an
sLSTM's columns of every head, on its batch slice.  A serving rank
gathers no weight but a Mamba, mLSTM or sLSTM mixer's whose split dim does
not divide the extent, and reads its batch slice of the cache with its
KV heads, its Mamba heads' ``h`` and conv channels, its columns of the
mLSTM's ``C`` and conv channels and of the sLSTM's ``h``, ``c``, ``n`` and
``m`` (where KV heads are whole on 'model', it holds them all and writes
and reads those its query heads use; the mLSTM's ``n`` and ``m`` are
whole).  ``cache_shardings`` places the cache: it leaves the sLSTM's
``n`` whole (the rule for the mLSTM's ``n`` matches it first), so a
rank's columns of it are gathered into that placement after each step.

Per-device argument bytes are the local shards' bytes, exactly; temporary
bytes are the peak of live tensors the step made (``temp_peak_bytes``).
The fake group is process-global, so run one cell a process (the sweep,
``scripts/dryrun_sweep_torch.py``, does).  Records go to
``<out>/<mesh>/<arch>_<shape>.json`` with the reference's fields.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.distributed import (constraints, sharded_step, sharding,
                                     tensor_parallel, trace_analysis)
from repro_torch.distributed.collectives import CARD, roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import LM
from repro_torch.training.optimizer import AdamWConfig, tree_leaves


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size() for t in tree_leaves(tree))


def _cache_spec(cfg, model, shape):
    T_mem = 0
    if cfg.is_encdec:
        T_mem = shape.seq_len // 2
    elif cfg.n_image_tokens:
        T_mem = cfg.n_image_tokens
    return model.cache_specs(shape.global_batch, shape.seq_len, T_mem)


# a split mixer's cache leaf -> its dim that holds the rank's share
_MIXER_DIMS = {"mamba": {"h": 2, "conv": 3}, "mlstm": {"C": 4, "conv": 3},
               "slstm": {"h": 3, "c": 3, "n": 3, "m": 3}}


def _compute_dims(cfg, path, extent) -> tuple:
    """The dims of a cache leaf that a rank computes on: its batch slice
    (dim 1), an attention cache's KV heads (dim 3, as ``cache_shardings``
    places them), a split Mamba mixer's heads of ``h`` and conv channels,
    a split mLSTM's columns of ``C`` and conv channels, a split sLSTM's
    columns of ``h``, ``c``, ``n`` and ``m``; every other dim whole (the
    sequence, an mLSTM's n and m, a mixer's state that does not split)."""
    leaf = path[-1]
    if leaf in ("k", "v"):
        return (1, 3)
    mixer = cfg.pattern[path[0]].mixer
    if tensor_parallel.mixer_splits(cfg, mixer, extent) and leaf in _MIXER_DIMS.get(mixer, {}):
        return (1, _MIXER_DIMS[mixer][leaf])
    return (1,)


def _compute_spec(cfg, path, spec, extent) -> sharding.P:
    """A cache leaf's spec as a rank computes on it: ``spec`` on the dims
    of ``_compute_dims``, every other dim replicated, and a split mixer's
    share on 'model' (also where the rules leave it whole: the sLSTM's
    ``n``)."""
    dims = _compute_dims(cfg, path, extent)
    model = () if path[-1] in ("k", "v") else dims[1:]
    return sharding.P(*("model" if i in model else e if i in dims else None
                        for i, e in enumerate(spec)))


def build_step(cfg, shape, mesh):
    """(fn, args) of the cell's step on this rank: ``fn(*args)`` runs it.
    Train: ``make_sharded_train_step`` over params, AdamW state and batch
    in the rules' placements.  Prefill / decode: bf16 weights on 'model'
    only, the cache in ``cache_shardings``' placements; each rank computes
    its batch slice on its shards over 'model'."""
    specs = configs.input_specs(cfg, shape)
    batch = sharding.meta_shards(specs, sharding.input_shardings(cfg, specs, mesh))

    if shape.kind == "train":
        model = LM(cfg, device="meta")
        p_spec = model.param_specs()
        params = sharding.meta_shards(
            p_spec, sharding.param_shardings(cfg, p_spec, mesh, train=True))
        step = sharded_step.make_sharded_train_step(cfg, model, AdamWConfig(), mesh)
        return step, (params, sharded_step.init_state(params), batch)

    scfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    smodel = LM(scfg, device="meta")
    p_spec = smodel.param_specs()
    params = sharding.meta_shards(
        p_spec, sharding.param_shardings(scfg, p_spec, mesh, train=False))
    c_spec = _cache_spec(scfg, smodel, shape)
    c_sh = sharding.cache_shardings(scfg, c_spec, mesh, long_ctx=shape.name == "long_500k")
    dp_group = mesh.group(sharding.batch_axes(mesh, shape.global_batch))
    shards = sharded_step.model_shards_of(mesh, scfg)
    # placements of each cache leaf as a rank computes on it
    compute = sharding.tree_map_with_path(lambda path, s: sharding.placements(
        _compute_spec(scfg, path, s.spec, shards[2]), mesh), c_sh)

    def place(cache):
        """A rank's compute-placed cache -> DTensors in ``c_sh`` (no traffic
        but the sLSTM's ``n``, gathered)."""
        return sharding.zip_map(lambda t, sc: DTensor.from_local(
            t, mesh.device_mesh, sc[1], run_check=False).redistribute(
                mesh.device_mesh, sc[0].placements), cache,
            sharding.zip_map(lambda s, pl: (s, pl), c_sh, compute))

    def local(batch):
        return {k: v.to_local() for k, v in batch.items()}

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            b = local(batch)
            aux = {k: v for k, v in b.items() if k != "tokens"}
            with constraints.activation_mesh(mesh), constraints.batch_slices(dp_group), \
                    constraints.model_shards(*shards):
                logits, cache = smodel.prefill(sharded_step.compute_view(params), b["tokens"],
                                               aux=aux or None, max_len=shape.seq_len)
            return logits, place(cache)
        return prefill_fn, (params, batch)

    cache = sharding.meta_shards(c_spec, c_sh)

    def decode_fn(params, cache, batch):
        b = local(batch)
        mine = sharding.zip_map(lambda t, pl: t.redistribute(
            mesh.device_mesh, pl).to_local(), cache, compute)
        with constraints.activation_mesh(mesh), constraints.batch_slices(dp_group), \
                constraints.model_shards(*shards):
            logits, mine = smodel.decode(sharded_step.compute_view(params), mine,
                                         b["tokens"], b["pos"])
        return logits, place(mine)
    return decode_fn, (params, cache, batch)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False) -> dict:
    """Dry-run one cell (skipped where ``cell_is_runnable`` refuses it) and
    write its record; an existing record is returned unless ``force``.  A
    failing cell is a fault of the port's sharding: its record has
    ``status`` "error", the error and its traceback."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = Path(out_dir) / mesh_name / f"{arch}_{shape_name}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch}
    runnable, reason = configs.cell_is_runnable(cfg, shape)
    if not runnable:
        rec.update(status="skipped", reason=reason)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    from torch.testing._internal.distributed.fake_pg import FakeStore
    n_dev = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
    try:
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod)
        fn, args = build_step(cfg, shape, mesh)
        t_build = time.time() - t0
        ta = trace_analysis.analyze(fn, *args)
        t_trace = time.time() - t0 - t_build
        counts = cfg.param_counts()
        rec.update(
            status="ok", build_s=round(t_build, 2), trace_s=round(t_trace, 2),
            n_devices=int(mesh.size),
            memory_analysis={"argument_size_in_bytes": _local_bytes(args),
                             "temp_size_in_bytes": ta["temp_peak_bytes"]},
            trace_analysis=ta,
            roofline=dict(roofline_terms(ta["flops"], ta["bytes"], ta["coll_eff_bytes"]),
                          card=CARD),
            params_total=counts["total"], params_active=counts["active"])
    except Exception as e:  # a failing cell is a fault of the port's sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    finally:
        dist.destroy_process_group()
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    rec = run_cell(args.arch, args.shape, args.multi_pod, Path(args.out), args.force)
    brief = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "trace_s", "error")}
    if rec.get("status") == "ok":
        t = rec["trace_analysis"]
        print(json.dumps({**brief, "n_devices": rec["n_devices"],
                          "flops_per_dev": t["flops"], "bytes_per_dev": t["bytes"],
                          "coll_eff_bytes_per_dev": t["coll_eff_bytes"],
                          "mem": rec["memory_analysis"], "roofline": rec["roofline"]}))
    else:
        print(json.dumps(brief))
        if rec.get("status") == "error":
            print(rec.get("traceback", ""))
            raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Tiny cells for the CPU tests: a copy of the benchmark (``BENCHMARK.json``
and this folder) with two cells added from new files only, a dropless-MoE
and a dense configuration at width 64 in float32, under an open and a
closed loop, each reporting the metrics of the real cell it stands for.
The harness runs them on the CPU, where the port's kernels run their plain
versions.

Their limits are their own, set as the real cells' are, from readings at
this size (four seeds each, 0.5-s windows; the control on three, 1-s):
the program, in float32 here, reads 0 in every number; the float8 control
reads ``gap_mean`` 0.0050-0.0067 (dense) and 0.0096-0.0150 (MoE), and
``gap_max`` 0.148-0.253 (dense); of the planted faults the weakest, a
step that leaves the KV unchanged, reads ``gap_mean`` 0.0115-0.0225 and
``gap_max`` 0.379-0.939 (dense), ``gap_mean`` 0.080-0.138 (MoE).  The real
cells' limits would pass the tiny control, whose logits are small."""
from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 96,
        "vocab": 512, "rope_theta": 10000.0, "norm": "rms", "act": "silu", "glu": True,
        "dtype": "float32", "param_dtype": "float32"}
MOE = dict(PORT, family="moe", pattern=[{"mixer": "attn", "ffn": "moe"}],
           moe={"num_experts": 4, "top_k": 2, "d_ff_expert": 96, "num_shared": 0,
                "capacity_factor": 2.0})
DENSE = dict(PORT, family="dense", pattern=[{"mixer": "attn", "ffn": "dense"}], head_pad=2)
NODE = {"max_active": 4, "max_len": 256, "kv_headroom_gib": 0, "cpu_pages": 160}

OPEN = {"loop": "open", "shape_seed": 1,
        "arrivals": {"kind": "poisson", "rate_per_s": 60.0}, "lead_in_s": 0.2,
        "prefixes": {"count": 3, "length": {"dist": "uniform", "min": 24, "max": 48},
                     "zipf_a": 1.1, "prefill_in_setup": True},
        "suffix": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 40},
        "answer": {"dist": "uniform", "min": 6, "max": 16}, "max_total": 256}
CLOSED = {"loop": "closed", "shape_seed": 2,
          "arrivals": {"kind": "closed", "clients": 8},
          "prefixes": {"count": 8, "length": {"dist": "normal", "mean": 20, "std": 4, "min": 8},
                       "zipf_a": 0.8, "prefill_in_setup": False},
          "suffix": {"dist": "normal", "mean": 60, "std": 18, "min": 4},
          "answer": {"dist": "uniform", "min": 4, "max": 12},
          "first_wave": {"count": 4, "answer": "residual"}, "max_total": 256}

# the numbers each real cell compares, at limits set at this size; every
# finished or active request is checked
MOE_CHECK = {"sample_tokens": 10**6, "limits": {"gap_mean": 1e-3, "short_answers": 0}}
DENSE_CHECK = {"sample_tokens": 10**6,
               "limits": {"gap_max": 0.02, "gap_mean": 1e-3, "short_answers": 0}}

# cell -> (config name, its port block, mix name, its file, its limits, the real cell whose
# metrics it reports)
CELLS = {"tiny_moe_open": ("tiny-moe", MOE, "tiny_open", OPEN, MOE_CHECK, "dbrx_chat_open"),
         "tiny_dense_closed": ("tiny-dense", DENSE, "tiny_closed", CLOSED, DENSE_CHECK,
                               "yi34b_coding_backlog")}


def _write(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


@contextlib.contextmanager
def one_thread():
    """Tiny widths gain nothing from intra-op threads, and the test
    workers share the machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make(dest: Path) -> Path:
    """A benchmark root at ``dest`` holding the tiny cells.  Returns its
    folder of harness files (the copy of this one)."""
    dest = Path(dest)
    bench_dir = dest / "portbench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (conf, port, mix, mix_file, limits, real) in CELLS.items():
        _write(bench_dir / "configs" / f"{conf}.json",
               {"name": conf, "reference": "decoder", "reduced": [], "node": NODE, "port": port})
        _write(bench_dir / "traffic" / f"{mix}.json", mix_file)
        _write(bench_dir / "checks" / f"{cell}.json", limits)
        bench["configs"].append({"name": conf, "source": "tiny", "file":
                                 f"portbench/configs/{conf}.json", "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": conf, "traffic": mix, "chips": 1,
                                   "why": "test"})
        like = {w["name"] for w in bench["workloads"] if w["name"] == real}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and like & set(m["workloads"]):
                m["workloads"].append(cell)
    _write(dest / "BENCHMARK.json", bench)
    return bench_dir

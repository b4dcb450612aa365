"""Everything the harness runs is found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration, whose entry
of ``configs`` gives the file (``configs/<config>.json``, which names its
reference, ``reference/<name>.py``), and its traffic mix
(``traffic/<mix>.json``, which names its loop, ``loops/<loop>.py``).  Its
limits are ``checks/<cell>.json``.  Each metric is read by
``metrics/<metric>.py``.  A cell reports the end-to-end metrics and the
per-layer metrics whose ``workloads`` list it, or that have no such list.
A later cell, mix, configuration or metric is new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # the portbench directory


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the mix's file
    check: dict         # the cell's limits
    end_to_end: list    # BENCHMARK.json metric entries this cell reports
    per_layer: list
    bench_dir: Path


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=w["chips"],
                config=load_json(Path(root) / conf["file"]),
                traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                check=load_json(bench_dir / "checks" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
                bench_dir=bench_dir)


def load_module(path: Path, name: str):
    """A module from a file, whatever its name holds (metric names have
    dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: Path, name: str):
    mod = load_module(bench_dir / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def loop(bench_dir: Path, kind: str):
    return load_module(bench_dir / "loops" / f"{kind}.py", f"portbench_loop_{kind}")


def reference(bench_dir: Path, name: str):
    return load_module(bench_dir / "reference" / f"{name}.py", f"portbench_reference_{name}")

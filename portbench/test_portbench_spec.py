"""``BENCHMARK.json`` against the benchmark's contract, and the files the
harness finds by name; the import boundary of everything it runs (a run
also checks ``sys.modules`` itself, ``run.py``)."""
import ast
import json
import re

import pytest

from harness import spec

ROOT = spec.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def test_the_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_entry_is_well_formed():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                assert k not in e or 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_what_it_must():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert configs == {w["config"] for w in cells.values()}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name, w in cells.items():
        assert w["chips"] in (1, 4) and w["config"] in configs
        c = spec.cell(ROOT, name)
        ends = {m["name"] for m in c.end_to_end}
        assert "setup_s" in ends and len(ends) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in ends, (name, m["name"])
        # beside each kernel roofline, a share of the peak moving the same metric
        moved = {m["moves"] for m in c.per_layer if m["name"].split(".")[0].endswith("_roofline")}
        mfu = {m["moves"] for m in c.per_layer if "mfu" in re.split(r"[._]", m["name"])}
        assert moved <= mfu, (name, moved - mfu)
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(cells) and m["moves"] in e2e


def test_files_are_found_by_name():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.parent == spec.HERE / "configs" and path.stem == c["name"]
        conf = json.loads(path.read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert set(conf["reduced"]) == set(conf["published"])
        assert all(conf[k] != v for k, v in conf["published"].items())
        assert (spec.HERE / "reference" / f"{conf['reference']}.py").exists()
    for w in BENCH["workloads"]:
        mix = spec.load_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
        assert (spec.HERE / "loops" / f"{mix['loop']}.py").exists()
        limits = set(spec.load_json(spec.HERE / "checks" / f"{w['name']}.json")["limits"])
        assert "short_answers" in limits and limits & {"gap_max", "gap_mean"}
        assert limits <= {"gap_max", "gap_mean", "short_answers"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric_reader(spec.HERE, m["name"]))


def test_the_port_block_is_the_published_model():
    """Widths as published; only what ``reduced`` names differs."""
    dbrx = spec.load_json(spec.HERE / "configs" / "dbrx-132b-l8.json")
    p = dbrx["port"]
    assert (p["d_model"], p["n_heads"], p["n_kv_heads"], p["vocab"], p["n_layers"]) == \
        (dbrx["d_model"], dbrx["n_heads"], dbrx["attn_config"]["kv_n_heads"],
         dbrx["vocab_size"], dbrx["n_layers"])
    f = dbrx["ffn_config"]
    assert (p["moe"]["num_experts"], p["moe"]["top_k"], p["moe"]["d_ff_expert"]) == \
        (f["moe_num_experts"], f["moe_top_k"], f["ffn_hidden_size"])
    assert p["moe"]["capacity_factor"] == f["moe_num_experts"] / f["moe_top_k"]
    assert p["rope_theta"] == dbrx["attn_config"]["rope_theta"]
    yi = spec.load_json(spec.HERE / "configs" / "yi-34b-l30.json")
    p = yi["port"]
    assert (p["d_model"], p["n_heads"], p["n_kv_heads"], p["d_ff"], p["vocab"],
            p["n_layers"], p["rope_theta"]) == \
        (yi["hidden_size"], yi["num_attention_heads"], yi["num_key_value_heads"],
         yi["intermediate_size"], yi["vocab_size"], yi["num_hidden_layers"], yi["rope_theta"])
    for conf in (dbrx, yi):
        assert conf["port"]["d_head"] * conf["port"]["n_heads"] == conf["port"]["d_model"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_no_reference_package_no_program_in_the_reference(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(FORBIDDEN), (path, tops)
    assert "benchmarks" not in tops and "benchmarks" + "/" not in path.read_text()
    if "reference" in path.relative_to(spec.HERE).parts:
        assert not any(t.startswith("repro") or t == "harness" for t in tops), tops


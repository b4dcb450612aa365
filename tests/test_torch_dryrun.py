"""The port's dry-run pieces against the reference's: ``trace_analysis``
(flops counted as a step runs) against ``hlo_analysis`` (flops read from
compiled HLO), the ring factors of ``collectives`` against the
reference's HLO parser, and ``launch.dryrun.run_cell`` on a reduced config
over a fake 16 x 16 process group (in a subprocess: the fake group is
process-global), rendered by ``launch.roofline``; and a train cell of a
reduced config widened so that heads, ``d_ff`` and vocab split over the 16
model ranks, whose useful flops show each rank computing only its shard."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import hlo_analysis  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.distributed import collectives, trace_analysis  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _compiled(f, *shapes):
    c = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
    return hlo_analysis.analyze(c.as_text(), 1)


def test_loop_flops_count_every_iteration():
    """A 7-step loop of (32x128) @ (128x128): the port counts each
    iteration, exactly 2*32*128*128*7; the reference recovers the same from
    the scan's trip count within 1%."""
    expect = 2 * 32 * 128 * 128 * 7
    w = torch.zeros(128, 128)

    def loop(x):
        for _ in range(7):
            x = x @ w
        return x
    got = trace_analysis.analyze(loop, torch.zeros(32, 128, device="meta"))
    assert got["flops"] == expect
    assert got["flops_by_op"] == {"mm": expect}
    wj = jnp.zeros((128, 128), jnp.float32)

    def scan(x):
        return jax.lax.scan(lambda c, _: (c @ wj, None), x, None, length=7)[0]
    assert abs(_compiled(scan, (32, 128))["flops"] - expect) / expect < 0.01


def test_loop_free_mlp_flops_equal_reference():
    w1, w2 = torch.zeros(256, 512), torch.zeros(512, 64)
    got = trace_analysis.analyze(lambda x: torch.relu(x @ w1) @ w2, torch.zeros(64, 256))
    j1, j2 = jnp.zeros((256, 512)), jnp.zeros((512, 64))
    want = _compiled(lambda x: jax.nn.relu(x @ j1) @ j2, (64, 256))
    assert got["flops"] == want["flops"] == 2 * 64 * 256 * 512 + 2 * 64 * 512 * 64
    # operands and results of each op, unfused: both products and the relu
    assert got["bytes"] == 4 * (64 * 256 + 256 * 512 + 64 * 512 + 2 * 64 * 512
                                + 64 * 512 + 512 * 64 + 64 * 64)
    assert got["temp_peak_bytes"] == 4 * (64 * 512 * 2)


HLO = textwrap.dedent("""
    ENTRY %main.1 (p0: f32[1024]) -> f32[1024] {
      %ar = f32[1024]{0} all-reduce(%p0), replica_groups=[4,8]<=[32], to_apply=%add
      %ag = bf16[64,128]{1,0} all-gather(%p1), replica_groups=[2,16]<=[32], dimensions={0}
      %rs = f32[256]{0} reduce-scatter(%p2), replica_groups={{0,1,2,3}}, to_apply=%add
      %aa = f32[32,8]{1,0} all-to-all(%p3), replica_groups=[8,4]<=[32]
      ROOT %cp = f32[16]{0} collective-permute(%p4), source_target_pairs={{0,1}}
    }
""")
RECORDS = [("all-reduce", 4096, 8), ("all-gather", 64 * 128 * 2, 16),
           ("reduce-scatter", 1024, 4), ("all-to-all", 32 * 8 * 4, 4),
           ("collective-permute", 64, None)]


def test_ring_factors_equal_reference():
    """The five collectives as the reference reads them from HLO text and
    as the port records them: counts, raw and effective bytes per op."""
    want = jcoll.collective_stats(HLO, 32)
    got = collectives.collective_stats(RECORDS, 32)
    assert got["by_op"] == want["by_op"]
    assert got["total"] == want["total"]
    assert set(got["by_op"]) == set(collectives.OPS)
    assert hlo_analysis.analyze(HLO, 32)["coll_eff_bytes"] == \
        pytest.approx(got["total"]["eff_bytes"])
    for op, rb, g in RECORDS:
        assert collectives.effective_bytes(op, rb, g or 32) == \
            want["by_op"][op]["eff_bytes"]


def test_roofline_terms_use_the_h100_data_sheet():
    t = collectives.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 3)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == \
        pytest.approx((1.0, 2.0, 3.0))
    assert t["dominant"] == "collective" and t["roofline_s"] == pytest.approx(3.0)
    with pytest.raises(ValueError, match="unknown collective"):
        collectives.effective_bytes("gather", 1, 2)


# reduced llama widened so that its 16 query heads (on 8 KV heads, whole
# on 'model'), d_ff and vocab split over 16 model ranks, and the products
# outweigh the plain attention's S x S scores at S=4096; a vocab small
# beside the layer, as in the full configs (MODEL_FLOPS counts the
# embedding table's parameters, which the lookup multiplies by nothing)
WIDE = dict(name="gentorrent-llama3-8b-tp16", d_model=2048, n_heads=16, n_kv_heads=8,
            d_head=128, d_ff=8192, vocab=4096)
CELL = textwrap.dedent("""
    import dataclasses, sys
    from pathlib import Path
    from repro_torch import configs
    from repro_torch.launch import dryrun
    cfg = configs.register(configs.get_config("gentorrent-llama3-8b").reduced())
    for shape in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell("gentorrent-llama3-8b-reduced", shape, False,
                              Path(sys.argv[1]), force=True)
        assert rec["status"] == "ok", rec
    wide = configs.register(dataclasses.replace(cfg, **%r))
    rec = dryrun.run_cell(wide.name, "train_4k", False, Path(sys.argv[2]), force=True)
    assert rec["status"] == "ok", rec
""" % WIDE)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out, wide = tmp_path_factory.mktemp("dryrun"), tmp_path_factory.mktemp("wide")
    r = subprocess.run([sys.executable, "-c", CELL, str(out), str(wide)], cwd=ROOT,
                       timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return out / "pod16x16", wide / "pod16x16"


@pytest.fixture(scope="module")
def records(cells):
    return cells[0]


def _local_bytes(cfg, tree, mesh, train):
    """Bytes of a rank's shards of ``tree`` under the reference's rules."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = jsharding.param_pspec(cfg, path, leaf.shape, mesh, train)
        n = math.prod(leaf.shape)
        for entry in spec:
            for ax in ([entry] if isinstance(entry, str) else entry or ()):
                n //= mesh.shape[ax]
        total += n * leaf.dtype.itemsize
    return total


def test_run_cell_over_a_fake_16x16_group(records):
    """A train and a decode cell of reduced llama: status ok on 256
    devices; the train cell's argument bytes are the rank's shards of the
    params, AdamW's mu and nu (f32), its step and its batch slice; both
    ran collectives (the weights' gathers) and counted flops."""
    cfg = base.get_config("gentorrent-llama3-8b").reduced()
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rec = json.loads((records / "gentorrent-llama3-8b-reduced_train_4k.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["params_total"] == cfg.param_counts()["total"]
    params = build_model(cfg).param_specs()
    want = (_local_bytes(cfg, params, mesh, True)
            + 2 * _local_bytes(cfg, jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                s.shape, jnp.float32), params), mesh, True)
            + 4 + 2 * (256 // 16) * 4096 * 4)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    for name in ("train_4k", "decode_32k"):
        r = json.loads((records / f"gentorrent-llama3-8b-reduced_{name}.json").read_text())
        t = r["trace_analysis"]
        assert r["status"] == "ok" and t["flops"] > 0 and t["coll_eff_bytes"] > 0
        assert r["roofline"]["roofline_s"] == max(
            r["roofline"][k] for k in ("t_compute_s", "t_memory_s", "t_collective_s"))
    # the train step all-gathers weights and reduce-scatters gradients
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
        rec["trace_analysis"]["coll_by_op"])


def test_roofline_renders_the_records(records, capsys, monkeypatch):
    rows = roofline.build_table(str(records))
    assert [(r["arch"], r["shape"], r["status"]) for r in rows] == [
        ("gentorrent-llama3-8b-reduced", "decode_32k", "ok"),
        ("gentorrent-llama3-8b-reduced", "train_4k", "ok")]
    train = rows[1]
    shape = base.SHAPES["train_4k"]
    active = base.get_config("gentorrent-llama3-8b").reduced().param_counts()["active"]
    assert train["model_flops"] == 6.0 * active * shape.global_batch * shape.seq_len
    monkeypatch.setattr(sys, "argv", ["roofline", "--dir", str(records)])
    roofline.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:3] == ["arch", "shape", "t_comp"]
    assert [line.split()[:2] for line in out[1:]] == [
        ["gentorrent-llama3-8b-reduced", "decode_32k"],
        ["gentorrent-llama3-8b-reduced", "train_4k"]]


def test_a_train_cell_split_over_model_counts_its_shard(cells):
    """The widened config's 16 x 16 train cell: useful flops (MODEL_FLOPS
    over every device's traced flops) at least 0.4 (at most 1), where a
    rank that computed its batch slice whole would count 16 x (4/3) x
    MODEL_FLOPS / 256 and show ~0.05; the reference's rules split its
    heads, d_ff and vocab over 'model'."""
    cfg = dataclasses.replace(base.get_config("gentorrent-llama3-8b").reduced(),
                              **{k: v for k, v in WIDE.items() if k != "name"})
    mesh = AbstractMesh((16, 16), ("data", "model"))
    specs = {getattr(p[-1], "key", None): jsharding.param_pspec(cfg, p, x.shape, mesh, True)
             for p, x in jax.tree_util.tree_flatten_with_path(
                 build_model(cfg).param_specs())[0]}
    assert specs["wq"][2] == specs["w_up"][2] == specs["embed"][0] == "model"
    (row,) = roofline.build_table(str(cells[1]))
    assert row["status"] == "ok" and 0.4 <= row["useful_flops_ratio"] <= 1.0, row


@pytest.mark.parametrize("extent", [16, 32])
def test_a_split_slstm_computes_on_its_columns_of_the_state(extent):
    """Reduced xlstm, whose sLSTM (pattern position 7) has heads of width
    16: at model extent 16, which divides it, a serving rank of the
    dry-run computes on its columns of h, c, n and m (dim 3 of (R, B, H,
    dh)), on 'model' also for n, which the rules leave whole (the
    reference's ``cache_pspec`` meets the mLSTM's rule for n first) and
    into whose placement the dry-run gathers it; at 32 the state is whole
    on every rank.  The port's cache rule gives the reference's spec for
    each leaf."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.launch import dryrun
    cfg, jcfg = configs.get_config("xlstm-1.3b").reduced(), base.get_config("xlstm-1.3b").reduced()
    assert cfg.pattern[7].mixer == "slstm" and cfg.d_model // cfg.n_heads == 16
    sizes = (256 // extent, extent)
    mesh = AbstractMesh(sizes, ("data", "model"))
    tmesh = SimpleNamespace(axis_names=("data", "model"), shape=dict(zip(mesh.axis_names, sizes)))
    split = extent == 16
    for leaf in ("h", "c", "n", "m"):
        path, shape = (7, leaf), (1, 32, 4, 16)
        want = tuple(jsharding.cache_pspec(jcfg, path, shape, mesh, False))
        spec = tsharding.cache_pspec(cfg, path, shape, tmesh, False)
        assert tuple(spec) == want, leaf
        assert want[3] == ("model" if split and leaf != "n" else None), (leaf, want)
        assert dryrun._compute_dims(cfg, path, extent) == ((1, 3) if split else (1,)), leaf
        assert tuple(dryrun._compute_spec(cfg, path, spec, extent)) == \
            (None, "data", None, "model" if split else None), leaf

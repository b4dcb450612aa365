"""Port parity on the CPU for the overlay's serving path: the HR-tree,
``decide()``, the wire and KV codecs, page export/import, and the
multi-node scenarios of ``test_affinity_serving.py`` and
``test_kv_migration.py`` re-run with the JAX package's nodes and the
port's nodes on the same reduced float32 weights.  Sink outputs, every
node metric (the simulated ``ttft``/``total`` included: both run the same
plain-Python cost model on the same message sizes) and every engine
counter must be equal."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.core import forwarding as jfwd  # noqa: E402
from repro.core import hrtree as jhr  # noqa: E402
from repro.core.sentry import build_lengths  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.net import simnet as jsimnet  # noqa: E402
from repro.overlay import model_node as jnode  # noqa: E402
from repro.overlay import probe as jprobe  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.prefix_cache import BLOCK, _chain_hashes  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import forwarding as tfwd  # noqa: E402
from repro_torch.core import hrtree as thr  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.net import simnet as tsimnet  # noqa: E402
from repro_torch.net import wire  # noqa: E402
from repro_torch.overlay import model_node as tnode  # noqa: E402
from repro_torch.overlay import probe as tprobe  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402

NAME = "gentorrent-llama3-8b"
ENGINE_COUNTERS = ("prefill_dispatches", "prefill_tokens", "batched_traces",
                   "batched_prefill_traces", "kv_exported_pages",
                   "kv_imported_pages", "kv_export_events", "kv_import_events")
SHARED_AFFINITY = [7] * 64              # test_affinity_serving.py: two blocks
SHARED = [7] * 96                       # test_kv_migration.py: three blocks


@pytest.fixture(scope="module")
def stacks():
    jcfg = base.get_config(NAME).reduced()
    tcfg = configs.get_config(NAME).reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tmodel = LM(tcfg, device="cpu")
    return {
        "jax": types.SimpleNamespace(
            SimNet=jsimnet.SimNet, ModelNode=jnode.ModelNode,
            ForwardingConfig=jfwd.ForwardingConfig, Sink=jprobe.ResponseSink,
            payload=jprobe.direct_payload, Request=jengine.Request,
            engine=lambda **kw: jengine.RealEngine(jcfg, jmodel, jparams, **kw)),
        "torch": types.SimpleNamespace(
            SimNet=tsimnet.SimNet, ModelNode=tnode.ModelNode,
            ForwardingConfig=tfwd.ForwardingConfig, Sink=tprobe.ResponseSink,
            payload=tprobe.direct_payload, Request=tengine.Request,
            engine=lambda **kw: tengine.RealEngine(tcfg, tmodel, tparams,
                                                   device="cpu", **kw)),
    }


# ------------------------------------------------------------ scenarios
def _nodes(st, seed, fwd, **kw):
    net = st.SimNet(seed=seed)
    nodes = [st.ModelNode(f"m{i}", use_crypto=False, fwd_cfg=fwd,
                          real_engine=st.engine(max_len=128), **kw)
             for i in range(2)]
    for n in nodes:
        net.add_node(n.node_id, n)
    for n in nodes:
        n.join_group([n.node_id for n in nodes])
    sink = st.Sink()
    net.add_node("sink", sink)
    return net, nodes, sink


def _record(net, nodes):
    """Log every message sent on ``net`` while still delivering it, with,
    for an hr_sync, the prompts its sender had served by then."""
    sent = []
    real_send = net.send
    by_id = {n.node_id: n for n in nodes}

    def send(src, dst, msg, size_bytes=1024):
        served = None
        if isinstance(msg, dict) and msg.get("type") == "hr_sync":
            served = [list(p) for p in by_id[src]._recent_prompts]
        sent.append((src, dst, msg, size_bytes, served))
        real_send(src, dst, msg, size_bytes)
    net.send = send
    return sent


def affinity(st, on):
    """test_affinity_serving.py::_run_mode."""
    net, nodes, sink = _nodes(st, 3, st.ForwardingConfig(affinity=on))
    sent = _record(net, nodes)
    nodes[0]._process(net, st.payload("seed", SHARED_AFFINITY + [1] * 8),
                      forwarded=True)
    net.run_until(net.t + 30)
    for n in nodes:
        n.broadcast_state(net)
    net.run_until(net.t + 5)
    nodes[1].peers["m0"].active_requests = 3
    for i in range(3):
        net.call_after(0.01, nodes[1]._process, net,
                       st.payload(f"sib{i}", SHARED_AFFINITY + [10 + i] * 8))
    net.run_until(net.t + 60)
    assert len(sink.got) == 4
    return net, nodes, sink, sent


def _seed_and_pressure(st, net, nodes):
    nodes[0]._process(net, st.payload("seed", SHARED + [1] * 8, 2),
                      forwarded=True)
    net.run_until(net.t + 30)
    for n in nodes:
        n.broadcast_state(net)
    net.run_until(net.t + 5)
    nodes[1].peers["m0"].active_requests = 6          # rel load 1.2
    nodes[1].peers["m0"].kv_pressure = 0.95


def migration(st, replicate, case="siblings", **kw):
    """test_kv_migration.py: ``_run_siblings`` and the refusal, garbled,
    timeout and chunked-reassembly cases."""
    net, nodes, sink = _nodes(st, 5, st.ForwardingConfig(replicate=replicate), **kw)
    sent = _record(net, nodes)
    _seed_and_pressure(st, net, nodes)
    if case == "refusal":
        while nodes[0].real_engine.prefix_cache.pop_lru():
            pass
    elif case == "timeout":
        net.remove_node("m0")
    n_sib = 3 if case == "siblings" else 1
    for i in range(n_sib):
        net.call_after(0.01, nodes[1]._process, net,
                       st.payload(f"sib{i}", SHARED + [10 + i] * 8, 4))
    if case == "garbled":
        logged = net.send

        def tamper(src, dst, msg, size_bytes=1024):
            if isinstance(msg, dict) and msg.get("type") == "kv_pages":
                msg = dict(msg, data=b"\xde\xad" * 8)
            logged(src, dst, msg, size_bytes)
        net.send = tamper
    net.run_until(net.t + (120 if case == "timeout" else 60))
    return net, nodes, sink, sent


SCENARIOS = {
    "affinity_on": lambda st: affinity(st, True),
    "affinity_off": lambda st: affinity(st, False),
    "replicate_on": lambda st: migration(st, True),
    "replicate_off": lambda st: migration(st, False),
    "refusal": lambda st: migration(st, True, "refusal"),
    "garbled": lambda st: migration(st, True, "garbled"),
    "timeout": lambda st: migration(st, True, "timeout"),
    "chunked": lambda st: migration(st, True, "chunk", kv_chunk_bytes=1024),
}


def _summary(net, nodes, sink):
    out = {"got": sink.got, "t": net.t, "delivered": net.delivered,
           "dropped": net.dropped}
    for n in nodes:
        eng = n.real_engine
        eng.allocator.check()
        out[n.node_id] = {
            "metrics": n.metrics, "active": n.active_requests,
            "engine": {k: getattr(eng, k) for k in ENGINE_COUNTERS},
            "used_pages": eng.allocator.used_count,
            "refcounts": [eng.allocator.refcount(p) for p in range(eng.num_pages)],
            "tree": sorted(map(tuple, n.hrtree.export_paths(n.node_id))),
            "tree_size": n.hrtree.size()}
    return out


@pytest.fixture(scope="module")
def runs(stacks):
    """Each scenario once per stack (the parity and the counter checks
    read the same runs)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = {k: SCENARIOS[name](st) for k, st in stacks.items()}
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(runs, name):
    r = runs(name)
    jsum, tsum = (_summary(*r[k][:3]) for k in ("jax", "torch"))
    assert tsum == jsum


def test_affinity_counters(runs):
    """The reference test's own assertions hold on the port's nodes."""
    (_, aff, aff_sink, _), (_, lb, lb_sink, _) = (
        runs(n)["torch"] for n in ("affinity_on", "affinity_off"))
    assert aff_sink.got == lb_sink.got
    assert aff[1].metrics["affinity_hits"] == 3
    assert aff[1].metrics["forwarded_out"] == 3
    assert aff[0].real_engine.prefill_tokens == 72 + 3 * 8
    assert aff[1].real_engine.prefill_tokens == 0
    assert aff[0].real_engine.prefill_dispatches == 3 + 1
    assert lb[1].metrics["affinity_hits"] == 0
    assert lb[1].real_engine.prefill_tokens == 3 * 72


def test_migration_counters(runs):
    (_, rep, rep_sink, _), (_, lb, lb_sink, _) = (
        runs(n)["torch"] for n in ("replicate_on", "replicate_off"))
    m0, m1 = rep
    assert rep_sink.got == lb_sink.got and len(rep_sink.got) == 4
    assert m1.metrics["replicate_routes"] == 3
    assert m1.metrics["kv_fetches"] == 1
    assert m1.metrics["kv_fetch_piggybacks"] == 2
    assert m1.metrics["kv_imported_pages"] == 3
    assert m1.metrics["kv_fallbacks"] == 0
    assert m0.metrics["kv_exports"] == 1
    assert m0.real_engine.kv_exported_pages == 3
    # seed (104 tokens, 4 chunks) on m0; only the 8-token tails on m1
    assert m1.real_engine.prefill_tokens == 3 * 8
    assert m1.real_engine.prefill_dispatches == 1
    assert lb[1].metrics["kv_fetches"] == 0
    assert lb[1].real_engine.prefill_tokens == 3 * (96 + 8)
    for name, metric in (("refusal", "kv_refusals"), ("garbled", "kv_import_failures"),
                         ("timeout", "kv_timeouts")):
        _, nodes, sink, _ = runs(name)["torch"]
        assert "sib0" in sink.got
        assert nodes[1].metrics[metric] == 1
        assert nodes[1].metrics["kv_fallbacks"] == 1
    _, nodes, sink, _ = runs("chunked")["torch"]
    assert nodes[1].metrics["kv_imported_pages"] == 3
    assert nodes[1].metrics["kv_wire_bytes"] > 1024


# ------------------------------------------------------------ wire codec
def _wire_objects(sent):
    """Every message of a scenario, and the payloads inside them: the
    forwarded request, and the reassembled kv_pages buffers."""
    objs, pages = [], {}
    for _, _, msg, _, _ in sent:
        objs.append(msg)
        if msg["type"] == "fwd_request":
            objs.append(msgpack.unpackb(msg["payload"], raw=False))
        if msg["type"] == "kv_pages" and msg["ok"]:
            pages.setdefault(msg["fetch_id"], []).append(msg["data"])
    objs += [msgpack.unpackb(b"".join(p), raw=False) for p in pages.values()]
    return objs


@pytest.mark.parametrize("name", ["affinity_on", "replicate_on", "chunked"])
def test_wire_codec_is_msgpack(runs, name):
    objs = _wire_objects(runs(name)["torch"][3])
    types_seen = {o.get("type") for o in objs}
    assert {"hr_sync", "response_clove"} <= types_seen
    assert ({"fwd_request"} if name == "affinity_on" else {"kv_fetch", "kv_pages"}) \
        <= types_seen
    # a response payload as ModelNode._finish encodes it
    objs.append({"msg_id": "sib0", "session": None, "server": "m0",
                 "output": [1, 2, 3], "prompt": SHARED + [10] * 8})
    for o in objs:
        b = msgpack.packb(o, use_bin_type=True)
        assert wire.packb(o) == b
        assert wire.unpackb(b) == msgpack.unpackb(b, raw=False)
        assert wire.unpackb(wire.packb(o)) == msgpack.unpackb(b, raw=False)


def test_wire_codec_edges():
    cases = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
             1.5, -0.0, float("inf"), None, True, False, "", "a" * 31, "a" * 32,
             "é" * 200, "x" * 70000, b"", b"\x00" * 255, b"\x01" * 256,
             b"\x02" * 70000, list(range(15)), list(range(16)), list(range(70000)),
             {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             (1, (2, [3, {"a": b"b"}]))]
    for o in cases:
        b = msgpack.packb(o, use_bin_type=True)
        assert wire.packb(o) == b, repr(o)[:40]
        assert wire.unpackb(b) == msgpack.unpackb(b, raw=False)
    for bad in (np.int64(3), torch.tensor(1), object()):
        with pytest.raises(TypeError):
            wire.packb(bad)
    for garbled in (b"\xde\xad" * 8, b"\x92\x01", b"\x01\x02", b"\xc1", b"",
                    b"\x91" * 600 + b"\x01"):                 # nested too deep
        with pytest.raises(ValueError):
            wire.unpackb(garbled)
    with pytest.raises(ValueError):
        wire.unpackb(msgpack.packb({1: 2}))            # map keys: str or bytes


# ------------------------------------------------------------ KV codec
def _kv_arrays():
    """The same f32 and bf16 values for both packages (bf16 from one set
    of bit patterns), outliers and an fp16 overflow included."""
    rng = np.random.default_rng(0)
    f = (rng.standard_normal((2, 3, 32, 2, 16)) * 3).astype(np.float32)
    f[0, 0, 0, 0, :4] = [7e4, -7e4, 1e-8, 0.0]
    f[1, 2] *= 100.0
    bits = (f.view(np.uint32) >> 16).astype(np.uint16)
    return {"float32": (f, torch.from_numpy(f)),
            "bfloat16": (bits.view(ml_dtypes.bfloat16),
                         torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))}


@pytest.mark.parametrize("mode", ["raw", "fp16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_codec_records_match_reference(mode, dtype):
    jarr, tarr = _kv_arrays()[dtype]
    with np.errstate(over="ignore"):
        jrec = jcomp.compress_kv_blocks(jarr, mode)
    trec = tcomp.compress_kv_blocks(tarr, mode)
    assert wire.packb(trec) == msgpack.packb(jrec, use_bin_type=True)
    jout = jcomp.decompress_kv_blocks(jrec)
    tout = tcomp.decompress_kv_blocks(trec)
    assert str(jout.dtype) == dtype and tout.dtype == tarr.dtype
    np.testing.assert_array_equal(np.asarray(jout, np.float32), tout.float().numpy())
    # and into another arena dtype, as import_pages asks
    np.testing.assert_array_equal(
        np.asarray(jcomp.decompress_kv_blocks(jrec, np.dtype("float32"))),
        tcomp.decompress_kv_blocks(trec, torch.float32).numpy())
    with pytest.raises(ValueError):
        tcomp.compress_kv_blocks(tarr, "gzip")


# ------------------------------------------------ export / import pages
@pytest.mark.parametrize("mode", ["raw", "fp16", "int8"])
def test_export_import_pages_match_reference(stacks, mode):
    """test_kv_migration.py::test_export_import_pages_roundtrip on both
    packages: same pages and refcounts after ``generate``; from the same
    arena contents (the reference's, copied in) the same wire bytes; the
    same imported pages, arena contents and admission counters."""
    res = {}
    for k, st in stacks.items():
        src = st.engine(max_len=128)
        src.generate(st.Request(0, SHARED + [1] * 8, max_new=2))
        _, entry = src.prefix_cache.peek(SHARED)
        res[k] = types.SimpleNamespace(src=src, entry=entry, st=st)
    j, t = res["jax"], res["torch"]
    assert t.entry.handle.pages == j.entry.handle.pages
    for layer_j, layer_t in zip(j.src.arena, t.src.arena):
        for n in ("k", "v"):
            np.testing.assert_allclose(layer_t[n].numpy(), np.asarray(layer_j[n]),
                                       atol=2e-4, rtol=2e-4)
            layer_t[n].copy_(torch.from_numpy(np.array(layer_j[n])))
    for r in (j, t):
        free = r.src.allocator.free_count
        r.buf = r.src.export_pages(r.entry.handle, depth=3, mode=mode)
        assert r.src.allocator.free_count == free      # export is read-only
        r.src.allocator.check()
    assert wire.packb(t.buf) == msgpack.packb(j.buf, use_bin_type=True)
    for r in (j, t):
        r.dst = r.st.engine(max_len=128)
        r.handle = r.dst.import_pages(r.buf, _chain_hashes(SHARED))
        r.matched, got = r.dst.prefix_cache.peek(SHARED)
        assert got.handle is r.handle
        r.refs = [r.dst.allocator.refcount(p) for p in range(r.dst.num_pages)]
        d0 = r.dst.prefill_dispatches
        r.res = r.dst.generate(r.st.Request(1, SHARED + [9] * 8, max_new=2))
        r.dispatches = r.dst.prefill_dispatches - d0
    assert t.handle.pages == j.handle.pages and t.handle.length == j.handle.length == 96
    assert t.matched == j.matched == 96 and t.refs == j.refs
    assert (t.res.cached_tokens, t.dispatches) == (j.res.cached_tokens, j.dispatches) == (96, 1)
    assert t.res.output == j.res.output
    pages = list(t.handle.pages)
    for layer_j, layer_t in zip(j.dst.arena, t.dst.arena):
        for n in ("k", "v"):
            np.testing.assert_array_equal(layer_t[n][:, pages].numpy(),
                                          np.asarray(layer_j[n])[:, pages])
    for k in ENGINE_COUNTERS:
        assert getattr(t.dst, k) == getattr(j.dst, k), k
        assert getattr(t.src, k) == getattr(j.src, k), k


def test_import_rejects_short_chain_and_releases(stacks):
    st = stacks["torch"]
    src = st.engine(max_len=128)
    src.generate(st.Request(0, SHARED, max_new=2))
    _, entry = src.prefix_cache.peek(SHARED)
    buf = src.export_pages(entry.handle, depth=3)
    dst = st.engine(max_len=128)
    with pytest.raises(ValueError):
        dst.import_pages(buf, _chain_hashes(SHARED)[:2])
    for layers in ([], [{"k": layer["k"]} for layer in buf["layers"]]):
        with pytest.raises((KeyError, ValueError)):     # layers or "v" missing
            dst.import_pages(dict(buf, layers=layers), _chain_hashes(SHARED))
    assert dst.allocator.free_count == dst.num_pages - 1
    dst.allocator.check()


def _bad_record(rec, case):
    rec = dict(rec)
    if case == "truncated":
        rec["data"] = rec["data"][:-2]
    elif case == "not_bytes":
        rec["data"] = 7
    elif case == "no_scale":
        rec = dict(rec, mode="int8")
    elif case == "wrong_heads":
        rec["shape"] = [*rec["shape"][:-2], rec["shape"][-2] * 2, rec["shape"][-1] // 2]
    elif case == "empty_shape":
        rec["shape"] = []
    return rec


@pytest.mark.parametrize("case", ["truncated", "not_bytes", "no_scale",
                                  "wrong_heads", "empty_shape"])
def test_import_rejects_malformed_record_and_releases(stacks, case):
    """A peer's record whose bytes do not fit its shape, or whose shape
    does not fit the arena, raises one of the errors the replicator turns
    into a fallback, before any page is written or kept."""
    st = stacks["torch"]
    src = st.engine(max_len=128)
    src.generate(st.Request(0, SHARED, max_new=2))
    _, entry = src.prefix_cache.peek(SHARED)
    buf = src.export_pages(entry.handle, depth=3, mode="raw")
    layers = [dict(layer, v=_bad_record(layer["v"], case)) for layer in buf["layers"]]
    dst = st.engine(max_len=128)
    before = [t.clone() for layer in dst.arena for t in layer.values()]
    with pytest.raises((ValueError, KeyError, TypeError)):
        dst.import_pages(dict(buf, layers=layers), _chain_hashes(SHARED))
    assert dst.allocator.free_count == dst.num_pages - 1
    dst.allocator.check()
    assert all(torch.equal(a, b) for a, b in
               zip(before, [t for layer in dst.arena for t in layer.values()]))


@pytest.mark.parametrize("fault", ["out_of_pages", "device"])
def test_replicator_falls_back_only_on_peer_or_arena_faults(stacks, monkeypatch, fault):
    """An import that runs out of pages falls back to prefill; any other
    error (a device fault in the scatter) propagates out of the node."""
    from repro_torch.serving.page_pool import OutOfPages
    err = OutOfPages("need 3 pages, 0 free") if fault == "out_of_pages" \
        else RuntimeError("device fault in the scatter")

    def fail(self, buf, chains):
        raise err
    monkeypatch.setattr(tengine.RealEngine, "import_pages", fail)
    st = stacks["torch"]
    if fault == "device":
        with pytest.raises(RuntimeError, match="device fault"):
            migration(st, True)
        return
    net, nodes, sink, _ = migration(st, True)
    m = nodes[1].metrics
    assert m["kv_import_failures"] == 1 and m["kv_imported_pages"] == 0
    assert m["kv_fallbacks"] == 3 and len(sink.got) == 4


# ------------------------------------------------------------ HR-tree
def _prompts(rng, n, lo, hi, vocab=50_000, shared=None):
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
        if shared is not None and i % 2 == 0:
            p = (shared + p)[:len(p)]
        out.append(p)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_hrtree_matches_reference(seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 50_000, size=200).tolist()
    lengths = build_lengths([40, 120, 200], 8)
    prompts = _prompts(rng, 24, 30, 500, shared=shared)
    jt, tt = jhr.HRTree(lengths), thr.HRTree(lengths, device="cpu")
    for i, p in enumerate(prompts):
        for tree in (jt, tt):
            tree.insert_tokens(p, f"m{i % 3}", ts=float(i))
    paths = {h: jt.export_paths(h) for h in ("m0", "m1", "m2")}
    for h in paths:
        assert tt.export_paths(h) == paths[h]
    for tree in (jt, tt):
        tree.merge_paths(paths["m1"], "m9", ts=100.0)
        tree.remove_holder("m2")
        tree.expire(10.0)
    probes = prompts + _prompts(rng, 8, 10, 400, shared=shared)
    for tau in (1, 2, 4):
        for p in probes:
            assert tt.search_tokens(p, tau) == jt.search_tokens(p, tau)
    for h in ("m0", "m1", "m2", "m9"):
        assert tt.export_paths(h) == jt.export_paths(h)
    assert tt.size() == jt.size()
    assert all(type(h) is int for p in tt.export_paths("m9") for h in p)


# ------------------------------------------------------------ decide()
def _peer_tables(rng, case):
    """The same peer view for both packages: loads, pressures and, for
    the sketch cases, the holder's prefix sketch over a cached prompt."""
    shared = rng.integers(0, 50_000, size=160).tolist()
    tokens = shared + rng.integers(0, 50_000, size=40).tolist()
    ids = [f"m{i}" for i in range(4)]
    rows = {nid: dict(hw_score=float(rng.integers(1, 11)),
                      active_requests=int(rng.integers(0, 4)),
                      latency_ms=float(rng.integers(0, 3)),
                      kv_pressure=float(rng.uniform(0, 0.5)),
                      spec_accept_rate=float(rng.uniform(0, 1)))
            for nid in ids}
    holder = ids[int(rng.integers(0, 4))]
    sketch, tree_tokens = None, None
    if case in ("sketch", "veto", "replicate"):
        sketch = shared[:int(rng.integers(2, 6)) * BLOCK]
    if case == "hrtree":
        tree_tokens = tokens
    if case in ("veto", "replicate"):
        rows[holder].update(kv_pressure=0.95, active_requests=9, hw_score=1.0)
    if case == "veto":                  # a shallow hit: below replicate_min_blocks
        sketch = shared[:BLOCK]
    out = {}
    for name, fwd, hr, kw in (("jax", jfwd, jhr, {}), ("torch", tfwd, thr, {"device": "cpu"})):
        peers = {nid: fwd.PeerInfo(nid, **r) for nid, r in rows.items()}
        if sketch is not None:
            peers[holder].prefix_sketch = fwd.PrefixSketch.build(
                _chain_hashes(sketch)).to_bytes()
        tree = hr.HRTree([64, 8, 88], **kw)
        if tree_tokens is not None:
            tree.insert_tokens(tree_tokens, holder)
        out[name] = (fwd, tree, peers)
    return tokens, out


@pytest.mark.parametrize("case", ["load", "hrtree", "sketch", "veto", "replicate"])
def test_decide_matches_reference(case):
    reasons = set()
    for seed in range(12):
        rng = np.random.default_rng(seed)
        tokens, tables = _peer_tables(rng, case)
        n_out = int(rng.choice([4, 400]))
        got = {}
        for name, (fwd, tree, peers) in tables.items():
            d = fwd.decide(fwd.ForwardingConfig(), tree, peers, tokens,
                           self_id="m0", n_out=n_out)
            got[name] = (d.target, d.reason, d.depth, d.candidates, d.fetch_from)
        assert got["torch"] == got["jax"]
        reasons.add(got["torch"][1])
    expect = {"load": {"load_balance"}, "hrtree": {"cache_hit"},
              "sketch": {"affinity"}, "veto": {"load_balance"},
              "replicate": {"replicate"}}[case]
    assert expect <= reasons


def test_overlay_hashes_equal_preprocess(runs):
    """The port's nodes hash through ``preprocess_batch`` (the plain hash
    on the CPU); their sync paths and trees equal the reference's Python
    ``preprocess`` over the same prompts."""
    for name in ("affinity_on", "replicate_on"):
        _, nodes, _, sent = runs(name)["torch"]
        syncs = [(m, served) for _, _, m, _, served in sent if m["type"] == "hr_sync"]
        assert any(m["paths"] for m, _ in syncs)
        for m, served in syncs:
            want = [h for h in (jhr.preprocess(p, nodes[0].lengths)
                                for p in served[-64:]) if h]
            assert m["paths"] == want
        tree = jhr.HRTree(nodes[0].lengths)
        for m, _ in syncs:
            tree.merge_paths(m["paths"], m["from"])
        for n in nodes:
            for nid in ("m0", "m1"):
                assert sorted(n.hrtree.export_paths(nid)) == sorted(tree.export_paths(nid))

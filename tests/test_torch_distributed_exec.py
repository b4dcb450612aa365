"""The port's sharded train step on 8 CPU ranks (gloo, a ``FileStore`` in
the test's temporary directory) against the reference's unsharded step,
the elastic re-mesh of a checkpoint, and the MoE's dispatch groups under a
mesh: the counterpart of ``tests/test_distributed_exec.py``.

One run of 8 worker processes (no JAX in them) writes what they computed;
the tests hold it against the reference in this process:
- ``h2o-danube-1.8b`` ``.reduced()`` widened to d_model 64, d_ff 128 and
  vocab 512 (as the reference's test), on a (4, 2) mesh over ("data",
  "model"): one ``make_sharded_train_step`` step equals the reference's
  unsharded ``make_train_step`` on the same weights and batch (labels with
  ignored positions, so ranks hold different counts);
- ``moonshot-v1-16b-a3b`` reduced the same way (MoE with its aux loss):
  the sharded step equals the reference's step with its DP extent set to
  4 (``constraints.dp_extent``), as GSPMD runs it on that mesh;
- the step with compute split over 'model' (tensor parallelism) on the
  meshes (2, 4) and (8, 1) too: danube on both, moonshot and gemma2
  (softcaps; 2 KV heads whole on 4 model ranks) on (2, 4), each equal to
  the reference's unsharded step; and on (2, 4) every other family: jamba
  widened to d_model 256 (4 Mamba heads, 1 a model rank; its SSD scan in
  chunks of 4 in both packages, where the reference's keeps finite
  gradients; attention and MoE beside them), xlstm (its mLSTM's value
  columns split, and its sLSTM's columns with h gathered at each step and
  its FFN's 85 columns whole on every rank; and widened to d_model 96,
  ``xlstm-1.3b@96``, where the sLSTM's FFN splits its 128 columns too),
  whisper (the encoder, self- and cross-attention; frames as an input) and
  vision (cross-attention to image embeddings);
- a rank computes only its shard: rank 0's matmul flops in danube's (2, 4)
  step are within 5% of its (8, 1) step's, B/8 of each split product;
- the danube step's params saved on (4, 2) restore onto (2, 4), each rank
  holding its shard of the new placements, every leaf identical;
- ``dbrx-132b`` ``.reduced()``'s ``moe_ffn`` under the (4, 2) mesh
  (dispatch groups gcd(4, B)) equals the reference's with its DP extent 4.
The workers' run has its own time limit."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.distributed import constraints as jconstraints  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 120
B, S = 8, 32
STEP_ARCHS = ["h2o-danube-1.8b", "moonshot-v1-16b-a3b"]
# more meshes over the same 8 ranks (data, model), and the configs stepped on each
TP_STEPS = {(2, 4): ["h2o-danube-1.8b", "moonshot-v1-16b-a3b", "gemma2-9b",
                     "jamba-v0.1-52b", "xlstm-1.3b", "whisper-base", "llama-3.2-vision-11b",
                     "xlstm-1.3b@96"],
            (8, 1): ["h2o-danube-1.8b"]}
ARCHS = STEP_ARCHS + TP_STEPS[(2, 4)][2:]
# widths past the reduced config's (a case "ARCH@D" is ARCH at d_model D):
# jamba's reduced d_inner 128 is one Mamba head, which splits nothing;
# xlstm's sLSTM FFN is 85 columns wide at d_model 64, whole on 4 model
# ranks, and 128 at 96, where it splits
WIDE = {"jamba-v0.1-52b": 256, "xlstm-1.3b@96": 96}
FLOPS_ARCH = "h2o-danube-1.8b"
MOE_ARCH = "dbrx-132b"
LR = 1e-3

WORKER = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch, torch.distributed as dist
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)      # eight ranks of tiny products share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=8)
    from repro_torch import configs
    from repro_torch.distributed import constraints, sharded_step, sharding, trace_analysis
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.training import checkpoint, optimizer as opt
    from torch.distributed.tensor import Shard

    def cfg_of(name):
        cfg = configs.get_config(name.split("@")[0]).reduced()
        kw = dict(mamba=dataclasses.replace(cfg.mamba, chunk=4)) if cfg.mamba else {}
        return dataclasses.replace(cfg, d_model=%(WIDE)r.get(name, 64), d_ff=128, vocab=512,
                                   **kw)

    def key(path):
        return "/".join(map(str, path))

    def leaves(tree):
        out = {}
        sharding.tree_map_with_path(lambda p, t: out.__setitem__(
            key(p), t.full_tensor().numpy() if hasattr(t, "full_tensor") else t.numpy()), tree)
        return out

    def run_step(name, mesh, prefix, flops=False):
        # one sharded step of name on mesh, its metrics and leaves into out
        # under prefix; with flops, counted by trace_analysis (the rank's
        # matmul flops under prefix/flops)
        cfg = cfg_of(name)
        data = np.load(f"{tmp}/{name}.npz")
        params = sharding.tree_map_with_path(
            lambda p, _: torch.from_numpy(data["p/" + key(p)]),
            LM(cfg, "cpu").param_specs())
        batch = {k: torch.from_numpy(data[k]) for k in data if not k.startswith("p/")}
        p_sh = sharding.param_shardings(cfg, params, mesh, train=True)
        params = sharding.distribute(params, p_sh)
        batch = sharding.distribute(batch, sharding.input_shardings(cfg, batch, mesh))
        step = sharded_step.make_sharded_train_step(
            cfg, LM(cfg, "cpu"), opt.AdamWConfig(lr=%(LR)r), mesh)
        res = []
        counts = trace_analysis.analyze(
            lambda: res.append(step(params, sharded_step.init_state(params), batch))) \
            if flops else None
        new, state, m = res[0] if flops else step(params, sharded_step.init_state(params),
                                                  batch)
        if flops:
            out[f"{prefix}/flops"] = np.array(counts["flops"])
        for k, v in m.items():
            out[f"{prefix}/metric/{k}"] = v.numpy()
        for part, tree in (("params", new), ("mu", state["mu"]), ("nu", state["nu"])):
            for k, v in leaves(tree).items():
                out[f"{prefix}/{part}/{k}"] = v
        return new

    mesh = make_host_mesh(model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    out = {}
    for shape, names in %(TP_STEPS)r.items():
        tp_mesh = make_mesh(shape, ("data", "model"))
        for name in names:
            run_step(name, tp_mesh, f"{shape[0]}x{shape[1]}/{name}",
                     flops=name == %(FLOPS_ARCH)r)
    for name in %(STEP_ARCHS)r:
        new = run_step(name, mesh, name)
        if name == %(STEP_ARCHS)r[0]:
            cfg = cfg_of(name)
            # elastic re-mesh: save on (4, 2), restore onto (2, 4)
            checkpoint.save(f"{tmp}/ckpt", 1, new)
            mesh2 = make_mesh((2, 4), ("data", "model"))
            sh2 = sharding.param_shardings(cfg, new, mesh2, train=True)
            restored, at = checkpoint.restore(f"{tmp}/ckpt", 1, new, shardings=sh2)
            same = at == 1
            coord = mesh2.device_mesh.get_coordinate()
            for r, s, n in zip(opt.tree_leaves(restored), opt.tree_leaves(sh2),
                               opt.tree_leaves(new)):
                full = n.full_tensor()
                want = full       # this rank's chunk of each sharded mesh dim
                for i, pl in enumerate(s.placements):
                    if isinstance(pl, Shard):
                        want = want.chunk(mesh2.device_mesh.shape[i], dim=pl.dim)[coord[i]]
                same &= tuple(r.placements) == s.placements
                same &= bool(torch.equal(r.to_local(), want))
                same &= bool(torch.equal(r.full_tensor(), full))
            flags = torch.tensor([int(same)])
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            out["reshard_ok"] = flags.numpy()

    cfg = configs.get_config(%(MOE_ARCH)r).reduced()
    data = np.load(f"{tmp}/moe.npz")
    p = {k.removeprefix("p/"): torch.from_numpy(v) for k, v in data.items() if k.startswith("p/")}
    with constraints.activation_mesh(mesh):
        assert constraints.dp_extent() == 4 and moe._n_groups(%(B)r) == 4
        y, aux = moe.moe_ffn(cfg, p, torch.from_numpy(data["x"]), capacity_factor=1.0,
                             return_aux=True)
    out["moe/out"], out["moe/aux"] = y.numpy(), aux.numpy()
    if rank == 0:
        np.savez(f"{tmp}/out.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
""") % {"STEP_ARCHS": STEP_ARCHS, "LR": LR, "MOE_ARCH": MOE_ARCH, "B": B,
        "TP_STEPS": TP_STEPS, "FLOPS_ARCH": FLOPS_ARCH, "WIDE": WIDE}


def _cfgs(name):
    """(reference, port) config, widened as the reference's test widens it
    (jamba and ``xlstm-1.3b@96`` further, ``WIDE``; jamba's SSD scan in
    chunks of 4)."""
    def widen(cfg):
        kw = dict(mamba=dataclasses.replace(cfg.mamba, chunk=4)) if cfg.mamba else {}
        return dataclasses.replace(cfg, d_model=WIDE.get(name, 64), d_ff=128, vocab=512, **kw)
    arch = name.split("@")[0]
    return widen(base.get_config(arch).reduced()), widen(configs.get_config(arch).reduced())


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flat(tree) -> dict:
    return {_key(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed, cfg):
    """Tokens and labels, a quarter of the labels ignored (-1), unevenly
    over the batch rows; whisper's frames (S / 2 of them) and vision's
    image embeddings."""
    g = np.random.default_rng(seed)
    tokens = g.integers(0, 512, (B, S)).astype(np.int32)
    labels = g.integers(0, 512, (B, S)).astype(np.int32)
    labels[g.random((B, S)) < np.linspace(0.0, 0.5, B)[:, None]] = -1
    aux = {}
    if cfg.is_encdec:
        aux["frames"] = g.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)
    if cfg.n_image_tokens:
        aux["image_embeds"] = g.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, **aux}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs from the reference, the 8 workers' run, their outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs = {}
    for i, name in enumerate(ARCHS):
        jcfg, _ = _cfgs(name)
        params = build_model(jcfg).init(jax.random.PRNGKey(i))
        batch = _batch(i, jcfg)
        np.savez(tmp / f"{name}.npz", **batch,
                 **{f"p/{k}": v for k, v in _flat(params).items()})
        inputs[name] = (params, batch)
    mcfg = base.get_config(MOE_ARCH).reduced()
    mp = jmoe.init_moe(mcfg, jax.random.PRNGKey(7))
    x = np.random.default_rng(7).standard_normal((B, 16, mcfg.d_model)).astype(np.float32)
    np.savez(tmp / "moe.npz", x=x, **{f"p/{k}": v for k, v in _flat(mp).items()
                                      if "/" not in k})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} workers did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [p.stdout.read().decode(errors="replace") for p in procs]
    for p in procs:
        p.stdout.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return inputs, mp, x, dict(np.load(tmp / "out.npz"))


def _reference_step(name, params, batch, monkeypatch, dp=4):
    jcfg, _ = _cfgs(name)
    if jcfg.moe is not None:   # GSPMD's grouping on a mesh of ``dp`` data ranks
        monkeypatch.setattr(jconstraints, "dp_extent", lambda: dp)
    step = jax.jit(jmake_step(jcfg, build_model(jcfg), jopt.AdamWConfig(lr=LR), block_q=32))
    new, state, m = step(params, jopt.init_state(params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    return _flat(new), _flat(state["mu"]), _flat(state["nu"]), m


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_sharded_step_matches_reference(run, name, monkeypatch):
    """Loss, gradient norm and every leaf of params, mu and nu after one
    sharded step on (4, 2) equal the reference's unsharded step (the
    train-step tolerances of test_torch_training.py)."""
    inputs, _, _, out = run
    _check_step(out, name, name, *inputs[name], monkeypatch)


def _check_step(out, prefix, name, params, batch, monkeypatch, dp=4):
    """The step written under ``prefix`` against the reference's."""
    new, mu, nu, m = _reference_step(name, params, batch, monkeypatch, dp)
    assert float(out[f"{prefix}/metric/loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert float(out[f"{prefix}/metric/grad_norm"]) == \
        pytest.approx(float(m["grad_norm"]), rel=1e-4)
    assert float(out[f"{prefix}/metric/lr"]) == pytest.approx(float(m["lr"]), rel=1e-7)
    for part, want in (("params", new), ("mu", mu), ("nu", nu)):
        n = prefix.count("/") + 2
        assert {k.split("/", n)[n] for k in out if k.startswith(f"{prefix}/{part}/")} \
            == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(out[f"{prefix}/{part}/{k}"], w, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{part} {k}")


@pytest.mark.parametrize("shape,name", [(s, n) for s, ns in TP_STEPS.items() for n in ns],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_tp_step_matches_reference(run, shape, name, monkeypatch):
    """With compute split over 'model' (heads, d_ff, experts, vocab, the
    Mamba heads, the mLSTM's value columns and the sLSTM's columns) on (2,
    4), and with none on
    (8, 1): loss, gradient norm and every leaf of params, mu and nu after
    one step equal the reference's unsharded step at the tolerances
    above."""
    inputs, _, _, out = run
    _check_step(out, f"{shape[0]}x{shape[1]}/{name}", name, *inputs[name], monkeypatch,
                dp=shape[0])


def test_a_rank_computes_only_its_shard(run):
    """Rank 0's matmul flops (``trace_analysis``) in danube's step on (2,
    4), B/2 of the batch split over 4 model ranks, are within 5% of its
    step on (8, 1), B/8 unsplit: every product splits over 'model'.  The
    reduced config's 2 KV heads stay whole on 4 model ranks, and the 2
    ranks that read one KV head each project half of the tokens
    (``tensor_parallel.kv_project``)."""
    out = run[3]
    tp_flops = float(out[f"2x4/{FLOPS_ARCH}/flops"])
    dp_flops = float(out[f"8x1/{FLOPS_ARCH}/flops"])
    assert dp_flops > 0 and abs(tp_flops / dp_flops - 1) < 0.05, (tp_flops, dp_flops)


def test_restore_onto_another_mesh(run):
    """Saved on (4, 2), restored onto (2, 4): on every rank each leaf has
    the new placements, its local shard is that rank's chunk, and the
    gathered leaf is identical to the one saved."""
    assert run[3]["reshard_ok"].tolist() == [1]


def test_moe_groups_under_the_mesh_match_reference(run, monkeypatch):
    """``moe_ffn`` under the (4, 2) mesh dispatches in gcd(4, B) groups
    (dropping at capacity factor 1.0) as the reference does with DP
    extent 4; outside a mesh the port takes gcd(16, B) groups, which
    drop other tokens."""
    _, mp, x, out = run
    monkeypatch.setattr(jconstraints, "dp_extent", lambda: 4)
    monkeypatch.setattr(jconstraints, "pin", lambda a, kinds: a)
    mcfg = base.get_config(MOE_ARCH).reduced()
    y, aux = jmoe.moe_ffn(mcfg, mp, jnp.asarray(x), capacity_factor=1.0, return_aux=True)
    np.testing.assert_allclose(out["moe/out"], np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["moe/aux"], np.asarray(aux), rtol=1e-5)
    tcfg = configs.get_config(MOE_ARCH).reduced()
    tp = from_jax_params({k: np.asarray(v) for k, v in mp.items()}, device="cpu")
    y16 = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x), capacity_factor=1.0)
    assert not np.allclose(y16.numpy(), out["moe/out"], rtol=1e-5, atol=1e-5)

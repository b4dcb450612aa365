"""The port's boundary: ``repro_torch``, ``chip_smoke.py`` and the
examples' twins (``examples/torch_*.py``) import neither JAX nor the JAX
package, nor ``msgpack`` or ``ml_dtypes`` (the card host has neither: the
port has its own wire codec and serialises bf16 through torch), and its
entry points never drop to the CPU on their own.  The twins import nothing
of ``benchmarks`` either."""
import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
SCRIPT_FILES = sorted((ROOT / "scripts").glob("*phases.py")) + \
    [ROOT / "scripts" / "dryrun_sweep_torch.py"]
EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))
EXAMPLES = ("torch_quickstart", "torch_serve_overlay", "torch_train_100m",
            "torch_dishonest_detection")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + SCRIPT_FILES + EXAMPLE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    forbidden = FORBIDDEN + (("benchmarks",) if path in EXAMPLE_FILES else ())
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in forbidden, f"{path}: {name}"


def test_every_example_has_its_twin():
    names = {p.stem for p in EXAMPLE_FILES}
    assert names == {*EXAMPLES, "torch_gt_model"}
    assert {f"torch_{p.stem}" for p in (ROOT / "examples").glob("*.py")
            if not p.stem.startswith("torch_")} <= names


def test_importing_the_examples_loads_no_jax():
    code = ("import sys\n" + "".join(f"import {p.stem}\n" for p in EXAMPLE_FILES)
            + f"bad = [m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN + ('benchmarks',)}]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(ROOT / "examples")])))


def test_importing_the_port_loads_no_jax():
    mods = [p.relative_to(ROOT / "src").with_suffix("").as_posix()
            .replace("/", ".").removesuffix(".__init__")
            for p in PORT_FILES[:-1]]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN}]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def test_entry_points_default_to_the_card():
    """Without a card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine
    cfg = configs.get_config("gentorrent-llama3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RealEngine(cfg, LM(cfg, device="cpu"), params)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_params(cfg, torch.Generator())
    from repro_torch.core.hrtree import HRTree, preprocess_batch
    from repro_torch.overlay.model_node import ModelNode
    with pytest.raises(RuntimeError, match="no CUDA card"):
        HRTree([64])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        preprocess_batch([[1] * 64], [64])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ModelNode("m0")
    from repro_torch.overlay.network import OverlayConfig, build_overlay
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_overlay(OverlayConfig())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_overlay(OverlayConfig(), model_behaviours={"m1": "drop"})
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        for name in EXAMPLES:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                importlib.import_module(name).main([])
    finally:
        sys.path.remove(str(ROOT / "examples"))


def test_the_verifier_is_checked():
    """The verification slice's module is among the files checked."""
    assert ROOT / "src" / "repro_torch" / "core" / "verification.py" in PORT_FILES

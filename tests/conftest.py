"""Collection guard: property-based test modules need ``hypothesis``
(requirements-dev.txt).  When it isn't installed, skip those modules
instead of failing the whole collection, so the deterministic tier-1
suite still runs on a bare interpreter.  Modules that declare
``hypothesis-optional`` guard the import themselves and keep their
deterministic tests collectable either way.  CI installs the dev extras
and runs everything.
"""
import importlib.util
import pathlib

collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    _here = pathlib.Path(__file__).parent
    collect_ignore = sorted(
        f.name for f in _here.glob("test_*.py")
        if ("from hypothesis" in f.read_text() or
            "import hypothesis" in f.read_text())
        and "hypothesis-optional" not in f.read_text())


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no CPU "
        "mode); the test skips itself, from a fixture, where torch sees none")

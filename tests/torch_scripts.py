"""The repo's fixture scripts, loaded as modules for the port's tests.

``scripts/make_mapsearch_fixture.py`` and ``make_front_door_fixture.py``
import no JAX at module level (only their ``main`` does), so a test that
needs their case lists or their comparisons loads them here without
pulling the JAX package in.
"""
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

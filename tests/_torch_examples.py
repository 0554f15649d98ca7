"""Helpers of the example tests (``tests/test_torch_examples_*.py``): the
reference's ``examples/*.py`` loaded as modules, the patch that lets the
reference's fused RL search run on JAX 0.9 (R1, ``ROADMAP.md`` queue 3),
and recorders that keep what the reference's calls return, so a test
compares numbers rather than printed digits.  Nothing of the reference
is edited: the recorders replace names in a loaded example's own
namespace, through ``monkeypatch``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def load_reference(name: str):
    """The reference's ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_chip_smoke():
    """``chip_smoke.py`` as a module (its imports are the standard
    library's): the tests hold its ``REF_*`` numbers, which phase 19
    checks the examples against on the card, to the reference."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patch_r1(monkeypatch) -> None:
    """R1: ``jax.experimental.enable_x64`` is gone from JAX 0.9, and the
    reference's fused ``RLScheduler`` calls it; ``jax.enable_x64(True)``
    is the same context."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def record_calls(monkeypatch, mod, name: str, **override) -> list:
    """Replace the function ``mod.<name>`` by one that calls it with
    ``override`` merged into its keyword arguments and keeps each result;
    returns the list the results go to."""
    fn, results = getattr(mod, name), []

    def call(*args, **kw):
        out = fn(*args, **{**kw, **override})
        results.append(out)
        return out

    monkeypatch.setattr(mod, name, call)
    return results


def record_instances(monkeypatch, mod, name: str, **override) -> list:
    """Replace the class ``mod.<name>`` by a subclass that is built with
    ``override`` merged into its keyword arguments and keeps each
    instance (and, for a scheduler, each ``schedule`` result as
    ``(instance, result)`` in ``made.results``)."""
    cls, made = getattr(mod, name), _Made()

    class Recorded(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kw, **override})
            made.append(self)

        if hasattr(cls, "schedule"):
            def schedule(self, *args, **kw):
                out = super().schedule(*args, **kw)
                made.results.append((self, out))
                return out

    Recorded.__name__ = cls.__name__
    monkeypatch.setattr(mod, name, Recorded)
    return made


class _Made(list):
    def __init__(self):
        super().__init__()
        self.results = []


class JitRecorder:
    """Stands in for an example module's ``jax``: every attribute is
    ``jax``'s, but ``jit`` keeps the function it is given and the first
    call's arguments and result (``calls[0]``)."""

    def __init__(self):
        import jax

        self._jax = jax
        self.fns: list = []
        self.calls: list = []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn, **kw):
        jitted = self._jax.jit(fn, **kw)
        self.fns.append(fn)

        def call(*args):
            out = jitted(*args)
            if not self.calls:
                self.calls.append((args, out))
            return out

        return call


def one_thread():
    """Run a module's torch work on one intra-op thread (a fixture body:
    the suite runs several files side by side); yields, then restores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

"""Test config: single-device jax (no XLA_FLAGS here by design — the 512-
device forcing belongs ONLY to launch/dryrun.py), small hypothesis profile.

`hypothesis` is optional: when it is not installed (minimal CI images, the
container the kernels are validated in) we register a deterministic stand-in
that runs each @given test on the strategy boundary values plus a few seeded
random draws, so property tests keep running instead of breaking collection.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "ci", max_examples=20, deadline=None,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large])
    settings.load_profile("ci")
except ModuleNotFoundError:                       # degrade, don't die
    import random
    import types

    class _Strategy:
        def __init__(self, lo, hi, draw):
            self.lo, self.hi, self._draw = lo, hi, draw

        def draw(self, rng):
            return self._draw(rng)

    def _integers(lo, hi):
        return _Strategy(lo, hi, lambda rng: rng.randint(lo, hi))

    def _floats(lo, hi, **_kw):
        return _Strategy(lo, hi, lambda rng: rng.uniform(lo, hi))

    def _given(*strats, **_kw):
        def deco(fn):
            def run():
                rng = random.Random(0)
                cases = [tuple(s.lo for s in strats),
                         tuple(s.hi for s in strats)]
                cases += [tuple(s.draw(rng) for s in strats)
                          for _ in range(6)]
                for case in cases:
                    fn(*case)
            run.__name__ = fn.__name__
            run.__doc__ = fn.__doc__
            run.__module__ = fn.__module__
            return run
        return deco

    class _Settings:
        @staticmethod
        def register_profile(*a, **k):
            pass

        @staticmethod
        def load_profile(*a, **k):
            pass

    class _HealthCheck:
        too_slow = data_too_large = None

    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _hyp.strategies = _st
    _hyp.given = _given
    _hyp.settings = _Settings
    _hyp.HealthCheck = _HealthCheck
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


# -- fleet marker ----------------------------------------------------------
# Multi-process fleet tests spawn worker processes that each pay a jit
# warm-up, which would dominate the tier-1 wall clock. They run when asked
# for explicitly: `pytest --fleet`, REPRO_FLEET=1, or a direct
# `pytest tests/test_fleet.py` invocation (the CI fleet-smoke job).

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--fleet", action="store_true", default=False,
        help="run multi-process fleet tests (@pytest.mark.fleet)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "fleet: multi-process fleet-tier test (skipped unless --fleet, "
        "REPRO_FLEET=1, or test_fleet.py is invoked directly)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels); skips without one")


def _fleet_enabled(config) -> bool:
    if config.getoption("--fleet") or os.environ.get("REPRO_FLEET") == "1":
        return True
    return any("test_fleet" in str(a) for a in config.invocation_params.args)


def pytest_collection_modifyitems(config, items):
    if _fleet_enabled(config):
        return
    skip = pytest.mark.skip(
        reason="fleet test: needs --fleet / REPRO_FLEET=1")
    for item in items:
        if "fleet" in item.keywords:
            item.add_marker(skip)


# -- fault injection -------------------------------------------------------


class _StallHandle:
    """Handle for an in-engine render stall: `entered` fires when a flush
    has called into the (wrapped) render and is now sleeping."""

    def __init__(self):
        import threading
        self.entered = threading.Event()
        self.delay_s = 0.0
        self.calls = 0


@pytest.fixture
def stall_render():
    """Artificially delay an engine's flush thread: wraps `engine._render`
    so each call signals `handle.entered`, sleeps `handle.delay_s`, then
    renders normally. Models a slow/stalled flush without touching engine
    code — used to assert deadline semantics still fire (test_serving) and
    to build slow workers (fleet tests use the protocol-level `inject` op
    instead, since the engine lives in another process)."""
    import time as _time

    patched = []

    def arm(engine, delay_s):
        handle = _StallHandle()
        handle.delay_s = float(delay_s)
        inner = engine._render

        def stalled(*a, **kw):
            handle.calls += 1
            handle.entered.set()
            _time.sleep(handle.delay_s)
            return inner(*a, **kw)

        engine._render = stalled
        patched.append((engine, inner))
        return handle

    yield arm
    for engine, inner in patched:
        engine._render = inner


@pytest.fixture
def fleet_faults():
    """Fault injectors against a live `FleetRouter`:

      * `kill(router, worker)` — SIGKILL the worker process (hard crash:
        no goodbye on the pipe, the router finds out from EOF).
      * `stall(router, worker, stall_s)` — plant a pre-flush sleep via
        the wire-level `inject` op (slow-worker, still protocol-alive).
    """
    import signal
    import types as types_lib

    def kill(router, worker):
        os.kill(router.worker_pid(worker), signal.SIGKILL)

    def stall(router, worker, stall_s):
        router.inject(worker, stall_s=float(stall_s))

    return types_lib.SimpleNamespace(kill=kill, stall=stall)

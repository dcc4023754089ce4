"""Debug-mode runtime lock-order assertion. The port's own copy of
`repro/obs/lockdebug.py` (stdlib only), the dynamic complement to the
repo lint's static ``lock-order`` rule (docs/static_analysis.md).

Every lock in the port's serving stack is created through
:func:`make_lock`. With ``REPRO_LOCK_DEBUG`` unset (the default) it returns
a plain ``threading.Lock``/``RLock``: zero overhead. With
``REPRO_LOCK_DEBUG=1`` it returns a tracking wrapper that records the
process-global acquisition-order graph (label held -> label acquired) and
raises :class:`LockOrderError` *before* blocking when an acquisition would
invert an order already observed, so a rare deadlock becomes a
deterministic test failure.

Labels are stable strings ("engine", "engine.render", "store",
"obs.metric", ...); instances sharing a label share ordering constraints.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple, Union

__all__ = ["make_lock", "LockOrderError", "enabled", "reset", "edges"]


class LockOrderError(RuntimeError):
    """Acquisition order inverted against the recorded global order."""


_graph_lock = threading.Lock()
# (held_label, acquired_label) -> thread name that first recorded it
_edges: Dict[Tuple[str, str], str] = {}
_tls = threading.local()


def enabled() -> bool:
    return os.environ.get("REPRO_LOCK_DEBUG") == "1"


def _held_stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def reset() -> None:
    """Forget the recorded order graph (tests start from a clean slate)."""
    with _graph_lock:
        _edges.clear()
    _tls.stack = []


def edges() -> Dict[Tuple[str, str], str]:
    with _graph_lock:
        return dict(_edges)


class _TrackedLock:
    """Lock/RLock wrapper recording acquisition order by label."""

    def __init__(self, label: str, inner, reentrant: bool):
        self._label = label
        self._inner = inner
        self._reentrant = reentrant

    # -- ordering bookkeeping ---------------------------------------------

    def _check_and_note(self) -> None:
        st = _held_stack()
        if self._label in st:
            if not self._reentrant:
                raise LockOrderError(
                    f"reentrant acquire of non-reentrant lock "
                    f"'{self._label}' (held: {st})")
            return  # reentrant re-acquire adds no ordering edges
        me = threading.current_thread().name
        with _graph_lock:
            for held in st:
                if (self._label, held) in _edges:
                    first = _edges[(self._label, held)]
                    raise LockOrderError(
                        f"lock-order inversion: acquiring '{self._label}' "
                        f"while holding '{held}', but thread '{first}' "
                        f"previously acquired '{held}' while holding "
                        f"'{self._label}' (held: {st})")
            for held in st:
                _edges.setdefault((held, self._label), me)

    # -- Lock API ----------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_and_note()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self._label)
        return got

    def release(self) -> None:
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self._label:
                del st[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # -- threading.Condition duck-typed hooks ------------------------------
    # Condition(lock) lifts these if present; they must keep the held
    # stack honest across wait()'s release/reacquire cycle.

    def _release_save(self):
        st = _held_stack()
        n = 0
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self._label:
                del st[i]
                n += 1
        return (self._inner._release_save(), n)

    def _acquire_restore(self, saved) -> None:
        inner_state, n = saved
        self._inner._acquire_restore(inner_state)
        _held_stack().extend([self._label] * n)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def make_lock(label: str, kind: str = "lock"
              ) -> Union[threading.Lock, threading.RLock, _TrackedLock]:
    """A lock for the serving stack. ``kind`` is "lock" or "rlock".

    Plain stdlib lock unless ``REPRO_LOCK_DEBUG=1``, in which case the
    returned wrapper asserts global acquisition order under ``label``."""
    if kind not in ("lock", "rlock"):
        raise ValueError(f"unknown lock kind {kind!r}")
    reentrant = kind == "rlock"
    inner = threading.RLock() if reentrant else threading.Lock()
    if not enabled():
        return inner
    return _TrackedLock(label, inner, reentrant)

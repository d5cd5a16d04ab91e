"""Phase tracing: named spans over codec phases.

The reference's observability is level-5 "trace" log lines in hot paths
(mtscomp.py:154, 336, 392) plus tqdm bars. Here each phase is a context
manager that (a) logs duration at the trace level, (b) emits a
``jax.profiler.TraceAnnotation`` so device work shows up named in XLA
profiles, and (c) feeds an in-process aggregator queryable via
:func:`phase_stats` — enable with ``MTSCOMP_TRACE=1`` or
:func:`enable_tracing`. :func:`count` adds event counters (which route
encoded or decoded each chunk) to the same aggregator.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict

from .misc import logger, TRACE

_enabled = os.environ.get('MTSCOMP_TRACE', '') not in ('', '0')
_lock = threading.Lock()
_stats = defaultdict(lambda: [0, 0.0])      # name -> [count, seconds]


def enable_tracing(on=True):
    global _enabled
    _enabled = bool(on)
    if _enabled and logger.getEffectiveLevel() > TRACE:
        # Phase durations log at the sub-DEBUG trace level; tracing is
        # an explicit opt-in, so make those records pass the logger.
        logger.setLevel(TRACE)


if _enabled and logger.getEffectiveLevel() > TRACE:
    logger.setLevel(TRACE)


def reset_stats():
    with _lock:
        _stats.clear()


def phase_stats():
    """{phase: (count, total_seconds)} accumulated since reset."""
    with _lock:
        return {k: tuple(v) for k, v in _stats.items()}


def count(name, n=1):
    """Add ``n`` to counter ``name`` (no-op unless tracing is enabled).

    Counters share the :func:`phase_stats` aggregator with zero
    seconds, so ``phase_stats()[name][0]`` reads them back.
    """
    if not _enabled:
        return
    with _lock:
        _stats[name][0] += n


@contextlib.contextmanager
def phase(name):
    """Trace one phase (no-op unless tracing is enabled)."""
    if not _enabled:
        yield
        return
    ann = None
    try:
        from jax.profiler import TraceAnnotation
        ann = TraceAnnotation(name)
        ann.__enter__()
    except Exception:  # pragma: no cover - jax absent or headless
        ann = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        with _lock:
            s = _stats[name]
            s[0] += 1
            s[1] += dt
        logger.log(TRACE, "phase %s: %.3f ms", name, dt * 1e3)

"""Tracing / profiling / debug utilities.

The reference has no profiling or sanitizers (SURVEY §5 — its only pacing is
the viewer's 60 fps sleep). Equivalents here:

  * ``trace(...)`` — jax.profiler trace context writing a TensorBoard-
    compatible trace (open with xprof/perfetto);
  * ``annotate(name)`` — named TraceAnnotation around march/shade/composite
    regions so kernels show up labeled in the trace;
  * ``timed_step(fn)`` — step timer for rays/s reporting, synchronized by
    fetching a scalar result;
  * ``debug_mode()`` — enables jax_debug_nans + disables x64 surprises; the
    Pallas kernels also accept interpret=True for interpreter-mode
    verification on the CPU (the race-detector analog for kernel code).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: with trace('/tmp/trace'): step(...)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named annotation context for profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def timed_step(fn: Callable, *args, iters: int = 10, warmup: int = 2,
               sync_output=None, **kwargs) -> float:
    """Best-of-iters wall time of ``fn(*args)`` with a host-fetch sync.

    Returns seconds per call. ``sync_output`` selects which output to fetch
    (callable applied to fn's result; defaults to the result itself).
    """
    pick = sync_output or (lambda r: r)
    for _ in range(warmup):
        np.asarray(jax.tree.leaves(pick(fn(*args, **kwargs)))[0])
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        np.asarray(jax.tree.leaves(pick(fn(*args, **kwargs)))[0])
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def debug_mode():
    """NaN-checking context (jax_debug_nans re-runs the failing primitive
    un-jitted and raises with its location)."""
    prev = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)

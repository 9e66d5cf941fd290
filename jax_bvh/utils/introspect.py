"""Compiled-program introspection & profiling hooks.

The reference exposes per-kernel register/shared-memory counts
(`Kernel::getNumSmem/getNumRegs`, `src/Kernel.cpp:170-182`)
and GPU-event timings. The XLA equivalents: compiled cost analysis (flops,
bytes accessed, memory footprint) per jitted function, and
`jax.profiler` traces.
"""
from __future__ import annotations

import contextlib

import jax


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Compile fn for the current backend and return XLA's cost analysis
    (flops, bytes accessed, optimal seconds, ...)."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    stats = compiled.cost_analysis()
    if isinstance(stats, list):  # older jax returns one dict per computation
        stats = stats[0] if stats else {}
    return dict(stats or {})


def memory_analysis(fn, *args, **kwargs):
    """Compiled memory footprint (bytes) if the backend reports it."""
    compiled = jax.jit(fn).lower(*args, **kwargs).compile()
    try:
        return compiled.memory_analysis()
    except Exception:  # noqa: BLE001
        return None


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """`jax.profiler` trace context — the rebuild's analog of the
    reference's oroEvent phase timing, but with full per-op visibility."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

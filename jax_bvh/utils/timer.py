"""Phase timer — the reference's GPU-event timing as host wall timing
around `block_until_ready`, plus optional jax.profiler traces.

Mirrors `Timer::measure` (`src/Timer.h:31-73`) and the
`TimerCodes` tokens (`Common.h:418-427`); times accumulate per token across
calls (the reference's `+=`), and `report()` prints the same perf block the
builders print (`TwoPassLbvh.cpp:300-310`) with "Total" = extents + morton
+ sort + build.
"""
from __future__ import annotations

import contextlib
import enum
import time
from collections import defaultdict

import jax


class TimerCodes(enum.Enum):
    CALCULATE_CENTROID_EXTENTS = "CalculateCentroidExtentsTime"
    CALCULATE_MORTON_CODES = "CalculateMortonCodesTime"
    SORTING = "SortingTime"
    BVH_BUILD = "BvhBuildTime"
    TRAVERSAL = "TraversalTime"
    COLLAPSE_BVH = "CollapseBvhTime"
    RAY_GEN = "RayGenTime"


_TOTAL_TOKENS = (
    TimerCodes.CALCULATE_CENTROID_EXTENTS,
    TimerCodes.CALCULATE_MORTON_CODES,
    TimerCodes.SORTING,
    TimerCodes.BVH_BUILD,
)


class Timer:
    def __init__(self) -> None:
        self._ms: dict[TimerCodes, float] = defaultdict(float)

    def measure(self, token: TimerCodes, fn, *args, **kwargs):
        """Run fn, block on its outputs, accumulate elapsed ms under token."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self._ms[token] += (time.perf_counter() - t0) * 1e3
        return out

    @contextlib.contextmanager
    def span(self, token: TimerCodes):
        t0 = time.perf_counter()
        yield
        self._ms[token] += (time.perf_counter() - t0) * 1e3

    def ms(self, token: TimerCodes) -> float:
        return self._ms[token]

    @property
    def total_ms(self) -> float:
        """extents + morton + sort + build, the reference's 'Total Time'
        accounting (collapse/traversal excluded, `TwoPassLbvh.cpp:308-309`)."""
        return sum(self._ms[t] for t in _TOTAL_TOKENS)

    def report(self) -> str:
        lines = ["==========================Perf Times=========================="]
        for token in TimerCodes:
            if token in self._ms:
                lines.append(f"{token.value} : {self._ms[token]:.3f}ms")
        lines.append(f"Total Time : {self.total_ms:.3f}ms")
        lines.append("==============================================================")
        return "\n".join(lines)

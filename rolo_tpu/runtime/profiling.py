"""Per-stage timing + device tracing.

The reference's observability is printf wall-clock timing around the
solvers (src/lidarOdometry.cpp:449-498, scancontext tictoc.h) and
solve_time_ms in SolverResult. This module makes those structured: stage
timers the SlamSystem records every scan, and a jax.profiler context for
full device traces (SURVEY.md section 5).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np


class StageTimers:
    """Accumulates wall-clock samples per pipeline stage.

    Under the async pipeline driver (runtime/slam.py) most stages time
    DISPATCH only — the host enqueues device work and moves on; stages
    without a `sync` argument therefore understate device execution cost.
    `wall_s` / scans_per_s in SequenceResult remain truthful end-to-end
    numbers. For device-true per-stage costs set SlamSystem.sync_stages
    (tools/bench_pipeline.py --synced) or take a profiler trace."""

    def __init__(self) -> None:
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a stage; pass `sync` (e.g. a device array or
        jax.block_until_ready-able pytree getter) to include device time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import jax

                jax.block_until_ready(sync() if callable(sync) else sync)
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def reset(self) -> None:
        """Drop accumulated samples (e.g. to exclude compile-heavy warmup
        scans from a steady-state measurement)."""
        self._samples.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {count, mean_ms, p50_ms, p95_ms, max_ms, total_s}}."""
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':24s} {'count':>7s} {'mean':>9s} {'p95':>9s} {'total':>9s}"]
        for name, s in rows:
            lines.append(
                f"{name:24s} {s['count']:7d} {s['mean_ms']:7.2f}ms {s['p95_ms']:7.2f}ms {s['total_s']:8.2f}s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace wrapper (no-op when log_dir is None). View with
    tensorboard / xprof."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield

"""Per-stage timing report (reference Timing_Statistics,
include/Stereo_Matches.h:32-47 - whose instrumentation is entirely
commented out; here it works).

Device programs are asynchronous: host-side wall timing of a jitted call
measures dispatch unless the result is blocked on. `StageTimer.timed`
blocks on the stage output, so stage times are end-to-end wall clock
(including device execution). For kernel-level breakdowns use
`jax.profiler.trace` and inspect the HLO profile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import jax


@dataclasses.dataclass
class StageTimer:
    """Accumulates per-stage wall times across frames."""

    times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its output, record the wall time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = jax.block_until_ready(out)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = [f"{'Stage':>28} | {'mean ms':>10} | {'total s':>9} | {'n':>5}"]
        total = 0.0
        for name, ts in self.times.items():
            mean = sum(ts) / len(ts)
            tot = sum(ts)
            total += tot
            lines.append(f"{name:>28} | {mean * 1e3:>10.3f} | {tot:>9.3f} | "
                         f"{len(ts):>5}")
        lines.append(f"{'TOTAL':>28} | {'':>10} | {total:>9.3f} |")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace wrapper - open with TensorBoard or xprof
    (the replacement for the reference's omp_get_wtime spans,
    src/toed/cpu_toed.cpp:164-368)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

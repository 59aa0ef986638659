"""Lightweight phase profiler.

Reference: Utils/Profiler.{h,cpp} — named start/stop scoped timers whose
percent-of-total table prints periodically (Learner.cpp:135-145). The
reference wraps every serving/training phase (keys DATA/SAMP/FWD/CMP/BCK/
ADDW/GRAD/MPI/PRE/FILTER/FIND/STAT/LOSS); here whole phases fuse into
single XLA programs, so the equivalent granularity is: ROLL (acting +
ingest), TRAIN (grad chunk), REFRESH (1000-step sweeps), HOST (everything
else). jax.profiler traces remain available for op-level views.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Profiler:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._open = {}

    def start(self, name: str):
        self._open[name] = time.perf_counter()

    def stop(self, name: str):
        t0 = self._open.pop(name, None)
        if t0 is not None:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @contextmanager
    def __call__(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def table(self) -> str:
        """Percent-of-total table (Profiler::printStatAndReset analog)."""
        total = sum(self.totals.values()) or 1.0
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"  {k:>8s}: {v:8.3f}s {100 * v / total:5.1f}%"
                 f" ({self.counts[k]} calls)" for k, v in rows]
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()

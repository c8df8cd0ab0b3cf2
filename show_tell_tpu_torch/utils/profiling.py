"""Per-stage wall-clock accounting (counterpart of
show_tell_tpu/utils/profiling.py's ``StepTimer``).  The loop's device
trace is ``torch.profiler`` (train/loop.py, ``profile_dir``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class StepTimer:
    """Host-clock seconds per named stage (data / step), summed per epoch."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, samples in self._times.items():
            n = len(samples)
            total = sum(samples)
            out[name] = {
                "count": n,
                "total_s": total,
                "mean_ms": total / n * 1e3 if n else 0.0,
                "last_ms": samples[-1] * 1e3 if samples else 0.0,
            }
        return out

    def reset(self) -> None:
        self._times.clear()

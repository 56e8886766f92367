"""Phase timing (the `PhaseTimer` of `streamchat_tpu/utils/profiling.py`).

  timer = PhaseTimer()
  with timer.phase("ingest"): ...
  timer.totals  # {"ingest": s}

Host wall-clock per named phase. A phase that ends in device work measures
the device only if the caller synchronises inside the window (the runner
does, through `synchronize`, so phase totals are true on a GPU).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional


class PhaseTimer:
    def __init__(self, synchronize: Optional[Callable[[], None]] = None) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._sync = synchronize

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

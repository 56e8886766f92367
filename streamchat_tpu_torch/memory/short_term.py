"""Short-term visual memory of the on-line session: an Ebbinghaus-weighted
FIFO over recent frames (`streamchat_tpu/memory/short_term.py`).

Keeps the last `short_window` frame features [P, D] across the stream and
samples `remember_window` of them without replacement with retention
probabilities exp(-t / tau) normalized over the window
(`ops/forgetting.select_short_memory`).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List

import torch

from streamchat_tpu_torch.ops.forgetting import select_short_memory


class ShortTermMemory:
    """Fixed-capacity FIFO of per-frame features [P, D]."""

    def __init__(self, short_window: int, remember_window: int, tau: float) -> None:
        if remember_window > short_window:
            raise ValueError("remember_window cannot exceed short_window")
        self.short_window = short_window
        self.remember_window = remember_window
        self.tau = tau
        self._buf: Deque[torch.Tensor] = deque(maxlen=short_window)

    def extend(self, frame_features: torch.Tensor) -> None:
        """Append frames [N, P, D]; the oldest beyond short_window drop out."""
        for i in range(frame_features.shape[0]):
            self._buf.append(frame_features[i])

    def __len__(self) -> int:
        return len(self._buf)

    def sample(self, generator: torch.Generator | None = None) -> torch.Tensor:
        """remember_window frames -> [R, P, D] in temporal order; the whole
        buffer when it holds no more than remember_window frames."""
        if not self._buf:
            raise ValueError("short-term memory is empty")
        window = torch.stack(list(self._buf))                  # [W, P, D]
        if window.shape[0] <= self.remember_window:
            return window
        return select_short_memory(window, self.remember_window, self.tau,
                                   generator=generator)

    def features(self) -> List[torch.Tensor]:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()

"""The benchmark's video: RGB uint8 frames made from the seed, served
through a reader object with the interface the program reads
(`frame_rate`, `total_frames`, `read_frames(indices)`).

Set-up makes a few scenes (coarse random blocks with fine noise over
them). Frame i shows scene (i // scene_frames) % scenes, shifted by
`drift_px` pixels a frame across and half that down, so frames of one
segment differ a little and segments differ a lot: k-means and the
short-memory selection see structure. A frame is a function of the seed
and its index alone, so the reference makes the same frame again.
`cache` makes the frames of given reads in set-up, so that reading them
in the window takes no host time (making a 720p segment takes ~50 ms of
the interpreter, which the decode loop on the main thread would wait
for).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from portbench.seeds import subseed


class SyntheticVideo:
    def __init__(self, spec: dict, seed: int) -> None:
        self.width, self.height = int(spec["width"]), int(spec["height"])
        self.frame_rate = float(spec["fps"])
        self.total_frames = int(spec["total_frames"])
        self.scene_frames = int(spec["scene_frames"])
        self.drift_px = int(spec["drift_px"])
        rng = np.random.default_rng(subseed(seed, "video"))
        block = int(spec["block_px"])
        scenes: List[np.ndarray] = []
        for _ in range(int(spec["scenes"])):
            coarse = rng.integers(0, 256, (-(-self.height // block), -(-self.width // block), 3),
                                  dtype=np.uint8)
            img = np.repeat(np.repeat(coarse, block, 0), block, 1)[:self.height, :self.width]
            noise = rng.integers(0, 32, img.shape, dtype=np.uint8)
            scenes.append((img // 8 * 7 + noise).astype(np.uint8))
        self._scenes = scenes
        self._cached: Dict[tuple, np.ndarray] = {}

    def frame(self, i: int) -> np.ndarray:
        scene = self._scenes[(i // self.scene_frames) % len(self._scenes)]
        step = i % self.scene_frames
        return np.roll(scene, (step * self.drift_px // 2, step * self.drift_px), axis=(0, 1))

    def cache(self, reads: Sequence[Sequence[int]]) -> None:
        for indices in reads:
            self._cached[tuple(indices)] = self._make(indices)

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        hit = self._cached.get(tuple(indices))
        return hit if hit is not None else self._make(indices)

    def _make(self, indices: Sequence[int]) -> np.ndarray:
        out = np.empty((len(indices), self.height, self.width, 3), np.uint8)
        for k, i in enumerate(indices):
            out[k] = self.frame(int(i))
        return out

    def close(self) -> None:
        pass

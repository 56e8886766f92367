"""AnyRes image preprocessing for high-resolution single images.

Rebuild of the reference's anyres helpers (`longva/mm_utils.py:213-311`):
pick the best grid resolution for an image, resize-and-pad into it, divide
into base-size tiles, and prepend the base-resolution overview. The video
pipeline never uses these (frames are plain-resized); they exist for
image-mode prompts (image_aspect_ratio="anyres" in LongVA's config).

Numpy in / numpy out: [H, W, 3] uint8 -> [num_tiles + 1, 3, base, base]
float32, normalized, via the same preprocessing as the frame path.

A copy of `streamchat_tpu/pipeline/anyres.py` whose host preprocessing is
the port's `native/frameproc` (the same C++ source); cv2 resizes, as there.
"""

from __future__ import annotations

import ast
import re
from typing import List, Sequence, Tuple

import numpy as np


def parse_grid_pinpoints(grid_pinpoints, patch_size: int) -> List[List[int]]:
    """Resolve "(AxB)...(CxD)" range strings or literal lists to pixel
    resolutions (mm_utils.py:226-236)."""
    if isinstance(grid_pinpoints, str) and "x" in grid_pinpoints:
        matches = re.findall(r"\((\d+)x(\d+)\)", grid_pinpoints)
        start = tuple(map(int, matches[0]))
        end = tuple(map(int, matches[-1]))
        pins = [
            (i, j)
            for i in range(start[0], end[0] + 1)
            for j in range(start[1], end[1] + 1)
        ]
        return [[d * patch_size for d in p] for p in pins]
    if isinstance(grid_pinpoints, list):
        return grid_pinpoints
    return ast.literal_eval(grid_pinpoints)


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: Sequence[Sequence[int]]
) -> Tuple[int, int]:
    """Resolution maximizing effective pixels then minimizing waste
    (mm_utils.py select_best_resolution)."""
    ow, oh = original_size
    best = None
    max_effective = 0
    min_waste = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        waste = w * h - effective
        if effective > max_effective or (
            effective == max_effective and waste < min_waste
        ):
            max_effective = effective
            min_waste = waste
            best = (w, h)
    return best


def resize_and_pad(image: np.ndarray, target: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving resize into (w, h), centered zero padding."""
    import cv2

    th_w, th_h = target
    h, w = image.shape[:2]
    scale = min(th_w / w, th_h / h)
    nw, nh = int(w * scale), int(h * scale)
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_CUBIC)
    out = np.zeros((th_h, th_w, 3), image.dtype)
    top = (th_h - nh) // 2
    left = (th_w - nw) // 2
    out[top : top + nh, left : left + nw] = resized
    return out


def divide_to_patches(image: np.ndarray, tile: int) -> List[np.ndarray]:
    """Row-major base-size tiles (mm_utils.py divide_to_patches)."""
    h, w = image.shape[:2]
    return [
        image[i : i + tile, j : j + tile]
        for i in range(0, h, tile)
        for j in range(0, w, tile)
    ]


def process_anyres_image(
    image: np.ndarray, grid_pinpoints, base_size: int = 336
) -> np.ndarray:
    """[H, W, 3] uint8 -> [1 + tiles, 3, base, base] f32 normalized.

    Order matches the reference (mm_utils.py:288-295): the base-resolution
    overview FIRST, then the grid tiles. The overview uses a plain square
    resize (the reference's own FIXME notes it resizes instead of pads;
    behavior kept).
    """
    import cv2

    from streamchat_tpu_torch.native.frameproc import preprocess_frames_host

    pins = parse_grid_pinpoints(grid_pinpoints, base_size)
    h, w = image.shape[:2]
    best = select_best_resolution((w, h), pins)
    padded = resize_and_pad(image, best)
    tiles = divide_to_patches(padded, base_size)
    overview = cv2.resize(image, (base_size, base_size), interpolation=cv2.INTER_CUBIC)
    batch = np.stack([overview] + tiles)
    return preprocess_frames_host(batch, base_size)


def get_anyres_image_grid_shape(
    image_size: Tuple[int, int], grid_pinpoints, patch_size: int
) -> Tuple[int, int]:
    """(grid_w, grid_h) in tiles for the chosen resolution (mm_utils.py:213-241)."""
    pins = parse_grid_pinpoints(grid_pinpoints, patch_size)
    w, h = select_best_resolution(image_size, pins)
    return w // patch_size, h // patch_size

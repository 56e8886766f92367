"""CLIP image preprocessing on the device (`streamchat_tpu/pipeline/preprocess.py`).

uint8 RGB [N, H, W, 3] -> shortest-edge bicubic resize (antialiased) ->
center crop -> rescale -> OpenAI CLIP mean/std normalize -> [N, 3, S, S]
float32. PyTorch's antialiased bicubic uses the Keys a = -0.5 kernel with
renormalized edge weights, the kernel `jax.image.resize(..., antialias=True)`
uses; its non-antialiased bicubic (a = -0.75, clamped edges) would not match.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_frames(frames, image_size: int = 336, device=None) -> torch.Tensor:
    """uint8 RGB [N, H, W, 3] (numpy or tensor) -> normalized [N, 3, S, S] f32."""
    x = torch.as_tensor(np.asarray(frames) if not isinstance(frames, torch.Tensor)
                        else frames, device=device)
    n, h, w, _ = x.shape
    x = x.permute(0, 3, 1, 2).float() / 255.0
    if h <= w:
        nh, nw = image_size, max(image_size, int(round(w * image_size / h)))
    else:
        nh, nw = max(image_size, int(round(h * image_size / w))), image_size
    if (nh, nw) != (h, w):
        x = torch.nn.functional.interpolate(x, size=(nh, nw), mode="bicubic",
                                            align_corners=False, antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size]
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return ((x - mean) / std).clamp(-10.0, 10.0).contiguous()

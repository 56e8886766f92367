"""Lucas-Kanade optical flow scene-change test (`streamchat_tpu/ops/optical_flow.py`).

The reference's pixel-space keep / drop test: Sobel gradients of the
previous frame, the temporal difference, the 2x2 normal equations of each
window solved in closed form (adjugate over determinant), and a frame kept
when the mean flow magnitude passes a threshold. Batched over frame pairs.
As in the JAX package the magnitude is sqrt(u^2 + v^2); `u_only=True`
gives the reference's sqrt(u^2 + u^2).

Plain PyTorch (the JAX package leaves it to XLA), in f32 (float64 inputs
stay float64, for a host reference). The Sobel filters and the window
sums are shifted adds, never convolutions: a cuDNN
convolution may run in TF32 under the global `allow_tf32` flags, and these
ill-conditioned 2x2 solves would carry its rounding into the flow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
RGB_WEIGHTS = (0.2989, 0.5870, 0.1140)


def _real(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def grayscale(frames: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] -> [N, H, W] (the reference's luma weights)."""
    frames = _real(frames)
    w = torch.tensor(RGB_WEIGHTS, dtype=torch.float32, device=frames.device)
    return torch.einsum("nchw,c->nhw", frames, w.to(frames.dtype))


def _filter3(img: torch.Tensor, kernel) -> torch.Tensor:
    """[N, H, W] cross-correlated with a 3x3 kernel, zero-padded ("SAME")."""
    n, h, w = img.shape
    pad = F.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for dy, row in enumerate(kernel):
        for dx, k in enumerate(row):
            if k:
                out = out + k * pad[:, dy:dy + h, dx:dx + w]
    return out


def compute_gradients(img: torch.Tensor):
    """Sobel Ix, Iy of [N, H, W] (zero-padded, same size)."""
    img = _real(img)
    return _filter3(img, SOBEL_X), _filter3(img, SOBEL_Y)


def _window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """[N, H, W] -> [N, H-w+1, W-w+1]: each valid w x w window's sum."""
    n, h, wd = x.shape
    oh, ow = h - w + 1, wd - w + 1
    out = torch.zeros(n, oh, ow, dtype=x.dtype, device=x.device)
    for dy in range(w):
        for dx in range(w):
            out = out + x[:, dy:dy + oh, dx:dx + ow]
    return out


def flow_magnitude(last: torch.Tensor, current: torch.Tensor, *, window_size: int = 5,
                   u_only: bool = False) -> torch.Tensor:
    """Mean LK flow magnitude per pair: grayscale [N, H, W] x 2 -> [N].

    Solves each window's (A^T A + eps I) nu = A^T b, with A = [Ix | Iy]
    and b = -It, in closed form."""
    eps = 1e-6
    last, current = _real(last), _real(current)
    ix, iy = compute_gradients(last)
    it = current - last
    a = _window_sum(ix * ix, window_size) + eps
    b = _window_sum(ix * iy, window_size)
    c = _window_sum(iy * iy, window_size) + eps
    r1 = -_window_sum(ix * it, window_size)
    r2 = -_window_sum(iy * it, window_size)
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    u = (c * r1 - b * r2) / det
    v = (a * r2 - b * r1) / det
    mag = torch.sqrt(u * u + (u * u if u_only else v * v))
    return mag.mean(dim=(1, 2))


def keep_frames_optical_flow(frames_gray: torch.Tensor, threshold: float,
                             window_size: int = 5) -> torch.Tensor:
    """Keep mask [N] (bool) over a grayscale sequence [N, H, W]: each frame
    against the one before it (the anchor advances every frame, kept or
    not, as in the reference); frame 0 is always kept."""
    mags = flow_magnitude(frames_gray[:-1], frames_gray[1:], window_size=window_size)
    first = torch.ones(1, dtype=torch.bool, device=frames_gray.device)
    return torch.cat([first, mags > threshold])

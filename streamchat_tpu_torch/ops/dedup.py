"""Selective frame stacking: scene-change dedup over frame features (K12),
with its plain twin (`streamchat_tpu/ops/dedup.py`).

Frame i is kept iff 1 - cos(x_i, x_{i-1}) > threshold over pooled per-frame
descriptors x [N, D]; frame 0 is always kept (its score compares it with
row N - 1, as the TPU kernel's roll wraps). `select_changed_frames` launches
`csrc/dedup.cu` on a CUDA tensor (f32 or bf16 descriptors, any D; one
block a row, 16-byte loads where `launch_plan` allows them) and runs
`select_changed_frames_plain` on a CPU tensor. `frame_descriptors` (the f32
mean over patches) and `ssim_pairs` (a pixel-space score) are plain PyTorch,
as they are plain XLA outside the Pallas call there.
"""

from __future__ import annotations

import torch

from streamchat_tpu_torch.kernels import counted, launched

# The card's kernel (csrc/dedup.cu): one block of THREADS a row, UNROLL
# vectors of each row in flight a thread and pass.
THREADS, UNROLL = 256, 4


def launch_plan(n: int, d: int, itemsize: int, aligned: bool = True) -> dict:
    """The K12 kernel's launch for descriptors [n, d] of `itemsize` bytes ->
    {"vec", "blocks", "passes"}.

    vec: 16-byte loads, only when every row starts on a 16-byte boundary
    (d * itemsize % 16 == 0 and an aligned base); otherwise the kernel's
    scalar loop. One block a row; `passes` round trips of UNROLL loads a
    thread and row cover it."""
    if n < 1 or d < 1:
        raise ValueError(f"select_changed_frames: expected [N >= 1, D >= 1], got [{n}, {d}]")
    vec = aligned and (d * itemsize) % 16 == 0
    v = 16 // itemsize if vec else 1
    return {"vec": vec, "blocks": n, "passes": -(-d // (THREADS * v * UNROLL))}


def _keep(sim: torch.Tensor, threshold: float) -> torch.Tensor:
    keep = (1.0 - sim) > threshold
    keep[0] = True
    return keep


def select_changed_frames_plain(features: torch.Tensor, *, threshold: float = 0.18,
                                return_similarity: bool = False):
    """Plain PyTorch twin of `select_changed_frames` (same signature): the
    TPU kernel's body, rows normalized by rsqrt(sum x^2 + 1e-8) and each
    multiplied by the row before it (row 0 by row N - 1)."""
    x = features.float()
    xn = x * torch.rsqrt((x * x).sum(1, keepdim=True) + 1e-8)
    sim = (xn * torch.roll(xn, 1, 0)).sum(1)
    keep = _keep(sim, threshold)
    return (keep, sim) if return_similarity else keep


@counted
def select_changed_frames(features: torch.Tensor, *, threshold: float = 0.18,
                          return_similarity: bool = False):
    """Keep mask [N] bool for frame descriptors [N, D] (K12); with
    `return_similarity` also the scores sim [N] f32, keep = 1 - sim >
    threshold but keep[0] = True.

    threshold plays the role of the reference's optical-flow magnitude
    threshold: larger keeps fewer frames. CPU tensors run the plain twin;
    CUDA tensors (f32 or bf16, N >= 1) launch the kernel or raise.
    """
    if features.device.type == "cpu":
        return select_changed_frames_plain(features, threshold=threshold,
                                           return_similarity=return_similarity)
    from streamchat_tpu_torch.kernels.build import call

    if features.dim() != 2 or features.shape[0] == 0:
        raise ValueError(f"select_changed_frames: expected [N >= 1, D], got "
                         f"{tuple(features.shape)}")
    dtypes = {torch.bfloat16: 0, torch.float32: 1}
    if features.dtype not in dtypes:
        raise ValueError(f"select_changed_frames: expected f32 or bf16, got {features.dtype}")
    x = features.contiguous()
    n, d = x.shape
    plan = launch_plan(n, d, x.element_size(), aligned=x.data_ptr() % 16 == 0)
    sim = torch.empty(n, dtype=torch.float32, device=x.device)
    call("sc_select_changed_frames", x.data_ptr(), dtypes[x.dtype], int(plan["vec"]),
         sim.data_ptr(), n, d, torch.cuda.current_stream().cuda_stream)
    launched(select_changed_frames)
    keep = _keep(sim, threshold)
    return (keep, sim) if return_similarity else keep


def frame_descriptors(patch_features: torch.Tensor) -> torch.Tensor:
    """[N, P, D] patch features -> [N, D] f32 per-frame descriptors."""
    return patch_features.float().mean(1)


def ssim_pairs(frames_a: torch.Tensor, frames_b: torch.Tensor) -> torch.Tensor:
    """Global-statistics SSIM between grayscale frame batches [N, H, W]
    (means and variances over each whole frame, not an 11x11 window)."""
    a, b = frames_a.float(), frames_b.float()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mu_a, mu_b = a.mean((1, 2)), b.mean((1, 2))
    var_a = a.var((1, 2), unbiased=False)
    var_b = b.var((1, 2), unbiased=False)
    cov = ((a - mu_a[:, None, None]) * (b - mu_b[:, None, None])).mean((1, 2))
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))

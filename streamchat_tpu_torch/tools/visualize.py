"""Memory-feature and benchmark-distribution visualization.

* `visualize_memory_features` — parity for the reference's
  `visualize_memory_feature_with_PCA` (utiles.py, called from the uni-modal
  answer path while debugging): project frame-bank features and the
  retrieved memory centroids to 2D with PCA and plot which frames the
  memory kept. Pure numpy SVD; matplotlib only at save time.
* `plot_duration_histogram` / `plot_class_pie` / `plot_category_sunburst` —
  parity for the reference's benchmark-distribution tooling
  (tools/static.py video_time_distribution_histogram + pie chart,
  tools/draw_sun_pic.py's plotly sunburst rendered here as a matplotlib
  nested two-ring pie). Driven from `tools/streambench.py plots` over
  `annotation_stats` output instead of hard-coded counts.

All plotting is headless-safe: matplotlib uses the Agg backend and an
ImportError degrades to a no-op (the computed data is still returned).

A copy of `streamchat_tpu/tools/visualize.py` whose feature inputs may be
torch tensors (on any device, in any float dtype) or numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _np(x) -> np.ndarray:
    """A numpy array of a torch tensor (to the host, bf16 as float32) or of
    anything numpy takes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def pca_project(x, dims: int = 2) -> np.ndarray:
    """[N, D] -> [N, dims] principal-component projection."""
    x = np.asarray(_np(x), np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    # SVD of the (N, D) matrix; columns of V are principal axes.
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return (x @ vt[:dims].T).astype(np.float32)


def visualize_memory_features(
    feature_bank: Sequence,                 # [T] of [P, D] frame features
    memory_features: Optional[Sequence] = None,   # [K] of [Kc, P, D] centroids
    save_path: str = "memory_pca.png",
) -> np.ndarray:
    """PCA scatter of per-frame descriptors with retrieved memory overlaid.

    Returns the projected frame coordinates; writes a PNG when matplotlib is
    importable (headless-safe no-op otherwise).
    """
    frames = np.stack([_np(f).mean(axis=0).reshape(-1) for f in feature_bank])
    mems = None
    if memory_features:
        mems = np.stack([
            _np(m).reshape(-1, frames.shape[-1]).mean(axis=0)
            for m in memory_features
        ])
        allpts = np.concatenate([frames, mems], axis=0)
    else:
        allpts = frames
    proj = pca_project(allpts)
    frame_xy = proj[: len(frames)]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        # Plotting is optional; the projection is still returned. Real save
        # errors (bad path, disk full) below DO propagate.
        return frame_xy
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.scatter(frame_xy[:, 0], frame_xy[:, 1],
               c=np.arange(len(frames)), cmap="viridis", s=12,
               label="frames (time-colored)")
    if mems is not None:
        mem_xy = proj[len(frames):]
        ax.scatter(mem_xy[:, 0], mem_xy[:, 1], marker="x", c="red",
                   s=60, label="memory centroids")
    ax.legend()
    ax.set_title("memory features (PCA)")
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return frame_xy


def plot_duration_histogram(
    durations_s: Sequence[float],
    save_path: str = "video_time_distribution_histogram.png",
    bins: int = 30,
) -> np.ndarray:
    """Histogram of per-video durations (reference: tools/static.py).

    Returns the bin counts; writes a PNG when matplotlib is importable.
    """
    durations = np.asarray(list(durations_s), np.float64)
    counts, edges = np.histogram(durations, bins=bins)
    plt = _plt()
    if plt is None:
        return counts
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(edges[:-1], counts, width=np.diff(edges), align="edge",
           edgecolor="white")
    ax.set_xlabel("video duration (s)")
    ax.set_ylabel("videos")
    ax.set_title(
        f"video durations (n={len(durations)}, "
        f"mean={durations.mean():.0f}s, max={durations.max():.0f}s)"
    )
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return counts


def plot_class_pie(
    counts: Dict[str, int],
    save_path: str = "class_distribution_pie_chart.png",
    title: str = "question classes",
) -> Dict[str, float]:
    """Pie chart of a {label: count} distribution (reference:
    tools/class_distribution_pie_chart.png from static.py).

    Returns the label->fraction mapping; writes a PNG when matplotlib is
    importable.
    """
    total = float(sum(counts.values())) or 1.0
    fractions = {k: v / total for k, v in sorted(counts.items())}
    plt = _plt()
    if plt is None:
        return fractions
    fig, ax = plt.subplots(figsize=(6, 6))
    labels = list(fractions)
    ax.pie([counts[k] for k in labels],
           labels=[f"{k} ({counts[k]})" for k in labels],
           autopct="%1.1f%%", pctdistance=0.8)
    ax.set_title(title)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fractions


def plot_category_sunburst(
    nested: Dict[str, Dict[str, int]],
    save_path: str = "category_sunburst.png",
) -> Dict[str, int]:
    """Two-ring domain->subclass distribution (reference:
    tools/draw_sun_pic.py, a plotly sunburst; rendered as a matplotlib
    nested pie — inner ring class_1 domains, outer ring class_2 subclasses).

    Returns the per-domain totals; writes a PNG when matplotlib is
    importable.
    """
    domains = sorted(nested)
    domain_totals = {d: sum(nested[d].values()) for d in domains}
    plt = _plt()
    if plt is None:
        return domain_totals
    fig, ax = plt.subplots(figsize=(7, 7))
    cmap = plt.get_cmap("tab20")
    inner_sizes, inner_labels, inner_colors = [], [], []
    outer_sizes, outer_labels, outer_colors = [], [], []
    for di, d in enumerate(domains):
        inner_sizes.append(domain_totals[d])
        inner_labels.append(f"{d} ({domain_totals[d]})")
        inner_colors.append(cmap(2 * di % 20))
        for si, (sub, n) in enumerate(sorted(nested[d].items())):
            outer_sizes.append(n)
            outer_labels.append(sub)
            outer_colors.append(cmap((2 * di + 1) % 20))
    ax.pie(inner_sizes, radius=0.7, labels=inner_labels, labeldistance=0.35,
           colors=inner_colors, wedgeprops=dict(width=0.35, edgecolor="white"))
    ax.pie(outer_sizes, radius=1.0, labels=outer_labels,
           colors=outer_colors, textprops={"fontsize": 8},
           wedgeprops=dict(width=0.3, edgecolor="white"))
    ax.set_title("videos by domain / subclass")
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return domain_totals

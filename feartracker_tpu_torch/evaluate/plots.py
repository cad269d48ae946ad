"""OPE report-plot writers — the got10k toolkit's report-plot capability
(the reference pulled that toolkit in; its ExperimentOPE drew these). The
counterpart of ``feartracker_tpu/evaluate/plots.py``; matplotlib is
imported inside the writers (the H100 host has none).

Two chart forms: success rate vs IoU threshold (AUC in the legend label) and
precision vs center-error threshold (score at 20 px in the label). Styling
follows the dataviz method with its validated reference palette (fixed
categorical order, never cycled; 2px lines; recessive grid; text in ink
tokens, identity carried by the mark; a legend whenever there are ≥2 series,
title names a single series; ≤8 series — fold extras before calling).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

# validated reference categorical order (dataviz palette.md, light mode)
SERIES_COLORS = [
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100",
    "#e87ba4", "#008300", "#4a3aa7", "#e34948",
]
SURFACE = "#fcfcfb"
INK_PRIMARY = "#0b0b0b"
INK_MUTED = "#898781"
GRID = "#e8e8e6"


def _plot_curves(
    curves: Dict[str, Sequence[float]],
    out_path: str,
    thresholds: np.ndarray,
    title: str,
    xlabel: str,
    ylabel: str,
    score_fn: Callable[[np.ndarray], float],
    legend_loc: str,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(curves) > len(SERIES_COLORS):
        raise ValueError(f"≤{len(SERIES_COLORS)} trackers per plot; fold or facet the rest")

    fig, ax = plt.subplots(figsize=(5.4, 4.2), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    ax.set_facecolor(SURFACE)
    for (name, ys), color in zip(curves.items(), SERIES_COLORS):
        ys = np.asarray(ys, float)
        ax.plot(thresholds, ys, color=color, linewidth=2.0,
                label=f"{name} [{score_fn(ys):.3f}]")

    ax.set_xlim(float(thresholds[0]), float(thresholds[-1]))
    ax.set_ylim(0, 1)
    ax.set_xlabel(xlabel, color=INK_MUTED)
    ax.set_ylabel(ylabel, color=INK_MUTED)
    ax.grid(True, color=GRID, linewidth=0.8)
    ax.tick_params(colors=INK_MUTED, labelsize=9)
    for spine in ax.spines.values():
        spine.set_color(GRID)
    if len(curves) >= 2:
        leg = ax.legend(frameon=False, fontsize=9, loc=legend_loc)
        for text in leg.get_texts():
            text.set_color(INK_PRIMARY)
        ax.set_title(title, color=INK_PRIMARY, fontsize=11)
    else:
        # single series: the title names it, no legend box
        only = next(iter(curves))
        score = score_fn(np.asarray(curves[only], float))
        ax.set_title(f"{title} — {only} [{score:.3f}]", color=INK_PRIMARY, fontsize=11)
    fig.tight_layout()
    fig.savefig(out_path, facecolor=SURFACE)
    plt.close(fig)
    return out_path


def plot_success(
    curves: Dict[str, Sequence[float]],
    out_path: str,
    thresholds: Optional[Sequence[float]] = None,
    title: str = "Success plot (OPE)",
) -> str:
    """Write a success-rate-vs-overlap-threshold plot.

    Args:
      curves: tracker name → success rates over ``thresholds`` (the
        ``success_curve`` from got10k_eval.summarize / ope_metrics).
      thresholds: x values; default the standard 0..1 step .05 grid.
    """
    if thresholds is None:
        from feartracker_tpu_torch.evaluate.got10k_eval import SUCCESS_THRESHOLDS

        thresholds = SUCCESS_THRESHOLDS
    return _plot_curves(
        curves, out_path, np.asarray(thresholds, float), title,
        xlabel="Overlap threshold", ylabel="Success rate",
        score_fn=lambda ys: float(ys.mean()),  # AUC
        legend_loc="lower left",
    )


def plot_precision(
    curves: Dict[str, Sequence[float]],
    out_path: str,
    thresholds: Optional[Sequence[float]] = None,
    title: str = "Precision plot (OPE)",
) -> str:
    """Write a precision-vs-center-error-threshold plot.

    Args:
      curves: tracker name → precision over ``thresholds`` (the
        ``precision_curve`` from got10k_eval.summarize / ope_metrics).
      thresholds: x values in pixels; default the standard 0..50 px grid,
        with the legend score read at 20 px (OTB convention). With custom
        thresholds the score is the curve's final value.
    """
    if thresholds is None:
        from feartracker_tpu_torch.evaluate.got10k_eval import PRECISION_THRESHOLDS

        thresholds = PRECISION_THRESHOLDS
    thresholds = np.asarray(thresholds, float)
    at20 = int(np.argmin(np.abs(thresholds - 20.0))) if thresholds[-1] >= 20 else -1
    return _plot_curves(
        curves, out_path, thresholds, title,
        xlabel="Location error threshold (px)", ylabel="Precision",
        score_fn=lambda ys: float(ys[at20]),
        legend_loc="lower right",
    )

"""Statistical method ranking and reporting.

The port's own copy of ``gaussian_process_transportation_tpu/benchmarks/statistics.py``
(numpy, scipy and matplotlib only):

* ranking: pairwise one-sided Mann-Whitney U tests; a method's rank
  improves by one for every competitor it beats at p < alpha, then the
  ranks are compacted.  NaN samples are dropped before each test;
* the report: one ``metric: method(rank) >= …`` line per metric;
* the figure: one box-plot panel per metric, the methods ordered by rank
  with the rank above each box.

The figure is built on ``matplotlib.figure.Figure``'s object interface,
not pyplot, so drawing it neither changes the process's backend nor
registers a figure with pyplot.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import stats


def mann_whitney_ranking(
    samples: Dict[str, np.ndarray], alpha: float = 0.05
) -> List[Tuple[str, int]]:
    """samples: method name → metric samples (lower is better).
    Returns [(name, rank)] sorted by rank (1 = best)."""
    names = list(samples)
    raw_rank = {n: len(names) for n in names}
    for a in names:
        for b in names:
            if a == b:
                continue
            xa = np.asarray(samples[a])
            xb = np.asarray(samples[b])
            xa = xa[~np.isnan(xa)]
            xb = xb[~np.isnan(xb)]
            p = stats.mannwhitneyu(xa, xb, alternative="less")[1]
            if p < alpha:
                raw_rank[a] -= 1
    # compact the ranks to 1..k, ties kept
    uniq = sorted(set(raw_rank.values()))
    remap = {v: i + 1 for i, v in enumerate(uniq)}
    ranked = [(n, remap[raw_rank[n]]) for n in names]
    return sorted(ranked, key=lambda t: t[1])


def best_method(samples: Dict[str, np.ndarray], alpha: float = 0.05) -> str:
    return mann_whitney_ranking(samples, alpha)[0][0]


def ranking_report(
    metrics: Dict[str, Dict[str, np.ndarray]], alpha: float = 0.05
) -> str:
    """Text report of per-metric Mann-Whitney rankings.

    ``metrics``: metric title → (method name → samples, lower is better);
    one ``metric: method(rank) >= ...`` line per metric."""
    lines = []
    for title, samples in metrics.items():
        ranked = mann_whitney_ranking(samples, alpha)
        lines.append(f"{title}: " + " >= ".join(f"{n}({r})" for n, r in ranked))
    return "\n".join(lines)


def ranked_boxplot(
    metrics: Dict[str, Dict[str, np.ndarray]],
    out_path: Optional[str] = None,
    alpha: float = 0.05,
    method_order: Optional[Sequence[str]] = None,
    figsize_per_panel: Tuple[float, float] = (4.0, 5.0),
):
    """One box-plot panel per metric, the methods ordered by Mann-Whitney
    rank with the rank above each box; each method keeps one color across
    the panels.  Saved to ``out_path`` where given.  Returns (fig, axes).

    A ``matplotlib.figure.Figure``: the process's backend stays as it was,
    and pyplot does not hold the figure."""
    import matplotlib
    from matplotlib.figure import Figure

    if method_order is None:
        method_order = list(next(iter(metrics.values())))
    cmap = matplotlib.colormaps["tab10"]
    colors = {m: cmap(i % 10) for i, m in enumerate(method_order)}

    n = len(metrics)
    fig = Figure(figsize=(figsize_per_panel[0] * n, figsize_per_panel[1]), layout="constrained")
    axes = fig.subplots(1, n, squeeze=False)[0]
    for ax, (title, samples) in zip(axes, metrics.items()):
        ranked = mann_whitney_ranking(samples, alpha)
        names = [nm for nm, _ in ranked]
        data = [np.asarray(samples[nm], float) for nm in names]
        data = [d[~np.isnan(d)] for d in data]
        bp = ax.boxplot(data, patch_artist=True, tick_labels=names, widths=0.6)
        for patch, nm in zip(bp["boxes"], names):
            patch.set_facecolor(colors[nm])
        top = max((d.max() for d in data if d.size), default=1.0)
        for j, (nm, rank) in enumerate(ranked):
            ax.text(j + 1, top, str(rank), ha="center", va="bottom", fontweight="bold")
        ax.set_title(title, fontweight="bold")
        ax.tick_params(axis="x", labelrotation=90)
    if out_path is not None:
        fig.savefig(out_path, bbox_inches="tight")
    return fig, axes

"""Publication figure theming (counterpart of
``visfly_tpu/utils/figfashion.py``): ``FigFon.set_fashion("IEEE")``,
``FigFon.get_figure_axes(SubFigSize=...)`` and ``colorsets[...]``, the API
surface the reference's FigFashion submodule offers. matplotlib is imported
only when a fashion is set."""
from __future__ import annotations

from typing import Tuple

colorsets = {
    # ordered for adjacent-contrast; colorblind-safe base hues
    "Modern Scientific": [
        "#0072B2", "#D55E00", "#009E73", "#CC79A7",
        "#F0E442", "#56B4E9", "#E69F00", "#000000",
    ],
    "IEEE": [
        "#1f77b4", "#d62728", "#2ca02c", "#9467bd",
        "#ff7f0e", "#8c564b", "#17becf", "#7f7f7f",
    ],
    "Muted": [
        "#4878d0", "#ee854a", "#6acc64", "#d65f5f",
        "#956cb4", "#8c613c", "#dc7ec0", "#797979",
    ],
}

_FASHIONS = {
    "IEEE": {
        "figure.figsize": (3.5, 2.5),  # single IEEE column
        "figure.dpi": 150,
        "font.size": 8,
        "font.family": "serif",
        "axes.linewidth": 0.6,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "grid.linewidth": 0.4,
        "lines.linewidth": 1.2,
        "legend.frameon": False,
        "legend.fontsize": 7,
        "xtick.direction": "in",
        "ytick.direction": "in",
        "savefig.bbox": "tight",
        "savefig.dpi": 300,
    },
    "Presentation": {
        "figure.figsize": (8, 5),
        "font.size": 14,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "lines.linewidth": 2.0,
        "legend.frameon": False,
    },
}


class FigFon:
    """Minimal FigFashion facade (classmethod API, as the reference calls
    it: ``FigFon.set_fashion("IEEE")``)."""

    current: str = "IEEE"

    @classmethod
    def set_fashion(cls, name: str = "IEEE") -> None:
        import matplotlib as mpl
        from cycler import cycler

        style = _FASHIONS.get(name, _FASHIONS["IEEE"])
        mpl.rcParams.update(style)
        colors = colorsets.get(name, colorsets["Modern Scientific"])
        mpl.rcParams["axes.prop_cycle"] = cycler(color=colors)
        cls.current = name

    @classmethod
    def get_figure_axes(cls, SubFigSize: Tuple[int, int] = (1, 1),
                        **subplots_kw):
        """(fig, axes) with the current fashion applied; axes is always a
        flat list (the reference indexes ``axes[0]``)."""
        import matplotlib.pyplot as plt

        cls.set_fashion(cls.current)
        r, c = SubFigSize
        base_w, base_h = _FASHIONS.get(cls.current, _FASHIONS["IEEE"]).get(
            "figure.figsize", (3.5, 2.5))
        subplots_kw.setdefault("figsize", (base_w * c, base_h * r))
        fig, axes = plt.subplots(r, c, **subplots_kw)
        try:
            axes = list(axes.ravel())
        except AttributeError:  # single Axes
            axes = [axes]
        return fig, axes

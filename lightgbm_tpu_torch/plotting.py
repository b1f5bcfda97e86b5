"""Plotting utilities.

Counterpart of ``lightgbm_tpu/plotting.py`` (reference
python-package/lightgbm/plotting.py — ``plot_importance``,
``plot_split_value_histogram``, ``plot_metric``, ``plot_tree``,
``create_tree_digraph``) on this package's Booster: the same bars, labels
and digraph source for the same model.  matplotlib and graphviz are
imported inside the functions.

Label strings may carry ``@...@`` placeholder tokens (``@importance_type@``,
``@metric@``, ``@feature@``, ``@index/name@``) that are substituted at
render time — an API behavior the reference documents, so it is kept.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster

__all__ = [
    "plot_importance", "plot_split_value_histogram", "plot_metric",
    "plot_tree", "create_tree_digraph",
]


def _fmt(value: Any, precision: Optional[int]) -> str:
    """Number -> display string at the requested decimal precision."""
    if isinstance(value, str) or precision is None:
        return str(value)
    return f"{value:.{precision}f}"


def _as_booster(obj: Any) -> Booster:
    """Accept a Booster or a fitted sklearn estimator."""
    b = getattr(obj, "booster_", obj)
    if not isinstance(b, Booster):
        raise TypeError("booster must be Booster or LGBMModel.")
    return b


class _AxesCanvas:
    """One matplotlib Axes plus the shared decoration logic (limits, title,
    labels with token substitution, grid) every plot entry point applies."""

    def __init__(self, ax, figsize, dpi):
        if ax is None:
            import matplotlib.pyplot as plt
            if figsize is not None:
                _pair(figsize, "figsize")
            _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
        self.ax = ax

    def decorate(self, *, xlim=None, ylim=None, title=None, xlabel=None,
                 ylabel=None, grid=True, tokens: Dict[str, str] = {}):
        def subst(text):
            for token, repl in tokens.items():
                text = text.replace(f"@{token}@", repl)
            return text

        if xlim is not None:
            self.ax.set_xlim(_pair(xlim, "xlim"))
        if ylim is not None:
            self.ax.set_ylim(_pair(ylim, "ylim"))
        if title is not None:
            self.ax.set_title(subst(title))
        if xlabel is not None:
            self.ax.set_xlabel(subst(xlabel))
        if ylabel is not None:
            self.ax.set_ylabel(subst(ylabel))
        self.ax.grid(grid)
        return self.ax


def _pair(value: Any, name: str) -> Tuple[float, float]:
    if not (isinstance(value, tuple) and len(value) == 2):
        raise TypeError(f"{name} must be a tuple of 2 elements.")
    return value


def plot_importance(booster: Union[Booster, Any], ax=None, height: float = 0.2,
                    xlim: Optional[Tuple[float, float]] = None,
                    ylim: Optional[Tuple[float, float]] = None,
                    title: Optional[str] = "Feature importance",
                    xlabel: Optional[str] = "Feature importance",
                    ylabel: Optional[str] = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: Optional[int] = 3,
                    **kwargs: Any):
    """Horizontal bar chart of feature importances."""
    if importance_type == "auto":
        importance_type = getattr(booster, "importance_type", "split")
    b = _as_booster(booster)
    scores = b.feature_importance(importance_type=importance_type)
    if not len(scores):
        raise ValueError("Booster's feature_importance is empty.")

    # ascending so the biggest bar lands on top of the barh chart
    order = np.argsort(scores, kind="stable")
    names = b.feature_name()
    keep = [i for i in order if scores[i] > 0] if ignore_zero else list(order)
    if max_num_features is not None and max_num_features > 0:
        keep = keep[-max_num_features:]
    values = scores[keep]
    is_int_scores = importance_type != "gain"

    canvas = _AxesCanvas(ax, figsize, dpi)
    ypos = np.arange(len(keep))
    canvas.ax.barh(ypos, values, align="center", height=height, **kwargs)
    for yi, v in enumerate(values):
        text = str(int(v)) if is_int_scores else _fmt(v, precision)
        canvas.ax.text(v + 1, yi, text, va="center")
    canvas.ax.set_yticks(ypos)
    canvas.ax.set_yticklabels([names[i] for i in keep])
    return canvas.decorate(
        xlim=xlim if xlim is not None else (0, float(values.max()) * 1.1),
        ylim=ylim if ylim is not None else (-1, len(keep)),
        title=title, xlabel=xlabel, ylabel=ylabel, grid=grid,
        tokens={"importance_type": importance_type})


def _iter_tree_nodes(tree_structure: Dict[str, Any]):
    """Yield every node dict of a dumped tree, root first."""
    todo = [tree_structure]
    while todo:
        node = todo.pop()
        yield node
        for side in ("left_child", "right_child"):
            child = node.get(side)
            if isinstance(child, dict):
                todo.append(child)


def plot_split_value_histogram(booster: Union[Booster, Any],
                               feature: Union[int, str], bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title: Optional[str] = "Split value histogram "
                                                      "for feature with @index/name@ @feature@",
                               xlabel: Optional[str] = "Feature split value",
                               ylabel: Optional[str] = "Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs: Any):
    """Histogram of a feature's chosen split thresholds across the model."""
    b = _as_booster(booster)
    if isinstance(feature, str):
        names = b.feature_name()
        if feature not in names:
            raise ValueError(f"Feature {feature} not found.")
        fidx = names.index(feature)
    else:
        fidx = int(feature)

    thresholds = [
        float(node["threshold"])
        for info in b.dump_model()["tree_info"]
        for node in _iter_tree_nodes(info["tree_structure"])
        if node.get("split_feature") == fidx
        and node.get("decision_type") == "<="
    ]
    if not thresholds:
        raise ValueError(
            "Cannot plot split value histogram, "
            f"because feature {feature} was not used in splitting.")
    counts, edges = np.histogram(thresholds, bins=bins or "auto")

    canvas = _AxesCanvas(ax, figsize, dpi)
    canvas.ax.bar((edges[:-1] + edges[1:]) / 2, counts,
                  width=width_coef * (edges[1] - edges[0]),
                  align="center", **kwargs)
    return canvas.decorate(
        xlim=xlim,
        ylim=ylim if ylim is not None else (0, float(counts.max()) * 1.1),
        title=title, xlabel=xlabel, ylabel=ylabel, grid=grid,
        tokens={"index/name": "name" if isinstance(feature, str) else "index",
                "feature": str(feature)})


def plot_metric(booster: Union[Dict, Any], metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None,
                title: Optional[str] = "Metric during training",
                xlabel: Optional[str] = "Iterations",
                ylabel: Optional[str] = "@metric@", figsize=None, dpi=None,
                grid: bool = True):
    """Plot a metric recorded by ``record_evaluation`` during training."""
    if isinstance(booster, dict):
        history = deepcopy(booster)
    elif hasattr(booster, "evals_result_"):
        history = deepcopy(booster.evals_result_)
    else:
        raise TypeError("booster must be dict or LGBMModel with "
                        "recorded eval results.")
    if not history:
        raise ValueError("eval results cannot be empty.")

    names = dataset_names if dataset_names is not None else list(history)
    first = history[names[0]]
    if metric is None:
        if len(first) > 1:
            raise ValueError("more than one metric available, "
                             "pick one metric via metric arg.")
        metric = next(iter(first))
    elif metric not in first:
        raise ValueError("No given metric in eval results.")

    canvas = _AxesCanvas(ax, figsize, dpi)
    n_iter = len(first[metric])
    for name in names:
        canvas.ax.plot(range(n_iter), history[name][metric], label=name)
    canvas.ax.legend(loc="best")
    return canvas.decorate(
        xlim=xlim if xlim is not None else (0, n_iter),
        ylim=ylim, title=title, xlabel=xlabel, ylabel=ylabel, grid=grid,
        tokens={"metric": metric})


def _node_label(node: Dict[str, Any], feature_names: List[str],
                show_info: List[str], precision: Optional[int]) -> str:
    """Multi-line graphviz label for one dumped node."""
    if "split_index" in node:
        fidx = node["split_feature"]
        feat = feature_names[fidx] if fidx < len(feature_names) \
            else f"Column_{fidx}"
        lines = [f"{feat} {node['decision_type']} "
                 f"{_fmt(node['threshold'], precision)}"]
        for key in ("split_gain", "internal_value", "internal_count"):
            if key in show_info and key in node:
                lines.append(
                    f"{key.rsplit('_', 1)[-1]}: {_fmt(node[key], precision)}")
    else:
        lines = [f"leaf {node['leaf_index']}: "
                 f"{_fmt(node['leaf_value'], precision)}"]
        if "leaf_count" in show_info and "leaf_count" in node:
            lines.append(f"count: {int(node['leaf_count'])}")
        if "leaf_weight" in show_info and "leaf_weight" in node:
            lines.append(f"weight: {_fmt(node['leaf_weight'], precision)}")
    return "\n".join(lines)


def create_tree_digraph(booster: Union[Booster, Any], tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal", **kwargs: Any):
    """Create a graphviz Digraph of one tree."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("You must install graphviz for plot_tree.") from e
    b = _as_booster(booster)
    model = b.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    info = show_info or []
    feature_names = model.get("feature_names", [])

    graph = Digraph(**kwargs)
    graph.attr(rankdir="LR" if orientation == "horizontal" else "TB")
    # explicit worklist of (node, parent_name, edge_label); graphviz output
    # order follows insertion, so children are pushed right before left
    todo = [(model["tree_info"][tree_index]["tree_structure"], None, None)]
    while todo:
        node, parent, edge = todo.pop()
        name = f"split{node['split_index']}" if "split_index" in node \
            else f"leaf{node['leaf_index']}"
        graph.node(name, label=_node_label(node, feature_names, info,
                                           precision))
        if parent is not None:
            graph.edge(parent, name, edge)
        if "split_index" in node:
            todo.append((node["right_child"], name, "no"))
            todo.append((node["left_child"], name, "yes"))
    return graph


def plot_tree(booster: Union[Booster, Any], ax=None, tree_index: int = 0,
              figsize=None, dpi=None, show_info: Optional[List[str]] = None,
              precision: Optional[int] = 3, orientation: str = "horizontal",
              **kwargs: Any):
    """Render one tree with matplotlib (via graphviz)."""
    from io import BytesIO

    import matplotlib.image as mimage
    canvas = _AxesCanvas(ax, figsize, dpi)
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    canvas.ax.imshow(mimage.imread(BytesIO(graph.pipe(format="png"))))
    canvas.ax.axis("off")
    return canvas.ax

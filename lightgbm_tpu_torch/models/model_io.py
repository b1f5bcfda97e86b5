"""Model text serialization.

Counterpart of ``lightgbm_tpu/models/model_io.py`` (reference:
src/boosting/gbdt_model_text.cpp — ``SaveModelToString`` versioned text
format, ``LoadModelFromString``, ``DumpModel`` JSON).  The format emitted
here follows the reference's v4 text layout (header keys, per-tree blocks,
feature_importances / parameters trailer) so models interoperate: a model
trained here loads in stock LightGBM and vice versa for the shared feature
set.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import log
from .tree import Tree


def objective_to_string(name: str, config) -> str:
    """Reference objective ToString() forms (objective cpp files)."""
    if name == "binary":
        return f"binary sigmoid:{config.sigmoid:g}"
    if name == "multiclass":
        return f"multiclass num_class:{config.num_class}"
    if name == "multiclassova":
        return (f"multiclassova num_class:{config.num_class} "
                f"sigmoid:{config.sigmoid:g}")
    if name == "quantile":
        return f"quantile alpha:{config.alpha:g}"
    if name == "huber":
        return f"huber alpha:{config.alpha:g}"
    if name == "fair":
        return f"fair c:{config.fair_c:g}"
    if name == "tweedie":
        return f"tweedie tweedie_variance_power:{config.tweedie_variance_power:g}"
    if name == "regression" and getattr(config, "reg_sqrt", False):
        return "regression sqrt"
    if name == "lambdarank":
        return "lambdarank"
    if name == "rank_xendcg":
        return "rank_xendcg"
    if name == "none":
        return "custom"
    return name


def objective_string_to_params(s: str) -> Dict[str, Any]:
    """Inverse of :func:`objective_to_string`: the params of a model
    header's objective string (``"binary sigmoid:1"`` ->
    ``{"objective": "binary", "sigmoid": "1"}``)."""
    toks = s.split(" ")
    name = toks[0]
    out: Dict[str, Any] = {"objective": "none" if name == "custom" else name}
    key_map = {"sigmoid": "sigmoid", "num_class": "num_class",
               "alpha": "alpha", "c": "fair_c",
               "tweedie_variance_power": "tweedie_variance_power"}
    for tok in toks[1:]:
        if tok == "sqrt":
            out["reg_sqrt"] = True
        elif ":" in tok:
            k, v = tok.split(":", 1)
            if k in key_map:
                out[key_map[k]] = v
    return out


def model_to_string(trees: List[Tree], *, num_class: int,
                    num_tree_per_iteration: int, max_feature_idx: int,
                    objective_str: str, feature_names: List[str],
                    feature_infos: List[str], params: Dict[str, Any],
                    label_index: int = 0,
                    pandas_categorical: Optional[list] = None) -> str:
    """Assemble the full model file (gbdt_model_text.cpp SaveModelToString)."""
    header = [
        "tree",
        "version=v4",
        f"num_class={num_class}",
        f"num_tree_per_iteration={num_tree_per_iteration}",
        f"label_index={label_index}",
        f"max_feature_idx={max_feature_idx}",
        f"objective={objective_str}",
        "feature_names=" + " ".join(feature_names),
        "feature_infos=" + " ".join(feature_infos),
    ]
    tree_strs = [t.to_text(i) for i, t in enumerate(trees)]
    sizes = [len(s) + 1 for s in tree_strs]
    header.append("tree_sizes=" + " ".join(str(s) for s in sizes))
    header.append("")

    body = "\n".join(tree_strs)

    # split-count feature importances (reference FeatureImportance)
    imp = np.zeros(max_feature_idx + 1)
    for t in trees:
        for i in range(t.num_leaves - 1):
            if t.split_gain[i] > 0:
                imp[t.split_feature[i]] += 1
    order = np.argsort(-imp, kind="mergesort")
    imp_lines = ["feature_importances:"]
    for fi in order:
        if imp[fi] > 0:
            imp_lines.append(f"{feature_names[fi]}={int(imp[fi])}")
    # pandas category lists ride the model file as trailing JSON, exactly
    # like the reference python package (basic.py pandas_categorical)
    pc_json = json.dumps(pandas_categorical) if pandas_categorical else "null"
    trailer = "\n".join(imp_lines) + "\n\nparameters:\n" + "\n".join(
        f"[{k}: {_fmt_param(v)}]" for k, v in params.items()) + \
        f"\nend of parameters\n\npandas_categorical:{pc_json}\n"
    return "\n".join(header) + "\n" + body + "\nend of trees\n\n" + trailer


def _fmt_param(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


def parse_model_string(text: str) -> Dict[str, Any]:
    """Parse a model file (gbdt_model_text.cpp LoadModelFromString)."""
    if "tree" not in text.split("\n", 1)[0]:
        log.fatal("Model file doesn't specify the model format")
    head, _, rest = text.partition("\nTree=")
    meta: Dict[str, Any] = {}
    for line in head.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            meta[k.strip()] = v.strip()
    trees: List[Tree] = []
    if rest:
        body = "Tree=" + rest
        body = body.split("end of trees")[0]
        blocks = body.split("\nTree=")
        for i, b in enumerate(blocks):
            if not b.strip():
                continue
            if not b.startswith("Tree="):
                b = "Tree=" + b
            trees.append(Tree.from_text(b))
    feature_names = meta.get("feature_names", "").split(" ") \
        if meta.get("feature_names") else []
    params: Dict[str, str] = {}
    if "parameters:" in text:
        ptext = text.split("parameters:", 1)[1].split("end of parameters")[0]
        for line in ptext.strip().splitlines():
            line = line.strip()
            if line.startswith("[") and ": " in line:
                k, v = line[1:-1].split(": ", 1)
                params[k] = v
    pandas_categorical = None
    if "\npandas_categorical:" in text:
        pc_line = text.rsplit("\npandas_categorical:", 1)[1].splitlines()[0]
        try:
            pandas_categorical = json.loads(pc_line)
        except (json.JSONDecodeError, ValueError):
            pandas_categorical = None
    return {
        "trees": trees,
        "num_class": int(meta.get("num_class", 1)),
        "num_tree_per_iteration": int(meta.get("num_tree_per_iteration", 1)),
        "max_feature_idx": int(meta.get("max_feature_idx", 0)),
        "objective": meta.get("objective", "regression"),
        "feature_names": feature_names,
        "feature_infos": meta.get("feature_infos", "").split(" "),
        "params": params,
        "pandas_categorical": pandas_categorical,
    }

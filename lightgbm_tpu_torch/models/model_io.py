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


def model_to_dict(trees: List[Tree], *, num_class: int,
                  num_tree_per_iteration: int, max_feature_idx: int,
                  objective_str: str, feature_names: List[str]
                  ) -> Dict[str, Any]:
    """The DumpModel structure (gbdt_model_text.cpp DumpModel) as a dict:
    the header and each tree's nested nodes, the JAX package's keys."""

    def node_json(t: Tree, node: int) -> Dict[str, Any]:
        if node < 0:
            leaf = -node - 1
            return {"leaf_index": int(leaf),
                    "leaf_value": float(t.leaf_value[leaf]),
                    "leaf_weight": float(t.leaf_weight[leaf])
                    if len(t.leaf_weight) > leaf else 0.0,
                    "leaf_count": int(t.leaf_count[leaf])
                    if len(t.leaf_count) > leaf else 0}
        dt = int(t.decision_type[node])
        return {
            "split_index": int(node),
            "split_feature": int(t.split_feature[node]),
            "split_gain": float(t.split_gain[node]),
            "threshold": float(t.threshold[node]),
            "decision_type": "==" if dt & 1 else "<=",
            "default_left": bool(dt & 2),
            "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
            "internal_value": float(t.internal_value[node]),
            "internal_count": int(t.internal_count[node]),
            "left_child": node_json(t, int(t.left_child[node])),
            "right_child": node_json(t, int(t.right_child[node])),
        }

    return {
        "name": "tree",
        "version": "v4",
        "num_class": num_class,
        "num_tree_per_iteration": num_tree_per_iteration,
        "label_index": 0,
        "max_feature_idx": max_feature_idx,
        "objective": objective_str,
        "feature_names": feature_names,
        "tree_info": [
            {"tree_index": i, "num_leaves": t.num_leaves,
             "shrinkage": t.shrinkage,
             "tree_structure": node_json(t, 0 if t.num_leaves > 1 else -1)}
            for i, t in enumerate(trees)
        ],
    }


def model_to_json(trees: List[Tree], **kwargs: Any) -> str:
    return json.dumps(model_to_dict(trees, **kwargs), indent=2)


def model_to_cpp(trees: List[Tree], *, num_tree_per_iteration: int = 1) -> str:
    """Standalone C++ prediction code of a model (the reference's
    ``convert_model`` task / ModelToIfElse, gbdt_model_text.cpp; the JAX
    package's text, byte for byte): one ``double PredictTreeK(const
    double* arr)`` of nested ifs a tree and a ``Predict`` that sums them a
    class; a missing value goes to the node's default side."""

    def node_code(t: Tree, node: int, indent: str) -> str:
        if node < 0:
            leaf = -node - 1
            if t.is_linear:
                terms = [f"{t.leaf_const[leaf]:.17g}"]
                for fi, co in zip(t.leaf_features[leaf], t.leaf_coeff[leaf]):
                    terms.append(f"({co:.17g}) * arr[{fi}]")
                return f"{indent}return {' + '.join(terms)};\n"
            return f"{indent}return {t.leaf_value[leaf]:.17g};\n"
        f = int(t.split_feature[node])
        dt = int(t.decision_type[node])
        is_cat = bool(dt & 1)
        default_left = bool(dt & 2)
        mtype = (dt >> 2) & 3  # 0 none / 1 zero / 2 nan (tree.py encoding)
        if is_cat:
            # NaN categorical routes per the recorded cat_nan_left
            # (predict_leaf_index in tree.py)
            ci = int(t.cat_split_index[node])
            cats = sorted(t.cat_threshold[ci]) if ci >= 0 else []
            nan_left = (ci >= 0 and ci < len(t.cat_nan_left)
                        and bool(t.cat_nan_left[ci]))
            in_set = " || ".join(f"ivalue == {c}" for c in cats) or "false"
            member = (f"[&]{{ int ivalue = (int)arr[{f}]; "
                      f"return {in_set}; }}()")
            cond = f"std::isnan(arr[{f}]) ? {str(nan_left).lower()} : {member}"
        else:
            thr = float(t.threshold[node])
            nan = f"std::isnan(arr[{f}])"
            base = f"arr[{f}] <= {thr:.17g}"
            if mtype == 0:
                # missing_type none: NaN falls back to 0.0 before comparing
                cond = (f"({nan}) ? (0.0 <= {thr:.17g}) : ({base})")
            else:
                miss = nan if mtype == 2 else \
                    f"(({nan}) || std::fabs(arr[{f}]) <= 1e-35)"
                cond = f"({miss}) || ({base})" if default_left \
                    else f"!({miss}) && ({base})"
        left = node_code(t, int(t.left_child[node]), indent + "  ")
        right = node_code(t, int(t.right_child[node]), indent + "  ")
        return (f"{indent}if ({cond}) {{\n{left}{indent}}} else {{\n"
                f"{right}{indent}}}\n")

    # the JAX package's banner, so both packages write the same file
    parts = ["#include <cmath>", "", "// generated by lightgbm_tpu "
             "convert_model (reference ModelToIfElse equivalent)", ""]
    for i, t in enumerate(trees):
        body = node_code(t, 0 if t.num_leaves > 1 else -1, "  ")
        parts.append(f"double PredictTree{i}(const double* arr) {{\n{body}}}\n")
    k = max(1, num_tree_per_iteration)
    calls = [f"PredictTree{i}(arr)" for i in range(len(trees))]
    parts.append("void Predict(const double* arr, double* out) {")
    for c in range(k):
        sub = [calls[j] for j in range(c, len(calls), k)]
        expr = " + ".join(sub) if sub else "0.0"
        parts.append(f"  out[{c}] = {expr};")
    parts.append("}\n")
    return "\n".join(parts)

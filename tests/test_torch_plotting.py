"""The port's plots: the five checks of tests/test_plotting.py under the Agg
backend, and for the same model text the bars' values and labels, the
split-value histogram, the metric curves and the digraph source equal to
lightgbm_tpu's."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu as lgb_jax  # noqa: E402

import lightgbm_tpu_torch as lgb  # noqa: E402

from test_torch_fused import one_torch_thread  # noqa: F401,E402

CPU = dict(device_type="cpu")


@pytest.fixture(scope="module")
def synthetic_binary_mod():
    rng = np.random.default_rng(42)
    n, f = 500, 6
    X = rng.normal(size=(n, f))
    y = ((X @ rng.normal(size=f)) > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def trained(synthetic_binary_mod):
    X, y = synthetic_binary_mod
    ds = lgb.Dataset(X, label=y)
    evals = {}
    bst = lgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                     "metric": ["binary_logloss", "auc"], **CPU},
                    ds, num_boost_round=8, valid_sets=[ds],
                    valid_names=["train"],
                    callbacks=[lgb.record_evaluation(evals)])
    return bst, evals


def test_plot_importance(trained):
    bst, _ = trained
    ax = lgb.plot_importance(bst)
    assert ax.get_title() == "Feature importance"
    assert len(ax.patches) >= 1
    ax2 = lgb.plot_importance(bst, importance_type="gain",
                              max_num_features=3, title="gain imp")
    assert ax2.get_title() == "gain imp"
    assert len(ax2.patches) <= 3
    plt.close("all")


def test_plot_metric(trained):
    _, evals = trained
    ax = lgb.plot_metric(evals, metric="binary_logloss")
    assert ax.get_ylabel() == "binary_logloss"
    with pytest.raises(ValueError):
        lgb.plot_metric(evals)
    plt.close("all")


def test_plot_split_value_histogram(trained):
    bst, _ = trained
    ax = lgb.plot_split_value_histogram(bst, feature=0)
    assert len(ax.patches) >= 1
    plt.close("all")


def test_create_tree_digraph(trained):
    bst, _ = trained
    graph = lgb.create_tree_digraph(
        bst, tree_index=0,
        show_info=["split_gain", "internal_count", "leaf_count"])
    src = graph.source
    assert "split0" in src
    assert "leaf" in src
    with pytest.raises(IndexError):
        lgb.create_tree_digraph(bst, tree_index=999)


def test_plot_importance_sklearn(synthetic_binary_mod):
    X, y = synthetic_binary_mod
    clf = lgb.LGBMClassifier(n_estimators=5, num_leaves=7, verbose=-1, **CPU)
    clf.fit(X, y)
    ax = lgb.plot_importance(clf)
    assert len(ax.patches) >= 1
    plt.close("all")


def _bars(ax):
    return ([(p.get_x(), p.get_y(), p.get_width(), p.get_height())
             for p in ax.patches],
            [t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in ax.texts], ax.get_xlim(), ax.get_ylim(),
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel())


INT8 = dict(objective="regression", num_leaves=7, max_bin=63,
            tpu_split_batch=4, use_quantized_grad=True,
            tpu_hist_dtype="int8", quant_train_renew_leaf=True,
            stochastic_rounding=False, hist_kernel="onehot",
            min_data_in_leaf=5, verbosity=-1)


@pytest.mark.parametrize("kind", ["loaded", "trained"])
def test_plots_match_jax(trained, synthetic_binary_mod, kind):
    """``loaded``: both packages load the port's model text; ``trained``:
    both train the same int8 model (equal text), the boosters' in-memory
    trees plotted."""
    bst, evals = trained
    if kind == "loaded":
        text = bst.model_to_string()
        bt = lgb.Booster(model_str=text)
        bj = lgb_jax.Booster(model_str=text)
    else:
        X, y = synthetic_binary_mod
        y = X[:, 0] + y
        bt = lgb.train(dict(INT8, **CPU), lgb.Dataset(X, y), 8)
        bj = lgb_jax.train(INT8, lgb_jax.Dataset(X, y), 8)
        assert bt.model_to_string().split("parameters:")[0] == \
            bj.model_to_string().split("parameters:")[0]
    for kw in ({}, dict(importance_type="gain", max_num_features=3),
               dict(ignore_zero=False, precision=1)):
        assert _bars(lgb.plot_importance(bt, **kw)) == \
            _bars(lgb_jax.plot_importance(bj, **kw))
    name = bt.feature_name()[0]
    for feat in (0, name):
        assert _bars(lgb.plot_split_value_histogram(bt, feat, bins=4)) == \
            _bars(lgb_jax.plot_split_value_histogram(bj, feat, bins=4))
    at = lgb.plot_metric(evals, metric="auc")
    aj = lgb_jax.plot_metric(evals, metric="auc")
    assert [list(ln.get_ydata()) for ln in at.get_lines()] == \
        [list(ln.get_ydata()) for ln in aj.get_lines()]
    plt.close("all")
    for ti in (0, 5):
        for kw in ({}, dict(show_info=["split_gain", "internal_value",
                                       "internal_count", "leaf_count",
                                       "leaf_weight"], precision=5,
                            orientation="vertical")):
            assert lgb.create_tree_digraph(bt, tree_index=ti, **kw).source \
                == lgb_jax.create_tree_digraph(bj, tree_index=ti,
                                               **kw).source
    with pytest.raises(TypeError):
        lgb.plot_importance("not a booster")

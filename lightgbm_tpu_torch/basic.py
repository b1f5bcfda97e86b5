"""User-facing ``Dataset`` and ``Booster``.

Counterpart of ``lightgbm_tpu/basic.py`` (reference python-package
lightgbm/basic.py — ``Dataset`` :1764 lazy construction with reference
alignment, ``Booster`` :3586): lazy Dataset construction, valid sets binned
against their training reference, Booster train / eval / predict / save /
load with the same model text format.  Booster(model_str=...) and
Booster(model_file=...) load the JAX package's model text as well as this
package's.

Input, at construction and at predict time: numpy and lists of rows, a
text file path (CSV / TSV / LibSVM, io/parser.py) or a binary dataset
written by ``save_binary`` (of either package), scipy CSR / CSC (binned
from its columns, never made dense; predicted in byte-bounded row blocks),
pandas frames (category columns as codes, their category lists kept as
``pandas_categorical`` in the model text and reapplied by position at
predict time), pyarrow Tables, datatable Frames (by duck type) and
:class:`Sequence` objects or lists of them.

``Booster.predict`` has the JAX package's surface: raw or converted
scores, ``pred_leaf``, ``pred_contrib`` (TreeSHAP, models/shap.py) and
prediction early stopping (``pred_early_stop`` / ``_freq`` / ``_margin``).
Scores of at least ``GBDT.DEVICE_PREDICT_MIN_WORK`` row-trees run on the
booster's device: a trained booster's on the forest kernel's sums, a
loaded model's (device from its params) on the kernel's leaves with the
sums in host float64, the host walk's bits.

The training surface (the JAX package's): ``Booster.update(train_set,
fobj)`` with custom gradients, continued training (a Dataset's predictor
gives its init score, ``Booster.__init__`` merges the init model's trees),
``rollback_one_iter``, ``refit`` / ``refit_from_leaf_preds``,
``reset_parameter``, ``eval`` with custom metrics (a loaded model's too),
``telemetry``, ``Dataset.subset`` with the field accessors.

Model inspection and edits: ``feature_importance``, ``dump_model``,
``trees_to_dataframe``, ``get_split_value_histogram``, ``upper_bound`` /
``lower_bound``, ``get_leaf_output`` / ``set_leaf_output``,
``model_from_string``, ``merge_models``, ``shuffle_models`` and
``reset_training_data`` (the score caches rebuilt on the booster's
device).

Not here yet: ``set_network`` / ``free_network`` (multi-device, ROADMAP
Queue 1 item 6) and ``prometheus_text`` (item 8); they raise
``LightGBMError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence as TSeq, Union

import numpy as np

from .boosting import create_boosting
from .config import Config, normalize_params, raw_param
from .io.dataset import Dataset as _InnerDataset, _is_sparse
from .io.parser import load_text_file
from .models.model_io import (model_to_dict, model_to_string,
                              objective_string_to_params,
                              objective_to_string, parse_model_string)
from .models.tree import Tree
from .utils import log
from .utils.device import resolve_device


class Sequence:
    """Generic data access for batched construction (reference
    basic.py:915 ``Sequence``): a subclass implements ``__getitem__`` (a
    row or a slice) and ``__len__``; the loader reads ``batch_size`` rows
    at a time."""

    batch_size = 4096

    def __getitem__(self, idx):  # pragma: no cover - interface
        raise NotImplementedError("Sub-classes of lightgbm_tpu_torch."
                                  "Sequence must implement __getitem__")

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError("Sub-classes of lightgbm_tpu_torch."
                                  "Sequence must implement __len__")


def _sequence_to_array(seqs) -> np.ndarray:
    """Sequences read batch by batch into one float64 [n, F] matrix."""
    parts = []
    for s in seqs:
        n = len(s)
        bs = int(getattr(s, "batch_size", 4096) or 4096)
        for lo in range(0, n, bs):
            hi = min(n, lo + bs)
            batch = np.asarray(s[slice(lo, hi)], dtype=np.float64)
            parts.append(batch.reshape(hi - lo, -1))
    return np.concatenate(parts, axis=0) if parts else np.zeros((0, 0))


def _convert_pandas_categorical(df, stored: Optional[list] = None):
    """Category columns as float codes (NaN for missing and unseen
    categories): (frame, category lists in column order, the category
    columns' names).  ``stored`` (the training lists, the model's
    ``pandas_categorical``) is zipped by position with the frame's category
    columns."""
    import pandas as pd
    cat_cols = [c for c in df.columns
                if isinstance(df[c].dtype, pd.CategoricalDtype)]
    if not cat_cols:
        return df, None, []
    if stored is not None and len(stored) != len(cat_cols):
        log.fatal(f"train data had {len(stored)} categorical column(s), "
                  f"this data has {len(cat_cols)}")
    df = df.copy()
    out = []
    for i, c in enumerate(cat_cols):
        cats = list(stored[i]) if stored is not None \
            else list(df[c].cat.categories)
        codes = pd.Categorical(df[c],
                               categories=cats).codes.astype(np.float64)
        df[c] = np.where(codes < 0, np.nan, codes)
        out.append(cats)
    return df, out, [str(c) for c in cat_cols]


def _coerce_data(data: Any, categorical_feature, category_maps=None):
    """Input data as (float64 matrix or scipy sparse, feature names or
    None, categorical_feature, pandas_categorical or None), the JAX
    package's rules: a Sequence or a list of them is read in batches; a
    datatable Frame (by its module name) through its ``to_numpy``, masked
    cells NaN; a pyarrow Table column by column when no column is a
    dictionary, else through pandas; a pandas frame's category columns as
    codes ('auto' categorical resolves to them); scipy sparse passed on
    as it is.  ``category_maps``: the training category lists a valid
    set aligns to."""
    pandas_categorical = None
    feature_names = None
    if isinstance(data, Sequence):
        data = _sequence_to_array([data])
    elif isinstance(data, list) and data and \
            all(isinstance(s, Sequence) for s in data):
        data = _sequence_to_array(data)
    if type(data).__module__.split(".")[0] == "datatable" and \
            hasattr(data, "to_numpy"):
        feature_names = [str(c) for c in data.names] \
            if hasattr(data, "names") else None
        arr = data.to_numpy()
        if np.ma.isMaskedArray(arr):
            arr = np.ma.filled(arr.astype(np.float64), np.nan)
        arr = np.asarray(arr, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        return arr, feature_names, categorical_feature, None
    if hasattr(data, "column_names") and hasattr(data, "to_pandas"):
        import pyarrow as pa
        if not any(pa.types.is_dictionary(f.type) for f in data.schema):
            names = [str(c) for c in data.column_names]
            arr = np.empty((data.num_rows, len(names)), np.float64)
            for ci, col in enumerate(data.columns):
                arr[:, ci] = col.cast(pa.float64()).to_numpy(
                    zero_copy_only=False)
            return arr, names, categorical_feature, None
        data = data.to_pandas()
    if hasattr(data, "columns") and hasattr(data, "dtypes"):  # DataFrame
        feature_names = [str(c) for c in data.columns]
        data, pandas_categorical, cat_names = _convert_pandas_categorical(
            data, stored=category_maps)
        if cat_names and categorical_feature in ("auto", None):
            categorical_feature = cat_names
        arr = data.to_numpy(dtype=np.float64, na_value=np.nan)
        return arr, feature_names, categorical_feature, pandas_categorical
    if _is_sparse(data):
        return data, feature_names, categorical_feature, pandas_categorical
    return (np.asarray(data, dtype=np.float64), feature_names,
            categorical_feature, pandas_categorical)


def _is_binary_dataset(path) -> bool:
    """True when ``path`` is a binary dataset (an npz with the
    ``lgbtpu_dataset`` marker)."""
    try:
        with np.load(str(path), allow_pickle=False) as z:
            return "lgbtpu_dataset" in z
    except (OSError, ValueError):
        return False



def _margin_reached(out: np.ndarray, margin: float) -> np.ndarray:
    """Per-row early-termination test (reference
    prediction_early_stop.cpp — binary: 2*|raw|, multiclass: top-2 gap)."""
    if out.shape[1] == 1:
        return 2.0 * np.abs(out[:, 0]) >= margin
    part = np.partition(out, -2, axis=1)
    return (part[:, -1] - part[:, -2]) >= margin


def _host_leaves(trees: List[Tree], X: np.ndarray, k: int, start: int,
                 end: int) -> np.ndarray:
    """i32 [n, trees]: the leaf of every row in iterations [start, end),
    walked on the host (``pred_leaf``)."""
    leaves = [trees[it * k + c].predict_leaf_index(X)
              for it in range(start, end) for c in range(k)]
    return np.stack(leaves, axis=1) if leaves else \
        np.zeros((X.shape[0], 0), np.int32)


def _host_raw(trees: List[Tree], X: np.ndarray, k: int, start: int,
              end: int, early=None) -> np.ndarray:
    """float64 [n, k] raw scores of iterations [start, end), walked on the
    host; ``early`` = (on, freq, margin) stops a row every ``freq``
    iterations once ``_margin_reached``."""
    out = np.zeros((X.shape[0], k))
    active = np.ones(X.shape[0], bool) if early is not None else None
    for it in range(start, end):
        for c in range(k):
            if early is not None:
                out[active, c] += trees[it * k + c].predict(X[active])
            else:
                out[:, c] += trees[it * k + c].predict(X)
        if early is not None and (it + 1) % early[1] == 0:
            active &= ~_margin_reached(out, early[2])
            if not active.any():
                break
    return out


def _objective_string_transform(out: np.ndarray, obj_str: str) -> np.ndarray:
    """Raw scores [n, k] -> output space, from a model-text objective string
    like ``"binary sigmoid:1"`` (reference ConvertOutput dispatch for
    text-loaded models, objective_function.h; the JAX package's)."""
    obj_tokens = obj_str.split(" ")
    obj = obj_tokens[0]
    if obj == "binary":
        sig = 1.0
        for tok in obj_tokens[1:]:
            if tok.startswith("sigmoid:"):
                sig = float(tok.split(":")[1])
        return 1.0 / (1.0 + np.exp(-sig * out))
    if obj == "multiclass":
        ex = np.exp(out - out.max(axis=1, keepdims=True))
        return ex / ex.sum(axis=1, keepdims=True)
    if obj in ("multiclassova", "cross_entropy"):
        return 1.0 / (1.0 + np.exp(-out))
    if obj in ("poisson", "gamma", "tweedie"):
        return np.exp(out)
    if obj == "cross_entropy_lambda":
        return np.log1p(np.exp(out))
    if obj == "regression" and "sqrt" in obj_tokens[1:]:
        return np.sign(out) * out * out
    return out


class Dataset:
    """Lazily-constructed binned dataset (reference basic.py:1764)."""

    def __init__(self, data: Any, label: Optional[TSeq[float]] = None,
                 reference: Optional["Dataset"] = None,
                 weight: Optional[TSeq[float]] = None,
                 group: Optional[TSeq[int]] = None,
                 init_score: Optional[TSeq[float]] = None,
                 feature_name: Union[str, List[str], None] = "auto",
                 categorical_feature: Union[str, List, None] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.position = position
        self.pandas_categorical: Optional[list] = None
        self._inner: Optional[_InnerDataset] = None
        # continued training: a predictor whose raw predictions become this
        # dataset's init score (reference basic.py:2059
        # _set_init_score_by_predictor)
        self._predictor: Optional["Booster"] = None

    def construct(self) -> "Dataset":
        """Bin the data (once).  A binary dataset path is loaded as it is
        (the metadata given here replaces the file's); a text path is
        parsed, its label and companion files filling what was not given;
        other input is coerced (``_coerce_data``), a valid set's pandas
        categories aligned to its reference's."""
        if self._inner is not None:
            return self
        params = dict(self.params)
        ref_inner = None
        if self.reference is not None:
            self.reference.construct()
            ref_inner = self.reference._inner
            params = {**self.reference.params, **params}
        cfg = Config(params)
        data = self.data
        if isinstance(data, (str, os.PathLike)) and _is_binary_dataset(data):
            self._inner = _InnerDataset.load_binary(str(data), cfg)
            md = self._inner.metadata
            if self.label is not None:
                md.set_label(self.label)
            if self.weight is not None:
                md.set_weight(self.weight)
            if self.group is not None:
                md.set_group(self.group)
            if self.init_score is not None:
                md.set_init_score(self.init_score)
            if self.position is not None:
                md.set_position(self.position)
            if self._predictor is not None:
                log.fatal("init_model continuation requires raw data; "
                          "binary datasets store only binned values")
            if self.free_raw_data:
                self.data = None
            return self
        if isinstance(data, (str, os.PathLike)):
            arr, label, meta = load_text_file(str(data), cfg)
            if self.label is None:
                self.label = label
            for k, v in meta.items():
                if getattr(self, k, None) is None:
                    setattr(self, k, v)
            data = arr
        else:
            ref_cats = self.reference.pandas_categorical \
                if self.reference is not None else None
            data, fn_auto, catf, pcats = _coerce_data(
                data, self.categorical_feature, category_maps=ref_cats)
            if self.feature_name in ("auto", None) and fn_auto:
                self.feature_name = fn_auto
            self.categorical_feature = catf
            self.pandas_categorical = pcats
        fn = None if self.feature_name in ("auto", None) \
            else list(self.feature_name)
        cat = None if self.categorical_feature in ("auto", None) else \
            list(self.categorical_feature)
        if cat is None:
            # categorical_feature may come through params too, under any
            # of its aliases (reference config.h)
            pcat = raw_param(params, "categorical_feature")
            if pcat not in (None, "", "auto"):
                if isinstance(pcat, str):
                    pcat = [int(x) for x in pcat.split(",") if x != ""]
                cat = list(pcat)
        predictor = self._predictor
        if predictor is None and self.reference is not None:
            predictor = self.reference._predictor
        if predictor is not None and self.init_score is None:
            # all of the predictor's trees: they are merged whole into the
            # new booster, so the residuals are against the full model
            raw = predictor.predict(data, raw_score=True, num_iteration=-1)
            # column-major flatten for k outputs (reference basic.py:2089)
            self.init_score = np.asarray(raw, np.float64).reshape(
                -1, order="F")
        self._inner = _InnerDataset.from_data(
            data, label=self.label, config=cfg, weight=self.weight,
            group=self.group, init_score=self.init_score, feature_names=fn,
            categorical_feature=cat, reference=ref_inner)
        if self._inner.metadata.position is None and \
                self.position is not None:
            self._inner.metadata.set_position(self.position)
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, **kwargs) -> "Dataset":
        return Dataset(data, label=label, reference=self, **kwargs)

    @classmethod
    def from_inner(cls, inner: _InnerDataset,
                   params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """Wrap an already-constructed inner dataset (subsets)."""
        d = cls(data=None, params=params)
        d._inner = inner
        d.label = inner.metadata.label
        return d

    def subset(self, used_indices, params: Optional[Dict[str, Any]] = None
               ) -> "Dataset":
        """Row subset sharing the bin mappers (reference Dataset.subset ->
        LGBM_DatasetGetSubset)."""
        self.construct()
        return Dataset.from_inner(self._inner.subset(used_indices),
                                  params or dict(self.params))

    def _apply_predictor(self, predictor: Optional["Booster"]) -> None:
        """Set the continuation predictor (reference basic.py:2576
        ``_set_predictor``).  A constructed dataset gets its init score at
        once, which needs the raw data."""
        self._predictor = predictor
        if predictor is None or self._inner is None:
            return
        if self.data is None:
            log.fatal("Cannot use init_model with a constructed Dataset "
                      "whose raw data was freed; create the Dataset with "
                      "free_raw_data=False")
        raw = predictor.predict(self.data, raw_score=True, num_iteration=-1)
        self._inner.metadata.set_init_score(
            np.asarray(raw, np.float64).reshape(-1, order="F"))

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """This dataset and its chain of references (reference
        Dataset.get_ref_chain)."""
        head, chain = self, set()
        while len(chain) < ref_limit and isinstance(head, Dataset) \
                and head not in chain:
            chain.add(head)
            head = head.reference
        return chain

    @property
    def inner(self) -> _InnerDataset:
        self.construct()
        return self._inner  # type: ignore[return-value]

    def num_data(self) -> int:
        return self.inner.num_data

    def num_feature(self) -> int:
        return self.inner.num_total_features

    def get_label(self) -> np.ndarray:
        return self.inner.metadata.label

    def get_weight(self) -> Optional[np.ndarray]:
        return self.inner.metadata.weight

    def get_group(self) -> Optional[np.ndarray]:
        """Each query's size (None without queries)."""
        qb = self.inner.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.inner.metadata.init_score

    def get_position(self) -> Optional[np.ndarray]:
        """reference Dataset.get_position (position-debiased ranking)."""
        return self.get_field("position")

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(weight)
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(init_score)
        return self

    def set_position(self, position) -> "Dataset":
        pos = np.asarray(position, np.int32)
        self.position = pos
        if self._inner is not None:
            self._inner.metadata.set_position(pos)
        return self

    def get_field(self, field_name: str) -> Optional[np.ndarray]:
        """reference Dataset.get_field: label / weight / init_score as float
        arrays, ``group`` as the cumulative query boundaries (the
        reference's storage form), ``position`` as int."""
        self.construct()
        md = self._inner.metadata
        if field_name == "label":
            return None if md.label is None else np.asarray(md.label)
        if field_name == "weight":
            return None if md.weight is None else np.asarray(md.weight)
        if field_name == "init_score":
            return None if md.init_score is None else \
                np.asarray(md.init_score)
        if field_name == "group":
            qb = md.query_boundaries
            return None if qb is None else np.asarray(qb, np.int32)
        if field_name == "position":
            return None if md.position is None else \
                np.asarray(md.position, np.int32)
        log.fatal(f"Unknown field name: {field_name}")

    def set_field(self, field_name: str, data) -> "Dataset":
        """reference Dataset.set_field."""
        if field_name == "label":
            return self.set_label(data)
        if field_name == "weight":
            return self.set_weight(data)
        if field_name == "init_score":
            return self.set_init_score(data)
        if field_name == "group":
            return self.set_group(np.asarray(data))
        if field_name == "position":
            return self.set_position(data)
        log.fatal(f"Unknown field name: {field_name}")

    def get_data(self):
        """The raw data this Dataset was built from (reference
        Dataset.get_data); fatal once it was freed or for a subset."""
        if self.data is None:
            log.fatal("Cannot get data: the raw data was freed or this "
                      "Dataset was created from a subset")
        return self.data

    def get_params(self) -> Dict[str, Any]:
        """reference Dataset.get_params."""
        return dict(self.params)

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset (reference Dataset.save_binary ->
        LGBM_DatasetSaveBinary c_api.h:516); loading it back skips parsing
        and binning."""
        self.construct()
        self._inner.save_binary(str(filename))
        return self

    def get_feature_name(self) -> List[str]:
        """reference Dataset.get_feature_name."""
        return list(self.feature_names)

    def set_feature_name(self, feature_name: List[str]) -> "Dataset":
        """reference Dataset.set_feature_name."""
        return self.set_feature_names(list(feature_name))

    @property
    def feature_names(self) -> List[str]:
        return self.inner.feature_names

    def set_feature_names(self, names: List[str]) -> "Dataset":
        """LGBM_DatasetSetFeatureNames (c_api.h:551)."""
        names = [str(n) for n in names]
        inner = self.inner
        if len(names) != inner.num_total_features:
            raise ValueError(
                f"{len(names)} names for {inner.num_total_features} features")
        inner.feature_names = names
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """reference Dataset.set_categorical_feature: effective before
        construction; afterwards the binning is fixed."""
        if self._inner is not None and \
                list(categorical_feature or []) != \
                list(self.categorical_feature or []):
            log.warning("set_categorical_feature ignored: the Dataset is "
                        "already constructed with its own binning")
            return self
        self.categorical_feature = categorical_feature
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """reference Dataset.set_reference: bin against another dataset's
        mappers (before construction)."""
        if self._inner is not None and reference is not self.reference:
            log.warning("set_reference ignored: the Dataset is already "
                        "constructed")
            return self
        self.reference = reference
        return self

    def feature_num_bin(self, feature: Union[int, str]) -> int:
        """reference Dataset.feature_num_bin: one feature's bin count."""
        self.construct()
        if isinstance(feature, str):
            feature = self.feature_names.index(feature)
        return int(self._inner.mappers[int(feature)].num_bin)

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append another constructed dataset's features as columns
        (reference LGBM_DatasetAddFeaturesFrom c_api.h:631); neither may be
        EFB-bundled."""
        a, b = self.inner, other.inner
        if a.num_data != b.num_data:
            raise ValueError("datasets hold different row counts")
        if a.bundle_plan is not None or b.bundle_plan is not None:
            raise ValueError(
                "add_features_from does not compose with EFB bundles; "
                "construct both datasets with enable_bundle=false")
        na = a.num_total_features
        a.bins = np.concatenate([a.bins, b.bins], axis=1)
        a.used_feature_idx = list(a.used_feature_idx) + \
            [na + i for i in b.used_feature_idx]
        a.mappers = list(a.mappers) + list(b.mappers)
        a.feature_names = list(a.feature_names) + list(b.feature_names)
        a.num_total_features = na + b.num_total_features
        a._packed_mirror = None
        return self

    def serialize_reference(self) -> bytes:
        """The binning reference (mappers and schema, no rows) as bytes
        (reference LGBM_DatasetSerializeReferenceToBinary), in the JAX
        package's JSON form."""
        import json
        inner = self.inner
        doc = {
            "lgbtpu_reference": 1,
            "mappers": [m.to_dict() for m in inner.mappers],
            "used_feature_idx": list(map(int, inner.used_feature_idx)),
            "num_total_features": int(inner.num_total_features),
            "feature_names": list(inner.feature_names),
            "params": {k: v for k, v in (self.params or {}).items()
                       if isinstance(v, (str, int, float, bool))},
        }
        return json.dumps(doc).encode()

    @classmethod
    def deserialize_reference(cls, raw: bytes) -> "Dataset":
        """A row-less reference Dataset whose ``create_valid`` bins new
        rows on the serialized mappers (reference
        LGBM_DatasetCreateFromSerializedReference c_api.h:142)."""
        import json
        from .io.binning import BinMapper
        from .io.dataset import Metadata
        doc = json.loads(raw.decode())
        if not doc.get("lgbtpu_reference"):
            raise ValueError("not a serialized dataset reference")
        inner = _InnerDataset()
        inner.mappers = [BinMapper.from_dict(d) for d in doc["mappers"]]
        inner.used_feature_idx = doc["used_feature_idx"]
        inner.num_total_features = doc["num_total_features"]
        inner.feature_names = doc["feature_names"]
        inner.bins = np.zeros((0, len(inner.used_feature_idx)), np.uint8)
        inner.metadata = Metadata(0)
        return cls.from_inner(inner, params=doc.get("params") or {})


class Booster:
    """Trained/trainable model handle (reference basic.py:3586)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = normalize_params(params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._gbdt = None
        self._loaded: Optional[Dict[str, Any]] = None
        # (trees, device, tables) of _standalone_forest
        self._loaded_forest: Optional[tuple] = None
        self.train_set = train_set
        self.pandas_categorical: Optional[list] = None
        if model_file is not None:
            try:
                with open(model_file) as f:
                    model_str = f.read()
            except OSError as e:
                raise log.LightGBMError(
                    f"cannot read model file {str(model_file)!r}: "
                    f"{type(e).__name__}: {e}") from e
        if model_str is not None:
            try:
                self._loaded = parse_model_string(model_str)
            except log.LightGBMError:
                raise
            except Exception as e:
                raise log.LightGBMError(
                    f"failed to parse model string: {type(e).__name__}: {e}"
                ) from e
            self.pandas_categorical = self._loaded.get("pandas_categorical")
            return
        if train_set is None:
            log.fatal("Booster requires train_set or a model to load")
        train_set.params = {**train_set.params, **self.params}
        train_set.construct()
        self.pandas_categorical = train_set.pandas_categorical
        self._gbdt = create_boosting(Config(self.params), train_set.inner)
        # continued training: the init model's trees ahead of the new ones
        # (reference basic.py:3675 LGBM_BoosterMerge -> gbdt.h:70
        # MergeFrom)
        if train_set._predictor is not None:
            self._gbdt.merge_from(train_set._predictor._get_trees())

    # ------------------------------------------------------------ training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct()
        if not hasattr(self, "_valid_lookup"):
            self._valid_lookup = {}
        self._valid_lookup[data] = len(self._gbdt.valid_sets)
        self._gbdt.add_valid(data.inner, name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting round (reference Booster.update ->
        LGBM_BoosterUpdateOneIter; with ``fobj`` ->
        LGBM_BoosterUpdateOneIterCustom).  ``fobj(preds, train_set)``
        returns (grad, hess) for the current raw scores (float64, [n], or
        [n, k] for k outputs); they reach the device once, as float32.
        Another ``train_set`` than the booster's replaces its training
        data first (``reset_training_data``), as in the reference."""
        if train_set is not None and train_set is not self.train_set:
            self.reset_training_data(train_set)
        if fobj is None:
            return self._gbdt.train_one_iter()
        if self._gbdt.objective is not None:
            log.fatal("Cannot use fobj with a built-in objective; set "
                      "objective=none")
        grad, hess = fobj(self._current_train_preds(), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

    def _current_train_preds(self) -> np.ndarray:
        return self._gbdt._host_scores(self._gbdt.scores)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores (never the
        init model's)."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """LGBM_BoosterResetParameter (c_api.h:853): swap learning-control
        parameters on the live booster (``GBDT.reset_config``)."""
        self.params = {**self.params, **normalize_params(params)}
        if self._gbdt is not None:
            self._gbdt.reset_config(Config(self.params))
        return self

    def telemetry(self) -> Dict[str, Any]:
        """Counters and gauges accumulated while training (obs/metrics.py);
        ``phases`` and ``memory`` stay empty until the JAX package's phase
        timers and memory sampling are ported.  A loaded booster reports
        empty dicts."""
        if self._gbdt is not None:
            return self._gbdt.telemetry()
        return {"counters": {}, "gauges": {}, "phases": {}, "memory": {}}

    @property
    def current_iteration(self):
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees() if self._gbdt else \
            len(self._loaded["trees"])

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration if self._gbdt else \
            self._loaded["num_tree_per_iteration"]

    # ---------------------------------------------------------- evaluation
    def eval_train(self):
        out = self._gbdt.eval_train()
        name = getattr(self, "_train_data_name", "training")
        if name != "training":
            out = [(name,) + r[1:] for r in out]
        return out

    def eval_valid(self):
        return self._gbdt.eval_valid()

    def _check_valid_alignment(self, data: Dataset) -> None:
        """The reference refuses validation data with other bin mappers
        (Dataset::CheckAlign): its bins would mean other values."""
        if self.train_set is not None and \
                self.train_set in data.get_ref_chain():
            return
        data.construct()
        tm = self._gbdt.train_set.mappers
        vm = data.inner.mappers

        def same(a, b):
            return (a.bin_type == b.bin_type and a.num_bin == b.num_bin
                    and np.array_equal(np.asarray(a.bin_upper_bound),
                                       np.asarray(b.bin_upper_bound))
                    and list(getattr(a, "bin_2_categorical", []) or []) ==
                    list(getattr(b, "bin_2_categorical", []) or []))

        if len(tm) != len(vm) or any(not same(a, b)
                                     for a, b in zip(tm, vm)):
            log.fatal("cannot evaluate data with different bin mappers; "
                      "build it with create_valid / reference=")

    def eval(self, data: Dataset, name: str, feval=None) -> List[tuple]:
        """Evaluate the current model on ``data`` (reference Booster.eval):
        the training set and registered valid sets use their score caches;
        another aligned Dataset is registered as a valid set (and stays
        so), its scores built from the trees.  ``feval`` (one callable or a
        list) gets the raw scores (float64) and ``data``."""
        if self._gbdt is None:
            return self._eval_loaded(data, name, feval)
        g = self._gbdt
        if data is self.train_set:
            out = [(name,) + r[1:] for r in self.eval_train()]
            scores = g.scores
        else:
            if data not in getattr(self, "_valid_lookup", {}):
                self._check_valid_alignment(data)
                self.add_valid(data, name)
                g.invalidate_score_cache(
                    only_valid_index=self._valid_lookup[data])
            vi = self._valid_lookup[data]
            out = [(name,) + r[1:] for r in g._eval_metric_list(
                g.valid_names[vi], g.valid_metrics[vi], g.valid_scores[vi])]
            scores = g.valid_scores[vi]
        if feval is not None:
            sc = g._host_scores(scores)
            for f in feval if isinstance(feval, (list, tuple)) else [feval]:
                out.append((name,) + tuple(f(sc, data)))
        return out

    def _eval_loaded(self, data: Dataset, name: str, feval) -> List[tuple]:
        """A loaded model's evaluation (the JAX package's): the metrics and
        output conversion of the model's objective (its header tokens, then
        the booster's params), on the host walk's raw scores of ``data``'s
        raw rows (``free_raw_data=False``) plus its init score."""
        from .metrics import create_metrics
        from .objectives import create_objective
        data.construct()
        obj_toks = str(self._loaded.get("objective", "none")).split()
        obj_extra = {t.split(":", 1)[0]: t.split(":", 1)[1]
                     for t in obj_toks[1:] if ":" in t}
        cfg = Config({**(self._loaded.get("params") or {}), **obj_extra,
                      "objective": obj_toks[0] if obj_toks else "none",
                      **self.params})
        ms = create_metrics(cfg)
        md = data.inner.metadata
        for m in ms:
            m.init(md, data.inner.num_data)
        try:
            obj = create_objective(cfg)
            if obj is not None:
                obj.init(md, data.inner.num_data)
        except Exception:
            obj = None
        raw = np.asarray(self.predict(data.get_data(), raw_score=True),
                         np.float64)
        k = self.num_model_per_iteration()
        score = raw if k == 1 else raw.reshape(-1, k, order="F")
        isc = md.init_score
        if isc is not None:
            score = score + (np.asarray(isc).reshape(score.shape, order="F")
                             if np.size(isc) == score.size
                             else np.asarray(isc).reshape(-1, 1))
        out = []
        for m in ms:
            for mname, val in m.eval(score, obj):
                out.append((name, mname, val, m.bigger_is_better))
        if feval is not None:
            sc = score[:, 0] if score.ndim == 2 and score.shape[1] == 1 \
                else score
            for f in feval if isinstance(feval, (list, tuple)) else [feval]:
                out.append((name,) + tuple(f(sc, data)))
        return out

    # ---------------------------------------------------------- prediction
    def predict(self, data: Any, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False, pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                **kwargs) -> np.ndarray:
        """Scores, leaf indices (``pred_leaf``: i32 [n, trees]) or SHAP
        contributions (``pred_contrib``: [n, F + 1], class-major for k
        outputs) of the model's iterations [start_iteration,
        start_iteration + num_iteration) (all, or up to ``best_iteration``,
        when ``num_iteration`` is None).  ``pred_early_stop`` stops a row
        every ``pred_early_stop_freq`` iterations once its margin reaches
        ``pred_early_stop_margin`` (host walk).

        ``data``: a matrix, a pandas frame (category columns through the
        training category lists), a pyarrow Table, or scipy sparse, made
        dense in row blocks of about 512 MB each (the JAX package's
        geometry), never as a whole."""
        if _is_sparse(data):
            block = max(256, min(65536, self.SPARSE_BLOCK_BYTES
                                 // (8 * max(data.shape[1], 1))))
            if data.shape[0] > block:
                csr = data.tocsr()
                blocks = [self.predict(
                    csr[r0:r0 + block], start_iteration=start_iteration,
                    num_iteration=num_iteration, raw_score=raw_score,
                    pred_leaf=pred_leaf, pred_contrib=pred_contrib,
                    pred_early_stop=pred_early_stop,
                    pred_early_stop_freq=pred_early_stop_freq,
                    pred_early_stop_margin=pred_early_stop_margin, **kwargs)
                    for r0 in range(0, data.shape[0], block)]
                return np.concatenate(blocks, axis=0)
        X = self._to_matrix(data)
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        if pred_contrib:
            return self._predict_contrib(X, start_iteration, num_iteration)
        early = (pred_early_stop, pred_early_stop_freq,
                 pred_early_stop_margin) if pred_early_stop else None
        if self._gbdt is not None:
            return self._gbdt.predict(X, raw_score=raw_score,
                                      start_iteration=start_iteration,
                                      num_iteration=num_iteration,
                                      pred_leaf=pred_leaf, early=early)
        return self._predict_loaded(X, start_iteration, num_iteration,
                                    raw_score, pred_leaf, early)

    #: scipy input's row blocks at predict time: dense float64 blocks of at
    #: most this many bytes, 256 to 65,536 rows (a class attribute so tests
    #: can shrink it)
    SPARSE_BLOCK_BYTES = 512 << 20

    def _to_matrix(self, data: Any) -> np.ndarray:
        """Predict-time input as float64: a pyarrow Table through pandas,
        a pandas frame's category columns through the training category
        lists (``pandas_categorical``), a sparse block made dense."""
        if hasattr(data, "column_names") and hasattr(data, "to_pandas"):
            data = data.to_pandas()
        if hasattr(data, "columns") and hasattr(data, "dtypes"):
            data, _, _ = _convert_pandas_categorical(
                data, stored=self.pandas_categorical)
            return data.to_numpy(dtype=np.float64, na_value=np.nan)
        if _is_sparse(data):
            # column-major: binning and the host walk read whole columns
            return np.asarray(data.toarray(order="F"), np.float64)
        return np.asarray(data, np.float64)

    def _predict_loaded(self, X, start_iteration, num_iteration, raw_score,
                        pred_leaf=False, early=None) -> np.ndarray:
        """A loaded model's scores or leaves.  Scores of at least
        ``GBDT.DEVICE_PREDICT_MIN_WORK`` row-trees with no early stop take
        :meth:`_loaded_device_raw`; the rest, and leaves, the host walk."""
        from .boosting.gbdt import GBDT
        trees = self._loaded["trees"]
        k = self._loaded["num_tree_per_iteration"]
        total_iters = len(trees) // k if k else 0
        end = total_iters if num_iteration is None or num_iteration <= 0 \
            else min(total_iters, start_iteration + num_iteration)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if pred_leaf:
            return _host_leaves(trees, X, k, start_iteration, end)
        out = None
        used = trees[start_iteration * k:end * k]
        if early is None and used and \
                X.shape[0] * len(used) >= GBDT.DEVICE_PREDICT_MIN_WORK:
            out = self._loaded_device_raw(X, used, k)
        if out is None:
            out = _host_raw(trees, X, k, start_iteration, end, early)
        if not raw_score:
            out = _objective_string_transform(out, self._loaded["objective"])
        return out[:, 0] if k == 1 else out

    def _standalone_forest(self, trees: List[Tree],
                           k: int) -> Optional[tuple]:
        """(bin, forest, cat_feats) of a loaded model's ``trees``: the bin
        tables serving/standalone.py builds from them (``bin``: raw [n, F]
        -> i32 logical bins) and their forest on the model's device
        (``params["device_type"]``: the card unless ``cpu``); None where
        those tables cannot be built.  Made at the first call and kept
        while the model's trees are these objects on this device (a merge,
        a shuffle or a rollback replaces trees; ``set_leaf_output`` drops
        it)."""
        c = self._loaded_forest
        if c is None or len(c[0]) != len(trees) or \
                any(a is not b for a, b in zip(c[0], trees)) or \
                (c[2] is not None and
                 c[1] != resolve_device(self.params.get("device_type"))):
            from .models.predict import forest_from_numpy
            from .serving.standalone import (StandaloneUnsupported,
                                             build_standalone)
            try:
                binner, fd, cat_feats = build_standalone(
                    trees, self.num_feature(), k)
            except StandaloneUnsupported as e:
                log.warning(f"no standalone bin tables for the loaded model "
                            f"({e}); it is walked on the host")
                c = self._loaded_forest = (tuple(trees), None, None)
                return None
            dev = resolve_device(self.params.get("device_type"))
            c = self._loaded_forest = (tuple(trees), dev, (
                binner.bin, forest_from_numpy(fd, dev), cat_feats))
        return c[2]

    def _loaded_device_raw(self, X: np.ndarray, trees: List[Tree],
                           k: int) -> Optional[np.ndarray]:
        """float64 [n, k] raw scores of a loaded model's ``trees`` with the
        walk on the model's device, or None without standalone tables
        (:meth:`_standalone_forest`).  X is binned once by those tables
        and copied to the device once; the forest kernel's leaves mode
        (its plain version on the CPU) runs once a block of
        ``GBDT.PREDICT_BLOCK_ROWS`` rows into host leaves i32 [T, n], and
        the leaf values of all rows are added in host float64 tree by tree
        in the host walk's order, so the scores are the host walk's bit for
        bit (a linear leaf's dot runs over the same rows as there)."""
        import torch
        from .boosting.gbdt import GBDT
        from .ops import forest_kernels
        tables = self._standalone_forest(trees, k)
        if tables is None:
            return None
        bin_rows, forest, cat_feats = tables
        bins_t = torch.as_tensor(np.ascontiguousarray(bin_rows(X).T),
                                 device=forest.feat.device)
        blk = int(GBDT.PREDICT_BLOCK_ROWS)
        leaves = np.empty((len(trees), X.shape[0]), np.int32)
        for r0 in range(0, X.shape[0], blk):
            leaves[:, r0:r0 + blk] = forest_kernels.forest_leaves(
                forest, bins_t[:, r0:r0 + blk], cat_feats).cpu().numpy()
        out = np.zeros((X.shape[0], k))
        for ti, t in enumerate(trees):
            out[:, ti % k] += t.values_from_leaf_index(X, leaves[ti])
        return out

    def _predict_contrib(self, X, start_iteration,
                         num_iteration) -> np.ndarray:
        """SHAP contributions (reference PredictContrib,
        gbdt_prediction.cpp:44; models/shap.py TreeSHAP).  The device part
        runs on the booster's device; a loaded model's device comes from
        ``params["device_type"]`` (the card unless ``cpu``), resolved only
        when the device part runs."""
        from .models.shap import DEVICE_CONTRIB_MIN_WORK, predict_contrib
        trees = self._get_trees()
        k = self.num_model_per_iteration()
        nf = (self._gbdt.train_set.num_total_features if self._gbdt
              else self._loaded["max_feature_idx"] + 1)
        end = -1 if num_iteration is None or num_iteration <= 0 else \
            start_iteration + num_iteration
        n = X.reshape(-1, X.shape[-1]).shape[0]
        device = None
        if n * max((t.num_leaves for t in trees),
                   default=1) > DEVICE_CONTRIB_MIN_WORK:
            device = self._gbdt.device if self._gbdt is not None else \
                resolve_device(self.params.get("device_type"))
        return predict_contrib(trees, X, nf, k, start_iteration, end,
                               device=device)

    def _get_trees(self) -> List[Tree]:
        return self._gbdt.models if self._gbdt is not None \
            else self._loaded["trees"]

    # --------------------------------------------------------------- refit
    @staticmethod
    def _refit_trees(trees: List[Tree], k: int, objective, device, leaf_of,
                     n: int, decay_rate: float, l1: float, l2: float) -> None:
        """New leaf values of ``trees`` in place, iteration by iteration
        (reference GBDT::RefitTree gbdt.cpp:258, FitByExistingTree
        serial_tree_learner.cpp:249-276; the JAX package's formulation):
        the objective's float32 gradients at the refitted model's scores,
        each leaf's sums in float64 in row order, L1 thresholding, the
        tree's shrinkage, then ``decay * old + (1 - decay) * new``.
        ``leaf_of(it, c)``: the rows' leaves in tree ``it * k + c``."""
        import torch
        scores = np.zeros((n, k))
        for it in range(len(trees) // k):
            sc = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                                 dtype=torch.float32, device=device)
            g, h = objective.get_gradients(sc)
            g = g.cpu().numpy().astype(np.float64).reshape(n, k, order="F")
            h = h.cpu().numpy().astype(np.float64).reshape(n, k, order="F")
            for c in range(k):
                t = trees[it * k + c]
                leaf = leaf_of(it, c)
                sg = np.bincount(leaf, weights=g[:, c],
                                 minlength=t.num_leaves)
                sh = np.bincount(leaf, weights=h[:, c],
                                 minlength=t.num_leaves)
                sg_reg = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
                new_out = -sg_reg / (sh + l2 + 1e-15) * t.shrinkage
                t.leaf_value = decay_rate * t.leaf_value + \
                    (1.0 - decay_rate) * new_out
                scores[:, c] += t.leaf_value[leaf]

    def refit(self, data: Any, label, decay_rate: Optional[float] = None,
              weight=None, group=None, **kwargs) -> "Booster":
        """Refit the leaf values of the existing trees on new data
        (reference GBDT::RefitTree gbdt.cpp:258, LGBM_BoosterRefit
        c_api.h:776): a new (loaded) Booster, the same structures, each
        leaf ``decay * old + (1 - decay) * new`` under the built-in
        objective (a loaded model's from its header).  The rows' leaves
        come from the host walk."""
        from .io.dataset import Metadata
        from .objectives import create_objective
        params = dict(self.params)
        if self._gbdt is None and self._loaded is not None:
            params = {**objective_string_to_params(self._loaded["objective"]),
                      **params}
        cfg = Config(params)
        if decay_rate is None:
            decay_rate = float(cfg.refit_decay_rate)
        X = self._to_matrix(data)
        n = X.shape[0]
        md = Metadata(n)
        md.set_label(np.asarray(label, np.float64))
        if weight is not None:
            md.set_weight(weight)
        if group is not None:
            md.set_group(group)
        objective = create_objective(cfg)
        if objective is None:
            log.fatal("refit requires a built-in objective")
        # the booster's device, or for a loaded model the card unless
        # params say cpu
        device = self._gbdt.device if self._gbdt is not None else \
            resolve_device(self.params.get("device_type"))
        objective.init(md, n, device)
        new_booster = Booster(model_str=self.model_to_string(num_iteration=-1))
        new_booster.params = dict(self.params)
        trees = new_booster._loaded["trees"]
        k = max(1, new_booster._loaded["num_tree_per_iteration"])
        self._refit_trees(
            trees, k, objective, device,
            lambda it, c: trees[it * k + c].predict_leaf_index(X), n,
            decay_rate, float(cfg.lambda_l1), float(cfg.lambda_l2))
        return new_booster

    def refit_from_leaf_preds(self, leaf_preds: np.ndarray,
                              decay_rate: Optional[float] = None
                              ) -> "Booster":
        """Refit the leaf values in place from an [n, num_trees] leaf-index
        matrix of the training set (reference LGBM_BoosterRefit); the score
        caches are rebuilt from the refitted trees."""
        if self._gbdt is None:
            log.fatal("refit_from_leaf_preds needs a booster with training "
                      "state (use refit(data, label) on loaded models)")
        g = self._gbdt
        cfg = g.config
        if decay_rate is None:
            decay_rate = float(cfg.refit_decay_rate)
        trees = g.models
        k = max(1, g.num_tree_per_iteration)
        leaf_preds = np.asarray(leaf_preds)
        if leaf_preds.shape[1] != len(trees):
            log.fatal(f"leaf matrix has {leaf_preds.shape[1]} columns for "
                      f"{len(trees)} trees")
        if g.objective is None:
            log.fatal("refit requires a built-in objective")
        self._refit_trees(
            trees, k, g.objective, g.device,
            lambda it, c: leaf_preds[:, it * k + c], leaf_preds.shape[0],
            decay_rate, float(cfg.lambda_l1), float(cfg.lambda_l2))
        g.invalidate_score_cache()
        return self

    # ------------------------------------------------------------- im/export
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        if self._gbdt is None:
            d = self._loaded
            return model_to_string(
                d["trees"], num_class=d["num_class"],
                num_tree_per_iteration=d["num_tree_per_iteration"],
                max_feature_idx=d["max_feature_idx"],
                objective_str=d["objective"], feature_names=d["feature_names"],
                feature_infos=d["feature_infos"], params={},
                pandas_categorical=self.pandas_categorical)
        g = self._gbdt
        ds = g.train_set
        k = g.num_tree_per_iteration
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        total_iters = len(g.models) // k
        end = total_iters if num_iteration <= 0 else \
            min(total_iters, start_iteration + num_iteration)
        trees = [g.models[it * k + c] for it in range(start_iteration, end)
                 for c in range(k)]
        feature_infos = []
        for j in range(ds.num_total_features):
            m = ds.mappers[j]
            if m.is_trivial():
                feature_infos.append("none")
            elif m.bin_type == 1:
                feature_infos.append(
                    ":".join(str(c) for c in m.bin_2_categorical) or "none")
            else:
                feature_infos.append(f"[{m.min_val:g}:{m.max_val:g}]")
        obj_str = objective_to_string(
            g.objective.NAME if g.objective is not None else "none",
            g.config)
        return model_to_string(
            trees, num_class=g.num_class, num_tree_per_iteration=k,
            max_feature_idx=ds.num_total_features - 1, objective_str=obj_str,
            feature_names=ds.feature_names, feature_infos=feature_infos,
            params=g.config._explicit,
            pandas_categorical=self.pandas_categorical)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0, **kwargs) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def feature_name(self) -> List[str]:
        if self._gbdt is not None:
            return self._gbdt.train_set.feature_names
        return self._loaded["feature_names"]

    def num_feature(self) -> int:
        """Number of features the model was trained on (reference
        LGBM_BoosterGetNumFeature c_api.h:876)."""
        return len(self.feature_name())

    # ------------------------------------------------------- model edits
    def merge_models(self, other: "Booster") -> "Booster":
        """Append the other model's trees (reference LGBM_BoosterMerge
        c_api.h:680), as copies; a training booster's score caches are
        rebuilt on its device."""
        import copy
        trees = other._get_trees()
        if self._gbdt is not None:
            self._gbdt.append_models(trees)
        else:
            self._loaded["trees"].extend(copy.deepcopy(trees))
        return self

    def reset_training_data(self, train_set: Dataset) -> "Booster":
        """LGBM_BoosterResetTrainingData (c_api.h:843): train on
        ``train_set`` from now on; it must be binned like the old set
        (``GBDT.reset_training_data``)."""
        train_set.construct()
        if self._gbdt is None:
            log.fatal("reset_training_data needs a training booster")
        self._gbdt.reset_training_data(train_set.inner)
        self.train_set = train_set
        return self

    def shuffle_models(self, start: int = 0, end: int = -1) -> "Booster":
        """LGBM_BoosterShuffleModels (c_api.h:698): permute whole
        iterations in [start, end), the permutation the JAX package draws
        (``default_rng(seed or 1)``); a training booster's score caches are
        rebuilt."""
        k = max(1, self.num_model_per_iteration())
        trees = self._get_trees()
        n_iter = len(trees) // k
        end = n_iter if end < 0 else min(end, n_iter)
        start = max(0, start)
        if end - start > 1:
            rng = np.random.default_rng(int(self.params.get("seed") or 1))
            perm = rng.permutation(end - start) + start
            groups = [trees[i * k:(i + 1) * k] for i in range(n_iter)]
            shuffled = groups[:start] + [groups[p] for p in perm] \
                + groups[end:]
            flat = [t for grp in shuffled for t in grp]
            if self._gbdt is not None:
                self._gbdt.models = flat
                self._gbdt.invalidate_score_cache()
            else:
                self._loaded["trees"] = flat
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """reference Booster.get_leaf_output / LGBM_BoosterGetLeafValue."""
        return float(self._get_trees()[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """reference Booster.set_leaf_output / LGBM_BoosterSetLeafValue: a
        linear leaf becomes the constant ``value``; a training booster's
        score caches are rebuilt."""
        t = self._get_trees()[tree_id]
        t.leaf_value[leaf_id] = float(value)
        self._loaded_forest = None   # its forest holds the leaf values
        if t.is_linear:
            t.leaf_const[leaf_id] = float(value)
            t.leaf_coeff[leaf_id] = []
            t.leaf_features[leaf_id] = []
        if self._gbdt is not None:
            self._gbdt.invalidate_score_cache()
        return self

    def model_from_string(self, model_str: str) -> "Booster":
        """Load a model into this booster (reference
        Booster.model_from_string): the model state is replaced, the
        booster's params kept, the training state dropped."""
        other = Booster(model_str=model_str)
        self._gbdt = None
        self._loaded = other._loaded
        self.pandas_categorical = other.pandas_categorical
        self.best_iteration = -1
        self.train_set = None
        self._valid_lookup = {}
        self._train_data_name = "training"
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """reference Booster.set_train_data_name: the training set's name
        in ``eval_train``."""
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """reference Booster.free_dataset: drop the reference to the
        training Dataset (the booster's device state stays)."""
        self.train_set = None
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """reference Booster.set_network: multi-device training is not
        ported (ROADMAP Queue 1 item 6)."""
        log.fatal("set_network (multi-device training, ROADMAP Queue 1 "
                  "item 6) is not supported by lightgbm_tpu_torch yet")

    def free_network(self) -> "Booster":
        """reference Booster.free_network (ROADMAP Queue 1 item 6)."""
        log.fatal("free_network (multi-device training, ROADMAP Queue 1 "
                  "item 6) is not supported by lightgbm_tpu_torch yet")

    def prometheus_text(self) -> str:
        """The JAX package's Prometheus exposition belongs to its ``obs/``
        layer (ROADMAP Queue 1 item 8), not ported."""
        log.fatal("prometheus_text (the obs/ layer, ROADMAP Queue 1 item "
                  "8) is not supported by lightgbm_tpu_torch yet")

    # -------------------------------------------------------- inspection
    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict[str, Any]:
        """The model as a dict (reference Booster.dump_model, the parsed
        JSON of LGBM_BoosterDumpModel; models/model_io.py
        ``model_to_dict``): every tree, as the JAX package dumps it."""
        if self._gbdt is not None:
            g = self._gbdt
            return model_to_dict(
                g.models, num_class=g.num_class,
                num_tree_per_iteration=g.num_tree_per_iteration,
                max_feature_idx=g.train_set.num_total_features - 1,
                objective_str=objective_to_string(
                    g.objective.NAME if g.objective is not None else "none",
                    g.config),
                feature_names=g.train_set.feature_names)
        d = self._loaded
        return model_to_dict(
            d["trees"], num_class=d["num_class"],
            num_tree_per_iteration=d["num_tree_per_iteration"],
            max_feature_idx=d["max_feature_idx"],
            objective_str=d["objective"], feature_names=d["feature_names"])

    def trees_to_dataframe(self):
        """The model as a pandas DataFrame, one row a node (reference
        Booster.trees_to_dataframe): tree_index, node_depth, node_index,
        left_child, right_child, parent_index, split_feature, split_gain,
        threshold (a categorical node's '||'-joined categories),
        decision_type, missing_direction, missing_type, value, weight,
        count; nodes in depth-first order, left first."""
        import pandas as pd
        from .models.tree import _decode_decision_type
        rows = []
        names = self.feature_name()

        def visit(t, ti, node, depth, parent):
            if node < 0:
                leaf = -node - 1
                tag = f"{ti}-L{leaf}"
                rows.append(dict(
                    tree_index=ti, node_depth=depth, node_index=tag,
                    left_child=None, right_child=None, parent_index=parent,
                    split_feature=None, split_gain=None, threshold=None,
                    decision_type=None, missing_direction=None,
                    missing_type=None, value=float(t.leaf_value[leaf]),
                    weight=float(t.leaf_weight[leaf]),
                    count=int(t.leaf_count[leaf])))
                return tag, None
            tag = f"{ti}-S{node}"
            is_cat, default_left, missing_type = _decode_decision_type(
                int(t.decision_type[node]))
            if is_cat:
                csi = int(t.cat_split_index[node])
                thr_out = "||".join(str(c) for c in t.cat_threshold[csi])
            else:
                thr_out = float(t.threshold[node])
            row = dict(
                tree_index=ti, node_depth=depth, node_index=tag,
                parent_index=parent,
                split_feature=names[int(t.split_feature[node])],
                split_gain=float(t.split_gain[node]),
                threshold=thr_out,
                decision_type="==" if is_cat else "<=",
                missing_direction="left" if default_left else "right",
                missing_type=["None", "Zero", "NaN"][missing_type],
                value=float(t.internal_value[node]),
                weight=float(t.internal_weight[node])
                if len(t.internal_weight) > node else 0.0,
                count=int(t.internal_count[node]))
            rows.append(row)
            return tag, row

        for ti, t in enumerate(self._get_trees()):
            # an explicit stack: a leaf-wise tree can be num_leaves deep
            stack = [(0 if t.num_leaves > 1 else -1, 1, None, None, None)]
            while stack:
                node, depth, parent, prow, side = stack.pop()
                tag, row = visit(t, ti, node, depth, parent)
                if prow is not None:
                    prow[side] = tag
                if row is not None:
                    stack.append((int(t.right_child[node]), depth + 1, tag,
                                  row, "right_child"))
                    stack.append((int(t.left_child[node]), depth + 1, tag,
                                  row, "left_child"))
        cols = ["tree_index", "node_depth", "node_index", "left_child",
                "right_child", "parent_index", "split_feature", "split_gain",
                "threshold", "decision_type", "missing_direction",
                "missing_type", "value", "weight", "count"]
        return pd.DataFrame(rows).reindex(columns=cols)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Per original feature: the number of splits on it (``split``) or
        their summed gains (``gain``, negative gains counted as 0), over
        every tree, as the JAX package counts them."""
        trees = self._get_trees()
        nf = (self._gbdt.train_set.num_total_features if self._gbdt
              else self._loaded["max_feature_idx"] + 1)
        imp = np.zeros(nf)
        for t in trees:
            for i in range(t.num_leaves - 1):
                if importance_type == "split":
                    imp[t.split_feature[i]] += 1
                else:
                    imp[t.split_feature[i]] += max(float(t.split_gain[i]),
                                                   0.0)
        return imp

    def upper_bound(self) -> float:
        """reference Booster.upper_bound: the sum over trees of each
        tree's largest leaf output (GBDT::GetUpperBoundValue)."""
        return float(sum(float(np.max(t.leaf_value)) if t.num_leaves else 0.0
                         for t in self._get_trees()))

    def lower_bound(self) -> float:
        """reference Booster.lower_bound (GBDT::GetLowerBoundValue)."""
        return float(sum(float(np.min(t.leaf_value)) if t.num_leaves else 0.0
                         for t in self._get_trees()))

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """reference Booster.get_split_value_histogram: a histogram of the
        model's numeric thresholds on one feature ((counts, edges), or
        [[edge, count], ...] of the non-empty bins ``xgboost_style``)."""
        fnames = self.feature_name()
        fidx = fnames.index(feature) if isinstance(feature, str) \
            else int(feature)
        values = []
        for t in self._get_trees():
            for i in range(max(t.num_leaves - 1, 0)):
                if int(t.split_feature[i]) == fidx and \
                        not (int(t.decision_type[i]) & 1):
                    values.append(float(t.threshold[i]))
        values = np.asarray(values, np.float64)
        if bins is None:
            bins = max(len(np.unique(values)), 1)
        hist, edges = np.histogram(values, bins=bins)
        if not xgboost_style:
            return hist, edges
        nz = hist > 0
        return np.column_stack([edges[1:][nz], hist[nz]])

"""Binned Dataset + Metadata.

Counterpart of ``lightgbm_tpu/io/dataset.py`` for dense numeric input
(reference: include/LightGBM/dataset.h:487 ``Dataset``, dataset.h:48
``Metadata``, src/io/dataset_loader.cpp ``DatasetLoader``).  The binned data
is one row-major ``uint8`` matrix ``[n_rows, n_used_features]`` built on the
host with NumPy; the booster copies it to the torch device once
(boosting/gbdt.py).  Binning, trivial-feature dropping and the EFB plan run
the same NumPy code as ``lightgbm_tpu``, so the same input gives the same
bytes.

External matrices bin the same way for the device forest predictor
(``bin_external``, ``bin_external_pred``).

With ``linear_tree`` set, a dataset (training or valid) also keeps the
raw float32 values of its used features (``raw`` [n, F_used], NaN kept),
which the linear-leaf fit and scores read (reference Dataset raw_data_;
the JAX package's ``raw``).

``subset`` takes rows of a constructed dataset with its mappers and EFB
plan (cv's folds).

Not in this package yet: sparse (scipy) input, ``save_binary`` /
``load_binary``, streamed and sharded ingest.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..config import Config, as_config
from ..utils import log
from .binning import BIN_CATEGORICAL, BinMapper
from .bundling import BundlePlan, apply_bundles, plan_bundles

MAX_UINT8_BINS = 256

#: raw values a matrix holds from which its columns bin on a thread each
#: (NumPy's casts and searchsorted release the GIL; the bytes are the same)
PARALLEL_BIN_VALUES = 1 << 22


def device_bins_pow2(widest: int) -> int:
    """Device histogram bin-axis width for a widest-column bin count:
    rounded up to a power of two, floor 4 (the rule ``lightgbm_tpu`` uses,
    so histograms of both packages have the same shape)."""
    return max(1 << max(1, (int(widest) - 1).bit_length()), 4)


def _as_2d_float(data: Any) -> np.ndarray:
    """Accept numpy / pandas / list-of-rows; return float64 [n, F] with NaN
    for missing."""
    if hasattr(data, "tocsc") and hasattr(data, "nnz"):
        log.fatal("sparse input is not supported by lightgbm_tpu_torch yet; "
                  "pass a dense matrix")
    if hasattr(data, "values") and hasattr(data, "columns"):  # pandas
        arr = data.to_numpy(dtype=np.float64, na_value=np.nan)
    else:
        arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        log.fatal(f"data must be 2-dimensional, got shape {arr.shape}")
    return arr


class Metadata:
    """Labels / weights / query boundaries / init scores / positions
    (reference dataset.h:48-360)."""

    def __init__(self, num_data: int):
        self.num_data = int(num_data)
        self.label: np.ndarray = np.zeros(num_data, dtype=np.float32)
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [nq+1]
        self.init_score: Optional[np.ndarray] = None
        self.position: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            log.fatal(f"Length of label ({len(label)}) != num_data "
                      f"({self.num_data})")
        self.label = label

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            log.fatal(f"Length of weight ({len(weight)}) != num_data "
                      f"({self.num_data})")
        if (weight < 0).any():
            log.fatal("Weights should be non-negative")
        self.weight = weight

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        """``group`` is per-query SIZES (python-package convention)."""
        if group is None:
            self.query_boundaries = None
            return
        sizes = np.asarray(group).astype(np.int64)
        bounds = np.zeros(len(sizes) + 1, dtype=np.int32)
        np.cumsum(sizes, out=bounds[1:])
        if bounds[-1] != self.num_data:
            log.fatal(f"Sum of query counts ({bounds[-1]}) != num_data "
                      f"({self.num_data})")
        self.query_boundaries = bounds

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).reshape(-1)

    def set_position(self, position: Optional[Sequence[int]]) -> None:
        """Each document's displayed position (position-debiased
        lambdarank)."""
        self.position = None if position is None else \
            np.asarray(position, dtype=np.int32).reshape(-1)


class Dataset:
    """Binned training data (reference dataset.h:487).

    ``bins``  uint8 [n_rows, n_used]   packed bin matrix
    ``mappers``  one BinMapper per ORIGINAL feature
    ``used_feature_idx``  original index of each packed column
    """

    def __init__(self) -> None:
        self.bins: np.ndarray = np.zeros((0, 0), dtype=np.uint8)
        self.mappers: List[BinMapper] = []
        self.used_feature_idx: List[int] = []
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.metadata: Metadata = Metadata(0)
        self.config: Config = Config()
        self._reference: Optional["Dataset"] = None
        self.bundle_plan: Optional[BundlePlan] = None
        # raw values of the used features, kept only under linear_tree
        self.raw: Optional[np.ndarray] = None

    # ------------------------------------------------------------ properties
    @property
    def num_data(self) -> int:
        return self.bins.shape[0]

    @property
    def num_features(self) -> int:
        """Packed (used) feature count."""
        return len(self.used_feature_idx)

    @property
    def label(self) -> np.ndarray:
        return self.metadata.label

    def num_bins_array(self) -> np.ndarray:
        return np.array([self.mappers[i].num_bin for i in self.used_feature_idx],
                        dtype=np.int32)

    def nan_bin_array(self) -> np.ndarray:
        return np.array([self.mappers[i].nan_bin for i in self.used_feature_idx],
                        dtype=np.int32)

    def categorical_array(self) -> np.ndarray:
        return np.array([self.mappers[i].bin_type == BIN_CATEGORICAL
                         for i in self.used_feature_idx], dtype=bool)

    def max_num_bin(self) -> int:
        return int(max((self.mappers[i].num_bin for i in self.used_feature_idx),
                       default=1))

    def device_n_bins(self) -> int:
        """Bin-axis width of device histograms: max_num_bin (or the widest
        EFB bundle column) rounded up to a power of two, floor 4."""
        widest = self.max_num_bin()
        if self.bundle_plan is not None:
            for members in self.bundle_plan.bundles:
                total = 1 + sum(self.mappers[self.used_feature_idx[f]].num_bin
                                - 1 for f in members)
                widest = max(widest, total)
        return device_bins_pow2(widest)

    def device_bundle_arrays(self):
        """EFB tables trimmed to ``device_n_bins`` width, or None
        (learner/grower.py ``DeviceBundle`` operands)."""
        p = self.bundle_plan
        if p is None:
            return None
        B = self.device_n_bins()
        return (p.feat_col, p.src_idx[:, :B], p.valid[:, :B],
                p.default_bin, p.inv_table[:, :B])

    def packed_mirror(self) -> np.ndarray:
        """Packed-word mirror of the bin matrix: i32 [n, ceil(F/4)], 4 uint8
        bins per word (little-endian view of the row-major matrix — the
        layout ``ops/histogram.bins_to_words`` produces).  The fused
        partition kernel copies these words into the compaction payload
        (ops/round_fuse.py).  Built lazily and cached."""
        cached = getattr(self, "_packed_mirror", None)
        if cached is not None and cached.shape[0] == self.bins.shape[0]:
            return cached
        n, num_f = self.bins.shape
        pad = (-num_f) % 4
        b = self.bins if not pad else \
            np.concatenate([self.bins, np.zeros((n, pad), np.uint8)], axis=1)
        self._packed_mirror = np.ascontiguousarray(b).view(np.int32) \
            .reshape(n, (num_f + pad) // 4)
        return self._packed_mirror

    def subset(self, indices) -> "Dataset":
        """Row subset sharing the mappers and the EFB plan, nothing binned
        again (reference Dataset::CopySubrow dataset.h:661; the JAX
        package's ``subset``; cv's folds): the rows' bins, label, weight,
        init score (column-major per class when it has k columns),
        positions and, under ``linear_tree``, raw columns.  Query
        boundaries do not survive an arbitrary subset: callers that fold
        whole queries set the groups afterwards.  ``indices``: row indices
        into this dataset."""
        idx = np.asarray(indices, np.int64)
        ds = Dataset()
        ds.mappers = self.mappers
        ds.used_feature_idx = list(self.used_feature_idx)
        ds.num_total_features = self.num_total_features
        ds.feature_names = self.feature_names
        ds.config = self.config
        ds.bundle_plan = self.bundle_plan
        ds.bins = self.bins[idx]
        md = Metadata(len(idx))
        md.set_label(self.metadata.label[idx])
        if self.metadata.weight is not None:
            md.set_weight(self.metadata.weight[idx])
        isc = self.metadata.init_score
        if isc is not None:
            if isc.size == self.num_data:
                md.set_init_score(isc[idx])
            else:
                k = isc.size // self.num_data
                md.set_init_score(isc.reshape(self.num_data, k, order="F")
                                  [idx].reshape(-1, order="F"))
        if self.metadata.position is not None:
            md.set_position(self.metadata.position[idx])
        ds.metadata = md
        if self.raw is not None:
            ds.raw = self.raw[idx]
        return ds

    # ---------------------------------------------------------- construction
    @classmethod
    def from_data(cls, data: Any, label: Optional[Sequence[float]] = None,
                  config: Union[Config, Dict[str, Any], None] = None,
                  weight: Optional[Sequence[float]] = None,
                  group: Optional[Sequence[int]] = None,
                  init_score: Optional[Sequence[float]] = None,
                  feature_names: Optional[List[str]] = None,
                  categorical_feature: Optional[Sequence[Union[int, str]]] = None,
                  reference: Optional["Dataset"] = None) -> "Dataset":
        """Build a binned dataset from a dense matrix (reference
        DatasetLoader::ConstructFromSampleData)."""
        cfg = as_config(config)
        arr = _as_2d_float(data)
        n, f = arr.shape
        ds = cls()
        ds.config = cfg
        ds.num_total_features = f
        if feature_names is None and hasattr(data, "columns"):
            feature_names = [str(c) for c in data.columns]
        ds.feature_names = feature_names or [f"Column_{i}" for i in range(f)]

        ds.metadata = Metadata(n)
        if label is not None:
            ds.metadata.set_label(label)
        ds.metadata.set_weight(weight)
        ds.metadata.set_group(group)
        ds.metadata.set_init_score(init_score)

        if reference is not None:
            # valid set: reuse the training mappers (reference CreateValid,
            # dataset.h:703) and the training EFB plan
            ds.mappers = reference.mappers
            ds.used_feature_idx = list(reference.used_feature_idx)
            ds.num_total_features = reference.num_total_features
            ds.feature_names = reference.feature_names
            ds._reference = reference
            ds.bins = ds._bin_matrix(arr)
            if reference.bundle_plan is not None:
                ds.bundle_plan = reference.bundle_plan
                ds.bins = apply_bundles(ds.bins, ds.bundle_plan)
            if bool(cfg.linear_tree):
                ds.raw = _raw_columns(arr, ds.used_feature_idx)
            return ds

        cat_idx = _resolve_categorical(categorical_feature, ds.feature_names)
        ds._construct_mappers(arr, cfg, cat_idx)
        ds.bins = ds._bin_matrix(arr)
        if bool(cfg.enable_bundle) and cfg.tree_learner not in (
                "feature", "feature_parallel"):
            # cap bundle width at the pre-EFB histogram width so EFB can
            # only shrink the histogram tensor, never widen its bin axis
            plan = plan_bundles(ds.bins, ds.num_bins_array(),
                                max_total_bins=ds.device_n_bins())
            if plan is not None:
                saved = ds.bins.shape[1] - plan.num_bundles
                log.info(f"EFB bundled {ds.bins.shape[1]} features into "
                         f"{plan.num_bundles} columns (saved {saved})")
                ds.bundle_plan = plan
                ds.bins = apply_bundles(ds.bins, plan)
        if bool(cfg.linear_tree):
            ds.raw = _raw_columns(arr, ds.used_feature_idx)
        return ds

    def create_valid(self, data: Any, label: Optional[Sequence[float]] = None,
                     **kwargs: Any) -> "Dataset":
        return Dataset.from_data(data, label=label, config=self.config,
                                 reference=self, **kwargs)

    def _construct_mappers(self, arr: np.ndarray, cfg: Config,
                           cat_idx: Sequence[int]) -> None:
        n, f = arr.shape
        max_bin = int(cfg.max_bin)
        if max_bin > MAX_UINT8_BINS:
            log.warning(f"max_bin={max_bin} > {MAX_UINT8_BINS} not yet "
                        f"supported on the uint8 path; clamping")
            max_bin = MAX_UINT8_BINS
        # sample rows for bin finding (reference bin_construct_sample_cnt,
        # dataset_loader.cpp sampling)
        sample_cnt = min(n, int(cfg.bin_construct_sample_cnt))
        if sample_cnt < n:
            rng = np.random.default_rng(cfg.data_random_seed)
            sample_rows = rng.choice(n, size=sample_cnt, replace=False)
            sample = arr[np.sort(sample_rows)]
        else:
            sample = arr
        mbf = list(cfg.max_bin_by_feature or [])
        forced = _load_forced_bins(cfg, f)
        self.mappers = []
        cat_set = set(cat_idx)
        for j in range(f):
            fmax = mbf[j] if j < len(mbf) and mbf[j] > 1 else max_bin
            m = BinMapper.find_bin(
                sample[:, j], total_sample_cnt=len(sample), max_bin=int(fmax),
                min_data_in_bin=int(cfg.min_data_in_bin),
                use_missing=bool(cfg.use_missing),
                zero_as_missing=bool(cfg.zero_as_missing),
                is_categorical=(j in cat_set),
                forced_bounds=forced.get(j))
            self.mappers.append(m)
        self.used_feature_idx = [j for j in range(f)
                                 if not self.mappers[j].is_trivial()]
        dropped = f - len(self.used_feature_idx)
        if dropped:
            log.info(f"Dropped {dropped} trivial (single-bin) feature(s)")
        if not self.used_feature_idx:
            log.fatal("Cannot construct Dataset: all features are trivial "
                      "(single bin). Check your data or binning parameters.")

    def _bin_matrix(self, arr: np.ndarray) -> np.ndarray:
        """Apply this dataset's per-feature mappers to a raw matrix (from
        ``PARALLEL_BIN_VALUES`` values on, a column per thread)."""
        n = arr.shape[0]
        used = self.used_feature_idx
        bins = np.zeros((n, len(used)), dtype=np.uint8)
        if arr.shape[1] != self.num_total_features:
            log.fatal(f"The number of features in data ({arr.shape[1]}) does "
                      f"not match Dataset ({self.num_total_features})")

        def one(col: int) -> None:
            j = used[col]
            bins[:, col] = self.mappers[j].values_to_bins(arr[:, j]) \
                .astype(np.uint8)

        workers = min(os.cpu_count() or 1, len(used))
        if n * len(used) < PARALLEL_BIN_VALUES or workers < 2:
            for col in range(len(used)):
                one(col)
        else:
            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(one, range(len(used))))
        return np.ascontiguousarray(bins)

    def bin_external(self, arr: np.ndarray) -> np.ndarray:
        """Bin an external raw matrix with this dataset's mappers and its
        EFB bundle layout, as a valid set is binned at construction: u8
        [n, columns].  A numeric split ``value <= threshold`` is exactly
        ``bin <= threshold_bin`` under these mappers, so the device forest
        predictor of numeric models walks these bins
        (boosting/gbdt.py ``_device_predict_raw``)."""
        bins = self._bin_matrix(arr)
        if self.bundle_plan is not None:
            bins = apply_bundles(bins, self.bundle_plan)
        return np.ascontiguousarray(bins)

    def bin_external_pred(self, arr: np.ndarray) -> np.ndarray:
        """i32 LOGICAL (un-bundled) bins [n, used features] for the forest
        predictor of categorical, bundled and linear models: numeric
        columns bin as in :meth:`bin_external`; a categorical column maps
        a category unseen at training time to the sentinel bin ``num_bin``
        and NaN to ``num_bin + 1``, so a bitset node sends them where the
        raw-space walk does (unseen right, NaN by ``cat_nan_left``)."""
        if arr.shape[1] != self.num_total_features:
            log.fatal(f"The number of features in data ({arr.shape[1]}) "
                      f"does not match Dataset ({self.num_total_features})")
        used = self.used_feature_idx
        bins = np.zeros((arr.shape[0], len(used)), dtype=np.int32)
        for col, j in enumerate(used):
            m = self.mappers[j]
            bins[:, col] = m.values_to_bins_pred(arr[:, j], m.num_bin,
                                                 m.num_bin + 1)
        return np.ascontiguousarray(bins)


def _raw_columns(arr: np.ndarray, used: Sequence[int]) -> np.ndarray:
    """float32 [n, F_used] row-major: the raw values of the used columns
    (a column selection of a row-major matrix comes out column-major)."""
    return np.ascontiguousarray(arr[:, list(used)], dtype=np.float32)


def _resolve_categorical(categorical_feature: Optional[Sequence[Union[int, str]]],
                         feature_names: List[str]) -> List[int]:
    if not categorical_feature or categorical_feature == "auto":
        return []
    out = []
    for c in categorical_feature:
        if isinstance(c, str) and not c.isdigit():
            if c in feature_names:
                out.append(feature_names.index(c))
            else:
                log.warning(f"Unknown categorical feature name: {c}")
        else:
            out.append(int(c))
    return sorted(set(out))


def _load_forced_bins(cfg: Config, num_features: int) -> dict:
    """Read ``forcedbins_filename`` (reference dataset_loader.cpp forced-bins
    JSON: ``[{"feature": i, "bin_upper_bound": [...]}, ...]``) into a
    {feature_index: sorted bounds} dict; empty when unset."""
    path = str(cfg.forcedbins_filename or "")
    if not path:
        return {}
    import json
    try:
        with open(path) as fh:
            entries = json.load(fh)
    except (OSError, ValueError) as e:
        log.warning(f"could not read forcedbins_filename={path!r}: {e}")
        return {}
    out = {}
    try:
        for e in entries:
            j = int(e.get("feature", -1))
            bounds = e.get("bin_upper_bound", [])
            if 0 <= j < num_features and bounds:
                out[j] = sorted(float(b) for b in bounds)
            elif j >= num_features:
                log.warning(f"forced bins: feature {j} out of range "
                            f"({num_features} features)")
    except (AttributeError, TypeError, ValueError) as e:
        log.warning(f"malformed forced-bins file {path!r} "
                    f"(expected [{{'feature': i, 'bin_upper_bound': "
                    f"[...]}}, ...]): {e}")
        return {}
    return out

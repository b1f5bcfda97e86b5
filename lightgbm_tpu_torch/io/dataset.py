"""Binned Dataset + Metadata.

Counterpart of ``lightgbm_tpu/io/dataset.py`` (reference:
include/LightGBM/dataset.h:487 ``Dataset``, dataset.h:48 ``Metadata``,
src/io/dataset_loader.cpp ``DatasetLoader``).  The binned data is one
row-major ``uint8`` matrix ``[n_rows, n_used_features]`` (bundled columns
under EFB) built on the host with NumPy; the booster copies it to the torch
device once (boosting/gbdt.py).  Binning, trivial-feature dropping and the
EFB plan run the same NumPy code as ``lightgbm_tpu``, so the same input
gives the same bytes.

Sparse (scipy CSR / CSC) input is binned from its CSC columns without a
dense ``[n, F]`` matrix (``_from_sparse``): the mappers come from each
column's nonzeros, the EFB plan from sampled nonzero-row masks
(``plan_bundles_sparse``), and the only row-major matrix made is the
bundled ``uint8`` one (``_sparse_bundled_matrix``).  The numpy random
draws are made in the JAX package's order, so the sampled mappers and
masks are the same.

External matrices bin the same way for the device forest predictor
(``bin_external``, ``bin_external_pred``).

With ``linear_tree`` set, a dataset (training or valid) also keeps the
raw float32 values of its used features (``raw`` [n, F_used], NaN kept),
which the linear-leaf fit and scores read (reference Dataset raw_data_;
the JAX package's ``raw``).

``subset`` takes rows of a constructed dataset with its mappers and EFB
plan (cv's folds).  ``save_binary`` / ``load_binary`` write and read the
JAX package's npz format (the ``lgbtpu_dataset`` marker and
``format_version``), so a file written by either package loads in the
other.

Not in this package yet: streamed and sharded ingest.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..config import Config, as_config
from ..utils import log
from .binning import BIN_CATEGORICAL, BinMapper
from .bundling import (BundlePlan, apply_bundles, plan_bundles,
                       plan_bundles_sparse)

MAX_UINT8_BINS = 256

#: on-disk binary dataset format version (``save_binary`` /
#: ``load_binary``), the JAX package's: v1 carries only the marker, v2 the
#: version field and the streamed-ingest provenance.  Readers accept up to
#: their own version.
BINARY_FORMAT_VERSION = 2

#: raw values a matrix holds from which its columns bin on a thread each
#: (NumPy's casts and searchsorted release the GIL; the bytes are the same)
PARALLEL_BIN_VALUES = 1 << 22


def device_bins_pow2(widest: int) -> int:
    """Device histogram bin-axis width for a widest-column bin count:
    rounded up to a power of two, floor 4 (the rule ``lightgbm_tpu`` uses,
    so histograms of both packages have the same shape)."""
    return max(1 << max(1, (int(widest) - 1).bit_length()), 4)


def _is_sparse(data: Any) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def _as_2d_float(data: Any) -> np.ndarray:
    """Accept numpy / pandas / list-of-rows; return float64 [n, F] with NaN
    for missing.  Sparse matrices never come here (``_from_sparse``)."""
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
        # how a streamed ingest built this dataset (the JAX package's
        # io/streaming.py): kept through save_binary / load_binary only
        self.ingest_provenance: Optional[Dict[str, Any]] = None

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
        """Build a binned dataset from a dense or a scipy sparse matrix
        (reference DatasetLoader::ConstructFromSampleData)."""
        cfg = as_config(config)
        if _is_sparse(data):
            return cls._from_sparse(data, label, cfg, weight, group,
                                    init_score, feature_names,
                                    categorical_feature, reference)
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

    # ------------------------------------------------------------- sparse
    @classmethod
    def _from_sparse(cls, data, label, cfg, weight, group, init_score,
                     feature_names, categorical_feature, reference
                     ) -> "Dataset":
        """Scipy CSR / CSC input binned without a dense matrix (the JAX
        package's ``_from_sparse``; reference sparse_bin.hpp + EFB): each
        feature's mapper from its CSC column's nonzeros (the implicit rows
        counted as zeros through ``total_sample_cnt``; a column with more
        than ``bin_construct_sample_cnt`` nonzeros is sampled), the EFB plan
        from nonzero-row masks of up to 100,000 sampled rows, kept only
        where it shrinks the histogram cells or, at most doubling them, the
        columns by a quarter; the one row-major matrix made is the bundled
        uint8 ``[n, columns]``.  A valid set bins against its reference's
        mappers and plan, dense-built or categorical ones included."""
        csc = data.tocsc(copy=True)  # copy: sum_duplicates works in place
        csc.sum_duplicates()
        n, f = csc.shape
        if bool(cfg.linear_tree):
            log.fatal("linear_tree=true requires dense input "
                      "(sparse ingestion keeps no raw matrix)")
        if categorical_feature not in (None, "auto") and \
                len(list(categorical_feature)):
            log.fatal("categorical_feature with sparse input is not "
                      "supported; pass a dense matrix or a DataFrame")
        ds = cls()
        ds.config = cfg
        ds.num_total_features = f
        ds.feature_names = feature_names or [f"Column_{i}" for i in range(f)]
        ds.metadata = Metadata(n)
        if label is not None:
            ds.metadata.set_label(label)
        ds.metadata.set_weight(weight)
        ds.metadata.set_group(group)
        ds.metadata.set_init_score(init_score)

        if reference is not None:
            ds.mappers = reference.mappers
            ds.used_feature_idx = list(reference.used_feature_idx)
            ds.num_total_features = reference.num_total_features
            ds.feature_names = reference.feature_names
            ds._reference = reference
            ds.bundle_plan = reference.bundle_plan
            ds.bins = _sparse_bundled_matrix(
                csc, ds.mappers, ds.used_feature_idx, ds.bundle_plan, n)
            return ds

        # the mappers from the columns' nonzeros (bin.cpp:311 FindBin with
        # zero elision: total_sample_cnt - len(values) count as zeros)
        max_bin = min(int(cfg.max_bin), MAX_UINT8_BINS)
        cap = int(cfg.bin_construct_sample_cnt)
        rng = np.random.default_rng(cfg.data_random_seed)
        mbf = list(cfg.max_bin_by_feature or [])
        forced = _load_forced_bins(cfg, f)
        mappers = []
        for j in range(f):
            vals = csc.data[csc.indptr[j]:csc.indptr[j + 1]]
            if len(vals) > cap:
                vals = vals[rng.choice(len(vals), cap, replace=False)]
                total = int(round(n * cap / (csc.indptr[j + 1]
                                             - csc.indptr[j])))
            else:
                total = n
            fmax = mbf[j] if j < len(mbf) and mbf[j] > 1 else max_bin
            mappers.append(BinMapper.find_bin(
                vals, total_sample_cnt=max(total, len(vals)),
                max_bin=int(fmax),
                min_data_in_bin=int(cfg.min_data_in_bin),
                use_missing=bool(cfg.use_missing),
                zero_as_missing=bool(cfg.zero_as_missing),
                forced_bounds=forced.get(j)))
        ds.mappers = mappers
        ds.used_feature_idx = [j for j in range(f)
                               if not mappers[j].is_trivial()]
        dropped = f - len(ds.used_feature_idx)
        if dropped:
            log.info(f"Dropped {dropped} trivial (single-bin) feature(s)")
        if not ds.used_feature_idx:
            log.fatal("Cannot construct Dataset: all features are trivial")

        # the EFB plan from sampled nonzero-row masks
        plan = None
        if bool(cfg.enable_bundle) and cfg.tree_learner not in (
                "feature", "feature_parallel"):
            ns = min(n, 100_000)
            sample_rows = np.sort(rng.choice(n, ns, replace=False)) \
                if ns < n else np.arange(n)
            masks = []
            for j in ds.used_feature_idx:
                rows = csc.indices[csc.indptr[j]:csc.indptr[j + 1]]
                mask = np.zeros(ns, bool)
                pos = np.searchsorted(sample_rows, rows)
                inb = pos < ns
                hit = np.zeros(len(rows), bool)
                hit[inb] = sample_rows[pos[inb]] == rows[inb]
                mask[pos[hit]] = True
                masks.append(mask)
            zero_bins = np.array([mappers[j].default_bin
                                  for j in ds.used_feature_idx], np.int32)
            # unlike the dense path, which never widens the bin axis, wide
            # sparse data wants full-width bundles: the plan is kept when
            # the histogram cells shrink, or when the columns shrink by a
            # quarter and the cells at most double
            n_bins_pre = ds.device_n_bins()
            plan = plan_bundles_sparse(masks, ds.num_bins_array(),
                                       zero_bins, ns)
            if plan is not None:
                ds.bundle_plan = plan
                cells_with = plan.num_bundles * ds.device_n_bins()
                cells_without = len(ds.used_feature_idx) * n_bins_pre
                ds.bundle_plan = None
                shrinks_cols = plan.num_bundles <= \
                    0.75 * len(ds.used_feature_idx)
                if not (cells_with < cells_without
                        or (shrinks_cols and cells_with
                            <= 2 * cells_without)):
                    plan = None
            if plan is not None:
                saved = len(ds.used_feature_idx) - plan.num_bundles
                log.info(f"EFB bundled {len(ds.used_feature_idx)} sparse "
                         f"features into {plan.num_bundles} columns "
                         f"(saved {saved})")
        ds.bundle_plan = plan
        ds.bins = _sparse_bundled_matrix(csc, mappers, ds.used_feature_idx,
                                         plan, n)
        return ds

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

    def _map_columns(self, arr: np.ndarray, dtype, fn) -> np.ndarray:
        """``fn(mapper, column)`` of each used feature's raw column into a
        ``dtype`` [n, used] matrix; from ``PARALLEL_BIN_VALUES`` values on,
        a column per thread (the bytes are the same)."""
        if arr.shape[1] != self.num_total_features:
            log.fatal(f"The number of features in data ({arr.shape[1]}) does "
                      f"not match Dataset ({self.num_total_features})")
        n = arr.shape[0]
        used = self.used_feature_idx
        out = np.zeros((n, len(used)), dtype=dtype)

        def one(col: int) -> None:
            j = used[col]
            out[:, col] = fn(self.mappers[j], arr[:, j])

        workers = min(os.cpu_count() or 1, len(used))
        if n * len(used) < PARALLEL_BIN_VALUES or workers < 2:
            for col in range(len(used)):
                one(col)
        else:
            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(one, range(len(used))))
        return np.ascontiguousarray(out)

    def _bin_matrix(self, arr: np.ndarray) -> np.ndarray:
        """Apply this dataset's per-feature mappers to a raw matrix."""
        return self._map_columns(
            arr, np.uint8, lambda m, v: m.values_to_bins(v).astype(np.uint8))

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
        return self._map_columns(
            arr, np.int32,
            lambda m, v: m.values_to_bins_pred(v, m.num_bin, m.num_bin + 1))

    # --------------------------------------------------------------- utility
    def bin_threshold_to_value(self, packed_feature: int,
                               bin_thr: int) -> float:
        """A learner bin threshold of a packed feature as the model's
        real-valued threshold."""
        return self.mappers[self.used_feature_idx[packed_feature]] \
            .bin_to_value(bin_thr)

    # ------------------------------------------------------- binary format
    def save_binary(self, path: str) -> None:
        """Write the binned dataset (reference Dataset::SaveBinaryFile /
        LGBM_DatasetSaveBinary c_api.h:516) in the JAX package's npz
        format: the marker, the format version, the bin matrix, the
        mappers as JSON, the metadata, the raw columns and the bundle
        plan."""
        import json
        mappers_json = json.dumps([m.to_dict() for m in self.mappers])
        md = self.metadata
        extra: Dict[str, Any] = {}
        if md.weight is not None:
            extra["weight"] = md.weight
        if md.query_boundaries is not None:
            extra["query_boundaries"] = md.query_boundaries
        if md.init_score is not None:
            extra["init_score"] = md.init_score
        if md.position is not None:
            extra["position"] = md.position
        if self.raw is not None:
            extra["raw"] = self.raw
        if self.bundle_plan is not None:
            p = self.bundle_plan
            extra["bundle_json"] = json.dumps(p.bundles)
            extra["bundle_feat_col"] = p.feat_col
            extra["bundle_src_idx"] = p.src_idx
            extra["bundle_valid"] = p.valid
            extra["bundle_default_bin"] = p.default_bin
            extra["bundle_inv_table"] = p.inv_table
        if self.ingest_provenance is not None:
            extra["provenance_json"] = json.dumps(self.ingest_provenance)
        with open(path, "wb") as fh:  # the exact name (np would add .npz)
            np.savez_compressed(
                fh, lgbtpu_dataset=np.int32(1),
                format_version=np.int64(BINARY_FORMAT_VERSION),
                bins=self.bins,
                label=md.label, mappers_json=mappers_json,
                used_feature_idx=np.asarray(self.used_feature_idx, np.int64),
                num_total_features=np.int64(self.num_total_features),
                feature_names=np.asarray(self.feature_names, dtype=object),
                **extra)

    @classmethod
    def load_binary(cls, path: str, config: Optional[Config] = None
                    ) -> "Dataset":
        """Read a dataset written by :meth:`save_binary` (of either
        package); a newer format version is refused."""
        import json
        z = np.load(path, allow_pickle=True)
        if "lgbtpu_dataset" not in z:
            log.fatal(f"{path} is not a lightgbm_tpu binary dataset")
        version = int(z["format_version"]) if "format_version" in z else 1
        if version > BINARY_FORMAT_VERSION:
            log.fatal(
                f"Binary dataset {path!r} has format version {version}, but "
                f"this build reads up to version {BINARY_FORMAT_VERSION}; "
                "re-save it with a matching version")
        ds = cls()
        ds.config = config or Config()
        ds.bins = z["bins"]
        ds.used_feature_idx = [int(i) for i in z["used_feature_idx"]]
        ds.num_total_features = int(z["num_total_features"])
        ds.feature_names = [str(s) for s in z["feature_names"]]
        ds.mappers = [BinMapper.from_dict(d)
                      for d in json.loads(str(z["mappers_json"]))]
        ds.metadata = Metadata(ds.bins.shape[0])
        ds.metadata.set_label(z["label"])
        if "weight" in z:
            ds.metadata.set_weight(z["weight"])
        if "query_boundaries" in z:
            ds.metadata.query_boundaries = z["query_boundaries"]
        if "init_score" in z:
            ds.metadata.set_init_score(z["init_score"])
        if "position" in z:
            ds.metadata.set_position(z["position"])
        if "raw" in z:
            ds.raw = z["raw"]
        if "provenance_json" in z:
            ds.ingest_provenance = json.loads(str(z["provenance_json"]))
        if "bundle_json" in z:
            bundles = json.loads(str(z["bundle_json"]))
            ds.bundle_plan = BundlePlan(
                bundles=bundles,
                feat_col=z["bundle_feat_col"],
                src_idx=z["bundle_src_idx"], valid=z["bundle_valid"],
                default_bin=z["bundle_default_bin"],
                inv_table=z["bundle_inv_table"],
                num_bundles=len(bundles))
        return ds


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


def _sparse_bundled_matrix(csc, mappers, used_idx, plan, n: int) -> np.ndarray:
    """The bundled uint8 [n, columns] straight from CSC columns (the JAX
    package's).  An implicit entry is 0.0, so each column starts at its
    feature's bin of zero (``values_to_bins(0.0)``: numeric and
    categorical mappers alike) and only the nonzeros are binned and
    scattered.  Under a bundle plan, member encoding and first-writer
    conflict resolution are ``apply_bundles``' on the equivalent dense
    matrix, a dense-built plan included: a member whose zero bin is a
    stored bin claims its implicit rows in member order too."""
    _z = np.zeros(1, np.float64)

    def zero_bin(m) -> int:
        return int(m.values_to_bins(_z)[0])

    def column(j):
        lo, hi = csc.indptr[j], csc.indptr[j + 1]
        return mappers[j], csc.indices[lo:hi], csc.data[lo:hi]

    bundles = [[f] for f in range(len(used_idx))] if plan is None \
        else plan.bundles
    out = np.zeros((n, len(bundles)), np.uint8)
    for col, members in enumerate(bundles):
        if len(members) == 1:
            m, rows, vals = column(used_idx[members[0]])
            zb = zero_bin(m)
            if zb:
                out[:, col] = zb
            out[rows, col] = m.values_to_bins(vals).astype(np.uint8)
            continue
        for fv in members:
            m, rows, vals = column(used_idx[fv])
            b = m.values_to_bins(vals).astype(np.int64)
            stored = plan.valid[fv][b]
            write = stored & (out[rows, col] == 0)
            out[rows[write], col] = \
                plan.src_idx[fv][b[write]].astype(np.uint8)
            zb = zero_bin(m)
            if 0 <= zb < len(plan.valid[fv]) and plan.valid[fv][zb]:
                imp = np.ones(n, bool)
                imp[rows] = False
                imp &= out[:, col] == 0
                out[imp, col] = np.uint8(plan.src_idx[fv][zb])
    return out


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

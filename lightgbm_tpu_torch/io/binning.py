"""Per-feature quantization (binning).

Counterpart of ``lightgbm_tpu/io/binning.py`` (same NumPy code, so the same
input gives the same bins byte for byte).  Design of the reference
bin-mapping layer (reference:
include/LightGBM/bin.h:85 ``BinMapper``, src/io/bin.cpp:311 ``FindBin``).
Binning is one-time host preprocessing, so this is NumPy; the output feeds the
packed device bin tensor.  Semantics preserved from the reference:

  * equal-count greedy binning over sampled distinct values
    (``GreedyFindBin``): values with count >= mean bin size get their own bin,
    the rest are cut greedily at the running mean of the remaining budget;
  * zero always isolated in its own bin ([-1e-35, 1e-35], reference
    ``kZeroThreshold`` bin.cpp) with the negative/positive value ranges binned
    separately with proportional bin budgets (``FindBinWithZeroAsOneBin``);
  * missing handling (bin.h:27 ``MissingType``): None / Zero (zero bin doubles
    as the missing bin) / NaN (dedicated last bin);
  * categorical bins ordered by descending frequency (bin.cpp categorical
    branch), ``bin_2_categorical`` kept for model serialization;
  * trivial features (num_bin <= 1) are flagged so the Dataset can drop them
    (reference ``feature_pre_filter``, dataset.cpp).

Unlike the reference's dense bins we do NOT elide the most-frequent bin from
storage — every bin is stored explicitly in the packed tensor, so the
``FixHistogram`` completion step (dataset.h:760) has no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils import log

K_ZERO_THRESHOLD = 1e-35  # reference bin.cpp kZeroThreshold

# MissingType (reference bin.h:27)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Equal-count greedy binning over (distinct value, count) pairs.

    Returns the list of bin upper bounds (last = +inf).  Mirrors the behavior
    of reference ``BinMapper::GreedyFindBin`` (src/io/bin.cpp): small distinct
    sets get one bin per value (merged up to ``min_data_in_bin``), large sets
    are cut greedily so each bin holds ~mean count, with heavy hitters
    guaranteed their own bin.
    """
    num_distinct = len(distinct_values)
    if num_distinct == 0:
        return []
    bounds: List[float] = []
    if num_distinct <= max_bin:
        # one bin per distinct value, merging tiny bins forward
        if min_data_in_bin > 0 and total_cnt > 2 * min_data_in_bin:
            cur = 0
            i = 0
            while i < num_distinct:
                cur += int(counts[i])
                if cur >= min_data_in_bin:
                    if i + 1 < num_distinct:
                        bounds.append((float(distinct_values[i]) +
                                       float(distinct_values[i + 1])) / 2.0)
                    cur = 0
                i += 1
            bounds.append(np.inf)
        else:
            for i in range(num_distinct - 1):
                bounds.append((float(distinct_values[i]) +
                               float(distinct_values[i + 1])) / 2.0)
            bounds.append(np.inf)
        return bounds

    # large distinct set: greedy equal-count
    max_bin = max(1, max_bin)
    mean_bin_size = total_cnt / max_bin
    # heavy values get dedicated bins
    is_big = counts >= mean_bin_size
    rest_cnt = total_cnt - int(counts[is_big].sum())
    rest_bins = max_bin - int(is_big.sum())
    if rest_bins > 0:
        mean_bin_size = rest_cnt / rest_bins
    upper_bounds: List[float] = []
    lower_bounds: List[float] = []
    cur_cnt = 0
    bin_cnt = 0
    cur_lower = float(distinct_values[0])
    for i in range(num_distinct):
        if not is_big[i]:
            rest_cnt -= int(counts[i])
        cur_cnt += int(counts[i])
        # cut when the running bin is full, the value is big, or the next is big
        need_cut = (is_big[i] or cur_cnt >= mean_bin_size or
                    (i + 1 < num_distinct and is_big[i + 1] and
                     cur_cnt >= max(1.0, mean_bin_size * 0.5)))
        if need_cut:
            upper_bounds.append(float(distinct_values[i]))
            lower_bounds.append(cur_lower)
            bin_cnt += 1
            if i + 1 < num_distinct:
                cur_lower = float(distinct_values[i + 1])
            cur_cnt = 0
            if not is_big[i] and rest_bins > bin_cnt:
                mean_bin_size = rest_cnt / (rest_bins - bin_cnt)
            if bin_cnt >= max_bin - 1:
                break
    # boundaries are midpoints between a bin's max and the next bin's min
    for i in range(len(upper_bounds) - 1):
        bounds.append((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
    # everything after the last cut falls into the final bin
    bounds.append(np.inf)
    return bounds


class BinMapper:
    """Maps raw feature values to integer bins (reference bin.h:85)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.bin_type: int = BIN_NUMERICAL
        self.missing_type: int = MISSING_NONE
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self._cat_2_bin: Optional[dict] = None
        self.default_bin: int = 0        # bin of value 0.0 (reference GetDefaultBin)
        self.min_val: float = 0.0
        self.max_val: float = 0.0

    # ------------------------------------------------------------------ find
    @classmethod
    def find_bin(cls, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, use_missing: bool, zero_as_missing: bool,
                 is_categorical: bool = False,
                 forced_bounds: Optional[Sequence[float]] = None) -> "BinMapper":
        """Construct a mapper from sampled values (reference bin.cpp:311).

        ``values``: sampled raw values for this feature, possibly containing
        NaN.  ``total_sample_cnt`` may exceed ``len(values)`` when zeros were
        elided by a sparse sampler; the difference is counted as zeros.
        """
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        values = values[~np.isnan(values)]
        dv, cnts = np.unique(values, return_counts=True)
        return cls.find_bin_from_dist(
            dv, cnts, na_cnt=na_cnt, total_sample_cnt=total_sample_cnt,
            max_bin=max_bin, min_data_in_bin=min_data_in_bin,
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            is_categorical=is_categorical, forced_bounds=forced_bounds)

    @classmethod
    def find_bin_from_dist(cls, distinct_values: np.ndarray,
                           counts: np.ndarray, *, na_cnt: int,
                           total_sample_cnt: int, max_bin: int,
                           min_data_in_bin: int, use_missing: bool,
                           zero_as_missing: bool, is_categorical: bool = False,
                           forced_bounds: Optional[Sequence[float]] = None
                           ) -> "BinMapper":
        """``find_bin`` on a (distinct value, count) summary instead of raw
        values — THE shared construction path.  ``find_bin`` reduces its
        sample through ``np.unique`` and delegates here, so a streamed
        exact tally (io/streaming.py pass 1) that reproduces the same
        distinct/count multiset produces a bit-identical mapper.  NaN must
        already be stripped from ``distinct_values`` and tallied in
        ``na_cnt``; zeros elided upstream (sparse/streamed sources) are
        recovered from ``total_sample_cnt`` exactly like ``find_bin``.
        """
        m = cls()
        dv = np.asarray(distinct_values, dtype=np.float64)
        cnts = np.asarray(counts, dtype=np.int64)

        if not use_missing:
            m.missing_type = MISSING_NONE
        elif zero_as_missing:
            m.missing_type = MISSING_ZERO
        elif na_cnt > 0:
            m.missing_type = MISSING_NAN
        else:
            m.missing_type = MISSING_NONE

        if is_categorical:
            m._find_bin_categorical(dv, cnts, total_sample_cnt, max_bin,
                                    na_cnt)
            return m

        m._find_bin_numerical(dv, cnts, total_sample_cnt, max_bin,
                              min_data_in_bin, na_cnt, forced_bounds)
        return m

    def _find_bin_numerical(self, dv: np.ndarray, cnts: np.ndarray,
                            total_sample_cnt: int,
                            max_bin: int, min_data_in_bin: int, na_cnt: int,
                            forced_bounds: Optional[Sequence[float]]) -> None:
        self.bin_type = BIN_NUMERICAL
        n_values = int(cnts.sum())
        zero_cnt = max(0, total_sample_cnt - n_values - na_cnt)
        # zeros elided by sparse sampling come back as explicit zeros here
        nz = np.abs(dv) > K_ZERO_THRESHOLD
        zero_cnt += int(cnts[~nz].sum())
        dv_nz, c_nz = dv[nz], cnts[nz]
        if len(dv_nz):
            self.min_val = float(dv_nz.min())
            self.max_val = float(dv_nz.max())

        budget = max_bin - (1 if self.missing_type == MISSING_NAN else 0)
        budget = max(budget, 2)

        # forced bounds are GUARANTEED boundaries; the remaining budget is
        # still filled with data-driven bins (reference forced-bins
        # semantics, dataset_loader.cpp forced_upper_bounds: forcing a few
        # boundaries must not collapse the feature's split resolution)
        fb = sorted(float(b) for b in forced_bounds) if forced_bounds else []
        if fb:
            budget = max(budget - len(fb), 2)
        neg_mask = dv_nz < 0
        pos_mask = dv_nz > 0
        n_neg = int(c_nz[neg_mask].sum())
        n_pos = int(c_nz[pos_mask].sum())
        n_nonzero = n_neg + n_pos
        bounds = []
        if n_nonzero == 0:
            bounds = [np.inf]
        elif zero_cnt == 0:
            # no zeros sampled (dense feature): bin the raw value range
            # directly, no dedicated zero bin
            bounds = _greedy_find_bin(dv_nz, c_nz, budget, n_nonzero,
                                      min_data_in_bin)
        else:
            # proportional budget split around the dedicated zero bin
            # (reference FindBinWithZeroAsOneBin)
            left_budget = int(round(n_neg / n_nonzero * (budget - 1)))
            if n_neg > 0:
                left_budget = max(left_budget, 1)
            right_budget = budget - 1 - left_budget
            if n_pos > 0:
                right_budget = max(right_budget, 1)
            if n_neg > 0:
                nb = _greedy_find_bin(dv_nz[neg_mask], c_nz[neg_mask],
                                      left_budget,
                                      n_neg + zero_cnt // 2, min_data_in_bin)
                if nb:
                    nb[-1] = -K_ZERO_THRESHOLD  # close negatives below zero bin
                bounds.extend(nb)
            bounds.append(K_ZERO_THRESHOLD)  # zero bin upper bound
            if n_pos > 0:
                pb = _greedy_find_bin(dv_nz[pos_mask], c_nz[pos_mask],
                                      right_budget,
                                      n_pos + zero_cnt - zero_cnt // 2,
                                      min_data_in_bin)
                bounds.extend(pb)
            else:
                bounds[-1] = np.inf
            if bounds[-1] != np.inf:
                bounds.append(np.inf)
        bounds = list(bounds) + fb
        # dedupe while preserving order
        ub = np.array(sorted(set(bounds)), dtype=np.float64)
        self.bin_upper_bound = ub
        self.num_bin = len(ub)
        if self.missing_type == MISSING_NAN:
            self.num_bin += 1  # dedicated NaN bin appended last
        self.default_bin = int(np.searchsorted(ub, 0.0, side="left"))

    def _find_bin_categorical(self, dv: np.ndarray, dcnts: np.ndarray,
                              total_sample_cnt: int,
                              max_bin: int, na_cnt: int) -> None:
        self.bin_type = BIN_CATEGORICAL
        ivals = dv.astype(np.int64)
        if (ivals[dcnts > 0] < 0).any():
            log.warning("Met negative value in categorical features, will convert "
                        "it to NaN")
            keep = ivals >= 0
            ivals, dcnts = ivals[keep], dcnts[keep]
        # distinct floats can collapse onto one int code: re-aggregate
        cats, inv = np.unique(ivals, return_inverse=True)
        counts = np.bincount(inv, weights=dcnts.astype(np.float64),
                             minlength=len(cats)).astype(np.int64)
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        # cap at max_bin - 1; rare categories collapse into bin 0
        keep = min(len(cats), max_bin - 1)
        cats = cats[:keep]
        self.bin_2_categorical = [int(c) for c in cats]
        self._cat_2_bin = {int(c): i for i, c in enumerate(cats)}
        self.num_bin = max(1, len(cats))
        # categorical NaN folds into bin 0 (most frequent category) so the
        # device path stays pure one-hot — no missing-bin default routing
        self.missing_type = MISSING_NONE
        self.default_bin = 0

    # --------------------------------------------------------------- mapping
    def is_trivial(self) -> bool:
        """True when the whole feature lands in one bin (reference dataset.cpp
        feature_pre_filter drops these)."""
        return self.num_bin <= 1

    @property
    def nan_bin(self) -> int:
        """Bin index holding missing values, or -1 when missing maps nowhere.
        Categorical features always return -1: NaN folds into bin 0 and the
        device partition stays pure one-hot."""
        if self.bin_type == BIN_CATEGORICAL:
            return -1
        if self.missing_type == MISSING_NAN:
            return self.num_bin - 1
        if self.missing_type == MISSING_ZERO:
            return self.default_bin
        return -1

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (reference bin.h / bin.cpp)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            return self._cat_values_to_bins(values, 0, 0)
        isnan = np.isnan(values)
        if self.missing_type == MISSING_ZERO:
            values = np.where(isnan, 0.0, values)
            isnan = np.zeros_like(isnan)
        out = np.searchsorted(self.bin_upper_bound, values, side="left")
        out = np.clip(out, 0, len(self.bin_upper_bound) - 1).astype(np.int32)
        if self.missing_type == MISSING_NAN:
            out = np.where(isnan, self.num_bin - 1, out).astype(np.int32)
        else:
            out[isnan] = self.default_bin
        return out

    def _cat_values_to_bins(self, values: np.ndarray, unseen_bin: int,
                            nan_bin_out: int) -> np.ndarray:
        """THE categorical raw->bin lookup, shared by training binning
        (``values_to_bins``: unseen/NaN fold to bin 0) and the bitset
        predictor (``values_to_bins_pred``: dedicated sentinel bins).
        int64 truncation matches the host walk's ``int(v)`` coercion;
        negative codes never match a category and take the unseen fill."""
        values = np.asarray(values, dtype=np.float64)
        isnan = np.isnan(values)
        ivals = np.where(isnan, -1, values).astype(np.int64)
        table = self._cat_2_bin or {}
        # vectorized dict lookup via searchsorted over sorted cats
        cats = np.array(sorted(table), dtype=np.int64)
        out = np.full(len(values), unseen_bin, dtype=np.int32)
        if len(cats):
            bins_for = np.array([table[c] for c in cats], dtype=np.int32)
            pos = np.clip(np.searchsorted(cats, ivals), 0, len(cats) - 1)
            hit = cats[pos] == ivals
            out = np.where(hit, bins_for[pos], unseen_bin).astype(np.int32)
        out[isnan] = nan_bin_out
        return out

    def values_to_bins_pred(self, values: np.ndarray, unseen_bin: int,
                            nan_bin_out: int) -> np.ndarray:
        """``values_to_bins`` variant for the device BITSET predictor
        (models/predict.py predict_bitset_forest): categorical columns
        map categories unseen at training time to ``unseen_bin`` and NaN
        to ``nan_bin_out`` instead of folding both into bin 0 — the
        sentinels let bin-space traversal reproduce the raw-space walk's
        'not in set -> right' / cat_nan_left branches exactly
        (reference tree.cpp CategoricalDecision).  Numerical columns are
        unchanged (their bin space is decision-exact already)."""
        if self.bin_type != BIN_CATEGORICAL:
            return self.values_to_bins(values)
        return self._cat_values_to_bins(values, unseen_bin, nan_bin_out)

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative split threshold for a bin boundary: the upper bound
        of ``bin_idx`` (used when converting bin thresholds to real-valued
        model thresholds, reference tree.cpp threshold_ semantics)."""
        if self.bin_type == BIN_CATEGORICAL:
            if 0 <= bin_idx < len(self.bin_2_categorical):
                return float(self.bin_2_categorical[bin_idx])
            return 0.0
        ub = self.bin_upper_bound
        idx = min(int(bin_idx), len(ub) - 1)
        # the last bin's bound stays +inf: a split there only sends missing
        # values right, every real value goes left
        return float(ub[idx])

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "bin_type": self.bin_type,
            "missing_type": self.missing_type,
            "bin_upper_bound": [float(x) for x in self.bin_upper_bound],
            "bin_2_categorical": list(self.bin_2_categorical),
            "default_bin": self.default_bin,
            "min_val": self.min_val,
            "max_val": self.max_val,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.bin_type = int(d["bin_type"])
        m.missing_type = int(d["missing_type"])
        m.bin_upper_bound = np.array(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(c) for c in d.get("bin_2_categorical", [])]
        m._cat_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.default_bin = int(d.get("default_bin", 0))
        m.min_val = float(d.get("min_val", 0.0))
        m.max_val = float(d.get("max_val", 0.0))
        return m

"""Python side of the port's C ABI (consumed by native/capi.cpp).

The reference exposes its C++ core through ~100 ``LGBM_*`` C functions
(reference: src/c_api.cpp, include/LightGBM/c_api.h) that every language
binding consumes.  Here the runtime core is this package, so the C ABI is a
thin native shim (native/capi.cpp, the same ``LGBMTPU_*`` functions as
lightgbm_tpu's) that embeds CPython and dispatches to the functions below;
handles are integer ids into a registry.  Buffers cross the boundary as raw
addresses wrapped with numpy.  An input view is copied (or consumed by a
host-side conversion) before any device work starts, an output is written
only once its values are on the host, and no view outlives its call.

Devices follow the package's policy: a Dataset or Booster runs on the CUDA
card unless its params JSON says ``device_type=cpu``; a model loaded from a
file or string takes its device from params given later
(``LGBMTPU_BoosterResetParameter``).  Predict is ``Booster.predict``,
which decides where the work runs (a loaded model's scores of at least
``DEVICE_PREDICT_MIN_WORK`` row-trees on its device, bitwise the host
walk).  The
single-row fast path (``LGBMTPU_BoosterPredictForMatSingleRowFast``) runs
through the serving tier's bucket-1 ``CompiledPredictor`` in exact mode:
one launch of the forest kernel's leaves mode a row on the card, the sum
finished in host float64.  ``LGBMTPU_NetworkInit`` with several machines
waits for multi-device training (ROADMAP Queue 1 item 6) and raises.
"""

from __future__ import annotations

import ctypes
import itertools
import json
from typing import Any, Dict

import numpy as np

_handles: Dict[int, Any] = {}
_next_id = itertools.count(1)


def _new_handle(obj: Any) -> int:
    h = next(_next_id)
    _handles[h] = obj
    return h


def _arr_f64(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double)), shape=(n,))


def dataset_from_mat(data_ptr: int, nrow: int, ncol: int, label_ptr: int,
                     params_json: str) -> int:
    """LGBM_DatasetCreateFromMat (c_api.h:409) equivalent."""
    import lightgbm_tpu_torch as lgb
    data = _arr_f64(data_ptr, nrow * ncol).reshape(nrow, ncol).copy()
    label = _arr_f64(label_ptr, nrow).copy() if label_ptr else None
    params = json.loads(params_json) if params_json else {}
    ds = lgb.Dataset(data, label=label, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_set_field(ds_id: int, field: str, ptr: int, n: int) -> None:
    """LGBM_DatasetSetField equivalent (weight/init_score/group/position)."""
    ds = _handles[ds_id]
    vals = _arr_f64(ptr, n).copy()
    if field == "weight":
        ds.set_weight(vals)
    elif field == "group":
        ds.set_group(vals.astype(np.int64))
    elif field == "label":
        ds.set_label(vals)
    elif field == "init_score":
        ds.set_init_score(vals)
    elif field == "position":
        ds.set_position(vals.astype(np.int32))
    else:
        raise ValueError(f"unknown field {field}")


def booster_create(ds_id: int, params_json: str) -> int:
    """LGBM_BoosterCreate (c_api.h:656) equivalent."""
    import lightgbm_tpu_torch as lgb
    params = json.loads(params_json) if params_json else {}
    return _new_handle(lgb.Booster(params=params, train_set=_handles[ds_id]))


def booster_create_from_modelfile(path: str) -> int:
    """LGBM_BoosterCreateFromModelfile equivalent."""
    import lightgbm_tpu_torch as lgb
    return _new_handle(lgb.Booster(model_file=path))


def booster_update_one_iter(b_id: int) -> int:
    """LGBM_BoosterUpdateOneIter (c_api.h:765): returns 1 when finished."""
    return 1 if _handles[b_id].update() else 0


def booster_predict_for_mat(b_id: int, data_ptr: int, nrow: int, ncol: int,
                            raw_score: int, out_ptr: int,
                            out_capacity: int) -> int:
    """LGBM_BoosterPredictForMat (c_api.h:1281): writes into out_ptr
    (capacity checked — multiclass needs nrow * num_class doubles),
    returns the number of doubles written."""
    data = _arr_f64(data_ptr, nrow * ncol).reshape(nrow, ncol)
    preds = np.asarray(_handles[b_id].predict(data,
                                              raw_score=bool(raw_score)),
                       np.float64).reshape(-1)
    if preds.size > out_capacity:
        raise ValueError(
            f"prediction needs {preds.size} doubles but the out buffer "
            f"holds {out_capacity}; allocate nrow * num_class "
            f"(LGBMTPU_BoosterNumClasses)")
    out = _arr_f64(out_ptr, preds.size)
    out[:] = preds
    return int(preds.size)


def booster_save_model(b_id: int, path: str) -> None:
    _handles[b_id].save_model(path)


def booster_num_trees(b_id: int) -> int:
    return int(_handles[b_id].num_trees())


def booster_num_classes(b_id: int) -> int:
    return int(_handles[b_id].num_model_per_iteration())


def free_handle(h: int) -> None:
    """LGBMTPU_FreeHandle: drop the handle.  A Booster's, a Dataset's or a
    fast-predict config's device tensors go with their last reference; a
    collection pass then frees those held only through reference cycles,
    so the card's live memory is back when the call returns."""
    if _handles.pop(h, None) is not None:
        import gc
        gc.collect()


def _arr_i32(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), shape=(n,))


def dataset_from_csr(indptr_ptr: int, indices_ptr: int, data_ptr: int,
                     nrow: int, nnz: int, ncol: int, label_ptr: int,
                     params_json: str, reference: int = 0) -> int:
    """LGBM_DatasetCreateFromCSR (c_api.h:340) equivalent.

    Routed through the sparse ingestion path (io/dataset.py _from_sparse)
    — the CSR payload is binned column-wise without densification, and
    duplicate (row, col) entries are summed (scipy.sparse semantics).
    ``reference``: optional training-dataset handle; when set, the new
    dataset aligns to its bin mappers (create_valid semantics, as the
    reference's reference parameter does).
    """
    import lightgbm_tpu_torch as lgb
    from scipy.sparse import csr_matrix
    indptr = _arr_i32(indptr_ptr, nrow + 1).copy()
    indices = _arr_i32(indices_ptr, nnz).copy()
    vals = _arr_f64(data_ptr, nnz).copy()
    mat = csr_matrix((vals, indices, indptr), shape=(nrow, ncol))
    label = _arr_f64(label_ptr, nrow).copy() if label_ptr else None
    params = json.loads(params_json) if params_json else {}
    if reference:
        ds = _handles[reference].create_valid(mat, label=label)
    else:
        ds = lgb.Dataset(mat, label=label, params=params)
    ds.construct()
    return _new_handle(ds)


class _StreamCollector:
    """Streaming push target (reference LGBM_DatasetInitStreaming
    c_api.h:177 + LGBM_DatasetPushRows :203): rows arrive in chunks from
    any producer; MarkFinished constructs the binned Dataset."""

    def __init__(self, ncol: int, params: Dict[str, Any]):
        self.ncol = ncol
        self.params = params
        self.chunks = []
        self.labels = []
        self.weights = []
        self.groups = []
        self.init_scores = []
        self.finished = None
        self.reference = None          # Dataset to copy bin mappers from
        self.expected_rows = None
        self.wait_for_manual_finish = False

    def push(self, rows: np.ndarray, label, weight=None, group=None,
             init_score=None) -> None:
        if self.finished is not None:
            raise ValueError("dataset already marked finished")
        if rows.shape[1] != self.ncol:
            raise ValueError(f"pushed ncol {rows.shape[1]} != declared "
                             f"ncol {self.ncol}")
        for buf, val, name in ((self.labels, label, "label"),
                               (self.weights, weight, "weight"),
                               (self.groups, group, "group"),
                               (self.init_scores, init_score, "init_score")):
            if self.chunks and (val is None) != (not buf):
                raise ValueError(
                    f"{name} must be passed on every push or none "
                    "(chunk metadata would misalign)")
            if val is not None:
                buf.append(np.asarray(val).copy())
        self.chunks.append(rows.copy())

    def finish(self):
        import lightgbm_tpu_torch as lgb
        data = np.concatenate(self.chunks, axis=0) if self.chunks \
            else np.zeros((0, self.ncol))
        label = np.concatenate(self.labels) if self.labels else None
        if label is not None and len(label) != data.shape[0]:
            raise ValueError(f"{len(label)} labels for {data.shape[0]} rows")
        if self.expected_rows is not None \
                and data.shape[0] != self.expected_rows:
            from .utils import log
            log.warning(f"streaming dataset declared {self.expected_rows} "
                        f"rows but received {data.shape[0]}")
        if self.reference is not None:
            # bin alignment with the reference (create_valid semantics,
            # reference DatasetCreateByReference c_api.h:160)
            ds = self.reference.create_valid(data, label=label)
        else:
            ds = lgb.Dataset(data, label=label, params=self.params)
        ds.construct()
        if self.weights:
            ds.set_weight(np.concatenate(self.weights))
        if self.groups:
            # per-row query ids -> boundary counts by RUN-LENGTH in row
            # order (np.unique would sort ids and reorder the queries)
            qid = np.concatenate(self.groups)
            change = np.flatnonzero(np.diff(qid)) + 1
            bounds = np.concatenate([[0], change, [len(qid)]])
            ds.set_group(np.diff(bounds).astype(np.int64))
        if self.init_scores:
            ds.set_init_score(np.concatenate(self.init_scores))
        self.finished = ds
        return ds


def dataset_init_streaming(ncol: int, params_json: str) -> int:
    params = json.loads(params_json) if params_json else {}
    return _new_handle(_StreamCollector(ncol, params))


def dataset_push_rows(h: int, data_ptr: int, nrow: int, ncol: int,
                      label_ptr: int) -> None:
    col = _handles[h]
    if not isinstance(col, _StreamCollector):
        raise TypeError("handle is not a streaming dataset")
    rows = _arr_f64(data_ptr, nrow * ncol).reshape(nrow, ncol)
    label = _arr_f64(label_ptr, nrow) if label_ptr else None
    col.push(rows, label)


def dataset_mark_finished(h: int) -> None:
    """After this, the handle behaves as a constructed Dataset."""
    col = _handles[h]
    if not isinstance(col, _StreamCollector):
        raise TypeError("handle is not a streaming dataset")
    _handles[h] = col.finish()


def dataset_num_data(ds_id: int) -> int:
    return int(_handles[ds_id].num_data())


def dataset_num_feature(ds_id: int) -> int:
    return int(_handles[ds_id].num_feature())


def booster_add_valid_data(b_id: int, ds_id: int) -> None:
    """LGBM_BoosterAddValidData (c_api.h:703) equivalent."""
    _handles[b_id].add_valid(_handles[ds_id], f"valid_{ds_id}")


def booster_get_eval(b_id: int, data_idx: int, out_ptr: int,
                     out_capacity: int) -> int:
    """LGBM_BoosterGetEval (c_api.h:910): data_idx 0 = train, 1.. = valid;
    writes metric values, returns how many."""
    b = _handles[b_id]
    if data_idx == 0:
        res = b.eval_train()
    else:
        names = list(getattr(b._gbdt, "valid_names", []))
        if data_idx - 1 >= len(names):
            raise IndexError(f"data_idx {data_idx} out of range: "
                             f"{len(names)} valid set(s)")
        name = names[data_idx - 1]
        res = [r for r in b.eval_valid() if r[0] == name]
    vals = [float(r[2]) for r in res]
    if len(vals) > out_capacity:
        raise ValueError(f"eval needs {len(vals)} doubles, buffer holds "
                         f"{out_capacity}")
    out = _arr_f64(out_ptr, len(vals))
    out[:] = vals
    return len(vals)


def booster_rollback_one_iter(b_id: int) -> None:
    """LGBM_BoosterRollbackOneIter (c_api.h:817) equivalent."""
    _handles[b_id].rollback_one_iter()


def booster_current_iteration(b_id: int) -> int:
    return int(_handles[b_id].current_iteration())


def booster_save_model_to_string(b_id: int, out_ptr: int,
                                 out_capacity: int) -> int:
    """LGBM_BoosterSaveModelToString: writes NUL-terminated model text,
    returns required size INCLUDING the terminator (call with capacity 0 to
    size the buffer, like the reference's out_len contract)."""
    s = _handles[b_id].model_to_string().encode()
    need = len(s) + 1
    if out_capacity >= need:
        buf = np.ctypeslib.as_array(
            ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_char)),
            shape=(need,))
        buf[:need - 1] = np.frombuffer(s, dtype="S1")
        buf[need - 1] = b"\x00"
    return need


def dataset_from_csc(colptr_ptr: int, indices_ptr: int, data_ptr: int,
                     ncol: int, nnz: int, nrow: int, label_ptr: int,
                     params_json: str) -> int:
    """LGBM_DatasetCreateFromCSC (c_api.h:479) equivalent.

    Routed through the sparse ingestion path like the CSR create;
    duplicates summed."""
    import lightgbm_tpu_torch as lgb
    from scipy.sparse import csc_matrix
    colptr = _arr_i32(colptr_ptr, ncol + 1).copy()
    indices = _arr_i32(indices_ptr, nnz).copy()
    vals = _arr_f64(data_ptr, nnz).copy()
    mat = csc_matrix((vals, indices, colptr), shape=(nrow, ncol))
    label = _arr_f64(label_ptr, nrow).copy() if label_ptr else None
    params = json.loads(params_json) if params_json else {}
    ds = lgb.Dataset(mat, label=label, params=params)
    ds.construct()
    return _new_handle(ds)


def booster_from_string(model_str: str) -> int:
    """LGBM_BoosterLoadModelFromString (c_api.h:677) equivalent."""
    import lightgbm_tpu_torch as lgb
    return _new_handle(lgb.Booster(model_str=model_str))


def booster_num_feature(b_id: int) -> int:
    """LGBM_BoosterGetNumFeature (c_api.h:876) equivalent."""
    return int(_handles[b_id].num_feature())


def booster_feature_names(b_id: int) -> str:
    """LGBM_BoosterGetFeatureNames (c_api.h:845): newline-joined."""
    return "\n".join(_handles[b_id].feature_name())


def booster_eval_names(b_id: int) -> str:
    """LGBM_BoosterGetEvalNames (c_api.h:826): newline-joined metric names
    in the order booster_get_eval writes values.  Computed from the metric
    objects, NOT by running an evaluation; boosters loaded from a model
    string/file carry no metrics and report none (like the reference)."""
    g = _handles[b_id]._gbdt
    if g is None:
        return ""
    names = []
    for m in g.train_metrics:
        names.extend(m.display_names())
    return "\n".join(names)


class _FastPredictor:
    """Single-row fast predict (reference c_api.h:1162
    LGBM_BoosterPredictForMatSingleRowFastInit + SingleRowPredictor cache,
    src/c_api.cpp): rows route through the serving tier's bucket-1
    ``CompiledPredictor`` in exact mode (serving/predictor.py) — the same
    device buffer every call, one launch of the forest kernel's leaves
    mode a row on the card, and the host float64 finish keeps it
    bit-identical to ``Booster.predict`` on the same single row for every
    model shape (categorical, linear, text-loaded; linear-leaf batch
    predict reassociates its BLAS dot, so single-row is the parity
    anchor).  The device is the booster's (a loaded model's from its
    params); a card that fails raises, it is never traded for the CPU."""

    def __init__(self, booster, ncol: int, raw_score: bool):
        from .serving.buckets import BucketLadder
        from .serving.predictor import CompiledPredictor
        self.booster = booster
        self.ncol = ncol
        self.raw = bool(raw_score)
        self.k = booster.num_model_per_iteration()
        self.n_trees_snapshot = booster.num_trees()
        self._served = CompiledPredictor.from_booster(
            booster, ladder=BucketLadder((1,)), exact=True)

    def predict_row(self, row: np.ndarray) -> np.ndarray:
        if self.booster.num_trees() != self.n_trees_snapshot:
            # booster trained further since init: rebuild the served
            # forest so fast predict stays bit-identical to batch predict
            self.__init__(self.booster, self.ncol, self.raw)
        out = np.asarray(self._served.predict(
            row.reshape(1, -1), raw_score=True), np.float64).reshape(-1)
        if not self.raw:
            out = self._transform(out)
        return out

    def _transform(self, out: np.ndarray) -> np.ndarray:
        # identical math to Booster.predict's conversion for a single row:
        # a trained booster's objective in float32 (boosting/gbdt.py
        # predict), a loaded model's objective string in float64
        g = self.booster._gbdt
        if g is not None:
            if g.objective is None or not g.objective.need_convert_output:
                return out
            import torch
            arr = out if self.k == 1 else out[None, :]
            conv = g.objective.convert_output(
                torch.as_tensor(arr, dtype=torch.float32))
            return np.asarray(conv.numpy(), np.float64).reshape(-1)
        from .basic import _objective_string_transform
        return _objective_string_transform(
            out[None, :], self.booster._loaded["objective"]).reshape(-1)


def fastpredict_init(b_id: int, ncol: int, raw_score: int) -> int:
    b = _handles[b_id]
    nf = int(b.num_feature())
    if ncol != nf:
        raise ValueError(f"model expects {nf} features, fast config "
                         f"declares {ncol}")
    return _new_handle(_FastPredictor(b, ncol, bool(raw_score)))


def fastpredict_row(f_id: int, row_ptr: int, out_ptr: int,
                    out_capacity: int) -> int:
    fp = _handles[f_id]
    if not isinstance(fp, _FastPredictor):
        raise TypeError("handle is not a fast-predict config")
    row = _arr_f64(row_ptr, fp.ncol)
    preds = np.asarray(fp.predict_row(row), np.float64).reshape(-1)
    if preds.size > out_capacity:
        raise ValueError(f"prediction needs {preds.size} doubles, buffer "
                         f"holds {out_capacity}")
    _arr_f64(out_ptr, preds.size)[:] = preds
    return int(preds.size)


# ---------------------------------------------------------------------------
# The rest of the reference's LGBM_* inventory (include/LightGBM/c_api.h).
# Naming maps LGBM_X -> the snake_case impl below; native/capi.cpp exports
# LGBMTPU_X.
# ---------------------------------------------------------------------------

# reference predict-type constants (c_api.h C_API_PREDICT_*)
PREDICT_NORMAL = 0
PREDICT_RAW_SCORE = 1
PREDICT_LEAF_INDEX = 2
PREDICT_CONTRIB = 3


def _predict_values(b, X, predict_type: int, start_iteration: int,
                    num_iteration: int) -> np.ndarray:
    """Shared predict-type dispatch (reference C_API_PREDICT_*)."""
    kw = dict(start_iteration=int(start_iteration),
              num_iteration=(None if num_iteration <= 0
                             else int(num_iteration)))
    if predict_type == PREDICT_RAW_SCORE:
        return np.asarray(b.predict(X, raw_score=True, **kw), np.float64)
    if predict_type == PREDICT_LEAF_INDEX:
        return np.asarray(b.predict(X, pred_leaf=True, **kw), np.float64)
    if predict_type == PREDICT_CONTRIB:
        return np.asarray(b.predict(X, pred_contrib=True, **kw), np.float64)
    return np.asarray(b.predict(X, **kw), np.float64)


def _predict_any(b_id: int, X, predict_type: int, start_iteration: int,
                 num_iteration: int, out_ptr: int, out_capacity: int) -> int:
    preds = _predict_values(_handles[b_id], X, predict_type,
                            start_iteration, num_iteration).reshape(-1)
    if preds.size > out_capacity:
        raise ValueError(
            f"prediction needs {preds.size} doubles but the out buffer "
            f"holds {out_capacity} (use booster_calc_num_predict)")
    _arr_f64(out_ptr, preds.size)[:] = preds
    return int(preds.size)


def booster_predict_for_mat2(b_id: int, data_ptr: int, nrow: int, ncol: int,
                             predict_type: int, start_iteration: int,
                             num_iteration: int, out_ptr: int,
                             out_capacity: int) -> int:
    """LGBM_BoosterPredictForMat (c_api.h:1281) with the reference's full
    predict_type/start/num signature (the v1 export keeps its raw_score
    form for ABI back-compat)."""
    X = _arr_f64(data_ptr, nrow * ncol).reshape(nrow, ncol)
    return _predict_any(b_id, X, predict_type, start_iteration,
                        num_iteration, out_ptr, out_capacity)


def booster_predict_for_csr(b_id: int, indptr_ptr: int, indices_ptr: int,
                            data_ptr: int, nindptr: int, nelem: int,
                            ncol: int, predict_type: int,
                            start_iteration: int, num_iteration: int,
                            out_ptr: int, out_capacity: int) -> int:
    """LGBM_BoosterPredictForCSR (c_api.h:1042)."""
    from scipy.sparse import csr_matrix
    indptr = _arr_i32(indptr_ptr, nindptr).copy()
    indices = _arr_i32(indices_ptr, nelem).copy()
    vals = _arr_f64(data_ptr, nelem).copy()
    X = csr_matrix((vals, indices, indptr), shape=(nindptr - 1, ncol))
    return _predict_any(b_id, X, predict_type, start_iteration,
                        num_iteration, out_ptr, out_capacity)


def booster_predict_for_csc(b_id: int, colptr_ptr: int, indices_ptr: int,
                            data_ptr: int, ncolptr: int, nelem: int,
                            nrow: int, predict_type: int,
                            start_iteration: int, num_iteration: int,
                            out_ptr: int, out_capacity: int) -> int:
    """LGBM_BoosterPredictForCSC (c_api.h:1105)."""
    from scipy.sparse import csc_matrix
    colptr = _arr_i32(colptr_ptr, ncolptr).copy()
    indices = _arr_i32(indices_ptr, nelem).copy()
    vals = _arr_f64(data_ptr, nelem).copy()
    X = csc_matrix((vals, indices, colptr), shape=(nrow, ncolptr - 1))
    return _predict_any(b_id, X, predict_type, start_iteration,
                        num_iteration, out_ptr, out_capacity)


def booster_predict_for_file(b_id: int, data_path: str, has_header: int,
                             predict_type: int, start_iteration: int,
                             num_iteration: int, result_path: str) -> int:
    """LGBM_BoosterPredictForFile (c_api.h:986): parses with the same
    parser the Dataset loader uses and writes one prediction row per
    line."""
    from .config import Config
    from .io.parser import load_text_file
    cfg = Config({"header": bool(has_header)})
    feats, _label, _meta = load_text_file(data_path, cfg)
    preds = _predict_values(_handles[b_id], feats, predict_type,
                            start_iteration, num_iteration)
    with open(result_path, "w") as fh:
        for row in np.atleast_2d(preds.reshape(preds.shape[0], -1)):
            fh.write("\t".join(repr(float(v)) for v in row) + "\n")
    return int(preds.shape[0])


def booster_predict_for_mat_single_row(b_id: int, row_ptr: int, ncol: int,
                                       predict_type: int,
                                       start_iteration: int,
                                       num_iteration: int, out_ptr: int,
                                       out_capacity: int) -> int:
    """LGBM_BoosterPredictForMatSingleRow (c_api.h:1324)."""
    X = _arr_f64(row_ptr, ncol).reshape(1, ncol)
    return _predict_any(b_id, X, predict_type, start_iteration,
                        num_iteration, out_ptr, out_capacity)


def booster_predict_for_csr_single_row(b_id: int, indices_ptr: int,
                                       data_ptr: int, nelem: int, ncol: int,
                                       predict_type: int,
                                       start_iteration: int,
                                       num_iteration: int, out_ptr: int,
                                       out_capacity: int) -> int:
    """LGBM_BoosterPredictForCSRSingleRow (c_api.h:1160)."""
    row = np.zeros(ncol)
    idx = _arr_i32(indices_ptr, nelem)
    row[idx] = _arr_f64(data_ptr, nelem)
    return _predict_any(b_id, row.reshape(1, ncol), predict_type,
                        start_iteration, num_iteration, out_ptr,
                        out_capacity)


def booster_calc_num_predict(b_id: int, nrow: int, predict_type: int,
                             start_iteration: int,
                             num_iteration: int) -> int:
    """LGBM_BoosterCalcNumPredict (c_api.h:1009)."""
    b = _handles[b_id]
    k = b.num_model_per_iteration()
    n_iter = b.current_iteration() if num_iteration <= 0 else min(
        num_iteration, b.current_iteration())
    n_iter = max(n_iter - max(start_iteration, 0), 0)
    if predict_type == PREDICT_LEAF_INDEX:
        return int(nrow * k * n_iter)
    if predict_type == PREDICT_CONTRIB:
        return int(nrow * k * (b.num_feature() + 1))
    return int(nrow * k)


def booster_dump_model(b_id: int, num_iteration: int) -> str:
    """LGBM_BoosterDumpModel (c_api.h:1480): JSON dump."""
    return json.dumps(_handles[b_id].dump_model(
        num_iteration=None if num_iteration <= 0 else num_iteration))


def booster_feature_importance(b_id: int, importance_type: int,
                               out_ptr: int, out_capacity: int) -> int:
    """LGBM_BoosterFeatureImportance (c_api.h:1528): 0=split, 1=gain."""
    imp = _handles[b_id].feature_importance(
        "gain" if importance_type == 1 else "split")
    imp = np.asarray(imp, np.float64)
    if imp.size > out_capacity:
        raise ValueError("feature importance buffer too small")
    _arr_f64(out_ptr, imp.size)[:] = imp
    return int(imp.size)


def booster_get_eval_counts(b_id: int) -> int:
    """LGBM_BoosterGetEvalCounts (c_api.h:810)."""
    g = _handles[b_id]._gbdt
    if g is None:
        return 0
    return sum(len(m.display_names()) for m in g.train_metrics)


def booster_get_leaf_value(b_id: int, tree_idx: int, leaf_idx: int) -> float:
    """LGBM_BoosterGetLeafValue (c_api.h:940)."""
    t = _handles[b_id]._get_trees()[tree_idx]
    return float(t.leaf_value[leaf_idx])


def booster_set_leaf_value(b_id: int, tree_idx: int, leaf_idx: int,
                           value: float) -> None:
    """LGBM_BoosterSetLeafValue (c_api.h:952): ``Booster.set_leaf_output``,
    whose training booster rebuilds its score caches on its device."""
    _handles[b_id].set_leaf_output(tree_idx, leaf_idx, value)


def booster_get_linear(b_id: int) -> int:
    """LGBM_BoosterGetLinear (c_api.h:736)."""
    trees = _handles[b_id]._get_trees()
    return int(any(t.is_linear for t in trees))


def booster_get_loaded_param(b_id: int) -> str:
    """LGBM_BoosterGetLoadedParam (c_api.h:690): the params the model was
    trained/loaded with, as JSON."""
    b = _handles[b_id]
    if b._gbdt is not None:
        return json.dumps(b.params)
    return json.dumps(b._loaded.get("params", {}))


def _bound_value(b_id: int, upper: bool) -> float:
    """LGBM_BoosterGet{Lower,Upper}BoundValue (c_api.h:700-712): sum over
    trees of the extreme leaf value (the reference walks tree bounds the
    same way)."""
    trees = _handles[b_id]._get_trees()
    total = 0.0
    for t in trees:
        lv = np.asarray(t.leaf_value[:t.num_leaves], np.float64)
        total += float(lv.max() if upper else lv.min())
    return total


def booster_get_lower_bound_value(b_id: int) -> float:
    return _bound_value(b_id, upper=False)


def booster_get_upper_bound_value(b_id: int) -> float:
    return _bound_value(b_id, upper=True)


def booster_get_num_predict(b_id: int, data_idx: int) -> int:
    """LGBM_BoosterGetNumPredict (c_api.h:963): length of the cached
    score vector for train (0) / valid i (i+1)."""
    g = _handles[b_id]._gbdt
    if g is None:
        raise ValueError("booster carries no training state")
    s = g.scores if data_idx == 0 else g.valid_scores[data_idx - 1]
    return int(np.prod(s.shape))


def booster_get_predict(b_id: int, data_idx: int, out_ptr: int,
                        out_capacity: int) -> int:
    """LGBM_BoosterGetPredict (c_api.h:974): converted cached scores."""
    g = _handles[b_id]._gbdt
    if g is None:
        raise ValueError("booster carries no training state")
    s = g._host_scores(g.scores if data_idx == 0
                       else g.valid_scores[data_idx - 1])
    if g.objective is not None and g.objective.need_convert_output:
        import torch
        s = np.asarray(g.objective.convert_output(
            torch.as_tensor(s, dtype=torch.float32)).numpy(), np.float64)
    flat = s.reshape(-1)
    if flat.size > out_capacity:
        raise ValueError("predict buffer too small")
    _arr_f64(out_ptr, flat.size)[:] = flat
    return int(flat.size)


def booster_merge(b_id: int, other_id: int) -> None:
    """LGBM_BoosterMerge (c_api.h:680): append the other model's trees."""
    _handles[b_id].merge_models(_handles[other_id])


def booster_num_model_per_iteration(b_id: int) -> int:
    return int(_handles[b_id].num_model_per_iteration())


def booster_number_of_total_model(b_id: int) -> int:
    return int(_handles[b_id].num_trees())


def booster_refit(b_id: int, leaf_ptr: int, nrow: int, ncol: int) -> None:
    """LGBM_BoosterRefit (c_api.h:776): re-fit leaf values given the
    [nrow, num_trees] leaf-index matrix predicted on new data (the Python
    wrapper computes it with pred_leaf and passes it through, reference
    basic.py Booster.refit)."""
    leaf_preds = _arr_i32(leaf_ptr, nrow * ncol).reshape(nrow, ncol).copy()
    _handles[b_id].refit_from_leaf_preds(leaf_preds)


def booster_reset_parameter(b_id: int, params_json: str) -> None:
    """LGBM_BoosterResetParameter (c_api.h:853)."""
    _handles[b_id].reset_parameter(json.loads(params_json or "{}"))


def booster_reset_training_data(b_id: int, ds_id: int) -> None:
    """LGBM_BoosterResetTrainingData (c_api.h:843)."""
    _handles[b_id].reset_training_data(_handles[ds_id])


def booster_shuffle_models(b_id: int, start: int, end: int) -> None:
    """LGBM_BoosterShuffleModels (c_api.h:698): random-permute trees in
    [start, end) (iteration granularity, like the reference)."""
    _handles[b_id].shuffle_models(start, end)


def booster_update_one_iter_custom(b_id: int, grad_ptr: int, hess_ptr: int,
                                   n: int) -> int:
    """LGBM_BoosterUpdateOneIterCustom (c_api.h:793)."""
    grad = np.ctypeslib.as_array(
        ctypes.cast(grad_ptr, ctypes.POINTER(ctypes.c_float)),
        shape=(n,)).astype(np.float32)
    hess = np.ctypeslib.as_array(
        ctypes.cast(hess_ptr, ctypes.POINTER(ctypes.c_float)),
        shape=(n,)).astype(np.float32)
    return int(_handles[b_id].update(fobj=lambda preds, ds: (grad, hess)))


def booster_validate_feature_names(b_id: int, names_json: str) -> None:
    """LGBM_BoosterValidateFeatureNames (c_api.h:730)."""
    want = json.loads(names_json)
    have = _handles[b_id].feature_name()
    if list(want) != list(have):
        raise ValueError(
            f"feature names mismatch: model has {have}, data has {want}")


# --- dataset surface -------------------------------------------------------

def dataset_from_file(path: str, params_json: str) -> int:
    """LGBM_DatasetCreateFromFile (c_api.h:127)."""
    import lightgbm_tpu_torch as lgb
    params = json.loads(params_json) if params_json else {}
    ds = lgb.Dataset(path, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_from_mats(nmat: int, ptrs_ptr: int, nrows_ptr: int, ncol: int,
                      label_ptr: int, params_json: str) -> int:
    """LGBM_DatasetCreateFromMats (c_api.h:379): row-block concatenation."""
    import lightgbm_tpu_torch as lgb
    ptrs = np.ctypeslib.as_array(
        ctypes.cast(ptrs_ptr, ctypes.POINTER(ctypes.c_int64)), shape=(nmat,))
    nrows = _arr_i32(nrows_ptr, nmat)
    blocks = [_arr_f64(int(ptrs[i]), int(nrows[i]) * ncol)
              .reshape(int(nrows[i]), ncol) for i in range(nmat)]
    data = np.concatenate(blocks, axis=0)
    total = data.shape[0]
    label = _arr_f64(label_ptr, total).copy() if label_ptr else None
    params = json.loads(params_json) if params_json else {}
    ds = lgb.Dataset(data, label=label, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_create_by_reference(ref_id: int, num_total_row: int) -> int:
    """LGBM_DatasetCreateByReference (c_api.h:160): a streaming dataset
    whose bin mappers are COPIED from the reference (create_valid
    alignment semantics)."""
    ref = _handles[ref_id]
    col = _StreamCollector(ref.num_feature(), dict(ref.params or {}))
    col.reference = ref
    col.expected_rows = int(num_total_row)
    return _new_handle(col)


def dataset_save_binary(ds_id: int, path: str) -> None:
    """LGBM_DatasetSaveBinary (c_api.h:516)."""
    _handles[ds_id].save_binary(path)


def dataset_dump_text(ds_id: int, path: str) -> None:
    """LGBM_DatasetDumpText (c_api.h:526): bin values per row, the
    debugging dump the reference writes."""
    ds = _handles[ds_id]
    inner = ds.inner
    with open(path, "w") as fh:
        fh.write("\t".join(list(ds.feature_names)) + "\n")
        for row in np.asarray(inner.bins):
            fh.write("\t".join(str(int(v)) for v in row) + "\n")


def dataset_set_feature_names(ds_id: int, names_json: str) -> None:
    """LGBM_DatasetSetFeatureNames (c_api.h:551)."""
    _handles[ds_id].set_feature_names(json.loads(names_json))


def dataset_get_feature_names(ds_id: int) -> str:
    """LGBM_DatasetGetFeatureNames (c_api.h:561): newline-joined."""
    return "\n".join(list(_handles[ds_id].feature_names))


def dataset_get_feature_num_bin(ds_id: int, fidx: int) -> int:
    """LGBM_DatasetGetFeatureNumBin (c_api.h:615)."""
    return int(_handles[ds_id].inner.num_bins_array()[fidx])


def dataset_get_field(ds_id: int, field: str, out_ptr: int,
                      out_capacity: int) -> int:
    """LGBM_DatasetGetField (c_api.h:583): doubles out (the reference
    returns typed buffers; doubles cover every field losslessly except
    int64 groups beyond 2^53, which no real dataset reaches)."""
    ds = _handles[ds_id]
    if field == "label":
        vals = ds.get_label()
    elif field == "weight":
        vals = ds.get_weight()
    elif field == "group":
        g = ds.get_group()
        vals = None if g is None else np.asarray(g)
    elif field == "init_score":
        vals = ds.get_init_score()
    elif field == "position":
        vals = getattr(ds.inner.metadata, "position", None)
    else:
        raise ValueError(f"unknown field {field}")
    if vals is None:
        return 0
    vals = np.asarray(vals, np.float64).reshape(-1)
    if vals.size > out_capacity:
        raise ValueError(f"field buffer too small ({vals.size} needed)")
    _arr_f64(out_ptr, vals.size)[:] = vals
    return int(vals.size)


def dataset_get_subset(ds_id: int, idx_ptr: int, n: int,
                       params_json: str) -> int:
    """LGBM_DatasetGetSubset (c_api.h:536)."""
    idx = _arr_i32(idx_ptr, n).copy()
    sub = _handles[ds_id].subset(idx)
    sub.construct()
    return _new_handle(sub)


def dataset_add_features_from(ds_id: int, other_id: int) -> None:
    """LGBM_DatasetAddFeaturesFrom (c_api.h:631)."""
    _handles[ds_id].add_features_from(_handles[other_id])


def dataset_update_param_checking(old_json: str, new_json: str) -> None:
    """LGBM_DatasetUpdateParamChecking (c_api.h:573): raise when a
    binning-relevant parameter changes (the reference's forbidden list)."""
    from .config import DATASET_BINDING_PARAMS
    old = json.loads(old_json or "{}")
    new = json.loads(new_json or "{}")
    for k in DATASET_BINDING_PARAMS:
        if k in new and new.get(k) != old.get(k):
            raise ValueError(
                f"cannot change dataset parameter {k!r} after construction")


def dataset_push_rows_with_metadata(h: int, data_ptr: int, nrow: int,
                                    ncol: int, label_ptr: int,
                                    weight_ptr: int, group_ptr: int,
                                    init_score_ptr: int) -> None:
    """LGBM_DatasetPushRowsWithMetadata (c_api.h:239): rows plus
    label/weight/query/init_score mid-stream."""
    col = _handles[h]
    if not isinstance(col, _StreamCollector):
        raise TypeError("handle is not a streaming dataset")
    rows = _arr_f64(data_ptr, nrow * ncol).reshape(nrow, ncol)
    label = _arr_f64(label_ptr, nrow) if label_ptr else None
    weight = _arr_f64(weight_ptr, nrow) if weight_ptr else None
    group = _arr_i32(group_ptr, nrow) if group_ptr else None
    init_score = _arr_f64(init_score_ptr, nrow) if init_score_ptr else None
    col.push(rows, label, weight=weight, group=group, init_score=init_score)


def dataset_push_rows_by_csr(h: int, indptr_ptr: int, indices_ptr: int,
                             data_ptr: int, nindptr: int, nelem: int,
                             ncol: int, label_ptr: int) -> None:
    """LGBM_DatasetPushRowsByCSR (c_api.h:203)."""
    col = _handles[h]
    if not isinstance(col, _StreamCollector):
        raise TypeError("handle is not a streaming dataset")
    indptr = _arr_i32(indptr_ptr, nindptr)
    indices = _arr_i32(indices_ptr, nelem)
    vals = _arr_f64(data_ptr, nelem)
    nrow = nindptr - 1
    rows = np.zeros((nrow, ncol))
    for i in range(nrow):
        s, e = indptr[i], indptr[i + 1]
        rows[i, indices[s:e]] = vals[s:e]
    label = _arr_f64(label_ptr, nrow) if label_ptr else None
    col.push(rows, label)


def dataset_push_rows_by_csr_with_metadata(h: int, indptr_ptr: int,
                                           indices_ptr: int, data_ptr: int,
                                           nindptr: int, nelem: int,
                                           ncol: int, label_ptr: int,
                                           weight_ptr: int, group_ptr: int,
                                           init_score_ptr: int) -> None:
    """LGBM_DatasetPushRowsByCSRWithMetadata (c_api.h:269)."""
    col = _handles[h]
    if not isinstance(col, _StreamCollector):
        raise TypeError("handle is not a streaming dataset")
    indptr = _arr_i32(indptr_ptr, nindptr)
    indices = _arr_i32(indices_ptr, nelem)
    vals = _arr_f64(data_ptr, nelem)
    nrow = nindptr - 1
    rows = np.zeros((nrow, ncol))
    for i in range(nrow):
        s, e = indptr[i], indptr[i + 1]
        rows[i, indices[s:e]] = vals[s:e]
    label = _arr_f64(label_ptr, nrow) if label_ptr else None
    weight = _arr_f64(weight_ptr, nrow) if weight_ptr else None
    group = _arr_i32(group_ptr, nrow) if group_ptr else None
    init_score = _arr_f64(init_score_ptr, nrow) if init_score_ptr else None
    col.push(rows, label, weight=weight, group=group, init_score=init_score)


def dataset_set_wait_for_manual_finish(h: int, flag: int) -> None:
    """LGBM_DatasetSetWaitForManualFinish (c_api.h:331): advisory in this
    runtime (construction happens at mark_finished either way)."""
    col = _handles[h]
    if not isinstance(col, _StreamCollector):
        raise TypeError("handle is not a streaming dataset")
    col.wait_for_manual_finish = bool(flag)


def dataset_serialize_reference_to_binary(ds_id: int) -> int:
    """LGBM_DatasetSerializeReferenceToBinary (c_api.h:516+): the binning
    reference (mappers + schema, no rows) as a byte buffer handle."""
    buf = _handles[ds_id].serialize_reference()
    return _new_handle(bytearray(buf))


def dataset_from_serialized_reference(buf_ptr: int, buf_len: int,
                                      num_total_row: int,
                                      params_json: str) -> int:
    """LGBM_DatasetCreateFromSerializedReference (c_api.h:142)."""
    raw = bytes(np.ctypeslib.as_array(
        ctypes.cast(buf_ptr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(buf_len,)))
    from .basic import Dataset as _DS
    ref = _DS.deserialize_reference(raw)
    return dataset_create_by_reference(_new_handle(ref), num_total_row)


def byte_buffer_get_at(h: int, index: int) -> int:
    """LGBM_ByteBufferGetAt (c_api.h:118)."""
    return int(_handles[h][index])


def byte_buffer_size(h: int) -> int:
    """Companion query so C consumers can size their copy (the reference
    returns the size out of SerializeReferenceToBinary itself)."""
    return len(_handles[h])


# --- misc ------------------------------------------------------------------

_max_threads = [0]


def get_max_threads() -> int:
    """LGBM_GetMaxThreads (c_api.h:1603): PyTorch and the card own
    threading in this runtime; the value is advisory and round-trips
    Set/Get."""
    return _max_threads[0]


def set_max_threads(n: int) -> None:
    """LGBM_SetMaxThreads (c_api.h:1610)."""
    _max_threads[0] = int(n)


def dump_param_aliases() -> str:
    """LGBM_DumpParamAliases (c_api.h:100): JSON alias map."""
    from .config import _PARAMS
    return json.dumps({name: list(aliases)
                       for name, _, aliases, _ in _PARAMS})


def get_sample_count(nrow: int, params_json: str) -> int:
    """LGBM_GetSampleCount (c_api.h:55)."""
    params = json.loads(params_json or "{}")
    cnt = int(params.get("bin_construct_sample_cnt", 200000))
    return min(nrow, cnt)


def sample_indices(nrow: int, params_json: str, out_ptr: int,
                   out_capacity: int) -> int:
    """LGBM_SampleIndices (c_api.h:70): the row sample used for bin-mapper
    construction (same uniform sampling the Dataset loader applies)."""
    params = json.loads(params_json or "{}")
    cnt = get_sample_count(nrow, params_json)
    seed = int(params.get("data_random_seed", 1) or 1)
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(nrow, size=cnt, replace=False).astype(np.int32))
    if cnt > out_capacity:
        raise ValueError("sample indices buffer too small")
    out = np.ctypeslib.as_array(
        ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_int32)), shape=(cnt,))
    out[:] = idx
    return int(cnt)


_network_conf: Dict[str, Any] = {}


def network_init(machines: str, local_listen_port: int, listen_time_out: int,
                 num_machines: int) -> None:
    """LGBM_NetworkInit (c_api.h:1578): records the machine list.  Training
    across machines (``parallel/`` on ``torch.distributed``) is not ported
    (ROADMAP Queue 1 item 6), so more than one machine raises, as
    ``Booster.set_network`` does."""
    from .utils import log
    if num_machines > 1:
        log.fatal("LGBM_NetworkInit with num_machines > 1 (multi-device "
                  "training, ROADMAP Queue 1 item 6) is not supported by "
                  "lightgbm_tpu_torch yet")
    _network_conf.update(machines=machines, port=int(local_listen_port),
                         num_machines=int(num_machines))


def network_free() -> None:
    """LGBM_NetworkFree (c_api.h:1587)."""
    _network_conf.clear()


_log_cb_keepalive = []


def register_log_callback(fn_ptr: int) -> None:
    """LGBM_RegisterLogCallback (c_api.h:73): route this runtime's logger
    through a C callback ``void(const char*)``."""
    from .utils import log as _log
    cb_t = ctypes.CFUNCTYPE(None, ctypes.c_char_p)
    cb = cb_t(fn_ptr)
    _log_cb_keepalive.append(cb)

    def logger(msg: str) -> None:
        cb(msg.encode())

    _log.register_logger(logger)


def network_init_with_functions(num_machines: int, rank: int,
                                reduce_scatter_ptr: int,
                                allgather_ptr: int) -> None:
    """LGBM_NetworkInitWithFunctions (c_api.h:1593): externally provided
    collectives — the reference's injection point for embedders (Dask,
    .NET/SynapseML) that own their transport.

    In this runtime the injected functions serve the HOST-side
    coordination path (device-side reductions wait for ROADMAP Queue 1
    item 6) (:func:`ext_allgather` /
    :func:`ext_reduce_scatter`, usable wherever the reference called
    Network::Allgather on host buffers, e.g. bin-mapper agreement).
    Function signatures follow the reference's ReduceScatterFunction /
    AllgatherFunction typedefs."""
    _network_conf.update(num_machines=int(num_machines), rank=int(rank),
                         reduce_scatter_ptr=int(reduce_scatter_ptr),
                         allgather_ptr=int(allgather_ptr))
    if num_machines > 1:
        from .utils import log
        log.info("external collectives registered for %d machines (host-"
                 "side coordination only)" % num_machines)


def ext_allgather(local: np.ndarray, block_sizes) -> np.ndarray:
    """Run the injected allgather over host bytes.

    ``local``: this rank's uint8 buffer; ``block_sizes``: byte count per
    rank.  Mirrors the reference AllgatherFunction contract
    (input, input_size, block_start, block_len, num_block, output,
    output_size)."""
    ptr = _network_conf.get("allgather_ptr")
    if not ptr:
        raise RuntimeError("no external allgather registered "
                           "(LGBM_NetworkInitWithFunctions)")
    sizes = np.asarray(block_sizes, np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    total = int(sizes.sum())
    out = np.zeros(total, np.uint8)
    local = np.ascontiguousarray(local, np.uint8)
    fn = ctypes.CFUNCTYPE(
        None, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int)(ptr)
    fn(local.ctypes.data_as(ctypes.c_char_p), int(local.size),
       starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       int(len(sizes)), out.ctypes.data_as(ctypes.c_char_p), total)
    return out


# the reducer handed to external reduce-scatter transports (reference
# ReduceFunction: dst[i] = reduce(dst[i], src[i]) over len bytes in
# type_size chunks; here elementwise f64 sum).  Module-level so the
# ctypes thunk outlives the call.
_REDUCER_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int64)


def _sum_reducer(src_ptr, dst_ptr, type_size, nbytes):
    n = int(nbytes) // 8
    src = np.ctypeslib.as_array(
        ctypes.cast(src_ptr, ctypes.POINTER(ctypes.c_double)), shape=(n,))
    dst = np.ctypeslib.as_array(
        ctypes.cast(dst_ptr, ctypes.POINTER(ctypes.c_double)), shape=(n,))
    dst += src


_sum_reducer_cb = _REDUCER_T(_sum_reducer)


def ext_reduce_scatter(local: np.ndarray, block_sizes) -> np.ndarray:
    """Run the injected reduce-scatter over host bytes (reference
    ReduceScatterFunction contract; a real f64-sum reducer callback is
    passed, since transport implementations invoke it to combine
    blocks)."""
    ptr = _network_conf.get("reduce_scatter_ptr")
    if not ptr:
        raise RuntimeError("no external reduce_scatter registered "
                           "(LGBM_NetworkInitWithFunctions)")
    sizes = np.asarray(block_sizes, np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    rank = int(_network_conf.get("rank", 0))
    out = np.zeros(int(sizes[rank]), np.uint8)
    local = np.ascontiguousarray(local, np.uint8)
    fn = ctypes.CFUNCTYPE(
        None, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, _REDUCER_T)(ptr)
    fn(local.ctypes.data_as(ctypes.c_char_p), int(local.size), 8,
       starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       int(len(sizes)), out.ctypes.data_as(ctypes.c_char_p), int(out.size),
       _sum_reducer_cb)
    return out


# sparse prediction outputs stay alive until BoosterFreePredictSparse
# (keyed by the data buffer's address, like the reference's allocation)
_sparse_out_keepalive: Dict[int, tuple] = {}


def booster_predict_sparse_output(b_id: int, indptr_ptr: int,
                                  indices_ptr: int, data_ptr: int,
                                  nindptr: int, nelem: int,
                                  num_col_or_row: int, predict_type: int,
                                  start_iteration: int, num_iteration: int,
                                  matrix_type: int):
    """LGBM_BoosterPredictSparseOutput (c_api.h:1068): CSR-in, sparse-out
    prediction — the wide-sparse SHAP-contribution path (predict_type 3 =
    contrib, matching C_API_PREDICT_CONTRIB).  Returns
    (indptr_ptr, nindptr, indices_ptr, data_ptr, nelem) of library-owned
    buffers."""
    from scipy.sparse import csr_matrix
    if matrix_type != 0:
        raise ValueError("only C_API_MATRIX_TYPE_CSR (0) output is "
                         "supported")
    b = _handles[b_id]
    nrow = nindptr - 1
    indptr = _arr_i32(indptr_ptr, nindptr).copy()
    indices = _arr_i32(indices_ptr, nelem).copy()
    vals = _arr_f64(data_ptr, nelem).copy()
    X = csr_matrix((vals, indices, indptr),
                   shape=(nrow, num_col_or_row))
    dense = _predict_values(_handles[b_id], X, predict_type,
                            start_iteration, num_iteration)
    dense = np.asarray(dense, np.float64).reshape(nrow, -1)
    out = csr_matrix(dense)
    out_indptr = np.ascontiguousarray(out.indptr, np.int32)
    out_indices = np.ascontiguousarray(out.indices, np.int32)
    out_data = np.ascontiguousarray(out.data, np.float64)
    key = int(out_data.ctypes.data)
    _sparse_out_keepalive[key] = (out_indptr, out_indices, out_data)
    return (int(out_indptr.ctypes.data), int(out_indptr.size),
            int(out_indices.ctypes.data), key, int(out_data.size))


def booster_free_predict_sparse(data_ptr: int) -> None:
    """LGBM_BoosterFreePredictSparse (c_api.h:1088)."""
    _sparse_out_keepalive.pop(int(data_ptr), None)


_ARROW_ARRAY_STRUCT_SIZE = 80  # sizeof(ArrowArray), C Data Interface


def _import_arrow_chunks(n_chunks: int, chunks_ptr: int, schema_ptr: int):
    """ArrowArray struct array + ArrowSchema -> list of pyarrow
    RecordBatches, zero-copy over the C Data Interface buffers (ownership
    moves to pyarrow per the release-callback protocol).  The interface
    releases the schema struct on first import, so later chunks import
    through re-exports of the captured schema object."""
    import pyarrow as pa
    batches = []
    schema_obj = None
    for i in range(int(n_chunks)):
        arr_addr = int(chunks_ptr) + i * _ARROW_ARRAY_STRUCT_SIZE
        if i == 0:
            b = pa.RecordBatch._import_from_c(arr_addr, int(schema_ptr))
            schema_obj = b.schema
        else:
            tmp = (ctypes.c_byte * 72)()
            schema_obj._export_to_c(ctypes.addressof(tmp))
            b = pa.RecordBatch._import_from_c(arr_addr,
                                              ctypes.addressof(tmp))
        batches.append(b)
    return batches


def dataset_from_arrow(n_chunks: int, chunks_ptr: int, schema_ptr: int,
                       params_json: str, reference: int) -> int:
    """LGBM_DatasetCreateFromArrow (c_api.h:451): chunked Arrow record
    batches bind zero-copy at the ABI (the column buffers are wrapped, not
    copied; binning consumes them column-wise)."""
    import lightgbm_tpu_torch as lgb
    import pyarrow as pa
    batches = _import_arrow_chunks(n_chunks, chunks_ptr, schema_ptr)
    table = pa.Table.from_batches(batches)
    params = json.loads(params_json) if params_json else {}
    ref = _handles[reference] if reference else None
    if ref is not None:
        ds = ref.create_valid(table)
    else:
        ds = lgb.Dataset(table, params=params)
    ds.construct()
    return _new_handle(ds)


def dataset_set_field_from_arrow(ds_id: int, field: str, n_chunks: int,
                                 chunks_ptr: int, schema_ptr: int) -> None:
    """LGBM_DatasetSetFieldFromArrow (c_api.h:498)."""
    import pyarrow as pa
    chunks = []
    typ = None
    for i in range(int(n_chunks)):
        addr = int(chunks_ptr) + i * _ARROW_ARRAY_STRUCT_SIZE
        if i == 0:
            a = pa.Array._import_from_c(addr, int(schema_ptr))
            typ = a.type
        else:
            tmp = (ctypes.c_byte * 72)()
            typ._export_to_c(ctypes.addressof(tmp))
            a = pa.Array._import_from_c(addr, ctypes.addressof(tmp))
        chunks.append(a)
    vals = pa.chunked_array(chunks).to_numpy(zero_copy_only=False)
    ds = _handles[ds_id]
    vals = np.asarray(vals, np.float64)
    if field == "weight":
        ds.set_weight(vals)
    elif field == "label":
        ds.set_label(vals)
    elif field == "init_score":
        ds.set_init_score(vals)
    elif field == "group":
        ds.set_group(vals.astype(np.int64))
    elif field == "position":
        ds.set_position(vals.astype(np.int32))
    else:
        raise ValueError(f"unknown field {field}")


def booster_predict_for_arrow(b_id: int, n_chunks: int, chunks_ptr: int,
                              schema_ptr: int, predict_type: int,
                              start_iteration: int, num_iteration: int,
                              out_ptr: int, out_capacity: int) -> int:
    """LGBM_BoosterPredictForArrow (c_api.h:1456)."""
    import pyarrow as pa
    batches = _import_arrow_chunks(n_chunks, chunks_ptr, schema_ptr)
    table = pa.Table.from_batches(batches)
    cols = [np.asarray(c.to_numpy(zero_copy_only=False), np.float64)
            for c in table.columns]
    X = np.column_stack(cols) if cols else np.zeros((0, 0))
    return _predict_any(b_id, X, predict_type, start_iteration,
                        num_iteration, out_ptr, out_capacity)


def dataset_from_sampled_column(sample_data_ptr: int, sample_idx_ptr: int,
                                ncol: int, num_per_col_ptr: int,
                                num_sample_row: int, num_local_row: int,
                                num_dist_row: int, params_json: str) -> int:
    """LGBM_DatasetCreateFromSampledColumn (c_api.h:145): bin mappers are
    fixed from the pre-sampled columns NOW (the reference's
    ConstructFromSampleData); rows arrive afterwards via
    LGBM_DatasetPushRows and bin through those mappers.  Realized by
    reconstructing the sampled matrix (elided entries are zeros), binning
    it into a throwaway reference dataset, and aligning the streaming
    collector to it (create_valid semantics)."""
    import lightgbm_tpu_torch as lgb
    ncol = int(ncol)
    nsr = int(num_sample_row)
    per_col = _arr_i32(num_per_col_ptr, ncol)
    data_ptrs = np.ctypeslib.as_array(
        ctypes.cast(sample_data_ptr, ctypes.POINTER(ctypes.c_uint64)),
        shape=(ncol,))
    idx_ptrs = np.ctypeslib.as_array(
        ctypes.cast(sample_idx_ptr, ctypes.POINTER(ctypes.c_uint64)),
        shape=(ncol,))
    sample = np.zeros((nsr, ncol), np.float64)
    for j in range(ncol):
        cnt = int(per_col[j])
        if cnt == 0:
            continue
        vals = _arr_f64(int(data_ptrs[j]), cnt)
        rows = _arr_i32(int(idx_ptrs[j]), cnt)
        sample[rows, j] = vals
    params = json.loads(params_json) if params_json else {}
    ref = lgb.Dataset(sample, params=params)
    ref.construct()
    collector = _StreamCollector(ncol, params)
    collector.reference = ref
    collector.expected_rows = int(num_local_row)
    return _new_handle(collector)


def fastpredict_init_csr(b_id: int, ncol: int, raw_score: int) -> int:
    """LGBM_BoosterPredictForCSRSingleRowFastInit (c_api.h:1216)."""
    return fastpredict_init(b_id, ncol, raw_score)


def fastpredict_row_csr(f_id: int, indices_ptr: int, data_ptr: int,
                        nelem: int, out_ptr: int, out_capacity: int) -> int:
    """LGBM_BoosterPredictForCSRSingleRowFast (c_api.h:1246)."""
    fp = _handles[f_id]
    row = np.zeros(fp.ncol)
    idx = _arr_i32(indices_ptr, nelem)
    row[idx] = _arr_f64(data_ptr, nelem)
    out = fp.predict_row(row)
    if out.size > out_capacity:
        raise ValueError("fast predict buffer too small")
    _arr_f64(out_ptr, out.size)[:] = out
    return int(out.size)

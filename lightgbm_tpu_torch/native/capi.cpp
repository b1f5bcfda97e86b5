// C ABI for lightgbm_tpu_torch — the counterpart of the reference's LGBM_*
// C API (reference: src/c_api.cpp, include/LightGBM/c_api.h), with the same
// LGBMTPU_* functions and signatures as lightgbm_tpu's shim (capi.h).  The
// core is the PyTorch package, so this shim embeds CPython and dispatches to
// lightgbm_tpu_torch/capi_impl.py, whose entry points run on the CUDA card
// unless the params JSON says device_type=cpu.  Any C/C++/C#/Java/R consumer
// links this .so exactly like the reference's lib_lightgbm.
//
// Conventions follow the reference ABI: every function returns 0 on success
// and -1 on failure, with LGBMTPU_GetLastError() returning the message
// (thread-local); each call takes the GIL, so calls from several threads
// run one at a time.
//
// Build (native/__init__.py build_capi): g++ -O2 -shared -fPIC capi.cpp
//   $(python3-config --includes --embed --ldflags) -o liblgbtpu_capi.so

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace {

// thread-local so the pointer returned by GetLastError stays valid while
// other threads fail (the reference ABI does the same)
thread_local std::string g_last_error;
PyThreadState* g_main_state = nullptr;

void SetError(const std::string& msg) { g_last_error = msg; }

// Initialize the embedded interpreter once; release the GIL afterwards so
// API calls can come from any thread (each call re-acquires it).
bool EnsurePython() {
  static std::once_flag once;
  static bool ok = false;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      g_main_state = PyEval_SaveThread();
    }
    ok = true;
  });
  return ok;
}

// Call lightgbm_tpu_torch.capi_impl.<fn>(args...); returns new ref or
// nullptr.
PyObject* CallImpl(const char* fn, PyObject* args) {
  PyObject* mod = PyImport_ImportModule("lightgbm_tpu_torch.capi_impl");
  if (!mod) return nullptr;
  PyObject* f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (!f) return nullptr;
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return r;
}

std::string FetchPyError() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "unknown python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* u = PyUnicode_AsUTF8(s);
      if (u) msg = u;
      else PyErr_Clear();  // undecodable message; keep the fallback
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

// Run fn under the GIL; on python error captures the message, returns -1.
template <typename F>
int WithGIL(F&& body) {
  if (!EnsurePython()) {
    SetError("python initialization failed");
    return -1;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = body();
  if (rc != 0 && PyErr_Occurred()) {
    SetError(FetchPyError());
    PyErr_Clear();
  }
  PyGILState_Release(st);
  return rc;
}

}  // namespace

extern "C" {

const char* LGBMTPU_GetLastError() { return g_last_error.c_str(); }

int LGBMTPU_DatasetCreateFromMat(const double* data, int64_t nrow,
                                 int64_t ncol, const double* label,
                                 const char* params_json, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLs)", (long long)(intptr_t)data, (long long)nrow,
        (long long)ncol, (long long)(intptr_t)label,
        params_json ? params_json : "{}");
    PyObject* r = CallImpl("dataset_from_mat", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_DatasetSetField(int64_t dataset, const char* field,
                            const double* vals, int64_t n) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(LsLL)", (long long)dataset, field,
                                   (long long)(intptr_t)vals, (long long)n);
    PyObject* r = CallImpl("dataset_set_field", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterCreate(int64_t dataset, const char* params_json,
                          int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(Ls)", (long long)dataset,
                                   params_json ? params_json : "{}");
    PyObject* r = CallImpl("booster_create", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterCreateFromModelfile(const char* path, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(s)", path);
    PyObject* r = CallImpl("booster_create_from_modelfile", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterUpdateOneIter(int64_t booster, int* is_finished) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)booster);
    PyObject* r = CallImpl("booster_update_one_iter", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *is_finished = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// ``out_len`` is in/out: pass the out buffer's capacity in doubles
// (like the reference's out_len contract); the call fails rather than
// overflow (multiclass writes nrow * num_class doubles).
int LGBMTPU_BoosterPredictForMat(int64_t booster, const double* data,
                                 int64_t nrow, int64_t ncol, int raw_score,
                                 double* out, int64_t* out_len) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLiLL)", (long long)booster, (long long)(intptr_t)data,
        (long long)nrow, (long long)ncol, raw_score,
        (long long)(intptr_t)out, (long long)*out_len);
    PyObject* r = CallImpl("booster_predict_for_mat", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out_len = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterSaveModel(int64_t booster, const char* path) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(Ls)", (long long)booster, path);
    PyObject* r = CallImpl("booster_save_model", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterNumClasses(int64_t booster, int* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)booster);
    PyObject* r = CallImpl("booster_num_classes", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterNumTrees(int64_t booster, int* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)booster);
    PyObject* r = CallImpl("booster_num_trees", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// The CSR payload is binned column-wise without densification (sparse
// ingestion path; peak memory is O(nnz + nrow * n_bundles)).  Duplicate
// (row, col) entries are summed (scipy.sparse semantics).
int LGBMTPU_DatasetCreateFromCSR(const int32_t* indptr,
                                 const int32_t* indices, const double* data,
                                 int64_t nrow, int64_t nnz, int64_t ncol,
                                 const double* label,
                                 const char* params_json, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLLLLs)", (long long)(intptr_t)indptr,
        (long long)(intptr_t)indices, (long long)(intptr_t)data,
        (long long)nrow, (long long)nnz, (long long)ncol,
        (long long)(intptr_t)label, params_json ? params_json : "{}");
    PyObject* r = CallImpl("dataset_from_csr", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// Streaming ingestion (reference LGBM_DatasetInitStreaming c_api.h:177,
// LGBM_DatasetPushRows :203): push chunks from any producer, then
// MarkFinished to bin and finalize the dataset in place.
int LGBMTPU_DatasetInitStreaming(int64_t ncol, const char* params_json,
                                 int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(Ls)", (long long)ncol,
                                   params_json ? params_json : "{}");
    PyObject* r = CallImpl("dataset_init_streaming", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_DatasetPushRows(int64_t dataset, const double* data,
                            int64_t nrow, int64_t ncol,
                            const double* label) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLL)", (long long)dataset, (long long)(intptr_t)data,
        (long long)nrow, (long long)ncol, (long long)(intptr_t)label);
    PyObject* r = CallImpl("dataset_push_rows", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_DatasetMarkFinished(int64_t dataset) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)dataset);
    PyObject* r = CallImpl("dataset_mark_finished", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_DatasetGetNumData(int64_t dataset, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)dataset);
    PyObject* r = CallImpl("dataset_num_data", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_DatasetGetNumFeature(int64_t dataset, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)dataset);
    PyObject* r = CallImpl("dataset_num_feature", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterAddValidData(int64_t booster, int64_t dataset) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(LL)", (long long)booster,
                                   (long long)dataset);
    PyObject* r = CallImpl("booster_add_valid_data", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

// data_idx 0 = train, 1.. = valid sets; out_len in: capacity, out: count.
int LGBMTPU_BoosterGetEval(int64_t booster, int data_idx, double* out,
                           int64_t* out_len) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LiLL)", (long long)booster, data_idx, (long long)(intptr_t)out,
        (long long)*out_len);
    PyObject* r = CallImpl("booster_get_eval", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out_len = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterRollbackOneIter(int64_t booster) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)booster);
    PyObject* r = CallImpl("booster_rollback_one_iter", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterGetCurrentIteration(int64_t booster, int* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)booster);
    PyObject* r = CallImpl("booster_current_iteration", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// out_len in: buffer capacity in bytes; out: required size including the
// NUL terminator.  Call with capacity 0 to size the buffer.
int LGBMTPU_BoosterSaveModelToString(int64_t booster, char* out,
                                     int64_t* out_len) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(LLL)", (long long)booster,
                                   (long long)(intptr_t)out,
                                   (long long)*out_len);
    PyObject* r = CallImpl("booster_save_model_to_string", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out_len = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_FreeHandle(int64_t handle) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)handle);
    PyObject* r = CallImpl("free_handle", args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
  });
}

// Like the CSR path: binned without densification, duplicates summed.
// (reference LGBM_DatasetCreateFromCSC c_api.h:479)
int LGBMTPU_DatasetCreateFromCSC(const int32_t* colptr,
                                 const int32_t* indices, const double* data,
                                 int64_t ncol, int64_t nnz, int64_t nrow,
                                 const double* label,
                                 const char* params_json, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLLLLs)", (long long)(intptr_t)colptr,
        (long long)(intptr_t)indices, (long long)(intptr_t)data,
        (long long)ncol, (long long)nnz, (long long)nrow,
        (long long)(intptr_t)label, params_json ? params_json : "");
    PyObject* r = CallImpl("dataset_from_csc", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// reference LGBM_BoosterLoadModelFromString (c_api.h:677)
int LGBMTPU_BoosterLoadModelFromString(const char* model_str, int64_t* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(s)", model_str);
    PyObject* r = CallImpl("booster_from_string", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// reference LGBM_BoosterGetNumFeature (c_api.h:876)
int LGBMTPU_BoosterGetNumFeature(int64_t booster, int* out) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", (long long)booster);
    PyObject* r = CallImpl("booster_num_feature", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return 0;
  });
}

namespace {
// Shared plumbing for the newline-joined string getters: writes a
// NUL-terminated copy when the buffer fits; always reports the required
// size INCLUDING the terminator (reference out_buffer_len contract).
int StringCall(const char* impl_fn, long long handle, char* buffer,
               int64_t buffer_len, int64_t* out_len) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(L)", handle);
    PyObject* r = CallImpl(impl_fn, args);
    Py_XDECREF(args);
    if (!r) return -1;
    Py_ssize_t n = 0;
    const char* s = PyUnicode_AsUTF8AndSize(r, &n);
    if (!s) {
      Py_DECREF(r);
      return -1;
    }
    *out_len = (int64_t)n + 1;
    if (buffer && buffer_len >= n + 1) {
      memcpy(buffer, s, n + 1);
    }
    Py_DECREF(r);
    return 0;
  });
}
}  // namespace

// reference LGBM_BoosterGetFeatureNames (c_api.h:845); names are
// newline-joined in one buffer (simpler ABI than char** + per-name sizes)
int LGBMTPU_BoosterGetFeatureNames(int64_t booster, char* buffer,
                                   int64_t buffer_len, int64_t* out_len) {
  return StringCall("booster_feature_names", (long long)booster, buffer,
                    buffer_len, out_len);
}

// reference LGBM_BoosterGetEvalNames (c_api.h:826)
int LGBMTPU_BoosterGetEvalNames(int64_t booster, char* buffer,
                                int64_t buffer_len, int64_t* out_len) {
  return StringCall("booster_eval_names", (long long)booster, buffer,
                    buffer_len, out_len);
}

// Fast single-row predict (reference c_api.h:1162
// LGBM_BoosterPredictForMatSingleRowFastInit + ...SingleRowFast): the
// returned config holds the model's bucket-1 serving predictor
// (serving/predictor.py), so per-row calls skip all model setup.  Free with LGBMTPU_FreeHandle.
int LGBMTPU_BoosterPredictForMatSingleRowFastInit(int64_t booster,
                                                  int64_t ncol,
                                                  int raw_score,
                                                  int64_t* out_config) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue("(LLi)", (long long)booster,
                                   (long long)ncol, raw_score);
    PyObject* r = CallImpl("fastpredict_init", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out_config = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

int LGBMTPU_BoosterPredictForMatSingleRowFast(int64_t config,
                                              const double* row,
                                              double* out,
                                              int64_t out_capacity,
                                              int64_t* out_len) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLL)", (long long)config, (long long)(intptr_t)row,
        (long long)(intptr_t)out, (long long)out_capacity);
    PyObject* r = CallImpl("fastpredict_row", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out_len = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The rest of the reference c_api.h surface.  Compact dispatch helpers keep
// each export to a handful of lines.
// ---------------------------------------------------------------------------

namespace {

// call impl fn with pre-built args; discard result
int CallVoid(const char* fn, PyObject* args) {
  PyObject* r = CallImpl(fn, args);
  Py_XDECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

// call impl fn; *out = integer result
int CallI64(const char* fn, PyObject* args, int64_t* out) {
  PyObject* r = CallImpl(fn, args);
  Py_XDECREF(args);
  if (!r) return -1;
  *out = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int CallF64(const char* fn, PyObject* args, double* out) {
  PyObject* r = CallImpl(fn, args);
  Py_XDECREF(args);
  if (!r) return -1;
  *out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return 0;
}

// call impl fn returning str; copy into (buf, cap), *out_len = required
// size incl. NUL (call with cap 0 to size the buffer)
int CallStr(const char* fn, PyObject* args, char* buf, int64_t cap,
            int64_t* out_len) {
  PyObject* r = CallImpl(fn, args);
  Py_XDECREF(args);
  if (!r) return -1;
  Py_ssize_t n = 0;
  const char* s = PyUnicode_AsUTF8AndSize(r, &n);
  if (!s) { Py_DECREF(r); return -1; }
  *out_len = (int64_t)n + 1;
  if (buf && cap >= n + 1) std::memcpy(buf, s, n + 1);
  Py_DECREF(r);
  return 0;
}

}  // namespace

#define LP(x) (long long)(x)
#define LPTR(x) (long long)(intptr_t)(x)

extern "C" {

int LGBMTPU_BoosterPredictForMat2(int64_t booster, const double* data,
                                  int64_t nrow, int64_t ncol,
                                  int predict_type, int start_iteration,
                                  int num_iteration, double* out,
                                  int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_predict_for_mat2",
                   Py_BuildValue("(LLLLiiiLL)", LP(booster), LPTR(data),
                                 LP(nrow), LP(ncol), predict_type,
                                 start_iteration, num_iteration, LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_BoosterPredictForCSR(int64_t booster, const int32_t* indptr,
                                 const int32_t* indices, const double* data,
                                 int64_t nindptr, int64_t nelem,
                                 int64_t ncol, int predict_type,
                                 int start_iteration, int num_iteration,
                                 double* out, int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_predict_for_csr",
                   Py_BuildValue("(LLLLLLLiiiLL)", LP(booster), LPTR(indptr),
                                 LPTR(indices), LPTR(data), LP(nindptr),
                                 LP(nelem), LP(ncol), predict_type,
                                 start_iteration, num_iteration, LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_BoosterPredictForCSC(int64_t booster, const int32_t* colptr,
                                 const int32_t* indices, const double* data,
                                 int64_t ncolptr, int64_t nelem,
                                 int64_t nrow, int predict_type,
                                 int start_iteration, int num_iteration,
                                 double* out, int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_predict_for_csc",
                   Py_BuildValue("(LLLLLLLiiiLL)", LP(booster), LPTR(colptr),
                                 LPTR(indices), LPTR(data), LP(ncolptr),
                                 LP(nelem), LP(nrow), predict_type,
                                 start_iteration, num_iteration, LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_BoosterPredictForFile(int64_t booster, const char* data_path,
                                  int has_header, int predict_type,
                                  int start_iteration, int num_iteration,
                                  const char* result_path) {
  return WithGIL([&] {
    int64_t n = 0;
    return CallI64("booster_predict_for_file",
                   Py_BuildValue("(Lsiiiis)", LP(booster), data_path,
                                 has_header, predict_type, start_iteration,
                                 num_iteration, result_path), &n);
  });
}

int LGBMTPU_BoosterPredictForMatSingleRow(int64_t booster, const double* row,
                                          int64_t ncol, int predict_type,
                                          int start_iteration,
                                          int num_iteration, double* out,
                                          int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_predict_for_mat_single_row",
                   Py_BuildValue("(LLLiiiLL)", LP(booster), LPTR(row),
                                 LP(ncol), predict_type, start_iteration,
                                 num_iteration, LPTR(out), LP(*out_len)),
                   out_len);
  });
}

int LGBMTPU_BoosterPredictForCSRSingleRow(int64_t booster,
                                          const int32_t* indices,
                                          const double* data, int64_t nelem,
                                          int64_t ncol, int predict_type,
                                          int start_iteration,
                                          int num_iteration, double* out,
                                          int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_predict_for_csr_single_row",
                   Py_BuildValue("(LLLLLiiiLL)", LP(booster), LPTR(indices),
                                 LPTR(data), LP(nelem), LP(ncol),
                                 predict_type, start_iteration,
                                 num_iteration, LPTR(out), LP(*out_len)),
                   out_len);
  });
}

int LGBMTPU_BoosterCalcNumPredict(int64_t booster, int64_t nrow,
                                  int predict_type, int start_iteration,
                                  int num_iteration, int64_t* out) {
  return WithGIL([&] {
    return CallI64("booster_calc_num_predict",
                   Py_BuildValue("(LLiii)", LP(booster), LP(nrow),
                                 predict_type, start_iteration,
                                 num_iteration), out);
  });
}

int LGBMTPU_BoosterDumpModel(int64_t booster, int num_iteration, char* out,
                             int64_t buffer_len, int64_t* out_len) {
  return WithGIL([&] {
    return CallStr("booster_dump_model",
                   Py_BuildValue("(Li)", LP(booster), num_iteration), out,
                   buffer_len, out_len);
  });
}

int LGBMTPU_BoosterFeatureImportance(int64_t booster, int importance_type,
                                     double* out, int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_feature_importance",
                   Py_BuildValue("(LiLL)", LP(booster), importance_type,
                                 LPTR(out), LP(*out_len)), out_len);
  });
}

int LGBMTPU_BoosterGetEvalCounts(int64_t booster, int* out) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("booster_get_eval_counts",
                     Py_BuildValue("(L)", LP(booster)), &v);
    *out = (int)v;
    return rc;
  });
}

int LGBMTPU_BoosterGetLeafValue(int64_t booster, int tree_idx, int leaf_idx,
                                double* out) {
  return WithGIL([&] {
    return CallF64("booster_get_leaf_value",
                   Py_BuildValue("(Lii)", LP(booster), tree_idx, leaf_idx),
                   out);
  });
}

int LGBMTPU_BoosterSetLeafValue(int64_t booster, int tree_idx, int leaf_idx,
                                double value) {
  return WithGIL([&] {
    return CallVoid("booster_set_leaf_value",
                    Py_BuildValue("(Liid)", LP(booster), tree_idx, leaf_idx,
                                  value));
  });
}

int LGBMTPU_BoosterGetLinear(int64_t booster, int* out) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("booster_get_linear",
                     Py_BuildValue("(L)", LP(booster)), &v);
    *out = (int)v;
    return rc;
  });
}

int LGBMTPU_BoosterGetLoadedParam(int64_t booster, char* out,
                                  int64_t buffer_len, int64_t* out_len) {
  return WithGIL([&] {
    return CallStr("booster_get_loaded_param",
                   Py_BuildValue("(L)", LP(booster)), out, buffer_len,
                   out_len);
  });
}

int LGBMTPU_BoosterGetLowerBoundValue(int64_t booster, double* out) {
  return WithGIL([&] {
    return CallF64("booster_get_lower_bound_value",
                   Py_BuildValue("(L)", LP(booster)), out);
  });
}

int LGBMTPU_BoosterGetUpperBoundValue(int64_t booster, double* out) {
  return WithGIL([&] {
    return CallF64("booster_get_upper_bound_value",
                   Py_BuildValue("(L)", LP(booster)), out);
  });
}

int LGBMTPU_BoosterGetNumPredict(int64_t booster, int data_idx,
                                 int64_t* out) {
  return WithGIL([&] {
    return CallI64("booster_get_num_predict",
                   Py_BuildValue("(Li)", LP(booster), data_idx), out);
  });
}

int LGBMTPU_BoosterGetPredict(int64_t booster, int data_idx, double* out,
                              int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_get_predict",
                   Py_BuildValue("(LiLL)", LP(booster), data_idx, LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_BoosterMerge(int64_t booster, int64_t other) {
  return WithGIL([&] {
    return CallVoid("booster_merge",
                    Py_BuildValue("(LL)", LP(booster), LP(other)));
  });
}

int LGBMTPU_BoosterNumModelPerIteration(int64_t booster, int* out) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("booster_num_model_per_iteration",
                     Py_BuildValue("(L)", LP(booster)), &v);
    *out = (int)v;
    return rc;
  });
}

int LGBMTPU_BoosterNumberOfTotalModel(int64_t booster, int* out) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("booster_number_of_total_model",
                     Py_BuildValue("(L)", LP(booster)), &v);
    *out = (int)v;
    return rc;
  });
}

int LGBMTPU_BoosterRefit(int64_t booster, const int32_t* leaf_preds,
                         int64_t nrow, int64_t ncol) {
  return WithGIL([&] {
    return CallVoid("booster_refit",
                    Py_BuildValue("(LLLL)", LP(booster), LPTR(leaf_preds),
                                  LP(nrow), LP(ncol)));
  });
}

int LGBMTPU_BoosterResetParameter(int64_t booster, const char* params_json) {
  return WithGIL([&] {
    return CallVoid("booster_reset_parameter",
                    Py_BuildValue("(Ls)", LP(booster),
                                  params_json ? params_json : "{}"));
  });
}

int LGBMTPU_BoosterResetTrainingData(int64_t booster, int64_t dataset) {
  return WithGIL([&] {
    return CallVoid("booster_reset_training_data",
                    Py_BuildValue("(LL)", LP(booster), LP(dataset)));
  });
}

int LGBMTPU_BoosterShuffleModels(int64_t booster, int start, int end) {
  return WithGIL([&] {
    return CallVoid("booster_shuffle_models",
                    Py_BuildValue("(Lii)", LP(booster), start, end));
  });
}

int LGBMTPU_BoosterUpdateOneIterCustom(int64_t booster, const float* grad,
                                       const float* hess, int64_t n,
                                       int* is_finished) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("booster_update_one_iter_custom",
                     Py_BuildValue("(LLLL)", LP(booster), LPTR(grad),
                                   LPTR(hess), LP(n)), &v);
    *is_finished = (int)v;
    return rc;
  });
}

int LGBMTPU_BoosterValidateFeatureNames(int64_t booster,
                                        const char* names_json) {
  return WithGIL([&] {
    return CallVoid("booster_validate_feature_names",
                    Py_BuildValue("(Ls)", LP(booster), names_json));
  });
}

int LGBMTPU_DatasetCreateFromFile(const char* path, const char* params_json,
                                  int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_from_file",
                   Py_BuildValue("(ss)", path,
                                 params_json ? params_json : "{}"), out);
  });
}

int LGBMTPU_DatasetCreateFromMats(int nmat, const double** data,
                                  const int32_t* nrows, int64_t ncol,
                                  const double* label,
                                  const char* params_json, int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_from_mats",
                   Py_BuildValue("(iLLLLs)", nmat, LPTR(data), LPTR(nrows),
                                 LP(ncol), LPTR(label),
                                 params_json ? params_json : "{}"), out);
  });
}

int LGBMTPU_DatasetCreateByReference(int64_t reference,
                                     int64_t num_total_row, int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_create_by_reference",
                   Py_BuildValue("(LL)", LP(reference), LP(num_total_row)),
                   out);
  });
}

int LGBMTPU_DatasetSaveBinary(int64_t dataset, const char* path) {
  return WithGIL([&] {
    return CallVoid("dataset_save_binary",
                    Py_BuildValue("(Ls)", LP(dataset), path));
  });
}

int LGBMTPU_DatasetDumpText(int64_t dataset, const char* path) {
  return WithGIL([&] {
    return CallVoid("dataset_dump_text",
                    Py_BuildValue("(Ls)", LP(dataset), path));
  });
}

int LGBMTPU_DatasetSetFeatureNames(int64_t dataset, const char* names_json) {
  return WithGIL([&] {
    return CallVoid("dataset_set_feature_names",
                    Py_BuildValue("(Ls)", LP(dataset), names_json));
  });
}

int LGBMTPU_DatasetGetFeatureNames(int64_t dataset, char* out,
                                   int64_t buffer_len, int64_t* out_len) {
  return WithGIL([&] {
    return CallStr("dataset_get_feature_names",
                   Py_BuildValue("(L)", LP(dataset)), out, buffer_len,
                   out_len);
  });
}

int LGBMTPU_DatasetGetFeatureNumBin(int64_t dataset, int fidx,
                                    int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_get_feature_num_bin",
                   Py_BuildValue("(Li)", LP(dataset), fidx), out);
  });
}

int LGBMTPU_DatasetGetField(int64_t dataset, const char* field, double* out,
                            int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("dataset_get_field",
                   Py_BuildValue("(LsLL)", LP(dataset), field, LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_DatasetGetSubset(int64_t dataset, const int32_t* indices,
                             int64_t n, const char* params_json,
                             int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_get_subset",
                   Py_BuildValue("(LLLs)", LP(dataset), LPTR(indices),
                                 LP(n), params_json ? params_json : "{}"),
                   out);
  });
}

int LGBMTPU_DatasetAddFeaturesFrom(int64_t dataset, int64_t other) {
  return WithGIL([&] {
    return CallVoid("dataset_add_features_from",
                    Py_BuildValue("(LL)", LP(dataset), LP(other)));
  });
}

int LGBMTPU_DatasetUpdateParamChecking(const char* old_params,
                                       const char* new_params) {
  return WithGIL([&] {
    return CallVoid("dataset_update_param_checking",
                    Py_BuildValue("(ss)", old_params ? old_params : "{}",
                                  new_params ? new_params : "{}"));
  });
}

int LGBMTPU_DatasetPushRowsWithMetadata(int64_t dataset, const double* data,
                                        int64_t nrow, int64_t ncol,
                                        const double* label,
                                        const double* weight,
                                        const int32_t* group,
                                        const double* init_score) {
  return WithGIL([&] {
    return CallVoid("dataset_push_rows_with_metadata",
                    Py_BuildValue("(LLLLLLLL)", LP(dataset), LPTR(data),
                                  LP(nrow), LP(ncol), LPTR(label),
                                  LPTR(weight), LPTR(group),
                                  LPTR(init_score)));
  });
}

int LGBMTPU_DatasetPushRowsByCSR(int64_t dataset, const int32_t* indptr,
                                 const int32_t* indices, const double* data,
                                 int64_t nindptr, int64_t nelem,
                                 int64_t ncol, const double* label) {
  return WithGIL([&] {
    return CallVoid("dataset_push_rows_by_csr",
                    Py_BuildValue("(LLLLLLLL)", LP(dataset), LPTR(indptr),
                                  LPTR(indices), LPTR(data), LP(nindptr),
                                  LP(nelem), LP(ncol), LPTR(label)));
  });
}

int LGBMTPU_DatasetPushRowsByCSRWithMetadata(
    int64_t dataset, const int32_t* indptr, const int32_t* indices,
    const double* data, int64_t nindptr, int64_t nelem, int64_t ncol,
    const double* label, const double* weight, const int32_t* group,
    const double* init_score) {
  return WithGIL([&] {
    return CallVoid("dataset_push_rows_by_csr_with_metadata",
                    Py_BuildValue("(LLLLLLLLLLL)", LP(dataset), LPTR(indptr),
                                  LPTR(indices), LPTR(data), LP(nindptr),
                                  LP(nelem), LP(ncol), LPTR(label),
                                  LPTR(weight), LPTR(group),
                                  LPTR(init_score)));
  });
}

int LGBMTPU_DatasetSetWaitForManualFinish(int64_t dataset, int wait) {
  return WithGIL([&] {
    return CallVoid("dataset_set_wait_for_manual_finish",
                    Py_BuildValue("(Li)", LP(dataset), wait));
  });
}

int LGBMTPU_DatasetSerializeReferenceToBinary(int64_t dataset,
                                              int64_t* out_buffer,
                                              int64_t* out_size) {
  return WithGIL([&] {
    int rc = CallI64("dataset_serialize_reference_to_binary",
                     Py_BuildValue("(L)", LP(dataset)), out_buffer);
    if (rc != 0) return rc;
    return CallI64("byte_buffer_size",
                   Py_BuildValue("(L)", LP(*out_buffer)), out_size);
  });
}

int LGBMTPU_DatasetCreateFromSerializedReference(const void* buffer,
                                                 int64_t len,
                                                 int64_t num_total_row,
                                                 const char* params_json,
                                                 int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_from_serialized_reference",
                   Py_BuildValue("(LLLs)", LPTR(buffer), LP(len),
                                 LP(num_total_row),
                                 params_json ? params_json : "{}"), out);
  });
}

int LGBMTPU_ByteBufferGetAt(int64_t handle, int64_t index, uint8_t* out) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("byte_buffer_get_at",
                     Py_BuildValue("(LL)", LP(handle), LP(index)), &v);
    *out = (uint8_t)v;
    return rc;
  });
}

int LGBMTPU_ByteBufferFree(int64_t handle) {
  return WithGIL([&] {
    return CallVoid("free_handle", Py_BuildValue("(L)", LP(handle)));
  });
}

int LGBMTPU_GetMaxThreads(int* out) {
  return WithGIL([&] {
    int64_t v = 0;
    int rc = CallI64("get_max_threads", Py_BuildValue("()"), &v);
    *out = (int)v;
    return rc;
  });
}

int LGBMTPU_SetMaxThreads(int n) {
  return WithGIL([&] {
    return CallVoid("set_max_threads", Py_BuildValue("(i)", n));
  });
}

int LGBMTPU_DumpParamAliases(char* out, int64_t buffer_len,
                             int64_t* out_len) {
  return WithGIL([&] {
    return CallStr("dump_param_aliases", Py_BuildValue("()"), out,
                   buffer_len, out_len);
  });
}

int LGBMTPU_GetSampleCount(int64_t nrow, const char* params_json,
                           int64_t* out) {
  return WithGIL([&] {
    return CallI64("get_sample_count",
                   Py_BuildValue("(Ls)", LP(nrow),
                                 params_json ? params_json : "{}"), out);
  });
}

int LGBMTPU_SampleIndices(int64_t nrow, const char* params_json,
                          int32_t* out, int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("sample_indices",
                   Py_BuildValue("(LsLL)", LP(nrow),
                                 params_json ? params_json : "{}", LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_NetworkInit(const char* machines, int local_listen_port,
                        int listen_time_out, int num_machines) {
  return WithGIL([&] {
    return CallVoid("network_init",
                    Py_BuildValue("(siii)", machines ? machines : "",
                                  local_listen_port, listen_time_out,
                                  num_machines));
  });
}

int LGBMTPU_NetworkFree() {
  return WithGIL([&] {
    return CallVoid("network_free", Py_BuildValue("()"));
  });
}

int LGBMTPU_RegisterLogCallback(void (*callback)(const char*)) {
  return WithGIL([&] {
    return CallVoid("register_log_callback",
                    Py_BuildValue("(L)", LPTR(callback)));
  });
}

int LGBMTPU_BoosterPredictForCSRSingleRowFastInit(int64_t booster,
                                                  int64_t ncol,
                                                  int raw_score,
                                                  int64_t* out) {
  return WithGIL([&] {
    return CallI64("fastpredict_init_csr",
                   Py_BuildValue("(LLi)", LP(booster), LP(ncol), raw_score),
                   out);
  });
}

int LGBMTPU_BoosterPredictForCSRSingleRowFast(int64_t fast_handle,
                                              const int32_t* indices,
                                              const double* data,
                                              int64_t nelem, double* out,
                                              int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("fastpredict_row_csr",
                   Py_BuildValue("(LLLLLL)", LP(fast_handle), LPTR(indices),
                                 LPTR(data), LP(nelem), LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

int LGBMTPU_FastConfigFree(int64_t fast_handle) {
  return WithGIL([&] {
    return CallVoid("free_handle", Py_BuildValue("(L)", LP(fast_handle)));
  });
}

// ---------------------------------------------------------------------------
// Name aliases, external collectives, sparse output, Arrow, sampled
// columns, the CSR row callback and row-pointer matrices.

// exact-name aliases of existing entries (reference c_api.h naming)
int LGBMTPU_BoosterFree(int64_t handle) {
  return WithGIL([&] {
    return CallVoid("free_handle", Py_BuildValue("(L)", LP(handle)));
  });
}

int LGBMTPU_DatasetFree(int64_t handle) {
  return WithGIL([&] {
    return CallVoid("free_handle", Py_BuildValue("(L)", LP(handle)));
  });
}

int LGBMTPU_BoosterGetNumClasses(int64_t booster, int* out) {
  return LGBMTPU_BoosterNumClasses(booster, out);
}

void LGBMTPU_SetLastError(const char* msg) { SetError(msg ? msg : ""); }

// reference c_api.h:1593 — external collective injection (how Dask/.NET
// style embedders plug custom transports into the reference).  On this
// runtime device-side collectives are XLA's; the injected functions serve
// the HOST-side coordination path (capi_impl.ext_allgather/ext_reduce_scatter).
int LGBMTPU_NetworkInitWithFunctions(int num_machines, int rank,
                                     void* reduce_scatter_ext_fun,
                                     void* allgather_ext_fun) {
  return WithGIL([&] {
    return CallVoid("network_init_with_functions",
                    Py_BuildValue("(iiLL)", num_machines, rank,
                                  LPTR(reduce_scatter_ext_fun),
                                  LPTR(allgather_ext_fun)));
  });
}

// reference c_api.h:1068 — sparse (CSR) prediction output, the wide-data
// SHAP-contribution path.  Output buffers are owned by the library until
// LGBMTPU_BoosterFreePredictSparse.
int LGBMTPU_BoosterPredictSparseOutput(
    int64_t booster, const int32_t* indptr, const int32_t* indices,
    const double* data, int64_t nindptr, int64_t nelem,
    int64_t num_col_or_row, int predict_type, int start_iteration,
    int num_iteration, int matrix_type, int64_t* out_len,
    int32_t** out_indptr, int32_t** out_indices, double** out_data) {
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLLLLiiii)", LP(booster), LPTR(indptr), LPTR(indices),
        LPTR(data), LP(nindptr), LP(nelem), LP(num_col_or_row),
        predict_type, start_iteration, num_iteration, matrix_type);
    PyObject* r = CallImpl("booster_predict_sparse_output", args);
    Py_XDECREF(args);
    if (!r) return -1;
    long long ip = 0, nip = 0, ix = 0, dp = 0, ne = 0;
    if (!PyArg_ParseTuple(r, "LLLLL", &ip, &nip, &ix, &dp, &ne)) {
      Py_DECREF(r);
      return -1;
    }
    Py_DECREF(r);
    *out_indptr = reinterpret_cast<int32_t*>(static_cast<intptr_t>(ip));
    *out_indices = reinterpret_cast<int32_t*>(static_cast<intptr_t>(ix));
    *out_data = reinterpret_cast<double*>(static_cast<intptr_t>(dp));
    out_len[0] = nip;
    out_len[1] = ne;
    return 0;
  });
}

// reference c_api.h:1088
int LGBMTPU_BoosterFreePredictSparse(int32_t* indptr, int32_t* indices,
                                     double* data) {
  return WithGIL([&] {
    return CallVoid("booster_free_predict_sparse",
                    Py_BuildValue("(L)", LPTR(data)));
  });
}

// reference c_api.h:451 ff — Arrow C Data Interface ingestion.  `chunks`
// is an array of ArrowArray structs, `schema` one ArrowSchema; columns
// are wrapped zero-copy over the Arrow buffers on the Python side
// (ownership moves to the library, per the C Data Interface release
// protocol).
int LGBMTPU_DatasetCreateFromArrow(int64_t n_chunks, const void* chunks,
                                   const void* schema,
                                   const char* params_json,
                                   int64_t reference, int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_from_arrow",
                   Py_BuildValue("(LLLsL)", LP(n_chunks), LPTR(chunks),
                                 LPTR(schema),
                                 params_json ? params_json : "{}",
                                 LP(reference)), out);
  });
}

int LGBMTPU_DatasetSetFieldFromArrow(int64_t dataset, const char* field,
                                     int64_t n_chunks, const void* chunks,
                                     const void* schema) {
  return WithGIL([&] {
    return CallVoid("dataset_set_field_from_arrow",
                    Py_BuildValue("(LsLLL)", LP(dataset),
                                  field ? field : "", LP(n_chunks),
                                  LPTR(chunks), LPTR(schema)));
  });
}

int LGBMTPU_BoosterPredictForArrow(int64_t booster, int64_t n_chunks,
                                   const void* chunks, const void* schema,
                                   int predict_type, int start_iteration,
                                   int num_iteration, double* out,
                                   int64_t* out_len) {
  return WithGIL([&] {
    return CallI64("booster_predict_for_arrow",
                   Py_BuildValue("(LLLLiiiLL)", LP(booster), LP(n_chunks),
                                 LPTR(chunks), LPTR(schema), predict_type,
                                 start_iteration, num_iteration, LPTR(out),
                                 LP(*out_len)), out_len);
  });
}

// reference c_api.h:145 — bin mappers from pre-sampled columns, rows
// pushed afterwards (the SWIG/streaming construction path).
int LGBMTPU_DatasetCreateFromSampledColumn(
    double** sample_data, int** sample_indices, int32_t ncol,
    const int32_t* num_per_col, int32_t num_sample_row,
    int32_t num_local_row, int64_t num_dist_row, const char* params_json,
    int64_t* out) {
  return WithGIL([&] {
    return CallI64("dataset_from_sampled_column",
                   Py_BuildValue("(LLiLiiLs)", LPTR(sample_data),
                                 LPTR(sample_indices), ncol,
                                 LPTR(num_per_col), num_sample_row,
                                 num_local_row, LP(num_dist_row),
                                 params_json ? params_json : "{}"), out);
  });
}

// reference c_api.h:363 — rows delivered by a C++ std::function callback
// (the SWIG path).  The callback is drained into CSR buffers here in C++,
// then ingested through the normal sparse path.
int LGBMTPU_DatasetCreateFromCSRFunc(void* get_row_funptr, int32_t num_rows,
                                     int64_t num_col,
                                     const char* params_json,
                                     int64_t reference, int64_t* out) {
  using RowFn = std::function<void(int, std::vector<std::pair<int, double>>&)>;
  auto* get_row = reinterpret_cast<RowFn*>(get_row_funptr);
  std::vector<int32_t> indptr{0};
  std::vector<int32_t> indices;
  std::vector<double> data;
  std::vector<std::pair<int, double>> row;
  for (int i = 0; i < num_rows; ++i) {
    row.clear();
    (*get_row)(i, row);
    for (const auto& kv : row) {
      indices.push_back(kv.first);
      data.push_back(kv.second);
    }
    indptr.push_back(static_cast<int32_t>(indices.size()));
  }
  return WithGIL([&] {
    PyObject* args = Py_BuildValue(
        "(LLLLLLLsL)", LPTR(indptr.data()), LPTR(indices.data()),
        LPTR(data.data()), LP(num_rows), LP((int64_t)data.size()),
        LP(num_col), LP(0), params_json ? params_json : "{}",
        LP(reference));
    PyObject* r = CallImpl("dataset_from_csr", args);
    Py_XDECREF(args);
    if (!r) return -1;
    *out = PyLong_AsLongLong(r);
    Py_DECREF(r);
    return 0;
  });
}

// reference c_api.h:1408 — predict over an array of row pointers.
int LGBMTPU_BoosterPredictForMats(int64_t booster, const double** data,
                                  int32_t nrow, int32_t ncol,
                                  int predict_type, int start_iteration,
                                  int num_iteration, double* out,
                                  int64_t* out_len) {
  std::vector<double> contiguous(static_cast<size_t>(nrow) * ncol);
  for (int32_t i = 0; i < nrow; ++i)
    std::memcpy(contiguous.data() + static_cast<size_t>(i) * ncol, data[i],
                sizeof(double) * ncol);
  return WithGIL([&] {
    return CallI64("booster_predict_for_mat2",
                   Py_BuildValue("(LLLLiiiLL)", LP(booster),
                                 LPTR(contiguous.data()), LP(nrow), LP(ncol),
                                 predict_type, start_iteration,
                                 num_iteration, LPTR(out), LP(*out_len)),
                   out_len);
  });
}

}  // extern "C"

/* C ABI header for lightgbm_tpu_torch (native/capi.cpp) — the counterpart
 * of the reference's include/LightGBM/c_api.h.  It declares the same
 * LGBMTPU_* functions with the same signatures as lightgbm_tpu's
 * native/capi.h (and keeps its include guard), so swig/lgbtpulib.i and the
 * R glue build against either library unchanged.  Conventions: every
 * function returns 0 on success / -1 on failure, with
 * LGBMTPU_GetLastError() holding the message (thread-local).  Handles are
 * opaque int64 ids.  tests/test_torch_capi.py holds the declarations
 * against lightgbm_tpu's header and the exports of the built library. */
#ifndef LIGHTGBM_TPU_CAPI_H_
#define LIGHTGBM_TPU_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

const char* LGBMTPU_GetLastError();
int LGBMTPU_DatasetCreateFromMat(const double* data, int64_t nrow, int64_t ncol, const double* label, const char* params_json, int64_t* out);
int LGBMTPU_DatasetSetField(int64_t dataset, const char* field, const double* vals, int64_t n);
int LGBMTPU_BoosterCreate(int64_t dataset, const char* params_json, int64_t* out);
int LGBMTPU_BoosterCreateFromModelfile(const char* path, int64_t* out);
int LGBMTPU_BoosterUpdateOneIter(int64_t booster, int* is_finished);
int LGBMTPU_BoosterPredictForMat(int64_t booster, const double* data, int64_t nrow, int64_t ncol, int raw_score, double* out, int64_t* out_len);
int LGBMTPU_BoosterSaveModel(int64_t booster, const char* path);
int LGBMTPU_BoosterNumClasses(int64_t booster, int* out);
int LGBMTPU_BoosterNumTrees(int64_t booster, int* out);
int LGBMTPU_DatasetCreateFromCSR(const int32_t* indptr, const int32_t* indices, const double* data, int64_t nrow, int64_t nnz, int64_t ncol, const double* label, const char* params_json, int64_t* out);
int LGBMTPU_DatasetInitStreaming(int64_t ncol, const char* params_json, int64_t* out);
int LGBMTPU_DatasetPushRows(int64_t dataset, const double* data, int64_t nrow, int64_t ncol, const double* label);
int LGBMTPU_DatasetMarkFinished(int64_t dataset);
int LGBMTPU_DatasetGetNumData(int64_t dataset, int64_t* out);
int LGBMTPU_DatasetGetNumFeature(int64_t dataset, int64_t* out);
int LGBMTPU_BoosterAddValidData(int64_t booster, int64_t dataset);
int LGBMTPU_BoosterGetEval(int64_t booster, int data_idx, double* out, int64_t* out_len);
int LGBMTPU_BoosterRollbackOneIter(int64_t booster);
int LGBMTPU_BoosterGetCurrentIteration(int64_t booster, int* out);
int LGBMTPU_BoosterSaveModelToString(int64_t booster, char* out, int64_t* out_len);
int LGBMTPU_FreeHandle(int64_t handle);
int LGBMTPU_DatasetCreateFromCSC(const int32_t* colptr, const int32_t* indices, const double* data, int64_t ncol, int64_t nnz, int64_t nrow, const double* label, const char* params_json, int64_t* out);
int LGBMTPU_BoosterLoadModelFromString(const char* model_str, int64_t* out);
int LGBMTPU_BoosterGetNumFeature(int64_t booster, int* out);
int LGBMTPU_BoosterGetFeatureNames(int64_t booster, char* buffer, int64_t buffer_len, int64_t* out_len);
int LGBMTPU_BoosterGetEvalNames(int64_t booster, char* buffer, int64_t buffer_len, int64_t* out_len);
int LGBMTPU_BoosterPredictForMatSingleRowFastInit(int64_t booster, int64_t ncol, int raw_score, int64_t* out_config);
int LGBMTPU_BoosterPredictForMatSingleRowFast(int64_t config, const double* row, double* out, int64_t out_capacity, int64_t* out_len);
int LGBMTPU_BoosterPredictForMat2(int64_t booster, const double* data, int64_t nrow, int64_t ncol, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);
int LGBMTPU_BoosterPredictForCSR(int64_t booster, const int32_t* indptr, const int32_t* indices, const double* data, int64_t nindptr, int64_t nelem, int64_t ncol, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);
int LGBMTPU_BoosterPredictForCSC(int64_t booster, const int32_t* colptr, const int32_t* indices, const double* data, int64_t ncolptr, int64_t nelem, int64_t nrow, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);
int LGBMTPU_BoosterPredictForFile(int64_t booster, const char* data_path, int has_header, int predict_type, int start_iteration, int num_iteration, const char* result_path);
int LGBMTPU_BoosterPredictForMatSingleRow(int64_t booster, const double* row, int64_t ncol, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);
int LGBMTPU_BoosterPredictForCSRSingleRow(int64_t booster, const int32_t* indices, const double* data, int64_t nelem, int64_t ncol, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);
int LGBMTPU_BoosterCalcNumPredict(int64_t booster, int64_t nrow, int predict_type, int start_iteration, int num_iteration, int64_t* out);
int LGBMTPU_BoosterDumpModel(int64_t booster, int num_iteration, char* out, int64_t buffer_len, int64_t* out_len);
int LGBMTPU_BoosterFeatureImportance(int64_t booster, int importance_type, double* out, int64_t* out_len);
int LGBMTPU_BoosterGetEvalCounts(int64_t booster, int* out);
int LGBMTPU_BoosterGetLeafValue(int64_t booster, int tree_idx, int leaf_idx, double* out);
int LGBMTPU_BoosterSetLeafValue(int64_t booster, int tree_idx, int leaf_idx, double value);
int LGBMTPU_BoosterGetLinear(int64_t booster, int* out);
int LGBMTPU_BoosterGetLoadedParam(int64_t booster, char* out, int64_t buffer_len, int64_t* out_len);
int LGBMTPU_BoosterGetLowerBoundValue(int64_t booster, double* out);
int LGBMTPU_BoosterGetUpperBoundValue(int64_t booster, double* out);
int LGBMTPU_BoosterGetNumPredict(int64_t booster, int data_idx, int64_t* out);
int LGBMTPU_BoosterGetPredict(int64_t booster, int data_idx, double* out, int64_t* out_len);
int LGBMTPU_BoosterMerge(int64_t booster, int64_t other);
int LGBMTPU_BoosterNumModelPerIteration(int64_t booster, int* out);
int LGBMTPU_BoosterNumberOfTotalModel(int64_t booster, int* out);
int LGBMTPU_BoosterRefit(int64_t booster, const int32_t* leaf_preds, int64_t nrow, int64_t ncol);
int LGBMTPU_BoosterResetParameter(int64_t booster, const char* params_json);
int LGBMTPU_BoosterResetTrainingData(int64_t booster, int64_t dataset);
int LGBMTPU_BoosterShuffleModels(int64_t booster, int start, int end);
int LGBMTPU_BoosterUpdateOneIterCustom(int64_t booster, const float* grad, const float* hess, int64_t n, int* is_finished);
int LGBMTPU_BoosterValidateFeatureNames(int64_t booster, const char* names_json);
int LGBMTPU_DatasetCreateFromFile(const char* path, const char* params_json, int64_t* out);
int LGBMTPU_DatasetCreateFromMats(int nmat, const double** data, const int32_t* nrows, int64_t ncol, const double* label, const char* params_json, int64_t* out);
int LGBMTPU_DatasetCreateByReference(int64_t reference, int64_t num_total_row, int64_t* out);
int LGBMTPU_DatasetSaveBinary(int64_t dataset, const char* path);
int LGBMTPU_DatasetDumpText(int64_t dataset, const char* path);
int LGBMTPU_DatasetSetFeatureNames(int64_t dataset, const char* names_json);
int LGBMTPU_DatasetGetFeatureNames(int64_t dataset, char* out, int64_t buffer_len, int64_t* out_len);
int LGBMTPU_DatasetGetFeatureNumBin(int64_t dataset, int fidx, int64_t* out);
int LGBMTPU_DatasetGetField(int64_t dataset, const char* field, double* out, int64_t* out_len);
int LGBMTPU_DatasetGetSubset(int64_t dataset, const int32_t* indices, int64_t n, const char* params_json, int64_t* out);
int LGBMTPU_DatasetAddFeaturesFrom(int64_t dataset, int64_t other);
int LGBMTPU_DatasetUpdateParamChecking(const char* old_params, const char* new_params);
int LGBMTPU_DatasetPushRowsWithMetadata(int64_t dataset, const double* data, int64_t nrow, int64_t ncol, const double* label, const double* weight, const int32_t* group, const double* init_score);
int LGBMTPU_DatasetPushRowsByCSR(int64_t dataset, const int32_t* indptr, const int32_t* indices, const double* data, int64_t nindptr, int64_t nelem, int64_t ncol, const double* label);
int LGBMTPU_DatasetPushRowsByCSRWithMetadata(int64_t dataset, const int32_t* indptr, const int32_t* indices, const double* data, int64_t nindptr, int64_t nelem, int64_t ncol, const double* label, const double* weight, const int32_t* group, const double* init_score);
int LGBMTPU_DatasetSetWaitForManualFinish(int64_t dataset, int wait);
int LGBMTPU_DatasetSerializeReferenceToBinary(int64_t dataset, int64_t* out_buffer, int64_t* out_size);
int LGBMTPU_DatasetCreateFromSerializedReference(const void* buffer, int64_t len, int64_t num_total_row, const char* params_json, int64_t* out);
int LGBMTPU_ByteBufferGetAt(int64_t handle, int64_t index, uint8_t* out);
int LGBMTPU_ByteBufferFree(int64_t handle);
int LGBMTPU_GetMaxThreads(int* out);
int LGBMTPU_SetMaxThreads(int n);
int LGBMTPU_DumpParamAliases(char* out, int64_t buffer_len, int64_t* out_len);
int LGBMTPU_GetSampleCount(int64_t nrow, const char* params_json, int64_t* out);
int LGBMTPU_SampleIndices(int64_t nrow, const char* params_json, int32_t* out, int64_t* out_len);
int LGBMTPU_NetworkInit(const char* machines, int local_listen_port, int listen_time_out, int num_machines);
int LGBMTPU_NetworkFree();
int LGBMTPU_RegisterLogCallback(void (*callback)(const char*));
int LGBMTPU_BoosterPredictForCSRSingleRowFastInit(int64_t booster, int64_t ncol, int raw_score, int64_t* out);
int LGBMTPU_BoosterPredictForCSRSingleRowFast(int64_t fast_handle, const int32_t* indices, const double* data, int64_t nelem, double* out, int64_t* out_len);
int LGBMTPU_FastConfigFree(int64_t fast_handle);
int LGBMTPU_BoosterFree(int64_t handle);
int LGBMTPU_DatasetFree(int64_t handle);
int LGBMTPU_BoosterGetNumClasses(int64_t booster, int* out);
void LGBMTPU_SetLastError(const char* msg);
int LGBMTPU_NetworkInitWithFunctions(int num_machines, int rank, void* reduce_scatter_ext_fun, void* allgather_ext_fun);
int LGBMTPU_BoosterPredictSparseOutput(int64_t booster, const int32_t* indptr, const int32_t* indices, const double* data, int64_t nindptr, int64_t nelem, int64_t num_col_or_row, int predict_type, int start_iteration, int num_iteration, int matrix_type, int64_t* out_len, int32_t** out_indptr, int32_t** out_indices, double** out_data);
int LGBMTPU_BoosterFreePredictSparse(int32_t* indptr, int32_t* indices, double* data);
int LGBMTPU_DatasetCreateFromArrow(int64_t n_chunks, const void* chunks, const void* schema, const char* params_json, int64_t reference, int64_t* out);
int LGBMTPU_DatasetSetFieldFromArrow(int64_t dataset, const char* field, int64_t n_chunks, const void* chunks, const void* schema);
int LGBMTPU_BoosterPredictForArrow(int64_t booster, int64_t n_chunks, const void* chunks, const void* schema, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);
int LGBMTPU_DatasetCreateFromSampledColumn(double** sample_data, int** sample_indices, int32_t ncol, const int32_t* num_per_col, int32_t num_sample_row, int32_t num_local_row, int64_t num_dist_row, const char* params_json, int64_t* out);
int LGBMTPU_DatasetCreateFromCSRFunc(void* get_row_funptr, int32_t num_rows, int64_t num_col, const char* params_json, int64_t reference, int64_t* out);
int LGBMTPU_BoosterPredictForMats(int64_t booster, const double** data, int32_t nrow, int32_t ncol, int predict_type, int start_iteration, int num_iteration, double* out, int64_t* out_len);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* LIGHTGBM_TPU_CAPI_H_ */

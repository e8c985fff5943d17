/* C inference ABI for paddle_tpu_torch — public header.
 *
 * Capability match for the reference C API (paddle/capi/capi.h):
 *   - dense float and integer-id inputs (capi/matrix.h, vector.h)
 *   - ragged sequence inputs via start positions
 *     (capi/arguments.h paddle_arguments_set_sequence_start_pos),
 *     including one nested level (sub-sequences)
 *   - sparse-binary / sparse-float CSR inputs
 *     (capi/matrix.h paddle_matrix_create_sparse +
 *     paddle_matrix_sparse_copy_from)
 *
 * The library embeds CPython; link nothing but -ldl and dlopen
 * libpaddle_tpu_torch_capi.so, or link against it directly. All functions are
 * thread-safe: any thread may call pt_capi_forward* concurrently after
 * pt_capi_init (calls serialize on the embedded interpreter).
 */
#ifndef PT_CAPI_H
#define PT_CAPI_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Slot kinds for pt_capi_forward_slots. */
enum {
  PT_SLOT_DENSE = 0,      /* float32 row-major, `shape` dims           */
  PT_SLOT_IDS = 1,        /* int32, `shape` dims                       */
  PT_SLOT_SEQ_IDS = 2,    /* ragged int32 ids + seq start positions    */
  PT_SLOT_SEQ_DENSE = 3,  /* ragged float32 rows + seq start positions */
  PT_SLOT_SPARSE_BINARY = 4, /* CSR, implicit 1.0 values               */
  PT_SLOT_SPARSE_FLOAT = 5   /* CSR with explicit float values         */
};

typedef struct {
  const char* name; /* data layer name */
  int kind;         /* PT_SLOT_* */

  /* PT_SLOT_DENSE / PT_SLOT_IDS: buf + shape/ndims.
   * PT_SLOT_SEQ_IDS: buf = int32[seq_pos[n_seq-1]] flat token ids.
   * PT_SLOT_SEQ_DENSE: buf = float32[seq_pos[n_seq-1] * width]. */
  const void* buf;
  const int64_t* shape;
  int ndims;

  /* Sequence slots: start positions, length n_seq (= #sequences + 1),
   * first 0, last = total timesteps — exactly the reference's
   * sequenceStartPositions. Optional `subseq_pos` adds the nested
   * level (arguments.h nestedLevel=1): positions into the same flat
   * timestep axis, refining seq_pos. */
  const int32_t* seq_pos;
  int n_seq;
  const int32_t* subseq_pos;
  int n_subseq;
  int64_t width; /* per-timestep feature width (PT_SLOT_SEQ_DENSE) */

  /* Sparse slots: CSR over [height, width]; rows has height+1 entries,
   * cols has nnz entries, vals is NULL for PT_SLOT_SPARSE_BINARY. */
  const int32_t* rows;
  const int32_t* cols;
  const float* vals;
  int64_t height;
  int64_t nnz;
} pt_capi_slot;

/* Initialize the runtime; `repo_path` (nullable) is prepended to
 * sys.path so `import paddle_tpu_torch` resolves. Returns 0 on success. */
int pt_capi_init(const char* repo_path);

/* Load a merged model; returns handle > 0, or 0 on error. */
int64_t pt_capi_create(const char* merged_path, const char* output_layer);

/* Per-example output width of the first output layer, or -1. */
int64_t pt_capi_output_dim(int64_t handle);

/* Dense-only forward (original ABI, kept stable). */
int pt_capi_forward(int64_t handle, const char** names, const void** bufs,
                    const int64_t** shapes, const int* ndims,
                    const int* is_ids, int n_inputs, float* out_buf,
                    int64_t out_cap, int64_t* out_shape);

/* Full-surface forward: sequence + sparse slots. Writes the first
 * output layer's value into out_buf (float32, row-major, capacity
 * out_cap floats) and its dims into out_shape (capacity 8); returns
 * the output rank, or -1 (see pt_capi_error). */
int pt_capi_forward_slots(int64_t handle, const pt_capi_slot* slots,
                          int n_slots, float* out_buf, int64_t out_cap,
                          int64_t* out_shape);

void pt_capi_destroy(int64_t handle);

/* Last error on this thread's view of the runtime (thread-safe). */
const char* pt_capi_error(void);

#ifdef __cplusplus
}
#endif

#endif /* PT_CAPI_H */

/* Sparse-binary inference over the C ABI: a CSR multi-hot row, the
 * reference's sparse example surface
 * (capi/examples/model_inference/sparse_binary/main.c,
 * capi/matrix.h paddle_matrix_create_sparse +
 * paddle_matrix_sparse_copy_from with NULL values).
 *
 * usage: main LIBPATH REPOPATH MERGED_MODEL OUTPUT_LAYER WIDTH
 */
#include "../common/common.h"

int main(int argc, char** argv) {
  CHECK(argc == 6);
  pt_api pt = pt_load(argv[1]);
  if (pt.init(argv[2]) != 0) {
    fprintf(stderr, "init: %s\n", pt.error());
    return 3;
  }
  int64_t h = pt.create(argv[3], argv[4]);
  if (!h) {
    fprintf(stderr, "create: %s\n", pt.error());
    return 4;
  }

  /* batch of 2 rows; row 0 has features {1, 3}, row 1 has {0, 5, 6} */
  int32_t rows[] = {0, 2, 5};
  int32_t cols[] = {1, 3, 0, 5, 6};

  pt_capi_slot s = pt_slot("x", PT_SLOT_SPARSE_BINARY);
  s.rows = rows;
  s.cols = cols;
  s.height = 2;
  s.width = atoll(argv[5]);
  s.nnz = 5;

  float out[64];
  int64_t oshape[8];
  int rank = pt.forward_slots(h, &s, 1, out, 64, oshape);
  if (rank < 0) {
    fprintf(stderr, "forward: %s\n", pt.error());
    return 5;
  }
  pt_print_output(out, oshape, rank);
  pt.destroy(h);
  return 0;
}

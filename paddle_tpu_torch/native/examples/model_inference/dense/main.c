/* Dense inference over the C ABI.
 *
 * Counterpart of reference capi/examples/model_inference/dense/main.c:
 * feed one dense float batch, print the output row-major.
 *
 * usage: main LIBPATH REPOPATH MERGED_MODEL OUTPUT_LAYER
 */
#include "../common/common.h"

int main(int argc, char** argv) {
  CHECK(argc == 5);
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

  float in[16];
  for (int i = 0; i < 16; ++i) in[i] = (float)i / 16.0f;
  int64_t shape[] = {2, 8};

  pt_capi_slot s = pt_slot("x", PT_SLOT_DENSE);
  s.buf = in;
  s.shape = shape;
  s.ndims = 2;

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

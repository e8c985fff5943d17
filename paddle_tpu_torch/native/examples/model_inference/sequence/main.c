/* Sequence inference over the C ABI: ragged integer-id input described
 * by start positions, exactly the reference's sequence example surface
 * (capi/examples/model_inference/sequence/main.c,
 * capi/arguments.h paddle_arguments_set_sequence_start_pos).
 *
 * Two sentences of different lengths in one batch: ids are flat, the
 * start-position vector {0, 5, 9} says tokens [0,5) are sentence 0 and
 * [5,9) are sentence 1.
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

  int32_t word_ids[] = {13, 8, 2, 14, 9, 7, 3, 14, 5};
  int32_t seq_pos[] = {0, 5, 9};

  pt_capi_slot s = pt_slot("words", PT_SLOT_SEQ_IDS);
  s.buf = word_ids;
  s.seq_pos = seq_pos;
  s.n_seq = 3;

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

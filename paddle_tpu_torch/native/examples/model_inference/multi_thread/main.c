/* Multi-threaded serving over the C ABI: one model handle shared by
 * several threads, each running its own forwards concurrently — the
 * reference's multi_thread example
 * (capi/examples/model_inference/multi_thread/main.c). The embedded
 * interpreter serializes marshaling; each call's buffers are
 * thread-local so no external locking is needed.
 *
 * Every thread feeds a batch derived from its thread id and checks it
 * gets the same result each iteration (catches cross-thread mixups).
 *
 * usage: main LIBPATH REPOPATH MERGED_MODEL OUTPUT_LAYER
 */
#include <pthread.h>
#include <signal.h>
#include <string.h>

#include "../common/common.h"

#define NUM_THREAD 4
#define NUM_ITER 5

static pt_api pt;
static int64_t g_h;
/* written from worker threads, read after join — keep the flag atomic
 * so the template users copy for threaded serving is race-free */
static volatile sig_atomic_t g_failed = 0;

static void* thread_main(void* arg) {
  long tid = (long)arg;
  float in[16];
  for (int i = 0; i < 16; ++i) in[i] = (float)((i + tid) % 16) / 16.0f;
  int64_t shape[] = {2, 8};

  pt_capi_slot s = pt_slot("x", PT_SLOT_DENSE);
  s.buf = in;
  s.shape = shape;
  s.ndims = 2;

  float first[64], out[64];
  int64_t oshape[8];
  for (int iter = 0; iter < NUM_ITER; ++iter) {
    int rank = pt.forward_slots(g_h, &s, 1, out, 64, oshape);
    if (rank < 0) {
      fprintf(stderr, "thread %ld: forward: %s\n", tid, pt.error());
      g_failed = 1;
      return 0;
    }
    int64_t n = 1;
    for (int d = 0; d < rank; ++d) n *= oshape[d];
    if (iter == 0) {
      memcpy(first, out, n * sizeof(float));
    } else if (memcmp(first, out, n * sizeof(float)) != 0) {
      fprintf(stderr, "thread %ld: result changed across iterations\n",
              tid);
      g_failed = 1;
      return 0;
    }
  }
  return 0;
}

int main(int argc, char** argv) {
  CHECK(argc == 5);
  pt = pt_load(argv[1]);
  if (pt.init(argv[2]) != 0) {
    fprintf(stderr, "init: %s\n", pt.error());
    return 3;
  }
  g_h = pt.create(argv[3], argv[4]);
  if (!g_h) {
    fprintf(stderr, "create: %s\n", pt.error());
    return 4;
  }
  pthread_t threads[NUM_THREAD];
  for (long i = 0; i < NUM_THREAD; ++i)
    pthread_create(&threads[i], 0, thread_main, (void*)i);
  for (int i = 0; i < NUM_THREAD; ++i) pthread_join(threads[i], 0);
  pt.destroy(g_h);
  if (g_failed) return 5;
  printf("OK\n");
  return 0;
}

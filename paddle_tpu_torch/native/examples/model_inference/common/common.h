/* Shared helpers for the model_inference examples.
 *
 * Counterpart of the reference's examples/model_inference/common/
 * common.h (the CHECK macro around paddle_error). Here the library is
 * dlopen-ed so the examples build with nothing but -ldl -lpthread; a
 * serving process may equally link libpaddle_tpu_torch_capi.so directly.
 */
#ifndef PT_EXAMPLES_COMMON_H
#define PT_EXAMPLES_COMMON_H

#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include "../../../include/pt_capi.h"

typedef struct {
  void* lib;
  int (*init)(const char*);
  int64_t (*create)(const char*, const char*);
  int64_t (*output_dim)(int64_t);
  int (*forward)(int64_t, const char**, const void**, const int64_t**,
                 const int*, const int*, int, float*, int64_t, int64_t*);
  int (*forward_slots)(int64_t, const pt_capi_slot*, int, float*, int64_t,
                       int64_t*);
  void (*destroy)(int64_t);
  const char* (*error)(void);
} pt_api;

#define CHECK(stmt)                                                    \
  do {                                                                 \
    if (!(stmt)) {                                                     \
      fprintf(stderr, "%s:%d: check failed: %s\n", __FILE__, __LINE__, \
              #stmt);                                                  \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

static pt_api pt_load(const char* libpath) {
  pt_api a;
  a.lib = dlopen(libpath, RTLD_NOW | RTLD_GLOBAL);
  if (!a.lib) {
    fprintf(stderr, "dlopen %s: %s\n", libpath, dlerror());
    exit(2);
  }
  a.init = (int (*)(const char*))dlsym(a.lib, "pt_capi_init");
  a.create = (int64_t(*)(const char*, const char*))dlsym(a.lib,
                                                         "pt_capi_create");
  a.output_dim = (int64_t(*)(int64_t))dlsym(a.lib, "pt_capi_output_dim");
  a.forward = (int (*)(int64_t, const char**, const void**,
                       const int64_t**, const int*, const int*, int,
                       float*, int64_t, int64_t*))
      dlsym(a.lib, "pt_capi_forward");
  a.forward_slots =
      (int (*)(int64_t, const pt_capi_slot*, int, float*, int64_t,
               int64_t*))dlsym(a.lib, "pt_capi_forward_slots");
  a.destroy = (void (*)(int64_t))dlsym(a.lib, "pt_capi_destroy");
  a.error = (const char* (*)(void))dlsym(a.lib, "pt_capi_error");
  CHECK(a.init && a.create && a.forward && a.forward_slots && a.destroy &&
        a.error);
  return a;
}

static void pt_print_output(const float* buf, const int64_t* shape,
                            int rank) {
  int64_t n = 1;
  for (int d = 0; d < rank; ++d) n *= shape[d];
  for (int64_t i = 0; i < n; ++i) printf("%.6f\n", buf[i]);
}

/* zero-initialized slot (every example fills only what it needs) */
static pt_capi_slot pt_slot(const char* name, int kind) {
  pt_capi_slot s;
  s.name = name;
  s.kind = kind;
  s.buf = 0;
  s.shape = 0;
  s.ndims = 0;
  s.seq_pos = 0;
  s.n_seq = 0;
  s.subseq_pos = 0;
  s.n_subseq = 0;
  s.width = 0;
  s.rows = 0;
  s.cols = 0;
  s.vals = 0;
  s.height = 0;
  s.nnz = 0;
  return s;
}

#endif /* PT_EXAMPLES_COMMON_H */

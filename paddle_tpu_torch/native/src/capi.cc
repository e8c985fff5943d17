// C inference ABI over the paddle_tpu_torch runtime.
//
// Reference surface: paddle/capi/gradient_machine.h:36-75
// (paddle_gradient_machine_create_for_inference_with_parameters,
// paddle_gradient_machine_forward) and capi/matrix.h dense buffers.
// Like the reference trainer embedding Python for config parsing
// (paddle/utils/PythonUtil.h), this library embeds CPython and defers
// marshaling to paddle_tpu_torch/capi_bridge.py; the exported surface is a
// pure C ABI a serving process can dlopen with no Python headers.
//
// Build: make -C paddle_tpu_torch/native capi   (links libpython), or
// paddle_tpu_torch.native.build_capi().

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#include "../include/pt_capi.h"

namespace {

std::mutex g_mu;
std::string g_error;
bool g_we_initialized = false;
PyThreadState* g_main_tstate = nullptr;

std::mutex g_err_mu;  // guards g_error against cross-thread get/set

void set_error(const char* what) {
  std::string msg = what ? what : "unknown error";
  if (PyErr_Occurred()) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    if (value) {
      PyObject* s = PyObject_Str(value);
      if (s) {
        const char* c = PyUnicode_AsUTF8(s);
        if (c) {
          msg += ": ";
          msg += c;
        }
        Py_DECREF(s);
      }
      // PyObject_Str or PyUnicode_AsUTF8 may have set a NEW exception;
      // never leave it pending for the next bridge call
      PyErr_Clear();
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  }
  std::lock_guard<std::mutex> lock(g_err_mu);
  g_error = std::move(msg);
}

PyObject* bridge() {
  static PyObject* mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("paddle_tpu_torch.capi_bridge");
  }
  return mod;
}

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

// Initialize the runtime. `repo_path` (may be null) is prepended to
// sys.path so `import paddle_tpu_torch` resolves. Returns 0 on success.
int pt_capi_init(const char* repo_path) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
  }
  int rc = 0;
  {
    Gil gil;
    if (repo_path && *repo_path) {
      PyObject* sys_path = PySys_GetObject("path");  // borrowed
      PyObject* p = PyUnicode_FromString(repo_path);
      if (!sys_path || !p || PyList_Insert(sys_path, 0, p) != 0) {
        Py_XDECREF(p);
        set_error("cannot extend sys.path");
        rc = -1;
      } else {
        Py_DECREF(p);
      }
    }
    if (rc == 0 && !bridge()) {
      set_error("cannot import paddle_tpu_torch.capi_bridge");
      rc = -1;
    }
  }
  // Py_InitializeEx leaves the calling thread holding the GIL; release
  // it so pt_capi_* calls from OTHER threads (the normal serving
  // pattern) can PyGILState_Ensure without deadlocking on this thread.
  if (g_we_initialized && g_main_tstate == nullptr && PyGILState_Check()) {
    g_main_tstate = PyEval_SaveThread();
  }
  return rc;
}

// Load a merged model (trainer/MergeModel.cpp analogue). Returns a
// handle > 0, or 0 on error.
int64_t pt_capi_create(const char* merged_path, const char* output_layer) {
  Gil gil;
  PyObject* m = bridge();
  if (!m) {
    set_error("runtime not initialized");
    return 0;
  }
  PyObject* r = PyObject_CallMethod(
      m, "create", "ss", merged_path, output_layer ? output_layer : "");
  if (!r) {
    set_error("create failed");
    return 0;
  }
  int64_t h = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return h;
}

// Total per-example output width of the first output layer.
int64_t pt_capi_output_dim(int64_t handle) {
  Gil gil;
  PyObject* r =
      PyObject_CallMethod(bridge(), "output_dim", "L", (long long)handle);
  if (!r) {
    set_error("output_dim failed");
    return -1;
  }
  int64_t d = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return d;
}

// Forward one batch. n_inputs parallel arrays describe the feed:
// names[i]; bufs[i] (float32 row-major, or int32 when is_ids[i]);
// shapes[i] points at ndims[i] int64 dims. The first output layer's
// value is written to out_buf (capacity out_cap floats); its shape is
// written to out_shape (capacity 8), returning the output rank, or -1.
int pt_capi_forward(int64_t handle, const char** names, const void** bufs,
                    const int64_t** shapes, const int* ndims,
                    const int* is_ids, int n_inputs, float* out_buf,
                    int64_t out_cap, int64_t* out_shape) {
  Gil gil;
  PyObject *py_names = PyList_New(n_inputs),
           *py_addrs = PyList_New(n_inputs),
           *py_shapes = PyList_New(n_inputs),
           *py_ids = PyList_New(n_inputs);
  bool alloc_ok = py_names && py_addrs && py_shapes && py_ids;
  for (int i = 0; alloc_ok && i < n_inputs; ++i) {
    PyObject* nm = PyUnicode_FromString(names[i]);
    PyObject* addr = PyLong_FromVoidPtr((void*)bufs[i]);
    PyObject* shp = PyList_New(ndims[i]);
    PyObject* ids = PyBool_FromLong(is_ids[i]);
    if (!nm || !addr || !shp || !ids) {
      Py_XDECREF(nm);
      Py_XDECREF(addr);
      Py_XDECREF(shp);
      Py_XDECREF(ids);
      alloc_ok = false;
      break;
    }
    for (int d = 0; alloc_ok && d < ndims[i]; ++d) {
      PyObject* dim = PyLong_FromLongLong(shapes[i][d]);
      if (!dim) {
        alloc_ok = false;
        break;
      }
      PyList_SetItem(shp, d, dim);
    }
    PyList_SetItem(py_names, i, nm);
    PyList_SetItem(py_addrs, i, addr);
    PyList_SetItem(py_shapes, i, shp);
    PyList_SetItem(py_ids, i, ids);
  }
  if (!alloc_ok) {
    Py_XDECREF(py_names);
    Py_XDECREF(py_addrs);
    Py_XDECREF(py_shapes);
    Py_XDECREF(py_ids);
    set_error("forward: allocation failed");
    return -1;
  }
  PyObject* r = PyObject_CallMethod(
      bridge(), "forward", "LOOOOLL", (long long)handle, py_names, py_addrs,
      py_shapes, py_ids, (long long)(intptr_t)out_buf, (long long)out_cap);
  Py_DECREF(py_names);
  Py_DECREF(py_addrs);
  Py_DECREF(py_shapes);
  Py_DECREF(py_ids);
  if (!r) {
    set_error("forward failed");
    return -1;
  }
  int rank = (int)PyList_Size(r);
  for (int d = 0; d < rank && d < 8; ++d)
    out_shape[d] = PyLong_AsLongLong(PyList_GetItem(r, d));
  Py_DECREF(r);
  return rank;
}

// Full-surface forward: sequence (ragged ids / dense rows + start
// positions, optional nested level) and sparse CSR slots — the
// reference C API's paddle_arguments_set_sequence_start_pos
// (capi/arguments.h:137) and paddle_matrix_create_sparse /
// paddle_matrix_sparse_copy_from (capi/matrix.h:52,102) surface.
// Marshaling stays in capi_bridge.forward_slots; here each slot is
// packed into a dict of addresses/sizes.
int pt_capi_forward_slots(int64_t handle, const pt_capi_slot* slots,
                          int n_slots, float* out_buf, int64_t out_cap,
                          int64_t* out_shape) {
  Gil gil;
  PyObject* py_slots = PyList_New(n_slots);
  if (!py_slots) {
    set_error("forward_slots: allocation failed");
    return -1;
  }
  bool ok = true;
  for (int i = 0; ok && i < n_slots; ++i) {
    const pt_capi_slot& s = slots[i];
    PyObject* shp = PyList_New(s.ndims > 0 ? s.ndims : 0);
    for (int d = 0; shp && d < s.ndims; ++d) {
      PyObject* dim = PyLong_FromLongLong(s.shape[d]);
      if (!dim) {
        Py_CLEAR(shp);
        break;
      }
      PyList_SetItem(shp, d, dim);
    }
    PyObject* dict =
        shp ? Py_BuildValue(
                  "{s:s, s:i, s:L, s:O, s:L, s:i, s:L, s:i, s:L, s:L, "
                  "s:L, s:L, s:L, s:L}",
                  "name", s.name ? s.name : "", "kind", s.kind, "buf",
                  (long long)(intptr_t)s.buf, "shape", shp, "seq_pos",
                  (long long)(intptr_t)s.seq_pos, "n_seq", s.n_seq,
                  "subseq_pos", (long long)(intptr_t)s.subseq_pos,
                  "n_subseq", s.n_subseq, "width", (long long)s.width,
                  "rows", (long long)(intptr_t)s.rows, "cols",
                  (long long)(intptr_t)s.cols, "vals",
                  (long long)(intptr_t)s.vals, "height",
                  (long long)s.height, "nnz", (long long)s.nnz)
            : nullptr;
    // "O" borrows shp (increfs on use), so this frame's reference is
    // released unconditionally — leak-free on failure without the
    // double-decref a "N" + manual-clear pairing risks when the dict
    // builder fails AFTER consuming the shape pair
    Py_XDECREF(shp);
    if (!dict) {
      ok = false;
      break;
    }
    PyList_SetItem(py_slots, i, dict);
  }
  if (!ok) {
    Py_DECREF(py_slots);
    set_error("forward_slots: allocation failed");
    return -1;
  }
  PyObject* r = PyObject_CallMethod(
      bridge(), "forward_slots", "LOLL", (long long)handle, py_slots,
      (long long)(intptr_t)out_buf, (long long)out_cap);
  Py_DECREF(py_slots);
  if (!r) {
    set_error("forward_slots failed");
    return -1;
  }
  int rank = (int)PyList_Size(r);
  for (int d = 0; d < rank && d < 8; ++d)
    out_shape[d] = PyLong_AsLongLong(PyList_GetItem(r, d));
  Py_DECREF(r);
  return rank;
}

void pt_capi_destroy(int64_t handle) {
  Gil gil;
  PyObject* r =
      PyObject_CallMethod(bridge(), "destroy", "L", (long long)handle);
  Py_XDECREF(r);
}

// Copies the last error into a thread-local buffer so the returned
// pointer stays valid on this thread even if another thread sets a new
// error concurrently.
const char* pt_capi_error() {
  static thread_local std::string local;
  std::lock_guard<std::mutex> lock(g_err_mu);
  local = g_error;
  return local.c_str();
}

}  // extern "C"

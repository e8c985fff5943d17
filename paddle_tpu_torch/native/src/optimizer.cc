// Standalone C-ABI optimizer library.
//
// Capability parity with the reference's paddle/optimizer/ (its C-linkage
// optimizer built for the Go pserver via cgo — optimizer/optimizer.h,
// optimizer/parameter_optimizer.cc, optimizer/serialization.h): dense
// SGD/momentum/adagrad/adadelta/rmsprop/adam with learning-rate policies
// (const / t_inv / poly) and binary state (de)serialization with CRC.
// Rebuilt from the update equations, not the reference code; the hot
// device path applies optimizers on the card (paddle_tpu_torch/optimizers/), this
// library serves the host-side runtime: checkpoint-portable optimizer
// state and host-resident (e.g. CPU-offloaded embedding) updates.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "common.h"

namespace {

enum Method { SGD, MOMENTUM, ADAGRAD, ADADELTA, RMSPROP, ADAM };
enum LrPolicy { LR_CONST, LR_T_INV, LR_POLY };

struct Optimizer {
  Method method = SGD;
  LrPolicy lr_policy = LR_CONST;
  double lr = 0.01, momentum = 0.0, eps = 1e-6, rho = 0.95;
  double beta1 = 0.9, beta2 = 0.999, decay = 0.0;
  // lr policy params: t_inv: lr/(1+a*t); poly: lr*(1+a*t)^(-b)
  double lr_a = 0.0, lr_b = 0.0;
  int64_t n = 0;
  std::vector<float> buf1, buf2;  // method-dependent state slots

  double lr_at(int64_t step) const {
    switch (lr_policy) {
      case LR_T_INV: return lr / (1.0 + lr_a * step);
      case LR_POLY: return lr * std::pow(1.0 + lr_a * step, -lr_b);
      default: return lr;
    }
  }
};

}  // namespace

extern "C" {

Optimizer* pt_optimizer_create(const char* method, int64_t n, double lr,
                               double momentum, double eps, double rho,
                               double beta1, double beta2, double decay,
                               const char* lr_policy, double lr_a,
                               double lr_b) {
  auto* o = new Optimizer();
  std::string m = method ? method : "sgd";
  if (m == "sgd") o->method = SGD;
  else if (m == "momentum") o->method = MOMENTUM;
  else if (m == "adagrad") o->method = ADAGRAD;
  else if (m == "adadelta") o->method = ADADELTA;
  else if (m == "rmsprop") o->method = RMSPROP;
  else if (m == "adam") o->method = ADAM;
  else { delete o; return nullptr; }
  std::string p = lr_policy ? lr_policy : "const";
  if (p == "const") o->lr_policy = LR_CONST;
  else if (p == "t_inv") o->lr_policy = LR_T_INV;
  else if (p == "poly") o->lr_policy = LR_POLY;
  else { delete o; return nullptr; }
  o->n = n;
  o->lr = lr; o->momentum = momentum; o->eps = eps; o->rho = rho;
  o->beta1 = beta1; o->beta2 = beta2; o->decay = decay;
  o->lr_a = lr_a; o->lr_b = lr_b;
  switch (o->method) {
    case SGD: break;
    case MOMENTUM: case ADAGRAD: o->buf1.assign(n, 0.f); break;
    case ADADELTA: case RMSPROP: case ADAM:
      o->buf1.assign(n, 0.f); o->buf2.assign(n, 0.f); break;
  }
  return o;
}

void pt_optimizer_destroy(Optimizer* o) { delete o; }

// In-place parameter update; step is the 0-based update count.
void pt_optimizer_update(Optimizer* o, float* param, const float* grad,
                         int64_t n, int64_t step) {
  if (n != o->n) return;
  const double lr = o->lr_at(step);
  switch (o->method) {
    case SGD:
      for (int64_t i = 0; i < n; i++) {
        double g = grad[i] + o->decay * param[i];
        param[i] = static_cast<float>(param[i] - lr * g);
      }
      break;
    case MOMENTUM:
      for (int64_t i = 0; i < n; i++) {
        double g = grad[i] + o->decay * param[i];
        double v = o->momentum * o->buf1[i] - lr * g;
        o->buf1[i] = static_cast<float>(v);
        param[i] = static_cast<float>(param[i] + v);
      }
      break;
    case ADAGRAD:
      for (int64_t i = 0; i < n; i++) {
        double g = grad[i] + o->decay * param[i];
        double a = o->buf1[i] + g * g;
        o->buf1[i] = static_cast<float>(a);
        param[i] = static_cast<float>(param[i] - lr * g / (std::sqrt(a) + o->eps));
      }
      break;
    case ADADELTA:
      for (int64_t i = 0; i < n; i++) {
        double g = grad[i] + o->decay * param[i];
        double acc = o->rho * o->buf1[i] + (1 - o->rho) * g * g;
        double dx = -std::sqrt((o->buf2[i] + o->eps) / (acc + o->eps)) * g;
        o->buf2[i] = static_cast<float>(o->rho * o->buf2[i] + (1 - o->rho) * dx * dx);
        o->buf1[i] = static_cast<float>(acc);
        param[i] = static_cast<float>(param[i] + lr * dx);
      }
      break;
    case RMSPROP:
      // centered variant (tracks E[g] too), matching the reference's
      // rmspropApply (math/TrainingAlgorithmOp.h)
      for (int64_t i = 0; i < n; i++) {
        double g = grad[i] + o->decay * param[i];
        double g2 = o->rho * o->buf1[i] + (1 - o->rho) * g * g;
        double g1 = o->rho * o->buf2[i] + (1 - o->rho) * g;
        o->buf1[i] = static_cast<float>(g2);
        o->buf2[i] = static_cast<float>(g1);
        param[i] = static_cast<float>(
            param[i] - lr * g / std::sqrt(g2 - g1 * g1 + o->eps));
      }
      break;
    case ADAM: {
      double t = static_cast<double>(step) + 1.0;
      double bc1 = 1.0 - std::pow(o->beta1, t);
      double bc2 = 1.0 - std::pow(o->beta2, t);
      for (int64_t i = 0; i < n; i++) {
        double g = grad[i] + o->decay * param[i];
        double m = o->beta1 * o->buf1[i] + (1 - o->beta1) * g;
        double v = o->beta2 * o->buf2[i] + (1 - o->beta2) * g * g;
        o->buf1[i] = static_cast<float>(m);
        o->buf2[i] = static_cast<float>(v);
        double mh = m / bc1, vh = v / bc2;
        param[i] = static_cast<float>(param[i] - lr * mh / (std::sqrt(vh) + o->eps));
      }
      break;
    }
  }
}

// ---- state serialization (CRC-protected, versioned) ----
// layout: magic u32 | version u32 | method u32 | n i64 | buf1 | buf2 | crc u32

static const uint32_t kMagic = 0x50544f50;  // "PTOP"

int64_t pt_optimizer_state_size(Optimizer* o) {
  return static_cast<int64_t>(4 + 4 + 4 + 8 +
                              (o->buf1.size() + o->buf2.size()) * 4 + 4);
}

int64_t pt_optimizer_get_state(Optimizer* o, char* out, int64_t cap) {
  std::string buf;
  pt::put<uint32_t>(&buf, kMagic);
  pt::put<uint32_t>(&buf, 1u);
  pt::put<uint32_t>(&buf, static_cast<uint32_t>(o->method));
  pt::put<int64_t>(&buf, o->n);
  buf.append(reinterpret_cast<const char*>(o->buf1.data()), o->buf1.size() * 4);
  buf.append(reinterpret_cast<const char*>(o->buf2.data()), o->buf2.size() * 4);
  pt::put<uint32_t>(&buf, pt::crc32(buf.data(), buf.size()));
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

int pt_optimizer_set_state(Optimizer* o, const char* data, int64_t len) {
  if (len < 24) return -1;
  uint32_t crc_stored;
  std::memcpy(&crc_stored, data + len - 4, 4);
  if (pt::crc32(data, len - 4) != crc_stored) return -2;
  const char* p = data;
  const char* end = data + len - 4;
  uint32_t magic, version, method;
  int64_t n;
  if (!pt::get(&p, end, &magic) || magic != kMagic) return -3;
  if (!pt::get(&p, end, &version) || version != 1) return -4;
  if (!pt::get(&p, end, &method) || method != static_cast<uint32_t>(o->method))
    return -5;
  if (!pt::get(&p, end, &n) || n != o->n) return -6;
  size_t want = (o->buf1.size() + o->buf2.size()) * 4;
  if (static_cast<size_t>(end - p) != want) return -7;
  std::memcpy(o->buf1.data(), p, o->buf1.size() * 4);
  std::memcpy(o->buf2.data(), p + o->buf1.size() * 4, o->buf2.size() * 4);
  return 0;
}

}  // extern "C"

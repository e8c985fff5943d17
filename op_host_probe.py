"""The kernels' custom ops: their host cost on eager, host-bound steps,
measured in one process by interleaving the op path with the path the
ops replaced.

    python3 op_host_probe.py

(on the card). Two paths run the same CUDA implementations:

- "op": the layers call the `paddle_tpu_torch::` ops, as they do;
- "direct": each op's module attribute is swapped for its CUDA
  implementation, the forward ops wrapped in an autograd Function with
  the op's own setup and backward, the way the wrappers were called
  before they were ops (an autograd Function around the kernel's
  wrapper).

The two alternate in windows (op, direct, direct, op, ...), so that the
host's drift falls on both alike; each pair of windows gives one
difference (op - direct). Measured:

1. the IMDB classifier of phase 13 (h = 256, B = 64, T = 100, adam)
   through `SGD.run_step` at K = 1, phase 18c's eager arm: windows of
   10 steps;
2. ResNet-50 fused under the bf16 flag at B = 256 (phase 9c's eager arm,
   momentum): windows of 3 steps;
3. B1 at a small shape (n = 256, 64 -> 64), where the host is the cost:
   host µs a forward + backward (B1, B2, B3) and a forward without
   gradients, windows of 200 calls, the card synchronised after each.

A step's time is the median of its window; every step ends in the
watchdog's health fetch, so the host clock holds the whole step. The
direct path counts its calls, so a step's op calls are known. Every line
lands in chiprun_out/op_host_probe.txt, the card's name and power limit
first; the last line is the summary: per path the median of the
windows, and the pairs' differences as median, quartiles and extremes.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from paddle_tpu_torch.core.config import OptimizationConf
from paddle_tpu_torch.models.image import resnet
from paddle_tpu_torch.models.text import stacked_lstm_classifier
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import bn_act_conv1x1 as fop
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.trainer.trainer import SGD

LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                   "op_host_probe.txt")
CALLS = {"n": 0}


def _direct(impl, setup=None, backward=None):
    """impl called without the dispatcher; with setup and backward, an
    autograd Function around it where gradients are enabled."""
    def counted(*args):
        CALLS["n"] += 1
        return impl(*args)
    if setup is None:
        return counted

    class Direct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            out = counted(*args)
            setup(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, *grads):
            return backward(ctx, *grads)

    def call(*args):
        if torch.is_grad_enabled() and any(
                torch.is_tensor(a) and a.requires_grad for a in args):
            return Direct.apply(*args)
        return counted(*args)

    return call


DIRECT = {
    (fop, "fwd_op"): _direct(fop.bn_act_conv1x1_fwd, fop._setup,
                             fop._backward),
    (fop, "bwd_dx_op"): _direct(fop._bwd_dx_cuda),
    (fop, "bwd_dw_op"): _direct(fop.bn_act_conv1x1_bwd_dw),
    (rnn, "lstm_fwd_op"): _direct(rnn._lstm_fwd_cuda, rnn._lstm_setup,
                                  rnn._lstm_backward),
    (rnn, "lstm_bwd_op"): _direct(rnn.lstm_seq_bwd),
    (rnn, "gru_fwd_op"): _direct(rnn.gru_seq_fwd, rnn._gru_setup,
                                 rnn._gru_backward),
    (rnn, "gru_bwd_op"): _direct(rnn.gru_seq_bwd),
}
OPS = {key: getattr(*key) for key in DIRECT}


def use(path: str) -> None:
    for (mod, name), fn in (DIRECT if path == "direct" else OPS).items():
        setattr(mod, name, fn)


def log(line: str) -> None:
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def interleave(fn, pairs: int, window: int, per: float = 1e3) -> dict:
    """Windows of `window` calls of fn, alternating the paths over
    `pairs` pairs; a window's time is its median call (`per` scales the
    seconds: ms or µs)."""
    def one(path):
        use(path)
        ts = []
        for _ in range(window):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * per)
        return statistics.median(ts)

    for path in ("op", "direct"):     # warm both
        one(path)
    got = {"op": [], "direct": []}
    for i in range(pairs):
        order = ("op", "direct") if i % 2 == 0 else ("direct", "op")
        for path in order:
            got[path].append(one(path))
    use("op")
    diff = sorted(o - d for o, d in zip(got["op"], got["direct"]))
    q = statistics.quantiles(diff, n=4)
    CALLS["n"] = 0
    use("direct")
    fn()
    use("op")
    return {"op": statistics.median(got["op"]),
            "direct": statistics.median(got["direct"]),
            "diff_median": statistics.median(diff), "diff_q1": q[0],
            "diff_q3": q[2], "diff_min": diff[0], "diff_max": diff[-1],
            "pairs": pairs, "window": window, "op_calls": CALLS["n"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("op_host_probe: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    out = {}

    cls, _nmt = cs.text_feeds(cs.SEED + 300, ragged=False)
    sgd = SGD(stacked_lstm_classifier(**cs.CLS),
              OptimizationConf(learning_method="adam",
                               learning_rate=cs.CLS_LR), device="cuda")
    for _ in range(5):
        sgd.run_step(cls)
    out["classifier_ms"] = interleave(lambda: sgd.run_step(cls), 24, 10)
    log("classifier_ms " + json.dumps(out["classifier_ms"]))
    del sgd

    cs.set_amp(True)
    sgd = SGD(resnet(50, (224, 224, 3), 1000, fused=True),
              OptimizationConf(**cs.RESNET_OPT), device="cuda")
    feed = cs.image_feed(cs.RESNET_AMP_BATCH, cs.SEED + 301)
    for _ in range(3):
        sgd.run_step(feed)
    out["resnet50_amp_ms"] = interleave(lambda: sgd.run_step(feed), 12, 3)
    log("resnet50_amp_ms " + json.dumps(out["resnet50_amp_ms"]))
    cs.set_amp(False)
    del sgd, feed
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(0)
    u, r = (torch.randn(256, 64, device="cuda", generator=g) for _ in range(2))
    sc, sh = (torch.randn(64, device="cuda", generator=g) for _ in range(2))
    w = torch.randn(64, 64, device="cuda", generator=g) * 0.1
    leaves = [x.clone().requires_grad_(True) for x in (u, sc, sh, w, r)]
    d1 = torch.randn(64, device="cuda", generator=g)

    def fwd_bwd():
        y, s1, _s2 = fop.bn_act_conv1x1(*leaves, "relu")
        torch.autograd.grad(y.sum() + (s1 * d1).sum(), leaves)

    def no_grad():
        with torch.no_grad():
            fop.bn_act_conv1x1(u, sc, sh, w, r, "relu")

    out["b1_fwd_bwd_us"] = interleave(fwd_bwd, 20, 200, per=1e6)
    out["b1_no_grad_us"] = interleave(no_grad, 20, 200, per=1e6)
    log("b1 " + json.dumps({k: out[k] for k in ("b1_fwd_bwd_us",
                                                 "b1_no_grad_us")}))
    log("summary " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

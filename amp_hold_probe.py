#!/usr/bin/env python3
"""Where can a bf16 gradient check of the fused AMP ResNet step fail?

    python3 amp_hold_probe.py            # on the card

Runs the four arms of `chip_smoke.py::amp_arms` (plain f32, plain AMP,
fused AMP, and the witness: the f32 step on bf16-rounded weights and
images) in several settings and prints, for each arm, the spread (min,
median, max over the parameters) of its gradients' distance from the
f32 step's: relative max-abs (the metric of `held_amp_step`), relative
L2, the norm ratio and the cosine.

- ResNet-50 at B = 8 and 32, the BNs on batch statistics and on running
  statistics (use_global_stats, set to the batch's own statistics);
- ResNet-50 at B = 8 under the bf16 flag, B1-B3's bf16 forms against
  their bf16 plain versions swapped in for them in the same step;
- shallow nets at ResNet-50's widths: two bottlenecks at res2's and at
  res4's widths, four at res3's;
- then `held_amp_blocks` on the tree, and in two copies of the checkout
  under a scratch directory whose B3 wrapper returns dw * 0 and dw * 2
  (each copy must fail the hold).

Every line also goes to chiprun_out/amp_hold_probe.txt.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "amp_hold_probe.txt")

MUTANT = """
import sys, torch
sys.path.insert(0, {repo!r})
import chip_smoke as m
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import bn_act_conv1x1 as fop
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
m.held_amp_blocks(torch, fop)
"""


def log(line):
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def spread(v):
    import numpy as np

    return [float(np.min(v)), float(np.median(v)), float(np.max(v))]


def metrics(fused, got, arms):
    """{arm: {metric: [min, median, max]}} of each arm's gradients (the
    new momentum) against the plain f32 step's; `arms` maps a name to
    (momentum tree, whether it is keyed by the fused graph's names)."""
    from paddle_tpu_torch.weights import fused_resnet_map

    pmap, _ = fused_resnet_map(fused)
    m32 = got["plain_f32"][1]
    out = {}
    for arm, (mom, fused_keys) in arms.items():
        v = {"maxabs": [], "l2": [], "ratio": [], "cos": []}
        for k, src in pmap.items():
            ref = m32[src]["mom"].double().flatten()
            g = mom[k if fused_keys else src]["mom"].double().flatten()
            d = g - ref
            v["maxabs"].append(float(d.abs().max() / ref.abs().max()))
            v["l2"].append(float(d.norm() / ref.norm()))
            v["ratio"].append(float(g.norm() / ref.norm()))
            v["cos"].append(float(g @ ref / (g.norm() * ref.norm())))
        out[arm] = {k: spread(x) for k, x in v.items()}
    return out


def arms_of(got):
    return {"plain_amp": (got["plain_amp"][1], False),
            "fused_amp": (got["fused_amp"][1], True),
            "witness": (got["witness_f32_rounded_inputs"][1], False)}


def on_running_stats(torch, net, params, feed):
    """`net` with every BN on running statistics, and the state holding
    this batch's own statistics."""
    from paddle_tpu_torch.network import Network

    def with_attrs(n, **attrs):
        conf = copy.deepcopy(n.conf)
        for lc in conf.layers:
            if lc.type in ("batch_norm", "fused_conv1x1_bn",
                           "fused_bottleneck_tail"):
                lc.attrs.update(attrs)
        return Network(conf)

    with torch.no_grad():
        _o, state = with_attrs(net, moving_average_fraction=0.0).forward(
            params, feed, train=True, outputs=["output"])
    return lambda n: with_attrs(n, use_global_stats=True), state


def kernels_vs_plain_versions(torch, m, op, fused, params, state, feed):
    """ResNet-50's fused step under the flag with B1-B3, against the same
    step with their bf16 plain versions in their place."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    names = {"bn_act_conv1x1_fwd": "bn_act_conv1x1_plain",
             "bn_act_conv1x1_bwd_dx": "bn_act_conv1x1_bwd_dx_plain",
             "bn_act_conv1x1_bwd_dw": "bn_act_conv1x1_bwd_dw_plain"}
    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    got = {}
    for arm in ("kernels", "plain_versions"):
        saved = {n: getattr(op, n) for n in names}
        if arm == "plain_versions":
            for n, plain in names.items():
                setattr(op, n, getattr(op, plain))
        m.set_amp(True)
        try:
            opt = create_optimizer(OptimizationConf(**m.RESNET_OPT),
                                   fused.param_confs)
            step = TrainStep(fused, opt, watchdog=True, device="cuda")
            _p, mom, _s, health, _o = step(fparams, opt.init_state(fparams),
                                           fstate, feed, 0, None)
        finally:
            m.set_amp(False)
            for n, f in saved.items():
                setattr(op, n, f)
        got[arm] = (health[0].item(), mom)
    mk, mp = got["kernels"][1], got["plain_versions"][1]
    errs = [m.rel_err(mk[k]["mom"], mp[k]["mom"])[0] for k in mk]
    return {"loss_kernels": got["kernels"][0],
            "loss_plain_versions": got["plain_versions"][0],
            "grad_maxabs": spread(errs)}


def mutant(tag, factor):
    """The two-block hold in a copy of the checkout whose B3 wrapper
    returns dw * factor: True if the hold fails there."""
    dst = os.path.join(tempfile.mkdtemp(prefix="amp_hold_probe_"), tag)
    shutil.copytree(REPO, dst, ignore=shutil.ignore_patterns(
        "_archive", "chiprun_out", ".git"))
    path = os.path.join(dst, "paddle_tpu_torch", "ops", "bn_act_conv1x1.py")
    src = open(path).read()
    old = "        bwd_dw_launches += 1\n    return dw\n"
    assert old in src, "the B3 wrapper changed: update the mutation"
    open(path, "w").write(src.replace(
        old, f"        bwd_dw_launches += 1\n    return dw * {factor}\n"))
    res = subprocess.run([sys.executable, "-c", MUTANT.format(repo=dst)],
                         capture_output=True, text=True, timeout=900)
    failed = res.returncode != 0 and "outside the bound" in res.stderr
    log(f"mutant dw * {factor}: rc {res.returncode}, the hold "
        f"{'fails' if failed else 'PASSES'}: "
        + (res.stderr.strip().splitlines() or [""])[-1][:400])
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    return failed


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("amp_hold_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as m
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.models.image import _bottleneck
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import bn_act_conv1x1 as fop

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()

    plain, fused, params, state = m.resnet_nets(torch)
    for b in (8, 32):
        feed = m.image_feed(b, m.SEED + 30)
        to_running, rstate = on_running_stats(torch, plain, params, feed)
        for kind, pn, fn, st in (
                ("batch", plain, fused, state),
                ("running", to_running(plain), to_running(fused), rstate)):
            got = m.amp_arms(torch, pn, fn, params, st, feed)
            log(f"resnet50 b{b} {kind} statistics "
                + json.dumps(metrics(fused, got, arms_of(got))))
    log("resnet50 b8 kernels vs bf16 plain versions " + json.dumps(
        kernels_vs_plain_versions(torch, m, fop, fused, params, state,
                                  m.image_feed(8, m.SEED + 30))))
    del plain, fused, params, state
    torch.cuda.empty_cache()

    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.network import Network

    for img, ch, blocks, b in (((56, 56, 256), 64, 2, 8),
                               ((28, 28, 512), 128, 4, 8),
                               ((14, 14, 1024), 256, 2, 8),
                               ((14, 14, 1024), 256, 2, 32)):
        nets = []
        for is_fused in (False, True):
            with dsl.model() as g:
                h = dsl.data("image", img)
                lbl = dsl.data("label", (1,), is_ids=True)
                for i in range(blocks):
                    h = _bottleneck(f"blk{i}", h, ch, 1, project=False,
                                    fused=is_fused)
                h = dsl.pool(h, img[0], 1, pool_type="avg")
                dsl.classification_cost(dsl.fc(h, size=1000, name="output"),
                                        lbl, name="cost")
            nets.append(Network(g.conf))
        plain, fused = nets
        params = plain.init_params(torch.Generator().manual_seed(m.SEED),
                                   device="cuda")
        rng = np.random.default_rng(m.SEED + 32)
        feed = {"image": non_seq(rng.standard_normal((b,) + img).astype(
                    np.float32), device="cuda"),
                "label": id_arg(rng.integers(0, 1000, b).astype(np.int32),
                                device="cuda")}
        got = m.amp_arms(torch, plain, fused, params,
                         plain.init_state("cuda"), feed)
        log(f"{blocks} blocks {img} ch {ch} b{b} "
            + json.dumps(metrics(fused, got, arms_of(got))))
        torch.cuda.empty_cache()

    log("held_amp_blocks passes on the tree "
        + json.dumps(m.held_amp_blocks(torch, fop)))
    ok = [mutant("zero", 0), mutant("double", 2)]
    log("both mutants fail the hold" if all(ok) else f"mutants {ok}")
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())

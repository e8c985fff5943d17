"""The new-style op set with registered grad-op builders: the JAX
package's `framework/ops.py` with each kernel a plain function of torch
tensors.

Reference: paddle/operators/*.cc — add, mul, mean, sigmoid, softmax,
onehot cross_entropy, rowwise_add, sgd, fill_zeros_like, gaussian_random,
uniform_random (35 REGISTER_OP* registrations total), gather/scatter
kernels (operators/gather.h, operators/scatter.h). Each forward op
registers a grad builder wiring @GRAD-suffixed variables exactly like
framework/grad_op_builder.cc. 24 op types, 11 of them with a gradient;
none is a Pallas kernel in the JAX package, and none needs a kernel of
its own here.

The random ops draw from a torch.Generator on the op's device (its
`device` attribute, else its scope's; None: the card), seeded from
their `seed` attribute: one seed gives one draw, but not the JAX
package's (another generator).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.framework.op import (
    GRAD_SUFFIX as G,
    OperatorBase,
    create_op,
    register_grad,
    register_op,
    set_signature,
)


def _g(name: str) -> str:
    return name + G


def _index(idx):
    return idx.to(torch.int64)


# ---------------------------------------------------------------- add
@register_op("add")
class AddOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": ins["X"] + ins["Y"]}


@register_grad("add")
def _add_grad(op):
    x, y, out = op.input("X"), op.input("Y"), op.output("Out")
    return [
        create_op("identity", {"X": _g(out)}, {"Out": _g(x)}),
        create_op(
            "reduce_to_shape_of",
            {"X": _g(out), "Like": y},
            {"Out": _g(y)},
        ),
    ]


@register_op("identity")
class IdentityOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": ins["X"]}


@register_grad("identity")
def _identity_grad(op):
    return [
        create_op(
            "identity",
            {"X": _g(op.output("Out"))},
            {"Out": _g(op.input("X"))},
        )
    ]


@register_op("reduce_to_shape_of")
class ReduceToShapeOfOp(OperatorBase):
    """Sum-reduce X over broadcast dims so it matches Like's shape
    (the unbroadcast needed by add/rowwise_add grads)."""

    def kernel(self, ins, attrs):
        x, like = ins["X"], ins["Like"]
        extra = x.dim() - like.dim()
        if extra:
            x = x.sum(dim=tuple(range(extra)))
        keep = tuple(
            i for i, (a, b) in enumerate(zip(x.shape, like.shape)) if a != b
        )
        if keep:
            x = x.sum(dim=keep, keepdim=True)
        return {"Out": x.reshape(like.shape)}


# ---------------------------------------------------------------- sum
@register_op("sum")
class SumOp(OperatorBase):
    """Accumulates a list of same-shape inputs; inserted by backward()
    for fan-out gradient accumulation (framework/backward.cc:117-140
    add op over @RENAME@ duplicates)."""

    def kernel(self, ins, attrs):
        xs = ins["X"]
        if not isinstance(xs, list):
            xs = [xs]
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return {"Out": out}


# ---------------------------------------------------------------- mul
@register_op("mul")
class MulOp(OperatorBase):
    """Matrix multiply (operators/mul_op.cc)."""

    def kernel(self, ins, attrs):
        return {"Out": ins["X"] @ ins["Y"]}


@register_grad("mul")
def _mul_grad(op):
    x, y, out = op.input("X"), op.input("Y"), op.output("Out")
    return [
        create_op("matmul_nt", {"X": _g(out), "Y": y}, {"Out": _g(x)}),
        create_op("matmul_tn", {"X": x, "Y": _g(out)}, {"Out": _g(y)}),
    ]


@register_op("matmul_nt")
class MatmulNTOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": ins["X"] @ ins["Y"].T}


@register_op("matmul_tn")
class MatmulTNOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": ins["X"].T @ ins["Y"]}


# ---------------------------------------------------------------- mean
@register_op("mean")
class MeanOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": torch.mean(ins["X"])}


@register_grad("mean")
def _mean_grad(op):
    x, out = op.input("X"), op.output("Out")
    return [
        create_op("mean_grad", {"X": x, "Out@G": _g(out)}, {"Out": _g(x)})
    ]


@register_op("mean_grad")
class MeanGradOp(OperatorBase):
    def kernel(self, ins, attrs):
        x = ins["X"]
        return {"Out": torch.broadcast_to(ins["Out@G"] / x.numel(),
                                          x.shape)}


# ---------------------------------------------------------------- scale
@register_op("scale")
class ScaleOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": ins["X"] * attrs.get("scale", 1.0)}


@register_grad("scale")
def _scale_grad(op):
    return [
        create_op(
            "scale",
            {"X": _g(op.output("Out"))},
            {"Out": _g(op.input("X"))},
            {"scale": op.attrs.get("scale", 1.0)},
        )
    ]


# ---------------------------------------------------------------- sigmoid
@register_op("sigmoid")
class SigmoidOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Y": torch.sigmoid(ins["X"])}


@register_grad("sigmoid")
def _sigmoid_grad(op):
    y = op.output("Y")
    return [
        create_op(
            "sigmoid_grad",
            {"Y": y, "Y@G": _g(y)},
            {"Out": _g(op.input("X"))},
        )
    ]


@register_op("sigmoid_grad")
class SigmoidGradOp(OperatorBase):
    def kernel(self, ins, attrs):
        y = ins["Y"]
        return {"Out": ins["Y@G"] * y * (1.0 - y)}


# ---------------------------------------------------------------- softmax
@register_op("softmax")
class SoftmaxOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Y": torch.softmax(ins["X"], dim=-1)}


@register_grad("softmax")
def _softmax_grad(op):
    y = op.output("Y")
    return [
        create_op(
            "softmax_grad",
            {"Y": y, "Y@G": _g(y)},
            {"Out": _g(op.input("X"))},
        )
    ]


@register_op("softmax_grad")
class SoftmaxGradOp(OperatorBase):
    def kernel(self, ins, attrs):
        y, dy = ins["Y"], ins["Y@G"]
        return {"Out": y * (dy - torch.sum(dy * y, dim=-1, keepdim=True))}


# ------------------------------------------------------- cross entropy
@register_op("onehot_cross_entropy")
class OnehotCrossEntropyOp(OperatorBase):
    """Y_i = -log(X[i, label_i]) (operators/cross_entropy_op.cc)."""

    def kernel(self, ins, attrs):
        x, label = ins["X"], ins["label"]
        picked = torch.take_along_dim(x, _index(label)[:, None], dim=1)[:, 0]
        return {"Y": -torch.log(torch.clamp_min(picked, 1e-20))}


@register_grad("onehot_cross_entropy")
def _xent_grad(op):
    x, label, y = op.input("X"), op.input("label"), op.output("Y")
    return [
        create_op(
            "onehot_cross_entropy_grad",
            {"X": x, "label": label, "Y@G": _g(y)},
            {"Out": _g(x)},
        )
    ]


@register_op("onehot_cross_entropy_grad")
class OnehotCrossEntropyGradOp(OperatorBase):
    def kernel(self, ins, attrs):
        x, label, dy = ins["X"], ins["label"], ins["Y@G"]
        onehot = torch.nn.functional.one_hot(
            _index(label), x.shape[1]).to(x.dtype)
        return {"Out": -onehot * (dy[:, None] / torch.clamp_min(x, 1e-20))}


# ------------------------------------------------------- rowwise add
@register_op("rowwise_add")
class RowwiseAddOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Out": ins["X"] + ins["b"]}


@register_grad("rowwise_add")
def _rowwise_add_grad(op):
    x, b, out = op.input("X"), op.input("b"), op.output("Out")
    return [
        create_op("identity", {"X": _g(out)}, {"Out": _g(x)}),
        create_op(
            "reduce_to_shape_of", {"X": _g(out), "Like": b}, {"Out": _g(b)}
        ),
    ]


# ---------------------------------------------------------------- sgd
@register_op("sgd")
class SGDOp(OperatorBase):
    """param_out = param - lr * grad (operators/sgd_op.cc)."""

    def kernel(self, ins, attrs):
        lr = attrs.get("learning_rate", 0.01)
        return {"param_out": ins["param"] - lr * ins["grad"]}


# ------------------------------------------------------ fill zeros like
@register_op("fill_zeros_like")
class FillZerosLikeOp(OperatorBase):
    def kernel(self, ins, attrs):
        return {"Dst": torch.zeros_like(ins["Src"])}


# ------------------------------------------------------- random ops
def _generator(attrs):
    """A generator on the op's device, seeded from its `seed`."""
    dev = resolve_device(attrs.get("device"))
    return dev, torch.Generator(device=dev).manual_seed(
        int(attrs.get("seed", 0)))


@register_op("gaussian_random")
class GaussianRandomOp(OperatorBase):
    def kernel(self, ins, attrs):
        dev, gen = _generator(attrs)
        x = torch.randn(tuple(attrs["dims"]), generator=gen, device=dev,
                        dtype=torch.float32)
        return {"Out": attrs.get("mean", 0.0) + attrs.get("std", 1.0) * x}


@register_op("uniform_random")
class UniformRandomOp(OperatorBase):
    def kernel(self, ins, attrs):
        dev, gen = _generator(attrs)
        lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
        x = torch.rand(tuple(attrs["dims"]), generator=gen, device=dev,
                       dtype=torch.float32)
        return {"Out": lo + (hi - lo) * x}


# ------------------------------------------------------- gather/scatter
@register_op("gather")
class GatherOp(OperatorBase):
    """Out = X[Index] rows (operators/gather.h)."""

    def kernel(self, ins, attrs):
        return {"Out": ins["X"].index_select(0, _index(ins["Index"]))}


@register_grad("gather")
def _gather_grad(op):
    x, idx, out = op.input("X"), op.input("Index"), op.output("Out")
    return [
        create_op(
            "scatter_add_like",
            {"Like": x, "Index": idx, "Updates": _g(out)},
            {"Out": _g(x)},
        )
    ]


@register_op("scatter_add_like")
class ScatterAddLikeOp(OperatorBase):
    def kernel(self, ins, attrs):
        zeros = torch.zeros_like(ins["Like"])
        return {"Out": zeros.index_add(0, _index(ins["Index"]),
                                       ins["Updates"])}


@register_op("scatter")
class ScatterOp(OperatorBase):
    """Out = Ref with Updates added at Index rows
    (operators/scatter.h ScatterUpdate)."""

    def kernel(self, ins, attrs):
        return {"Out": ins["Ref"].index_add(0, _index(ins["Index"]),
                                            ins["Updates"])}


@register_grad("scatter")
def _scatter_grad(op):
    ref, idx, upd = op.input("Ref"), op.input("Index"), op.input("Updates")
    out = op.output("Out")
    return [
        create_op("identity", {"X": _g(out)}, {"Out": _g(ref)}),
        create_op(
            "gather", {"X": _g(out), "Index": idx}, {"Out": _g(upd)}
        ),
    ]


# --------------------------------------------------- slot signatures
# OpProto declarations (framework/op_registry.h: each op's Maker names
# its input/output slots and attributes). The v2 Operator facade
# (compat/v2_framework/op.py) and the generic op-test/gradient-check
# harness build ops by slot name from these. The random ops also take
# `device`.
for _name, _sig in {
    "add": (("X", "Y"), ("Out",)),
    "identity": (("X",), ("Out",)),
    "reduce_to_shape_of": (("X", "Like"), ("Out",)),
    "sum": (("X",), ("Out",)),
    "mul": (("X", "Y"), ("Out",)),
    "matmul_nt": (("X", "Y"), ("Out",)),
    "matmul_tn": (("X", "Y"), ("Out",)),
    "mean": (("X",), ("Out",)),
    "mean_grad": (("X", "Out@G"), ("Out",)),
    "scale": (("X",), ("Out",), ("scale",)),
    "sigmoid": (("X",), ("Y",)),
    "sigmoid_grad": (("Y", "Y@G"), ("Out",)),
    "softmax": (("X",), ("Y",)),
    "softmax_grad": (("Y", "Y@G"), ("Out",)),
    "onehot_cross_entropy": (("X", "label"), ("Y",)),
    "onehot_cross_entropy_grad": (("X", "label", "Y@G"), ("Out",)),
    "rowwise_add": (("X", "b"), ("Out",)),
    "sgd": (("param", "grad"), ("param_out",), ("learning_rate",)),
    "fill_zeros_like": (("Src",), ("Dst",)),
    "gaussian_random": ((), ("Out",), ("dims", "mean", "std", "seed",
                                       "device")),
    "uniform_random": ((), ("Out",), ("dims", "min", "max", "seed",
                                      "device")),
    "gather": (("X", "Index"), ("Out",)),
    "scatter_add_like": (("Like", "Index", "Updates"), ("Out",)),
    "scatter": (("Ref", "Index", "Updates"), ("Out",)),
}.items():
    set_signature(_name, *_sig)

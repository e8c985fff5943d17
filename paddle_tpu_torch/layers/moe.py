"""The MoE layer: `paddle_tpu/layers/moe.py` on torch.

A sparsely-activated expert FFN with a load-balancing loss. The layer
emits its aux loss as the extra output `<name>@aux`, which the DSL
wires into a sum_cost (`dsl.moe`), so the trainer's multi-cost
reduction applies it. The expert weights carry a leading expert dim and
the `expert_sharded` mark on their parameter confs, which the mesh
placement reads (`parallel/sharding.py`: experts over `model`). A
mesh train step (`parallel/dp.py`) hands the layer the rank's shard of
the experts, and the layer runs expert-parallel over the `model` axis
of the step's mesh (`ops/moe.py`).
"""

from __future__ import annotations

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.mesh import MODEL_AXIS, batch_mesh, get_mesh
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops import moe as moe_ops


@LAYERS.register("moe")
class MoELayer(Layer):
    """attrs: num_experts, hidden (expert FFN width), capacity_factor,
    expert_act. size = output dim (== input dim). Params: router w0
    [D, E]; experts w_in [E, D, H], w_out [E, H, D]."""

    def build(self, in_specs):
        (s,) = in_specs
        d = s.size
        a = self.conf.attrs
        e = a["num_experts"]
        h = a.get("hidden") or 4 * d
        pcs = {
            "w0": self.weight_conf(0, (d, e)),
            "w_in": self.weight_conf(0, (e, d, h)),
            "w_out": self.weight_conf(0, (e, h, d)),
        }
        # distinct auto-names for the three slots
        pcs["w_in"].name = pcs["w0"].name + "_in"
        pcs["w_out"].name = pcs["w0"].name + "_out"
        pcs["w_in"].expert_sharded = True
        pcs["w_out"].expert_sharded = True
        # per-expert fan-in: each token multiplies ONE [D, H] slice, so
        # the std is 1/sqrt(D) (the default prod(dims[:-1]) fan-in would
        # give 1/sqrt(E*D), E times too small). A user-set std wins.
        if pcs["w_in"].initial_std is None:
            pcs["w_in"].initial_std = 1.0 / (d ** 0.5)
        if pcs["w_out"].initial_std is None:
            pcs["w_out"].initial_std = 1.0 / (h ** 0.5)
        return s, pcs

    def extra_output_specs(self):
        return {f"{self.name}@aux": Spec(dim=(1,))}

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        a = self.conf.attrs
        act = activations.get(a.get("expert_act", "relu"))
        v = x.value
        lead = v.shape[:-1]
        flat = v.reshape(-1, v.shape[-1])
        # padded tokens are excluded from routing itself (capacity and
        # balance statistics), not only masked at the output
        token_mask = x.mask(v.dtype).reshape(-1) if x.is_seq else None
        mesh = batch_mesh() or get_mesh()
        y, aux = moe_ops.moe_ffn(
            flat, params["w0"], params["w_in"], params["w_out"],
            capacity_factor=a.get("capacity_factor", 1.25),
            activation=act, token_mask=token_mask, mesh=mesh,
            axis=MODEL_AXIS)
        self._extra_outs = {
            f"{self.name}@aux": Arg(value=aux.reshape(1, 1))
        }
        return Arg(value=y.reshape(tuple(lead) + (-1,)),
                   seq_lens=x.seq_lens)

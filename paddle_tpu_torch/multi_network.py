"""MultiNetwork: several submodels trained jointly in one program.

Reference: gserver/gradientmachines/MultiNetwork.h — a GradientMachine
holding N sub-networks, forwarding each with its own in/out args and
summing their costs into one training signal (used for multi-task
setups). The submodels are merged into ONE ModelConf (layer and
parameter names prefixed per submodel, shared-parameter names left
untouched so submodels can share weights by name) and run as a single
network — the jointly-trained equivalent without a special executor.

The port of `paddle_tpu/multi_network.py` over the port's config
dataclasses (`core/config.py`): the merged conf runs as one `Network`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from paddle_tpu_torch.core.config import ModelConf


def merge_confs(
    confs: Dict[str, ModelConf],
    share_params: bool = True,
) -> ModelConf:
    """Merge named submodel configs into one ModelConf.

    Layer names become "<sub>/<layer>"; data-layer (feed) names are
    prefixed too, so each submodel keeps its own inputs. Explicit
    parameter names (user-set, e.g. shared embeddings) are preserved
    when `share_params` — identical names across submodels alias one
    parameter, exactly how MultiNetwork shares via the parameter map.
    Auto-named parameters (layer-derived "_<layer>.w0") follow their
    prefixed layer automatically.
    """
    merged = ModelConf()
    for sub, conf in confs.items():
        # referenceable names: the submodel's layers, plus every step-net
        # layer (recurrent-group secondary out_links surface under step
        # names), recursively for nested groups
        names = {lc.name for lc in conf.layers}
        stack = [
            lc.attrs["step_conf"]
            for lc in conf.layers
            if "step_conf" in lc.attrs
        ]
        while stack:
            sc = stack.pop()
            for slc in sc.layers:
                names.add(slc.name)
                if "step_conf" in slc.attrs:
                    stack.append(slc.attrs["step_conf"])

        def _ref(n):
            # extra outputs ("moe@aux") reference their producer layer
            # before the '@'; prefix whenever the base is local
            return n in names or n.split("@")[0] in names

        for lc in conf.layers:
            nlc = dataclasses.replace(
                lc,
                name=f"{sub}/{lc.name}",
                inputs=[
                    dataclasses.replace(
                        ic,
                        name=(
                            f"{sub}/{ic.name}" if _ref(ic.name) else ic.name
                        ),
                    )
                    for ic in lc.inputs
                ],
            )
            if "step_conf" in nlc.attrs:
                # recurrent groups carry layer-name references in attrs:
                # memories[].boot_layer names a PARENT layer; the step
                # net's own layer names must be prefixed too so two
                # merged submodels' auto-named step params ("_s.w0")
                # never alias
                nlc.attrs = _prefix_group_attrs(
                    sub, nlc.attrs, share_params
                )
            if not share_params:
                # privatize explicit param names per submodel
                for ic in nlc.inputs:
                    if ic.parameter is not None and ic.parameter.name:
                        ic.parameter = dataclasses.replace(
                            ic.parameter,
                            name=f"{sub}/{ic.parameter.name}",
                        )
                if nlc.bias_parameter is not None and nlc.bias_parameter.name:
                    nlc.bias_parameter = dataclasses.replace(
                        nlc.bias_parameter,
                        name=f"{sub}/{nlc.bias_parameter.name}",
                    )
            merged.layers.append(nlc)
        merged.input_layer_names.extend(
            f"{sub}/{n}" for n in conf.input_layer_names
        )
        merged.output_layer_names.extend(
            f"{sub}/{n}" for n in conf.output_layer_names
        )
    return merged


def _prefix_group_attrs(sub: str, attrs: dict, share_params: bool) -> dict:
    """Prefix the layer-name references inside a recurrent_group's attrs
    (layers/recurrent_group.py:19-27): step_conf layer names +
    in/static/out_links + memories' step-side "layer"/"link" get the
    submodel prefix; memories' parent-side "boot_layer" gets it too
    (the parent layer itself was just renamed)."""
    a = dict(attrs)
    p = lambda n: f"{sub}/{n}" if n else n
    step: ModelConf = a["step_conf"]
    new_step = ModelConf()
    for lc in step.layers:
        nlc = dataclasses.replace(
            lc,
            name=p(lc.name),
            inputs=[
                dataclasses.replace(ic, name=p(ic.name))
                for ic in lc.inputs
            ],
        )
        if "step_conf" in nlc.attrs:  # nested recurrent group
            nlc.attrs = _prefix_group_attrs(sub, nlc.attrs, share_params)
        if not share_params:
            for ic in nlc.inputs:
                if ic.parameter is not None and ic.parameter.name:
                    ic.parameter = dataclasses.replace(
                        ic.parameter, name=p(ic.parameter.name)
                    )
            if nlc.bias_parameter is not None and nlc.bias_parameter.name:
                nlc.bias_parameter = dataclasses.replace(
                    nlc.bias_parameter, name=p(nlc.bias_parameter.name)
                )
        new_step.layers.append(nlc)
    a["step_conf"] = new_step
    a["in_links"] = [p(n) for n in a.get("in_links", [])]
    a["static_links"] = [p(n) for n in a.get("static_links", [])]
    a["out_links"] = [p(n) for n in a.get("out_links", [])]
    a["memories"] = [
        {
            **m,
            "layer": p(m.get("layer")),
            "link": p(m.get("link")),
            "boot_layer": p(m.get("boot_layer")),
        }
        for m in a.get("memories", [])
    ]
    return a


def prefix_feed(sub: str, feed: dict) -> dict:
    """Rewrite a submodel's feed dict to merged names."""
    return {f"{sub}/{k}": v for k, v in feed.items()}

"""v1 API compatibility: run 2017-era config files — the JAX package's
`compat` front end for the port.

`layers_v1` exposes the trainer_config_helpers naming
(`fc_layer(input=..., size=...)` keyword style) over the port's DSL,
`layer_math` the arithmetic on layer handles, `raw_config` the raw
Layer / Projection / RecurrentLayerGroup surface, and
`config_parser.parse_config` execs an unmodified v1 config file
(`v1_namespace/` holds the modules its `paddle.*` imports resolve to).

Left out, still to port (ROADMAP A12): `swig_api.py` and `py2run.py`.
"""

from paddle_tpu_torch.compat import layers_v1  # noqa: F401

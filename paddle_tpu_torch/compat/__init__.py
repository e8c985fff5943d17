"""v1 API compatibility: run 2017-era config files — the JAX package's
`compat` front end for the port.

`layers_v1` exposes the trainer_config_helpers naming
(`fc_layer(input=..., size=...)` keyword style) over the port's DSL,
`layer_math` the arithmetic on layer handles, `raw_config` the raw
Layer / Projection / RecurrentLayerGroup surface, and
`config_parser.parse_config` execs an unmodified v1 config file
(`v1_namespace/` holds the modules its `paddle.*` imports resolve to).
`swig_api` is the `py_paddle.swig_paddle` surface (GradientMachine,
ParameterUpdater, Trainer, Arguments, ... on the card), `py_paddle/`
the namespace a py2-era API driver's `from py_paddle import ...`
resolves to, and `py2run.run_py2_script` runs such a driver unmodified.
"""

from paddle_tpu_torch.compat import layers_v1  # noqa: F401

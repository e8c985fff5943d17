"""The modules a v1 config's and a v1 provider's `paddle.*` imports
resolve to under the port's `compat.config_parser` (its `v1_builtins`):
`paddle.trainer_config_helpers` -> `trainer_config_helpers`,
`paddle.trainer.PyDataProvider2` -> `PyDataProvider2`,
`paddle.trainer.config_parser` -> `config_parser`. They are the
repo-root `paddle` package's modules of those names, on the port.
"""

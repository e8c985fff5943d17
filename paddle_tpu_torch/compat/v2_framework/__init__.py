"""The port's `paddle.v2.framework`: the new-op-framework namespace.

The repo-root `paddle/v2/framework/` package on the port's engine,
`paddle_tpu_torch.framework` (torch op kernels over Scopes). It
reproduces the reference's user-facing module layout
(python/paddle/v2/framework/__init__.py: the `core` module, the
Operator factory in `op.py`, `default_scope_funcs`), with the generic
test harness (`gradient_checker`, `op_test_util`, `tests/`) that
reference op tests import. A v1 source exec'd with
`compat.config_parser.v1_builtins` imports these modules under their
`paddle.v2.framework.*` names, as `compat/v1_namespace/` serves
`paddle.trainer_config_helpers`.
"""

from paddle_tpu_torch.compat.v2_framework import (  # noqa: F401
    core,
    default_scope_funcs,
    gradient_checker,
    op,
    op_test_util,
    tests,
)

__all__ = ["core", "op", "default_scope_funcs"]

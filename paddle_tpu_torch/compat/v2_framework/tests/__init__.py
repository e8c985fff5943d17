"""Reference import location for the op-test harness
(python/paddle/v2/framework/tests/), on the port: re-exports the
reusable modules so `from paddle.v2.framework.tests import
gradient_checker` and reference-style `from
paddle.v2.framework.tests.op_test_util import OpTestMeta` both
resolve."""

from paddle_tpu_torch.compat.v2_framework import (  # noqa: F401
    gradient_checker,
    op_test_util,
)

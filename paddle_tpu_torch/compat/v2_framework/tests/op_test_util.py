from paddle_tpu_torch.compat.v2_framework.op_test_util import (  # noqa
    OpTestMeta,
)

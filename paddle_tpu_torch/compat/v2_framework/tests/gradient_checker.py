from paddle_tpu_torch.compat.v2_framework.gradient_checker import (  # noqa
    GradientChecker,
    create_op,
    get_numeric_gradient,
    grad_var_name,
)

__all__ = ["get_numeric_gradient", "GradientChecker", "create_op",
           "grad_var_name"]

"""`py_paddle.swig_paddle` — the reference SWIG module name
(paddle/api/Paddle.i:1), backed by paddle_tpu_torch.compat.swig_api.
"""

from paddle_tpu_torch.compat.swig_api import *  # noqa: F401,F403
from paddle_tpu_torch.compat.swig_api import (  # noqa: F401
    Arguments,
    GradientMachine,
    IVector,
    Matrix,
    Parameter,
    ParameterBuffer,
    Trainer,
    Vector,
    initPaddle,
    isGpuVersion,
    isUsingGpu,
    setUseGpu,
)

"""`paddle.trainer_config_helpers` for the port: the star-import
authoring surface of the reference's v1 config helpers
(python/paddle/trainer_config_helpers/{layers,networks,optimizers,
attrs,poolings,activations}.py), backed by paddle_tpu_torch.compat.
"""

from paddle_tpu_torch.compat.config_parser import *  # noqa: F401,F403
from paddle_tpu_torch.compat.layers_v1 import *  # noqa: F401,F403
from paddle_tpu_torch.compat import layer_math  # noqa: F401  (patches LayerRef ops)

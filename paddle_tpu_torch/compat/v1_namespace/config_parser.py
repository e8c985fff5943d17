"""`paddle.trainer.config_parser` for the port: the reference's
parse_config entry point (python/paddle/trainer/config_parser.py:3724)
backed by paddle_tpu_torch.compat.config_parser.
"""

import logging

from paddle_tpu_torch.compat.config_parser import (  # noqa: F401
    get_config_arg,
    parse_config,
)


def parse_config_and_serialize(trainer_config, config_arg_str=""):
    """Reference config_parser.py:3756 — parse + SerializeToString."""
    return parse_config(trainer_config, config_arg_str).SerializeToString()


# the reference module's logger the api demo drivers import
# (v1_api_demo/vae/vae_train.py:23)
logger = logging.getLogger("paddle_tpu_torch.config_parser")

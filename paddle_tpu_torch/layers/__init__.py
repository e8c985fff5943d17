"""Layer library. Importing this package registers the ported layer
types (the port's own LAYERS registry, core/registry.py)."""

from paddle_tpu_torch.layers import (  # noqa: F401
    attention,
    base,
    basic,
    cost,
)

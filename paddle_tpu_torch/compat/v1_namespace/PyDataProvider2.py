"""`paddle.trainer.PyDataProvider2` for the port: the data-provider
declaration API reference providers star-import (python/paddle/trainer/
PyDataProvider2.py:39-329), backed by paddle_tpu_torch.data.
"""

from paddle_tpu_torch.data.feeder import (  # noqa: F401
    InputType,
    dense_vector,
    dense_vector_sequence,
    integer_value,
    integer_value_sequence,
    integer_value_sub_sequence,
    sparse_binary_vector,
    sparse_float_vector,
)
from paddle_tpu_torch.data.provider import CacheType, provider  # noqa: F401


class DataType:
    """Slot kind enum (reference PyDataProvider2.py:32)."""

    Dense = 0
    SparseNonValue = 1
    SparseValue = 2
    Index = 3


class SequenceType:
    """Sequence level enum (reference PyDataProvider2.py:25)."""

    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


# older alias used by some reference providers
sparse_vector = sparse_float_vector


def sparse_binary_vector_sequence(dim):
    return sparse_binary_vector(dim, seq_type=1)


def sparse_vector_sequence(dim):
    return sparse_float_vector(dim, seq_type=1)
integer_sequence = integer_value_sequence

"""DataProviderConverter — python sample tuples -> Arguments, on the
port (`py_paddle/dataprovider_converter.py` of the repo root for the
JAX package).

Reference: paddle/py_paddle/dataprovider_converter.py (scanners per
input type building Matrix/IVector slots with sequence start
positions). Here each slot column is packed by the port's DataFeeder
into a dense Arg of CPU tensors (ragged -> [B, T_bucket] + lengths),
which Arguments carries natively; the machine moves it to its device.
"""

from __future__ import annotations

from paddle_tpu_torch.compat.swig_api import Arguments
from paddle_tpu_torch.data.feeder import DataFeeder, InputType

__all__ = ["DataProviderConverter"]


class DataProviderConverter:
    def __init__(self, input_types):
        for t in input_types:
            if not isinstance(t, InputType):
                raise TypeError(f"expected InputType, got {type(t)!r}")
        self.input_types = list(input_types)
        self._feeder = DataFeeder(
            {i: i for i in range(len(input_types))},
            {i: t for i, t in enumerate(input_types)},
        )

    def convert(self, dat, argument=None):
        batch = [tuple(sample) for sample in dat]
        cols = self._feeder(batch)
        args = argument if argument is not None else Arguments.createArguments(
            len(self.input_types)
        )
        args.resize(len(self.input_types))
        for i in range(len(self.input_types)):
            args._setSlotArg(i, cols[i])
        return args

    def __call__(self, dat, argument=None):
        return self.convert(dat, argument)

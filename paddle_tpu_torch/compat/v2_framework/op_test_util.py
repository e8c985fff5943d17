"""OpTestMeta — declarative per-op forward tests, on the port.

Reference: python/paddle/v2/framework/tests/op_test_util.py — a
metaclass injecting `test_all` into a TestCase: the subclass declares
`self.type`, `self.inputs`, `self.outputs` (and optionally
`self.attrs`) in setUp; test_all builds the op by slot name, runs it
in a fresh scope at every place (the CPU, and the card where there is
one, as the reference's CPUPlace / GPUPlace arms), and compares every
declared output.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.compat.v2_framework import core
from paddle_tpu_torch.compat.v2_framework.op import Operator

__all__ = ["OpTestMeta"]


class OpTestMeta(type):
    def __new__(cls, name, bases, attrs):
        obj = super().__new__(cls, name, bases, attrs)

        def run_at(self, place):
            scope = core.Scope(device=place.device)
            kwargs = {}
            for in_name in Operator.get_op_input_names(self.type):
                if hasattr(self, "inputs") and in_name in self.inputs:
                    kwargs[in_name] = in_name
                    scope.set(in_name, np.asarray(self.inputs[in_name]))
            for out_name in Operator.get_op_output_names(self.type):
                if not hasattr(self, "outputs"):
                    raise ValueError("the test op must set self.outputs")
                if out_name not in self.outputs:
                    raise ValueError(
                        f"{out_name} is not in self.outputs"
                    )
                kwargs[out_name] = out_name
            for attr_name in Operator.get_op_attr_names(self.type):
                if hasattr(self, "attrs") and attr_name in self.attrs:
                    kwargs[attr_name] = self.attrs[attr_name]

            op = Operator(self.type, **kwargs)
            op.run(scope)

            for out_name in Operator.get_op_output_names(self.type):
                actual = scope.get(out_name).cpu().numpy()
                expect = np.asarray(self.outputs[out_name])
                np.testing.assert_allclose(
                    actual, expect, rtol=1e-4, atol=1e-5,
                    err_msg=f"output {out_name} has diff at {place}",
                )

        def test_all(self):
            places = [core.CPUPlace()]
            if core.is_compile_gpu():
                places.append(core.GPUPlace(0))
            for place in places:
                run_at(self, place)

        obj.test_all = test_all
        return obj

"""The port's `py_paddle` import namespace — the counterpart of the
repo-root `py_paddle/` shim (which imports the JAX package).

Reference: paddle/py_paddle/__init__.py — exports the SWIG module
`swig_paddle` plus DataProviderConverter. A py2-era API driver run
through `compat/py2run.py::run_py2_script` (or a v1 config exec'd by
`compat/config_parser.py`) resolves `from py_paddle import swig_paddle`
here through its exec namespace's `__builtins__`
(`config_parser.v1_builtins`); nothing is registered under the name
`py_paddle` in `sys.modules`.
"""

from paddle_tpu_torch.compat.py_paddle import swig_paddle  # noqa: F401
from paddle_tpu_torch.compat.py_paddle.dataprovider_converter import (  # noqa: F401,E501
    DataProviderConverter,
)

__all__ = ["swig_paddle", "DataProviderConverter"]

"""Operations and bytes, counted from the shapes of what was asked, never
from a kernel's tiling: the same work reads the same whatever implements
it.  A matrix product counts twice its multiply-adds; attention's two
products count over the positions each query sees.  Bytes count each input
read once and each output written once, at the dtypes the program passes.

``kernels.py`` counts one launch of each kernel; a family module
(``counts/<family>.py``) gives a model's operations in a join or a decode
step (``join_flops``, ``step_flops``) and the kernel launches each makes
(``join_launches``, ``step_launches``: kernel -> list of (flops, bytes)).
Only the rows of the requests count, not a bucket's padding.
"""
import importlib


def family(name: str):
    return importlib.import_module(f"{__name__}.{name}")

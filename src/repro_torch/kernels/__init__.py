"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package (`repro.kernels`):

  agg/   staleness-weighted buffered aggregation (paper eq. 4), CUDA C++

Each kernel package holds its CUDA source (`csrc/`), a wrapper
(`kernel.py`) that checks its inputs and launches on PyTorch's current
stream, the plain PyTorch version (`ref.py`) that CPU tensors go to, and
the public functions (`ops.py`). A CUDA tensor always goes to the kernel,
or the wrapper raises.

`launch_counts` counts kernel launches by name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels (`launch_counts.clear()` resets them).
"""
from collections import Counter

launch_counts: Counter = Counter()

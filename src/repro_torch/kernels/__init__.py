"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package (`repro.kernels`):

  agg/              staleness-weighted buffered aggregation (paper
                    eq. 4), CUDA C++
  rmsnorm/          RMSNorm over the model dim, forward and backward,
                    CUDA C++
  flash_attention/  causal / sliding-window flash attention with GQA,
                    forward and backward, CUDA C++ (bf16 at hd 64 and 128
                    on the tensor cores, both directions)

Each kernel package holds its CUDA source (`csrc/`), a wrapper
(`kernel.py`) that checks its inputs and launches on PyTorch's current
stream, the plain PyTorch version (`ref.py`) that CPU tensors go to, and
the public functions (`ops.py`, an autograd function where the client
update differentiates through the kernel). A CUDA tensor always goes to
the kernel, or the wrapper raises.

`launch_counts` counts launches by kernel entry point
(`weighted_aggregate`, `rmsnorm`, `rmsnorm_bwd`, `flash_attention`,
`flash_attention_bwd`; `flash_attention_tc` and `flash_attention_bwd_tc`
count, among the `flash_attention` and `flash_attention_bwd` launches,
those of the tensor-core forward and backward): each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels (`launch_counts.clear()`
resets them).
"""
from collections import Counter

launch_counts: Counter = Counter()

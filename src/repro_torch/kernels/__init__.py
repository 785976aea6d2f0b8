"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package (`repro.kernels`):

  agg/              staleness-weighted buffered aggregation (paper
                    eq. 4), CUDA C++
  rmsnorm/          RMSNorm over the model dim, forward and backward,
                    CUDA C++
  flash_attention/  causal / sliding-window flash attention with GQA,
                    forward and backward, CUDA C++ (bf16 at hd 64 and 128
                    on the tensor cores, both directions; bf16 at padded
                    hd 256 on the tensor cores, both directions, the
                    forward split over keys at decode; short sequences
                    on their own CUDA-core kernels)

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
those of the tensor-core forward and backward, and
`flash_attention_short` and `flash_attention_bwd_short` those of the
short-sequence kernels, `flash_attention_tc256` and
`flash_attention_bwd_tc256` those of the hd-256 tensor-core forward and
backward, and `flash_attention_combine` the combines of the forward's
split calls): each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels (`launch_counts.clear()`
resets them).

A call on the meta device (the dry run's: shapes, no memory) launches
nothing. It returns empty meta outputs of the kernel's shapes and dtypes
and adds its work to `meta_counts`, keyed (kernel entry point, "calls" |
"bytes" | "flops"), by the formulas of `cost.py`; `launch_counts` stays
as it was.
"""
from collections import Counter

launch_counts: Counter = Counter()
meta_counts: Counter = Counter()

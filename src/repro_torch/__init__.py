"""PyTorch/CUDA port of the FedSpace reproduction (`repro`, the JAX
package, stays the reference it is tested against).

Module paths mirror the JAX package's (`repro_torch.fl.api` is the
counterpart of `repro.fl.api`, and so on). Entry points run on a CUDA
device unless the caller passes ``device="cpu"``; there is no silent CPU
fallback. The JAX package's three Pallas kernels are hand-written CUDA
C++ for sm_90a here (`repro_torch.kernels`: the eq.-4 aggregation, and
RMSNorm and flash attention, forward and backward, for the transformer
payload).
"""

"""Flash-attention kernel with GQA, forward and backward (CUDA C++ for
sm_90a), with its wrapper, plain PyTorch version and public autograd
functions."""

"""Eq.-4 aggregation kernel (CUDA C++ for sm_90a) with its wrapper, plain
PyTorch version and public flat/tree functions."""

"""Compute core of the port: the coarse stage, the fine stage, and the three
hand-written CUDA kernels with their plain PyTorch versions
(``cuda_coarse``: K1 emission, ``cuda_fine``: K2 select, ``cuda_attr``: K3f
attribute merge).  Importing builds nothing: each kernel is compiled at its
first launch."""

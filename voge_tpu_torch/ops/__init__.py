"""Compute core of the port: the coarse stage, the fine stage and its
backward, and the hand-written CUDA kernels with their plain PyTorch versions
(``cuda_coarse``: K1 emission, ``cuda_fine``: K2 select and its global
entry, ``cuda_fine_bwd``: K3 fine backward and its global entry and the
weight fold, ``cuda_attr``: K3f attribute merge and K4b its backward).  Importing builds nothing: each kernel is compiled at its
first launch."""

"""The port's kernels: CUDA sources in ``repro_torch/csrc``, built with nvcc
at first use (``cuda_lib``), with a plain PyTorch version beside each."""

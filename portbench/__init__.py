"""The benchmark of the PyTorch and CUDA port (tpu_debruijn_torch); see README.md."""

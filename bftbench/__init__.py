"""A benchmark of the PyTorch and CUDA port, `tendermint_tpu_torch`."""

"""tendermint-tpu on PyTorch and CUDA: the BFT state-machine-replication
framework's port to the NVIDIA H100."""

__version__ = "0.1.0"

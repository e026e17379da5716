"""The hand-written Hopper kernels of the main path, their plain PyTorch
versions, and the ``repro.kernels.ops`` counterparts that wrap them."""

"""Power ops: plain PyTorch versions (``power``) and CUDA kernel bindings
(``cuda_power``). Importing them touches no CUDA state."""

"""Hand-written CUDA kernels for Hopper, their plain torch versions and oracles
(port of repro.kernels)."""

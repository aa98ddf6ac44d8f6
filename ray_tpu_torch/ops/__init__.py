"""Device ops: attention (flash and paged-decode kernels), RoPE, norms."""

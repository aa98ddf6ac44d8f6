"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu's device code.

The JAX package `ray_tpu` stays the reference.  This package mirrors its
paths (`ray_tpu/ops/paged_attention.py` ->
`ray_tpu_torch/ops/paged_attention.py`), imports torch and numpy only,
and replaces every Pallas kernel on a ported path with a CUDA C++ kernel
for Hopper (`csrc/`, built at first use by `_kernels.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; on
the CPU each kernel wrapper takes its plain PyTorch version.
"""

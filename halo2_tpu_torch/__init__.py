"""halo2_tpu_torch: the PyTorch and CUDA port of halo2_tpu for one NVIDIA H100.

Mirrors halo2_tpu's module layout and names. Bulk field arithmetic is plain
torch on limb tensors; the constant-geometry NTT level and the three stages
of the bucket MSM are hand-written CUDA kernels (`csrc/`), built with nvcc
for sm_90a at first use. Entry points run on CUDA unless the caller asks for
the CPU (`ParamsIPA.cached(curve, k, device="cpu")`), where each kernel's
plain torch version runs instead.

This package imports neither jax nor halo2_tpu.
"""

__version__ = "0.1.0"

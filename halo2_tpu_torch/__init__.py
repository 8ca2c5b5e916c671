"""halo2_tpu_torch: the PyTorch and CUDA port of halo2_tpu for one NVIDIA H100.

Mirrors halo2_tpu's module layout and names. Bulk field arithmetic is plain
torch on limb tensors; each Pallas kernel of halo2_tpu (the two NTT levels,
the bucket and sorted-bucket MSM stages, the profiling tool's tile
arithmetic) is a hand-written CUDA kernel (`csrc/`), built with nvcc for
sm_90a at first use. Entry points run on CUDA unless the caller asks for
the CPU (`ParamsIPA.cached(curve, k, device="cpu")`), where each kernel's
plain torch version runs instead.

This package imports neither jax nor halo2_tpu.
"""

__version__ = "0.1.0"

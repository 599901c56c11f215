"""barcode_tpu_torch — the PyTorch / CUDA port of barcode_tpu.

HMC inference of cosmic density fields (the capabilities of egpbos/barcode),
written for an NVIDIA H100: plain tensor code is PyTorch, and each kernel
that the JAX package wrote in Pallas for the TPU is a CUDA C++ kernel written
for Hopper (`csrc/`, built at first use by `cuda_build`).

The JAX package `barcode_tpu` is the reference: every module here mirrors
its twin's public functions, and the tests hold the two against each other
on the CPU.  This package imports neither `jax` nor `barcode_tpu`.

Layout differences from the JAX package:
  * chains are a leading batch dimension written out (JAX vmaps them);
  * randomness comes from an explicit `torch.Generator`;
  * entry points take `device=`, default "cuda", and raise when no card is
    present unless the caller asked for the CPU.
"""

__version__ = "0.1.0"

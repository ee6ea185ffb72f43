"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper.

The package mirrors `repro`'s subpackages and module names so that every
ported function sits where its JAX counterpart does.  It imports torch,
numpy and the standard library only; the JAX package is its reference
and is never imported here.  Entry points take an explicit `device`
(default "cuda"); the kernel wrappers in `kernels/` take their plain
PyTorch version only for tensors that lie on the CPU.
"""

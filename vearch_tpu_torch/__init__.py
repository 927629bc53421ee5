"""PyTorch/CUDA port of vearch_tpu, held against it as the reference.

The package mirrors vearch_tpu's layout (ops/, engine/, index/, scalar/,
cluster/, sdk/) and imports nothing of it, nor of JAX. Hand-written Hopper kernels live
under csrc/ and are built with nvcc at first use into _build/.
"""

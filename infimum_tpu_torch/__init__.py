"""infimum_tpu_torch: the Groth16/MACI prover of `infimum_tpu`, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package `infimum_tpu` stays the reference. This package imports
nothing of it and nothing of JAX: it keeps its own copies of the pure-Python
host layers (circuits, witness, poll state, trees, serialization, the
native library's bindings), each marked with the module it was copied from,
and brings its own field, curve, NTT, row-evaluation, fixed-base, MSM,
Poseidon and Groth16 modules. The three Pallas kernels of the reference (the
MSM accumulation and weighted reduction, the Poseidon permutation) are CUDA
C++ kernels here (`csrc/`, built and bound by `kernels.py`). Entry points
run on the card (`device="cuda"`) unless the caller asks for the CPU.
"""

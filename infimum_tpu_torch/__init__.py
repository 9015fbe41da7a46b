"""infimum_tpu_torch: the Groth16/MACI prover of `infimum_tpu`, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package `infimum_tpu` stays the reference. This package imports none
of JAX: it reuses the reference's pure-Python host layers (circuits, witness,
poll state, serialization, native pairing) through `_reference`, and brings
its own field, curve, NTT, row-evaluation, fixed-base, MSM and Groth16
modules. The two Pallas MSM kernels of `infimum_tpu/msm/pallas_msm.py` are
CUDA C++ kernels here (`csrc/`, built and bound by `kernels.py`).
"""

from . import _reference  # noqa: F401  (registers the bare infimum_tpu.ff)

"""kwave_tpu — a JAX k-Wave fluid framework.

Brand-new JAX/XLA implementation of the capabilities of kspaceFirstOrder-CUDA v1.3
(reference: klepo/k-Wave-Fluid-CUDA): the k-space pseudospectral acoustic solver, the
sample-and-compress output-stream path, and the on-the-fly lossless-roundtrip compression codec
(windowed complex-exponential harmonic coefficients, 40-bit packing). It runs on a GPU (cuFFT
plus XLA-fused elementwise code) and, for tests, on the CPU.

See DESIGN.md for the architecture and SURVEY.md for the reference layer map.
"""

__version__ = "0.1.0"

from kwave_tpu.basis import CompressionBasis, find_period, generate_basis  # noqa: F401

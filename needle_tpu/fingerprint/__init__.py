"""Chromaprint-compatible audio fingerprinting.

The reference fingerprints audio via the chromaprint C++ library
(needle/src/audio/analyzer.rs:176-311). Here the same algorithm
(CHROMAPRINT_ALGORITHM_TEST2, chromaprint v1.5.x) is implemented from scratch:

  * :mod:`needle_tpu.fingerprint.constants` — algorithm constants (frame size,
    chroma mapping, trained classifier filters + quantizer thresholds).
  * :mod:`needle_tpu.fingerprint.numpy_impl` — NumPy reference implementation
    (validation oracle for the device path).
  * :mod:`needle_tpu.fingerprint.jax_impl` — batched JAX/XLA pipeline
    (framing -> Hamming window -> DFT-as-matmul -> chroma fold ->
    chroma filter -> normalize -> classifier matmul -> gray-code bit packing).
  * :mod:`needle_tpu.fingerprint.oracle` — ctypes binding to a system
    libchromaprint (if present) used in tests to generate golden hashes.
"""

from .constants import (
    SAMPLE_RATE,
    FRAME_SIZE,
    FRAME_OVERLAP,
    HOP_SIZE,
    DELAY_SAMPLES,
    ITEM_DURATION_SAMPLES,
    NUM_BANDS,
)
from .numpy_impl import fingerprint_numpy, num_subfingerprints

__all__ = [
    "SAMPLE_RATE",
    "FRAME_SIZE",
    "FRAME_OVERLAP",
    "HOP_SIZE",
    "DELAY_SAMPLES",
    "ITEM_DURATION_SAMPLES",
    "NUM_BANDS",
    "fingerprint_numpy",
    "num_subfingerprints",
]

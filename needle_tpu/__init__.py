"""needle-tpu: a JAX framework for finding openings ("needles") and endings in
TV/anime episodes ("haystacks") using audio fingerprints.

Built from scratch in JAX/XLA/Pallas with the same capabilities as the reference
implementation `aksiksi/needle` (Rust + FFmpeg + chromaprint + rayon):

  * :class:`needle_tpu.Analyzer`  — decodes episode audio and converts it into
    :class:`needle_tpu.FrameHashes` (chromaprint-style 32-bit perceptual hashes),
    with the fingerprint math running as batched JAX/XLA compute on the GPU.
    (reference: needle/src/audio/analyzer.rs)
  * :class:`needle_tpu.Comparator` — searches for openings/endings across two or
    more episodes via a batched pairwise Hamming-similarity / longest-common-run
    engine on the GPU, replacing the reference's per-pair rayon CPU loop.
    (reference: needle/src/audio/comparator.rs)

The public surface mirrors the reference:
  * `needle {info, analyze, search}` CLI with identical flags and defaults,
  * `.needle.dat` frame-hash files (bincode v1 bit-compatible),
  * `.needle.skip.json` skip files,
  * `Analyzer` / `Comparator` builder APIs.
"""

from .errors import (
    Error,
    AnalyzerMissingPaths,
    FrameHashDataInvalidVersion,
    FrameHashDataNoEnding,
    FrameHashDataNotFound,
    PathNotFound,
)
from .constants import (
    DEFAULT_HASH_MATCH_THRESHOLD,
    DEFAULT_OPENING_SEARCH_PERCENTAGE,
    DEFAULT_ENDING_SEARCH_PERCENTAGE,
    DEFAULT_MIN_OPENING_DURATION,
    DEFAULT_MIN_ENDING_DURATION,
    DEFAULT_HASH_DURATION,
    DEFAULT_OPENING_AND_ENDING_TIME_PADDING,
    FRAME_HASH_DATA_FILE_NAME,
    SKIP_FILE_NAME,
)
from .duration import Duration
from .data import FrameHashes, SkipFile
from .analyzer import Analyzer
from .comparator import Comparator, SearchResult

__version__ = "0.1.0"

__all__ = [
    "Analyzer",
    "Comparator",
    "Duration",
    "FrameHashes",
    "SearchResult",
    "SkipFile",
    "Error",
    "AnalyzerMissingPaths",
    "FrameHashDataInvalidVersion",
    "FrameHashDataNoEnding",
    "FrameHashDataNotFound",
    "PathNotFound",
    "DEFAULT_HASH_MATCH_THRESHOLD",
    "DEFAULT_OPENING_SEARCH_PERCENTAGE",
    "DEFAULT_ENDING_SEARCH_PERCENTAGE",
    "DEFAULT_MIN_OPENING_DURATION",
    "DEFAULT_MIN_ENDING_DURATION",
    "DEFAULT_HASH_DURATION",
    "DEFAULT_OPENING_AND_ENDING_TIME_PADDING",
    "FRAME_HASH_DATA_FILE_NAME",
    "SKIP_FILE_NAME",
]

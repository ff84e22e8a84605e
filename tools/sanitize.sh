#!/usr/bin/env bash
# Run the native-ingest-exercising test legs against an ASan+UBSan build of
# libneedle_ingest.so. The reference gets memory safety from Rust; this is
# the C++ layer's equivalent artifact (SURVEY §5 sanitizers row).
#
# Usage: tools/sanitize.sh [extra pytest args]
#
# ASan must be loaded before libpython (the interpreter itself is not
# instrumented), hence LD_PRELOAD. detect_leaks=0: CPython's arena
# allocator "leaks" by design at interpreter exit; we are after
# buffer/UB errors in needle_ingest.cpp, not Python's shutdown profile.
set -euo pipefail
cd "$(dirname "$0")/.."

make -C native asan

LIBASAN="$(g++ -print-file-name=libasan.so)"
LIBUBSAN="$(g++ -print-file-name=libubsan.so)"

NEEDLE_TPU_INGEST_LIB="$PWD/native/libneedle_ingest_asan.so" \
LD_PRELOAD="$LIBASAN $LIBUBSAN" \
ASAN_OPTIONS="detect_leaks=0:abort_on_error=1:strict_string_checks=1" \
UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1" \
JAX_PLATFORMS=cpu \
python -m pytest tests/test_containers.py tests/test_ingest_exact.py \
    tests/test_mixed_media.py tests/test_end_to_end.py -q "$@"

# C API leg: run the `full` example (analyze + search over a synthetic
# season, exercising every capi entry family) against an ASan+UBSan build
# of libneedle_tpu_capi.so. The example binaries link by soname, so
# LD_LIBRARY_PATH swaps in the instrumented lib (RUNPATH loses to it).
make -C capi asan
make -C capi/examples

SEASON="$(mktemp -d)/season"
PYTHONPATH="$PWD" python - "$SEASON" <<'EOF'
import sys
from needle_tpu.testing import make_synthetic_season
make_synthetic_season(sys.argv[1], num_episodes=3, episode_secs=100,
                      opening_secs=25, seed=4242)
EOF

# NEEDLE_TPU_ALLOW_AUDIO: the synthetic season is WAV and discovery now
# defaults to the reference's video-only semantics.
LD_LIBRARY_PATH="$PWD/capi/asan" \
LD_PRELOAD="$LIBASAN $LIBUBSAN" \
ASAN_OPTIONS="detect_leaks=0:abort_on_error=1:strict_string_checks=1" \
UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1" \
PYTHONPATH="$PWD" JAX_PLATFORMS=cpu NEEDLE_TPU_PYTHON_ROOT="$PWD" \
NEEDLE_TPU_ALLOW_AUDIO=1 \
capi/examples/full "$SEASON"
echo "sanitize: all legs clean"

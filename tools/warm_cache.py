#!/usr/bin/env python3
"""Precompile the standard program shapes into the persistent JAX cache.

The first run over a new library size pays a compile per new program
shape. This warms the common buckets for both engines (deploy-time
warmup). Usage: python tools/warm_cache.py [--quick]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def log(msg):
    print(f"[warm {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main() -> None:
    quick = "--quick" in sys.argv
    import jax

    t0 = time.time()
    np.asarray(jax.device_put(np.ones(8, np.float32)) + 1)
    log(f"device warm in {time.time() - t0:.1f}s")

    from needle_tpu.fingerprint import jax_impl as J
    from needle_tpu.search import jax_impl as S

    # Fingerprint/ingest programs: common frame buckets x common source
    # rates, for both decimation placements (device: dec chain from the
    # source rate; host: pre-decimated mid rate, dec_factor 1).
    from needle_tpu.fingerprint.decimate import decimation_factor

    frame_buckets = [256, 512, 1280, 2560, 5120] if not quick else [256, 2560]
    rates = [(16000, 1), (8000, 1), (11025, 2), (12000, 1), (44100, 2)]
    tables = J._device_tables()
    # warm the SAME program variant production dispatches: with the exact
    # borderline flagging on (the default), the flags output is part of the
    # compiled program for both the fused-ingest and mono paths
    exact = J._exact_enabled()
    for rate, ch in rates:
        f = decimation_factor(rate)
        dec = f if f in (2, 4) else 1
        mid = rate // dec
        rs = J._rs_device_matrix(mid)
        for nf_b in frame_buckets:
            _, in_len, _ = J._ingest_dims(mid, nf_b)
            in_len *= ch * dec
            batch = np.zeros((J.LANES, in_len), np.int16)
            nv = np.full(J.LANES, in_len // ch, np.int32)
            t0 = time.time()
            out = J._ingest_fingerprint_batched(
                jax.numpy.asarray(batch), jax.numpy.asarray(nv), rs,
                *tables, mid, ch, nf_b, dec, with_flags=exact,
            )
            np.asarray(out[0] if exact else out)
            log(f"ingest rate={rate} ch={ch} nf={nf_b} dec={dec}: "
                f"{time.time() - t0:.1f}s")

    for nf_b in frame_buckets:
        pad_len = (nf_b + J._ROWS_PER_FRAME + 1) * J.HOP_SIZE
        batch = np.zeros((J.LANES, pad_len), np.int16)
        t0 = time.time()
        out = J._fingerprint_core_batched(
            jax.numpy.asarray(batch), *tables, nf_b, with_flags=exact
        )
        np.asarray(out[0] if exact else out)
        log(f"fingerprint nf={nf_b}: {time.time() - t0:.1f}s")

    # Search programs: hash-length buckets x episode-table buckets x chunks.
    hash_buckets = [256, 1280, 2560] if quick else [256, 640, 1280, 2560, 5120]
    for n_pad in hash_buckets:
        per_pair = n_pad * S.D_TILE * 12 * 4
        chunk = max(1, min(128, S._MEM_BUDGET // per_pair))
        for e_pad in ([160] if quick else [160, 320, 640]):
            table = np.zeros((e_pad, n_pad), np.uint32)
            ia = np.zeros(chunk, np.int32)
            lm = np.full(chunk, 2**31 - 1, np.int32)
            t0 = time.time()
            # validity table mirrors _search_side's construction
            vt = np.zeros((e_pad, n_pad), bool)
            out = S._batch_tiles_indexed(
                jax.device_put(table), jax.device_put(vt),
                jax.numpy.asarray(ia), jax.numpy.asarray(ia),
                jax.numpy.asarray(lm), 10, n_pad,
            )
            np.asarray(out)
            log(f"search/tiles n_pad={n_pad} e_pad={e_pad} chunk={chunk}: "
                f"{time.time() - t0:.1f}s")
            if S._kernel_choice() == "triton":
                from needle_tpu.search.geometry import (
                    full_block_mask,
                    n_groups_for,
                )

                t0 = time.time()
                walk_chunk = 1024  # _search_side's Triton chunk
                wa = np.zeros(walk_chunk, np.int32)
                wlm = np.full(walk_chunk, 2**31 - 1, np.int32)
                bm = np.full((walk_chunk, n_groups_for(n_pad)),
                             full_block_mask(n_pad), np.int32)
                out = S._batch_walk_bitmask(
                    jax.device_put(table), jax.device_put(vt),
                    jax.numpy.asarray(wa), jax.numpy.asarray(wa),
                    jax.numpy.asarray(wlm), jax.numpy.asarray(bm), 10, n_pad,
                )
                np.asarray(out)
                log(f"search/triton n_pad={n_pad} e_pad={e_pad}: "
                    f"{time.time() - t0:.1f}s")
    log("done")


if __name__ == "__main__":
    main()

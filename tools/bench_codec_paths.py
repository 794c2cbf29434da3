"""Per-path codec throughput on the current backend.

Measures the encode paths end-to-end over a long series:

- float fast (windowed-projection matmuls, encoder.encode_series_fast)
- float exact (the driver's per-step lax.fori_loop MACs)
- 40-bit exact (the same loop with per-step 40-bit requantization)

Throughput counts input bytes consumed per second (the reference-comparable metric:
BASELINE.md's oracle figures count the same). Each timing ends in block_until_ready.

Usage: python tools/bench_codec_paths.py
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kwave_tpu import encoder  # noqa: E402
from kwave_tpu.basis import generate_basis  # noqa: E402

PERIOD = 20.0
HARMONICS = 2
T_STEPS = 2048
N_SENSORS = 16384
REPS = 8


def _series(t, n):
    rng = np.random.default_rng(0)
    tt = np.arange(t, dtype=np.float32)[:, None]
    ph = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return (1e5 * np.sin(2 * np.pi * tt / PERIOD + ph)).astype(np.float32)


def _time(fn, reps=REPS):
    jax.block_until_ready(fn())  # warmup + compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    cb = generate_basis(PERIOD, 1, HARMONICS, normalize=True)
    o = cb.o_size
    series = jnp.asarray(_series(T_STEPS, N_SENSORS))
    n_chunks = T_STEPS // o
    chunks = series[: n_chunks * o].reshape(n_chunks, o, N_SENSORS)
    gb_in = T_STEPS * N_SENSORS * 4 / 1e9
    tables = encoder.make_tables(cb, False)

    results = {}

    # float fast path (matmul projection)
    fast = jax.jit(lambda x: encoder.encode_series_fast(x, cb))
    results["float_fast"] = gb_in / _time(lambda: fast(series))

    for mode40 in (False, True):
        cfg = encoder.EncoderConfig.for_stream(cb, False, mode40, True)

        @jax.jit
        def run(chunks_, cfg=cfg):
            st = encoder.init_state(cfg, N_SENSORS)
            _, frames = encoder.encode_chunks(st, chunks_, cfg, tables)
            return frames

        results[f"{'40bit' if mode40 else 'float'}_exact"] = gb_in / _time(
            lambda: run(chunks))

    for k, v in results.items():
        print(f"  {k:24s} {v:8.2f} GB/s")
    print(json.dumps({k: round(v, 2) for k, v in results.items()}))


if __name__ == "__main__":
    main()

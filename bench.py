"""Codec benchmark: on-the-fly compression codec throughput on one device.

Prints ONE JSON line: {"metric": "codec_encode_decode", "value": <GB/s>, "unit": "GB/s",
"vs_baseline": <x over the reference-semantics CPU oracle>, "actual_bytes_value": <GB/s
over the 2S+2F bytes the chain really moves>, "ceiling": <GB/s of a SAME-RUN chained XLA
elementwise copy over the same series>, "fraction": <actual_bytes_value / ceiling>}.

`fraction` is the run-over-run comparable number: the raw GB/s moves with the card's clocks
and power limit between runs, but kernel and ceiling shift together within a run, so their
ratio tracks the code. `value` counts 2·S bytes (series in, series out); it understates
actual traffic by (S+F)/S ≈ 1.20 at this config, which `actual_bytes_value` counts.

Workload (BASELINE.json north star): pressure sensor series [T, N] fp32 at pressure
amplitudes, windowed-harmonic projection encode (the production float path — the same
coefficients the reference's OpenMP accumulate loop produces,
OutputStreams/IndexOutputStream.cpp:397-450) plus full decode (overlap-add reconstruction).
Throughput counts bytes-in for encode + bytes-out for decode over the measured wall time.

Measurement: REPS_INNER round trips are CHAINED inside one compiled program — each
iteration's input is the previous reconstruction, a true serial data dependency — so the
number measures sustained on-device throughput, not per-dispatch overhead (the driver
amortizes dispatches the same way, one program per window). Timing ends in
block_until_ready. The device (platform, kind, count) is printed on stderr.

`vs_baseline` compares against the reference-CPU-oracle float-encode throughput recorded
in BASELINE.md (tools/measure_oracle.py — the faithful reimplementation of the reference
CPU encode loop).
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from kwave_tpu import decoder, encoder
from kwave_tpu.basis import generate_basis

# Reference-oracle float-mode encode throughput measured on this container's CPU
# (tools/measure_oracle.py: 0.881 GB/s float, 0.014 GB/s 40-bit; see BASELINE.md).
ORACLE_GBPS = 0.881

PERIOD = 20.0
HARMONICS = 2
T_STEPS = 4096
N_SENSORS = 16384  # 256 MB series
REPS_INNER = 16  # chained round trips per dispatch
REPS_OUTER = 4


def make_series(t_steps: int, n: int) -> jax.Array:
    """Generated on device: no 268 MB host->device upload inside the benchmark."""
    @jax.jit
    def gen():
        t = jnp.arange(t_steps, dtype=jnp.float32)[:, None]
        phase = jax.random.uniform(jax.random.PRNGKey(0), (1, n),
                                   dtype=jnp.float32,
                                   minval=0.0, maxval=2.0 * np.pi)
        x = 1e5 * jnp.sin(2 * jnp.pi * t / PERIOD + phase)
        return x + 1e4 * jnp.sin(4 * jnp.pi * t / PERIOD + 1.7 * phase)

    return gen()


def main() -> None:
    import sys

    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}", file=sys.stderr)
    cb = generate_basis(PERIOD, 1, HARMONICS, normalize=True)
    o = cb.o_size
    series = make_series(T_STEPS, N_SENSORS)
    n_frames = T_STEPS // o

    be_re, be_im, _, _ = cb.tables(False)
    tab_re = jnp.asarray(be_re[:, : 2 * o].T)
    tab_im = jnp.asarray(be_im[:, : 2 * o].T)

    def one_roundtrip(x):
        # production packed-frame chain: the kernels' native [K, 2H, N] layout is
        # carried encode -> decode with no re/im split or concat HBM passes between
        frames = encoder.encode_series_frames(x, cb)
        rec = decoder.reconstruct_frames(frames, tab_re, tab_im, o, T_STEPS)
        return frames, rec

    @jax.jit
    def roundtrip_chain(x):
        # serial chain: iteration i+1 encodes iteration i's reconstruction — no
        # loop-invariant hoisting possible, every round trip really runs
        def body(carry, _):
            _, rec = one_roundtrip(carry)
            return rec, None

        rec, _ = lax.scan(body, x, None, length=REPS_INNER)
        return rec

    # correctness guard on one round trip (the chain re-encodes its own reconstruction,
    # which is a fixed point of the transform for band-limited signals)
    frames, rec = jax.block_until_ready(jax.jit(one_roundtrip)(series))
    err = float(
        jnp.max(jnp.abs(rec[2 * o : n_frames * o - 2 * o] - series[2 * o : n_frames * o - 2 * o]))
        / jnp.max(jnp.abs(series))
    )
    assert err < 0.02, f"roundtrip rel err {err}"

    jax.block_until_ready(roundtrip_chain(series))  # warmup + compile
    t0 = time.perf_counter()
    for _ in range(REPS_OUTER):
        out = roundtrip_chain(series)
    jax.block_until_ready(out)  # device executes in enqueue order: waits for all reps
    dt = (time.perf_counter() - t0) / (REPS_OUTER * REPS_INNER)

    # Same-run memory ceiling: a chained elementwise pass (read + write the series
    # once per link) under the identical harness — measured back-to-back with the
    # codec chain so the card's state cancels in the ratio. The per-link term depends
    # on the loop index, so XLA cannot fold the chain away.
    @jax.jit
    def copy_chain(x):
        def body(c, i):
            return c + 1e-30 * (i + 1).astype(jnp.float32), None

        out, _ = lax.scan(body, x, jnp.arange(REPS_INNER))
        return out

    jax.block_until_ready(copy_chain(series))  # warmup + compile
    t0 = time.perf_counter()
    for _ in range(REPS_OUTER):
        cout = copy_chain(series)
    jax.block_until_ready(cout)
    dt_copy = (time.perf_counter() - t0) / (REPS_OUTER * REPS_INNER)

    bytes_in = series.size * 4  # encode reads the series
    bytes_out = rec.size * 4  # decode writes the reconstruction
    f_bytes = frames.size * 4  # coefficient frames: written by encode, read by decode
    gbps = (bytes_in + bytes_out) / dt / 1e9
    actual_gbps = (bytes_in + bytes_out + 2 * f_bytes) / dt / 1e9
    ceiling = (bytes_in + bytes_out) / dt_copy / 1e9
    print(
        json.dumps(
            {
                "metric": "codec_encode_decode",
                "value": round(gbps, 3),
                "unit": "GB/s",
                "vs_baseline": round(gbps / ORACLE_GBPS, 1),
                "actual_bytes_value": round(actual_gbps, 3),
                "ceiling": round(ceiling, 3),
                "fraction": round(actual_gbps / ceiling, 4),
            }
        )
    )


if __name__ == "__main__":
    main()

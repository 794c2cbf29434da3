"""Scaling-efficiency harness: sharded codec encode throughput over 1..N devices.

Run on GPUs for the BASELINE.json §5 metric; on the CPU virtual mesh it validates the
mechanics only (speedups there are bounded by host cores).

Usage: python tools/bench_scaling.py [max_devices]
Prints one JSON line per device count plus a final efficiency summary.
"""

import json
import sys
import time

import numpy as np

import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from kwave_tpu.basis import generate_basis
from kwave_tpu.parallel import make_mesh
from kwave_tpu.parallel.distributed import encode_sharded, gather_frames

PERIOD, HARMONICS, T = 20.0, 2, 2048


def run(n_devices: int, n_sensors: int) -> float:
    mesh = make_mesh(n_devices)
    cb = generate_basis(PERIOD, 1, HARMONICS, normalize=True)
    rng = np.random.default_rng(0)
    t = np.arange(T, dtype=np.float32)[:, None]
    x = (1e5 * np.sin(2 * np.pi * t / PERIOD)
         + 1e3 * rng.standard_normal((T, n_sensors))).astype(np.float32)

    jax.block_until_ready(encode_sharded(x, cb, mesh))  # warmup
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = encode_sharded(x, cb, mesh)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    gather_frames(out, mesh)
    return x.nbytes / dt / 1e9


def main():
    max_dev = int(sys.argv[1]) if len(sys.argv) > 1 else len(jax.devices())
    base_sensors = 4096
    results = {}
    for n in (1, 2, 4, 8, 16, 32):
        if n > max_dev:
            break
        gbps = run(n, base_sensors * n)  # weak scaling: constant work per device
        results[n] = gbps
        print(json.dumps({"devices": n, "encode_gbps": round(gbps, 3)}))
    if len(results) > 1:
        base = results[1]
        last_n = max(results)
        eff = results[last_n] / (base * last_n)
        print(json.dumps({"weak_scaling_efficiency": round(eff, 3),
                          "devices": last_n}))


if __name__ == "__main__":
    main()

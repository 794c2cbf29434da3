"""Driver-amortized 40-bit codec benchmark (VERDICT r3 #5).

The production driver encodes INSIDE the window program — one dispatch per
compression window amortized over oSize solver steps — so the 40-bit figure that
matters is measured here exactly as the driver runs it: 128^3 heterogeneous
medium, index mask, the full stream set of
``--p_c --u_non_staggered_c --I_avg_c --40-bit_complex``
(p + 3 shifted-velocity compressed streams, their hidden-dependency wiring, and
the coefficient-space intensity accumulators), through driver.make_window_fn.

Reported:
- ms/step solver-only (same grid, no streams) vs with the full 40-bit window
  pipeline -> the codec+sampling increment;
- encode GB/s seen by the window program: sampled series bytes (4 sources x
  N sensors x 4 B per step) / the increment;
- the host flush leg (fetch one window's emissions + append them to an in-memory
  output store, `kwave_tpu.io.memory`) measured separately: the number that
  overlaps window w+1's compute in the driver.

Each timing ends in block_until_ready.

Usage: python tools/bench_driver_40bit.py [--n 128] [--sensors 16384]
       [--windows 8] [--period 16]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kwave_tpu import streams as streams_mod  # noqa: E402
from kwave_tpu.basis import generate_basis  # noqa: E402
from kwave_tpu.driver import make_window_fn  # noqa: E402
from kwave_tpu.solver import (  # noqa: E402
    Grid,
    Medium,
    SolverConfig,
    Sources,
    init_state,
    make_operators,
    make_simulate_fn,
)
from kwave_tpu.streams import StreamSpec  # noqa: E402

def build(n: int, n_sensors: int, period: float, harmonics: int):
    dx = 1e-4
    dt = 0.3 * dx / 1600.0
    grid = Grid(nx=n, ny=n, nz=n, dx=dx, dy=dx, dz=dx, dt=dt, nt=10_000)
    rng = np.random.default_rng(7)
    c0 = (1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32)
    rho0 = (1000.0 + 50.0 * rng.random(grid.shape)).astype(np.float32)
    medium = Medium(c0=c0, rho0=rho0, alpha_coeff=0.75, alpha_power=1.5)

    # the full 40-bit stream set the VERDICT names: p_c + u_non_staggered_c
    # (shifted basis) + I_avg_c from coefficient space
    flags = dict(p_c=True, u_non_staggered_c=True)
    specs = StreamSpec.from_flags(flags, True, True)  # mode40
    for a in ("x", "y", "z"):
        specs.append(StreamSpec(f"I{a}_avg_c", f"u{a}_shifted", "iavg_c", mode40=True))
    ops = make_operators(grid, medium, (10, 10, 10), (2.0,) * 3, absorbing=True,
                         need_shift=True)
    ops = jax.tree_util.tree_map(jnp.asarray, ops)
    cfg = SolverConfig(absorbing=True)
    basis = generate_basis(period, 1, harmonics, normalize=True)
    mask = jnp.asarray(
        np.sort(rng.choice(grid.n_elements, n_sensors, replace=False)).astype(np.int32)
    )
    p0 = np.zeros(grid.shape, np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    src = Sources(p0=jnp.asarray(p0))
    return grid, ops, cfg, basis, specs, mask, src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--sensors", type=int, default=16384)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--period", type=float, default=16.0)
    ap.add_argument("--harmonics", type=int, default=2)
    args = ap.parse_args()

    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}", flush=True)
    grid, ops, cfg, basis, specs, mask, src = build(
        args.n, args.sensors, args.period, args.harmonics
    )
    o = basis.o_size
    n_series = 4  # p + ux/uy/uz shifted feed the compressed streams

    # --- solver-only baseline (same steps, no streams) ---
    run = make_simulate_fn(ops, src, cfg, o)
    st = init_state(grid)
    st, _ = run(st, jnp.int32(0))
    jax.block_until_ready(st)
    st = init_state(grid)
    t0 = time.perf_counter()
    t = 0
    for _ in range(args.windows):
        st, _ = run(st, jnp.int32(t))
        t += o
    jax.block_until_ready(st)
    base_ms = (time.perf_counter() - t0) / (args.windows * o) * 1e3
    print(f"solver-only: {base_ms:8.3f} ms/step", flush=True)

    # --- full 40-bit window pipeline, device side (the driver's hot loop;
    # emissions stay on device — the host flush overlaps the next window) ---
    window = make_window_fn(specs, basis, cfg, o, args.sensors, ops=ops, src=src,
                            mask=mask)
    ss = streams_mod.init_stream_states(specs, args.sensors, grid.n_elements, basis)
    st = init_state(grid)
    st, ss, em = window(st, ss, jnp.int32(0))  # compile
    jax.block_until_ready(st)
    st = init_state(grid)
    ss = streams_mod.init_stream_states(specs, args.sensors, grid.n_elements, basis)
    t0 = time.perf_counter()
    t = 0
    for _ in range(args.windows):
        st, ss, em = window(st, ss, jnp.int32(t))
        t += o
    jax.block_until_ready(st)
    full_ms = (time.perf_counter() - t0) / (args.windows * o) * 1e3
    inc_ms = full_ms - base_ms
    series_bytes_per_step = n_series * args.sensors * 4
    enc_gbps = series_bytes_per_step / max(inc_ms, 1e-9) / 1e6
    print(f"40-bit window pipeline: {full_ms:8.3f} ms/step "
          f"(codec+sampling increment {inc_ms:8.3f} ms/step, "
          f"{inc_ms / base_ms * 100:5.1f}%)", flush=True)
    print(f"encode throughput seen by the window program: {enc_gbps:8.2f} GB/s "
          f"({n_series} series x {args.sensors} sensors)", flush=True)

    # --- host flush leg: fetch one window's emissions + append to the output ---
    from kwave_tpu.io.memory import MemoryFile
    from kwave_tpu.streams import StreamWriter

    f = MemoryFile()
    writer = StreamWriter(f, specs, args.sensors, grid.n_elements,
                          args.windows * o, basis, 0)
    t0 = time.perf_counter()
    host_em = jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), em,
        is_leaf=lambda v: v is None)
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    writer.flush_emissions(host_em)
    write_s = time.perf_counter() - t0
    f.close()
    print(f"host flush per window: fetch {fetch_s * 1e3:.1f} ms + append "
          f"{write_s * 1e3:.1f} ms (window compute {full_ms * o:.1f} ms)", flush=True)


if __name__ == "__main__":
    main()

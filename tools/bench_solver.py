"""Solver throughput benchmark on the current jax backend.

Measures the production main-loop iteration time — the number the reference reports as
`average_sampling_iteration_time` / `average_non-sampling_iteration_time`
(KSpaceFirstOrderSolver.cpp:1157-1168, printStatistics :2742-2780) — for 3D heterogeneous
absorbing media at the reference's supported grid sizes (64^3..256^3; Readme.md:11-13),
with and without the full sampling+compression window pipeline. Each timing ends in
block_until_ready.

Usage: python tools/bench_solver.py [--sizes 64,128,256] [--steps 32]
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


def setup(n: int, compact: bool = False):
    dx = 1e-4
    dt = 0.3 * dx / 1600.0
    grid = Grid(nx=n, ny=n, nz=n, dx=dx, dy=dx, dz=dx, dt=dt, nt=10_000)
    rng = np.random.default_rng(7)
    c0 = (1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32)
    rho0 = (1000.0 + 50.0 * rng.random(grid.shape)).astype(np.float32)
    medium = Medium(c0=c0, rho0=rho0, alpha_coeff=0.75, alpha_power=1.5)
    ops = make_operators(grid, medium, (10, 10, 10), (2.0,) * 3, absorbing=True,
                         compact=compact)
    ops = jax.tree_util.tree_map(jnp.asarray, ops)  # device-resident (see driver.py)
    # steady-state step: the driver peels the t==0 initial-pressure program out
    # of the scan (make_window_fn peel_p0), so production iterations carry no p0
    # branch — the benchmark measures exactly that step
    cfg = SolverConfig(absorbing=True)
    p0 = np.zeros(grid.shape, np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    src = Sources(p0=jnp.asarray(p0))
    return grid, ops, cfg, src


def bench_plain(n: int, steps: int, compact: bool = False) -> float:
    """Seconds per iteration, solver only (non-sampling)."""
    grid, ops, cfg, src = setup(n, compact)
    run = make_simulate_fn(ops, src, cfg, steps)
    state = init_state(grid)
    state, _ = run(state, jnp.int32(0))
    jax.block_until_ready(state)
    state = init_state(grid)
    reps = 4
    t0 = time.perf_counter()
    for r in range(reps):
        state, _ = run(state, jnp.int32(r * steps))
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / (steps * reps)


def bench_sampling(n: int, steps: int, n_sensors: int = 16384,
                   compact: bool = False) -> float:
    """Seconds per iteration with index-mask sampling + compressed + raw p streams
    (the reference's sampling-iteration bucket)."""
    grid, ops, cfg, src = setup(n, compact)
    basis = generate_basis(16.0, 1, 2, normalize=True)
    o = basis.o_size
    rng = np.random.default_rng(0)
    mask = jnp.asarray(
        np.sort(rng.choice(grid.n_elements, n_sensors, replace=False)).astype(np.int32)
    )
    specs = StreamSpec.from_flags(dict(p_raw=True, p_c=True, p_rms=True), True, False)
    ss = streams_mod.init_stream_states(specs, n_sensors, grid.n_elements, basis)
    window = make_window_fn(specs, basis, cfg, o, n_sensors, ops=ops, src=src, mask=mask)
    state = init_state(grid)
    state, ss, em = window(state, ss, jnp.int32(0))  # compile
    jax.block_until_ready(state)
    state = init_state(grid)
    ss = streams_mod.init_stream_states(specs, n_sensors, grid.n_elements, basis)
    n_windows = max(steps // o, 1) * 4
    t0 = time.perf_counter()
    t = 0
    for _ in range(n_windows):
        state, ss, em = window(state, ss, jnp.int32(t))
        t += o
    jax.block_until_ready((state, ss, em))
    return (time.perf_counter() - t0) / (n_windows * o)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="64,128,256")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--compact", action="store_true",
                    help="compact operators (the driver's default from 192^3 up)")
    ap.add_argument("--no-sampling", action="store_true",
                    help="skip the sampling+encode benchmark leg")
    args = ap.parse_args()
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}", flush=True)
    for n in (int(s) for s in args.sizes.split(",")):
        plain = bench_plain(n, args.steps, compact=args.compact)
        cells = n**3
        line = (
            f"  {n}^3: non-sampling {plain * 1e3:8.3f} ms/step "
            f"({cells / plain / 1e9:6.2f} Gcell/s)"
        )
        if not args.no_sampling:
            samp = bench_sampling(n, args.steps, compact=args.compact)
            line += (
                f" | sampling+encode {samp * 1e3:8.3f} ms/step "
                f"({cells / samp / 1e9:6.2f} Gcell/s)"
            )
        print(line, flush=True)


if __name__ == "__main__":
    main()

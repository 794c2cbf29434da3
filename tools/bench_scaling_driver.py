"""Weak-scaling mechanics of the sharded solver on the 8-device virtual CPU mesh.

Wall-clock on a host-platform mesh means nothing (all "devices" share the same
cores), so this records the things that DO carry to real multi-GPU hardware
(BASELINE.json north star: >=80% scaling at N>=2):

1. **Collective census**: compile one sharded timestep per device count and
   inventory every collective in the optimized HLO — kind, count, and bytes.
   Under weak scaling (nz grows with N, per-device slab constant) the per-device
   collective bytes per step should stay ~flat: that is the mechanical statement
   of weak scalability (the all-to-alls of the pencil FFT exchange each device's
   slab with every other, but each device's TOTAL send+recv volume is its slab).
2. **Output equality**: the full driver on 2/4/8 devices must produce the same
   output file as the single-device run (tolerance: pencil-FFT reassociation).

On GPUs, time `simulate` ending in block_until_ready; the collective census is the
same there — GSPMD partitioning does not depend on the backend.

Usage: python tools/bench_scaling_driver.py   (sets its own XLA_FLAGS/JAX_PLATFORMS)
"""

import json
import os
import re
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

# in case jax was imported before this file: the config is still mutable until
# first backend use (as in tests/conftest.py)
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from kwave_tpu.parallel import (  # noqa: E402
    make_mesh,
    pencil_fft,
    shard_operators,
    shard_state,
)
from kwave_tpu.solver import (  # noqa: E402
    Grid,
    Medium,
    SolverConfig,
    Sources,
    init_state,
    make_operators,
    step,
)

_DTYPE_BYTES = {"f32": 4, "c64": 8, "f64": 8, "c128": 16, "s32": 4, "u32": 4,
                "pred": 1, "bf16": 2, "u8": 1}
_COLLECTIVES = ("all-to-all", "all-gather", "all-reduce", "reduce-scatter",
                "collective-permute")


def _collective_census(hlo_text: str) -> dict:
    """Count collectives and their output bytes in optimized HLO.

    Results may be tuples (one element per participant), e.g.
      %all-to-all = (c64[1,16,1,4,17]{...}, ...) all-to-all(%a, %b, ...)
    so every dtype[dims] on the LHS is summed."""
    out = {}
    line_pat = re.compile(
        r"=\s*(.*?)\s(" + "|".join(_COLLECTIVES) + r")\(")
    shape_pat = re.compile(r"(\w+)\[([\d,]*)\]")
    for line in hlo_text.splitlines():
        m = line_pat.search(line)
        if not m:
            continue
        kind = m.group(2)
        nbytes = 0
        for sm in shape_pat.finditer(m.group(1)):
            dt, dims = sm.group(1), sm.group(2)
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        e = out.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += nbytes
    return out


def _setup(n_dev: int, nz: int):
    grid = Grid(nx=32, ny=32, nz=nz, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=10)
    rng = np.random.default_rng(0)
    c0 = (1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32)
    medium = Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5)
    ops = make_operators(grid, medium, (4, 4, 4), (2.0,) * 3, absorbing=True)
    cfg = SolverConfig(absorbing=True)
    mesh = make_mesh(n_dev)
    ops_s = shard_operators(ops, 3, mesh, grid=grid, pencil=True)
    state = shard_state(init_state(grid), mesh)
    fft = pencil_fft(mesh, grid.nx)
    return grid, mesh, ops_s, state, cfg, fft


def census_for(n_dev: int) -> dict:
    """Compile ONE sharded timestep at weak-scaled size; return collective stats."""
    nz_per_dev = 16
    grid, mesh, ops_s, state, cfg, fft = _setup(n_dev, nz_per_dev * n_dev)
    src = Sources()

    def one_step(st):
        return step(st, jnp.int32(1), ops_s, src, cfg, fft=fft)

    with mesh:
        compiled = jax.jit(one_step).lower(state).compile()
    txt = compiled.as_text()
    cens = _collective_census(txt)
    # the compiled module is SPMD (one per-device program), so every shape in it —
    # including collective results — is already PER-DEVICE
    total = sum(e["bytes"] for e in cens.values())
    return {
        "devices": n_dev,
        "grid": [grid.nz, grid.ny, grid.nx],
        "collectives": cens,
        "per_device_collective_bytes_per_step": total,
    }


def equality_check() -> dict:
    """Full driver, fixed 16^3 problem: mesh runs vs single-device run."""
    import tempfile

    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(np.random.default_rng(4).choice(grid.n_elements, 40,
                                                   replace=False))
    data = InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask, p0=p0,
    )
    run = RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True), period=10.0,
                    harmonics=2)
    res = {}
    with tempfile.TemporaryDirectory() as td:
        ref_path = os.path.join(td, "single.h5")
        run_simulation(data, run, ref_path)
        with h5py.File(ref_path) as f:
            ref = {k: np.asarray(f[k]) for k in ("p", "p_c", "p_rms")}
        for n in (2, 4, 8):
            out = os.path.join(td, f"mesh{n}.h5")
            run_simulation(data, run, out, mesh=make_mesh(n))
            worst = 0.0
            with h5py.File(out) as f:
                for k, a in ref.items():
                    b = np.asarray(f[k])
                    scale = max(np.abs(a).max(), 1e-30)
                    worst = max(worst, float(np.abs(b - a).max() / scale))
            res[n] = worst
    return res


def mp_equality_check() -> dict:
    """The SAME full-driver equality, but across real process boundaries so every
    emission crosses the hardened WriterGather transport (r4 VERDICT #8): a
    2-process/4-device run and a 4-process/8-device run, each against a
    single-process run on an identically-partitioned mesh."""
    import socket
    import subprocess
    import tempfile

    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                    + "/tests")
    from mp_driver_worker import build_input

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_driver_worker.py")
    res = {}
    data = build_input()
    run = RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                    period=10.0, harmonics=2)
    with tempfile.TemporaryDirectory() as td:
        for nproc in (2, 4):
            ref_path = os.path.join(td, f"ref{nproc}.h5")
            run_simulation(data, run, ref_path, mesh=make_mesh(2 * nproc))
            s = socket.socket(); s.bind(("localhost", 0))
            port = s.getsockname()[1]; s.close()
            out = os.path.join(td, f"mp{nproc}.h5")
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            procs = [
                subprocess.Popen(
                    [sys.executable, worker, str(r), str(nproc), str(port), out],
                    env=env, cwd=root)
                for r in range(nproc)
            ]
            rcs = [p.wait(timeout=420) for p in procs]
            assert all(rc == 0 for rc in rcs), rcs
            worst = 0.0
            with h5py.File(out) as fa, h5py.File(ref_path) as fb:
                for k in ("p", "p_c", "p_rms", "p_max_all"):
                    a, b = np.asarray(fa[k]), np.asarray(fb[k])
                    scale = max(np.abs(b).max(), 1e-30)
                    worst = max(worst, float(np.abs(a - b).max() / scale))
            res[nproc] = worst
    return res


def main():
    print(f"devices: {len(jax.devices())}", file=sys.stderr, flush=True)
    rows = []
    for n in (1, 2, 4, 8):
        r = census_for(n)
        rows.append(r)
        print(json.dumps(r), flush=True)
    base = next((r for r in rows if r["devices"] > 1), None)
    if base is not None:
        last = rows[-1]
        k = "per_device_collective_bytes_per_step"
        ratio = last[k] / base[k] if base[k] else 0.0
        # 1.0 = per-device comm volume flat under weak scaling (the mechanical
        # prerequisite for the >=80% scaling target on real GPUs)
        print(json.dumps({
            "weak_scaling_per_device_bytes_ratio_8_vs_2": round(ratio, 3)}),
            flush=True)
    eq = equality_check()
    print(json.dumps({"driver_equality_max_rel_diff": eq}), flush=True)
    mp_eq = mp_equality_check()
    print(json.dumps(
        {"mp_writer_gather_equality_max_rel_diff":
         {f"{n}proc_{2*n}dev": v for n, v in mp_eq.items()}}), flush=True)


if __name__ == "__main__":
    main()

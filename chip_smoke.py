"""Proof that the simulator and its 40-bit codec run correctly on a GPU.

    python chip_smoke.py          # one GPU: the phases main, codec and fields
    python chip_smoke.py --multi  # four GPUs of one host, one process: the phase multi

Phases (each prints one line with its result and wall time):

- main: ROADMAP deployment C (focused-ultrasound treatment planning) at 256^3 through
  the CLI's own flag parsing and run path (`cli.simulate`): a heterogeneous,
  nonlinear, absorbing medium generated from a seed, a driven periodic pressure
  source, 16,384 index sensors, ``--p_raw --p_c --40-bit_complex --u_non_staggered_c
  --I_avg_c --p_max --p_final --harmonics 2``, cut by ``--benchmark`` to a lead-in
  plus three compression windows and a partial tail. The input and output files are
  in-memory stores (`kwave_tpu.io.memory`): the HDF5 layout without h5py, which the
  GPU machine lacks. Checks every dataset's shape, p_c bit for bit against
  `oracle.py` fed the run's own raw p, and the decoded p_c against raw p.
- codec: the exact encoder against `oracle.py`, bit for bit, in all 32 modes
  (float/40-bit x overlap/no-overlap x pressure/shifted-velocity x H = 1..4) at
  16,384 sensors, both through `encoder.encode_series_exact` and through the
  driver's jitted window program.
- fields: one jitted 40-step window program at 128^3 on the GPU and on the CPU backend
  of the same process; the relative L2 difference of p and ux_sgx.
- multi (``--multi`` only): the main phase's deployment through ``--devices 4`` (a
  z-sharded mesh with the pencil FFT) against a one-GPU run of the same input.

Exits non-zero, printing no result line, when JAX finds no GPU, when a phase fails,
or when run outside a kwave_tpu checkout. Otherwise the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

# -- deployment C, cut to a few windows (ROADMAP queue 2; BASELINE.json configs 3-4) --
N_GRID = 256
N_SENSORS = 16_384  # a 128 x 128 sensor plane
PERIOD = 32  # source period in steps = the compression period (2 MHz drive)
F0 = 2.0e6
HARMONICS = 2
# unsampled steps (-s 1025): 32 periods, so the driven field at the sensor plane is
# steady when sampling starts and the tonal codec can represent it
LEAD_IN = 1024
SOURCE_RADIUS = 0.25  # of the grid width: the aperture spans the sensor plane
N_WINDOWS = 3
TAIL = PERIOD // 2  # a partial trailing window
# decoded-p_c vs raw-p bound over the fully covered window: what the tonal codec reaches
# once the driven field is steady (1.4e-4 for this input at 128^3 on the CPU backend)
RECON_REL_TOL = 2e-3
# GPU vs CPU fields after 40 steps: cuFFT and the CPU FFT round differently, ~1e-7
# relative per fp32 transform. 40 steps x ~20 transforms, all adding up in the same
# direction, stay below 1e-4; a wrong operator or term gives 1e-2 or more.
FIELD_REL_TOL = 1e-4
# mesh vs one-GPU: the pencil FFT sums in another order (per-axis 1D transforms and
# all-to-alls instead of one 3D plan); the same rounding argument over the run's
# 1,136 steps, in a damped, stable scheme where rounding does not grow.
MESH_REL_TOL = 1e-4


def deployment_c(n: int = N_GRID, n_sensors: int = N_SENSORS, seed: int = 0,
                 nt: int = 2048):
    """Input for deployment C: water with soft-tissue inclusions (c0, rho0 from a seed),
    B/A = 6, power-law absorption 0.75 dB/(MHz^1.5 cm), a disc source driven at 2 MHz
    (100 kPa) in additive mode, and a square plane of index sensors beyond the source."""
    from kwave_tpu.io.input_file import InputData
    from kwave_tpu.solver import Grid, Medium

    rng = np.random.default_rng(seed)
    dx = 1e-4
    grid = Grid(nx=n, ny=n, nz=n, dx=dx, dy=dx, dz=dx, dt=1.0 / (F0 * PERIOD), nt=nt)
    c0 = np.full(grid.shape, 1500.0, np.float32)
    rho0 = np.full(grid.shape, 1000.0, np.float32)
    zz, yy, xx = np.ogrid[:n, :n, :n]
    for _ in range(6):
        cz, cy, cx = rng.uniform(0.35 * n, 0.75 * n, 3)
        r = rng.uniform(0.05 * n, 0.12 * n)
        inside = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        c0[inside] = rng.uniform(1540.0, 1600.0)
        rho0[inside] = rng.uniform(1030.0, 1080.0)
    pml = max(4, n // 25)
    z_src = pml + 4
    yy2, xx2 = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    disc = (yy2 - n / 2) ** 2 + (xx2 - n / 2) ** 2 <= (SOURCE_RADIUS * n) ** 2
    src_idx = ((z_src * n + yy2[disc]) * n + xx2[disc]).astype(np.int64)
    # 100 kPa at the source, in the density units of an additive source term (the
    # k-Wave toolbox writes source.p * 2 dt / (N c0 dx) into the input file)
    t = np.arange(nt, dtype=np.float64)
    scale = 2.0 * grid.dt / (3 * 1500.0 * dx)
    signal = (1e5 * scale * np.sin(2 * np.pi * t / PERIOD)).astype(np.float32)
    side = int(math.isqrt(n_sensors))
    z_sens = min(z_src + max(6, n // 10), n - pml - 1)
    lo = (n - side) // 2
    sy, sx = np.meshgrid(np.arange(lo, lo + side), np.arange(lo, lo + side),
                         indexing="ij")
    sensors = np.sort(((z_sens * n + sy) * n + sx).reshape(-1)).astype(np.int64)
    return InputData(
        grid=grid,
        medium=Medium(c0=c0, rho0=rho0, bona=6.0, alpha_coeff=0.75, alpha_power=1.5),
        pml_size=(pml,) * 3, pml_alpha=(2.0,) * 3,
        nonlinear=True, absorbing=True,
        sensor_mask_index=sensors,
        p_source_index=src_idx, p_source_input=signal,
        p_source_flag=nt, p_source_mode=2,
    )


def _in_memory_input(data):
    """The input written and read back through the HDF5 contract, in memory."""
    from kwave_tpu.io.input_file import write_input_file
    from kwave_tpu.io.memory import MemoryFile

    store = MemoryFile()
    write_input_file(store, data)
    return store


def _run_cli(flags: list[str], input_store):
    """The CLI's parser and run path with in-memory stores for -i/-o."""
    from kwave_tpu.cli import simulate
    from kwave_tpu.io.memory import MemoryFile
    from kwave_tpu.params import build_parser

    out = MemoryFile()
    args = build_parser().parse_args(["-i", "(memory)", "-o", "(memory)", *flags])
    rc = simulate(args, input_store, out)
    if rc != 0:
        raise RuntimeError(f"cli.simulate returned {rc}")
    return out


def _oracle_rows(series, basis, shifted: bool, mode40: bool, overlap: bool):
    """Expected dataset rows (as bytes) of one compressed stream: the oracle's frames in
    the reference's pH = i*H + ih layout, 40-bit rows zero-padded to ceil(1.25 N) H."""
    from kwave_tpu import oracle

    n = series.shape[1]
    frames = oracle.OracleEncoder(basis, n, shifted=shifted, mode40=mode40,
                                  overlap=overlap,
                                  total_steps=series.shape[0]).encode_series(series)
    rows = []
    for fr in frames:
        if mode40:
            row = np.zeros(int(math.ceil(n * 1.25)) * basis.harmonics, np.float32)
            packed = oracle.soa_to_bytes(*fr)
            row.view(np.uint8)[: packed.size] = packed
        else:
            row = np.stack(fr, axis=-1).astype(np.float32).reshape(-1)
        rows.append(row.view(np.uint8))
    return frames, rows


def _mismatched_rows(dataset_rows, expected_rows) -> int:
    got = np.ascontiguousarray(np.asarray(dataset_rows, np.float32))
    if got.shape[0] != len(expected_rows):
        raise AssertionError(f"{got.shape[0]} frames written, {len(expected_rows)} expected")
    return sum(int(not np.array_equal(g.view(np.uint8), e))
               for g, e in zip(got, expected_rows))


def phase_main(n: int = N_GRID, n_sensors: int = N_SENSORS) -> str:
    from kwave_tpu import decoder
    from kwave_tpu.basis import MAX_EXP_P, generate_basis
    from kwave_tpu.io import names

    steps = N_WINDOWS * PERIOD + TAIL
    store = _in_memory_input(deployment_c(n, n_sensors))
    f = _run_cli(["--p_raw", "--p_c", "--40-bit_complex", "--u_non_staggered_c",
                  "--I_avg_c", "--p_max", "--p_final", "--harmonics", str(HARMONICS),
                  "-s", str(LEAD_IN + 1), "--benchmark", str(LEAD_IN + steps)], store)
    row40 = int(math.ceil(n_sensors * 1.25)) * HARMONICS
    want = {"p": (1, steps, n_sensors), "p_c": (1, N_WINDOWS, row40),
            "p_max": (1, 1, n_sensors), "p_final": (n, n, n)}
    for a in "xyz":
        want[f"u{a}_non_staggered_c"] = (1, N_WINDOWS, row40)
        want[f"I{a}_avg_c"] = (1, 1, n_sensors)
    got = {k: tuple(f[k].shape) for k in f.keys()}
    if got != want:
        raise AssertionError(f"datasets {got} != reference sizing {want}")
    raw = np.asarray(f["p"])[0]
    for k in ("p", "p_max", "p_final", "Ix_avg_c", "Iy_avg_c", "Iz_avg_c"):
        if not np.isfinite(np.asarray(f[k])).all():
            raise AssertionError(f"{k} has non-finite values")
    if not np.array_equal(np.asarray(f["p_max"]).reshape(-1), raw.max(axis=0)):
        raise AssertionError("p_max differs from the maximum of raw p")
    if float(f["p_c"].attrs["c_period"]) != PERIOD:
        raise AssertionError(f"detected period {f['p_c'].attrs['c_period']} != {PERIOD}")

    basis = generate_basis(float(PERIOD), 1, HARMONICS, normalize=True)
    _, rows = _oracle_rows(raw, basis, shifted=False, mode40=True, overlap=True)
    bad = _mismatched_rows(np.asarray(f["p_c"])[0], rows)
    if bad:
        raise AssertionError(f"p_c: {bad}/{len(rows)} frames differ from the oracle")

    re, im = decoder.decode_40bit_rows(np.asarray(f["p_c"])[0], HARMONICS, MAX_EXP_P)
    rec = np.asarray(decoder.reconstruct_series(
        np.transpose(re, (0, 2, 1)), np.transpose(im, (0, 2, 1)), basis, False,
        N_WINDOWS * PERIOD))
    o = basis.o_size
    full = slice(o, (N_WINDOWS - 1) * o)  # covered by two frames each
    scale = float(np.abs(raw[full]).max())
    if scale == 0.0:
        raise AssertionError("the sensor plane saw no pressure in the covered window")
    rel = float(np.abs(rec[full] - raw[full]).max()) / scale
    if rel > RECON_REL_TOL:
        raise AssertionError(f"decoded p_c vs raw p: {rel:.3e} > {RECON_REL_TOL:g}")
    peak = f.attrs.get(names.PEAK_DEVICE_MEMORY)
    it = f.attrs.get("average_sampling_iteration_time")
    return (f"{n}^3, {n_sensors} sensors, {steps} sampled steps: datasets at reference "
            f"sizes; p_c bit-exact vs oracle ({len(rows)} frames); decoded p_c vs raw p "
            f"{rel:.3e} (tol {RECON_REL_TOL:g}, max |p| {scale:.4g} Pa); "
            f"peak device memory {peak if peak is None else f'{float(peak):.1f}'} MiB; "
            f"sampling iteration {float(it) * 1e3 if it is not None else float('nan'):.3f} ms")


def phase_codec(n: int = 64, n_sensors: int = N_SENSORS) -> str:
    from kwave_tpu import encoder
    from kwave_tpu.basis import generate_basis
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import read_input_file
    from kwave_tpu.io.memory import MemoryFile

    period, lead = 13.4, 40  # a non-integer period, as the reference allows
    data = deployment_c(n, n_sensors=64)
    rng = np.random.default_rng(1)
    data.sensor_mask_index = np.sort(
        rng.choice(data.grid.n_elements, n_sensors, replace=False)).astype(np.int64)
    store = _in_memory_input(data)
    modes, failures = 0, []
    for h in (1, 2, 3, 4):
        basis = generate_basis(period, 1, h, normalize=True)
        o = basis.o_size
        for mode40 in (False, True):
            for overlap in (True, False):
                d = read_input_file(store)
                d.grid = dataclasses.replace(d.grid, nt=lead + 6 * o)
                out = MemoryFile()
                run_simulation(d, RunConfig(
                    flags=dict(p_raw=True, p_c=True, u_non_staggered_raw=True,
                               u_non_staggered_c=True),
                    mode40=mode40, no_overlap=not overlap, period=period,
                    harmonics=h, sampling_start=lead), out)
                for raw_name, c_name, shifted in (("p", "p_c", False),
                                                  ("ux_non_staggered",
                                                   "ux_non_staggered_c", True)):
                    series = np.asarray(out[raw_name])[0]
                    frames, rows = _oracle_rows(series, basis, shifted, mode40, overlap)
                    tag = (f"H={h} {'40-bit' if mode40 else 'float'} "
                           f"{'overlap' if overlap else 'no-overlap'} "
                           f"{'shifted' if shifted else 'pressure'}")
                    bad = _mismatched_rows(np.asarray(out[c_name])[0], rows)
                    if bad:
                        failures.append(f"{tag} driver window: {bad} frames differ")
                    got, _ = encoder.encode_series_exact(
                        series, basis, shifted=shifted, mode40=mode40, overlap=overlap)
                    for c, fo in enumerate(frames):
                        for k, plane in enumerate(fo):
                            pj = np.asarray(got[k][c]).T
                            same = (np.array_equal(pj.astype(plane.dtype), plane)
                                    if mode40 else
                                    np.array_equal(pj.view(np.uint32),
                                                   plane.view(np.uint32)))
                            if not same:
                                failures.append(f"{tag} encode_series_exact frame {c}")
                    modes += 1
    if failures:
        raise AssertionError("; ".join(failures[:8]))
    return (f"{modes}/32 modes bit-exact vs oracle at {n_sensors} sensors, through "
            "encode_series_exact and the driver window program")


def phase_fields(n: int = 128, steps: int = 40) -> str:
    import jax
    import jax.numpy as jnp

    from kwave_tpu.driver import make_window_fn
    from kwave_tpu.solver import SolverConfig, Sources, init_state, make_operators
    from kwave_tpu.streams import StreamSpec, init_stream_states

    data = deployment_c(n, n_sensors=1024)
    ops = make_operators(data.grid, data.medium, data.pml_size, data.pml_alpha,
                         absorbing=True, need_source_kappa=True)
    src = Sources(p_index=data.p_source_index, p_signal=data.p_source_input)
    cfg = SolverConfig(nonlinear=True, absorbing=True, p_source_flag=data.grid.nt,
                       p_source_mode=data.p_source_mode)
    specs = StreamSpec.from_flags({"p_raw": True}, True)
    mask = data.sensor_mask_index.astype(np.int32)
    results = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev), jax.default_matmul_precision("highest"):
            window = make_window_fn(specs, None, cfg, steps, mask.size,
                                    ops=ops, src=src, mask=mask)
            st, _, em = window(init_state(data.grid),
                               init_stream_states(specs, mask.size,
                                                  data.grid.n_elements, None),
                               jnp.int32(0))
            results[dev.platform] = (np.asarray(st.p), np.asarray(st.ux_sgx),
                                     np.asarray(em["p"]))
    gpu, cpu = results["gpu"], results["cpu"]
    rel = [float(np.linalg.norm(g - c) / np.linalg.norm(c)) for g, c in zip(gpu, cpu)]
    if not all(np.isfinite(rel)) or max(rel) > FIELD_REL_TOL:
        raise AssertionError(f"GPU vs CPU rel L2 p {rel[0]:.3e}, ux_sgx {rel[1]:.3e}, "
                             f"sensor p {rel[2]:.3e} > {FIELD_REL_TOL:g}")
    return (f"{n}^3, {steps} steps: GPU vs CPU rel L2 p {rel[0]:.3e}, ux_sgx "
            f"{rel[1]:.3e}, sensor p {rel[2]:.3e} (tol {FIELD_REL_TOL:g})")


def phase_multi(n: int = N_GRID, n_sensors: int = N_SENSORS, devices: int = 4) -> str:
    import jax

    from kwave_tpu import decoder
    from kwave_tpu.basis import MAX_EXP_P, generate_basis

    steps = N_WINDOWS * PERIOD + TAIL
    store = _in_memory_input(deployment_c(n, n_sensors))
    flags = ["--p_raw", "--p_c", "--40-bit_complex", "--p_final", "--harmonics",
             str(HARMONICS), "-s", str(LEAD_IN + 1), "--benchmark", str(LEAD_IN + steps)]
    mesh_out = _run_cli(flags + ["--devices", str(devices)], store)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**20
             for d in jax.devices()[:devices]]
    one_out = _run_cli(flags, store)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    rel_p = rel_l2(np.asarray(mesh_out["p"]), np.asarray(one_out["p"]))
    rel_final = rel_l2(np.asarray(mesh_out["p_final"]), np.asarray(one_out["p_final"]))
    basis = generate_basis(float(PERIOD), 1, HARMONICS, normalize=True)
    dec = [np.stack(decoder.decode_40bit_rows(np.asarray(f["p_c"])[0], HARMONICS,
                                              MAX_EXP_P))
           for f in (mesh_out, one_out)]
    rel_c = float(np.abs(dec[0] - dec[1]).max() / np.abs(dec[1]).max())
    _, rows = _oracle_rows(np.asarray(mesh_out["p"])[0], basis, False, True, True)
    bad = _mismatched_rows(np.asarray(mesh_out["p_c"])[0], rows)
    msg = (f"{n}^3 on {devices} GPUs vs 1: rel L2 raw p {rel_p:.3e}, p_final "
           f"{rel_final:.3e}; decoded p_c max rel diff {rel_c:.3e}; mesh p_c vs oracle "
           f"of its raw p: {bad}/{len(rows)} frames differ; peak MiB per device "
           f"{[round(p, 1) for p in peaks]}")
    if max(rel_p, rel_final, rel_c) > MESH_REL_TOL or bad:
        raise AssertionError(msg)
    if peaks[0] > 1.5 * max(peaks[1:]):
        raise AssertionError(f"device 0 holds more than the others: {msg}")
    return msg


PHASES = {"main": phase_main, "codec": phase_codec, "fields": phase_fields,
          "multi": phase_multi}


def phases_for(multi: bool) -> list[str]:
    """--multi runs the four-GPU comparison alone; the default runs the one-GPU phases."""
    return ["multi"] if multi else ["main", "codec", "fields"]


def _refuse(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh-vs-one-GPU phase")
    args = ap.parse_args(argv)
    try:
        from kwave_tpu.utils import compile_cache
    except ImportError:
        return _refuse("kwave_tpu is not importable: run from the root of a checkout")
    cache = compile_cache.enable()
    import jax

    devs = jax.devices()
    need = 4 if args.multi else 1
    if devs[0].platform != "gpu":
        return _refuse(f"JAX found no GPU (first device: {devs[0]})")
    if len(devs) < need:
        return _refuse(f"needs {need} GPUs, JAX found {len(devs)}")
    try:
        import h5py

        h5 = h5py.__version__
    except ImportError:
        h5 = "not installed (files stay in memory)"
    import jaxlib

    print(f"python {sys.version.split()[0]}, jax {jax.__version__}, jaxlib "
          f"{jaxlib.__version__}, numpy {np.__version__}, h5py {h5}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line)
    print(f"devices: {len(devs)} x {devs[0].device_kind}")

    def entries():
        return sum(1 for p in cache.rglob("*") if p.is_file()) if cache.exists() else 0

    events = {"/jax/compilation_cache/cache_hits": 0,
              "/jax/compilation_cache/cache_misses": 0}

    def count(event, **_):
        if event in events:
            events[event] += 1

    jax.monitoring.register_event_listener(count)
    files_before = entries()
    print(f"compile cache: {cache} ({files_before} files)", flush=True)
    failed = []
    for name in phases_for(args.multi):
        t = time.perf_counter()
        try:
            detail = PHASES[name]()
        except Exception:  # phase boundary: report it, run the rest, exit non-zero
            traceback.print_exc()
            failed.append(name)
            detail = "see the traceback above"
        print(f"phase {name}: {'FAIL' if name in failed else 'PASS'} in "
              f"{time.perf_counter() - t:.1f}s: {detail}", flush=True)
    print(f"compile cache: {cache}: {files_before} files before, {entries()} after; "
          f"{events['/jax/compilation_cache/cache_hits']} hits, "
          f"{events['/jax/compilation_cache/cache_misses']} misses of programs that "
          "took a second or more to compile")
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                             "kind": devs[0].device_kind,
                                             "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

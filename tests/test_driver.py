"""Driver tests: the windowed stream loop vs a plain per-step reference run."""

import numpy as np
import h5py
import pytest

import jax.numpy as jnp

from kwave_tpu import sampling
from kwave_tpu.basis import generate_basis
from kwave_tpu.driver import RunConfig, run_simulation
from kwave_tpu.encoder import encode_series_exact, frames_to_flat_float
from kwave_tpu.io.hdf5 import open_file
from kwave_tpu.io.input_file import InputData
from kwave_tpu.io.memory import MemoryFile
from kwave_tpu.solver import (
    Grid,
    Medium,
    SolverConfig,
    Sources,
    init_state,
    make_operators,
    simulate,
)


def _input(nt=60, n=16):
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    p0 = np.zeros(grid.shape, np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    mask = np.sort(
        np.random.default_rng(3).choice(grid.n_elements, 64, replace=False)
    ).astype(np.int64)
    return InputData(
        grid=grid,
        medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4),
        pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask,
        p0=p0,
    )


def _reference_series(data):
    """Plain per-step run: the ground truth the windowed driver must match exactly.

    Uses the same peeled t==0 structure as the driver (make_p0_init once, then a
    branch-free scan) so the comparison isolates the windowing/stream machinery —
    the peel-vs-cond identity itself is covered bitwise at step granularity by
    tests/test_solver.py::test_p0_peel_matches_cond_path."""
    from kwave_tpu.solver import make_p0_init

    grid = data.grid
    ops = make_operators(grid, data.medium, data.pml_size, data.pml_alpha)
    cfg = SolverConfig()
    src = Sources(p0=jnp.asarray(data.p0))
    mask = jnp.asarray(data.sensor_mask_index.astype(np.int32))
    st0 = make_p0_init(grid, ops, data.p0)
    row0 = sampling.sample_index(st0.p.reshape(-1), mask)
    _, series = simulate(
        st0, ops, src, cfg, grid.nt - 1,
        sample_fn=lambda s: sampling.sample_index(s.p.reshape(-1), mask),
        t0=1,
    )
    return np.concatenate([np.asarray(row0)[None], np.asarray(series)])


@pytest.mark.parametrize("target", ["hdf5", "memory"])
def test_driver_matches_reference_run(tmp_path, target):
    """The same run into an HDF5 file and into an in-memory store (io.memory), which
    stands in for the file where h5py is not installed."""
    data = _input()
    out = str(tmp_path / "out.h5") if target == "hdf5" else MemoryFile()
    run = RunConfig(
        flags=dict(p_raw=True, p_c=True, p_rms=True, p_max=True, p_min=True,
                   p_max_all=True, p_final=True, u_raw=True),
        period=10.0, harmonics=2,
    )
    summary = run_simulation(data, run, out)
    series = _reference_series(data)

    with open_file(out, "r") as f:
        # raw series: windows cover nt//o * o steps; compare that prefix bitwise
        raw = np.asarray(f["p"])[0]
        assert raw.shape == (60, 64)
        np.testing.assert_array_equal(raw, series)

        # compressed stream vs the exact encoder on the reference series
        cb = generate_basis(10.0, 1, 2, normalize=True)
        (f_re, f_im), _ = encode_series_exact(jnp.asarray(series), cb)
        expect = frames_to_flat_float(np.asarray(f_re), np.asarray(f_im))
        got = np.asarray(f["p_c"])[0]
        assert got.shape == expect.shape == (6, 64 * 2 * 2)
        np.testing.assert_array_equal(got, expect)
        assert f["p_c"].attrs["c_period"] == np.float32(10.0)

        # aggregates
        np.testing.assert_allclose(
            np.asarray(f["p_rms"]).reshape(-1),
            np.sqrt(np.mean(series.astype(np.float64) ** 2, axis=0)),
            rtol=2e-5,
        )
        np.testing.assert_array_equal(
            np.asarray(f["p_max"]).reshape(-1), series.max(axis=0)
        )
        np.testing.assert_array_equal(
            np.asarray(f["p_min"]).reshape(-1), series.min(axis=0)
        )
        assert np.asarray(f["p_max_all"]).max() >= series.max()
        assert np.isfinite(np.asarray(f["p_final"])).all()
        assert np.asarray(f["ux"]).shape == (1, 60, 64)


def test_driver_40bit_and_trailing_window(tmp_path):
    """40-bit compressed stream + nt not divisible by o (trailing raw rows)."""
    data = _input(nt=47)
    out = str(tmp_path / "out40.h5")
    run = RunConfig(flags=dict(p_raw=True, p_c=True), period=10.0, harmonics=1,
                    mode40=True)
    run_simulation(data, run, out)
    series = _reference_series(data)
    with h5py.File(out, "r") as f:
        raw = np.asarray(f["p"])[0]
        np.testing.assert_array_equal(raw, series)  # incl. trailing 7 rows
        pc = f["p_c"]
        assert pc.shape == (1, 4, int(np.ceil(64 * 1.25)) * 1)
        assert pc.attrs["c_complex_size"] == np.float32(1.25)
        (hdr, mr, mi), _ = __import__("kwave_tpu.encoder", fromlist=["x"]).encode_series_exact(
            jnp.asarray(series[:40]), generate_basis(10.0, 1, 1), mode40=True
        )
        from kwave_tpu.encoder import frames_to_flat_40b
        expect_bytes = frames_to_flat_40b(np.asarray(hdr), np.asarray(mr), np.asarray(mi))
        got = np.asarray(pc)[0]
        got_bytes = got.view(np.uint8).reshape(4, -1)[:, : expect_bytes.shape[-1]]
        np.testing.assert_array_equal(got_bytes, expect_bytes)


def test_driver_cuboid_mask_and_sampling_start(tmp_path):
    """Cuboid masks produce the reference's group layout: per-cuboid 4D datasets
    "1","2",... (CuboidOutputStream.cpp:656-722), and the written values equal the
    field restricted to each cuboid."""
    data = _input(nt=40)
    data.sensor_mask_index = None
    data.sensor_mask_corners = np.array([[2, 2, 2, 5, 4, 3], [8, 8, 8, 9, 9, 9]])
    out = str(tmp_path / "outc.h5")
    run = RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True), sampling_start=10,
                    period=10.0, harmonics=1)
    run_simulation(data, run, out)
    with h5py.File(out, "r") as f:
        grp = f["p"]
        assert set(grp.keys()) == {"1", "2"}
        assert grp["1"].shape == (30, 2, 3, 4)  # (steps, cz, cy, cx)
        assert grp["2"].shape == (30, 2, 2, 2)
        assert np.abs(np.asarray(grp["1"])).max() > 0
        pc = f["p_c"]
        assert pc["1"].shape == (30 // 10, 2, 3, 4 * 1 * 2)
        assert pc["1"].attrs["c_harmonics"] == 1
        assert np.abs(np.asarray(pc["1"])).max() > 0
        # per-sensor aggregates keep the cuboid group layout too
        rms = f["p_rms"]
        assert isinstance(rms, h5py.Group) and rms["1"].shape == (1, 2, 3, 4)
        want = np.sqrt(np.mean(np.asarray(grp["1"]) ** 2, axis=0))
        np.testing.assert_allclose(np.asarray(rms["1"])[0], want, rtol=1e-5)

    # cross-check cuboid contents against an index-mask run over the same points
    from kwave_tpu.driver import _corners_to_indices

    data2 = _input(nt=40)
    data2.sensor_mask_index = np.sort(
        _corners_to_indices(np.array([[2, 2, 2, 5, 4, 3]]), data2.grid)
    )
    out2 = str(tmp_path / "outi.h5")
    run_simulation(data2, RunConfig(flags=dict(p_raw=True), sampling_start=10), out2)
    with h5py.File(out, "r") as fc, h5py.File(out2, "r") as fi:
        cub = np.asarray(fc["p"]["1"]).reshape(30, -1)
        idx = np.asarray(fi["p"])[0]
        np.testing.assert_array_equal(cub, idx)


def test_driver_2d_end_to_end(tmp_path):
    """2D simulation through the full driver (the reference's SD::k2D path)."""
    grid = Grid(nx=24, ny=24, nz=1, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[12, 12] = 1e5
    mask = np.sort(np.random.default_rng(2).choice(grid.n_elements, 30, replace=False))
    data = InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4), pml_alpha=(2.0, 2.0),
        sensor_mask_index=mask, p0=p0,
    )
    out = str(tmp_path / "out2d.h5")
    run = RunConfig(flags=dict(p_raw=True, p_c=True, u_raw=True, p_max=True),
                    period=10.0, harmonics=2)
    run_simulation(data, run, out)
    series = None
    with h5py.File(out, "r") as f:
        assert np.asarray(f["p"]).shape == (1, 40, 30)
        assert np.asarray(f["p_c"]).shape == (1, 4, 30 * 2 * 2)
        assert "ux" in f and "uy" in f and "uz" not in f
        series = np.asarray(f["p"])[0]
    assert np.isfinite(series).all() and np.abs(series).max() > 0


def test_p0_peel_lead_in_and_tail(tmp_path):
    """The t==0 peel covers every program that can own step 0: the lead-in
    (sampling_start > 0) and the tail (nt < oSize, tiny-record). Outputs must
    match the plain cond-path reference run exactly."""
    import h5py

    # lead-in peel: sampling starts after step 0
    data = _input(nt=40)
    ref = _reference_series(data)
    out = str(tmp_path / "lead.h5")
    run_simulation(data, RunConfig(flags=dict(p_raw=True), sampling_start=10), out)
    with h5py.File(out) as f:
        np.testing.assert_array_equal(np.asarray(f["p"])[0], ref[10:])

    # tail peel: the whole record is shorter than one compression window
    data2 = _input(nt=7)
    ref2 = _reference_series(data2)
    out2 = str(tmp_path / "tail.h5")
    run_simulation(
        data2,
        RunConfig(flags=dict(p_raw=True, p_c=True), period=10.0, harmonics=1),
        out2,
    )
    with h5py.File(out2) as f:
        np.testing.assert_array_equal(np.asarray(f["p"])[0], ref2)
        assert np.abs(np.asarray(f["p_c"])).max() > 0  # forced partial frame emitted


def test_detected_period_cached_in_input_file(tmp_path):
    """Auto-detected period is written back as a `period` attribute on
    p_source_input (Parameters.cpp:508-511) and used on later reads without
    re-running detection."""
    import h5py

    from kwave_tpu import driver as drv
    from kwave_tpu.io.input_file import read_input_file, write_input_file

    grid = Grid(nx=12, ny=12, nz=12, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=30)
    t = np.arange(200, dtype=np.float32)
    sig = (1e5 * np.sin(2 * np.pi * t / 10.0)).astype(np.float32)
    mask = np.arange(1, 20, dtype=np.int64)
    inp = str(tmp_path / "in.h5")
    write_input_file(inp, InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(2, 2, 2), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask,
        p_source_index=np.arange(1, 5, dtype=np.int64),
        p_source_input=sig, p_source_flag=len(sig),
    ))
    data = read_input_file(inp)
    assert data.cached_period is None
    run = RunConfig(flags=dict(p_c=True), harmonics=1)
    period = drv.detect_period(data, run)
    assert period == 10.0
    with h5py.File(inp) as f:
        assert float(f["p_source_input"].attrs["period"]) == 10.0

    # second read carries the cache; detection must not run again
    data2 = read_input_file(inp)
    assert data2.cached_period == 10.0
    import kwave_tpu.basis as basis_mod
    orig = drv.find_period
    drv.find_period = lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("find_period re-ran despite cached attribute"))
    try:
        assert drv.detect_period(data2, run) == 10.0
    finally:
        drv.find_period = orig


def test_cuboid_equals_index_mask_same_points(tmp_path):
    """Cross-subsystem invariant: a cuboid mask and an index mask covering the
    SAME points (in cuboid scan order) produce bit-identical sampled data in
    raw, aggregate, and coefficient streams — only the HDF5 layout differs
    (IndexOutputStream vs CuboidOutputStream parity)."""
    import h5py

    from kwave_tpu.driver import _corners_to_indices

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=30)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    corners = np.array([[2, 3, 4, 6, 7, 8]])  # one 5x5x5 cuboid
    idx = _corners_to_indices(corners, grid).astype(np.int64)
    base = dict(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
                pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3, p0=p0)
    run = RunConfig(flags=dict(p_raw=True, p_rms=True, p_c=True),
                    period=10.0, harmonics=2)
    cub, ind = str(tmp_path / "cub.h5"), str(tmp_path / "idx.h5")
    run_simulation(InputData(**base, sensor_mask_corners=corners), run, cub)
    run_simulation(InputData(**base, sensor_mask_index=idx), run, ind)
    h = 2
    with h5py.File(cub) as fc, h5py.File(ind) as fi:
        np.testing.assert_array_equal(
            np.asarray(fc["p"]["1"]).reshape(30, -1), np.asarray(fi["p"])[0])
        np.testing.assert_array_equal(
            np.asarray(fc["p_rms"]["1"]).reshape(-1),
            np.asarray(fi["p_rms"]).reshape(-1))
        cc = np.asarray(fc["p_c"]["1"])  # [Nc, cz, cy, cx*2H]
        ci = np.asarray(fi["p_c"])[0]    # [Nc, N*2H]
        np.testing.assert_array_equal(cc.reshape(cc.shape[0], -1, 2 * h),
                                      ci.reshape(ci.shape[0], -1, 2 * h))


@pytest.mark.parametrize("case", ["raw", "float_c", "40bit_c", "no_overlap_c",
                                  "aggregates"])
def test_window_program_per_stream_set(case):
    """Each stream set compiles its own window program; each must reproduce the plain
    per-step run on its own: raw rows bit for bit, compressed frames equal to the exact
    encoder on those rows, aggregates equal to NumPy reductions of them."""
    from kwave_tpu.encoder import frames_to_flat_40b

    flags, kw = {
        "raw": (dict(p_raw=True), {}),
        "float_c": (dict(p_raw=True, p_c=True), {}),
        "40bit_c": (dict(p_raw=True, p_c=True), dict(mode40=True)),
        "no_overlap_c": (dict(p_raw=True, p_c=True), dict(no_overlap=True)),
        "aggregates": (dict(p_rms=True, p_max=True, p_min=True), {}),
    }[case]
    data = _input()
    out = MemoryFile()
    run_simulation(data, RunConfig(flags=flags, period=10.0, harmonics=2, **kw), out)
    series = _reference_series(data)
    if "p" in out:
        np.testing.assert_array_equal(np.asarray(out["p"])[0], series)
    if "p_c" in out:
        mode40 = kw.get("mode40", False)
        frames, _ = encode_series_exact(jnp.asarray(series), generate_basis(10.0, 1, 2),
                                        mode40=mode40, overlap=not kw.get("no_overlap"))
        got = np.asarray(out["p_c"])[0]
        if mode40:
            want = frames_to_flat_40b(*(np.asarray(a) for a in frames))
            got = got.view(np.uint8)[:, : want.shape[-1]]
        else:
            want = frames_to_flat_float(*(np.asarray(a) for a in frames))
        np.testing.assert_array_equal(got, want)
    if case == "aggregates":
        np.testing.assert_array_equal(np.asarray(out["p_max"]).reshape(-1),
                                      series.max(axis=0))
        np.testing.assert_array_equal(np.asarray(out["p_min"]).reshape(-1),
                                      series.min(axis=0))
        np.testing.assert_allclose(np.asarray(out["p_rms"]).reshape(-1),
                                   np.sqrt(np.mean(series.astype(np.float64) ** 2, 0)),
                                   rtol=2e-5)

"""Sharded solver step with the pencil FFT vs the single-device step — identical physics."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kwave_tpu.parallel import (
    make_mesh,
    pencil_fft,
    shard_operators,
    shard_state,
)
from kwave_tpu.solver import (
    Grid,
    Medium,
    SolverConfig,
    Sources,
    init_state,
    make_operators,
    simulate,
)


@pytest.fixture
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return make_mesh(8)


def test_pencil_step_matches_local(mesh):
    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=12)
    rng = np.random.default_rng(0)
    c0 = (1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32)
    medium = Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5)
    ops = make_operators(grid, medium, (4, 4, 4), (2.0,) * 3, absorbing=True)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    cfg = SolverConfig(p0_source_flag=True, absorbing=True)
    src = Sources(p0=jnp.asarray(p0))

    ref, _ = simulate(init_state(grid), ops, src, cfg, 10)

    ops_s = shard_operators(ops, 3, mesh, grid=grid, pencil=True)
    state_s = shard_state(init_state(grid), mesh)
    src_s = Sources(p0=jax.device_put(jnp.asarray(p0), state_s.p.sharding))
    fft = pencil_fft(mesh, grid.nx)
    with mesh:
        got, _ = simulate(state_s, ops_s, src_s, cfg, 10, fft=fft)

    np.testing.assert_allclose(np.asarray(got.p), np.asarray(ref.p),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(np.asarray(got.ux_sgx), np.asarray(ref.ux_sgx),
                               rtol=1e-5, atol=1e-8)


def test_sharded_encode_matches_unsharded(mesh):
    """Sensor-sharded codec encode equals the single-device result, and the ordered
    gather returns sensor-index order."""
    from kwave_tpu.basis import generate_basis
    from kwave_tpu.encoder import encode_series_fast
    from kwave_tpu.parallel.distributed import encode_sharded, gather_frames

    cb = generate_basis(10.0, 1, 2, normalize=True)
    rng = np.random.default_rng(0)
    x = (1e5 * rng.standard_normal((40, 64))).astype(np.float32)

    ref_re, ref_im = encode_series_fast(jnp.asarray(x), cb)
    out = encode_sharded(x, cb, mesh)
    got_re, got_im = gather_frames(out, mesh)
    np.testing.assert_allclose(got_re, np.asarray(ref_re), rtol=1e-6, atol=1e-2)
    np.testing.assert_allclose(got_im, np.asarray(ref_im), rtol=1e-6, atol=1e-2)


def test_compact_operators_on_mesh_match_full(mesh):
    """compact=True (lazy per-step kappa/nabla/tau regeneration) under the pencil FFT's
    sharded layout reproduces the precomputed-operator sharded step — validates the
    driver's auto-compact on the multi-chip path (round-2 advisor finding)."""
    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=12)
    rng = np.random.default_rng(1)
    c0 = (1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32)
    medium = Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    cfg = SolverConfig(p0_source_flag=True, absorbing=True)
    fft = pencil_fft(mesh, grid.nx)

    def run(compact):
        ops = make_operators(grid, medium, (4, 4, 4), (2.0,) * 3, absorbing=True,
                             compact=compact)
        ops_s = shard_operators(ops, 3, mesh, grid=grid, pencil=True)
        state_s = shard_state(init_state(grid), mesh)
        src_s = Sources(p0=jax.device_put(jnp.asarray(p0), state_s.p.sharding))
        with mesh:
            st, _ = simulate(state_s, ops_s, src_s, cfg, 10, fft=fft)
        return np.asarray(st.p)

    p_full = run(False)
    p_compact = run(True)
    np.testing.assert_allclose(p_compact, p_full, atol=3e-5 * np.abs(p_full).max())


def test_run_simulation_on_mesh_matches_single(mesh, tmp_path):
    """The full driver on an 8-device mesh (z-sharded fields, pencil FFT, GSPMD rest)
    writes the same output file contents as the single-device run."""
    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(np.random.default_rng(4).choice(grid.n_elements, 40, replace=False))
    data = InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask, p0=p0,
    )
    run = RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                    period=10.0, harmonics=2)

    out1 = str(tmp_path / "single.h5")
    run_simulation(data, run, out1)
    out2 = str(tmp_path / "mesh.h5")
    run_simulation(data, run, out2, mesh=mesh)

    with h5py.File(out1) as f1, h5py.File(out2) as f2:
        for name in ("p", "p_c", "p_rms", "p_max_all"):
            a, b = np.asarray(f1[name]), np.asarray(f2[name])
            scale = max(np.abs(a).max(), 1e-30)
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6 * scale,
                                       err_msg=name)


def test_cuboid_mask_40bit_on_mesh(tmp_path):
    """Cuboid-corner sensor masks through the FULL sharded driver (previously
    only index masks had mesh coverage): per-cuboid groups, padded 40-bit rows,
    and the writer's cuboid assembly all cross the mesh path. Raw/aggregate
    outputs match the single-device run; the 40-bit stream matches at DECODED
    level (per-step requantization amplifies pencil-FFT reassociation noise, so
    byte equality is not expected)."""
    import h5py

    from tests.mp_driver_worker import build_input_cuboid
    from kwave_tpu.decoder import decode_40bit_rows
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.parallel import make_mesh

    # the SAME fixture the 2-process cuboid test runs (single source of truth)
    data = build_input_cuboid()
    run = RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True), period=10.0,
                    harmonics=2, mode40=True)
    single, meshed = str(tmp_path / "s.h5"), str(tmp_path / "m.h5")
    run_simulation(data, run, single)
    run_simulation(data, run, meshed, mesh=make_mesh(4))

    with h5py.File(single) as fa, h5py.File(meshed) as fb:
        for name in ("p", "p_rms"):
            for k in fa[name]:
                a, b = np.asarray(fa[name][k]), np.asarray(fb[name][k])
                assert a.shape == b.shape
                err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
                assert err < 2e-5, (name, k, err)
        for k in fa["p_c"]:
            a, b = np.asarray(fa["p_c"][k]), np.asarray(fb["p_c"][k])
            assert a.shape == b.shape
            h = int(fa["p_c"][k].attrs["c_harmonics"])
            e = int(fa["p_c"][k].attrs["c_max_exp"])
            nf = a.shape[-1]
            ra = decode_40bit_rows(a.reshape(-1, nf), h, e)
            rb = decode_40bit_rows(b.reshape(-1, nf), h, e)
            ca, cb = np.stack(ra), np.stack(rb)
            assert np.abs(ca).max() > 0
            err = np.abs(ca - cb).max() / np.abs(ca).max()
            assert err < 1e-3, (k, err)


def test_nonlinear_all_sources_on_mesh(tmp_path):
    """The full physics surface on a mesh: nonlinear + heterogeneous absorbing
    medium with an additive pressure source, a dirichlet velocity source, AND a
    delayed transducer, through run_simulation — the complete source matrix
    crossing the sharded step (previously only p0 runs had full-driver mesh
    coverage)."""
    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    rng = np.random.default_rng(5)
    medium = Medium(
        c0=(1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
        rho0=(1000.0 + 20.0 * rng.random(grid.shape)).astype(np.float32),
        bona=6.0, alpha_coeff=0.5, alpha_power=1.5,
    )
    t = np.arange(40, dtype=np.float32)
    mask = np.sort(rng.choice(grid.n_elements, 48, replace=False)).astype(np.int64)
    data = InputData(
        grid=grid, medium=medium, nonlinear=True, absorbing=True,
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask,
        p_source_flag=40, p_source_mode=2,
        p_source_index=np.array([1000, 2000, 3000]),
        # file-domain values: the reference injects p_source_input RAW into the
        # density variables (cudaAddPressureSource, SolverCudaKernels.cu:570-629)
        # — the MATLAB toolbox pre-scales by ~1/c^2 before writing, so a 10 kPa
        # drive is ~4e-3 in the file
        p_source_input=(4e-3 * np.sin(2 * np.pi * t / 10)).astype(np.float32),
        u_source_index=np.array([1500, 2500]),
        ux_source_input=(0.005 * np.sin(2 * np.pi * t / 10)).astype(np.float32),
        ux_source_flag=40, u_source_mode=1,
        transducer_source_flag=40,
        transducer_source_input=(0.05 * np.sin(2 * np.pi * t / 8)).astype(np.float32),
        delay_mask=np.array([0, 3]),
    )
    run = RunConfig(flags=dict(p_raw=True, p_c=True, u_raw=True),
                    period=10.0, harmonics=2)
    single, meshed = str(tmp_path / "nl_s.h5"), str(tmp_path / "nl_m.h5")
    run_simulation(data, run, single)
    run_simulation(data, run, meshed, mesh=make_mesh(8))
    with h5py.File(single) as fa, h5py.File(meshed) as fb:
        for name in ("p", "p_c", "ux", "uy", "uz"):
            a, b = np.asarray(fa[name]), np.asarray(fb[name])
            assert a.shape == b.shape, name
            assert np.isfinite(a).all(), f"{name}: unstable config"
            err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
            assert err < 2e-5, (name, err)


def test_nonuniform_grid_driver_on_mesh(tmp_path):
    """Non-uniform grid stretch maps (dxudxn + staggered variants) through the
    FULL driver, single-device vs 8-device mesh — the nonuniform operator fold
    (make_operators(nonuniform=...)) previously had only solver-level identity
    coverage and no mesh coverage at all."""
    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io import names
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=30)
    rng = np.random.default_rng(9)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5

    def stretch(n, seed):
        # mild smooth perturbation around 1 (a real MATLAB-generated map is
        # smooth and near-unity)
        x = np.linspace(0, 2 * np.pi, n, dtype=np.float32)
        return (1.0 + 0.05 * np.sin(x + seed)).astype(np.float32)

    maps = {
        names.DXUDXN: stretch(16, 0.0), names.DXUDXN_SGX: stretch(16, 0.3),
        names.DYUDYN: stretch(16, 1.0), names.DYUDYN_SGY: stretch(16, 1.3),
        names.DZUDZN: stretch(16, 2.0), names.DZUDZN_SGZ: stretch(16, 2.3),
    }
    mask = np.sort(rng.choice(grid.n_elements, 40, replace=False)).astype(np.int64)
    data = InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        nonuniform=True, nonuniform_maps=maps,
        sensor_mask_index=mask, p0=p0,
    )
    run = RunConfig(flags=dict(p_raw=True, p_rms=True))
    single, meshed = str(tmp_path / "nu_s.h5"), str(tmp_path / "nu_m.h5")
    run_simulation(data, run, single)
    run_simulation(data, run, meshed, mesh=make_mesh(8))
    with h5py.File(single) as fa, h5py.File(meshed) as fb:
        for name in ("p", "p_rms"):
            a, b = np.asarray(fa[name]), np.asarray(fb[name])
            assert np.isfinite(a).all() and np.abs(a).max() > 0
            err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
            assert err < 2e-5, (name, err)


def test_2d_grid_on_mesh_fails_actionably(tmp_path):
    """2D + mesh is unsupported by design (z-sharding + pencil FFT are 3D-only;
    2D grids are tiny) — the driver says so instead of dying in an obscure
    device_put divisibility error."""
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=32, ny=32, nz=1, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=10)
    p0 = np.zeros(grid.shape, np.float32)
    p0[16, 16] = 1e5
    data = InputData(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
                     pml_size=(4, 4, 0), pml_alpha=(2.0, 2.0, 0.0),
                     sensor_mask_index=np.arange(10, dtype=np.int64), p0=p0)
    with pytest.raises(ValueError, match="3D grid.*2D"):
        run_simulation(data, RunConfig(flags=dict(p_raw=True)),
                       str(tmp_path / "x.h5"), mesh=make_mesh(8))


def test_sampling_start_on_mesh(tmp_path):
    """-s (sampling_start) on a mesh: the lead-in program, shifted window
    boundaries, and the trailing partial window all run sharded and match the
    single-device run."""
    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(np.random.default_rng(4).choice(grid.n_elements, 40,
                                                   replace=False))
    data = InputData(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
                     pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
                     sensor_mask_index=mask, p0=p0)
    run = RunConfig(flags=dict(p_raw=True, p_c=True), period=10.0, harmonics=2,
                    sampling_start=7)
    single, meshed = str(tmp_path / "ss_s.h5"), str(tmp_path / "ss_m.h5")
    run_simulation(data, run, single)
    run_simulation(data, run, meshed, mesh=make_mesh(8))
    with h5py.File(single) as fa, h5py.File(meshed) as fb:
        for name in ("p", "p_c"):
            a, b = np.asarray(fa[name]), np.asarray(fb[name])
            assert a.shape == b.shape and a.shape[1] in (33, 3)
            err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
            assert err < 2e-5, (name, err)


def test_many_signal_sources(tmp_path):
    """Per-point source columns (p_source_many, CommandLineParameters' u/p_source_many
    file flags) — previously untested anywhere: (a) many=True with identical
    columns is bit-identical to the single-signal path; (b) distinct per-point
    columns match between mesh and single-device."""
    import h5py

    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    rng = np.random.default_rng(2)
    mask = np.sort(rng.choice(grid.n_elements, 40, replace=False)).astype(np.int64)
    t = np.arange(40, dtype=np.float32)
    sig = (4e-3 * np.sin(2 * np.pi * t / 10)).astype(np.float32)
    idx = np.array([1000, 2000, 3000])
    base = dict(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
                pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
                sensor_mask_index=mask)
    run = RunConfig(flags=dict(p_raw=True))

    a_path, b_path = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    run_simulation(InputData(**base, p_source_flag=40, p_source_mode=2,
                             p_source_index=idx, p_source_input=sig),
                   run, a_path)
    run_simulation(InputData(**base, p_source_flag=40, p_source_mode=2,
                             p_source_index=idx,
                             p_source_input=np.stack([sig] * 3),
                             p_source_many=True),
                   run, b_path)
    with h5py.File(a_path) as fa, h5py.File(b_path) as fb:
        np.testing.assert_array_equal(np.asarray(fa["p"]), np.asarray(fb["p"]))
        assert np.abs(np.asarray(fa["p"])).max() > 0

    sigs = np.stack([sig, 0.5 * sig,
                     (4e-3 * np.cos(2 * np.pi * t / 10)).astype(np.float32)])
    data = InputData(**base, p_source_flag=40, p_source_mode=2,
                     p_source_index=idx, p_source_input=sigs,
                     p_source_many=True)
    s_path, m_path = str(tmp_path / "s.h5"), str(tmp_path / "m.h5")
    run_simulation(data, run, s_path)
    run_simulation(data, run, m_path, mesh=make_mesh(8))
    with h5py.File(s_path) as fa, h5py.File(m_path) as fb:
        a, b = np.asarray(fa["p"]), np.asarray(fb["p"])
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert err < 2e-5, err

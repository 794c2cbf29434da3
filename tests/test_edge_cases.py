"""Driver edge cases the reference defines precisely:

- --no_overlap end-to-end (CommandLineParameters --no_overlap; buffer aliasing
  BaseOutputStream.cpp:246-257),
- degenerate-overlap auto-force when the record is shorter than one period
  (Parameters.cpp:141-145),
- tiny-record lastStep partial-frame emission (IndexOutputStream.cpp:455-456),
- trailing-steps accumulation into compressed/aggregate buffers
  (IndexOutputStream.cpp:397-450 runs every sampled step),
- checkpoint consistency validation on resume (KSpaceFirstOrderSolver.cpp:189-228).
"""

import h5py
import numpy as np
import pytest

import jax.numpy as jnp

from kwave_tpu import sampling
from kwave_tpu.basis import generate_basis
from kwave_tpu.driver import RunConfig, run_simulation
from kwave_tpu.encoder import (
    encode_series_exact,
    frames_to_flat_float,
)
from kwave_tpu.io.input_file import InputData
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
        np.random.default_rng(3).choice(grid.n_elements, 48, replace=False)
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
    # peeled t==0 structure, matching the driver (see tests/test_driver.py)
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


@pytest.mark.parametrize("mode40", [False, True])
def test_no_overlap_flag_end_to_end(tmp_path, mode40):
    """A --no_overlap run produces frames bit-identical to the no-overlap oracle."""
    data = _input(nt=60)
    out = str(tmp_path / "out.h5")
    run = RunConfig(flags=dict(p_c=True), period=10.0, harmonics=2,
                    no_overlap=True, mode40=mode40)
    run_simulation(data, run, out)
    series = _reference_series(data)
    cb = generate_basis(10.0, 1, 2, normalize=True)
    frames, _ = encode_series_exact(jnp.asarray(series), cb, mode40=mode40,
                                    overlap=False)
    with h5py.File(out, "r") as f:
        got = np.asarray(f["p_c"])[0]
        if mode40:
            from kwave_tpu.encoder import frames_to_flat_40b

            expect = frames_to_flat_40b(*[np.asarray(a) for a in frames])
            got_b = got.view(np.uint8).reshape(6, -1)[:, : expect.shape[-1]]
            np.testing.assert_array_equal(got_b, expect)
        else:
            expect = frames_to_flat_float(np.asarray(frames[0]), np.asarray(frames[1]))
            np.testing.assert_array_equal(got, expect)


def test_degenerate_overlap_auto_force(tmp_path):
    """period >= Nt - s forces no-overlap (Parameters.cpp:141-145) even without the flag."""
    data = _input(nt=8)  # period 10 > 8 sampled steps
    out = str(tmp_path / "out.h5")
    run = RunConfig(flags=dict(p_c=True), period=10.0, harmonics=1)
    run_simulation(data, run, out)
    series = _reference_series(data)
    cb = generate_basis(10.0, 1, 1, normalize=True)
    frames, _ = encode_series_exact(jnp.asarray(series), cb, overlap=False)
    with h5py.File(out, "r") as f:
        got = np.asarray(f["p_c"])[0]
        assert got.shape[0] == 1  # Nc = max(floor(8/10), 1) = 1
        expect = frames_to_flat_float(np.asarray(frames[0]), np.asarray(frames[1]))
        np.testing.assert_array_equal(got, expect.reshape(1, -1))
        assert np.abs(got).max() > 0  # the partial frame was actually written


def test_tiny_record_overlap_partial_frame(tmp_path):
    """steps <= oSize with overlap still possible (mos=2): lastStep emits buffer2."""
    data = _input(nt=9)
    out = str(tmp_path / "out.h5")
    # period 5, mos 2 -> oSize 10 > 9 steps, but period 5 < 9 so overlap stays on
    run = RunConfig(flags=dict(p_c=True), period=5.0, mos=2, harmonics=1)
    run_simulation(data, run, out)
    series = _reference_series(data)
    cb = generate_basis(5.0, 2, 1, normalize=True)
    frames, _ = encode_series_exact(jnp.asarray(series), cb, overlap=True)
    with h5py.File(out, "r") as f:
        got = np.asarray(f["p_c"])[0]
        expect = frames_to_flat_float(np.asarray(frames[0]), np.asarray(frames[1]))
        np.testing.assert_array_equal(got, expect.reshape(1, -1))
        assert np.abs(got).max() > 0


@pytest.mark.parametrize("mode40", [False, True])
def test_one_window_record_exact_boundary(tmp_path, mode40):
    """nt == oSize with overlap (mos=2): the saving boundary fires at the last step, so
    the frame is emitted exactly ONCE — `mSavingFlag || lastStep` in the reference
    (IndexOutputStream.cpp:454-456) must not become a double emission here."""
    data = _input(nt=20)
    out = str(tmp_path / "out.h5")
    # period 5 < 20 sampled steps, so overlap stays on; oSize = 5*2... use period 10,
    # mos 2 -> oSize 20 == nt, period 10 < 20 keeps overlap on.
    run = RunConfig(flags=dict(p_c=True), period=10.0, mos=2, harmonics=1,
                    mode40=mode40)
    run_simulation(data, run, out)
    series = _reference_series(data)
    cb = generate_basis(10.0, 2, 1, normalize=True)
    frames, _ = encode_series_exact(jnp.asarray(series), cb, mode40=mode40,
                                    overlap=True)
    with h5py.File(out, "r") as f:
        got = np.asarray(f["p_c"])[0]
        assert got.shape[0] == 1  # Nc = max(floor(20/20), 1) = 1
        if mode40:
            from kwave_tpu.encoder import frames_to_flat_40b

            expect = frames_to_flat_40b(*[np.asarray(a) for a in frames])
            got_b = got.view(np.uint8).reshape(got.shape[0], -1)[0, : expect.shape[-1]]
            np.testing.assert_array_equal(got_b, expect.reshape(-1))
        else:
            expect = frames_to_flat_float(np.asarray(frames[0]), np.asarray(frames[1]))
            np.testing.assert_array_equal(got, expect.reshape(1, -1))
        assert np.abs(got).max() > 0


def test_one_window_no_overlap_boundary(tmp_path):
    """nt == oSize with mos=1: degenerate-overlap auto-force (period >= Nt-s) switches to
    no-overlap; the window-loop emission must be the only one (no bogus zero partial)."""
    data = _input(nt=10)
    out = str(tmp_path / "out.h5")
    run = RunConfig(flags=dict(p_c=True), period=10.0, mos=1, harmonics=2)
    run_simulation(data, run, out)
    series = _reference_series(data)
    cb = generate_basis(10.0, 1, 2, normalize=True)
    frames, _ = encode_series_exact(jnp.asarray(series), cb, overlap=False)
    with h5py.File(out, "r") as f:
        got = np.asarray(f["p_c"])[0]
        assert got.shape[0] == 1
        expect = frames_to_flat_float(np.asarray(frames[0]), np.asarray(frames[1]))
        np.testing.assert_array_equal(got, expect.reshape(1, -1))
        assert np.abs(got).max() > 0


def _reference_series_with_shifted(data):
    """(p series, ux_shifted series) sampled at the mask, [T, N] each."""
    from kwave_tpu.solver import shifted_velocity

    grid = data.grid
    ops = make_operators(grid, data.medium, data.pml_size, data.pml_alpha,
                         need_shift=True)
    from kwave_tpu.solver import make_p0_init

    cfg = SolverConfig()  # peeled t==0 structure, matching the driver
    src = Sources(p0=jnp.asarray(data.p0))
    mask = jnp.asarray(data.sensor_mask_index.astype(np.int32))

    def sample_fn(s):
        sh = shifted_velocity(s, ops)
        return (
            sampling.sample_index(s.p.reshape(-1), mask),
            sampling.sample_index(sh[0].reshape(-1), mask),
        )

    st0 = make_p0_init(grid, ops, data.p0)
    row0 = sample_fn(st0)
    _, series = simulate(st0, ops, src, cfg, grid.nt - 1, sample_fn=sample_fn, t0=1)
    return (
        np.concatenate([np.asarray(row0[0])[None], np.asarray(series[0])]),
        np.concatenate([np.asarray(row0[1])[None], np.asarray(series[1])]),
    )


@pytest.mark.parametrize("mode40", [False, True])
def test_one_window_iavg_c_boundary(tmp_path, mode40):
    """The round-2 double-emit repro (period=10, mos=2, nt == oSize == 20, p_c + I_avg_c):
    Ix_avg_c was off by 55% because the tiny-record branch re-fed the frame into the
    intensity accumulator. It must equal exactly one frame's sum_h Re(cP conj(cU))/2."""
    from kwave_tpu.decoder import avg_intensity_frames

    data = _input(nt=20)
    out = str(tmp_path / "out.h5")
    run = RunConfig(flags=dict(p_c=True), i_avg_c=True, period=10.0, mos=2,
                    harmonics=1, mode40=mode40)
    run_simulation(data, run, out)
    p_series, ux_series = _reference_series_with_shifted(data)
    cb = generate_basis(10.0, 2, 1, normalize=True)
    if mode40:
        from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U
        from kwave_tpu import bitpack

        pf, _ = encode_series_exact(jnp.asarray(p_series), cb, mode40=True,
                                    overlap=True)
        uf, _ = encode_series_exact(jnp.asarray(ux_series), cb, shifted=True,
                                    mode40=True, overlap=True)
        p_re, p_im = bitpack.decode40(pf[0][0], pf[1][0], pf[2][0], MAX_EXP_P)
        u_re, u_im = bitpack.decode40(uf[0][0], uf[1][0], uf[2][0], MAX_EXP_U)
        expect = np.asarray(avg_intensity_frames(p_re[None], p_im[None],
                                                 u_re[None], u_im[None]))
    else:
        pf, _ = encode_series_exact(jnp.asarray(p_series), cb, overlap=True)
        uf, _ = encode_series_exact(jnp.asarray(ux_series), cb, shifted=True,
                                    overlap=True)
        expect = np.asarray(avg_intensity_frames(pf[0], pf[1], uf[0], uf[1]))
    with h5py.File(out, "r") as f:
        got = np.asarray(f["Ix_avg_c"]).reshape(-1)
    scale = np.abs(expect).max()
    assert scale > 0
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6 * scale)


def test_trailing_steps_feed_aggregates_and_accumulators(tmp_path):
    """nt not divisible by oSize: rms/max fold ALL sampled steps, and the compressed
    accumulators carry the trailing contribution (visible in the final checkpoint)."""
    data = _input(nt=47)
    out = str(tmp_path / "out.h5")
    ckpt = str(tmp_path / "ck.h5")
    run = RunConfig(flags=dict(p_c=True, p_rms=True, p_max=True, p_min=True),
                    period=10.0, harmonics=1, checkpoint_file=ckpt)
    run_simulation(data, run, out)
    series = _reference_series(data)
    with h5py.File(out, "r") as f:
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
    # oracle state after the full 47 steps (4 full windows + 7 trailing accumulates)
    cb = generate_basis(10.0, 1, 1, normalize=True)
    _, state = encode_series_exact(jnp.asarray(series), cb)
    expect_b1 = frames_to_flat_float(np.asarray(state["acc1_re"]),
                                     np.asarray(state["acc1_im"])).reshape(-1)
    with h5py.File(ckpt, "r") as f:
        got_b1 = np.asarray(f["Temp_p_c_1"]).reshape(-1)
        np.testing.assert_array_equal(got_b1, expect_b1)


def test_checkpoint_grid_mismatch_rejected(tmp_path):
    """A checkpoint written for another grid raises instead of corrupting output."""
    from kwave_tpu.io import checkpoint as ckpt_io
    from kwave_tpu.solver.step import SimState

    data = _input(nt=20)
    bad = str(tmp_path / "bad_ck.h5")
    shp = (8, 8, 8)
    z = np.zeros(shp, np.float32)
    ckpt_io.write_checkpoint(
        bad, SimState(p=z, ux_sgx=z, uy_sgy=z, uz_sgz=z, rho_x=z, rho_y=z, rho_z=z),
        t_index=10, grid_shape=(8, 8, 8),
    )
    out = str(tmp_path / "out.h5")
    with pytest.raises(ValueError, match="grid"):
        run_simulation(data, RunConfig(flags=dict(p_raw=True)), out, resume_from=bad)

"""CLI end-to-end: write input file, run the binary-equivalent entry, check the output."""

import numpy as np
import h5py

from kwave_tpu.cli import main
from kwave_tpu.io.input_file import InputData, write_input_file
from kwave_tpu.solver import Grid, Medium


def test_cli_end_to_end(tmp_path):
    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(np.random.default_rng(0).choice(grid.n_elements, 32, replace=False))
    inp = str(tmp_path / "in.h5")
    out = str(tmp_path / "out.h5")
    write_input_file(inp, InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask, p0=p0,
    ))

    rc = main(["-i", inp, "-o", out, "--p_raw", "--p_c", "--p_max",
               "--period", "10", "--harmonics", "2"])
    assert rc == 0
    with h5py.File(out, "r") as f:
        assert np.asarray(f["p"]).shape == (1, 40, 32)
        assert np.asarray(f["p_c"]).shape == (1, 4, 32 * 2 * 2)
        assert np.abs(np.asarray(f["p"])).max() > 0
        assert f.attrs["file_type"] in (b"output", "output")


def test_cli_benchmark_truncates(tmp_path):
    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=100)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.arange(10, dtype=np.int64)
    inp = str(tmp_path / "in.h5")
    out = str(tmp_path / "out.h5")
    write_input_file(inp, InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask, p0=p0,
    ))
    rc = main(["-i", inp, "-o", out, "-p", "--benchmark", "20"])
    assert rc == 0
    with h5py.File(out, "r") as f:
        assert np.asarray(f["p"]).shape == (1, 20, 10)


def test_cli_post_mode_and_copy_mask(tmp_path):
    """--copy_sensor_mask embeds the mask; --post computes I_avg on the existing output."""
    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(np.random.default_rng(1).choice(grid.n_elements, 24, replace=False))
    inp = str(tmp_path / "in.h5")
    out = str(tmp_path / "out.h5")
    write_input_file(inp, InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask, p0=p0,
    ))
    rc = main(["-i", inp, "-o", out, "--p_raw", "--u_non_staggered_raw",
               "--copy_sensor_mask"])
    assert rc == 0
    with h5py.File(out, "r") as f:
        assert "sensor_mask_index" in f
        assert np.asarray(f["sensor_mask_index"]).min() >= 1

    rc = main(["-i", inp, "-o", out, "--post", "--I_avg", "--Q_term"])
    assert rc == 0
    with h5py.File(out, "r") as f:
        for name in ("Ix_avg", "Iy_avg", "Iz_avg", "Q_term"):
            assert name in f and np.isfinite(np.asarray(f[name])).all()


def test_cli_num_processes_requires_coordinator(capsys):
    """--num_processes without --coordinator/--process_id fails at the parser
    with a message naming the fix (not deep inside jax.distributed)."""
    import pytest

    from kwave_tpu.cli import main

    with pytest.raises(SystemExit):
        main(["-i", "x.h5", "-o", "y.h5", "--p_raw", "--num_processes", "2"])
    err = capsys.readouterr().err
    assert "--coordinator" in err and "--process_id" in err

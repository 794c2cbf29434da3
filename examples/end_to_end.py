"""End-to-end worked example: build an input file, simulate, decode the compressed
stream, reconstruct the sensor series, and verify it against the raw recording.

This is the complete k-Wave workflow without MATLAB: the programmatic input writer
replaces the toolbox's HDF5 generation, the driver replaces kspaceFirstOrder-CUDA,
and the decoder gives you back time series from the windowed-harmonic coefficients
(`p_c`) that the reference can only produce, not consume.

Run: python examples/end_to_end.py [workdir]
(CPU or GPU; ~20 s on CPU. The test suite runs this file, so it stays green.)
"""

import os
import sys
import tempfile

import h5py
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kwave_tpu import decoder  # noqa: E402
from kwave_tpu.basis import generate_basis  # noqa: E402
from kwave_tpu.driver import RunConfig, run_simulation  # noqa: E402
from kwave_tpu.io.input_file import InputData, write_input_file  # noqa: E402
from kwave_tpu.solver import Grid, Medium  # noqa: E402


def main(workdir: str | None = None) -> int:
    workdir = workdir or tempfile.mkdtemp(prefix="kwave_tpu_example_")
    os.makedirs(workdir, exist_ok=True)

    # -- 1. Describe the simulation (what the MATLAB toolbox would do) ---------
    n = 32
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4,
                dt=2e-8, nt=400)
    rng = np.random.default_rng(0)
    medium = Medium(  # heterogeneous speed of sound, absorbing
        c0=(1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
        rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5,
    )
    # Driven tonal source — the codec's production regime (ultrasound at a drive
    # frequency; the compression period matches the source period). A broadband
    # p0 pulse would NOT compress well: windowed harmonics capture tonal fields.
    period = 20.0  # timesteps per source cycle = the compression basis period
    src_plane = n // 4
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    disc = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 <= (n / 6) ** 2
    src_idx = ((src_plane * n + yy[disc]) * n + xx[disc]).astype(np.int64)
    t_sig = np.arange(grid.nt, dtype=np.float32)
    signal = (1e5 * np.sin(2 * np.pi * t_sig / period)).astype(np.float32)
    sensors = np.sort(rng.choice(grid.n_elements, 128, replace=False))

    inp = os.path.join(workdir, "input.h5")
    write_input_file(inp, InputData(
        grid=grid, medium=medium, absorbing=True,
        pml_size=(6, 6, 6), pml_alpha=(2.0,) * 3,
        sensor_mask_index=sensors.astype(np.int64),
        p_source_flag=grid.nt, p_source_mode=1,  # additive-no-correction
        p_source_index=src_idx, p_source_input=signal,
    ))

    # -- 2. Simulate with a raw AND a compressed pressure stream ---------------
    # (equivalently: python -m kwave_tpu.cli -i input.h5 -o output.h5
    #                    --p_raw --p_c --period 20 --harmonics 2)
    out = os.path.join(workdir, "output.h5")
    harmonics = 2
    from kwave_tpu.io.input_file import read_input_file

    summary = run_simulation(
        read_input_file(inp),
        RunConfig(flags=dict(p_raw=True, p_c=True),
                  period=period, harmonics=harmonics),
        out,
    )
    print("datasets written:", {k: tuple(v) for k, v in summary.items()})

    # -- 3. Read the output and decode the compressed stream -------------------
    with h5py.File(out) as f:
        raw = np.asarray(f["p"])[0]          # [Nt, Nsens]
        pc = np.asarray(f["p_c"])[0]         # [Nc, mSize] coefficient frames
        attrs = dict(f["p_c"].attrs)
    n_sens = len(sensors)
    h = int(attrs["c_harmonics"])
    assert attrs["c_period"] == np.float32(period) and h == harmonics

    # frames [Nc, mSize=2*H*Nsens interleaved re/im] -> [Nc, H, N] re/im planes,
    # then the public convenience wrapper does the basis synthesis
    coeffs = pc.reshape(pc.shape[0], n_sens, h, 2)
    f_re = np.transpose(coeffs[..., 0], (0, 2, 1))  # [Nc, H, N]
    f_im = np.transpose(coeffs[..., 1], (0, 2, 1))

    cb = generate_basis(period, 1, harmonics, normalize=True)
    o = cb.o_size
    rec = np.asarray(decoder.reconstruct_series(f_re, f_im, cb, False,
                                                raw.shape[0]))

    # -- 4. Verify: reconstruction matches the raw recording -------------------
    # interior steps only (the first/last window are partially covered by design)
    # compare the steady-state half of the record: the arrival transient at each
    # sensor is broadband (ramp-up) and is not what the tonal codec encodes
    steps = f_re.shape[0] * o
    lo, hi = steps // 2, steps - 2 * o
    scale = np.abs(raw[lo:hi]).max()
    err = np.abs(rec[lo:hi] - raw[lo:hi]).max() / scale
    ratio = raw.size * 4 / pc.nbytes
    print(f"roundtrip rel err {err:.2e} (windowed-harmonic projection), "
          f"compression ratio {ratio:.1f}x")
    assert err < 0.05, err
    print("OK — output at", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))

"""The exact encoder against the NumPy oracle in all 32 stream modes.

float / 40-bit x overlap / no-overlap x pressure / shifted-velocity x H = 1..4, on real-valued
series. On the GPU the match is bit for bit (XLA:GPU rounds every multiply and add
separately, as the reference does; `python chip_smoke.py` checks it at 16,384 sensors). On
the CPU XLA rounds the multiply-adds differently, so here the frames are held to fp32
tolerance: float frames to 1e-5 of the frame scale, decoded 40-bit frames to 1e-3 (a
rounding difference feeds the per-step requantizer, which can move a coefficient by a few
quanta of its 17-bit mantissa).
"""

import numpy as np
import pytest

from kwave_tpu import encoder, oracle
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, generate_basis

PERIOD = 13.4  # non-integer, as the reference allows
N_SENSORS = 96


def _series(steps, n, seed, scale):
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.5, 2.0, n) * scale
    ph = rng.uniform(0, 2 * np.pi, n)
    t = np.arange(steps)[:, None]
    base = amp[None] * np.sin(2 * np.pi * t / PERIOD + ph[None])
    return (base + rng.normal(0, 0.01 * scale, (steps, n))).astype(np.float32)


@pytest.mark.parametrize("harmonics", [1, 2, 3, 4])
@pytest.mark.parametrize("shifted", [False, True], ids=["pressure", "shifted"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no_overlap"])
@pytest.mark.parametrize("mode40", [False, True], ids=["float", "40bit"])
def test_exact_path_matches_oracle(mode40, overlap, shifted, harmonics):
    basis = generate_basis(PERIOD, 1, harmonics)
    # velocity-scale series for the shifted (kMaxExpU) streams, pressure-scale otherwise
    series = _series(6 * basis.o_size + 5, N_SENSORS, seed=harmonics + 10 * shifted,
                     scale=2.0 if shifted else 1e5)
    frames_o = oracle.OracleEncoder(
        basis, N_SENSORS, shifted=shifted, mode40=mode40, overlap=overlap,
        total_steps=series.shape[0],
    ).encode_series(series)
    frames_j, _ = encoder.encode_series_exact(series, basis, shifted=shifted,
                                              mode40=mode40, overlap=overlap)
    assert frames_j[0].shape[0] == len(frames_o) == 6
    e = MAX_EXP_U if shifted else MAX_EXP_P
    for c, fo in enumerate(frames_o):
        if mode40:
            got = oracle.decode40(*(np.asarray(p[c]).T.astype(o.dtype)
                                    for p, o in zip(frames_j, fo)), e)
            want = oracle.decode40(*fo, e)
            tol = 1e-3
        else:
            got = tuple(np.asarray(p[c]).T for p in frames_j)
            want = fo
            tol = 1e-5
        scale = max(np.abs(want[0]).max(), np.abs(want[1]).max(), 1e-30)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol * scale, err_msg=f"frame {c}")

"""Post-processing: time-averaged acoustic intensity and the heat-source Q term.

The reference computes these after the main loop (or in `--post` mode on an existing
output file), reading the stored sensor series back in memory-bounded blocks
(KSpaceFirstOrderSolver.cpp: computeAverageIntensities :1231-1534,
computeAverageIntensitiesC :1543-1775, computeQTerm :1783-2080). Semantics reproduced:

- **Raw-series intensity**: velocity is staggered half a timestep behind pressure, so u is
  time-shifted by +dt/2 spectrally (signed-frequency phase ramp exp(i*pi*shift/steps),
  :1259-1267) before averaging: I = mean_t p * shift(u).
- **Coefficient-space intensity**: I = mean_frames sum_h Re(cP * conj(cU)) / 2 per point —
  no reconstruction needed (:1738-1764). (The decoder also exposes this as
  `decoder.avg_intensity_frames`.)
- **Q term**: scatter the sensor intensities onto the full grid, per-axis spectral
  derivative with plain ik (signed frequencies, :1905-1924), Q = -div(I).

On the device all three are batched jnp programs — the reference's block-streamed cuFFT plan and
OpenMP shift loops become single rfft/irfft expressions over the series.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _signed_freq_index(n_bins: int, n: int) -> np.ndarray:
    """Signed frequency index per rfft bin: ((i + n/2) % n) - n/2 (the reference's shift
    table, KSpaceFirstOrderSolver.cpp:1262-1266)."""
    i = np.arange(n_bins)
    return ((i + n // 2) % n - n // 2).astype(np.float64)


def time_shift_half_step(u_series: jax.Array) -> jax.Array:
    """Shift a velocity time series [T, ...] forward by dt/2 onto pressure sample times:
    rfft over time, multiply exp(i*pi*shift/T), irfft (:1259-1267, applied :1455-1496)."""
    t_steps = u_series.shape[0]
    n_bins = t_steps // 2 + 1
    shift = _signed_freq_index(n_bins, t_steps)
    arg = np.pi * shift / t_steps
    # complex formed on device from float planes — complex64 never crosses host<->device
    # (see operators.pack_complex)
    phase = jax.lax.complex(
        jnp.asarray(np.cos(arg).astype(np.float32)),
        jnp.asarray(np.sin(arg).astype(np.float32)),
    )
    uk = jnp.fft.rfft(u_series, axis=0)
    shape = (n_bins,) + (1,) * (u_series.ndim - 1)
    return jnp.fft.irfft(uk * phase.reshape(shape), n=t_steps, axis=0)


@jax.jit
def avg_intensity_raw(p_series: jax.Array, u_series: jax.Array) -> jax.Array:
    """I[point] = mean_t p[t] * u_shifted[t] (:1498-1517). Series are [T, N]."""
    return jnp.mean(p_series * time_shift_half_step(u_series), axis=0)


def avg_intensity_coeffs(cp_re, cp_im, cu_re, cu_im):
    """Coefficient-space intensity (re-export; decoder.avg_intensity_frames)."""
    from kwave_tpu.decoder import avg_intensity_frames

    return avg_intensity_frames(cp_re, cp_im, cu_re, cu_im)


def _ik_axis(n: int, d: float) -> np.ndarray:
    """Spectral derivative i*k on the rfft-reduced axis with signed frequencies
    (computeQTerm shift tables, :1905-1924). Returned as the imaginary part (float32);
    consumers form i*k on device via lax.complex."""
    n_bins = n // 2 + 1
    shift = _signed_freq_index(n_bins, n)
    return (2.0 * np.pi / d * shift / n).astype(np.float32)


def scatter_to_grid(values: jax.Array, mask: jax.Array, shape: tuple[int, ...]):
    """Sensor values -> full grid (zeros elsewhere) — the Q-term scatter (:1835-1870)."""
    flat = jnp.zeros(int(np.prod(shape)), jnp.float32).at[mask].set(values)
    return flat.reshape(shape)


def q_term(
    ix: jax.Array,
    iy: jax.Array,
    iz: Optional[jax.Array],
    dx: float,
    dy: float,
    dz: float,
) -> jax.Array:
    """Q = -(dIx/dx + dIy/dy [+ dIz/dz]) via per-axis 1D spectral derivatives
    (:1926-2010). Inputs are full-grid [.., ny, nx] fields."""
    ndim = ix.ndim

    def ddx(f, d, axis):
        n = f.shape[axis]
        k_im = jnp.asarray(_ik_axis(n, d))
        op = jax.lax.complex(jnp.zeros_like(k_im), k_im)  # i*k, formed on device
        fk = jnp.fft.rfft(f, axis=axis)
        shp = [1] * ndim
        shp[axis] = op.shape[0]
        return jnp.fft.irfft(fk * op.reshape(shp), n=n, axis=axis)

    q = ddx(ix, dx, ndim - 1) + ddx(iy, dy, ndim - 2)
    if iz is not None:
        q = q + ddx(iz, dz, 0)
    return -q


def q_term_from_intensity(
    output_path: str,
    grid,
    sensor_mask_index: np.ndarray,
    suffix: str = "_c",
) -> None:
    """Q term from already-stored I{x,y,z}_avg<suffix> datasets (the on-the-fly I_avg_c
    accumulation path: computeQTerm consumes the IAvgC streams' data,
    KSpaceFirstOrderSolver.cpp:1016-1030 + :1783-2080)."""
    from kwave_tpu.io import names as dn
    from kwave_tpu.io.hdf5 import create_dataset, is_group, open_file

    is3d = grid.dim == 3
    axes = ("x", "y", "z") if is3d else ("x", "y")
    with open_file(output_path, "r+") as f:

        def read_flat(name):
            obj = f[name]
            if is_group(obj):  # cuboid-layout aggregates
                return np.concatenate([
                    np.asarray(obj[k], np.float32).reshape(-1)
                    for k in sorted(obj.keys(), key=int)
                ])
            return np.asarray(obj, np.float32).reshape(-1)

        i_name = f"Ix_avg{suffix}"
        cuboid_dims = None
        if is_group(f[i_name]):
            grp = f[i_name]
            cuboid_dims = [grp[k].shape[1:] for k in sorted(grp.keys(), key=int)]

        intensities = {a: read_flat(f"I{a}_avg{suffix}") for a in axes}
        mask = jnp.asarray(sensor_mask_index.astype(np.int32))
        fields = [
            scatter_to_grid(jnp.asarray(intensities[a]), mask, grid.shape) for a in axes
        ]
        q = q_term(fields[0], fields[1], fields[2] if is3d else None,
                   grid.dx, grid.dy, grid.dz)
        qs = np.asarray(jnp.take(jnp.asarray(np.asarray(q).reshape(-1)), mask))
        name = dn.Q_TERM + suffix
        if name in f:
            del f[name]
        if cuboid_dims is not None:  # mirror the run's per-cuboid layout
            grp = f.create_group(name)
            off = 0
            for ci, dims in enumerate(cuboid_dims):
                npts = int(np.prod(dims))
                grp.create_dataset(str(ci + 1),
                                   data=qs[off : off + npts].reshape((1,) + tuple(dims))
                                   .astype(np.float32))
                off += npts
        else:
            ds = create_dataset(f, name, (1, 1, qs.shape[0]))
            ds[...] = qs.reshape(1, 1, -1)


# ---------------------------------------------------------------------------
# File-level post-processing (--post mode / end-of-run)
# ---------------------------------------------------------------------------


def _free_device_bytes() -> Optional[int]:
    """Free HBM on the attached accelerator (None on hosts without memory_stats —
    CPU backends report no device distinct from the host)."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and "bytes_limit" in stats:
            return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
    except Exception:
        pass
    return None


def _auto_block_size(avail_bytes: Optional[int] = None,
                     device_bytes: Optional[int] = None) -> int:
    """I/O block size (float elements) when --block_size is absent — the reference
    sizes its post-processing blocks from free host AND device memory
    (KSpaceFirstOrderSolver::computeAverageIntensities,
    KSpaceFirstOrderSolver.cpp:1283-1307: min(host*0.98, device*0.90) / 20).
    Budget: 1/8 of host MemAvailable bounded by 1/4 of free HBM (the blocks are
    staged on device for the fp32 time-shift FFTs — at 512^3 HBM, not host RAM,
    is the binding constraint), capped at 2 GB, floor 8M elements (32 MB).

    `avail_bytes` / `device_bytes` override the probes (tests)."""
    if avail_bytes is None:
        avail_bytes = 2 << 30
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        avail_bytes = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
    if device_bytes is None:
        device_bytes = _free_device_bytes()
    budget = min(avail_bytes // 8, 2 << 30)
    if device_bytes is not None:
        budget = min(budget, device_bytes // 4)
    return max(budget // 4, 8 << 20)


def _cuboid_cx_from_row(row_floats: int, harmonics: int, complex_size: float) -> int:
    """Geometric x extent from a packed coefficient x-row:
    row_floats = ceil(cx * complex_size) * harmonics (CuboidOutputStream.cpp:668-675).
    ceil(cx*cs) is strictly increasing in cx for cs >= 1, so the inverse is unique."""
    nf_h = row_floats // harmonics
    cx = int(nf_h / complex_size)
    while math.ceil((cx + 1) * complex_size) <= nf_h:
        cx += 1
    while cx > 0 and math.ceil(cx * complex_size) > nf_h:
        cx -= 1
    return cx


def post_process_output_file(
    output_path: str,
    grid,
    sensor_mask_index: np.ndarray,
    want_i_avg: bool = True,
    want_q_term: bool = False,
    from_coeffs: bool = False,
    block_size: Optional[int] = None,
) -> None:
    """Compute Ix/Iy/Iz_avg (and Q_term) from an output file holding p/u_non_staggered
    series (raw or compressed) and append the result datasets — the `--post` path
    (main.cpp --post flag; KSpaceFirstOrderSolver::postProcessing :950-1045).

    Coefficient mode reads `*_c` datasets and stays entirely in coefficient space
    (computeAverageIntensitiesC; the reference cannot post-process 40-bit coefficients,
    note :1541 — here the integer unpack is exact on any backend).

    `block_size` bounds the I/O working set, as the reference's --block_size flag
    (CommandLineParameters) and auto-sizing (:1283-1307): it is the maximum number of
    float elements read per hyperslab block; when None it is derived from available
    host memory (`_auto_block_size`). Raw mode blocks over sensor points (the
    half-step time shift needs the full time axis per point); coefficient mode blocks
    over compressed frames (the intensity is a running mean over frames)."""
    if block_size is None:
        block_size = _auto_block_size()

    from kwave_tpu.io.hdf5 import create_dataset, is_group, open_file
    from kwave_tpu.io import names as dn

    is3d = grid.dim == 3
    axes = ("x", "y", "z") if is3d else ("x", "y")
    with open_file(output_path, "r+") as f:
        # fail with a actionable message when the run didn't record the needed series
        # (the reference requires the same inputs: postProcessing :950-1045)
        suffix = dn.COMPRESS_SUFFIX if from_coeffs else ""
        needed = ["p" + suffix] + [f"u{a}_non_staggered{suffix}" for a in axes]
        missing = [nm for nm in needed if nm not in f]
        if missing:
            mode = "coefficient (*_c)" if from_coeffs else "raw"
            raise ValueError(
                f"--post needs the {mode} datasets {missing} in {output_path}; "
                "re-run the simulation with the matching p/u_non_staggered stream "
                "flags (e.g. --p_c --u_non_staggered_c for coefficient mode)"
            )
        # cuboid-mask runs store series as HDF5 groups with per-cuboid datasets "1","2",...
        # (CuboidOutputStream.cpp:656-722); assemble them into the linearized point order
        # (cuboid-concatenated, x fastest — the same order as the sensor mask index list)
        probe_name = ("p" + dn.COMPRESS_SUFFIX) if from_coeffs else dn.P
        is_cuboid = is_group(f[probe_name])
        cuboid_shapes = None  # geometric (cz, cy, cx) per cuboid
        if is_cuboid:
            grp = f[probe_name]
            keys = sorted(grp.keys(), key=int)
            first = grp[keys[0]]
            if from_coeffs:
                h_a = int(first.attrs["c_harmonics"])
                cs_a = float(first.attrs["c_complex_size"])
                cuboid_shapes = [
                    (grp[k].shape[1], grp[k].shape[2],
                     _cuboid_cx_from_row(grp[k].shape[3], h_a, cs_a))
                    for k in keys
                ]
            else:
                cuboid_shapes = [
                    (grp[k].shape[1], grp[k].shape[2], grp[k].shape[3]) for k in keys
                ]

        def read_rows(name, lo, hi):
            """Rows [lo:hi) as [n, Npts*values_per_point] in linearized point order."""
            obj = f[name]
            if not is_cuboid:
                return obj[0, lo:hi]
            parts = []
            for k in sorted(obj.keys(), key=int):
                d = obj[k][lo:hi]  # [n, cz, cy, cx*vpp]
                parts.append(d.reshape(d.shape[0], -1))
            return np.concatenate(parts, axis=1)

        def series_dims(name):
            """(n_rows, values_per_row) of a flat dataset or cuboid group."""
            obj = f[name]
            if not is_cuboid:
                return obj.shape[1], obj.shape[2]
            keys_ = sorted(obj.keys(), key=int)
            return obj[keys_[0]].shape[0], sum(
                int(np.prod(obj[k].shape[1:])) for k in keys_
            )

        def coeff_attrs(name):
            obj = f[name]
            return obj[sorted(obj.keys(), key=int)[0]].attrs if is_cuboid else obj.attrs

        def write_result(name, values):
            """Aggregate [Npts] -> flat dataset or per-cuboid group, mirroring the run's
            layout (the reference's cuboid IAvg/QTerm streams write per-cuboid blocks)."""
            if name in f:
                del f[name]
            if not is_cuboid:
                ds = create_dataset(f, name, (1, 1, values.shape[0]))
                ds[...] = values.reshape(1, 1, -1)
                return
            grp = f.create_group(name)
            off = 0
            for ci, (cz, cy, cx) in enumerate(cuboid_shapes):
                npts = cz * cy * cx
                grp.create_dataset(str(ci + 1), data=values[off : off + npts]
                                   .reshape(1, cz, cy, cx).astype(np.float32))
                off += npts

        if from_coeffs:

            def load_coeffs(name, lo, hi):
                """Frame rows [lo:hi) of a `*_c` dataset/group -> (re, im) [hi-lo, N, H].
                Handles 64-bit interleaved floats and packed 40-bit rows in both index
                and cuboid layouts — the reference's post path cannot post-process
                40-bit at all, note :1541; here the integer unpack is exact on any
                backend."""
                from kwave_tpu import bitpack
                from kwave_tpu.oracle import bytes_to_soa

                attrs = coeff_attrs(name)
                h_ = int(attrs["c_harmonics"])
                cs = float(attrs["c_complex_size"])
                if is_cuboid and cs != 2.0:
                    # 40-bit cuboid rows: per-(z,y) x-rows are PADDED to
                    # ceil(cx*1.25)*H floats, so the generic flatten would smear the
                    # 5-byte fields across padding — strip padding per cuboid first
                    e = int(attrs["c_max_exp"])
                    obj = f[name]
                    parts = ([], [], [])
                    for k, (cz, cy, cx) in zip(sorted(obj.keys(), key=int),
                                               cuboid_shapes):
                        d = np.ascontiguousarray(obj[k][lo:hi])  # [blk, cz, cy, nf]
                        blk_n = d.shape[0]
                        bpr = 5 * cx * h_
                        by = d.reshape(blk_n, cz, cy, -1).view(np.uint8)[..., :bpr]
                        soa = bytes_to_soa(np.ascontiguousarray(by).reshape(-1))
                        for acc, plane in zip(parts, soa):
                            acc.append(plane.reshape(blk_n, cz * cy * cx, h_))
                    hdr, mr, mi = (np.concatenate(p, axis=1) for p in parts)
                    re, im = bitpack.decode40(
                        jnp.asarray(hdr.astype(np.uint32)),
                        jnp.asarray(mr.astype(np.uint32)),
                        jnp.asarray(mi.astype(np.uint32)), e,
                    )
                    return np.asarray(re), np.asarray(im)
                rows = read_rows(name, lo, hi)  # [blk, mSize]
                if cs == 2.0:
                    n_ = rows.shape[1] // (2 * h_)
                    c = rows.reshape(rows.shape[0], n_, h_, 2)
                    return c[..., 0], c[..., 1]
                from kwave_tpu.decoder import decode_40bit_rows

                return decode_40bit_rows(rows, h_, int(attrs["c_max_exp"]))

            n_frames, m_size = series_dims("p" + dn.COMPRESS_SUFFIX)
            blk = max(1, block_size // max(m_size, 1))
            acc = {a: None for a in axes}
            for lo in range(0, n_frames, blk):
                hi = min(lo + blk, n_frames)
                cp_re, cp_im = load_coeffs("p" + dn.COMPRESS_SUFFIX, lo, hi)
                for a in axes:
                    cu_re, cu_im = load_coeffs(
                        f"u{a}_non_staggered" + dn.COMPRESS_SUFFIX, lo, hi
                    )
                    part = np.sum(
                        np.sum(cp_re * cu_re + cp_im * cu_im, axis=2), axis=0
                    )
                    acc[a] = part if acc[a] is None else acc[a] + part
            intensities = {
                a: (acc[a] / n_frames * 0.5).astype(np.float32) for a in axes
            }
        else:
            t_steps, n_sens = series_dims(dn.P)
            intensities = {a: np.empty(n_sens, np.float32) for a in axes}
            if is_cuboid:
                # time blocks don't work (the half-step shift needs the full time axis
                # per point); block per cuboid over z slabs — points within a z slab
                # are contiguous in the linearized order, so each (p, u) block pair is
                # one bounded hyperslab read
                off = 0
                for k, (cz, cy, cx) in zip(sorted(f[dn.P].keys(), key=int),
                                           cuboid_shapes):
                    blk_z = max(1, block_size // max(t_steps * cy * cx, 1))
                    for z0 in range(0, cz, blk_z):
                        z1 = min(z0 + blk_z, cz)
                        lo = off + z0 * cy * cx
                        hi = off + z1 * cy * cx
                        p = jnp.asarray(
                            np.asarray(f[dn.P][k][:, z0:z1]).reshape(t_steps, -1))
                        for a in axes:
                            u = jnp.asarray(
                                np.asarray(f[f"u{a}_non_staggered"][k][:, z0:z1])
                                .reshape(t_steps, -1))
                            intensities[a][lo:hi] = np.asarray(avg_intensity_raw(p, u))
                    off += cz * cy * cx
            else:
                blk = max(1, block_size // max(t_steps, 1))
                for lo in range(0, n_sens, blk):
                    hi = min(lo + blk, n_sens)
                    p = jnp.asarray(f[dn.P][0, :, lo:hi])  # [T, blk]
                    for a in axes:
                        u = jnp.asarray(f[f"u{a}_non_staggered"][0, :, lo:hi])
                        intensities[a][lo:hi] = np.asarray(avg_intensity_raw(p, u))

        if want_i_avg:
            for a in axes:
                name = f"I{a}_avg" + (dn.COMPRESS_SUFFIX if from_coeffs else "")
                write_result(name, intensities[a])

        if want_q_term:
            mask = jnp.asarray(sensor_mask_index.astype(np.int32))
            shape = grid.shape
            fields = [
                scatter_to_grid(jnp.asarray(intensities[a]), mask, shape) for a in axes
            ]
            q = np.asarray(
                q_term(
                    fields[0], fields[1], fields[2] if is3d else None,
                    grid.dx, grid.dy, grid.dz,
                )
            )
            qs = np.asarray(jnp.take(jnp.asarray(q.reshape(-1)), mask))
            name = dn.Q_TERM + (dn.COMPRESS_SUFFIX if from_coeffs else "")
            write_result(name, qs)

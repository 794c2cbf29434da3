"""Spectral / PML / absorption operator precompute for the k-space solver.

Everything the reference builds in `preProcessing` (KSpaceSolver/KSpaceFirstOrderSolver.cpp:784+)
or loads precomputed from the k-Wave input file (Containers/MatrixContainer.cpp:135-166) is
generated here once, on the host in float64, and cast to fp32 device arrays:

- `kappa` — k-space correction sinc(c_ref*dt*k/2) (generateKappa, KSpaceFirstOrderSolver.cpp:2404-2452;
  absorbing variant with nabla operators, generateKappaAndNablas :2511-2581).
- `source_kappa` — cos(c_ref*dt*k/2) for additive sources (generateSourceKappa :2460-2506).
- `absorb_nabla1/2` — |k|^(alpha_power-2), |k|^(alpha_power-1) with inf->0
  (generateKappaAndNablas :2568-2576).
- `absorb_tau/eta` — power-law absorption coefficients (generateTauAndEta :2587-2652).
- `ddx_k_shift_pos/neg` etc. — spectral derivative + half-grid staggering shift
  i*k*exp(+-i*k*d/2) (loaded from file by the reference, MatrixContainer.cpp:135-152; the
  generating formula is the standard k-Wave one, documented in main.cpp's file-format table).
- PML exponential damping profiles, regular and staggered (loaded from file by the reference,
  MatrixContainer.cpp:155-166; formula: k-Wave getPML — absorption ramp alpha_max*(x/L)^4,
  applied as exp(-alpha*c_ref*dt/(2*dx))).
- `dt_rho0_sg*` — dt / rho0 on staggered grids (generateInitialDenisty :2660-2701), staggered
  density computed by linear interpolation when rho0 is heterogeneous.
- `c2` — squared sound speed (computeC2 :2707-2725).

Scalar (homogeneous) media stay 0-d arrays and broadcast — the reference's
scalar/matrix kernel template forks (e.g. SolverCudaKernels.cu:1356-1468) collapse into
numpy broadcasting.

Array layout: fields are ``[nz, ny, nx]`` (or ``[ny, nx]`` in 2D), x fastest — the same
linearization as the reference (Utils/CudaUtils.cuh:82-125). Spectral arrays use
`rfftn`-reduced last (x) axis of size nx//2+1, matching the reference's reduced dims
(Parameters::getReducedDimensionSizes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import jax
import numpy as np


def pack_complex(v: np.ndarray) -> np.ndarray:
    """complex [n] -> float32 [n, 2] (re, im) planes.

    Operators travel host->device as float planes and are recombined into complex64 on
    device with `cvec` inside the compiled program, so no complex buffer crosses the
    host<->device boundary."""
    v = np.asarray(v)
    return np.stack([v.real, v.imag], axis=-1).astype(np.float32)


def cvec(packed) -> jax.Array:
    """Packed float32 [n, 2] (re, im) -> complex64 [n] on device (see pack_complex)."""
    return jax.lax.complex(packed[..., 0], packed[..., 1])


@dataclasses.dataclass(frozen=True)
class Grid:
    """Spatial/temporal discretization. 2D when nz == 1."""

    nx: int
    ny: int
    nz: int  # 1 => 2D
    dx: float
    dy: float
    dz: float
    dt: float
    nt: int

    @property
    def dim(self) -> int:
        return 2 if self.nz == 1 else 3

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.ny, self.nx) if self.dim == 2 else (self.nz, self.ny, self.nx)

    @property
    def n_elements(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def reduced_shape(self) -> tuple[int, ...]:
        r = self.nx // 2 + 1
        return (self.ny, r) if self.dim == 2 else (self.nz, self.ny, r)


@dataclasses.dataclass
class Medium:
    """Material properties; scalars (floats) mean homogeneous.

    Heterogeneous arrays are full-grid ``[nz, ny, nx]``/``[ny, nx]`` float32.
    `rho0_sg*` may be given (the k-Wave input file carries rho0_sgx/sgy/sgz datasets,
    main.cpp file-format table); when None and rho0 is an array, staggered values are
    interpolated; when rho0 is scalar they equal rho0.
    """

    c0: Any  # sound speed [m/s]
    rho0: Any  # ambient density [kg/m^3]
    rho0_sgx: Optional[Any] = None
    rho0_sgy: Optional[Any] = None
    rho0_sgz: Optional[Any] = None
    bona: Optional[Any] = None  # B/A nonlinearity parameter
    alpha_coeff: Optional[Any] = None  # absorption [dB/(MHz^y cm)]
    alpha_power: float = 1.5
    c_ref: Optional[float] = None  # reference sound speed for kappa; default max(c0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Operators:
    """Precomputed device-ready operator pytree (numpy/jnp leaves; dt is static metadata)."""

    kappa: np.ndarray  # [*, nxR] fp32
    ddx_pos: np.ndarray  # [nxR, 2] fp32 re/im planes of i*kx*exp(+i*kx*dx/2) (pack_complex)
    ddx_neg: np.ndarray  # [nxR, 2]
    ddy_pos: np.ndarray  # [ny, 2]
    ddy_neg: np.ndarray
    ddz_pos: Optional[np.ndarray]  # [nz, 2] (3D only)
    ddz_neg: Optional[np.ndarray]
    pml_x: np.ndarray  # [nx] fp32
    pml_y: np.ndarray
    pml_z: Optional[np.ndarray]
    pml_x_sgx: np.ndarray
    pml_y_sgy: np.ndarray
    pml_z_sgz: Optional[np.ndarray]
    dt_rho0_sgx: np.ndarray  # scalar or full fp32: dt / rho0_sgx
    dt_rho0_sgy: np.ndarray
    dt_rho0_sgz: Optional[np.ndarray]
    rho0: np.ndarray  # scalar or full
    c2: np.ndarray  # scalar or full
    bona: Optional[np.ndarray]
    absorb_nabla1: Optional[np.ndarray]  # [*, nxR] fp32
    absorb_nabla2: Optional[np.ndarray]
    absorb_tau: Optional[np.ndarray]  # scalar or full
    absorb_eta: Optional[np.ndarray]
    source_kappa: Optional[np.ndarray]  # [*, nxR] fp32 (additive sources only)
    # half-cell backward shift per axis, rfft-reduced (x_shift_neg_r / y / z;
    # MatrixContainer.cpp:377-388) — for non-staggered velocity sampling;
    # [n, 2] fp32 re/im planes (pack_complex)
    shift_x_neg: Optional[np.ndarray] = None
    shift_y_neg: Optional[np.ndarray] = None
    shift_z_neg: Optional[np.ndarray] = None
    # non-uniform grid stretch maps du/dxi (regular points; dxudxn/dyudyn/dzudzn,
    # MatrixContainer.cpp:310-315); staggered variants are folded into dt_rho0_sg*
    # at build time (generateInitialDenisty, KSpaceFirstOrderSolver.cpp:2660-2701)
    dxudxn: Optional[np.ndarray] = None
    dyudyn: Optional[np.ndarray] = None
    dzudzn: Optional[np.ndarray] = None
    # ---- compact spectral mode (make_operators(compact=True)) ----
    # The big spectral operators (kappa, absorb_nabla1/2, source_kappa) and the
    # c0-derived media fields (c2, absorb_tau/eta) are radially-symmetric functions
    # of |k| / pointwise functions of c0: instead of storing full 3D arrays they are
    # recomputed on device from these per-axis squared-wavenumber vectors (and c0)
    # inside the step — XLA fuses the generation into the spectral multiplies. Saves
    # ~2.3 GB resident HBM at 512^3 heterogeneous absorbing (the reference has no
    # equivalent: it precomputes all of them, KSpaceFirstOrderSolver.cpp:2404-2652).
    k2_x: Optional[np.ndarray] = None  # [nxR] fp32 kx^2 (rfft-reduced)
    k2_y: Optional[np.ndarray] = None  # [ny]
    k2_z: Optional[np.ndarray] = None  # [nz] (3D only)
    c0: Optional[np.ndarray] = None  # compact heterogeneous: c2/tau/eta derive from c0
    alpha2: Optional[np.ndarray] = None  # 2*alpha_coeff*alpha_np (tau/eta prefactor)
    dt: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    c_ref_dt_2: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    alpha_power: float = dataclasses.field(metadata=dict(static=True), default=1.5)


def _k_components(n: int, d: float) -> np.ndarray:
    """Wavenumber magnitude per FFT bin: 2*pi/d * (0.5 - |0.5 - i/n|).

    The reference's folded-index expression (generateKappa,
    KSpaceFirstOrderSolver.cpp:2425-2440) — identical to |2*pi*fftfreq(n, d)| on the
    unreduced axis and directly valid on the rfft-reduced axis.
    """
    i = np.arange(n, dtype=np.float64)
    return 2.0 * np.pi / d * (0.5 - np.abs(0.5 - i / n))


def _k_grid(grid: Grid, reduced: bool = True) -> np.ndarray:
    """|k| over the (reduced) spectral grid, float64."""
    nxr = grid.nx // 2 + 1 if reduced else grid.nx
    kx = _k_components(grid.nx, grid.dx)[:nxr]
    ky = _k_components(grid.ny, grid.dy)
    if grid.dim == 2:
        return np.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
    kz = _k_components(grid.nz, grid.dz)
    return np.sqrt(
        kx[None, None, :] ** 2 + ky[None, :, None] ** 2 + kz[:, None, None] ** 2
    )


def make_kappa(grid: Grid, c_ref: float) -> np.ndarray:
    """sinc k-space correction: sin(c_ref*dt*k/2)/(c_ref*dt*k/2), 1 at k=0
    (generateKappa, KSpaceFirstOrderSolver.cpp:2404-2452)."""
    arg = (c_ref * grid.dt / 2.0) * _k_grid(grid)
    with np.errstate(invalid="ignore"):
        kap = np.where(arg == 0.0, 1.0, np.sin(arg) / np.where(arg == 0, 1.0, arg))
    return kap.astype(np.float32)


def make_source_kappa(grid: Grid, c_ref: float) -> np.ndarray:
    """cos(c_ref*dt*k/2) for additive-source dispersion correction
    (generateSourceKappa, KSpaceFirstOrderSolver.cpp:2460-2506)."""
    return np.cos((c_ref * grid.dt / 2.0) * _k_grid(grid)).astype(np.float32)


def make_absorb_nablas(grid: Grid, alpha_power: float):
    """|k|^(y-2), |k|^(y-1) with inf -> 0 (generateKappaAndNablas :2568-2576)."""
    k = _k_grid(grid)
    with np.errstate(divide="ignore"):
        n1 = k ** (alpha_power - 2.0)
        n2 = k ** (alpha_power - 1.0)
    n1[~np.isfinite(n1)] = 0.0
    n2[~np.isfinite(n2)] = 0.0
    return n1.astype(np.float32), n2.astype(np.float32)


def make_tau_eta(alpha_coeff, c0, alpha_power: float):
    """Power-law absorption tau/eta (generateTauAndEta :2587-2652).

    alpha_np = 100*alpha*(1e-6/(2*pi))^y / (20*log10(e));
    tau = -2*alpha_np * c0^(y-1);  eta = 2*alpha_np * c0^y * tan(pi*y/2).
    """
    alpha_np = (100.0 * (1.0e-6 / (2.0 * np.pi)) ** alpha_power) / (
        20.0 * math.log10(math.e)
    )
    a2 = 2.0 * np.asarray(alpha_coeff, np.float64) * alpha_np
    c = np.asarray(c0, np.float64)
    tau = (-a2) * c ** (alpha_power - 1.0)
    eta = a2 * (c**alpha_power) * math.tan(math.pi / 2.0 * alpha_power)
    return tau.astype(np.float32), eta.astype(np.float32)


def make_ddk_shift(n: int, d: float, reduced: bool):
    """Spectral derivative with half-grid shift: (pos, neg) = i*k*exp(+-i*k*d/2).

    The k-Wave operators the reference loads as ddx_k_shift_pos_r/ddy_k_shift_pos/...
    (MatrixContainer.cpp:135-152; dataset table main.cpp:520-527). Signed wavenumbers
    k = 2*pi*fftfreq(n, d); on the x axis only the rfft-reduced half is kept. The Nyquist
    bin of even-length axes keeps its negative sign (numpy fftfreq convention, matching
    MATLAB's ifftshift((-n/2:n/2-1))-based generation in k-Wave's writeGrid).
    """
    k = 2.0 * np.pi * np.fft.fftfreq(n, d)
    if reduced:
        k = np.abs(k[: n // 2 + 1])  # rfft half-axis: bins 0..n/2 are non-negative freqs
        k[-1] = 2.0 * np.pi * np.fft.fftfreq(n, d)[n // 2] if n % 2 == 0 else k[-1]
    pos = 1j * k * np.exp(1j * k * d / 2.0)
    neg = 1j * k * np.exp(-1j * k * d / 2.0)
    return pack_complex(pos), pack_complex(neg)


def make_shift_neg(n: int, d: float, reduced: bool) -> np.ndarray:
    """Half-cell backward shift operator exp(-i*k*d/2) (x_shift_neg_r etc., loaded from the
    input file by the reference, MatrixContainer.cpp:377-388; used by computeShiftedVelocity,
    KSpaceFirstOrderSolver.cpp:2714-2735, to move staggered velocities onto the regular grid)."""
    k = 2.0 * np.pi * np.fft.fftfreq(n, d)
    if reduced:
        kr = np.abs(k[: n // 2 + 1])
        if n % 2 == 0:
            kr[-1] = k[n // 2]  # Nyquist keeps the negative sign (ifftshift convention)
        k = kr
    return pack_complex(np.exp(-1j * k * d / 2.0))


def make_pml(n: int, size: int, alpha_max: float, c_ref: float, d: float, dt: float,
             staggered: bool):
    """Exponential PML damping profile over one axis (k-Wave getPML).

    Inside the layer the absorption ramps as alpha_max*(x/L)^4 (x measured into the layer,
    in grid points; staggered grids sample at half-point offsets); applied per half-step as
    pml = exp(-alpha * c_ref * dt / (2*dx))  [the operator the reference loads as
    pml_x/pml_x_sgx..., MatrixContainer.cpp:155-166, applied twice per update,
    SolverCudaKernels.cu:178-180].
    """
    x = np.arange(n, dtype=np.float64)
    if staggered:
        x = x + 0.5
    # distance into each layer, in [0, size]
    d_left = np.clip(size - x, 0.0, None) if size > 0 else np.zeros(n)
    d_right = np.clip(x - (n - 1 - size), 0.0, None) if size > 0 else np.zeros(n)
    ramp = np.maximum(d_left, d_right) / max(size, 1)
    alpha = alpha_max * ramp**4
    pml = np.exp(-alpha * c_ref * dt / (2.0 * d))
    pml[ramp == 0.0] = 1.0
    return pml.astype(np.float32)


def _stagger(rho: np.ndarray, axis: int) -> np.ndarray:
    """Half-grid-forward linear interpolation with edge replication (k-Wave's staggered
    rho0 when the input file does not carry precomputed rho0_sg*)."""
    fwd = np.roll(rho, -1, axis=axis)
    idx = [slice(None)] * rho.ndim
    idx[axis] = -1
    fwd[tuple(idx)] = np.take(rho, -1, axis=axis)
    return 0.5 * (rho + fwd)


def make_operators(
    grid: Grid,
    medium: Medium,
    pml_size: tuple[int, ...] = (20, 20, 20),
    pml_alpha: tuple[float, ...] = (2.0, 2.0, 2.0),
    absorbing: bool = False,
    need_source_kappa: bool = False,
    need_shift: bool = False,
    nonuniform: Optional[dict] = None,
    compact: bool = False,
) -> Operators:
    """Build the full operator set for one simulation (reference preProcessing,
    KSpaceFirstOrderSolver.cpp:784-861).

    ``compact=True`` skips materializing the radially-symmetric spectral arrays
    (kappa/source_kappa/absorb_nabla1/2) and, for heterogeneous media, the
    c0-derived fields (c2, absorb_tau/eta): the solver step regenerates them on
    device from the per-axis k^2 vectors and c0 (step._kappa & co). Saves ~2.3 GB
    resident HBM at 512^3 heterogeneous absorbing at the cost of a few fused VPU
    transcendentals per spectral point; results agree to fp32 rounding.
    """
    c0 = np.asarray(medium.c0, np.float64)
    c_ref = float(medium.c_ref) if medium.c_ref is not None else float(c0.max())
    dim = grid.dim

    k2_x = k2_y = k2_z = None
    compact_c0 = alpha2 = None
    if compact:
        kappa = None
        nabla1 = nabla2 = None
        k2_x = (_k_components(grid.nx, grid.dx)[: grid.nx // 2 + 1] ** 2).astype(
            np.float32
        )
        k2_y = (_k_components(grid.ny, grid.dy) ** 2).astype(np.float32)
        if dim == 3:
            k2_z = (_k_components(grid.nz, grid.dz) ** 2).astype(np.float32)
        if absorbing:
            alpha_np = (
                100.0 * (1.0e-6 / (2.0 * np.pi)) ** medium.alpha_power
            ) / (20.0 * math.log10(math.e))
            alpha2 = np.asarray(
                2.0 * np.asarray(medium.alpha_coeff, np.float64) * alpha_np, np.float32
            )
            tau = eta = None
        else:
            tau = eta = None
        compact_c0 = c0.astype(np.float32)
    elif absorbing:
        kappa = make_kappa(grid, c_ref)  # generateKappaAndNablas shares the formula
        nabla1, nabla2 = make_absorb_nablas(grid, medium.alpha_power)
        tau, eta = make_tau_eta(medium.alpha_coeff, medium.c0, medium.alpha_power)
    else:
        kappa = make_kappa(grid, c_ref)
        nabla1 = nabla2 = tau = eta = None

    ddx_pos, ddx_neg = make_ddk_shift(grid.nx, grid.dx, reduced=True)
    ddy_pos, ddy_neg = make_ddk_shift(grid.ny, grid.dy, reduced=False)
    if dim == 3:
        ddz_pos, ddz_neg = make_ddk_shift(grid.nz, grid.dz, reduced=False)
    else:
        ddz_pos = ddz_neg = None

    psz = tuple(pml_size) + (0,) * (3 - len(tuple(pml_size)))
    pal = tuple(pml_alpha) + (0.0,) * (3 - len(tuple(pml_alpha)))
    pml_x = make_pml(grid.nx, psz[0], pal[0], c_ref, grid.dx, grid.dt, False)
    pml_y = make_pml(grid.ny, psz[1], pal[1], c_ref, grid.dy, grid.dt, False)
    pml_x_sgx = make_pml(grid.nx, psz[0], pal[0], c_ref, grid.dx, grid.dt, True)
    pml_y_sgy = make_pml(grid.ny, psz[1], pal[1], c_ref, grid.dy, grid.dt, True)
    if dim == 3:
        pml_z = make_pml(grid.nz, psz[2], pal[2], c_ref, grid.dz, grid.dt, False)
        pml_z_sgz = make_pml(grid.nz, psz[2], pal[2], c_ref, grid.dz, grid.dt, True)
    else:
        pml_z = pml_z_sgz = None

    rho0 = np.asarray(medium.rho0, np.float32)

    def sg(given, axis):
        if given is not None:
            return np.asarray(given, np.float32)
        if rho0.ndim == 0:
            return rho0
        return _stagger(rho0.astype(np.float64), axis).astype(np.float32)

    # axis order [z, y, x] (or [y, x] in 2D): x is the last axis
    ax_x, ax_y, ax_z = (dim - 1, dim - 2, 0)
    rho0_sgx = sg(medium.rho0_sgx, ax_x)
    rho0_sgy = sg(medium.rho0_sgy, ax_y)
    rho0_sgz = sg(medium.rho0_sgz, ax_z) if dim == 3 else None

    dt = np.float32(grid.dt)
    dt_rho0_sgx = (dt / rho0_sgx).astype(np.float32)
    dt_rho0_sgy = (dt / rho0_sgy).astype(np.float32)
    dt_rho0_sgz = (dt / rho0_sgz).astype(np.float32) if dim == 3 else None

    dxudxn = dyudyn = dzudzn = None
    if nonuniform:
        # staggered stretch maps fold into dt/rho0_sg (dtRho0Sg = dt*dxudxnSgx/rho0,
        # generateInitialDenisty :2685-2694); regular maps scale the velocity gradients
        def vec(name, n):
            v = nonuniform.get(name)
            return None if v is None else np.asarray(v, np.float32).reshape(n)

        sgx = vec("dxudxn_sgx", grid.nx)
        sgy = vec("dyudyn_sgy", grid.ny)
        sgz = vec("dzudzn_sgz", grid.nz) if dim == 3 else None
        bx = (1,) * (dim - 1) + (grid.nx,)
        by = (1,) * (dim - 2) + (grid.ny,) + (1,)
        if sgx is not None:
            dt_rho0_sgx = (dt_rho0_sgx * sgx.reshape(bx)).astype(np.float32)
        if sgy is not None:
            dt_rho0_sgy = (dt_rho0_sgy * sgy.reshape(by)).astype(np.float32)
        if dim == 3 and sgz is not None:
            dt_rho0_sgz = (
                dt_rho0_sgz * sgz.reshape(grid.nz, 1, 1)
            ).astype(np.float32)
        dxudxn = vec("dxudxn", grid.nx)
        dyudyn = vec("dyudyn", grid.ny)
        dzudzn = vec("dzudzn", grid.nz) if dim == 3 else None

    c2 = None if compact else (c0 * c0).astype(np.float32)
    bona = None if medium.bona is None else np.asarray(medium.bona, np.float32)

    return Operators(
        kappa=kappa,
        ddx_pos=ddx_pos,
        ddx_neg=ddx_neg,
        ddy_pos=ddy_pos,
        ddy_neg=ddy_neg,
        ddz_pos=ddz_pos,
        ddz_neg=ddz_neg,
        pml_x=pml_x,
        pml_y=pml_y,
        pml_z=pml_z,
        pml_x_sgx=pml_x_sgx,
        pml_y_sgy=pml_y_sgy,
        pml_z_sgz=pml_z_sgz,
        dt_rho0_sgx=dt_rho0_sgx,
        dt_rho0_sgy=dt_rho0_sgy,
        dt_rho0_sgz=dt_rho0_sgz,
        rho0=rho0,
        c2=c2,
        bona=bona,
        absorb_nabla1=nabla1,
        absorb_nabla2=nabla2,
        absorb_tau=tau,
        absorb_eta=eta,
        source_kappa=(
            make_source_kappa(grid, c_ref)
            if need_source_kappa and not compact
            else None
        ),
        shift_x_neg=make_shift_neg(grid.nx, grid.dx, True) if need_shift else None,
        shift_y_neg=make_shift_neg(grid.ny, grid.dy, True) if need_shift else None,
        shift_z_neg=make_shift_neg(grid.nz, grid.dz, True) if need_shift and dim == 3
        else None,
        dxudxn=dxudxn,
        dyudyn=dyudyn,
        dzudzn=dzudzn,
        k2_x=k2_x,
        k2_y=k2_y,
        k2_z=k2_z,
        c0=compact_c0,
        alpha2=alpha2,
        dt=float(grid.dt),
        c_ref_dt_2=float(c_ref * grid.dt / 2.0),
        alpha_power=float(medium.alpha_power),
    )

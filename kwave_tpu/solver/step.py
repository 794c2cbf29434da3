"""The k-space first-order timestep as a pure jittable function + lax.scan main loop.

One `step` call reproduces one iteration of the reference main loop
(KSpaceFirstOrderSolver::computeMainLoop, KSpaceSolver/KSpaceFirstOrderSolver.cpp:864-943):

  velocity update -> velocity source -> transducer source -> velocity gradient ->
  density update (linear|nonlinear) -> pressure source -> pressure update
  (lossless|absorbing x linear|nonlinear) -> [t==0: initial pressure source].

All spectral work is jnp.fft rfftn/irfftn (XLA-planned; the reference's cuFFT plan cache,
MatrixClasses/CufftComplexMatrix.cpp, has no equivalent state here). Elementwise updates are
plain jnp expressions — XLA fuses them into the FFT pipeline, replacing the reference's 31
hand-written CUDA kernels (SolverCudaKernels.cu).

Heterogeneous vs homogeneous media need no code forks (the reference template-instantiates
per-case kernels, e.g. SolverCudaKernels.cu:1356-1566): scalar operators are 0-d arrays and
broadcast.

Fields are fp32 ``[nz, ny, nx]`` (``[ny, nx]`` in 2D), x fastest. The scan carries the
7-field state the reference checkpoints (MatrixContainer.cpp:29-42: p, rhoX/Y/Z, uxSgx/
uySgy/uzSgz).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from kwave_tpu.solver.operators import Grid, Operators, cvec


# Source modes (Parameters.h:73-81).
DIRICHLET = 0
ADDITIVE_NO_CORRECTION = 1
ADDITIVE = 2


class FftOps(NamedTuple):
    """Pluggable spectral transform pair: local jnp.fft (cuFFT on a GPU) by default; the
    distributed pencil FFT (kwave_tpu.parallel.fft) for sharded multi-device runs."""

    rfftn: Callable[[jax.Array], jax.Array]
    irfftn: Callable[[jax.Array, tuple[int, ...]], jax.Array]  # (xk, real_shape) -> x


LOCAL_FFT = FftOps(
    rfftn=jnp.fft.rfftn,
    irfftn=lambda xk, shape: jnp.fft.irfftn(xk, s=shape),
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """The time-marched fields (the 7 checkpointed matrices, MatrixContainer.cpp:29-42)."""

    p: jax.Array
    ux_sgx: jax.Array
    uy_sgy: jax.Array
    uz_sgz: Optional[jax.Array]
    rho_x: jax.Array
    rho_y: jax.Array
    rho_z: Optional[jax.Array]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Sources:
    """Source terms; any member may be None (flags live in SolverConfig, jit-static).

    Signals are ``[T]`` (many=False) or ``[n_idx, T]`` (many=True — per-point series,
    u_source_many/p_source_many flags, main.cpp file-format table). Indices are 0-based flat
    indices into the x-fastest flattened grid (the reference rebases MATLAB 1-based masks at
    load, MatrixClasses/IndexMatrix.h:115-117).
    """

    p0: Optional[jax.Array] = None  # initial pressure [grid]
    p_index: Optional[jax.Array] = None  # [n]
    p_signal: Optional[jax.Array] = None  # [T] or [n, T]
    u_index: Optional[jax.Array] = None
    ux_signal: Optional[jax.Array] = None
    uy_signal: Optional[jax.Array] = None
    uz_signal: Optional[jax.Array] = None
    transducer_index: Optional[jax.Array] = None  # [n]
    transducer_signal: Optional[jax.Array] = None  # [T_sig]
    delay_mask: Optional[jax.Array] = None  # [n] per-element delays


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static (trace-time) solver switches — the reference's Parameters flag surface
    (Parameters/Parameters.h; CommandLineParameters.cpp)."""

    nonlinear: bool = False
    absorbing: bool = False
    p0_source_flag: bool = False
    p_source_flag: int = 0  # #steps the source is active (0 = off)
    p_source_mode: int = DIRICHLET
    p_source_many: bool = False
    u_source_flag: int = 0
    u_source_mode: int = DIRICHLET
    u_source_many: bool = False
    transducer_source_flag: int = 0
    sampling_start_index: int = 0  # -s flag (1-based in CLI; 0-based here)


def init_state(grid: Grid) -> SimState:
    """All-zero fields (the reference zeroes device matrices at allocation).

    Each field gets its OWN buffer — the jitted loops donate the state, and donating one
    buffer through several pytree leaves is rejected (`donate(a), donate(a)`)."""
    z = lambda: jnp.zeros(grid.shape, jnp.float32)  # noqa: E731
    is3d = grid.dim == 3
    return SimState(
        p=z(),
        ux_sgx=z(),
        uy_sgy=z(),
        uz_sgz=z() if is3d else None,
        rho_x=z(),
        rho_y=z(),
        rho_z=z() if is3d else None,
    )


# ---------------------------------------------------------------------------
# Spectral helpers
# ---------------------------------------------------------------------------


def _bc(vec: jax.Array, axis_from_end: int, ndim: int) -> jax.Array:
    """Reshape a per-axis operator vector for broadcasting over an ndim-D array."""
    shape = [1] * ndim
    shape[ndim - 1 - axis_from_end] = vec.shape[0]
    return vec.reshape(shape)


# ---------------------------------------------------------------------------
# Compact-operator accessors: when make_operators(compact=True) left the big
# radially-symmetric spectral arrays / c0-derived media fields as None, rebuild
# them on device from the per-axis k^2 vectors (and c0). XLA fuses the generation
# into the consuming spectral multiplies; the host-precompute variants
# (KSpaceFirstOrderSolver.cpp:2404-2652) stay bit-preferred when present.
# ---------------------------------------------------------------------------


def _k_mag(ops: Operators, ndim: int) -> jax.Array:
    """|k| over the reduced spectral grid from the compact per-axis k^2 vectors."""
    k2 = _bc(ops.k2_x, 0, ndim) + _bc(ops.k2_y, 1, ndim)
    if ndim == 3:
        k2 = k2 + _bc(ops.k2_z, 2, ndim)
    return jnp.sqrt(k2)


def _kappa(ops: Operators, ndim: int) -> jax.Array:
    """sinc k-space correction (generateKappa :2404-2452), lazy in compact mode."""
    if ops.kappa is not None:
        return ops.kappa
    arg = jnp.float32(ops.c_ref_dt_2) * _k_mag(ops, ndim)
    return jnp.where(arg == 0.0, 1.0, jnp.sin(arg) / jnp.where(arg == 0.0, 1.0, arg))


def _source_kappa_op(ops: Operators, ndim: int) -> jax.Array:
    """cos(c_ref*dt*k/2) (generateSourceKappa :2460-2506), lazy in compact mode."""
    if ops.source_kappa is not None:
        return ops.source_kappa
    return jnp.cos(jnp.float32(ops.c_ref_dt_2) * _k_mag(ops, ndim))


def _absorb_nablas(ops: Operators, ndim: int):
    """|k|^(y-2), |k|^(y-1) with the k=0 pole zeroed (generateKappaAndNablas
    :2568-2576), lazy in compact mode."""
    if ops.absorb_nabla1 is not None:
        return ops.absorb_nabla1, ops.absorb_nabla2
    k = _k_mag(ops, ndim)
    safe = jnp.where(k == 0.0, 1.0, k)
    n1 = jnp.where(k == 0.0, 0.0, safe ** jnp.float32(ops.alpha_power - 2.0))
    n2 = jnp.where(k == 0.0, 0.0, safe ** jnp.float32(ops.alpha_power - 1.0))
    return n1, n2


def _c2_op(ops: Operators) -> jax.Array:
    """c^2 (computeC2 :2707-2725) — derived from c0 in compact heterogeneous mode."""
    return ops.c2 if ops.c2 is not None else ops.c0 * ops.c0


def _tau_eta_op(ops: Operators):
    """Power-law absorption tau/eta (generateTauAndEta :2587-2652), lazy from
    (alpha2 = 2*alpha_coeff*alpha_np, c0) in compact heterogeneous mode."""
    if ops.absorb_tau is not None:
        return ops.absorb_tau, ops.absorb_eta
    ap = float(ops.alpha_power)
    tau = -ops.alpha2 * ops.c0 ** jnp.float32(ap - 1.0)
    eta = (
        ops.alpha2
        * (ops.c0 ** jnp.float32(ap))
        * jnp.float32(math.tan(math.pi / 2.0 * ap))
    )
    return tau, eta


def _grad_fields(field: jax.Array, ops: Operators, ddx, ddy, ddz, shape,
                 fft: FftOps = LOCAL_FFT):
    """ifftn(dd*_k_shift * kappa * fftn(field)) for each axis — the shared pattern of
    computePressureGradient (SolverCudaKernels.cu:1139-1199) and computeVelocityGradient
    (:1210-1343), fused with the surrounding FFTs (KSpaceFirstOrderSolver.cpp:2087-2150).

    The per-axis operators arrive as packed float (re, im) planes (operators.pack_complex)
    and become complex64 only here, on device."""
    ndim = field.ndim
    fk = fft.rfftn(field)
    fk = fk * _kappa(ops, ndim)
    specs = [fk * _bc(cvec(ddx), 0, ndim), fk * _bc(cvec(ddy), 1, ndim)]
    if ddz is not None:
        specs.append(fk * _bc(cvec(ddz), 2, ndim))
    grads = [fft.irfftn(sp, shape) for sp in specs]
    return grads[0], grads[1], (grads[2] if ddz is not None else None)


def _source_value(signal: jax.Array, t, many: bool, n: int) -> jax.Array:
    """Signal sample(s) at timestep t: scalar broadcast or per-point column."""
    if many:
        return lax.dynamic_index_in_dim(signal, t, axis=1, keepdims=False)  # [n]
    return jnp.broadcast_to(lax.dynamic_index_in_dim(signal, t, keepdims=False), (n,))


def _apply_point_source(field, index, value, mode: int):
    """Dirichlet replaces, additive modes add (SolverCudaKernels addPressureSource /
    addVelocitySource kernels; mode semantics Parameters.h:73-81)."""
    flat = field.reshape(-1)
    if mode == DIRICHLET:
        flat = flat.at[index].set(value)
    else:
        flat = flat.at[index].add(value)
    return flat.reshape(field.shape)


def _scale_additive_source(index, value, ops: Operators, shape, fft: FftOps = LOCAL_FFT):
    """Additive-mode source dispersion correction: scatter to the full grid, multiply by
    source_kappa in k-space, inverse transform (KSpaceFirstOrderSolver::scaleSource,
    KSpaceFirstOrderSolver.cpp:2339-2354)."""
    scaled = jnp.zeros(shape, jnp.float32).reshape(-1).at[index].set(value).reshape(shape)
    sk = fft.rfftn(scaled) * _source_kappa_op(ops, len(shape))
    return fft.irfftn(sk, shape)


# ---------------------------------------------------------------------------
# The timestep
# ---------------------------------------------------------------------------


def step(
    state: SimState,
    t: jax.Array,
    ops: Operators,
    src: Sources,
    cfg: SolverConfig,
    fft: FftOps = LOCAL_FFT,
) -> SimState:
    """One main-loop iteration (computeMainLoop body, KSpaceFirstOrderSolver.cpp:885-935)."""
    is3d = state.uz_sgz is not None
    shape = state.p.shape
    ndim = state.p.ndim

    # -- velocity update (computeVelocity :2087-2119; kernel SolverCudaKernels.cu:184-216):
    # u = pml_sg * (pml_sg * u - dt/rho0_sg * ifft(ddk_pos * kappa * fft(p)))
    dpx, dpy, dpz = _grad_fields(
        state.p, ops, ops.ddx_pos, ops.ddy_pos, ops.ddz_pos, shape, fft
    )
    pml_x_sg = _bc(ops.pml_x_sgx, 0, ndim)
    pml_y_sg = _bc(ops.pml_y_sgy, 1, ndim)
    ux = (state.ux_sgx * pml_x_sg - ops.dt_rho0_sgx * dpx) * pml_x_sg
    uy = (state.uy_sgy * pml_y_sg - ops.dt_rho0_sgy * dpy) * pml_y_sg
    if is3d:
        pml_z_sg = _bc(ops.pml_z_sgz, 2, ndim)
        uz = (state.uz_sgz * pml_z_sg - ops.dt_rho0_sgz * dpz) * pml_z_sg
    else:
        uz = None

    # -- velocity source (addVelocitySource :2252-2303)
    if cfg.u_source_flag > 0:
        def add_u(u, signal):
            val = _source_value(signal, t, cfg.u_source_many, src.u_index.shape[0])
            if cfg.u_source_mode == ADDITIVE:
                return u + _scale_additive_source(src.u_index, val, ops, shape, fft)
            return _apply_point_source(u, src.u_index, val, cfg.u_source_mode)

        active = t < cfg.u_source_flag
        if src.ux_signal is not None:
            ux = jnp.where(active, add_u(ux, src.ux_signal), ux)
        if src.uy_signal is not None:
            uy = jnp.where(active, add_u(uy, src.uy_signal), uy)
        if is3d and src.uz_signal is not None:
            uz = jnp.where(active, add_u(uz, src.uz_signal), uz)

    # -- transducer source (addTransducerSource kernel; delay mask per element)
    if cfg.transducer_source_flag > 0:
        sig_at = src.transducer_signal[src.delay_mask + t]
        ux = jnp.where(
            t < cfg.transducer_source_flag,
            _apply_point_source(ux, src.transducer_index, sig_at, ADDITIVE_NO_CORRECTION),
            ux,
        )

    # -- velocity gradient (computeVelocityGradient :2126-2150): per-axis
    # duxdx = ifft(ddx_neg * kappa * fft(ux)) etc.
    kap = _kappa(ops, ndim)
    du_specs = [fft.rfftn(ux) * kap * _bc(cvec(ops.ddx_neg), 0, ndim),
                fft.rfftn(uy) * kap * _bc(cvec(ops.ddy_neg), 1, ndim)]
    if is3d:
        du_specs.append(fft.rfftn(uz) * kap * _bc(cvec(ops.ddz_neg), 2, ndim))
    du = [fft.irfftn(sp, shape) for sp in du_specs]
    duxdx, duydy = du[0], du[1]
    if is3d:
        duzdz = du[2]
    # non-uniform grid: scale gradients by the stretch maps (the nonuniform variant of
    # cudaComputeVelocityGradient — MATLAB duxdx = dxudxn .* real(ifft(...)))
    if ops.dxudxn is not None:
        duxdx = duxdx * _bc(ops.dxudxn, 0, ndim)
    if ops.dyudyn is not None:
        duydy = duydy * _bc(ops.dyudyn, 1, ndim)
    if is3d and ops.dzudzn is not None:
        duzdz = duzdz * _bc(ops.dzudzn, 2, ndim)

    # -- density update (computeDensityNonliner/Linear :2157-2173; kernels :1358/:1470)
    pml_x = _bc(ops.pml_x, 0, ndim)
    pml_y = _bc(ops.pml_y, 1, ndim)
    pml_z = _bc(ops.pml_z, 2, ndim) if is3d else None
    dt_f = jnp.float32(ops.dt)
    if cfg.nonlinear:
        rho_sum_old = state.rho_x + state.rho_y + (state.rho_z if is3d else 0.0)
        rho0_plus = 2.0 * rho_sum_old + ops.rho0
        rx = pml_x * (pml_x * state.rho_x - dt_f * rho0_plus * duxdx)
        ry = pml_y * (pml_y * state.rho_y - dt_f * rho0_plus * duydy)
        rz = pml_z * (pml_z * state.rho_z - dt_f * rho0_plus * duzdz) if is3d else None
    else:
        rx = pml_x * (pml_x * state.rho_x - dt_f * ops.rho0 * duxdx)
        ry = pml_y * (pml_y * state.rho_y - dt_f * ops.rho0 * duydy)
        rz = pml_z * (pml_z * state.rho_z - dt_f * ops.rho0 * duzdz) if is3d else None

    # -- pressure source (addPressureSource :2310-2333): applied to the split densities
    if cfg.p_source_flag > 0:
        val = _source_value(src.p_signal, t, cfg.p_source_many, src.p_index.shape[0])
        active = t < cfg.p_source_flag
        if cfg.p_source_mode == ADDITIVE:
            scaled = _scale_additive_source(src.p_index, val, ops, shape, fft)
            rx = jnp.where(active, rx + scaled, rx)
            ry = jnp.where(active, ry + scaled, ry)
            if is3d:
                rz = jnp.where(active, rz + scaled, rz)
        else:
            rx2 = _apply_point_source(rx, src.p_index, val, cfg.p_source_mode)
            ry2 = _apply_point_source(ry, src.p_index, val, cfg.p_source_mode)
            rx = jnp.where(active, rx2, rx)
            ry = jnp.where(active, ry2, ry)
            if is3d:
                rz = jnp.where(
                    active, _apply_point_source(rz, src.p_index, val, cfg.p_source_mode), rz
                )

    # -- pressure update (computePressureNonlinear/Linear :2180-2245)
    rho_sum = rx + ry + (rz if is3d else 0.0)
    du_sum = duxdx + duydy + (duzdz if is3d else 0.0)
    c2 = _c2_op(ops)
    if cfg.absorbing:
        tau, eta = _tau_eta_op(ops)
        vel_grad_sum = ops.rho0 * du_sum
        nabla1, nabla2 = _absorb_nablas(ops, ndim)
        tau_term = fft.irfftn(fft.rfftn(vel_grad_sum) * nabla1, shape)
        eta_term = fft.irfftn(fft.rfftn(rho_sum) * nabla2, shape)
        if cfg.nonlinear:
            nonlin = (ops.bona * rho_sum * rho_sum) / (2.0 * ops.rho0) + rho_sum
            p = c2 * (nonlin + tau * tau_term - eta * eta_term)
        else:
            p = c2 * (rho_sum + tau * tau_term - eta * eta_term)
    else:
        if cfg.nonlinear:
            p = c2 * (rho_sum + ops.bona * rho_sum * rho_sum / (2.0 * ops.rho0))
        else:
            p = c2 * rho_sum

    new = SimState(p=p, ux_sgx=ux, uy_sgy=uy, uz_sgz=uz, rho_x=rx, rho_y=ry, rho_z=rz)

    # -- initial pressure at t==0 (addInitialPressureSource :2359-2400). The result
    # is state-independent, so hot callers PEEL this out of their scan: the driver
    # runs add_initial_pressure once before the loop and passes
    # p0_source_flag=False (make_window_fn peel_p0 / the lead-in init) — the cond
    # here is the generic fallback for standalone simulate() users only.
    if cfg.p0_source_flag:
        new = lax.cond(
            t == 0, lambda s: add_initial_pressure(s, ops, src.p0, fft),
            lambda s: s, new,
        )
    return new


def shifted_velocity(state: SimState, ops: Operators):
    """Velocities shifted back onto the regular grid via per-axis spectral half-cell shifts
    (computeShiftedVelocity, KSpaceFirstOrderSolver.cpp:2714-2735: batched 1D FFT per axis x
    x_shift_neg). Returns (ux_shifted, uy_shifted, uz_shifted|None)."""
    ndim = state.p.ndim

    def shift(u, op_packed, axis):
        n = u.shape[axis]
        op_vec = cvec(op_packed)
        uk = jnp.fft.rfft(u, axis=axis)
        shape = [1] * ndim
        shape[axis] = op_vec.shape[0]
        return jnp.fft.irfft(uk * op_vec.reshape(shape), n=n, axis=axis)

    ux = shift(state.ux_sgx, ops.shift_x_neg, ndim - 1)
    uy = shift(state.uy_sgy, ops.shift_y_neg, ndim - 2)
    uz = (
        shift(state.uz_sgz, ops.shift_z_neg, 0)
        if state.uz_sgz is not None and ops.shift_z_neg is not None
        else None
    )
    return ux, uy, uz


def make_p0_init(grid: Grid, ops: Operators, p0: jax.Array,
                 fft: FftOps = LOCAL_FFT) -> SimState:
    """The peeled t==0 state: addInitialPressureSource's result does not depend on the
    running state, so the full state after step 0 is exactly this. Hot loops run it ONCE
    before their scan (and drop p0_source_flag from the scanned step) instead of
    paying a per-step lax.cond whose p0 branch carries 4 FFTs.

    The eager evaluation aliases rho_x/rho_y/rho_z through ONE buffer (and p through
    the caller's p0): donating such a state into a jitted loop is rejected
    (`f(donate(a), donate(a))`), so the duplicated leaves are copied out."""
    st = add_initial_pressure(init_state(grid), ops, jnp.asarray(p0), fft)
    return SimState(
        p=jnp.array(st.p, copy=True),
        ux_sgx=st.ux_sgx,
        uy_sgy=st.uy_sgy,
        uz_sgz=st.uz_sgz,
        rho_x=st.rho_x,
        rho_y=jnp.array(st.rho_y, copy=True),
        rho_z=None if st.rho_z is None else jnp.array(st.rho_z, copy=True),
    )


def add_initial_pressure(state: SimState, ops: Operators, p0: jax.Array,
                         fft: FftOps = LOCAL_FFT) -> SimState:
    """p = p0; rho_i = p0/(dim*c^2); u_sg = 0.5 * dt/rho0_sg * ifft(ddk_pos*kappa*fft(p0))
    (addInitialPressureSource, KSpaceFirstOrderSolver.cpp:2359-2400; kernels
    SolverCudaKernels.cu:854-935 and the 0.5*fftDivider*dtRho0 initial-velocity kernels)."""
    is3d = state.uz_sgz is not None
    shape = p0.shape
    dim = 3 if is3d else 2
    rho_part = p0 / (jnp.float32(dim) * _c2_op(ops))
    gx, gy, gz = _grad_fields(p0, ops, ops.ddx_pos, ops.ddy_pos, ops.ddz_pos, shape, fft)
    half = jnp.float32(0.5)
    return SimState(
        p=p0,
        ux_sgx=half * ops.dt_rho0_sgx * gx,
        uy_sgy=half * ops.dt_rho0_sgy * gy,
        uz_sgz=half * ops.dt_rho0_sgz * gz if is3d else None,
        rho_x=rho_part,
        rho_y=rho_part,
        rho_z=rho_part if is3d else None,
    )


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------


def make_simulate_fn(
    ops: Operators,
    src: Sources,
    cfg: SolverConfig,
    n_steps: int,
    sample_fn: Optional[Callable[[SimState], Any]] = None,
    fft: FftOps = LOCAL_FFT,
):
    """Build the jitted main loop: ``run(state, t0) -> (state, samples)``.

    ``ops`` and ``src`` are staged onto the device HERE, once, and passed to the jitted
    program as runtime arguments. Both alternatives cost at scale: host-numpy arguments
    are re-uploaded on every execution, and closing over them bakes the full operator
    set into the lowered HLO as dense literals (606 MB of StableHLO at 256^3).
    Device-resident buffers passed by handle avoid both. ``t0`` is a traced scalar so
    checkpoint legs / lead-ins don't recompile per start index.
    """
    ops = jax.tree_util.tree_map(jnp.asarray, ops)
    src = jax.tree_util.tree_map(jnp.asarray, src)

    # donate the carried fields: the caller never reuses the input state, and the
    # double-buffer costs 7 full grids (3.5 GB at 512^3)
    @functools.partial(jax.jit, donate_argnums=(0,))
    def _run(state: SimState, t0, ops_, src_):
        def body(carry, i):
            new = step(carry, t0 + i, ops_, src_, cfg, fft)
            out = sample_fn(new) if sample_fn is not None else None
            return new, out

        return lax.scan(body, state, jnp.arange(n_steps))

    def run(state: SimState, t0):
        return _run(state, t0, ops, src)

    return run


def simulate(
    state: SimState,
    ops: Operators,
    src: Sources,
    cfg: SolverConfig,
    n_steps: int,
    sample_fn: Optional[Callable[[SimState], Any]] = None,
    t0: int = 0,
    fft: FftOps = LOCAL_FFT,
):
    """Run ``n_steps`` iterations from time index ``t0`` via lax.scan.

    ``sample_fn(state)`` is evaluated every step; its stacked outputs are returned (None
    entries before sampling_start are zero-filled — the reference simply skips storage,
    KSpaceFirstOrderSolver.cpp:1060-1068; callers slice ``[cfg.sampling_start_index - t0:]``).
    Checkpoint/restart = call again with the carried state and t0 = steps done
    (saveCheckpointData/loadInputData recovery, :1176/:186-228).

    Convenience wrapper around `make_simulate_fn` — builds (and compiles) a fresh closure
    per call; hot callers that invoke the loop repeatedly should hold the function
    returned by `make_simulate_fn` instead.
    """
    run = make_simulate_fn(ops, src, cfg, n_steps, sample_fn, fft)
    return run(state, jnp.int32(t0))

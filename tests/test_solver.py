"""Solver tests: analytic exactness for homogeneous media, branch coverage for the rest.

The k-space pseudospectral scheme with the sinc(c*dt*k/2) correction integrates the
homogeneous lossless wave equation *exactly* in time (the property the reference's kappa
operator exists for, KSpaceFirstOrderSolver.cpp:2404-2452) — so a standing wave must match
cos(w*t) to fp32 accuracy, which pins the whole velocity/density/pressure update chain.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kwave_tpu.solver import (
    Grid,
    Medium,
    SolverConfig,
    Sources,
    init_state,
    make_operators,
    simulate,
)


def _standing_wave_exact(dim: int):
    n = 32
    c0, rho0 = 1500.0, 1000.0
    dx = 1e-4
    dt = 0.3 * dx / c0  # CFL 0.3
    shape = (n, n) if dim == 2 else (n, n, n)
    grid = Grid(
        nx=n, ny=n, nz=1 if dim == 2 else n, dx=dx, dy=dx, dz=dx, dt=dt, nt=50
    )
    medium = Medium(c0=c0, rho0=rho0)
    ops = make_operators(grid, medium, pml_size=(0, 0, 0), pml_alpha=(0, 0, 0))

    # standing wave along x: p0 = cos(kx * x), kx = 2*pi*m/(n*dx)
    m = 3
    kx = 2 * np.pi * m / (n * dx)
    x = np.arange(n) * dx
    p0 = np.cos(kx * x).astype(np.float32)
    p0 = np.broadcast_to(p0, shape).copy()

    cfg = SolverConfig(p0_source_flag=True)
    src = Sources(p0=jnp.asarray(p0))
    state = init_state(grid)
    nt = 40
    lead = (0,) * (dim - 1)
    final, ps = simulate(state, ops, src, cfg, nt, sample_fn=lambda s: s.p[lead])
    ps = np.asarray(ps)  # [nt, n] — p along x at y(=z)=0

    w = c0 * kx
    for it in range(nt):
        # The t_index=0 iteration applies p0 after the (zero-state) pressure update and
        # samples it (computeMainLoop order, :917-930), so sample[it] = p(it*dt).
        t = it * dt
        expect = np.cos(w * t) * np.cos(kx * x)
        np.testing.assert_allclose(ps[it], expect, atol=5e-3)


def test_standing_wave_exact_2d():
    _standing_wave_exact(2)


def test_standing_wave_exact_3d():
    _standing_wave_exact(3)


def _mini_grid(dim, n=16, nt=20):
    dx = 1e-4
    dt = 0.2 * dx / 1500.0
    return Grid(nx=n, ny=n, nz=1 if dim == 2 else n, dx=dx, dy=dx, dz=dx, dt=dt, nt=nt)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("absorbing", [False, True])
def test_branches_finite(dim, nonlinear, absorbing):
    """All 4 equation-of-state branches (x 2D/3D) run and stay finite with heterogeneous
    medium + PML (the reference's kernel-template matrix, SolverCudaKernels.cu)."""
    grid = _mini_grid(dim)
    shape = grid.shape
    rng = np.random.default_rng(0)
    c0 = (1500.0 + 50.0 * rng.random(shape)).astype(np.float32)
    rho0 = (1000.0 + 30.0 * rng.random(shape)).astype(np.float32)
    medium = Medium(
        c0=c0,
        rho0=rho0,
        bona=6.0 if nonlinear else None,
        alpha_coeff=0.75 if absorbing else None,
        alpha_power=1.5,
    )
    ops = make_operators(grid, medium, pml_size=(4,) * 3, pml_alpha=(2.0,) * 3,
                         absorbing=absorbing)
    p0 = np.zeros(shape, np.float32)
    center = tuple(s // 2 for s in shape)
    p0[center] = 1e5
    cfg = SolverConfig(p0_source_flag=True, nonlinear=nonlinear, absorbing=absorbing)
    final, _ = simulate(init_state(grid), ops, Sources(p0=jnp.asarray(p0)), cfg, 15)
    assert np.isfinite(np.asarray(final.p)).all()
    assert np.abs(np.asarray(final.p)).max() > 0


def test_pressure_source_modes():
    """Dirichlet vs additive-no-correction vs additive point source all inject energy."""
    grid = _mini_grid(2)
    medium = Medium(c0=1500.0, rho0=1000.0)
    shape = grid.shape
    idx = np.array([shape[1] * (shape[0] // 2) + shape[1] // 2], np.int32)
    sig = (1e5 * np.sin(2 * np.pi * np.arange(grid.nt) / 10)).astype(np.float32)
    for mode in (0, 1, 2):
        ops = make_operators(grid, medium, pml_size=(4, 4), pml_alpha=(2.0, 2.0),
                             need_source_kappa=(mode == 2))
        cfg = SolverConfig(p_source_flag=grid.nt, p_source_mode=mode)
        src = Sources(p_index=jnp.asarray(idx), p_signal=jnp.asarray(sig))
        final, _ = simulate(init_state(grid), ops, src, cfg, 15)
        p = np.asarray(final.p)
        assert np.isfinite(p).all() and np.abs(p).max() > 0, f"mode {mode}"


def test_velocity_source_and_transducer():
    grid = _mini_grid(2)
    medium = Medium(c0=1500.0, rho0=1000.0)
    shape = grid.shape
    idx = np.array([shape[1] * 4 + 4, shape[1] * 4 + 5], np.int32)
    sig = (0.01 * np.sin(2 * np.pi * np.arange(grid.nt) / 8)).astype(np.float32)
    ops = make_operators(grid, medium, pml_size=(4, 4), pml_alpha=(2.0, 2.0))

    cfg = SolverConfig(u_source_flag=grid.nt, u_source_mode=1)
    src = Sources(u_index=jnp.asarray(idx), ux_signal=jnp.asarray(sig))
    final, _ = simulate(init_state(grid), ops, src, cfg, 12)
    assert np.abs(np.asarray(final.ux_sgx)).max() > 0

    cfg = SolverConfig(transducer_source_flag=grid.nt)
    src = Sources(
        transducer_index=jnp.asarray(idx),
        transducer_signal=jnp.asarray(np.concatenate([sig, np.zeros(8, np.float32)])),
        delay_mask=jnp.asarray(np.array([0, 3], np.int64)),
    )
    final, _ = simulate(init_state(grid), ops, src, cfg, 12)
    assert np.abs(np.asarray(final.ux_sgx)).max() > 0


def test_pml_absorbs_outgoing_wave():
    """With a PML, field energy decays once the wavefront reaches the boundary; with
    pml_alpha=0 (periodic wrap) it does not."""
    grid = _mini_grid(2, n=32, nt=120)
    medium = Medium(c0=1500.0, rho0=1000.0)
    shape = grid.shape
    p0 = np.zeros(shape, np.float32)
    p0[16, 16] = 1e5
    src = Sources(p0=jnp.asarray(p0))
    cfg = SolverConfig(p0_source_flag=True)

    def total_e(pml_alpha):
        ops = make_operators(grid, medium, pml_size=(8, 8), pml_alpha=(pml_alpha,) * 2)
        final, _ = simulate(init_state(grid), ops, src, cfg, 110)
        return float(np.sum(np.asarray(final.p) ** 2))

    assert total_e(2.0) < 0.2 * total_e(0.0)


def test_checkpoint_resume_equivalence():
    """simulate(N) == simulate(k) then simulate(N-k) from the carried state — the
    functional form of the reference's checkpoint/restart legs (main.cpp:147-169)."""
    grid = _mini_grid(2, n=16, nt=20)
    medium = Medium(c0=1500.0, rho0=1000.0)
    ops = make_operators(grid, medium, pml_size=(4, 4), pml_alpha=(2.0, 2.0))
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8] = 1e5
    src = Sources(p0=jnp.asarray(p0))
    cfg = SolverConfig(p0_source_flag=True)

    full, _ = simulate(init_state(grid), ops, src, cfg, 17)
    mid, _ = simulate(init_state(grid), ops, src, cfg, 9)
    resumed, _ = simulate(mid, ops, src, cfg, 8, t0=9)
    np.testing.assert_array_equal(np.asarray(full.p), np.asarray(resumed.p))
    np.testing.assert_array_equal(np.asarray(full.ux_sgx), np.asarray(resumed.ux_sgx))


def test_nonuniform_grid_reduces_to_uniform():
    """With identity stretch maps the nonuniform path must equal the uniform one;
    with non-identity maps it must change the answer (both finite)."""
    import jax.numpy as jnp

    grid = _mini_grid(3)
    medium = Medium(c0=1500.0, rho0=1000.0)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    src = Sources(p0=jnp.asarray(p0))
    cfg = SolverConfig(p0_source_flag=True)

    ident = {k: np.ones(n, np.float32) for k, n in (
        ("dxudxn", grid.nx), ("dyudyn", grid.ny), ("dzudzn", grid.nz),
        ("dxudxn_sgx", grid.nx), ("dyudyn_sgy", grid.ny), ("dzudzn_sgz", grid.nz))}
    ops_u = make_operators(grid, medium, (4,) * 3, (2.0,) * 3)
    ops_i = make_operators(grid, medium, (4,) * 3, (2.0,) * 3, nonuniform=ident)
    fu, _ = simulate(init_state(grid), ops_u, src, cfg, 10)
    fi, _ = simulate(init_state(grid), ops_i, src, cfg, 10)
    np.testing.assert_array_equal(np.asarray(fu.p), np.asarray(fi.p))

    stretched = dict(ident)
    stretched["dxudxn"] = (1.0 + 0.1 * np.sin(np.arange(grid.nx))).astype(np.float32)
    stretched["dxudxn_sgx"] = stretched["dxudxn"]
    ops_s = make_operators(grid, medium, (4,) * 3, (2.0,) * 3, nonuniform=stretched)
    fs, _ = simulate(init_state(grid), ops_s, src, cfg, 10)
    assert np.isfinite(np.asarray(fs.p)).all()
    assert np.abs(np.asarray(fs.p) - np.asarray(fu.p)).max() > 0


def test_p0_peel_matches_cond_path():
    """The peeled t==0 state (make_p0_init == add_initial_pressure, state-independent)
    must equal the post-step-0 state of the generic lax.cond path bitwise — the
    identity the driver's first-window/lead-in peel relies on."""
    import jax.numpy as jnp

    from kwave_tpu.solver import (
        Grid, Medium, SolverConfig, Sources, init_state, make_operators, make_p0_init,
        step,
    )

    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (4, 4, 4), (2.0,) * 3)
    cfg = SolverConfig(p0_source_flag=True)
    cfg_peeled = SolverConfig(p0_source_flag=False)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    src = Sources(p0=jnp.asarray(p0))

    s_cond = step(init_state(grid), jnp.int32(0), ops, src, cfg)
    s_peel = make_p0_init(grid, ops, p0)
    for t in range(1, 3):
        for f in ("p", "ux_sgx", "uy_sgy", "uz_sgz", "rho_x", "rho_y", "rho_z"):
            np.testing.assert_array_equal(
                np.asarray(getattr(s_cond, f)), np.asarray(getattr(s_peel, f)),
                err_msg=f"{f} before t={t}")
        s_cond = step(s_cond, jnp.int32(t), ops, src, cfg)
        s_peel = step(s_peel, jnp.int32(t), ops, src, cfg_peeled)


def test_velocity_source_axis_symmetry():
    """Axis-permutation invariance: on a uniform cubic medium, a uy (uz) point
    source at the center must produce the x<->y (x<->z) transposed field of the
    ux run — a wiring guard for the per-axis staggered source paths (uy/uz had
    no direct coverage; an axis mix-up in the staggered shifts or rho0_sg
    selection breaks this at O(1), while correct physics agrees to fp level)."""
    n = 24
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=30)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (4, 4, 4),
                         (2.0,) * 3)
    c = n // 2
    idx = np.array([(c * n + c) * n + c])
    sig = (0.01 * np.sin(2 * np.pi * np.arange(30) / 8)).astype(np.float32)

    def run(axis):
        cfg = SolverConfig(u_source_flag=30, u_source_mode=1)
        src = Sources(u_index=jnp.asarray(idx),
                      **{f"u{axis}_signal": jnp.asarray(sig)})
        st, _ = simulate(init_state(grid), ops, src, cfg, 30)
        return np.asarray(st.p)

    px, py, pz = run("x"), run("y"), run("z")
    scale = np.abs(px).max()
    assert scale > 0
    assert np.abs(py - px.transpose(0, 2, 1)).max() / scale < 1e-5
    assert np.abs(pz - px.transpose(2, 1, 0)).max() / scale < 1e-5


def test_acoustic_reciprocity():
    """Acoustic reciprocity: in a lossless homogeneous medium the recorded
    pressure is invariant under source<->receiver exchange (G(A->B) = G(B->A)).
    A physics-level validation of the coupled update equations as a whole —
    the k-Wave ecosystem gets this class of check only via external MATLAB
    cross-validation (SURVEY §4); here it is a unit test."""
    import functools

    import jax

    from kwave_tpu.solver.step import step as one_step

    n = 32
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=60)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (6, 6, 6),
                         (2.0,) * 3, need_source_kappa=True)
    a_idx = (10 * n + 12) * n + 14
    b_idx = (20 * n + 18) * n + 22
    sig = (4e-3 * np.sin(2 * np.pi * np.arange(60) / 12)
           * np.hanning(60)).astype(np.float32)
    cfg = SolverConfig(p_source_flag=60, p_source_mode=2)  # additive
    stepper = jax.jit(functools.partial(one_step, cfg=cfg))

    def record(src_idx, rec_idx):
        src = Sources(p_index=jnp.asarray(np.array([src_idx])),
                      p_signal=jnp.asarray(sig))
        st = init_state(grid)
        vals = []
        for t in range(60):
            st = stepper(st, jnp.int32(t), ops, src)
            vals.append(float(st.p.reshape(-1)[rec_idx]))
        return np.array(vals)

    ab = record(a_idx, b_idx)
    ba = record(b_idx, a_idx)
    scale = np.abs(ab).max()
    assert scale > 0
    assert np.abs(ab - ba).max() / scale < 1e-4


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_shifted_velocity_moves_staggered_samples_onto_the_grid(axis):
    """shifted_velocity (per-axis jnp rfft/irfft with exp(-i k d/2)) takes a velocity
    sampled at the staggered points (j + 1/2) d back to the grid points j d: a sinusoid
    comes back as the same sinusoid half a cell earlier. Odd and even extents."""
    from kwave_tpu.solver import SimState, shifted_velocity

    nz, ny, nx = 8, 9, 12
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=1e-4, dy=2e-4, dz=1.5e-4, dt=1e-8, nt=1)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (2, 2, 2), (2.0,) * 3,
                         need_shift=True)
    ax = {"x": 2, "y": 1, "z": 0}[axis]
    n = grid.shape[ax]
    j = np.arange(n)
    shape = [1, 1, 1]
    shape[ax] = n
    cross = np.linspace(0.5, 1.5, int(np.prod(grid.shape)) // n)  # varies off-axis
    cross = np.moveaxis(cross.reshape([s for i, s in enumerate(grid.shape) if i != ax]
                                      + [1]), -1, ax)

    def field(offset):
        return (cross * np.sin(2 * np.pi * 2 * (j + offset) / n).reshape(shape)
                ).astype(np.float32)

    zero = jnp.zeros(grid.shape, jnp.float32)
    comps = {c: zero for c in ("ux_sgx", "uy_sgy", "uz_sgz")}
    comps[{"x": "ux_sgx", "y": "uy_sgy", "z": "uz_sgz"}[axis]] = jnp.asarray(field(0.5))
    state = SimState(p=zero, rho_x=zero, rho_y=zero, rho_z=zero, **comps)
    out = shifted_velocity(state, ops)
    got = np.asarray(out[{"x": 0, "y": 1, "z": 2}[axis]])
    np.testing.assert_allclose(got, field(0.0), atol=2e-6)
    for k in range(3):
        if k != {"x": 0, "y": 1, "z": 2}[axis]:
            assert not np.asarray(out[k]).any()

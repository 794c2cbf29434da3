"""k-space pseudospectral fluid solver — the producer of the sampled fields.

Functional reformulation of the reference KSpaceFirstOrderSolver
(KSpaceSolver/KSpaceFirstOrderSolver.cpp, SolverCudaKernels.cu): the 31 CUDA kernels and the
cuFFT plan juggling collapse into a single pure `step` function over a pytree of fields, with
all spectral/PML/absorption operators precomputed once (`make_operators`) and the main loop a
`lax.scan`.
"""

from kwave_tpu.solver.operators import Grid, Medium, Operators, make_operators
from kwave_tpu.solver.step import (
    SimState,
    SolverConfig,
    Sources,
    add_initial_pressure,
    init_state,
    make_p0_init,
    shifted_velocity,
    make_simulate_fn,
    simulate,
    step,
)

__all__ = [
    "Grid",
    "Medium",
    "Operators",
    "make_operators",
    "SimState",
    "SolverConfig",
    "Sources",
    "add_initial_pressure",
    "init_state",
    "make_p0_init",
    "shifted_velocity",
    "make_simulate_fn",
    "simulate",
    "step",
]

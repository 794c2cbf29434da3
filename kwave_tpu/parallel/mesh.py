"""Mesh + sharding rules for solver fields and codec streams.

Design (DESIGN.md / SURVEY.md §2.9 table):

- 1-axis mesh ``('space',)`` for single-host multi-chip: solver fields [nz, ny, nx] are
  sharded over z (the leading, non-FFT-reduced axis); codec sensor blocks are sharded over
  the same devices (the codec's sensor axis is embarrassingly parallel,
  SURVEY.md §5 long-context note).
- Basis tables / per-axis operator vectors / scalars are replicated.
- Multi-host runs span the same 1-axis mesh over every process's devices (one process
  per host).

Everything here works identically on the 8-device virtual CPU mesh used in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kwave_tpu.solver.operators import Operators
from kwave_tpu.solver.step import SimState


def make_mesh(n_devices: Optional[int] = None, axis: str = "space") -> Mesh:
    """1-axis device mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def field_sharding(mesh: Mesh, ndim: int, axis: str = "space") -> NamedSharding:
    """Shard the leading (z in 3D, y in 2D) axis of a field array."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def codec_sharding(mesh: Mesh, ndim: int, axis: str = "space") -> NamedSharding:
    """Codec arrays are [..., H, N] (or [o, N] chunks): shard the trailing sensor axis."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1)), axis))


def shard_state(state: SimState, mesh: Mesh, axis: str = "space") -> SimState:
    """Place all fields with the leading axis sharded."""

    def put(x):
        if x is None:
            return None
        return jax.device_put(x, field_sharding(mesh, np.ndim(x), axis))

    return jax.tree_util.tree_map(put, state)


def shard_operators(ops: Operators, grid_ndim: int, mesh: Mesh, axis: str = "space",
                    grid=None, pencil: bool = False) -> Operators:
    """Full-grid operators (kappa, nablas, source_kappa, heterogeneous media) follow the
    field sharding; per-axis vectors and scalars replicate.

    With ``pencil=True`` (and ``grid`` given), spectral-domain arrays — those with the
    rfft-reduced x axis — are placed in the pencil FFT's y-sharded spectral layout
    (kwave_tpu.parallel.fft.spectral_sharding) so the elementwise spectral multiplies in
    the solver step stay local after dist_rfftn."""
    repl = replicated(mesh)
    spec_shape = tuple(grid.reduced_shape) if grid is not None else None
    if pencil:
        from kwave_tpu.parallel.fft import spectral_sharding

        spec_sh = spectral_sharding(mesh, axis)

    # per-axis complex operators travel as packed [n, 2] float planes
    # (operators.pack_complex) — always replicated, never grid-sharded, even when their
    # ndim happens to match the grid's (2D grids)
    packed = {"ddx_pos", "ddx_neg", "ddy_pos", "ddy_neg", "ddz_pos", "ddz_neg",
              "shift_x_neg", "shift_y_neg", "shift_z_neg"}

    def put(name, x):
        if x is None:
            return None
        if name in packed:
            return jax.device_put(x, repl)
        if pencil and spec_shape is not None and tuple(np.shape(x)) == spec_shape:
            return jax.device_put(x, spec_sh)
        if np.ndim(x) == grid_ndim and np.shape(x)[0] % mesh.shape[axis] == 0:
            # full-grid (real or spectral): z-sharded like the fields. The
            # divisibility guard keeps grid-ndim BROADCAST vectors — the
            # nonuniform stretch maps travel as (1,1,nx)/(1,ny,1)/(nz,1,1) —
            # out of the field rule; the unshardable ones replicate (GSPMD
            # broadcasts them against sharded fields locally).
            return jax.device_put(x, field_sharding(mesh, grid_ndim, axis))
        return jax.device_put(x, repl)

    d = {}
    for f in dataclasses.fields(ops):
        v = getattr(ops, f.name)
        # static metadata (dt, c_ref_dt_2, alpha_power) stays a Python float — it is
        # jit-static aux data, and device_put of host scalars trips the multi-process
        # cross-host consistency check
        static = bool(f.metadata.get("static"))
        d[f.name] = v if static else put(f.name, v)
    return Operators(**d)


def pencil_fft(mesh: Mesh, nx: int, axis: str = "space"):
    """FftOps bound to this mesh's pencil-decomposed distributed FFT — pass as the
    solver step/simulate `fft` argument alongside pencil-sharded operators."""
    from kwave_tpu.parallel import fft as dfft
    from kwave_tpu.solver.step import FftOps

    return FftOps(
        rfftn=lambda x: dfft.dist_rfftn(x, mesh, axis),
        irfftn=lambda xk, shape: dfft.dist_irfftn(xk, shape[-1], mesh, axis),
    )

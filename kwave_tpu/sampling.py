"""Sensor sampling and reduce operators — the jnp analogue of OutputStreamsCudaKernels.

The reference gathers field values through an index sensor mask or cuboid corners with a
templated reduce (OutputStreams/OutputStreamsCudaKernels.cu: cudaSampleIndex :83-107,
cudaSampleCuboid :202-230, cudaSampleAll :297-316, cudaPostProcessingRms :359-365). Here each
is a pure jnp function over the flattened field; XLA fuses the gather with the reduce update so
aggregated streams never materialize the gathered vector in HBM.

Index convention: the field is flattened x-fastest (``flat = x + nx*(y + ny*z)``), matching the
reference's row-major-in-x CUDA layout (Utils/CudaUtils.cuh:82-125). Sensor masks are 0-based
here; MATLAB 1-based masks from input files are rebased at load
(IndexMatrix::recomputeIndicesToCPP, MatrixClasses/IndexMatrix.h:115-117 — see kwave_tpu.io).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


# -- index-mask sampling (cudaSampleIndex :83-107) --------------------------------------------


def sample_index(field_flat: jax.Array, mask: jax.Array) -> jax.Array:
    """kNone: gather ``field[mask]`` (raw time series row)."""
    return jnp.take(field_flat, mask, axis=-1)


def sample_index_rms(buf: jax.Array, field_flat: jax.Array, mask: jax.Array) -> jax.Array:
    """kRms accumulate: ``buf += x*x`` at masked points."""
    x = jnp.take(field_flat, mask, axis=-1)
    return buf + x * x


def sample_index_max(buf: jax.Array, field_flat: jax.Array, mask: jax.Array) -> jax.Array:
    return jnp.maximum(buf, jnp.take(field_flat, mask, axis=-1))


def sample_index_min(buf: jax.Array, field_flat: jax.Array, mask: jax.Array) -> jax.Array:
    return jnp.minimum(buf, jnp.take(field_flat, mask, axis=-1))


# -- cuboid sampling (cudaSampleCuboid :202-230, transformCoordinates :164-188) ---------------


@dataclasses.dataclass(frozen=True)
class Cuboid:
    """Half-open cuboid [lo, hi) in (x, y, z); 0-based (reference stores inclusive 1-based
    corners, IndexMatrix::getTopLeftCorner/getBottomRightCorner, IndexMatrix.h:106-112)."""

    lo: tuple[int, int, int]
    hi: tuple[int, int, int]

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def size(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz


def sample_cuboid(field_3d: jax.Array, cuboid: Cuboid) -> jax.Array:
    """kNone: extract one cuboid as a [cx, cy, cz] block. field_3d is [nz, ny, nx] (z-major,
    x fastest — the flattened layout reshaped)."""
    (x0, y0, z0), (x1, y1, z1) = cuboid.lo, cuboid.hi
    return jax.lax.slice(field_3d, (z0, y0, x0), (z1, y1, x1))


def sample_cuboid_flat(field_3d: jax.Array, cuboid: Cuboid) -> jax.Array:
    """Cuboid block flattened x-fastest — the reference's linear cuboid buffer order
    (transformCoordinates: slab z, row y, x contiguous)."""
    return sample_cuboid(field_3d, cuboid).reshape(-1)


def sample_cuboid_rms(buf, field_3d, cuboid: Cuboid):
    x = sample_cuboid_flat(field_3d, cuboid)
    return buf + x * x


def sample_cuboid_max(buf, field_3d, cuboid: Cuboid):
    return jnp.maximum(buf, sample_cuboid_flat(field_3d, cuboid))


def sample_cuboid_min(buf, field_3d, cuboid: Cuboid):
    return jnp.minimum(buf, sample_cuboid_flat(field_3d, cuboid))


# -- whole-domain sampling (cudaSampleAll :297-316) --------------------------------------------


def sample_all_rms(buf: jax.Array, field_flat: jax.Array) -> jax.Array:
    return buf + field_flat * field_flat


def sample_all_max(buf: jax.Array, field_flat: jax.Array) -> jax.Array:
    return jnp.maximum(buf, field_flat)


def sample_all_min(buf: jax.Array, field_flat: jax.Array) -> jax.Array:
    return jnp.minimum(buf, field_flat)


# -- post-processing ---------------------------------------------------------------------------


def post_rms(buf: jax.Array, n_sampled_steps: int) -> jax.Array:
    """RMS finalization ``sqrt(buf * 1/(Nt - s))`` (cudaPostProcessingRms :359-365,
    scaling from BaseOutputStream::postProcess, BaseOutputStream.cpp:170-176)."""
    return jnp.sqrt(buf * (jnp.float32(1.0) / jnp.float32(n_sampled_steps)))


def init_reduce_buffer(op: str, n: int) -> jax.Array:
    """Fresh aggregate buffer. Max/min seed with -inf/+inf: the reference seeds with the first
    sampled value via FLT_MAX init (BaseOutputStream.cpp allocate + first min/max compare);
    -inf/+inf is equivalent under jnp.maximum/minimum."""
    if op == "rms":
        return jnp.zeros(n, jnp.float32)
    if op == "max":
        return jnp.full(n, -jnp.inf, jnp.float32)
    if op == "min":
        return jnp.full(n, jnp.inf, jnp.float32)
    raise ValueError(f"unknown reduce op {op!r}")

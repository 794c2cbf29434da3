"""Distributed 3D FFT: pencil decomposition over the mesh 'space' axis via shard_map.

The reference has no distributed FFT (single GPU, cuFFT plans — MatrixClasses/
CufftComplexMatrix.cpp). Across devices the naive approach (GSPMD all-gathering the
z-sharded field around jnp.fft.rfftn) moves the whole field between devices every FFT;
the pencil scheme moves it once per transpose and keeps every 1D FFT local:

  forward:  [nz/S, ny, nx] --rfft(x), fft(y) local--> [nz/S, ny, nxR]
            --all_to_all(z<->y)--> [nz, ny/S, nxR] --fft(z) local--> spectral, y-sharded
  inverse:  mirror image.

Spectral fields and spectral operators therefore live **y-sharded** (P(None,'space',None))
while time-domain fields are **z-sharded** (P('space',None,None)) — `spectral_sharding`
below. The all-to-alls run over the device interconnect (NVLink between the GPUs of
one host, where every device reaches every other at the same rate, so the flat
1-axis mesh needs no device ordering).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def spectral_sharding(mesh: Mesh, axis: str = "space") -> NamedSharding:
    """Sharding of spectral arrays produced by dist_rfftn (y axis sharded)."""
    return NamedSharding(mesh, P(None, axis, None))


def _fwd_local(x, axis_name: str):
    """Per-shard forward: local rfft(x)+fft(y), transpose z<->y, local fft(z)."""
    s = jax.lax.psum(1, axis_name)
    nz_loc, ny, _ = x.shape  # after rfft: [nz/S, ny, nxR]
    xk = jnp.fft.fft(jnp.fft.rfft(x, axis=2), axis=1)
    nxr = xk.shape[2]
    # split y into S blocks and trade: [nz/S, S, ny/S, nxR] -> [S, nz/S, ny/S, nxR]
    xk = xk.reshape(nz_loc, s, ny // s, nxr)
    xk = jax.lax.all_to_all(xk, axis_name, split_axis=1, concat_axis=0, tiled=False)
    # [S, nz/S, ny/S, nxR] -> [nz, ny/S, nxR]
    xk = xk.reshape(s * nz_loc, ny // s, nxr)
    return jnp.fft.fft(xk, axis=0)


def _inv_local(xk, nx: int, axis_name: str):
    """Per-shard inverse: local ifft(z), transpose y<->z, local ifft(y)+irfft(x)."""
    s = jax.lax.psum(1, axis_name)
    nz, ny_loc, nxr = xk.shape
    xk = jnp.fft.ifft(xk, axis=0)
    # [S, nz/S, ny/S, nxR] -> trade back -> [nz/S, S, ny/S, nxR] -> [nz/S, ny, nxR]
    xk = xk.reshape(s, nz // s, ny_loc, nxr)
    xk = jax.lax.all_to_all(xk, axis_name, split_axis=0, concat_axis=1, tiled=False)
    xk = xk.reshape(nz // s, s * ny_loc, nxr)
    return jnp.fft.irfft(jnp.fft.ifft(xk, axis=1), n=nx, axis=2)


def dist_rfftn(x: jax.Array, mesh: Mesh, axis: str = "space") -> jax.Array:
    """3D rfftn of a z-sharded [nz, ny, nx] field -> y-sharded spectral [nz, ny, nxR]."""
    fn = jax.shard_map(
        functools.partial(_fwd_local, axis_name=axis),
        mesh=mesh,
        in_specs=P(axis, None, None),
        out_specs=P(None, axis, None),
    )
    return fn(x)


def dist_irfftn(xk: jax.Array, nx: int, mesh: Mesh, axis: str = "space") -> jax.Array:
    """Inverse of dist_rfftn: y-sharded spectral -> z-sharded real [nz, ny, nx]."""
    fn = jax.shard_map(
        functools.partial(_inv_local, nx=nx, axis_name=axis),
        mesh=mesh,
        in_specs=P(None, axis, None),
        out_specs=P(axis, None, None),
    )
    return fn(xk)

"""Decoder: coefficient unpacking, basis-synthesis reconstruction, coefficient-space intensity.

Consumers of the compressed coefficient streams:

- `decode_frames_40b`: packed SoA planes -> fp32 complex planes (pure integer unpack,
  backend-exact; semantics of `CompressHelper::convert40bToFloatC`,
  Compression/CompressHelper.cpp:224-284).
- `reconstruct`: inverse of the windowed projection — overlap-add synthesis with the
  triangular window, formulated as one einsum over all frames at once. The C++ reference
  never reconstructs the time series (it consumes coefficients directly); this is the
  analytical inverse used by the round-trip acceptance gate.
- `avg_intensity_frames` / `avg_intensity_update`: time-averaged acoustic intensity straight
  from coefficient space, `I = mean_c sum_h Re(cP * conj(cU)) / 2` — the semantics of
  `IndexOutputStream::postSample` (OutputStreams/IndexOutputStream.cpp:299-342: one
  accumulation per completed frame) and `postProcess` (:482-490: divide by frame count), and
  of the post-hoc `computeAverageIntensitiesC` (KSpaceSolver/KSpaceFirstOrderSolver.cpp:1543-1775).

Device layout convention: coefficient frames are ``[..., H, N]`` (harmonics, sensor points);
basis tables time-major ``[2o, H]`` as produced by `kwave_tpu.encoder.make_tables`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from kwave_tpu import bitpack
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis


def decode_frames_40b(hdr: jax.Array, mr: jax.Array, mi: jax.Array, e: int):
    """Unpack 40-bit SoA coefficient planes ``[..., H, N]`` -> fp32 (re, im)."""
    return bitpack.decode40(hdr, mr, mi, e)


def decode_40bit_rows(rows, harmonics: int, max_exp: int):
    """Packed index-layout dataset rows -> decoded coefficient planes.

    ``rows`` is the float32-viewed ``[n_frames, mSize]`` content of a 40-bit
    ``*_c`` dataset (``mSize = ceil(N*1.25)*H`` floats per frame,
    IndexOutputStream.cpp:91-93); returns fp32 ``(re, im)`` of shape
    ``[n_frames, N, H]``. The integer unpack is exact on any backend — the
    reference cannot post-process 40-bit data at all
    (KSpaceFirstOrderSolver.cpp:1541)."""
    import numpy as np

    from kwave_tpu.oracle import bytes_to_soa

    rows = np.ascontiguousarray(rows)
    n_pts = int(rows.shape[1] / (1.25 * harmonics))
    raw = rows.view(np.uint8)[:, : 5 * n_pts * harmonics]
    hdr, mr, mi = bytes_to_soa(np.ascontiguousarray(raw).reshape(-1))
    shape3 = (rows.shape[0], n_pts, harmonics)
    re, im = bitpack.decode40(
        jnp.asarray(hdr.reshape(shape3).astype(np.uint32)),
        jnp.asarray(mr.reshape(shape3).astype(np.uint32)),
        jnp.asarray(mi.reshape(shape3).astype(np.uint32)), max_exp,
    )
    return np.asarray(re), np.asarray(im)


@functools.partial(jax.jit, static_argnames=("o_size", "n_steps", "normalized"))
def reconstruct(
    f_re: jax.Array,
    f_im: jax.Array,
    be_re: jax.Array,
    be_im: jax.Array,
    o_size: int,
    n_steps: int,
    normalized: bool = True,
):
    """Overlap-add synthesis of the time series from coefficient frames.

    Frame ``c`` is the windowed projection over the window starting at ``(c-1)*o``; writing
    ``t = k*o + r`` the two frames covering ``t`` are ``c = k`` (window offset ``r + o``) and
    ``c = k+1`` (offset ``r``), so

        x[k*o + r] = scale * sum_h ( C_re[k,h]*bE_re[r+o,h] + C_im[k,h]*bE_im[r+o,h]
                                   + C_re[k+1,h]*bE_re[r,h] + C_im[k+1,h]*bE_im[r,h] )

    (``Re(C * conj(e^{-iwu})) = C_re*cos + C_im*(-sin)`` — the tables already hold
    ``e^{-iw u}``). Both terms are one batched matmul ``[K,H,N] x [o,H] -> [K,o,N]``.
    ``scale = o/2`` undoes the production-mode 2/oSize normalization
    (Parameters/Parameters.cpp:549-551).

    Args:
      f_re, f_im: coefficient frames ``[Nc, H, N]``.
      be_re, be_im: time-major basis tables ``[2o, H]`` (plain or shifted to match the stream).
      o_size: window half-length o.
      n_steps: number of output timesteps (t >= Nc*o is outside full coverage and clamped off).

    Returns:
      ``x[n_steps, N]`` fp32.
    """
    n_c = f_re.shape[0]
    o = o_size
    k_max = (n_steps + o - 1) // o
    # x[k*o + r] = late[k, r] + early[k+1, r]. The coefficient frames are ~oSize x smaller
    # than the synthesized series, so pair frame k with frame k+1 on the (cheap) coefficient
    # side first, then run ONE contraction that writes the big output exactly once:
    #   x[k, r] = sum_m g[k, m] * tab[r, m],  m = (late/early) x (re/im) x harmonic.
    pad_to = max(k_max, n_c) + 1
    f_re_p = jnp.pad(f_re, ((0, pad_to - n_c), (0, 0), (0, 0)))
    f_im_p = jnp.pad(f_im, ((0, pad_to - n_c), (0, 0), (0, 0)))
    g = jnp.concatenate(
        [f_re_p[:k_max], f_im_p[:k_max], f_re_p[1 : k_max + 1], f_im_p[1 : k_max + 1]],
        axis=1,
    )  # [k_max, 4H, N]
    tab = jnp.concatenate([be_re[o:], be_im[o:], be_re[:o], be_im[:o]], axis=1)  # [o, 4H]
    # HIGHEST precision with fp32 accumulation: a GPU's default fp32 matmul is TF32
    # (~1e-3 rel error) — enough to fail the round-trip acceptance gate
    x = jnp.einsum("khn,rh->krn", g, tab, precision=lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    x = x.reshape(k_max * o, -1)[:n_steps]
    scale = jnp.float32(o / 2.0) if normalized else jnp.float32(1.0)
    return x * scale


@functools.partial(jax.jit, static_argnames=("o_size", "n_steps", "normalized"))
def reconstruct_frames(
    frames: jax.Array,  # [Nc, 2H, N] rows [:H]=re, [H:]=im
    be_re: jax.Array,
    be_im: jax.Array,
    o_size: int,
    n_steps: int,
    normalized: bool = True,
):
    """Overlap-add synthesis from PACKED coefficient frames (``[Nc, 2H, N]``, the layout
    of `encoder.encode_series_frames`). Semantics identical to `reconstruct`."""
    h = frames.shape[1] // 2
    return reconstruct(frames[:, :h], frames[:, h:], be_re, be_im, o_size, n_steps,
                       normalized)


def reconstruct_series(frames_re, frames_im, basis: CompressionBasis, shifted: bool,
                       n_steps: int):
    """Convenience wrapper: frames ``[Nc, H, N]`` + CompressionBasis -> ``x[n_steps, N]``."""
    be_re, be_im, _, _ = basis.tables(shifted)
    n = 2 * basis.o_size
    return reconstruct(
        jnp.asarray(frames_re),
        jnp.asarray(frames_im),
        jnp.asarray(be_re[:, :n].T),
        jnp.asarray(be_im[:, :n].T),
        basis.o_size,
        n_steps,
        basis.normalized,
    )


def avg_intensity_update(acc, cp_re, cp_im, cu_re, cu_im):
    """One per-frame accumulation: ``acc[i] += sum_h Re(cP * conj(cU)) / 2``.

    Inputs are one frame's coefficient planes ``[H, N]``; acc is ``[N]``. Matches the scalar
    loop of IndexOutputStream::postSample (IndexOutputStream.cpp:315-341):
    ``Re(P * conj(U)) = pRe*uRe + pIm*uIm``, halved, summed over harmonics.
    """
    return acc + jnp.sum(cp_re * cu_re + cp_im * cu_im, axis=0) * jnp.float32(0.5)


@jax.jit
def avg_intensity_frames(cp_re, cp_im, cu_re, cu_im):
    """Batch form over all frames ``[Nc, H, N]`` -> time-averaged intensity ``[N]``.

    Equivalent to Nc `avg_intensity_update` calls followed by the postProcess divide
    (IndexOutputStream.cpp:485-489) / computeAverageIntensitiesC's per-step mean
    (KSpaceFirstOrderSolver.cpp:1738-1764).
    """
    n_c = cp_re.shape[0]
    total = jnp.sum(cp_re * cu_re + cp_im * cu_im, axis=(0, 1)) * jnp.float32(0.5)
    return total / jnp.float32(n_c)


def avg_intensity_40b(p_planes, u_planes, e_p: int = MAX_EXP_P, e_u: int = MAX_EXP_U):
    """40-bit variant: unpack both packed streams then `avg_intensity_frames`.

    (The reference's post-hoc path does not support 40-bit —
    KSpaceFirstOrderSolver.cpp:1541 note — but its on-the-fly path does,
    IndexOutputStream.cpp:324-330; this covers both.)
    """
    cp = bitpack.decode40(*p_planes, e_p)
    cu = bitpack.decode40(*u_planes, e_u)
    return avg_intensity_frames(cp[0], cp[1], cu[0], cu[1])

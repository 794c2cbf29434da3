"""Streaming frame encoder for compressed output streams — the codec core.

Two formulations of the reference's sample-and-compress path
(`IndexOutputStream::flushRaw`, OutputStreams/IndexOutputStream.cpp:348-471):

**Exact path** (`encode_series_exact`, `encode_chunks`): reproduces the reference's per-step
fp32 complex MAC order (and, in 40-bit mode, the per-step decode->add->encode requantization)
bit-for-bit. A `lax.scan` over oSize-step chunks; each chunk emits exactly one frame. This is
the compliance mode for the bit-exactness acceptance gate.

**Fast path** (`encode_series_fast`): a matmul reformulation. The dual staggered
accumulators are algebraically a *strided windowed projection*: frame ``c`` equals
``sum_{u=0}^{2o-1} bE[u] * x((c-1)*o + u)`` for every c >= 1 (the rotation identity
``bE_1[s] == bE[(s+o) mod 2o]`` makes the even/odd buffer dance collapse), and the mirrored
first frame equals ``sum_{t<o} (bE[t] + bE[t+o]) * x(t)``. Splitting each window at its
midpoint gives ``frame[c] = P1[c-1] + P2[c]`` with ``P1 = chunks . bE[:o]`` and
``P2 = chunks . bE[o:]`` — two batched matmuls over all frames at once, no sequential scan,
one read of the input. Reduction order differs from the reference's sequential loop, so this
path is fp32-accurate but not bit-identical; in 40-bit mode it quantizes once per completed
frame instead of every step (higher quality than the reference, different bits).

Device data layout: accumulators and frames are ``[H, N]`` (sensors on the minor axis);
sample chunks are ``[o, N]``; basis tables are time-major ``[2o, H]``. The host/file edge
transposes to the reference's sensor-major interleaved layout (kwave_tpu.streams).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from kwave_tpu import bitpack
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Static configuration of one compressed stream (hashable; jit-static)."""

    o_size: int
    harmonics: int
    e_const: int = MAX_EXP_P
    overlap: bool = True
    mode40: bool = False

    @property
    def b_size(self) -> int:
        return 2 * self.o_size + 1

    @staticmethod
    def for_stream(basis: CompressionBasis, shifted: bool, mode40: bool, overlap: bool = True):
        return EncoderConfig(
            o_size=basis.o_size,
            harmonics=basis.harmonics,
            e_const=MAX_EXP_U if shifted else MAX_EXP_P,
            overlap=overlap,
            mode40=mode40,
        )


def make_tables(basis: CompressionBasis, shifted: bool) -> dict[str, jax.Array]:
    """Basis tables as time-major [2o, H] device arrays (column bSize-1 is never addressed)."""
    be_re, be_im, be1_re, be1_im = basis.tables(shifted)
    n = 2 * basis.o_size
    return {
        "be_re": jnp.asarray(be_re[:, :n].T),
        "be_im": jnp.asarray(be_im[:, :n].T),
        "be1_re": jnp.asarray(be1_re[:, :n].T),
        "be1_im": jnp.asarray(be1_im[:, :n].T),
    }


def init_state(cfg: EncoderConfig, n_sensors: int) -> dict[str, Any]:
    """Fresh encoder state (a pytree; directly checkpointable)."""
    shape = (cfg.harmonics, n_sensors)
    state: dict[str, Any] = {
        "sampled_step": jnp.int32(0),
        "compressed_step": jnp.int32(0),
    }
    if cfg.mode40:
        zeros = jnp.zeros(shape, jnp.uint32)
        state.update(hdr1=zeros, mr1=zeros, mi1=zeros)
        if cfg.overlap:
            state.update(hdr2=zeros, mr2=zeros, mi2=zeros)
    else:
        zeros = jnp.zeros(shape, jnp.float32)
        state.update(acc1_re=zeros, acc1_im=zeros)
        if cfg.overlap:
            state.update(acc2_re=zeros, acc2_im=zeros)
    return state


# ---------------------------------------------------------------------------
# Exact path — per-step semantics, bit-identical to the reference CPU loop
# ---------------------------------------------------------------------------


def _mac_step(state, x, sl, cfg: EncoderConfig, tables, mirror):
    """One sampled timestep: the correlation step (+ mirror / packed RMW variants)."""
    t1r = lax.dynamic_index_in_dim(tables["be_re"], sl, keepdims=False)  # [H]
    t1i = lax.dynamic_index_in_dim(tables["be_im"], sl, keepdims=False)
    t2r = lax.dynamic_index_in_dim(tables["be1_re"], sl, keepdims=False)
    t2i = lax.dynamic_index_in_dim(tables["be1_im"], sl, keepdims=False)
    xr = x[None, :]  # [1, N]

    if not cfg.mode40:
        if cfg.overlap:
            a1r = state["acc1_re"] + t1r[:, None] * xr
            a1i = state["acc1_im"] + t1i[:, None] * xr
            a2r = state["acc2_re"] + t2r[:, None] * xr
            a2i = state["acc2_im"] + t2i[:, None] * xr
            a2r, a2i = lax.cond(
                mirror, lambda: (a2r + a1r, a2i + a1i), lambda: (a2r, a2i)
            )
            return dict(state, acc1_re=a1r, acc1_im=a1i, acc2_re=a2r, acc2_im=a2i)
        # Aliased buffer: two sequential adds (IndexOutputStream.cpp float branch with
        # mHostBuffer2 == mHostBuffer1). Barrier prevents reassociation to (bE+bE_1)*x.
        a1r = state["acc1_re"] + t1r[:, None] * xr
        a1i = state["acc1_im"] + t1i[:, None] * xr
        a1r, a1i = lax.optimization_barrier((a1r, a1i))
        a1r = a1r + t2r[:, None] * xr
        a1i = a1i + t2i[:, None] * xr
        return dict(state, acc1_re=a1r, acc1_im=a1i)

    e = cfg.e_const
    if cfg.overlap:
        c1r, c1i = bitpack.decode40(state["hdr1"], state["mr1"], state["mi1"], e)
        c2r, c2i = bitpack.decode40(state["hdr2"], state["mr2"], state["mi2"], e)
        c1r = c1r + t1r[:, None] * xr
        c1i = c1i + t1i[:, None] * xr
        c2r = c2r + t2r[:, None] * xr
        c2i = c2i + t2i[:, None] * xr
        h1, r1, i1 = bitpack.encode40(c1r, c1i, e)
        h2, r2, i2 = bitpack.encode40(c2r, c2i, e)

        def _mirrored():
            m_r = c2r + c1r
            m_i = c2i + c1i
            return bitpack.encode40(m_r, m_i, e)

        h2, r2, i2 = lax.cond(mirror, _mirrored, lambda: (h2, r2, i2))
        return dict(state, hdr1=h1, mr1=r1, mi1=i1, hdr2=h2, mr2=r2, mi2=i2)
    # No-overlap 40-bit: cc += (bE*x + bE_1*x), one accumulate of the pre-summed term.
    # The barrier stops XLA's algebraic simplifier from reassociating a*x + b*x -> (a+b)*x,
    # which would change fp32 rounding vs the reference's scalar evaluation order.
    c1r, c1i = bitpack.decode40(state["hdr1"], state["mr1"], state["mi1"], e)
    p1r, p1i, p2r, p2i = lax.optimization_barrier(
        (t1r[:, None] * xr, t1i[:, None] * xr, t2r[:, None] * xr, t2i[:, None] * xr)
    )
    tr = p1r + p2r
    ti = p1i + p2i
    c1r = c1r + tr
    c1i = c1i + ti
    h1, r1, i1 = bitpack.encode40(c1r, c1i, e)
    return dict(state, hdr1=h1, mr1=r1, mi1=i1)


def _emit(state, cfg: EncoderConfig):
    """Select the finished buffer, zero it, bump compressed_step. Returns (state, frame)."""
    c = state["compressed_step"]
    odd = (c + 1) % 2 == 0
    if cfg.mode40:
        if cfg.overlap:
            frame = tuple(
                jnp.where(odd, state[k1], state[k2])
                for k1, k2 in (("hdr1", "hdr2"), ("mr1", "mr2"), ("mi1", "mi2"))
            )
            zero = jnp.zeros_like(state["hdr1"])
            new = {
                k1: jnp.where(odd, zero, state[k1])
                for k1 in ("hdr1", "mr1", "mi1")
            }
            new.update(
                {k2: jnp.where(odd, state[k2], zero) for k2 in ("hdr2", "mr2", "mi2")}
            )
        else:
            frame = (state["hdr1"], state["mr1"], state["mi1"])
            zero = jnp.zeros_like(state["hdr1"])
            new = dict(hdr1=zero, mr1=zero, mi1=zero)
    else:
        if cfg.overlap:
            frame = (
                jnp.where(odd, state["acc1_re"], state["acc2_re"]),
                jnp.where(odd, state["acc1_im"], state["acc2_im"]),
            )
            zero = jnp.zeros_like(state["acc1_re"])
            new = dict(
                acc1_re=jnp.where(odd, zero, state["acc1_re"]),
                acc1_im=jnp.where(odd, zero, state["acc1_im"]),
                acc2_re=jnp.where(odd, state["acc2_re"], zero),
                acc2_im=jnp.where(odd, state["acc2_im"], zero),
            )
        else:
            frame = (state["acc1_re"], state["acc1_im"])
            zero = jnp.zeros_like(state["acc1_re"])
            new = dict(acc1_re=zero, acc1_im=zero)
    out = dict(state, **new)
    out["compressed_step"] = c + 1
    return out, frame


def encode_chunk(state, x_chunk, cfg: EncoderConfig, tables):
    """Process one aligned oSize-step chunk; emits exactly one frame.

    Requires state.sampled_step to be a multiple of oSize. The window accumulate is a
    lax.fori_loop of per-step MACs; its accumulator planes are [H, N] (0.4 MB at
    16,384 sensors, H=2, overlap), so the loop's traffic is a small share of a window.
    """
    o = cfg.o_size
    parity = (state["sampled_step"] // o) % 2

    def body(i, st):
        sl = parity * o + i
        # Mirror fires at the saving step of the very first frame (overlap mode).
        mirror = (st["compressed_step"] == 0) & (i == o - 1) & cfg.overlap
        st2 = _mac_step(st, x_chunk[i], sl, cfg, tables, mirror)
        st2["sampled_step"] = st["sampled_step"] + 1
        return st2

    state = lax.fori_loop(0, o, body, state)
    return _emit(state, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_chunks(state, chunks, cfg: EncoderConfig, tables):
    """Scan over ``chunks[C, o, N]``; returns (state, frames) with frames leading dim C."""

    def step(st, xc):
        return encode_chunk(st, xc, cfg, tables)

    return lax.scan(step, state, chunks)


def accumulate_chunk(state, x_chunk, cfg: EncoderConfig, tables):
    """Accumulate a partial trailing window (x_chunk shorter than oSize) with NO emission.

    The reference runs the correlation step on every sampled timestep
    (IndexOutputStream.cpp:397-450); trailing steps of a record not divisible by oSize
    accumulate into the live buffers and are only flushed by the next saving boundary
    (which never comes) or the tiny-record lastStep rule (:455-456, see `emit_partial`).
    Requires that no saving boundary falls inside the chunk (true for window-aligned
    tails: state.sampled_step % oSize == 0 and len(x_chunk) < oSize).
    """
    o = cfg.o_size
    no_mirror = jnp.asarray(False)

    def body(i, st):
        sl = st["sampled_step"] % (2 * o)
        st2 = _mac_step(st, x_chunk[i], sl, cfg, tables, no_mirror)
        st2["sampled_step"] = st["sampled_step"] + 1
        return st2

    return lax.fori_loop(0, x_chunk.shape[0], body, state)


def encode_steps(state, x_steps, cfg: EncoderConfig, tables):
    """Process ``x_steps[S, N]`` one step at a time (S static, unrolled; S < 2*oSize).

    Used for the unaligned lead-in after checkpoint resume and for trailing partial windows.
    Returns (state, frames list) where frames are any emissions that occurred (at most
    ceil(S/o) of them, as host-visible jnp arrays).
    """
    o = cfg.o_size
    frames = []
    for s in range(x_steps.shape[0]):
        sl = state["sampled_step"] % (2 * o)
        saving = (sl + 1) % o == 0
        mirror = (state["compressed_step"] == 0) & saving & cfg.overlap
        state = _mac_step(state, x_steps[s], sl, cfg, tables, mirror)
        state["sampled_step"] = state["sampled_step"] + 1
        if bool(saving):  # requires concrete sampled_step (host-driven path)
            state, frame = _emit(state, cfg)
            frames.append(frame)
    return state, frames


def emit_partial(state, cfg: EncoderConfig):
    """Force-emit the current buffer (the reference's tiny-record lastStep edge,
    IndexOutputStream.cpp:455-456: fires when the whole record fits inside one overlap)."""
    return _emit(state, cfg)


def encode_series_exact(series, basis: CompressionBasis, shifted=False, mode40=False,
                        overlap=True, total_steps=None):
    """Encode ``series[T, N]`` with reference-exact semantics. Returns (frames, state).

    frames: float mode -> (re, im) each [Nc, H, N]; 40-bit mode -> (hdr, mr, mi) uint32
    planes of the same shape. ``Nc = T // oSize`` (or 1 for tiny records T <= oSize, per the
    lastStep rule).
    """
    series = jnp.asarray(series, jnp.float32)
    t_total, n = series.shape
    cfg = EncoderConfig.for_stream(basis, shifted, mode40, overlap)
    tables = make_tables(basis, shifted)
    state = init_state(cfg, n)
    o = cfg.o_size
    total = total_steps if total_steps is not None else t_total

    if total <= o:
        # Tiny record: accumulate everything, then the lastStep flush emits one partial
        # frame (IndexOutputStream.cpp:455-456). Built from the same fori_loop blocks as
        # the production driver so the two agree bit-for-bit on every backend (XLA:CPU
        # differs from the oracle in the last bits; XLA:GPU emits separately rounded
        # mul.rn/add.rn and matches it bit for bit — chip_smoke.py checks).
        if t_total >= o:  # record is exactly one window: the saving boundary emits
            state, frame = encode_chunk(state, series[:o], cfg, tables)
            return tuple(f[None] for f in frame), state
        state = accumulate_chunk(state, series, cfg, tables)
        state, frame = _emit(state, cfg)
        return tuple(f[None] for f in frame), state

    n_chunks = t_total // o
    chunks = series[: n_chunks * o].reshape(n_chunks, o, n)
    state, frames = encode_chunks(state, chunks, cfg, tables)
    # Trailing partial window: accumulate into state (no emission; reference emits the next
    # frame only at the next saving boundary).
    rem = t_total - n_chunks * o
    if rem:
        state = accumulate_chunk(state, series[n_chunks * o :], cfg, tables)
    return frames, state


# ---------------------------------------------------------------------------
# Fast path — strided windowed projection (two batched matmuls)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("o_size", "precision"))
def _fast_project(series, be_re, be_im, o_size: int, precision):
    t_total, n = series.shape
    n_frames = t_total // o_size
    chunks = series[: n_frames * o_size].reshape(n_frames, o_size, n)
    # Both window halves and both complex parts in ONE contraction so the big input
    # (the sample chunks) is read from HBM exactly once:
    #   P[k, w, z, h] = chunks[k]^T . bE[w-th half, h, z-th part]
    tab = jnp.stack([be_re, be_im], axis=-1)  # [2o, H, 2]
    tab4 = jnp.stack([tab[:o_size], tab[o_size:]], axis=-1)  # [o, H, 2(z), 2(half)]
    p = jnp.einsum(
        "kun,uhzw->kwzhn", chunks, tab4, precision=precision,
        preferred_element_type=jnp.float32,
    )
    p_a, p_b = p[:, 0], p[:, 1]  # first-half / second-half projections, each [K, 2, H, N]
    # frame[0] = P1[0] + P2[0] (mirror identity); frame[c>=1] = P1[c-1] + P2[c].
    p_a_shift = jnp.concatenate([p_a[:1], p_a[:-1]], axis=0)
    frames = p_a_shift + p_b
    return frames[:, 0], frames[:, 1]  # re, im each [Nc, H, N]


def encode_series_frames(series, basis: CompressionBasis, shifted=False,
                         precision=lax.Precision.HIGHEST):
    """Packed-frame fast encode: frames ``[Nc, 2H, N]`` with rows ``[:H]`` = re,
    ``[H:]`` = im.

    Overlap-mode float path for standalone encodes: `decoder.reconstruct_frames` takes
    this layout directly. ``precision`` defaults to HIGHEST, which keeps the einsum in
    full fp32 (a GPU's default fp32 matmul is TF32, ~1e-3 relative)."""
    series = jnp.asarray(series, jnp.float32)
    o = basis.o_size
    be_re, be_im, _, _ = basis.tables(shifted)
    tab_re = jnp.asarray(be_re[:, : 2 * o].T)
    tab_im = jnp.asarray(be_im[:, : 2 * o].T)
    f_re, f_im = _fast_project(series, tab_re, tab_im, o, precision)
    return jnp.concatenate([f_re, f_im], axis=1)


def encode_series_fast(series, basis: CompressionBasis, shifted=False, mode40=False,
                       overlap=True, precision=lax.Precision.HIGHEST,
                       bits: Optional[int] = None):
    """Fast windowed-projection encoder (not bit-identical; fp32-accurate).

    Float mode returns (re, im) [Nc, H, N]; packed modes quantize each completed frame
    once (better quality than the reference's per-step RMW; different bits) and return
    uint32 SoA planes. ``bits`` selects the packed width (8/16/24/32/40,
    bitpack.SUPPORTED_MANT_BITS; BASELINE config #3's mixed packing) — ``mode40`` is the
    bits=40 shorthand. No-overlap mode uses the single summed basis per frame.

    Float-mode overlap callers that feed `decoder.reconstruct_frames` (or any consumer
    indifferent to the split) should use `encode_series_frames` instead — the re/im
    split here costs an extra HBM pass over the frame planes.
    """
    if bits is None and mode40:
        bits = 40
    series = jnp.asarray(series, jnp.float32)
    o = basis.o_size
    if overlap:
        frames = encode_series_frames(series, basis, shifted, precision)
        h = basis.harmonics
        f_re, f_im = frames[:, :h], frames[:, h:]
    else:
        be_re, be_im, be1_re, be1_im = (
            jnp.asarray(a[:, : 2 * o].T) for a in basis.tables(shifted)
        )
        # Single accumulator with basis bE + bE_1, reset every o steps: one matmul per chunk
        # against the summed half-tables.
        tab_re = be_re[:o] + be1_re[:o]
        tab_im = be_im[:o] + be1_im[:o]
        t_total, n = series.shape
        n_frames = t_total // o
        chunks = series[: n_frames * o].reshape(n_frames, o, n)
        f_re = jnp.einsum("kun,uh->khn", chunks, tab_re, precision=precision,
                          preferred_element_type=jnp.float32)
        f_im = jnp.einsum("kun,uh->khn", chunks, tab_im, precision=precision,
                          preferred_element_type=jnp.float32)
    if bits is None:
        return f_re, f_im
    e = MAX_EXP_U if shifted else MAX_EXP_P
    return bitpack.encode_packed(f_re, f_im, e, bits)


# ---------------------------------------------------------------------------
# Host-edge layout: device [.., H, N] -> reference sensor-major flat buffers
# ---------------------------------------------------------------------------


def frames_to_flat_float(f_re, f_im) -> np.ndarray:
    """[C?, H, N] complex planes -> reference float buffer layout [..., N*H*2]
    (pH = i*H + ih, interleaved re/im; IndexOutputStream.cpp:438-443)."""
    f_re = np.asarray(f_re)
    f_im = np.asarray(f_im)
    stacked = np.stack([f_re, f_im], axis=-1)  # [..., H, N, 2]
    moved = np.moveaxis(stacked, -3, -2)  # [..., N, H, 2]
    return moved.reshape(*moved.shape[:-3], -1)


def frames_to_flat_40b(hdr, mr, mi) -> np.ndarray:
    """[C?, H, N] uint32 SoA planes -> packed 5-byte AoS stream in pH = i*H + ih order."""
    from kwave_tpu import oracle

    hdr = np.asarray(hdr)
    arrs = []
    for a in (hdr, np.asarray(mr), np.asarray(mi)):
        arrs.append(np.moveaxis(a, -2, -1))  # [..., N, H]
    h, r, i = arrs
    lead = h.shape[:-2]
    flat = oracle.soa_to_bytes(
        h.reshape(*lead, -1).astype(np.uint8),
        r.reshape(*lead, -1).astype(np.uint16),
        i.reshape(*lead, -1).astype(np.uint16),
    )
    if lead:
        flat = flat.reshape(*lead, -1)
    return flat

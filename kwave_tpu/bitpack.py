"""40-bit complex codec as JAX integer ops (device-side, backend-exact).

The packed stream lives on device as SoA planes — ``header`` (uint32, low 8 bits used),
``mr``/``mi`` (uint32, low 17 bits incl. the flag bit's 17th carried in the header) — and is
serialized to the reference's interleaved 5-byte AoS layout only at the host/file edge
(`kwave_tpu.oracle.soa_to_bytes`).

Semantics are op-for-op those of the reference codec (`Compression/CompressHelper.cpp:224-389`),
bit-identical to `kwave_tpu.oracle.encode40/decode40` (which the tests enforce): shared 4-bit
exponent, 17-bit mantissas with a flag bit encoding a per-part exponent decrement,
truncate-then-increment rounding with overflow guard, uint8 shift-count wraparound, saturation
on exponent overflow. Pure integer arithmetic: results are identical on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_U32 = jnp.uint32
_I32 = jnp.int32


def encode40(re: jax.Array, im: jax.Array, e: int):
    """Pack fp32 complex (re, im) -> (header, mR, mI) uint32 planes (low 8/16/16 bits used)."""
    bits_r = lax.bitcast_convert_type(re.astype(jnp.float32), _U32)
    bits_i = lax.bitcast_convert_type(im.astype(jnp.float32), _U32)

    s_r = bits_r >> 31
    s_i = bits_i >> 31
    e_rs = ((bits_r >> 23) & 0xFF).astype(_I32) - jnp.int32(e)
    e_is = ((bits_i >> 23) & 0xFF).astype(_I32) - jnp.int32(e)
    e_s = jnp.maximum(e_rs, e_is)

    m_r = bits_r & 0x007FFFFF
    m_i = bits_i & 0x007FFFFF

    # Right-shift counts are uint8 in the reference: mod-256 wraparound at each update.
    rs_r = (6 + jnp.maximum(e_is - e_rs, 0)) & 0xFF
    rs_i = (6 + jnp.maximum(e_rs - e_is, 0)) & 0xFF
    neg = e_s < 0
    rs_r = jnp.where(neg, (rs_r - e_s) & 0xFF, rs_r)
    rs_i = jnp.where(neg, (rs_i - e_s) & 0xFF, rs_i)
    e_s = jnp.maximum(e_s, 0)
    rs_r = jnp.minimum(rs_r, 23).astype(_U32)
    rs_i = jnp.minimum(rs_i, 23).astype(_U32)

    m_r = m_r >> rs_r
    m_i = m_i >> rs_i
    # Round up unless at the truncated-field maximum (CompressHelper.cpp:353-367).
    max_r = jnp.uint32(0x7FFFFF) >> rs_r
    max_i = jnp.uint32(0x7FFFFF) >> rs_i
    m_r = jnp.where((m_r > 0) & (m_r != max_r), m_r + 1, m_r)
    m_i = jnp.where((m_i > 0) & (m_i != max_i), m_i + 1, m_i)
    # Flag bit, then align to 17 bits.
    m_r = (m_r | (jnp.uint32(1) << (jnp.uint32(23) - rs_r))) >> 1
    m_i = (m_i | (jnp.uint32(1) << (jnp.uint32(23) - rs_i))) >> 1

    over = e_s > 0xF
    m_r = jnp.where(over, jnp.uint32(0xFFFF), m_r)
    m_i = jnp.where(over, jnp.uint32(0xFFFF), m_i)
    e_s = jnp.where(over, 0xF, e_s).astype(_U32)

    header = (
        (s_r << 7)
        | (s_i << 6)
        | ((m_r & 0x10000) >> 11)
        | ((m_i & 0x10000) >> 12)
        | (e_s & 0xF)
    )
    return header, m_r & 0xFFFF, m_i & 0xFFFF


def decode40(header: jax.Array, mr: jax.Array, mi: jax.Array, e: int):
    """Unpack (header, mR, mI) uint32 planes -> fp32 (re, im)."""
    header = header.astype(_U32)
    m_r = ((header & 0x20) << 11) | (mr.astype(_U32) & 0xFFFF)
    m_i = ((header & 0x10) << 12) | (mi.astype(_U32) & 0xFFFF)
    s_r = header >> 7
    s_i = (header & 0x40) >> 6
    e_s = (header & 0xF).astype(_I32)
    m_r <<= 6
    m_i <<= 6

    def _norm(m, ex):
        nz = m != 0
        safe = jnp.where(nz, m, 1).astype(_I32)
        idx = 31 - lax.clz(safe)  # MSB index; m has <= 23 bits
        m2 = jnp.where(nz, m << (jnp.uint32(23) - idx.astype(_U32)), m)
        ex2 = jnp.where(nz, ex - (22 - idx), 0)
        return m2, ex2

    e_base = e_s + jnp.int32(e)
    m_r, e_r = _norm(m_r, e_base)
    m_i, e_i = _norm(m_i, e_base)
    bits_r = (s_r << 31) | (e_r.astype(_U32) << 23) | (m_r & 0x7FFFFF)
    bits_i = (s_i << 31) | (e_i.astype(_U32) << 23) | (m_i & 0x7FFFFF)
    return (
        lax.bitcast_convert_type(bits_r, jnp.float32),
        lax.bitcast_convert_type(bits_i, jnp.float32),
    )


# ---------------------------------------------------------------------------
# Generalized W-bit complex packing (BASELINE config #3: mixed 8/16/32/40-bit)
# ---------------------------------------------------------------------------
#
# The reference implements exactly one packed size (40-bit). The format family
# generalizes naturally: W = 2 sign bits + 2*M mantissa bits + 4 shared-exponent bits,
# with M mantissa bits (incl. the leading-zeros flag bit encoding the per-part exponent
# decrement). M=17 -> the reference's 40-bit layout (encode40/decode40 above are the
# bit-exact specialization); M=13 -> 32-bit, M=9 -> 24-bit, M=5 -> 16-bit, M=1 -> 8-bit.
# All sizes share the reference's arithmetic: shared-exponent alignment,
# truncate-then-increment rounding with overflow guard, saturation.

SUPPORTED_MANT_BITS = {8: 1, 16: 5, 24: 9, 32: 13, 40: 17}


def encode_packed(re: jax.Array, im: jax.Array, e: int, total_bits: int = 40):
    """Pack fp32 complex -> (header, mR, mI) uint32 SoA planes at the given field width.

    header: low byte = [s_r | s_i | mantissa carry bits (40-bit only) | e(4)];
    mr/mi: low M bits (M = SUPPORTED_MANT_BITS[total_bits])."""
    if total_bits == 40:
        return encode40(re, im, e)
    m_bits = SUPPORTED_MANT_BITS[total_bits]
    rs0 = 23 - m_bits  # generalizes the 40-bit base shift of 6 (CompressHelper.cpp:330)
    bits_r = lax.bitcast_convert_type(re.astype(jnp.float32), _U32)
    bits_i = lax.bitcast_convert_type(im.astype(jnp.float32), _U32)
    s_r = bits_r >> 31
    s_i = bits_i >> 31
    e_rs = ((bits_r >> 23) & 0xFF).astype(_I32) - jnp.int32(e)
    e_is = ((bits_i >> 23) & 0xFF).astype(_I32) - jnp.int32(e)
    e_s = jnp.maximum(e_rs, e_is)
    m_r = bits_r & 0x007FFFFF
    m_i = bits_i & 0x007FFFFF
    rs_r = (rs0 + jnp.maximum(e_is - e_rs, 0)) & 0xFF
    rs_i = (rs0 + jnp.maximum(e_rs - e_is, 0)) & 0xFF
    neg = e_s < 0
    rs_r = jnp.where(neg, (rs_r - e_s) & 0xFF, rs_r)
    rs_i = jnp.where(neg, (rs_i - e_s) & 0xFF, rs_i)
    e_s = jnp.maximum(e_s, 0)
    rs_r = jnp.minimum(rs_r, 23).astype(_U32)
    rs_i = jnp.minimum(rs_i, 23).astype(_U32)
    m_r = m_r >> rs_r
    m_i = m_i >> rs_i
    max_r = jnp.uint32(0x7FFFFF) >> rs_r
    max_i = jnp.uint32(0x7FFFFF) >> rs_i
    m_r = jnp.where((m_r > 0) & (m_r != max_r), m_r + 1, m_r)
    m_i = jnp.where((m_i > 0) & (m_i != max_i), m_i + 1, m_i)
    m_r = (m_r | (jnp.uint32(1) << (jnp.uint32(23) - rs_r))) >> 1
    m_i = (m_i | (jnp.uint32(1) << (jnp.uint32(23) - rs_i))) >> 1
    sat = jnp.uint32((1 << (m_bits - 1)) - 1)
    over = e_s > 0xF
    m_r = jnp.where(over, sat, m_r)
    m_i = jnp.where(over, sat, m_i)
    e_s = jnp.where(over, 0xF, e_s).astype(_U32)
    mask = jnp.uint32((1 << m_bits) - 1)
    header = (s_r << 7) | (s_i << 6) | (e_s & 0xF)
    return header, m_r & mask, m_i & mask


def decode_packed(header: jax.Array, mr: jax.Array, mi: jax.Array, e: int,
                  total_bits: int = 40):
    """Unpack W-bit SoA planes -> fp32 (re, im); inverse of encode_packed."""
    if total_bits == 40:
        return decode40(header, mr, mi, e)
    m_bits = SUPPORTED_MANT_BITS[total_bits]
    rs0 = 23 - m_bits
    header = header.astype(_U32)
    mask = jnp.uint32((1 << m_bits) - 1)
    m_r = (mr.astype(_U32) & mask) << rs0
    m_i = (mi.astype(_U32) & mask) << rs0
    s_r = header >> 7
    s_i = (header & 0x40) >> 6
    e_s = (header & 0xF).astype(_I32)

    def _norm(m, ex):
        nz = m != 0
        safe = jnp.where(nz, m, 1).astype(_I32)
        idx = 31 - lax.clz(safe)
        m2 = jnp.where(nz, m << (jnp.uint32(23) - idx.astype(_U32)), m)
        ex2 = jnp.where(nz, ex - (22 - idx), 0)
        return m2, ex2

    e_base = e_s + jnp.int32(e)
    m_r, e_r = _norm(m_r, e_base)
    m_i, e_i = _norm(m_i, e_base)
    bits_r = (s_r << 31) | (e_r.astype(_U32) << 23) | (m_r & 0x7FFFFF)
    bits_i = (s_i << 31) | (e_i.astype(_U32) << 23) | (m_i & 0x7FFFFF)
    return (
        lax.bitcast_convert_type(bits_r, jnp.float32),
        lax.bitcast_convert_type(bits_i, jnp.float32),
    )


def pack_words(header: jax.Array, mr: jax.Array, mi: jax.Array) -> jax.Array:
    """Pack the SoA planes into interleaved uint32 words whose bytes ARE the 5-byte wire format.

    Output shape ``(..., 5)`` of uint8-valued uint32s is wasteful; instead this packs 4 complex
    coefficients (20 bytes) into 5 uint32 words per group so a flat little-endian byte view of
    the result equals `oracle.soa_to_bytes`. Requires the trailing axis length to be a multiple
    of 4. Used to hand a single dense buffer to the host.
    """
    h = (header & 0xFF).astype(_U32)
    r = (mr & 0xFFFF).astype(_U32)
    i = (mi & 0xFFFF).astype(_U32)
    # bytes per coeff k: [h_k, r_k lo, r_k hi, i_k lo, i_k hi]
    b0 = h
    b1 = r & 0xFF
    b2 = r >> 8
    b3 = i & 0xFF
    b4 = i >> 8
    flat = jnp.stack([b0, b1, b2, b3, b4], axis=-1).reshape(*header.shape[:-1], -1)
    # group 20 bytes -> 5 words (little-endian)
    g = flat.reshape(*flat.shape[:-1], -1, 4)
    words = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (g[..., 3] << 24)
    return words


def words_to_bytes(words) -> bytes:
    """Host-side: view packed words as the wire byte stream."""
    import numpy as np

    return np.asarray(words).astype("<u4").tobytes()


def pack_frame_wire(hdr: jax.Array, mr: jax.Array, mi: jax.Array) -> jax.Array:
    """One coefficient frame's ``[H, N]`` SoA planes -> wire-format uint32 words.

    The emission transport optimization (r5): shipping the three int32 planes
    device->host (and over DCN through WriterGather on pods) moves 12 bytes per
    coefficient where the 5-byte wire format suffices — 2.4x the necessary
    bytes on the production 40-bit path. This packs on DEVICE, inside the
    window program, in the writer's pH = i*H + ih point-major order
    (encoder.frames_to_flat_40b), padding to the 4-coefficient group size of
    `pack_words`. The true payload is the first ``5*N*H`` bytes of the
    little-endian word stream (`frame_wire_bytes`)."""
    if hdr.ndim != 2:
        raise ValueError(
            f"pack_frame_wire packs ONE [H, N] frame; got ndim={hdr.ndim} "
            "(pack multi-frame [C, H, N] emissions one frame at a time so the "
            "per-frame padding stays at each frame's tail)"
        )
    h_t = jnp.swapaxes(hdr, -2, -1).reshape(-1)  # [N*H] point-major
    r_t = jnp.swapaxes(mr, -2, -1).reshape(-1)
    i_t = jnp.swapaxes(mi, -2, -1).reshape(-1)
    pad = (-h_t.shape[0]) % 4
    if pad:
        h_t = jnp.pad(h_t, (0, pad))
        r_t = jnp.pad(r_t, (0, pad))
        i_t = jnp.pad(i_t, (0, pad))
    return pack_words(h_t, r_t, i_t)


def frame_wire_bytes(words, n_coeffs: int):
    """Host-side inverse of `pack_frame_wire`: words -> the frame's 5-byte/coeff
    stream (numpy uint8 of length ``5*n_coeffs``). Fails loudly when the packed
    payload does not cover the expected coefficient count (a silent short read
    would write truncated bytes into the output dataset)."""
    import numpy as np

    raw = np.frombuffer(words_to_bytes(words), np.uint8)
    need = 5 * n_coeffs
    if raw.size < need or raw.size >= need + 20:  # 20 B = one 4-coeff pad group
        raise ValueError(
            f"packed frame holds {raw.size} bytes but the writer expects "
            f"{need} (= 5 x {n_coeffs} coefficients) — emission/writer config "
            "mismatch"
        )
    return raw[:need]

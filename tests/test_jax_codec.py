"""JAX codec vs NumPy oracle.

Bit-exactness strategy (see DESIGN.md "Numerics"): XLA:CPU rounds the exact path's fp32
multiply-adds differently from the reference's separate roundings, so random-data bit-equality
holds on the GPU (XLA:GPU emits mul.rn/add.rn; `python chip_smoke.py` runs that gate on the
card) and not here. The rounding differs ONLY when a product is inexact, so this suite pins the *entire* state machine — frame
alternation, mirroring, zeroing, per-step 40-bit RMW, emission, layouts — bit-for-bit on any
backend using dyadic-exact data (few-mantissa-bit tables x integer samples => every multiply
exact). Real-valued data is additionally checked within fp32 tolerance.
"""

import dataclasses

import numpy as np
import pytest

from kwave_tpu import bitpack, encoder, oracle
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis, generate_basis


# ---------------------------------------------------------------------------
# Bit-level codec: pure integer, backend-exact everywhere
# ---------------------------------------------------------------------------


def _rand_pressures(n, seed=0):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3, 9, n)
    sign = rng.choice([-1.0, 1.0], n)
    vals = (mag * sign).astype(np.float32)
    edge = np.float32(
        [0.0, -0.0, 1e-30, -1e-30, 3e8, -3e8, np.inf, -np.inf, 0.03125, -0.03125, 1.0]
    )
    return np.concatenate([vals, edge])


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U])
def test_encode40_bit_exact_vs_oracle(e):
    re = _rand_pressures(4096, 1)
    im = _rand_pressures(4096, 2)
    h_o, r_o, i_o = oracle.encode40(re, im, e)
    h_j, r_j, i_j = bitpack.encode40(np.asarray(re), np.asarray(im), e)
    np.testing.assert_array_equal(np.asarray(h_j) & 0xFF, h_o)
    np.testing.assert_array_equal(np.asarray(r_j), r_o)
    np.testing.assert_array_equal(np.asarray(i_j), i_o)


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U])
def test_decode40_bit_exact_vs_oracle(e):
    rng = np.random.default_rng(3)
    h = rng.integers(0, 256, 8192).astype(np.uint8)
    mr = rng.integers(0, 65536, 8192).astype(np.uint16)
    mi = rng.integers(0, 65536, 8192).astype(np.uint16)
    re_o, im_o = oracle.decode40(h, mr, mi, e)
    re_j, im_j = bitpack.decode40(
        np.asarray(h, np.uint32), np.asarray(mr, np.uint32), np.asarray(mi, np.uint32), e
    )
    np.testing.assert_array_equal(np.asarray(re_j).view(np.uint32), re_o.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(im_j).view(np.uint32), im_o.view(np.uint32))


def test_pack_words_matches_wire_format():
    rng = np.random.default_rng(4)
    n = 64
    h = rng.integers(0, 256, n).astype(np.uint32)
    mr = rng.integers(0, 65536, n).astype(np.uint32)
    mi = rng.integers(0, 65536, n).astype(np.uint32)
    words = bitpack.pack_words(np.asarray(h), np.asarray(mr), np.asarray(mi))
    raw = bitpack.words_to_bytes(words)
    expected = oracle.soa_to_bytes(
        h.astype(np.uint8), mr.astype(np.uint16), mi.astype(np.uint16)
    ).tobytes()
    assert raw == expected


# ---------------------------------------------------------------------------
# Dyadic-exact fixtures: every fp32 product exact => backend-independent bits
# ---------------------------------------------------------------------------


def _dyadic_basis(o=8, harmonics=2) -> CompressionBasis:
    """A synthetic basis whose table entries are k/32 (|k|<=7): 3-bit dyadic rationals."""
    b_size = 2 * o + 1
    def tab(seed):
        rng = np.random.default_rng(seed)
        k = rng.integers(-7, 8, (harmonics, b_size))
        return (k / 32.0).astype(np.float32)

    be_re, be_im = tab(0), tab(1)
    es_re, es_im = tab(2), tab(3)
    rot = lambda a: np.concatenate(  # noqa: E731
        [a[:, np.arange(b_size - 1)[(np.arange(b_size - 1) + o) % (b_size - 1)]],
         a[:, -1:]], axis=1
    )
    # bE_1[sl] = bE[(sl+o) mod (bSize-1)] on the used range [0, 2o).
    idx = (np.arange(b_size) + o) % (b_size - 1)
    be1_re, be1_im = be_re[:, idx], be_im[:, idx]
    bes1_re, bes1_im = es_re[:, idx], es_im[:, idx]
    del rot
    w = np.zeros(b_size, np.float32)
    return CompressionBasis(
        period=float(2 * o), mos=1, harmonics=harmonics, o_size=o, b_size=b_size,
        normalized=False, b=w,
        e_re=be_re, e_im=be_im,
        be_re=be_re, be_im=be_im, be1_re=be1_re, be1_im=be1_im,
        e_sh_re=es_re, e_sh_im=es_im,
        be_sh_re=es_re, be_sh_im=es_im, be1_sh_re=bes1_re, be1_sh_im=bes1_im,
    )


def _dyadic_series(steps, n, seed=0, scale=1.0):
    """Integer-valued samples (exact products against dyadic tables)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (steps, n)) * scale).astype(np.float32)


def _series(steps, n, period, seed=0, scale=1e5):
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.5, 2.0, n) * scale
    ph = rng.uniform(0, 2 * np.pi, n)
    t = np.arange(steps)[:, None]
    base = amp[None] * np.sin(2 * np.pi * t / period + ph[None])
    return (base + rng.normal(0, 0.01 * scale, (steps, n))).astype(np.float32)


def _oracle_frames(series, basis, **kw):
    enc = oracle.OracleEncoder(basis, series.shape[1], total_steps=series.shape[0], **kw)
    return enc.encode_series(series)


def _assert_frames_equal(frames_j, frames_o, mode40):
    assert frames_j[0].shape[0] == len(frames_o)
    for c, fo in enumerate(frames_o):
        for k, plane_o in enumerate(fo):
            plane_j = np.asarray(frames_j[k][c]).T
            if mode40:
                np.testing.assert_array_equal(plane_j.astype(plane_o.dtype), plane_o)
            else:
                np.testing.assert_array_equal(
                    plane_j.view(np.uint32), plane_o.view(np.uint32)
                )


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [False, True])
def test_exact_state_machine_bits(shifted, overlap, mode40):
    basis = _dyadic_basis(o=8, harmonics=2)
    # 40-bit pressure range floor is 2^-5: scale integer samples so coefficients live well
    # above it while products stay exact (scale by 2^7).
    scale = 128.0 if mode40 else 1.0
    series = _dyadic_series(5 * basis.o_size + 3, 13, seed=1, scale=scale)
    frames_o = _oracle_frames(series, basis, shifted=shifted, overlap=overlap, mode40=mode40)
    frames_j, state = encoder.encode_series_exact(
        series, basis, shifted=shifted, overlap=overlap, mode40=mode40
    )
    _assert_frames_equal(frames_j, frames_o, mode40)
    assert int(state["compressed_step"]) == len(frames_o)


def test_tiny_record_last_step_emission():
    basis = _dyadic_basis(o=16, harmonics=1)
    series = _dyadic_series(basis.o_size - 3, 5, seed=8)
    frames_o = _oracle_frames(series, basis)
    frames_j, _ = encoder.encode_series_exact(series, basis)
    assert len(frames_o) == 1 and frames_j[0].shape[0] == 1
    _assert_frames_equal(frames_j, frames_o, mode40=False)


def test_trailing_partial_window_and_resume():
    basis = _dyadic_basis(o=8, harmonics=1)
    o = basis.o_size
    n = 6
    steps = 3 * o + 5
    series = _dyadic_series(steps, n, seed=9)
    frames_o = _oracle_frames(series, basis)
    frames_j, state = encoder.encode_series_exact(series, basis)
    assert frames_j[0].shape[0] == len(frames_o) == 3
    assert int(state["sampled_step"]) == steps
    # Continue both encoders: emissions must still agree bit-for-bit.
    more = _dyadic_series(o - 5, n, seed=10)
    enc_o = oracle.OracleEncoder(basis, n, total_steps=steps + len(more))
    frames_all = enc_o.encode_series(np.concatenate([series, more]))
    cfg = encoder.EncoderConfig.for_stream(basis, False, False, True)
    tables = encoder.make_tables(basis, False)
    state2, extra = encoder.encode_steps(state, np.asarray(more, np.float32), cfg, tables)
    assert len(extra) == 1
    np.testing.assert_array_equal(np.asarray(extra[0][0]).T, frames_all[3][0])
    np.testing.assert_array_equal(np.asarray(extra[0][1]).T, frames_all[3][1])


# ---------------------------------------------------------------------------
# Real-valued data: fp32-tolerance on CPU (bit-exactness on the GPU via chip_smoke.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("harmonics", [1, 3])
def test_exact_float_real_data_tolerance(harmonics):
    period, steps, n = 13.4, 170, 33
    basis = generate_basis(period, 1, harmonics)
    series = _series(steps, n, period)
    frames_o = _oracle_frames(series, basis)
    (f_re, f_im), _ = encoder.encode_series_exact(series, basis)
    assert f_re.shape[0] == len(frames_o)
    scale = max(np.abs(np.asarray(f_re)).max(), 1e-30)
    for c, (o_re, o_im) in enumerate(frames_o):
        np.testing.assert_allclose(np.asarray(f_re[c]).T, o_re, atol=1e-5 * scale)
        np.testing.assert_allclose(np.asarray(f_im[c]).T, o_im, atol=1e-5 * scale)


def test_exact_40bit_real_data_tolerance():
    period, steps, n = 11.0, 88, 21
    basis = generate_basis(period, 1, 2)
    series = _series(steps, n, period, seed=6)
    frames_o = _oracle_frames(series, basis, mode40=True)
    (hdr, mr, mi), _ = encoder.encode_series_exact(series, basis, mode40=True)
    # FMA-vs-not rounding differences feed the requantizer; decoded values must agree within
    # a few quanta of the 17-bit mantissa at the frame scale.
    for c, (o_h, o_r, o_i) in enumerate(frames_o):
        d_re_o, d_im_o = oracle.decode40(o_h, o_r, o_i, MAX_EXP_P)
        d_re_j, d_im_j = oracle.decode40(
            np.asarray(hdr[c]).T.astype(np.uint8),
            np.asarray(mr[c]).T.astype(np.uint16),
            np.asarray(mi[c]).T.astype(np.uint16),
            MAX_EXP_P,
        )
        scale = max(np.abs(d_re_o).max(), np.abs(d_im_o).max(), 1e-30)
        np.testing.assert_allclose(d_re_j, d_re_o, atol=1e-3 * scale)
        np.testing.assert_allclose(d_im_j, d_im_o, atol=1e-3 * scale)


# ---------------------------------------------------------------------------
# Fast path: numerically faithful, frame-structure identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
def test_fast_path_close_to_exact(overlap):
    period, steps, n = 14.0, 280, 40
    basis = generate_basis(period, 1, 3)
    series = _series(steps, n, period, seed=11)
    (e_re, e_im), _ = encoder.encode_series_exact(series, basis, overlap=overlap)
    f_re, f_im = encoder.encode_series_fast(series, basis, overlap=overlap)
    assert f_re.shape == e_re.shape
    scale = float(np.max(np.abs(np.asarray(e_re))))
    np.testing.assert_allclose(np.asarray(f_re), np.asarray(e_re), atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(f_im), np.asarray(e_im), atol=1e-5 * scale)


def test_fast_40bit_decodes_close_to_float_frames():
    period, steps, n = 16.0, 128, 24
    basis = generate_basis(period, 1, 1)
    series = _series(steps, n, period, seed=12)
    (ref_re, ref_im), _ = encoder.encode_series_exact(series, basis)
    h_f, r_f, i_f = encoder.encode_series_fast(series, basis, mode40=True)
    df_re, df_im = bitpack.decode40(h_f, r_f, i_f, MAX_EXP_P)
    scale = float(np.abs(np.asarray(ref_re)).max())
    # One-shot quantization: error bounded by a single 17-bit rounding at frame scale.
    np.testing.assert_allclose(np.asarray(df_re), np.asarray(ref_re), atol=2**-14 * scale)
    np.testing.assert_allclose(np.asarray(df_im), np.asarray(ref_im), atol=2**-14 * scale)


# ---------------------------------------------------------------------------
# Host-edge layouts
# ---------------------------------------------------------------------------


def test_flat_layout_matches_reference_order():
    basis = _dyadic_basis(o=4, harmonics=2)
    series = _dyadic_series(16, 3, seed=13)
    (f_re, f_im), _ = encoder.encode_series_exact(series, basis)
    flat = encoder.frames_to_flat_float(f_re[0], f_im[0])
    n = 3
    assert flat.shape == (n * 2 * 2,)
    assert flat[0] == np.asarray(f_re)[0, 0, 0]  # sensor 0, harmonic 0, re
    assert flat[1] == np.asarray(f_im)[0, 0, 0]
    assert flat[2] == np.asarray(f_re)[0, 1, 0]  # sensor 0, harmonic 1, re
    assert flat[4] == np.asarray(f_re)[0, 0, 1]  # sensor 1, harmonic 0, re


def test_flat_40b_layout_matches_oracle_bytes():
    basis = _dyadic_basis(o=4, harmonics=2)
    series = _dyadic_series(16, 4, seed=14, scale=128.0)
    frames_o = _oracle_frames(series, basis, mode40=True)
    (hdr, mr, mi), _ = encoder.encode_series_exact(series, basis, mode40=True)
    flat = encoder.frames_to_flat_40b(hdr[0], mr[0], mi[0])
    o_h, o_r, o_i = frames_o[0]  # [N, H]
    expected = oracle.soa_to_bytes(o_h.reshape(-1), o_r.reshape(-1), o_i.reshape(-1))
    np.testing.assert_array_equal(flat, expected)


import jax.numpy as jnp


class TestGeneralizedPacking:
    """W-bit packing family (BASELINE config #3: mixed 8/16/32/40-bit). 40-bit is the
    reference's format; the narrower widths share its arithmetic with scaled mantissas."""

    def _vals(self, n=4096, scale=1e5, seed=3):
        rng = np.random.default_rng(seed)
        re = (rng.standard_normal(n) * scale).astype(np.float32)
        im = (rng.standard_normal(n) * scale).astype(np.float32)
        return re, im

    def test_roundtrip_determinism_and_monotone_quality(self):
        from kwave_tpu import bitpack
        from kwave_tpu.basis import MAX_EXP_P

        re, im = self._vals()
        errs = {}
        for bits in (8, 16, 24, 32, 40):
            planes = bitpack.encode_packed(jnp.asarray(re), jnp.asarray(im),
                                           MAX_EXP_P, bits)
            r2, i2 = bitpack.decode_packed(*planes, MAX_EXP_P, bits)
            # re-encoding the decoded values is a fixed point (lossless roundtrip of
            # representable values — the reference's accumulate-in-packed-form invariant)
            planes2 = bitpack.encode_packed(r2, i2, MAX_EXP_P, bits)
            for a, b in zip(planes, planes2):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            errs[bits] = float(jnp.max(jnp.abs(r2 - re) + jnp.abs(i2 - im)))
        assert errs[40] < errs[32] < errs[24] < errs[16] < errs[8]
        # 40-bit variant must equal the reference specialization exactly
        from kwave_tpu.basis import MAX_EXP_U

        p40 = bitpack.encode_packed(jnp.asarray(re), jnp.asarray(im), MAX_EXP_U, 40)
        p40b = bitpack.encode40(jnp.asarray(re), jnp.asarray(im), MAX_EXP_U)
        for a, b in zip(p40, p40b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_wire_roundtrip_all_widths(self):
        from kwave_tpu import bitpack, oracle
        from kwave_tpu.basis import MAX_EXP_P

        re, im = self._vals(n=1024)
        for bits in (8, 16, 24, 32, 40):
            h, r, i = (np.asarray(p) for p in bitpack.encode_packed(
                jnp.asarray(re), jnp.asarray(im), MAX_EXP_P, bits))
            raw = oracle.pack_wire(h.astype(np.uint8) if bits != 40 else h,
                                   r, i, bits)
            assert raw.size == 1024 * bits // 8
            h2, r2, i2 = oracle.unpack_wire(raw, bits)
            if bits == 40:
                np.testing.assert_array_equal(h2, h.astype(np.uint8))
            else:
                np.testing.assert_array_equal(h2, (h & 0xCF).astype(np.uint8))
            np.testing.assert_array_equal(r2, r)
            np.testing.assert_array_equal(i2, i)

    def test_fast_encoder_bits_param(self):
        from kwave_tpu import encoder
        from kwave_tpu.basis import generate_basis

        cb = generate_basis(10.0, 1, 2, normalize=True)
        t = np.arange(200, dtype=np.float32)[:, None]
        x = (1e5 * np.sin(2 * np.pi * t / 10.0)).astype(np.float32) * np.ones(
            (1, 16), np.float32)
        planes = encoder.encode_series_fast(jnp.asarray(x), cb, bits=16)
        assert len(planes) == 3 and np.asarray(planes[1]).max() < (1 << 5)

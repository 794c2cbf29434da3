"""Pencil-decomposed distributed FFT vs single-device rfftn on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kwave_tpu.parallel import make_mesh, field_sharding
from kwave_tpu.parallel.fft import dist_irfftn, dist_rfftn, spectral_sharding


@pytest.fixture
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return make_mesh(8)


def test_dist_rfftn_matches_reference(mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 24, 20)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), field_sharding(mesh, 3))
    got = np.asarray(dist_rfftn(xs, mesh))
    ref = np.fft.rfftn(x.astype(np.float64)).astype(np.complex64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_dist_roundtrip_and_sharding(mesh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 16, 12)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), field_sharding(mesh, 3))

    @jax.jit
    def roundtrip(a):
        ak = dist_rfftn(a, mesh)
        return dist_irfftn(ak, a.shape[2], mesh), ak

    back, ak = roundtrip(xs)
    np.testing.assert_allclose(np.asarray(back), x, atol=2e-6)
    # spectral result is y-sharded
    assert ak.sharding.is_equivalent_to(spectral_sharding(mesh), 3)
    assert back.sharding.is_equivalent_to(field_sharding(mesh, 3), 3)


def test_dist_spectral_multiply_kappa(mesh):
    """A k-space operator applied in the y-sharded spectral layout matches the
    single-device result — the solver's spectral-multiply pattern."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 16, 16)).astype(np.float32)
    kap = rng.random((16, 16, 9)).astype(np.float32)

    xs = jax.device_put(jnp.asarray(x), field_sharding(mesh, 3))
    kap_s = jax.device_put(jnp.asarray(kap), spectral_sharding(mesh))

    @jax.jit
    def apply_op(a, k):
        return dist_irfftn(dist_rfftn(a, mesh) * k, 16, mesh)

    got = np.asarray(apply_op(xs, kap_s))
    ref = np.fft.irfftn(np.fft.rfftn(x) * kap, s=(16, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("n_dev,shape", [(2, (8, 6, 10)), (4, (16, 12, 9)),
                                         (8, (32, 16, 7))])
def test_pencil_fft_on_jax_shard_map(n_dev, shape):
    """The pencil legs run under jax.shard_map (the deprecated
    jax.experimental.shard_map warns on use) on 2, 4 and 8 devices, odd x extents
    included, and match numpy's rfftn forward and back."""
    import warnings

    if len(jax.devices()) < n_dev:
        pytest.skip(f"needs {n_dev} devices")
    mesh_n = make_mesh(n_dev)
    x = np.random.default_rng(n_dev).standard_normal(shape).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), field_sharding(mesh_n, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        xk = dist_rfftn(xs, mesh_n)
        back = dist_irfftn(xk, shape[2], mesh_n)
    ref = np.fft.rfftn(x.astype(np.float64))
    np.testing.assert_allclose(np.asarray(xk), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-5)

"""Permutohedral lattice parity: the port's float32 lattice gives the JAX
package's vertex indices exactly and its barycentric weights within 1e-6.
``el = E @ x`` is a float32 matmul on both sides (fused multiply-adds in
coordinate order), so no point near a rounding boundary splits the two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import permuto_encoding as pe_j
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t

FLAGSHIP = (24, 18, 1.0, 1e-4)
TINY = (4, 8, 1.0, 0.05)


def _coords(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (3, n)).astype(np.float32)


def test_elevation_matrix_identical():
    np.testing.assert_array_equal(pe_t._E, pe_j._E)


@pytest.mark.parametrize("cfg", [FLAGSHIP, TINY, (16, 12, 1.0, 1e-3)],
                         ids=["flagship", "tiny", "mid"])
def test_direct_level_specs_identical(cfg):
    l, cl, coarse, fine = cfg
    scales = np.geomspace(coarse, fine, l)
    a = pe_j.direct_level_specs(scales, 1 << cl, 2)
    b = pe_t.direct_level_specs(scales, 1 << cl, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("log2_c", [8, 18, 31])
def test_hash_keys_wraps_like_uint32(log2_c):
    rng = np.random.default_rng(log2_c)
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (4, 3, 4096)).astype(np.int32)
    keys[0, :, :4] = [[-1], [-4], [2 ** 31 - 1]]        # edge values
    a = np.asarray(pe_j._hash_keys_T(jnp.asarray(keys), log2_c))
    b = pe_t._hash_keys_T(torch.from_numpy(keys), log2_c).numpy()
    assert b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 0.05, 1e-4])
def test_simplex_vertices_and_weights(scale):
    x = _coords(20000, seed=1) / np.float32(scale)
    kj, bj = pe_j.simplex_vertices_and_weights_T(jnp.asarray(x))
    kt, bt = pe_t.simplex_vertices_and_weights_T(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bt.sum(0).numpy(), 1.0, atol=1e-5)


def test_rank_tie_break_on_lattice_points():
    # integer lattice points give exactly tied differentials
    x = np.random.default_rng(3).integers(-3, 4, (3, 512)).astype(np.float32)
    kj, bj = pe_j.simplex_vertices_and_weights_T(jnp.asarray(x))
    kt, bt = pe_t.simplex_vertices_and_weights_T(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", [FLAGSHIP, TINY], ids=["flagship", "tiny"])
def test_all_levels_match(cfg):
    l, cl, coarse, fine = cfg
    scales = np.geomspace(coarse, fine, l)
    mm, dm, direct, _ = pe_j.direct_level_specs(scales, 1 << cl, 2)
    inv = (1.0 / scales).astype(np.float32)
    x = _coords(8192, seed=4)
    ij, bj = jax.jit(lambda a: pe_j._lattice_all_levels(
        cl, a, inv, mm, dm, direct))(jnp.asarray(x))
    it, bt = pe_t.lattice_all_levels(torch.from_numpy(x), cl, inv, mm, dm, direct)
    assert it.dtype == torch.int32 and tuple(it.shape) == (l, 4, 8192)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)
    assert int(it.min()) >= 0 and int(it.max()) < (1 << cl)

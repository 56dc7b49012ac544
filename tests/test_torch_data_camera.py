"""Data and camera parity: the port's numpy ``make_dataset`` is bit-identical
to the JAX package's; its camera functions match the JAX ones in float32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.core import camera as cam_j
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.data.multiview import MultiviewDataset as MultiviewJ
from pagnerf_tpu.data.synthetic import make_dataset as make_j
from pagnerf_tpu_torch.core import camera as cam_t
from pagnerf_tpu_torch.core.rays import Rays as RaysT
from pagnerf_tpu_torch.data.multiview import MultiviewDataset as MultiviewT
from pagnerf_tpu_torch.data.synthetic import make_dataset as make_t


@pytest.mark.parametrize("kw", [
    dict(num_views=4, width=16, height=16, num_spheres=2),          # tiny
    dict(num_views=8, width=64, height=48, num_spheres=4),          # flagship
    dict(num_views=6, width=20, height=12, num_spheres=3, seed=3,
         pose_noise=0.05, supersample=1),
], ids=["tiny", "flagship", "noisy"])
def test_make_dataset_bit_identical(kw):
    a, b = make_j(**kw), make_t(**kw)
    assert sorted(a) == sorted(b)
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), k
    assert a["semantic_info"] == b["semantic_info"]
    ia, ib = a["intrinsics"], b["intrinsics"]
    for f in ("fx", "fy", "cx", "cy", "width", "height", "near", "far"):
        assert getattr(ia, f) == getattr(ib, f), f
    for f in dataclasses.fields(a["scene"]):
        assert np.array_equal(getattr(a["scene"], f.name),
                              getattr(b["scene"], f.name))
    dj, dt = MultiviewJ(a), MultiviewT(b)
    assert dj.semantic_info == dt.semantic_info
    assert np.array_equal(dj.train_idxs, dt.train_idxs)
    assert np.array_equal(dj.val_idxs, dt.val_idxs)


def _views(n=5, seed=0):
    data = make_t(num_views=n, width=8, height=6, num_spheres=1, seed=seed,
                  supersample=1)
    return data["view_matrices"]


def test_extrinsics_round_trip_matches_jax():
    views = _views()
    pj = np.asarray(cam_j.extrinsics_params_from_view_matrix(jnp.asarray(views)))
    pt = cam_t.extrinsics_params_from_view_matrix(torch.from_numpy(views))
    np.testing.assert_array_equal(pj, pt.numpy())
    vj = np.asarray(cam_j.view_matrix_from_extrinsics_params(jnp.asarray(pj)))
    vt = cam_t.view_matrix_from_extrinsics_params(pt).numpy()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt, views, rtol=0, atol=1e-5)


def test_r6_to_rotmat_matches_jax():
    r6 = np.random.default_rng(0).normal(size=(32, 6)).astype(np.float32)
    rj = np.asarray(cam_j.r6_to_rotmat(jnp.asarray(r6)))
    rt = cam_t.r6_to_rotmat(torch.from_numpy(r6)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,nik->njk", rt, rt),
                               np.broadcast_to(np.eye(3), rt.shape), atol=1e-5)


def test_transform_rays_matches_jax():
    rng = np.random.default_rng(1)
    views = _views(n=4)
    params = np.asarray(cam_j.extrinsics_params_from_view_matrix(
        jnp.asarray(views)))
    params = params + rng.normal(0, 0.05, params.shape).astype(np.float32)
    dirs = rng.normal(size=(2, 64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = rng.normal(0, 0.1, (2, 64, 3)).astype(np.float32)
    cam_idx = np.array([3, 1], np.int32)
    wj = cam_j.transform_rays(
        jnp.asarray(params),
        RaysJ(origins=jnp.asarray(origins), dirs=jnp.asarray(dirs),
              dist_min=jnp.float32(0.0), dist_max=jnp.float32(6.0)),
        jnp.asarray(cam_idx))
    wt = cam_t.transform_rays(
        torch.from_numpy(params),
        RaysT(origins=torch.from_numpy(origins), dirs=torch.from_numpy(dirs),
              dist_min=0.0, dist_max=6.0),
        torch.from_numpy(cam_idx).long())
    np.testing.assert_allclose(wt.origins.numpy(), np.asarray(wj.origins),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(wt.dirs.numpy(), np.asarray(wj.dirs),
                               rtol=0, atol=1e-6)
    flat = wt.reshape(-1)
    assert flat.shape == (128,) and flat.num_rays == 128


def test_view_from_c2w_copy_matches():
    rng = np.random.default_rng(2)
    c2w = np.tile(np.eye(4), (3, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(3, 3))
    np.testing.assert_array_equal(cam_t.view_from_c2w(c2w),
                                  cam_j.view_from_c2w(c2w))

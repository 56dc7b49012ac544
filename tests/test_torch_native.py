"""The port's host sampler (``pagnerf_tpu_torch/data/native.py`` over its
own copy of ``batcher.cpp``) against the JAX package's
``pagnerf_tpu/data/native.py`` with its default library, bit for bit:

- ``sample_ray_indices`` over a grid of (batch, rays, pool, seed), with
  rays == pool, rays > pool (the replacement path) and seeds near 2^62 and
  2^64;
- ``gather_pixels`` (float32, int32 through the library; uint8 and a
  non-contiguous source through numpy) and ``rle_decode``;
- ``MultiviewDataset.sample_batch`` of both packages from the same ``rng``,
  with and without a robot mask (``_valid_pixels``);
- the build: a missing compiler raises and leaves nothing; concurrent
  builds each load a whole library.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from pagnerf_tpu.data import native as native_j
from pagnerf_tpu.data.multiview import MultiviewDataset as DatasetJ
from pagnerf_tpu.data.synthetic import make_dataset as make_dataset_j
from pagnerf_tpu_torch.data import native
from pagnerf_tpu_torch.data.multiview import MultiviewDataset
from pagnerf_tpu_torch.data.synthetic import make_dataset


def test_jax_library_is_loaded():
    """The reference side is the JAX package's default path: its library."""
    assert native_j.available()


@pytest.mark.parametrize("batch,rays,pool,seed", [
    (1, 1, 1, 0), (2, 16, 100, 123), (6, 40, 256, 7), (3, 256, 256, 1),
    (4, 100, 100, 2 ** 62 - 1), (2, 33, 4096, 2 ** 62 - 12345),
    (5, 300, 200, 9), (2, 7, 3, 2 ** 61 + 5), (1, 4096, 3072, 11),
    (3, 1000, 20000, 2 ** 64 - 1)])
def test_sample_ray_indices_bit_equal(batch, rays, pool, seed):
    got = native.sample_ray_indices(batch, rays, pool, seed)
    ref = native_j.sample_ray_indices(batch, rays, pool, seed)
    assert got.dtype == np.int64 and got.shape == (batch, rays)
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0 and got.max() < pool
    if rays <= pool:
        for row in got:
            assert len(np.unique(row)) == rays


@pytest.mark.parametrize("dtype,channels", [(np.float32, 3), (np.float32, 1),
                                            (np.int32, 1), (np.int32, 2),
                                            (np.uint8, 3)])
def test_gather_pixels_matches_jax(dtype, channels):
    rng = np.random.default_rng(3)
    src = (rng.uniform(0, 200, (5, 64, channels))).astype(dtype)
    if channels == 1:
        src = src[..., 0]
    img = np.array([4, 0, 2], np.int64)
    ray = rng.integers(0, 64, (3, 10)).astype(np.int64)
    got = native.gather_pixels(src, img, ray)
    np.testing.assert_array_equal(got, native_j.gather_pixels(src, img, ray))
    np.testing.assert_array_equal(got, src[img[:, None], ray])


def test_gather_pixels_non_contiguous_source():
    src = np.random.default_rng(1).normal(size=(4, 30, 6)).astype(np.float32)[..., ::2]
    img, ray = np.array([1, 3]), np.random.default_rng(2).integers(0, 30, (2, 5))
    np.testing.assert_array_equal(native.gather_pixels(src, img, ray),
                                  native_j.gather_pixels(src, img, ray))


@pytest.mark.parametrize("h,w,runs", [
    (4, 5, [0, 3, 2, 7, 8]), (3, 3, [9]), (3, 3, [0, 9]), (6, 4, [5, 4, 3, 20]),
    (7, 9, list(np.random.default_rng(0).integers(0, 6, 24)))])
def test_rle_decode_matches_jax(h, w, runs):
    got = native.rle_decode(runs, h, w)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, native_j.rle_decode(runs, h, w))


def _pair(robot: bool):
    dj = make_dataset_j(num_views=4, width=16, height=16, num_spheres=2)
    dt = make_dataset(num_views=4, width=16, height=16, num_spheres=2)
    if robot:
        m = np.zeros((16, 16), np.uint8)
        m[10:, 3:9] = 1
        dj["robot_mask"] = m
        dt["robot_mask"] = m.copy()
    return DatasetJ(dj), MultiviewDataset(dt)


@pytest.mark.parametrize("robot", [False, True], ids=["all_pixels", "robot_mask"])
@pytest.mark.parametrize("batch,rays,seed", [(6, 40, 4), (2, 200, 0), (4, 256, 3),
                                             (1, 300, 5)])
def test_sample_batch_bit_equal_to_jax(robot, batch, rays, seed):
    ds_j, ds_t = _pair(robot)
    if robot:
        assert ds_t._valid_pixels is not None
        np.testing.assert_array_equal(ds_t._valid_pixels, ds_j._valid_pixels)
    for split in ("train", "val"):
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):                       # the rng streams stay in step
            bj = ds_j.sample_batch(rng_j, batch, rays, split)
            bt = ds_t.sample_batch(rng_t, batch, rays, split)
            assert sorted(bt) == sorted(bj)
            for k in bj:
                assert np.asarray(bt[k]).dtype == np.asarray(bj[k]).dtype, k
                np.testing.assert_array_equal(bt[k], np.asarray(bj[k]), err_msg=k)
    if robot:
        # no robot pixel enters a batch
        keep = set(ds_t._valid_pixels.tolist())
        flat_dirs = ds_t.data["base_rays_dirs"].reshape(-1, 3)
        idx = {tuple(r): i for i, r in enumerate(flat_dirs)}
        for d in bt["base_rays_dirs"].reshape(-1, 3):
            assert idx[tuple(d)] in keep


def test_build_without_compiler_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    assert not (tmp_path / "_build").exists()


_BUILD_AND_SAMPLE = """
import sys
import numpy as np
from pagnerf_tpu_torch.data import native
native.BUILD_DIR = sys.argv[1]
print(native.build())
print(native.sample_ray_indices(1, 4, 10, 3).tolist())
"""


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Six processes build into one empty directory at once (as six test
    workers do): each loads a library that samples, and one file remains."""
    build_dir = str(tmp_path / "_build")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_SAMPLE, build_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=root) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = [o.split("\n")[-3:-1] for o, _ in outs]
    assert len({path for path, _ in lines}) == 1
    ref = str(native_j.sample_ray_indices(1, 4, 10, 3).tolist())
    assert all(sample == ref for _, sample in lines)
    assert sorted(os.listdir(build_dir)) == [os.path.basename(lines[0][0])]

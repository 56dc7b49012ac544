"""ctypes bindings of the host data-path library ``data/csrc/batcher.cpp``
(counterpart of ``pagnerf_tpu/data/native.py``).

``sample_ray_indices`` draws each image's distinct ray pixels with the
library's xorshift128+ partial Fisher-Yates, the stream the JAX package's
batches come from; ``gather_pixels`` gathers [B, R, C] pixel modes;
``rle_decode`` decodes COCO's uncompressed runs.

The source is compiled with ``g++ -O3 -fPIC -shared`` at first use into
``pagnerf_tpu_torch/_build/`` (under a name hashed from the source and the
flags), written to a temporary name and renamed into place, so processes
that build at once never load a half-written library. There is no numpy
fallback for the sampler: a missing compiler raises, since another random
stream would train on other pixels than the JAX package does from the same
seed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "batcher.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 120


def find_cxx() -> str | None:
    """The C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on ``PATH``."""
    env = os.environ.get("CXX")
    if env:
        return shutil.which(env) or (env if os.path.isfile(env) else None)
    return shutil.which("g++") or shutil.which("c++")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbatcher_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``batcher.cpp`` unless its library exists; return its path.
    Raises naming the compiler if it is missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ (or $CXX, or c++) is not on PATH; "
                           "cannot build pagnerf_tpu_torch/data/csrc/batcher.cpp, "
                           "the ray sampler of every training batch")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                               f"batcher.cpp:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    lib = ctypes.CDLL(build())
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sample_ray_indices.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_uint64, i64, i64]
    lib.sample_ray_indices.restype = None
    for name, dt in (("gather_pixels_f32", np.float32), ("gather_pixels_i32", np.int32)):
        fn = getattr(lib, name)
        arr = np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
        fn.argtypes = [arr, i64, i64, arr] + [ctypes.c_int64] * 4
        fn.restype = None
    lib.rle_decode.argtypes = [i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                               np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.rle_decode.restype = None
    return lib


def sample_ray_indices(batch: int, num_rays: int, num_pixels: int,
                       seed: int) -> np.ndarray:
    """[batch, num_rays] int64 pixel indices per image: distinct (the
    library's partial Fisher-Yates) while the pool allows; with replacement
    from ``np.random.default_rng(seed)`` when ``num_rays`` exceeds it, as the
    JAX package draws them (the Fisher-Yates would divide by zero there)."""
    if num_rays > num_pixels:
        rng = np.random.default_rng(seed)
        return rng.integers(0, num_pixels, (batch, num_rays)).astype(np.int64)
    pool = np.empty(num_pixels, np.int64)
    out = np.empty((batch, num_rays), np.int64)
    load().sample_ray_indices(batch, num_rays, num_pixels, seed & (2 ** 64 - 1), pool, out)
    return out


def gather_pixels(src: np.ndarray, img_idx: np.ndarray,
                  ray_idx: np.ndarray) -> np.ndarray:
    """src [N_img, P, C] (or [N_img, P]) -> [B, R, C] (or [B, R]): image
    ``img_idx[b]``'s pixels ``ray_idx[b]``. float32 and int32 modes go
    through the library, other dtypes through numpy indexing (the same
    values)."""
    squeeze = src.ndim == 2
    s = src[..., None] if squeeze else src
    if s.dtype not in (np.float32, np.int32) or not s.flags.c_contiguous:
        out = s[np.asarray(img_idx)[:, None], ray_idx]
    else:
        b, r = ray_idx.shape
        out = np.empty((b, r, s.shape[-1]), s.dtype)
        lib = load()
        fn = lib.gather_pixels_f32 if s.dtype == np.float32 else lib.gather_pixels_i32
        fn(s, np.ascontiguousarray(img_idx, np.int64), np.ascontiguousarray(ray_idx, np.int64),
           out, b, r, s.shape[1], s.shape[2])
    return out[..., 0] if squeeze else out


def rle_decode(runs, h: int, w: int) -> np.ndarray:
    """COCO uncompressed runs (column-major, starting with background) ->
    [h, w] uint8 mask."""
    runs = np.ascontiguousarray(runs, np.int64)
    mask = np.zeros((h, w), np.uint8)
    load().rle_decode(runs, runs.shape[0], h, w, mask)
    return mask

"""The port's stand-ins for PIL, cv2 and PyYAML (``data/image_io.py``,
``config/yaml_lite.py``) and its small format modules (``coco``,
``utils_ply``, ``categories``, ``nerf_standard``, ``core/camera.
cv_to_gl_pose``, ``data/bup20_tree.py``) against the libraries and the JAX
package, on the CPU.

- PNG: ``read_png`` equals ``np.asarray(PIL.Image.open(...))`` (and its
  ``convert("RGB")`` / ``convert("L")``) on PIL-written files of every
  supported mode and on hand-made files of each of the five row filters;
  other modes raise. ``write_png``'s 16-bit grey reads back through PIL.
  At BUP20's 1280x720 the decode walls of both are printed.
- Resizes against ``cv2.resize`` at whole and at odd ratios: nearest
  exactly, linear within 1e-6 relative; Lanczos within one 8-bit code of
  PIL's ``resize`` (L, RGB and RGBA).
- Polygon fills against ``ImageDraw.polygon``: the fixtures' and degenerate
  polygons exactly; on random polygons the differing pixels are counted
  and each lies within one pixel of the polygon's edges (the rule in
  ROADMAP Queue 3 item 4): convex ones differ in at most 1 pixel of 500
  polygons, random (mostly self-intersecting) ones in at most 20 of 500.
- ``yaml_lite.load`` gives ``yaml.safe_load``'s value on what PyYAML's
  ``safe_dump`` writes for ``params.yaml``, ``BUP_20.yaml`` and NeRF
  transforms; ``dump`` writes nested lists PyYAML reads back.
- COCO masks (polygons, runs, compressed RLE; ``encode_rle`` round trips),
  PLY bounds and scales, the taxonomies, ``cv_to_gl_pose``: equal to the
  JAX package's.
- ``load_nerf_standard`` against the JAX one on the fixture of
  ``tests/test_nerf_standard_format.py``, mip 0 and 1, black and white
  backgrounds, and with an explicit val split.
- ``write_bup20_tree`` at 80x45: both packages load the tree to the same
  arrays (its Mask R-CNN and DeepLab predictions too), both validators
  report nothing, and the loader's rays re-render the depth the tree holds.
"""
import json
import struct
import time
import zlib

import cv2
import numpy as np
import pytest
import yaml
from PIL import Image, ImageDraw
from test_nerf_standard_format import nerf_root  # noqa: F401

from pagnerf_tpu.core import camera as camera_j
from pagnerf_tpu.data import utils_ply as ply_j
from pagnerf_tpu.data import validate as validate_j
from pagnerf_tpu.data.formats import bup20 as bup20_j
from pagnerf_tpu.data.formats import categories as cat_j
from pagnerf_tpu.data.formats import coco as coco_j
from pagnerf_tpu.data.formats import nerf_standard as nerf_j
from pagnerf_tpu_torch.config import yaml_lite
from pagnerf_tpu_torch.core import camera as camera_t
from pagnerf_tpu_torch.data import bup20_tree
from pagnerf_tpu_torch.data import image_io as io_t
from pagnerf_tpu_torch.data import synthetic as syn_t
from pagnerf_tpu_torch.data import utils_ply as ply_t
from pagnerf_tpu_torch.data import validate as validate_t
from pagnerf_tpu_torch.data.formats import bup20 as bup20_t
from pagnerf_tpu_torch.data.formats import categories as cat_t
from pagnerf_tpu_torch.data.formats import coco as coco_t
from pagnerf_tpu_torch.data.formats import nerf_standard as nerf_t
from pagnerf_tpu_torch.utils.visualization import write_png


# ------------------------------------------------------------------ PNG
def _photo(h, w, ch, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.sin(xx / 5.0) * 60 + np.cos(yy / 3.0) * 60 + 128
    shape = (h, w) if ch is None else (h, w, ch)
    noise = rng.normal(0, 20, shape)
    return np.clip((base if ch is None else base[..., None]) + noise, 0, 255)


def _pil_images(h, w):
    rgb = _photo(h, w, 3, 0).astype(np.uint8)
    return {
        "L": Image.fromarray(rgb[..., 0], "L"),
        "RGB": Image.fromarray(rgb, "RGB"),
        "RGBA": Image.fromarray(np.dstack([rgb, _photo(h, w, None, 1).astype(np.uint8)]),
                                "RGBA"),
        "P": Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE, colors=200),
        "P4": Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE, colors=12),
        "P1": Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE, colors=2),
        "I;16": Image.fromarray((_photo(h, w, None, 2) * 200).astype(np.uint16)),
    }


@pytest.mark.parametrize("size", [(12, 16), (37, 53), (1, 1), (180, 320)])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "P4", "P1", "I;16"])
def test_png_reads_equal_pil(tmp_path, mode, size):
    path = tmp_path / "x.png"
    _pil_images(*size)[mode].save(path)
    want = np.asarray(Image.open(path))
    got = io_t.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if want.dtype == np.uint8:
        for conv in ("RGB", "L"):
            np.testing.assert_array_equal(io_t.read_png(path, conv),
                                          np.asarray(Image.open(path).convert(conv)))
    assert io_t.png_size(path) == Image.open(path).size


def _write_filtered(path, img, ftypes, depth=8):
    """A PNG whose rows carry the given filter types (0-4)."""
    h = img.shape[0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bpp = ch * depth // 8
    raw = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = raw.reshape(h, -1).astype(np.int64)
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        x, t = rows[r], ftypes[r]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if t == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        else:
            pred = [0, a, b, (a + b) // 2][t] if t else 0
        out.append(bytes([t]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    header = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                     + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("kind", ["RGB", "RGBA", "L", "I;16"])
def test_png_row_filters(tmp_path, filters, kind):
    rng = np.random.default_rng(5)
    h, w = 9, 11
    img = {"RGB": rng.integers(0, 256, (h, w, 3)), "RGBA": rng.integers(0, 256, (h, w, 4)),
           "L": rng.integers(0, 256, (h, w)),
           "I;16": rng.integers(0, 65536, (h, w))}[kind]
    img = img.astype(np.uint16 if kind == "I;16" else np.uint8)
    ftypes = (rng.integers(0, 5, h).tolist() if filters == "mixed" else [int(filters)] * h)
    path = tmp_path / "f.png"
    _write_filtered(path, img, ftypes, 16 if kind == "I;16" else 8)
    np.testing.assert_array_equal(io_t.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("mode", ["LA", "1", "interlaced", "RGB16", "truncated", "crc"])
def test_png_outside_the_reader_raises(tmp_path, mode):
    path = tmp_path / "bad.png"
    if mode in ("LA", "1"):
        Image.new(mode, (4, 3)).save(path)
    elif mode in ("interlaced", "RGB16"):
        depth, interlace = (8, 1) if mode == "interlaced" else (16, 0)
        header = struct.pack(">IIBBBBB", 2, 2, depth, 2, 0, 0, interlace)
        body = b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + header
        path.write_bytes(body + struct.pack(">I", zlib.crc32(b"IHDR" + header)))
    else:
        Image.new("RGB", (8, 8)).save(path)
        data = bytearray(path.read_bytes())
        if mode == "truncated":
            data = data[:-20]
        else:
            data[20] ^= 0xFF
        path.write_bytes(bytes(data))
    with pytest.raises(io_t.PngError):
        io_t.read_png(path)


def test_write_png_16_bit_reads_back(tmp_path):
    img = (np.arange(12 * 16).reshape(12, 16) * 311).astype(np.uint16)
    write_png(str(tmp_path / "d.png"), img)
    assert Image.open(tmp_path / "d.png").mode == "I;16"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "d.png")), img)
    np.testing.assert_array_equal(io_t.read_png(tmp_path / "d.png"), img)


def _median_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


@pytest.mark.parametrize("writer", ["PIL", "paeth"])
@pytest.mark.parametrize("kind", ["rgb", "depth"])
def test_png_decode_at_bup20_size(tmp_path, kind, writer):
    """A photo-like 8-bit RGB frame and a 16-bit depth frame at BUP20's
    1280x720, written by PIL (which picks each row's filter) or with every
    row Paeth-filtered (the slowest rows to reconstruct), decode to PIL's
    arrays. Prints the row filters and the median decode walls of the port
    and of PIL on this host (``-k bup20_size -s``)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:720, :1280]
    base = np.sin(xx / 25.0) * 60 + np.cos(yy / 13.0) * 60 + 128
    if kind == "rgb":
        img = np.clip(base[..., None] + rng.normal(0, 25, (720, 1280, 3)), 0, 255)
        img = img.astype(np.uint8)
    else:
        img = np.clip(base * 10 + rng.normal(0, 200, (720, 1280)), 0, 65535).astype(np.uint16)
    path = str(tmp_path / f"{kind}.png")
    if writer == "PIL":
        Image.fromarray(img).save(path)
    else:
        write_png(path, img, paeth=True)
    got = io_t.read_png(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)
    data = open(path, "rb").read()
    idat = b"".join(body for name, body in io_t._chunks(data) if name == b"IDAT")
    row_filters = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(720, -1)[:, 0]
    print(json.dumps({"file": f"{kind} 1280x720 {img.dtype}", "written_by": writer,
                      "row_filters_0_to_4": np.bincount(row_filters, minlength=5).tolist(),
                      "port_ms": _median_ms(lambda: io_t.read_png(path)),
                      "pil_ms": _median_ms(lambda: np.asarray(Image.open(path)))}))


# ------------------------------------------------------------------ resizes
SIZES = [(12, 16), (45, 80), (180, 320), (7, 9), (1, 9), (9, 1)]


def _targets(h, w):
    return sorted({(h, w), (max(1, h // 2), max(1, w // 2)), (max(1, h // 4), max(1, w // 4)),
                   (max(1, h * 2 // 3), max(1, w * 3 // 5)), (h * 2, w * 3), (5, 3),
                   (h + 1, max(1, w - 1)), (1, 1)})


@pytest.mark.parametrize("size", SIZES)
def test_resize_linear_and_nearest_match_cv2(size):
    rng = np.random.default_rng(0)
    h, w = size
    for th, tw in _targets(h, w):
        for shape in ((h, w), (h, w, 3)):
            img = rng.random(shape).astype(np.float32) * 3
            want = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
            got = io_t.resize_linear(img, tw, th)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-6, atol=0)
            lab = rng.integers(-1, 60, shape[:2]).astype(np.int32)
            np.testing.assert_array_equal(
                io_t.resize_nearest(lab, tw, th),
                cv2.resize(lab, (tw, th), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("size", [(12, 16), (45, 80), (100, 100), (180, 320)])
def test_resize_lanczos_within_one_code_of_pil(mode, size):
    h, w = size
    ch = {"L": None, "RGB": 3, "RGBA": 4}[mode]
    img = _photo(h, w, ch, 3).astype(np.uint8)
    if mode == "RGBA":
        img[..., 3] = np.random.default_rng(1).choice([0, 17, 200, 255], size=(h, w))
    for th, tw in ((h // 2, w // 2), (h // 4, w // 4), (h * 2 // 3, w * 3 // 5),
                   (h * 2, w * 3), (h, w - 1)):
        if th < 1 or tw < 1:
            continue
        want = np.asarray(Image.fromarray(img, mode).resize((tw, th), Image.LANCZOS))
        got = io_t.resize_lanczos(img, tw, th)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(int) - want).max() <= 1


# ------------------------------------------------------------------ polygons
def _pil_fill(pts, h, w):
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon(pts, outline=1, fill=1)
    return np.asarray(img)


def _port_fill(pts, h, w):
    m = np.zeros((h, w), np.uint8)
    io_t.fill_polygon(m, pts)
    return m


@pytest.mark.parametrize("pts", [
    [(3.0, 3.0), (9.0, 3.0), (9.0, 7.0), (3.0, 7.0)],       # tests/test_bup20_format.py
    [(0, 0), (5, 0), (5, 5)], [(2, 2), (2, 2), (2, 2)], [(1, 1), (8, 1), (4, 1)],
    [(1, 1), (1, 8), (1, 4)], [(-3, -2), (20, 5), (4, 30)], [(1.5, 1.5), (6.5, 2.5), (3.49, 7.5)],
    [(0, 0), (10, 0), (10, 10), (5, 2), (0, 10)], [(2, 2), (8, 2), (8, 8), (2, 8), (2, 2)],
    [(5, 1), (9, 5), (5, 9), (1, 5)], [(1, 1), (4, 1), (7, 1), (7, 6), (1, 6)],
    [(7, 1), (4, 1), (1, 1), (1, 6), (7, 6)], [(15, 7), (0, 5), (12, 10)],
    [(6, 0), (10, 2), (10, 2)], [(-5, -5), (-1, -5), (-3, -1)], [(20, 3), (30, 3), (25, 9)],
])
def test_polygon_fill_equals_pil(pts):
    np.testing.assert_array_equal(_port_fill(pts, 12, 16), _pil_fill(pts, 12, 16))


def _edge_dist(px, py, q):
    """Distance of pixel (px, py) from the closed polygon q's edges."""
    out = np.inf
    for i in range(len(q)):
        a, b = q[i], q[(i + 1) % len(q)]
        d = np.subtract(b, a, dtype=float)
        n = d @ d
        t = 0.0 if n == 0 else np.clip(((px - a[0]) * d[0] + (py - a[1]) * d[1]) / n, 0, 1)
        out = min(out, np.hypot(px - (a[0] + t * d[0]), py - (a[1] + t * d[1])))
    return out


@pytest.mark.parametrize("kind", ["convex", "random"])
def test_polygon_fill_differs_only_at_edges(kind):
    rng = np.random.default_rng(0)
    h, w = 12, 16
    bad_polys = bad_px = 0
    for _ in range(500):
        n = int(rng.integers(3, 9))
        if kind == "random":
            pts = list(zip(rng.uniform(-3, w + 3, n).tolist(), rng.uniform(-3, h + 3, n).tolist()))
        else:
            c, r = rng.uniform(2, 12, 2), rng.uniform(1, 7)
            a = np.sort(rng.uniform(0, 2 * np.pi, n))
            pts = [(c[0] + r * np.cos(t), 0.8 * c[1] + r * np.sin(t)) for t in a]
        diff = np.argwhere(_port_fill(pts, h, w) != _pil_fill(pts, h, w))
        bad_polys += len(diff) > 0
        bad_px += len(diff)
        q = [(int(x), int(y)) for x, y in pts]
        for y, x in diff:
            assert _edge_dist(x, y, q) <= 1.0
    # measured: 1 pixel of 500 convex polygons, 16 pixels in 16 of 500 random ones
    assert bad_px <= (1 if kind == "convex" else 25) and bad_polys <= (1 if kind == "convex" else 20)


# ------------------------------------------------------------------ YAML
def _dumped():
    return {
        "params": yaml.safe_dump({"intrinsics": [[1150.5, 0.0, 640.25], [0.0, 1150.5, 360.0],
                                                 [0.0, 0.0, 1.0]],
                                  "extrinsics": np.eye(4).tolist()}),
        "image_sets": yaml.safe_dump({"image_sets": {"eval": [43, 44, 45], "train": [],
                                                     "valid": [1]}}),
        "transforms": yaml.safe_dump({"camera_angle_x": 0.8, "frames": [
            {"file_path": f"r_{i}", "transform_matrix": (np.eye(4) * (i + 1)).tolist()}
            for i in range(2)]}),
        "flow": yaml.safe_dump({"a": [[1, 2], [3, [4, "x y"]]], "b": [{"c": [1]}, 2, None]},
                               default_flow_style=None),
        "top_list": yaml.safe_dump([{"a": 1}, [2, 3], "z"]),
    }


@pytest.mark.parametrize("name", list(_dumped()))
def test_yaml_reads_pyyaml_dumps(name):
    text = _dumped()[name]
    assert yaml_lite.load(text) == yaml.safe_load(text)


def test_yaml_writer_nested_lists():
    value = {"intrinsics": [[1.5, 0.0, 8.0], [0.0, 1.5, 6.0], [0.0, 0.0, 1.0]],
             "image_sets": {"eval": [1, 2], "train": []}, "deep": [[[1], []], [2]]}
    text = yaml_lite.dump(value)
    assert yaml_lite.load(text) == value == yaml.safe_load(text)
    with pytest.raises(yaml_lite.YamlLiteError):
        yaml_lite.dump({"k": [{"a": 1}]})


# ------------------------------------------------------------------ COCO
def test_coco_masks_equal_jax():
    rng = np.random.default_rng(0)
    h, w = 12, 16
    for k in range(60):
        m = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        if k % 7 == 0:
            m[:] = k % 2
        rle = coco_t.encode_rle(m)
        np.testing.assert_array_equal(coco_j.ann_to_mask({"segmentation": rle}, h, w), m)
        np.testing.assert_array_equal(coco_t.ann_to_mask({"segmentation": rle}, h, w), m)
        runs = {"segmentation": {"size": [h, w], "counts": coco_t.mask_to_runs(m)}}
        np.testing.assert_array_equal(coco_t.ann_to_mask(runs, h, w), m)
        np.testing.assert_array_equal(coco_j.ann_to_mask(runs, h, w), m)
        xy = rng.uniform(-2, 18, 2 * int(rng.integers(3, 7))).tolist()
        poly = {"segmentation": [xy, [1.0, 1.0, 4.0, 1.0]]}
        q = [(int(x), int(y)) for x, y in zip(xy[::2], xy[1::2])]
        for y, x in np.argwhere(coco_t.ann_to_mask(poly, h, w) != coco_j.ann_to_mask(poly, h, w)):
            assert _edge_dist(x, y, q) <= 1.0           # the fill's edge rule
    assert coco_t.ann_to_mask({}, h, w).sum() == 0


# ------------------------------------------------------------------ PLY
@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
@pytest.mark.parametrize("mode", ["largest", "snap_to_bottom", "scale_to_fit"])
def test_ply_scale_equals_jax(tmp_path, fmt, mode):
    pts = np.random.default_rng(1).normal(0, 2, (20, 3)).astype(np.float32)
    head = (f"ply\nformat {fmt} 1.0\nelement vertex 20\nproperty float x\nproperty float y\n"
            "property float z\nproperty uchar red\nelement face 0\n"
            "property list uchar int vertex_indices\nend_header\n")
    path = tmp_path / "m.ply"
    if fmt == "ascii":
        path.write_text(head + "".join(f"{x} {y} {z} 7\n" for x, y, z in pts))
    else:
        e = "<" if "little" in fmt else ">"
        rec = np.zeros(20, dtype=[("p", f"{e}f4", 3), ("c", "u1")])
        rec["p"] = pts
        path.write_bytes(head.encode() + rec.tobytes())
    assert [np.asarray(v).tolist() for v in ply_t.read_ply_vertex_bounds(path)] == \
        [np.asarray(v).tolist() for v in ply_j.read_ply_vertex_bounds(path)]
    assert ply_t.get_scale_from_ply_mesh(path, mode) == ply_j.get_scale_from_ply_mesh(path, mode)
    assert ply_t.get_scale_from_ply_mesh(tmp_path / "none.ply") == (None, None)


def test_taxonomies_and_pose_flip_equal_jax():
    for name in dir(cat_j):
        v = getattr(cat_j, name)
        if not name.startswith("_") and isinstance(v, (list, dict)):
            assert getattr(cat_t, name) == v, name
    sem = np.random.default_rng(0).integers(0, 150, (5, 7))
    np.testing.assert_array_equal(cat_t.ade20k_to_replica(sem), cat_j.ade20k_to_replica(sem))
    pose = np.random.default_rng(1).normal(size=(3, 4, 4))
    np.testing.assert_array_equal(camera_t.cv_to_gl_pose(pose), camera_j.cv_to_gl_pose(pose))


# ------------------------------------------------------------------ NeRF standard
def _assert_nerf_equal(dt, dj):
    assert sorted(dt) == sorted(dj)
    for k, a in dj.items():
        b = dt[k]
        if k == "intrinsics":
            assert vars(b) == vars(a)
        elif k in ("imgs",):
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b, a)
        elif isinstance(a, np.ndarray) or hasattr(a, "shape"):
            np.testing.assert_allclose(np.asarray(b).reshape(np.shape(a)), np.asarray(a),
                                       rtol=0, atol=1e-6, err_msg=k)
        else:
            assert b == a, k


@pytest.mark.parametrize("mip", [0, 1])
@pytest.mark.parametrize("bg", ["white", "black"])
def test_nerf_standard_equals_jax(nerf_root, mip, bg):  # noqa: F811
    _assert_nerf_equal(nerf_t.load_nerf_standard(str(nerf_root), mip=mip, bg_color=bg),
                       nerf_j.load_nerf_standard(str(nerf_root), mip=mip, bg_color=bg))


def test_nerf_standard_splits_and_intrinsics_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    for split, n in (("train", 3), ("val", 2)):
        frames = []
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (12, 16, 3)).astype(np.uint8)).save(
                tmp_path / f"{split}_{i}.png")
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3)
            frames.append({"file_path": f"{split}_{i}", "transform_matrix": c2w.tolist()})
        meta = {"fl_x": 25.0, "fl_y": 26.0, "cx": 7.0, "cy": 5.0, "aabb_scale": 2.0,
                "scale": 0.5, "offset": [0.1, 0.0, -0.2], "frames": frames}
        (tmp_path / f"transforms_{split}.json").write_text(json.dumps(meta))
    for mip in (0, 1):
        _assert_nerf_equal(nerf_t.load_nerf_standard(str(tmp_path), mip=mip),
                           nerf_j.load_nerf_standard(str(tmp_path), mip=mip))


# ------------------------------------------------------------------ tree writer
@pytest.fixture(scope="module")
def written_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("written") / "BUP_20"
    return root, bup20_tree.write_bup20_tree(str(root), width=80, height=45)


def test_written_tree_loads_and_validates_as_jax(written_tree):
    root, stamps = written_tree
    assert validate_t.validate_bup20_tree(root, deep=True) == []
    assert validate_j.validate_bup20_tree(root, deep=True) == []
    kw = dict(dataset_center_idx=5, max_depth=1.4)
    dt, dj = bup20_t.load_data(root, **kw), bup20_j.load_data(root, **kw)
    for k in ("imgs", "semantics", "instance", "semantics_pred", "instance_pred"):
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    for k in ("depths", "sem_conf", "inst_conf"):
        np.testing.assert_allclose(dt[k], dj[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(dt["view_matrices"], dj["view_matrices"], atol=1e-6)
    assert len(dt["train_idxs"]) == 39 and len(dt["val_idxs"]) == 41
    # the metashape cameras hold the same poses
    meta = bup20_t.load_data(root, pose_src="metashape", **kw)
    np.testing.assert_allclose(meta["view_matrices"], dt["view_matrices"], atol=1e-6)
    assert validate_t.validate_bup20_tree(root, pose_src="metashape") == []
    # the centre frame (47) is labelled with every visible sphere
    c = dt["filenames"].index(f"{stamps[47]}.png")
    assert c in dt["val_idxs"] and dt["instance"][c].max() >= 3
    # the depth filter dropped the spheres beyond max_depth from the predictions
    assert 0 < len(np.unique(dt["instance_pred"][c])) < len(np.unique(
        bup20_t.load_data(root, dataset_center_idx=5)["instance_pred"][c]))


@pytest.mark.parametrize("preds", ["preds_maskrcnn", "preds_deeplab"])
def test_written_tree_predictions_load_as_jax(written_tree, preds):
    """The Mask R-CNN and DeepLab predictions the tree also holds (the
    ``_app`` configs' load modes): both packages load them to the same
    arrays, with and without the depth filter, and they carry the
    Mask2Former predictions' instance map."""
    root, stamps = written_tree
    modes = ["imgs", "semantics", "instance", preds]
    for kw in (dict(dataset_center_idx=5), dict(dataset_center_idx=5, max_depth=1.4)):
        dt = bup20_t.load_data(root, load_modes=modes, **kw)
        dj = bup20_j.load_data(root, load_modes=modes, **kw)
        for k in ("semantics_pred", "instance_pred", "sem_conf", "inst_conf"):
            assert dt[k].dtype == dj[k].dtype, k
            np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    m2f = bup20_t.load_data(root, dataset_center_idx=5)
    c = dt["filenames"].index(f"{stamps[47]}.png")
    unfiltered = bup20_t.load_data(root, load_modes=modes, dataset_center_idx=5)
    np.testing.assert_array_equal(unfiltered["instance_pred"][c], m2f["instance_pred"][c])
    assert unfiltered["instance_pred"][c].max() >= 2


def test_written_tree_rays_see_its_depth(written_tree):
    root, _ = written_tree
    data = bup20_t.load_data(root, dataset_center_idx=5)
    scene = syn_t.default_scene(4, 0)
    cam = data["base_rays_dirs"].reshape(-1, 3)
    for i in (0, 40, 79):
        o = data["rays_origins"][i].reshape(-1, 3).astype(np.float64)
        d = data["rays_dirs"][i].reshape(-1, 3).astype(np.float64)
        _, _, inst, t = syn_t._render_analytic(scene, o, d, backdrop=False)
        z = t * np.abs(cam[:, 2]) * 1000.0
        got = data["depths"][i].reshape(-1)
        # away from silhouettes the loader's rays hit what the tree's depth holds
        inner = (inst.reshape(45, 80) == syn_t._erode3(inst.reshape(45, 80) > 0) * inst.reshape(
            45, 80)).reshape(-1) & (inst > 0)
        assert inner.sum() > 100
        np.testing.assert_allclose(got[inner], z[inner], atol=1.0)
        assert (got[inst == 0] == 0).mean() > 0.95

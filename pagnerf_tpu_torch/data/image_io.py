"""Images without PIL or cv2: what the dataset readers need of them.

The card's machine has neither, so the port reads and resizes its images in
numpy, each function repeating the library call the JAX package's readers
make:

- ``read_png``: a PNG decoder (``zlib``; not interlaced) for 8-bit grey,
  RGB, RGBA, palette images (1, 2, 4 or 8 bits, as PIL writes small
  palettes) and 16-bit grey, returning what
  ``np.asarray(PIL.Image.open(path))`` returns (palette indices for a
  palette image). ``mode="RGB"`` / ``"L"`` give ``Image.convert``'s
  result. Anything else raises ``PngError``. Rows filtered with "Average"
  or "Paeth" depend on the reconstructed pixel to their left, so an image
  holding such rows is reconstructed along anti-diagonals (one numpy step
  per diagonal, all rows at once); images of "None", "Sub" and "Up" rows
  go row by row.
- ``resize_linear``: ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)``
  of a float32 image, with cv2 5's arithmetic (tap positions in double,
  each pass a float32 ``fma``); an exact halving takes the same path.
- ``resize_nearest``: ``cv2.INTER_NEAREST``, which takes source pixel
  ``floor(dst * scale)``, not the pixel under the destination's centre.
- ``resize_lanczos``: PIL's ``Image.resize(..., LANCZOS)`` of an 8-bit L,
  RGB or RGBA image (RGBA through premultiplied alpha, as PIL does):
  separable, coefficients in PIL's fixed point, rounded and clipped after
  each pass.
- ``fill_polygon``: ``ImageDraw.polygon(points, fill=1, outline=1)`` on a
  zero 8-bit image: vertices rounded to whole pixels, horizontal edges
  drawn, each scanline filled between its sorted edge crossings with PIL's
  rounding and its corner rule.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


class PngError(ValueError):
    """The file is not a PNG this reader supports."""


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngError("truncated chunk")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise PngError(f"bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PngError("no IEND chunk")


def png_size(path) -> Tuple[int, int]:
    """(width, height) from a PNG's header, as ``Image.open(path).size``."""
    with open(path, "rb") as f:
        head = f.read(33)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise PngError(f"{path} is not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return w, h


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of "None", "Sub" and "Up" filters, one row at a time."""
    h, stride = filt.shape
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        row = filt[r]
        if ftype[r] == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype[r] == 2:
            row = row + prior
        out[r] = row
        prior = out[r]
    return out


def _unfilter_diagonals(ftype: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1),
    so all pixels with r + x = d are reconstructed together, d ascending.
    ``s`` holds pixel (r, x) at [d + 2, r + 1], one diagonal per row of
    ``s``: the entries outside the image stay zero, the PNG's values there,
    and the three neighbours are slices of the two diagonals before."""
    h, stride = filt.shape
    w = stride // bpp
    rows = np.arange(h)
    diag = rows[:, None] + np.arange(w)[None, :]                    # [h, w] -> d
    f = np.zeros((w + h - 1, h, bpp), np.int16)
    f[diag, rows[:, None]] = filt.reshape(h, w, bpp)
    s = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    t = ftype[:, None]
    sub, up, avg, paeth = (t == 1), (t == 2), (t == 3), (t == 4)
    for d in range(w + h - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = s[d + 1, r0 + 1:r1 + 1]
        b = s[d + 1, r0:r1]
        c = s[d, r0:r1]
        pred = np.where(sub[r0:r1], a, np.where(up[r0:r1], b, 0))
        if avg[r0:r1].any():
            pred = np.where(avg[r0:r1], (a + b) >> 1, pred)
        if paeth[r0:r1].any():
            pred = np.where(paeth[r0:r1], _paeth(a, b, c), pred)
        s[d + 2, r0 + 1:r1 + 1] = (f[d, r0:r1] + pred) & 0xFF
    return s[diag + 2, rows[:, None] + 1].astype(np.uint8).reshape(h, stride)


def _decode(data: bytes) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """(samples [H, W] or [H, W, C], colour type, palette [n, 3] or None)."""
    if not data.startswith(_SIGNATURE):
        raise PngError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("no IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _CHANNELS or comp != 0 or filt_method != 0:
        raise PngError(f"colour type {ctype} (compression {comp}, filter method "
                       f"{filt_method}) is not supported")
    if interlace != 0:
        raise PngError("interlaced PNGs are not supported")
    if not (depth == 8 or (depth == 16 and ctype == 0)
            or (depth in (1, 2, 4) and ctype == 3)):
        raise PngError(f"bit depth {depth} of colour type {ctype} is not supported")
    if ctype == 3 and palette is None:
        raise PngError("a palette image without a PLTE chunk")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise PngError(f"image data holds {raw.size} bytes, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    ftype, filt = raw[:, 0], raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise PngError(f"unknown row filter {int(ftype.max())}")
    if (ftype >= 3).any():
        rows = _unfilter_diagonals(ftype, filt, bpp)
    else:
        rows = _unfilter_rows(ftype, filt, bpp)
    if depth == 16:
        out = rows.view(">u2").astype(np.uint16).reshape(h, w)
    elif depth < 8:
        # palette indices packed most significant bits first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        out = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        out = np.ascontiguousarray(out, np.uint8)
    else:
        out = rows.reshape(h, w, ch) if ch > 1 else rows.reshape(h, w)
    return out, ctype, palette


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def read_png(path, mode: Optional[str] = None) -> np.ndarray:
    """A PNG's samples as ``np.asarray(PIL.Image.open(path))`` gives them
    (``mode=None``), or ``Image.open(path).convert(mode)``'s for ``"RGB"``
    and ``"L"`` (8-bit images only)."""
    with open(path, "rb") as f:
        arr, ctype, palette = _decode(f.read())
    if mode is None:
        return arr
    if arr.dtype != np.uint8:
        raise PngError(f"converting a {arr.dtype} image to {mode!r} is not supported")
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        rgb = pal[arr]
    elif ctype == 0:
        rgb = None
    else:
        rgb = arr[..., :3]
    if mode == "RGB":
        return np.repeat(arr[..., None], 3, axis=-1) if rgb is None else np.ascontiguousarray(rgb)
    if mode == "L":
        return arr.copy() if rgb is None else _luma(rgb)
    raise PngError(f"mode {mode!r} is not supported")


# ------------------------------------------------------------------ resizes
def _cv_scale(src: int, dst: int) -> float:
    """cv2's source step per destination pixel: 1 / (dst / src) in double."""
    return 1.0 / (dst / src)


def nearest_index(src: int, dst: int) -> np.ndarray:
    """The source index cv2.INTER_NEAREST takes for each destination index."""
    ifx = _cv_scale(src, dst)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``."""
    ys = nearest_index(img.shape[0], h)
    xs = nearest_index(img.shape[1], w)
    return img[ys[:, None], xs[None, :]].copy()


def _linear_taps(src: int, dst: int, exact: bool):
    """cv2's INTER_LINEAR taps: (i0, i1, w0, w1) per destination index, the
    weights float32. cv2 5 takes the source position ``(dst + 0.5) * scale
    - 0.5`` in double for a 2-D image (``exact``) and rounds it to float32
    first for an image of one row or one column."""
    scale = _cv_scale(src, dst)
    fx = (np.arange(dst) + 0.5) * scale - 0.5
    if not exact:
        fx = fx.astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    low = sx < 0
    fx[low], sx[low] = 0.0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0.0, src - 1
    return sx, np.minimum(sx + 1, src - 1), (np.float32(1.0) - fx), fx


def _lerp(lo: np.ndarray, hi: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``fma(hi - lo, t, lo)`` in float32 (the product of two float32 is
    exact in float64)."""
    return ((hi - lo).astype(np.float64) * t + lo).astype(np.float32)


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float32 [H, W] or [H, W, C] image: the horizontal pass, then the
    vertical one, each a float32 ``fma(b - a, t, a)`` as cv2 5 computes
    it for a 2-D image (an image of one row or column: ``a*(1-t) + b*t``)."""
    img = np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img.copy()
    exact = sh > 1 and sw > 1
    x0, x1, a0, a1 = _linear_taps(sw, w, exact)
    y0, y1, b0, b1 = _linear_taps(sh, h, exact)
    extra = (None,) * (img.ndim - 2)
    ax0, ax1 = a0[(slice(None),) + extra], a1[(slice(None),) + extra]
    by0 = b0[(slice(None), None) + extra]
    by1 = b1[(slice(None), None) + extra]
    if exact:
        rows = _lerp(img[:, x0], img[:, x1], ax1[None])
        return _lerp(rows[y0], rows[y1], by1)
    rows = img[:, x0] * ax0[None] + img[:, x1] * ax1[None]
    return (rows[y0] * by0 + rows[y1] * by1).astype(np.float32)


_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        v = v * np.pi
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(v == 0.0, 1.0, np.sin(v) / np.where(v == 0.0, 1.0, v))
    return np.where((x > -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    Lanczos filter (support 3): per destination pixel its first source
    pixel and fixed-point weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = _lanczos((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        fixed = k * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(fixed < 0, fixed - 0.5, fixed + 0.5).astype(np.int64)
        bounds[xx] = xmin
    return bounds, kk


def _lanczos_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of an int [H, W, C] image, rounded and
    clipped to 8 bits as PIL's ``ImagingResample{Horizontal,Vertical}_8bpc``."""
    in_size = img.shape[axis]
    bounds, kk = _lanczos_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    idx = np.minimum(bounds[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * kk[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.LANCZOS)`` of a uint8
    [H, W] (L), [H, W, 3] (RGB) or [H, W, 4] (RGBA) image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] in (3, 4)):
        raise ValueError(f"Lanczos resizes 8-bit L, RGB or RGBA images, not "
                         f"{img.dtype} {img.shape}")
    x = img[..., None] if img.ndim == 2 else img
    x = x.astype(np.int64)
    rgba = x.shape[2] == 4
    if rgba:
        # RGBA -> RGBa: MULDIV255(c, a) = ((c*a + 128) >> 8) + (c*a + 128)) >> 8
        t = x[..., :3] * x[..., 3:] + 128
        x = np.concatenate([((t >> 8) + t) >> 8, x[..., 3:]], axis=-1)
    if x.shape[1] != w:
        x = _lanczos_pass(x, w, 1)
    if x.shape[0] != h:
        x = _lanczos_pass(x, h, 0)
    if rgba:
        a = x[..., 3:]
        keep = (a == 255) | (a == 0)
        unp = np.clip((255 * x[..., :3]) // np.maximum(a, 1), 0, 255)
        x = np.concatenate([np.where(keep, x[..., :3], unp), a], axis=-1)
    out = x.astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


# ------------------------------------------------------------------ polygons
def _round_up(v: float) -> int:
    """PIL's ROUND_UP: halves away from zero."""
    return int(np.floor(v + 0.5)) if v >= 0.0 else -int(np.floor(abs(v) + 0.5))


def _round_down(v: float) -> int:
    """PIL's ROUND_DOWN: halves toward zero."""
    return int(np.ceil(v - 0.5)) if v >= 0.0 else -int(np.ceil(abs(v) - 0.5))


def _roundf(v: np.float32) -> np.float32:
    return np.float32(np.sign(v) * np.floor(abs(np.float64(v)) + 0.5))


class _Edge:
    __slots__ = ("xmin", "xmax", "ymin", "ymax", "dx", "x0", "y0")

    def __init__(self, x0, y0, x1, y1):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = (np.float32(0.0) if y0 == y1
                   else np.float32(np.float32(x1 - x0) / np.float32(y1 - y0)))
        self.x0, self.y0 = x0, y0

    def x_at(self, y: int) -> np.float32:
        return np.float32(np.float32(np.float32(y - self.y0) * self.dx) + np.float32(self.x0))


def _edges(xy: Sequence[int]):
    """PIL's edge list of a filled polygon: consecutive horizontal edges
    running the same way merge; the polygon closes if it is open."""
    count = len(xy) // 2
    edges = []
    i = 0
    for i in range(count - 1):
        x0, y0, x1, y1 = xy[2 * i], xy[2 * i + 1], xy[2 * i + 2], xy[2 * i + 3]
        if y0 == y1 and i != 0 and y0 == xy[2 * i - 1]:
            last = edges[-1]
            if x1 > x0 > xy[2 * i - 2]:
                last.xmax = x1
                continue
            if x1 < x0 < xy[2 * i - 2]:
                last.xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    i = count - 1
    if xy[2 * i] != xy[0] or xy[2 * i + 1] != xy[1]:
        edges.append(_Edge(xy[2 * i], xy[2 * i + 1], xy[0], xy[1]))
    return edges


def _hline(mask: np.ndarray, x0: int, y: int, x1: int) -> None:
    h, w = mask.shape
    if not 0 <= y < h:
        return
    if x0 < 0:
        x0 = 0
    elif x0 >= w:
        return
    if x1 < 0:
        return
    if x1 >= w:
        x1 = w - 1
    if x0 <= x1:
        mask[y, x0:x1 + 1] = 1


def fill_polygon(mask: np.ndarray, points: Sequence[Tuple[float, float]]) -> None:
    """Fill ``points`` [(x, y), ...] into the uint8 [H, W] ``mask`` with 1,
    as ``ImageDraw.Draw(img).polygon(points, fill=1, outline=1)`` does."""
    xy = []
    for x, y in points:
        xy += [int(x), int(y)]           # PIL truncates the vertices
    edges = _edges(xy)
    h = mask.shape[0]
    ymin, ymax = h - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            _hline(mask, e.xmin, e.ymin, e.xmax)
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x_at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif cur.dx != 0 and _roundf(xx[-1]) == xx[-1]:
                # connect discontiguous corners
                for other in table[:i]:
                    if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
                        continue
                    if not (((y == cur.ymin and y == other.ymin)
                             or (y == cur.ymax and y == other.ymax))
                            and xx[-1] == other.x_at(y)):
                        continue
                    off = -1 if y == cur.ymax else 1
                    adj = cur.x_at(y + off)
                    if other.ymin <= y + off <= other.ymax:
                        adj_other = other.x_at(y + off)
                        if xx[-1] > adj + 1 and xx[-1] > adj_other + 1:
                            xx[-1] = np.float32(_roundf(np.float32(max(adj, adj_other))) + 0.5)
                        elif xx[-1] < adj - 1 and xx[-1] < adj_other - 1:
                            xx[-1] = np.float32(_roundf(np.float32(min(adj, adj_other))) - 0.5)
                        break
        xx.sort()
        for i in range(1, len(xx), 2):
            _hline(mask, _round_up(float(xx[i - 1])), y, _round_down(float(xx[i])))

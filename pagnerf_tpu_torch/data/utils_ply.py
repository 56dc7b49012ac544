"""Scene scale and offset from PLY mesh bounds (counterpart of
``pagnerf_tpu/data/utils_ply.py``): the vertex bounds of an ASCII or binary
PLY file, read without dependencies, and the scale and offset that place
the scene in the unit cube (``get_scale_from_ply_mesh``, the reference's
'largest' / 'snap_to_bottom' / 'scale_to_fit' modes).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_ply_vertex_bounds(path) -> Tuple[np.ndarray, np.ndarray]:
    """Return (min_xyz, max_xyz) of the vertex positions."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_verts = int(next(l.split()[2] for l in header
                           if l.startswith("element vertex")))
        # vertex property layout
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif in_vertex and l.startswith("property"):
                props.append(tuple(l.split()[1:]))
        type_size = {"float": 4, "float32": 4, "double": 8, "float64": 8,
                     "uchar": 1, "uint8": 1, "char": 1, "int8": 1,
                     "short": 2, "ushort": 2, "int": 4, "uint": 4,
                     "int32": 4, "uint32": 4}

        if fmt == "ascii":
            pts = []
            names = [p[1] for p in props]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            for _ in range(n_verts):
                vals = f.readline().split()
                pts.append((float(vals[xi]), float(vals[yi]), float(vals[zi])))
            arr = np.asarray(pts)
        else:
            stride = sum(type_size[p[0]] for p in props)
            offs, names = [], []
            o = 0
            for t, name in props:
                offs.append(o)
                names.append(name)
                o += type_size[t]
            raw = f.read(n_verts * stride)
            endian = ">" if "big_endian" in fmt else "<"
            def col(name):
                i = names.index(name)
                dt = f"{endian}f4" if type_size[props[i][0]] == 4 else f"{endian}f8"
                return np.frombuffer(raw, dtype=np.uint8).reshape(n_verts, stride)[
                    :, offs[i]:offs[i] + type_size[props[i][0]]].copy().view(dt)[:, 0]
            arr = np.stack([col("x"), col("y"), col("z")], -1).astype(np.float64)
    return arr.min(0), arr.max(0)


def get_scale_from_ply_mesh(path, model_rescaling: str = "snap_to_bottom"
                            ) -> Tuple[Optional[float], Optional[list]]:
    """Scene scale/offset placing the mesh in [-1, 1]^3
    (reference datasets/utils.py:7-33)."""
    try:
        lo, hi = read_ply_vertex_bounds(path)
    except Exception:
        return None, None
    center = (lo + hi) / 2.0
    extent = hi - lo
    if model_rescaling == "largest":
        # largest XYZ bound, shrunk 2% (reference datasets/utils.py:17-19)
        scale = 0.98 * 2.0 / max(extent.max(), 1e-9)
        offset = (-center * scale).tolist()
    elif model_rescaling == "scale_to_fit":
        scale = 2.0 / max(np.linalg.norm(extent), 1e-9)
        offset = (-center * scale).tolist()
    else:  # snap_to_bottom: scale by the largest XY bound (NOT Z —
        # reference utils.py:23), centre x/y, floor at z = -1
        scale = 2.0 / max(extent[:2].max(), 1e-9)
        offset = [-center[0] * scale, -center[1] * scale, -lo[2] * scale - 1.0]
    return scale, offset

"""The dual table gather (``ops/csrc/permuto_gather.cu``, packed rows)
against the single gather and against another version of its source, on the
CUDA card.

    python -m pagnerf_tpu_torch.profile_gather [--parent OLD.cu] [--out FILE]

Two shapes, float32 and bfloat16, random tables: V = 4 at the flagship
render's N = 1,572,864 (24 levels of 2^18 rows, F = 2; idx and bary from the
port's lattice at the render's sample coordinates) and V = 8 at the hash
path's N = 1,048,576 (14 levels of 2^19 rows, F = 2; the hash indices of
the first 1,048,576 of those ray-ordered coordinates). For each: the dual
gather through its wrapper on the kept packed copy, and with a fresh pack a
call (the copy a caller pays for once its tables changed: a table's version
is bumped before each call), the dual kernel alone on packed rows, the
single gather (wrapper and kernel alone), ms (CUDA events, L2 evicted
before each launch, median of 10; through a wrapper its host time counts
too) and bounds; the dual outputs against two single gathers bit for bit.
With ``--parent``: another version
of ``permuto_gather.cu`` whose C entry ``pagnerf_permuto_gather`` takes the
two tables apart (table_a, table_b, idx, bary, out_a, out_b, levels,
capacity, n, feat, num_tables, dtype, verts, stream), built with this
package's nvcc flags; its dual outputs against this one's bit for bit and
both kernels alone in turns (parent, this, this, parent, twice). One JSON object
per shape and dtype; exits with an error after the last if outputs were
not bit-equal.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from .ops import table_gather as tg

HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, flush, reps: int = 10) -> float:
    """Median device ms of ``fn()`` over ``reps`` launches after a warm-up,
    CUDA events around each, ``flush()`` (outside the span) before each."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(l, f, n, v, itemsize, table_rows, num_tables) -> float:
    """Bytes the gather must move over the memory rate: idx (int32) and
    bary read once, each table's reachable rows read once, each output
    written once (its arithmetic is far below the float32 rate)."""
    nbytes = l * v * n * (4 + itemsize) + num_tables * (table_rows * f * itemsize
                                                        + l * f * n * itemsize)
    return nbytes / HBM_BYTES_PER_S * 1e3


def shapes(dev):
    """{name: (idx, bary32, capacity, reachable rows of all levels)}."""
    import numpy as np

    from .entry import entry
    from .ops import hash_encoding, permuto_encoding
    from .profile_encode import render_coords

    _, (pipe, origins, dirs, cam_idx) = entry(device=dev)
    x = render_coords(pipe, origins, dirs, cam_idx)
    spec = pipe.nef.grid.spec
    with torch.no_grad():
        idx4, bary4 = permuto_encoding.lattice(pipe.nef.grid.tables, x, spec.scales)
    rows4 = permuto_encoding.level_statics(spec.scales, spec.capacity,
                                           spec.feature_dim).rows_used
    del pipe
    hspec = hash_encoding.HashEncodingSpec(14, 2, 19)
    with torch.no_grad():
        idx8, bary8 = hash_encoding.hash_indices(x[:, :1 << 20].contiguous(),
                                                 hspec.resolutions, 19)
    rows8 = [min((int(r) + 1) ** 3, hspec.capacity) for r in np.asarray(hspec.resolutions)]
    return {"v4_render": (idx4, bary4, spec.capacity,
                          sum(min(r or spec.capacity, spec.capacity) for r in rows4)),
            "v8_hash": (idx8, bary8.contiguous(), hspec.capacity, sum(rows8))}


def parent_entry(source: str, workdir: str):
    """Build another ``permuto_gather.cu``; return a dual gather
    ``(ta, tb, idx, bary) -> (out_a, out_b)`` at its two-table C interface."""
    from .profile_encode import _nvcc
    lib_path = os.path.join(workdir, "libparent_gather.so")
    _nvcc(source, lib_path)
    fn = ctypes.CDLL(lib_path).pagnerf_permuto_gather
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def dual(ta, tb, idx, bary):
        l, c, f = ta.shape
        n = idx.shape[2]
        oa, ob = (torch.empty((l, f, n), dtype=ta.dtype, device=ta.device) for _ in range(2))
        err = fn(ta.data_ptr(), tb.data_ptr(), idx.data_ptr(), bary.data_ptr(),
                 oa.data_ptr(), ob.data_ptr(), l, c, n, f, 2, tg._DTYPE_CODE[ta.dtype],
                 idx.shape[1], torch.cuda.current_stream(ta.device).cuda_stream)
        if err:
            raise RuntimeError(f"parent permuto_gather launch failed: cudaError_t {err}")
        return oa, ob
    return dual


def time_dual(ta, tb, idx, bary, flush, parent=None) -> dict:
    """The dual gather's times on one shape (see the module's docstring):
    through the wrapper (``ms``: the kept copy; ``ms_with_pack``: a fresh
    pack a call; the wrapper's host time counts while the card waits for
    it), and the kernel alone (``kernel_ms``: the C entry on the packed
    rows, as the parent's is called)."""
    kept = lambda: tg.dual_multilevel_table_gather(ta, tb, idx, bary)

    def fresh():
        torch.autograd.graph.increment_version(ta)      # as an update does
        return tg.dual_multilevel_table_gather(ta, tb, idx, bary)

    got = kept()
    packed = torch.cat((ta, tb), dim=2)
    kernel = lambda: tg._launch(packed, 2, idx, bary)
    singles = (tg.multilevel_table_gather(ta, idx, bary),
               tg.multilevel_table_gather(tb, idx, bary))
    rec = dict(dual_equals_singles=all(torch.equal(a, b) for a, b in zip(got, singles)),
               ms=cuda_ms(kept, flush), ms_with_pack=cuda_ms(fresh, flush),
               kernel_ms=cuda_ms(kernel, flush),
               pack_ms=cuda_ms(lambda: torch.cat((ta, tb), dim=2), flush),
               single_ms=cuda_ms(lambda: tg.multilevel_table_gather(ta, idx, bary), flush),
               single_kernel_ms=cuda_ms(lambda: tg._launch(ta, 1, idx, bary), flush))
    if parent is not None:
        old = parent(ta, tb, idx, bary)
        rec["parent_equal"] = all(torch.equal(a, b) for a, b in zip(old, got))
        turns = {"parent": [], "this": []}
        for which in ("parent", "this", "this", "parent") * 2:
            fn = (lambda: parent(ta, tb, idx, bary)) if which == "parent" else kernel
            turns[which].append(cuda_ms(fn, flush))
        rec["turns_ms"] = turns
        rec["parent_ms"] = statistics.mean(turns["parent"])
        rec["this_ms"] = statistics.mean(turns["this"])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another permuto_gather.cu to time beside this one")
    ap.add_argument("--out", help="also write every JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gather: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=20, check=True).stdout.strip().splitlines()[0]
    sink = open(args.out, "w") if args.out else None
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev).zero_
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []
    with tempfile.TemporaryDirectory(prefix="profile_gather_") as workdir:
        parent = parent_entry(args.parent, workdir) if args.parent else None
        for name, (idx, bary32, c, table_rows) in shapes(dev).items():
            l, v, n = idx.shape
            for dtype in (torch.float32, torch.bfloat16):
                ta = torch.randn((l, c, 2), generator=gen, device=dev).to(dtype)
                tb = torch.randn((l, c, 2), generator=gen, device=dev).to(dtype)
                bary = bary32.to(dtype)
                rec = time_dual(ta, tb, idx, bary, flush, parent)
                size = ta.element_size()
                rec.update(bound_ms=bound_ms(l, 2, n, v, size, table_rows, 2),
                           single_bound_ms=bound_ms(l, 2, n, v, size, table_rows, 1))
                line = json.dumps({"card": card, "shape": name, "L": l, "C": c, "F": 2,
                                   "V": v, "N": n, "dtype": str(dtype).replace("torch.", ""),
                                   **rec})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                if not (rec["dual_equals_singles"] and rec.get("parent_equal", True)):
                    failed.append(f"{name} {dtype}")
                del ta, tb, bary
    if sink:
        sink.close()
    if failed:
        raise SystemExit(f"profile_gather: outputs not bit-equal: {failed}")


if __name__ == "__main__":
    main()

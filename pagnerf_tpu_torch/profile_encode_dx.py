"""The encodes' coordinate gradient kernel (``ops/csrc/permuto_encode_bwd.cu``,
``permuto_encoding.encode_dx``) on the CUDA card, against its plain version
and against another version of its source.

    python -m pagnerf_tpu_torch.profile_encode_dx [--parent OLD.cu] [--out FILE]

One flagship training microbatch's coordinates (``profile_scatter.
training_coords``: a non-anchor camera's 4096 rays x 512 jittered steps,
ray-major) cut to the main paths' N -- 163,840 (the post-prune packed B),
393,216 (the tuned config's dense microbatch) and 2,097,152 (the flagship's
and BUP20's) -- through the encode kernel, which keeps idx and the packed
rank; random float32 tables (24 levels of 2^18 rows, F = 2) and cotangents.
For each N: the kernel's dx against ``encode_dx_plain`` (1e-5 of the plain
dx's largest entry), on table A's rows and on A's half of the packed rows;
device ms (CUDA events, L2 evicted before each launch, median of 10) on
each, and the bound (``chip_smoke.encode_dx_bound``). ``--parent``: another
version of the source with the same C entry ``pagnerf_encode_dx``, built
with this package's nvcc flags: its dx against this one's bit for bit, and
both timed in turns (this, parent, parent, this). Prints one JSON object
per N; exits with an error after the last if a check failed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from .ops import _build
from .ops import permuto_encoding as pe

NS = (163840, 393216, 2097152)


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


def build(source: str, name: str):
    """``source`` built with this package's nvcc flags into
    ``_build/profile_encode_dx/lib<name>.so``; its C entry, typed as
    ``encode_dx`` calls it."""
    from .profile_encode import _nvcc
    out_dir = os.path.join(_build.BUILD_DIR, "profile_encode_dx")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    _nvcc(source, lib)
    fn = ctypes.CDLL(lib).pagnerf_encode_dx
    fn.argtypes = pe._encode_dx_kernel().argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode_dx: needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import encode_dx_bound
    from .profile_scatter import training_coords

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=20, check=True).stdout.strip()
    kernels = {"this": None}
    if a.parent:
        kernels["parent"] = build(a.parent, "parent")
    spec, x_all = training_coords(dev)
    l, c, f = spec.num_levels, spec.capacity, spec.feature_dim
    st = pe.level_statics(spec.scales, c, f)
    gen = torch.Generator(device=dev).manual_seed(3)
    ta = torch.randn((l, c, f), generator=gen, device=dev)
    packed = torch.cat((ta, torch.randn((l, c, f), generator=gen, device=dev)), dim=2)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ok = True
    out = open(a.out, "w") if a.out else None
    for n in NS:
        x = x_all[:, :n].contiguous()
        _, idx, _, rank = pe._launch_encode(x, (ta,), st, True, False)
        g = torch.randn((l, f, n), generator=gen, device=dev)
        run = {k: (lambda rows, kern=kern: pe.encode_dx(rows, idx, rank, g, st.inv_scales,
                                                         kernel=kern))
               for k, kern in kernels.items()}
        checks = {}
        for rows_name, rows in (("table", ta), ("packed", packed)):
            want = pe.encode_dx_plain(rows, idx, rank, g, st.inv_scales)
            got = run["this"](rows)
            err, ref = float((got - want).abs().max()), float(want.abs().max())
            checks[rows_name] = dict(max_abs_err=err, err_over_max=err / ref,
                                     ok=err <= 1e-5 * ref,
                                     bit_equal={k: torch.equal(fn(rows), got)
                                                for k, fn in run.items() if k != "this"})
            ok = ok and checks[rows_name]["ok"]
        order = list(kernels) + list(kernels)[::-1]
        times = {k: [] for k in kernels}
        for k in order:
            times[k].append(cuda_ms(lambda k=k: run[k](ta), flush_buf.zero_))
        packed_ms = {k: cuda_ms(lambda k=k: run[k](packed), flush_buf.zero_) for k in kernels}
        bound_ms, bound_by, nbytes, _ = encode_dx_bound(l, c, f, n, st.rows_used)
        rec = dict(card=card, N=n, checks=checks, order=order, ms=times,
                   ms_mean={k: statistics.mean(v) for k, v in times.items()},
                   packed_rows_ms=packed_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes)
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
        del idx, rank, g, x
    if out:
        out.close()
    if not ok:
        raise SystemExit("profile_encode_dx: a check failed")


if __name__ == "__main__":
    main()

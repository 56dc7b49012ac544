"""How the fused encode agrees with the plain lattice, where its time goes,
and how it compares with another version of its source, on the CUDA card.

    python -m pagnerf_tpu_torch.profile_encode [--parts] [--parent OLD.cu [--paths]]
                                               [--out FILE]

Without ``--parts``: the fused encode (``ops/csrc/permuto_encode.cu``,
``elevate``) rounds el = E @ s in one fixed order. The plain lattice's
product goes to cuBLAS, which picks its kernel by shape, and with it the
order. For each N this prints, over uniform points in [-1, 1]^3 at the
flagship's levels 0, 12 and 23, the share of el entries that cuBLAS rounds
as the kernel does and as a full fma chain does, and the idx mismatches and
bit-equal bary share of the fused kernel against the plain lattice at all
24 levels. One JSON object per N.

``--parts`` instead: ptxas's registers and spills and the SASS opcode
counts of every instantiation; the SM clock; the ceilings of random 8- and
16-byte loads from a buffer the L2 holds and from shared memory (loads per
SM per clock); then at the render's coordinates (N = 1,572,864, no
idx/bary) and a training microbatch's (N = 2,097,152, with idx/bary), the
device ms of all levels and of each level, single / packed dual / dual with
two loads, for the kernel and two ablations built from the same source
(``-DPAGNERF_ENCODE_ABLATE=1``: every table read is a read of row v;
``=2``: idx and bary are read from arrays the plain lattice wrote). CUDA
events, median of 10, L2 evicted before each.

``--parent``: another version of ``permuto_encode.cu`` with the same C
entry, built with the same flags, against this one at the render's, a
training microbatch's, a BUP20 validation chunk's (4,096,000), the prune's
(65,536) and a final validation chunk's (245,760) N: whether
outputs, idx, bary and the rank byte are bit for bit equal, and device ms in
turns (parent, this, this, parent). With ``--paths`` also the render's ms
and a BUP20 final validation's wall with each (``paths_compare``).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time

import torch

from .ops import _build
from .ops import permuto_encoding as pe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 255, 1000, 4096, 4097, 20000, 65536, 65537, 1 << 17, 1 << 18, 1 << 19,
         1 << 20, 1572864, 2097152)


def elevate_as_kernel(e: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """el = E @ s [4, N] in the fused encode's order: the first product, an
    fma of the second (here through float64, where a product of two float32
    values is exact), then the third product rounded on its own and added;
    float32 throughout."""
    acc = (e[:, 1:2].double() * s[1:2].double() + (e[:, 0:1] * s[0:1]).double()).float()
    return acc + e[:, 2:3] * s[2:3]


def elevate_fma_chain(e: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """el = fma(e2, s2, fma(e1, s1, e0 * s0)), the fmas through float64."""
    acc = (e[:, 1:2].double() * s[1:2].double() + (e[:, 0:1] * s[0:1]).double()).float()
    return (e[:, 2:3].double() * s[2:3].double() + acc.double()).float()


def kernel_order_rank(x: torch.Tensor, inv_scales) -> torch.Tensor:
    """The packed rank [L, N] (``permuto_encoding.pack_rank``) of coords x
    [3, N] with el rounded in the fused encode's order
    (``elevate_as_kernel``)."""
    e = torch.as_tensor(pe._E, dtype=torch.float32, device=x.device)
    return torch.stack([pe.pack_rank(pe._rank_from_el(elevate_as_kernel(
        e, x * torch.tensor(inv_s, device=x.device)))[1]) for inv_s in inv_scales])


def backward_rank_check(table: torch.Tensor, x: torch.Tensor, scales,
                        g: torch.Tensor) -> dict:
    """The fused encode's coordinate gradient (tables [L, C, F], x [3, N],
    cotangent g [L, F, N]) against ``encode_dx`` on the rank of
    ``kernel_order_rank`` (``dx_bit_equal``: the kernel has no atomics, so
    the backward's dx is that bit for bit when it used that rank) and
    against the plain composition, ``_lattice_levels_dx`` of the same dbary
    on that rank (``dx_err_over_max``, over the largest |dx|), and how the
    rank and dx of a recomputation through the card's ``E @ s`` (cuBLAS,
    which picks its rounding order by N) would differ: dx max error over the
    largest |dx|, and rank entries that differ. Launches the encode, dbary
    and scatter kernels once each and encode_dx twice."""
    from .ops import table_gather as tg
    st = pe.level_statics(scales, table.shape[1], table.shape[2])
    xx = x.detach().clone().requires_grad_()
    out = pe.fused_encode(table.detach(), xx, scales)
    _, idx, _, _ = out.grad_fn.saved_tensors
    kept = out.grad_fn.rank
    out.backward(g)
    dbary = tg.multilevel_gather_dbary(table.detach().float().contiguous(), idx, g)
    dbary = dbary.to(table.dtype).float()
    ordered = kernel_order_rank(x, st.inv_scales)
    cublas = torch.stack([pe.pack_rank(pe._rank_and_el(x * torch.tensor(s, device=x.device))[2])
                          for s in st.inv_scales])
    dx_max = float(xx.grad.abs().max())
    with torch.no_grad():
        same = pe.encode_dx(table.detach(), idx, ordered, g.float().contiguous(),
                            st.inv_scales, table.dtype)
        ref = pe._lattice_levels_dx(x, st.inv_scales, dbary, ordered)
        recomputed = pe._lattice_levels_dx(x, st.inv_scales, dbary, cublas)
    return {"N": x.shape[1], "dx_max": dx_max,
            "dx_err_over_max": float((xx.grad - ref).abs().max()) / dx_max,
            "dx_bit_equal": torch.equal(xx.grad, same),
            "rank_kept_vs_kernel_order_mismatches": int((kept != ordered).sum()),
            "rank_cublas_mismatches": int((cublas != ordered).sum()),
            "dx_cublas_rank_err_over_max": float((recomputed - ref).abs().max()) / dx_max,
            "rank_entries": ordered.numel()}


def bit_equal_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of entries of two float32 tensors that are equal bit for bit."""
    return (a.view(torch.int32) == b.view(torch.int32)).float().mean().item()


def _event_ms(fn, flush, reps: int = 10) -> float:
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


def _microbatch_tables(spec, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (spec.num_levels, spec.capacity, spec.feature_dim)
    return (torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))


def compare_parent(spec, coords: dict, flush, parent) -> dict:
    """Parent and this kernel at each (name -> x) of ``coords``: whether
    outputs, idx, bary and the rank byte are bit for bit equal, and device ms
    in turns (parent, this, this, parent), single / packed dual / dual with
    two loads, without and with idx/bary."""
    ta, tb = _microbatch_tables(spec, "cuda")
    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    out = {}
    for where, x in coords.items():
        res = {"N": x.shape[1]}
        for name, tables, packed in (("single", (ta,), False), ("dual", (ta, tb), True),
                                     ("dual_two_loads", (ta, tb), False)):
            for lattice in (False, True):
                runs = {k: (lambda k=k: pe._launch_encode(
                    x, tables, st, lattice, packed, parent if k == "parent" else None))
                    for k in ("parent", "this")}
                got = {k: fn() for k, fn in runs.items()}
                outs_p, *lat_p = got["parent"]
                outs_t, *lat_t = got["this"]
                equal = all(torch.equal(a, b) for a, b in zip(outs_p, outs_t))
                if lattice:
                    equal = equal and all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                                          for a, b in zip(lat_p, lat_t))
                del got, outs_p, lat_p, outs_t, lat_t
                ms = {"parent": [], "this": []}
                for k in ("parent", "this", "this", "parent"):
                    ms[k].append(_event_ms(runs[k], flush))
                res[name + ("_idx_bary" if lattice else "")] = {
                    "bit_equal": equal, "ms": ms,
                    "parent_over_this": sum(ms["parent"]) / sum(ms["this"])}
        out[where] = res
    return out


def _nvcc(source: str, out: str, extra=()) -> str:
    """Build ``source`` with this package's nvcc flags (and ``extra``) into
    ``out``; return nvcc's stderr. Raises with it on failure."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, *extra, "-o", out, source],
                          capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return proc.stderr


def _entry(lib: ctypes.CDLL):
    fn = lib.pagnerf_permuto_encode
    fn.argtypes = pe._encode_kernel().argtypes
    fn.restype = ctypes.c_int
    return fn


def parent_kernel(source: str, workdir: str):
    """Build another version of ``permuto_encode.cu`` with this package's
    nvcc flags into ``workdir``; return its C entry ``pagnerf_permuto_encode``."""
    lib_path = os.path.join(workdir, "libparent_encode.so")
    _nvcc(source, lib_path)
    return _entry(ctypes.CDLL(lib_path))


# Builds of this package's permuto_encode.cu for ``parts``: the kernel with
# the measurement aids (ceilings, clock), and the two ablations.
PROFILE_BUILDS = {"profile": ("-DPAGNERF_ENCODE_PROFILE",),
                  "reads_row0": ("-DPAGNERF_ENCODE_PROFILE", "-DPAGNERF_ENCODE_ABLATE=1"),
                  "lattice_from_arrays": ("-DPAGNERF_ENCODE_PROFILE",
                                          "-DPAGNERF_ENCODE_ABLATE=2")}


def profile_builds(workdir: str) -> tuple:
    """({name: CDLL} of ``PROFILE_BUILDS``, ptxas's report and the SASS
    opcode counts of the kernel the paths run), all built at once."""
    from concurrent.futures import ThreadPoolExecutor

    source = os.path.join(_build.CSRC, "permuto_encode.cu")
    jobs = {name: (os.path.join(workdir, f"lib{name}.so"), flags)
            for name, flags in PROFILE_BUILDS.items()}
    jobs["ptxas"] = (os.path.join(workdir, "libptxas.so"), ("-Xptxas", "-v"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        done = {k: ex.submit(_nvcc, source, out, flags) for k, (out, flags) in jobs.items()}
        logs = {k: f.result() for k, f in done.items()}
    libs = {name: ctypes.CDLL(jobs[name][0]) for name in PROFILE_BUILDS}
    return libs, ptxas_usage(logs["ptxas"]), sass_histogram(jobs["ptxas"][0])


def ptxas_usage(log: str) -> list:
    """Registers, spills and stack of every kernel in ``nvcc -Xptxas -v``'s
    output, names demangled by ``cu++filt`` where it is found."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(_build.find_nvcc() or ""),
                                                    "cu++filt")
    if kernels and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(k["kernel"] for k in kernels),
                               capture_output=True, text=True, timeout=20).stdout.split("\n")
        for k, name in zip(kernels, names):
            k["kernel"] = name.strip() or k["kernel"]
    return kernels


def sass_histogram(lib_path: str) -> dict:
    """Per kernel of a built library (``cuobjdump -sass``): its instruction
    count and the count of each opcode (without modifiers), largest first."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc() or ""), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and cur is not None:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return {k: {"instructions": sum(v.values()),
                "opcodes": dict(sorted(v.items(), key=lambda kv: -kv[1]))}
            for k, v in out.items()}


def sm_clock_hz(lib) -> float:
    """The SM clock now: one thread counts 2e7 clocks against the global timer."""
    clocks = torch.zeros(2, dtype=torch.int64, device="cuda")
    lib.pagnerf_encode_clock.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    err = lib.pagnerf_encode_clock(20_000_000, clocks.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"clock kernel: cudaError {err}")
    c, ns = clocks.tolist()
    return c / ns * 1e9


def ceilings(lib, loads: int, sms: int, clock_hz: float) -> list:
    """Random loads of 8 and 16 bytes a lane, ``loads`` in all (a hashed
    level's), 4 or 16 independent loads a lane: from a 2 / 4 MB buffer that
    the L2 holds, through L1 (``__ldg``) and L2 only (``__ldcg``), and from
    128 KB of shared memory; device ms (median of 10, warm) and loads per
    SM per clock."""
    fn = lib.pagnerf_encode_ceiling
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for row_bytes in (8, 16):
        buf = torch.randint(0, 2 ** 31, (2 ** 18 * row_bytes // 4,), generator=gen,
                            dtype=torch.int32, device="cuda")
        for where, name in ((0, "global_l1"), (1, "global_l2_only"), (2, "shared")):
            rows = 2 ** 18 if where < 2 else 2 ** 17 // row_bytes
            for k in (4, 16):
                lanes = loads // k
                call = lambda: fn(buf.data_ptr(), rows, row_bytes, lanes, k, where,
                                  sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
                err = call()
                if err:
                    raise RuntimeError(f"ceiling kernel: cudaError {err}")
                ms = _event_ms(call, lambda: None)
                out.append({"row_bytes": row_bytes, "from": name, "buffer_bytes": rows * row_bytes,
                            "loads_per_lane": k, "loads": lanes * k, "ms": ms,
                            "loads_per_sm_per_clock": lanes * k / (ms * 1e-3) / sms / clock_hz})
    return out


def _lattice_arrays(lib, idx: torch.Tensor, bary: torch.Tensor) -> None:
    lib.pagnerf_encode_ablate_lattice.argtypes = [ctypes.c_void_p] * 2
    err = lib.pagnerf_encode_ablate_lattice(idx.data_ptr(), bary.data_ptr())
    if err:
        raise RuntimeError(f"ablate_lattice: cudaError {err}")


def parts(spec, coords: dict, flush, libs: dict, sms: int, clock_hz: float) -> dict:
    """For each (name, x, with idx/bary) of ``coords``: device ms of all
    levels and of each level alone, single / packed dual / dual with two
    loads, for the kernel the paths run and its two ablations (every table
    read replaced by a read of row v; idx and bary read from arrays the
    plain lattice wrote); hashed levels' table loads per SM per clock."""
    kernels = {"kernel": None, **{k: _entry(libs[k]) for k in ("reads_row0",
                                                              "lattice_from_arrays")}}
    ta, tb = _microbatch_tables(spec, "cuda")
    st_all = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    out = {}
    for where, (x, lattice) in coords.items():
        n = x.shape[1]
        idx_p, bary_p = pe.lattice(ta, x, spec.scales)
        res = {"N": n, "idx_bary_written": lattice}
        for layout, tables, packed in (("single", (ta,), False), ("dual", (ta, tb), True),
                                       ("dual_two_loads", (ta, tb), False)):
            for kname, kern in kernels.items():
                if kname == "lattice_from_arrays":
                    _lattice_arrays(libs[kname], idx_p, bary_p)
                all_ms = _event_ms(lambda tabs=tables, kern=kern: pe._launch_encode(
                    x, tabs, st_all, lattice, packed, kern), flush)
                level_ms = []
                for lv in range(spec.num_levels):
                    sl = tuple(t[lv:lv + 1] for t in tables)
                    st_lv = pe.level_statics(spec.scales[lv:lv + 1], spec.capacity,
                                             spec.feature_dim)
                    if kname == "lattice_from_arrays":
                        _lattice_arrays(libs[kname], idx_p[lv:lv + 1], bary_p[lv:lv + 1])
                    level_ms.append(_event_ms(
                        lambda sl=sl, st_lv=st_lv, kern=kern: pe._launch_encode(
                            x, sl, st_lv, lattice, packed, kern), flush))
                loads = 4 * n * (2 if layout == "dual_two_loads" else 1)
                hashed = [i for i, d in enumerate(st_all.direct) if not d]
                res[f"{layout}/{kname}"] = {
                    "all_levels_ms": all_ms, "level_ms": level_ms,
                    "hashed_level_loads_per_sm_per_clock": [
                        loads / (level_ms[i] * 1e-3) / sms / clock_hz for i in hashed]}
        out[where] = res
        del idx_p, bary_p
    return out


def render_coords(pipe, origins, dirs, cam_idx):
    """Sample coordinates [3, N] of the flagship render (``entry()``'s
    march)."""
    from .core.rays import Rays
    from .ops.occupancy import OccupancyGrid
    from .ops.raymarch import raymarch

    occ = OccupancyGrid.create(level=7, device=origins.device)
    with torch.no_grad():
        rays = pipe.transform_rays(
            Rays(origins=origins, dirs=dirs, dist_min=0.0, dist_max=6.0), cam_idx)
        coordsT = raymarch(rays, occ, pipe.tracer_cfg.num_steps).positionsT
    return coordsT.reshape(3, -1).contiguous()


BUP20_VALIDATION_N = 8000 * 512     # best.yaml's full validation chunk


def path_coords(dev):
    """(spec, {"render", "train", "bup20_val", "prune", "val": x [3, N]}):
    the flagship render's coordinates (N = 1,572,864), a training
    microbatch's (N = 2,097,152); for the bup20 validation chunk's N =
    4,096,000 the two joined and repeated (ray-ordered samples, as a
    chunk's are); for the prune's N = 65,536 and the final validation's
    chunk N = 245,760 the first samples of the render's."""
    from .entry import entry
    from .profile_scatter import training_coords

    _, (pipe, origins, dirs, cam_idx) = entry(device=dev)
    x_render = render_coords(pipe, origins, dirs, cam_idx)
    del pipe
    spec, x_train = training_coords(dev)
    both = torch.cat([x_train, x_render], dim=1)
    reps = -(-BUP20_VALIDATION_N // both.shape[1])
    x_val = both.repeat(1, reps)[:, :BUP20_VALIDATION_N].contiguous()
    return spec, {"render": x_render, "train": x_train, "bup20_val": x_val,
                  "prune": x_render[:, :65536].contiguous(),
                  "val": x_render[:, :245760].contiguous()}


def _host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn`` to a synchronised end, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def paths_compare(dev, parent, workdir: str, size=(320, 180), flags=()) -> dict:
    """The flagship render (``entry()``, median of 5) and best.yaml's final
    validation over a 320x180 BUP20-format tree (at mip 0, median of 1, the
    trainer as built: the same rays and chunks as a trained one's), in turns
    (parent, this, this, parent): "this" with this kernel and the dual
    encode's kept packed copy, "parent" with the parent kernel and a packed
    copy made per call, as the wrapper made it before it kept one. Host
    clock."""
    from unittest import mock

    from .config import factory
    from .config.config import parse_options
    from .data.bup20_tree import write_bup20_tree
    from .entry import entry
    from .train.validation import validate

    def as_parent():
        return mock.patch.multiple(pe, _encode_kernel=lambda: parent,
                                   packed_tables=lambda a, b: torch.cat((a, b), dim=2))
    fn, args = entry(device=dev)
    tree = os.path.join(workdir, "BUP_20")
    write_bup20_tree(tree, *size)
    argv = ["--config", os.path.join(ROOT, "configs", "bup20", "best.yaml"),
            "--dataset-path", tree, "--log-dir", os.path.join(workdir, "runs")] + list(flags)
    _, _, trainer = factory.get_modules_from_config(parse_options(argv), dev)
    final = trainer.cfg.epochs
    out = {"render_ms": {"parent": [], "this": []},
           "bup20_final_validation_s": {"parent": [], "this": []},
           "bup20_validated_images": len(trainer.dataset.val_idxs)}
    for k in ("parent", "this", "this", "parent"):
        with (as_parent() if k == "parent" else contextlib.nullcontext()):
            out["render_ms"][k].append(_host_ms(lambda: fn(*args), 5))
            out["bup20_final_validation_s"][k].append(
                _host_ms(lambda: validate(trainer, final), 1) / 1e3)
    return out


def agreement_by_n(dev, emit) -> None:
    """One object per N of ``SIZES``: el's agreement with cuBLAS and the
    kernel's lattice against the plain one (see the module doc)."""
    spec = pe.PermutoEncodingSpec()
    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    e = torch.as_tensor(pe._E, dtype=torch.float32, device=dev)
    table = torch.zeros((spec.num_levels, spec.capacity, spec.feature_dim), device=dev)
    for n in SIZES:
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.rand((3, n), generator=gen, device=dev) * 2 - 1
        kernel_order, fma_chain = [], []
        for lv in (0, 12, 23):
            s = x * torch.tensor(st.inv_scales[lv], device=dev)
            el = e @ s
            kernel_order.append(bit_equal_share(elevate_as_kernel(e, s), el))
            fma_chain.append(bit_equal_share(elevate_fma_chain(e, s), el))
        _, idx, bary, _ = pe._launch_encode(x, (table,), st, True, False)
        idx_p, bary_p = pe.lattice(table, x, spec.scales)
        emit({"N": n, "el_share_kernel_order": kernel_order,
              "el_share_fma_chain": fma_chain,
              "idx_mismatches": int((idx != idx_p).sum()), "idx_entries": idx.numel(),
              "bary_bit_equal_share": bit_equal_share(bary, bary_p)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another permuto_encode.cu to compare with this one")
    ap.add_argument("--parts", action="store_true",
                    help="the kernel's time split by ablations, per level, the ceilings "
                         "of random loads and ptxas's registers (skips the map by N)")
    ap.add_argument("--paths", action="store_true",
                    help="with --parent: the render's ms and a BUP20 validation's wall "
                         "with each kernel")
    ap.add_argument("--out", help="also write every JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: needs a CUDA card")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps({"card": card, **obj})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev).zero_
    if not args.parts:
        agreement_by_n(dev, emit)
    if not (args.parts or args.parent):
        return
    spec, coords = path_coords(dev)
    with tempfile.TemporaryDirectory(prefix="profile_encode_") as workdir:
        if args.parts:
            libs, ptxas, sass = profile_builds(workdir)
            emit({"ptxas": ptxas, "sass": sass})
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            clock0 = sm_clock_hz(libs["profile"])
            ceil = ceilings(libs["profile"], 4 * coords["render"].shape[1], sms, clock0)
            clock1 = sm_clock_hz(libs["profile"])
            emit({"sm_clock_hz": [clock0, clock1], "sms": sms, "ceilings": ceil})
            emit({"parts": parts(spec, {"render": (coords["render"], False),
                                        "train": (coords["train"], True)},
                                 flush, libs, sms, (clock0 + clock1) / 2)})
        if args.parent:
            parent = parent_kernel(args.parent, workdir)
            if args.parts:
                emit({"parent": args.parent,
                      "sass": sass_histogram(os.path.join(workdir, "libparent_encode.so"))})
            emit({"parent": args.parent, **compare_parent(spec, coords, flush, parent)})
            if args.paths:
                del coords
                torch.cuda.empty_cache()
                emit({"parent": args.parent, "paths": paths_compare(dev, parent, workdir)})
    if sink:
        sink.close()


if __name__ == "__main__":
    main()

"""How the fused encode's lattice agrees with the plain lattice, by N, on the
CUDA card.

    python -m pagnerf_tpu_torch.profile_encode [--parent OLD.cu]

The fused encode (``ops/csrc/permuto_encode.cu``, ``elevate``) rounds
el = E @ s in one fixed order. The plain lattice's product goes to cuBLAS,
which picks its kernel by shape, and with it the order. For each N this
prints, over uniform points in [-1, 1]^3 at the flagship's levels 0, 12 and
23, the share of el entries that cuBLAS rounds as the kernel does and as a
full fma chain does, and the idx mismatches and bit-equal bary share of the
fused kernel against the plain lattice at all 24 levels. One JSON object
per N. Then one object for the levels: at a training microbatch's
coordinates (N = 2,097,152, float32 tables, no idx/bary), the device ms of
the single and the packed dual encode of all levels in one launch and of
each level alone (CUDA events, median of 10, L2 evicted before each).
With ``--parent``, another version of ``permuto_encode.cu`` (the same C
interface), built with the same flags into a temporary directory, against
this one at those coordinates: whether their outputs (and idx/bary) are bit
for bit equal, and their times in turns (parent, this, this, parent).
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

from .ops import _build
from .ops import permuto_encoding as pe

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
    cotangent g [L, F, N]) against ``_lattice_levels_dx`` of the same dbary
    on the rank of ``kernel_order_rank``, and how the rank and dx of a
    recomputation through the card's ``E @ s`` (cuBLAS, which picks its
    rounding order by N) would differ: dx max error over the largest |dx|,
    and rank entries that differ. Launches the encode, dbary and scatter
    kernels once each."""
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
        ref = pe._lattice_levels_dx(x, st.inv_scales, dbary, ordered)
        recomputed = pe._lattice_levels_dx(x, st.inv_scales, dbary, cublas)
    return {"N": x.shape[1], "dx_max": dx_max,
            "dx_err_over_max": float((xx.grad - ref).abs().max()) / dx_max,
            "dx_bit_equal": torch.equal(xx.grad, ref),
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


def level_times(spec, x, flush) -> dict:
    """Device ms of the fused encode (single; dual from packed rows) of all
    levels and of each level alone, at coordinates x."""
    ta, tb = _microbatch_tables(spec, x.device)
    scales = spec.scales
    with torch.no_grad():
        out = {"N": x.shape[1],
               "all_levels_ms": {
                   "single": _event_ms(lambda: pe.fused_encode(ta, x, scales), flush),
                   "dual": _event_ms(lambda: pe.fused_encode_dual(ta, tb, x, scales), flush)},
               "level_ms": {"single": [], "dual": []}}
        for lv in range(spec.num_levels):
            a, b, s = ta[lv:lv + 1], tb[lv:lv + 1], scales[lv:lv + 1]
            out["level_ms"]["single"].append(
                _event_ms(lambda: pe.fused_encode(a, x, s), flush))
            out["level_ms"]["dual"].append(
                _event_ms(lambda: pe.fused_encode_dual(a, b, x, s), flush))
    return out


def parent_kernel(source: str, workdir: str):
    """Build another version of ``permuto_encode.cu`` with this package's
    nvcc flags into ``workdir``; return its C entry ``pagnerf_permuto_encode``."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    lib_path = os.path.join(workdir, "libparent_encode.so")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", lib_path, source],
                          capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    fn = ctypes.CDLL(lib_path).pagnerf_permuto_encode
    fn.argtypes = pe._encode_kernel().argtypes
    fn.restype = ctypes.c_int
    return fn


def compare_parent(spec, x, flush, parent) -> dict:
    """Parent and this kernel at coordinates x: bit-equal outputs (and
    idx/bary), device ms in turns, single and packed dual, without and with
    idx/bary."""
    ta, tb = _microbatch_tables(spec, x.device)
    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    out = {}
    for name, tables, lattice in (("single", (ta,), False), ("dual", (ta, tb), False),
                                  ("single_idx_bary", (ta,), True),
                                  ("dual_idx_bary", (ta, tb), True)):
        runs = {k: (lambda k=k: pe._launch_encode(x, tables, st, lattice, True,
                                                  parent if k == "parent" else None))
                for k in ("parent", "this")}
        got = {k: fn() for k, fn in runs.items()}
        outs_p, idx_p, bary_p = got["parent"][:3]
        outs_t, idx_t, bary_t = got["this"][:3]
        equal = all(torch.equal(a, b) for a, b in zip(outs_p, outs_t))
        if lattice:
            equal = equal and torch.equal(idx_p, idx_t) and bit_equal_share(bary_p, bary_t) == 1.0
        del got, outs_p, idx_p, bary_p, outs_t, idx_t, bary_t
        ms = {"parent": [], "this": []}
        for k in ("parent", "this", "this", "parent"):
            ms[k].append(_event_ms(runs[k], flush))
        out[name] = {"bit_equal": equal, "ms": ms}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another permuto_encode.cu to compare with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: needs a CUDA card")
    from .profile_scatter import training_coords

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    dev = torch.device("cuda")
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
        print(json.dumps({
            "card": card, "N": n, "el_share_kernel_order": kernel_order,
            "el_share_fma_chain": fma_chain,
            "idx_mismatches": int((idx != idx_p).sum()), "idx_entries": idx.numel(),
            "bary_bit_equal_share": bit_equal_share(bary, bary_p)}), flush=True)
    del table, idx, bary, idx_p, bary_p

    spec, x = training_coords(dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev).zero_
    print(json.dumps({"card": card, **level_times(spec, x, flush)}), flush=True)
    if args.parent:
        with tempfile.TemporaryDirectory(prefix="parent_encode_") as workdir:
            parent = parent_kernel(args.parent, workdir)
            print(json.dumps({"card": card, "parent": args.parent, "N": x.shape[1],
                              **compare_parent(spec, x, flush, parent)}), flush=True)


if __name__ == "__main__":
    main()

"""The exact assignment kernel (``ops/csrc/lap_assign.cu``) on its cases,
and against another version of its source, on the CUDA card.

    python -m pagnerf_tpu_torch.profile_assign [--parent OLD.cu] [--recorded FILE]
                                               [--out FILE]

One JSON object per case, for the cases of ``assignment_cases`` (those of
``tests/test_torch_assignment.py``, the 200 x 200 ones cut to 48 x 48 so
that the plain version solves them, and uncut), ``tie_cases`` (small-integer
costs whose ties cross the 32-column chunks of a warp) and, with
``--recorded``, a microbatch's [B, K, M] costs and presence saved by
``torch.save`` (``chip_smoke.py``'s fused_step phase writes the tuned
config's first panoptic microbatch to ``pagnerf_tpu_torch/_build/
assign_recorded.pt``): the kernel's columns against the plain version's
where it solves the case (``PLAIN_MAX_STEPS``), else the matched cost
against ``scipy``'s optimum; the Dijkstra steps the data asks for; the
kernel's device ms (``graph_ms``: launches back to back in a CUDA graph,
so that no host time is counted), the empty kernel's at the same plan (the
floor of a launch, ``assignment.empty_launch``), and the wrapper's ms with
CUDA events around one call (host time included, as ``chip_smoke.py``
timed it before). With ``--parent``: another version of ``lap_assign.cu``
whose C entry ``pagnerf_lap_assign`` takes (cost, present, out, b, k, m,
stream), built with this package's nvcc flags; its columns against this
kernel's and both device times in turns (parent, this, this, parent).
Exits with an error after the last case if a case failed its check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from .ops import assignment

# the plain version reads the card back at every Dijkstra step: it solves
# a case whose steps stay below this in about a second
PLAIN_MAX_STEPS = 4000


def assignment_cases(n: int = 48):
    """(name, cost [K, M] float32, present [K] bool) of
    ``tests/test_torch_assignment.py``, its 200 x 200 ones at n x n: random
    shapes, separated costs, absent rows, more rows than columns, rejection
    penalties, quantised near ties, plateaus, two-tier ties with penalties,
    the deployed 20 labels of 200 against 200 slots (always 200 x 200), and
    non-finite costs mapped as ``hungarian_assign`` maps them."""
    out = []
    for k, m, seed in [(5, 5, 0), (8, 12, 1), (12, 8, 2), (30, 30, 3)]:
        rng = np.random.default_rng(seed)
        out.append((f"random_{k}x{m}", rng.uniform(-1, 0, (k, m)).astype(np.float32),
                    rng.random(k) > 0.2))
    out.append(("separated", np.array([[0.0, 5, 5, 5], [5, 5, 0, 5], [5, 0, 5, 5]],
                                      np.float32), np.ones(3, bool)))
    cost = np.zeros((4, 3), np.float32)
    cost[1] = [-1, 0, 0]
    out.append(("absent_rows", cost, np.array([False, True, False, False])))
    rng = np.random.default_rng(4)
    out.append(("more_rows", rng.uniform(-1, 0, (10, 4)).astype(np.float32),
                np.ones(10, bool)))
    out += large_cases(n)
    rng = np.random.default_rng(21)
    cost = rng.uniform(-1, 0, (8, 20)).astype(np.float32)
    cost[0, :10] = np.inf
    cost[3, 5] = np.nan
    out.append(("nonfinite", np.clip(np.nan_to_num(cost), -1e12, 1e12).astype(np.float32),
                np.ones(8, bool)))
    return out


def large_cases(n: int = 200):
    """The 200 x 200 cases of ``tests/test_torch_assignment.py`` at n x n
    (rejection penalties, near ties, plateaus, two-tier ties), and the
    deployed 20 labels of 200 against 200 slots."""
    out = []
    for seed in range(2):
        rng = np.random.default_rng(100 + seed)
        cost = rng.uniform(-1.0, 0.0, (n, n)).astype(np.float32)
        penal = rng.random((n, n)) < 0.3
        penal[np.arange(n), rng.integers(0, n, n)] = False
        out.append((f"penalties_{seed}", np.where(penal, cost + 10000.0, cost).astype(
            np.float32), rng.random(n) > 0.1))
    for quant in (1.0, 0.1, 0.01):
        rng = np.random.default_rng(7)
        out.append((f"near_ties_{quant}", (np.round(rng.uniform(-1.0, 0.0, (n, n)) / quant)
                                           * quant).astype(np.float32), np.ones(n, bool)))
    for i, cost in enumerate((np.zeros((n, n), np.float32), np.full((n, n), -0.5, np.float32),
                              (-np.outer(np.linspace(0, 1, n), np.linspace(0, 1, n))
                               ).astype(np.float32))):
        out.append((f"plateau_{i}", cost, np.ones(n, bool)))
    rng = np.random.default_rng(11)
    base = rng.choice([-1.0, -0.999999], size=(n, n))
    penal = np.zeros((n, n), bool)
    penal[:, :n // 2] = rng.random((n, n // 2)) < 0.5
    out.append(("two_tier", np.where(penal, base + 10000.0, base).astype(np.float32),
                np.ones(n, bool)))
    rng = np.random.default_rng(13)
    emb, slots = rng.normal(size=(200, 8)), rng.normal(size=(200, 8))
    cost = ((emb[:, None] - slots[None]) ** 2).sum(-1).astype(np.float32)
    present = np.zeros(200, bool)
    present[rng.choice(200, 20, replace=False)] = True
    penal = rng.random((200, 200)) < 0.85
    penal[np.arange(200), cost.argmin(1)] = False
    out.append(("deployed_20_of_200", np.where(penal, cost + 10000.0, cost).astype(
        np.float32), present))
    return out


# (K, M) of the tie cases: at, across and past the 32-column chunks of a
# warp, square and not, more rows than columns
TIE_SHAPES = ((33, 33), (40, 40), (64, 64), (65, 65), (40, 65), (70, 33))


def tie_cases():
    """(name, cost [K, M] float32, present [K] bool): costs drawn from
    {-3, -2, -1, 0}, so nearly every step's argmin is a tie, among columns
    in different 32-column chunks; about a tenth of the rows absent."""
    out = []
    for k, m in TIE_SHAPES:
        rng = np.random.default_rng(1000 + 100 * k + m)
        cost = rng.integers(-3, 1, (k, m)).astype(np.float32)
        out.append((f"ties_{k}x{m}", cost, rng.random(k) > 0.1))
    return out


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device ms of one ``fn()``: ``reps`` calls captured back to back in a
    CUDA graph, the median of ``replays`` replays (CUDA events around each)
    over ``reps``. The host enqueues nothing between the launches, so no
    host time is counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def wrapper_ms(fn, reps: int = 20) -> float:
    """Median ms of one ``fn()`` with CUDA events around the call (the
    host's checks and launch included while the card waits for them)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scipy_cost(cost: np.ndarray, present: np.ndarray) -> float:
    """Matched cost of scipy's optimum over the first M present rows."""
    from scipy.optimize import linear_sum_assignment
    rows = np.nonzero(present)[0][:cost.shape[1]]
    if not rows.size:
        return 0.0
    r, c = linear_sum_assignment(cost[rows])
    return float(cost[rows][r, c].sum())


def matched_cost(cost: np.ndarray, present: np.ndarray, cols: np.ndarray) -> float:
    rows = np.nonzero(present)[0][:cost.shape[1]]
    return float(cost[rows, cols[rows]].sum())


def cost_tolerance(name: str, cost: np.ndarray, present: np.ndarray) -> float:
    """How far a matched cost may lie above scipy's optimum, as
    ``tests/test_assignment.py`` bounds it: 1.0 where rejection penalties
    of 10000 make the float32 ulp ~1e-3, else float32 rounding of the
    potentials, 1e-4 of the largest present cost per present row."""
    if name.startswith(("penalties", "two_tier", "deployed")):
        return 1.0
    rows = np.nonzero(present)[0][:cost.shape[1]]
    if not rows.size:
        return 0.0
    return 1e-4 * max(1.0, float(np.abs(cost[rows]).max())) * len(rows)


def parent_entry(source: str, workdir: str):
    """Build another ``lap_assign.cu`` with this package's nvcc flags;
    return a call ``(cost, present) -> out`` at its C interface (cost, present,
    out, b, k, m, stream) on [B, K, M] / [B, K] CUDA tensors."""
    from .profile_encode import _nvcc
    lib_path = os.path.join(workdir, "libparent_lap_assign.so")
    _nvcc(source, lib_path)
    fn = ctypes.CDLL(lib_path).pagnerf_lap_assign
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(cost, present):
        b, k, m = cost.shape
        out = torch.empty((b, k), dtype=torch.int64, device=cost.device)
        err = fn(cost.data_ptr(), present.data_ptr(), out.data_ptr(), b, k, m,
                 torch.cuda.current_stream(cost.device).cuda_stream)
        if err:
            raise RuntimeError(f"parent lap_assign launch failed: cudaError_t {err}")
        return out
    return call


def check_case(cost: torch.Tensor, present: torch.Tensor, tol: float, parent=None,
               reps: int = 20) -> dict:
    """One [B, K, M] case on the card (see the module's docstring); ``ok``:
    distinct columns, a matched cost within ``tol`` of scipy's optimum in
    every image, and the plain version's columns where it ran."""
    b, k, m = cost.shape
    got = assignment.lap_assign(cost, present)
    torch.cuda.synchronize()
    c_np, p_np, g_np = cost.cpu().numpy(), present.cpu().numpy(), got.cpu().numpy()
    opt = [scipy_cost(c_np[i], p_np[i]) for i in range(b)]
    rows = [int(min(p_np[i].sum(), m)) for i in range(b)]
    # steps the data asks for: those of the plain version where it runs,
    # else the bound P (P + 1) / 2
    bound_steps = sum(p * (p + 1) // 2 for p in rows)
    rec = dict(shape=[b, k, m], present_rows=rows,
               cost_minus_scipy=max(matched_cost(c_np[i], p_np[i], g_np[i]) - opt[i]
                                    for i in range(b)),
               distinct=all(len(set(g_np[i][np.nonzero(p_np[i])[0][:m]])) == rows[i]
                            for i in range(b)))
    if bound_steps <= PLAIN_MAX_STEPS:
        want = assignment.lap_assign_plain(cost, present)
        rec.update(equal_plain=bool(torch.equal(got, want)),
                   dijkstra_steps=assignment.lap_assign_plain.steps)
    else:
        rec.update(equal_plain=None, dijkstra_steps_at_most=bound_steps)
    rec["ok"] = bool(rec["distinct"] and rec["cost_minus_scipy"] <= tol
                     and rec["equal_plain"] is not False)
    warps, staged, per_warp = assignment.launch_geometry(b, k, m)
    rec["plan"] = dict(warps=warps, staged=staged, smem_per_warp=per_warp)
    rec["ms"] = graph_ms(lambda: assignment.lap_assign(cost, present), reps)
    rec["floor_ms"] = graph_ms(lambda: assignment.empty_launch(cost, present), reps)
    rec["wrapper_ms"] = wrapper_ms(lambda: assignment.lap_assign(cost, present), reps)
    if parent is not None:
        old = parent(cost, present)
        torch.cuda.synchronize()
        turns = {"parent": [], "this": []}
        for which in ("parent", "this", "this", "parent"):
            fn = (lambda: parent(cost, present)) if which == "parent" else \
                (lambda: assignment.lap_assign(cost, present))
            turns[which].append(graph_ms(fn, reps))
        rec["parent"] = dict(equal=bool(torch.equal(old, got)), turns_ms=turns,
                             ms=statistics.mean(turns["parent"]),
                             this_ms=statistics.mean(turns["this"]),
                             parent_over_this=sum(turns["parent"]) / sum(turns["this"]))
    return rec


def cases_on_card(dev, recorded=None, parent=None):
    """(name, record) of every case: ``assignment_cases()``, the uncut
    ``large_cases()``, ``tie_cases()``, and ``recorded`` ({"cost",
    "present"}) when given. The large cases take fewer launches a time."""
    named = [(n, n, c, p, 20) for n, c, p in assignment_cases() + tie_cases()]
    named += [(n + "_uncut", n, c, p, 5) for n, c, p in large_cases()
              if n != "deployed_20_of_200"]
    for name, kind, cost, present, reps in named:
        c = torch.from_numpy(cost).to(dev)[None]
        p = torch.from_numpy(present).to(dev)[None]
        yield name, check_case(c, p, cost_tolerance(kind, cost, present), parent, reps)
    if recorded is not None:
        c, p = recorded["cost"].to(dev).contiguous(), recorded["present"].to(dev).contiguous()
        tol = max(cost_tolerance("recorded", c[i].cpu().numpy(), p[i].cpu().numpy())
                  for i in range(c.shape[0]))
        yield "recorded", check_case(c, p, tol, parent)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another lap_assign.cu to time beside this one")
    ap.add_argument("--recorded", help="a torch.save'd {'cost', 'present'} microbatch")
    ap.add_argument("--out", help="also write every JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_assign: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=20, check=True).stdout.strip().splitlines()[0]
    sink = open(args.out, "w") if args.out else None
    dev = torch.device("cuda")
    recorded = torch.load(args.recorded) if args.recorded else None
    failed = []
    with tempfile.TemporaryDirectory(prefix="profile_assign_") as workdir:
        parent = parent_entry(args.parent, workdir) if args.parent else None
        for name, rec in cases_on_card(dev, recorded, parent):
            line = json.dumps({"card": card, "case": name, **rec})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
            if not rec["ok"] or not rec.get("parent", {}).get("equal", True):
                failed.append(name)
    if sink:
        sink.close()
    if failed:
        raise SystemExit(f"profile_assign: cases that failed their check: {failed}")


if __name__ == "__main__":
    main()

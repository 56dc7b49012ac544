"""Run a function on every rank of a ray-axis group, one process per rank.

``run_ranks(n, worker, spec, device, workdir)`` starts ``n`` processes of
``python -m pagnerf_tpu_torch.parallel.launch``; rank r joins the group
through a ``file://`` rendezvous in ``workdir`` (no TCP port, so several
launches run side by side), calls ``worker(group, spec)`` (``worker`` is a
``"module:function"`` name) and saves its result to ``workdir/rank<r>.pt``.
The parent returns the results in rank order, or raises with the failing
rank's error output; a rank still running at ``timeout_s`` first dumps
every thread's stack into its log (``faulthandler`` on SIGUSR1), so the
error shows where it waited. The parent kills every rank it started
before it returns.
"""
from __future__ import annotations

import argparse
import faulthandler
import importlib
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(n: int, worker: str, spec: Dict[str, Any], device: str, workdir: str,
              ranks_per_device: int = 1, timeout_s: float = 900.0) -> List[Any]:
    workdir = os.path.abspath(workdir)      # the file:// rendezvous needs a full path
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "spec.pt")
    torch.save(spec, spec_path)
    rdzv = os.path.join(workdir, "rendezvous")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(n):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pagnerf_tpu_torch.parallel.launch", "--rank", str(r),
                 "--world", str(n), "--device", device, "--workdir", workdir,
                 "--worker", worker, "--ranks-per-device", str(ranks_per_device)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_ROOT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
        if None in codes:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
            time.sleep(2.0)
        if any(c != 0 for c in codes):
            bad = next((r for r, c in enumerate(codes) if c not in (None, 0)), 0)
            logs[bad].seek(0)
            tail = logs[bad].read()[-12000:]
            raise RuntimeError(f"rank {bad} of {n} failed (exit codes {codes}):\n{tail}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--worker", required=True)
    ap.add_argument("--ranks-per-device", type=int, default=1)
    a = ap.parse_args(argv)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    torch.set_num_threads(1)
    from .sharding import make_group
    module, name = a.worker.split(":")
    worker = getattr(importlib.import_module(module), name)
    spec = torch.load(os.path.join(a.workdir, "spec.pt"), weights_only=False)
    group = make_group(a.world, a.rank, "file://" + os.path.join(a.workdir, "rendezvous"),
                       a.device, ranks_per_device=a.ranks_per_device)
    try:
        result = worker(group, spec)
        torch.save(result, os.path.join(a.workdir, f"rank{a.rank}.pt"))
    except BaseException:
        traceback.print_exc()
        code = 1
    else:
        code = 0
    # no destroy_process_group: a group whose collectives a CUDA graph
    # captured never sees that work complete, and NCCL's shutdown waits
    # for it; the process exits and the parent reads the saved result
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    main()

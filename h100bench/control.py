"""The control of ``correct``, and the faults it must catch, at a cell's own
size.

    python3 -m h100bench.control --workload <cell> --seeds <n> [<n> ...]
        [--fault control|unchanged|half_batch|altered] [--seconds s]

``control`` (the default) puts the reference, computed with TF32 matmuls
(the nearest precision below the float32 the configurations state), in the
program's place over the cell's own inputs. The faults are planted in the
program: ``unchanged``, a step that leaves the state as it was;
``half_batch``, the later half of the batch's microbatches left out and the
mean taken over the rest, every draw made as before; ``altered``, one
rendered value changed where it is produced. Prints each seed's numbers;
exits 0 only if the cell's limits call every run not correct. The
benchmark's own runs do not run this.
"""
import argparse
import contextlib
import json
import sys
from unittest import mock

from h100bench import run


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted (the driver's keyword arguments)."""
    if fault in ("control", "altered"):
        yield ({"control": True} if fault == "control"
               else {"hooks": {"alter": _alter}})
        return
    import torch
    from pagnerf_tpu_torch.train.optimizer import MaskedOptimizer
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer
    if fault == "unchanged":
        patch = mock.patch.object(MaskedOptimizer, "update",
                                  lambda self, *a, **k: torch.ones((), dtype=torch.bool))
    elif fault == "half_batch":
        patch = mock.patch.object(PanopticTrainer, "_step_body",
                                  _half_batch(PanopticTrainer._step_body))
    else:
        raise ValueError(fault)
    with patch:
        yield {}


def _half_batch(whole):
    """The step body with the losses of its later half of microbatches
    weighted 0 and those of the first half by ``micro / kept``: the mean
    over the first half. Every draw is made as before, so the reference
    follows the steps."""
    def body(self, stage, subs, draws, cams, lod_w):
        kept, seen = max(1, len(subs) // 2), [0]
        losses = self.compute_losses

        def half(*a, **k):
            w = len(subs) / kept if seen[0] < kept else 0.0
            seen[0] += 1
            total, parts = losses(*a, **k)
            return total * w, {n: v * w for n, v in parts.items()}
        self.compute_losses = half
        try:
            return whole(self, stage, subs, draws, cams, lod_w)
        finally:
            del self.compute_losses
    return body


def _alter(out) -> None:
    """One pixel's colour off by 0.1, as a wrong answer would be."""
    out["rgb"].reshape(-1)[0] += 0.1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="control",
                   choices=("control", "unchanged", "half_batch", "altered"))
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    caught = True
    for seed in args.seeds:
        with planted(args.fault) as kw:
            line, lines = run.measure(["--workload", args.workload, "--seed", str(seed),
                                       "--seconds", str(args.seconds), "--trace", "0"], **kw)
        out = json.loads(line)
        caught &= not out["correct"]
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                          "numbers": [x for x in lines if x.startswith(("number", "check"))]}),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())

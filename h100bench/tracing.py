"""The traced windows: ``torch.profiler`` over the card, and its reduction
to what the per-layer readers read.

The metrics' window records the card's activity alone, so that the host
runs as in an untraced run: no host operation is recorded. Its length is
the host's clock over the window, which the driver closes with a
synchronise, so that every operation of the card lies inside it;
``busy_s`` is the length of the union of the card's operations (kernels,
copies, fills), and ``kernel_s`` sums each operation's device seconds by
name. A labelled window (``labelled=True``), run after it, records the
host's operations and annotations too and is marked by a user annotation
(``WINDOW``); its idle gaps, the holes in the union, are each labelled by
the innermost host operation under the annotations that covered the gap's
middle. On a host without a card every window is the labelled kind, over
the host alone. The events are read from the profiler's raw results,
without its Python post-processing.
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Tuple

WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(enabled: bool, labelled: bool = False):
    """Profile the block when ``enabled``: the card's activity, or with
    ``labelled`` the host's as well; yields a holder whose ``events`` are
    set when the block ends."""
    holder = type("Holder", (), {"events": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if card else []
    if labelled or not card:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        with record_function(WINDOW):
            yield holder
    holder.events = raw_events(prof)


def raw_events(prof) -> Dict[str, List[Tuple[str, int, int]]]:
    """{"device": [(name, start_ns, end_ns)], "host": [...], "annotations":
    [...]} from a finished profiler."""
    out = {"device": [], "host": [], "annotations": []}
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        rec = (e.name(), start, end)
        on_card = str(e.device_type()).endswith("CUDA")
        kind = str(getattr(e, "activity_type", lambda: "")())
        if e.is_user_annotation() or "annotation" in kind:
            if not on_card:           # the card's copy of an annotation is no work
                out["annotations"].append(rec)
        elif on_card:
            out["device"].append(rec)
        else:
            out["host"].append(rec)
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _label(t: int, annotations, host) -> str:
    """The annotations covering ``t``, outermost first, then the innermost
    host operation covering it; "host" if nothing does."""
    ann = sorted((a for a in annotations if a[1] <= t < a[2] and a[0] != WINDOW),
                 key=lambda a: a[1])
    names = [a[0] for a in ann]
    ops = [h for h in host if h[1] <= t < h[2]]
    if ops:
        names.append(min(ops, key=lambda h: h[2] - h[1])[0])
    return " > ".join(names) if names else "host"


def summarize(events: Dict[str, list], window_s: float = None, top: int = 10) -> Dict:
    """A window's reduction: ``window_s``, ``busy_s``, ``kernel_s`` {name:
    seconds}, ``device_ops`` and ``idle_gaps`` (each at most ``top`` entries
    of [name, seconds]; a gap's label is "host" where the window recorded
    no host operation). The window is the annotation's where the trace
    holds it, else ``window_s`` of the host's clock from the card's first
    operation."""
    win = [a for a in events["annotations"] if a[0] == WINDOW]
    if win:
        w0, w1 = win[0][1], win[0][2]
    elif events["device"] and window_s:
        w0 = min(s for _, s, _ in events["device"])
        w1 = max(max(e for _, _, e in events["device"]), w0 + int(window_s * 1e9))
    else:
        raise ValueError("the trace holds no window annotation, and no window was given")
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in events["device"] if e > w0 and s < w1]
    kernel_s: Dict[str, float] = {}
    for n, s, e in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) * 1e-9
    union = _union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in union) * 1e-9
    gaps, last = [], w0
    for s, e in union:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = [[_label((s + e) // 2, events["annotations"], events["host"]), (e - s) * 1e-9]
            for s, e in gaps[:top]]
    ops = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy, "kernel_s": kernel_s,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def seconds_of(kernel_s: Dict[str, float], names) -> float:
    """Device seconds of the kernels named one of ``names`` (the demangled
    name, with or without ``void``, an anonymous namespace, template or
    argument lists)."""
    pat = re.compile(r"^(void )?(\(anonymous namespace\)::)?("
                     + "|".join(map(re.escape, names)) + r")[<(]")
    return sum(s for n, s in kernel_s.items() if pat.match(n))

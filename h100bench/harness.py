"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the program's modules from a configuration's settings,
the weights drawn from the seed, the scene fixture's occupancy, and the
result's lines.

A cell names a configuration (``configs[].file``) and a traffic mix,
``h100bench/traffic/<traffic>.json``, whose ``kind`` picks the driver
(``train`` or ``render``). A per-layer metric is
``h100bench/metrics/<name>.py``, whose ``read(record)`` returns a number or
None.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "pagnerf_tpu")
# the density head's output bias; its first entry is the density before the ReLU
DENSITY_BIAS = "nef.decoder_density.lout.bias"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def find_cell(root: str, name: str) -> Dict:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration,
    traffic mix and metrics: {"bench", "cell", "config", "traffic",
    "end_to_end", "per_layer"}."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "h100bench", "traffic", cell["traffic"] + ".json"))

    def mine(metric):
        return name in metric.get("workloads", [name])
    return {"bench": bench, "cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)], "root": root}


def metric_reader(root: str, name: str):
    """``read`` of ``<root>/h100bench/metrics/<name>.py``."""
    path = os.path.join(root, "h100bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("h100bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def settings_of(config: Dict, traffic: Dict) -> Dict:
    """The run's settings: the configuration's, with the traffic mix's
    ``settings`` (how this mix runs it: the fused step, the dispatch depth)
    on top."""
    return {**config["settings"], **traffic.get("settings", {})}


def program_args(settings: Dict):
    """The program's parsed options with every one of ``settings`` set, as
    its command line would hold them; refuses an option it does not know
    or reads otherwise."""
    from pagnerf_tpu_torch.config.config import build_parser
    parser = build_parser()
    known = {a.dest for a in parser._actions}
    unknown = sorted(set(settings) - known)
    if unknown:
        raise ValueError(f"options the program does not know: {unknown}")
    parser.set_defaults(**settings)
    args = parser.parse_args([])
    wrong = [k for k, v in settings.items() if getattr(args, k) != v]
    if wrong:
        raise ValueError(f"the program reads these options otherwise: {wrong}")
    return args


def build_program(settings: Dict, data: Dict, dev, seed: int, draw):
    """(pipeline, dataset, trainer) through the program's own factory, the
    dataset being the benchmark's frames, the random draws ``draw``'s."""
    from unittest import mock

    from pagnerf_tpu_torch.config import factory
    from pagnerf_tpu_torch.data.multiview import MultiviewDataset
    args = program_args(settings)
    dataset = MultiviewDataset(data)
    with mock.patch.object(factory, "load_dataset", lambda _args: dataset):
        pipe, ds, trainer = factory.get_modules_from_config(args, device=str(dev), seed=seed)
    trainer.draw = draw
    return pipe, ds, trainer


def make_weights(shapes: Dict[str, tuple], spec: Dict, seed: int, dev) -> Dict:
    """Weights of every named shape (the extrinsics excepted, which come from
    the frames' poses) from ``seed``, on ``dev``, in one draw: uniform, a
    table's entries within +-``table_halfwidth``, a kernel's within the
    LeCun variance's +-sqrt(3 / fan_in), a bias's within
    +-``bias_halfwidth``; then the density head's output bias is set to
    ``density_bias``, so that occupied space is dense, as in a trained
    field, and a ray that meets it renders near-opaque."""
    import torch
    names = [n for n in shapes if not n.startswith("extrinsics")]
    total = sum(int(np.prod(shapes[n])) for n in names)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(total, generator=gen, device=dev) * 2.0 - 1.0
    out, at = {}, 0
    for n in names:
        k = int(np.prod(shapes[n]))
        if n.endswith("tables"):
            half = spec["table_halfwidth"]
        elif n.endswith("kernel"):
            half = math.sqrt(3.0 / shapes[n][0])
        else:
            half = spec["bias_halfwidth"]
        out[n] = (u[at:at + k] * half).reshape(shapes[n])
        at += k
    out[DENSITY_BIAS][0] = float(spec["density_bias"])
    return out


def load_weights(module, weights: Dict) -> None:
    """Copy ``weights`` into ``module``'s parameters of the same names, in
    place; refuses a name or shape that differs."""
    import torch
    params = dict(module.named_parameters())
    have = {n: tuple(p.shape) for n, p in params.items() if not n.startswith("extrinsics")}
    want = {n: tuple(w.shape) for n, w in weights.items()}
    if have != want:
        raise ValueError(f"parameters differ from the weights: {sorted(set(have) ^ set(want))} "
                         f"{[n for n in have if n in want and have[n] != want[n]]}")
    with torch.no_grad():
        for n, w in weights.items():
            params[n].copy_(w)


def forbidden_modules(modules) -> List[str]:
    """Modules whose top-level name is one of ``FORBIDDEN`` (whole names)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                checks: List[Dict], breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(out, allow_nan=False)


def check_lines(checks: List[Dict]) -> List[str]:
    return [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})" for c in checks]

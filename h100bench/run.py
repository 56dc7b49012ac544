"""The benchmark of pagnerf_tpu_torch on one H100.

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also end standard
error. Exits non-zero, printing no result, without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def cache_dirs(root: str) -> None:
    """Every kernel cache at a fixed path inside the checkout (the program
    builds its nvcc libraries into ``pagnerf_tpu_torch/_build``)."""
    cache = os.path.join(root, "h100bench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def end_to_end(record: dict) -> dict:
    return {"setup_s": record["setup_s"], "train_rays_per_s": record.get("rays_per_s"),
            "render_rays_per_s": record.get("rays_per_s"),
            "view_ms_p95": record.get("view_ms_p95")}


def measure(argv=None, root=None, allow_cpu=False, control=False, hooks=None):
    """One run; returns (result line, check lines) or raises. ``allow_cpu``
    and ``hooks`` (keyword arguments for the driver) serve the tests."""
    args = parse(argv)
    root = os.path.abspath(root or os.getcwd())
    cache_dirs(root)
    import torch

    from h100bench import harness, render, train
    cell = harness.find_cell(root, args.workload)
    chips = int(cell["cell"]["chips"])
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        dev = torch.device("cuda", 0)
    elif allow_cpu:
        dev = torch.device("cpu")
    else:
        raise SystemExit(f"the cell needs {chips} CUDA card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = {"train": train.run, "render": render.run}[cell["traffic"]["kind"]]
    record = driver(cell, args.seed, args.seconds, bool(args.trace), T_START, dev,
                    control=control, **(hooks or {}))
    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = harness.metric_reader(root, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(record)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    limits = harness.load_json(os.path.join(root, "h100bench", "limits",
                                            args.workload + ".json"))
    checks = [{"name": k, "value": record["numbers"][k], "limit": limits[k]} for k in limits]
    correct = all(isinstance(c["value"], (int, float)) and c["value"] == c["value"]
                  and c["value"] <= c["limit"] for c in checks)
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": chips, "memory_peak_bytes": int(record["peak"])}
    breakdown = None
    if args.trace and record.get("trace"):
        tr = record["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": record.get("labels") or tr["idle_gaps"]}
    found = harness.forbidden_modules(sys.modules)
    if found:
        raise SystemExit(f"loaded in this process: {found}")
    line = harness.result_line(correct, record["attempted"], 0 if correct else 1, metrics,
                               device, checks, breakdown)
    return line, record.get("details", []) + harness.check_lines(checks)


def main(argv=None) -> int:
    try:
        line, checks = measure(argv)
    except SystemExit as e:
        print(str(e), file=sys.stderr)
        return 2
    for c in checks:
        print(c, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

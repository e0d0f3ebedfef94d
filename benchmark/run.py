"""Runs one cell of the benchmark and prints its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up (build, weights, loaders, the first three steps, which warm every
shape up and are kept for ``correct``) counts as ``setup_s``, from the start
of this process; the window then runs for ``--seconds``; with ``--trace 1``
a few more steps or batches run under the profiler and the per-layer
metrics are printed instead of the end-to-end ones.  After the window the
program's state is freed and the plain float32 reference
(``benchmark/reference/``) decides ``correct``; each compared number is
printed with its limit as the last lines of standard error and under the
result's last key, ``checks``.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "css_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``css_tpu_torch`` is not ``css_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell`` on ``device``; the result's dict (without
    printing)."""
    import importlib

    import torch

    from benchmark import compare
    from benchmark.train_cell import sync

    kind = cell.traffic["kind"]
    # the generator of a traffic kind: benchmark/<kind>_cell.py, its Run class
    runner = importlib.import_module(f"benchmark.{kind}_cell").Run(cell, seed, device)
    runner.setup()
    sync(device)
    setup_s = time.time() - t0
    window = runner.window(seconds)
    summary = runner.trace() if trace else None
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    record = runner.record(window, summary)
    runner.free()
    ref = runner.reference()
    numbers = runner.numbers(ref)
    correct, failed, checks = compare.judge(numbers, cell.limits)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = runner.end_to_end(window, setup_s, peak)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and all(math.isfinite(v) for v in numbers.values())),
              "attempted": window["steps"], "failed": failed, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.get("busy_s", 0.0)
        dev["window_s"] = summary.get("span_s", 0.0)
        if "breakdown" in summary:
            result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    result["_detail"] = {"window_steps": window["steps"], "window_s": window["seconds"],
                         "images": window["images"], "setup_s": setup_s,
                         "setup_phases": getattr(runner, "setup_phases", None),
                         "trace": None if summary is None else
                         {k: summary.get(k) for k in ("kernels", "units", "busy_s", "span_s",
                                                      "host_s", "read_s", "ms_by_category",
                                                      "launches_per_step")},
                         "reference_losses": ref.get("losses"),
                         "program_losses": getattr(runner, "prog", {}).get("losses")}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                      T0)
    return emit(result)


def emit(result: dict) -> int:
    """Refuses a process that loaded JAX or the JAX package; otherwise
    prints the checks to standard error and the result line to standard
    output."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    detail = result.pop("_detail", None)
    card = _power_limit() if result["device"]["platform"] == "gpu" else "no card"
    print(f"benchmark: card {card}; detail {json.dumps(detail)}", file=sys.stderr)
    for name, check in result["checks"].items():
        limit = "not compared" if check["limit"] is None else repr(check["limit"])
        print(f"check {name} {check['value']!r} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

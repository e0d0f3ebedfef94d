"""Cells by name: ``BENCHMARK.json``'s entry, its configuration, its traffic
mix, its limits and its per-layer metric readers, each from a file of its
own under ``benchmark/``.

* configuration ``<config>``: ``benchmark/configs/<config>.json``, the
  recipe as it runs (the reference YAML's groups) with ``source``,
  ``assumed`` and ``reduced``;
* traffic ``<traffic>``: ``benchmark/traffic/<traffic>.json``, the
  parameters of the one generator of that ``kind`` (``train`` or ``eval``);
* limits of ``correct``: ``benchmark/limits/<cell>.json``;
* per-layer metric ``<name>``: ``benchmark/layer_metrics/<name>.py`` with
  ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["ROOT", "HERE", "Cell", "load_cell", "effective_config", "step_config_kwargs"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]          # the cell's end-to-end metrics, as declared
    per_layer: List[dict]           # the cell's per-layer metrics, as declared
    readers: Dict[str, Callable[[dict], Optional[float]]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def _reader(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.layer_metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(name: str, bench_path: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root)."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    config = effective_config(_json(HERE / "configs" / f"{entry['config']}.json"), traffic)
    limits = _json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _in_cell(m, name, e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer,
                readers={m["name"]: _reader(m["name"]) for m in layer})


def effective_config(config: dict, traffic: dict) -> dict:
    """The configuration with the traffic's ``overrides`` (dotted paths,
    such as ``Loss.negative_mode``) written into a copy."""
    out = json.loads(json.dumps(config))
    for path, value in traffic.get("overrides", {}).items():
        group, key = path.split(".", 1)
        out.setdefault(group, {})[key] = value
    return out


def step_config_kwargs(config: dict, strategy: str, distributed: bool) -> dict:
    """The train step's settings from the configuration's groups, as the
    program's training entry point maps its YAML."""
    net, data, loss = config["Network"], config["Dataset"], config["Loss"]
    train = config.get("Training_Setting", {})
    c = net["num_class"]
    return dict(
        num_classes=c,
        crop_hw=tuple(data["crop_size"]),
        scale_range=tuple(data["scale_size"]),
        strategy=strategy,
        mix_mode=data.get("mix_mode", "cutmix"),
        mix_partner=config.get("Distributed", {}).get("mix_partner", "reference"),
        sup_loss=loss.get("sup_loss", "ohem" if c == 19 else "ce"),
        ohem_thresh=loss.get("ohem_thresh", 0.7),
        ohem_min_kept_per_image=loss.get("ohem_min_kept_per_image", 50000),
        un_threshold=loss.get("un_threshold", 0.97),
        weak_threshold=loss.get("weak_threshold", 0.7),
        strong_threshold=loss.get("strong_threshold", 0.97),
        temp=loss.get("temp", 0.5),
        rep_temp=loss.get("rep_temp", loss.get("temp", 0.5)),
        num_queries=loss.get("num_queries", 256),
        num_negatives=loss.get("num_negatives", 512),
        proto_alpha=loss.get("alpha", 0.99),
        ema_alpha=config.get("EMA", {}).get("alpha", 0.99),
        contrast_enabled=bool(loss.get("is_available", True)),
        negative_mode=loss.get("negative_mode", "sampled_pallas"),
        aug_quantize=bool(train.get("aug_quantize", False)),
        fused_forward=bool(train.get("fused_forward", False)),
        distributed=distributed,
    )

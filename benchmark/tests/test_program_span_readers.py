"""The ``program_span`` readers (``benchmark/program_spans.py``): nothing to
read gives ``None``; a filled recorder gives its sums over the count of
``css.step``; a program without the recorder gives ``None`` and raises
nothing."""

import json
import sys
import types
import warnings

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"
         and m["name"] != "loader_wait_ms.train"]
PHASES = ("augment", "teacher", "student", "losses", "backward", "update")
SYNC = "called a synchronizing CUDA operation (Triggered internally at probe.cpp:1.)"
RECORD = {"kind": "train", "trace": None, "window": {"steps": 0}}


def _readers():
    from benchmark.spec import load_cell

    readers = {}
    for cell in ("voc_ori_train", "city_ori_train"):
        readers.update(load_cell(cell).readers)
    return readers


@pytest.fixture
def recorder():
    from css_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def test_the_eight_metrics_are_declared():
    assert sorted(NAMES) == sorted([f"span_ms.{p}.train" for p in PHASES]
                                   + ["host_syncs.train", "loader_block_ms.train"])
    assert set(NAMES) <= set(_readers())


def test_none_without_spans(recorder):
    readers = _readers()
    assert all(readers[n](RECORD) is None for n in NAMES)
    with recorder.tracing():                        # spans, but no css.step
        with recorder.span("css.loader", device=False):
            pass
    assert all(readers[n](RECORD) is None for n in NAMES)


def test_per_step_values_of_a_filled_recorder(recorder):
    readers = _readers()
    with recorder.tracing():
        for step in range(4):
            with recorder.span("css.draws"):
                warnings.warn(SYNC)
            for _ in range(2):
                with recorder.span("css.loader", device=False):
                    pass
            with recorder.span("css.step"):
                with recorder.span("css.augment"):
                    for _ in range(3):
                        warnings.warn(SYNC)
                with recorder.span("css.update"):
                    pass
    with recorder.tracing():
        with recorder.span("css.loader", device=False):     # outside any step: not counted
            warnings.warn(SYNC)
    spans = recorder.snapshot()
    assert readers["host_syncs.train"](RECORD) == 4.0       # 3 in css.augment, 1 in css.draws
    assert readers["loader_block_ms.train"](RECORD) == pytest.approx(
        spans["css.loader"]["host_ms"] / 4)
    assert readers["span_ms.augment.train"](RECORD) is None  # no card: no device interval
    assert readers["host_syncs.train"](dict(RECORD, kind="eval")) is None


def test_device_intervals_a_step(recorder, monkeypatch):
    spans = {"css.step": {"count": 4, "device_ms": 2000.0, "syncs": 0, "parent": None},
             "css.loader": {"count": 8, "host_ms": 12.0, "device_ms": None, "syncs": 0,
                            "parent": None}}
    for i, p in enumerate(PHASES):
        spans[f"css.{p}"] = {"count": 8 if p == "augment" else 4, "device_ms": 40.0 * (i + 1),
                             "syncs": i, "parent": "css.step"}
    spans["css.deeper"] = {"count": 4, "device_ms": 1.0, "syncs": 5, "parent": "css.losses"}
    monkeypatch.setattr(recorder, "snapshot", lambda: spans)
    readers = _readers()
    for i, p in enumerate(PHASES):
        assert readers[f"span_ms.{p}.train"](RECORD) == pytest.approx(10.0 * (i + 1))
    assert readers["host_syncs.train"](RECORD) == pytest.approx((sum(range(6)) + 5) / 4)
    assert readers["loader_block_ms.train"](RECORD) == pytest.approx(3.0)


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    bare = types.ModuleType("css_tpu_torch.utils.profiling")    # the parent's module
    bare.StepTimer = bare.maybe_profile = object
    monkeypatch.setitem(sys.modules, "css_tpu_torch.utils.profiling", bare)
    readers = _readers()
    assert all(readers[n](RECORD) is None for n in NAMES)

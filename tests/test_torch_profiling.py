"""The train step's spans and sync counter (``css_tpu_torch/utils/profiling.py``).

On the CPU: off, ``span()`` records nothing and touches nothing; under
``torch.profiler`` (the benchmark's schedule: one discarded unit, then kept
ones) a tiny train step records each phase once a step, ``css.augment``
twice, with the profiler's ranges of the same names nested as the spans are;
``tracing()`` records without the profiler; the sync counter counts every
warning of a synchronising call, in the innermost span, and puts the filters
back; the entry point's log line under ``--profile_dir`` carries the spans.

On the card (``-m gpu``; no JAX, so ``--noconftest`` works):

    python -m pytest --noconftest tests/test_torch_profiling.py -m gpu

a pageable copy to the card and ``.item()`` count one sync each, a pinned
``non_blocking`` copy none; the recorder itself never synchronises before
``snapshot()``; the six phases of a step hold 95-100% of ``css.step``'s
device interval.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from css_tpu_torch.data import BatchLoader, InfiniteLoader, SyntheticSpec
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train.draws import sample_step_draws
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import StepConfig, make_train_step
from css_tpu_torch.utils import profiling
from css_tpu_torch.utils.profiling import per_step_line, reset, snapshot, span, tracing

C, D, CROP, B = 6, 16, 32, 2
PHASES = ("css.augment", "css.teacher", "css.student", "css.losses", "css.backward",
          "css.update")
ONCE_A_STEP = ("css.step",) + PHASES[1:]
SYNC = "called a synchronizing CUDA operation (Triggered internally at probe.cpp:1.)"


class TinyRun:
    """The tiny trunk's ``ori`` step fed as the benchmark feeds it: two
    ``BatchLoader``s of synthetic records, the step's draws from
    ``sample_step_draws``, the step."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cfg = StepConfig(num_classes=C, crop_hw=(CROP, CROP), scale_range=(0.5, 1.5),
                              num_queries=8, num_negatives=16)
        model = build_model(C, D, "tiny")
        self.state = create_train_state(model, C, D, base_lr=1e-2, weight_decay=5e-4,
                                        total_steps=100, device=device)
        self.step_fn = make_train_step(self.cfg)
        h, w = self.state.model.output_hw(self.cfg.crop_hw)
        self.rows = 2 * B * h * w
        spec = SyntheticSpec(num_classes=C, canvas_hw=(40, 40), image_hw=(30, 40))
        self.loaders = [BatchLoader(spec, [f"{s}{i}" for i in range(8)], B, num_workers=2)
                        for s in "lu"]
        self.iters = [InfiniteLoader(x) for x in self.loaders]

    def next_batch(self):
        bl, bu = (next(it) for it in self.iters)
        batch = {"l_image": bl["image"], "l_label": bl["label"], "l_valid_hw": bl["valid_hw"],
                 "u_image": bu["image"], "u_valid_hw": bu["valid_hw"]}
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def step(self, batch=None):
        batch = self.next_batch() if batch is None else batch
        g = torch.Generator(device=self.device).manual_seed(self.state.step)
        draws = sample_step_draws(g, self.cfg, B, B, self.rows)
        self.state, metrics = self.step_fn(self.state, batch, draws, 1.0)
        return metrics

    def close(self):
        for loader in self.loaders:
            loader.close()


@pytest.fixture
def clean():
    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def profiled():
    """Two kept steps under the benchmark's profiler schedule (one discarded
    unit first), the recorder's snapshot and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile, schedule

    run = TinyRun(torch.device("cpu"))
    try:
        run.step()
        reset()
        with profile(activities=[ProfilerActivity.CPU],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run.step()
            warm = snapshot()
            prof.step()
            for _ in range(2):
                run.step()
            prof.step()
        spans = snapshot()
        events = [e for e in prof.events() if e.name.startswith("css.")]
    finally:
        run.close()
        reset()
    return warm, spans, events


# -------------------------------------------------------------------- off --

def test_off_records_nothing_and_touches_nothing(clean, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: calls.append(mode))
    show, filters = warnings.showwarning, list(warnings.filters)
    contexts = set()
    for i in range(1000):
        ctx = span(f"css.probe{i % 7}")
        contexts.add(id(ctx))
        with ctx:
            pass
    assert snapshot() == {}
    assert len(contexts) == 1 and span("css.other") is span("css.step")
    assert calls == []
    assert warnings.showwarning is show and warnings.filters == filters


# ------------------------------------------------------- under the profiler --

def test_profiled_step_counts_each_phase(profiled):
    warm, spans, _ = profiled
    assert warm == {}, "the discarded warm-up unit recorded"
    for name in ONCE_A_STEP + ("css.draws",):
        assert spans[name]["count"] == 2, (name, spans[name])
    assert spans["css.augment"]["count"] == 4
    assert spans["css.loader"]["count"] == 4          # both loaders, each step
    for e in spans.values():
        assert e["device_ms"] is None and e["host_ms"] > 0 and e["syncs"] == 0


def test_profiled_spans_nest_as_the_step(profiled):
    _, spans, _ = profiled
    assert spans["css.step"]["parent"] is None
    assert spans["css.draws"]["parent"] is None
    assert spans["css.loader"]["parent"] is None
    for name in PHASES:
        assert spans[name]["parent"] == "css.step", (name, spans[name])
    phases = sum(spans[n]["host_ms"] for n in PHASES)
    step = spans["css.step"]
    assert phases <= step["host_ms"]
    assert step["self_ms"] == pytest.approx(step["host_ms"] - phases, rel=1e-9, abs=1e-9)


def test_profiler_ranges_carry_the_span_names(profiled):
    _, spans, events = profiled
    counts = {}
    for e in events:
        counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {name: e["count"] for name, e in spans.items()}
    for e in events:
        if e.name in PHASES:
            parent = e.cpu_parent
            while parent is not None and parent.name != "css.step":
                parent = parent.cpu_parent
            assert parent is not None, f"{e.name} outside css.step"
            assert parent.time_range.start <= e.time_range.start
            assert e.time_range.end <= parent.time_range.end


# -------------------------------------------------------------- tracing() --

def test_tracing_records_without_the_profiler(clean):
    run = TinyRun(torch.device("cpu"))
    try:
        with tracing():
            run.step()
        run.step()                                     # off again
    finally:
        run.close()
    spans = snapshot()
    assert {n: spans[n]["count"] for n in ONCE_A_STEP} == {n: 1 for n in ONCE_A_STEP}
    assert spans["css.augment"]["count"] == 2
    assert per_step_line(spans).startswith("spans a step over 1 (device ms/host ms/syncs): ")
    assert "css.backward -/" in per_step_line(spans)


def test_snapshot_sums_self_time_and_parents(clean):
    with tracing():
        for _ in range(2):
            with span("outer", device=False):
                time.sleep(0.004)
                with span("inner", device=False):
                    time.sleep(0.002)
                with span("inner", device=False):
                    pass
    spans = snapshot()
    outer, inner = spans["outer"], spans["inner"]
    assert (outer["count"], inner["count"]) == (2, 4)
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert outer["self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    assert outer["self_ms"] >= 8.0 and inner["host_ms"] >= 4.0
    assert inner["self_ms"] == pytest.approx(inner["host_ms"])
    assert snapshot() == spans                          # reading again changes nothing
    reset()
    assert snapshot() == {}
    assert per_step_line(spans) == ""                   # no css.step


def test_sync_warnings_counted_in_the_innermost_span(clean):
    show, filters = warnings.showwarning, list(warnings.filters)
    with tracing():
        with span("outer", device=False):
            for _ in range(3):                          # one call site, three syncs
                warnings.warn(SYNC)
            with span("inner", device=False):
                warnings.warn(SYNC)
                with pytest.warns(UserWarning, match="unrelated"):
                    warnings.warn("unrelated")
    assert warnings.showwarning is show and warnings.filters == filters
    spans = snapshot()
    assert (spans["outer"]["syncs"], spans["inner"]["syncs"]) == (3, 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        warnings.warn(SYNC)                             # no span open: not counted
    assert len(seen) == 1 and snapshot()["outer"]["syncs"] == 3


def test_threads_keep_their_own_stacks(clean):
    seen = []

    def other():
        with span("css.loader", device=False):
            seen.append(profiling._RECORDER.stack()[0].parent)

    with tracing():
        with span("css.step", device=False):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [None]
    spans = snapshot()
    assert spans["css.loader"]["parent"] is None and spans["css.step"]["self_ms"] >= 0


def test_profile_dir_log_line_carries_the_spans(tmp_path, clean):
    from css_tpu_torch.cli import entries, train_main
    from tests.test_torch_driver import _tiny_yaml

    args = entries.ori_pseudo_parser().parse_args(
        ["--config", _tiny_yaml(tmp_path), "--job_name", "spans", "--device", "cpu",
         "--num_labels", "4", "--total_iter", "2", "--max_steps", "2",
         "--profile_dir", str(tmp_path / "trace")])
    train_main.run_training("ori", args)
    log = (tmp_path / "ckpt" / "spans" / "train.log").read_text()
    line = next(ln for ln in log.splitlines() if "Epoch:0" in ln)
    assert "spans a step over 2 (device ms/host ms/syncs): css." in line
    for name in ONCE_A_STEP + ("css.augment", "css.draws", "css.loader"):
        assert f"{name} " in line, name
    assert snapshot() == {}                             # reset after the line
    assert list((tmp_path / "trace").glob("trace_*.json"))


# ------------------------------------------------------------------- card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events and the sync debug mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_syncs_counted(cuda, clean):
    host = torch.arange(1 << 20, dtype=torch.float32).pin_memory()
    on_card = torch.ones(4, device=cuda)
    torch.cuda.synchronize()
    with tracing():
        with span("pageable"):
            torch.tensor([1, 2], device=cuda)
        with span("item"):
            on_card.sum().item()
        with span("pinned"):
            host.to(cuda, non_blocking=True)
    spans = snapshot()
    assert {n: spans[n]["syncs"] for n in ("pageable", "item", "pinned")} == \
        {"pageable": 1, "item": 1, "pinned": 0}
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_card_recorder_never_synchronises_before_snapshot(cuda, clean):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # a sync outside a span would raise
    try:
        torch.cuda._sleep(2_000_000_000)        # about a second of work ahead of the host
        with tracing():
            for _ in range(50):
                with span("css.step"):
                    with span("css.augment"):
                        pass
                    with span("css.update"):
                        pass
        still_busy = not torch.cuda.current_stream().query()
        assert torch.cuda.get_sync_debug_mode() == 2
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert still_busy, "the stream drained before snapshot(): something waited for it"
    spans = snapshot()
    assert torch.cuda.current_stream().query()
    assert {n: e["syncs"] for n, e in spans.items()} == \
        {"css.step": 0, "css.augment": 0, "css.update": 0}
    assert spans["css.step"]["count"] == 50
    assert all(e["device_ms"] is not None for e in spans.values())


@pytest.mark.gpu
def test_card_phases_fill_the_step(cuda, clean):
    run = TinyRun(cuda)
    try:
        run.step()
        run.step()              # the step's CUDA graph is captured here
        batches = [run.next_batch() for _ in range(3)]   # (a copy from pageable memory waits)
        torch.cuda.synchronize()
        reset()
        # the card kept busy while the host issues the steps, as in a real step
        # (the host ahead of the card), so that the spans time device work, not
        # the host's time between the tiny trunk's replays
        torch.cuda._sleep(200_000_000)
        with tracing():
            for batch in batches:
                run.step(batch)
        spans = snapshot()
    finally:
        run.close()
    step = spans["css.step"]
    assert step["count"] == 3 and spans["css.augment"]["count"] == 6
    share = sum(spans[n]["device_ms"] for n in PHASES) / step["device_ms"]
    assert 0.95 <= share <= 1.001, (share, spans)     # event timestamps: 0.5 us
    assert np.isfinite(step["self_ms"]) and step["self_ms"] >= 0

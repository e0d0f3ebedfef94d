"""The ``train`` traffic: the program's training loop body, one step after
another, as its training entry point runs it between evals.

Per step: the next labeled and unlabeled batches from the program's
``BatchLoader``s (wrapped in ``InfiniteLoader``; 8 decode threads; the
benchmark's seeded records), copied to the card from pinned memory on a side
stream one batch ahead (a frozen copy of the entry point's prefetch), the
step's draws from ``sample_step_draws`` with a generator seeded by (seed,
step), and the step that ``make_train_step(StepConfig(...))`` returns.

Set-up builds the state (``build_model``, ``create_train_state``, the
benchmark's weights), drives its first three steps through that same call
and feed (they warm every shape up), keeps what ``correct`` compares, and
hands the same state to the window.  The window runs steps until
``seconds`` have passed, then drains the card.  With ``trace`` a few more
steps run under the profiler.  Then the program's state is freed and the
reference repeats the first three steps.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np
import torch

from benchmark import compare, devtrace, flops, records, seeds, weights
from benchmark.reference import draws as ref_draws
from benchmark.reference.model import build_reference
from benchmark.reference.step import RefState, StepSettings, train_step as ref_step
from benchmark.spec import Cell, step_config_kwargs

__all__ = ["TrainRun", "Run", "CHECKED_STEPS", "StepMarks", "sync", "device_prefetch",
           "fp8_round", "halve"]

CHECKED_STEPS = 3
TRACED_STEPS = 4
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def device_prefetch(batches, device: torch.device):
    """Each numpy batch of ``batches`` as tensors on ``device``; on the card
    through pinned memory on a side stream, batch n + 1's copy started before
    batch n is yielded."""
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)

    def start(batch):
        with torch.cuda.stream(copy_stream):
            return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                    for k, v in batch.items()}

    it = iter(batches)
    ahead = next(it, None)
    ahead = None if ahead is None else start(ahead)
    while ahead is not None:
        current = ahead
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(copy_stream)
        for t in current.values():
            t.record_stream(compute)
        ahead = next(it, None)
        ahead = None if ahead is None else start(ahead)
        yield current


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepMarks:
    """Marks at step ends: CUDA events recorded on the current stream (read
    after the window, so the loop gains no synchronisation), or the host
    clock off the card."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude to 448), the gradient passed straight through: the control's
    convolution operands."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def halve(batch: dict, d: dict, rows_per_image: int):
    """The first half of the labeled and of the unlabeled batch, with their
    draws: per image, and the contrastive table's rows of the kept images."""
    b = batch["l_image"].shape[0]
    h = b // 2
    batch = {k: v[:h] for k, v in batch.items()}
    keep = torch.cat([torch.arange(h * rows_per_image),
                      b * rows_per_image + torch.arange(h * rows_per_image)])
    out = {k: {n: t[:h] for n, t in d[k].items()}
           for k in ("l_aug", "u_crop", "t_crop", "u_aug", "mix")}
    c = d["contrast"]
    keep = keep.to(c["tie"].device)
    out["contrast"] = {"tie": c["tie"][keep], "u1": c["u1"], "u": c["u"][:, keep]}
    return batch, out


def _host(named) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in named}


class TrainRun:
    """A training cell's run on one card."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        if cell.chips != 1:
            raise ValueError(f"{cell.name}: the train traffic runs on one card; a cell on "
                             f"{cell.chips} needs a traffic kind of its own")
        if cell.traffic["strategy"] != "ori":
            raise ValueError(f"{cell.name}: the reference steps the ori strategy only")
        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config
        self.net, self.data = cfg["Network"], cfg["Dataset"]
        self.batch = int(self.data["batch_size"])
        self.total_steps = int(cell.traffic["total_steps"])
        self.loader_seed = seeds.seed_of(seed, seeds.LOADER) % (1 << 31)
        self.maker = records.RecordMaker(tuple(self.data["canvas_size"]),
                                         tuple(cfg["Records"]["image_hw"]), self.net["num_class"])
        splits = cfg["Records"]["splits"]
        self.l_ids = records.split_ids(seed, "l", splits["labeled"])
        self.u_ids = records.split_ids(seed, "u", splits["unlabeled"])
        self.prog: dict = {}
        self.waits = []

    # ---------------------------------------------------------------- set-up --
    def setup(self) -> None:
        from css_tpu_torch.data import BatchLoader, InfiniteLoader
        from css_tpu_torch.models.deeplabv3 import build_model
        from css_tpu_torch.train.draws import sample_step_draws
        from css_tpu_torch.train.state import create_train_state
        from css_tpu_torch.train.train_step import StepConfig, make_train_step

        cfg = self.cell.config
        dev = self.device
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.backends.cudnn.benchmark = True
        model = build_model(self.net["num_class"], self.net.get("output_dim", 256),
                            self.net["backbone"], dtype=_DTYPES[self.net.get("dtype", "bfloat16")],
                            remat=bool(self.net.get("remat", False)))
        want = weights.layout(build_reference(cfg, device="meta"))
        if weights.layout(model) != want:
            raise RuntimeError("the program's network does not have the reference's tensors "
                               "(names and shapes)")
        state = create_train_state(
            model, self.net["num_class"], self.net.get("output_dim", 256),
            base_lr=float(cfg["Optim"]["lr"]), weight_decay=float(cfg["Optim"]["weight_decay"]),
            total_steps=self.total_steps, power=float(cfg["Lr_Scheduler"]["power"]),
            min_lr=float(cfg["Lr_Scheduler"]["min_lr"]), device=dev)
        weights.fill_(state.model, self.seed, self.net)
        weights.fill_(state.teacher, self.seed, self.net)
        self.step_cfg = StepConfig(**step_config_kwargs(cfg, self.cell.traffic["strategy"],
                                                        distributed=False))
        self.train_step = make_train_step(self.step_cfg)
        self.sample_draws = sample_step_draws
        h, w = state.model.output_hw(self.step_cfg.crop_hw)
        self.rows = 2 * self.batch * h * w

        def loader(ids):
            return BatchLoader(self.maker, ids, self.batch, seed=self.loader_seed, shuffle=True,
                               drop_last=True)

        self.loaders = (loader(self.l_ids), loader(self.u_ids))
        l_iter, u_iter = (InfiniteLoader(x) for x in self.loaders)

        def pairs():
            while True:
                bl, bu = next(l_iter), next(u_iter)
                yield {"l_image": bl["image"], "l_label": bl["label"],
                       "l_valid_hw": bl["valid_hw"], "u_image": bu["image"],
                       "u_valid_hw": bu["valid_hw"]}

        self.batches = device_prefetch(pairs(), dev)
        self.state = state
        sync(dev)
        t1 = time.perf_counter()

        losses = []
        for i in range(CHECKED_STEPS):
            metrics = self.step()
            losses.append(metrics["total"])
            if i == 0:
                first = {"sup": float(metrics["sup"]), "contrast": float(metrics["contrast"]),
                         "prototypes": state.prototypes.detach().float().cpu().clone(),
                         "teacher_buffers": _host(state.teacher.named_buffers())}
                opt = state.optimizer
                momentum = _host((k, opt.state[p].get("momentum_buffer", torch.zeros_like(p)))
                                 for k, p in state.model.named_parameters())
        self.prog = {
            "losses": [float(x) for x in losses], "momentum": momentum,
            "student": _host(state.model.named_parameters()),
            "teacher": _host(state.teacher.named_parameters()),
            "buffers": {**{f"student.{k}": v for k, v in
                           _host(state.model.named_buffers()).items()},
                        **{f"teacher.{k}": v for k, v in
                           _host(state.teacher.named_buffers()).items()}},
            "prototypes": state.prototypes.detach().float().cpu().clone(),
            "first": first,
        }
        self.waits = []
        sync(dev)
        self.setup_phases = {"build_s": t1 - t0, "first_steps_s": time.perf_counter() - t1}

    def step(self):
        t = time.perf_counter()
        batch = next(self.batches)
        self.waits.append(time.perf_counter() - t)
        g = seeds.generator(self.device, self.seed, seeds.TRAIN_DRAWS, self.state.step)
        draws = self.sample_draws(g, self.step_cfg, self.batch, self.batch, self.rows)
        self.state, metrics = self.train_step(self.state, batch, draws, 1.0)
        return metrics

    # ---------------------------------------------------------------- window --
    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed; CUDA events at each step's end
        (read after the window)."""
        marks = StepMarks(self.device)
        marks.mark()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            marks.mark()
            steps += 1
        sync(self.device)
        wall = time.perf_counter() - t0
        step_ms = marks.intervals_ms()
        return {"steps": steps, "seconds": wall, "step_ms": step_ms,
                "images": steps * 2 * self.batch,
                "loader_wait_s": list(self.waits)}

    def trace(self) -> dict:
        from css_tpu_torch.ops.kernels.contrastive_kernels import LAUNCHES

        before = dict(LAUNCHES)
        summary = devtrace.summarise(devtrace.profile_units(self.step, TRACED_STEPS, self.device))
        summary["launches_per_step"] = {k: (LAUNCHES[k] - before[k]) / (TRACED_STEPS + 1)
                                        for k in LAUNCHES}
        return summary

    def free(self) -> None:
        for loader in self.loaders:
            loader.close()
        self.state = self.batches = self.train_step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def record(self, window: dict, trace: Optional[dict]) -> dict:
        """What the per-layer readers read."""
        cfg = self.cell.config
        crop = tuple(self.data["crop_size"])
        step_flops = flops.train_step_flops(cfg, crop, self.batch, self.batch)
        return {"kind": "train", "window": window, "trace": trace,
                "flops_per_step": step_flops,
                "class_live_rows_bytes": flops.class_live_rows_bytes(self.net["num_class"],
                                                                     self.rows),
                "peak_flop_per_s": flops.BF16_FLOP_PER_S,
                "hbm_bytes_per_s": flops.HBM_BYTES_PER_S}

    # ------------------------------------------------------------- reference --
    def reference(self, variant: Optional[str] = None) -> dict:
        """The reference's first three steps from the same weights, records
        and draws; ``variant`` "fp8" (the control: float8 convolution
        operands) or "half_batch" (a planted fault: each step on the first
        half of the labeled and of the unlabeled batch, with their draws)."""
        cfg = self.cell.config
        dev = self.device
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.benchmark)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        try:
            model = build_reference(cfg, device=dev)
            weights.fill_(model, self.seed, self.net)
            w0 = _host(model.named_parameters())
            b0 = _host(model.named_buffers())
            st = RefState(model, self.net["num_class"], self.net.get("output_dim", 256))
            if variant == "fp8":
                st.student.quantize = st.teacher.quantize = fp8_round
            s = StepSettings(cfg, self.total_steps)
            losses, first = [], None
            for i in range(CHECKED_STEPS):
                batch = self._reference_batch(i)
                g = seeds.generator(dev, self.seed, seeds.TRAIN_DRAWS, i)
                d = ref_draws.step(g, s.num_classes, s.crop, s.scale, self.batch, self.batch,
                                   self.rows, s.num_queries)
                if variant == "half_batch":
                    batch, d = halve(batch, d, self.rows // (2 * self.batch))
                losses.append(ref_step(st, batch, d, s))
                if i == 0:
                    first = dict(st.last_terms, prototypes=st.prototypes.float().cpu().clone(),
                                 teacher_buffers=_host(st.teacher.named_buffers()))
            out = {"losses": losses, "w0": w0, "first": first,
                   "b0": {**{f"student.{k}": v for k, v in b0.items()},
                          **{f"teacher.{k}": v for k, v in b0.items()}},
                   "grads": {k: v.float().cpu() for k, v in st.first_grads.items()},
                   "student": _host(st.student.named_parameters()),
                   "teacher": _host(st.teacher.named_parameters()),
                   "buffers": {**{f"student.{k}": v for k, v in
                                  _host(st.student.named_buffers()).items()},
                               **{f"teacher.{k}": v for k, v in
                                  _host(st.teacher.named_buffers()).items()}},
                   "prototypes": st.prototypes.float().cpu()}
            del st, model
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark) = flags

    def _reference_batch(self, i: int) -> dict:
        """Batch ``i`` of the first epoch, as the loaders served it: the
        permutation of ``default_rng(seed * 1000003 + epoch)``, cut in order."""
        def ids(split):
            order = np.random.default_rng(self.loader_seed * 1000003).permutation(len(split))
            return [split[k] for k in order[i * self.batch:(i + 1) * self.batch]]

        lb, ub = self.maker.batch(ids(self.l_ids)), self.maker.batch(ids(self.u_ids))
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return {"l_image": to(lb["image"]), "l_label": to(lb["label"]),
                "l_valid_hw": to(lb["valid_hw"]), "u_image": to(ub["image"]),
                "u_valid_hw": to(ub["valid_hw"])}

    def numbers(self, ref: dict) -> dict:
        return compare.train_numbers(self.prog, ref, float(self.cell.config["Optim"]
                                                           ["weight_decay"]))

    @staticmethod
    def end_to_end(window: dict, setup_s: float, peak_bytes: int) -> dict:
        """The end-to-end metrics of a window: images of every step over the
        window's wall time; the 90th percentile of the steps' times; the
        peak of device memory over set-up and window; set-up time."""
        return {"train_img_per_s": window["images"] / window["seconds"],
                "step_ms_p90": float(np.percentile(window["step_ms"], 90)),
                "peak_mem_gib": peak_bytes / 2 ** 30,
                "setup_s": setup_s}


Run = TrainRun      # the runner that run.py finds by the traffic's kind

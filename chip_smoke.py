#!/usr/bin/env python3
"""Drives css_tpu_torch's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--steps N] [--profile]

Phases, in order; any failure ends the run with a traceback and a non-zero
exit code, and no result line:

1. header: the card (``nvidia-smi``), torch and CUDA versions, TF32 flags;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once;
3. kernels: K1 and K2 at the main-path shapes (Q = 256 anchors, D = 256,
   N = 262,144 table rows), held against their plain PyTorch versions on
   the same inputs, once with a dead half of the weights and once with the
   thinned multiplicities the main path feeds them; then timed beside the
   plain versions, the ``torch.matmul`` yardstick and the least time the
   card could take for the same work;
4. contrastive: the port's contrastive loss and its gradient at a small
   input on the card (through K1/K2) against the same call on the CPU
   (through the plain versions);
5. train: the flagship ``ori`` step -- ResNet-101 OS8 DeepLabV3+ dual head,
   21 classes, 512x512 crops, 8 labeled + 8 unlabeled images, CutMix,
   ``sampled_pallas`` negatives, bf16 compute, random weights from a seed,
   synthetic data -- 2 warm-up steps, then ``--steps`` timed steps with the
   kernel launch counters zeroed just before and read just after: every
   loss must be finite and each kernel must launch once per class per step.

The output ends with one JSON line of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
Q, D, N = 256, 256, 262_144     # 16 images x 128^2 representation pixels
INV_TEMP = 2.0                  # 1 / temp, temp = 0.5
NUM_NEGATIVES = 512
K1_RTOL = 1e-3                  # same bf16 products, f32 sums in another order
K2_RTOL = 1e-2                  # plus K2's bf16 exp: one bf16 step (2^-8) may flip
K2_ATOL_FRACTION = 1e-2         # of max |M|


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the summed durations of the kernels ``fn``
    launches, from torch.profiler, without the host's gaps between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in p.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / iters / 1e3


def _kernel_inputs(torch, ck, g, w_kind: str):
    dev = "cuda"
    a = torch.nn.functional.normalize(torch.randn(Q, D, device=dev, generator=g), dim=1)
    r = torch.nn.functional.normalize(torch.randn(N, D, device=dev, generator=g), dim=1)
    if w_kind == "dead_half":
        w = torch.rand(N, device=dev, generator=g)
        w[N // 2:] = 0.0
    else:   # thinned multiplicities around lam, sum(lam) = G, on the labeled half
        lam = torch.rand(N, device=dev, generator=g)
        lam[N // 2:] = 0.0
        lam *= NUM_NEGATIVES / lam.sum()
        w = ck.thinned_multiplicities(torch.rand(N, device=dev, generator=g), lam)
    return a.to(torch.bfloat16), r.to(torch.bfloat16), w


def _bounds_ms(a, r, w, torch):
    """Least time for K1 and K2 on these inputs: only rows with a nonzero
    weight are needed, besides the weights themselves and the anchors."""
    live = int(torch.count_nonzero(w))
    q, d = a.shape
    read = q * d * 2 + w.numel() * 4 + live * d * 2
    out = {}
    for name, ops, written in (("k1", 2 * q * d * live, q * 4),
                               ("k2", 4 * q * d * live, q * d * 4)):
        t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_FLOP_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out, live


def kernel_phase(torch, ck):
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {"k1": {"max_abs_err": 0.0}, "k2": {"max_abs_err": 0.0}}
    for kind in ("dead_half", "thinned"):
        a, r, w = _kernel_inputs(torch, ck, g, kind)
        s = ck.softsum_kernel(a, r, w, INV_TEMP)
        m = ck.softsum_moment_kernel(a, r, w, INV_TEMP)
        torch.cuda.synchronize()
        s_ref = ck.softsum_plain(a, r, w, INV_TEMP)
        m_ref = ck.softsum_moment_plain(a, r, w, INV_TEMP)
        torch.testing.assert_close(s, s_ref, rtol=K1_RTOL, atol=1e-6)
        m_scale = m_ref.abs().max().item()
        torch.testing.assert_close(m, m_ref, rtol=K2_RTOL, atol=K2_ATOL_FRACTION * m_scale)
        errs = {"k1": (s - s_ref).abs().max().item(), "k2": (m - m_ref).abs().max().item()}
        bounds, live = _bounds_ms(a, r, w, torch)
        timing = {
            "k1": (lambda: ck.softsum_kernel(a, r, w, INV_TEMP),
                   lambda: ck.softsum_plain(a, r, w, INV_TEMP)),
            "k2": (lambda: ck.softsum_moment_kernel(a, r, w, INV_TEMP),
                   lambda: ck.softsum_moment_plain(a, r, w, INV_TEMP)),
        }
        library_ms = _cuda_ms(lambda: torch.matmul(a, r.T), 10)
        for name, (kern, plain) in timing.items():
            row = dict(ms=_cuda_ms(kern, 20), plain_ms=_cuda_ms(plain, 5),
                       bound_ms=bounds[name][0], bound_by=bounds[name][1],
                       library_ms=library_ms, max_abs_err=errs[name])
            print(f"kernel {name} w={kind} live_rows={live}: " + json.dumps(row)
                  + f" device_ms={_device_ms(torch, kern, 20)}", flush=True)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], errs[name])
            if kind == "thinned":     # what the main path feeds the kernels
                results[name].update({k: v for k, v in row.items() if k != "max_abs_err"})
        del a, r, w, s, m, s_ref, m_ref
        torch.cuda.empty_cache()
    return results


def contrastive_phase(torch):
    """The contrastive loss on the card (K1/K2) against the CPU (plain)."""
    from css_tpu_torch.losses.contrastive import prototype_contrastive_loss

    g = torch.Generator().manual_seed(1)
    b, h, w, c, q = 4, 16, 16, 21, 256
    n = b * h * w
    rep = torch.randn(b, h, w, D, generator=g)
    lab = torch.randint(0, c, (b, h, w), generator=g)
    onehot = torch.nn.functional.one_hot(lab, c).float()
    mask = (torch.rand(b, h, w, generator=g) < 0.8).float()
    prob = torch.softmax(3 * torch.randn(b, h, w, c, generator=g), dim=-1)
    protos = torch.randn(c, D, generator=g)
    draws = dict(tie=torch.randint(0, 1 << 24, (n,), generator=g, dtype=torch.int32),
                 u1=torch.rand(c, q, generator=g), u=torch.rand(c, n, generator=g))
    out = {}
    for dev in ("cpu", "cuda"):
        x = rep.to(dev).detach().requires_grad_(True)
        loss, new_protos = prototype_contrastive_loss(
            x, onehot.to(dev), mask.to(dev), prob.to(dev), protos.to(dev),
            **{k: v.to(dev) for k, v in draws.items()}, num_negatives=NUM_NEGATIVES)
        loss.backward()
        out[dev] = (loss.detach().cpu(), new_protos.cpu(), x.grad.cpu())
    torch.cuda.synchronize()
    # bf16 operands in both; sums in another order, K2's bf16 exp
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-5)
    g_scale = out["cpu"][2].abs().max().item()
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=2e-2, atol=1e-2 * g_scale)
    print(f"contrastive: loss cuda {out['cuda'][0].item():.6f} cpu {out['cpu'][0].item():.6f}",
          flush=True)


def train_phase(torch, ck, steps: int, profile: bool):
    from css_tpu_torch.models.deeplabv3 import build_model
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.state import create_train_state
    from css_tpu_torch.train.train_step import StepConfig, make_train_step, rep_hw

    c, crop, bsz = 21, 512, 8
    cfg = StepConfig(num_classes=c, crop_hw=(crop, crop), scale_range=(0.5, 1.5))
    model = build_model(c, 256, "resnet101", dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, c, 256, base_lr=6.4e-3, weight_decay=5e-4,
                               total_steps=80_000, device="cuda")
    step = make_train_step(cfg)

    g_cpu = torch.Generator().manual_seed(0)
    batch = {
        "l_image": torch.rand(bsz, crop, crop, 3, generator=g_cpu),
        "l_label": torch.randint(0, c, (bsz, crop, crop), generator=g_cpu, dtype=torch.int32),
        "l_valid_hw": torch.full((bsz, 2), crop, dtype=torch.int32),
        "u_image": torch.rand(bsz, crop, crop, 3, generator=g_cpu),
        "u_valid_hw": torch.full((bsz, 2), crop, dtype=torch.int32),
    }
    batch = {k: v.cuda() for k, v in batch.items()}
    g = torch.Generator(device="cuda").manual_seed(1)
    h, w = rep_hw(cfg.crop_hw)

    def one_step():
        draws = sample_step_draws(g, cfg, bsz, bsz, 2 * bsz * h * w)
        _, metrics = step(state, batch, draws, 1.0)
        return metrics

    for _ in range(2):
        metrics = one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ck.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(one_step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(ck.LAUNCHES)

    for i, m in enumerate(losses):
        vals = {k: v.item() for k, v in m.items()}
        print(f"train step {i}: {times[i] * 1e3:.3f} ms " + json.dumps(vals), flush=True)
        bad = [k for k, v in vals.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise RuntimeError(f"non-finite losses at timed step {i}: {bad}")
    want = c * steps
    for name, count in launches.items():
        if count != want:
            raise RuntimeError(f"{name}: {count} launches in {steps} steps, want {want}")
    dt = sum(times) / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {dt * 1e3:.3f} ms/step (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}), {2 * bsz / dt:.3f} img/s, peak memory {peak_gib:.3f} GiB, "
          f"launches {json.dumps(launches)}", flush=True)
    if profile:
        profile_step(torch, one_step)
    return launches


_CATEGORIES = (   # first match wins, on the lower-cased kernel name
    ("contrastive K1/K2", ("partial_kernel", "sum_partials")),
    ("convolution", ("conv", "wgrad", "dgrad", "xmma", "cudnn", "nhwc", "nchw")),
    ("matmul", ("gemm", "cutlass", "sm90")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduction", ("reduce",)),
)


def profile_step(torch, one_step):
    """One more step under torch.profiler: device time by kernel category,
    the top kernels, and the device's idle share of the step's wall time
    (the profiler's own host overhead inflates the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    intervals = []
    for e in p.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    busy, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > last:
            busy += end - max(start, last)
            last = end
    by_cat = {}
    for name, us in by_name.items():
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES if any(k in low for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    total = sum(by_name.values())
    print(f"profile: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.4f}, kernels {len(intervals)}", flush=True)
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"profile category {cat}: {us / 1e3:.3f} ms ({us / total:.4f})", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"profile kernel {us / 1e3:9.3f} ms  {name[:110]}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3, help="timed train steps (>= 3)")
    parser.add_argument("--profile", action="store_true",
                        help="profile one more step and print its kernel table")
    args = parser.parse_args()
    if args.steps < 3:
        parser.error("--steps must be at least 3")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from css_tpu_torch.ops.kernels import _build
    from css_tpu_torch.ops.kernels import contrastive_kernels as ck

    smi = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    _build.build_all(_build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for source, log in _build.build_logs.items():
        print(f"--- nvcc {source}\n{log.strip()}", flush=True)

    kernels = kernel_phase(torch, ck)
    contrastive_phase(torch)
    launches = train_phase(torch, ck, args.steps, args.profile)

    source = "css_tpu_torch/csrc/" + ck.SOURCE
    tpu = "css_tpu/ops/pallas/contrastive_kernels.py"
    line = {"kernels": [
        dict(name="weighted_exp_softsum_fwd", route="cuda", source=source,
             replaces=f"{tpu}:35", launches=launches["weighted_exp_softsum_fwd"],
             **kernels["k1"]),
        dict(name="weighted_exp_softsum_bwd", route="cuda", source=source,
             replaces=f"{tpu}:60", launches=launches["weighted_exp_softsum_bwd"],
             **kernels["k2"]),
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

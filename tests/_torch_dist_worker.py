"""Rank functions for the port's multi-process tests, spawned through
``css_tpu_torch.parallel.spawn`` (one gloo rank per process, on the CPU).

They import torch and the port only, never JAX: the test process builds
every input (weights, per-rank batches and draws, replayed from the JAX key
chain) and hands them over in a file written by ``torch.save``; each rank
returns numpy arrays.
"""

import copy
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

from css_tpu_torch import parallel
from css_tpu_torch.cli import train_main
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.models.resnet import GroupedBatchNorm
from css_tpu_torch.ops.mixing import mix_batch
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import StepConfig, make_eval_step, make_train_step
from css_tpu_torch.utils.preempt import PreemptionGuard

THREADS = 2


def _np_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _run_case(case, rank):
    """One port state from ``case["state_dict"]``, stepped once per entry of
    ``case["steps"]`` on this rank's batch and draws; a snapshot after each."""
    model = build_model(case["num_classes"], case["output_dim"], case["backbone"],
                        remat=case["remat"], distributed=True)
    model.load_state_dict(case["state_dict"], strict=True)
    state = create_train_state(model, case["num_classes"], case["output_dim"], **case["opt"],
                               device="cpu")
    state.prototypes = case["prototypes"].clone()
    step = make_train_step(StepConfig(**case["cfg"], distributed=True))
    out = []
    for batches, draws, args in case["steps"]:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batches[rank].items()},
                              draws[rank], *args)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
                        model=_np_state(state.model), teacher=_np_state(state.teacher),
                        prototypes=state.prototypes.numpy().copy()))
    return out


def _run_eval(case, rank):
    model = build_model(case["num_classes"], case["output_dim"], case["backbone"],
                        distributed=True)
    model.load_state_dict(case["state_dict"], strict=True)
    image, label, valid = (torch.from_numpy(case[k][rank]) for k in ("image", "label", "valid"))
    c = case["num_classes"]
    mat = make_eval_step(model, c)(torch.zeros((c, c), dtype=torch.int64), image, label, valid)
    return parallel.all_reduce_sum(mat).numpy()


def _run_mix(case, rank):
    out = {}
    for name, (mode, partner, draws) in case["modes"].items():
        got = mix_batch(*(torch.from_numpy(case[k][rank]) for k in ("images", "labels", "confs")),
                        mode=mode, distributed=True, partner=partner, **draws[rank].as_kwargs())
        out[name] = [t.numpy() for t in got]
    return out


def _run_bn(case, rank):
    """Grouped cross-replica BN, train mode: output, input and parameter
    gradients of sum(y * cot) (parameter gradients averaged over ranks, as
    the step averages them) and the running stats."""
    bn = GroupedBatchNorm(case["x"][rank].shape[-1])
    bn.distributed = True
    with torch.no_grad():
        for name, value in case["init"].items():
            getattr(bn, name).copy_(torch.from_numpy(value))
    x = torch.from_numpy(case["x"][rank]).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(x, case["groups"])
    (y * torch.from_numpy(case["cot"][rank]).permute(0, 3, 1, 2)).sum().backward()
    parallel.mean_gradients(bn.parameters())
    return dict(y=y.detach().permute(0, 2, 3, 1).numpy(), gx=x.grad.permute(0, 2, 3, 1).numpy(),
                g_weight=bn.weight.grad.numpy(), g_bias=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(), running_var=bn.running_var.numpy())


def step_cases(device, path):
    """Every case of ``tests/test_torch_distributed_step.py`` on this rank."""
    torch.set_num_threads(THREADS)
    inputs = torch.load(path, weights_only=False)
    rank = dist.get_rank()
    out = {name: _run_case(case, rank) for name, case in inputs["steps"].items()}
    out["eval"] = _run_eval(inputs["eval"], rank)
    out["mix"] = _run_mix(inputs["mix"], rank)
    out["bn"] = _run_bn(inputs["bn"], rank)
    return out


def train_probed(device, strategy, args):
    """``train_main.train_on`` with its checkpoint saves, config dump and
    first step's incoming (step, prototypes) recorded."""
    torch.set_num_threads(THREADS)
    seen = {"saves": [], "dumps": 0, "start": None}
    save, dump, make = train_main.save_checkpoint, train_main.dump_config, \
        train_main.make_train_step

    def saving(path, *a, **kw):
        seen["saves"].append(os.path.basename(path))
        return save(path, *a, **kw)

    def dumping(*a, **kw):
        seen["dumps"] += 1
        return dump(*a, **kw)

    def making(cfg):
        step = make(cfg)

        def probed(state, *a):
            if seen["start"] is None:
                seen["start"] = (state.step, state.prototypes.numpy().copy())
            return step(state, *a)
        return probed

    train_main.save_checkpoint, train_main.dump_config = saving, dumping
    train_main.make_train_step = making
    try:
        result = train_main.train_on(device, strategy, copy.deepcopy(args))
    finally:
        train_main.save_checkpoint, train_main.dump_config = save, dump
        train_main.make_train_step = make
    return dict(result=result, rank=dist.get_rank(), **seen)


def sigterm_poll(device, check_every, steps, signal_rank, signal_at):
    """Polls a PreemptionGuard for ``steps`` steps; rank ``signal_rank``
    sends itself SIGTERM just before step ``signal_at``'s poll."""
    guard = PreemptionGuard(check_every, device).install()
    try:
        stops = []
        for si in range(steps):
            if dist.get_rank() == signal_rank and si == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
            stops.append(guard.should_stop(si))
        return stops
    finally:
        guard.uninstall()


def all_reduce_grad(device, values):
    """x = values[rank]; y = all_reduce_sum(x) * (rank + 1): the gradient
    of sum(y) reaching x."""
    rank = dist.get_rank()
    x = torch.tensor(values[rank], requires_grad=True)
    (parallel.all_reduce_sum(x) * (rank + 1)).sum().backward()
    return np.asarray(x.grad)


def _raise_oom(module, inputs, output):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")


def train_with_fault(device, args, fault_rank, out_dir):
    """``train_main.train_on`` ("ori"), with an OutOfMemoryError raised from
    the student's first forward on rank ``fault_rank``; a rank that ends
    with an error writes it to ``out_dir/error<rank>.txt`` and raises it."""
    rank = dist.get_rank()
    if rank == fault_rank:
        make = train_main.make_train_step

        def making(cfg):
            step = make(cfg)

            def faulty(state, *a):
                hook = state.model.register_forward_hook(_raise_oom)
                try:
                    return step(state, *a)
                finally:
                    hook.remove()
            return faulty
        train_main.make_train_step = making
    try:
        return train_main.train_on(device, "ori", args)
    except BaseException as e:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise


def rendezvous(index, env, out_dir):
    """Process ``index`` of a ``torch.multiprocessing.spawn``: joins the
    group through ``parallel.distributed_init`` on the CPU with ``env[index]``
    in its environment, all-reduces ``index + 1`` and writes
    ``out_dir/rank<rank>.txt``: its rank, the world size and the sum."""
    torch.set_num_threads(THREADS)
    os.environ.update(env[index])
    device = parallel.distributed_init(device_type="cpu")
    try:
        t = torch.tensor([index + 1.0], device=device)
        dist.all_reduce(t)
        with open(os.path.join(out_dir, f"rank{dist.get_rank()}.txt"), "w") as f:
            f.write(f"{dist.get_rank()} {dist.get_world_size()} {t.item():g}")
    finally:
        dist.destroy_process_group()

"""Data parallelism across processes, one per device (``torch.distributed``)."""

from css_tpu_torch.parallel.mesh import (all_reduce_sum, any_process, backend_for, broadcast_,
                                         distributed_init, expand_hostlist, init_from_env,
                                         is_initialized, launched_by_torchrun, mean_gradients,
                                         rank, rank_devices, spawn, world_size)

__all__ = ["all_reduce_sum", "any_process", "backend_for", "broadcast_", "distributed_init",
           "expand_hostlist", "init_from_env", "is_initialized", "launched_by_torchrun",
           "mean_gradients", "rank", "rank_devices", "spawn", "world_size"]

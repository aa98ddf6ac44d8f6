"""ray_tpu_torch.collective: collective groups across actors, tasks and
drivers over the object plane (port of ray_tpu/collective).

Analog of ray: python/ray/util/collective/collective.py (GroupManager,
init_collective_group, allreduce) with its gloo-style backend: ring
reduce-scatter/allgather for large tensors, a binomial tree for small
ones, async variants returning a wait()-able `CollectiveWork`, the packed
pytree broadcast of the RLHF weight sync, and the opt-in per-collective
phase tracer (`ray_tpu_torch.profiling.collective_trace`).  Device
collectives inside one program are torch.distributed's (parallel/).

The names below load `collective.py` (and torch) at first use, so the
rendezvous actor's process (`rendezvous.py`, standard library only),
which imports this package, never loads torch.
"""
__all__ = [
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "deregister_collective_group",
    "allreduce", "allgather", "reducescatter",
    "broadcast", "barrier", "send", "recv", "get_rank",
    "get_collective_group_size", "allreduce_async", "allgather_async",
    "reducescatter_async", "broadcast_async", "broadcast_pytree",
    "broadcast_pytree_async", "CollectiveWork",
]


def __getattr__(name):
    if name in __all__:
        from ray_tpu_torch.collective import collective

        return getattr(collective, name)
    raise AttributeError(name)

"""Population-evaluation dispatch: the mpi4py-rank replacement.

The reference distributes offspring across MPI ranks, each rank owning a
private ExaStencils workspace (reference optimization/program.py:285-310,
478-502; code_generation/exastencils.py:71-91).  Every evolved individual
is a *different program*, so the JAX equivalent is not vmap but pipelined
dispatch: a thread pool traces/compiles individuals concurrently on host
CPUs while the accelerator drains execution asynchronously (JAX dispatch
is async; compilation is the serial bottleneck the pool hides).

For multi-host scale-out the same interface can wrap `jax.distributed`
with a host-level scatter/allgather of (tree-string, fitness) pairs —
strings are the wire format, mirroring the reference's fitness-cache
allgather (program.py:498-502).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, List, Sequence


class ThreadPoolDispatcher:
    """Evaluate individuals concurrently; JAX-level thread safety is
    guaranteed because each evaluation jit-compiles a distinct function
    and device execution is serialized by the runtime."""

    def __init__(self, max_workers: int | None = None):
        if max_workers is None:
            max_workers = min(8, (os.cpu_count() or 4))
        self.max_workers = max_workers

    def map(self, fn: Callable, items: Sequence) -> List:
        if len(items) <= 1 or self.max_workers == 1:
            return [fn(item) for item in items]
        # Generous worker stacks: tracing deep cycle graphs overflows the
        # default thread stack (SIGSTKFLT, no traceback).
        previous = threading.stack_size()
        try:
            threading.stack_size(64 * 1024 * 1024)
        except (ValueError, RuntimeError):
            previous = None
        try:
            with concurrent.futures.ThreadPoolExecutor(self.max_workers) as pool:
                return list(pool.map(fn, items))
        finally:
            if previous is not None:
                try:
                    threading.stack_size(previous)
                except (ValueError, RuntimeError):
                    pass


class SerialDispatcher:
    def map(self, fn: Callable, items: Sequence) -> List:
        return [fn(item) for item in items]


class MultiHostDispatcher:
    """Round-robin split of the population across jax.distributed hosts.

    Each host evaluates its slice; fitnesses are exchanged via a host-level
    allgather on (canonical-string, fitness) pairs.  Requires
    jax.distributed.initialize() to have been called by the launcher.
    """

    # Fixed wire width: the allgathered row layout must be identical on
    # every host regardless of its slice (a host with an empty slice, or
    # one that only saw 1-objective fitnesses, must still send the same
    # shape).  Large enough for every fitness arity in the framework.
    MAX_FITNESS_WIDTH = 4

    def __init__(self, inner=None):
        import jax

        self.process_index = jax.process_index()
        self.process_count = jax.process_count()
        self.inner = inner or ThreadPoolDispatcher()

    def map(self, fn: Callable, items: Sequence) -> List:
        import numpy as np

        mine = [
            (i, item)
            for i, item in enumerate(items)
            if i % self.process_count == self.process_index
        ]
        local_results = self.inner.map(fn, [item for _, item in mine])
        if self.process_count == 1:
            return local_results
        # Exchange (index, arity, fitness...) rows via a global allgather
        # on a fixed-width float array (fitness tuples are small and
        # numeric) — the analog of the reference's cross-rank fitness
        # exchange (program.py:495-502).
        from jax.experimental import multihost_utils

        width = self.MAX_FITNESS_WIDTH
        rows = np.full((len(items), width + 2), np.nan)
        for (i, _), fit in zip(mine, local_results):
            fit = tuple(fit)
            rows[i, 0] = i
            rows[i, 1] = len(fit)
            rows[i, 2 : 2 + len(fit)] = fit
        gathered = np.asarray(multihost_utils.process_allgather(rows))
        results: List = [None] * len(items)
        for host_rows in gathered.reshape(-1, len(items), width + 2):
            for row in host_rows:
                if not np.isnan(row[0]):
                    idx = int(row[0])
                    arity = int(row[1])
                    results[idx] = tuple(row[2 : 2 + arity])
        return results

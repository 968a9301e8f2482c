"""Device timing helper shared by the measurement scripts.

JAX dispatch is asynchronous, so every timed region ends in
`block_until_ready`.  Per-cycle device time comes from fori-loop
differencing, which cancels the fixed dispatch and synchronisation cost.
"""

from __future__ import annotations


def per_cycle_time(step, u0, f, iters: int = 100, repeats: int = 5) -> float:
    """Per-cycle device seconds of ``step(u, f)`` via fori-loop
    differencing: (t(3K) − t(K)) / 2K."""
    import time

    import jax

    def k_loop(n):
        run = jax.jit(
            lambda u, f: jax.lax.fori_loop(0, n, lambda i, uu: step(uu, f), u)
        )
        jax.block_until_ready(run(u0, f))
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(u0, f))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = k_loop(iters)
    t3 = k_loop(3 * iters)
    return max((t3 - t1) / (2 * iters), 1e-9)

"""Tracing / profiling utilities (SURVEY §5.1).

The reference's observability was wall-clock accounting scraped from
subprocess stdout plus ExaStencils HTML build logs (reference
optimization/program.py:102-103,405-412; exastencils.py:449-457).  Here:

  * `trace(logdir)` — context manager around `jax.profiler` producing a
    TensorBoard-loadable XPlane trace of everything executed inside
    (device kernels, transfers, host callbacks).  A profiler that fails
    to start or stop raises.
  * `evaluation_report(generator)` — structured counters from a
    JaxProgramGenerator: compile/run seconds, cycle-VM hit rates, cache
    sizes, device failures — the per-generation numbers the EA logbook
    stream prints.
  * `bandwidth_utilization(expression, measured_seconds, device_kind)` —
    modeled HBM bytes per cycle application (models/roofline
    .estimate_traffic, an unfused upper bound) against the device's
    published peak bandwidth (utils/peaks.py).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(logdir: str):
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def evaluation_report(generator) -> dict:
    report = {
        "compile_time_s": round(generator.compile_time_total, 3),
        "run_time_s": round(generator.run_time_total, 3),
        "solver_cache_entries": len(generator._solver_cache),
        "device_failures": generator.device_failures,
    }
    report.update(generator.vm_stats())
    return report


def bandwidth_utilization(expression, measured_seconds: float,
                          device_kind: str) -> dict:
    from evostencils_tpu.models.roofline import PerformanceEvaluator
    from evostencils_tpu.utils.peaks import peaks_for

    peak = peaks_for(device_kind).hbm_bytes_per_s
    perf = PerformanceEvaluator(device_kind=device_kind)
    traffic = perf.estimate_traffic(expression)
    bw = traffic / max(measured_seconds, 1e-12)
    return {
        "modeled_bytes": int(traffic),
        "achieved_GBps": round(bw / 1e9, 1),
        "utilization_pct_upper_bound": round(100.0 * bw / peak, 1),
    }

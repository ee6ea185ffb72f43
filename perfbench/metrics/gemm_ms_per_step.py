"""Device time of the matrix-product kernels (by name: cuBLAS, CUTLASS,
nvjet) per decode step, from the trace of back-to-back graph replays."""

from perfbench import tracing


def read(run):
    t = run.trace and run.trace["decode"]
    if not t:
        return None
    us = tracing.matching_us(t["kernels_us"], tracing.GEMM_KEYS)
    return us / 1e3 / t["steps"] if us else None

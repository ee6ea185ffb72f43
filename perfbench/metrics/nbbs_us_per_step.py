"""Device time of kernel A (`nbbs_step_kernel`: the boundary claim and the
retirement free) per decode step, from the trace of back-to-back graph
replays."""

from perfbench import tracing


def read(run):
    t = run.trace and run.trace["decode"]
    if not t:
        return None
    us = tracing.matching_us(t["kernels_us"], tracing.NBBS_KEY)
    return us / t["steps"] if us else None

"""Seconds from the process's start to the window's: weights from the
seed, the KV pool, prefill warm-up, graph capture and the ramp to steady
state (host clock)."""


def read(run):
    return run.setup_s

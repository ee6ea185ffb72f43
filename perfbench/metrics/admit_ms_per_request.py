"""Host time of `JitServeEngine._admit` inside the window (kernel A's
claim, its sync, the B=1 prefill and the insert of each request) per
request admitted (host clock)."""


def read(run):
    w = run.window
    n = len(w.admitted())
    return w.admit_s * 1e3 / n if n else None

"""Share of the traced loop window (admissions included) in which no
operation ran on the card, from the profiler's device records."""


def read(run):
    t = run.trace and run.trace["loop"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""95th percentile, over every request due inside the window, of the time
from when it was due to the drain after the first chunk that followed its
admission (host clock).  A request that has no first token when the run
stops waiting (the cell's grace_s after the window) counts with the wait
up to then, and also as failed."""

from perfbench.stats import percentile


def read(run):
    vals = run.window.ttft_ms()
    return percentile(vals, 95) if vals else None

"""95th percentile, over every request that retired inside the window, of
the time from the drain after its first chunk to the drain that returned
it, over its tokens less one (host clock at drains, which wait for the
device).  A request's first token may precede the window (in the ramp):
a request of the MoE cell lives about as long as the window, so counting
only requests that both started and ended in it would leave a handful,
all short."""

from perfbench.stats import percentile


def read(run):
    vals = run.window.tpot_ms()
    return percentile(vals, 95) if vals else None

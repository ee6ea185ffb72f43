"""Kernel B's share of its roofline: the least time the card could take
for the live K/V rows, q, the outputs and the live block-table entries of
each launch (`costs.paged_attention_cost`, per layer and step, from the
lanes the traced replays started from) over the kernel's device time in
the trace."""

from perfbench import costs, tracing


def read(run):
    t = run.trace and run.trace["decode"]
    if not t:
        return None
    us = tracing.matching_us(t["kernels_us"], tracing.PAGED_ATTENTION_KEY)
    if not us:
        return None
    pt = run.cell["engine"]["page_tokens"]
    bound = 0.0
    for s in range(t["steps"]):
        ctx = [c + s + 1 for c, n_out, max_new, live in t["lanes"] if live and n_out + s < max_new]
        nbytes, flops = costs.paged_attention_cost(run.arch, ctx, pt)
        bound += costs.roofline_seconds(nbytes, flops) * run.arch["n_layers"]
    return 100.0 * bound / (us / 1e6)

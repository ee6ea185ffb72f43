"""Operations of the unpadded prompts prefilled in the traced loop (trace
A) over the device time of those prefills (the card's busy time inside
the device ranges of the `serve_prefill` spans: the kernels launched
from each prefill, and none of the host's time between them), as a
share of the card's bf16 peak."""

from perfbench import costs


def read(run):
    t = run.trace and run.trace["loop"]
    # every prefill of the traced iterations has its device range, or the
    # reading would set some prompts' operations against none of their time
    if not t or not t["prefill_busy_us"] or t["prefill_ranges"] != len(t["prefill_prompts"]):
        return None
    flops = sum(costs.prefill_flops(run.arch, n) for n in t["prefill_prompts"])
    return 100.0 * flops / (t["prefill_busy_us"] / 1e6) / costs.PEAK_BF16_FLOPS

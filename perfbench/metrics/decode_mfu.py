"""Model operations of the tokens decoded inside the window (every
layer's projections and MLP or top-k experts, the LM head, and attention
over each token's live context) over the device time of the window's
chunks (CUDA events), as a share of the card's bf16 peak."""

from perfbench import costs
from perfbench.stats import ctx_sum


def read(run):
    w = run.window
    if not w.chunk_ms:
        return None
    spans = w.token_spans()
    tokens = sum(b - a for _, a, b in spans)
    pairs = sum(ctx_sum(r.prompt_len, a, b) for r, a, b in spans)
    flops = costs.decode_flops(run.arch, tokens, pairs)
    return 100.0 * flops / (sum(w.chunk_ms) / 1e3) / costs.PEAK_BF16_FLOPS

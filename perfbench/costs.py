"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of a model token, a prompt and one paged-attention launch.

Every count is reckoned from the inputs a step actually had (the live
context of each lane, the unpadded prompt), never from what a kernel
reads or computes beyond them, so a share of a peak computed from these
can only err low.  The model's sizes come from the configuration file as
a plain dict (`arch` of `configs/<name>.json`).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _dims(arch: dict):
    D = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    return arch["d_model"], arch["n_heads"], arch["n_kv_heads"], D


def matmul_params_per_token(arch: dict, lm_head: bool = True) -> int:
    """Weights one token multiplies through: every layer's q/k/v/o
    projections, its MLP (or its top_k experts and the router), and the
    LM head.  The embedding is a gather and costs no operation."""
    d, Hq, Hkv, D = _dims(arch)
    attn = d * (2 * Hq * D + 2 * Hkv * D)
    if arch.get("n_experts"):
        ffn = 3 * d * arch["d_ff"] * arch["top_k"] + d * arch["n_experts"]
    else:
        ffn = 3 * d * arch["d_ff"]
    head = arch["vocab_size"] * d if lm_head else 0
    return arch["n_layers"] * (attn + ffn) + head


def attention_flops(arch: dict, pairs: int) -> int:
    """QK^T and PV over `pairs` (query, key) pairs summed over every
    layer: 2 products x 2 operations per multiply-add x Hq x D."""
    _, Hq, _, D = _dims(arch)
    return 4 * Hq * D * pairs * arch["n_layers"]


def decode_flops(arch: dict, tokens: int, ctx_sum: int) -> int:
    """Model operations of `tokens` decoded tokens whose attention
    contexts (the cache plus the token itself) sum to `ctx_sum`."""
    return 2 * matmul_params_per_token(arch) * tokens + attention_flops(arch, ctx_sum)


def prefill_flops(arch: dict, prompt_len: int) -> int:
    """Model operations of one unpadded prompt through every layer:
    the projections and MLP of each token and causal attention over
    prompt_len (prompt_len + 1) / 2 pairs.  The LM head of the last
    token only, which prefill computes and the engine discards, is not
    counted."""
    S = prompt_len
    return (2 * matmul_params_per_token(arch, lm_head=False) * S
            + attention_flops(arch, S * (S + 1) // 2))


def paged_attention_cost(arch: dict, ctx_lens, page_tokens: int, elem_bytes: int = 2):
    """(bytes, operations) of one paged-attention launch for live lanes
    with attention contexts `ctx_lens`: each live K/V row read once per
    kv head, q read and the output written once per live lane, the live
    block-table entries and each lane's length read once."""
    _, Hq, Hkv, D = _dims(arch)
    live = [c for c in ctx_lens if c > 0]
    ctx = sum(live)
    pages = sum(-(-c // page_tokens) for c in live)
    nbytes = (2 * ctx * Hkv * D * elem_bytes + 2 * len(live) * Hq * D * elem_bytes
              + 4 * pages + 4 * len(live))
    return nbytes, 4 * Hq * D * ctx


def kv_page_bytes(arch: dict, page_tokens: int, elem_bytes: int = 2) -> int:
    """Bytes one page of the K/V pool holds: K and V rows of every layer
    and kv head for `page_tokens` positions."""
    _, _, Hkv, D = _dims(arch)
    return 2 * arch["n_layers"] * Hkv * D * page_tokens * elem_bytes


def roofline_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)

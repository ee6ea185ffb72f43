"""The served-token comparison that decides a run's `correct`.

For each sampled request the reference runs once over its prompt and its
served tokens (the last one excepted) and gives, at every position where
the engine served a token, the logits of the next token.  A served
token's gap is how far its reference logit lies below the reference's
best, in units of the standard deviation of that position's reference
logits (random weights set the logits' scale; the unit keeps a limit
meaningful across widths).  A greedy engine that computes what the
reference computes serves the best token or one within rounding of it.

The control's gap is the same measure for the token that the control
(the reference in fp8, `model.py`) puts first at each position.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(best - ref[chosen]) / std(ref) per row; ref [n, V], chosen [n]."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, chosen.long()[:, None])[:, 0]
    return (best - got) / ref.std(dim=-1)


def pick(requests: list, k: int, seed: int) -> list:
    """`k` of the finished requests (dicts with "prompt", "served"), drawn
    from the seed, always with the longest (prompt plus served) in it."""
    if not requests:
        return []
    order = sorted(range(len(requests)),
                   key=lambda i: (-(len(requests[i]["prompt"]) + len(requests[i]["served"])), i))
    rest = order[1:]
    rng = np.random.default_rng(seed)
    take = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [requests[order[0]]] + [requests[rest[int(j)]] for j in sorted(take)]


def gap_stats(g: torch.Tensor) -> dict:
    """The numbers compared, from every served token's gap: the widest,
    the mean, and the share of tokens that are not the reference's best."""
    return {"served_gap_sd": float(g.max()), "served_gap_sd_mean": float(g.mean()),
            "served_not_best_share": float((g > 0).float().mean())}


def served_gap(arch: dict, params: dict, sample: list, device, control: bool = False):
    """(`gap_stats` of the served tokens with "compared", their count;
    the same of the control's first tokens, or None) over `sample`."""
    got, ctrl = [], []
    for r in sample:
        prompt = torch.as_tensor(np.asarray(r["prompt"], np.int64), device=device)
        served = torch.as_tensor(np.asarray(r["served"], np.int64), device=device)
        if served.numel() == 0:
            continue
        seq = torch.cat([prompt, served[:-1]])
        first = prompt.numel() - 1
        ref = model.logits(arch, params, seq, first)
        got.append(gaps(ref, served))
        if control:
            low = model.logits(arch, params, seq, first, precision="fp8")
            ctrl.append(gaps(ref, low.argmax(-1)))
            del low
        del ref
    if not got:
        return {"served_gap_sd": 0.0, "served_gap_sd_mean": 0.0,
                "served_not_best_share": 0.0, "compared": 0}, None
    out = dict(gap_stats(torch.cat(got)), compared=int(sum(g.numel() for g in got)))
    return out, (gap_stats(torch.cat(ctrl)) if control else None)

"""Shared model layers: norms, RoPE, MLPs, embeddings, cross-entropy.

Counterpart of `repro/models/layers.py`.  Plain functions on tensors;
`init_*` take an explicit `torch.Generator` and device and return
float32 parameters (the generator's numbers differ from `jax.random`'s,
so parity tests move the JAX parameters over with
`models.transformer.params_from_numpy`).

The JAX layers cast each weight to the compute dtype at every matmul
(`w.astype(dtype)`); the port's serving paths keep matmul weights in the
working dtype from the start, which gives the same numbers, and training
casts its float32 masters once per layer body
(`models.transformer.cast_matmul`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.sharding import like, sum_partials

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterization keeps init at identity.
    return (x * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, device="cuda") -> torch.Tensor:
    return torch.zeros(d, dtype=F32, device=device)


def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    angles = positions[..., None].float() * freqs           # [..., S, D/2]
    angles = angles[..., None, :]                           # over heads
    sin, cos = like(torch.sin(angles), x), like(torch.cos(angles), x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_swiglu(gen: torch.Generator, d: int, ff: int, device="cuda") -> dict:
    s_in, s_out = d ** -0.5, ff ** -0.5
    return {
        "w_gate": _normal(gen, (d, ff), device) * s_in,
        "w_in": _normal(gen, (d, ff), device) * s_in,
        "w_out": _normal(gen, (ff, d), device) * s_out,
    }


def apply_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x in the compute dtype; the weights are in it already."""
    g = x @ p["w_gate"]
    h = x @ p["w_in"]
    act = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    return sum_partials(act @ p["w_out"])


def init_gelu_mlp(gen: torch.Generator, d: int, ff: int, device="cuda") -> dict:
    return {
        "w_in": _normal(gen, (d, ff), device) * d ** -0.5,
        "w_out": _normal(gen, (ff, d), device) * ff ** -0.5,
    }


def apply_gelu_mlp(p: dict, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """`jax.nn.gelu`'s default is the tanh approximation."""
    h = x @ p["w_in"].to(dtype)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(dtype)
    return h @ p["w_out"].to(dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, device="cuda"):
    return _normal(gen, (vocab, d), device) * (d ** -0.5)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype=torch.bfloat16,
          scale: bool = False) -> torch.Tensor:
    x = _local_embed(table, tokens) if isinstance(table, DTensor) else table[tokens]
    x = x.to(dtype)
    if scale:
        # the scale rounded to `dtype` first, as JAX's; a Python number,
        # so that the product works on DTensors too
        x = x * float(torch.tensor(table.shape[1] ** 0.5, dtype=dtype))
    return x


def _local_embed(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """`table[tokens]` for a sharded table, on local tensors: each rank
    gathers the whole table and looks up its own tokens; the gradient of
    the gathered table is a partial sum over the mesh dims that split
    the batch.  A local region: DTensor (torch 2.11) fails to place the
    lookup's backward (an index_put into the replicated table)."""
    mesh = table.device_mesh
    batch = [isinstance(tokens, DTensor) and p == Shard(0)
             for p in (tokens.placements if isinstance(tokens, DTensor)
                       else [Replicate()] * mesh.ndim)]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if b else Replicate() for b in batch])
    local = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(whole[local], mesh,
                              [Shard(0) if b else Replicate() for b in batch],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def logits(x: torch.Tensor, table: torch.Tensor,
           softcap: Optional[float] = None) -> torch.Tensor:
    """LM head (tied or untied table [V, d]); returns fp32 logits."""
    out = x.float() @ table.float().T
    if softcap:
        out = softcap * torch.tanh(out / softcap)
    return out


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with an optional z-loss regularizer."""
    lse = torch.logsumexp(lg, dim=-1)
    if isinstance(lg, DTensor):
        # DTensor's gather over a sharded vocab dim fails to reduce its
        # masked partial; a one-hot product picks the same value exactly
        vocab = like(torch.arange(lg.shape[-1], device=lg.device), lg)
        ll = (lg * (labels.long()[..., None] == vocab)).sum(-1)
    else:
        ll = lg.gather(-1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=F32, device=device)

"""Plain reference of the served model: one sequence, every position,
written from the architecture's equations in float32 (TF32 off).

Pre-norm decoder: RMSNorm with a (1 + scale) parameterisation, rotary
position embedding over the whole head (the two halves of each head
rotated together), causal grouped-query attention scaled by D^-1/2, a
SwiGLU MLP, or a mixture of SwiGLU experts whose router takes a softmax
over the experts, keeps the top_k (the lower index first among equal
probabilities) and renormalises their gates to sum to one; a final
RMSNorm and an untied LM head.  The weights are the harness's inputs
(`weights.py`), read as they are and widened to float32 here.

`precision="fp8"` is the control: every matmul that the configuration
runs in bf16 (q/k/v/o projections, MLP and expert FFNs) takes both its
operands rounded to float8 e4m3, the weight with a scale per output
column and the activation with a scale per token; the router, the LM
head and attention itself stay as in the float32 reference.

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along `dim`."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [T, a] @ w [a, b], both float32."""
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.to(F32))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D] at positions 0..T-1."""
    T, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=F32, device=x.device) / D)
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * inv      # [T, D/2]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal attention, q [T, Hq, D], k/v [T, Hkv, D] -> [T, Hq * D]."""
    T, Hq, D = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / D ** 0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(T, Hq * D)


def swiglu(x, w_gate, w_in, w_out, precision: str) -> torch.Tensor:
    g = _mm(x, w_gate.to(F32), precision)
    h = _mm(x, w_in.to(F32), precision)
    return _mm(torch.nn.functional.silu(g) * h, w_out.to(F32), precision)


def experts(x, moe: dict, li: int, top_k: int, precision: str) -> torch.Tensor:
    probs = torch.softmax(x @ moe["router"][li].to(F32), dim=-1)       # [T, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    gates = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(probs.shape[1]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], moe["w_gate"][li, e], moe["w_in"][li, e],
                         moe["w_out"][li, e], precision)
            y.index_add_(0, tok, out * gates[tok, slot][:, None])
    return y


def logits(arch: dict, params: dict, tokens: torch.Tensor, first: int,
           precision: str = "fp32") -> torch.Tensor:
    """float32 logits [T - first, V] at positions first..T-1 of `tokens`
    (int64 [T]): the distributions of tokens first+1..T."""
    d, Hq, Hkv = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    D = arch.get("head_dim") or d // Hq
    eps, theta = arch.get("norm_eps", 1e-6), arch.get("rope_theta", 10000.0)
    lay = params["layers"]
    T = tokens.shape[0]
    with no_tf32():
        x = params["embed"][tokens].to(F32)
        for li in range(arch["n_layers"]):
            at = lay["attn"]
            h = rms_norm(x, lay["ln1"][li], eps)
            q = _mm(h, at["wq"][li].to(F32), precision).reshape(T, Hq, D)
            k = _mm(h, at["wk"][li].to(F32), precision).reshape(T, Hkv, D)
            v = _mm(h, at["wv"][li].to(F32), precision).reshape(T, Hkv, D)
            o = attention(rope(q, theta), rope(k, theta), v)
            x = x + _mm(o, at["wo"][li].to(F32), precision)
            h = rms_norm(x, lay["ln2"][li], eps)
            if arch.get("n_experts"):
                x = x + experts(h, lay["moe"], li, arch["top_k"], precision)
            else:
                m = lay["mlp"]
                x = x + swiglu(h, m["w_gate"][li], m["w_in"][li], m["w_out"][li], precision)
        h = rms_norm(x[first:], params["final_norm"], eps)
        head = params["embed"] if arch.get("tie_embeddings", True) else params["lm_head"]
        return h @ head.to(F32).T

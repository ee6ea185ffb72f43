"""RWKV6 "Finch" block: attention-free mixer with data-dependent decay.

Counterpart of `repro/models/rwkv.py`.  Time-mix (per head, head size P):

    w_t = exp(-exp(w0 + lora_w(x~_t)))          data-dependent decay [d]
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t       state [P, P] per head
    y_t = r_t . (S_{t-1} + diag(u (.) k_t) v_t)  (u = per-channel bonus)

then per-head group norm, a silu gate and an output projection;
channel-mix is the squared-relu two-layer MLP with token shift.  The
wkv recurrence is a Python loop over time (JAX's `lax.scan`) on the
float32 [B, H, P, P] state.  Decode carries {token-shift xs, wkv state},
O(1) per token.

Precision follows the JAX block: the projections (`w_r`, `w_k`, `w_v`,
`w_g`, `w_o`, `cm_k`, `cm_v`, `cm_r`) are in the compute dtype (the port
keeps them there, `models.transformer._MATMUL`); the token-shift mixes
cast their float32 weights to it at use; the decay LoRA runs in float32.
The state (`tm_x`, `cm_x`, `wkv`) is float32 whatever the dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import _normal, rms_norm
from repro_torch.models.sharding import like, on_rows_and_heads, sum_partials

F32 = torch.float32


def init_rwkv6(gen: torch.Generator, d: int, d_ff: int, head_dim: int, lora: int = 64,
               device="cuda") -> dict:
    s = d ** -0.5
    full = lambda v: torch.full((d,), v, dtype=F32, device=device)  # noqa: E731
    return {
        # token-shift interpolation weights per stream
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_g": full(0.5),
        "mu_w": full(0.5),
        "w_r": _normal(gen, (d, d), device) * s,
        "w_k": _normal(gen, (d, d), device) * s,
        "w_v": _normal(gen, (d, d), device) * s,
        "w_g": _normal(gen, (d, d), device) * s,
        "w_o": _normal(gen, (d, d), device) * s,
        # data-dependent decay LoRA
        "w0": full(-6.0),
        "wl_a": _normal(gen, (d, lora), device) * s,
        "wl_b": _normal(gen, (lora, d), device) * lora ** -0.5,
        "u": _normal(gen, (d,), device) * 0.1,
        "ln_scale": full(1.0),
        # channel mix
        "cm_mu_k": full(0.5), "cm_mu_r": full(0.5),
        "cm_k": _normal(gen, (d, d_ff), device) * s,
        "cm_v": _normal(gen, (d_ff, d), device) * d_ff ** -0.5,
        "cm_r": _normal(gen, (d, d), device) * s,
        # pre-mix norms (scale-only, as in the rest of the zoo)
        "ln1": full(0.0), "ln2": full(0.0),
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: previous token per position; x_prev seeds position 0."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head layer norm over [B, T, H*P]: population variance (JAX's
    `var`, ddof 0), eps 1e-5."""
    B, T, d = y.shape
    yh = y.reshape(B, T, H, d // H).float()
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mean) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, T, d) * scale).to(y.dtype)


def _wkv_scan(r, k, v, w, u, head_dim: int, state: torch.Tensor):
    """r, k, v, w: [B, T, d] float32 (w the per-step decay in (0, 1));
    u: [d]; state [B, H, P, P].  Returns (y [B, T, d], final state)."""
    B, T, d = r.shape
    H, P = d // head_dim, head_dim
    rs, ks, vs, ws = (a.reshape(B, T, H, P) for a in (r, k, v, w))
    uh = u.reshape(H, P)[None, :, :, None]
    S = state
    ys = []
    for t in range(T):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]        # [B, H, P, P]
        ys.append((rs[:, t, :, None, :] @ (S + uh * kv))[:, :, 0])
        S = ws[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).reshape(B, T, d), S


def apply_rwkv6(p: dict, x: torch.Tensor, *, head_dim: int,
                state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Full block (time-mix + channel-mix).  x: [B, S, d].

    `state` (decode / chunk streaming) carries tm_x, cm_x: [B, d] the
    last token's shifts and wkv: [B, H, P, P].  Returns (out, new
    state); the new state's tensors are fresh, so the caller may copy
    them over `state` in place."""
    B, S, d = x.shape
    dtype = x.dtype
    H = d // head_dim
    if state is None:
        state = {k: like(v, x) for k, v in
                 init_rwkv6_state(B, d, head_dim, device=x.device).items()}

    residual = x
    x = rms_norm(x, p["ln1"])
    x_in = x

    # ---- time mix -----------------------------------------------------
    xprev = _shift(x, state["tm_x"].to(dtype))

    def mix(mu):
        return x + (xprev - x) * mu.to(dtype)

    xr, xk, xv, xg, xw = (mix(p[k]) for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = xg @ p["w_g"]
    # float32 LoRA (JAX promotes a bf16 weight to float32 in the product)
    dd = torch.tanh(xw.float() @ p["wl_a"].float()) @ p["wl_b"].float()
    w = torch.exp(-torch.exp(p["w0"][None, None] + dd))      # [B, S, d] in (0, 1)

    scan = (r.float(), k.float(), v.float(), w, p["u"], state["wkv"])
    if isinstance(w, DTensor):
        # a local region: the scan's per-head products flatten a
        # head-sharded batch, which DTensor (torch 2.11) refuses
        y, wkv = on_rows_and_heads(lambda *a: _wkv_scan(*a[:5], head_dim, a[5]), scan,
                                   [(0, 2)] * 4 + [(None, 0), (0, 1)], [(0, 2), (0, 1)], H)
    else:
        y, wkv = _wkv_scan(*scan[:5], head_dim, scan[5])
    y = _group_norm(y.to(dtype), p["ln_scale"], H)
    y = sum_partials((y * F.silu(g.float()).to(dtype)) @ p["w_o"])
    residual = residual + y

    # ---- channel mix ---------------------------------------------------
    xc = rms_norm(residual, p["ln2"])
    xprev_c = _shift(xc, state["cm_x"].to(dtype))
    xk_c = xc + (xprev_c - xc) * p["cm_mu_k"].to(dtype)
    xr_c = xc + (xprev_c - xc) * p["cm_mu_r"].to(dtype)
    kk = torch.square(F.relu((xk_c @ p["cm_k"]).float())).to(dtype)
    rr = torch.sigmoid((xr_c @ p["cm_r"]).float())
    out = residual + sum_partials(kk @ p["cm_v"]) * rr.to(dtype)

    new_state = {
        # the next chunk's shifts: the last token of the time-mix input
        # and of the channel-mix input
        "tm_x": x_in[:, -1].float(),
        "cm_x": xc[:, -1].float(),
        "wkv": wkv,
    }
    return out, new_state


def init_rwkv6_state(batch: int, d: int, head_dim: int, device="cuda") -> dict:
    H = d // head_dim
    return {
        "tm_x": torch.zeros((batch, d), dtype=F32, device=device),
        "cm_x": torch.zeros((batch, d), dtype=F32, device=device),
        "wkv": torch.zeros((batch, H, head_dim, head_dim), dtype=F32, device=device),
    }

"""Mamba2 block (chunked SSD), zamba2's backbone mixer.

Counterpart of `repro/models/ssm.py`.  Scalar-per-head A, shared B/C
across heads (ngroups=1):

    h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t (x) x_t        (state [H, N, P])
    y_t = C_t . h_t + D x_t

Training and prefill loop over sequence chunks (JAX's `lax.scan` is a
Python loop here): inside a chunk the quadratic form gives the
intra-chunk outputs and the carried state the inter-chunk part, with
[B, L, L, H] transients (L the chunk length).  Decode is the O(1)
recurrence on the carried state.

Precision follows the JAX block: `w_in` / `w_out` are in the compute
dtype (the port keeps them there, `models.transformer._MATMUL`); prefill's
conv multiplies its inputs by the float32 kernel, so it runs in float32
by type promotion, while decode casts the kernel and bias to the
compute dtype and sums there.  The scan and the SSM state are float32.
The gated norm uses `rms_norm`'s default eps (1e-6), not the config's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import _normal, rms_norm
from repro_torch.models.sharding import like, on_rows_and_heads, sum_partials

F32 = torch.float32


def _linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """`jnp.linspace(start, stop, n)` in float32, in JAX's arithmetic
    (start (1 - t) + stop t, then the endpoint)."""
    t = torch.arange(n - 1, dtype=F32, device=device) / (n - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=F32, device=device)])


def init_mamba2(gen: torch.Generator, d: int, d_inner: int, d_state: int,
                head_dim: int, d_conv: int = 4, device="cuda") -> dict:
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return {
        # in_proj -> [z, x, B, C, dt]
        "w_in": _normal(gen, (d, 2 * d_inner + 2 * d_state + n_heads), device) * d ** -0.5,
        "conv_w": _normal(gen, (d_conv, conv_dim), device) * 0.2,
        "conv_b": torch.zeros(conv_dim, dtype=F32, device=device),
        "A_log": torch.log(_linspace(1.0, float(n_heads), n_heads, device)),
        "D": torch.ones(n_heads, dtype=F32, device=device),
        "dt_bias": torch.zeros(n_heads, dtype=F32, device=device),
        "norm": torch.zeros(d_inner, dtype=F32, device=device),
        "w_out": _normal(gen, (d_inner, d), device) * d_inner ** -0.5,
    }


def _split_proj(p: dict, x: torch.Tensor, d_inner: int, d_state: int, n_heads: int):
    """z, x, B, C, dt of the input projection (`torch.split` takes the
    sizes where `jnp.split` takes the split points)."""
    return torch.split(x @ p["w_in"], [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)


def _pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, S, ...] with `n` rows of zeros in front of dim 1: a `cat`,
    since DTensor (torch 2.11) gives `F.pad`'s output malformed
    placements."""
    zeros = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    return torch.cat([like(zeros, x), x], dim=1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [K, C]."""
    K, S = w.shape[0], xBC.shape[1]
    xp = _pad_front(xBC, K - 1)
    out = sum(xp[:, i : i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu((out + b[None, None, :]).float()).to(xBC.dtype)


def _chunk_step(Hst, la_c, xd_c, B_c, C_c):
    """One chunk of the SSD scan: (state [B, H, N, P], la [B, L, H],
    xd [B, L, H, P], B, C [B, L, N]) -> (new state, y [B, L, H, P])."""
    L = la_c.shape[1]
    cums = torch.cumsum(la_c, dim=1)                           # [B, L, H]
    total = cums[:, -1]                                        # [B, H]
    # inter-chunk: y_i += C_i . (decay_i * H)
    yin = torch.einsum("bln,bhnp->blhp", C_c, Hst) * torch.exp(cums)[..., None]
    # intra-chunk quadratic form; the mask goes inside the exp: the i<j
    # exponents are positive, overflow to inf, and inf * 0 is NaN
    cb = torch.einsum("bin,bjn->bij", C_c, B_c)                # [B, L, L]
    idx = torch.arange(L, device=la_c.device)
    mask = like(idx[:, None] >= idx[None, :], la_c)
    diff = cums[:, :, None, :] - cums[:, None, :, :]           # [B, i, j, H]
    dec = torch.exp(torch.where(mask[None, :, :, None], diff, -torch.inf))
    w = cb[..., None] * dec
    yintra = torch.einsum("bijh,bjhp->bihp", w, xd_c)
    decay_j = torch.exp(total[:, None, :] - cums)              # [B, L, H]
    S_c = torch.einsum("bjh,bjn,bjhp->bhnp", decay_j, B_c, xd_c)
    H_new = torch.exp(total)[..., None, None] * Hst + S_c
    return H_new, yin + yintra


def _ssd_scan(la, xd, Bf, Cf, L: int):
    """The chunked SSD scan from a zero state: (la [B, S, H], xd [B, S, H,
    P], B, C [B, S, N]) -> (final state [B, H, N, P], y [B, S, H, P]).
    Padded steps add no input (xd = 0) and decay by exp(0) = 1, so the
    final state is the state at position S - 1 exactly."""
    Bsz, S, H = la.shape
    pad = (-S) % L
    if pad:
        la = F.pad(la, (0, 0, 0, pad))
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    Hst = torch.zeros((Bsz, H, Bf.shape[-1], xd.shape[-1]), dtype=F32, device=la.device)
    ys = []
    for c in range(0, S + pad, L):
        Hst, y_c = _chunk_step(Hst, la[:, c : c + L], xd[:, c : c + L], Bf[:, c : c + L],
                               Cf[:, c : c + L])
        ys.append(y_c)
    return Hst, torch.cat(ys, dim=1)[:, :S]


def _ssm_step(ssm, a, dt, Bf, Cf, xh, D):
    """One step of the recurrence: (state [B, H, N, P], decay a and dt
    [B, H], B, C [B, N], x [B, H, P], D [H]) -> (new state, y [B, H, P])."""
    hs = ssm * a[..., None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, Bf, xh)
    return hs, torch.einsum("bn,bhnp->bhp", Cf, hs) + xh * D[None, :, None]


def apply_mamba2(p: dict, x: torch.Tensor, *, d_inner: int, d_state: int, head_dim: int,
                 chunk: int = 128, return_state: bool = False):
    """x: [B, S, d] -> [B, S, d] (training / prefill path).

    With return_state=True also returns the decode state {"ssm": final
    SSM state [B, H, N, P] float32, "conv": the last d_conv - 1 raw conv
    inputs [B, d_conv - 1, conv_dim]}, so prefill hands decode an exact
    continuation point."""
    Bsz, S, _ = x.shape
    dtype = x.dtype
    H = d_inner // head_dim
    P = head_dim
    z, xs, Bc, Cc, dt = _split_proj(p, x, d_inner, d_state, H)
    xBC_raw = torch.cat([xs, Bc, Cc], dim=-1)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs, Bc, Cc = torch.split(xBC, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                # [B, S, H]
    A = -torch.exp(p["A_log"])                                 # [H], negative
    la = dt * A                                                # log decay per step
    xh = xs.reshape(Bsz, S, H, P).float()
    xd = xh * dt[..., None]                                    # dt-scaled input
    L = min(chunk, S)
    if isinstance(xd, DTensor):
        # a local region: the scan's einsums flatten head-sharded
        # operands, which DTensor (torch 2.11) refuses
        Hst, y = on_rows_and_heads(lambda *a: _ssd_scan(*a, L),
                                   (la, xd, Bc.float(), Cc.float()),
                                   [(0, 2), (0, 2), (0, None), (0, None)], [(0, 1), (0, 2)], H)
    else:
        Hst, y = _ssd_scan(la, xd, Bc.float(), Cc.float(), L)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(dtype)
    y = rms_norm(y * F.silu(z.float()).to(dtype), p["norm"])
    out = sum_partials(y @ p["w_out"])
    if not return_state:
        return out
    K = p["conv_w"].shape[0]
    tail = xBC_raw[:, max(S - (K - 1), 0):]
    if S < K - 1:
        tail = _pad_front(tail, K - 1 - S)
    return out, {"ssm": Hst, "conv": tail}


def init_mamba2_state(batch: int, d_inner: int, d_state: int, head_dim: int,
                      d_conv: int = 4, dtype=torch.bfloat16, device="cuda") -> dict:
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return {
        "ssm": torch.zeros((batch, H, d_state, head_dim), dtype=F32, device=device),
        "conv": torch.zeros((batch, d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def apply_mamba2_decode(p: dict, x: torch.Tensor, state: dict, *, d_inner: int,
                        d_state: int, head_dim: int) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: [B, 1, d] -> (out [B, 1, d], new state).
    The new state's tensors are fresh: the caller may copy them over
    `state` in place."""
    Bsz = x.shape[0]
    dtype = x.dtype
    H = d_inner // head_dim
    P = head_dim
    z, xs, Bc, Cc, dt = _split_proj(p, x, d_inner, d_state, H)
    xBC = torch.cat([xs, Bc, Cc], dim=-1)                      # [B, 1, conv_dim]
    conv_buf = torch.cat([state["conv"].to(dtype), xBC], dim=1)
    out = (conv_buf * p["conv_w"].to(dtype)[None]).sum(1) + p["conv_b"].to(dtype)
    xBC_t = F.silu(out.float()).to(dtype)                      # [B, conv_dim]
    new_conv = conv_buf[:, 1:]
    xs, Bc, Cc = torch.split(xBC_t, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])           # [B, H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                      # [B, H]
    xh = xs.reshape(Bsz, H, P).float()
    step = (state["ssm"], a, dt, Bc.float(), Cc.float(), xh, p["D"])
    if isinstance(xh, DTensor):
        # a local region, as the scan of `apply_mamba2`
        hs, y = on_rows_and_heads(_ssm_step, step, [(0, 1)] * 3 + [(0, None)] * 2
                                  + [(0, 1), (None, 0)], [(0, 1), (0, 1)], H)
    else:
        hs, y = _ssm_step(*step)
    y = y.reshape(Bsz, 1, d_inner).to(dtype)
    y = rms_norm(y * F.silu(z.float()).to(dtype), p["norm"])
    return sum_partials(y @ p["w_out"]), {"ssm": hs, "conv": new_conv}

"""Mamba2 (SSD) block, training path (port of `repro.nn.ssm`): zamba2's
backbone.

  h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t ⊗ x_t)
  y_t = C_t · h_t + D * x_t

with a causal depthwise conv front-end and a gated RMSNorm on the output.
The sequence runs as JAX's chunked SSD: within a chunk an attention-like
product under the decay mask, across chunks a recurrence over the chunk
states.  JAX combines those states with `lax.associative_scan` (a tree);
the port folds them in order, so the carries round differently (f32
tolerance, not bits).  JAX has no Pallas kernel here; this is plain
PyTorch.  Serving carries a state (`mamba2`): the prefill returns the
SSD's final state and each conv's last K - 1 inputs, and a one-token
decode step (S == 1 with a state) updates the state recurrently
(`init_mamba2_cache` for an empty one).

Leaves, as JAX's `init_mamba2`: w_z, w_x (d, di), w_B, w_C (d, N), w_dt
(d, H), conv_x (K, di), conv_bc (K, 2N), conv_b_x (di,), conv_b_bc (2N,),
A_log, D, dt_bias (H,), norm_scale (di,), w_out (di, d).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.common import stack_trips, trips
from .config import ModelConfig

__all__ = ["leaf_shapes", "causal_conv", "ssd_chunked", "apply_mamba2",
           "mamba2", "init_mamba2_cache", "softplus"]


def leaf_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of one Mamba2 block's leaves (JAX `init_mamba2`)."""
    d, di, ns, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.conv_width)
    return {"w_z": (d, di), "w_x": (d, di), "w_B": (d, ns), "w_C": (d, ns),
            "w_dt": (d, H), "conv_x": (K, di), "conv_bc": (K, 2 * ns),
            "conv_b_x": (di,), "conv_b_bc": (2 * ns,), "A_log": (H,),
            "D": (H,), "dt_bias": (H,), "norm_scale": (di,),
            "w_out": (di, d)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, as JAX writes it (`logaddexp(x, 0)`): max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv (JAX `_causal_conv` without a state): u (B, S,
    C), w (K, C), b (C,); zeros pad the K - 1 positions before the
    sequence, the K taps summed from 0 in order, then + b."""
    return _causal_conv(u, w, b)[0]


def _causal_conv(u, w, b, state=None):
    """JAX `_causal_conv`: (out, the last K - 1 rows of the extended input
    in u's dtype); `state` (B, K - 1, C), cast to u's dtype, stands in for
    the zero padding."""
    K, S = w.shape[0], u.shape[1]
    u_ext = (F.pad(u, (0, 0, K - 1, 0)) if state is None
             else torch.cat([state.to(u.dtype), u], dim=1))
    out = sum(u_ext[:, i:i + S] * w[i] for i in range(K))
    return out + b, u_ext[:, S:].clone()     # not a view of all of u_ext


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """The chunked SSD scan (JAX `_ssd_chunked`), f32.
    x (b, S, H, hd), dt (b, S, H), A (H,) negative, B, C (b, S, N) ->
    (y (b, S, H, hd), the final state (b, H, N, hd)).

    JAX writes the products as three multi-operand einsums; the port
    writes each as pairwise steps whose intermediates keep at most five
    axes (a six-axis (b, n, i, j, h, d) product would take 1.34 GB a
    layer at zamba2's width):
      y_local  (cb (b,n,i,j) * Lw (b,n,i,j,h)) over j against
               (x * dt) (b,n,j,h,d);
      states   B (b,n,j,k) over j against x * (wdecay * dt) (b,n,j,h,d);
      y_carry  (C (b,n,i,k) over k against carry_in (b,n,h,k,d)) *
               exp(seg) (b,n,i,h)."""
    b, S, H, hd = x.shape
    N = B.shape[-1]
    nc = S // chunk
    xc = x.reshape(b, nc, chunk, H, hd)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = B.reshape(b, nc, chunk, N)
    Cc = C.reshape(b, nc, chunk, N)

    la = dtc * A                                      # log decay (<= 0)
    seg = torch.cumsum(la, dim=2)                     # (b,nc,chunk,H)
    total = seg[:, :, -1]                             # (b,nc,H)

    dmat = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # (b,nc,i,j,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    dmat = torch.where(causal[None, None, :, :, None], dmat, -torch.inf)
    Lw = torch.exp(dmat)
    cb = torch.einsum("bnik,bnjk->bnij", Cc, Bc)
    xdt = xc * dtc[..., None]                         # (b,nc,j,H,hd)
    y_local = torch.einsum("bnijh,bnjhd->bnihd", cb[..., None] * Lw, xdt)

    wdecay = torch.exp(total[:, :, None, :] - seg)    # (b,nc,chunk,H)
    xw = xc * (wdecay * dtc)[..., None]
    states = torch.einsum("bnjk,bnjhd->bnhkd", Bc, xw)    # (b,nc,H,N,hd)

    # carry_n = exp(total_n) carry_{n-1} + states_n from carry_{-1} = 0,
    # folded in order (over `common.trips`); chunk n reads carry_{n-1}
    decay = torch.exp(total)                          # (b,nc,H)
    carry, carry_in = torch.zeros_like(states[:, 0]), []
    for n in trips(nc, x.device):
        carry_in.append(carry)
        carry = states[:, n] + decay[:, n, :, None, None] * carry
    carry_in = stack_trips(carry_in, nc, dim=1)       # (b,nc,H,N,hd)
    y_carry = torch.einsum("bnik,bnhkd->bnihd", Cc, carry_in) \
        * torch.exp(seg)[..., None]
    return (y_local + y_carry).reshape(b, S, H, hd), carry


def apply_mamba2(p, x: torch.Tensor, cfg: ModelConfig, chunk: int = 64
                 ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), the training path of JAX `apply_mamba2`
    (`mamba2` from the zero state, its output alone)."""
    return mamba2(p, x, cfg, chunk=chunk)[0]


def mamba2(p, x: torch.Tensor, cfg: ModelConfig, *, ssm_state=None,
           conv_state=None, chunk: int = 64):
    """JAX `apply_mamba2`: x (B, S, d) -> (out (B, S, d), (ssm (B, H, N,
    hd) f32, (conv_x (B, K-1, di), conv_bc (B, K-1, 2N)))).  Projections
    in the compute dtype, dt = softplus(x w_dt + dt_bias) and A =
    -exp(A_log) in f32, the causal convs (continuing `conv_state`'s rows
    when given) and silu; then with S == 1 and an `ssm_state` one
    recurrent step h = exp(dt A) h + dt (B ⊗ x), y = C · h in f32, else
    the SSD scan in f32 at chunk min(chunk, S) from the zero state; + D x,
    the gate silu(z) and RMSNorm in f32, then @ w_out.  The conv tails are
    the last K - 1 conv inputs in the compute dtype."""
    ct = x.dtype
    B_, S, _ = x.shape
    di, ns, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // H

    z = x @ p["w_z"].to(ct)
    xs_raw = x @ p["w_x"].to(ct)
    bc_raw = torch.cat([x @ p["w_B"].to(ct), x @ p["w_C"].to(ct)], dim=-1)
    dt_raw = x @ p["w_dt"].to(ct)

    A = -torch.exp(p["A_log"].float())
    dt = softplus(dt_raw.float() + p["dt_bias"].float())     # (B,S,H)

    xs_c, conv_x = _causal_conv(xs_raw, p["conv_x"].to(ct),
                                p["conv_b_x"].to(ct),
                                None if conv_state is None else conv_state[0])
    bc_c, conv_bc = _causal_conv(bc_raw, p["conv_bc"].to(ct),
                                 p["conv_b_bc"].to(ct),
                                 None if conv_state is None
                                 else conv_state[1])
    xs = F.silu(xs_c).reshape(B_, S, H, hd)
    bc_c = F.silu(bc_c)
    Bv, Cv = bc_c[..., :ns], bc_c[..., ns:]
    if S == 1 and ssm_state is not None:
        dt0 = dt[:, 0]                                        # (B,H)
        dec = torch.exp(dt0 * A)
        upd = (dt0[:, :, None, None] * Bv[:, 0].float()[:, None, :, None]) \
            * xs[:, 0].float()[:, :, None, :]                 # (B,H,N,hd)
        new_ssm = dec[..., None, None] * ssm_state + upd
        y = torch.einsum("bk,bhkd->bhd", Cv[:, 0].float(), new_ssm)
        y = y[:, None].to(ct)                                 # (B,1,H,hd)
    else:
        y, new_ssm = ssd_chunked(xs.float(), dt, A, Bv.float(), Cv.float(),
                                 chunk=min(chunk, S))
        y = y.to(ct)
    y = y + xs * p["D"].to(ct)[None, None, :, None]
    y = y.reshape(B_, S, di)
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["norm_scale"].float()).to(ct)
    return y @ p["w_out"].to(ct), (new_ssm, (conv_x, conv_bc))


def init_mamba2_cache(cfg: ModelConfig, batch: int, device,
                      dtype=torch.float32) -> tuple:
    """JAX `init_mamba2_cache`: (ssm (B, H, N, hd) f32 zeros, (conv_x (B,
    K-1, di), conv_bc (B, K-1, 2N)) zeros in `dtype`, f32 by default, as
    JAX's; the prefill's conv tails are in the compute dtype)."""
    H, ns, K = cfg.ssm_heads, cfg.ssm_state, cfg.conv_width
    return (torch.zeros((batch, H, ns, cfg.d_inner // H),
                        dtype=torch.float32, device=device),
            (torch.zeros((batch, K - 1, cfg.d_inner), dtype=dtype,
                         device=device),
             torch.zeros((batch, K - 1, 2 * ns), dtype=dtype,
                         device=device)))

"""xLSTM blocks, training path (port of `repro.nn.xlstm`): mLSTM (matrix
memory) and sLSTM (scalar memory).

mLSTM per head, with exponential gating and a running stabiliser m:
  C_t = f_t C_{t-1} + i_t v_t k_t^T ,  n_t = f_t n_{t-1} + i_t k_t
  h_t = (C_t q_t) / max(|n_t^T q_t|, exp(-m_t))
in JAX's chunkwise form: quadratic within a chunk, a loop over chunks
carrying (C, n, m), C and n stored scaled by exp(-m), m floored at -30.
The head width is di // H (at xlstm-1.3b's width 4096 / 4 = 1024; the
config's head_dim is not read), so the carry C is (B, H, 1024, 1024) f32.

sLSTM: a scalar-memory recurrent cell with exponential gating, sequential
over time.  `SLSTMScan` is an autograd Function that mirrors JAX's
`custom_vjp`: the forward loop saves each step's pre-state, the backward
loop recomputes each step's pre-activation, applies the cell's vjp
(written out: no autograd graph a step) and stacks dpre, then dW_h is one contraction over the stacked sequence and
db one sum (autograd through the loop would accumulate dW_h step by step:
other sums, and a graph of S steps a block).

JAX has no Pallas kernel here; this is plain PyTorch.  Serving carries
the states (`mlstm`, `slstm`): the prefill returns the chunk scan's (C,
n, m) and the sLSTM's last (c, n, h, m); a one-token decode step runs
the mLSTM's recurrence and one sLSTM cell step (`init_mlstm_cache`,
`init_slstm_cache` for empty ones).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.common import stack_trips, trips
from .config import ModelConfig
from .ssm import softplus

__all__ = ["mlstm_shapes", "slstm_shapes", "mlstm_chunk_scan",
           "apply_mlstm", "mlstm", "slstm_cell", "slstm_cell_vjp",
           "SLSTMScan", "apply_slstm", "slstm", "mlstm_state",
           "slstm_state", "init_mlstm_cache", "init_slstm_cache"]

M_FLOOR = -30.0


def mlstm_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of one mLSTM block's leaves (JAX `init_mlstm`):
    block-diagonal per-head q, k, v of (di // H)^2 each."""
    d, H = cfg.d_model, cfg.num_heads
    di = int(d * cfg.proj_factor)
    hd = di // H
    return {"w_xin": (d, di), "w_zgate": (d, di), "w_q": (H, hd, hd),
            "w_k": (H, hd, hd), "w_v": (H, hd, hd), "w_if": (di, 2 * H),
            "b_if": (2 * H,), "norm_scale": (di,), "w_down": (di, d)}


def slstm_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of one sLSTM block's leaves (JAX `init_slstm`)."""
    d = cfg.d_model
    return {"w_x": (d, 4 * d), "w_h": (d, 4 * d), "b": (4 * d,),
            "w_down": (d, d)}


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_sigmoid as JAX writes it: -softplus(-x)."""
    return -softplus(-x)


def _floor(m: torch.Tensor) -> torch.Tensor:
    """max(m, -30) with jnp.maximum's gradient (torch.maximum, not
    clamp_min: split in two at a tie).  The bound is filled on m's device:
    `new_tensor` would copy it from the host, which synchronises the
    stream."""
    return torch.maximum(m, m.new_full((), M_FLOOR))


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_state(B: int, H: int, hd: int, device) -> tuple:
    """JAX `init_mlstm_cache_raw`: C, n zeros, m at the floor."""
    f32 = torch.float32
    return (torch.zeros((B, H, hd, hd), dtype=f32, device=device),
            torch.zeros((B, H, hd), dtype=f32, device=device),
            torch.full((B, H), M_FLOOR, dtype=f32, device=device))


def mlstm_chunk_scan(q, k, v, ig, log_f, state, chunk: int):
    """Chunkwise mLSTM (JAX `_mlstm_chunk_scan`), f32.
    q, k, v (B, S, H, hd); ig, log_f (B, S, H) (log-space gates); state
    (C (B, H, hd, hd), n (B, H, hd), m (B, H)), C and n scaled by exp(-m).
    Returns (y (B, S, H, hd), the new state).

    JAX's three-operand einsums are written pairwise, each intermediate of
    at most four axes: num = (s_qk * W) (b,i,j,h) over j against v;
    C_new's update = (k * wj) (b,j,h,d) over j against v.  The chunks run
    over `common.trips`."""
    B, S, H, hd = q.shape
    nc = max(1, S // chunk)
    c = S // nc

    def rs(t):
        return t.reshape((B, nc, c) + t.shape[2:])
    qc, kc, vc, igc, lfc = rs(q), rs(k), rs(v), rs(ig), rs(log_f)
    b_cum = torch.cumsum(lfc, dim=2)                  # (B,nc,c,H) inclusive
    g = igc - b_cum                                   # ig_j - b_j
    total = b_cum[:, :, -1]                           # (B,nc,H)
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    causal = causal[None, :, :, None]
    C, n, m = state
    ys = []
    for i in trips(nc, q.device):
        qn, kn, vn = qc[:, i], kc[:, i], vc[:, i]     # (B,c,H,hd)
        bn, gn, tot = b_cum[:, i], g[:, i], total[:, i]
        bg = bn[:, :, None, :] + gn[:, None, :, :]    # (B,i,j,H)
        m_intra = torch.where(causal, bg, -torch.inf).amax(dim=2)
        m_i = _floor(torch.maximum(m_intra, bn + m[:, None, :]))
        W = torch.exp(torch.where(causal, bg - m_i[:, :, None, :],
                                  -torch.inf))        # (B,i,j,H)
        s_qk = torch.einsum("bihd,bjhd->bijh", qn, kn)
        sw = s_qk * W
        num = torch.einsum("bijh,bjhv->bihv", sw, vn)
        den_i = (W * s_qk).sum(dim=2)                 # (B,c,H)
        scale_c = torch.exp(bn + m[:, None, :] - m_i)
        num = num + scale_c[..., None] * torch.einsum("bihd,bhdv->bihv",
                                                      qn, C)
        den_i = den_i + scale_c * torch.einsum("bihd,bhd->bih", qn, n)
        ys.append(num / torch.maximum(den_i.abs(),
                                      torch.exp(-m_i))[..., None])
        m_next = _floor(torch.maximum(
            tot + m, (gn + tot[:, None, :]).amax(dim=1)))
        wj = torch.exp(gn + tot[:, None, :] - m_next[:, None, :])  # (B,c,H)
        decay = torch.exp(tot + m - m_next)
        C = decay[..., None, None] * C + torch.einsum(
            "bjhd,bjhv->bhdv", kn * wj[..., None], vn)
        n = decay[..., None] * n + torch.einsum("bjh,bjhd->bhd", wj, kn)
        m = m_next
    y = stack_trips(ys, nc, dim=1).reshape(B, S, H, hd)
    return y, (C, n, m)


def apply_mlstm(p, x: torch.Tensor, cfg: ModelConfig, chunk: int = 256
                ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), the training path of JAX `apply_mlstm`
    (`mlstm` from the zero state, its output alone)."""
    return mlstm(p, x, cfg, chunk=chunk)[0]


def mlstm(p, x: torch.Tensor, cfg: ModelConfig, *, state=None,
          chunk: int = 256):
    """JAX `apply_mlstm`: x (B, S, d), state (C, n, m) (None: the zero
    state) -> (out (B, S, d), the new state): the up-projection and gate
    in the compute dtype, per-head q, k (scaled by hd^-0.5), v and the
    gates in f32; with S == 1 one recurrent step
      m' = max(log f + m, i, -30), C' = f_s C + i_s k v^T, n' = f_s n +
      i_s k, y = C'^T q / max(|n'.q|, exp(-m'))
    (f_s = exp(log f + m - m'), i_s = exp(i - m')), else the chunk scan
    at chunk min(chunk, S); RMSNorm in f32, * silu(z), then @ w_down."""
    ct = x.dtype
    B, S, d = x.shape
    di = int(d * cfg.proj_factor)
    H = cfg.num_heads
    hd = di // H

    xin = x @ p["w_xin"].to(ct)
    z = x @ p["w_zgate"].to(ct)
    xh = xin.reshape(B, S, H, hd)
    q = torch.einsum("bshd,hde->bshe", xh, p["w_q"].to(ct)).float()
    k = torch.einsum("bshd,hde->bshe", xh,
                     p["w_k"].to(ct)).float() * (hd ** -0.5)
    v = torch.einsum("bshd,hde->bshe", xh, p["w_v"].to(ct)).float()
    gates = (xin @ p["w_if"].to(ct) + p["b_if"].to(ct)).float()
    ig, fg = gates[..., :H], gates[..., H:]
    log_f = log_sigmoid(fg)
    if state is None:
        state = mlstm_state(B, H, hd, x.device)
    if S == 1:
        C, n, m = state
        qf, kf, vf = q[:, 0], k[:, 0], v[:, 0]
        m_new = _floor(torch.maximum(log_f[:, 0] + m, ig[:, 0]))
        i_s = torch.exp(ig[:, 0] - m_new)[..., None]
        f_s = torch.exp(log_f[:, 0] + m - m_new)[..., None]
        C = f_s[..., None] * C + (i_s[..., None] * kf[..., None]) \
            * vf[..., None, :]
        n = f_s * n + i_s * kf
        num = torch.einsum("bhd,bhdv->bhv", qf, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                            torch.exp(-m_new))
        y = (num / den[..., None])[:, None]                   # (B,1,H,hd)
        state = (C, n, m_new)
    else:
        y, state = mlstm_chunk_scan(q, k, v, ig, log_f, state,
                                    chunk=min(chunk, S))
    y = y.to(ct).reshape(B, S, di)
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["norm_scale"].float()).to(ct)
    y = y * F.silu(z)
    return y @ p["w_down"].to(ct), state


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> tuple:
    """JAX `init_mlstm_cache`: `mlstm_state` at the block's head width."""
    H = cfg.num_heads
    return mlstm_state(batch, H, int(cfg.d_model * cfg.proj_factor) // H,
                       device)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_state(B: int, d: int, device) -> tuple:
    """JAX `init_slstm_cache_raw`: (c, n, h, m) = (0, 1, 0, 0), each in
    memory of its own (a decode step writes them in place)."""
    z = torch.zeros((B, d), dtype=torch.float32, device=device)
    return (z, torch.ones_like(z), z.clone(), z.clone())


def slstm_cell(pre, c, n, m):
    """One sLSTM cell update (JAX `_slstm_cell`): pre (B, 4d) holds the
    i, f, z, o pre-activations -> (c, n, h, m) of the next step."""
    ig, fg, zg, og = pre.chunk(4, dim=-1)
    log_f = log_sigmoid(fg)
    m_new = torch.maximum(log_f + m, ig)
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c2 = f_s * c + i_s * torch.tanh(zg)
    n2 = f_s * n + i_s
    h2 = torch.sigmoid(og) * c2 / torch.maximum(n2, n2.new_ones(()))
    return c2, n2, h2, m_new


def slstm_cell_vjp(pre, c, n, m, gc2, gn2, gh2, gm2):
    """The vjp of `slstm_cell` at (pre, c, n, m) for the cotangents of
    (c2, n2, h2, m_new) -> (dpre, dc, dn, dm), written out (no autograd
    graph a step: the backward loop runs it S times a block).  The
    maxima split their cotangent in two at a tie, as jnp.maximum's
    derivative does."""
    ig, fg, zg, og = pre.chunk(4, dim=-1)
    a = log_sigmoid(fg) + m
    m_new = torch.maximum(a, ig)
    e_i = torch.exp(ig - m_new)
    e_f = torch.exp(a - m_new)
    tz = torch.tanh(zg)
    c2 = e_f * c + e_i * tz
    n2 = e_f * n + e_i
    so = torch.sigmoid(og)
    nm = torch.maximum(n2, n2.new_ones(()))
    q = gh2 / nm                                  # d h2 / d (so c2)
    g_c2 = gc2 + q * so
    g_n2 = gn2 - q * (so * c2 / nm) * (torch.sign(n2 - 1.0) + 1.0) * 0.5
    d_i = (g_c2 * tz + g_n2) * e_i                # d / d (ig - m_new)
    d_f = (g_c2 * c + g_n2 * n) * e_f             # d / d (a - m_new)
    g_m = gm2 - d_i - d_f                         # d / d m_new
    w = (torch.sign(a - ig) + 1.0) * 0.5          # m_new's share to a
    g_a = d_f + g_m * w
    dpre = torch.cat([d_i + g_m * (1.0 - w),
                      g_a * torch.sigmoid(-fg),   # d log_sigmoid
                      g_c2 * e_i * (1.0 - tz * tz),
                      q * c2 * so * (1.0 - so)], dim=-1)
    return dpre, g_c2 * e_f, g_n2 * e_f, g_a


def slstm_loop(px, wh, b, state, saved=None):
    """The sLSTM forward over time: px (S, B, 4d) f32, state (c, n, h, m)
    -> (hs (S, B, d), c, n, h, m of the last step), each step pre_t = px_t
    + h_{t-1} @ wh + b through `slstm_cell`; `saved` (4, S, B, d), when
    given, receives each step's pre-state.  The steps run over
    `common.trips` (on the meta device an op counter may count one step
    S times)."""
    S, B, d4 = px.shape
    c, n, h, m = state
    hs = px.new_empty((S, B, d4 // 4))
    for t in trips(S, px.device):
        if saved is not None:
            saved[0, t], saved[1, t], saved[2, t], saved[3, t] = c, n, h, m
        pre = px[t] + h @ wh + b
        c, n, h, m = slstm_cell(pre, c, n, m)
        hs[t] = h
    return hs, c, n, h, m


class SLSTMScan(torch.autograd.Function):
    """The sLSTM over time (JAX `_slstm_scan` with its custom_vjp):
    px (S, B, 4d) f32, wh (d, 4d), b (4d,), the state (c, n, h, m) (B, d)
    each -> (hs (S, B, d), c, n, h, m of the last step).

    forward   pre_t = px_t + h_{t-1} @ wh + b, the cell; saves each step's
              pre-state (c, n, h, m), stacked (S, B, d);
    backward  in reverse: pre_t recomputed from the saved h, the cell's
              vjp (`slstm_cell_vjp`) at the saved state with cotangents
              (dc, dn, dh + dhs_t, dm), dh_{t-1} = dpre_t @ wh^T; dpre
              stacked over time; then dwh = h_stack^T dpre as one (B
              S)-long contraction and db = dpre summed over (S, B).
    wh and b come in f32 (`slstm` casts the leaves, as JAX's apply_slstm
    does), so dwh and db are summed in f32, JAX's einsum over the stacked
    sequence; the cast's backward rounds them once into a bf16 leaf."""

    @staticmethod
    def forward(ctx, px, wh, b, c, n, h, m):
        S, B, d4 = px.shape
        saved = px.new_empty((4, S, B, d4 // 4))
        out = slstm_loop(px, wh, b, (c, n, h, m), saved)
        ctx.save_for_backward(px, wh, b, saved)
        return out

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        px, wh, b, saved = ctx.saved_tensors
        S = px.shape[0]
        dpre = torch.empty_like(px)
        for t in trips(S, px.device, reverse=True):
            c_p, n_p, h_p, m_p = (saved[j, t] for j in range(4))
            pre = px[t] + h_p @ wh + b
            dpre[t], dc, dn, dm = slstm_cell_vjp(pre, c_p, n_p, m_p, dc, dn,
                                                 dh + dhs[t], dm)
            dh = dpre[t] @ wh.T
        h_stack = saved[2]
        dwh = h_stack.reshape(-1, h_stack.shape[-1]).T @ \
            dpre.reshape(-1, dpre.shape[-1])
        db = dpre.sum((0, 1))
        return dpre, dwh, db, dc, dn, dh, dm


def slstm(p, x: torch.Tensor, cfg: ModelConfig, *, state=None):
    """JAX `apply_slstm` with its state: x (B, S, d), state (c, n, h, m)
    (None: the initial state) -> (out (B, S, d), the last step's (c, n,
    h, m)).  x @ w_x in the compute dtype, the scan in f32 (`SLSTMScan`
    where a gradient is taken, else `slstm_loop`), then @ w_down."""
    ct = x.dtype
    B, S, d = x.shape
    pre_x = (x @ p["w_x"].to(ct)).float()
    if state is None:
        state = slstm_state(B, d, x.device)
    wh = p["w_h"].float()
    if S > 1:
        # W_h into an allocation of its own: a view into the flat
        # parameter buffer starts at any 16-byte boundary, and the scan's
        # 2 S small products with it (h @ W_h, dpre @ W_h^T) are its hot
        # loop
        wh = wh.clone()
    px, b = pre_x.transpose(0, 1).contiguous(), p["b"].float()
    if torch.is_grad_enabled():
        hs, *state = SLSTMScan.apply(px, wh, b, *state)
    else:
        hs, *state = slstm_loop(px, wh, b, state)
    return hs.transpose(0, 1).to(ct) @ p["w_down"].to(ct), tuple(state)


def apply_slstm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): `slstm` from the initial state."""
    return slstm(p, x, cfg)[0]


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> tuple:
    """JAX `init_slstm_cache`: `slstm_state` at the model's width."""
    return slstm_state(batch, cfg.d_model, device)

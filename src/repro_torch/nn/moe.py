"""Mixture-of-Experts layer (port of `repro.nn.moe`): top-k routing with
capacity, sort-based dispatch with static shapes, optional shared experts
that every token passes through, and the Switch-style load-balance loss.

JAX computes this layer in plain jnp (no Pallas kernel), and so does the
port, in the same steps:

  router   logits = x @ router in f32 (never TF32), softmax, the top k in
           `lax.top_k` order (ties to the lower expert id: a stable
           descending sort, not `torch.topk`, ROADMAP C1), gates
           renormalised by their sum + 1e-9;
  slots    a stable sort of the T*k expert ids; an assignment's rank among
           its expert's is its position minus the expert's first
           (searchsorted, side left); ranks >= C = capacity(T) are
           dropped; kept ones fill slot expert * C + rank;
  experts  (E, C, d) batched products in the compute dtype:
           silu(x Wg) * x Wu, then @ Wd;
  combine  each token's kept outputs times their gates, summed from +0 in
           ascending expert id and rounded to the compute dtype at every
           add: the order in which XLA:CPU applies JAX's scatter-add
           `zeros.at[token_of].add(...)` (updates in the stable sort's
           order), so the port's forward equals JAX's bit for bit given
           the same expert outputs and gates;
  aux      E * sum(mean(probs) * kept / T), the kept counts per expert read
           off the sort's boundaries.

Nothing here synchronises the host: every shape is static (C from T on
the host) and no value is read back.  Every gradient is a gather: the
dispatch and the combine are partial permutations between the T*k
assignments and the E*C slots, each with its inverse for the backward
pass (`_Gather`), and a token's k copies are summed by a reshape.  No
float is accumulated by atomics, so two backward passes on the same
inputs give the same bits on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["capacity", "apply_moe", "leaf_shapes", "top_k", "route",
           "experts",
           "combine", "Routing"]


def leaf_shapes(cfg: ModelConfig):
    """name -> shape of one layer's MoE leaves (JAX `init_moe`)."""
    d, ff, E = cfg.d_model, cfg.moe_ff, cfg.moe_experts
    shapes = {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
              "w_down": (E, ff, d)}
    if cfg.moe_shared > 0:
        sff = ff * cfg.moe_shared
        shapes.update({"shared/w_gate": (d, sff), "shared/w_up": (d, sff),
                       "shared/w_down": (sff, d)})
    return shapes


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ceil(tokens * k / E * capacity_factor), rounded up
    to a multiple of 8, at least 8."""
    c = math.ceil(tokens * cfg.moe_top_k / cfg.moe_experts
                  * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def _check_no_tf32(x: torch.Tensor) -> None:
    """The router's f32 matmuls, forward and backward, take no TF32: the
    port leaves PyTorch's default (TF32 off) and refuses to route on a
    card where a caller turned it on."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router needs full f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


class _Gather(torch.autograd.Function):
    """out[r] = x[idx[r]] where valid[r], else 0, for a partial bijection
    between the rows of out and of x; inv_idx / inv_valid are its inverse
    (x row s feeds out row inv_idx[s] where inv_valid[s]), so the gradient
    is the gather grad[inv_idx] (0 for rows of x that feed nothing)."""

    @staticmethod
    def forward(ctx, x, idx, valid, inv_idx, inv_valid):
        ctx.save_for_backward(inv_idx, inv_valid)
        return torch.where(valid[:, None], x[idx], 0.0)

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_valid = ctx.saved_tensors
        gx = torch.where(inv_valid[:, None], g[inv_idx], 0.0)
        return gx, None, None, None, None


def _gather(x, idx, valid, inv_idx, inv_valid):
    """`_Gather` where autograd may need its gradient; a plain gather
    under no_grad or inference mode (serving)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, idx, valid, inv_idx, inv_valid)
    return torch.where(valid[:, None], x[idx], 0.0)


class Routing:
    """The integer bookkeeping of one routing (no gradient, no host sync):
    for A = T*k assignments (row-major in (token, top-k rank)) and E*C
    slots, the dispatch map slot -> assignment and the combine map
    (token, i-th smallest expert id) -> slot, each with its inverse, and
    the kept count per expert."""

    def __init__(self, gate_idx: torch.Tensor, E: int, C: int):
        T, k = gate_idx.shape
        A = T * k
        self.gate_idx = gate_idx
        dev = gate_idx.device
        ar = torch.arange(A, device=dev)
        sorted_e, order = torch.sort(gate_idx.reshape(-1), stable=True)
        self.order = order
        bounds = torch.searchsorted(sorted_e,
                                    torch.arange(E + 1, device=dev))
        pos = ar - bounds[sorted_e]
        keep = pos < C
        slot = torch.where(keep, sorted_e * C + pos, E * C)
        self.slot, self.keep = slot, keep     # by sorted position
        self.counts = (bounds[1:] - bounds[:-1]).clamp(max=C)    # (E,)
        self.dropped = A - self.counts.sum()
        # assignment a -> its position in the sorted order
        inv = torch.empty_like(order).scatter_(0, order, ar)
        self.slot_of_a = slot[inv].clamp(max=E * C - 1)
        self.keep_of_a = keep[inv]
        # slot e*C + p <- sorted position bounds[e] + p, if p < counts[e]
        p = torch.arange(C, device=dev)
        src = (bounds[:E, None] + p).reshape(-1).clamp(max=A - 1)
        self.valid_slot = (p < self.counts[:, None]).reshape(-1)
        self.a_of_slot = order[src]
        # combine rows: token t's assignments in ascending expert id
        _, perm = torch.sort(gate_idx, dim=1)
        self.perm = perm
        a_asc = (torch.arange(T, device=dev)[:, None] * k + perm).reshape(-1)
        self.comb_slot = self.slot_of_a[a_asc]
        self.comb_keep = self.keep_of_a[a_asc]
        rank = torch.empty_like(perm).scatter_(
            1, perm, torch.arange(k, device=dev).expand(T, k)).reshape(-1)
        a = self.a_of_slot
        self.row_of_slot = (a // k) * k + rank[a]


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The ids (T, k) of each token's k largest probs in `lax.top_k` order:
    descending, ties to the lower id (a stable sort, not `torch.topk`)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]


def route(probs: torch.Tensor, gate_idx: torch.Tensor, cfg: ModelConfig,
          C: int) -> Tuple[torch.Tensor, "Routing"]:
    """(the gates (T, k) f32 of experts gate_idx (T, k), renormalised, and
    the Routing) from the router's softmax probs (T, E)."""
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    with torch.no_grad():
        r = Routing(gate_idx, cfg.moe_experts, C)
    return gate_vals, r


def experts(p, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, d) -> (E, C, d): silu(x Wg) * x Wu, then @ Wd, per expert in
    xe's dtype."""
    ct = xe.dtype
    h = F.silu(torch.bmm(xe, p["w_gate"].to(ct))) * \
        torch.bmm(xe, p["w_up"].to(ct))
    return torch.bmm(h, p["w_down"].to(ct))


def combine(ye: torch.Tensor, gate_vals: torch.Tensor, r: "Routing"
            ) -> torch.Tensor:
    """The experts' outputs (E, C, d) back to the tokens (T, d): each
    token's kept outputs times its gates (rounded to ye's dtype), summed
    from +0 in ascending expert id, every add rounded to ye's dtype."""
    ct = ye.dtype
    T, k = gate_vals.shape
    E, C, d = ye.shape
    yk = _gather(ye.reshape(E * C, d), r.comb_slot, r.comb_keep,
                 r.row_of_slot, r.valid_slot).view(T, k, d)
    gv = (gate_vals.gather(1, r.perm) * r.comb_keep.view(T, k)).to(ct)
    u = yk * gv[..., None]
    out = torch.zeros((T, d), dtype=ct, device=ye.device)
    for i in range(k):
        out = out + u[:, i]
    return out


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux (f32 scalar), dropped
    assignments (int64 scalar)); T = B * S tokens.  p: {"router",
    "w_gate", "w_up", "w_down"[, "shared": {...}]}."""
    ct = x.dtype
    B, S, d = x.shape
    T = B * S
    E, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(T, d)
    _check_no_tf32(x)
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    C = capacity(T, cfg)
    gate_vals, r = route(probs, top_k(probs, k), cfg, C)
    xk = xt.unsqueeze(1).expand(T, k, d).reshape(T * k, d)
    xe = _gather(xk, r.a_of_slot, r.valid_slot, r.slot_of_a,
                 r.keep_of_a).view(E, C, d)
    out = combine(experts(p, xe), gate_vals, r)
    if cfg.moe_shared > 0:
        sp = p["shared"]
        hs = F.silu(xt @ sp["w_gate"].to(ct)) * (xt @ sp["w_up"].to(ct))
        out = out + hs @ sp["w_down"].to(ct)
    me = probs.mean(0)
    ce = r.counts.float() / max(T, 1)
    aux = E * torch.sum(me * ce)
    return out.view(B, S, d), aux, r.dropped

"""Server-side optimizers on flat vectors (port of
`repro.optim.optimizers`).

COCO-EF's aggregate ghat already contains the learning rate (eq. 4), so the
paper's server optimizer is plain SGD: theta <- theta - ghat.  Momentum and
Adam treat ghat/gamma as the gradient estimate.  Weight decay is decoupled
(AdamW).  Unlike the JAX version, `apply_update` updates the parameter and
state vectors in place, which saves a model-sized copy.  The parameters
may be stored in bf16 (`ModelConfig.param_dtype`): the update is then
computed in f32 from theta widened and rounded once per element, as JAX
updates the f32 flat vector and casts each leaf back (`unflatten_local`);
ghat and the state stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.obs.metrics import CHUNK

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "sgd"            # sgd | momentum | adam
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def init_opt_state(cfg: OptimizerConfig, n: int, device="cuda"
                   ) -> Tuple[torch.Tensor, ...]:
    """Zero state vectors of `cfg.kind` for n parameters, on `device`
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if cfg.kind == "sgd":
        return ()
    if cfg.kind == "momentum":
        return (torch.zeros(n, dtype=_F32, device=device),)
    if cfg.kind == "adam":
        return (torch.zeros(n, dtype=_F32, device=device),
                torch.zeros(n, dtype=_F32, device=device))
    raise ValueError(cfg.kind)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


@torch.no_grad()
def apply_update(cfg: OptimizerConfig, params_flat: torch.Tensor,
                 ghat: torch.Tensor, state: Tuple[torch.Tensor, ...], step,
                 gamma, want_norms: bool = False):
    """params_flat (n,) f32 or bf16 and the state vectors are updated in
    place; returns (params_flat, state), and with want_norms a third dict
    {"update_norm_sq", "param_norm_sq"} (float64 scalars on the device:
    |theta_new - theta|^2, the decay included, and |theta_new|^2).
    theta is updated a CHUNK at a time, so only a chunk of temporaries is
    live: new = (theta - upd) - theta * (wd * gamma) in f32 from theta
    widened, written back (rounded once when theta is bf16); the norms are
    of the f32 values before that rounding, as JAX's `delta = new_params -
    params_flat` is taken before the cast."""
    gamma = _f32(gamma)
    if cfg.kind == "sgd":
        upd = ghat
    elif cfg.kind == "momentum":
        (m,) = state
        m.mul_(_f32(cfg.momentum)).add_(ghat)
        upd = m
    elif cfg.kind == "adam":
        m, v = state
        g = ghat / torch.clamp(gamma, min=1e-20)
        m.mul_(_f32(cfg.beta1)).add_(g * _f32(1 - cfg.beta1))
        v.mul_(_f32(cfg.beta2)).add_(g * _f32(1 - cfg.beta2) * g)
        t = _f32(step) + 1.0
        mh = m / (1 - _f32(cfg.beta1) ** t)
        vh = v / (1 - _f32(cfg.beta2) ** t)
        upd = gamma * mh / (torch.sqrt(vh) + _f32(cfg.eps))
    else:
        raise ValueError(cfg.kind)
    wd = cfg.weight_decay * gamma if cfg.weight_decay else None
    norms = {k: torch.zeros((), dtype=torch.float64,
                            device=params_flat.device)
             for k in ("update_norm_sq", "param_norm_sq")}
    for i in range(0, params_flat.numel(), CHUNK):
        sl = slice(i, i + CHUNK)
        old = params_flat[sl].to(_F32, copy=True)
        new = old - upd[sl]
        if wd is not None:
            new.sub_(old * wd)
        params_flat[sl] = new
        if want_norms:
            old.sub_(new)                  # theta - theta_new, in f32
            norms["update_norm_sq"] += torch.dot(old, old).double()
            norms["param_norm_sq"] += torch.dot(new, new).double()
    if not want_norms:
        return params_flat, state
    return params_flat, state, norms


SCHEDULES = ("constant", "rsqrt", "cosine")


def lr_schedule(kind: str, base: float, warmup: int = 0,
                total: Optional[int] = None):
    """Returns gamma(step) as an f32 scalar tensor.  'constant' is the
    paper's setting; 'rsqrt' the decaying scheme of Fig. 6; 'cosine' needs
    `total`.  Knobs are validated here, at construction."""
    if kind not in SCHEDULES:
        raise ValueError(f"unknown lr schedule {kind!r}; have {SCHEDULES}")
    if warmup < 0:
        raise ValueError(f"warmup={warmup} must be >= 0 steps")
    if kind == "cosine" and (total is None or total < 1):
        raise ValueError(
            f"cosine schedule needs total >= 1 decay steps, got {total!r}")

    def f(step) -> torch.Tensor:
        s = _f32(step)
        g = _f32(base)
        if kind == "rsqrt":
            g = g / torch.sqrt(s + 1.0)
        elif kind == "cosine":
            frac = torch.clamp(s / total, 0.0, 1.0)
            g = g * 0.5 * (1 + torch.cos(_f32(torch.pi) * frac))
        if warmup > 0:
            g = g * torch.clamp((s + 1.0) / warmup, 0.0, 1.0)
        return g
    return f

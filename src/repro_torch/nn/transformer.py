"""The dense decoder stack (port of the dense family of
`repro.nn.transformer`): parameter shapes, init, forward, the coded
weighted loss, and serving (prefill, KV caches, decode).

Block parameters are stacked (L, ...) exactly as JAX lays them out
(`blocks/attn/wq` is (L, d, H, hd), ...), and every leaf is a view into one
padded flat f32 buffer in JAX's leaf order (`core.cocoef.flat_layout`).
Autograd sees one leaf per layer — a view of layer l of the stacked tensor
— whose `.grad` is the matching view of one flat gradient buffer, so the
backward pass accumulates straight into the flat gradient with no
concatenation and no full-size per-layer temporaries.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import prng
from . import layers as L
from .config import ModelConfig

BLOCK_LEAVES = ("attn/wk", "attn/wo", "attn/wq", "attn/wv", "mlp/w_down",
                "mlp/w_gate", "mlp/w_up", "norm1/scale", "norm2/scale")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every parameter leaf of a dense model (the JAX
    param tree's key paths joined by '/')."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the port has the dense family only, "
                                  f"not {cfg.family!r}")
    if cfg.qkv_bias or cfg.norm != "rms" or not cfg.tie_embeddings \
            or cfg.input_mode != "tokens" or cfg.mlp != "geglu":
        raise NotImplementedError("the port's dense stack has RMSNorm, no "
                                  "qkv bias, tied token embeddings, GeGLU")
    Lyr, d, H, Hkv, hd, ff = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    shapes = {
        "blocks/attn/wq": (Lyr, d, H, hd),
        "blocks/attn/wk": (Lyr, d, Hkv, hd),
        "blocks/attn/wv": (Lyr, d, Hkv, hd),
        "blocks/attn/wo": (Lyr, H, hd, d),
        "blocks/mlp/w_gate": (Lyr, d, ff),
        "blocks/mlp/w_up": (Lyr, d, ff),
        "blocks/mlp/w_down": (Lyr, ff, d),
        "blocks/norm1/scale": (Lyr, d),
        "blocks/norm2/scale": (Lyr, d),
        "embed/tok": (cfg.vocab_size, d),
        "final_norm/scale": (d,),
    }
    return shapes


def num_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def layer_windows(cfg: ModelConfig):
    """Per-layer attention windows (gemma2 local/global alternation)."""
    n = cfg.num_layers
    if cfg.local_global_period and cfg.sliding_window:
        return [cfg.sliding_window if i % cfg.local_global_period == 0
                else L.BIG_WINDOW for i in range(n)]
    return [cfg.sliding_window or L.BIG_WINDOW] * n


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """Empty ring caches of the dense family (JAX `init_caches`), stacked
    over layers: {"kv": {"k", "v": (L, B, Hkv, T, hd), "pos": (L, T)
    int32}}.  With gemma2's alternation JAX sizes the local layers' rings
    at min(cache_len, window) and then allocates every layer at the
    longest of those lengths."""
    if cfg.local_global_period and cfg.sliding_window:
        lens = [min(cache_len, cfg.sliding_window)
                if i % cfg.local_global_period == 0 else cache_len
                for i in range(cfg.num_layers)]
        cache_len = max(lens)
    one = L.init_kv_cache(cfg, batch, cache_len, dtype,
                          resolve_device(device))
    return {"kv": {k: v[None].repeat((cfg.num_layers,) + (1,) * v.dim())
                   for k, v in one.items()}}


def _layer_cache(caches, l: int):
    return {k: v[l] for k, v in caches["kv"].items()}


def init_keys(cfg: ModelConfig, key: np.ndarray
              ) -> Dict[str, Tuple[np.ndarray, Optional[int]]]:
    """name -> (keys, fan_in) of every random leaf, walking the key tree of
    `repro.nn.transformer.init_params` for the dense stack: split(key, 8);
    ks[0] to `init_embedding` (split of 2, the token table from the first,
    unscaled: fan_in None); split(ks[1], L) to the layers (under JAX's
    vmap, one key per layer), each split in 4 with k1 to `init_attention`
    (split of 4: wq, wk, wv, wo) and k3 to `init_mlp` (split of 3:
    w_gate, w_up, w_down).  Block leaves get (L, 2) keys, one per layer;
    fan_in is `dense_init`'s in_axis_size.  Norm scales are ones."""
    d = cfg.d_model
    ks = prng.split(key, 8)
    out = {"embed/tok": (prng.split(ks[0], 2)[0], None)}
    per = [prng.split(k, 4) for k in prng.split(ks[1], cfg.num_layers)]
    attn = np.stack([prng.split(k[0], 4) for k in per])      # (L, 4, 2)
    mlp = np.stack([prng.split(k[2], 3) for k in per])       # (L, 3, 2)
    for i, (leaf, fan) in enumerate((("wq", d), ("wk", d), ("wv", d),
                                     ("wo", cfg.num_heads * cfg.head_dim))):
        out["blocks/attn/" + leaf] = (attn[:, i], fan)
    for i, (leaf, fan) in enumerate((("w_gate", d), ("w_up", d),
                                     ("w_down", cfg.d_ff))):
        out["blocks/mlp/" + leaf] = (mlp[:, i], fan)
    return out


class Transformer(nn.Module):
    """Dense decoder stack over flat parameter/gradient buffers.

    theta, grad: (layout.padded,) f32 buffers (grad None: no gradient
    views are attached); `stacked` maps every leaf name to its view of
    theta in the JAX shape."""

    def __init__(self, cfg: ModelConfig, layout, theta: torch.Tensor,
                 grad: Optional[torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.layout = layout
        self.theta, self.grad = theta, grad
        self.stacked = layout.views(theta)
        gviews = layout.views(grad) if grad is not None else None
        self.layers = nn.ModuleList()
        for l in range(cfg.num_layers):
            blk = nn.ParameterDict()
            for leaf in BLOCK_LEAVES:
                name = "blocks/" + leaf
                p = nn.Parameter(self.stacked[name][l])
                if gviews is not None:
                    p.grad = gviews[name][l]
                blk[leaf.replace("/", "_")] = p
            self.layers.append(blk)
        self.tok = nn.Parameter(self.stacked["embed/tok"])
        self.final_norm = nn.Parameter(self.stacked["final_norm/scale"])
        if gviews is not None:
            self.tok.grad = gviews["embed/tok"]
            self.final_norm.grad = gviews["final_norm/scale"]
        self.windows = layer_windows(cfg)

    @torch.no_grad()
    def init_(self, key: np.ndarray) -> None:
        """JAX's init_params(key) bit for bit, as `jax.jit` compiles it
        (`init_keys`; each leaf erf_inv(u) * `prng.init_scale(fan_in)`,
        drawn by `prng.normal_into` on theta's device); norm scales 1."""
        keys = init_keys(self.cfg, key)
        for name, v in self.stacked.items():
            if name.endswith("/scale"):
                v.fill_(1.0)
                continue
            k, fan = keys[name]
            scale = prng.init_scale(fan)
            if k.ndim == 1:
                prng.normal_into(v.view(-1), k, scale)
            else:
                for l in range(v.shape[0]):
                    prng.normal_into(v[l].view(-1), k[l], scale)

    def _params(self, l: int):
        b = self.layers[l]
        attn = {k: b["attn_" + k] for k in ("wq", "wk", "wv", "wo")}
        mlp = {k: b["mlp_" + k] for k in ("w_gate", "w_up", "w_down")}
        return b, attn, mlp

    def _block(self, x: torch.Tensor, l: int) -> torch.Tensor:
        b, attn, mlp = self._params(l)
        h = L.attn_train(attn, L.apply_norm(b["norm1_scale"], x), self.cfg,
                         window=self.windows[l])
        x = x + h
        return x + L.apply_mlp(mlp, L.apply_norm(b["norm2_scale"], x),
                               self.cfg)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs (B, S) tokens -> (B, S, d) final normed hidden states.
        Each block is rematerialised in the backward pass when cfg.remat."""
        x = L.embed(self.tok, inputs, self.cfg)
        for l in range(self.cfg.num_layers):
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self._block, x, l, use_reentrant=False)
            else:
                x = self._block(x, l)
        return L.apply_norm(self.final_norm, x)

    def weighted_loss(self, tokens: torch.Tensor, weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Coded loss sum_j w_j * mean-token-NLL(example j).
        tokens (B, S+1), weights (B,) f32 -> (loss, per_example (B,))."""
        x = self.forward(tokens[:, :-1])
        logits = L.logits_from(self.tok, x, self.cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
        per_example = nll.mean(dim=-1)
        return (per_example * weights).sum(), per_example

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, cache_dtype=torch.bfloat16):
        """Forward over the prompt (JAX `prefill`, dense family): inputs
        (B, S) tokens -> (logits of the last position (B, vocab), caches).
        Attention runs through the flash kernel; each layer's k and v go
        straight into the stacked caches, whose length is the prompt's, and
        pos (L, S) holds 0..S-1."""
        cfg = self.cfg
        B, S = inputs.shape
        x = L.embed(self.tok, inputs, cfg)
        shape = (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        kv = {"k": torch.empty(shape, dtype=cache_dtype, device=x.device),
              "v": torch.empty(shape, dtype=cache_dtype, device=x.device),
              "pos": torch.arange(S, dtype=torch.int32, device=x.device
                                  ).repeat(cfg.num_layers, 1)}
        for l in range(cfg.num_layers):
            b, attn, mlp = self._params(l)
            h, (k, v) = L.attn_prefill(attn, L.apply_norm(b["norm1_scale"], x),
                                       cfg, window=self.windows[l])
            kv["k"][l].copy_(k)
            kv["v"][l].copy_(v)
            x = x + h
            x = x + L.apply_mlp(mlp, L.apply_norm(b["norm2_scale"], x), cfg)
        x = L.apply_norm(self.final_norm, x[:, -1:])
        return L.logits_from(self.tok, x, cfg)[:, -1], {"kv": kv}

    @torch.no_grad()
    def decode_step(self, caches, inputs: torch.Tensor, pos: int):
        """One-token decode (JAX `decode_step`, dense family): inputs (B, 1)
        tokens at absolute position `pos` (a host int).  Every layer writes
        its ring slot of `caches` in place (`layers.attn_decode`).  Returns
        (logits (B, vocab), caches)."""
        cfg = self.cfg
        x = L.embed(self.tok, inputs, cfg)
        for l in range(cfg.num_layers):
            b, attn, mlp = self._params(l)
            x = x + L.attn_decode(attn, L.apply_norm(b["norm1_scale"], x),
                                  cfg, _layer_cache(caches, l), pos,
                                  window=self.windows[l])
            x = x + L.apply_mlp(mlp, L.apply_norm(b["norm2_scale"], x), cfg)
        x = L.apply_norm(self.final_norm, x)
        return L.logits_from(self.tok, x, cfg)[:, -1], caches

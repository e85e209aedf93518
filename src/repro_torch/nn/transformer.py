"""The dense and MoE decoder stacks (port of those families of
`repro.nn.transformer`): parameter shapes, init, forward, the coded
weighted loss, and serving (prefill, KV caches, decode) of gemma2's
stack.  The dense family takes every variant of `nn.layers` (RMSNorm or
LayerNorm, qkv bias, the four MLPs, token or embeddings input, a tied or
untied head); the MoE family swaps each block's MLP for `nn.moe`.

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
from . import moe as MOE
from .config import ModelConfig

FAMILIES = ("dense", "moe")
AUX_WEIGHT = 0.01          # JAX weighted_loss's default aux_weight

def _block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One block's leaves (JAX `init_attention`, `init_norm`, `init_mlp`
    or `moe.init_moe`), without the layer axis."""
    d, H, Hkv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    blk = {"attn/wq": (d, H, hd), "attn/wk": (d, Hkv, hd),
           "attn/wv": (d, Hkv, hd), "attn/wo": (H, hd, d)}
    if cfg.qkv_bias:
        blk.update({"attn/bq": (H, hd), "attn/bk": (Hkv, hd),
                    "attn/bv": (Hkv, hd)})
    for norm in ("norm1", "norm2"):
        blk.update(_norm_shapes(cfg, norm))
    if cfg.family == "moe":
        blk.update({"moe/" + k: v for k, v in MOE.leaf_shapes(cfg).items()})
    else:
        if cfg.mlp in ("swiglu", "geglu"):
            blk["mlp/w_gate"] = (d, ff)
        blk.update({"mlp/w_up": (d, ff), "mlp/w_down": (ff, d)})
    return blk


def _norm_shapes(cfg: ModelConfig, name: str) -> Dict[str, Tuple[int, ...]]:
    out = {f"{name}/scale": (cfg.d_model,)}
    if cfg.norm == "layer":
        out[f"{name}/bias"] = (cfg.d_model,)
    return out


def check_family(cfg: ModelConfig) -> None:
    """The port has the dense and MoE families (ROADMAP A5: MLA, the
    hybrid and xLSTM stacks are still to port)."""
    if cfg.family not in FAMILIES or cfg.mla:
        raise NotImplementedError(f"the port has the {FAMILIES} families, "
                                  f"not {cfg.family!r}")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every parameter leaf (the JAX param tree's key
    paths joined by '/'): the blocks stacked over layers, the embedding
    (a token table or the embeddings input's projection, and the head
    unless tied) and the final norm."""
    check_family(cfg)
    Lyr, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    shapes = {"blocks/" + k: (Lyr,) + v
              for k, v in _block_shapes(cfg).items()}
    if cfg.input_mode == "tokens":
        shapes["embed/tok"] = (V, d)
    else:
        shapes["embed/proj"] = (d, d)
    if not cfg.tie_embeddings:
        shapes["embed/head"] = (d, V)
    shapes.update(_norm_shapes(cfg, "final_norm"))
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
    `repro.nn.transformer.init_params` for the dense and MoE stacks:
    split(key, 8); ks[0] to `init_embedding` (split of 2: the token table,
    unscaled (fan_in None), or the embeddings input's proj from the
    first, the untied head from the second); split(ks[1], L) to the
    layers (under JAX's vmap, one key per layer), each split in 4 with k1
    to `init_attention` (split of 4: wq, wk, wv, wo), k2 to `init_moe`
    (split of 5: router, w_gate, w_up, w_down, and the shared experts'
    split of 3 from the fifth) and k3 to `init_mlp` (split of 3: w_gate,
    w_up, w_down; without a gate w_up, w_down).  Block leaves get (L, 2)
    keys, one per layer; fan_in is `dense_init`'s in_axis_size.  Norm
    scales are ones, biases zeros (no key)."""
    d, ff = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 8)
    emb = prng.split(ks[0], 2)
    out = ({"embed/tok": (emb[0], None)} if cfg.input_mode == "tokens"
           else {"embed/proj": (emb[0], d)})
    if not cfg.tie_embeddings:
        out["embed/head"] = (emb[1], d)
    per = [prng.split(k, 4) for k in prng.split(ks[1], cfg.num_layers)]

    def leaves(prefix, parents, n, names_fans):
        keys = np.stack([prng.split(k, n) for k in parents])    # (L, n, 2)
        for i, (leaf, fan) in enumerate(names_fans):
            out[prefix + leaf] = (keys[:, i], fan)
        return keys

    leaves("blocks/attn/", [k[0] for k in per], 4,
           (("wq", d), ("wk", d), ("wv", d),
            ("wo", cfg.num_heads * cfg.head_dim)))
    if cfg.family == "moe":
        mk = leaves("blocks/moe/", [k[1] for k in per], 5,
                    (("router", d), ("w_gate", d), ("w_up", d),
                     ("w_down", cfg.moe_ff)))
        if cfg.moe_shared > 0:
            leaves("blocks/moe/shared/", mk[:, 4], 3,
                   (("w_gate", d), ("w_up", d),
                    ("w_down", cfg.moe_ff * cfg.moe_shared)))
    elif cfg.mlp in ("swiglu", "geglu"):
        leaves("blocks/mlp/", [k[2] for k in per], 3,
               (("w_gate", d), ("w_up", d), ("w_down", ff)))
    else:
        leaves("blocks/mlp/", [k[2] for k in per], 3,
               (("w_up", d), ("w_down", ff)))
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b": t} -> {"a": {"b": t}}."""
    tree: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


class Transformer(nn.Module):
    """The dense or MoE decoder stack over flat parameter/gradient buffers.

    theta, grad: (layout.padded,) f32 buffers (grad None: no gradient
    views are attached); `stacked` maps every leaf name to its view of
    theta in the JAX shape.  `layers[l]` holds layer l's block leaves and
    `top` the embedding's and the final norm's, each an nn.Parameter
    whose .grad is the matching view of grad."""

    def __init__(self, cfg: ModelConfig, layout, theta: torch.Tensor,
                 grad: Optional[torch.Tensor]):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.layout = layout
        self.theta, self.grad = theta, grad
        self.stacked = layout.views(theta)
        gviews = layout.views(grad) if grad is not None else None

        def param(name: str, l: Optional[int]) -> nn.Parameter:
            def at(v):
                return v if l is None else v[l]
            p = nn.Parameter(at(self.stacked[name]))
            if gviews is not None:
                p.grad = at(gviews[name])
            return p

        blocks = {n for n in layout.names if n.startswith("blocks/")}
        self.layers = nn.ModuleList()
        self._blocks = []
        for l in range(cfg.num_layers):
            blk, named = nn.ParameterDict(), {}
            for name in layout.names:
                if name not in blocks:
                    continue
                leaf = name[len("blocks/"):]
                blk[leaf.replace("/", "_")] = named[leaf] = param(name, l)
            self.layers.append(blk)
            self._blocks.append(_nest(named))
        self.top, named = nn.ParameterDict(), {}
        for name in layout.names:
            if name not in blocks:
                self.top[name.replace("/", "_")] = named[name] = \
                    param(name, None)
        named = _nest(named)
        self.embed_p, self.final_p = named["embed"], named["final_norm"]
        self.windows = layer_windows(cfg)
        self.moe_dropped: Optional[torch.Tensor] = None

    @property
    def tok(self) -> nn.Parameter:
        return self.embed_p["tok"]

    @torch.no_grad()
    def init_(self, key: np.ndarray) -> None:
        """JAX's init_params(key) bit for bit, as `jax.jit` compiles it
        (`init_keys`; each leaf erf_inv(u) * `prng.init_scale(fan_in)`,
        drawn by `prng.normal_into` on theta's device); norm scales 1,
        biases 0."""
        keys = init_keys(self.cfg, key)
        for name, v in self.stacked.items():
            if name not in keys:
                v.fill_(1.0 if name.endswith("/scale") else 0.0)
                continue
            k, fan = keys[name]
            scale = prng.init_scale(fan)
            if k.ndim == 1:
                prng.normal_into(v.view(-1), k, scale)
            else:
                for l in range(v.shape[0]):
                    prng.normal_into(v[l].view(-1), k[l], scale)

    def _block(self, x: torch.Tensor, l: int):
        """Layer l: (x, the MoE layer's aux and dropped assignments, or
        None in the dense family)."""
        p, cfg = self._blocks[l], self.cfg
        x = x + L.attn_train(p["attn"], L.apply_norm(p["norm1"], x, cfg),
                             cfg, window=self.windows[l])
        h = L.apply_norm(p["norm2"], x, cfg)
        if cfg.family == "moe":
            h, aux, dropped = MOE.apply_moe(p["moe"], h, cfg)
            return x + h, aux, dropped
        return x + L.apply_mlp(p["mlp"], h, cfg), None, None

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """inputs (B, S) tokens or (B, S, d) embeddings -> ((B, S, d) final
        normed hidden states, the MoE aux loss summed over the layers from
        0 in f32, or None in the dense family).  Each block is
        rematerialised in the backward pass when cfg.remat.  The MoE
        layers' dropped assignments of this pass (an int64 device scalar,
        summed over layers) are left in `moe_dropped`."""
        x = L.embed(self.embed_p, inputs, self.cfg)
        aux = dropped = None
        if self.cfg.family == "moe":
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            dropped = torch.zeros((), dtype=torch.int64, device=x.device)
        for l in range(self.cfg.num_layers):
            if self.cfg.remat and torch.is_grad_enabled():
                x, a, dr = checkpoint(self._block, x, l, use_reentrant=False)
            else:
                x, a, dr = self._block(x, l)
            if a is not None:
                aux, dropped = aux + a, dropped + dr
        self.moe_dropped = dropped
        return L.apply_norm(self.final_p, x, self.cfg), aux

    def weighted_loss(self, inputs: torch.Tensor, weights: torch.Tensor,
                      targets: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Coded loss sum_j w_j * mean-token-NLL(example j) + AUX_WEIGHT *
        aux (JAX's `weighted_loss` at its default aux_weight; the dense
        family has no aux term).  Token input: inputs (B, S+1), the
        targets its shift; embeddings input: inputs (B, S, d), targets
        (B, S).  weights (B,) f32 -> (loss, per_example (B,))."""
        if self.cfg.input_mode == "tokens":
            inputs, targets = inputs[:, :-1], inputs[:, 1:]
        x, aux = self.forward(inputs)
        logits = L.logits_from(self.embed_p, x, self.cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        per_example = nll.mean(dim=-1)
        loss = (per_example * weights).sum()
        if aux is not None:
            loss = loss + AUX_WEIGHT * aux
        return loss, per_example

    def _check_serving(self) -> None:
        """Serving is held against JAX for gemma2's stack only (dense,
        token input, RMSNorm, GeGLU, no qkv bias, tied head); the other
        variants' prefill and decode are ROADMAP A9."""
        cfg = self.cfg
        if not (cfg.family == "dense" and cfg.input_mode == "tokens"
                and cfg.norm == "rms" and cfg.mlp == "geglu"
                and not cfg.qkv_bias and cfg.tie_embeddings):
            raise NotImplementedError(
                f"serving {cfg.name}: the port serves gemma2's stack only "
                f"(ROADMAP A9)")

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, cache_dtype=torch.bfloat16):
        """Forward over the prompt (JAX `prefill`, dense family): inputs
        (B, S) tokens -> (logits of the last position (B, vocab), caches).
        Attention runs through the flash kernel; each layer's k and v go
        straight into the stacked caches, whose length is the prompt's, and
        pos (L, S) holds 0..S-1."""
        self._check_serving()
        cfg = self.cfg
        B, S = inputs.shape
        x = L.embed(self.embed_p, inputs, cfg)
        shape = (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        kv = {"k": torch.empty(shape, dtype=cache_dtype, device=x.device),
              "v": torch.empty(shape, dtype=cache_dtype, device=x.device),
              "pos": torch.arange(S, dtype=torch.int32, device=x.device
                                  ).repeat(cfg.num_layers, 1)}
        for l in range(cfg.num_layers):
            p = self._blocks[l]
            h, (k, v) = L.attn_prefill(p["attn"],
                                       L.apply_norm(p["norm1"], x, cfg),
                                       cfg, window=self.windows[l])
            kv["k"][l].copy_(k)
            kv["v"][l].copy_(v)
            x = x + h
            x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg),
                                cfg)
        x = L.apply_norm(self.final_p, x[:, -1:], cfg)
        return L.logits_from(self.embed_p, x, cfg)[:, -1], {"kv": kv}

    @torch.no_grad()
    def decode_step(self, caches, inputs: torch.Tensor, pos: int):
        """One-token decode (JAX `decode_step`, dense family): inputs (B, 1)
        tokens at absolute position `pos` (a host int).  Every layer writes
        its ring slot of `caches` in place (`layers.attn_decode`).  Returns
        (logits (B, vocab), caches)."""
        self._check_serving()
        cfg = self.cfg
        x = L.embed(self.embed_p, inputs, cfg)
        for l in range(cfg.num_layers):
            p = self._blocks[l]
            x = x + L.attn_decode(p["attn"], L.apply_norm(p["norm1"], x, cfg),
                                  cfg, _layer_cache(caches, l), pos,
                                  window=self.windows[l])
            x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg),
                                cfg)
        x = L.apply_norm(self.final_p, x, cfg)
        return L.logits_from(self.embed_p, x, cfg)[:, -1], caches

"""The decoder stacks of every family (port of `repro.nn.transformer`):
parameter shapes, init, forward, the coded weighted loss, and serving
(prefill, caches, decode) of every family.  The dense
family takes every variant of `nn.layers` (RMSNorm or LayerNorm, qkv
bias, the four MLPs, token or embeddings input, a tied or untied head);
the MoE family swaps each block's MLP for `nn.moe`; deepseek puts MLA
(`layers.mla_train`) before the MoE, after one dense block0; hybrid
(zamba2) interleaves groups of Mamba2 blocks (`nn.ssm`) with one shared
attention block; xlstm groups mLSTM blocks before an sLSTM block
(`nn.xlstm`).

Block parameters are stacked exactly as JAX lays them out
(`blocks/attn/wq` is (L, d, H, hd), hybrid's `blocks/mamba/w_x` (G,
period, d, di), ...), and every leaf is a view into one padded flat f32
buffer in JAX's leaf order (`core.cocoef.flat_layout`).  Autograd sees one
leaf per block — a view of block (g, i) of the stacked tensor — whose
`.grad` is the matching view of one flat gradient buffer, so the backward
pass accumulates straight into the flat gradient with no concatenation
and no full-size per-layer temporaries.

The sharded serve (`sharded_prefill`, `sharded_decode_step`) runs the
dense family over the mesh that `sharding.ctx.active_mesh()` returns: a
`Transformer` a device holds that device's shard of θ (`specs`), and the
layers' sharded forms (`nn.layers`) loop over the devices the process
holds.  The other families raise NotImplementedError there (ROADMAP A15).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.sharding import ctx
from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .config import ModelConfig

FAMILIES = ("dense", "moe", "deepseek", "hybrid", "xlstm")
AUX_WEIGHT = 0.01          # JAX weighted_loss's default aux_weight
ONES = frozenset(("scale", "D", "norm_scale", "kv_norm"))   # init to 1


def _attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """JAX `init_attention`'s leaves."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    out = {"wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
           "wo": (H, hd, d)}
    if cfg.qkv_bias:
        out.update({"bq": (H, hd), "bk": (Hkv, hd), "bv": (Hkv, hd)})
    return out


def _mla_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """JAX `init_mla`'s leaves."""
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    return {"wq": (d, H, cfg.qk_nope_dim + cfg.qk_rope_dim),
            "w_dkv": (d, r + cfg.qk_rope_dim),
            "w_uk": (r, H, cfg.qk_nope_dim), "w_uv": (r, H, cfg.v_head_dim),
            "wo": (H, cfg.v_head_dim, d), "kv_norm": (r,)}


def _mlp_shapes(cfg: ModelConfig, ff: int) -> Dict[str, Tuple[int, ...]]:
    """JAX `init_mlp`'s leaves at width ff."""
    d = cfg.d_model
    out = {"w_gate": (d, ff)} if cfg.mlp in ("swiglu", "geglu") else {}
    out.update({"w_up": (d, ff), "w_down": (ff, d)})
    return out


def _norm_shapes(cfg: ModelConfig, name: str) -> Dict[str, Tuple[int, ...]]:
    out = {f"{name}/scale": (cfg.d_model,)}
    if cfg.norm == "layer":
        out[f"{name}/bias"] = (cfg.d_model,)
    return out


def _under(prefix: str, shapes: Dict[str, Tuple[int, ...]]):
    return {f"{prefix}/{k}": v for k, v in shapes.items()}


def _block(cfg: ModelConfig, attn: Dict, ffn: Dict) -> Dict:
    """norm1, attn, norm2 and the MLP or MoE leaves `ffn` of one block."""
    out = {**_norm_shapes(cfg, "norm1"), **_under("attn", attn),
           **_norm_shapes(cfg, "norm2")}
    out.update(ffn)
    return out


def _moe(cfg: ModelConfig) -> Dict:
    return _under("moe", MOE.leaf_shapes(cfg))


def _stacks(cfg: ModelConfig
            ) -> Dict[str, Tuple[Tuple[int, ...], Dict[str, Tuple[int, ...]]]]:
    """prefix -> (leading axes, one block's leaves) of each block group of
    JAX's param tree (`init_params`): the dense and MoE stacks one group
    "blocks" (L); deepseek "block0" (MLA + a dense MLP of dense_ff, no
    axis) and "blocks" (L - 1, MLA + MoE); hybrid "blocks" (G, period) of
    Mamba2 and one "shared_attn" block; xlstm "mlstm_blocks" (G,
    slstm_every - 1) and "slstm_blocks" (G)."""
    f, Lyr = cfg.family, cfg.num_layers
    if f in ("dense", "moe"):
        ffn = (_moe(cfg) if f == "moe"
               else _under("mlp", _mlp_shapes(cfg, cfg.d_ff)))
        return {"blocks": ((Lyr,), _block(cfg, _attn_shapes(cfg), ffn))}
    if f == "deepseek":
        return {"block0": ((), _block(cfg, _mla_shapes(cfg), _under(
                    "mlp", _mlp_shapes(cfg, cfg.dense_ff)))),
                "blocks": ((Lyr - 1,), _block(cfg, _mla_shapes(cfg),
                                              _moe(cfg)))}
    if f == "hybrid":
        per = cfg.hybrid_attn_period
        return {"blocks": ((Lyr // per, per), {
                    **_norm_shapes(cfg, "norm1"),
                    **_under("mamba", SSM.leaf_shapes(cfg))}),
                "shared_attn": ((), _block(cfg, _attn_shapes(cfg), _under(
                    "mlp", _mlp_shapes(cfg, cfg.d_ff))))}
    per = cfg.slstm_every
    return {"mlstm_blocks": ((Lyr // per, per - 1), {
                **_norm_shapes(cfg, "norm1"),
                **_under("mlstm", XL.mlstm_shapes(cfg))}),
            "slstm_blocks": ((Lyr // per,), {
                **_norm_shapes(cfg, "norm1"),
                **_under("slstm", XL.slstm_shapes(cfg))})}


def check_family(cfg: ModelConfig) -> None:
    """The port has every family of JAX's `init_params`: dense, moe,
    deepseek (MLA + MoE), hybrid (Mamba2 + a shared attention block) and
    xlstm (mLSTM + sLSTM)."""
    if cfg.family not in FAMILIES or (cfg.mla and cfg.family != "deepseek"):
        raise NotImplementedError(f"the port has the {FAMILIES} families, "
                                  f"not {cfg.family!r}")


def check_sharded(cfg: ModelConfig) -> None:
    """The sharded serve has the dense family (GQA attention and an MLP);
    the MoE (expert-parallel `w_*_e`), MLA, hybrid and xLSTM families on a
    mesh are ROADMAP A15."""
    check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the sharded serve has the dense family; {cfg.name} "
            f"({cfg.family}) on a mesh is ROADMAP A15")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every parameter leaf (the JAX param tree's key
    paths joined by '/'): the block groups of `_stacks` with their
    leading axes, the embedding (a token table or the embeddings input's
    projection, and the head unless tied) and the final norm."""
    check_family(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    shapes = {f"{prefix}/{k}": lead + v
              for prefix, (lead, blk) in _stacks(cfg).items()
              for k, v in blk.items()}
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


def tree_map(fn, tree, *rest):
    """fn over the leaves of a cache tree (nested dicts and tuples) and of
    `rest`, trees of the same nesting: the same nesting of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _tile(tree, lead: Tuple[int, ...]):
    """Every leaf repeated over new leading axes `lead`, each copy in
    memory of its own."""
    return tree_map(lambda t: t.expand(lead + tuple(t.shape)).clone(), tree)


def _at(tree, idx):
    """The views tree[idx] of every leaf."""
    return tree_map(lambda t: t[idx], tree)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """Empty serving caches (JAX `init_caches`), JAX's tree:
      dense, moe  {"kv": {"k", "v": (L, B, Hkv, T, hd) dtype, "pos": (L, T)
                  int32 at -BIG_WINDOW}}; with gemma2's alternation JAX
                  sizes the local layers' rings at min(cache_len, window)
                  and then allocates every layer at the longest of those;
      deepseek    {"mla0": {"lat": (B, T, r + qk_rope), "pos": (T,)},
                  "mla": the same over (L - 1,)};
      hybrid      {"ssm": (ssm (G, per, B, H, N, hd) f32, (conv_x (G, per,
                  B, K-1, di), conv_bc (G, per, B, K-1, 2N)) f32), "kv":
                  the shared block's ring per group, over (G,)};
      xlstm       {"mlstm": (C (G, per, B, H, hd, hd), n (..., hd), m (G,
                  per, B, H) at -30), "slstm": (c, n, h, m) (G, B, d) at
                  (0, 1, 0, 0)}, all f32."""
    dev = resolve_device(device)
    f, Lyr = cfg.family, cfg.num_layers
    if f in ("dense", "moe"):
        if cfg.local_global_period and cfg.sliding_window:
            lens = [min(cache_len, cfg.sliding_window)
                    if i % cfg.local_global_period == 0 else cache_len
                    for i in range(Lyr)]
            cache_len = max(lens)
        return {"kv": _tile(L.init_kv_cache(cfg, batch, cache_len, dtype,
                                            dev), (Lyr,))}
    if f == "deepseek":
        one = L.init_mla_cache(cfg, batch, cache_len, dtype, dev)
        return {"mla0": one, "mla": _tile(one, (Lyr - 1,))}
    if f == "hybrid":
        per = cfg.hybrid_attn_period
        return {"ssm": _tile(SSM.init_mamba2_cache(cfg, batch, dev),
                             (Lyr // per, per)),
                "kv": _tile(L.init_kv_cache(cfg, batch, cache_len, dtype,
                                            dev), (Lyr // per,))}
    per = cfg.slstm_every
    return {"mlstm": _tile(XL.init_mlstm_cache(cfg, batch, dev),
                           (Lyr // per, per - 1)),
            "slstm": _tile(XL.init_slstm_cache(cfg, batch, dev),
                           (Lyr // per,))}


def _split(parents: np.ndarray, n: int) -> np.ndarray:
    """`prng.split(k, n)` of every key of parents (..., 2) -> (..., n, 2)
    (JAX's split under vmap)."""
    flat = parents.reshape(-1, 2)
    return np.stack([prng.split(k, n) for k in flat]).reshape(
        parents.shape[:-1] + (n, 2))


def init_keys(cfg: ModelConfig, key: np.ndarray
              ) -> Dict[str, Tuple[np.ndarray, Optional[int]]]:
    """name -> (keys, fan_in) of every random leaf, walking the key tree of
    `repro.nn.transformer.init_params`: split(key, 8); ks[0] to
    `init_embedding` (split of 2: the token table, unscaled (fan_in
    None), or the embeddings input's proj from the first, the untied head
    from the second).  A stacked leaf gets one key per block, (*lead, 2)
    (JAX's vmap over split keys, then reshaped); fan_in is `dense_init`'s
    in_axis_size.  The blocks:
      dense, moe  split(ks[1], L), each split in 4: k1 to
                  `init_attention` (split of 4: wq, wk, wv, wo), k2 to
                  `init_moe` (split of 5: router, w_gate, w_up, w_down, and
                  the shared experts' split of 3 from the fifth), k3 to
                  `init_mlp` (split of 3: w_gate, w_up, w_down; without a
                  gate w_up, w_down);
      deepseek    split(ks[1]): `init_mla` (split of 5: wq, w_dkv, w_uk,
                  w_uv, wo) and `init_mlp` at dense_ff for block0; then
                  split(ks[2], L - 1), each split in 2: `init_mla`,
                  `init_moe`;
      hybrid      split(ks[1], L) to `init_mamba2` (split of 8), reshaped
                  (G, period); split(ks[2]): `init_attention` and
                  `init_mlp` of the shared block;
      xlstm       split(ks[1], G * (slstm_every - 1)) to `init_mlstm`
                  (split of 8, 7 used), reshaped (G, slstm_every - 1);
                  split(ks[2], G) to `init_slstm` (split of 3).
    The constant leaves (names in ONES: 1; the rest 0) take no key."""
    d, H = cfg.d_model, cfg.num_heads
    ks = prng.split(key, 8)
    emb = prng.split(ks[0], 2)
    out = ({"embed/tok": (emb[0], None)} if cfg.input_mode == "tokens"
           else {"embed/proj": (emb[0], d)})
    if not cfg.tie_embeddings:
        out["embed/head"] = (emb[1], d)

    def leaves(prefix, parents, names_fans):
        keys = _split(parents, len(names_fans))
        for i, (leaf, fan) in enumerate(names_fans):
            if leaf is not None:
                out[prefix + leaf] = (keys[..., i, :], fan)
        return keys

    def attn(prefix, parents):
        leaves(prefix, parents, (("wq", d), ("wk", d), ("wv", d),
                                 ("wo", H * cfg.head_dim)))

    def mla(prefix, parents):
        r = cfg.kv_lora_rank
        leaves(prefix, parents, (("wq", d), ("w_dkv", d), ("w_uk", r),
                                 ("w_uv", r), ("wo", H * cfg.v_head_dim)))

    def mlp(prefix, parents, ff):
        gate = cfg.mlp in ("swiglu", "geglu")
        leaves(prefix, parents,
               (("w_gate", d), ("w_up", d), ("w_down", ff)) if gate
               else (("w_up", d), ("w_down", ff), (None, None)))

    def moe(prefix, parents):
        mk = leaves(prefix, parents, (("router", d), ("w_gate", d),
                                      ("w_up", d), ("w_down", cfg.moe_ff),
                                      (None, None)))
        if cfg.moe_shared > 0:
            leaves(prefix + "shared/", mk[..., 4, :],
                   (("w_gate", d), ("w_up", d),
                    ("w_down", cfg.moe_ff * cfg.moe_shared)))

    f, Lyr = cfg.family, cfg.num_layers
    if f in ("dense", "moe"):
        per = _split(prng.split(ks[1], Lyr), 4)
        attn("blocks/attn/", per[:, 0])
        if f == "moe":
            moe("blocks/moe/", per[:, 1])
        else:
            mlp("blocks/mlp/", per[:, 2], cfg.d_ff)
    elif f == "deepseek":
        k0 = prng.split(ks[1], 2)
        mla("block0/attn/", k0[0])
        mlp("block0/mlp/", k0[1], cfg.dense_ff)
        per = _split(prng.split(ks[2], Lyr - 1), 2)
        mla("blocks/attn/", per[:, 0])
        moe("blocks/moe/", per[:, 1])
    elif f == "hybrid":
        per = cfg.hybrid_attn_period
        di, cw = cfg.d_inner, cfg.conv_width
        leaves("blocks/mamba/",
               prng.split(ks[1], Lyr).reshape(Lyr // per, per, 2),
               (("w_z", d), ("w_x", d), ("w_B", d), ("w_C", d), ("w_dt", d),
                ("conv_x", cw), ("conv_bc", cw), ("w_out", di)))
        k = prng.split(ks[2], 2)
        attn("shared_attn/attn/", k[0])
        mlp("shared_attn/mlp/", k[1], cfg.d_ff)
    else:
        per = cfg.slstm_every
        G = Lyr // per
        di = int(d * cfg.proj_factor)
        leaves("mlstm_blocks/mlstm/",
               prng.split(ks[1], G * (per - 1)).reshape(G, per - 1, 2),
               (("w_xin", d), ("w_zgate", d), ("w_q", di // H),
                ("w_k", di // H), ("w_v", di // H), ("w_if", di),
                ("w_down", di), (None, None)))
        leaves("slstm_blocks/slstm/", prng.split(ks[2], G),
               (("w_x", d), ("w_h", d), ("w_down", d)))
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
    whose .grad is the matching view of grad.  A device's shard (`specs`:
    name -> spec on a mesh, `layout` then of the shard shapes) serves
    through `sharded_prefill` and `sharded_decode_step` only."""

    def __init__(self, cfg: ModelConfig, layout, theta: torch.Tensor,
                 grad: Optional[torch.Tensor], specs=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.specs = specs
        self.layout = layout
        self.theta, self.grad = theta, grad
        self.stacked = layout.views(theta)
        gviews = layout.views(grad) if grad is not None else None

        def param(name: str, idx: Tuple[int, ...]) -> nn.Parameter:
            def at(v):
                return v[idx] if idx else v
            p = nn.Parameter(at(self.stacked[name]))
            if gviews is not None:
                p.grad = at(gviews[name])
            return p

        # every block group of `_stacks`: one ParameterDict and one nested
        # dict of parameters a block, in the order of its leading axes
        self.layers = nn.ModuleList()
        self.groups: Dict[str, list] = {}
        grouped = set()
        for prefix, (lead, _) in _stacks(cfg).items():
            names = [n for n in layout.names if n.startswith(prefix + "/")]
            grouped.update(names)
            self.groups[prefix] = []
            for idx in itertools.product(*map(range, lead)):
                blk, named = nn.ParameterDict(), {}
                for name in names:
                    leaf = name[len(prefix) + 1:]
                    blk[leaf.replace("/", "_")] = named[leaf] = \
                        param(name, idx)
                self.layers.append(blk)
                self.groups[prefix].append(_nest(named))
        self._blocks = self.groups.get("blocks", [])
        self.top, named = nn.ParameterDict(), {}
        for name in layout.names:
            if name not in grouped:
                self.top[name.replace("/", "_")] = named[name] = \
                    param(name, ())
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
        drawn by `prng.normal_into` on theta's device, one draw a block of
        a stacked leaf); the constant leaves 1 (names in ONES) or 0."""
        keys = init_keys(self.cfg, key)
        for name, v in self.stacked.items():
            if name not in keys:
                v.fill_(1.0 if name.rsplit("/", 1)[-1] in ONES else 0.0)
                continue
            k, fan = keys[name]
            scale = prng.init_scale(fan)
            k = k.reshape(-1, 2)
            rows = v.view(k.shape[0], -1)
            for i in range(k.shape[0]):
                prng.normal_into(rows[i], k[i], scale)

    def _remat(self, fn, *args):
        """fn(*args), rematerialised in the backward pass when cfg.remat
        (JAX's `_maybe_remat` of its scanned blocks)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _attn_ffn(self, x: torch.Tensor, p, window: int = 0):
        """An attention block (GQA, or MLA in the deepseek family) and its
        MLP or MoE: (x, the MoE layer's aux and dropped assignments, or
        None without one)."""
        cfg = self.cfg
        h = L.apply_norm(p["norm1"], x, cfg)
        x = x + (L.mla_train(p["attn"], h, cfg) if cfg.mla
                 else L.attn_train(p["attn"], h, cfg, window=window))
        return self._ffn(x, p)

    def _ffn(self, x: torch.Tensor, p):
        """x + the block's MLP or MoE of norm2(x): (x, the MoE layer's aux
        and dropped assignments, or None without one)."""
        h = L.apply_norm(p["norm2"], x, self.cfg)
        if "moe" in p:
            h, aux, dropped = MOE.apply_moe(p["moe"], h, self.cfg)
            return x + h, aux, dropped
        return x + L.apply_mlp(p["mlp"], h, self.cfg), None, None

    def _mamba(self, x: torch.Tensor, p) -> torch.Tensor:
        return x + SSM.apply_mamba2(
            p["mamba"], L.apply_norm(p["norm1"], x, self.cfg), self.cfg)

    def _mlstm(self, x: torch.Tensor, p) -> torch.Tensor:
        return x + XL.apply_mlstm(
            p["mlstm"], L.apply_norm(p["norm1"], x, self.cfg), self.cfg)

    def _slstm(self, x: torch.Tensor, p) -> torch.Tensor:
        return x + XL.apply_slstm(
            p["slstm"], L.apply_norm(p["norm1"], x, self.cfg), self.cfg)

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """inputs (B, S) tokens or (B, S, d) embeddings -> ((B, S, d) final
        normed hidden states, the MoE aux loss summed over the MoE layers
        from 0 in f32, or None without MoE layers), as JAX's `forward`:
          dense, moe  the L blocks;
          deepseek    block0 (MLA + dense MLP), then the L - 1 MLA + MoE
                      blocks;
          hybrid      G groups of `hybrid_attn_period` Mamba2 blocks, each
                      group followed by the one shared attention block
                      (full causal attention + MLP; its gradient sums over
                      its G uses);
          xlstm       G groups of slstm_every - 1 mLSTM blocks, each
                      followed by the group's sLSTM block.
        The blocks JAX scans are rematerialised in the backward pass when
        cfg.remat (`_remat`); deepseek's block0, the shared block and the
        sLSTM blocks are not, as in JAX.  The MoE layers' dropped
        assignments of this pass (an int64 device scalar, summed over
        layers) are left in `moe_dropped`."""
        cfg = self.cfg
        f = cfg.family
        x = L.embed(self.embed_p, inputs, cfg)
        aux = dropped = None
        if f in ("moe", "deepseek"):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            dropped = torch.zeros((), dtype=torch.int64, device=x.device)
        if f in ("dense", "moe", "deepseek"):
            if f == "deepseek":
                x, _, _ = self._attn_ffn(x, self.groups["block0"][0])
            for p, w in zip(self._blocks, self.windows):    # MLA: no window
                x, a, dr = self._remat(self._attn_ffn, x, p, w)
                if a is not None:
                    aux, dropped = aux + a, dropped + dr
        elif f == "hybrid":
            per = cfg.hybrid_attn_period
            shared = self.groups["shared_attn"][0]
            for g in range(cfg.num_layers // per):
                for p in self._blocks[g * per:(g + 1) * per]:
                    x = self._remat(self._mamba, x, p)
                x, _, _ = self._attn_ffn(x, shared)
        else:
            per = cfg.slstm_every - 1
            mlstm = self.groups["mlstm_blocks"]
            for g, sp in enumerate(self.groups["slstm_blocks"]):
                for p in mlstm[g * per:(g + 1) * per]:
                    x = self._remat(self._mlstm, x, p)
                x = self._slstm(x, sp)
        self.moe_dropped = dropped
        return L.apply_norm(self.final_p, x, cfg), aux

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

    def _norm1(self, x: torch.Tensor, p) -> torch.Tensor:
        return L.apply_norm(p["norm1"], x, self.cfg)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, vocab) logits of x's last position, final-normed."""
        x = L.apply_norm(self.final_p, x[:, -1:], self.cfg)
        return L.logits_from(self.embed_p, x, self.cfg)[:, -1]

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, cache_dtype=torch.bfloat16):
        """Forward over the prompt (JAX `prefill`): inputs (B, S) tokens or
        (B, S, d) embeddings -> (logits of the last position (B, vocab),
        caches of `init_caches`' tree whose length is the prompt's, pos
        0..S-1):
          dense, moe  each block's GQA attention through the flash kernel
                      (`layers.attn_prefill`), its k and v straight into
                      the stacked caches in `cache_dtype`;
          deepseek    MLA over the prompt (plain, as JAX's), each block's
                      latent in `cache_dtype`;
          hybrid      each Mamba2 block's final SSD state (f32) and conv
                      tails (the compute dtype); the shared block's k, v
                      of each group (flash kernel);
          xlstm       each mLSTM block's (C, n, m) and each sLSTM block's
                      (c, n, h, m), f32."""
        cfg = self.cfg
        f, Lyr = cfg.family, cfg.num_layers
        B, S = inputs.shape[:2]
        x = L.embed(self.embed_p, inputs, cfg)
        dev, ct = x.device, x.dtype
        arange = torch.arange(S, dtype=torch.int32, device=dev)

        def kv_cache(n):
            shape = (n, B, cfg.num_kv_heads, S, cfg.head_dim)
            return {"k": torch.empty(shape, dtype=cache_dtype, device=dev),
                    "v": torch.empty(shape, dtype=cache_dtype, device=dev),
                    "pos": arange.repeat(n, 1)}

        def attn(x, p, window, cache):
            h, (k, v) = L.attn_prefill(p["attn"], self._norm1(x, p), cfg,
                                       window=window)
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            return self._ffn(x + h, p)[0]

        def mla(x, p):
            h, lat = L.mla_train(p["attn"], self._norm1(x, p), cfg,
                                 return_lat=True)
            return self._ffn(x + h, p)[0], lat.to(cache_dtype)

        if f in ("dense", "moe"):
            caches = {"kv": kv_cache(Lyr)}
            for l, p in enumerate(self._blocks):
                x = attn(x, p, self.windows[l], _at(caches["kv"], l))
        elif f == "deepseek":
            x, lat0 = mla(x, self.groups["block0"][0])
            lats = torch.empty((Lyr - 1,) + lat0.shape, dtype=cache_dtype,
                               device=dev)
            for l, p in enumerate(self._blocks):
                x, lat = mla(x, p)
                lats[l].copy_(lat)
            caches = {"mla0": {"lat": lat0, "pos": arange},
                      "mla": {"lat": lats, "pos": arange.repeat(Lyr - 1, 1)}}
        elif f == "hybrid":
            per = cfg.hybrid_attn_period
            G = Lyr // per
            states, shared = [], self.groups["shared_attn"][0]
            caches = {"kv": kv_cache(G)}
            for g in range(G):
                for p in self._blocks[g * per:(g + 1) * per]:
                    h, st = SSM.mamba2(p["mamba"], self._norm1(x, p), cfg)
                    x = x + h
                    states.append(st)
                x = attn(x, shared, 0, _at(caches["kv"], g))
            caches["ssm"] = _stacked(states, (G, per))
        else:
            per = cfg.slstm_every - 1
            m_states, s_states = [], []
            mlstm = self.groups["mlstm_blocks"]
            for g, sp in enumerate(self.groups["slstm_blocks"]):
                for p in mlstm[g * per:(g + 1) * per]:
                    h, st = XL.mlstm(p["mlstm"], self._norm1(x, p), cfg)
                    x = x + h
                    m_states.append(st)
                h, st = XL.slstm(sp["slstm"], self._norm1(x, sp), cfg)
                x = x + h
                s_states.append(st)
            G = len(s_states)
            caches = {"mlstm": _stacked(m_states, (G, per)),
                      "slstm": _stacked(s_states, (G,))}
        return self._logits(x), caches

    @torch.no_grad()
    def decode_step(self, caches, inputs: torch.Tensor, pos: int):
        """One-token decode (JAX `decode_step`): inputs (B, 1) tokens or
        (B, 1, d) embeddings at absolute position `pos` (a host int).
        Every cache is updated IN PLACE (the GQA and MLA rings write slot
        pos % T, the recurrent states are overwritten), so the buffers stay
        fixed from step to step; an f32 conv tail from `init_caches` keeps
        its dtype and takes the compute dtype's values, which JAX's tree
        carries in the compute dtype.  Returns (logits (B, vocab),
        caches)."""
        cfg = self.cfg
        f = cfg.family
        x = L.embed(self.embed_p, inputs, cfg)
        if f in ("dense", "moe"):
            for l, p in enumerate(self._blocks):
                x = x + L.attn_decode(p["attn"], self._norm1(x, p), cfg,
                                      _at(caches["kv"], l), pos,
                                      window=self.windows[l])
                x = self._ffn(x, p)[0]
        elif f == "deepseek":
            blocks = [(self.groups["block0"][0], caches["mla0"])] + \
                [(p, _at(caches["mla"], l))
                 for l, p in enumerate(self._blocks)]
            for p, cache in blocks:
                x = x + L.mla_decode(p["attn"], self._norm1(x, p), cfg,
                                     cache, pos)
                x = self._ffn(x, p)[0]
        elif f == "hybrid":
            per = cfg.hybrid_attn_period
            shared = self.groups["shared_attn"][0]
            for g in range(cfg.num_layers // per):
                for i in range(per):
                    p, st = self._blocks[g * per + i], \
                        _at(caches["ssm"], (g, i))
                    h, new = SSM.mamba2(p["mamba"], self._norm1(x, p), cfg,
                                        ssm_state=st[0], conv_state=st[1])
                    tree_map(torch.Tensor.copy_, st, new)
                    x = x + h
                x = x + L.attn_decode(shared["attn"], self._norm1(x, shared),
                                      cfg, _at(caches["kv"], g), pos)
                x = self._ffn(x, shared)[0]
        else:
            per = cfg.slstm_every - 1
            mlstm = self.groups["mlstm_blocks"]
            for g, sp in enumerate(self.groups["slstm_blocks"]):
                for i, p in enumerate(mlstm[g * per:(g + 1) * per]):
                    st = _at(caches["mlstm"], (g, i))
                    h, new = XL.mlstm(p["mlstm"], self._norm1(x, p), cfg,
                                      state=st)
                    tree_map(torch.Tensor.copy_, st, new)
                    x = x + h
                st = _at(caches["slstm"], g)
                h, new = XL.slstm(sp["slstm"], self._norm1(x, sp), cfg,
                                  state=st)
                tree_map(torch.Tensor.copy_, st, new)
                x = x + h
        return self._logits(x), caches


def _leaf_specs(specs: Dict[str, tuple]) -> Tuple[Dict, Dict]:
    """(a block's leaf specs nested as its params (the stack dim dropped),
    the embedding's leaf specs) of a dense stack's `specs`."""
    blk = {n[len("blocks/"):]: s[1:] for n, s in specs.items()
           if n.startswith("blocks/")}
    emb = {n[len("embed/"):]: s for n, s in specs.items()
           if n.startswith("embed/")}
    return _nest(blk), emb


def _mesh():
    mesh = ctx.active_mesh()
    if mesh is None:
        raise RuntimeError("the sharded serve runs under "
                           "sharding.ctx.use_mesh(mesh)")
    return mesh


def _sharded_block(mesh, nets, l: int, xs, bs, attn):
    """Block l of every device's stack: norm1, attention (`attn(ps, hs)`
    -> the outputs a device), the residual, norm2, the sharded MLP, the
    residual; each add made once a distinct pair of tensors
    (`layers.each_distinct`)."""
    cfg = nets[0].cfg
    ps = [n._blocks[l] for n in nets]
    hs = [L.apply_norm(p["norm1"], x, cfg) for p, x in zip(ps, xs)]
    xs = L.each_distinct(torch.add, xs, attn([p["attn"] for p in ps], hs))
    hs = [L.apply_norm(p["norm2"], x, cfg) for p, x in zip(ps, xs)]
    return L.each_distinct(torch.add, xs, L.apply_mlp_sharded(
        mesh, [p["mlp"] for p in ps], bs["mlp"], hs, cfg))


def _sharded_logits(mesh, nets, xs, emb):
    cfg = nets[0].cfg
    last = [L.apply_norm(n.final_p, x[:, -1:], cfg) for n, x in zip(nets,
                                                                    xs)]
    return [t[:, -1] for t in L.logits_sharded(
        mesh, [n.embed_p for n in nets], emb, last, cfg)]


@torch.no_grad()
def sharded_prefill(nets, inputs, cache_dtype=torch.bfloat16):
    """The dense `prefill` over the active mesh: `nets` a `Transformer`
    shard a local device (mesh.indices order), `inputs` each device's
    batch block (B_loc, S) tokens or (B_loc, S, d) embeddings.  Returns
    (each device's logits block (B_loc, vocab / model where it divides),
    each device's caches {"kv": {"k", "v": (L, B_loc, KV heads, S,
    head_dim) of `layers.kv_block_dims`, "pos": (L, S)}})."""
    mesh = _mesh()
    cfg = nets[0].cfg
    check_sharded(cfg)
    bs, emb = _leaf_specs(nets[0].specs)
    xs = L.embed_sharded(mesh, [n.embed_p for n in nets], emb, inputs, cfg)
    Lyr, S = cfg.num_layers, inputs[0].shape[1]
    hk, width = L.kv_block_dims(cfg, mesh)
    caches = []
    for x in xs:
        shape = (Lyr, x.shape[0], hk, S, width)
        caches.append({"kv": {
            "k": torch.empty(shape, dtype=cache_dtype, device=x.device),
            "v": torch.empty(shape, dtype=cache_dtype, device=x.device),
            "pos": torch.arange(S, dtype=torch.int32,
                                device=x.device).repeat(Lyr, 1)}})
    for l in range(Lyr):
        def attn(ps, hs, l=l):
            ys, kvs = L.attn_prefill_sharded(mesh, ps, bs["attn"], hs, cfg,
                                             window=nets[0].windows[l])
            for c, (k, v) in zip(caches, kvs):
                c["kv"]["k"][l].copy_(k)
                c["kv"]["v"][l].copy_(v)
            return ys
        xs = _sharded_block(mesh, nets, l, xs, bs, attn)
    return _sharded_logits(mesh, nets, xs, emb), caches


@torch.no_grad()
def sharded_decode_step(nets, caches, inputs, pos: int):
    """The dense `decode_step` over the active mesh: each device's caches
    (`sharded_prefill`'s tree) updated in place at slot pos % T, inputs
    each device's (B_loc, 1) tokens or (B_loc, 1, d) embeddings.  Returns
    (each device's logits block, caches)."""
    mesh = _mesh()
    cfg = nets[0].cfg
    check_sharded(cfg)
    bs, emb = _leaf_specs(nets[0].specs)
    xs = L.embed_sharded(mesh, [n.embed_p for n in nets], emb, inputs, cfg)
    for l in range(cfg.num_layers):
        def attn(ps, hs, l=l):
            return L.attn_decode_sharded(
                mesh, ps, bs["attn"], hs, cfg,
                [_at(c["kv"], l) for c in caches], pos,
                window=nets[0].windows[l])
        xs = _sharded_block(mesh, nets, l, xs, bs, attn)
    return _sharded_logits(mesh, nets, xs, emb), caches


def _stacked(states: list, lead: Tuple[int, ...]):
    """Per-block state trees (tuples) stacked over `lead` (JAX's scan
    outputs, then its stack over groups)."""
    if isinstance(states[0], tuple):
        return tuple(_stacked([s[j] for s in states], lead)
                     for j in range(len(states[0])))
    return torch.stack(states).view(lead + tuple(states[0].shape))

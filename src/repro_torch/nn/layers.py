"""Dense layers in the JAX package's layouts (port of `repro.nn.layers`):
RMSNorm and LayerNorm, RoPE, GQA attention with optional qkv bias,
deepseek-v2's MLA (training, prefill and decode against a latent ring),
the swiglu, geglu, relu2 and gelu MLPs, token or embeddings input, a tied
or untied head; and the sharded forms of the dense family's serving
layers (the end of the module).

Layouts match JAX: wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H, hd, d),
bq (H, hd), bk/bv (Hkv, hd), w_gate/w_up (d, ff), w_down (ff, d),
proj (d, d), head (d, vocab); MLA's wq (d, H, qk_nope + qk_rope),
w_dkv (d, r + qk_rope), w_uk (r, H, qk_nope), w_uv (r, H, v), wo (H, v,
d), kv_norm (r,); products written x @ W.  Parameters
are stored in cfg.param_dtype (f32 or bf16) and cast where JAX casts them:
to the compute dtype at use (a no-op for bf16 parameters under bf16
compute), to f32 where the math is f32 (the norms' scales and biases, the
MoE router, the SSM's A_log, dt_bias and norm_scale, MLA's kv_norm, the
sLSTM's w_h and b), so each gradient comes back in its leaf's dtype
through the cast, rounded once, as JAX's does; compute runs in cfg.dtype.
Training attention is plain einsum + softmax, as JAX's XLA path is.  The
prefill runs the hand-written flash kernel (`kernels.flash_attention`), as
JAX's `attn_train` docstring says its Pallas kernel does on real hardware;
the decode step attends plain against the whole KV cache, as JAX's does.

Scalars that JAX multiplies as weakly typed Python floats are rounded to
the compute dtype first (`_cs`), as JAX does; torch would otherwise keep
them in f32 inside the op and round the product differently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import rules
from .config import ModelConfig

BIG_WINDOW = 1 << 30  # "no window" sentinel
NEG_INF = -1e30


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _cs(v: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python float as a 0-dim CPU tensor of `dtype` (a weak scalar)."""
    return torch.tensor(v, dtype=dtype)


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6
               ) -> torch.Tensor:
    """In f32, rounded to x's dtype: LayerNorm (cfg.norm "layer")
    (x - mean) * rsqrt(var + eps) * scale + bias, else RMSNorm
    x * rsqrt(mean(x^2) + eps) * scale (not 1+scale).  p: {"scale"[,
    "bias"]}."""
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        xc = xf - mu
        var = (xc * xc).mean(-1, keepdim=True)
        out = xc * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Rotation in f32 (bf16 x f32 promotes), result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** expo)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv(p, x, cfg: ModelConfig, positions):
    ct = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(ct))
    if cfg.qkv_bias:
        q = q + p["bq"].to(ct)
        k = k + p["bk"].to(ct)
        v = v + p["bv"].to(ct)
    q = rope(q, positions, cfg.rope_theta) * _cs(cfg.head_dim ** -0.5, ct)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return scores
    c = _cs(cap, scores.dtype)
    return c * torch.tanh(scores / c)


def _attn_core(q, k, v, cfg: ModelConfig, q_pos, k_pos, w_eff: int):
    """Scores + softmax (f32) + values for q against the full k/v."""
    B, Sq = q.shape[:2]
    ct = q.dtype
    groups = cfg.num_heads // cfg.num_kv_heads
    keep = (k_pos[None, :] <= q_pos[:, None]) & \
           (k_pos[None, :] > q_pos[:, None] - w_eff)              # (Sq, St)
    qh = q.reshape(B, Sq, cfg.num_kv_heads, groups, cfg.head_dim)
    scores = torch.einsum("bsngk,btnk->bsngt", qh, k)
    scores = _softcap(scores, cfg.attn_softcap)
    scores = torch.where(keep[None, :, None, None, :], scores, NEG_INF)
    wts = torch.softmax(scores.float(), dim=-1).to(ct)
    out = torch.einsum("bsngt,btnk->bsngk", wts, v)
    return out.reshape(B, Sq, cfg.num_heads, cfg.head_dim)


def attn_train(p, x, cfg: ModelConfig, window: int = 0) -> torch.Tensor:
    """Full causal self-attention; window 0 = global."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos[None])
    w_eff = window if window > 0 else BIG_WINDOW
    out = _attn_core(q, k, v, cfg, pos, pos, w_eff)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def attn_prefill(p, x, cfg: ModelConfig, window: int = 0):
    """Causal self-attention over the prompt through the flash kernel (JAX
    `attn_train(..., return_kv=True)`).  Returns (y, (k, v)) with k, v in
    cache layout (B, Hkv, S, hd).  Forward only: run it without autograd."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos[None])
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(q.transpose(1, 2).contiguous(), k, v,
                              softcap=cfg.attn_softcap, window=window,
                              groups=cfg.num_heads // cfg.num_kv_heads)
    y = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2),
                     p["wo"].to(x.dtype))
    return y, (k, v)


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype: torch.dtype, device: torch.device):
    """An empty ring cache: k, v (B, Hkv, T, hd) zeros, pos (T,) int32 at
    -BIG_WINDOW (no slot holds a position yet)."""
    shape = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((cache_len,), -BIG_WINDOW, dtype=torch.int32,
                              device=device)}


def attn_decode(p, x, cfg: ModelConfig, cache, pos: int, window: int = 0
                ) -> torch.Tensor:
    """One-step decode (JAX `attn_decode`): x (B, 1, d) at absolute
    position `pos` (a host int).  Writes k, v and pos into ring slot
    pos % T of `cache` IN PLACE (JAX returns new caches; a copy of the
    full-size caches per token would move 3.9 GB), then attends plain
    against the whole cache, keeping slots with pos - window < cpos <=
    pos."""
    ct = x.dtype
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    q, k, v = _qkv(p, x, cfg, torch.full((1, 1), pos, device=x.device))
    slot = pos % ck.shape[2]
    ck[:, :, slot] = k[:, 0]
    cv[:, :, slot] = v[:, 0]
    cpos[slot] = pos
    w_eff = window if window > 0 else BIG_WINDOW
    out = _attend_ring(q, ck, cv, cpos, pos, w_eff, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ct))


def _attend_ring(q, ck, cv, cpos, pos: int, w_eff: int, cfg: ModelConfig
                 ) -> torch.Tensor:
    """One position's queries q (B, 1, Hq, hd) against a ring (B, Hk, T,
    hd) (query head h reads kv head h // (Hq / Hk)), keeping slots with
    pos - w_eff < cpos <= pos: (B, 1, Hq, hd)."""
    B, _, Hq, hd = q.shape
    ct = q.dtype
    Hk = ck.shape[1]
    qh = q.reshape(B, 1, Hk, Hq // Hk, hd)
    scores = torch.einsum("bsngk,bntk->bsngt", qh, ck.to(ct))
    wts = _ring_weights(scores, cpos, pos, w_eff, cfg)
    out = torch.einsum("bsngt,bntk->bsngk", wts, cv.to(ct))
    return out.reshape(B, 1, Hq, hd)


def _ring_weights(scores, cpos, pos: int, w_eff: int, cfg: ModelConfig):
    """Softcapped ring scores (B, 1, Hk, groups, T) to softmax weights in
    their dtype (the softmax in f32), slots outside pos - w_eff < cpos <=
    pos masked."""
    keep = (cpos <= pos) & (cpos > pos - w_eff)                   # (T,)
    scores = torch.where(keep, _softcap(scores, cfg.attn_softcap), NEG_INF)
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)


def prefill_kv(p, x, cfg: ModelConfig, cache_len: int,
               dtype: torch.dtype = torch.bfloat16):
    """A ring cache built from a whole prompt x (B, S, d) (JAX
    `prefill_kv`; no entry point of either package calls it): k and v of
    positions sel = the trailing cache_len when S >= cache_len, else
    arange(cache_len) % S, ordered by ring slot sel % cache_len (a stable
    sort), in `dtype`; pos holds sel in that order for the first
    min(S, cache_len) slots and -BIG_WINDOW after.  For S < cache_len this
    is JAX's layout too: slot j holds the position the sort puts there,
    which repeats positions (0, 0, ..., 1, 1, ...), not slot j = position
    j."""
    S = x.shape[1]
    _, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device)[None])
    if S >= cache_len:
        sel = torch.arange(S - cache_len, S, device=x.device)
    else:
        sel = torch.arange(cache_len, device=x.device) % max(S, 1)
    sel = sel[torch.argsort(sel % cache_len, stable=True)]
    pos = torch.where(torch.arange(cache_len, device=x.device)
                      < min(S, cache_len), sel, -BIG_WINDOW)
    return {"k": k.transpose(1, 2)[:, :, sel].to(dtype),
            "v": v.transpose(1, 2)[:, :, sel].to(dtype),
            "pos": pos.to(torch.int32)}


def mla_latent(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """MLA's compressed latent [c_kv ; k_rope] (B, S, r + qk_rope) (JAX
    `_mla_latent`): x @ w_dkv, c_kv RMS-normed in f32 by kv_norm, k_rope
    rotated once for every head."""
    ct = x.dtype
    r = cfg.kv_lora_rank
    ckv = x @ p["w_dkv"].to(ct)
    c, k_rope = ckv[..., :r], ckv[..., r:]
    cf = c.float()
    c = (cf * torch.rsqrt((cf * cf).mean(-1, keepdim=True) + 1e-6)
         * p["kv_norm"].float()).to(ct)
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return torch.cat([c, k_rope], dim=-1)


def mla_attend(p, x, lat, cfg: ModelConfig, positions, keep
               ) -> torch.Tensor:
    """Attention of x's queries against the latent `lat` (JAX
    `_mla_attend`): k_nope and v expanded from c_kv per head, scores
    (q_nope . k_nope + q_rope . k_rope) * (qk_nope + qk_rope)^-0.5 in the
    compute dtype, masked by keep (1, S, T), softmax in f32, the weights
    back in the compute dtype; v's width (v_head_dim) is not q.k's."""
    ct = x.dtype
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_all, krope_all = lat[..., :r], lat[..., r:]
    k_nope = torch.einsum("btr,rhk->bthk", c_all, p["w_uk"].to(ct))
    v = torch.einsum("btr,rhk->bthk", c_all, p["w_uv"].to(ct))
    scale = _cs((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5, ct)
    scores = (torch.einsum("bshk,bthk->bsht", q_nope, k_nope)
              + torch.einsum("bshk,btk->bsht", q_rope, krope_all)) * scale
    scores = torch.where(keep[:, :, None, :], scores, NEG_INF)
    wts = torch.softmax(scores.float(), dim=-1).to(ct)
    out = torch.einsum("bsht,bthk->bshk", wts, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ct))


def mla_train(p, x, cfg: ModelConfig, return_lat: bool = False):
    """Full causal MLA over x (B, S, d) (JAX `mla_train`); return_lat=True
    also returns the latent (B, S, r + qk_rope) for the prefill's cache."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    lat = mla_latent(p, x, cfg, pos[None])
    keep = (pos[None, :] <= pos[:, None])[None]                  # (1,S,S)
    y = mla_attend(p, x, lat, cfg, pos[None], keep)
    return (y, lat) if return_lat else y


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype: torch.dtype, device: torch.device):
    """An empty latent ring (JAX `init_mla_cache`): lat (B, T, r + qk_rope)
    zeros, pos (T,) int32 at -BIG_WINDOW."""
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    return {"lat": torch.zeros((batch, cache_len, width), dtype=dtype,
                               device=device),
            "pos": torch.full((cache_len,), -BIG_WINDOW, dtype=torch.int32,
                              device=device)}


def mla_decode(p, x, cfg: ModelConfig, cache, pos: int) -> torch.Tensor:
    """One-step MLA decode (JAX `mla_decode`): x (B, 1, d) at absolute
    position `pos`.  Writes the token's latent and pos into ring slot
    pos % T of `cache` in place, then attends against the whole latent
    (cast to the compute dtype), keeping slots with pos - BIG_WINDOW <
    cpos <= pos (the empty slots' sentinel drops out)."""
    lat, cpos = cache["lat"], cache["pos"]
    at = torch.full((1, 1), pos, device=x.device)
    slot = pos % lat.shape[1]
    lat[:, slot] = mla_latent(p, x, cfg, at)[:, 0]
    cpos[slot] = pos
    keep = ((cpos <= pos) & (cpos > pos - BIG_WINDOW))[None, None]  # (1,1,T)
    return mla_attend(p, x, lat.to(x.dtype), cfg, at, keep)


def mla_prefill(p, x, cfg: ModelConfig, cache_len: int,
                dtype: torch.dtype = torch.bfloat16):
    """A latent ring built from a whole prompt x (B, S, d) (JAX
    `mla_prefill`; called by no entry point): the latents of the last
    take = min(S, cache_len) positions in slots 0..take-1 (in `dtype`,
    zeros after), pos = slot + S - take there and -BIG_WINDOW after."""
    B, S, _ = x.shape
    lat = mla_latent(p, x, cfg, torch.arange(S, device=x.device)[None])
    take = min(S, cache_len)
    out = torch.zeros((B, cache_len, lat.shape[-1]), dtype=dtype,
                      device=x.device)
    out[:, :take] = lat[:, S - take:].to(dtype)
    slots = torch.arange(cache_len, device=x.device)
    pos = torch.where(slots < take, slots + (S - take), -BIG_WINDOW)
    return {"lat": out, "pos": pos.to(torch.int32)}


def apply_mlp(p, x, cfg: ModelConfig) -> torch.Tensor:
    """cfg.mlp: swiglu silu(x Wg) * x Wu, geglu gelu(x Wg) * x Wu, relu2
    relu(x Wu)^2, gelu gelu(x Wu); then @ W_down.  jax.nn.gelu defaults to
    the tanh approximation, hence approximate="tanh"."""
    ct = x.dtype
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"].to(ct)) * (x @ p["w_up"].to(ct))
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"].to(ct), approximate="tanh") * \
            (x @ p["w_up"].to(ct))
    elif cfg.mlp == "relu2":
        h = F.relu(x @ p["w_up"].to(ct)).square()
    elif cfg.mlp == "gelu":
        h = F.gelu(x @ p["w_up"].to(ct), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return h @ p["w_down"].to(ct)


def embed(p, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token input: the table p["tok"] cast to the compute dtype, then
    gathered (the JAX order, so its gradient also sums in the compute
    dtype); Gemma scales by sqrt(d_model) in the compute dtype.
    Embeddings input (B, S, d): cast, then @ p["proj"]."""
    ct = compute_dtype(cfg)
    if cfg.input_mode != "tokens":
        return inputs.to(ct) @ p["proj"].to(ct)
    x = p["tok"].to(ct)[inputs]
    if cfg.name.startswith("gemma"):
        x = x * _cs(cfg.d_model ** 0.5, ct)
    return x


def logits_from(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x @ tok^T (tied) or x @ head, then the final softcap in the compute
    dtype."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return _softcap(x @ w.to(x.dtype), cfg.final_softcap)


# --------------------------------------------------------------------------
# the sharded serve: the dense layers over a `launch.mesh.DeviceMesh`
# --------------------------------------------------------------------------
#
# Each function takes one entry a local device (in mesh.indices order): its
# block of the layer's leaves (laid out by `specs`, `rules.param_specs`
# on the mesh, the stack dims dropped) and its input, the residual stream
# replicated over the model axis and the batch over the data axes.  The
# query and KV heads go over the model axis where they divide it (`wq`,
# `wk`, `wv` column blocks, `wo` row blocks summed by `sum_ordered`), the
# MLP's w_gate / w_up as column blocks and w_down as row blocks.  A leaf
# whose spec the layer does not compute with (where `_check_divisible`
# moved the model axis to another dim: phi3's 10 KV heads on model 4 put
# it on head_dim) is gathered over the model axis first and cut as the
# layer needs, as GSPMD gathers it.  The prefill's attention is the flash
# kernel on each device's heads, one launch a device.

MODEL = "model"


def each_distinct(fn, *lists):
    """fn over the devices' arguments, made once for each distinct tuple
    of argument objects (in-process, the devices of one model group share
    their replicated tensors)."""
    seen, out = {}, []
    for args in zip(*lists):
        key = tuple(map(id, args))
        if key not in seen:
            seen[key] = fn(*args)
        out.append(seen[key])
    return out


def _gathered(mesh, parts, spec, dim=None):
    """Each device's whole leaf from its model group's blocks (`spec`
    shards it over the model axis only, as every non-FSDP spec does), or
    the blocks themselves where `spec` does not shard it."""
    if MODEL not in tuple(spec):
        return list(parts)
    d = tuple(spec).index(MODEL) if dim is None else dim
    groups = mesh.gather(parts, MODEL)          # a device: its group's parts
    return each_distinct(lambda *g: torch.cat(g, d), *zip(*groups))


def _as(mesh, ps, specs, want):
    """The devices' leaf dicts with each leaf of `want` laid out by its
    spec there: the block itself where the specs agree, else cut from the
    leaf gathered over the model axis (`_gathered`)."""
    out = [dict(p) for p in ps]
    for name, w in want.items():
        if name not in specs or tuple(specs[name]) == tuple(w):
            continue
        full = _gathered(mesh, [p[name] for p in ps], specs[name])
        for o, f, i in zip(out, full, mesh.indices):
            o[name] = rules.shard_of(f, w, mesh.layout, i)
    return out


def _split(on: bool, nd: int, dim: int) -> tuple:
    return tuple(MODEL if on and i == dim else None for i in range(nd))


def head_plan(cfg: ModelConfig, mesh):
    """(heads, kv, want): whether the query heads split over the model
    axis, whether the KV heads do (`rules.kv_heads_split`, the ring
    layout C17), and the spec each attention leaf is computed with."""
    heads = cfg.num_heads % mesh.size(MODEL) == 0
    kv = rules.kv_heads_split(cfg, mesh.layout)
    want = {"wq": _split(heads, 3, 1), "bq": _split(heads, 2, 0),
            "wo": _split(heads, 3, 0), "wk": _split(kv, 3, 1),
            "wv": _split(kv, 3, 1), "bk": _split(kv, 2, 0),
            "bv": _split(kv, 2, 0)}
    return heads, kv, want


def _query_heads(cfg: ModelConfig, mesh, index: int, heads: bool) -> range:
    if not heads:
        return range(cfg.num_heads)
    n = cfg.num_heads // mesh.size(MODEL)
    c = mesh.coords(index).get(MODEL, 0)
    return range(c * n, (c + 1) * n)


def _kv_for(k, v, qh: range, groups: int):
    """The KV heads (dim 1 of k, v) the query heads qh read, contiguous,
    and the group ratio between them: a run of whole groups, one KV head
    under all of qh, or (neither) one KV head a query head."""
    first, n = qh.start, len(qh)
    if first % groups == 0 and n % groups == 0:
        sl, g = slice(first // groups, (first + n) // groups), groups
    elif first // groups == (first + n - 1) // groups:
        sl, g = slice(first // groups, first // groups + 1), n
    else:
        idx = torch.tensor([h // groups for h in qh], device=k.device)
        return k.index_select(1, idx), v.index_select(1, idx), 1
    return k[:, sl].contiguous(), v[:, sl].contiguous(), g


def _hd_block(t, mesh, index: int, width: int):
    """Device `index`'s block of t's last dim (head_dim) where its ring
    holds `width` of it (head_dim over the model axis), else t."""
    if width == t.shape[-1]:
        return t
    c = mesh.coords(index).get(MODEL, 0)
    return t.narrow(-1, c * width, width)


def kv_block_dims(cfg: ModelConfig, mesh) -> tuple:
    """(KV heads, head_dim) of one device's ring (`rules.ring_spec`)."""
    shape = rules.shard_shape((1, 1, cfg.num_kv_heads, 1, cfg.head_dim),
                              rules.ring_spec(cfg, mesh.layout), mesh.layout)
    return shape[2], shape[4]


def attn_prefill_sharded(mesh, ps, specs, hs, cfg: ModelConfig,
                         window: int = 0):
    """`attn_prefill` on each device: its query heads through the flash
    kernel (one launch a device; with the KV heads split, its own KV
    heads, else every KV head from the gathered wk / wv and the ones its
    query heads read), wo's row block, the partial outputs summed over
    the model axis.  Returns (y a device, (k, v) a device in its ring's
    layout (B, KV heads, S, head_dim) of `kv_block_dims`)."""
    heads, kv, want = head_plan(cfg, mesh)
    groups = cfg.num_heads // cfg.num_kv_heads
    width = kv_block_dims(cfg, mesh)[1]
    ys, kvs = [], []
    for p, x, i in zip(_as(mesh, ps, specs, want), hs, mesh.indices):
        S = x.shape[1]
        q, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device)[None])
        k = k.transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        if kv:
            kq, vq, g = k, v, groups
        else:
            kq, vq, g = _kv_for(k, v, _query_heads(cfg, mesh, i, heads),
                                groups)
        out = ops.flash_attention(q.transpose(1, 2).contiguous(), kq, vq,
                                  softcap=cfg.attn_softcap, window=window,
                                  groups=g)
        del q, kq, vq
        ys.append(torch.einsum("bshk,hkd->bsd", out.transpose(1, 2),
                               p["wo"].to(x.dtype)))
        kvs.append((_hd_block(k, mesh, i, width),
                    _hd_block(v, mesh, i, width)))
    return (mesh.sum_ordered(ys, MODEL) if heads else ys), kvs


def attn_decode_sharded(mesh, ps, specs, hs, cfg: ModelConfig, caches,
                        pos: int, window: int = 0):
    """`attn_decode` on each device: k, v and pos written into slot
    pos % T of its ring block (`caches`: a {"k", "v", "pos"} a device) in
    place, then its query heads attend plain against its ring
    (`_attend_ring_hd` where the ring holds a block of head_dim), wo's
    row block, the partial outputs summed over the model axis."""
    heads, kv, want = head_plan(cfg, mesh)
    groups = cfg.num_heads // cfg.num_kv_heads
    w_eff = window if window > 0 else BIG_WINDOW
    ps = _as(mesh, ps, specs, want)
    qs = []
    for p, x, c, i in zip(ps, hs, caches, mesh.indices):
        q, k, v = _qkv(p, x, cfg, torch.full((1, 1), pos, device=x.device))
        slot = pos % c["k"].shape[2]
        width = c["k"].shape[-1]
        c["k"][:, :, slot] = _hd_block(k[:, 0], mesh, i, width)
        c["v"][:, :, slot] = _hd_block(v[:, 0], mesh, i, width)
        c["pos"][slot] = pos
        qs.append(q)
    if caches[0]["k"].shape[-1] != cfg.head_dim:
        outs = _attend_ring_hd(mesh, qs, caches, pos, w_eff, cfg, heads)
    else:
        outs = []
        for q, c, i in zip(qs, caches, mesh.indices):
            ck, cv = c["k"], c["v"]
            if not kv:
                ck, cv, _ = _kv_for(ck, cv, _query_heads(cfg, mesh, i, heads),
                                    groups)
            outs.append(_attend_ring(q, ck, cv, c["pos"], pos, w_eff, cfg))
    ys = [torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
          for p, out in zip(ps, outs)]
    return mesh.sum_ordered(ys, MODEL) if heads else ys


def _attend_ring_hd(mesh, qs, caches, pos: int, w_eff: int, cfg: ModelConfig,
                    heads: bool):
    """`_attend_ring` where each device's ring holds a block of head_dim
    (C17's fallback), the ring staying where it is: every query head's
    partial scores over the device's block, summed over the model axis
    (`sum_ordered`), the softmax, the weights times the device's v block,
    and those gathered over the model axis along head_dim.  What moves a
    token and layer is the queries (where the heads split), the (B, H, T)
    scores and the (B, H, hd) outputs, not the ring.  Returns each
    device's outputs (B, 1, its query heads, hd)."""
    if heads:
        qs = _gathered(mesh, qs, (None, None, MODEL, None))
    B, _, Hq, _ = qs[0].shape
    ct = qs[0].dtype
    Hk, width = caches[0]["k"].shape[1], caches[0]["k"].shape[-1]
    parts = []
    for q, c, i in zip(qs, caches, mesh.indices):
        qh = _hd_block(q, mesh, i, width).reshape(B, 1, Hk, Hq // Hk, width)
        parts.append(torch.einsum("bsngk,bntk->bsngt", qh, c["k"].to(ct)))
    outs = []
    for s, c in zip(mesh.sum_ordered(parts, MODEL), caches):
        wts = _ring_weights(s, c["pos"], pos, w_eff, cfg)
        outs.append(torch.einsum("bsngt,bntk->bsngk", wts, c["v"].to(ct))
                    .reshape(B, 1, Hq, width))
    full = _gathered(mesh, outs, (None, None, None, MODEL))
    if not heads:
        return full
    out = []
    for f, i in zip(full, mesh.indices):
        qh = _query_heads(cfg, mesh, i, heads)
        out.append(f[:, :, qh.start:qh.stop])
    return out


def apply_mlp_sharded(mesh, ps, specs, hs, cfg: ModelConfig):
    """`apply_mlp` on each device's column blocks of w_gate / w_up and row
    block of w_down (where d_ff divides the model axis), the partial
    outputs summed over it."""
    split = cfg.d_ff % mesh.size(MODEL) == 0
    want = {"w_gate": _split(split, 2, 1), "w_up": _split(split, 2, 1),
            "w_down": _split(split, 2, 0)}
    ys = [apply_mlp(p, h, cfg) for p, h in zip(_as(mesh, ps, specs, want),
                                                  hs)]
    return mesh.sum_ordered(ys, MODEL) if split else ys


def embed_sharded(mesh, ps, specs, inputs, cfg: ModelConfig):
    """`embed` on each device's inputs (its batch block): a table of
    vocabulary rows (tied, (model, None)) looks up the tokens in its
    range, zeros elsewhere, summed over the model axis (exact: one term
    is nonzero); a table or proj of d columns ((None, model)) gives its
    columns, gathered over the model axis."""
    ct = compute_dtype(cfg)
    name = "tok" if cfg.input_mode == "tokens" else "proj"
    spec = tuple(specs[name])
    if name == "tok" and spec[0] == MODEL:
        parts = []
        for p, inp, i in zip(ps, inputs, mesh.indices):
            n = p["tok"].shape[0]
            local = inp.long() - mesh.coords(i).get(MODEL, 0) * n
            inside = (local >= 0) & (local < n)
            x = p["tok"].to(ct)[local.clamp(0, n - 1)]
            parts.append(torch.where(inside[..., None], x, 0.0))
        xs = mesh.sum_ordered(parts, MODEL)
    else:
        parts = [inp.to(ct) @ p["proj"].to(ct) if name == "proj" else
                 p["tok"].to(ct)[inp.long()] for p, inp in zip(ps, inputs)]
        xs = _gathered(mesh, parts, spec, dim=-1)
    if name == "tok" and cfg.name.startswith("gemma"):
        xs = each_distinct(lambda x: x * _cs(cfg.d_model ** 0.5, ct), xs)
    return xs


def logits_sharded(mesh, ps, specs, xs, cfg: ModelConfig):
    """`logits_from` on each device: vocabulary-sharded logits (the
    device's columns of the head, or rows of the tied table) where the
    vocabulary divides the model axis, JAX's `vshard`; else the head's
    rows of d (the model axis moved to d) as partial products summed
    over it, or the whole head."""
    name = "tok" if cfg.tie_embeddings else "head"
    spec = tuple(specs[name])
    if cfg.tie_embeddings:
        spec = spec[::-1]                       # of tok.T: (d, vocab)
    ws = [p["tok"].T if cfg.tie_embeddings else p["head"] for p in ps]
    if spec[0] == MODEL:
        parts = []
        for w, x, i in zip(ws, xs, mesh.indices):
            n = w.shape[0]
            c = mesh.coords(i).get(MODEL, 0)
            parts.append(x.narrow(-1, c * n, n) @ w.to(x.dtype))
        out = mesh.sum_ordered(parts, MODEL)
    else:
        out = [x @ w.to(x.dtype) for w, x in zip(ws, xs)]
    return [_softcap(t, cfg.final_softcap) for t in out]

"""What one launch of each hand-written kernel must move and compute: the
bytes (each input read once, each output written once) and the operations
of `PERF.md` §2's bound formulas, one function a kernel.

Each wrapper charges its launch to the active op counters
(`common.charge`, read by `launch.op_cost.OpCounter`) from these
functions, and the dry run (`launch.dryrun`) reckons a device's stage 2
from them.  Every function returns a `Charge`: bytes, operations and the
dtype whose peak rate bounds the operations ("float32" on the CUDA cores;
the bf16 attention kernel's "bfloat16" on the tensor cores)."""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["Charge", "ef_sign_fused", "sign_pack", "sign_decode_reduce",
           "ef_topk_fused", "topk_pack", "topk_decode_reduce", "block_topk",
           "flash_attention", "attention_pairs"]


class Charge(NamedTuple):
    bytes: float
    ops: float
    ops_dtype: str = "float32"


def _sign_payload(n: int, group_size: int) -> float:
    """words (n/32,) u32 and scales (n/g,) f32."""
    return n / 8 + 4 * n / group_size


def _topk_payload(n: int, block_size: int, k: int, idx_bytes: int,
                  val_bytes: int) -> float:
    """idx and values (n/B, k) and scales (n/B,) f32."""
    return n // block_size * (k * (idx_bytes + val_bytes) + 4)


def ef_sign_fused(n: int, group_size: int, g_bytes: int = 4,
                  e_bytes: int = 4) -> Charge:
    """B1: g and e read, e' written, the payload written; 6 ops a
    coordinate."""
    return Charge((g_bytes + 2 * e_bytes) * n
                  + _sign_payload(n, group_size), 6 * n)


def sign_pack(n: int, group_size: int, x_bytes: int = 4) -> Charge:
    """B5: x read, the payload written; 3 ops a coordinate."""
    return Charge(x_bytes * n + _sign_payload(n, group_size), 3 * n)


def sign_decode_reduce(senders: int, n: int, group_size: int) -> Charge:
    """B2: every sender's payload and mask read, the (n,) f32 sum written;
    3 ops a coordinate and sender."""
    return Charge(senders * _sign_payload(n, group_size) + 4 * senders
                  + 4 * n, 3 * senders * n)


def ef_topk_fused(n: int, block_size: int, k: int, g_bytes: int = 4,
                  e_bytes: int = 4, idx_bytes: int = 2,
                  val_bytes: int = 4) -> Charge:
    """B3: g and e read, e' written, the payload written; 6 + k ops a
    coordinate (the selection's k compares)."""
    return Charge((g_bytes + 2 * e_bytes) * n
                  + _topk_payload(n, block_size, k, idx_bytes, val_bytes),
                  (6 + k) * n)


def topk_pack(n: int, block_size: int, k: int, x_bytes: int = 4,
              idx_bytes: int = 2, val_bytes: int = 4,
              gamma: bool = False) -> Charge:
    """B6: x read, the payload written; k ops a coordinate, 2 more with
    COCO's gamma folded in."""
    return Charge(x_bytes * n
                  + _topk_payload(n, block_size, k, idx_bytes, val_bytes),
                  (k + (2 if gamma else 0)) * n)


def topk_decode_reduce(senders: int, n: int, block_size: int, k: int,
                       idx_bytes: int = 2, val_bytes: int = 4) -> Charge:
    """B4: every sender's payload and mask read, the (n,) f32 sum written;
    3 ops a kept entry."""
    return Charge(4 * n + senders * _topk_payload(n, block_size, k,
                                                  idx_bytes, val_bytes)
                  + 4 * senders, 3 * senders * (n // block_size) * k)


def block_topk(n: int, k: int, x_bytes: int = 4) -> Charge:
    """B7: x read, the sparsified (n,) written; k ops a coordinate."""
    return Charge(2 * x_bytes * n, k * n)


def attention_pairs(S: int, window: int) -> int:
    """Unmasked (query, key) pairs of one causal head: the sum over i of
    min(i + 1, window) (window 0: global)."""
    w = min(window, S) if window > 0 else S
    return w * (w + 1) // 2 + (S - w) * w


def flash_attention(B: int, H: int, Hkv: int, S: int, hd: int,
                    window: int, elt_bytes: int) -> Charge:
    """B8: q, k, v read and o written once; 4 * hd flops an unmasked pair
    (q.k and p.v), on the tensor cores in bf16."""
    return Charge(elt_bytes * (2 * B * H * S * hd + 2 * B * Hkv * S * hd),
                  4 * hd * B * H * attention_pairs(S, window),
                  "bfloat16" if elt_bytes == 2 else "float32")

"""What every kernel wrapper of the port shares: the launch counts, input
checks, device scalars and the launch-error check.

Each kernel launch adds one to `launches[<name>]`, and nothing else does,
so a run can show that its main path went through the kernels.
`flash_routes` splits the flash_attention launches by the kernel that ran:
"tensor_core" (bf16, `csrc/flash_attention_sm90.cu`) or "cuda_core" (f32,
`csrc/flash_attention.cu`).

`charge(name, bill, *args)` hands one launch's bytes and operations
(`bill(*args)`, a `cost` function's `Charge`) to every active op counter
(`launch.op_cost.OpCounter`, which a dispatch mode cannot show a ctypes
launch): a wrapper charges where it launches its kernel, and on the meta
device, where it launches nothing, in the launch's place.  With no
counter active it returns at once.  `trips` is the loop over a repeated
body that such a counter may count once (the recurrent layers' loops on
the meta device), `stack_trips` stacks its per-trip outputs."""
from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List

import torch

launches: Dict[str, int] = {
    "ef_sign_fused": 0, "sign_pack": 0, "sign_decode_reduce": 0,
    "ef_topk_fused": 0, "topk_pack": 0, "topk_decode_reduce": 0,
    "block_topk": 0, "flash_attention": 0}
flash_routes: Dict[str, int] = {"tensor_core": 0, "cuda_core": 0}
counters: List = []       # the active op counters, innermost last

VP, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# the storage dtypes of the fused local steps' g and e and of the packs' x
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (launches, flash_routes):
        for k in counts:
            counts[k] = 0


def charge(name: str, bill, *args) -> None:
    """One launch of kernel `name`, costing `bill(*args)`, to the active
    counters; nothing is reckoned when none is active."""
    if counters:
        cost = bill(*args)
        for c in counters:
            c.charge_kernel(name, cost)


def trips(n: int, device, reverse: bool = False) -> Iterator[int]:
    """range(n) (reversed with reverse=True), or, on the meta device with
    autograd off, under op counters that all take the loop shortcut, the
    first trip alone with every charge made in it multiplied by n (the
    counters' `scale`).  Autograd must be off: the backward of a body
    recorded once would run once, unscaled."""
    ctrs = list(counters)
    if not (n > 1 and torch.device(device).type == "meta" and ctrs
            and all(c.loop_shortcut for c in ctrs)
            and not torch.is_grad_enabled()):
        yield from (reversed(range(n)) if reverse else range(n))
        return
    for c in ctrs:
        c.scale *= n
    try:
        yield n - 1 if reverse else 0
    finally:
        for c in ctrs:
            c.scale //= n


def stack_trips(parts: List[torch.Tensor], n: int, dim: int
                ) -> torch.Tensor:
    """The outputs of an n-trip `trips` loop, one a trip, stacked along
    `dim`: torch.stack(parts, dim), or, where the shortcut ran one trip,
    that trip's output standing for all n (the same shape, and the same
    charge as n outputs)."""
    return torch.stack(parts * (n // len(parts)), dim=dim)


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: need {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_dtype(t: torch.Tensor, name: str) -> None:
    """Raise TypeError unless t's dtype has a kernel instance (DTYPES)."""
    if t.dtype not in DTYPES:
        raise TypeError(f"{name}: no kernel instance for {t.dtype}; have "
                        f"{DTYPES}")


def dtype_code(g: torch.Tensor, e: torch.Tensor) -> int:
    """The fused local step's instance: bit 0 = bf16 g, bit 1 = bf16 e."""
    return (int(g.dtype == torch.bfloat16)
            | int(e.dtype == torch.bfloat16) << 1)


def scalar(v, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.contiguous()


def raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"(cudaGetLastError)")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

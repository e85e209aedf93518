#!/usr/bin/env python3
"""Time the library yardstick of `flash_attention` (compiled
`flex_attention`, `chip_smoke.library_attention`) at the serve slice's
two layer shapes (gemma2-2b: B 32, H 8, Hkv 4, S 8192, hd 288, bf16,
softcap 50, window 0 and 4096) over several tile choices, beside the
hand-written kernel on the same inputs.  flex_attention's own choice
needs more shared memory than the card has at hd 288 (padded to 512), so
`chip_smoke.py` passes tiles; this picks them.  With --cells, the same at
the layer shapes of `chip_smoke.SERVE_CELLS`' GQA cells (hd 128, 80 and
64; no softcap, no window), flex_attention's own choice (None) first.

    python3 tools/flex_tiles.py [--cells phi3,olmoe,zamba2,musicgen]

Prints the card's name and power limit, then one JSON line per shape for
the kernel and one per tile choice (compile seconds, ms, the largest
difference from the kernel and the share of entries beyond the kernel's
`allowed_error`), or the error of a choice that does not compile.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OPTIONS = [dict(BLOCK_M=64, BLOCK_N=64, num_stages=1, num_warps=4),
           dict(BLOCK_M=64, BLOCK_N=64, num_stages=2, num_warps=4),
           dict(BLOCK_M=64, BLOCK_N=32, num_stages=2, num_warps=4),
           dict(BLOCK_M=128, BLOCK_N=32, num_stages=1, num_warps=8),
           dict(BLOCK_M=128, BLOCK_N=64, num_stages=1, num_warps=8),
           dict(BLOCK_M=32, BLOCK_N=32, num_stages=3, num_warps=4),
           dict(BLOCK_M=64, BLOCK_N=64, num_stages=1, num_warps=8)]


def shapes(cells):
    """(label, B, Hkv, groups, S, hd, softcap, windows) to sweep."""
    if not cells:
        return [("gemma2", 32, 4, 2, 8192, 288, 50.0, (0, 4096))]
    import chip_smoke as cs
    from repro_torch.configs import REGISTRY
    out = []
    for key in cells:
        arch, _, B, S, _, _ = cs.SERVE_CELLS[key]
        c = REGISTRY[arch].config
        out.append((key, B, c.num_kv_heads, c.num_heads // c.num_kv_heads,
                    S, c.head_dim, 0.0, (0,)))
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="")
    cells = [c for c in ap.parse_args().cells.split(",") if c]
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import build, flash_attention as fa
    print(cs.smi_line(), flush=True)
    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, B, Hkv, g, S, hd, cap, windows in shapes(cells):
        q, k, v = cs.attention_inputs(torch, gen, dev, B, Hkv, g, S, hd,
                                      torch.bfloat16)
        sweep(torch, cs, fa, q, k, v, label, g, cap, windows,
              ([None] if cells else []) + OPTIONS)
        del q, k, v


def sweep(torch, cs, fa, q, k, v, label, groups, softcap, windows,
          options) -> None:
    for window in windows:
        def kernel(window=window):
            return fa.flash_attention(q, k, v, softcap=softcap,
                                      window=window, groups=groups)
        mine = kernel()
        print(json.dumps({"shape": label, "window": window,
                          "kernel_ms": cs.cuda_ms(kernel, 3)}), flush=True)
        for opts in options:
            torch._dynamo.reset()
            t0 = time.perf_counter()
            try:
                lib = cs.library_attention(torch, q, k, v, softcap,
                                           window, groups,
                                           kernel_options=opts)
                got = lib()
                torch.cuda.synchronize()
            except Exception as err:     # a tile choice that cannot build
                print(json.dumps({"shape": label, "window": window,
                                  "opts": opts, "error": str(err)[:300]}),
                      flush=True)
                continue
            d = (got.float() - mine.float()).abs()
            beyond = d > fa.allowed_error(got, mine)
            print(json.dumps({
                "shape": label, "window": window, "opts": opts,
                "compile_s": time.perf_counter() - t0,
                "flex_ms": cs.cuda_ms(lib, 3),
                "max_abs_vs_kernel": d.max().item(),
                "frac_beyond_tol": beyond.float().mean().item()}),
                flush=True)
            del got
        del mine


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What one sharded decode step moves between devices: an arch at full
width, cut to --layers, on an in-process (data, model) mesh on the meta
device (nothing is allocated or computed), one `decode_step` at the last
position of the shape's cache.  Every `DeviceMesh.gather` the step makes
is counted: a device receives (group size - 1) parts of it, from the
other devices of its group.  Prints one JSON line: the bytes each device
receives a token, a layer and in all, split by the gathered part's
shape, and, where the rings hold a block of head_dim (ROADMAP C17's
fallback), what a gather of the step's k and v ring blocks would move:
the step keeps the rings where they are and sums partial scores instead.
Two layers by default: gemma2's first layer is a sliding-window one, and
a stack of it alone caps its rings at the window.

    PYTHONPATH=src python tools/decode_moves.py [--arch gemma2-2b]
        [--shape decode_32k] [--mesh 16,16] [--layers 2]
"""
import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.launch.mesh import (DeviceMesh, MeshLayout,  # noqa: E402
                                     local_mesh, make_production_mesh)
from repro_torch.launch.serve import build_serve_setup  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="16,16",
                    help="DATA,MODEL (16,16: the production mesh)")
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    base = REGISTRY[args.arch]
    spec = dataclasses.replace(base, config=dataclasses.replace(
        base.config, num_layers=args.layers))
    shape = spec.shapes[args.shape]
    dm = tuple(map(int, args.mesh.split(",")))
    layout = (make_production_mesh() if dm == (16, 16) else
              MeshLayout(("data", "model"), dm))
    mesh = local_mesh(layout, "meta")
    setup = build_serve_setup(spec, shape, device="meta", mesh=mesh)
    caches = setup.model.init_caches(shape.global_batch, setup.cache_len)
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.long,
                         device="meta")
    received = collections.Counter()
    gather = DeviceMesh.gather

    def counted(self, parts, axis):
        p = parts[0]
        received[f"{axis} {tuple(p.shape)} {p.dtype}"] += \
            (self.size(axis) - 1) * p.numel() * p.element_size()
        return gather(self, parts, axis)
    DeviceMesh.gather = counted
    try:
        setup.decode_step(caches, tokens, setup.cache_len - 1)
    finally:
        DeviceMesh.gather = gather
    ring = caches[0]["kv"]["k"]
    m = layout.axis_sizes.get("model", 1)
    ring_bytes = (2 * (m - 1) * ring[0].numel() * ring.element_size()
                  if ring.shape[-1] < spec.config.head_dim else None)
    total = sum(received.values())
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": list(layout.shape),
        "layers": args.layers, "ring_block": list(ring.shape[1:]),
        "received_bytes_a_token": total,
        "received_bytes_a_token_a_layer": total / args.layers,
        "by_part": dict(received),
        "ring_gather_bytes_a_token_a_layer": ring_bytes}))


if __name__ == "__main__":
    main()

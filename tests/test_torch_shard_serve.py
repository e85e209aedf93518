"""The port's sharded serve (`launch.serve.build_serve_setup(..., mesh=)`,
`launch.mesh.DeviceMesh`, the sharded dense layers) against JAX's
`build_serve_setup` on the same meshes, against its own process form and
against its own one-device serve, on the smoke configs of gemma2-2b
(tied vocab-sharded table, softcaps, sliding window), phi3-medium-14b
(swiglu, untied head) and musicgen-large (the embeddings input, LayerNorm,
gelu), on (data=2, model=2) and (data=1, model=4), B = 8 prompts of S = 16
(`_torch_cases.SHARD_*`), seeded f32 parameters (`shard_params`) given to
both sides.  On (1, 4) gemma2's and phi3's 2 KV heads do not divide the
model axis: `wk` / `wv` put it on head_dim (`rules._check_divisible`'s
fallback) and the layer gathers them, as GSPMD does, while the 4 query
heads split; the rings hold a block of head_dim, and a decode step sums
partial scores over the model axis instead of gathering them.
musicgen's 4 KV heads split on both meshes, as every case's heads do on
(2, 2).

  - JAX: one subprocess with 4 host devices, started at the module's
    first case, runs JAX's setup on both meshes for the three archs:
    params put with its `param_shardings`, the jitted prefill and 3
    decode steps with its out shardings (tests/test_serve.py's), and
    dumps the gathered logits and caches.  The port's in-process sharded
    serve from the same parameters is held to them: logits and every
    cache leaf within the bf16 tolerance of
    tests/test_torch_serve_families.py for the attention family (2**-6
    of the largest magnitude; JAX's prefill with its `_attn_core`
    monkeypatched to the Pallas kernel in interpret mode, as
    tests/test_torch_serve.py does for gemma2's two windows), the
    positions exact, the greedy tokens equal;
  - the in-process mesh against the process mesh (4 gloo processes, one
    thread each, `_torch_gloo.py serve`): every device's logits and
    cache blocks, bit for bit;
  - sharded against the port's one-device serve: the same tolerance,
    the greedy tokens equal (the row-parallel outputs are summed in rank
    order in f32 and rounded once, not one matmul's sum); also with a
    device's query heads reading two KV heads (6 on 2, model = 3);
  - per-device argument bytes of every smoke cell (what each device
    holds: its θ shard, its cache blocks, its int32 token block) equal
    `serve_specs`' exactly, and at full width gemma2-2b's decode_32k on
    the meta device on (1, 4), (2, 2) and the production (16, 16);
  - `shard_of` / `unshard` round trips of every leaf of the five archs
    in the slice, and of their caches (`caches_to_shards`);
  - on (1, 4) a decode step gathers no ring block over the model axis;
  - `sharding.ctx`: `use_mesh` nests and restores, `gather_block` raises;
  - the other families, and the FSDP arch, raise NotImplementedError on
    a mesh;
  - `serve_batched --mesh 4,2` against its one-device run: equal tokens
    up to each row's first near tie (tests/test_torch_serve_families.py's
    rule, its ties read from the one-device run's logits).

The torch work runs on one thread (`_torch_cases.one_thread`).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_cases import (SHARD_ARCHS, SHARD_B, SHARD_CASES, SHARD_S,
                          SHARD_STEPS, SRC, one_thread, run_sharded,
                          shard_inputs, shard_params)
from _torch_gloo import collect, start_gloo
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.convert import (caches_from_shards, caches_to_jax,
                                 caches_to_shards, params_to_shards)
from repro_torch.launch import dryrun, serve, serve_batched
from repro_torch.launch.mesh import DeviceMesh, MeshLayout, local_mesh, \
    make_production_mesh
from repro_torch.launch.serve import build_serve_setup, serve_specs
from repro_torch.nn import transformer as T
from repro_torch.sharding import ctx, rules

BF16_TOL = 2.0 ** -6
SLICE_ARCHS = ("gemma2-2b", "phi3-medium-14b", "nemotron-4-15b",
               "llava-next-34b", "musicgen-large")
OUT_OF_SLICE = ("olmoe-1b-7b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                "xlstm-1.3b")
IDS = [f"{a}-{d}x{m}" for a, (d, m) in SHARD_CASES]

JAX_SHARDED = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import warnings
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.nn.layers as jlayers
    from repro.configs import REGISTRY
    from repro.configs.common import ShapeCfg
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro.launch.serve import build_serve_setup
    warnings.simplefilter("ignore")
    out_dir, B, S, steps = sys.argv[1], *map(int, sys.argv[2:5])
    cases = json.loads(sys.argv[5])

    def pallas_core(q, k, v, cfg, q_pos, k_pos, w_eff):
        args = tuple(jnp.swapaxes(t, 1, 2) for t in (q, k, v))
        g = cfg.num_heads // cfg.num_kv_heads
        wins = (cfg.sliding_window, 0) if cfg.sliding_window else (0,)
        outs = [jflash(*args, softcap=cfg.attn_softcap, window=w, groups=g,
                       interpret=True) for w in wins]
        out = (jnp.where(w_eff == cfg.sliding_window, *outs)
               if len(outs) == 2 else outs[0])
        return jnp.swapaxes(out, 1, 2)
    jlayers._attn_core = pallas_core

    def nest(flat):
        tree = {}
        for name, a in flat.items():
            *path, leaf = name.split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = a
        return tree

    def f32(tree):
        return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)
                                                 if a.dtype == jnp.bfloat16
                                                 else a), tree)

    for arch, shape in cases:
        inp = np.load(os.path.join(out_dir, f"{arch}.in.npz"))
        mesh = Mesh(np.array(jax.devices()).reshape(shape),
                    ("data", "model"))
        s = build_serve_setup(REGISTRY[arch], mesh,
                              ShapeCfg("prefill", S, B), smoke=True)
        params = jax.device_put(
            nest({k[2:]: inp[k] for k in inp.files if k[:2] == "p:"}),
            s.param_shardings)
        cast = (lambda a: jnp.asarray(a, jnp.bfloat16)
                if a.dtype == np.float32 else jnp.asarray(a))
        pre = jax.jit(s.prefill_step, out_shardings=s.prefill_out_shardings)
        dec = jax.jit(s.decode_step, out_shardings=s.decode_out_shardings)
        lg, caches = pre(params, cast(inp["prompt"]))
        res = {"logits0": lg, "caches0": caches}
        for t in range(steps):
            lg, caches = dec(params, caches, cast(inp[f"feed{t}"]),
                             jnp.int32(S + t))
            res[f"logits{t + 1}"] = lg
        res["caches1"] = caches
        flat = {}
        for key, v in f32(res).items():
            if isinstance(v, dict):
                for path, a in jax.tree_util.tree_flatten_with_path(v)[0]:
                    flat[key + "/" + "/".join(k.key for k in path)] = a
            else:
                flat[key] = v
        np.savez(os.path.join(out_dir, f"{arch}.{shape[0]}x{shape[1]}.npz"),
                 **flat)
""")


class _Refs:
    """JAX's sharded runs and the gloo processes' (`_torch_gloo.py
    serve`), both started at once; `jax(...)` and `gloo()` wait."""

    def __init__(self, tmp):
        self.tmp = tmp
        for arch in SHARD_ARCHS:
            prompt, feeds = shard_inputs(arch)
            np.savez(tmp / f"{arch}.in.npz", prompt=prompt,
                     **{f"feed{t}": f for t, f in enumerate(feeds)},
                     **{f"p:{k}": v for k, v in shard_params(arch).items()})
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        self.jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SHARDED, str(tmp), str(SHARD_B),
             str(SHARD_S), str(SHARD_STEPS), json.dumps(SHARD_CASES)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        (tmp / "gloo").mkdir()
        self.gloo_proc = start_gloo("serve", tmp / "gloo")
        self._jax = self._gloo = None

    def jax(self, arch, shape):
        if self._jax is None:
            _, err = self.jax_proc.communicate(timeout=300)
            assert self.jax_proc.returncode == 0, err[-3000:]
            self._jax = True
        return np.load(self.tmp / f"{arch}.{shape[0]}x{shape[1]}.npz")

    def gloo(self):
        if self._gloo is None:
            self._gloo = collect(self.gloo_proc, self.tmp / "gloo")
        return self._gloo

    def close(self):
        for proc in (self.jax_proc, self.gloo_proc):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def refs(tmp_path_factory):
    """The module on one torch thread; JAX's and the gloo runs start at
    its first case."""
    r = _Refs(tmp_path_factory.mktemp("shard_serve"))
    with one_thread():
        yield r
    r.close()


def _mesh(shape):
    return local_mesh(MeshLayout(("data", "model"), tuple(shape)), "cpu")


@functools.lru_cache(maxsize=None)
def _port(arch, shape=None):
    """`run_sharded` in-process on `shape` (None: one device)."""
    return run_sharded(arch, None if shape is None else _mesh(shape))


def _setup(arch, shape):
    return build_serve_setup(REGISTRY[arch], ShapeCfg("prefill", SHARD_S,
                                                      SHARD_B),
                             smoke=True, device="cpu", mesh=_mesh(shape))


def _full(arch, shape, run):
    """(each step's whole logits, each cache tree whole) of a sharded
    run's device blocks."""
    setup = _setup(arch, shape)
    layout = setup.mesh.layout
    logits = [rules.unshard(parts, setup.prefill_out_shardings[0], layout)
              for parts in run["logits"]]
    caches = [caches_from_shards(parts, REGISTRY[arch].smoke, layout,
                                 SHARD_B) for parts in run["caches"]]
    return logits, caches


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    return ((got - want).abs().max() / want.abs().max()).item()


def _check(logits, caches, want_logits, want_caches, what):
    """Every step's logits and each cache leaf within BF16_TOL, the
    positions exact and the greedy tokens equal."""
    for t, (g, w) in enumerate(zip(logits, want_logits)):
        assert _gap(g, w) <= BF16_TOL, f"{what} logits {t}: {_gap(g, w)}"
        assert torch.equal(g.float().argmax(-1), w.float().argmax(-1)), \
            f"{what} greedy tokens {t}"
    for t, (g, w) in enumerate(zip(caches, want_caches)):
        for leaf in ("k", "v"):
            gap = _gap(g["kv"][leaf], w["kv"][leaf])
            assert gap <= BF16_TOL, f"{what} cache {t} {leaf}: {gap}"
        assert torch.equal(g["kv"]["pos"], w["kv"]["pos"]), what


# --- no reference run needed ---------------------------------------------

@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_shard_of_unshard_round_trip(arch):
    """Every leaf of the arch's smoke θ cut on (2, 2), (1, 4) and (4, 2)
    and put back is the leaf, bit for bit; so is the cache tree."""
    cfg = REGISTRY[arch].smoke
    g = torch.Generator().manual_seed(1)
    state = {n: torch.randn(s, generator=g)
             for n, s in T.param_shapes(cfg).items()}
    caches = T.init_caches(cfg, SHARD_B, SHARD_S, torch.bfloat16, "cpu")
    caches = T.tree_map(lambda t: torch.randn(t.shape, generator=g).to(
        t.dtype) if t.is_floating_point() else t, caches)
    for shape in ((2, 2), (1, 4), (4, 2)):
        layout = MeshLayout(("data", "model"), shape)
        specs = rules.param_specs(T.param_shapes(cfg), cfg, layout)
        shards = params_to_shards(state, cfg, layout)
        for n, t in state.items():
            parts = [s[n] for s in shards]
            assert all(tuple(p.shape) == rules.shard_shape(t.shape, specs[n],
                                                           layout)
                       for p in parts), n
            assert torch.equal(rules.unshard(parts, specs[n], layout), t), n
        back = caches_from_shards(caches_to_shards(caches, cfg, layout,
                                                   SHARD_B),
                                  cfg, layout, SHARD_B)
        for leaf in ("k", "v", "pos"):
            assert torch.equal(back["kv"][leaf], caches["kv"][leaf])


@pytest.mark.parametrize("arch", OUT_OF_SLICE + ("qwen1.5-110b",))
def test_other_families_and_fsdp_raise_on_a_mesh(arch):
    with pytest.raises(NotImplementedError, match="A15"):
        _setup(arch, (2, 2))


def test_input_specs_is_the_dry_runs_serve_specs():
    """One `dp_spec` and one `input_specs`: the setup's is `serve_specs`
    on the mesh's layout, the dry run's the same function."""
    setup = _setup("gemma2-2b", (2, 2))
    assert setup.input_specs.func is serve_specs is dryrun.serve_specs
    assert dryrun.dp_spec is rules.dp_spec is serve.dp_spec
    assert setup.batch_sharding == rules.dp_spec(setup.mesh.layout, SHARD_B)
    want = serve_specs(REGISTRY["gemma2-2b"], ShapeCfg("prefill", SHARD_S,
                                                       SHARD_B),
                       setup.mesh.layout, "decode", smoke=True)
    assert setup.input_specs("decode") == want


def _held_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_held_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _device_bytes(setup, batch: int, seq: int) -> list:
    """What each device holds: {params, caches, prefill inputs, decode
    inputs} bytes (tokens as the steps cut them: int32 blocks)."""
    model, mesh = setup.model, setup.mesh
    caches = model.init_caches(batch, setup.cache_len)
    cfg = model.cfg
    tok = cfg.input_mode == "tokens"

    def inputs(n):
        x = (torch.zeros((batch, n), dtype=torch.long, device=mesh.device)
             if tok else torch.zeros((batch, n, cfg.d_model),
                                     dtype=torch.bfloat16,
                                     device=mesh.device))
        return serve._batch_blocks(mesh, setup.batch_sharding, x)
    pre, dec = inputs(seq), inputs(1)
    return [{"params": _held_bytes(p), "caches": _held_bytes(c),
             "prefill": _held_bytes(a), "decode": _held_bytes(b)}
            for p, c, a, b in zip(model.params(), caches, pre, dec)]


def _want_bytes(spec, shape, layout, smoke):
    d = dryrun.part_bytes(serve_specs(spec, shape, layout, "decode",
                                      smoke)["parts"])
    p = dryrun.part_bytes(serve_specs(spec, shape, layout, "prefill",
                                      smoke)["parts"])
    return {"params": d["params"], "caches": d["caches"],
            "prefill": p["inputs"], "decode": d["inputs"]}


@pytest.mark.parametrize("arch,shape", SHARD_CASES, ids=IDS)
def test_device_bytes_equal_serve_specs(arch, shape):
    setup = _setup(arch, shape)
    want = _want_bytes(REGISTRY[arch], ShapeCfg("prefill", SHARD_S, SHARD_B),
                       setup.mesh.layout, True)
    for held in _device_bytes(setup, SHARD_B, SHARD_S):
        assert held == want
    for name, (spec, shard) in setup.param_shardings.items():
        assert tuple(setup.model.params()[0][name].shape) == shard, name


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (16, 16)])
def test_full_width_decode_32k_bytes_on_meta(shape):
    """gemma2-2b at full width, decode_32k (B 128, S 32768): what each of
    the mesh's devices holds on the meta device equals `serve_specs`."""
    spec = REGISTRY["gemma2-2b"]
    layout = (make_production_mesh() if shape == (16, 16) else
              MeshLayout(("data", "model"), shape))
    shp = spec.shapes["decode_32k"]
    setup = build_serve_setup(spec, shp, device="meta",
                              mesh=local_mesh(layout, "meta"))
    want = _want_bytes(spec, shp, layout, False)
    held = _device_bytes(setup, shp.global_batch, shp.seq_len)
    assert len(held) == layout.size
    assert all(h == want for h in held), (held[0], want)


@pytest.mark.parametrize("arch,shape", SHARD_CASES, ids=IDS)
def test_sharded_matches_unsharded(arch, shape):
    logits, caches = _full(arch, shape, _port(arch, shape))
    one = _port(arch)
    _check(logits, caches, one["logits"], one["caches"],
           f"{arch} on {shape} against one device")


@pytest.mark.parametrize("arch", ["gemma2-2b", "phi3-medium-14b"])
def test_head_dim_rings_stay_put_in_decode(arch, monkeypatch):
    """On (1, 4) the 2 KV heads do not divide the model axis and each ring
    holds a block of head_dim (C17's fallback): a decode step moves the
    queries, the (B, H, T) partial scores and the outputs over the model
    axis, and no ring block.  Its logits equal `_port`'s step, bit for
    bit."""
    setup = _setup(arch, (1, 4))
    setup.model.load_params({k: torch.from_numpy(v)
                             for k, v in shard_params(arch).items()})
    prompt, feeds = shard_inputs(arch)
    _, caches = setup.prefill_step(torch.from_numpy(prompt))
    ring = tuple(caches[0]["kv"]["k"].shape[1:])
    assert ring[-1] < REGISTRY[arch].smoke.head_dim
    moved = []
    gather = DeviceMesh.gather

    def spy(self, parts, axis):
        moved.append(tuple(parts[0].shape))
        return gather(self, parts, axis)
    monkeypatch.setattr(DeviceMesh, "gather", spy)
    logits, _ = setup.decode_step(caches, torch.from_numpy(feeds[0]),
                                  SHARD_S)
    monkeypatch.undo()
    B, Hkv, T_, _ = ring
    groups = REGISTRY[arch].smoke.num_heads // Hkv
    assert ring not in moved
    assert (B, 1, Hkv, groups, T_) in moved
    want = _port(arch, (1, 4))["logits"][1]
    assert all(torch.equal(g, w) for g, w in zip(logits, want))


def test_ctx_use_mesh_nests_and_gather_block_raises():
    mesh = _mesh((2, 2))
    assert ctx.active_mesh() is None
    with ctx.use_mesh(mesh):
        assert ctx.active_mesh() is mesh
        with ctx.use_mesh(None):
            assert ctx.active_mesh() is None
        assert ctx.active_mesh() is mesh
    assert ctx.active_mesh() is None
    x = torch.ones(2)
    assert ctx.constrain(x, ("model",)) is x
    with pytest.raises(NotImplementedError, match="A15"):
        ctx.gather_block({}, torch.bfloat16)


@pytest.mark.parametrize("arch", ["gemma2-2b", "phi3-medium-14b"])
def test_query_heads_across_kv_groups(arch):
    """6 query heads on 2 KV heads (groups of 3) over model = 3: device 1
    holds query heads 2 and 3, which read two KV heads (`layers._kv_for`'s
    head-by-head branch); d_ff, the vocabulary and head_dim do not divide
    3, so those leaves stay whole.  Sharded on (1, 3) against one device:
    the prefill and a decode step within BF16_TOL, greedy tokens equal."""
    base = REGISTRY[arch]
    spec = dataclasses.replace(base, smoke=dataclasses.replace(
        base.smoke, num_heads=6, num_kv_heads=2))
    shape = ShapeCfg("prefill", SHARD_S, SHARD_B)
    layout = MeshLayout(("data", "model"), (1, 3))
    one = build_serve_setup(spec, shape, smoke=True, device="cpu")
    one.model.init_(0)
    sharded = build_serve_setup(spec, shape, smoke=True, device="cpu",
                                mesh=local_mesh(layout, "cpu"))
    sharded.model.load_params(one.model.params())
    prompt = torch.from_numpy(shard_inputs(arch)[0])
    logits, caches = [], []
    for s in (one, sharded):
        lg, c = s.prefill_step(prompt)
        step, c = s.decode_step(c, prompt[:, :1], SHARD_S)
        logits.append([s.full_logits(lg), s.full_logits(step)])
        caches.append([c if s is one else caches_from_shards(
            c, spec.smoke, layout, SHARD_B)])
    _check(logits[1], caches[1], logits[0], caches[0],
           f"{arch} with 6 query heads on 2 KV heads on (1, 3)")


def _args(**kw):
    ns = serve_batched.build_parser().parse_args(["--device", "cpu"])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_serve_batched_on_a_4x2_mesh(capsys):
    """`serve_batched --mesh 4,2` (JAX's example mesh) in-process: the
    tokens of the one-device run up to each row's first near tie of its
    logits (bf16; tests/test_torch_serve_families.py's rule)."""
    one = serve_batched.run(_args())
    got = serve_batched.run(_args(mesh="4,2"))
    assert "mesh (data=4, model=2)" in capsys.readouterr().out
    logs = one["logits"]                               # (new, B, V)
    top2 = np.sort(logs, -1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]).T <= \
        2 * BF16_TOL * np.abs(logs).max()               # (B, new)
    for b in range(got["tokens"].shape[0]):
        stop = int(np.argmax(near[b])) if near[b].any() else \
            got["tokens"].shape[1]
        np.testing.assert_array_equal(got["tokens"][b, :stop],
                                      one["tokens"][b, :stop])


# --- against the gloo processes, then JAX (their runs started first) ------

@pytest.mark.parametrize("arch,shape", SHARD_CASES, ids=IDS)
def test_in_process_equals_process_mesh(refs, arch, shape):
    """Every device's logits and cache blocks of the in-process mesh equal
    the gloo process's (device r = process r), bit for bit."""
    mine = _port(arch, shape)
    for r, theirs in enumerate(refs.gloo()):
        got = theirs[f"{arch}/{shape}"]
        for t, parts in enumerate(mine["logits"]):
            assert torch.equal(parts[r], got["logits"][t][0]), (r, t)
        for t, parts in enumerate(mine["caches"]):
            for leaf in ("k", "v", "pos"):
                assert torch.equal(parts[r]["kv"][leaf],
                                   got["caches"][t][0]["kv"][leaf]), \
                    (r, t, leaf)


@pytest.mark.parametrize("arch,shape", SHARD_CASES, ids=IDS)
def test_sharded_matches_jax(refs, arch, shape):
    """The port's in-process sharded serve against JAX's
    `build_serve_setup` on the same mesh (the gathered arrays)."""
    want = refs.jax(arch, shape)
    logits, caches = _full(arch, shape, _port(arch, shape))
    jl = [torch.from_numpy(want[f"logits{t}"]) for t in range(len(logits))]
    jc = [{"kv": {leaf: torch.from_numpy(want[f"caches{t}/kv/{leaf}"])
                  for leaf in ("k", "v", "pos")}} for t in range(2)]
    _check(logits, caches, jl, jc, f"{arch} on {shape} against JAX")
    # the assembled caches carry over to JAX's tree as `caches_to_jax`
    tree = caches_to_jax(caches[0])
    assert tree["kv"]["k"].shape == want["caches0/kv/k"].shape

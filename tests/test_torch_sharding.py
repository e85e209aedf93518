"""The port's partition rules (`repro_torch.sharding.rules`) against JAX's
(`repro.sharding.rules`), leaf by leaf, at every arch's full width.

JAX's `param_specs` and `cache_specs` read only `mesh.axis_names` and
`mesh.devices.shape`, so JAX's side runs in this process on a stub mesh
of those two attributes (no devices), over `jax.eval_shape` of JAX's
init, `init_caches` and prefill; the port's side on a
`launch.mesh.MeshLayout` of the same axes over the port's leaf shapes,
its meta-device caches and a meta-device prefill.  The meshes: the two
production meshes, (data=16, model=16) and (pod=2, data=16, model=16),
and a (data=2, model=2) host mesh; each arch with its `fsdp`.  Specs are
compared exactly, as `PartitionSpec` tuples (a one-axis entry is the
axis name).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.launch.serve import LONG_SEQ as JAX_LONG_SEQ, _dp_spec
from repro.launch.train import _local_flat_size
from repro.nn import Model as JaxModel
from repro.sharding import rules as jrules
from repro_torch.configs import REGISTRY, STANDARD_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshLayout, make_host_mesh, \
    make_production_mesh
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.serve import cache_len_of
from repro_torch.nn import transformer as T
from repro_torch.nn.models import Model
from repro_torch.sharding import rules

ARCHS = list(REGISTRY)
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16)),
          "host": (("data", "model"), (2, 2))}


def stub(mesh: MeshLayout):
    """JAX's side of a mesh: the two attributes its rules read."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.shape, dtype=object))


def layout(name: str) -> MeshLayout:
    return MeshLayout(*MESHES[name])


def jax_flat(tree):
    """{'/'-joined key path: leaf} of a JAX tree (PartitionSpecs as
    tuples); sequence keys by index."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]

    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in p):
            tuple(v) if isinstance(v, jax.sharding.PartitionSpec) else v
            for p, v in leaves}


def port_flat(tree, like=None, path=()):
    """{'/'-joined path: leaf} of the port's nested dicts and tuples of
    tensors; with `like`, a tree of the same nesting (specs), its leaves
    at those paths."""
    like = tree if like is None else like
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in port_flat(
            tree[key], like[key], path + (str(key),)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree) for k, v in port_flat(
            t, like[i], path + (str(i),)).items()}
    return {"/".join(path): like}


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    return JaxModel(JAX_REGISTRY[arch].config).param_shapes()


@functools.lru_cache(maxsize=None)
def jax_caches(arch: str, kind: str):
    """JAX's cache tree of a serve shape ("decode_32k", "long_500k":
    `init_caches` at JAX's cache_len; "prefill_32k": the prefill's)."""
    cfg = JAX_REGISTRY[arch].config
    model = JaxModel(cfg)
    shape = STANDARD_SHAPES[kind]
    B, S = shape.global_batch, shape.seq_len
    if kind != "prefill_32k":
        cl = S
        if cfg.family in ("dense", "moe") and cfg.sliding_window and \
                S >= JAX_LONG_SEQ:
            cl = cfg.sliding_window
        return jax.eval_shape(lambda: model.init_caches(B, cl))
    inp = (jax.ShapeDtypeStruct((B, S), jnp.int32)
           if cfg.input_mode == "tokens" else
           jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.bfloat16))
    return jax.eval_shape(lambda p, i: model.prefill(p, i)[1],
                          jax_params(arch), inp)


@functools.lru_cache(maxsize=None)
def port_caches(arch: str, kind: str):
    """The port's cache tree of the same shape, on the meta device (the
    prefill's under an `OpCounter`, whose loop shortcut keeps the
    recurrent archs' 32768-step scans short)."""
    cfg = REGISTRY[arch].config
    shape = STANDARD_SHAPES[kind]
    B, S = shape.global_batch, shape.seq_len
    if kind != "prefill_32k":
        return T.init_caches(cfg, B, cache_len_of(cfg, S),
                             torch.bfloat16, dryrun.META)
    model = Model(cfg, device=dryrun.META, with_grad=False)
    x = (torch.zeros((B, S), dtype=torch.long, device=dryrun.META)
         if cfg.input_mode == "tokens" else
         torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16,
                     device=dryrun.META))
    with torch.inference_mode(), OpCounter():
        return model.prefill(x)[1]


def port_params(arch: str, mesh: MeshLayout):
    cfg = REGISTRY[arch].config
    return rules.param_specs(T.param_shapes(cfg), cfg, mesh,
                             fsdp=REGISTRY[arch].coding.fsdp)


def jax_param_specs(arch: str, mesh: MeshLayout):
    spec = JAX_REGISTRY[arch]
    return jax_flat(jrules.param_specs(jax_params(arch), spec.config,
                                       stub(mesh), fsdp=spec.coding.fsdp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh):
    m = layout(mesh)
    want, got = jax_param_specs(arch, m), port_params(arch, m)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_specs_equal_jax(arch, mesh):
    m = layout(mesh)
    spec, cfg = JAX_REGISTRY[arch], REGISTRY[arch].config
    want = jax_flat(jrules.grads_specs(
        jax_params(arch), spec.config, stub(m), spec.coding.coding_axes,
        fsdp=spec.coding.fsdp))
    got = rules.grads_specs(T.param_shapes(cfg), cfg, m,
                            REGISTRY[arch].coding.coding_axes,
                            fsdp=REGISTRY[arch].coding.fsdp)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_flat_size_equals_jax(arch, mesh):
    m = layout(mesh)
    spec = JAX_REGISTRY[arch]
    want = _local_flat_size(
        jax_params(arch), jrules.param_specs(jax_params(arch), spec.config,
                                             stub(m), fsdp=spec.coding.fsdp),
        stub(m))
    cfg = REGISTRY[arch].config
    assert rules.local_flat_size(T.param_shapes(cfg), port_params(arch, m),
                                 m) == want


CACHE_CELLS = [(a, k) for a in ARCHS for k in ("decode_32k", "long_500k",
                                               "prefill_32k")
               if k in REGISTRY[a].shapes]


@pytest.mark.parametrize("arch,kind", CACHE_CELLS)
def test_cache_specs_equal_jax(arch, kind):
    """Every cache leaf's spec on both production meshes, with the batch
    axes of `_dp_spec` at the shape's global batch; the trees' shapes
    too."""
    B = STANDARD_SHAPES[kind].global_batch
    jc, pc = jax_caches(arch, kind), port_caches(arch, kind)
    jshapes = {k: tuple(v.shape) for k, v in jax_flat(jc).items()}
    pshapes = {k: tuple(v.shape) for k, v in port_flat(pc).items()}
    assert pshapes == jshapes
    for mesh in ("single", "multi"):
        m = layout(mesh)
        b = _dp_spec(stub(m), B)
        axes = b if isinstance(b, tuple) else ((b,) if b else ())
        assert dryrun.dp_spec(m, B) == b
        want = jax_flat(jrules.cache_specs(jc, JAX_REGISTRY[arch].config,
                                           stub(m), axes, B))
        got = port_flat(pc, rules.cache_specs(pc, REGISTRY[arch].config,
                                              m, axes, B))
        assert got == want, mesh


def test_phi3_heads_fall_back_to_head_dim():
    """phi3's 40 heads do not divide model=16: the model axis moves onto
    head_dim 128 (`_check_divisible`'s fallback), as in JAX."""
    m = layout("single")
    got = port_params("phi3-medium-14b", m)
    cfg = REGISTRY["phi3-medium-14b"].config
    assert cfg.num_heads % 16 and cfg.head_dim % 16 == 0
    assert got["blocks/attn/wq"] == (None, None, None, "model")   # hd
    assert got["blocks/attn/wo"] == (None, None, None, "model")   # d
    assert got == jax_param_specs("phi3-medium-14b", m)


def test_slstm_weights_replicated():
    """xlstm's sLSTM leaves are replicated on every mesh (their per-step
    matmuls on (B, d) states), while its mLSTM leaves are sharded."""
    for mesh in MESHES:
        got = port_params("xlstm-1.3b", layout(mesh))
        sl = {k: v for k, v in got.items() if "slstm" in k.split("/")}
        assert sl and all(all(e is None for e in v) for v in sl.values())
        assert any("model" in v for k, v in got.items()
                   if k.startswith("mlstm_blocks/mlstm/"))
        assert got == jax_param_specs("xlstm-1.3b", layout(mesh))


def test_meshes():
    assert make_production_mesh() == MeshLayout(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshLayout(
        ("pod", "data", "model"), (2, 16, 16))
    host = make_host_mesh()
    assert host.axis_names == ("data", "model") and host.shape[1] == 1
    assert host.size == max(torch.cuda.device_count(), 1)
    with pytest.raises(ValueError):
        make_host_mesh(model_parallel=3 * host.size + 1)

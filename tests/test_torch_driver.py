"""The port's training driver (`repro_torch/launch/train_e2e.py`) and the
coding plane of its setup (`repro_torch/launch/train.py`).

  - resume: `run()` for 12 steps with a checkpoint at step 10, then again
    with --steps 14, prints "resumed from step 10", and its losses and
    the final theta and e bits equal an uninterrupted 14-step run (iid,
    and the bursty markov process);
  - the elastic step with its estimate pinned to the oracle rates equals
    the static step bit for bit (JAX's
    `test_static_vs_elastic_train_setup_bitwise`);
  - hetero stragglers with a rate-aware plan against JAX's real
    `build_train_setup` + `train_step` on a (data=4, model=1) mesh (a
    subprocess), 3 steps;
  - `--plan auto --metrics --prefetch 2`: the planner's pick trained,
    JSONL and trace through JAX's validators, the same bits as the plan
    trained synchronously without telemetry; the driver's usage errors.

Tolerances and why: the masks, allocations, encode weights and batch
weights are host-side float64/f32 numpy in JAX's order (bit-equal); the
losses and theta against JAX's mesh step are held as
tests/test_torch_train.py holds the sign wire (loss rtol 1e-4; theta
within steps * 2*N*(max group scale), the most that sign bits flipped by
near-zero accumulators can move a coordinate, and under 1% of the
coordinates off by more than 1e-6).  Port against port: bit-equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cases import (G, LR, N, SRC, _port_setup, _state_dict,
                          one_thread)
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.core.plan import PlanSpec
from repro_torch.launch import train_e2e
from repro_torch.launch.train import (TrainRun, build_train_setup,
                                      elastic_coding_state)


def _run(tmp_path, name, *flags, arch="gemma2-2b"):
    """train_e2e.run on the CPU, on one thread (`_torch_cases.one_thread`)."""
    args = train_e2e.build_parser().parse_args(
        ["--device", "cpu", "--arch", arch, "--ckpt-dir",
         str(tmp_path / name), *flags])
    with one_thread():
        return train_e2e.run(args)


@pytest.mark.parametrize("straggler", ("iid", "markov"))
def test_resume_is_bit_exact(tmp_path, capsys, straggler):
    flags = ("--straggler", straggler)
    first = _run(tmp_path, "ckpt", "--steps", "12", "--ckpt-every", "10",
                 *flags)
    assert [c["step"] for c in first["ckpt"]] == [10]
    assert "checkpointed -> ckpt_0000000010.rpr" in capsys.readouterr().out
    resumed = _run(tmp_path, "ckpt", "--steps", "14", "--ckpt-every", "10",
                   *flags)
    assert "resumed from step 10" in capsys.readouterr().out
    assert resumed["start"] == 10 and resumed["restore_s"] is not None
    straight = _run(tmp_path, "straight", "--steps", "14", "--ckpt-every",
                    "100", *flags)
    assert straight["start"] == 0
    want = {r["step"]: r for r in straight["steps"]}
    for r in first["steps"][10:] + resumed["steps"]:
        assert r["loss"] == want[r["step"]]["loss"]
        assert r["mask"] == want[r["step"]]["mask"]
    assert [r["step"] for r in resumed["steps"]] == [10, 11, 12, 13]
    if straggler == "markov":           # some rank straggled on the way
        assert any(0.0 in r["mask"] for r in straight["steps"])
    assert torch.equal(resumed["e"], straight["e"])
    assert torch.equal(resumed["setup"].model.theta,
                       straight["setup"].model.theta)


def test_elastic_resume_restarts_the_plane(tmp_path, capsys):
    """Under --elastic a checkpoint holds no coding plane (as in JAX's
    driver): the resumed run restores theta and e, draws the same masks,
    and starts its estimator and allocation again at epoch 0."""
    flags = ("--straggler", "markov", "--straggler-p", "0.25", "--elastic",
             "--ckpt-every", "10")
    first = _run(tmp_path, "ckpt", "--steps", "11", *flags)
    resumed = _run(tmp_path, "ckpt", "--steps", "12", *flags)
    assert "resumed from step 10" in capsys.readouterr().out
    was, now = first["steps"][10], resumed["steps"][0]
    assert now["step"] == 10 and now["mask"] == was["mask"]
    epoch0 = resumed["setup"].allocation.S.tolist()
    assert now["allocation"] == epoch0
    assert now["replan"]["epoch"] == int(now["replan"]["reallocated"])
    assert was["replan"]["epoch"] > 1      # the plane had moved on
    if was["allocation"] != epoch0:
        assert now["weights"] != was["weights"]


def test_driver_flags_not_ported_exit_as_usage_errors(tmp_path, capsys):
    for flags, item in ((("--rank-uplink-gbps", "10,5,5,5"),
                         "--compressor block_topk"),
                        (("--straggler", "hetero", "--straggler-spread",
                          "9"), "outside [0, 1)")):
        with pytest.raises(SystemExit) as ex:
            train_e2e.main(["--device", "cpu", "--arch", "gemma2-2b",
                            "--ckpt-dir", str(tmp_path), *flags])
        assert ex.value.code == 2
        assert item in capsys.readouterr().err


def test_driver_plan_auto_metrics_prefetch(tmp_path, capsys):
    """--plan auto --metrics --prefetch 2 on the CPU: the planner's pick
    (the search JAX's driver runs, tests/test_torch_planner.py) is the
    wire trained, every JSONL record passes JAX's `validate_record`, the
    trace JAX's `validate_chrome_trace`, and the run's bits equal the
    same plan trained synchronously without telemetry."""
    from repro.obs import validate_chrome_trace, validate_record
    from repro_torch.obs import read_jsonl
    common = ("--steps", "3", "--straggler", "markov", "--straggler-p",
              "0.25", "--plan-out", str(tmp_path / "plan.json"))
    out = _run(tmp_path, "all", "--plan", "auto", "--metrics",
               "--metrics-dir", str(tmp_path / "m"), "--prefetch", "2",
               *common)
    text = capsys.readouterr().out
    assert "planner: 15 candidates -> 4 confirmed; ranking:" in text
    emission = json.loads((tmp_path / "plan.json").read_text())
    assert emission["schema"] == "repro.plan_search/v1"
    plan = PlanSpec.from_dict(emission["plan"])
    assert out["setup"].plan == dataclasses.replace(plan, num_ranks=4)
    assert f"plan: d={plan.d} compressor={plan.compressor}" in text
    recs = read_jsonl(out["metrics"]["jsonl"])
    for r in recs:
        validate_record(r)
    kinds = [r["kind"] for r in recs]
    assert kinds == ["run_meta"] + ["train_step"] * 3 + ["prefetch"]
    assert recs[-1]["stats"]["get_count"] == 3
    for r, st in zip(recs[1:4], out["steps"]):
        assert r["participation"] == st["mask"] and r["loss"] == st["loss"]
        assert set(r["spans"]) == {"train/batch_wait", "train/step_dispatch",
                                   "train/result_fetch"}
    trace = json.loads(Path(out["metrics"]["trace"]).read_text())
    validate_chrome_trace(trace)
    names = {ev["name"] for ev in trace["traceEvents"]}
    assert {"train/batch_wait", "prefetch_depth"} <= names
    # the same plan, synchronous and without telemetry: the same bits
    plan_path = tmp_path / "plan_only.json"
    plan.save(str(plan_path))
    plain = _run(tmp_path, "plain", "--plan", str(plan_path), *common)
    assert [r["loss"] for r in plain["steps"]] == \
        [r["loss"] for r in out["steps"]]
    assert torch.equal(plain["setup"].model.theta,
                       out["setup"].model.theta)
    assert torch.equal(plain["e"], out["e"])


def test_driver_budgets_plan_and_elastic(tmp_path, capsys):
    """--rank-uplink-gbps solves the budgets and the run carries them; a
    saved plan runs its wire; --elastic replans from the observed masks
    and feeds each example its live weight."""
    out = _run(tmp_path, "b", "--steps", "2", "--compressor", "block_topk",
               "--rank-uplink-gbps", "10,10,5,2.5", "--elastic",
               "--straggler", "markov", "--straggler-p", "0.25")
    text = capsys.readouterr().out
    assert "k=(8, 8, 3, 1)" in text and "replan @ step 0" in text
    assert out["setup"].cocoef_cfg.k_per_block == (8, 8, 3, 1)
    rep = out["steps"][0]["replan"]
    assert rep["reallocated"] and rep["epoch"] == 1
    # step 1 trained on the epoch-1 allocation, with its refitted weights
    s = out["setup"]
    assert out["steps"][1]["allocation"] != s.allocation.S.tolist()
    assert all(w > 0 for row in out["steps"][1]["weights"] for w in row)
    path = tmp_path / "plan.json"
    PlanSpec(compressor="block_topk", block_size=64, k_per_block=4,
             num_buckets=2).save(str(path))
    out = _run(tmp_path, "p", "--steps", "1", "--plan", str(path))
    assert "plan: d=2 compressor=block_topk alloc=uniform buckets=2" in \
        capsys.readouterr().out
    cfg = out["setup"].cocoef_cfg
    assert (cfg.compressor, cfg.k_per_block, cfg.num_buckets) == \
        ("block_topk", 4, 2)


def _driver_spec():
    spec = REGISTRY["gemma2-2b"]
    return dataclasses.replace(spec, coding=dataclasses.replace(
        spec.coding, straggler_p=0.25, **train_e2e.CODING_OVERRIDES))


def test_static_vs_elastic_pinned_bitwise():
    """The elastic step with its CodingState pinned to the planned
    (oracle) rates trains 3 steps bit for bit as the static step, under
    hetero stragglers (rate-aware weights that differ per rank)."""
    spec, shape = _driver_spec(), train_e2e.SHAPE
    results = {}
    for elastic in (False, True):
        run = TrainRun(base_lr=5e-3, straggler="hetero", elastic=elastic)
        s = build_train_setup(spec, shape, run, smoke=True, n_code=N,
                              device="cpu")
        e = s.init_state()
        for t in range(3):
            state = None
            if elastic:
                state, info = elastic_coding_state(s)   # pinned: planned
                assert not info["reallocated"]
            m = s.train_step(s.model, e, s.make_batch(t), t,
                             coding_state=state)
        results[elastic] = (m, s, e)
    (ms, ss, es), (me, se, ee) = results[False], results[True]
    assert len(set(np.asarray(ss.W).ravel().tolist())) > 2   # per-rank q_i
    assert torch.equal(ms["weights"], me["weights"])
    assert ms["loss"].item() == me["loss"].item()
    assert torch.equal(ss.model.theta, se.model.theta)
    assert torch.equal(es, ee)
    with pytest.raises(ValueError):          # an elastic batch needs W
        se.train_step(se.model, ee, se.make_batch(3), 3)


# JAX's setup with hetero stragglers and a plan, on a (data=4, model=1)
# mesh: its allocation, encode weights and masks, and for the exact-load
# plan 3 steps of batches, losses and theta
JAX_PLAN_RUN = textwrap.dedent(f"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs import REGISTRY
    from repro.configs.common import ShapeCfg
    from repro.core.cocoef import flatten_local
    from repro.core.plan import PlanSpec
    from repro.launch.train import (TrainRun, build_train_setup,
                                    make_batch_for_step, setup_encode_weights)
    warnings.simplefilter("ignore")
    spec = REGISTRY["gemma2-2b"]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"))
    mesh = make_mesh((4, 1), ("data", "model"))
    shape = ShapeCfg("train", 32, 8)
    key = jax.random.PRNGKey(0)
    out = {{}}
    for alloc in ("rate_aware", "exact_load"):
        plan = PlanSpec.from_dict({{**json.loads(sys.argv[2]),
                                    "allocation": alloc}})
        setup = build_train_setup(spec, mesh, shape,
                                  TrainRun(base_lr={LR}, plan=plan,
                                           straggler="hetero"), smoke=True)
        out[alloc + "/S"] = setup.allocation.S
        out[alloc + "/W"] = np.asarray(setup_encode_weights(setup))
        out[alloc + "/rates"] = np.asarray(setup.cocoef_cfg.straggler_rates)
        for t in range(3):
            out[alloc + f"/mask{{t}}"] = np.asarray(
                setup.straggler_process.mask(key, t))
    params, e, opt = setup.init_state(key)
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p0/" + "/".join(k.key for k in p)] = np.asarray(v)
    flat = lambda leaves: np.asarray(flatten_local(leaves, 4, {G})[0])
    step = jax.jit(setup.train_step)
    for t in range(3):
        batch = make_batch_for_step(setup, spec, shape, key, t, smoke=True)
        out[f"tokens{{t}}"] = np.asarray(batch["inputs"])
        out[f"weights{{t}}"] = np.asarray(batch["weights"])
        params, e, opt, m = step(params, e, opt, batch, jnp.int32(t), key)
        out[f"loss{{t}}"] = np.asarray(m["loss"])
        out[f"theta{{t + 1}}"] = flat(jax.tree.leaves(params))
    np.savez(sys.argv[1], **out)
""")

PLAN = PlanSpec(d=2, group_size=G, num_ranks=N)


@pytest.fixture(scope="module")
def jax_plan_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_plan") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", JAX_PLAN_RUN, str(path),
                        PLAN.to_json()],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("alloc", ("rate_aware", "exact_load"))
def test_hetero_plan_setup_equals_jax(jax_plan_run, alloc):
    """Allocation, rates, encode weights and masks exactly JAX's.  The
    rate-aware placement of 4 ranks has unequal loads (3, 2, 2, 1), which
    neither package's batch maker can stack; the exact-load placement
    keeps 2 subsets a rank."""
    ref = jax_plan_run
    s = _port_setup(plan=dataclasses.replace(PLAN, allocation=alloc),
                    straggler="hetero")
    np.testing.assert_array_equal(s.allocation.S, ref[alloc + "/S"])
    np.testing.assert_array_equal(s.W, ref[alloc + "/W"])
    np.testing.assert_array_equal(np.asarray(s.straggler_rates),
                                  ref[alloc + "/rates"])
    for t in range(3):
        np.testing.assert_array_equal(s.mask(t).numpy(),
                                      ref[alloc + f"/mask{t}"])
    loads = s.allocation.S.sum(1)
    assert (loads == 2).all() == (alloc == "exact_load")
    if alloc == "rate_aware":
        with pytest.raises(RuntimeError):            # rows of 3, 2, 2, 1
            s.make_batch(0)


def test_hetero_plan_training_matches_jax(jax_plan_run):
    """3 steps of the exact-load plan: batch weights and tokens exactly
    JAX's; losses and theta within the sign-wire bounds above."""
    ref = jax_plan_run
    s = _port_setup(plan=dataclasses.replace(PLAN, allocation="exact_load"),
                    straggler="hetero")
    e = s.init_state()
    s.model.load_params(_state_dict(ref))
    max_scale = 0.0
    for t in range(3):
        batch = s.make_batch(t)
        np.testing.assert_array_equal(batch[0].numpy(), ref[f"tokens{t}"])
        np.testing.assert_array_equal(batch[1].numpy(), ref[f"weights{t}"])
        m = s.train_step(s.model, e, batch, t)
        np.testing.assert_allclose(m["loss"].item(), ref[f"loss{t}"],
                                   rtol=1e-4)
        max_scale = max(max_scale, s.payload[1].max().item())
        d = np.abs(s.model.theta.numpy() - ref[f"theta{t + 1}"])
        assert d.max() <= (t + 1) * 2 * N * max_scale
        assert np.mean(d > 1e-6) < 0.01
    assert ShapeCfg("train", 32, 8).global_batch // N * 2 == s.b_loc

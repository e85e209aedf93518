"""The port's counterparts of JAX's two examples, on the CPU, on one torch
thread:

  - `repro_torch.launch.quickstart.main(device="cpu", steps=31)` against
    JAX's `error_feedback` steps run here for the same 31 steps (JAX's
    constants: linreg seed 0, N = M = 100, d 5, p 0.2; GroupedSign at
    1e-5 against StochasticSign at 2e-6): F(theta) every 10 steps within
    1e-5 relative (JAX sums Z @ theta in XLA's order and F in f32, the
    port in fixed trees and F in f64: 1.2e-7 seen);
  - `repro_torch.launch.elastic_restart.run` at smoke size (3 steps on 4
    coding ranks, the checkpoint, 3 on 2) against JAX's
    `examples/elastic_restart.py` itself, run once in a subprocess with
    its module's STEPS_1 = STEPS_2 = 3 and CKPT under the test's temp
    dir (the file is not edited; its `RateEstimator` is wrapped to log
    every mask it is fed and the rates after every update and after the
    resize): the masks, the rates (numpy float64 in both) and the replan
    epochs equal, the losses within 1e-3 relative (olmoe's smoke config
    computes in bf16; JAX's mesh also shards each leaf over its model
    axis, which the port has not, and its printed losses carry 4
    decimals: 2.2e-4 seen); and within the port, the rescaled error rows
    of the ranks in both grids equal phase 1's rows bit for bit (cut to
    the smaller flat size, zeros elsewhere), and so does a momentum
    optimizer's state.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_cases import SRC, one_thread
from repro.core import coding as jcoding, compression as jcomp
from repro.core import error_feedback as JEF
from repro.data import tasks as jtasks
from repro_torch.launch import elastic_restart, quickstart
from repro_torch.optim.optimizers import OptimizerConfig

EXAMPLES = str(Path(SRC).parent / "examples")
STEPS = 3

JAX_ELASTIC = textwrap.dedent("""
    import contextlib, io, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[2])
    import numpy as np
    import elastic_restart as ex
    log = []

    class Logged(ex.RateEstimator):
        def update(self, mask):
            out = super().update(mask)
            log.append({"mask": np.asarray(mask, np.float64).tolist(),
                        "rates": self.rates.tolist()})
            return out

        def resize(self, num_new, survivors=None):
            super().resize(num_new, survivors)
            log.append({"resize": num_new, "rates": self.rates.tolist()})

    ex.RateEstimator = Logged
    ex.STEPS_1 = ex.STEPS_2 = int(sys.argv[3])
    ex.CKPT = os.path.join(sys.argv[1], "ckpt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex.main()
    with open(os.path.join(sys.argv[1], "out.json"), "w") as f:
        json.dump({"stdout": buf.getvalue(), "log": log}, f)
""")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def test_quickstart_matches_jax(capsys):
    got = quickstart.main(device="cpu", steps=31, every=10)
    text = capsys.readouterr().out
    assert "\nCOCO-EF (Sign)  [proposed]  (1 bit/coordinate on the wire)" \
        in text
    assert re.search(r"\n  step    0  F\(theta\) = +759825\.7\n", text)
    grad_fn, loss_fn, theta0, _ = jtasks.linreg_task(seed=0)
    alloc = jcoding.random_allocation(seed=0, num_devices=100,
                                      num_subsets=100, d=5)
    W = jcoding.encode_weights(alloc, p=0.2)
    key = jax.random.PRNGKey(42)
    runs = {"COCO-EF (Sign)  [proposed]": (JEF.cocoef_step,
                                           jcomp.GroupedSign(), 1e-5, False),
            "Unbiased (Sign) [baseline]": (JEF.unbiased_step,
                                           jcomp.StochasticSign(), 2e-6,
                                           True)}
    assert list(got) == list(runs) == list(quickstart.RUNS)
    for name, (step_fn, comp, lr, needs_key) in runs.items():
        st = JEF.EFState.init(theta0, 100)
        want = []
        for t in range(31):
            mask = jcoding.straggler_mask(key, t, 100, p=0.2)
            kk = (jax.random.fold_in(jax.random.PRNGKey(7), t) if needs_key
                  else None)
            st = step_fn(st, grad_fn, W, mask, lr, comp, step=t, key=kk)
            if t % 10 == 0:
                want.append((t, float(loss_fn(st.theta))))
        assert [t for t, _ in got[name]] == [t for t, _ in want]
        np.testing.assert_allclose([f for _, f in got[name]],
                                   [f for _, f in want], rtol=1e-5)
        assert want[-1][1] < want[0][1] / 3          # it trains


@pytest.fixture(scope="module")
def jax_elastic(tmp_path_factory):
    """JAX's examples/elastic_restart.py, STEPS steps a phase: its stdout
    and its estimator's log."""
    d = tmp_path_factory.mktemp("jax_elastic")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", JAX_ELASTIC, str(d), EXAMPLES,
                        str(STEPS)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads((d / "out.json").read_text())


def _steps(stdout: str):
    """(step, loss, replan epoch or None) of each printed step line."""
    return [(int(t), float(loss), int(ep) if ep else None)
            for t, loss, ep in re.findall(
                r"^  step +(\d+) loss=([-\d.]+)"
                r"(?: \(replan -> epoch (\d+)\))?$", stdout, re.M)]


def test_elastic_restart_matches_jax(jax_elastic, tmp_path, capsys):
    out = elastic_restart.run(device="cpu", steps_1=STEPS, steps_2=STEPS,
                              ckpt=str(tmp_path / "ckpt"))
    text = capsys.readouterr().out
    assert not (tmp_path / "ckpt").exists()          # removed at the end
    recs = out["phase1"]["steps"] + out["phase2"]["steps"]
    assert [r["step"] for r in recs] == list(range(2 * STEPS))
    assert (out["phase1"]["n_code"], out["phase2"]["n_code"]) == (4, 2)
    want = _steps(jax_elastic["stdout"])
    assert _steps(text) == [(t, round(r["loss"], 4), e) for (t, _, e), r
                            in zip(want, recs)]
    np.testing.assert_allclose([r["loss"] for r in recs],
                               [loss for _, loss, _ in want], rtol=1e-3)
    assert [r["epoch"] if r["reallocated"] else None for r in recs] == \
        [e for _, _, e in want]
    log = jax_elastic["log"]
    assert [x.get("resize") for x in log] == \
        [None] * STEPS + [2] + [None] * STEPS
    upd = [x for x in log if "mask" in x]
    assert [r["mask"] for r in recs] == [x["mask"] for x in upd]
    assert [r["rates"] for r in recs] == [x["rates"] for x in upd]
    assert out["rates"].tolist() == log[STEPS]["rates"]
    assert "[phase 1] checkpointed at step 3" in text
    assert f"[phase 2] step {2 * STEPS} loss=" in text


@pytest.mark.parametrize("kind", ["sgd", "momentum"])
def test_elastic_rescale_keeps_the_surviving_rows(kind):
    rows = []
    out = elastic_restart.run(
        device="cpu", steps_1=2, steps_2=1, optimizer=OptimizerConfig(kind),
        digest=lambda r: rows.append([x.clone() for x in r]) or len(rows))
    info = out["resume"]
    assert elastic_restart.survivors((2, 2), (1, 2)) == [(0, 0), (1, 1)]
    before, restored = rows
    for a, b in zip(before, restored):           # the checkpoint's rows
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert info["e_rows_equal"] and info["e_tail_zero"]
    assert info["opt_equal"]
    assert out["setup"].opt_state == () if kind == "sgd" else \
        len(out["setup"].opt_state) == 1
    assert out["e"].shape == (2, out["phase2"]["flat_pad"])
    assert all(np.isfinite(r["loss"]) for r in out["phase2"]["steps"])

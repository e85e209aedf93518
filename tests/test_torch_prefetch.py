"""The port's host -> device prefetcher and batch streams
(`repro_torch/data/pipeline.py`, `launch/train.py::batch_stream`), the
counterparts of tests/test_prefetch.py, plus the prefetched train loop.

Consuming `prefetch_to_device` must be indistinguishable from mapping
`to_device` over the source: same order, same values, exceptions
re-raised at the consumer, and abandoning it must not leak a blocked
worker.  Batches are a function of (seed, step), so a prefetched run
trains on the synchronous run's bits: the streams are compared with
JAX's `coded_train_batch` and the driver's theta and e bit for bit.
Every thread wait has its own timeout (the suite runs without
pytest-timeout).  Tolerance: none, every comparison is exact.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.data import pipeline as jpipeline
from repro_torch.core import coding
from repro_torch.data import pipeline
from repro_torch.launch import train_e2e
from repro_torch.launch.train import batch_stream

from test_torch_driver import _run


def _no_prefetch_threads(timeout_s: float = 3.0) -> bool:
    """Wait for every prefetch worker to wind down."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate()
                if t.name == pipeline.PREFETCH_THREAD and t.is_alive()]:
            return True
        time.sleep(0.05)
    return False


def _pull(it, timeout_s: float = 10.0):
    """next(it) on a helper thread joined with a timeout, so a hung
    prefetcher fails the test instead of stalling the suite."""
    box = {}

    def go():
        try:
            box["v"] = next(it)
        except BaseException as exc:          # handed to the test below
            box["e"] = exc
    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(timeout_s)
    assert not th.is_alive(), "prefetcher hung"
    if "e" in box:
        raise box["e"]
    return box["v"]


def _drain(it, timeout_s: float = 10.0):
    out = []
    while True:
        try:
            out.append(_pull(it, timeout_s))
        except StopIteration:
            return out


def test_prefetch_preserves_order_and_values():
    items = [np.full((4,), i, np.float32) for i in range(10)]
    out = _drain(pipeline.prefetch_to_device(iter(items), size=2,
                                             device="cpu"))
    assert len(out) == 10
    for i, o in enumerate(out):
        assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
        np.testing.assert_array_equal(o.numpy(), items[i])
    assert _no_prefetch_threads()


def test_prefetch_matches_direct_to_device_on_trees():
    def gen():
        for i in range(6):
            yield {"toks": np.arange(3, dtype=np.int32) + i,
                   "w": (torch.ones(2) * i,)}

    direct = [pipeline.to_device(b, "cpu") for b in gen()]
    staged = _drain(pipeline.prefetch_to_device(gen(), size=3, device="cpu"))
    assert len(direct) == len(staged)
    for d, p in zip(direct, staged):
        assert torch.equal(d["toks"], p["toks"])
        assert isinstance(p["w"], tuple) and torch.equal(d["w"][0],
                                                         p["w"][0])


def test_prefetch_reraises_source_exception():
    def gen():
        yield np.zeros(2, np.float32)
        raise RuntimeError("synthetic pipeline failure")

    it = pipeline.prefetch_to_device(gen(), size=2, device="cpu")
    np.testing.assert_array_equal(_pull(it).numpy(), np.zeros(2))
    with pytest.raises(RuntimeError, match="synthetic pipeline failure"):
        _pull(it)
    assert _no_prefetch_threads()


def test_prefetch_early_abandonment_stops_worker():
    """close() mid-stream unblocks and joins the worker, though the source
    is infinite and the queue full; a dropped iterator does too."""
    produced = []

    def gen():
        i = 0
        while True:
            produced.append(i)
            yield np.full((2,), i, np.float32)
            i += 1

    it = pipeline.prefetch_to_device(gen(), size=2, device="cpu")
    _pull(it)
    _pull(it)
    it.close()
    assert _no_prefetch_threads()
    n_after_close = len(produced)
    time.sleep(0.2)                 # a leaked worker would keep producing
    assert len(produced) == n_after_close
    it = pipeline.prefetch_to_device(gen(), size=2, device="cpu")
    _pull(it)
    del it                          # __del__ stops and joins it
    assert _no_prefetch_threads()


def test_prefetch_size_validation():
    with pytest.raises(ValueError):
        pipeline.prefetch_to_device(iter([]), size=0, device="cpu")
    with pytest.raises(ValueError):
        batch_stream(None, prefetch=-1)


def test_prefetch_stall_counters_name_the_bottleneck():
    """A slow producer accumulates consumer_wait_s; a slow consumer
    accumulates producer_wait_s with the queue at its high-water mark."""
    def slow_gen(n, delay):
        for i in range(n):
            time.sleep(delay)
            yield np.full((2,), i, np.float32)

    it = pipeline.prefetch_to_device(slow_gen(5, 0.05), size=2, device="cpu")
    assert len(_drain(it)) == 5
    s = it.stats.snapshot()
    assert s["put_count"] == 5 and s["get_count"] == 5
    assert s["consumer_wait_s"] >= 0.1
    assert s["device_put_s"] >= 0.0
    assert set(s) == {"size", "put_count", "get_count", "producer_wait_s",
                      "consumer_wait_s", "device_put_s", "max_depth",
                      "depth_sum"}                      # JAX's keys
    assert _no_prefetch_threads()

    it = pipeline.prefetch_to_device(
        (np.full((2,), i, np.float32) for i in range(6)), size=2,
        device="cpu")
    time.sleep(0.3)                 # worker fills the queue, then blocks
    got = []
    while True:
        try:
            got.append(_pull(it))
        except StopIteration:
            break
        time.sleep(0.05)
    s = it.stats.snapshot()
    assert len(got) == 6
    assert s["max_depth"] == 2
    assert s["producer_wait_s"] >= 0.1
    assert s["depth_sum"] >= s["get_count"]
    assert _no_prefetch_threads()


def test_coded_batch_stream_matches_jax_per_step_batches():
    """The stream at any start_step yields coded_train_batch(t), equal to
    JAX's batch maker bit for bit; host_stream is synthetic_lm_batch."""
    N, d, p = 4, 2, 0.25
    alloc = coding.cyclic_allocation(N, N, d)
    W = coding.encode_weights(alloc, p)
    jW = np.asarray(jcoding.encode_weights(jcoding.cyclic_allocation(N, N, d),
                                           p))
    np.testing.assert_array_equal(W, jW)
    stream = pipeline.coded_batch_stream(0, alloc, W, per_subset=2,
                                         seq_len=8, vocab=97, start_step=3)
    for t in range(3, 7):
        toks, wts = next(stream)
        rt, rw = jpipeline.coded_train_batch(jax.random.PRNGKey(0), t, alloc,
                                             jW, 2, 8, 97)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(wts.numpy(), np.asarray(rw))
    cfg = pipeline.SyntheticLMConfig(vocab_size=61, seq_len=8,
                                     global_batch=3, seed=5)
    hs = pipeline.host_stream(cfg, start_step=2)
    for t in (2, 3):
        want = jpipeline.synthetic_lm_batch(jax.random.PRNGKey(5), t, 3, 8,
                                            61)
        np.testing.assert_array_equal(next(hs).numpy(), np.asarray(want))
    sids = alloc.subsets_of(1)
    toks, wts = pipeline.subset_batch_for_rank(
        prng_key(7), 4, sids, W[1, sids] / 2, 2, 8, 97)
    jt, jw = jpipeline.subset_batch_for_rank(jax.random.PRNGKey(7), 4, sids,
                                             jW[1, sids] / 2, 2, 8, 97)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(wts.numpy(), np.asarray(jw))


def prng_key(seed):
    from repro_torch.core import prng
    return prng.PRNGKey(seed)


def test_prefetched_coded_stream_end_to_end():
    """prefetch(coded_batch_stream) == the synchronous loop, batch for
    batch."""
    N, d, p = 4, 4, 0.2
    alloc = coding.cyclic_allocation(N, N, d)
    W = coding.encode_weights(alloc, p)
    it = pipeline.prefetch_to_device(
        pipeline.coded_batch_stream(7, alloc, W, 2, 8, 61), size=2,
        device="cpu")
    for t in range(5):
        toks, wts = _pull(it)
        rt, rw = pipeline.coded_train_batch(7, t, alloc, W, 2, 8, 61)
        assert torch.equal(toks, rt) and torch.equal(wts, rw)
    it.close()
    assert _no_prefetch_threads()


@pytest.mark.parametrize("flags", [(), ("--elastic",)],
                         ids=["static", "elastic"])
def test_prefetched_driver_equals_synchronous(tmp_path, flags):
    """The driver with --prefetch 2 trains on the synchronous run's bits:
    the same batches (static (tokens, weights) and elastic (tokens, ones,
    subset ids), across re-allocations), losses, theta and e."""
    common = ("--steps", "5", "--straggler", "markov", "--straggler-p",
              "0.25", "--ckpt-every", "100", *flags)
    sync = _run(tmp_path, "sync", *common)
    pre = _run(tmp_path, "pre", "--prefetch", "2", *common)
    assert sync["prefetch"] is None
    assert pre["prefetch"]["get_count"] == 5
    for a, b in zip(sync["steps"], pre["steps"]):
        for k in ("loss", "mask", "weights", "allocation"):
            assert a[k] == b[k], k
    if flags:       # the plane re-allocated mid-run, so staged batches
        assert any(r["replan"]["reallocated"] for r in sync["steps"][:-1])
    assert torch.equal(sync["setup"].model.theta, pre["setup"].model.theta)
    assert torch.equal(sync["e"], pre["e"])
    assert _no_prefetch_threads()

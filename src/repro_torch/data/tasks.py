"""The paper's experimental tasks as grad_fn factories (port of
`repro.data.tasks`: Task A, the linear regression of Sec. V.A, and Task
B, the heterogeneous image classification of Sec. V.B).

Both return (grad_fn, loss_fn, theta0, extras) with
  grad_fn(theta) -> (M, D) per-subset gradients (feeds eq. 3)
  loss_fn(theta) -> F(theta) = sum_k f_k(theta), a float
drawn from the same `np.random.default_rng(seed)` stream as JAX's, so the
data and theta0 are bit-identical.

Task A: f_k(theta) = 0.5 (<theta, z_k> - y_k)^2 with z_k ~ N(0, 100) in
R^D and y_k ~ N(<z_k, theta_hat>, 1).  The dot products <theta, z_k> are
summed as a fixed binary tree of rounded f32 adds (`kernels.ref.
tree_sum`), and so is F's f64 sum of squares: the same bits on the CPU
and on the card, so the reference loop on either device gives the same
trajectory.  JAX's `Z @ theta` sums in XLA's order, so free-running
trajectories of the two packages agree within a tolerance
(tests/test_torch_reference.py).

Task B: a synthetic 10-class image set with the paper's heterogeneity
protocol (every subset holds one class; MNIST is not available offline)
and a small CNN trained with cross-entropy (`classification_task`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.kernels.ref import tree_sum

__all__ = ["linreg_task", "classification_task", "ClassificationModel",
           "ieee_f32"]


def _tree_dot(Z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(M,) f32: row k is sum_j Z[k, j] * theta[j], the products rounded
    to f32 and summed pairwise in a fixed binary tree."""
    return tree_sum(Z * theta)


def linreg_task(seed: int = 0, num_subsets: int = 100, dim: int = 100,
                device="cuda") -> Tuple[Callable, Callable, torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """Sec. V.A synthetic linear regression on `device`."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(0.0, 10.0, size=(num_subsets, dim))
    theta_hat = rng.normal(0.0, 1.0, size=(dim,))
    y = Z @ theta_hat + rng.normal(0.0, 1.0, size=(num_subsets,))
    theta0 = rng.normal(0.0, 1.0, size=(dim,))

    dev = resolve_device(device)
    Zt = torch.from_numpy(Z.astype(np.float32)).to(dev)
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)

    def grad_fn(theta: torch.Tensor) -> torch.Tensor:
        resid = _tree_dot(Zt, theta) - yt                    # (M,)
        return resid[:, None] * Zt                           # (M, D)

    def loss_fn(theta: torch.Tensor) -> float:
        resid = (_tree_dot(Zt, theta) - yt).double()
        return float(0.5 * tree_sum(resid * resid))

    return (grad_fn, loss_fn,
            torch.from_numpy(theta0.astype(np.float32)).to(dev),
            {"Z": Zt, "y": yt})


# --------------------------------------------------------------------------
# Task B: heterogeneous classification with a small CNN
# --------------------------------------------------------------------------

class ClassificationModel(NamedTuple):
    """Tiny CNN: conv(1->8, 3x3) - relu - pool2 - conv(8->16, 3x3) - relu -
    pool2 - dense(10).  The parameters are one flat vector (so the coding
    layer, which is per-coordinate, applies unchanged); `unravel(theta)`
    gives its leaves as views."""

    img: int
    unravel: Callable
    dim: int


def _leaf_shapes(img: int) -> Dict[str, Tuple[int, ...]]:
    """JAX's leaves in `ravel_pytree`'s order (keys sorted) and layouts:
    HWIO filters, (in, out) dense weights."""
    return {"b1": (8,), "b2": (16,), "b3": (10,), "w1": (3, 3, 1, 8),
            "w2": (3, 3, 8, 16), "w3": ((img // 4) ** 2 * 16, 10)}


def _unravel_of(img: int) -> Tuple[Callable, int]:
    """(unravel, D): unravel(theta) maps a flat (D,) tensor to its leaves,
    each a view of theta in C order."""
    shapes = _leaf_shapes(img)
    spans, off = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        spans[name] = (off, n, shape)
        off += n

    def unravel(theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: theta[o:o + n].view(shape)
                for k, (o, n, shape) in spans.items()}
    return unravel, off


def _init_cnn(key: np.ndarray, img: int, device="cuda"
              ) -> Tuple[torch.Tensor, Callable]:
    """(theta0 (D,) f32, unravel): JAX's `_init_cnn(key, img)` bit for bit:
    the key split three ways, each weight `jax.random.normal` in f32 times
    its Python float scale (one f32 rounding), the biases zero."""
    k1, k2, k3 = prng.split(key, 3)
    shapes = _leaf_shapes(img)
    leaves = {
        "w1": prng.normal(k1, shapes["w1"]) * np.float32((2.0 / 9) ** 0.5),
        "w2": prng.normal(k2, shapes["w2"]) * np.float32((2.0 / 72) ** 0.5),
        "w3": prng.normal(k3, shapes["w3"]) * np.float32(0.05),
    }
    unravel, dim = _unravel_of(img)
    flat = np.concatenate([leaves.get(k, np.zeros(s, np.float32)).ravel()
                           for k, s in shapes.items()]).astype(np.float32)
    assert flat.shape == (dim,)
    return torch.from_numpy(flat).to(resolve_device(device)), unravel


@contextlib.contextmanager
def ieee_f32():
    """Matmuls in plain IEEE f32 inside, whatever the global flags say (no
    TF32; the task's convolutions are matmuls, `_conv3x3`).  The previous
    flag comes back on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def _conv3x3(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX's "SAME" 3x3 convolution of NHWC h (B, H, W, C) with an HWIO
    filter w: the nine shifted windows of h zero-padded by one, stacked
    in HWIO's (kh, kw, c) order, times w as a (9 C, O) matrix.  Not
    `conv2d`: cuDNN's transform algorithms leave rounding noise where a
    direct sum gives exact zeros (the gradients of dead ReLU units, on
    which the sign compressors flip), and without cuDNN the card's
    `conv2d` runs an image at a time."""
    B, H, W, C = h.shape
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([hp[:, i:i + H, j:j + W] for i in range(3)
                        for j in range(3)], dim=3)        # (B, H, W, 9, C)
    return cols.reshape(B, H, W, 9 * C) @ w.reshape(9 * C, -1)


def _pool(h: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, "VALID" (14 -> 7 -> 3, floor), of NHWC h;
    a tie routes its gradient to one position, as XLA's does."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _cnn_logits(params: Dict[str, torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    """x: (B, img, img, 1) NHWC -> (B, 10), in JAX's layouts throughout:
    each bias added after its convolution, as JAX adds it, and the pooled
    features flattened in (h, w, c) order before w3."""
    h = x
    for w, b in (("w1", "b1"), ("w2", "b2")):
        h = _pool(F.relu(_conv3x3(h, params[w]) + params[b]))
    return h.reshape(h.shape[0], -1) @ params["w3"] + params["b3"]


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


def classification_task(seed: int = 0, num_subsets: int = 100,
                        samples_per_subset: int = 16, img: int = 14,
                        test_samples: int = 512, device="cuda"):
    """Sec. V.B protocol on `device`: M single-class subsets of
    `samples_per_subset` noisy class templates, a balanced test split.
    Returns (grad_fn, loss_fn, theta0, {"model", "test_metrics",
    "train_metrics", "X", "Y", "Xte", "Yte"}); the metrics give (mean
    cross-entropy, accuracy) as floats; X (M, S, img, img, 1) f32 and Y
    (M, S) int64, Xte and Yte the test split.  grad_fn takes every
    subset's gradient in one batched pass (`torch.func.vmap` of
    `torch.func.grad`).  Every call runs inside
    `ieee_f32`, so on the card the convolutions (matmuls, `_conv3x3`) are
    IEEE f32 whatever the global TF32 flags are."""
    rng = np.random.default_rng(seed)
    # class templates: smooth random blobs
    templates = rng.normal(0, 1, size=(10, img, img))
    kern = np.ones((3, 3)) / 9.0
    for c in range(10):
        t = templates[c]
        for _ in range(2):
            t = np.pad(t, 1, mode="edge")
            t = sum(t[i:i + img, j:j + img] * kern[i, j]
                    for i in range(3) for j in range(3))
        templates[c] = t / (np.abs(t).max() + 1e-9)

    subset_class = np.arange(num_subsets) % 10
    rng.shuffle(subset_class)
    noise = 0.6

    def make_split(n_per, classes):
        xs, ys = [], []
        for c in classes:
            xs.append(templates[c][None]
                      + noise * rng.normal(0, 1, (n_per, img, img)))
            ys.append(np.full((n_per,), c))
        return (np.concatenate(xs).astype(np.float32),
                np.concatenate(ys).astype(np.int32))

    X = np.stack([templates[c][None] + noise * rng.normal(
        0, 1, (samples_per_subset, img, img)) for c in subset_class])
    Y = np.stack([np.full((samples_per_subset,), c) for c in subset_class])
    Xte, Yte = make_split(test_samples // 10, np.arange(10))

    dev = resolve_device(device)
    Xt = torch.from_numpy(X[..., None].astype(np.float32)).to(dev)
    Yt = torch.from_numpy(Y.astype(np.int64)).to(dev)
    Xte_t = torch.from_numpy(Xte[..., None]).to(dev)
    Yte_t = torch.from_numpy(Yte.astype(np.int64)).to(dev)

    theta0, unravel = _init_cnn(prng.PRNGKey(seed + 1), img, dev)
    model = ClassificationModel(img=img, unravel=unravel,
                                dim=theta0.shape[0])

    def subset_loss(theta, x, y):
        return _xent(_cnn_logits(unravel(theta), x), y)

    per_subset_grad = torch.func.vmap(torch.func.grad(subset_loss),
                                      in_dims=(None, 0, 0))

    def grad_fn(theta: torch.Tensor) -> torch.Tensor:
        with ieee_f32():
            return per_subset_grad(theta, Xt, Yt)

    @torch.no_grad()
    def loss_fn(theta: torch.Tensor) -> float:
        with ieee_f32():
            losses = torch.func.vmap(subset_loss, in_dims=(None, 0, 0))(
                theta, Xt, Yt)
            return float(tree_sum(losses))

    @torch.no_grad()
    def metrics(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor
                ) -> Tuple[float, float]:
        with ieee_f32():
            logits = _cnn_logits(unravel(theta), x)
            acc = (torch.argmax(logits, -1) == y).to(torch.float32).mean()
            return float(_xent(logits, y)), float(acc)

    def test_metrics(theta):
        return metrics(Xte_t, Yte_t, theta)

    def train_metrics(theta):
        return metrics(Xt.reshape(-1, img, img, 1), Yt.reshape(-1), theta)

    return grad_fn, loss_fn, theta0, dict(
        model=model, test_metrics=test_metrics, train_metrics=train_metrics,
        X=Xt, Y=Yt, Xte=Xte_t, Yte=Yte_t)

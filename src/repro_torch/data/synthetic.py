"""Deterministic synthetic data pipelines, the port's copy of
``repro/data/synthetic.py``: the same numpy draws (Philox generators keyed
by seed and step), so every batch is byte-equal to the reference's; the
arrays end as torch tensors on ``device`` (the GPU when None).

* ``TokenPipeline`` — LM token stream with learnable bigram/repeat structure.
  Stateless per step: batch(step) is a pure function of (seed, step).
* ``pseudo_mnist_batch`` — 10 fixed smooth prototypes + jitter + noise,
  28×28, for the paper's §3.1 classification benchmark.
* ``smooth_images`` — band-limited random images for the §3.2 auto-encoder.
* ``parabola_batch`` — the §2.1 Fig. 2 toy regression.
* ``class_images`` — ImageNet-like classes for the §3.3 AlexNet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TokenPipeline", "pseudo_mnist_batch", "smooth_images",
           "parabola_batch", "class_images"]


def _t(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
        resolve_device(device))


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    repeat_p: float = 0.6     # P(next token == current) — learnable structure
    device: object = None     # where the tokens go (the GPU when None)

    def batch_at(self, step: int) -> dict:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        toks = np.empty((self.batch, self.seq), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        rep = rng.random((self.batch, self.seq - 1)) < self.repeat_p
        fresh = rng.integers(0, self.vocab, (self.batch, self.seq - 1))
        for t in range(1, self.seq):
            toks[:, t] = np.where(rep[:, t - 1], toks[:, t - 1],
                                  fresh[:, t - 1])
        return {"tokens": _t(toks, np.int32, self.device)}


_PROTO_CACHE = {}


def _prototypes(n_classes: int, side: int, seed: int = 7):
    key = (n_classes, side, seed)
    if key not in _PROTO_CACHE:
        rng = np.random.Generator(np.random.Philox(seed))
        f = rng.normal(size=(n_classes, 4, 4))
        big = np.zeros((n_classes, side, side))
        big[:, :4, :4] = f
        proto = np.real(np.fft.ifft2(big, axes=(1, 2)))
        proto = proto / (np.abs(proto).max(axis=(1, 2), keepdims=True) + 1e-9)
        _PROTO_CACHE[key] = proto.astype(np.float32)
    return _PROTO_CACHE[key]


def pseudo_mnist_batch(step: int, batch: int = 128, side: int = 28,
                       n_classes: int = 10, noise: float = 0.25,
                       seed: int = 0, device=None):
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    proto = _prototypes(n_classes, side)
    labels = rng.integers(0, n_classes, batch)
    imgs = proto[labels].copy()
    # random shift ±2px
    sh = rng.integers(-2, 3, (batch, 2))
    imgs = np.stack([np.roll(np.roll(im, s0, 0), s1, 1)
                     for im, (s0, s1) in zip(imgs, sh)])
    imgs += rng.normal(scale=noise, size=imgs.shape)
    return {"x": _t(imgs.reshape(batch, -1), np.float32, device),
            "y": _t(labels, np.int32, device)}


def smooth_images(step: int, batch: int = 32, side: int = 32, chans: int = 3,
                  seed: int = 0, bands: int = 6, device=None):
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    f = np.zeros((batch, side, side, chans), np.complex128)
    f[:, :bands, :bands, :] = (rng.normal(size=(batch, bands, bands, chans))
                               + 1j * rng.normal(size=(batch, bands, bands, chans)))
    img = np.real(np.fft.ifft2(f, axes=(1, 2)))
    img = img / (np.abs(img).max(axis=(1, 2, 3), keepdims=True) + 1e-9)
    return {"x": _t(img, np.float32, device)}


def parabola_batch(step: int, batch: int = 256, seed: int = 0, device=None):
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    x = rng.uniform(-1, 1, (batch, 1))
    return {"x": _t(x, np.float32, device),
            "y": _t(x * x, np.float32, device)}


def class_images(step: int, batch: int = 64, side: int = 64, chans: int = 3,
                 n_classes: int = 1000, noise: float = 0.3, seed: int = 1,
                 device=None):
    """ImageNet-like synthetic classification (AlexNet benchmark)."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    proto = _prototypes(n_classes, side, seed=11)
    labels = rng.integers(0, n_classes, batch)
    imgs = proto[labels][..., None].repeat(chans, axis=-1)
    imgs = imgs + rng.normal(scale=noise, size=imgs.shape)
    return {"x": _t(imgs, np.float32, device),
            "y": _t(labels, np.int32, device)}

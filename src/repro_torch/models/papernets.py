"""The paper's own experiment networks (§3): MLP, auto-encoders, AlexNet-ish,
the port's copy of ``repro/models/papernets.py``.

The parameter trees are the reference's: dense weights (d_in, d_out) with a
bias, conv kernels HWIO, activations NHWC, so ``bridge.from_jax_params``
carries a reference tree across unchanged.  Every ``dense`` takes a
``backend`` (``kernels.dispatch``), the port's form of the reference's
``dispatch.use_backend`` context: an MLP in index form runs through
``codebook_matmul`` or the lut backend as it does in the reference.  Convs
run as NCHW views of the NHWC tensors (``F.conv2d``, plain PyTorch, as the
reference leaves them to XLA).

Every net trains under autograd: at ``act_levels > 0`` the activations
pass the underlying function's derivative (``core.activations``), as the
paper trains them (§2.1).  Dropout takes a ``torch.Generator`` in place of
the reference's ``jax.random`` key, whose bits no torch generator
reproduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.layers import dense, dense_init, ffn_act

__all__ = ["mlp_init", "mlp_apply", "fc_autoencoder_init",
           "fc_autoencoder_apply", "conv_autoencoder_init",
           "conv_autoencoder_apply", "alexnet_init", "alexnet_features",
           "alexnet_head", "alexnet_apply", "mlp_layer_sizes"]


# --- MNIST-style MLP (paper §3.1) ---------------------------------------------

def mlp_layer_sizes(d_in: int, hidden: list[int], d_out: int):
    dims = [d_in] + list(hidden) + [d_out]
    return list(zip(dims[:-1], dims[1:]))


def mlp_init(gen: torch.Generator, d_in: int, hidden: list[int], d_out: int,
             dtype=torch.float32, device=None):
    """{'layer{i}': {'w': N(0, 1/d_in), 'b': zeros}}, drawn from ``gen`` (a
    generator on ``device``, the GPU when None)."""
    dev = resolve_device(device)
    return {f"layer{i}": dense_init(gen, a, b, dtype, dev, std=a ** -0.5,
                                    bias=True)
            for i, (a, b) in enumerate(mlp_layer_sizes(d_in, hidden, d_out))}


def mlp_apply(p, x, act_kind: str = "tanh", act_levels: int = 0,
              backend: dispatch.BackendSpec = dispatch.DENSE):
    n = len(p)
    for i in range(n):
        x = dense(p[f"layer{i}"], x, backend)
        if i < n - 1:
            x = ffn_act(x, act_kind, act_levels)
    return x


# --- FC auto-encoder (paper §3.2: 7 hidden layers, 50n..20n..50n) -------------

def fc_autoencoder_init(gen: torch.Generator, d_in: int, n: float = 1.0,
                        dtype=torch.float32, device=None):
    hidden = [int(50 * n), int(50 * n), int(40 * n), int(20 * n),
              int(40 * n), int(50 * n), int(50 * n)]
    return mlp_init(gen, d_in, hidden, d_in, dtype, device)


def fc_autoencoder_apply(p, x, act_kind: str = "tanh", act_levels: int = 0,
                         backend: dispatch.BackendSpec = dispatch.DENSE):
    return mlp_apply(p, x, act_kind, act_levels, backend)


# --- Conv auto-encoder (paper §3.2) -------------------------------------------

def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int, dtype,
               device):
    std = (2.0 / (k * k * cin)) ** 0.5      # He init (ReLU-family nets)
    w = torch.randn((k, k, cin, cout), generator=gen, device=device)
    return {"w": (w * std).to(dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: the output has
    ceil(size/stride) positions, and the low side takes the smaller half
    of the total (so at k = 5, stride 2 on an even side: 1 low, 2 high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride: int = 1):
    """``lax.conv_general_dilated(x, w, stride, "SAME")`` in NHWC / HWIO,
    plus the bias: an explicit (possibly asymmetric) pad, then
    ``F.conv2d`` on NCHW views."""
    w = p["w"]
    k_h, k_w = w.shape[0], w.shape[1]
    (h_lo, h_hi), (w_lo, w_hi) = (_same_pads(x.shape[1], k_h, stride),
                                  _same_pads(x.shape[2], k_w, stride))
    xc = F.pad(x.permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


def _conv_t(p, x, stride: int = 2):
    """``lax.conv_transpose(x, w, stride, "SAME")`` (``transpose_kernel``
    False) in NHWC / HWIO, plus the bias: the stride-dilated input padded
    as XLA pads it, correlated with w as it is.  ``F.conv_transpose2d``
    correlates with its kernel flipped, so it is given w as (I, O, kH, kW)
    flipped in both spatial axes; its output, padded k − 1 on each side,
    is then cropped (or padded with zeros) to XLA's padding."""
    w = p["w"]
    k = (w.shape[0], w.shape[1])
    wt = torch.flip(w.permute(2, 3, 0, 1), dims=(2, 3))
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=stride)
    crop = []
    for size, kk in zip(x.shape[1:3], k):
        pad_len = kk + stride - 2
        pad_a = kk - 1 if stride > kk - 1 else -(-pad_len // 2)
        lo = (kk - 1) - pad_a               # ≥ 0 for "SAME"
        crop.append((lo, size * stride))    # XLA's output: size·stride
    (h0, hn), (w0, wn) = crop
    y = y[:, :, h0:h0 + hn, w0:w0 + wn]
    y = F.pad(y, (0, wn - y.shape[3], 0, hn - y.shape[2]))
    return y.permute(0, 2, 3, 1) + p["b"]


def conv_autoencoder_init(gen: torch.Generator, n: float = 1.0, c_in: int = 3,
                          dtype=torch.float32, device=None):
    """Paper: 4 conv 2×2 (50n,50n,40n,20n) + 3 conv-T (40n,50n,50n) +
    two 1×1 convs (20, c_in).  Strides (2,2,2,1)/(2,2,2) keep in/out sizes
    equal."""
    dev = resolve_device(device)
    d = [int(50 * n), int(50 * n), int(40 * n), int(20 * n)]
    dt = [int(40 * n), int(50 * n), int(50 * n)]
    p = {}
    cin = c_in
    for i, c in enumerate(d):
        p[f"enc{i}"] = _conv_init(gen, 2, cin, c, dtype, dev)
        cin = c
    for i, c in enumerate(dt):
        p[f"dec{i}"] = _conv_init(gen, 2, cin, c, dtype, dev)
        cin = c
    p["post0"] = _conv_init(gen, 1, cin, 20, dtype, dev)
    p["post1"] = _conv_init(gen, 1, 20, c_in, dtype, dev)
    return p


def conv_autoencoder_apply(p, x, act_kind: str = "tanh", act_levels: int = 0):
    def a(v):
        return ffn_act(v, act_kind, act_levels)

    h = x
    for i, s in enumerate((2, 2, 2, 1)):
        h = a(_conv(p[f"enc{i}"], h, s))
    for i in range(3):
        h = a(_conv_t(p[f"dec{i}"], h, 2))
    h = a(_conv(p["post0"], h, 1))
    return _conv(p["post1"], h, 1)


# --- AlexNet-style classifier (paper §3.3), width-scalable --------------------

def alexnet_init(gen: torch.Generator, n_classes: int = 1000,
                 width: float = 1.0, c_in: int = 3, img: int = 64,
                 dtype=torch.float32, device=None):
    dev = resolve_device(device)

    def w(c):
        return max(8, int(c * width))

    p = {
        "c1": _conv_init(gen, 5, c_in, w(96), dtype, dev),
        "c2": _conv_init(gen, 5, w(96), w(256), dtype, dev),
        "c3": _conv_init(gen, 3, w(256), w(384), dtype, dev),
        "c4": _conv_init(gen, 3, w(384), w(384), dtype, dev),
        "c5": _conv_init(gen, 3, w(384), w(256), dtype, dev),
    }
    spatial = img // 16  # c1 stride2 + three pools
    feat = w(256) * spatial * spatial

    def he(fan):
        return (2.0 / fan) ** 0.5

    p["f6"] = dense_init(gen, feat, w(1024), dtype, dev, std=he(feat),
                         bias=True)
    p["f7"] = dense_init(gen, w(1024), w(1024), dtype, dev,
                         std=he(w(1024)), bias=True)
    p["f8"] = dense_init(gen, w(1024), n_classes, dtype, dev,
                         std=he(w(1024)), bias=True)
    return p


def _maxpool(x):
    """2 × 2 max pool, stride 2, VALID, on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _dropout(h, rate: float, gen: torch.Generator):
    keep = torch.rand(h.shape, generator=gen, device=h.device) < 1 - rate
    return h * keep.to(h.dtype) / (1 - rate)


def alexnet_features(p, x, act_kind: str = "relu6", act_levels: int = 0):
    """The conv trunk: c1 (stride 2) … c5 and three pools, NHWC."""
    def a(v):
        return ffn_act(v, act_kind, act_levels)

    h = a(_conv(p["c1"], x, 2))
    h = _maxpool(h)
    h = a(_conv(p["c2"], h, 1))
    h = _maxpool(h)
    h = a(_conv(p["c3"], h, 1))
    h = a(_conv(p["c4"], h, 1))
    h = a(_conv(p["c5"], h, 1))
    return _maxpool(h)


def alexnet_head(p, h, act_kind: str = "relu6", act_levels: int = 0,
                 dropout_rate: float = 0.0, generator=None,
                 backend: dispatch.BackendSpec = dispatch.DENSE):
    """Logits of the trunk's output ``h`` (NHWC): f6, f7, f8."""
    def a(v):
        return ffn_act(v, act_kind, act_levels)

    h = h.reshape(h.shape[0], -1)                   # NHWC order, as f6's rows
    h = a(dense(p["f6"], h, backend))
    if dropout_rate and generator is not None:
        h = _dropout(h, dropout_rate, generator)
    h = a(dense(p["f7"], h, backend))
    if dropout_rate and generator is not None:
        h = _dropout(h, dropout_rate, generator)
    return dense(p["f8"], h, backend)


def alexnet_apply(p, x, act_kind: str = "relu6", act_levels: int = 0,
                  dropout_rate: float = 0.0, generator=None,
                  backend: dispatch.BackendSpec = dispatch.DENSE):
    """Logits of NHWC images; dropout after f6 and f7 only with a rate and
    a ``generator`` (on x's device)."""
    return alexnet_head(p, alexnet_features(p, x, act_kind, act_levels),
                        act_kind, act_levels, dropout_rate, generator,
                        backend)

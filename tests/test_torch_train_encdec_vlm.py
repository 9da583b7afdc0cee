"""Training of the encoder-decoder (whisper-small) and vision-language
(qwen2-vl-7b) families in the port against the JAX package's, computed
live, and one train step of every assigned architecture:

* ``Model.loss`` within 1e-6 and every gradient leaf within 1e-5 of its
  largest |g| of ``jax.grad``'s at act_levels 0 and 32, every FFN site
  locked (``train_rig.lock_ffn``): whisper's encoder (non-causal
  attention, the position table, the biased MLP) and its decoder's
  cross-attention over the encoder's output (Lq ≠ Lk, the flash backward
  with no mask); qwen2-vl's M-RoPE over (3, B, L) positions, its prompts
  embeddings that take no gradient;
* one ``make_train_step`` update (``train_rig.check_step``);
* qwen2-vl at ``microbatches`` 2: ``positions`` split on their batch
  axis, as the reference's ``split_mb`` does, each row its own streams;
* the vlm's ``embed`` table, which its loss never reads (untied head,
  embeddings in), gets zeros from ``value_and_grad``, as from
  ``jax.grad``;
* ``launch.train.train`` on the audio and vlm families fails as the
  reference's does (its pipeline gives tokens only): the same exception
  type and text;
* the twin of ``tests/test_models.py::test_arch_smoke_forward_and_train_
  step`` over every assigned architecture: the port's forward finite and
  of the reference's shape, one step at the config's own remat moving the
  params, and one step (remat off on both sides, sites and rwkv's streams
  locked) within ``check_step``'s bounds of the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as C  # noqa: E402
from recurrent_rig import lock_streams  # noqa: E402
from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from train_rig import (batch, check_loss_and_grads,  # noqa: E402
                       check_step, jax_batch, lock_ffn, models, tparams,
                       torch_batch)

torch.set_num_threads(2)

ARCHS = ["whisper-small", "qwen2-vl-7b"]


def _sites(cfg) -> int:
    """FFN sites a forward: a biased MLP an encoder and a decoder block
    (whisper), a SwiGLU a layer (qwen2-vl)."""
    return cfg.n_layers + cfg.enc_layers


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(monkeypatch, arch, levels):
    ns = models(arch, levels)
    stats = lock_ffn(monkeypatch)
    worst = check_loss_and_grads(ns, batch(ns.cfg))
    assert not stats["pending"] and stats["sites"] == _sites(ns.cfg)
    print(f"{arch} levels {levels}: worst gradient share {worst:.2e}, "
          f"{stats['flips']} flips at boundary ties in {stats['acts']} "
          f"activations")


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(monkeypatch, arch, levels):
    ns = models(arch, levels)
    stats = lock_ffn(monkeypatch)
    r = check_step(ns, batch(ns.cfg, seed=1), monkeypatch)
    assert not stats["pending"] and stats["sites"] == _sites(ns.cfg)
    print(f"{arch} levels {levels}: {r}")


def test_vlm_microbatches_split_positions(monkeypatch):
    """qwen2-vl at ``microbatches`` 2 over 4 rows whose M-RoPE streams
    differ row by row: the step's averaged gradients, loss and update
    within ``check_step``'s bounds of the reference's, which splits
    ``positions`` (3, B, L) into (2, 3, B/2, L)."""
    ns = models("qwen2-vl-7b", 32, microbatches=2)
    stats = lock_ffn(monkeypatch)
    b = batch(ns.cfg, B=4, seed=3)
    assert len({tuple(b["positions"][:, i].ravel()) for i in range(4)}) == 4
    r = check_step(ns, b, monkeypatch)
    assert not stats["pending"] and stats["sites"] == 2 * ns.cfg.n_layers
    print(f"microbatches 2: {r}")


def test_vlm_unused_embed_gets_zeros():
    """The vlm's loss reads the embeddings and ``lm_head``, never
    ``embed``: ``jax.grad`` gives it zeros, ``value_and_grad`` too, in
    its dtype (``torch.autograd.grad`` alone raises for such a leaf)."""
    ns = models("qwen2-vl-7b")
    b = batch(ns.cfg)
    jg = jax.grad(lambda p: ns.model.loss(p, jax_batch(b))[0])(ns.params)
    assert not np.asarray(jg["embed"]["table"]).any()
    tp = tparams(ns.params)
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(
        tparams(ns.params))]
    grad_tree = jax.tree.unflatten(jax.tree.structure(tp), leaves)
    with pytest.raises(RuntimeError, match="not have been used"):
        torch.autograd.grad(ns.tmodel.loss(grad_tree, torch_batch(b))[0],
                            leaves)
    (loss, _), tg = value_and_grad(ns.tmodel.loss, tp, torch_batch(b))
    g = tg["embed"]["table"]
    assert g.dtype == tp["embed"]["table"].dtype and not g.any()
    assert tg["lm_head"]["w"].abs().max() > 0
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_fails_as_the_reference(arch):
    """``launch.train.train`` feeds token batches (``TokenPipeline``): the
    audio family's loss reads ``frames`` and the vlm's ``embeds``, which
    it lacks; both packages raise the same exception with the same
    text."""
    from repro.launch import train as JT
    from repro_torch import configs as TC
    from repro_torch.launch import train as TT
    kw = dict(steps=1, batch=2, seq=16, log_every=1)
    with pytest.raises(Exception) as want:
        JT.train(C.get(arch).reduced(), JT.TrainLoopConfig(**kw),
                 log=lambda *a: None)
    with pytest.raises(Exception) as got:
        TT.train(TC.get(arch).reduced(),
                 TT.TrainLoopConfig(**kw, device="cpu"), log=lambda *a: None)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    print(f"{arch}: {type(got.value).__name__}: {got.value}")


@pytest.mark.parametrize("name", ASSIGNED)
def test_arch_smoke_forward_and_train_step(monkeypatch, name):
    ns = models(name)
    b = batch(ns.cfg)
    own = dataclasses.replace(ns.tcfg, remat=C.get(name).reduced().remat)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    m = build(own)
    p0 = tparams(ns.params)
    logits = m.forward(p0, torch_batch(b))
    B, S = b["tokens"].shape
    assert logits.shape == (B, S, own.padded_vocab)
    assert torch.isfinite(logits).all()
    ocfg = OptConfig(lr=1e-3)
    p1, _, met = make_train_step(m, ocfg)(p0, init_opt_state(p0, ocfg),
                                          torch_batch(b))
    assert np.isfinite(float(met["loss"]))
    moved = sum(float((a.float() - c.float()).abs().sum())
                for a, c in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)))
    assert moved > 0

    stats = lock_ffn(monkeypatch)
    if ns.cfg.family == "ssm_rwkv":
        lock_streams(JR, TR, monkeypatch, straight=True)
    r = check_step(ns, b, monkeypatch)
    assert not stats["pending"]
    print(f"{name}: {r}")

"""Training of the recurrent families in the port against the JAX
package's, computed live: the reduced rwkv6-7b (``ssm_rwkv``) and
zamba2-2.7b (``hybrid``: Mamba2 blocks and the shared attention block),
f32.

* ``Model.loss`` within 1e-6 and every gradient leaf within 1e-5 of its
  largest |g| of ``jax.grad``'s, at act_levels 0 and 32, every FFN site
  locked to the reference's (``train_rig.lock_ffn``).  The WKV scan keeps
  the reference's bf16 casts of r, k, v and of each step's output, and
  its gradients pass through them as the reference's do; rwkv6-7b's
  streams are held to the reference's straight through
  (``recurrent_rig.lock_streams(straight=True)``): unlocked, its
  gradients differ by up to 2.7e-3 of a leaf's largest |g| (the bonus
  ``u``, act_levels 0), the ties' own effect;
* one ``make_train_step`` update (``train_rig.check_step``);
* the twin of ``tests/test_models.py::test_quantized_mode_trains`` on
  rwkv6-7b (|A| 16, |W| 64, adamw at 5e-3, 4 × 32 tokens, the clustering
  event at step 4 of 8): the port alone, its loss falling and every
  weight on a center after the event; in lockstep with the reference's
  run, every loss within 1e-4 and the event's output the reference's;
* the decay's clip at an exact tie with a bound passes half the gradient,
  as ``jnp.clip``'s does (``torch.clamp`` would pass all of it);
* the chunked SSD scan's masked exponent (``exp(-inf)``, then a second
  ``where``) leaves every gradient finite where the upper triangle
  would overflow, equal to the reference's;
* ``cfg.remat`` (each block, or each hybrid group, checkpointed; the WKV
  scan checkpointed per chunk) changes no bit of the loss or gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from recurrent_rig import lock_streams  # noqa: E402
from train_rig import (batch,  # noqa: E402
                       check_loss_and_grads, check_step, jax_batch,
                       lock_ffn, models, tparams, torch_batch)
from repro.models import rwkv as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro.models.model_zoo import build as build_j  # noqa: E402
from recurrent_rig import np_tree  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["rwkv6-7b", "zamba2-2.7b"]


def _sites(cfg) -> int:
    """FFN sites a forward: rwkv's gate and channel-mix a layer; each
    Mamba2 block's conv and gate, and the shared block's SwiGLU a
    group."""
    if cfg.family == "ssm_rwkv":
        return 2 * cfg.n_layers
    return 2 * cfg.n_layers + cfg.n_layers // cfg.shared_attn_every


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(monkeypatch, arch, levels):
    ns = models(arch, levels)
    stats = lock_ffn(monkeypatch)
    ties = (lock_streams(JR, TR, monkeypatch, straight=True)
            if arch == "rwkv6-7b" else None)
    worst = check_loss_and_grads(ns, batch(ns.cfg, S=32))
    assert not stats["pending"] and stats["sites"] == _sites(ns.cfg)
    print(f"{arch} levels {levels}: worst gradient share {worst:.2e}, "
          f"{stats['flips']} flips at boundary ties in {stats['acts']} "
          f"activations, stream ties {ties}")


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(monkeypatch, arch, levels):
    ns = models(arch, levels)
    stats = lock_ffn(monkeypatch)
    if arch == "rwkv6-7b":
        lock_streams(JR, TR, monkeypatch, straight=True)
    r = check_step(ns, batch(ns.cfg, S=32, seed=1), monkeypatch)
    assert not stats["pending"] and stats["sites"] == _sites(ns.cfg)
    print(f"{arch} levels {levels}: {r}")


def test_quantized_mode_trains(monkeypatch):
    """The twin of ``test_models.py::test_quantized_mode_trains`` on
    rwkv6-7b: 8 steps of ``make_train_step`` (adamw at 5e-3) on one seeded
    4 × 32 batch at |A| 16, the |W| 64 event at step 4.

    The port alone, free running: every loss finite, the loss falling,
    every weight on one of the 64 centers right after the event.

    Then in lockstep with the reference's run of the same 8 steps: each
    port step (and the event) starts from the reference's params and
    optimizer state before it, with every FFN site and the streams locked:
    every loss of the history within 1e-4 of the reference's; the event's
    codebook, and every snapped weight, within 1e-6 of the largest
    |center| of the reference's (each weight on the same center).  Free running the two histories part by about 1e-2 from
    step 1 on: adam's first step turns noise-level gradient differences
    into ±lr moves (``train_rig.check_step``), the next forwards flip
    activation levels, and the event snaps the moved weights apart."""
    from repro.core.quantizer import cluster_params as jcluster
    from repro.core.quantizer import init_state as jinit
    from repro.launch.steps import make_train_step as jstep
    from repro.optim import OptConfig as JOpt, init_opt_state as jopt
    from repro_torch.core.quantizer import cluster_params as tcluster
    from repro_torch.core.quantizer import init_state as tinit
    from repro_torch.launch.steps import make_train_step as tstep
    from repro_torch.optim import OptConfig as TOpt, init_opt_state as topt

    ns = models("rwkv6-7b", 16)
    jcfg = ns.cfg.quantized(levels=16, n_weights=64)
    tcfg = ns.tcfg.quantized(levels=16, n_weights=64)
    ns.model, ns.tmodel = build_j(jcfg), build(tcfg)
    b = batch(jcfg, B=4, S=32, seed=2)
    tb = torch_batch(b)
    to = TOpt(lr=5e-3)
    tstep_fn = tstep(ns.tmodel, to)

    def port_event(tp, tq):
        tp, tq = tcluster(tp, tcfg.wq, tq, 4, torch.Generator().manual_seed(0))
        book = torch.unique(tq.codebooks[""])
        for leaf in jax.tree.leaves(tp):
            assert torch.isin(leaf.reshape(-1), book).all()
        return tp, tq

    tp = tparams(ns.params)
    topt_s, tq, alone = topt(tp, to), tinit(tcfg.wq), []
    for i in range(8):
        if i == 4:
            tp, tq = port_event(tp, tq)
        tp, topt_s, m = tstep_fn(tp, topt_s, tb)
        alone.append(float(m["loss"]))
    assert np.isfinite(alone).all() and alone[-1] < alone[0]
    assert tq.codebooks[""].shape == (64,)

    stats = lock_ffn(monkeypatch)
    ties = lock_streams(JR, TR, monkeypatch, straight=True)
    jo = JOpt(lr=5e-3)
    step = jax.jit(jstep(ns.model, jo, None))
    params, opt, qs, jl, states = ns.params, jopt(ns.params, jo), \
        jinit(jcfg.wq), [], []
    for i in range(8):
        if i == 4:
            before = params
            params, qs = jcluster(params, jcfg.wq, qs, 4,
                                  jax.random.PRNGKey(0))
            event = (before, params, qs)
        states.append((params, opt))
        params, opt, m = step(params, opt, jax_batch(b))
        jl.append(float(m["loss"]))
    jax.effects_barrier()
    assert qs.codebooks[""].shape == (64,)

    tl = []
    for i in range(8):
        if i == 4:
            got, gq = port_event(tparams(event[0]), tinit(tcfg.wq))
            want = np.asarray(event[2].codebooks[""])
            np.testing.assert_allclose(gq.codebooks[""].numpy(), want,
                                       rtol=0, atol=1e-6 * np.abs(want).max())
            for g, w in zip(jax.tree.leaves(got),
                            jax.tree.leaves(np_tree(event[1]))):
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-6 * np.abs(want).max())
        jp, jopt_s = states[i]
        _, _, m = tstep_fn(tparams(jp), tparams(jopt_s), tb)
        tl.append(float(m["loss"]))
    assert not stats["pending"]
    gap = float(np.abs(np.subtract(tl, jl)).max())
    print(f"alone {alone}; lockstep {tl}; reference {jl}; max gap {gap:.2e}"
          f"; {stats['flips']} flips at boundary ties in {stats['acts']} "
          f"activations; stream ties {ties}")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)


def _tm_params(cfg):
    """A reduced time-mix block's params whose LoRA up matrix is zero, so
    that the decay's pre-clip value is exactly ``w0``: channels 0–3 on
    the upper bound 4, 4–7 on the lower bound −8, the rest inside."""
    rng = np.random.default_rng(5)
    d, r = cfg.d_model, cfg.lora_rank
    p = {"mix": rng.uniform(0.25, 0.75, (5, d)).astype(np.float32),
         "w_lora_a": {"w": rng.standard_normal((d, r)).astype(np.float32)},
         "w_lora_b": {"w": np.zeros((r, d), np.float32)},
         "u": np.full((d,), 0.5, np.float32),
         "ln_out": {"scale": np.ones((d,), np.float32)}}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = {"w": (rng.standard_normal((d, d)) * d ** -0.5).astype(
            np.float32)}
    w0 = rng.uniform(-7.0, 3.0, (d,)).astype(np.float32)
    w0[:4], w0[4:8] = 4.0, -8.0
    p["w0"] = w0
    return p


def test_decay_clip_ties_pass_half():
    """d/dw0 of Σ c·logw, ``logw = -exp(clip(w0 + dd, -8, 4))``, at dd = 0:
    equal to ``jax.grad``'s, which is half the interior rule's at the
    channels on a bound."""
    jc = JR.RWKVConfig(d_model=128, head_dim=32)
    p = _tm_params(jc)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    prev = rng.standard_normal((2, 1, 128)).astype(np.float32)
    c = rng.standard_normal((2, 8, 128)).astype(np.float32)

    def jloss(w0):
        pp = jax.tree.map(jnp.asarray, {**p, "w0": w0})
        logw = JR._tm_projections(pp, jnp.asarray(x), jnp.asarray(prev))[4]
        return jnp.sum(logw * c)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(p["w0"])))

    tp = tparams(p)
    w0 = tp["w0"].clone().requires_grad_(True)
    logw = TR._tm_projections({**tp, "w0": w0}, torch.from_numpy(x),
                              torch.from_numpy(prev), None)[4]
    (logw * torch.from_numpy(c)).sum().backward()
    got = w0.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the interior rule: -exp(w0) Σ_{b,t} c
    full = -np.exp(p["w0"].astype(np.float64)) * c.sum(axis=(0, 1))
    np.testing.assert_allclose(got[:8], 0.5 * full[:8], rtol=1e-5)
    np.testing.assert_allclose(got[8:], full[8:], rtol=1e-5)


def test_ssd_gradients_finite():
    """The chunked SSD scan where the masked upper triangle's exponent
    would overflow exp (steps of log decay down to −32, so the exponents
    of the upper triangle reach +480 in a chunk of 16): every gradient
    finite, the output within 1e-5 of its largest |y| of the reference's,
    the gradients of x, dt, B and C within 1e-5 of each one's largest |g|
    of ``jax.grad``'s.  A's gradient sums every step's terms of every
    chunk, which enter with both signs (its decay's exponent is a
    difference of cumulative sums), so its rounding follows the order of
    the sums: it is held to 1e-4 here, and ``A_log``'s to 1e-5 through the
    model above."""
    kw = dict(d_model=64, d_state=8, head_dim=16, chunk=16)
    jc, tc = JS.SSMConfig(**kw), TS.SSMConfig(**kw)
    Bt, L, H, P, G, N = 2, 32, jc.n_heads, 16, 1, 8
    rng = np.random.default_rng(7)
    ins = [rng.standard_normal((Bt, L, H, P)).astype(np.float32),
           rng.uniform(0.1, 2.0, (Bt, L, H)).astype(np.float32),
           -np.linspace(1.0, 16.0, H).astype(np.float32),
           rng.standard_normal((Bt, L, G, N)).astype(np.float32),
           rng.standard_normal((Bt, L, G, N)).astype(np.float32)]
    cy = rng.standard_normal((Bt, L, H, P)).astype(np.float32)
    ch = rng.standard_normal((Bt, H, N, P)).astype(np.float32)

    def jloss(*a):
        y, h = JS._ssd_chunked(*a, jc)
        return jnp.sum(y * cy) + jnp.sum(h * ch), y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                     has_aux=True)(
        *(jnp.asarray(a) for a in ins))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    ty, th = TS._ssd_chunked(*tin, tc)
    ((ty * torch.from_numpy(cy)).sum()
     + (th * torch.from_numpy(ch)).sum()).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    for name, t, w in zip(("x", "dt", "A", "B", "C"), tin, jg):
        g, w = t.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        rel = 1e-4 if name == "A" else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_nothing(arch):
    """The port alone at act_levels 32: remat on and off give the same
    loss and gradients, bit for bit."""
    ns = models(arch, 32)
    b = torch_batch(batch(ns.cfg, S=32))
    out = []
    for remat in (False, True):
        m = build(ns.tcfg.replace(remat=remat))
        tp = tparams(ns.params, requires_grad=True)
        loss, _ = m.loss(tp, b)
        loss.backward()
        out.append((loss.detach(), [t.grad for t in jax.tree.leaves(tp)]))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)

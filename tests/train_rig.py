"""Shared rig of the family training tests (``test_torch_train_moe.py``,
``test_torch_train_recurrent.py``, ``test_torch_train_encdec_vlm.py``):
a reduced registry model in both packages from the reference's weights,
seeded batches, the port's FFN activation sites held to the reference's
in every module that calls ``ffn_act`` (layers, moe, rwkv, ssm), the MoE
routing decisions of both sides recorded, and the loss with its
gradients, and one ``make_train_step``, run on each side.

The reference runs jitted (``jax.jit(jax.value_and_grad(...))``, one
compile a case) with remat off on both sides, so that each FFN site runs
once a forward and the recorded sites line up with the port's calls.

Only the tests import this module; it imports JAX lazily.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from families_rig import mrope_positions
from recurrent_rig import np_tree
from repro_torch import configs as TCfg
from repro_torch.bridge import from_jax_params, to_numpy_tree
from repro_torch.core.activations import ActQuantConfig, act_input_boundaries
from repro_torch.models.model_zoo import build as tbuild

LOSS_TOL = 1e-6          # the loss, of max(1, |loss|)
GRAD_REL = 1e-5          # each gradient leaf, of its largest |g|
STEP_TOL = 1e-6          # params after one update


def models(name: str, levels: int = 0, **over):
    """The reduced ``name`` in both packages at ``act_levels`` ``levels``,
    remat off unless ``over`` says otherwise, with the reference's
    ``PRNGKey(0)`` params carried to the port."""
    import jax
    import repro.configs as C
    from repro.models.model_zoo import build

    over = {"remat": False, **over}
    cfg = C.get(name).reduced().replace(act_levels=levels, **over)
    m = build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    tcfg = TCfg.get(name).reduced().replace(act_levels=levels, **over)
    return SimpleNamespace(cfg=cfg, model=m, params=params, tcfg=tcfg,
                           tmodel=tbuild(tcfg))


def batch(cfg, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    """A seeded numpy training batch: tokens; the encoder's frames; the
    vlm's embeddings and (3, B, S) M-RoPE positions (2 text tokens, a 1 ×
    2 × 2 grid, the rest text), each row's streams offset by its row
    number, so that a split on the wrong axis feeds a row another's."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        b["positions"] = (mrope_positions(B, 2, (1, 2, 2), S - 6)
                          + np.arange(B, dtype=np.int32)[None, :, None])
    return b


def jax_batch(b: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


def tparams(params, requires_grad: bool = False):
    """The reference's params as the port's tree on the CPU."""
    tp = from_jax_params(np_tree(params), "cpu")
    if requires_grad:
        tp = _map(lambda t: t.requires_grad_(True), tp)
    return tp


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def ffn_modules():
    """The modules of each package that call ``ffn_act`` (each binds its
    own name): (reference's, port's)."""
    import repro.models.layers as JL
    import repro.models.moe as JM
    import repro.models.rwkv as JR
    import repro.models.ssm as JS
    import repro_torch.models.layers as TL
    import repro_torch.models.moe as TM
    import repro_torch.models.rwkv as TR
    import repro_torch.models.ssm as TS
    return (JL, JM, JR, JS), (TL, TM, TR, TS)


def lock_ffn(monkeypatch, rel: float = 1e-5) -> dict:
    """Hold every FFN activation site of the port to the reference's, in
    every module that calls ``ffn_act``: the reference records each site's
    input and output through an ordered ``jax.debug.callback``; the
    port's calls, in the same order, check their input within ``rel`` of
    the site's largest |x| and, at ``levels`` > 0, their levels equal but
    where one flipped at a boundary tie (one level apart, both inputs
    within that bound of the boundary), counted; then go on with the
    reference's output, straight through (the port's own gradient)."""
    import jax

    recorded, stats = [], {"sites": 0, "acts": 0, "flips": 0,
                           "max_input_gap": 0.0}
    jmods, tmods = ffn_modules()
    jact, tact = jmods[0].ffn_act, tmods[0].ffn_act

    def keep(a, b):
        recorded.append((np.array(a, np.float32), np.array(b, np.float32)))

    def reference(x, kind, levels):
        y = jact(x, kind, levels)
        jax.debug.callback(keep, x, y, ordered=True)
        return y

    def port(x, kind, levels, mul=None):
        y = tact(x, kind, levels)
        xw, yw = recorded.pop(0)
        xp = x.detach().to(torch.float32).numpy()
        yp = y.detach().to(torch.float32).numpy()
        tol = rel * max(1.0, float(np.abs(xw).max()))
        assert xp.shape == xw.shape, (xp.shape, xw.shape)
        gap = float(np.abs(xp - xw).max()) if xp.size else 0.0
        stats["max_input_gap"] = max(stats["max_input_gap"], gap)
        assert gap <= tol, (stats["sites"], gap, tol)
        if levels == 0:
            assert np.abs(yp - yw).max(initial=0.0) <= tol
        else:
            cfg = ActQuantConfig(tmods[0]._bounded(kind), levels)
            lo, _ = cfg.out_range
            lp = np.rint((yp - lo) / cfg.step).astype(int)
            lw = np.rint((yw - lo) / cfg.step).astype(int)
            flip = lp != lw
            if flip.any():
                assert (np.abs(lp - lw)[flip] == 1).all(), "not one level"
                edge = act_input_boundaries(cfg)[np.minimum(lp, lw)[flip]]
                assert (np.abs(xp[flip] - edge) <= tol).all() and \
                    (np.abs(xw[flip] - edge) <= tol).all(), "not a tie"
            stats["flips"] += int(flip.sum())
        stats["sites"] += 1
        stats["acts"] += yw.size
        y = y + (torch.from_numpy(yw).to(y.dtype) - y).detach()
        return y if mul is None else y * mul

    for jm in jmods:
        monkeypatch.setattr(jm, "ffn_act", reference)
    for tm in tmods:
        monkeypatch.setattr(tm, "ffn_act", port)
    stats["pending"] = recorded
    return stats


def record_routing(monkeypatch) -> dict:
    """Each MoE dispatch's decisions on both sides, in call order: the
    expert ids (T, k), each entry's buffer slot and whether it was kept
    (capacity drops), as numpy arrays."""
    import jax
    import repro.models.moe as JM
    import repro_torch.models.moe as TM

    out = {"jax": [], "torch": []}
    jd, td = JM._dispatch_local, TM._dispatch_local

    def keep(ids, slot, kept):
        out["jax"].append(tuple(np.array(a) for a in (ids, slot, kept)))

    def reference(x_flat, ids, gates, e0, n_local, capacity):
        buf, slot, kept = jd(x_flat, ids, gates, e0, n_local, capacity)
        jax.debug.callback(keep, ids, slot, kept, ordered=True)
        return buf, slot, kept

    def port(x_flat, ids, *args):
        buf, slot, kept = td(x_flat, ids, *args)
        out["torch"].append(tuple(a.detach().numpy() for a in
                                  (ids, slot, kept)))
        return buf, slot, kept

    monkeypatch.setattr(JM, "_dispatch_local", reference)
    monkeypatch.setattr(TM, "_dispatch_local", port)
    return out


def assert_routing_equal(rec: dict) -> int:
    """The port's dispatch decisions equal the reference's, call for
    call; returns the entries dropped at capacity."""
    assert len(rec["torch"]) == len(rec["jax"]) > 0
    dropped = 0
    for (ti, ts, tk), (ji, js, jk) in zip(rec["torch"], rec["jax"]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tk, jk)
        dropped += int((~jk).sum())
    return dropped


def loss_and_grads(ns, b: dict):
    """The reference's jitted ``value_and_grad`` of ``Model.loss``, then
    the port's loss and its backward from the same params: ((loss,
    metrics, grads) of each side).  Run under ``lock_ffn`` (and the
    stream lock) when the sites must line up."""
    import jax

    jb = jax_batch(b)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: ns.model.loss(p, jb), has_aux=True))(ns.params)
    jax.effects_barrier()
    tp = tparams(ns.params, requires_grad=True)
    tl, tmet = ns.tmodel.loss(tp, torch_batch(b))
    tl.backward()
    tg = _map(lambda t: t.grad if t.grad is not None
              else torch.zeros_like(t), tp)
    return (jl, jmet, jg), (tl.detach(), tmet, tg)


def leaf_close(got_tree, want_tree, rel: float, what: str = "") -> float:
    """Each leaf of the port's tree within ``rel`` of the reference leaf's
    largest |value|; returns the largest such share met."""
    import jax
    want = jax.tree_util.tree_flatten_with_path(np_tree(want_tree))[0]
    got = to_numpy_tree(got_tree)
    worst = 0.0
    for kp, w in want:
        g = got
        for k in kp:
            g = g[k.key]
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
        share = float(np.abs(g - w).max(initial=0.0)) / scale
        worst = max(worst, share)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * scale,
            err_msg=f"{what}{jax.tree_util.keystr(kp)}")
    return worst


def assert_loss_close(tl, jl) -> None:
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * max(1.0, abs(float(jl))), \
        (float(tl), float(jl))


def check_loss_and_grads(ns, b: dict) -> float:
    """The loss within ``LOSS_TOL``, the token count equal, every gradient
    leaf within ``GRAD_REL``; returns the worst leaf's share."""
    (jl, jmet, jg), (tl, tmet, tg) = loss_and_grads(ns, b)
    assert_loss_close(tl, jl)
    assert float(tmet["ntokens"]) == float(jmet["ntokens"])
    return leaf_close(tg, jg, GRAD_REL, "grad")


def one_step(ns, b: dict, monkeypatch, lr: float = 1e-3):
    """One ``make_train_step`` (adamw, the reference trainer's optimizer)
    on each side from the reference's params, the gradients each side
    hands ``apply_updates`` captured (the reference's through an ordered
    callback): {'jax', 'torch': (params, metrics, grads)}."""
    import jax
    import repro.launch.steps as JS
    import repro_torch.launch.steps as TS
    from repro.optim import OptConfig as JOpt, init_opt_state as jopt
    from repro_torch.optim import OptConfig as TOpt, init_opt_state as topt

    seen = {}

    def keep(g):
        seen["jax"] = np_tree(g)

    def jspy(p, g, st, cfg, _f=JS.apply_updates):
        jax.debug.callback(keep, g, ordered=True)
        return _f(p, g, st, cfg)

    def tspy(p, g, st, cfg, _f=TS.apply_updates):
        seen["torch"] = g
        return _f(p, g, st, cfg)

    monkeypatch.setattr(JS, "apply_updates", jspy)
    monkeypatch.setattr(TS, "apply_updates", tspy)
    jo, to = JOpt(lr=lr), TOpt(lr=lr)
    jp, _, jm = jax.jit(JS.make_train_step(ns.model, jo, None))(
        ns.params, jopt(ns.params, jo), jax_batch(b))
    jax.effects_barrier()
    tp0 = tparams(ns.params)
    tp, _, tm = TS.make_train_step(ns.tmodel, to)(tp0, topt(tp0, to),
                                                  torch_batch(b))
    return {"jax": (jp, jm, seen["jax"]), "torch": (tp, tm, seen["torch"]),
            "opt": jo}


def _scaled(grads: dict, clip: float) -> dict:
    """The gradient ``apply_updates`` steps with: scaled by min(1, clip /
    its global norm), f32."""
    flat = [np.asarray(g, np.float64) for _, g in _leaves(grads)]
    norm = np.sqrt(sum(float(np.sum(g * g)) for g in flat))
    s = min(1.0, clip / max(norm, 1e-9))
    return {k: np.asarray(g, np.float64) * s for k, g in _leaves(grads)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def check_step(ns, b: dict, monkeypatch, lr: float = 1e-3) -> dict:
    """One update on each side (``one_step``):

    - the loss within ``LOSS_TOL``;
    - the gradients handed to the optimizer within ``GRAD_REL`` of each
      leaf's largest |g|;
    - the port's params within ``STEP_TOL`` of the reference's
      ``apply_updates`` applied to the port's gradients (the update
      itself);
    - the port's params within ``STEP_TOL`` of the reference's step,
      but where adam's first step conditions the gradients' own
      difference beyond it: that step moves a param by lr·ĝ/(|ĝ|+ε) (ĝ
      the clipped gradient), whose slope in ĝ is lr·ε/(|ĝ|+ε)², so an
      element whose |ĝ| is near ε turns a gradient difference far
      inside ``GRAD_REL`` into more than ``STEP_TOL``; each such element
      is held to STEP_TOL + lr·ε·|Δĝ|/(min |ĝ| + ε)² (lr·|Δĝ|/ε where the
      signs differ), and counted.

    Returns {'max_dparam', 'conditioned'}."""
    import jax
    import jax.numpy as jnp
    from repro.optim import apply_updates as japply, init_opt_state as jopt

    r = one_step(ns, b, monkeypatch, lr)
    (jp, jm, jg), (tp, tm, tg), jo = r["jax"], r["torch"], r["opt"]
    assert_loss_close(tm["loss"], jm["loss"])
    leaf_close(tg, jg, GRAD_REL, "step grad")
    tgn = to_numpy_tree(tg)
    mine, _, _ = japply(ns.params, jax.tree.map(jnp.asarray, tgn),
                        jopt(ns.params, jo), jo)
    got = dict(_leaves(to_numpy_tree(tp)))
    for path, w in _leaves(np_tree(mine)):
        np.testing.assert_allclose(got[path], w, rtol=0, atol=STEP_TOL,
                                   err_msg=f"update {path}")
    gj, gt = _scaled(jg, jo.grad_clip), _scaled(tgn, jo.grad_clip)
    eps, worst, conditioned = jo.eps, 0.0, 0
    for path, w in _leaves(np_tree(jp)):
        d = np.abs(got[path].astype(np.float64) - w)
        worst = max(worst, float(d.max(initial=0.0)))
        far = d > STEP_TOL
        if far.any():
            a, c = gj[path][far], gt[path][far]
            dg = np.abs(a - c)
            slope = np.where(np.sign(a) == np.sign(c),
                             eps / (np.minimum(np.abs(a), np.abs(c))
                                    + eps) ** 2, 1.0 / eps)
            assert (d[far] <= STEP_TOL + lr * slope * dg).all(), path
            conditioned += int(far.sum())
    return {"max_dparam": worst, "conditioned": conditioned}


def first_ffn_input(model, params, batch: dict) -> torch.Tensor:
    """The input of the first FFN activation site (``ffn_act``, in any of
    the port's modules) of ``model.loss`` under autograd, with its graph:
    a tensor that requires grad."""
    _, tmods = ffn_modules()
    route, seen = tmods[0].ffn_act, []

    def spy(x, *a, **kw):
        seen.append(x)
        return route(x, *a, **kw)
    for m in tmods:
        m.ffn_act = spy
    try:
        model.loss(_map(lambda t: t.detach().requires_grad_(True), params),
                   batch)
    finally:
        for m in tmods:
            m.ffn_act = route
    assert seen[0].requires_grad
    return seen[0]


def refused_level_index(x: torch.Tensor) -> None:
    """The quantized activation's level index (``act_index``, what the §4
    engine feeds its next table) refuses an input that requires grad."""
    import pytest
    from repro_torch.core.activations import act_index
    with pytest.raises(RuntimeError, match="level index has no gradient"):
        act_index(ActQuantConfig("relu6", 32), x)


def refused_gated_ffn(x: torch.Tensor, n: int = 64) -> None:
    """The codebook backend's gated FFN launch (``ops.codebook_swiglu``)
    refuses an activation that requires grad: the reference defines no
    gradient for it."""
    import pytest
    from repro_torch.kernels import ops
    x2 = x.reshape(-1, x.shape[-1])
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 16, (x2.shape[-1], n), generator=gen).to(
        torch.int8)
    book = torch.linspace(-0.1, 0.1, 16)
    with pytest.raises(RuntimeError, match="codebook_swiglu has no gradient"):
        ops.codebook_swiglu(x2, ids, book, ids, book, "relu6", 32)


def index_form_with_grad(params, n_weights: int = 16):
    """The port's tree clustered to ``n_weights`` values (laplacian_l1,
    global) and put into index form, its float leaves (codebooks, norms,
    leaves under ``min_size``) requiring grad."""
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.serving import to_codebook_params

    wq = WeightQuantConfig(num_weights=n_weights)
    pq, state = cluster_params(params, wq, init_state(wq), 0)
    cp = to_codebook_params(pq, wq, state)
    return _map(lambda t: t.requires_grad_(True) if t.is_floating_point()
                else t, cp)

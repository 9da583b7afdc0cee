"""The port's training path against the JAX package's, computed live: the
reduced qwen3 (f32) ``loss_fn`` and its gradients at act_levels 0 and 32
from the reference's params carried across by ``bridge.from_jax_params``;
10 steps of ``launch.train.train`` at the paper's working point
(``--quant``: |A| 32, |W| 1000, laplacian_l1, global) with the clustering
event at step 5, from the reference's initial params, losses within 1e-4
of the reference's ``train`` history; one microbatched step; remat; k-means
on a subsample; the launcher's JSON line; and what still refuses a
gradient (the activation's level index, the gated codebook launch).

The reference runs jitted, as its trainer runs, with remat off on both
sides, so that each FFN site runs once a forward.  ``lock_ffn`` then holds
every FFN activation site of the port to the reference's, as
``tests/recurrent_rig.lock_streams`` and the papernets' ``lock_acts`` do:
inputs within 1e-5 of the site's largest |x|, and at act_levels 32 the
levels equal but where one flipped at a boundary tie (one level apart,
both inputs within that bound of the boundary; XLA's jitted snap rounds
apart from the op-by-op one the port mirrors exactly there, see
``tests/test_torch_quantized_serve.py``), counted; the port goes on with
the reference's values, its gradient still its own.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core import clustering as JCL  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.launch.steps import make_train_step as j_step  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model_zoo import build as jbuild  # noqa: E402
from repro.optim import OptConfig as JOpt, init_opt_state as j_opt  # noqa
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.core import clustering as TCL  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.core.activations import (ActQuantConfig,  # noqa: E402
                                          act_input_boundaries)
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.launch.steps import make_train_step as t_step  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.optim import (OptConfig as TOpt,  # noqa: E402
                               init_opt_state as t_opt)

torch.set_num_threads(2)

ARCH = "qwen3-1.7b"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(levels=0, **over):
    over = {"remat": False, **over}
    j = C.get(ARCH).reduced().replace(act_levels=levels, **over)
    t = TC.get(ARCH).reduced().replace(act_levels=levels, **over)
    return j, t


def _pipe(cfg, batch=2, seq=16):
    from repro.data.synthetic import TokenPipeline
    return TokenPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)


def lock_ffn(monkeypatch, rel: float = 1e-5) -> dict:
    """Hold every FFN activation site of the port to the reference's (see
    the module docstring).  The reference records each site's input and
    output through an ordered ``jax.debug.callback`` (its values are
    tracers under ``jax.jit`` and ``jax.grad``); the port's calls, in the
    same order, check theirs and go on with the reference's output,
    straight through."""
    recorded, stats = [], {"sites": 0, "acts": 0, "flips": 0}
    jact, tact = JL.ffn_act, TL.ffn_act

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
        assert xp.shape == xw.shape and np.abs(xp - xw).max() <= tol
        if levels == 0:
            assert np.abs(yp - yw).max() <= tol
        else:
            cfg = ActQuantConfig(TL._bounded(kind), levels)
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

    monkeypatch.setattr(JL, "ffn_act", reference)
    monkeypatch.setattr(TL, "ffn_act", port)
    stats["pending"] = recorded
    return stats


def _leaf_close(got_tree, want_tree, rel, what=""):
    """Each leaf within ``rel`` of its largest |value|."""
    want = jax.tree_util.tree_flatten_with_path(np_tree(want_tree))[0]
    got = to_numpy_tree(got_tree)
    for kp, w in want:
        g = got
        for k in kp:
            g = g[k.key]
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what}{jax.tree_util.keystr(kp)}")


@pytest.mark.parametrize("levels", [0, 32])
def test_loss_and_gradients_match(monkeypatch, levels):
    """loss_fn and every parameter's gradient within 1e-5 of the leaf's
    largest |g| (the loss within 1e-6)."""
    jcfg, tcfg = _configs(levels)
    jm, tm = jbuild(jcfg), TZ.build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = _pipe(jcfg).batch_at(3)
    stats = lock_ffn(monkeypatch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True))(params)
    jax.effects_barrier()
    tp = jax.tree.map(lambda t: t.requires_grad_(True),
                      from_jax_params(np_tree(params), "cpu"))
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(
        np.array(batch["tokens"]))})
    tl.backward()
    assert not stats["pending"] and stats["sites"] == jcfg.n_layers
    print(f"levels {levels}: {stats['flips']} flips at boundary ties in "
          f"{stats['acts']} activations")
    assert abs(tl.item() - float(jl)) <= 1e-6 * max(1.0, abs(float(jl)))
    assert float(tmet["ntokens"]) == float(jmet["ntokens"])
    _leaf_close(jax.tree.map(lambda t: t.grad, tp), jg, 1e-5, "grad")


def test_remat_changes_nothing():
    """``cfg.remat`` checkpoints each block (recomputed in the backward):
    the loss and gradients are the same bits either way."""
    out = []
    for remat in (False, True):
        cfg = TC.get(ARCH).reduced().replace(act_levels=32, remat=remat)
        m = TZ.build(cfg)
        p = jax.tree.map(lambda t: t.requires_grad_(True),
                         m.init(torch.Generator().manual_seed(1), "cpu"))
        toks = torch.randint(0, cfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(2))
        loss, _ = m.loss(p, {"tokens": toks})
        loss.backward()
        out.append((loss.detach(), jax.tree.map(lambda t: t.grad, p)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        assert torch.equal(a, b)


def test_train_matches_reference_history(monkeypatch):
    """10 steps at ``--quant`` with the laplacian_l1 event at step 5, from
    the reference's initial params: every logged loss within 1e-4, the
    codebook the same size, level flips at ties counted."""
    jcfg, tcfg = (c.quantized() for c in _configs())
    jcfg, tcfg = (c.replace(wq=dataclasses.replace(c.wq, interval=5))
                  for c in (jcfg, tcfg))
    init = jbuild(jcfg).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(TZ.Model, "init", lambda self, gen, device=None:
                        from_jax_params(np_tree(init), "cpu"))
    stats = lock_ffn(monkeypatch)
    kw = dict(steps=10, batch=2, seq=16, log_every=1)
    _, jq, jhist = JT.train(jcfg, JT.TrainLoopConfig(**kw),
                            log=lambda *a: None)
    jax.effects_barrier()
    _, tq, thist = TT.train(tcfg, TT.TrainLoopConfig(**kw, device="cpu"),
                            log=lambda *a: None)
    assert not stats["pending"]
    print(f"train: {stats['flips']} flips at boundary ties in "
          f"{stats['acts']} activations over {stats['sites']} sites")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) < 1e-4, (t, j)
    assert tq.last_step == jq.last_step == 5
    assert {k: v.shape[0] for k, v in tq.codebooks.items()} == \
        {k: v.shape[0] for k, v in jq.codebooks.items()} == {"": 1000}
    np.testing.assert_allclose(tq.codebooks[""].numpy(),
                               np.asarray(jq.codebooks[""]), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(
                                   jq.codebooks[""])).max())


def test_microbatched_step_matches(monkeypatch):
    """cfg.microbatches 2: the two slices' gradients averaged in the
    moments dtype, as ``apply_updates`` receives them on each side, each
    leaf within 1e-5 of its largest |g|; the mean loss within 1e-6."""
    import repro.launch.steps as JS
    import repro_torch.launch.steps as TS
    jcfg, tcfg = _configs(microbatches=2)
    jm, tm = jbuild(jcfg), TZ.build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = _pipe(jcfg, batch=4).batch_at(1)
    seen = {}
    for mod, tag in ((JS, "jax"), (TS, "torch")):
        def spy(p, g, st, cfg, _f=mod.apply_updates, _tag=tag):
            seen[_tag] = g
            return _f(p, g, st, cfg)
        monkeypatch.setattr(mod, "apply_updates", spy)
    jo, to = JOpt(name="adamw"), TOpt(name="adamw")
    _, _, jmet = j_step(jm, jo, None)(params, j_opt(params, jo), batch)
    tp0 = from_jax_params(np_tree(params), "cpu")
    _, _, tmet = t_step(tm, to)(tp0, t_opt(tp0, to), {
        "tokens": torch.from_numpy(np.array(batch["tokens"]))})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) < 1e-6
    _leaf_close(seen["torch"], seen["jax"], 1e-5, "grad")


def test_kmeans_on_a_subsample():
    """The subsample: m = max(1, int(n·f)) draws with replacement of the
    given values, the same draws for the same generator; k-means on the
    same drawn values equals the reference's."""
    rng = np.random.default_rng(8)
    v = rng.laplace(size=50_000).astype(np.float32)
    gen = lambda: torch.Generator().manual_seed(5)          # noqa: E731
    s1 = TCL.subsample(torch.from_numpy(v), 0.02, gen())
    s2 = TCL.subsample(torch.from_numpy(v), 0.02, gen())
    assert s1.shape == (1000,) and torch.equal(s1, s2)
    assert np.isin(s1.numpy(), v).all()
    assert TCL.subsample(torch.from_numpy(v[:10]), 0.02, gen()).shape == (1,)
    want = JCL.kmeans1d(jnp.asarray(s1.numpy()), 64, iters=25)
    got = TCL.kmeans1d(s1, 64, iters=25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    f1 = TQ.fold_in(gen(), 3)
    assert torch.equal(torch.rand(4, generator=f1),
                       torch.rand(4, generator=TQ.fold_in(gen(), 3)))
    assert not torch.equal(torch.rand(4, generator=TQ.fold_in(gen(), 4)),
                           torch.rand(4, generator=TQ.fold_in(gen(), 3)))


def test_launcher_prints_the_reference_keys(capsys):
    TT.main(["--arch", ARCH, "--reduced", "--steps", "6", "--quant",
             "--cluster-every", "3", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step     0 loss ")
    line = json.loads(out[-1])
    assert sorted(line) == ["codebook_sizes", "history", "wall_seconds"]
    assert line["codebook_sizes"] == {"": 1000}
    assert [h["step"] for h in line["history"]] == [0, 5]
    assert all(sorted(h) == ["loss", "sec", "step"] for h in line["history"])
    args = TT.parser().parse_args(["--quant", "--cluster-every", "3"])
    assert args.device is None
    assert TT.config_of(args).wq.interval == 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            TT.main(["--reduced", "--steps", "1"])
        else:
            raise RuntimeError("no CUDA device (skipped: a card is here)")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_other_families_refuse_training(arch):
    """Every LM family trains; what still refuses a gradient, as the
    reference defines none: the quantized activation's level index (the
    §4 engine's) and the codebook backend's gated FFN launch, each on the
    family's first FFN input under its loss (zamba2's gated launch
    through its own forward at act_levels 32); and ``build`` refuses the
    paper's nets."""
    from repro_torch.kernels import dispatch as TD
    from train_rig import (first_ffn_input, index_form_with_grad,
                           refused_gated_ffn, refused_level_index)
    cfg = TC.get(arch).reduced()
    m = TZ.build(cfg)
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros(1, 16, dtype=torch.int64)
    x = first_ffn_input(m, p, {"tokens": toks})
    refused_level_index(x)
    if cfg.family == "hybrid":
        quantized = TZ.build(cfg.replace(act_levels=32))
        with pytest.raises(RuntimeError,
                           match="codebook_swiglu has no gradient"):
            quantized.forward(index_form_with_grad(p), {"tokens": toks},
                              TD.BackendSpec("codebook"))
    else:
        refused_gated_ffn(x)
    with pytest.raises(ValueError, match="papernets"):
        TZ.build(TC.get("paper-mnist"))

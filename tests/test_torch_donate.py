"""Buffer donation in the port's training step (the reference trainer's
``jax.jit(step, donate_argnums=(0, 1))``): ``apply_updates_`` and
``make_train_step(..., donate=True)`` write the new params, moments and
count into the tensors they were given.

* the reduced qwen3 at ``--quant`` (|A| 32), 1 and 2 microbatches, for
  each of the five optimizers: two donated steps bit-equal to two steps
  that build new trees from the same state, params, moments and count,
  every returned leaf at its input's address;
* ``launch.train.train`` (donated) against the same run with the old
  step patched in: losses, final params and the checkpoint written
  before the next in-place step, bit-equal;
* ``launch.train.train`` keeps no reference to the params a clustering
  event replaced;
* a tree whose leaves share memory, or a gradient or moment tree of
  another structure than the params', is refused before anything is
  written.
"""

import dataclasses
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.optim import (OptConfig, apply_updates,  # noqa: E402
                               apply_updates_, init_opt_state, warmup_cosine)
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

NAMES = ("sgd", "momentum", "rmsprop", "adam", "adamw")


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def reduced():
    cfg = TC.get("qwen3-1.7b").reduced().quantized()
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    return cfg, params


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_donated_step_is_bit_equal(reduced, name, microbatches):
    cfg, init = reduced
    model = build(cfg.replace(microbatches=microbatches))
    ocfg = OptConfig(name=name, lr=3e-3, weight_decay=0.05,
                     schedule=warmup_cosine(2, 10))
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=16, device="cpu")
    kept = ST.make_train_step(model, ocfg)
    donated = ST.make_train_step(model, ocfg, donate=True)
    p0 = _clone(init)
    o0 = init_opt_state(p0, ocfg)
    p1, o1 = _clone(p0), _clone(o0)
    ptrs = [t.data_ptr() for t in leaves({"p": p1, "o": o1})]
    for s in range(2):
        p0, o0, m0 = kept(p0, o0, pipe.batch_at(s))
        q, r, m1 = donated(p1, o1, pipe.batch_at(s))
        assert q is p1 and r is o1
        assert [t.data_ptr() for t in leaves({"p": q, "o": r})] == ptrs
        assert torch.equal(m0["loss"], m1["loss"])
        assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    _equal(p1, p0)
    _equal(o1, o0)
    assert int(o1["count"]) == 2 and sorted(o1) == sorted(o0)


def test_train_donates_as_the_old_step(reduced, monkeypatch, tmp_path):
    """6 steps of the trainer at ``--quant`` with the event at step 3
    and a checkpoint every 2 steps: the donated run and the run with the
    non-donated step give equal losses, final params and checkpoints."""
    cfg, _ = reduced
    cfg = cfg.replace(wq=dataclasses.replace(cfg.wq, interval=3))
    runs = []
    for donate in (True, False):
        if not donate:
            make = ST.make_train_step
            monkeypatch.setattr(ST, "make_train_step",
                                lambda m, o, donate=False: make(m, o))
        d = str(tmp_path / str(donate))
        loop = TT.TrainLoopConfig(steps=6, batch=2, seq=16, log_every=1,
                                  ckpt_dir=d, ckpt_every=2, device="cpu")
        params, qstate, hist = TT.train(cfg, loop, log=lambda *a: None)
        like = {"params": params, "opt": init_opt_state(params, OptConfig(
            name=loop.opt, moments_dtype=cfg.moments_dtype))}
        ckpts = [CKPT.restore(d, s, like)[0] for s in (4, 6)]
        runs.append((params, hist, qstate.last_step, ckpts))
    (pd, hd, ed, cd), (pk, hk, ek, ck) = runs
    assert [h["loss"] for h in hd] == [h["loss"] for h in hk]
    assert ed == ek == 3
    _equal(pd, pk)
    for a, b in zip(cd, ck):
        _equal(a, b)
    _equal(cd[1]["params"], pd)


def test_aliased_tree_is_refused():
    base = torch.arange(8, dtype=torch.float32)
    ocfg = OptConfig(name="adam")
    params = {"a": base[:5], "b": base[4:]}
    grads = {"a": torch.ones(5), "b": torch.ones(4)}
    state = init_opt_state({"a": torch.zeros(5), "b": torch.zeros(4)}, ocfg)
    with pytest.raises(ValueError, match="share memory"):
        apply_updates_(params, dict(grads), state, ocfg)
    assert torch.equal(base, torch.arange(8, dtype=torch.float32))
    assert int(state["count"]) == 0
    ok = {"a": base[:4], "b": base[4:]}        # one storage, no overlap
    apply_updates_(ok, dict(grads, a=torch.ones(4)), init_opt_state(
        ok, ocfg), ocfg)
    moments = init_opt_state(ok, ocfg)
    moments["v"]["b"] = moments["m"]["b"]
    with pytest.raises(ValueError, match="share memory"):
        apply_updates_(ok, {"a": torch.ones(4), "b": torch.ones(4)}, moments,
                       ocfg)


@pytest.mark.parametrize("update", [apply_updates, apply_updates_],
                         ids=["new_trees", "donated"])
@pytest.mark.parametrize("fault", ["grad_missing", "grad_extra",
                                   "moment_missing"])
def test_mismatched_tree_is_refused(update, fault):
    """A gradient or moment tree with a leaf fewer or more than the
    params' raises before any leaf, moment, count or gradient changes."""
    ocfg = OptConfig(name="adam")
    params = {"a": torch.ones(3), "n": {"b": torch.ones(2)}}
    state = init_opt_state(params, ocfg)
    grads = {"a": torch.ones(3), "n": {"b": torch.ones(2)}}
    if fault == "grad_missing":
        del grads["n"]["b"]
    elif fault == "grad_extra":
        grads["n"]["c"] = torch.ones(2)
    else:
        del state["v"]["a"]
    kept = _clone({"p": params, "s": state, "g": grads})
    with pytest.raises(ValueError, match="tree structure"):
        update(params, grads, state, ocfg)
    _equal({"p": params, "s": state, "g": grads}, kept)
    assert sorted(grads["n"]) == sorted(kept["g"]["n"])


def test_train_frees_the_replaced_params(reduced, monkeypatch):
    """After the clustering event at step 2, no frame holds the leaves the
    event replaced: by step 3 each is freed."""
    cfg, _ = reduced
    cfg = cfg.replace(wq=dataclasses.replace(cfg.wq, interval=2))
    replaced = []
    route = TT.cluster_params

    def event(params, *a):
        out = route(params, *a)
        replaced.extend(weakref.ref(x) for x, y in zip(
            leaves(params), leaves(out[0])) if x is not y)
        return out

    class Probe:
        def maybe_fail(self, step):
            if step == 3:
                gc.collect()
                assert replaced and not any(r() is not None
                                            for r in replaced)

    monkeypatch.setattr(TT, "cluster_params", event)
    loop = TT.TrainLoopConfig(steps=4, batch=2, seq=16, device="cpu")
    TT.train(cfg, loop, injector=Probe(), log=lambda *a: None)

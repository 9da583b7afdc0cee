"""Training of the mixture-of-experts family in the port against the JAX
package's, computed live: the reduced qwen3-moe-30b-a3b and grok-1-314b
(f32) ``Model.loss`` and every gradient leaf against ``jax.grad`` at
act_levels 0 and 32, the routing decisions of every dispatch equal (with
the reduced config's own capacity, which drops entries; with
``moe_capacity`` 16, which drops none; with two token chunks, as the
full grok-1-314b dispatches in chunks), and one ``make_train_step``
update.

The gradient reaches the router through the softmax, the top-k's sorted
values and their renormalisation; a dropped entry's weight is 0 (``keep``)
and the dispatch buffer's dump row is cut off, so neither takes any.  At
act_levels 32 every FFN site (``ffn_act`` on the whole (E, C, f) buffer)
is locked to the reference's (``train_rig.lock_ffn``), flips at boundary
ties counted.
"""

import pytest

torch = pytest.importorskip("torch")

from train_rig import (assert_routing_equal, batch,  # noqa: E402
                       check_loss_and_grads, check_step, lock_ffn, models,
                       record_routing)

torch.set_num_threads(2)

# case: (arch, config overrides)
CASES = {
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "qwen3-moe-30b-a3b-capacity16": ("qwen3-moe-30b-a3b",
                                     {"moe_capacity": 16.0}),
    "grok-1-314b": ("grok-1-314b", {}),
    "grok-1-314b-chunks2": ("grok-1-314b", {"moe_token_chunks": 2}),
}


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_routing(monkeypatch, case, levels):
    """The loss within 1e-6, every gradient leaf within 1e-5 of its largest
    |g|, each dispatch's expert ids, slots and kept entries equal; the
    own capacity drops entries, capacity 16 none."""
    arch, over = CASES[case]
    ns = models(arch, levels, **over)
    stats = lock_ffn(monkeypatch)
    rec = record_routing(monkeypatch)
    worst = check_loss_and_grads(ns, batch(ns.cfg))
    chunks = ns.cfg.moe_token_chunks
    assert not stats["pending"]
    assert stats["sites"] == ns.cfg.n_layers * chunks
    dropped = assert_routing_equal(rec)
    assert len(rec["jax"]) == ns.cfg.n_layers * chunks
    if ns.cfg.moe_capacity >= 16.0:
        assert dropped == 0
    elif case == "qwen3-moe-30b-a3b":
        assert dropped > 0
    print(f"{case} levels {levels}: worst gradient share {worst:.2e}, "
          f"{dropped} entries dropped, {stats['flips']} flips at boundary "
          f"ties in {stats['acts']} activations")


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_one_train_step(monkeypatch, arch, levels):
    """One ``make_train_step`` (adamw) from the reference's params
    (``train_rig.check_step``): the loss within 1e-6, the update within
    1e-6, the params within 1e-6 of the reference's step but where adam's
    first step conditions the gradients' difference past it."""
    ns = models(arch, levels)
    stats = lock_ffn(monkeypatch)
    r = check_step(ns, batch(ns.cfg, seed=1), monkeypatch)
    assert not stats["pending"] and stats["sites"] == ns.cfg.n_layers
    print(f"{arch} levels {levels}: {r}")

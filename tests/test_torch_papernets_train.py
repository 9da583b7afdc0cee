"""The paper's nets trained in the port (the twin of
``tests/test_papernets_integration.py``, in the port alone): the MLP with
both quantizations against the continuous baseline (Fig. 6), trained
quantized into the §4 integer engine, and the Fig. 2 parabola; then the
first MLP steps from the reference's params (``bridge.from_jax_params``)
against the reference's own loop, losses within 1e-5.

The reference's contracts are kept as they are: continuous accuracy >
0.85, quantized within 0.05 of it; the integer engine agreeing with the
float quantized net on > 0.97 of answers with max |Δ| < 0.6; the parabola
at |A| 2, 8 and 256 with e256 < 5e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import clustering  # noqa: E402
from repro_torch.core import fixedpoint as fp  # noqa: E402
from repro_torch.core.activations import ActQuantConfig, act_apply  # noqa
from repro_torch.core.lut import LutConfig, build_tables  # noqa: E402
from repro_torch.core.quantizer import (WeightQuantConfig,  # noqa: E402
                                        cluster_params, init_state)
from repro_torch.data.synthetic import (parabola_batch,  # noqa: E402
                                        pseudo_mnist_batch)
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import papernets as PN  # noqa: E402
from repro_torch.optim import (OptConfig, apply_updates,  # noqa: E402
                               init_opt_state)

torch.set_num_threads(2)
CPU = "cpu"


def _ce(params, x, y, kind, levels):
    logits = PN.mlp_apply(params, x, kind, levels)
    lse = torch.logsumexp(logits, -1)
    true = torch.take_along_dim(logits, y[:, None].long(), -1)[:, 0]
    loss = torch.mean(lse - true)
    return loss, loss


def _mlp_step(ocfg, kind, levels):
    def step(params, opt, batch):
        (loss, _), g = value_and_grad(_ce, params, batch["x"], batch["y"],
                                      kind, levels)
        params, opt, _ = apply_updates(params, g, opt, ocfg)
        return params, opt, loss
    return step


def _train_mlp(act_levels, n_weights, steps=250, hidden=(32,), key=0,
               params=None, losses=None):
    kind = "tanh"
    if params is None:
        params = PN.mlp_init(torch.Generator().manual_seed(key), 784,
                             list(hidden), 10, device=CPU)
    ocfg = OptConfig(name="adam", lr=2e-3)
    opt = init_opt_state(params, ocfg)
    wq = WeightQuantConfig(num_weights=n_weights, method="laplacian_l1",
                           interval=50) if n_weights else \
        WeightQuantConfig()
    qstate = init_state(wq)
    step = _mlp_step(ocfg, kind, act_levels)
    for s in range(steps):
        if wq.due(s):
            params, qstate = cluster_params(params, wq, qstate, s)
        params, opt, loss = step(params, opt, pseudo_mnist_batch(s, 64,
                                                                 device=CPU))
        if losses is not None:
            losses.append(float(loss))
    if wq.enabled:   # final snap so the deployed net is exactly clustered
        params, qstate = cluster_params(params, wq, qstate, steps)
    return params, qstate, wq


def _accuracy(fn, n_batches=5):
    hits = tot = 0
    for s in range(1000, 1000 + n_batches):
        b = pseudo_mnist_batch(s, 128, device=CPU)
        with torch.no_grad():
            pred = np.argmax(np.asarray(fn(b["x"])), -1)
        hits += (pred == b["y"].numpy()).sum()
        tot += pred.size
    return hits / tot


def test_quantized_training_matches_continuous():
    """Fig. 6: |A|=32, |W|=256 quantization ≈ continuous baseline."""
    p_cont, _, _ = _train_mlp(0, 0)
    acc_cont = _accuracy(lambda x: PN.mlp_apply(p_cont, x, "tanh", 0))
    p_q, _, _ = _train_mlp(32, 256)
    acc_q = _accuracy(lambda x: PN.mlp_apply(p_q, x, "tanh", 32))
    print(f"accuracy: continuous {acc_cont:.4f}, quantized {acc_q:.4f}")
    assert acc_cont > 0.85
    assert acc_q > acc_cont - 0.05, (acc_cont, acc_q)


def test_integer_engine_end_to_end():
    """Train quantized -> export §4 tables -> integer-only inference must
    match the float quantized network's predictions."""
    act = ActQuantConfig("tanh", 16)
    params, qstate, wq = _train_mlp(16, 128, steps=200, hidden=(24,))
    book = qstate.codebooks[""]
    tabs = build_tables(book.numpy(), LutConfig(act=act,
                                                 table_entries=8192),
                        fan_in=785)
    layers = [(clustering.assign_to_centers(params[f"layer{i}"]["w"], book),
               clustering.assign_to_centers(params[f"layer{i}"]["b"], book))
              for i in range(len(params))]

    def float_net(x):
        xi = fp.input_to_indices(torch.tanh(x), act)   # bounded inputs
        lo, _ = act.out_range
        h = lo + xi.to(torch.float32) * act.step
        for i in range(len(params) - 1):
            h = act_apply(act, h @ params[f"layer{i}"]["w"]
                          + params[f"layer{i}"]["b"])
        last = params[f"layer{len(params) - 1}"]
        return h @ last["w"] + last["b"]

    def int_net(x):
        xi = fp.input_to_indices(torch.tanh(x), act)
        return tabs.decode(fp.int_mlp_forward(layers, xi, tabs))

    b = pseudo_mnist_batch(2000, 256, device=CPU)
    with torch.no_grad():
        yf = float_net(b["x"]).numpy()
    yi = int_net(b["x"])
    agree = np.mean(np.argmax(yf, -1) == np.argmax(yi, -1))
    print(f"engine: agreement {agree:.4f}, max |dy| "
          f"{np.max(np.abs(yf - yi)):.4f}")
    assert agree > 0.97, agree        # prediction-level agreement
    assert np.max(np.abs(yf - yi)) < 0.6   # value-level (boundary snapping)


def test_parabola_regression_fig2():
    """Fig. 2: tanhD(L) fits a parabola; error shrinks as L grows."""
    def run(levels):
        params = PN.mlp_init(torch.Generator().manual_seed(1), 1, [2], 1,
                             device=CPU)
        ocfg = OptConfig(name="adam", lr=2e-2)
        opt = init_opt_state(params, ocfg)

        def mse(p, b):
            pred = PN.mlp_apply(p, b["x"], "tanh", levels)
            loss = torch.mean((pred - b["y"]) ** 2)
            return loss, loss
        for s in range(600):
            (loss, _), g = value_and_grad(mse, params,
                                          parabola_batch(s, device=CPU))
            params, opt, _ = apply_updates(params, g, opt, ocfg)
        return float(loss)

    e2, e8, e256 = run(2), run(8), run(256)
    print(f"parabola: e2 {e2:.5f}, e8 {e8:.5f}, e256 {e256:.5f}")
    assert e8 < e2 and e256 < e2
    assert e256 < 5e-3


@pytest.mark.parametrize("levels", [0, 32])
def test_first_steps_match_the_reference(levels):
    """The reference's ``_train_mlp`` loop from its own params, 5 steps,
    against the port's from the same params carried across: losses within
    1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.data.synthetic import pseudo_mnist_batch as j_batch
    from repro.models import papernets as JPN
    from repro.optim import (OptConfig as JOpt, apply_updates as j_apply,
                             init_opt_state as j_init)
    from repro_torch.bridge import from_jax_params
    jp = JPN.mlp_init(jax.random.PRNGKey(0), 784, [32], 10)
    ocfg = JOpt(name="adam", lr=2e-3)
    opt = j_init(jp, ocfg)

    def loss_fn(p, b):
        logits = JPN.mlp_apply(p, b["x"], "tanh", levels)
        lse = jax.nn.logsumexp(logits, -1)
        true = jnp.take_along_axis(logits, b["y"][:, None], -1)[:, 0]
        return jnp.mean(lse - true)
    want = []
    params = jp
    step = jax.jit(jax.value_and_grad(loss_fn))
    for s in range(5):
        loss, g = step(params, j_batch(s, 64))
        params, opt, _ = j_apply(params, g, opt, ocfg)
        want.append(float(loss))
    got = []
    _train_mlp(levels, 0, steps=5, params=from_jax_params(
        jax.tree.map(np.asarray, jp), CPU), losses=got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

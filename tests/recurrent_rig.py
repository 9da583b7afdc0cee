"""Shared rig of ``test_torch_rwkv.py`` and ``test_torch_ssm.py``: the
reduced recurrent models in both packages, the WKV scan's bf16 streams of
the port held to the reference's, and a greedy loop through the model
handle on each side.

Only the tests import this module; it imports JAX lazily.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import configs as TCfg
from repro_torch.bridge import from_jax_params, to_numpy_tree
from repro_torch.models.model_zoo import build as tbuild

BACKENDS = ("dense", "codebook", "lut")
# every refusal of a recurrent family: the model handle's, then the engine's
REFUSALS = ["prefill_lengths", "decode_vector_pos", "init_paged_cache",
            "verify", "prefill_chunk", "engine"]


def np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_tree_close(got, want, atol: float, what: str = "") -> None:
    """Every leaf of the port's tree (tensors) within ``atol`` of the
    reference's (arrays), dtypes and shapes equal."""
    g, w = dict(leaves(got)), dict(leaves(np_tree(want)))
    assert set(g) == set(w), what
    for path, a in w.items():
        t = g[path]
        assert str(t.dtype).split(".")[-1] == str(a.dtype), (what, path)
        assert tuple(t.shape) == a.shape, (what, path)
        np.testing.assert_allclose(
            to_numpy_tree(t).astype(np.float64), a.astype(np.float64),
            rtol=0, atol=atol, err_msg=f"{what}{path}")


def reference_model(name: str, levels: int = 0, n_weights: int = 0, **over):
    """A reduced registry model in both packages with the reference's
    ``PRNGKey(0)`` weights, carried to the port by the bridge; with
    ``n_weights``, also compressed as the launcher's ``--compress`` does
    it (laplacian_l1, global, ``min_size`` 4096) on the reference's side
    and carried to the port in index form."""
    import jax
    import repro.configs as C
    from repro.models.model_zoo import build

    cfg = C.get(name).reduced().replace(act_levels=levels, **over)
    m = build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    ns = SimpleNamespace(
        cfg=cfg, model=m, params=params,
        tmodel=tbuild(TCfg.get(name).reduced().replace(act_levels=levels,
                                                       **over)),
        tparams=from_jax_params(np_tree(params), "cpu"))
    if n_weights:
        from repro.core.quantizer import cluster_params, init_state
        from repro.serving import to_codebook_params
        wq = cfg.quantized(levels=levels or 32, n_weights=n_weights).wq
        pq, state = cluster_params(params, wq, init_state(wq), wq.interval,
                                   jax.random.PRNGKey(1))
        cp = to_codebook_params(pq, wq, state)
        ns.wq, ns.state, ns.clustered, ns.index = wq, state, pq, cp
        ns.tindex = from_jax_params(np_tree(cp), "cpu")
    return ns


def bf16_ties(got: np.ndarray, want: np.ndarray, atol: float = 0.0) -> int:
    """The elements of two arrays of bf16 values (as f32) that differ by
    more than ``atol``; each must be one bf16 step from the other (a
    rounding tie: an f32 difference in the last bit moved a value lying on
    a rounding boundary).  Returns their count."""
    a = np.ascontiguousarray(got, np.float32)
    b = np.ascontiguousarray(want, np.float32)
    far = np.abs(a - b) > atol
    ua = a.view(np.uint32)[far].astype(np.int64) >> 16
    ub = b.view(np.uint32)[far].astype(np.int64) >> 16
    assert ((ua >> 15 == ub >> 15) & (np.abs(ua - ub) == 1)).all(), \
        ("not a rounding tie", a[far][:4], b[far][:4])
    return int(far.sum())


def lock_streams(JR, TR, monkeypatch, atol: float = 1e-5,
                 straight: bool = False) -> dict:
    """Hold the WKV scan's bf16 streams of the port to the reference's.

    The scan takes r, k and v as bf16 and rounds each step's output y to
    bf16.  Where the two packages' f32 values differ in the last bit (XLA
    fuses multiply-adds and has its own exp), a value on a rounding
    boundary lands one bf16 step apart, and the model's later layers see
    that step.  Each reference scan records its (r, k, v, y); each port
    scan, in the same order, is held to them (every element equal or one
    bf16 step apart beyond ``atol``: a tie, counted in the returned dict;
    near zero the f32 values' own difference may span several steps within
    ``atol``), then runs on the
    reference's r, k and v and returns the reference's y.  Everything else
    in the model is then compared on equal streams.

    With ``straight`` (for gradients) the reference's values enter
    straight through (the port's own r, k, v and y plus a detached
    difference), so the gradient flows through the port's scan, and the
    streams' cotangents, which are bf16 too and tie the same way, are
    held as well: each cotangent of the reference's r, k, v and y is
    recorded (an identity with a custom VJP around each), and the port's,
    stream by stream in the backward's order, is held to it (``atol``
    taken of the cotangent's largest |g|; ties counted as ``dr``, ``dk``,
    ``dv``, ``dy``) and replaced by it.  The reference
    must run before the port."""
    import jax
    import jax.numpy as jnp

    recorded, ties = [], {"r": 0, "k": 0, "v": 0, "y": 0, "scans": 0}
    cots = {name: [] for name in "rkvy"}
    if straight:
        ties.update({"dr": 0, "dk": 0, "dv": 0, "dy": 0})
    jscan, tscan = JR._wkv_scan, TR._wkv_scan

    def record(*streams):
        recorded.append([np.array(a, np.float32) for a in streams])

    def tap(name):
        @jax.custom_vjp
        def ident(x):
            return x

        def keep(g):
            cots[name].append(np.array(g, np.float32))

        def bwd(_, g):
            jax.debug.callback(keep, g.astype(jnp.float32), ordered=True)
            return (g,)
        ident.defvjp(lambda x: (x, None), bwd)
        return ident

    taps = {name: tap(name) for name in "rkvy"} if straight else None

    def reference(r, k, v, u, logw, cfg, s0=None):
        if straight:
            r, k, v = (taps[n](a) for n, a in zip("rkv", (r, k, v)))
        y, s = jscan(r, k, v, u, logw, cfg, s0)
        jax.debug.callback(record, *(a.astype(jnp.float32)
                                     for a in (r, k, v, y)), ordered=True)
        return (taps["y"](y) if straight else y), s

    def held(a, want, name):
        w = torch.from_numpy(want)
        if not straight:
            return w.to(torch.bfloat16)
        af = a.to(torch.float32)          # exact: the sum gives w's bits
        out = (af + (w - af).detach()).to(torch.bfloat16)

        def hold(g):
            want_g = cots[name].pop(0)
            scale = float(np.abs(want_g).max(initial=0.0))
            ties["d" + name] += bf16_ties(g.float().numpy(), want_g,
                                          atol * scale)
            return torch.from_numpy(want_g).to(g.dtype)
        out.register_hook(hold)
        return out

    def port(r, k, v, u, logw, cfg, s0=None):
        want = recorded.pop(0)
        for name, a, b in zip("rkv", (r, k, v), want):
            ties[name] += bf16_ties(a.detach().float().numpy(), b, atol)
        r, k, v = (held(a, b, n) for a, b, n in zip((r, k, v), want, "rkv"))
        y, s = tscan(r, k, v, u, logw, cfg, s0)
        ties["y"] += bf16_ties(y.detach().float().numpy(), want[3], atol)
        ties["scans"] += 1
        return held(y, want[3], "y"), s

    monkeypatch.setattr(JR, "_wkv_scan", reference)
    monkeypatch.setattr(TR, "_wkv_scan", port)
    return ties


def lut_specs(ns):
    """The lut grid each side's engine would make from the index form
    (fan-in and codebooks from ``_index_form_stats``): (reference's,
    port's), equal."""
    from repro.kernels import dispatch as JD
    from repro.serving.engine import _index_form_stats as j_stats
    from repro_torch.kernels import dispatch as TD
    from repro_torch.serving.engine import _index_form_stats as t_stats

    _, jfan, jbook = j_stats(ns.index)
    _, tfan, tbook = t_stats(ns.tindex)
    assert tfan == jfan
    np.testing.assert_array_equal(tbook, jbook)
    return JD.make_lut_spec(jbook, jfan), TD.make_lut_spec(tbook, tfan)


def greedy_reference(ns, tokens: np.ndarray, n_new: int, backend: str,
                     spec=None, feed: bool = False):
    """The reference's greedy continuation through the model handle under
    ``use_backend``: the prompt by ``prefill`` (or, ``feed``, from
    ``init_cache`` token by token through ``decode``), then ``n_new``
    greedy decodes.  Eager (``jax.disable_jit``) at ``act_levels > 0``,
    whose jitted act_apply rounds otherwise.  Returns (B, n_new) ids."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import dispatch as JD

    params = ns.index
    if backend == "lut":
        params = JD.attach_lut_tables(params, spec)
    toks = jnp.asarray(tokens)
    B, S = tokens.shape
    out = []
    with JD.use_backend(backend, spec if backend == "lut" else None), \
            jax.disable_jit(ns.cfg.act_levels > 0):
        if feed:
            cache = ns.model.init_cache(B, S + n_new, dtype=jnp.float32)
            for t in range(S):
                logits, cache = ns.model.decode(params, toks[:, t:t + 1],
                                                cache)
        else:
            logits, cache = ns.model.prefill(params, {"tokens": toks})
        for _ in range(n_new):
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out.append(np.asarray(nxt))
            logits, cache = ns.model.decode(params, nxt[:, None], cache)
    return np.stack(out, axis=1)


def greedy_port(ns, tokens: np.ndarray, n_new: int, backend: str,
                spec=None, feed: bool = False):
    """``greedy_reference`` on the port's model handle (the backend passed
    to every call)."""
    from repro_torch.kernels import dispatch as TD

    params = ns.tindex
    if backend == "lut":
        params = TD.attach_lut_tables(params, spec)
    bk = TD.BackendSpec(backend, spec if backend == "lut" else None)
    toks = torch.from_numpy(tokens).long()
    B, S = tokens.shape
    out = []
    if feed:
        cache = ns.tmodel.init_cache(B, S + n_new, dtype=torch.float32,
                                     device="cpu")
        for t in range(S):
            logits, cache = ns.tmodel.decode(params, toks[:, t:t + 1], cache,
                                             bk)
    else:
        logits, cache = ns.tmodel.prefill(params, {"tokens": toks}, bk)
    for _ in range(n_new):
        nxt = torch.argmax(logits[:, -1], dim=-1)
        out.append(nxt.numpy())
        logits, cache = ns.tmodel.decode(params, nxt[:, None], cache, bk)
    return np.stack(out, axis=1)


def refusal_calls(model, params, lib: str) -> dict:
    """Each refusal of a recurrent family (``REFUSALS`` but the engine's)
    as a call on one side's model handle, ``lib`` 'jax' or 'torch'."""
    if lib == "jax":
        import jax.numpy as jnp
        arr, i32 = jnp.asarray, jnp.int32
        toks = jnp.ones((2, 4), jnp.int32)
        kw, dt = {}, {}
    else:
        arr, i32 = torch.tensor, torch.int32
        toks = torch.ones((2, 4), dtype=torch.long)
        kw = {"device": "cpu"}
        dt = {"dtype": torch.float32, "device": "cpu"}

    def vector_pos():
        cache = model.init_cache(2, 8, **dt)
        cache["pos"] = arr([0, 1], dtype=i32)
        model.decode(params, toks[:, :1], cache)

    def verify():
        model.verify(params, toks, model.init_cache(2, 8, **dt))

    return {
        "prefill_lengths": lambda: model.prefill(
            params, {"tokens": toks, "lengths": arr([4, 2], dtype=i32)}),
        "decode_vector_pos": vector_pos,
        "init_paged_cache": lambda: model.init_paged_cache(4, 8, **kw),
        "verify": verify,
        "prefill_chunk": lambda: model.prefill_chunk(params, {}, {}),
    }


def refusal(call) -> tuple:
    """(exception type name, text) of a call that must raise."""
    try:
        call()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")

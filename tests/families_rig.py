"""Shared rig of ``test_torch_audio.py`` and ``test_torch_vlm.py``: the
reduced whisper-small (``audio``) and qwen2-vl-7b (``vlm``) in both
packages, their seeded inputs (the encoder's frames, the vlm's embeddings
with an M-RoPE layout), the port's FFN activation sites and lut snaps held
to the reference's with the ties counted, and prefill plus greedy decodes
through the model handle on each side.

Only the tests import this module; it imports JAX lazily.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from recurrent_rig import lut_specs, np_tree  # noqa: F401 - re-exported
from repro_torch import configs as TCfg
from repro_torch.bridge import from_jax_params
from repro_torch.core.activations import ActQuantConfig, act_input_boundaries
from repro_torch.models.model_zoo import build as tbuild

BACKENDS = ("dense", "codebook", "lut")
N_WEIGHTS = 256              # the reduced codebooks: int8 ids


def reference_model(name: str, levels: int = 0, n_weights: int = 0,
                    exclude: str = "", **over):
    """A reduced registry model in both packages with the reference's
    ``PRNGKey(0)`` weights, carried to the port by the bridge; with
    ``n_weights``, also compressed as the launcher's ``--compress`` does
    (laplacian_l1, global, ``min_size`` 4096), ``exclude`` kept out of the
    clustering, on the reference's side and carried across in index
    form."""
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
        wq = dataclasses.replace(
            cfg.quantized(levels=levels or 32, n_weights=n_weights).wq,
            exclude=exclude)
        pq, state = cluster_params(params, wq, init_state(wq), wq.interval,
                                   jax.random.PRNGKey(1))
        ns.wq, ns.state, ns.clustered = wq, state, pq
        ns.index = to_codebook_params(pq, wq, state)
        ns.tindex = from_jax_params(np_tree(ns.index), "cpu")
    return ns


def with_levels(ns, levels: int):
    """``ns`` at another ``act_levels``: the same weights and index form
    (the weights' clustering does not read it), new configs and handles."""
    from repro.models.model_zoo import build

    out = SimpleNamespace(**vars(ns))
    out.cfg = ns.cfg.replace(act_levels=levels)
    out.model = build(out.cfg)
    tcfg = ns.tmodel.cfg.replace(act_levels=levels)
    out.tmodel = tbuild(tcfg)
    return out


def mrope_positions(B: int, text: int, grid: tuple, tail: int) -> np.ndarray:
    """(3, B, L) int32 M-RoPE positions as Qwen2-VL lays them out: ``text``
    tokens at t = h = w = i, then a t × h × w patch grid starting at the
    next position, each stream stepping along its own axis, then ``tail``
    text tokens from one past the grid's largest position."""
    rows = [(i, i, i) for i in range(text)]
    for ti in range(grid[0]):
        for hi in range(grid[1]):
            for wi in range(grid[2]):
                rows.append((text + ti, text + hi, text + wi))
    nxt = text + max(grid)
    rows += [(nxt + j,) * 3 for j in range(tail)]
    pos = np.asarray(rows, np.int32).T                       # (3, L)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, B, pos.shape[1])))


def inputs(cfg, B: int, S: int, seed: int, lengths=None,
           positions: bool = True) -> dict:
    """A seeded numpy batch: tokens; the encoder's (B, enc_len, d) frames
    (the reference's stub of a conv front end); the vlm's (B, S, d)
    embeddings and, with ``positions``, the layout of ``mrope_positions``
    (2 text tokens, a 1 × 2 × 2 grid, the rest text)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.5
                       ).astype(np.float32)
        if positions:
            b["positions"] = mrope_positions(B, 2, (1, 2, 2), S - 6)
    if lengths is not None:
        b["lengths"] = np.asarray(lengths, np.int32)
    return b


def grow(cache: dict, n: int, pad) -> dict:
    """The prefill's cache with ``n`` free rows after the prompt's on the
    sequence axis of its K/V planes, as a server's cache of ``max_len``
    holds them (a prefill's planes end at the prompt, and a decode into a
    full cache overwrites its last row); ``pad(a, n)`` pads one plane."""
    return {**cache, "kv": {k: pad(v, n) for k, v in cache["kv"].items()}}


def run_reference(ns, batch: dict, n_new: int, backend: str, spec=None,
                  params=None, forward: bool = True) -> dict:
    """The reference through its model handle under ``use_backend``:
    ``forward``, ``prefill`` and ``n_new`` greedy decodes on the prefill's
    cache with room for them (``grow``), eager (``jax.disable_jit``: the
    jitted act_apply rounds otherwise at ``act_levels > 0``, and a small
    model's ops compile faster one by one than its scans).  Returns numpy
    {'forward' (unless not ``forward``), 'prefill', 'cache' (the
    prefill's), 'steps' (each decode's logits), 'tokens'}."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import dispatch as JD

    params = ns.index if params is None else params
    if backend == "lut":
        params = JD.attach_lut_tables(params, spec)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = {k: v for k, v in jb.items() if k != "lengths"}
    out = {"steps": [], "tokens": []}
    with JD.use_backend(backend, spec if backend == "lut" else None), \
            jax.disable_jit():
        if forward:
            out["forward"] = np.asarray(ns.model.forward(params, fwd))
        logits, cache = ns.model.prefill(params, jb)
        out["prefill"], out["cache"] = np.asarray(logits), np_tree(cache)
        cache = grow(cache, n_new, lambda a, n: jnp.pad(
            a, [(0, 0), (0, 0), (0, n)] + [(0, 0)] * (a.ndim - 3)))
        for _ in range(n_new):
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out["tokens"].append(np.asarray(nxt))
            logits, cache = ns.model.decode(params, nxt[:, None], cache)
            out["steps"].append(np.asarray(logits))
    return out


def run_port(ns, batch: dict, n_new: int, backend: str, spec=None,
             params=None, forward: bool = True) -> dict:
    """``run_reference`` on the port's model handle (the backend passed to
    every call): the same keys, the cache as tensors."""
    from repro_torch.kernels import dispatch as TD

    params = ns.tindex if params is None else params
    if backend == "lut":
        params = TD.attach_lut_tables(params, spec)
    bk = TD.BackendSpec(backend, spec if backend == "lut" else None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    fwd = {k: v for k, v in tb.items() if k != "lengths"}
    out = {"steps": [], "tokens": []}
    if forward:
        out["forward"] = ns.tmodel.forward(params, fwd, bk).numpy()
    logits, cache = ns.tmodel.prefill(params, tb, bk)
    out["prefill"], out["cache"] = logits.numpy(), cache
    cache = grow(cache, n_new, lambda a, n: torch.cat(
        [a, a.new_zeros(a.shape[:2] + (n,) + a.shape[3:])], dim=2))
    for _ in range(n_new):
        nxt = torch.argmax(logits[:, -1], dim=-1)
        out["tokens"].append(nxt.numpy())
        logits, cache = ns.tmodel.decode(params, nxt[:, None], cache, bk)
        out["steps"].append(logits.numpy())
    return out


def lock_acts(JL, TL, monkeypatch, rel: float = 1e-5) -> dict:
    """Hold every ``ffn_act`` site of the port to the reference's.

    The reference records each site's input and output through an
    ordered ``jax.debug.callback`` (its values are tracers inside
    ``lax.scan``); the port's calls, in the same order, check their input
    within ``rel`` of its largest |value|, count the quantized levels that
    differ (each must be one level apart, at a level boundary: a tie), and
    go on with the reference's output.  The reference must run first."""
    import jax

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
        xp, yp = x.to(torch.float32).numpy(), y.to(torch.float32).numpy()
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
        y = torch.from_numpy(yw).to(y.dtype)
        return y if mul is None else y * mul

    monkeypatch.setattr(JL, "ffn_act", reference)
    monkeypatch.setattr(TL, "ffn_act", port)
    stats["pending"] = recorded
    return stats


def lock_snaps(JD, TD, monkeypatch, atol: float = 1e-2) -> dict:
    """Hold every lut activation snap of the port to the reference's.

    The lut backend snaps each activation to a level, ``round((x −
    a_min) / Δa)``, half to even.  Where the two packages' f32 inputs
    differ in the last bit (sums in another order), a value on a half-way
    point lands one level apart, and the model's later layers see that
    level.  The reference records each snap's input in grid units through
    an ordered ``jax.debug.callback``; the port's snaps, in the same
    order, check theirs within ``atol`` grid units, count the levels that
    differ (each one level apart, both inputs within ``atol`` of the same
    half-way point: a tie), and accumulate on the reference's levels.
    The reference must run first.  Returns {'snaps', 'acts', 'ties',
    'pending'}."""
    import jax
    import jax.numpy as jnp
    from repro_torch.kernels import ops

    recorded, stats = [], {"snaps": 0, "acts": 0, "ties": 0}
    jacc = JD._lut_acc

    def keep(g):
        recorded.append(np.array(g, np.float32))

    def reference(x2, w_idx, codebook, spec, table=None):
        g = (x2.astype(jnp.float32) - spec.a_min) / spec.da
        jax.debug.callback(keep, g, ordered=True)
        return jacc(x2, w_idx, codebook, spec, table)

    def port(x2, w_idx, codebook, spec, table=None):
        gw = recorded.pop(0)
        g = ((x2.to(torch.float32) - spec.a_min)
             / TD._grid_step(spec, x2.device)).numpy()
        assert g.shape == gw.shape and np.abs(g - gw).max() <= atol
        lw = np.clip(np.round(gw), 0, spec.levels - 1)
        lp = np.clip(np.round(g), 0, spec.levels - 1)
        flip = lp != lw
        if flip.any():
            half = np.floor(gw[flip]) + 0.5
            assert (np.abs(lp - lw)[flip] == 1).all(), "not one level"
            assert (np.abs(gw[flip] - half) <= atol).all() and \
                (np.abs(g[flip] - half) <= atol).all(), "not a tie"
        stats["ties"] += int(flip.sum())
        stats["snaps"] += 1
        stats["acts"] += g.size
        if table is None:
            table = TD.build_lut_table(codebook, spec)
        a_idx = torch.from_numpy(lw.astype(np.int32))
        return ops.lut_matmul(a_idx, w_idx.contiguous(), table.contiguous())

    monkeypatch.setattr(JD, "_lut_acc", reference)
    monkeypatch.setattr(TD, "lut_acc", port)
    stats["pending"] = recorded
    return stats


def assert_runs_agree(got: dict, want: dict, atol: float = 1e-3,
                      what: str = "") -> None:
    """Forward (where run), prefill and every decode step's logits within
    ``atol``, greedy tokens equal."""
    for key in ("forward", "prefill"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=atol, err_msg=f"{what} {key}")
    np.testing.assert_array_equal(np.stack(got["tokens"]),
                                  np.stack(want["tokens"]), err_msg=what)
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what} decode {i}")


def assert_cache_like(got, want: dict, names=("memory",)) -> None:
    """The port's cache has the reference's K/V planes (and ``names``)
    with equal shapes and dtypes, the values within 1e-3."""
    pairs = [(got["kv"][k], want["kv"][k]) for k in want["kv"]]
    pairs += [(got[k], want[k]) for k in names if k in want]
    assert set(got["kv"]) == set(want["kv"])
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   w.astype(np.float32), rtol=0, atol=1e-3)


def refusal(call) -> tuple:
    """(exception type name, text) of a call that must raise."""
    try:
        call()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")

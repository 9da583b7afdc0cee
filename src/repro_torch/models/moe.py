"""Mixture-of-Experts FFN (the port's copy of ``repro/models/moe.py``).

Token→slot dispatch is sort-based: a stable sort by expert id, the rank
within each expert's run as the capacity slot, a scatter into an (E, C, d)
buffer, three grouped products, a gather back and a weighted combine.
Entries over an expert's capacity are dropped (GShard semantics): they go
to the buffer's extra dump row and contribute zero.  The capacity is
static for a shape, ``max(1, int(T·top_k·capacity_factor / E))``, so every
row of a forward (padding and free decode slots included) competes for
it, as in the reference.

Everything on the path is a fixed-shape device op (no host read, no
data-dependent shape), so a decode step holding it can be captured in a
CUDA graph, and the combine is a fixed-order sum over each token's top_k
contributions, so a replay gives eager's bits.

Over a mesh (``moe_apply(..., mesh)``, a ``launch/mesh.Mesh``) the
reference's two regimes over the ``model`` axis, chosen by divisibility:

* **EP** (``n_experts % tp == 0``): rank m holds experts [m·E/tp,
  (m+1)·E/tp).  The activations are the same on every rank (they come
  whole from the attention), so each rank routes every token, keeps the
  entries of its own experts (the others go to the drop bucket) and the
  psum of y over ``model`` combines them: no all-to-all.
* **TP within expert** (otherwise): every expert's hidden dim f is cut
  over ``model`` (w1/w3 on their columns, w2 on its rows) and every rank
  runs every expert; the psum sums the row products.

The capacity keeps the global E in both.  The params are this rank's
slices already (``moe_param_specs``; the serving engine cuts them once).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import probes
from repro_torch.models.layers import ffn_act

__all__ = ["MoEConfig", "moe_init", "moe_apply", "moe_param_specs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act_kind: str = "silu"
    act_levels: int = 0
    token_chunks: int = 1     # dispatch in sequential token chunks (memory)
    fsdp: bool = True         # expert weights' specs name the 'data' axis

    def ep_size(self, model_size: int) -> int:
        return model_size if self.n_experts % model_size == 0 else 1


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype, device,
             layers: tuple = ()):
    """{'router': {'w': (d, E) f32}, 'w1', 'w3': (E, d, f), 'w2': (E, f,
    d)} with the reference's standard deviations: the router, w1 and w3
    N(0, 1/d), w2 N(0, 1/f); the router always f32.  ``layers`` prepends
    stacked dims."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return torch.randn(layers + shape, generator=gen, device=device) * std

    return {"router": {"w": normal((d, E), d ** -0.5)},
            "w1": normal((E, d, f), d ** -0.5).to(dtype),
            "w3": normal((E, d, f), d ** -0.5).to(dtype),
            "w2": normal((E, f, d), f ** -0.5).to(dtype)}


def _top_k(probs: torch.Tensor, k: int):
    """(values, ids) of the k largest entries of each row, ties in
    ``lax.top_k``'s order (the lower index first): a stable descending
    sort, sliced."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def moe_param_specs(cfg: MoEConfig, model_size: int,
                    fsdp_axis: str = "data") -> dict:
    """The expert weights' specs (without the layer dim), as tuples equal
    to ``tuple(PartitionSpec)`` of the reference's: EP cuts the experts
    over ``model``, TP within expert the hidden dim f; the router stays
    whole."""
    fa = fsdp_axis if cfg.fsdp else None
    if cfg.ep_size(model_size) > 1:
        return {"router": {"w": (None, None)}, "w1": ("model", fa, None),
                "w3": ("model", fa, None), "w2": ("model", None, fa)}
    return {"router": {"w": (None, None)}, "w1": (None, fa, "model"),
            "w3": (None, fa, "model"), "w2": (None, "model", fa)}


def _dispatch_local(x_flat, ids, e0: int, n_local: int, capacity: int):
    """Sort-based dispatch to the experts [e0, e0 + n_local) (the
    reference's ``_dispatch_local``; e0 = 0 and n_local = E without a
    mesh).  x_flat: (T, d); ids: (T, k) in [0, E).

    Returns (buffer (n_local, C, d), slot (T·k,), keep (T·k,)): entry i of
    the flattened ids sits at buffer row ``slot[i]`` when ``keep[i]``;
    entries of other experts (the drop bucket ``n_local``) and over
    capacity point at the dump row ``n_local·C``.
    """
    T, k = ids.shape
    d = x_flat.shape[-1]
    dev = x_flat.device
    flat_e = ids.reshape(-1)
    local = (flat_e >= e0) & (flat_e < e0 + n_local)
    le = torch.where(local, flat_e - e0, torch.full_like(flat_e, n_local))
    order = torch.sort(le, stable=True).indices
    le_s = le[order]
    # rank within each expert's run of the sorted array
    first = torch.searchsorted(le_s, le_s, side="left")
    rank = torch.arange(T * k, device=dev) - first
    keep_s = (rank < capacity) & (le_s < n_local)
    slot_s = torch.where(keep_s, le_s * capacity + rank,
                         torch.full_like(le_s, n_local * capacity))
    tok_s = order // k
    buf = torch.zeros((n_local * capacity + 1, d), dtype=x_flat.dtype,
                      device=dev)
    # kept slots are distinct; the dropped entries collide in the dump row
    buf.index_copy_(0, slot_s, x_flat[tok_s])
    # un-sort slot/keep back to (T·k,) order
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=dev))
    return (buf[:-1].reshape(n_local, capacity, d), slot_s[inv],
            keep_s[inv])


def _moe_chunk(x_flat, router_w, w1, w3, w2, cfg: MoEConfig, e0: int,
               n_local: int):
    """Route + compute one flat token chunk on the experts [e0, e0 +
    n_local): (Tc, d) -> (Tc, d)."""
    Tc, d = x_flat.shape
    logits = x_flat.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    capacity = max(1, int(Tc * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts))
    buf, slot, keep = _dispatch_local(x_flat, ids, e0, n_local, capacity)

    # ffn_act runs on the whole (n_local, C, f) buffer, empty slots included
    h = ffn_act(torch.bmm(buf, w1), cfg.act_kind, cfg.act_levels) \
        * torch.bmm(buf, w3)
    out = torch.bmm(h, w2)                                # (n_local, C, d)

    out_flat = torch.cat([out.reshape(n_local * capacity, d),
                          out.new_zeros((1, d))], dim=0)
    y = out_flat[slot]                                    # (Tc·k, d)
    w = (gates.reshape(-1) * keep).to(y.dtype)
    # each token's top_k contributions in a fixed-order sum (no atomics)
    return (y * w[:, None]).reshape(Tc, cfg.top_k, d).sum(dim=1)


def _moe_math(x, router_w, w1, w3, w2, cfg: MoEConfig, e0: int = 0,
              n_local: int | None = None):
    """The routed computation on x: (B, L, d), on the experts [e0, e0 +
    n_local) (all of them by default).  With ``token_chunks > 1`` (and T
    divisible by it) the dispatch, compute and combine run over
    sequential token chunks, each with its own capacity."""
    n_local = cfg.n_experts if n_local is None else n_local
    B, L, d = x.shape
    T = B * L
    x_flat = x.reshape(T, d)
    nc = cfg.token_chunks if cfg.token_chunks > 1 and T % cfg.token_chunks \
        == 0 else 1
    y = torch.cat([_moe_chunk(xc, router_w, w1, w3, w2, cfg, e0, n_local)
                   for xc in x_flat.reshape(nc, T // nc, d)], dim=0)
    return y.reshape(B, L, d)


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig, mesh=None) -> torch.Tensor:
    """Routed FFN.  x: (B, L, d) → (B, L, d).

    The router reads ``p['router']['w']``: a router put into index form
    (a compression that does not exclude it) raises ``KeyError`` here, as
    the reference's does.  The expert products run in x's dtype.  With a
    ``mesh`` the params are this rank's slices (``moe_param_specs``), the
    regime is EP or TP within expert as ``cfg.ep_size`` says, and one psum
    over ``model`` follows the token-chunk loop; the numerics probes
    record nothing inside it (``probes.fence``).  The reference's
    all-gather of FSDP-sharded experts over ``data`` is the identity on a
    (1, tp) mesh; a larger ``data`` axis is refused.
    """
    w1, w3, w2 = (p[k].to(x.dtype) for k in ("w1", "w3", "w2"))
    if mesh is None:
        return _moe_math(x, p["router"]["w"], w1, w3, w2, cfg)
    if mesh.shape.get("data", 1) > 1:
        raise NotImplementedError(
            f"moe_apply over a mesh with data axis {mesh.shape['data']}: "
            "FSDP-sharded experts are not ported (a (1, tp) mesh serves)")
    tp = mesh.tp
    if cfg.ep_size(tp) > 1:
        n_local = cfg.n_experts // tp
        e0 = mesh.coords["model"] * n_local
    else:
        n_local, e0 = cfg.n_experts, 0
    if w1.shape[0] != n_local:
        raise ValueError(f"moe_apply: this rank holds {w1.shape[0]} experts, "
                         f"the mesh gives it {n_local} (params not cut by "
                         "moe_param_specs?)")
    # the reference runs this body in a shard_map, whose taps it drops
    with probes.fence():
        y = _moe_math(x, p["router"]["w"], w1, w3, w2, cfg, e0, n_local)
    return collectives.psum(y, mesh)

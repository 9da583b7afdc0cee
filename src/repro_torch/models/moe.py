"""Mixture-of-Experts FFN (the port's copy of ``repro/models/moe.py``,
single-device: the reference's shard_map regimes over a mesh are not
ported).

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
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import ffn_act

__all__ = ["MoEConfig", "moe_init", "moe_apply"]


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


def _dispatch_local(x_flat, ids, n_experts: int, capacity: int):
    """Sort-based dispatch.  x_flat: (T, d); ids: (T, k) in [0, E).

    Returns (buffer (E, C, d), slot (T·k,), keep (T·k,)): entry i of the
    flattened ids sits at buffer row ``slot[i]`` when ``keep[i]``; dropped
    entries point at the dump row ``E·C``.  Every expert is local: the
    reference's shard offset is 0 here.
    """
    T, k = ids.shape
    d = x_flat.shape[-1]
    dev = x_flat.device
    flat_e = ids.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    e_s = flat_e[order]
    # rank within each expert's run of the sorted array
    first = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(T * k, device=dev) - first
    keep_s = rank < capacity
    slot_s = torch.where(keep_s, e_s * capacity + rank,
                         torch.full_like(e_s, n_experts * capacity))
    tok_s = order // k
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=x_flat.dtype,
                      device=dev)
    # kept slots are distinct; the dropped entries collide in the dump row
    buf.index_copy_(0, slot_s, x_flat[tok_s])
    # un-sort slot/keep back to (T·k,) order
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=dev))
    return (buf[:-1].reshape(n_experts, capacity, d), slot_s[inv],
            keep_s[inv])


def _moe_chunk(x_flat, router_w, w1, w3, w2, cfg: MoEConfig):
    """Route + compute one flat token chunk: (Tc, d) -> (Tc, d)."""
    Tc, d = x_flat.shape
    E = cfg.n_experts
    logits = x_flat.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    capacity = max(1, int(Tc * cfg.top_k * cfg.capacity_factor / E))
    buf, slot, keep = _dispatch_local(x_flat, ids, E, capacity)

    # ffn_act runs on the whole (E, C, f) buffer, empty slots included
    h = ffn_act(torch.bmm(buf, w1), cfg.act_kind, cfg.act_levels) \
        * torch.bmm(buf, w3)
    out = torch.bmm(h, w2)                                # (E, C, d)

    out_flat = torch.cat([out.reshape(E * capacity, d),
                          out.new_zeros((1, d))], dim=0)
    y = out_flat[slot]                                    # (Tc·k, d)
    w = (gates.reshape(-1) * keep).to(y.dtype)
    # each token's top_k contributions in a fixed-order sum (no atomics)
    return (y * w[:, None]).reshape(Tc, cfg.top_k, d).sum(dim=1)


def _moe_math(x, router_w, w1, w3, w2, cfg: MoEConfig):
    """The routed computation on x: (B, L, d).  With ``token_chunks > 1``
    (and T divisible by it) the dispatch, compute and combine run over
    sequential token chunks, each with its own capacity."""
    B, L, d = x.shape
    T = B * L
    x_flat = x.reshape(T, d)
    nc = cfg.token_chunks if cfg.token_chunks > 1 and T % cfg.token_chunks \
        == 0 else 1
    if nc == 1:
        y = _moe_chunk(x_flat, router_w, w1, w3, w2, cfg)
    else:
        y = torch.cat([_moe_chunk(xc, router_w, w1, w3, w2, cfg)
                       for xc in x_flat.reshape(nc, T // nc, d)], dim=0)
    return y.reshape(B, L, d)


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Routed FFN.  x: (B, L, d) → (B, L, d).

    The router reads ``p['router']['w']``: a router put into index form
    (a compression that does not exclude it) raises ``KeyError`` here, as
    the reference's does.  The expert products run in x's dtype.
    """
    return _moe_math(x, p["router"]["w"], p["w1"].to(x.dtype),
                     p["w3"].to(x.dtype), p["w2"].to(x.dtype), cfg)

"""Speculative decoding: drafts verified by the full model (the port's copy
of ``repro/serving/spec.py``).

A draft proposes ``k`` tokens a round — the parameter-free n-gram
self-draft, or a second model of the same architecture at a lower tier
(``draft_backend``, e.g. the index-form params through a coarse ``lut``
grid) — and the target scores all ``k + 1`` positions in one
``transformer.verify_step`` forward.

* **SpecConfig / SpecStats** — the knobs and the acceptance counters.
* **ngram_propose** — the self-draft in tensor ops only (compare, gather),
  so that it can live inside a captured round; ``ngram_propose_host`` is
  its plain-Python twin for a host-stepped round.
* **spec_accept** — the rejection rule.  Temperature 0: accept while the
  draft token equals the target argmax, which makes the output equal
  baseline greedy decode token for token.  Temperature > 0: accept ``x_i``
  with probability ``min(1, p(x_i)/q(x_i))`` and resample the first
  rejection from ``norm(max(0, p − q))`` (Leviathan et al. 2023), over the
  same top-k / top-p filtered distribution ``_sample`` draws from.

Random draws come from an explicit ``torch.Generator``: the port's tokens
at temperature > 0 follow the same rule as the reference's but cannot equal
them, which come from ``jax.random``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SpecConfig", "SpecStats", "filter_logits", "target_dist",
           "ngram_propose", "ngram_propose_host", "spec_accept", "NEG_INF"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for ServeEngine.

    draft:         'ngram' — parameter-free self-draft; 'model' — a second
                   model of the same architecture (``draft_params`` through
                   ``draft_backend``).
    k:             draft tokens proposed a round (verify scores k + 1).
    ngram:         suffix length the self-draft matches.
    draft_params:  params of the 'model' draft (index form for the
                   codebook and lut backends).
    draft_backend: the draft's matmul backend, which may differ from the
                   target's.
    lut_levels / lut_range: the draft's activation grid when
                   draft_backend='lut'.
    """

    draft: str = "ngram"
    k: int = 4
    ngram: int = 2
    draft_params: object = None
    draft_backend: str = "lut"
    lut_levels: int = 4096
    lut_range: tuple = (-16.0, 16.0)


@dataclasses.dataclass
class SpecStats:
    """Cumulative acceptance counters."""

    rounds: int = 0            # verify forwards run
    proposed: int = 0          # draft tokens offered to verification
    accepted: int = 0          # draft tokens that survived (and were emitted)
    emitted: int = 0           # total tokens emitted by spec rounds

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / self.rounds if self.rounds else 0.0

    def add(self, rounds, proposed, accepted, emitted):
        self.rounds += int(rounds)
        self.proposed += int(proposed)
        self.accepted += int(accepted)
        self.emitted += int(emitted)

    def reset(self):
        self.rounds = self.proposed = self.accepted = self.emitted = 0


# --- top-k / top-p filtering -------------------------------------------------

def filter_logits(lg: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Top-k / nucleus filtering on (..., V) f32 logits (already divided by
    temperature).  Filtered entries drop to −1e30; ``top_k=0`` and
    ``top_p>=1`` are no-ops.  Ties at the top-p threshold are kept; the
    argmax always survives.
    """
    V = lg.shape[-1]
    if top_k and top_k < V:
        kth = torch.sort(lg, dim=-1).values[..., V - top_k, None]
        lg = torch.where(lg < kth, NEG_INF, lg)
    if top_p < 1.0:
        srt = torch.flip(torch.sort(lg, dim=-1).values, dims=(-1,))
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p          # mass BEFORE the token < p
        thr = torch.amin(torch.where(keep, srt, torch.inf), dim=-1,
                         keepdim=True)
        lg = torch.where(lg < thr, NEG_INF, lg)
    return lg


def target_dist(logits: torch.Tensor, temperature: float, top_k: int = 0,
                top_p: float = 1.0) -> torch.Tensor:
    """The distribution both ``ServeEngine._sample`` and ``spec_accept``
    draw from: temperature first, then filtering."""
    return torch.softmax(filter_logits(logits / temperature, top_k, top_p),
                         dim=-1)


# --- drafts ------------------------------------------------------------------

def ngram_propose(ctx: torch.Tensor, ctx_len: torch.Tensor, *, k: int,
                  n: int) -> torch.Tensor:
    """Propose the k tokens that followed the most recent earlier
    occurrence of each slot's n-token context suffix.

    ctx: (B, C) token history (prompt + emitted so far); ctx_len: (B,)
    valid lengths.  Matches whose continuation lies wholly inside the known
    context are preferred; slots with no match repeat their last token, and
    positions past the known context propose the last token.  Tensor ops
    only (no host read).  Returns (B, k) in ctx's dtype.
    """
    B, C = ctx.shape
    dev = ctx.device
    cl = ctx_len.to(torch.int64)[:, None]                            # (B, 1)
    pos = torch.arange(C, device=dev)[None].expand(B, C)
    match = torch.ones((B, C), dtype=torch.bool, device=dev)
    for i in range(n):
        suff = torch.gather(ctx, 1, torch.clamp(cl - n + i, min=0))  # (B, 1)
        cand = torch.gather(ctx, 1, torch.clamp(pos - (n - 1) + i, 0, C - 1))
        match &= cand == suff
    # j = end position of a candidate match; the suffix itself ends at
    # ctx_len − 1 and is excluded
    valid = (pos >= n - 1) & (pos <= cl - 2)
    full = valid & (pos + k <= cl - 1)                 # continuation known
    neg = torch.full_like(pos, -1)
    j_full = torch.amax(torch.where(match & full, pos, neg), dim=1)
    j_any = torch.amax(torch.where(match & valid, pos, neg), dim=1)
    j = torch.where(j_full >= 0, j_full, j_any)[:, None]             # (B, 1)
    take = j + 1 + torch.arange(k, device=dev)[None]                 # (B, k)
    prop = torch.gather(ctx, 1, torch.clamp(take, 0, C - 1))
    last = torch.gather(ctx, 1, torch.clamp(cl - 1, min=0))
    prop = torch.where(take <= cl - 1, prop, last)
    return torch.where(j >= 0, prop, last)


def ngram_propose_host(tokens, *, k: int, n: int) -> list[int]:
    """Host twin of ``ngram_propose``: one slot's token history in, k
    proposals out."""
    t = np.asarray(tokens, np.int64)
    L = len(t)
    if L < n + 1:
        return [int(t[-1])] * k
    suff = t[L - n:]
    best = -1
    for j in range(L - 2, n - 2, -1):                 # most recent first
        if np.array_equal(t[j - n + 1:j + 1], suff):
            if best < 0:
                best = j
            if j + k <= L - 1:                        # full continuation
                best = j
                break
    if best < 0:
        return [int(t[-1])] * k
    out = [int(c) for c in t[best + 1:best + 1 + k]]
    return out + [int(t[-1])] * (k - len(out))


# --- rejection sampling ------------------------------------------------------

def spec_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                draft_dist: torch.Tensor | None, *, temperature: float,
                top_k: int = 0, top_p: float = 1.0,
                generator: torch.Generator | None = None,
                u: torch.Tensor | None = None):
    """Resolve one verify round: accept a prefix of the draft and emit one
    more token (the rejection's resample, or the bonus token when every
    proposal survived).

    logits: (B, K+1, V) target verify logits (vocab-sliced, f32).
    draft_tokens: (B, K) proposals.  draft_dist: (B, K, V) the draft's own
    (filtered, post-temperature) distribution at each position, or None
    for a point-mass draft (n-gram): then q = onehot(draft).

    Returns (n_acc (B,), toks (B, K+1)): ``toks[:, :n_acc]`` are the
    accepted proposals and ``toks[:, n_acc]`` the correction or bonus.
    Temperature 0: accept while draft == target argmax; the emission is the
    argmax row.  Temperature > 0: uniforms ``u`` (B, K) (drawn from
    ``generator`` when not given) accept proposal i when u_i < p_i / q_i,
    up to the first rejection; then the residual categorical draws from
    ``generator``.
    """
    B, K1, V = logits.shape
    K = K1 - 1
    if temperature <= 0:
        tgt = torch.argmax(logits, dim=-1)                         # (B, K1)
        acc = draft_tokens == tgt[:, :K]
        n_acc = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
        # accepted drafts equal the argmax, so tgt doubles as the emission
        return n_acc, tgt.to(draft_tokens.dtype)
    p = target_dist(logits, temperature, top_k, top_p)            # (B, K1, V)
    d_idx = draft_tokens.to(torch.int64)
    p_draft = torch.gather(p[:, :K], 2, d_idx[..., None])[..., 0]  # (B, K)
    if draft_dist is None:
        q_draft = torch.ones_like(p_draft)
        q_full = torch.nn.functional.one_hot(d_idx, V).to(p.dtype)
    else:
        q_full = draft_dist
        q_draft = torch.gather(q_full, 2, d_idx[..., None])[..., 0]
    if u is None:
        u = torch.rand((B, K), generator=generator, device=logits.device)
    acc = u * torch.clamp(q_draft, min=1e-30) < p_draft   # u < min(1, p/q)
    n_acc = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
    rows = torch.arange(B, device=logits.device)
    idx = torch.clamp(n_acc, max=K)
    p_sel = p[rows, idx]                                           # (B, V)
    q_pad = torch.cat([q_full, torch.zeros((B, 1, V), dtype=q_full.dtype,
                                           device=q_full.device)], dim=1)
    res = torch.clamp(p_sel - q_pad[rows, idx], min=0.0)
    # q ≥ p everywhere ⇒ an empty residual (only under filtering
    # mismatches or rounding): fall back to the target itself
    res = torch.where(res.sum(dim=-1, keepdim=True) > 1e-9, res, p_sel)
    corr = torch.multinomial(res, 1, generator=generator)[:, 0]
    toks = torch.cat([d_idx, torch.zeros((B, 1), dtype=torch.int64,
                                         device=logits.device)], dim=1)
    toks[rows, idx] = corr
    return n_acc, toks.to(draft_tokens.dtype)

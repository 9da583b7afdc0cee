"""Fleet routing policy: prefix- and load-aware replica choice, plus
admission backpressure (the port's copy of ``repro/serving/router.py``;
plain Python, no tensors).

``FleetRouter`` picks which of N replicas receives each request.  It sees
replicas only through small probe objects (load, free pages, prefix-match
length, pressure), so the policy is testable over fake probes and the
fleet (``serving/fleet.py``) wires real ``AsyncScheduler``/``PagePool``
probes in.

Policy, deterministic and independent of replica order:

* **prefix** (default): score every admitting replica by ``(prefix pages
  already cached, -unfinished load, free pages)`` and take the maximum;
  the prefix length uses the pool's own content-addressed hash chain
  (``kvcache.chain_keys``), so a predicted hit is exactly an admit-time
  hit.  Ties fall to the lexicographically smallest replica id.
* **round_robin**: cycle through admitting replicas in sorted-id order.

The round-robin cursor remembers the last replica id handed work and
advances to the next admitting id above it (wrapping), so a drain or
scale-up mid-rotation keeps the cycle fair; ``n_routed`` is a statistics
counter only.  Candidates are always enumerated in sorted-id order, so a
fleet built with its replicas permuted routes identically.

**Drain** removes a replica from the candidate set without touching its
queue; only new routes skip it.  **Scale-up** (``add``) makes a replica a
candidate at once.

**Backpressure** (``decide``): an arrival can be *deferred* (left at the
head of the fleet's pending heap and retried next round) or *shed*
(rejected) when every admitting replica is over the pressure threshold.
``shed_policy``: ``"none"`` (route regardless), ``"defer"`` (nobody
sheds), ``"slo"`` (requests carrying an SLO shed, best-effort work
waits), ``"all"`` (every arrival sheds under pressure).  An empty
admitting set always defers.  Nothing reads the wall clock, so decisions
replay exactly.
"""

from __future__ import annotations

__all__ = ["FleetRouter", "POLICIES", "SHED_POLICIES"]

POLICIES = ("prefix", "round_robin")
SHED_POLICIES = ("none", "defer", "slo", "all")


class FleetRouter:
    """Replica chooser over probe objects.

    A probe must expose ``load()`` (unfinished requests assigned),
    ``free_pages()`` (claimable capacity), ``prefix_match_pages(tokens)``
    (leading prompt pages the replica's pool already holds), and
    ``pressure()`` (0.0 idle → 1.0 admission blocked).
    ``serving/fleet.py``'s ``ReplicaProbe`` adapts the real engine stack;
    tests drive stubs."""

    def __init__(self, policy: str = "prefix", *,
                 shed_policy: str = "none", shed_threshold: float = 0.95):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {POLICIES}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {shed_policy!r}; "
                             f"choose from {SHED_POLICIES}")
        self.policy = policy
        self.shed_policy = shed_policy
        self.shed_threshold = float(shed_threshold)
        self.probes: dict[str, object] = {}
        self.draining: set[str] = set()
        self.n_routed = 0                    # statistics only, NOT a cursor
        self.n_shed = 0
        self._rr_last: str | None = None     # membership-aware RR cursor

    # --- membership ----------------------------------------------------------

    def add(self, rep: str, probe) -> None:
        if rep in self.probes:
            raise ValueError(f"replica {rep!r} already registered")
        self.probes[rep] = probe

    def drain(self, rep: str) -> None:
        """Stop routing to ``rep``.  Its queued/running requests are
        untouched — the replica drains itself (or the fleet migrates
        them; see ``Fleet.drain``)."""
        if rep not in self.probes:
            raise KeyError(f"unknown replica {rep!r}")
        self.draining.add(rep)

    @property
    def admitting(self) -> list[str]:
        """Routable replica ids, in the canonical (sorted) order every
        routing decision iterates."""
        return [r for r in sorted(self.probes) if r not in self.draining]

    # --- the decision --------------------------------------------------------

    def pressure(self) -> float:
        """The fleet-is-full signal the shed gate thresholds: the MINIMUM
        pressure over admitting replicas (the least-loaded candidate is
        where a route would land; shedding is justified only when even it
        is saturated).  1.0 when nothing admits."""
        reps = self.admitting
        if not reps:
            return 1.0
        return min(float(self.probes[r].pressure()) for r in reps)

    def decide(self, prompt, *, has_slo: bool = False):
        """Admission decision for one arrival: ``("route", rep)``,
        ``("defer", None)`` (leave it pending, retry next round) or
        ``("shed", None)`` (reject it outright).  See the module
        docstring for the shed-policy semantics."""
        if not self.admitting:
            return ("defer", None)
        if (self.shed_policy != "none"
                and self.pressure() >= self.shed_threshold):
            if self.shed_policy == "all" or (self.shed_policy == "slo"
                                             and has_slo):
                self.n_shed += 1
                return ("shed", None)
            return ("defer", None)
        return ("route", self.route(prompt))

    def route(self, prompt) -> str:
        """Choose the replica for one request's prompt.  Raises when
        nothing admits — callers that can wait use ``decide``, which
        defers instead."""
        reps = self.admitting
        if not reps:
            raise RuntimeError("no admitting replica (all drained?)")
        if self.policy == "round_robin":
            rep = reps[0]
            if self._rr_last is not None:
                for r in reps:
                    if r > self._rr_last:
                        rep = r
                        break
            self._rr_last = rep
        else:
            # max() keeps the FIRST maximum, and reps is sorted, so full
            # ties deterministically fall to the smallest replica id.
            rep = max(reps, key=lambda r: (
                self.probes[r].prefix_match_pages(prompt),
                -self.probes[r].load(),
                self.probes[r].free_pages()))
        self.n_routed += 1
        return rep

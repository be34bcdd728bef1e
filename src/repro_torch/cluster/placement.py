"""Topology-aware block placement for the distributed cluster volume.

HDFS-style: the cluster LBA space is carved into fixed *chunks* of
``chunk_blocks`` consecutive blocks, and every chunk maps to an ordered
**chain** of K nodes — the write pipeline (primary first, replicas
downstream).  The chain is the unit of replication, failover and
re-replication; blocks inside a chunk never split across chains, so a
``write_multi`` that stays inside one chunk keeps the per-node
chained-tx journal's whole-object atomicity end to end.

Three policies, all deterministic for a given assignment order:

  ``ring``      primary = ``chunk % n``, replicas on the next indices —
                the baseline with no topology awareness;
  ``spread``    rack-aware spread-K (the HDFS default): the primary
                rotates by chunk, each replica maximizes rack diversity
                against the chain so far, capacity-balanced (fewest
                placed blocks wins) within the eligible set;
  ``balanced``  capacity *and* load balanced everywhere: every member —
                primary included — is the candidate minimizing
                ``placed_blocks + load_weight * svc_ewma_us``, with rack
                diversity still preferred.  ``observe_load`` feeds the
                service-time EWMAs (the same fail-slow signal
                ``Metrics.per_node`` surfaces), so a limping node stops
                attracting new chains before it ever fails a heartbeat.

:meth:`PlacementPolicy.replacement` picks the re-replication target for
a chain that lost a member: an alive node outside the chain, rack
diversity against the survivors first, then least-placed.
"""
from __future__ import annotations

from repro_torch.core.metrics import EWMA_ALPHA

POLICIES = ("ring", "spread", "balanced")


class NodeInfo:
    """Static description of one cluster member (topology + capacity)."""

    __slots__ = ("name", "rack", "socket", "capacity_blocks")

    def __init__(self, name: str, *, rack: int = 0, socket: int = 0,
                 capacity_blocks: int | None = None) -> None:
        self.name = name
        self.rack = rack
        self.socket = socket
        self.capacity_blocks = capacity_blocks

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"NodeInfo({self.name!r}, rack={self.rack})"


class PlacementPolicy:
    """Maps chunk ids to node chains; tracks placed blocks and load."""

    def __init__(self, nodes: list[NodeInfo], *, k: int = 2,
                 policy: str = "spread",
                 load_weight: float = 1.0) -> None:
        assert policy in POLICIES, f"unknown placement policy {policy!r}"
        assert nodes, "placement needs at least one node"
        assert 1 <= k <= len(nodes), \
            f"replication factor k={k} needs k distinct nodes " \
            f"(have {len(nodes)})"
        self.nodes = list(nodes)
        self.k = min(k, len(self.nodes))
        self.policy = policy
        self.load_weight = load_weight
        self.placed = [0] * len(self.nodes)      # blocks placed per node
        self.load = [0.0] * len(self.nodes)      # svc-ewma us per node
        # fail-slow steering: node -> score multiplier (>= 1.0) pushed
        # from the cluster's ShardScorer — a limping node's candidacy
        # costs more under EVERY policy, not just 'balanced'
        self.penalty = [1.0] * len(self.nodes)
        self.steered_placements = 0

    # ------------------------------------------------------------- feedback
    def observe_load(self, node: int, svc_us: float) -> None:
        """Fold one service time into ``node``'s load EWMA (same alpha
        as ``Metrics.observe`` so the two views agree)."""
        self.load[node] += EWMA_ALPHA * (svc_us - self.load[node])

    def set_penalties(self, penalties: dict[int, float]) -> None:
        """Install the scorer's per-node multipliers (healthy 1x,
        limping/dead higher); missing nodes reset to 1.0."""
        changed = 0
        for i in range(len(self.nodes)):
            p = max(1.0, float(penalties.get(i, 1.0)))
            if p > 1.0 and self.penalty[i] <= 1.0:
                changed += 1
            self.penalty[i] = p
        self.steered_placements += changed

    def _score(self, i: int) -> float:
        """Lower is better: capacity first, load-shaded for 'balanced',
        limping-penalized always (a 25x-slow node should not win a chain
        just because it is empty — it is empty BECAUSE it is slow)."""
        s = float(self.placed[i])
        if self.policy == "balanced":
            s += self.load_weight * self.load[i]
        return (s + 1.0) * self.penalty[i] - 1.0

    # ------------------------------------------------------------ assignment
    def assign(self, chunk_id: int, n_blocks: int = 0,
               eligible: list[int] | None = None) -> list[int]:
        """The ordered chain for ``chunk_id`` (primary first), recording
        ``n_blocks`` of placed capacity on every member.  ``eligible``
        restricts candidates (re-assignment after node death)."""
        n = len(self.nodes)
        cand_all = list(range(n)) if eligible is None else list(eligible)
        assert cand_all, "no eligible nodes"
        k = min(self.k, len(cand_all))
        if self.policy == "ring":
            chain = [cand_all[(chunk_id + j) % len(cand_all)]
                     for j in range(k)]
        else:
            if self.policy == "balanced":
                primary = min(cand_all, key=lambda i: (self._score(i), i))
            else:                      # spread: rotate primaries by chunk
                primary = cand_all[chunk_id % len(cand_all)]
            chain = [primary]
            racks = {self.nodes[primary].rack}
            while len(chain) < k:
                rest = [i for i in cand_all if i not in chain]
                fresh = [i for i in rest if self.nodes[i].rack not in racks]
                pool = fresh or rest
                nxt = min(pool, key=lambda i: (self._score(i), i))
                chain.append(nxt)
                racks.add(self.nodes[nxt].rack)
        for i in chain:
            self.placed[i] += n_blocks
        return chain

    def replacement(self, chain: list[int], dead: int,
                    alive: list[int]) -> int | None:
        """The node to regenerate ``dead``'s copy of a chain onto: alive,
        outside the chain, rack-diverse against the survivors if
        possible, least placed otherwise.  None when every alive node
        already holds a copy (the chain stays under-replicated)."""
        survivors = [i for i in chain if i != dead and i in alive]
        cand = [i for i in alive if i not in chain]
        if not cand:
            return None
        racks = {self.nodes[i].rack for i in survivors}
        fresh = [i for i in cand if self.nodes[i].rack not in racks]
        pool = fresh or cand
        return min(pool, key=lambda i: (self._score(i), i))

    def transfer(self, src: int, dst: int, n_blocks: int) -> None:
        """Re-replication accounting: ``n_blocks`` moved off ``src``'s
        ledger onto ``dst``."""
        self.placed[src] = max(0, self.placed[src] - n_blocks)
        self.placed[dst] += n_blocks

    # ---------------------------------------------------------------- stats
    def rack_diversity(self, chain: list[int]) -> int:
        return len({self.nodes[i].rack for i in chain})

    def balance(self) -> float:
        """max/mean placed blocks — 1.0 is perfectly even."""
        total = sum(self.placed)
        if not total:
            return 1.0
        mean = total / len(self.placed)
        return max(self.placed) / mean

    def stats(self) -> dict:
        return {"policy": self.policy, "k": self.k,
                "placed": list(self.placed),
                "load_ewma_us": [round(x, 3) for x in self.load],
                "penalty": list(self.penalty),
                "steered_placements": self.steered_placements,
                "balance": self.balance()}

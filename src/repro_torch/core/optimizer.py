"""Join-order optimization (§7.3, Algorithm 4): System-R style dynamic
programming over the subqueries of a decomposition.

Plans are left-deep: (((q_i1 ⋈ q_i2) ⋈ q_i3) ⋈ ...).  Table T_i keeps,
per subset of subqueries, only the cheapest plan (Lines 9-11's duplicate
elimination).  Join cardinalities follow the paper's worst-case model
(cards multiply) refined with a shared-variable selectivity discount --
a join on k shared variables divides the cross product by deg^k.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .decomposition import Decomposition
from .dictionary import DataDictionary
from .query import QueryGraph


@dataclasses.dataclass
class JoinPlan:
    order: List[int]            # subquery indices, left-deep join order
    cost: float                 # accumulated intermediate-result cost
    card: float                 # estimated output cardinality


def shared_variables(a: QueryGraph, b: QueryGraph) -> Set[int]:
    return {v for v in a.vertices() if v < 0} & {v for v in b.vertices() if v < 0}


def optimize(decomp: Decomposition, dictionary: DataDictionary,
             bushy: bool = False) -> JoinPlan:
    """Algorithm 4.  Returns the minimum-cost left-deep plan."""
    subs = decomp.subqueries
    t = len(subs)
    cards = [dictionary.estimate_card(q) for q in subs]
    if t == 1:
        return JoinPlan([0], cards[0], cards[0])
    deg = max(dictionary.avg_out_degree, 2.0)

    def join_card(card_a: float, vars_a: Set[int], card_b: float,
                  vars_b: Set[int]) -> float:
        shared = vars_a & vars_b
        c = card_a * card_b
        for _ in shared:
            c /= deg * 4.0
        return max(c, 1.0)

    svars = [{v for v in q.vertices() if v < 0} for q in subs]

    # T_2 (Lines 1-3): all ordered pairs -- keep best per subset
    best: Dict[FrozenSet[int], JoinPlan] = {}
    plan_vars: Dict[FrozenSet[int], Set[int]] = {}
    for i, j in itertools.permutations(range(t), 2):
        key = frozenset((i, j))
        card = join_card(cards[i], svars[i], cards[j], svars[j])
        cost = cards[i] + cards[j] + card
        if key not in best or cost < best[key].cost:
            best[key] = JoinPlan([i, j], cost, card)
            plan_vars[key] = svars[i] | svars[j]

    # T_3..T_t (Lines 4-11)
    for size in range(3, t + 1):
        nxt: Dict[FrozenSet[int], JoinPlan] = {}
        nvars: Dict[FrozenSet[int], Set[int]] = {}
        for key, pl in best.items():
            if len(key) != size - 1:
                continue
            for k in range(t):
                if k in key:
                    continue
                nkey = key | {k}
                card = join_card(pl.card, plan_vars[key], cards[k], svars[k])
                cost = pl.cost + cards[k] + card
                if nkey not in nxt or cost < nxt[nkey].cost:
                    nxt[nkey] = JoinPlan(pl.order + [k], cost, card)
                    nvars[nkey] = plan_vars[key] | svars[k]
        best.update(nxt)
        plan_vars.update(nvars)

    full = frozenset(range(t))
    return best[full]

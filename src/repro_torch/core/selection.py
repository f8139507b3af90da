"""Frequent access pattern selection (§4.1, Algorithm 1).

Maximizing Benefit(P', Q) = Σ_Q max_{p∈P'} |E(p)|·use(Q,p) subject to
Σ_{p∈P'} |E([[p]]_G)| <= SC is NP-hard (Theorem 1: the benefit is
submodular; submodular maximization under a knapsack constraint).

Algorithm 1 (faithful):
  1. seed P' with every 1-edge pattern of a frequent property (data
     integrity: every hot edge is covered by at least one fragment);
  2. P1 = the single best multi-edge pattern by benefit density;
  3. P2 = greedy marginal-benefit-per-fragment-size selection;
  4. return the better of P' ∪ P1 and P' ∪ P2.
Approximation: min{1/max|E(p)|, ½(1-1/e)} (Theorem 2).

Note: the paper's Line 11 writes the marginal against the fixed seed set
P'; the standard knapsack-greedy it cites ([11]) uses the *current*
selection P' ∪ P2 -- we implement the latter (it dominates and is what
the proof of Theorem 2 requires).

Benefit evaluations are dense vector ops over the (deduped) usage
matrix (one weighted relu-matmul per greedy round), so million-query
workloads reduce to a handful of BLAS calls.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set

import numpy as np

from .mining import FrequentPattern


@dataclasses.dataclass
class SelectionResult:
    selected: List[int]            # indices into the candidate pattern list
    seed: List[int]                # the 1-edge integrity seed subset
    benefit: float
    total_size: int                # Σ |E([[p]]_G)| over selected
    storage_constraint: int


def benefit_vector(patterns: Sequence[FrequentPattern],
                   usage: np.ndarray) -> np.ndarray:
    """B[q, i] = |E(p_i)| * use(Q_q, p_i)  (Def. 8)."""
    sizes = np.array([fp.num_edges for fp in patterns], dtype=np.float64)
    return usage.astype(np.float64) * sizes[None, :]


def total_benefit(B: np.ndarray, weights: np.ndarray,
                  selected: Sequence[int]) -> float:
    """Benefit(P', Q) (Def. 9) over deduped queries with multiplicities."""
    if not selected:
        return 0.0
    per_q = B[:, list(selected)].max(axis=1)
    return float((per_q * weights).sum())


def select_patterns(patterns: Sequence[FrequentPattern],
                    usage: np.ndarray, weights: np.ndarray,
                    frag_sizes: np.ndarray, storage_constraint: int,
                    frequent_props: Optional[Sequence[int]] = None
                    ) -> SelectionResult:
    """Algorithm 1.

    patterns:   candidate FAPs (mined; includes all 1-edge patterns)
    usage:      U[q, i] usage matrix over deduped normalized queries
    weights:    multiplicity of each deduped query
    frag_sizes: |E([[p_i]]_G)| -- edge count of each pattern's fragment
    """
    x = len(patterns)
    B = benefit_vector(patterns, usage)            # (q, x)
    Bw = B * weights[:, None].astype(np.float64)   # weighted benefit
    frag_sizes = np.asarray(frag_sizes, dtype=np.int64)

    # --- Lines 3-6: integrity seed (all 1-edge patterns) ---
    seed = [i for i, fp in enumerate(patterns) if fp.num_edges == 1]
    selected: Set[int] = set(seed)
    total_size = int(frag_sizes[seed].sum()) if seed else 0
    if total_size > storage_constraint:
        raise ValueError(
            f"storage constraint {storage_constraint} below hot-graph size "
            f"{total_size}; Algorithm 1 requires SC >= |E(hot)| (§4.1.2)")

    multi = [i for i in range(x) if patterns[i].num_edges > 1]
    cur = B[:, seed].max(axis=1) if seed else np.zeros(B.shape[0])

    # --- Line 7: P1 = best single multi-edge pattern by density ---
    p1: List[int] = []
    best_density = -1.0
    for i in multi:
        if total_size + frag_sizes[i] > storage_constraint:
            continue
        b = total_benefit(B, weights, seed + [i])
        d = b / max(int(frag_sizes[i]), 1)
        if d > best_density:
            best_density = d
            p1 = [i]

    # --- Lines 8-14: greedy marginal-density selection (vectorized:
    # per-candidate marginal gains are one weighted relu-matmul) ---
    p2: List[int] = []
    cur2 = cur.copy()
    size2 = total_size
    remaining = np.array(sorted(multi), dtype=np.int64)
    wf = weights.astype(np.float64)
    while remaining.size:
        fits = size2 + frag_sizes[remaining] <= storage_constraint
        cand = remaining[fits]
        if cand.size == 0:
            break
        gains = np.maximum(B[:, cand] - cur2[:, None], 0.0).T @ wf
        dens = gains / np.maximum(frag_sizes[cand].astype(np.float64), 1.0)
        j = int(np.argmax(dens))
        if gains[j] <= 0.0:
            break
        best_i = int(cand[j])
        p2.append(best_i)
        cur2 = np.maximum(cur2, B[:, best_i])
        size2 += int(frag_sizes[best_i])
        remaining = remaining[remaining != best_i]

    # --- Lines 15-17: keep the better of P'∪P1 / P'∪P2 ---
    b1 = total_benefit(B, weights, seed + p1)
    b2 = total_benefit(B, weights, seed + p2)
    if b1 >= b2:
        chosen, bben = seed + p1, b1
    else:
        chosen, bben = seed + p2, b2
    tsize = int(frag_sizes[chosen].sum())
    return SelectionResult(chosen, seed, bben, tsize, storage_constraint)

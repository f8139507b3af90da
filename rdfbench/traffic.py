"""The one traffic generator: a mix file's parameters to a request
stream and, for an open loop, its arrival times.

A mix (``traffic/<name>.json``) says how clients load the front door
and what they ask:

* ``loop``: ``"closed"`` (``clients`` callers, each waiting for its
  answer before it sends the next) or ``"open"`` (arrivals at
  ``rate_qps``, sent whatever the door does);
* ``template_zipf`` (Zipf popularity over the 13 templates, in their
  order) or ``class_weights`` (``watdiv.class_template_probs``);
* ``templates_left_out`` (optional): template ids never sent, the
  others' popularity scaled up to fill their share;
* ``cold_fraction``: single-edge lookups of the cold properties;
* ``constant_fraction``: share of template requests bound to a data
  constant, drawn from the vertices that take the bound variable's place
  in some match (``watdiv.positions``);
* ``block``: requests per stratified block (``watdiv.stratified_queries``);
* ``check_share``: share of each category's requests whose outcomes the
  reference checks (at least one of each in every block);
* ``shed_backoff_ms`` (closed loop): a client's pause after a shed.

The door is the program's default ``FrontDoorConfig``.

The stream and the arrivals depend on the seed alone: the same seed
gives the same requests in the same order at the same offsets.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import watdiv

#: seed streams, one per use, so that each draws the same numbers
#: whatever the others draw (the vertex relabelling, the requests, the
#: arrivals); fixed numbers, so that a seed keeps its draws
GRAPH, REQUESTS, ARRIVALS = 0, 2, 3
#: the seed of the requests' constants, the same for every run seed
BINDINGS = 4


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for run seed ``seed`` (any whole
    number; taken modulo 2^64)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def template_probs(mix: Dict) -> np.ndarray:
    """The mix's template probabilities."""
    if "class_weights" in mix:
        probs = watdiv.class_template_probs(mix["class_weights"])
    else:
        probs = watdiv.zipf_probs(len(watdiv.TEMPLATE_CLASS),
                                  float(mix["template_zipf"]))
    out = [int(t) for t in mix.get("templates_left_out", [])]
    if out:
        probs = np.array(probs, np.float64)
        probs[out] = 0.0
        probs /= probs.sum()
    return probs


class Requests:
    """The mix's request stream, drawn block by block on demand; any
    thread may take the next request.  Each request is (index, edges,
    template id or -1, whether the reference checks it).  ``graph_cols``
    is the served graph's (s, p, o, num_vertices, num_properties) and
    ``perm`` the relabelling that made it (``watdiv.relabel``): the
    constants are drawn over the graph before it, so that every seed
    binds the same vertices."""

    def __init__(self, mix: Dict, graph_cols: Tuple, perm: np.ndarray,
                 seed: int):
        s, p, o, nv, _n_props = graph_cols
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=perm.dtype)
        self.domains = [{v: np.sort(inv[d]) for v, d in doms.items()}
                        for doms in watdiv.positions(
                            s, p, o, nv, watdiv.watdiv_templates())]
        self._stream = watdiv.stratified_queries(
            self.domains, rng(seed, REQUESTS), template_probs(mix),
            float(mix["cold_fraction"]), float(mix["constant_fraction"]),
            int(mix["block"]), float(mix["check_share"]), BINDINGS, perm)
        self._lock = threading.Lock()
        self._n = 0

    def next(self) -> Tuple[int, watdiv.Query, int, bool]:
        with self._lock:
            edges, tid, check = next(self._stream)
            i = self._n
            self._n += 1
            return i, edges, tid, check


def warmup_queries(mix: Dict) -> List[Tuple[watdiv.Query, int]]:
    """One request of every category the mix sends, each template bound
    to vertex 0 where the mix binds constants: the shapes the window
    runs, and no others (an engine that filters constants last runs a
    template's shape alike whatever it binds)."""
    shares = watdiv.category_shares(template_probs(mix),
                                    float(mix["cold_fraction"]))
    n_t = len(watdiv.TEMPLATE_CLASS)
    out: List[Tuple[watdiv.Query, int]] = []
    for c, t in enumerate(watdiv.watdiv_templates()):
        if shares[c] > 0:
            var = watdiv.variables(t)[0]
            bound = tuple((0 if s == var else s, 0 if d == var else d, p)
                          for s, d, p in t)
            out.append((bound if float(mix["constant_fraction"]) > 0
                        else t, c))
    for k, prop in enumerate(watdiv.COLD_PROPS):
        if shares[n_t + k] > 0:
            out.append((((watdiv.V(0), watdiv.V(1), prop),), -1))
    return out


def arrivals(mix: Dict, seconds: float, seed: int) -> Optional[np.ndarray]:
    """An open loop's arrival offsets in [0, seconds): ``rate_qps`` x
    ``seconds`` of them (rounded), uniform and sorted, which is a
    Poisson process given its count; ``None`` for a closed loop."""
    if mix["loop"] != "open":
        return None
    n = int(round(float(mix["rate_qps"]) * seconds))
    return np.sort(rng(seed, ARRIVALS).uniform(0.0, seconds, n))

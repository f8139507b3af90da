#!/usr/bin/env python3
"""Before/after numbers of the RDF serve on one NVIDIA GPU.

Builds the WatDiv plan of ``chip_smoke.py``, times a gather step's joins
as one call per site through the one-site entry points
(``ops.fused_join``, ``ops.pair_semijoin``) and as one call for all
sites (``ops.fused_join_sites``, ``ops.pair_semijoin_runs``: the
``sites times`` lines), the dedup as the match loop applied it before
the masked entry (``ops.dedup_rows`` then a ``torch.where``) and
``ops.semijoin`` (the ``path forms`` line), serves the 67 queries with
``execute`` and profiles one warm pass; it checks nothing and prints no
result line.  It needs nothing of the port beyond ``Session`` and those
entry points, so it also measures a checkout of an earlier commit:
copy this file and ``chip_smoke.py`` into that checkout's root and run

    python3 chip_baseline.py

there, before and after ``python3 chip_smoke.py`` of the change, in one
chip call.
"""
from __future__ import annotations

import sys
import time

import torch

import chip_smoke as smoke


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_baseline: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import build
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    graph, _design, _plan, session = smoke.rdf_setup()
    gen = torch.Generator(device="cpu").manual_seed(0)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).cuda()
    store = session.engine.store
    smoke.one_site_times(store, ints)
    smoke.sites_times(store.csr_sub_s, store.csr_sub_o,
                      smoke.largest_windows(store), ints)
    smoke.path_form_times(store, masked=False)
    queries = smoke.served_queries(graph)
    t0 = time.perf_counter()
    for q in queries:
        session.execute(q)
    torch.cuda.synchronize()
    st = session.stats()
    print(f"serve ({card}): {len(queries)} queries in "
          f"{time.perf_counter() - t0:.2f} s, comm_bytes={st.comm_bytes}, "
          f"capacity_retries={int(st.extra['capacity_retries'])}", flush=True)
    smoke.serve_profile(session, queries)


if __name__ == "__main__":
    main()

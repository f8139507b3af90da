"""The frozen generators reproduce the program's at small sizes, and the
stratified stream holds its counts."""
import numpy as np
import pytest

from rdfbench import traffic, watdiv


def program_graph(n, seed):
    from repro_torch.core import generate_watdiv
    return generate_watdiv(n, seed=seed)


@pytest.mark.parametrize("n,seed", [(5000, 0), (12000, 7)])
def test_graph_equals_the_programs(n, seed):
    s, p, o, nv, n_props = watdiv.generate_watdiv(n, seed)
    g = program_graph(n, seed)
    assert (nv, n_props) == (g.num_vertices, g.num_properties)
    for a, b in ((s, g.s), (p, g.p), (o, g.o)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(watdiv.PROPERTIES) == list(g.property_names)


def test_templates_equal_the_programs():
    from repro_torch.core import watdiv_templates
    from repro_torch.core.workload import PROP, TEMPLATE_CLASS
    assert watdiv.PROP == PROP
    assert watdiv.TEMPLATE_CLASS == TEMPLATE_CLASS
    ours = watdiv.watdiv_templates()
    theirs = [tuple((e.src, e.dst, e.prop) for e in q.edges)
              for q in watdiv_templates()]
    assert ours == theirs


@pytest.mark.parametrize("kw", [
    {},
    {"constant_fraction": 1.0, "cold_fraction": 0.0},
    {"template_probs": "drift"},
])
def test_workload_equals_the_programs(kw):
    from repro_torch.core import class_template_probs, generate_workload
    kw = dict(kw)
    if kw.get("template_probs") == "drift":
        kw["template_probs"] = class_template_probs({"F": 12.0})
        assert np.allclose(kw["template_probs"],
                           watdiv.class_template_probs({"F": 12.0}))
    g = program_graph(6000, 3)
    wl = generate_workload(g, 300, seed=11, **kw)
    queries, tids = watdiv.generate_workload(g.num_vertices, 300, seed=11,
                                             **kw)
    assert tids == wl.template_ids
    assert queries == [tuple((e.src, e.dst, e.prop) for e in q.edges)
                       for q in wl.queries]


GRAPH = watdiv.generate_watdiv(6000, 1)
DOMAINS = watdiv.positions(*GRAPH[:4], watdiv.watdiv_templates())


def draw(seed, n, block=200, check=0.1, constant_fraction=0.5):
    probs = watdiv.zipf_probs(13, 1.3)
    st = watdiv.stratified_queries(DOMAINS, traffic.rng(seed, 2), probs,
                                   0.03, constant_fraction, block, check)
    return [next(st) for _ in range(n)]


def test_positions_are_the_variables_places_in_the_matches():
    from rdfbench import reference
    index = reference.GraphIndex(*GRAPH)
    for tmpl, doms in zip(watdiv.watdiv_templates(), DOMAINS):
        variables, rows = reference.match(index, tmpl)
        assert len(rows)
        for v, dom in doms.items():
            want = np.unique(rows[:, variables.index(v)])
            assert np.array_equal(dom, want), (tmpl, v)


def test_every_bound_request_has_an_answer():
    from rdfbench import reference
    index = reference.GraphIndex(*GRAPH)
    got = draw(3, 400, constant_fraction=1.0)
    templates = watdiv.watdiv_templates()
    for q, tid, _c in got:
        if tid < 0:
            continue
        consts = [(i, j) for i, e in enumerate(q) for j in (0, 1)
                  if e[j] >= 0]
        assert consts, q
        i, j = consts[0]
        var = templates[tid][i][j]
        assert q[i][j] in DOMAINS[tid][var]
        assert len(reference.match(index, q)[1]) > 0, q


def category(q, tid):
    return tid if tid >= 0 else 13 + watdiv.COLD_PROPS.index(q[0][2])


def test_stratified_blocks_hold_fixed_counts():
    block = 200
    counts = watdiv.largest_remainder(
        watdiv.category_shares(watdiv.zipf_probs(13, 1.3), 0.03), block)
    assert counts.sum() == block and counts[10] >= 1
    got = draw(1, 3 * block, block)
    for b in range(3):
        part = got[b * block:(b + 1) * block]
        cats = np.bincount([category(q, t) for q, t, _c in part],
                           minlength=16)
        assert np.array_equal(cats, counts)
        for c in range(16):
            mine = [x for x in part if category(x[0], x[1]) == c]
            if not mine:
                continue
            assert sum(chk for _q, _t, chk in mine) == max(
                1, round(len(mine) * 0.1))
            if c < 13:
                bound = sum(any(v >= 0 for e in q for v in e[:2])
                            for q, _t, _c in mine)
                assert bound == round(len(mine) * 0.5)


def test_stratified_stream_depends_on_the_seed_alone():
    assert draw(4, 300) == draw(4, 300)
    a, b = draw(4, 200), draw(5, 200)
    assert a != b
    assert sorted(category(q, t) for q, t, _c in a) == \
        sorted(category(q, t) for q, t, _c in b)
    # every seed sends the same requests in another order
    assert sorted(q for q, _t, _c in a) == sorted(q for q, _t, _c in b)
    assert [c for _q, _t, c in a] != [c for _q, _t, c in b]


def test_every_seed_binds_the_same_vertices():
    s, p, o, nv, n_props = GRAPH
    mix = {"template_zipf": 1.3, "cold_fraction": 0.03,
           "constant_fraction": 1.0, "block": 200, "check_share": 0.1}
    ident = np.arange(nv, dtype=np.int32)
    plain = traffic.Requests(mix, GRAPH, ident, 8)
    perm = traffic.rng(77, traffic.GRAPH).permutation(nv).astype(np.int32)
    s2, o2, _ = watdiv.relabel(perm, s, o, [])
    moved = traffic.Requests(mix, (s2, p, o2, nv, n_props), perm, 8)
    for _ in range(250):
        _i, qa, ta, ca = plain.next()
        _j, qb, tb, cb = moved.next()
        assert (ta, ca) == (tb, cb)
        assert qb == watdiv.relabel(perm, s[:0], o[:0], [qa])[2][0]


def test_seeds_of_more_than_32_bits_draw():
    big = 2 ** 31 + 12345
    assert traffic.rng(big, 0).integers(0, 10, 3).shape == (3,)
    assert traffic.rng(-big, 0).integers(0, 10, 3).shape == (3,)


def test_open_arrivals_are_fixed_in_count_and_sorted():
    mix = {"loop": "open", "rate_qps": 25.0}
    a = traffic.arrivals(mix, 10.0, 9)
    assert len(a) == 250 and np.all(np.diff(a) >= 0)
    assert a.min() >= 0 and a.max() < 10.0
    assert np.array_equal(a, traffic.arrivals(mix, 10.0, 9))
    assert traffic.arrivals({"loop": "closed"}, 10.0, 9) is None


def test_warm_up_sends_each_shape_the_mix_sends():
    mix = {"template_zipf": 1.3, "cold_fraction": 0.03,
           "constant_fraction": 1.0}
    qs = traffic.warmup_queries(mix)
    assert sorted(t for _q, t in qs) == [-1, -1, -1] + list(range(13))
    drift = {"class_weights": {"F": 12.0}, "cold_fraction": 0.0,
             "constant_fraction": 0.0}
    qs = traffic.warmup_queries(drift)
    assert sorted(t for _q, t in qs) == list(range(13))
    assert all(v < 0 for q, _t in qs for e in q for v in e[:2])


def test_relabelling_serves_an_isomorphic_graph():
    from rdfbench import reference
    s, p, o, nv, n_props = watdiv.generate_watdiv(6000, 1)
    queries, _ = watdiv.generate_workload(nv, 40, seed=2,
                                          constant_fraction=1.0)
    perm = traffic.rng(99, traffic.GRAPH).permutation(nv).astype(np.int32)
    s2, o2, q2 = watdiv.relabel(perm, s, o, queries)
    a = reference.GraphIndex(s, p, o, nv, n_props)
    b = reference.GraphIndex(s2, p, o2, nv, n_props)
    for t in watdiv.watdiv_templates():
        assert reference.pattern_peak(a, t) == reference.pattern_peak(b, t)
    for q, r in zip(queries, q2):
        va, ra = reference.match(a, q)
        vb, rb = reference.match(b, r)
        assert va == vb
        assert np.array_equal(np.unique(perm[ra], axis=0), rb)


def test_left_out_templates_are_never_sent():
    mix = {"template_zipf": 1.3, "cold_fraction": 0.03,
           "constant_fraction": 1.0, "block": 200, "check_share": 0.1,
           "templates_left_out": [10]}
    probs = traffic.template_probs(mix)
    full = watdiv.zipf_probs(13, 1.3)
    assert probs[10] == 0.0 and np.isclose(probs.sum(), 1.0)
    keep = np.arange(13) != 10
    assert np.allclose(probs[keep], full[keep] / full[keep].sum())
    assert 10 not in [t for _q, t in traffic.warmup_queries(mix)]
    ident = np.arange(GRAPH[3], dtype=np.int32)
    reqs = traffic.Requests(mix, GRAPH, ident, 5)
    got = [reqs.next() for _ in range(600)]
    tids = [t for _i, _q, t, _c in got]
    assert 10 not in tids
    assert set(tids) == set(range(13)) - {10} | {-1}

"""The NumPy reference against brute force on tiny graphs."""
import itertools

import numpy as np
import pytest

from rdfbench import reference, watdiv

NV = 7


def tiny_graph(seed):
    """Random edges over ``NV`` vertices and every property, dense
    enough that every template has matches."""
    rng = np.random.default_rng(seed)
    n = 16 * 24
    s = rng.integers(0, NV, n)
    p = np.repeat(np.arange(16), 24)
    o = rng.integers(0, NV, n)
    key = np.unique((p * NV + s) * NV + o)
    p, rest = np.divmod(key, NV * NV)
    s, o = np.divmod(rest, NV)
    return s, p, o


def brute_force(s, p, o, edges):
    """Every assignment of the variables to vertices that makes each
    edge a triple of the graph, as distinct sorted rows."""
    triples = set(zip(s.tolist(), p.tolist(), o.tolist()))
    variables = sorted({v for e in edges for v in e[:2] if v < 0})
    rows = []
    for vals in itertools.product(range(NV), repeat=len(variables)):
        a = dict(zip(variables, vals))
        if all((a.get(x, x), q, a.get(y, y)) in triples
               for x, y, q in edges):
            rows.append(vals)
    arr = np.array(sorted(rows), np.int64).reshape(-1, len(variables))
    return variables, arr


def count_matches(s, p, o, edges):
    return len(brute_force(s, p, o, edges)[1])


def cases():
    out = [(f"template{i}", t)
           for i, t in enumerate(watdiv.watdiv_templates())]
    t0 = watdiv.watdiv_templates()[0]
    out += [("bound_start", ((2, -2, t0[0][2]), t0[1])),
            ("bound_end", (t0[0], (-2, 3, t0[1][2]))),
            ("two_constants", ((1, -2, 0), (-2, 4, 1))),
            ("cycle", ((-1, -2, 0), (-2, -3, 1), (-3, -1, 2))),
            ("self_loop", ((-1, -1, 3), (-1, -2, 4))),
            ("parallel", ((-1, -2, 0), (-1, -2, 1))),
            ("cold_lookup", ((-1, -2, 13),))]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,edges", cases())
def test_match_equals_brute_force(seed, name, edges):
    s, p, o = tiny_graph(seed)
    index = reference.GraphIndex(s, p, o, NV, 16)
    got = reference.match(index, edges)
    want = brute_force(s, p, o, edges)
    assert len(want[1]) or name in ("two_constants", "self_loop")
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1]), name


@pytest.mark.parametrize("i", [0, 1, 3, 4, 6, 8, 10, 11])
def test_pattern_peak_is_the_largest_connected_part(i):
    s, p, o = tiny_graph(3)
    index = reference.GraphIndex(s, p, o, NV, 16)
    t = watdiv.watdiv_templates()[i]
    # bound to a constant: the peak is the constant-free pattern's
    var = watdiv.variables(t)[0]
    bound = tuple((2 if x == var else x, 2 if y == var else y, q)
                  for x, y, q in t)
    norm = reference.normalized(bound)
    want = 0
    for k in range(1, len(norm) + 1):
        for sub in itertools.combinations(norm, k):
            vs = {v for e in sub for v in e[:2]}
            if reference._connected(sub, vs):
                want = max(want, count_matches(s, p, o, sub))
    assert reference.pattern_peak(index, bound) == want


def test_pattern_peak_of_a_cycle_is_unknown():
    s, p, o = tiny_graph(0)
    index = reference.GraphIndex(s, p, o, NV, 16)
    assert reference.pattern_peak(
        index, ((-1, -2, 0), (-2, -3, 1), (-3, -1, 2))) is None


def test_answers_compare_as_sets_of_rows():
    a = reference.rows_of({-2: np.array([3, 1, 3]), -1: np.array([0, 5, 0])})
    assert a[0] == [-2, -1]
    assert a[1].tolist() == [[1, 5], [3, 0]]
    b = ([-2, -1], np.array([[1, 5], [3, 0]]))
    assert reference.same_answer(a, b)
    assert not reference.same_answer(a, ([-2, -1], np.array([[1, 5]])))
    assert not reference.same_answer(a, ([-1, -2], a[1]))

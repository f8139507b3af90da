"""Shared pieces of the port's differential tests: the seeded random
graph, its shape workload and 4-site vertical plan, the routine that
serves one plan through the JAX ``SpmdEngine`` and the port's and
compares everything both report, exactly, and the runner that puts the
JAX package's own tests (telemetry, serving, planning, the online loop,
checkpoints) through the port."""
import copy
import dataclasses
import importlib
import inspect
import sys

import numpy as np
import pytest

from generators import SEED, answer_set, random_graph, shape_workload
from repro.core import PartitionConfig, Session, build_plan
from repro.core.matching import match_pattern as j_match_pattern
from repro.core.query import QueryGraph as JQuery
from repro.core.workload import Workload
from repro.launch.mesh import make_host_mesh
from repro_torch import convert
from repro_torch.core import PartitionConfig as TConfig
from repro_torch.core import QueryGraph, RDFGraph
from repro_torch.core import build_plan as t_build_plan
from repro_torch.core import match_pattern as t_match_pattern
from repro_torch.core.workload import Workload as TWorkload


def port_query(q):
    return QueryGraph.make([(e.src, e.dst, e.prop) for e in q.edges])


@pytest.fixture(scope="module")
def rgraph():
    return random_graph(SEED)


@pytest.fixture(scope="module")
def rqueries(rgraph):
    qs = shape_workload(rgraph, SEED, n_props=rgraph.num_properties)
    # a star whose three steps ship the same property's edges: the
    # second and third reuse the first gather (COMM_EDGE_CACHED)
    qs.append(JQuery.make([(-1, -2, 5), (-1, -3, 5), (-1, -4, 5)]))
    return qs


@pytest.fixture(scope="module")
def rplan(rgraph, rqueries):
    return build_plan(rgraph, Workload(list(rqueries)),
                      PartitionConfig(kind="vertical", num_sites=4))


@pytest.fixture(scope="module")
def tplan(rgraph, rqueries):
    """The port's own plan of ``rplan``'s inputs (identical per-site
    storage: ``tests/test_torch_plan.py``), for the port's ``Session``."""
    g = RDFGraph(rgraph.s, rgraph.p, rgraph.o, rgraph.num_vertices,
                 rgraph.num_properties)
    return t_build_plan(g, TWorkload([port_query(q) for q in rqueries]),
                        TConfig(kind="vertical", num_sites=4))


def differential(plan, queries, mesh_n, capacity, comm_plan=True,
                 routing=True, via_state=False):
    """Serve ``queries`` through both engines and compare everything the
    engines report.  The port's engine is built from the plan's serving
    arrays (``convert.plan_arrays``), or with ``via_state`` from the
    port's own ``PartitionPlan`` rebuilt from the whole plan
    (``convert.plan_state_arrays``).  Returns the port engine's
    stats."""
    jeng = Session(plan, backend="spmd", mesh=make_host_mesh(mesh_n),
                   spmd_capacity=capacity, spmd_comm_plan=comm_plan,
                   spmd_routing=routing).engine
    kw = dict(device="cpu", num_devices=mesh_n, capacity=capacity,
              comm_plan=comm_plan, routing=routing)
    if via_state:
        teng = convert.plan_from_state_arrays(
            convert.plan_state_arrays(plan)).build_spmd_engine(**kw)
    else:
        teng = convert.engine_from_arrays(convert.plan_arrays(plan), **kw)
    tgraph = RDFGraph(plan.graph.s, plan.graph.p, plan.graph.o,
                      plan.graph.num_vertices, plan.graph.num_properties)
    # residency metadata the planner and the router read: identical
    for f in ("prop_dev_rows", "prop_dev_distinct", "prop_union_rows",
              "prop_dev_owned"):
        np.testing.assert_array_equal(getattr(teng.store, f),
                                      np.asarray(getattr(jeng.store, f)))
    for q in queries:
        tq = port_query(q)
        jroute = jeng._route(q.normalize())
        troute = teng._route(tq.normalize())
        assert (troute is None) == (jroute is None)
        if jroute is not None:
            assert dataclasses.asdict(troute) == dataclasses.asdict(jroute)
        jr, tr = jeng.execute(q), teng.execute(tq)
        want = answer_set(jr)
        assert answer_set(tr) == want, f"answers diverged on {q.edges}"
        assert answer_set(j_match_pattern(plan.graph, q)) == want
        assert answer_set(t_match_pattern(tgraph, tq)) == want
        assert tr.stats.comm_bytes == jr.stats.comm_bytes, q.edges
        assert tr.stats.sites_touched == jr.stats.sites_touched
        # the final tier again (warm hints): identical step vectors
        _jb, _jv, jcaps, jatt = jeng._run_exact(q.normalize())
        _out, tcaps, tatt = teng._run_exact(tq.normalize())
        assert tcaps == jcaps
        for (jd, jrows, jn), (td, trows, tn) in zip(jatt, tatt):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(trows, jrows)
            assert tn == jn
    js, ts = jeng.stats(), teng.stats()
    assert ts.comm_bytes == js.comm_bytes
    assert ts.result_rows == js.result_rows
    assert ts.extra == js.extra
    return ts


# ----------------------------------------------------------------------
# The reference's own unit tests, run against either package
# ----------------------------------------------------------------------

# constants the reference test modules import by name (no __module__)
_PORT_CONSTANTS = {"REQUIRED_METRICS": "repro.obs.export",
                   "REQUIRED_SERVE_METRICS": "repro.obs.export",
                   "SNAPSHOT_SCHEMA": "repro.obs.export",
                   "BACKENDS": "repro.core.session",
                   "BYTES_PER_EDGE": "repro.online.migration"}
_SWAPPED_PACKAGES = ("repro.obs", "repro.serve", "repro.core",
                     "repro.online", "repro.checkpoint", "repro.distributed",
                     "repro.data")


def reference_unit_tests(module):
    """Names of the tests of a reference test module that take no
    fixture but ``tmp_path`` (its unit tests, with fakes only)."""
    return sorted(
        name for name, fn in vars(module).items()
        if name.startswith("test_") and callable(fn)
        and set(inspect.signature(fn).parameters) <= {"tmp_path"})


def _names_used(fn):
    """Global names a test reads, through the wrapper a property-test
    decorator puts around it."""
    names = set(fn.__code__.co_names)
    for cell in fn.__closure__ or ():
        inner = cell.cell_contents
        if callable(inner) and hasattr(inner, "__code__"):
            names |= set(inner.__code__.co_names)
    return names


def swap_imports_in_body(fn, monkeypatch):
    """Point every module of the swapped packages that ``fn`` imports in
    its own body (``from repro.data import ...``) at the port's module
    of the same path, through ``sys.modules``, while the test runs.
    Returns the module names swapped."""
    swapped = set()
    for name in _names_used(fn):
        if name.startswith(_SWAPPED_PACKAGES):
            port = importlib.import_module("repro_torch" + name[len("repro"):])
            monkeypatch.setitem(sys.modules, name, port)
            swapped.add(name)
    return swapped


def swap_to_port(module, monkeypatch):
    """Bind every name ``module`` imported from the JAX package's
    ``obs`` / ``serve`` / ``core`` / ``online`` / ``checkpoint`` /
    ``distributed`` / ``data`` to the port's module of the same path.
    Returns (the names swapped, the names the port lacks)."""
    swapped, missing = set(), set()
    for attr, val in list(vars(module).items()):
        src = _PORT_CONSTANTS.get(attr) or getattr(val, "__module__", None)
        if not (isinstance(src, str) and src.startswith(_SWAPPED_PACKAGES)):
            continue
        try:
            port = importlib.import_module("repro_torch" + src[len("repro"):])
        except ImportError:
            port = None
        if port is None or not hasattr(port, attr):
            missing.add(attr)
            continue
        monkeypatch.setattr(module, attr, getattr(port, attr))
        swapped.add(attr)
    return swapped, missing


def pin_port_to_cpu(monkeypatch):
    """The port's entry points default to ``device="cuda"``; the JAX
    package's scenarios name no device.  Resolve every device the
    port's modules ask for to the CPU while a scenario runs, so it runs
    here on the plain versions, as the JAX package's runs on the
    CPU."""
    import repro_torch.device as dev
    resolve = dev.resolve_device

    def to_cpu(device):
        return resolve("cpu")

    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch") \
                and getattr(mod, "resolve_device", None) is resolve:
            monkeypatch.setattr(mod, "resolve_device", to_cpu)


_FIXTURES = {}


def _is_fixture(obj):
    return callable(obj) and hasattr(obj, "__wrapped__") \
        and type(obj).__name__ == "FixtureFunctionDefinition"


def reference_fixture(module, name, package, conftest):
    """The value of the reference module's fixture ``name`` built with
    ``package``'s names (and, for the port, on the CPU), once per
    module, fixture and package.  Its own fixture arguments come from
    the module's fixtures or from ``conftest`` (name -> zero-argument
    callable giving ``package``'s value)."""
    key = (module.__name__, name, package)
    if key not in _FIXTURES:
        fn = getattr(module, name).__wrapped__
        args = fixture_args(module, fn, package, conftest)
        with pytest.MonkeyPatch.context() as mp:
            if package == "repro_torch":
                swap_to_port(module, mp)
                pin_port_to_cpu(mp)
            _FIXTURES[key] = fn(**args)
    return _FIXTURES[key]


def fixture_args(module, fn, package, conftest, given=None):
    """The fixture arguments of the test or fixture ``fn`` of the
    reference ``module``, but ``tmp_path``, built for ``package``:
    ``given`` ones (a parametrized case's values) as they are, the
    module's own fixtures through ``reference_fixture``, the others
    from ``conftest``."""
    out = dict(given or {})
    for name in inspect.signature(fn).parameters:
        if name == "tmp_path" or name in out:
            continue
        if _is_fixture(getattr(module, name, None)):
            out[name] = reference_fixture(module, name, package, conftest)
        else:
            out[name] = conftest[name]()
    return out


def run_reference_test(module, name, package, monkeypatch, tmp_path,
                       **fixtures):
    """Run ``module.<name>`` with every name it imported from the JAX
    package's swapped packages bound to ``package``'s module of the
    same path (``"repro"`` leaves it as it is, ``"repro_torch"`` swaps
    in the port and resolves the port's devices to the CPU), so one
    scenario checks both implementations; so are the modules the test
    imports in its own body (``swap_imports_in_body``).  Every such name
    the test reads must exist in the port.  ``fixtures`` supplies the
    test's fixture arguments other than ``tmp_path``, built for
    ``package``."""
    fn = getattr(module, name)
    if package == "repro_torch":
        swapped, missing = swap_to_port(module, monkeypatch)
        swapped |= swap_imports_in_body(fn, monkeypatch)
        assert swapped, f"{module.__name__} imports nothing to swap"
        unported = missing & _names_used(fn)
        assert not unported, f"{name} reads names the port lacks: {unported}"
        pin_port_to_cpu(monkeypatch)
    kw = {k: fixtures[k] if k != "tmp_path" else tmp_path
          for k in inspect.signature(fn).parameters}
    fn(**kw)


# ----------------------------------------------------------------------
# The seeded ledger benches (``chip_smoke.ledger_runs``) on both packages
# ----------------------------------------------------------------------

def assert_same_ledger(want, got, bench, reference_totals):
    """``ledger_runs`` output of the port (``got``) equals the JAX
    package's (``want``) for ``bench``: bytes per session and shape,
    answers, every session's ``stats().extra``; and the totals equal
    ``reference_totals``."""
    w, g = want[bench], got[bench]
    assert g["per_shape"] == w["per_shape"]
    assert g["mismatches"] == w["mismatches"] == 0
    assert g["extra"] == w["extra"]
    totals = {name: sum(v[name] for v in g["per_shape"].values())
              for name in reference_totals}
    assert totals == reference_totals


def assert_ledger_checker_catches(runs, bench, low, high, failures):
    """``failures`` (``chip_smoke.ledger_failures``) reports a changed
    total and ``low``'s ledger above ``high``'s on one shape, and also
    ``low`` below ``high`` on no shape."""
    runs = copy.deepcopy(runs)
    runs[bench]["per_shape"]["star"][low] += 10**6
    bad = failures(runs)
    assert any(b.startswith(f"{bench}: totals") for b in bad)
    assert f"{bench}: {low} above {high} on a shape" in bad
    for v in runs[bench]["per_shape"].values():
        v[low] = v[high]
    assert f"{bench}: {low} below {high} on no shape" in failures(runs)

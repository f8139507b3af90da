"""The rules engine against the JAX package's: ``make_rules`` and
``spec_for`` on every arch of ``configs.ARCHS`` at its full published
config (parameter definitions and decode-cache shapes only, nothing
allocated), on both production mesh shapes, with ``fsdp`` and the
decode rules (``seq_model_shard``) on and off.

The reference's ``spec_for`` reads a mesh's ``axis_names`` and
``devices.shape`` and nothing else (``common.py:186-204``), so the JAX
side gets a stub with those two; the port's gets a stub with a
``DeviceMesh``'s ``mesh_dim_names`` and ``shape``.  Specs compare as
tuples."""
import dataclasses
import types

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import get_api as j_get_api
from repro.models.common import make_rules as j_make_rules
from repro.models.common import param_pspecs as j_param_pspecs
from repro.models.common import spec_for as j_spec_for
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import _rules_for
from repro_torch.models import (PartitionSpec, get_api, make_rules,
                                param_placements, param_pspecs, spec_for)
from repro_torch.models.common import iter_defs, mesh_sizes

ARCHS = list(tconfigs.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  devices=np.empty(shape, dtype=object))
    tmesh = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    return jmesh, tmesh


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _cache_pairs(arch, jcfg, tcfg):
    """(path, shape, JAX axes, port axes) of every decode-cache leaf at
    each decode shape of the arch that is not skipped."""
    spec = tconfigs.get_arch(arch)
    for sname, sh in spec.shapes.items():
        if sh.kind != "decode" or sh.skip:
            continue
        japi, tapi = j_get_api(jcfg), get_api(tcfg)
        jshapes = dict(_leaves(japi.init_cache(jcfg, sh.global_batch,
                                               sh.seq_len, as_shape=True)))
        tshapes = dict(_leaves(tapi.init_cache(tcfg, sh.global_batch,
                                               sh.seq_len, "meta")))
        jaxes = dict(_leaves_axes(japi.cache_axes(jcfg)))
        taxes = dict(_leaves_axes(tapi.cache_axes(tcfg)))
        assert jshapes.keys() == tshapes.keys() == jaxes.keys() == taxes.keys()
        for path in sorted(jshapes):
            assert tuple(jshapes[path].shape) == tuple(tshapes[path].shape)
            yield (f"{sname}:{path}", tuple(tshapes[path].shape),
                   jaxes[path], taxes[path])


def _leaves_axes(tree, prefix=""):
    """Leaves of a logical-axes tree (tuples of names are leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_axes(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tuple(tree)


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_jax(arch, mesh, fsdp, decode):
    """Every parameter definition and every decode-cache entry gets the
    reference's spec, and ``param_pspecs`` the reference's tree."""
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).config, fsdp=fsdp,
                               seq_shard_decode=decode)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).config, fsdp=fsdp,
                               seq_shard_decode=decode)
    jrules = j_make_rules(fsdp=fsdp, seq_model_shard=decode)
    trules = make_rules(fsdp=fsdp, seq_model_shard=decode)
    assert trules == jrules
    assert _rules_for(tcfg, decode) == trules
    jmesh, tmesh = _meshes(mesh)
    jdefs, tdefs = j_get_api(jcfg).defs(jcfg), get_api(tcfg).defs(tcfg)
    tspecs = param_pspecs(tdefs, tmesh, trules)
    jspecs = dict(_leaves(j_param_pspecs(jdefs, jmesh, jrules)))
    n = 0
    for path, d in iter_defs(tdefs):
        leaf = jdefs
        for k in path.split("."):
            leaf = leaf[k]
        want = tuple(j_spec_for(leaf.shape, leaf.axes, jmesh, jrules))
        got = spec_for(d.shape, d.axes, tmesh, trules)
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == want, path
        assert tuple(jspecs[path]) == want, path
        sub = tspecs
        for k in path.split("."):
            sub = sub[k]
        assert tuple(sub) == want, path
        n += 1
    assert n == sum(1 for _ in _leaves(jdefs))
    for path, shape, jax_axes, port_axes in _cache_pairs(arch, jcfg, tcfg):
        assert port_axes == jax_axes, path
        assert tuple(spec_for(shape, port_axes, tmesh, trules)) == tuple(
            j_spec_for(shape, jax_axes, jmesh, jrules)), path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_follow_the_spec(mesh):
    """``param_placements`` on a stub mesh: a spec entry shards
    its tensor dimension on every mesh axis it names (a tuple in mesh
    order), the other axes replicate; llama3-405b with FSDP shards its
    embed dimension on "data" (and its MLP on "model")."""
    from torch.distributed.tensor import Replicate, Shard
    _jmesh, tmesh = _meshes(mesh)
    cfg = tconfigs.get_arch("llama3-405b").config
    assert cfg.fsdp and cfg.seq_shard_decode
    rules = _rules_for(cfg, decode=False)
    defs = get_api(cfg).defs(cfg)
    places = param_placements(defs, tmesh, rules)
    names = tmesh.mesh_dim_names
    for path, d in iter_defs(defs):
        pl = places
        for k in path.split("."):
            pl = pl[k]
        spec = spec_for(d.shape, d.axes, tmesh, rules)
        want = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                want[names.index(ax)] = Shard(dim)
        assert list(pl) == want, path
    w1 = places["layers"]["mlp"]["w1"]
    assert w1[names.index("data")] == Shard(1)       # [L, D, F]: embed
    assert w1[names.index("model")] == Shard(2)      # mlp
    assert mesh_sizes(tmesh) == dict(zip(names, MESHES[mesh][0]))


def test_cache_axes_match_jax():
    """``ModelApi.cache_axes`` of every family is the reference's."""
    for arch in ARCHS:
        jcfg = jconfigs.get_arch(arch).config
        tcfg = tconfigs.get_arch(arch).config
        assert dict(_leaves_axes(get_api(tcfg).cache_axes(tcfg))) == dict(
            _leaves_axes(j_get_api(jcfg).cache_axes(jcfg))), arch


def test_production_configs_carry_the_sharding_fields():
    """llama3-405b and jamba-1.5-large set ``fsdp`` and
    ``seq_shard_decode`` as the reference's configs do."""
    for arch in ("llama3-405b", "jamba-1.5-large-398b"):
        cfg = tconfigs.get_arch(arch).config
        jcfg = jconfigs.get_arch(arch).config
        assert (cfg.fsdp, cfg.seq_shard_decode) == (True, True)
        assert (jcfg.fsdp, jcfg.seq_shard_decode) == (True, True)
        assert _rules_for(cfg, True)["cache_seq"] == [("model",)]
        assert _rules_for(cfg, False)["embed"] == [("data",), ("pod",)]


def test_make_production_mesh_names_the_world_it_needs():
    """Without a group of 256 (512) ranks ``make_production_mesh``
    raises a ``RuntimeError`` naming the count, as the reference's does
    for its devices."""
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")

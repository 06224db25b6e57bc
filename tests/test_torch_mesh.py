"""The port's mesh tooling on the CPU against the JAX package: the
logical-axis rules (``runtime/mesh_rules``), each parameter's logical axes
(``LMModel.logical_axes``), elastic resharding (``checkpoint/reshard``),
the production and local meshes (``launch/mesh``) and pipeline
parallelism (``runtime/pipeline_parallel``).

Specs and shapes are compared exactly; tensors moved between meshes at 0;
the pipeline against the sequential stages computed in JAX at atol 1e-5
(``tests/dist_scripts/elastic_pp.py``'s tolerance).  Multi-device JAX runs
in one subprocess with 8 forced host devices, as ``run_dist_script``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.runtime import mesh_rules as ref_rules

import repro
import repro_torch
from repro_torch.checkpoint import (CheckpointManager, reshard_tree,
                                    shardings_from_specs)
from repro_torch.checkpoint.reshard import NamedSharding, ShardedTensor
from repro_torch.configs import ARCHS
from repro_torch.core.distributed import ENV_DEVICE_COUNT
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.common import LogicalAxes
from repro_torch.runtime import mesh_rules
from repro_torch.runtime.mesh_rules import P, AxisRules
from repro_torch.runtime.pipeline_parallel import (bubble_fraction,
                                                   pipeline_apply)

#: every flag of ``default_rules`` set alone, on each mesh kind
FLAGS = [{}, {"seq_parallel_cache": True}, {"expert_parallel": True},
         {"shard_residual": False}, {"fsdp_over_pod": True}]
#: a subprocess's JAX: 8 host devices, one thread for its Eigen kernels
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_cpu_multi_thread_eigen=false")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_specs(cfg):
    """The reference's spec tree, flattened to {path: names}."""
    with ref_common.abstract_init():
        tree = ref_transformer.build(cfg).init(jax.random.PRNGKey(0))
    _, specs = ref_common.split_params(tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, ref_common.LogicalAxes))
    return {jax.tree_util.keystr(p, simple=True, separator="/"): s.names
            for p, s in flat}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree.names}


@pytest.fixture(scope="module")
def ref_spec_trees():
    return {name: _ref_specs(REF_ARCHS[name].reduced()) for name in ARCHS}


# ---- rules -----------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(f) or "none")
def test_pspec_equals_the_reference_for_every_leaf(ref_spec_trees, multi_pod,
                                                    flags):
    mine = mesh_rules.default_rules(multi_pod, **flags)
    ref = ref_rules.default_rules(multi_pod, **flags)
    assert mine.table == ref.table
    for name, specs in ref_spec_trees.items():
        for path, names in specs.items():
            got, want = mine.pspec(names), ref.pspec(names)
            assert isinstance(got, mesh_rules.PartitionSpec)
            assert tuple(got) == tuple(want), (name, path)
            assert got == tuple(want)


def test_a_mesh_axis_appears_once():
    rules = AxisRules(table={"a": ("data", "model"), "b": "model",
                             "c": "data"})
    ref = ref_rules.AxisRules(table=rules.table)
    for axes in [("a", "b"), ("b", "a"), ("c", "a", "b"), ("a", "a"),
                 ("none", "b", None)]:
        assert tuple(rules.pspec(axes)) == tuple(ref.pspec(axes))
    assert rules.pspec(("b", "c", "a")) == P("model", "data", None)


def test_use_rules_nests_restores_and_unknown_axes_raise():
    outer = mesh_rules.default_rules(False)
    inner = mesh_rules.default_rules(True)
    assert mesh_rules.get_rules() is None
    x = torch.ones(2, 3)
    assert mesh_rules.shard(x, "nonsense") is x      # no rules: no lookup
    with mesh_rules.use_rules(outer) as r:
        assert r is outer and mesh_rules.get_rules() is outer
        with mesh_rules.use_rules(inner):
            assert mesh_rules.get_rules() is inner
            assert mesh_rules.shard(x, "batch", "d_model") is x
        assert mesh_rules.get_rules() is outer
        with pytest.raises(KeyError, match="nonsense"):
            mesh_rules.shard(x, "batch", "nonsense")
        with ref_rules.use_rules(ref_rules.default_rules(False)):
            with pytest.raises(KeyError, match="nonsense"):
                ref_rules.get_rules().pspec(("batch", "nonsense"))
    assert mesh_rules.get_rules() is None
    with pytest.raises(KeyError, match="nonsense"):
        outer.pspec(("nonsense",))


# ---- logical axes of the port's parameters -----------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_logical_axes_equal_the_reference_spec_tree(ref_spec_trees, name):
    cfg = ARCHS[name].reduced()
    model = transformer.build(cfg, device="meta", train=True)
    want = ref_spec_trees[name]
    tree = model.reference_logical_axes()
    assert _flat(tree) == {k.replace(".", "/"): v for k, v in want.items()}
    assert len(tree["units"]) == len(cfg.pattern)
    assert len(tree["tail"]) == len(cfg.tail)
    leaves = model.reference_leaves()
    axes = model.logical_axes()
    assert set(axes) == {n for n, _ in model.named_parameters()}
    for pname, p in model.named_parameters():
        ref = want[leaves[pname].replace(".", "/")]
        if leaves[pname].startswith("units."):
            assert ref[0] == "unit"
            ref = ref[1:]
        assert axes[pname] == ref, pname
        assert len(axes[pname]) == p.ndim, pname


# ---- shardings: pieces and placements ------------------------------------------

_INDEX_SCRIPT = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for shape, names, dims, spec in cases:
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                tuple(names))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(dims))
    out.append([[list(s.indices(n)[:2]) for s, n in zip(m[d], dims)]
                for d in mesh.devices.flat])
print(json.dumps(out))
"""

INDEX_CASES = [
    ((2, 4), ("data", "model"), (16, 32), ["data", "model"]),
    ((2, 4), ("data", "model"), (16, 32), [["data", "model"], None]),
    ((2, 4), ("data", "model"), (16, 32), [None, ["model", "data"]]),
    ((2, 4), ("data", "model"), (8, 4, 6), ["model"]),
    ((2, 4), ("data", "model"), (8, 6), []),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6),
     [["pod", "data"], "model"]),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 8),
     ["model", None, ["data", "pod"]]),
    ((4, 2), ("pod", "data"), (4, 6, 2), ["pod", None, "data"]),
]


def test_indices_equal_devices_indices_map(monkeypatch):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, "-c", _INDEX_SCRIPT, json.dumps(INDEX_CASES)],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    monkeypatch.setenv(ENV_DEVICE_COUNT, "8")
    for (shape, names, dims, spec), ref in zip(INDEX_CASES, want):
        mesh = make_local_mesh(shape, names, device="cpu")
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        got = NamedSharding(mesh, spec).indices(dims)
        assert [[[s.start, s.stop] for s in idx] for idx in got] == ref, \
            (shape, spec)


def test_an_uneven_dim_is_refused_like_the_reference():
    mesh = make_local_mesh((4,), ("model",), device="meta")
    sh = NamedSharding(mesh, P(None, "model"))
    assert sh.shard_shape((8, 4)) == (8, 1)
    with pytest.raises(ValueError, match=r"w_up .*dim 1 \(2\).*'model'"):
        sh.shard_shape((8, 2), "w_up")
    ref = jax.sharding.NamedSharding(
        jax.sharding.AbstractMesh((4,), ("model",)),
        jax.sharding.PartitionSpec(None, "model"))
    with pytest.raises(ValueError, match="evenly divide"):
        ref.shard_shape((8, 2))
    with pytest.raises(ValueError, match="units/0/ffn/wo"):
        reshard_tree({"units": ({"ffn": {"wo": torch.zeros(8, 2)}},)},
                     {"units": ({"ffn": {"wo": sh}},)})


def _elastic_tree():
    g = torch.Generator().manual_seed(0)
    tree = {"w1": torch.randn(16, 32, generator=g),
            "w2": torch.randn(32, 16, generator=g)}
    specs = {"w1": LogicalAxes(("d_model", "d_ff")),
             "w2": LogicalAxes(("d_ff", "d_model"))}
    rules = AxisRules(table={"batch": ("data",), "d_model": "data",
                             "d_ff": "model"})
    return tree, specs, rules


def test_elastic_reshard_via_disk_and_live(monkeypatch, tmp_path):
    """``elastic_pp.py``'s cases: (2, 4) -> (4, 2) on 8 CPU mesh
    devices, through a checkpoint and live."""
    monkeypatch.setenv(ENV_DEVICE_COUNT, "8")
    tree, specs, rules = _elastic_tree()
    mesh_a = make_local_mesh((2, 4), ("data", "model"), device="cpu")
    mesh_b = make_local_mesh((4, 2), ("data", "model"), device="cpu")
    assert len(mesh_a.devices) == 8
    sh_a = shardings_from_specs(mesh_a, rules, specs)
    sh_b = shardings_from_specs(mesh_b, rules, specs)
    assert sh_a["w1"].spec == P("data", "model")
    assert sh_b["w2"].spec == P("model", "data")
    tree_a = reshard_tree(tree, sh_a)
    for k, t in tree_a.items():
        assert isinstance(t, ShardedTensor)
        for idx, piece in zip(t.sharding.indices(t.shape), t.pieces):
            assert piece.shape == t.sharding.shard_shape(t.shape)
            assert torch.equal(piece, tree[k][idx])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree_a)
    restored = mgr.restore(3, tree, shardings=sh_b)
    live = reshard_tree(tree_a, sh_b)
    for k in tree:
        for got in (restored[k], live[k]):
            assert got.sharding.mesh.shape["data"] == 4
            assert torch.equal(got.full(), tree[k])
            for idx, piece in zip(got.sharding.indices(got.shape),
                                  got.pieces):
                assert torch.equal(piece, tree[k][idx])
    assert torch.equal(mgr.restore(3, tree)["w2"], tree["w2"])


# ---- meshes ----------------------------------------------------------------

def test_production_and_local_meshes(monkeypatch):
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in multi.devices} == {"meta"} and multi.size == 512
    monkeypatch.delenv(ENV_DEVICE_COUNT, raising=False)
    with pytest.raises(ValueError, match=ENV_DEVICE_COUNT):
        make_local_mesh(device="cpu")
    monkeypatch.setenv(ENV_DEVICE_COUNT, "6")
    local = make_local_mesh((2, 3), ("data", "model"), device="cpu")
    assert local.shape == {"data": 2, "model": 3}
    assert local.coords(5) == {"data": 1, "model": 2}
    assert local.devices == (torch.device("cpu"),) * 6


# ---- pipeline parallelism -------------------------------------------------

def test_pipeline_equals_the_sequential_stages_in_jax(monkeypatch):
    monkeypatch.setenv(ENV_DEVICE_COUNT, "8")
    mesh = make_local_mesh((4, 2), ("pod", "data"), device="cpu")
    rng = np.random.default_rng(2)
    n_stages, n_micro, d = 4, 8, 16
    w = (0.3 * rng.standard_normal((n_stages, d, d))).astype(np.float32)
    b = (0.01 * rng.standard_normal((n_stages, d))).astype(np.float32)
    x = rng.standard_normal((n_micro, 4, d)).astype(np.float32)

    want = jnp.asarray(x)
    for s in range(n_stages):
        want = jax.vmap(lambda xm, s=s: jnp.tanh(xm @ w[s]) + b[s])(want)

    calls = []

    def stage_fn(params, h):
        calls.append(h.shape)
        return torch.tanh(h @ params["w"]) + params["b"]

    got = pipeline_apply(stage_fn, {"w": torch.from_numpy(w),
                                    "b": torch.from_numpy(b)},
                         torch.from_numpy(x), mesh=mesh, axis="pod",
                         micro_spec=P(None, None, None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert len(calls) == n_micro * n_stages      # the bubble runs nothing
    assert bubble_fraction(8, 4) == pytest.approx(3 / 11, abs=1e-12)
    with pytest.raises(ValueError, match="whole"):
        pipeline_apply(stage_fn, {"w": torch.from_numpy(w)},
                       torch.from_numpy(x), mesh=mesh, axis="pod",
                       micro_spec=P("data", None, None))


def test_pipeline_of_pattern_units_equals_the_units_in_turn(monkeypatch):
    """Stages that are a reduced gemma3-4b's pattern units, applied with
    ``torch.func.functional_call`` on params stacked on a stage axis."""
    monkeypatch.setenv(ENV_DEVICE_COUNT, "2")
    cfg = ARCHS["gemma3-4b"].reduced()
    model = transformer.build(cfg, device="cpu", seed=3)
    units = [transformer.PatternUnit(model, u) for u in range(cfg.units)]
    names = [n for n, _ in units[0].named_parameters()]
    stacked = {n: torch.stack([dict(u.named_parameters())[n].detach()
                               for u in units]) for n in names}
    mesh = make_local_mesh((cfg.units,), ("pod",), device="cpu")
    x = torch.randn(3, 1, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))

    def stage_fn(params, h):
        return torch.func.functional_call(units[0], params, (h,))

    with torch.no_grad():
        got = pipeline_apply(stage_fn, stacked, x, mesh=mesh)
        want = x.clone()
        for m in range(x.shape[0]):
            for u in units:
                want[m] = u(want[m])
    assert torch.equal(got, want)


# ---- the top-level exports ----------------------------------------------------

def test_top_level_exports_cover_the_reference():
    owed = {"pipelined_variant"}           # the deprecated shims' item
    assert set(repro.__all__) - owed <= set(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), name
    from repro_torch.kernels import ref
    from repro_torch.core import reference
    for name in ref.__all__:
        assert getattr(ref, name) is getattr(reference, name)

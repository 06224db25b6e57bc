"""The port's dry run on the CPU against the JAX package: the input shapes
(``configs/shapes``), the step counter (``analysis/roofline``) and the
dry run (``launch/dryrun``).

Shapes, shard shapes, parameter counts and argument bytes are compared
exactly; the counter's FLOPs against the reference's HLO parser on its
analytic programs exactly, and against a compiled reduced step within
``FLOPS_TOL`` (measured); the collective bytes are printed beside XLA's,
not compared: the port's are a model.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import input_specs as ref_input_specs
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.runtime import mesh_rules as ref_rules

from repro_torch.analysis import roofline
from repro_torch.checkpoint.reshard import NamedSharding
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, input_specs, \
    shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.runtime import mesh_rules

# The reference's dry run sets XLA_FLAGS for 512 host devices when it is
# imported; with the backend already up that cannot reach this process,
# and the variable is put back for the subprocesses this suite starts.
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

#: the counter's FLOPs per device over the reference parser's on the
#: compiled reduced step: 1.028 measured (starcoder2-7b reduced, (2, 2, 2))
FLOPS_TOL = 0.05

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if shape_applicable(ARCHS[a], SHAPES[s])]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Intra-op threads: one.  These CPU tensors are small, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract_ref(name):
    cfg = REF_ARCHS[name]
    model = ref_transformer.build(cfg)
    with ref_common.abstract_init():
        tree = model.init(jax.random.PRNGKey(0))
    values, specs = ref_common.split_params(tree)
    return model, ref_common.as_sds(values), specs


@pytest.fixture(scope="module")
def refs():
    return {name: _abstract_ref(name) for name in ARCHS}


@pytest.fixture(scope="module")
def metas():
    return {name: transformer.build(ARCHS[name], device="meta", train=True)
            for name in ARCHS}


def _ref_layer_caches(cfg, caches):
    """The reference's stacked caches (each layer's ``{"mixer": state}``)
    as one (state, stacked) per layer of the port (unit layer ``u * P +
    p`` is unit ``u`` of position ``p``)."""
    P = len(cfg.pattern)
    out = []
    for i in range(cfg.units * P + len(cfg.tail)):
        if i < cfg.units * P:
            out.append((caches["units"][i % P]["mixer"], True))
        else:
            out.append((caches["tail"][i - cfg.units * P]["mixer"], False))
    return out


# ---- configs/shapes ----------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(refs, metas, arch, shape):
    cfg, spec = ARCHS[arch], SHAPES[shape]
    assert dataclasses.asdict(spec) == dataclasses.asdict(REF_SHAPES[shape])
    ref_model = refs[arch][0]
    got = input_specs(cfg, spec, model=metas[arch])
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape],
                           model=ref_model)
    assert set(got) == set(want)
    for k in got:
        if k == "caches":
            continue
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[1] == want[k].dtype.name, k
    if spec.kind != "decode":
        return
    pairs = _ref_layer_caches(cfg, want["caches"])
    assert len(pairs) == len(got["caches"])
    for c, (r, stacked) in zip(got["caches"], pairs):
        assert type(c).__name__ == type(r).__name__
        for field, t, w in zip(c._fields, c, r):
            shape_w = tuple(w.shape)[1:] if stacked else tuple(w.shape)
            if stacked:
                assert w.shape[0] == cfg.units
            assert tuple(t.shape) == shape_w, field
            assert str(t.dtype).split(".")[1] == w.dtype.name, field


def test_decode_specs_need_a_meta_model():
    cfg = ARCHS["gemma3-4b"].reduced()
    with pytest.raises(ValueError, match="meta"):
        input_specs(cfg, SHAPES["decode_32k"],
                    model=transformer.build(cfg, device="cpu"))


# ---- model FLOPs --------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_model_flops_equal_the_reference(refs, metas, arch):
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    _, ref_sds, _ = refs[arch]
    assert dryrun._param_counts(cfg, metas[arch]) == \
        ref_dryrun._param_counts(ref_cfg, ref_sds)
    for name, spec in SHAPES.items():
        assert dryrun.model_flops(cfg, spec, metas[arch]) == \
            ref_dryrun.model_flops(ref_cfg, REF_SHAPES[name], ref_sds)


# ---- the counter ----------------------------------------------------------------

def test_counter_on_the_scanned_matmul_is_exact():
    """``tests/test_roofline_parser.py``'s program: 10 steps of
    tanh(x @ w)."""
    def f(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    c = roofline.count(f, torch.empty(128, 256, device="meta"),
                       torch.empty(10, 256, 256, device="meta"))
    assert c.flops == 2 * 128 * 256 * 256 * 10 + 128 * 256 * 10


def test_counter_bytes_scale_with_the_trip_count():
    def make(n):
        def f(x, ws):
            for i in range(ws.shape[0]):
                x = x * ws[i]
            return x
        return roofline.count(f, torch.empty(1024, 1024, device="meta"),
                              torch.empty(n, 1024, 1024, device="meta"))

    b4, b8 = make(4).bytes, make(8).bytes
    assert 1.7 < b8 / b4 < 2.3
    assert b8 == 2 * b4            # no loop body is counted once


def test_counter_nested_loops_and_dtypes():
    def f(x, ws):
        for row in ws:
            for w in row:
                x = torch.sin(x) * w
        return x

    c = roofline.count(f, torch.empty(256, 256, device="meta"),
                       torch.empty(3, 5, 256, 256, device="meta"))
    assert c.flops == 2 * 256 * 256 * 15
    x16 = torch.empty(512, 512, dtype=torch.bfloat16, device="meta")
    c = roofline.count(lambda x: x + x, x16)
    assert c.bytes >= 2 * 512 * 512 * 2
    assert c.flops == 512 * 512


def test_analyze_divides_by_the_card():
    cell = roofline.analyze(arch="a", shape="s", mesh_name="m", chips=4,
                            flops=989e12, bytes_accessed=3.35e12,
                            collectives={"all-reduce": 900e9},
                            peak_bytes=7, model_flops=989e12)
    assert cell.t_compute == pytest.approx(1.0)
    assert cell.t_memory == pytest.approx(1.0)
    assert cell.t_collective == pytest.approx(2.0)
    assert cell.dominant == "collective"
    assert cell.useful_ratio == pytest.approx(0.25)
    assert set(cell.coll_breakdown) == set(roofline.COLLECTIVES)


# ---- shard shapes on the production meshes ------------------------------------

def _both(fn_got, fn_want):
    """(got, want) of two shard shapes; "refused" where one raises."""
    out = []
    for fn, err in ((fn_got, ValueError), (fn_want, ValueError)):
        try:
            out.append(tuple(fn()))
        except err:
            out.append("refused")
    return out


def test_shard_shapes_equal_jax_on_both_production_meshes(refs, metas):
    """Every leaf, input and cache of every full-width cell: the port's
    ``NamedSharding.shard_shape`` against JAX's on an ``AbstractMesh``
    (both abstract), and the cells each side refuses."""
    refused = {"port": set(), "jax": set()}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        amesh = jax.sharding.AbstractMesh(tuple(mesh.shape.values()),
                                          mesh.axis_names)
        for arch, shape_name in CELLS:
            cfg, spec = ARCHS[arch], SHAPES[shape_name]
            rules = dryrun._cell_rules(cfg, shape_name, multi)
            ref_rules_ = ref_rules.default_rules(
                multi, seq_parallel_cache=(shape_name == "long_500k"),
                expert_parallel=(cfg.moe is not None
                                 and cfg.moe.mode == "ep"),
                fsdp_over_pod=(cfg.param_dtype == "bfloat16"))
            ref_model, ref_sds, ref_specs = refs[arch]
            flat_sds = dict(jax.tree_util.tree_flatten_with_path(ref_sds)[0])
            flat_sds = {jax.tree_util.keystr(p, simple=True, separator="."):
                        v for p, v in flat_sds.items()}
            flat_specs = {
                jax.tree_util.keystr(p, simple=True, separator="."): s
                for p, s in jax.tree_util.tree_flatten_with_path(
                    ref_specs, is_leaf=lambda x: isinstance(
                        x, ref_common.LogicalAxes))[0]}
            params = dryrun.reference_params(metas[arch])
            assert set(params) == set(flat_sds)
            cell_refused = {"port": False, "jax": False}

            def check(got, want, what):
                assert got == want, (arch, shape_name, multi, what)
                if got == "refused":
                    cell_refused["port"] = True
                if want == "refused":
                    cell_refused["jax"] = True

            for leaf, (shp, dt, axes) in params.items():
                assert shp == tuple(flat_sds[leaf].shape)
                assert axes == flat_specs[leaf].names
                pspec = rules.pspec(axes)
                jspec = ref_rules_.pspec(axes)
                assert tuple(pspec) == tuple(jspec)
                check(*_both(
                    lambda: NamedSharding(mesh, pspec).shard_shape(shp,
                                                                   leaf),
                    lambda: jax.sharding.NamedSharding(amesh, jspec)
                    .shard_shape(shp)), leaf)
            batch_axes = tuple(a for a in mesh.axis_names if a != "model")
            bax = None if spec.global_batch == 1 else (
                batch_axes if len(batch_axes) > 1 else batch_axes[0])
            ins = input_specs(cfg, spec, model=metas[arch])
            ref_ins = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape_name],
                                      model=ref_model)
            for k, t in ins.items():
                if k == "caches":
                    continue
                ps = dryrun._batch_pspec(bax, t)
                check(*_both(
                    lambda: NamedSharding(mesh, ps).shard_shape(t.shape, k),
                    lambda: jax.sharding.NamedSharding(
                        amesh, jax.sharding.PartitionSpec(*ps))
                    .shard_shape(ref_ins[k].shape)), k)
            if spec.kind == "decode":
                long = shape_name == "long_500k"
                got_specs = dryrun.cache_pspecs(ins["caches"], cfg, mesh,
                                                long_context=long)
                want_specs = ref_dryrun.cache_pspecs(
                    ref_ins["caches"], REF_ARCHS[arch], amesh,
                    long_context=long)
                pairs = _ref_layer_caches(cfg, ref_ins["caches"])
                spec_pairs = _ref_layer_caches(cfg, want_specs)
                for c, cs, (r, stacked), (rs, _) in zip(
                        ins["caches"], got_specs, pairs, spec_pairs):
                    for field, t, ps, w, ws in zip(c._fields, c, cs, r, rs):
                        assert tuple(ps) == tuple(ws)[1:] if stacked \
                            else tuple(ps) == tuple(ws)
                        got, want = _both(
                            lambda: NamedSharding(mesh, ps).shard_shape(
                                t.shape, field),
                            lambda: jax.sharding.NamedSharding(amesh, ws)
                            .shard_shape(w.shape))
                        if stacked and want != "refused":
                            want = want[1:]
                        check(got, want, field)
            for side in refused:
                if cell_refused[side]:
                    refused[side].add((arch, shape_name, multi))
            if cell_refused["port"]:
                with pytest.raises(ValueError, match="does not divide"):
                    dryrun.cell_arguments(cfg, spec, mesh, rules,
                                          metas[arch])
    assert refused["port"] == refused["jax"]
    print(f"cells the reference's shardings refuse: "
          f"{sorted(refused['jax'])}")


# ---- counted against compiled -------------------------------------------------

_COMPILED_SCRIPT = r"""
import json, sys
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.analysis.roofline import parse_hlo_costs
from repro.checkpoint.reshard import shardings_from_specs
from repro.configs import ARCHS
from repro.core import compat
from repro.models import common, transformer
from repro.optim import AdamW
from repro.runtime import mesh_rules
from repro.runtime.trainer import make_train_step

arch, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
rules = mesh_rules.default_rules(multi_pod=True)
cfg = ARCHS[arch].reduced()
model = transformer.build(cfg)
with common.abstract_init():
    params_p = model.init(jax.random.PRNGKey(0))
params, specs = common.split_params(params_p)
params = common.as_sds(params)
param_sh = shardings_from_specs(mesh, rules, specs)
opt = AdamW(moment_dtype=cfg.moment_dtype)
opt_sds = opt.abstract_state(params)
opt_sh = type(opt_sds)(step=NamedSharding(mesh, P()), mu=param_sh,
                       nu=param_sh)
tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
batch = {"tokens": tokens, "labels": tokens}
batch_sh = {k: NamedSharding(mesh, P(("pod", "data"), None)) for k in batch}
step = make_train_step(model, opt, accum=1)
with mesh_rules.use_rules(rules):
    with mesh:
        compiled = jax.jit(
            step, in_shardings=(param_sh, opt_sh, None, batch_sh),
        ).lower(params, opt_sds, None, batch).compile()
costs = parse_hlo_costs(compiled.as_text())
print(json.dumps({
    "arg_bytes": compiled.memory_analysis().argument_size_in_bytes,
    "flops": costs["flops"], "bytes": costs["bytes"],
    "coll": {k: costs[k] for k in ("all-gather", "all-reduce",
                                   "reduce-scatter", "all-to-all",
                                   "collective-permute")}}))
"""


def test_counted_against_compiled():
    """A reduced config's train step on a (2, 2, 2) mesh
    (``tests/dist_scripts/dryrun_small.py``'s cell): argument bytes per
    device equal XLA's ``memory_analysis``; FLOPs per device within
    ``FLOPS_TOL`` of the reference parser's; collective bytes printed."""
    arch, B, S = "starcoder2-7b", 4, 32
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.path.join(root, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _COMPILED_SCRIPT, arch,
                           str(B), str(S)], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    xla = json.loads(proc.stdout.strip().splitlines()[-1])

    cfg = ARCHS[arch].reduced()
    model = transformer.build(cfg, device="meta", train=True)
    mesh = make_local_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="meta")
    rules = mesh_rules.default_rules(multi_pod=True)
    shape = ShapeSpec("reduced", S, B, "train")
    args = dryrun.cell_arguments(cfg, shape, mesh, rules, model)
    assert args["accum"] == 1 and args["batch_shards"] == 4
    assert sum(args["arg_bytes"].values()) == xla["arg_bytes"]
    shard_batch = B // args["batch_shards"]
    counter = dryrun.step_counts(cfg, shape, model, batch=shard_batch,
                                 accum=1)
    sharing = mesh.size // args["batch_shards"]
    flops = counter.flops / sharing
    coll = dryrun.collective_bytes(cfg, shape, mesh, args["params"],
                                   args["param_sh"], batch=shard_batch,
                                   accum=1)
    print(f"{arch} reduced, (2, 2, 2), B {B} S {S}: arg bytes "
          f"{xla['arg_bytes']}; flops/device port {flops} xla "
          f"{xla['flops']} (ratio {flops / xla['flops']}); bytes/device "
          f"port {counter.bytes / sharing} xla {xla['bytes']}; "
          f"collectives port {coll} xla {xla['coll']}")
    assert abs(flops / xla["flops"] - 1) < FLOPS_TOL


# ---- the dry run ---------------------------------------------------------------

def test_cells_write_their_records(tmp_path):
    r = dryrun.run_lm_cell("starcoder2-7b", "decode_32k", True,
                           str(tmp_path), verbose=False)
    assert r["mesh"] == "2x16x16" and r["chips"] == 512
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["arg_bytes"] == sum(r["arg_breakdown"].values())
    assert r["peak_bytes"] >= r["arg_bytes"] and r["fits_hbm"]
    saved = json.load(open(tmp_path /
                           "starcoder2-7b__decode_32k__2x16x16.json"))
    assert saved["flops_per_device"] == r["flops_per_device"] > 0
    skipped = dryrun.run_lm_cell("starcoder2-7b", "long_500k", False, None,
                                 verbose=False)
    assert skipped["skipped"]
    wl = dryrun.st3d_cfg.workloads(4)["3d_r4_pod"]
    s = dryrun.run_stencil_cell(wl, True, str(tmp_path), verbose=False)
    assert s["coll_breakdown"]["collective-permute"] > 0
    assert s["model_flops"] == wl.spec.flops_per_cell * wl.par_time \
        * int(np.prod(wl.grid_shape))


def test_main_lists_the_failing_cells(capsys, monkeypatch, tmp_path):
    dryrun.main(["--mesh", "single", "--cells", "gemma3-4b:long_500k",
                 "--out", str(tmp_path)])
    assert "all cells counted OK" in capsys.readouterr().out

    def uneven(*a, **k):
        raise ValueError("caches/0/k: dim 1 does not divide")
    monkeypatch.setattr(dryrun, "cell_arguments", uneven)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--mesh", "multi", "--cells", "gemma3-4b:decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "('gemma3-4b:decode_32k', True)" in capsys.readouterr().out

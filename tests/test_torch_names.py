"""Name parity: every public name of the JAX package exists in the port, or
stands in the table below with its reason.

Both trees are read by AST (nothing is imported, so no jax): for every
module of ``src/repro``, its ``__all__`` and its top-level public names
(functions, classes, assignments) against the module of the same path in
``src/repro_torch`` (whose imports count too), and each public member of a
class both modules define (methods, properties, class fields, and in the
port also the attributes its methods set on ``self``).  A name the port
lacks must be in :data:`NOT_TO_PORT` (TPU-only, JAX-only or retired) or in
:data:`NAMED_OTHERWISE` (with the port's names, which must exist); a
table entry that is no longer a gap fails too, so the table stays the
list of the differences that remain.  ``module:*`` is a whole module.
"""

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

#: names the port does not carry: TPU or JAX machinery with no counterpart
#: on the card, or a reading the port retired, each with the reason
NOT_TO_PORT = {
    "core/compat.py:*": "JAX API drift shims (make_mesh, shard_map, "
                        "tracing); the port calls torch directly",
    "core/blocking.py:LANE": "TPU lane width; the card coalesces 128-byte "
                             "rows (RP106)",
    "core/blocking.py:SUBLANE": "TPU sublane height; no counterpart on the "
                                "card",
    "core/codegen.py:Array": "the jnp array type alias; the port's arrays "
                             "are torch.Tensor",
    "core/program.py:Array": "the jnp array type alias",
    "core/reference.py:Array": "the jnp array type alias",
    "core/spec.py:Array": "the jnp array type alias",
    "kernels/common.py:MemorySpace": "Pallas memory spaces; the CUDA kernels "
                                     "place their own shared memory",
    "kernels/common.py:dma_semaphore": "Pallas DMA semaphores; the queued "
                                       "kernel waits on mbarriers",
    "kernels/common.py:vmem_scratch": "Pallas VMEM scratch; CTA shared "
                                      "memory is sized by the launchers",
    "kernels/common.py:default_interpret": "Pallas interpret mode; on the "
                                           "CPU the port runs each kernel's "
                                           "plain version",
    "tuning/space.py:fits_vmem": "the TPU's VMEM budget; the port filters "
                                 "by RP105's shared-memory fit",
    "tuning/space.py:is_aligned": "TPU lane/sublane alignment of a block",
    "tuning/space.py:halo_aligned": "TPU sublane alignment of a halo",
    "analysis/roofline.py:AliasPair": "HLO parser; the port counts a step "
                                      "with CostCounter",
    "analysis/roofline.py:entry_signature": "HLO parser",
    "analysis/roofline.py:parse_collectives": "HLO parser",
    "analysis/roofline.py:parse_hlo_costs": "HLO parser",
    "analysis/roofline.py:parse_input_output_aliases": "HLO parser",
    "analysis/roofline.py:xla_cost_analysis": "XLA's compiled cost "
                                              "analysis",
    "models/common.py:Param": "the JAX parameter-tree idiom; the port's "
                              "weights live in nn.Module (convert.py "
                              "carries a tree across)",
    "models/common.py:abstract_init": "JAX abstract init; the port builds "
                                      "on device='meta'",
    "models/common.py:as_sds": "jax.ShapeDtypeStruct trees; device='meta'",
    "models/common.py:const_param": "the JAX parameter-tree idiom",
    "models/common.py:ones_param": "the JAX parameter-tree idiom",
    "models/common.py:is_param": "the JAX parameter-tree idiom",
    "models/common.py:split_params": "the JAX parameter-tree idiom",
    "models/common.py:stack_param_trees": "the JAX parameter-tree idiom; "
                                          "the port stacks units in "
                                          "nn.Module",
    # class members
    "executor.py:CompiledStencil.xla_cost_analysis": "XLA's compiled cost "
                                                     "analysis",
    "optim/adamw.py:AdamW.abstract_state": "jax.ShapeDtypeStruct state; the "
                                           "port sizes state on "
                                           "device='meta'",
    "models/transformer.py:LMModel.init": "JAX init returning a params "
                                          "tree; the port's LMModel holds "
                                          "its weights (transformer.build)",
    "backends/registry.py:BackendTraits.interpret": "Pallas interpret mode",
    "core/blocking.py:BlockPlan.vmem_bytes": "the TPU's VMEM footprint of a "
                                             "block",
    "core/blocking.py:BlockPlan.vmem_bytes_for": "the TPU's VMEM footprint",
    "core/blocking.py:BlockPlan.useful_cells_per_block": "the TPU model's "
                                                         "work per block; "
                                                         "the port prices a "
                                                         "CTA tile "
                                                         "(blocking."
                                                         "launch_work)",
    "core/distributed.py:Decomposition.pspec": "a JAX PartitionSpec",
    "core/distributed.py:DistributedStencil.interpret": "Pallas interpret "
                                                        "mode",
    "core/distributed.py:DistributedStencil.sharding": "a JAX NamedSharding "
                                                       "of the global grid; "
                                                       "the port scatters "
                                                       "into one carry per "
                                                       "shard",
    "core/temporal.py:StencilEngine.interpret": "Pallas interpret mode",
    "tuning/space.py:Candidate.halo_aligned": "TPU sublane alignment",
    "launch/stencil_serve.py:ServeStats.mcell_steps_per_s":
        "cell-steps over compile plus dispatch seconds, not over a window: "
        "retired; a served rate is cell-steps over a timed window",
}

#: names the port spells otherwise: the port's names (``module:name``,
#: ``module:Class.member`` or ``module:*``) and the reason
NAMED_OTHERWISE = {
    "backends/pallas_backend.py:*": (
        ("backends/cuda_backend.py:*",),
        "the Pallas lowerings; the port's are cuda, cuda-pipelined and "
        "cuda-temporal"),
    "backends/xla_ref.py:*": (
        ("backends/torch_ref.py:torch_reference",),
        "the oracle lowering (xla-reference is torch-reference)"),
    "analysis/hw.py:TpuChip": (("analysis/hw.py:GpuChip",), "the card"),
    "analysis/hw.py:V5E": (("analysis/hw.py:H100_SXM",), "the card"),
    "tuning/__init__.py:default_bsizes": (
        ("core/blocking.py:candidate_blocks",),
        "the block shapes searched (TPU lane/sublane multiples there)"),
    "tuning/space.py:default_bsizes": (
        ("core/blocking.py:candidate_blocks",),
        "the block shapes searched"),
    "tuning/space.py:eq2_csize": (
        ("core/perf_model.py:csize",),
        "paper eq. 2; the port's space is in csize already"),
    "kernels/common.py:build_padded_superstep_kernel": (
        ("kernels/cuda.py:padded_superstep",),
        "B1: csrc/queued_superstep.cu or csrc/streamed_superstep.cu"),
    "kernels/common.py:build_temporal_kernel": (
        ("kernels/cuda.py:temporal_superstep",),
        "B3: csrc/streamed_superstep.cu"),
    "kernels/common.py:build_padded_pipelined_kernel": (
        ("kernels/cuda.py:padded_pipelined",),
        "B4: csrc/streamed_superstep.cu"),
    "kernels/common.py:build_superstep_kernel": (
        ("kernels/cuda.py:superstep",), "B5: both bodies, one-shot"),
    "kernels/common.py:build_pipelined_kernel": (
        ("kernels/cuda.py:pipelined_superstep",),
        "B6: both bodies, persistent CTAs"),
    "lint/__init__.py:analyze_artifact": (
        ("lint/artifact.py:analyze_launches", "lint/artifact.py:audit_run"),
        "the audit reads a run's recorded launches, not its HLO"),
    "lint/artifact.py:analyze_artifact": (
        ("lint/artifact.py:analyze_launches", "lint/artifact.py:audit_run"),
        "the audit reads a run's recorded launches, not its HLO"),
    "models/common.py:apply_rope": (
        ("models/common.py:rope_tables", "models/common.py:rotate"),
        "the tables once per step, the rotation per projection"),
    "models/common.py:rms_norm_headwise": (
        ("models/common.py:rms_norm",), "over the last axis of any rank"),
    "models/moe.py:AXES_EP": (("models/moe.py:axes",),
                              "each leaf's logical axes by mode"),
    "models/moe.py:AXES_TP": (("models/moe.py:axes",),
                              "each leaf's logical axes by mode"),
    "models/rwkv.py:MIX_NAMES": (
        ("models/rwkv.py:_mixed_inputs",),
        "the five token-shift mixes, in the order w, k, v, r, g"),
    # class members
    "backends/registry.py:BackendTraits.pipelined": (
        ("backends/registry.py:BackendTraits.variant",),
        "the deprecated bool mirror of variant"),
    "core/blocking.py:BlockPlan.useful_fraction": (
        ("core/blocking.py:PlanEstimate.useful_fraction",),
        "the CTA tile's useful share, which the H100 model prices"),
    "core/distributed.py:DistributedStencil.pipelined": (
        ("core/distributed.py:DistributedStencil.variant",),
        "the deprecated bool mirror of variant"),
    "core/distributed.py:DistributedStencil.superstep_fn": (
        ("core/distributed.py:DistributedStencil.superstep",),
        "one superstep of the mesh (no jit-able function to return)"),
    "core/temporal.py:StencilEngine.hw": (
        ("core/temporal.py:StencilEngine.chip",), "the card (a GpuChip)"),
    "tuning/space.py:Candidate.bsize": (
        ("core/blocking.py:BlockPlan.padded_shape",),
        "the TPU's padded window; each CUDA kernel picks its own CTA tile"),
}


def _modules(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(dirpath, n)
                out[os.path.relpath(path, root).replace(os.sep, "/")] = path
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node):
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _members(cls: ast.ClassDef, self_attrs: bool):
    names = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            if self_attrs:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) \
                            and isinstance(sub.value, ast.Name) \
                            and sub.value.id == "self" \
                            and isinstance(sub.ctx, ast.Store):
                        names.add(sub.attr)
        names.update(_targets(node))
    return names


def _read(path, port: bool):
    """(top-level names, ``__all__`` or None, {class: members})."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names, classes, all_ = set(), {}, None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            classes[node.name] = _members(node, self_attrs=port)
        for t in _targets(node):
            names.add(t)
            if t == "__all__":
                all_ = list(ast.literal_eval(node.value))
        if port and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names, all_, classes


def _gaps():
    ref, port = _modules(REF), _modules(PORT)
    gaps = set()
    for rel, path in sorted(ref.items()):
        if rel not in port:
            gaps.add(f"{rel}:*")
            continue
        rnames, rall, rclasses = _read(path, port=False)
        pnames, pall, pclasses = _read(port[rel], port=True)
        wanted = {n for n in rnames if _public(n)} | set(rall or ())
        gaps.update(f"{rel}:{n}" for n in wanted - pnames - set(pall or ()))
        if rall is not None:
            gaps.update(f"{rel}:{n}" for n in set(rall) - set(pall or ())
                        if f"{rel}:{n}" not in gaps)
        for cls, members in rclasses.items():
            if cls in pclasses:
                gaps.update(f"{rel}:{cls}.{m}" for m in members
                            if _public(m) and m not in pclasses[cls])
    return gaps


def _exists(target: str) -> bool:
    rel, name = target.split(":")
    path = os.path.join(PORT, rel)
    if not os.path.exists(path):
        return False
    if name == "*":
        return True
    names, _, classes = _read(path, port=True)
    if "." in name:
        cls, member = name.split(".")
        return member in classes.get(cls, ())
    return name in names


def test_every_name_of_the_reference_is_ported_or_tabled():
    gaps = _gaps()
    tabled = set(NOT_TO_PORT) | set(NAMED_OTHERWISE)
    assert not set(NOT_TO_PORT) & set(NAMED_OTHERWISE)
    untabled = sorted(gaps - tabled)
    assert not untabled, f"names the port lacks: {untabled}"
    stale = sorted(tabled - gaps)
    assert not stale, f"table entries that are no longer gaps: {stale}"


def test_every_name_otherwise_exists_in_the_port():
    for name, (targets, reason) in NAMED_OTHERWISE.items():
        assert reason and targets, name
        missing = [t for t in targets if not _exists(t)]
        assert not missing, f"{name}: {missing}"
    assert all(r.strip() for r in NOT_TO_PORT.values())


def test_the_new_names_are_ported():
    """The names this table once listed and the port now carries."""
    gaps = _gaps()
    for name in ("kernels/ref.py:numpy_program_nsteps",
                 "kernels/ref.py:program_nsteps_unrolled",
                 "core/reference.py:numpy_program_step",
                 "core/codegen.py:multi_step_interior",
                 "kernels/common.py:trace_count",
                 "kernels/common.py:reset_trace_counts",
                 "tuning/__init__.py:measure_candidates",
                 "tuning/measure.py:measure_candidates",
                 "analysis/hw.py:PaperDevice",
                 "analysis/hw.py:PAPER_DEVICES",
                 "analysis/hw.py:ARRIA10_DSPS",
                 "analysis/hw.py:ARRIA10_MEM_CTRL_MHZ",
                 "core/perf_model.py:PAPER_TABLE4_2D",
                 "core/perf_model.py:PAPER_TABLE5_3D",
                 "launch/dryrun.py:HBM_LIMIT",
                 "core/program.py:StencilProgram.coeffs_from_shells",
                 "core/program.py:ProgramCoeffs.astype",
                 "tuning/cache.py:PlanCache.get",
                 "tuning/cache.py:PlanCache.put",
                 "configs/stencil2d.py:StencilWorkload.compile"):
        assert name not in gaps, name
        assert _exists(name), name

"""The port's dry run (``launch/dryrun.py``), its dot accounting
(``launch/trace_analysis.py``), the model half of ``launch/costing.py``
and ``steps.tp_block_schedule`` against the JAX package's, on the CPU.

* the step's dot FLOPs of the train, prefill and decode bundles at a 1×1
  mesh, traced on ``meta`` tensors, against ``analyze_dots`` of the
  reference's compiled HLO (the same bundle lowered and compiled by
  XLA:CPU) for qwen1.5-0.5b, gemma3-1b and deepseek-v3 at smoke size,
  within 1 %;
* mamba2-2.7b and hymba-1.5b at full size against
  ``counting.model_flops``, since the reference's SSD scan lowers to a
  loop whose body ``analyze_dots`` counts once;
* ``_pattern_unit``, ``_with_depth``, ``_lin`` and the mode ``run_one``
  picks, equal to the reference's for every config;
* ``tp_block_schedule``'s ``program_digest`` and ``collective_counts()``
  equal to the reference's, and the collective accounting of ring
  programs under the reference's wire-byte conventions;
* dry-run records for a subset, on both production meshes.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.launch.costing as jcost
from repro.configs.base import ARCH_IDS
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jget
from repro.core import collectives as JC
from repro.core import effects as jeffects
from repro.launch.hlo_analysis import analyze_dots
from repro.launch.steps import build_bundle as jbuild_bundle
from repro.launch.steps import tp_block_schedule as jtp_block_schedule
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import collectives as C
from repro_torch.core import program_digest
from repro_torch.core.queue import STQueue
from repro_torch.launch import costing, dryrun, steps
from repro_torch.launch.trace_analysis import analyze_program_collectives
from repro_torch.models import counting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-1b", "deepseek-v3-671b"])
def test_step_dot_flops_equal_the_reference_hlo(arch, kind):
    jbundle = jbuild_bundle(jget(arch).smoke(), JShape("s", 64, 2, kind),
                            jax_make_mesh((1, 1), ("data", "model")))
    want = analyze_dots(jbundle.lower().compile().as_text())
    bundle = steps.build_bundle(get_config(arch).smoke(), ShapeConfig("s", 64, 2, kind),
                                make_mesh((1, 1), ("data", "model"), device="meta"))
    _, got, _ = bundle.trace()
    assert got.total_flops == pytest.approx(want.total_flops, rel=1e-2)
    assert got.largest[0][0] == pytest.approx(want.largest[0][0], rel=1e-2)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_step_dot_flops_against_model_flops(arch, shape_name):
    """Within 5 % of ``model_flops`` (6·N·D to train, 2·N·D to serve,
    with attention's S² term), its causal half counted whole, as the
    plain attention computes it; training without the recompute
    (``remat="none"``), which ``model_flops`` leaves out.  What remains:
    the SSD scan's own contractions (+1.5 % at mamba2), the embedding's
    gather, which ``model_flops`` counts as a product, the prefill's logits
    of the last position only (−3.3 %), and hymba's 128 meta tokens."""
    cfg = dataclasses.replace(get_config(arch), remat="none")
    shape = SHAPES[shape_name]
    bundle = steps.build_bundle(cfg, shape, make_mesh((1, 1), ("data", "model"),
                                                      device="meta"))
    _, dots, _ = bundle.trace()
    B, S = shape.global_batch, shape.seq_len
    want = counting.model_flops(cfg, shape)["model_flops"]
    if shape.kind != "decode":
        want += {"train": 3, "prefill": 1}[shape.kind] * \
            counting._attn_flops_quadratic(cfg, S, S, B)
    assert 0.95 < dots.total_flops / want < 1.05


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_costing_rules_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    unit = costing._pattern_unit(cfg)
    assert unit == jcost._pattern_unit(jcfg)
    for L in (2 * unit, 4 * unit):
        assert dataclasses.asdict(costing._with_depth(cfg, L)) == \
            dataclasses.asdict(jcost._with_depth(jcfg, L))
    c2, c4 = {"step_dot_flops": 3.0e12}, {"step_dot_flops": 7.5e12}
    assert costing._lin(c2, c4, 2, 4, cfg.n_layers, "step_dot_flops") == \
        jcost._lin(c2, c4, 2, 4, jcfg.n_layers, "step_dot_flops")
    # the reference's run_one: unrolled up to 28 layers (the encoder's
    # included) at d_model <= 4096, or up to 8; else calibrated at 2 and 4
    # pattern units
    eff_L = jcfg.n_layers + (jcfg.n_enc_layers if jcfg.enc_dec else 0)
    junit = jcost._pattern_unit(jcfg)
    want = ("unrolled" if (eff_L <= 28 and jcfg.d_model <= 4096) or eff_L <= 8
            else f"calibrated(L{2 * junit},L{4 * junit})")
    rec = costing.run_one(arch, "decode_32k", save=False)
    assert rec["status"] == "ok" and rec["mode"] == want
    assert rec["step_dot_flops"] > 0 and rec["collectives"].startswith("not derived")


@pytest.mark.parametrize("companion", [False, True])
def test_tp_block_schedule_equals_the_reference(companion):
    n = 4
    jmesh, mesh = AbstractMesh((n,), ("x",)), make_mesh((n,), ("x",), device="cpu")
    m, k, f = 8 * n * n, 4 * n, 4 * n
    jcomp = (JC.build_all_gather_matmul(jmesh, "x", 3 * n, 7, 5).program,) if companion else ()
    comp = (C.build_all_gather_matmul(mesh, "x", 3 * n, 7, 5).program,) if companion else ()
    jsched, _ = jtp_block_schedule(jmesh, "x", m, k, f, companions=jcomp, dtype=np.float32)
    sched, tp = steps.tp_block_schedule(mesh, "x", m, k, f, companions=comp)
    assert program_digest(sched) == jeffects.program_digest(jsched)
    assert sched.collective_counts() == jsched.collective_counts()
    assert (sched is tp.program) == (not companion)


def test_ring_collectives_follow_the_reference_wire_conventions():
    """A ring's hops are one-hop collective-permutes, and add up to the
    reference's convention for the collective the ring computes; a
    deferred all-reduce is priced as one."""
    n = 4
    mesh = make_mesh((n,), ("x",), device="cpu")
    ag = analyze_program_collectives(C.build_all_gather_matmul(mesh, "x", 3 * n, 7, 5).program)
    assert ag.count_by_kind == {"collective-permute": n - 1}
    assert ag.total_bytes == 3 * n * 7 * 4 * (n - 1) / n          # all-gather of x
    rs = analyze_program_collectives(
        C.build_matmul_reduce_scatter(mesh, "x", 3 * n, 4 * n, 5).program)
    assert rs.total_bytes == 3 * n * 5 * 4 * (n - 1) / n          # reduce-scatter of y
    q = STQueue(mesh, "allreduce")
    q.buffer("b", (8, 3), np.float32, pspec=("x",))
    q.buffer("o", (2, 3), np.float32, pspec=())
    q.enqueue_collective("all_reduce", "b", "o", "x")
    q.enqueue_start()
    q.enqueue_wait()
    ar = analyze_program_collectives(q.build())
    assert ar.as_dict() == {"bytes_by_kind": {"all-reduce": 2.0 * 2 * 3 * 4 * (n - 1) / n},
                            "count_by_kind": {"all-reduce": 1},
                            "total_bytes": 2.0 * 2 * 3 * 4 * (n - 1) / n}


def _reference_skips():
    """The reference's ``SKIPS``, read from its source: importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for the whole process."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "SKIPS":
            return ast.literal_eval(node.value)
    raise AssertionError("no SKIPS in the reference's dryrun.py")


@pytest.mark.parametrize("arch,shape_name", [("gemma3-1b", "decode_32k"),
                                             ("grok-1-314b", "long_500k"),
                                             ("deepseek-v3-671b", "long_500k"),
                                             ("whisper-large-v3", "prefill_32k")])
def test_dry_run_records_on_both_production_meshes(arch, shape_name):
    assert dryrun.SKIPS == _reference_skips()
    recs = [dryrun.run_one(arch, shape_name, mp, save=False) for mp in (False, True)]
    assert [r["mesh"] for r in recs] == ["pod16x16", "pod2x16x16"]
    if (arch, shape_name) in dryrun.SKIPS:
        assert all(r["status"] == "skipped" and r["reason"] == dryrun.SKIPS[(arch, shape_name)]
                   for r in recs)
        return
    assert [r["status"] for r in recs] == ["ok", "ok"], [r.get("error") for r in recs]
    assert [r["n_devices"] for r in recs] == [256, 512]
    for r in recs:
        assert r["step_dot_flops"] > 0 and r["collectives"] == dryrun.COLLECTIVES_NOT_DERIVED
        assert 0 < r["argument_bytes_per_device"] and 0 < r["output_bytes_per_device"]
    # the second pod halves what a device holds of the batch and caches
    assert recs[1]["argument_bytes_per_device"] <= recs[0]["argument_bytes_per_device"]

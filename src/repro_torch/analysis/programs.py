"""Registry of every ST program the shipped benchmarks build.

Port of ``repro.analysis.programs``: the same names, in the same order,
with the same structure — the Faces figure grids, the persistent
variant, the composed half-grid pipeline, the linked N-part solves, the
prefill+decode admission schedule
(:func:`repro_torch.launch.serve.build_admission_schedule`) and the ST
collective-matmul programs.  Build only, no execution.

One GPU holds every rank, so ``device_count`` is the number of ranks to
build with; it defaults to the benchmark grid, 8.  Below what a grid
needs, the grid scales down to ``(1, 1, 1)`` as in the reference, so
both packages can be compared at ``device_count=1``.  ``device`` is the
meshes' device (default: the card).
"""

from __future__ import annotations

import warnings
from typing import Iterator, List, Optional, Tuple

#: benchmark point counts / persistent iteration depth (faces_bench)
POINTS = (12, 12, 12)
INNER = 10
#: the benchmark grid's ranks
DEVICE_COUNT = 8


def _scale(grid: Tuple[int, int, int], device_count: int):
    need = grid[0] * grid[1] * grid[2]
    return grid if device_count >= need else (1, 1, 1)


def iter_programs(device_count: Optional[int] = None,
                  device=None) -> Iterator[Tuple[str, object]]:
    """Yield ``(name, program)`` for every benchmark-built ST program."""
    from repro_torch.core import (
        FacesConfig,
        STLintWarning,
        build_faces_part_program,
        build_faces_program,
        collectives,
        compose,
        half_config,
        part_names,
    )
    from repro_torch.launch.serve import build_admission_schedule
    from repro_torch.mesh import make_mesh, resolve_device

    if device_count is None:
        device_count = DEVICE_COUNT
    device = resolve_device(device, "iter_programs")
    mesh = lambda shape, axes: make_mesh(shape, axes, device=device)

    with warnings.catch_warnings():
        # builds run with verify="off"/suppressed warnings: lint_all and
        # the CLI collect diagnostics explicitly, so a dirty program is
        # REPORTED, not raised mid-registry
        warnings.simplefilter("ignore", STLintWarning)

        grid = _scale((8, 1, 1), device_count)
        mesh1d = mesh(grid, ("gx", "gy", "gz"))
        cfg1d = FacesConfig(grid=grid, points=POINTS)
        yield "faces_fig8_1d", build_faces_program(cfg1d, mesh1d)

        grid = _scale((2, 2, 2), device_count)
        mesh3d = mesh(grid, ("gx", "gy", "gz"))
        cfg3d = FacesConfig(grid=grid, points=POINTS)
        yield "faces_fig11_3d", build_faces_program(cfg3d, mesh3d)
        yield ("faces_fig_persistent",
               build_faces_program(cfg3d, mesh3d).persistent(INNER))

        cfgh = half_config(cfg3d)
        prog_a = build_faces_program(cfgh, mesh3d, name="facesA").persistent(INNER)
        prog_b = build_faces_program(cfgh, mesh3d, name="facesB").persistent(INNER)
        yield "faces_pipeline_halves", compose(prog_a, prog_b, verify="off")

        for n_parts in (2, 4):
            names = part_names(n_parts)
            progs = [build_faces_part_program(cfg3d, mesh3d, k, n_parts,
                                              names=names).persistent(INNER)
                     for k in range(n_parts)]
            yield f"faces_pipeline_linked_n{n_parts}", compose(*progs, verify="off")

        serve_mesh = mesh((device_count,), ("x",))
        yield "serve_admission", build_admission_schedule(serve_mesh, verify="off")

        # ST collective-matmul programs: ring size = the rank axis, at most 4
        n = min(device_count, 4)
        cmesh = mesh((n,), ("x",))
        m, k, f = 8 * n * n, 4 * n, 4 * n
        yield ("overlap_ag_matmul",
               collectives.build_all_gather_matmul(cmesh, "x", m, k, f,
                                                   verify="off").program)
        yield ("overlap_matmul_rs",
               collectives.build_matmul_reduce_scatter(cmesh, "x", m, k, f,
                                                       verify="off").program)
        yield ("overlap_a2a",
               collectives.build_all_to_all(cmesh, "x", m, k, verify="off").program)
        yield ("overlap_tp_chain",
               collectives.build_tp_block(cmesh, "x", m, k, f, chain=True,
                                          verify="off").program.persistent(INNER))


def lint_all(device_count: Optional[int] = None, device=None) -> List[Tuple[str, list]]:
    """Lint every registry program; return ``[(name, diagnostics)]``."""
    from repro_torch.core import verify_program

    return [(name, verify_program(prog))
            for name, prog in iter_programs(device_count, device)]


def certificates(device_count: Optional[int] = None, device=None) -> List[Tuple[str, object]]:
    """A :class:`~repro_torch.core.effects.ProgramCertificate` for every
    registry program: ``[(name, certificate)]``, the program's effect
    digest and its race-free verdict under the happens-before rules
    (ST015–ST018), i.e. race-free under ANY interleave policy."""
    from repro_torch.core.effects import program_certificate

    return [(name, program_certificate(prog))
            for name, prog in iter_programs(device_count, device)]

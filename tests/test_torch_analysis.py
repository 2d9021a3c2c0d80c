"""The port's program registry and CLI (``repro_torch.analysis``) against
the JAX package's ``repro.analysis``, on the CPU.

The registry yields the reference's names in the reference's order, with
equal ``program_digest`` and ``collective_counts()`` — at
``device_count=1`` in process, and at the benchmark grid's 8 ranks
against an 8-device JAX subprocess.  Every program lints clean, every
certificate is race-free, and ``python -m repro_torch.analysis
--strict`` exits 0.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.analysis import programs as jprograms
from repro.core import effects as jeffects
from repro_torch.analysis import certificates, iter_programs, lint_all
from repro_torch.core import program_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["faces_fig8_1d", "faces_fig11_3d", "faces_fig_persistent",
         "faces_pipeline_halves", "faces_pipeline_linked_n2",
         "faces_pipeline_linked_n4", "serve_admission", "overlap_ag_matmul",
         "overlap_matmul_rs", "overlap_a2a", "overlap_tp_chain"]


def _sigs(progs, digest):
    return [(name, digest(p), {str(k): list(v) for k, v in p.collective_counts().items()},
             p.n_iters)
            for name, p in progs]


def test_registry_equals_reference_at_one_rank():
    got = _sigs(iter_programs(1, device="cpu"), program_digest)
    want = _sigs(jprograms.iter_programs(1), jeffects.program_digest)
    assert [g[0] for g in got] == NAMES
    assert got == want


def test_registry_equals_reference_on_the_benchmark_grid(subproc):
    """Eight ranks: the port builds them on the CPU, the reference on
    eight JAX devices."""
    r = subproc("""
import json
from repro.analysis.programs import iter_programs
from repro.core.effects import program_digest
print(json.dumps([(n, program_digest(p),
                   {str(k): list(v) for k, v in p.collective_counts().items()},
                   p.n_iters) for n, p in iter_programs()]))
""", devices=8)
    assert r.returncode == 0, r.stderr
    want = [tuple(x) for x in json.loads(r.stdout.strip().splitlines()[-1])]
    got = _sigs(iter_programs(device="cpu"), program_digest)
    assert got == want


@pytest.mark.parametrize("device_count", [1, 8])
def test_lint_all_clean_and_certificates_race_free(device_count):
    results = lint_all(device_count, device="cpu")
    assert [n for n, _ in results] == NAMES
    dirty = {n: [str(d) for d in ds] for n, ds in results if ds}
    assert not dirty, dirty
    certs = certificates(device_count, device="cpu")
    assert [n for n, _ in certs] == NAMES
    assert not [n for n, c in certs if not c.race_free]
    assert all(c.digest == program_digest(p)
               for (_, c), (_, p) in zip(certs, iter_programs(device_count, device="cpu")))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_strict_exits_zero():
    r = _cli("--strict", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STLint: 11 program(s) clean" in r.stdout
    assert r.stdout.count("race-free") == 11
    assert "XLA_FLAGS" not in open(os.path.join(REPO, "src", "repro_torch", "analysis",
                                                "__main__.py")).read()
    r = _cli("overlap", "--device", "cpu", "--device-count", "1")
    assert r.returncode == 0 and "STLint: 4 program(s) clean" in r.stdout
    assert _cli("nothing_matches", "--device", "cpu").returncode == 2


def test_registry_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        assert next(iter_programs())[1].mesh.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter_programs())

"""The port's device-resident convergence loop against the JAX package's,
on the CPU (``device="cpu"``: the eager loop and the plain step).

Each case runs the same seeded ``u0`` through
``repro.core.run_faces_until_converged`` and the port's, and requires
equal ``n_done``, one dispatch and no sync point on both sides, and:

* the residual trace within ``rtol=1e-5`` of JAX's: the two packages
  add the squares in another order;
* every buffer (the field and the message slots) within
  ``rtol=atol=1e-5`` of JAX's, the repo's engine-vs-engine bound over a
  few stencil iterations (tests/test_torch_engines.py says why);
* the field within ``rtol=atol=1e-4`` of ``faces_oracle`` iterated
  ``n_done`` times, whose stencil sums in another order.

The (2,2,1) grid needs four JAX devices, so its reference runs in a
subprocess with four host devices.  The step kernel's plain version,
which the CPU loop runs, is checked on known traces.
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    PersistentEngine,
    build_faces_program,
    faces_oracle,
    global_residual_fn,
    run_faces_until_converged,
    to_numpy,
)
from repro_torch.core.halo import AXES3
from repro_torch.kernels import graph_loop

CFG = FacesConfig(grid=(1, 1, 1), points=(4, 3, 5), periodic=True, damping=0.08)
CFG_221 = FacesConfig(grid=(2, 2, 1), points=(4, 3, 5), damping=0.12)
_FIELDS = ("grid", "points", "dtype", "granularity", "batched", "periodic",
           "interior_compute", "damping")


def _u0(cfg, seed=0):
    return np.random.RandomState(seed).randn(*cfg.grid, *cfg.points).astype(np.float32)


def _oracle_n(u0, cfg, n):
    ref = u0
    for _ in range(n):
        ref = faces_oracle(ref, cfg)
    return ref


def _jax_in_process(cfg, u0, tol, max_iters, double_buffer):
    jcfg = jcore.FacesConfig(**{f: getattr(cfg, f) for f in _FIELDS})
    mem, res, n_done, stats = jcore.run_faces_until_converged(
        jcfg, jax_make_mesh(cfg.grid, AXES3), u0, tol=tol, max_iters=max_iters,
        double_buffer=double_buffer)
    return ({k: np.asarray(v) for k, v in mem.items()}, np.asarray(res), n_done,
            (stats.dispatches, stats.sync_points))


def _jax_in_subprocess(subproc, tmp_path, cfg, u0, tol, max_iters, double_buffer):
    np.save(tmp_path / "u0.npy", u0)
    out = tmp_path / "jax.npz"
    r = subproc(f"""
import numpy as np
from repro.core import FacesConfig, run_faces_until_converged
from repro.parallel import make_mesh
cfg = FacesConfig(**{ {f: getattr(cfg, f) for f in _FIELDS}!r})
mem, res, n_done, stats = run_faces_until_converged(
    cfg, make_mesh(cfg.grid, ("gx", "gy", "gz")), np.load({str(tmp_path / "u0.npy")!r}),
    tol={tol!r}, max_iters={max_iters!r}, double_buffer={double_buffer!r})
np.savez({str(out)!r}, n_done=n_done, res=np.asarray(res),
         stats=np.array([stats.dispatches, stats.sync_points]),
         **{{"mem_" + k: np.asarray(v) for k, v in mem.items()}})
""", devices=cfg.n_ranks)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    got = np.load(out)
    mem = {k[4:]: got[k] for k in got.files if k.startswith("mem_")}
    return mem, got["res"], int(got["n_done"]), tuple(got["stats"])


def _check_against_jax(cfg, u0, tol, max_iters, double_buffer=None, want=None):
    """Run the port; hold it against ``want`` (JAX's run, made in process
    unless given) and the oracle.  Returns the port's results."""
    if want is None:
        want = _jax_in_process(cfg, u0, tol, max_iters, double_buffer)
    jmem, jres, jn, jstats = want
    mem, res, n_done, stats = run_faces_until_converged(
        cfg, make_mesh(cfg.grid, AXES3, device="cpu"), u0, tol=tol,
        max_iters=max_iters, double_buffer=double_buffer)
    assert n_done == jn, f"tol={tol}: n_done {n_done} != JAX's {jn}"
    assert (stats.dispatches, stats.sync_points) == (1, 0) == jstats
    assert tuple(res.shape) == (n_done,)
    np.testing.assert_allclose(res.numpy(), jres, rtol=1e-5)
    got = to_numpy(mem)
    assert set(got) == set(jmem)
    for name in jmem:
        np.testing.assert_allclose(got[name], jmem[name], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} tol={tol} n_done={n_done}")
    np.testing.assert_allclose(got["u"], _oracle_n(u0, cfg, n_done), rtol=1e-4, atol=1e-4)
    return got, res.numpy(), n_done


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 1)])
def test_converges_in_one_dispatch_and_matches_jax(grid, subproc, tmp_path):
    """The tolerance is reached in ONE dispatch with no sync point, the
    loop stops exactly where the trace crosses it, and the port agrees
    with JAX and with the oracle at the realized count."""
    cfg, tol, max_iters = ((CFG, 1e-2, 50) if grid == (1, 1, 1) else (CFG_221, 1e-3, 40))
    u0 = _u0(cfg, seed=0)
    want = None
    if cfg.n_ranks > 1:
        want = _jax_in_subprocess(subproc, tmp_path, cfg, u0, tol, max_iters, None)
    _, res, n_done = _check_against_jax(cfg, u0, tol, max_iters, want=want)
    assert 1 <= n_done < max_iters
    assert res[-1] < tol and np.all(res[:-1] >= tol)


@pytest.mark.parametrize("tol", [2e-2, 1e-2, 5e-3, 2e-3])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_dynamic_last_parity_slot_selection(double_buffer, tol):
    """Tolerances whose realized counts are odd and even: with and without
    double buffering, every buffer (the slots too) agrees with JAX's,
    and the double-buffered run equals the single-buffered one bit for
    bit."""
    u0 = _u0(CFG, seed=4)
    got, res, n_done = _check_against_jax(CFG, u0, tol, 50, double_buffer=double_buffer)
    other, other_res, other_n = _check_against_jax(CFG, u0, tol, 50,
                                                   double_buffer=not double_buffer)
    assert other_n == n_done
    np.testing.assert_array_equal(other_res, res)
    for name in got:
        np.testing.assert_array_equal(other[name], got[name], err_msg=name)


def test_max_iters_bound_respected():
    """An unreachable tolerance stops at the bound."""
    _, res, n_done = _check_against_jax(CFG, _u0(CFG), 0.0, 7)
    assert n_done == 7 and res.shape == (7,)


def test_reduction_trace_matches_host_recomputation():
    """The loop's residual trace equals residuals recomputed on the host
    from oracle iterates."""
    u0 = _u0(CFG, seed=9)
    _, res, n_done = _check_against_jax(CFG, u0, 1e-2, 50)
    ref, want = u0, []
    for _ in range(n_done):
        ref = faces_oracle(ref, CFG)
        want.append(np.sqrt((ref.astype(np.float64) ** 2).mean()))
    np.testing.assert_allclose(res, want, rtol=1e-4)


def test_growing_residual_runs_to_bound_in_stream_mode():
    """Without damping the update grows, so ``residual >= tol`` never
    fails: the stream-mode loop stops at its bound, as JAX's does."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(3, 3, 3), periodic=True)
    u0 = _u0(cfg)
    jcfg = jcore.FacesConfig(**{f: getattr(cfg, f) for f in _FIELDS})
    jprog = jcore.build_faces_program(jcfg, jax_make_mesh((1, 1, 1), AXES3)).persistent(
        4, until=lambda r: r >= 1e-6)
    jeng = jcore.PersistentEngine(jprog, mode="stream",
                                  reduce_fn=jcore.global_residual_fn(jcfg))
    jmem, jres, jn = jeng(jeng.init_buffers({"u": u0}))
    prog = build_faces_program(cfg, make_mesh((1, 1, 1), AXES3, device="cpu")).persistent(
        4, until=lambda r: r >= 1e-6)
    eng = PersistentEngine(prog, mode="stream", reduce_fn=global_residual_fn(cfg))
    mem, res, n_done = eng(eng.init_buffers({"u": u0}))
    assert int(n_done) == int(jn) == 4
    assert eng.stats.dispatches == jeng.stats.dispatches == 1
    assert eng.stats.sync_points == 0
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-5)
    np.testing.assert_allclose(to_numpy(mem)["u"], np.asarray(jmem["u"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_numpy(mem)["u"], _oracle_n(u0, cfg, 4),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tol,max_iters", [(0.6, 32), (0.5, 32), (-1.0, 16), (-1.0, 7),
                                           (-1.0, 1), (2.0, 16)])
def test_plain_step_records_counts_and_stops(tol, max_iters):
    """The plain step on a known trace: it records every value, stops after
    the first one below ``tol`` or at ``max_iters``, the first always."""
    trace = torch.linspace(1.0, 0.0, 32)
    below = np.flatnonzero(trace.numpy() < tol)
    want = min(int(below[0]) + 1 if below.size else max_iters, max_iters)
    red, n_done = graph_loop.trace_plain(trace, tol, max_iters)
    assert int(n_done) == want and n_done.dtype == torch.int32
    assert torch.equal(red[:want], trace[:want])
    assert not red[want:].any()


def test_graph_loop_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA device"):
        graph_loop.GraphLoop(None, None, torch.zeros(()), torch.zeros((), dtype=torch.bool),
                             torch.zeros(4), torch.zeros((), dtype=torch.int32), 4)

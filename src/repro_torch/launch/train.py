"""End-to-end training entry point — port of ``repro.launch.train``.

Dispatch regimes (``inner_steps``), as the reference's:

* ``inner_steps=1``: one dispatch a step;
* ``inner_steps=N``: :func:`repro_torch.launch.steps.persistent_steps`
  folds N steps into ONE dispatch: the host stacks N batches (a leading
  step axis, indexed on the device), params and optimizer state stay on
  the device, and the stacked metrics bring every inner step's metrics
  back; the one host sync a dispatch reads the realised step count;
* ``plateau_eps``: with ``inner_steps > 1`` the device loop stops early
  once the loss plateaus (``|Δloss| <= eps``), with no host round trip a
  step.

On the card a dispatch is one CUDA-graph launch (captured at its first
call: set-up); on the CPU an eager loop.  Checkpoints hold ``{"params",
"opt_state"}`` in the reference's layout, so a resumed run keeps its
AdamW moments and its place in the schedule, and either package can
resume from the other's checkpoint.

Usage (the reference's flags; ``--device`` for ``--mesh``, which takes
``1x1`` only)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --smoke --device cpu --steps 5 --batch 2 --seq 32
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticTokens
from repro_torch.launch.steps import build_train_step, loss_plateau, persistent_steps
from repro_torch.mesh import Mesh, make_mesh
from repro_torch.models.nn import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init


def _restore_state(directory: str, step: int, params, opt_state):
    """Params AND optimizer state from a checkpoint, written into the live
    tensors (a graph captured over them stays valid).  A params-only
    checkpoint restores what it has, with a warning: the AdamW moments and
    the schedule then restart."""
    like = {"params": params, "opt_state": opt_state}
    try:
        restored = restore_pytree(directory, step, like)
    except KeyError:
        print(f"warning: checkpoint step_{step} predates optimizer-state "
              "checkpointing; resuming params only", flush=True)
        restored = {"params": restore_pytree(directory, step, params), "opt_state": opt_state}
    with torch.no_grad():
        for dst, src in zip(tree_leaves(like), tree_leaves(restored)):
            if dst is not src:
                dst.copy_(src)
    return params, opt_state


def train(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
          steps: int = 100, opt: Optional[AdamWConfig] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0,
          log_every: int = 10,
          seed: int = 0,
          inner_steps: int = 1,
          plateau_eps: Optional[float] = None,
          params=None):
    """Train ``steps`` steps; returns ``(params, opt_state, history)``.
    ``params``: initial parameters on ``mesh.device`` (a tree like
    ``Model.init``'s, e.g. the reference's carried over by
    ``models.convert.from_reference_params``); by default
    ``Model.init(seed)``.  They are updated in place."""
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if plateau_eps is not None and inner_steps < 2:
        raise ValueError(
            "plateau_eps needs inner_steps >= 2: a 1-step device loop is "
            "bounded before the plateau predicate can ever stop it")
    opt = opt or AdamWConfig(lr=1e-3)
    bundle = build_train_step(cfg, shape, mesh, opt=opt, total_steps=steps)
    model, device = bundle.model, mesh.device
    until = loss_plateau(plateau_eps) if plateau_eps is not None else None
    cache = {}

    def dispatch_for(k: int):
        if k not in cache:
            cache[k] = persistent_steps(bundle, k, until=until, stacked=True).step_fn
        return cache[k]

    if params is None:
        params = model.init(seed, device=device)
    opt_state = adamw_init(params, opt)
    start = 0
    if checkpoint_dir and (ck := latest_step(checkpoint_dir)) is not None:
        params, opt_state = _restore_state(checkpoint_dir, ck, params, opt_state)
        start = ck

    source = SyntheticTokens(cfg, shape, SyntheticConfig(seed=seed))
    history = []
    t0 = time.time()
    step = start
    while step < steps:
        k = min(inner_steps, steps - step)
        host = [source.batch(step + j) for j in range(k)]
        batch = {key: torch.from_numpy(np.stack([h[key] for h in host])).to(device)
                 for key in host[0]}
        params, opt_state, metrics = dispatch_for(k)(params, opt_state, batch)
        # the one host sync a dispatch: how far did the device get?
        done = int(metrics["steps_done"])
        trace = {key: v.cpu().numpy() for key, v in metrics.items() if key != "steps_done"}
        for j in range(done):
            gstep = step + j
            if gstep % log_every == 0 or gstep == steps - 1:
                m = {key: float(v[j]) for key, v in trace.items()}
                m["step"] = gstep
                m["wall_s"] = round(time.time() - t0, 2)
                history.append(m)
                print(f"step {gstep:5d} loss={m['loss']:.4f} "
                      f"ce={m.get('ce', 0):.4f} gnorm={m['grad_norm']:.3f} "
                      f"lr={m['lr']:.2e} t={m['wall_s']}s", flush=True)
        prev, step = step, step + done
        if (checkpoint_dir and checkpoint_every
                and step // checkpoint_every > prev // checkpoint_every):
            save_pytree(checkpoint_dir, step, {"params": params, "opt_state": opt_state})
        if done < k:
            print(f"loss plateaued after {step} steps "
                  f"(eps={plateau_eps:g}); stopping", flush=True)
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params, opt_state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="one card trains the model: only 1x1")
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' runs on the host)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--inner-steps", type=int, default=1,
                    help="train steps folded into one device dispatch")
    ap.add_argument("--plateau-eps", type=float, default=None,
                    help="stop a dispatch early when |dloss| <= eps "
                         "(device-resident; needs --inner-steps > 1)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port trains on one card (1x1)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = ShapeConfig("custom_train", args.seq, args.batch, "train")
    mesh = make_mesh((1, 1), ("data", "model"), device=args.device)
    train(cfg, shape, mesh, steps=args.steps, opt=AdamWConfig(lr=args.lr),
          checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
          inner_steps=args.inner_steps, plateau_eps=args.plateau_eps)


if __name__ == "__main__":
    main()

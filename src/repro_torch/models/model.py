"""Model facade — port of ``repro.models.model.Model`` for the dense
(gemma3, qwen1.5, glm4) and SSM (mamba2) paths.

``init``, ``forward_logits``, ``init_caches``, ``prefill``,
``decode_step``, ``cache_axes`` and ``select_slots`` give the
reference's outputs and cache tree: params ``{"embed": {"table"},
"decoder": {"segments": [...]}, "ln_final": {"scale"}, "unembed": {}}``
(``{"w"}`` for an untied head) and caches ``{"segments": [{"attn":
{"k", "v"}} or {"ssm": {"conv", "state"}}], "pos"}``.  The SSM caches
are new tensors out, as in the reference; the attention caches are
written in place and returned (the reference's functional update,
without copying the cache at every step).  ``select_slots`` merges a
prefilled cache into the admitted slots (continuous batching).
``loss`` is the train forward: the mean float32 cross-entropy of the
logits against ``batch["targets"]``, returned with ``{"ce", "loss"}``.
The frontends are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.mesh import resolve_device
from . import transformer as tfm
from .nn import (
    apply_embedding,
    apply_rmsnorm,
    apply_unembed,
    dtype_of,
    init_embedding,
    init_rmsnorm,
    init_unembed,
)


#: weights the forward casts to ``cfg.dtype`` at each use (``ssm.py``,
#: ``nn.py``)
_COMPUTE_DTYPE_WEIGHTS = ("in_proj", "out_proj", "table", "wq", "wk", "wv", "wo",
                          "bq", "bk", "bv", "wi", "wg")
#: subtrees whose every leaf the forward casts at each use: the untied head
_COMPUTE_DTYPE_SUBTREES = ("unembed",)


class Model:
    def __init__(self, cfg: ModelConfig):
        segs = tfm.plan_segments(cfg)  # raises for what is not ported
        if cfg.frontend != "none" or cfg.n_meta_tokens or cfg.pos_embedding != "rope":
            raise NotImplementedError(f"{cfg.name}: frontends, meta tokens and "
                                      f"non-rope positions are not ported yet")
        if segs[0].kind == "ssm" and not cfg.use_ssd_kernel:
            raise NotImplementedError(f"{cfg.name}: use_ssd_kernel=False (the plain "
                                      f"SSD forward) is not ported; the port's scan "
                                      f"always takes the kernel wrapper")
        self.cfg = cfg
        self._attention = any(s.kind == "attn_mlp" for s in segs)

    # -- params ---------------------------------------------------------------

    def init(self, seed: int = 0, *, device=None) -> Dict[str, Any]:
        """Random parameters from ``torch.Generator(seed)`` with the
        reference's distributions (not its numbers: carry the reference's
        own with :func:`repro_torch.models.convert.from_reference_params`).
        ``device=None`` means the current CUDA device; ``"meta"`` gives
        shapes without memory."""
        cfg = self.cfg
        device = resolve_device(device, "Model.init")
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return {
            "embed": init_embedding(gen, cfg, device=device),
            "decoder": tfm.init_stack(gen, cfg, device=device),
            "ln_final": init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype),
                                     device=device),
            "unembed": init_unembed(gen, cfg, device=device),  # {} when tied
        }

    def abstract_init(self) -> Dict[str, Any]:
        """Parameters on the ``meta`` device: shapes and dtypes, no memory."""
        return self.init(device="meta")

    def compute_params(self, params) -> Dict[str, Any]:
        """``params`` with the weights the forward casts to ``cfg.dtype``
        at every use (the projections, the embedding table and an untied
        head) cast once, as XLA hoists the reference's casts; the other
        leaves are the same tensors.  The values the forward sees are
        unchanged."""
        dt = dtype_of(self.cfg.dtype)

        def cast(tree, whole=False):
            if isinstance(tree, dict):
                return {k: (v.to(dt) if k in _COMPUTE_DTYPE_WEIGHTS and not whole
                            else cast(v, whole or k in _COMPUTE_DTYPE_SUBTREES))
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v, whole) for v in tree]
            return tree.to(dt) if whole else tree

        return cast(params)

    # -- forward ----------------------------------------------------------------

    def forward_logits(self, params, batch) -> torch.Tensor:
        """Full-sequence logits (no cache): every layer's scan takes the
        SSD kernel, as the reference's ``cache is None`` path does, and
        every attention layer the flash kernel."""
        cfg = self.cfg
        x = apply_embedding(params["embed"], batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = tfm.apply_stack(params["decoder"], x, cfg, positions=positions)
        h = apply_rmsnorm(params["ln_final"], x, cfg)
        return apply_unembed(params["embed"], params["unembed"], h, cfg)

    # -- train forward --------------------------------------------------------------

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, {"ce", "loss"})`` of ``batch = {"tokens", "targets"}``
        (``[B,S]`` int): the embedding, the layer stack (each layer
        checkpointed when autograd records and ``cfg.remat == "block"``),
        the final norm, the unembedding and :func:`_ce`, as the reference's
        ``Model.loss`` for the ported families.  The MoE balance loss and
        the multi-token-prediction head are not ported."""
        cfg = self.cfg
        if cfg.n_experts or cfg.mtp_depth:
            raise NotImplementedError(
                f"{cfg.name}: the MoE load-balance loss and the MTP head are not ported "
                f"yet (ROADMAP.md, the MoE family)")
        tokens, targets = batch["tokens"], batch["targets"]
        x = apply_embedding(params["embed"], tokens, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = tfm.apply_stack(params["decoder"], x, cfg, positions=positions)
        h = apply_rmsnorm(params["ln_final"], x, cfg)
        logits = apply_unembed(params["embed"], params["unembed"], h, cfg)
        loss = _ce(logits, targets)
        return loss, {"ce": loss, "loss": loss}

    # -- serving ------------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int, per_sequence: bool = False, *,
                    device=None) -> Dict[str, Any]:
        """Zeroed decode caches; ``per_sequence=True`` makes ``pos`` a
        [batch] vector (every slot at its own depth).  Attention caches
        hold ``max_len`` entries; an SSM cache does not grow with it."""
        device = resolve_device(device, "Model.init_caches")
        pos_shape = (batch,) if per_sequence else ()
        return {"segments": tfm.init_caches(self.cfg, batch, max_len, device=device),
                "pos": torch.zeros(pos_shape, dtype=torch.int32, device=device)}

    def cache_axes(self, per_sequence: bool = False) -> Dict[str, Any]:
        """The cache tree's logical axes, leaf for leaf: where ``batch``
        (the slot axis) sits in each."""
        return {"segments": tfm.cache_logical_axes(self.cfg),
                "pos": ("batch",) if per_sequence else ()}

    def select_slots(self, mask: torch.Tensor, new_caches, old_caches, *,
                     in_place: bool = False) -> Dict[str, Any]:
        """Per-slot cache merge: slot ``b`` takes ``new_caches`` where
        ``mask[b]`` and keeps ``old_caches`` elsewhere (K/V, the SSM
        ``conv`` and ``state``, ``pos``).  Each leaf's slot axis is looked
        up in :meth:`cache_axes`, as the reference does, and the mask
        broadcast along it; new tensors out, or with ``in_place`` the
        merge written into ``old_caches``' leaves (which are returned),
        as into a donated buffer."""
        axes = self.cache_axes(per_sequence=old_caches["pos"].dim() == 1)

        def sel(ax, n, o):
            shape = [1] * n.dim()
            shape[ax.index("batch")] = mask.shape[0]
            return torch.where(mask.reshape(shape), n, o, out=o if in_place else None)

        return _map_axes(sel, axes, new_caches, old_caches)

    def prefill_depth(self, caches) -> Optional[int]:
        """The depth every slot's cache sits at, read on the host (a device
        sync), for a model with attention layers (the flash kernel's
        ``q_offset`` is a host int); None without them.  A prefill into
        slots at differing depths (a per-row ``q_offset``) is not ported:
        ``NotImplementedError``.  Continuous batching never needs one: its
        admission prefills into a zeroed view, every slot at depth 0."""
        return _common_depth(caches["pos"]) if self._attention else None

    def prefill(self, params, batch, caches, *, serve_window: int = 0,
                depth: Optional[int] = None):
        """Write the prompt into the caches; returns (last_logits, caches).

        ``depth``: :meth:`prefill_depth` of ``caches``, read by the caller
        before a CUDA-graph capture (where a host sync is illegal); None
        reads it here."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if depth is None:
            depth = self.prefill_depth(caches)
        x = apply_embedding(params["embed"], tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=x.device) + (depth or 0)
        x, new_segs = tfm.apply_stack(params["decoder"], x, cfg, positions=positions,
                                      caches=caches["segments"], cache_pos=caches["pos"],
                                      depth=depth, serve_window=serve_window)
        h = apply_rmsnorm(params["ln_final"], x, cfg)
        logits = apply_unembed(params["embed"], params["unembed"], h[:, -1:], cfg)[:, 0]
        return logits, {"segments": _merge_caches(caches["segments"], new_segs),
                        "pos": caches["pos"] + tokens.shape[1]}

    def decode_step(self, params, caches, token, *, serve_window: int = 0):
        """One-token decode against the cache.  token: [B] int32;
        ``caches["pos"]`` is a scalar or a [B] vector."""
        cfg = self.cfg
        pos = caches["pos"]
        x = apply_embedding(params["embed"], token[:, None], cfg)
        positions = pos[None] if pos.dim() == 0 else pos[:, None]
        x, new_segs = tfm.apply_stack(params["decoder"], x, cfg, positions=positions,
                                      caches=caches["segments"], cache_pos=pos,
                                      serve_window=serve_window)
        h = apply_rmsnorm(params["ln_final"], x, cfg)
        logits = apply_unembed(params["embed"], params["unembed"], h, cfg)[:, 0]
        out = dict(caches)
        out["segments"] = _merge_caches(caches["segments"], new_segs)
        out["pos"] = caches["pos"] + 1
        return logits, out


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32: ``logsumexp(logits) - logits[target]``
    (the reference's ``_ce``)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _common_depth(pos: torch.Tensor) -> int:
    """The one depth of every slot, as a host int (a device sync)."""
    values = pos.reshape(-1).tolist()
    if not values or any(v != values[0] for v in values):
        raise NotImplementedError(
            f"prefill into slots at differing depths {values} (a per-row q_offset) "
            f"is not ported (ROADMAP.md); continuous batching admits into a zeroed "
            f"view at depth 0")
    return int(values[0])


def _map_axes(fn, axes, *trees):
    """``fn(axes_leaf, *leaves)`` over trees shaped like ``axes``, whose
    leaves are tuples of axis names."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, a, *(t[k] for t in trees)) for k, a in axes.items()}
    if isinstance(axes, list):
        return [_map_axes(fn, a, *(t[i] for t in trees)) for i, a in enumerate(axes)]
    return fn(axes, *trees)


def _merge_caches(old_segs: List, new_segs: List) -> List:
    out = []
    for o, n in zip(old_segs, new_segs):
        merged = dict(o)
        merged.update(n or {})
        out.append(merged)
    return out

"""Model facade — port of ``repro.models.model.Model`` for the dense
(gemma3, qwen1.5, glm4), MoE (deepseek-v3 with MLA and the MTP head,
grok-1), SSM (mamba2), hybrid (hymba), encoder-decoder (whisper) and
vision-language (internvl2) families.

``init``, ``forward_logits``, ``loss``, ``init_caches``, ``prefill``,
``decode_step``, ``cache_axes`` and ``select_slots`` give the
reference's outputs and cache tree: params ``{"embed": {"table"},
"decoder": {"segments": [...]}, "ln_final": {"scale"}, "unembed": {}}``
(``{"w"}`` for an untied head), with ``"encoder"`` and ``"ln_enc"`` for
an encoder-decoder, ``"frontend"`` for a modality frontend and
``"meta"`` for meta tokens and ``"mtp"`` (``{"proj", "block", "ln"}``)
for the multi-token-prediction head; caches ``{"segments": [{"attn":
{"k", "v"}} (``{"c_kv", "k_rope"}`` with MLA) and/or {"ssm": {"conv",
"state"}}], "pos"}``, with ``"enc_out"`` (the
encoder output the decode steps attend to) for an encoder-decoder.  The
decoder's sequence is the meta tokens, then the vision prefix, then the
tokens (:meth:`Model._embed_tokens`); positions and ``pos`` count the
prefix, and the logits of ``forward_logits`` and ``loss`` leave it out.
The SSM caches are new tensors out, as in the reference; the attention
caches are written in place and returned (the reference's functional
update, without copying the cache at every step).  ``select_slots``
merges a prefilled cache into the admitted slots (continuous batching).
``loss`` is the train forward: the mean float32 cross-entropy of the
logits against ``batch["targets"]``, plus the MoE balance loss and the
MTP head's loss where the config has them, returned with ``{"ce",
"loss"}`` (and ``"lb_loss"``, ``"mtp_loss"``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.mesh import resolve_device
from . import transformer as tfm
from .frontends import apply_frontend, init_frontend, sinusoidal_positions, timescales
from .nn import (
    apply_embedding,
    apply_rmsnorm,
    apply_unembed,
    dtype_of,
    init_embedding,
    init_rmsnorm,
    init_unembed,
    param,
    tree_map,
)


#: weights the forward casts to ``cfg.dtype`` at each use (``ssm.py``,
#: ``nn.py``)
_COMPUTE_DTYPE_WEIGHTS = ("in_proj", "out_proj", "table", "wq", "wk", "wv", "wo",
                          "bq", "bk", "bv", "wi", "wg", "meta", "proj_in", "proj_out",
                          "wq_a", "wq_b", "wkv_a", "wkv_b", "shared_wi", "shared_wg",
                          "shared_wo", "proj")
#: subtrees whose every leaf the forward casts at each use: the untied head
_COMPUTE_DTYPE_SUBTREES = ("unembed",)


class Model:
    def __init__(self, cfg: ModelConfig):
        segs = tfm.plan_segments(cfg)  # raises for what is not ported
        self.cfg = cfg
        self._attention = any(s.kind in tfm.ATTENTION_KINDS for s in segs)

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
        pdt = dtype_of(cfg.param_dtype)
        params = {
            "embed": init_embedding(gen, cfg, device=device),
            "decoder": tfm.init_stack(gen, cfg, device=device),
            "ln_final": init_rmsnorm(cfg.d_model, pdt, device=device),
            "unembed": init_unembed(gen, cfg, device=device),  # {} when tied
        }
        if cfg.enc_dec:
            params["encoder"] = tfm.init_stack(gen, cfg, device=device, decoder=False)
            params["ln_enc"] = init_rmsnorm(cfg.d_model, pdt, device=device)
        if cfg.frontend != "none":
            params["frontend"] = init_frontend(gen, cfg, device=device)
        if cfg.n_meta_tokens:
            params["meta"] = param(gen, (cfg.n_meta_tokens, cfg.d_model), (None, "embed"), pdt,
                                   device=device)
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": param(gen, (2 * cfg.d_model, cfg.d_model), ("embed", "embed"), pdt,
                              device=device),
                "block": tfm.init_block(gen, cfg, "attn_mlp", device=device),
                "ln": init_rmsnorm(cfg.d_model, pdt, device=device),
            }
        return params

    def abstract_init(self) -> Dict[str, Any]:
        """Parameters on the ``meta`` device: shapes and dtypes, no memory."""
        return self.init(device="meta")

    def param_axes(self) -> Dict[str, Any]:
        """The parameters' logical axes, leaf for leaf: a tuple of axis
        names (or None) for each leaf of :meth:`abstract_init`, the
        reference's ``abstract_init()[1]``."""
        return tree_map(lambda t: t.logical_axes, self.abstract_init())

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins for every model input of a step of ``shape``:
        ``tokens`` (and ``targets`` to train) ``[B, S]`` int32 with the
        config's embeddings, or a decode step's ``token`` ``[B]``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = lambda size, dt=torch.int32: torch.empty(size, dtype=dt, device="meta")
        if shape.kind not in ("train", "prefill"):
            return {"token": meta((B,))}
        specs = {"tokens": meta((B, S))}
        if shape.kind == "train":
            specs["targets"] = meta((B, S))
        embeds = (B, cfg.frontend_tokens, cfg.frontend_dim)
        if cfg.enc_dec:
            specs["audio_embeds"] = meta(embeds, dtype_of(cfg.dtype))
        if cfg.frontend == "vision":
            specs["vision_embeds"] = meta(embeds, dtype_of(cfg.dtype))
        return specs

    def compute_params(self, params) -> Dict[str, Any]:
        """``params`` with the weights the forward casts to ``cfg.dtype``
        at every use (the projections, the embedding table, an untied
        head, the meta tokens and the frontend's projectors) cast once, as
        XLA hoists the reference's casts; the other leaves (the norms,
        the SSM's float32 leaves, hymba's ``mix``) are the same tensors.
        The values the forward sees are unchanged."""
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

    # -- the encoder and the decoder's sequence ------------------------------------

    def _encode(self, params, audio_embeds: torch.Tensor) -> torch.Tensor:
        """whisper's encoder: the audio projector, sinusoidal positions,
        the encoder's layers (not causal) and its final norm."""
        cfg = self.cfg
        x = apply_frontend(params["frontend"], audio_embeds, cfg)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, device=x.device)[None]
        x, _ = tfm.apply_stack(params["encoder"], x, cfg, decoder=False, causal=False)
        return apply_rmsnorm(params["ln_enc"], x, cfg)

    def _embed_tokens(self, params, tokens, *, prefix_embeds=None) -> torch.Tensor:
        """The decoder's input: the meta tokens, then ``prefix_embeds``
        (the vision prefix), then the tokens' embeddings, with sinusoidal
        positions added where the config has them."""
        cfg = self.cfg
        x = apply_embedding(params["embed"], tokens, cfg)
        parts = []
        if cfg.n_meta_tokens:
            parts.append(params["meta"].to(x.dtype)[None].expand(
                x.shape[0], cfg.n_meta_tokens, cfg.d_model))
        if prefix_embeds is not None:
            parts.append(prefix_embeds.to(x.dtype))
        if parts:
            x = torch.cat(parts + [x], dim=1)
        if cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                         device=x.device)[None]
        return x

    def _prefix_len(self) -> int:
        """Rows the decoder's sequence holds before the tokens: the meta
        tokens and the vision patches."""
        cfg = self.cfg
        return cfg.n_meta_tokens + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)

    def _decoder_input(self, params, batch):
        """(the decoder's input, the encoder output or None) of ``batch``:
        ``tokens``, with ``audio_embeds`` (encoder-decoder) or
        ``vision_embeds`` (vision) where the config takes them."""
        cfg = self.cfg
        enc_out = self._encode(params, batch["audio_embeds"]) if cfg.enc_dec else None
        prefix = (apply_frontend(params["frontend"], batch["vision_embeds"], cfg)
                  if cfg.frontend == "vision" else None)
        return self._embed_tokens(params, batch["tokens"], prefix_embeds=prefix), enc_out

    # -- forward ----------------------------------------------------------------

    def hidden_states(self, params, batch, *, aux=None) -> torch.Tensor:
        """The final norm's output over the whole sequence (no cache; the
        prefix rows kept): the decoder's input and the layer stack, each
        layer checkpointed when autograd records and ``cfg.remat ==
        "block"``.  ``aux``: a dict that receives the MoE layers' summed
        ``lb_loss``."""
        cfg = self.cfg
        x, enc_out = self._decoder_input(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = tfm.apply_stack(params["decoder"], x, cfg, positions=positions,
                               enc_out=enc_out, aux=aux)
        return apply_rmsnorm(params["ln_final"], x, cfg)

    def forward_logits(self, params, batch) -> torch.Tensor:
        """Full-sequence logits of the tokens (no cache; the prefix rows
        left out): every SSD scan takes the kernel wrapper, every
        attention layer the flash kernel."""
        h = self.hidden_states(params, batch)
        return apply_unembed(params["embed"], params["unembed"], h[:, self._prefix_len():],
                             self.cfg)

    # -- train forward --------------------------------------------------------------

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, metrics)`` of ``batch = {"tokens", "targets"}`` (``[B,S]``
        int, with the config's embeddings), as the reference's
        ``Model.loss``: the decoder's input, the layer stack (each layer
        checkpointed when autograd records and ``cfg.remat == "block"``),
        the final norm, the unembedding of the token rows and :func:`_ce`
        (``"ce"``); with MoE layers ``+ 0.01 lb_loss / n_layers`` (their
        summed balance loss, ``"lb_loss"``), with an MTP head ``+ 0.3
        mtp_loss`` (:meth:`_mtp_loss`, ``"mtp_loss"``); ``"loss"`` the
        total."""
        cfg = self.cfg
        aux: Dict[str, torch.Tensor] = {}
        h = self.hidden_states(params, batch, aux=aux)
        P = self._prefix_len()
        h_text = h[:, P:]
        logits = apply_unembed(params["embed"], params["unembed"], h_text, cfg)
        loss = _ce(logits, batch["targets"])
        metrics = {"ce": loss}
        if "lb_loss" in aux:
            metrics["lb_loss"] = aux["lb_loss"]
            loss = loss + 0.01 * aux["lb_loss"] / max(cfg.n_layers, 1)
        if cfg.mtp_depth:
            positions = torch.arange(P, h.shape[1], device=h.device)
            mtp_loss = self._mtp_loss(params, h_text, batch["targets"], positions)
            metrics["mtp_loss"] = mtp_loss
            loss = loss + 0.3 * mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, params, h: torch.Tensor, targets: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """DeepSeek's depth-1 multi-token prediction (the reference's
        ``_mtp_loss``): token ``t + 2`` predicted from ``[h_t ;
        emb(target_t)]`` through ``proj``, one dense block and a norm."""
        cfg = self.cfg
        p = params["mtp"]
        emb_next = apply_embedding(params["embed"], targets, cfg)
        hcat = torch.cat([h, emb_next.to(h.dtype)], dim=-1)
        hm = hcat @ p["proj"].to(h.dtype)
        hm, _ = tfm.apply_block(p["block"], hm, cfg, "attn_mlp", positions=positions)
        hm = apply_rmsnorm(p["ln"], hm, cfg)
        logits = apply_unembed(params["embed"], params["unembed"], hm[:, :-1], cfg)
        # the target at depth 1 is token t + 2: the targets shifted by one
        return _ce(logits, targets[:, 1:])

    # -- serving ------------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int, per_sequence: bool = False, *,
                    device=None) -> Dict[str, Any]:
        """Zeroed decode caches; ``per_sequence=True`` makes ``pos`` a
        [batch] vector (every slot at its own depth).  Attention caches
        hold ``max_len`` entries; an SSM cache does not grow with it.  An
        encoder-decoder's also hold ``enc_out`` ``[batch, frontend_tokens,
        d_model]`` in ``cfg.dtype``."""
        cfg = self.cfg
        device = resolve_device(device, "Model.init_caches")
        pos_shape = (batch,) if per_sequence else ()
        out = {"segments": tfm.init_caches(cfg, batch, max_len, device=device),
               "pos": torch.zeros(pos_shape, dtype=torch.int32, device=device)}
        if cfg.enc_dec:
            out["enc_out"] = torch.zeros((batch, cfg.frontend_tokens, cfg.d_model),
                                         dtype=dtype_of(cfg.dtype), device=device)
        return out

    def cache_axes(self, per_sequence: bool = False) -> Dict[str, Any]:
        """The cache tree's logical axes, leaf for leaf: where ``batch``
        (the slot axis) sits in each."""
        out = {"segments": tfm.cache_logical_axes(self.cfg),
               "pos": ("batch",) if per_sequence else ()}
        if self.cfg.enc_dec:
            out["enc_out"] = ("batch", None, "act_embed")
        return out

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

        return map_axes(sel, axes, new_caches, old_caches)

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
        """Write the prompt (and the prefix before it) into the caches;
        returns (last_logits, caches).

        ``depth``: :meth:`prefill_depth` of ``caches``, read by the caller
        before a CUDA-graph capture (where a host sync is illegal); None
        reads it here.  Positions and the new ``pos`` count the whole
        sequence, prefix included."""
        cfg = self.cfg
        if depth is None:
            depth = self.prefill_depth(caches)
        x, enc_out = self._decoder_input(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device) + (depth or 0)
        x, new_segs = tfm.apply_stack(params["decoder"], x, cfg, positions=positions,
                                      caches=caches["segments"], cache_pos=caches["pos"],
                                      depth=depth, serve_window=serve_window,
                                      enc_out=enc_out)
        h = apply_rmsnorm(params["ln_final"], x, cfg)
        logits = apply_unembed(params["embed"], params["unembed"], h[:, -1:], cfg)[:, 0]
        out = {"segments": _merge_caches(caches["segments"], new_segs),
               "pos": caches["pos"] + S}
        if cfg.enc_dec:
            out["enc_out"] = enc_out
        return logits, out

    def decode_step(self, params, caches, token, *, serve_window: int = 0):
        """One-token decode against the cache.  token: [B] int32;
        ``caches["pos"]`` is a scalar or a [B] vector."""
        cfg = self.cfg
        pos = caches["pos"]
        x = apply_embedding(params["embed"], token[:, None], cfg)
        if cfg.pos_embedding == "sinusoidal":
            # the sinusoidal embedding at the cache position(s)
            s = _sinusoid_at(pos, cfg.d_model, x.dtype)
            x = x + (s[None, None] if s.dim() == 1 else s[:, None])
        positions = pos[None] if pos.dim() == 0 else pos[:, None]
        x, new_segs = tfm.apply_stack(params["decoder"], x, cfg, positions=positions,
                                      caches=caches["segments"], cache_pos=pos,
                                      serve_window=serve_window,
                                      enc_out=caches.get("enc_out"))
        h = apply_rmsnorm(params["ln_final"], x, cfg)
        logits = apply_unembed(params["embed"], params["unembed"], h, cfg)[:, 0]
        out = dict(caches)
        out["segments"] = _merge_caches(caches["segments"], new_segs)
        out["pos"] = caches["pos"] + 1
        return logits, out


def _sinusoid_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The sinusoidal embedding at cache positions ``pos`` (a device
    tensor, read on the device): a scalar gives ``[d]``, a ``[B]`` vector
    (per-slot depths) ``[B, d]``."""
    ang = pos.float()[..., None] / timescales(d, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32: ``logsumexp(logits) - logits[target]``
    (the reference's ``_ce``)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    # one target a row: the gather's backward (a scatter-add) gives each
    # address one add, so its result does not depend on the atomics' order
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


def map_axes(fn, axes, *trees):
    """``fn(axes_leaf, *leaves)`` over trees shaped like ``axes``, whose
    leaves are tuples of axis names."""
    if isinstance(axes, dict):
        return {k: map_axes(fn, a, *(t[k] for t in trees)) for k, a in axes.items()}
    if isinstance(axes, list):
        return [map_axes(fn, a, *(t[i] for t in trees)) for i, a in enumerate(axes)]
    return fn(axes, *trees)


def _merge_caches(old_segs: List, new_segs: List) -> List:
    out = []
    for o, n in zip(old_segs, new_segs):
        merged = dict(o)
        merged.update(n or {})
        out.append(merged)
    return out

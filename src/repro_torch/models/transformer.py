"""Decoder LM of the dense, MoE, SSM, hybrid and VLM families: the
counterpart of ``repro/models/transformer.py`` (``init_lm``, ``lm_loss``).

Parameters are a flat dict keyed by the JAX tree's ``|``-joined paths.  As
in JAX, the layers at one position of the block period share stacked
leaves of leading dim ``n_blocks`` (``blocks|<pi>|attn|wq`` is
``(n_blocks, d, H·hd)``, ``blocks|<pi>|moe|shared|w_gate`` is
``(n_blocks, d, n_shared·ff)``); the forward pass walks the stack in a
Python loop where JAX scans it.  Each layer is a mixer — attention
(``attn``) or a Mamba block (``ssm``) — then a dense FFN (``ffn``), an MoE
FFN (``moe``) or none, as ``layer_kinds`` says: the SSM family's layers
are Mamba blocks with no FFN, the hybrid family's period mixes
``(ssm, dense)``, ``(ssm, moe)`` and ``(attn, dense)`` layers.  The MoE
router's leaf and the Mamba block's ``dt_proj``, ``dt_bias``, ``A_log``
and ``D`` are f32 inside a bf16 model, as in the reference.  A VLM's
``frontend`` embeddings ``(B, P, d)`` (the stub of its vision encoder)
are cast to the embedding's dtype and run before the tokens; in the loss
their positions predict nothing.  ``lm_loss`` recomputes each layer in
the backward pass when asked (``remat``), as the reference's scan body
does.  The encoder-decoder family is :mod:`repro_torch.models.encdec`,
built on this module's specs and layers.

Serving (the counterparts of ``lm_prefill``, ``lm_decode_step`` and the
paged entries): caches and page pools keep the JAX layout, a tuple over
period positions of ``{"k", "v"}`` leaves with leading ``n_blocks``
(``pools[pi]["k"][b]`` is layer ``b·period + pi``'s
``(num_pages, page_size, K, hd)`` pool), and are written in place.  An
SSM position's cache is ``{"h", "conv"}``, the fixed-size decode state,
so a hybrid model's caches are a tuple of both kinds; the paged entries
cover attention mixers only, as the reference's.

Tensor parallelism (every family here): :func:`lm_param_specs` /
:func:`lm_cache_specs` are the reference's partition specs, and the
serving entries take ``tp`` (a
:class:`repro_torch.core.sharding.TensorParallel`) to run on a rank's
blocks (see the note above :func:`_reduce`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, block_period, layer_kinds
from .attention import (apply_attn, apply_attn_paged,
                        apply_attn_paged_prefill, init_kv_cache)
from .layers import apply_dense_ffn, init_leaf, rms_norm
from .mamba import apply_mamba, init_ssm_cache, ssm_specs
from .moe import apply_moe, apply_moe_shard_map, expert_axis

__all__ = ["param_specs", "param_meta", "meta_from_specs", "init_lm",
           "init_lm_rank", "init_from_specs", "lm_loss", "init_lm_cache",
           "lm_prefill", "lm_decode_step", "lm_decode_step_paged",
           "lm_prefill_chunk_paged", "lm_serve_step_mixed",
           "lm_param_specs", "expert_param_specs", "lm_cache_specs",
           "check_tp_split", "check_tp_train"]

# (shape, dtype, init): init is the truncated-normal fan-in (an int),
# None for a zero-initialised leaf (norm weights, QKV biases), or a
# constant init (the Mamba block's A_log, dt_bias, D); layers.init_leaf
Spec = Tuple[Tuple[int, ...], torch.dtype, object]

# the decoder families the port runs, and the (mixer, ffn) layer kinds of
# their block periods
_PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
_PORTED_KINDS = (("attn", "dense"), ("attn", "moe"), ("ssm", "none"),
                 ("ssm", "dense"), ("ssm", "moe"))


def _check_family(cfg: ModelConfig):
    kinds = layer_kinds(cfg)[:block_period(cfg)]
    if cfg.family not in _PORTED_FAMILIES or any(
            k not in _PORTED_KINDS for k in kinds):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not a decoder LM: this module "
            "runs the dense, MoE, SSM, hybrid and VLM families (the "
            "encoder-decoder family is repro_torch.models.encdec, which "
            "build_model picks for it)")
    return kinds


def _check_attn_only(cfg: ModelConfig):
    if any(mixer != "attn" for mixer, _ in _check_family(cfg)):
        raise NotImplementedError(
            "paged serving covers attention mixers only (an SSM layer's "
            "state is fixed-size: serve it through greedy_generate)")


def _attn_specs(cfg: ModelConfig, nb: int) -> Dict[str, Spec]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = getattr(torch, cfg.dtype)
    sp = {"ln": ((nb, d), dt, None),
          "wq": ((nb, d, H * hd), dt, d),
          "wk": ((nb, d, K * hd), dt, d),
          "wv": ((nb, d, K * hd), dt, d),
          "wo": ((nb, H * hd, d), dt, H * hd)}
    if cfg.qkv_bias:
        sp.update({"bq": ((nb, H * hd), dt, None),
                   "bk": ((nb, K * hd), dt, None),
                   "bv": ((nb, K * hd), dt, None)})
    if cfg.qk_norm:
        sp.update({"q_norm": ((nb, hd), dt, None),
                   "k_norm": ((nb, hd), dt, None)})
    return sp


def _ffn_specs(cfg: ModelConfig, nb: int) -> Dict[str, Spec]:
    d, ff = cfg.d_model, cfg.dense_d_ff or cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    sp = {"ln": ((nb, d), dt, None),
          "w_up": ((nb, d, ff), dt, d),
          "w_down": ((nb, ff, d), dt, ff)}
    if cfg.mlp_gated:
        sp["w_gate"] = ((nb, d, ff), dt, d)
    return sp


def _moe_specs(cfg: ModelConfig, nb: int) -> Dict[str, Spec]:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    sp = {"ln": ((nb, d), dt, None),
          "router": ((nb, d, E), torch.float32, d),
          "w_gate": ((nb, E, d, ff), dt, d),
          "w_up": ((nb, E, d, ff), dt, d),
          "w_down": ((nb, E, ff, d), dt, ff)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        sp.update({"shared|w_gate": ((nb, d, sff), dt, d),
                   "shared|w_up": ((nb, d, sff), dt, d),
                   "shared|w_down": ((nb, sff, d), dt, sff)})
    return sp


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Every parameter's shape, dtype and init fan-in, keyed by path."""
    kinds = _check_family(cfg)
    nb = cfg.n_layers // len(kinds)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, Spec] = {
        "embed": ((cfg.vocab_size, d), dt, d),
        "final_ln": ((d,), dt, None),
        "lm_head": ((d, cfg.vocab_size), dt, d),
    }
    for pi, (mixer, ffn) in enumerate(kinds):
        subs = ({"ssm": ssm_specs(cfg, nb)} if mixer == "ssm"
                else {"attn": _attn_specs(cfg, nb)})
        if ffn == "moe":
            subs["moe"] = _moe_specs(cfg, nb)
        elif ffn == "dense":
            subs["ffn"] = _ffn_specs(cfg, nb)
        for sub, sp in subs.items():
            specs.update({f"blocks|{pi}|{sub}|{name}": v
                          for name, v in sp.items()})
    return specs


def param_meta(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Shape-only (``meta`` device) parameter dict: no allocation."""
    return meta_from_specs(param_specs(cfg))


def meta_from_specs(specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """``specs``' leaves as ``meta`` tensors of their shapes and dtypes."""
    return {p: torch.empty(s, dtype=dt, device="meta")
            for p, (s, dt, _) in specs.items()}


# ---------------------------------------------------------------------------
# tensor-parallel partition specs (the reference's lm_param_specs /
# lm_cache_specs; see repro_torch.core.sharding)
# ---------------------------------------------------------------------------

_ENCDEC_TP = ("the encoder-decoder family's tensor-parallel layout "
              "(encdec_param_specs) is queued in ROADMAP §1 item 8.2: "
              "whisper_small's 51,865 vocabulary rows split over no M > 1 "
              "in whole blocks, and an uneven vocabulary split is a slice of "
              "its own")


def _check_tp_family(cfg: ModelConfig):
    """The period's layer kinds of a family with a TP layout (every
    decoder family); the encoder-decoder family raises."""
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): {_ENCDEC_TP}")
    return _check_family(cfg)


def _attn_partition(cfg: ModelConfig) -> Dict:
    """The attention leaves' specs: heads column-wise for ``wq`` / ``wk`` /
    ``wv`` and their biases, row-wise for ``wo``."""
    from repro_torch.core.sharding import P
    sp = {"ln": P(None), "wq": P(None, "model"), "wk": P(None, "model"),
          "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qkv_bias:
        sp.update({"bq": P("model"), "bk": P("model"), "bv": P("model")})
    if cfg.qk_norm:
        sp.update({"q_norm": P(None), "k_norm": P(None)})
    return sp


def _ffn_partition(cfg: ModelConfig, gated: Optional[bool] = None) -> Dict:
    """The dense FFN's specs: ``w_gate`` / ``w_up`` column-wise, ``w_down``
    row-wise (``gated``: default the config's ``mlp_gated``)."""
    from repro_torch.core.sharding import P
    sp = {"ln": P(None), "w_up": P(None, "model"), "w_down": P("model", None)}
    if cfg.mlp_gated if gated is None else gated:
        sp["w_gate"] = P(None, "model")
    return sp


def _moe_partition(cfg: ModelConfig) -> Dict:
    """The MoE FFN's specs: ``ln`` and the router replicated, the experts
    over the model axis (expert parallelism), the shared experts as the
    gated dense FFN's (columns of ``w_gate`` / ``w_up``, rows of
    ``w_down``), with no norm of their own."""
    from repro_torch.core.sharding import P
    sp = {"ln": P(None), "router": P(None, None),
          "w_gate": P("model", None, None), "w_up": P("model", None, None),
          "w_down": P("model", None, None)}
    if cfg.n_shared_experts:
        shared = _ffn_partition(cfg, gated=True)
        del shared["ln"]
        sp.update({f"shared|{k}": v for k, v in shared.items()})
    return sp


def _ssm_partition(cfg: ModelConfig) -> Dict:
    """The Mamba block's specs: ``in_proj``, ``conv_w`` and ``dt_proj``
    over their ``d_inner`` columns, ``conv_b``, ``dt_bias`` and ``D`` by
    entries, ``x_proj``, ``A_log`` and ``out_proj`` by rows — a rank's
    channels.  ``in_proj``'s cut is paired (``groups=2``: the same
    channels of x and of z; see :mod:`repro_torch.core.sharding`)."""
    from repro_torch.core.sharding import P
    return {"ln": P(None), "in_proj": P(None, "model", groups=2),
            "conv_w": P(None, "model"), "conv_b": P("model"),
            "x_proj": P("model", None), "dt_proj": P(None, "model"),
            "dt_bias": P("model"), "A_log": P("model", None), "D": P("model"),
            "out_proj": P("model", None)}


def lm_param_specs(cfg: ModelConfig) -> Dict:
    """``{path: PartitionSpec}`` of every parameter, the reference's
    ``lm_param_specs`` path by path: the embedding split over the
    vocabulary, ``lm_head`` over its columns, each layer's mixer and FFN
    leaves as :func:`_attn_partition` / :func:`_ssm_partition` and
    :func:`_ffn_partition` / :func:`_moe_partition`, the stacked leading
    dim ``None`` (the reference's ``_prepend(s, None)``).  The
    encoder-decoder family raises ``NotImplementedError``."""
    from repro_torch.core.sharding import P
    kinds = _check_tp_family(cfg)
    specs = {"embed": P("model", None), "final_ln": P(None),
             "lm_head": P(None, "model")}
    for pi, (mixer, ffn) in enumerate(kinds):
        subs = [("ssm", _ssm_partition(cfg)) if mixer == "ssm"
                else ("attn", _attn_partition(cfg))]
        if ffn == "moe":
            subs.append(("moe", _moe_partition(cfg)))
        elif ffn == "dense":
            subs.append(("ffn", _ffn_partition(cfg)))
        for sub, sp in subs:
            specs.update({f"blocks|{pi}|{sub}|{name}": P(None, *s,
                                                          groups=s.groups)
                          for name, s in sp.items()})
    return specs


def expert_param_specs(paths) -> Dict:
    """The expert-parallel layout of ``paths``: each MoE expert leaf split
    over the model axis along its expert dim (:func:`expert_axis`), every
    other leaf whole — :func:`lm_param_specs`' expert entries alone (the
    layout of :func:`~repro_torch.models.moe.set_moe_mesh`'s
    ``"shard_map"`` path)."""
    from repro_torch.core.sharding import P
    out = {}
    for path in paths:
        ax = expert_axis(path)
        out[path] = P() if ax is None else P(*([None] * ax), "model")
    return out


def lm_cache_specs(cfg: ModelConfig) -> Tuple[Dict, ...]:
    """The reference's ``lm_cache_specs``: a tuple over period positions,
    the batch over ``data`` and the model axis over an attention cache's
    KV heads (``{"k", "v"}`` of ``(n_blocks, B, S, K, hd)``) or an SSM
    state's channels (``{"h", "conv"}`` of ``(n_blocks, B, d_inner,
    d_state)`` and ``(n_blocks, B, conv − 1, d_inner)``).  The
    encoder-decoder family raises ``NotImplementedError``."""
    from repro_torch.core.sharding import P
    one = P(None, "data", None, "model", None)
    return tuple({"h": P(None, "data", "model", None),
                  "conv": P(None, "data", None, "model")} if mixer == "ssm"
                 else {"k": one, "v": one}
                 for mixer, _ in _check_tp_family(cfg))


def check_tp_split(cfg: ModelConfig, count: int) -> None:
    """Raise ``ValueError`` unless ``count`` model ranks can hold ``cfg``
    whole blocks of what its layout splits: where it has attention
    layers, whole heads (rank r holds query heads ``[r·H/M, (r+1)·H/M)``
    and KV heads ``[r·K/M, (r+1)·K/M)``, so GQA's ``h // G`` pairing
    stays on the rank); the dense FFN's columns; the experts and the
    shared experts' ``n_shared · d_ff`` columns; the SSM's ``d_inner``
    channels; the vocabulary rows.  The encoder-decoder family raises
    ``NotImplementedError``."""
    kinds = _check_tp_family(cfg)
    mixers = {m for m, _ in kinds}
    ffns = {f for _, f in kinds}
    splits = [("vocabulary rows", cfg.vocab_size)]
    if "attn" in mixers:
        splits += [("KV heads", cfg.n_kv_heads),
                   ("query heads", cfg.n_heads)]
    if "dense" in ffns:
        splits.append(("FFN columns", cfg.dense_d_ff or cfg.d_ff))
    if "moe" in ffns:
        splits.append(("experts", cfg.n_experts))
        if cfg.n_shared_experts:
            splits.append(("shared-expert columns",
                           cfg.n_shared_experts * cfg.d_ff))
    if "ssm" in mixers:
        splits.append(("SSM channels (d_inner)", cfg.d_inner))
    for what, n in splits:
        if n % count:
            raise ValueError(
                f"{cfg.name}: {n} {what} do not split whole over {count} "
                "model ranks (a rank holds whole blocks: whole heads, so "
                "that each query head's KV head is on the same rank)")


def init_lm(cfg: ModelConfig, generator: torch.Generator
            ) -> Dict[str, torch.Tensor]:
    """Random parameters on ``generator.device``: truncated-normal fan-in
    init (std = 1/√fan_in) for matrices, zeros for norm weights and
    biases, the Mamba block's constants (S4D-real ``A_log``, ``dt_bias``
    −4.6, ``D`` 1) — the JAX package's scheme, drawn from a
    ``torch.Generator`` (so the values differ from ``jax.random``'s; tests
    carry weights across instead).  A stacked leaf (``blocks|...``) is
    drawn one leading-index slice at a time into the allocated leaf, so
    the f32 temporaries are one layer's, not the stack's."""
    return init_from_specs(param_specs(cfg), generator)


def init_lm_rank(cfg: ModelConfig, generator: torch.Generator,
                 index: int, count: int, specs: Optional[Dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """Model rank ``index`` of ``count``'s parameters: :func:`init_lm`'s
    draws, of which the rank keeps its block of every leaf that ``specs``
    (``{path: PartitionSpec}``; default :func:`lm_param_specs`, the
    tensor-parallel layout) splits over ``model`` — bit-equal to
    :func:`repro_torch.core.sharding.shard_params` of :func:`init_lm`'s
    dict, a paired cut included.  The expert-parallel layout (every leaf
    whole but the expert leaves) is ``specs=expert_param_specs(...)``
    (bit-equal to :func:`repro_torch.weights.expert_block`).  The rank
    never holds the whole model: a stacked leaf is drawn one layer slice
    at a time, so the peak is the rank's parameters plus one layer's
    draw."""
    from repro_torch.core.sharding import block_bounds
    shapes = param_specs(cfg)
    if specs is None:
        check_tp_split(cfg, count)
        specs = lm_param_specs(cfg)
    keep = {}
    for path, spec in specs.items():
        bounds = block_bounds(shapes[path][0], spec,
                              {"model": (index, count), "data": (0, 1)}, path)
        if bounds:
            (keep[path],) = bounds      # one split dim a leaf
    return init_from_specs(shapes, generator, keep)


def init_from_specs(specs: Dict[str, Spec], generator: torch.Generator,
                    keep: Dict[str, Tuple[int, int, int, int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``specs`` drawn in sorted path order (see
    :func:`init_lm`); a stacked leaf — one whose first path component
    ends in ``blocks`` — one leading-index slice at a time.  ``keep``
    maps a leaf's path to ``(axis, lo, hi, groups)``
    (:func:`repro_torch.core.sharding.block_bounds`): of each drawn leaf
    (a stacked leaf: of each drawn slice) only that block along ``axis``
    of the whole leaf is kept (the draws, and so every later leaf's bits,
    are the whole init's)."""
    from repro_torch.core.sharding import cut
    keep = keep or {}
    params = {}
    for path in sorted(specs):
        shape, dt, init = specs[path]
        axis, lo, hi, groups = keep.get(path, (None, 0, 0, 1))
        kept = list(shape)
        if axis is not None:
            kept[axis] = (hi - lo) * groups
        if path.split("|", 1)[0].endswith("blocks"):
            if axis == 0:
                raise ValueError(f"{path}: the stacked dim is not split")
            leaf = torch.empty(kept, dtype=dt, device=generator.device)
            for b in range(shape[0]):
                one = init_leaf(shape[1:], dt, init, generator)
                leaf[b] = one if axis is None else cut(one, axis - 1, lo, hi,
                                                       groups)
                # freed before the next draw: two alive at once would
                # double the peak (a Jamba MoE slice is 12.9 GB in f32)
                del one
            params[path] = leaf
        else:
            leaf = init_leaf(shape, dt, init, generator)
            if axis is not None:
                leaf = cut(leaf, axis, lo, hi, groups).clone()
            params[path] = leaf
    return params


def _layers(cfg: ModelConfig, params: Dict[str, torch.Tensor]
            ) -> List[Dict[str, Dict]]:
    """Per-layer ``{"attn": {...}, "ffn" | "moe": {...}}`` views of the
    stacked leaves (nested below, as ``moe["shared"]["w_gate"]``).
    ``unbind`` keeps one autograd node per stacked leaf, whose backward
    stacks the per-layer gradients."""
    period = block_period(cfg)
    nb = cfg.n_layers // period
    layers: List[Dict[str, Dict]] = [{} for _ in range(cfg.n_layers)]
    for path, leaf in params.items():
        parts = path.split("|")
        if parts[0] != "blocks":
            continue
        pi, keys = int(parts[1]), parts[2:]
        for b, w in enumerate(leaf.unbind(0)):
            node = layers[b * period + pi]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = w
    assert len(layers) == nb * period
    return layers


def _ffn(cfg: ModelConfig, lp: Dict, x: torch.Tensor, tp=None,
         enter=None):
    """The layer's FFN with residual: (x, the MoE layer's
    ``router_aux_coef · aux``, or None for a dense layer).  A Mamba layer
    has no FFN: x passes through.  ``tp``: see :func:`_reduce`; an MoE
    layer runs expert-parallel on the same grid, its shared experts'
    partial folded into the one sum.  ``enter``: the training forward's
    :meth:`~repro_torch.core.sharding.TensorParallel.enter`."""
    if "moe" in lp:
        if tp is not None:
            return apply_moe_shard_map(lp["moe"], cfg, x, cfg.norm_eps,
                                       tp.mesh, tp=True)
        return apply_moe(lp["moe"], cfg, x, cfg.norm_eps)
    if "ffn" in lp:
        return apply_dense_ffn(lp["ffn"], x, cfg.norm_eps,
                               reduce=_reduce(tp), enter=enter), None
    return x, None


def _train_layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                 positions: torch.Tensor, tp=None):
    """One layer of the training forward: (x, the MoE aux loss or None).
    ``tp``: a dense layer on the rank's blocks (see :func:`lm_loss`)."""
    if "ssm" in lp:
        x, _ = apply_mamba(lp["ssm"], cfg, x)
        return _ffn(cfg, lp, x)
    enter = None if tp is None else tp.enter
    x = apply_attn(lp["attn"], cfg, x, positions, reduce=_reduce(tp),
                   enter=enter)
    return _ffn(cfg, lp, x, tp, enter)


# "dots" keeps what jax.checkpoint_policies.dots_saveable keeps: the
# matmul outputs; the rest of the layer is recomputed in the backward pass
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _remat_context(remat_policy: str):
    if remat_policy == "full":
        return None
    if remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 list(_DOTS))
    raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                     f"{remat_policy!r}")


def _embed_inputs(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                  frontend, tp=None) -> torch.Tensor:
    """The token embeddings, after the frontend embeddings when given
    (cast to the embedding's dtype): ``(B, P + S, d)``."""
    x = _embed(params, tokens, tp)
    if frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    return x


_TP_TRAIN = ("the train path under tensor parallelism runs the dense "
             "family; TP training of the {family} family is queued in "
             "ROADMAP §1 item 8.6")


def check_tp_train(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg``'s loss runs under
    tensor parallelism: the dense family (QKV bias, QK norm, the GELU
    MLP); the MoE, SSM, hybrid and VLM families' TP losses are queued,
    the encoder-decoder family has no TP layout."""
    _check_tp_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: "
                                  + _TP_TRAIN.format(family=cfg.family))


def lm_loss(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            remat_policy: str = "full", tp=None) -> torch.Tensor:
    """Next-token cross entropy of one agent, plus the MoE layers'
    load-balance losses.  batch: {tokens (B, S), [frontend (B, P, d)]};
    the loss predicts tokens[1:] from the prefix (the frontend positions
    predict nothing), f32 logits through ``logsumexp``.
    ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``): ``remat_policy="full"`` keeps only the
    layer's input, ``"dots"`` also its matmul outputs.  The gradients are
    those of ``remat=False``.

    ``tp`` (a :class:`~repro_torch.core.sharding.TensorParallel`, the
    dense family only: :func:`check_tp_train`): ``params`` are the
    rank's blocks under :func:`lm_param_specs` and the forward is the
    serving one's — the vocab-parallel embedding's sum, each layer's
    ``wo`` and ``w_down`` partials summed before the residual — with the
    backward's sums where the reference's GSPMD puts them: each
    column-parallel product's normed input (``wq`` / ``wk`` / ``wv``,
    ``w_gate`` / ``w_up``, ``lm_head``) and ``q_norm`` / ``k_norm`` go
    through :meth:`~repro_torch.core.sharding.TensorParallel.enter`, and
    the logits' ``(B, S, V / M)`` blocks through the differentiable
    gather, so that the loss is the whole one on every rank and each
    rank's gradient is its block of the whole gradient (a replicated
    leaf's whole, alike on every rank).  The recompute of ``remat``
    repeats a layer's forward sums, in one order on every rank."""
    _check_family(cfg)
    if tp is not None:
        check_tp_train(cfg)
    ctx = _remat_context(remat_policy)
    tokens = batch["tokens"].long()
    fe = batch.get("frontend")
    x = _embed_inputs(params, tokens, fe, tp)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = None
    for lp in _layers(cfg, params):
        if remat:
            kw = {} if ctx is None else {"context_fn": ctx}
            x, a = checkpoint(_train_layer, cfg, lp, x, positions, tp,
                              use_reentrant=False, preserve_rng_state=False,
                              **kw)
        else:
            x, a = _train_layer(cfg, lp, x, positions, tp)
        if a is not None:
            aux = a if aux is None else aux + a
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if tp is None:
        logits = (h @ params["lm_head"]).float()
    else:
        logits = tp.gather(tp.enter(h) @ params["lm_head"]).float()
    n_front = 0 if fe is None else fe.shape[1]
    pred = logits[:, n_front:-1]
    tgt = tokens[:, 1:]
    logz = torch.logsumexp(pred, dim=-1)
    gold = pred.gather(-1, tgt[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll if aux is None else nll + aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# Tensor parallelism (the reference's serve_param_specs layout): the
# serving entries below take ``tp``, a
# :class:`repro_torch.core.sharding.TensorParallel` of the rank grid, with
# the params sharded by ``shard_params(params, lm_param_specs(cfg), mesh)``
# (or drawn so by :func:`init_lm_rank`) and the caches / pools holding the
# rank's KV heads or SSM channels.  Per forward: one sum for the
# vocab-parallel embedding, two a layer — after the mixer (``wo``, or a
# Mamba block's ``out_proj``) and after the FFN (``w_down``, or the MoE
# layer's routed + shared partial), each before its residual; a Mamba
# layer has no FFN and sums its ``x_proj`` product instead — and one
# all-gather of the vocab-parallel logits: a decode step makes 2L + 1 sums
# and one gather, a mixed step twice that (its decode rows and its chunk
# run separately).  A VLM's frontend rows join after the embedding's sum.
# ``tp=None``: the weights are whole.

def _reduce(tp):
    return None if tp is None else tp.psum


def _embed(params, tokens, tp) -> torch.Tensor:
    tokens = tokens.long()
    if tp is None:
        return params["embed"][tokens]
    return tp.embed(params["embed"], tokens)


def _logits(cfg: ModelConfig, params, x, tp=None) -> torch.Tensor:
    """Logits ``(..., V)``: under ``tp`` the rank's ``V / M`` columns,
    gathered over the model axis in rank order (greedy argmax sees the
    one-process ties)."""
    out = rms_norm(x, params["final_ln"], cfg.norm_eps) @ params["lm_head"]
    return out if tp is None else tp.gather(out)


def _stack_index(cfg: ModelConfig):
    """(layer, block b, period position pi) for every layer, in order."""
    period = block_period(cfg)
    return [(li, li // period, li % period) for li in range(cfg.n_layers)]


def init_lm_cache(cfg: ModelConfig, batch: int, length: int, *,
                  device=None, n_kv_heads: Optional[int] = None,
                  d_inner: Optional[int] = None
                  ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Zero caches, a tuple over period positions of stacked leaves:
    ``(n_blocks, batch, length, K, hd)`` ``k`` / ``v`` for attention (K
    ``n_kv_heads``, a tensor-parallel rank's: ``Model.kv_heads``; default
    the config's), and for an SSM position the
    fixed-size state, ``h`` ``(n_blocks, batch, d_inner, d_state)`` f32
    and ``conv`` ``(n_blocks, batch, conv − 1, d_inner)`` (``d_inner`` a
    rank's channels: ``Model.ssm_channels``; default the config's)
    (``device="meta"`` gives the shapes without allocating)."""
    kinds = _check_family(cfg)
    nb = cfg.n_layers // len(kinds)
    out = []
    for mixer, _ in kinds:
        one = (init_ssm_cache(cfg, batch, device=device, d_inner=d_inner)
               if mixer == "ssm"
               else init_kv_cache(cfg, batch, length, device=device,
                                  n_kv_heads=n_kv_heads))
        out.append({k: v[None].expand(nb, *v.shape).contiguous()
                    for k, v in one.items()})
    return tuple(out)


def lm_prefill(cfg: ModelConfig, params, tokens, *, frontend=None,
               window: int = 0, tp=None):
    """Full-sequence forward returning (last-token logits (B, 1, V),
    caches); with ``window`` each KV cache holds the last ``window`` rows
    in ring order.  ``frontend`` embeddings ``(B, P, d)`` run before the
    tokens, so the caches hold ``P + S`` positions.  An SSM layer scans
    from a zero state, as the reference's prefill does, and its cache is
    the final state."""
    _check_family(cfg)
    x = _embed_inputs(params, tokens, frontend, tp)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    per_layer = []
    for lp in _layers(cfg, params):
        if "ssm" in lp:
            x, cache = apply_mamba(
                lp["ssm"], cfg, x, reduce=_reduce(tp),
                cache=init_ssm_cache(cfg, B, device=tokens.device,
                                     d_inner=lp["ssm"]["D"].shape[-1]))
        else:
            x, cache = apply_attn(lp["attn"], cfg, x, positions,
                                  mode="prefill", window=window,
                                  reduce=_reduce(tp))
        x, _ = _ffn(cfg, lp, x, tp)
        per_layer.append(cache)
    period = block_period(cfg)
    caches = tuple(
        {name: torch.stack([c[name] for c in per_layer[pi::period]])
         for name in per_layer[pi]}
        for pi in range(period))
    return _logits(cfg, params, x[:, -1:], tp), caches


def lm_decode_step(cfg: ModelConfig, params, caches, token, pos, *,
                   window: int = 0, tp=None):
    """One decode step.  token: (B, 1); pos: the absolute position, the
    same for every row.  The caches are written in place (an SSM layer's
    new state over its old).  Returns (logits (B, 1, V), caches)."""
    token = token.long()
    x = _embed(params, token, tp)
    B = token.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.long,
                           device=token.device)
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        layer_cache = {name: c[b] for name, c in caches[pi].items()}
        if "ssm" in lp:
            x, new = apply_mamba(lp["ssm"], cfg, x, mode="decode",
                                 cache=layer_cache, reduce=_reduce(tp))
            for name, c in new.items():
                layer_cache[name].copy_(c)
        else:
            x, _ = apply_attn(lp["attn"], cfg, x, positions, mode="decode",
                              cache=layer_cache, window=window,
                              reduce=_reduce(tp))
        x, _ = _ffn(cfg, lp, x, tp)
    return _logits(cfg, params, x, tp), caches


def _layer_pools(pools, b: int, pi: int) -> Dict[str, torch.Tensor]:
    return {name: pools[pi][name][b] for name in ("k", "v")}


def lm_decode_step_paged(cfg: ModelConfig, params, pools, token, positions,
                         page_table, kv_len, *, attn_fn: Callable,
                         window: int = 0, tp=None):
    """One continuous-batching decode step over the whole slot batch.
    token: (B, 1); positions: (B,) each slot's absolute position (ragged);
    page_table: (B, n_pages); kv_len: (B,) valid KV rows (0 for idle
    slots).  ``attn_fn`` is the attention of
    :func:`~repro_torch.models.attention.apply_attn_paged` (the kernel or
    its plain version).  The pools
    are written in place.  Returns (logits (B, 1, V), pools)."""
    _check_attn_only(cfg)
    x = _embed(params, token, tp)
    pos2 = positions.reshape(token.shape[0], 1).long()
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        x, _ = apply_attn_paged(lp["attn"], cfg, x, pos2,
                                pools=_layer_pools(pools, b, pi),
                                page_table=page_table, kv_len=kv_len,
                                window=window, attn_fn=attn_fn,
                                reduce=_reduce(tp))
        x, _ = _ffn(cfg, lp, x, tp)
    return _logits(cfg, params, x, tp), pools


def lm_prefill_chunk_paged(cfg: ModelConfig, params, pools, tokens, pt_row,
                           chunk_start: int, chunk_len: int, *,
                           attn_fn: Callable, window: int = 0, tp=None):
    """One chunked-prefill step for ONE slot: a C-token chunk of its
    prompt (padded to C) attends to the slot's earlier pages and is
    written into them.  tokens: (1, C); pt_row: (n_pages,).  Returns
    (logits (1, C, V), pools); logits rows ≥ chunk_len are padding."""
    _check_attn_only(cfg)
    x = _embed(params, tokens, tp)
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        x, _ = apply_attn_paged_prefill(
            lp["attn"], cfg, x, pools=_layer_pools(pools, b, pi),
            pt_row=pt_row, chunk_start=chunk_start, chunk_len=chunk_len,
            window=window, attn_fn=attn_fn, reduce=_reduce(tp))
        x, _ = _ffn(cfg, lp, x, tp)
    return _logits(cfg, params, x, tp), pools


def lm_serve_step_mixed(cfg: ModelConfig, params, pools, token, positions,
                        page_table, kv_len, chunk_tokens, pt_row,
                        chunk_start: int, chunk_len: int, *,
                        attn_fn: Callable, prefill_attn_fn: Callable,
                        window: int = 0, tp=None):
    """The mixed serving step: every live decode slot advances one token
    AND one prefill chunk of one slot runs, in one walk over the layers.
    Decode inputs are :func:`lm_decode_step_paged`'s (the engine masks
    mid-prefill slots out of ``page_table`` / ``kv_len``), chunk inputs
    :func:`lm_prefill_chunk_paged`'s.  Within each layer the decode batch
    runs first, then the chunk; their page writes are disjoint.  An MoE
    FFN routes the decode rows (idle slots included) and the chunk rows
    (padding included) in two separate calls, as the reference does, so
    each call's capacity is its own.
    Returns (decode logits (B, 1, V), chunk logits (1, C, V), pools)."""
    _check_attn_only(cfg)
    xd = _embed(params, token, tp)
    xc = _embed(params, chunk_tokens, tp)
    pos2 = positions.reshape(token.shape[0], 1).long()
    red = _reduce(tp)
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        layer_pools = _layer_pools(pools, b, pi)
        xd, _ = apply_attn_paged(lp["attn"], cfg, xd, pos2, pools=layer_pools,
                                 page_table=page_table, kv_len=kv_len,
                                 window=window, attn_fn=attn_fn, reduce=red)
        xc, _ = apply_attn_paged_prefill(
            lp["attn"], cfg, xc, pools=layer_pools, pt_row=pt_row,
            chunk_start=chunk_start, chunk_len=chunk_len, window=window,
            attn_fn=prefill_attn_fn, reduce=red)
        xd, _ = _ffn(cfg, lp, xd, tp)
        xc, _ = _ffn(cfg, lp, xc, tp)
    return (_logits(cfg, params, xd, tp), _logits(cfg, params, xc, tp),
            pools)

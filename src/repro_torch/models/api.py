"""Public model API: the counterpart of ``repro/models/api.py`` for every
family: dense, MoE, SSM, hybrid, VLM and encoder-decoder.

``Model`` bundles the training entries ``init`` (a ``torch.Generator`` →
parameter dict on the generator's device), ``loss`` (``(params, batch,
remat=True, remat_policy="full") → scalar``, as the reference's) and
``meta`` (shape-only parameters, for layouts), and the
serving entries of the JAX ``Model``: ``prefill``, ``decode_step``,
``init_cache``, ``decode_window`` and the paged ``decode_step_paged``,
``prefill_chunk_paged`` and ``decode_step_mixed`` (attention mixers
only: they raise for an SSM or hybrid model, and are None for an
encoder-decoder model, as in the reference).  A VLM batch carries its
``frontend`` embeddings beside the tokens, to ``loss`` and ``prefill``;
an encoder-decoder batch its encoder's frames under the same key
(:mod:`repro_torch.models.encdec`; its ``loss`` takes ``remat`` and
``remat_policy`` and ignores both, as the reference's).
Caches and pools are written in place (see
:mod:`repro_torch.models.transformer`).  The paged entries take their
attention as an argument: the kernels of
:mod:`repro_torch.kernels.ops` or their plain versions in
:mod:`repro_torch.kernels.ref`.

``param_specs`` / ``cache_specs`` are the reference's: ``() →`` the
tensor-parallel :class:`~repro_torch.core.sharding.PartitionSpec` of
every parameter path / of the cache tree (every decoder family; the
encoder-decoder family raises ``NotImplementedError``).
``build_model(cfg, mesh=grid)``
builds the model's serving entries on a ``("data", "model")`` rank grid
(:func:`repro_torch.launch.mesh.make_moe_mesh`): the params and caches
they take are the rank's blocks under those specs
(:func:`repro_torch.core.sharding.shard_params`, or
:func:`repro_torch.models.transformer.init_lm_rank`), and each forward
sums over the model axis where the reference's GSPMD would
(:class:`~repro_torch.core.sharding.TensorParallel`): the counterpart of
the reference's ``serve_param_specs`` under ``jax.jit(in_shardings=…)``,
fixed at build time.  ``kv_heads`` is the KV heads a rank holds (the
config's on one rank, K/M on the grid): the caches' and the paged pools'
width; ``ssm_channels`` the SSM channels (``d_inner``, or ``d_inner /
M``): an SSM state's.  Under the grid an MoE layer runs expert-parallel
(:func:`repro_torch.models.moe.apply_moe_shard_map`).  ``loss`` under
the grid is a dense model's tensor-parallel loss (its gradient is the
rank's block of the whole gradient: :func:`repro_torch.models.
transformer.lm_loss`); for the other families it raises
``NotImplementedError``, their TP training queued.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from . import encdec as ed
from . import transformer as tf

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable        # generator -> {path: tensor}
    loss: Callable        # (params, batch, remat, remat_policy) -> scalar
    meta: Callable        # () -> {path: meta tensor}
    prefill: Callable     # (params, batch) -> (logits, caches)
    decode_step: Callable  # (params, caches, token, pos) -> (logits, caches)
    init_cache: Callable  # (batch, length, device=None) -> caches
    decode_window: int = 0  # sliding-window size fixed at build time
    # (params, pools, token, positions, page_table, kv_len, attn_fn)
    # -> (logits, pools)
    decode_step_paged: Optional[Callable] = None
    # (params, pools, tokens, pt_row, chunk_start, chunk_len, attn_fn)
    # -> (chunk logits, pools): one prompt chunk of one slot
    prefill_chunk_paged: Optional[Callable] = None
    # (params, pools, token, positions, page_table, kv_len, chunk_tokens,
    #  pt_row, chunk_start, chunk_len, attn_fn, prefill_attn_fn)
    # -> (decode logits, chunk logits, pools): the mixed serving step
    decode_step_mixed: Optional[Callable] = None
    param_specs: Optional[Callable] = None   # () -> {path: PartitionSpec}
    cache_specs: Optional[Callable] = None   # () -> cache tree of specs
    kv_heads: Optional[int] = None   # a rank's KV heads (None: cfg's)
    ssm_channels: Optional[int] = None   # a rank's d_inner (None: cfg's)


def _build_encdec(cfg: ModelConfig, w: int) -> Model:
    def loss(params, batch, remat=True, remat_policy="full"):
        return ed.encdec_loss(cfg, params, batch, remat=remat,
                              remat_policy=remat_policy)

    def prefill(params, batch):
        return ed.encdec_prefill(cfg, params, batch["tokens"],
                                 batch["frontend"], window=w)

    def decode_step(params, caches, token, pos):
        return ed.encdec_decode_step(cfg, params, caches, token, pos,
                                     window=w)

    def init_cache(batch, length, device=None):
        return ed.init_encdec_cache(cfg, batch, length, device=device)

    def no_tp():
        return tf.lm_param_specs(cfg)      # raises NotImplementedError

    return Model(cfg, lambda generator: ed.init_encdec(cfg, generator), loss,
                 lambda: tf.meta_from_specs(ed.encdec_param_specs(cfg)),
                 prefill, decode_step, init_cache, decode_window=w,
                 param_specs=no_tp, cache_specs=no_tp)


def build_model(cfg: ModelConfig, decode_window: int = 0,
                mesh=None) -> Model:
    """The model of ``cfg``; with ``mesh`` (a ``("data", "model")`` rank
    grid) its serving entries split over the model axis (every decoder
    family; a count that does not split whole raises ``ValueError``, the
    encoder-decoder family ``NotImplementedError``)."""
    w = decode_window
    if cfg.family == "encdec" and mesh is None:
        return _build_encdec(cfg, w)
    if mesh is not None:
        from repro_torch.core.sharding import TensorParallel
        tp = TensorParallel(mesh)
        tf.check_tp_split(cfg, tp.size)
    else:
        tp = None
    M = 1 if tp is None else tp.size
    kv_heads, ssm_channels = cfg.n_kv_heads // M, cfg.d_inner // M
    tf.param_specs(cfg)   # raises for a family this module does not run

    def prefill(params, batch):
        return tf.lm_prefill(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"), window=w, tp=tp)

    def decode_step(params, caches, token, pos):
        return tf.lm_decode_step(cfg, params, caches, token, pos, window=w,
                                 tp=tp)

    def init_cache(batch, length, device=None):
        return tf.init_lm_cache(cfg, batch, length, device=device,
                                n_kv_heads=kv_heads, d_inner=ssm_channels)

    def decode_step_paged(params, pools, token, positions, page_table,
                          kv_len, attn_fn):
        return tf.lm_decode_step_paged(cfg, params, pools, token, positions,
                                       page_table, kv_len, window=w,
                                       attn_fn=attn_fn, tp=tp)

    def prefill_chunk_paged(params, pools, tokens, pt_row, chunk_start,
                            chunk_len, attn_fn):
        return tf.lm_prefill_chunk_paged(cfg, params, pools, tokens, pt_row,
                                         chunk_start, chunk_len, window=w,
                                         attn_fn=attn_fn, tp=tp)

    def decode_step_mixed(params, pools, token, positions, page_table,
                          kv_len, chunk_tokens, pt_row, chunk_start,
                          chunk_len, attn_fn, prefill_attn_fn):
        return tf.lm_serve_step_mixed(cfg, params, pools, token, positions,
                                      page_table, kv_len, chunk_tokens,
                                      pt_row, chunk_start, chunk_len,
                                      window=w, attn_fn=attn_fn,
                                      prefill_attn_fn=prefill_attn_fn, tp=tp)

    def loss(params, batch, remat=True, remat_policy="full"):
        return tf.lm_loss(cfg, params, batch, remat=remat,
                          remat_policy=remat_policy, tp=tp)

    return Model(cfg,
                 lambda generator: tf.init_lm(cfg, generator),
                 loss,
                 lambda: tf.param_meta(cfg),
                 prefill, decode_step, init_cache, decode_window=w,
                 decode_step_paged=decode_step_paged,
                 prefill_chunk_paged=prefill_chunk_paged,
                 decode_step_mixed=decode_step_mixed,
                 param_specs=lambda: tf.lm_param_specs(cfg),
                 cache_specs=lambda: tf.lm_cache_specs(cfg),
                 kv_heads=kv_heads, ssm_channels=ssm_channels)

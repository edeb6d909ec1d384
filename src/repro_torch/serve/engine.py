"""Dense serving reference: prefill + batched greedy decode with KV caches,
the counterpart of ``repro/serve/engine.py`` (``build_serve_step``,
``grow_caches``, ``greedy_generate``, ``serve_param_specs``,
``serve_cache_specs``, ``scale_specs_multipod``).  The
continuous-batching engine of :mod:`repro_torch.serve.scheduler` is held
against this path.

Serving uses a single replica sharded tensor-parallel, as the
reference's: ``serve_param_specs`` / ``serve_cache_specs`` give the
:class:`~repro_torch.core.sharding.PartitionSpec` trees that
:func:`repro_torch.core.sharding.shard_params` applies to a rank of a
``(1, M)`` ``("data", "model")`` grid, and a model built on that grid
(``build_model(cfg, mesh=grid)``) serves from the rank's blocks.  Its
logits are gathered over the model axis, so every rank draws the same
greedy tokens.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.api import Model

__all__ = ["build_serve_step", "grow_caches", "greedy_generate",
           "serve_param_specs", "serve_cache_specs", "scale_specs_multipod"]


def build_serve_step(model: Model) -> Callable:
    """``serve_step(params, caches, token, pos) -> (next_token (B, 1),
    caches)``: one new token per request (greedy head); the caches are
    written in place."""

    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(params, caches, token, pos)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1)
        return nxt.to(torch.int32)[:, None], caches

    return serve_step


def serve_param_specs(model: Model, *, fsdp: bool, multi_pod: bool):
    """The tensor-parallel specs of the serving params:
    ``model.param_specs()``.  ``fsdp=True`` (the reference's ZeRO-style 2-D
    sharding of each weight's first unsharded dim over ``data``, gathered
    on use) raises: it is queued in ROADMAP §1.  ``multi_pod`` names the
    data axes ``("pod", "data")``; without fsdp no param spec names
    them, so it changes nothing, as in the reference."""
    if fsdp:
        raise NotImplementedError(
            "ZeRO-style serving (serve_param_specs(fsdp=True)) is a later "
            "slice, queued in ROADMAP §1")
    del multi_pod
    return model.param_specs()


def serve_cache_specs(model: Model, multi_pod: bool):
    """The cache specs, every ``data`` entry as ``("pod", "data")`` with
    ``multi_pod``."""
    specs = model.cache_specs()
    return scale_specs_multipod(specs) if multi_pod else specs


def scale_specs_multipod(spec_tree):
    """Map every ``"data"`` mesh-axis entry of a spec tree (dicts, tuples,
    lists of :class:`~repro_torch.core.sharding.PartitionSpec`) to
    ``("pod", "data")``."""
    from repro_torch.core.sharding import PartitionSpec
    if isinstance(spec_tree, PartitionSpec):
        return PartitionSpec(*(("pod", "data") if e == "data" else e
                               for e in spec_tree), groups=spec_tree.groups)
    if isinstance(spec_tree, dict):
        return {k: scale_specs_multipod(v) for k, v in spec_tree.items()}
    return type(spec_tree)(scale_specs_multipod(v) for v in spec_tree)


def grow_caches(model: Model, caches, batch_size: int, target_len: int):
    """Pad every prefill-cache leaf out to the shape
    ``model.init_cache(batch_size, target_len)`` would allocate.

    The target shapes come from the model's own cache layout (built on the
    ``meta`` device, no allocation), and each leaf grows along the one
    axis that differs, with zeros; leaves already at the target shape
    (ring caches at ``window``) pass through untouched."""
    target = model.init_cache(batch_size, target_len, device="meta")

    def grow(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cur, want = tuple(c.shape), tuple(t.shape)
        if cur == want:
            return c
        diff = [i for i, (a, b) in enumerate(zip(cur, want)) if a != b]
        if len(cur) != len(want) or len(diff) != 1 \
                or want[diff[0]] < cur[diff[0]]:
            raise ValueError(f"cache leaf {cur} does not grow to {want} "
                             "along one axis")
        ax = diff[0]
        pad = [0, 0] * (len(cur) - 1 - ax) + [0, want[ax] - cur[ax]]
        return F.pad(c, pad)

    return tuple({name: grow(c[name], t[name]) for name in c}
                 for c, t in zip(caches, target))


@torch.inference_mode()
def greedy_generate(model: Model, params, batch: Dict[str, Any],
                    n_steps: int) -> torch.Tensor:
    """Prefill the prompt, then greedy-decode: returns (B, n_steps)
    generated ids (int32), the first from the prefill logits.  This is the
    dense reference the continuous-batching engine is held against.  A
    VLM batch's ``frontend`` embeddings (B, n_front, d) occupy the first
    positions of the stream, so the caches grow to ``S + n_front +
    n_steps`` and decoding starts at position ``S + n_front``; an SSM
    layer's fixed-size state passes through ``grow_caches`` untouched.
    An encoder-decoder batch's ``frontend`` is the encoder's frames, not
    positions of the decoder's stream (``n_front`` 0, as the reference
    checks the family): only ``k`` / ``v`` grow, and ``xk`` / ``xv`` pass
    through when the frames have ``n_frontend_tokens`` rows (other counts
    are padded with zero rows that cross attention does not mask, as in
    the reference)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    fe = batch.get("frontend")
    n_front = (0 if fe is None or model.cfg.family == "encdec"
               else fe.shape[1])
    logits, caches = model.prefill(params, batch)
    L0 = S + n_front
    caches = grow_caches(model, caches, B, model.decode_window or L0 + n_steps)
    step = build_serve_step(model)
    tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(n_steps - 1):
        tok, caches = step(params, caches, tok, L0 + i)
        out.append(tok)
    return torch.cat(out, dim=1)

"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Batched prefill + greedy decode, or the continuous-batching engine over
the paged KV cache.  It takes the reference launcher's flags plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path and
must be asked for).  ``--attn-impl`` takes ``ref`` (plain gather +
softmax) or ``kernel`` (the default: the CUDA paged-attention kernels on
the card, their plain versions on the CPU), where the reference's takes
``ref`` / ``pallas``.

  # dense reference path (the SSM and hybrid families serve this way
  # only: an SSM layer's decode state is fixed-size, not paged; a VLM's
  # fixed batch carries seeded frontend embeddings before its prompts)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --smoke --device cpu --batch 4 --prompt-len 32 --new-tokens 16

  # Jamba-1.5-Large (398 B parameters) does not fit one card: serve its
  # full width at the 5 layers that hold every layer kind of its period
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba_1_5_large_398b --n-layers 5 --batch 8 --prompt-len 32

  # chunked prefill fused into the decode dispatch
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --continuous-batching --prefill-chunk 16 --max-step-tokens 32 \
      --prompt-dist exact --max-slots 8 --page-size 16 --requests 16

The continuous engine serves a VLM (``--arch pixtral_12b``) text-only,
as the reference's scheduler does: it has no frontend path.  The
encoder-decoder family (``--arch whisper_small``) serves the fixed batch
only, each request with ``n_frontend_tokens`` (1500) seeded frame
embeddings for its encoder; it has no paged path, so
``--continuous-batching`` raises, as in the reference.

Under torchrun a decoder model is served as the reference serves: one
replica sharded tensor-parallel over the ``(1, world)`` ``("data",
"model")`` grid (:func:`repro_torch.launch.mesh.make_moe_mesh`; the
reference's ``serve_param_specs`` / ``paged_pool_specs`` layout,
:mod:`repro_torch.core.sharding`).  Each rank draws its block of every
split leaf (``init_lm_rank``: whole heads, ``ff / world`` FFN columns,
E / world experts and the shared experts' columns, ``d_inner / world``
SSM channels, ``V / world`` vocabulary rows; with ``--ckpt`` its block of
each entry of the file, cut on the host), builds the model on the grid
(``build_model(cfg, mesh=grid)``) and serves the same requests through
the same engine or ``greedy_generate``: each forward sums over the model
axis once for the embedding and twice a layer (a Mamba layer: after
``x_proj`` and ``out_proj``), and gathers the logits once.  The engine
must take the same admissions on every rank, so the continuous trace
arrives at once (every arrival at 0: a closed batch).  Rank 0 prints;
the metrics carry every rank's token digest (``rank_token_digests``).
A count that does not split over the world raises ``ValueError``
(``smollm_360m``'s 5 KV heads at 2 or 4 ranks).  An SSM or hybrid model
serves the fixed batch there too; the encoder-decoder family has no TP
layout, and each torchrun process serves it whole.

A model with experts (``deepseek_moe_16b``, ``qwen3_moe_235b_a22b``,
``jamba_1_5_large_398b``) needs ``--moe-impl shard_map`` under torchrun
(the reference's ``RunConfig.moe_impl`` / dry-run flag; without it, it
raises): its MoE layers run expert-parallel on the same grid
(:func:`repro_torch.models.moe.apply_moe_shard_map`), attention and the
shared experts split as above, the rank's shared-expert partial summed
with its routed one.  ``gspmd`` (the default) serves in one process;
``shard_map`` outside torchrun raises.  Ranks sharing a card sum over
gloo through the host; across cards NCCL (not run anywhere):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch qwen3_14b --smoke --device cpu \
      --continuous-batching --prefill-chunk 8 --max-step-tokens 16 \
      --prompt-dist exact --requests 4
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch deepseek_moe_16b --smoke \
      --device cpu --moe-impl shard_map --continuous-batching \
      --prefill-chunk 8 --max-step-tokens 16 --prompt-dist exact
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch falcon_mamba_7b --smoke \
      --device cpu --batch 2 --prompt-len 8 --new-tokens 4

``--ckpt`` loads a consensus export — the port's
(``repro_torch.train.checkpoint.export_consensus``) or the reference's,
an npz of the bare-path parameter tree — through
:func:`repro_torch.weights.params_from_npz`, and prints the parameters'
SHA-256 (:func:`repro_torch.weights.params_digest`), which the returned
metrics carry as ``params_sha256``: the train → export → serve hand-off
can check that the served weights are the exported bits.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.configs.base import layer_kinds
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import init_lm_rank, lm_param_specs
from repro_torch.serve import (ContinuousBatchingEngine, PagedCacheConfig,
                               greedy_generate, poisson_load)
from repro_torch.weights import (npz_params_digest, params_digest,
                                 params_from_npz)

__all__ = ["parser", "main"]

# the trace sizes of the reference CLI: prompts 16–32, up to 32 new tokens
MAX_PROMPT, MAX_NEW = 32, 32


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    help="architecture (the port's ARCH_IDS: the dense, "
                         "MoE, SSM, hybrid, VLM and encoder-decoder "
                         "families; an SSM, hybrid or encoder-decoder "
                         "model serves the fixed batch only, without "
                         "--continuous-batching; a VLM's continuous "
                         "engine is text-only)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers at full width "
                         "(0 = the config's depth): a model too large for "
                         "the card, served on random weights")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window KV cache size (0 = full)")
    ap.add_argument("--ckpt", default=None,
                    help="consensus-exported params .npz "
                         "(repro_torch.train.checkpoint.export_consensus, "
                         "or the JAX package's)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="serve a Poisson request trace through the paged "
                         "continuous-batching engine instead of one fixed "
                         "batch")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV page rows (multiple of 8)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="concurrent decode slots")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests in the Poisson trace")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--attn-impl", choices=("ref", "kernel"),
                    default="kernel",
                    help="paged attention: 'kernel' = the CUDA kernels on "
                         "the card (plain versions on the CPU), 'ref' = "
                         "the plain gather + softmax")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: fixed chunk width in tokens "
                         "(None = per-request exact-length prefill)")
    ap.add_argument("--max-step-tokens", type=int, default=None,
                    help="per-dispatch token budget (chunk + live decodes); "
                         "None = uncapped")
    ap.add_argument("--prompt-dist", choices=("bucket", "exact"),
                    default="bucket",
                    help="prompt-length draw: 'bucket' or 'exact' (a length "
                         "continuum)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--moe-impl", choices=moe.MOE_IMPLS, default="gspmd",
                    help="MoE FFN: 'gspmd' = one process; 'shard_map' = "
                         "expert-parallel across torchrun's ranks, each "
                         "holding E / world experts a layer, in the "
                         "tensor-parallel serving layout (needed for a "
                         "model with experts under torchrun)")
    return ap


def _rank_grid(args, cfg):
    """Under torchrun a decoder model's ``(1, world)`` grid (it joins
    torchrun's process group), else None.  ``--moe-impl shard_map`` raises
    outside torchrun and for a model with no experts; a model with
    experts under torchrun raises without it."""
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.moe_impl == "shard_map":
        if not torchrun:
            raise RuntimeError("--moe-impl shard_map serves one rank a "
                               "process: run it under torchrun (e.g. "
                               "torchrun --standalone --nproc-per-node 4 -m "
                               "repro_torch.launch.serve ...)")
        if not cfg.n_experts:
            raise ValueError(f"--moe-impl shard_map needs an MoE model; "
                             f"{cfg.name} has no experts")
    elif torchrun and cfg.n_experts:
        raise ValueError(f"{cfg.name} has experts: under torchrun it is "
                         "served expert-parallel with --moe-impl shard_map "
                         "(its gspmd form has no multi-rank counterpart)")
    if not torchrun or cfg.family == "encdec":
        return None
    from repro_torch.launch.mesh import init_distributed, make_moe_mesh
    init_distributed(str(resolve_device(args.device)))
    return make_moe_mesh(1)


def _tp_line(cfg, model, mesh) -> str:
    """The rank's share of each split the layout makes (a model with
    experts: a ``moe=shard_map`` line first)."""
    M = mesh.axis_size("model")
    kinds = set(layer_kinds(cfg))
    parts = [f"tp grid={mesh.shape}"]
    if any(m == "attn" for m, _ in kinds):
        parts.append(f"heads/rank={cfg.n_heads // M}/{model.kv_heads}")
    if any(f == "dense" for _, f in kinds):
        parts.append(f"ffn/rank={(cfg.dense_d_ff or cfg.d_ff) // M}")
    if cfg.n_shared_experts:
        parts.append(f"shared_ffn/rank={cfg.n_shared_experts * cfg.d_ff // M}")
    if any(m == "ssm" for m, _ in kinds):
        parts.append(f"d_inner/rank={model.ssm_channels}")
    parts += [f"vocab/rank={cfg.vocab_size // M}", f"backend={mesh.backend}"]
    moe_line = (f"moe=shard_map grid={mesh.shape} experts/rank="
                f"{cfg.n_experts // M}\n" if cfg.n_experts else "")
    return moe_line + " ".join(parts)


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def _rank_digests(mesh, digest: str):
    """Every rank's token digest, in rank order (over the control group)."""
    import torch.distributed as dist
    out = [None] * mesh.size
    dist.all_gather_object(out, digest, group=mesh.control)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv``, serve, print the metrics, and return them: the
    engine's :func:`~repro_torch.serve.scheduler.summarize` dict with
    ``--continuous-batching`` (plus ``params_sha256`` with ``--ckpt``),
    else ``{"tokens": (B, new_tokens) ids, "seconds": s,
    "params_sha256": digest or None}``; both with ``token_digest`` (the
    SHA-256 of the generated ids) and, on a rank grid (a decoder model
    under torchrun), ``rank_token_digests`` (every rank's, in rank
    order)."""
    args = parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return _serve(args, cfg, _rank_grid(args, cfg))


def _serve(args, cfg, mesh) -> Dict[str, Any]:
    device = resolve_device(args.device) if mesh is None else mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    model = build_model(cfg, decode_window=args.window, mesh=mesh)
    digest = None
    gen = torch.Generator(device=device).manual_seed(0)
    if mesh is not None:
        m, M = mesh.axis_index("model"), mesh.axis_size("model")
    if args.ckpt and mesh is not None:
        digest = npz_params_digest(args.ckpt)
        params = params_from_npz(args.ckpt, device=device,
                                 block=(lm_param_specs(cfg), m, M))
        say(f"loaded consensus params from {args.ckpt} (sha256 {digest}), "
            f"model rank blocks of {M}")
    elif args.ckpt:
        params = params_from_npz(args.ckpt, device=device)
        digest = params_digest(params)
        say(f"loaded consensus params from {args.ckpt} (sha256 {digest})")
    elif mesh is not None:
        params = init_lm_rank(cfg, gen, m, M)
    else:
        params = model.init(gen)
    if mesh is not None:
        say(_tp_line(cfg, model, mesh))
    grid = "" if mesh is None else f" grid={mesh.shape}"

    if args.continuous_batching:
        ctx = args.window or MAX_PROMPT + MAX_NEW
        pcfg = PagedCacheConfig(
            page_size=args.page_size,
            num_pages=1 + args.max_slots * (-(-ctx // args.page_size)),
            max_slots=args.max_slots, max_context=ctx, window=args.window)
        eng = ContinuousBatchingEngine(model, params, pcfg,
                                       attn_impl=args.attn_impl,
                                       prefill_chunk=args.prefill_chunk,
                                       max_step_tokens=args.max_step_tokens,
                                       device=device)
        reqs = poisson_load(args.requests, args.rate, vocab=cfg.vocab_size,
                            prompt_buckets=(MAX_PROMPT // 2, MAX_PROMPT),
                            new_token_buckets=(4, 8, 16, MAX_NEW),
                            prompt_dist=args.prompt_dist, seed=1)
        if mesh is not None:
            reqs = [dataclasses.replace(r, arrival=0.0) for r in reqs]
        metrics = eng.run(reqs)
        if digest is not None:
            metrics["params_sha256"] = digest
        metrics["token_digest"] = _digest(
            {str(r): t.tolist() for r, t in sorted(eng.completed.items())})
        if mesh is not None:
            metrics["rank_token_digests"] = _rank_digests(
                mesh, metrics["token_digest"])
        pf = (f"chunked(C={args.prefill_chunk})"
              if args.prefill_chunk else "per-request")
        say(f"arch={cfg.name} engine=continuous slots={args.max_slots} "
            f"page={args.page_size} window={args.window or 'full'} "
            f"attn={args.attn_impl} prefill={pf} "
            f"compiles={metrics['compile_count']} device={device}{grid}"
            + ("" if mesh is None else " arrivals=closed"))
        say("serve metrics: " + json.dumps(metrics))
        say(f"generated {metrics['tokens']} tokens over "
            f"{metrics['requests']} requests "
            f"({metrics['tokens_per_s']} tok/s)", flush=True)
        return metrics

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(device)}
    if cfg.family in ("vlm", "encdec"):
        # the frontend stub's embeddings (a VLM's image positions, an
        # encoder-decoder's frames), n_frontend_tokens a request
        gen = torch.Generator(device=device).manual_seed(2)
        batch["frontend"] = torch.randn(
            (args.batch, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=device).to(getattr(torch, cfg.dtype))
    t0 = time.perf_counter()
    out = greedy_generate(model, params, batch, n_steps=args.new_tokens)
    out = out.cpu()                       # waits for the device
    dt = time.perf_counter() - t0
    front = (f" frontend={cfg.n_frontend_tokens}" if "frontend" in batch
             else "")
    say(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}"
        f"{front} window={args.window or 'full'} device={device}{grid}")
    say(f"generated {args.new_tokens} tokens/request in {dt:.2f}s "
        f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    for i in range(min(args.batch, 4)):
        say(f"  req{i}: {out[i].tolist()}")
    res = {"tokens": out, "seconds": dt, "params_sha256": digest,
           "token_digest": _digest(out.tolist())}
    if mesh is not None:
        res["rank_token_digests"] = _rank_digests(mesh, res["token_digest"])
        say(f"rank token digests: {res['rank_token_digests']}")
    return res


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

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
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (ContinuousBatchingEngine, PagedCacheConfig,
                               greedy_generate, poisson_load)
from repro_torch.weights import params_digest, params_from_npz

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
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv``, serve, print the metrics, and return them: the
    engine's :func:`~repro_torch.serve.scheduler.summarize` dict with
    ``--continuous-batching`` (plus ``params_sha256`` with ``--ckpt``),
    else ``{"tokens": (B, new_tokens) ids, "seconds": s,
    "params_sha256": digest or None}``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = build_model(cfg, decode_window=args.window)
    digest = None
    if args.ckpt:
        params = params_from_npz(args.ckpt, device=device)
        digest = params_digest(params)
        print(f"loaded consensus params from {args.ckpt} (sha256 {digest})")
    else:
        params = model.init(torch.Generator(device=device).manual_seed(0))

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
        metrics = eng.run(reqs)
        if digest is not None:
            metrics["params_sha256"] = digest
        pf = (f"chunked(C={args.prefill_chunk})"
              if args.prefill_chunk else "per-request")
        print(f"arch={cfg.name} engine=continuous slots={args.max_slots} "
              f"page={args.page_size} window={args.window or 'full'} "
              f"attn={args.attn_impl} prefill={pf} "
              f"compiles={metrics['compile_count']} device={device}")
        print("serve metrics: " + json.dumps(metrics))
        print(f"generated {metrics['tokens']} tokens over "
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
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}"
          f"{front} window={args.window or 'full'} device={device}")
    print(f"generated {args.new_tokens} tokens/request in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    for i in range(min(args.batch, 4)):
        print(f"  req{i}: {out[i].tolist()}")
    return {"tokens": out, "seconds": dt, "params_sha256": digest}


if __name__ == "__main__":
    main()

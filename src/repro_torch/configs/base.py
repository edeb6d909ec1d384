"""Model / run configuration: a copy of ``repro/configs/base.py``.

The port keeps its own copy rather than importing the JAX package.  Field
names and defaults are identical (including ``RunConfig.alpha = 1e-3``
against the CLI default of 0.2), so one configuration means the same run
in both packages.  ``layer_kinds`` derives the per-layer (mixer, ffn)
pattern the model stacks follow.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

__all__ = ["ModelConfig", "RunConfig", "block_period", "layer_kinds",
           "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0                # 0 → d_model // n_heads
    # attention options
    pos_emb: str = "rope"            # rope | sinusoidal (encdec)
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_gated: bool = True           # SwiGLU vs plain GELU MLP
    sliding_window: int = 0          # 0 = full causal attention
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1               # layer i uses MoE FFN iff i % moe_every == moe_offset
    moe_offset: int = 0
    dense_d_ff: int = 0              # ffn width of non-MoE layers in mixed models
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 → ceil(d_model / 16)
    # hybrid: layer i is attention iff i % attn_every == attn_offset (else SSM)
    attn_every: int = 0              # 0 → all attention (or all-SSM for family=ssm)
    attn_offset: int = 0
    # encoder-decoder (audio)
    n_enc_layers: int = 0
    # modality frontend stub: number of precomputed embedding tokens supplied
    n_frontend_tokens: int = 0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # citation / provenance (model card or paper)
    source: str = ""

    # ---- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def is_decoder_lm(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, V = self.d_model, self.vocab_size
        total = V * d * 2  # embed + untied lm head
        for mixer, ffn in layer_kinds(self):
            if mixer == "attn" or mixer == "xattn":
                qk = d * self.n_heads * self.hd + d * self.n_kv_heads * self.hd * 2
                total += qk + self.n_heads * self.hd * d + 2 * d
                if mixer == "xattn":
                    total += qk + self.n_heads * self.hd * d + d
            elif mixer == "ssm":
                di, s, r = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di + self.ssm_conv * di + di * (r + 2 * s)
                total += r * di + di * s + di + di * d + d
            if ffn == "dense":
                ff = self.dense_d_ff or self.d_ff
                total += d * ff * (3 if self.mlp_gated else 2) + d
            elif ffn == "moe":
                e_ff = self.d_ff
                total += d * self.n_experts + self.n_experts * d * e_ff * 3 + d
                if self.n_shared_experts:
                    total += d * e_ff * self.n_shared_experts * 3
        if self.family == "encdec":
            # encoder layers (self-attn + dense ffn)
            enc = self.n_enc_layers * (
                d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
                + (self.d_ff * d * (3 if self.mlp_gated else 2)) + 3 * d)
            total += enc
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        for mixer, ffn in layer_kinds(self):
            if ffn == "moe":
                inactive = (self.n_experts - self.experts_per_token) * d * self.d_ff * 3
                total -= inactive
        return total


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Per-layer (mixer, ffn) for the decoder stack.

    mixer ∈ {attn, ssm};  ffn ∈ {dense, moe, none}.
    """
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            mixer = "ssm"
        elif cfg.family == "hybrid" and cfg.attn_every:
            mixer = "attn" if i % cfg.attn_every == cfg.attn_offset else "ssm"
        else:
            mixer = "attn"
        if cfg.n_experts and i % cfg.moe_every == cfg.moe_offset:
            ffn = "moe"
        elif cfg.family == "ssm":
            ffn = "none"       # mamba-1 blocks have no separate FFN
        else:
            ffn = "dense"
        kinds.append((mixer, ffn))
    return kinds


def block_period(cfg: ModelConfig) -> int:
    """Smallest p such that layer kinds repeat with period p and p | n_layers."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return n


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training / serving run parameters (input shape + distribution)."""
    global_batch: int = 256
    seq_len: int = 4096
    mode: str = "train"              # train | prefill | decode
    # decentralized training
    algorithm: str = "edm"
    alpha: float = 1e-3
    beta: float = 0.9
    topology: str = "ring"           # ring | exp | torus | full | hier
    agents: str = "data"             # data | pod  (DESIGN §3)
    gossip_engine: str = "shifts"    # dense | shifts | ppermute  (DESIGN §3)
    # time-varying gossip (DESIGN §4): static wraps `topology`; round_robin =
    # one-peer exp rounds; alt_hier = intra-pod rounds + one inter-pod round
    gossip_schedule: str = "static"  # static | round_robin | alt_hier
    gossip_period: int = 0           # alt_hier: intra rounds per inter (0→1)
    gossip_seed: int = 0             # round_robin: offset-order shuffle (0=off)
    agents_per_device: int = 1       # blocked ppermute: A > device count (§4)
    # packed parameter bus (DESIGN §5): params + EDM state live in one
    # (A, rows, 128) superbuffer — one edm_update pallas_call and one
    # ppermute per gossip term per step.  None = auto: on for the
    # algorithm="edm" + gossip_engine="ppermute" production path.
    packed_bus: Optional[bool] = None
    # overlapped gossip pipeline (DESIGN §6): "off" = synchronous gossip on
    # the critical path (bit-identical to the plain bus step); "delayed" =
    # one-step-stale mixing — the live payload's permutes are issued before
    # the backward pass and combined after it, so wire time hides behind
    # compute.  Requires the packed bus (the payload is ONE buffer).
    overlap: str = "off"             # off | delayed
    gossip_dtype: str = "float32"    # bf16 payload is a §Perf lever
    # quantized gossip wire (DESIGN §9): wire format of the bus permutes.
    # "bf16" / "int8" route the packed-bus step through the error-feedback
    # codec (bus-shaped residual in the opt state, decode folded into the
    # combine); "f32" is the byte-identical legacy wire.  Packed bus only;
    # mutually exclusive with gossip_dtype != float32 (the codec replaces
    # that cast lever and, unlike it, composes with overlap="delayed").
    wire: str = "f32"                # f32 | bf16 | int8
    gossip_every: int = 1            # gossip every k steps (local-EDM, §Perf)
    # policy groups (DESIGN §12): the single declarative entry point for
    # WHAT gossips, HOW OFTEN and at WHAT precision.  "" = one default
    # "dense" group (bit-identical to the ungrouped bus); presets
    # "moe[:k]" / "ssm[:k]" put expert / conv+SSM-state leaves in their
    # own group (k = that group's gossip_every, 0 = full opt-out); a JSON
    # list gives explicit specs: [{"name": ..., "match": [...],
    # "gossip_every": ..., "wire": ..., "schedule": ...}, ...].
    # Parsed by repro_torch.train.trainer.resolve_group_specs.
    gossip_groups: str = ""
    moe_sharding: bool = False       # explicit MoE dispatch constraints (§Perf)
    moe_impl: str = "gspmd"          # gspmd | shard_map  (§Perf serving path)
    attn_bf16_path: bool = False     # bf16 attention data path (§Perf)
    remat: bool = True
    remat_policy: str = "full"       # full | dots  (§Perf)
    seq_parallel: bool = False       # sequence-sharded residual (§Perf)
    warmup_steps: int = 0            # LR schedule (0 = constant α)
    total_steps: int = 0
    # serving
    decode_window: int = 0           # 0 → full KV cache; else sliding window


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (≤4 experts etc.)."""
    period = block_period(cfg)
    n_layers = max(n_layers, period)
    n_layers = (n_layers + period - 1) // period * period
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads else 0
    if n_kv and cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads  # keep MHA archs MHA
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=min(cfg.d_model, d_model),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64 if cfg.n_heads else 0,
        d_ff=min(cfg.d_ff, 2 * d_model) if cfg.d_ff else 0,
        dense_d_ff=min(cfg.dense_d_ff, 2 * d_model) if cfg.dense_d_ff else 0,
        vocab_size=min(cfg.vocab_size, vocab),
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        # dropless at smoke scale (C ≥ T·k/E · E/k): prefill↔decode must agree
        capacity_factor=8.0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_dt_rank=8 if cfg.ssm_state else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16),
        attn_every=min(cfg.attn_every, n_layers) if cfg.attn_every else 0,
        attn_offset=min(cfg.attn_offset, min(cfg.attn_every, n_layers) - 1)
        if cfg.attn_every else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **updates)

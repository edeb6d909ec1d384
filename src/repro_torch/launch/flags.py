"""Table-driven CLI ↔ :class:`~repro_torch.configs.base.RunConfig` mapping.

A copy of ``repro/launch/flags.py``: the same table of launcher flags, so
``python -m repro_torch.launch.train`` takes the reference launcher's
flags: ``--algorithm`` any name of ``ALGORITHMS``, ``--no-packed-bus``
the tree path.  Levers the port does not run yet parse as usual and are
rejected by :func:`repro_torch.train.trainer.resolve_features`.
"""
from __future__ import annotations

import argparse
import warnings
from typing import Any, Dict, Tuple

__all__ = ["RUN_FLAGS", "DEPRECATED_ALIASES", "add_run_flags",
           "run_config_overrides"]


# (flag, RunConfig field, add_argument kwargs) — the single source of truth
# for the flag → RunConfig mapping.  Flags not listed here (arch, steps,
# agent geometry, checkpoints) are launcher-local and never reach RunConfig
# directly.
RUN_FLAGS: Tuple[Tuple[str, str, Dict[str, Any]], ...] = (
    ("--algorithm", "algorithm", dict(
        default="edm",
        help="decentralized algorithm (e.g. edm, edm_ef, dsgd, dmsgd)")),
    ("--topology", "topology", dict(default="ring")),
    ("--gossip-engine", "gossip_engine", dict(
        default="shifts", choices=["dense", "shifts", "ppermute"],
        help="mixing engine; ppermute with --agents-per-device below "
             "--agents runs across ranks (under torchrun)")),
    ("--gossip-schedule", "gossip_schedule", dict(
        default="static", choices=["static", "round_robin", "alt_hier"],
        help="time-varying gossip schedule (DESIGN §4): round_robin = one "
             "permute/step one-peer exp rounds")),
    ("--gossip-period", "gossip_period", dict(
        type=int, default=0,
        help="alt_hier: intra-pod rounds per inter-pod round")),
    ("--gossip-seed", "gossip_seed", dict(
        type=int, default=0,
        help="round_robin: shuffle the offset order (0 = off)")),
    ("--agents-per-device", "agents_per_device", dict(
        type=int, default=1,
        help="blocked ppermute: agents per mesh device, so A > device "
             "count runs without the shifts fallback")),
    ("--packed-bus", "packed_bus", dict(
        default=None, action=argparse.BooleanOptionalAction,
        help="packed parameter bus (DESIGN §5): params + EDM state in one "
             "(A, rows, 128) superbuffer — one edm_update launch and one "
             "ppermute per gossip term per step.  Default: on for "
             "edm + ppermute")),
    ("--overlap", "overlap", dict(
        default="off", choices=["off", "delayed"],
        help="overlapped gossip pipeline (DESIGN §6): 'delayed' issues the "
             "double-buffered payload's permutes before the backward pass "
             "and combines after it (one-step-stale mixing; needs the "
             "packed bus), 'off' keeps gossip synchronous")),
    ("--wire", "wire", dict(
        default="f32", choices=["f32", "bf16", "int8"],
        help="gossip wire format (DESIGN §9): 'bf16'/'int8' quantize the "
             "bus permute payloads through the error-feedback codec (int8 "
             "carries per-block f32 scales; a bus-shaped residual rides in "
             "the opt state), cutting wire bytes 2x / ~4x at the f32 "
             "divergence floor.  Needs the packed bus; composes with "
             "--overlap delayed and --agents pod")),
    ("--gossip-groups", "gossip_groups", dict(
        default="",
        help="gossip policy groups (DESIGN §12): '' = one default group "
             "(bit-identical to the ungrouped bus); presets 'moe[:k]' / "
             "'ssm[:k]' put expert / conv+SSM-state leaves in their own "
             "group (k = group gossip_every, 0 = opt out of gossip); a "
             "JSON list ('[{\"name\": ..., \"match\": [...], "
             "\"gossip_every\": ..., \"wire\": ...}]') or '@file.json' "
             "gives explicit specs.  Needs the packed bus")),
    ("--gossip-every", "gossip_every", dict(
        type=int, default=1,
        help="gossip every k steps (local-EDM, §Perf); with "
             "--gossip-groups keep 1 and set per-group cadences instead")),
    ("--alpha", "alpha", dict(type=float, default=0.2)),
    ("--beta", "beta", dict(type=float, default=0.9)),
)

# deprecated alias → canonical flag; parses into the canonical dest with a
# DeprecationWarning, so old invocations keep working but cannot diverge.
DEPRECATED_ALIASES: Dict[str, str] = {
    "--optimizer": "--algorithm",
}


class _DeprecatedAlias(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        warnings.warn(
            f"{option_string} is deprecated; use {self.metavar}",
            DeprecationWarning, stacklevel=2)
        print(f"warning: {option_string} is deprecated; "
              f"use {self.metavar}")
        setattr(namespace, self.dest, values)


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def add_run_flags(ap: argparse.ArgumentParser) -> None:
    """Register every RunConfig-backed flag (plus deprecated aliases)."""
    canonical_dest = {}
    for flag, field, kwargs in RUN_FLAGS:
        ap.add_argument(flag, **kwargs)
        canonical_dest[flag] = _dest(flag)
    for alias, target in DEPRECATED_ALIASES.items():
        ap.add_argument(alias, dest=canonical_dest[target],
                        action=_DeprecatedAlias, metavar=target,
                        default=argparse.SUPPRESS,
                        help=f"deprecated alias for {target}")


def run_config_overrides(args: argparse.Namespace) -> Dict[str, Any]:
    """Parsed args → RunConfig constructor kwargs, straight off the table.
    ``--gossip-groups @file.json`` is dereferenced here."""
    out = {}
    for flag, field, _ in RUN_FLAGS:
        val = getattr(args, _dest(flag))
        if field == "gossip_groups" and isinstance(val, str) \
                and val.startswith("@"):
            with open(val[1:]) as f:
                val = f.read()
        out[field] = val
    return out

"""The port's gossip policy groups (DESIGN §12) against the JAX package's.

* Layout: for the same specs on ``smollm_360m``'s smoke tree the port's
  grouped layout equals the reference's field by field (groups: name, row,
  rows, slots, cadence, wire, schedule; every slot), the grouped bus packs
  byte-equal, and pack / unpack / ``leaf_views`` / ``pack_agent`` /
  ``unpack_agent`` round-trip with slots out of path order; the default
  layout is the ungrouped one; the cache is keyed on the specs.
* Specs and rules: ``group_specs_from_json`` and ``resolve_group_specs``
  agree with the reference on JSON lists and on the ``moe[:k]`` and
  ``ssm[:k]`` presets; an unknown preset raises ``ValueError``; each of
  the five composition rules raises.
* Mixer: ``make_group_mixer`` within rtol 1e-6 / atol 1e-6 of the
  reference's over steps 0–5 on a 4-group policy (opt-out; f32 ring
  every step; int8 every other step; bf16 on a ``round_robin`` override),
  the plain and the fused combine; opt-out and off-cadence rows bit-equal
  to the input.  The reference's group mixer hands a wired group its raw
  f32 rows where its engines take the codec's payload (an int8 group
  raises, a bf16 group mixes unquantized: ROADMAP §3), so the reference
  here is its ``make_group_mixer`` with the group's encode put in at the
  schedule-mixer seam; a test pins the fault itself.
* Byte model: ``group_wire_bytes_per_step`` equals the reference's for
  steps 0–7.
* Checkpoints: 1-group ↔ 2-group states, a grouped state ↔ the tree path
  and ``load_state_resized`` on a grouped layout, bit for bit.
* Churn: a group without a schedule override mixes the masked rounds, an
  overridden group its full rounds (as the reference builds it), each
  held against the dense engine's ``W`` of its round.

Inputs are made with numpy from seeds and fed to both packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import bus as jbus
from repro.core import mixing as jmix
from repro.core import schedule as jsched
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import bus_layout_for as jbus_layout_for
from repro.train import make_gossip_schedule as jmake_gossip_schedule
from repro.train import make_group_plans as jmake_group_plans
from repro.train import resolve_features as jresolve_features
from repro.train import resolve_group_specs as jresolve_group_specs

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import bus as tbus
from repro_torch.core import elastic as tel
from repro_torch.core import schedule as tsched
from repro_torch.core.mixing import make_group_mixer
from repro_torch.models import build_model
from repro_torch.train import (bus_layout_for, checkpoint, init_state,
                               make_gossip_schedule, make_group_plans,
                               resolve_features, resolve_group_specs)

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "smollm_360m"
A = 4
STEPS = 6

# the chip cell's policy: embeddings local, attention every step, the MLPs
# int8 every other step, the final norm bf16 on round_robin's rounds
POLICY = json.dumps([
    {"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},
    {"name": "attn", "match": ["|attn|"]},
    {"name": "ffn", "match": ["|ffn|"], "gossip_every": 2, "wire": "int8"},
    {"name": "norm", "match": ["final_ln"], "wire": "bf16",
     "schedule": "round_robin"}])
TWO_GROUPS = json.dumps([{"name": "attn", "match": ["|attn|"]}])
CATCH_ALL = json.dumps([{"name": "dense"}])
SPECS = {"policy": POLICY, "two": TWO_GROUPS, "catch_all": CATCH_ALL,
         "default": ""}


def _run_kw(groups="", **kw):
    base = dict(global_batch=A, seq_len=16, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", gossip_groups=groups, remat=False)
    base.update(kw)
    return base


def _layouts(groups):
    jrun, run = JRunConfig(**_run_kw(groups)), RunConfig(**_run_kw(groups))
    jl = jbus_layout_for(jbuild_model(get_smoke_config(ARCH)), A,
                         groups=jresolve_features(jrun).groups)
    tl = bus_layout_for(build_model(tget_smoke_config(ARCH)), A,
                        groups=resolve_features(run).groups)
    return jl, tl


def _same_group(tg, jg):
    assert (tg.name, tg.row, tg.rows, tg.slots, tg.gossip_every, tg.wire,
            tg.schedule, tg.elems) == (jg.name, jg.row, jg.rows, jg.slots,
                                       jg.gossip_every, jg.wire, jg.schedule,
                                       jg.elems)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_grouped_layout_matches_reference(name):
    jl, tl = _layouts(SPECS[name])
    assert (tl.rows, tl.block_rows, tl.is_grouped) == \
        (jl.rows, jl.block_rows, jl.is_grouped)
    assert len(tl.groups) == len(jl.groups)
    for tg, jg in zip(tl.groups, jl.groups):
        _same_group(tg, jg)
    for ts, js in zip(tl.slots, jl.slots):
        assert (ts.row, ts.rows, ts.shape, ts.size) == \
            (js.row, js.rows, js.shape, js.size)
    assert tl.is_grouped == (name in ("policy", "two"))


def test_policy_matches_every_leaf_and_leaves_dense_empty():
    _, tl = _layouts(POLICY)
    groups = {g.name: g for g in tl.groups}
    assert groups["dense"].rows == 0 and groups["dense"].slots == ()
    assert sum(len(g.slots) for g in tl.groups) == len(tl.paths) == 12
    rows = [tl.slots[i].row for g in tl.groups for i in g.slots]
    assert rows == sorted(rows)
    # slots are in group order, not path order
    assert [s.row for s in tl.slots] != sorted(s.row for s in tl.slots)


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jbuild_model(get_smoke_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: jnp.asarray(rng.normal(
        size=(A,) + s.shape).astype(np.float32)).astype(s.dtype), shapes)


@pytest.mark.parametrize("name", ["policy", "two"])
def test_grouped_pack_is_byte_equal_and_round_trips(name):
    jl, tl = _layouts(SPECS[name])
    tree = _jax_tree()
    want = np.asarray(jbus.pack_tree(jl, tree))
    flat = weights.params_from_tree(jax.tree.map(np.asarray, tree))
    bus = tbus.pack_tree(tl, flat)
    np.testing.assert_array_equal(bus.numpy(), want)
    back = tbus.unpack_tree(tl, bus)
    views = tbus.leaf_views(tl, bus)
    again = torch.zeros_like(bus)
    for a in range(A):
        one = tbus.unpack_agent(tl, bus, a)
        tbus.pack_agent(tl, again, a, one)
        for k, v in flat.items():
            assert torch.equal(one[k], v[a]), k
    assert torch.equal(again, bus)
    for k, v in flat.items():
        assert torch.equal(back[k], v), k
        assert torch.equal(views[k], v.float()), k
    # every group's tail pad is zero
    used = torch.zeros(tl.rows * 128, dtype=torch.bool)
    for s in tl.slots:
        used[s.row * 128:s.row * 128 + s.size] = True
    assert torch.count_nonzero(bus.view(A, -1)[:, ~used]) == 0


def test_default_layout_is_the_ungrouped_layout_and_cached():
    model = build_model(tget_smoke_config(ARCH))
    default = bus_layout_for(model, A)
    assert bus_layout_for(model, A) is default
    assert bus_layout_for(model, A + 3) is default      # A is stripped
    catch_all = bus_layout_for(model, A, groups=resolve_group_specs(
        RunConfig(**_run_kw(CATCH_ALL))))
    for lay in (default, catch_all):
        assert not lay.is_grouped
        assert [g.name for g in lay.groups] == ["dense"]
        assert lay.groups[0].slots == tuple(range(len(lay.paths)))
    assert (catch_all.slots, catch_all.rows) == (default.slots, default.rows)
    # the path-order packing: slot i right after slot i - 1
    row = 0
    for s in default.slots:
        assert s.row == row
        row += s.rows
    assert default.rows == -(-row // default.block_rows) * default.block_rows
    grouped = bus_layout_for(model, A, groups=resolve_group_specs(
        RunConfig(**_run_kw(TWO_GROUPS))))
    assert grouped is not default
    assert bus_layout_for(model, A, groups=resolve_group_specs(
        RunConfig(**_run_kw(TWO_GROUPS)))) is grouped


def test_make_layout_rules():
    tree = {"a|w": torch.zeros(2, 5), "b|w": torch.zeros(2, 300)}
    lay = tbus.make_layout(tree, block_rows=8, groups=(
        tbus.GroupSpec("b", ("b|",)), tbus.GroupSpec("rest")))
    assert [g.name for g in lay.groups] == ["b", "rest"]   # no extra dense
    assert [(g.row, g.rows) for g in lay.groups] == [(0, 8), (8, 8)]
    assert lay.slots[1].row == 0 and lay.slots[0].row == 8
    # first match wins; a callable matcher
    lay2 = tbus.make_layout(tree, block_rows=8, groups=(
        tbus.GroupSpec("any", lambda p: p.endswith("|w")),
        tbus.GroupSpec("b", ("b|",))))
    assert [g.slots for g in lay2.groups] == [(0, 1), (), ()]
    with pytest.raises(ValueError, match="duplicate"):
        tbus.make_layout(tree, block_rows=8, groups=(
            tbus.GroupSpec("x", ("a",)), tbus.GroupSpec("x", ("b",))))
    with pytest.raises(ValueError, match="gossip_every"):
        tbus.GroupSpec("x", gossip_every=-1)
    with pytest.raises(ValueError, match="wire"):
        tbus.GroupSpec("x", wire="fp8")


# ---------------------------------------------------------------------------
# specs and rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["policy", "two", "catch_all"])
def test_specs_from_json_match_reference(name):
    obj = json.loads(SPECS[name])
    for got, want in zip(tbus.group_specs_from_json(obj),
                         jbus.group_specs_from_json(obj)):
        assert (got.name, got.match, got.gossip_every, got.wire,
                got.schedule) == (want.name, want.match, want.gossip_every,
                                  want.wire, want.schedule)
    run = RunConfig(**_run_kw(SPECS[name]))
    jrun = JRunConfig(**_run_kw(SPECS[name]))
    assert [dataclass_tuple(s) for s in resolve_group_specs(run)] == \
        [dataclass_tuple(s) for s in jresolve_group_specs(jrun)]
    single = tbus.group_specs_from_json([{"name": "x", "match": "|ffn|"}])
    assert single[0].match == ("|ffn|",)


def dataclass_tuple(s):
    return (s.name, s.match, s.gossip_every, s.wire, s.schedule)


@pytest.mark.parametrize("preset", ["moe", "ssm", "moe:2", "ssm:0,moe"])
def test_family_presets_are_not_ported(preset):
    """Both family presets are ported now: ``moe[:k]`` and ``ssm[:k]``,
    alone or in a list, resolve as the reference's do."""
    run = RunConfig(**_run_kw(preset))
    want = jresolve_group_specs(JRunConfig(**_run_kw(preset)))
    assert [dataclass_tuple(s) for s in resolve_group_specs(run)] == \
        [dataclass_tuple(s) for s in want]


def test_unknown_preset_and_bad_json_raise():
    with pytest.raises(ValueError, match="unknown gossip-groups preset"):
        resolve_group_specs(RunConfig(**_run_kw("experts")))
    with pytest.raises(ValueError, match="name"):
        resolve_group_specs(RunConfig(**_run_kw('[{"match": ["x"]}]')))
    assert resolve_group_specs(RunConfig(**_run_kw(""))) == ()


@pytest.mark.parametrize("lever,match", [
    (dict(packed_bus=False), "packed bus"),
    (dict(gossip_every=2), "gossip_every"),
    (dict(overlap="delayed"), "overlap"),
    (dict(wire="int8"), "error-feedback wire"),
    (dict(gossip_dtype="bfloat16"), "gossip_dtype")])
def test_group_composition_rules_raise(lever, match):
    with pytest.raises(ValueError, match=match):
        resolve_features(RunConfig(**_run_kw(POLICY, **lever)))
    feats = resolve_features(RunConfig(**_run_kw(POLICY)))
    assert feats.packed_bus and len(feats.groups) == 4


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.fixture
def reference_encodes(monkeypatch):
    """The reference's ``make_group_mixer`` with each wired group's payload
    encoded before its engines see it (the codec's ``encode``, which the
    reference's group mixer leaves out)."""
    orig = jmix.make_schedule_mixer

    def with_encode(sched, engine="shifts", *args, wire=None, **kw):
        inner = orig(sched, engine, *args, wire=wire, **kw)
        if wire is None or wire.fmt == "f32":
            return inner
        return lambda tree, step=0: inner(wire.encode(tree), step)

    monkeypatch.setattr(jmix, "make_schedule_mixer", with_encode)


def _plans(groups, churn=None):
    jrun, run = JRunConfig(**_run_kw(groups)), RunConfig(**_run_kw(groups))
    jl, tl = _layouts(groups)
    jplans = jmake_group_plans(jrun, jl, jmake_gossip_schedule(jrun, A))
    tplans = make_group_plans(run, tl, make_gossip_schedule(
        run, A, churn=churn))
    return jl, tl, jplans, tplans


def _bus(layout, seed):
    return np.random.default_rng(seed).standard_normal(
        (A, layout.rows, 128)).astype(np.float32)


def _jax_mixer(jplans):
    mesh = make_gossip_mesh(A, agents_per_device=A)
    return jmix.make_group_mixer(jplans, engine="ppermute", mesh=mesh,
                                 agent_axes=gossip_agent_axes(mesh))


_REFERENCE_MIXES = []


def _reference_mixes():
    """The reference's mix of ``_bus(layout, step)`` at each step (made
    once, under ``reference_encodes``)."""
    if not _REFERENCE_MIXES:
        jl, _, jplans, _ = _plans(POLICY)
        jmixer = jax.jit(_jax_mixer(jplans), static_argnums=1)
        _REFERENCE_MIXES.extend(np.asarray(jmixer(jnp.asarray(_bus(jl, t)),
                                                  t)) for t in range(STEPS))
    return _REFERENCE_MIXES


@pytest.mark.parametrize("fused", [False, True])
def test_group_mixer_matches_reference(reference_encodes, fused):
    _, tl, _, tplans = _plans(POLICY)
    tmixer = make_group_mixer(tplans, engine="ppermute", agents_per_device=A,
                              use_fused_kernel=fused)
    groups = {g.name: g for g in tl.groups}
    emb, ffn = groups["embed"], groups["ffn"]
    for step, want in enumerate(_reference_mixes()):
        x = _bus(tl, step)
        out = torch.full(x.shape, 7.0)
        got = tmixer(torch.from_numpy(x), step, out=out)
        assert got is out
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {step}")
        rows = slice(emb.row, emb.row + emb.rows)
        np.testing.assert_array_equal(got.numpy()[:, rows], x[:, rows])
        rows = slice(ffn.row, ffn.row + ffn.rows)
        if step % 2 == 0:
            np.testing.assert_array_equal(got.numpy()[:, rows], x[:, rows])
        else:
            assert not np.array_equal(got.numpy()[:, rows], x[:, rows])
    assert tmixer(torch.from_numpy(x), 1).shape == x.shape   # out=None


def test_reference_group_mixer_skips_the_wire_encode():
    """The reference's fault: its group mixer passes a wired group's raw
    f32 rows to engines that take the codec's payload — an int8 group
    fails to unpack (q, scale), a bf16 group mixes unquantized (equal to
    the f32 group)."""
    jl, _, jplans, _ = _plans(POLICY)
    x = jnp.asarray(_bus(jl, 0))
    with pytest.raises(ValueError, match="unpack"):
        _jax_mixer(jplans)(x, 1)
    norm = next(p for p in jplans if p.group.name == "norm")
    whole = jbus.BusGroup("all", 0, jl.rows, ())
    bf16 = _jax_mixer([jmix.GroupPlan(whole, norm.sched, norm.wire)])
    f32 = _jax_mixer([jmix.GroupPlan(whole, norm.sched, None)])
    np.testing.assert_array_equal(np.asarray(bf16(x, 0)),
                                  np.asarray(f32(x, 0)))


def test_group_mixer_rejects_gaps_and_wrong_buses():
    _, tl, _, tplans = _plans(POLICY)
    with pytest.raises(ValueError, match="contiguous"):
        make_group_mixer(tplans[1:], agents_per_device=A)
    mix = make_group_mixer(tplans, agents_per_device=A)
    with pytest.raises(ValueError, match="buses"):
        mix(torch.zeros(A, tl.rows - 8, 128))


# ---------------------------------------------------------------------------
# the byte model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,b", [("ppermute", 1), ("ppermute", 2),
                                      ("shifts", 1), ("dense", 1)])
def test_group_wire_bytes_match_reference(engine, b):
    jl, tl, jplans, tplans = _plans(POLICY)
    jscheds = {p.group.name: p.sched for p in jplans if p.sched}
    tscheds = {p.group.name: p.sched for p in tplans if p.sched}
    jcodecs = {p.group.name: p.wire for p in jplans if p.wire}
    tcodecs = {p.group.name: p.wire for p in tplans if p.wire}
    for step in range(8):
        want = jsched.group_wire_bytes_per_step(
            jl.groups, jscheds, step, agents_per_device=b, engine=engine,
            codecs=jcodecs)
        got = tsched.group_wire_bytes_per_step(
            tl.groups, tscheds, step, agents_per_device=b, engine=engine,
            codecs=tcodecs)
        assert got == want, step
        assert got["embed"] == 0 and got["dense"] == 0
        assert (got["ffn"] == 0) == (step % 2 == 0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(groups, packed=True, seed=0):
    model = build_model(tget_smoke_config(ARCH))
    run = RunConfig(**_run_kw(groups, packed_bus=packed))
    state = init_state(model, run, A, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    lay = bus_layout_for(model, A, resolve_features(run).groups)

    def noise(bus):        # distinct agents and slots, pads kept zero
        tree = tbus.unpack_tree(lay, bus)
        tree = {k: (v.float() + torch.randn(v.shape, generator=gen)
                    ).to(v.dtype) for k, v in tree.items()}
        return tbus.pack_tree(lay, tree)

    if packed:
        state = {"params": noise(state["params"]),
                 "opt": {k: noise(v) for k, v in state["opt"].items()},
                 "step": 3}
    return state, lay


def test_checkpoint_cross_group_layouts(tmp_path):
    s1, l1 = _state("")
    s2, l2 = _state(POLICY)
    assert l1.rows != l2.rows
    p1 = str(tmp_path / "one.npz")
    checkpoint.save_state(p1, s1, layout=l1)
    got2 = checkpoint.load_state(p1, s2, layout=l2)
    want2 = tbus.pack_tree(l2, tbus.unpack_tree(l1, s1["params"]))
    assert torch.equal(got2["params"], want2) and got2["step"] == 3
    p2 = str(tmp_path / "two.npz")
    checkpoint.save_state(p2, got2, layout=l2)
    back = checkpoint.load_state(p2, s1, layout=l1)
    for k in ("m", "psi"):
        assert torch.equal(back["opt"][k], s1["opt"][k]), k
    assert torch.equal(back["params"], s1["params"])
    # a grouped state and the tree path read each other's files
    tree, _ = _state("", packed=False)
    as_tree = checkpoint.load_state(p2, tree)
    for path, v in tbus.unpack_tree(l2, got2["params"]).items():
        assert torch.equal(as_tree["params"][path], v), path
    p3 = str(tmp_path / "tree.npz")
    checkpoint.save_state(p3, as_tree)
    assert torch.equal(checkpoint.load_state(p3, s2, layout=l2)["params"],
                       got2["params"])
    # resized onto 3 agents under the grouped layout: survivors exact
    like3 = {"params": torch.empty((3,) + tuple(s2["params"].shape[1:])),
             "opt": {k: torch.empty((3,) + tuple(v.shape[1:]))
                     for k, v in s2["opt"].items()}, "step": 0}
    small = checkpoint.load_state_resized(p2, like3, layout=l2)
    assert torch.equal(small["params"], got2["params"][:3])
    assert torch.equal(small["opt"]["psi"], got2["opt"]["psi"][:3])


# ---------------------------------------------------------------------------
# churn with groups
# ---------------------------------------------------------------------------

CHURN = {"n_agents": A, "epochs": [{"start": 0, "down": []},
                                   {"start": 2, "down": [3]},
                                   {"start": 4, "down": []}]}
CHURN_POLICY = json.dumps([
    {"name": "attn", "match": ["|attn|"]},
    {"name": "ffn", "match": ["|ffn|"], "schedule": "round_robin"}])


def test_churn_masks_groups_without_an_override_only():
    _, tl, _, tplans = _plans(CHURN_POLICY, churn=CHURN)
    plans = {p.group.name: p for p in tplans}
    assert isinstance(plans["attn"].sched, tel.ElasticSchedule)
    assert not isinstance(plans["ffn"].sched, tel.ElasticSchedule)
    for fused in (False, True):
        mix = make_group_mixer(tplans, agents_per_device=A,
                               use_fused_kernel=fused)
        for step in range(6):
            x = torch.from_numpy(_bus(tl, 10 + step))
            got = mix(x, step)
            for name, p in plans.items():
                g = p.group
                rows = slice(g.row, g.row + g.rows)
                W = torch.from_numpy(p.sched.round(step).dense_matrix()
                                     ).float()
                want = (W @ x[:, rows].reshape(A, -1)).view(
                    A, g.rows, 128)
                np.testing.assert_allclose(got[:, rows].numpy(),
                                           want.numpy(), rtol=1e-6,
                                           atol=1e-6, err_msg=f"{name} "
                                           f"step {step} fused {fused}")
            degraded = 2 <= step < 4
            W_attn = plans["attn"].sched.round(step).dense_matrix()
            assert (W_attn[3, 3] == 1.0) == degraded
            assert plans["ffn"].sched.round(step).dense_matrix()[3, 3] < 1

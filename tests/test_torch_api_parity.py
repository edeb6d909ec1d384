"""The last public functions of the JAX package that the port lacked,
held against it on the CPU:

* ``core/topology.py``: ``spectral_stats`` (and ``Topology.spectral_gap``)
  on a ring, an exponential graph, a torus, a hierarchical and a
  disconnected topology and a masked round, to 1e-12;
* ``core/bus.py``: ``layout_of`` on ``smollm_360m`` at full width and 2
  layers, with and without ``block_rows``, with ``shards=2`` and with
  ``chip_smoke.py`` phase 14's policy groups: paths, rows, and every
  slot's offset, rows, shape, size and dtype equal (and the trainer's
  ``bus_layout_for`` the same layout);
* ``configs``: ``all_configs()``, names and every field;
* ``models/attention.py``: ``sdpa_ref`` on seeded bf16 inputs (causal,
  windowed, ragged ``kv_len``) within 2e-5 + 2⁻⁷·|want| of the
  reference's, with the reference's ``set_bf16_path`` at its default
  (off): the port has no such switch, as nothing of it reads
  ``attn_bf16_path``.

Inputs are made with numpy from seeds and fed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bus as jbus
from repro.core import elastic as jel
from repro.core import topology as jtopo
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model

from repro_torch import configs as tconfigs
from repro_torch.core import bus as tbus
from repro_torch.core import elastic as tel
from repro_torch.core import topology as ttopo
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild_model
from repro_torch.train import bus_layout_for

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "smollm_360m"
A = 4
# phase 14's policy groups (chip_smoke.py GROUP_POLICY)
POLICY = [
    {"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},
    {"name": "attn", "match": ["|attn|"]},
    {"name": "ffn", "match": ["|ffn|"], "gossip_every": 2, "wire": "int8"},
    {"name": "norm", "match": ["final_ln"], "wire": "bf16",
     "schedule": "round_robin"}]


def _topologies(mod, el):
    """The same rounds built by one package (``mod`` its topology module,
    ``el`` its elastic one)."""
    alive = np.ones(8, bool)
    alive[[2, 5]] = False
    return {"ring": mod.ring(8), "exp": mod.exp_graph(8),
            "torus": mod.torus2d(2, 4), "hier": mod.hierarchical(2, 4),
            "disconnected": mod.disconnected(8),
            "masked": el.degrade_round(mod.ring(8), alive)}


@pytest.mark.parametrize("case", ["ring", "exp", "torus", "hier",
                                  "disconnected", "masked"])
def test_spectral_stats_match_reference(case):
    got = ttopo.spectral_stats(_topologies(ttopo, tel)[case])
    want = jtopo.spectral_stats(_topologies(jtopo, jel)[case])
    assert sorted(got) == sorted(want) == ["gap", "lambda", "min_eig", "n",
                                           "name"]
    assert (got["name"], got["n"]) == (want["name"], want["n"])
    for k in ("lambda", "gap", "min_eig"):
        assert isinstance(got[k], float)
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    topo = _topologies(ttopo, tel)[case]
    assert topo.spectral_gap() == 1.0 - topo.lam()


def _models():
    cfg = dataclasses.replace(jconfigs.get_config(ARCH), n_layers=2)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=2)
    return jbuild_model(cfg), tbuild_model(tcfg)


LAYOUTS = {"default": {}, "block_rows": dict(block_rows=64),
           "shards": dict(shards=2), "groups": dict(groups=POLICY)}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_of_matches_reference(case):
    jmodel, tmodel = _models()
    kw = dict(LAYOUTS[case])
    jkw, tkw = dict(kw), dict(kw)
    if "groups" in kw:
        jkw["groups"] = jbus.group_specs_from_json(kw["groups"])
        tkw["groups"] = tbus.group_specs_from_json(kw["groups"])
    jl = jbus.layout_of(jmodel, A, **jkw)
    tl = tbus.layout_of(tmodel, A, **tkw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert list(tl.paths) == jbus.leaf_paths(shapes)
    assert (tl.rows, tl.block_rows, tl.shards, tl.is_grouped) == \
        (jl.rows, jl.block_rows, jl.shards, jl.is_grouped)
    assert str(tl.dtype).split(".")[1] == jnp.dtype(jl.dtype).name
    assert len(tl.slots) == len(jl.slots)
    for path, ts, js in zip(tl.paths, tl.slots, jl.slots):
        assert (ts.row, ts.rows, ts.shape, ts.size) == \
            (js.row, js.rows, tuple(js.shape), js.size), path
        assert str(ts.dtype).split(".")[1] == jnp.dtype(js.dtype).name, path
    assert [(g.name, g.row, g.rows, g.slots) for g in tl.groups] == \
        [(g.name, g.row, g.rows, tuple(g.slots)) for g in jl.groups]
    if "block_rows" not in kw:    # the trainer's layout is the same one
        assert bus_layout_for(tmodel, A, groups=tkw.get("groups", ()),
                              shards=kw.get("shards", 1)) is tl
    # shape-only: no leaf of the model is allocated
    assert all(t.device.type == "meta" for t in tmodel.meta().values())


def test_all_configs_match_reference():
    got, want = tconfigs.all_configs(), jconfigs.all_configs()
    assert sorted(got) == sorted(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == \
            dataclasses.asdict(want[name]), name


SDPA = {"causal": dict(causal=True, Sq=12),
        "window": dict(causal=True, window=5, Sq=12),
        "ragged": dict(causal=True, Sq=1, q_offset=11,
                       kv_len=np.array([4, 12], np.int32))}


@pytest.mark.parametrize("case", sorted(SDPA))
def test_sdpa_ref_matches_reference(case):
    kw = dict(SDPA[case])
    Sq = kw.pop("Sq")
    rng = np.random.default_rng(sorted(SDPA).index(case))
    shapes = ((2, Sq, 6, 32), (2, 12, 2, 32), (2, 12, 2, 32))
    # bf16 values, exact in f32, fed to both packages
    qkv = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 2)
           .to(torch.bfloat16) for s in shapes]
    jqkv = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in qkv]
    tkw = dict(kw)
    if "kv_len" in kw:
        tkw["kv_len"] = torch.from_numpy(kw["kv_len"])
    got = tattn.sdpa_ref(*qkv, **tkw)
    want = jattn.sdpa_ref(*jqkv, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(g - w) <= 2e-5 + 2.0 ** -7 * np.abs(w)), \
        np.max(np.abs(g - w))

"""The peer table's wire and block forms on the CPU: the plain versions of
the multi-rank combines (``table_peer_ref`` on f32 and bf16 ``(B, rows,
128)`` blocks, ``table_peer_q8_ref`` on the int8 wire) against the port's
one-device plain versions and the JAX package's ``gossip_axpy_wire``, and
the routing that sends the wires, agent blocks and row shards to them on
the card.  The CUDA kernels against these plain versions, at 2 and 4
ranks on the card, are in ``test_torch_cuda.py``.

Payloads are made with numpy from a seed, NaN and ±Inf among them (the
int8 wire's in its scales).  The rounds: a ±1 ring, an exponential graph,
the ring with its slot 1 late (the late source swapped for the agent
itself, as the overlap pipeline does) and the ring with one agent down (a
masked round: per-agent sources and weights), at one and two agents a
rank over four ranks.

Tolerances, with the reason:
* against the one-device plain versions: bit for bit (a NaN matching a
  NaN) — the same terms in the same order with the same f32 roundings,
  each int8 coefficient one f32 product ``w · scale``;
* against JAX's ``gossip_axpy_wire`` (Pallas, ``interpret=True``) on the
  permuted payloads: within ``1e-6 · Σₖ|wₖ · decode(payloadₖ)|``, as
  ``tests/test_torch_wire.py`` holds the one-device combine (XLA may
  contract a product into an FMA where the port rounds it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.core import elastic as tel
from repro_torch.core import mixing as tmix
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core.comm import GossipMesh
from repro_torch.core.wire import make_codec
from repro_torch.kernels import ops, ref
from repro_torch.kernels.table_peer import MAX_BLOCK

torch.set_num_threads(1)  # xdist workers share the cores

RANKS = 4
ROWS = 16
BR = 8                     # block_rows: two scale tiles an agent
ROUNDS = ("ring", "exp", "late", "masked")


def _round(case: str, A: int):
    """``(src, w)`` ``(K, A)`` tables of a test round over A agents."""
    if case == "exp":
        return tmix.round_tables(ttopo.exp_graph(A))
    if case == "masked":
        alive = np.ones(A, bool)
        alive[A - 1] = False
        return tmix.round_tables(tel.degrade_round(ttopo.ring(A), alive))
    src, w = tmix.round_tables(ttopo.ring(A))
    if case == "late":           # slot 1 late: the agent's own payload
        src = src.copy()
        src[1] = np.arange(A, dtype=src.dtype)
    return src, w


def _payloads(A: int, dtype, seed: int, specials=True) -> torch.Tensor:
    """``(A, ROWS, 128)`` seeded values, NaN and ±Inf in every agent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(A, ROWS, 128)).astype(np.float32)
    if specials:
        for a in range(A):
            x[a].flat[rng.choice(ROWS * 128, 3, replace=False)] = \
                (np.nan, np.inf, -np.inf)
    return torch.from_numpy(x).to(dtype)


def _wire(A: int, seed: int, specials=True):
    """An int8 wire payload ``(q, scale)`` of A agents; NaN and ±Inf in
    some scales."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, size=(A, ROWS, 128))
                         .astype(np.int8))
    scale = rng.uniform(1e-3, 1.0, size=(A, ROWS // BR)).astype(np.float32)
    if specials:
        scale[0, 0], scale[1, 1], scale[-1, 0] = np.nan, np.inf, -np.inf
    return q, torch.from_numpy(scale)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape, (got.shape, want.shape)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


def _ranks(x, B):
    """Rank j's ``(B, ...)`` block of every component of ``x``."""
    return [tuple(t[j * B:(j + 1) * B] for t in x) if isinstance(x, tuple)
            else x[j * B:(j + 1) * B] for j in range(RANKS)]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("case", ROUNDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_peer_plain_equals_one_device_plain(dtype, case, B):
    """Every rank's block form (f32, and the bf16 wire's decode-combine)
    bit-equal to the one-device table combine's rows of its agents, f32
    out; on an unmasked round also to ``gossip_axpy_ref`` over the
    gathered payloads (the one-device engine's permuted terms)."""
    A = RANKS * B
    x = _payloads(A, dtype, seed=B * 10 + ROUNDS.index(case))
    src, w = _round(case, A)
    whole = ref.table_combine_ref(x, src, w, out_dtype=torch.float32)
    per_term = None
    if case != "masked":
        per_term = ref.gossip_axpy_ref(
            [x.index_select(0, torch.from_numpy(src[k]).long())
             for k in range(src.shape[0])],
            [float(v) for v in w[:, 0]], out_dtype=torch.float32)
    pays = _ranks(x, B)
    for i in range(RANKS):
        cols = slice(i * B, (i + 1) * B)
        got = ref.table_peer_ref(pays, src[:, cols], w[:, cols])
        assert _same_bits(got, whole[cols]), (case, i)
        if per_term is not None:
            assert _same_bits(got, per_term[cols]), (case, i)
        # the dispatching op takes the plain version on the CPU
        assert _same_bits(ops.table_peer(pays, src[:, cols], w[:, cols]),
                          got)
        if B == 1:    # a (K,) table of ranks is the one-agent form
            assert _same_bits(ref.table_peer_ref(
                pays, list(src[:, i]), list(w[:, i])), got)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("case", ROUNDS)
def test_table_peer_q8_plain_equals_one_device_plain(case, B):
    """Every rank's int8 form bit-equal to the one-device fused engines'
    plain q8 combines on the same payload: ``table_combine_wire`` (the
    table gathers the rows and scales, ``w[k, a] · scale`` per tile) on
    every round, and on an unmasked round ``gossip_axpy_wire`` over the
    permuted payloads (``wire_coefs``)."""
    A = RANKS * B
    codec = make_codec("int8", BR)
    q, scale = _wire(A, seed=100 + B * 10 + ROUNDS.index(case))
    src, w = _round(case, A)
    whole = ops.table_combine_wire((q, scale), torch.from_numpy(src),
                                   torch.from_numpy(w), fmt="int8",
                                   block_rows=BR)
    per_term = None
    if case != "masked":
        pays = [codec.map_payload(
            lambda t, k=k: t.index_select(0, torch.from_numpy(src[k]).long()),
            (q, scale)) for k in range(src.shape[0])]
        per_term = ops.gossip_axpy_wire(pays, [float(v) for v in w[:, 0]],
                                        fmt="int8", block_rows=BR)
    qs, scales = zip(*_ranks((q, scale), B))
    for i in range(RANKS):
        cols = slice(i * B, (i + 1) * B)
        got = ref.table_peer_q8_ref(qs, scales, src[:, cols], w[:, cols],
                                    block_rows=BR)
        assert _same_bits(got, whole[cols]), (case, i)
        if per_term is not None:
            assert _same_bits(got, per_term[cols]), (case, i)
        assert _same_bits(ops.table_peer_q8(qs, scales, src[:, cols],
                                            w[:, cols], block_rows=BR), got)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("case,B", [("ring", 1), ("exp", 1), ("late", 1),
                                    ("masked", 1), ("ring", 2)])
def test_peer_wire_plain_matches_jax_gossip_axpy_wire(fmt, case, B):
    """Rank 1's combine of the wire against the JAX package's
    ``gossip_axpy_wire`` (its Pallas kernels in interpret mode) on the
    payloads the reference's permutes would bring it (a column's weights
    are one scalar a term there: every agent of the rank shares them)."""
    A = RANKS * B
    codec = make_codec(fmt, BR)
    x = _payloads(A, torch.float32, seed=7 + B, specials=False)
    payload = codec.encode(x)
    src, w = _round(case, A)
    i = 1
    cols = slice(i * B, (i + 1) * B)
    assert np.all(w[:, cols] == w[:, cols][:, :1])
    weights = [float(v) for v in w[:, i * B]]
    terms = [codec.map_payload(
        lambda t, k=k: t.index_select(0, torch.from_numpy(src[k, cols]).long()),
        payload) for k in range(src.shape[0])]
    want = np.asarray(jops.gossip_axpy_wire(
        [tuple(jnp.asarray(c.numpy()) for c in codec.payload_leaves(t))
         if fmt == "int8" else jnp.asarray(t.float().numpy()).astype(
             jnp.bfloat16) for t in terms],
        weights, fmt=fmt, block_rows=BR, interpret=True))
    ranks = _ranks(payload, B)
    if fmt == "int8":
        qs, scales = zip(*ranks)
        got = ref.table_peer_q8_ref(qs, scales, src[:, cols], w[:, cols],
                                    block_rows=BR)
    else:
        got = ref.table_peer_ref(ranks, src[:, cols], w[:, cols])
    mag = sum(abs(wk) * np.abs(codec.decode(t).numpy())
              for wk, t in zip(weights, terms))
    assert got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mag + 1e-30)


# ---------------------------------------------------------------------------
# routing: which gossip a rank takes on the card
# ---------------------------------------------------------------------------

def _mesh(shape, names, n_agents, B=1, shards=1, hosts=None):
    """A grid seen from rank 0 on ``cuda`` (no process group: routing reads
    the grid only)."""
    n = int(np.prod(shape))
    coords = (0,) * len(shape)
    slices = tuple(tuple(range(0, n, n // shape[0]))[:shape[0]] if ax == 0
                   else tuple(range(shape[-1])) for ax in range(len(shape)))
    return GossipMesh(tuple(shape), tuple(names), n_agents, B, shards, 0,
                      coords, slices, (None,) * len(shape), None, None,
                      torch.device("cuda"), "gloo", True,
                      tuple(hosts or ["h0"] * n))


def _routes(sched, mesh, **kw):
    return tmix.rank_routes(sched, mesh, "cuda", use_fused_kernel=True, **kw)


def test_rank_routes_send_wires_blocks_and_shards_to_the_peer_kernels():
    """On one host's card: the bf16 wire takes the peer table, the int8
    wire the peer q8 kernel (a ±1 ring round included), a block of 2
    agents a rank the table (masked rounds included), a pod's row shard
    the peer ring on its ``pod`` slice and the table on other rounds;
    f32 at one agent a rank is unchanged."""
    flat = _mesh((4,), ("data",), 4)
    ring4, rr4 = tsched.StaticSchedule(ttopo.ring(4)), tsched.RoundRobinExp(4)
    for wire, route in ((None, "table_peer"), ("bf16", "table_peer"),
                        ("int8", "table_peer_q8")):
        codec = make_codec(wire, BR) if wire else None
        want = "ring_peer" if wire is None else route
        # round_robin's offset-1 round is a one-sided ring, offset 2 a hop
        assert _routes(rr4, flat, wire=codec) == [want, route]
        assert _routes(ring4, flat, wire=codec) == [want]
        assert _routes(ring4, flat, wire=codec, overlap=True) == [want]
    blocked = _mesh((2,), ("data",), 4, B=2)
    ring4_down = tsched.StaticSchedule(
        tel.degrade_round(ttopo.ring(4), [True, True, True, False]))
    for sched in (ring4, ring4_down):
        assert _routes(sched, blocked) == ["table_peer"]
        assert _routes(sched, blocked,
                       wire=make_codec("int8", BR)) == ["table_peer_q8"]
    pods = _mesh((2, 2), ("pod", "data"), 2, shards=2)
    assert tmix.axes_group(pods, "pod")[0] == (0, 2)
    assert _routes(tsched.StaticSchedule(ttopo.ring(2)), pods,
                   shard_axes="data") == ["ring_peer"]
    assert _routes(tsched.StaticSchedule(ttopo.ring(2)), pods,
                   shard_axes="data",
                   wire=make_codec("int8", BR)) == ["table_peer_q8"]
    assert _routes(tsched.StaticSchedule(
        tel.degrade_round(ttopo.ring(2), [True, False])), pods,
        shard_axes="data") == ["table_peer"]
    # the CPU and an unfused combine take the permutes
    assert tmix.rank_routes(rr4, flat, "cpu", use_fused_kernel=True,
                            wire=make_codec("int8", BR)) == ["permutes"] * 2
    assert tmix.rank_routes(rr4, flat, "cuda", use_fused_kernel=False) == \
        ["permutes"] * 2


def test_table_and_ring_refusals():
    """What stays refused: more than 16 ranks, ranks on two hosts, more
    than ``MAX_BLOCK`` agents a rank, a payload of no spec (a tree whose
    leaves are not the rank's B agents, a tree of int leaves, a bf16
    payload under the int8 wire); the ring takes no wire and no block.  A
    tree of the rank's B agents' f32 leaves is a table payload."""
    int8 = make_codec("int8", BR)
    big = _mesh((17,), ("data",), 17)
    assert "at most 16" in tmix._table_unfit(big, None, ("data",), 1, None,
                                             None)
    assert _routes(tsched.StaticSchedule(ttopo.exp_graph(17)), big,
                   wire=int8) == ["permutes"]
    two = _mesh((4,), ("data",), 4, hosts=["h0", "h0", "h1", "h1"])
    assert "one host" in tmix._table_unfit(two, None, ("data",), 1, None,
                                           int8)
    flat = _mesh((4,), ("data",), 4)
    assert "agents a rank" in tmix._table_unfit(
        flat, None, ("data",), MAX_BLOCK + 1, None, None)
    tree = {"w": torch.zeros(2, 3)}
    assert tmix._table_unfit(flat, tree, ("data",), 2, None, None) == ""
    assert "agents'" in tmix._table_unfit(flat, tree, ("data",), 3, None,
                                          None)
    assert "agents'" in tmix._table_unfit(
        flat, {"w": torch.zeros(2, 3, dtype=torch.int32)}, ("data",), 2,
        None, None)
    bad = torch.zeros(1, ROWS, 128, dtype=torch.bfloat16)
    assert "int8" in tmix._table_unfit(flat, (bad, bad), ("data",), 1,
                                       None, int8)
    q, scale = _wire(2, seed=0)
    assert tmix._table_unfit(flat, (q, scale), ("data",), 2, None,
                             int8) == ""
    ring = ttopo.ring(4)
    assert "f32" in tmix._peer_unfit(ring, flat, None, ("data",), 1, None,
                                     int8)
    assert "one agent" in tmix._peer_unfit(ring, _mesh((2,), ("data",), 4,
                                                       B=2),
                                           None, ("data",), 2, None, None)
    assert tmix._peer_unfit(ttopo.ring(2), _mesh((2, 2), ("pod", "data"), 2,
                                                 shards=2),
                            None, ("pod",), 1, "data", None) == ""


def test_peer_operands_refuse_what_the_kernels_cannot_take():
    """The operand checks every device makes: a table of the wrong width,
    a source outside the ranks, more than 16 distinct blocks, scales of
    the wrong shape, an output that overlaps a block the combine reads."""
    x = _payloads(RANKS * 2, torch.float32, seed=1, specials=False)
    pays = _ranks(x, 2)
    with pytest.raises(ValueError, match=r"\(K, 2\)"):
        ops.table_peer(pays, [0, 1], [0.5, 0.5])
    with pytest.raises(ValueError, match="not one of the 8 agents"):
        ops.table_peer(pays, [[0, 8]], [[0.5, 0.5]])
    with pytest.raises(ValueError, match="overlaps"):
        ops.table_peer(pays, [[0, 1]], [[1.0, 1.0]], out=pays[0])
    many = [torch.zeros(2, 8, 128) for _ in range(9)]
    with pytest.raises(ValueError, match="distinct source blocks"):
        ops.table_peer(many, [[2 * k, 2 * k + 1] for k in range(9)],
                       [[1 / 9, 1 / 9]] * 9)
    q, scale = _wire(RANKS * 2, seed=2)
    qs, scales = zip(*_ranks((q, scale), 2))
    with pytest.raises(ValueError, match="scales"):
        ops.table_peer_q8(qs, [s[:, :1] for s in scales], [[0, 1]],
                          [[1.0, 1.0]], block_rows=BR)
    # the combine counts no launch on the CPU
    before = ops.launch_counts()
    ops.table_peer_q8(qs, scales, [[0, 1]], [[1.0, 1.0]], block_rows=BR)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_wire_encoders_write_into_given_buffers(fmt):
    """Across ranks on the card the wire's encoders write their payload
    straight into the peer table's slot: the fused EF update
    (``payload_out``), the overlap's EF encode and a group's stateless
    encode, each into given buffers, equal to their fresh payloads (and
    the EF state alike)."""
    from repro_torch.core.mixing import encode_rows
    from repro_torch.train.trainer import _encode_ef_agents
    codec = make_codec(fmt, BR)
    x, g, m, psi, e = (_payloads(2, torch.float32, seed=s, specials=False)
                       for s in range(5))

    def bufs():
        return codec.map_payload(torch.empty_like, codec.encode(x))

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(
            codec.payload_leaves(a), codec.payload_leaves(b)))

    fresh = ops.edm_update_bus_ef(x, g, m.clone(), psi.clone(), e.clone(),
                                  alpha=0.2, beta=0.9, fmt=fmt,
                                  block_rows=BR)
    into = bufs()
    got = ops.edm_update_bus_ef(x, g, m.clone(), psi.clone(), e.clone(),
                                alpha=0.2, beta=0.9, fmt=fmt, block_rows=BR,
                                payload_out=into)
    assert same(got[2], fresh[2]) and same(into, fresh[2])
    for a, b in zip(got[:2] + got[3:], fresh[:2] + fresh[3:]):
        assert torch.equal(a, b)
    e1, e2, into = e.clone(), e.clone(), bufs()
    want = _encode_ef_agents(codec, x, e1)
    assert same(_encode_ef_agents(codec, x, e2, into), want)
    assert same(into, want) and torch.equal(e1, e2)
    into = bufs()
    assert same(encode_rows(codec, x, into), encode_rows(codec, x))
    assert same(into, encode_rows(codec, x))

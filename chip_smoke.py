#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and ``nvidia-smi`` name and power limit; no CUDA
   device is an error;
2. build: compiles the port's CUDA kernels from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` (one ``nvcc`` per
   source, in parallel) and prints each kernel's registers, spills and
   static shared memory (``-Xptxas -v``), the redesigned attention
   kernels' dynamic shared memory a block, and the paged decode kernel's
   cluster (blocks a cluster, keys a block) at phase 7's timed shape;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at small odd ones, bit for bit, with its
   median device time over 20 launches (CUDA events; every timed run of
   launches is queued behind a device-side spin, so a kernel faster than
   its Python launch path is not timed at the host's pace), the plain
   version's time
   and the bound (bytes moved at 3.35 TB/s, or f32 operations at
   67 TFLOP/s, whichever is larger); then the wire kernels the same way:
   the fused EDM + bf16 / int8 EF update at the full bus (timed, in place
   as the main path calls it; the plain version one agent at a time to fit
   the card) and on buses of edge tiles (all zero, NaN, ±Inf beside finite
   values, ±Inf in an all-zero tile, tiny magnitudes, exact rounding
   ties), in place and out of place; the int8 dequantize-combine as the
   ring's 3-ary case at full width (timed) and at arities 1, 2, 5 and 16.
   "Bit for bit" lets a NaN match any NaN.  Each combine (here the 3-ary
   f32 combine and the q8 combine, in 3r the ring kernel, in 3m the table
   kernel) also runs on a policy group's rows of the full bus — phase
   14's attention rows, at a nonzero offset, the rest of the bus NaN —
   read and written in place (an agent stride): bit-equal to its plain
   version on the same view, no other output row written, equal to the
   same call on contiguous copies of the rows, both timed;
3r. the ring combine (the rolls fused in, kernel 8's counterpart)
   against its plain version (the rolls, then the weighted sum), bit for
   bit: at the full bus, timed beside the plain version, its bound (one
   read and one write of the bus at 3.35 TB/s) and one
   ``torch.matmul(W, x.view(A, -1))`` (the same function as one library
   call; the port never calls it); at the full bus with NaN and ±Inf; at
   A ∈ {1, 2, 3, 8, 32} with odd row counts, plain and with NaN / ±Inf;
   each also written into ``out=``;
3m. the source-table combine (masked rounds, late slots, weight-0 pad
   slots; kernel 2's per-agent form) against its plain version (the
   table's gathers, then the weighted sum), bit for bit, at the full bus
   on a degraded ring-4 round with agent 3 dead (timed beside the plain
   version, its bound — one read and one write of the bus at 3.35 TB/s —
   and one ``torch.matmul(W_eff, x.view(A, -1))``), a late-slot table
   and a K = 3 table with a weight-0 pad; each again with NaN / ±Inf; on
   a bf16 bus with f32 out; and poisoned: agent 2's block NaN under the
   late table with both neighbour slots late, every other output finite;
4. main path: ``repro_torch.launch.train`` — smollm_360m at full width,
   4 agents on one device, ring, packed bus, fused kernels, seq 128,
   5 steps, the bus step replayed from CUDA graphs (the CLI's default on
   the card; step 0 runs eagerly and is captured, steps 1–4 replay) and
   the ring gossiped through the ring kernel (the ``"auto"`` transport) —
   with the kernels' launch counts reset just before and read just after:
   the wrappers count the kernels they run, so 1 ``edm_update`` and 1
   ``ring_combine`` (step 0), none other, and 4 replays; losses,
   consensus and grad norms must be finite;
5. profile: one more eager train step under ``torch.profiler``, the
   device time by kernel (no roll left, the ring kernel's time); then one
   graph replay profiled and between CUDA events, its idle share against
   phase 4's median; the replay's device trace must hold what the eager
   step's holds, one ``edm_update`` and one ``ring_combine`` kernel;
6. fused against plain through the rolls: from one state (one eager
   step past the init) and one gradient bus, one optimizer + gossip step
   with the rolls and the ``gossip_axpy`` kernel and one with the rolls
   and the plain combine; the three buses must be bit-equal — at full
   width with the depth cut to 8 layers, as 6r, 6w and 4g (the kernels
   themselves are held on the full bus in phase 3);
4r. the main path with ``--eager``, counts read around it (5
   ``ring_combine`` and 5 ``edm_update`` launches, no ``gossip_axpy``);
   metrics finite; step times, tokens/s, peak memory, busy time and idle
   share of the graphed and the eager run on one line each;
6r. from one state and one gradient bus, one fused EDM step gossiping
   through the ring kernel against one plain step gossiping through the
   rolls and the plain combine: x, m and ψ bit-equal;
4g. under ``torch.use_deterministic_algorithms(True)``, at full width
   with the depth cut to 8 layers: two eager runs
   bit-equal, then the graphed bus step against the eager one from one
   state and one token stream, 3 timed steps and one profiled, on the
   ring, round_robin on the exp graph (two graphs) under
   ``warmup_cosine``, and ``--wire int8``: metrics of every step and every bus bit-equal;
   the wrappers counted each eager step and nothing of the replays, and
   the profiled replay's device trace holds the eager step's kernels;
   median step, tokens/s, busy time, idle share and peak memory of both;
4w. the wire main path through the same CLI (graphed), counts reset
   before and read after each run: ``--wire int8`` on the ring, 5 steps
   (1 EF-update and 1 q8-combine launch in the eager step 0, 4 replays,
   no f32 training kernel), then ``--wire bf16 --topology exp
   --gossip-schedule round_robin``, 3 steps (2 EF-update and 2 combine
   launches, one eager step a round, 1 replay); metrics finite, step
   times, peak memory and the modeled wire bytes per gossip round;
5w. one profiled eager ``--wire int8`` step, device time by bucket, and
   one graph replay profiled, its idle share; the replay's device trace
   holds the eager step's EF-update and q8-combine kernels;
6w. the fused EF step against the plain EF step (the codec's chain and the
   combine's plain version on the same rolled payloads), int8 and bf16,
   at full width, 8 layers: x, m, ψ and e bit-equal;
7. serving kernels: paged decode and paged prefill attention against their
   plain versions on the same pools, at the shapes of both serving runs of
   phase 8 and at head dim 128 (deepseek_moe_16b's heads, K 16 and G 1,
   which phase 15 serves; qwen3_moe_235b_a22b's, K 4 and G 16;
   pixtral_12b's, K 8 and G 4, which phase 19 serves) (f32
   within atol 2e-5; bf16 compared in f32 within
   2e-5 + 2⁻⁷·|want|, one bf16 ulp), and on NaN-poisoned pools bit-equal
   to the clean pools' output and finite; each timed at the
   serving shapes of phase 8, at deepseek_moe_16b's and at
   pixtral_12b's (paged prefill also its host time a call)
   beside its plain version, its bound (bytes
   at 3.35 TB/s or bf16 operations at 989 TFLOP/s) and one
   ``F.scaled_dot_product_attention`` call over pre-gathered dense K/V
   (the yardstick: it excludes the gather, and the port never calls it);
   paged decode's share of its bound printed;
8. serving main path: ``repro_torch.launch.serve`` with chunked
   continuous batching at full width, then the engine itself at a
   1024-token context (32 requests, prompts 256–768, chunks of 128), each
   with the launch counts reset just before and read just after (32
   paged-attention launches per dispatch, 32 paged-prefill launches per
   dispatch with a chunk, no training kernel); one mixed and one
   decode-only dispatch profiled, the paged prefill kernel's share of
   the mixed dispatch's device time printed;
9. exactness: in f32 the kernel engine's greedy tokens equal
   ``greedy_generate``'s; in bf16 the share of tokens on which the kernel
   and plain engines agree is printed (bf16 logits tie at vocab 49152);
3f. flash GQA attention: the kernel against its plain version on the JAX
   package's attention cases, a window as long as the sequence, and a
   case whose rows q >= 255 see no key (those rows must be 0), in f32
   (atol 2e-5) and bf16 (2e-5 + 2⁻⁷·|want|); with NaN in every K/V row a
   causal query cannot see, the output bit-equal to the clean output;
   timed at smollm_360m's heads, (a) 4 sequences of 2048 causal and (b)
   one of 8192 with a 2048 window, in bf16 and f32, beside its plain
   version, its bound (q, k, v and o once at 3.35 TB/s, or 4·hd flops per
   live (query, key) pair at the dtype's peak) and one
   ``F.scaled_dot_product_attention`` call (its backend printed; the port
   never calls it); then the op driven once at (a) and once at (b), with
   the launch counts reset just before and read just after (2 launches);
4t. the tree path through the train CLI: ``--no-packed-bus`` at full
   width, 2 steps of each of edm, ed, edm_ef, dsgd, dmsgd, dsgt, dsgt_hb,
   decentlam and qg, counts reset before and read after each: L EDM and L
   combine launches a step for edm (L = 12 parameter leaves), L combine
   launches for ed, edm_ef, dsgd, dmsgd, decentlam and qg, 2L for dsgt
   and dsgt_hb; metrics finite, median step and peak memory;
5t. one more tree edm step under ``torch.profiler``, the device time by
   kernel and the idle share;
6t. one tree EDM step with the kernels (per-leaf pack, EDM kernel,
   unpack; per-leaf rolls and combine kernel) bit-equal to the same step
   with the plain versions through the same pack, unpack and rolls, and
   within four bf16 ulps of the operands' scale of the unfused chain (at
   full width, 8 layers, as phase 6);
10. the paper on the card: §E.1's quadratic problem, 32 agents on a ring,
   full gradients, 3000 steps of EDM and DmSGD through ``make_optimizer``:
   EDM's mean ‖xᵢ − x*‖² below 1e-8, DmSGD's above 1e-3;
11. hand-off: 2 bus steps at full width through the train CLI (step 0
   eager: 1 EDM and 1 ring-combine launch; step 1 replayed), the parameters saved with the port's
   ``checkpoint.save`` (``params|`` leaves, the bus unpacked), their
   consensus exported with the port's ``export_consensus`` and served by
   ``repro_torch.launch.serve --ckpt`` in bf16 (4 requests; counts reset
   before and read after: 32 paged-attention launches a dispatch); the
   served parameters' digest equal to the export's, the exported model's
   logits finite; then at the smoke config on the card a run resumed
   through ``--ckpt`` / ``--resume`` bit-equal to the uninterrupted one.
   The files go to ``build/handoff/`` and are deleted after use.

12. churn: the main cell plus ``--churn`` (agent 3 down for steps 2–3 of
   6), graphed, counts reset before and read after (3 EDM, 2 ring and 1
   table launch — the eager first step of each epoch's graph — and 3
   replays); each epoch's λ and modeled wire bytes, the median replayed
   step, idle share and peak; one replay of the degraded epoch and one of
   the last epoch profiled (the table kernel in the first, the ring
   kernel in the second); then, at the smoke config, a 4-agent churn run
   saved at the drop and resumed at 3 agents, bit-equal on the survivors
   (the table kernel against the ring kernel), and grown back to 4;
13. the overlapped pipeline: the main cell plus ``--overlap delayed``, on
   the f32 ring and with ``--wire int8``, graphed, counts reset before
   and read after (2 eager steps — one per parity — and 3 replays);
   graphed == eager under deterministic algorithms at the depth 4g runs
   (their profiled replay gives the idle share at that depth); at that
   depth too, step 0 == the synchronous step, and a ``StragglerPlan``
   with slot 1 late at step 1 (the table kernel, 1 launch) bit-equal to
   its plain twin.
14. policy groups: the main cell plus ``--gossip-groups`` (embeddings
   opt out, attention on the ring every step, the MLPs int8 every other
   step, the final norm bf16 on round_robin's rounds), 6 steps, graphed,
   counts reset before and read after (2 graphs: the eager first step of
   each key — 2 EDM, 2 ring, 2 bf16 combine, 1 q8 launch — and 4
   replays); each group's rows and modeled wire bytes; median even and
   odd step, peak allocated and reserved; one even and one odd replay
   profiled (busy, host, idle share; EDM + ring + combine, plus q8 when
   odd); the 2-group all-gossip f32 ring (3 steps, graphed) bit-equal to
   the ungrouped ring on every leaf; graphed == eager for the 4-group
   policy (4 steps, deterministic), the opt-out rows of x equal to φ's
   after every step — the replays and both comparisons at full width
   with the depth cut to 8 layers, as 4g and 13 (the CLI run at full
   depth).
15. MoE serving: deepseek_moe_16b at full width (64 experts of width
   1408, top-6, 2 shared experts, vocab 102400, bf16, random weights from
   seed 0), its depth cut 28 → ``MOE_SERVE_LAYERS`` (12; 7.47 B
   parameters) for the script's time (PERF.md §4;
   ``tools/tp_phase.py --arch deepseek_moe_16b`` serves all 28 in one
   process as its reference): the serve CLI at phase 8's trace
   sizes, then the engine at context 1024 (16 slots, 32 requests, prompts
   256–768, chunks of 128), counts reset just before and read just after
   each (12 paged-attention launches a dispatch, 12 paged-prefill
   launches a mixed dispatch); init time and its peak, one prefill's
   logits finite, tokens/s, TTFT and per-token p50/p99, peak allocated
   and reserved; one mixed and one decode-only dispatch profiled (busy,
   host, idle share, launches); then at the smoke config in f32 on the
   card: dropless, the kernel engine's tokens equal the plain engine's
   and ``greedy_generate``'s; at capacity 1.25 (capacity can bind), the
   kernel engine's equal the plain engine's;
16. MoE training: deepseek_moe_16b at full width with its depth cut to 1
   layer (1.007 B parameters), 2 agents on the ring, packed f32 bus,
   fused kernels, seq 128, under deterministic algorithms: with
   ``gossip_groups="moe"`` (the experts opt out) and ungrouped, 3 steps
   + 1 profiled, eager and graphed from one state: graphed == eager bit
   for bit, losses finite, each replay's device trace holding 1 EDM and
   1 ring kernel, under ``moe`` the expert rows of x equal to φ's after
   every step; median replayed step, busy, idle share and peak.
17. SSM serving: falcon_mamba_7b at full width and depth (64 Mamba-1
   layers, d 4096, d_inner 8192, state 16, conv 4, dt_rank 256, vocab
   65024, bf16, 7,272,665,088 parameters from seed 0): the serve CLI's
   fixed batch at phase 8's sizes (8 requests, prompt 32, 32 new tokens;
   counts reset just before and read just after: the SSM path launches
   none of the port's kernels), then a batch of 4 with prompt 512 (two
   scan chunks of 256) and 64 new tokens through ``greedy_generate``:
   init time and peak, prefill ms, tokens/s, ms a token, peak allocated
   and reserved; one decode step profiled (busy, host, launches, idle
   share); then at the smoke config in f32 on the card: prefill + one
   decode step equal to the full forward (rtol 1e-3 / atol 1e-4), and
   ``greedy_generate``'s tokens equal to a token-by-token decode replay;
18. SSM training: falcon_mamba_7b at full width with its depth cut to 2
   layers (743,305,216 parameters), 4 agents on the ring, packed f32 bus,
   fused kernels, seq 128, under deterministic algorithms: with
   ``gossip_groups="ssm"`` (the conv / state leaves opt out) and
   ungrouped, 3 steps + 1 profiled, eager and graphed from one state:
   graphed == eager bit for bit, losses finite, each replay's device
   trace holding 1 EDM and 1 ring kernel, under ``ssm`` the state rows of
   x equal to φ's after every step; median replayed step, busy, idle
   share and peak; at x(0) the gradients with ``remat`` "full" and "dots"
   bit-equal to ``remat=False``, each one's peak; the EDM and ring
   kernels timed on this bus beside their bounds.
19. VLM serving: pixtral_12b at full width (d 5120, 32 / 8 heads at hd
   128 — G 4 —, d_ff 14336, vocab 131072, bf16, from seed 0), its depth
   cut 40 → ``VLM_SERVE_LAYERS`` (32; 10,066,662,400 parameters) for the
   script's time (PERF.md §4): the serve CLI's fixed batch at
   phase 8's sizes with 256 seeded frontend embeddings a request
   (``greedy_generate``: no kernel of the port), then as phase 15 the
   serve CLI's continuous engine and the engine at context 1024,
   text-only as the reference's scheduler (32 paged-attention launches a
   dispatch, 32 paged-prefill launches a mixed dispatch), one mixed and
   one decode-only dispatch profiled; then at the smoke config in f32
   with G 4 (``n_kv_heads`` 1 under 4 heads) on the card: the kernel
   engine's tokens equal ``greedy_generate``'s, and ``greedy_generate``
   with a frontend equals a token-by-token decode replay after it;
20. VLM training: pixtral_12b at full width with its depth cut to 1 layer
   (1,614,822,400 parameters), 2 agents on the ring, seq 128 after 256
   frontend positions, as phase 16 (ungrouped): graphed == eager bit for
   bit with a new frontend every step (step 1 repeating step 0's tokens,
   so a stale frontend buffer would show);
21. hybrid serving: jamba_1_5_large_398b at full width (d 8192, 64 / 8
   heads at hd 128, 16 experts of 24576 top-2, dense d_ff 24576, d_inner
   16384, state 16, vocab 65536, bf16) with its depth cut 72 → 5, the
   smallest whose period holds (ssm, dense), (ssm, moe) and (attn, dense)
   (24,045,707,264 parameters from seed 0), as phase 17: the serve CLI's
   fixed batch (``--n-layers 5``), 4 × prompt 512 × 64 new through
   ``greedy_generate``, one decode step profiled, the 8-layer smoke
   config's exactness in f32;
22. hybrid training: jamba_1_5_large_398b at one whole period of depth (8
   layers) with its width cut d_model 8192 → 1024 and d_ff = dense_d_ff
   24576 → 2048 (627,657,728 parameters), 4 agents on the ring, seq 128,
   as phase 18 under ``gossip_groups="ssm:0,moe"`` (the conv / state
   leaves and the experts opt out) and ungrouped; ``remat`` gradients
   bit-equal; the EDM and ring kernels on its 2.51 G-element bus,
   bit-equal on agent 3's block (which spans element 2³¹) and timed.
23. encoder-decoder serving: whisper_small at full width and depth (12
   encoder + 12 decoder layers, d 768, 12 heads at hd 64, d_ff 3072,
   vocab 51865, bf16, 277,893,120 parameters from seed 0): the serve
   CLI's fixed batch at phase 8's sizes (8 requests, prompt 32, 32 new
   tokens) with 1500 seeded frames a request, counts reset just before
   and read just after (no kernel of the port: no paged path, as in the
   reference), then the same batch through ``greedy_generate``: prefill
   ms (the encoder plus the prompt), ms a token, one decode step
   profiled (busy, host, launches, idle share), the peak; then at the
   smoke config in f32 on the card: prefill + one decode step equal to
   the full prefill (rtol 1e-3 / atol 1e-4), ``greedy_generate`` equal
   to a token-by-token decode replay whose cross caches come from the
   prefill;
24. encoder-decoder training: whisper_small at full width and depth, 4
   agents on the ring, bus ``(4, 2171392, 128)`` f32, seq 128 after the
   encoder's 1500 frames, new frames every step (step 1 repeating step
   0's tokens), as phase 20 (ungrouped): graphed == eager bit for bit,
   1 EDM and 1 ring kernel in each replay's trace; then 2 steps through
   the train CLI (1 EDM and 1 ring launch, 1 replay), the parameters
   saved, their consensus exported and served by the serve CLI's fixed
   batch ``--ckpt``: the served digest equal to the export's;
25. multi-rank gossip: 4 spawned ranks share the card (``torch.
   distributed`` over gloo, a ``file://`` store; NCCL refuses two ranks
   on one card), each one agent of smollm_360m at full width and depth
   (bus ``(1, 3195392, 128)`` a rank), ring, fused kernels, seq 128,
   per-agent batch 1, 3 steps of the multi-rank bus step
   (``build_train_step(mesh=)``) whose gossip is the peer-pointer ring
   kernel (``csrc/ring_peer.cu``: the neighbours' payloads read through
   CUDA IPC, epoch flags with bounded waits): per-agent losses and the
   final x and ψ bit-equal to a one-process 4-agent eager run of the
   same steps (its buses shared with the ranks through CUDA IPC), the
   kernel bit-equal to its plain version on each rank's final payloads,
   timed one rank at a time beside the plain version and one
   ``torch.matmul``, its bound; one ``ring_peer`` and one ``edm_update``
   launch a rank a step, rank 0's profiled step holding one of each and
   no roll; no flag wait timed out.  The split (pod × data) plan is not
   run on one card (the CPU tests hold it over gloo); the NCCL path has
   run nowhere (gloo on the CPU runs the same permute plan).
26. the overlapped pipeline, the peer table and policy groups across
   ranks, in phase 25's ranks once it is done: (a) 3 steps of the delayed
   pipeline (``overlap="delayed"``) on the ring with the ring's slot 1
   late at step 1 (a ``StragglerPlan``): each rank publishes φ(t) into
   the double-buffered peer table (``csrc/table_peer.cu``'s allocation)
   before its forward and backward pass and combines after it — the ring
   kernel on the table's slots on steps 0 and 2, the table kernel on the
   late step; (c) the table kernel on the ranks' final payloads (rank 0's
   poisoned with NaN) for a ring round, an exponential hop, a late round
   and a masked round, bit-equal to its plain version, the late round
   finite wherever rank 0 is not read, the ring round timed one rank at a
   time beside the plain version and one ``torch.matmul``, its bound; (b)
   4 steps of the policy groups (the embeddings opt out, attention every
   step on the ring, the rest every other step on ``round_robin`` over
   ``exp``: its offset-1 round through the peer ring, its offset-2 round
   through the peer table).  (a) and (b): per-agent losses and the
   digests of x, m, ψ (and the pipeline's live slot) bit-equal to
   one-process 4-agent eager runs of the same steps; launches a rank
   exactly (a) 3 EDM + 2 ring + 1 table, (b) 4 EDM + 5 ring + 1 table (no
   gossip launch for the embeddings' rows); the recorder's marks put the
   publish before each step's forward and backward pass and the combine
   after; no flag wait timed out.
27. the tree path across ranks, in phase 25's ranks after 26: one agent
   of ``smollm_360m`` a rank at full width, the depth cut to
   ``GRAPH_LAYERS`` (its 12 bf16 tree leaves; phase 30 runs the tree at
   full depth), ``packed_bus=False``, fused kernels, eager, (a) 2 EDM steps on
   the ring: the rank's leaves packed into one f32 payload
   (``core/mixing.py::TreePayload``) through the peer ring; (b) 2 DSGT
   steps on ``round_robin`` over ``exp`` (two mixes a step, y and x): the
   offset-1 round through the peer ring, the offset-2 round through the
   peer table.  Gates: per-agent losses and the per-agent digests of
   every leaf of x and of every optimizer slot bit-equal to one-process
   4-agent fused eager tree runs of the same steps (one ``gossip_axpy``
   a leaf there); consensus and gradient norm within rtol 1e-5 of them
   (the sums run in another order); launches a rank a step exactly (a)
   12 ``edm_update`` + 1 ``ring_peer``, (b) 2 ``ring_peer`` at step 0 and
   2 ``table_peer`` at step 1, no ``edm_update``; rank 0's profiled last
   step of each holds no roll; no flag wait timed out.
28. the wires, agent blocks and row shards across ranks, in phase 25's
   ranks after 27, ``smollm_360m`` at full width from seed 0 — at full
   depth the runs whose form is timed ((a), (b), the f32 blocks of (e)),
   the others at ``GRAPH_LAYERS`` (``WIRE_FULL_DEPTH``) —,
   fused kernels, eager (``WIRE_RUNS``): four ranks × one agent, bus
   ``(1, 3195392, 128)`` a rank — (a) 3 ``wire="int8"`` EF steps on the
   ring, (b) 2 ``wire="bf16"`` steps on ``round_robin`` over ``exp``, (c)
   3 steps of the delayed int8 pipeline with ring slot 1 late at step 1,
   (d) 2 steps (one even, one odd) of phase 14's policy groups; ranks 0–1
   × two agents, bus ``(2, 3195392, 128)`` a rank, ranks 2–3 outside the
   mesh — (e) 3 f32 steps on ring(4) with agent 3 down at step 2, then 2
   int8 steps; two pods × two row shards, a rank's ``(1, 1597952, 128)``
   rows — (f) 2 f32 steps on ring(2) through the peer ring, then 1 int8
   step.  Every wire and block round goes through the peer table: the
   bf16 and f32-block forms of ``csrc/table_peer.cu`` and the peer q8
   kernel ``csrc/table_peer_q8.cu`` (the EF kernel, the overlap's encode
   and a wired group's encode write the payload into the table's slot).
   Gates, each against a one-process eager fused run of the same agents
   and steps: per-agent losses bit-equal; digests of x, m, ψ, e (and the
   pipeline's live slot) equal, a shard's of its rows; a rank's launches
   a step exactly ``WIRE_LAUNCHES`` — the one-process step's with each
   one-card combine replaced by one peer combine; rank 0's profiled last
   step of each run holding what its counters say, no roll; no flag wait
   timed out.  The q8, bf16 and f32-block forms bit-equal to their plain
   versions on every rank's final payloads (rank 0's poisoned with NaN
   and ±Inf; ring, exp, late and masked rounds), the first three timed
   one rank at a time on the ring round beside the plain version, the
   bound and (bf16, f32 blocks) one ``torch.matmul``.
29. the MoE across ranks, in phase 25's ranks after 28:
   ``deepseek_moe_16b`` at full width on a ``(1, 4)`` ``("data",
   "model")`` grid (``launch/mesh.py::make_moe_mesh``), each rank 16 of
   the 64 experts a layer from the rank-local init
   (``models/transformer.py::init_lm_rank``, never the whole set), served
   by the continuous engine with the paged kernels, every request
   arriving at once: (a) the expert-parallel layout alone (every other
   leaf whole, the grid registered by ``set_moe_mesh(mesh,
   "shard_map")``), f32 with the depth cut 28 → 2, 4 requests (prompts
   128–256, 8 new tokens) at capacity 8.0 and the config's 1.25, each
   rank's tokens equal to the one-process engine's (its references made
   before the spawn), one sum over the model axis a MoE layer call and
   no other collective; (b) the reference's serving layout, EP + TP
   (``lm_param_specs`` on the grid, ``build_model(cfg, mesh=grid)``: 4 of
   16 heads, 704 of the 2816 shared-expert columns and 25600 of the
   102400 vocabulary rows a rank besides its experts; attention at K 4,
   G 1), bf16 at ``EP_B_LAYERS`` (4 of 28) layers, 8 requests at context
   1024 (prompts 256–512, chunks of 128, 16–32 new tokens), every rank's
   tokens bit-equal to rank 0's, 2L + 1 sums and one logits gather a
   forward and no other collective, no plain twin.  Gates in both: each
   rank's paged kernels launched once a layer a dispatch (the prefill
   once a layer a mixed one), no other kernel.  Reported: each rank's
   init time, peak and parameter GB, tokens/s against one process, one
   mixed and one decode-only dispatch with the sums' time apart, and the
   share of (b)'s tokens equal to the one-process engine's (the same cut
   model, made before the spawn) on the same requests and the first
   divergence.
30. the tree path with a block of agents a rank, in phase 25's ranks
   after 29: ranks 0–1 × two agents of ``smollm_360m`` at full width,
   the depth cut to ``GRAPH_LAYERS`` (4 of 32; PERF.md §4) (ranks 2–3
   outside the mesh), ``packed_bus=False``, fused
   kernels, eager, from seed 0 — (a) 3 EDM steps on ring(4) with agent 3
   down at step 2 (a masked round), (b) 2 DSGT steps on ``round_robin``
   over ``exp`` (two mixes a step, y and x).  Every round goes through
   the peer table, the rank's 12 bf16 leaves of both agents packed into
   one ``(2, rows, 128)`` f32 payload (``core/mixing.py::TreePayload``,
   ``table_peer_kernel_blk``).  Gates, each against a one-process 4-agent
   fused eager tree run of the same steps: per-agent losses and the
   per-agent digests of every leaf of x and of every optimizer slot
   equal; consensus and gradient norm within rtol 1e-5; launches a rank a
   step exactly (a) 12 ``edm_update`` + 1 ``table_peer``, (b) 2
   ``table_peer`` and no ``edm_update``; one table epoch a mix; no
   permute and no gossip collective in the recorder; rank 0's profiled
   last step of each holding what its counters say, no roll; no flag wait
   timed out.  Reported: a rank's step ms, torch peak and peer-slot GiB.
31. tensor-parallel serving across ranks, in phase 25's ranks after 30:
   ``qwen3_14b`` at full width on a ``(1, 4)`` ``("data", "model")`` grid
   (the reference's ``serve_param_specs`` / ``paged_pool_specs`` layout,
   ``build_model(cfg, mesh=grid)``): a rank holds 10 of the 40 query heads
   and 2 of the 8 KV heads a layer (hd 128), 4352 of the 17408 FFN
   columns and 37984 of the 151936 vocabulary rows from the rank-local
   init (``init_lm_rank``, never the whole model), and its pools hold its
   2 KV heads; the continuous engine with the paged kernels at K 2, G 5
   serves 8 requests at context 1024 (prompts 256–768, chunks of 128,
   16–32 new tokens), every request arriving at once: (a) f32 at 2 of 40
   layers, each rank's engine tokens equal to the one-process engine's
   and its ``greedy_generate`` tokens on 4 prompts of 256 equal to one
   process's; (b) bf16 at ``TP_BF16_LAYERS`` (4 of 40) layers, every
   rank's tokens bit-equal to rank 0's.  Gates in both: each rank's paged
   kernels launched once a layer a dispatch (the prefill once a layer a
   mixed one), no other kernel and no plain twin; 2L + 1 sums over the model
   axis (``core/comm.py::psum``, staged through the host over gloo) and
   one all-gather of the logits a forward (a mixed dispatch: two
   forwards), no other collective.  The one-process references run in
   the parent once the ranks have exited.  Reported: each rank's init
   time and peak, pools GB, tokens/s against one process, one mixed and
   one decode-only dispatch with the sums' time apart, the share of
   (b)'s tokens equal to the one-process engine's and the first
   divergence.
32. tensor-parallel SSM serving across ranks, in phase 25's ranks after
   31: ``falcon_mamba_7b`` at full width (d 4096, ``d_inner`` 8192) on
   the ``(1, 4)`` grid, a rank 2048 channels a layer (``in_proj``'s paired
   x and z columns) and 16256 of the 65024 vocabulary rows from the
   rank-local init, serving the fixed batch (``greedy_generate``'s steps)
   of 4 prompts of 512 and 16 new tokens: (a) f32 at 2 of 64 layers,
   every rank's tokens equal to one process's; (b) bf16 at
   ``SSM_TP_BF16_LAYERS`` (4) layers, every rank's tokens bit-equal to
   rank 0's.  Gates in both: 2L + 1 sums over the model axis (the
   embedding, each layer's ``x_proj`` and ``out_proj``) and one logits
   gather a forward, no other collective, no kernel launch (the scan is
   plain PyTorch, as the reference's).  The references run in the parent
   once the ranks have exited.  Reported: prefill ms, ms a token, sums a
   forward, peak and parameter GB a rank, against one process; the share
   of (b)'s tokens equal to one process's.
33. tensor-parallel training on the tree path across ranks, in phase
   25's ranks after 32: ``qwen3_14b`` at full width in bf16 at
   ``TP_TRAIN_LAYERS`` (1 of 40) layers on the ``(2, 2)`` ``("data",
   "model")`` grid of the reference's ``state_specs`` (2 agents, one a
   data rank, each split over two model ranks: 20 / 4 heads, 8704 FFN
   columns, 75968 vocabulary rows a rank from the rank-local init), ring,
   EDM, fused, seq 128: (a) each rank's step-0 loss and gradient blocks
   within a stated bf16 tolerance of one process's whole-agent backward;
   (b) ``TP_TRAIN_STEPS`` steps of ``build_train_step(mesh=grid)``, the
   launch counts set to 0 before and read after: one ``edm_update`` a
   leaf a step on the rank's blocks, each bit-equal (by digest) to the
   plain twin on the same inputs, one ``ring_peer`` a step in each
   column, 2L + 1 + 4L + 1 sums and one logits gather over the model
   axis, no gossip collective; the replicated leaves bit-equal across a
   column's model ranks after every step; every rank's losses and
   metrics equal; then one step more without the twin check or the
   synchronised collectives.  Reported: that step's ms a rank, the
   instrumented steps' ms with the sums' and the metrics' host-staged
   time apart, peak a rank.

Phases run in the order 1–3, 3w, 3r, 3m, 3f, 25–33 (26–33 in 25's
ranks),
4–6, 4r, 6r, 4g, 4w–6w, 12, 13, 14, 4t–6t, 7–11, 15–24; a ``[time]``
line before each gives the seconds since the start and those of the
phase before, and the memory this process still holds on the card.  The third
line from the end is the ``nvidia-smi`` name and power limit,
the line before the last ``{"kernels": [...]}`` and the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

ARCH, AGENTS, SEQ, STEPS = "smollm_360m", 4, 128, 5
WIRE_RR_STEPS = 3                    # bf16 wire on round_robin's rounds
ALPHA, BETA = 0.2, 0.9
MAIN_ARGS = ["--arch", ARCH, "--agents", str(AGENTS), "--agents-per-device",
             str(AGENTS), "--gossip-engine", "ppermute", "--topology", "ring",
             "--fused-kernel", "--seq", str(SEQ), "--per-agent-batch", "1",
             "--steps", str(STEPS), "--alpha", str(ALPHA), "--beta",
             str(BETA), "--device", "cuda"]
REPS = 20

# serving: the reference CLI's trace sizes, then a 1024-token context
SERVE_ARGS = ["--arch", ARCH, "--continuous-batching", "--prefill-chunk",
              "16", "--max-step-tokens", "32", "--prompt-dist", "exact",
              "--max-slots", "8", "--page-size", "16", "--requests", "16",
              "--rate", "50", "--attn-impl", "kernel", "--device", "cuda"]
PAGE, SLOTS, CTX, CHUNK, STEP_TOKENS = 16, 16, 1024, 128, 256

# the MoE family: deepseek_moe_16b served at full width, its depth cut 28 →
# MOE_SERVE_LAYERS for the script's time (phase 15: PERF.md §4; the whole
# 28 layers serve in one process in tools/tp_phase.py --arch
# deepseek_moe_16b's reference), trained at full width with the depth cut
# to one layer on two agents (phase 16)
MOE_ARCH, MOE_TRAIN_LAYERS, MOE_AGENTS = "deepseek_moe_16b", 1, 2
MOE_SERVE_LAYERS = 12
MOE_SERVE_ARGS = [MOE_ARCH if a == ARCH else a for a in SERVE_ARGS] + [
    "--n-layers", str(MOE_SERVE_LAYERS)]

# the SSM family: falcon_mamba_7b served at full width and depth (phase
# 17: the serve CLI's fixed batch at phase 8's sizes — 8 requests, its
# slots, of its longest prompt and budget, 32 and 32 — then a batch of 4
# with prompt 512, two scan chunks of 256, and 64 new tokens), trained at
# full width with the depth cut to two layers on the main cell's four
# agents (phase 18)
SSM_ARCH, SSM_TRAIN_LAYERS, SSM_PARAMS = "falcon_mamba_7b", 2, 7272665088
SSM_SERVE_ARGS = ["--arch", SSM_ARCH, "--batch", "8", "--prompt-len", "32",
                  "--new-tokens", "32", "--device", "cuda"]
SSM_BATCH, SSM_PROMPT, SSM_NEW = 4, 512, 64

# the VLM family: pixtral_12b served at full width, its depth cut 40 →
# VLM_SERVE_LAYERS for the script's time (phase 19: PERF.md §4; the serve
# CLI's fixed batch at phase 8's sizes with 256 frontend embeddings a
# request, its continuous engine at phase 8's trace, then the engine at
# context 1024, text-only), trained at full width with the depth cut to
# one layer on two agents (phase 20)
VLM_ARCH, VLM_SERVE_LAYERS, VLM_PARAMS = "pixtral_12b", 32, 10066662400
VLM_TRAIN_LAYERS, VLM_AGENTS = 1, 2
VLM_CLI_ARGS = ["--arch", VLM_ARCH] + SSM_SERVE_ARGS[2:] + [
    "--n-layers", str(VLM_SERVE_LAYERS)]
VLM_SERVE_ARGS = [VLM_ARCH if a == ARCH else a for a in SERVE_ARGS] + [
    "--n-layers", str(VLM_SERVE_LAYERS)]

# the hybrid family: jamba_1_5_large_398b served at full width with its
# depth cut 72 → 5, the smallest depth whose period holds (ssm, dense),
# (ssm, moe) and (attn, dense) (phase 21: the fixed batch, as phase 17);
# trained at one whole period of depth (8 layers) with its width cut
# d_model 8192 → 1024 and d_ff = dense_d_ff 24576 → 2048 on four agents
# (phase 22: one full-width MoE layer is 9.66 B parameters, a 38.6 GB f32
# bus an agent)
HYBRID_ARCH, HYBRID_SERVE_LAYERS, HYBRID_PARAMS = (
    "jamba_1_5_large_398b", 5, 24045707264)
HYBRID_CLI_ARGS = ["--arch", HYBRID_ARCH, "--n-layers",
                   str(HYBRID_SERVE_LAYERS)] + SSM_SERVE_ARGS[2:]
HYBRID_TRAIN = dict(n_layers=8, d_model=1024, d_ff=2048, dense_d_ff=2048)
HYBRID_TRAIN_PARAMS, HYBRID_GROUPS = 627657728, "ssm:0,moe"

# the encoder-decoder family: whisper_small at full width and depth (12 +
# 12 layers, 277,893,120 parameters) served (phase 23: the serve CLI's
# fixed batch at phase 8's sizes, 1500 seeded frames a request) and
# trained on the main cell's four agents (phase 24), bus (4, 2171392, 128)
WHISPER_ARCH, WHISPER_PARAMS = "whisper_small", 277893120
WHISPER_CLI_ARGS = ["--arch", WHISPER_ARCH] + SSM_SERVE_ARGS[2:]
WHISPER_SHAPE = (8, 32, 32)         # the CLI's batch, prompt, new tokens
WHISPER_BUS = (AGENTS, 2171392, 128)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


# a device-side spin of ~10 ms at the H100's clock: the host queues every
# timed call behind it, so a kernel faster than its Python launch path is
# timed on the device, not at the pace of the host
QUEUE_CYCLES = 20_000_000
TIMING = ("device time per call: median of 20 (flash: 10) CUDA-event pairs, "
          "the calls queued behind a device-side spin")


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events around
    each call), the calls queued behind a device-side spin."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, reps: int = REPS) -> float:
    """Wall time per call of ``fn`` called back to back, ending in a device
    sync: what the host's launch path costs where it, not the device, is
    the slower of the two."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def ptxas_report(log: str):
    """(kernel, "N registers, spill stores / loads, static smem") of every
    kernel in an ``nvcc -Xptxas -v`` log, template arguments decoded."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled, kernel = m.group(1), m.group(1)
            for part in re.finditer(r"(?=(\d+)([a-z_]\w*?_kernel))", mangled):
                ident = part.group(2)
                if int(part.group(1)) == len(ident):
                    rest = mangled[part.end(2):]
                    targs = rest[:rest.find("EE") + 1] \
                        if rest.startswith("I") else ""
                    args = [n or ({"0": "false", "1": "true"}[b] if b
                                  else "float" if f else "bf16")
                            for n, b, f, _ in re.findall(
                                r"Li(\d+)E|Lb(\d)E|(f)(?=[LE])"
                                r"|(13__nv_bfloat16)", targs)]
                    kernel = ident + (f"<{', '.join(args)}>" if args else "")
                    break
        elif kernel and "spill" in line:
            spill = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            used = line.split("Used", 1)[1].strip()
            out.append((kernel, f"{used}; {spill}"))
            kernel, spill = None, ""
    return out


def attention_smem_report():
    """The redesigned attention kernels' dynamic shared memory a block at
    each head dim (the C launchers' own sizes; ptxas reports static
    shared memory only), and the paged decode kernel's cluster at phase
    7's timed shape."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels._ffi import sm_count
    from repro_torch.kernels.paged_attention import split_plan
    flash = build.library("flash_attention")
    prefill = build.library("paged_prefill")
    decode = build.library("paged_attention")
    lines = [f"dynamic smem at hd {hd}: flash_wgmma_kernel "
             f"{flash.flash_attention_smem_bytes(hd)} B; "
             f"paged_prefill_mma_kernel "
             f"{prefill.paged_prefill_smem_bytes(hd, 128, PAGE, 6)} B "
             f"(split_keys 128, page {PAGE}, 6 splits); "
             f"paged_decode_mma_kernel (bf16) "
             f"{decode.paged_attention_smem_bytes(3, hd, 1)} B, "
             f"paged_decode_simt_kernel (f32) "
             f"{decode.paged_attention_smem_bytes(3, hd, 0)} B (G 3)"
             for hd in (8, 64, 128, 192, 256)]
    sms = sm_count(torch.device("cuda"))
    n_split, split_keys = split_plan(SLOTS, 5, CTX, PAGE, sms=sms)
    lines.append(f"paged_decode at the timed shape ({SLOTS} slots, 5 KV "
                 f"heads, {CTX}-row tables): clusters of {n_split} blocks, "
                 f"{split_keys} keys a block, {SLOTS * 5 * n_split} blocks "
                 f"on {sms} SMs")
    return lines


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits, except that a NaN matches any NaN."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = torch.int32 if a.element_size() == 4 else torch.int16
    ia, ib = a.view(ints), b.view(ints)
    if torch.equal(ia, ib):
        return True
    return bool(((ia == ib) | (torch.isnan(a) & torch.isnan(b))).all())


def compare(got, want):
    """(bit-equal, max |got − want| where the difference is finite), pair
    by pair; a NaN matches any NaN."""
    equal, err = True, 0.0
    for g, w in zip(got, want):
        equal &= same_bits(g, w)
        if g.shape == w.shape and g.numel():
            d = g.float() - w.float()
            err = max(err, float(d.nan_to_num_(0.0, 0.0, 0.0).abs_().max()))
    return equal, err


def free():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_edm(shape, gen, timed: bool):
    import torch
    from repro_torch.kernels import ops, ref
    x, g, m, psi = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(4))
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA)
    equal, err = True, 0.0
    for a in range(shape[0]):
        want = ref.edm_update_ref(x[a], g[a], m[a], psi[a], alpha=ALPHA,
                                  beta=BETA)
        eq, e = compare([o[a] for o in got], want)
        equal, err = equal and eq, max(err, e)
    # in place: m' over m, ψ' over ψ
    m2, p2 = m.clone(), psi.clone()
    inplace = ops.edm_update_bus(x, g, m2, p2, alpha=ALPHA, beta=BETA,
                                 out=(m2, p2, None))
    check(inplace[0].data_ptr() == m2.data_ptr(), "in-place m' not in m")
    eq, e = compare(inplace, got)
    equal, err = equal and eq, max(err, e)
    del m2, p2, inplace
    check(equal, f"edm_update differs from its plain version at {shape}: "
                 f"max abs err {err}")
    rec = {"shape": list(shape), "bit_equal": equal, "max_abs_err": err}
    if timed:
        n = x.numel()
        rec["ms"] = time_ms(lambda: ops.edm_update_bus(
            x, g, m, psi, alpha=ALPHA, beta=BETA, out=got))
        del got
        free()
        rec["plain_ms"] = time_ms(lambda: ref.edm_update_ref(
            x, g, m, psi, alpha=ALPHA, beta=BETA))
        rec["bytes"] = 28 * n                  # 4 f32 reads + 3 f32 writes
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], 7 * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del x, g, m, psi
    free()
    return rec


def check_axpy(shape, n_ops, dtype, out_dtype, gen, timed: bool, ring=False):
    import torch
    from repro_torch.kernels import ops, ref
    if ring:
        # the main path's operands: φ and its two ring neighbours
        phi = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        operands = [phi, torch.roll(phi, 1, 0), torch.roll(phi, -1, 0)]
        weights = [0.5, 0.25, 0.25]
    else:
        operands = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for _ in range(n_ops)]
        weights = [1.0 / (k + 3) for k in range(n_ops)]
    got = ops.gossip_axpy(operands, weights, out_dtype=out_dtype)
    equal, err = True, 0.0
    for a in range(shape[0]):
        want = ref.gossip_axpy_ref([o[a] for o in operands], weights,
                                   out_dtype=out_dtype)
        eq, e = compare([got[a]], [want])
        equal, err = equal and eq, max(err, e)
    name = (f"{len(operands)}-ary {str(dtype)[6:]}→"
            f"{str(out_dtype or dtype)[6:]}")
    check(equal, f"gossip_axpy {name} differs from its plain version at "
                 f"{shape}: max abs err {err}")
    rec = {"case": name, "shape": list(shape), "bit_equal": equal,
           "max_abs_err": err}
    if timed:
        del got
        free()
        n = operands[0].numel()
        in_b = operands[0].element_size()
        out_b = torch.empty((), dtype=out_dtype or dtype).element_size()
        rec["ms"] = time_ms(lambda: ops.gossip_axpy(operands, weights,
                                                    out_dtype=out_dtype))
        rec["plain_ms"] = time_ms(lambda: ref.gossip_axpy_ref(
            operands, weights, out_dtype=out_dtype))
        rec["bytes"] = (len(operands) * in_b + out_b) * n
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"],
                                                    2 * len(operands) * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
        if ring:
            # the same function as one library call: the ring's W over
            # the agent axis (the port never calls it)
            A = shape[0]
            W = torch.zeros((A, A), device="cuda")
            for a in range(A):
                for src, w in ((a, 0.5), ((a - 1) % A, 0.25),
                               ((a + 1) % A, 0.25)):
                    W[a, src] += w
            flat = phi.view(A, -1)
            lib = torch.matmul(W, flat)
            got = ops.gossip_axpy(operands, weights, out_dtype=out_dtype)
            rec["library_max_abs_diff"] = float(
                (lib - got.view(A, -1)).abs_().max())
            del lib, got
            rec["library_ms"] = time_ms(lambda: torch.matmul(W, flat))
    del operands
    free()
    return rec


# ---------------------------------------------------------------------------
# phase 3w: the wire kernels against their plain versions
# ---------------------------------------------------------------------------

def ef_inputs(A, block_rows, n_tiles, gen):
    """(x, g, m, ψ, e) buses of A agents × n_tiles ≥ 7 tiles whose first 7
    tiles per agent are random, all zero, NaN, ±Inf beside finite values,
    ±Inf in an all-zero tile, tiny (~1e-30) and exact ties (absmax 127);
    x, g, m, ψ are zero on tiles 1, 4, 5, 6, so c = e there."""
    import torch
    shape = (A, n_tiles, block_rows * 128)
    x, g, m, psi, e = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(5))
    for t in (x, g, m, psi):
        t[:, [1, 4, 5, 6]] = 0.0
    e[:, 1] = 0.0
    e[:, 2, ::97] = float("nan")
    e[:, 3, 5], e[:, 3, 11] = float("inf"), -float("inf")
    e[:, 4] = 0.0
    e[:, 4, 7], e[:, 4, 13] = float("inf"), -float("inf")
    e[:, 5] *= 1e-30
    e[:, 6] = torch.randint(-127, 127, shape[2:], generator=gen,
                            device="cuda").float() + 0.5
    e[:, 6, 0] = 127.0
    return [t.reshape(A, n_tiles * block_rows, 128)
            for t in (x, g, m, psi, e)]


def ef_flat(outs, fmt):
    """(m', ψ', payload, e') → [m', ψ', q(, scale), e']."""
    m2, p2, pay, e2 = outs
    return [m2, p2, *(pay if fmt == "int8" else (pay,)), e2]


def ef_vs_plain(inputs, fmt, block_rows):
    """The kernel out of place and in place against the plain version, one
    agent row block at a time (tiles never straddle agents)."""
    from repro_torch.kernels import ops, ref
    x, g, m, psi, e = inputs
    kw = dict(alpha=ALPHA, beta=BETA, fmt=fmt, block_rows=block_rows)

    def against_plain(got):
        equal, err = True, 0.0
        for a in range(x.shape[0]):
            want = ref.edm_update_ef_ref(x[a], g[a], m[a], psi[a], e[a],
                                         **kw)
            pieces = [o[a] for o in got]
            eq, er = compare(pieces, [w.view(p.shape)
                                      for w, p in zip(want, pieces)])
            equal, err = equal and eq, max(err, er)
            del want
        return equal, err

    got = ef_flat(ops.edm_update_bus_ef(x, g, m, psi, e, **kw), fmt)
    equal, err = against_plain(got)
    del got
    free()
    m2, p2, e2 = m.clone(), psi.clone(), e.clone()
    got = ef_flat(ops.edm_update_bus_ef(x, g, m2, p2, e2, **kw,
                                        out=(m2, p2, e2)), fmt)
    check(got[0].data_ptr() == m2.data_ptr()
          and got[-1].data_ptr() == e2.data_ptr(), "EF update not in place")
    eq, er = against_plain(got)
    del got, m2, p2, e2
    free()
    return equal and eq, max(err, er)


def check_ef(shape, fmt, gen, timed: bool, block_rows: int = 512):
    """The fused EF update: random buses at ``shape`` (timed at the main
    path's), or the edge-tile bus of ``shape = (A, n_tiles)``."""
    import torch
    from repro_torch.kernels import ops, ref
    if len(shape) == 2:
        inputs = ef_inputs(shape[0], block_rows, shape[1], gen)
        shape = tuple(inputs[0].shape)
    else:
        inputs = [torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(5)]
    equal, err = ef_vs_plain(inputs, fmt, block_rows)
    check(equal, f"edm_update_ef {fmt} differs from its plain version at "
                 f"{shape}, block_rows {block_rows}: max abs err {err}")
    rec = {"fmt": fmt, "shape": list(shape), "block_rows": block_rows,
           "bit_equal": equal, "max_abs_err": err}
    if timed:
        x, g, m, psi, e = inputs
        n = x.numel()
        kw = dict(alpha=ALPHA, beta=BETA, fmt=fmt, block_rows=block_rows)
        rec["ms"] = time_ms(lambda: ops.edm_update_bus_ef(
            x, g, m, psi, e, **kw, out=(m, psi, e)))     # the main path's
        free()
        rec["plain_ms"] = time_ms(lambda: [ref.edm_update_ef_ref(
            x[a], g[a], m[a], psi[a], e[a], **kw)
            for a in range(shape[0])])     # per agent, to fit the card
        # 5 f32 reads, 3 f32 writes, q: 2 B (bf16) or 1 B + scales (int8)
        n_tiles = n // (block_rows * 128)
        rec["bytes"] = (34 * n if fmt == "bf16" else 33 * n + 4 * n_tiles)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["bytes"], (10 if fmt == "bf16" else 16) * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del inputs
    free()
    return rec


def check_q8(shape, n_ops, gen, timed: bool, ring=False,
             block_rows: int = 512):
    """The int8 dequantize-combine through ops.gossip_axpy_wire: the ring's
    3-ary case on a payload and its two agent rolls, or n random
    operands."""
    import torch
    from repro_torch.kernels import ops, ref
    A, rows, _ = shape
    nb = rows // block_rows

    def payload():
        q = torch.randint(-127, 127, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        return q, torch.rand((A, nb), generator=gen, device="cuda")

    if ring:
        q, s = payload()
        pays = [(q, s), (torch.roll(q, 1, 0), torch.roll(s, 1, 0)),
                (torch.roll(q, -1, 0), torch.roll(s, -1, 0))]
        weights = [0.5, 0.25, 0.25]
    else:
        pays = [payload() for _ in range(n_ops)]
        weights = [1.0 / (k + 3) for k in range(n_ops)]
    qs, scales = zip(*pays)
    coefs = ref.wire_coefs(weights, scales)
    got = ops.gossip_axpy_wire(pays, weights, fmt="int8",
                               block_rows=block_rows)
    equal, err = True, 0.0
    for a in range(A):
        want = ref.gossip_axpy_q8_ref([q[a] for q in qs],
                                      coefs[:, a * nb:(a + 1) * nb],
                                      block_rows=block_rows)
        eq, e = compare([got[a]], [want])
        equal, err = equal and eq, max(err, e)
    name = f"{len(pays)}-ary int8→float32"
    check(equal, f"gossip_axpy_q8 {name} differs from its plain version "
                 f"at {shape}: max abs err {err}")
    rec = {"case": name, "shape": list(shape), "bit_equal": equal,
           "max_abs_err": err}
    if timed:
        del got
        free()
        n = qs[0].numel()
        rec["ms"] = time_ms(lambda: ops.gossip_axpy_wire(
            pays, weights, fmt="int8", block_rows=block_rows))
        rec["plain_ms"] = time_ms(lambda: ref.gossip_axpy_q8_ref(
            qs, coefs, block_rows=block_rows))
        rec["bytes"] = (len(pays) + 4) * n + 4 * coefs.numel()
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"],
                                                    2 * len(pays) * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del pays, qs, scales
    free()
    return rec


# ---------------------------------------------------------------------------
# phase 6: one fused optimizer + gossip step against its plain twin
# ---------------------------------------------------------------------------

def fused_vs_plain(model, layout, state, tokens):
    """Phase 6: one fused EDM step gossiping through the rolls and the
    gossip_axpy kernel against one plain step through the rolls and the
    plain combine (the ring transport's twin is phase 6r)."""
    import torch
    from repro_torch.core import build_mixer, make_edm_bus, ring
    from repro_torch.train import losses_and_grads

    x, m, psi = state["params"], state["opt"]["m"], state["opt"]["psi"]
    _, g = losses_and_grads(model, layout, x, {"tokens": tokens})

    def opt(fused):
        mix = build_mixer(ring(AGENTS), mode="static", engine="ppermute",
                          agents_per_device=AGENTS, use_fused_kernel=fused,
                          transport="ppermute")
        return make_edm_bus(ALPHA, BETA, mix, use_fused_kernel=fused)

    with torch.no_grad():
        x_f, st = opt(True).step(x, g, {"m": m.clone(), "psi": psi.clone()})
        fused = [x_f.cpu(), st["m"].cpu(), st["psi"].cpu()]   # host copies
        del x_f, st
        free()
        x_p, st = opt(False).step(x, g, {"m": m, "psi": psi})
        equal, err = True, 0.0
        for host, dev in zip(fused, (x_p, st["m"], st["psi"])):
            eq, e = compare(host.cuda(), dev)
            equal, err = equal and eq, max(err, e)
    check(equal, f"fused step differs from the plain step: max abs err {err}")
    return {"bit_equal": equal, "max_abs_err": err,
            "shape": list(x.shape)}


def ef_fused_vs_plain(model, layout, state, tokens, fmt):
    """Phase 6w: from one state and one gradient bus, one EF optimizer +
    ring-gossip step with the kernels and one with their plain versions
    (the codec's EF chain and the combine's plain version on the same
    rolled payloads); x, m, ψ and e must be bit-equal.  Consumes the
    state's m, ψ and e."""
    import torch
    from repro_torch.core import (build_mixer, make_codec, make_edm_bus_ef,
                                  ring, wire_terms)
    from repro_torch.kernels import ref
    from repro_torch.train import losses_and_grads

    x = state["params"]
    _, g = losses_and_grads(model, layout, x, {"tokens": tokens})
    codec = make_codec(fmt, layout.block_rows)
    topo = ring(AGENTS)
    weights = [t.weight for t in topo.terms]

    def plain_mix(payload):
        pays = wire_terms(topo, payload, codec)
        if fmt == "bf16":
            return ref.gossip_axpy_ref(pays, weights,
                                       out_dtype=torch.float32)
        qs, scales = zip(*pays)
        return ref.gossip_axpy_q8_ref(qs, ref.wire_coefs(weights, scales),
                                      block_rows=codec.block_rows)

    fused_mix = build_mixer(topo, mode="static", engine="ppermute",
                            agents_per_device=AGENTS, use_fused_kernel=True,
                            wire=codec)
    keys = ("m", "psi", "e")
    with torch.no_grad():
        opt = make_edm_bus_ef(ALPHA, BETA, fused_mix, codec,
                              use_fused_kernel=True)
        x_f, st = opt.step(x, g, {k: state["opt"][k].clone() for k in keys})
        fused = [x_f.cpu()] + [st[k].cpu() for k in keys]   # host copies
        del x_f, st
        free()
        # the plain step writes over the state's own m, ψ, e (no clones:
        # the plain chain's temporaries need the room)
        opt = make_edm_bus_ef(ALPHA, BETA, plain_mix, codec,
                              use_fused_kernel=False)
        x_p, st = opt.step(x, g, {k: state["opt"][k] for k in keys})
        equal, err = True, 0.0
        for host, dev in zip(fused, [x_p] + [st[k] for k in keys]):
            for a in range(AGENTS):
                eq, e = compare([host[a].cuda()], [dev[a]])
                equal, err = equal and eq, max(err, e)
        del x_p, st, fused, g
    free()
    check(equal, f"fused {fmt} EF step differs from the plain EF step: max "
                 f"abs err {err}")
    return {"fmt": fmt, "bit_equal": equal, "max_abs_err": err,
            "shape": list(x.shape)}


# ---------------------------------------------------------------------------
# phase 3r: the ring combine (the rolls fused in) against its plain version
# ---------------------------------------------------------------------------

# (A, rows): one agent (one term), two (both neighbours the same agent),
# three, a longer ring and a 32-agent ring, at odd row counts
RING_CASES = ((1, 9), (2, 17), (3, 24), (8, 3), (32, 5))


def ring_edges(x):
    """NaN and ±Inf in every agent's block, at different places."""
    A, rows, _ = x.shape
    for a in range(A):
        x[a, a % rows, 3] = float("nan")
        x[a, (a + 5) % rows, 7] = float("inf")
        x[a, (a + 9) % rows, 11] = -float("inf")
    return x


def check_ring(shape, gen, timed: bool, edges: bool = False):
    """The ring kernel against ``ring_combine_ref`` (the rolls, then the
    weighted sum) on one bus, out of place and into ``out=``; timed at the
    full bus beside the plain version, the bound and one
    ``torch.matmul(W, x.view(A, -1))`` (the same function as one library
    call; the port never calls it)."""
    import torch
    from repro_torch.core import ring
    from repro_torch.kernels import ops, ref
    A = shape[0]
    x = torch.randn(shape, generator=gen, device="cuda")
    if edges:
        ring_edges(x)
    terms = [(t.shift, float(t.weight)) for t in ring(A).terms]
    got = ops.ring_combine(x, terms)
    want = ref.ring_combine_ref(x, terms)
    equal, err = compare([got], [want])
    got.fill_(7.0)                    # out=: every element written again
    into = ops.ring_combine(x, terms, out=got)
    check(into.data_ptr() == got.data_ptr(), "ring out= not written in place")
    eq, e = compare([got], [want])
    equal, err = equal and eq, max(err, e)
    del want
    check(equal, f"ring_combine differs from its plain version at {shape} "
                 f"(edges {edges}): max abs err {err}")
    rec = {"shape": list(shape), "edges": edges, "bit_equal": equal,
           "max_abs_err": err, "terms": len(terms)}
    if timed:
        free()
        n = x.numel()
        rec["ms"] = time_ms(lambda: ops.ring_combine(x, terms, out=got))
        rec["plain_ms"] = time_ms(lambda: ref.ring_combine_ref(x, terms))
        free()
        W = torch.tensor(ring(A).dense_matrix(), dtype=torch.float32,
                         device="cuda")
        lib = torch.matmul(W, x.view(A, -1))
        rec["library_max_abs_diff"] = float(
            (lib.view(shape) - got).abs().max())
        del lib
        free()
        rec["library_ms"] = time_ms(lambda: torch.matmul(W, x.view(A, -1)))
        rec["bytes"] = 2 * 4 * n              # one f32 read, one f32 write
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["bytes"], (2 * len(terms) - 1) * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del x, got
    free()
    return rec


def ring_vs_plain(model, layout, state, tokens):
    """Phase 6r: from one state and one gradient bus, one fused EDM step
    gossiping through the ring kernel and one plain EDM step gossiping
    through the rolls and the plain combine; x, m and ψ bit-equal."""
    import torch
    from repro_torch.core import build_mixer, make_edm_bus, ring
    from repro_torch.train import losses_and_grads

    x, m, psi = state["params"], state["opt"]["m"], state["opt"]["psi"]
    _, g = losses_and_grads(model, layout, x, {"tokens": tokens})
    with torch.no_grad():
        mix = build_mixer(ring(AGENTS), mode="static", engine="ppermute",
                          agents_per_device=AGENTS, use_fused_kernel=True,
                          transport="ring_dma")
        x_f, st = make_edm_bus(ALPHA, BETA, mix, use_fused_kernel=True).step(
            x, g, {"m": m.clone(), "psi": psi.clone()})
        fused = [x_f.cpu(), st["m"].cpu(), st["psi"].cpu()]   # host copies
        del x_f, st
        free()
        mix = build_mixer(ring(AGENTS), mode="static", engine="ppermute",
                          agents_per_device=AGENTS, use_fused_kernel=False,
                          transport="ppermute")
        x_p, st = make_edm_bus(ALPHA, BETA, mix, use_fused_kernel=False).step(
            x, g, {"m": m, "psi": psi})
        equal, err = True, 0.0
        for host, dev in zip(fused, (x_p, st["m"], st["psi"])):
            for a in range(AGENTS):
                eq, e = compare([host[a].cuda()], [dev[a]])
                equal, err = equal and eq, max(err, e)
        del x_p, st, fused, g
    free()
    check(equal, f"the ring step differs from the rolled plain step: max "
                 f"abs err {err}")
    return {"bit_equal": equal, "max_abs_err": err, "shape": list(x.shape)}


# ---------------------------------------------------------------------------
# phase 3m: the source-table combine against its plain version
# ---------------------------------------------------------------------------

def table_cases():
    """Phase 3m's tables on the main path's 4 agents: ``(name, src, w)``
    numpy tables of a degraded ring-4 round with agent 3 dead, of the ring
    with slot 1 late (its source the agent itself, its weight kept), and
    of a one-peer round padded to K = 3 with a weight-0 self slot."""
    import numpy as np
    from repro_torch.core import RoundRobinExp, ring
    from repro_torch.core.elastic import degrade_round
    from repro_torch.core.mixing import round_tables
    src, w = round_tables(ring(AGENTS))
    late = src.copy()
    late[1] = np.arange(AGENTS)
    return (("degraded ring, agent 3 dead",)
            + round_tables(degrade_round(ring(AGENTS), [1, 1, 1, 0])),
            ("ring, slot 1 late", late, w),
            ("one peer, weight-0 pad slot",)
            + round_tables(RoundRobinExp(AGENTS).rounds[0], 3))


def dense_of(src, w, A: int):
    """The table's W_eff: ``W[a, src[k, a]] += w[k, a]``."""
    import numpy as np
    W = np.zeros((A, A), np.float32)
    for k in range(src.shape[0]):
        W[np.arange(A), src[k]] += w[k]
    return W


def check_table(x, name, src_np, w_np, timed: bool, out_dtype=None):
    """The table kernel against ``table_combine_ref`` on one bus, out of
    place and into ``out=``; timed beside the plain version, the bound
    (one read of x, one write of the output) and one
    ``torch.matmul(W_eff, x.view(A, -1))`` (the same function as one
    library call; the port never calls it)."""
    import torch
    from repro_torch.kernels import ops, ref
    src = torch.from_numpy(src_np).cuda()
    w = torch.from_numpy(w_np).cuda()
    got = ops.table_combine(x, src, w, out_dtype=out_dtype)
    want = ref.table_combine_ref(x, src, w, out_dtype=out_dtype)
    equal, err = compare([got], [want])
    got.fill_(7.0)
    into = ops.table_combine(x, src, w, out_dtype=out_dtype, out=got)
    check(into.data_ptr() == got.data_ptr(), "table out= not in place")
    eq, e = compare([got], [want])
    equal, err = equal and eq, max(err, e)
    finite_rows = [a for a in range(x.shape[0])
                   if bool(torch.isfinite(got[a]).all())]
    del want
    check(equal, f"table_combine differs from its plain version ({name}, "
                 f"{x.dtype}): max abs err {err}")
    rec = {"case": name, "shape": list(x.shape), "dtype": str(x.dtype),
           "terms": int(src_np.shape[0]), "bit_equal": equal,
           "max_abs_err": err, "finite_rows": finite_rows}
    if timed:
        free()
        A, n = x.shape[0], x.numel()
        rec["ms"] = time_ms(lambda: ops.table_combine(x, src, w, out=got))
        rec["plain_ms"] = time_ms(lambda: ref.table_combine_ref(x, src, w))
        free()
        W = torch.from_numpy(dense_of(src_np, w_np, A)).cuda()
        lib = torch.matmul(W, x.view(A, -1))
        rec["library_max_abs_diff"] = float((lib.view(x.shape) - got).abs()
                                            .max())
        del lib
        free()
        rec["library_ms"] = time_ms(lambda: torch.matmul(W, x.view(A, -1)))
        rec["bytes"] = 2 * 4 * n              # one f32 read, one f32 write
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["bytes"], (2 * src_np.shape[0] - 1) * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del got
    free()
    return rec


def table_phase(bus_shape, gen):
    """Phase 3m: every table of ``table_cases`` at the full bus, clean
    (the degraded round timed) and with NaN / ±Inf in every agent's block
    (a weight-0 slot reading an Inf gives NaN, as the stack does); the
    degraded round on a bf16 bus with f32 out (the bf16 wire); and the
    poisoned run: agent 2's whole block NaN under the late table with both
    neighbour slots late, so only agent 2's own output may be NaN."""
    import torch
    recs = []
    x = torch.randn(bus_shape, generator=gen, device="cuda")
    cases = table_cases()
    for i, (name, src, w) in enumerate(cases):
        recs.append(check_table(x, name, src, w, timed=i == 0))
    ring_edges(x)
    for name, src, w in cases:
        recs.append(check_table(x, name + ", NaN / ±Inf", src, w, False))
    xb = x.to(torch.bfloat16)
    recs.append(check_table(xb, cases[0][0] + ", bf16 → f32", cases[0][1],
                            cases[0][2], False, out_dtype=torch.float32))
    del xb
    x.normal_(generator=gen)
    x[2] = float("nan")
    name, src, w = cases[1]
    src = src.copy()
    src[2] = src[0]                           # slots 1 and 2 late
    rec = check_table(x, "poisoned: agent 2 NaN, both neighbour slots late",
                      src, w, False)
    check(rec["finite_rows"] == [0, 1, 3], f"a late slot read agent 2's "
          f"NaN block: finite outputs {rec['finite_rows']}")
    recs.append(rec)
    del x
    free()
    return recs


# ---------------------------------------------------------------------------
# phases 3, 3w, 3r, 3m: the combines on a policy group's rows, in place
# ---------------------------------------------------------------------------

def group_rows(model):
    """Rows ``[r0, r1)`` of the grouped cell's attention group (phase 14's
    layout: a nonzero offset, after the embedding group)."""
    from repro_torch.train import bus_layout_for, resolve_features
    layout = bus_layout_for(model, AGENTS, resolve_features(bus_run(
        gossip_groups=GROUP_POLICY)).groups)
    g = next(g for g in layout.groups if g.name == "attn")
    return g.row, g.row + g.rows


def check_strided(kind: str, bus_shape, rows, gen, block_rows: int):
    """One combine on the group rows ``x = bus[:, r0:r1]`` of a full bus
    whose other rows are NaN, written into the same rows of a second bus
    (its other rows 7.0): the kernel reads and writes the rows in place.
    Bit-equal to its plain version on the same view, the second bus's
    other rows untouched, and the same call on contiguous copies of the
    rows (the unstrided call) bit-equal; both timed.  ``kind``: the ring
    kernel, the table kernel (the degraded round), the 3-ary combine (the
    self term read in place, the rolled neighbours fresh) or the q8
    combine (fresh int8 payloads, the output strided)."""
    import torch
    from repro_torch.core import ring
    from repro_torch.kernels import ops, ref
    r0, r1 = rows
    bus = torch.full(bus_shape, float("nan"), device="cuda")
    x = bus[:, r0:r1]
    x.normal_(generator=gen)
    dst_bus = torch.full(bus_shape, 7.0, device="cuda")
    dst = dst_bus[:, r0:r1]
    terms = [(t.shift, float(t.weight)) for t in ring(AGENTS).terms]
    ws = [w for _, w in terms]
    if kind == "ring_combine":
        def run(v, out):
            return ops.ring_combine(v, terms, out=out)

        def plain(v):
            return ref.ring_combine_ref(v, terms)
    elif kind == "table_combine":
        _, src_np, w_np = table_cases()[0]
        src = torch.from_numpy(src_np).cuda()
        w = torch.from_numpy(w_np).cuda()

        def run(v, out):
            return ops.table_combine(v, src, w, out=out)

        def plain(v):
            return ref.table_combine_ref(v, src, w)
    elif kind == "gossip_axpy":
        nbrs = [torch.roll(x, 1, 0), torch.roll(x, -1, 0)]

        def run(v, out):
            return ops.gossip_axpy([v] + nbrs, ws, out=out)

        def plain(v):
            return ref.gossip_axpy_ref([v] + nbrs, ws)
    else:
        nb = (r1 - r0) // block_rows
        q = torch.randint(-127, 128, x.shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        sc = torch.rand((AGENTS, nb), generator=gen, device="cuda")
        pays = [(q, sc), (torch.roll(q, 1, 0), torch.roll(sc, 1, 0)),
                (torch.roll(q, -1, 0), torch.roll(sc, -1, 0))]
        coefs = ref.wire_coefs(ws, [p[1] for p in pays])

        def run(v, out):
            return ops.gossip_axpy_wire(pays, ws, fmt="int8",
                                        block_rows=block_rows, out=out)

        def plain(v):
            return ref.gossip_axpy_q8_ref([p[0] for p in pays], coefs,
                                          block_rows=block_rows)
    got = run(x, dst)
    check(got.data_ptr() == dst.data_ptr(), f"{kind}: out= not written in "
          "place on the group rows")
    want = plain(x)
    equal, err = compare([dst], [want])
    untouched = bool((dst_bus[:, :r0] == 7.0).all()
                     and (dst_bus[:, r1:] == 7.0).all())
    del want, dst_bus
    free()
    xc = x.contiguous()
    oc = torch.empty(x.shape, device="cuda")
    run(xc, oc)
    dense_equal = same_bits(oc, dst)
    check(equal and untouched and dense_equal,
          f"{kind} on the group rows {rows} of {bus_shape}: bit-equal to "
          f"plain {equal} (max abs err {err}), other rows untouched "
          f"{untouched}, equal to the unstrided call {dense_equal}")
    rec = {"kernel": kind, "bus": list(bus_shape), "rows": [r0, r1],
           "bit_equal": equal, "max_abs_err": err,
           "other_rows_untouched": untouched,
           "unstrided_bit_equal": dense_equal,
           "strided_ms": time_ms(lambda: run(x, dst)),
           "unstrided_ms": time_ms(lambda: run(xc, oc))}
    del bus, x, dst, xc, oc, got
    free()
    return rec


def print_strided(tag: str, rec, smi: str) -> None:
    print(f"[{tag}] {rec['kernel']} on the group rows {rec['rows']} of "
          f"{tuple(rec['bus'])} in place: {rec['strided_ms']:.4f} ms; the "
          f"same rows contiguous (unstrided): {rec['unstrided_ms']:.4f} ms; "
          f"bit-equal to plain {rec['bit_equal']}; {smi}", flush=True)


# ---------------------------------------------------------------------------
# phases 5 and 4g: the graphed bus step
# ---------------------------------------------------------------------------

def bus_run(**kw):
    """The main path's RunConfig (ring, one-device ppermute, 4 agents),
    with ``kw`` over it."""
    from repro_torch.configs.base import RunConfig
    cfg = dict(global_batch=AGENTS, seq_len=SEQ, algorithm="edm",
               alpha=ALPHA, beta=BETA, topology="ring",
               gossip_engine="ppermute", agents_per_device=AGENTS,
               remat=False)
    cfg.update(kw)
    return RunConfig(**cfg)


def profile_graph_replay(model, run, state, batch):
    """Capture the bus step of ``run`` over ``state`` (one eager step, then
    the capture), then one replay under torch.profiler (device time and
    the training kernels' launches by kernel) and one between CUDA events
    (the graph's device span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import build_train_step, make_gossip_schedule
    from repro_torch.train.graphs import graph_train_step

    step = graph_train_step(build_train_step(
        model, run, make_gossip_schedule(run, AGENTS), use_fused_kernel=True,
        device="cuda"), state, batch)
    state, _ = step(state, batch)                   # eager, then captured
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        state, _ = step(state, batch)
        settle()
    rows = device_rows(prof)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    state, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    host_ms_ = (time.perf_counter() - t0) * 1e3
    return state, {"device_busy_ms": sum(r[0] for r in rows),
                   "kernel_launches": sum(r[1] for r in rows),
                   "traced": traced_launches(rows),
                   "buckets": bucket(rows), "top": rows[:8],
                   "graph_span_ms": start.elapsed_time(end),
                   "host_ms": host_ms_}


def stepped_state(model, run, batch):
    """A state of ``model`` (the bus, or the tree with ``packed_bus``
    off) one eager step past the seed-0 init (m and ψ nonzero, with a
    wire its residual too): where the twin checks of phases 6, 6r, 6w and
    6t start."""
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    state = init_state(model, run, AGENTS, seed=0, device="cuda")
    step = build_train_step(model, run, make_gossip_schedule(run, AGENTS),
                            use_fused_kernel=True, device="cuda")
    state, _ = step(state, batch)
    return state


def check_replay(tag: str, eprof, gprof, want) -> None:
    """One profiled eager step and one profiled graph replay ran the same
    training kernels, ``want`` (counter name → launches, the rest 0)."""
    full = dict.fromkeys(eprof["traced"], 0)
    full.update(want)
    check(eprof["traced"] == full and gprof["traced"] == full,
          f"{tag}: device traces hold {eprof['traced']} (eager step) and "
          f"{gprof['traced']} (graph replay), expected {full}")


def print_graph_profile(tag: str, median_ms: float, gprof) -> None:
    """One graphed replay's device busy time (profiler, kernels only) and
    span (CUDA events) against the CLI's median graphed step."""
    busy = gprof["device_busy_ms"]
    print(f"[{tag}] one graphed step: device busy {busy:.3f} ms in "
          f"{gprof['kernel_launches']} kernel launches (profiler), device "
          f"span {gprof['graph_span_ms']:.3f} ms (CUDA events), host "
          f"{gprof['host_ms']:.3f} ms; against the CLI's median graphed "
          f"step of {median_ms:.1f} ms the device is idle "
          f"{1 - busy / median_ms:.1%}", flush=True)
    for ms, count, key in gprof["top"]:
        print(f"[{tag}]   graphed top {ms:9.3f} ms  x{count:<5d} {key[:80]}")


GRAPH_STEPS = 3
# phase 4g runs the main model at full width with its depth cut 32 → 4
# (first to 8, then to 4 to make room for phase 29): graphed == eager
# holds layer by layer, and the cut keeps the whole script inside its time
GRAPH_LAYERS = 4
# (name, RunConfig fields): the ring (the ring kernel); round_robin on the
# exp graph (a ring round and a rolled round: two graphs) under
# warmup_cosine (the LR scale a device scalar written before each
# replay); the int8 wire
GRAPH_CASES = (("f32 ring", {}),
               ("exp round_robin, warmup_cosine",
                dict(topology="exp", gossip_schedule="round_robin",
                     warmup_steps=2, total_steps=6)),
               ("int8 wire", dict(wire="int8")))


def graph_trajectory(model, run, batches, graphed: bool, against=None,
                     n_agents: int = AGENTS, phi_rows=None):
    """``GRAPH_STEPS`` timed bus steps of ``n_agents`` agents from the
    seed-0 state, eager or graphed, then one more under torch.profiler (a
    replay when graphed): a record of host copies of the buses after the
    last step (``host``) — or, given ``against`` (another run's
    ``host``), whether the buses equal those bit for bit (``same``; no
    second copy is held on the host; the step and its graphs' memory are
    released first) — the metrics of every step, step
    seconds, the wrappers' launch counts over the timed steps, graph
    replays, peak allocated and reserved GiB, and the profiled step's
    device busy ms and training-kernel launches.  With ``phi_rows`` (an
    opt-out group's rows) also whether after every timed step those rows
    of x equal the EDM update's φ rows, ``(ψ' + x) − ψ`` (``opt_out_phi``;
    the copies are made outside the timed span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train.graphs import graph_train_step

    free()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, run, n_agents, seed=0, device="cuda")
    step = build_train_step(model, run, make_gossip_schedule(run, n_agents),
                            use_fused_kernel=True, device="cuda")
    if graphed:
        step = graph_train_step(step, state, batches[0])
    ops.reset_launch_counts()
    metrics, seconds, phi_ok = [], [], True
    for b in batches[:-1]:
        if phi_rows is not None:
            x0 = state["params"][:, phi_rows].clone()
            psi0 = state["opt"]["psi"][:, phi_rows].clone()
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}       # synchronises
        seconds.append(time.perf_counter() - t0)
        metrics.append(m)
        if phi_rows is not None:
            # φ = (ψ' + x) − ψ formed in x0's buffer (the sum commutes
            # exactly): the opt-out rows are 64 % of the hybrid bus, and
            # no third copy of them fits beside a graph's pool
            phi = x0.add_(state["opt"]["psi"][:, phi_rows]).sub_(psi0)
            del psi0
            phi_ok &= same_bits(state["params"][:, phi_rows], phi)
            del x0, phi
    rec = {"launches": ops.launch_counts(), "opt_out_phi": phi_ok,
           "replays": getattr(step, "replays", 0),
           "peak": (torch.cuda.max_memory_allocated() / 2**30,
                    torch.cuda.max_memory_reserved() / 2**30)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batches[-1])
        settle()
    metrics.append({k: float(v) for k, v in m.items()})
    rows = device_rows(prof)
    rec.update(metrics=metrics, seconds=seconds,
               busy_ms=sum(r[0] for r in rows), traced=traced_launches(rows),
               buckets=bucket(rows), top=rows[:6])
    del step, m
    free()
    bufs = [state["params"]] + [state["opt"][k] for k in sorted(state["opt"])]
    if "pipeline" in state:       # the live slot (the spare is dead)
        pipe = state["pipeline"]
        bufs.append(pipe["slot"][pipe["parity"]])
    if against is None:
        rec["host"] = [b.cpu() for b in bufs]
    else:
        rec["same"] = same_state(bufs, against)
    del bufs, state
    free()
    return rec


def same_state(a, b):
    """Two states' buses (host copies, or the live buses for ``a``):
    bit-equal, NaN matching NaN (one agent's block on the card at a
    time)."""
    return len(a) == len(b) and all(
        same_bits(x[i].cuda(), y[i].cuda()) for x, y in zip(a, b)
        for i in range(x.shape[0]))


def graph_phase(model, data, dgen, cases=GRAPH_CASES):
    """Phase 4g: under deterministic algorithms, eager against eager, then
    the graphed bus step against the eager one from one state and one
    token stream, for each of GRAPH_CASES: the metrics of ``GRAPH_STEPS``
    + 1 steps and the buses after them bit-equal; the wrappers
    counted the eager first step of each graph key and nothing else, and
    the profiled last step's device trace holds the same training kernels
    in the replay as in the eager step."""
    import torch
    batches = [data.sample(dgen, 1) for _ in range(GRAPH_STEPS + 1)]
    recs = []
    torch.use_deterministic_algorithms(True)
    try:
        for name, kw in cases:
            run = bus_run(**kw)
            eager = graph_trajectory(model, run, batches, False)
            rec = {"case": name}
            if name == "f32 ring":
                again = graph_trajectory(model, run, batches, False,
                                         against=eager["host"])
                rec["eager_eq_eager"] = (
                    again["same"] and again["metrics"] == eager["metrics"])
                check(rec["eager_eq_eager"], "under deterministic "
                      "algorithms two eager runs differ")
                del again
            graph = graph_trajectory(model, run, batches, True,
                                     against=eager["host"])
            rec["graph_eq_eager"] = (
                graph["same"] and graph["metrics"] == eager["metrics"])
            # one EDM and one combine launch a step: the wrappers count
            # every eager step, and the graphed run's eager first step of
            # each key; a replay runs the eager step's kernels
            eager_steps = GRAPH_STEPS - graph["replays"]
            rec["launches_measured"] = (
                graph["replays"] >= 1
                and sum(eager["launches"].values()) == 2 * GRAPH_STEPS
                and sum(graph["launches"].values()) == 2 * eager_steps
                and graph["traced"] == eager["traced"]
                and sum(eager["traced"].values()) == 2)
            for what, res in (("eager", eager), ("graphed", graph)):
                # the steps after each key's first (eager, captured) step
                first = GRAPH_STEPS - res["replays"] if res["replays"] else 1
                med = statistics.median(res["seconds"][first:]) * 1e3
                rec[what] = {
                    "step_ms": [round(t * 1e3, 2) for t in res["seconds"]],
                    "median_ms": med,
                    "tokens_per_s": AGENTS * SEQ / med * 1e3,
                    "busy_ms": res["busy_ms"],
                    "idle_share": 1 - res["busy_ms"] / med,
                    "launches": {k: v for k, v in res["launches"].items()
                                 if v},
                    "replays": res["replays"],
                    "traced_last_step": {k: v for k, v in
                                         res["traced"].items() if v},
                    "peak_allocated_gib": res["peak"][0],
                    "peak_reserved_gib": res["peak"][1]}
            check(rec["graph_eq_eager"] and rec["launches_measured"],
                  f"{name}: the graphed step differs from the eager step: "
                  f"{rec}")
            recs.append(rec)
            del eager, graph
            free()
    finally:
        torch.use_deterministic_algorithms(False)
    return recs


# ---------------------------------------------------------------------------
# phase 12: churn at full width
# ---------------------------------------------------------------------------

CHURN_STEPS = 6
# agent 3 drops at step 2 and rejoins at step 4
CHURN = {"n_agents": AGENTS, "epochs": [{"start": 0, "down": []},
                                        {"start": 2, "down": [3]},
                                        {"start": 4, "down": []}]}


def profiled(fn):
    """Run ``fn`` under torch.profiler (the card only): its device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        settle()
    return device_rows(prof)


def churn_traces(model, run, data, dgen):
    """The graphed churn run through the API, steps 3 (a replay of the
    degraded epoch's graph) and 5 (a replay of the last epoch's ring
    graph) profiled: the training kernels in each replay's device trace
    and the degraded replay's busy time."""
    import torch
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train.graphs import graph_train_step
    sched = make_gossip_schedule(run, AGENTS, churn=json.dumps(CHURN))
    batches = [data.sample(dgen, 1) for _ in range(CHURN_STEPS)]
    state = init_state(model, run, AGENTS, seed=0, device="cuda")
    step = graph_train_step(build_train_step(
        model, run, sched, use_fused_kernel=True, device="cuda"), state,
        batches[0])
    rows = {}
    for t, b in enumerate(batches):
        def one():
            nonlocal state
            state, m = step(state, b)
            float(m["loss"])
        if t in (3, 5):
            rows[t] = profiled(one)
        else:
            one()
    rec = {"replays": step.replays,
           "degraded_replay": traced_launches(rows[3]),
           "ring_replay": traced_launches(rows[5]),
           "degraded_busy_ms": sum(r[0] for r in rows[3]),
           "ring_busy_ms": sum(r[0] for r in rows[5])}
    del state, step
    free()
    return rec


def resize_phase():
    """Phase 12's resize at the smoke config on the card (full-width leaves
    are bf16, so a file rounds the f32 bus's m and ψ: survivors could not
    match an uninterrupted f32 run there).  A 4-agent run whose agent 3
    drops at step 2 for good, saved at step 2 and resumed at 3 agents
    (ring(4) degraded to its 3 survivors is ring(3): the table kernel
    against the ring kernel), bit-equal on the survivors at step 4; then
    saved at 3 and resumed at 4: the survivors' rows as saved, the joiner
    at the survivors' mean with ψ := x and m = 0, and one more step
    finite."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.elastic import DropPlan
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, bus_layout_for,
                                   checkpoint, init_state,
                                   make_gossip_schedule)
    smoke = build_model(get_smoke_config(ARCH))
    layout = bus_layout_for(smoke, AGENTS)
    run4 = bus_run(seq_len=16)
    run3 = bus_run(seq_len=16, global_batch=3, agents_per_device=3)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = [torch.randint(0, smoke.cfg.vocab_size, (AGENTS, 1, 16),
                            generator=gen, device="cuda") for _ in range(5)]

    def steps(state, run, sched, n_agents, toks):
        step = build_train_step(smoke, run, sched, use_fused_kernel=True,
                                device="cuda")
        for tok in toks:
            state, m = step(state, {"tokens": tok[:n_agents]})
            check(all(math.isfinite(float(v)) for v in m.values()),
                  f"resize phase: non-finite metrics {m}")
        return state

    HANDOFF_DIR.mkdir(parents=True, exist_ok=True)
    path, path3 = HANDOFF_DIR / "churn4.npz", HANDOFF_DIR / "churn3.npz"
    sched4 = make_gossip_schedule(run4, AGENTS, churn=DropPlan.from_events(
        AGENTS, [(0, []), (2, [3])]))
    full = steps(init_state(smoke, run4, AGENTS, seed=0, device="cuda"),
                 run4, sched4, AGENTS, tokens[:2])
    checkpoint.save_state(str(path), full, layout=layout)
    full = steps(full, run4, sched4, AGENTS, tokens[2:4])
    res = checkpoint.load_state_resized(
        str(path), init_state(smoke, run3, 3, device="cuda"), layout=layout)
    res = steps(res, run3, make_gossip_schedule(run3, 3), 3, tokens[2:4])
    shrink = same_bits(res["params"], full["params"][:3]) and all(
        same_bits(res["opt"][k], full["opt"][k][:3]) for k in ("m", "psi"))
    checkpoint.save_state(str(path3), res, layout=layout)
    grown = checkpoint.load_state_resized(
        str(path3), init_state(smoke, run4, AGENTS, device="cuda"),
        layout=layout)
    path.unlink()
    path3.unlink()
    mean = res["params"].sum(0) * torch.tensor(1 / 3, device="cuda")
    grow = (same_bits(grown["params"][:3], res["params"])
            and all(same_bits(grown["opt"][k][:3], res["opt"][k])
                    for k in ("m", "psi"))
            and same_bits(grown["opt"]["psi"][3], grown["params"][3])
            and not bool(grown["opt"]["m"][3].any())
            and bool(torch.allclose(grown["params"][3], mean, atol=1e-6)))
    steps(grown, run4, make_gossip_schedule(run4, AGENTS), AGENTS,
          tokens[4:])
    check(shrink and grow, f"resize: survivors bit-equal after the shrink "
          f"{shrink}, the grow's rows {grow}")
    return {"config": "smoke", "shrink_4_to_3_survivors_bit_equal": shrink,
            "grow_3_to_4_rows_as_saved": grow}


def churn_phase(model, data, dgen):
    """Phase 12: the main cell plus ``--churn CHURN``, graphed, through the
    CLI (counts reset before and read after: an eager step a graph key —
    3 EDM, 2 ring (epochs 0 and 2) and 1 table launch (the degraded epoch)
    — and 3 replays); each epoch's λ and wire bytes; the replays' device
    traces (table kernel in the degraded epoch, ring kernel outside it);
    the resize at the smoke config."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    args = MAIN_ARGS + ["--churn", json.dumps(CHURN)]
    args[args.index("--steps") + 1] = str(CHURN_STEPS)
    free()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = cli.main(args)
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(edm_update=3, ring_combine=2, table_combine=1)
    check(counts == want and res["graph_replays"] == 3,
          f"churn launched {counts} and replayed {res['graph_replays']}, "
          f"expected {want} and 3")
    for t, m in enumerate(res["metrics"]):
        check(all(math.isfinite(v) for v in m.values()),
              f"churn: non-finite metrics at step {t}: {m}")
    rec = {"launches": {k: v for k, v in counts.items() if v},
           "graph_replays": res["graph_replays"],
           "epochs": res["epochs"],
           "step_ms": [round(t * 1e3, 2) for t in res["step_seconds"]],
           # the replays: steps 1, 3 and 5
           "median_ms": statistics.median(res["step_seconds"][1::2]) * 1e3,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss": [m["loss"] for m in res["metrics"]]}
    run = res["run"]
    del res
    free()
    rec["traces"] = churn_traces(model, run, data, dgen)
    tr = rec["traces"]
    full = dict.fromkeys(tr["ring_replay"], 0)
    check(tr["degraded_replay"] == {**full, "edm_update": 1,
                                    "table_combine": 1}
          and tr["ring_replay"] == {**full, "edm_update": 1,
                                    "ring_combine": 1},
          f"churn replays traced {tr}")
    rec["idle_share"] = 1 - tr["degraded_busy_ms"] / rec["median_ms"]
    rec["resize"] = resize_phase()
    return rec


# ---------------------------------------------------------------------------
# phase 13: the overlapped pipeline at full width
# ---------------------------------------------------------------------------

OVERLAP_GRAPH_CASES = (("overlap f32 ring", dict(overlap="delayed")),
                       ("overlap int8 wire", dict(overlap="delayed",
                                                  wire="int8")))
STRAGGLER_LATE = ((1, (1,)),)                 # slot 1 late at step 1


def overlap_step0(model, data, dgen):
    """Step 0 of the delayed pipeline against the synchronous step, from
    one state and one batch, deterministic algorithms on: the same loss,
    m and ψ bit-equal, and the ring's mix of the new live payload equal to
    the synchronous step's x(1)."""
    import torch
    from repro_torch.core import ring
    from repro_torch.kernels import ops
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    batch = data.sample(dgen, 1)
    host, losses, equal = None, {}, False
    for name, run in (("sync", bus_run()), ("delayed",
                                             bus_run(overlap="delayed"))):
        state = init_state(model, run, AGENTS, seed=0, device="cuda")
        step = build_train_step(model, run, make_gossip_schedule(run, AGENTS),
                                use_fused_kernel=True, device="cuda")
        state, m = step(state, batch)
        losses[name] = float(m["loss"])
        x = state["params"]
        if name == "delayed":
            terms = [(t.shift, float(t.weight)) for t in ring(AGENTS).terms]
            x = ops.ring_combine(state["pipeline"]["slot"][
                state["pipeline"]["parity"]], terms)
        bufs = [x, state["opt"]["m"], state["opt"]["psi"]]
        if host is None:          # the synchronous step, on the host
            host = [b.cpu() for b in bufs]
        else:
            equal = (losses["sync"] == losses["delayed"]
                     and same_state(bufs, host))
        del state, step, x, bufs
        free()
    check(equal, f"delayed step 0 differs from the synchronous step: "
                 f"losses {losses}")
    return {"bit_equal": equal, "loss": losses["sync"]}


def straggler_vs_plain(model, data, dgen):
    """A StragglerPlan with slot 1 late at step 1, through the API: 2
    delayed steps with the kernels (step 0 the ring kernel, step 1 the
    table kernel, counted) against the same 2 steps with the plain
    versions, deterministic algorithms on: x, m, ψ and the live payload
    bit-equal."""
    from repro_torch.core.elastic import StragglerPlan
    from repro_torch.kernels import ops
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    run = bus_run(overlap="delayed")
    plan = StragglerPlan(3, STRAGGLER_LATE)
    batches = [data.sample(dgen, 1) for _ in range(2)]
    host, counts, equal = None, None, False
    for fused in (True, False):
        state = init_state(model, run, AGENTS, seed=0, device="cuda")
        step = build_train_step(model, run, make_gossip_schedule(run, AGENTS),
                                use_fused_kernel=fused, straggler_plan=plan,
                                device="cuda")
        ops.reset_launch_counts()
        for b in batches:
            state, m = step(state, b)
            check(all(math.isfinite(float(v)) for v in m.values()),
                  f"straggler run: non-finite metrics {m}")
        if fused:
            counts = {k: v for k, v in ops.launch_counts().items() if v}
        pipe = state["pipeline"]
        bufs = [state["params"], state["opt"]["m"], state["opt"]["psi"],
                pipe["slot"][pipe["parity"]]]
        if host is None:          # the kernels' run, on the host
            host = [b.cpu() for b in bufs]
        else:
            equal = same_state(bufs, host)
        del state, step, pipe, bufs
        free()
    check(equal and counts == {"edm_update": 2, "ring_combine": 1,
                               "table_combine": 1},
          f"straggler: fused == plain {equal}, launches {counts}")
    return {"bit_equal": equal, "launches": counts,
            "late": [[s, list(ks)] for s, ks in STRAGGLER_LATE]}


def overlap_phase(model, data, dgen):
    """Phase 13: the main cell plus ``--overlap delayed`` through the CLI,
    graphed, on the f32 ring and with ``--wire int8`` (counts reset before
    and read after: the eager first step of each parity's graph, 3
    replays); graphed == eager under deterministic algorithms at full
    width with the depth cut to ``GRAPH_LAYERS``, as 4g (PR 22: the
    script's time), whose profiled replay gives the training kernels,
    busy time and idle share against its own median step; step 0 == the
    synchronous step; the straggler plan against its plain twin."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    recs = {}
    for fmt, extra, want in (
            ("f32", [], {"edm_update": 2, "ring_combine": 2}),
            ("int8", ["--wire", "int8"],
             {"edm_update": 2, "gossip_axpy_q8": 2})):
        free()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = cli.main(MAIN_ARGS + ["--overlap", "delayed"] + extra)
        counts = ops.launch_counts()
        full = dict.fromkeys(counts, 0)
        full.update(want)
        check(counts == full and res["graph_replays"] == STEPS - 2,
              f"--overlap delayed {fmt} launched {counts} and replayed "
              f"{res['graph_replays']}, expected {full} and {STEPS - 2}")
        for t, m in enumerate(res["metrics"]):
            check(all(math.isfinite(v) for v in m.values()),
                  f"overlap {fmt}: non-finite metrics at step {t}: {m}")
        med = statistics.median(res["step_seconds"][2:]) * 1e3
        rec = {"launches": {k: v for k, v in counts.items() if v},
               "graph_replays": res["graph_replays"],
               "step_ms": [round(t * 1e3, 2) for t in res["step_seconds"]],
               "median_ms": med, "tokens_per_s": AGENTS * SEQ / med * 1e3,
               "peak_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2**30,
               "loss": [m["loss"] for m in res["metrics"]]}
        state = res["state"]
        del res
        check(state["pipeline"]["parity"] == STEPS % 2
              and bool(torch.isfinite(state["params"]).all()),
              f"overlap {fmt}: final state")
        recs[fmt] = rec
        del state
        free()
        print(f"[time] phase 13 {fmt} CLI done", flush=True)
    from repro_torch.models import build_model
    graph_model = build_model(dataclasses.replace(model.cfg,
                                                  n_layers=GRAPH_LAYERS))
    recs["graph"] = graph_phase(graph_model, data, dgen,
                                OVERLAP_GRAPH_CASES)
    for fmt, g in zip(("f32", "int8"), recs["graph"]):
        # the profiled replay of 4g's graphed trajectory (deterministic)
        want = recs[fmt]["launches"]
        check(g["graphed"]["traced_last_step"] == {k: 1 for k in want},
              f"overlap {fmt}: a replay traced "
              f"{g['graphed']['traced_last_step']}, expected one of each "
              f"of {sorted(want)}")
        recs[fmt].update(graph_layers=GRAPH_LAYERS,
                         busy_ms=g["graphed"]["busy_ms"],
                         idle_share=g["graphed"]["idle_share"],
                         replay_trace=g["graphed"]["traced_last_step"])
    print("[time] phase 13 graph == eager done", flush=True)
    torch.use_deterministic_algorithms(True)
    try:
        recs["step0"] = overlap_step0(graph_model, data, dgen)
        print("[time] phase 13 step 0 done", flush=True)
        recs["straggler"] = straggler_vs_plain(graph_model, data, dgen)
    finally:
        torch.use_deterministic_algorithms(False)
    del graph_model
    return recs


# ---------------------------------------------------------------------------
# phase 14: policy groups at full width
# ---------------------------------------------------------------------------

GROUP_STEPS = 6
# a user who keeps the embeddings local, gossips attention every step and
# sends the MLPs compressed every other step; the final norm on
# round_robin's rounds in bf16.  Every leaf matches: the trailing "dense"
# group is empty
GROUP_POLICY = json.dumps([
    {"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},
    {"name": "attn", "match": ["|attn|"]},
    {"name": "ffn", "match": ["|ffn|"], "gossip_every": 2, "wire": "int8"},
    {"name": "norm", "match": ["final_ln"], "wire": "bf16",
     "schedule": "round_robin"}])
# the 2-group all-gossip f32 layout: attention apart from the rest
TWO_GROUPS = json.dumps([{"name": "attn", "match": ["|attn|"]}])
# a replay's training kernels: every step the EDM update, the attention
# group's ring kernel and the norm group's bf16 → f32 combine; odd steps
# also the MLP group's q8 combine
GROUP_TRACE = {"even": {"edm_update": 1, "ring_combine": 1,
                        "gossip_axpy": 1},
               "odd": {"edm_update": 1, "ring_combine": 1, "gossip_axpy": 1,
                       "gossip_axpy_q8": 1}}


def group_replays(model, run, state, batches):
    """Graph the grouped step over ``state`` (at an even step): two steps
    run eagerly and are captured (one a graph key); then one even and one
    odd replay under torch.profiler, and one of each between CUDA events
    and on the host's clock (ending in a device sync).  Returns the state
    and, per parity, the replay's device busy ms, launches, training
    kernels, span, host ms and idle share (1 − busy / host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import build_train_step, make_gossip_schedule
    from repro_torch.train.graphs import graph_train_step

    step = graph_train_step(build_train_step(
        model, run, make_gossip_schedule(run, AGENTS), use_fused_kernel=True,
        device="cuda"), state, batches[0])
    for b in batches[:2]:
        state, _ = step(state, b)                   # eager, then captured
    recs = {}
    for b in batches[2:4]:
        parity = "odd" if int(state["step"]) % 2 else "even"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, b)
            settle()
        rows = device_rows(prof)
        traced = {k: v for k, v in traced_launches(rows).items() if v}
        check(traced == GROUP_TRACE[parity], f"a grouped {parity} replay "
              f"traced {traced}, expected {GROUP_TRACE[parity]}")
        recs[parity] = {"busy_ms": sum(r[0] for r in rows),
                        "kernel_launches": sum(r[1] for r in rows),
                        "traced": traced, "top": rows[:6]}
    for b in batches[4:6]:
        parity = "odd" if int(state["step"]) % 2 else "even"
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, _ = step(state, b)
        end.record()
        torch.cuda.synchronize()
        r = recs[parity]
        r["host_ms"] = (time.perf_counter() - t0) * 1e3
        r["span_ms"] = start.elapsed_time(end)
        r["idle_share"] = 1 - r["busy_ms"] / r["host_ms"]
    check(len(step.graphs) == 2 and step.replays == 4,
          f"{len(step.graphs)} graphs and {step.replays} replays, expected "
          "2 and 4")
    return state, recs


def bus_leaves(layout, state):
    """``((bus, path), view)`` of every leaf of x, m and ψ in the bus dtype
    (f32): a layout-free view of a bus state."""
    from repro_torch.core import bus as parambus
    for k, b in (("x", state["params"]), ("m", state["opt"]["m"]),
                 ("psi", state["opt"]["psi"])):
        for path, v in parambus.leaf_views(layout, b).items():
            yield (k, path), v


def grouped_vs_ungrouped(model, batches):
    """The 2-group all-gossip f32 ring (two ring launches a step, each on
    its group's rows in place) against the ungrouped ring step, both
    graphed, ``GRAPH_STEPS`` steps from the seed-0 state: every leaf of
    x, m and ψ bit-equal (the ungrouped leaves held on the host, compared
    on the card one at a time)."""
    from repro_torch.kernels import ops
    from repro_torch.train import (build_train_step, bus_layout_for,
                                   init_state, make_gossip_schedule,
                                   resolve_features)
    from repro_torch.train.graphs import graph_train_step
    host, equal, n = {}, True, 0
    for groups in ("", TWO_GROUPS):
        free()
        run = bus_run(gossip_groups=groups)
        layout = bus_layout_for(model, AGENTS, resolve_features(run).groups)
        state = init_state(model, run, AGENTS, seed=0, device="cuda")
        step = graph_train_step(build_train_step(
            model, run, make_gossip_schedule(run, AGENTS),
            use_fused_kernel=True, device="cuda"), state, batches[0])
        ops.reset_launch_counts()
        for b in batches[:GRAPH_STEPS]:
            state, _ = step(state, b)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        want = {"edm_update": 1, "ring_combine": 2 if groups else 1}
        check(counts == want and step.replays == GRAPH_STEPS - 1,
              f"groups {groups or 'none'}: launched {counts}, replayed "
              f"{step.replays}; expected {want} and {GRAPH_STEPS - 1}")
        for key, v in bus_leaves(layout, state):
            if not groups:
                host[key] = v.cpu()
            else:
                equal &= same_bits(v, host.pop(key).cuda())
                n += 1
        del state, step
    equal &= not host
    check(equal, "the 2-group f32 ring trajectory differs from the "
                 "ungrouped one")
    free()
    return {"bit_equal": equal, "steps": GRAPH_STEPS, "leaves": n}


def grouped_graph_vs_eager(model, batches):
    """The 4-group policy, ``GRAPH_STEPS`` + 1 steps eager and graphed from
    the seed-0 state under deterministic algorithms: the metrics of every
    step and the buses bit-equal; after every step the opt-out group's
    rows of x equal the EDM kernel's φ rows, ``(ψ' + x) − ψ``."""
    import torch
    from repro_torch.train import (build_train_step, bus_layout_for,
                                   init_state, make_gossip_schedule,
                                   resolve_features)
    from repro_torch.train.graphs import graph_train_step
    run = bus_run(gossip_groups=GROUP_POLICY)
    layout = bus_layout_for(model, AGENTS, resolve_features(run).groups)
    g = next(g for g in layout.groups if g.name == "embed")
    rows = slice(g.row, g.row + g.rows)
    out = {}
    for graphed in (False, True):
        free()
        state = init_state(model, run, AGENTS, seed=0, device="cuda")
        step = build_train_step(model, run, make_gossip_schedule(
            run, AGENTS), use_fused_kernel=True, device="cuda")
        if graphed:
            step = graph_train_step(step, state, batches[0])
        metrics, opt_out_phi = [], True
        for b in batches[:GRAPH_STEPS + 1]:
            x0 = state["params"][:, rows].clone()
            psi0 = state["opt"]["psi"][:, rows].clone()
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            phi = (state["opt"]["psi"][:, rows] + x0) - psi0
            opt_out_phi &= same_bits(state["params"][:, rows], phi)
            del x0, psi0, phi
        bufs = [state["params"], state["opt"]["m"], state["opt"]["psi"]]
        if graphed:
            same = same_state(bufs, out["eager"]["host"])
            out["graphed"] = {"metrics": metrics, "same": same,
                              "opt_out_phi": opt_out_phi,
                              "graphs": len(step.graphs),
                              "replays": step.replays}
        else:
            out["eager"] = {"metrics": metrics, "opt_out_phi": opt_out_phi,
                            "host": [b.cpu() for b in bufs]}
        del state, step, bufs
    e, gr = out["eager"], out["graphed"]
    rec = {"graph_eq_eager": gr["same"] and gr["metrics"] == e["metrics"],
           "opt_out_rows_eq_phi": e["opt_out_phi"] and gr["opt_out_phi"],
           "graphs": gr["graphs"], "replays": gr["replays"],
           "steps": GRAPH_STEPS + 1}
    check(rec["graph_eq_eager"] and rec["opt_out_rows_eq_phi"]
          and rec["graphs"] == 2, f"the grouped graphed step: {rec}")
    del out
    free()
    return rec


def group_phase(model, data, dgen):
    """Phase 14: the main cell plus ``--gossip-groups`` (GROUP_POLICY)
    through the CLI at full depth, graphed, 6 steps, counts reset before
    and read after (the eager first step of each of the 2 graph keys: 2
    EDM, 2 ring, 2 bf16 combine and 1 q8 launch; 4 replays); each group's
    rows and modeled wire bytes; median even (no MLP gossip) and odd
    step.  Then, at full width with the depth cut to ``GRAPH_LAYERS`` as
    4g and phase 13 (for the script's time): one even and one odd
    replay profiled from the seed-0 state (busy, host, idle, the
    kernels), the 2-group f32 ring == the ungrouped ring and graphed ==
    eager."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model
    from repro_torch.train import init_state
    free()
    args = MAIN_ARGS + ["--gossip-groups", GROUP_POLICY]
    args[args.index("--steps") + 1] = str(GROUP_STEPS)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = cli.main(args)
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(edm_update=2, ring_combine=2, gossip_axpy=2,
                gossip_axpy_q8=1)
    check(counts == want and res["graph_replays"] == GROUP_STEPS - 2
          and res["graphs"] == 2,
          f"the grouped cell launched {counts}, replayed "
          f"{res['graph_replays']} steps in {res['graphs']} graphs; "
          f"expected {want}, {GROUP_STEPS - 2} and 2")
    for t, m in enumerate(res["metrics"]):
        check(all(math.isfinite(v) for v in m.values()),
              f"grouped cell: non-finite metrics at step {t}: {m}")
    secs = res["step_seconds"]
    rec = {"launches": {k: v for k, v in counts.items() if v},
           "graph_replays": res["graph_replays"], "graphs": res["graphs"],
           "step_ms": [round(t * 1e3, 2) for t in secs],
           "even_ms": statistics.median(secs[2::2]) * 1e3,
           "odd_ms": statistics.median(secs[3::2]) * 1e3,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
           "groups": res["groups"],
           "loss": [m["loss"] for m in res["metrics"]]}
    state, run = res["state"], res["run"]
    del res
    check(state["step"] == GROUP_STEPS
          and bool(torch.isfinite(state["params"]).all()),
          "grouped cell: final state")
    del state
    free()
    print("[time] phase 14 CLI done", flush=True)
    graph_model = build_model(dataclasses.replace(model.cfg,
                                                  n_layers=GRAPH_LAYERS))
    rec["graph_layers"] = GRAPH_LAYERS
    batches = [data.sample(dgen, 1) for _ in range(6)]
    state = init_state(graph_model, run, AGENTS, seed=0, device="cuda")
    state, rec["replays"] = group_replays(graph_model, run, state, batches)
    del state
    free()
    print("[time] phase 14 replays done", flush=True)
    batches = [data.sample(dgen, 1) for _ in range(GRAPH_STEPS + 1)]
    rec["two_groups_eq_ungrouped"] = grouped_vs_ungrouped(graph_model,
                                                          batches)
    print("[time] phase 14 grouped == ungrouped done", flush=True)
    torch.use_deterministic_algorithms(True)
    try:
        rec["graph_eq_eager"] = grouped_graph_vs_eager(graph_model, batches)
    finally:
        torch.use_deterministic_algorithms(False)
    del graph_model
    return rec


# ---------------------------------------------------------------------------
# phase 7: the serving kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16: both sides round one f32 result once, so they differ by at most
# one bf16 ulp of the reference, ≤ 2⁻⁷·|want|, plus the f32 bound
SERVE_ATOL, BF16_RTOL = 2e-5, 2.0 ** -7


def serve_tol(dtype):
    """(atol, rtol) of a serving kernel against its plain version, compared
    in f32: the JAX tests' bound for the Pallas kernels (atol 2e-5), and
    for bf16 one bf16 ulp of the reference on top."""
    import torch
    return SERVE_ATOL, (0.0 if dtype == torch.float32 else BF16_RTOL)


def serve_err(got, want, dtype, what: str):
    """(max |got − want|, max |got − want| / (atol + rtol·|want|)); raises
    if the second exceeds 1."""
    atol, rtol = serve_tol(dtype)
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ratio = float((diff / (atol + rtol * w.abs())).max()) \
        if diff.numel() else 0.0
    check(ratio <= 1.0, f"{what} {dtype}: max abs err {err}, "
          f"{ratio:.3f} × the tolerance (atol {atol}, rtol {rtol})")
    return err, ratio


def peak_flops(dtype) -> float:
    import torch
    return F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S


def decode_inputs(B, K, G, hd, page_size, kv_len, seed, dtype):
    """A ragged slot batch: slot b owns ceil(kv_len[b] / page_size) pages
    of a shuffled pool; every other page, the null page too, is NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    kv_len = np.asarray(kv_len, np.int32)
    used = [-(-int(n) // page_size) for n in kv_len]
    num_pages = 1 + sum(used) + 2
    phys = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((B, max(used)), np.int32)
    at = 0
    for b, n in enumerate(used):
        pt[b, :n] = phys[at:at + n]
        at += n
    q = rng.standard_normal((B, K, G, hd), np.float32)
    kp = rng.standard_normal((num_pages, page_size, K, hd), np.float32)
    vp = rng.standard_normal((num_pages, page_size, K, hd), np.float32)
    dead = np.setdiff1d(np.arange(num_pages), phys[:at])
    kp[dead] = np.nan
    vp[dead] = np.nan
    return [torch.from_numpy(a).cuda().to(dtype) for a in (q, kp, vp)] + [
        torch.from_numpy(pt).cuda(), torch.from_numpy(kv_len).cuda()]


def check_decode(case, dtype, timed: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._ffi import sm_count
    from repro_torch.kernels.paged_attention import (paged_attention_flat,
                                                     split_plan)
    B, K, G, hd, ps = (case[k] for k in ("B", "K", "G", "hd", "page_size"))
    q, kp, vp, pt, kv = decode_inputs(B, K, G, hd, ps, case["kv_len"], B,
                                      dtype)
    # kernel and plain version on the same pools, dead rows zeroed (the
    # plain version gathers whole page-table rows, null tail entries at
    # weight 0); then the kernel on the NaN-poisoned pools must give the
    # same bits, finite, with a zero tile for the idle slot
    kc, vc = kp.nan_to_num(), vp.nan_to_num()
    got = ops.paged_attention(q, kc, vc, pt, kv, page_size=ps)
    want = ref.paged_attention_ref(q, kc, vc, pt, kv, page_size=ps)
    err, ratio = serve_err(got, want, dtype,
                           f"paged_attention {case['name']}")
    poisoned = ops.paged_attention(q, kp, vp, pt, kv, page_size=ps)
    idle = kv == 0
    check(bool(torch.isfinite(poisoned).all())
          and bool((poisoned[idle] == 0).all())
          and torch.equal(poisoned, got),
          f"paged_attention {case['name']}: on poisoned pools a non-finite "
          "output, a non-zero idle tile, or bits that differ from the "
          "clean pools'")
    rec = {"case": case["name"], "dtype": str(dtype)[6:],
           "shape": [B, K, G, hd], "max_abs_err": err, "err_over_tol": ratio}
    if timed:
        out = torch.empty_like(q)
        rec["ms"] = time_ms(lambda: paged_attention_flat(
            q, kp, vp, pt, kv, page_size=ps, out=out))
        rec["plain_ms"] = time_ms(lambda: ref.paged_attention_ref(
            q, kc, vc, pt, kv, page_size=ps))
        # yardstick: one SDPA call over K/V gathered beforehand, GQA-shared
        kd = ref.gather_pages(kc, pt).transpose(1, 2)       # (B, K, L, hd)
        vd = ref.gather_pages(vc, pt).transpose(1, 2)
        qd = q.reshape(B, 1, K * G, hd).transpose(1, 2)     # (B, H, 1, hd)
        mask = (torch.arange(kd.shape[2], device="cuda")[None]
                < kv[:, None])[:, None, None, :]
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True))
        rows = int(kv.sum())
        es = q.element_size()
        pages = int(((kv + ps - 1) // ps).sum())
        rec["bytes"] = (2 * rows * K * hd * es + 2 * q.numel() * es
                        + 4 * (pages + B))
        rec["flops"] = 4 * rows * K * G * hd
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["bytes"], rec["flops"], peak_flops(dtype))
        rec["bound_fraction"] = rec["bound_ms"] / rec["ms"]
        rec["kv_rows"] = rows
        rec["n_split"], rec["split_keys"] = split_plan(
            B, K, pt.shape[1] * ps, ps, sms=sm_count(q.device))
    del q, kp, vp, kc, vc, got, want, poisoned
    return rec


def prefill_inputs(window, start, C, K, G, hd, page_size, n_pages,
                   num_pages, seed, dtype):
    """One slot's history written into NaN-poisoned pools (the null page a
    zero write sink), as tests/test_chunked_prefill.py builds them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    k_hist = rng.standard_normal((start, K, hd), np.float32)
    v_hist = rng.standard_normal((start, K, hd), np.float32)
    k_pool = np.full((num_pages, page_size, K, hd), np.nan, np.float32)
    v_pool = np.full((num_pages, page_size, K, hd), np.nan, np.float32)
    n_slot = (window // page_size) if window else n_pages
    pt_row = np.zeros((n_pages,), np.int32)
    pt_row[:n_slot] = rng.choice(np.arange(1, num_pages), size=n_slot,
                                 replace=False)
    k_pool[0] = 0.0
    v_pool[0] = 0.0
    for p in range(start):
        row = p % window if window else p
        k_pool[pt_row[row // page_size], row % page_size] = k_hist[p]
        v_pool[pt_row[row // page_size], row % page_size] = v_hist[p]
    q = rng.standard_normal((1, C, K * G, hd), np.float32)
    k_c = rng.standard_normal((1, C, K, hd), np.float32)
    v_c = rng.standard_normal((1, C, K, hd), np.float32)
    return [torch.from_numpy(a).cuda().to(dtype)
            for a in (q, k_c, v_c, k_pool, v_pool)] + [
        torch.from_numpy(pt_row).cuda()]


def prefill_mask(window, start, C, clen, n_rows):
    """(C, n_rows + C) mask of the keys each chunk query may see: the
    slot's earlier rows (ring-aware positions), then the chunk's own."""
    import torch
    from repro_torch.models.attention import prev_page_positions
    kpos_prev, valid_prev = prev_page_positions(n_rows, start, window,
                                                device="cuda")
    qpos = start + torch.arange(C, device="cuda")
    kpos = torch.cat([kpos_prev.long(), qpos])
    valid = torch.cat([valid_prev, torch.arange(C, device="cuda") < clen])
    mask = valid[None] & (kpos[None] <= qpos[:, None])
    if window:
        mask &= kpos[None] > qpos[:, None] - window
    return mask


def check_prefill(case, dtype, timed: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_prefill import paged_prefill_flat
    window, start, C, clen, K, G, hd, ps, n_pages, num_pages = case
    q, kc, vc, kp, vp, pt_row = prefill_inputs(
        window, start, C, K, G, hd, ps, n_pages, num_pages, start + C, dtype)
    # the plain version zeroes dead rows itself, so both take the poisoned
    # pools; the kernel must also give the same bits on the clean pools
    got = ops.paged_prefill_attention(q, kc, vc, kp, vp, pt_row, start,
                                      clen, page_size=ps, window=window)
    want = ref.paged_prefill_attention_ref(q, kc, vc, kp, vp, pt_row, start,
                                           clen, page_size=ps, window=window)
    clean = ops.paged_prefill_attention(q, kc, vc, kp.nan_to_num(),
                                        vp.nan_to_num(), pt_row, start, clen,
                                        page_size=ps, window=window)
    got, want, clean = got[:, :clen], want[:, :clen], clean[:, :clen]
    check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
          f"paged_prefill {case}: non-finite output or bits that differ "
          "from the clean pools' (a poisoned row read)")
    err, ratio = serve_err(got, want, dtype, f"paged_prefill {case}")
    rec = {"case": list(case), "dtype": str(dtype)[6:], "max_abs_err": err,
           "err_over_tol": ratio}
    if timed:
        H = K * G
        # the kernel alone, on operands already in its (K, C·G, hd) layout
        qk = q.reshape(C, K, G, hd).permute(1, 0, 2, 3).reshape(
            K, C * G, hd).contiguous()
        kck = kc[0].permute(1, 0, 2).contiguous()
        vck = vc[0].permute(1, 0, 2).contiguous()
        out = torch.empty_like(qk)
        rec["ms"] = time_ms(lambda: paged_prefill_flat(
            qk, kck, vck, kp, vp, pt_row, start, clen, page_size=ps,
            window=window, out=out))
        rec["host_ms"] = host_ms(lambda: paged_prefill_flat(
            qk, kck, vck, kp, vp, pt_row, start, clen, page_size=ps,
            window=window, out=out))
        rec["op_ms"] = time_ms(lambda: ops.paged_prefill_attention(
            q, kc, vc, kp, vp, pt_row, start, clen, page_size=ps,
            window=window))
        rec["plain_ms"] = time_ms(lambda: ref.paged_prefill_attention_ref(
            q, kc, vc, kp, vp, pt_row, start, clen, page_size=ps,
            window=window))
        n_rows = n_pages * ps
        mask = prefill_mask(window, start, C, clen, n_rows)
        kd = torch.cat([ref.gather_pages(kp.nan_to_num(), pt_row[None]), kc],
                       dim=1).transpose(1, 2)              # (1, K, R+C, hd)
        vd = torch.cat([ref.gather_pages(vp.nan_to_num(), pt_row[None]), vc],
                       dim=1).transpose(1, 2)
        qd = q.transpose(1, 2)                               # (1, H, C, hd)
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[None, None], enable_gqa=True))
        es = q.element_size()
        prev = min(start, window) if window else start
        rec["bytes"] = (2 * prev * K * hd * es + 2 * C * K * hd * es
                        + 2 * C * H * hd * es + 4 * -(-prev // ps))
        rec["flops"] = 4 * int(mask.sum()) * K * G * hd
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["bytes"], rec["flops"], peak_flops(dtype))
    return rec


# (window, start, C, chunk_len, K, G, hd, page_size, n_pages, num_pages):
# the 11 KERNEL_CASES of tests/test_chunked_prefill.py; smollm_360m's heads
# at the serve CLI's shapes (16-token chunks, C·G = 48 so the last 32-row
# query tile is partial, 4 pages per slot); then 128-token chunks over
# 16-row pages at context 1024, linear and a 256-row ring
PREFILL_CASES = [(w, s, C, n, 2, 2, 8, 4, 6, 16) for w, s, C, n in [
    (0, 0, 4, 4), (0, 4, 4, 4), (0, 9, 4, 3), (0, 20, 4, 1),
    (8, 0, 4, 4), (8, 4, 4, 4), (8, 7, 4, 4), (8, 8, 4, 4),
    (8, 13, 4, 3), (8, 37, 4, 2), (8, 37, 8, 8)]] + [
    (0, s, 16, n, 5, 3, 64, PAGE, 4, 40)
    for s, n in ((0, 16), (16, 16), (16, 7), (32, 1))] + [
    (w, s, CHUNK, n, 5, 3, 64, PAGE, CTX // PAGE, 80)
    for w in (0, 256) for s, n in ((0, 128), (128, 128), (640, 77))]
# timed: the longest-context chunk of phase 8's trace (prompts ≤ 768)
PREFILL_TIMED = (0, 640, CHUNK, CHUNK, 5, 3, 64, PAGE, CTX // PAGE, 80)
# head dim 128: deepseek_moe_16b's heads (K 16, G 1; timed, phase 15's
# longest-context chunk), qwen3_moe_235b_a22b's (K 4, G 16) and
# pixtral_12b's (K 8, G 4; timed, phase 19's longest-context chunk; 77
# rows a partial query tile)
PREFILL_TIMED_HD128 = (0, 640, CHUNK, CHUNK, 16, 1, 128, PAGE, CTX // PAGE,
                       80)
PREFILL_TIMED_G4 = (0, 640, CHUNK, CHUNK, 8, 4, 128, PAGE, CTX // PAGE, 80)
# a tensor-parallel rank of qwen3_14b over 4 ranks (phase 31): K 2, G 5
# (timed: its longest-context chunk), and the split plan's few blocks at
# a short history
PREFILL_TIMED_TP = (0, 640, CHUNK, CHUNK, 2, 5, 128, PAGE, CTX // PAGE, 80)
# a deepseek_moe_16b rank in the EP + TP layout over 4 ranks (phase 29
# (b)): K 4, G 1 (timed: its longest-context chunk)
PREFILL_TIMED_EP_TP = (0, 640, CHUNK, CHUNK, 4, 1, 128, PAGE, CTX // PAGE,
                       80)
PREFILL_CASES += [(w, s, CHUNK, n, K, G, 128, PAGE, CTX // PAGE, 80)
                  for K, G in ((16, 1), (4, 16), (8, 4))
                  for w, s, n in ((0, 0, 128), (0, 640, 77),
                                  (256, 640, 128))] + [
    (0, 640, CHUNK, CHUNK, 4, 16, 128, PAGE, CTX // PAGE, 80)] + [
    (w, s, CHUNK, n, K, G, 128, PAGE, CTX // PAGE, 80)
    for K, G in ((2, 5), (4, 1))
    for w, s, n in ((0, 0, 128), (0, 128, 128), (0, 640, 77),
                    (256, 640, 128))]
DECODE_CASES = [
    # tests/test_serve.py's ragged batch: idle slot 1, full slot 2
    dict(name="ragged", B=4, K=2, G=3, hd=16, page_size=8,
         kv_len=[5, 0, 24, 17]),
    # smollm_360m's heads at the serve CLI's shapes: 8 slots, 4 pages each
    dict(name="smollm_360m_cli", B=8, K=5, G=3, hd=64, page_size=PAGE,
         kv_len=[64, 0, 17, 33, 1, 48, 16, 63]),
    # smollm_360m's heads, phase 8's 16 slots, contexts up to 1024, 1 idle
    dict(name="smollm_360m", B=SLOTS, K=5, G=3, hd=64, page_size=PAGE,
         kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700, 129, 33, 1000,
                 64, 900, 15, 384]),
    # head dim 128 at the same slots and contexts: deepseek_moe_16b's
    # heads (MHA, G 1; phase 15 serves them) and qwen3_moe_235b_a22b's
    # (G 16: two blocks a KV head)
    dict(name="deepseek_moe_16b", B=SLOTS, K=16, G=1, hd=128,
         page_size=PAGE, kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700,
                                 129, 33, 1000, 64, 900, 15, 384]),
    dict(name="qwen3_moe_235b_a22b", B=SLOTS, K=4, G=16, hd=128,
         page_size=PAGE, kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700,
                                 129, 33, 1000, 64, 900, 15, 384]),
    # pixtral_12b's heads (K 8, G 4; phase 19 serves them)
    dict(name="pixtral_12b", B=SLOTS, K=8, G=4, hd=128,
         page_size=PAGE, kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700,
                                 129, 33, 1000, 64, 900, 15, 384]),
    # a tensor-parallel rank of qwen3_14b over 4 ranks (K 2, G 5; phase
    # 31 serves them): phase 31's 8 slots, contexts up to 1024, 1 idle
    dict(name="qwen3_14b_tp", B=8, K=2, G=5, hd=128, page_size=PAGE,
         kv_len=[1024, 0, 256, 700, 1, 513, 129, 900]),
    # a deepseek_moe_16b rank in the EP + TP layout over 4 ranks (K 4, G
    # 1; phase 29 (b) serves them): its 8 slots, contexts up to 1024
    dict(name="deepseek_moe_16b_tp", B=8, K=4, G=1, hd=128,
         page_size=PAGE, kv_len=[1024, 0, 256, 700, 1, 513, 129, 900]),
]
# timed in bf16: smollm_360m's heads (phase 8), deepseek_moe_16b's (phase
# 15), pixtral_12b's (phase 19), a qwen3_14b TP rank's (phase 31) and a
# deepseek_moe_16b EP + TP rank's (phase 29 (b))
DECODE_TIMED = {"smollm_360m": "paged_attention",
                "deepseek_moe_16b": "paged_attention_hd128",
                "pixtral_12b": "paged_attention_g4",
                "qwen3_14b_tp": "paged_attention_tp",
                "deepseek_moe_16b_tp": "paged_attention_ep_tp"}


def serving_kernels():
    """Phase 7: every case in f32 and bf16; the full-width cases of
    smollm_360m (hd 64), deepseek_moe_16b (hd 128, G 1), pixtral_12b (hd
    128, G 4), a qwen3_14b tensor-parallel rank (hd 128, K 2, G 5) and a
    deepseek_moe_16b EP + TP rank (hd 128, K 4, G 1) timed in bf16 (the
    serving dtype)."""
    import torch
    recs = {"paged_attention": [], "paged_prefill": []}
    timed = {}
    prefill_timed = {PREFILL_TIMED: "paged_prefill",
                     PREFILL_TIMED_HD128: "paged_prefill_hd128",
                     PREFILL_TIMED_G4: "paged_prefill_g4",
                     PREFILL_TIMED_TP: "paged_prefill_tp",
                     PREFILL_TIMED_EP_TP: "paged_prefill_ep_tp"}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for case in DECODE_CASES:
            key = DECODE_TIMED.get(case["name"]) if bf16 else None
            rec = check_decode(case, dtype, timed=key is not None)
            recs["paged_attention"].append(rec)
            if key:
                timed[key] = rec
        for case in PREFILL_CASES + list(prefill_timed):
            key = prefill_timed.get(case) if bf16 else None
            rec = check_prefill(case, dtype, timed=key is not None)
            recs["paged_prefill"].append(rec)
            if key:
                timed[key] = rec
        free()
    return recs, timed


# ---------------------------------------------------------------------------
# phases 8 and 9: serving
# ---------------------------------------------------------------------------

# torch.profiler keeps the device records that fall inside its window on
# the host's clock, and a region closed the moment the device drains has
# lost the records of its last kernels (27–35 ms of kernels at the end of a
# full-width eager step, the EDM update and the combine among them; the
# driven runs counted them).  So every profiled region ends by holding the
# window open past them: tools/profile_loss.py counts, with and without the
# settle, the launches whose device record is missing.
PROFILE_SETTLE_S = 0.2


def settle() -> None:
    """The last statement of a profiled region: the device drained, then
    the profiler's window held open ``PROFILE_SETTLE_S`` more."""
    import torch
    torch.cuda.synchronize()
    time.sleep(PROFILE_SETTLE_S)


def device_rows(prof):
    """(device ms, launches, kernel name) of every kernel in a trace."""
    from torch.autograd import DeviceType
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    return rows


# the training kernels' launch counters and their names in a device trace
TRACED = (("edm_update", "edm_update_kernel"), ("edm_update_ef", "edm_ef_"),
          ("gossip_axpy", "gossip_axpy_kernel"),
          ("gossip_axpy_q8", "gossip_axpy_q8_kernel"),
          ("ring_combine", "ring_combine_kernel"),
          ("ring_peer", "ring_peer_kernel"),
          ("table_combine", "table_combine_kernel"),
          ("table_peer", "table_peer_kernel"),
          ("table_peer_q8", "table_peer_q8_kernel"))


def traced_launches(rows):
    """Launches of the port's training kernels in a device trace, by
    counter name: kernels as the device ran them, a CUDA graph's replay
    included (no wrapper counts a replay)."""
    return {name: sum(n for _, n, key in rows if kernel in key)
            for name, kernel in TRACED}


def profile_dispatches(eng, vocab: int):
    """Time mixed and decode-only dispatches of the 1024-context engine
    (host clock, each ending in a device sync) and profile the fourth of
    each kind: device busy ms, launches, idle share against the median."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    rng = np.random.default_rng(9)
    eng.reset()
    for i in range(8):       # 8 slots, 2 chunks of 128 each, then decode
        check(eng.try_admit(Request(rid=i, tokens=rng.integers(
            0, vocab, (2 * CHUNK,)).astype(np.int32), max_new=64,
            arrival=0.0)), "profile request not admitted")
    times = {"mixed": [], "decode": []}
    out = {}
    while len(times["decode"]) < 8:
        kind = "mixed" if eng._filling else "decode"
        torch.cuda.synchronize()
        if len(times[kind]) == 3 and kind not in out:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.step()
                settle()
            rows = device_rows(prof)
            out[kind] = {"device_busy_ms": sum(r[0] for r in rows),
                         "kernel_launches": sum(r[1] for r in rows),
                         "buckets": bucket(rows), "top": rows[:8]}
            continue
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
    for kind, rec in out.items():
        rec["median_ms"] = statistics.median(times[kind]) * 1e3
        rec["dispatches_timed"] = len(times[kind])
        rec["idle_share"] = 1 - rec["device_busy_ms"] / rec["median_ms"]
    eng.reset()
    return out


# kernels that no serving dispatch may launch
NOT_SERVING = ("edm_update", "gossip_axpy", "edm_update_ef",
               "gossip_axpy_q8", "flash_attention", "ring_combine")


def check_serve_counts(counts, metrics, n_layers: int, what: str):
    check(all(counts[k] == 0 for k in NOT_SERVING),
          f"{what}: a non-serving kernel launched while serving: {counts}")
    check(counts["paged_attention"] == n_layers * metrics["steps"] > 0,
          f"{what}: paged_attention launched {counts['paged_attention']} "
          f"times in {metrics['steps']} dispatches of {n_layers} layers")
    check(counts["paged_prefill"] == n_layers * metrics["mixed_steps"] > 0,
          f"{what}: paged_prefill launched {counts['paged_prefill']} times "
          f"in {metrics['mixed_steps']} mixed dispatches of {n_layers} "
          "layers")


def serve_exactness(vocab: int, bf16_model, bf16_params):
    """Phase 9: f32 kernel engine == greedy_generate token for token; bf16
    kernel-engine vs plain-engine agreement share."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, greedy_generate,
                                   poisson_load)
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=1 + 4 * 256 // PAGE,
                            max_slots=4, max_context=256)
    reqs = poisson_load(4, rate=1000.0, vocab=vocab, prompt_buckets=(40, 200),
                        new_token_buckets=(8,), prompt_dist="exact", seed=4)

    def engine_tokens(model, params, attn_impl):
        eng = ContinuousBatchingEngine(model, params, pcfg,
                                       attn_impl=attn_impl, prefill_chunk=64,
                                       max_step_tokens=128, device="cuda")
        eng.run(reqs)
        return {r: t.tolist() for r, t in eng.completed.items()}

    model = build_model(dataclasses.replace(get_config(ARCH),
                                            dtype="float32"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    got = engine_tokens(model, params, "kernel")
    for r in reqs:
        want = greedy_generate(model, params, {"tokens": torch.from_numpy(
            r.tokens)[None].cuda()}, n_steps=r.max_new)[0].cpu().tolist()
        check(got[r.rid] == want, f"f32 kernel engine differs from "
              f"greedy_generate on request {r.rid}: {got[r.rid]} vs {want}")
    del model, params
    free()
    kern = engine_tokens(bf16_model, bf16_params, "kernel")
    plain = engine_tokens(bf16_model, bf16_params, "ref")
    same = sum(a == b for r in kern for a, b in zip(kern[r], plain[r]))
    total = sum(len(t) for t in kern.values())
    return {"f32_requests_equal": len(reqs), "f32_tokens": sum(
        len(t) for t in got.values()), "prompts": [len(r.tokens) for r in reqs],
        "bf16_agree": same, "bf16_tokens": total,
        "bf16_agree_share": same / total}


# device-time buckets of one train step, by kernel-name substring
BUCKETS = (("edm_update kernel", ("edm_update_kernel",)),
           ("edm_update_ef kernel", ("edm_ef_",)),
           ("gossip_axpy kernel", ("gossip_axpy_kernel",)),
           ("gossip_axpy_q8 kernel", ("gossip_axpy_q8_kernel",)),
           ("ring_combine kernel", ("ring_combine_kernel",)),
           ("ring_peer kernel", ("ring_peer_kernel",)),
           ("peer flags", ("flag_wait_kernel", "flag_signal_kernel")),
           ("table_combine kernel", ("table_combine_kernel",)),
           ("table_peer kernels", ("table_peer_kernel",
                                   "table_peer_q8_kernel")),
           ("paged_attention kernel", ("paged_decode_mma_kernel",
                                       "paged_decode_simt_kernel")),
           ("paged_prefill kernel", ("paged_prefill_kernel",
                                     "paged_prefill_mma_kernel")),
           ("roll (gossip terms)", ("roll_cuda_kernel",)),
           ("matmul", ("gemm", "cutlass", "sm90_", "nvjet", "cublas")),
           ("copy / cast", ("copy",)),
           ("reduce (norms, softmax, loss, metrics)", ("reduce", "softmax",
                                                       "logsumexp")))


def profile_step(model, run, state, batch):
    """One fused train step of ``run`` (its schedule and wire) under
    torch.profiler: device time by kernel (kernel events only, so nothing
    is counted twice) and by bucket."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import build_train_step, make_gossip_schedule

    step = build_train_step(model, run, make_gossip_schedule(run, AGENTS),
                            use_fused_kernel=True, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        state, _ = step(state, batch)
        settle()
    rows = device_rows(prof)
    return state, {"device_busy_ms": sum(r[0] for r in rows),
                   "kernel_launches": sum(r[1] for r in rows),
                   "traced": traced_launches(rows),
                   "buckets": bucket(rows), "top": rows[:12]}


def bucket(rows):
    """Device ms by BUCKETS name (first match), the rest elementwise."""
    buckets = {name: 0.0 for name, _ in BUCKETS}
    buckets["other elementwise"] = 0.0
    for ms, _, key in rows:
        name = next((n for n, keys in BUCKETS
                     if any(k in key for k in keys)), "other elementwise")
        buckets[name] += ms
    return buckets


# ---------------------------------------------------------------------------
# phase 3f: flash GQA attention against its plain version
# ---------------------------------------------------------------------------

# (B, H, K, Sq, Sk, hd, causal, window): the JAX package's ATTN_CASES
# (tests/test_kernels.py), a window as long as the sequence (equal to no
# window) and a causal case whose rows q >= 255 see no key
FLASH_CASES = [
    (1, 4, 4, 256, 256, 64, True, 0),
    (2, 8, 2, 256, 256, 64, True, 0),
    (1, 4, 1, 128, 384, 64, False, 0),
    (1, 2, 2, 512, 512, 128, True, 256),
    (1, 15, 5, 128, 128, 64, True, 0),
    (1, 2, 2, 256, 256, 64, True, 4096),
    (1, 15, 5, 512, 128, 64, True, 128),
]
# smollm_360m's heads: (a) a prefill of four sequences at the model's
# context, (b) DESIGN §2's long-context sliding window
FLASH_TIMED = {"a": (4, 15, 5, 2048, 2048, 64, True, 0),
               "b": (1, 15, 5, 8192, 8192, 64, True, 2048)}


def flash_inputs(case, dtype, gen):
    import torch
    B, H, K, Sq, Sk, hd, _, _ = case
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd))]


def live_keys(Sq, Sk, causal, window):
    """Live keys of each query row (numpy int64, length Sq)."""
    import numpy as np
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return np.maximum(hi - lo + 1, 0)


def check_flash(case, dtype, gen):
    import torch
    from repro_torch.kernels import ops, ref
    q, k, v = flash_inputs(case, dtype, gen)
    _, _, _, Sq, Sk, _, causal, window = case
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err, ratio = serve_err(got, want, dtype, f"flash_attention {case}")
    dead = torch.from_numpy(live_keys(Sq, Sk, causal, window) == 0).cuda()
    check(torch.count_nonzero(got[:, :, dead]) == 0,
          f"flash_attention {case} {dtype}: a row with no live key is "
          "not 0")
    return {"case": list(case), "dtype": str(dtype)[6:],
            "max_abs_err": err, "err_over_tol": ratio,
            "dead_rows": int(dead.sum())}


def check_flash_poison(dtype, gen):
    """Causal, Sk > Sq: keys at positions >= Sq are live for no query; NaN
    there must leave the output bit-equal to the clean output."""
    import torch
    from repro_torch.kernels import ops
    q, k, v = flash_inputs((2, 15, 5, 256, 512, 64, True, 0), dtype, gen)
    clean = ops.flash_attention(q, k, v, causal=True)
    k[:, :, 256:] = float("nan")
    v[:, :, 256:] = float("nan")
    poisoned = ops.flash_attention(q, k, v, causal=True)
    equal = same_bits(clean, poisoned) and bool(
        torch.isfinite(poisoned).all())
    check(equal, f"flash_attention {dtype}: NaN in dead keys changed the "
                 "output")
    return {"dtype": str(dtype)[6:], "poisoned_bit_equal": equal}


def sdpa_timed(q, k, v, causal, window):
    """One ``F.scaled_dot_product_attention`` call of the same function
    (GQA through ``enable_gqa``; the window as an explicit boolean mask):
    (ms, backend) of the first backend that takes it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Sq, Sk = q.shape[2], k.shape[2]
    kw = dict(enable_gqa=True)
    if window:
        qp = torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Sk, device="cuda")[None, :]
        kw["attn_mask"] = (kp > qp - window) & ((kp <= qp) if causal
                                                 else True)
    else:
        kw["is_causal"] = causal
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                fn = lambda: F.scaled_dot_product_attention(q, k, v, **kw)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                return time_ms(fn, reps=10), backend.name
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend ran")


def time_flash(name, dtype, gen):
    import torch
    from repro_torch.kernels import ops, ref
    case = FLASH_TIMED[name]
    B, H, K, Sq, Sk, hd, causal, window = case
    q, k, v = flash_inputs(case, dtype, gen)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    rec = {"case": name, "shape": list(case), "dtype": str(dtype)[6:]}
    rec["ms"] = time_ms(lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window), reps=10)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    rec["max_abs_err"], rec["err_over_tol"] = serve_err(
        got, want, dtype, f"flash_attention timed {name}")
    del got, want
    free()
    rec["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), reps=5)
    free()
    rec["library_ms"], rec["library_backend"] = sdpa_timed(q, k, v, causal,
                                                          window)
    pairs = int(live_keys(Sq, Sk, causal, window).sum())
    rec["bytes"] = (2 * B * H * Sq + 2 * B * K * Sk) * hd * q.element_size()
    rec["flops"] = 4 * hd * pairs * B * H
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["flops"],
                                                peak_flops(dtype))
    rec["tflops"] = rec["flops"] / rec["ms"] / 1e9
    del q, k, v
    free()
    return rec


def flash_phase():
    """Phase 3f: every case in f32 and bf16, the poisoned check, the
    timed shapes, then the op driven once at (a) and (b) with the counts
    reset just before and read just after."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(5)
    recs, poison, timed = [], [], {}
    for dtype in (torch.float32, torch.bfloat16):
        recs += [check_flash(c, dtype, gen) for c in FLASH_CASES]
        poison.append(check_flash_poison(dtype, gen))
        for name in FLASH_TIMED:
            timed[(name, str(dtype)[6:])] = time_flash(name, dtype, gen)
    inputs = {n: flash_inputs(c, torch.bfloat16, gen)
              for n, c in FLASH_TIMED.items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for name, (q, k, v) in inputs.items():
        _, _, _, _, _, _, causal, window = FLASH_TIMED[name]
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        check(bool(torch.isfinite(out).all()), f"flash {name}: non-finite")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    want["flash_attention"] = len(inputs)
    check(counts == want, f"the flash op launched {counts}, expected "
                          f"{want}")
    del inputs
    free()
    return recs, poison, timed, counts


# ---------------------------------------------------------------------------
# phases 4t and 6t: the tree-resident train path
# ---------------------------------------------------------------------------

# edm last: its final state feeds phase 6t and is held through no other run
TREE_ALGS = ("ed", "edm_ef", "dsgd", "dmsgd", "dsgt", "dsgt_hb",
             "decentlam", "qg", "edm")
TREE_STEPS = 2


def tree_expected(alg: str, n_leaves: int, steps: int):
    """Exact launches of a tree run: L EDM launches a step for edm only
    (the JAX trainer passes ``use_fused_kernel`` to edm alone), L combine
    launches a step, 2L for the gradient-tracking methods (mix(y) and the
    step's own mix)."""
    mixes = 2 if alg in ("dsgt", "dsgt_hb") else 1
    return {"edm_update": n_leaves * steps if alg == "edm" else 0,
            "gossip_axpy": mixes * n_leaves * steps}


def tree_main(cli, n_leaves: int):
    """Phase 4t: every algorithm through the CLI on the tree path; returns
    the records and the edm run's final state and run config (for 5t and
    6t)."""
    import torch
    from repro_torch.kernels import ops
    recs, edm_state, edm_run = {}, None, None
    for alg in TREE_ALGS:
        args = MAIN_ARGS + ["--no-packed-bus", "--algorithm", alg]
        args[args.index("--steps") + 1] = str(TREE_STEPS)
        free()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        result = cli.main(args)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {k: 0 for k in counts}
        want.update(tree_expected(alg, n_leaves, TREE_STEPS))
        check(counts == want, f"tree {alg}: launched {counts}, expected "
                              f"{want}")
        for t, m in enumerate(result["metrics"]):
            check(all(math.isfinite(v) for v in m.values()),
                  f"tree {alg}: non-finite metrics at step {t}: {m}")
        state = result["state"]
        check(state["step"] == TREE_STEPS and all(
            bool(torch.isfinite(v).all()) for v in state["params"].values()),
            f"tree {alg}: state at step {state['step']} or non-finite x")
        recs[alg] = {"launches": counts, "peak_gib": peak / 2**30,
                     "median_step_ms": statistics.median(
                         result["step_seconds"]) * 1e3,
                     "step_ms": [s * 1e3 for s in result["step_seconds"]],
                     "metrics": result["metrics"],
                     "opt_slots": sorted(state["opt"])}
        if alg == "edm":
            edm_state, edm_run = state, result["run"]
        del result, state
    free()
    return recs, edm_state, edm_run


def tree_fused_vs_plain(model, state, tokens):
    """Phase 6t: one tree EDM + ring-gossip step with the kernels against
    the plain versions through the same per-leaf pack, unpack and rolls
    (bit-equal), and against the unfused chain (within 2⁻⁵·s, four bf16
    ulps of the operands' scale s: s_m = β|m| + (1−β)|g|, s_ψ = |x| + α s_m,
    s_x = W(s_ψ + |x| + |ψ|), since the chain rounds after every
    operation and the fused path once from f32)."""
    import torch
    from repro_torch.core import (make_mixer, make_optimizer, mix_shifts,
                                  ring, wire_terms)
    from repro_torch.kernels import ops, ref
    from repro_torch.train import tree_losses_and_grads

    x, m, psi = state["params"], state["opt"]["m"], state["opt"]["psi"]
    _, g = tree_losses_and_grads(model, x, {"tokens": tokens})
    topo = ring(AGENTS)
    weights = [t.weight for t in topo.terms]

    def step(fused):
        mix = make_mixer(topo, "ppermute", agents_per_device=AGENTS,
                         use_fused_kernel=fused)
        opt = make_optimizer("edm", alpha=ALPHA, beta=BETA, mix=mix,
                             use_fused_kernel=fused)
        x2, st = opt.step(x, g, {"m": m, "psi": psi})
        return {p: [x2[p].cpu(), st["m"][p].cpu(), st["psi"][p].cpu()]
                for p in x}

    with torch.no_grad():
        fused = step(True)                 # host copies
        free()
        equal, err_plain = True, 0.0
        for p in x:
            packed = [ops.pack_leaf(t) for t in (x[p], g[p], m[p], psi[p])]
            m_p, psi_p, phi_p = ref.edm_update_ref(
                *packed, alpha=ALPHA, beta=BETA,
                out=(packed[2], packed[3], None))
            shape, dt = x[p].shape, x[p].dtype
            phi = ops.unpack_leaf(phi_p, shape, dt)
            plain = [ref.gossip_axpy_ref(wire_terms(topo, phi), weights),
                     ops.unpack_leaf(m_p, shape, m[p].dtype),
                     ops.unpack_leaf(psi_p, shape, psi[p].dtype)]
            eq, e = compare([f.cuda() for f in fused[p]], plain)
            equal, err_plain = equal and eq, max(err_plain, e)
            del packed, m_p, psi_p, phi_p, phi, plain
        free()
        chain = step(False)
        ratio = 0.0
        for p in x:
            xf, mf, pf = (t.cuda().float() for t in fused[p])
            xc, mc, pc = (t.cuda().float() for t in chain[p])
            s_m = BETA * m[p].float().abs() + (1 - BETA) * g[p].float().abs()
            s_psi = x[p].float().abs() + ALPHA * s_m
            s_x = mix_shifts(topo, s_psi + x[p].float().abs()
                             + psi[p].float().abs())
            for f, c, sc in ((mf, mc, s_m), (pf, pc, s_psi), (xf, xc, s_x)):
                r = float(((f - c).abs() / (2.0 ** -5 * sc + 1e-30)).max())
                ratio = max(ratio, r)
            del xf, mf, pf, xc, mc, pc, s_m, s_psi, s_x
        del fused, chain, g
    free()
    check(equal, f"tree fused step differs from its plain twin: max abs "
                 f"err {err_plain}")
    check(ratio <= 1.0, f"tree fused step vs the unfused chain: "
                        f"{ratio:.3f} × the tolerance")
    return {"bit_equal_plain": equal, "max_abs_err_plain": err_plain,
            "chain_err_over_tol": ratio,
            "leaves": len(x), "dtype": str(next(iter(x.values())).dtype)}


# ---------------------------------------------------------------------------
# phase 10: the paper on the card
# ---------------------------------------------------------------------------

def paper_phase():
    """§E.1's quadratic problem (32 agents, ring, σ = 0, c = 1): EDM
    reaches the optimum, DmSGD stalls at the heterogeneity floor."""
    from repro_torch.core import make_mixer, make_optimizer, ring
    from repro_torch.data import quadratic_problem
    import torch
    n, steps = 32, 3000
    _, full, x_opt, zeta2 = quadratic_problem(n, c=1.0, sigma=0.0, seed=0,
                                              device="cuda")
    out = {"zeta2": zeta2, "steps": steps}
    for alg in ("edm", "dmsgd"):
        opt = make_optimizer(alg, alpha=0.05, beta=0.9,
                             mix=make_mixer(ring(n)))
        x = torch.zeros(n, x_opt.shape[0], device="cuda")
        state = opt.init(x)
        t0 = time.perf_counter()
        for _ in range(steps):
            x, state = opt.step(x, full(x), state)
        out[alg] = float(((x - x_opt[None]) ** 2).sum(-1).mean())
        out[f"{alg}_s"] = time.perf_counter() - t0
    check(out["edm"] < 1e-8, f"EDM did not reach the optimum: {out}")
    check(out["dmsgd"] > 1e-3, f"DmSGD did not stall: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the train → export → serve hand-off
# ---------------------------------------------------------------------------

HANDOFF_DIR = ROOT / "build" / "handoff"
HANDOFF_STEPS = 2
# the serve CLI on the export: 4 requests of the CLI trace's sizes, bf16
HANDOFF_SERVE = ["--arch", ARCH, "--continuous-batching", "--prefill-chunk",
                 "16", "--max-step-tokens", "32", "--prompt-dist", "exact",
                 "--max-slots", "4", "--page-size", "16", "--requests", "4",
                 "--rate", "50", "--attn-impl", "kernel", "--device", "cuda"]
SMOKE_RESUME = ["--arch", ARCH, "--smoke", "--agents", str(AGENTS),
                "--agents-per-device", str(AGENTS), "--gossip-engine",
                "ppermute", "--fused-kernel", "--seq", "16", "--device",
                "cuda"]


def train_and_export(arch: str, stem: str):
    """The hand-off's first half (phases 11 and 24): ``HANDOFF_STEPS`` bus
    steps of ``arch`` at full size through the train CLI (graphed: 1 EDM
    and 1 ring launch in step 0, the later steps replayed), the
    parameters saved with the port's ``checkpoint.save`` (``params|``
    leaves, the bus unpacked), their consensus exported with the port's
    ``export_consensus`` into ``HANDOFF_DIR / f"{stem}_consensus.npz"``,
    one bf16 replica of every leaf.  Returns a record, the export's path,
    its parameters and their digest."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model
    from repro_torch.train import bus_layout_for, checkpoint
    from repro_torch.weights import params_digest, params_from_npz
    HANDOFF_DIR.mkdir(parents=True, exist_ok=True)
    params_path = HANDOFF_DIR / f"{stem}_params.npz"
    export_path = HANDOFF_DIR / f"{stem}_consensus.npz"
    rec = {}
    args = [arch if a == ARCH else a for a in MAIN_ARGS]
    args[args.index("--steps") + 1] = str(HANDOFF_STEPS)
    free()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(args)
    rec["train_s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    rec["train_counts"] = {k: v for k, v in counts.items() if v}
    check(rec["train_counts"] == {"edm_update": 1, "ring_combine": 1}
          and result["graph_replays"] == HANDOFF_STEPS - 1,
          f"{arch} hand-off training launched {counts} and replayed "
          f"{result['graph_replays']} steps")
    check(all(math.isfinite(v) for m in result["metrics"]
              for v in m.values()), f"{arch} hand-off: non-finite metrics")
    rec["train_loss"] = [m["loss"] for m in result["metrics"]]
    layout = bus_layout_for(build_model(get_config(arch)), AGENTS)
    t0 = time.perf_counter()
    checkpoint.save(str(params_path), {"params": result["state"]["params"]},
                    layout=layout)
    rec["save_s"] = time.perf_counter() - t0
    rec["params_file_gb"] = params_path.stat().st_size / 1e9
    del result
    free()
    t0 = time.perf_counter()
    checkpoint.export_consensus(str(params_path), str(export_path))
    rec["export_s"] = time.perf_counter() - t0
    rec["export_file_gb"] = export_path.stat().st_size / 1e9
    with np.load(params_path) as f:
        check(all(k.startswith("params|") for k in f.files)
              and len(f.files) == len(layout.paths),
              f"the saved {arch} file is not the params leaves")
    params_path.unlink()
    exported = params_from_npz(str(export_path))
    check(set(exported) == set(layout.paths) and all(
        t.dtype == torch.bfloat16 for t in exported.values()),
        f"the {arch} export is not one bf16 replica of every leaf")
    return rec, export_path, exported, params_digest(exported)


def handoff_phase(n_layers: int):
    """Phase 11: :func:`train_and_export` at full width, then 4 requests
    served from the export through the serve CLI's ``--ckpt`` in bf16: 32
    decode launches a dispatch, the served parameters the export's bits,
    finite logits.  Then, at the smoke config on the card, ``--ckpt`` /
    ``--resume`` (``save_state`` / ``load_state``) resumed bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model
    rec, export_path, exported, want = train_and_export(ARCH, "smollm")
    model = build_model(get_config(ARCH))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = serve_cli.main(HANDOFF_SERVE + ["--ckpt", str(export_path)])
    rec["serve_s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_serve_counts(counts, metrics, n_layers, "hand-off serve CLI")
    check(metrics["params_sha256"] == want,
          "the served parameters are not the export's bits")
    check(metrics["requests"] == 4 and metrics["tokens"] > 0,
          f"hand-off serve CLI finished {metrics}")
    served = {p: t.cuda() for p, t in exported.items()}
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 32), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(11))
    logits = model.prefill(served, {"tokens": tokens})[0]
    check(bool(torch.isfinite(logits).all()),
          "the exported model gives non-finite logits")
    del served, exported, logits
    export_path.unlink()
    free()
    rec.update(serve_counts=counts, serve_metrics=metrics,
               params_sha256=want)
    # save_state / load_state on the card: a resumed run is the
    # uninterrupted one, bit for bit
    ck = HANDOFF_DIR / "smoke_state.npz"
    full = cli.main(SMOKE_RESUME + ["--steps", "4"])["state"]
    cli.main(SMOKE_RESUME + ["--steps", "2", "--ckpt", str(ck)])
    resumed = cli.main(SMOKE_RESUME + ["--steps", "2", "--resume",
                                       str(ck)])["state"]
    ck.unlink()
    check(resumed["step"] == full["step"] == 4
          and same_bits(resumed["params"], full["params"])
          and all(same_bits(resumed["opt"][k], full["opt"][k])
                  for k in full["opt"]),
          "the resumed smoke run differs from the uninterrupted one")
    rec["resume_bit_equal"] = True
    return rec


# ---------------------------------------------------------------------------
# phase 15: deepseek_moe_16b served at full width, its depth cut
# ---------------------------------------------------------------------------

def moe_serve_exactness():
    """At deepseek_moe_16b's smoke config in f32 on the card: dropless
    (the config's capacity 8.0) the kernel engine's tokens equal the plain
    engine's and ``greedy_generate``'s; at capacity 1.25 (where capacity
    can bind: the decode batch's idle slots and the chunks' padding rows
    are routed too) the kernel engine's equal the plain engine's."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, greedy_generate,
                                   poisson_load)
    cfg = get_smoke_config(MOE_ARCH)
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=1 + 4 * 256 // PAGE,
                            max_slots=4, max_context=256)
    reqs = poisson_load(4, rate=1000.0, vocab=cfg.vocab_size,
                        prompt_buckets=(40, 200), new_token_buckets=(8,),
                        prompt_dist="exact", seed=4)
    out = {}
    for cf in (cfg.capacity_factor, 1.25):
        model = build_model(dataclasses.replace(cfg, capacity_factor=cf))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        toks = {}
        for impl in ("kernel", "ref"):
            eng = ContinuousBatchingEngine(model, params, pcfg,
                                           attn_impl=impl, prefill_chunk=64,
                                           max_step_tokens=128,
                                           device="cuda")
            eng.run(reqs)
            toks[impl] = {r: t.tolist() for r, t in eng.completed.items()}
            del eng
        check(toks["kernel"] == toks["ref"], f"MoE smoke, capacity {cf}: "
              f"the kernel engine's tokens {toks['kernel']} differ from the "
              f"plain engine's {toks['ref']}")
        rec = {"requests_equal": len(reqs), "tokens": sum(
            len(t) for t in toks["kernel"].values())}
        if cf == cfg.capacity_factor:
            for r in reqs:
                want = greedy_generate(model, params, {
                    "tokens": torch.from_numpy(r.tokens)[None].cuda()},
                    n_steps=r.max_new)[0].cpu().tolist()
                check(toks["kernel"][r.rid] == want, f"MoE smoke: the "
                      f"kernel engine differs from greedy_generate on "
                      f"request {r.rid}: {toks['kernel'][r.rid]} vs {want}")
            rec["greedy_generate_equal"] = True
        out[f"capacity_{cf}"] = rec
        del model, params
        free()
    return out


def moe_serve_phase():
    """Phase 15: deepseek_moe_16b at full width and ``MOE_SERVE_LAYERS``
    of its 28 layers through :func:`engine_serve_phase` (one
    paged-attention launch a layer a dispatch, one paged-prefill launch a
    layer a mixed dispatch), then the smoke config's exactness."""
    rec = engine_serve_phase(MOE_ARCH, MOE_SERVE_ARGS, "MoE",
                             MOE_SERVE_LAYERS)
    rec["smoke"] = moe_serve_exactness()
    return rec


def engine_serve_phase(arch: str, serve_args, tag: str, n_layers: int = 0):
    """``arch`` at full width and depth (or ``n_layers``, as
    ``serve_args``' ``--n-layers``) in bf16, random weights from seed
    0: the serve CLI's continuous engine at the reference CLI's trace
    sizes, then the engine at context 1024 (16 slots, 32 requests, prompts
    256–768, chunks of 128), counts reset just before and read just after
    each (n_layers paged-attention launches a dispatch, n_layers
    paged-prefill launches a mixed dispatch); init time and peak, logits
    of one prefill finite (after a frontend for a VLM), serving peak; one
    mixed and one decode-only dispatch profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, poisson_load)
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_layers = cfg.n_layers
    rec = {"n_layers": n_layers}
    free()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cli_metrics = serve_cli.main(serve_args)
    rec["cli_s"] = time.perf_counter() - t0
    rec["cli_counts"] = ops.launch_counts()
    rec["cli_metrics"] = cli_metrics
    check_serve_counts(rec["cli_counts"], cli_metrics, n_layers,
                       f"{tag} serve CLI")
    check(cli_metrics["requests"] == 16 and cli_metrics["tokens"] > 0,
          f"{tag} serve CLI finished {cli_metrics}")
    free()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["params"] = sum(t.numel() for t in params.values())
    rec["param_gb"] = sum(t.numel() * t.element_size()
                          for t in params.values()) / 1e9
    vocab = cfg.vocab_size
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(3)
        batch = {"tokens": torch.randint(0, vocab, (1, 64), device="cuda",
                                         generator=gen)}
        if cfg.family == "vlm":
            batch["frontend"] = torch.randn(
                (1, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                device="cuda").to(getattr(torch, cfg.dtype))
        logits, _ = model.prefill(params, batch)
        rec["prefill_logits_finite"] = bool(torch.isfinite(logits).all())
        del logits, batch
    check(rec["prefill_logits_finite"], f"{tag} prefill logits not finite")
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=1 + SLOTS * CTX // PAGE,
                            max_slots=SLOTS, max_context=CTX)
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="kernel",
                                   prefill_chunk=CHUNK,
                                   max_step_tokens=STEP_TOKENS,
                                   device="cuda")
    reqs = poisson_load(32, rate=1000.0, vocab=vocab,
                        prompt_buckets=(256, 768),
                        new_token_buckets=(16, 32, 64), prompt_dist="exact",
                        seed=0)
    eng.run(poisson_load(2, rate=1000.0, vocab=vocab,
                         prompt_buckets=(256, 256), new_token_buckets=(4,),
                         seed=1))                        # warm-up
    eng.reset()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = eng.run(reqs)
    rec["counts"] = ops.launch_counts()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    rec["metrics"] = metrics
    check_serve_counts(rec["counts"], metrics, n_layers,
                       f"{tag} engine at context {CTX}")
    check(metrics["requests"] == len(reqs) and all(
        len(eng.completed[r.rid]) == r.max_new for r in reqs),
        f"the {tag} engine did not finish every request with its full "
        "budget")
    rec["pool_gb"] = sum(t.numel() * t.element_size() for pi in eng.pools
                         for t in pi.values()) / 1e9
    rec["dispatches"] = profile_dispatches(eng, vocab)
    del eng, params, model
    free()
    return rec


# ---------------------------------------------------------------------------
# phase 16: MoE training at full width, depth cut
# ---------------------------------------------------------------------------

def graphed_runs(model, n_agents: int, batches, cases, tag: str):
    """For each ``(name, gossip_groups)`` of ``cases``: ``n_agents`` agents
    on the ring, packed f32 bus, fused kernels, under deterministic
    algorithms, ``GRAPH_STEPS`` + 1 steps eager and graphed from one state
    and one batch stream: metrics and buses bit-equal, losses finite,
    each replay's device trace holding one EDM and one ring kernel; where
    groups opt out (``gossip_every`` 0; their rows are one contiguous
    range) those rows of x equal φ's after every step.  Returns a record
    a case: bus, opt-out rows, median replayed step, busy, idle share,
    launches, replay trace, peaks, losses, device ms by bucket."""
    import torch
    from repro_torch.train import bus_layout_for, resolve_features
    want = {n: 0 for n, _ in TRACED}
    want.update(edm_update=1, ring_combine=1)
    seq = batches[0]["tokens"].shape[-1]
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, groups in cases:
            run = bus_run(global_batch=n_agents, agents_per_device=n_agents,
                          gossip_groups=groups)
            layout = bus_layout_for(model, n_agents,
                                    resolve_features(run).groups)
            rec = {"bus": [n_agents, layout.rows, 128]}
            off = [g for g in layout.groups if g.gossip_every == 0]
            rows = None
            if off:
                lo, hi = off[0].row, off[-1].row + off[-1].rows
                check(sum(g.rows for g in off) == hi - lo,
                      f"{tag} {name}: the opt-out groups are not one range")
                rows = slice(lo, hi)
                rec["opt_out_rows"] = {g.name: [g.row, g.row + g.rows]
                                       for g in off}
            kw = dict(n_agents=n_agents, phi_rows=rows)
            eager = graph_trajectory(model, run, batches, False, **kw)
            graph = graph_trajectory(model, run, batches, True,
                                     against=eager["host"], **kw)
            del eager["host"]
            med = statistics.median(graph["seconds"][1:]) * 1e3
            rec.update(
                graph_eq_eager=graph["same"]
                and graph["metrics"] == eager["metrics"],
                opt_out_rows_eq_phi=(eager["opt_out_phi"]
                                     and graph["opt_out_phi"])
                if rows is not None else None,
                loss=[m["loss"] for m in graph["metrics"]],
                step_ms=[round(t * 1e3, 2) for t in graph["seconds"]],
                median_ms=med, busy_ms=graph["busy_ms"],
                idle_share=1 - graph["busy_ms"] / med,
                tokens_per_s=n_agents * seq / med * 1e3,
                eager_median_ms=statistics.median(eager["seconds"]) * 1e3,
                replays=graph["replays"],
                launches={k: v for k, v in graph["launches"].items() if v},
                traced_replay={k: v for k, v in graph["traced"].items()
                               if v},
                peak_allocated_gib=graph["peak"][0],
                peak_reserved_gib=graph["peak"][1],
                eager_peak_allocated_gib=eager["peak"][0],
                buckets=graph["buckets"], top=graph["top"])
            check(rec["graph_eq_eager"], f"{tag} {name}: the graphed step "
                  f"differs from the eager step: {rec}")
            check(rows is None or rec["opt_out_rows_eq_phi"],
                  f"{tag} {name}: the opt-out rows of x are not φ's: {rec}")
            check(all(math.isfinite(v) for m in graph["metrics"]
                      for v in m.values()),
                  f"{tag} {name}: non-finite metrics {graph['metrics']}")
            check(graph["traced"] == want and eager["traced"] == want
                  and graph["replays"] == GRAPH_STEPS - 1,
                  f"{tag} {name}: replay traced {graph['traced']}, eager "
                  f"step {eager['traced']}, replays {graph['replays']}; "
                  f"expected {want} and {GRAPH_STEPS - 1} replays")
            out[name] = rec
            del eager, graph
            free()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def moe_train_phase():
    """Phase 16: deepseek_moe_16b at full width with its depth cut to
    ``MOE_TRAIN_LAYERS`` layer, ``MOE_AGENTS`` agents, seq 128, per-agent
    batch 1, through :func:`graphed_runs` for ``gossip_groups="moe"`` (the
    experts opt out) and the ungrouped bus."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(get_config(MOE_ARCH),
                                            n_layers=MOE_TRAIN_LAYERS))
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                       n_agents=MOE_AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    batches = [data.sample(dgen, 1) for _ in range(GRAPH_STEPS + 1)]
    out = {"params": sum(t.numel() for t in model.meta().values())}
    out.update(graphed_runs(model, MOE_AGENTS, batches,
                            (("moe", "moe"), ("ungrouped", "")), "MoE"))
    return out


# ---------------------------------------------------------------------------
# phase 17: falcon_mamba_7b served at full width and depth
# ---------------------------------------------------------------------------

def fixed_batch_exactness(arch: str, tag: str):
    """At ``arch``'s smoke config in f32 on the card (falcon_mamba_7b's 2
    Mamba layers, jamba_1_5_large_398b's 8-layer period): the prefill of
    S − 1 tokens then one decode step gives the logits of the prefill of
    all S (the full forward; S = 512, two scan chunks of 256, against one
    chunk of 511 and the one-step recurrence) within the serving tests'
    bound, rtol 1e-3 / atol 1e-4; ``greedy_generate``'s tokens equal a
    replay that feeds the prompt token by token through ``decode_step``
    from zero caches, then decodes greedily."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import greedy_generate, grow_caches
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S, n_new = 2, SSM_PROMPT, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(7))
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": tokens})
        _, caches = model.prefill(params, {"tokens": tokens[:, :-1]})
        # an attention layer's cache grows to hold position S − 1
        caches = grow_caches(model, caches, B, S)
        step, _ = model.decode_step(params, caches, tokens[:, -1:], S - 1)
        err = float((step - full).abs().max())
        check(bool(torch.allclose(step, full, rtol=1e-3, atol=1e-4)),
              f"{tag} smoke: prefill + decode differs from the full forward "
              f"by {err}")
        want = greedy_generate(model, params, {"tokens": tokens},
                               n_steps=n_new)
        caches = model.init_cache(B, S + n_new, device="cuda")
        for t in range(S):
            logits, caches = model.decode_step(params, caches,
                                               tokens[:, t:t + 1], t)
        out = []
        for i in range(n_new):
            tok = torch.argmax(logits[:, -1].float(), -1).to(
                torch.int32)[:, None]
            out.append(tok)
            if i < n_new - 1:
                logits, caches = model.decode_step(params, caches, tok, S + i)
        replay = torch.cat(out, dim=1)
    check(torch.equal(replay, want), f"{tag} smoke: greedy_generate "
          f"{want.tolist()} differs from the decode replay "
          f"{replay.tolist()}")
    del model, params, caches
    free()
    return {"prefill_decode_max_abs_err": err, "prompt": S,
            "greedy_equal_replay": True, "tokens": B * n_new}


def fixed_batch_serve_phase(arch: str, cli_args, n_params: int,
                            n_layers: int = 0, tag: str = "SSM",
                            shape=(SSM_BATCH, SSM_PROMPT, SSM_NEW),
                            exactness=None):
    """Phases 17, 21 and 23: ``arch`` at full width (depth cut to
    ``n_layers`` when given) in bf16, random weights from seed 0: the
    serve CLI's fixed batch at phase 8's sizes, counts reset just before
    and read just after (the path launches none of the port's kernels:
    its attention, where it has any, runs on dense caches); then a fixed
    batch of ``shape`` = (batch, prompt, new tokens) — by default
    ``SSM_BATCH`` with prompt ``SSM_PROMPT`` (two scan chunks) and
    ``SSM_NEW`` new tokens; an encoder-decoder batch with
    ``n_frontend_tokens`` seeded frames a request — through
    ``greedy_generate``: init time and peak, prefill ms (with the
    encoder's), tokens/s and per-token ms, peak allocated and reserved;
    one decode step's host ms (median) and device busy ms, launches and
    idle share (profiler); then the smoke config's exactness
    (``exactness()``, by default :func:`fixed_batch_exactness`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.serve import greedy_generate, grow_caches
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rec = {}
    free()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cli = serve_cli.main(cli_args)
    rec["cli_s"] = time.perf_counter() - t0
    rec["cli_counts"] = ops.launch_counts()
    check(not any(rec["cli_counts"].values()), f"{tag} serve CLI launched "
          f"{rec['cli_counts']}: the fixed batch has no kernel of the port")
    b = int(cli_args[cli_args.index("--batch") + 1])
    new = int(cli_args[cli_args.index("--new-tokens") + 1])
    check(tuple(cli["tokens"].shape) == (b, new)
          and bool(((cli["tokens"] >= 0)
                    & (cli["tokens"] < cfg.vocab_size)).all()),
          f"{tag} serve CLI tokens {cli['tokens']}")
    rec["cli_tokens_per_s"] = b * new / cli["seconds"]
    rec["cli_seconds"] = cli["seconds"]
    del cli
    free()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["params"] = sum(t.numel() for t in params.values())
    rec["param_gb"] = sum(t.numel() * t.element_size()
                          for t in params.values()) / 1e9
    check(rec["params"] == n_params, f"{arch} has {rec['params']} "
          f"parameters, expected {n_params}")
    B, S, n_new = shape
    rec["shape"] = list(shape)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                                     generator=gen)}
    rec["frames"] = cfg.n_frontend_tokens if cfg.family == "encdec" else 0
    if rec["frames"]:
        batch["frontend"] = torch.randn(
            (B, rec["frames"], cfg.d_model), device="cuda",
            generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        # warm-up
        model.prefill(params, {**batch, "tokens": batch["tokens"][:, :16]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check(bool(torch.isfinite(logits).all()),
              f"{tag} prefill logits not finite")
        rec["state_mb"] = sum(t.numel() * t.element_size()
                              for c in caches for t in c.values()) / 1e6
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = greedy_generate(model, params, batch, n_steps=n_new).cpu()
        total_s = time.perf_counter() - t0
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
        check(tuple(out.shape) == (B, n_new) and bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{tag} greedy tokens {out}")
        rec["generate_s"] = total_s
        rec["tokens_per_s"] = B * n_new / total_s
        rec["per_token_ms"] = (total_s * 1e3 - rec["prefill_ms"]) / (
            n_new - 1)
        # one decode step at context S: host time, then one profiled
        caches = grow_caches(model, caches, B, S + n_new)
        tok = torch.argmax(logits[:, -1].float(), -1).to(
            torch.int32)[:, None]
        times = []
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, caches, tok, S + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()),
              f"{tag} decode logits not finite")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, caches, tok, S + 8)
            settle()
        rows = device_rows(prof)
        host = statistics.median(times[2:]) * 1e3
        busy = sum(r[0] for r in rows)
        rec["decode"] = {"host_ms": host, "device_busy_ms": busy,
                         "kernel_launches": sum(r[1] for r in rows),
                         "idle_share": 1 - busy / host,
                         "buckets": bucket(rows), "top": rows[:8]}
        del logits, caches, out
    del params, model
    free()
    rec["smoke"] = (exactness or functools.partial(fixed_batch_exactness,
                                                    arch, tag))()
    return rec


# ---------------------------------------------------------------------------
# phase 18: SSM training at full width, depth cut
# ---------------------------------------------------------------------------

def remat_check(model, batch, tag: str):
    """At x(0) of the ungrouped bus of ``AGENTS`` agents, under
    deterministic algorithms: every agent's loss and gradient with
    ``remat`` off, "full" and "dots" — the gradient buses bit-equal — and
    the peak allocated above the state in each case."""
    import torch
    from repro_torch.train import (bus_layout_for, init_state,
                                   losses_and_grads)
    run = bus_run(remat=False)
    layout = bus_layout_for(model, AGENTS)
    x = init_state(model, run, AGENTS, seed=0, device="cuda")["params"]
    rec, want = {}, None
    torch.use_deterministic_algorithms(True)
    try:
        for label, kw in (("off", dict(remat=False)),
                          ("full", dict(remat=True, remat_policy="full")),
                          ("dots", dict(remat=True, remat_policy="dots"))):
            free()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            losses, g = losses_and_grads(model, layout, x, batch, **kw)
            torch.cuda.synchronize()
            r = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "above_base_gib": (torch.cuda.max_memory_allocated()
                                    - base) / 2**30}
            if want is None:
                want = (losses, g)
            else:
                r["bit_equal"] = (same_bits(losses, want[0])
                                  and same_bits(g, want[1]))
                check(r["bit_equal"], f"{tag} remat {label}: gradients "
                      "differ from remat=False")
                del g
            rec[label] = r
    finally:
        torch.use_deterministic_algorithms(False)
    del want, x
    free()
    return rec


def bus_kernels(bus_shape):
    """The EDM and ring kernels on a training phase's bus (in place: m'
    and ψ' over m and ψ, φ and the ring's output into their own buffers):
    the first call of each held bit for bit against its plain version on
    the last agent's block, whose element offsets lie past 2³¹ (phase 18)
    or across it (phase 22); then timed beside their byte bounds."""
    import torch
    from repro_torch.core import ring
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, g, m, psi = (torch.randn(bus_shape, generator=gen, device="cuda")
                    for _ in range(4))
    phi = torch.empty_like(x)
    A = bus_shape[0]
    n, last = x.numel(), A - 1
    rec = {"shape": list(bus_shape), "checked_agent": last,
           "checked_first_element": last * (n // A)}

    def edm():
        return ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA,
                                  out=(m, psi, phi))
    want = ref.edm_update_ref(x[last], g[last], m[last], psi[last],
                              alpha=ALPHA, beta=BETA)
    edm()
    rec["edm_update_bit_equal"], rec["edm_update_max_abs_err"] = compare(
        [m[last], psi[last], phi[last]], want)
    del want
    check(rec["edm_update_bit_equal"], f"edm_update differs from its plain "
          f"version on agent {last} of the {bus_shape} bus: max abs err "
          f"{rec['edm_update_max_abs_err']}")
    edm_ms = time_ms(edm)
    del g, m, psi
    terms = [(t.shift, float(t.weight)) for t in ring(A).terms]
    want = ref.gossip_axpy_ref([phi[(last - s) % A] for s, _ in terms],
                               [w for _, w in terms])
    ops.ring_combine(phi, terms, out=x)
    rec["ring_combine_bit_equal"], rec["ring_combine_max_abs_err"] = \
        compare([x[last]], [want])
    del want
    check(rec["ring_combine_bit_equal"], f"ring_combine differs from its "
          f"plain version on agent {last} of the {bus_shape} bus: max abs "
          f"err {rec['ring_combine_max_abs_err']}")
    ring_ms = time_ms(lambda: ops.ring_combine(phi, terms, out=x))
    for name, ms, nbytes, flops in (("edm_update", edm_ms, 28 * n, 7 * n),
                                    ("ring_combine", ring_ms, 8 * n,
                                     (2 * len(terms) - 1) * n)):
        b, by = bound_ms(nbytes, flops)
        rec[name] = {"ms": ms, "bound_ms": b, "bound_by": by,
                     "bytes": nbytes, "bound_fraction": b / ms}
    del x, phi
    free()
    return rec


def ssm_scan_timing():
    """The chunked scan alone (``models.mamba._chunked_scan``, the
    reference's order) at its two shapes on the card: the prefill's (B 4,
    S 512 in two chunks of 256, d_inner 8192, state 16; forward, no
    grad) and a training agent's (B 1, S 128; forward and backward): the
    time a call by CUDA events (``ms``; the training shape's hundreds of
    small launches are host-paced) and its device busy time by the
    profiler (``busy_ms``: what a graph replay pays), beside the bytes a
    fused scan must move (a, b and h0 read once, hs written once;
    backward: the gradient of hs read, those of a and b written) at
    3.35 TB/s."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.mamba import _chunked_scan
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    di, st = cfg.d_inner, cfg.ssm_state
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for name, (B, S, grad) in (("prefill", (SSM_BATCH, SSM_PROMPT, False)),
                               ("train", (1, SEQ, True))):
        a = torch.rand((B, S, di, st), generator=gen, device="cuda")
        b = torch.randn((B, S, di, st), generator=gen, device="cuda")
        h0 = torch.zeros((B, di, st), device="cuda")
        n = a.numel()
        if grad:
            a.requires_grad_()
            b.requires_grad_()
            g = torch.randn((B, S, di, st), generator=gen, device="cuda")

            def fn():
                hs, _ = _chunked_scan(a, b, h0, 256)
                torch.autograd.grad(hs, (a, b), g)
            nbytes = 4 * (3 * n + n + 3 * n)      # fwd: a, b, hs; bwd
        else:
            def fn():
                with torch.inference_mode():
                    _chunked_scan(a, b, h0, 256)
            nbytes = 4 * 3 * n
        ms = time_ms(fn, reps=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            settle()
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        bms, _ = bound_ms(nbytes, 0)
        out[name] = {"shape": [B, S, di, st], "ms": ms, "busy_ms": busy,
                     "launches": sum(r[1] for r in rows), "bound_ms": bms,
                     "bytes": nbytes, "bound_fraction": bms / busy}
        del a, b, h0
        free()
    return out


def ssm_train_phase():
    """Phase 18: falcon_mamba_7b at full width with its depth cut to
    ``SSM_TRAIN_LAYERS`` layers, ``AGENTS`` agents, seq 128, per-agent
    batch 1, through :func:`graphed_runs` for ``gossip_groups="ssm"`` (the
    conv / state leaves opt out) and the ungrouped bus.  Then ``remat``
    "full" and "dots" against off (gradients bit-equal, peaks), the EDM
    and ring kernels on this bus, and the scan timed alone."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(get_config(SSM_ARCH),
                                            n_layers=SSM_TRAIN_LAYERS))
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                       n_agents=AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    batches = [data.sample(dgen, 1) for _ in range(GRAPH_STEPS + 1)]
    out = {"params": sum(t.numel() for t in model.meta().values()),
           "layers": SSM_TRAIN_LAYERS}
    out.update(graphed_runs(model, AGENTS, batches,
                            (("ssm", "ssm"), ("ungrouped", "")), "SSM"))
    out["remat"] = remat_check(model, batches[0], "SSM")
    out["kernels"] = bus_kernels(tuple(out["ungrouped"]["bus"]))
    out["scan"] = ssm_scan_timing()
    return out


# ---------------------------------------------------------------------------
# phase 19: pixtral_12b served at full width and depth
# ---------------------------------------------------------------------------

def vlm_serve_exactness():
    """At pixtral_12b's smoke config in f32 on the card, its heads grouped
    as Pixtral's (G 4: ``n_kv_heads`` 1 under 4 heads): the kernel
    engine's tokens (text-only, as the reference's scheduler) equal
    ``greedy_generate``'s; ``greedy_generate`` with a frontend equals a
    replay that prefills the frontend and the first prompt token, feeds
    the rest of the prompt token by token through ``decode_step`` (at
    positions after the frontend's), then decodes greedily."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, greedy_generate,
                                   grow_caches, poisson_load)
    cfg = dataclasses.replace(get_smoke_config(VLM_ARCH), n_kv_heads=1)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=1 + 4 * 256 // PAGE,
                            max_slots=4, max_context=256)
    reqs = poisson_load(4, rate=1000.0, vocab=cfg.vocab_size,
                        prompt_buckets=(40, 200), new_token_buckets=(8,),
                        prompt_dist="exact", seed=4)
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="kernel",
                                   prefill_chunk=64, max_step_tokens=128,
                                   device="cuda")
    eng.run(reqs)
    got = {r: t.tolist() for r, t in eng.completed.items()}
    del eng
    for r in reqs:
        want = greedy_generate(model, params, {
            "tokens": torch.from_numpy(r.tokens)[None].cuda()},
            n_steps=r.max_new)[0].cpu().tolist()
        check(got[r.rid] == want, f"VLM smoke (G 4): the kernel engine "
              f"differs from greedy_generate on request {r.rid}: "
              f"{got[r.rid]} vs {want}")
    B, S, n_new, P = 2, 64, 16, cfg.n_frontend_tokens
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     device="cuda", generator=gen),
             "frontend": torch.randn((B, P, cfg.d_model), device="cuda",
                                     generator=gen)}
    tokens = batch["tokens"]
    with torch.inference_mode():
        want = greedy_generate(model, params, batch, n_steps=n_new)
        logits, caches = model.prefill(params, {
            "tokens": tokens[:, :1], "frontend": batch["frontend"]})
        caches = grow_caches(model, caches, B, P + S + n_new)
        for t in range(1, S):
            logits, caches = model.decode_step(params, caches,
                                               tokens[:, t:t + 1], P + t)
        out = []
        for i in range(n_new):
            tok = torch.argmax(logits[:, -1].float(), -1).to(
                torch.int32)[:, None]
            out.append(tok)
            if i < n_new - 1:
                logits, caches = model.decode_step(params, caches, tok,
                                                   P + S + i)
        replay = torch.cat(out, dim=1)
    check(torch.equal(replay, want), f"VLM smoke: greedy_generate with a "
          f"frontend {want.tolist()} differs from the decode replay "
          f"{replay.tolist()}")
    del model, params, caches
    free()
    return {"g4_engine_requests_equal": len(reqs),
            "g4_engine_tokens": sum(len(t) for t in got.values()),
            "frontend_greedy_equal_replay": True, "frontend": P,
            "prompt": S, "tokens": B * n_new}


def vlm_serve_phase():
    """Phase 19: pixtral_12b at full width and ``VLM_SERVE_LAYERS`` of its
    40 layers in bf16, random weights from seed 0: the serve CLI's fixed
    batch at phase 8's sizes with ``n_frontend_tokens`` (256) frontend
    embeddings a request, counts reset before and read after
    (``greedy_generate`` on dense caches: no kernel of the port), then
    :func:`engine_serve_phase` — the engine, text-only as the reference's
    scheduler, through the paged kernels at hd 128 and G 4, one launch of
    each a layer a mixed dispatch — then the smoke config's exactness at
    G 4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    cfg = get_config(VLM_ARCH)
    rec = {}
    free()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cli = serve_cli.main(VLM_CLI_ARGS)
    rec["fixed_cli_s"] = time.perf_counter() - t0
    rec["fixed_cli_counts"] = ops.launch_counts()
    check(not any(rec["fixed_cli_counts"].values()), f"VLM fixed batch "
          f"launched {rec['fixed_cli_counts']}: greedy_generate runs no "
          "kernel of the port")
    b = int(VLM_CLI_ARGS[VLM_CLI_ARGS.index("--batch") + 1])
    new = int(VLM_CLI_ARGS[VLM_CLI_ARGS.index("--new-tokens") + 1])
    check(tuple(cli["tokens"].shape) == (b, new)
          and bool(((cli["tokens"] >= 0)
                    & (cli["tokens"] < cfg.vocab_size)).all()),
          f"VLM fixed-batch tokens {cli['tokens']}")
    rec["fixed_cli_tokens_per_s"] = b * new / cli["seconds"]
    rec["fixed_cli_seconds"] = cli["seconds"]
    del cli
    rec.update(engine_serve_phase(VLM_ARCH, VLM_SERVE_ARGS, "VLM",
                                  VLM_SERVE_LAYERS))
    check(rec["params"] == VLM_PARAMS, f"{VLM_ARCH} has {rec['params']} "
          f"parameters, expected {VLM_PARAMS}")
    rec["smoke"] = vlm_serve_exactness()
    return rec


# ---------------------------------------------------------------------------
# phase 20: VLM training at full width, depth cut
# ---------------------------------------------------------------------------

def vlm_train_phase():
    """Phase 20: pixtral_12b at full width with its depth cut to
    ``VLM_TRAIN_LAYERS`` layer, ``VLM_AGENTS`` agents, seq 128 after 256
    frontend positions, per-agent batch 1, through :func:`graphed_runs`
    (ungrouped).  The frontend changes every step and step 1 repeats step
    0's tokens, so a replay that read a stale frontend buffer would part
    from the eager step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(get_config(VLM_ARCH),
                                            n_layers=VLM_TRAIN_LAYERS))
    cfg = model.cfg
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       n_agents=VLM_AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    batches = []
    for t in range(GRAPH_STEPS + 1):
        b = data.sample(dgen, 1)
        if t == 1:
            b["tokens"] = batches[0]["tokens"]
        b["frontend"] = torch.randn(
            (VLM_AGENTS, 1, cfg.n_frontend_tokens, cfg.d_model),
            generator=dgen, device="cuda").to(torch.bfloat16)
        batches.append(b)
    out = {"params": sum(t.numel() for t in model.meta().values()),
           "layers": VLM_TRAIN_LAYERS}
    out.update(graphed_runs(model, VLM_AGENTS, batches,
                            (("ungrouped", ""),), "VLM"))
    return out


# ---------------------------------------------------------------------------
# phases 21 and 22: the hybrid family
# ---------------------------------------------------------------------------

def hybrid_train_phase():
    """Phase 22: jamba_1_5_large_398b cut in width (``HYBRID_TRAIN``: d_model
    1024, d_ff = dense_d_ff 2048) at one whole period of depth (8 layers,
    every kind in its place), ``AGENTS`` agents, seq 128, per-agent batch
    1, through :func:`graphed_runs` for ``gossip_groups="ssm:0,moe"`` (the
    conv / state leaves and the experts opt out) and the ungrouped bus;
    then ``remat`` against off, and the EDM and ring kernels on this bus
    (2.51 G elements: agent 3's block spans element 2³¹)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(get_config(HYBRID_ARCH),
                                            **HYBRID_TRAIN))
    out = {"params": sum(t.numel() for t in model.meta().values()),
           "layers": model.cfg.n_layers}
    check(out["params"] == HYBRID_TRAIN_PARAMS, f"the hybrid training cut "
          f"has {out['params']} parameters, expected {HYBRID_TRAIN_PARAMS}")
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                       n_agents=AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    batches = [data.sample(dgen, 1) for _ in range(GRAPH_STEPS + 1)]
    out.update(graphed_runs(model, AGENTS, batches,
                            ((HYBRID_GROUPS, HYBRID_GROUPS),
                             ("ungrouped", "")), "hybrid"))
    out["remat"] = remat_check(model, batches[0], "hybrid")
    out["kernels"] = bus_kernels(tuple(out["ungrouped"]["bus"]))
    return out


# ---------------------------------------------------------------------------
# phases 23 and 24: the encoder-decoder family
# ---------------------------------------------------------------------------

def whisper_serve_exactness():
    """At whisper_small's smoke config in f32 on the card (2 + 2 layers,
    16 frames): the prefill of S − 1 tokens, its self-attention caches
    grown by one row, then one decode step gives the full prefill's
    logits (rtol 1e-3 / atol 1e-4); ``greedy_generate``'s tokens equal a
    replay that prefills the frames and the first prompt token (the cross
    caches come from this prefill), feeds the rest of the prompt token by
    token through ``decode_step`` from position 1, then decodes
    greedily."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import greedy_generate, grow_caches
    cfg = get_smoke_config(WHISPER_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S, n_new = 2, 64, 16
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=gen)
    frames = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                         device="cuda", generator=gen)
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": tokens,
                                         "frontend": frames})
        _, caches = model.prefill(params, {"tokens": tokens[:, :-1],
                                           "frontend": frames})
        caches = grow_caches(model, caches, B, S)
        step, _ = model.decode_step(params, caches, tokens[:, -1:], S - 1)
        err = float((step - full).abs().max())
        check(bool(torch.allclose(step, full, rtol=1e-3, atol=1e-4)),
              f"whisper smoke: prefill + decode differs from the full "
              f"prefill by {err}")
        want = greedy_generate(model, params, {"tokens": tokens,
                                               "frontend": frames},
                               n_steps=n_new)
        logits, caches = model.prefill(params, {"tokens": tokens[:, :1],
                                                "frontend": frames})
        caches = grow_caches(model, caches, B, S + n_new)
        for t in range(1, S):
            logits, caches = model.decode_step(params, caches,
                                               tokens[:, t:t + 1], t)
        out = []
        for i in range(n_new):
            tok = torch.argmax(logits[:, -1].float(), -1).to(
                torch.int32)[:, None]
            out.append(tok)
            if i < n_new - 1:
                logits, caches = model.decode_step(params, caches, tok, S + i)
        replay = torch.cat(out, dim=1)
    check(torch.equal(replay, want), f"whisper smoke: greedy_generate "
          f"{want.tolist()} differs from the decode replay {replay.tolist()}")
    del model, params, caches
    free()
    return {"prefill_decode_max_abs_err": err, "prompt": S,
            "frames": cfg.n_frontend_tokens, "greedy_equal_replay": True,
            "tokens": B * n_new}


def whisper_handoff():
    """Phase 24's hand-off: :func:`train_and_export` of whisper_small at
    full size (the train CLI draws the frames every step), then the serve
    CLI's fixed batch ``--ckpt`` (1500 frames a request, no kernel of the
    port): the served parameters' digest equal to the export's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    rec, export_path, exported, want = train_and_export(WHISPER_ARCH,
                                                        "whisper")
    del exported
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served = serve_cli.main(WHISPER_CLI_ARGS + ["--ckpt", str(export_path)])
    rec["serve_s"] = time.perf_counter() - t0
    export_path.unlink()
    counts = ops.launch_counts()
    check(not any(counts.values()), f"whisper hand-off serving launched "
          f"{counts}")
    check(served["params_sha256"] == want,
          "the served whisper parameters are not the export's bits")
    rec["params_sha256"] = want
    rec["served_tokens"] = list(served["tokens"].shape)
    free()
    return rec


def whisper_train_phase():
    """Phase 24: whisper_small at full width and depth, ``AGENTS`` agents
    on the ring, seq 128 after the encoder's 1500 frames, per-agent batch
    1, through :func:`graphed_runs` (ungrouped) on its ``(4, 2171392,
    128)`` f32 bus.  New frames every step and step 1 repeats step 0's
    tokens, so a replay that read a stale frame buffer would part from the
    eager step.  Then the hand-off (:func:`whisper_handoff`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    model = build_model(get_config(WHISPER_ARCH))
    cfg = model.cfg
    out = {"params": sum(t.numel() for t in model.meta().values()),
           "layers": [cfg.n_enc_layers, cfg.n_layers]}
    check(out["params"] == WHISPER_PARAMS, f"{WHISPER_ARCH} has "
          f"{out['params']} parameters, expected {WHISPER_PARAMS}")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       n_agents=AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    batches = []
    for t in range(GRAPH_STEPS + 1):
        b = data.sample(dgen, 1)
        if t == 1:
            b["tokens"] = batches[0]["tokens"]
        b["frontend"] = torch.randn(
            (AGENTS, 1, cfg.n_frontend_tokens, cfg.d_model),
            generator=dgen, device="cuda").to(torch.bfloat16)
        batches.append(b)
    out.update(graphed_runs(model, AGENTS, batches, (("ungrouped", ""),),
                            "whisper"))
    check(out["ungrouped"]["bus"] == list(WHISPER_BUS),
          f"whisper bus {out['ungrouped']['bus']}, expected {WHISPER_BUS}")
    del batches
    free()
    out["handoff"] = whisper_handoff()
    return out


# ---------------------------------------------------------------------------
# phases 25 and 26: multi-rank gossip — 4 ranks on the one card, the
# peer-pointer kernels
# ---------------------------------------------------------------------------

PEER_RANKS = 4
PEER_STEPS = 3
PEER_STORE = ROOT / "build" / "peer_phase"
# phase 26 (a): the delayed pipeline on the ring, ring slot 1 (the left
# neighbour's payload) late at step 1; (b) policy groups over 4 steps (the
# every-other-step group gossips at steps 1 and 3: round_robin's offset-1
# round through the peer ring, its offset-2 round through the peer table)
OVERLAP_LATE = {"late": [[1, [1]]]}
GROUP_STEPS = 4
RANK_GROUPS = json.dumps([
    {"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},
    {"name": "attn", "match": ["|attn|"]},
    {"name": "rest", "gossip_every": 2, "schedule": "round_robin"}])
# phase 26 (c): the rounds the peer table kernel is held and timed on
TABLE_CASES = ("ring", "exp", "late", "masked")
# phase 27: the tree path across ranks, (a) EDM on the ring, (b) DSGT on
# round_robin over exp (its offset-1 round through the peer ring, its
# offset-2 round through the peer table), TREE_STEPS steps each, at full
# width with the depth cut to GRAPH_LAYERS (for the script's time: phase
# 30 runs the tree at full depth)
TREE_STEPS = 2
TREE_RUNS = {"edm": dict(packed_bus=False),
             "dsgt": dict(algorithm="dsgt", packed_bus=False,
                          topology="exp", gossip_schedule="round_robin")}
# phase 28: the wires, agent blocks and row shards across ranks.  A run:
# its RunConfig over the main cell's, its steps, agents a rank (B), row
# shards an agent (S), its churn plan and straggler plan.  Four ranks × one
# agent: (a) the int8 wire on the ring, (b) the bf16 wire on round_robin
# over exp, (c) the delayed pipeline on the int8 wire with ring slot 1 late
# at step 1, (d) phase 14's policy groups (one even and one odd step);
# ranks 0–1 × two agents, ranks 2–3 outside the mesh: (e) f32 on ring(4)
# with agent 3 down at step 2, then the int8 wire; two pods × two row
# shards: (f) f32 on ring(2), then the int8 wire
WireRun = collections.namedtuple("WireRun", "kw steps B S churn late")
BLOCK_CHURN = {"n_agents": AGENTS, "epochs": [{"start": 0, "down": []},
                                              {"start": 2, "down": [3]}]}
POD_AGENTS = 2
WIRE_RUNS = {
    "wire_int8": WireRun(dict(wire="int8"), 3, 1, 1, None, None),
    "wire_bf16": WireRun(dict(wire="bf16", topology="exp",
                              gossip_schedule="round_robin"), 2, 1, 1, None,
                         None),
    "wire_overlap": WireRun(dict(wire="int8", overlap="delayed"), 3, 1, 1,
                            None, OVERLAP_LATE),
    "wire_groups": WireRun(dict(gossip_groups=GROUP_POLICY), 2, 1, 1,
                           None, None),
    "block_f32": WireRun({}, 3, 2, 1, BLOCK_CHURN, None),
    "block_int8": WireRun(dict(wire="int8"), 2, 2, 1, None, None),
    "pod_f32": WireRun({}, 2, 1, 2, None, None),
    "pod_int8": WireRun(dict(wire="int8"), 1, 1, 2, None, None)}
# a rank's launches a step in each: every one-card combine of the
# one-process run (ONE_CARD) replaced by exactly one peer combine
ONE_CARD = ("gossip_axpy", "gossip_axpy_q8", "table_combine", "ring_combine")
PEER_COMBINES = ("ring_peer", "table_peer", "table_peer_q8")
WIRE_LAUNCHES = {
    "wire_int8": [{"edm_update_ef": 1, "table_peer_q8": 1}] * 3,
    "wire_bf16": [{"edm_update_ef": 1, "table_peer": 1}] * 2,
    "wire_overlap": [{"edm_update": 1, "table_peer_q8": 1}] * 3,
    "wire_groups": [{"edm_update": 1, "ring_peer": 1, "table_peer": 1},
                    {"edm_update": 1, "ring_peer": 1, "table_peer": 1,
                     "table_peer_q8": 1}],
    "block_f32": [{"edm_update": 1, "table_peer": 1}] * 3,
    "block_int8": [{"edm_update_ef": 1, "table_peer_q8": 1}] * 2,
    "pod_f32": [{"edm_update": 1, "ring_peer": 1}] * 2,
    "pod_int8": [{"edm_update_ef": 1, "table_peer_q8": 1}]}
# the peer kernels' new forms, held bit-equal on the final payloads of a
# run (every TABLE_CASES round) and, where timed, one rank at a time on
# the ring round: run → form
FORM_CHECKS = {"wire_int8": ("q8", True), "wire_bf16": ("bf16", True),
               "block_f32": ("block", True), "block_int8": ("q8_block",
                                                            False)}
# the runs whose form is timed keep full depth (their payloads are the
# main path's); the others run at GRAPH_LAYERS (cut_model), for the
# script's time (PERF.md §4)
WIRE_FULL_DEPTH = tuple(t for t, (_, timed) in FORM_CHECKS.items() if timed)


def wire_model(tag: str, model):
    """Phase 28's model for run ``tag``: ``model`` (the main path's, full
    depth) for a run whose form is timed, else :func:`cut_model`."""
    return model if tag in WIRE_FULL_DEPTH else cut_model()


def cut_model():
    """The main path's model at full width, the depth cut to
    ``GRAPH_LAYERS``: phase 27's runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(get_config(ARCH),
                                           n_layers=GRAPH_LAYERS))
# phase 30: the tree path with B = 2 agents a rank on ranks 0–1 (ranks 2–3
# outside the mesh), the rank's leaves of both agents packed into one (2,
# rows, 128) f32 payload of the peer table: (a) EDM on ring(4) with agent 3
# down at step 2 (BLOCK_CHURN: a masked round), (b) DSGT on round_robin over
# exp (both offsets through the table).  The model at full width, its depth
# cut to GRAPH_LAYERS (cut_model) for the script's time, as phase 27's
# (PERF.md §4).  A run: its RunConfig over the main cell's, its steps, its
# churn plan
TREE_BLOCK_B = 2
TREE_BLOCK_RUNS = {
    "edm": (dict(packed_bus=False), 3, BLOCK_CHURN),
    "dsgt": (dict(algorithm="dsgt", packed_bus=False, topology="exp",
                  gossip_schedule="round_robin"), 2, None)}


def bus_digest(t) -> list:
    """Two 64-bit digests of a bus's (or a tree leaf's) bits: the sum of
    its words (int32, or int16 for a 2-byte dtype), and their sum weighted
    by an odd hash of each word's position (wrapping, so the order of the
    additions does not matter) — what phases 26 and 27 hold a rank's
    buffers to, so that no full one-process state need stay on the card
    beside the four ranks."""
    import torch
    flat = t.detach().reshape(-1).view(
        torch.int16 if t.element_size() == 2 else torch.int32)
    s1 = s2 = 0
    chunk = 1 << 24
    for i in range(0, flat.numel(), chunk):
        w = flat[i:i + chunk].to(torch.int64)
        pos = torch.arange(i, i + w.numel(), dtype=torch.int64,
                           device=w.device)
        h = (pos * 2654435761) % (1 << 31) * 2 + 1
        s1 += int(w.sum())
        s2 = (s2 + int((w * h).sum())) % (1 << 64)
    return [s1, s2]


def rank_bufs(state) -> dict:
    """The buffers phases 26–28 compare: on the bus x, m, ψ, the wire's
    residual e and, under the overlap, the pipeline's live slot; on the
    tree every leaf of x and of every optimizer slot (``x|<path>``,
    ``<slot>|<path>``)."""
    if isinstance(state["params"], dict):
        out = {f"x|{p}": v for p, v in state["params"].items()}
        for slot, tree in state["opt"].items():
            out.update({f"{slot}|{p}": v for p, v in tree.items()})
        return out
    out = {"x": state["params"], **{k: state["opt"][k] for k in (
        "m", "psi", "e") if k in state["opt"]}}
    pipe = state.get("pipeline")
    if pipe is not None:
        out["phi"] = pipe["slot"][int(pipe["parity"])]
    return out


def one_process_run(model, run, batches, plan=None, digests=False,
                    agents=AGENTS, churn=None, shard_rows=None):
    """A one-process eager run of ``run`` over ``agents`` agents (4 by
    default) on the card under deterministic algorithms, the references of
    phases 25–28: the per-step per-agent losses (read off the trainer's
    ``losses_and_grads`` or, on the tree, ``tree_losses_and_grads``), the
    metrics, the step seconds, the launches (in all and a step), and the
    final buses (phase 25: x and ψ, kept on the card for the ranks) or the
    per-agent digests of every buffer (:func:`rank_bufs`; with
    ``shard_rows`` one a row shard of each agent).  ``churn``: a drop plan
    over the schedule."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train import trainer
    seen = []
    inner, tinner = trainer.losses_and_grads, trainer.tree_losses_and_grads

    def spy_of(fn):
        def spy(*a, **k):
            losses, g = fn(*a, **k)
            seen.append(losses.tolist())
            return losses, g
        return spy

    state = init_state(model, run, agents, seed=0, device="cuda")
    step = build_train_step(model, run,
                            make_gossip_schedule(run, agents, churn=churn),
                            use_fused_kernel=True, device="cuda",
                            straggler_plan=plan)
    secs, metrics, per_step = [], [], []
    trainer.losses_and_grads = spy_of(inner)
    trainer.tree_losses_and_grads = spy_of(tinner)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        for b in batches:
            before = ops.launch_counts()
            t0 = time.perf_counter()
            state, m = step(state, {k: v.cuda() for k, v in b.items()})
            metrics.append({k: float(m[k]) for k in ("loss", "consensus",
                                                     "grad_norm")})
            secs.append(time.perf_counter() - t0)
            per_step.append({k: v - before[k] for k, v in
                             ops.launch_counts().items() if v - before[k]})
    finally:
        trainer.losses_and_grads = inner
        trainer.tree_losses_and_grads = tinner
        torch.use_deterministic_algorithms(False)
    out = {"losses": seen, "seconds": secs, "metrics": metrics,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k: v for k, v in ops.launch_counts().items() if v},
           "step_launches": per_step}
    if digests:
        R = shard_rows
        out["digests"] = {
            k: [bus_digest(v[a]) if R is None else
                [bus_digest(v[a, s * R:(s + 1) * R])
                 for s in range(-(-v.shape[1] // R))]
                for a in range(agents)]
            for k, v in rank_bufs(state).items()}
    else:
        out["x"], out["psi"] = state["params"], state["opt"]["psi"]
    del state, step
    free()
    return out


def table_round(case, rank, world):
    """Rank ``rank``'s ``(src, weights)`` column of a round phase 26 (c)
    holds the peer table kernel on: the ±1 ring, an exponential hop (rank
    − 2), the ring with every term that reads rank 0 late (set to the
    reader), the ring with rank ``world − 1`` down (masked)."""
    left, right = (rank - 1) % world, (rank + 1) % world
    w = [1 / 3, 1 / 3, 1 / 3]
    if case == "ring":
        return [rank, left, right], w
    if case == "exp":
        return [rank, (rank - 2) % world], [0.5, 0.5]
    if case == "late":
        return [rank if s == 0 and rank != 0 else s
                for s in (rank, left, right)], w
    dead = world - 1
    if rank == dead:
        return [rank], [1.0]
    return [rank if s == dead else s for s in (rank, left, right)], w


def rank_steps(step, state, batches, mesh, rec, tag, profile_last=False):
    """Phases 26–28 and 30's driven run on one rank: the launch counts set
    to 0, the steps (the recorder's marks each step: the peer publish
    before the forward and backward pass, the combine after; each step's
    launches, collectives by kind and purpose, and metrics), the counts
    read; ``profile_last``: the last step under ``torch.profiler`` (its
    training kernels and roll bucket)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import comm
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.use_deterministic_algorithms(True)
    losses, secs, order, per_step, collectives = [], [], [], [], []
    prof_rows = None
    for t, b in enumerate(batches):
        b = {k: v.cuda() for k, v in b.items()}
        dist.barrier(group=mesh.control)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with comm.recording() as log:
            if profile_last and t == len(batches) - 1:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, m = step(state, b)
                    settle()
                prof_rows = device_rows(prof)
            else:
                state, m = step(state, b)
        losses.append(m["agent_losses"].tolist())
        rec.setdefault(f"{tag}_loss", []).append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        rec.setdefault(f"{tag}_metrics", []).append(
            {k: float(m[k]) for k in ("loss", "consensus", "grad_norm")})
        per_step.append({k: v - before[k] for k, v in
                         ops.launch_counts().items() if v - before[k]})
        order.append([n for n, _ in sorted(log.marks, key=lambda t: t[1])])
        collectives.append(dict(collections.Counter(
            f"{c.kind} {c.tag}" for c in log)))
    torch.use_deterministic_algorithms(False)
    rec[f"{tag}_launches"] = {k: v for k, v in ops.launch_counts().items()
                              if v}
    rec[f"{tag}_step_launches"] = per_step
    if prof_rows is not None:
        rec[f"{tag}_traced"] = traced_launches(prof_rows)
        rec[f"{tag}_roll_ms"] = bucket(prof_rows)["roll (gossip terms)"]
    rec[f"{tag}_step_ms"] = [round(t * 1e3, 2) for t in secs]
    rec[f"{tag}_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec[f"{tag}_peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    rec[f"{tag}_agent_losses"] = losses
    rec[f"{tag}_marks"] = order
    rec[f"{tag}_collectives"] = collectives
    rec[f"{tag}_digests"] = {k: [bus_digest(b) for b in v]
                             for k, v in rank_bufs(state).items()}
    return state


def table_checks(table, rank, world, mesh, rec):
    """Phase 26 (c) on one rank: the peer table kernel on the ranks' final
    payloads (the overlap's last epoch, static now; rank 0's payload
    poisoned with NaN first, so that the late round, whose terms that read
    rank 0 read the reader instead, must come out finite on the other
    ranks) for each of ``TABLE_CASES``, bit-equal to its plain version;
    then, one rank at a time, the ring round timed through the table kernel
    beside the plain version and one ``torch.matmul(w, stack)``."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops, ref
    views = table.views()
    if rank == 0:
        views[0].fill_(float("nan"))
    torch.cuda.synchronize()
    rec["table_cases"] = {}
    for r in range(world):
        dist.barrier(group=mesh.control)
        if r != rank:
            continue
        for case in TABLE_CASES:
            src, w = table_round(case, rank, world)
            copies = [v.clone() if j in src else v
                      for j, v in enumerate(views)]
            got = ops.table_peer(views, src, w)
            want = ref.table_peer_ref(copies, src, w)
            equal, err = compare([got], [want])
            rec["table_cases"][case] = {"bit_equal": equal,
                                        "max_abs_err": err,
                                        "finite": bool(torch.isfinite(
                                            got).all())}
            del copies, got, want
        src, w = table_round("ring", rank, world)
        n = views[rank].numel()
        rec["table_bytes"] = 4 * n * (len(set(src)) + 1)
        rec["table_bound_ms"], rec["table_bound_by"] = bound_ms(
            rec["table_bytes"], (2 * len(src) - 1) * n)
        out = torch.empty_like(views[rank])
        rec["table_ms"] = time_ms(lambda: ops.table_peer(views, src, w,
                                                         out=out))
        rec["table_plain_ms"] = time_ms(lambda: ref.table_peer_ref(
            views, src, w))
        stack = torch.stack([views[j][0].clone() for j in src]).view(
            len(src), -1)
        wt = torch.tensor([w], device=stack.device)
        lib = torch.matmul(wt, stack).view_as(out)
        rec["table_library_max_abs_diff"] = float(
            (lib - out).nan_to_num_(0.0, 0.0, 0.0).abs_().max())
        del lib
        rec["table_library_ms"] = time_ms(lambda: torch.matmul(wt, stack))
        del stack, out
        free()


def wire_agents(tag: str) -> int:
    """Agents of phase 28's run ``tag``."""
    return POD_AGENTS if WIRE_RUNS[tag].S > 1 else AGENTS


def wire_batches(tag: str, batches):
    """Phase 28's run ``tag``'s global batches: the first agents' rows."""
    A = wire_agents(tag)
    return [{k: v[:A] for k, v in b.items()}
            for b in batches[:WIRE_RUNS[tag].steps]]


def wire_run_config(tag: str, ranks: bool):
    """Phase 28's run ``tag``: across ranks (B agents a rank; a pod's
    agents in row shards) or in one process (every agent on the card)."""
    wr = WIRE_RUNS[tag]
    A = wire_agents(tag)
    return bus_run(global_batch=A, agents_per_device=wr.B if ranks else A,
                   agents="pod" if ranks and wr.S > 1 else "data", **wr.kw)


def wire_plan(tag: str, sched):
    from repro_torch.core.elastic import StragglerPlan
    late = WIRE_RUNS[tag].late
    return None if late is None else StragglerPlan.from_json(
        late, max(len(r.terms) for r in sched.rounds))


def wire_references(model, batches) -> dict:
    """Phase 28's references: each of ``WIRE_RUNS`` as one one-process
    eager fused run of its agents (a pod's agents unsharded, its digests
    taken a row shard at a time)."""
    from repro_torch.train import bus_layout_for, make_gossip_schedule
    refs = {}
    for tag, wr in WIRE_RUNS.items():
        A = wire_agents(tag)
        run = wire_run_config(tag, ranks=False)
        m = wire_model(tag, model)
        refs[tag] = one_process_run(
            m, run, wire_batches(tag, batches),
            wire_plan(tag, make_gossip_schedule(run, A, churn=wr.churn)),
            digests=True, agents=A, churn=wr.churn,
            shard_rows=(bus_layout_for(m, A, shards=wr.S).shard_rows
                        if wr.S > 1 else None))
    return refs


def block_round(case, rank, n_ranks, B):
    """Rank ``rank``'s ``(K, B)`` columns of a round over ``n_ranks`` × B
    agents that phase 28 holds the peer kernels on: the ±1 ring, the
    exponential graph, the ring with every term that reads rank 0's
    agents from another rank late (it reads the agent itself) and the ring
    with the last agent down (masked)."""
    import numpy as np
    from repro_torch.core import exp_graph, ring
    from repro_torch.core.elastic import degrade_round
    from repro_torch.core.mixing import round_tables
    A = n_ranks * B
    if case == "exp":
        src, w = round_tables(exp_graph(A))
    elif case == "masked":
        src, w = round_tables(degrade_round(ring(A), [True] * (A - 1)
                                            + [False]))
    else:
        src, w = round_tables(ring(A))
        if case == "late":
            own = np.tile(np.arange(A, dtype=src.dtype), (src.shape[0], 1))
            src = np.where((src // B == 0) & (own // B != 0), own, src)
    cols = slice(rank * B, (rank + 1) * B)
    return src[:, cols], w[:, cols]


def poison(payload) -> None:
    """NaN with ±Inf among it over a payload (the int8 wire's: its
    scales)."""
    t = (payload[1] if isinstance(payload, tuple) else payload).view(-1)
    t.fill_(float("nan"))
    t[1::3] = float("inf")
    t[2::3] = float("-inf")


def peer_form_checks(table, mesh, rec, tag, timed):
    """Phase 28's kernel checks on one rank: the peer table's kernel in the
    table's form (the q8 kernel on the int8 wire, the table kernel on bf16
    or on f32 blocks of B agents) on the ranks' final payloads (the run's
    last epoch, static now; rank 0's poisoned first with NaN and ±Inf) for
    each of ``TABLE_CASES`` (:func:`block_round`), bit-equal to its plain
    version; a late round's output finite where rank 0's payload is not
    read.  ``timed``: one rank at a time, the ring round timed beside the
    plain version, the bound and (not the q8 form: no single call) one
    ``torch.matmul(W, stack)`` on f32 copies of the blocks read."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops, ref
    B, br = table.B, table.block_rows
    rank, n_ranks = table.me, table.n
    pays = table.views()
    if rank == 0:
        poison(pays[0])
    torch.cuda.synchronize()

    def clone(p):
        return tuple(t.clone() for t in p) if isinstance(p, tuple) \
            else p.clone()

    def run(src, w, payloads, out=None):
        if br is None:
            return ops.table_peer(payloads, src, w, out=out)
        qs, scales = zip(*payloads)
        return ops.table_peer_q8(qs, scales, src, w, block_rows=br, out=out)

    def plain(src, w, payloads):
        if br is None:
            return ref.table_peer_ref(payloads, src, w)
        qs, scales = zip(*payloads)
        return ref.table_peer_q8_ref(qs, scales, src, w, block_rows=br)

    out_rec = rec.setdefault("forms", {})[tag] = {"cases": {}}
    for r in range(n_ranks):
        dist.barrier(group=mesh.control)
        if r != rank:
            continue
        for case in TABLE_CASES:
            src, w = block_round(case, rank, n_ranks, B)
            reads = {int(g) // B for g in src.reshape(-1)}
            copies = [clone(p) if j in reads else p
                      for j, p in enumerate(pays)]
            got = run(src, w, pays)
            want = plain(src, w, copies)
            equal, err = compare([got], [want])
            out_rec["cases"][case] = {
                "bit_equal": equal, "max_abs_err": err,
                "finite": bool(torch.isfinite(got).all())}
            del copies, got, want
        if timed:
            src, w = block_round("ring", rank, n_ranks, B)
            blocks = sorted({int(g) for g in src.reshape(-1)})
            data = pays[rank][0] if br else pays[rank]
            n = data[0].numel()               # elements an agent block
            read = len(blocks) * n * data.element_size()
            if br:
                read += len(blocks) * (n // (br * 128)) * 4
            out_rec.update(
                shape=list(data.shape), dtype=str(data.dtype).split(".")[-1],
                blocks_read=len(blocks), bytes=read + 4 * B * n)
            out_rec["bound_ms"], out_rec["bound_by"] = bound_ms(
                out_rec["bytes"], (2 * src.shape[0] - (br is None)) * B * n)
            out = torch.empty((B,) + tuple(data.shape[1:]),
                              dtype=torch.float32, device=data.device)
            out_rec["ms"] = time_ms(lambda: run(src, w, pays, out=out))
            out_rec["plain_ms"] = time_ms(lambda: plain(src, w, pays))
            out_rec["library_ms"] = None
            if not br:
                W = torch.zeros((B, len(blocks)), device=out.device)
                for b in range(B):
                    for k in range(src.shape[0]):
                        W[b, blocks.index(int(src[k, b]))] += float(w[k, b])
                stack = torch.stack([pays[g // B][g % B].float()
                                     for g in blocks]).view(len(blocks), -1)
                lib = torch.matmul(W, stack).view_as(out)
                out_rec["library_max_abs_diff"] = float(
                    (lib - out).nan_to_num_(0.0, 0.0, 0.0).abs_().max())
                del lib
                out_rec["library_ms"] = time_ms(lambda: torch.matmul(W,
                                                                     stack))
                del stack
            del out
        free()


def wire_run(tag, model, batches, mesh, rank, rec):
    """Phase 28's run ``tag`` on this rank of ``mesh``: the multi-rank
    step of ``WIRE_RUNS[tag]`` from seed 0 over its steps
    (:func:`rank_steps`, rank 0's last step profiled), its transports'
    flag waits and epochs, its form's kernel checks on the final payloads
    (``FORM_CHECKS``); the step closed.  Returns the run's seconds."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.table_peer import PeerTable
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    t0 = time.time()
    wr = WIRE_RUNS[tag]
    A = wire_agents(tag)
    run = wire_run_config(tag, ranks=True)
    sched = make_gossip_schedule(run, A, churn=wr.churn)
    sa = "data" if wr.S > 1 else None
    step = build_train_step(model, run, sched, use_fused_kernel=True,
                            mesh=mesh, shard_axes=sa,
                            straggler_plan=wire_plan(tag, sched))
    state = init_state(model, run, A, seed=0, mesh=mesh, shard_axes=sa)
    rec[f"{tag}_bus"] = list(state["params"].shape)
    state = rank_steps(step, state, wire_batches(tag, batches), mesh, rec,
                       tag, profile_last=rank == 0)
    transports = step.transports()
    for t in transports:
        t.raise_on_timeout()
    rec[f"{tag}_waits"] = sum(getattr(t, "waits", 0) for t in transports)
    rec[f"{tag}_epochs"] = [t.epoch for t in transports]
    rec[f"{tag}_peer_gib"] = sum(
        getattr(t, "_flag_off", 0) / 2**30 for t in transports)
    del state
    free()
    if tag in FORM_CHECKS:
        table = next(t for t in transports if isinstance(t, PeerTable))
        peer_form_checks(table, mesh, rec, *FORM_CHECKS[tag])
    torch.cuda.synchronize()
    dist.barrier(group=mesh.control)
    step.close()
    del step
    free()
    return time.time() - t0


def wire_ranks(rank, world, model, batches, refs, mesh, rec):
    """Phase 28 on one rank (after 27): (a)–(d) on the four ranks one
    agent each, (e) on ranks 0–1 two agents each, (f) on two pods of two
    row shards; each run's per-agent losses and buffer digests held to
    its reference (``refs``: a rank's agents' digests, a shard's of its
    rows).  ``mesh``: phases 25–27's, one agent a rank."""
    import torch.distributed as dist
    from repro_torch.core.comm import rank_block
    from repro_torch.launch.mesh import make_gossip_mesh
    t28 = time.time()
    meshes = {1: mesh, 2: make_gossip_mesh(world, agents_per_device=2),
              "pod": make_gossip_mesh(POD_AGENTS, pods=POD_AGENTS,
                                      shards=2)}
    rec["wire_s"] = {}
    for tag, wr in WIRE_RUNS.items():
        mesh = meshes["pod" if wr.S > 1 else wr.B]
        rec[f"{tag}_member"] = mesh.member
        if mesh.member:
            rec["wire_s"][tag] = wire_run(tag, wire_model(tag, model),
                                          batches, mesh, rank, rec)
            a0, B, s, _ = rank_block(mesh, wire_agents(tag),
                                     "data" if wr.S > 1 else None)
            want = refs[tag]["digests"]
            rec[f"{tag}_equal"] = all(
                rec[f"{tag}_digests"][k] == (
                    [want[k][a0][s]] if wr.S > 1 else want[k][a0:a0 + B])
                for k in want)
        dist.barrier()
    rec["p28_s"] = time.time() - t28


# phase 29: deepseek_moe_16b over phase 25's four ranks on a (1, 4)
# ("data", "model") grid, 16 of the 64 experts a layer a rank
# (models/moe.py::apply_moe_shard_map), served by the continuous engine
# with the paged kernels.  Every request arrives at once, so that every
# rank — and the one-process engine it is held to — takes the same
# admissions.  (a) the expert-parallel layout alone (every other leaf
# whole: set_moe_mesh(mesh, "shard_map"), one sum a MoE layer call), f32
# with the depth cut 28 → 2, 4 requests at capacity 8.0 (dropless) and
# the config's 1.25, against the one-process engine's tokens; (b) the
# reference's serving layout (EP + TP: lm_param_specs on the grid,
# build_model(cfg, mesh=grid) — attention 4 of 16 heads a rank, the
# shared experts' columns split, the vocabulary split; 2L + 1 sums a
# forward), bf16 at full width, 8 requests at context 1024, its depth cut
# 28 → 4 (the script's time: PERF.md §4); tools/tp_phase.py --arch
# deepseek_moe_16b runs (b) at all 28 layers
EpServe = collections.namedtuple("EpServe", "n prompts new slots ctx seed")
EP_F32_LAYERS, EP_F32_CFS = 2, (8.0, 1.25)
EP_B_LAYERS = 4
EP_A = EpServe(4, (128, 256), (8,), 4, 512, 21)
EP_B = EpServe(8, (256, 512), (16, 32), 8, CTX, 22)


def ep_requests(spec: EpServe, vocab: int):
    """``spec``'s requests, every arrival at 0."""
    from repro_torch.serve import poisson_load
    return [dataclasses.replace(r, arrival=0.0) for r in poisson_load(
        spec.n, rate=1000.0, vocab=vocab, prompt_buckets=spec.prompts,
        new_token_buckets=spec.new, prompt_dist="exact", seed=spec.seed)]


def ep_engine(model, params, spec: EpServe):
    """The continuous engine of phase 29 at ``spec``'s slots and context:
    the paged kernels, chunks of 128, phase 8's token budget."""
    from repro_torch.serve import ContinuousBatchingEngine, PagedCacheConfig
    pcfg = PagedCacheConfig(page_size=PAGE,
                            num_pages=1 + spec.slots * spec.ctx // PAGE,
                            max_slots=spec.slots, max_context=spec.ctx)
    return ContinuousBatchingEngine(model, params, pcfg, attn_impl="kernel",
                                    prefill_chunk=CHUNK,
                                    max_step_tokens=STEP_TOKENS,
                                    device="cuda")


def ep_f32_config(cf: float):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=EP_F32_LAYERS,
                               dtype="float32", capacity_factor=cf)


def ep_b_config(n_layers: int = EP_B_LAYERS):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers)


def ep_tokens(eng) -> dict:
    return {str(r): t.tolist() for r, t in sorted(eng.completed.items())}


def ep_references() -> dict:
    """Phase 29's one-process references (the whole expert set in one
    process, ``model.init`` from seed 0): (a) the f32 2-layer model's
    engine tokens on :data:`EP_A`'s requests at each capacity; (b) the
    bf16 ``EP_B_LAYERS``-layer model's engine tokens and metrics on
    :data:`EP_B`'s requests, after a one-request warm-up."""
    import torch
    from repro_torch.models import build_model
    out = {}
    for cf in EP_F32_CFS:
        model = build_model(ep_f32_config(cf))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        eng = ep_engine(model, params, EP_A)
        eng.run(ep_requests(EP_A, model.cfg.vocab_size))
        out[str(cf)] = ep_tokens(eng)
        del eng, params, model
        free()
    out["b"] = ep_b_reference(EP_B_LAYERS)
    return out


def ep_b_reference(n_layers: int) -> dict:
    """Phase 29 (b)'s one-process reference: the whole bf16 model at
    ``n_layers`` (``model.init`` from seed 0) through the engine on
    :data:`EP_B`'s requests, after a one-request warm-up
    (:func:`tp_serve`); ``s`` is the whole reference's seconds, init
    included."""
    import torch
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(ep_b_config(n_layers))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    run = tp_serve(model, params, greedy=False, spec=EP_B)
    del run["eng"], params, model
    free()
    return dict(run["engine"], s=time.perf_counter() - t0)


def ep_run(eng, reqs):
    """Drive ``reqs`` through ``eng`` with the counts set to 0 just before
    and read just after: (metrics, launches, the sums over the model axis,
    any other collective)."""
    from repro_torch.core import comm
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    with comm.recording() as log:
        metrics = eng.run(reqs)
    counts = ops.launch_counts()
    is_sum = [c.kind == "all-reduce" and c.tag == "moe" for c in log]
    return metrics, counts, sum(is_sum), [c.kind for c, y in zip(log, is_sum)
                                          if not y]


def ep_dispatches(eng, vocab: int, slots: int = EP_B.slots,
                  phase: str = "phase 29") -> dict:
    """One mixed and one decode-only dispatch of the bf16 engine timed on
    the host clock (each ending in a device sync), the sums over the model
    axis timed apart inside it (a device sync before each, then the
    host-staged all-reduce): the second dispatch of each kind after
    ``slots`` requests of two chunks each are admitted."""
    import numpy as np
    import torch
    from repro_torch.core import comm
    from repro_torch.serve import Request
    rng = np.random.default_rng(9)
    eng.reset()
    for i in range(slots):
        check(eng.try_admit(Request(rid=i, tokens=rng.integers(
            0, vocab, (2 * CHUNK,)).astype(np.int32), max_new=8,
            arrival=0.0)), f"{phase}: a timed request was not admitted")
    inner, spent = comm.all_reduce, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    seen, out = {"mixed": 0, "decode": 0}, {}
    comm.all_reduce = timed
    try:
        while len(out) < 2:
            kind = "mixed" if eng._filling else "decode"
            seen[kind] += 1
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if seen[kind] == 2 and kind not in out:
                out[kind] = {"ms": ms, "sums": len(spent),
                             "sums_ms": sum(spent) * 1e3,
                             "sums_share": sum(spent) * 1e3 / ms}
    finally:
        comm.all_reduce = inner
    eng.reset()
    return out


def ep_ranks(rank, world, refs, rec):
    """Phase 29 on one rank (after 28): (a) the rank's block of experts
    from the rank-local init (:func:`init_lm_rank` under the expert-only
    layout, never the whole set), the grid registered, through the
    engine, its tokens against the one-process engine's (``refs``); then
    (b) (:func:`ep_b_ranks`).  Each run's tokens, launches, collectives
    and metrics into ``rec``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_moe_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.models.transformer import (expert_param_specs,
                                                init_lm_rank)
    t29 = time.time()
    free()
    rec["card_free_gib_29"] = torch.cuda.mem_get_info()[0] / 2**30
    mesh = make_moe_mesh(1, world)
    moe.set_moe_mesh(mesh, "shard_map")
    try:
        for cf in EP_F32_CFS:
            model = build_model(ep_f32_config(cf))
            params = init_lm_rank(model.cfg, torch.Generator(
                device="cuda").manual_seed(0), rank, world,
                specs=expert_param_specs(model.meta()))
            eng = ep_engine(model, params, EP_A)
            metrics, counts, sums, other = ep_run(
                eng, ep_requests(EP_A, model.cfg.vocab_size))
            toks = ep_tokens(eng)
            rec[f"ep_a_{cf}"] = {
                "metrics": metrics, "counts": counts, "sums": sums,
                "other": other, "equal": toks == refs[str(cf)],
                "tokens": toks}
            del eng, params, model
            free()
    finally:
        moe.set_moe_mesh(None)
    dist.barrier(group=mesh.control)
    rec["ep_a_s"] = time.time() - t29
    ep_b_ranks(rank, world, rec)
    rec["p29_s"] = time.time() - t29


def ep_b_ranks(rank, world, rec, b_layers: int = EP_B_LAYERS):
    """Phase 29 (b) on one rank: the EP + TP serving layout at
    ``b_layers`` (kept in ``rec``): the model built on the ``(1, world)``
    grid, the rank's blocks from the rank-local init, through the engine
    (:func:`tp_serve`), then one mixed and one decode-only dispatch timed
    with the sums apart."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_moe_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_lm_rank
    free()
    rec.setdefault("card_free_gib_29", torch.cuda.mem_get_info()[0] / 2**30)
    mesh = make_moe_mesh(1, world)
    rec["ep_b_layers"] = b_layers
    cfg = ep_b_config(b_layers)
    model = build_model(cfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm_rank(cfg, torch.Generator(device="cuda").manual_seed(
        0), rank, world)
    torch.cuda.synchronize()
    rec["ep_init_s"] = time.perf_counter() - t0
    rec["ep_init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["ep_param_gb"] = sum(t.numel() * t.element_size()
                             for t in params.values()) / 1e9
    rec["ep_experts"] = params["blocks|0|moe|w_gate"].shape[1]
    rec["ep_heads"] = [params["blocks|0|attn|wq"].shape[-1] // cfg.hd,
                       params["blocks|0|attn|wk"].shape[-1] // cfg.hd]
    rec["ep_shared_cols"] = params["blocks|0|moe|shared|w_up"].shape[-1]
    t0 = time.time()
    b = tp_serve(model, params, greedy=False, spec=EP_B)
    eng = b.pop("eng")
    rec["ep_b"] = b["engine"]
    rec["ep_b_s"] = time.time() - t0
    rec["ep_b_dispatches"] = ep_dispatches(eng, cfg.vocab_size)
    del eng, params, model
    free()
    dist.barrier(group=mesh.control)


# phase 31: qwen3_14b tensor-parallel over phase 25's four ranks (the
# reference's serve_param_specs layout on a (1, 4) ("data", "model") grid,
# build_model(cfg, mesh=grid)): a rank holds 10 of the 40 query heads and 2
# of the 8 KV heads a layer, 4352 of the 17408 FFN columns and 37984 of the
# 151936 vocabulary rows, drawn rank-locally (init_lm_rank), and serves
# through the continuous engine with the paged kernels at K 2, G 5, hd
# 128: 2L + 1 sums over the model axis and one gather of the logits a
# decode-only dispatch, twice that a mixed one.  Every request arrives at
# once.  (a) f32 with the depth cut 40 → 2: 8 requests at context 1024
# (prompts 256–768, chunks of 128) and greedy_generate on 4 prompts, each
# against the one-process run's tokens; (b) bf16 at TP_BF16_LAYERS layers
# on the same 8 requests, every rank's tokens bit-equal to rank 0's.  (b)
# is cut to 4 of the 40 layers for the script's time: each layer costs
# ~3.6-4.2 s (2L + 1 host-staged sums a forward, ~8 ms each, and the
# one-process reference), and 4 is the deepest multiple of 4 that keeps
# the script under 1200 s, with at least 15 s to spare, on the slowest
# host measured (at 20 layers it ran 1248.7 s there; PERF.md §4 has the
# arithmetic); tools/tp_phase.py runs the phase alone at full depth
TP_ARCH = "qwen3_14b"
TP_F32_LAYERS = 2
TP_BF16_LAYERS = 4
TP_SERVE = EpServe(8, (256, 768), (16, 32), 8, CTX, 31)
TP_GREEDY = (4, 256, 16)          # prompts, prompt length, new tokens
TP_PLAIN = ("paged_attention_ref", "paged_prefill_attention_ref")


def tp_config(dtype: str, n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TP_ARCH), n_layers=n_layers,
                               dtype=dtype)


def tp_collectives(log) -> dict:
    """A record's collectives counted by tag and kind."""
    out = {}
    for c in log:
        key = f"{c.tag} {c.kind}"
        out[key] = out.get(key, 0) + 1
    return out


def tp_run(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, its collectives recorded and the plain attention twins
    counted: (result, launches, collectives, plain calls)."""
    from repro_torch.core import comm
    from repro_torch.kernels import ops, ref
    plain = {name: 0 for name in TP_PLAIN}
    inner = {name: getattr(ref, name) for name in TP_PLAIN}

    def counted(name):
        def call(*a, **k):
            plain[name] += 1
            return inner[name](*a, **k)
        return call

    for name in TP_PLAIN:
        setattr(ref, name, counted(name))
    try:
        ops.reset_launch_counts()
        with comm.recording() as log:
            out = fn()
        counts = ops.launch_counts()
    finally:
        for name in TP_PLAIN:
            setattr(ref, name, inner[name])
    return out, counts, tp_collectives(log), sum(plain.values())


def tp_prompts(vocab: int):
    import numpy as np
    import torch
    n, S, _ = TP_GREEDY
    rng = np.random.default_rng(32)
    return torch.from_numpy(rng.integers(0, vocab, (n, S)).astype(
        np.int32)).cuda()


def tp_serve(model, params, greedy: bool, spec: EpServe = TP_SERVE
             ) -> dict:
    """Phase 31's runs of ``model`` (on the grid or whole; phase 29 (b)'s
    too, at ``spec`` :data:`EP_B`): the engine on ``spec``'s requests
    (bf16: after a one-request warm-up) and, with ``greedy``,
    ``greedy_generate`` on :data:`TP_GREEDY`'s prompts; each run's
    tokens, metrics, launches, collectives and plain-twin calls, the
    serving peak and the pools' GB."""
    import torch
    from repro_torch.serve import greedy_generate
    vocab = model.cfg.vocab_size
    eng = ep_engine(model, params, spec)
    if model.cfg.dtype == "bfloat16":
        eng.run(ep_requests(spec._replace(n=1, new=(2,)), vocab))
        eng.reset()
    torch.cuda.reset_peak_memory_stats()
    metrics, counts, colls, plain = tp_run(
        lambda: eng.run(ep_requests(spec, vocab)))
    out = {"engine": {"metrics": metrics, "counts": counts,
                      "collectives": colls, "plain": plain,
                      "tokens": ep_tokens(eng),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "pool_gb": sum(t.numel() * t.element_size()
                                     for pi in eng.pools
                                     for t in pi.values()) / 1e9}}
    if greedy:
        toks, counts, colls, plain = tp_run(lambda: greedy_generate(
            model, params, {"tokens": tp_prompts(vocab)}, TP_GREEDY[2]))
        out["greedy"] = {"tokens": toks.cpu().tolist(), "counts": counts,
                         "collectives": colls, "plain": plain}
    out["eng"] = eng
    return out


def tp_ranks(rank, world, rec, bf16_layers: int = TP_BF16_LAYERS):
    """Phase 31 on one rank (after 30): the rank's blocks from the
    rank-local init (:func:`init_lm_rank`, never the whole model), the
    model built on the ``(1, world)`` grid, then (a) and (b) at
    ``bf16_layers`` (:func:`tp_serve`; the depth is kept in ``rec`` for
    the gates and the lines); (b)'s init time and peak, and one mixed and
    one decode-only dispatch timed with the sums apart."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_moe_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_lm_rank
    t31 = time.time()
    free()
    rec["card_free_gib_31"] = torch.cuda.mem_get_info()[0] / 2**30
    mesh = make_moe_mesh(1, world)
    model = build_model(tp_config("float32", TP_F32_LAYERS), mesh=mesh)
    params = init_lm_rank(model.cfg, torch.Generator(
        device="cuda").manual_seed(0), rank, world)
    a = tp_serve(model, params, greedy=True)
    del a["eng"], params, model
    rec["tp_a"] = a
    free()
    dist.barrier(group=mesh.control)
    rec["tp_a_s"] = time.time() - t31
    rec["tp_b_layers"] = bf16_layers
    model = build_model(tp_config("bfloat16", bf16_layers), mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm_rank(model.cfg, torch.Generator(
        device="cuda").manual_seed(0), rank, world)
    torch.cuda.synchronize()
    rec["tp_init_s"] = time.perf_counter() - t0
    rec["tp_init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["tp_param_gb"] = sum(t.numel() * t.element_size()
                             for t in params.values()) / 1e9
    hd = model.cfg.hd
    rec["tp_heads"] = [params["blocks|0|attn|wq"].shape[-1] // hd,
                       params["blocks|0|attn|wk"].shape[-1] // hd]
    t0 = time.time()
    b = tp_serve(model, params, greedy=False)
    eng = b.pop("eng")
    rec["tp_b"] = b
    rec["tp_b_s"] = time.time() - t0
    t0 = time.time()
    rec["tp_b_dispatches"] = ep_dispatches(eng, model.cfg.vocab_size,
                                           TP_SERVE.slots, "phase 31")
    rec["tp_b_timing_s"] = time.time() - t0
    del eng, params, model
    free()
    dist.barrier(group=mesh.control)
    rec["p31_s"] = time.time() - t31


def tp_references(bf16_layers: int) -> dict:
    """Phase 31's one-process references, after the ranks have freed
    their shards: the whole f32 2-layer model (``model.init`` from seed 0,
    the stream the ranks drew their blocks from) through (a)'s runs, and
    the whole bf16 model at ``bf16_layers`` through (b)'s."""
    import torch
    from repro_torch.models import build_model
    out = {}
    for tag, dtype, n_layers in (("a", "float32", TP_F32_LAYERS),
                                 ("b", "bfloat16", bf16_layers)):
        t0 = time.time()
        model = build_model(tp_config(dtype, n_layers))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        run = tp_serve(model, params, greedy=tag == "a")
        del run["eng"], params, model
        free()
        out[tag] = run
        out[f"{tag}_s"] = time.time() - t0
    return out


def check_tp_ranks(ranks, refs) -> None:
    """Phase 31's gates: (a) every rank's f32 engine and greedy tokens
    equal to the one-process runs'; (b) every rank's bf16 tokens equal to
    rank 0's, every request served; in every run of a rank and of the
    references the paged kernels launched once a layer a dispatch (the
    prefill once a layer a mixed one), no other kernel and no plain twin;
    a rank's collectives exactly 2L + 1 sums and one logits gather over
    the model axis a forward (a mixed dispatch: two forwards) and no
    other; each rank holding 10 / 2 heads a layer; the timed dispatches'
    sums 2 (2L + 1) and 2L + 1."""
    L_b = ranks[0]["tp_b_layers"]
    runs = (("(a) f32", "tp_a", TP_F32_LAYERS), ("(b) bf16", "tp_b", L_b))
    want_b = ranks[0]["tp_b"]["engine"]["tokens"]
    for what, key, L in runs:
        ref_run = refs[key[-1]]["engine"]
        check_serve_counts(ref_run["counts"], ref_run["metrics"], L,
                           f"phase 31 {what} one process")
        check(ref_run["plain"] == 0, f"phase 31 {what} one process: "
              f"{ref_run['plain']} plain attention calls")
    for r in ranks:
        tag = f"phase 31 rank {r['rank']}"
        for what, key, L in runs:
            run = r[key]["engine"]
            m = run["metrics"]
            check_serve_counts(run["counts"], m, L, f"{tag} {what}")
            check(run["plain"] == 0, f"{tag} {what}: {run['plain']} plain "
                  "attention calls")
            n = m["steps"] + m["mixed_steps"]
            check(run["collectives"] == {"tp all-reduce": (2 * L + 1) * n,
                                         "tp all-gather": n},
                  f"{tag} {what}: collectives {run['collectives']} in "
                  f"{m['steps']} dispatches ({m['mixed_steps']} mixed) of "
                  f"{L} layers")
            check(m["requests"] == TP_SERVE.n, f"{tag} {what}: "
                  f"{m['requests']} of {TP_SERVE.n} requests served")
        a = r["tp_a"]
        check(a["engine"]["tokens"] == refs["a"]["engine"]["tokens"],
              f"{tag} (a): the f32 engine's tokens differ from the "
              f"one-process engine's: {a['engine']['tokens']}")
        g, n_new = a["greedy"], TP_GREEDY[2]
        check(g["tokens"] == refs["a"]["greedy"]["tokens"],
              f"{tag} (a): greedy_generate's f32 tokens differ from one "
              f"process's: {g['tokens']}")
        check(g["collectives"] == {
            "tp all-reduce": (2 * TP_F32_LAYERS + 1) * n_new,
            "tp all-gather": n_new} and g["plain"] == 0
            and not any(g["counts"].values()),
            f"{tag} (a): greedy_generate's collectives {g['collectives']}, "
            f"launches {g['counts']}")
        check(r["tp_b_layers"] == L_b, f"{tag} (b): {r['tp_b_layers']} "
              f"layers, rank 0 {L_b}")
        check(r["tp_b"]["engine"]["tokens"] == want_b,
              f"{tag} (b): the bf16 tokens differ from rank 0's")
        check(r["tp_heads"] == [10, 2], f"{tag}: {r['tp_heads']} query / KV "
              "heads a layer")
        d = r["tp_b_dispatches"]
        s = 2 * L_b + 1
        check(d["mixed"]["sums"] == 2 * s and d["decode"]["sums"] == s,
              f"{tag}: timed dispatches' sums {d}")


def print_tp(rec, smi: str) -> None:
    """Phase 31's lines."""
    refs = rec["tp_refs"]
    rb = refs["b"]["engine"]["metrics"]
    for r in rec["ranks"]:
        a, b, dd = r["tp_a"], r["tp_b"]["engine"], r["tp_b_dispatches"]
        ma, m = a["engine"]["metrics"], b["metrics"]
        print(f"[tp31] rank {r['rank']} (a) f32 {TP_F32_LAYERS} layers: "
              f"{ma['tokens']} tokens in {ma['steps']} dispatches "
              f"({ma['mixed_steps']} mixed), launches "
              f"{ {k: n for k, n in a['engine']['counts'].items() if n} }, "
              f"collectives {a['engine']['collectives']}; greedy_generate "
              f"{TP_GREEDY}: collectives {a['greedy']['collectives']}; "
              "tokens equal to one process's", flush=True)
        print(f"[tp31] rank {r['rank']} (b) bf16 {r['tp_b_layers']} layers, "
              f"{r['tp_heads'][0]} / {r['tp_heads'][1]} heads a layer: init "
              f"{r['tp_init_s']:.2f} s, params {r['tp_param_gb']:.2f} GB, "
              f"init peak {r['tp_init_peak_gib']:.2f} GiB, serving peak "
              f"{b['peak_gib']:.2f} GiB (pools {b['pool_gb']:.3f} GB); "
              f"{m['tokens']} tokens over {m['requests']} requests in "
              f"{m['steps']} dispatches ({m['mixed_steps']} mixed), "
              f"{m['tokens_per_s']} tokens/s (one process "
              f"{rb['tokens_per_s']}), wall {m['wall_s']} s, TTFT p50 "
              f"{m['ttft_p50_ms']} ms, per-token p50 {m['p50_ms']} / p99 "
              f"{m['p99_ms']} ms; launches "
              f"{ {k: n for k, n in b['counts'].items() if n} }, collectives "
              f"{b['collectives']}; a mixed dispatch {dd['mixed']['ms']:.1f} "
              f"ms of which {dd['mixed']['sums']} sums "
              f"{dd['mixed']['sums_ms']:.1f} ms "
              f"({dd['mixed']['sums_share']:.1%}), a decode-only "
              f"{dd['decode']['ms']:.1f} ms of which {dd['decode']['sums']} "
              f"sums {dd['decode']['sums_ms']:.1f} ms "
              f"({dd['decode']['sums_share']:.1%}); card free at the phase's "
              f"start {r['card_free_gib_31']:.2f} GiB; {smi}", flush=True)
    agree = ep_agreement(rec["ranks"][0]["tp_b"]["engine"]["tokens"],
                         refs["b"]["engine"]["tokens"])
    rec["tp_b_agreement"] = agree
    print(f"[tp31] (b) the four ranks' bf16 tokens against the one-process "
          f"engine's on the same {agree['requests']} requests "
          f"({rb['tokens']} tokens in {rb['wall_s']} s, "
          f"{rb['tokens_per_s']} tokens/s, serving peak "
          f"{refs['b']['engine']['peak_gib']:.2f} GiB): "
          f"{agree['equal_share']:.1%} of the tokens equal, "
          f"{agree['requests_equal']} requests whole, first divergence "
          f"(request, position) {agree['first_divergence']} (reported, not "
          "gated: the sums over the ranks add the partials in another "
          "order)", flush=True)
    print(f"[time] phase 31 took "
          f"{statistics.median(r['p31_s'] for r in rec['ranks']):.1f} s in "
          f"the ranks (median; per rank "
          f"{[round(r['p31_s'], 1) for r in rec['ranks']]}; rank 0's (a) "
          f"{rec['ranks'][0]['tp_a_s']:.1f} s, (b)'s runs "
          f"{rec['ranks'][0]['tp_b_s']:.1f} s and timed dispatches "
          f"{rec['ranks'][0]['tp_b_timing_s']:.1f} s), its "
          f"one-process references {refs['a_s'] + refs['b_s']:.1f} s "
          f"((a) {refs['a_s']:.1f}, (b) {refs['b_s']:.1f}); every rank's "
          "tokens equal (bf16: bit-equal to rank 0's)", flush=True)


# phase 32: falcon_mamba_7b tensor-parallel over phase 25's four ranks, in
# the same spawn after phase 31 (the reference's lm_param_specs for the SSM
# family on a (1, 4) ("data", "model") grid, build_model(cfg, mesh=grid)):
# a rank holds 2048 of the 8192 channels a layer (in_proj's paired x and z
# columns, conv, dt_proj, A_log, D, the rows of x_proj and out_proj) and
# 16256 of the 65024 vocabulary rows, drawn rank-locally (init_lm_rank),
# and serves the fixed batch (greedy_generate's steps: an SSM state is
# fixed-size, not paged) of 4 prompts of 512 and 16 new tokens: 2L + 1
# sums over the model axis (the embedding, each layer's x_proj and
# out_proj) and one gather of the logits a forward.  No kernel runs on
# this path: the scan is plain PyTorch, as in the reference (no Pallas
# kernel there).  (a) f32 at 2 of 64 layers against the one-process run's
# tokens; (b) bf16 at SSM_TP_BF16_LAYERS layers, every rank's tokens
# bit-equal to rank 0's; tools/tp_phase.py --arch falcon_mamba_7b runs
# (b) at all 64 layers
SSM_TP_F32_LAYERS, SSM_TP_BF16_LAYERS = 2, 4
SSM_TP_BATCH = (4, 512, 16)       # prompts, prompt length, new tokens


def ssm_tp_config(dtype: str, n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SSM_ARCH), n_layers=n_layers,
                               dtype=dtype)


def ssm_generate(model, params) -> dict:
    """``greedy_generate``'s steps on :data:`SSM_TP_BATCH`'s seeded
    prompts (prefill, then one serve step a token), timed on the host
    clock to a device sync, under :func:`tp_run`: tokens, prefill ms, ms a
    token, launches, collectives, plain-twin calls and the peak."""
    import numpy as np
    import torch
    from repro_torch.serve import build_serve_step, grow_caches
    n, S, n_new = SSM_TP_BATCH
    rng = np.random.default_rng(33)
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (
        n, S)).astype(np.int32)).cuda()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, {"tokens": tokens})
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        caches = grow_caches(model, caches, n, S + n_new)
        step, out = build_serve_step(model), [tok]
        for i in range(n_new - 1):
            tok, caches = step(params, caches, tok, S + i)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu().tolist()
        return toks, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3 / (
            n_new - 1)

    torch.cuda.reset_peak_memory_stats()
    (toks, pre_ms, tok_ms), counts, colls, plain = tp_run(run)
    return {"tokens": toks, "prefill_ms": pre_ms, "token_ms": tok_ms,
            "counts": counts, "collectives": colls, "plain": plain,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def ssm_ranks(rank, world, rec, bf16_layers: int = SSM_TP_BF16_LAYERS):
    """Phase 32 on one rank (after 31): (a) f32 at
    :data:`SSM_TP_F32_LAYERS` and (b) bf16 at ``bf16_layers`` (kept in
    ``rec``), each the model built on the ``(1, world)`` grid, the rank's
    blocks from the rank-local init (:func:`init_lm_rank`), then
    :func:`ssm_generate`; each run's init time, peak and params GB."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_moe_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_lm_rank
    t32 = time.time()
    free()
    mesh = make_moe_mesh(1, world)
    rec["ssm_b_layers"] = bf16_layers
    for tag, dtype, n_layers in (("a", "float32", SSM_TP_F32_LAYERS),
                                 ("b", "bfloat16", bf16_layers)):
        t0 = time.time()
        model = build_model(ssm_tp_config(dtype, n_layers), mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        params = init_lm_rank(model.cfg, torch.Generator(
            device="cuda").manual_seed(0), rank, world)
        torch.cuda.synchronize()
        run = {"init_s": time.perf_counter() - t1,
               "init_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "param_gb": sum(t.numel() * t.element_size()
                               for t in params.values()) / 1e9,
               "channels": params["blocks|0|ssm|D"].shape[-1],
               "in_proj_cols": params["blocks|0|ssm|in_proj"].shape[-1]}
        run.update(ssm_generate(model, params))
        del params, model
        free()
        dist.barrier(group=mesh.control)
        run["s"] = time.time() - t0
        rec[f"ssm_{tag}"] = run
    rec["p32_s"] = time.time() - t32


def ssm_references(bf16_layers: int) -> dict:
    """Phase 32's one-process references, after the ranks have exited:
    the whole model (``model.init`` from seed 0, the stream the ranks drew
    their blocks from) through :func:`ssm_generate`, f32 at
    :data:`SSM_TP_F32_LAYERS` and bf16 at ``bf16_layers``."""
    import torch
    from repro_torch.models import build_model
    out = {}
    for tag, dtype, n_layers in (("a", "float32", SSM_TP_F32_LAYERS),
                                 ("b", "bfloat16", bf16_layers)):
        t0 = time.time()
        model = build_model(ssm_tp_config(dtype, n_layers))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        out[tag] = ssm_generate(model, params)
        del params, model
        free()
        out[f"{tag}_s"] = time.time() - t0
    return out


def check_ssm_ranks(ranks, refs) -> None:
    """Phase 32's gates: (a) every rank's f32 tokens equal to the
    one-process run's; (b) every rank's bf16 tokens equal to rank 0's; in
    every run of a rank exactly 2L + 1 sums over the model axis and one
    logits gather a forward (16 forwards: the prefill and 15 steps) and no
    other collective, in every run (a rank's and the references') no
    kernel launch and no plain twin; each rank holding 2048 of the 8192
    channels a layer, ``in_proj`` its 4096 paired columns."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    M, n_new = len(ranks), SSM_TP_BATCH[2]
    L_b = ranks[0]["ssm_b_layers"]
    for tag in ("a", "b"):
        ref = refs[tag]
        check(not any(ref["counts"].values()) and ref["plain"] == 0
              and ref["collectives"] == {},
              f"phase 32 ({tag}) one process: launches {ref['counts']}, "
              f"plain {ref['plain']}, collectives {ref['collectives']}")
    for r in ranks:
        who = f"phase 32 rank {r['rank']}"
        for tag, L in (("a", SSM_TP_F32_LAYERS), ("b", L_b)):
            run = r[f"ssm_{tag}"]
            check(run["collectives"] == {"tp all-reduce": (2 * L + 1) * n_new,
                                         "tp all-gather": n_new},
                  f"{who} ({tag}): collectives {run['collectives']} in "
                  f"{n_new} forwards of {L} layers")
            check(not any(run["counts"].values()) and run["plain"] == 0,
                  f"{who} ({tag}): launches {run['counts']}, plain "
                  f"{run['plain']}")
            check(run["channels"] == cfg.d_inner // M
                  and run["in_proj_cols"] == 2 * cfg.d_inner // M,
                  f"{who} ({tag}): {run['channels']} channels, in_proj "
                  f"{run['in_proj_cols']} columns")
        check(r["ssm_a"]["tokens"] == refs["a"]["tokens"],
              f"{who} (a): the f32 tokens differ from one process's: "
              f"{r['ssm_a']['tokens']} != {refs['a']['tokens']}")
        check(r["ssm_b_layers"] == L_b and r["ssm_b"]["tokens"]
              == ranks[0]["ssm_b"]["tokens"],
              f"{who} (b): the bf16 tokens differ from rank 0's")


def print_ssm(rec, smi: str) -> None:
    """Phase 32's lines."""
    refs = rec["ssm_refs"]
    n, S, n_new = SSM_TP_BATCH
    for r in rec["ranks"]:
        for tag in ("a", "b"):
            run = r[f"ssm_{tag}"]
            L = SSM_TP_F32_LAYERS if tag == "a" else r["ssm_b_layers"]
            one = refs[tag]
            print(f"[ssm32] rank {r['rank']} ({tag}) "
                  f"{'f32' if tag == 'a' else 'bf16'} {L} layers, "
                  f"{run['channels']} channels a layer: init "
                  f"{run['init_s']:.2f} s, params {run['param_gb']:.3f} GB, "
                  f"init peak {run['init_peak_gib']:.2f} GiB, serving peak "
                  f"{run['peak_gib']:.2f} GiB; {n} × {S} prompts, prefill "
                  f"{run['prefill_ms']:.1f} ms (one process "
                  f"{one['prefill_ms']:.1f}), {run['token_ms']:.2f} ms a "
                  f"token (one process {one['token_ms']:.2f}) over "
                  f"{n_new - 1} steps; collectives {run['collectives']} "
                  f"({2 * L + 1} sums a forward); {smi}", flush=True)
    agree = ep_agreement(
        {str(i): t for i, t in enumerate(rec["ranks"][0]["ssm_b"]["tokens"])},
        {str(i): t for i, t in enumerate(refs["b"]["tokens"])})
    rec["ssm_b_agreement"] = agree
    print(f"[ssm32] (b) the four ranks' bf16 tokens against one process's "
          f"on the same {n} prompts (serving peak "
          f"{refs['b']['peak_gib']:.2f} GiB): {agree['equal_share']:.1%} of "
          f"the tokens equal, {agree['requests_equal']} rows whole, first "
          f"divergence (row, position) {agree['first_divergence']} "
          "(reported, not gated: the sums over the ranks add the partials "
          "in another order); (a) f32 every rank's tokens equal to one "
          "process's", flush=True)
    print(f"[time] phase 32 took "
          f"{statistics.median(r['p32_s'] for r in rec['ranks']):.1f} s in "
          f"the ranks (median; per rank "
          f"{[round(r['p32_s'], 1) for r in rec['ranks']]}; rank 0's (a) "
          f"{rec['ranks'][0]['ssm_a']['s']:.1f} s, (b) "
          f"{rec['ranks'][0]['ssm_b']['s']:.1f} s), its one-process "
          f"references {refs['a_s'] + refs['b_s']:.1f} s", flush=True)


# phase 33: the tree train path under tensor parallelism over phase 25's
# four ranks, in the same spawn after phase 32 (the reference's
# state_specs layout on a (2, 2) ("data", "model") grid: agents over
# data, each agent's leaves over model, build_train_step(mesh=grid)):
# qwen3_14b at full width in bf16, A = 2 agents, one a data rank, each
# split over two model ranks (20 / 4 heads, 8704 FFN columns and 75968
# vocabulary rows a rank, drawn rank-locally under state_specs), ring,
# EDM, fused, seq 128, batch 1.  (a) Step 0's loss and every gradient
# block of each rank's agent against a one-process loss and backward of
# the whole agent at the same weights (each rank draws them from the
# seed the blocks came from); (b) TP_TRAIN_STEPS steps of the multi-rank
# tree step: row 1 once a leaf a step on the rank's blocks, each launch's
# outputs bit-equal (by digest) to the plain twin's on the same inputs,
# row 8p once a step in each model column (two peer rings side by side,
# each over its 2-rank data slice), the replicated leaves bit-equal
# across a column's model ranks after every step, a column's two ranks
# bit-equal in loss.  Depth: 1 of 40 layers, the deepest at which the
# four ranks fit the card reliably here (a rank's EDM peak: x, m, ψ, the
# f32 peer payload and one vocabulary leaf's four packed f32 copies; at
# 2 layers ~18.3 GiB a rank left ~1.2 GiB of the card free after the
# earlier phases in one run and ran out in another); tools/tp_phase.py
# --train runs 2 layers alone.  The time rule (PERF.md §4) took the room
# from phases 15 and 19
TP_TRAIN_LAYERS = 1
TP_TRAIN_STEPS = 3
TP_TRAIN_AGENTS = 2
# Step 0 against one process, bf16: a TP sum adds M = 2 partials, each
# already rounded to bf16 (≤ 2⁻⁸ relative), and rounds once more, where
# the one-process product rounds once — up to (M + 1)·2⁻⁸ ≈ 2⁻⁶.4 of the
# summands' size a sum site.  The loss sees the forward's 2L + 1 sites
# (here 5) through the logits: |Δloss| ≤ 2⁻⁷·|loss| (one bf16 ulp of the
# loss's size); a gradient sees the forward's and the backward's sites
# (4L + 1 sums and the enters' sums): each leaf's ‖Δg‖ ≤ 2⁻⁴·‖g‖ (a few
# sites' worth, the rounding errors of independent sites adding in
# norm).  A missing sum is an error of the gradient's own size (the
# norms' gradients halved on each rank: ‖Δg‖ ≈ 0.7‖g‖).
TP_TRAIN_LOSS_RTOL = 2 ** -7
TP_TRAIN_GRAD_RTOL = 2 ** -4


def tp_train_config(n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TP_ARCH), n_layers=n_layers)


def tp_train_run():
    return bus_run(global_batch=TP_TRAIN_AGENTS, agents_per_device=1,
                   packed_bus=False)


def tp_train_batches(vocab: int):
    """``TP_TRAIN_STEPS`` global batches of ``(A, 1, SEQ)`` tokens, from a
    seeded numpy stream (every rank draws the same)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(33)
    return [{"tokens": torch.from_numpy(rng.integers(
        0, vocab, (TP_TRAIN_AGENTS, 1, SEQ)).astype(np.int32)).cuda()}
        for _ in range(TP_TRAIN_STEPS)]


def digest_add(acc, t, start: int) -> None:
    """Add the words of ``t`` (a chunk whose first element sits at
    ``start`` of the whole) to ``acc``, a device int64 pair:
    :func:`bus_digest`'s two sums, wrapping, with no host sync."""
    import torch
    w = t.reshape(-1).view(torch.int16 if t.element_size() == 2
                           else torch.int32).to(torch.int64)
    pos = torch.arange(start, start + w.numel(), dtype=torch.int64,
                       device=w.device)
    h = (pos * 2654435761) % (1 << 31) * 2 + 1
    acc[0] += w.sum()
    acc[1] += (w * h).sum()


def edm_twin_spy():
    """Wrap ``ops.edm_update_flat`` (row 1's wrapper) so that each launch's
    ``(m', ψ', φ)`` is held to the plain twin's on the same inputs: the
    twin runs first, ``2¹⁴`` rows at a time (the launch may write over
    its inputs), and leaves digests (:func:`bus_digest`'s sums, taken
    chunk by chunk on the card), which the launch's outputs must match.
    Returns ``(stats, restore)``; the twin launches nothing, so the
    counts are the path's."""
    import torch
    from repro_torch.kernels import ops, ref
    inner = ops.edm_update_flat
    stats = {"checked": 0, "equal": 0}

    def digests(outs, start, acc):
        for a, t in zip(acc, outs):
            digest_add(a, t, start)

    def spy(x, g, m, psi, *, alpha, beta, out=None):
        # small chunks: the launch's four packed f32 copies of a
        # vocabulary leaf are alive meanwhile, on four ranks at once
        want, got = (torch.zeros(3, 2, dtype=torch.int64, device=x.device)
                     for _ in range(2))
        rows = 1 << 14
        for r0 in range(0, x.shape[0], rows):
            sl = slice(r0, r0 + rows)
            digests(ref.edm_update_ref(x[sl], g[sl], m[sl], psi[sl],
                                       alpha=alpha, beta=beta),
                    r0 * x.shape[1], want)
        res = inner(x, g, m, psi, alpha=alpha, beta=beta, out=out)
        for r0 in range(0, x.shape[0], rows):
            digests([t[r0:r0 + rows] for t in res], r0 * x.shape[1], got)
        stats["checked"] += 1
        stats["equal"] += bool(torch.equal(got, want))
        return res

    ops.edm_update_flat = spy
    return stats, lambda: setattr(ops, "edm_update_flat", inner)


def timed_collectives():
    """Wrap ``comm.all_reduce`` / ``comm.all_gather`` so that each call's
    wall time (the device synchronised before and after: a host-staged
    collective waits on the card anyway) adds to ``ms[f"{tag} {kind}"]``.
    Returns ``(ms, restore)``."""
    import torch
    from repro_torch.core import comm
    defaults = {"all_reduce": "metrics", "all_gather": "gossip"}
    inner = {n: getattr(comm, n) for n in defaults}
    ms = {}

    def wrap(name):
        def call(*a, **k):
            tag = k.get("tag", a[3] if len(a) > 3 else defaults[name])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*a, **k)
            torch.cuda.synchronize()
            key = f"{tag} {name.replace('_', '-')}"
            ms[key] = ms.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    for name in defaults:
        setattr(comm, name, wrap(name))
    return ms, lambda: [setattr(comm, n, f) for n, f in inner.items()]


def tp_train_grads(rank, world, mesh, model, run, batch, rec) -> None:
    """Phase 33 (a) on one rank: its agent's step-0 loss and gradient
    blocks on the grid against one process's whole-agent loss and
    backward at the same weights (``init_lm`` from the seed the blocks
    were drawn from: the blocks are its cut, :func:`init_lm_rank`); the
    collectives of the TP loss."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.core.sharding import leaf_block, mesh_coords
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_lm_rank
    from repro_torch.train import trainer
    a0 = rank_block(mesh, TP_TRAIN_AGENTS)[0]
    tokens = {"tokens": batch["tokens"][a0]}
    tp_model = build_model(model.cfg, mesh=mesh)
    specs = trainer._leaf_specs(model, run)
    gen = torch.Generator(device="cuda")
    blocks = init_lm_rank(model.cfg, gen.manual_seed(0),
                          mesh.axis_index("model"), 2, specs=specs)
    blocks = {k: v.requires_grad_() for k, v in blocks.items()}
    with comm.recording() as log:
        loss = tp_model.loss(blocks, tokens, remat=run.remat)
        grads = torch.autograd.grad(loss, list(blocks.values()))
    rec["tpt_grad_collectives"] = tp_collectives(log)
    rec["tpt_loss0"] = float(loss.detach())
    grads = dict(zip(blocks, grads))
    del blocks, loss
    whole = {k: v.requires_grad_() for k, v in model.init(
        gen.manual_seed(0)).items()}
    loss = model.loss(whole, tokens, remat=run.remat)
    want = dict(zip(whole, torch.autograd.grad(loss, list(whole.values()))))
    rec["tpt_loss0_one"] = float(loss.detach())
    del whole, loss
    coords = mesh_coords(mesh)
    rel, err = {}, 0.0
    for path, g in grads.items():
        w = leaf_block(want.pop(path), specs[path], coords, path).float()
        d = g.float() - w
        rel[path] = float(d.norm() / w.norm().clamp_min(1e-30))
        err = max(err, float(d.abs().max()))
        del w, d
    rec["tpt_grad_rel"], rec["tpt_grad_max_abs"] = rel, err
    del grads, want
    free()


def tp_train_ranks(rank, world, rec, n_layers: int = TP_TRAIN_LAYERS
                   ) -> None:
    """Phase 33 on one rank (after 32): the ``(2, 2)`` grid, (a)
    :func:`tp_train_grads`, then (b) ``TP_TRAIN_STEPS`` steps from
    ``init_state(mesh=grid)`` (the rank's blocks, never the whole model)
    with the launch counts set to 0 just before and read just after,
    row 1's launches held to the plain twin (:func:`edm_twin_spy`), the
    collectives counted and timed a step, the replicated leaves' digests
    after each step (these steps' ms are instrumented); then one step
    without the twin or the timed collectives (step ms), peak and the
    transports' epochs."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_gossip_mesh
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule, trainer)
    t33 = time.time()
    free()
    # new segments grow in place (the vocabulary leaves' packed f32
    # copies come and go a leaf at a time; fixed segments left ~2.7 GiB
    # a rank reserved but unusable, and four ranks ran out of memory)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    rec["card_free_gib_33"] = torch.cuda.mem_get_info()[0] / 2**30
    mesh = make_gossip_mesh(TP_TRAIN_AGENTS, agents_per_device=1, model=2)
    rec["tpt_coords"] = list(mesh.coords)
    rec["tpt_layers"] = n_layers
    model = build_model(tp_train_config(n_layers))
    run = tp_train_run()
    batches = tp_train_batches(model.cfg.vocab_size)
    t0 = time.time()
    tp_train_grads(rank, world, mesh, model, run, batches[0], rec)
    dist.barrier(group=mesh.control)
    rec["tpt_a_s"] = time.time() - t0
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    step = build_train_step(model, run, make_gossip_schedule(
        run, TP_TRAIN_AGENTS), use_fused_kernel=True, mesh=mesh)
    state = init_state(model, run, TP_TRAIN_AGENTS, seed=0, mesh=mesh)
    rec["tpt_init_s"] = time.time() - t0
    rec["tpt_param_gb"] = sum(v.numel() * v.element_size()
                              for v in state["params"].values()) / 1e9
    hd = model.cfg.hd
    rec["tpt_heads"] = [state["params"]["blocks|0|attn|wq"].shape[-1] // hd,
                        state["params"]["blocks|0|attn|wk"].shape[-1] // hd]
    rec["tpt_leaves"] = len(state["params"])
    replicated = [p for p, s in trainer._leaf_specs(model, run).items()
                  if "model" not in s]
    stats, restore_spy = edm_twin_spy()
    ms, restore_ms = timed_collectives()
    per_step = []
    try:
        ops.reset_launch_counts()
        for b in batches:
            dist.barrier(group=mesh.control)
            ms.clear()
            t1 = time.perf_counter()
            with comm.recording() as log:
                state, m = step(state, b)
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3
            per_step.append({
                "step_ms": step_ms, "collectives": tp_collectives(log),
                "collective_ms": dict(ms),
                "agent_losses": m["agent_losses"].tolist(),
                "metrics": {k: float(m[k]) for k in ("loss", "consensus",
                                                     "grad_norm")},
                "replicated": {f"{slot}|{p}": bus_digest(tree[p])
                               for slot, tree in (("x", state["params"]),
                                                  *state["opt"].items())
                               for p in replicated}})
        rec["tpt_launches"] = {k: v for k, v in ops.launch_counts().items()
                               if v}
    finally:
        restore_spy()
        restore_ms()
    rec["tpt_steps"] = per_step
    rec["tpt_edm_checked"], rec["tpt_edm_equal"] = (stats["checked"],
                                                    stats["equal"])
    # one more step with neither the twin check nor the synchronising
    # collectives: a step's own time
    dist.barrier(group=mesh.control)
    t1 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    rec["tpt_step_ms"] = (time.perf_counter() - t1) * 1e3
    rec["tpt_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["tpt_peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    for t in step.transports():
        t.raise_on_timeout()
    rec["tpt_epochs"] = [t.epoch for t in step.transports()]
    rec["tpt_b_s"] = time.time() - t0
    del state, m
    free()
    torch.cuda.synchronize()
    dist.barrier(group=mesh.control)
    step.close()
    del step
    free()
    rec["p33_s"] = time.time() - t33


def tp_train_sums(L: int) -> int:
    """The TP loss's sums over the model axis a step at ``remat=False``:
    the embedding's and two a layer forward; the backward's, of each
    layer's two normed inputs and of ``q_norm`` / ``k_norm``, and of the
    final normed input."""
    return 1 + 2 * L + 4 * L + 1


def check_tp_train_ranks(ranks) -> None:
    """Phase 33's gates: (a) each rank's step-0 loss within
    ``TP_TRAIN_LOSS_RTOL`` and every gradient block within
    ``TP_TRAIN_GRAD_RTOL`` (norm-relative) of one process's whole-agent
    backward; the loss's sums and gather as :func:`tp_train_sums` says;
    (b) a rank's launches exactly one ``edm_update`` a leaf a step (each
    bit-equal to the plain twin) and one ``ring_peer`` a step, nothing
    else; its collectives a step the loss's sums and gather, no gossip
    collective (the peer ring carries it); every rank the same per-agent
    losses and metrics, finite; the replicated leaves' digests equal on
    a column's two model ranks after every step; one ring epoch a step
    (the uninstrumented step's too); 20 / 4 heads a rank."""
    L = ranks[0]["tpt_layers"]
    by_data = {}
    for r in ranks:
        tag = f"phase 33 rank {r['rank']}"
        by_data.setdefault(r["tpt_coords"][0], []).append(r)
        check(r["tpt_layers"] == L, f"{tag}: {r['tpt_layers']} layers")
        rel = abs(r["tpt_loss0"] - r["tpt_loss0_one"])
        check(rel <= TP_TRAIN_LOSS_RTOL * abs(r["tpt_loss0_one"]),
              f"{tag} (a): step-0 loss {r['tpt_loss0']} against one "
              f"process's {r['tpt_loss0_one']}")
        worst = max(r["tpt_grad_rel"].items(), key=lambda kv: kv[1])
        check(worst[1] <= TP_TRAIN_GRAD_RTOL, f"{tag} (a): gradient block "
              f"{worst[0]} {worst[1]:.3e} of its norm off one process's")
        check(r["tpt_grad_collectives"] == {
            "tp all-reduce": tp_train_sums(L), "tp all-gather": 1},
            f"{tag} (a): collectives {r['tpt_grad_collectives']}")
        n_leaves = r["tpt_leaves"]
        check(r["tpt_launches"] == {"edm_update": n_leaves * TP_TRAIN_STEPS,
                                    "ring_peer": TP_TRAIN_STEPS},
              f"{tag} (b): launches {r['tpt_launches']}")
        check(r["tpt_edm_checked"] == n_leaves * TP_TRAIN_STEPS
              and r["tpt_edm_equal"] == r["tpt_edm_checked"],
              f"{tag} (b): {r['tpt_edm_equal']} of {r['tpt_edm_checked']} "
              "edm_update launches bit-equal to the plain twin")
        check(r["tpt_epochs"] == [TP_TRAIN_STEPS + 1],
              f"{tag} (b): ring epochs {r['tpt_epochs']}")
        check(r["tpt_heads"] == [20, 4], f"{tag}: {r['tpt_heads']} heads")
        for t, s in enumerate(r["tpt_steps"]):
            c = s["collectives"]
            check(c.get("tp all-reduce") == tp_train_sums(L)
                  and c.get("tp all-gather") == 1
                  and not any(k.startswith("gossip") for k in c),
                  f"{tag} (b) step {t}: collectives {c}")
            check(all(math.isfinite(v) for v in s["metrics"].values()),
                  f"{tag} (b) step {t}: metrics {s['metrics']}")
            want = ranks[0]["tpt_steps"][t]
            check(s["agent_losses"] == want["agent_losses"]
                  and s["metrics"] == want["metrics"],
                  f"{tag} (b) step {t}: losses / metrics {s} differ from "
                  f"rank 0's")
    for col in by_data.values():
        check(len(col) == 2, f"phase 33: a data rank of {len(col)} ranks")
        for t, (a, b) in enumerate(zip(col[0]["tpt_steps"],
                                       col[1]["tpt_steps"])):
            check(a["replicated"] == b["replicated"], f"phase 33 step {t}: "
                  f"the replicated leaves differ between ranks "
                  f"{col[0]['rank']} and {col[1]['rank']}")


def print_tp_train(rec, smi: str) -> None:
    """Phase 33's lines."""
    for r in rec["ranks"]:
        steps = r["tpt_steps"]
        sums = [s["collective_ms"].get("tp all-reduce", 0.0)
                + s["collective_ms"].get("tp all-gather", 0.0)
                for s in steps]
        metrics_ms = [s["collective_ms"].get("metrics all-reduce", 0.0)
                      + s["collective_ms"].get("metrics all-gather", 0.0)
                      for s in steps]
        worst = max(r["tpt_grad_rel"].items(), key=lambda kv: kv[1])
        print(f"[tp33] rank {r['rank']} grid {tuple(r['tpt_coords'])} of "
              f"(2, 2), {r['tpt_layers']} layers bf16, "
              f"{r['tpt_heads'][0]} / {r['tpt_heads'][1]} heads a layer, "
              f"params {r['tpt_param_gb']:.2f} GB a rank: (a) step-0 loss "
              f"{r['tpt_loss0']:.6f} (one process {r['tpt_loss0_one']:.6f}),"
              f" worst gradient block {worst[0]} {worst[1]:.3e} of its "
              f"norm (max |Δ| {r['tpt_grad_max_abs']:.3e}); (b) step ms "
              f"{r['tpt_step_ms']:.1f} (uninstrumented); instrumented "
              f"(the twin check, synchronised collectives) "
              f"{[round(s['step_ms'], 1) for s in steps]}, of which the TP "
              f"sums and gather {[round(v, 1) for v in sums]} ms "
              f"({[f'{v / s['step_ms']:.1%}' for v, s in zip(sums, steps)]}"
              f"; {steps[0]['collectives'].get('tp all-reduce')} sums and "
              f"{steps[0]['collectives'].get('tp all-gather')} gather a "
              f"step) and the metrics' host-staged reduces "
              f"{[round(v, 1) for v in metrics_ms]} ms; losses "
              f"{[s['agent_losses'] for s in steps]}; launches "
              f"{r['tpt_launches']} ({r['tpt_edm_equal']} of "
              f"{r['tpt_edm_checked']} edm_update bit-equal to the twin); "
              f"peak {r['tpt_peak_gib']:.2f} GiB allocated, "
              f"{r['tpt_peak_reserved_gib']:.2f} reserved; card free at the "
              f"phase's start {r['card_free_gib_33']:.2f} GiB; {smi}",
              flush=True)
    print(f"[time] phase 33 took "
          f"{statistics.median(r['p33_s'] for r in rec['ranks']):.1f} s in "
          f"the ranks (median; per rank "
          f"{[round(r['p33_s'], 1) for r in rec['ranks']]}; rank 0's (a) "
          f"{rec['ranks'][0]['tpt_a_s']:.1f} s, init "
          f"{rec['ranks'][0]['tpt_init_s']:.1f} s, (b) "
          f"{rec['ranks'][0]['tpt_b_s']:.1f} s)", flush=True)


def tree_block_ranks(rank, world, batches, refs, rec):
    """Phase 30 on one rank (after 29): ``TREE_BLOCK_RUNS`` on ranks 0–1,
    ``TREE_BLOCK_B`` agents of ``smollm_360m`` each at full width, its
    depth cut to ``GRAPH_LAYERS`` (:func:`cut_model`) (ranks 2–3 outside
    the mesh), ``packed_bus=False``, fused kernels,
    eager: the rank's 12 bf16 leaves of both agents go through the peer
    table packed into one ``(2, rows, 128)`` f32 payload
    (``core/mixing.py::TreePayload``).  Each run from seed 0
    (:func:`rank_steps`, rank 0's last step profiled): its transports'
    flag waits, epochs and slot GiB, its agents' leaf digests held to its
    one-process reference (``refs``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.comm import rank_block
    from repro_torch.launch.mesh import make_gossip_mesh
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    t30 = time.time()
    free()
    rec["held_gib_30"] = torch.cuda.memory_allocated() / 2**30
    model = cut_model()
    mesh = make_gossip_mesh(world, agents_per_device=TREE_BLOCK_B)
    rec["tree_block_member"] = mesh.member
    rec["tree_block_s"] = {}
    if mesh.member:
        a0, B, _, _ = rank_block(mesh, AGENTS, None)
        for tag, (kw, steps, churn) in TREE_BLOCK_RUNS.items():
            t0 = time.time()
            key = f"tree_block_{tag}"
            run = bus_run(agents_per_device=B, **kw)
            step = build_train_step(
                model, run, make_gossip_schedule(run, AGENTS, churn=churn),
                use_fused_kernel=True, mesh=mesh)
            state = init_state(model, run, AGENTS, seed=0, mesh=mesh)
            rec[f"{key}_leaf"] = list(
                next(iter(state["params"].values())).shape[:1])
            state = rank_steps(step, state, batches[:steps], mesh, rec, key,
                               profile_last=rank == 0)
            transports = step.transports()
            for t in transports:
                t.raise_on_timeout()
            rec[f"{key}_waits"] = sum(getattr(t, "waits", 0)
                                      for t in transports)
            rec[f"{key}_epochs"] = [t.epoch for t in transports]
            rec[f"{key}_peer_gib"] = sum(
                getattr(t, "_flag_off", 0) / 2**30 for t in transports)
            want = refs[key]["digests"]
            rec[f"{key}_equal"] = all(
                rec[f"{key}_digests"][k] == want[k][a0:a0 + B] for k in want)
            del state
            free()
            torch.cuda.synchronize()
            dist.barrier(group=mesh.control)
            step.close()
            del step
            free()
            rec["tree_block_s"][tag] = time.time() - t0
    dist.barrier()
    rec["p30_s"] = time.time() - t30


def peer_rank(rank: int, world: int, batches, held, refs, out_dir):
    """Phases 25–33's rank (a spawned process; the one card for every
    rank), one agent of the main path's model each (phases 28 and 30: also
    two agents on ranks 0–1; phase 28: a pod's row shard; phase 29: a block of
    deepseek_moe_16b's experts).

    Phase 25: ring, fused kernels, ``PEER_STEPS`` steps of the multi-rank
    bus step — the peer-pointer ring kernel carries the gossip.  Its
    losses, x and ψ against the one-process run's (``held``: the parent's
    buses, shared through CUDA IPC, dropped as soon as they are compared),
    the kernel against its plain version on the final payloads (the
    neighbours' copied through the peer pointers), each rank's kernel
    timed while the others wait, the last step profiled (rank 0).

    Phase 26, once the parent has freed its phase-25 buses: (a) the
    delayed pipeline (``overlap="delayed"``) on the ring with the straggler
    plan ``OVERLAP_LATE``, ``PEER_STEPS`` steps: the peer table carries the
    gossip, the ring kernel on its slots on the steps with no late slot,
    the table kernel on the late one; (c) the table kernel on the final
    payloads (:func:`table_checks`); (b) ``GROUP_STEPS`` grouped steps of
    ``RANK_GROUPS``.  (a) and (b) against the one-process runs' per-agent
    losses and bus digests (``refs``).

    Phase 27, after 26: the tree path (``packed_bus=False``) at
    ``GRAPH_LAYERS``, each of ``TREE_RUNS`` for ``TREE_STEPS`` steps — the
    rank's leaves packed into the peer transports' f32 payload — against
    the one-process tree runs' per-agent losses, metrics and leaf digests
    (``refs``), rank 0's last step of each profiled.

    Phase 28, after 27: ``WIRE_RUNS`` (:func:`wire_ranks`).  Phase 29,
    after 28: the expert-parallel MoE served (:func:`ep_ranks`).  Phase 30,
    after 29: ``TREE_BLOCK_RUNS`` (:func:`tree_block_ranks`).  Phase 31,
    after 30: ``qwen3_14b`` tensor-parallel served (:func:`tp_ranks`).
    Phase 32, after 31: ``falcon_mamba_7b`` tensor-parallel served
    (:func:`ssm_ranks`).  Phase 33, after 32: ``qwen3_14b`` trained
    tensor-parallel on a ``(2, 2)`` grid (:func:`tp_train_ranks`).  Writes
    ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.elastic import StragglerPlan
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda", init_method=f"file://{out_dir}/store",
                     rank=rank, world_size=world, timeout_s=600)
    mesh = make_gossip_mesh(world, agents_per_device=1)
    model = build_model(get_config(ARCH))
    run = bus_run(agents_per_device=1)
    sched = make_gossip_schedule(run, world)
    step = build_train_step(model, run, sched, use_fused_kernel=True,
                            mesh=mesh)
    state = init_state(model, run, world, seed=0, mesh=mesh)
    rec = {"rank": rank, "device": str(mesh.device), "shared": mesh.shared,
           "bus": list(state["params"].shape)}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.use_deterministic_algorithms(True)
    losses, secs, prof_rows = [], [], None
    for t, b in enumerate(batches[:PEER_STEPS]):
        b = {k: v.cuda() for k, v in b.items()}
        dist.barrier(group=mesh.control)
        t0 = time.perf_counter()
        if t == PEER_STEPS - 1 and rank == 0:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, m = step(state, b)
                settle()
            prof_rows = device_rows(prof)
        else:
            state, m = step(state, b)
        losses.append(m["agent_losses"].tolist())
        rec.setdefault("loss", []).append(float(m["loss"]))
        rec.setdefault("consensus", []).append(float(m["consensus"]))
        secs.append(time.perf_counter() - t0)
    torch.use_deterministic_algorithms(False)
    rec["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    rec["step_ms"] = [round(t * 1e3, 2) for t in secs]
    rec["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    rec["agent_losses"] = losses
    want_x, want_psi = held
    rec["x_equal"] = same_bits(state["params"][0], want_x[rank])
    rec["psi_equal"] = same_bits(state["opt"]["psi"][0], want_psi[rank])
    # the parent's buses, shared through IPC: the list is the spawn's own
    # argument, so emptying it is what drops this rank's references
    held.clear()
    del want_x, want_psi
    if prof_rows is not None:
        rec["traced"] = traced_launches(prof_rows)
        rec["buckets"] = bucket(prof_rows)
        rec["busy_ms"] = sum(r[0] for r in prof_rows)
    # the kernel on the final payloads (static now: every rank is done),
    # one rank at a time: the copies and the library's stack take ~13 GB
    ring = step.peer_ring()
    terms = [(t.shift, float(t.weight)) for t in sched.rounds[0].terms]
    ring.raise_on_timeout()
    rec["epochs"] = ring.epoch
    del state, m
    free()
    for r in range(world):
        dist.barrier(group=mesh.control)
        if r != rank:
            continue
        left, right = ring.left.clone(), ring.right.clone()
        got = ops.ring_peer(ring.payload, ring.left, ring.right, terms,
                            world)
        want = ref.ring_peer_ref(ring.payload, left, right, terms, world)
        rec["bit_equal"], rec["max_abs_err"] = compare([got], [want])
        n = ring.payload.numel()
        rec["bytes"] = 4 * n * 4        # three payloads read, one written
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["bytes"], (2 * len(terms) - 1) * n)
        rec["ms"] = time_ms(lambda: ops.ring_peer(
            ring.payload, ring.left, ring.right, terms, world, out=got))
        rec["plain_ms"] = time_ms(lambda: ref.ring_peer_ref(
            ring.payload, ring.left, ring.right, terms, world))
        codes = ops.peer_operands(ring.payload, left, right, terms, world)
        stack = torch.stack([(ring.payload, left, right)[c][0]
                             for c in codes]).view(len(terms), -1)
        del left, right
        w = torch.tensor([[wt for _, wt in terms]], device=got.device)
        lib = torch.matmul(w, stack).view_as(got)
        rec["library_max_abs_diff"] = float(
            (lib - want).nan_to_num_(0.0, 0.0, 0.0).abs_().max())
        del lib, want
        rec["library_ms"] = time_ms(lambda: torch.matmul(w, stack))
        del got, stack
        free()
    torch.cuda.synchronize()
    dist.barrier(group=mesh.control)
    step.close()
    del step
    free()
    # hand over to phase 26 once the parent has dropped phase 25's buses
    Path(out_dir, f"rank{rank}.p25").write_text("done")
    freed = Path(out_dir, "p25.freed")
    t_wait = time.time()
    while not freed.exists():
        check(time.time() - t_wait < 300, "the parent did not free phase "
              "25's buses in 300 s")
        time.sleep(0.1)
    dist.barrier(group=mesh.control)
    rec["card_free_gib_26"] = torch.cuda.mem_get_info()[0] / 2**30

    # 26 (a): the delayed pipeline with a straggler across ranks
    orun = bus_run(agents_per_device=1, overlap="delayed")
    osched = make_gossip_schedule(orun, world)
    plan = StragglerPlan.from_json(OVERLAP_LATE, max(
        len(r.terms) for r in osched.rounds))
    step = build_train_step(model, orun, osched, use_fused_kernel=True,
                            mesh=mesh, straggler_plan=plan)
    state = init_state(model, orun, world, seed=0, mesh=mesh)
    state = rank_steps(step, state, batches[:PEER_STEPS], mesh, rec,
                       "overlap")
    table = step.transports()[0]
    table.raise_on_timeout()
    rec["overlap_epochs"], rec["overlap_waits"] = table.epoch, table.waits
    del state
    free()
    # 26 (c): the table kernel on the overlap's final payloads
    table_checks(table, rank, world, mesh, rec)
    torch.cuda.synchronize()
    dist.barrier(group=mesh.control)
    step.close()
    del step, table
    free()
    # 26 (b): policy groups across ranks
    grun = bus_run(agents_per_device=1, gossip_groups=RANK_GROUPS)
    step = build_train_step(model, grun, make_gossip_schedule(grun, world),
                            use_fused_kernel=True, mesh=mesh)
    state = init_state(model, grun, world, seed=0, mesh=mesh)
    state = rank_steps(step, state, batches[:GROUP_STEPS], mesh, rec,
                       "groups")
    rec["groups_waits"] = sum(getattr(t, "waits", 0)
                              for t in step.transports())
    for t in step.transports():
        t.raise_on_timeout()
    del state
    free()
    torch.cuda.synchronize()
    dist.barrier(group=mesh.control)
    step.close()
    del step
    free()

    # 27: the tree path across ranks, (a) EDM on the ring, (b) DSGT on
    # round_robin over exp
    t27 = time.time()
    cut = cut_model()
    for tag, kw in TREE_RUNS.items():
        trun = bus_run(agents_per_device=1, **kw)
        step = build_train_step(cut, trun, make_gossip_schedule(trun, world),
                                use_fused_kernel=True, mesh=mesh)
        state = init_state(cut, trun, world, seed=0, mesh=mesh)
        state = rank_steps(step, state, batches[:TREE_STEPS], mesh, rec,
                           f"tree_{tag}", profile_last=rank == 0)
        rec[f"tree_{tag}_waits"] = sum(getattr(t, "waits", 0)
                                       for t in step.transports())
        rec[f"tree_{tag}_epochs"] = [t.epoch for t in step.transports()]
        for t in step.transports():
            t.raise_on_timeout()
        del state
        free()
        torch.cuda.synchronize()
        dist.barrier(group=mesh.control)
        step.close()
        del step
        free()
    rec["tree_s"] = time.time() - t27
    rec["tree_leaves"] = len(model.meta())
    del cut

    # 28: the wires, agent blocks and row shards across ranks
    wire_ranks(rank, world, model, batches, refs, mesh, rec)
    # 29: deepseek_moe_16b expert-parallel across the ranks
    del model
    ep_ranks(rank, world, refs["ep"], rec)
    # 30: the tree of two agents a rank through the peer table
    tree_block_ranks(rank, world, batches, refs, rec)
    # 31: qwen3_14b tensor-parallel across the ranks
    tp_ranks(rank, world, rec)
    # 32: falcon_mamba_7b tensor-parallel across the ranks
    ssm_ranks(rank, world, rec)
    # 33: qwen3_14b trained on the tree path, tensor-parallel on (2, 2)
    tp_train_ranks(rank, world, rec)
    for tag in ("overlap", "groups", "tree_edm", "tree_dsgt"):
        rec[f"{tag}_equal"] = all(
            rec[f"{tag}_digests"][k] == [refs[tag]["digests"][k][rank]]
            for k in refs[tag]["digests"])
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def peer_phase():
    """Phases 25–33: ``PEER_RANKS`` ranks on the one card, each one agent
    of ``smollm_360m`` at full width and depth (bus ``(1, 3195392, 128)``
    a rank, or its 12 bf16 tree leaves), fused kernels, seq 128, per-agent
    batch 1, α 0.2, β 0.9, spawned once for the nine phases.

    Phase 25: ``PEER_STEPS`` steps of the multi-rank bus step on the ring;
    the gossip runs through the peer-pointer ring kernel (CUDA IPC).
    Gates: per-agent losses and the final x and ψ bit-equal to the
    one-process eager run; the kernel bit-equal to its plain version on
    every rank; no flag wait timed out; one ring launch a rank a step, no
    one-card ring or combine launch, and the traced step holds no roll.

    Phase 26: (a) ``PEER_STEPS`` steps of the delayed pipeline on the
    ring with slot 1 late at step 1, (b) ``GROUP_STEPS`` steps of the
    ``RANK_GROUPS`` policy.  Gates: per-agent losses and the digests of x,
    m, ψ (and the pipeline's live slot) bit-equal to the one-process eager
    runs'; (a) 2 ring and 1 table launches a rank, the peer publish before
    each step's forward and backward pass and the combine after; (b) 5
    ring launches (attention every step, the rest's offset-1 round) and 1
    table launch (its offset-2 round) a rank, none for the embeddings; (c)
    the table kernel bit-equal to its plain version on every rank's final
    payloads for each of ``TABLE_CASES`` (the late round's output finite
    where rank 0's late payload is not read); no flag wait timed out.
    Phase 27: the tree path at ``GRAPH_LAYERS``, (a) ``TREE_STEPS`` EDM
    steps on the ring,
    (b) ``TREE_STEPS`` DSGT steps on ``round_robin`` over ``exp``.  Gates:
    per-agent losses and the digests of every leaf of x and of every
    optimizer slot bit-equal to one-process 4-agent fused eager tree runs;
    consensus and gradient norm within rtol 1e-5 of them; launches a rank
    a step (a) 12 EDM + 1 ring, (b) 2 ring at step 0 and 2 table at step
    1; rank 0's profiled last step of each holds no roll; no flag wait
    timed out.
    Phase 28: ``WIRE_RUNS``, each against its one-process run
    (:func:`wire_references`), gated by :func:`check_wire_ranks`.
    Phase 29: ``deepseek_moe_16b``'s experts split over the ranks, served
    (:func:`ep_ranks`; (a)'s references :func:`ep_references`), gated by
    :func:`check_ep_ranks`.
    Phase 30: ``TREE_BLOCK_RUNS`` on ranks 0–1 × ``TREE_BLOCK_B`` agents,
    each against a one-process 4-agent tree run, gated by
    :func:`check_tree_block_ranks`.
    Phase 31: ``qwen3_14b`` tensor-parallel over the ranks
    (:func:`tp_ranks`), its one-process references made once the ranks
    have exited (:func:`tp_references`), gated by :func:`check_tp_ranks`.
    Phase 32: ``falcon_mamba_7b`` tensor-parallel over the ranks
    (:func:`ssm_ranks`), its references so (:func:`ssm_references`),
    gated by :func:`check_ssm_ranks`.
    Phase 33: ``qwen3_14b`` trained on the tree path tensor-parallel on a
    ``(2, 2)`` grid (:func:`tp_train_ranks`; each rank's one-process
    reference of step 0 in the rank), gated by
    :func:`check_tp_train_ranks`.
    The split plan is not run here (one card; the CPU tests hold it over
    gloo); the NCCL path has run nowhere."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.core.elastic import StragglerPlan
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import make_gossip_schedule
    free()
    model = build_model(get_config(ARCH))
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                       n_agents=AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(7)
    batches = [{k: v.cpu() for k, v in data.sample(dgen, 1).items()}
               for _ in range(max(PEER_STEPS, GROUP_STEPS))]
    t0 = time.time()
    orun = bus_run(overlap="delayed")
    plan = StragglerPlan.from_json(OVERLAP_LATE, max(
        len(r.terms) for r in make_gossip_schedule(orun, AGENTS).rounds))
    refs = {"overlap": one_process_run(model, orun, batches[:PEER_STEPS],
                                       plan, digests=True),
            "groups": one_process_run(
                model, bus_run(gossip_groups=RANK_GROUPS),
                batches[:GROUP_STEPS], digests=True)}
    out = {"reference26_s": time.time() - t0}
    # phase 27's references: one-process 4-agent fused eager tree runs at
    # GRAPH_LAYERS
    t0 = time.time()
    cut = cut_model()
    for tag, kw in TREE_RUNS.items():
        refs[f"tree_{tag}"] = one_process_run(cut, bus_run(**kw),
                                              batches[:TREE_STEPS],
                                              digests=True)
    del cut
    out["reference27_s"] = time.time() - t0
    # phase 28's references: one-process runs of each WIRE_RUNS' agents
    t0 = time.time()
    refs.update(wire_references(model, batches))
    out["reference28_s"] = time.time() - t0
    # phase 30's references: one-process 4-agent fused eager tree runs at
    # GRAPH_LAYERS
    t0 = time.time()
    cut = cut_model()
    for tag, (kw, steps, churn) in TREE_BLOCK_RUNS.items():
        refs[f"tree_block_{tag}"] = one_process_run(
            cut, bus_run(**kw), batches[:steps], digests=True, churn=churn)
    del cut
    out["reference30_s"] = time.time() - t0
    out["references"] = {k: {"step_ms": [round(t * 1e3, 2)
                                         for t in v["seconds"]],
                             "launches": v["launches"],
                             "step_launches": v["step_launches"],
                             "metrics": v["metrics"],
                             "peak_allocated_gib": v["peak_allocated_gib"]}
                         for k, v in refs.items()}
    # phase 29's references: the one-process f32 engine's tokens, and (b)'s
    # bf16 engine at the cut depth
    t0 = time.time()
    refs["ep"] = ep_references()
    out["ep_b_one_process"] = refs["ep"]["b"]
    out["reference29_s"] = time.time() - t0
    t0 = time.time()
    refrun = one_process_run(model, bus_run(), batches[:PEER_STEPS])
    out.update(reference_s=time.time() - t0,
               reference_step_ms=[round(t * 1e3, 2)
                                  for t in refrun["seconds"]])
    del model
    free()
    shutil.rmtree(PEER_STORE, ignore_errors=True)
    PEER_STORE.mkdir(parents=True)
    held = [refrun.pop("x"), refrun.pop("psi")]
    t0 = time.time()
    ctx = mp.spawn(peer_rank, args=(PEER_RANKS, batches, held, refs,
                                    str(PEER_STORE)),
                   nprocs=PEER_RANKS, join=False)
    handed = False
    while not ctx.join(timeout=0.5):
        if not handed and all((PEER_STORE / f"rank{r}.p25").exists()
                              for r in range(PEER_RANKS)):
            # every rank compared and dropped its views: free the buses
            held.clear()
            torch.cuda.ipc_collect()
            free()
            out["parent_reserved_gib_26"] = (torch.cuda.memory_reserved()
                                             / 2**30)
            out["ranks25_s"] = time.time() - t0
            (PEER_STORE / "p25.freed").write_text("freed")
            handed = True
    out["ranks_s"] = time.time() - t0
    ranks = [json.loads((PEER_STORE / f"rank{r}.json").read_text())
             for r in range(PEER_RANKS)]
    out["ranks"] = ranks
    want_losses = refrun["losses"]
    for r in ranks:
        tag = f"peer rank {r['rank']}"
        check(r["agent_losses"] == want_losses, f"{tag}: per-agent losses "
              f"{r['agent_losses']} != the one-process run's {want_losses}")
        check(r["x_equal"] and r["psi_equal"], f"{tag}: final x / ψ differ "
              "from the one-process run's")
        check(r["bit_equal"], f"{tag}: the peer ring kernel differs from "
              f"its plain version (max |err| {r['max_abs_err']})")
        check(r["launches"] == {"edm_update": PEER_STEPS,
                                "ring_peer": PEER_STEPS},
              f"{tag}: launches {r['launches']}, expected {PEER_STEPS} "
              "edm_update and ring_peer")
        check(r["epochs"] == PEER_STEPS, f"{tag}: {r['epochs']} ring epochs")
        check(r["shared"], f"{tag}: the ranks do not share the card")
        # phase 26
        for what in ("overlap", "groups"):
            check(r[f"{what}_agent_losses"] == refs[what]["losses"],
                  f"{tag}: {what} per-agent losses "
                  f"{r[f'{what}_agent_losses']} != the one-process run's "
                  f"{refs[what]['losses']}")
            check(r[f"{what}_equal"], f"{tag}: {what} final buses differ "
                  f"from the one-process run's ({r[f'{what}_digests']})")
        check(r["overlap_launches"] == {"edm_update": PEER_STEPS,
                                        "ring_peer": PEER_STEPS - 1,
                                        "table_peer": 1},
              f"{tag}: overlap launches {r['overlap_launches']}")
        check(all(m == ["peer publish", "backward", "backward done",
                        "peer combine"] for m in r["overlap_marks"]),
              f"{tag}: overlap step order {r['overlap_marks']}")
        check(r["overlap_epochs"] == PEER_STEPS,
              f"{tag}: {r['overlap_epochs']} table epochs")
        check(r["groups_launches"] == {"edm_update": GROUP_STEPS,
                                       "ring_peer": GROUP_STEPS + 1,
                                       "table_peer": 1},
              f"{tag}: groups launches {r['groups_launches']}")
        for case, c in r["table_cases"].items():
            check(c["bit_equal"], f"{tag}: the peer table kernel differs "
                  f"from its plain version on the {case} round "
                  f"(max |err| {c['max_abs_err']})")
        check(r["rank"] == 0 or r["table_cases"]["late"]["finite"],
              f"{tag}: the late round's output is not finite")
        # phase 27: the tree path across ranks
        L = r["tree_leaves"]
        want_launches = {"edm": [{"edm_update": L, "ring_peer": 1}]
                         * TREE_STEPS,
                         "dsgt": [{"ring_peer": 2}, {"table_peer": 2}]}
        for what in TREE_RUNS:
            key, ref27 = f"tree_{what}", refs[f"tree_{what}"]
            check(r[f"{key}_agent_losses"] == ref27["losses"],
                  f"{tag}: tree {what} per-agent losses "
                  f"{r[f'{key}_agent_losses']} != the one-process run's "
                  f"{ref27['losses']}")
            check(r[f"{key}_equal"], f"{tag}: tree {what} final leaves "
                  "differ from the one-process run's")
            for t, (got, want) in enumerate(zip(r[f"{key}_metrics"],
                                                ref27["metrics"])):
                for k in ("consensus", "grad_norm"):
                    check(math.isclose(got[k], want[k], rel_tol=1e-5),
                          f"{tag}: tree {what} step {t} {k} {got[k]} vs "
                          f"the one-process run's {want[k]}")
            check(r[f"{key}_step_launches"] == want_launches[what],
                  f"{tag}: tree {what} launches a step "
                  f"{r[f'{key}_step_launches']}, expected "
                  f"{want_launches[what]}")
        # the peer ring's and the peer table's epochs: (a) one mix a step,
        # (b) two mixes (y and x) on each of its two rounds
        check(r["tree_edm_epochs"] == [TREE_STEPS]
              and r["tree_dsgt_epochs"] == [2, 2],
              f"{tag}: tree transport epochs {r['tree_edm_epochs']}, "
              f"{r['tree_dsgt_epochs']}")
    for what in TREE_RUNS:
        key = f"tree_{what}"
        traced = {k: v for k, v in ranks[0][f"{key}_traced"].items() if v}
        check(traced == ranks[0][f"{key}_step_launches"][-1],
              f"peer rank 0's traced tree {what} step holds {traced}, its "
              f"wrappers counted {ranks[0][f'{key}_step_launches'][-1]}")
        check(ranks[0][f"{key}_roll_ms"] == 0,
              f"peer rank 0's traced tree {what} step rolls: "
              f"{ranks[0][f'{key}_roll_ms']} ms")
    tr = ranks[0]["traced"]
    check(tr["ring_peer"] == 1 and tr["edm_update"] == 1
          and tr["ring_combine"] == 0 and tr["gossip_axpy"] == 0
          and ranks[0]["buckets"]["roll (gossip terms)"] == 0,
          f"peer rank 0's traced step: {tr}, roll bucket "
          f"{ranks[0]['buckets']['roll (gossip terms)']}")
    check_wire_ranks(ranks, refs)
    check_ep_ranks(ranks, refs["ep"]["b"])
    check_tree_block_ranks(ranks, refs)
    # phase 31's one-process references, now that the ranks' shards are
    # freed (the whole bf16 model takes 29.5 GB)
    out["tp_refs"] = tp_references(ranks[0]["tp_b_layers"])
    check_tp_ranks(ranks, out["tp_refs"])
    # phase 32's, the same way
    out["ssm_refs"] = ssm_references(ranks[0]["ssm_b_layers"])
    check_ssm_ranks(ranks, out["ssm_refs"])
    check_tp_train_ranks(ranks)
    return out


def ep_b_sums(L: int) -> int:
    """Phase 29 (b)'s sums over the model axis a forward: the embedding's,
    and each layer's after ``wo`` and after its MoE layer (the routed and
    shared partials in one)."""
    return 2 * L + 1


def check_ep_ranks(ranks, ref_b) -> None:
    """Phase 29's gates: (a) every rank's f32 tokens equal to the
    one-process engine's at both capacities, one sum over the model axis
    a MoE layer call (two calls a mixed dispatch) and no other
    collective; (b) every rank's bf16 tokens equal to rank 0's, 2L + 1
    sums and one logits gather a forward (a mixed dispatch: two forwards)
    and no other collective, no plain twin, the rank holding 16 of the 64
    experts, 4 / 4 heads and 1/4 of the shared experts' columns a layer,
    the timed dispatches' sums 2 (2L + 1) and 2L + 1; in each run (and in
    ``ref_b``'s one-process engine) the paged kernels launched once a
    layer a dispatch (the prefill once a layer a mixed one) and no other
    kernel, every request served."""
    for r in ranks:
        tag = f"phase 29 rank {r['rank']}"
        for cf in EP_F32_CFS:
            what, run = f"(a) f32 capacity {cf}", r[f"ep_a_{cf}"]
            m = run["metrics"]
            check_serve_counts(run["counts"], m, EP_F32_LAYERS,
                               f"{tag} {what}")
            check(run["sums"] == EP_F32_LAYERS * (m["steps"]
                                                  + m["mixed_steps"]),
                  f"{tag} {what}: {run['sums']} sums over the model axis in "
                  f"{m['steps']} dispatches ({m['mixed_steps']} mixed) of "
                  f"{EP_F32_LAYERS} MoE layers")
            check(run["other"] == [], f"{tag} {what}: other collectives "
                  f"{run['other']}")
            check(m["requests"] == EP_A.n, f"{tag} {what}: {m['requests']} "
                  f"of {EP_A.n} requests served")
            check(run["equal"], f"{tag} (a): the f32 tokens at capacity {cf} "
                  "differ from the one-process engine's: "
                  f"{run['tokens']}")
    check_ep_b_ranks(ranks, ref_b)


def check_ep_b_ranks(ranks, ref_b) -> None:
    """Phase 29 (b)'s gates (see :func:`check_ep_ranks`)."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    n_layers = ranks[0]["ep_b_layers"]
    want_b = ranks[0]["ep_b"]["tokens"]
    check_serve_counts(ref_b["counts"], ref_b["metrics"], n_layers,
                       "phase 29 (b) one process")
    check(ref_b["plain"] == 0, f"phase 29 (b) one process: "
          f"{ref_b['plain']} plain attention calls")
    for r in ranks:
        tag = f"phase 29 rank {r['rank']}"
        b = r["ep_b"]
        m = b["metrics"]
        check_serve_counts(b["counts"], m, n_layers, f"{tag} (b) bf16")
        check(b["plain"] == 0, f"{tag} (b): {b['plain']} plain attention "
              "calls")
        n = m["steps"] + m["mixed_steps"]
        check(b["collectives"] == {"tp all-reduce": ep_b_sums(n_layers) * n,
                                   "tp all-gather": n},
              f"{tag} (b): collectives {b['collectives']} in {m['steps']} "
              f"dispatches ({m['mixed_steps']} mixed) of {n_layers} layers")
        check(m["requests"] == EP_B.n, f"{tag} (b): {m['requests']} of "
              f"{EP_B.n} requests served")
        check(r["ep_b_layers"] == n_layers, f"{tag} (b): "
              f"{r['ep_b_layers']} layers, rank 0 {n_layers}")
        check(b["tokens"] == want_b, f"{tag} (b): the bf16 tokens differ "
              "from rank 0's")
        M = len(ranks)
        check(r["ep_experts"] == cfg.n_experts // M
              and r["ep_heads"] == [cfg.n_heads // M, cfg.n_kv_heads // M]
              and r["ep_shared_cols"] == cfg.n_shared_experts * cfg.d_ff // M,
              f"{tag}: {r['ep_experts']} experts, {r['ep_heads']} heads, "
              f"{r['ep_shared_cols']} shared-expert columns a layer")
        d = r["ep_b_dispatches"]
        s = ep_b_sums(n_layers)
        check(d["mixed"]["sums"] == 2 * s and d["decode"]["sums"] == s,
              f"{tag}: timed dispatches' sums {d}")


def print_ep(rec, smi: str) -> None:
    """Phase 29's lines."""
    for r in rec["ranks"]:
        a = {cf: r[f"ep_a_{cf}"] for cf in EP_F32_CFS}
        print(f"[ep29] rank {r['rank']} (a) EP-only f32 {EP_F32_LAYERS} "
              "layers: " + "; ".join(
                  f"capacity {cf}: {v['metrics']['tokens']} tokens in "
                  f"{v['metrics']['steps']} dispatches "
                  f"({v['metrics']['mixed_steps']} mixed), launches "
                  f"{ {k: n for k, n in v['counts'].items() if n} }, sums "
                  f"{v['sums']}, equal to the one-process engine "
                  f"{v['equal']}" for cf, v in a.items()), flush=True)
    print_ep_b(rec, smi)
    r0 = rec["ranks"][0]
    print(f"[time] phase 29 took "
          f"{statistics.median(r['p29_s'] for r in rec['ranks']):.1f} s in "
          f"the ranks (median; per rank "
          f"{[round(r['p29_s'], 1) for r in rec['ranks']]}; rank 0's (a) "
          f"{r0['ep_a_s']:.1f} s, (b)'s run {r0['ep_b_s']:.1f} s), its "
          f"one-process references {rec['reference29_s']:.1f} s; every "
          "rank's tokens equal (bf16: bit-equal to rank 0's)", flush=True)


def print_ep_b(rec, smi: str) -> None:
    """Phase 29 (b)'s lines: each rank's run, and its tokens against
    ``rec["ep_b_one_process"]``'s."""
    for r in rec["ranks"]:
        b, dd = r["ep_b"], r["ep_b_dispatches"]
        m = b["metrics"]
        L = r["ep_b_layers"]
        print(f"[ep29] rank {r['rank']} (b) EP + TP bf16 {L} layers, "
              f"{r['ep_experts']} experts, {r['ep_heads'][0]} / "
              f"{r['ep_heads'][1]} heads, {r['ep_shared_cols']} shared-expert"
              f" columns a layer: init {r['ep_init_s']:.2f} s, params "
              f"{r['ep_param_gb']:.2f} GB, init peak "
              f"{r['ep_init_peak_gib']:.2f} GiB, serving peak "
              f"{b['peak_gib']:.2f} GiB (pools {b['pool_gb']:.3f} GB); "
              f"{m['tokens']} tokens over {m['requests']} requests in "
              f"{m['steps']} dispatches ({m['mixed_steps']} mixed), "
              f"{m['tokens_per_s']} tokens/s (one process "
              f"{rec['ep_b_one_process']['metrics']['tokens_per_s']}), wall "
              f"{m['wall_s']} s, TTFT p50 {m['ttft_p50_ms']} ms, per-token "
              f"p50 {m['p50_ms']} / p99 {m['p99_ms']} ms; launches "
              f"{ {k: n for k, n in b['counts'].items() if n} }, collectives "
              f"{b['collectives']} ({ep_b_sums(L)} sums a forward); a mixed "
              f"dispatch {dd['mixed']['ms']:.1f} ms of which "
              f"{dd['mixed']['sums']} sums {dd['mixed']['sums_ms']:.1f} ms "
              f"({dd['mixed']['sums_share']:.1%}), a decode-only "
              f"{dd['decode']['ms']:.1f} ms of which {dd['decode']['sums']} "
              f"sums {dd['decode']['sums_ms']:.1f} ms "
              f"({dd['decode']['sums_share']:.1%}); card free at the phase's "
              f"start {r['card_free_gib_29']:.2f} GiB; {smi}", flush=True)
    one = rec["ep_b_one_process"]
    agree = ep_agreement(rec["ranks"][0]["ep_b"]["tokens"], one["tokens"])
    rec["ep_b_agreement"] = agree
    print(f"[ep29] (b) the four ranks' bf16 tokens against the one-process "
          f"engine's on the same {agree['requests']} requests ({one['s']:.1f}"
          f" s, {one['metrics']['tokens_per_s']} tokens/s, serving peak "
          f"{one['peak_gib']:.2f} GiB): "
          f"{agree['equal_share']:.1%} of the tokens equal, "
          f"{agree['requests_equal']} requests whole, first divergence "
          f"(request, position) {agree['first_divergence']} (reported, not "
          "gated: the sums over the ranks add the partials in another "
          "order)", flush=True)


def check_tree_block_ranks(ranks, refs) -> None:
    """Phase 30's gates: ranks 0–1 the mesh's members; for each of
    ``TREE_BLOCK_RUNS`` every member's per-agent losses and its agents'
    digests of every leaf of x and of every optimizer slot equal to the
    one-process run's, consensus and gradient norm within rtol 1e-5 of it
    (the cross-rank sums run in another order); launches a rank a step
    exactly (a) L ``edm_update`` + 1 ``table_peer``, (b) 2 ``table_peer``
    and no ``edm_update``; one table epoch a mix; no permute and no
    gossip collective (the recorder); rank 0's profiled last step holding
    what its counters say, no roll.  (A flag wait that timed out raised
    in the rank.)"""
    members = [r for r in ranks if r["tree_block_member"]]
    check([r["rank"] for r in members]
          == list(range(AGENTS // TREE_BLOCK_B)),
          f"phase 30: member ranks {[r['rank'] for r in members]}")
    for r in members:
        L = r["tree_leaves"]
        for what, (_, steps, _) in TREE_BLOCK_RUNS.items():
            key, ref30 = f"tree_block_{what}", refs[f"tree_block_{what}"]
            tag = f"phase 30 rank {r['rank']} {what}"
            want_launches = ([{"edm_update": L, "table_peer": 1}] * steps
                             if what == "edm" else [{"table_peer": 2}] * steps)
            check(r[f"{key}_leaf"] == [TREE_BLOCK_B],
                  f"{tag}: a leaf's agents {r[f'{key}_leaf']}")
            check(r[f"{key}_agent_losses"] == ref30["losses"],
                  f"{tag}: per-agent losses {r[f'{key}_agent_losses']} != "
                  f"the one-process run's {ref30['losses']}")
            check(r[f"{key}_equal"], f"{tag}: final leaves differ from the "
                  "one-process run's")
            for t, (got, want) in enumerate(zip(r[f"{key}_metrics"],
                                                ref30["metrics"])):
                for k in ("consensus", "grad_norm"):
                    check(math.isclose(got[k], want[k], rel_tol=1e-5),
                          f"{tag} step {t} {k} {got[k]} vs the one-process "
                          f"run's {want[k]}")
            check(r[f"{key}_step_launches"] == want_launches,
                  f"{tag}: launches a step {r[f'{key}_step_launches']}, "
                  f"expected {want_launches}")
            mixes = sum(n.get("table_peer", 0) for n in want_launches)
            check(r[f"{key}_epochs"] == [mixes],
                  f"{tag}: table epochs {r[f'{key}_epochs']}, expected "
                  f"[{mixes}]")
            check(not any(k.startswith("collective-permute") or
                          k.endswith(" gossip")
                          for c in r[f"{key}_collectives"] for k in c),
                  f"{tag}: the recorder holds gossip collectives "
                  f"{r[f'{key}_collectives']}")
    r0 = ranks[0]
    for what in TREE_BLOCK_RUNS:
        key = f"tree_block_{what}"
        traced = {k: v for k, v in r0[f"{key}_traced"].items() if v}
        check(traced == r0[f"{key}_step_launches"][-1],
              f"phase 30 rank 0's traced {what} step holds {traced}, its "
              f"wrappers counted {r0[f'{key}_step_launches'][-1]}")
        check(r0[f"{key}_roll_ms"] == 0,
              f"phase 30 rank 0's traced {what} step rolls: "
              f"{r0[f'{key}_roll_ms']} ms")


def print_tree_block(rec, smi: str) -> None:
    """Phase 30's lines."""
    for r in rec["ranks"]:
        if not r["tree_block_member"]:
            continue
        for what in TREE_BLOCK_RUNS:
            key = f"tree_block_{what}"
            print(f"[peer30] rank {r['rank']} tree {what}, "
                  f"{TREE_BLOCK_B} agents a rank: step ms "
                  f"{r[f'{key}_step_ms']}, loss {r[f'{key}_loss']}, "
                  f"metrics {r[f'{key}_metrics']}, launches a step "
                  f"{r[f'{key}_step_launches']}, collectives a step "
                  f"{r[f'{key}_collectives']}, torch peak "
                  f"{r[f'{key}_peak_allocated_gib']:.2f} / "
                  f"{r[f'{key}_peak_reserved_gib']:.2f} GiB (peer slots "
                  f"{r[f'{key}_peer_gib']:.2f} GiB outside it), table "
                  f"epochs {r[f'{key}_epochs']}, flag waits "
                  f"{r[f'{key}_waits']} (none timed out), bit-equal to the "
                  f"one-process run {r[f'{key}_equal']}; {smi}", flush=True)
    for what in TREE_BLOCK_RUNS:
        key = f"tree_block_{what}"
        ref = rec["references"][key]
        r0 = rec["ranks"][0]
        print(f"[peer30] tree {what}: the one-process 4-agent run step ms "
              f"{ref['step_ms']} launches {ref['launches']} peak "
              f"{ref['peak_allocated_gib']:.2f} GiB metrics {ref['metrics']};"
              f" rank 0's profiled last step traced "
              f"{json.dumps({k: v for k, v in r0[f'{key}_traced'].items() if v})}"
              f", roll {r0[f'{key}_roll_ms']} ms", flush=True)
    print(f"[time] phase 30 took "
          f"{statistics.median(r['p30_s'] for r in rec['ranks']):.1f} s in "
          f"the ranks (median; per rank "
          f"{[round(r['p30_s'], 1) for r in rec['ranks']]}; rank 0's runs "
          f"{ {k: round(v, 1) for k, v in rec['ranks'][0]['tree_block_s'].items()} }"
          f"; held at its start "
          f"{[round(r['held_gib_30'], 2) for r in rec['ranks']]} GiB), its "
          f"one-process references {rec['reference30_s']:.1f} s", flush=True)


def ep_agreement(ranks_tokens: dict, one_tokens: dict) -> dict:
    """A bf16 run's tokens across ranks (phase 29 (b), phase 31 (b))
    against the one-process engine's on the same requests: the share of
    generated tokens equal position by position, the requests equal
    whole, and the first divergence (request, position).  Reported, not
    gated: the ranks' sums add the partials in another order than the
    one-process product."""
    n = same = whole = 0
    first = None
    for rid in sorted(one_tokens, key=int):
        got, want = ranks_tokens[rid], one_tokens[rid]
        eq = [g == w for g, w in zip(got, want)]
        n += len(want)
        same += sum(eq)
        whole += got == want
        if first is None and got != want:
            first = [int(rid), eq.index(False) if False in eq else len(eq)]
    return {"equal_share": same / n, "requests_equal": whole,
            "requests": len(one_tokens), "first_divergence": first}


def check_wire_ranks(ranks, refs) -> None:
    """Phase 28's gates: every member rank of each run's per-agent losses
    and digests equal to its one-process reference's; its launches a step
    ``WIRE_LAUNCHES`` — the reference's step with each one-card combine
    replaced by exactly one peer combine; rank 0's profiled last step
    holding what its counters say, no roll; every form's kernel bit-equal
    to its plain version on every round, a late round finite on the ranks
    that do not read rank 0's poisoned payload.  (A flag wait that timed
    out raised in the rank.)"""
    for tag, wr in WIRE_RUNS.items():
        ref28 = refs[tag]
        members = [r for r in ranks if r[f"{tag}_member"]]
        n = AGENTS // wr.B if wr.S == 1 else POD_AGENTS * wr.S
        check(len(members) == n, f"{tag}: {len(members)} member ranks, "
              f"expected {n}")
        for r in members:
            t = f"peer rank {r['rank']} {tag}"
            check(r[f"{tag}_agent_losses"] == ref28["losses"],
                  f"{t}: per-agent losses {r[f'{tag}_agent_losses']} != the "
                  f"one-process run's {ref28['losses']}")
            check(r[f"{tag}_equal"], f"{t}: final buffers differ from the "
                  f"one-process run's ({r[f'{tag}_digests']})")
            check(r[f"{tag}_step_launches"] == WIRE_LAUNCHES[tag],
                  f"{t}: launches a step {r[f'{tag}_step_launches']}, "
                  f"expected {WIRE_LAUNCHES[tag]}")
            for got, want in zip(r[f"{tag}_step_launches"],
                                 ref28["step_launches"]):
                check({k: v for k, v in got.items()
                       if k not in PEER_COMBINES}
                      == {k: v for k, v in want.items() if k not in ONE_CARD}
                      and sum(got.get(k, 0) for k in PEER_COMBINES)
                      == sum(want.get(k, 0) for k in ONE_CARD),
                      f"{t}: a step's launches {got} are not the one-process "
                      f"step's {want} with each one-card combine replaced by "
                      "one peer combine")
        r0 = ranks[0]
        traced = {k: v for k, v in r0[f"{tag}_traced"].items() if v}
        check(traced == r0[f"{tag}_step_launches"][-1],
              f"peer rank 0's traced {tag} step holds {traced}, its wrappers "
              f"counted {r0[f'{tag}_step_launches'][-1]}")
        check(r0[f"{tag}_roll_ms"] == 0,
              f"peer rank 0's traced {tag} step rolls: "
              f"{r0[f'{tag}_roll_ms']} ms")
    for r in ranks:
        for form, fr in r.get("forms", {}).items():
            for case, c in fr["cases"].items():
                check(c["bit_equal"], f"peer rank {r['rank']}: the {form} "
                      f"peer kernel differs from its plain version on the "
                      f"{case} round (max |err| {c['max_abs_err']})")
            check(r["rank"] == 0 or fr["cases"]["late"]["finite"],
                  f"peer rank {r['rank']}: the {form} late round's output is "
                  "not finite")


def print_peer(rec, smi: str) -> None:
    """Phases 25–27's lines."""
    for r in rec["ranks"]:
        print(f"[peer] rank {r['rank']} on {r['device']} (shared card "
              f"{r['shared']}), bus {r['bus']}: step ms {r['step_ms']}, "
              f"loss {r['loss']}, consensus {r['consensus']}, launches "
              f"{r['launches']}, peak {r['peak_allocated_gib']:.2f} / "
              f"{r['peak_reserved_gib']:.2f} GiB; ring_peer {r['ms']:.4f} "
              f"ms (plain {r['plain_ms']:.3f}, library "
              f"{r['library_ms']:.3f}, bound {r['bound_ms']:.4f} ms "
              f"{r['bound_by']}), bit-equal {r['bit_equal']}; {smi}",
              flush=True)
    r0 = rec["ranks"][0]
    print(f"[peer] {PEER_RANKS} ranks × {PEER_STEPS} steps in "
          f"{rec['ranks25_s']:.1f} s (the one-process run "
          f"{rec['reference_s']:.1f} s, step ms "
          f"{rec['reference_step_ms']}); per-agent losses, x and ψ bit-equal "
          f"to it; rank 0's profiled step: busy {r0['busy_ms']:.2f} ms, "
          f"traced {json.dumps({k: v for k, v in r0['traced'].items() if v})}"
          f", buckets {json.dumps({k: round(v, 3) for k, v in r0['buckets'].items() if v})}",
          flush=True)
    for r in rec["ranks"]:
        for tag in ("overlap", "groups"):
            print(f"[peer26] rank {r['rank']} {tag}: step ms "
                  f"{r[f'{tag}_step_ms']}, loss {r[f'{tag}_loss']}, launches "
                  f"{r[f'{tag}_launches']} "
                  f"({ {k: v / len(r[f'{tag}_step_ms']) for k, v in r[f'{tag}_launches'].items()} } a step), "
                  f"peak {r[f'{tag}_peak_allocated_gib']:.2f} / "
                  f"{r[f'{tag}_peak_reserved_gib']:.2f} GiB, flag waits "
                  f"{r[f'{tag}_waits']} (none timed out), bit-equal to the "
                  f"one-process run {r[f'{tag}_equal']}; {smi}", flush=True)
        cases = {k: v["bit_equal"] for k, v in r["table_cases"].items()}
        print(f"[peer26] rank {r['rank']} table_peer {r['table_ms']:.4f} ms "
              f"(plain {r['table_plain_ms']:.3f}, library "
              f"{r['table_library_ms']:.3f}, bound {r['table_bound_ms']:.4f} "
              f"ms {r['table_bound_by']}) on the ring round; bit-equal "
              f"{cases}; {smi}", flush=True)
    ref26 = rec["references"]
    print(f"[peer26] the one-process references ({rec['reference26_s']:.1f} "
          f"s): overlap step ms {ref26['overlap']['step_ms']} launches "
          f"{ref26['overlap']['launches']}; groups step ms "
          f"{ref26['groups']['step_ms']} launches "
          f"{ref26['groups']['launches']}; phases 26–27 on the ranks "
          f"{rec['ranks_s'] - rec['ranks25_s']:.1f} s (the card's free "
          f"memory at its start {[round(r['card_free_gib_26'], 2) for r in rec['ranks']]}"
          f" GiB, the parent's reserve {rec['parent_reserved_gib_26']:.2f} "
          "GiB); the publish precedes each rank's forward and backward pass, "
          "the combine follows it", flush=True)
    for r in rec["ranks"]:
        for what in TREE_RUNS:
            key = f"tree_{what}"
            print(f"[peer27] rank {r['rank']} tree {what}: step ms "
                  f"{r[f'{key}_step_ms']}, loss {r[f'{key}_loss']}, metrics "
                  f"{r[f'{key}_metrics']}, launches a step "
                  f"{r[f'{key}_step_launches']}, peak "
                  f"{r[f'{key}_peak_allocated_gib']:.2f} / "
                  f"{r[f'{key}_peak_reserved_gib']:.2f} GiB (the peer "
                  f"payloads outside torch's count), flag waits "
                  f"{r[f'{key}_waits']} (none timed out), bit-equal to the "
                  f"one-process run {r[f'{key}_equal']}; {smi}", flush=True)
    r0 = rec["ranks"][0]
    for what in TREE_RUNS:
        ref = rec["references"][f"tree_{what}"]
        print(f"[peer27] tree {what}: the one-process 4-agent run step ms "
              f"{ref['step_ms']} launches {ref['launches']} peak "
              f"{ref['peak_allocated_gib']:.2f} GiB metrics {ref['metrics']};"
              f" rank 0's profiled step traced "
              f"{json.dumps({k: v for k, v in r0[f'tree_{what}_traced'].items() if v})}"
              f", roll {r0[f'tree_{what}_roll_ms']} ms", flush=True)
    print(f"[time] phase 27 took {statistics.median(r['tree_s'] for r in rec['ranks']):.1f}"
          f" s in the ranks (median; per rank "
          f"{[round(r['tree_s'], 1) for r in rec['ranks']]}), its "
          f"one-process references {rec['reference27_s']:.1f} s", flush=True)
    print_wire_ranks(rec, smi)
    print_ep(rec, smi)
    print_tree_block(rec, smi)
    print_tp(rec, smi)
    print_ssm(rec, smi)
    print_tp_train(rec, smi)
    print("[peer] not run on this card: the split (pod × data) permute "
          "plan (the CPU tests hold it over gloo against the JAX package); "
          "NCCL: not run anywhere (one card: NCCL refuses two ranks on it; "
          "gloo on the CPU runs the same permute plan)", flush=True)


def print_wire_ranks(rec, smi: str) -> None:
    """Phase 28's lines: each member rank's run, each form's kernel, the
    one-process references and the phase's time."""
    for r in rec["ranks"]:
        for tag in WIRE_RUNS:
            if not r[f"{tag}_member"]:
                continue
            print(f"[peer28] rank {r['rank']} {tag} bus {r[f'{tag}_bus']}: "
                  f"step ms {r[f'{tag}_step_ms']}, loss {r[f'{tag}_loss']}, "
                  f"launches a step {r[f'{tag}_step_launches']}, torch peak "
                  f"{r[f'{tag}_peak_allocated_gib']:.2f} / "
                  f"{r[f'{tag}_peak_reserved_gib']:.2f} GiB (peer buffers "
                  f"{r[f'{tag}_peer_gib']:.2f} GiB outside it), flag waits "
                  f"{r[f'{tag}_waits']} (none timed out), bit-equal to the "
                  f"one-process run {r[f'{tag}_equal']}; {smi}", flush=True)
        for form, fr in r.get("forms", {}).items():
            cases = {k: v["bit_equal"] for k, v in fr["cases"].items()}
            timed = "not timed"
            if "ms" in fr:
                lib = ("—" if fr["library_ms"] is None
                       else f"{fr['library_ms']:.3f}")
                timed = (f"{fr['ms']:.4f} ms on the ring round (plain "
                         f"{fr['plain_ms']:.3f}, library {lib}, bound "
                         f"{fr['bound_ms']:.4f} ms {fr['bound_by']}, "
                         f"{fr['bound_ms'] / fr['ms']:.1%} of it; "
                         f"{fr['dtype']} {fr['shape']}, {fr['blocks_read']} "
                         f"blocks read, {fr['bytes'] / 1e9:.2f} GB)")
            print(f"[peer28] rank {r['rank']} {form}: {timed}; bit-equal "
                  f"{cases}; {smi}", flush=True)
    for tag in WIRE_RUNS:
        ref = rec["references"][tag]
        print(f"[peer28] {tag}: the one-process run step ms {ref['step_ms']}"
              f" launches a step {ref['step_launches']} peak "
              f"{ref['peak_allocated_gib']:.2f} GiB", flush=True)
    r0 = rec["ranks"][0]
    print(f"[peer28] rank 0's profiled last steps: "
          f"{ {t: {k: v for k, v in r0[f'{t}_traced'].items() if v} for t in WIRE_RUNS} }"
          f", roll ms {[r0[f'{t}_roll_ms'] for t in WIRE_RUNS]}", flush=True)
    print(f"[time] phase 28 took "
          f"{statistics.median(r['p28_s'] for r in rec['ranks']):.1f} s in "
          f"the ranks (median; per rank "
          f"{[round(r['p28_s'], 1) for r in rec['ranks']]}; rank 0's runs "
          f"{ {k: round(v, 1) for k, v in rec['ranks'][0]['wire_s'].items()} }"
          f"), its one-process references {rec['reference28_s']:.1f} s",
          flush=True)


def wire_launches(ranks, name: str) -> dict:
    """Phase 28: each run's member ranks' launches of kernel ``name``."""
    return {t: [r[f"{t}_launches"].get(name, 0) for r in ranks
                if r[f"{t}_member"]] for t in WIRE_RUNS}


def form_summary(ranks, form: str) -> dict:
    """Phase 28: a peer kernel form's timing over the ranks (medians) and
    its bit-equality on every round."""
    recs = [r["forms"][form] for r in ranks if form in r.get("forms", {})]
    libs = [f["library_ms"] for f in recs if f["library_ms"] is not None]
    return {"ms": statistics.median(f["ms"] for f in recs),
            "ms_per_rank": [f["ms"] for f in recs],
            "plain_ms": statistics.median(f["plain_ms"] for f in recs),
            "bound_ms": recs[0]["bound_ms"], "bound_by": recs[0]["bound_by"],
            "library_ms": statistics.median(libs) if libs else None,
            "library": ("torch.matmul(W (B, blocks), stack of the blocks "
                        "read as f32 copies), cuBLAS, TF32 off" if libs
                        else None),
            "max_abs_err": max(c["max_abs_err"] for f in recs
                               for c in f["cases"].values()),
            "bit_equal": all(c["bit_equal"] for f in recs
                             for c in f["cases"].values()),
            "shape": recs[0]["shape"], "dtype": recs[0]["dtype"],
            "blocks_read": recs[0]["blocks_read"],
            "bytes": recs[0]["bytes"]}


def print_fixed_batch(tag: str, arch: str, cli_args, rec, smi: str):
    """Phases 17, 21 and 23's lines."""
    print(f"[{tag}] {arch}: {rec['params']:,} parameters, "
          f"{rec['param_gb']:.2f} GB; init {rec['init_s']:.1f} s, peak "
          f"during init {rec['init_peak_gib']:.2f} GiB; {smi}", flush=True)
    print(f"[{tag}] CLI {' '.join(cli_args)} ({rec['cli_s']:.1f} s): "
          f"{rec['cli_tokens_per_s']:.1f} tokens/s; launches "
          f"{rec['cli_counts']}", flush=True)
    B, S, n_new = rec["shape"]
    frames = f"{rec['frames']} frames, " if rec["frames"] else ""
    print(f"[{tag}] batch {B}, {frames}prompt {S}, {n_new} new: "
          f"prefill {rec['prefill_ms']:.1f} ms (peak "
          f"{rec['prefill_peak_gib']:.2f} GiB), greedy_generate "
          f"{rec['generate_s']:.2f} s = {rec['tokens_per_s']:.1f} tokens/s, "
          f"{rec['per_token_ms']:.2f} ms a token; peak allocated "
          f"{rec['peak_gib']:.2f} GiB, reserved {rec['reserved_gib']:.2f}; "
          f"state {rec['state_mb']:.1f} MB", flush=True)
    dec = rec["decode"]
    print(f"[{tag}-profile] one decode step (batch {B}): device "
          f"busy {dec['device_busy_ms']:.3f} ms in {dec['kernel_launches']} "
          f"kernel launches; host (median) {dec['host_ms']:.2f} ms; device "
          f"idle {dec['idle_share']:.1%}", flush=True)
    print_buckets(f"{tag}-profile", dec)
    print(f"[{tag}-exact] smoke config, f32: {json.dumps(rec['smoke'])}",
          flush=True)


def print_engine(tag: str, arch: str, rec, smi: str):
    """Phases 15 and 19's lines."""
    print(f"[{tag}] {arch} at {rec['n_layers']} layers: "
          f"{rec['params'] / 1e9:.3f} B parameters, "
          f"{rec['param_gb']:.2f} GB; init {rec['init_s']:.1f} s, peak "
          f"during init {rec['init_peak_gib']:.2f} GiB; prefill logits "
          "finite", flush=True)
    print(f"[{tag}] CLI ({rec['cli_s']:.1f} s): launches "
          f"{rec['cli_counts']}; {json.dumps(rec['cli_metrics'])}",
          flush=True)
    print(f"[{tag}] context {CTX}: launches {rec['counts']}; peak "
          f"allocated {rec['peak_gib']:.2f} GiB, reserved "
          f"{rec['reserved_gib']:.2f} GiB (pools {rec['pool_gb']:.2f} GB); "
          f"{smi}", flush=True)
    print(f"[{tag}] {json.dumps(rec['metrics'])}", flush=True)
    for what, d in rec["dispatches"].items():
        print(f"[{tag}-profile] one {what} dispatch: device busy "
              f"{d['device_busy_ms']:.3f} ms in {d['kernel_launches']} "
              f"kernel launches; host (unprofiled median) "
              f"{d['median_ms']:.2f} ms over {d['dispatches_timed']} "
              f"dispatches; device idle {d['idle_share']:.1%}", flush=True)
        print_buckets(f"{tag}-profile", d)
    print(f"[{tag}-exact] smoke config, f32: {json.dumps(rec['smoke'])}",
          flush=True)


def print_buckets(tag: str, rec):
    for name, bms in rec["buckets"].items():
        if bms:
            print(f"[{tag}]   {bms:9.3f} ms  {name}")
    for bms, count, key in rec["top"]:
        print(f"[{tag}]   top {bms:9.3f} ms  x{count:<5d} {key[:80]}")


def print_train_runs(tag: str, arch: str, what: str, rec, smi: str):
    """Phases 16, 18, 20 and 22's lines: one a run of
    :func:`graphed_runs`."""
    print(f"[{tag}] {arch} {what} ({rec['params']:,} parameters), seq "
          f"{SEQ}; {smi}", flush=True)
    for name, r in rec.items():
        if not isinstance(r, dict) or "graph_eq_eager" not in r:
            continue
        print(f"[{tag}] {name}: bus {r['bus']}; graphed == eager "
              f"{r['graph_eq_eager']}; opt-out rows "
              f"{r.get('opt_out_rows')} == φ {r['opt_out_rows_eq_phi']}; "
              f"median replayed step {r['median_ms']:.1f} ms "
              f"({r['tokens_per_s']:.0f} tokens/s; eager "
              f"{r['eager_median_ms']:.1f} ms); replay busy "
              f"{r['busy_ms']:.3f} ms, idle {r['idle_share']:.1%}; replay "
              f"trace {r['traced_replay']}; launches {r['launches']}; peak "
              f"allocated {r['peak_allocated_gib']:.2f} GiB, reserved "
              f"{r['peak_reserved_gib']:.2f}; losses {r['loss']}; steps "
              f"{r['step_ms']} ms", flush=True)
        busy = {k: round(v, 3) for k, v in r["buckets"].items() if v}
        print(f"[{tag}-profile] {name} replay, device ms by bucket: "
              f"{json.dumps(busy)}", flush=True)
        for bms, count, key in r["top"]:
            print(f"[{tag}-profile]   top {bms:9.3f} ms  x{count:<5d} "
                  f"{key[:80]}")


def phase_clock(t_start: float):
    """``clock(phase)`` prints a ``[time]`` line: the seconds since the
    start and those of the phase that just ended, and the memory torch
    still holds on the card going into the phase (allocated / reserved
    GiB, after the cache is emptied)."""
    import torch
    last = {"name": "1-2", "t": t_start}

    def clock(phase: str) -> None:
        now = time.time()
        free()
        print(f"[time] {now - t_start:.1f} s before phase {phase}; phase "
              f"{last['name']} took {now - last['t']:.1f} s; held "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} / "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
        last.update(name=phase, t=now)

    return clock


def main() -> None:
    t_start = time.time()
    clock = phase_clock(t_start)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is "
                         "available")
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model
    from repro_torch.train import bus_layout_for

    # 1. device
    # f32 products in full f32 (phase 9 holds f32 tokens exact)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {device_kind}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # the default stream's cuBLAS workspace lives as long as the process:
    # take it now, from an empty cache, so that it pins no bus-sized cached
    # block of a later phase (a first matmul in phase 3 once held a 6.1 GiB
    # segment so, and phases 20 and 26 ran out of memory)
    torch.matmul(torch.ones((8, 8), device="cuda"),
                 torch.ones((8, 8), device="cuda"))

    # 2. build
    t0 = time.time()
    libs = build.build_all()
    print(f"[build] {time.time() - t0:.2f} s", flush=True)
    for name, path in libs.items():
        print(f"[build] {name}: {path.relative_to(ROOT)}")
        for kernel, report in ptxas_report(build.build_log(name)):
            print(f"[build]   {kernel}: {report}")
    for line in attention_smem_report():
        print(f"[build] {line}")

    clock("3")
    # 3. kernels against their plain versions, on the card
    model = build_model(get_config(ARCH))
    layout = bus_layout_for(model, AGENTS)
    bus_shape = (AGENTS, layout.rows, 128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    edm_main = check_edm(bus_shape, gen, timed=True)
    edm_small = [check_edm(s, gen, timed=False)
                 for s in ((3, 24, 128), (1, 8, 128), (4, 2048, 128))]
    axpy_main = check_axpy(bus_shape, 3, torch.float32, None, gen,
                           timed=True, ring=True)
    axpy_small = [check_axpy(s, n, dt, odt, gen, timed=False)
                  for s in ((3, 24, 128), (4, 2048, 128))
                  for n in (1, 3, 5)
                  for dt, odt in ((torch.float32, None),
                                  (torch.bfloat16, None),
                                  (torch.bfloat16, torch.float32))]
    for rec in [edm_main, *edm_small]:
        print(f"[kernels] edm_update {rec}", flush=True)
    for rec in [axpy_main, *axpy_small]:
        print(f"[kernels] gossip_axpy {rec}", flush=True)
    # the combines on the grouped cell's attention rows of the full bus, in
    # place (phase 14's layout): bit-equal, timed beside the unstrided call
    grows = group_rows(model)
    strided = {"gossip_axpy": check_strided("gossip_axpy", bus_shape, grows,
                                            gen, layout.block_rows)}
    print_strided("kernels", strided["gossip_axpy"], smi)

    clock("3w")
    # 3w. the wire kernels against their plain versions, on the card
    br = layout.block_rows
    ef_main, ef_small = {}, {}
    for fmt in ("bf16", "int8"):
        ef_main[fmt] = check_ef(bus_shape, fmt, gen, timed=True,
                                block_rows=br)
        ef_small[fmt] = [check_ef(s, fmt, gen, timed=False, block_rows=b)
                         for s, b in (((2, 9), 8), ((3, 8), 24), ((1, 7), br),
                                      ((4, 12), br))]
        for rec in [ef_main[fmt], *ef_small[fmt]]:
            print(f"[wire-kernels] edm_update_ef {rec}", flush=True)
    q8_main = check_q8(bus_shape, 3, gen, timed=True, ring=True,
                       block_rows=br)
    q8_small = [check_q8((A, rows, 128), n, gen, timed=False, block_rows=b)
                for A, rows, b in ((3, 24, 8), (4, 3 * br, br))
                for n in (1, 2, 5, 16)]
    for rec in [q8_main, *q8_small]:
        print(f"[wire-kernels] gossip_axpy_q8 {rec}", flush=True)
    strided["gossip_axpy_q8"] = check_strided("gossip_axpy_q8", bus_shape,
                                              grows, gen, br)
    print_strided("wire-kernels", strided["gossip_axpy_q8"], smi)

    clock("3r")
    # 3r. the ring combine (kernel 8's counterpart) against its plain
    # version: the full bus timed, then with NaN / ±Inf, then every ring
    # shape at odd row counts
    ring_main = check_ring(bus_shape, gen, timed=True)
    ring_small = [check_ring(bus_shape, gen, timed=False, edges=True)] + [
        check_ring((A, rows, 128), gen, timed=False, edges=e)
        for A, rows in RING_CASES for e in (False, True)]
    for rec in [ring_main, *ring_small]:
        print(f"[ring-kernels] ring_combine {rec}", flush=True)
    strided["ring_combine"] = check_strided("ring_combine", bus_shape, grows,
                                            gen, br)
    print_strided("ring-kernels", strided["ring_combine"], smi)
    print(f"[ring-kernels] ring_combine at {bus_shape}: "
          f"{ring_main['ms']:.4f} ms ({ring_main['gb_per_s']:.0f} GB/s); "
          f"plain (2 rolls + combine) {ring_main['plain_ms']:.4f} ms; "
          f"bound {ring_main['bound_ms']:.4f} ms ({ring_main['bound_by']}), "
          f"{ring_main['bound_ms'] / ring_main['ms']:.1%} of it; "
          f"torch.matmul(W, x.view(A, -1)) {ring_main['library_ms']:.4f} ms;"
          f" {smi}", flush=True)

    clock("3m")
    # 3m. the source-table combine against its plain version: masked,
    # late and weight-0-pad tables at the full bus, NaN / ±Inf, bf16, and
    # a late slot's NaN row reaching no other agent
    free()
    table_recs = table_phase(bus_shape, gen)
    for rec in table_recs:
        print(f"[table-kernels] table_combine {rec}", flush=True)
    strided["table_combine"] = check_strided("table_combine", bus_shape,
                                             grows, gen, br)
    print_strided("table-kernels", strided["table_combine"], smi)
    tm = table_recs[0]
    print(f"[table-kernels] table_combine at {bus_shape} ({tm['case']}): "
          f"{tm['ms']:.4f} ms ({tm['gb_per_s']:.0f} GB/s); plain "
          f"(gathers + combine) {tm['plain_ms']:.4f} ms; bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}), "
          f"{tm['bound_ms'] / tm['ms']:.1%} of it; "
          f"torch.matmul(W_eff, x.view(A, -1)) {tm['library_ms']:.4f} ms; "
          f"{smi}", flush=True)

    clock("3f")
    # 3f. flash GQA attention against its plain version, timed, driven
    free()
    flash_recs, flash_poison, flash_timed, flash_counts = flash_phase()
    for rec in flash_recs + flash_poison:
        print(f"[flash] {rec}", flush=True)
    for rec in flash_timed.values():
        print(f"[flash-timed] {rec}", flush=True)
    print(f"[flash] the op at (a) and (b): launches {flash_counts}",
          flush=True)

    clock("25-33")
    # 25–33. multi-rank: 4 ranks on the one card, the peer-pointer
    # ring (25); the delayed pipeline with a straggler, the peer table
    # kernel and policy groups across ranks (26); the tree path (27); the
    # wires, agent blocks and row shards (28); the MoE served
    # expert-parallel and in the EP + TP layout (29); the tree with two
    # agents a rank (30); qwen3_14b (31) and falcon_mamba_7b (32)
    # tensor-parallel served; qwen3_14b trained tensor-parallel (33).  They run here, while this process holds next to nothing on the card: the four ranks and their
    # peer buffers take most of it
    peer = peer_phase()
    print_peer(peer, smi)

    clock("4")
    # 4. the main path, through the CLI's entry point
    free()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    result = cli.main(MAIN_ARGS)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] launches {counts}; peak memory {peak / 2**30:.2f} GiB; "
          f"bus {bus_shape} f32 = {math.prod(bus_shape) * 4 / 1e9:.2f} GB",
          flush=True)
    for t, (m, s) in enumerate(zip(result["metrics"], result["step_seconds"])):
        print(f"[main] step {t} loss={m['loss']:.6f} "
              f"consensus={m['consensus']:.6e} grad_norm={m['grad_norm']:.4f}"
              f" step_s={s:.4f}")
        check(all(math.isfinite(v) for v in m.values()),
              f"non-finite metrics at step {t}: {m}")
    # graphed: step 0 runs eagerly and captures, steps 1.. replay
    step_s = statistics.median(result["step_seconds"][1:])
    print(f"[main] median step {step_s * 1e3:.1f} ms over steps 1–"
          f"{STEPS - 1} (CUDA graph replays; step 0, eager and captured, "
          f"{result['step_seconds'][0] * 1e3:.1f} ms); "
          f"{AGENTS * SEQ / step_s:.0f} tokens/s; peak reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB", flush=True)
    # the wrappers ran step 0 (eager); steps 1.. replayed, which the
    # device traces of phase 5 read
    want = {k: 0 for k in counts}
    want.update(edm_update=1, ring_combine=1)
    check(counts == want and result["graph_replays"] == STEPS - 1,
          f"training launched {counts} and replayed "
          f"{result['graph_replays']} steps, expected {want} (the eager "
          f"step 0: one EDM and one ring combine, no roll, no wire or "
          f"serving kernel) and {STEPS - 1} replays")
    state = result["state"]
    check(state["step"] == STEPS, "main path did not take every step")
    check(bool(torch.isfinite(state["params"]).all()), "non-finite x")

    ring_runs = {"graphed": {
        "launches": {k: v for k, v in counts.items() if v},
        "graph_replays": result["graph_replays"],
        "step_ms": [round(t * 1e3, 2) for t in result["step_seconds"]],
        "median_ms": step_s * 1e3, "tokens_per_s": AGENTS * SEQ / step_s,
        "peak_allocated_gib": peak / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
        "loss": [m["loss"] for m in result["metrics"]]}}

    clock("5")
    # 5. where one step's device time goes: one eager step profiled (the
    # ring kernel, no roll left), then one graph replay profiled (the same
    # training kernels in its device trace) and between CUDA events
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                       n_agents=AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(2)
    state, prof = profile_step(model, result["run"], state,
                               data.sample(dgen, 1))
    busy = prof["device_busy_ms"]
    print(f"[profile] one eager step: device busy {busy:.3f} ms in "
          f"{prof['kernel_launches']} kernel launches", flush=True)
    for name, ms in prof["buckets"].items():
        print(f"[profile]   {ms:9.3f} ms  {name}")
    for ms, count, key in prof["top"]:
        print(f"[profile]   top {ms:9.3f} ms  x{count:<5d} {key[:80]}")
    check(prof["buckets"]["roll (gossip terms)"] == 0
          and prof["buckets"]["ring_combine kernel"] > 0,
          f"the ring step still rolls or never ran the ring kernel: "
          f"{prof['buckets']}")
    free()
    state, gprof_main = profile_graph_replay(model, result["run"], state,
                                             data.sample(dgen, 1))
    print_graph_profile("profile", step_s * 1e3, gprof_main)
    check_replay("main path", prof, gprof_main,
                 {"edm_update": 1, "ring_combine": 1})
    del result

    clock("6")
    # 6. fused against plain through the rolls: one step with the rolls and
    # the gossip_axpy kernel against one with the rolls and the plain
    # combine, from one state and one gradient bus; the twin checks (6, 6r,
    # 6w) and 4g run at full width with the depth cut to GRAPH_LAYERS (the
    # script's time: each copies whole buses to the host)
    del state
    free()
    cut = build_model(dataclasses.replace(get_config(ARCH),
                                          n_layers=GRAPH_LAYERS))
    cut_layout = bus_layout_for(cut, AGENTS)
    twin = fused_vs_plain(cut, cut_layout,
                          stepped_state(cut, bus_run(), data.sample(dgen, 1)),
                          data.sample(dgen, 1)["tokens"])
    print(f"[fused-vs-plain] {GRAPH_LAYERS} layers: {twin}", flush=True)
    free()

    clock("4r")
    # 4r. the main path eager (--eager): every launch counted where the
    # wrapper makes it (5 ring_combine, 5 edm_update, no gossip_axpy)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = cli.main(MAIN_ARGS + ["--eager"])
    c = ops.launch_counts()
    want = {k: 0 for k in c}
    want.update(edm_update=STEPS, ring_combine=STEPS)
    check(c == want and res["graph_replays"] == 0,
          f"the eager main path launched {c}, expected {want}")
    for t, m in enumerate(res["metrics"]):
        check(all(math.isfinite(v) for v in m.values()),
              f"eager main path: non-finite metrics at step {t}: {m}")
    steady = statistics.median(res["step_seconds"][1:]) * 1e3
    ring_runs["eager"] = {
        "launches": {k: v for k, v in c.items() if v},
        "step_ms": [round(t * 1e3, 2) for t in res["step_seconds"]],
        "median_ms": steady, "tokens_per_s": AGENTS * SEQ / steady * 1e3,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
        "loss": [m["loss"] for m in res["metrics"]]}
    state = res["state"]
    del res
    for mode in ("graphed", "eager"):
        print(f"[ring-main] {mode}: {json.dumps(ring_runs[mode])}",
              flush=True)
    for mode, prof_ in (("eager", prof), ("graphed", gprof_main)):
        med = ring_runs[mode]["median_ms"]
        busy = prof_["device_busy_ms"]
        print(f"[ring-profile] {mode}: one step device busy {busy:.3f} ms in "
              f"{prof_['kernel_launches']} kernel launches (training kernels "
              f"{ {k: v for k, v in prof_['traced'].items() if v} }); median "
              f"step {med:.1f} ms (steps 1–{STEPS - 1}), "
              f"{AGENTS * SEQ / med * 1e3:.0f} tokens/s, idle "
              f"{1 - busy / med:.1%}; peak allocated "
              f"{ring_runs[mode]['peak_allocated_gib']:.2f} GiB, reserved "
              f"{ring_runs[mode]['peak_reserved_gib']:.2f} GiB; wrapper "
              f"launches {ring_runs[mode]['launches']}", flush=True)
    print(f"[ring-profile] graphed: one replay's device span (CUDA events) "
          f"{gprof_main['graph_span_ms']:.3f} ms, host "
          f"{gprof_main['host_ms']:.3f} ms; ring_combine kernel "
          f"{prof['buckets']['ring_combine kernel']:.3f} ms of the eager "
          f"step; {smi}", flush=True)

    clock("6r")
    # 6r. one fused step through the ring kernel == one plain step through
    # the rolls and the plain combine, from one state and gradient bus
    del state
    free()
    ring_twin = ring_vs_plain(cut, cut_layout,
                              stepped_state(cut, bus_run(),
                                            data.sample(dgen, 1)),
                              data.sample(dgen, 1)["tokens"])
    print(f"[ring-vs-plain] {GRAPH_LAYERS} layers: {ring_twin}", flush=True)
    free()

    clock("4g")
    # 4g. the graphed bus step against the eager one, bit for bit, under
    # deterministic algorithms (eager against eager first), at full width
    # with the depth cut to GRAPH_LAYERS
    graph_recs = graph_phase(cut, data, dgen)
    for rec in graph_recs:
        print(f"[graph] {GRAPH_LAYERS} layers: {json.dumps(rec)}",
              flush=True)

    clock("4w")
    # 4w. the wire main path through the CLI: int8 on the ring, then bf16
    # on round_robin's one-peer rounds of the exp graph; graphed, so the
    # wrappers count the eager first step of each graph key (one on the
    # ring, one a round on round_robin) and the rest replay
    wire_counts, wire_replays = {}, {}
    for fmt, extra, steps, want in (
            ("int8", [], STEPS, {"edm_update_ef": 1, "gossip_axpy_q8": 1}),
            ("bf16", ["--topology", "exp", "--gossip-schedule",
                      "round_robin"], WIRE_RR_STEPS,
             {"edm_update_ef": 2, "gossip_axpy": 2})):
        args = MAIN_ARGS + ["--wire", fmt] + extra
        args[args.index("--steps") + 1] = str(steps)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        result = cli.main(args)
        counts_w = ops.launch_counts()
        wire_counts[fmt] = counts_w
        wire_replays[fmt] = result["graph_replays"]
        peak = torch.cuda.max_memory_allocated()
        print(f"[wire-main] --wire {fmt} {' '.join(extra)}: launches "
              f"{counts_w}; peak memory {peak / 2**30:.2f} GiB; modeled "
              f"wire bytes per gossip round {result['wire_bytes'][0]} on "
              f"one device, {result['wire_bytes'][1]} with one agent per "
              "device", flush=True)
        for t, (m, sec) in enumerate(zip(result["metrics"],
                                         result["step_seconds"])):
            print(f"[wire-main] {fmt} step {t} loss={m['loss']:.6f} "
                  f"consensus={m['consensus']:.6e} "
                  f"grad_norm={m['grad_norm']:.4f} step_s={sec:.4f}")
            check(all(math.isfinite(v) for v in m.values()),
                  f"--wire {fmt}: non-finite metrics at step {t}: {m}")
        # the replayed steps: those after each round's eager first step
        n_eager = want["edm_update_ef"]
        wire_step_s = statistics.median(result["step_seconds"][n_eager:])
        print(f"[wire-main] {fmt} median step {wire_step_s * 1e3:.1f} ms "
              f"over steps {n_eager}–{steps - 1} ({result['graph_replays']} "
              f"graph replays; eager and captured steps "
              f"{[round(t * 1e3, 1) for t in result['step_seconds'][:n_eager]]}"
              " ms)", flush=True)
        full = {k: 0 for k in counts_w}
        full.update(want)
        check(counts_w == full and result["graph_replays"] == steps - n_eager,
              f"--wire {fmt} launched {counts_w} and replayed "
              f"{result['graph_replays']} steps, expected {full} and "
              f"{steps - n_eager}")
        state, run = result["state"], result["run"]
        del result                # the state is consumed by the next step
        check(state["step"] == steps and set(state["opt"]) == {
            "m", "psi", "e"}, f"--wire {fmt}: state {state['step']}, "
            f"{sorted(state['opt'])}")
        check(bool(torch.isfinite(state["params"]).all()),
              f"--wire {fmt}: non-finite x")
        if fmt == "int8":
            # 5w. one profiled int8 step; 6w. fused EF step == plain EF step
            state, wprof = profile_step(model, run, state,
                                        data.sample(dgen, 1))
            busy = wprof["device_busy_ms"]
            print(f"[wire-profile] one eager int8 step: device busy "
                  f"{busy:.3f} ms in {wprof['kernel_launches']} kernel "
                  "launches", flush=True)
            for name, ms in wprof["buckets"].items():
                print(f"[wire-profile]   {ms:9.3f} ms  {name}")
            for ms, count, key in wprof["top"]:
                print(f"[wire-profile]   top {ms:9.3f} ms  x{count:<5d} "
                      f"{key[:80]}")
            free()
            state, gprof_wire = profile_graph_replay(model, run, state,
                                                     data.sample(dgen, 1))
            print_graph_profile("wire-profile", wire_step_s * 1e3,
                                gprof_wire)
            check_replay("--wire int8", wprof, gprof_wire,
                         {"edm_update_ef": 1, "gossip_axpy_q8": 1})
            del state
            free()
            print("[time] phase 5w done", flush=True)
            tokens = data.sample(dgen, 1)["tokens"]
            ef_twin = []
            for f in ("int8", "bf16"):
                ef_twin.append(ef_fused_vs_plain(
                    cut, cut_layout, stepped_state(
                        cut, bus_run(wire="int8"), data.sample(dgen, 1)),
                    tokens, f))
                free()
            for rec in ef_twin:
                print(f"[wire-fused-vs-plain] {GRAPH_LAYERS} layers: {rec}",
                      flush=True)
        else:
            del state
        free()
    clock("12")
    # 12. churn at full width: the main cell with agent 3 down for steps
    # 2–3, graphed; replay traces; the resize at the smoke config
    churn = churn_phase(model, data, dgen)
    for ep in churn["epochs"]:
        print(f"[churn] epoch {ep['epoch']} @ step {ep['start']}: "
              f"{ep['alive']}/{AGENTS} alive, λ = {ep['lambda']:.4f}, "
              f"modeled wire bytes per round {ep['wire_bytes'][0]} on one "
              f"device, {ep['wire_bytes'][1]} with one agent per device",
              flush=True)
    print(f"[churn] {json.dumps({k: v for k, v in churn.items() if k != 'epochs'})}",
          flush=True)
    print(f"[churn] median replayed step {churn['median_ms']:.1f} ms "
          f"(steps 1, 3, 5), degraded replay busy "
          f"{churn['traces']['degraded_busy_ms']:.2f} ms, idle "
          f"{churn['idle_share']:.1%}; peak allocated "
          f"{churn['peak_allocated_gib']:.2f} GiB; launches "
          f"{churn['launches']}; {smi}", flush=True)

    clock("13")
    # 13. the overlapped pipeline at full width: f32 ring and int8 wire
    # through the CLI, graphed == eager, step 0 == synchronous, straggler
    overlap = overlap_phase(model, data, dgen)
    for fmt in ("f32", "int8"):
        rec = overlap[fmt]
        print(f"[overlap] --overlap delayed {fmt}: {json.dumps(rec)}",
              flush=True)
        print(f"[overlap] {fmt}: median replayed step {rec['median_ms']:.1f}"
              f" ms (steps 2–{STEPS - 1}), {rec['tokens_per_s']:.0f} "
              f"tokens/s; peak allocated {rec['peak_allocated_gib']:.2f} "
              f"GiB; at {GRAPH_LAYERS} layers a replay busy "
              f"{rec['busy_ms']:.2f} ms, idle {rec['idle_share']:.1%} of "
              f"that run's median; {smi}", flush=True)
    for rec in overlap["graph"]:
        print(f"[overlap-graph] {json.dumps(rec)}", flush=True)
    print(f"[overlap] step 0 == synchronous step: {overlap['step0']}; "
          f"straggler == plain twin: {overlap['straggler']}", flush=True)

    clock("14")
    # 14. policy groups at full width: the 4-group policy through the CLI,
    # graphed; replay traces; 2-group f32 ring == ungrouped; graphed ==
    # eager with the opt-out rows equal to φ's
    groups = group_phase(model, data, dgen)
    for g in groups["groups"]:
        print(f"[groups] group {g['name']}: rows {g['rows']}, gossip_every "
              f"{g['gossip_every']}, wire {g['wire']}, schedule "
              f"{g['schedule']}; modeled wire bytes on a gossiping step "
              f"(one agent per device) {g['wire_bytes']}, "
              f"{g['gossip_steps']} of {GROUP_STEPS} steps gossip",
              flush=True)
    print("[groups] " + json.dumps(
        {k: v for k, v in groups.items() if k != "groups"}), flush=True)
    for parity in ("even", "odd"):
        r = groups["replays"][parity]
        print(f"[groups] {parity} steps: median {groups[parity + '_ms']:.1f}"
              f" ms (the CLI, full depth); at {GRAPH_LAYERS} layers one "
              f"replay busy {r['busy_ms']:.2f} ms in {r['kernel_launches']} "
              f"launches (span {r['span_ms']:.2f} ms, host "
              f"{r['host_ms']:.2f} ms), idle {r['idle_share']:.1%}; "
              f"training kernels {r['traced']}", flush=True)
    print(f"[groups] graphs {groups['graphs']}, replays "
          f"{groups['graph_replays']}; peak allocated "
          f"{groups['peak_allocated_gib']:.2f} GiB, reserved "
          f"{groups['peak_reserved_gib']:.2f} GiB; launches "
          f"{groups['launches']}; {smi}", flush=True)

    clock("4t")
    # 4t. the tree path through the CLI, every algorithm; 6t. fused tree
    # step == its plain twin, and close to the unfused chain
    n_leaves = len(model.meta())
    tree_recs, edm_state, edm_run = tree_main(cli, n_leaves)
    for alg, rec in tree_recs.items():
        print(f"[tree-main] {alg}: launches {rec['launches']}; median step "
              f"{rec['median_step_ms']:.1f} ms (steps {rec['step_ms']}); "
              f"peak memory {rec['peak_gib']:.2f} GiB; opt {rec['opt_slots']}"
              f"; metrics {rec['metrics']}", flush=True)
    clock("5t")
    # 5t. one profiled tree edm step
    edm_state, tprof = profile_step(model, edm_run, edm_state,
                                    data.sample(dgen, 1))
    tree_ms = tree_recs["edm"]["median_step_ms"]
    print(f"[tree-profile] one tree edm step: device busy "
          f"{tprof['device_busy_ms']:.3f} ms in {tprof['kernel_launches']} "
          f"kernel launches; against the unprofiled median step of "
          f"{tree_ms:.1f} ms the device is idle "
          f"{1 - tprof['device_busy_ms'] / tree_ms:.1%} of the step",
          flush=True)
    for name, ms in tprof["buckets"].items():
        print(f"[tree-profile]   {ms:9.3f} ms  {name}")
    for ms, count, key in tprof["top"]:
        print(f"[tree-profile]   top {ms:9.3f} ms  x{count:<5d} {key[:80]}")
    del edm_state
    free()
    print("[time] phase 5t profile done", flush=True)
    tree_twin = tree_fused_vs_plain(
        cut, stepped_state(cut, edm_run, data.sample(dgen, 1)),
        data.sample(dgen, 1)["tokens"])
    print(f"[tree-fused-vs-plain] {GRAPH_LAYERS} layers: {tree_twin}",
          flush=True)
    del model, layout, cut, cut_layout
    free()

    clock("7")
    # 7. the serving kernels against their plain versions, on the card
    serve_recs, serve_timed = serving_kernels()
    for name, recs in serve_recs.items():
        for rec in recs:
            print(f"[serve-kernels] {name} {rec}", flush=True)
    dt = serve_timed["paged_attention"]
    print(f"[serve-kernels] paged_attention timed ({dt['dtype']}, q "
          f"{dt['shape']}, {dt['kv_rows']} KV rows): {dt['ms']:.5f} ms; "
          f"plain {dt['plain_ms']:.4f} ms; SDPA {dt['library_ms']:.5f} ms; "
          f"bound {dt['bound_ms']:.5f} ms ({dt['bound_by']}), "
          f"{dt['bound_fraction']:.1%} of it; clusters of {dt['n_split']} "
          f"blocks, {dt['split_keys']} keys a block; {smi}", flush=True)
    for key, what in (("paged_attention_hd128", "hd 128 G 1"),
                      ("paged_attention_g4", "hd 128 G 4"),
                      ("paged_attention_tp", "hd 128 K 2 G 5 (TP rank)"),
                      ("paged_attention_ep_tp",
                       "hd 128 K 4 G 1 (EP + TP rank)")):
        dt = serve_timed[key]
        print(f"[serve-kernels] paged_attention {what} timed ({dt['dtype']}, "
              f"q {dt['shape']}, {dt['kv_rows']} KV rows): {dt['ms']:.5f} "
              f"ms; plain {dt['plain_ms']:.4f} ms; SDPA "
              f"{dt['library_ms']:.5f} ms; bound {dt['bound_ms']:.5f} ms "
              f"({dt['bound_by']}), {dt['bound_fraction']:.1%} of it; "
              f"clusters of {dt['n_split']} blocks, {dt['split_keys']} keys "
              f"a block; {smi}", flush=True)
    for key in ("paged_prefill", "paged_prefill_hd128", "paged_prefill_g4",
                "paged_prefill_tp", "paged_prefill_ep_tp"):
        pt = serve_timed[key]
        print(f"[serve-kernels] {key} timed ({pt['dtype']}, case "
              f"{pt['case']}): {pt['ms']:.5f} ms (host {pt['host_ms']:.4f} "
              f"ms a call); op {pt['op_ms']:.5f} ms; plain "
              f"{pt['plain_ms']:.4f} ms; SDPA {pt['library_ms']:.5f} ms; "
              f"bound {pt['bound_ms']:.5f} ms ({pt['bound_by']}), "
              f"{pt['bound_ms'] / pt['ms']:.1%} of it; {smi}", flush=True)

    clock("8")
    # 8. the serving main path: the CLI, then the engine at context 1024
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, poisson_load)
    n_layers = get_config(ARCH).n_layers
    ops.reset_launch_counts()
    cli_metrics = serve_cli.main(SERVE_ARGS)
    cli_counts = ops.launch_counts()
    print(f"[serve-cli] launches {cli_counts}", flush=True)
    check_serve_counts(cli_counts, cli_metrics, n_layers, "serve CLI")
    check(cli_metrics["requests"] == 16 and cli_metrics["tokens"] > 0,
          f"serve CLI finished {cli_metrics}")
    free()
    smodel = build_model(get_config(ARCH))
    sparams = smodel.init(torch.Generator(device="cuda").manual_seed(0))
    vocab = smodel.cfg.vocab_size
    pcfg = PagedCacheConfig(page_size=PAGE, num_pages=1 + SLOTS * CTX // PAGE,
                            max_slots=SLOTS, max_context=CTX)
    eng = ContinuousBatchingEngine(smodel, sparams, pcfg, attn_impl="kernel",
                                   prefill_chunk=CHUNK,
                                   max_step_tokens=STEP_TOKENS,
                                   device="cuda")
    reqs = poisson_load(32, rate=1000.0, vocab=vocab,
                        prompt_buckets=(256, 768),
                        new_token_buckets=(16, 32, 64), prompt_dist="exact",
                        seed=0)
    eng.run(poisson_load(2, rate=1000.0, vocab=vocab,
                         prompt_buckets=(256, 256), new_token_buckets=(4,),
                         seed=1))                        # warm-up
    eng.reset()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    serve_metrics = eng.run(reqs)
    serve_counts = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    check_serve_counts(serve_counts, serve_metrics, n_layers,
                       f"engine at context {CTX}")
    check(serve_metrics["requests"] == len(reqs) and all(
        len(eng.completed[r.rid]) == r.max_new for r in reqs),
        "the engine did not finish every request with its full budget")
    pool_gb = sum(t.numel() * t.element_size() for pi in eng.pools
                  for t in pi.values()) / 1e9
    print(f"[serve] context {CTX}: launches {serve_counts}; peak memory "
          f"{serve_peak / 2**30:.2f} GiB (pools {pool_gb:.2f} GB)",
          flush=True)
    print(f"[serve] {json.dumps(serve_metrics)}", flush=True)
    disp = profile_dispatches(eng, vocab)
    for what, rec in disp.items():
        print(f"[serve-profile] one {what} dispatch: device busy "
              f"{rec['device_busy_ms']:.3f} ms in {rec['kernel_launches']} "
              f"kernel launches; unprofiled median {rec['median_ms']:.2f} ms "
              f"over {rec['dispatches_timed']} dispatches; device idle "
              f"{rec['idle_share']:.1%}", flush=True)
        for name, ms in rec["buckets"].items():
            if ms:
                print(f"[serve-profile]   {ms:9.3f} ms  {name}")
        for ms, count, key in rec["top"]:
            print(f"[serve-profile]   top {ms:9.3f} ms  x{count:<5d} "
                  f"{key[:80]}")
    mixed = disp["mixed"]
    prefill_share = mixed["buckets"]["paged_prefill kernel"] / mixed[
        "device_busy_ms"]
    print(f"[serve-profile] mixed dispatch: paged_prefill kernel "
          f"{mixed['buckets']['paged_prefill kernel']:.3f} ms of "
          f"{mixed['device_busy_ms']:.3f} ms device busy "
          f"({prefill_share:.1%}); {smi}", flush=True)
    for what, rec in disp.items():
        ms = rec["buckets"]["paged_attention kernel"]
        print(f"[serve-profile] {what} dispatch: paged_attention kernel "
              f"{ms:.3f} ms of {rec['device_busy_ms']:.3f} ms device busy "
              f"({ms / rec['device_busy_ms']:.1%})", flush=True)
    del eng
    free()

    clock("9")
    # 9. exactness of the kernel engine on the card
    exact = serve_exactness(vocab, smodel, sparams)
    print(f"[serve-exact] f32 kernel engine == greedy_generate on "
          f"{exact['f32_requests_equal']} requests ({exact['f32_tokens']} "
          f"tokens, prompts {exact['prompts']}); bf16 kernel vs plain engine "
          f"agree on {exact['bf16_agree']}/{exact['bf16_tokens']} tokens "
          f"({exact['bf16_agree_share']:.1%})", flush=True)
    del smodel, sparams
    free()

    clock("10")
    # 10. the paper on the card
    paper = paper_phase()
    print(f"[paper] quadratic §E.1, ring(32), 3000 steps: EDM mean "
          f"‖x_i − x*‖² = {paper['edm']:.3e} ({paper['edm_s']:.1f} s), DmSGD "
          f"{paper['dmsgd']:.3e} ({paper['dmsgd_s']:.1f} s); ζ² = "
          f"{paper['zeta2']:.2f}", flush=True)

    clock("11")
    # 11. the train → export → serve hand-off, at full width and depth
    handoff = handoff_phase(n_layers)
    hm = handoff["serve_metrics"]
    print(f"[handoff] {HANDOFF_STEPS} bus steps → checkpoint.save "
          f"{handoff['params_file_gb']:.2f} GB in {handoff['save_s']:.1f} s "
          f"→ export_consensus {handoff['export_file_gb']:.2f} GB in "
          f"{handoff['export_s']:.1f} s → serve CLI --ckpt: "
          f"{hm['requests']} requests, {hm['tokens']} tokens in "
          f"{hm['steps']} dispatches ({handoff['serve_s']:.1f} s), launches "
          f"{handoff['serve_counts']}; served params sha256 "
          f"{handoff['params_sha256'][:16]}… == the export's; smoke "
          f"--ckpt/--resume bit-equal: {handoff['resume_bit_equal']}",
          flush=True)

    clock("15")
    # 15. deepseek_moe_16b served at full width and depth
    moe_serve = moe_serve_phase()
    print_engine("moe-serve", MOE_ARCH, moe_serve, smi)

    clock("16")
    # 16. MoE training at full width, depth cut to one layer, 2 agents
    moe_train = moe_train_phase()
    print_train_runs("moe-train", MOE_ARCH, f"at full width, "
                     f"{MOE_TRAIN_LAYERS} layer, {MOE_AGENTS} agents, ring",
                     moe_train, smi)

    clock("17")
    # 17. falcon_mamba_7b served at full width and depth
    ssm_serve = fixed_batch_serve_phase(SSM_ARCH, SSM_SERVE_ARGS,
                                        SSM_PARAMS)
    print_fixed_batch("ssm-serve", SSM_ARCH, SSM_SERVE_ARGS, ssm_serve, smi)

    clock("18")
    # 18. SSM training at full width, depth cut to two layers, 4 agents
    ssm_train = ssm_train_phase()
    print_train_runs("ssm-train", SSM_ARCH, f"at full width, "
                     f"{SSM_TRAIN_LAYERS} layers, {AGENTS} agents, ring",
                     ssm_train, smi)
    print(f"[ssm-train] remat (gradients at x(0), bit-equal to off): "
          f"{json.dumps(ssm_train['remat'])}", flush=True)
    print(f"[ssm-train] kernels on this bus: "
          f"{json.dumps(ssm_train['kernels'])}", flush=True)
    sc, n_ssm = ssm_train["scan"], get_config(SSM_ARCH).n_layers
    pf, tr = sc["prefill"], sc["train"]
    print(f"[ssm-scan] the chunked scan alone: prefill shape {pf['shape']} "
          f"{pf['ms']:.3f} ms a layer, device busy {pf['busy_ms']:.3f} ms in "
          f"{pf['launches']} launches (x {n_ssm} layers = "
          f"{pf['busy_ms'] * n_ssm:.1f} ms of the "
          f"{ssm_serve['prefill_ms']:.1f} ms prefill; bound "
          f"{pf['bound_ms']:.3f} ms); train shape {tr['shape']} forward + "
          f"backward {tr['ms']:.3f} ms a call, device busy "
          f"{tr['busy_ms']:.3f} ms in {tr['launches']} launches (x "
          f"{SSM_TRAIN_LAYERS} layers x {AGENTS} agents = "
          f"{tr['busy_ms'] * SSM_TRAIN_LAYERS * AGENTS:.1f} ms of the "
          f"{ssm_train['ungrouped']['busy_ms']:.1f} ms replay busy; bound "
          f"{tr['bound_ms']:.3f} ms); {smi}", flush=True)

    clock("19")
    # 19. pixtral_12b served at full width and depth (paged kernels, G 4)
    vlm_serve = vlm_serve_phase()
    print(f"[vlm-serve] fixed batch {' '.join(VLM_CLI_ARGS)} (frontend "
          f"{get_config(VLM_ARCH).n_frontend_tokens} a request; "
          f"{vlm_serve['fixed_cli_s']:.1f} s): "
          f"{vlm_serve['fixed_cli_tokens_per_s']:.1f} tokens/s; launches "
          f"{vlm_serve['fixed_cli_counts']}", flush=True)
    print_engine("vlm-serve", VLM_ARCH, vlm_serve, smi)

    clock("20")
    # 20. VLM training at full width, depth cut to one layer, 2 agents
    vlm_train = vlm_train_phase()
    print_train_runs("vlm-train", VLM_ARCH, f"at full width, "
                     f"{VLM_TRAIN_LAYERS} layer, {VLM_AGENTS} agents, ring, "
                     f"{get_config(VLM_ARCH).n_frontend_tokens} frontend "
                     "positions", vlm_train, smi)

    clock("21")
    # 21. jamba_1_5_large_398b served at full width, depth cut to 5
    hybrid_serve = fixed_batch_serve_phase(
        HYBRID_ARCH, HYBRID_CLI_ARGS, HYBRID_PARAMS,
        n_layers=HYBRID_SERVE_LAYERS, tag="hybrid")
    print_fixed_batch("hybrid-serve", HYBRID_ARCH, HYBRID_CLI_ARGS,
                      hybrid_serve, smi)

    clock("22")
    # 22. Jamba training at a width cut, one period deep, 4 agents
    hybrid_train = hybrid_train_phase()
    print_train_runs("hybrid-train", HYBRID_ARCH, f"d_model "
                     f"{HYBRID_TRAIN['d_model']}, d_ff "
                     f"{HYBRID_TRAIN['d_ff']}, {HYBRID_TRAIN['n_layers']} "
                     f"layers, {AGENTS} agents, ring", hybrid_train, smi)
    print(f"[hybrid-train] remat (gradients at x(0), bit-equal to off): "
          f"{json.dumps(hybrid_train['remat'])}", flush=True)
    print(f"[hybrid-train] kernels on this bus: "
          f"{json.dumps(hybrid_train['kernels'])}", flush=True)

    clock("23")
    # 23. whisper_small served at full width and depth (fixed batch)
    whisper_serve = fixed_batch_serve_phase(
        WHISPER_ARCH, WHISPER_CLI_ARGS, WHISPER_PARAMS, tag="whisper",
        shape=WHISPER_SHAPE, exactness=whisper_serve_exactness)
    print_fixed_batch("whisper-serve", WHISPER_ARCH, WHISPER_CLI_ARGS,
                      whisper_serve, smi)

    clock("24")
    # 24. whisper_small trained at full width and depth, 4 agents; the
    # consensus of a CLI run exported and served
    whisper_train = whisper_train_phase()
    print_train_runs("whisper-train", WHISPER_ARCH, f"at full width and "
                     f"depth, {AGENTS} agents, ring, 1500 frames",
                     whisper_train, smi)
    wh = whisper_train["handoff"]
    print(f"[whisper-handoff] train CLI {HANDOFF_STEPS} steps "
          f"({wh['train_s']:.1f} s, launches {wh['train_counts']}, losses "
          f"{wh['train_loss']}) → checkpoint.save {wh['params_file_gb']:.2f} "
          f"GB in {wh['save_s']:.1f} s → export_consensus "
          f"{wh['export_file_gb']:.2f} GB in {wh['export_s']:.1f} s → serve "
          f"CLI --ckpt ({wh['serve_s']:.1f} s, tokens {wh['served_tokens']}):"
          f" served params sha256 {wh['params_sha256'][:16]}… == the "
          "export's", flush=True)

    clock("end")

    def serve_row(name, replaces):
        rec = serve_timed[name]
        errs = [r["max_abs_err"] for r in serve_recs[name]]
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": cli_counts[name],
            "max_abs_err": max(errs), "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library": "F.scaled_dot_product_attention over pre-gathered "
                       "dense K/V (excludes the gather)",
            "timed_case": rec.get("case") or rec.get("shape"),
            "dtype": rec["dtype"], "bytes": rec["bytes"],
            "flops": rec["flops"],
            "max_abs_err_f32": max(r["max_abs_err"] for r in serve_recs[name]
                                   if r["dtype"] == "float32"),
            "max_err_over_tol": max(r["err_over_tol"]
                                    for r in serve_recs[name]),
            "launches_ctx1024": serve_counts[name],
            "launches_handoff": handoff["serve_counts"][name],
            "launches_moe_cli": moe_serve["cli_counts"][name],
            "launches_moe_ctx1024": moe_serve["counts"][name],
            "launches_vlm_cli": vlm_serve["cli_counts"][name],
            "launches_vlm_ctx1024": vlm_serve["counts"][name],
            "launches_ep_f32_rank0": {
                cf: peer["ranks"][0][f"ep_a_{cf}"]["counts"][name]
                for cf in EP_F32_CFS},
            "launches_ep_bf16_per_rank": [r["ep_b"]["counts"][name]
                                          for r in peer["ranks"]],
            "launches_ep_of": "phase 29: rank 0's EP-only f32 runs at "
                              f"{EP_F32_LAYERS} layers, each rank's EP + TP "
                              f"bf16 run at {peer['ranks'][0]['ep_b_layers']}",
            "launches_tp_f32_rank0": peer["ranks"][0]["tp_a"]["engine"][
                "counts"][name],
            "launches_tp_bf16_per_rank": [r["tp_b"]["engine"]["counts"][name]
                                          for r in peer["ranks"]],
            "launches_tp_of": "phase 31: each rank's engine run (f32 at "
                              f"{TP_F32_LAYERS} layers, bf16 at "
                              f"{peer['ranks'][0]['tp_b_layers']})",
            **{key: {k: serve_timed[f"{name}_{key}"].get(k) for k in (
                "case", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bytes", "flops", "host_ms", "bound_fraction",
                "n_split", "split_keys")} for key in ("hd128", "g4", "tp",
                                                     "ep_tp")},
            "bit_equal": True,
            "bit_equal_of": "the kernel's output on NaN-poisoned pools "
                            "against its output on the clean pools, every "
                            "case (against the plain version: within "
                            "max_err_over_tol of the tolerance)",
            "timing": TIMING}

    kernels = [
        {"name": "edm_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/edm_update.cu",
         "replaces": "src/repro/kernels/edm_update.py:67",
         "launches": ring_runs["eager"]["launches"]["edm_update"],
         "launches_of": "the main path with --eager (phase 4r)",
         "launches_graphed": counts["edm_update"],
         "graph_replays": ring_runs["graphed"]["graph_replays"],
         "replay_trace": gprof_main["traced"]["edm_update"],
         "max_abs_err": edm_main["max_abs_err"], "ms": edm_main["ms"],
         "plain_ms": edm_main["plain_ms"], "bound_ms": edm_main["bound_ms"],
         "bound_by": edm_main["bound_by"], "library_ms": None,
         "bit_equal": all(r["bit_equal"] for r in [edm_main, *edm_small]),
         "shape": edm_main["shape"], "gb_per_s": edm_main["gb_per_s"]},
        {"name": "gossip_axpy", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip_axpy.cu",
         "replaces": "src/repro/kernels/edm_update.py:187",
         "launches": tree_recs["edm"]["launches"]["gossip_axpy"],
         "launches_of": "the tree path, edm (phase 4t, eager)",
         "max_abs_err": axpy_main["max_abs_err"], "ms": axpy_main["ms"],
         "plain_ms": axpy_main["plain_ms"], "bound_ms": axpy_main["bound_ms"],
         "bound_by": axpy_main["bound_by"],
         "library_ms": axpy_main["library_ms"],
         "library": "torch.matmul(W, x.view(A, -1)), f32 (cuBLAS; TF32 off)",
         "library_max_abs_diff": axpy_main["library_max_abs_diff"],
         "bit_equal": all(r["bit_equal"] for r in [axpy_main, *axpy_small]),
         "shape": axpy_main["shape"], "gb_per_s": axpy_main["gb_per_s"]},
        serve_row("paged_attention", "src/repro/kernels/paged_attention.py:48"),
        serve_row("paged_prefill", "src/repro/kernels/paged_prefill.py:59"),
    ]
    decode = serve_timed["paged_attention"]
    kernels[2].update({k: decode[k] for k in ("bound_fraction", "n_split",
                                              "split_keys")})
    kernels[-1].update(
        host_ms=serve_timed["paged_prefill"]["host_ms"],
        mixed_dispatch_busy_ms=mixed["device_busy_ms"],
        mixed_dispatch_prefill_ms=mixed["buckets"]["paged_prefill kernel"])
    for fmt, line, fmt_counts in (("bf16", 100, wire_counts["bf16"]),
                                  ("int8", 118, wire_counts["int8"])):
        rec = ef_main[fmt]
        kernels.append({
            "name": f"edm_update_ef_{fmt}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/edm_update_ef.cu",
            "replaces": f"src/repro/kernels/edm_update.py:{line}",
            "launches": fmt_counts["edm_update_ef"],
            "graph_replays": wire_replays[fmt],
            "max_abs_err": max(r["max_abs_err"]
                               for r in [rec, *ef_small[fmt]]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
            "bit_equal": all(r["bit_equal"] for r in [rec, *ef_small[fmt]]),
            "shape": rec["shape"], "bytes": rec["bytes"],
            "gb_per_s": rec["gb_per_s"]})
    kernels.append({
        "name": "gossip_axpy_q8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_axpy_q8.cu",
        "replaces": "src/repro/kernels/edm_update.py:239",
        "launches": wire_counts["int8"]["gossip_axpy_q8"],
        "graph_replays": wire_replays["int8"],
        "replay_trace": gprof_wire["traced"]["gossip_axpy_q8"],
        "max_abs_err": max(r["max_abs_err"] for r in [q8_main, *q8_small]),
        "ms": q8_main["ms"], "plain_ms": q8_main["plain_ms"],
        "bound_ms": q8_main["bound_ms"], "bound_by": q8_main["bound_by"],
        "library_ms": None,
        "bit_equal": all(r["bit_equal"] for r in [q8_main, *q8_small]),
        "shape": q8_main["shape"], "bytes": q8_main["bytes"],
        "gb_per_s": q8_main["gb_per_s"]})
    fa, fb = flash_timed[("a", "bfloat16")], flash_timed[("b", "bfloat16")]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": flash_counts["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_recs),
        "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "library": f"F.scaled_dot_product_attention is_causal, enable_gqa "
                   f"({fa['library_backend']})",
        "timed_case": "a: B 4, H 15, K 5, S 2048, hd 64, causal, bf16",
        "flops": fa["flops"], "bytes": fa["bytes"],
        "max_err_over_tol": max(r["err_over_tol"] for r in flash_recs),
        "poisoned_bit_equal": all(r["poisoned_bit_equal"]
                                  for r in flash_poison),
        "bit_equal": all(r["poisoned_bit_equal"] for r in flash_poison),
        "bit_equal_of": "the kernel's output with NaN in every K/V row a "
                        "causal query cannot see against its clean output "
                        "(against the plain version: within "
                        "max_err_over_tol of the tolerance)",
        "window_b": {k: fb[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "library_backend", "flops")},
        "timing": TIMING,
        "f32": {n: {k: flash_timed[(n, "float32")][k]
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                              "library_backend")} for n in FLASH_TIMED}})
    kernels.append({
        "name": "ring_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_combine.cu",
        "replaces": "src/repro/kernels/ring_dma.py:121",
        "launches": ring_runs["eager"]["launches"]["ring_combine"],
        "launches_of": "the main path with --eager (phase 4r)",
        "launches_graphed": ring_runs["graphed"]["launches"]["ring_combine"],
        "graph_replays": ring_runs["graphed"]["graph_replays"],
        "replay_trace": gprof_main["traced"]["ring_combine"],
        "max_abs_err": max(r["max_abs_err"] for r in [ring_main,
                                                      *ring_small]),
        "ms": ring_main["ms"], "plain_ms": ring_main["plain_ms"],
        "bound_ms": ring_main["bound_ms"], "bound_by": ring_main["bound_by"],
        "library_ms": ring_main["library_ms"],
        "library": "torch.matmul(W, x.view(A, -1)), f32 (cuBLAS; TF32 off)",
        "library_max_abs_diff": ring_main["library_max_abs_diff"],
        "bit_equal": all(r["bit_equal"] for r in [ring_main, *ring_small])
        and ring_twin["bit_equal"],
        "shape": ring_main["shape"], "bytes": ring_main["bytes"],
        "gb_per_s": ring_main["gb_per_s"], "timing": TIMING})
    kernels.append({
        "name": "table_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/table_combine.cu",
        "replaces": "src/repro/kernels/edm_update.py:187",
        "launches": churn["launches"]["table_combine"],
        "launches_of": "the churn cell, graphed (phase 12: the degraded "
                       "epoch's eager first step)",
        "graph_replays": churn["graph_replays"],
        "replay_trace": churn["traces"]["degraded_replay"]["table_combine"],
        "launches_straggler": overlap["straggler"]["launches"][
            "table_combine"],
        "max_abs_err": max(r["max_abs_err"] for r in table_recs),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"],
        "library": "torch.matmul(W_eff, x.view(A, -1)), f32 (cuBLAS; TF32 "
                   "off)",
        "library_max_abs_diff": tm["library_max_abs_diff"],
        "bit_equal": all(r["bit_equal"] for r in table_recs),
        "timed_case": tm["case"], "shape": tm["shape"],
        "bytes": tm["bytes"], "gb_per_s": tm["gb_per_s"], "timing": TIMING})
    pr = peer["ranks"]
    kernels.append({
        "name": "ring_peer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_peer.cu",
        "replaces": "src/repro/kernels/ring_dma.py:121",
        "launches": sum(r["launches"]["ring_peer"] for r in pr),
        "launches_of": f"phase 25: {PEER_RANKS} ranks × {PEER_STEPS} steps "
                       "of the multi-rank bus step (each rank's count)",
        "launches_per_rank": [r["launches"]["ring_peer"] for r in pr],
        "max_abs_err": max(r["max_abs_err"] for r in pr),
        "ms": statistics.median(r["ms"] for r in pr),
        "ms_per_rank": [r["ms"] for r in pr],
        "plain_ms": statistics.median(r["plain_ms"] for r in pr),
        "bound_ms": pr[0]["bound_ms"], "bound_by": pr[0]["bound_by"],
        "library_ms": statistics.median(r["library_ms"] for r in pr),
        "library": "torch.matmul(w, stack of the three payloads), f32 "
                   "(cuBLAS; TF32 off; the neighbours' payloads copied "
                   "first)",
        "library_max_abs_diff": max(r["library_max_abs_diff"] for r in pr),
        "bit_equal": all(r["bit_equal"] for r in pr),
        "shape": pr[0]["bus"], "bytes": pr[0]["bytes"],
        "traced_in_rank0_profiled_step": pr[0]["traced"]["ring_peer"],
        "launches_phase26": {
            t: [r[f"{t}_launches"].get("ring_peer", 0) for r in pr]
            for t in ("overlap", "groups")},
        "timing": TIMING + "; one rank timed at a time, the others idle"})
    kernels.append({
        "name": "table_peer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/table_peer.cu",
        "replaces": "src/repro/kernels/edm_update.py:187",
        "launches": sum(r[f"{t}_launches"].get("table_peer", 0)
                        for r in pr for t in ("overlap", "groups")),
        "launches_of": f"phase 26: {PEER_RANKS} ranks × ({PEER_STEPS} "
                       f"delayed steps, a slot late at step 1; "
                       f"{GROUP_STEPS} grouped steps)",
        "launches_per_rank": {
            t: [r[f"{t}_launches"].get("table_peer", 0) for r in pr]
            for t in ("overlap", "groups")},
        "max_abs_err": max(c["max_abs_err"] for r in pr
                           for c in r["table_cases"].values()),
        "ms": statistics.median(r["table_ms"] for r in pr),
        "ms_per_rank": [r["table_ms"] for r in pr],
        "plain_ms": statistics.median(r["table_plain_ms"] for r in pr),
        "bound_ms": pr[0]["table_bound_ms"],
        "bound_by": pr[0]["table_bound_by"],
        "library_ms": statistics.median(r["table_library_ms"] for r in pr),
        "library": "torch.matmul(w, stack of the read payloads), f32 "
                   "(cuBLAS; TF32 off; the payloads copied first)",
        "library_max_abs_diff": max(r["table_library_max_abs_diff"]
                                    for r in pr),
        "bit_equal": all(c["bit_equal"] for r in pr
                         for c in r["table_cases"].values()),
        "cases": list(TABLE_CASES), "timed_case": "ring",
        "shape": pr[0]["bus"], "bytes": pr[0]["table_bytes"],
        "timing": TIMING + "; one rank timed at a time, the others idle",
        # phase 28: the bf16 wire's and the f32 agent blocks' forms
        "forms": {f: form_summary(pr, f) for f in ("bf16", "block")}})
    kernels.append({
        "name": "table_peer_q8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/table_peer_q8.cu",
        "replaces": "src/repro/kernels/edm_update.py:239",
        "launches": sum(n for v in wire_launches(pr, "table_peer_q8").values()
                        for n in v),
        "launches_of": "phase 28: the int8 runs of WIRE_RUNS (each member "
                       "rank's count, summed)",
        **form_summary(pr, "q8"),
        "max_abs_err": max(c["max_abs_err"] for r in pr
                           for f in ("q8", "q8_block")
                           for c in r["forms"].get(f, {}).get(
                               "cases", {}).values()),
        "bit_equal": all(c["bit_equal"] for r in pr
                         for f in ("q8", "q8_block")
                         for c in r["forms"].get(f, {}).get(
                             "cases", {}).values()),
        "cases": list(TABLE_CASES), "timed_case": "ring",
        "timing": TIMING + "; one rank timed at a time, the others idle"})
    for rec in kernels:
        name = rec["name"]
        counter = ("edm_update_ef" if name.startswith("edm_update_ef")
                   else name)
        if counter in ("edm_update", "edm_update_ef", "ring_peer",
                       "table_peer", "table_peer_q8"):
            # phase 28: each run's member ranks' launches
            rec["launches_phase28"] = wire_launches(pr, counter)
        if name in ("edm_update", "ring_peer", "table_peer"):
            # phase 27: the tree path across ranks, each rank's launches
            rec["launches_phase27"] = {
                what: [sum(s_.get(name, 0) for s_ in r[f"tree_{what}_step_launches"])
                       for r in pr] for what in TREE_RUNS}
        if name in ("edm_update", "ring_peer", "table_peer"):
            # phase 33: the tree under tensor parallelism on (2, 2), each
            # rank's launches over its steps
            rec["launches_phase33"] = [r["tpt_launches"].get(name, 0)
                                       for r in pr]
        if name in ("edm_update", "table_peer"):
            # phase 30: the tree with two agents a rank, each member
            # rank's launches
            rec["launches_phase30"] = {
                what: [r[f"tree_block_{what}_launches"].get(name, 0)
                       for r in pr if r["tree_block_member"]]
                for what in TREE_BLOCK_RUNS}
        if name in ("edm_update", "gossip_axpy", "gossip_axpy_q8",
                    "ring_combine"):
            # the grouped cell (phase 14): the eager first step of each
            # graph key, and one even and one odd replay's device trace
            rec["launches_grouped"] = groups["launches"].get(name, 0)
            rec["replay_trace_grouped"] = {
                p: groups["replays"][p]["traced"].get(name, 0)
                for p in ("even", "odd")}
        if name in strided:
            rec["strided"] = strided[name]
        if name in ("edm_update", "ring_combine"):
            # phase 16: the eager first step of each graphed MoE run, and
            # one replay's device trace
            rec["launches_moe_train"] = {
                g: moe_train[g]["launches"].get(name, 0)
                for g in ("moe", "ungrouped")}
            rec["replay_trace_moe_train"] = {
                g: moe_train[g]["traced_replay"].get(name, 0)
                for g in ("moe", "ungrouped")}
            # phase 18: the same for the SSM runs, and the kernel timed
            # on their bus
            rec["launches_ssm_train"] = {
                g: ssm_train[g]["launches"].get(name, 0)
                for g in ("ssm", "ungrouped")}
            rec["replay_trace_ssm_train"] = {
                g: ssm_train[g]["traced_replay"].get(name, 0)
                for g in ("ssm", "ungrouped")}
            rec["ssm_bus"] = ssm_train["kernels"][name]
            # phases 20 and 22: the VLM and hybrid runs, and the kernel
            # timed on the hybrid bus
            rec["launches_vlm_train"] = vlm_train["ungrouped"][
                "launches"].get(name, 0)
            rec["replay_trace_vlm_train"] = vlm_train["ungrouped"][
                "traced_replay"].get(name, 0)
            rec["launches_hybrid_train"] = {
                g: hybrid_train[g]["launches"].get(name, 0)
                for g in (HYBRID_GROUPS, "ungrouped")}
            rec["replay_trace_hybrid_train"] = {
                g: hybrid_train[g]["traced_replay"].get(name, 0)
                for g in (HYBRID_GROUPS, "ungrouped")}
            rec["hybrid_bus"] = hybrid_train["kernels"][name]
            # phase 24: the whisper run and its hand-off's CLI run
            rec["launches_whisper_train"] = whisper_train["ungrouped"][
                "launches"].get(name, 0)
            rec["replay_trace_whisper_train"] = whisper_train["ungrouped"][
                "traced_replay"].get(name, 0)
            rec["launches_whisper_handoff"] = whisper_train["handoff"][
                "train_counts"].get(name, 0)
    print(f"[done] {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

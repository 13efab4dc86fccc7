#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, one
   process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card, at the
   paper's §7.1 width (N=1,000,000 events, C=100 campaigns, S=32 designs),
   from a fresh and from a mid-day state, under both pricing rules:
   ``round_fused`` and ``sweep_partials`` (partials at rtol 1e-5),
   ``sweep_resolve`` (winners and prices bitwise, sums at rtol 1e-5, atol
   1e-6·max; its (S, N, C)-mask form at N=65,536, C=64, S=8),
   ``segment_partials`` (bitwise the plain version on the CPU),
   ``auction_resolve`` on the day's own embeddings (EmbTile) and on its
   valuation matrix (MatrixTile), each with a (C,) and an (N, C) mask and
   a reserve (winners and prices bitwise; sums at rtol 1e-5, and
   MatrixTile's bitwise the plain version on the CPU), ``first_crossing``
   of the 32 resolved lanes (cap times bitwise the plain version on the
   card and, for one lane, on the CPU, with the spends and caps only;
   spends bitwise the CPU; each call's device kernels traced and printed
   by name at 32 lanes and one lane, both modes) and
   ``capped_scan`` at N=65,536, C=64, S=8 with a reserve, a zero budget and
   a zero multiplier, and at N=4,096, S=4 with C=257 and C=1,000, past the
   first design's 256 campaigns (bitwise the plain version on the card);
   and the resolve core of ``sweep_partials`` and ``sweep_resolve``
   (``csrc/lane_resolve.cuh``) at its edges (``PARTIALS_EDGES``,
   ``SWEEP_RESOLVE_EDGES``: windows starting and ending inside a tile,
   inside one canonical block, on block edges, retired lanes, an offset
   slice, a resumable fold's slab from a mid-block offset to the log's end,
   S no multiple of the lanes per item, C of 1, 100, 129 and either
   side of the 8-lane item's shared memory, a per-event mask), bitwise
   the plain versions on the CPU under both pricing rules;
   ``segment_resolve`` at hand-built edge tables (``SEGMENT_EDGES``:
   boundaries on tile edges, duplicates, caps at event 1 and N, masks in
   no order, N of 1 and 129, S=33), bitwise the plain version on the CPU;
   ``vi`` (Algorithm 4 in one launch) at ``simulate``'s full shape (1%
   sample, 20 epochs of 64 rows), both rules and couplings, bitwise the
   plain loop on the CPU on the same draws, and at S=32 on the
   per-scenario warm start's 10% sample cut to ``VI_SWEEP_CPU_EPOCHS``
   epoch(s), its lanes ``VI_SWEEP_CPU_LANES`` bitwise the CPU's lane loop
   (the lanes are independent on the CPU); then timed alone at the full
   warm start (S=32, 80 epochs);
3. hold the fused-round sweep on the card against the plain torch sweep on
   the CPU at a reduced size (N=65,536, C=64, S=8): every integer output
   equal, spends at rtol 1e-6;
4. run the main path, ``CounterfactualEngine.sweep(grid,
   method="parallel")`` with ``resolve="auto"``, at full width for both
   pricing rules; the launch counters show it went through the fused
   kernels, a second run must give the same bits, the torch path on the
   card (its partials through ``segment_partials``) must give the same six
   outputs bit for bit, and one lane per rule must be bitwise the torch path
   on the CPU;
5. run the exact replay, ``engine.sweep(grid, method="sequential")``, at
   full width for both rules: one ``capped_scan`` launch each, a second
   launch gives the same bits, the first 65,536 events of lane 0
   (first price) and lane 31 (second price) are bitwise the plain version
   on the CPU, and every lane at full width is the exact replay: its events
   resolved against its own cap times (MatrixTile, an (N, C) mask) give its
   winners and prices, ``first_crossing``'s flat sums its spends, and each
   campaign's sequential cumsum on the host reaches the budget at its cap
   time;
6. three back-ends, one answer: ``sweep_state_machine`` with ``resolve`` in
   ``"torch"``, ``"sweep_resolve"`` and ``"fused"`` gives identical six
   outputs at full width for both rules; the counters show
   ``"sweep_resolve"`` launched ``sweep_resolve`` once a round and
   ``segment_partials`` twice; ``engine.simulate(method="parallel")`` of
   lane 0's design equals lane 0 for each back-end; at C=12,269, one past
   the first partials kernel's limit (``OLD_RF_LIMIT``), the fused round
   runs it; and at a C one past the round kernels' shared memory (512
   events, S=4, both rules) ``engine.sweep(method="parallel")`` with
   ``resolve="auto"`` resolves every lane of a round with one
   ``auction_resolve`` launch and one merge of its campaign chunks (the
   counters equal the rounds, counted by the same sweep on the CPU) and its
   partials with ``segment_partials``, and no round kernel; both to the
   CPU's bits. The matrix kernel at that shape, S=4 and S=1, is bitwise its
   plain version on the card and the CPU; its resolve and merge launches
   are timed (and traced for their device time); at N=65,536, C=16,384,
   S=32 (``ANY_C_DAY``) its one launch is timed against 32 one-lane
   launches, beside its byte bound and issue floor, three lanes bitwise
   the plain version;
7. the paper's comparison: Algorithm 2 against the exact replay, per lane,
   in mean relative spend error (each < 0.08), capped campaigns and cap-time
   shift, and both sweeps' wall times;
8. SORT2AGGREGATE at full width for both rules: ``engine.simulate()``
   (default method and settings: Algorithm 4, the refinement, the
   aggregate pass) and ``engine.sweep(grid, method="sort2aggregate")`` with
   the base design's warm start; the counters show both went through
   ``auction_resolve`` and ``first_crossing`` and nothing else, no
   ``index_add_`` ran, a second run gives the same bits, and at N=65,536,
   C=64, S=8 every output is bitwise the port on the CPU: simulate makes one
   ``vi`` launch and a ``segment_resolve`` and a ``first_crossing`` launch a
   pass, the sweep ``refine_iters + 1`` more of each (one
   ``segment_resolve`` launch a pass for all 32 lanes), no
   ``auction_resolve``, and ``first_crossing`` runs exactly 3 device kernels
   a refine pass (caps only) and 4 the aggregate pass; the sweep with ``warm_start="per_scenario"`` (10%
   sample, 80 epochs) runs in one ``vi`` launch and is timed; at the
   sweep's own cap times ``segment_resolve`` is bitwise the per-lane
   MatrixTile resolve on the gathered masks, both rules; then its
   accuracy against phase 5's exact replay, per lane, with every lane
   whose consistency gap is 0 (a self-consistent segment history) within
   a spend-weighted error of 0.02 (``tests/test_core_s2a.py``'s bound);
9. LM serving (``repro_torch.serve.ServeEngine``): (a) ``flash_attention``
   against its plain version at ``tests/test_kernels.py``'s five shapes,
   stablelm-1.6b's prefill (B=8, S=2048, H=32, dh=64, bf16), gemma3-4b's
   local layer (B=1, S=4096, H=8, KV=4, dh=256, window 1024, bf16), a
   ragged S, stablelm's prefill shape once more in float32, the bf16
   tensor-core kernel's edges (S below and just past a 128-row query
   tile, a window cutting a 64-row kv tile, GQA 8:1) and the float32
   split-TF32 kernel's (dh=32 and 256, gemma3-4b's layer, a ragged S, GQA
   8:1, windows cutting a 64- and a 32-key kv tile, B*H=65,540) (2e-5
   float32, with ``allow_tf32`` False on the plain side, 2e-2 bfloat16
   and two ulps at each row's scale; two launches bitwise equal); it times
   the kernel at the float32 prefill and both gemma3-4b shapes beside
   SDPA and the bound (in float32 that of split TF32 on the tensor
   cores, with the CUDA cores' beside it);
   (b) stablelm-1.6b at full width (24 layers, d_model 2048, vocab
   100,352, random weights from ``--seed``): 8 requests of 2,048 prompt
   tokens from seeded numpy, ``generate`` for 32 greedy tokens; exactly
   24 ``flash_attention`` launches in the prefill and none in decode, the
   same tokens on a second run, every token in ``[0, vocab)``; a traced
   prefill's busiest kernels and the attention kernel's share; (c) the
   same model cut to 2 layers on the card and on the CPU, 2 requests × 256
   tokens and 8 teacher-forced decode steps: prefill and decode logits
   within ``LM_TOL`` of their scale;
10. print the numbers: the card's name and power limit, each kernel's time
   beside its plain version's, its library yardstick's and its bound,
   ``sweep_partials`` also at a late-round pass (every lane's window the
   last half of the last canonical block) and as the mean launch of a
   traced fused sweep, the round, partials and ``sweep_resolve`` beside
   their first designs' times (``EARLIER_MS``), the scan's issue floor
   (``SCAN_INSTRUCTIONS``),
   per-round and sweep times, the SORT2AGGREGATE wall times and Algorithm
   4's share of them, the LM's prefill time, decode time per token,
   tokens/s and peak memory, ``capped_scan``'s and ``first_crossing``'s
   times beside their first designs' (``EARLIER_MS``), ``first_crossing``'s
   time at one lane (``simulate``'s shape) and at one lane of N in
   ``SMALL_N`` (small calls, bitwise the CPU), ``vi``'s time beside its
   chain floor, at simulate's shape and at the full warm start,
   ``segment_resolve`` at S=32 and at one lane, and one JSON line
   describing each kernel (``first_crossing``'s row also gives the device
   kernels its calls ran, its caps-only times, its split by device kernel
   and the flat sums' chain floor, ``chain_floor_ms``: the longest (lane,
   campaign) run of sales times ``FADD_LATENCY_CYCLES`` at the top SM
   clock; ``vi``'s its chain floor and the warm start;
   ``segment_resolve``'s its one-lane time).
   The plain capped scan is one chain of small launches per event, so it
   is timed over the first 16,384 events of the full day
   (``plain_events`` in the JSON line); every other time is at the full
   shapes;
11. chunks, naive sampling, multi-slot auctions and search at the full
   day, both rules (``chunks_phase``): (a)
   ``engine.sweep(grid, chunks=125_000)`` (8 chunks of 4 canonical
   blocks) and ``sweep_state_machine`` at 125,000 with ``resolve="auto"``
   (fused: ``2 × n_chunks`` ``sweep_partials`` launches a round, no
   ``round_fused``) and ``"sweep_resolve"``, and at 250,000: all six
   outputs bitwise phase 4's unchunked sweep; the torch back-end chunked
   at ``PAPER_SYNTHETIC_CPU`` bitwise phase 3's CPU sweep; (b)
   ``scenario_chunks=8``, alone and with ``chunks=125_000``, bitwise; (c)
   the peak device memory of the ``sweep_resolve`` sweep unchunked and at
   ``chunks=125_000``; (d) the chunked SORT2AGGREGATE sweep at
   ``crossing_block=15_625`` and chunks of 125,000 and 250,000: cap times,
   gaps and refine iterations bitwise the unchunked sweep, ``final_spend``
   bitwise across the two sizes and within 1e-4 of the flat sums,
   ``n_chunks`` ``segment_resolve`` and ``first_crossing`` launches a
   pass, caps only (3 device kernels a call); (e) ``first_crossing`` with
   a carry chunk by chunk bitwise one
   call (cap times and the running total; a chunk boundary on a crossing;
   two chunks of a lane bitwise the CPU), ``segment_resolve`` at a row
   offset bitwise the rows of a whole call and its plain version, and
   ``capped_scan`` with a scale (naive sampling's shape) bitwise its CPU
   version, each timed beside its plain version and bound (the JSON
   rows' ``carry_*``, ``offset_*`` and ``scaled_*`` keys); (f)
   ``engine.simulate(method="naive_sampling", sample_size=10_000)``: one
   ``capped_scan`` launch, bitwise the CPU's loop, its error against the
   exact replay; (g) ``aggregate_multislot`` at the full day with 3 slots
   bitwise the CPU (one ``first_crossing`` call), the multi-slot oracle and
   refinement at N=2,048 bitwise the CPU; (h) ``engine.search`` over
   reserve × budget scale (hillclimb, budget 32): the same trajectory on
   the card and the CPU over the first ``CPU_CUT_EVENTS`` events of
   ``PAPER_SYNTHETIC_CPU``, and its wall time at the full day;
12. CRN scenario families at the full day, both rules (``crn_phase``): (a)
   the day's bid-noise normals and participation uniforms, one
   ``crn_cells`` launch each, ``CRN_CHECK_ROWS`` bitwise the CPU's draws,
   naive sampling's sample drawn on the card from a key made on the CPU
   bitwise the CPU's; ``crn_cells`` and ``bid_noise`` timed beside their
   plain versions; (b) a static family of 32 lanes (pauses, boosts,
   budget scales, reserves, a full-window entrant: C=101) on ``"auto"``
   (the fused round) bitwise the family on ``resolve="torch"`` and at
   ``chunks=125_000``; paused campaigns spend 0 and never cap; one lane
   of each kind (``CRN_CPU_LANES``) at ``PAPER_SYNTHETIC_CPU`` bitwise the
   CPU; (c) a per-event family of 8 lanes (bid noise 0.2, participation
   0.9, a pacing window over the middle half, their pairs, a sigma=0 /
   p=1 lane) on ``resolve="torch"``: the last lane bitwise the base lane,
   two identical specs bitwise each other, ``chunks=125_000`` bitwise,
   bitwise the CPU over the first ``CPU_CUT_EVENTS`` events of
   ``PAPER_SYNTHETIC_CPU`` (first price), its wall time,
   ``segment_partials`` launches and peak memory above the inputs;
   ``"fused"`` refuses it with ``check_overlay``'s text; (d)
   ``engine.attribute`` over pause[3], the noise and the pacing window (8
   lanes): Shapley values and efficiency gap; (e) the warm start's VI with
   the per-event overlay, S=8 in one ``vi`` launch, bitwise the CPU's loop
   on the same inputs at ``VI_SWEEP_CPU_EPOCHS``, the kernel timed at the
   full warm start (the JSON ``vi`` row's ``overlay_*`` keys);
13. the always-on counterfactual service at the full day, both rules
   (``service_phase``): appends of 200,000 + 300,000 + 500,000 rows
   (chunks of 100,000; the second fold starts inside a canonical block)
   with two of phase 4's lanes registered for streaming; (a) the device
   store: each fold's wall, rounds and launches (the first fold's fused
   round, then two ``sweep_partials`` launches a round at the offset),
   four ``ask`` tickets in one flush, ``sweep(grid)``, a repeated sweep
   (all cache hits) and ``engine().sweep(grid)``, each bitwise phase 4's
   fused sweep; (b) the host store (pinned slabs, a copy stream): the same
   folds, answers and frontiers bitwise the device store's, the peak
   device memory of both stores' replays, the replay with ``prefetch`` on
   and off, and one streamed pass's time and bytes beside its copies alone
   and its PCIe bound; (c) a one-append frontier bitwise phase 4's sweep,
   the three-fold frontier at ``PAPER_SYNTHETIC_CPU`` on the card (both
   stores) bitwise the CPU service, the mid-block fold at full width
   bitwise the CPU's fold (first price); (d) save after two appends, load,
   append: bitwise the uninterrupted service, the save and load seconds;
   and ``sweep_partials`` at the mid-block fold's shape timed beside its
   plain version and bound (the JSON row's ``resume_*`` keys, whose
   ``resume_launches`` counts the launches of the folds resumed at a
   non-zero offset, both stores and rules; ``host_pass_*``, whose
   ``host_pass_launches`` is read from the counters around one streamed
   pass);
14. the multi-GPU placements at the full day, both rules
   (``sharded_phase``), with ``SHARDS`` event shards of 250,000 rows on
   this one card (a mesh may name a device more than once; the shards are
   views of the day): (a) ``engine.sweep(grid, driver="sharded")`` (``2 ×
   SHARDS`` ``sweep_partials`` launches a round, no ``round_fused``, no
   ``index_add_``), the ``sweep_resolve`` back-end, a 2 × 2 event ×
   scenario mesh and ``chunks=125_000`` within each shard, all six outputs
   bitwise phase 4, each wall and peak memory above the inputs; (b) the
   multihost sweep as two processes on the card over ``gloo``, each
   holding its 500,000 rows (``MULTIHOST_WORKER``; NCCL with one card a
   rank too where more cards are visible): two all-reduces a round, every
   rank's outputs bitwise phase 4; (c) the sharded SORT2AGGREGATE sweep
   with the base warm start (``estimate_pi_sharded``: one MatrixTile
   ``auction_resolve`` and one ``first_crossing`` a step; then one
   ``segment_resolve`` and one ``first_crossing`` at ``block = local_n``
   a shard a pass), its spend-weighted error against phase 5's exact
   replay and its consistency gaps, and at ``PAPER_SYNTHETIC_CPU``
   (``SHARDED_CPU_LANES`` lanes) the card bitwise the CPU at ``SHARDS``
   shards; (d) a ``CounterfactualService(placement="sharded", mesh=...)``
   whose asks and ``sweep(grid)`` are bitwise phase 4, saved and loaded
   onto 2 shards, and a log saved from ``SHARDS`` shards restored onto 2
   (the elastic restore), both sweeping bitwise phase 4; then
   ``sweep_partials`` at a shard's offset, ``first_crossing`` with a carry
   at ``block = local_n`` (also caps only, the same cap times and running
   spend; traced by kernel, its chain floor) and ``segment_resolve`` at a
   shard offset, each against its plain version and timed (the JSON rows'
   ``shard_*``, ``shard_carry_*`` and ``shard_offset_*`` keys).
15. plan tuning and the keyed days (``tune_phase``): (a) the §7.1 day
   built on the card from ``prng.PRNGKey(seed)``, its first, last full and
   last blocks bitwise the CPU's keyed build; (b) ``engine.tune(grid)``
   at S=32 for the fused and ``sweep_resolve`` back-ends, both rules, each
   candidate's predicted and paired times and the winner, then
   ``sweep(tuned=True)`` / ``block_t="auto"`` bitwise phase 4 with the
   concrete plan's launches, a ``CounterfactualService(tuned=True)``
   answering bitwise phase 4 before and after its ``tune()``, a host
   store's ``tune()`` refused, the cost model's full-day seconds beside
   phase 4's walls and the host time of one launch; (c) the Yahoo-like day
   pair of §7.2 (``PAPER_YAHOO_FULL``) built on the card from a key,
   bitwise the CPU's build, both exact replays (one ``capped_scan`` launch
   each) and the warm-started SORT2AGGREGATE (only ``segment_resolve`` and
   ``first_crossing`` launches) with the fig. 6 errors, and the whole
   pipeline at ``PAPER_YAHOO_CPU`` (its days cut to half their auctions)
   bitwise the CPU's;
16. the MoE and recurrent language models (``mixers_phase``), random
   weights from ``--seed``, each through ``ServeEngine.generate`` at full
   width with 8 requests of 2,048 prompt tokens and 32 greedy tokens:
   granite-moe-3b-a800m whole (32 attention + MoE layers, 40 experts
   top-8), xlstm-125m whole (10 mLSTM and 2 sLSTM layers), mixtral-8x7b
   cut to 4 of its 32 layers and jamba-v0.1-52b to its first 5 (4 mamba
   layers, 2 of them MoE, and its attention layer; ``MIXER_MODELS``: the
   whole of either does not fit the card's 80 GB).
   Each prefill makes exactly one ``flash_attention`` launch an attention
   layer and decode none; the tokens lie in the vocabulary and a second
   run gives the same; the prefill is traced, its device time split into
   attention and the rest (the MoE products and dispatch, the mamba scan,
   the sLSTM loop). Then each cut to 2 layers at full width (jamba's
   mamba and mamba + MoE), xlstm to its first 6 (5 mLSTM and an sLSTM),
   runs on the card and on the CPU (2 requests of 256 tokens, 8
   teacher-forced decode steps), twice: as served, bfloat16 logits within
   ``LM_TOL`` for granite and mixtral and printed beside it for jamba and
   xlstm (rounding alone reaches it there), then cast to float32, logits
   within ``F32_TOL`` for all four. Where the CPU's
   MoE routing differs from the card's at a token whose probabilities
   drift less than ``ROUTE_DRIFT`` between them (a near tie), the CPU
   takes the card's experts and the tie is printed with its layer and
   token; a larger drift fails.
17. the encoder-decoder, the patch prefix and sampling (``encdec_phase``),
   random weights from ``--seed``, each through ``ServeEngine.generate``
   at full width with 8 requests and 32 greedy tokens (``ENCDEC_MODELS``):
   whisper-small whole (12 encoder + 12 decoder layers) on 1,500 frames a
   request (seeded normal frame embeddings: the frontend is a stub) and a
   224-token decoder prompt, and internvl2-76b cut to 8 of its 80 layers
   (the whole is ~141 GB of bfloat16) on 256 patch embeddings + 1,792
   tokens. Each prefill makes exactly one ``flash_attention`` launch a
   layer (whisper's 12 encoder launches, checked alone, not causal: S =
   1,500, ragged against both kernels' tiles) and decode none; the
   tokens lie in the vocabulary, a second run gives the same, and they
   are the argmax loop's with any key; the prefill is traced, its device
   time split into attention, products and the rest. On whisper,
   sampling at temperature 0.7: one key gives the same tokens twice,
   another key others, and ``_sample`` on the card is bit for bit the
   CPU's on the same bfloat16 logits and keys. Then each cut to 2 layers
   (2 + 2 for whisper) at full width, all frames and patches, a shorter
   text, runs on the card and on the CPU (2 requests, 8 teacher-forced
   decode steps), as served (bfloat16 logits within ``LM_TOL``) and as
   float32 twins (within ``F32_TOL``; the frames and patches float32 in
   both). Phase 9 (a) holds and times the kernel at phase 17's shapes in
   both types: whisper's encoder (B=8, S=1,500, H=12, dh=64, not causal)
   and internvl2's prefill (B=8, S=2,048, H=64, KV=8, dh=128).
18. training (``train_phase``): (a) the flash-attention backward kernel
   (``csrc/flash_attention_bwd.cu``) against its plain version on the
   card, dq, dk and dv from the same q, k, v, output, output gradient and
   the forward kernel's logsumexp, at the training shapes
   (``BWD_SHAPES``: stablelm-1.6b's microbatch, granite-moe-3b's GQA,
   gemma3-4b's dh=256 window layer, whisper-small's encoder, not causal
   and ragged, internvl2-76b's GQA 8:1 at dh=128) in bfloat16 (the
   ``mma.sync`` kernels; max |diff| over max |plain| within 2e-2, and
   within ``BWD_MIRROR_TOL`` of ``ref.attention_bwd_bf16_ref``, the mirror
   of their roundings of P and dS) and at two of them in float32 (the
   CUDA-core kernels; 1e-4); a second launch gives the same bits; each
   bfloat16 shape timed against its plain version, its bound (five
   products at the bf16 tensor-core peak), the design's floor (seven) and
   SDPA's backward (``torch.autograd.grad`` through
   ``scaled_dot_product_attention``; timed only). (b) stablelm-1.6b at
   full width (24 layers, d=2,048, ~1.64 B parameters of float32 masters,
   ~26 GB of float32 state) through ``init_state``,
   ``make_train_step(microbatches=2)`` and ``pipeline_for(seq_len=2048,
   global_batch=8)``: a warm-up step and 3 timed steps, each launching
   exactly 2 x 24 x 2 ``flash_attention`` (forward and recompute, each
   microbatch) and 24 x 2 ``flash_attention_bwd``, all of them on the
   tensor-core route (``TENSOR_CORE_LAUNCHES``), the loss finite; a traced
   step splits the backward's time by kernel; a second run from the same
   seed gives the same parameters and losses bit for bit. (c) the reduced configs of stablelm-1.6b, granite-moe-3b,
   whisper-small and internvl2-76b on the card against the CPU from the
   same state (``TRAIN_CPU_ARCHS``), computing in bfloat16 and as float32
   twins: the loss and every parameter's gradient within ``TRAIN_TOLS``,
   then one AdamW step; the MoE routing of the CPU's forward and of its
   backward's recompute is recorded and followed on the card at near ties.
   (d) ``train_loop`` on the card at reduced
   stablelm-1.6b with a ``FailureInjector`` at step 3 and a checkpoint
   every 2 steps: the losses after the restart and the final state are an
   uninterrupted run's bit for bit.
19. training the recurrent mixers and ``comm`` (``mixers_train_phase``):
   (a) xlstm-125m uncut (12 layers, d=768: mLSTM and sLSTM) and
   jamba-v0.1-52b at full width cut to its first layer (mamba with
   d_in=8,192 and a dense MLP, ~0.82 B parameters of float32 masters), 8 x
   2,048 tokens a step in 1 and 2 microbatches: a warm-up step and 2 timed
   steps launching no hand-written kernel, the loss finite, peak memory,
   and a traced step's device time split into the mixers' recurrences
   (marked on the stream by ``ScanMarks``), the other products and the
   rest; (b) one period of each, reduced (jamba's 8 layers with its
   attention layer, whose flash forward and backward kernels must launch
   once each a loss; xlstm's 6 with its sLSTM), on the card against the
   CPU in both compute dtypes, as 18 (c) but without the per-block
   recompute (``MIXER_TRAIN_TOLS``); (c)
   ``train_loop``'s failure and restart at reduced xlstm-125m, bit for bit
   as 18 (d); (d) ``comm.ring_all_reduce_mean`` and
   ``compressed_all_reduce_mean`` over two gloo processes on the card and
   two on the CPU, a 16 M-float leaf a rank: within float32 rounding and
   the int8 quantisation's error of the exact mean, the card's bitwise the
   CPU's;
20. the dry run (``dryrun_phase``; ``repro_torch.launch.dryrun``, counted
   on the ``meta`` device): (a) stablelm-1.6b at phase 18 (b)'s shape on a
   1×1 logical mesh, its product FLOPs within [6, 8]·N·D plus attention,
   its roofline terms printed beside 18 (b)'s measured median step; (b)
   the production cell ``single_stablelm-1.6b_train_4k`` (status ``ok``,
   finite terms); (c) the hill climb's cell 3 baseline; no kernel
   launched and no card memory allocated. Records in ``build/``.

Every check raises on failure and nothing is caught, so any failure exits
non-zero. The last line is the JSON result. Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, it exits 2
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
PCIE_BYTES_PER_S = 64e9         # PCIe 5.0 x16, one direction
FP32_OPS_PER_S = 67e12          # H100 SXM fp32, non-tensor (data sheet)
# 32-bit integer add, logic and shift issue at 64 a cycle an SM on Hopper
# (half the float32 rate); the rate is this times the SMs and the max clock
INT32_LANES_PER_SM = 64
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 tensor cores, dense
GRID_AXES = dict(bid_scales=(1.0, 0.9, 1.1, 1.3), reserves=(0.0, 0.05),
                 budget_scales=(1.0, 0.8, 1.25, 1.5))
SMALL_AXES = dict(bid_scales=(1.0, 1.2), reserves=(0.0, 0.05),
                  budget_scales=(1.0, 0.5))
KINDS = ("first_price", "second_price")
RESOLVES = ("torch", "sweep_resolve", "fused")
OUTPUTS = ("final_spend", "cap_times", "retired", "boundaries", "num_rounds",
           "n_hat")
PREFIX = 65_536                 # events of the exact replay checked on the CPU
WIDE_CAMPAIGNS = (257, 1000)    # capped_scan past the first design's limit
WIDE_EVENTS = 4096
# the first designs' times, measured by this script on an NVIDIA H100 80GB
# HBM3 at 700 W before their redesign, printed beside this run's
EARLIER_MS = {"capped_scan": 437.2258, "first_crossing": 77.9087,
              "round_fused": 4.3255, "sweep_partials": 2.6350,
              "sweep_resolve": 3.4829,
              # one lane at the any-C back-end's shape; the float32
              # prefill on CUDA cores
              "auction_resolve": 2.3959, "flash_attention_f32": 6.2775,
              # the first partials kernel's total in a traced fused sweep
              # (176 launches)
              "sweep_partials_traced": 314.881}
OLD_RF_LIMIT = 12_268           # the first partials kernel's largest C
# per (lane, row, campaign), the resolve core's scan issues a multiply, a
# compare and two selects (first price; a max and a select more for second
# price) and, at 8 lanes an item, (1 + 8) / 32 shared loads: the issue
# floor is these over 128 thread-instructions a cycle on every SM
SCAN_INSTRUCTIONS = {"first_price": 4 + 9 / 32, "second_price": 6 + 9 / 32}
# the resolve core's edges (phase 2), against the plain versions on the
# CPU: name, S, N, C, windows ("t8" / "t8+1": the largest C an item of 8
# lanes holds, and one more)
PARTIALS_EDGES = (
    ("windows starting and ending inside tiles", 6, 20_000, 37, "mid_tile"),
    ("windows inside one canonical block", 5, 20_000, 100, "one_block"),
    ("windows on block edges (n_next on an edge)", 4, 20_000, 100,
     "block_edges"),
    ("retired lanes, an offset slice, S=7", 7, 20_000, 129,
     "retired_offset"),
    ("C=1", 9, 5_000, 1, "mid_tile"),
    ("C=100, S=32", 32, 8_000, 100, "mid_tile"),
    ("C=129", 3, 5_000, 129, "retired_offset"),
    ("C=t8", 8, 3_000, "t8", "mid_tile"),
    ("C=t8+1", 8, 3_000, "t8+1", "mid_tile"),
    ("a resumable fold: the slab from a mid-block offset to the log's end",
     6, 20_000, 100, "resume"),
)
SWEEP_RESOLVE_EDGES = (   # name, S, N, C, per-event mask
    ("N below one tile", 3, 100, 37, False),
    ("ragged N, S=5", 5, 1_001, 100, False),
    ("C=1", 9, 3_000, 1, False),
    ("C=129, per-event mask", 4, 2_000, 129, True),
    ("C=t8", 8, 1_500, "t8", False),
    ("C=t8+1", 8, 1_500, "t8+1", False),
)
PLAIN_EVENTS = 16_384           # events of the plain capped scan timed on card
# Algorithm 4 as simulate runs it (a 1% sample, 20 epochs of 64 rows) and as
# the per-scenario warm start does (10%, 80 epochs, decayed steps); the S=32
# sweep's comparison with the CPU is cut to VI_SWEEP_CPU_EPOCHS epochs and
# to VI_SWEEP_CPU_LANES of its 32 lanes (the card still runs all 32 in one
# launch; the CPU's loop took ~18 s a rule for all of them)
VI_SIMULATE = dict(sample_rate=0.01, num_iters=20, batch_size=64,
                   eta_decay=0.0)
VI_WARM = dict(sample_rate=0.1, num_iters=80, batch_size=64, eta_decay=0.05)
VI_SWEEP_CPU_EPOCHS = 1
VI_SWEEP_CPU_LANES = (0, 7, 20, 31)
# per (row, campaign) a vi step's scan issues a compare of the uniform with
# pi, a select, a multiply, a compare with the best bid and a select: a
# dependent step on one SM takes at least B*C*5/128 cycles (the chain floor)
VI_SCAN_INSTRUCTIONS = 5
# per (lane, event, campaign) segment_resolve's scan issues at least a
# multiply and a max (first price, as timed): its issue floor at one
# instruction a thread a cycle on every SM
SEGMENT_SCAN_INSTRUCTIONS = 2
# segment_resolve's hand-built edges (phase 2), against the plain version on
# the CPU: name, table, S, N, C
SEGMENT_EDGES = (
    ("boundaries on and beside tile edges, S=33", "tile_edges", 33, 1000,
     12),
    ("duplicate boundaries, C=100, S=33", "duplicates", 33, 3000, 100),
    ("caps at event 1 and N, never-capped campaigns, C=37", "cap_at_1_and_n",
     5, 1000, 37),
    ("hand-built, non-monotone masks, 0 and N inner, S=33", "hand_built", 33,
     1000, 12),
    ("hand-built, N=1", "hand_built", 2, 1, 12),
    ("hand-built, N=129, C=7", "hand_built", 3, 129, 7),
    ("duplicates, N=127", "duplicates", 4, 127, 100),
)
SMALL_N = (256, 1024, 8192)     # first_crossing's small calls, one lane
FC_TILE = 4096                  # first_crossing's tile: 16^3 rows
# the latency of a dependent float32 add on the SM's FP32 pipe (cycles,
# Volta through Hopper): a flat sum is one chain of them a (lane, campaign)
FADD_LATENCY_CYCLES = 4
ANY_C_EVENTS = 512              # the parallel sweep past the round kernels
# a day-sized any-C resolve (phase 6): N, C, S (4.3 GB of valuations). The
# matrix kernel's issue floor there: a thread holds ANY_C_LANES lanes of a
# row; every (lane, row, campaign) pays a multiply and a compare folded into
# the thread's any-test, every (thread, campaign) the lanes' multiplier loads
# (4 a load) and the branch on the any-test, every 4 campaigns a load of
# valuations; where the any-test fires (counted on this run's data), every
# lane of the thread takes two compares and three selects, and one
# instruction forms the column
ANY_C_DAY = (65_536, 16_384, 32)
ANY_C_LANES = 8
ANY_C_LANE_INSTRUCTIONS = 2
ANY_C_UPDATE_INSTRUCTIONS = 5
SHORT_SUM_ROWS = (1_000, 8_192)  # short resolves with sums (phase 2)
CPU_LANE = {"first_price": 0, "second_price": 31}
ORACLE_TOL = 0.08               # tests/test_core_parallel.py's bound
S2A_TOL = 0.02                  # tests/test_core_s2a.py's bound
# phase 11: event chunks of 4 and 8 canonical blocks of the day
# (reduce_block_size(1e6) = 31,250), the chunked SORT2AGGREGATE's crossing
# block (8 of them a 125,000-event chunk), naive sampling's sample (rho =
# 1%), the multi-slot oracle's reduced N
CHUNK_EVENTS = (125_000, 250_000)
S2A_CROSSING_BLOCK = 15_625
NAIVE_SAMPLE = 10_000
MULTISLOT_SMALL_N = 2_048
# phase 13: the service's appends (whole chunks of SERVICE_EPC, a multiple
# of REDUCE_BLOCKS, so the host store takes it; the second fold starts at
# 200,000 of 500,000, inside block 12 of 15,625), the grid lanes asked for
# and registered for streaming, and the three-fold comparison with the CPU
# at PAPER_SYNTHETIC_CPU (its second fold starts inside a block too)
SERVICE_EPC = 100_000
SERVICE_SLABS = (200_000, 300_000, 500_000)
SERVICE_ASK_LANES = (0, 5, 17, 31)
SERVICE_STREAM_LANES = {"base": 0, "lane21": 21}
SERVICE_SMALL_EPC = 4_096
SERVICE_SMALL_SLABS = (16_384, 20_480, 28_672)
# phase 12: CRN scenario families at the §7.1 day. The day's CRN draws are
# held against the CPU on CRN_CHECK_ROWS; the static family's 32 lanes are
# cut to one lane of each intervention kind (CRN_CPU_LANES with the base) at
# PAPER_SYNTHETIC_CPU, where the card is held against the CPU port; the
# per-event family (8 lanes) runs whole there, under the first rule (the
# CPU's masked resolves take ~20 s a rule). The warm start's VI with the
# per-event overlay is held against the CPU's loop at VI_SWEEP_CPU_EPOCHS
CRN_CHECK_ROWS = ((0, 16_384), (500_000, 516_384))
CRN_CPU_LANES = 8
# events of PAPER_SYNTHETIC_CPU over which phase 11's search and phase 12's
# per-event family are held against the CPU (~9 s and ~10 s there)
CPU_CUT_EVENTS = 32_768
# phase 14: event shards of the day on one card (a mesh may name a device
# more than once), and the lanes of the small sharded S2A sweep held
# against the CPU
SHARDS = 4
SHARDED_CPU_LANES = 4
# phase 15: the keyed day's blocks (repro's default); the tuner measures on
# half the day, whose canonical blocks (15,625 rows) divide every chunk
# size of the day's lattice (a cut to 125,000 rows made every chunk
# candidate illegal), with fewer trials than its defaults; the launches
# timed for the roofline's dispatch_us
KEYED_BLOCK = 65_536
# the Yahoo pipeline's CPU check: PAPER_YAHOO_CPU's days cut to half their
# auctions (the same 1,000 keywords and C; the budget halved with the
# volume), for the script's time
YAHOO_CPU_CUT = 2
TUNE_EVENTS = 500_000
TUNE_TRIALS = (1, 3)            # quick, full
DISPATCH_CALLS = 200
# operations a cell of crn_cells, (32-bit integer, float32): three
# Threefry hashes (20 rounds of an add, a rotate and a xor, 5 key
# injections of three adds, the key schedule's two xors: 77 each) and the
# mantissa transform's shift and or, all integer; the transform's subtract
# and scale (2) and the uniform's multiply-add and clamp (2); a normal adds
# -x*x (1), both branches of log1p (24 and 20) and the select (1), erf_inv's
# compare, subtract and square root (4), its coefficient selects, 8
# multiply-adds and the end point test (18) and the scale (1). The integer
# ones go at the integer rate (INT32_LANES_PER_SM), the float32 ones at the
# float32 rate (bound_ms)
CRN_CELL_OPS = {"uniform": (3 * 77 + 2, 2 + 2),
                "normal": (3 * 77 + 2, 2 + 2 + 1 + 45 + 4 + 18 + 1)}
# bid_noise a cell: sigma * z, exp's two clamps, floor, two clamps, 7
# multiply-adds, r * r, the add of 1, the exponent's three integer
# operations, the scale, the flush test and select, and the final multiply
BID_NOISE_OPS = 1 + 2 + 1 + 2 + 7 + 1 + 1 + 3 + 1 + 2 + 1
KERNELS = (   # name, CUDA source, the TPU kernel (or XLA op) it replaces
    ("round_fused", "src/repro_torch/csrc/round_fused.cu",
     "src/repro/kernels/auction_resolve/round_fused.py:197"),
    ("sweep_partials", "src/repro_torch/csrc/round_fused.cu",
     "src/repro/kernels/auction_resolve/round_fused.py:301"),
    ("sweep_resolve", "src/repro_torch/csrc/sweep_resolve.cu",
     "src/repro/kernels/auction_resolve/sweep_resolve.py:81"),
    ("capped_scan", "src/repro_torch/csrc/capped_scan.cu",
     "src/repro/kernels/capped_scan/capped_scan.py:75"),
    ("segment_partials", "src/repro_torch/csrc/segment_partials.cu",
     "src/repro/core/segments.py:130"),
    ("auction_resolve", "src/repro_torch/csrc/auction_resolve.cu",
     "src/repro/kernels/auction_resolve/auction_resolve.py:80"),
    # the matrix kernel's second launch: its campaign chunks merged
    ("auction_resolve_merge", "src/repro_torch/csrc/auction_resolve.cu",
     "src/repro/kernels/auction_resolve/auction_resolve.py:80"),
    ("first_crossing", "src/repro_torch/csrc/first_crossing.cu",
     "src/repro/core/segments.py:68"),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/flash_attention.py:82"),
    # auction_resolve_pallas's counterpart redesigned for its two uses on
    # SORT2AGGREGATE's path: Algorithm 4's batches and the segment replays
    ("vi", "src/repro_torch/csrc/vi.cu",
     "src/repro/kernels/auction_resolve/auction_resolve.py:80"),
    ("segment_resolve", "src/repro_torch/csrc/segment_resolve.cu",
     "src/repro/kernels/auction_resolve/auction_resolve.py:80"),
    # no Pallas: the CRN draws (jax.random.normal and uniform of every
    # (event, campaign) cell) and the bid noise's fused v * exp(sigma * z)
    ("crn_cells", "src/repro_torch/csrc/crn.cu", "src/repro/core/crn.py:67"),
    ("bid_noise", "src/repro_torch/csrc/crn.cu",
     "src/repro/core/executor.py:914"),
    # no Pallas: XLA's autodiff of the reference's attention (training)
    ("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:103"),
)
LM_ARCH = "stablelm-1.6b"
LM_REQUESTS, LM_PROMPT, LM_STEPS = 8, 2048, 32
LM_CPU_LAYERS, LM_CPU_REQUESTS, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 2, 256, 8
LM_TOL = 2e-2       # card vs CPU logits, max |diff| over max |CPU|, bf16
# kernel vs plain in bfloat16: the kernel's tensor cores take the
# probabilities as two bfloat16 terms (16 significant bits; rounded once to
# bfloat16, as repro's model attention rounds them, they would move the
# output by ~u/sqrt(n) of its row's scale over n keys), so both sides are
# float32-accurate up to 2^-16 in P and round the output once: they differ
# by about one output ulp. The bound is two ulps at each row's scale, max
# |diff| <= 2^-6 * max |plain| over the row's dh values (one 64-key tile
# dropped or counted twice moves a late row of S=2048 by several percent
# of its scale)
FLASH_BF16_ROW_TOL = 2.0 ** -6
FLASH_SHAPES = (    # b, s, h, kv, dh, causal, window, dtype name
    (2, 256, 4, 2, 64, True, None, "float32"),     # tests/test_kernels.py
    (1, 512, 2, 2, 64, True, 128, "float32"),
    (2, 128, 4, 1, 32, False, None, "bfloat16"),
    (1, 384, 3, 3, 128, True, None, "float32"),
    (1, 64, 2, 2, 16, True, 16, "float32"),
    (8, 2048, 32, 32, 64, True, None, "bfloat16"),  # stablelm-1.6b prefill
    (8, 2048, 32, 32, 64, True, None, "float32"),   # its grid at f32 precision
    (1, 4096, 8, 4, 256, True, 1024, "bfloat16"),   # gemma3-4b local layer
    (2, 1000, 4, 2, 128, True, None, "bfloat16"),   # ragged S
    # the bf16 tensor-core kernel's edges: S below one 128-row query tile
    # and one past it, a window cutting a 64-row kv tile, GQA 8:1, dh=256
    (2, 40, 4, 2, 16, True, None, "bfloat16"),
    (2, 129, 4, 2, 64, True, None, "bfloat16"),
    (1, 500, 16, 2, 64, True, 77, "bfloat16"),
    (1, 300, 4, 2, 256, True, 77, "bfloat16"),
    # the float32 split-TF32 kernel's edges: dh=32 and 256, a ragged S, GQA
    # 8:1 with a window cutting a 64-key kv tile, a window cutting a 32-key
    # tile at dh=256, B*H past the old float32 grid's 65,535
    (2, 333, 8, 4, 32, False, 50, "float32"),
    (1, 4096, 8, 4, 256, True, 1024, "float32"),
    (2, 1000, 4, 2, 64, True, None, "float32"),
    (1, 500, 16, 2, 64, True, 77, "float32"),
    (1, 300, 4, 2, 256, True, 77, "float32"),
    (16385, 16, 4, 1, 64, True, None, "float32"),
    # phase 16's prefills: granite-moe-3b-a800m's GQA 3:1 at dh=64 and
    # mixtral-8x7b's 4,096 window (past S) at dh=128
    (8, 2048, 24, 8, 64, True, None, "bfloat16"),
    (8, 2048, 32, 8, 128, True, 4096, "bfloat16"),
    # phase 17's: whisper-small's encoder, bidirectional over 1,500 frames
    # (11 x 128 + 92 query rows, 23 x 64 + 28 keys), and internvl2-76b's
    # prefill of 256 patches + 1,792 tokens (GQA 8:1, dh=128), both types
    (8, 1500, 12, 12, 64, False, None, "bfloat16"),
    (8, 1500, 12, 12, 64, False, None, "float32"),
    (8, 2048, 64, 8, 128, True, None, "bfloat16"),
    (8, 2048, 64, 8, 128, True, None, "float32"),
)
# the shapes phase 9 (a) times besides stablelm's bf16 prefill: its float32
# twin (the split-TF32 kernel), gemma3-4b's dh=256 window layer in both
# types, phase 16's prefills: granite-moe-3b-a800m (GQA 3:1, dh=64) and
# mixtral-8x7b (a 4,096 window over 2,048 tokens, dh=128), and phase 17's
# in both types: whisper-small's encoder (not causal) and internvl2-76b's
# prefill
FLASH_TIMED = {(8, 2048, 32, 32, 64, True, None, "float32"): "float32 prefill",
               (1, 4096, 8, 4, 256, True, 1024, "bfloat16"): "gemma3-4b",
               (1, 4096, 8, 4, 256, True, 1024, "float32"):
                   "gemma3-4b float32",
               (8, 2048, 24, 8, 64, True, None, "bfloat16"): "granite prefill",
               (8, 2048, 32, 8, 128, True, 4096, "bfloat16"):
                   "mixtral prefill",
               (8, 1500, 12, 12, 64, False, None, "bfloat16"):
                   "whisper encoder",
               (8, 1500, 12, 12, 64, False, None, "float32"):
                   "whisper encoder float32",
               (8, 2048, 64, 8, 128, True, None, "bfloat16"):
                   "internvl2 prefill",
               (8, 2048, 64, 8, 128, True, None, "float32"):
                   "internvl2 prefill float32"}
# phase 16: arch, layers on the card (None: all of them), layers of the
# card-vs-CPU check, whether its bfloat16 logits are held within LM_TOL.
# mixtral-8x7b is ~93 GB of bfloat16 weights and jamba-v0.1-52b ~103 GB,
# over the card's 80 GB: each runs at full width, cut to keep the phase
# near two minutes (at 8 layers, jamba's one period, it took 190 s on the
# H100): mixtral to 4 layers (12.1 GB), jamba to its first 5 (4 mamba
# layers, 2 of them MoE, and its attention layer; 14.3 GB). The check cuts
# each to its first LM_CPU_LAYERS layers, and xlstm-125m to its first
# pattern of 6, so that its sLSTM (layer 5) is held at full width. Under
# rounding alone jamba's bfloat16 logits differ by up to 3 bfloat16 ulps
# of the largest (0.0157-0.0234 over seeds 0-2; 0.0166-0.0206 with every
# product a float32 GEMM), and xlstm's sLSTM recurrence, at the
# reference's initialisation, amplifies rounding to 0.11-0.17: both are
# printed beside LM_TOL, and their float32 twins held within F32_TOL
# (tools/lm_products.py floor and seeds, NVIDIA H100 80GB HBM3 at 700 W)
MIXER_MODELS = (("granite-moe-3b-a800m", None, LM_CPU_LAYERS, True),
                ("xlstm-125m", None, 6, False),
                ("mixtral-8x7b", 4, LM_CPU_LAYERS, True),
                ("jamba-v0.1-52b", 5, LM_CPU_LAYERS, False))
# card vs CPU logits of the float32 twins, max |diff| over max |CPU|: they
# read 1.5e-6 to 6.2e-6 (granite, mixtral, jamba) and 2.2e-5 to 6.4e-5
# (xlstm) over seeds 0-2 (tools/lm_products.py seeds, NVIDIA H100 80GB
# HBM3 at 700 W); a layer computing something else moves them by far more
F32_TOL = 2.0 ** -10
ROUTE_DRIFT = 2.0 ** -7     # the most a near tie's probabilities may drift
TIES_SHOWN = 4
# phase 17: arch, layers on the card (None: all), the text prompt (after
# the patches), the text prompt of the card-vs-CPU check. whisper-small
# whole (12 encoder + 12 decoder layers, 0.67 GB of bfloat16): 8 requests
# of 1,500 frames (30 s of audio each) and a 224-token decoder prompt, half
# of its 448 positions. internvl2-76b at full width cut to 8 of its 80
# layers (all 80 are ~141 GB of bfloat16, over the card's 80 GB; 8 are
# 18.0 GB, 1.71 GB a layer and 4.2 GB of embedding tables): 256 patches +
# 1,792 text tokens, a 2,048-position prompt. The check cuts each to
# LM_CPU_LAYERS layers (2 + 2 for whisper) at full width, all 1,500 frames
# and 256 patches, and shortens the text: the CPU runs both twins
ENCDEC_MODELS = (("whisper-small", None, 224, 64),
                 ("internvl2-76b", 8, 1792, 32))
SAMPLE_TEMPERATURE = 0.7
SAMPLE_KEYS = 8             # keys of the card-vs-CPU draw of _sample
# phase 18 (a): the backward kernel at the training shapes (b, s, h, kv, dh,
# causal, window, label): stablelm-1.6b's microbatch (8 rows in 2), granite-
# moe-3b's GQA 3:1, gemma3-4b's local layer (dh=256, a 1,024 window),
# whisper-small's encoder (not causal, 1,500 frames: ragged against the 64-
# row tiles) and internvl2-76b's GQA 8:1 at dh=128 (one row of 256 patches
# + 1,792 tokens); the first and fourth also in float32
BWD_SHAPES = ((4, 2048, 32, 32, 64, True, None, "stablelm-1.6b"),
              (4, 2048, 24, 8, 64, True, None, "granite-moe-3b"),
              (1, 4096, 8, 4, 256, True, 1024, "gemma3-4b local"),
              (8, 1500, 12, 12, 64, False, None, "whisper-small encoder"),
              (1, 2048, 64, 8, 128, True, None, "internvl2-76b"))
BWD_F32 = ("stablelm-1.6b", "whisper-small encoder")
# max |kernel - plain| / max |plain| of dq, dk, dv: bfloat16 rounds each
# gradient once (2^-9 of its scale) and feeds the tensor cores P and dS
# rounded once to bfloat16, float32 only the order of the sums
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the bfloat16 kernels against ref.attention_bwd_bf16_ref, the mirror of
# their roundings of P and dS, run on the card: two output ulps at each
# tensor's largest values (read <= 4.5e-3 at these shapes,
# tools/flash_bwd_designs.py on an NVIDIA H100 80GB HBM3 at 700 W)
BWD_MIRROR_TOL = 2.0 ** -6
# phase 18 (b): stablelm-1.6b at full width
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 2048, 2, 3
TRAIN_LR = 3e-4
# phase 18 (c): reduced configs on the card against the CPU, 4 rows of 64
# positions, one step at lr 1e-3. Bounds, max |card - CPU| / max |CPU|,
# per compute dtype. float32 twins: the flash kernels' split TF32 and
# CUDA-core sums against the CPU's float32 (order only); bfloat16: two
# devices' bfloat16 products and roundings, as the port is held against
# repro in tests/test_torch_train_loss.py
TRAIN_CPU_ARCHS = ("stablelm-1.6b", "granite-moe-3b-a800m", "whisper-small",
                   "internvl2-76b")
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_LR = 4, 64, 1e-3
# (loss, gradients, parameters after the step in learning rates); the
# float32 twins read 7.7e-8, 2.3e-6 and 0.031 at most (this phase on an
# NVIDIA H100 80GB HBM3 at 700 W), bfloat16 5.5e-5 and 1.3e-2, and its
# parameters up to 2 learning rates apart (printed, not held: Adam's first
# step is lr * g / (|g| + eps), so a gradient near zero whose sign differs
# moves by up to 2 lr)
TRAIN_TOLS = {"float32": (1e-6, 2e-5, 0.1), "bfloat16": (1e-3, 5e-2, None)}
# phase 18 (d): train_loop with a failure at step 3, checkpoints every 2
TRAIN_LOOP = dict(steps=6, global_batch=4, seq_len=64, ckpt_every=2,
                  log_every=100, lr=1e-3)
TRAIN_FAIL_AT = 3
# phase 19 (a): the recurrent mixers trained at full width, (arch, layers
# kept or None, microbatches): xlstm-125m uncut (12 layers, d=768; one
# microbatch, since the sLSTM's token loop runs once a microbatch) and
# jamba-v0.1-52b at full width cut to its first layer (mamba + dense MLP;
# with the next, its first MoE layer of 2.82 B parameters, the float32
# state alone is ~60 GB, and AdamW's temporaries do not fit 80 GB)
MIXER_TRAIN = (("xlstm-125m", None, 1), ("jamba-v0.1-52b", 1, 2))
MIXER_TRAIN_BATCH, MIXER_TRAIN_SEQ, MIXER_TRAIN_STEPS = 8, 2048, 2
# phase 19 (b): one period of each, reduced, on the card against the CPU
# (TRAIN_CPU_BATCH x TRAIN_CPU_SEQ, as phase 18 (c)). xlstm's gradients are
# ill-conditioned at such weights (near-zero mLSTM head contexts under the
# head norm's eps, tests/test_torch_train_mixers.py: a one-ulp change of
# the embedding table moves its float32 gradients by 3.7e-4 of their scale
# and a bfloat16 rounding of it its bfloat16 gradients by 1.5): its float32
# gradients are held within 1e-3, its bfloat16 gradients and both dtypes'
# steps printed, not held. jamba's float32 step is printed too: Adam's first
# step is lr * g / (|g| + eps), and its gradients within 2e-5 of their scale
# still moved a near-zero element 0.127 learning rates (this phase on an
# NVIDIA H100 80GB HBM3 at 700 W)
MIXER_CPU_ARCHS = (("jamba-v0.1-52b", 8), ("xlstm-125m", 6))
# leaves whose gradient cancels (the input gates' biases: shifting every
# input gate of a unit scales a memory's numerator and normaliser alike;
# exactly zero for the sLSTM, 2.6e-10 of rounding in the CPU tests): held
# against their block's largest gradient, as tests/test_torch_train_mixers.py
# holds them
CANCELLING = ("mlstm.b_i", "slstm.b_i")
MIXER_TRAIN_TOLS = {"xlstm-125m": {"float32": (1e-6, 1e-3, None),
                                   "bfloat16": (1e-3, None, None)},
                    "jamba-v0.1-52b": {"float32": (1e-6, 2e-5, None),
                                       "bfloat16": (1e-3, 5e-2, None)}}
# phase 19 (d): the all-reduce means over two gloo processes, one leaf a
# rank, on the card and on the CPU
COMM_FLOATS = 1 << 24
COMM_RUNS = (("card", "cuda"), ("CPU", "cpu"))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def cuda_ms_once(fn) -> float:
    """Milliseconds of one run of ``fn`` by CUDA events, with no warm-up
    run: for plain versions that take seconds and build nothing."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S,
             *, int_ops: float = 0, int_ops_per_s: float = 1.0,
             bytes_per_s: float = HBM_BYTES_PER_S):
    """The least time the card could take: the larger of bytes over the
    memory rate (HBM unless said) and operations over the card's peak rate
    for their type (fp32 unless said; ``int_ops`` 32-bit integer operations
    at ``int_ops_per_s``, a pipe of their own, so the slower of the two
    pipes bounds)."""
    t_bytes = n_bytes / bytes_per_s * 1e3
    t_ops = max(n_ops / ops_per_s, int_ops / int_ops_per_s) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_fires(values, mult, act, reserves, lanes):
    """How often the matrix kernel's scan leaves its fast path in a
    one-chunk launch: the (thread, campaign) pairs at which a bid of one of
    the thread's ``lanes`` lanes (consecutive lanes of one row) exceeds
    that lane's second best, the running top two starting at the reserve
    and an inactive campaign's bid NaN, as in the kernel. One column at a
    time on the card, (S, N) at once."""
    import torch
    s, n = mult.shape[0], values.shape[0]
    m = torch.where(act, mult, float("nan"))
    best = reserves[:, None].expand(s, n).clone()
    sec = best.clone()
    fires = torch.zeros((), dtype=torch.int64, device=values.device)
    for c in range(values.shape[1]):
        bid = values[:, c][None, :] * m[:, c:c + 1]
        up = bid > sec
        fires += up.view(s // lanes, lanes, n).any(1).sum()
        top = bid > best
        sec = torch.where(top, best, torch.where(up, bid, sec))
        best = torch.where(top, bid, best)
    return int(fires)


def resolve_cost(n, c, s, rows, second_price, outputs):
    """Bytes and operations of resolving ``rows`` (lane, event) pairs of an
    (N, C) matrix for S lanes: the valuation rows read once, the (S, C)
    lane inputs, the outputs written once; a multiply and a compare per
    (lane, row, campaign) (a second compare for second price)."""
    n_bytes = n * c * 4 + s * (c * 5 + 16) + outputs
    n_ops = rows * c * (3 if second_price else 2)
    return n_bytes, n_ops


def crossing_ops(winners, n, c, block=4096):
    """Operations ``first_crossing`` needs for S lanes of N events in
    crossing blocks of ``block``: inside a 4,096-row tile of a block a
    campaign's running spend changes only at its own sales and at a few
    group starts after them, so per sale an add of the scan, a test and an
    add of the flat sum, and per (lane, campaign, tile) three group-start
    tests and the six adds of the chain between tiles. The sales are this
    run's."""
    s = winners.shape[0]
    sales = int((winners >= 0).sum())
    blocks = -(-n // block)
    tiles = (blocks - 1) * -(-block // FC_TILE) + -(
        -(n - (blocks - 1) * block) // FC_TILE)
    return 3 * sales + 9 * s * c * tiles


def chain_floor_ms(winners, c: int) -> tuple[float, int]:
    """The flat sums' floor: the longest (lane, campaign) run of sales in
    the call, one dependent float32 add each (``FADD_LATENCY_CYCLES``) at
    the card's top SM clock. Returns ``(ms, the run's length)``."""
    import torch
    w = winners.reshape(-1, winners.shape[-1]).long()
    lanes = torch.arange(w.shape[0], device=w.device)[:, None]
    ids = lanes * (c + 1) + torch.where(w >= 0, w, c)
    runs = torch.bincount(ids.reshape(-1), minlength=w.shape[0] * (c + 1))
    longest = int(runs.reshape(-1, c + 1)[:, :c].max())
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    return longest * FADD_LATENCY_CYCLES / clock_hz * 1e3, longest


def fc_split(tag: str, label: str, fn, reps: int = 5) -> dict:
    """``first_crossing``'s device kernels in a call of ``fn``, traced over
    ``reps`` calls (:func:`trace`): ``{kernel: (launches a call, device ms a
    launch)}``, printed. A call launches each of its kernels once; the mean
    over the launches recorded keeps a dropped record from halving a
    kernel's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    counts: dict = {}
    by_kernel = trace(tag, f"first_crossing {label}, {reps} calls",
                      lambda: [fn() for _ in range(reps)], counts)
    split = {}
    for name, us in by_kernel.items():
        found = re.search(r"(\w+_kernel(<[^>]*>)?)", name)
        split[found.group(1) if found else name[:40]] = (
            counts[name] / reps, us / 1e3 / counts[name])
    print(f"{tag} first_crossing {label}, device kernels (launches a call, "
          f"ms a launch): " + "; ".join(
              f"{k} x{n:g} {ms:.4f}" for k, (n, ms) in split.items()),
          flush=True)
    return split


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def trace(tag: str, label: str, fn, counts: dict | None = None,
          ordered: list | None = None) -> dict:
    """Run ``fn`` under ``torch.profiler`` and print its wall time, the
    device's busy time (the sum of the kernels' own device time) and idle
    share, and the six busiest kernels. Returns the device microseconds by
    kernel name; ``counts``, if given, gets each kernel's number of
    launches, ``ordered`` every kernel's ``(name, start, device us)`` in
    the device's order. Only the kernels are recorded, no host operator
    events, and they are read from the profiler's own records, not
    through its Python events (``key_averages``): phase 19's ~3 x 10^5
    launches are then summarised in seconds, not two minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kernels = sorted(
        ((e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
         for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0),
        key=lambda k: k[1])
    totals, launches = {}, {}
    for name, _, us in kernels:
        totals[name] = totals.get(name, 0.0) + us
        launches[name] = launches.get(name, 0) + 1
    by_kernel = sorted(totals.items(), key=lambda kv: -kv[1])
    if counts is not None:
        counts.update(launches)
    if ordered is not None:
        ordered.extend(kernels)
    busy_us = sum(us for _, us in by_kernel)
    if busy_us == 0:
        print(f"{tag} traced {label}: the profiler recorded no device "
              f"time; device busy share not measured")
        return {}
    print(f"{tag} traced {label}: wall {traced_wall:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s, idle share "
          f"{1 - busy_us / 1e6 / traced_wall:.4f}")
    for key, us in by_kernel[:6]:
        print(f"    {us / 1e3:12.3f} ms  {key[:90]}")
    return dict(by_kernel)


def edge_windows(kind: str, s: int, n: int, n_blocks: int):
    """Per-lane windows of a phase-2 edge case: ``(lo, hi, alive, offset,
    n_local, block_size)``."""
    import torch
    block = -(-n // n_blocks)
    ar = torch.arange(s, dtype=torch.int64)
    alive = torch.ones(s, dtype=torch.bool)
    offset, n_local = 0, n
    if kind == "mid_tile":
        lo = 37 + ar * (n // (3 * s)) + 101 * (ar % 3)
        hi = n - 5 - ar * (n // (4 * s)) - 77 * (ar % 2)
    elif kind == "one_block":
        lo = 20 * block + 3 + ar * 7
        hi = 21 * block - 1 - ar * 5
    elif kind == "block_edges":
        lo = (ar + 1) * block
        hi = torch.clamp((ar + 3) * block, max=n)
    elif kind == "resume":
        # a fold's slab: rows from 40% of the log (inside a canonical
        # block) to its end, every lane's frontier at the offset or past it
        offset = 2 * n // 5
        n_local = n - offset
        lo = offset + 97 * (ar % 3)
        hi = torch.where(ar % 2 == 0, n, n - 1000 - 61 * ar)
    else:
        offset, n_local = 1000, n - 3000
        lo = 900 + ar * 333
        hi = n - 2500 - ar * 251
        alive = ar % 3 != 1
    return (lo.to(torch.int32), hi.to(torch.int32), alive, offset, n_local,
            block)


def coarse_inputs(s: int, n: int, c: int, seed: int, per_event: bool):
    """Valuations and multipliers on coarse grids (equal bids are common,
    so the first index's tie-break is tested), an activation and reserves,
    on the CPU."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    values = torch.randint(0, 8, (n, c), generator=gen).float() / 8
    mult = torch.tensor([0.5, 1.0, 1.5])[
        torch.randint(0, 3, (s, c), generator=gen)]
    act = torch.rand((s, n, c) if per_event else (s, c), generator=gen) < 0.8
    res = (torch.arange(s) % 4).float() / 8
    return values, mult, act, res


def core_edges(dev, ops, ref, rf_mod, n_blocks: int) -> None:
    """Phase 2's edge shapes of the resolve core: partials_kernel and
    sweep_resolve_kernel against their plain versions on the CPU, bit for
    bit, under both pricing rules."""
    import torch
    t8 = 1
    while rf_mod.item_lanes(t8 + 1) == 8:
        t8 += 1
    wide = {"t8": t8, "t8+1": t8 + 1}
    for seed, (name, s, n, c, kind) in enumerate(PARTIALS_EDGES):
        c = wide.get(c, c)
        values, mult, act, res = coarse_inputs(s, n, c, seed, False)
        lo, hi, alive, offset, n_local, block = edge_windows(kind, s, n,
                                                             n_blocks)
        v_local = values[offset:offset + n_local]
        for second in (False, True):
            got = ops.sweep_partials(
                v_local.to(dev), mult.to(dev), act.to(dev), res.to(dev),
                lo.to(dev), hi.to(dev), alive.to(dev), offset,
                n_events_global=n, reduce_blocks=n_blocks,
                second_price=second).cpu()
            want = ref.fused_partials_ref(v_local, mult, act, res, lo, hi,
                                          block_size=block,
                                          second_price=second,
                                          index_offset=offset)
            require(torch.equal(got[alive], want[alive])
                    and not got[~alive].any() and bool(got[alive].any()),
                    f"sweep_partials edge {name!r} (C={c}, second price "
                    f"{second}) differs from its plain version on the CPU")
        print(f"[2] sweep_partials edge: {name} (S={s} N={n} C={c}): "
              f"bitwise the plain version on the CPU, both rules",
              flush=True)
    for seed, (name, s, n, c, per_event) in enumerate(SWEEP_RESOLVE_EDGES):
        c = wide.get(c, c)
        values, mult, act, res = coarse_inputs(s, n, c, 100 + seed,
                                               per_event)
        for second in (False, True):
            got = ops.sweep_resolve(values.to(dev), mult.to(dev),
                                    act.to(dev), res.to(dev),
                                    second_price=second)
            want = ref.sweep_resolve_ref(values, mult, act, res,
                                         second_price=second)
            require(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                    f"sweep_resolve edge {name!r} (C={c}, second price "
                    f"{second}) differs from its plain version on the CPU")
        print(f"[2] sweep_resolve edge: {name} (S={s} N={n} C={c}): "
              f"winners, prices and sums bitwise the plain version on the "
              f"CPU, both rules", flush=True)


def segment_table(kind: str, s: int, n: int, c: int, rng):
    """A segment table of one phase-2 edge case: ``(boundaries (S, K+2)
    int32, masks (S, K+1, C) bool)``, from cap times or hand-built (sorted
    boundaries with 0 and N among the inner ones, masks in no order)."""
    import numpy as np
    import torch
    from repro_torch.core import Segments
    if kind == "hand_built":
        k = 9
        inner = np.sort(np.concatenate(
            [rng.integers(0, n + 1, (s, k - 3)),
             np.tile([0, min(128, n), n], (s, 1))], axis=1), axis=1)
        bounds = np.concatenate([np.zeros((s, 1)), inner,
                                 np.full((s, 1), n)], axis=1)
        return (torch.from_numpy(bounds.astype(np.int32)),
                torch.from_numpy(rng.uniform(size=(s, k + 1, c)) < 0.6))
    caps = rng.integers(1, n + 1, (s, c))
    if kind == "tile_edges":
        edges = np.array([128, 256, 385, 511, n - 1])
        caps = edges[rng.integers(0, len(edges), (s, c))]
    elif kind == "duplicates":
        caps = rng.choice([n // 5, n // 2, n // 2, n // 2, n - 3], (s, c))
    elif kind == "cap_at_1_and_n":
        caps[:, 0], caps[:, 1], caps[:, 2], caps[:, 3] = 1, n, n + 1, 10 * n
        caps[::2, 4:7] = 1
    segs = Segments.from_cap_times(torch.from_numpy(caps.astype(np.int32)),
                                   n)
    return segs.boundaries, segs.masks


def segment_edges(dev, ops, ref) -> None:
    """Phase 2's edge tables of segment_resolve_kernel against its plain
    version on the CPU, bit for bit, under both pricing rules."""
    import numpy as np
    import torch
    for seed, (name, kind, s, n, c) in enumerate(SEGMENT_EDGES):
        rng = np.random.default_rng(200 + seed)
        values, mult, _, _ = coarse_inputs(s, n, c, 200 + seed, False)
        res = torch.from_numpy(rng.choice([0.0, 0.125, 0.3], s).astype(
            np.float32))
        bounds, masks = segment_table(kind, s, n, c, rng)
        for second in (False, True):
            got = ops.segment_resolve(values.to(dev), mult.to(dev),
                                      res.to(dev), bounds.to(dev),
                                      masks.to(dev), second_price=second)
            want = ref.segment_resolve_plain(values, mult, res, bounds, masks,
                                             second)
            require(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                    f"segment_resolve edge {name!r} (second price {second}) "
                    f"differs from its plain version on the CPU")
        print(f"[2] segment_resolve edge: {name} (S={s} N={n} C={c}): "
              f"bitwise the plain version on the CPU, both rules",
              flush=True)


def vi_cost(n_batches: int, b: int, c: int, w: int, total: int, s: int,
            clock_hz: float):
    """``(bytes, operations, chain floor ms)`` of S lanes of Algorithm 4:
    the sampled rows, the uniforms, the steps and the (S, C) inputs read
    once and pi written once; a compare, a multiply and a compare per
    (lane, step, row, campaign); the chain floor is ``total`` dependent
    steps, each at least VI_SCAN_INSTRUCTIONS * B * C / 128 cycles of one
    SM's issue (one SM a lane, as the kernel runs)."""
    n_bytes = 4 * (n_batches * b * c + total * b * w + total + n_batches
                   + s * (4 * c + 1))
    n_ops = 3 * s * total * b * c
    floor_ms = total * (VI_SCAN_INSTRUCTIONS * b * c / 128) / clock_hz * 1e3
    return n_bytes, n_ops, floor_ms


def segment_cost(n: int, c: int, s: int, k: int):
    """``(bytes, operations, issue floor ms)`` of a segment replay of n
    rows, S lanes, K inner boundaries: the rows read once, each lane's
    table, multipliers and reserve read once and its winners and prices
    written once; a multiply and a compare per (lane, event, campaign); the
    issue floor SEGMENT_SCAN_INSTRUCTIONS of them at 128 a cycle an SM."""
    import torch
    n_bytes = n * c * 4 + s * (n * 8 + (k + 2) * 4 + (k + 1) * c + c * 4 + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    floor_ms = SEGMENT_SCAN_INSTRUCTIONS * s * n * c / (sms * 128 * clock_hz) \
        * 1e3
    return n_bytes, 2 * s * n * c, floor_ms


def serve_phase(seed: int, dev, reset_counts, read_counts) -> dict:
    """Phase 9: the LM serving path. Returns its numbers."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import Model, build_model
    from repro_torch.serve import ServeEngine

    out = {"err": 0.0}
    # ---- (a) the kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for b, s, h, kv, dh, causal, window, dname in FLASH_SHAPES:
        dtype = getattr(torch, dname)
        q = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        again = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        label = (f"flash_attention B={b} S={s} H={h} KV={kv} dh={dh} "
                 f"causal={causal} window={window} {dname}")
        require(torch.equal(got, again), f"{label}: two launches differ")
        tol = 2e-2 if dname == "bfloat16" else 2e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        row_err = float((diff / want.float().abs().amax(
            dim=-1, keepdim=True).clamp_min(1e-30)).max())
        if dname == "bfloat16":
            require(row_err <= FLASH_BF16_ROW_TOL,
                    f"{label}: max |kernel - plain| / row scale {row_err:.4g}"
                    f" > {FLASH_BF16_ROW_TOL}")
        out["err"] = max(out["err"], err)
        print(f"[9] {label}: max |kernel - plain| {err:.3g} (tol {tol}), "
              f"at the row's scale {row_err:.3g}"
              + (f" (tol {FLASH_BF16_ROW_TOL})" if dname == "bfloat16"
                 else "")
              + ", two launches bitwise equal", flush=True)
        del diff
        shape = (b, s, h, kv, dh, causal, window, dname)
        if shape in FLASH_TIMED:
            # key-query pairs each row sees (causal or not, and window)
            rows = torch.arange(s, dtype=torch.float64)
            if causal:
                seen = rows + 1 if window is None else torch.clamp(
                    rows + 1, max=window)
            else:
                seen = torch.full_like(rows, s)
                if window is not None:
                    seen -= torch.clamp(rows - window + 1, min=0)
            pairs = b * h * float(seen.sum())
            kernel_ms = cuda_ms(lambda: fa_ops.flash_attention(
                q, k, v, causal=causal, window=window), 10)
            plain_ms = cuda_ms(lambda: attention_ref(
                q, k, v, causal=causal, window=window), 3)
            # the yardstick: SDPA on the same tensors as strided (B, H, S,
            # dh) views, a band mask for the window; the port never calls it
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            band = None
            if window is not None:
                idx = torch.arange(s, device=dev)
                band = idx[None, :] > idx[:, None] - window
                if causal:
                    band &= idx[None, :] <= idx[:, None]
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band,
                    is_causal=causal and band is None,
                    enable_gqa=kv != h), 10)
            n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
            if dname == "float32":
                # the kernel's split TF32 does three TF32 products a float32
                # product on the tensor cores; the same products on the CUDA
                # cores are kept beside it
                bound = bound_ms(n_bytes, 3 * 2 * 2 * pairs * dh,
                                 TF32_OPS_PER_S)
                cuda_core = bound_ms(n_bytes, 2 * 2 * pairs * dh)[0]
            else:
                bound = bound_ms(n_bytes, 2 * 2 * pairs * dh, BF16_OPS_PER_S)
                cuda_core = None
            out.setdefault("flash_timed", []).append(
                (FLASH_TIMED[shape], label, kernel_ms, plain_ms, library_ms,
                 bound, cuda_core))
            print(f"[9] {label}: kernel {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]})"
                  + (f" in split TF32, on the CUDA cores {cuda_core:.4f} ms"
                     if cuda_core else ""), flush=True)
        if ((b, s, h, dh) == (LM_REQUESTS, LM_PROMPT, 32, 64)
                and dname == "bfloat16"):
            # the yardstick reads the same tensors in its (B, H, S, dh)
            # layout, as strided views; the port never calls it
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out["flash"] = (
                cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 10),
                cuda_ms(lambda: attention_ref(q, k, v), 3),
                cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10))
            pairs = b * h * s * (s + 1) // 2        # the causal half
            out["flash_bound"] = bound_ms(4 * q.numel() * q.element_size(),
                                          2 * 2 * pairs * dh, BF16_OPS_PER_S)
            out["flash_shape"] = label
        del q, k, v, got, again, want

    # ---- (b) stablelm-1.6b at full width
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT))
    tokens = torch.from_numpy(prompts).to(dev)
    engine = ServeEngine(model, max_len=LM_PROMPT + LM_STEPS)

    reset_counts()
    torch.cuda.synchronize()
    logits, caches = engine.prefill(tokens)
    torch.cuda.synchronize()
    prefill_counts = read_counts()
    require(prefill_counts["flash_attention"] == cfg.n_layers and not any(
        n for name, n in prefill_counts.items() if name != "flash_attention"),
        f"prefill launches {prefill_counts}, expected {cfg.n_layers} "
        f"flash_attention and nothing else")
    require(bool(torch.isfinite(logits.float()).all())
            and tuple(logits.shape) == (LM_REQUESTS, 1, cfg.padded_vocab),
            "prefill logits not finite or of the wrong shape")
    del logits, caches

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    generated = engine.generate(tokens, LM_STEPS)
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated()
    launches = read_counts()
    require(launches["flash_attention"] == cfg.n_layers and not any(
        n for name, n in launches.items() if name != "flash_attention"),
        f"generate launches {launches}: expected the prefill's "
        f"{cfg.n_layers} flash_attention and none in decode")
    out["launches"] = launches["flash_attention"]
    require(tuple(generated.shape) == (LM_REQUESTS, LM_STEPS)
            and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
            f"generated tokens malformed: {tuple(generated.shape)}")
    second = engine.generate(tokens, LM_STEPS)
    require(torch.equal(second, generated), "a second generate gave other "
                                            "tokens")
    # prefill alone, and the decode steps alone, from the same prompts
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = engine.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["prefill_s"] = statistics.median(times)
    tok = engine._sample(logits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_STEPS):
        logits, caches = model.decode_step(caches, tok[:, None],
                                           LM_PROMPT + i)
        tok = engine._sample(logits)
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) / LM_STEPS * 1e3
    by_kernel = trace("[9]", f"{LM_ARCH} prefill",
                      lambda: engine.prefill(tokens))
    flash_us = sum(us for key, us in by_kernel.items() if "flash_" in key)
    if by_kernel:
        print(f"[9] {LM_ARCH} prefill: flash_attention kernels "
              f"{flash_us / 1e3:.3f} ms of {sum(by_kernel.values()) / 1e3:.3f}"
              f" ms device busy ({flash_us / sum(by_kernel.values()):.4f})",
              flush=True)

    def decode_steps(n=4):
        nonlocal logits, caches, tok
        for i in range(n):
            logits, caches = model.decode_step(caches, tok[:, None],
                                               LM_PROMPT + i)
            tok = engine._sample(logits)

    trace("[9]", f"{LM_ARCH} 4 decode steps", decode_steps)
    print(f"[9] {LM_ARCH} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"vocab={cfg.vocab_size}: generate {LM_REQUESTS} x {LM_PROMPT} "
          f"prompt tokens + {LM_STEPS} greedy tokens in "
          f"{out['generate_s']:.4f} s; {launches['flash_attention']} "
          f"flash_attention launches, all in the prefill; a second run gives "
          f"the same tokens; first tokens {generated[:, :6].tolist()}",
          flush=True)
    del logits, caches, tokens

    # ---- (c) card vs CPU, two layers at full width
    small = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    card = Model(small, device=dev)
    card.load_state_dict({k: v for k, v in model.state_dict().items()
                          if not k.startswith("blocks.")
                          or int(k.split(".")[1]) < LM_CPU_LAYERS})
    del model
    cpu = Model(small, device="cpu")
    cpu.load_state_dict(card.state_dict())
    seq = np.random.default_rng(seed + 1).integers(
        0, small.vocab_size, (LM_CPU_REQUESTS, LM_CPU_PROMPT + LM_CPU_STEPS))
    seq = torch.from_numpy(seq)
    t0 = time.perf_counter()
    worst = {}
    runs = {}
    for name, m in (("card", card), ("cpu", cpu)):
        d = m.device
        steps = []
        logits, caches = m.prefill(seq[:, :LM_CPU_PROMPT].to(d),
                                   LM_CPU_PROMPT + LM_CPU_STEPS)
        steps.append(logits.float().cpu())
        for i in range(LM_CPU_STEPS):
            pos = LM_CPU_PROMPT + i
            logits, caches = m.decode_step(caches, seq[:, pos:pos + 1].to(d),
                                           pos)
            steps.append(logits.float().cpu())
        runs[name] = steps
    for i, (a, b) in enumerate(zip(runs["card"], runs["cpu"])):
        rel = float((a - b).abs().max() / b.abs().max())
        kind = "prefill" if i == 0 else "decode"
        worst[kind] = max(worst.get(kind, 0.0), rel)
        require(rel < LM_TOL, f"card vs CPU logits ({kind} {i}): relative "
                              f"error {rel:.4g} >= {LM_TOL}")
    print(f"[9] {LM_ARCH} cut to {LM_CPU_LAYERS} layers, {LM_CPU_REQUESTS} x "
          f"{LM_CPU_PROMPT} tokens + {LM_CPU_STEPS} teacher-forced decode "
          f"steps: card vs CPU logits, max |diff| / max |CPU|: prefill "
          f"{worst['prefill']:.4g}, decode {worst['decode']:.4g} (tol "
          f"{LM_TOL}; {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def is_gemm(kernel: str) -> bool:
    """A cuBLAS / CUTLASS matrix-product kernel, by its name."""
    key = kernel.lower()
    return any(tag in key for tag in ("gemm", "gemv", "nvjet", "cutlass",
                                      "xmma"))


def mixers_phase(seed: int, dev, reset_counts, read_counts, *,
                 models=MIXER_MODELS, config=None, requests=LM_REQUESTS,
                 prompt=LM_PROMPT, steps=LM_STEPS, card_name="") -> dict:
    """Phase 16: the MoE and recurrent models at full width (``config``,
    default ``get_config``, gives each arch's config; a CPU rehearsal
    passes ``reduced_config`` and small sizes). Returns their numbers and
    the ``flash_attention`` launches of their generate runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.serve import ServeEngine

    config = config or get_config
    t_phase = time.perf_counter()
    out = {"models": {}, "flash_launches": 0}
    for arch, cut, cpu_layers, bf16_bounded in models:
        cfg = config(arch)
        if cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        tag = f"[16] {arch}" + (f" cut to {cut} layers" if cut else "")
        n_attn = sum(ls.kind == "attn" for ls in cfg.layers)
        t_model = t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=seed)
        torch.cuda.synchronize()
        rec = dict(init_s=time.perf_counter() - t0, layers=cfg.n_layers,
                   attention_layers=n_attn,
                   weights_gb=sum(p.numel() * p.element_size()
                                  for p in model.parameters()) / 1e9)
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (requests, prompt))).to(dev)
        engine = ServeEngine(model, max_len=prompt + steps)

        def only_flash(counts, what):
            require(counts["flash_attention"] == n_attn and not any(
                n for name, n in counts.items() if name != "flash_attention"),
                f"{tag}: {what} launches {counts}, expected {n_attn} "
                f"flash_attention (one an attention layer) and nothing else")

        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        generated = engine.generate(tokens, steps)
        torch.cuda.synchronize()
        rec["generate_s"] = time.perf_counter() - t0
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = read_counts()
        only_flash(launches, "generate")
        out["flash_launches"] += launches["flash_attention"]
        require(tuple(generated.shape) == (requests, steps)
                and bool(((generated >= 0)
                          & (generated < cfg.vocab_size)).all()),
                f"{tag}: generated tokens malformed")
        require(torch.equal(engine.generate(tokens, steps), generated),
                f"{tag}: a second generate gave other tokens")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = engine.prefill(tokens)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        only_flash(read_counts(), "prefill")
        require(bool(torch.isfinite(logits.float()).all())
                and tuple(logits.shape) == (requests, 1, cfg.padded_vocab),
                f"{tag}: prefill logits not finite or of the wrong shape")
        tok = engine._sample(logits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, caches = model.decode_step(caches, tok[:, None],
                                               prompt + i)
            tok = engine._sample(logits)
        torch.cuda.synchronize()
        rec["decode_ms"] = (time.perf_counter() - t0) / steps * 1e3
        del logits, caches
        counts = {}
        t0 = time.perf_counter()
        by_kernel = trace("[16]", f"{arch} prefill",
                          lambda: engine.prefill(tokens), counts=counts)
        rec["trace_s"] = time.perf_counter() - t0
        if by_kernel:
            busy = sum(by_kernel.values()) / 1e3
            attention = sum(us for k, us in by_kernel.items()
                            if "flash_" in k) / 1e3
            gemm = sum(us for k, us in by_kernel.items() if is_gemm(k)) / 1e3
            rec["trace"] = dict(busy_ms=busy, attention_ms=attention,
                                gemm_ms=gemm,
                                other_ms=busy - attention - gemm,
                                kernel_launches=sum(counts.values()))
            print(f"{tag} prefill: device busy {busy:.3f} ms = attention "
                  f"{attention:.3f} ms + matrix products {gemm:.3f} ms + "
                  f"the rest {busy - attention - gemm:.3f} ms (elementwise "
                  f"ops, the MoE dispatch, the mamba scan, the sLSTM "
                  f"loop); {sum(counts.values())} device kernel launches "
                  f"(traced and summarised in {rec['trace_s']:.1f} s)",
                  flush=True)
        gen_tokens = requests * steps
        print(f"{tag} on {card_name}: d_model={cfg.d_model}, {cfg.n_layers} "
              f"layers ({n_attn} attention), {rec['weights_gb']:.2f} GB of "
              f"weights; prefill of {requests} x {prompt} tokens "
              f"{rec['prefill_s']:.4f} s "
              f"({requests * prompt / rec['prefill_s']:.6g} prompt tokens/s);"
              f" decode {rec['decode_ms']:.4f} ms a step of {requests} "
              f"tokens ({requests / rec['decode_ms'] * 1e3:.6g} tokens/s); "
              f"generate of {steps} tokens {rec['generate_s']:.4f} s "
              f"({gen_tokens / rec['generate_s']:.6g} generated tokens/s); "
              f"peak device memory {rec['peak_gib']:.3f} GiB; weights "
              f"initialised in {rec['init_s']:.2f} s; {n_attn} "
              f"flash_attention launches a prefill, none in decode; the "
              f"same tokens twice; first tokens {generated[:2, :6].tolist()}",
              flush=True)
        del engine, tokens, generated

        # ---- the card against the CPU, cut to a few layers
        small = dataclasses.replace(cfg, n_layers=cpu_layers)
        card = Model(small, device=dev)
        card.load_state_dict({k: v for k, v in model.state_dict().items()
                              if not k.startswith("blocks.")
                              or int(k.split(".")[1]) < cpu_layers})
        del model
        torch.cuda.empty_cache()
        cpu = Model(small, device="cpu")
        cpu.load_state_dict(card.state_dict())
        rec["cpu_check"] = card_against_cpu(f"[16] {arch}", card, cpu,
                                            small, seed, moe_lib,
                                            bf16_bounded)
        del card, cpu
        torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t_model
        print(f"{tag}: {rec['wall_s']:.1f} s in all", flush=True)
        out["models"][arch] = rec
    out["wall"] = time.perf_counter() - t_phase
    print(f"[16] phase 16: {out['wall']:.1f} s", flush=True)
    return out


def card_against_cpu(tag, card, cpu, cfg, seed, moe_lib,
                     bf16_bounded: bool, *, prompt: int = LM_CPU_PROMPT,
                     stub=None) -> dict:
    """``LM_CPU_REQUESTS`` x ``prompt`` tokens (and ``stub``, ``(keyword,
    float32 CPU tensor)``, the frames or patch embeddings of a model with
    a stub frontend; they stay float32, the model casts them) and
    ``LM_CPU_STEPS`` teacher-forced decode steps on both, the logits held
    as max |diff| over max |CPU|, twice: as served (bfloat16), against
    ``LM_TOL`` (required where ``bf16_bounded``, printed beside it
    otherwise), then with both models cast to float32, within ``F32_TOL``.
    The second is the same code on the same weights with rounding 2^16
    times finer, so a layer that computes something else on the card
    stands out of it where the bfloat16 reading cannot tell it from
    rounding. The card's MoE routing is recorded; where the CPU's differs
    at a near tie (its probabilities within ``ROUTE_DRIFT`` of the card's)
    the CPU takes the card's experts (``moe.follow_routing``, which raises
    past it) and the tie is printed with its layer and token. ``card``
    and ``cpu`` are cast in place."""
    import numpy as np
    import torch
    seq = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (LM_CPU_REQUESTS, prompt + LM_CPU_STEPS)))
    offset = cfg.num_patches
    moe_layers = [i for i, ls in enumerate(cfg.layers) if ls.moe]
    out = {}
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            card.float()
            cpu.float()
        routes = []
        t0 = time.perf_counter()
        runs = {}
        for name, m in (("card", card), ("cpu", cpu)):
            d = m.device
            steps = []
            extra = {} if stub is None else {stub[0]: stub[1].to(d)}
            with (moe_lib.record_routing(routes) if name == "card" else
                  moe_lib.follow_routing(routes, ROUTE_DRIFT)) as taken:
                logits, caches = m.prefill(seq[:, :prompt].to(d),
                                           offset + prompt + LM_CPU_STEPS,
                                           **extra)
                steps.append(logits.float().cpu())
                for i in range(LM_CPU_STEPS):
                    pos = prompt + i
                    logits, caches = m.decode_step(
                        caches, seq[:, pos:pos + 1].to(d), offset + pos)
                    steps.append(logits.float().cpu())
            runs[name] = steps
        ties = []
        for tie in taken:
            step, layer = divmod(tie["call"], len(moe_layers))
            flat = tie["group"] * routes[tie["call"]][1].shape[1] \
                + tie["token"]
            where = (f"prefill token {flat % prompt} of request "
                     f"{flat // prompt}" if step == 0 else
                     f"decode step {step - 1} of request {flat}")
            ties.append(dict(tie, layer=moe_layers[layer], where=where))
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(runs["card"], runs["cpu"])]
        worst = dict(prefill=rel[0], decode=max(rel[1:]))
        tol = LM_TOL if dtype == "bfloat16" else F32_TOL
        for tie in ties[:TIES_SHOWN]:
            print(f"{tag} {dtype}: near tie at layer {tie['layer']}, "
                  f"{tie['where']}: the card's experts {tie['followed']}, "
                  f"the CPU's {tie['own']}, probabilities "
                  f"{tie['drift']:.4g} apart; the CPU took the card's",
                  flush=True)
        if len(ties) > TIES_SHOWN:
            print(f"{tag} {dtype}: {len(ties) - TIES_SHOWN} more near ties "
                  f"(all in build/phase16.json), at layers "
                  f"{sorted({t['layer'] for t in ties})}, the largest drift "
                  f"{max(t['drift'] for t in ties):.4g}", flush=True)
        held = dtype == "float32" or bf16_bounded
        print(f"{tag} cut to {cfg.n_layers} layers, {dtype}, "
              f"{LM_CPU_REQUESTS} x {prompt} tokens + {LM_CPU_STEPS} "
              f"teacher-forced decode steps: card vs CPU logits, max |diff| "
              f"/ max |CPU|: prefill {worst['prefill']:.4g}, decode "
              f"{worst['decode']:.4g} (steps "
              f"{[float(f'{r:.4g}') for r in rel[1:]]}; "
              f"{'tol' if held else 'reported beside'} {tol}); "
              f"{len(routes)} MoE calls, {len(ties)} near ties "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if held:
            for i, r in enumerate(rel):
                require(r < tol, f"{tag}: card vs CPU {dtype} logits "
                                 f"({'prefill' if i == 0 else 'decode'} "
                                 f"{i}): relative error {r:.4g} >= {tol}")
        out[dtype] = dict(worst, steps=rel, held=held, moe_calls=len(routes),
                          near_ties=ties)
    return out


def encdec_phase(seed: int, dev, reset_counts, read_counts, *,
                 card_name="") -> dict:
    """Phase 17: ``ENCDEC_MODELS``, whisper-small's encoder-decoder and
    internvl2-76b's patch prefix, at full width through
    ``ServeEngine.generate`` with ``LM_REQUESTS`` requests and
    ``LM_STEPS`` tokens, sampling at ``SAMPLE_TEMPERATURE`` on the first
    model, and each cut against the CPU. Returns their numbers and the
    ``flash_attention`` launches of their generate runs, all and not
    causal."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.models import build_model, new_model
    from repro_torch.models import encdec as encdec_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.serve import ServeEngine

    requests, steps = LM_REQUESTS, LM_STEPS
    t_phase = time.perf_counter()
    out = {"models": {}, "flash_launches": 0}
    for arch, cut, prompt, cpu_prompt in ENCDEC_MODELS:
        cfg = get_config(arch)
        if cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        tag = f"[17] {arch}" + (f" cut to {cut} layers" if cut else "")
        stub_key = "frames" if cfg.is_encdec else "patch_embeds"
        width = cfg.encoder_frames or cfg.num_patches
        n_flash = cfg.n_layers + cfg.encoder_layers
        t_model = t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=seed)
        torch.cuda.synchronize()
        rec = dict(init_s=time.perf_counter() - t0, layers=cfg.n_layers,
                   encoder_layers=cfg.encoder_layers, prompt=prompt,
                   stub=(stub_key, width),
                   weights_gb=sum(p.numel() * p.element_size()
                                  for p in model.parameters()) / 1e9)
        rng = np.random.default_rng(seed)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (requests, prompt))).to(dev),
            stub_key: torch.from_numpy(rng.standard_normal(
                (requests, width, cfg.d_model), dtype=np.float32)).to(dev)}
        positions = prompt + cfg.num_patches
        engine = ServeEngine(model, max_len=positions + steps)

        def only_flash(counts, what, n=n_flash):
            # the encoder's launches, and only they, are not causal
            non_causal = fa_mod.NON_CAUSAL_LAUNCHES["flash_attention"]
            require(counts["flash_attention"] == n and not any(
                k for name, k in counts.items() if name != "flash_attention")
                and non_causal == cfg.encoder_layers,
                f"{tag}: {what} launches {counts}, {non_causal} not causal; "
                f"expected {n} flash_attention ({cfg.encoder_layers} not "
                f"causal) and nothing else")
            return non_causal

        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        generated = engine.generate(batch, steps)
        torch.cuda.synchronize()
        rec["generate_s"] = time.perf_counter() - t0
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = read_counts()
        rec["non_causal_launches"] = only_flash(launches, "generate")
        rec["launches"] = launches["flash_attention"]
        out["flash_launches"] += launches["flash_attention"]
        require(tuple(generated.shape) == (requests, steps)
                and bool(((generated >= 0)
                          & (generated < cfg.vocab_size)).all()),
                f"{tag}: generated tokens malformed")
        require(torch.equal(engine.generate(batch, steps), generated),
                f"{tag}: a second generate gave other tokens")
        if cfg.is_encdec:
            reset_counts()
            enc = encdec_lib.encode(model, batch["frames"])
            torch.cuda.synchronize()
            only_flash(read_counts(), "encode", cfg.encoder_layers)
            require(tuple(enc.shape) == (requests, width, cfg.d_model)
                    and bool(torch.isfinite(enc.float()).all()),
                    f"{tag}: the encoder's output is malformed")
            del enc
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = engine.prefill(batch)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        only_flash(read_counts(), "prefill")
        require(bool(torch.isfinite(logits.float()).all())
                and tuple(logits.shape) == (requests, 1, cfg.padded_vocab),
                f"{tag}: prefill logits not finite or of the wrong shape")
        prefill_logits = logits
        tok = engine._sample(logits)
        # the greedy loop as it was before sampling was ported: argmax of
        # the true vocabulary; generate's greedy tokens are its, with any key
        hand = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            hand.append(tok)
            logits, caches = model.decode_step(caches, tok[:, None],
                                               positions + i)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size],
                               dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        rec["decode_ms"] = (time.perf_counter() - t0) / steps * 1e3
        require(torch.equal(torch.stack(hand, 1), generated),
                f"{tag}: generate's greedy tokens are not the argmax loop's")
        require(torch.equal(engine.generate(batch, steps,
                                            key=prng.PRNGKey(seed + 5)),
                            generated),
                f"{tag}: a key changed the greedy tokens")
        del logits, caches
        counts = {}
        t0 = time.perf_counter()
        by_kernel = trace("[17]", f"{arch} prefill",
                          lambda: engine.prefill(batch), counts=counts)
        rec["trace_s"] = time.perf_counter() - t0
        if by_kernel:
            busy = sum(by_kernel.values()) / 1e3
            attention = sum(us for k, us in by_kernel.items()
                            if "flash_" in k) / 1e3
            gemm = sum(us for k, us in by_kernel.items() if is_gemm(k)) / 1e3
            rec["trace"] = dict(busy_ms=busy, attention_ms=attention,
                                gemm_ms=gemm,
                                other_ms=busy - attention - gemm,
                                kernel_launches=sum(counts.values()))
            print(f"{tag} prefill: device busy {busy:.3f} ms = attention "
                  f"{attention:.3f} ms + matrix products {gemm:.3f} ms + "
                  f"the rest {busy - attention - gemm:.3f} ms (elementwise "
                  f"ops, norms, RoPE, the cross-attention's einsums and "
                  f"softmax); {sum(counts.values())} device kernel launches "
                  f"(traced and summarised in {rec['trace_s']:.1f} s)",
                  flush=True)
        if not out.get("sampling"):
            out["sampling"] = sample_check(tag, engine, batch, steps,
                                           prefill_logits, seed, prng, cfg)
        del prefill_logits
        n_prompt = requests * positions
        print(f"{tag} on {card_name}: d_model={cfg.d_model}, "
              f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers"
              f", {rec['weights_gb']:.2f} GB of weights; prefill of "
              f"{requests} x ({width} {stub_key.replace('_', ' ')} + "
              f"{prompt} tokens) {rec['prefill_s']:.4f} s; decode "
              f"{rec['decode_ms']:.4f} ms a step of {requests} tokens "
              f"({requests / rec['decode_ms'] * 1e3:.6g} tokens/s); generate "
              f"of {steps} tokens {rec['generate_s']:.4f} s "
              f"({requests * steps / rec['generate_s']:.6g} generated "
              f"tokens/s); peak device memory {rec['peak_gib']:.3f} GiB; "
              f"weights initialised in {rec['init_s']:.2f} s; "
              f"{rec['launches']} flash_attention launches in generate, "
              f"{rec['non_causal_launches']} of them not causal, all in "
              f"its prefill; the same tokens twice; first tokens "
              f"{generated[:2, :6].tolist()}"
              + ("" if cfg.is_encdec else
                 f" ({n_prompt} prompt positions)"), flush=True)
        del engine, batch, generated

        # ---- the card against the CPU, cut to a few layers
        small = dataclasses.replace(
            cfg, n_layers=LM_CPU_LAYERS,
            encoder_layers=LM_CPU_LAYERS if cfg.is_encdec else 0)
        card = new_model(small, device=dev)
        card.load_state_dict({
            k: v for k, v in model.state_dict().items()
            if not k.startswith(("blocks.", "enc_blocks.", "dec_blocks."))
            or int(k.split(".")[1]) < LM_CPU_LAYERS})
        del model
        torch.cuda.empty_cache()
        cpu = new_model(small, device="cpu")
        cpu.load_state_dict(card.state_dict())
        stub = torch.from_numpy(np.random.default_rng(seed + 2)
                                .standard_normal((LM_CPU_REQUESTS, width,
                                                  cfg.d_model),
                                                 dtype=np.float32))
        rec["cpu_check"] = card_against_cpu(
            f"[17] {arch} ({width} {stub_key.replace('_', ' ')})", card,
            cpu, small, seed, moe_lib, True, prompt=cpu_prompt,
            stub=(stub_key, stub))
        del card, cpu
        torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t_model
        print(f"{tag}: {rec['wall_s']:.1f} s in all", flush=True)
        out["models"][arch] = rec
    out["wall"] = time.perf_counter() - t_phase
    print(f"[17] phase 17: {out['wall']:.1f} s", flush=True)
    return out


def bwd_pairs(b: int, s: int, h: int, causal: bool, window) -> float:
    """The (query, key) pairs attention of this shape computes: what each
    of its products costs, per dh."""
    import torch
    rows = torch.arange(s, dtype=torch.float64)
    seen = rows + 1 if causal else torch.full_like(rows, float(s))
    if window is not None:
        # keys j > i - window: at most window of them up to i, and all
        # the later ones when not causal
        before = torch.clamp(rows + 1, max=window)
        seen = before if causal else before + (s - 1 - rows)
    return b * h * float(seen.sum())


def kernel_name(key: str) -> str:
    """A traced kernel's name with its template arguments, without its
    return type, namespace and parameters."""
    name = key.split("(anonymous namespace)::")[-1]
    return name[:name.index(">") + 1] if "<" in name else name.split("(")[0]


def backward_check(dev, tag: str) -> dict:
    """Phase 18 (a): ``BWD_SHAPES`` through the forward kernel (with its
    logsumexp) and the backward kernel against ``ref.attention_bwd_ref``
    (and, in bfloat16, against ``ref.attention_bwd_bf16_ref``, the mirror
    of the tensor-core kernels' roundings); bfloat16 timed against the
    plain version, the bound, the design's floor (its seven products at
    the bf16 tensor-core peak: the dQ kernel recomputes S and dP) and
    SDPA's backward. Returns the timings and errors by label."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import ref as fa_ref

    out = {"shapes": {}, "max_abs_err": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, kv, dh, causal, window, label in BWD_SHAPES:
        for dname in ("bfloat16", "float32"):
            if dname == "float32" and label not in BWD_F32:
                continue
            dtype = getattr(torch, dname)
            gen = torch.Generator(device=dev).manual_seed(s + h + dh)
            q, do = (torch.randn((b, s, h, dh), generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((b, s, kv, dh), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            o, lse = fa_mod.flash_attention_cuda(
                q, k, v, causal=causal, window=window, with_lse=True)

            def kernel():
                return fab.flash_attention_bwd_cuda(
                    q, k, v, o, do, lse, causal=causal, window=window)

            def plain():
                return fa_ref.attention_bwd_ref(
                    q, k, v, o, do, lse, causal=causal, window=window)

            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            rec = {}
            for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
                require(torch.equal(g, a),
                        f"{tag} {label} {dname}: a second launch gave other "
                        f"bits of {name}")
                diff = float((g.float() - w.float()).abs().max())
                rel = diff / float(w.float().abs().max())
                require(rel <= BWD_TOL[dname],
                        f"{tag} {label} {dname}: {name} differs by {rel:.3g}"
                        f" of its scale (> {BWD_TOL[dname]})")
                rec[f"{name}_rel_err"] = rel
                out["max_abs_err"] = max(out["max_abs_err"], diff)
            if dname == "bfloat16":
                mirror = fa_ref.attention_bwd_bf16_ref(
                    q, k, v, o, do, lse, causal=causal, window=window)
                for name, g, w in zip(("dq", "dk", "dv"), got, mirror):
                    rel = float((g.float() - w.float()).abs().max()
                                / w.float().abs().max())
                    require(rel <= BWD_MIRROR_TOL,
                            f"{tag} {label}: {name} differs from the mirror "
                            f"of the kernels' roundings by {rel:.3g} of its "
                            f"scale (> {BWD_MIRROR_TOL})")
                    rec[f"{name}_mirror_rel_err"] = rel
                del mirror
            del got, again, want
            if dname == "bfloat16":
                pairs = bwd_pairs(b, s, h, causal, window)
                # read q, k, v, o, dO and lse once, write dq, dk, dv
                n_bytes = (3 * q.numel() + 2 * k.numel()) \
                    * q.element_size() + lse.numel() * 4 \
                    + (q.numel() + 2 * k.numel()) * q.element_size()
                rec["bound"] = bound_ms(n_bytes, 5 * 2 * pairs * dh,
                                        BF16_OPS_PER_S)
                rec["floor_ms"] = 7 * 2 * pairs * dh / BF16_OPS_PER_S * 1e3
                rec["ms"] = cuda_ms(kernel, 5)
                rec["tflops"] = 5 * 2 * pairs * dh / rec["ms"] / 1e9
                rec["plain_ms"] = cuda_ms(plain, 2)
                # the yardstick: SDPA's backward on the same tensors as
                # (B, H, S, dh) views, a band mask for the window; the port
                # never calls it
                leaves = [x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v)]
                band = None
                if window is not None:
                    idx = torch.arange(s, device=dev)
                    band = idx[None, :] > idx[:, None] - window
                    if causal:
                        band &= idx[None, :] <= idx[:, None]
                ref_out = sdpa(*leaves, attn_mask=band,
                               is_causal=causal and band is None,
                               enable_gqa=kv != h)
                grad_out = do.transpose(1, 2)
                rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    ref_out, leaves, grad_out, retain_graph=True), 5)
                del ref_out, leaves
                print(f"{tag} {label} (B={b}, S={s}, H={h}, KV={kv}, "
                      f"dh={dh}, {'causal' if causal else 'not causal'}"
                      f"{'' if window is None else f', window {window}'}) "
                      f"bf16: kernel {rec['ms']:.4f} ms, plain "
                      f"{rec['plain_ms']:.4f} ms, SDPA backward "
                      f"{rec['library_ms']:.4f} ms, bound "
                      f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]}), "
                      f"7-product floor {rec['floor_ms']:.4f} ms, "
                      f"{rec['tflops']:.1f} TFLOP/s on five products; "
                      f"errors dq {rec['dq_rel_err']:.3g}, dk "
                      f"{rec['dk_rel_err']:.3g}, dv {rec['dv_rel_err']:.3g} "
                      f"of their scale (against the mirror "
                      f"{rec['dq_mirror_rel_err']:.3g}, "
                      f"{rec['dk_mirror_rel_err']:.3g}, "
                      f"{rec['dv_mirror_rel_err']:.3g})", flush=True)
            else:
                print(f"{tag} {label} f32: errors dq {rec['dq_rel_err']:.3g}"
                      f", dk {rec['dk_rel_err']:.3g}, dv "
                      f"{rec['dv_rel_err']:.3g} of their scale", flush=True)
            out["shapes"][f"{label} {dname}"] = rec
            del q, k, v, o, do, lse
            torch.cuda.empty_cache()
    return out


def full_width_train(seed: int, dev, reset_counts, read_counts, tag: str,
                     keep_params: bool) -> dict:
    """Phase 18 (b), one run: ``TRAIN_ARCH`` at full width from ``seed``,
    a warm-up step, ``TRAIN_STEPS`` timed steps and one more (traced with
    ``keep_params``). Returns the losses, walls, launches, peak memory
    and, with ``keep_params``, the final parameters on the host (else the
    state)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline_for
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.models import new_model
    from repro_torch.train import (AdamW, init_state, make_train_step,
                                   warmup_cosine)

    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    model = new_model(cfg, device=dev, param_dtype=torch.float32)
    adamw = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 1, TRAIN_STEPS + 1))
    state = init_state(model, adamw, seed)
    step = make_train_step(model, adamw, microbatches=TRAIN_MICRO)
    pipe = pipeline_for(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=seed, device=dev)
    torch.cuda.synchronize()
    rec = dict(init_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()),
               losses=[], step_s=[], launches=[])
    state, metrics = step(state, pipe.batch(0))          # warm-up
    rec["losses"].append(float(metrics["loss"]))
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, TRAIN_STEPS + 1):
        batch = pipe.batch(i)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        counts = read_counts()
        rec["launches"].append(counts)
        want = {"flash_attention": 2 * cfg.n_layers * TRAIN_MICRO,
                "flash_attention_bwd": cfg.n_layers * TRAIN_MICRO}
        require(all(counts[k] == n for k, n in want.items()) and not any(
            n for k, n in counts.items() if k not in want),
            f"{tag} step {i} launches {counts}, expected {want} and "
            f"nothing else")
        tc = fab.TENSOR_CORE_LAUNCHES["flash_attention_bwd"]
        require(tc == want["flash_attention_bwd"],
                f"{tag} step {i}: {tc} backward launches on the tensor-core "
                f"route, expected all {want['flash_attention_bwd']}")
        rec["losses"].append(float(metrics["loss"]))
        rec["grad_norm"] = float(metrics["grad_norm"])
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # one more step, traced in the first run: the device time by kernel
    # family
    batch = pipe.batch(TRAIN_STEPS + 1)
    box = {}

    def last_step():
        box["state"], box["metrics"] = step(state, batch)

    by_kernel = (trace(tag, "a train step", last_step) if keep_params
                 else last_step())
    state = box["state"]
    rec["losses"].append(float(box["metrics"]["loss"]))
    if by_kernel:
        busy = sum(by_kernel.values()) / 1e3
        split = {
            "attention_bwd": sum(us for k, us in by_kernel.items()
                                 if "bwd_" in k) / 1e3,
            "attention_fwd": sum(us for k, us in by_kernel.items()
                                 if "flash_" in k) / 1e3,
            "products": sum(us for k, us in by_kernel.items()
                            if is_gemm(k)) / 1e3}
        split["rest"] = busy - sum(split.values())
        bwd_split = {k: us / 1e3 for k, us in by_kernel.items()
                     if "bwd_" in k}
        rec["trace"] = dict(busy_ms=busy, **split, backward=bwd_split)
        print(f"{tag} traced step: device busy {busy:.1f} ms = "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
              + "; the backward's kernels: "
              + ", ".join(f"{kernel_name(k)} {v:.1f} ms" for k, v in sorted(
                              bwd_split.items(), key=lambda kv: -kv[1])),
              flush=True)
    require(all(torch.isfinite(torch.tensor(rec["losses"]))),
            f"{tag}: losses {rec['losses']} not finite")
    if keep_params:
        rec["host_params"] = {k: v.detach().cpu()
                              for k, v in state.params.items()}
    else:
        rec["state"] = state
    rec["cfg"] = cfg
    return rec


def card_against_cpu_train(seed: int, dev, tag: str, archs=TRAIN_CPU_ARCHS,
                           tols=None, reset_counts=None, read_counts=None,
                           remat: bool = True) -> dict:
    """Phase 18 (c) and 19 (b): ``archs`` reduced (a name, or ``(name,
    layers)`` to cut it), the same float32 masters and batch on the card
    and the CPU, in both compute dtypes: the loss and each leaf's gradient
    within ``TRAIN_TOLS`` (or ``tols[arch]``; a bound of None is printed,
    not held), then one AdamW step, whose parameters are printed in steps
    of the learning rate. Where the CPU's MoE routing differs from the
    card's at a near tie (within ``ROUTE_DRIFT``), the card takes the
    CPU's experts, in the forward and in the backward's per-block
    recompute alike (both run inside ``record_routing`` and
    ``follow_routing``). A leaf the loss never reads has a zero gradient;
    one whose gradient cancels (``CANCELLING``) is held against its
    block's largest. With the counters' ``reset_counts`` and
    ``read_counts``, each card run's kernel launches are returned under
    ``launches``. ``remat`` false runs both losses without the per-block
    recompute."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.data import pipeline_for
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import new_model
    from repro_torch.train import AdamW, constant_lr

    def grad(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    out = {}
    for entry in archs:
        arch, layers = (entry, None) if isinstance(entry, str) else entry
        cfg = reduced_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        batch = pipeline_for(cfg, seq_len=TRAIN_CPU_SEQ,
                             global_batch=TRAIN_CPU_BATCH, seed=seed,
                             device="cpu").batch(0)
        for dname in ("bfloat16", "float32"):
            compute = getattr(torch, dname)
            models, runs = {}, {}
            for where in ("cpu", dev):
                model = new_model(cfg, device=where,
                                  param_dtype=torch.float32)
                if compute == torch.float32:
                    model.compute_dtype = None      # the float32 twin
                if where == "cpu":
                    model.init_params(seed)
                else:
                    model.load_state_dict(models["cpu"].state_dict())
                for p in model.parameters():
                    p.requires_grad_(True)
                models[where] = model
            # the backward's recompute routes again: it is recorded and
            # followed too, in the backward's order
            log: list = []
            with moe_lib.record_routing(log):
                loss_cpu, met_cpu = models["cpu"].loss(batch, remat=remat)
                loss_cpu.backward()
            if reset_counts is not None:
                reset_counts()
            with moe_lib.follow_routing(log, ROUTE_DRIFT) as ties:
                loss_card, met_card = models[dev].loss(
                    {k: v.to(dev) for k, v in batch.items()}, remat=remat)
                loss_card.backward()
            launches = read_counts() if read_counts is not None else None
            loss_tol, grad_tol, step_tol = (tols or {}).get(
                arch, TRAIN_TOLS)[dname]
            loss_card, loss_cpu = float(loss_card.detach()), \
                float(loss_cpu.detach())
            loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
            grad_rel = {}
            named = dict(models["cpu"].named_parameters())
            for (name, pc), (_, pd) in zip(
                    models["cpu"].named_parameters(),
                    models[dev].named_parameters()):
                scale = float(grad(pc).abs().max())
                if name.endswith(CANCELLING):
                    block = name.rsplit(".", 2)[0] + "."
                    scale = max(float(grad(q).abs().max()) for k, q in
                                named.items() if k.startswith(block))
                grad_rel[name] = float((grad(pd).cpu() - grad(pc)).abs().max()
                                       ) / (scale if scale else 1.0)
            worst = max(grad_rel, key=grad_rel.get)
            require(loss_rel <= loss_tol,
                    f"{tag} {arch} {dname}: loss {loss_card} on the card, "
                    f"{loss_cpu} on the CPU ({loss_rel:.3g} > {loss_tol})")
            require(grad_tol is None or grad_rel[worst] <= grad_tol,
                    f"{tag} {arch} {dname}: gradient of {worst} differs by "
                    f"{grad_rel[worst]:.3g} of its scale (> {grad_tol})")
            # one AdamW step from the gradients, each device on its own
            steps = {}
            for where, model in models.items():
                adamw = AdamW(learning_rate=constant_lr(TRAIN_CPU_LR))
                params = dict(model.named_parameters())
                grads = {k: grad(p) for k, p in params.items()}
                adamw.update(grads, adamw.init(params), params)
                steps[where] = params
            moved = max(float((steps[dev][k].detach().cpu()
                               - steps["cpu"][k].detach()).abs().max())
                        for k in steps["cpu"]) / TRAIN_CPU_LR
            require(step_tol is None or moved <= step_tol,
                    f"{tag} {arch} {dname}: after one step the parameters "
                    f"differ by {moved:.3g} learning rates (> {step_tol})")
            shown = {k: n for k, n in (launches or {}).items() if n}
            out[f"{arch} {dname}"] = dict(loss_rel=loss_rel,
                                          grad_rel=grad_rel[worst],
                                          worst=worst, step_diff_lr=moved,
                                          ties=len(ties), launches=launches)
            print(f"{tag} {arch} {dname}: loss {loss_card:.6f} on the card, "
                  f"{loss_cpu:.6f} on the CPU ({loss_rel:.3g} <= {loss_tol}); "
                  f"gradients within {grad_rel[worst]:.3g} of their scale "
                  f"(worst {worst}; <= {grad_tol}); after one AdamW step the "
                  f"parameters differ by at most {moved:.3g} learning rates"
                  f" (<= {step_tol}); {len(ties)} near ties followed"
                  + (f"; launches {shown}" if launches is not None
                     else ""), flush=True)
            del models, steps
    return out


def train_phase(seed: int, dev, reset_counts, read_counts, *,
                card_name="") -> dict:
    """Phase 18: training. (a) the backward kernel against its plain
    version and timed; (b) stablelm-1.6b at full width, twice from one
    seed; (c) reduced configs on the card against the CPU; (d)
    ``train_loop``'s restart on the card. Returns the numbers, the
    launches of (b)'s timed steps and the backward kernel's row."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    out["backward"] = bwd = backward_check(dev, "[18a]")
    print(f"[18a] {time.perf_counter() - t_phase:.1f} s", flush=True)

    t0 = time.perf_counter()
    first = full_width_train(seed, dev, reset_counts, read_counts, "[18b]",
                             keep_params=True)
    cfg = first.pop("cfg")
    host = first.pop("host_params")
    torch.cuda.empty_cache()
    second = full_width_train(seed, dev, reset_counts, read_counts,
                              "[18b] again", keep_params=False)
    second.pop("cfg")
    state = second.pop("state")
    require(second["losses"] == first["losses"],
            f"[18b] a second run gave losses {second['losses']}, the first "
            f"{first['losses']}")
    same = all(torch.equal(state.params[k], v.to(dev))
               for k, v in host.items())
    require(same, "[18b] a second run from the same seed gave other "
            "parameters")
    del state, host
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(first["step_s"])
    out["full"] = dict(first, tokens_per_step=tokens, step_median_s=step_s,
                       tokens_per_s=tokens / step_s,
                       wall_s=time.perf_counter() - t0)
    print(f"[18b] {TRAIN_ARCH} on {card_name}: {first['params'] / 1e9:.4f} B "
          f"parameters ({cfg.n_layers} layers, d={cfg.d_model}, vocab "
          f"{cfg.vocab_size}), float32 masters; steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches: "
          f"{[round(t, 4) for t in first['step_s']]} s (median {step_s:.4f}"
          f" s, {tokens / step_s:.6g} tokens/s); peak device memory "
          f"{first['peak_gib']:.3f} GiB; losses {first['losses']}; "
          f"{first['launches'][0]} launches a step; the same parameters "
          f"and losses from a second run; {out['full']['wall_s']:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    out["cpu_check"] = card_against_cpu_train(seed, dev, "[18c]")
    print(f"[18c] {time.perf_counter() - t0:.1f} s", flush=True)

    out["restart"] = restart_check(TRAIN_ARCH, None, seed, dev, "[18d]",
                                   "phase18_ckpt")

    main = bwd["shapes"][f"{BWD_SHAPES[0][7]} bfloat16"]
    out["row"] = dict(ms=main["ms"], plain_ms=main["plain_ms"],
                      library_ms=main["library_ms"], bound=main["bound"],
                      max_abs_err=bwd["max_abs_err"])
    out["launches"] = {k: sum(c[k] for c in first["launches"])
                       for k in ("flash_attention", "flash_attention_bwd")}
    out["wall"] = time.perf_counter() - t_phase
    print(f"[18] phase 18: {out['wall']:.1f} s", flush=True)
    return out


class ScanMarks:
    """Marks where the mixers' recurrences run on the stream: wrapped by
    :meth:`wrap`, a recurrence launches a marker kernel (``torch.cuda.
    _sleep(0)``, ``spin_kernel``) before and after its forward and, through
    autograd hooks, when its output's gradient arrives and each time one of
    its inputs' gradients is complete (the last of these ends its
    backward). :meth:`split` finds the markers among a trace's kernels in
    the device's order and sums the device time between each span's first
    and last marker."""

    def __init__(self):
        self.labels = []          # (span, "start" or "stop") in launch order
        self.spans = 0

    def _mark(self, span: int, what: str) -> None:
        import torch
        torch.cuda._sleep(0)
        self.labels.append((span, what))

    def wrap(self, fn):
        import torch

        def tensors(tree):
            if isinstance(tree, torch.Tensor):
                return [tree] if tree.requires_grad else []
            if isinstance(tree, (tuple, list)):
                return [t for sub in tree for t in tensors(sub)]
            return []

        def wrapped(*args):
            span = self.spans
            self.spans += 2
            self._mark(span, "start")
            out = fn(*args)
            self._mark(span, "stop")
            outs, ins = tensors(out), tensors(args)
            if torch.is_grad_enabled() and outs and ins:
                started = []

                def on_out(_):
                    if not started:
                        started.append(True)
                        self._mark(span + 1, "start")

                for t in outs:
                    t.register_hook(on_out)
                for t in ins:
                    t.register_hook(lambda _: self._mark(span + 1, "stop"))
            return out
        return wrapped

    def split(self, ordered: list):
        """``(device us inside the spans, device us outside, markers)`` of
        ``ordered`` (``trace``'s kernels in the device's order)."""
        marks = [i for i, (name, _, _) in enumerate(ordered)
                 if "spin_kernel" in name]
        require(len(marks) == len(self.labels),
                f"{len(marks)} marker kernels traced, {len(self.labels)} "
                f"launched")
        bounds = {}
        for pos, (span, what) in zip(marks, self.labels):
            lo, hi = bounds.get(span, (None, None))
            bounds[span] = (pos if what == "start" and lo is None else lo,
                            pos if what == "stop" else hi)
        inside = [False] * len(ordered)
        for lo, hi in bounds.values():
            if lo is not None and hi is not None:
                for i in range(lo, hi + 1):
                    inside[i] = True
        marked = set(marks)
        scan = sum(us for i, (_, _, us) in enumerate(ordered)
                   if inside[i] and i not in marked)
        other = [(name, us) for i, (name, _, us) in enumerate(ordered)
                 if not inside[i] and i not in marked]
        return scan, other, len(marks)


def mixer_train_full(seed: int, dev, reset_counts, read_counts, arch: str,
                     cut, micro: int, tag: str) -> dict:
    """Phase 19 (a), one model: ``arch`` at full width (cut to ``cut``
    layers if given) from ``seed``, ``MIXER_TRAIN_BATCH`` x
    ``MIXER_TRAIN_SEQ`` tokens a step in ``micro`` microbatches: a warm-up
    step, ``MIXER_TRAIN_STEPS`` timed steps (no hand-written kernel
    launched) and one traced step, its device time split into the mixers'
    recurrences (:class:`ScanMarks`: mamba's ``SelectiveScan``, the
    mLSTM's ``mlstm_chunks`` and the sLSTM's ``slstm_scan``, forward,
    recompute and backward, their own small products included), the other
    products and the rest."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline_for
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models import new_model
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.train import (AdamW, init_state, make_train_step,
                                   warmup_cosine)

    cfg = get_config(arch)
    if cut is not None:
        cfg = dataclasses.replace(cfg, n_layers=cut)
    t0 = time.perf_counter()
    model = new_model(cfg, device=dev, param_dtype=torch.float32)
    adamw = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 1,
                                              MIXER_TRAIN_STEPS + 1))
    state = init_state(model, adamw, seed)
    step = make_train_step(model, adamw, microbatches=micro)
    pipe = pipeline_for(cfg, seq_len=MIXER_TRAIN_SEQ,
                        global_batch=MIXER_TRAIN_BATCH, seed=seed, device=dev)
    torch.cuda.synchronize()
    rec = dict(init_s=time.perf_counter() - t0, layers=cfg.n_layers,
               kinds=sorted({ls.kind for ls in cfg.layers}),
               params=sum(p.numel() for p in model.parameters()),
               losses=[], step_s=[], launches=[])
    t0 = time.perf_counter()
    state, metrics = step(state, pipe.batch(0))          # warm-up
    rec["losses"].append(float(metrics["loss"]))
    rec["warmup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, MIXER_TRAIN_STEPS + 1):
        batch = pipe.batch(i)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        counts = read_counts()
        rec["launches"].append(counts)
        require(not any(counts.values()),
                f"{tag} step {i} launches {counts}: no hand-written kernel "
                f"is on a recurrent model's training path (flash_attention "
                f"and flash_attention_bwd 0)")
        rec["losses"].append(float(metrics["loss"]))
        rec["grad_norm"] = float(metrics["grad_norm"])
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    batch = pipe.batch(MIXER_TRAIN_STEPS + 1)
    marks = ScanMarks()
    saved = (mamba_lib.SelectiveScan, xlstm_lib.mlstm_chunks,
             xlstm_lib.slstm_scan)
    mamba_lib.SelectiveScan = types.SimpleNamespace(
        apply=marks.wrap(saved[0].apply))
    xlstm_lib.mlstm_chunks = marks.wrap(saved[1])
    xlstm_lib.slstm_scan = marks.wrap(saved[2])
    box, ordered = {}, []

    def last_step():
        box["state"], box["metrics"] = step(state, batch)

    t0 = time.perf_counter()
    try:
        by_kernel = trace(tag, "a train step", last_step, ordered=ordered)
    finally:
        rec["traced_s"] = time.perf_counter() - t0
        (mamba_lib.SelectiveScan, xlstm_lib.mlstm_chunks,
         xlstm_lib.slstm_scan) = saved
    rec["losses"].append(float(box["metrics"]["loss"]))
    if by_kernel:
        t_split = time.perf_counter()
        scan_us, other, n_marks = marks.split(ordered)
        products = sum(us for name, us in other if is_gemm(name)) / 1e3
        rest = sum(us for name, us in other if not is_gemm(name)) / 1e3
        rec["trace"] = dict(busy_ms=sum(by_kernel.values()) / 1e3,
                            mixer_scan_ms=scan_us / 1e3,
                            products_ms=products, rest_ms=rest,
                            kernels=len(ordered), markers=n_marks,
                            split_s=time.perf_counter() - t_split)
        print(f"{tag} traced step: device busy {rec['trace']['busy_ms']:.1f}"
              f" ms = mixer scans {scan_us / 1e3:.1f} ms (their own small "
              f"products included), other products {products:.1f} ms, rest "
              f"{rest:.1f} ms ({len(ordered)} kernels, {n_marks} markers; "
              f"the traced step and its summary {rec['traced_s']:.1f} s, "
              f"the split {rec['trace']['split_s']:.1f} s)", flush=True)
    require(all(torch.isfinite(torch.tensor(rec["losses"]))),
            f"{tag}: losses {rec['losses']} not finite")
    tokens = MIXER_TRAIN_BATCH * MIXER_TRAIN_SEQ
    step_s = statistics.median(rec["step_s"])
    rec.update(tokens_per_step=tokens, microbatches=micro,
               step_median_s=step_s, tokens_per_s=tokens / step_s)
    print(f"{tag} {rec['params'] / 1e9:.4f} B parameters ({cfg.n_layers} "
          f"layers: {', '.join(rec['kinds'])}; d={cfg.d_model}), float32 "
          f"masters; steps of {MIXER_TRAIN_BATCH} x {MIXER_TRAIN_SEQ} tokens "
          f"in {micro} microbatch(es): warm-up {rec['warmup_s']:.3f} s, "
          f"{[round(t, 4) for t in rec['step_s']]} s (median {step_s:.4f} s,"
          f" {tokens / step_s:.6g} tokens/s); peak device memory "
          f"{rec['peak_gib']:.3f} GiB; losses {rec['losses']}; no "
          f"hand-written kernel launched", flush=True)
    del model, state, box
    return rec


COMM_WORKER = """
import sys, time
import torch
rank, world, address, device, src, out_path, n = sys.argv[1:8]
rank, world, n = int(rank), int(world), int(n)
sys.path.insert(0, src)
from repro_torch import comm
from repro_torch.launch.mesh import distributed_initialize
dev = torch.device(device)
if dev.type == "cuda":                 # every rank on the one card
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
used = distributed_initialize(address, world, rank, backend="gloo",
                              device=dev)
gen = torch.Generator().manual_seed(1000 + rank)
x = (torch.randn(n, generator=gen) * (1 + rank)).to(dev)
out = {}
for name, fn in (("ring", comm.ring_all_reduce_mean),
                 ("compressed", comm.compressed_all_reduce_mean)):
    fn(x[:4096])                       # a warm-up of the group's links
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out[name] = (got.cpu(), time.perf_counter() - t0)
torch.save(out, out_path)
torch.distributed.destroy_process_group()
print("COMM_OK", rank, used)
"""


def comm_check(dev, tag: str) -> dict:
    """Phase 19 (d): :data:`COMM_WORKER` as two gloo processes on the card
    (both ranks on it, as phase 14 (b) runs them) and two on the CPU, each
    rank with its own ``COMM_FLOATS``-float leaf: the ring mean within
    float32 rounding of the exact mean, the compressed mean within the
    int8 quantisation's error of it, and both on the card bitwise the
    CPU's."""
    import socket
    import tempfile
    import torch

    def start(device, where, tmp):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            address = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
        paths = [Path(tmp) / f"{where}{r}.pt" for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", COMM_WORKER, str(r), "2", address,
             device, str(ROOT / "src"), str(paths[r]), str(COMM_FLOATS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        return procs, paths

    t0 = time.perf_counter()
    got = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        jobs = {where: start(device, where, tmp)
                for where, device in COMM_RUNS}
        try:
            for where, (procs, paths) in jobs.items():
                for r, p in enumerate(procs):
                    stdout, stderr = p.communicate(timeout=300)
                    require(p.returncode == 0 and f"COMM_OK {r}" in stdout,
                            f"{tag} {where} rank {r} failed: "
                            f"{stderr[-3000:]}")
                got[where] = [torch.load(path) for path in paths]
        finally:
            for procs, _ in jobs.values():
                for p in procs:
                    if p.poll() is None:
                        p.kill()
    xs = [torch.randn(COMM_FLOATS, generator=torch.Generator().manual_seed(
        1000 + r)) * (1 + r) for r in range(2)]
    exact = (xs[0].double() + xs[1].double()) / 2
    rounding = float(torch.finfo(torch.float32).eps) * (
        xs[0].abs() + xs[1].abs()).double()
    out = {}
    for name in ("ring", "compressed"):
        card = [g[name][0] for g in got[COMM_RUNS[0][0]]]
        host = [g[name][0] for g in got[COMM_RUNS[1][0]]]
        require(all(torch.equal(c, card[0]) for c in card)
                and all(torch.equal(c, h) for c, h in zip(card, host)),
                f"{tag} {name}: the ranks' means differ, or the card's "
                f"from the CPU's")
        err = (card[0].double() - exact).abs()
        if name == "ring":
            require(bool((err <= rounding).all()),
                    f"{tag} ring mean off the exact mean by "
                    f"{float(err.max()):.3g}")
        else:
            # a rank's value moves by at most half its block's scale, plus
            # 127 times the scale's bfloat16 rounding (2^-8 of it)
            moved = sum(x.reshape(-1, 256).abs().amax(1).double() / 127
                        for x in xs) / 2 * (0.5 + 127 * 2.0 ** -8)
            require(bool((err.reshape(-1, 256)
                          <= moved[:, None] * (1 + 1e-6)).all()),
                    f"{tag} compressed mean off by more than the "
                    f"quantisation's error")
        out[name] = dict(max_err=float(err.max()),
                         card_s=max(g[name][1] for g in got[COMM_RUNS[0][0]]),
                         cpu_s=max(g[name][1] for g in got[COMM_RUNS[1][0]]))
    out["wall_s"] = time.perf_counter() - t0
    print(f"{tag} two gloo processes, a {COMM_FLOATS:,}-float leaf a rank: "
          f"ring mean {out['ring']['card_s']:.4f} s on the card "
          f"({out['ring']['cpu_s']:.4f} s on the CPU), max error "
          f"{out['ring']['max_err']:.3g} (within float32 rounding); "
          f"compressed mean {out['compressed']['card_s']:.4f} s "
          f"({out['compressed']['cpu_s']:.4f} s), max error "
          f"{out['compressed']['max_err']:.3g} (within the int8 "
          f"quantisation's); both bitwise the CPU's; "
          f"{out['wall_s']:.1f} s with the start-up", flush=True)
    return out


def restart_check(arch: str, layers, seed: int, dev, tag: str,
                  ckpt_name: str) -> dict:
    """``train_loop`` on ``arch`` reduced (cut to ``layers`` if given) on
    the card, uninterrupted and with a ``FailureInjector`` at
    ``TRAIN_FAIL_AT``: the losses after the restart and the final
    parameters bit for bit the uninterrupted run's (phases 18 (d) and 19
    (c))."""
    import shutil
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.fault import FailureInjector
    from repro_torch.launch.train import train_loop

    t0 = time.perf_counter()
    small = reduced_config(arch)
    if layers is not None:
        small = dataclasses.replace(small, n_layers=layers)
    ckpt = ROOT / "build" / ckpt_name
    shutil.rmtree(ckpt, ignore_errors=True)
    straight, losses = train_loop(small, ckpt_dir=ckpt / "straight",
                                  seed=seed, device=dev, **TRAIN_LOOP)
    restarted, again = train_loop(
        small, ckpt_dir=ckpt / "restarted", seed=seed, device=dev,
        failure_injector=FailureInjector(schedule={TRAIN_FAIL_AT: 0}),
        **TRAIN_LOOP)
    resumed_at = (TRAIN_FAIL_AT // TRAIN_LOOP["ckpt_every"]
                  * TRAIN_LOOP["ckpt_every"])
    require(again[:TRAIN_FAIL_AT] == losses[:TRAIN_FAIL_AT]
            and again[TRAIN_FAIL_AT:] == losses[resumed_at:],
            f"{tag} losses after the restart {again}, uninterrupted "
            f"{losses}")
    require(all(torch.equal(restarted.params[k], v)
                for k, v in straight.params.items()),
            f"{tag} the restarted run ended with other parameters")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = dict(losses=losses, restarted=again,
               wall_s=time.perf_counter() - t0)
    print(f"{tag} train_loop on the card ({arch}): a failure at step "
          f"{TRAIN_FAIL_AT} resumed from step {resumed_at}; losses {again} "
          f"against {losses} uninterrupted, the same bits and the same "
          f"final parameters; {out['wall_s']:.1f} s", flush=True)
    return out


def mixers_train_phase(seed: int, dev, reset_counts, read_counts, *,
                       card_name="", full=MIXER_TRAIN) -> dict:
    """Phase 19: the recurrent mixers' training. (a) ``full``'s models at
    full width; (b) one period of jamba-v0.1-52b and of xlstm-125m,
    reduced, on the card against the CPU without the recompute (jamba's
    attention layer through the flash kernels: 1 forward and 1 backward
    launch a loss); (c)
    ``train_loop``'s restart at reduced xlstm-125m; (d) the all-reduce
    means over two gloo processes."""
    import torch

    t_phase = time.perf_counter()
    out = {"full": {}}
    for arch, cut, micro in full:
        t0 = time.perf_counter()
        tag = f"[19a] {arch}" + (f" cut to {cut} layer(s)" if cut else "")
        rec = mixer_train_full(seed, dev, reset_counts, read_counts, arch,
                               cut, micro, tag)
        rec["wall_s"] = time.perf_counter() - t0
        rec["card"] = card_name
        out["full"][arch] = rec
        torch.cuda.empty_cache()
        print(f"{tag} {rec['wall_s']:.1f} s", flush=True)

    t0 = time.perf_counter()
    out["cpu_check"] = checks = card_against_cpu_train(
        seed, dev, "[19b]", archs=MIXER_CPU_ARCHS, tols=MIXER_TRAIN_TOLS,
        reset_counts=reset_counts, read_counts=read_counts, remat=False)
    for dname in ("bfloat16", "float32"):
        got = checks[f"jamba-v0.1-52b {dname}"]["launches"]
        want = {"flash_attention": 1, "flash_attention_bwd": 1}
        require(all(got[k] == n for k, n in want.items()) and not any(
            n for k, n in got.items() if k not in want),
            f"[19b] jamba {dname}: launches {got}, expected {want} (its "
            f"attention layer's forward and backward) and nothing else")
        got = checks[f"xlstm-125m {dname}"]["launches"]
        require(not any(got.values()), f"[19b] xlstm {dname}: launches "
                f"{got}, expected none")
    out["flash_launches"] = {k: sum(checks[f"jamba-v0.1-52b {d}"][
        "launches"][k] for d in ("bfloat16", "float32"))
        for k in ("flash_attention", "flash_attention_bwd")}
    print(f"[19b] {time.perf_counter() - t0:.1f} s", flush=True)

    out["restart"] = restart_check("xlstm-125m", MIXER_CPU_ARCHS[1][1], seed,
                                   dev, "[19c]", "phase19_ckpt")
    out["comm"] = comm_check(dev, "[19d]")
    out["wall"] = time.perf_counter() - t_phase
    print(f"[19] phase 19: {out['wall']:.1f} s on {card_name}", flush=True)
    return out


def dryrun_phase(dev, read_counts, step_s: float, *, card_name="") -> dict:
    """Phase 20: the dry run (``repro_torch.launch.dryrun``, counted on
    the ``meta`` device) on the card's machine: (a) stablelm-1.6b at phase
    18 (b)'s shape (TRAIN_BATCH x TRAIN_SEQ tokens, TRAIN_MICRO
    microbatches) on a 1×1 logical mesh, its roofline terms beside phase
    18 (b)'s measured median step ``step_s``; (b) the production cell
    ``single_stablelm-1.6b_train_4k``; (c) the hill climb's cell 3
    baseline. Nothing may launch a kernel or allocate card memory; the
    records go to ``build/``."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import LogicalMesh

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    launches, allocated = read_counts(), torch.cuda.memory_allocated(dev)
    out = {}
    cfg = get_config(TRAIN_ARCH)
    mesh = LogicalMesh(("data", "model"), (1, 1))
    rec = dryrun.measure(TRAIN_ARCH, "phase18", mesh, None, TRAIN_MICRO,
                         shape=ShapeConfig("phase18", TRAIN_SEQ, TRAIN_BATCH,
                                           "train"))
    out["phase18_shape"] = rec
    terms, ca = rec["roofline"], rec["cost_analysis"]
    six_nd = 6.0 * cfg.active_param_count_estimate() * TRAIN_BATCH * TRAIN_SEQ
    # the products: 6·N·D, the per-block recompute's forward (up to 2·N·D
    # more) and attention
    require(six_nd <= ca["product_flops"] <= 8 * six_nd + 3 * ca[
        "attention_flops"] and ca["attention_flops"] > 0,
        f"[20a] product FLOPs {ca['product_flops']:.4g} outside [6, 8]·N·D "
        f"({six_nd:.4g}) plus attention")
    t_roof = max(terms["t_compute"], terms["t_memory"],
                 terms["t_collective"])
    print(f"[20a] dry run of {TRAIN_ARCH} at {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, {TRAIN_MICRO} microbatches, 1x1 mesh ({rec['compile_s']}"
          f" s): {ca['product_flops']:.4e} product FLOPs "
          f"({ca['product_flops'] / six_nd:.3f} x 6ND), "
          f"{ca['flops']:.4e} FLOPs, {ca['bytes accessed']:.4e} bytes; "
          f"T_comp {terms['t_compute']:.4f} s, T_mem {terms['t_memory']:.4f}"
          f" s, T_coll {terms['t_collective']:.4f} s ({terms['bottleneck']}"
          f"-bound, data-sheet rates of {terms['hardware']}); phase 18 (b) "
          f"measured {step_s:.4f} s a step on {card_name} "
          f"({step_s / t_roof:.2f} x the roofline); activation peak "
          f"(estimate) {rec['memory']['temp_bytes'] / 2**30:.3f} GiB",
          flush=True)
    out["phase18_step_s"] = step_s
    prod = dryrun.run_cell(TRAIN_ARCH, "train_4k", "single",
                           out_dir=ROOT / "build" / "dryrun_torch",
                           verbose=False)
    require(prod["status"] == "ok", f"[20b] {prod.get('error')}")
    t = prod["roofline"]
    require(all(math.isfinite(t[k]) and t[k] > 0 for k in (
        "t_compute", "t_memory", "t_collective")), f"[20b] terms {t}")
    print(f"[20b] {prod['cell']}: T_comp {t['t_compute'] * 1e3:.2f} ms, "
          f"T_mem {t['t_memory'] * 1e3:.2f} ms, T_coll "
          f"{t['t_collective'] * 1e3:.2f} ms ({t['bottleneck']}-bound; "
          f"useful-FLOPs ratio {t['useful_flops_ratio']:.3f}); state "
          f"{prod['memory']['state_bytes'] / 1e9:.3f} GB a device, "
          f"activation peak (estimate) {prod['memory']['temp_bytes'] / 1e9:.3f}"
          f" GB; {prod['compile_s']} s", flush=True)
    out["production"] = prod
    c3 = hillclimb.cell3(["baseline_fp32"],
                         out_dir=ROOT / "build" / "perf_torch")["baseline_fp32"]
    out["cell3"] = c3
    torch.cuda.synchronize()
    require(read_counts() == launches,
            "[20] the dry run launched a kernel")
    require(torch.cuda.memory_allocated(dev) == allocated,
            "[20] the dry run allocated card memory")
    out["wall"] = time.perf_counter() - t_phase
    print(f"[20] phase 20: {out['wall']:.1f} s (budget 20 s); no kernel "
          f"launched, no card memory allocated", flush=True)
    return out


def sample_check(tag, engine, batch, steps, logits, seed, prng, cfg) -> dict:
    """Sampling at ``SAMPLE_TEMPERATURE`` with ``engine``'s model: two
    ``generate`` runs with one key give the same tokens, another key other
    ones; ``_sample`` on the card, on the prefill's bfloat16 logits with
    ``SAMPLE_KEYS`` keys at once and a few one at a time, is bit for bit
    ``_sample`` on the CPU of the same logits copied to the host and the
    same keys."""
    import torch
    from repro_torch.serve import ServeEngine
    t0 = time.perf_counter()
    hot = ServeEngine(engine.model, max_len=engine.max_len,
                      temperature=SAMPLE_TEMPERATURE)
    key = prng.PRNGKey(seed + 11)
    first = hot.generate(batch, steps, key=key)
    require(torch.equal(hot.generate(batch, steps, key=key), first),
            f"{tag}: two sampled generate runs with one key differ")
    require(bool(((first >= 0) & (first < cfg.vocab_size)).all()),
            f"{tag}: sampled tokens outside the vocabulary")
    other = hot.generate(batch, steps, key=prng.PRNGKey(seed + 12))
    require(not torch.equal(other, first),
            f"{tag}: two keys drew the same {tuple(first.shape)} tokens")
    keys = prng.split(prng.PRNGKey(seed + 13), SAMPLE_KEYS)
    host = logits.cpu()
    card = hot._sample(logits, keys.to(logits.device))
    require(card.device == logits.device
            and torch.equal(card.cpu(), hot._sample(host, keys)),
            f"{tag}: _sample on the card differs from the CPU's over "
            f"{SAMPLE_KEYS} keys")
    for i in (0, 1, SAMPLE_KEYS - 1):
        require(torch.equal(hot._sample(logits, keys[i].to(logits.device))
                            .cpu(), hot._sample(host, keys[i])),
                f"{tag}: _sample on the card differs from the CPU's "
                f"(key {i})")
    distinct = len(torch.unique(card))
    wall = time.perf_counter() - t0
    print(f"{tag} sampling at temperature {SAMPLE_TEMPERATURE}: generate "
          f"twice with one key gives the same tokens (first tokens "
          f"{first[:2, :6].tolist()}), another key others; _sample on the "
          f"card bitwise the CPU's on the same bfloat16 logits over "
          f"{SAMPLE_KEYS} keys at once and 3 one at a time ({distinct} "
          f"distinct tokens; {wall:.1f} s)", flush=True)
    return dict(temperature=SAMPLE_TEMPERATURE, keys=SAMPLE_KEYS,
                distinct_tokens=distinct, first_tokens=first[:2].tolist(),
                wall_s=wall)


def any_c_phase(dev, values_any, gen_any, ops, ref, ar_mod, timing,
                equal) -> None:
    """Phase 6's matrix-kernel checks and times: at the any-C back-end's
    shape (N=512, C=15,553, (C,) masks) the resolve of 4 lanes and of one
    lane bitwise the plain version on the card and the CPU, both rules;
    each launch (resolve, merge) timed beside its plain version and its
    device time from a trace; then the day-sized shape (``ANY_C_DAY``):
    the one launch for 32 lanes against 32 one-lane launches, bitwise the
    plain version on the card, beside its byte bound and issue floor."""
    import torch
    n_any, c_any = values_any.shape
    v_any = values_any.to(dev)
    mult4 = (torch.rand((4, c_any), generator=gen_any) + 0.5).to(dev)
    act4 = (torch.rand((4, c_any), generator=gen_any) < 0.8).to(dev)
    res4 = torch.tensor([0.0, 0.05, 0.1, 0.05], device=dev)
    for kind in KINDS:
        second = kind == KINDS[1]
        what = f"auction_resolve {kind} C={c_any} N={n_any}"
        got = ops.resolve_lanes(v_any, mult4, act4, res4,
                                second_price=second)
        want = ref.resolve_lanes_ref(v_any, mult4, act4, res4, second)
        on_cpu = ref.resolve_lanes_ref(values_any, mult4.cpu(), act4.cpu(),
                                       res4.cpu(), second)
        for name, a, b, c in zip(("winners", "prices"), got, want, on_cpu):
            equal(name, a, b, f"{what} S=4")
            equal(name, a.cpu(), c, f"{what} S=4 on the CPU")
        one = ops.resolve_masked(v_any, mult4[2], act4[2], res4[2],
                                 second_price=second, sums=False)
        one_plain = ref.resolve_masked_ref(v_any, mult4[2], act4[2], res4[2],
                                           second_price=second)
        for name, a, b, c in zip(("winners", "prices"), one, one_plain,
                                 got):
            equal(name, a, b, f"{what} S=1")
            equal(name, a, c[2], f"{what} S=1 against lane 2 of S=4")
    chunks, cols = ar_mod.chunk_plan(
        n_any, c_any, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    parts = ar_mod.resolve_chunks_cuda(v_any, mult4, act4, res4,
                                       second_price=False)
    m1, a1, r1 = mult4[:1], act4[:1], res4[:1]
    timing["auction_resolve"] = (
        cuda_ms(lambda: ar_mod.resolve_chunks_cuda(
            v_any, mult4, act4, res4, second_price=False), 50),
        cuda_ms(lambda: ref.resolve_chunks_ref(
            v_any, mult4, act4, res4, chunk_cols=cols), 3), None)
    timing["auction_resolve_merge"] = (
        cuda_ms(lambda: ar_mod.merge_chunks_cuda(*parts,
                                                 second_price=False), 50),
        cuda_ms(lambda: ref.merge_chunks_ref(*parts), 10), None)
    timing["auction_resolve_calls"] = {
        "s4": cuda_ms(lambda: ops.resolve_lanes(v_any, mult4, act4, res4),
                      50),
        "s1": cuda_ms(lambda: ops.resolve_lanes(v_any, m1, a1, r1), 50),
        "s1_plain": cuda_ms(lambda: ref.resolve_lanes_ref(v_any, m1, a1, r1),
                            10)}
    device = {}
    for lanes, (m, a, r) in (("s4", (mult4, act4, res4)),
                             ("s1", (m1, a1, r1))):
        traced = trace("[6]", f"20 any-C resolves, {lanes}", lambda: [
            ops.resolve_lanes(v_any, m, a, r) for _ in range(20)])
        for key, us in traced.items():
            for kernel in ("matrix_lanes_kernel", "merge_kernel"):
                if kernel in key:
                    device[f"{kernel}_{lanes}"] = us / 20 / 1e3
    timing["auction_resolve_device"] = device
    s = 4
    timing["auction_resolve_bound"] = bound_ms(
        n_any * c_any * 4 + s * (c_any * 5 + 4) + s * chunks * n_any * 12,
        s * n_any * c_any * 2)
    timing["auction_resolve_merge_bound"] = bound_ms(
        s * chunks * n_any * 12 + s * n_any * 8, s * n_any * chunks * 2)
    timing["auction_resolve_shape"] = (n_any, c_any, chunks, cols)
    print(f"[6] auction_resolve at the any-C back-end's shape (N={n_any}, "
          f"C={c_any}, (C,) masks, {chunks} chunks of {cols}): S=4 and S=1 "
          f"bitwise the plain version on the card and the CPU, both rules; "
          f"resolve launch {timing['auction_resolve'][0]:.4f} ms, merge "
          f"{timing['auction_resolve_merge'][0]:.4f} ms; a whole call S=4 "
          f"{timing['auction_resolve_calls']['s4']:.4f} ms, S=1 "
          f"{timing['auction_resolve_calls']['s1']:.4f} ms; device time a "
          f"launch {device}", flush=True)
    del v_any, parts

    # the day-sized shape: one launch for 32 lanes against 32 one-lane
    # launches of the same kernel
    n_day, c_day, s_day = ANY_C_DAY
    gen = torch.Generator(device=dev).manual_seed(7)
    v_day = torch.rand((n_day, c_day), generator=gen, device=dev)
    m_day = torch.rand((s_day, c_day), generator=gen, device=dev) + 0.5
    a_day = torch.rand((s_day, c_day), generator=gen, device=dev) < 0.8
    r_day = torch.linspace(0.0, 0.3, s_day, device=dev)
    got = ops.resolve_lanes(v_day, m_day, a_day, r_day)
    for lane in (0, 17, 31):
        want = ref.resolve_masked_ref(v_day, m_day[lane], a_day[lane],
                                      r_day[lane])
        equal("winners", got[0][lane], want[0], f"day-sized lane {lane}")
        equal("prices", got[1][lane], want[1], f"day-sized lane {lane}")
    del got, want
    all_ms = cuda_ms(lambda: ops.resolve_lanes(v_day, m_day, a_day, r_day),
                     5)
    per_lane_ms = cuda_ms(lambda: [
        ops.resolve_lanes(v_day, m_day[i:i + 1], a_day[i:i + 1],
                          r_day[i:i + 1]) for i in range(s_day)], 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    threads = s_day // ANY_C_LANES * n_day
    fast = (s_day * n_day * c_day * ANY_C_LANE_INSTRUCTIONS
            + threads * c_day * (ANY_C_LANES / 4 + 1) + threads * c_day / 4)
    fires = scan_fires(v_day, m_day, a_day, r_day, ANY_C_LANES)
    updates = fires * (ANY_C_LANES * ANY_C_UPDATE_INSTRUCTIONS + 1)
    per_ms = sms * 128 * clock_hz / 1e3
    floor = (fast + updates) / per_ms
    day_bound = bound_ms(n_day * c_day * 4 + s_day * (c_day * 5 + 4)
                         + s_day * n_day * 8, s_day * n_day * c_day * 2)
    timing["auction_resolve_day"] = dict(
        shape=list(ANY_C_DAY), ms=all_ms, one_lane_launches_ms=per_lane_ms,
        bound_ms=day_bound[0], bound_by=day_bound[1], issue_floor_ms=floor,
        fast_path_floor_ms=fast / per_ms, update_fires=fires)
    print(f"[6] auction_resolve at N={n_day}, C={c_day}, S={s_day}: one "
          f"launch {all_ms:.4f} ms, {s_day} one-lane launches "
          f"{per_lane_ms:.4f} ms; bound {day_bound[0]:.4f} ms "
          f"({day_bound[1]}), issue floor {floor:.4f} ms: the fast path "
          f"{fast / (s_day * n_day * c_day):.4f} instructions a (lane, row, "
          f"campaign), {fast / per_ms:.4f} ms, and {fires} fired any-tests "
          f"of {ANY_C_LANES} lanes ({fires / (threads * c_day):.3g} of the "
          f"thread-campaigns) x {ANY_C_LANES * ANY_C_UPDATE_INSTRUCTIONS + 1}"
          f" instructions, {updates / per_ms:.4f} ms, over {sms} SMs x 128 a "
          f"cycle at {clock_hz / 1e9:.2f} GHz; lanes 0, 17, 31 bitwise the "
          f"plain version", flush=True)
    del v_day, m_day, a_day


def chunks_phase(dev, env, small, engines, base_sweeps, small_cpu, exact,
                 reset_counts, read_counts, equal) -> dict:
    """Phase 11: event and scenario chunks, naive sampling, multi-slot
    auctions and search at the §7.1 day (``CHUNK_EVENTS``,
    ``S2A_CROSSING_BLOCK``, both rules):
    (a) Algorithm 2 over event chunks, fused and ``sweep_resolve``, the six
    outputs bitwise the unchunked sweep and ``2 × n_chunks`` partials
    launches a round, no ``round_fused``; the torch back-end chunked at
    ``PAPER_SYNTHETIC_CPU`` against the CPU; (b) scenario chunks, alone and
    with event chunks; (c) the peak memory of the ``sweep_resolve`` sweep
    unchunked and chunked; (d) the chunked SORT2AGGREGATE sweep against
    the unchunked one, ``n_chunks`` ``segment_resolve`` and
    ``first_crossing`` launches a pass; (e) ``first_crossing`` with a
    carry, ``segment_resolve`` at a row offset and ``capped_scan`` with a
    scale against their plain versions, timed; (f) naive sampling, one
    ``capped_scan`` launch, bitwise the CPU's loop, its error against the
    exact replay; (g) multi-slot auctions, bitwise the CPU; (h) search,
    the same trajectory on the card and the CPU at the reduced size, timed
    at the full day. Returns the new kernel modes' numbers."""
    import torch
    from repro_torch import prng
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  Segments, naive_sampled_replay,
                                  relative_error,
                                  spend_weighted_relative_error,
                                  sweep_sort2aggregate, sweep_state_machine)
    from repro_torch.core import multislot
    from repro_torch.core import segments as seg_lib
    from repro_torch.core.sequential import inverse_rate
    from repro_torch.kernels.auction_resolve import ref
    from repro_torch.kernels.auction_resolve import segment_resolve as sg_mod
    from repro_torch.kernels.auction_resolve.first_crossing import \
        first_crossing_cuda
    from repro_torch.kernels.capped_scan import ops as scan_ops
    from repro_torch.kernels.capped_scan.ref import capped_scan_ref
    from repro_torch.search import SearchSpace

    t_phase = time.perf_counter()
    n, c = env.values.shape
    out = {}

    def counted(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_counts()

    # (a) and (b): Algorithm 2 over event and scenario chunks
    walls = {}
    for kind in KINDS:
        engine, grid = engines[kind]
        base = base_sweeps[kind]
        rounds = int(base[4].max())
        sweep_args = (env.values, grid.budgets, grid.rules)
        res, wall, cnt = counted(lambda: engine.sweep(
            grid, chunks=CHUNK_EVENTS[0]))
        k = n // CHUNK_EVENTS[0]
        require(cnt["round_fused"] == 0
                and cnt["sweep_partials"] == 2 * k * rounds,
                f"[11] {kind} engine.sweep(chunks={CHUNK_EVENTS[0]}): "
                f"launches {cnt}, expected {2 * k * rounds} partials")
        require(torch.equal(res.results.final_spend, base[0])
                and torch.equal(res.results.cap_times, base[1]),
                f"[11] {kind} chunked engine.sweep differs")
        walls[(kind, "engine", CHUNK_EVENTS[0])] = wall
        for epc, resolve in ((CHUNK_EVENTS[0], "auto"),
                             (CHUNK_EVENTS[0], "sweep_resolve"),
                             (CHUNK_EVENTS[1], "auto")):
            k = n // epc
            got, wall, cnt = counted(lambda: sweep_state_machine(
                *sweep_args, resolve=resolve, chunks=epc))
            if resolve == "auto":
                require(cnt["round_fused"] == 0
                        and cnt["sweep_partials"] == 2 * k * rounds,
                        f"[11] {kind} chunks={epc}: launches {cnt}")
            else:
                require(cnt["sweep_resolve"] == 2 * k * rounds
                        and cnt["segment_partials"] == 2 * k * rounds,
                        f"[11] {kind} sweep_resolve chunks={epc}: {cnt}")
            for name, a, b in zip(OUTPUTS, got, base):
                require(torch.equal(a, b), f"[11] {kind} {resolve} "
                                           f"chunks={epc}: {name} differs")
            walls[(kind, resolve, epc)] = wall
        for kw in (dict(scenario_chunks=8),
                   dict(scenario_chunks=8, chunks=CHUNK_EVENTS[0])):
            got, wall, cnt = counted(lambda: sweep_state_machine(
                *sweep_args, resolve="auto", **kw))
            for name, a, b in zip(OUTPUTS, got, base):
                require(torch.equal(a, b), f"[11] {kind} {kw}: {name} "
                                           f"differs")
            if "chunks" not in kw:
                require(cnt["round_fused"] > rounds
                        and cnt["sweep_partials"] == 2 * cnt["round_fused"],
                        f"[11] {kind} {kw}: launches {cnt}")
            walls[(kind, "scenario_chunks", kw.get("chunks"))] = wall
        print(f"[11] (a, b) {kind}: chunked sweeps bitwise the unchunked "
              f"one ({rounds} rounds): " + ", ".join(
                  f"{r} chunks={e}: {w:.4f} s"
                  for (kd, r, e), w in walls.items() if kd == kind),
              flush=True)
        # the torch back-end chunked at the reduced size, against the CPU
        s_grid_rules = small_cpu[kind]["grid"]
        got = sweep_state_machine(small.values, s_grid_rules.budgets,
                                  s_grid_rules.rules, resolve="torch",
                                  chunks=small.n_events // 8)
        for name, a, b in zip(OUTPUTS, got, small_cpu[kind]["out"]):
            require(torch.equal(a.cpu(), b),
                    f"[11] {kind} torch chunked at N={small.n_events}: "
                    f"{name} differs from the CPU")
    out["walls"] = {f"{k[0]} {k[1]} {k[2]}": v for k, v in walls.items()}

    # (c) peak memory of the sweep_resolve sweep, unchunked and chunked
    engine, grid = engines[KINDS[0]]
    peaks = {}
    for epc in (None, CHUNK_EVENTS[0]):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sweep_state_machine(env.values, grid.budgets, grid.rules,
                            resolve="sweep_resolve", chunks=epc)
        torch.cuda.synchronize()
        peaks[epc] = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_allocated() - before)
    out["peak"] = {str(k): v for k, v in peaks.items()}
    print(f"[11] (c) peak device memory of the sweep_resolve sweep, S=32: "
          f"unchunked {peaks[None][0] / 2**30:.4f} GiB "
          f"({peaks[None][1] / 2**30:.4f} GiB above its inputs), chunks="
          f"{CHUNK_EVENTS[0]} {peaks[CHUNK_EVENTS[0]][0] / 2**30:.4f} GiB "
          f"({peaks[CHUNK_EVENTS[0]][1] / 2**30:.4f} GiB above)", flush=True)

    # (d) the chunked SORT2AGGREGATE sweep
    s2a_walls = {}
    mode_launches = {"first_crossing": 0, "segment_resolve": 0,
                     "capped_scan": 0}
    for kind in KINDS:
        engine, grid = engines[kind]
        caps0 = engine._base_warm_caps(grid, 0, 8, None)
        kw = dict(cap_times_init=caps0, crossing_block=S2A_CROSSING_BLOCK)
        s2a_args = (env.values, grid.budgets, grid.rules)
        whole, wall, _ = counted(lambda: sweep_sort2aggregate(*s2a_args,
                                                              **kw))
        s2a_walls[(kind, None)] = wall
        chunked = {}
        for epc in CHUNK_EVENTS:
            k = n // epc
            got, wall, cnt = counted(lambda: sweep_sort2aggregate(
                *s2a_args, chunks=epc, **kw))
            passes = 8 + 1
            # every pass carried chunk by chunk, caps only (3 device
            # kernels a call; the final spend is the carried total)
            require(cnt["segment_resolve"] == cnt["first_crossing"]
                    == k * passes and cnt["first_crossing_device_kernels"]
                    == 3 * k * passes,
                    f"[11] {kind} S2A chunks={epc}: launches {cnt}, "
                    f"expected {k * passes} of each, "
                    f"{3 * k * passes} first_crossing device kernels")
            for name, a, b in (("cap times", got[0].cap_times,
                                whole[0].cap_times),
                               ("gaps", got[1], whole[1]),
                               ("refine iterations", got[2], whole[2])):
                require(torch.equal(a, b), f"[11] {kind} S2A chunks={epc}: "
                                           f"{name} differ")
            torch.testing.assert_close(got[0].final_spend,
                                       whole[0].final_spend, rtol=1e-4,
                                       atol=0.0)
            chunked[epc] = got
            s2a_walls[(kind, epc)] = wall
            for name in ("first_crossing", "segment_resolve"):
                mode_launches[name] += cnt[name]
        require(torch.equal(chunked[CHUNK_EVENTS[0]][0].final_spend,
                            chunked[CHUNK_EVENTS[1]][0].final_spend),
                f"[11] {kind} S2A final spend differs between chunk sizes")
        via_engine, wall, _ = counted(lambda: engine.sweep(
            grid, method="sort2aggregate", chunks=CHUNK_EVENTS[0],
            crossing_block=S2A_CROSSING_BLOCK))
        require(torch.equal(via_engine.results.final_spend,
                            chunked[CHUNK_EVENTS[0]][0].final_spend)
                and torch.equal(via_engine.results.cap_times,
                                chunked[CHUNK_EVENTS[0]][0].cap_times),
                f"[11] {kind} engine.sweep S2A chunked differs")
        s2a_walls[(kind, "engine")] = wall
        rel = float(((chunked[CHUNK_EVENTS[0]][0].final_spend
                      - whole[0].final_spend).abs()
                     / whole[0].final_spend.abs().clamp(min=1e-9)).max())
        print(f"[11] (d) {kind}: S2A sweep at crossing_block="
              f"{S2A_CROSSING_BLOCK}: chunked cap times, gaps and refine "
              f"iterations bitwise the unchunked sweep's; final spend "
              f"bitwise across chunk sizes, max relative difference to the "
              f"flat sums {rel:.3g}; " + ", ".join(
                  f"chunks={e}: {w:.4f} s" for (kd, e), w in
                  s2a_walls.items() if kd == kind), flush=True)
        if kind == KINDS[0]:
            s2a_segs = Segments.from_cap_times(whole[0].cap_times, n)
            s2a_grid = grid
    out["s2a_walls"] = {f"{k[0]} {k[1]}": v for k, v in s2a_walls.items()}

    # (e) the kernel modes against their plain versions
    grid = s2a_grid
    seg_args = (grid.rules.multipliers, grid.rules.reserve,
                s2a_segs.boundaries, s2a_segs.masks)
    epc = CHUNK_EVENTS[0]
    k_seg = s2a_segs.masks.shape[1] - 1
    w_all, p_all = sg_mod.segment_resolve_cuda(env.values, *seg_args,
                                               second_price=False)
    s = w_all.shape[0]
    # segment_resolve at an offset: the rows of the whole call
    off = 3 * epc
    rows = env.values[off:off + epc]
    reset_counts()
    w_k, p_k = sg_mod.segment_resolve_cuda(rows, *seg_args,
                                           second_price=False, offset=off)
    torch.cuda.synchronize()
    require(read_counts()["segment_resolve"] == 1,
            "[11] segment_resolve at an offset: one launch")
    equal("winners", w_k, w_all[:, off:off + epc],
          "segment_resolve at an offset against the whole call")
    equal("prices", p_k, p_all[:, off:off + epc],
          "segment_resolve at an offset against the whole call")
    plain = ref.segment_resolve_plain(rows, *seg_args, offset=off)
    equal("winners", w_k, plain[0], "segment_resolve at an offset, plain")
    equal("prices", p_k, plain[1], "segment_resolve at an offset, plain")
    del plain
    sg_bytes, sg_ops, sg_floor = segment_cost(epc, c, s, k_seg)
    out["segment_resolve_offset"] = dict(
        ms=cuda_ms(lambda: sg_mod.segment_resolve_cuda(
            rows, *seg_args, second_price=False, offset=off), 10),
        plain_ms=cuda_ms(lambda: ref.segment_resolve_plain(
            rows, *seg_args, offset=off), 1),
        bound=bound_ms(sg_bytes, sg_ops), issue_floor_ms=sg_floor,
        rows=epc, offset=off)
    # first_crossing with a carry: chunk by chunk, one whole call's bits; a
    # chunk boundary on a crossing
    b = grid.budgets.clone()
    block = S2A_CROSSING_BLOCK
    zero = (torch.zeros((s, c), device=dev),
            torch.full((s, c), n + 1, dtype=torch.int32, device=dev))
    s0_first, _ = seg_lib.crossing_carry(w_all[:, :epc], p_all[:, :epc], b,
                                         c, block, s0=zero[0], cap=zero[1],
                                         offset=0, n_global=n)
    lane0_w = int(w_all[0, epc - 1])
    require(lane0_w >= 0, "[11] lane 0 sells on the first chunk's last row")
    b[0, lane0_w] = s0_first[0, lane0_w]
    whole_cap, _, whole_s0 = first_crossing_cuda(
        w_all, p_all, b, num_campaigns=c, block=block,
        carry=(zero[0], zero[1], 0, n))
    require(int(whole_cap[0, lane0_w]) == epc,
            "[11] the boundary crossing is at the first chunk's end")
    carry = zero
    reset_counts()
    for start in range(0, n, epc):
        carry = seg_lib.crossing_carry(
            w_all[:, start:start + epc], p_all[:, start:start + epc], b, c,
            block, s0=carry[0], cap=carry[1], offset=start, n_global=n)
    torch.cuda.synchronize()
    fc_launches = read_counts()["first_crossing"]
    require(fc_launches == n // epc
            and read_counts()["first_crossing_device_kernels"]
            == 3 * fc_launches,
            "[11] first_crossing carry launches (caps only: 3 device "
            "kernels a call)")
    equal("cap times", carry[1], whole_cap, "first_crossing chunk by chunk")
    equal("running spend", carry[0], whole_s0,
          "first_crossing chunk by chunk")
    # the first two chunks of lane 0 on the CPU
    cpu = (torch.zeros((1, c)), torch.full((1, c), n + 1, dtype=torch.int32))
    card = (zero[0][:1], zero[1][:1])
    for start in (0, epc):
        sl = slice(start, start + epc)
        cpu = seg_lib.crossing_carry(w_all[:1, sl].cpu(), p_all[:1, sl].cpu(),
                                     b[:1].cpu(), c, block, s0=cpu[0],
                                     cap=cpu[1], offset=start, n_global=n)
        card = seg_lib.crossing_carry(w_all[:1, sl], p_all[:1, sl], b[:1], c,
                                      block, s0=card[0], cap=card[1],
                                      offset=start, n_global=n)
        equal("cap times", card[1].cpu(), cpu[1], "first_crossing carry CPU")
        equal("running spend", card[0].cpu(), cpu[0],
              "first_crossing carry CPU")
    w_k, p_k = w_all[:, off:off + epc], p_all[:, off:off + epc]
    c_args = dict(s0=carry[0], cap=zero[1], offset=off, n_global=n)
    out["first_crossing_carry"] = dict(
        split=fc_split("[11]", f"a {epc}-row chunk with a carry, caps only",
                       lambda: seg_lib.crossing_carry(w_k, p_k, b, c, block,
                                                      **c_args)),
        ms=cuda_ms(lambda: seg_lib.crossing_carry(w_k, p_k, b, c, block,
                                                  **c_args), 10),
        plain_ms=cuda_ms(lambda: seg_lib._crossing_scan(
            w_k, p_k, b, c, block, carry[0], zero[1], off, n + 1), 1),
        bound=bound_ms(s * epc * 8 + s * c * 4 * 6,
                       crossing_ops(w_k, epc, c, block)),
        rows=epc, lanes=s)
    del w_all, p_all, w_k, p_k, rows
    # capped_scan with a scale: naive sampling's shape (one lane, 1%)
    engine, grid = engines[KINDS[0]]
    k_sample = NAIVE_SAMPLE
    inv = float(inverse_rate(k_sample, n))
    gen = torch.Generator().manual_seed(11)
    idx = torch.sort(torch.randperm(n, generator=gen)[:k_sample]).values
    sub = env.values[idx.to(dev)]
    scan_args = (grid.budgets[:1], grid.rules.multipliers[:1],
                 grid.rules.reserve[:1])
    reset_counts()
    got = scan_ops.capped_scan(sub, *scan_args, scale=inv)
    torch.cuda.synchronize()
    require(read_counts()["capped_scan"] == 1, "[11] scaled capped_scan")
    want = capped_scan_ref(sub.cpu(), *(x.cpu() for x in scan_args),
                           scale=inv)
    for name, a, w in zip(("winners", "prices", "spend", "cap times"), got,
                          want):
        equal(name, a.cpu(), w, "capped_scan with a scale against the CPU")
    scan_capped = int((want[3] <= k_sample).sum())
    out["capped_scan_scaled"] = dict(
        ms=cuda_ms(lambda: scan_ops.capped_scan(sub, *scan_args, scale=inv),
                   10),
        plain_ms=cuda_ms_once(lambda: capped_scan_ref(sub, *scan_args,
                                                      scale=inv)),
        bound=bound_ms(k_sample * c * 4 + c * 12 + 4 + k_sample * 8 + c * 8,
                       k_sample * c * 3),
        rows=k_sample, lanes=1, capped=scan_capped)
    del sub, got, want

    # (f) naive sampling: one capped_scan launch, the CPU's loop's bits
    naive = {}
    for kind in KINDS:
        engine, grid = engines[kind]
        res, wall, cnt = counted(lambda: engine.simulate(
            method="naive_sampling", sample_size=NAIVE_SAMPLE))
        require(cnt["capped_scan"] == 1 and sum(cnt.values()) == 1,
                f"[11] {kind} naive sampling launches {cnt}")
        mode_launches["capped_scan"] += cnt["capped_scan"]
        t0 = time.perf_counter()
        want = naive_sampled_replay(env.values.cpu(), env.budgets.cpu(),
                                    AuctionRule(
                                        multipliers=engine.base_rule
                                        .multipliers.cpu(),
                                        reserve=engine.base_rule.reserve.cpu(),
                                        kind=kind),
                                    prng.PRNGKey(0), NAIVE_SAMPLE)
        cpu_wall = time.perf_counter() - t0
        equal("spend", res.final_spend.cpu(), want.final_spend,
              f"{kind} naive sampling against the CPU")
        equal("cap times", res.cap_times.cpu(), want.cap_times,
              f"{kind} naive sampling against the CPU")
        s_ref = exact[kind]["spend"][0].cpu()
        naive[kind] = dict(
            wall=wall, cpu_wall=cpu_wall,
            rel_last=float(relative_error(res.final_spend.cpu(), s_ref)),
            swe=float(spend_weighted_relative_error(res.final_spend.cpu(),
                                                    s_ref)),
            capped=int((res.cap_times <= n).sum()),
            capped_exact=int((exact[kind]["caps"][0] <= n).sum()))
        print(f"[11] (f) {kind}: naive sampling, rho = {NAIVE_SAMPLE / n} "
              f"({NAIVE_SAMPLE} events), one capped_scan launch, "
              f"{wall:.4f} s, bitwise the CPU's loop ({cpu_wall:.1f} s); "
              f"against the exact replay of the base design: relative "
              f"error of campaign |C| {naive[kind]['rel_last']:.6f}, "
              f"spend-weighted {naive[kind]['swe']:.6f}, capped "
              f"{naive[kind]['capped']} (exact {naive[kind]['capped_exact']})",
              flush=True)
    out["naive"] = naive
    out["mode_launches"] = mode_launches

    # (g) multi-slot auctions
    rule = multislot.MultiSlotRule.first_price(c, slots=3, device=dev)
    rule_cpu = multislot.MultiSlotRule.first_price(c, slots=3, device="cpu")
    segs = Segments.from_cap_times(exact[KINDS[0]]["caps"][0], n)
    got, wall, cnt = counted(lambda: multislot.aggregate_multislot(
        env.values, segs, env.budgets, rule))
    require(cnt["first_crossing"] == 1, f"[11] multislot launches {cnt}")
    t0 = time.perf_counter()
    want = multislot.aggregate_multislot(
        env.values.cpu(), Segments(boundaries=segs.boundaries.cpu(),
                                   masks=segs.masks.cpu()),
        env.budgets.cpu(), rule_cpu)
    cpu_wall = time.perf_counter() - t0
    for name in ("final_spend", "cap_times", "winners", "prices"):
        equal(name, getattr(got, name).cpu(), getattr(want, name),
              "aggregate_multislot at the full day")
    del got, want
    ms_n = MULTISLOT_SMALL_N
    small_v, small_b = env.values[:ms_n], env.budgets * (ms_n / n)
    seq = multislot.sequential_replay_multislot(small_v, small_b, rule)
    seq_cpu = multislot.sequential_replay_multislot(small_v.cpu(),
                                                    small_b.cpu(), rule_cpu)
    for name in ("final_spend", "cap_times", "winners", "prices"):
        equal(name, getattr(seq, name).cpu(), getattr(seq_cpu, name),
              f"sequential_replay_multislot at N={ms_n}")
    noisy = torch.clamp(seq_cpu.cap_times + 50, max=ms_n + 1)
    ref_caps = multislot.refine_segments_multislot(small_v, small_b, rule,
                                                   noisy)
    ref_cpu = multislot.refine_segments_multislot(small_v.cpu(),
                                                  small_b.cpu(), rule_cpu,
                                                  noisy)
    equal("cap times", ref_caps[0].cpu(), ref_cpu[0],
          f"refine_segments_multislot at N={ms_n}")
    require(ref_caps[1:] == ref_cpu[1:], "[11] multislot refine iterations")
    out["multislot_wall"] = wall
    print(f"[11] (g) aggregate_multislot, 3 slots, N={n}: {wall:.4f} s on "
          f"the card (one first_crossing call), bitwise the CPU "
          f"({cpu_wall:.1f} s); sequential_replay_multislot and "
          f"refine_segments_multislot at N={ms_n} bitwise the CPU "
          f"({int((seq.cap_times <= ms_n).sum())} campaigns capped, refine "
          f"{ref_caps[1]} iterations, converged {ref_caps[2]})", flush=True)

    # (h) search over reserve x budget scale
    space = SearchSpace(reserve=(0.0, 0.1), budget_scale=(0.5, 1.5))
    trajectories = []
    for device in (dev, torch.device("cpu")):
        eng = CounterfactualEngine(small.values[:CPU_CUT_EVENTS],
                                   small.budgets, device=device)
        t0 = time.perf_counter()
        found = eng.search(space, method="hillclimb", budget=32)
        trajectories.append((found, time.perf_counter() - t0))
    (card_found, card_wall), (cpu_found, cpu_wall) = trajectories
    require(card_found.best_point == cpu_found.best_point
            and card_found.ledger.entries == cpu_found.ledger.entries
            and [h["points"] for h in card_found.history]
            == [h["points"] for h in cpu_found.history],
            "[11] search on the card and the CPU took other trajectories")
    eng = CounterfactualEngine(env.values, env.budgets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    day = eng.search(space, method="hillclimb", budget=32)
    torch.cuda.synchronize()
    day_wall = time.perf_counter() - t0
    out["search"] = dict(small_card_wall=card_wall, small_cpu_wall=cpu_wall,
                         day_wall=day_wall, day_evaluations=day.evaluations,
                         day_best=day.best_point)
    print(f"[11] (h) engine.search(reserve x budget_scale, hillclimb, "
          f"budget 32): N={CPU_CUT_EVENTS} the same {card_found.evaluations}"
          f"-evaluation trajectory and best point {card_found.best_point} on "
          f"the card ({card_wall:.2f} s) and the CPU ({cpu_wall:.2f} s); the "
          f"full day {day_wall:.4f} s, {day.evaluations} evaluations, best "
          f"{day.best_point} = {day.best_value:.2f}", flush=True)
    print(f"[11] phase 11: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def crn_phase(dev, env, small, reset_counts, read_counts, equal, *,
              seed: int, chunk: int = CHUNK_EVENTS[0],
              check_rows=CRN_CHECK_ROWS, sample: int = NAIVE_SAMPLE,
              vi_warm=VI_WARM, vi_cpu_epochs: int = VI_SWEEP_CPU_EPOCHS,
              clock_hz: float = 1.98e9) -> dict:
    """Phase 12: CRN scenario families at the §7.1 day, both rules:
    (a) the day's bid-noise normals and participation uniforms in one
    ``crn_cells`` launch each, ``check_rows`` bitwise the CPU's draws, and
    naive sampling's sample drawn on the card from a key made on the CPU
    bitwise the CPU's; (b) a static family of 32 lanes (pauses, boosts,
    per-campaign and all-campaign budget scales, reserves, a full-window
    entrant: C becomes C+1) on ``"auto"`` (the fused round), bitwise the
    family on ``resolve="torch"`` and with ``chunks``; paused campaigns
    spend 0 and never cap; one lane of each kind at ``small``'s size
    bitwise the CPU port; (c) a per-event family of 8 lanes (bid noise,
    participation, a pacing window, their pairs, a sigma=0 / p=1 lane) on
    ``resolve="torch"``: the sigma=0 / p=1 lane bitwise the base lane, two
    identical specs bitwise each other, ``chunks`` bitwise the unchunked
    run, bitwise the CPU at ``small``'s size under the first rule (the
    CPU's per-lane masks take ~20 s a rule there); its wall time,
    ``segment_partials`` launches and peak memory above the inputs;
    ``"fused"`` refuses it with ``check_overlay``'s text; (d)
    ``engine.attribute`` over a pause, the noise and the pacing window (8
    lanes), its Shapley values and efficiency gap; (e) the per-scenario
    warm start's VI (``vi_warm``'s sample) with the per-event overlay, S=8
    in one ``vi`` launch, bitwise the CPU's loop on the same inputs at
    ``vi_cpu_epochs``, and the kernel timed at the full warm start. Returns
    the kernels' timings, bounds and main-path launches."""
    import numpy as np
    import torch
    from repro_torch import prng, scenarios as sc
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, crn)
    from repro_torch.core import vi as vi_lib
    from repro_torch.kernels import crn as crn_ops
    from repro_torch.kernels.auction_resolve import ref
    from repro_torch.kernels.auction_resolve import vi as vi_mod
    from repro_torch.scenarios import CompiledFamily

    t_phase = time.perf_counter()
    n, c = env.values.shape
    out = {"counted": {}, "timing": {}}
    counted = out["counted"]

    def count(cnt, *names):
        for name in names:
            counted[name] = counted.get(name, 0) + cnt[name]

    def run(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_counts()

    def same(a, b, what):
        require(torch.equal(a.results.final_spend.cpu(),
                            b.results.final_spend.cpu())
                and torch.equal(a.results.cap_times.cpu(),
                                b.results.cap_times.cpu()), what)

    key = prng.PRNGKey(seed + 12)             # made on the CPU
    key_z = crn.stream_key(key, "bid_noise")
    key_u = crn.stream_key(key, "participation")

    # (a) the day's draws on the card, a slice of each against the CPU
    gidx = torch.arange(n, dtype=torch.int32, device=dev)
    (z, u), draw_s, cnt = run(lambda: (
        crn.event_campaign_normals(key_z, gidx, c),
        crn.event_campaign_uniforms(key_u, gidx, c)))
    require(cnt["crn_cells"] == 2 and z.device.type == dev.type
            and bool(torch.isfinite(z).all()) and bool((u >= 0).all())
            and bool((u < 1).all()), f"[12] (a) the day's draws: {cnt}")
    t0 = time.perf_counter()
    for lo, hi in check_rows:
        rows = torch.arange(lo, hi)
        equal("crn_cells", z[lo:hi].cpu(),
              crn.event_campaign_normals(key_z, rows, c),
              f"[12] (a) bid-noise normals of events [{lo}, {hi})")
        equal("crn_cells", u[lo:hi].cpu(),
              crn.event_campaign_uniforms(key_u, rows, c),
              f"[12] (a) participation uniforms of events [{lo}, {hi})")
    sample_card = prng.choice(key.to(dev), n, sample)
    equal("naive sample", sample_card.cpu(), prng.choice(key, n, sample),
          "[12] (a) naive sampling's sample drawn on the card")
    cpu_s = time.perf_counter() - t0
    zbuf = torch.empty_like(z)
    cells_ms = cuda_ms(lambda: crn.event_campaign_normals(
        key_z, gidx, c, out=zbuf), 3)
    rows0 = check_rows[0][1] - check_rows[0][0]
    part = gidx[:rows0]
    cells_part_ms = cuda_ms(lambda: crn.event_campaign_normals(
        key_z, part, c, out=zbuf[:rows0]), 3)
    cells_plain_ms = cuda_ms(lambda: crn_ops.cells_plain(
        key_z, part.to(torch.int64), c, True), 1)
    equal("crn_cells", crn_ops.cells_plain(key_z, part.to(torch.int64), c,
                                           True), z[:rows0],
          "[12] (a) crn_cells against its plain version on the card")
    out["timing"]["crn_cells"] = (cells_ms, cells_plain_ms, None)
    int_ops, f32_ops = CRN_CELL_OPS["normal"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["timing"]["crn_cells_bound"] = bound_ms(
        n * 4 + n * c * 4, n * c * f32_ops, int_ops=n * c * int_ops,
        int_ops_per_s=INT32_LANES_PER_SM * sms * clock_hz)
    out["crn_cells_part"] = (rows0, cells_part_ms)
    sigma = torch.full((1, c), 0.2, device=dev)
    noise_ms = cuda_ms(lambda: crn_ops.bid_noise(env.values, z, sigma), 3)
    noise_plain_ms = cuda_ms(lambda: crn_ops.bid_noise_plain(
        env.values, z, sigma), 1)
    equal("bid_noise", crn_ops.bid_noise(env.values, z, sigma),
          crn_ops.bid_noise_plain(env.values, z, sigma),
          "[12] (a) bid_noise against its plain version on the card")
    out["timing"]["bid_noise"] = (noise_ms, noise_plain_ms, None)
    out["timing"]["bid_noise_bound"] = bound_ms(
        n * c * 12 + c * 4, n * c * BID_NOISE_OPS)
    del z, u, zbuf, sigma
    print(f"[12] (a) the day's CRN draws (N={n} x C={c}, bid-noise normals "
          f"and participation uniforms), one crn_cells launch each: "
          f"{draw_s:.4f} s; events {list(check_rows)} and naive sampling's "
          f"{sample}-event sample drawn on the card from a key made on the "
          f"CPU bitwise the CPU's ({cpu_s:.1f} s on the CPU); crn_cells "
          f"{cells_ms:.4f} ms a day of normals ({rows0} events "
          f"{cells_part_ms:.4f} ms, plain {cells_plain_ms:.4f} ms), "
          f"bid_noise {noise_ms:.4f} ms a lane of the day (plain "
          f"{noise_plain_ms:.4f} ms)", flush=True)

    def engine_of(values, budgets, kind, where):
        base = AuctionRule(multipliers=torch.ones(values.shape[1],
                                                  device=where),
                           reserve=torch.zeros((), device=where), kind=kind)
        return CounterfactualEngine(values, budgets, base_rule=base,
                                    device=where)

    def static_groups(nc, entrant_budget):
        entrant = sc.AddEntrant(budget=entrant_budget, value_scale=0.5)
        return [
            [sc.PauseCampaign(i) for i in (0, 3, nc // 6, nc // 3, nc // 2,
                                           nc - 1)],
            [sc.BoostCampaign(i, m) for i, m in (
                (1, 1.5), (5, 2.0), (nc // 5, 1.25), (nc // 2, 0.8),
                (3 * nc // 4, 3.0))],
            [sc.ScaleBudget(i, m) for i, m in (
                (2, 0.5), (nc // 10, 2.0), (nc // 3, 0.25), (3 * nc // 5, 1.5),
                (9 * nc // 10, 0.75))],
            [sc.ScaleBudgets(m) for m in (0.5, 0.8, 1.25, 2.0)],
            [sc.SetReserve(0.02), sc.SetReserve(0.05)],
            [entrant, [entrant, sc.PauseCampaign(3)],
             [entrant, sc.ScaleBudgets(0.8)]],
            [[sc.PauseCampaign(0), sc.BoostCampaign(5, 2.0)],
             [sc.ScaleBudgets(0.8), sc.SetReserve(0.02)],
             [sc.BoostCampaign(1, 1.5), sc.ScaleBudget(2, 0.5)],
             [sc.PauseCampaign(nc // 6), entrant], [sc.ScaleBids(1.1)],
             [sc.ScaleBids(0.9), sc.PauseCampaign(nc // 3)]]]

    def paused(spec):
        specs = spec if isinstance(spec, list) else [spec]
        return [iv.campaign for iv in specs
                if isinstance(iv, sc.PauseCampaign)]

    def per_event_specs(nn, pace):
        noise, part = sc.BidNoise(0.2), sc.ParticipationJitter(0.9)
        pacing = sc.BudgetPacing(pace, nn // 4, 3 * nn // 4)
        null = [sc.BidNoise(0.0), sc.ParticipationJitter(1.0)]
        return [noise, part, pacing, [noise, part], [noise, pacing],
                [part, pacing], null]

    pace = 3
    small_cpu = (small.values.cpu(), small.budgets.cpu())
    results = {}
    for kind in KINDS:
        eng = engine_of(env.values, env.budgets, kind, dev)
        # (b) the static family
        groups = static_groups(c, float(env.budgets.mean()))
        specs = [s for g in groups for s in g]
        fam = sc.compile_family(eng.values, eng.budgets, eng.base_rule, specs,
                                key=key)
        require(fam.num_scenarios == 32 and fam.values.shape[1] == c + 1
                and fam.overlay is not None and not fam.overlay.per_event,
                f"[12] (b) {kind}: the static family's shape")
        auto, auto_s, cnt = run(lambda: eng.sweep(fam))
        require(cnt["round_fused"] > 0 and cnt["segment_partials"] == 0,
                f"[12] (b) {kind} auto: {cnt}")
        count(cnt, "round_fused", "sweep_partials")
        torch_run, torch_s, cnt = run(lambda: eng.sweep(fam,
                                                        resolve="torch"))
        count(cnt, "segment_partials")
        same(auto, torch_run, f"[12] (b) {kind}: torch differs from auto")
        chunked, chunked_s, cnt = run(lambda: eng.sweep(fam, chunks=chunk))
        count(cnt, "sweep_partials")
        same(auto, chunked, f"[12] (b) {kind}: chunks={chunk} differ")
        spend, caps = auto.results.final_spend, auto.results.cap_times
        for lane, spec in enumerate(specs, start=1):
            for pc in paused(spec):
                require(float(spend[lane, pc]) == 0.0
                        and int(caps[lane, pc]) == n + 1,
                        f"[12] (b) {kind}: paused campaign {pc} of lane "
                        f"{lane} spent or capped")
        require(bool(torch.isfinite(spend).all()) and float(spend[0, c]) == 0
                and float(spend[specs.index(groups[5][0]) + 1, c]) > 0,
                f"[12] (b) {kind}: spends not finite, or the entrant's "
                f"column wrong")
        s_card = engine_of(small.values, small.budgets, kind, dev)
        s_cpu = engine_of(*small_cpu, kind, "cpu")
        s_groups = static_groups(small.values.shape[1],
                                 float(small.budgets.mean()))
        cut = [g[0] for g in s_groups]
        t0 = time.perf_counter()
        want = s_cpu.sweep(sc.compile_family(
            s_cpu.values, s_cpu.budgets, s_cpu.base_rule, cut, key=key))
        small_cpu_s = time.perf_counter() - t0
        same(s_card.sweep(sc.compile_family(
            s_card.values, s_card.budgets, s_card.base_rule, cut, key=key)),
            want, f"[12] (b) {kind}: the card differs from the CPU at "
                  f"N={small.values.shape[0]}")
        print(f"[12] (b) {kind}: static family S={fam.num_scenarios} "
              f"C={c}+1: auto (fused) {auto_s:.4f} s, bitwise torch "
              f"({torch_s:.4f} s) and chunks={chunk} ({chunked_s:.4f} s); "
              f"paused campaigns spend 0 and never cap; "
              f"{len(cut) + 1} lanes at N={small.values.shape[0]} bitwise "
              f"the CPU ({small_cpu_s:.1f} s on the CPU)", flush=True)

        # (c) the per-event family
        pfam = sc.compile_family(eng.values, eng.budgets, eng.base_rule,
                                 per_event_specs(n, pace), key=key)
        require(pfam.num_scenarios == 8 and pfam.overlay.per_event,
                f"[12] (c) {kind}: the per-event family's shape")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        pev, pev_s, cnt = run(lambda: eng.sweep(pfam, resolve="torch"))
        peak_above = torch.cuda.max_memory_allocated() - base_mem
        require(cnt["crn_cells"] == 2 and cnt["bid_noise"] == 1
                and cnt["segment_partials"] > 0 and cnt["round_fused"] == 0,
                f"[12] (c) {kind}: launches {cnt}")
        count(cnt, "crn_cells", "bid_noise", "segment_partials")
        sp_launches = cnt["segment_partials"]
        spend = pev.results.final_spend
        require(torch.equal(spend[7], spend[0])
                and torch.equal(pev.results.cap_times[7],
                                pev.results.cap_times[0])
                and all(not torch.equal(spend[i], spend[0])
                        for i in range(1, 7)),
                f"[12] (c) {kind}: the sigma=0 / p=1 lane is not the base "
                f"lane, or an intervention moved nothing")
        pch, pch_s, cnt = run(lambda: eng.sweep(pfam, resolve="torch",
                                                chunks=chunk))
        count(cnt, "crn_cells", "bid_noise", "segment_partials")
        same(pev, pch, f"[12] (c) {kind}: chunks={chunk} differ")
        twin = sc.compile_family(eng.values, eng.budgets, eng.base_rule,
                                 [sc.BidNoise(0.2), sc.BidNoise(0.2)],
                                 key=key)
        tw = eng.sweep(twin, resolve="torch").results
        require(torch.equal(tw.final_spend[1], tw.final_spend[2])
                and torch.equal(tw.cap_times[1], tw.cap_times[2])
                and torch.equal(tw.final_spend[1], spend[1]),
                f"[12] (c) {kind}: identical specs differ")
        try:
            eng.sweep(pfam, resolve="fused")
            refused = ""
        except ValueError as err:
            refused = str(err)
        require("torch resolve path only" in refused,
                f"[12] (c) {kind}: fused did not refuse the per-event "
                f"family: {refused!r}")
        cpu_note = "the CPU comparison under the first rule only"
        if kind == KINDS[0]:
            cut_n = CPU_CUT_EVENTS
            s_card = engine_of(small.values[:cut_n], small.budgets, kind,
                               dev)
            s_cpu = engine_of(small_cpu[0][:cut_n], small_cpu[1], kind,
                              "cpu")
            specs_small = per_event_specs(cut_n, pace)
            t0 = time.perf_counter()
            want = s_cpu.sweep(sc.compile_family(
                s_cpu.values, s_cpu.budgets, s_cpu.base_rule, specs_small,
                key=key), resolve="torch")
            cpu_note = (f"bitwise the CPU at N={cut_n} "
                        f"({time.perf_counter() - t0:.1f} s on the CPU)")
            same(s_card.sweep(sc.compile_family(
                s_card.values, s_card.budgets, s_card.base_rule,
                specs_small, key=key), resolve="torch"), want,
                f"[12] (c) {kind}: the card differs from the CPU at "
                f"N={cut_n}")
        results[kind] = dict(per_event_s=pev_s, chunked_s=pch_s,
                             sp_launches=sp_launches, peak=peak_above,
                             static_s=auto_s, static_torch_s=torch_s,
                             static_chunked_s=chunked_s)
        print(f"[12] (c) {kind}: per-event family S=8 on resolve='torch': "
              f"{pev_s:.4f} s, {sp_launches} segment_partials launches, "
              f"peak {peak_above / 2**30:.4f} GiB above the inputs; "
              f"chunks={chunk} bitwise ({pch_s:.4f} s); the sigma=0 / p=1 "
              f"lane bitwise the base lane and two identical specs bitwise "
              f"each other; {cpu_note}; 'fused' refuses it: "
              f"{refused[:60]}...", flush=True)

        # (d) attribution
        att, att_s, cnt = run(lambda: eng.attribute(
            {"pause3": sc.PauseCampaign(3), "noise": sc.BidNoise(0.2),
             "pacing": sc.BudgetPacing(pace, n // 4, 3 * n // 4)},
            key=key, resolve="torch"))
        count(cnt, "crn_cells", "bid_noise", "segment_partials")
        require(len(att.subset_values) == 8 and att.efficiency_gap
                <= 1e-6 * max(1.0, abs(att.total_delta)),
                f"[12] (d) {kind}: attribution over {att.subset_values}")
        results[kind].update(phi=att.phi, gap=att.efficiency_gap,
                             total_delta=att.total_delta, att_s=att_s)
        print(f"[12] (d) {kind}: engine.attribute over pause[3], noise "
              f"sigma=0.2 and pacing (8 lanes) in {att_s:.4f} s: phi "
              + ", ".join(f"{a} {v:+.4f}" for a, v in att.phi.items())
              + f"; total delta {att.total_delta:+.4f}, efficiency gap "
              f"{att.efficiency_gap:.3g}", flush=True)

        # (e) the warm start's VI with the per-event overlay
        k_warm = max(int(round(n * vi_warm["sample_rate"])),
                     vi_warm["batch_size"])
        warm_kw = dict(sample_size=k_warm, batch_size=vi_warm["batch_size"])
        est, est_s, cnt = run(lambda: vi_lib.estimate_pi_sweep(
            pfam.values, pfam.grid.budgets, pfam.grid.rules, key,
            num_iters=vi_cpu_epochs, eta_decay=vi_warm["eta_decay"],
            overlay=pfam.overlay, **warm_kw))
        require(cnt["vi"] == 1, f"[12] (e) {kind}: launches {cnt}")
        count(cnt, "vi")
        draws = vi_lib._draws(key, n, c, num_iters=vi_cpu_epochs,
                              coupling="shared", device=dev, **warm_kw)
        chain = vi_lib._chain(pfam.values, pfam.grid.budgets, draws,
                              eta=0.5, eta_decay=vi_warm["eta_decay"],
                              overlay=pfam.overlay, **warm_kw)
        draws_cpu = vi_lib._Draws(idx=draws.idx.cpu(), u=draws.u.cpu(),
                                  n_batches=draws.n_batches)
        chain_cpu = vi_lib._Chain(**{
            f: None if getattr(chain, f) is None else getattr(chain, f).cpu()
            for f in ("sampled", "live", "denom", "btilde", "step",
                      "elig")})
        t0 = time.perf_counter()
        lanes = [vi_lib._iterate(chain_cpu.lane(s), AuctionRule(
            multipliers=pfam.grid.rules.multipliers[s].cpu(),
            reserve=pfam.grid.rules.reserve[s].cpu(), kind=kind), draws_cpu,
            sample_size=k_warm, batch_size=vi_warm["batch_size"], pi0=None,
            track_every=0).pi for s in range(8)]
        vi_cpu_s = time.perf_counter() - t0
        equal("pi", est.pi.cpu(), torch.stack(lanes),
              f"[12] (e) {kind}: the vi kernel with the overlay against the "
              f"CPU's loop")
        plain = vi_lib.estimate_pi_sweep(
            pfam.values, pfam.grid.budgets, pfam.grid.rules, key,
            num_iters=vi_cpu_epochs, eta_decay=vi_warm["eta_decay"],
            **warm_kw)
        require(not torch.equal(plain.pi, est.pi),
                f"[12] (e) {kind}: the overlay moved no pi")
        print(f"[12] (e) {kind}: estimate_pi_sweep(overlay=) S=8, {k_warm} "
              f"sampled rows, {vi_cpu_epochs} epoch(s): one vi launch "
              f"({est_s:.4f} s), bitwise the CPU's loop on the same inputs "
              f"({vi_cpu_s:.1f} s on the CPU)", flush=True)
        if kind == KINDS[0]:
            full = vi_lib._draws(key, n, c, num_iters=vi_warm["num_iters"],
                                 coupling="shared", device=dev, **warm_kw)
            fchain = vi_lib._chain(pfam.values, pfam.grid.budgets, full,
                                   eta=0.5, eta_decay=vi_warm["eta_decay"],
                                   overlay=pfam.overlay, **warm_kw)
            args = (fchain.sampled.contiguous(), full.u, fchain.step,
                    fchain.denom, fchain.btilde.contiguous(),
                    pfam.grid.rules.multipliers.contiguous(),
                    pfam.grid.rules.reserve.contiguous(),
                    torch.ones((8, c), device=dev))
            ov_ms = cuda_ms(lambda: vi_mod.vi_cuda(
                *args, sample_size=k_warm, second_price=False,
                elig=fchain.elig.contiguous()), 3)
            p_args = (chain.sampled, draws.u, chain.step, chain.denom,
                      chain.btilde, pfam.grid.rules.multipliers,
                      pfam.grid.rules.reserve, torch.ones((8, c), device=dev))
            ov_plain_ms = cuda_ms_once(lambda: ref.vi_chain_ref(
                *p_args, sample_size=k_warm, elig=chain.elig))
            total, b = full.u.shape[0], vi_warm["batch_size"]
            eb = -(-b * c // 16) * 16
            v_bytes, v_ops, v_floor = vi_cost(full.n_batches, b, c, 1, total,
                                              8, clock_hz)
            v_bytes += 4 * 7 * full.n_batches * b * c \
                + 8 * full.n_batches * eb
            out["vi_overlay"] = dict(
                ms=ov_ms, plain_ms=ov_plain_ms, plain_steps=draws.u.shape[0],
                bound=bound_ms(v_bytes, v_ops), chain_floor_ms=v_floor,
                steps=total, lanes=8,
                staged=vi_mod.staged(b, c, 1, True))
            del full, fchain, args, p_args
        del chain, chain_cpu, draws, draws_cpu, est, plain
    out["results"] = results
    vo = out["vi_overlay"]
    print(f"[12] (e) vi with the overlay at the full warm start (S=8, "
          f"{vo['steps']} steps a lane, per-lane rows and eligibility, "
          f"staged {vo['staged']}): {vo['ms']:.4f} ms, plain "
          f"(ref.vi_chain_ref on the card, {vo['plain_steps']} steps) "
          f"{vo['plain_ms']:.4f} ms, bound {vo['bound'][0]:.4f} ms "
          f"({vo['bound'][1]}), chain floor {vo['chain_floor_ms']:.4f} ms",
          flush=True)
    print(f"[12] phase 12: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def service_phase(dev, env, small, engines, base_sweeps, reset_counts,
                  read_counts, *, epc: int = SERVICE_EPC,
                  slabs=SERVICE_SLABS, small_epc: int = SERVICE_SMALL_EPC,
                  small_slabs=SERVICE_SMALL_SLABS,
                  ask_lanes=SERVICE_ASK_LANES,
                  stream_lanes=SERVICE_STREAM_LANES,
                  ckpt_root: Path = ROOT / "build" / "service_ckpt") -> dict:
    """Phase 13: the always-on counterfactual service
    (``repro_torch.serve.CounterfactualService``) on the §7.1 day, both
    rules, with appends of ``slabs`` rows in chunks of ``epc`` (the second
    fold starts inside a canonical block) and ``stream_lanes`` of phase 4's
    grid registered for streaming before them. (a) The device store: each
    fold's wall, rounds and ``sweep_partials`` launches; ``ask`` tickets
    for ``ask_lanes``, ``sweep(grid)``, a repeated sweep (all cache hits)
    and ``engine().sweep(grid)``, each bitwise phase 4's one-shot fused
    sweep. (b) The host store: the same folds, exact answers and streaming
    frontiers bitwise the device store's; the peak device memory above the
    inputs of both stores' grid replays; the host-streamed replay with
    ``prefetch`` on and off (bitwise); the H2D bytes and time of one
    streamed pass, and of its copies alone. (c) A one-append service's
    frontier bitwise phase 4's sweep; the three-fold frontier at
    ``small``'s size (slabs ``small_slabs`` of whole ``small_epc`` chunks)
    on the card, device and host stores, bitwise the port's CPU service;
    the mid-block fold at full width bitwise the CPU's fold (first price).
    (d) Save after two appends, load, append the last slab: bitwise the
    uninterrupted service; the save and load seconds. ``sweep_partials`` at
    the mid-block fold's shape is timed beside its plain version and bound.
    Returns the numbers and the main path's launches."""
    import shutil
    import torch
    from repro_torch.core import AuctionRule, ScenarioGrid, scenario_rule
    from repro_torch.core import executor
    from repro_torch.kernels.auction_resolve import ops, ref
    from repro_torch.serve import CounterfactualService
    from repro_torch.serve import counterfactual as svc_mod

    t_phase = time.perf_counter()
    n, c = env.values.shape
    out = {"counted": {"round_fused": 0, "sweep_partials": 0,
                       "segment_partials": 0}, "folds": {},
           "resume_launches": 0}
    fold_rounds = []
    fold = svc_mod.execute_sweep_resumable

    def recorded_fold(*args, **kwargs):
        res, carry = fold(*args, **kwargs)
        fold_rounds.append(int(res[4].max()))
        return res, carry

    def count(cnt):
        for name in out["counted"]:
            out["counted"][name] += cnt[name]

    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cnt = read_counts()
        count(cnt)
        return res, wall, cnt

    def make(store, e=env, grid=None, size_epc=epc):
        svc = CounterfactualService(e.budgets, grid.scenario(0)[0],
                                    events_per_chunk=size_epc, store=store,
                                    device=e.values.device)
        for label, lane in stream_lanes.items():
            svc.register(label, *grid.scenario(lane))
        return svc

    def appends(svc, values, sizes, tag):
        walls, start = [], 0
        for k, size in enumerate(sizes):
            fold_rounds.clear()
            _, wall, cnt = timed(lambda: svc.append(values[start:start + size]))
            rounds = max(fold_rounds)
            walls.append(wall)
            if start > 0:               # a fold resumed at a row offset
                out["resume_launches"] += cnt["sweep_partials"]
            print(f"[13] {tag}: fold {k + 1} (events [{start}, "
                  f"{start + size}) of {start + size}, block "
                  f"{-(-(start + size) // 32)}, offset inside a block: "
                  f"{start % -(-(start + size) // 32) != 0}): "
                  f"{wall:.4f} s, {rounds} rounds, "
                  f"{cnt['sweep_partials']} sweep_partials and "
                  f"{cnt['round_fused']} round_fused launches", flush=True)
            start += size
        return walls

    def frontier_equal(a, b, labels, what):
        for label in labels:
            x, y = a.streaming(label), b.streaming(label)
            require(torch.equal(x.final_spend.cpu(), y.final_spend.cpu())
                    and torch.equal(x.cap_times.cpu(), y.cap_times.cpu()),
                    f"{what}: streaming {label!r} differs")

    svc_mod.execute_sweep_resumable = recorded_fold
    try:
        for kind in KINDS:
            engine, grid = engines[kind]
            want_spend, want_caps = base_sweeps[kind][0], base_sweeps[kind][1]

            def same_rows(spend, caps, lanes, what):
                require(torch.equal(spend, want_spend[lanes])
                        and torch.equal(caps, want_caps[lanes]),
                        f"{kind}: {what} differs from phase 4's fused sweep")

            every = list(range(grid.num_scenarios))
            # (a) the device store
            dev_svc = make("device", grid=grid)
            walls = appends(dev_svc, env.values, slabs, f"{kind} device store")
            tickets = [dev_svc.ask(*grid.scenario(s)) for s in ask_lanes]
            _, ask_wall, ask_cnt = timed(dev_svc.flush)
            for s, t in zip(ask_lanes, tickets):
                a = t.result()
                same_rows(a.final_spend, a.cap_times, s, f"ask of lane {s}")
            require(ask_cnt["round_fused"] > 0
                    and dev_svc.stats["batches"] == 1,
                    f"{kind}: the asks did not run one fused replay")
            dev_svc.values                   # the concatenated log
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            swept, sweep_wall, _ = timed(lambda: dev_svc.sweep(grid))
            dev_peak = torch.cuda.max_memory_allocated() - before
            same_rows(swept.results.final_spend, swept.results.cap_times,
                      every, "service.sweep(grid)")
            stats = dict(dev_svc.stats)
            again, _, _ = timed(lambda: dev_svc.sweep(grid))
            bound, _, _ = timed(lambda: dev_svc.engine().sweep(grid))
            require(dev_svc.stats["batches"] == stats["batches"]
                    and dev_svc.stats["hits"] == stats["hits"]
                    + 2 * grid.num_scenarios,
                    f"{kind}: a repeated sweep was not all cache hits")
            for res, what in ((again, "the repeated sweep"),
                              (bound, "engine().sweep(grid)")):
                same_rows(res.results.final_spend, res.results.cap_times,
                          every, what)
            log_bytes = sum(x.numel() * 4 for x in dev_svc._slabs) + \
                dev_svc.values.numel() * 4
            print(f"[13] {kind} (a): {len(ask_lanes)} asks in one flush "
                  f"({ask_wall:.4f} s, {ask_cnt['round_fused']} round_fused "
                  f"launches), sweep(grid) ({stats['misses'] - len(ask_lanes)}"
                  f" misses, {sweep_wall:.4f} s), a repeated sweep and "
                  f"engine().sweep(grid) (all hits): bitwise phase 4's fused "
                  f"sweep; the log on the card {log_bytes / 2**30:.4f} GiB "
                  f"(slabs and their concatenation)", flush=True)
            # (b) the host store
            host_svc = make("host", grid=grid)
            host_walls = appends(host_svc, env.values, slabs,
                                 f"{kind} host store")
            frontier_equal(host_svc, dev_svc, stream_lanes,
                           f"{kind} (b) host store against device store")
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            executor.reset_h2d()
            h_swept, h_wall, h_cnt = timed(lambda: host_svc.sweep(grid))
            host_peak = torch.cuda.max_memory_allocated() - before
            h2d = dict(executor.H2D)
            same_rows(h_swept.results.final_spend, h_swept.results.cap_times,
                      every, "the host store's sweep(grid)")
            stream = host_svc.values
            plan, _ = host_svc._batch_plan(grid.num_scenarios)
            walls_pf = {}
            for prefetch in (True, False):
                p_plan = dataclasses.replace(plan, chunks=dataclasses.replace(
                    plan.chunks, prefetch=prefetch))
                res, walls_pf[prefetch], _ = timed(
                    lambda: executor.execute_sweep(stream, grid.budgets,
                                                   grid.rules, p_plan))
                same_rows(res[0], res[1], every,
                          f"the host-streamed replay, prefetch {prefetch}")
            epc_h = plan.chunks.events_per_chunk
            rounds = int(base_sweeps[kind][4].max())
            print(f"[13] {kind} (b): host store sweep(grid) {h_wall:.4f} s "
                  f"(chunks of {epc_h}, {h2d['copies']} copies, "
                  f"{h2d['bytes'] / 1e9:.4f} GB to the card, "
                  f"{h2d['staged']} staged; {h_cnt['sweep_partials']} "
                  f"sweep_partials launches for {rounds} rounds), bitwise "
                  f"the device store; replay prefetch on {walls_pf[True]:.4f}"
                  f" s, off {walls_pf[False]:.4f} s; peak device memory "
                  f"above the inputs: device store {dev_peak / 2**30:.4f} "
                  f"GiB, host store {host_peak / 2**30:.4f} GiB", flush=True)
            out["folds"][kind] = dict(device=walls, host=host_walls)
            out.setdefault("replay", {})[kind] = dict(
                host=h_wall, prefetch_on=walls_pf[True],
                prefetch_off=walls_pf[False], device=sweep_wall,
                dev_peak=dev_peak, host_peak=host_peak, h2d=h2d,
                rounds=rounds)
            # one streamed pass of the day, S=32, every lane's window the
            # whole log, and its copies alone
            if kind == "first_price":
                mult, res_ = grid.rules.multipliers, grid.rules.reserve
                act = torch.ones_like(mult, dtype=torch.bool)
                lo = torch.zeros(grid.num_scenarios, dtype=torch.int32,
                                 device=dev)
                hi = torch.full_like(lo, n)
                alive = torch.ones_like(lo, dtype=torch.bool)

                def one_pass(compute):
                    pipe = executor._HostPipeline(stream, epc_h, 0, dev,
                                                  True)
                    for off, rows in pipe.rows():
                        if compute:
                            ops.sweep_partials(
                                rows, mult, act, res_, lo, hi, alive, off,
                                n_events_global=n, reduce_blocks=32)

                pass_s = {}
                for compute in (True, False):
                    times = []
                    for _ in range(4):
                        executor.reset_h2d()
                        reset_counts()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        one_pass(compute)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        if compute:
                            pass_launches = read_counts()["sweep_partials"]
                    pass_s[compute] = statistics.median(times[1:])
                require(pass_launches == -(-n // epc_h),
                        f"a streamed pass made {pass_launches} sweep_partials"
                        f" launches for {-(-n // epc_h)} chunks")
                pass_bytes = executor.H2D["bytes"]
                part_bound = bound_ms(*resolve_cost(
                    n, c, grid.num_scenarios, grid.num_scenarios * n, False,
                    grid.num_scenarios * 32 * c * 4))
                pcie_bound = bound_ms(pass_bytes, 0,
                                      bytes_per_s=PCIE_BYTES_PER_S)
                out["pass"] = dict(ms=pass_s[True] * 1e3,
                                   copy_ms=pass_s[False] * 1e3,
                                   bytes=pass_bytes,
                                   bound_ms=max(part_bound[0], pcie_bound[0]),
                                   partials_bound_ms=part_bound[0],
                                   pcie_bound_ms=pcie_bound[0],
                                   launches=pass_launches)
                print(f"[13] one host-streamed pass (S=32, N={n}, chunks "
                      f"of {epc_h}): {pass_s[True] * 1e3:.4f} ms, its "
                      f"copies alone {pass_s[False] * 1e3:.4f} ms, "
                      f"{pass_bytes / 1e9:.4f} GB to the card "
                      f"({pass_bytes / pass_s[False] / 1e9:.2f} GB/s), "
                      f"{pass_launches} sweep_partials launches; "
                      f"bound {out['pass']['bound_ms']:.4f} ms (PCIe "
                      f"{pcie_bound[0]:.4f}, partials over HBM "
                      f"{part_bound[0]:.4f})", flush=True)
            del host_svc, stream
            # (c) streaming
            lanes = list(stream_lanes.values())
            one = make("device", grid=grid)
            timed(lambda: one.append(env.values))
            for label, lane in stream_lanes.items():
                a = one.streaming(label)
                same_rows(a.final_spend, a.cap_times, lane,
                          f"the one-append frontier of {label!r}")
            del one
            s_grid = ScenarioGrid.product(
                AuctionRule(multipliers=torch.ones(small.values.shape[1],
                                                   device=dev),
                            reserve=torch.zeros((), device=dev), kind=kind),
                small.budgets, **GRID_AXES)
            s_cpu = types.SimpleNamespace(values=small.values.cpu(),
                                          budgets=small.budgets.cpu())
            cpu_grid = ScenarioGrid(
                rules=AuctionRule(multipliers=s_grid.rules.multipliers.cpu(),
                                  reserve=s_grid.rules.reserve.cpu(),
                                  kind=kind),
                budgets=s_grid.budgets.cpu(), labels=s_grid.labels)
            small_svcs = {}
            for store, e, g in (("device", small, s_grid),
                                ("host", small, s_grid),
                                ("cpu", s_cpu, cpu_grid)):
                svc = make("device" if store == "cpu" else store, e=e,
                           grid=g, size_epc=small_epc)
                start = 0
                for size in small_slabs:
                    svc.append(e.values[start:start + size])
                    start += size
                small_svcs[store] = svc
            frontier_equal(small_svcs["device"], small_svcs["cpu"],
                           stream_lanes, f"{kind} (c) small, card vs CPU")
            frontier_equal(small_svcs["host"], small_svcs["cpu"],
                           stream_lanes, f"{kind} (c) small, host vs CPU")
            del small_svcs
            mid_cpu = ""
            if kind == "first_price":
                # the mid-block fold at full width against the CPU's fold
                budgets = grid.budgets[lanes]
                rules = AuctionRule(multipliers=grid.rules.multipliers[lanes],
                                    reserve=grid.rules.reserve[lanes],
                                    kind=kind)
                plan = executor.SweepPlan()
                _, carry = executor.execute_sweep_resumable(
                    env.values[:slabs[0]], budgets, rules, plan)
                stop = slabs[0] + slabs[1]
                got, got_carry = executor.execute_sweep_resumable(
                    env.values[slabs[0]:stop], budgets, rules, plan,
                    carry=carry)
                t0 = time.perf_counter()
                want, want_carry = executor.execute_sweep_resumable(
                    env.values[slabs[0]:stop].cpu(), budgets.cpu(),
                    AuctionRule(multipliers=rules.multipliers.cpu(),
                                reserve=rules.reserve.cpu(), kind=kind),
                    executor.SweepPlan(resolve="torch"),
                    carry=carry.to("cpu"))
                cpu_s = time.perf_counter() - t0
                for name, a, b in zip(OUTPUTS, got, want):
                    require(torch.equal(a.cpu(), b),
                            f"{kind}: the mid-block fold's {name} differs "
                            f"from the CPU's")
                require(torch.equal(got_carry.cap_times.cpu(),
                                    want_carry.cap_times),
                        f"{kind}: the mid-block fold's carry differs")
                mid_cpu = (f"; the mid-block fold ([{slabs[0]}, {stop}) of "
                           f"{stop}, {int(got[4].max())} rounds) bitwise "
                           f"the CPU's fold ({cpu_s:.1f} s on the CPU)")
            print(f"[13] {kind} (c): the one-append frontier bitwise phase "
                  f"4's sweep ({len(lanes)} lanes); the three-fold frontier "
                  f"at N={small.values.shape[0]} (slabs {small_slabs}) on "
                  f"the card, device and host stores, bitwise the CPU "
                  f"service{mid_cpu}", flush=True)
            # (d) checkpoints: save after two appends, load, append
            shutil.rmtree(ckpt_root, ignore_errors=True)
            part = make("device", grid=grid)
            start = 0
            for size in slabs[:-1]:
                part.append(env.values[start:start + size])
                start += size
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            part.save(ckpt_root)
            save_s = time.perf_counter() - t0
            del part
            t0 = time.perf_counter()
            restored = CounterfactualService.load(ckpt_root, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            ckpt_bytes = sum(f.stat().st_size for f in ckpt_root.rglob("*")
                             if f.is_file())
            timed(lambda: restored.append(env.values[start:]))
            frontier_equal(restored, dev_svc, stream_lanes,
                           f"{kind} (d) save, load, append")
            lane = ask_lanes[-1]
            a = restored.ask(*grid.scenario(lane)).result()
            same_rows(a.final_spend, a.cap_times, lane,
                      "the restored service's ask")
            shutil.rmtree(ckpt_root, ignore_errors=True)
            out.setdefault("ckpt", {})[kind] = (save_s, load_s, ckpt_bytes)
            print(f"[13] {kind} (d): saved after {start} events in "
                  f"{save_s:.4f} s ({ckpt_bytes / 1e6:.1f} MB), loaded in "
                  f"{load_s:.4f} s, the last slab appended: streaming and "
                  f"an ask bitwise the uninterrupted service", flush=True)
            del restored, dev_svc
    finally:
        svc_mod.execute_sweep_resumable = fold
    # sweep_partials at the mid-block fold's shape: rows [200,000, 500,000)
    # of a 500,000-event log (block 15,625), 32 lanes, every window from
    # the offset to the end; two lanes held against the CPU
    engine, grid = engines["first_price"]
    lo_row, n_glob = slabs[0], slabs[0] + slabs[1]
    s = grid.num_scenarios
    rows = env.values[lo_row:n_glob]
    mult, res_ = grid.rules.multipliers, grid.rules.reserve
    act = torch.ones_like(mult, dtype=torch.bool)
    lo = torch.full((s,), lo_row, dtype=torch.int32, device=dev)
    hi = torch.full((s,), n_glob, dtype=torch.int32, device=dev)
    alive = torch.ones(s, dtype=torch.bool, device=dev)
    block = -(-n_glob // 32)

    def kernel():
        return ops.sweep_partials(rows, mult, act, res_, lo, hi, alive,
                                  lo_row, n_events_global=n_glob,
                                  reduce_blocks=32)

    def plain(sl=slice(None), where=dev):
        return ref.fused_partials_ref(
            rows.to(where), mult[sl].to(where), act[sl].to(where),
            res_[sl].to(where), lo[sl].to(where), hi[sl].to(where),
            block_size=block, index_offset=lo_row)

    got = kernel()
    for lane in (0, s - 1):
        want = plain(slice(lane, lane + 1), "cpu")
        require(torch.equal(got[lane:lane + 1].cpu(), want),
                f"sweep_partials at a mid-block offset, lane {lane}, "
                f"differs from its plain version on the CPU")
    out["resume"] = dict(
        ms=cuda_ms(kernel, 10), plain_ms=cuda_ms(plain, 3),
        bound=bound_ms(*resolve_cost(n_glob - lo_row, c, s,
                                     s * (n_glob - lo_row), False,
                                     s * 32 * c * 4)),
        rows=n_glob - lo_row,
        launches=out["resume_launches"])
    print(f"[13] sweep_partials at the mid-block fold's shape (rows "
          f"[{lo_row}, {n_glob}) of {n_glob}, block {block}, S={s}): "
          f"{out['resume']['ms']:.4f} ms, plain {out['resume']['plain_ms']:.4f}"
          f" ms, bound {out['resume']['bound'][0]:.4f} ms; lanes 0 and "
          f"{s - 1} bitwise the plain version on the CPU; "
          f"{out['resume_launches']} launches in the folds resumed at an "
          f"offset", flush=True)
    print(f"[13] phase 13: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def sharded_phase(dev, env, small, engines, base_sweeps, exact,
                  reset_counts, read_counts, equal, *, env_args: dict,
                  shards: int = SHARDS, chunk_events: int = CHUNK_EVENTS[0],
                  epc: int = SERVICE_EPC, ask_lanes=SERVICE_ASK_LANES,
                  cpu_lanes: int = SHARDED_CPU_LANES,
                  ckpt_root: Path = ROOT / "build" / "sharded_ckpt") -> dict:
    """Phase 14: the multi-GPU placements on the card, the §7.1 day, both
    rules. ``shards`` event shards on this one card (a mesh may name a
    device more than once: the shards are views of the day). (a)
    ``engine.sweep(grid, driver="sharded")`` (fused: two ``sweep_partials``
    launches a shard a round, no ``round_fused``), the ``sweep_resolve``
    back-end, a 2 × 2 event × scenario mesh and ``chunks=chunk_events``
    within each shard, each bitwise phase 4's sweep; (b) the multihost
    sweep as two processes on the card over ``gloo`` (each holding its
    half of the day; NCCL with one card a rank where more are visible),
    bitwise phase 4; (c) the sharded SORT2AGGREGATE sweep with the base
    warm start (``estimate_pi_sharded``, then the sharded refine) timed,
    its spend-weighted error against phase 5's exact replay and its
    consistency gaps, and at ``small``'s size the card bitwise the CPU at
    ``shards`` shards; (d) a ``CounterfactualService`` on the mesh (asks
    and ``sweep(grid)`` bitwise phase 4), saved and loaded onto 2 shards,
    and a log saved from ``shards`` shards restored onto 2 (the elastic
    restore), each answering bitwise phase 4. Then ``sweep_partials`` at a
    shard's offset, ``first_crossing`` with a carry at ``block = local_n``
    and ``segment_resolve`` at a shard offset, each against its plain
    version and timed. Returns the numbers and the launches."""
    import shutil
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  Segments, SweepPlan, execute_sweep,
                                  spend_weighted_relative_error,
                                  sweep_state_machine)
    from repro_torch.core import segments as seg_lib
    from repro_torch.kernels.auction_resolve import ops, ref
    from repro_torch.kernels.auction_resolve import segment_resolve as sg_mod
    from repro_torch.launch.mesh import SweepMeshSpec, event_sharding
    from repro_torch.serve import CounterfactualService

    t_phase = time.perf_counter()
    n, c = env.values.shape
    local_n = n // shards
    mesh = SweepMeshSpec.for_devices(devices=[dev] * shards)
    mesh22 = SweepMeshSpec.for_devices(2, 2, devices=[dev] * 4)
    mesh2 = SweepMeshSpec.for_devices(devices=[dev] * 2)
    out = {"counted": {"sweep_partials": 0, "segment_resolve": 0,
                       "first_crossing": 0, "auction_resolve": 0},
           "walls": {}}

    plain_index_add = torch.Tensor.index_add_
    index_adds = [0]

    def counting_index_add(self, *a, **k):
        index_adds[0] += 1
        return plain_index_add(self, *a, **k)

    def timed(fn):
        """``fn()`` with the kernel counts and a count of ``index_add_``
        calls set to 0 just before: ``(result, wall seconds, counts, peak
        GiB above what was allocated before)``."""
        reset_counts()
        index_adds[0] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        torch.Tensor.index_add_ = counting_index_add
        try:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.Tensor.index_add_ = plain_index_add
        cnt = dict(read_counts(), index_add_=index_adds[0])
        return (res, wall, cnt,
                (torch.cuda.max_memory_allocated() - before) / 2 ** 30)

    def same_six(got, want, what):
        for name, a, b in zip(OUTPUTS, got, want):
            require(torch.equal(a, b), f"[14] {what}: {name} differs from "
                    f"phase 4's sweep")

    # (a) Algorithm 2, event-sharded
    for kind in KINDS:
        engine, grid = engines[kind]
        want = base_sweeps[kind]
        rounds = int(want[4].max())
        sweep, wall, cnt, peak = timed(
            lambda: engine.sweep(grid, driver="sharded", mesh=mesh))
        require(torch.equal(sweep.results.final_spend, want[0])
                and torch.equal(sweep.results.cap_times, want[1]),
                f"[14] {kind}: the sharded engine.sweep differs from phase "
                f"4's sweep")
        require(cnt["sweep_partials"] == 2 * shards * rounds
                and cnt["round_fused"] == 0 and cnt["segment_partials"] == 0
                and cnt["index_add_"] == 0,
                f"[14] {kind}: the sharded fused sweep made "
                f"{cnt['sweep_partials']} sweep_partials, "
                f"{cnt['round_fused']} round_fused and "
                f"{cnt['segment_partials']} segment_partials launches and "
                f"{cnt['index_add_']} index_add_ calls for {rounds} rounds "
                f"of {shards} shards")
        out["counted"]["sweep_partials"] += cnt["sweep_partials"]
        line = [f"engine.sweep {wall:.4f} s ({cnt['sweep_partials']} "
                f"sweep_partials = 2 x {shards} x {rounds} rounds, 0 "
                f"round_fused, 0 index_add_, peak {peak:.4f} GiB above the "
                f"inputs)"]
        out["walls"][f"{kind} fused"] = wall
        cells = (("sweep_resolve", mesh, None), ("fused 2x2", mesh22, None),
                 (f"fused chunks={chunk_events}", mesh, chunk_events))
        for tag, spec, chunks in cells:
            got, wall, cnt, peak = timed(lambda: sweep_state_machine(
                env.values, grid.budgets, grid.rules,
                resolve=tag.split()[0], driver="sharded", mesh=spec,
                chunks=chunks))
            same_six(got, want, f"{kind} {tag}")
            per = shards * (local_n // chunks if chunks else 1)
            if tag == "sweep_resolve":
                require(cnt["sweep_resolve"] == shards * rounds
                        and cnt["segment_partials"] == 2 * shards * rounds,
                        f"[14] {kind} sweep_resolve: {cnt}")
            elif spec is mesh22:
                half = grid.num_scenarios // 2
                g_rounds = sum(int(got[4][g * half:(g + 1) * half].max())
                               for g in range(2))
                require(cnt["sweep_partials"] == 2 * 2 * g_rounds,
                        f"[14] {kind} 2x2: {cnt['sweep_partials']} launches "
                        f"for {g_rounds} rounds of the two scenario groups")
            else:
                require(cnt["sweep_partials"] == 2 * per * rounds,
                        f"[14] {kind} chunked: {cnt['sweep_partials']} "
                        f"launches for {rounds} rounds of {per} parts")
            out["walls"][f"{kind} {tag}"] = wall
            line.append(f"{tag} {wall:.4f} s (peak {peak:.4f} GiB)")
        print(f"[14] {kind} (a): {shards} shards of {local_n} rows on one "
              f"card, all bitwise phase 4: " + "; ".join(line), flush=True)

    # (b) multihost: two processes on the card
    runs = [("gloo", 2)]
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        runs.append(("nccl", torch.cuda.device_count()))
    for backend, world in runs:
        got, took = run_multihost(backend, world, env_args, dev)
        for rank, res in enumerate(got):
            for kind in KINDS:
                outs, wall, launches, coll = res[kind]
                same_six([x.to(dev) for x in outs], base_sweeps[kind],
                         f"multihost {backend} rank {rank} {kind}")
                rounds = int(outs[4].max())
                require(coll["all_reduce"] == 2 * rounds,
                        f"[14] multihost {backend}: {coll} all-reduces for "
                        f"{rounds} rounds")
                print(f"[14] {kind} (b): multihost {backend}, rank {rank} of "
                      f"{world}, {n // world} rows: {wall:.4f} s, "
                      f"{launches['sweep_partials']} sweep_partials "
                      f"launches, {coll['all_reduce']} all-reduces of the "
                      f"(32, 32, C) partials, bitwise phase 4", flush=True)
                out["walls"][f"{kind} multihost {backend} rank {rank}"] = wall
        print(f"[14] (b) {backend}: {world} processes, {took:.1f} s with "
              f"their start-up", flush=True)

    # (c) the sharded SORT2AGGREGATE sweep
    s2a = {}
    for kind in KINDS:
        engine, grid = engines[kind]
        sweep, wall, cnt, peak = timed(lambda: engine.sweep(
            grid, method="sort2aggregate", driver="sharded", mesh=mesh))
        res = sweep.results
        s = grid.num_scenarios
        # the base design's refine and the lanes': 8 refine passes and the
        # aggregate each; Algorithm 4's steps at estimate_pi_sharded's
        # defaults, one MatrixTile resolve and one flat sum a step
        passes, vi_steps = 9 + 9, 200
        require(bool(torch.isfinite(res.final_spend).all())
                and tuple(res.final_spend.shape) == (s, c),
                f"[14] {kind}: sharded S2A spends not finite or mis-shaped")
        require(cnt["segment_resolve"] == shards * passes
                and cnt["first_crossing"] == shards * passes + vi_steps
                and cnt["auction_resolve"] == vi_steps and cnt["vi"] == 0
                and cnt["segment_partials"] == 0 and cnt["index_add_"] == 0,
                f"[14] {kind}: sharded S2A launches {cnt}")
        for name in ("segment_resolve", "first_crossing", "auction_resolve"):
            out["counted"][name] += cnt[name]
        # the crossings at block = local_n: the calls not Algorithm 4's
        out["shard_carry_launches"] = out.get("shard_carry_launches", 0) + \
            cnt["first_crossing"] - cnt["auction_resolve"]
        oracle = exact[kind]
        s_hat, s_ref = res.final_spend.cpu(), oracle["spend"].cpu()
        swe = torch.stack([spend_weighted_relative_error(s_hat[k], s_ref[k])
                           for k in range(s)])
        gaps = sweep.consistency_gaps.cpu()
        converged = gaps == 0
        out["walls"][f"{kind} s2a"] = wall
        s2a[kind] = dict(wall=wall, swe_max=float(swe.max()),
                         swe_mean=float(swe.mean()),
                         gap_max=float(gaps.max()),
                         converged=int(converged.sum()))
        if kind == KINDS[0]:
            out["s2a_caps"] = (grid, res.cap_times.clone())
        print(f"[14] {kind} (c): sharded SORT2AGGREGATE S={s}, {shards} "
              f"shards: {wall:.4f} s (launches: {cnt['auction_resolve']} "
              f"auction_resolve (Algorithm 4's steps), "
              f"{cnt['segment_resolve']} segment_resolve, "
              f"{cnt['first_crossing']} first_crossing, 0 vi, 0 "
              f"segment_partials, 0 index_add_; peak {peak:.4f} GiB); "
              f"against phase 5's "
              f"exact replay: spend-weighted error max "
              f"{float(swe.max()):.6f}, mean {float(swe.mean()):.6f}; "
              f"consistency gap max {float(gaps.max()):.0f}, "
              f"{int(converged.sum())} of {s} lanes at 0", flush=True)
    out["s2a"] = s2a
    # the same sweep at small's size: the card bitwise the CPU
    cpu_mesh = SweepMeshSpec.for_devices(devices=["cpu"] * shards)
    for kind in KINDS:
        base = AuctionRule(multipliers=torch.ones(small.n_campaigns,
                                                  device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        card = CounterfactualEngine(small.values, small.budgets,
                                    base_rule=base, device=dev)
        grid = card.grid(**SMALL_AXES)
        lanes = slice(0, cpu_lanes)
        grid_s = dataclasses.replace(
            grid, rules=AuctionRule(multipliers=grid.rules.multipliers[lanes],
                                    reserve=grid.rules.reserve[lanes],
                                    kind=kind),
            budgets=grid.budgets[lanes], labels=grid.labels[lanes])
        got = card.sweep(grid_s, method="sort2aggregate", driver="sharded",
                         mesh=mesh)
        t0 = time.perf_counter()
        cpu = CounterfactualEngine(
            small.values.cpu(), small.budgets.cpu(),
            base_rule=AuctionRule(multipliers=base.multipliers.cpu(),
                                  reserve=base.reserve.cpu(), kind=kind),
            device="cpu")
        cpu_grid = dataclasses.replace(
            grid_s, rules=AuctionRule(
                multipliers=grid_s.rules.multipliers.cpu(),
                reserve=grid_s.rules.reserve.cpu(), kind=kind),
            budgets=grid_s.budgets.cpu())
        want = cpu.sweep(cpu_grid, method="sort2aggregate", driver="sharded",
                         mesh=cpu_mesh)
        cpu_wall = time.perf_counter() - t0
        for name, a, b in (("final_spend", got.results.final_spend,
                            want.results.final_spend),
                           ("cap_times", got.results.cap_times,
                            want.results.cap_times),
                           ("consistency_gaps", got.consistency_gaps,
                            want.consistency_gaps),
                           ("refine_iters", got.refine_iters,
                            want.refine_iters)):
            equal(name, a.cpu(), b, f"[14] {kind} sharded S2A at "
                  f"N={small.n_events} against the CPU")
        print(f"[14] {kind} (c): N={small.n_events} C={small.n_campaigns} "
              f"S={cpu_lanes}, {shards} shards: the card bitwise the CPU "
              f"(spends, cap times, gaps, iterations; {cpu_wall:.1f} s on "
              f"the CPU)", flush=True)

    # (d) the service on the mesh, and the elastic restore
    for kind in KINDS:
        engine, grid = engines[kind]
        want = base_sweeps[kind]
        svc = CounterfactualService(env.budgets, grid.scenario(0)[0],
                                    events_per_chunk=epc,
                                    placement="sharded", mesh=mesh,
                                    device=dev)
        svc.append(env.values)
        tickets = [svc.ask(*grid.scenario(s)) for s in ask_lanes]
        _, ask_wall, cnt, _ = timed(svc.flush)
        for s, t in zip(ask_lanes, tickets):
            ans = t.result()
            require(torch.equal(ans.final_spend, want[0][s])
                    and torch.equal(ans.cap_times, want[1][s]),
                    f"[14] {kind}: the sharded service's ask {s} differs "
                    f"from phase 4")
        swept, sweep_wall, _, _ = timed(lambda: svc.sweep(grid))
        require(torch.equal(swept.results.final_spend, want[0])
                and torch.equal(swept.results.cap_times, want[1]),
                f"[14] {kind}: the sharded service's sweep differs")
        line = (f"[14] {kind} (d): service on {shards} shards: "
                f"{len(ask_lanes)} asks {ask_wall:.4f} s "
                f"({cnt['sweep_partials']} sweep_partials), sweep(grid) "
                f"{sweep_wall:.4f} s, bitwise phase 4")
        if kind == KINDS[0]:
            shutil.rmtree(ckpt_root, ignore_errors=True)
            t0 = time.perf_counter()
            svc.save(ckpt_root / "service")
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = CounterfactualService.load(
                ckpt_root / "service", placement="sharded", mesh=mesh2,
                device=dev)
            load_s = time.perf_counter() - t0
            again = loaded.sweep(grid)
            require(torch.equal(again.results.final_spend, want[0])
                    and torch.equal(again.results.cap_times, want[1]),
                    f"[14] {kind}: the service loaded onto 2 shards differs")
            log = event_sharding(mesh).place(env.values)
            save_checkpoint(ckpt_root / "log", 0, {"values": log})
            t0 = time.perf_counter()
            tree, _ = restore_checkpoint(
                ckpt_root / "log", {"values": 0},
                shardings={"values": event_sharding(mesh2)})
            elastic_s = time.perf_counter() - t0
            restored = tree["values"]
            require(len(restored.shards) == 2
                    and torch.equal(restored.shards[1], env.values[n // 2:]),
                    "[14] the elastic restore's shards")
            got = execute_sweep(restored, grid.budgets, grid.rules,
                                SweepPlan(placement="sharded", mesh=mesh2))
            same_six(got, want, f"{kind} elastic restore onto 2 shards")
            shutil.rmtree(ckpt_root, ignore_errors=True)
            line += (f"; saved {save_s:.4f} s, loaded onto 2 shards "
                     f"{load_s:.4f} s, its sweep bitwise; a log saved from "
                     f"{shards} shards restored onto 2 in {elastic_s:.4f} s, "
                     f"its sharded sweep bitwise phase 4")
            del loaded, again, log, tree, restored, got
        print(line, flush=True)
        del svc

    # the kernel modes at a shard: rows [local_n, 2 local_n), S=32
    grid, caps = out.pop("s2a_caps")
    s = grid.num_scenarios
    mult, res_ = grid.rules.multipliers, grid.rules.reserve
    segs = Segments.from_cap_times(caps, n)
    seg_args = (mult, res_, segs.boundaries, segs.masks)
    k_seg = segs.masks.shape[1] - 1
    off = local_n
    rows = env.values[off:off + local_n]
    w0, p0 = sg_mod.segment_resolve_cuda(env.values[:local_n], *seg_args,
                                         second_price=False)
    reset_counts()
    w1, p1 = sg_mod.segment_resolve_cuda(rows, *seg_args, second_price=False,
                                         offset=off)
    torch.cuda.synchronize()
    require(read_counts()["segment_resolve"] == 1,
            "[14] segment_resolve at a shard offset: one launch")
    plain = ref.segment_resolve_plain(rows, *seg_args, offset=off)
    equal("winners", w1, plain[0], "[14] segment_resolve at a shard offset")
    equal("prices", p1, plain[1], "[14] segment_resolve at a shard offset")
    del plain
    sg_bytes, sg_ops, sg_floor = segment_cost(local_n, c, s, k_seg)
    out["segment_resolve_shard"] = dict(
        ms=cuda_ms(lambda: sg_mod.segment_resolve_cuda(
            rows, *seg_args, second_price=False, offset=off), 10),
        plain_ms=cuda_ms(lambda: ref.segment_resolve_plain(
            rows, *seg_args, offset=off), 1),
        bound=bound_ms(sg_bytes, sg_ops), issue_floor_ms=sg_floor,
        rows=local_n, offset=off,
        launches=out["counted"]["segment_resolve"])
    # first_crossing with a carry at block = local_n: shard 1 from shard 0
    b = grid.budgets.to(torch.float32)
    zero = (torch.zeros((s, c), device=dev),
            torch.full((s, c), n + 1, dtype=torch.int32, device=dev))
    s0, cap0 = seg_lib.shard_crossing(w0, p0, b, c, s0=zero[0], cap=zero[1],
                                      offset=0, n_global=n)
    reset_counts()
    spend1, cap1 = seg_lib.shard_crossing(w1, p1, b, c, s0=s0, cap=cap0,
                                          offset=off, n_global=n)
    torch.cuda.synchronize()
    require(read_counts()["first_crossing"] == 1
            and read_counts()["first_crossing_device_kernels"] == 4,
            "[14] first_crossing at block = local_n: one call, 4 device "
            "kernels")
    plain_s0, plain_cap = seg_lib._crossing_scan(w1, p1, b, c, local_n, s0,
                                                 cap0, off, n + 1)
    equal("cap times", cap1, plain_cap,
          "[14] first_crossing with a carry at block = local_n")
    # the caps-only call (segments.crossing_carry): the same cap times, and
    # the running spend after the shard
    reset_counts()
    s0_only, caps_only = seg_lib.crossing_carry(
        w1, p1, b, c, local_n, s0=s0, cap=cap0, offset=off, n_global=n)
    torch.cuda.synchronize()
    require(read_counts()["first_crossing_device_kernels"] == 3,
            "[14] first_crossing at block = local_n, caps only: 3 device "
            "kernels")
    equal("cap times", caps_only, plain_cap,
          "[14] first_crossing at block = local_n, caps only")
    equal("running spend", s0_only, plain_s0,
          "[14] first_crossing at block = local_n, caps only")
    del plain_cap, plain_s0
    lane = 0
    cpu_spend, cpu_cap = seg_lib.shard_crossing(
        w1[lane:lane + 1].cpu(), p1[lane:lane + 1].cpu(),
        b[lane:lane + 1].cpu(), c, s0=s0[lane:lane + 1].cpu(),
        cap=cap0[lane:lane + 1].cpu(), offset=off, n_global=n)
    equal("cap times", cap1[lane:lane + 1].cpu(), cpu_cap,
          "[14] first_crossing at block = local_n, lane 0 against the CPU")
    equal("flat sums", spend1[lane:lane + 1].cpu(), cpu_spend,
          "[14] first_crossing at block = local_n, lane 0 against the CPU")
    floor = chain_floor_ms(w1, c)
    out["first_crossing_shard"] = dict(
        split=fc_split("[14]", "at block = local_n with a carry, spends "
                               "and caps",
                       lambda: seg_lib.shard_crossing(
                           w1, p1, b, c, s0=s0, cap=cap0, offset=off,
                           n_global=n)),
        chain_floor_ms=floor[0], longest_run=floor[1],
        caps_only_ms=cuda_ms(lambda: seg_lib.crossing_carry(
            w1, p1, b, c, local_n, s0=s0, cap=cap0, offset=off,
            n_global=n), 5),
        ms=cuda_ms(lambda: seg_lib.shard_crossing(
            w1, p1, b, c, s0=s0, cap=cap0, offset=off, n_global=n), 5),
        plain_ms=cuda_ms(lambda: seg_lib._crossing_scan(
            w1, p1, b, c, local_n, s0, cap0, off, n + 1), 1),
        bound=bound_ms(s * local_n * 8 + s * c * 4 * 6,
                       crossing_ops(w1, local_n, c, local_n)),
        rows=local_n, lanes=s, launches=out["shard_carry_launches"])
    del w0, p0, w1, p1
    # sweep_partials at a shard's offset, a fresh round's windows
    act = torch.ones_like(mult, dtype=torch.bool)
    lo = torch.zeros(s, dtype=torch.int32, device=dev)
    hi = torch.full((s,), n, dtype=torch.int32, device=dev)
    alive = torch.ones(s, dtype=torch.bool, device=dev)
    block = -(-n // 32)

    def kernel():
        return ops.sweep_partials(rows, mult, act, res_, lo, hi, alive, off,
                                  n_events_global=n, reduce_blocks=32)

    def plain_partials(sl=slice(None), where=dev):
        return ref.fused_partials_ref(
            rows.to(where), mult[sl].to(where), act[sl].to(where),
            res_[sl].to(where), lo[sl].to(where), hi[sl].to(where),
            block_size=block, index_offset=off)

    got = kernel()
    for ln in (0, s - 1):
        require(torch.equal(got[ln:ln + 1].cpu(),
                            plain_partials(slice(ln, ln + 1), "cpu")),
                f"[14] sweep_partials at a shard's offset, lane {ln}, "
                f"differs from its plain version on the CPU")
    out["sweep_partials_shard"] = dict(
        ms=cuda_ms(kernel, 10), plain_ms=cuda_ms(plain_partials, 3),
        bound=bound_ms(*resolve_cost(local_n, c, s, s * local_n, False,
                                     s * 32 * c * 4)),
        rows=local_n, offset=off,
        launches=out["counted"]["sweep_partials"])
    for name, key in (("sweep_partials", "sweep_partials_shard"),
                      ("first_crossing", "first_crossing_shard"),
                      ("segment_resolve", "segment_resolve_shard")):
        m = out[key]
        print(f"[14] {name} at a shard ({m['rows']} rows, S={s}): "
              f"{m['ms']:.4f} ms"
              + (f", caps only {m['caps_only_ms']:.4f} ms"
                 if "caps_only_ms" in m else "")
              + f", plain {m['plain_ms']:.4f} ms, bound "
              f"{m['bound'][0]:.4f} ms ({m['bound'][1]})"
              + (f", the flat sums' chain floor {m['chain_floor_ms']:.4f} ms "
                 f"({m['longest_run']} sales of one (lane, campaign))"
                 if "chain_floor_ms" in m else "")
              + f", {m['launches']} launches on the sharded paths",
              flush=True)
    out["wall"] = time.perf_counter() - t_phase
    print(f"[14] phase 14: {out['wall']:.1f} s", flush=True)
    return out


def tune_phase(dev, env, engines, base_sweeps, walls, reset_counts,
               read_counts, *, seed: int, full, yahoo_full, yahoo_cpu,
               key_block: int = KEYED_BLOCK, tune_events: int = TUNE_EVENTS,
               epc: int = SERVICE_EPC, ask_lanes=SERVICE_ASK_LANES,
               cache_path: Path = ROOT / "build" / "tune_cache.json") -> dict:
    """Phase 15: plan tuning and the keyed days on the card. (a) The keyed
    §7.1 day (``full``) built on the card from ``prng.PRNGKey(seed)``, its
    first, last full and last ``key_block``-row blocks bitwise the CPU's
    keyed build of the same blocks (values, event and campaign
    embeddings). (b) ``engine.tune(grid)`` at S=32 for ``resolve="auto"``
    (fused) and ``"sweep_resolve"``, both pricing rules, on
    ``tune_events`` events of the day (the cache at ``cache_path``, also
    the default file of the phase): every measured candidate's config,
    predicted and paired times, the winner and its speedup; then
    ``engine.sweep(grid, tuned=True)`` and ``block_t="auto"`` bitwise phase
    4, the tuned plan's six outputs bitwise phase 4 with the launches of
    the concrete plan it resolves to (resolution launches nothing); a
    ``CounterfactualService(tuned=True)`` answering ``ask_lanes`` bitwise
    phase 4 (as phase 13's asks are), its ``tune()`` pinning a concrete
    plan, a host store's ``tune()`` raising ``repro``'s text; the cost
    model's full-day seconds beside phase 4's walls; the host time of one
    kernel launch (``dispatch_us``). (c) The Yahoo-like day pair at
    ``yahoo_full`` built on the card from a key, bitwise the CPU's build;
    both exact replays (one ``capped_scan`` launch each), the fig. 5-6
    warm start and ``sort2aggregate(..., refine_iters=12)`` (only
    ``segment_resolve`` and ``first_crossing`` launches, no ``vi``, no
    ``index_add_``), the walls, the heuristics' and S2A's spend-weighted
    errors against the day-2 replay and the capped count; the whole
    pipeline at ``yahoo_cpu`` bitwise the CPU's. Returns the numbers and
    the launches."""
    import os
    import torch
    from repro_torch import prng, tune
    from repro_torch.core import (SweepPlan, execute_sweep,
                                  sequential_replay, sort2aggregate,
                                  spend_weighted_relative_error)
    from repro_torch.core.executor import needs_tuning
    from repro_torch.core.segments import REDUCE_BLOCKS
    from repro_torch.data import make_synthetic_env, make_yahoo_like_env
    from repro_torch.data.synthetic import keyed_block
    from repro_torch.data.yahoo import as_is_prediction, rescaled_prediction
    from repro_torch.kernels.auction_resolve import ops
    from repro_torch.serve import CounterfactualService

    t_phase = time.perf_counter()
    n, c = env.values.shape
    quick, trials = TUNE_TRIALS
    tune_kw = dict(max_events=tune_events, quick_trials=quick,
                   trials=trials)
    out = {"counted": {"round_fused": 0, "sweep_partials": 0,
                       "sweep_resolve": 0, "segment_partials": 0,
                       "capped_scan": 0, "segment_resolve": 0,
                       "first_crossing": 0}, "tune": []}

    plain_index_add = torch.Tensor.index_add_
    index_adds = [0]

    def counting_index_add(self, *a, **k):
        index_adds[0] += 1
        return plain_index_add(self, *a, **k)

    def timed(fn):
        """``fn()`` with the kernel counts and a count of ``index_add_``
        calls set to 0 just before: ``(result, wall seconds, counts)``."""
        reset_counts()
        index_adds[0] = 0
        torch.cuda.synchronize()
        torch.Tensor.index_add_ = counting_index_add
        try:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.Tensor.index_add_ = plain_index_add
        return res, wall, dict(read_counts(), index_add_=index_adds[0])

    def add(counts):
        for name in out["counted"]:
            out["counted"][name] += counts.get(name, 0)

    # (a) the keyed §7.1 day
    key = prng.PRNGKey(seed)
    keyed, wall, _ = timed(lambda: make_synthetic_env(
        key, full.n_events, full.n_campaigns, full.emb_dim,
        b_base=full.b_base, block=key_block, device=dev))
    out["keyed_wall"] = wall
    last = (full.n_events - 1) // key_block * key_block
    blocks = sorted({(0, key_block), (last - key_block, last),
                     (last, full.n_events)})
    t0 = time.perf_counter()
    for lo, hi in blocks:
        emb, vals, cemb = keyed_block(key, lo, hi, full.n_campaigns,
                                      full.emb_dim, device="cpu")
        for name, got, want in (("values", keyed.values[lo:hi], vals),
                                ("event_emb", keyed.event_emb[lo:hi], emb),
                                ("campaign_emb", keyed.campaign_emb, cemb)):
            require(torch.equal(got.cpu(), want),
                    f"keyed day rows [{lo}, {hi}): {name} differs from "
                    f"the CPU's keyed build")
    print(f"[15] (a) keyed §7.1 day (N={full.n_events} C={full.n_campaigns}"
          f" d={full.emb_dim}) built on the card in {wall:.4f} s; blocks "
          f"{blocks} bitwise the CPU's keyed build (values, embeddings; "
          f"{time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
    del keyed

    # (b) tuning at S=32
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    cache_path.unlink(missing_ok=True)
    saved_env = os.environ.get(tune.ENV_VAR)
    os.environ[tune.ENV_VAR] = str(cache_path)
    try:
        for kind in KINDS:
            engine, grid = engines[kind]
            s = grid.num_scenarios
            want = base_sweeps[kind]
            for resolve in ("auto", "sweep_resolve"):
                t0 = time.perf_counter()
                report = engine.tune(grid, resolve=resolve,
                                     cache_path=cache_path, **tune_kw)
                tune_wall = time.perf_counter() - t0
                for m in report.measurements:
                    print(f"[15] (b) {kind} {resolve}: candidate "
                          f"{m.config}: predicted {m.predicted_total:.6f} s"
                          f" (full day), paired {m.us:.1f} µs against the "
                          f"default's {m.us_default:.1f} µs"
                          f"{' (pruned)' if m.pruned else ''}", flush=True)
                plan = SweepPlan(resolve=resolve, block_t="auto", tuned=True)
                shape = tune.shape_for(plan, n_events=n, n_campaigns=c,
                                       n_scenarios=s, device=dev)
                ranked = tune.rank_candidates(plan, shape)
                default = tune.default_candidate(plan)
                predicted = dict(ranked)[default].total
                concrete = tune.resolve_plan(plan, n_events=n, n_campaigns=c,
                                             n_scenarios=s, device=dev)
                require(concrete == report.plan(plan),
                        f"{kind} {resolve}: the tuned plan did not resolve "
                        f"to the measured winner")
                got, t_wall, t_cnt = timed(lambda: execute_sweep(
                    env.values, grid.budgets, grid.rules, plan))
                ref, c_wall, c_cnt = timed(lambda: execute_sweep(
                    env.values, grid.budgets, grid.rules, concrete))
                require(t_cnt == c_cnt,
                        f"{kind} {resolve}: resolving the tuned plan "
                        f"launched more than its sweep ({t_cnt} against "
                        f"{c_cnt})")
                add(t_cnt)
                for name, a, b in zip(OUTPUTS, got, want):
                    require(torch.equal(a, b), f"{kind} {resolve}: the "
                            f"tuned plan's {name} differs from phase 4's")
                for kw in (dict(tuned=True), dict(block_t="auto")):
                    res = engine.sweep(grid, resolve=resolve, **kw)
                    require(torch.equal(res.results.final_spend, want[0])
                            and torch.equal(res.results.cap_times, want[1]),
                            f"{kind} {resolve}: engine.sweep({kw}) differs "
                            f"from phase 4")
                row = dict(kind=kind, resolve=resolve,
                           winner=report.winner_config,
                           speedup=report.speedup, origin=report.origin,
                           n_candidates=report.n_candidates,
                           measured_events=report.measured_events,
                           tune_wall=tune_wall, tuned_wall=t_wall,
                           predicted_full_day_s=predicted,
                           phase4_wall=walls[(kind, resolve)],
                           measurements=[dataclasses.asdict(m) for m in
                                         report.measurements])
                out["tune"].append(row)
                print(f"[15] (b) {kind} {resolve}: {report.n_candidates} "
                      f"candidates, {len(report.measurements)} measured on "
                      f"{report.measured_events} events in {tune_wall:.2f}"
                      f" s; winner {report.winner_config} (speedup "
                      f"{report.speedup}); sweep(tuned=True) and block_t="
                      f"'auto' bitwise phase 4, the tuned plan's launches "
                      f"{ {k: v for k, v in t_cnt.items() if v} } those of "
                      f"its concrete plan ({t_wall:.4f} s); the cost model's"
                      f" full-day default {predicted:.6f} s against phase "
                      f"4's {walls[(kind, resolve)]:.4f} s", flush=True)
        # the service: tuned=True answers phase 13's asks, tune() pins
        engine, grid = engines[KINDS[0]]
        want = base_sweeps[KINDS[0]]
        svc = CounterfactualService(env.budgets, engine.base_rule,
                                    events_per_chunk=epc, tuned=True,
                                    device=dev)
        svc.append(env.values)

        def asks(what):
            tickets = [svc.ask(*grid.scenario(s)) for s in ask_lanes]
            svc.flush()
            for s, t in zip(ask_lanes, tickets):
                a = t.result()
                require(torch.equal(a.final_spend, want[0][s])
                        and torch.equal(a.cap_times, want[1][s]),
                        f"tuned service ({what}): the ask of lane {s} "
                        f"differs from phase 4 (and phase 13)")

        asks("cache or cost model")
        t0 = time.perf_counter()
        svc.tune(scenarios=grid.num_scenarios, cache_path=cache_path,
                 **tune_kw)
        svc_tune_wall = time.perf_counter() - t0
        require(not needs_tuning(svc.plan), "service.tune() pinned no plan")
        svc._cache.clear()           # the asks replay under the pinned plan
        asks("pinned")
        host = CounterfactualService(env.budgets, engine.base_rule,
                                     events_per_chunk=epc, store="host",
                                     device=dev)
        host.append(env.values[:epc])
        raised = ""
        try:
            host.tune()
        except ValueError as err:
            raised = str(err)
        require("store='host' replans" in raised,
                f"a host store's tune() did not raise repro's text: "
                f"{raised!r}")
        print(f"[15] (b) CounterfactualService(tuned=True): {len(ask_lanes)}"
              f" asks bitwise phase 4 (phase 13's answers) before and after "
              f"tune() ({svc_tune_wall:.2f} s) pinned {svc.plan}; a host "
              f"store's tune() raises repro's text", flush=True)
        del svc, host
    finally:
        if saved_env is None:
            os.environ.pop(tune.ENV_VAR, None)
        else:
            os.environ[tune.ENV_VAR] = saved_env
    # the host time of one kernel launch, the roofline's dispatch_us
    grid = engines[KINDS[0]][1]
    v_small = env.values[:4096]
    lane = slice(0, 1)
    act = torch.ones((1, c), dtype=torch.bool, device=dev)
    lo = torch.zeros(1, dtype=torch.int32, device=dev)
    hi = torch.full((1,), 4096, dtype=torch.int32, device=dev)
    keep = torch.ones(1, dtype=torch.bool, device=dev)

    def launch():
        ops.sweep_partials(v_small, grid.rules.multipliers[lane], act,
                           grid.rules.reserve[lane], lo, hi, keep, 0,
                           n_events_global=4096,
                           reduce_blocks=REDUCE_BLOCKS)

    for _ in range(20):
        launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCH_CALLS):
        launch()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["dispatch_us"] = host_s / DISPATCH_CALLS * 1e6
    print(f"[15] (b) dispatch: {out['dispatch_us']:.2f} µs of host time a "
          f"sweep_partials launch ({DISPATCH_CALLS} launches, N=4096, "
          f"C={c}, one lane)", flush=True)

    # (c) the Yahoo-like day pair
    def yahoo(preset, where):
        return make_yahoo_like_env(
            prng.PRNGKey(seed), n_keywords=preset.n_keywords,
            n_campaigns=preset.n_campaigns, n_day1=preset.n_day1,
            n_day2=preset.n_day2, budget=preset.budget, device=where)

    def pipeline(y, preset):
        """fig. 5-6: both replays, the warm start, S2A and the errors,
        each step timed with its launches."""
        n1, n2 = preset.n_day1, preset.n_day2
        v1, v2 = y.values(1), y.values(2)
        d1, w1, k1 = timed(lambda: sequential_replay(v1, y.budgets, y.rule))
        d2, w2, k2 = timed(lambda: sequential_replay(v2, y.budgets, y.rule))
        caps1 = d1.cap_times.long()
        warm = torch.where(caps1 <= n1, torch.clamp(caps1 * n2 // n1,
                                                    max=n2),
                           n2 + 1).to(torch.int32)
        s2a, w3, k3 = timed(lambda: sort2aggregate(
            v2, y.budgets, y.rule, cap_times_init=warm, refine_iters=12))
        errs = {
            "as_is": spend_weighted_relative_error(
                as_is_prediction(d1.final_spend), d2.final_spend),
            "rescale": spend_weighted_relative_error(
                rescaled_prediction(d1.final_spend, n1, n2, y.budgets),
                d2.final_spend),
            "s2a": spend_weighted_relative_error(s2a.result.final_spend,
                                                 d2.final_spend)}
        outputs = dict(day1_spend=d1.final_spend, day1_caps=d1.cap_times,
                       day2_spend=d2.final_spend, day2_caps=d2.cap_times,
                       warm=warm, s2a_spend=s2a.result.final_spend,
                       s2a_caps=s2a.result.cap_times, **errs)
        return outputs, (w1, w2, w3), (k1, k2, k3), s2a.refine_iters_used

    y_card, y_wall, _ = timed(lambda: yahoo(yahoo_full, dev))
    y_cpu = yahoo(yahoo_full, "cpu")
    for name in ("bid_table", "day1_keywords", "day2_keywords", "budgets"):
        require(torch.equal(getattr(y_card, name).cpu(),
                            getattr(y_cpu, name)),
                f"Yahoo-like day: {name} differs from the CPU's build")
    res, (w1, w2, w3), (k1, k2, k3), iters = pipeline(y_card, yahoo_full)
    for k in (k1, k2):
        require(k["capped_scan"] == 1 and sum(k.values()) == 1,
                f"an exact replay made launches {k}")
    s2a_kernels = {name for name, v in k3.items() if v}
    require(k3["segment_resolve"] > 0 and k3["first_crossing"] > 0
            and s2a_kernels <= {"segment_resolve", "first_crossing",
                                "first_crossing_device_kernels"},
            f"the warm-started SORT2AGGREGATE made launches {k3}")
    for k in (k1, k2, k3):
        add(k)
    capped = int((res["day2_caps"] <= yahoo_full.n_day2).sum())
    out["yahoo"] = dict(build_wall=y_wall, replay_walls=(w1, w2),
                        s2a_wall=w3, s2a_launches=k3, refine_iters=iters,
                        capped=capped,
                        errors={e: float(res[e]) for e in
                                ("as_is", "rescale", "s2a")})
    print(f"[15] (c) Yahoo-like day pair (K={yahoo_full.n_keywords} C="
          f"{yahoo_full.n_campaigns}, {yahoo_full.n_day1} then "
          f"{yahoo_full.n_day2} auctions) built on the card in {y_wall:.4f}"
          f" s, bitwise the CPU's; exact replays {w1:.4f} s and {w2:.4f} s"
          f" (one capped_scan launch each); warm-started SORT2AGGREGATE "
          f"(12 refine passes, {iters} used) {w3:.4f} s, launches "
          f"{ {k: v for k, v in k3.items() if v} }; spend-weighted error "
          f"against the day-2 replay: as is {float(res['as_is']):.4f}, "
          f"rescaled {float(res['rescale']):.4f}, SORT2AGGREGATE "
          f"{float(res['s2a']):.4f}; {capped} of {yahoo_full.n_campaigns} "
          f"campaigns capped on day 2", flush=True)
    del y_card, y_cpu
    t0 = time.perf_counter()
    on_card = pipeline(yahoo(yahoo_cpu, dev), yahoo_cpu)
    on_cpu = pipeline(yahoo(yahoo_cpu, "cpu"), yahoo_cpu)
    for name, want in on_cpu[0].items():
        require(torch.equal(on_card[0][name].cpu(), want),
                f"Yahoo pipeline at {yahoo_cpu}: {name} differs from the "
                f"CPU's")
    require(on_card[3] == on_cpu[3], "S2A refine iterations differ")
    print(f"[15] (c) the pipeline at {yahoo_cpu} on the card bitwise the "
          f"CPU's (replays, warm start, S2A, errors; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    out["wall"] = time.perf_counter() - t_phase
    print(f"[15] phase 15: {out['wall']:.1f} s", flush=True)
    return out


MULTIHOST_WORKER = """
import json, sys, time
import torch
rank, world, address, backend, device, src, out_path, spec = sys.argv[1:9]
rank, world, spec = int(rank), int(world), json.loads(spec)
sys.path.insert(0, src)
from repro_torch.core import (AuctionRule, ScenarioGrid, SweepPlan,
                              execute_sweep, executor)
from repro_torch.data import make_synthetic_env
from repro_torch.kernels.auction_resolve import round_fused as rf
from repro_torch.launch.mesh import SweepMeshSpec, distributed_initialize
if device == "cuda":
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
else:
    dev = torch.device(device)
used = distributed_initialize(address, world, rank, backend=backend,
                              device=dev)
mesh = SweepMeshSpec.for_processes(device=dev)
env = make_synthetic_env(spec["seed"], spec["n_events"], spec["n_campaigns"],
                         spec["emb_dim"], b_base=spec["b_base"], device=dev)
half = spec["n_events"] // world
# this rank keeps its own rows of the day only
local = env.values[rank * half:(rank + 1) * half].clone()
budgets = env.budgets
del env
out = {}
for kind in ("first_price", "second_price"):
    c = spec["n_campaigns"]
    base = AuctionRule(multipliers=torch.ones(c, device=dev),
                       reserve=torch.zeros((), device=dev), kind=kind)
    grid = ScenarioGrid.product(base, budgets, **spec["axes"])
    rf.reset_launches()
    executor.reset_collectives()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = execute_sweep(local, grid.budgets, grid.rules,
                        SweepPlan(placement="multihost", mesh=mesh))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out[kind] = ([x.cpu() for x in res], wall, dict(rf.LAUNCHES),
                 dict(executor.COLLECTIVES))
torch.save(out, out_path)
torch.distributed.destroy_process_group()
print("MULTIHOST_OK", rank, used)
"""


def run_multihost(backend: str, world: int, env_args: dict, dev):
    """Run :data:`MULTIHOST_WORKER` as ``world`` processes of one
    ``torch.distributed`` job on ``backend`` (every rank on the card, or
    on its own card for NCCL; on the CPU when ``dev`` is the CPU), each
    with its rows of the day named by ``env_args``. Returns each rank's
    outputs and the job's wall time, start-up included."""
    import socket
    import tempfile
    import torch
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    device = "cuda" if torch.device(dev).type == "cuda" else "cpu"
    spec = json.dumps(dict(env_args, axes=GRID_AXES))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        paths = [Path(tmp) / f"rank{r}.pt" for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", MULTIHOST_WORKER, str(r), str(world),
             address, backend, device, str(ROOT / "src"), str(paths[r]),
             spec], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
            require(p.returncode == 0 and f"MULTIHOST_OK {r}" in stdout,
                    f"multihost rank {r} ({backend}) failed: "
                    f"{stderr[-3000:]}")
        got = [torch.load(path) for path in paths]
    return got, time.perf_counter() - t0


def phase_wall(n: int, t0: float) -> float:
    """Print phase ``n``'s wall since ``t0``; return the time now."""
    now = time.perf_counter()
    print(f"[{n}] phase {n}: {now - t0:.1f} s", flush=True)
    return now


def main() -> int:
    t_script = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import prng
    from repro_torch.configs.paper_auction import (PAPER_SYNTHETIC_CPU,
                                                   PAPER_SYNTHETIC_FULL,
                                                   PAPER_YAHOO_CPU,
                                                   PAPER_YAHOO_FULL)
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, Segments, scenario_rule,
                                  spend_weighted_relative_error,
                                  sweep_sequential, sweep_state_machine)
    from repro_torch.core import auction, executor
    from repro_torch.core import segments as seg_lib
    from repro_torch.core import vi as vi_lib
    from repro_torch.core.segments import REDUCE_BLOCKS
    from repro_torch.data import make_synthetic_env
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import ops, ref
    from repro_torch.kernels.auction_resolve import auction_resolve as ar_mod
    from repro_torch.kernels.auction_resolve import first_crossing as fc_mod
    from repro_torch.kernels.auction_resolve import round_fused as rf_mod
    from repro_torch.kernels.auction_resolve import segment_partials as sp_mod
    from repro_torch.kernels.auction_resolve import segment_resolve as sg_mod
    from repro_torch.kernels.auction_resolve import vi as vi_mod
    from repro_torch.kernels.auction_resolve import sweep_resolve as sr_mod
    from repro_torch.kernels.capped_scan import capped_scan as cs_mod
    from repro_torch.kernels.capped_scan import ops as scan_ops
    from repro_torch.kernels.capped_scan.ref import capped_scan_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import \
        flash_attention_bwd as fab_mod
    from repro_torch.kernels import crn as crn_mod

    counters = (rf_mod, sr_mod, sp_mod, cs_mod, ar_mod, fc_mod, fa_mod,
                vi_mod, sg_mod, crn_mod, fab_mod)

    def reset_counts():
        for mod in counters:
            mod.reset_launches()

    def read_counts() -> dict:
        return {k: v for mod in counters for k, v in mod.LAUNCHES.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(f"card: {card} | max SM clock {smi('clocks.max.sm')} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t_wall = time.perf_counter()
    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all(["round_fused", "sweep_resolve",
                             "segment_partials", "capped_scan",
                             "auction_resolve", "first_crossing",
                             "flash_attention", "flash_attention_bwd", "vi",
                             "segment_resolve", "crn"])
    print(f"[1] built {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, (lib_path, log, seconds) in built.items():
        print(f"    {lib_path.name}: nvcc {seconds:.2f} s")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"      ptxas: {line.strip()}")

    t_wall = phase_wall(1, t_wall)
    # ---- phase 2: kernels vs plain versions ------------------------------
    full = PAPER_SYNTHETIC_FULL
    t0 = time.perf_counter()
    env = make_synthetic_env(args.seed, full.n_events, full.n_campaigns,
                             full.emb_dim, b_base=full.b_base, device=dev)
    small_cfg = PAPER_SYNTHETIC_CPU
    small = make_synthetic_env(args.seed, small_cfg.n_events,
                               small_cfg.n_campaigns, small_cfg.emb_dim,
                               b_base=small_cfg.b_base, device=dev)
    torch.cuda.synchronize()
    n, c = env.values.shape
    block = -(-n // REDUCE_BLOCKS)
    print(f"[2] env N={n} C={c}: values {env.values.numel() * 4 / 1e6:.0f} "
          f"MB on the card, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    gen = torch.Generator().manual_seed(args.seed + 1)
    card_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    errs = {name: 0.0 for name, _, _ in KERNELS}

    def close(name, got, want, mask=None):
        if mask is not None:
            got, want = got[mask], want[mask]
        tol = 1e-6 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        errs[name] = max(errs[name], float((got - want).abs().max()))

    def equal(name, got, want, what):
        require(got.dtype == want.dtype and torch.equal(got, want),
                f"{what}: {name} differs from its plain version")

    def base_grid(kind, budgets, axes):
        base = AuctionRule(multipliers=torch.ones(budgets.shape[0],
                                                  device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        return ScenarioGrid.product(base, budgets, **axes)

    def check_round(label, grid, active, s_hat, n_hat, alive, second):
        out = ops.round_fused(env.values, grid.rules.multipliers, active,
                              grid.rules.reserve, grid.budgets, s_hat, n_hat,
                              alive, reduce_blocks=REDUCE_BLOCKS,
                              second_price=second)
        want = ref.round_fused_ref(
            env.values, grid.rules.multipliers, active, grid.rules.reserve,
            grid.budgets, s_hat, n_hat, block_size=block,
            second_price=second)
        torch.cuda.synchronize()
        close("round_fused", out[0], want[0], alive)
        require(torch.equal(out[2][alive], want[2][alive]),
                f"{label}: c_next differs")
        require(torch.equal(out[3][alive], want[3][alive]),
                f"{label}: no_cap differs")
        off = (out[4] - want[4])[alive].abs()
        if int(off.max()) > 0:
            print(f"    {label}: n_next off by {off.tolist()}")
        require(int(off.max()) <= 1, f"{label}: n_next off by more than 1")
        # the block window is the kernel's own n_next; compare where both
        # predicted the same block
        same = alive & (out[4] == want[4])
        close("round_fused", out[1], want[1], same)
        require(not out[0][~alive].any() and not out[1][~alive].any(),
                f"{label}: skipped lanes wrote non-zero partials")
        return out

    def check_sweep_resolve(label, values, mult, active, reserves, second):
        got = ops.sweep_resolve(values, mult, active, reserves,
                                second_price=second)
        want = ref.sweep_resolve_ref(values, mult, active, reserves,
                                     second_price=second)
        torch.cuda.synchronize()
        equal("winners", got[0], want[0], f"sweep_resolve {label}")
        equal("prices", got[1], want[1], f"sweep_resolve {label}")
        close("sweep_resolve", got[2], want[2])
        return got

    timing = {}
    for kind in KINDS:
        second = kind == "second_price"
        grid = base_grid(kind, env.budgets, GRID_AXES)
        s = grid.num_scenarios
        mult, res = grid.rules.multipliers, grid.rules.reserve
        ones = torch.ones((s, c), dtype=torch.bool, device=dev)
        zeros = torch.zeros((s, c), device=dev)
        n0 = torch.zeros(s, dtype=torch.int32, device=dev)
        full_hi = torch.full_like(n0, n)
        all_alive = torch.ones(s, dtype=torch.bool, device=dev)
        fresh = check_round(f"{kind} fresh", grid, ones, zeros, n0,
                            all_alive, second)
        # mid-day: n_hat ~ N/3, a quarter of the campaigns retired with
        # part of their budgets spent, every fourth lane dead
        active = (torch.rand((s, c), generator=gen) < 0.75).to(dev)
        s_hat = grid.budgets * 0.3 * torch.rand((s, c), generator=gen).to(dev)
        n_mid = (n // 3 + (n // 256) * torch.arange(s)).to(torch.int32)
        n_mid = n_mid.to(dev)
        alive = (torch.arange(s) % 4 != 3).to(dev)
        check_round(f"{kind} mid-day", grid, active, s_hat, n_mid, alive,
                    second)
        # one partials pass over a slice of the log at a non-zero offset,
        # with a window per lane
        offset, n_local = n // 4, n // 2
        lo = (offset - n // 200 + (n // 80) * torch.arange(s))
        lo, hi = lo.to(torch.int32), (lo + 2 * n // 5).to(torch.int32)
        lo, hi = lo.to(dev), hi.to(dev)
        v_slice = env.values[offset:offset + n_local]
        got = ops.sweep_partials(v_slice, mult, active, res, lo, hi,
                                 all_alive, offset, n_events_global=n,
                                 reduce_blocks=REDUCE_BLOCKS,
                                 second_price=second)
        want = ref.fused_partials_ref(v_slice, mult, active, res, lo, hi,
                                      block_size=block, second_price=second,
                                      index_offset=offset)
        close("sweep_partials", got, want)
        # the scenario-batched resolve, fresh and mid-day masks
        resolved = check_sweep_resolve(f"{kind} fresh", env.values, mult,
                                       ones, res, second)
        mid = check_sweep_resolve(f"{kind} mid-day", env.values, mult, active,
                                  res, second)
        # event-ordered partials of the mid-day resolve, a window per lane:
        # bitwise the plain version (index_add_) on the CPU
        win_hi = torch.clamp(n_mid + (n // 7) * (1 + torch.arange(
            s, device=dev) % 5), max=n).to(torch.int32)
        got = seg_lib.window_partials(mid[0], mid[1], c, n_mid, win_hi,
                                      block_size=block)
        want = seg_lib.window_partials_ref(mid[0].cpu(), mid[1].cpu(), c,
                                           n_mid.cpu(), win_hi.cpu(),
                                           block_size=block)
        equal("partials", got.cpu(), want, f"segment_partials {kind}")
        print(f"[2] {kind}: round (fresh, mid-day), offset partials, "
              f"sweep_resolve (fresh, mid-day) and segment_partials agree "
              f"with the plain versions", flush=True)
        if kind == "first_price":
            # time the fresh-state round, one full-window pass, the fresh
            # resolve and its full-window partials
            args_rf = (env.values, mult, ones, res, grid.budgets, zeros, n0,
                       all_alive)
            timing["round_fused"] = (
                cuda_ms(lambda: ops.round_fused(
                    *args_rf, reduce_blocks=REDUCE_BLOCKS), 10),
                cuda_ms(lambda: ref.round_fused_ref(
                    *args_rf[:7], block_size=block), 3), None)
            timing["sweep_partials"] = (
                cuda_ms(lambda: ops.sweep_partials(
                    env.values, mult, ones, res, n0, full_hi, all_alive,
                    n_events_global=n, reduce_blocks=REDUCE_BLOCKS), 10),
                cuda_ms(lambda: ref.fused_partials_ref(
                    env.values, mult, ones, res, n0, full_hi,
                    block_size=block), 3), None)
            # a late-round pass: every lane's window the last half of the
            # last canonical block, the shape most of a sweep's passes have
            n_late = torch.full_like(n0, n - block // 2)
            timing["sweep_partials_late"] = cuda_ms(
                lambda: ops.sweep_partials(
                    env.values, mult, ones, res, n_late, full_hi, all_alive,
                    n_events_global=n, reduce_blocks=REDUCE_BLOCKS), 10)
            timing["sweep_partials_late_bound"] = bound_ms(
                (n - n_late[0].item()) * c * 4 + s * (c * 5 + 16) +
                s * REDUCE_BLOCKS * c * 4,
                s * (n - n_late[0].item()) * c * 2)
            timing["sweep_resolve"] = (
                cuda_ms(lambda: ops.sweep_resolve(env.values, mult, ones,
                                                  res), 10),
                cuda_ms(lambda: ref.sweep_resolve_ref(env.values, mult, ones,
                                                      res), 3), None)
            w, p = resolved[0], resolved[1]
            # the library yardstick: one index_add_ over every lane's rows
            flat_ids = ((torch.arange(s, device=dev)[:, None] * REDUCE_BLOCKS
                         + torch.arange(n, device=dev) // block)
                        * (c + 1) + torch.where(w < 0, c, w)).reshape(-1)
            flat_p = p.reshape(-1)
            timing["segment_partials"] = (
                cuda_ms(lambda: seg_lib.window_partials(
                    w, p, c, n0, full_hi, block_size=block), 10),
                cuda_ms(lambda: seg_lib.window_partials_ref(
                    w, p, c, n0, full_hi, block_size=block), 3),
                cuda_ms(lambda: torch.zeros(
                    s * REDUCE_BLOCKS * (c + 1), device=dev).index_add_(
                        0, flat_ids, flat_p), 10))
            del flat_ids, flat_p, w, p
            out_bytes = s * REDUCE_BLOCKS * c * 4
            rows_block = int(fresh[4].sum())
            timing["round_fused_bound"] = bound_ms(*resolve_cost(
                n, c, s, s * n + rows_block, False, 2 * out_bytes + 9 * s))
            timing["sweep_partials_bound"] = bound_ms(*resolve_cost(
                n, c, s, s * n, False, out_bytes))
            timing["sweep_resolve_bound"] = bound_ms(*resolve_cost(
                n, c, s, s * n, False, s * n * 8 + s * c * 4))
            timing["segment_partials_bound"] = bound_ms(
                s * n * 8 + s * 8 + out_bytes, s * n)
            round_bodies = {}
            for resolve in RESOLVES:
                round_bodies[resolve] = executor._make_round_body(
                    executor.SweepPlan(resolve=resolve), resolve,
                    values=env.values, rules=grid.rules,
                    budgets_f32=grid.budgets, n_events=n, n_campaigns=c)
            core0 = (zeros, ones, torch.full((s, c), n + 1, dtype=torch.int32,
                                             device=dev),
                     n0, n0, torch.full((s, c + 1), -1, dtype=torch.int32,
                                        device=dev),
                     torch.zeros((s, c + 2), dtype=torch.int32, device=dev))
            timing["round_ms"] = {
                resolve: cuda_ms(lambda: body(core0, all_alive), reps)
                for (resolve, body), reps in zip(round_bodies.items(),
                                                 (3, 10, 10))}
        # the single-design resolve: EmbTile on the day's own embeddings,
        # MatrixTile on its valuation matrix; a (C,) and an (N, C) mask, a
        # reserve, the bids of lane 5
        mult1 = mult[5].contiguous()
        res1 = torch.tensor(0.05, device=dev)
        cmask = torch.rand(c, generator=card_gen, device=dev) < 0.8
        nmask = torch.rand((n, c), generator=card_gen, device=dev) < 0.8
        for mname, mask in (("(C,) mask", cmask), ("(N, C) mask", nmask)):
            what = f"auction_resolve {kind} {mname}"
            got = ops.auction_resolve(env.event_emb, env.campaign_emb, mult1,
                                      mask, res1, second_price=second)
            want = ref.auction_resolve_ref(env.event_emb, env.campaign_emb,
                                           mult1, mask, res1,
                                           second_price=second)
            torch.cuda.synchronize()
            equal("winners", got[0], want[0], f"{what} EmbTile")
            equal("prices", got[1], want[1], f"{what} EmbTile")
            close("auction_resolve", got[2], want[2])
            got = ops.resolve_masked(env.values, mult1, mask, res1,
                                     second_price=second)
            want = ref.resolve_masked_ref(env.values, mult1, mask, res1,
                                          second_price=second)
            on_cpu = ref.resolve_masked_ref(env.values.cpu(), mult1.cpu(),
                                            mask.cpu(), res1.cpu(),
                                            second_price=second)
            equal("winners", got[0], want[0], f"{what} MatrixTile")
            equal("prices", got[1], want[1], f"{what} MatrixTile")
            close("auction_resolve", got[2], want[2])
            equal("sums", got[2].cpu(), on_cpu[2], f"{what} MatrixTile on "
                  f"the CPU")
        # short resolves with sums: the kernel's winners and prices, the
        # sums first_crossing's flat sum (one a call), EmbTile's and
        # MatrixTile's bitwise the CPU's event-ordered sums
        ops.reset_paths()
        for rows in SHORT_SUM_ROWS:
            e_short, v_short = env.event_emb[:rows], env.values[:rows]
            for mname, mask in (("(C,) mask", cmask),
                                ("(N, C) mask", nmask[:rows])):
                what = f"auction_resolve {kind} {mname} N={rows} with sums"
                got = ops.auction_resolve(e_short, env.campaign_emb, mult1,
                                          mask, res1, second_price=second)
                want = ref.auction_resolve_ref(e_short, env.campaign_emb,
                                               mult1, mask, res1,
                                               second_price=second)
                equal("winners", got[0], want[0], f"{what} EmbTile")
                equal("prices", got[1], want[1], f"{what} EmbTile")
                equal("sums", got[2].cpu(), auction.spend_sums(
                    got[0].cpu(), got[1].cpu(), c), f"{what} EmbTile on the "
                                                    f"CPU")
                got = ops.resolve_masked(v_short, mult1, mask, res1,
                                         second_price=second)
                on_cpu = ref.resolve_masked_ref(
                    v_short.cpu(), mult1.cpu(), mask.cpu(), res1.cpu(),
                    second_price=second)
                for name, a, b in zip(("winners", "prices", "sums"), got,
                                      on_cpu):
                    equal(name, a.cpu(), b, f"{what} MatrixTile on the CPU")
        flat_calls = 4 * len(SHORT_SUM_ROWS)
        require(ops.PATHS["auction_resolve_flat_sums"] == flat_calls,
                f"short resolves took {ops.PATHS['auction_resolve_flat_sums']}"
                f" flat sums, expected {flat_calls}")
        print(f"[2] {kind}: auction_resolve with sums at N="
              f"{', '.join(map(str, SHORT_SUM_ROWS))} (EmbTile and "
              f"MatrixTile, both masks): flat sums, bitwise the CPU",
              flush=True)
        if kind == "first_price":
            # one design's resolve with sums at the short shapes
            timing["short_sums"] = {}
            for rows in SHORT_SUM_ROWS:
                e_short = env.event_emb[:rows]
                timing["short_sums"][rows] = cuda_ms(
                    lambda: ops.auction_resolve(e_short, env.campaign_emb,
                                                mult1, cmask, res1), 50)
        # the first crossings and spends of the 32 resolved lanes: cap times
        # bitwise the plain version on the card and (one lane) on the CPU,
        # spends bitwise the CPU's event-ordered sums
        w, p = resolved[0], resolved[1]
        fc_spend, fc_cap = seg_lib.crossing_and_spend(w, p, grid.budgets, c)
        plain_cap = seg_lib.first_crossing_ref(w, p, grid.budgets, c)
        torch.cuda.synchronize()
        equal("cap times", fc_cap, plain_cap, f"first_crossing {kind}")
        equal("cap times", seg_lib.first_crossing_times(
            w, p, grid.budgets, c), fc_cap, f"first_crossing {kind}, caps "
                                            f"only")
        equal("spend", fc_spend.cpu(), auction.spend_sums(w.cpu(), p.cpu(), c),
              f"first_crossing {kind} on the CPU")
        lane = CPU_LANE[kind]
        equal("cap times", fc_cap[lane].cpu(), seg_lib.first_crossing_ref(
            w[lane].cpu(), p[lane].cpu(), grid.budgets[lane].cpu(), c),
            f"first_crossing {kind} lane {lane} on the CPU")
        require(bool((fc_cap <= n).any()) and bool((fc_cap > n).any()),
                f"first_crossing {kind}: the lanes should cap some campaigns "
                f"and not others")
        print(f"[2] {kind}: auction_resolve (EmbTile and MatrixTile, both "
              f"masks) and first_crossing ({int((fc_cap <= n).sum())} "
              f"crossings in {s} lanes) agree with the plain versions",
              flush=True)
        if kind == "first_price":
            # auction_resolve standalone at N=1e6, C=100 (MatrixTile, an
            # (N, C) mask, no sums: no main path sends this shape since the
            # segment replays went to segment_resolve; phase 6 times the
            # JSON row's shape) and at the embeddings' (EmbTile, a (C,)
            # mask, sums); first_crossing of 32 lanes
            timing["auction_resolve_c100"] = (
                cuda_ms(lambda: ops.resolve_masked(
                    env.values, mult1, nmask, res1, sums=False), 10),
                cuda_ms(lambda: ref.resolve_masked_ref(
                    env.values, mult1, nmask, res1), 3), None)
            timing["auction_resolve_emb"] = (
                cuda_ms(lambda: ops.auction_resolve(
                    env.event_emb, env.campaign_emb, mult1, cmask, res1), 10),
                cuda_ms(lambda: ref.auction_resolve_ref(
                    env.event_emb, env.campaign_emb, mult1, cmask, res1), 3))
            timing["first_crossing"] = (
                cuda_ms(lambda: seg_lib.crossing_and_spend(
                    w, p, grid.budgets, c), 10),
                cuda_ms(lambda: seg_lib.first_crossing_ref(
                    w, p, grid.budgets, c), 1), None)
            # one lane: the shape of simulate()'s nine launches
            w1, p1, b1 = w[:1], p[:1], grid.budgets[:1]
            timing["first_crossing_one_lane"] = (
                cuda_ms(lambda: seg_lib.crossing_and_spend(w1, p1, b1, c),
                        10),
                cuda_ms(lambda: seg_lib.first_crossing_ref(w1, p1, b1, c),
                        1))
            # caps only (the refine passes), each call's device kernels,
            # the flat sums' chain floor
            timing["first_crossing_caps_only"] = {
                "S32": cuda_ms(lambda: seg_lib.first_crossing_times(
                    w, p, grid.budgets, c), 10),
                "one_lane": cuda_ms(lambda: seg_lib.first_crossing_times(
                    w1, p1, b1, c), 10)}
            timing["first_crossing_split"] = {
                "S32": fc_split("[2]", f"S={s}, spends and caps",
                                lambda: seg_lib.crossing_and_spend(
                                    w, p, grid.budgets, c)),
                "S32_caps_only": fc_split(
                    "[2]", f"S={s}, caps only",
                    lambda: seg_lib.first_crossing_times(
                        w, p, grid.budgets, c)),
                "one_lane": fc_split("[2]", "one lane, spends and caps",
                                     lambda: seg_lib.crossing_and_spend(
                                         w1, p1, b1, c)),
                "one_lane_caps_only": fc_split(
                    "[2]", "one lane, caps only",
                    lambda: seg_lib.first_crossing_times(w1, p1, b1, c))}
            timing["first_crossing_chain_floor"] = {
                "S32": chain_floor_ms(w, c), "one_lane": chain_floor_ms(w1, c)}
            # what a small call costs (auction.spend_sums on a short
            # log): one lane of the first SMALL_N events, bitwise the CPU
            timing["first_crossing_small"] = {}
            for rows in SMALL_N:
                ws, ps = w1[:, :rows].contiguous(), p1[:, :rows].contiguous()
                want = seg_lib.crossing_and_spend(ws.cpu(), ps.cpu(),
                                                  b1.cpu(), c)
                got = seg_lib.crossing_and_spend(ws, ps, b1, c)
                for name, a, b in zip(("spend", "cap times"), got, want):
                    equal(name, a.cpu(), b, f"first_crossing N={rows}")
                timing["first_crossing_small"][rows] = cuda_ms(
                    lambda: seg_lib.crossing_and_spend(ws, ps, b1, c), 50)
            d = env.event_emb.shape[1]
            timing["auction_resolve_c100_bound"] = bound_ms(
                n * c * 4 + n * c + c * 4 + 4 + n * 8, n * c * 2)
            timing["auction_resolve_emb_bound"] = bound_ms(
                (n + c) * d * 4 + c * 5 + 4 + n * 8 + c * 4,
                n * c * (2 * d + 6))
            timing["first_crossing_bound"] = bound_ms(
                s * n * 8 + s * c * 12, crossing_ops(w, n, c))
            timing["first_crossing_one_lane_bound"] = bound_ms(
                n * 8 + c * 12, crossing_ops(w1, n, c))
        del resolved, mid, w, p, nmask

    # the per-event (S, N, C) mask and the exact replay at the reduced size
    for kind in KINDS:
        second = kind == "second_price"
        grid = base_grid(kind, small.budgets, SMALL_AXES)
        s, (n_s, c_s) = grid.num_scenarios, small.values.shape
        per_event = (torch.rand((s, n_s, c_s), generator=gen) < 0.75).to(dev)
        check_sweep_resolve(f"{kind} per-event mask", small.values,
                            grid.rules.multipliers, per_event,
                            grid.rules.reserve, second)
        del per_event
        budgets = grid.budgets.clone()
        budgets[:, 2] = 0.0                     # caps at event 1, unsold
        mult = grid.rules.multipliers.clone()
        mult[:, 3] = 0.0                        # never bids above a reserve
        got = scan_ops.capped_scan(small.values, budgets, mult,
                                   grid.rules.reserve, second_price=second)
        t0 = time.perf_counter()
        want = capped_scan_ref(small.values, budgets, mult,
                               grid.rules.reserve, second_price=second)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for name, a, b in zip(("winners", "prices", "final_spend",
                               "cap_times"), got, want):
            equal(name, a, b, f"capped_scan {kind}")
        require(bool((got[3][:, 2] == 1).all()),
                f"capped_scan {kind}: a zero budget did not cap at event 1")
        print(f"[2] {kind}: sweep_resolve with an (S, N, C) mask and "
              f"capped_scan (reserve, zero budget, zero multiplier) agree "
              f"with the plain versions at N={n_s} C={c_s} S={s}; the plain "
              f"capped scan took {plain_s:.2f} s on the card "
              f"({plain_s / n_s * 1e6:.2f} us per event)", flush=True)
        # C past the first design's 256-campaign limit, state in shared
        # memory; budgets a fifth of the base so that most campaigns cap
        for c_w in WIDE_CAMPAIGNS:
            values_w = torch.rand((WIDE_EVENTS, c_w), generator=card_gen,
                                  device=dev)
            budgets_w = torch.rand((4, c_w), generator=card_gen,
                                   device=dev) * (0.2 * WIDE_EVENTS / c_w)
            mult_w = 0.5 + torch.rand((4, c_w), generator=card_gen,
                                      device=dev)
            res_w = torch.tensor([0.0, 0.05, 0.1, 0.2], device=dev)
            got = scan_ops.capped_scan(values_w, budgets_w, mult_w, res_w,
                                       second_price=second)
            want = capped_scan_ref(values_w, budgets_w, mult_w, res_w,
                                   second_price=second)
            for name, a, b in zip(("winners", "prices", "final_spend",
                                   "cap_times"), got, want):
                equal(name, a, b, f"capped_scan {kind} C={c_w}")
            print(f"[2] {kind}: capped_scan at N={WIDE_EVENTS} C={c_w} S=4 "
                  f"agrees with the plain version "
                  f"({int((got[3] <= WIDE_EVENTS).sum())} of {4 * c_w} "
                  f"campaigns capped)", flush=True)

    core_edges(dev, ops, ref, rf_mod, REDUCE_BLOCKS)
    segment_edges(dev, ops, ref)

    # Algorithm 4 at simulate's full shape: the vi kernel (one launch for
    # every batch) against the plain loop on the CPU on the same draws,
    # both rules and both couplings, bit for bit
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    values_cpu, budgets_cpu = env.values.cpu(), env.budgets.cpu()
    key = prng.PRNGKey(args.seed)
    k_sim = max(int(round(n * VI_SIMULATE["sample_rate"])),
                VI_SIMULATE["batch_size"])
    run_kw = dict(sample_size=k_sim, batch_size=VI_SIMULATE["batch_size"],
                  eta=0.5, eta_decay=VI_SIMULATE["eta_decay"], pi0=None,
                  track_every=0)
    for coupling in ("shared", "independent"):
        draws = vi_lib._draws(key, n, c, sample_size=k_sim,
                              num_iters=VI_SIMULATE["num_iters"],
                              batch_size=VI_SIMULATE["batch_size"],
                              coupling=coupling, device=dev)
        draws_cpu = vi_lib._Draws(idx=draws.idx.cpu(), u=draws.u.cpu(),
                                  n_batches=draws.n_batches)
        t0 = time.perf_counter()
        for kind in KINDS:
            rule = AuctionRule(multipliers=torch.ones(c, device=dev),
                               reserve=torch.zeros((), device=dev),
                               kind=kind)
            got = vi_lib._run(env.values, env.budgets, rule, draws, **run_kw)
            want = vi_lib._run(values_cpu, budgets_cpu, AuctionRule(
                multipliers=torch.ones(c), reserve=torch.zeros(()),
                kind=kind), draws_cpu, **run_kw)
            equal("pi", got.pi.cpu(), want.pi,
                  f"vi {kind} {coupling} against the CPU loop")
            require(bool(((got.pi >= 0) & (got.pi <= 1)).all())
                    and bool((got.pi < 1).any()),
                    f"vi {kind} {coupling}: pi out of [0, 1] or no campaign "
                    f"predicted to cap")
        print(f"[2] vi at simulate's shape (N={n} C={c}, {k_sim} sampled "
              f"rows, {draws.u.shape[0]} batches of "
              f"{VI_SIMULATE['batch_size']}), {coupling} coupling: bitwise "
              f"the plain loop on the CPU, both rules "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if coupling == "shared":
            chain = vi_lib._chain(env.values, env.budgets, draws,
                                  sample_size=k_sim,
                                  batch_size=VI_SIMULATE["batch_size"],
                                  eta=0.5, eta_decay=VI_SIMULATE["eta_decay"])
            vi_args = (chain.sampled, draws.u, chain.step, chain.denom,
                       chain.btilde[None], torch.ones((1, c), device=dev),
                       torch.zeros(1, device=dev),
                       torch.ones((1, c), device=dev))
            timing["vi"] = (
                cuda_ms(lambda: vi_mod.vi_cuda(
                    *vi_args, sample_size=k_sim, second_price=False), 10),
                cuda_ms_once(lambda: ref.vi_chain_ref(*vi_args,
                                                      sample_size=k_sim)),
                None)
            v_bytes, v_ops, v_floor = vi_cost(
                draws.n_batches, VI_SIMULATE["batch_size"], c, 1,
                draws.u.shape[0], 1, clock_hz)
            timing["vi_bound"] = bound_ms(v_bytes, v_ops)
            timing["vi_chain_floor"] = v_floor
            timing["vi_plain_shape"] = (k_sim, int(draws.u.shape[0]))
            del chain, vi_args
        del draws, draws_cpu
    # the scenario sweep on the warm start's sample, S=32: one launch for
    # every lane, bitwise the CPU's lane loop at VI_SWEEP_CPU_EPOCHS epochs;
    # then the kernel alone at the warm start's full 80 epochs, timed
    k_warm = max(int(round(n * VI_WARM["sample_rate"])), VI_WARM["batch_size"])
    warm_kw = dict(sample_size=k_warm, batch_size=VI_WARM["batch_size"],
                   eta_decay=VI_WARM["eta_decay"])
    for kind in KINDS:
        grid = base_grid(kind, env.budgets, GRID_AXES)
        t0 = time.perf_counter()
        got = vi_lib.estimate_pi_sweep(env.values, grid.budgets, grid.rules,
                                       key, num_iters=VI_SWEEP_CPU_EPOCHS,
                                       **warm_kw)
        lanes = torch.tensor(VI_SWEEP_CPU_LANES)
        want = vi_lib.estimate_pi_sweep(
            values_cpu, grid.budgets.cpu()[lanes], AuctionRule(
                multipliers=grid.rules.multipliers.cpu()[lanes],
                reserve=grid.rules.reserve.cpu()[lanes], kind=kind), key,
            num_iters=VI_SWEEP_CPU_EPOCHS, **warm_kw)
        equal("pi", got.pi.cpu()[lanes], want.pi,
              f"vi sweep {kind} S={grid.num_scenarios} against the CPU")
        print(f"[2] vi sweep {kind}: S={grid.num_scenarios} lanes in one "
              f"launch, {k_warm} sampled rows, {VI_SWEEP_CPU_EPOCHS} epoch(s) "
              f"({-(-k_warm // 64) * VI_SWEEP_CPU_EPOCHS} steps a lane): "
              f"lanes {VI_SWEEP_CPU_LANES} bitwise the CPU's lane loop "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    grid = base_grid(KINDS[0], env.budgets, GRID_AXES)
    s_warm = grid.num_scenarios
    draws = vi_lib._draws(key, n, c, sample_size=k_warm,
                          num_iters=VI_WARM["num_iters"],
                          batch_size=VI_WARM["batch_size"], coupling="shared",
                          device=dev)
    chain = vi_lib._chain(env.values, grid.budgets, draws, sample_size=k_warm,
                          batch_size=VI_WARM["batch_size"], eta=0.5,
                          eta_decay=VI_WARM["eta_decay"])
    warm_args = (chain.sampled, draws.u, chain.step, chain.denom,
                 chain.btilde.contiguous(),
                 grid.rules.multipliers.contiguous(),
                 grid.rules.reserve.contiguous(),
                 torch.ones((s_warm, c), device=dev))
    w_bytes, w_ops, w_floor = vi_cost(draws.n_batches, VI_WARM["batch_size"],
                                      c, 1, draws.u.shape[0], s_warm,
                                      clock_hz)
    timing["vi_warm"] = (cuda_ms(lambda: vi_mod.vi_cuda(
        *warm_args, sample_size=k_warm, second_price=False), 3),
        bound_ms(w_bytes, w_ops)[0], w_floor, draws.u.shape[0])
    print(f"[2] vi at the full per-scenario warm start (S={s_warm}, {k_warm} "
          f"sampled rows, {VI_WARM['num_iters']} epochs, "
          f"{draws.u.shape[0]} steps a lane): {timing['vi_warm'][0]:.4f} ms "
          f"(chain floor {w_floor:.4f} ms)", flush=True)
    del draws, chain, warm_args, values_cpu, budgets_cpu

    t_wall = phase_wall(2, t_wall)
    # ---- phase 3: exactness at a reduced size ----------------------------
    small_cpu = {}                  # phase 11 holds chunked sweeps to these
    for kind in KINDS:
        grid = base_grid(kind, small.budgets, SMALL_AXES)
        t0 = time.perf_counter()
        on_card = sweep_state_machine(small.values, grid.budgets, grid.rules,
                                      resolve="fused")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rules_cpu = AuctionRule(multipliers=grid.rules.multipliers.cpu(),
                                reserve=grid.rules.reserve.cpu(), kind=kind)
        on_cpu = sweep_state_machine(small.values.cpu(), grid.budgets.cpu(),
                                     rules_cpu, resolve="torch")
        t2 = time.perf_counter()
        for name, a, b in zip(OUTPUTS[1:], on_card[1:], on_cpu[1:]):
            require(torch.equal(a.cpu(), b), f"phase 3 {kind}: {name} differs")
        torch.testing.assert_close(on_card[0].cpu(), on_cpu[0], rtol=1e-6,
                                   atol=0.0)
        bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(on_card,
                                                               on_cpu))
        small_cpu[kind] = dict(grid=grid, out=on_cpu)
        print(f"[3] {kind}: N={small.n_events} C={small.n_campaigns} S=8 "
              f"fused on the card == torch on the CPU (bitwise: {bitwise}); "
              f"rounds {on_card[4].tolist()}; {t1 - t0:.2f} s on the card, "
              f"{t2 - t1:.2f} s on the CPU", flush=True)

    t_wall = phase_wall(3, t_wall)
    # ---- phase 4: the main path at full width ----------------------------
    results = {}
    counted = {name: 0 for name, _, _ in KERNELS}
    peak = {"fused": 0, "torch": 0}
    engines = {}
    for kind in KINDS:
        base = AuctionRule(multipliers=torch.ones(c, device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        engine = CounterfactualEngine(env.values, env.budgets, base_rule=base)
        grid = engine.grid(**GRID_AXES)
        engines[kind] = (engine, grid)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sweep = engine.sweep(grid, method="parallel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak["fused"] = max(peak["fused"], torch.cuda.max_memory_allocated())
        for name in ("round_fused", "sweep_partials"):
            counted[name] += launches[name]
        spend, caps = sweep.results.final_spend, sweep.results.cap_times
        require(bool(torch.isfinite(spend).all())
                and tuple(spend.shape) == (grid.num_scenarios, c)
                and bool((spend >= 0).all()),
                f"{kind}: spends not finite, negative or of the wrong shape")
        # the same sweep again: the kernels are deterministic
        fused = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                    resolve="fused")
        rounds = int(fused[4].max())
        require(launches["round_fused"] == rounds,
                f"{kind}: {launches['round_fused']} round_fused launches for "
                f"{rounds} rounds")
        require(launches["sweep_partials"] == 2 * rounds,
                f"{kind}: {launches['sweep_partials']} partials launches for "
                f"{rounds} rounds")
        require(torch.equal(spend, fused[0]) and torch.equal(caps, fused[1]),
                f"{kind}: a second fused sweep gave other bits")
        # the plain torch path on the card, one lane at a time: its
        # partials go through the event-ordered segment_partials kernel, so
        # it must give the fused path's bits
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                    resolve="torch")
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        torch_counts = read_counts()
        peak["torch"] = max(peak["torch"], torch.cuda.max_memory_allocated())
        plain_rounds = int(plain[4].max())
        require(torch_counts["segment_partials"] == 2 * plain_rounds,
                f"{kind}: torch path made {torch_counts['segment_partials']} "
                f"segment_partials launches for {plain_rounds} rounds")
        for name, a, b in zip(OUTPUTS, fused, plain):
            require(torch.equal(a, b),
                    f"{kind}: the torch path's {name} differs from the fused "
                    f"path's")
        # one lane at full width against the torch path on the CPU, where
        # index_add_ sums in event order as the kernels do: the same bits
        lane = CPU_LANE[kind]
        rule_cpu = AuctionRule(
            multipliers=grid.rules.multipliers[lane:lane + 1].cpu(),
            reserve=grid.rules.reserve[lane:lane + 1].cpu(), kind=kind)
        t0 = time.perf_counter()
        on_cpu = sweep_state_machine(env.values.cpu(),
                                     grid.budgets[lane:lane + 1].cpu(),
                                     rule_cpu, resolve="torch")
        cpu_wall = time.perf_counter() - t0
        for name, a, b in zip(OUTPUTS, fused, on_cpu):
            require(torch.equal(a[lane].cpu(), b[0]),
                    f"{kind}: lane {lane} {name} differs from the CPU")
        results[kind] = dict(wall=wall, plain_wall=plain_wall, rounds=rounds,
                             fused=fused)
        print(f"[4] {kind}: engine.sweep S={grid.num_scenarios} N={n} C={c}: "
              f"{rounds} rounds, {wall:.3f} s, "
              f"{n * grid.num_scenarios / wall:.4g} events*scenarios/s; "
              f"launches {launches}; torch path on the card bitwise the fused "
              f"path, all six outputs ({plain_wall:.3f} s, "
              f"{torch_counts['segment_partials']} segment_partials "
              f"launches); lane {lane} bitwise the CPU torch path "
              f"({cpu_wall:.1f} s)", flush=True)
        print(sweep.format_delta_table())
        del plain, on_cpu

    t_wall = phase_wall(4, t_wall)
    # ---- phase 5: the exact replay at full width -------------------------
    def fixed_point(kind, grid, res, second):
        """Every lane is the exact replay: resolving each event against the
        kernel's own activations (campaign c active at event n iff its cap
        time is above n and its budget positive) gives its winners and
        prices bitwise; first_crossing's flat sums of those sales give its
        spends bitwise; and on the host a sequential float32 np.cumsum of
        each campaign's prices first reaches its budget at its cap time."""
        t0 = time.perf_counter()
        events = torch.arange(n, device=dev)[:, None]
        for lane in range(grid.num_scenarios):
            mask = ((res.cap_times[lane][None, :] > events)
                    & (grid.budgets[lane] > 0)[None, :])
            w, p, _ = ops.resolve_masked(
                env.values, grid.rules.multipliers[lane], mask,
                grid.rules.reserve[lane], second_price=second, sums=False)
            require(torch.equal(w, res.winners[lane])
                    and torch.equal(p, res.prices[lane]),
                    f"{kind}: lane {lane} is not the replay of its own cap "
                    f"times")
            del mask, w, p
        require(torch.equal(auction.spend_sums(res.winners, res.prices, c),
                            res.final_spend),
                f"{kind}: the flat sums of the replay's sales are not its "
                f"spends")
        winners, prices = res.winners.cpu().numpy(), res.prices.cpu().numpy()
        caps = res.cap_times.cpu().numpy()
        budgets = grid.budgets.cpu().numpy()
        for lane in range(grid.num_scenarios):
            order = np.argsort(winners[lane], kind="stable")
            bounds = np.searchsorted(winners[lane][order], np.arange(c + 1))
            for cc in range(c):
                rows = order[bounds[cc]:bounds[cc + 1]]
                cum = np.cumsum(prices[lane][rows], dtype=np.float32)
                hit = np.nonzero(cum >= budgets[lane, cc])[0]
                want = rows[hit[0]] + 1 if len(hit) else n + 1
                require(caps[lane, cc] == want,
                        f"{kind}: lane {lane} campaign {cc}: cap time "
                        f"{caps[lane, cc]}, its sales' cumsum reaches the "
                        f"budget at {want}")
        print(f"[5] {kind}: all {grid.num_scenarios} lanes are the exact "
              f"replay at full width: each event resolved against the "
              f"kernel's own cap times gives its winners and prices, the "
              f"flat sums its spends, and each campaign's sequential cumsum "
              f"its cap times ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    exact = {}
    for kind in KINDS:
        second = kind == "second_price"
        engine, grid = engines[kind]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = engine.sweep(grid, method="sequential", record_events=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        require(launches["capped_scan"] == 1,
                f"{kind}: {launches['capped_scan']} capped_scan launches for "
                f"one sequential sweep")
        counted["capped_scan"] += launches["capped_scan"]
        res = seq.results
        require(bool(torch.isfinite(res.final_spend).all())
                and tuple(res.winners.shape) == (grid.num_scenarios, n),
                f"{kind}: the exact replay's outputs are malformed")
        again = sweep_sequential(env.values, grid.budgets, grid.rules)
        require(torch.equal(again.final_spend, res.final_spend)
                and torch.equal(again.cap_times, res.cap_times),
                f"{kind}: a second capped_scan launch gave other bits")
        # the replay is causal: its first PREFIX events are the replay of
        # the first PREFIX events, which the plain version runs on the CPU
        lane = CPU_LANE[kind]
        t0 = time.perf_counter()
        w_cpu, p_cpu, _, cap_cpu = scan_ops.capped_scan(
            env.values[:PREFIX].cpu(), grid.budgets[lane].cpu(),
            grid.rules.multipliers[lane].cpu(), grid.rules.reserve[lane].cpu(),
            second_price=second)
        cpu_wall = time.perf_counter() - t0
        caps = res.cap_times[lane].cpu()
        require(torch.equal(res.winners[lane, :PREFIX].cpu(), w_cpu)
                and torch.equal(res.prices[lane, :PREFIX].cpu(), p_cpu),
                f"{kind}: lane {lane}'s first {PREFIX} sales differ from the "
                f"CPU")
        require(torch.equal(torch.where(caps <= PREFIX, caps, PREFIX + 1),
                            cap_cpu),
                f"{kind}: lane {lane}'s cap times up to {PREFIX} differ from "
                f"the CPU")
        fixed_point(kind, grid, res, second)
        exact[kind] = dict(spend=res.final_spend, caps=res.cap_times,
                           wall=wall)
        print(f"[5] {kind}: exact replay S={grid.num_scenarios} N={n} C={c} "
              f"in one capped_scan launch: {wall:.4f} s, "
              f"{n * grid.num_scenarios / wall:.4g} events*scenarios/s; "
              f"a second launch gives the same bits; lane {lane}'s first "
              f"{PREFIX} events bitwise the CPU ({cpu_wall:.1f} s)",
              flush=True)
        del seq, res, again

    t_wall = phase_wall(5, t_wall)
    # ---- phase 6: three back-ends, one answer ----------------------------
    sr_wall = {}
    for kind in KINDS:
        engine, grid = engines[kind]
        fused = results[kind]["fused"]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                  resolve="sweep_resolve")
        torch.cuda.synchronize()
        sr_wall[kind] = time.perf_counter() - t0
        launches = read_counts()
        rounds = int(out[4].max())
        require(launches["sweep_resolve"] == rounds,
                f"{kind}: {launches['sweep_resolve']} sweep_resolve launches "
                f"for {rounds} rounds")
        require(launches["segment_partials"] == 2 * rounds,
                f"{kind}: {launches['segment_partials']} segment_partials "
                f"launches for {rounds} rounds")
        counted["sweep_resolve"] += launches["sweep_resolve"]
        counted["segment_partials"] += launches["segment_partials"]
        for name, a, b in zip(OUTPUTS, out, fused):
            require(torch.equal(a, b), f"{kind}: the sweep_resolve back-end's "
                                       f"{name} differs from the fused one's")
        rule0, budgets0 = scenario_rule(grid.rules, 0), grid.budgets[0]
        for resolve in RESOLVES:
            one = engine.simulate(rule0, budgets0, method="parallel",
                                  resolve=resolve)
            require(torch.equal(one.final_spend, fused[0][0])
                    and torch.equal(one.cap_times, fused[1][0]),
                    f"{kind}: engine.simulate(resolve={resolve!r}) differs "
                    f"from lane 0 of the sweep")
        print(f"[6] {kind}: torch, sweep_resolve and fused back-ends give "
              f"identical outputs; sweep_resolve sweep {rounds} rounds in "
              f"{sr_wall[kind]:.4f} s, launches {launches}; "
              f"engine.simulate of lane 0 equals lane 0 for all three",
              flush=True)

    # a C one past the round kernels' shared memory: "auto" takes the
    # any-C auction_resolve back-end (every lane of a round in one launch);
    # and one past the first partials kernel's limit (OLD_RF_LIMIT), which
    # the fused round now takes; ten campaigns capping
    rf_limit = ops.round_campaign_limits()["fused"]
    require(rf_limit >= OLD_RF_LIMIT, f"the fused round's limit {rf_limit} "
                                      f"fell below {OLD_RF_LIMIT}")
    gen_any = torch.Generator().manual_seed(args.seed)
    for c_any, backend in ((OLD_RF_LIMIT + 1, "round_fused"),
                           (rf_limit + 1, "auction_resolve")):
        values_any = torch.rand((ANY_C_EVENTS, c_any), generator=gen_any)
        values_any[:, :10] += 0.5
        budgets_any = torch.full((c_any,), 1e6)
        budgets_any[:10] = 5.0
        for kind in KINDS:
            out_any, grids_any = {}, {}
            for where in ("cpu", "cuda"):
                base = AuctionRule(
                    multipliers=torch.ones(c_any, device=where),
                    reserve=torch.zeros((), device=where), kind=kind)
                eng = CounterfactualEngine(values_any, budgets_any,
                                           base_rule=base, device=where)
                grids_any[where] = eng.grid(bid_scales=(1.0, 1.2),
                                            reserves=(0.0, 0.05))
                reset_counts()
                out_any[where] = eng.sweep(grids_any[where],
                                           method="parallel").results
                torch.cuda.synchronize()
                launches = read_counts()
            if backend == "round_fused":
                require(launches["round_fused"] > 0
                        and not launches["auction_resolve"],
                        f"{kind} C={c_any}: launches {launches}, expected "
                        f"the fused round")
                how = "the fused round, one past the first design's limit"
            else:
                # the sweep's rounds, from the same sweep on the CPU
                cpu_core = sweep_state_machine(
                    values_any, grids_any["cpu"].budgets,
                    grids_any["cpu"].rules, resolve="torch")
                equal("final_spend", cpu_core[0],
                      out_any["cpu"].final_spend, f"{kind} C={c_any} CPU")
                rounds_any = int(cpu_core[4].max())
                require(launches["auction_resolve"] == rounds_any
                        and launches["auction_resolve_merge"] == rounds_any
                        and launches["segment_partials"] > 0
                        and not launches["round_fused"]
                        and not launches["sweep_resolve"],
                        f"{kind} C={c_any}: launches {launches}, expected "
                        f"one auction_resolve and one merge a round "
                        f"({rounds_any} rounds, S=4) and segment_partials "
                        f"only")
                how = (f"one auction_resolve launch a round for all 4 lanes "
                       f"({rounds_any} rounds) and segment_partials, one "
                       f"past the fused round's shared memory")
                counted["auction_resolve"] += launches["auction_resolve"]
                counted["auction_resolve_merge"] += \
                    launches["auction_resolve_merge"]
            for name in ("final_spend", "cap_times"):
                equal(name, getattr(out_any["cuda"], name).cpu(),
                      getattr(out_any["cpu"], name),
                      f"{kind} C={c_any} sweep")
            require(bool((out_any["cpu"].cap_times <= ANY_C_EVENTS).any()),
                    f"{kind} C={c_any}: no campaign capped")
            print(f"[6] {kind}: engine.sweep(method='parallel') at "
                  f"C={c_any}, N={ANY_C_EVENTS} S=4: {how} (launches "
                  f"{launches}), bitwise the CPU", flush=True)
        if backend == "auction_resolve":
            any_c_phase(dev, values_any, gen_any, ops, ref, ar_mod, timing,
                        equal)
        del values_any, out_any

    t_wall = phase_wall(6, t_wall)
    # ---- phase 7: the paper's comparison ---------------------------------
    for kind in KINDS:
        engine, grid = engines[kind]
        alg2, oracle = results[kind]["fused"], exact[kind]
        s_par, s_seq = alg2[0].double().cpu(), oracle["spend"].double().cpu()
        rel = ((s_par - s_seq).abs() / s_seq.clamp(min=1e-9)).mean(-1)
        c_par = torch.clamp(alg2[1].cpu().long(), max=n + 1)
        c_seq = torch.clamp(oracle["caps"].cpu().long(), max=n + 1)
        shift = (c_par - c_seq).abs().double().mean(-1)
        print(f"[7] {kind}: Algorithm 2 against the exact replay, per lane "
              f"(mean relative spend error | capped: Alg. 2, exact | mean "
              f"cap-time shift in events)")
        for lane in range(grid.num_scenarios):
            print(f"    {lane:2d} {grid.labels[lane]:<26} "
                  f"{float(rel[lane]):.6f} | {int((c_par[lane] <= n).sum()):3d}"
                  f" {int((c_seq[lane] <= n).sum()):3d} | "
                  f"{float(shift[lane]):.1f}")
        worst = int(rel.argmax())
        require(float(rel.max()) < ORACLE_TOL,
                f"{kind}: lane {worst} has mean relative spend error "
                f"{float(rel.max()):.4f} >= {ORACLE_TOL}")
        walls = (results[kind]["wall"], sr_wall[kind], oracle["wall"])
        print(f"[7] {kind}: worst lane error {float(rel.max()):.6f}; wall: "
              f"Algorithm 2 fused {walls[0]:.4f} s, sweep_resolve "
              f"{walls[1]:.4f} s, exact replay {walls[2]:.4f} s; "
              + ", ".join(f"{n * grid.num_scenarios / w:.4g}" for w in walls)
              + " events*scenarios/s", flush=True)

    t_wall = phase_wall(7, t_wall)
    # ---- phase 8: SORT2AGGREGATE -------------------------------------------
    plain_index_add = torch.Tensor.index_add_
    index_adds = [0]

    def counting_index_add(self, *a, **k):
        index_adds[0] += 1
        return plain_index_add(self, *a, **k)

    def driven(fn):
        """``fn()`` run with every kernel count and a count of index_add_
        calls set to 0 just before; returns ``(result, wall seconds, kernel
        counts, index_add_ calls)``."""
        reset_counts()
        index_adds[0] = 0
        torch.Tensor.index_add_ = counting_index_add
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.Tensor.index_add_ = plain_index_add
        return out, wall, read_counts(), index_adds[0]

    def same_s2a(a, b, what):
        for name in ("final_spend", "cap_times"):
            require(torch.equal(getattr(a, name).cpu(),
                                getattr(b, name).cpu()),
                    f"{what}: {name} differs")

    def same_s2a_sweep(a, b, what):
        same_s2a(a.results, b.results, what)
        require(torch.equal(a.consistency_gaps.cpu(), b.consistency_gaps.cpu())
                and torch.equal(a.refine_iters.cpu(), b.refine_iters.cpu()),
                f"{what}: consistency gaps or refine iterations differ")

    s2a = {}
    s2a_peak = 0
    fc_device_kernels = 0

    def fc_kernels(passes: int) -> int:
        """first_crossing's device kernels in an S2A run of ``passes``
        passes: caps only (3) in all but the aggregate pass (4)."""
        return 3 * (passes - 1) + 4
    refine_iters = 8                      # engine.sweep's default
    for kind in KINDS:
        engine, grid = engines[kind]
        s = grid.num_scenarios
        torch.cuda.reset_peak_memory_stats()
        sim, sim_wall, sim_counts, sim_adds = driven(engine.simulate)
        sweep, sweep_wall, sweep_counts, sweep_adds = driven(
            lambda: engine.sweep(grid, method="sort2aggregate"))
        s2a_peak = max(s2a_peak, torch.cuda.max_memory_allocated())
        for what, cnt, adds in (("simulate", sim_counts, sim_adds),
                                ("sweep", sweep_counts, sweep_adds)):
            others = {k: v for k, v in cnt.items() if v and k not in (
                "vi", "segment_resolve", "first_crossing",
                "first_crossing_device_kernels")}
            require(cnt["vi"] == 1 and cnt["segment_resolve"] > 0
                    and cnt["first_crossing"] > 0 and not others,
                    f"{kind} S2A {what}: launches {cnt}, expected one vi "
                    f"launch and only segment_resolve and first_crossing "
                    f"besides")
            require(adds == 0, f"{kind} S2A {what} made {adds} index_add_ "
                               f"calls")
            for name in ("vi", "segment_resolve", "first_crossing"):
                counted[name] += cnt[name]
            fc_device_kernels += cnt["first_crossing_device_kernels"]
        # simulate: Algorithm 4 in one vi launch, then at most
        # refine_iters + 1 replay passes of one segment_resolve and one
        # first_crossing launch each
        require(sim_counts["segment_resolve"] == sim_counts["first_crossing"]
                <= refine_iters + 1,
                f"{kind}: S2A simulate launches {sim_counts}")
        # the sweep = the base design's simulate (its warm start), then
        # refine_iters + 1 passes of ONE segment_resolve launch for all S
        # lanes and one crossing launch each
        passes = refine_iters + 1
        require(sweep_counts["first_crossing"]
                == sim_counts["first_crossing"] + passes
                and sweep_counts["segment_resolve"]
                == sim_counts["segment_resolve"] + passes,
                f"{kind}: S2A sweep launches {sweep_counts} against "
                f"simulate's {sim_counts}")
        # first_crossing's device kernels: every refine pass asks for the
        # cap times only (3: the tiles' sums, the chain, the crossings),
        # the aggregate pass for the flat sums too (4)
        fc_sim = fc_kernels(sim_counts["first_crossing"])
        require(sim_counts["first_crossing_device_kernels"] == fc_sim
                and sweep_counts["first_crossing_device_kernels"]
                == fc_sim + fc_kernels(passes),
                f"{kind}: S2A first_crossing device kernels: simulate "
                f"{sim_counts['first_crossing_device_kernels']} (expected "
                f"{fc_sim}), sweep "
                f"{sweep_counts['first_crossing_device_kernels']} (expected "
                f"{fc_sim + fc_kernels(passes)})")
        # the full-size per-scenario warm start: Algorithm 4 for all S
        # lanes (10% sample, 80 epochs) in one vi launch, then the passes
        warm, warm_wall, warm_counts, warm_adds = driven(
            lambda: engine.sweep(grid, method="sort2aggregate",
                                 warm_start="per_scenario"))
        require(warm_counts["vi"] == 1 and warm_counts["vi_device_state"] == 0
                and warm_counts["segment_resolve"] == passes
                and warm_counts["first_crossing"] == passes
                and warm_counts["first_crossing_device_kernels"]
                == fc_kernels(passes)
                and not warm_counts["auction_resolve"] and warm_adds == 0,
                f"{kind}: per-scenario warm start launches {warm_counts}")
        require(bool(torch.isfinite(warm.results.final_spend).all())
                and tuple(warm.results.cap_times.shape) == (s, c),
                f"{kind}: per-scenario warm start outputs malformed")
        for name in ("vi", "segment_resolve", "first_crossing"):
            counted[name] += warm_counts[name]
        fc_device_kernels += warm_counts["first_crossing_device_kernels"]
        res = sweep.results
        require(bool(torch.isfinite(res.final_spend).all())
                and tuple(res.final_spend.shape) == (s, c)
                and bool((res.final_spend >= 0).all())
                and tuple(res.cap_times.shape) == (s, c),
                f"{kind}: S2A sweep outputs malformed")
        # the same again: the same bits
        same_s2a(engine.simulate(), sim, f"{kind} second S2A simulate")
        same_s2a_sweep(engine.sweep(grid, method="sort2aggregate"), sweep,
                       f"{kind} second S2A sweep")
        # Algorithm 4 alone, as simulate runs it (the default key and VI)
        vi_est, vi_wall, _, _ = driven(lambda: vi_lib.estimate_pi(
            env.values, env.budgets, engine.base_rule, prng.PRNGKey(0),
            sample_size=max(int(round(n * 0.01)), 64), num_iters=20,
            batch_size=64))
        # the reduced size: the card's bits are the CPU's
        outs = []
        t0 = time.perf_counter()
        for device in (dev, torch.device("cpu")):
            base_small = AuctionRule(
                multipliers=torch.ones(small.n_campaigns, device=device),
                reserve=torch.zeros((), device=device), kind=kind)
            eng = CounterfactualEngine(small.values, small.budgets,
                                       base_rule=base_small, device=device)
            outs.append((eng.simulate(), eng.sweep(
                eng.grid(**SMALL_AXES), method="sort2aggregate")))
        small_wall = time.perf_counter() - t0
        same_s2a(outs[0][0], outs[1][0], f"{kind} S2A simulate card vs CPU")
        same_s2a_sweep(outs[0][1], outs[1][1], f"{kind} S2A sweep card vs "
                                               f"CPU")
        # every lane's replay at the sweep's own cap times, S=32 and one
        # lane (lane 0's table, the shape of simulate's passes): the segment
        # kernel against its plain version (each lane's gathered mask and
        # resolve in PyTorch) and, as a second witness, the per-lane
        # MatrixTile route, bit for bit; timed at both shapes
        segs = Segments.from_cap_times(sweep.results.cap_times, n)
        seg_args = (env.values, grid.rules.multipliers, grid.rules.reserve,
                    segs.boundaries, segs.masks)
        one = (env.values,) + tuple(x[:1] for x in seg_args[1:])
        second = kind == KINDS[1]
        for lanes, args_ in ((s, seg_args), (1, one)):
            got = sg_mod.segment_resolve_cuda(*args_, second_price=second)
            for witness, want in (
                    ("the plain version", ref.segment_resolve_plain(
                        *args_, second_price=second)),
                    ("per-lane MatrixTile", ops.segment_resolve_per_lane(
                        *args_, second_price=second))):
                for name, a, b in zip(("winners", "prices"), got, want):
                    equal(name, a, b, f"segment_resolve {kind} S={lanes} at "
                                      f"the sweep's cap times against "
                                      f"{witness}")
                del want
            del got
        if kind == KINDS[0]:
            timing["segment_resolve"] = (
                cuda_ms(lambda: sg_mod.segment_resolve_cuda(
                    *seg_args, second_price=False), 10),
                cuda_ms(lambda: ref.segment_resolve_plain(*seg_args), 1),
                None)
            timing["segment_resolve_one_lane"] = (
                cuda_ms(lambda: sg_mod.segment_resolve_cuda(
                    *one, second_price=False), 10),
                cuda_ms(lambda: ref.segment_resolve_plain(*one), 3))
            k_seg = segs.masks.shape[1] - 1
            for tag, lanes in (("", s), ("_one_lane", 1)):
                sg_bytes, sg_ops, sg_floor = segment_cost(n, c, lanes, k_seg)
                timing[f"segment_resolve{tag}_bound"] = bound_ms(sg_bytes,
                                                                 sg_ops)
                timing[f"segment_resolve{tag}_issue_floor"] = sg_floor
        s2a[kind] = dict(sim_wall=sim_wall, sweep_wall=sweep_wall,
                         vi_wall=vi_wall, sweep=sweep, warm_wall=warm_wall,
                         launches=(sim_counts, sweep_counts, warm_counts))
        print(f"[8] {kind}: S2A engine.simulate() {sim_wall:.4f} s "
              f"(launches {sim_counts}); engine.sweep(method="
              f"'sort2aggregate') S={s} {sweep_wall:.4f} s (launches "
              f"{sweep_counts}); with warm_start='per_scenario' "
              f"{warm_wall:.4f} s (launches {warm_counts}); Algorithm 4 "
              f"alone {vi_wall:.4f} s; segment_resolve bitwise its plain "
              f"version and per-lane MatrixTile at the sweep's cap times "
              f"(S={s} and one lane); no "
              f"index_add_; a second run gives the same bits; at "
              f"N={small.n_events} C={small.n_campaigns} S=8 the card is "
              f"bitwise the CPU ({small_wall:.1f} s)", flush=True)
        print(sweep.format_delta_table())
        # accuracy against phase 5's exact replay
        oracle = exact[kind]
        s_hat, s_ref = res.final_spend.cpu(), oracle["spend"].cpu()
        rel = ((s_hat.double() - s_ref.double()).abs()
               / s_ref.double().clamp(min=1e-9)).mean(-1)
        swe = torch.stack([spend_weighted_relative_error(s_hat[k], s_ref[k])
                           for k in range(s)])
        c_s2a = torch.clamp(res.cap_times.cpu().long(), max=n + 1)
        c_seq = torch.clamp(oracle["caps"].cpu().long(), max=n + 1)
        print(f"[8] {kind}: SORT2AGGREGATE against the exact replay, per "
              f"lane (mean relative spend error | spend-weighted error | "
              f"capped: S2A, exact | cap times equal | consistency gap | "
              f"refine iterations used)")
        for k in range(s):
            print(f"    {k:2d} {grid.labels[k]:<26} {float(rel[k]):.6f} | "
                  f"{float(swe[k]):.6f} | {int((c_s2a[k] <= n).sum()):3d} "
                  f"{int((c_seq[k] <= n).sum()):3d} | "
                  f"{int((c_s2a[k] == c_seq[k]).sum()):3d} | "
                  f"{float(sweep.consistency_gaps[k]):.0f} | "
                  f"{int(sweep.refine_iters[k])}")
        # a lane whose replayed crossings reproduce its assumed cap times
        # (consistency gap 0) holds a self-consistent segment history: the
        # exact replay's, up to the float order of the crossing sums
        converged = sweep.consistency_gaps.cpu() == 0
        if bool(converged.any()):
            worst = float(swe[converged].max())
            require(worst < S2A_TOL,
                    f"{kind}: a lane with consistency gap 0 has "
                    f"spend-weighted error {worst:.4f} >= {S2A_TOL}")
        sim_err = float(spend_weighted_relative_error(sim.final_spend.cpu(),
                                                      s_ref[0]))
        print(f"[8] {kind}: {int(converged.sum())} of {s} lanes converged "
              f"(gap 0); worst lane spend-weighted error "
              f"{float(swe.max()):.6f}, worst mean relative error "
              f"{float(rel.max()):.6f}; engine.simulate() of the base design "
              f"(lane 0): spend-weighted error {sim_err:.6f}", flush=True)
        del outs, sweep, res, warm, segs, seg_args

    t_wall = phase_wall(8, t_wall)
    # ---- phase 9: LM serving -------------------------------------------
    t0 = time.perf_counter()
    lm = serve_phase(args.seed, dev, reset_counts, read_counts)
    print(f"[9] LM serving phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    counted["flash_attention"] = lm["launches"]
    errs["flash_attention"] = lm["err"]
    timing["flash_attention"] = lm["flash"]
    timing["flash_attention_bound"] = lm["flash_bound"]

    # ---- phase 10: numbers ------------------------------------------------
    # one traced fused sweep and one traced SORT2AGGREGATE simulate (first
    # price): device busy time by kernel
    engine, grid = engines[KINDS[0]]

    sweep_counts = {}
    sweep_us = trace("[10]", "fused sweep", lambda: sweep_state_machine(
        env.values, grid.budgets, grid.rules, resolve="fused"),
        counts=sweep_counts)
    # the partials kernel is lanes_kernel<second price, no stores, ...>
    partials_keys = [k for k in sweep_us
                     if "lanes_kernel<" in k and ", false, false," in k]
    partials_launches = sum(sweep_counts[k] for k in partials_keys)
    if partials_launches:
        partials_us = sum(sweep_us[k] for k in partials_keys)
        timing["sweep_partials_traced"] = (partials_us / 1e3,
                                           partials_launches)
        print(f"[10] partials_kernel in the traced fused sweep: "
              f"{partials_launches} launches, {partials_us / 1e3:.3f} ms, "
              f"mean {partials_us / 1e3 / partials_launches:.4f} ms a "
              f"launch (the first design: "
              f"{EARLIER_MS['sweep_partials_traced']} ms over 176)")
    trace("[10]", "S2A simulate", engine.simulate)
    # the exact replay of the full day, 32 lanes, first price: the kernel,
    # then its plain version over the first PLAIN_EVENTS events (a chain of
    # small launches per event; the full day would take many minutes),
    # which must give the kernel's first PLAIN_EVENTS sales bit for bit
    s = grid.num_scenarios
    scan_args = (grid.budgets, grid.rules.multipliers, grid.rules.reserve)
    scan_ms = cuda_ms(lambda: scan_ops.capped_scan(env.values, *scan_args),
                      3)
    kernel_out = scan_ops.capped_scan(env.values, *scan_args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_out = capped_scan_ref(env.values[:PLAIN_EVENTS], *scan_args)
    stop.record()
    stop.synchronize()
    timing["capped_scan"] = (scan_ms, start.elapsed_time(stop), None)
    for name, a, b in zip(("winners", "prices"), kernel_out, plain_out):
        equal(name, a[:, :PLAIN_EVENTS], b, "capped_scan full day")
    del kernel_out, plain_out
    timing["capped_scan_bound"] = bound_ms(
        n * c * 4 + s * c * 12 + s * 4 + s * n * 8 + s * c * 8, s * n * c * 3)
    print(f"[10] capped_scan, full day, S={s}: {scan_ms:.4f} ms "
          f"({scan_ms * 1e6 / n:.2f} ns per event of the lane chains; the "
          f"first design {EARLIER_MS['capped_scan']} ms, "
          f"{EARLIER_MS['capped_scan'] / scan_ms:.2f}x); the "
          f"plain version {timing['capped_scan'][1]:.1f} ms for the first "
          f"{PLAIN_EVENTS} events, bitwise the kernel; SM clock now "
          f"{smi('clocks.sm')}")
    fc_ms = timing["first_crossing"][0]
    fc1_ms, fc1_plain = timing["first_crossing_one_lane"]
    fc1_bound, fc1_by = timing["first_crossing_one_lane_bound"]
    fc_caps = timing["first_crossing_caps_only"]
    fc_floor = timing["first_crossing_chain_floor"]
    print(f"[10] first_crossing, S={s}: {fc_ms:.4f} ms (the first design "
          f"{EARLIER_MS['first_crossing']} ms, "
          f"{EARLIER_MS['first_crossing'] / fc_ms:.2f}x), caps only "
          f"{fc_caps['S32']:.4f} ms; bound "
          f"{timing['first_crossing_bound'][0]:.4f} ms "
          f"({timing['first_crossing_bound'][1]}), the flat sums' chain "
          f"floor {fc_floor['S32'][0]:.4f} ms ({fc_floor['S32'][1]} sales "
          f"of one (lane, campaign)); one lane (simulate's shape): "
          f"{fc1_ms:.4f} ms, caps only "
          f"{fc_caps['one_lane']:.4f} ms, plain {fc1_plain:.4f} ms, bound "
          f"{fc1_bound:.4f} ms ({fc1_by}), chain floor "
          f"{fc_floor['one_lane'][0]:.4f} ms ({fc_floor['one_lane'][1]} "
          f"sales)")
    print(f"[10] first_crossing, one lane, C={c}, small calls: " + ", ".join(
        f"N={rows} {ms:.4f} ms"
        for rows, ms in timing["first_crossing_small"].items()))
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    for kind, per_element in SCAN_INSTRUCTIONS.items():
        floor = s * n * c * per_element / (sms * 128 * clock_hz) * 1e3
        print(f"[10] issue floor of a full-day pass, {kind}: {s} x {n} x "
              f"{c} elements x {per_element:.4f} instructions over {sms} "
              f"SMs x 128 a cycle at {clock_hz / 1e9:.2f} GHz: {floor:.4f} "
              f"ms")
        timing[f"issue_floor_{kind}"] = floor
    late_bound, late_by = timing["sweep_partials_late_bound"]
    print(f"[10] {card}: partials_kernel full-day pass "
          f"{timing['sweep_partials'][0]:.4f} ms (first design "
          f"{EARLIER_MS['sweep_partials']} ms), late-round pass [N - "
          f"{block // 2}, N) for every lane "
          f"{timing['sweep_partials_late']:.4f} ms (bound {late_bound:.4f} "
          f"ms, {late_by}); round "
          f"{timing['round_fused'][0]:.4f} ms (first design "
          f"{EARLIER_MS['round_fused']} ms); sweep_resolve "
          f"{timing['sweep_resolve'][0]:.4f} ms (first design "
          f"{EARLIER_MS['sweep_resolve']} ms)")
    rm = timing["round_ms"]
    print(f"[10] per-round time from the fresh state, S=32 (CUDA events, "
          f"median): fused {rm['fused']:.4f} ms, sweep_resolve "
          f"{rm['sweep_resolve']:.4f} ms, torch path {rm['torch']:.4f} ms")
    for kind, r in results.items():
        print(f"[10] sweep {kind}: wall {r['wall']:.4f} s, "
              f"{n * 32 / r['wall']:.6g} events*scenarios/s, "
              f"{r['rounds']} rounds; torch path wall {r['plain_wall']:.4f} s;"
              f" sweep_resolve wall {sr_wall[kind]:.4f} s; exact replay wall "
              f"{exact[kind]['wall']:.4f} s")
    print(f"[10] peak device memory in a full-width sweep: fused "
          f"{peak['fused'] / 2**30:.3f} GiB, torch path "
          f"{peak['torch'] / 2**30:.3f} GiB")
    for kind, r in s2a.items():
        print(f"[10] SORT2AGGREGATE {kind}: simulate {r['sim_wall']:.4f} s, "
              f"sweep S=32 {r['sweep_wall']:.4f} s "
              f"({n * 32 / r['sweep_wall']:.6g} events*scenarios/s); "
              f"Algorithm 4 alone {r['vi_wall']:.4f} s, "
              f"{r['vi_wall'] / r['sim_wall']:.4f} of simulate and "
              f"{r['vi_wall'] / r['sweep_wall']:.4f} of the sweep; the sweep "
              f"with the full per-scenario warm start {r['warm_wall']:.4f} s")
    print(f"[10] peak device memory in the SORT2AGGREGATE runs: "
          f"{s2a_peak / 2**30:.3f} GiB")
    emb_ms, emb_plain = timing["auction_resolve_emb"]
    emb_bound, emb_by = timing["auction_resolve_emb_bound"]
    print(f"[10] auction_resolve EmbTile (N={n}, C={c}, "
          f"d={env.event_emb.shape[1]}, (C,) mask, with sums): "
          f"{emb_ms:.4f} ms, plain {emb_plain:.4f} ms, bound "
          f"{emb_bound:.4f} ms ({emb_by}); with sums, one design, C={c}: "
          + ", ".join(f"N={r_} {ms:.4f} ms"
                      for r_, ms in timing["short_sums"].items()))
    c100_ms, c100_plain, _ = timing["auction_resolve_c100"]
    c100_bound, _ = timing["auction_resolve_c100_bound"]
    ar_rows, ar_c, ar_chunks, ar_cols = timing["auction_resolve_shape"]
    ar_calls = timing["auction_resolve_calls"]
    ar_day = timing["auction_resolve_day"]
    print(f"[10] auction_resolve MatrixTile standalone at N={n}, C={c} "
          f"((N, C) mask, no sums; no main-path launches at this shape): "
          f"{c100_ms:.4f} ms, plain {c100_plain:.4f} ms, bound "
          f"{c100_bound:.4f} ms; the JSON line's auction_resolve and "
          f"auction_resolve_merge rows are the matrix kernel's two launches "
          f"at the any-C back-end's shape, N={ar_rows}, C={ar_c}, S=4 "
          f"({ar_chunks} chunks of {ar_cols}); a whole call S=4 "
          f"{ar_calls['s4']:.4f} ms, S=1 {ar_calls['s1']:.4f} ms (plain "
          f"{ar_calls['s1_plain']:.4f} ms; the first design's one-lane "
          f"kernel {EARLIER_MS['auction_resolve']} ms), device time a launch "
          f"{timing['auction_resolve_device']}; N={ar_day['shape'][0]}, "
          f"C={ar_day['shape'][1]}, S={ar_day['shape'][2]}: one launch "
          f"{ar_day['ms']:.4f} ms, one-lane launches "
          f"{ar_day['one_lane_launches_ms']:.4f} ms, bound "
          f"{ar_day['bound_ms']:.4f} ms, issue floor "
          f"{ar_day['issue_floor_ms']:.4f} ms")
    vi_ms, vi_plain, _ = timing["vi"]
    vi_bound, vi_by = timing["vi_bound"]
    warm_ms, warm_bound, warm_floor, warm_steps = timing["vi_warm"]
    print(f"[10] vi, simulate's Algorithm 4 (one lane, "
          f"{VI_SIMULATE['num_iters']} epochs of "
          f"{VI_SIMULATE['batch_size']} rows): {vi_ms:.4f} ms, plain "
          f"(ref.vi_chain_ref on the card) {vi_plain:.4f} ms, bound "
          f"{vi_bound:.4f} ms ({vi_by}), chain floor "
          f"{timing['vi_chain_floor']:.4f} ms; the full per-scenario warm "
          f"start (S={s}, {warm_steps} steps a lane): {warm_ms:.4f} ms, "
          f"bound {warm_bound:.4f} ms, chain floor {warm_floor:.4f} ms")
    sg1_ms, sg1_plain = timing["segment_resolve_one_lane"]
    sg1_bound, _ = timing["segment_resolve_one_lane_bound"]
    print(f"[10] segment_resolve at the sweep's cap times: S={s} "
          f"{timing['segment_resolve'][0]:.4f} ms (plain "
          f"{timing['segment_resolve'][1]:.4f} ms, bound "
          f"{timing['segment_resolve_bound'][0]:.4f} ms, issue floor "
          f"{timing['segment_resolve_issue_floor']:.4f} ms); one lane "
          f"{sg1_ms:.4f} ms (plain {sg1_plain:.4f} ms, bound "
          f"{sg1_bound:.4f} ms, issue floor "
          f"{timing['segment_resolve_one_lane_issue_floor']:.4f} ms)")
    tokens_out = LM_REQUESTS * LM_STEPS
    print(f"[10] {LM_ARCH} serving on {card}: prefill of {LM_REQUESTS} x "
          f"{LM_PROMPT} tokens {lm['prefill_s']:.4f} s "
          f"({LM_REQUESTS * LM_PROMPT / lm['prefill_s']:.6g} prompt tokens/s);"
          f" decode {lm['decode_ms']:.4f} ms per step of {LM_REQUESTS} tokens "
          f"({LM_REQUESTS / lm['decode_ms'] * 1e3:.6g} tokens/s); generate "
          f"of {LM_STEPS} tokens {lm['generate_s']:.4f} s "
          f"({tokens_out / lm['generate_s']:.6g} generated tokens/s); peak "
          f"device memory {lm['peak'] / 2**30:.3f} GiB; weights initialised "
          f"in {lm['init_s']:.2f} s")
    print(f"[10] flash_attention at {lm['flash_shape']}: "
          f"{lm['launches']} launches per prefill")
    for name, label, kernel_ms, plain_ms, library_ms, (bound, by), \
            cuda_core in lm["flash_timed"]:
        print(f"[10] flash_attention, {name} ({label}): {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by})"
              + (f" in split TF32 (on the CUDA cores {cuda_core:.4f} ms)"
                 if cuda_core else "")
              + (f"; the CUDA-core design "
                 f"{EARLIER_MS['flash_attention_f32']} ms"
                 if name == "float32 prefill" else ""))
    sp_ms, _, sp_library_ms = timing["segment_partials"]
    print(f"[10] segment_partials full-window pass: {sp_ms:.4f} ms, "
          f"{sp_ms / sp_library_ms:.4f} of the index_add_ beside it")

    # ---- phase 11: chunks, naive sampling, multi-slot, search ------------
    phase11 = chunks_phase(dev, env, small, engines,
                           {k: r["fused"] for k, r in results.items()},
                           small_cpu, exact, reset_counts, read_counts,
                           equal)
    modes = [(name, mode, phase11[key], phase11["mode_launches"][name])
             for name, mode, key in (
                 ("first_crossing", "carry", "first_crossing_carry"),
                 ("segment_resolve", "offset", "segment_resolve_offset"),
                 ("capped_scan", "scaled", "capped_scan_scaled"))]
    for name, mode, m, launches in modes:
        print(f"[11] {name} ({mode}; {m['rows']} rows): {m['ms']:.4f} ms"
              + (f", caps only {m['caps_only_ms']:.4f} ms"
                 if "caps_only_ms" in m else "")
              + f", plain {m['plain_ms']:.4f} ms, bound {m['bound'][0]:.4f} "
              f"ms ({m['bound'][1]})"
              + (f", the flat sums' chain floor {m['chain_floor_ms']:.4f} ms"
                 if "chain_floor_ms" in m else "")
              + f", {launches} launches on the chunked or sampled paths")
    # ---- phase 12: CRN scenario families ---------------------------------
    phase12 = crn_phase(dev, env, small, reset_counts, read_counts, equal,
                        seed=args.seed, clock_hz=clock_hz)
    timing.update(phase12["timing"])
    for name, launches in phase12["counted"].items():
        counted[name] += launches
    vo = phase12["vi_overlay"]
    part_rows, part_ms = phase12["crn_cells_part"]
    # ---- phase 13: the always-on counterfactual service ------------------
    phase13 = service_phase(dev, env, small, engines,
                            {k: r["fused"] for k, r in results.items()},
                            reset_counts, read_counts)
    for name, launches in phase13["counted"].items():
        counted[name] += launches
    resume = phase13["resume"]
    modes.append(("sweep_partials", "resume", resume, resume["launches"]))
    # ---- phase 14: the multi-GPU placements ------------------------------
    phase14 = sharded_phase(
        dev, env, small, engines, {k: r["fused"] for k, r in results.items()},
        exact, reset_counts, read_counts, equal,
        env_args=dict(seed=args.seed, n_events=full.n_events,
                      n_campaigns=full.n_campaigns, emb_dim=full.emb_dim,
                      b_base=full.b_base))
    for name, launches in phase14["counted"].items():
        counted[name] += launches
    for name, mode, key in (("sweep_partials", "shard", "sweep_partials_shard"),
                            ("first_crossing", "shard_carry",
                             "first_crossing_shard"),
                            ("segment_resolve", "shard_offset",
                             "segment_resolve_shard")):
        modes.append((name, mode, phase14[key], phase14[key]["launches"]))
    # ---- phase 15: plan tuning and the keyed days -------------------------
    phase15 = tune_phase(
        dev, env, engines, {k: r["fused"] for k, r in results.items()},
        {**{(k, "auto"): r["wall"] for k, r in results.items()},
         **{(k, "sweep_resolve"): w for k, w in sr_wall.items()}},
        reset_counts, read_counts, seed=args.seed, full=full,
        yahoo_full=PAPER_YAHOO_FULL, yahoo_cpu=dataclasses.replace(
            PAPER_YAHOO_CPU, n_day1=PAPER_YAHOO_CPU.n_day1 // YAHOO_CPU_CUT,
            n_day2=PAPER_YAHOO_CPU.n_day2 // YAHOO_CPU_CUT,
            budget=PAPER_YAHOO_CPU.budget / YAHOO_CPU_CUT))
    for name, launches in phase15["counted"].items():
        counted[name] += launches
    # ---- phase 16: the MoE and recurrent language models -----------------
    phase16 = mixers_phase(args.seed, dev, reset_counts, read_counts,
                           card_name=card)
    counted["flash_attention"] += phase16["flash_launches"]
    # ---- phase 17: the encoder-decoder, the patch prefix and sampling -----
    phase17 = encdec_phase(args.seed, dev, reset_counts, read_counts,
                           card_name=card)
    counted["flash_attention"] += phase17["flash_launches"]
    # ---- phase 18: training ------------------------------------------------
    phase18 = train_phase(args.seed, dev, reset_counts, read_counts,
                          card_name=card)
    for name, launches in phase18["launches"].items():
        counted[name] += launches
    # ---- phase 19: training the recurrent mixers, comm ---------------------
    phase19 = mixers_train_phase(args.seed, dev, reset_counts, read_counts,
                                 card_name=card)
    # ---- phase 20: the dry run and the hill climb, counted on meta --------
    phase20 = dryrun_phase(dev, read_counts,
                           phase18["full"]["step_median_s"], card_name=card)
    row18 = phase18["row"]
    timing["flash_attention_bwd"] = (row18["ms"], row18["plain_ms"],
                                     row18["library_ms"])
    timing["flash_attention_bwd_bound"] = row18["bound"]
    errs["flash_attention_bwd"] = row18["max_abs_err"]
    rows = []
    for name, src, replaces in KERNELS:
        ms, plain_ms, library_ms = timing[name]
        bound, bound_by = timing[f"{name}_bound"]
        print(f"[10] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms if library_ms is None else f'{library_ms:.4f}'}"
              f" ms, bound {bound:.4f} ms ({bound_by}), "
              f"{counted[name]} launches on its path")
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=counted[name],
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by,
                         library_ms=library_ms,
                         plain_events=(PLAIN_EVENTS if name == "capped_scan"
                                       else ar_rows
                                       if name.startswith("auction_resolve")
                                       else part_rows if name == "crn_cells"
                                       else None if name in (
                                           "flash_attention", "vi",
                                           "flash_attention_bwd")
                                       else n)))
        if name == "crn_cells":
            # the kernel at the plain version's rows, like for like
            rows[-1].update(plain_events_ms=part_ms)
        if name == "sweep_partials":
            rows[-1].update(late_ms=timing["sweep_partials_late"],
                            late_bound_ms=late_bound,
                            issue_floor_ms=timing["issue_floor_first_price"])
            if "sweep_partials_traced" in timing:
                traced_ms, traced_n = timing["sweep_partials_traced"]
                rows[-1].update(sweep_mean_ms=traced_ms / traced_n,
                                sweep_launches_traced=traced_n)
        if name == "first_crossing":
            rows[-1].update(one_lane_ms=fc1_ms, one_lane_plain_ms=fc1_plain,
                            one_lane_bound_ms=fc1_bound,
                            caps_only_ms=fc_caps["S32"],
                            one_lane_caps_only_ms=fc_caps["one_lane"],
                            chain_floor_ms=fc_floor["S32"][0],
                            one_lane_chain_floor_ms=fc_floor["one_lane"][0],
                            device_kernels=fc_device_kernels,
                            split_ms={k: {n: v[1] for n, v in sp.items()}
                                      for k, sp in timing[
                                          "first_crossing_split"].items()},
                            small_n_ms={str(k): v for k, v in timing[
                                "first_crossing_small"].items()})
        if name.startswith("auction_resolve"):
            rows[-1].update(n_events=ar_rows, n_campaigns=ar_c, n_lanes=4,
                            chunks=ar_chunks, chunk_cols=ar_cols)
        if name == "auction_resolve":
            device = timing["auction_resolve_device"]
            rows[-1].update(
                device_ms=device.get("matrix_lanes_kernel_s4"),
                call_ms=ar_calls["s4"], one_lane_call_ms=ar_calls["s1"],
                one_lane_plain_ms=ar_calls["s1_plain"],
                one_lane_device_ms=device.get("matrix_lanes_kernel_s1"),
                day=ar_day,
                standalone_c100_ms=c100_ms,
                standalone_c100_plain_ms=c100_plain,
                standalone_c100_bound_ms=c100_bound,
                emb_sums_ms=emb_ms, emb_sums_bound_ms=emb_bound,
                short_sums_ms={str(k): v for k, v
                               in timing["short_sums"].items()})
        if name == "auction_resolve_merge":
            rows[-1].update(device_ms=timing["auction_resolve_device"].get(
                "merge_kernel_s4"))
        if name == "flash_attention":
            for timed, _, t_ms, t_plain, t_lib, (t_bound, _), cuda_core \
                    in lm["flash_timed"]:
                key = timed.replace(" ", "_").replace("-", "_").replace(
                    ".", "_")
                rows[-1][f"{key}_ms"] = t_ms
                rows[-1][f"{key}_plain_ms"] = t_plain
                rows[-1][f"{key}_library_ms"] = t_lib
                rows[-1][f"{key}_bound_ms"] = t_bound
                if cuda_core:
                    rows[-1][f"{key}_cuda_core_bound_ms"] = cuda_core
            # phase 17's launches, counted in the row's: each model's
            # generate, all and those with causal=False
            for arch, rec in phase17["models"].items():
                key = arch.replace("-", "_").replace(".", "_")
                rows[-1][f"{key}_launches"] = rec["launches"]
                rows[-1][f"{key}_non_causal_launches"] = \
                    rec["non_causal_launches"]
        if name == "flash_attention_bwd":
            for label, rec in phase18["backward"]["shapes"].items():
                key = label.replace(" ", "_").replace("-", "_").replace(
                    ".", "_")
                rows[-1].update({f"{key}_{k}": v for k, v in rec.items()
                                 if k != "bound"})
                if "bound" in rec:
                    rows[-1][f"{key}_bound_ms"] = rec["bound"][0]
            full = phase18["full"]
            rows[-1].update(train_step_s=full["step_median_s"],
                            train_tokens_per_s=full["tokens_per_s"],
                            train_peak_gib=full["peak_gib"],
                            train_launches_per_step=full["launches"][0])
        if name == "vi":
            rows[-1].update(plain_sampled_rows=timing["vi_plain_shape"][0],
                            plain_steps=timing["vi_plain_shape"][1],
                            chain_floor_ms=timing["vi_chain_floor"],
                            warm_start_ms=warm_ms,
                            warm_start_bound_ms=warm_bound,
                            warm_start_chain_floor_ms=warm_floor,
                            warm_start_steps=warm_steps,
                            overlay_ms=vo["ms"],
                            overlay_plain_ms=vo["plain_ms"],
                            overlay_plain_steps=vo["plain_steps"],
                            overlay_bound_ms=vo["bound"][0],
                            overlay_bound_by=vo["bound"][1],
                            overlay_chain_floor_ms=vo["chain_floor_ms"],
                            overlay_steps=vo["steps"],
                            overlay_lanes=vo["lanes"],
                            overlay_staged=vo["staged"],
                            overlay_launches=phase12["counted"]["vi"])
        if name == "segment_resolve":
            rows[-1].update(
                one_lane_ms=sg1_ms, one_lane_plain_ms=sg1_plain,
                one_lane_bound_ms=sg1_bound,
                issue_floor_ms=timing["segment_resolve_issue_floor"],
                one_lane_issue_floor_ms=timing[
                    "segment_resolve_one_lane_issue_floor"])
        for mode_name, mode, m, launches in modes:
            if mode_name != name:
                continue
            rows[-1].update({f"{mode}_ms": m["ms"],
                             f"{mode}_plain_ms": m["plain_ms"],
                             f"{mode}_bound_ms": m["bound"][0],
                             f"{mode}_bound_by": m["bound"][1],
                             f"{mode}_rows": m["rows"],
                             f"{mode}_launches": launches})
            for extra in ("issue_floor_ms", "chain_floor_ms",
                          "caps_only_ms"):
                if extra in m:
                    rows[-1][f"{mode}_{extra}"] = m[extra]
            if "split" in m:
                rows[-1][f"{mode}_split_ms"] = {
                    k: v[1] for k, v in m["split"].items()}
        if name == "sweep_partials":
            hp = phase13["pass"]
            rows[-1].update(host_pass_ms=hp["ms"],
                            host_pass_copy_ms=hp["copy_ms"],
                            host_pass_bytes=hp["bytes"],
                            host_pass_bound_ms=hp["bound_ms"],
                            host_pass_pcie_bound_ms=hp["pcie_bound_ms"],
                            host_pass_launches=hp["launches"])
        require(counted[name] > 0, f"{name} never launched on its path")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase15.json").write_text(json.dumps(
        dict(card=card, **phase15), indent=1, default=str))
    (out_dir / "phase16.json").write_text(json.dumps(
        dict(card=card, **phase16), indent=1, default=str))
    (out_dir / "phase17.json").write_text(json.dumps(
        dict(card=card, **phase17), indent=1, default=str))
    (out_dir / "phase18.json").write_text(json.dumps(
        dict(card=card, **phase18), indent=1, default=str))
    (out_dir / "phase19.json").write_text(json.dumps(
        dict(card=card, **phase19), indent=1, default=str))
    (out_dir / "phase20.json").write_text(json.dumps(
        dict(card=card, **phase20), indent=1, default=str))
    print(f"[done] all phases in {time.perf_counter() - t_script:.1f} s on "
          f"{card}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

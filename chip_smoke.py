#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``); exits non-zero without them, or when run outside
a checkout of the repository.  Phases, each of which must pass:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (timed; one nvcc per source, all started together);
2. drive the main path, the stream-triggered Faces loop, at full size —
   a (2,2,2) rank grid of 128^3 float32 blocks (2.1 M points a rank,
   67 MB of field), direct26, batched, coalesced, ``pack="kernel"``,
   ``damping=0.12`` — through the host, fused and persistent engines,
   10 iterations each, in ``stream`` and ``dataflow`` modes, with the
   kernels' launch counters set to 0 just before and read just after;
3. check the results: the engines agree bit for bit, the
   ``pack="torch"`` run agrees bit for bit, one iteration agrees with
   the NumPy ``faces_oracle`` within 1e-4, dispatch counts are
   ``dispatch_count_host() x 10`` / 10 / 1, the four Faces kernels
   launched;
4. drive the same 10 iterations the paper's other way, through ONE
   contiguous buffer per rank (``faces_step_contiguous``:
   ``ops.pack_boundary`` and ``ops.unpack_boundary_add``, counters set
   to 0 just before), and require the first iteration and the tenth
   equal to the host engine's bit for bit;
5. hold each halo and boundary kernel against its plain PyTorch version
   on the main path's shapes, bit for bit (``halo_pack`` and
   ``halo_unpack_add`` on all 26 regions, the unpack in float32 and
   bf16; the boundary pair on each of the 8 rank blocks and on a bf16
   block, ``pack_boundary`` also on the whole field in both dtypes;
   ``pack_segments`` also on a relay-heavy bf16 member set at unaligned
   columns), and time kernel, plain version and one PyTorch call for
   the same function (CUDA events, median); ``halo_unpack_add`` also on
   one region of each class (x-, y- and z-face, edges along x, y and z,
   corner) against a slice ``add_``, with two bounds: the useful bytes
   and the 32-byte sectors the region touches (``sector_bound_ms``, also
   in the pack's, the unpack's and both boundary kernels' rows of the
   kernels line), and ``halo_pack`` on the same regions against a slice
   ``copy_`` with the same two bounds; ``unpack_boundary_add`` is timed
   beside one ``index_add_`` of the buffer at the regions' flat indices
   (which adds overlapping regions in another order: timed, not
   compared), ``unpack_segments`` beside no library call (no single
   PyTorch call writes N separate tensors); and, untimed, the four Faces
   kernels bit for bit at the part shapes of phase 12 (64- and 32-plane
   blocks: all 26 regions, and every coalescing plan of the 2- and
   4-part linked schedules, ghost planes and cross payloads included);
6. serve mamba2-2.7b at full width and depth (64 layers, d_model 2560,
   80 SSD heads of 64, state 128, vocab 50 280, bf16 compute, float32
   parameters from ``torch.Generator(seed)``): 4 slots, 512-token
   prompts, 32 tokens each, first device-resident (decode = one CUDA
   graph launch) then host-stepped (one launch per token); the prefill
   is one CUDA-graph launch in both.  A set-up serve in each mode
   captures the graphs; the kernels' counters are set to 0 just before
   it and read after the two served runs, which must launch no kernel
   eagerly and each launch the prefill graph once; the prefill graph
   must hold the SSD kernel, 64 launches all on its tensor-core route,
   and the rmsnorm kernel; ``torch.profiler`` windows
   over an eager and a graphed prefill and a decode step;
7. check the serving results: both modes emit the same tokens, the
   graphed prefill equals an eager ``Model.prefill`` bit for bit
   (logits and caches), ``forward_logits`` (the reference's no-cache
   kernel path) equals the prefill's last-position logits bit for bit
   (phase 19's models, whose unembedding GEMM cuBLAS may run by another
   algorithm at another row count, hold ``Model.hidden_states``' last
   row unembedded as the prefill does bit for bit), and the logits are
   finite;
8. hold the SSD kernel against its plain version, each case on its
   route: at the served shapes in bf16 within a bound derived from bf16
   rounding, and at the same bound on bf16 cases at the served widths
   (a short last chunk with ``init_state`` and 2 groups, 11 chunks, the
   extreme decay of ``tests/test_torch_gpu.py``, whose state is also
   held to that test's float32 bound) on the tensor-core route, and on
   the float32 cases of ``tests/test_kernels.py`` (plus a tail and an
   ``init_state`` case) at the repo's rtol 2e-4 / atol 3e-5 on the
   CUDA-core route; time the kernel, the CUDA-core kernel on the served
   bf16 inputs (``earlier_ms``) and the plain version;
9. serve gemma3-1b at full width and depth (26 layers, d_model 1152, 4
   query heads and 1 kv head of 256, 22 local layers with a 512-token
   window and 4 global ones, vocab 262 144, bf16 compute over float32
   parameters from ``torch.Generator(seed)``): 4 slots, 1024-token
   prompts (twice the window, so the local layers skip kv tiles), 32
   tokens each, resident then host-stepped, counted as in phase 6; the
   prefill graph must hold 26 flash launches on the tensor-core route
   and none on the CUDA-core route, and at least 105 norms; the checks
   of phase 7 (the eager prefill takes the same routes); profiles as in
   phase 6;
10. hold flash attention against its plain version on the q, k, v of the
   served prefill's first local layer (0) and first global layer (5),
   taken by calling the layers' functions, in bf16 within one rounding
   of the output (the tensor-core route), on bf16 cases at head_dim 64,
   128 and 256 at the same bound, and on float32 cases (softcap, one
   query at an offset, ragged kv, head_dim 32/64/128/256) at the repo's
   rtol 2e-4 / atol 3e-5 (the CUDA-core route); rmsnorm on the served
   layer-0 input and at d 1152, 256 and 2560 with a ragged row count at
   ``weight_offset`` 0 and 1, and at the decode shapes (4 x 2560, 4 x
   5120, 4 x 1152, 16 x 256 bf16); require the served input's first 4
   rows, normalised alone, equal to the same rows of the whole input
   bit for bit (two routes of the kernel); time both, flash on the
   global and the local layer, rmsnorm also at the decode shapes,
   against ``F.scaled_dot_product_attention`` and ``F.rms_norm``;
11. convergence on the Faces configuration of phase 2: for tol 1e-1,
   1e-2 and 1e-3 (``max_iters`` 64), ``run_faces_until_converged`` in
   ``dataflow`` mode (ONE launch of a CUDA graph whose conditional WHILE
   node repeats two passes, set by the step kernel of
   ``csrc/graph_loop.cu``; double buffered) against host-polled
   ``FusedEngine`` (one call and one host read of the residual an
   iteration): equal ``n_done``, residual trace and buffers bit for
   bit, dispatches 1 against ``n_done``, sync points 0 against
   ``n_done``, wall times (the counters are set to 0 just before these
   runs and read after them); tol 0 with ``max_iters`` 20 in both modes
   must stop at 20 and equal ``PersistentEngine(n_iters=20)`` bit for
   bit, with ms per iteration beside it (with and without the residual)
   and the times of one field copy and one residual; the step kernel
   against the plain step on known traces (the bound, and both
   parities of the last pass), and its time per iteration;
12. composition on the Faces configuration of phase 2: the domain split
   into 2 and 4 x-parts, one queue each, linked by cross-program
   channels and composed (``run_faces_pipelined``, 10 iterations, ONE
   graph launch with one CUDA stream a program), in ``stream`` and
   ``dataflow``: the merged field equal to the full-domain
   ``PersistentEngine`` bit for bit, dispatches and graph launches 1,
   the captured pass one stream wide a program (``graph_loop.
   graph_edges``: the kernel nodes' largest unordered set is 1 for the
   plain program and N for N parts in ``stream``, at most 2N in
   ``dataflow``), ms per iteration beside the full-domain run's and a
   ``torch.profiler`` window of each (one call, 10 iterations); with
   ``exchange=False`` each part equal to its own ``run_faces_persistent``
   bit for bit; one pass of the 2-part schedule on the host and fused
   engines equal to the full program's.  The counters are set to 0
   just before each composed run (``run_faces_pipelined``; the
   ``PersistentEngine`` of the schedule, compiled and called) and read
   just after it, before any other run: each such run must launch all
   four Faces kernels, and its counts are printed per mode and parts;
13. the verifier and the sanitizer: ``verify_program`` finds nothing on
   every program and schedule this script builds (count, and host ms of
   the largest); ``FusedEngine`` and ``PersistentEngine`` with
   ``sanitize=True`` equal ``sanitize=False`` bit for bit on the Faces
   program and the 2-part linked schedule in both modes, ms per
   iteration for both (and a profile of the persistent Faces call with
   and without); the racy mutation of ``tests/test_verify.py``
   (an unpack kernel moved ahead of its wait) at full width raises
   ``SanitizeError`` in every engine's constructor with no kernel
   launched, while the unsanitized engine runs it; the program registry
   (``repro_torch.analysis``) on the benchmark grid's 8 ranks: every
   program lints clean and every certificate is race-free.

14. the masked multi-queue loop on the Faces configuration of phase 2,
   split along x into 2 and 4 linked parts, in ``stream`` and
   ``dataflow``, each part to its own count or tolerance in ONE launch
   of a CUDA graph (a conditional WHILE node over two passes of every
   part, set by the schedule step of ``csrc/graph_loop.cu``, which also
   fires each part's snapshot and restore copies): (a) tolerance 1e-2 on
   every part, ``max_iters`` 20; (b) tolerances (1e-1, 1e-3) and (1e-1,
   1e-2, 1e-2, 1e-3), whether the tightest part plateaus at the bound,
   ms per iteration (CUDA events), the pass's and the freeze graphs'
   node counts by type, and (2 parts)
   ``sanitize=True`` equal bit for bit; (c) (b) unlinked, each part
   equal to its own ``run_faces_until_converged`` bit for bit (field,
   trace, ``n_done``); (d) 2 linked parts with counts 3 and 7, no
   reductions; (e) reductions only, every count 10, equal to the
   fixed-count composed graph bit for bit, ms per iteration beside it
   (CUDA events).  Every solve: one dispatch and one graph launch,
   fields, traces and ``n_done`` equal to the eager
   ``_run_schedule_while`` run on the card's tensors bit for bit, wall
   ms of the graph and the eager loop (host clock around synchronized
   calls), and the four Faces kernels and the schedule step launched
   (counters set to 0 just before the engine's compile and first call,
   read just after); the schedule step against the plain step on known
   traces, and its time per pass.
15. the tuner on phase 12's linked 2- and 4-part pipeline at full width:
   ``run_faces_pipelined(tune=True)`` (the reference's default space,
   interleave {round_robin, sequential, 2} x mode {dataflow, stream}; the
   3 cheapest predictions timed) and ``tune(certify=True)`` on the same
   builds with all 6 timed; then the 26-layer TP chain of phase 16 over
   mode x coalesce x double_buffer {None, False} (all 8 timed).  Each
   candidate's predicted µs beside its measured median and the rank
   agreement (Spearman) — no threshold: the cost model's constants are
   the reference's CPU ones; every candidate certified, each winner one
   dispatch and one graph launch, equal to the untuned run bit for bit
   (the Faces kernels' counters set to 0 just before each tuned run and
   read just after);
16. the ring collectives at gemma3-1b's MLP widths (m 4096 = 4 slots x
   1024 tokens, d_model 1152, d_ff 6912; weights from
   ``torch.Generator(seed)`` scaled by 1/sqrt(fan-in)) on a one-axis
   mesh of 4 ranks, float32: ``build_all_gather_matmul`` uni- and
   bidirectional, ``build_matmul_reduce_scatter``, ``build_all_to_all``
   through FusedEngine and PersistentEngine in both modes, each one
   launch, finite and equal to the port's decomposed oracle on the card
   bit for bit, and to its CPU run within rtol=atol=1e-5 (the
   all-to-all bit for bit); ``build_tp_block(chain=True)`` persistent
   over 26 layers: one dispatch, equal to 26 decomposed block
   applications bit for bit, to 26 fused calls and to its CPU run; ms a
   layer beside 26 eager calls of the stock composition (CUDA events).
   No hand-written kernel is on this path (the matmuls are cuBLAS, as
   the reference's are XLA's): every counter, set to 0 before it, reads
   0 after it.
17. continuous serving (4 slots, 512-token prompts, 32 tokens a request,
   a decode chunk of 8) of (a) qwen1.5-0.5b (24 layers, d_model 1024, 16
   query and 16 kv heads of 64, vocab 151 936), (b) glm4-9b (40 layers,
   d_model 4096, 32 query and 2 kv heads of 128, rotary on half of each
   head, an untied head, vocab 151 552; first served as phase 9 serves
   gemma3-1b, resident then host-stepped, its prefill graph holding 40
   flash launches all on the tensor-core route, graphed prefill ==
   eager == ``forward_logits`` bit for bit) and (c) mamba2-2.7b, each
   at full width and depth, bf16 over float32 parameters from
   ``torch.Generator(seed)``.  A scripted mixed-depth sequence: admit
   slots 0 and 1, one decode round, admit slots 2 and 3 while 0 and 1
   are in flight at depth 528, decode rounds until every slot stops;
   each admission is ONE graph launch equal bit for bit to the eager
   admission on a copy of the same state (outputs and every cache
   leaf), the second admission leaves the in-flight slots bit-equal to
   an eager decode round without it (K/V, or the SSM ``conv`` and
   ``state``), every round returns the same state buffers (no cache
   copy between rounds), the admission graph's closing copies move no
   more bytes than the decode graph's (the merge is in place, so no
   cache set is copied within a round), and each slot's tokens equal
   serving its prompt alone in the
   same slot of an engine with as many slots, bit for bit.  Then
   ``serve_continuous`` with 16 requests as a t=0 burst and as a
   Poisson stream whose mean gap is one measured decode round: tok/s,
   p50 and p99 latency, dispatches (admission and decode) and syncs (a
   sync a dispatch, no prefill dispatch, a graph launch a round).  The
   admission graph holds a flash launch a layer on the tensor-core
   route (qwen, glm4) or the SSD kernel's 64 on its tensor-core route
   (mamba2).  Flash attention and rmsnorm are held against their plain
   versions on the served layer 0 of qwen and glm4 (one bf16 rounding;
   rmsnorm also on a decode step's 4 rows, on the team route, at the
   model's ``norm_eps``) and timed beside them cold, each call on a copy
   of its inputs that the L2 no longer holds (the rows'
   ``served_shapes``).  The kernels'
   counters are set to 0 just before each model's path and read just
   after its last ``serve_continuous`` (less the eager checks'
   launches; the rows' ``phase17_launches``).  A profile of one qwen
   admission round.

18. train mamba2-2.7b at full width and depth (64 layers, d_model 2560,
   80 SSD heads of 64, state 128, vocab 50 280; bf16 compute over
   float32 parameters from ``torch.Generator(seed)``; AdamW with
   float32 moments; every layer checkpointed, ``remat="block"``) on
   batches of 4 x 512 tokens from ``SyntheticTokens`` (the cut of the
   reference's pod-scale ``train_4k``, 256 x 4096, is printed on a line
   of its own), with deterministic algorithms off (``torch.
   use_deterministic_algorithms`` is never turned on):
   (a) 3 eager steps, every gradient leaf of step 1 present, finite and
   not all zero; (b) the same 3 steps as ONE CUDA-graph launch
   (``persistent_steps``), equal to (a) bit for bit in params, AdamW
   state and metrics; (c) ``until=loss_plateau`` through the graph-loop
   WHILE node: ``steps_done`` and the loss trace equal ``loss_plateau``
   polled on the host over (a)'s steps; (d) the SSD backward on the
   served bf16 inputs (the model's path: dy only, and with init_state
   and dh) on its tensor-core route, and the CUDA-core kernel on the
   same inputs, against the plain VJP in float32; float32 CUDA-core
   cases (a short last sub-chunk, init_state, 2 groups) and those of
   P 64, N 128 in bf16 on the tensor-core route, with S 1100 (two
   groups of chunks); each case's route recorded; the RMSNorm backward
   on the team route's training shapes (2048 x 2560 and 2048 x 5120) and
   on the rows route's (4096 x 1024): against the plain VJP, two runs and
   a CUDA-graph replay equal to eager bit for bit, each timed with its
   bound, the plain VJP and autograd of ``F.rms_norm``, its row pass and
   dw pass apart (``torch.profiler``); (e) the
   kernels' launches in one eager step, counters set to 0 just before
   it: the SSD forward 128 times on the tensor-core route (64 forward,
   64 recompute), its backward 64 times on the tensor-core route, the
   RMSNorm forward and backward; (f) ms a step eager and as one launch,
   tokens/s, one step split into forward, backward and optimizer (CUDA
   events) with its top kernels and the RMSNorm backward's sum
   (``torch.profiler``), the recompute as
   a no-grad run of the layer stack, and the peak memory.
19. the hybrid, encoder-decoder and vision families: (a) hymba-1.5b (32
   hybrid layers, d_model 1600, 25 query and 5 kv heads of 64, a window
   of 1024 with layers 16 and 32 global, 50 SSD heads of 64 at state 16,
   128 meta tokens, vocab 32 001) and (b) whisper-large-v3 (32 encoder
   layers over 1500 frames of ``audio_embeds``, not causal, and 32
   decoder layers with cross attention, d_model 1280, 20 heads of 64,
   sinusoidal positions, vocab 51 866), each at full width and depth,
   bf16 over float32 parameters from ``torch.Generator(seed)`` (whisper's
   encoder and decoder matrices times 8, ``TRUNK_SCALE``, so that its
   tokens depend on the prompt and the audio): served
   as phase 9 serves gemma3-1b (4 slots, prompts of 512 and 64 tokens,
   32 tokens each), the launch counts of the prefill graph and of one
   eager prefill (counters set to 0 just before it) equal to those
   reckoned from the config (hymba: 32 flash on the tensor-core route,
   32 SSD scans on the N-16 tensor-core route, 129 norms; whisper: 96 flash,
   162 norms); the checks of phase 7, and every slot's tokens distinct
   from every other's, served and continuous; profiles as in phase 6;
   flash at every served shape (hymba's layer 0, whose window of 1024
   does not bind over 640 keys: the global layers' function,
   whisper's encoder, decoder self and cross layer 0 and a decode
   query against the 1500 frames), the SSD scan at hymba's served
   shape without and with an initial state (the prompt's end state) on
   its N-16 tensor-core route, the CUDA-core kernel timed on the same
   inputs, and every SSD launch of hymba's serving and continuous
   admissions required on that route,
   rmsnorm at d 1600, 3200 (the gated norm) and 1280, each against its
   plain version and timed cold beside it and SDPA or ``F.rms_norm``
   (with the SSD scan's bound by ``ssd_flops_bytes`` at the bf16
   tensor-core peak, its inputs' type); then continuous
   serving as phase 17 does it (chunk 8: the scripted sequence, a
   16-request burst, tokens equal to serial serving).  (c)
   internvl2-76b: its full-size parameters on the meta device against
   the count its config gives, and its smoke model (float32) served on
   the card with a 16-patch vision prefix: tokens equal to the CPU's,
   resident and host-stepped, the checks of phase 7, the capacity and
   ``pos`` counting the prefix;
20. the MoE family, uncut in width with bf16 parameters from
   ``torch.Generator(seed)`` (the trunks' matrices times 8,
   ``MOE_TRUNK_SCALE``, so that the tokens depend on attention and the
   experts): (a) deepseek-v3-671b cut to 3 layers (``MOE_CUTS``: 1 dense,
   then 2 of 256 routed experts, top-8 by a sigmoid router with its bias,
   plus 1 shared; MLA with 128 heads, q/k head dim 192 and v 128; d_model
   7168, vocab 129 280: 26.14 B parameters, 52.3 GB) and grok-1-314b cut
   to 2 (8 experts of d_ff 32 768, top-2 by softmax; GQA 48/8 at 128,
   soft-cap 30, output multiplier 0.0884: 11.45 B, 22.9 GB), served as
   phase 19 serves hymba (4 slots, 512-token prompts, 32 tokens,
   resident and host-stepped), the prefill graph's and one eager prefill's
   launches equal to those reckoned from the config (deepseek 3 flash
   at (192, 128) and grok 2 at 128, all on the tensor-core route; 13
   and 5 norms), the checks of phase 7, every slot's tokens distinct;
   ``torch.profiler`` windows of an eager prefill and decode step split
   into the MoE layers' routing, dispatch, expert ``bmm``s and combine,
   flash, norms and the rest, with the idle share, and the profiles of
   phase 6; (b) flash at each model's layer 0 (deepseek's MLA pair,
   grok's soft-capped GQA) and rmsnorm at d 7168, 1536 and 512 (MLA's q
   and kv norms, the kv one a strided view) and 6144, against the plain
   versions, timed cold beside SDPA (whose kernels are named; grok's
   soft-cap has no SDPA counterpart, so its SDPA time without the cap is
   a detail, not the library time) and ``F.rms_norm``; (c) both full
   sizes (671.71 B and 316.49 B by ``count_params``) on the meta
   device, the leaves' total equal to ``count_params`` plus the leaves
   it does not count, and both smoke models (float32) served on the
   card, tokens equal to the CPU's; (d) ``build_moe_dispatch_program``
   over 4 stacked ranks at deepseek's prefill widths (256 experts,
   capacity 80, d 7168, bf16) through ``FusedEngine``, equal to the
   plain tiled all-to-all bit for bit and giving its input back when run
   again; (e) continuous serving of each cut on the weights (a) served,
   as phase 17 does it (4 slots, 512-token prompts, 32 tokens, chunk 8:
   the scripted sequence, each admission one graph launch equal to the
   eager one bit for bit, then a 16-request burst; the admission graph's
   flash launches all on the tensor-core route); an admission prefills
   the whole batch at that call's expert capacity, so a slot's tokens
   depend on its batch-mates, as in the reference: the tokens are not
   held to serial serving, nor the in-flight slots to a decode round
   without the admission (the line says why);
21. training gemma3-1b at full width and depth (26 layers, d_model 1152,
   4 query heads and 1 kv head of 256, the window of 512 on 22 layers, 4
   global, qk-norms, d_ff 6912, tied vocab 262 144; bf16 compute over
   float32 parameters from ``torch.Generator(seed)``), 4 x 1024 tokens a
   step (``DENSE_TRAIN``; the cut from ``train_4k`` printed as a
   ``train_cut`` line): (b) 3 eager steps, every gradient leaf of the
   first finite and not all zero, the losses finite, the kernels'
   launches in one eager step (counters set to 0 just before it): flash
   forward 52 times on the tensor-core route (forward and the
   checkpoint's recompute), its backward 26 times on the tensor-core
   route, each RMSNorm (the
   qk-norms included) forward twice and backward once; the same 3 steps
   as ONE graph launch equal to the eager ones bit for bit (deterministic
   algorithms off); ms a step both ways, tokens/s, dispatches, peak memory;
   an eager step split into forward, recompute, backward and AdamW (CUDA
   events, the recompute as a no-grad run of the layer stack) with its
   kernels, the flash backward's share named (``torch.profiler``); (a)
   flash's backward against ``ref.attention_vjp`` at each of
   ``FLASH_BWD_CASES`` within phase 18's ``GRAD_RTOL``/``GRAD_FRAC`` (one
   bf16 rounding more for bf16 outputs), each one counted launch of the
   route ``route()`` gives, two calls equal bit for bit, rows that see no
   key zero; timed at gemma3's global and local layers, grok's
   soft-capped GQA and MLA's pair beside its bound, the CUDA-core
   backward on the same input, the plain VJP and autograd of SDPA (the backward as
   forward and backward less forward, each timed as the kernels are, in
   captured graphs; its kernels named); the RMSNorm backward at the
   step's shapes (the pre- and post-norms' 4096 x 1152, the q- and
   k-norms' 16384 x 256 and 4096 x 256; eps 1e-6, weight offset 1)
   against ``ref.rmsnorm_vjp``, two runs and a graph replay equal to
   eager bit for bit, timed as in phase 18.
22. training the MoE family at full width with bf16 parameters from
   ``torch.Generator(seed)``, 4 x 512 tokens a step (``MOE_TRAIN``; the
   cuts from ``train_4k`` printed as ``train_cut`` lines): (a)
   grok-1-314b cut to 1 layer (6.53 B parameters; bf16 AdamW moments):
   3 eager steps, every gradient leaf
   of the first finite and nonzero, the losses finite, an eager step's
   launches (counters set to 0 just before it): flash forward twice
   (forward and recompute) and its backward once on the tensor-core
   route, the RMSNorm forward and backward counted; the eager state is
   kept as each leaf's 128-bit fingerprint made on the card (two copies
   do not fit; ``fingerprints``), then the same 3 steps as ONE graph
   launch equal to the eager ones (parameters and moments by their
   fingerprints, losses bit for bit); ms a step both ways, tokens/s, dispatches, peak memory; a
   profiled eager step (forward, backward with the recompute, AdamW;
   kernels by family); (b)
   deepseek-v3-671b cut to 1 dense and 1 MoE layer (14.63 B; its AdamW
   moments do not fit, so the gradient step only, ``bundle.grad_fn``):
   the same leaf checks (the router's bias zero, as from ``jax.grad``),
   flash at (192, 128) in the 2 layers and the MTP block, the eager
   gradients' fingerprints, then ONE graph launch of ``grad_fn`` equal to
   them (gradients by their fingerprints, metrics bit for bit); (c) for each, its MoE layer alone at the step's
   shape [2048, D]: forward and backward twice with deterministic
   algorithms off, equal bit for bit (output, dx, router and experts);
   the dispatch's and the combine's backwards equal to a plain version
   (gathers, then an explicit loop in ascending expert order) bit for
   bit; route, dispatch, experts and combine and each backward timed by
   CUDA events; (d) the flash backward at grok's (B 4, 48/8 heads, S
   512, soft-cap) and MLA's (B 4, 128 heads, (192, 128)) training
   shapes and the RMSNorm backward at d 6144, 7168, 1536 and 512
   against their plain VJPs, timed as phase 21 times them.
23. the sharding layer (``repro_torch.parallel``, ``launch/steps.py``'s
   bundles, ``models/moe.py`` ``apply_moe_ep``, ``launch/dryrun.py``):
   (a) gemma3-1b's prefill bundle (4 x 1024) and decode bundle (4 slots,
   caches of 1024 + 32) at a 1x1 mesh on the card, each equal to
   ``Model.prefill`` / ``Model.decode_step`` run eagerly bit for bit
   (logits and caches), their flash and RMSNorm launches counted; (b)
   phase 20's MoE cuts (the same weights, trunk scale and prompts)
   through the prefill bundle at 1x1, whose sharding context sends every
   MoE layer through the expert-parallel path: logits equal to the
   gather path's bit for bit, tokens equal to phase 20's first served
   tokens, the first MoE layer's drops reported; (c) grok-1's MoE layer
   at full width in float32 (capacity factor 8, no drops) through
   ``apply_moe_ep`` at a 2x2 mesh held on the card against the gather
   path, output and gradients (input, router, experts) within 2e-4, the
   reference's own EP-versus-gather bound; (d) the dry run of ten archs x
   four shapes x both production meshes on the meta device, run in a CPU
   process of its own started before phase 1 (``CUDA_VISIBLE_DEVICES``
   empty): 80 records, each ``ok`` or skipped with the reference's
   reason, no error; counts, the largest per-device argument GB, the
   step TFLOP of each shape and its seconds.
24. training hymba-1.5b at full width and depth (32 hybrid layers,
   d_model 1600, 25/5 attention heads of 64, 50 SSD heads of 64 at state
   16, 128 meta tokens; bf16 compute over 1.59 B float32 parameters from
   ``torch.Generator(seed)``), 4 x 512 tokens a step (640 rows a layer;
   ``HYMBA_TRAIN``, the cut printed as a ``train_cut`` line), as phase 21
   trains gemma3-1b: (b) every gradient leaf of the first eager step
   finite and not all zero, an eager step's launches (counters set to 0
   just before it): the SSD forward 64 times (forward and recompute) and
   its backward 32 times, all on the N-16 tensor-core routes, none on the
   CUDA-core ones, flash 64 and 32 on the tensor-core route, the norms
   257 and 129; 3 eager steps equal to ONE graph launch of them bit for
   bit (deterministic algorithms off); ms a step both ways, tokens/s,
   dispatches, peak memory; (c) a profiled eager step (forward, backward
   with the recompute, AdamW; the SSD, flash and norm kernels' sums); (a)
   the N-16 SSD backward against ``ref.ssd_scan_vjp`` at the step's shape
   (dy only, and with init_state and dh), two runs equal, the CUDA-core
   backward held and timed on the same inputs, a short last chunk and two
   groups of chunks at smaller H; the flash backward at hymba's GQA group
   of 5 (B 4, 25/5 heads, S 640, D 64, window 1024) and the RMSNorm
   backward at 2560 x 1600 and 2560 x 3200 (the gated norm) against their
   plain VJPs, timed as phase 21 times them.
25. training qwen1.5-0.5b (24 layers, 16/16 heads of 64, a tied vocab of
   151 936; 0.46 B parameters) and whisper-large-v3 (32 encoder and 32
   decoder layers, 20/20 heads of 64, 1500 audio frames a sample, a tied
   vocab of 51 866; 1.54 B) at full width and depth, and glm4-9b at full
   width (d 4096, 32/2 heads of 128, d_ff 13 696, half the head rotary, an
   untied vocab of 151 552) cut in depth only (``FAMILY_TRAIN``), bf16
   compute over float32 parameters from ``torch.Generator(seed)`` and
   float32 AdamW moments, 4 x 1024 tokens a step (whisper 4 x 448, its
   decoder's length), each cut printed as a ``train_cut`` line, with
   deterministic algorithms off throughout: (b) for each model every
   gradient leaf of the first eager step finite and not all zero, the
   losses finite, an eager step's launches (counters set to 0 just before
   it): every attention's flash forward twice (forward and recompute) and
   backward once on the tensor-core route, every norm forward twice and
   backward once but the final ones, the embedding backward once; 3 eager
   steps equal to ONE graph launch of them (parameters and moments by
   their on-card fingerprints, metrics bit for bit); a second eager run of
   2 steps from the same seed equal to the first's (fingerprints); ms a
   step both ways, tokens/s, dispatches, peak memory and the memory left
   at the eager peak, a profiled eager step (forward, backward with the
   recompute, AdamW; flash, norm and embedding kernels' sums); (a) the
   embedding backward (``kernels/embedding.py``: a stable sort, then each
   id's rows added in token order) against its plain version bit for bit,
   two calls equal, at each model's step shape on its ids, and at qwen's
   shape on 4096 ids drawn from 16 values and on 4096 copies of one id;
   timed beside the sort alone, the plain version, its bound (dy and ids
   read, every row of the V x D result written) and autograd of
   ``index_select`` (forward and backward less forward, in captured
   graphs; its entries that differ from the kernel's counted); (b) the
   flash backward at glm4's layer (B 4, 32/2 heads, S 1024, D 128),
   whisper's encoder (B 4, 20/20, 1500 x 1500, not causal) and qwen's
   layer (B 4, 16/16, S 1024, D 64) against ``ref.attention_vjp``, and the
   RMSNorm backward at 4096 x 4096 (glm4's eps 1.5625e-7) and 6000 x 1280
   against their plain VJPs, timed as phase 21 times them.

Each phase's seconds are printed as it ends (``phase_seconds`` lines),
and all of them with the total before the kernels line.

The last lines are a ``{"kernels": [...]}`` JSON line (seventeen rows:
the nine Pallas kernels', the N-16 SSD route's (``ssd_scan_n16``: phase
19's hymba prefill shape, ``cuda_core_ms`` the CUDA-core kernel on the
same inputs, ``phase24_launches``), the two step kernels' and the five
backward kernels' (the N-16 SSD backward's, ``ssd_scan_bwd_n16``, at
phase 24's shape; the embedding backward's, ``embedding_bwd``, at qwen's
step shape, its other cases in ``other_shapes``), which have no Pallas
counterpart (``"pallas_counterpart": false``); the
flash and SSD rows also give ``earlier_ms``: the CUDA-core kernel, the
port's kernel before the tensor-core one, on the same input in this
run, and the SSD row its ``kernel_route``; the SSD backward row its
``kernel_route`` and ``cuda_core_ms`` (the CUDA-core backward on the same
input); the RMSNorm backward row its ``training_shapes`` (each shape's
ms, row pass, dw pass, plain, library and bound; phase 18's and, named
``gemma3_``, phase 21's); the rmsnorm row gives
``decode``: its times at the decode shapes; the flash and rmsnorm rows
``served_shapes``: their times at phase 17's served layer 0 and phases
19's and 20's served shapes (the SSD row's: hymba's), and those
three rows ``phase17_launches`` and ``phase19_launches``, the flash and
rmsnorm rows ``phase20_launches``, they and the RMSNorm backward's row
``phase21_launches``, they and both attention and norm backward rows
``phase22_launches`` (phase 22's ``training_shapes`` named ``moe_``, its
flash backward shapes in ``other_shapes``), the flash and rmsnorm rows
``phase23_launches``, they and the flash and RMSNorm backward rows
``phase24_launches`` and ``phase25_launches`` (phase 25's norm shapes
named ``phase25_``, its flash shapes in ``other_shapes``); the flash
backward's row its ``kernel_route``,
``earlier_ms`` (the CUDA-core backward on the same input), its
``local_layer`` times, ``other_shapes`` (grok's and MLA's) and SDPA's
``sdpa_kernels``; the schedule step's row
``one_program_ms``: its loop with one program), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
N_ITERS = 10


REPLACES = {
    "halo_pack": "src/repro/kernels/halo_pack.py:67",
    "halo_unpack_add": "src/repro/kernels/halo_pack.py:84",
    "pack_boundary": "src/repro/kernels/halo_pack.py:112",
    "unpack_boundary_add": "src/repro/kernels/halo_pack.py:134",
    "pack_segments": "src/repro/kernels/halo_pack.py:163",
    "unpack_segments": "src/repro/kernels/halo_pack.py:202",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:28",
    "flash_attention": "src/repro/kernels/flash_attention.py:96",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:80",
    # the same Pallas kernel at hymba's state width, on its own route
    "ssd_scan_n16": "src/repro/kernels/ssd_scan.py:80",
    # no Pallas counterpart: the lax.while_loop of _run_persistent_while
    "graph_loop_step": "src/repro/core/engine_persistent.py:495",
    # nor here: the lax.while_loop of _run_schedule_while and its jnp.where masks
    "schedule_step": "src/repro/core/engine_persistent.py:599",
    # the backward kernels: the reference differentiates its plain versions,
    # the SSD scan through a custom_vjp, the model's norm by XLA's autodiff
    "ssd_scan_bwd": "src/repro/models/ssm.py:46-49",
    "ssd_scan_bwd_n16": "src/repro/models/ssm.py:46-49",
    "rmsnorm_bwd": "src/repro/models/nn.py:78",
    # and attention's backward: XLA differentiates the plain _sdpa
    "flash_attention_bwd": "src/repro/models/nn.py:258",
    # and the embedding's: the VJP of jnp.take, a scatter-add in token order
    "embedding_bwd": "src/repro/models/nn.py:94-98",
}
FACES_KERNELS = ("halo_pack", "halo_unpack_add", "pack_segments", "unpack_segments")
# one region of each class the Faces loop unpacks, by its DIRECTIONS entry
UNPACK_CLASSES = {"face_x": (1, 0, 0), "face_y": (0, 1, 0), "face_z": (0, 0, 1),
                  "edge_along_x": (0, 1, 1), "edge_along_y": (1, 0, 1),
                  "edge_along_z": (1, 1, 0), "corner": (1, 1, 1)}
SERVE = dict(batch=4, prompt_len=512, gen_len=32)          # mamba2-2.7b
DENSE_SERVE = dict(batch=4, prompt_len=1024, gen_len=32)   # gemma3-1b
CONV_TOLS = (1e-1, 1e-2, 1e-3)     # the reference's faces_convergence rows
CONV_MAX_ITERS = 64
BOUND_ITERS = 20                   # the loop's own cost: tol 0 runs to the bound
STEP_ITERS = 4096                  # iterations of the step kernel's timing loop
PARTS = (2, 4)                     # x-parts of the composed runs (phase 12)
# (tol, max_iters) of the step kernel's known-trace checks: n_done 14 and 17
# by the tolerance, 16, 7 and 1 by the bound, 1 by a first value below tol
STEP_CASES = ((0.6, 32), (0.5, 32), (-1.0, 16), (-1.0, 7), (-1.0, 1), (2.0, 16))
MASK_MAX_ITERS = 20                # phase 14: the bound of cases (a) to (c)
MASK_EQUAL_TOL = 1e-2              # case (a): every part
MASK_TOLS = {2: (1e-1, 1e-3), 4: (1e-1, 1e-2, 1e-2, 1e-3)}   # cases (b) and (c)
MASK_COUNTS = (3, 7)               # case (d): 2 linked parts, no reductions
MASK_FIXED = N_ITERS               # case (e): every count, reductions only
# (tols, counts, max_iters) of the schedule step's known-trace checks: programs
# stopping by a tolerance, by their count, without a predicate, at the first
# pass, and both parities of the last pass
SCHED_STEP_CASES = (((0.6, None, 0.1), (16, 4, 9), 16), ((2.0, 0.45), (5, 16), 16),
                    ((None,), (7,), 7), ((-1.0, -1.0), (1, 2), 2))
SCHED_STEP_PROGRAMS = 4            # programs of the step's timing loop
# phase 15: the tuner's spaces (the reference's default for the pipeline;
# benchmarks/overlap_bench.py's for the TP chain)
TUNE_SPACE = {"interleave": ["round_robin", "sequential", 2], "mode": ["dataflow", "stream"]}
TP_SPACE = {"mode": ["stream", "dataflow"], "coalesce": [True, False],
            "double_buffer": [None, False]}
# phase 16: gemma3-1b's MLP (configs/gemma3_1b.py: d_model 1152, d_ff 6912) over
# the serve phase's 4 slots x 1024 tokens, on a one-axis mesh of 4 ranks
MLP = (4096, 1152, 6912)
COLL_RANKS = 4
TP_LAYERS = 26                     # gemma3-1b's depth
COLL_TOL = 1e-5                    # card against CPU: the repo's engine-vs-engine bound
# phase 17: continuous serving (4 slots, 512-token prompts, 32 tokens a request,
# a decode chunk of 8 between admissions; 16 requests a serve_continuous run)
CONT = dict(slots=4, prompt_len=512, max_new=32, chunk=8)
CONT_REQUESTS = 16
GLM_SERVE = dict(batch=4, prompt_len=512, gen_len=32)      # glm4-9b, as phase 9
#: phase 18: 2048 tokens a step, at the served SSD shapes (S 512, chunk 128)
TRAIN = dict(batch=4, seq=512, steps=3)
TRAIN_CUT = ("train_4k is 256 x 4096 tokens a step across a TPU pod; one H100 trains "
             "4 x 512 = 2048 tokens a step, whose scan has the served SSD shapes, at "
             "full width and depth")
#: the backward kernels against their plain VJPs: float32 reassociation over
#: up to S x H/G terms (rtol, and a share of the leaf's largest magnitude),
#: and one bf16 rounding of a bf16 output on top
GRAD_RTOL, GRAD_FRAC = 2e-4, 2e-5
#: phase 19: hymba-1.5b (128 meta tokens before each prompt) and
#: whisper-large-v3 (1500 audio frames a slot) at full width and depth
HYMBA_SERVE = dict(batch=4, prompt_len=512, gen_len=32)
WHISPER_SERVE = dict(batch=4, prompt_len=64, gen_len=32)
FAMILY_CHUNK = 8                   # the continuous decode chunk
#: whisper's encoder and decoder matrices (``w*`` leaves) are scaled by
#: this, as ``tests/test_torch_families.py`` scales them: at the init scale
#: its sinusoids swamp the 0.02 token embeddings and every slot emits the
#: same tokens, so a slot mix-up would not show
TRUNK_SCALE = {"whisper-large-v3": 8.0}
#: phase 21: gemma3-1b at full width and depth, 4 x 1024 tokens a step
DENSE_TRAIN = dict(batch=4, seq=1024, steps=3)
DENSE_TRAIN_CUT = ("train_4k is 256 x 4096 tokens a step across a TPU pod; one H100 trains "
                   "gemma3-1b at full width and depth on 4 x 1024 = 4096 tokens a step, the "
                   "served prefill's shape: the window of 512 binds on the 22 local layers, "
                   "the 4 global ones (5, 11, 17, 23) see all 1024 tokens")
#: phase 24: hymba-1.5b trained at full width and depth
HYMBA_TRAIN = dict(batch=4, seq=512, steps=3)
HYMBA_TRAIN_CUT = ("train_4k is 256 x 4096 tokens a step across a TPU pod; one H100 trains "
                   "hymba-1.5b at full width and depth on 4 x 512 tokens a step (640 rows "
                   "a layer with the 128 meta tokens, so the window of 1024 does not bind): "
                   "float32 parameters and AdamW moments, 1.6 B parameters, ~26 GB of state")
#: the SSD backward's shape in that step: (B, S, H, G, N) at P 64
HYMBA_SSD_TRAIN = (4, 640, 50, 1, 16)
#: the flash backward against ref.attention_vjp: (name, dtype, B, Hq, Hkv, Sq,
#: Skv, D, Dv, keywords): gemma3's global and local layers, grok's soft-capped
#: GQA (48/8, its output multiplier as the scale) at a shorter S, MLA's pair,
#: whisper's cross attention (not causal, Sq != Skv), a chunk at a depth, a
#: float32 case, rows that see no key (a negative q_offset); phase 25's
#: training shapes: glm4-9b's GQA group of 16 (the dK/dV kernel's cluster of
#: 8, 2 heads a CTA), whisper's encoder (not causal, 1500 x 1500) and
#: qwen1.5-0.5b's layer
FLASH_BWD_CASES = (
    ("gemma3_global", "bf16", 4, 4, 1, 1024, 1024, 256, 256, {}),
    ("gemma3_local", "bf16", 4, 4, 1, 1024, 1024, 256, 256, {"window": 512}),
    ("grok_softcap_gqa", "bf16", 1, 48, 8, 256, 256, 128, 128,
     {"logit_softcap": 30.0, "scale": 0.08838834764831845}),
    ("mla_192_128", "bf16", 1, 16, 16, 512, 512, 192, 128, {"scale": 192 ** -0.5}),
    ("whisper_cross", "bf16", 2, 20, 20, 64, 1500, 64, 64, {"causal": False}),
    ("q_offset", "bf16", 2, 4, 1, 256, 768, 256, 256, {"q_offset": 512, "window": 512}),
    ("float32", "f32", 1, 4, 1, 512, 512, 256, 256, {"window": 128}),
    ("rows_without_keys", "bf16", 1, 8, 2, 200, 200, 128, 128,
     {"q_offset": -40, "window": 100}),
    ("glm4_gqa16", "bf16", 4, 32, 2, 1024, 1024, 128, 128, {}),
    ("whisper_encoder", "bf16", 4, 20, 20, 1500, 1500, 64, 64, {"causal": False}),
    ("qwen_mha", "bf16", 4, 16, 16, 1024, 1024, 64, 64, {}),
)
#: the cases phase 25 checks and times (phase 21 checks the others)
PHASE25_FLASH_BWD = ("glm4_gqa16", "whisper_encoder", "qwen_mha")
#: the cases the flash backward's row times (the first is the row's own)
FLASH_BWD_TIMED = ("gemma3_global", "gemma3_local", "grok_softcap_gqa", "mla_192_128")
#: phase 20: the MoE family uncut in width with bf16 parameters, 4 slots,
#: 512-token prompts, 32 tokens; deepseek-v3 cut to 3 layers (1 dense, then 2
#: of 256 routed experts: 26.14 B parameters, 52.3 GB) and grok-1 to 2 (11.45
#: B, 22.9 GB), so that each fits the card's 80 GB with its graphs' pools
MOE_SERVE = dict(batch=4, prompt_len=512, gen_len=32)
MOE_CUTS = {"deepseek-v3-671b": dict(n_layers=3, first_k_dense=1),
            "grok-1-314b": dict(n_layers=2)}
#: their trunks' matrices (``w*`` leaves) are scaled as whisper's are: at the
#: init scale every slot echoes its last prompt token, whatever attention
#: and the experts give, so resident == host-stepped would hold vacuously
MOE_TRUNK_SCALE = 8.0
#: phase 22: the MoE family trained uncut in width with bf16 parameters, 4 x
#: 512 tokens a step; depth cut to fit the card: grok-1 to 1 layer (6.53 B;
#: parameters, bf16 gradients and bf16 AdamW moments 52.2 GB), deepseek-v3 to
#: 1 dense and 1 MoE layer (14.63 B; parameters and gradients 58.5 GB, its
#: moments 58.5 GB more: the gradient step only)
MOE_TRAIN = dict(batch=4, seq=512, steps=3)
MOE_TRAIN_CUTS = {"grok-1-314b": dict(n_layers=1),
                  "deepseek-v3-671b": dict(n_layers=2, first_k_dense=1)}
MOE_TRAIN_CUT = ("train_4k is 256 x 4096 tokens a step across a TPU pod; one H100 trains "
                 "4 x 512 = 2048 tokens a step at full width in bf16, depth cut to fit "
                 "80 GB: grok-1 to 1 layer with bf16 AdamW moments (52.2 GB of state), "
                 "deepseek-v3 to 1 dense + 1 MoE layer, its gradient step only (parameters "
                 "and gradients 58.5 GB; its AdamW moments would need 58.5 GB more)")
#: phase 25: qwen1.5-0.5b, glm4-9b and whisper-large-v3 trained at full width,
#: bf16 compute over float32 parameters and AdamW moments, 3 steps; glm4-9b cut
#: in depth only, to the most layers that leave 10 GB of the card free at the
#: eager peak: 8 layers peaked at 51.8 GB and each adds 204 M parameters
#: (3.3 GB of state), so 14 (4.10 B parameters) peak near 72 GB
FAMILY_TRAIN = {"qwen1.5-0.5b": dict(batch=4, seq=1024, cut={}),
                "glm4-9b": dict(batch=4, seq=1024, cut=dict(n_layers=14)),
                "whisper-large-v3": dict(batch=4, seq=448, cut={})}
FAMILY_TRAIN_STEPS = 3
FAMILY_TRAIN_CUT = ("train_4k is 256 x 4096 tokens a step across a TPU pod; one H100 trains "
                    "at full width on 4 x 1024 tokens a step (whisper-large-v3: 4 x 448, its "
                    "decoder's length, beside 4 x 1500 audio frames), float32 parameters and "
                    "AdamW moments: qwen1.5-0.5b and whisper-large-v3 at full depth, glm4-9b "
                    "cut in depth only (its 40 layers would need ~150 GB of state)")
#: the embedding backward's extra inputs at qwen's step shape (4096 ids, D
#: 1024, vocab 151 936): ids drawn from 16 values, and 4096 copies of one id
EMB_SKEWED = (("ids_16_values", 16), ("one_id", 1))
#: gradient leaves that jax.grad leaves at zero too: the sigmoid router's
#: balancing bias, which the loss reaches only through top-k's indices
ZERO_GRAD_LEAVES = ("router_bias",)
#: phase 23: gemma3-1b's prefill bundle (4 x 1024) and decode bundle (4 slots,
#: caches of 1024 + 32) at a 1x1 mesh; grok-1's MoE layer at full width in
#: float32 on 2 x 256 tokens through the expert-parallel path at a 2x2 mesh
#: against the gather path, at ample capacity, within the reference's own
#: EP-versus-gather bound (tests/test_distributed.py:198-226)
BUNDLE_SHAPE = dict(batch=4, seq=1024, gen=32)
EP_MESH = (2, 2)
EP_TOKENS = (2, 256)
EP_CAPACITY_FACTOR = 8.0
EP_TOL = 2e-4
#: the dry run: ten archs x four shapes x both production meshes on the meta
#: device, in a CPU process of its own that runs beside the card's phases
DRY_RUN_RECORDS = 80
DRY_RUN_CODE = """
import json, time
t0 = time.perf_counter()
from repro_torch.launch import dryrun
recs = dryrun.run_all(save=False, log=lambda m: None)
keys = ("arch", "shape", "mesh", "status", "reason", "error", "rules",
        "argument_bytes_per_device", "step_dot_flops", "trace_s")
print(json.dumps({"seconds": time.perf_counter() - t0, "skips": {
    f"{a}|{s}": r for (a, s), r in dryrun.SKIPS.items()},
    "records": [{k: r.get(k) for k in keys} for r in recs]}))
"""
#: the expert-parallel dispatch at deepseek-v3's prefill widths: 4 ranks of
#: 256 experts x capacity 80 (2048 tokens, top-8, factor 1.25) x d 7168
MOE_DISPATCH = dict(ranks=4, experts=256, capacity=80, d_model=7168)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


#: the H100's L2 cache
L2_BYTES = 50 * 2 ** 20


def cold_calls(torch, fn, *args):
    """``fn(*args)`` as a call of no arguments that cycles over copies of
    ``args`` (``args`` first) whose bytes together exceed twice the L2, so
    that under :func:`median_ms` each call reads its inputs from HBM, not
    from the L2 the calls before left them in."""
    n_bytes = sum(a.numel() * a.element_size() for a in args)
    sets = [args] + [tuple(a.clone() for a in args)
                     for _ in range(-(-2 * L2_BYTES // n_bytes))]
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def median_ms(torch, fn, reps: int = 15, inner: int = 20) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured into one
    CUDA graph (as the engines run them, without the host's per-call
    overhead), replayed ``reps`` times between CUDA events; the median
    window over ``inner``.  Repeated calls find their data in L2."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        windows.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / inner for a, b in windows)


def profile_iterations(torch, engine, mem, calls: int = 5) -> dict:
    """Kernel time by name over ``calls`` chained calls of a donating
    engine (no copy-in, as in a running loop)."""
    state = {"mem": engine(mem)}

    def step():
        state["mem"] = engine(state["mem"])

    return profile_calls(torch, step, calls)


def profile_calls(torch, fn, calls: int = 1) -> dict:
    """Kernel time by name over ``calls`` calls of ``fn`` after one
    warm-up (``torch.profiler``), the window's wall time and the
    device's idle share within it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    # device time of the kernels each PyTorch op launched itself
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages() if e.self_device_time_total > 0
                  and e.device_type == torch.autograd.DeviceType.CPU), key=lambda o: -o[1])
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms) if kernels else None,
            "top": [{"kernel": k[:90], "ms": t, "count": c}
                    for k, t, c in kernels[:12]],
            "ops": [{"op": k, "ms": t, "count": c} for k, t, c in ops[:16]]}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run_engines(torch, cfg, mesh, u0):
    """Phase 2: the main path through every engine; returns the fields
    after 10 iterations, the field after one host iteration, dispatch
    counts and median ms per iteration."""
    from repro_torch.core import (FusedEngine, HostEngine, PersistentEngine,
                                  build_faces_program)

    prog = build_faces_program(cfg, mesh)
    fields, dispatches, ms = {}, {}, {}

    host = HostEngine(prog)
    mem = host.init_buffers({"u": u0})
    times = []
    for i in range(N_ITERS):
        t0 = time.perf_counter()
        mem = host(mem)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = mem["u"].clone()
    fields["host"], dispatches["host"], ms["host"] = mem["u"], host.stats.dispatches, statistics.median(times)

    for mode in ("stream", "dataflow"):
        fused = FusedEngine(prog, mode=mode, donate=True)
        fused.compile()
        mem = fused.init_buffers({"u": u0})
        events = []
        for _ in range(N_ITERS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            mem = fused(mem)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        key = f"fused_{mode}"
        fields[key] = mem["u"].clone()
        dispatches[key] = fused.stats.dispatches
        ms[key] = statistics.median(a.elapsed_time(b) for a, b in events)
        if mode == "stream":
            trace_engine = fused

        pers = PersistentEngine(prog.persistent(N_ITERS), mode=mode)
        pers.compile()
        init = pers.init_buffers({"u": u0})
        key = f"persistent_{mode}"
        fields[key] = pers(init)["u"]
        dispatches[key] = pers.stats.dispatches
        events = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            pers(init)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        ms[key] = statistics.median(a.elapsed_time(b) for a, b in events) / N_ITERS
    return prog, fields, first, dispatches, ms, trace_engine


def kernel_row(torch, name, source, err, fn, plain, library, n_bytes, n_ops, ops_rate,
               plain_reps=(15, 20)):
    """A row of the kernels line: times of the kernel, its plain version
    and the library call, and the bound from this run's bytes and
    operations (``ops_rate``: the peak of the operations' type)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": REPLACES[name], "max_abs_err": err,
        "ms": median_ms(torch, fn), "plain_ms": median_ms(torch, plain, *plain_reps),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None if library is None else median_ms(torch, library),
    }


def sector_bound_ms(torch, u, regions, passes, packed_bytes) -> float:
    """The least time for a kernel that moves ``regions`` of ``u`` in
    whole 32-byte sectors: the distinct sectors of ``u`` the regions
    touch, each moved ``passes`` times (read, or read and written), and
    ``packed_bytes`` of a contiguous packed buffer, over the memory
    rate.  A strided region touches a sector for each element (a z-face
    of 4-byte elements: 8 times its useful bytes)."""
    index = torch.arange(u.numel(), device=u.device).view(u.shape)
    addrs = torch.cat([index[(..., *r)].flatten() for r in regions])
    sectors = torch.unique((u.data_ptr() + addrs * u.element_size()) // 32).numel()
    return (passes * 32 * sectors + packed_bytes) / HBM_BYTES_PER_S * 1e3


def run_contiguous(torch, cfg, u0, first, last, hk):
    """Phase 4: the same iterations through one contiguous buffer per rank
    (``faces_step_contiguous``), counters set to 0 just before and read
    just after; the first and the last iteration must equal the host
    engine's bit for bit."""
    from repro_torch.core import faces_step_contiguous

    u = torch.from_numpy(u0).cuda()
    torch.cuda.synchronize()
    hk.reset_launches()
    events = []
    for i in range(N_ITERS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        u = faces_step_contiguous(u, cfg)
        b.record()
        events.append((a, b))
        if i == 0:
            one = u.clone()
    torch.cuda.synchronize()
    launches = hk.launch_counts()
    require(launches["pack_boundary"] == N_ITERS and launches["unpack_boundary_add"] == N_ITERS,
            f"the one-buffer path did not take the boundary kernels: {launches}")
    require(torch.equal(one, first), "one-buffer iteration 1 differs from the host engine's")
    require(torch.equal(u, last), f"one-buffer iteration {N_ITERS} differs from the host "
            "engine's")
    return {"iterations": N_ITERS,
            "median_ms_per_iter": statistics.median(a.elapsed_time(b) for a, b in events),
            "equal_to_host_engine": True, "launches": launches}


def check_kernels(torch, prog, u, hk, ref):
    """Phase 4: each kernel against its plain version at the main path's
    shapes (bit for bit), its timings, and its bound from this input."""
    import numpy as np

    from repro_torch.core.engine_fused import Lowering
    from repro_torch.core.halo import DIRECTIONS, _region_for

    points = tuple(u.shape[-3:])
    n_ranks = u.numel() // (points[0] * points[1] * points[2])
    itemsize = u.element_size()
    errs = dict.fromkeys(REPLACES, 0.0)

    def same(name, got, want, what):
        for g, w in zip(got, want):
            errs[name] = max(errs[name], float((g.float() - w.float()).abs().max()))
            require(torch.equal(g, w), f"{name} != plain on {what}")

    def row(name, fn, plain, library, n_bytes, n_ops=0):
        return kernel_row(torch, name, "halo_pack.cu", errs[name], fn, plain, library,
                          n_bytes, n_ops, FP32_OPS_PER_S)

    # halo_pack / halo_unpack_add: all 26 regions, bit for bit (the
    # unpack also on the field in bf16); timed on a face (the largest
    # region the path packs), the unpack also on one region of each class
    ub = u.bfloat16()
    for d in DIRECTIONS:
        region = _region_for(d, points)
        same("halo_pack", [hk.halo_pack(u, region)], [ref.halo_pack(u, region)],
             f"direction {d}")
        for field in (u, ub):
            msg = ref.halo_pack(torch.roll(field, 1, 0), region)
            same("halo_unpack_add", [hk.halo_unpack_add(field.clone(), msg, region)],
                 [ref.halo_unpack_add(field.clone(), msg, region)],
                 f"direction {d}, {field.dtype}")
    rows = []
    face = _region_for((1, 0, 0), points)
    slab = ref.halo_pack(u, face)
    view = u[(..., *face)]
    out = torch.empty_like(slab)
    rows.append(row("halo_pack", lambda: hk.halo_pack(u, face),
                    lambda: ref.halo_pack(u, face),
                    lambda: out.copy_(view), 2 * slab.numel() * itemsize))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, [face], 1, slab.numel() * itemsize)
    acc = u.clone()
    acc_view = acc[(..., *face)]
    rows.append(row("halo_unpack_add", lambda: hk.halo_unpack_add(acc, slab, face),
                    lambda: ref.halo_unpack_add(acc, slab, face),
                    lambda: acc_view.add_(slab), 3 * slab.numel() * itemsize,
                    n_ops=slab.numel()))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, [face], 2, slab.numel() * itemsize)
    by_class = {}
    for name, d in UNPACK_CLASSES.items():
        region = _region_for(d, points)
        msg = ref.halo_pack(u, region)
        part = acc[(..., *region)]
        by_class[name] = {
            "elements": msg.numel(),
            "ms": median_ms(torch, lambda: hk.halo_unpack_add(acc, msg, region)),
            "library_ms": median_ms(torch, lambda: part.add_(msg)),
            "bound_ms": 3 * msg.numel() * itemsize / HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": sector_bound_ms(torch, u, [region], 2,
                                               msg.numel() * itemsize)}
    print(json.dumps({"halo_unpack_add_by_class": by_class}), flush=True)
    by_class = {}
    for name, d in UNPACK_CLASSES.items():
        region = _region_for(d, points)
        slab_c = ref.halo_pack(u, region)
        part, out_c = u[(..., *region)], torch.empty_like(slab_c)
        by_class[name] = {
            "elements": slab_c.numel(),
            "ms": median_ms(torch, lambda: hk.halo_pack(u, region)),
            "library_ms": median_ms(torch, lambda: out_c.copy_(part)),
            "bound_ms": 2 * slab_c.numel() * itemsize / HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": sector_bound_ms(torch, u, [region], 1,
                                               slab_c.numel() * itemsize)}
    print(json.dumps({"halo_pack_by_class": by_class}), flush=True)

    # pack_boundary / unpack_boundary_add: each of the 8 rank blocks of the
    # field and a bf16 block, bit for bit (the received buffer: the packed
    # one reversed), and pack_boundary on the whole field in float32 and
    # bf16; timed on the whole field, all ranks in one launch, as the
    # one-buffer path calls them
    send = [_region_for(d, points) for d in DIRECTIONS]
    back = [_region_for(tuple(-x for x in d), points) for d in DIRECTIONS]
    blocks = [u[g] for g in np.ndindex(*u.shape[:-3])] + [u[(0,) * (u.dim() - 3)].bfloat16()]
    for i, blk in enumerate(blocks):
        buf = hk.pack_boundary(blk, send)
        same("pack_boundary", [buf], [ref.pack_boundary(blk, send)], f"block {i}")
        msg = torch.flip(buf, [-1])
        same("unpack_boundary_add", [hk.unpack_boundary_add(blk.clone(), msg, back)],
             [ref.unpack_boundary_add(blk.clone(), msg, back)], f"block {i}")
    for field in (u, ub):
        same("pack_boundary", [hk.pack_boundary(field, send)],
             [ref.pack_boundary(field, send)], f"the field in {field.dtype}")
    del ub
    sent = hk.pack_boundary(u, send)
    flats = [u[(..., *r)].flatten(-3) for r in send]
    shell = torch.zeros(points, dtype=torch.bool)
    for r in send:
        shell[r] = True
    total, union = sent.shape[-1], int(shell.sum())
    rows.append(row("pack_boundary", lambda: hk.pack_boundary(u, send),
                    lambda: ref.pack_boundary(u, send),
                    lambda: torch.cat(flats, dim=-1), 2 * n_ranks * total * itemsize))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, send, 1, sent.numel() * itemsize)
    acc = u.clone()
    # the library call: one index_add_ of the whole buffer at the blocks'
    # flat indices (built here, outside the timed window); it adds the
    # overlapping regions in another order at edges and corners, so it is
    # timed, not compared
    index = torch.arange(points[0] * points[1] * points[2], device=u.device).view(points)
    idx = torch.cat([index[r].flatten() for r in back])
    acc_rows, sent_rows = acc.view(n_ranks, -1), sent.view(n_ranks, -1)
    rows.append(row("unpack_boundary_add", lambda: hk.unpack_boundary_add(acc, sent, back),
                    lambda: ref.unpack_boundary_add(acc, sent, back),
                    lambda: acc_rows.index_add_(1, idx, sent_rows),
                    n_ranks * (total + 2 * union) * itemsize, n_ops=n_ranks * total))
    rows[-1]["sector_bound_ms"] = sector_bound_ms(torch, u, back, 2, sent.numel() * itemsize)
    rows[-1]["library_call"] = ("index_add_ at the regions' flat indices (adds in another "
                                "order where regions overlap: timed, not compared)")

    # pack_segments / unpack_segments: replay the coalescing plan of the
    # path's batch with both versions, transfer by transfer
    low = Lowering(prog)
    gen = torch.Generator(u.device).manual_seed(1)
    mem = {n: torch.randn(s.shape, dtype=s.dtype, device=u.device, generator=gen)
           for n, s in prog.buffers.items()}
    packs, unpacks = replay_plan(low, prog.batches[0], mem, hk, ref, same)

    # a relay-heavy bf16 member set at columns that break 16-byte
    # alignment (sizes 1, 3, 127, 16384; relays through strided views),
    # one launch, bit for bit
    recv = torch.randn(n_ranks, 2 * 16384 + 301, device=u.device, generator=gen).bfloat16()
    slab = torch.randn(n_ranks, 127, device=u.device, generator=gen).bfloat16()
    relays = [(recv, 1), (recv, 5), (recv[:, 3:], 17), (recv, 301), (slab, 0),
              (recv[:, 1:], 16601), (recv, 0)]
    relay_sizes = [1, 3, 127, 16384, 127, 16384, 3]
    before = hk.pack_segments.launches
    staged = hk.pack_segments(relays, relay_sizes)
    require(hk.pack_segments.launches == before + 1, "pack_segments: not one launch")
    same("pack_segments", [staged], [ref.pack_segments(relays, relay_sizes)],
         "the bf16 relay set")

    # timed: the first transfer (a face and its eight edge/corner
    # members) and the unpack with the most members
    sources, sizes = packs[0]
    pieces = [s[:, c:c + n] for (s, c), n in zip(sources, sizes)]
    rows.append(row("pack_segments", lambda: hk.pack_segments(sources, sizes),
                    lambda: ref.pack_segments(sources, sizes),
                    lambda: torch.cat(pieces, dim=1),
                    2 * n_ranks * sum(sizes) * itemsize))
    buf, outs, offs, masks = max(unpacks, key=lambda x: len(x[1]))
    written = sum((n_ranks if masks is None else int(masks[j].sum()))
                  * (o.numel() // n_ranks) for j, o in enumerate(outs))
    rows.append(row("unpack_segments", lambda: hk.unpack_segments(buf, outs, offs, masks),
                    lambda: ref.unpack_segments(buf, outs, offs, masks),
                    None, 2 * written * itemsize))
    return rows


def replay_plan(low, batch, mem, hk, ref, same, what: str = ""):
    """Replay one batch's coalescing plan transfer by transfer, as
    ``_run_coalesced_batch`` runs it, through ``pack_segments`` and
    ``unpack_segments`` and their plain versions, held equal by
    ``same(name, got, want, what)``.  Returns each pack's ``(sources,
    sizes)`` and each unpack's ``(received, outs, offsets, masks)``."""
    plan, consts, n = batch.plan, low.plans[batch.index], low.n_ranks
    received, packs, unpacks = [], [], []
    for ti, (t, route) in enumerate(zip(plan.transfers, consts.routes)):
        sources = []
        for seg in t.segments:
            if seg.hop == 0:
                ch = plan.channels[seg.channel]
                src = low.ranks(mem[ch.src_buf])
                if ch.send_region is not None:
                    src = src[low.local_region(ch.send_region)]
                sources.append((src.reshape(n, -1), 0))
            else:
                pt, po = plan.routes[seg.channel][seg.hop - 1]
                sources.append((received[pt], po))
        sizes = [seg.size for seg in t.segments]
        staged = hk.pack_segments(sources, sizes)
        same("pack_segments", [staged], [ref.pack_segments(sources, sizes)],
             f"{what}batch {batch.index}, transfer {ti}")
        received.append(low.permute(staged, route))
        packs.append((sources, sizes))
    for ti, (chans, offs, masks) in consts.direct.items():
        outs = [mem[plan.channels[ci].dst_buf] for ci in chans]
        got, want = [o.clone() for o in outs], [o.clone() for o in outs]
        hk.unpack_segments(received[ti], got, offs, masks)
        ref.unpack_segments(received[ti], want, offs, masks)
        same("unpack_segments", got, want, f"{what}batch {batch.index}, transfer {ti}")
        unpacks.append((received[ti], got, offs, masks))
    return packs, unpacks


def check_part_shapes(torch, cfg, mesh, hk, ref):
    """Phase 5, part shapes: the four Faces kernels against their plain
    versions, bit for bit, on the blocks of the 2- and 4-part splits (all
    26 regions, the unpack in float32 and bf16) and on every coalescing
    plan of the linked schedules (ghost-plane batches with their send
    regions, cross payloads), replayed transfer by transfer as
    ``_run_coalesced_batch`` runs them."""
    from repro_torch.core import build_faces_pipeline, part_configs
    from repro_torch.core.engine_fused import Lowering
    from repro_torch.core.halo import DIRECTIONS, _region_for

    def same(name, got, want, what):
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name} != plain: {what}")

    gen = torch.Generator("cuda").manual_seed(2)
    out = {}
    for n_parts in PARTS:
        points = part_configs(cfg, n_parts)[0].points
        u = torch.randn(*cfg.grid, *points, device="cuda", generator=gen)
        for d in DIRECTIONS:
            region = _region_for(d, points)
            require(torch.equal(hk.halo_pack(u, region), ref.halo_pack(u, region)),
                    f"halo_pack != plain at part points {points}, direction {d}")
            for field in (u, u.bfloat16()):
                msg = ref.halo_pack(torch.roll(field, 1, 0), region)
                require(torch.equal(hk.halo_unpack_add(field.clone(), msg, region),
                                    ref.halo_unpack_add(field.clone(), msg, region)),
                        f"halo_unpack_add != plain at {points}, {d}, {field.dtype}")
        sched = build_faces_pipeline(cfg, mesh, n_parts)
        low = Lowering(sched)
        mem = {name: torch.randn(spec.shape, device="cuda", generator=gen)
               for name, spec in sched.buffers.items()}
        transfers = unpacks = 0
        for b in sched.batches:
            if b.plan is not None:
                packs, done = replay_plan(low, b, mem, hk, ref, same, f"{n_parts} parts, ")
                transfers, unpacks = transfers + len(packs), unpacks + len(done)
        out[f"parts{n_parts}"] = {"points": points, "regions": len(DIRECTIONS),
                                  "transfers": transfers, "unpacks": unpacks,
                                  "equal_bitwise": True}
    return out


def graph_shape(torch, graph_loop, eng) -> dict:
    """One pass of ``eng`` captured again with its graph kept: node counts
    by type and the largest set of kernel nodes no edge path orders (one
    stream's work is a chain: width 1 a stream)."""
    eng.compile()
    graph, _ = graph_loop.capture(lambda: eng._run_into(eng._bufs))
    names, edges = graph_loop.graph_edges(graph)
    kernels = [i for i, t in enumerate(names) if t == "kernel"]
    return {"nodes": len(names), "kernel_nodes": len(kernels), "edges": len(edges),
            "width": graph_loop.dag_width(len(names), edges, kernels),
            "node_types": graph_loop.node_types(graph)}


def run_pipeline(torch, cfg, mesh, u0, card: str, hk, graph_loop):
    """Phase 12: the linked N-part pipeline at full width against the
    full-domain persistent run; returns the phase's line and every
    program it built (for phase 13)."""
    from repro_torch.core import (FusedEngine, HostEngine, PersistentEngine,
                                  build_faces_pipeline, build_faces_program, merge_parts,
                                  part_configs, part_names, run_faces_persistent,
                                  run_faces_pipelined, split_parts)

    def parts_init(n_parts):
        return dict(zip([f"{n}/u" for n in part_names(n_parts)], split_parts(u0, n_parts)))

    def merged(mem, n_parts):
        return merge_parts([mem[f"{n}/u"] for n in part_names(n_parts)])

    def counted(what, fn):
        # the counts of one composed run alone: set to 0 just before it, read
        # just after, and every Faces kernel must have launched in it
        torch.cuda.synchronize()
        hk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {n: hk.launch_counts()[n] for n in FACES_KERNELS}
        require(all(counts.values()), f"{what}: a kernel of the composed path never "
                f"launched: {counts}")
        return out, counts

    prog = build_faces_program(cfg, mesh)
    built, modes = [prog], {}
    launches = dict.fromkeys(FACES_KERNELS, 0)
    for mode in ("stream", "dataflow"):
        full = PersistentEngine(prog.persistent(N_ITERS), mode=mode, donate=True)
        full_init = full.init_buffers({"u": u0})
        full.compile()
        want = full(full_init)["u"].clone()
        row = {"full_ms_per_iter": events_ms(torch, lambda: full(full_init)) / N_ITERS,
               "full_graph": graph_shape(torch, graph_loop, FusedEngine(prog, mode=mode)),
               "full_profile": profile_calls(torch, lambda: full(full_init))}
        require(row["full_graph"]["width"] == (1 if mode == "stream" else 2),
                f"{mode}: the plain program's pass is {row['full_graph']['width']} wide")
        for n_parts in PARTS:
            what = f"{mode}, {n_parts} parts"
            t0 = time.perf_counter()
            (mem, stats), pipelined_counts = counted(what, lambda: run_faces_pipelined(
                cfg, mesh, u0, n_iters=N_ITERS, n_parts=n_parts, mode=mode))
            first_wall = (time.perf_counter() - t0) * 1e3
            require((stats.dispatches, stats.sync_points) == (1, 0),
                    f"{mode}, {n_parts} parts: run_faces_pipelined took {stats}")
            require(torch.equal(merged(mem, n_parts), want), f"{mode}, {n_parts} parts: "
                    "the linked pipeline differs from the full domain")
            del mem
            sched = build_faces_pipeline(cfg, mesh, n_parts, N_ITERS)
            built.append(sched)
            eng = PersistentEngine(sched, mode=mode, donate=True)
            init = eng.init_buffers(parts_init(n_parts))

            def engine_run():
                eng.compile()
                return merged(eng(init), n_parts)

            got, engine_counts = counted(what, engine_run)
            require(torch.equal(got, want),
                    f"{mode}, {n_parts} parts: the engine differs from the full domain")
            for n in FACES_KERNELS:
                launches[n] += pipelined_counts[n] + engine_counts[n]
            require(eng.stats.dispatches == eng.graph_launches == 1,
                    f"{mode}, {n_parts} parts: {eng.stats.dispatches} dispatches, "
                    f"{eng.graph_launches} graph launches")
            ms = events_ms(torch, lambda: eng(init)) / N_ITERS
            profile = profile_calls(torch, lambda: eng(init))
            one_pass = build_faces_pipeline(cfg, mesh, n_parts)
            built.append(one_pass)
            shape = graph_shape(torch, graph_loop, FusedEngine(one_pass, mode=mode))
            wide = (shape["width"] == n_parts if mode == "stream"
                    else n_parts < shape["width"] <= 2 * n_parts)
            require(wide, f"{mode}, {n_parts} parts: the pass is {shape['width']} wide")
            del eng, init, got
            unlinked, _ = run_faces_pipelined(cfg, mesh, u0, n_iters=N_ITERS, n_parts=n_parts,
                                              mode=mode, exchange=False)
            for name, pcfg, part in zip(part_names(n_parts), part_configs(cfg, n_parts),
                                        split_parts(u0, n_parts)):
                alone, _ = run_faces_persistent(pcfg, mesh, part, n_iters=N_ITERS, mode=mode)
                require(torch.equal(unlinked[f"{name}/u"], alone["u"]),
                        f"{mode}: unlinked part {name} differs from its own run")
            del unlinked, alone
            built.append(build_faces_pipeline(cfg, mesh, n_parts, N_ITERS, exchange=False))
            row[f"parts{n_parts}"] = {
                "ms_per_iter": ms, "vs_full": ms / row["full_ms_per_iter"],
                "first_call_wall_ms": first_wall, "dispatches": 1, "graph_launches": 1,
                "links": len(sched.links), "graph": shape, "profile": profile,
                "launches": {"run_faces_pipelined": pipelined_counts,
                             "PersistentEngine": engine_counts},
                "equal_to_full_bitwise": True,
                "unlinked_equal_to_parts_bitwise": True}
        modes[mode] = row
        del full, full_init, want
    one = build_faces_pipeline(cfg, mesh, 2)
    for cls, kw in ((HostEngine, {}), (FusedEngine, {"mode": "stream"}),
                    (FusedEngine, {"mode": "dataflow"})):
        split, whole = cls(one, **kw), cls(prog, **kw)
        got = merged(split(split.init_buffers(parts_init(2))), 2)
        require(torch.equal(got, whole(whole.init_buffers({"u": u0}))["u"]),
                f"{cls.__name__} {kw}: one pass of the 2-part schedule differs")
    return {"card": card, "grid": cfg.grid, "points": cfg.points, "iterations": N_ITERS,
            "modes": modes, "one_pass_host_and_fused_equal": True,
            "launches": launches}, built


def run_verifier(torch, cfg, mesh, u0, card: str, hk, built):
    """Phase 13: the verifier on every program built, the sanitizer's
    parity and cost, and the racy mutation refused before any launch."""
    from repro_torch.core import (FusedEngine, HostEngine, PersistentEngine, SanitizeError,
                                  build_faces_pipeline, part_names, split_parts,
                                  verify_program)
    from repro_torch.core.descriptors import KernelDesc, WaitDesc

    for p in built:
        diags = verify_program(p)
        require(diags == [], f"verify_program({p.name}): {[str(d) for d in diags[:3]]}")
    largest = max(built, key=lambda p: len(p.descriptors))
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify_program(largest)
        host_ms.append((time.perf_counter() - t0) * 1e3)

    prog = built[0]
    parts = dict(zip([f"{n}/u" for n in part_names(2)], split_parts(u0, 2)))
    cases = {"faces": (prog, prog.persistent(N_ITERS), {"u": u0}),
             "parts2": (build_faces_pipeline(cfg, mesh, 2),
                        build_faces_pipeline(cfg, mesh, 2, N_ITERS), parts)}
    sanitizer = {}
    for mode in ("stream", "dataflow"):
        for name, (one_pass, loop, init) in cases.items():
            for cls, p, per in ((FusedEngine, one_pass, 1), (PersistentEngine, loop, N_ITERS)):
                row = {}
                outs = []
                for sanitize in (False, True):
                    eng = cls(p, mode=mode, donate=True, sanitize=sanitize)
                    own = eng(eng.init_buffers(init))  # the engine's own buffers
                    outs.append({k: t.clone() for k, t in own.items()})
                    # calls on the engine's own buffers: no copy-in, the graph alone
                    row["sanitized_ms_per_iter" if sanitize else "ms_per_iter"] = \
                        events_ms(torch, lambda: eng(own)) / per
                    if cls is PersistentEngine and name == "faces" and mode == "stream":
                        row["sanitized_profile" if sanitize else "profile"] = \
                            profile_calls(torch, lambda: eng(own))
                    del eng, own
                require(all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0]),
                        f"{cls.__name__} {mode} {name}: sanitize=True changed the result")
                row["equal_bitwise"] = True
                sanitizer[f"{cls.__name__}/{name}/{mode}"] = row
                del outs

    descs = list(prog.descriptors)
    wi = max(i for i, d in enumerate(descs) if isinstance(d, WaitDesc))
    ki = next(i for i, d in enumerate(descs) if i > wi and isinstance(d, KernelDesc))
    descs.insert(wi, descs.pop(ki))
    bad = dataclasses.replace(prog, descriptors=tuple(descs))
    torch.cuda.synchronize()
    hk.reset_launches()
    refused = []
    for cls in (FusedEngine, PersistentEngine, HostEngine):
        try:
            cls(bad, sanitize=True)
        except SanitizeError as e:
            refused.append((cls.__name__, str(e)[:160]))
    launched = hk.launch_counts()
    require(len(refused) == 3, f"the racy program was accepted: refused only by {refused}")
    require(not any(launched.values()), f"a refused engine launched kernels: {launched}")
    silent = FusedEngine(bad)
    silent(silent.init_buffers({"u": u0}))
    torch.cuda.synchronize()
    require(silent.stats.dispatches == 1, "the unsanitized engine did not run the racy program")
    # the program registry on the benchmark grid's 8 ranks, on the card
    from repro_torch.analysis import certificates, lint_all
    lint = lint_all()
    require(all(not d for _, d in lint), "a registry program does not lint clean: "
            f"{[(n, [str(x) for x in d[:2]]) for n, d in lint if d]}")
    certs = certificates()
    require(all(c.race_free for _, c in certs),
            f"racy registry programs: {[n for n, c in certs if not c.race_free]}")
    return {"card": card, "verified": len(built), "diagnostics": 0,
            "registry": {"programs": len(lint), "clean": True, "race_free": True,
                         "digests": {n: c.digest for n, c in certs}},
            "largest": {"name": largest.name, "descriptors": len(largest.descriptors),
                        "verify_host_ms": statistics.median(host_ms)},
            "sanitizer": sanitizer,
            "race": {"refused": refused, "launches_when_refused": launched,
                     "unsanitized_dispatches": silent.stats.dispatches}}


def scale_trunks(params, factor: float) -> None:
    """The encoder's and decoder's matrices (``w*`` leaves) times
    ``factor``, in place."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, name)
        elif name.startswith("w"):
            tree.mul_(factor)

    for key in ("encoder", "decoder"):
        if key in params:
            walk(params[key])


def run_serve(torch, seed: int, arch: str, shape: dict, cfg=None, scale=None):
    """Serve ``arch`` at full size (or ``cfg``, a cut of it) in both decode
    modes (phases 6, 9, 19 and 20; ``TRUNK_SCALE``, or ``scale``, scales
    the trunk's weights).

    One serve per mode first captures the prefill and decode graphs
    (set-up, as a server does once); then each mode serves once more.
    Every kernel counter is set to 0 just before the set-up and read
    after the last serve (the launches of the main path: the graphs'
    eager warm-up passes and their captures), and read around each
    served run too, which replays graphs only and so launches no kernel
    eagerly.  Returns the runs as (tokens, stats, kernel launches, graph
    launches by dispatch kind), and the whole window's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch

    cfg = cfg or get_config(arch)
    eng = ServeEngine(cfg, slots=shape["batch"], prompt_len=shape["prompt_len"],
                      max_new=shape["gen_len"], chunk=shape["gen_len"] - 1)
    params = eng.model.init(seed)
    scale = scale or TRUNK_SCALE.get(arch)
    if scale:
        scale_trunks(params, scale)
    batch_in = synthetic_batch(cfg, np.random.RandomState(seed), shape["batch"],
                               shape["prompt_len"])
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    for resident in (True, False):
        serve(cfg, params=params, batch_in=batch_in, engine=eng,
              device_resident=resident, **shape)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runs = {}
    for resident in (True, False):
        torch.cuda.synchronize()
        counts, graphs = ops.launch_counts(), eng.graph_launches
        gen, stats = serve(cfg, params=params, batch_in=batch_in, engine=eng,
                           device_resident=resident, **shape)
        torch.cuda.synchronize()
        counts = {k: n - counts[k] for k, n in ops.launch_counts().items()}
        graphs = {k: n - graphs[k] for k, n in eng.graph_launches.items()}
        runs["resident" if resident else "host_stepped"] = (gen, stats, counts, graphs)
    return cfg, eng, params, batch_in, runs, setup_s, ops.launch_counts()


def reset_all_launches() -> None:
    from repro_torch.kernels import embedding, flash_attention, halo_pack, rmsnorm, ssd_scan

    for module in (flash_attention, halo_pack, rmsnorm, ssd_scan, embedding):
        module.reset_launches()


def serve_report(torch, cfg, eng, shape, runs, setup_s, launches) -> dict:
    """The serve line of phases 6 and 9; requires the dispatch counts,
    one prefill graph launch and no eager kernel launch per served run."""
    steps = shape["gen_len"] - 1
    line = {"model": cfg.name, **shape, "setup_s": setup_s, "launches": launches,
            "prefill_graph_holds": eng.captured_launches("prefill")}
    for mode, (gen, stats, counts, graphs) in runs.items():
        line[mode] = {
            "prefill_ms": stats["prefill_s"] * 1e3, "decode_ms": stats["decode_s"] * 1e3,
            "decode_ms_per_token": stats["decode_s"] * 1e3 / steps,
            "tok_per_s": stats["tok_per_s"], "decode_tokens": stats["decode_tokens"],
            "dispatches": stats["dispatches"],
            "decode_dispatches": stats["decode_dispatches"], "graph_launches": graphs,
            "eager_kernel_launches": sum(counts.values())}
    require((line["resident"]["dispatches"], line["resident"]["decode_dispatches"]) == (2, 1),
            f"resident dispatches {line['resident']}")
    require(line["host_stepped"]["decode_dispatches"] == steps,
            f"host-stepped dispatches {line['host_stepped']}")
    want = {"resident": {"prefill": 1, "decode": 1, "decode_one": 0, "admit_decode": 0},
            "host_stepped": {"prefill": 1, "decode": 0, "decode_one": steps,
                             "admit_decode": 0}}
    for mode, w in want.items():
        require(line[mode]["graph_launches"] == w,
                f"{mode}: graph launches {line[mode]['graph_launches']} != {w} (the "
                "prefill must be one graph launch after set-up)")
        require(line[mode]["eager_kernel_launches"] == 0,
                f"{mode}: a served run launched kernels eagerly: {runs[mode][2]}")
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return line


def check_serving(torch, eng, params, batch_in, runs, shape) -> dict:
    """Phases 7, 9 and 19: equal tokens in both modes; the graphed prefill
    equal to an eager ``Model.prefill`` (logits and caches) bit for bit;
    the last row of ``Model.hidden_states`` (the final norm's output that
    ``forward_logits`` unembeds), unembedded as the prefill unembeds (one
    row a slot), equal to the prefill's logits bit for bit.
    ``forward_logits`` itself must equal them bit for bit in bf16 with a
    vocabulary that is a multiple of 8 (phases 7, 9 and 17); elsewhere
    cuBLAS may pick the unembedding GEMM's algorithm by its row count
    (an N not 16 bytes aligned, or float32), and the difference is
    recorded.  Finite logits.  Returns the eager prefill's kernel
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.models.nn import apply_unembed, tree_leaves

    res, host = runs["resident"][0], runs["host_stepped"][0]
    require(res.shape == (shape["batch"], shape["gen_len"]), f"tokens of shape {res.shape}")
    require(bool((res == host).all()), "resident and host-stepped tokens differ")
    require(bool(((res >= 0) & (res < eng.cfg.vocab)).all()), "tokens out of the vocabulary")
    cast = eng.cast_params(params)
    graphed, graphed_caches = eng.prefill(params, batch_in, eng.init_state()[0])
    torch.cuda.synchronize()
    before = ops.launch_counts()
    pre, pre_caches = eng.model.prefill(cast, batch_in, eng.init_state()[0])
    torch.cuda.synchronize()
    eager = {k: n - before[k] for k, n in ops.launch_counts().items() if n > before[k]}
    full = eng.model.forward_logits(cast, batch_in)
    last = full[:, -1]
    h_last = eng.model.hidden_states(cast, batch_in)[:, -1:]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(pre).all()) and bool(torch.isfinite(full).all()),
            "non-finite logits")
    require(torch.equal(graphed, pre) and all(
        torch.equal(g, e) for g, e in zip(tree_leaves(graphed_caches), tree_leaves(pre_caches))),
        "the graphed prefill differs from the eager one")
    # With empty caches, prefill and forward_logits run the same kernels on
    # the same inputs: the last row's final hidden state, unembedded as the
    # prefill does, gives the prefill's logits bit for bit
    cfg = eng.cfg
    require(torch.equal(apply_unembed(cast["embed"], cast["unembed"], h_last, cfg)[:, 0],
                        pre),
            "forward_logits' last hidden state, unembedded as the prefill does, differs "
            "from the prefill's logits")
    logits_bitwise = torch.equal(pre, last)
    diff = float((pre.float() - last.float()).abs().max())
    if cfg.vocab % 8 == 0 and cfg.dtype == "bfloat16":
        require(logits_bitwise, "forward_logits differs from the prefill's logits "
                f"(max abs diff {diff})")
    return {"tokens_equal": True, "logits_finite": True,
            "graphed_vs_eager_prefill_bitwise": True,
            "forward_row_unembedded_vs_prefill_bitwise": True,
            "forward_vs_prefill_bitwise": logits_bitwise,
            "forward_vs_prefill_max_abs_diff": diff, "eager_prefill_launches": eager,
            "last_logit_abs_max": float(pre.float().abs().max())}


def print_profiles(torch, eng, params, batch_in, tag: str) -> None:
    """Where the time of one prefill (eager, and the served graph) and one
    decode step goes."""
    cast = eng.cast_params(params)
    caches, tok, _, _ = eng.init_state()
    pre_caches = eng.model.prefill(cast, batch_in, caches)[1]
    print(json.dumps({f"profile_prefill{tag}": profile_calls(
        torch, lambda: eng.model.prefill(cast, batch_in, caches))}), flush=True)
    fresh = eng.init_state()[0]   # the graph copies these in; they stay empty
    print(json.dumps({f"profile_prefill_graph{tag}": profile_calls(
        torch, lambda: eng.prefill(params, batch_in, fresh), calls=3)}), flush=True)
    print(json.dumps({f"profile_decode_step{tag}": profile_calls(
        torch, lambda: eng.model.decode_step(cast, pre_caches, tok))}), flush=True)
    graph_caches = eng.decode_one(params, pre_caches, tok)[1]  # the graph's own buffers
    print(json.dumps({f"profile_decode_graph{tag}": profile_calls(
        torch, lambda: eng.decode_one(params, graph_caches, tok))}), flush=True)


def ssd_flops_bytes(B, S, H, P, G, N, chunk, itemsize, h0: bool):
    """Operations the chunked form needs and the bytes a call must move
    (each input read once, each output written once).  Per chunk of L
    rows: C B^T and G x over the causal triangle only (G is 0 above the
    diagonal), L (L + 1) (N + P); C h^T and x^T (B w), 4 L N P."""
    chunk = min(chunk, S)
    lens = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    flops = B * H * sum(L * (L + 1) * (N + P) + 4 * L * N * P for L in lens)
    n_bytes = (2 * B * S * H * P * itemsize + B * S * H * 4 + H * 4
               + 2 * B * S * G * N * itemsize + (2 if h0 else 1) * B * H * P * N * 4)
    return flops, n_bytes


def served_ssd_inputs(torch, gen, B, S, H, G, kind="served", h0=True, P=64, N=128):
    """bf16 x, B and C as views of one conv output (row stride H P + 2 G
    N), float32 dt, A and init_state: ``"served"`` as the mamba2 prefill
    draws them (softplus dt, A = -exp(A_log) at init), ``"extreme"`` the
    extreme decay of ``tests/test_torch_gpu.py`` (dt ~ 1, A = -e)."""
    wide = torch.randn(B, S, H * P + 2 * G * N, device="cuda", generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    if kind == "served":
        dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda", generator=gen))
    else:
        dt = 1.0 + 0.01 * torch.rand(B, S, H, device="cuda", generator=gen)
    A = torch.full((H,), -2.718281828, device="cuda")
    h = torch.randn(B, H, P, N, device="cuda", generator=gen) if h0 else None
    return x, dt, A, Bm, C, h


def served_ssd_bound(torch, ref, y, h, x, dt, A, Bm, C, h0):
    """y and h against the plain version within the served bf16 bound:
    the largest shares of the bound used, and the largest errors.

    Bound: the plain version rounds each x*B product to bf16 (2^-8 of
    that term) where the kernel widens to float32 first; both round y to
    bf16 (2^-8 of each); 2^-10 of the terms' magnitudes covers float32
    reassociation, the chunked exponent's rounding and the tensor-core
    kernel's bf16 parts.  yabs, habs: the scan of |x|, |B|, |C|, |h0| --
    the sum of the terms' magnitudes."""
    yp, hp = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=None if h0 is None else h0.abs(), return_state=True)
    dy = (y.float() - yp.float()).abs()
    tol_y = 2.0 ** -8 * (y.float().abs() + yp.float().abs()) + (2.0 ** -8 + 2.0 ** -10) * yabs
    dh = (h - hp).abs()
    tol_h = (2.0 ** -8 + 2.0 ** -10) * habs
    require(bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all()),
            f"ssd_scan: non-finite output at {tuple(x.shape)}")
    require(bool((dy <= tol_y).all()) and bool((dh <= tol_h).all()),
            f"ssd_scan != plain beyond the served bf16 bound at {tuple(x.shape)}")
    return {"y_max_abs_err": float(dy.max()),
            "y_max_rel_err": float(dy.max() / yp.float().abs().max()),
            "y_bound_used": float((dy / tol_y).max()),
            "h_max_abs_err": float(dh.max()),
            "h_max_rel_err": float(dh.max() / hp.abs().max()),
            "h_bound_used": float((dh / tol_h).max())}


def cuda_core_ssd(torch, x, dt, A, Bm, C, h0):
    """The CUDA-core SSD kernel (the port's kernel before the tensor-core
    ones; the route rule now gives it float32 and other shapes) on bf16
    inputs at chunk 128 (h0 may be None), called through its C entry
    point: its time at the served shapes is the SSD row's ``earlier_ms``,
    at hymba's the N-16 row's ``cuda_core_ms``."""
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = load_library("ssd_scan", sk.SIGNATURES).rt_ssd_scan(
        1, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, P, G, N,
        128, *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3], *C.stride()[:3],
        stream_arg(x))
    check_launch("ssd_scan", err)
    return y, h


def check_ssd(torch, ssd, ref, seed: int):
    """Phase 8: the SSD kernel against its plain version on both routes;
    returns its kernel-table row and the details of the check."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def on_route(route, fn):
        """``fn()``, required to launch the SSD kernel once, on ``route``."""
        before = ssd.launch_counts()
        out = fn()
        moved = {k: v - before[k] for k, v in ssd.launch_counts().items() if v != before[k]}
        require(moved == {"ssd_scan": 1, f"ssd_scan_{route}": 1},
                f"ssd_scan took {moved}, not one launch on the {route} route")
        return out

    fp32_err = 0.0
    # tests/test_kernels.py SSD_CASES, its init_state case, a tail case:
    # float32, the CUDA-core route
    for B, S, H, P, G, N, chunk, h0 in [(1, 32, 2, 8, 1, 8, 8, False),
                                        (2, 80, 4, 16, 2, 24, 32, False),
                                        (1, 128, 2, 32, 1, 16, 128, False),
                                        (1, 40, 2, 8, 1, 8, 8, True),
                                        (2, 40, 4, 16, 2, 16, 16, True)]:
        x = torch.randn(B, S, H, P, device="cuda", generator=gen)
        dt = torch.randn(B, S, H, device="cuda", generator=gen).abs() * 0.1
        A = -torch.randn(H, device="cuda", generator=gen).abs()
        Bm = torch.randn(B, S, G, N, device="cuda", generator=gen)
        C = torch.randn(B, S, G, N, device="cuda", generator=gen)
        h = torch.randn(B, H, P, N, device="cuda", generator=gen) if h0 else None
        got = on_route("cuda_core", lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h,
                                                          chunk=chunk, return_state=True))
        want = ref.ssd_scan(x, dt, A, Bm, C, init_state=h, return_state=True)
        for g, w in zip(got, want):
            fp32_err = max(fp32_err, float((g - w).abs().max()))
            require(torch.allclose(g, w, rtol=2e-4, atol=3e-5),
                    f"ssd_scan != plain on float32 case S={S} chunk={chunk}")

    # served prefill shapes, bf16; x, B, C are views of the conv output
    B, S, H, P, G, N = SERVE["batch"], SERVE["prompt_len"], 80, 64, 1, 128
    x, dt, A, Bm, C, h0 = served_ssd_inputs(torch, gen, B, S, H, G)
    route = ssd.route(x.dtype, P, N, 128)
    y, h = on_route(route, lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=128,
                                                return_state=True))
    served = served_ssd_bound(torch, ref, y, h, x, dt, A, Bm, C, h0)
    # bf16 at the served widths, the tensor-core route: a short last chunk
    # with init_state and 2 groups, more chunks than a cluster holds (11
    # chunks: the cluster of 8 walks two groups), and the extreme decay of
    # tests/test_torch_gpu.py, whose state is also held to that test's
    # bound against the plain version of the same values in float32
    cases = {}
    for shape in [(2, 300, 8, 2, "served", True), (1, 1300, 2, 1, "served", True),
                  (1, 256, 2, 1, "extreme", False)]:
        args = served_ssd_inputs(torch, gen, *shape)
        yc, hc = on_route("wgmma", lambda: ssd.ssd_scan(*args[:5], init_state=args[5],
                                                        chunk=128, return_state=True))
        key = "B{}_S{}_H{}_G{}_{}".format(*shape)
        cases[key] = served_ssd_bound(torch, ref, yc, hc, *args)
        if shape[4] == "extreme":
            xf, Bf, Cf = (t.float() for t in (args[0], args[3], args[4]))
            dtc, Ac = args[1], args[2]
            _, hf = ref.ssd_scan(xf, dtc, Ac, Bf, Cf, return_state=True)
            _, habs = ref.ssd_scan(xf.abs(), dtc, Ac, Bf.abs(), Cf.abs(), return_state=True)
            tol = 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs
            require(bool(((hc - hf).abs() <= tol).all()),
                    "ssd_scan: the state beyond the extreme-decay bound in bf16")
            cases[key]["h_extreme_decay_bound_used"] = float(((hc - hf).abs() / tol).max())

    flops, n_bytes = ssd_flops_bytes(B, S, H, P, G, N, 128, 2, True)
    # the products at the bf16 tensor-core peak, the inputs' type, whichever
    # route the kernel takes
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_OPS_PER_S
    row = {
        "name": "ssd_scan", "route": "cuda", "kernel_route": route,
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan"], "max_abs_err": served["y_max_abs_err"],
        "ms": median_ms(torch, lambda: ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0,
                                                     chunk=128, return_state=True)),
        "plain_ms": median_ms(torch, lambda: ref.ssd_scan(x, dt, A, Bm, C, init_state=h0,
                                                          return_state=True),
                              reps=3, inner=2),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes the chunked scan
        "earlier_ms": median_ms(torch, lambda: cuda_core_ssd(torch, x, dt, A, Bm, C, h0)),
    }
    detail = {
        "shapes": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": 128},
        "route": route, "parts": list(ssd.PARTS), "cluster": ssd.default_cluster(S),
        "flops": flops, "bytes": n_bytes,
        "float32_ops_bound_ms": flops / FP32_OPS_PER_S * 1e3,
        "fp32_cases_max_abs_err": fp32_err,
        "served": served, "bf16_cases": cases,
    }
    return row, detail


def bf16_close(torch, got, want):
    """(within the bound, share of the bound used): both sides are float32
    results rounded to bf16, so they may land one ulp apart, at most 2^-8
    of their magnitudes, where the float32 values straddle a rounding
    boundary; 1e-6 absolute covers float32 reassociation near zero."""
    g, w = got.float(), want.float()
    d, tol = (g - w).abs(), 2.0 ** -8 * (g.abs() + w.abs()) + 1e-6
    return bool((d <= tol).all()), float((d / tol).max())


def attention_pairs(Sq: int, Skv: int, q_offset: int, window) -> int:
    """(query, key) pairs a causal attention with this window computes."""
    total = 0
    for i in range(Sq):
        hi = min(Skv, q_offset + i + 1)
        lo = 0 if window is None else max(0, q_offset + i - window + 1)
        total += max(0, hi - lo)
    return total


def cuda_core_flash(torch, q, k, v, window):
    """The CUDA-core flash kernel (the port's kernel before the tensor-core
    one; the route rule now gives it float32 and head_dims 16 and 32) on
    bf16 q, k, v, called through its C entry point: its time on the
    served layers is the flash row's ``earlier_ms``."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    B, Hq, Sq, D = q.shape
    Dv = v.shape[3]
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = load_library("flash_attention", fk.SIGNATURES).rt_flash_attention(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, k.shape[1], Sq,
        k.shape[2], D, Dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        D ** -0.5, 0.0, 1, -1 if window is None else int(window), 0, None, None,
        stream_arg(q))
    check_launch("flash_attention", err)
    return out


def check_dense_kernels(torch, eng, params, batch_in, fk, rk, ref, seed: int):
    """Phase 10: flash attention and rmsnorm against their plain versions;
    returns their kernel-table rows and the details of the checks."""
    import torch.nn.functional as F

    from repro_torch.models import nn, transformer as tfm

    cfg = eng.model.cfg
    cast = eng.cast_params(params)
    seg = cast["decoder"]["segments"][0]
    tokens = batch_in["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = nn.apply_embedding(cast["embed"], tokens, cfg)
    x0 = x
    detail, flash_err, layers = {}, 0.0, {}
    per_layer = tfm.unbind_layers(seg, cfg.n_layers)
    for li in range(6):   # layer 0 is local, layer 5 the first global one
        p = per_layer[li]
        window, theta = tfm.layer_window_theta(cfg, li)
        if li in (0, 5):
            h = nn.apply_rmsnorm(p["ln_attn"], x, cfg)
            q, k, v = nn.attention_qkv(p["attn"], h, cfg, rope_theta=theta,
                                       positions=positions)
            layers[li] = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          window or None)
        x, _ = tfm.apply_block(p, x, cfg, "attn_mlp", window=window, rope_theta=theta,
                               positions=positions)

    def on_route(route, fn):
        """``fn()``, required to launch flash once, on ``route``."""
        before = fk.launch_counts()
        out = fn()
        after = fk.launch_counts()
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(moved == {"flash_attention": 1, f"flash_attention_{route}": 1},
                f"flash_attention took {moved}, not one launch on the {route} route")
        return out

    for li, (q, k, v, window) in layers.items():
        got = on_route("wgmma", lambda: fk.flash_attention(q, k, v, window=window))
        want = ref.attention(q, k, v, window=window)
        ok, used = bf16_close(torch, got, want)
        err = float((got.float() - want.float()).abs().max())
        flash_err = max(flash_err, err)
        require(ok, f"flash_attention != plain on the served layer {li} beyond one bf16 "
                f"rounding (max abs err {err})")
        detail[f"layer{li}"] = {"window": window, "max_abs_err": err, "bound_used": used,
                                "out_abs_max": float(want.float().abs().max())}
        if window is None:   # the library call on the same input, for comparison only
            lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            detail[f"layer{li}"]["sdpa_bound_used"] = bf16_close(torch, lib, want)[1]

    # bf16 at head_dim 64 / 128 / 256 (GQA, ragged, an offset, a window, a
    # softcap), at the served layers' bound
    gen = torch.Generator("cuda").manual_seed(seed)
    used_max = 0.0
    for B, Hq, Hkv, Sq, Skv, D, kw in [
            (2, 4, 4, 100, 100, 64, dict()),
            (1, 8, 2, 130, 130, 128, dict(window=7)),
            (1, 8, 1, 200, 333, 256, dict(q_offset=133)),
            (1, 2, 1, 96, 96, 64, dict(logit_softcap=15.0)),
            (2, 4, 2, 1, 300, 256, dict(q_offset=299))]:
        qb, kb, vb = (torch.randn(B, H, S, D, device="cuda", generator=gen).bfloat16()
                      for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
        got = on_route("wgmma", lambda: fk.flash_attention(qb, kb, vb, **kw))
        ok, used = bf16_close(torch, got, ref.attention(qb, kb, vb, **kw))
        used_max = max(used_max, used)
        require(ok, f"flash_attention != plain on bf16 case {(B, Hq, Hkv, Sq, Skv, D, kw)}")
    detail["bf16_cases_bound_used"] = used_max

    # float32: the cases of tests/test_kernels.py (softcap, one query at an
    # offset, a window, ragged kv) and head_dim 128 and 256; the repo's
    # kernel-vs-reference bound, rtol 2e-4 / atol 3e-5
    fp32_err = 0.0
    for B, Hq, Hkv, Sq, Skv, D, kw in [
            (1, 2, 1, 64, 64, 32, dict()),
            (2, 4, 4, 48, 48, 16, dict(causal=False)),
            (1, 2, 2, 64, 64, 32, dict(window=19)),
            (1, 2, 1, 64, 64, 32, dict(logit_softcap=15.0)),
            (2, 4, 1, 1, 80, 32, dict(q_offset=79)),
            (1, 8, 2, 32, 96, 64, dict(q_offset=64)),
            (1, 2, 1, 50, 70, 32, dict(causal=False)),
            (1, 4, 2, 100, 100, 128, dict(window=7)),
            (2, 4, 1, 70, 200, 256, dict(q_offset=130, window=40)),
            (1, 4, 1, 300, 300, 256, dict())]:
        qf = torch.randn(B, Hq, Sq, D, device="cuda", generator=gen)
        kf = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen)
        vf = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen)
        got = on_route("cuda_core", lambda: fk.flash_attention(qf, kf, vf, **kw))
        want = ref.attention(qf, kf, vf, **kw)
        fp32_err = max(fp32_err, float((got - want).abs().max()))
        require(torch.allclose(got, want, rtol=2e-4, atol=3e-5),
                f"flash_attention != plain on float32 case {(B, Hq, Hkv, Sq, Skv, D, kw)}")
    detail["fp32_cases_max_abs_err"] = fp32_err
    detail["fp32_b1_h4_s300_d256_cuda_core_ms"] = median_ms(
        torch, lambda: fk.flash_attention(qf, kf, vf))

    # timed at the served global layer; bound: the pairs this input needs
    # in bf16 products summed in float32 (what the tensor cores compute)
    q, k, v, _ = layers[5]
    B, Hq, S, D = q.shape
    flops = {li: 4 * B * Hq * D * attention_pairs(S, S, 0, w)
             for li, (_, _, _, w) in layers.items()}
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ql, kl, vl, wl = layers[0]
    pos = torch.arange(S, device="cuda")
    local_mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - wl)
    detail["flops"] = flops
    detail["bytes"] = n_bytes
    detail["local_layer0"] = {
        "ms": median_ms(torch, lambda: fk.flash_attention(ql, kl, vl, window=wl)),
        "earlier_ms": median_ms(torch, lambda: cuda_core_flash(torch, ql, kl, vl, wl)),
        "sdpa_window_mask_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=local_mask, enable_gqa=True)),
        "bound_ms": max(flops[0] / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3}
    rows = [kernel_row(
        torch, "flash_attention", "flash_attention.cu", flash_err,
        lambda: fk.flash_attention(q, k, v), lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        n_bytes, flops[5], BF16_OPS_PER_S, plain_reps=(5, 4))]
    rows[0]["earlier_ms"] = median_ms(torch, lambda: cuda_core_flash(torch, q, k, v, None))
    require(bf16_close(torch, cuda_core_flash(torch, q, k, v, None), ref.attention(q, k, v))[0],
            "the CUDA-core kernel != plain on the served global layer")

    # rmsnorm: the served layer-0 input and sweeps of d, rows, offset
    norm_err = 0.0
    w = per_layer[0]["ln_attn"]["scale"]
    cases = [(x0, w, 1.0)]
    for rows_, d in [(37, 1152), (1001, 256), (7, 2560)]:
        for off in (0.0, 1.0):
            for dt in (torch.bfloat16, torch.float32):
                xs = torch.randn(rows_, d, device="cuda", generator=gen).to(dt)
                ws = torch.randn(d, device="cuda", generator=gen)
                cases.append((xs, ws, off))
    for xs, ws, off in cases:
        got = rk.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=off)
        want = ref.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=off)
        err = float((got.float() - want.float()).abs().max())
        norm_err = max(norm_err, err)
        if xs.dtype == torch.float32:
            require(torch.allclose(got, want, rtol=2e-5, atol=1e-5),
                    f"rmsnorm != plain at {tuple(xs.shape)} float32")
        else:
            require(bf16_close(torch, got, want)[0],
                    f"rmsnorm != plain at {tuple(xs.shape)} bf16 beyond one rounding")
    detail["rmsnorm_max_abs_err"] = norm_err
    # a row's output does not depend on the rows launched with it: the
    # served input's 4096 rows (the rows route) and its first 4 (the team
    # route) give the same first rows, bit for bit
    flat = x0.reshape(-1, x0.shape[-1])
    head = rk.rmsnorm(flat[:4], w, eps=cfg.norm_eps, weight_offset=1.0)
    full = rk.rmsnorm(flat, w, eps=cfg.norm_eps, weight_offset=1.0)
    require(torch.equal(head, full[:4]), "rmsnorm: the first 4 rows alone differ from the "
            "same rows of the served input")
    detail["rmsnorm_routes"] = {"served": rk.route(*flat.shape, flat.dtype),
                                "first_4_rows": rk.route(4, flat.shape[1], flat.dtype),
                                "rows_independent_bitwise": True}
    # the decode shapes: mamba2 (4 x 2560, 4 x 5120), gemma3 (4 x 1152 and
    # the qk-norm's 16 x 256), bf16 over a float32 weight, as served
    decode = []
    for rows_, d in [(4, 2560), (4, 5120), (4, 1152), (16, 256)]:
        xs = torch.randn(rows_, d, device="cuda", generator=gen).bfloat16()
        ws = torch.randn(d, device="cuda", generator=gen)
        ws1 = (ws + 1.0).bfloat16()
        require(bf16_close(torch, rk.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=1.0),
                           ref.rmsnorm(xs, ws, eps=cfg.norm_eps, weight_offset=1.0))[0],
                f"rmsnorm != plain at the decode shape {(rows_, d)} beyond one rounding")
        decode.append({
            "rows": rows_, "d": d, "route": rk.route(rows_, d, xs.dtype),
            "ms": median_ms(torch, lambda: rk.rmsnorm(xs, ws, eps=cfg.norm_eps,
                                                      weight_offset=1.0)),
            "library_ms": median_ms(torch, lambda: F.rms_norm(xs, (d,), weight=ws1,
                                                               eps=cfg.norm_eps)),
            "bound_ms": (2 * xs.numel() * 2 + d * 4) / HBM_BYTES_PER_S * 1e3})
    w1 = (w.float() + 1.0).to(x0.dtype)
    rows.append(kernel_row(
        torch, "rmsnorm", "rmsnorm.cu", norm_err,
        lambda: rk.rmsnorm(x0, w, eps=cfg.norm_eps, weight_offset=1.0),
        lambda: ref.rmsnorm(x0, w, eps=cfg.norm_eps, weight_offset=1.0),
        lambda: F.rms_norm(x0, (x0.shape[-1],), weight=w1, eps=cfg.norm_eps),
        2 * x0.numel() * x0.element_size() + w.numel() * w.element_size(), 0,
        FP32_OPS_PER_S))
    rows[-1]["decode"] = decode
    detail["rmsnorm_shape"] = list(x0.shape)
    return rows, detail


def events_ms(torch, fn, calls: int = 3) -> float:
    """Median device time of ``calls`` calls of ``fn`` (CUDA events)."""
    fn()
    windows = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        windows.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in windows)


def host_polled(torch, fused, residual, init, tol: float, max_iters: int):
    """The loop the device-resident one replaces: one FusedEngine call and
    one host read of the residual an iteration.  Returns the final
    buffers, the residual trace, the dispatches, the host reads and the
    wall time (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem, trace, reads = init, [], 0
    dispatches = fused.stats.dispatches
    while True:
        mem = fused(mem)
        trace.append(float(residual(mem)))
        reads += 1
        if not (trace[-1] >= tol and len(trace) < max_iters):
            break
    wall = (time.perf_counter() - t0) * 1e3
    return mem, trace, fused.stats.dispatches - dispatches, reads, wall


def check_step_kernel(torch, graph_loop):
    """Phase 11, part 3: the step kernel against the plain step on known
    traces (the bound, and both parities of the last pass, whose select
    must leave the last iteration's index), and its kernels-line row: one
    iteration of a loop whose passes replay a trace, against the same
    feed and the plain step in a plain graph."""
    trace = torch.linspace(1.0, 0.0, 32, device="cuda")
    err, cases = 0.0, []
    for tol, max_iters in STEP_CASES:
        want_red, want_n = graph_loop.trace_plain(trace, tol, max_iters)
        loop, red, n_done, last = graph_loop.trace_loop(trace, tol, max_iters)
        loop.launch()
        torch.cuda.synchronize()
        err = max(err, float((red.cpu() - want_red).abs().max()))
        require(int(n_done) == int(want_n) and torch.equal(red.cpu(), want_red),
                f"step kernel != plain step at tol {tol}, max_iters {max_iters}: "
                f"n_done {int(n_done)} vs {int(want_n)}")
        require(int(last) == int(want_n) - 1, f"the parity select kept iteration {int(last)}, "
                f"not the last ({int(want_n) - 1}), at n_done {int(want_n)}")
        cases.append({"tol": tol, "max_iters": max_iters, "n_done": int(n_done)})
    long_trace = torch.rand(STEP_ITERS, device="cuda")
    loop, _, n_done, _ = graph_loop.trace_loop(long_trace, -1.0, STEP_ITERS)
    iter_ms = events_ms(torch, loop.launch) / STEP_ITERS
    require(int(n_done) == STEP_ITERS, f"the timing loop ran {int(n_done)} iterations")
    reductions = torch.zeros(STEP_ITERS, device="cuda")
    count = torch.zeros((), dtype=torch.int32, device="cuda")

    def plain_iter():
        r = long_trace.index_select(0, count.reshape(1).long()).reshape(())
        graph_loop.step_plain(reductions, count, r, r >= -1.0, STEP_ITERS)

    # bytes of one step: the reduction, the predicate and n_done read, the
    # trace entry, n_done and the decision written
    t_bytes, t_ops = 21 / HBM_BYTES_PER_S, 2 / FP32_OPS_PER_S
    row = {"name": "graph_loop_step", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
           "replaces": REPLACES["graph_loop_step"], "pallas_counterpart": False,
           "max_abs_err": err, "ms": iter_ms,
           "plain_ms": median_ms(torch, plain_iter, reps=5, inner=20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    return row, cases


def run_convergence(torch, cfg, mesh, u0, card: str, hk, graph_loop):
    """Phase 11: Faces until the residual falls below each tolerance, device-
    resident (``run_faces_until_converged``, dataflow: one graph launch of
    a conditional WHILE node) against host-polled (``FusedEngine``, one
    call and one host read an iteration); then the loop's own cost at
    its bound beside the fixed-count graph, and the step kernel against
    its plain version.  Counters are set to 0 just before the device-
    resident runs and read just after them."""
    from repro_torch.core import (FusedEngine, PersistentEngine, build_faces_program,
                                  global_residual_fn, run_faces_until_converged)

    residual = global_residual_fn(cfg)
    prog = build_faces_program(cfg, mesh)
    fused = FusedEngine(prog, mode="dataflow", donate=True)
    fused.compile()
    rows = []
    torch.cuda.synchronize()
    hk.reset_launches()
    graph_loop.reset_launches()
    for tol in CONV_TOLS:
        t0 = time.perf_counter()
        mem, res, n_done, stats = run_faces_until_converged(
            cfg, mesh, u0, tol=tol, max_iters=CONV_MAX_ITERS, mode="dataflow")
        first_wall = (time.perf_counter() - t0) * 1e3
        require((stats.dispatches, stats.sync_points) == (1, 0),
                f"tol {tol}: the device-resident loop took {stats}")
        eng = PersistentEngine(prog.persistent(CONV_MAX_ITERS, until=lambda r, t=tol: r >= t),
                               mode="dataflow", reduce_fn=residual, donate=True)
        init = eng.init_buffers({"u": u0})
        eng.compile()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, warm_n = eng(init)
            warm_n = int(warm_n)
            walls.append((time.perf_counter() - t0) * 1e3)
        require(warm_n == n_done, f"tol {tol}: a warm call ran {warm_n} passes, not {n_done}")
        polled = [host_polled(torch, fused, residual, fused.init_buffers({"u": u0}), tol,
                              CONV_MAX_ITERS) for _ in range(3)]
        want, trace, dispatches, reads, _ = polled[-1]  # want: the fused engine's buffers
        require(len(trace) == n_done, f"tol {tol}: host-polled ran {len(trace)} "
                f"iterations, device-resident {n_done}")
        require(res.tolist() == trace, f"tol {tol}: residual traces differ")
        for name, t in want.items():
            require(torch.equal(mem[name], t), f"tol {tol}: {name} differs from the "
                    "host-polled run's")
        require(bool(torch.isfinite(mem["u"]).all()), f"tol {tol}: non-finite field")
        rows.append({"tol": tol, "n_done": n_done, "final_residual": trace[-1],
                     "device_resident": {"wall_ms": statistics.median(walls),
                                         "first_call_wall_ms": first_wall,
                                         "dispatches": stats.dispatches,
                                         "sync_points": stats.sync_points},
                     "host_polled": {"wall_ms": statistics.median(p[4] for p in polled),
                                     "dispatches": dispatches, "sync_points": reads},
                     "equal_bitwise": True})
        del eng, mem, want, polled
    torch.cuda.synchronize()
    launches = {**hk.launch_counts(), **graph_loop.launch_counts()}
    require(all(launches[n] > 0 for n in FACES_KERNELS + ("graph_loop_step",)),
            f"a kernel of the convergence path never launched: {launches}")
    del fused

    # the loop's own cost: tol 0 runs to the bound, beside the fixed-count graph
    bound = {}
    for mode in ("stream", "dataflow"):
        loop = PersistentEngine(prog.persistent(BOUND_ITERS, until=lambda r: r >= 0.0),
                                mode=mode, reduce_fn=residual, donate=True)
        fixed = PersistentEngine(prog.persistent(BOUND_ITERS), mode=mode, donate=True)
        reduced = PersistentEngine(prog.persistent(BOUND_ITERS), mode=mode,
                                   reduce_fn=residual, donate=True)
        init = loop.init_buffers({"u": u0})
        for e in (loop, fixed, reduced):
            e.compile()
        mem, red, n_done = loop(init)
        require(int(n_done) == BOUND_ITERS, f"{mode}: tol 0 stopped at {int(n_done)}, "
                f"not at max_iters {BOUND_ITERS}")
        want, want_red = reduced(init)
        require(torch.equal(mem["u"], fixed(init)["u"]) and torch.equal(mem["u"], want["u"])
                and torch.equal(red, want_red), f"{mode}: the loop at its bound differs "
                "from the fixed-count graph")
        bound[mode] = {"n_done": int(n_done),
                       "loop_ms_per_iter": events_ms(torch, lambda: loop(init)) / BOUND_ITERS,
                       "fixed_ms_per_iter": events_ms(torch, lambda: fixed(init)) / BOUND_ITERS,
                       "fixed_with_residual_ms_per_iter":
                           events_ms(torch, lambda: reduced(init)) / BOUND_ITERS}
        del loop, fixed, reduced, mem, want
    u = torch.from_numpy(u0).cuda()
    dst = torch.empty_like(u)
    costs = {"field_copy_ms": median_ms(torch, lambda: dst.copy_(u)),
             "residual_ms": median_ms(torch, lambda: residual({"u": u}))}
    row, cases = check_step_kernel(torch, graph_loop)
    row["launches"] = launches["graph_loop_step"]
    return {"card": card, "grid": cfg.grid, "points": cfg.points,
            "max_iters": CONV_MAX_ITERS, "rows": rows,
            "bound": {"max_iters": BOUND_ITERS, "card": card, **bound, **costs},
            "step_cases": cases, "launches": launches}, row


def check_schedule_step(torch, graph_loop):
    """Phase 14, the step: the schedule step kernel against the plain
    schedule step on known traces (each program's counter, kept through
    its snapshots and restores, must equal its count), and its kernels-
    line row: one pass of a 4-program loop replaying traces, against the
    same feed and the plain step in a plain graph."""
    err, cases = 0.0, []
    for tols, counts, max_iters in SCHED_STEP_CASES:
        traces = torch.stack([torch.linspace(1.0, 0.0, 16, device="cuda") * (k + 1)
                              for k in range(len(counts))])
        want_red, want_n = graph_loop.trace_schedule_plain(traces, tols, counts, max_iters)
        loop, red, n_done, v = graph_loop.trace_schedule_loop(traces, tols, counts, max_iters)
        loop.launch()
        torch.cuda.synchronize()
        err = max(err, float((red.cpu() - want_red).abs().max()))
        require(n_done.cpu().tolist() == want_n.tolist() and torch.equal(red.cpu(), want_red),
                f"schedule step != plain step at tols {tols}, counts {counts}: n_done "
                f"{n_done.tolist()} vs {want_n.tolist()}")
        require([int(t) for t in v] == want_n.tolist(), f"the freeze graphs kept "
                f"{[int(t) for t in v]}, not the counts {want_n.tolist()}")
        cases.append({"tols": tols, "counts": counts, "n_done": want_n.tolist()})
    n = SCHED_STEP_PROGRAMS
    long_traces = torch.rand(n, STEP_ITERS, device="cuda")
    loop, _, n_done, _ = graph_loop.trace_schedule_loop(long_traces, (-1.0,) * n,
                                                        (STEP_ITERS,) * n, STEP_ITERS)
    iter_ms = events_ms(torch, loop.launch) / STEP_ITERS
    require(n_done.cpu().tolist() == [STEP_ITERS] * n,
            f"the timing loop ran {n_done.tolist()} passes")
    # the same loop with one program: what the step's width and the IF nodes
    # of the other programs add
    one, _, _, _ = graph_loop.trace_schedule_loop(long_traces[:1], (-1.0,), (STEP_ITERS,),
                                                  STEP_ITERS)
    one_ms = events_ms(torch, one.launch) / STEP_ITERS
    reductions = torch.zeros(n, STEP_ITERS, device="cuda")
    count = torch.zeros(n, dtype=torch.int32, device="cuda")
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    i = torch.zeros((), dtype=torch.int32, device="cuda")
    limits = torch.full((n,), STEP_ITERS, dtype=torch.int32, device="cuda")
    yes = torch.ones(n, dtype=torch.bool, device="cuda")

    def plain_iter():
        r = long_traces.gather(1, count.long().clamp(max=STEP_ITERS - 1)[:, None]).reshape(n)
        graph_loop.schedule_step_plain(reductions, count, active, i, r, r >= -1.0, limits,
                                       yes, yes, STEP_ITERS)

    # bytes of one step: per program active, n_done, the reduction and the
    # predicate read (13), the trace entry, n_done and active written (12);
    # the pass counter read and written and the decision written (12)
    t_bytes, t_ops = (25 * n + 12) / HBM_BYTES_PER_S, 3 * n / FP32_OPS_PER_S
    row = {"name": "schedule_step", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
           "replaces": REPLACES["schedule_step"], "pallas_counterpart": False,
           "max_abs_err": err, "ms": iter_ms, "one_program_ms": one_ms,
           "plain_ms": median_ms(torch, plain_iter, reps=5, inner=20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    return row, cases


def run_masked(torch, cfg, mesh, u0, card: str, hk, graph_loop):
    """Phase 14: the masked multi-queue loop at full width, 2 and 4 x-parts
    in both modes: (a) equal tolerances, (b) unequal ones, (c) (b)
    unlinked, against each part's own converged run, (d) linked fixed
    counts 3 and 7, (e) every count 10 with reductions, against the
    fixed-count composed graph.  Every solve is one graph launch whose
    fields, traces and counts equal the eager loop's on the card bit for
    bit; the counters are set to 0 just before each masked run (compile
    and call) and read just after."""
    from repro_torch.core import (PersistentEngine, build_faces_pipeline, global_residual_fn,
                                  part_configs, part_names, run_faces_until_converged,
                                  split_parts)
    from repro_torch.core.engine_persistent import _run_schedule_while

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def solve(mode, n_parts, what, exchange=True, counts=MASK_MAX_ITERS, tols=None,
              reduce=True, sanitize=False):
        names = part_names(n_parts)
        fns = {nm: global_residual_fn(c, buf=f"{nm}/u")
               for nm, c in zip(names, part_configs(cfg, n_parts))} if reduce else None
        eng = PersistentEngine(build_faces_pipeline(cfg, mesh, n_parts, counts, exchange,
                                                    tols=tols),
                               mode=mode, donate=True, reduce_fns=fns, sanitize=sanitize)
        init = eng.init_buffers(dict(zip([f"{n}/u" for n in names],
                                         split_parts(u0, n_parts))))
        torch.cuda.synchronize()
        hk.reset_launches()
        graph_loop.reset_launches()
        eng.compile()
        (mem, reds, n_done), first_ms = synced_ms(lambda: eng(init))
        counts_now = {**{n: hk.launch_counts()[n] for n in FACES_KERNELS},
                      "schedule_step": graph_loop.launch_counts()["schedule_step"]}
        require(all(counts_now.values()), f"{what}: a kernel of the masked path never "
                f"launched: {counts_now}")
        require((eng.stats.dispatches, eng.graph_launches, eng.stats.sync_points)
                == (1, 1, 0), f"{what}: {eng.stats}, {eng.graph_launches} graph launches")
        got = ({k: t.clone() for k, t in mem.items()}, {k: t.clone() for k, t in reds.items()},
               {k: int(v) for k, v in n_done.items()})
        walls = [synced_ms(lambda: eng(init))[1] for _ in range(3)]
        # the explicit reference: the eager loop on the card's tensors
        ref_red, ref_n = torch.zeros_like(eng._reductions), torch.zeros_like(eng._n_done)
        eager, eager_ms = synced_ms(lambda: _run_schedule_while(
            dict(init), sched=eng.program, mode=mode, low=eng._lowering, slots=eng._slots,
            reduce_fns=eng.reduce_fns, reductions=ref_red, n_done=ref_n))
        for k, sub in enumerate(eng.program.subs):
            require(int(ref_n[k]) == got[2][sub.name], f"{what}: {sub.name} ran "
                    f"{got[2][sub.name]} passes, the eager loop {int(ref_n[k])}")
            if sub.name in got[1]:
                require(torch.equal(got[1][sub.name], ref_red[k]),
                        f"{what}: {sub.name}'s trace differs from the eager loop's")
        for name, t in eager.items():
            require(torch.equal(got[0][name], t), f"{what}: {name} differs from the "
                    "eager loop's")
        row = {"n_done": got[2], "graph_wall_ms": statistics.median(walls),
               "first_call_wall_ms": first_ms, "eager_wall_ms": eager_ms,
               "dispatches": 1, "graph_launches": 1, "launches": counts_now,
               "equal_to_eager_bitwise": True}
        del eager
        return eng, init, got, row

    def tail(reds, n):
        return [float(x) for x in reds[max(0, n - 3):n]]

    out, step_launches = {}, 0
    for mode in ("stream", "dataflow"):
        for n_parts in PARTS:
            names = part_names(n_parts)
            tag = f"{mode}/parts{n_parts}"
            rows = {}
            # (a) equal tolerances
            eng, init, got, rows["a"] = solve(mode, n_parts, f"{tag} (a)",
                                              tols=(MASK_EQUAL_TOL,) * n_parts)
            require(all(bool(torch.isfinite(got[0][f"{n}/u"]).all()) for n in names),
                    f"{tag} (a): non-finite field")
            del eng, init, got
            # (b) unequal tolerances: does the tightest part plateau at the bound?
            tols = MASK_TOLS[n_parts]
            eng, init, got, rows["b"] = solve(mode, n_parts, f"{tag} (b)", tols=tols)
            tight = names[-1]
            trace = got[1][tight]
            n = got[2][tight]
            rows["b"]["tightest"] = {
                "name": tight, "tol": tols[-1], "n_done": n,
                "ran_to_bound": n == MASK_MAX_ITERS, "last_residuals": tail(trace, n),
                "plateau": bool(n == MASK_MAX_ITERS and abs(float(trace[n - 1])
                                - float(trace[n - 5])) <= 1e-3 * abs(float(trace[n - 1])))}
            rows["b"]["last_residuals"] = {k: tail(v, got[2][k]) for k, v in got[1].items()}
            # a pass with parts frozen (restores run) beside (e)'s, where none is
            rows["b"]["ms_per_iter"] = events_ms(torch, lambda: eng(init)) / max(got[2].values())
            if n_parts == 2:
                rows["b"]["pass_node_types"] = graph_loop.node_types(eng._loop.passes[0])
                freeze = {}
                for g in (g for f in eng._loop.freeze for g in f or ()):
                    for kind, c in graph_loop.node_types(g).items():
                        freeze[kind] = freeze.get(kind, 0) + c
                rows["b"]["freeze_node_types"] = freeze
                san = solve(mode, n_parts, f"{tag} (b) sanitized", tols=tols, sanitize=True)
                require(san[2][2] == got[2] and all(
                    torch.equal(san[2][0][k], t) for k, t in got[0].items()) and all(
                    torch.equal(san[2][1][k], t) for k, t in got[1].items()),
                    f"{tag} (b): sanitize=True changed the result")
                rows["b"]["sanitized_equal_bitwise"] = True
                rows["b"]["sanitized_graph_wall_ms"] = san[3]["graph_wall_ms"]
                del san
            del eng, init, got
            # (c) unlinked (b): each part equals its own converged run
            eng, init, got, rows["c"] = solve(mode, n_parts, f"{tag} (c)", exchange=False,
                                              tols=tols)
            for nm, pcfg, part, tol in zip(names, part_configs(cfg, n_parts),
                                           split_parts(u0, n_parts), tols):
                alone, res, n_alone, _ = run_faces_until_converged(
                    pcfg, mesh, part, tol=tol, max_iters=MASK_MAX_ITERS, mode=mode)
                require(n_alone == got[2][nm] and torch.equal(res, got[1][nm][:n_alone]),
                        f"{tag} (c): {nm} ran {got[2][nm]} passes, its own run {n_alone}, "
                        "or their traces differ")
                for buf, t in alone.items():
                    require(torch.equal(got[0][f"{nm}/{buf}"], t),
                            f"{tag} (c): {nm}/{buf} differs from its own run")
                del alone
            rows["c"]["equal_to_own_runs_bitwise"] = True
            del eng, init, got
            # (d) linked fixed counts, no reductions
            if n_parts == 2:
                eng, init, got, rows["d"] = solve(mode, 2, f"{tag} (d)", counts=MASK_COUNTS,
                                                  reduce=False)
                require(got[2] == dict(zip(names, MASK_COUNTS)) and got[1] == {},
                        f"{tag} (d): n_done {got[2]}")
                del eng, init, got
            # (e) reductions only, every count 10, against the fixed-count graph
            eng, init, got, rows["e"] = solve(mode, n_parts, f"{tag} (e)", counts=MASK_FIXED)
            fixed = PersistentEngine(build_faces_pipeline(cfg, mesh, n_parts, MASK_FIXED),
                                     mode=mode, donate=True)
            fixed.compile()
            want = fixed(init)
            require(all(torch.equal(got[0][k], t) for k, t in want.items()),
                    f"{tag} (e): the masked loop differs from the fixed-count graph")
            ms, fixed_ms = (events_ms(torch, lambda e=e: e(init)) / MASK_FIXED
                            for e in (eng, fixed))
            rows["e"].update({"equal_to_fixed_count_bitwise": True, "ms_per_iter": ms,
                              "fixed_count_ms_per_iter": fixed_ms,
                              "vs_fixed_count": ms / fixed_ms})
            del eng, init, got, fixed, want
            torch.cuda.empty_cache()
            for r in rows.values():
                step_launches += r["launches"]["schedule_step"]
            out[tag] = rows
    row, cases = check_schedule_step(torch, graph_loop)
    row["launches"] = step_launches
    return {"card": card, "grid": cfg.grid, "points": cfg.points,
            "max_iters": MASK_MAX_ITERS, "cases": out, "step_cases": cases}, row


def spearman(xs, ys):
    """Rank correlation of two equal-length sequences (tied values share
    their average rank); None when either is constant."""
    def ranks(v):
        order = sorted(range(len(v)), key=lambda i: v[i])
        r = [0.0] * len(v)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and v[order[j + 1]] == v[order[i]]:
                j += 1
            for q in range(i, j + 1):
                r[order[q]] = (i + j) / 2
            i = j + 1
        return r
    rx, ry = ranks(xs), ranks(ys)
    mx, my = sum(rx) / len(rx), sum(ry) / len(ry)
    vx, vy = sum((a - mx) ** 2 for a in rx), sum((b - my) ** 2 for b in ry)
    if not vx or not vy:
        return None
    return sum((a - mx) * (b - my) for a, b in zip(rx, ry)) / (vx * vy) ** 0.5


def tune_rows(res) -> dict:
    """Each candidate's predicted µs beside its measured median, the
    winner, and the rank agreement over the timed candidates."""
    timed = [c for c in res.candidates if c.stats is not None]
    return {"winner": res.best.knobs.label(),
            "candidates": [{"knobs": c.knobs.label(), "predicted_us": c.predicted_us,
                            "measured_med_ms": c.measured_ms, "error": c.error,
                            "certified": bool(c.certificate is not None
                                              and c.certificate.equivalent)}
                           for c in res.candidates],
            "spearman": spearman([c.predicted_us for c in timed],
                                 [c.stats["med_s"] for c in timed]) if len(timed) > 2 else None,
            "predicted_cheapest": min(res.candidates, key=lambda c: c.predicted_us
                                      if c.predicted_us is not None else float("inf")
                                      ).knobs.label()}


def mlp_inputs(torch, seed: int):
    """x (m, k) ~ N(0, 1) and the MLP weights scaled by 1/sqrt(fan-in), from
    ``torch.Generator(seed)`` (unscaled, the chain grows ~10^3 a layer)."""
    m, k, f = MLP
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=g), torch.randn(k, f, generator=g) / k ** 0.5,
            torch.randn(f, k, generator=g) / f ** 0.5)


def run_tuner(torch, cfg, mesh, u0, card: str, hk, seed: int):
    """Phase 15: ``run_faces_pipelined(tune=True)`` on the linked 2- and
    4-part pipeline at full width, ``tune(certify=True)`` with every
    candidate timed on the same builds, then the TP chain of phase 16
    tuned over mode x coalesce x double_buffer.  Winners: one dispatch,
    one graph launch, equal to the untuned run bit for bit; every
    candidate certified.  The counters are set to 0 just before each
    tuned run and read just after."""
    from repro_torch import make_mesh
    from repro_torch.core import (PersistentEngine, build_faces_pipeline, collectives,
                                  part_names, run_faces_pipelined, split_parts)
    from repro_torch.launch.tune import Knobs, tune

    def rerun(winner, fresh):
        winner.stats.reset()
        winner.graph_launches = 0
        got = winner(fresh())
        require((winner.stats.dispatches, winner.graph_launches) == (1, 1),
                f"the winner took {winner.stats}, {winner.graph_launches} graph launches")
        return got

    out, launches = {}, dict.fromkeys(FACES_KERNELS, 0)
    for n_parts in PARTS:
        what = f"{n_parts} parts"
        init = dict(zip([f"{n}/u" for n in part_names(n_parts)], split_parts(u0, n_parts)))
        plain, _ = run_faces_pipelined(cfg, mesh, u0, n_iters=N_ITERS, n_parts=n_parts)
        plain = {k: t.clone() for k, t in plain.items()}
        torch.cuda.synchronize()
        hk.reset_launches()
        t0 = time.perf_counter()
        mem, stats, tuned = run_faces_pipelined(cfg, mesh, u0, n_iters=N_ITERS,
                                                n_parts=n_parts, tune=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: hk.launch_counts()[n] for n in FACES_KERNELS}
        require(all(counts.values()), f"{what}: a kernel of the tuned path never "
                f"launched: {counts}")
        for n in FACES_KERNELS:
            launches[n] += counts[n]
        require((stats.dispatches, stats.sync_points, tuned.best.engine.graph_launches)
                == (1, 0, 1), f"{what}: the tuned solve took {stats}, "
                f"{tuned.best.engine.graph_launches} graph launches")
        require(all(torch.equal(mem[k], t) for k, t in plain.items()),
                f"{what}: the tuned run differs from the untuned one")
        row = {"run_faces_pipelined": {**tune_rows(tuned), "wall_ms": wall,
                                       "launches": counts, "equal_to_untuned_bitwise": True}}
        del mem, tuned

        def build(knobs, n_parts=n_parts, init=init):
            eng = PersistentEngine(build_faces_pipeline(cfg, mesh, n_parts, N_ITERS,
                                                        interleave=knobs.interleave_policy()),
                                   donate=True, **knobs.engine_kwargs())
            return eng, lambda: eng.init_buffers(init)

        n_cand = len(TUNE_SPACE["interleave"]) * len(TUNE_SPACE["mode"])
        res = tune(build, TUNE_SPACE, base=Knobs(), repeats=5, measure_top=n_cand,
                   certify=True)
        require(all(c.error is None and c.certificate.equivalent for c in res.candidates),
                f"{what}: a candidate was not certified: "
                f"{[(c.knobs.label(), c.error) for c in res.candidates if c.error]}")
        got = rerun(res.best.engine, res.best.fresh)
        require(all(torch.equal(got[k], t) for k, t in plain.items()),
                f"{what}: the certified winner differs from the untuned run")
        row["certified"] = {**tune_rows(res), "winner_equal_to_untuned_bitwise": True}
        out[f"parts{n_parts}"] = row
        del res, got, plain
        torch.cuda.empty_cache()

    x, w1, w2 = mlp_inputs(torch, seed)
    tp = collectives.build_tp_block(make_mesh((COLL_RANKS,), ("x",)), "x", *MLP, chain=True)
    pprog = tp.program.persistent(TP_LAYERS)
    args = {"x": x, "w1": w1, "w2": w2}

    def build_tp(knobs):
        eng = PersistentEngine(pprog, donate=True, **knobs.engine_kwargs())
        return eng, lambda: eng.init_buffers(args)

    eng, fresh = build_tp(Knobs())
    untuned = eng(fresh())["out"].clone()
    del eng
    n_cand = 2 * 2 * 2
    res = tune(build_tp, TP_SPACE, base=Knobs(), repeats=3, measure_top=n_cand, certify=True)
    require(all(c.error is None and c.certificate.equivalent for c in res.candidates),
            "TP chain: a candidate was not certified")
    got = rerun(res.best.engine, res.best.fresh)["out"]
    require(bool(torch.isfinite(got).all()) and torch.equal(got, untuned),
            "TP chain: the tuned winner differs from the untuned chain")
    out["tp_chain"] = {**tune_rows(res), "layers": TP_LAYERS, "mlp": MLP, "ranks": COLL_RANKS,
                       "winner_equal_to_untuned_bitwise": True}
    del res, got, untuned
    torch.cuda.empty_cache()
    return {"card": card, "grid": cfg.grid, "points": cfg.points, "iterations": N_ITERS,
            "space": TUNE_SPACE, "tp_space": TP_SPACE, "cases": out, "launches": launches}


def run_collectives(torch, card: str, seed: int):
    """Phase 16: the collective builders at gemma3-1b's MLP widths on 4
    ranks through FusedEngine and PersistentEngine in both modes, each
    equal to the port's decomposed oracle on the card bit for bit and to
    its CPU run within COLL_TOL (the all-to-all bit for bit); the
    26-layer persistent TP chain in one dispatch equal to 26 oracle
    applications, and its ms a layer beside 26 eager calls of the stock
    composition (CUDA events).  No hand-written kernel is on this path:
    the counters are set to 0 before it and must read 0 after it."""
    from repro_torch import make_mesh
    from repro_torch.core import FusedEngine, PersistentEngine, collectives
    from repro_torch.kernels import flash_attention, graph_loop, halo_pack, rmsnorm, ssd_scan

    kernels = (halo_pack, rmsnorm, flash_attention, ssd_scan, graph_loop)

    def counts():
        c = {}
        for mod in kernels:
            c.update(mod.launch_counts())
        return c

    m, k, f = MLP
    mesh = make_mesh((COLL_RANKS,), ("x",))
    cpu_mesh = make_mesh((COLL_RANKS,), ("x",), device="cpu")
    x, w1, w2 = mlp_inputs(torch, seed)
    builds = {
        "ag_matmul": (lambda mm: collectives.build_all_gather_matmul(mm, "x", m, k, f),
                      {"x": x, "w": w1}),
        "ag_matmul_bidi": (lambda mm: collectives.build_all_gather_matmul(
            mm, "x", m, k, f, bidirectional=True), {"x": x, "w": w1}),
        "matmul_rs": (lambda mm: collectives.build_matmul_reduce_scatter(mm, "x", m, k, f),
                      {"x": x, "w": w1}),
        "a2a": (lambda mm: collectives.build_all_to_all(mm, "x", m, k), {"x": x}),
    }
    torch.cuda.synchronize()
    for mod in kernels:
        mod.reset_launches()
    rows = {}
    for name, (build, args) in builds.items():
        cm = build(mesh)
        dev = [args[b].cuda() for b in cm.inputs]
        oracle = cm.reference(*dev)
        require(bool(torch.isfinite(oracle).all()), f"{name}: non-finite oracle")
        row = {"oracle_ms": events_ms(torch, lambda: cm.reference(*dev)),
               "stock_ms": events_ms(torch, lambda: cm.reference_stock(*dev))}
        for label, cls, mode in (("fused_stream", FusedEngine, "stream"),
                                 ("fused_dataflow", FusedEngine, "dataflow"),
                                 ("persistent_stream", PersistentEngine, "stream"),
                                 ("persistent_dataflow", PersistentEngine, "dataflow")):
            eng = cls(cm.program, mode=mode, donate=True)
            init = eng.init_buffers(args)
            got = eng(init)[cm.output]
            require(eng.stats.dispatches == eng.graph_launches == 1,
                    f"{name} {label}: {eng.stats}, {eng.graph_launches} graph launches")
            require(torch.equal(got, oracle), f"{name} {label}: differs from the "
                    "decomposed oracle")
            row[f"{label}_ms"] = events_ms(torch, lambda: eng(init))
            del eng, init, got
        cpu = FusedEngine(build(cpu_mesh).program)
        on_cpu = cpu(cpu.init_buffers(args))[cm.output]
        err = float((oracle.cpu() - on_cpu).abs().max())
        if name == "a2a":
            require(torch.equal(oracle.cpu(), on_cpu), "a2a: the card differs from the CPU")
        else:
            require(torch.allclose(oracle.cpu(), on_cpu, rtol=COLL_TOL, atol=COLL_TOL),
                    f"{name}: the card differs from the CPU by {err}")
        stock = cm.reference_stock(*dev)
        row.update({"equal_to_oracle_bitwise": True, "cpu_max_abs_err": err,
                    "stock_max_abs_err": float((stock - oracle).abs().max()),
                    "output_shape": tuple(oracle.shape)})
        rows[name] = row
        del cm, dev, oracle, cpu, on_cpu, stock
        torch.cuda.empty_cache()

    tp = collectives.build_tp_block(mesh, "x", *MLP, chain=True)
    args = {"x": x, "w1": w1, "w2": w2}
    dev = {b: a.cuda() for b, a in args.items()}
    chain = {}
    for mode in ("stream", "dataflow"):
        pers = PersistentEngine(tp.program.persistent(TP_LAYERS), mode=mode, donate=True)
        init = pers.init_buffers(args)
        got = pers(init)["out"].clone()
        require(pers.stats.dispatches == pers.graph_launches == 1,
                f"TP chain {mode}: {pers.stats}, {pers.graph_launches} graph launches")
        require(bool(torch.isfinite(got).all()), f"TP chain {mode}: non-finite result")
        chain[mode] = {"ms_per_layer": events_ms(torch, lambda: pers(init)) / TP_LAYERS,
                       "out": got}
        if mode == "dataflow":
            chain["profile"] = profile_calls(torch, lambda: pers(init))
        del pers, init
    require(torch.equal(chain["stream"]["out"], chain["dataflow"]["out"]),
            "TP chain: the modes differ")
    profile = chain.pop("profile")
    want = dev["x"]
    for _ in range(TP_LAYERS):
        want = tp.reference(want, dev["w1"], dev["w2"])
    got = chain["dataflow"]["out"]
    require(torch.equal(got, want), "TP chain: differs from the decomposed layers")
    fused = FusedEngine(tp.program, mode="dataflow", donate=True)
    mem = fused.init_buffers(args)
    for _ in range(TP_LAYERS):
        mem = fused(mem)
    require(fused.stats.dispatches == fused.graph_launches == TP_LAYERS
            and torch.equal(mem["out"], got), "TP chain: 26 fused calls differ")
    del fused, mem
    launched = counts()
    require(not any(launched.values()), f"a hand-written kernel launched on the "
            f"collectives' path: {launched}")

    def stock_chain():
        y = dev["x"]
        for _ in range(TP_LAYERS):
            y = tp.reference_stock(y, dev["w1"], dev["w2"])
        return y

    stock_ms = events_ms(torch, stock_chain) / TP_LAYERS
    stock_profile = profile_calls(torch, stock_chain)
    stock = stock_chain()
    t0 = time.perf_counter()
    ctp = collectives.build_tp_block(cpu_mesh, "x", *MLP, chain=True)
    ceng = PersistentEngine(ctp.program.persistent(TP_LAYERS))
    on_cpu = ceng(ceng.init_buffers(args))["out"]
    cpu_s = time.perf_counter() - t0
    err = float((got.cpu() - on_cpu).abs().max())
    require(torch.allclose(got.cpu(), on_cpu, rtol=COLL_TOL, atol=COLL_TOL),
            f"TP chain: the card differs from the CPU by {err}")
    scale = float(got.abs().max())
    rows["tp_chain"] = {
        "layers": TP_LAYERS, "ms_per_layer": {md: r["ms_per_layer"] for md, r in chain.items()},
        "stock_ms_per_layer": stock_ms,
        "vs_stock": {md: r["ms_per_layer"] / stock_ms for md, r in chain.items()},
        "dispatches": 1, "graph_launches": 1, "equal_to_oracle_layers_bitwise": True,
        "fused_26_calls_equal": True, "cpu_max_abs_err": err, "cpu_seconds": cpu_s,
        "max_abs_out": scale, "cpu_err_over_max": err / scale,
        "stock_max_abs_err": float((stock - got).abs().max()),
        "profile_26_layers": profile, "stock_profile_26_calls": stock_profile,
        "gflop_per_layer": 2 * 2 * m * k * f / 1e9,
        "fp32_bound_ms_per_layer": 2 * 2 * m * k * f / FP32_OPS_PER_S * 1e3}
    return {"card": card, "mlp": MLP, "ranks": COLL_RANKS, "cases": rows,
            "launches": launched}


def norm_entry(torch, rk, ref, tag, model, x, w, eps):
    """A served-shape rmsnorm entry: within one bf16 rounding of the plain
    version, timed cold beside it and ``F.rms_norm``."""
    import torch.nn.functional as F

    got = rk.rmsnorm(x, w, eps=eps, weight_offset=1.0)
    want = ref.rmsnorm(x, w, eps=eps, weight_offset=1.0)
    ok, used = bf16_close(torch, got, want)
    err = float((got.float() - want.float()).abs().max())
    require(ok, f"{tag}: rmsnorm != plain beyond one bf16 rounding (max abs err {err})")
    w1 = (w.float() + 1.0).to(x.dtype)
    row = kernel_row(
        torch, "rmsnorm", "rmsnorm.cu", err,
        cold_calls(torch, lambda x: rk.rmsnorm(x, w, eps=eps, weight_offset=1.0), x),
        cold_calls(torch, lambda x: ref.rmsnorm(x, w, eps=eps, weight_offset=1.0), x),
        cold_calls(torch, lambda x: F.rms_norm(x, (x.shape[-1],), weight=w1, eps=eps), x),
        2 * x.numel() * x.element_size() + w.numel() * w.element_size(), 0, FP32_OPS_PER_S)
    rows_ = x.numel() // x.shape[-1]
    return {"model": model, "shape": tag, "x": list(x.shape),
            "route": rk.route(rows_, x.shape[-1], x.dtype), "bound_used": used,
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}


def served_shape_checks(torch, cfg, cast, tokens, fk, rk, ref):
    """Phase 17: flash attention and rmsnorm against their plain versions on
    the served layer 0 of a dense model (its q, k, v at ``q_offset`` 0, the
    admission prefill's; its ``ln_attn`` input, and the 4 rows a decode
    step gives it at the model's ``norm_eps``), within one bf16 rounding;
    timed cold (:func:`cold_calls`) beside the plain versions and the
    library calls, with their bounds.  Returns the flash and rmsnorm
    entries."""
    import torch.nn.functional as F

    from repro_torch.models import nn, transformer as tfm

    p = tfm.unbind_layers(cast["decoder"]["segments"][0], cfg.n_layers)[0]
    _, theta = tfm.layer_window_theta(cfg, 0)
    x = nn.apply_embedding(cast["embed"], tokens, cfg)
    h = nn.apply_rmsnorm(p["ln_attn"], x, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    q, k, v = (t.transpose(1, 2) for t in nn.attention_qkv(
        p["attn"], h, cfg, rope_theta=theta, positions=positions))
    before = fk.launch_counts()
    got = fk.flash_attention(q, k, v)
    after = fk.launch_counts()
    require(after["flash_attention_wgmma"] - before["flash_attention_wgmma"] == 1,
            f"{cfg.name}: layer 0's flash did not take the tensor-core route")
    want = ref.attention(q, k, v)
    ok, used = bf16_close(torch, got, want)
    err = float((got.float() - want.float()).abs().max())
    require(ok, f"{cfg.name}: flash_attention != plain on the served layer 0 beyond one "
            f"bf16 rounding (max abs err {err})")
    B, Hq, S, D = q.shape
    flops = 4 * B * Hq * D * attention_pairs(S, S, 0, None)
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flash = kernel_row(
        torch, "flash_attention", "flash_attention.cu", err,
        cold_calls(torch, fk.flash_attention, q, k, v),
        cold_calls(torch, ref.attention, q, k, v),
        cold_calls(torch, lambda *qkv: F.scaled_dot_product_attention(
            *qkv, is_causal=True, enable_gqa=True), q, k, v),
        n_bytes, flops, BF16_OPS_PER_S, plain_reps=(5, 4))
    flash = {"model": cfg.name, "q": list(q.shape), "kv": list(k.shape),
             "group": Hq // k.shape[1], "bound_used": used,
             **{key: flash[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}}
    w = p["ln_attn"]["scale"]
    norm = {"eps": cfg.norm_eps,
            **norm_entry(torch, rk, ref, "layer 0 ln_attn", cfg.name, x, w, cfg.norm_eps)}
    # a decode step's input: one row a slot (the prompts' last tokens), on
    # the team route, held at the model's eps as the served rows are
    xd = x[:, -1].contiguous()
    require(rk.route(*xd.shape, xd.dtype) == "team", f"{cfg.name}: the decode rows took "
            f"the {rk.route(*xd.shape, xd.dtype)} route")
    norm["decode"] = norm_entry(torch, rk, ref, "a decode step's rows", cfg.name, xd, w,
                                cfg.norm_eps)
    return flash, norm


def scripted_sequence(torch, eng, params, prompts, batch_independent=True):
    """Phases 17's, 19's and 20's scripted mixed-depth sequence on ``eng``
    (4 slots; ``prompts`` a dict of numpy rows, a slot's a row): admit
    slots 0 and 1, one decode round, admit slots 2 and 3 while 0 and 1 are
    in flight, then decode rounds until every slot stops; each round is
    given the buffers the round before returned.  Each admission must be
    one graph launch equal to the eager admission on a copy of the same
    state bit for bit (every output and cache leaf); with
    ``batch_independent`` the second one's in-flight slots (0 and 1) must
    equal, bit for bit, an eager decode round from the same state without
    the admission (outputs and cache leaves: the merge keeps them); a MoE
    config's slots share their experts' capacity, so there they need not.
    Returns the tokens of each slot, the checks, and the kernel launches
    of the eager checks (which are not the path's)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import PAD_TOKEN
    from repro_torch.models.nn import tree_leaves, tree_map

    slots, max_new, dev = eng.slots, eng.max_new, eng.device
    cast = eng.cast_params(params)
    eager_launches = dict.fromkeys(ops.launch_counts(), 0)

    def clone(tree):
        return tree_map(torch.clone, tree)

    def admit_args(admit):
        mask = np.isin(np.arange(slots), admit)
        rows = {k: np.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v, 0).astype(v.dtype)
                for k, v in prompts.items()}
        return ({k: torch.from_numpy(v).to(dev) for k, v in rows.items()},
                torch.from_numpy(mask).to(dev),
                torch.from_numpy(np.where(mask, max_new, 0).astype(np.int32)).to(dev))

    def counted(fn):
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for key, n in ops.launch_counts().items():
            eager_launches[key] += n - before[key]
        return out

    def equal(xs, ys):
        xs, ys = tree_leaves(xs), tree_leaves(ys)
        return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))

    def in_flight(caches, *rest):
        """Slots 0 and 1 of a state: cache leaves [L, B, ...], pos and the
        per-slot vectors [B], out [B, chunk]."""
        segs = [t[:, :2] for t in tree_leaves(caches["segments"])]
        return segs + [caches["pos"][:2]] + [t[:2] for t in rest]

    tokens = [[] for _ in range(slots)]
    checks = {"admit_one_launch": [], "admit_graph_equals_eager": [],
              "in_flight_equal_to_plain_decode": None}
    ptrs, script = set(), [[0, 1], None, [2, 3]]
    state = eng.init_state()
    for r in range(64):
        admit = script[r] if r < len(script) else None
        if admit is None:
            *state, out, n = eng.decode(params, *state)
            first = None
        else:
            a = admit_args(admit)
            snap = clone(tuple(state))
            if r > 0:
                checks["depth_at_second_admission"] = state[0]["pos"][:2].tolist()
            launches = eng.graph_launches["admit_decode"]
            *state, first, out, n = eng.admit_decode(params, *state, *a)
            torch.cuda.synchronize()
            checks["admit_one_launch"].append(
                eng.graph_launches["admit_decode"] == launches + 1)
            want = counted(lambda: eng._admit_decode_inner(cast, *clone(snap), *a))
            (wc, wt, wa, wr, *_), (wf, wo, wn) = want
            checks["admit_graph_equals_eager"].append(
                equal((*state, first, out, n), (wc, wt, wa, wr, wf, wo, wn)))
            if r > 0 and batch_independent:
                (pc, pt, pa, pr), (po, pn) = counted(
                    lambda: eng._decode_loop(cast, *clone(snap)))
                checks["in_flight_equal_to_plain_decode"] = equal(
                    in_flight(pc, pt, pa, pr, po, pn), in_flight(wc, wt, wa, wr, wo, wn))
        ptrs.add(tuple(t.data_ptr() for t in tree_leaves(tuple(state))))
        out_np, act_np = out.cpu().numpy(), state[2].cpu().numpy()
        first_np = None if first is None else first.cpu().numpy()
        for s in range(slots):
            if first_np is not None and first_np[s] != PAD_TOKEN:
                tokens[s].append(int(first_np[s]))
            tokens[s].extend(int(t) for t in out_np[s] if t != PAD_TOKEN)
        if r >= len(script) - 1 and not act_np.any():
            break
    require(all(checks["admit_one_launch"]), f"{eng.cfg.name}: an admission was not one "
            f"graph launch")
    require(all(checks["admit_graph_equals_eager"]), f"{eng.cfg.name}: the graphed "
            "admit_decode differs from the eager one")
    if batch_independent:
        require(checks["in_flight_equal_to_plain_decode"], f"{eng.cfg.name}: the admission "
                "changed the in-flight slots against a plain decode round")
    else:
        checks["in_flight_equal_to_plain_decode"] = (
            "not checked: the in-flight slots' tokens share the experts' capacity with the "
            "admitted ones, in the reference too")
    require(len(ptrs) == 1, f"{eng.cfg.name}: a round moved the state to other buffers "
            "(a cache copy between rounds)")
    require(eng.prefill.calls == 0, f"{eng.cfg.name}: prefill ran as its own dispatch")
    # the admission merges into the shared buffers in place and its decode
    # writes the K/V there: its graph's closing copies move no more than a
    # decode round's (pos, tok, active, rem and the SSM conv and state,
    # which each step makes anew)
    tail = {key[0]: g.tail_bytes for key, g in eng._graphs.items()}
    require(tail["admit_decode"] == tail["decode"], f"{eng.cfg.name}: the admission graph "
            f"copies {tail['admit_decode']} bytes of state, a decode round {tail['decode']}")
    checks.update({"graph_tail_bytes": tail, "rounds": r + 1, "dispatches": eng.dispatches,
                   "admit_dispatches": eng.admit_decode.calls,
                   "graph_launches": eng.graph_launches, "state_buffer_sets": len(ptrs)})
    return tokens, checks, {k: n for k, n in eager_launches.items() if n}


def run_continuous(torch, seed: int, params, prompts, eng_c, eng_s, poisson=True):
    """Phase 17 (and 19 and 20) for one model: the scripted sequence on
    ``eng_c`` (chunk 8; ``prompts`` a dict of numpy rows, a slot's a row),
    then ``serve_continuous`` with 16 requests, as a t=0 burst and (with
    ``poisson``) at the Poisson rate whose mean gap is one measured
    decode round.  The kernels' counters are set to 0 just before and
    read just after (less the eager checks' launches).  Then each slot's
    tokens against serving its prompt alone in the same slot of ``eng_s``
    (as many slots, chunk 31), and the rounds' times.  ``eng_s`` None (a
    MoE config: a slot's tokens depend on its batch-mates through the
    experts' capacity, in the reference too): no serial comparison, and
    the scripted sequence does not hold the in-flight slots to a plain
    decode round."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve, serve_continuous
    from repro_torch.models.nn import tree_map

    cfg = eng_c.cfg
    shape = dict(slots=eng_c.slots, prompt_len=eng_c.prompt_len, max_new=eng_c.max_new,
                 chunk=eng_c.chunk)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    serial_check = eng_s is not None
    tokens, checks, eager = scripted_sequence(torch, eng_c, params, prompts,
                                              batch_independent=serial_check)
    setup_s = time.perf_counter() - t0
    # one round of each kind on the live buffers (every slot admitted)
    mask = torch.ones(shape["slots"], dtype=torch.bool, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in prompts.items()}
    new_rem = torch.full((shape["slots"],), shape["max_new"], dtype=torch.int32,
                         device="cuda")
    live = {"s": eng_c.init_state()}

    def admit_round():
        live["s"] = eng_c.admit_decode(params, *live["s"], batch, mask, new_rem)[:4]

    def decode_round():
        live["s"] = eng_c.decode(params, *live["s"])[:4]

    admit_round()
    times = {"admit_round_ms": events_ms(torch, admit_round, calls=5),
             "decode_round_ms": events_ms(torch, decode_round, calls=5)}
    runs = {}
    rates = [("burst", 0.0)] + ([("poisson", 1e3 / times["decode_round_ms"])]
                                if poisson else [])
    for name, rate in rates:
        syncs = eng_c.sync_points
        results, stats = serve_continuous(
            cfg, slots=shape["slots"], prompt_len=shape["prompt_len"],
            max_new=shape["max_new"], n_requests=CONT_REQUESTS, chunk=shape["chunk"],
            arrival_rate=rate, seed=seed, params=params, engine=eng_c)
        stats["sync_points"] -= syncs
        stats["arrival_rate_per_s"] = rate
        require(stats["sync_points"] == stats["dispatches"] and
                stats["prefill_dispatches"] == 0,
                f"{cfg.name} {name}: {stats['sync_points']} syncs, {stats['dispatches']} "
                f"dispatches, {stats['prefill_dispatches']} prefill dispatches")
        require(stats["total_tokens"] == CONT_REQUESTS * shape["max_new"]
                and len(results) == CONT_REQUESTS, f"{cfg.name} {name}: {stats}")
        require(stats["graph_launches"]["admit_decode"] == stats["admit_dispatches"] and
                stats["graph_launches"]["decode"] == stats["decode_dispatches"],
                f"{cfg.name} {name}: a round was not one graph launch: {stats}")
        runs[name] = stats
    torch.cuda.synchronize()
    launches = {k: n - eager.get(k, 0) for k, n in ops.launch_counts().items()}

    # each slot's tokens against serving its prompt alone in that slot (the
    # serial engine takes the weights eng_c cast: the same tensors)
    serial, serial_params = [], eng_c.cast_params(params)
    for s in range(shape["slots"] if serial_check else 0):
        rows = {k: np.zeros_like(v) for k, v in prompts.items()}
        for k, v in prompts.items():
            rows[k][s] = v[s]
        gen, stats = serve(cfg, batch=shape["slots"], prompt_len=shape["prompt_len"],
                           gen_len=shape["max_new"], params=serial_params, engine=eng_s,
                           batch_in={k: torch.from_numpy(v).cuda() for k, v in rows.items()})
        serial.append(gen[s].tolist())
        if s == shape["slots"] - 1:
            times["serial_prefill_ms"] = stats["prefill_s"] * 1e3
            times["serial_decode_ms_per_token"] = stats["decode_s"] * 1e3 / (
                shape["max_new"] - 1)
    for s in range(shape["slots"]):
        if serial_check:
            require(tokens[s] == serial[s], f"{cfg.name}: slot {s}'s continuous tokens "
                    f"differ from serving its prompt alone: {tokens[s]} != {serial[s]}")
        require(len(tokens[s]) == shape["max_new"] and all(0 <= t < cfg.vocab
                                                           for t in tokens[s]),
                f"{cfg.name}: slot {s}'s tokens {tokens[s]}: not {shape['max_new']} in the "
                "vocabulary")
    caches = live["s"][0]

    def zero_and_merge():
        eng_c.model.select_slots(mask, tree_map(torch.zeros_like, caches), caches,
                                 in_place=True)

    times["zero_and_merge_ms"] = events_ms(torch, zero_and_merge)
    return {"model": cfg.name, **shape, "setup_s": setup_s, "checks": checks,
            "continuous_equals_serial_bitwise": True if serial_check else (
                "not checked: serving a prompt alone is another batch, and a MoE config's "
                "tokens depend on their batch-mates through the experts' capacity, in the "
                "reference too"),
            "tokens_slot0": tokens[0][:8],
            "distinct_slot_rows": len({tuple(t) for t in tokens}),
            "times": times, "runs": runs, "eager_check_launches": eager,
            "launches": launches}, admit_round



def run_phase17(torch, seed: int, fk, rk, ref):
    """Phase 17: continuous serving of qwen1.5-0.5b, glm4-9b (with phase 9's
    resident and host-stepped serve first) and mamba2-2.7b at full width
    and depth.  Returns the phase's line, the flash and rmsnorm entries at
    the served shapes and the kernels' launches on the phase's paths."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine

    shape = CONT
    out, flash, norm = {}, [], []
    launches = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}

    def engines(cfg):
        kw = dict(slots=shape["slots"], prompt_len=shape["prompt_len"],
                  max_new=shape["max_new"])
        return (ServeEngine(cfg, chunk=shape["chunk"], **kw),
                ServeEngine(cfg, chunk=shape["max_new"] - 1, **kw))

    def prompts(cfg):
        return {"tokens": np.random.RandomState(seed + 17).randint(
            0, cfg.vocab, (shape["slots"], shape["prompt_len"])).astype(np.int32)}

    def held_routes(cfg, eng, kind):
        held = eng.captured_launches(kind)
        want = {"flash_attention_wgmma": cfg.n_layers, "flash_attention_cuda_core": 0}
        require({k: held.get(k, 0) for k in want} == want,
                f"{cfg.name}: the {kind} graph holds flash launches {held}, not "
                f"{cfg.n_layers} on the tensor-core route and none on the CUDA-core route")
        return held

    def free():
        """An engine's dispatch wrappers hold its bound methods, a cycle:
        collect it before the next model's weights are drawn."""
        gc.collect()
        torch.cuda.empty_cache()

    def count(report, kernels):
        for k in kernels:
            require(report["launches"][k] > 0, f"{report['model']}: {k} never launched "
                    f"on the continuous path: {report['launches']}")
            launches[k] += report["launches"][k]

    # (a) qwen1.5-0.5b
    free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen1.5-0.5b")
    eng_c, eng_s = engines(cfg)
    params = eng_c.model.init(seed)
    report, admit_round = run_continuous(torch, seed, params, prompts(cfg), eng_c, eng_s)
    count(report, ("flash_attention", "rmsnorm"))
    report["admit_graph_holds"] = held_routes(cfg, eng_c, "admit_decode")
    report["profile_admit_round"] = profile_calls(torch, admit_round, calls=3)
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    f, n = served_shape_checks(torch, cfg, eng_c.cast_params(params),
                               torch.from_numpy(prompts(cfg)["tokens"]).cuda(), fk, rk, ref)
    flash.append(f)
    norm.append(n)
    out["qwen1.5-0.5b"] = report
    del eng_c, eng_s, params, admit_round
    free()

    # (b) glm4-9b: phase 9's serve, then the continuous path on the same weights
    torch.cuda.reset_peak_memory_stats()
    cfg, eng, params, batch_in, runs, setup_s, served = run_serve(
        torch, seed, "glm4-9b", GLM_SERVE)
    held_routes(cfg, eng, "prefill")
    require(served["flash_attention"] > 0 and served["rmsnorm"] > 0,
            f"a kernel never launched serving glm4: {served}")
    serve_line = serve_report(torch, cfg, eng, GLM_SERVE, runs, setup_s, served)
    checks = check_serving(torch, eng, params, batch_in, runs, GLM_SERVE)
    eager = checks["eager_prefill_launches"]
    require(eager.get("flash_attention_wgmma", 0) == cfg.n_layers and
            not eager.get("flash_attention_cuda_core", 0),
            f"the eager glm4 prefill took flash routes {eager}")
    launches["flash_attention"] += served["flash_attention"]
    launches["rmsnorm"] += served["rmsnorm"]
    cast = eng.cast_params(params)
    eng_c, eng_s = engines(cfg)
    report, admit_round = run_continuous(torch, seed, cast, prompts(cfg), eng_c, eng_s)
    count(report, ("flash_attention", "rmsnorm"))
    report["admit_graph_holds"] = held_routes(cfg, eng_c, "admit_decode")
    report["serve"], report["serve_checks"] = serve_line, checks
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    f, n = served_shape_checks(torch, cfg, cast,
                               torch.from_numpy(prompts(cfg)["tokens"]).cuda(), fk, rk, ref)
    flash.append(f)
    norm.append(n)
    out["glm4-9b"] = report
    del eng, params, batch_in, runs, cast, eng_c, eng_s, admit_round
    free()

    # (c) mamba2-2.7b
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mamba2-2.7b")
    eng_c, eng_s = engines(cfg)
    params = eng_c.model.init(seed)
    report, admit_round = run_continuous(torch, seed, params, prompts(cfg), eng_c, eng_s)
    count(report, ("ssd_scan", "rmsnorm"))
    held = report["admit_graph_holds"] = eng_c.captured_launches("admit_decode")
    require(held["ssd_scan_wgmma"] == cfg.n_layers == held["ssd_scan"],
            f"the mamba2 admit graph holds SSD launches {held}, not {cfg.n_layers} on the "
            "tensor-core route")
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["mamba2-2.7b"] = report
    del eng_c, eng_s, params, admit_round
    free()
    return out, flash, norm, launches

def expected_prefill_launches(cfg) -> dict:
    """One eager prefill's kernel launches, reckoned from the config: per
    layer, the norms (``attn_mlp`` and ``attn_moe`` 2, ``ssm`` 2 with the
    gated norm, ``hybrid`` 4, ``dec_cross`` 3, and 2 a self or cross
    attention with qk-norm, 2 an MLA attention: its q and kv norms), a
    flash launch a self or cross attention and an SSD launch an SSM head;
    the final norm and the encoder's.  Flash (at MLA's head-dim pair where
    the config has it) and the SSD scan by route
    (``kernels/*.py:route``)."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer as tfm
    from repro_torch.models.nn import dtype_of

    norms = {"attn_mlp": 2, "attn_moe": 2, "ssm": 2, "hybrid": 4, "dec_cross": 3}
    flashes = {"attn_mlp": 1, "attn_moe": 1, "ssm": 0, "hybrid": 1, "dec_cross": 2}
    scans = {"attn_mlp": 0, "attn_moe": 0, "ssm": 1, "hybrid": 1, "dec_cross": 0}
    segs = tfm.plan_segments(cfg)
    if cfg.enc_dec:
        segs = segs + tfm.plan_segments(cfg, decoder=False)
    n_flash = sum(s.n_layers * flashes[s.kind] for s in segs)
    n_scan = sum(s.n_layers * scans[s.kind] for s in segs)
    n_norm = (1 + int(cfg.enc_dec) + 2 * n_flash * int(cfg.qk_norm or cfg.use_mla)
              + sum(s.n_layers * norms[s.kind] for s in segs))
    dt = dtype_of(cfg.dtype)
    flash_route = fk.route(dt, *head_dims(cfg))
    scan_route = ssd.route(dt, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)
    out = {"flash_attention": n_flash, "rmsnorm": n_norm, "ssd_scan": n_scan}
    for kernel, n, route, routes in (("flash_attention", n_flash, flash_route,
                                      ("wgmma", "cuda_core")),
                                     ("ssd_scan", n_scan, scan_route, ssd.ROUTES)):
        out.update({f"{kernel}_{r}": n if r == route else 0 for r in routes})
    return out


def head_dims(cfg):
    """(q/k head dim, v head dim) of a config's attention: MLA's pair, or
    the one head dim twice."""
    if cfg.use_mla:
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.resolved_head_dim(), cfg.resolved_head_dim()


def sdpa_kernels(torch, fn) -> list:
    """The names of the kernels one call of ``fn`` launches (SDPA's
    backend shows in them).  Late in a run ``torch.profiler`` at times
    returns a window without kernel records: up to 5 windows are tried."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key[:120] for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.device_time_total > 0}
        if names:
            break
    return sorted(names)


def flash_entry(torch, fk, ref, tag, model, q, k, v, causal, window, scale=None,
                softcap=None):
    """A served-shape flash entry: the kernel (one launch on the
    tensor-core route) against its plain version, timed cold beside the
    plain version and SDPA (the same function: at these shapes a window
    never binds where SDPA is asked).

    Bound: :func:`bf16_close`'s one bf16 rounding, with its 1e-6 for
    float32 reassociation near zero widened to the worst case of a
    float32 sum of Skv terms, ``Skv 2^-24`` of the terms' magnitude (the
    attention of ``|v|``; phase 8's SSD bound has the same form).  Near
    zero an output of 1500 terms of magnitude ~0.6 moves by ~1e-6 under
    reassociation: 4 of whisper's 7.7 M encoder outputs do, where SDPA
    moves 44 908 beyond one rounding (``PERF.md`` §6).  How many outputs
    lie beyond one rounding alone is recorded."""
    import torch.nn.functional as F

    kw = dict(causal=causal, window=window, scale=scale, logit_softcap=softcap)
    before = fk.launch_counts()
    got = fk.flash_attention(q, k, v, **kw)
    after = fk.launch_counts()
    require(after["flash_attention_wgmma"] - before["flash_attention_wgmma"] == 1,
            f"{tag}: flash did not take the tensor-core route")
    want = ref.attention(q, k, v, **kw)
    B, Hq, Sq, D = q.shape
    Skv, Dv = k.shape[2], v.shape[3]
    vabs = ref.attention(q.float(), k.float(), v.float().abs(), **kw)
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rounding = 2.0 ** -8 * (g.abs() + w.abs()) + 1e-6
    tol = rounding + Skv * 2.0 ** -24 * vabs
    used = float((d / tol).max())
    err = float(d.max())
    require(bool((d <= tol).all()), f"{tag}: flash_attention != plain beyond one bf16 "
            f"rounding and a float32 sum's (max abs err {err}, bound used {used})")
    beyond_rounding = int((d > rounding).sum())
    del vabs, g, w, d, rounding, tol
    pairs = attention_pairs(Sq, Skv, Skv - Sq, window) if causal else Sq * Skv

    def sdpa(*qkv):
        return F.scaled_dot_product_attention(*qkv, is_causal=causal and Sq > 1,
                                              enable_gqa=True, scale=scale)

    library, sdpa_names, extra = None, None, {}
    if window is None or window >= Skv:
        sdpa_names = sdpa_kernels(torch, lambda: sdpa(q, k, v))
        if softcap is None:
            library = cold_calls(torch, sdpa, q, k, v)
        else:
            # SDPA has no soft-cap: not the same function, so not the library
            # time; the time of the same call without the cap, for scale
            extra["sdpa_without_softcap_ms"] = median_ms(torch, cold_calls(torch, sdpa,
                                                                          q, k, v))
    row = kernel_row(
        torch, "flash_attention", "flash_attention.cu", err,
        cold_calls(torch, lambda *qkv: fk.flash_attention(*qkv, **kw), q, k, v),
        cold_calls(torch, lambda *qkv: ref.attention(*qkv, **kw), q, k, v),
        library, 2 * (q.numel() + k.numel() + v.numel() + got.numel()),
        2 * B * Hq * (D + Dv) * pairs, BF16_OPS_PER_S, plain_reps=(5, 4))
    return {"model": model, "shape": tag, "q": list(q.shape), "kv": list(k.shape),
            "v": list(v.shape), "group": Hq // k.shape[1], "causal": causal,
            "window": window, "softcap": softcap, "bound_used": used,
            "outputs_beyond_one_rounding": beyond_rounding, "outputs": got.numel(),
            "sdpa_kernels": sdpa_names, **extra,
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}


def hymba_kernel_checks(torch, eng, params, batch_in, fk, rk, ssd, ref):
    """Phase 19 (a): flash, the SSD scan and rmsnorm against their plain
    versions on hymba's served layer 0 (the prefill's input: 128 meta
    tokens and the 512-token prompts); the SSD scan on its N-16
    tensor-core route, the CUDA-core kernel timed on the same inputs.
    Returns the flash and norm entries, the SSD entries and the N-16
    route's kernels-line row (the prefill's call, no initial state)."""
    from repro_torch.models import nn, ssm as ssm_lib, transformer as tfm

    cfg, model = eng.cfg, eng.model
    cast = eng.cast_params(params)
    p = tfm.unbind_layers(cast["decoder"]["segments"][0], cfg.n_layers)[0]
    x, _ = model._decoder_input(cast, batch_in)
    S = x.shape[1]
    window, theta = tfm.layer_window_theta(cfg, 0)
    h = nn.apply_rmsnorm(p["ln_attn"], x, cfg)
    q, k, v = (t.transpose(1, 2) for t in nn.attention_qkv(
        p["attn"], h, cfg, rope_theta=theta, positions=torch.arange(S, device="cuda")))
    # the window of 1024 never binds over 640 keys: the global layers' function
    flash = [flash_entry(torch, fk, ref, f"hymba layer 0 (window {window} of {S} keys: "
                         "the global layers' function)", cfg.name, q, k, v, True, window)]
    norm = [norm_entry(torch, rk, ref, "hymba ln_attn", cfg.name, x, p["ln_attn"]["scale"],
                       cfg.norm_eps)]
    # the SSD head's inputs, and the gated norm's
    hs = nn.apply_rmsnorm(p["ln_ssm"], x, cfg)
    z, xh, dt, A, Bm, C, _ = ssm_lib.scan_inputs(p["ssm"], hs, cfg)
    B_, S_, H, P = xh.shape
    G, N = Bm.shape[2:]
    require(ssd.route(xh.dtype, P, N, cfg.ssm_chunk) == "wgmma_n16",
            f"hymba's scan routes to {ssd.route(xh.dtype, P, N, cfg.ssm_chunk)}")
    scans, n16_row = [], None
    y0, h_end = ssd.ssd_scan(xh, dt, A, Bm, C, chunk=cfg.ssm_chunk, return_state=True)
    for tag, h0 in (("hymba layer 0", None),
                    ("hymba layer 0, init_state (the prompt's end state)", h_end)):
        before = ssd.launch_counts()
        y, hl = ssd.ssd_scan(xh, dt, A, Bm, C, init_state=h0, chunk=cfg.ssm_chunk,
                             return_state=True)
        after = ssd.launch_counts()
        moved = {k: v - before[k] for k, v in after.items() if v != before[k]}
        require(moved == {"ssd_scan": 1, "ssd_scan_wgmma_n16": 1},
                f"{tag}: the scan took {moved}, not one launch on the N-16 tensor-core route")
        detail = served_ssd_bound(torch, ref, y, hl, xh, dt, A, Bm, C, h0)
        flops, n_bytes = ssd_flops_bytes(B_, S_, H, P, G, N, cfg.ssm_chunk, 2, h0 is not None)
        args = (xh, dt, A, Bm, C) + ((h0,) if h0 is not None else ())

        def kernel(x_, dt_, A_, B__, C_, *h):
            return ssd.ssd_scan(x_, dt_, A_, B__, C_, init_state=h[0] if h else None,
                                chunk=cfg.ssm_chunk, return_state=True)

        def plain(x_, dt_, A_, B__, C_, *h):
            return ref.ssd_scan(x_, dt_, A_, B__, C_, init_state=h[0] if h else None,
                                return_state=True)

        # bound at the bf16 tensor-core peak (the inputs' type)
        row = kernel_row(torch, "ssd_scan_n16", "ssd_scan.cu", detail["y_max_abs_err"],
                         cold_calls(torch, kernel, *args), cold_calls(torch, plain, *args),
                         None, n_bytes, flops, BF16_OPS_PER_S, plain_reps=(3, 2))
        # the CUDA-core kernel, the route's kernel before the N-16 one
        row["cuda_core_ms"] = median_ms(torch, cold_calls(
            torch, lambda *a: cuda_core_ssd(torch, *a[:5], a[5] if len(a) > 5 else None),
            *args))
        scans.append({"model": cfg.name, "shape": tag, "x": list(xh.shape),
                      "B": list(Bm.shape), "init_state": h0 is not None,
                      "kernel_route": "wgmma_n16", "flops": flops, "bytes": n_bytes,
                      "float32_ops_bound_ms": flops / FP32_OPS_PER_S * 1e3,
                      "parts": list(ssd.PARTS_N16), "cluster": ssd.default_cluster(S_, N),
                      **detail, **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms",
                                                              "cuda_core_ms")}})
        if h0 is None:
            n16_row = {**row, "kernel_route": "wgmma_n16", "shape": list(xh.shape),
                       "state_dim": N}
    yg = (y0 + xh * p["ssm"]["D"][None, None, :, None].to(y0.dtype)).reshape(B_, S_, H * P)
    g = yg * torch.nn.functional.silu(z.float()).to(yg.dtype)
    norm.append(norm_entry(torch, rk, ref, "hymba gated norm", cfg.name, g,
                           p["ssm"]["norm"], cfg.norm_eps))
    return flash, norm, scans, n16_row


def whisper_kernel_checks(torch, eng, params, batch_in, fk, rk, ref):
    """Phase 19 (b): flash and rmsnorm against their plain versions on
    whisper's served layers: the encoder's layer 0 over the 1500 frames
    (not causal), the decoder's layer 0 self-attention over the prompt,
    its cross attention over the encoder output, and one decode query's."""
    from repro_torch.models import nn, transformer as tfm
    from repro_torch.models.frontends import apply_frontend, sinusoidal_positions

    cfg, model = eng.cfg, eng.model
    cast = eng.cast_params(params)
    pe = tfm.unbind_layers(cast["encoder"]["segments"][0], cfg.n_enc_layers)[0]
    pd = tfm.unbind_layers(cast["decoder"]["segments"][0], cfg.n_layers)[0]
    xe = apply_frontend(cast["frontend"], batch_in["audio_embeds"], cfg)
    xe = xe + sinusoidal_positions(xe.shape[1], cfg.d_model, xe.dtype, device="cuda")[None]
    he = nn.apply_rmsnorm(pe["ln_attn"], xe, cfg)
    qe, ke, ve = (t.transpose(1, 2) for t in nn.attention_qkv(
        pe["attn"], he, cfg, rope_theta=None,
        positions=torch.arange(xe.shape[1], device="cuda")))
    flash = [flash_entry(torch, fk, ref, "whisper encoder layer 0", cfg.name, qe, ke, ve,
                         False, None)]
    norm = [norm_entry(torch, rk, ref, "whisper encoder ln_attn", cfg.name, xe,
                       pe["ln_attn"]["scale"], cfg.norm_eps)]
    enc_out = model._encode(cast, batch_in["audio_embeds"])
    x = model._embed_tokens(cast, batch_in["tokens"])
    pos = torch.arange(x.shape[1], device="cuda")
    h = nn.apply_rmsnorm(pd["ln_attn"], x, cfg)
    q, k, v = (t.transpose(1, 2) for t in nn.attention_qkv(
        pd["attn"], h, cfg, rope_theta=None, positions=pos))
    flash.append(flash_entry(torch, fk, ref, "whisper decoder self layer 0", cfg.name,
                             q, k, v, True, None))
    norm.append(norm_entry(torch, rk, ref, "whisper decoder ln_attn", cfg.name, x,
                           pd["ln_attn"]["scale"], cfg.norm_eps))
    a, _ = nn.apply_attention(pd["attn"], h, cfg, positions=pos)
    hc = nn.apply_rmsnorm(pd["ln_cross"], x + a, cfg)
    qc, kc, vc = (t.transpose(1, 2) for t in nn.attention_qkv(
        pd["cross"], hc, cfg, rope_theta=None, positions=pos, kv_x=enc_out))
    flash.append(flash_entry(torch, fk, ref, "whisper cross layer 0", cfg.name, qc, kc, vc,
                             False, None))
    flash.append(flash_entry(torch, fk, ref, "whisper cross at decode (Sq 1)", cfg.name,
                             qc[:, :, -1:], kc, vc, False, None))
    return flash, norm


def internvl2_smoke(torch, seed: int):
    """Phase 19 (c): internvl2-76b's full-size parameter shapes on the meta
    device against a count reckoned from its config; its smoke model
    (float32, the CUDA-core routes) served on the card with a 16-patch
    vision prefix, resident and host-stepped, equal to the CPU's serve of
    the same weights, the graphed prefill equal to eager and
    ``forward_logits`` bit for bit, the capacity and ``pos`` counting the
    prefix."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch
    from repro_torch.models import Model
    from repro_torch.models.nn import tree_leaves, tree_map

    full = get_config("internvl2-76b")
    shapes = Model(full).abstract_init()
    require(all(t.device.type == "meta" for t in tree_leaves(shapes)),
            "internvl2-76b's abstract_init allocated memory")
    d, hd, f = full.d_model, full.resolved_head_dim(), full.d_ff
    layer = (2 * d + d * hd * (2 * full.n_heads + 2 * full.n_kv_heads) + 3 * d * f)
    want = (2 * full.vocab * d + d + full.n_layers * layer
            + full.frontend_dim * d + d * d)
    total = sum(t.numel() for t in tree_leaves(shapes))
    require(total == want, f"internvl2-76b: {total} parameters, the config gives {want}")
    require(tuple(shapes["frontend"]["proj_in"].shape) == (full.frontend_dim, d),
            "internvl2-76b's vision projector shape")

    cfg = full.smoke()
    shape = dict(batch=4, prompt_len=32, gen_len=8)
    params = Model(cfg).init(seed, device="cpu")
    batch = synthetic_batch(cfg, np.random.RandomState(seed), 4, 32, device="cpu")
    cpu, _ = serve(cfg, params=params, batch_in=batch, device="cpu", **shape)
    params = tree_map(lambda t: t.cuda(), params)
    batch = {k: v.cuda() for k, v in batch.items()}
    eng = ServeEngine(cfg, slots=4, prompt_len=32, max_new=8, chunk=7)
    require(eng.capacity == cfg.frontend_tokens + 32 + 8,
            f"internvl2 smoke: capacity {eng.capacity} leaves out the vision prefix")
    runs = {}
    for resident in (True, False, True, False):
        gen, stats = serve(cfg, params=params, batch_in=batch, engine=eng,
                           device_resident=resident, **shape)
        runs["resident" if resident else "host_stepped"] = (gen, stats, {}, {})
    for mode, (gen, _, _, _) in runs.items():
        require(np.array_equal(gen, cpu), f"internvl2 smoke {mode}: card tokens {gen} != "
                f"the CPU's {cpu}")
    checks = check_serving(torch, eng, params, batch, runs, shape)
    held = eng.captured_launches("prefill")
    want_held = expected_prefill_launches(cfg)
    require({k: held.get(k, 0) for k in want_held} == want_held,
            f"internvl2 smoke: the prefill graph holds {held}, the config gives {want_held}")
    pos = eng.prefill(params, batch, eng.init_state()[0])[1]["pos"]
    require(pos.tolist() == [cfg.frontend_tokens + 32] * 4, f"internvl2 smoke: pos {pos}")
    return {"model": cfg.name, "full_size_parameters": total, **shape,
            "capacity": eng.capacity, "prefill_graph_holds": held, "tokens_equal_cpu": True,
            "tokens_row0": cpu[0].tolist(), "serve_checks": checks}


def run_phase19(torch, seed: int, fk, rk, ssd, ref):
    """Phase 19: hymba-1.5b and whisper-large-v3 served at full width and
    depth (resident, host-stepped, continuously), the kernels at their
    served shapes, internvl2-76b's smoke and full-size shapes.  Returns the
    phase's line, the flash, rmsnorm and SSD served-shape entries, and the
    kernels' launches on the phase's serving paths."""
    import gc

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeEngine, synthetic_batch

    out, flash, norm, scans, n16_row = {}, [], [], [], None
    launches = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0, "ssd_scan_wgmma_n16": 0}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for arch, shape in (("hymba-1.5b", HYMBA_SERVE), ("whisper-large-v3", WHISPER_SERVE)):
        free()
        torch.cuda.reset_peak_memory_stats()
        cfg, eng, params, batch_in, runs, setup_s, served = run_serve(torch, seed, arch,
                                                                      shape)
        want = expected_prefill_launches(cfg)
        held = eng.captured_launches("prefill")
        require({k: held.get(k, 0) for k in want} == want,
                f"{arch}: the prefill graph holds {held}, the config gives {want}")
        serve_line = serve_report(torch, cfg, eng, shape, runs, setup_s, served)
        # every slot emits its own tokens, so that a slot mix-up would show in
        # the checks against serial serving below
        rows = {tuple(r) for r in runs["resident"][0].tolist()}
        require(len(rows) == shape["batch"],
                f"{arch}: {len(rows)} distinct token rows of {shape['batch']} slots")
        # one eager prefill, the counters set to 0 just before it
        cast = eng.cast_params(params)
        caches = eng.init_state()[0]
        torch.cuda.synchronize()
        reset_all_launches()
        eng.model.prefill(cast, batch_in, caches)
        torch.cuda.synchronize()
        eager = ops.launch_counts()
        require({k: eager.get(k, 0) for k in want} == want,
                f"{arch}: an eager prefill launched {eager}, the config gives {want}")
        print(json.dumps({"launches_reckoned": {"model": arch, "config_gives": want,
                                                "eager_prefill": eager}}), flush=True)
        checks = check_serving(torch, eng, params, batch_in, runs, shape)
        for k in launches:
            launches[k] += served[k]
        if cfg.hybrid:
            # every SSD launch of hymba's serving on the N-16 tensor-core route
            require(served["ssd_scan_wgmma_n16"] == served["ssd_scan"] > 0
                    and served["ssd_scan_cuda_core"] == 0,
                    f"{arch}: serving launched the SSD scan {served}, not all on the N-16 "
                    "tensor-core route")
        print_profiles(torch, eng, params, batch_in, "_" + arch.split("-")[0])
        if cfg.hybrid:
            f, n, sc, n16_row = hymba_kernel_checks(torch, eng, params, batch_in, fk, rk, ssd,
                                                    ref)
            scans += sc
        else:
            f, n = whisper_kernel_checks(torch, eng, params, batch_in, fk, rk, ref)
        flash += f
        norm += n
        # continuous serving on the same weights
        kw = dict(slots=shape["batch"], prompt_len=shape["prompt_len"],
                  max_new=shape["gen_len"])
        eng_c = ServeEngine(cfg, chunk=FAMILY_CHUNK, **kw)
        eng_s = ServeEngine(cfg, chunk=shape["gen_len"] - 1, **kw)
        prompts = {k: v.cpu().numpy() for k, v in synthetic_batch(
            cfg, np.random.RandomState(seed + 19), shape["batch"],
            shape["prompt_len"]).items()}
        report, _ = run_continuous(torch, seed, cast, prompts, eng_c, eng_s, poisson=False)
        require(report["distinct_slot_rows"] == shape["batch"],
                f"{arch}: {report['distinct_slot_rows']} distinct continuous token rows of "
                f"{shape['batch']} slots")
        for k in launches:
            if want[k]:
                require(report["launches"][k] > 0, f"{arch}: {k} never launched on the "
                        f"continuous path: {report['launches']}")
            launches[k] += report["launches"][k]
        held = eng_c.captured_launches("admit_decode")
        require(held["flash_attention_wgmma"] >= want["flash_attention"] and
                held["ssd_scan"] >= want["ssd_scan"],
                f"{arch}: the admission graph holds {held}")
        if cfg.hybrid:
            require(report["launches"]["ssd_scan_wgmma_n16"] == report["launches"]["ssd_scan"]
                    and report["launches"]["ssd_scan_cuda_core"] == 0
                    and held["ssd_scan_wgmma_n16"] == held["ssd_scan"]
                    and held["ssd_scan_cuda_core"] == 0,
                    f"{arch}: continuous serving's SSD launches {report['launches']} and the "
                    f"admission graph's {held}: not all on the N-16 tensor-core route")
        report.update({"admit_graph_holds": held, "serve": serve_line,
                       "serve_checks": checks,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[arch] = report
        print(json.dumps({"family_summary": {
            "model": arch, **shape,
            "prefill_ms": serve_line["resident"]["prefill_ms"],
            "decode_ms_per_token": {m: serve_line[m]["decode_ms_per_token"]
                                    for m in ("resident", "host_stepped")},
            "continuous_burst": {k: report["runs"]["burst"][k]
                                 for k in ("tok_per_s", "p50_ms", "p99_ms")},
            "card": gpu_line()}}), flush=True)
        del eng, params, batch_in, runs, cast, caches, eng_c, eng_s
    free()
    out["internvl2-76b"] = internvl2_smoke(torch, seed)
    free()
    require(n16_row is not None, "phase 19: no N-16 SSD row")
    n16_row["launches"] = launches["ssd_scan_wgmma_n16"]
    return out, flash, norm, scans, launches, n16_row


#: the MoE layer's parts, timed by ``torch.profiler`` ranges in phase 20
MOE_PARTS = ("_route", "_dispatch", "_expert_ffn", "_combine")


def moe_profile(torch, fn, calls: int = 1) -> dict:
    """Device time of ``calls`` eager calls of ``fn`` (after one warm-up)
    by part: the MoE layers' routing, dispatch (sort, plan, gather), expert
    ``bmm``s and combine (each a ``torch.profiler`` range around the
    ``models/moe.py`` function of that name, patched in for the window
    only), flash attention and the norms (by kernel name), the rest; the
    window's wall time and the device's idle share in it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe

    saved = {name: getattr(moe, name) for name in MOE_PARTS}

    def ranged(name, f):
        def call(*args, **kwargs):
            with record_function("moe" + name):
                return f(*args, **kwargs)
        return call

    fn()
    torch.cuda.synchronize()
    for name, f in saved.items():
        setattr(moe, name, ranged(name, f))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, f in saved.items():
            setattr(moe, name, f)
    events = prof.key_averages()
    ranges = {"moe" + name for name in MOE_PARTS}
    # the ranges also show on the device's timeline (as annotations, not
    # kernels); a part's time is that of the kernels launched within its
    # range on the host
    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
               and e.key not in ranges]
    busy = sum(t for _, t, _ in kernels)
    parts = {name.strip("_"): sum(e.device_time_total / 1e3 for e in events
                                  if e.key == "moe" + name
                                  and e.device_type == torch.autograd.DeviceType.CPU)
             for name in MOE_PARTS}
    parts["flash"] = sum(t for k, t, _ in kernels if "flash" in k)
    parts["norms"] = sum(t for k, t, _ in kernels if "rmsnorm" in k)
    parts["other"] = busy - sum(parts.values())
    kernels.sort(key=lambda k: -k[1])
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms) if kernels else None,
            "by_part_ms": parts,
            "top": [{"kernel": k[:90], "ms": t, "count": c} for k, t, c in kernels[:12]]}


def moe_cut(arch: str):
    """``arch``'s config cut in depth (``MOE_CUTS``) with bf16 parameters."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), param_dtype="bfloat16", **MOE_CUTS[arch])


def moe_kernel_checks(torch, eng, params, batch_in, fk, rk, ref):
    """Phase 20 (b): flash attention and rmsnorm against their plain
    versions on the served layer 0: deepseek-v3's MLA (q and k at 192, v
    at 128, the strided view of the expanded K/V, scale 192^-0.5) and its
    norms at d 7168, 1536 (q) and 512 (kv, a strided view); grok-1's GQA
    48/8 at 128 with its soft-cap and output multiplier, and its norm at
    d 6144."""
    from repro_torch.models import nn, transformer as tfm

    cfg, model = eng.cfg, eng.model
    cast = eng.cast_params(params)
    p = tfm.unbind_layers(cast["decoder"]["segments"][0], tfm.plan_segments(cfg)[0].n_layers)[0]
    x, _ = model._decoder_input(cast, batch_in)
    S = x.shape[1]
    pos = torch.arange(S, device="cuda")
    h = nn.apply_rmsnorm(p["ln_attn"], x, cfg)
    norm = [norm_entry(torch, rk, ref, f"{cfg.name} ln_attn", cfg.name, x,
                       p["ln_attn"]["scale"], cfg.norm_eps)]
    if cfg.use_mla:
        a = p["attn"]
        q_nope, q_rope, c_kv, k_rope = nn.mla_qkv(a, h, cfg, rope_theta=None, positions=pos)
        k, v = nn._expand_kv(a, c_kv, k_rope, cfg)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        D, Dv = head_dims(cfg)
        flash = [flash_entry(torch, fk, ref, f"deepseek-v3 layer 0 (MLA, q/k {D}, v {Dv})",
                             cfg.name, qq.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), True, None, scale=D ** -0.5)]
        ckv = h @ a["wkv_a"]
        norm += [norm_entry(torch, rk, ref, "deepseek-v3 q_norm", cfg.name, h @ a["wq_a"],
                            a["q_norm"], cfg.norm_eps),
                 norm_entry(torch, rk, ref, "deepseek-v3 kv_norm (a strided view)",
                            cfg.name, ckv[..., :cfg.kv_lora_rank], a["kv_norm"],
                            cfg.norm_eps)]
    else:
        q, k, v = (t.transpose(1, 2) for t in nn.attention_qkv(
            p["attn"], h, cfg, rope_theta=None, positions=pos))
        flash = [flash_entry(torch, fk, ref, "grok-1 layer 0 (GQA 48/8, soft-cap 30)",
                             cfg.name, q, k, v, True, None,
                             scale=cfg.attn_output_multiplier, softcap=cfg.attn_softcap)]
    return flash, norm


def leaf_paths(tree, prefix=""):
    """``(path, leaf)`` of a params tree, dicts and lists walked in order
    (the order of ``tree_leaves``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def moe_smoke(torch, seed: int, arch: str) -> dict:
    """Phase 20 (c): ``arch``'s full-size parameters on the meta device,
    counted against ``count_params`` (plus the leaves it does not count:
    the final norm, the MTP head's norms, MLA's q and kv norms, the
    routers' bias); its smoke model (float32) served on the card, resident
    and host-stepped, equal to the CPU's serve of the same weights, the
    graphed prefill equal to eager and ``forward_logits``' last row
    unembedded bit for bit (``check_serving``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch
    from repro_torch.models import Model
    from repro_torch.models.counting import count_params
    from repro_torch.models.nn import tree_leaves, tree_map

    full = get_config(arch)
    shapes = Model(full).abstract_init()
    require(all(t.device.type == "meta" for t in tree_leaves(shapes)),
            f"{arch}'s abstract_init allocated memory")

    total = sum(t.numel() for t in tree_leaves(shapes))
    uncounted = sum(t.numel() for path, t in leaf_paths(shapes)
                    if path.endswith(("q_norm", "kv_norm", "router_bias"))
                    or path == "/ln_final/scale"
                    or (path.startswith("/mtp/") and path.endswith("scale")))
    counted = count_params(full)
    require(total == counted + uncounted, f"{arch}: {total} parameters on the meta device, "
            f"count_params {counted} + {uncounted} uncounted")

    cfg = full.smoke()
    shape = dict(batch=4, prompt_len=32, gen_len=8)
    params = Model(cfg).init(seed, device="cpu")
    batch = synthetic_batch(cfg, np.random.RandomState(seed), 4, 32, device="cpu")
    cpu, _ = serve(cfg, params=params, batch_in=batch, device="cpu", **shape)
    params = tree_map(lambda t: t.cuda(), params)
    batch = {k: v.cuda() for k, v in batch.items()}
    eng = ServeEngine(cfg, slots=4, prompt_len=32, max_new=8, chunk=7)
    runs = {}
    for resident in (True, False, True, False):
        gen, stats = serve(cfg, params=params, batch_in=batch, engine=eng,
                           device_resident=resident, **shape)
        runs["resident" if resident else "host_stepped"] = (gen, stats, {}, {})
    for mode, (gen, _, _, _) in runs.items():
        require(np.array_equal(gen, cpu), f"{arch} smoke {mode}: card tokens {gen} != "
                f"the CPU's {cpu}")
    checks = check_serving(torch, eng, params, batch, runs, shape)
    held = eng.captured_launches("prefill")
    want_held = expected_prefill_launches(cfg)
    require({k: held.get(k, 0) for k in want_held} == want_held,
            f"{arch} smoke: the prefill graph holds {held}, the config gives {want_held}")
    return {"model": cfg.name, "full_size_parameters": total,
            "full_size_count_params": counted, "uncounted_leaves": uncounted,
            "full_size_count_params_b": round(counted / 1e9, 2), **shape,
            "prefill_graph_holds": held, "tokens_equal_cpu": True,
            "tokens_row0": cpu[0].tolist(), "serve_checks": checks}


def moe_dispatch_check(torch, seed: int) -> dict:
    """Phase 20 (d): ``build_moe_dispatch_program`` over 4 stacked ranks at
    deepseek-v3's prefill widths (``MOE_DISPATCH``, bf16) through
    FusedEngine, one graph launch, equal to the plain tiled all-to-all bit
    for bit; run again on its output it gives its input back (the
    combine).  Times of a launch and of the plain copy (CUDA events)."""
    from repro_torch import make_mesh
    from repro_torch.core import FusedEngine
    from repro_torch.models.moe import build_moe_dispatch_program

    n, E, C, D = (MOE_DISPATCH[k] for k in ("ranks", "experts", "capacity", "d_model"))
    cm = build_moe_dispatch_program(make_mesh((n,), ("x",)), "x", E, C, D,
                                    dtype=torch.bfloat16)
    rows = n * E * C
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((rows, D), generator=gen, device="cuda").to(torch.bfloat16)

    def plain(t):
        return t.reshape(n, n, rows // (n * n), D).transpose(0, 1).reshape(rows, D)

    eng = FusedEngine(cm.program, donate=True)
    init = eng.init_buffers({"x": x})
    out = eng(init)["out"].clone()
    require(eng.stats.dispatches == eng.graph_launches == 1,
            f"the MoE dispatch: {eng.stats}, {eng.graph_launches} graph launches")
    require(torch.equal(out, plain(x)), "the MoE dispatch differs from the plain tiled "
            "all-to-all")
    back = eng(eng.init_buffers({"x": out}))["out"]
    require(torch.equal(back, x), "the MoE dispatch run twice does not give its input back")
    row = {"ranks": n, "experts": E, "capacity": C, "d_model": D, "dtype": "bfloat16",
           "rows": rows, "bytes": rows * D * 2, "equal_to_plain_bitwise": True,
           "twice_gives_input": True, "launch_ms": events_ms(torch, lambda: eng(init)),
           "plain_ms": events_ms(torch, lambda: plain(x).contiguous()),
           "copy_bound_ms": 2 * rows * D * 2 / HBM_BYTES_PER_S * 1e3}
    del eng, init, out, back, x
    return row


def moe_continuous(torch, seed: int, cfg, params) -> dict:
    """Phase 20 (e): continuous serving of a cut MoE config on the weights
    phase 20 served (``CONT``: 4 slots, 512-token prompts, 32 tokens, chunk
    8) through :func:`run_continuous`: the scripted mixed-depth sequence
    (each admission one graph launch equal to the eager one bit for bit,
    outputs and every cache leaf; one set of state buffers), then 16
    requests as a t=0 burst.  Each admission prefills the whole batch at
    that call's capacity, so a slot's tokens depend on its batch-mates, as
    in the reference: they are not held to serial serving (the line says
    why).  The admission graph's flash launches are all on the
    tensor-core route."""
    import numpy as np

    from repro_torch.launch.serve import ServeEngine

    eng_c = ServeEngine(cfg, slots=CONT["slots"], prompt_len=CONT["prompt_len"],
                        max_new=CONT["max_new"], chunk=CONT["chunk"])
    prompts = {"tokens": np.random.RandomState(seed + 20).randint(
        0, cfg.vocab, (CONT["slots"], CONT["prompt_len"])).astype(np.int32)}
    report, admit_round = run_continuous(torch, seed, params, prompts, eng_c, None,
                                         poisson=False)
    held = report["admit_graph_holds"] = eng_c.captured_launches("admit_decode")
    require(held.get("flash_attention_wgmma") == cfg.n_layers
            and not held.get("flash_attention_cuda_core"),
            f"{cfg.name}: the admission graph holds flash launches {held}, not "
            f"{cfg.n_layers} on the tensor-core route")
    require(report["launches"]["flash_attention"] > 0 and report["launches"]["rmsnorm"] > 0,
            f"{cfg.name}: a kernel never launched on the continuous path: "
            f"{report['launches']}")
    del eng_c, admit_round
    return report


def run_phase20(torch, seed: int, fk, rk, ref):
    """Phase 20: the MoE family.  deepseek-v3-671b (MLA, 256 routed experts
    with a sigmoid router, a shared expert) and grok-1-314b (8 experts,
    soft-capped GQA) served uncut in width with bf16 parameters
    (``MOE_CUTS``, ``MOE_TRUNK_SCALE``), resident and host-stepped, with
    the checks of phases 7 and 19; flash and rmsnorm at their served
    shapes; the smoke models on the card equal to the CPU; the full sizes
    on the meta device; the expert-parallel dispatch program.  Returns the
    phase's line, the flash and rmsnorm entries and the kernels' launches
    on the serving paths."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.models.counting import count_params

    out, flash, norm = {}, [], []
    launches = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for arch in MOE_CUTS:
        free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cut = moe_cut(arch)
        cfg, eng, params, batch_in, runs, setup_s, served = run_serve(
            torch, seed, arch, MOE_SERVE, cfg=cut, scale=MOE_TRUNK_SCALE)
        want = expected_prefill_launches(cfg)
        held = eng.captured_launches("prefill")
        require({k: held.get(k, 0) for k in want} == want,
                f"{arch}: the prefill graph holds {held}, the config gives {want}")
        require(want["flash_attention_wgmma"] == cfg.n_layers,
                f"{arch}: flash not on the tensor-core route at {head_dims(cfg)}")
        serve_line = serve_report(torch, cfg, eng, MOE_SERVE, runs, setup_s, served)
        rows = {tuple(r) for r in runs["resident"][0].tolist()}
        require(len(rows) == MOE_SERVE["batch"],
                f"{arch}: {len(rows)} distinct token rows of {MOE_SERVE['batch']} slots")
        cast = eng.cast_params(params)
        caches = eng.init_state()[0]
        torch.cuda.synchronize()
        reset_all_launches()
        eng.model.prefill(cast, batch_in, caches)
        torch.cuda.synchronize()
        eager = ops.launch_counts()
        require({k: eager.get(k, 0) for k in want} == want,
                f"{arch}: an eager prefill launched {eager}, the config gives {want}")
        checks = check_serving(torch, eng, params, batch_in, runs, MOE_SERVE)
        for k in launches:
            launches[k] += served[k]
        caches, tok, _, _ = eng.init_state()
        pre_caches = eng.model.prefill(cast, batch_in, caches)[1]
        profiles = {
            "prefill": moe_profile(torch, lambda: eng.model.prefill(cast, batch_in, caches)),
            "decode_step": moe_profile(torch, lambda: eng.model.decode_step(cast, pre_caches,
                                                                            tok))}
        print(json.dumps({f"profile_moe_{arch.split('-')[0]}": profiles}), flush=True)
        print_profiles(torch, eng, params, batch_in, "_" + arch.split("-")[0])
        f, n = moe_kernel_checks(torch, eng, params, batch_in, fk, rk, ref)
        flash += f
        norm += n
        del eng, cast, caches, pre_caches
        free()
        cont = moe_continuous(torch, seed, cfg, params)
        for k in ("flash_attention", "rmsnorm"):
            launches[k] += cont["launches"][k]
        out[arch] = {"cut": MOE_CUTS[arch], "param_dtype": "bfloat16",
                     "first_tokens": runs["resident"][0][:, 0].tolist(),
                     "trunk_scale": MOE_TRUNK_SCALE, "parameters": count_params(cfg),
                     "parameters_b": round(count_params(cfg) / 1e9, 2),
                     "launches_reckoned": want, "eager_prefill": eager,
                     "serve": serve_line, "serve_checks": checks,
                     "distinct_slot_rows": len(rows), "continuous": cont,
                     "seconds": time.perf_counter() - t0}
        print(json.dumps({"moe_summary": {
            "model": arch, **MOE_SERVE, "cut": MOE_CUTS[arch],
            "parameters_b": out[arch]["parameters_b"],
            "prefill_ms": {m: serve_line[m]["prefill_ms"] for m in ("resident", "host_stepped")},
            "decode_ms_per_token": {m: serve_line[m]["decode_ms_per_token"]
                                    for m in ("resident", "host_stepped")},
            "peak_memory_gb": serve_line["peak_memory_gb"],
            "prefill_by_part_ms": profiles["prefill"]["by_part_ms"],
            "decode_by_part_ms": profiles["decode_step"]["by_part_ms"],
            "continuous_burst": {k: cont["runs"]["burst"][k] for k in
                                 ("tok_per_s", "p50_ms", "p99_ms", "dispatches",
                                  "sync_points", "admit_dispatches", "decode_dispatches")},
            "continuous_round_ms": {k: cont["times"][k] for k in
                                    ("admit_round_ms", "decode_round_ms")},
            "card": gpu_line()}}), flush=True)
        del params, batch_in, runs
    free()
    for arch in MOE_CUTS:
        out[arch]["smoke"] = moe_smoke(torch, seed, arch)
    free()
    out["dispatch_program"] = moe_dispatch_check(torch, seed)
    free()
    return out, flash, norm, launches


def grad_check(torch, got, want):
    """``got`` against the plain version's ``want`` within the backward
    kernels' bound (GRAD_RTOL of each entry plus GRAD_FRAC of the leaf's
    largest, plus 2^-8 of the magnitudes for a bf16 result): (share of
    the bound used, max abs err)."""
    g, w = got.float(), want.float()
    bound = GRAD_RTOL * w.abs() + GRAD_FRAC * float(w.abs().max()) + 1e-30
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * (g.abs() + w.abs())
    err = (g - w).abs()
    require(bool(torch.isfinite(g).all()), f"a non-finite gradient of shape {tuple(g.shape)}")
    return float((err / bound).max()), float(err.max())


def ssd_bwd_products(B, S, H, P, N, L, scores: int = 3):
    """Operations of the chunked backward at chunks of L rows.  Per chunk,
    over the causal triangle, L (L + 1) / 2 (scores N + (scores - 1) P)
    MACs: with ``scores`` 3, the function's scores B C^T and x dy^T and
    their three products with dy, C and B; with 4, the tensor-core
    kernel's, which also forms C B^T (for da's pairs) and dy x^T (for dC's
    layout).  Then the five L P N state products (the increments h_inc and
    u_inc, B U^T, x U, dy H0) and U.H0's P N.  Each product counted once,
    not once a bf16 part."""
    lens = [min(L, S - c0) for c0 in range(0, S, L)]
    return 2 * B * H * sum(n * (n + 1) // 2 * (scores * N + (scores - 1) * P)
                           + 5 * n * P * N + P * N for n in lens)


def ssd_bwd_flops_bytes(B, S, H, P, G, N, itemsize, h0: bool):
    """The least operations of the backward, and the bytes a call must
    move.  Operations: :func:`ssd_bwd_products` at the chunk of 16 to 128
    rows that needs the fewest (16: the smallest row tile of a bf16
    tensor-core product).  Bytes: x and dy in, dx out; dt in, ddt out; A
    in, dA out; B and C in, dB and dC out; with an initial state h0 and dh
    in, dh0 out."""
    flops = min(ssd_bwd_products(B, S, H, P, N, L) for L in (16, 32, 64, 128))
    n_bytes = (3 * B * S * H * P * itemsize        # x, dy in; dx out
               + 2 * B * S * H * 4 + 2 * H * 4     # dt in, ddt out; A, dA
               + 2 * 2 * B * S * G * N * itemsize  # B, C in; dB, dC out
               + (3 if h0 else 0) * B * H * P * N * 4)  # h0, dh in; dh0 out
    return flops, n_bytes


def norm_bwd_times(torch, rk, ref, xn, wn, dyn, eps: float) -> dict:
    """The RMSNorm backward at one shape (the model's eps, weight offset
    1): its time, the plain VJP's, autograd of ``F.rms_norm``'s backward
    (forward and backward in each captured call, the forward alone timed
    too: the backward's time is the difference; the weight w + 1 in bf16,
    so that PyTorch's own norm kernels run), the bound by bytes (x and dy
    read, dx written in bf16; w read, dw written in float32), and from
    ``torch.profiler`` over 5 calls (:func:`profile_calls`) the device ms
    of the row pass and of the dw pass apart.  A window this short at
    times comes back without its kernels' records (seen on the card: the
    launches listed, no kernel), so up to 5 windows are taken; None where
    none saw the pass."""
    d = xn.shape[-1]
    call = lambda: rk.rmsnorm_bwd(xn, wn, dyn, eps=eps, weight_offset=1.0)  # noqa: E731
    xl = xn.detach().requires_grad_()
    wl = (wn + 1.0).bfloat16().requires_grad_()

    def lib_fwd():
        return torch.nn.functional.rms_norm(xl, (d,), weight=wl, eps=eps)

    def lib_fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(lib_fwd(), (xl, wl), dyn)

    out = {"ms": median_ms(torch, call),
           "plain_ms": median_ms(torch, lambda: ref.rmsnorm_vjp(xn, wn, dyn, eps=eps,
                                                                weight_offset=1.0), 5, 5),
           "library_fwd_bwd_ms": median_ms(torch, lib_fwd_bwd),
           "bound_ms": (3 * xn.numel() * 2 + 2 * d * 4) / HBM_BYTES_PER_S * 1e3}
    with torch.no_grad():
        out["library_fwd_ms"] = median_ms(torch, lib_fwd)
    out["library_ms"] = out["library_fwd_bwd_ms"] - out["library_fwd_ms"]
    parts = (("row_pass_ms", "rmsnorm_bwd"), ("dw_pass_ms", "rmsnorm_dw"))
    for _ in range(5):
        top = profile_calls(torch, call, calls=5)["top"]
        seen = {part: [k["ms"] for k in top if name in k["kernel"]] for part, name in parts}
        if all(seen.values()):
            break
    out.update({part: sum(ms) / 5 if ms else None for part, ms in seen.items()})
    return out


def check_norm_bwd(torch, rk, ref, gen, shape, eps: float):
    """The RMSNorm backward at one of a model's training shapes (x and dy
    bf16 of ``shape``, w float32, the model's eps, weight offset 1): held
    to the plain VJP, two runs and a graph replay equal to eager bit for
    bit, then timed (:func:`norm_bwd_times`).  Returns the entry's key
    (rows x d and the route of ``bwd_plan``) and the entry."""
    d = shape[-1]
    xn = torch.randn(*shape, device="cuda", generator=gen).bfloat16()
    wn = 0.1 * torch.randn(d, device="cuda", generator=gen)
    dyn = torch.randn(*shape, device="cuda", generator=gen).bfloat16()
    call = lambda: rk.rmsnorm_bwd(xn, wn, dyn, eps=eps, weight_offset=1.0)  # noqa: E731
    got = call()
    want = ref.rmsnorm_vjp(xn, wn, dyn, eps=eps, weight_offset=1.0)
    rows = xn.numel() // d
    plan = rk.bwd_plan(rows, d, xn.dtype)
    key = f"{rows}x{d}_{plan.route}"
    used = {n_: grad_check(torch, g, w) for n_, g, w in zip(("dx", "dw"), got, want)}
    require(all(u <= 1.0 for u, _ in used.values()),
            f"rmsnorm_bwd {key}: beyond the bound {used}")
    again = call()
    require(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
            f"rmsnorm_bwd {key}: two runs differ")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(replayed[0], got[0]) and torch.equal(replayed[1], got[1]),
            f"rmsnorm_bwd {key}: a graph replay differs from eager")
    del graph, replayed, again, want
    return key, {**{k: {"bound_used": u, "max_abs_err": e} for k, (u, e) in used.items()},
                 "shape": list(shape), "eps": eps, "plan": plan._asdict(),
                 **norm_bwd_times(torch, rk, ref, xn, wn, dyn, eps)}


def check_backward_kernels(torch, ssd, rk, ref, seed: int):
    """Phase 18 (d): the two backward kernels against their plain VJPs at
    the training shapes; their kernel-table rows and the details."""
    gen = torch.Generator("cuda").manual_seed(seed + 18)
    B, S, H, G, P, N = TRAIN["batch"], TRAIN["seq"], 80, 1, 64, 128
    detail = {"bound": {"rtol": GRAD_RTOL, "leaf_max_share": GRAD_FRAC,
                        "bf16_outputs": "plus 2^-8 of |got| + |want|"}}
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")

    def held(got, want, key):
        used = {}
        for name, g, w in zip(names, got, want):
            require((g is None) == (w is None), f"ssd_scan_bwd {key}: {name} presence")
            if g is not None:
                used[name] = grad_check(torch, g, w)
                require(used[name][0] <= 1.0, f"ssd_scan_bwd {key}: {name} beyond the bound "
                        f"(share {used[name][0]:.3g})")
        detail[key] = {k: {"bound_used": u, "max_abs_err": e} for k, (u, e) in used.items()}
        return max(e for _, e in used.values())

    x, dt, A, Bm, C, h0 = served_ssd_inputs(torch, gen, B, S, H, G)
    dy = torch.randn(B, S, H, P, device="cuda", generator=gen).bfloat16()
    dh = torch.randn(B, H, P, N, device="cuda", generator=gen)
    wide = lambda *ts: [None if t is None else t.float() for t in ts]
    route = ssd.bwd_route(x.dtype, P, N)
    require(route == "wgmma", f"the served bf16 backward takes the {route} route")

    def routed(key, fn):
        """Run fn, recording the backward route it launched."""
        before = ssd.launch_counts()
        out = fn()
        after = ssd.launch_counts()
        taken = [r for r in ssd.ROUTES
                 if after[f"ssd_scan_bwd_{r}"] > before[f"ssd_scan_bwd_{r}"]]
        require(len(taken) == 1, f"ssd_scan_bwd {key}: routes launched {taken}")
        detail.setdefault("routes", {})[key] = taken[0]
        return out

    # the model's path: y only (the final state unused), no init_state
    want = ref.ssd_scan_vjp(*wide(x, dt, A, Bm, C), None, dy.float(), None)
    got = routed("served_bf16", lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy))
    err = held(got, want, "served_bf16")
    held(routed("served_bf16_init_dh",
                lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, init_state=h0, dy=dy, dh=dh)),
         ref.ssd_scan_vjp(*wide(x, dt, A, Bm, C, h0, dy, dh)), "served_bf16_init_dh")
    again = ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy)
    require(all(torch.equal(a, b) for a, b in zip(again, got) if a is not None),
            "ssd_scan_bwd: two runs differ")
    # the CUDA-core kernel, the route's kernel before the tensor-core one,
    # on the same inputs
    held(routed("served_bf16_cuda_core",
                lambda: ssd.ssd_scan_bwd_variant(x, dt, A, Bm, C, dy=dy, kernel="cuda_core")),
         want, "served_bf16_cuda_core")
    # float32 cases (the CUDA-core route) and, where the shape allows it, the
    # same in bf16 (the tensor-core route): a short last chunk, init_state
    # and dh, 2 groups; S 1100 spans two groups of chunks
    for case in [(2, 45, 4, 64, 2, 128, True), (2, 100, 4, 16, 1, 16, True),
                 (1, 33, 6, 32, 3, 64, False), (1, 1100, 4, 64, 1, 128, True)]:
        b, s_, h, p, g, n, init = case
        xs = torch.randn(b, s_, h, p, device="cuda", generator=gen)
        dts = torch.nn.functional.softplus(torch.randn(b, s_, h, device="cuda", generator=gen))
        As = -torch.rand(h, device="cuda", generator=gen) - 0.5
        Bs, Cs = (0.3 * torch.randn(b, s_, g, n, device="cuda", generator=gen) for _ in "BC")
        hs = torch.randn(b, h, p, n, device="cuda", generator=gen) if init else None
        dys = torch.randn(b, s_, h, p, device="cuda", generator=gen)
        dhs = torch.randn(b, h, p, n, device="cuda", generator=gen)
        name = "B{}_S{}_H{}_P{}_G{}_N{}_init{}".format(*case)
        if s_ < 1000:
            held(routed("float32_" + name,
                        lambda: ssd.ssd_scan_bwd(xs, dts, As, Bs, Cs, init_state=hs, dy=dys,
                                                 dh=dhs)),
                 ref.ssd_scan_vjp(xs, dts, As, Bs, Cs, hs, dys, dhs), "float32_" + name)
        if ssd.bwd_route(torch.bfloat16, p, n) == "wgmma":
            xb, Bb, Cb, dyb = (t.bfloat16() for t in (xs, Bs, Cs, dys))
            held(routed("bf16_" + name,
                        lambda: ssd.ssd_scan_bwd(xb, dts, As, Bb, Cb, init_state=hs, dy=dyb,
                                                 dh=dhs)),
                 ref.ssd_scan_vjp(*wide(xb, dts, As, Bb, Cb, hs, dyb, dhs)), "bf16_" + name)

    # the bound: the operands are bf16 and the products run on the bf16
    # tensor cores; the float32 CUDA-core time of the same products is kept
    # as a detail
    flops, n_bytes = ssd_bwd_flops_bytes(B, S, H, P, G, N, 2, False)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    xf, Bf, Cf, dyf = wide(x, Bm, C, dy)
    ssd_row = {
        "name": "ssd_scan_bwd", "route": "cuda", "kernel_route": route,
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan_bwd"], "pallas_counterpart": False,
        "max_abs_err": err,
        "ms": median_ms(torch, lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy), reps=5,
                        inner=3),
        "plain_ms": median_ms(torch, lambda: ref.ssd_scan_vjp(xf, dt, A, Bf, Cf, None, dyf,
                                                              None), reps=3, inner=1),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes the scan's VJP
        "cuda_core_ms": median_ms(
            torch, lambda: ssd.ssd_scan_bwd_variant(x, dt, A, Bm, C, dy=dy, kernel="cuda_core"),
            reps=5, inner=3),
    }
    detail["ssd_flops"], detail["ssd_bytes"] = flops, n_bytes
    detail["ssd_kernel_flops"] = ssd_bwd_products(B, S, H, P, N, 128, scores=4)
    detail["ssd_bytes_bound_ms"] = t_bytes * 1e3
    detail["ssd_float32_cuda_core_bound_ms"] = max(t_bytes, flops / FP32_OPS_PER_S) * 1e3

    # RMSNorm: the training shapes (the team route: the block and final
    # norms at d 2560, the gated norm at d 5120) and a rows-route shape, at
    # the model's eps: each held to the plain VJP, two runs and a graph
    # replay equal to eager bit for bit, then timed (norm_bwd_times)
    norm = {}
    for rows, d in ((B * S, 2560), (B * S, 5120), (4096, 1024)):
        key, entry = check_norm_bwd(torch, rk, ref, gen, (rows, d), 1e-5)
        norm[key] = entry
        if d == 5120:
            main_key, main_shape = key, [rows, d]
    detail["rmsnorm_bwd"] = norm
    t = norm[main_key]
    t_ops = 10 * main_shape[0] * main_shape[1] / FP32_OPS_PER_S * 1e3
    norm_row = {
        "name": "rmsnorm_bwd", "route": "cuda", "kernel_route": main_key.split("_")[-1],
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": REPLACES["rmsnorm_bwd"], "pallas_counterpart": False,
        "max_abs_err": max(v["max_abs_err"] for c in norm.values() for k, v in c.items()
                           if k in ("dx", "dw")),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": max(t["bound_ms"], t_ops),
        "bound_by": "bytes" if t["bound_ms"] >= t_ops else "operations",
        "library_ms": t["library_ms"], "library_fwd_bwd_ms": t["library_fwd_bwd_ms"],
        "library_fwd_ms": t["library_fwd_ms"],
        "library_call": ("torch.autograd.grad of F.rms_norm (weight w + 1 in bf16): "
                         "forward and backward less the forward alone"),
        "shape": main_shape,
        "training_shapes": {k: {n_: v[n_] for n_ in ("ms", "row_pass_ms", "dw_pass_ms",
                                                      "plain_ms", "library_ms", "bound_ms")}
                            for k, v in norm.items()}}
    return ssd_row, norm_row, detail


def run_phase18(torch, seed: int, ssd, rk, ref):
    """Phase 18: train mamba2-2.7b at full width and depth (see the module
    docstring); returns the phase's line, the two backward rows and the
    kernels' launches in one eager step."""
    import gc

    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models.nn import apply_embedding, tree_leaves
    from repro_torch.models.transformer import apply_stack
    from repro_torch.optim import AdamWConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"train_cut": {"model": "mamba2-2.7b", "batch": TRAIN["batch"],
                                    "seq": TRAIN["seq"], "reference_shape": "train_4k",
                                    "why": TRAIN_CUT}}), flush=True)
    # (b) and (c) hold one launch to eager bit for bit with deterministic
    # algorithms off: no backward of the step adds with float atomics
    require(not torch.are_deterministic_algorithms_enabled(),
            "phase 18: deterministic algorithms are on")
    cfg = get_config("mamba2-2.7b")
    shape = ShapeConfig("train_cut", TRAIN["seq"], TRAIN["batch"], "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    opt_cfg = AdamWConfig(lr=1e-3)
    bundle = st.build_train_step(cfg, shape, mesh, opt=opt_cfg, total_steps=100)
    source = SyntheticTokens(cfg, shape)
    n = TRAIN["steps"]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in source.batch(i).items()}
               for i in range(n)]
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    out = {"tokens_per_step": TRAIN["batch"] * TRAIN["seq"]}

    def fresh():
        params = bundle.model.init(seed)
        return params, adamw_init(params, opt_cfg)

    # (a) eager steps; step 1's gradients checked; step 2's launches
    t0 = time.perf_counter()
    params, opt = fresh()
    out["init_s"] = time.perf_counter() - t0
    out["param_count"] = sum(p.numel() for p in tree_leaves(params))
    grads, gmet = bundle.grad_fn(params, batches[0])
    bad = [i for i, g in enumerate(tree_leaves(grads))
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    require(not bad, f"phase 18: gradient leaves {bad} missing, non-finite or all zero")
    out["grad_leaves"] = len(tree_leaves(grads))
    params, opt, omet = bundle.apply_fn(params, opt, grads)  # in place: the same trees
    del grads
    eager_mets = [{**gmet, **omet}]
    step_ms = []
    for i in (1, 2):
        reset_all_launches()   # (e): the counts of step 2 alone
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = bundle.step_fn(params, opt, batches[i])
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        eager_mets.append(m)
        if i == 1:
            launches = {k: v for k, v in ops.launch_counts().items() if v}
    out["eager_step_launches"] = launches
    require(launches.get("ssd_scan_wgmma") == 2 * cfg.n_layers
            and launches.get("ssd_scan") == 2 * cfg.n_layers,
            f"an eager step's SSD forward launches {launches}: not {2 * cfg.n_layers} "
            f"(forward and recompute) all on the tensor-core route")
    require(launches.get("ssd_scan_bwd") == cfg.n_layers
            and launches.get("ssd_scan_bwd_wgmma") == cfg.n_layers
            and launches.get("ssd_scan_bwd_cuda_core", 0) == 0,
            f"an eager step's SSD backward launches {launches}: not {cfg.n_layers} all on "
            "the tensor-core route")
    require(launches.get("rmsnorm", 0) > 0 and launches.get("rmsnorm_bwd", 0) > 0,
            f"an eager step did not run the RMSNorm forward and backward kernels: {launches}")
    eager = {k: torch.stack([m[k] for m in eager_mets]) for k in eager_mets[0]}
    out["loss"] = eager["loss"].tolist()
    require(bool(torch.isfinite(eager["loss"]).all()), "phase 18: a non-finite loss")
    out["eager_ms_per_step"] = step_ms
    out["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    # the host-polled plateau over (a)'s steps: eps twice the first move
    eps = 2.0 * abs(out["loss"][1] - out["loss"][0])
    until = st.loss_plateau(eps)
    host_done = n
    for i in range(1, n + 1):
        if not bool(until({"loss": eager["loss"].cpu()}, i)):
            host_done = i
            break
    t0 = time.perf_counter()
    keep = {"state": [t.cpu() for t in tree_leaves((params, opt))],
            "mets": {k: v.cpu() for k, v in eager.items()}}
    out["host_copy_s"] = time.perf_counter() - t0
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same steps as ONE graph launch
    params, opt = fresh()
    multi = st.persistent_steps(bundle, n, stacked=True).step_fn
    t0 = time.perf_counter()
    params, opt, mets = multi(params, opt, stack)
    torch.cuda.synchronize()
    out["graph_setup_s"] = time.perf_counter() - t0
    require((multi.dispatches, multi.captures) == (1, 1), "phase 18: not one graph launch")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves((params, opt)),
                                                       keep["state"]))
    same_m = all(torch.equal(mets[k].cpu(), keep["mets"][k]) for k in keep["mets"])
    require(same and same_m, "phase 18: the one-launch steps differ from the eager steps")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    multi(params, opt, stack)
    stop.record()
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = start.elapsed_time(stop) / n
    out["tokens_per_s_graph"] = out["tokens_per_step"] / (out["graph_ms_per_step"] / 1e3)
    out["tokens_per_s_eager"] = out["tokens_per_step"] / (statistics.median(step_ms) / 1e3)
    out["peak_gb_graph"] = torch.cuda.max_memory_allocated() / 1e9
    del multi, params, opt, mets
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the loss plateau through the WHILE node
    params, opt = fresh()
    loop = st.persistent_steps(bundle, n, until=until, stacked=True).step_fn
    params, opt, mets = loop(params, opt, stack)
    done = int(mets["steps_done"])
    require(done == host_done < n, f"phase 18: the plateau loop ran {done} steps, host-polled "
            f"{host_done} (eps {eps:.3g}, bound {n})")
    require(torch.equal(mets["loss"][:done].cpu(), keep["mets"]["loss"][:done]),
            "phase 18: the plateau loop's loss trace differs from the eager steps'")
    out["plateau"] = {"eps": eps, "steps_done": done, "host_polled_steps_done": host_done,
                      "bound": n, "loss": mets["loss"][:done].tolist()}
    del loop, params, opt, mets, keep
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the backward kernels against their plain versions
    ssd_row, norm_row, detail = check_backward_kernels(torch, ssd, rk, ref, seed)
    out["backward_checks"] = detail
    gc.collect()
    torch.cuda.empty_cache()

    # (f) where a step's time goes: one eager step,
    # forward / backward / optimizer by CUDA events and the top kernels
    # from torch.profiler; the recompute inside the backward as the time
    # of the layer stack's forward without autograd (what each
    # checkpointed layer runs again), by CUDA events
    from torch.profiler import ProfilerActivity, profile
    params, opt = fresh()
    for i in range(2):  # the second eager step timed
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        bundle.step_fn(params, opt, batches[i])
        stop.record()
        torch.cuda.synchronize()
    out["eager_ms_per_step_nondeterministic"] = start.elapsed_time(stop)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, _ = bundle.model.loss(st._rebuild(params, live), batches[1])
            ev[1].record()
            grads = torch.autograd.grad(loss, live)
        ev[2].record()
        bundle.apply_fn(params, opt, st._rebuild(params, list(grads)))
        ev[3].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    fwd, bwd, optim = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    with torch.no_grad():
        x_in = apply_embedding(params["embed"], batches[1]["tokens"], cfg)
        positions = torch.arange(x_in.shape[1], device=x_in.device)
        rec = []
        for _ in range(2):  # the second timed
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            apply_stack(params["decoder"], x_in, cfg, positions=positions)
            b.record()
            torch.cuda.synchronize()
            rec.append(a.elapsed_time(b))
    rec = rec[-1]
    norm_bwd = [(t, c) for k, t, c in kernels if "rmsnorm_bwd" in k or "rmsnorm_dw" in k]
    out["profile"] = {
        "rmsnorm_bwd_ms": sum(t for t, _ in norm_bwd),
        "rmsnorm_bwd_kernel_launches": sum(c for _, c in norm_bwd),
        "forward_ms": fwd, "backward_ms_with_recompute": bwd, "optimizer_ms": optim,
        "recompute_ms_no_grad_stack": rec, "backward_ms_less_recompute": bwd - rec,
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1 - busy / wall_ms) if kernels else None,
        "top": [{"kernel": k[:90], "ms": t, "count": c} for k, t, c in kernels[:14]]}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["card"] = gpu_line()
    del params, opt, grads, live, loss, x_in
    gc.collect()
    torch.cuda.empty_cache()
    return out, [ssd_row, norm_row], launches


def flash_bwd_inputs(torch, gen, dtype, B, Hq, Hkv, Sq, Skv, D, Dv):
    """q, k, v and dO for the flash backward in the model's layout: [B,S,H,D]
    tensors passed as [B,H,S,D] views."""
    def mk(S, H, d):
        return torch.randn(B, S, H, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)

    return mk(Sq, Hq, D), mk(Skv, Hkv, D), mk(Skv, Hkv, Dv), mk(Sq, Hq, Dv)


def cuda_core_flash_bwd(torch, q, k, v, o32, lse, dout, causal=True, scale=None,
                        window=None, logit_softcap=None, q_offset=0):
    """The CUDA-core flash backward (the port's backward before the
    tensor-core one; the route rule now gives it float32 and the small
    pairs) on bf16 inputs, through its C entry point: its time at the
    training shapes is the flash backward row's ``earlier_ms``."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Skv, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Skv, Hkv, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ts = (q, k, v, dout, o32, dq, dk, dv)
    err = load_library("flash_attention", fk.SIGNATURES).rt_flash_attention_bwd(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o32.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, Dv, *[st for t in ts for st in t.stride()[:3]],
        D ** -0.5 if scale is None else float(scale),
        0.0 if logit_softcap is None else float(logit_softcap), int(bool(causal)),
        -1 if window is None else int(window), int(q_offset), stream_arg(q))
    check_launch("flash_attention", err)
    return dq, dk, dv


def sdpa_grad_times(torch, q, k, v, do, **kw) -> dict:
    """Autograd of ``F.scaled_dot_product_attention`` (``enable_gqa``):
    forward and backward, the forward alone, their difference (the
    library's backward time), each timed as the kernels are
    (:func:`median_ms`: calls captured into a CUDA graph, so no host time
    counts), and the kernels a call launches (the backend)."""
    import torch.nn.functional as F

    ins = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*ins, enable_gqa=True, **kw)

    def fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(fwd(), ins, do)

    both = median_ms(torch, fwd_bwd, reps=5, inner=5)
    with torch.no_grad():
        alone = median_ms(torch, fwd, reps=5, inner=5)
    return {"ms": both - alone, "fwd_bwd_ms": both, "fwd_ms": alone,
            "kernels": sdpa_kernels(torch, fwd_bwd)}


def flash_bwd_case(torch, fk, ref, gen, name, dt, B, Hq, Hkv, Sq, Skv, D, Dv, kw):
    """The flash backward at one case: one counted launch of the route
    ``route()`` gives, held to ``ref.attention_vjp`` within the backward
    kernels' bound, two calls equal bit for bit, rows that see no key
    zero.  Returns the case's detail, its errors and its inputs."""
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, do = flash_bwd_inputs(torch, gen, dtype, B, Hq, Hkv, Sq, Skv, D, Dv)
    out, o32, lse = fk.forward_with_lse(q, k, v, **kw)
    which = fk.route(dtype, D, Dv)
    before = dict(fk.launch_counts())
    got = fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    after = fk.launch_counts()
    counted = {key: after[key] - before[key] for key in after if after[key] != before[key]}
    require(counted == {"flash_attention_bwd": 1, f"flash_attention_bwd_{which}": 1},
            f"flash_attention_bwd {name}: not one counted launch of the {which} route: "
            f"{counted}")
    want = ref.attention_vjp(*(t.float() for t in (q, k, v, do)), **kw)
    used = {n: grad_check(torch, g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    require(all(u <= 1.0 for u, _ in used.values()),
            f"flash_attention_bwd {name}: beyond the bound {used}")
    again = fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    require(all(torch.equal(a, b) for a, b in zip(again, got)),
            f"flash_attention_bwd {name}: two calls differ")
    if kw.get("q_offset", 0) < 0:
        blind = -kw["q_offset"]
        require(bool((got[0][:, :, :blind] == 0).all()) and bool(torch.isneginf(
            lse[:, :, :blind]).all()), f"flash_attention_bwd {name}: rows that see no "
            "key have a gradient or a finite L")
    detail = {"dtype": dt, "q": list(q.shape), "kv": list(k.shape), "Dv": Dv, **kw,
              "route": which,
              **{n: {"bound_used": u, "max_abs_err": e} for n, (u, e) in used.items()}}
    return detail, [e for _, e in used.values()], (q, k, v, do, o32, lse, kw)


def flash_bwd_times(torch, fk, ref, q, k, v, do, o32, lse, kw) -> dict:
    """The flash backward's time on one input beside the CUDA-core
    backward, the plain VJP, autograd of SDPA (the same function but for
    a soft-cap) and its bound."""
    B, Hq, Sq, D = q.shape
    Skv, Dv = k.shape[2], v.shape[3]
    causal = kw.get("causal", True)
    pairs = (attention_pairs(Sq, Skv, kw.get("q_offset", 0), kw.get("window")) if causal
             else Sq * Skv)
    n_ops = 2 * (3 * D + 2 * Dv) * B * Hq * pairs
    n_bytes = 2 * 2 * (q.numel() + k.numel() + v.numel() + do.numel())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_OPS_PER_S
    sdpa_kw = {"scale": kw["scale"]} if "scale" in kw else {}
    if "window" in kw:
        idx = torch.arange(Sq, device="cuda")
        sdpa_kw["attn_mask"] = ((idx[None, :] <= idx[:, None])
                                & (idx[None, :] > idx[:, None] - kw["window"]))
    else:
        sdpa_kw["is_causal"] = causal
    lib = sdpa_grad_times(torch, q, k, v, do, **sdpa_kw)
    times = {
        "route": fk.route(q.dtype, D, Dv),
        "ms": median_ms(torch, lambda: fk.flash_attention_bwd(q, k, v, o32, lse, do, **kw),
                        reps=5, inner=5),
        "earlier_ms": median_ms(
            torch, lambda: cuda_core_flash_bwd(torch, q, k, v, o32, lse, do, **kw),
            reps=5, inner=5),
        "plain_ms": median_ms(torch, lambda: ref.attention_vjp(q, k, v, do, **kw), 3, 2),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gflop": n_ops / 1e9, "mbytes": n_bytes / 1e6,
        "forward_ms": median_ms(torch, lambda: fk.forward_with_lse(q, k, v, **kw), 5, 5),
        "library_ms": lib["ms"], "library_fwd_bwd_ms": lib["fwd_bwd_ms"],
        "library_fwd_ms": lib["fwd_ms"], "sdpa_kernels": lib["kernels"]}
    if "logit_softcap" in kw:  # SDPA has no soft-cap: timed without it, not the function
        times["library_ms_without_cap"] = times.pop("library_ms")
        times["library_ms"] = None
    return times


def check_flash_backward(torch, fk, ref, seed: int):
    """Phase 21 (a): the flash backward against ``ref.attention_vjp`` at
    each of ``FLASH_BWD_CASES`` (:func:`flash_bwd_case`), then its row of
    the kernels line at gemma3's global layer and its times at the local
    one."""
    gen = torch.Generator("cuda").manual_seed(seed + 21)
    detail = {"bound": {"rtol": GRAD_RTOL, "leaf_max_share": GRAD_FRAC,
                        "bf16_outputs": "plus 2^-8 of |got| + |want|"}}
    kept, errs = {}, []
    for name, *case in FLASH_BWD_CASES:
        if name in PHASE25_FLASH_BWD:
            continue
        detail[name], case_errs, inputs = flash_bwd_case(torch, fk, ref, gen, name, *case)
        errs += case_errs
        if name in FLASH_BWD_TIMED:
            kept[name] = inputs
        del inputs

    # the row: gemma3's global layer; the local layer, grok's and MLA's
    # shapes as details; each beside the CUDA-core backward on its input
    times = {name: flash_bwd_times(torch, fk, ref, *inputs) for name, inputs in kept.items()}
    g = times["gemma3_global"]
    row = {"name": "flash_attention_bwd", "route": "cuda", "kernel_route": g["route"],
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": REPLACES["flash_attention_bwd"], "pallas_counterpart": False,
           "max_abs_err": max(errs), "ms": g["ms"], "plain_ms": g["plain_ms"],
           "bound_ms": g["bound_ms"], "bound_by": g["bound_by"], "library_ms": g["library_ms"],
           "library_call": ("torch.autograd.grad of F.scaled_dot_product_attention("
                            "is_causal=True, enable_gqa=True): forward and backward less "
                            "the forward alone, each in captured graphs"),
           "library_fwd_bwd_ms": g["library_fwd_bwd_ms"], "library_fwd_ms": g["library_fwd_ms"],
           "sdpa_kernels": g["sdpa_kernels"], "shape": [4, 4, 1, 1024, 256],
           "earlier_ms": g["earlier_ms"], "local_layer": times["gemma3_local"],
           "other_shapes": {n: t for n, t in times.items() if not n.startswith("gemma3_")}}
    detail["times"] = times
    return row, detail


def profile_train_step(torch, bundle, params, opt, batch) -> dict:
    """One eager step (gradients, and AdamW unless ``opt`` is None) under
    ``torch.profiler``: forward, backward (with the checkpoints'
    recompute) and AdamW by CUDA events, every kernel's device time, the
    window's wall time and the device's idle share.  A late profiler
    window at times has no kernel records: up to 5 are taken."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as st
    from repro_torch.models.nn import tree_leaves

    for attempt in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ev[0].record()
            live = [p.detach().requires_grad_() for p in tree_leaves(params)]
            with torch.enable_grad():
                loss, _ = bundle.model.loss(st._rebuild(params, live), batch)
                ev[1].record()
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True)
            ev[2].record()
            if opt is not None:
                bundle.apply_fn(params, opt, st._rebuild(params, list(grads)))
            ev[3].record()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_time_total > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        del live, grads, loss
        if kernels:
            break
    busy = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    fwd, bwd, optim = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    return {"forward_ms": fwd, "backward_ms_with_recompute": bwd,
            "optimizer_ms": optim if opt is not None else None,
            "wall_ms": wall_ms, "device_busy_ms": busy, "windows": attempt + 1,
            "idle_share": max(0.0, 1 - busy / wall_ms) if kernels else None,
            "kernel_launches": sum(c for _, _, c in kernels), "kernels": kernels}


def run_phase21(torch, seed: int, fk, rk, ref):
    """Phase 21: train gemma3-1b at full width and depth (see the module
    docstring); returns the phase's line, the flash backward's row, the
    RMSNorm backward's entries at gemma3's training shapes and the
    kernels' launches in one eager step."""
    import gc

    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models.nn import apply_embedding, tree_leaves
    from repro_torch.models.transformer import apply_stack, layer_window_theta
    from repro_torch.optim import AdamWConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, n = DENSE_TRAIN["batch"], DENSE_TRAIN["seq"], DENSE_TRAIN["steps"]
    print(json.dumps({"train_cut": {"model": "gemma3-1b", "batch": B, "seq": S,
                                    "reference_shape": "train_4k",
                                    "why": DENSE_TRAIN_CUT}}), flush=True)
    cfg = get_config("gemma3-1b")
    windows = [layer_window_theta(cfg, i)[0] for i in range(cfg.n_layers)]
    shape = ShapeConfig("train_cut", S, B, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    opt_cfg = AdamWConfig(lr=1e-3)
    bundle = st.build_train_step(cfg, shape, mesh, opt=opt_cfg, total_steps=100)
    source = SyntheticTokens(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in source.batch(i).items()}
               for i in range(n)]
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    out = {"tokens_per_step": B * S, "layers": cfg.n_layers,
           "global_layers": [i for i, w in enumerate(windows) if w == 0],
           "window": cfg.sliding_window, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype}
    require(sum(w == 0 for w in windows) == 4 and set(windows) == {0, 512},
            f"gemma3-1b's layer windows {windows}")

    def fresh():
        params = bundle.model.init(seed)
        return params, adamw_init(params, opt_cfg)

    # (b) eager steps; step 0's gradients checked; step 1's launches
    t0 = time.perf_counter()
    params, opt = fresh()
    out["init_s"] = time.perf_counter() - t0
    out["param_count"] = sum(p.numel() for p in tree_leaves(params))
    grads, gmet = bundle.grad_fn(params, batches[0])
    bad = [i for i, g in enumerate(tree_leaves(grads))
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    require(not bad, f"phase 21: gradient leaves {bad} missing, non-finite or all zero")
    out["grad_leaves"] = len(tree_leaves(grads))
    params, opt, omet = bundle.apply_fn(params, opt, grads)
    del grads
    eager_mets = [{**gmet, **omet}]
    step_ms = []
    for i in range(1, n):
        reset_all_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = bundle.step_fn(params, opt, batches[i])
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        eager_mets.append(m)
        if i == 1:
            launches = {k: v for k, v in ops.launch_counts().items() if v}
    out["eager_step_launches"] = launches
    L = cfg.n_layers
    require(launches.get("flash_attention") == launches.get("flash_attention_wgmma") == 2 * L
            and launches.get("flash_attention_cuda_core", 0) == 0,
            f"an eager step's flash forward launches {launches}: not {2 * L} (forward and "
            "recompute) all on the tensor-core route")
    require(launches.get("flash_attention_bwd") == launches.get("flash_attention_bwd_wgmma") == L
            and launches.get("flash_attention_bwd_cuda_core", 0) == 0,
            f"an eager step's flash backward launches {launches}: not {L} all on the "
            "tensor-core route")
    require(launches.get("rmsnorm_bwd", 0) >= 4 * L + 1
            and launches.get("rmsnorm") == 2 * launches["rmsnorm_bwd"] - 1,
            f"an eager step's RMSNorm launches {launches}: not every norm (the qk-norms "
            "included) forward twice under the checkpoint and backward once")
    eager = {k: torch.stack([m[k] for m in eager_mets]) for k in eager_mets[0]}
    out["loss"] = eager["loss"].tolist()
    require(bool(torch.isfinite(eager["loss"]).all()), "phase 21: a non-finite loss")
    out["eager_ms_per_step"] = step_ms
    out["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    keep = {"state": [t.cpu() for t in tree_leaves((params, opt))],
            "mets": {k: v.cpu() for k, v in eager.items()}}
    out["host_copy_s"] = time.perf_counter() - t0
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same steps as ONE graph launch
    params, opt = fresh()
    multi = st.persistent_steps(bundle, n, stacked=True).step_fn
    t0 = time.perf_counter()
    params, opt, mets = multi(params, opt, stack)
    torch.cuda.synchronize()
    out["graph_setup_s"] = time.perf_counter() - t0
    require((multi.dispatches, multi.captures) == (1, 1), "phase 21: not one graph launch")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves((params, opt)),
                                                       keep["state"]))
    same_m = all(torch.equal(mets[k].cpu(), keep["mets"][k]) for k in keep["mets"])
    require(same and same_m, "phase 21: the one-launch steps differ from the eager steps")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    multi(params, opt, stack)
    stop.record()
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = start.elapsed_time(stop) / n
    out["dispatches_per_step_graph"] = 1 / n
    out["tokens_per_s_graph"] = out["tokens_per_step"] / (out["graph_ms_per_step"] / 1e3)
    out["tokens_per_s_eager"] = out["tokens_per_step"] / (statistics.median(step_ms) / 1e3)
    out["peak_gb_graph"] = torch.cuda.max_memory_allocated() / 1e9
    del multi, params, opt, mets, keep
    gc.collect()
    torch.cuda.empty_cache()

    # (c) where an eager step's time goes: forward / backward (with the
    # recompute) / AdamW by CUDA events, the kernels by torch.profiler, the
    # recompute as a no-grad run of the layer stack
    params, opt = fresh()
    bundle.step_fn(params, opt, batches[0])
    torch.cuda.synchronize()
    prof = profile_train_step(torch, bundle, params, opt, batches[1])
    kernels, busy = prof.pop("kernels"), prof["device_busy_ms"]
    with torch.no_grad():
        x_in = apply_embedding(params["embed"], batches[1]["tokens"], cfg)
        positions = torch.arange(S, device=x_in.device)
        rec = events_ms(torch, lambda: apply_stack(params["decoder"], x_in, cfg,
                                                   positions=positions), 1)
    flash_bwd = [(t, c) for k, t, c in kernels if "flash_bwd" in k]
    flash_fwd = [(t, c) for k, t, c in kernels if "flash_wgmma" in k]
    out["profile"] = {
        **prof, "recompute_ms_no_grad_stack": rec,
        "backward_ms_less_recompute": prof["backward_ms_with_recompute"] - rec,
        "flash_bwd_ms": sum(t for t, _ in flash_bwd),
        "flash_bwd_kernel_launches": sum(c for _, c in flash_bwd),
        "flash_bwd_share_of_busy": sum(t for t, _ in flash_bwd) / busy if busy else None,
        "flash_fwd_ms": sum(t for t, _ in flash_fwd),
        "top": [{"kernel": k[:90], "ms": t, "count": c} for k, t, c in kernels[:14]]}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, x_in
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the flash backward against its plain version; its kernels-line row
    row, detail = check_flash_backward(torch, fk, ref, seed)
    out["flash_backward_checks"] = detail

    # (a) the RMSNorm backward at the step's shapes, the model's eps: the
    # pre- and post-norms (4096 x 1152, over the rows route's width) and
    # the q- and k-norms (16384 x 256 and 4096 x 256)
    gen = torch.Generator("cuda").manual_seed(seed + 121)
    hd = cfg.resolved_head_dim()
    norms = dict(check_norm_bwd(torch, rk, ref, gen, shape, cfg.norm_eps)
                 for shape in ((B, S, cfg.d_model), (B, S, cfg.n_heads, hd),
                               (B, S, cfg.n_kv_heads, hd)))
    out["rmsnorm_backward_checks"] = norms
    out["card"] = gpu_line()
    gc.collect()
    torch.cuda.empty_cache()
    return out, row, norms, launches


def plain_moe_backwards(torch, dxin, dy, yout, w, slot, keep):
    """The MoE dispatch's and combine's backwards written plainly, from
    ``dispatch_plan``'s ``slot`` and ``keep`` (in ``w``'s order): gathers,
    then an explicit loop over each token's assignments in ascending
    expert order (``dx``; a token's slots in ascending order are its
    experts in ascending order), each filled slot written by its one kept
    assignment (``dyout``) and a row product per assignment (``dw``)."""
    T, k = w.shape
    order = torch.sort(slot.view(T, k), dim=1, stable=True)[1]
    dx = None
    for j in range(k):
        a = torch.arange(T, device=w.device) * k + order[:, j]
        term = torch.where(keep[a, None], dxin[slot[a]], 0)
        dx = term if dx is None else dx + term
    kept = keep.nonzero()[:, 0]
    dyout = torch.zeros_like(yout)
    dyout[slot[kept]] = dy[kept // k] * w.reshape(-1)[kept, None].to(dy.dtype)
    dw = (dy.repeat_interleave(k, 0) * yout[slot]).view(T, k, -1).sum(-1).float()
    return dx, dyout, torch.where(keep.view(T, k), dw, 0)


def moe_layer_check(torch, cfg, p, seed: int) -> dict:
    """Phase 22 (c): one MoE layer alone, on its real parameters ``p`` and
    an activation of the step's shape [2048, D] (seeded, ``cfg.dtype``).
    Forward and backward twice (deterministic algorithms off): the output, dx and every trained leaf's gradient (the
    router, the experts, the shared expert) equal bit for bit, the first
    run's on the host while the second runs.  Then the parts one by one,
    detached at their bounds: the dispatch's and the combine's gradients
    against :func:`plain_moe_backwards` bit for bit, and route, dispatch,
    experts and combine timed forward and backward, each alone
    (:func:`events_ms`)."""
    from repro_torch.models import moe
    from repro_torch.models.nn import dtype_of

    T, D, E = MOE_TRAIN["batch"] * MOE_TRAIN["seq"], cfg.d_model, cfg.n_experts
    C = max(1, int(math.ceil(T * cfg.top_k / E * cfg.capacity_factor)))
    gen = torch.Generator("cuda").manual_seed(seed + 22)
    x = torch.randn(1, T, D, device="cuda", generator=gen).to(dtype_of(cfg.dtype))
    dy = torch.randn(1, T, D, device="cuda", generator=gen).to(x.dtype)
    trained = [k for k in p if k not in ZERO_GRAD_LEAVES]
    first, equal = None, {}
    for _ in range(2):
        live = {k: v.detach().requires_grad_(k in trained) for k, v in p.items()}
        xl = x.detach().requires_grad_()
        y, aux = moe.apply_moe(live, xl, cfg)
        grads = torch.autograd.grad((y, aux["lb_loss"]), [xl] + [live[k] for k in trained],
                                    (dy, torch.ones_like(aux["lb_loss"])))
        got = dict(zip(["y", "x"] + trained, [y.detach(), *grads]))
        dropped = float(aux["dropped_frac"])
        del grads, y, aux, live, xl
        if first is None:
            first = {k: t.cpu() for k, t in got.items()}
        else:
            equal = {k: torch.equal(t.cpu(), first[k]) for k, t in got.items()}
        del got
    require(all(equal.values()), f"{cfg.name}: the MoE layer's forward and backward "
            f"differ between two runs with deterministic algorithms off: {equal}")
    del first

    # the parts, detached at their bounds: each part's forward and
    # backward timed alone (events_ms: a warm call, then the median of 3)
    x2d, dy2d = x.view(T, D), dy.view(T, D)
    live = {k: v.detach().requires_grad_(k in trained) for k, v in p.items()}
    experts = [live[k] for k in ("wi", "wg", "wo") if k in live]
    xr, xd = x2d.detach().requires_grad_(), x2d.detach().requires_grad_()
    idx, w, _ = moe._route(live, xr, cfg)
    xin, plan = moe._dispatch(xd, idx, E, C)
    xin_d = xin.detach().requires_grad_()
    yout = moe._expert_ffn(live, xin_d, cfg).reshape(E * C, D)
    yd, wd = yout.detach().requires_grad_(), w.detach().requires_grad_()
    y = moe._combine(yd, wd, plan)
    dyout, dw = torch.autograd.grad(y, (yd, wd), dy2d, retain_graph=True)
    dxin = torch.autograd.grad(yout, xin_d, dyout, retain_graph=True)[0]
    (dx,) = torch.autograd.grad(xin, xd, dxin, retain_graph=True)
    _, slot, keep, _ = moe.dispatch_plan(idx, E, C)
    want = plain_moe_backwards(torch, dxin.reshape(E * C, D), dy2d, yd.detach(),
                               wd.detach(), slot, keep)
    plain = {name: torch.equal(got, ref_)
             for name, got, ref_ in zip(("dx", "dyout", "dw"), (dx, dyout, dw), want)}
    require(all(plain.values()), f"{cfg.name}: the dispatch's and the combine's "
            f"backwards differ from their plain versions: {plain}")
    del want
    grad = torch.autograd.grad
    parts = {
        "route": events_ms(torch, lambda: moe._route(live, xr, cfg)),
        "dispatch": events_ms(torch, lambda: moe._dispatch(xd, idx, E, C)),
        "experts": events_ms(torch, lambda: moe._expert_ffn(live, xin_d, cfg)),
        "combine": events_ms(torch, lambda: moe._combine(yd, wd, plan)),
        "combine_bwd": events_ms(torch, lambda: grad(y, (yd, wd), dy2d,
                                                     retain_graph=True)),
        "experts_bwd": events_ms(torch, lambda: grad(yout, [xin_d] + experts, dyout,
                                                     retain_graph=True)),
        "dispatch_bwd": events_ms(torch, lambda: grad(xin, xd, dxin, retain_graph=True)),
        "route_bwd": events_ms(torch, lambda: grad(w, (xr, live["router"]), dw,
                                                   retain_graph=True))}
    del live, experts, xin, xin_d, yout, yd, y, dx, dyout, dw, dxin
    return {"tokens": T, "experts": E, "top_k": cfg.top_k, "capacity": C,
            "dropped_frac": dropped, "two_runs_equal_nondeterministic": equal,
            "backwards_equal_plain": plain, "parts_ms": parts}


def moe_train_setup(torch, arch: str, opt_cfg=None):
    """``arch`` cut as ``MOE_TRAIN_CUTS`` says with bf16 parameters, its
    train step on one card and ``SyntheticTokens`` batches of
    ``MOE_TRAIN``'s shape (one a step, and stacked)."""
    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps as st

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16", **MOE_TRAIN_CUTS[arch])
    shape = ShapeConfig("train_cut", MOE_TRAIN["seq"], MOE_TRAIN["batch"], "train")
    bundle = st.build_train_step(cfg, shape, make_mesh((1, 1), ("data", "model")),
                                 opt=opt_cfg, total_steps=100)
    source = SyntheticTokens(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in source.batch(i).items()}
               for i in range(MOE_TRAIN["steps"])]
    return cfg, bundle, batches


def moe_grads_checked(torch, cfg, grads) -> dict:
    """Every gradient leaf finite; zero exactly in the leaves jax.grad
    leaves at zero (``ZERO_GRAD_LEAVES``), nonzero in every other."""
    bad, zero = [], []
    for path, g in leaf_paths(grads):
        at_zero = path.endswith(ZERO_GRAD_LEAVES)
        if at_zero:
            zero.append(path)
        if (g is None or not bool(torch.isfinite(g).all())
                or bool(g.abs().max() > 0) == at_zero):
            bad.append(path)
    require(not bad, f"{cfg.name}: gradient leaves {bad} missing, non-finite, all zero, or "
            f"nonzero where jax.grad gives zeros")
    return {"leaves": len(list(leaf_paths(grads))), "zero_as_in_jax": zero}


def moe_step_launches(torch, cfg, launches) -> None:
    """An eager step's flash and RMSNorm launches: flash forward on the
    tensor-core route in each attention layer (twice in a checkpointed
    layer: forward and recompute; once in the MTP head's block), its
    backward once an attention layer on the tensor-core route, the RMSNorm
    forward and backward both launched."""
    layers = cfg.n_layers + cfg.mtp_depth
    fwd = (2 if cfg.remat == "block" else 1) * cfg.n_layers + cfg.mtp_depth
    require(launches.get("flash_attention") == launches.get("flash_attention_wgmma") == fwd
            and not launches.get("flash_attention_cuda_core"),
            f"{cfg.name}: an eager step's flash forward launches {launches}: not {fwd} all "
            "on the tensor-core route")
    require(launches.get("flash_attention_bwd") == launches.get("flash_attention_bwd_wgmma")
            == layers and not launches.get("flash_attention_bwd_cuda_core"),
            f"{cfg.name}: an eager step's flash backward launches {launches}: not {layers} "
            "all on the tensor-core route")
    require(launches.get("rmsnorm", 0) > 0 and launches.get("rmsnorm_bwd", 0) > 0,
            f"{cfg.name}: an eager step did not run the RMSNorm forward and backward "
            f"kernels: {launches}")


def moe_layer_params(cfg, params):
    """The first MoE layer's ``moe`` parameters (stacked layers split)."""
    from repro_torch.models import transformer as tfm

    for seg, plan in zip(params["decoder"]["segments"], tfm.plan_segments(cfg)):
        if plan.kind == "attn_moe":
            return tfm.unbind_layers(seg, plan.n_layers)[0]["moe"]
    raise ValueError(f"{cfg.name} has no MoE layer")


#: elements of a leaf fingerprinted at a time: 8 MB int64 temporaries, which
#: fit beside a graph's pool and a model's state (~1 GB left free)
FINGERPRINT_CHUNK = 1 << 20


def fingerprints(torch, leaves) -> list:
    """Each leaf's bits as two 64-bit integers, made on the card: the sums,
    wrapping at 2^64, of every element's bits (int16 or int32 by its
    width) times two weights drawn from its flat index by a 64-bit linear
    congruential step and an xor-shift of it.  Integer sums are exact in
    any order, so a leaf gives the same pair on every run; two leaves that
    differ in any element give the same pair only by a 2^-64-scale
    coincidence.  Phase 22 keeps these where two copies of a model's state
    do not fit the card (a copy to the host took 15-17 s at grok-1's 52 GB)."""
    out = []
    for t in leaves:
        bits = t.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        acc = torch.zeros(2, dtype=torch.int64, device=t.device)
        for off in range(0, bits.numel(), FINGERPRINT_CHUNK):
            b = bits[off:off + FINGERPRINT_CHUNK].to(torch.int64)
            w = torch.arange(off, off + b.numel(), dtype=torch.int64, device=t.device)
            w.mul_(6364136223846793005).add_(1442695040888963407)
            acc[0] += (b * w).sum()
            w.bitwise_xor_(w >> 29)
            acc[1] += (b * w).sum()
        out.append((tuple(t.shape), t.dtype, *acc.tolist()))
    return out


def train_grok(torch, seed: int, free):
    """Phase 22 (a): grok-1-314b cut to 1 layer (see the module docstring);
    returns the line and the launches of one eager step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models.counting import count_params
    from repro_torch.models.nn import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init

    arch, n = "grok-1-314b", MOE_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=1e-3, moment_dtype="bfloat16")
    cfg, bundle, batches = moe_train_setup(torch, arch, opt_cfg)
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    out = {"cut": MOE_TRAIN_CUTS[arch], "parameters": count_params(cfg),
           "parameters_b": round(count_params(cfg) / 1e9, 2), "param_dtype": "bfloat16",
           "moment_dtype": "bfloat16", "tokens_per_step": tokens}

    def fresh():
        params = bundle.model.init(seed)
        return params, adamw_init(params, opt_cfg)

    t0 = time.perf_counter()
    params, opt = fresh()
    out["init_s"] = time.perf_counter() - t0
    grads, gmet = bundle.grad_fn(params, batches[0])
    out["grads"] = moe_grads_checked(torch, cfg, grads)
    params, opt, omet = bundle.apply_fn(params, opt, grads)
    del grads
    eager_mets, step_ms = [{**gmet, **omet}], []
    for i in range(1, n):
        reset_all_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = bundle.step_fn(params, opt, batches[i])
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        eager_mets.append(m)
        if i == 1:
            launches = {k: v for k, v in ops.launch_counts().items() if v}
    moe_step_launches(torch, cfg, launches)
    out["eager_step_launches"] = launches
    eager = {k: torch.stack([m[k] for m in eager_mets]) for k in eager_mets[0]}
    out["loss"] = eager["loss"].tolist()
    require(bool(torch.isfinite(eager["loss"]).all()), f"{arch}: a non-finite loss")
    out["eager_ms_per_step"] = step_ms
    out["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    # two copies of the state do not fit: the eager one is kept as its
    # leaves' fingerprints, made on the card
    t0 = time.perf_counter()
    keep = {"state": fingerprints(torch, tree_leaves((params, opt))),
            "mets": {k: v.clone() for k, v in eager.items()}}
    out["fingerprint_s"] = time.perf_counter() - t0
    del params, opt, eager, eager_mets, m
    free()

    # the same steps as ONE graph launch
    torch.cuda.reset_peak_memory_stats()
    params, opt = fresh()
    multi = st.persistent_steps(bundle, n, stacked=True).step_fn
    t0 = time.perf_counter()
    params, opt, mets = multi(params, opt, stack)
    torch.cuda.synchronize()
    out["graph_setup_s"] = time.perf_counter() - t0
    require((multi.dispatches, multi.captures) == (1, 1), f"{arch}: not one graph launch")
    same = fingerprints(torch, tree_leaves((params, opt))) == keep["state"]
    same_m = all(torch.equal(mets[k], keep["mets"][k]) for k in keep["mets"])
    require(same and same_m, f"{arch}: the one-launch steps differ from the eager steps")
    out["one_launch_equals_eager"] = {"metrics": "bitwise", "state": "equal fingerprints"}
    del keep
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    multi(params, opt, stack)
    stop.record()
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = start.elapsed_time(stop) / n
    out["dispatches_per_step_graph"] = 1 / n
    out["dispatches_per_step_eager"] = 1
    out["tokens_per_s_graph"] = tokens / (out["graph_ms_per_step"] / 1e3)
    out["tokens_per_s_eager"] = tokens / (statistics.median(step_ms) / 1e3)
    out["peak_gb_graph"] = torch.cuda.max_memory_allocated() / 1e9
    del multi, mets
    free()

    # where an eager step's time goes, and the MoE layer alone
    prof = profile_train_step(torch, bundle, params, opt, batches[1])
    kernels = prof.pop("kernels")
    out["profile"] = {**prof, "by_kernel_family_ms": kernel_families(kernels),
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in kernels[:14]]}
    out["moe_layer"] = moe_layer_check(torch, cfg, moe_layer_params(cfg, params), seed)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    free()
    return out, launches


def grads_deepseek(torch, seed: int, free):
    """Phase 22 (b): deepseek-v3-671b cut to 1 dense and 1 MoE layer, its
    gradient step only (see the module docstring); returns the line and
    the launches of one eager gradient step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models.counting import count_params
    from repro_torch.models.nn import tree_leaves

    arch = "deepseek-v3-671b"
    cfg, bundle, batches = moe_train_setup(torch, arch)
    batch = batches[0]
    out = {"cut": MOE_TRAIN_CUTS[arch], "parameters": count_params(cfg),
           "parameters_b": round(count_params(cfg) / 1e9, 2), "param_dtype": "bfloat16",
           "tokens_per_step": MOE_TRAIN["batch"] * MOE_TRAIN["seq"],
           "step": "gradients only (bundle.grad_fn): the AdamW moments do not fit"}
    t0 = time.perf_counter()
    params = bundle.model.init(seed)
    out["init_s"] = time.perf_counter() - t0
    bundle.grad_fn(params, batch)   # warm: the timed call below is the second
    torch.cuda.synchronize()
    reset_all_launches()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    grads, met = bundle.grad_fn(params, batch)
    stop.record()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    moe_step_launches(torch, cfg, launches)
    out["eager_step_launches"] = launches
    out["eager_ms_per_grad_step"] = start.elapsed_time(stop)
    out["grads"] = moe_grads_checked(torch, cfg, grads)
    out["metrics"] = {k: float(v) for k, v in met.items()}
    require(all(math.isfinite(v) for v in out["metrics"].values()),
            f"{arch}: a non-finite metric {out['metrics']}")
    out["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    # the graph's gradients live in its own pool: the eager ones are kept as
    # their fingerprints, made on the card
    t0 = time.perf_counter()
    keep = fingerprints(torch, tree_leaves(grads)), {k: v.clone() for k, v in met.items()}
    out["fingerprint_s"] = time.perf_counter() - t0
    del grads, met
    free()

    # one graph launch of grad_fn
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    static = {k: v.clone() for k, v in batch.items()}
    st._warm_up(bundle, params, static)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ggrads, gmet = bundle.grad_fn(params, static)
    graph.replay()
    torch.cuda.synchronize()
    out["graph_setup_s"] = time.perf_counter() - t0
    same = fingerprints(torch, tree_leaves(ggrads)) == keep[0]
    same_m = all(torch.equal(gmet[k], v) for k, v in keep[1].items())
    require(same and same_m, f"{arch}: the graphed gradient step differs from the eager one")
    out["graph_equals_eager"] = {"metrics": "bitwise", "gradients": "equal fingerprints"}
    del keep
    out["graph_ms_per_grad_step"] = events_ms(torch, graph.replay, calls=3)
    out["tokens_per_s_graph"] = out["tokens_per_step"] / (out["graph_ms_per_grad_step"] / 1e3)
    out["tokens_per_s_eager"] = out["tokens_per_step"] / (out["eager_ms_per_grad_step"] / 1e3)
    out["peak_gb_graph"] = torch.cuda.max_memory_allocated() / 1e9
    del graph, ggrads, gmet, static
    free()

    prof = profile_train_step(torch, bundle, params, None, batch)
    kernels = prof.pop("kernels")
    out["profile"] = {**prof, "by_kernel_family_ms": kernel_families(kernels),
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in kernels[:14]]}
    free()
    out["moe_layer"] = moe_layer_check(torch, cfg, moe_layer_params(cfg, params), seed)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    free()
    return out, launches


def kernel_families(kernels) -> dict:
    """A profile's device ms by family: flash forward and backward, the
    RMSNorm forward and backward, GEMMs (cuBLAS / CUTLASS), the rest."""
    fams = {"flash_fwd": ("flash_wgmma", "flash_fwd", "flash_attention_kernel"),
            "flash_bwd": ("flash_bwd",), "rmsnorm_bwd": ("rmsnorm_bwd", "rmsnorm_dw"),
            "rmsnorm": ("rmsnorm",),
            "gemm": ("gemm", "nvjet", "sm90_xmma", "cutlass", "Kernel2")}
    out = dict.fromkeys(list(fams) + ["other"], 0.0)
    for name, ms, _ in kernels:
        fam = next((f for f, keys in fams.items() if any(key in name for key in keys)),
                   "other")
        out[fam] += ms
    return out


def moe_train_kernels(torch, fk, rk, ref, seed: int):
    """Phase 22 (d): the flash backward at each model's training shape
    (grok-1: 48/8 heads at 128 with its soft-cap and output multiplier;
    deepseek-v3: MLA's 128 heads at (192, 128)) and the RMSNorm backward
    at theirs (d 6144; d 7168, q_norm 1536, kv_norm 512), each held to its
    plain VJP, then timed as phase 21 times them."""
    from repro_torch.configs import get_config

    gen = torch.Generator("cuda").manual_seed(seed + 122)
    B, S = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    grok, ds = get_config("grok-1-314b"), get_config("deepseek-v3-671b")
    cases = (("grok_train", "bf16", B, grok.n_heads, grok.n_kv_heads, S, S, 128, 128,
              {"logit_softcap": grok.attn_softcap, "scale": grok.attn_output_multiplier}),
             ("mla_train", "bf16", B, ds.n_heads, ds.n_heads, S, S, 192, 128,
              {"scale": 192 ** -0.5}))
    flash, errs = {}, []
    for name, *case in cases:
        detail, case_errs, inputs = flash_bwd_case(torch, fk, ref, gen, name, *case)
        require(detail["route"] == "wgmma", f"{name}: the flash backward is not on the "
                "tensor-core route")
        flash[name] = {**detail, **flash_bwd_times(torch, fk, ref, *inputs)}
        errs += case_errs
        del inputs
    norms = dict(check_norm_bwd(torch, rk, ref, gen, (B, S, d), cfg.norm_eps)
                 for d, cfg in ((grok.d_model, grok), (ds.d_model, ds),
                                (ds.q_lora_rank, ds), (ds.kv_lora_rank, ds)))
    return flash, max(errs), norms


def run_phase22(torch, seed: int, fk, rk, ref):
    """Phase 22: train the MoE family at full width (see the module
    docstring); returns the phase's line, the launches of the eager steps
    (grok's step 1 and deepseek's gradient step, the counters set to 0
    just before each), the flash backward's and the RMSNorm backward's
    entries at the training shapes and the flash backward's largest
    error there."""
    import gc

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for arch, cut in MOE_TRAIN_CUTS.items():
        print(json.dumps({"train_cut": {"model": arch, **cut, "batch": MOE_TRAIN["batch"],
                                        "seq": MOE_TRAIN["seq"], "param_dtype": "bfloat16",
                                        "reference_shape": "train_4k",
                                        "why": MOE_TRAIN_CUT}}), flush=True)
    out = {}
    free()
    torch.cuda.reset_peak_memory_stats()
    out["grok-1-314b"], grok_launches = train_grok(torch, seed, free)
    free()
    torch.cuda.reset_peak_memory_stats()
    out["deepseek-v3-671b"], ds_launches = grads_deepseek(torch, seed, free)
    free()
    launches = {k: grok_launches.get(k, 0) + ds_launches.get(k, 0)
                for k in set(grok_launches) | set(ds_launches)}
    flash, flash_err, norms = moe_train_kernels(torch, fk, rk, ref, seed)
    out["flash_backward_at_training_shapes"] = flash
    out["rmsnorm_backward_at_training_shapes"] = norms
    out["card"] = gpu_line()
    free()
    return out, launches, flash, flash_err, norms


def check_ssd_bwd_n16(torch, ssd, ref, seed: int):
    """Phase 24 (a): the N-16 tensor-core backward against the plain VJP
    at hymba's training shape (B 4, S 640, H 50, P 64, G 1, N 16): as the
    model calls it (dy only) and with init_state and dh, two runs equal
    bit for bit; a short last chunk and two groups of chunks at smaller
    H.  The CUDA-core kernel, the route's kernel before, runs on the same
    inputs for its time and its share of the bound, which is reported and
    not required: its dA, summed from row-minus-column differences over
    32-row sub-chunks, leaves the bound at this shape.  Returns the N-16
    route's kernels-line row and the details."""
    gen = torch.Generator("cuda").manual_seed(seed + 24)
    (B, S, H, G, N), P = HYMBA_SSD_TRAIN, 64
    detail = {"bound": {"rtol": GRAD_RTOL, "leaf_max_share": GRAD_FRAC,
                        "bf16_outputs": "plus 2^-8 of |got| + |want|"}}
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    wide = lambda *ts: [None if t is None else t.float() for t in ts]  # noqa: E731

    def held(key, fn, want, route, required=True):
        before = ssd.launch_counts()
        got = fn()
        after = ssd.launch_counts()
        moved = {k: v - before[k] for k, v in after.items() if v != before[k]}
        require(moved == {"ssd_scan_bwd": 1, f"ssd_scan_bwd_{route}": 1},
                f"ssd_scan_bwd {key}: launched {moved}, not once on the {route} route")
        used = {}
        for name, g, w in zip(names, got, want):
            require((g is None) == (w is None), f"ssd_scan_bwd {key}: {name} presence")
            if g is not None:
                used[name] = grad_check(torch, g, w)
                require(used[name][0] <= 1.0 or not required, f"ssd_scan_bwd {key}: {name} "
                        f"beyond the bound (share {used[name][0]:.3g})")
        detail[key] = {k: {"bound_used": u, "max_abs_err": e} for k, (u, e) in used.items()}
        return got, max(e for _, e in used.values())

    x, dt, A, Bm, C, h0 = served_ssd_inputs(torch, gen, B, S, H, G, P=P, N=N)
    dy = torch.randn(B, S, H, P, device="cuda", generator=gen).bfloat16()
    dh = torch.randn(B, H, P, N, device="cuda", generator=gen)
    require(ssd.bwd_route(x.dtype, P, N) == "wgmma_n16", "hymba's backward does not route to "
            f"the N-16 tensor-core kernel: {ssd.bwd_route(x.dtype, P, N)}")
    want = ref.ssd_scan_vjp(*wide(x, dt, A, Bm, C), None, dy.float(), None)
    got, err = held("training_bf16", lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy), want,
                    "wgmma_n16")
    held("training_bf16_init_dh",
         lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, init_state=h0, dy=dy, dh=dh),
         ref.ssd_scan_vjp(*wide(x, dt, A, Bm, C, h0, dy, dh)), "wgmma_n16")
    again = ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy)
    require(all(torch.equal(a, b) for a, b in zip(again, got) if a is not None),
            "ssd_scan_bwd at N 16: two runs differ")
    held("training_bf16_cuda_core",
         lambda: ssd.ssd_scan_bwd_variant(x, dt, A, Bm, C, dy=dy, kernel="cuda_core"), want,
         "cuda_core", required=False)
    # a short last chunk with init_state and dh; 9 chunks in two groups
    for b, s_, h in ((2, 300, 8), (1, 1100, 4)):
        xs, dts, As, Bs, Cs, hs = served_ssd_inputs(torch, gen, b, s_, h, 1, P=P, N=N)
        dys = torch.randn(b, s_, h, P, device="cuda", generator=gen).bfloat16()
        dhs = torch.randn(b, h, P, N, device="cuda", generator=gen)
        held(f"bf16_B{b}_S{s_}_H{h}_init",
             lambda: ssd.ssd_scan_bwd(xs, dts, As, Bs, Cs, init_state=hs, dy=dys, dh=dhs),
             ref.ssd_scan_vjp(*wide(xs, dts, As, Bs, Cs, hs, dys, dhs)), "wgmma_n16")

    flops, n_bytes = ssd_bwd_flops_bytes(B, S, H, P, G, N, 2, False)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    xf, Bf, Cf, dyf = wide(x, Bm, C, dy)
    row = {
        "name": "ssd_scan_bwd_n16", "route": "cuda", "kernel_route": "wgmma_n16",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": REPLACES["ssd_scan_bwd_n16"], "pallas_counterpart": False,
        "max_abs_err": err,
        "ms": median_ms(torch, lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy), reps=5,
                        inner=3),
        "plain_ms": median_ms(torch, lambda: ref.ssd_scan_vjp(xf, dt, A, Bf, Cf, None, dyf,
                                                              None), reps=3, inner=1),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes the scan's VJP
        "cuda_core_ms": median_ms(
            torch, lambda: ssd.ssd_scan_bwd_variant(x, dt, A, Bm, C, dy=dy, kernel="cuda_core"),
            reps=5, inner=3),
        "shape": [B, S, H, P, G, N], "parts": list(ssd.BWD_PARTS_N16),
        "cluster": ssd.max_cluster(S),
    }
    detail.update({"ssd_flops": flops, "ssd_bytes": n_bytes,
                   "ssd_kernel_flops": ssd_bwd_products(B, S, H, P, N, 128, scores=4),
                   "ssd_bytes_bound_ms": t_bytes * 1e3,
                   "ssd_float32_cuda_core_bound_ms": max(t_bytes, flops / FP32_OPS_PER_S) * 1e3})
    return row, detail


def run_phase24(torch, seed: int, fk, rk, ssd, ref):
    """Phase 24: train hymba-1.5b at full width and depth (see the module
    docstring); returns the phase's line, the N-16 SSD backward's row, the
    flash backward's and the RMSNorm backward's entries at hymba's training
    shapes and the kernels' launches in one eager step."""
    import gc

    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models.nn import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, n = HYMBA_TRAIN["batch"], HYMBA_TRAIN["seq"], HYMBA_TRAIN["steps"]
    print(json.dumps({"train_cut": {"model": "hymba-1.5b", "batch": B, "seq": S,
                                    "reference_shape": "train_4k",
                                    "why": HYMBA_TRAIN_CUT}}), flush=True)
    cfg = get_config("hymba-1.5b")
    shape = ShapeConfig("train_cut", S, B, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    opt_cfg = AdamWConfig(lr=1e-3)
    bundle = st.build_train_step(cfg, shape, mesh, opt=opt_cfg, total_steps=100)
    source = SyntheticTokens(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in source.batch(i).items()}
               for i in range(n)]
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    L = cfg.n_layers
    out = {"tokens_per_step": B * S, "rows_per_layer": B * (S + cfg.n_meta_tokens),
           "layers": L, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "ssd": {"heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
                   "P": cfg.ssm_head_dim, "N": cfg.ssm_state, "chunk": cfg.ssm_chunk,
                   "route": ssd.route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state,
                                      cfg.ssm_chunk),
                   "bwd_route": ssd.bwd_route(torch.bfloat16, cfg.ssm_head_dim,
                                              cfg.ssm_state)}}

    def fresh():
        params = bundle.model.init(seed)
        return params, adamw_init(params, opt_cfg)

    # (b) eager steps; step 0's gradients checked; step 1's launches
    t0 = time.perf_counter()
    params, opt = fresh()
    out["init_s"] = time.perf_counter() - t0
    out["param_count"] = sum(p.numel() for p in tree_leaves(params))
    grads, gmet = bundle.grad_fn(params, batches[0])
    bad = [i for i, g in enumerate(tree_leaves(grads))
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    require(not bad, f"phase 24: gradient leaves {bad} missing, non-finite or all zero")
    out["grad_leaves"] = len(tree_leaves(grads))
    params, opt, omet = bundle.apply_fn(params, opt, grads)
    del grads
    eager_mets = [{**gmet, **omet}]
    step_ms = []
    for i in range(1, n):
        reset_all_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = bundle.step_fn(params, opt, batches[i])
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        eager_mets.append(m)
        if i == 1:
            launches = {k: v for k, v in ops.launch_counts().items() if v}
    out["eager_step_launches"] = launches
    require(launches.get("ssd_scan") == launches.get("ssd_scan_wgmma_n16") == 2 * L
            and not launches.get("ssd_scan_cuda_core") and not launches.get("ssd_scan_wgmma"),
            f"an eager step's SSD forward launches {launches}: not {2 * L} (forward and "
            "recompute) all on the N-16 tensor-core route")
    require(launches.get("ssd_scan_bwd") == launches.get("ssd_scan_bwd_wgmma_n16") == L
            and not launches.get("ssd_scan_bwd_cuda_core")
            and not launches.get("ssd_scan_bwd_wgmma"),
            f"an eager step's SSD backward launches {launches}: not {L} all on the N-16 "
            "tensor-core route")
    flash_route = fk.route(torch.bfloat16, cfg.resolved_head_dim(), cfg.resolved_head_dim())
    require(launches.get("flash_attention") == launches.get(f"flash_attention_{flash_route}")
            == 2 * L and launches.get("flash_attention_bwd")
            == launches.get(f"flash_attention_bwd_{flash_route}") == L,
            f"an eager step's flash launches {launches}: not {2 * L} forward and {L} backward "
            f"on the {flash_route} route")
    require(launches.get("rmsnorm_bwd", 0) == 4 * L + 1
            and launches.get("rmsnorm") == 2 * launches["rmsnorm_bwd"] - 1,
            f"an eager step's RMSNorm launches {launches}: not the 4 norms a layer (the gated "
            "norm included) forward twice under the checkpoint and backward once, and the "
            "final norm")
    eager = {k: torch.stack([m[k] for m in eager_mets]) for k in eager_mets[0]}
    out["loss"] = eager["loss"].tolist()
    require(bool(torch.isfinite(eager["loss"]).all()), "phase 24: a non-finite loss")
    out["eager_ms_per_step"] = step_ms
    out["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    # the eager state kept as its leaves' fingerprints, made on the card
    t0 = time.perf_counter()
    keep = {"state": fingerprints(torch, tree_leaves((params, opt))),
            "mets": {k: v.clone() for k, v in eager.items()}}
    out["fingerprint_s"] = time.perf_counter() - t0
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same steps as ONE graph launch
    params, opt = fresh()
    multi = st.persistent_steps(bundle, n, stacked=True).step_fn
    t0 = time.perf_counter()
    params, opt, mets = multi(params, opt, stack)
    torch.cuda.synchronize()
    out["graph_setup_s"] = time.perf_counter() - t0
    require((multi.dispatches, multi.captures) == (1, 1), "phase 24: not one graph launch")
    same = fingerprints(torch, tree_leaves((params, opt))) == keep["state"]
    same_m = all(torch.equal(mets[k], keep["mets"][k]) for k in keep["mets"])
    require(same and same_m, "phase 24: the one-launch steps differ from the eager steps")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    multi(params, opt, stack)
    stop.record()
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = start.elapsed_time(stop) / n
    out["dispatches_per_step_graph"] = 1 / n
    out["tokens_per_s_graph"] = out["tokens_per_step"] / (out["graph_ms_per_step"] / 1e3)
    out["tokens_per_s_eager"] = out["tokens_per_step"] / (statistics.median(step_ms) / 1e3)
    out["peak_gb_graph"] = torch.cuda.max_memory_allocated() / 1e9
    del multi, params, opt, mets, keep
    gc.collect()
    torch.cuda.empty_cache()

    # (c) where an eager step's time goes
    params, opt = fresh()
    bundle.step_fn(params, opt, batches[0])
    torch.cuda.synchronize()
    prof = profile_train_step(torch, bundle, params, opt, batches[1])
    kernels, busy = prof.pop("kernels"), prof["device_busy_ms"]
    groups = {"ssd_bwd": ("ssd_bwd_wgmma_n16", "ssd_bwd_group_sum", "ssd_bwd_batch_sum"),
              "ssd_fwd": ("ssd_wgmma_n16",), "flash_bwd": ("flash_bwd",),
              "flash_fwd": ("flash_wgmma",), "rmsnorm_bwd": ("rmsnorm_bwd", "rmsnorm_dw")}
    split = {}
    for name, keys in groups.items():
        hits = [(t, c) for k, t, c in kernels if any(key in k for key in keys)]
        split[name] = {"ms": sum(t for t, _ in hits), "launches": sum(c for _, c in hits),
                       "share_of_busy": sum(t for t, _ in hits) / busy if busy else None}
    out["profile"] = {**prof, "by_family": split,
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in kernels[:14]]}
    # an eager step dispatches each of its kernels from the host
    out["dispatches_per_step_eager"] = prof["kernel_launches"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the kernels at the step's shapes against their plain versions
    row, detail = check_ssd_bwd_n16(torch, ssd, ref, seed)
    out["ssd_backward_checks"] = detail
    gen = torch.Generator("cuda").manual_seed(seed + 124)
    flash, flash_errs, inputs = flash_bwd_case(
        torch, fk, ref, gen, "hymba_gqa5", "bf16", B, cfg.n_heads, cfg.n_kv_heads,
        S + cfg.n_meta_tokens, S + cfg.n_meta_tokens, cfg.resolved_head_dim(),
        cfg.resolved_head_dim(), {"window": cfg.sliding_window})
    flash["times"] = flash_bwd_times(torch, fk, ref, *inputs)
    del inputs
    norms = dict(check_norm_bwd(torch, rk, ref, gen, (B, S + cfg.n_meta_tokens, d),
                                cfg.norm_eps)
                 for d in (cfg.d_model, cfg.ssm_expand * cfg.d_model))
    out["flash_backward_check"] = flash
    out["rmsnorm_backward_checks"] = norms
    out["card"] = gpu_line()
    gc.collect()
    torch.cuda.empty_cache()
    return out, row, flash, max(flash_errs), norms, launches


def same_bits(torch, a, b) -> bool:
    """``a`` and ``b`` equal bit for bit (signed zeros told apart)."""
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def embedding_case(torch, ek, ref, name, dy, ids, vocab) -> dict:
    """Phase 25 (a): the embedding backward at one input (``dy`` [T, D]
    bf16, ``ids`` [T]): one counted launch equal to its plain version bit
    for bit, two calls equal; timed (the wrapper: the stable sort and the
    kernels) beside the sort alone, the plain version (CUDA events: it reads
    its sweep count on the host), autograd of ``index_select``'s backward
    (forward and backward less forward, each in captured graphs; it adds
    with float atomics, so its entries that differ from the kernel's are
    counted) and the bound: dy and ids read once, every row of the
    [vocab, D] result written once, over the card's memory rate."""
    before = ek.embedding_bwd.launches
    got = ek.embedding_bwd(dy, ids, vocab)
    require(ek.embedding_bwd.launches == before + 1,
            f"embedding_bwd {name}: not one counted launch")
    require(same_bits(torch, got, ref.embedding_bwd(dy, ids, vocab)),
            f"embedding_bwd {name}: differs from its plain version")
    require(same_bits(torch, ek.embedding_bwd(dy, ids, vocab), got),
            f"embedding_bwd {name}: two calls differ")
    T, D = dy.shape
    n_bytes = (dy.numel() * dy.element_size() + ids.numel() * ids.element_size()
               + vocab * D * dy.element_size())
    table = torch.zeros(vocab, D, dtype=dy.dtype, device="cuda", requires_grad=True)
    flat = ids.long()

    def lib_fwd():
        return torch.index_select(table, 0, flat)

    def lib_fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(lib_fwd(), table, dy)[0]

    counts = torch.unique(ids, return_counts=True)[1]
    out = {"T": T, "D": D, "vocab": vocab, "distinct_ids": int(counts.numel()),
           "longest_run": int(counts.max()),
           "library_entries_differing": int((lib_fwd_bwd() != got).sum()),
           "ms": median_ms(torch, lambda: ek.embedding_bwd(dy, ids, vocab), 10, 5),
           "sort_ms": median_ms(torch, lambda: torch.sort(ids.int(), stable=True), 10, 5),
           "plain_ms": events_ms(torch, lambda: ref.embedding_bwd(dy, ids, vocab)),
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "mbytes": n_bytes / 1e6,
           "library_fwd_bwd_ms": median_ms(torch, lib_fwd_bwd, 5, 5)}
    with torch.no_grad():
        out["library_fwd_ms"] = median_ms(torch, lib_fwd, 5, 5)
    out["library_ms"] = out["library_fwd_bwd_ms"] - out["library_fwd_ms"]
    del table, got
    return out


def family_setup(torch, arch: str):
    """Phase 25: ``arch`` at full width (cut in depth as ``FAMILY_TRAIN``
    says), its train step on one card and ``SyntheticTokens`` batches (one a
    step, and stacked)."""
    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps as st
    from repro_torch.optim import AdamWConfig

    run = FAMILY_TRAIN[arch]
    cfg = dataclasses.replace(get_config(arch), **run["cut"])
    shape = ShapeConfig("train_cut", run["seq"], run["batch"], "train")
    opt_cfg = AdamWConfig(lr=1e-3)
    bundle = st.build_train_step(cfg, shape, make_mesh((1, 1), ("data", "model")),
                                 opt=opt_cfg, total_steps=100)
    source = SyntheticTokens(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in source.batch(i).items()}
               for i in range(FAMILY_TRAIN_STEPS)]
    return cfg, bundle, opt_cfg, batches


def family_step_launches(torch, cfg, launches) -> dict:
    """An eager step's kernels, as the config gives them: every attention
    (the encoder's, the decoder's self and cross attention) forward twice
    (forward and the checkpoint's recompute) and backward once, all on the
    tensor-core route; every norm forward twice and backward once but the
    final ones (the decoder's, and the encoder's), which are not
    checkpointed; the embedding backward once."""
    attn = cfg.n_layers * (2 if cfg.enc_dec else 1) + (cfg.n_enc_layers if cfg.enc_dec else 0)
    finals = 2 if cfg.enc_dec else 1
    want = {"flash_attention": 2 * attn, "flash_attention_wgmma": 2 * attn,
            "flash_attention_bwd": attn, "flash_attention_bwd_wgmma": attn,
            "embedding_bwd": 1}
    got = {k: launches.get(k, 0) for k in want}
    require(got == want and not launches.get("flash_attention_cuda_core")
            and not launches.get("flash_attention_bwd_cuda_core"),
            f"{cfg.name}: an eager step's launches {launches}, not {want} (none on the "
            "CUDA-core routes)")
    require(launches.get("rmsnorm_bwd", 0) > 0
            and launches.get("rmsnorm") == 2 * launches["rmsnorm_bwd"] - finals,
            f"{cfg.name}: an eager step's RMSNorm launches {launches}: not every norm "
            f"forward twice under the checkpoint and backward once, the {finals} final "
            "one(s) forward once")
    return {"attention_calls": attn, "final_norms": finals}


def train_family(torch, seed: int, arch: str, free):
    """Phase 25 (b) for one model (see the module docstring); returns its
    line and the launches of its counted eager step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models.nn import tree_leaves
    from repro_torch.optim import adamw_init

    n = FAMILY_TRAIN_STEPS
    cfg, bundle, opt_cfg, batches = family_setup(torch, arch)
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    run = FAMILY_TRAIN[arch]
    tokens = run["batch"] * run["seq"]
    print(json.dumps({"train_cut": {"model": arch, "batch": run["batch"], "seq": run["seq"],
                                    "layers": cfg.n_layers, **run["cut"],
                                    "reference_shape": "train_4k",
                                    "why": FAMILY_TRAIN_CUT}}), flush=True)

    def fresh():
        params = bundle.model.init(seed)
        return params, adamw_init(params, opt_cfg)

    def step(params, opt, i, times):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = bundle.step_fn(params, opt, batches[i])
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        return params, opt, m

    def mode_off():
        require(not torch.are_deterministic_algorithms_enabled(),
                f"{arch}: deterministic algorithms are on")

    out = {"tokens_per_step": tokens, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "tied": cfg.tie_embeddings, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype}
    if cfg.enc_dec:
        out["encoder_layers"] = cfg.n_enc_layers
        out["audio_frames"] = cfg.frontend_tokens
    mode_off()

    # n eager steps: the first step's gradients checked, the second's
    # launches counted (counters set to 0 just before it), the state kept as
    # fingerprints after 2 and after n steps
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = fresh()
    out["init_s"] = time.perf_counter() - t0
    out["param_count"] = sum(p.numel() for p in tree_leaves(params))
    out["parameters_b"] = out["param_count"] / 1e9
    grads, gmet = bundle.grad_fn(params, batches[0])
    bad = [i for i, g in enumerate(tree_leaves(grads))
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    require(not bad, f"{arch}: gradient leaves {bad} missing, non-finite or all zero")
    out["grad_leaves"] = len(tree_leaves(grads))
    params, opt, omet = bundle.apply_fn(params, opt, grads)
    del grads
    eager_mets, step_ms = [{**gmet, **omet}], []
    for i in range(1, n):
        if i == 1:
            reset_all_launches()
        params, opt, m = step(params, opt, i, step_ms)
        eager_mets.append(m)
        if i == 1:
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            two_steps = fingerprints(torch, tree_leaves((params, opt)))
    out["eager_step_launches"] = launches
    out["expected_launches"] = family_step_launches(torch, cfg, launches)
    eager = {k: torch.stack([m[k] for m in eager_mets]) for k in eager_mets[0]}
    out["loss"] = eager["loss"].tolist()
    require(bool(torch.isfinite(eager["loss"]).all()), f"{arch}: a non-finite loss")
    out["eager_ms_per_step"] = step_ms
    out["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    out["free_gb_at_eager_peak"] = (torch.cuda.get_device_properties(0).total_memory
                                    - torch.cuda.max_memory_allocated()) / 1e9
    t0 = time.perf_counter()
    keep = fingerprints(torch, tree_leaves((params, opt)))
    out["fingerprint_s"] = time.perf_counter() - t0
    del params, opt, eager_mets, m
    free()

    # a second eager run of 2 steps from the same seed: the same bits
    params, opt = fresh()
    again = []
    params, opt, _ = bundle.apply_fn(params, opt, bundle.grad_fn(params, batches[0])[0])
    params, opt, _ = step(params, opt, 1, again)
    mode_off()
    require(fingerprints(torch, tree_leaves((params, opt))) == two_steps,
            f"{arch}: two eager runs of 2 steps differ (deterministic algorithms off)")
    out["two_eager_runs_equal"] = {"steps": 2, "state": "equal fingerprints"}
    del params, opt
    free()

    # the same n steps as ONE graph launch
    torch.cuda.reset_peak_memory_stats()
    params, opt = fresh()
    multi = st.persistent_steps(bundle, n, stacked=True).step_fn
    t0 = time.perf_counter()
    params, opt, mets = multi(params, opt, stack)
    torch.cuda.synchronize()
    out["graph_setup_s"] = time.perf_counter() - t0
    require((multi.dispatches, multi.captures) == (1, 1), f"{arch}: not one graph launch")
    same = fingerprints(torch, tree_leaves((params, opt))) == keep
    same_m = all(torch.equal(mets[k], eager[k]) for k in eager)
    require(same and same_m, f"{arch}: the one-launch steps differ from the eager steps")
    mode_off()
    out["one_launch_equals_eager"] = {"metrics": "bitwise", "state": "equal fingerprints"}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    multi(params, opt, stack)
    stop.record()
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = start.elapsed_time(stop) / n
    out["dispatches_per_step_graph"] = 1 / n
    out["tokens_per_s_graph"] = tokens / (out["graph_ms_per_step"] / 1e3)
    out["tokens_per_s_eager"] = tokens / (statistics.median(step_ms) / 1e3)
    out["peak_gb_graph"] = torch.cuda.max_memory_allocated() / 1e9
    del multi, mets, keep, two_steps
    free()

    # where an eager step's time goes
    prof = profile_train_step(torch, bundle, params, opt, batches[1])
    kernels, busy = prof.pop("kernels"), prof["device_busy_ms"]
    groups = {"flash_bwd": ("flash_bwd",), "flash_fwd": ("flash_wgmma",),
              "rmsnorm_bwd": ("rmsnorm_bwd", "rmsnorm_dw"), "embedding_bwd": ("embedding_bwd",)}
    split = {}
    for name, keys in groups.items():
        hits = [(t, c) for k, t, c in kernels if any(key in k for key in keys)]
        split[name] = {"ms": sum(t for t, _ in hits), "launches": sum(c for _, c in hits),
                       "share_of_busy": sum(t for t, _ in hits) / busy if busy else None}
    out["profile"] = {**prof, "by_family": split,
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in kernels[:14]]}
    # an eager step dispatches each of its kernels from the host
    out["dispatches_per_step_eager"] = prof["kernel_launches"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    free()
    return out, launches


def run_phase25(torch, seed: int, fk, rk, ref):
    """Phase 25: train qwen1.5-0.5b, glm4-9b (cut in depth) and
    whisper-large-v3 at full width (see the module docstring); returns the
    phase's line, the embedding backward's row, the flash backward's and the
    RMSNorm backward's entries at the phase's shapes, the flash backward's
    largest error there and the kernels' launches in the three counted
    eager steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import embedding as ek

    def free():
        gc_free(torch)

    out, launches = {}, {}
    for arch in FAMILY_TRAIN:
        free()
        out[arch], got = train_family(torch, seed, arch, free)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    free()

    # (a) the embedding backward at each model's step shape, on its ids
    gen = torch.Generator("cuda").manual_seed(seed + 125)
    emb = {}
    for arch, run in FAMILY_TRAIN.items():
        cfg = get_config(arch)
        shape = ShapeConfig("train_cut", run["seq"], run["batch"], "train")
        ids = torch.from_numpy(SyntheticTokens(cfg, shape).batch(0)["tokens"]).cuda()
        ids = ids.reshape(-1)
        dy = torch.randn(ids.numel(), cfg.d_model, device="cuda", generator=gen).bfloat16()
        emb[arch] = embedding_case(torch, ek, ref, arch, dy, ids, cfg.vocab)
        del dy, ids
    q = FAMILY_TRAIN["qwen1.5-0.5b"]
    cfg_q = get_config("qwen1.5-0.5b")
    T = q["batch"] * q["seq"]
    dy = torch.randn(T, cfg_q.d_model, device="cuda", generator=gen).bfloat16()
    for name, values in EMB_SKEWED:
        pool = torch.randint(0, cfg_q.vocab, (values,), device="cuda", generator=gen)
        ids = pool[torch.randint(0, values, (T,), device="cuda", generator=gen)]
        emb[name] = embedding_case(torch, ek, ref, name, dy, ids, cfg_q.vocab)
    del dy, ids, pool
    free()
    main_case = emb["qwen1.5-0.5b"]
    row = {"name": "embedding_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/embedding.cu",
           "replaces": REPLACES["embedding_bwd"], "pallas_counterpart": False,
           "launches": launches["embedding_bwd"], "phase25_launches": launches["embedding_bwd"],
           "max_abs_err": 0.0, "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
           "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
           "library_ms": main_case["library_ms"],
           "library_call": ("torch.autograd.grad of torch.index_select (float atomics): "
                            "forward and backward less the forward alone, each in captured "
                            "graphs"),
           "library_fwd_bwd_ms": main_case["library_fwd_bwd_ms"],
           "library_fwd_ms": main_case["library_fwd_ms"],
           "shape": [main_case["T"], main_case["D"], main_case["vocab"]],
           "other_shapes": {k: v for k, v in emb.items() if k != "qwen1.5-0.5b"}}
    out["embedding_backward_checks"] = emb

    # (b) the flash backward at the three models' layers, the RMSNorm
    # backward at glm4's d 4096 (its eps) and whisper's 1280
    gen = torch.Generator("cuda").manual_seed(seed + 25)
    flash, errs = {}, []
    for name, *case in FLASH_BWD_CASES:
        if name not in PHASE25_FLASH_BWD:
            continue
        flash[name], case_errs, inputs = flash_bwd_case(torch, fk, ref, gen, name, *case)
        flash[name]["times"] = flash_bwd_times(torch, fk, ref, *inputs)
        errs += case_errs
        del inputs
        free()
    glm, whisper = get_config("glm4-9b"), get_config("whisper-large-v3")
    norms = dict(check_norm_bwd(torch, rk, ref, gen, shape, eps)
                 for shape, eps in (((4, 1024, glm.d_model), glm.norm_eps),
                                    ((4, whisper.frontend_tokens, whisper.d_model),
                                     whisper.norm_eps)))
    out["flash_backward_checks"] = flash
    out["rmsnorm_backward_checks"] = norms
    out["card"] = gpu_line()
    free()
    return out, row, flash, max(errs), norms, launches


def start_dry_run():
    """Phase 23 (d), started first: the whole dry run in a CPU process
    (``CUDA_VISIBLE_DEVICES`` empty, meta tensors only) beside the card's
    phases; its JSON line is read in phase 23."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", DRY_RUN_CODE], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def bundles_equal_eager(torch, seed: int) -> dict:
    """Phase 23 (a): gemma3-1b's prefill bundle and decode bundle at a 1x1
    mesh on the card, each equal to ``Model.prefill`` / ``decode_step`` run
    eagerly on a copy of the same caches, bit for bit (logits and
    caches); the kernels each bundle launched."""
    import numpy as np

    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.serve import synthetic_batch
    from repro_torch.models.nn import tree_leaves

    cfg = get_config("gemma3-1b")
    B, S, G = BUNDLE_SHAPE["batch"], BUNDLE_SHAPE["seq"], BUNDLE_SHAPE["gen"]
    mesh = make_mesh((1, 1), ("data", "model"))
    pre = st.build_prefill_step(cfg, ShapeConfig("prefill_cut", S, B, "prefill"), mesh)
    dec = st.build_serve_step(cfg, ShapeConfig("decode_cut", S + G, B, "decode"), mesh)
    model = pre.model
    cast = model.compute_params(model.init(seed))
    batch = synthetic_batch(cfg, np.random.RandomState(seed), B, S)
    caches = [model.init_caches(B, S + G) for _ in range(2)]
    out = {"model": cfg.name, "mesh": mesh.shape, "prefill": [B, S], "decode_slots": B,
           "cache_len": S + G}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    torch.cuda.synchronize()
    reset_all_launches()
    got = pre.step_fn(cast, batch, caches[0])
    torch.cuda.synchronize()
    out["prefill_launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    want = model.prefill(cast, batch, caches[1])
    require(same(got, want), "gemma3-1b: the prefill bundle differs from Model.prefill")
    token = got[0].argmax(-1).to(torch.int32)
    reset_all_launches()
    got = dec.step_fn(cast, got[1], token)
    torch.cuda.synchronize()
    out["decode_launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    want = model.decode_step(cast, want[1], token)
    require(same(got, want), "gemma3-1b: the decode bundle differs from Model.decode_step")
    require(out["prefill_launches"].get("flash_attention") == cfg.n_layers
            and out["prefill_launches"].get("rmsnorm", 0) > 0
            and out["decode_launches"].get("rmsnorm", 0) > 0,
            f"gemma3-1b: the bundles' kernel launches {out}")
    out["equal_eager_bitwise"] = True
    return out


def moe_cuts_through_ep(torch, seed: int, first_tokens) -> dict:
    """Phase 23 (b): phase 20's MoE cuts (same weights, trunk scale and
    prompts) prefilled through the prefill bundle at a 1x1 mesh, whose
    sharding context sends each MoE layer through ``apply_moe_ep``: its
    logits equal the gather path's (``Model.prefill`` with no context)
    bit for bit, its tokens equal phase 20's first served tokens, and the
    first MoE layer's expert-parallel drops are reported."""
    import numpy as np

    from repro_torch import make_mesh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.launch.serve import synthetic_batch
    from repro_torch.models import moe, nn
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding_ctx

    out = {}
    B, S = MOE_SERVE["batch"], MOE_SERVE["prompt_len"]
    mesh = make_mesh((1, 1), ("data", "model"))
    for arch in MOE_CUTS:
        cfg = moe_cut(arch)
        bundle = st.build_prefill_step(cfg, ShapeConfig("prefill_cut", S, B, "prefill"), mesh)
        model = bundle.model
        params = model.init(seed)
        scale_trunks(params, MOE_TRUNK_SCALE)
        cast = model.compute_params(params)
        del params
        batch = synthetic_batch(cfg, np.random.RandomState(seed), B, S)
        cap = S + model._prefix_len() + MOE_SERVE["gen_len"]
        logits_ep = bundle.step_fn(cast, batch, model.init_caches(B, cap))[0]
        logits_gather = model.prefill(cast, batch, model.init_caches(B, cap))[0]
        tokens = logits_ep.argmax(-1).tolist()
        require(torch.equal(logits_ep, logits_gather),
                f"{arch}: the EP prefill at 1x1 differs from the gather path")
        require(tokens == first_tokens[arch],
                f"{arch}: EP prefill tokens {tokens} != phase 20's {first_tokens[arch]}")
        # the first MoE layer's own drops under the bundle's context
        x = model._decoder_input(cast, batch)[0]
        plan = tfm.plan_segments(cfg)
        seg = next(i for i, s in enumerate(plan) if s.kind == "attn_moe")
        p = tfm.unbind_layers(cast["decoder"]["segments"][seg], plan[seg].n_layers)[0]
        with sharding_ctx(bundle.rules, mesh):
            y, aux = moe.apply_moe_ep(p["moe"], nn.apply_rmsnorm(p["ln_mlp"], x, cfg), cfg)
        out[arch] = {"cut": MOE_CUTS[arch], "tokens": tokens,
                     "equal_gather_bitwise": True, "tokens_equal_phase20": True,
                     "first_moe_layer_dropped_frac_at_its_input": float(aux["dropped_frac"])}
        del cast, logits_ep, logits_gather, x, y, p
        gc_free(torch)
    return out


def ep_against_gather(torch, seed: int) -> dict:
    """Phase 23 (c): grok-1's MoE layer at full width in float32, its
    capacity factor raised to ``EP_CAPACITY_FACTOR`` (no drops), through
    ``apply_moe_ep`` at a 2x2 ``(data, model)`` mesh held on the card (2
    data shards, 4 experts a model shard, the shards' partial sums added
    in order) against the gather path: the output and the gradients of
    ``sum(y * dy)`` (input, router, experts) within ``EP_TOL``."""
    from repro_torch import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.parallel import RULES_TRAIN, sharding_ctx

    cfg = dataclasses.replace(get_config("grok-1-314b"), param_dtype="float32",
                              dtype="float32", capacity_factor=EP_CAPACITY_FACTOR)
    gen = torch.Generator("cuda").manual_seed(seed + 123)
    p = {k: v.requires_grad_() for k, v in moe.init_moe(gen, cfg, device="cuda").items()}
    x = torch.randn(*EP_TOKENS, cfg.d_model, generator=gen, device="cuda",
                    requires_grad=True)
    dy = torch.randn(*EP_TOKENS, cfg.d_model, generator=gen, device="cuda")
    mesh = make_mesh(EP_MESH, ("data", "model"))
    keys = ("router", "wi", "wg", "wo")
    res = {}
    for name in ("gather", "ep"):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if name == "gather":
            y, aux = moe.apply_moe(p, x, dataclasses.replace(cfg, moe_impl="gather"))
        else:
            with sharding_ctx(RULES_TRAIN, mesh):
                out = moe.apply_moe_ep(p, x, cfg)
            require(out is not None, "apply_moe_ep did not engage at 2x2")
            y, aux = out
        grads = torch.autograd.grad((y * dy).sum(), [x] + [p[k] for k in keys])
        stop.record()
        torch.cuda.synchronize()
        res[name] = (y.detach(), float(aux["dropped_frac"]), grads, start.elapsed_time(stop))
        del y, aux, grads
        gc_free(torch)
    (yg, dg, gg, tg), (ye, de, ge, te) = res["gather"], res["ep"]
    require(dg == 0.0 and de == 0.0, f"tokens dropped at capacity factor "
            f"{EP_CAPACITY_FACTOR}: gather {dg}, EP {de}")
    def close(a, b):
        """allclose at EP_TOL and the largest error, a slice of dim 0 at a
        time (a whole expert stack's temporaries would not fit)"""
        ok, err = True, 0.0
        for i in range(a.shape[0]):
            ok = ok and torch.allclose(a[i], b[i], rtol=EP_TOL, atol=EP_TOL)
            err = max(err, float((a[i] - b[i]).abs().max()))
        return ok, err

    ok, errs = True, {}
    for k, a, b in zip(("y", "dx") + tuple("d" + k for k in keys), (ye,) + tuple(ge),
                       (yg,) + tuple(gg)):
        good, errs[k] = close(a, b)
        ok = ok and good
    require(ok, f"EP at 2x2 differs from the gather path beyond {EP_TOL}: {errs}")
    return {"model": cfg.name, "dtype": "float32", "mesh": list(EP_MESH),
            "tokens": list(EP_TOKENS), "capacity_factor": EP_CAPACITY_FACTOR,
            "tol": EP_TOL, "max_abs_err": errs, "dropped_frac": [dg, de],
            "forward_backward_ms": {"gather": tg, "ep": te}}


def finish_dry_run(torch, proc) -> dict:
    """Phase 23 (d): the dry run's result: every record ``ok`` or skipped
    with the reference's reason, none an error; counts, the largest
    per-device argument GB, the step TFLOP of each kind, and its seconds."""
    out, err = proc.communicate(timeout=900)
    require(proc.returncode == 0, f"the dry run failed (rc {proc.returncode}): {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    recs = res["records"]
    counts = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
    errors = [(r["arch"], r["shape"], r["mesh"], r["error"]) for r in recs
              if r["status"] == "error"]
    require(len(recs) == DRY_RUN_RECORDS and not errors, f"dry run: {counts}, {errors[:4]}")
    for r in recs:
        if r["status"] == "skipped":
            require(r["reason"] == res["skips"][f"{r['arch']}|{r['shape']}"],
                    f"dry run: {r['arch']} {r['shape']} skipped without the reference's "
                    f"reason")
    ok = [r for r in recs if r["status"] == "ok"]
    big = max(ok, key=lambda r: r["argument_bytes_per_device"])
    tflop = {}
    for r in ok:
        if r["mesh"] == "pod16x16":
            tflop.setdefault(r["shape"], {})[r["arch"]] = r["step_dot_flops"] / 1e12
    return {"counts": counts, "records": len(recs), "seconds": res["seconds"],
            "trace_seconds": sum(r["trace_s"] for r in ok),
            "largest_argument_gb_per_device": {
                "gb": big["argument_bytes_per_device"] / 1e9,
                "at": [big["arch"], big["shape"], big["mesh"]]},
            "step_tflop_by_shape_pod16x16": tflop,
            "collectives": "not derived (no SPMD partitioner on one card)"}


def gc_free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def run_phase23(torch, seed: int, first_tokens, dry) -> tuple:
    """Phase 23: the step bundles, the expert-parallel MoE path on the
    card and the dry run (see the module docstring); returns the phase's
    line and the kernels' launches on its paths (the bundles' and the
    EP prefills', counters set to 0 just before (a) and read after
    (b))."""
    from repro_torch.kernels import ops

    gc_free(torch)
    out = {"bundles_gemma3": bundles_equal_eager(torch, seed)}
    gc_free(torch)
    reset_all_launches()
    out["moe_cuts_ep"] = moe_cuts_through_ep(torch, seed, first_tokens)
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts())
    for k, v in out["bundles_gemma3"]["prefill_launches"].items():
        launches[k] = launches.get(k, 0) + v
    for k, v in out["bundles_gemma3"]["decode_launches"].items():
        launches[k] = launches.get(k, 0) + v
    gc_free(torch)
    out["ep_against_gather_2x2"] = ep_against_gather(torch, seed)
    gc_free(torch)
    out["dry_run"] = finish_dry_run(torch, dry)
    out["card"] = gpu_line()
    return out, launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    dry = start_dry_run()
    try:
        return run_phases(torch, args, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
        dry.wait()


def run_phases(torch, args, dry) -> int:
    import numpy as np

    from repro_torch import make_mesh
    from repro_torch.core import FacesConfig, PersistentEngine, build_faces_program, faces_oracle
    from repro_torch.core.halo import AXES3
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import halo_pack as hk

    card = gpu_line()
    print(f"card: {card}", flush=True)
    t_run, phase_s = time.perf_counter(), {}

    def lap(name: str) -> None:
        """Print and keep the seconds since the last lap (or the start)."""
        now = time.perf_counter()
        phase_s[name] = now - (t_run + sum(phase_s.values()))
        print(json.dumps({"phase_seconds": {name: phase_s[name]}}), flush=True)
    # phase 1: every csrc/*.cu, one nvcc each, all started together
    t0 = time.perf_counter()
    infos = build.build_all()
    print(json.dumps({"build": {"seconds": time.perf_counter() - t0, "libraries": {
        name: {"library": i.path.name, "seconds": i.seconds,
               "ptxas": [l.strip() for l in i.log.splitlines()
                         if "registers" in l or "spill" in l]}
        for name, i in infos.items()}}}), flush=True)

    lap("phase_1")

    # phase 2: the main path
    cfg = FacesConfig(grid=(2, 2, 2), points=(128, 128, 128), dtype="float32",
                      granularity="direct26", batched=True, pack="kernel",
                      damping=0.12)
    mesh = make_mesh(cfg.grid, AXES3)
    u0 = np.random.RandomState(args.seed).randn(*cfg.grid, *cfg.points).astype(np.float32)
    hk.reset_launches()
    prog, fields, first, dispatches, ms, fused = run_engines(torch, cfg, mesh, u0)
    torch.cuda.synchronize()
    launches = hk.launch_counts()

    lap("phase_2")

    # phase 3: results
    want = {"host": N_ITERS * prog.dispatch_count_host(),
            "fused_stream": N_ITERS, "fused_dataflow": N_ITERS,
            "persistent_stream": 1, "persistent_dataflow": 1}
    require(dispatches == want, f"dispatch counts {dispatches} != {want}")
    require(all(launches[n] > 0 for n in FACES_KERNELS), f"a kernel never launched: {launches}")
    base = fields["host"]
    require(bool(torch.isfinite(base).all()), "non-finite field after 10 iterations")
    for name, f in fields.items():
        require(torch.equal(f, base), f"{name} differs from the host engine")
    plain_cfg = dataclasses.replace(cfg, pack="torch")
    plain = PersistentEngine(build_faces_program(plain_cfg, mesh).persistent(N_ITERS))
    require(torch.equal(plain(plain.init_buffers({"u": u0}))["u"], base),
            'pack="torch" differs from pack="kernel"')
    oracle = faces_oracle(u0, cfg)
    err = float(np.abs(first.cpu().numpy() - oracle).max())
    require(np.allclose(first.cpu().numpy(), oracle, rtol=1e-4, atol=1e-4),
            f"one iteration differs from faces_oracle (max abs err {err})")
    print(json.dumps({"faces": {
        "grid": cfg.grid, "points": cfg.points, "iterations": N_ITERS,
        "dispatches": dispatches, "median_ms_per_iter": ms,
        "oracle_max_abs_err": err,
        "launches": {n: launches[n] for n in FACES_KERNELS}}}), flush=True)

    # where the time of fused (stream) iterations goes
    print(json.dumps({"profile_fused_stream": profile_iterations(
        torch, fused, fused.init_buffers({"u": u0}))}), flush=True)

    lap("phase_3")

    # phase 4: the one-buffer path
    contiguous = run_contiguous(torch, cfg, u0, first, base, hk)
    print(json.dumps({"faces_contiguous": contiguous}), flush=True)
    launches.update({n: contiguous["launches"][n]
                     for n in ("pack_boundary", "unpack_boundary_add")})

    lap("phase_4")

    # phase 5: halo and boundary kernels against their plain versions
    rows = check_kernels(torch, prog, base, hk, ref)
    print(json.dumps({"part_shapes": check_part_shapes(torch, cfg, mesh, hk, ref)}),
          flush=True)
    for r in rows:
        r["launches"] = launches[r["name"]]
    del prog, fields, first, fused, base, plain

    lap("phase_5")

    # phase 6: serve mamba2-2.7b at full width and depth
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as ssd
    torch.cuda.reset_peak_memory_stats()
    model_cfg, eng, params, batch_in, runs, setup_s, served = run_serve(
        torch, args.seed, "mamba2-2.7b", SERVE)
    held = eng.captured_launches("prefill")
    require(held["ssd_scan"] == model_cfg.n_layers and held["rmsnorm"] > 0,
            f"the mamba2 prefill graph does not hold the SSD and rmsnorm kernels: {held}")
    require(held["ssd_scan_wgmma"] == model_cfg.n_layers,
            f"the mamba2 prefill graph's SSD launches are not all on the tensor-core "
            f"route: {held}")
    require(served["ssd_scan"] > 0 and served["rmsnorm"] > 0,
            f"a kernel never launched serving mamba2: {served}")
    print(json.dumps({"serve": serve_report(torch, model_cfg, eng, SERVE, runs, setup_s,
                                            served)}), flush=True)
    ssd_launches, norm_launches = served["ssd_scan"], served["rmsnorm"]

    lap("phase_6")

    # phase 7: serving results, and where the time goes
    print(json.dumps({"serve_checks": check_serving(torch, eng, params, batch_in, runs,
                                                    SERVE)}), flush=True)
    print_profiles(torch, eng, params, batch_in, "")
    del eng, params, runs

    lap("phase_7")

    # phase 8: the SSD kernel against its plain version
    row, detail = check_ssd(torch, ssd, ref, args.seed)
    row["launches"] = ssd_launches
    print(json.dumps({"ssd_scan_check": detail}), flush=True)
    ssd_row = row

    lap("phase_8")

    # phase 9: serve gemma3-1b at full width and depth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model_cfg, eng, params, batch_in, runs, setup_s, served = run_serve(
        torch, args.seed, "gemma3-1b", DENSE_SERVE)
    n = model_cfg.n_layers
    held = eng.captured_launches("prefill")
    routes = {"flash_attention_wgmma": n, "flash_attention_cuda_core": 0}
    require({k: held[k] for k in routes} == routes,
            f"the gemma3 prefill graph holds flash launches {held}, not {n} on the "
            "tensor-core route and none on the CUDA-core route")
    require(held["rmsnorm"] >= 4 * n + 1, f"the gemma3 prefill graph holds "
            f"{held['rmsnorm']} rmsnorm launches: not one on every norm")
    require(served["flash_attention"] > 0 and served["rmsnorm"] > 0,
            f"a kernel never launched serving gemma3: {served}")
    print(json.dumps({"serve_dense": serve_report(torch, model_cfg, eng, DENSE_SERVE, runs,
                                                  setup_s, served)}), flush=True)
    flash_launches = served["flash_attention"]
    norm_launches += served["rmsnorm"]
    checks = check_serving(torch, eng, params, batch_in, runs, DENSE_SERVE)
    eager = checks["eager_prefill_launches"]
    require({k: eager.get(k, 0) for k in routes} == routes,
            f"the eager gemma3 prefill took flash routes {eager}, not {routes}")
    print(json.dumps({"serve_dense_checks": checks}), flush=True)
    print_profiles(torch, eng, params, batch_in, "_dense")

    lap("phase_9")

    # phase 10: flash attention and rmsnorm against their plain versions
    dense_rows, detail = check_dense_kernels(torch, eng, params, batch_in, fk, rk, ref,
                                             args.seed)
    dense_rows[0]["launches"], dense_rows[1]["launches"] = flash_launches, norm_launches
    print(json.dumps({"dense_kernel_checks": detail}), flush=True)
    del eng, params, runs

    lap("phase_10")

    # phase 11: convergence loops, device-resident against host-polled
    from repro_torch.kernels import graph_loop
    torch.cuda.empty_cache()
    conv, step_row = run_convergence(torch, cfg, mesh, u0, gpu_line(), hk, graph_loop)
    print(json.dumps({"convergence": conv}), flush=True)

    lap("phase_11")

    # phase 12: the linked N-part pipeline, one stream a program
    torch.cuda.empty_cache()
    pipeline, built = run_pipeline(torch, cfg, mesh, u0, gpu_line(), hk, graph_loop)
    print(json.dumps({"pipeline": pipeline}), flush=True)

    lap("phase_12")

    # phase 13: the verifier and the sanitizer
    print(json.dumps({"verifier": run_verifier(torch, cfg, mesh, u0, gpu_line(), hk, built)}),
          flush=True)
    del built

    lap("phase_13")

    # phase 14: the masked multi-queue loop, each part to its own count
    torch.cuda.empty_cache()
    masked, sched_row = run_masked(torch, cfg, mesh, u0, gpu_line(), hk, graph_loop)
    print(json.dumps({"masked": masked}), flush=True)

    lap("phase_14")

    # phase 15: the tuner
    torch.cuda.empty_cache()
    print(json.dumps({"tuner": run_tuner(torch, cfg, mesh, u0, gpu_line(), hk, args.seed)}),
          flush=True)

    lap("phase_15")

    # phase 16: the ring collectives at gemma3-1b's MLP widths
    torch.cuda.empty_cache()
    print(json.dumps({"collectives": run_collectives(torch, gpu_line(), args.seed)}),
          flush=True)

    lap("phase_16")

    # phase 17: continuous serving at full width and depth
    torch.cuda.empty_cache()
    cont, flash_shapes, norm_shapes, cont_launches = run_phase17(torch, args.seed, fk, rk,
                                                                 ref)
    print(json.dumps({"continuous": cont}), flush=True)
    dense_rows[0]["served_shapes"], dense_rows[1]["served_shapes"] = flash_shapes, norm_shapes
    for r in dense_rows + [ssd_row]:
        r["phase17_launches"] = cont_launches[r["name"]]

    lap("phase_17")

    # phase 18: training mamba2-2.7b at full width and depth
    train_out, bwd_rows, train_launches = run_phase18(torch, args.seed, ssd, rk, ref)
    print(json.dumps({"train": train_out}), flush=True)
    for r in bwd_rows:
        r["launches"] = train_launches[r["name"]]
    for r in dense_rows[1:] + [ssd_row]:
        r["phase18_launches"] = train_launches[r["name"]]

    lap("phase_18")

    # phase 19: the hybrid, encoder-decoder and vision families
    torch.cuda.empty_cache()
    families, flash19, norm19, ssd19, launches19, n16_row = run_phase19(
        torch, args.seed, fk, rk, ssd, ref)
    print(json.dumps({"families": families}), flush=True)
    dense_rows[0]["served_shapes"] += flash19
    dense_rows[1]["served_shapes"] += norm19
    ssd_row["served_shapes"] = ssd19
    for r in dense_rows + [ssd_row]:
        r["phase19_launches"] = launches19[r["name"]]

    lap("phase_19")

    # phase 20: the MoE family
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    moe_out, flash20, norm20, launches20 = run_phase20(torch, args.seed, fk, rk, ref)
    moe_out["seconds"] = time.perf_counter() - t20
    print(json.dumps({"moe": moe_out}), flush=True)
    dense_rows[0]["served_shapes"] += flash20
    dense_rows[1]["served_shapes"] += norm20
    for r in dense_rows:
        r["phase20_launches"] = launches20[r["name"]]
    require(all(launches20[k] > 0 for k in ("flash_attention", "rmsnorm")),
            f"phase 20: a kernel never launched serving the MoE family: {launches20}")

    lap("phase_20")

    # phase 21: training gemma3-1b at full width and depth
    t21 = time.perf_counter()
    dense_train, flash_bwd_row, norms21, launches21 = run_phase21(torch, args.seed, fk, rk,
                                                                  ref)
    dense_train["seconds"] = time.perf_counter() - t21
    print(json.dumps({"train_dense": dense_train}), flush=True)
    flash_bwd_row["launches"] = launches21["flash_attention_bwd"]
    bwd_rows[1]["training_shapes"].update(
        {f"gemma3_{k}": {n_: v[n_] for n_ in ("ms", "row_pass_ms", "dw_pass_ms", "plain_ms",
                                             "library_ms", "bound_ms")}
         for k, v in norms21.items()})
    bwd_rows[1]["max_abs_err"] = max(
        [bwd_rows[1]["max_abs_err"]] + [v[n_]["max_abs_err"] for v in norms21.values()
                                        for n_ in ("dx", "dw")])
    for r in dense_rows + [bwd_rows[1]]:
        r["phase21_launches"] = launches21[r["name"]]
    bwd_rows.append(flash_bwd_row)

    lap("phase_21")

    # phase 22: training the MoE family at full width
    t22 = time.perf_counter()
    moe_train, launches22, flash22, flash22_err, norms22 = run_phase22(torch, args.seed, fk,
                                                                       rk, ref)
    moe_train["seconds"] = time.perf_counter() - t22
    print(json.dumps({"train_moe": moe_train}), flush=True)
    require(all(launches22.get(k, 0) > 0 for k in ("flash_attention", "rmsnorm",
                                                   "flash_attention_bwd", "rmsnorm_bwd")),
            f"phase 22: a kernel never launched training the MoE family: {launches22}")
    flash_bwd_row["other_shapes"].update(flash22)
    flash_bwd_row["max_abs_err"] = max(flash_bwd_row["max_abs_err"], flash22_err)
    bwd_rows[1]["training_shapes"].update(
        {f"moe_{k}": {n_: v[n_] for n_ in ("ms", "row_pass_ms", "dw_pass_ms", "plain_ms",
                                          "library_ms", "bound_ms")}
         for k, v in norms22.items()})
    bwd_rows[1]["max_abs_err"] = max(
        [bwd_rows[1]["max_abs_err"]] + [v[n_]["max_abs_err"] for v in norms22.values()
                                        for n_ in ("dx", "dw")])
    for r in dense_rows + bwd_rows[1:]:
        r["phase22_launches"] = launches22.get(r["name"], 0)

    lap("phase_22")

    # phase 23: the step bundles, expert parallelism on the card, the dry run
    t23 = time.perf_counter()
    first_tokens = {arch: moe_out[arch]["first_tokens"] for arch in MOE_CUTS}
    sharded, launches23 = run_phase23(torch, args.seed, first_tokens, dry)
    sharded["seconds"] = time.perf_counter() - t23
    print(json.dumps({"sharding": sharded}), flush=True)
    require(all(launches23.get(k, 0) > 0 for k in ("flash_attention", "rmsnorm")),
            f"phase 23: a kernel never launched on the bundles' paths: {launches23}")
    for r in dense_rows:
        r["phase23_launches"] = launches23.get(r["name"], 0)

    lap("phase_23")

    # phase 24: training hymba-1.5b at full width and depth
    t24 = time.perf_counter()
    hybrid_train, bwd_n16_row, flash24, flash24_err, norms24, launches24 = run_phase24(
        torch, args.seed, fk, rk, ssd, ref)
    hybrid_train["seconds"] = time.perf_counter() - t24
    print(json.dumps({"train_hybrid": hybrid_train}), flush=True)
    bwd_n16_row["launches"] = launches24["ssd_scan_bwd_wgmma_n16"]
    n16_row["phase24_launches"] = launches24["ssd_scan_wgmma_n16"]
    flash_bwd_row["other_shapes"]["hymba_gqa5"] = flash24["times"]
    flash_bwd_row["max_abs_err"] = max(flash_bwd_row["max_abs_err"], flash24_err)
    bwd_rows[1]["training_shapes"].update(
        {f"hymba_{k}": {n_: v[n_] for n_ in ("ms", "row_pass_ms", "dw_pass_ms", "plain_ms",
                                            "library_ms", "bound_ms")}
         for k, v in norms24.items()})
    bwd_rows[1]["max_abs_err"] = max(
        [bwd_rows[1]["max_abs_err"]] + [v[n_]["max_abs_err"] for v in norms24.values()
                                        for n_ in ("dx", "dw")])
    for r in dense_rows + bwd_rows[1:]:
        r["phase24_launches"] = launches24.get(r["name"], 0)

    lap("phase_24")

    # phase 25: training qwen1.5-0.5b, glm4-9b (cut) and whisper-large-v3
    t25 = time.perf_counter()
    family_train, emb_row, flash25, flash25_err, norms25, launches25 = run_phase25(
        torch, args.seed, fk, rk, ref)
    family_train["seconds"] = time.perf_counter() - t25
    print(json.dumps({"train_families": family_train}), flush=True)
    require(all(launches25.get(k, 0) > 0 for k in ("flash_attention", "rmsnorm",
                                                   "flash_attention_bwd", "rmsnorm_bwd",
                                                   "embedding_bwd")),
            f"phase 25: a kernel never launched training the three models: {launches25}")
    flash_bwd_row["other_shapes"].update({k: v["times"] for k, v in flash25.items()})
    flash_bwd_row["max_abs_err"] = max(flash_bwd_row["max_abs_err"], flash25_err)
    bwd_rows[1]["training_shapes"].update(
        {f"phase25_{k}": {n_: v[n_] for n_ in ("ms", "row_pass_ms", "dw_pass_ms", "plain_ms",
                                              "library_ms", "bound_ms")}
         for k, v in norms25.items()})
    bwd_rows[1]["max_abs_err"] = max(
        [bwd_rows[1]["max_abs_err"]] + [v[n_]["max_abs_err"] for v in norms25.values()
                                        for n_ in ("dx", "dw")])
    for r in dense_rows + bwd_rows[1:]:
        r["phase25_launches"] = launches25.get(r["name"], 0)
    lap("phase_25")
    print(json.dumps({"phase_seconds": phase_s, "total_s": time.perf_counter() - t_run}),
          flush=True)

    rows = (rows + dense_rows + [ssd_row, n16_row, step_row, sched_row] + bwd_rows
            + [bwd_n16_row, emb_row])
    require(sorted(r["name"] for r in rows) == sorted(REPLACES), "a kernel row is missing")
    require(all(r["launches"] > 0 for r in rows), "a kernel was not launched on its path")
    order = ("name", "route", "kernel_route", "source", "replaces", "pallas_counterpart",
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "sector_bound_ms", "library_ms", "library_call", "library_fwd_bwd_ms",
             "library_fwd_ms", "training_shapes", "earlier_ms", "cuda_core_ms", "decode",
             "served_shapes", "phase17_launches", "phase18_launches", "phase19_launches",
             "phase20_launches", "phase21_launches", "phase22_launches",
             "phase23_launches", "phase24_launches", "phase25_launches", "shape", "parts",
             "cluster",
             "sdpa_kernels", "local_layer",
             "other_shapes", "one_program_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r} for r in rows]}))
    print(f"card: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

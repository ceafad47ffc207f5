#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --digests

Run from the root of a checkout; it builds the CUDA kernels itself.
``--digests`` runs only the kernels, on seeded inputs: the attention
kernels without a window, cap or offset at the serving shapes (the flash
backward at 13 (b)'s training shape, and the VLM's non-causal cross
shape, Sq 2048 over 1024 keys), then the planner's fp32 matmul and
tdFIR kernels (real and complex) at the paper's sizes, then the bf16
matmul at 3mm's 512^3 and granite-3-2b's MLP up-projection, then the
bf16 flash backward at 13 (d)'s training shape (D 256) and at B 4 × S
2048, and prints a
SHA-256 of each output and its ms (CUDA events and device time): run in
two checkouts (this script copied into the other one's root, where it
imports that checkout's kernels), the lines say whether their kernels
agree bit for bit and how their times compare.  With no argument it runs
these phases, each printing its seconds:

  1. card      the card's name and power limit (nvidia-smi), its idle
               power draw (the H100 envelope's idle watts) and the two TF32
               flags, both off;
  2. build     one nvcc per ``src/repro_torch/csrc/*.cu`` (matmul, tdfir,
               flash_attention, decode_attention, flash_attention_bwd),
               all started together,
               with each kernel's ``-Xptxas -v`` report; the flash, flash
               backward and matmul libraries' SASS (cuobjdump) must hold
               HGMMA (wgmma) instructions, the decode-attention library's
               HMMA (mma.sync: its grouped bf16 route), and the matmul and
               decode-attention libraries' SASS LDGSTS (cp.async)
               instructions; their counts are printed; the tdfir kernels,
               the backward's and decode's tensor-core kernels must not
               spill, and the tdfir kernels'
               16-byte shared loads (LDS.128) are counted; the backward's
               ``plan`` is held to the compiled one and printed;
  3. check     every kernel against its plain PyTorch version on the card: the
               JAX tests' shapes at their tolerances, the main-path shapes,
               the bf16 matmul on each route (``check_matmul_bf16``: 512^3
               and granite's MLP up-projection through TMA, 513x1001x511
               through registers, all on wgmma, at 2e-2, each call twice
               for the same bits, beside two simulated faults the limit
               must reject: the last K tile dropped, B read K-major),
               and lengths that are not multiples of the tile (matmul ragged
               in M, N and K, K below one 16-byte vector; decode lengths
               around the split size, all at 1, at and above the cache
               length, D=128 with 8 query heads a KV head, a 64-slot pool
               whose one split a row wraps each warp's cp.async ring), two
               identical decode calls that must agree bit for bit; bf16
               decode also held to a row-scaled limit (``kernels/parity.py``)
               against the plain version in fp32, which must reject four
               simulated kernel faults; for the bf16 tensor-core flash
               kernel every head dim, lengths around its 128-row tiles,
               causal and not, kv_group 1 and 4, held to an absolute and a
               row-scaled limit that must also reject four simulated faults
               at the main shapes; tdfir and its one-launch complex form at
               the edges of the blocked tap loop (K not a multiple of 4, N
               below one thread's outputs or not a multiple of 4, N < K,
               F = 1, the largest K each form accepts, and a K past it,
               which must raise), the complex form bitwise equal to four
               real launches and their combine, and one device kernel per
               complex call; flash at D=80 (h2o-danube) under its 4096
               window at S=5000 and 1000 and without it at S=5000, and
               under ragged windows (under one tile, past S, straddling
               tiles), a window of S or more bitwise equal to none; decode over h2o-danube's
               [4,4096,8,80] pool; flash and decode at D=128 with 6, 12
               and 7 query heads over 8 KV heads and 16 over 16
               (nemotron-4-15b, command-r-plus-104b, arctic-480b,
               moonshot-v1-16b-a3b): flash at S=2048 and 1000 in bf16 at
               both limits, beside the simulated faults at 2048 (and in
               fp32 at 2e-4 at the MoE layouts), decode over their
               [4,2112,KV,128] pool in bf16 at 5e-2 and the row limit
               beside simulated faults and in fp32 at 2e-4, each call made
               twice for the same bits; recurrentgemma-2b's D=256 at 10
               query heads over one KV head: flash under its 2048 window
               at S=4096 and 1000 (bf16 at both limits beside simulated
               faults, fp32 at 2e-4) and at windows straddling its 64-key
               tiles (the bf16 sweep takes D=256 too), decode over its
               [4,2048,1,256] ring at lens 1/1000/2048/2048 (bf16 at 5e-2
               and the row limit beside simulated faults, fp32 at 2e-4,
               each call twice for the same bits); the cross-attention
               families: non-causal flash over a context of another
               length (Sq below and above Skv, both ragged against the
               tiles, kv_group 1 and 8, D 64, 128 and 256, bf16 at both
               limits, fp32 at 2e-4), at phase 10's shapes (the VLM's
               H=64 over KV=8 at D=128, causal at S=2048 and 1000 and over
               its 1024 image tokens; the audio H=KV=16 at D=64, causal,
               over 3072 frames and its non-causal S=3072 encoder; bf16
               beside simulated faults, causal or non-causal as the walk
               is, fp32 at 2e-4), and decode at 8 query heads a KV head
               over [4,2112,8,128] and the full [4,1024,8,128] context, at
               one over [4,2112,16,64] and the full [4,3072,16,64] frames
               (bf16 at 5e-2 and the row limit beside simulated faults,
               fp32 at 2e-4, each call twice for the same bits); the bf16
               decode kernel's tensor-core route over every group it takes
               (``DECODE_MMA_GROUPS``: 2 to 16 query heads a KV head, 10 at
               D=256) at every head dim (``check_decode_routes``: a row of
               length 0, one ending inside a key tile and one whole, with
               its lse; at 5e-2 and the row limit beside simulated faults,
               each call twice for the same bits), every decode row above
               printing its route; the flash
               backward (``BWD_CASES``: granite's H=32 over KV=8 at D=64,
               S 2048, 1000 and 50, h2o-danube's D=80 under its window at
               S=5000, recurrentgemma's D=256 at 10 query heads a KV head
               under its window, the VLM's non-causal 2048 over 1024 at
               D=128 and seamless's non-causal MHA over 3072 frames) on
               the forward kernel's output and saved log-sum-exp (held
               first to the plain one: fp32 1e-5, bf16 1e-3 absolute
               against the plain forward in fp32): fp32 at 2e-4, bf16
               against the plain backward in fp32 at 1e-2 of each
               gradient's largest
               entry and a floored row limit (``kernels/parity.py``)
               beside simulated faults (a dropped mask, a dK missing a
               group member, Delta one row off, dQ scaled by sqrt(D)),
               each call twice for the same bits; logit soft caps and the
               query offset (``check_softcap``): flash at granite's S=2048
               capped at SOFTCAP_CHECK and a causal chunk of 1000 queries
               over 2048 keys at its offset, with and without the cap,
               bf16 and fp32; every head dim's tile capped and offset;
               decode at the main pool and recurrentgemma's ring capped
               (its lse too, twice for the same bits); the backward at
               ``SOFTCAP_BWD_CASES``; each at the limits of the uncapped
               call beside fault controls that they must reject (the cap
               dropped, its derivative dropped, the offset dropped);
  4. time      each kernel, its plain version and the library call at the
               main-path shapes (CUDA events over many launches after a
               warm-up, and device time per call from torch.profiler),
               beside the least time the card could take; flash attention
               also at the ragged S=1000 and at D=128, decode attention also
               with every slot at 2112, the complex tdFIR bank beside one
               grouped ``F.conv1d`` and beside four real launches, the bf16
               matmul (PERF.md rows 1', 1'' and the unaligned route: 512^3,
               the MLP up-projection, 513x1001x511) beside ``torch.matmul``
               with its route and plan; the matmul, tdfir and decode
               launch plans; the flash backward at granite's training
               shape (B 4, S 2048, bf16) and at nemotron-4-15b's heads (B
               1, H 48 over KV 8, S 2048, D 128) beside SDPA's backward,
               and at recurrentgemma-2b's (H 10 over KV 1, D 256, window
               2048: B 2 x S 4096 and B 4 x S 2048, each first held to the
               plain backward at phase 3's bf16 limits, twice for the same
               bits, beside a control with the KV rows swapped), three
               device kernels a call, each kernel's device time;
               a profile of one decode-attention call must hold exactly one
               device kernel; each decode row names its route (``hmma``:
               the tensor cores; ``lanes``: the CUDA cores); h2o-danube's windowed and unwindowed S=5000,
               D=80 prefill beside SDPA (with the boolean causal-and-window
               mask) and its decode pool beside masked SDPA, the same
               S=1000 prefill under the window, and flash and decode at
               the head groups of nemotron-4-15b and command-r-plus-104b
               (H=48 and 96 over KV=8, D=128; the prefill at S=2048 and
               1000 beside causal SDPA, decode over [4,2112,8,128] beside
               masked SDPA), the same at arctic-480b's 56 over 8 and
               moonshot-v1-16b-a3b's 16 over 16 heads, and at
               recurrentgemma-2b's D=256, 10 over 1 (the windowed S=4096
               prefill beside SDPA with the boolean mask, S=1000 beside
               causal GQA SDPA, the decode ring beside masked SDPA);
               phase 10's shapes: the VLM's cross attention (Sq 2048 and
               1000 over 1024) and the audio cross attention (over 3072)
               and encoder (S=3072) beside non-causal SDPA (GQA where KV <
               H), both families' causal S=2048 self-attention beside
               causal SDPA, and decode over their pools and whole contexts
               beside masked SDPA; the decode kernel with its ``lse``
               output against its plain version at phase 15 (c)'s slice
               of the cache ([4,1056,8,64] fp32, 32 heads) and at the
               second half of the main pool, where three rows hold no
               valid key (zeros and -1e30), and timed against the call
               without it at the main shape; the capped rows under Gemma
               2's cap of 50 (the flash forward at S=2048, the backward at
               B 4, decode at the main pool), each beside the uncapped
               call, and the offset chunk forward and backward beside
               SDPA with its boolean mask (``time_softcap``);
  5. plan      the port's planner (``repro_torch.quickstart`` settings) over
               3mm, tdFIR and NAS.BT at the paper's sizes, with the launch
               counters set to 0 just before and read just after (the
               linted runs below included); then each app at its small
               size through ``plan_offload(lint_choice=)`` with a lint
               that rejects one pattern its loop searches meet
               (``PLAN_LINT_REJECT``: 3mm's FPGA-analogue ``mm1_E_AB``):
               that pattern never built or measured, ``static_pruned`` at
               least 1, at most 4 FPGA-analogue measurements, a correct
               selection, and matmul (3mm) and tdfir (tdFIR) launched;
  6. serve     the port's continuous batcher on granite-3-2b at full width,
               its decode step captured in a CUDA graph and replayed each
               tick (no step may run from Python), beside an engine that
               runs the step eagerly: (a) 2 layers in fp32, eight staggered
               requests whose greedy tokens must equal batch-1
               ``generate``'s and whose logits must lie within 1e-5 of the
               eager engine's; (b) 20 of its 40 layers in bf16, the same trace,
               every request complete and no NaN logit, with wall and
               tick-clock metrics, tokens per wall second and the device's
               idle share over a whole engine run (graph and eager: the
               kernel time of a profiled run over the wall time of the
               unprofiled one, beside the profiled run's own wall, which
               the profiler lengthens), the
               share of tokens that agree with ``generate``, and profiles
               of a prefill and a decode step (graph and eager: wall and
               device ms, the heaviest kernels and host ops, decode
               attention's share);
  7. family    the rest of the dense family in bf16 through the same engine,
               8 requests a cell: (c) h2o-danube-1.8b at full width and depth
               (prompts 1000 and 5000 past its 4096 window, a wrapped ring),
               (d) nemotron-4-15b at full width and depth, (e)
               command-r-plus-104b at full width, 4 of its 64 layers, (f)
               granite-3-2b with the int8 KV cache, whose first decode step
               must lie within 0.05 of the exact cache's in probability.
               Every engine run of phases 6 and 7 sets the launch counters
               to 0 before and requires one flash-attention launch per layer
               and prefill and one decode-attention launch per layer and
               decode step, counted across graph replays (none under the
               int8 cache: its decode attention is plain torch, as the JAX
               one is jnp);
  8. moe       the MoE family through the same engine, phase 7's trace:
               (g') moonshot-v1-16b-a3b at full width, 2 layers in fp32,
               whose greedy tokens must equal batch-1 ``generate``'s, whose
               graph-replayed logits must equal an eager engine's bit for
               bit, and one state's step replayed twice for the same bits;
               (g) moonshot-v1-16b-a3b at 8 of its 48 layers and (h)
               arctic-480b at 2 of its 35, at full width in bf16, with
               phase 7's metrics, the device idle share of an unprofiled
               run, the step's
               bound (every weight read once: the dispatch runs all
               experts), and the step's device time split into attention,
               GEMMs and the rest (a graph replay, by kernel name) and into
               the expert GEMMs, the shared or dense FFN, routing with
               dispatch and combine, and decode attention (an eager step,
               by ``record_function`` ranges).  Every cell prints the
               dropped share of (token, k) pairs at each prefill length
               and requires every decode step's pairs routed with none
               dropped (each slot routed as its own group); the launch
               counts are those of phases 6 and 7;
  9. recurrent the SSM and hybrid families through the same engine, 8
               requests a cell: (i') mamba2-1.3b at full width, 2 of its 48
               layers in fp32, prompts 1024 and 2048 (its SSD chunk of 256
               must divide them), and (j') recurrentgemma-2b at full width,
               5 of its 26 layers (one group of two recurrent blocks and a
               local attention, and a tail of two) in fp32, prompts 1000
               and 4096 (past its 2048 window), each with phase 6 (a)'s
               checks (tokens equal to batch-1 ``generate``'s, graph logits
               within 1e-5 of an eager engine's, one state's step replayed
               twice for the same bits); then (i) mamba2-1.3b at 12 of
               its 48 layers and (j) recurrentgemma-2b whole in bf16
               (cache_len 2112 and 4160)
               with phase 8's metrics: the step beside its bytes bound
               (the weights and the recurrent state read and written once,
               the rings' valid rows), tokens per wall second, the idle
               share of an unprofiled run, the prefill ms at each prompt
               length, and the step's device time split into attention,
               GEMMs, the scan and state updates (the ``ssm.state`` and
               ``rglru.state`` ranges of an eager step) and the rest; one
               flash launch per attention layer and prefill and one decode
               launch per attention layer and step (8 each for (j), none
               for (i));
 10. cross     the cross-attention families through the same engine,
               phase 7's trace, each request with its own seeded context
               (``launch.serve.request_extras``: image embeddings or audio
               frames, the reference's stub frontends): (k')
               llama-3.2-vision-90b at full width, 1 of its 20 groups (4
               self and 1 cross layer) in fp32, and (l')
               seamless-m4t-medium whole in fp32, each with phase 6 (a)'s
               checks (tokens equal to batch-1 ``generate``'s, graph
               logits within 1e-5 of an eager engine's, one state's step
               replayed twice for the same bits); then (k) the VLM at 1 of
               its 20 groups (5 of 100 layers) and (l) seamless whole in
               bf16 with phase 9's metrics: the step beside its bytes
               bound (the decoder's weights, the self-attention pool's
               valid rows, every slot's whole cross K/V), tokens per wall
               second, the idle share of an unprofiled run, the prefill ms
               at each prompt length, and a prefill's and an eager step's
               device time split into self attention, cross attention
               (the attention kernels labelled by their order on the
               stream), the audio encoder, GEMMs and the rest; flash
               launches 10 (k) and 36 (l) a prefill (self, cross and
               encoder layers), decode launches 10 and 24 a step (self and
               cross layers);
 11. modeled   the planner's modeled-cost path: each app of phase 5 at the
               paper's sizes through ``plan_offload`` with a
               ``CompiledCostRunner`` on the one-device mesh (every correct
               dp / tp winner traced on fake tensors and scored by the H100
               roofline) and ``publish=`` a ``PlanLookup`` over a
               ``SearchCache`` on disk, under the host-time (with a
               ``lint_choice`` that rejects nothing, whose verdicts must
               equal phase 5's unlinted ones) and the modeled
               policy: phase 5's verdicts, a modeled time and a roofline on
               every correct dp / tp record and none on the FPGA
               analogue's, no kernel launch while a candidate is traced,
               matmul and tdfir launched in the phase, a warm lookup key
               for each destination with a correct record and a failure
               for each with only wrong ones, and a second scoring pass
               over those keys, with the tracer poisoned, that only looks
               up; per record the measured and modeled ms, their ratio,
               the dominant term, the FLOPs by dtype and the bytes, the
               selection under each policy, the planner's wall beside
               phase 5's and the seconds spent tracing; then the dp and
               tp winners of the host-time runs traced by ``dist.bridge``
               on a ("data", "model") mesh of BRIDGE_MESH under the fake
               process group, in a child process (one device's trace on
               DTensor shards): every pair correct, no launch while
               traced, the modeled ms and collective bytes per device
               beside the one-device ones;
 12. fleet     the router, health, fleet, control and observability layers
               over phase 11's lookup (its H100 verdicts), with every
               trace, graph capture and launch forbidden
               (``kernels.ops.no_device_work``): each app's seeded
               open-loop trace (120 requests) routed under the modeled
               policy over one endpoint a destination, every request on a
               destination with a correct verdict and the lookup's trace
               counter flat, routes per second on the host; each bf16
               serving cell of phases 6–10 as an endpoint (its config as
               built, 4 slots, its cache_len, its decode step published
               through ``analysis_from_time``), none of its requests
               lint-pruned at the H100's 80 GiB, and command-r-plus-104b,
               arctic-480b and llama-3.2-vision-90b whole P019 errors, the
               lint's params + pool printed beside the bytes the card held
               (``torch.cuda.memory_allocated`` before each model and once
               its engine was built, read in phases 6–10); a
               ``FleetPlanner`` placement of the three apps, then per app
               the reference's chaos kill scenario (the selected endpoint
               dead from tick 20 to 60) with 0 dropped, 0 double
               completions, a recovered circuit, no replan onto a failure
               verdict, a fleet draw never negative and two runs' JSONL
               byte-identical; the JSONL and Chrome trace written to a
               temporary directory and ``python -m repro_torch.obs.report``
               run on the JSONL, which must exit 0; the recovery ticks and
               the joules a request before the kill and after recovery;
 13. train     granite-3-2b trained on the card: (a') 2 layers at full
               width in fp32, B 2, S 256: the loss, every gradient and one
               ``make_train_step``'s parameters against the same on the
               CPU (1e-5 relative, 2e-4 of each leaf's max), flash
               forward twice and backward once a layer; (b) the whole
               model in bf16, B 4, S 2048, block remat, vocab_chunk 2048,
               AdamW with fp32 moments: a warm-up and 8 timed steps
               (losses finite and falling, no NaN, 80 forward and 40
               backward launches a step), step wall and device ms,
               tokens per second, the model-FLOPs share of the bf16 peak,
               the idle share, the device time split into GEMMs, flash
               forward, flash backward, the loss, the optimizer and the
               rest, and peak memory; (c) ``launch.train.main`` on
               reduced granite: 25 steps whose loss falls by more than
               0.2, then 10 steps saving every 5 and 15 resuming at step
               10 with the restored parameters bitwise equal to the
               saved; (d) recurrentgemma-2b whole (26 layers, 8 of them
               local attention at D 256, 10 query heads over 1 KV head,
               window 2048) in bf16 at B 2, S 4096 as (b), 3 timed steps
               (16 forward and 8 backward launches a step, the profiled
               step's backward all on the D = 256 tensor-core kernels),
               after its checks on the step cut to 3 layers at B 1: the
               first bf16 loss within 2e-2 relative of the same weights'
               fp32 loss, and the backward's outputs in that step, on the
               inputs it was given, at phase 3's bf16 limits;
 14. dist      distribution with explicit collectives: (a) granite-3-2b
               at full width, 20 of its 40 layers, in bf16 at (b)'s
               shape, seed and AdamW on one NCCL
               rank, a ("pod", "data", "model") mesh of (1, 1, 1): the
               uncompressed pod-parallel step's loss, gradients and
               updated parameters bitwise equal to ``make_train_step``'s
               from the same state, the compressed step's reduced
               gradients within max|g| / 254 of each leaf's and its error
               feedback exactly g - out, then a warm-up and 4 timed
               compressed steps from the initial weights (losses finite
               and falling, 40 flash forward and 20 backward launches a
               step), the plain and compressed pod steps' wall and device
               ms, the error feedback's bytes and the peak memory; (b) two
               spawned processes on the one card over a gloo group (card
               tensors pass its point-to-point ops through host memory,
               counted): the pod
               step at full width, 2 layers in fp32, B 4, S 256, pod = 2,
               within 2e-4 of each leaf's max of the whole-batch step and
               the compressed one within its int8 bound; ``pipeline_apply``
               and ``make_pipeline_train_step`` with tanh(h @ w) stages at
               D 2048, B 64 (gpipe and one_f_one_b on 2 stages,
               interleaved on 4 with V 2, m in {1, S, 4S}) against
               ``sequential_apply`` at the reference test's limits; and
               ``apply_moe_ep`` on moonshot-v1-16b-a3b's MoE layer at full
               width over model = 2 against ``apply_moe`` (y within 1e-4,
               aux within 0.05, every gradient nonzero, both ranks holding
               the same gradients);
 15. part      automatic partitioning: two spawned processes on the one
               card over a gloo group, a ("data", "model") mesh of (1, 2),
               granite-3-2b at full width built with ``Rules`` (16 of 32
               heads and 4 of 8 KV heads a rank, ff and vocab halved):
               (a) 2 layers in fp32, B 4, S 256: the sharded
               ``make_train_step`` against the plain one from the same
               weights in the same process, the loss within 1e-5
               relative, each gathered gradient and updated parameter
               within 2e-4 of its leaf's max, the flash forward twice and
               the backward once a layer on each rank's heads; (b) 2
               layers in bf16, B 4, S 2048, block remat: a warm-up and 3
               timed steps (the loss falls), step wall and device ms,
               peak memory and the collectives staged through host memory
               per rank; (c) 2 layers in fp32: four 1000-token prompts
               prefilled into a 2112-slot cache and 16 greedy decode
               steps, heads-sharded and with ``decode_kv_seq_shard``
               (each rank decodes half the slots and the halves merge by
               their ``lse``), logits within 1e-4 of the unsharded LM's
               and the same tokens, the decode kernel launched a layer
               and step on each rank; (d) every other family and the int8
               cache at full width and a cut depth (``PART_FAMILIES``:
               moonshot-v1-16b-a3b's grouped MoE at 2 layers,
               mamba2-1.3b at 2, recurrentgemma-2b's (recurrent,
               recurrent, local attention) group, seamless-m4t-medium at
               2 encoder and 2 decoder layers, llama-3.2-vision-90b's
               group of 4 self and 1 cross layer in bf16, granite-3-2b
               with the int8 cache at 2), each against the same LM
               unpartitioned on the card: a train step's loss and
               updated parameters, a prefill and 2 decode steps' logits
               and tokens, heads- or kv_seq-sharded, the flash forward,
               backward and decode launches each path needs;
 16. pod part  the pod-parallel step partitioned inside each pod: four
               spawned processes on the one card over a gloo group, a
               ("pod", "data", "model") mesh of POD_PART_MESH,
               granite-3-2b at full width built with ``Rules`` (each LM
               on its pod's ("data", "model") sub-mesh, 16 of 32 heads a
               rank), 2 layers in fp32, B 4, S 256: the pod gradients and
               one pod step against the whole-batch ``make_train_step`` of
               the same LM unpartitioned in each process (loss within
               1e-5 relative, gradients and parameters within 2e-4 of
               each leaf's max), the compressed gradients within max over
               pods of max|g_p| / 127 of the plain ones, every leaf and its
               error feedback a rank's share, then POD_PART_STEPS timed
               steps (wall and device ms per rank, peak memory,
               collectives staged through host memory), the flash
               forward twice and the backward once a layer and step;
 17. analysis  static analysis and the dry run: (a) the CUDA kernel lint
               (``analysis.kernel_lint``: every output element written
               once, every access in bounds, sm_90's launch limits, no
               aliasing) over the launch plans of the shapes phases 3-16
               launched, no error; (b) the dry-run cells of
               ``DRYRUN_CELLS`` (granite-3-2b train_4k and decode_32k on
               the (16, 16) mesh, train_4k on the (2, 16, 16) one) through
               ``launch.dryrun.run_cell``, traced on a fake process group
               of 512 ranks with the card's device type in a child process
               started before phase 2 and waited for at the build's end
               (its seconds beside the build's): no kernel launch and no
               card allocation while traced, fake flash forward and
               backward (train) or decode calls recorded, a finite
               positive roofline, the per-card peak, ``fits_80GiB``, the
               modeled step and energy printed; (c) the cell of
               ``DRYRUN_PRUNED`` (microbatches 3) pruned by P002 untraced;
               (d) phase 13 (b)'s training shape traced on one device: its
               peak estimate over 13 (b)'s measured peak memory and its
               modeled step over 13 (b)'s device ms, printed (not gated);
 18. softcap   logit soft caps on the LM (``run_softcap``): (a)
               granite-3-2b at full width, 2 layers in fp32, capped at
               SOFTCAP_PARITY: 4 requests through the captured batcher,
               tokens equal to the CPU batcher's (the plain versions), the
               capped prefill logits far from the uncapped LM's, one train
               step against the CPU's within 13 (a')'s limits; (b) the
               whole model in bf16 under Gemma 2's cap of 50: 4 requests
               on the captured engine beside the same weights uncapped
               (decode ms a step, wall and CUDA events), then 3 train steps
               at 13 (b)'s shape (wall and CUDA-event ms, peak memory,
               beside 13 (b)'s), the flash and decode launches;
 19. examples  ``repro_torch.autoplan_model`` (its GA in a child process
               started before phase 2, run twice over one disk cache: no
               launch, no card byte, one trace a structural key, none on
               the warm cache), then on the card ``serve_lm --trace 6``
               over its trio, ``train_lm`` (the loss falls by 0.2, no
               restart) and ``train_lm --wide`` (``run_examples``).

It then prints one JSON line of per-kernel numbers, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failure ends the script with a traceback and a non-zero exit; without a
CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.cost_model import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.core.cost_model import PEAK_FLOPS_BY_DTYPE  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet), the cost model's
FP32_PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["fp32"]     # non-tensor fp32
BF16_PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bf16"]     # dense bf16, tensor cores

MATMUL_MAIN = (512, 512, 512)              # 3mm at N=512, fp32
# (M, K, N) of the bf16 matmul's rows beyond 3mm's shape (phases 3 and 4):
# granite-3-2b's MLP up-projection at phase 13 (b)'s tokens (B 4 x S 2048,
# d_model 2048, d_ff 8192), and operands TMA cannot map (K and N not
# multiples of 8: the route that fills its stages from registers)
MATMUL_MLP = (8192, 2048, 8192)
MATMUL_UNALIGNED = (513, 1001, 511)
# the planner's apps at the paper's sizes (phases 5 and 11), and the
# policies phase 11 selects under
PLANNER_APPS = ("3mm", "tdFIR", "NAS.BT")
MODELED_POLICIES = ("host-time", "modeled")
# phase 5's linted runs: the one pattern (nest, destination keys) a lint
# rejects in each app; 3mm's is an FPGA-analogue pattern, as in
# tests/test_analysis.py.  tdFIR and NAS.BT give the FPGA loop search no
# pattern (NAS.BT has no kernel-capable nest; tdFIR's filter bank is
# pinned by its function-block verification), so theirs is a many-core /
# GPU loop pattern: tdFIR's output scaling, NAS.BT's wrong smoother
PLAN_LINT_REJECT = {"3mm": ("mm1_E_AB", ("pallas",)),
                    "tdFIR": ("scale_output", ("dp",)),
                    "NAS.BT": ("seidel_relax", ("dp", "tp"))}
# phase 11: the dp and tp winners traced on a ("data", "model") mesh of the
# fake process group, one device's trace
BRIDGE_MESH = (4, 2)
BRIDGE_ROLES = {"many-core CPU": "data", "GPU": "model"}
TDFIR_MAIN = (64, 4096, 128)               # F, N, K of the paper's tdFIR
TDFIR_MAIN_BLOCK_N = 128                   # the app's max(128, K)
# granite-3-2b serving (phase 6): B, H, KV, S, D of the longest prefill, and
# the 4-slot decode pool at the trace's per-slot lengths
FLASH_MAIN = (1, 32, 8, 2048, 64)
FLASH_RAGGED_S = 1000
FLASH_WIDE_D = 128             # nemotron, command-r+, arctic, ... head dim
DECODE_MAIN = (4, 32, 8, 2112, 64)
DECODE_MAIN_LENS = (1, 300, 1000, 2112)
# a 64-slot pool: one split a row, so each warp's cp.async ring wraps
# the bf16 decode kernel's tensor-core route: every group it takes (up to
# 16 query heads a KV head, 10 at D = 256), swept over each head dim on a
# [3, 700, 2, D] pool at lengths 0 (no key), 333 (inside a key tile), 700
# decode attention's device kernels: the CUDA-core route's, the tensor-core
# route's
DECODE_KERNELS = ("decode_kernel", "decode_mma_kernel")
DECODE_MMA_GROUPS = (2, 3, 4, 6, 7, 8, 10, 12, 16)
DECODE_MMA_SWEEP = (3, 2, 700, (0, 333, 700))   # B, KV, S, lengths
# long caches over one KV head, whose live splits merge in the route's tree
# (more than MERGE_FAN of them): (B, H, KV, S, D), lengths
DECODE_MMA_TREE = (((2, 12, 1, 32768, 128), (30001, 777)),
                   ((1, 10, 1, 32768, 256), (32768,)))
DECODE_WRAP = (64, 32, 8, 2112, 64)
DECODE_WRAP_LENS = (1, 17, 300, 640, 1000, 2111, 2112, 2500) * 8
SERVE_ARCH = "granite-3-2b"
# (b) keeps 20 of granite's 40 layers (whole until phases 18 and 19 came,
# to pay for them; phase 18 (b) serves all 40, capped and not)
SERVE_LAYERS = 20
SERVE_PROMPTS = (1000, 2048)               # alternating prompt lengths
SERVE_GENS = (16, 64, 32, 48, 24, 56, 40, 64)  # (a): mixed max_gen
SERVE_MAX_GEN = 64                         # (b)
SERVE_SLOTS = 4
SERVE_CACHE_LEN = 2112                     # 2048 + 64
# h2o-danube-1.8b (phase 4 rows, phase 7 (c)): B, H, KV, S, D of its
# 5000-token prefill under its 4096-token window, and its 4-slot decode
# pool (W = 4096 slots) at one short, one mid and two wrapped rings
H2O_FLASH = (1, 32, 8, 5000, 80)
H2O_WINDOW = 4096
H2O_DECODE = (4, 32, 8, 4096, 80)
H2O_DECODE_LENS = (1, 1000, 4096, 4096)
# nemotron-4-15b and command-r-plus-104b (phase 7 (d), (e)): query heads
# over 8 KV heads at D=128, 6 and 12 a KV head
WIDE_GROUP_HEADS = (48, 96)
# arctic-480b and moonshot-v1-16b-a3b (phase 8 (h), (g)): (H, KV) at D=128,
# 7 query heads a KV head and 16 over 16
MOE_LAYOUTS = ((56, 8), (16, 16))
# every (H, KV) at D=128 that phases 7 and 8 serve
WIDE_LAYOUTS = tuple((h, 8) for h in WIDE_GROUP_HEADS) + MOE_LAYOUTS
# phase 7: (label, arch, layers kept (None: all), prompts, cache_len,
# int8 KV cache); 8 requests, one arrival a tick, 4 slots, max_gen 64
FAMILY_CELLS = (
    ("c", "h2o-danube-1.8b", None, (1000, 5000), 5120, False),
    ("d", "nemotron-4-15b", None, (1000, 2048), 2112, False),
    ("e", "command-r-plus-104b", 4, (1000, 2048), 2112, False),
    ("f", "granite-3-2b", None, SERVE_PROMPTS, SERVE_CACHE_LEN, True),
)
# phase 8: (label, arch, layers kept (None: all), why the depth is cut);
# phase 7's trace, prompts and cache_len; (g') is moonshot at 2 layers in
# fp32, the parity cell.  (g) keeps 8 of moonshot's 48 layers (whole
# until phase 15 (d) came, 24 until phases 18 and 19 came), to pay for
# them within the script's time
MOE_CELLS = (("g", "moonshot-v1-16b-a3b", 8,
              "fits one card; cut to pay for phases 15 (d), 18 and 19"),
             ("h", "arctic-480b", 2, "would not fit one card"))
MOE_PARITY_ARCH = "moonshot-v1-16b-a3b"
# recurrentgemma-2b (phase 3, phase 4 rows, phase 9 (j)): B, H, KV, S, D of
# its 4096-token prefill under its 2048-token local-attention window, and
# its 4-slot decode ring (W = 2048 slots) at a short, a mid and two full
# (wrapped) rings
GRIFFIN_FLASH = (1, 10, 1, 4096, 256)
GRIFFIN_WINDOW = 2048
GRIFFIN_DECODE = (4, 10, 1, 2048, 256)
GRIFFIN_DECODE_LENS = (1, 1000, 2048, 2048)
# phase 9: (label, arch, layers kept (None: all), prompts, cache_len); 8
# requests, one arrival a tick, 4 slots, max_gen 64.  mamba2's prompts
# divide its SSD chunk of 256 (the JAX model asserts it); recurrentgemma's
# 4096 is past its window.  (i) keeps 12 of mamba2's 48 identical layers
# (whole until phase 16 came, 24 until phases 18 and 19 came), to pay for
# phase 16, phase 11's mesh and phases 18 and 19
RECURRENT_CELLS = (("i", "mamba2-1.3b", 12, (1024, 2048), 2112),
                   ("j", "recurrentgemma-2b", None, (1000, 4096), 4160))
# the parity cells (i'), (j'), (k'), (l'): layers kept (None: all), in
# fp32 (recurrentgemma's 5 are one group of (recurrent, recurrent, local
# attention) and a tail of two recurrent blocks, the whole model's 8 x 3 +
# 2 in small; llama-3.2-vision-90b's 5 are one of its 20 groups of 4 self
# and 1 cross layer)
PARITY_LAYERS = {"i": 2, "j": 5, "k": 5, "l": None}
# llama-3.2-vision-90b (phase 3, phase 4 rows, phase 10 (k)): H, KV, D and
# its 1024 image tokens; seamless-m4t-medium (phase 10 (l)): H, KV, D and
# its 3072 audio frames (the encoder's length)
VLM_HEADS = (64, 8, 128)
VLM_CTX = 1024
AUDIO_HEADS = (16, 16, 64)
AUDIO_CTX = 3072
# phase 10: (label, arch, layers kept (None: all), flash launches a
# prefill, decode launches a step); phase 7's trace, prompts and
# cache_len, each request with its own context.  (k) keeps 1 of the VLM's
# 20 groups (5 of its 100 layers: 4 self, 1 cross; 2 groups until phases
# 18 and 19 came, 4 until phase 15), so that the script stays within its
# 1200 s; (l) is seamless whole (12 encoder, 12 self and 12 cross layers)
CROSS_CELLS = (("k", "llama-3.2-vision-90b", 5, 5, 5),
               ("l", "seamless-m4t-medium", None, 36, 24))
# the flash backward's shapes (phase 3): (what, H, KV, Sq, Skv, D, causal,
# window); granite's first at S 2048 (its main path's heads), then ragged
# S, S under one tile, h2o-danube's D 80 under its window, recurrentgemma's
# D 256 at 10 query heads a KV head under its window (13 (d)'s attention
# at B 1), the VLM's cross attention and seamless's non-causal MHA over its
# frames
BWD_CASES = (
    ("granite", 32, 8, 2048, 2048, 64, True, 0),
    ("granite ragged", 32, 8, FLASH_RAGGED_S, FLASH_RAGGED_S, 64, True, 0),
    ("granite under one tile", 32, 8, 50, 50, 64, True, 0),
    ("h2o-danube", 32, 8, H2O_FLASH[3], H2O_FLASH[3], 80, True, H2O_WINDOW),
    ("recurrentgemma", 10, 1, GRIFFIN_FLASH[3], GRIFFIN_FLASH[3], 256, True,
     GRIFFIN_WINDOW),
    ("llama-3.2-vision cross", VLM_HEADS[0], VLM_HEADS[1], 2048, VLM_CTX,
     VLM_HEADS[2], False, 0),
    ("seamless cross", AUDIO_HEADS[0], AUDIO_HEADS[1], 2048, AUDIO_CTX,
     AUDIO_HEADS[2], False, 0),
)
# phase 13, training granite-3-2b: (a') 2 layers in fp32 at B 2, S 256 on
# the card against the same step on the CPU; (b) the whole model in bf16 at
# B 4, S 2048, block remat, vocab_chunk 2048: a warm-up step, TRAIN_STEPS
# timed steps and a profiled one
TRAIN_ARCH = "granite-3-2b"
TRAIN_PARITY = (2, 2, 256)          # layers, B, S
TRAIN_SHAPE = (4, 2048)             # B, S
TRAIN_VOCAB_CHUNK = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
# (d) recurrentgemma-2b whole in bf16 (26 layers, the third of each group
# of three a local attention: 8, window 2048, D 256, 10 query heads over 1
# KV head) at B 2, S 4096 (13 (b)'s 8192 tokens a step; the window masks
# half the causal pairs), as (b): a warm-up step, TRAIN_RG_STEPS timed
# steps and a profiled one.  Its checks run first on the step cut to one
# group (layers, B), at PART_BF16_TOL and phase 3's bf16 backward limits,
# both set before the cell first ran
TRAIN_RG_ARCH = "recurrentgemma-2b"
TRAIN_RG_SHAPE = (2, 4096)          # B, S
TRAIN_RG_STEPS = 3
TRAIN_RG_CHECK = (3, 1)             # layers, B
# phase 14, distribution: (a) the pod-parallel step of granite-3-2b at full
# width, DIST_POD_LAYERS of its 40 layers (whole until 13 (d) came, to pay
# for it), in bf16 at 13 (b)'s shape and seed on one NCCL rank, a (pod,
# data, model) mesh of (1, 1, 1), a warm-up and DIST_STEPS timed
# compressed steps; (b)
# two gloo ranks on the one card: the pod step at full width (layers, B, S)
# with pod = 2, the pipeline's tanh(h @ w) stages at granite's width
# (D, B), and moonshot's MoE layer (x of B, S) over model = 2
DIST_STEPS = 4
DIST_POD_LAYERS = 20
DIST_POD = (2, 4, 256)
DIST_PIPE = (2048, 64)
DIST_PIPE_CASES = (("gpipe", 2, 1), ("one_f_one_b", 2, 1),
                   ("interleaved", 4, 2))     # schedule, stages, V
DIST_MOE_ARCH = "moonshot-v1-16b-a3b"
DIST_MOE_X = (4, 256)
# phase 15, automatic partitioning of granite-3-2b on a (data, model) mesh
# of (1, 2) over two gloo ranks on the one card: (a) layers, B, S in fp32;
# (b) layers, B, S, timed steps in bf16 (2 layers: 4 until phases 18 and
# 19 came); (c) layers, prompts, prompt length, cache slots, decode steps
# in fp32
PART_MESH = (1, 2)
PART_TRAIN = (2, 4, 256)
PART_STEPS = (2, 4, 2048, 3)
PART_SERVE = (2, 4, 1000, 2112, 16)
# phase 15 (d): the other families and the int8 cache on the same mesh at
# full width and a cut depth, each against the same LM unpartitioned on the
# card: (label, arch, layers kept (the audio family's encoder layers too),
# dtype, plan fields, decode sharding, flash forward / backward launches of
# the train step, flash launches of the prefill, decode launches a step).
# The VLM's group (4 self and 1 cross layer, 6.4 B parameters) runs in
# bf16: in fp32 its plain train step alone (weights, gradients, moments)
# would take 102 GB
PART_FAMILIES = (
    ("moonshot", "moonshot-v1-16b-a3b", 2, "float32", {}, "heads",
     (4, 2), 2, 2),
    ("mamba2", "mamba2-1.3b", 2, "float32", {}, "heads", (0, 0), 0, 0),
    ("recurrentgemma", "recurrentgemma-2b", 3, "float32", {}, "heads",
     (2, 1), 1, 1),
    ("seamless", "seamless-m4t-medium", 2, "float32", {}, "kv_seq",
     (12, 6), 6, 4),
    ("vlm", "llama-3.2-vision-90b", 5, "bfloat16", {}, "kv_seq",
     (10, 5), 5, 5),
    ("granite-int8", "granite-3-2b", 2, "float32",
     {"kv_cache_quant": True}, "kv_seq", (4, 2), 2, 0),
)
PART_FAMILY_TRAIN = (2, 64)            # B, S
PART_FAMILY_SERVE = (2, 64, 96, 2)     # prompts, length, cache slots, steps
# the bf16 cell's limit (phase 3's bf16 flash limit), relative: the loss,
# each updated parameter of its leaf's largest magnitude, each step's
# logits of their largest magnitude.  An int8 step whose written values
# differ from the plain LM's (a value rounded to the other side of a half)
# is held to the int8 cache's own bound, probabilities within 0.05
PART_BF16_TOL = 2e-2
# the two ranks take turns at the plain reference of a family whose plain
# train step (weights, gradients, two moments) takes more than this
PART_TURNS_BYTES = 24e9
# phase 16, the pod-parallel step partitioned inside each pod: granite-3-2b
# at full width on four gloo ranks on the one card, a (pod, data, model)
# mesh of POD_PART_MESH; (layers, B, S) in fp32, then POD_PART_STEPS timed
# steps
POD_PART_MESH = (2, 1, 2)
POD_PART_TRAIN = (2, 4, 256)
POD_PART_STEPS = 2
# phase 17, the dry run: (arch, shape, mesh kind) of the cells traced in a
# child process on a fake process group of 512 ranks with the card's
# device type (started before phase 2's build, read in phase 17), and the
# plan a cell the static lint must prune untraced
DRYRUN_CELLS = (("granite-3-2b", "train_4k", "single"),
                ("granite-3-2b", "decode_32k", "single"),
                ("granite-3-2b", "train_4k", "multi"))
DRYRUN_PRUNED = ("granite-3-2b", "train_4k", "single", {"microbatches": 3})
DRYRUN_TIMEOUT = 420
# logit soft caps and the query offset (phases 3, 4 and 18): a cap that
# bends unit-scale scores far past every limit (the kernel checks and their
# fault controls; 18 (a)), and Gemma 2's self-attention cap
# (arXiv:2408.00118) on the full-width path (18 (b)) and the timed rows;
# the offset case: a causal chunk of Sq queries after Skv - Sq earlier ones
SOFTCAP_CHECK = 2.0
SOFTCAP_PARITY = 1.0
SOFTCAP_GEMMA = 50.0
OFFSET_CASE = (1000, 2048)             # Sq, Skv
OFFSET = OFFSET_CASE[1] - OFFSET_CASE[0]
# the backward's capped and offset cases (phase 3), BWD_CASES' fields and
# the cap and the offset: granite's heads at its main shape, the offset
# case with and without the cap, and the general kernels' other tiles
# (D 80 on the D 128 tile under a window; D 256, whose warpgroups split
# the head dim, capped and at the offset under a window)
SOFTCAP_BWD_CASES = (
    ("granite capped", 32, 8, 2048, 2048, 64, True, 0, SOFTCAP_CHECK, 0),
    ("granite chunk", 32, 8, *OFFSET_CASE, 64, True, 0, 0.0, OFFSET),
    ("granite capped chunk", 32, 8, *OFFSET_CASE, 64, True, 0,
     SOFTCAP_CHECK, OFFSET),
    ("h2o-danube capped", 32, 8, 1000, 1000, 80, True, 300, SOFTCAP_CHECK,
     0),
    ("recurrentgemma capped", 10, 1, 1000, 1000, 256, True, 500,
     SOFTCAP_CHECK, 0),
    ("recurrentgemma chunk", 10, 1, *OFFSET_CASE, 256, True, 500, 0.0,
     OFFSET),
)
# phase 18 (a): granite-3-2b at full width, 2 layers in fp32, its cap at
# SOFTCAP_PARITY: 4 requests (prompt lengths in turn, max_gen each) through
# the captured batcher on the card and the batcher on the CPU, then one
# train step against the CPU's (13 (a')'s limits at B 1, S 256); (b) the
# whole model in bf16 under Gemma 2's cap: 4 requests of phase 6's prompts,
# SOFTCAP_SERVE_GEN tokens each, then SOFTCAP_TRAIN_STEPS timed steps at
# 13 (b)'s shape
SOFTCAP_PROMPTS = (300, 700)
SOFTCAP_GENS = (16, 24, 12, 20)
SOFTCAP_SERVE_GEN = 16
SOFTCAP_TRAIN_STEPS = 3
# phase 19, the examples: autoplan_model's GA (generations, population) in
# a child process started before phase 2 (beside the dry-run child) and
# run twice over one disk cache; train_lm's steps, and --wide's
EXAMPLE_AUTOPLAN = (2, 5)
EXAMPLE_TRAIN_STEPS = 20
EXAMPLE_WIDE_STEPS = 5
EXAMPLE_TIMEOUT = 420


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextmanager
def phase(name: str):
    print(f"\n--- phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"--- phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def idle_draw() -> str:
    """nvidia-smi's power.draw (the idle draw, read before any kernel runs:
    the H100 envelope's idle watts, ``repro_torch.power.H100_SXM``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.draw,pstate",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(
        "cuda", dtype)


def max_abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_close(what: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    print(f"  {what:48s} max_abs_err {err:.3e}  tol {tol:g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    require(ok, f"{what}: kernel disagrees with its plain version")
    return err


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls after a warm-up."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# A torch.profiler trace on the card can drop its first kernel records
# (seen on the H100 machine once a process had taken a few traces: the
# first 3 records of each, so 7 of 10 calls' kernels or 0 of 1; and, once
# phase 4 had taken about 60 traces, every record of a trace's first
# millisecond or so).  Each trace here opens with TRACE_PAD spin kernels,
# left out of every count, of PAD_CYCLES each (about 10 us, so the pad
# spans about 0.65 ms of device time); a trace that lost all of them is
# taken again with a pad ten times longer, at most TRACE_TRIES times.
TRACE_PAD = 64
PAD_CYCLES = 20_000
TRACE_TRIES = 4
PAD_KERNEL = "spin_kernel"


def pad_trace(attempt: int) -> None:
    """The pad that opens a trace: TRACE_PAD spins of PAD_CYCLES x
    10^attempt cycles, then a sync."""
    for _ in range(TRACE_PAD):
        torch.cuda._sleep(PAD_CYCLES * 10 ** attempt)
    torch.cuda.synchronize()


def traced_kernels(run, activities) -> list:
    """A torch.profiler trace of ``run()`` whose first records are the pad,
    and (name, ms) of each kernel in it but the pad."""
    from torch.profiler import profile
    for attempt in range(TRACE_TRIES):
        with profile(activities=activities) as prof:
            pad_trace(attempt)
            run()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        if any(PAD_KERNEL in name for name, _ in kernels):
            return prof, [(name, ms) for name, ms in kernels
                          if PAD_KERNEL not in name]
        print(f"  (a profiler trace lost its {TRACE_PAD} pad kernels; it "
              f"kept {len(kernels)} kernel records; taking it again with a "
              f"pad ten times longer)", flush=True)
    raise SmokeFailure(f"{TRACE_TRIES} profiler traces lost all {TRACE_PAD} "
                       f"pad kernels: their kernel counts would be short")


def device_profile(fn, iters: int = 10):
    """Device time per call of ``fn`` from a torch.profiler trace of
    ``iters`` calls after a warm-up: (ms, kernels as (name, ms) heaviest
    first, the 8 heaviest host ops by self CPU time as (name, ms)), all per
    call."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    prof, traced = traced_kernels(run, [ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
    kernels = {}
    for name, ms in traced:
        kernels[name] = kernels.get(name, 0.0) + ms / iters
    host = sorted(((a.key, a.self_cpu_time_total / 1e3 / iters)
                   for a in prof.key_averages()), key=lambda kv: -kv[1])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    return sum(kernels.values()), top, host[:8]


def time_row(kernel, plain, library, t_bound, by, iters=200,
             plain_iters=None):
    """CUDA-event ms per call of a kernel, its plain version and the
    library call beside the bound, and the device ms of each from a
    profiler trace (where a call is shorter than its host launch cost, the
    event time measures the host's launch rate).  A slow plain version
    (``plain_iters`` given) is traced over 3 calls, not 10: its hundreds of
    kernels a call would fill the trace."""
    row = {"ms": time_ms(kernel, iters),
           "plain_ms": time_ms(plain, plain_iters or iters),
           "library_ms": time_ms(library, iters),
           "bound_ms": t_bound, "bound_by": by}
    dev = {"kernel": device_profile(kernel)[0],
           "plain": device_profile(plain, 3 if plain_iters else 10)[0],
           "library": device_profile(library)[0]}
    return row, dev


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK_FLOPS):
    """Least time (ms) for the work, and which term sets it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(ops, ref):
    """Phase 3: returns the main-path max errors."""
    gen = torch.Generator().manual_seed(0)
    errs = {}
    print(" matmul (JAX test shapes: fp32 at 1e-5, bf16 at 2e-2)")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for m, k, n in ((32, 32, 32), (100, 70, 130), (128, 256, 64),
                        (17, 19, 23)):
            a, b = randn(gen, m, k, dtype=dtype), randn(gen, k, n, dtype=dtype)
            check_close(f"matmul {m}x{k}x{n} {dtype}", ops.matmul(a, b),
                        ref.matmul_ref(a, b), tol)
    # fp32 sums of 512-1000 products in another order than cuBLAS: 1e-4
    print(" matmul (main path 512^3; ragged K=1000 and N=130 vs 64x64x16 "
          "tiles; fp32 at 1e-4 for the longer sums, bf16 at 2e-2)")
    m, k, n = MATMUL_MAIN
    a, b = randn(gen, m, k), randn(gen, k, n)
    errs["matmul"] = check_close("matmul 512^3 float32 (main path)",
                                 ops.matmul(a, b), ref.matmul_ref(a, b), 1e-4)
    check_matmul_bf16(ops, ref, a.to(torch.bfloat16), b.to(torch.bfloat16))
    a, b = randn(gen, 192, 1000), randn(gen, 1000, 130)
    check_close("matmul 192x1000x130 float32 (ragged K, N)",
                ops.matmul(a, b), ref.matmul_ref(a, b), 1e-4)
    print(" matmul (ragged M, N and K, 4-byte copies where rows are not "
          "16-byte aligned, K below one 16-byte vector, warps with unequal "
          "K slabs; fp32 at 1e-4, bf16 at 2e-2)")
    for m, k, n in ((513, 1001, 511), (64, 4, 64), (64, 3, 64),
                    (64, 528, 64)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            a, b = randn(gen, m, k, dtype=dtype), randn(gen, k, n, dtype=dtype)
            check_close(f"matmul {m}x{k}x{n} {dtype}", ops.matmul(a, b),
                        ref.matmul_ref(a, b), tol)

    print(" tdfir (JAX test shapes at 3e-4)")
    for f, nn, kk, bn in ((2, 128, 8, 32), (4, 300, 16, 64),
                          (8, 256, 32, 128), (1, 512, 4, 256)):
        x, h = randn(gen, f, nn), randn(gen, f, kk)
        check_close(f"tdfir F={f} N={nn} K={kk} block_n={bn}",
                    ops.tdfir(x, h, block_n=bn), ref.tdfir_ref(x, h), 3e-4)
    xr, xi = randn(gen, 2, 128), randn(gen, 2, 128)
    hr, hi = randn(gen, 2, 8), randn(gen, 2, 8)
    for part, got, want in zip(
            ("re", "im"), ops.tdfir_complex(xr, xi, hr, hi, block_n=64),
            ref.tdfir_complex_ref(xr, xi, hr, hi)):
        check_close(f"tdfir_complex F=2 N=128 K=8 ({part})", got, want, 3e-4)
    print(" tdfir (main path: complex 64x4096x128, block_n=128; ragged "
          "N=1000 with K=200 > tile)")
    f, nn, kk = TDFIR_MAIN
    xr, xi = randn(gen, f, nn), randn(gen, f, nn)
    hr, hi = randn(gen, f, kk) * 0.1, randn(gen, f, kk) * 0.1
    errs["tdfir"] = max(
        check_close(f"tdfir_complex 64x4096x128 ({part}, main path)", got,
                    want, 3e-4)
        for part, got, want in zip(
            ("re", "im"),
            ops.tdfir_complex(xr, xi, hr, hi, block_n=TDFIR_MAIN_BLOCK_N),
            ref.tdfir_complex_ref(xr, xi, hr, hi)))
    x, h = randn(gen, 4, 1000), randn(gen, 4, 200)
    check_close("tdfir F=4 N=1000 K=200 block_n=128 (ragged N)",
                ops.tdfir(x, h, block_n=128), ref.tdfir_ref(x, h), 3e-4)
    rr, ii = ops.tdfir(xr, hr), ops.tdfir(xi, hi)
    ri, ir = ops.tdfir(xr, hi), ops.tdfir(xi, hr)
    for part, got, want in zip(
            ("re", "im"),
            ops.tdfir_complex(xr, xi, hr, hi, block_n=TDFIR_MAIN_BLOCK_N),
            (rr - ii, ri + ir)):
        require_same_bits(f"tdfir_complex 64x4096x128 ({part}) against four "
                          f"tdfir launches and the combine", got, want,
                          "the complex kernel's sums or combine are not "
                          "those of the real kernel")
    launched = device_kernels(lambda: ops.tdfir_complex(
        xr, xi, hr, hi, block_n=TDFIR_MAIN_BLOCK_N))
    print(f"  tdfir_complex: one call runs {len(launched)} device kernel(s): "
          f"{launched}")
    require(len(launched) == 1, "a tdfir_complex call is not one device "
            "kernel")
    check_tdfir_edges(ops, ref, gen)
    errs.update(check_attention(ops, ref, gen))
    errs["flash_attention_bwd"] = check_flash_backward(ops, ref, gen)
    check_softcap(ops, ref, gen)
    return errs


def check_matmul_bf16(ops, ref, a512, b512):
    """Phase 3: the bf16 matmul on each of its routes (``matmul.bf16_plan``)
    at 3mm's 512^3, granite-3-2b's MLP up-projection and the unaligned
    shape, within 2e-2 of the plain version, the same bits on a second
    call, the limit rejecting the simulated faults of
    ``parity.matmul_fault_controls`` (the last K tile dropped, B read
    K-major)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import parity
    print(" matmul bf16 on its routes (2e-2; repeated calls bitwise; the "
          "limit must reject the simulated faults)")
    gen = torch.Generator().manual_seed(30)   # phase 3's draws stay as
    cases = [("512^3", a512, b512)]          # they were before these
    for what, (m, k, n) in (("MLP up-projection", MATMUL_MLP),
                            ("unaligned", MATMUL_UNALIGNED)):
        cases.append((what, randn(gen, m, k, dtype=torch.bfloat16),
                      randn(gen, k, n, dtype=torch.bfloat16)))
    for what, a, b in cases:
        (m, k), n = a.shape, b.shape[1]
        route = mm.bf16_plan(m, n, k, mm.bf16_mappable(
            n, k, a.data_ptr(), b.data_ptr())).route
        want = ref.matmul_ref(a, b)
        got = ops.matmul(a, b)
        check_close(f"matmul {m}x{k}x{n} bfloat16 ({what}, {route})", got,
                    want, parity.MATMUL_BF16_TOL)
        require_same_bits(f"matmul {m}x{k}x{n} bfloat16 twice", got,
                          ops.matmul(a, b), "the bf16 matmul's bits vary "
                          "between calls")
        require((route == "unaligned") == ((m, k, n) == MATMUL_UNALIGNED),
                f"matmul {m}x{k}x{n} bfloat16 took the {route} route")
        for fault, bad in parity.matmul_fault_controls(a, b).items():
            rejected = not parity.matmul_within(bad, want)
            print(f"  fault control {fault:24s} max_abs_err "
                  f"{max_abs_err(bad, want):.3e}  "
                  f"{'rejected' if rejected else 'PASSES THE LIMIT'}")
            require(rejected, f"the bf16 matmul limit passes a simulated "
                    f"fault ({fault}) at {m}x{k}x{n}")


def check_flash_windows(ops, ref, gen):
    """Phase 3: flash attention under a sliding window and at D=80 (H=32
    over KV=8 as strided views, causal): h2o-danube's S=5000 under its
    4096 window and without it, then ragged windows (under one 128-key
    tile, past S, straddling tiles at an S off the tile grid); bf16 at both
    limits, fp32 at 2e-4; a window of S or more must give window 0's
    bits."""
    s_main, d = H2O_FLASH[3], H2O_FLASH[4]
    print(f" flash_attention (h2o-danube: D={d}, S={s_main} with window "
          f"{H2O_WINDOW} and without, S=1000 with it; windows 50, 1000 at "
          f"S=300 and 200 at S=777; bf16 at both limits, fp32 at 2e-4)")
    for dtype in (torch.bfloat16, torch.float32):
        for s, w in ((s_main, H2O_WINDOW), (s_main, 0), (1000, H2O_WINDOW),
                     (300, 50), (300, 1000), (777, 200)):
            q, k, v, rep = flash_inputs(gen, s, dtype, d=d)
            what = f"flash S={s} D={d} window {w} {dtype}"
            got = ops.flash_attention(q, k, v, kv_group=rep, window=w)
            want = ref.mha_ref(q, k, v, kv_group=rep, window=w)
            if dtype == torch.bfloat16:
                check_flash_bf16(what, got, want)
            else:
                check_close(what, got, want, 2e-4)
            del want
        q, k, v, rep = flash_inputs(gen, 777, dtype, d=d)
        none = ops.flash_attention(q, k, v, kv_group=rep)
        for w in (777, 7770):
            require_same_bits(
                f"flash S=777 D={d} {dtype}, window {w} against none",
                ops.flash_attention(q, k, v, kv_group=rep, window=w), none,
                "a window of S or more changed the result")


def check_tdfir_edges(ops, ref, gen):
    """Phase 3: tdfir and tdfir_complex at the edges of the kernel's blocked
    tap loop (``kernels/parity.py`` ``tdfir_edges``), at 3e-4, and a K
    past each form's limit, which must raise before any launch."""
    from repro_torch.kernels import parity
    from repro_torch.kernels import tdfir as fir
    print(" tdfir and tdfir_complex (blocked-loop edges at 3e-4: K not a "
          "multiple of 4, K' where the swizzle moves the window's last "
          "quad, N below 8 or not a multiple of 4, N < K, F = 1, the "
          "largest K each form accepts)")
    for f, nn, kk in parity.tdfir_edges():
        # taps scaled to unit gain: fp32 sums of thousands of unit-scale
        # products differ between two summation orders by more than 3e-4
        scale = kk ** -0.5 if kk > 256 else 1.0
        x, xi = randn(gen, f, nn), randn(gen, f, nn)
        h, hi = randn(gen, f, kk) * scale, randn(gen, f, kk) * scale
        check_close(f"tdfir F={f} N={nn} K={kk}", ops.tdfir(x, h),
                    ref.tdfir_ref(x, h), 3e-4)
        if kk > fir.max_taps(2):
            continue
        for part, got, want in zip(("re", "im"),
                                   ops.tdfir_complex(x, xi, h, hi),
                                   ref.tdfir_complex_ref(x, xi, h, hi)):
            check_close(f"tdfir_complex F={f} N={nn} K={kk} ({part})", got,
                        want, 3e-4)
    x, h = randn(gen, 2, 64), randn(gen, 2, fir.max_taps(1) + 4)
    hc = h[:, :fir.max_taps(2) + 4].contiguous()
    before = ops.launch_counts()["tdfir"]
    for what, call in (("tdfir", lambda: ops.tdfir(x, h)),
                       ("tdfir_complex",
                        lambda: ops.tdfir_complex(x, x, hc, hc))):
        try:
            call()
        except ValueError as e:
            print(f"  {what} past its tap limit raises: {e}")
        else:
            raise SmokeFailure(f"{what} took more taps than its limit")
    require(ops.launch_counts()["tdfir"] == before,
            "a tdfir call past the tap limit launched")


def flash_inputs(gen, s, dtype, b=1, h=32, kv=8, d=64, skv=None):
    """q/k/v as ``layers.attention`` hands them to the kernel: [B*H, S, D]
    views of the [B, S, H, D] projections (strided when B == 1); k/v of
    ``skv`` keys where given (a cross layer's context), else S."""
    def heads(n, length):
        return randn(gen, b, length, n, d, dtype=dtype).transpose(
            1, 2).reshape(b * n, length, d)
    return heads(h, s), heads(kv, skv or s), heads(kv, skv or s), h // kv


def decode_inputs(gen, dtype, b, h, kv, s, d, lens):
    """q [B, H, D], a [B, S, KV, D] cache pair, per-row lengths [B]."""
    return (randn(gen, b, h, d, dtype=dtype),
            randn(gen, b, s, kv, d, dtype=dtype),
            randn(gen, b, s, kv, d, dtype=dtype),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def check_flash_bf16(what: str, got, want) -> float:
    """The bf16 tensor-core kernel against its plain version: the absolute
    limit and the row-scaled one of ``kernels/parity.py``."""
    from repro_torch.kernels import parity
    torch.cuda.synchronize()
    ok, err, rerr = parity.within_limits(got, want)
    print(f"  {what:48s} max_abs_err {err:.3e}  row_err {rerr:.3e}  "
          f"{'ok' if ok else 'MISMATCH'}")
    require(ok, f"{what}: kernel disagrees with its plain version "
            f"(abs {err:.3e} > {parity.BF16_ABS_TOL} or row {rerr:.3e} > "
            f"{parity.BF16_ROW_TOL})")
    return err


def check_flash_faults(what: str, q, k, v, rep: int, want,
                       window: int = 0, causal: bool = True) -> None:
    """The bf16 flash limits must reject kernel faults that only late rows
    show (every row, in a non-causal walk), simulated on the plain version
    (``kernels/parity.py``)."""
    from repro_torch.kernels import parity
    for fault, bad in parity.fault_controls(q, k, v, rep, window,
                                            causal).items():
        ok, ferr, frerr = parity.within_limits(bad, want)
        print(f"    control, {fault:26s} max_abs_err {ferr:.3e}  "
              f"row_err {frerr:.3e}  {'PASSES' if ok else 'rejected'}")
        require(not ok, f"{what}: the bf16 limits pass a simulated fault "
                f"({fault})")


def require_same_bits(what: str, first, again,
                      why: str = "the split merge is not in a fixed order, "
                                 "or a counter was not reset") -> None:
    """``first`` and ``again`` must agree bit for bit: by default two
    identical decode calls (the splits merge in a fixed order and the kernel
    left its merge counters at zero); ``why`` names what a difference
    means."""
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    print(f"  {what}: {'bitwise identical' if same else 'DIFFERENT'}")
    require(same, f"{what}: not bitwise identical ({why})")


def check_decode_rows(what: str, got, q, kc, vc, lens, readings,
                      chunk=None):
    """bf16 decode attention's row-scaled limit (``kernels/parity.py``)
    against the plain version run in fp32; where ``chunk`` is given, also
    the simulated kernel faults that the limit must reject.  ``readings``
    keeps the largest sound and the smallest fault reading."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import parity
    torch.cuda.synchronize()
    want32 = parity.decode_want32(q, kc, vc, lens)
    rerr = parity.row_err(got, want32)
    print(f"    {'row_err':44s} {rerr:.3e}  limit {parity.DECODE_ROW_TOL}  "
          f"{'ok' if rerr <= parity.DECODE_ROW_TOL else 'MISMATCH'}")
    require(rerr <= parity.DECODE_ROW_TOL, f"{what}: row_err {rerr:.3e} > "
            f"{parity.DECODE_ROW_TOL}")
    readings["sound"] = max(readings["sound"], rerr)
    if chunk is None:
        return
    for fault, bad in parity.decode_fault_controls(
            q, kc, vc, lens, chunk,
            da.warp_tile(q.shape[-1], q.dtype)).items():
        frerr = parity.row_err(bad, want32)
        print(f"    control, {fault:34s} row_err {frerr:.3e}  "
              f"{'PASSES' if frerr <= parity.DECODE_ROW_TOL else 'rejected'}")
        require(frerr > parity.DECODE_ROW_TOL, f"{what}: the bf16 decode "
                f"limit passes a simulated fault ({fault})")
        readings["fault"] = min(readings["fault"], frerr)


def check_attention(ops, ref, gen):
    """Phase 3, attention kernels: returns the main-path max errors."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import parity
    errs = {}
    print(f" flash_attention (JAX test shapes: fp32 at 2e-4; bf16 at "
          f"{parity.BF16_ABS_TOL} and row_err {parity.BF16_ROW_TOL}: each "
          f"row's largest error over that row's rms)")
    for bh, s, d in ((2, 64, 16), (3, 128, 32), (1, 96, 64)):
        q, k, v = (randn(gen, bh, s, d) for _ in range(3))
        for causal in (True, False):
            check_close(f"flash {bh}x{s}x{d} causal={causal}",
                        ops.flash_attention(q, k, v, causal=causal),
                        ref.mha_ref(q, k, v, causal=causal), 2e-4)
    q, k, v = (randn(gen, 2, 64, 32, dtype=torch.bfloat16) for _ in range(3))
    check_flash_bf16("flash 2x64x32 bfloat16", ops.flash_attention(q, k, v),
                     ref.mha_ref(q, k, v))
    print(" flash_attention (main path: granite prefill B=1 H=32 KV=8 D=64 "
          "as strided views, S=2048 and ragged S=1000, fp32 at 2e-4, bf16 "
          "at both limits, also at D=128, each beside simulated faults "
          "that the limits must reject; fp32 D=128)")
    for s in (FLASH_MAIN[3], FLASH_RAGGED_S):
        for dtype, d in ((torch.bfloat16, FLASH_MAIN[4]),
                         (torch.float32, FLASH_MAIN[4]),
                         (torch.bfloat16, FLASH_WIDE_D)):
            q, k, v, rep = flash_inputs(gen, s, dtype, d=d)
            what = f"flash H=32 KV=8 S={s} D={d} {dtype} causal"
            got = ops.flash_attention(q, k, v, kv_group=rep)
            want = ref.mha_ref(q, k, v, kv_group=rep)
            if dtype == torch.float32:
                check_close(what, got, want, 2e-4)
                continue
            err = check_flash_bf16(what, got, want)
            if s == FLASH_MAIN[3] and d == FLASH_MAIN[4]:
                errs["flash_attention"] = err
            check_flash_faults(what, q, k, v, rep, want)
    q, k, v, rep = flash_inputs(gen, 300, torch.float32, b=2, h=8, kv=2,
                                d=128)
    check_close("flash B=2 H=8 KV=2 S=300 D=128 float32",
                ops.flash_attention(q, k, v, kv_group=rep),
                ref.mha_ref(q, k, v, kv_group=rep), 2e-4)
    print(f" flash_attention bf16 tensor-core kernel: S in {parity.SWEEP_S}"
          ", causal and not, kv_group 1 and 4 (H=8 over KV=8 or 2) as "
          "strided views; max over each head dim")
    for d in parity.SWEEP_D:
        worst, worst_row = 0.0, 0.0
        for s in parity.SWEEP_S:
            for rep, causal, q, k, v in parity.sweep_cases(gen, d, s):
                got = ops.flash_attention(q, k, v, causal=causal,
                                          kv_group=rep)
                want = ref.mha_ref(q, k, v, causal=causal, kv_group=rep)
                torch.cuda.synchronize()
                ok, err, rerr = parity.within_limits(got, want)
                require(ok, f"flash bf16 D={d} S={s} kv_group={rep} causal="
                        f"{causal}: kernel disagrees with its plain version "
                        f"(abs {err:.3e}, row {rerr:.3e})")
                worst, worst_row = max(worst, err), max(worst_row, rerr)
        print(f"  flash bf16 D={d:<3d} 24 shapes {'':23s} max_abs_err "
              f"{worst:.3e}  row_err {worst_row:.3e}  ok")
    check_flash_windows(ops, ref, gen)

    print(" decode_attention (JAX test shapes at 2e-4, one head per row)")
    for bh, s, d, clen in ((4, 256, 64, 256), (2, 512, 32, 300),
                           (1, 128, 128, 1)):
        q = randn(gen, bh, 1, d)
        kc, vc = randn(gen, bh, s, 1, d), randn(gen, bh, s, 1, d)
        check_close(f"decode BH={bh} S={s} D={d} len={clen}",
                    ops.decode_attention(q, kc, vc, clen),
                    ref.decode_attention_ref(q, kc, vc, clen), 2e-4)
    print(f" decode_attention (main path: 4 slots x 32 heads over a "
          f"[4,2112,8,64] cache, lens 1/300/1000/2112, random cache past "
          f"each length; bf16 at 5e-2 and row_err {parity.DECODE_ROW_TOL} "
          f"against the plain version in fp32, beside simulated faults "
          f"that the row limit must reject; fp32 at 2e-4; D=128)")
    readings = {"sound": 0.0, "fault": float("inf")}
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
        q, kc, vc, lens = decode_inputs(gen, dtype, *DECODE_MAIN,
                                        DECODE_MAIN_LENS)
        got = ops.decode_attention(q, kc, vc, lens)
        err = check_close(f"decode 4x32 over [4,2112,8,64] {dtype}", got,
                          ref.decode_attention_ref(q, kc, vc, lens), tol)
        if dtype == torch.bfloat16:
            errs["decode_attention"] = err
            check_decode_rows("decode main shape", got, q, kc, vc, lens,
                              readings, decode_plan(dtype).chunk)
    q, kc, vc, lens = decode_inputs(gen, torch.float32, 2, 16, 4, 700, 128,
                                    (1, 699))
    check_close("decode 2x16 over [2,700,4,128] float32",
                ops.decode_attention(q, kc, vc, lens),
                ref.decode_attention_ref(q, kc, vc, lens), 2e-4)
    b, h, kv, s, d = DECODE_MAIN
    chunk = decode_plan(torch.bfloat16).chunk
    print(f" decode_attention (main shape, split size {chunk}: lengths "
          f"around it, all at 1, at and above S; D=128 with 8 query heads a "
          f"KV head; a 64-slot pool whose one split a row wraps each warp's "
          f"ring; bf16 at 5e-2 and the row limit, fp32 at 2e-4)")
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
        c = decode_plan(dtype).chunk
        for lens in ((c - 1, c, c + 1, s), (1, 1, 1, 1),
                     (s + 100, 1, 2 * c, 2 * c + 1)):
            q, kc, vc, ln = decode_inputs(gen, dtype, *DECODE_MAIN, lens)
            what = f"decode [4,2112,8,64] lens {lens} {dtype}"
            got = ops.decode_attention(q, kc, vc, ln)
            check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln),
                        tol)
            if dtype == torch.bfloat16:
                check_decode_rows(what, got, q, kc, vc, ln, readings)
        q, kc, vc, ln = decode_inputs(gen, dtype, 2, 64, 8, 700, 128,
                                      (1, 699))
        what = f"decode 2x64 over [2,700,8,128] {dtype}"
        got = ops.decode_attention(q, kc, vc, ln)
        check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln), tol)
        if dtype == torch.bfloat16:
            check_decode_rows(what, got, q, kc, vc, ln, readings)
        b, h, kv, s, d = DECODE_WRAP
        wrap = decode_plan(dtype, DECODE_WRAP)
        q, kc, vc, ln = decode_inputs(gen, dtype, *DECODE_WRAP,
                                      DECODE_WRAP_LENS)
        tiles = wrap.chunk // da.KEY_TILE[dtype]
        what = f"decode [{b},{s},{kv},{d}] {dtype}, {tiles} tiles a split"
        first = ops.decode_attention(q, kc, vc, ln)
        check_close(what, first, ref.decode_attention_ref(q, kc, vc, ln),
                    tol)
        if dtype == torch.bfloat16:
            check_decode_rows(what, first, q, kc, vc, ln, readings,
                              wrap.chunk)
        require_same_bits(f"decode 64-slot pool {dtype}, called twice",
                          first, ops.decode_attention(q, kc, vc, ln))
        q, kc, vc, ln = decode_inputs(gen, dtype, *DECODE_MAIN,
                                      DECODE_MAIN_LENS)
        require_same_bits(f"decode main shape {dtype}, called twice",
                          ops.decode_attention(q, kc, vc, ln),
                          ops.decode_attention(q, kc, vc, ln))
    b, h, kv, s, d = H2O_DECODE
    print(f" decode_attention (h2o-danube's [{b},{s},{kv},{d}] pool, lens "
          f"{H2O_DECODE_LENS}: D=80 on padded lanes; bf16 at 5e-2 and the "
          f"row limit beside simulated faults, fp32 at 2e-4; called twice)")
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
        q, kc, vc, ln = decode_inputs(gen, dtype, *H2O_DECODE,
                                      H2O_DECODE_LENS)
        what = f"decode [{b},{s},{kv},{d}] {dtype}"
        got = ops.decode_attention(q, kc, vc, ln)
        check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln), tol)
        if dtype == torch.bfloat16:
            check_decode_rows(what, got, q, kc, vc, ln, readings,
                              decode_plan(dtype, H2O_DECODE).chunk)
        require_same_bits(f"{what}, called twice", got,
                          ops.decode_attention(q, kc, vc, ln))
    check_wide_groups(ops, ref, gen, readings)
    check_head_dim_256(ops, ref, gen, readings)
    check_cross_attention(ops, ref, gen, readings)
    check_decode_routes(ops, ref, gen, readings)
    print(f"  decode bf16 row_err: largest sound reading "
          f"{readings['sound']:.3e}, limit {parity.DECODE_ROW_TOL}, smallest "
          f"fault reading {readings['fault']:.3e}")
    return errs


def check_wide_groups(ops, ref, gen, readings):
    """Phase 3: flash and decode at the head layouts of phases 7 and 8, D=128
    with 6 and 12 query heads over 8 KV heads (nemotron-4-15b,
    command-r-plus-104b: a decode row pass that stops partway, and 6 or 12
    passes), 7 over 8 (arctic-480b: 4 passes of 2 rows in bf16, the last
    half empty, and the 8-pass instantiation in fp32) and 16 over 16
    (moonshot-v1-16b-a3b: one row a KV head, 16 KV rows a slot).  Flash at
    B=1 at the trace's prompt lengths, bf16 at both limits beside the
    simulated faults at S=2048, and fp32 at 2e-4 for the MoE layouts;
    decode over the [4,2112,KV,128] pool at the serving lengths, bf16 at
    5e-2 and the row limit beside simulated faults, fp32 at 2e-4, each call
    made twice for the same bits."""
    from repro_torch.kernels import decode_attention as da
    b, _, _, s_pool, _ = DECODE_MAIN
    d = FLASH_WIDE_D
    print(f" flash and decode attention at D={d}, (H, KV) in {WIDE_LAYOUTS} "
          f"(nemotron-4-15b, command-r-plus-104b, arctic-480b, "
          f"moonshot-v1-16b-a3b): flash at S={FLASH_MAIN[3]} and "
          f"{FLASH_RAGGED_S}, bf16 at both limits, fp32 at 2e-4 for "
          f"{MOE_LAYOUTS}; decode over [{b},{s_pool},KV,{d}] at lens "
          f"{DECODE_MAIN_LENS}, bf16 at 5e-2 and the row limit, fp32 at "
          f"2e-4, called twice")
    for h, kv in WIDE_LAYOUTS:
        dtypes = ((torch.bfloat16, torch.float32) if (h, kv) in MOE_LAYOUTS
                  else (torch.bfloat16,))
        for dtype in dtypes:
            for s in (FLASH_MAIN[3], FLASH_RAGGED_S):
                q, k, v, rep = flash_inputs(gen, s, dtype, h=h, kv=kv, d=d)
                what = f"flash H={h} KV={kv} S={s} D={d} {dtype} causal"
                want = ref.mha_ref(q, k, v, kv_group=rep)
                got = ops.flash_attention(q, k, v, kv_group=rep)
                if dtype == torch.float32:
                    check_close(what, got, want, 2e-4)
                else:
                    check_flash_bf16(what, got, want)
                    if s == FLASH_MAIN[3]:
                        check_flash_faults(what, q, k, v, rep, want)
                del want, got
        shape = (b, h, kv, s_pool, d)
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
            rows = 32 // da.lanes_per_row(d, dtype)
            q, kc, vc, ln = decode_inputs(gen, dtype, *shape,
                                          DECODE_MAIN_LENS)
            what = f"decode {b}x{h} over [{b},{s_pool},{kv},{d}] {dtype}"
            route = decode_plan(dtype, shape).route
            print(f"    {what}: {h // kv} query rows a KV head, route "
                  f"{route}: " + ("one 16-row tile" if route == "hmma" else
                                  f"{rows} a pass, "
                                  f"{-(-(h // kv) // rows)} passes"))
            got = ops.decode_attention(q, kc, vc, ln)
            check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln),
                        tol)
            if dtype == torch.bfloat16:
                check_decode_rows(what, got, q, kc, vc, ln, readings,
                                  decode_plan(dtype, shape).chunk)
            require_same_bits(f"{what}, called twice", got,
                              ops.decode_attention(q, kc, vc, ln))


def check_head_dim_256(ops, ref, gen, readings):
    """Phase 3: recurrentgemma-2b's local attention, D=256 with 10 query
    heads over one KV head (the bf16 flash kernel's own 64-key tile; the
    decode kernel's 10 row passes, fp32 two chunks a lane).  Flash at B=1
    under the 2048 window at S=4096 (past it) and S=1000 (within it), bf16
    at both limits beside the simulated faults (with the window), fp32 at
    2e-4, and at windows that straddle the 64-key tiles (the sweep above
    covers S around them without one); decode over the [4,2048,1,256] ring
    at lens 1/1000/2048/2048, bf16 at 5e-2 and the row limit beside
    simulated faults, fp32 at 2e-4, each call made twice for the same
    bits."""
    _, h, kv, s_main, d = GRIFFIN_FLASH
    w_main = GRIFFIN_WINDOW
    print(f" flash and decode attention at D={d}, H={h} over KV={kv} "
          f"(recurrentgemma-2b): flash at S={s_main} and {FLASH_RAGGED_S} "
          f"under window {w_main}, and S=300 under windows 63 and 129, "
          f"bf16 at both limits beside simulated faults, fp32 at 2e-4; "
          f"decode over {list(GRIFFIN_DECODE)} at lens "
          f"{GRIFFIN_DECODE_LENS}, bf16 at 5e-2 and the row limit, fp32 at "
          f"2e-4, called twice")
    for dtype in (torch.bfloat16, torch.float32):
        for s, w in ((s_main, w_main), (FLASH_RAGGED_S, w_main), (300, 63),
                     (300, 129)):
            q, k, v, rep = flash_inputs(gen, s, dtype, h=h, kv=kv, d=d)
            what = f"flash H={h} KV={kv} S={s} D={d} window {w} {dtype}"
            want = ref.mha_ref(q, k, v, kv_group=rep, window=w)
            got = ops.flash_attention(q, k, v, kv_group=rep, window=w)
            if dtype == torch.float32:
                check_close(what, got, want, 2e-4)
            else:
                check_flash_bf16(what, got, want)
                if s >= FLASH_RAGGED_S:
                    check_flash_faults(what, q, k, v, rep, want, w)
            del want, got
    from repro_torch.kernels import decode_attention as da
    b, _, _, s_pool, _ = GRIFFIN_DECODE
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
        q, kc, vc, ln = decode_inputs(gen, dtype, *GRIFFIN_DECODE,
                                      GRIFFIN_DECODE_LENS)
        what = f"decode {b}x{h} over [{b},{s_pool},{kv},{d}] {dtype}"
        p = decode_plan(dtype, GRIFFIN_DECODE)
        print(f"    {what}: route {p.route} ("
              + ("one 16-row tile, m16n8k8 P V" if p.route == "hmma" else
                 f"{da.lanes_per_row(d, dtype)} lanes a row, "
                 f"{da.chunks_per_lane(d, dtype)} chunk(s) a lane, "
                 f"{h // kv} passes")
              + f"), warp tiles of {da.warp_tile(d, dtype)} keys, "
              f"{p.n_splits} splits of {p.chunk}, "
              f"{da.live_blocks(p, GRIFFIN_DECODE_LENS, kv)} live")
        got = ops.decode_attention(q, kc, vc, ln)
        check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln), tol)
        if dtype == torch.bfloat16:
            check_decode_rows(what, got, q, kc, vc, ln, readings,
                              decode_plan(dtype, GRIFFIN_DECODE).chunk)
        require_same_bits(f"{what}, called twice", got,
                          ops.decode_attention(q, kc, vc, ln))


def check_decode_routes(ops, ref, gen, readings) -> None:
    """Phase 3: the bf16 decode kernel's tensor-core route at every group
    it takes (``DECODE_MMA_GROUPS``, up to 10 at D=256) and every head
    dim, on a [3, 700, 2, D] pool at lengths 0, 333 and 700: one launch a
    call through that route, within 5e-2 of the plain version and the row
    limit beside the simulated faults, its lse within 1e-3 of the plain
    version's in fp32, zeros and -1e30 at length 0, and the same bits on
    a second call; then ``DECODE_MMA_TREE``, long caches whose live splits
    merge in the route's two-level tree, held the same way."""
    from repro_torch.kernels import decode_attention as da
    b, kv, s, lens = DECODE_MMA_SWEEP
    print(f" decode_attention tensor-core route: groups {DECODE_MMA_GROUPS} "
          f"(up to {da.hmma_group(256)} at D=256) x D in {da.HEAD_DIMS} over "
          f"[{b},{s},{kv},D] at lens {lens}: 5e-2 and the row limit beside "
          f"simulated faults, the lse at 1e-3, called twice")
    empty = torch.tensor([n == 0 for n in lens], device="cuda")
    neg = float(np.float32(ref.NEG_INF))
    for d in da.HEAD_DIMS:
        worst, worst_lse = 0.0, 0.0
        for rep in DECODE_MMA_GROUPS:
            if rep > da.hmma_group(d):
                continue
            shape = (b, rep * kv, kv, s, d)
            p = decode_plan(torch.bfloat16, shape)
            what = f"decode group {rep} D={d} bf16"
            require(p.route == "hmma", f"{what}: plan takes route {p.route}")
            q, kc, vc, ln = decode_inputs(gen, torch.bfloat16, *shape, lens)
            lse = torch.empty((b, rep * kv), dtype=torch.float32,
                              device="cuda")
            before = ops.launch_counts()["decode_attention"]
            got = ops.decode_attention(q, kc, vc, ln, lse=lse)
            torch.cuda.synchronize()
            require(ops.launch_counts()["decode_attention"] == before + 1,
                    f"{what}: not one launch")
            want = ref.decode_attention_ref(q, kc, vc, ln)
            err = max_abs_err(got, want)
            require(err <= 5e-2, f"{what}: max_abs_err {err:.3e} > 5e-2")
            _, want_lse = ref.decode_attention_ref(
                q.float(), kc.float(), vc.float(), ln, return_lse=True)
            lse_err = max_abs_err(lse, want_lse)
            require(lse_err <= 1e-3, f"{what}: the lse is {lse_err:.2e} "
                    f"from the plain version's")
            require(bool((lse[empty] == neg).all()) and not got[empty].any(),
                    f"{what}: a row with no valid key is not zeros and "
                    f"-1e30")
            print(f"  {what:28s} chunk {p.chunk} x {p.n_splits}: "
                  f"max_abs_err {err:.3e}, lse {lse_err:.1e}")
            check_decode_rows(what, got, q, kc, vc, ln, readings, p.chunk)
            require_same_bits(f"{what}, called twice", got,
                              ops.decode_attention(q, kc, vc, ln))
            worst, worst_lse = max(worst, err), max(worst_lse, lse_err)
        print(f"  decode tensor-core route D={d:<3d} max_abs_err "
              f"{worst:.3e}  lse {worst_lse:.1e}  ok")
    for shape, lens in DECODE_MMA_TREE:
        p = decode_plan(torch.bfloat16, shape)
        live = [-(-n // p.chunk) for n in lens]
        what = f"decode {list(shape)} lens {lens} bf16"
        require(p.route == "hmma" and max(live) > da.MERGE_FAN,
                f"{what}: not the tensor-core route's merge tree ({p})")
        q, kc, vc, ln = decode_inputs(gen, torch.bfloat16, *shape, lens)
        got = ops.decode_attention(q, kc, vc, ln)
        print(f"  {what}: {p.n_splits} splits of {p.chunk}, {live} live, "
              f"merged in groups of {da.MERGE_FAN}")
        check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln), 5e-2)
        check_decode_rows(what, got, q, kc, vc, ln, readings, p.chunk)
        require_same_bits(f"{what}, called twice", got,
                          ops.decode_attention(q, kc, vc, ln))


def check_cross_attention(ops, ref, gen, readings):
    """Phase 3: the cross-attention families' kernel shapes.  Non-causal
    flash over a context of another length (``parity.CROSS_LENGTHS``: Sq
    below and above Skv, both ragged against the 128-row and 128- or
    64-key tiles; kv_group 1 and 8; D 64, 128 and 256; bf16 at both limits,
    fp32 at 2e-4); then the serving shapes: llama-3.2-vision-90b's causal
    self-attention (H=64 over KV=8, D=128, S 2048 and 1000) and its cross
    attention (Sq 2048 and 1000 over its 1024 image tokens),
    seamless-m4t-medium's causal self-attention (H=KV=16, D=64), its cross
    attention (over 3072 frames) and its non-causal encoder (S=3072): bf16
    at both limits beside the simulated faults (non-causal ones where the
    walk is), fp32 at 2e-4.  Decode at 8 query heads a KV head, D=128,
    over the VLM's [4,2112,8,128] pool at the serving lengths and over its
    full [4,1024,8,128] image context, and at one a KV head, D=64, over the
    audio [4,2112,16,64] pool and its full [4,3072,16,64] frames: bf16 at
    5e-2 and the row limit beside simulated faults, fp32 at 2e-4, each
    call made twice for the same bits."""
    from repro_torch.kernels import parity
    print(f" flash_attention non-causal over a context of another length: "
          f"(Sq, Skv) in {parity.CROSS_LENGTHS}, kv_group 1 and 8 (H=8 over "
          f"KV=8 or 1), bf16 at both limits, fp32 at 2e-4; max over each "
          f"head dim and dtype")
    for d in (64, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            worst, worst_row = 0.0, 0.0
            for sq, skv in parity.CROSS_LENGTHS:
                for rep, q, k, v in parity.cross_cases(gen, d, sq, skv,
                                                       dtype):
                    got = ops.flash_attention(q, k, v, causal=False,
                                              kv_group=rep)
                    want = ref.mha_ref(q, k, v, causal=False, kv_group=rep)
                    torch.cuda.synchronize()
                    what = (f"flash non-causal D={d} Sq={sq} Skv={skv} "
                            f"kv_group={rep} {dtype}")
                    if dtype == torch.float32:
                        err = max_abs_err(got, want)
                        require(torch.allclose(got, want, rtol=2e-4,
                                               atol=2e-4),
                                f"{what}: kernel disagrees with its plain "
                                f"version ({err:.3e} > 2e-4)")
                        worst = max(worst, err)
                        continue
                    ok, err, rerr = parity.within_limits(got, want)
                    require(ok, f"{what}: kernel disagrees with its plain "
                            f"version (abs {err:.3e}, row {rerr:.3e})")
                    worst, worst_row = max(worst, err), max(worst_row, rerr)
            print(f"  flash non-causal D={d:<3d} {str(dtype):14s} "
                  f"{2 * len(parity.CROSS_LENGTHS)} shapes  max_abs_err "
                  f"{worst:.3e}  row_err {worst_row:.3e}  ok")
    h, kv, d = VLM_HEADS
    ah, akv, ad = AUDIO_HEADS
    # (what, Sq, Skv, causal, H, KV, D, faults checked)
    cases = [("VLM self", s, s, True, h, kv, d, s == FLASH_MAIN[3])
             for s in SERVE_PROMPTS]
    cases += [("VLM cross", s, VLM_CTX, False, h, kv, d, s == FLASH_MAIN[3])
              for s in SERVE_PROMPTS]
    cases += [("audio self", s, s, True, ah, akv, ad, s == FLASH_MAIN[3])
              for s in SERVE_PROMPTS]
    cases += [("audio cross", s, AUDIO_CTX, False, ah, akv, ad,
               s == FLASH_MAIN[3]) for s in SERVE_PROMPTS]
    cases.append(("audio encoder", AUDIO_CTX, AUDIO_CTX, False, ah, akv, ad,
                  True))
    print(f" flash_attention at the serving shapes of phase 10 "
          f"(llama-3.2-vision-90b H={h} KV={kv} D={d}, context {VLM_CTX}; "
          f"seamless-m4t-medium H={ah} KV={akv} D={ad}, {AUDIO_CTX} frames): "
          f"bf16 at both limits beside simulated faults at Sq=2048 and the "
          f"encoder, fp32 at 2e-4")
    for what, sq, skv, causal, hh, kk, dd, faults in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, rep = flash_inputs(gen, sq, dtype, h=hh, kv=kk, d=dd,
                                        skv=skv)
            name = (f"flash {what} H={hh} KV={kk} Sq={sq} Skv={skv} D={dd} "
                    f"{'causal' if causal else 'non-causal'} {dtype}")
            want = ref.mha_ref(q, k, v, causal=causal, kv_group=rep)
            got = ops.flash_attention(q, k, v, causal=causal, kv_group=rep)
            if dtype == torch.float32:
                check_close(name, got, want, 2e-4)
            else:
                check_flash_bf16(name, got, want)
                if faults:
                    check_flash_faults(name, q, k, v, rep, want,
                                       causal=causal)
            del want, got
    b, _, _, s_pool, _ = DECODE_MAIN
    shapes = ((b, h, kv, s_pool, d, DECODE_MAIN_LENS),
              (b, h, kv, VLM_CTX, d, (VLM_CTX,) * b),
              (b, ah, akv, s_pool, ad, DECODE_MAIN_LENS),
              (b, ah, akv, AUDIO_CTX, ad, (AUDIO_CTX,) * b))
    print(f" decode_attention at the pools and contexts of phase 10: "
          f"{[list(sh[:5]) for sh in shapes]}, the contexts read whole; bf16 "
          f"at 5e-2 and the row limit beside simulated faults, fp32 at 2e-4, "
          f"called twice")
    for *shape, lens in shapes:
        shape = tuple(shape)
        bb, hh, kk, ss, dd = shape
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
            q, kc, vc, ln = decode_inputs(gen, dtype, *shape, lens)
            what = f"decode {bb}x{hh} over [{bb},{ss},{kk},{dd}] {dtype}"
            got = ops.decode_attention(q, kc, vc, ln)
            check_close(what, got, ref.decode_attention_ref(q, kc, vc, ln),
                        tol)
            if dtype == torch.bfloat16:
                check_decode_rows(what, got, q, kc, vc, ln, readings,
                                  decode_plan(dtype, shape).chunk)
            require_same_bits(f"{what}, called twice", got,
                              ops.decode_attention(q, kc, vc, ln))


def check_decode_lse(ops, ref, gen) -> None:
    """Phase 4: the decode kernel with its ``lse`` output (each row's
    base-2 log-sum-exp, what phase 15 (c)'s kv_seq-sharded decode merges
    by) against the plain version's, output and lse: fp32 at phase 15
    (c)'s slice of the cache (32 heads over [4,1056,8,64], one rank's
    lengths) and at the second half of the main pool (lengths past 1056
    clamped into it: three rows hold no valid key, which must give zeros
    and -1e30), then bf16 at the main shape, timed against the same call
    without ``lse``."""
    b, h, kv, s, d = DECODE_MAIN
    half = s // 2
    rank_lens = tuple(PART_SERVE[2] + i for i in range(b))
    tail_lens = tuple(min(max(n - half, 0), half) for n in DECODE_MAIN_LENS)
    neg = float(np.float32(ref.NEG_INF))
    for what, dtype, shape, lens, tol, lse_tol in (
            ("15 (c) slice", torch.float32, (b, h, kv, half, d), rank_lens,
             2e-4, 1e-4),
            ("second half", torch.float32, (b, h, kv, half, d), tail_lens,
             2e-4, 1e-4),
            ("main shape", torch.bfloat16, DECODE_MAIN, DECODE_MAIN_LENS,
             5e-2, 1e-3)):
        q, kc, vc, ln = decode_inputs(gen, dtype, *shape, lens)
        lse = torch.empty((b, h), dtype=torch.float32, device="cuda")
        got = ops.decode_attention(q, kc, vc, ln, lse=lse)
        want, want_lse = ref.decode_attention_ref(
            q.float(), kc.float(), vc.float(), ln, return_lse=True)
        err = check_close(f"decode lse {what} {dtype} lens {lens} out", got,
                          want.to(dtype), tol)
        lse_err = max_abs_err(lse, want_lse)
        empty = torch.tensor(lens, device="cuda") == 0
        print(f"  decode lse {what}: lse max_abs_err {lse_err:.2e} (limit "
              f"{lse_tol:.0e}); rows with no valid key {int(empty.sum())}")
        require(lse_err <= lse_tol, f"decode lse {what}: the lse is "
                f"{lse_err:.2e} from the plain version's")
        require(bool((lse[empty] == neg).all()) and not got[empty].any(),
                f"decode lse {what}: a row with no valid key is not zeros "
                f"and -1e30")
        require_same_bits(f"decode {what} with and without lse", got,
                          ops.decode_attention(q, kc, vc, ln))
    caches = itertools.cycle([decode_inputs(gen, torch.bfloat16,
                                            *DECODE_MAIN, DECODE_MAIN_LENS)
                              for _ in range(4)])

    def with_lse():
        q, kc, vc, ln = next(caches)
        return ops.decode_attention(q, kc, vc, ln, lse=lse)

    def without():
        q, kc, vc, ln = next(caches)
        return ops.decode_attention(q, kc, vc, ln)

    def plain():
        q, kc, vc, ln = next(caches)
        return ref.decode_attention_ref(q, kc, vc, ln, return_lse=True)

    # the library call that returns a log-sum-exp (natural, a yardstick no
    # path calls): memory-efficient SDPA with compute_log_sumexp over each
    # cache, its KV heads repeated to the query heads and the slots'
    # lengths as a -inf bias, both made before the timing
    pos = torch.arange(s, device="cuda")[None, None, None, :]
    lib_in = itertools.cycle([
        (q[:, :, None, :],
         *(x.transpose(1, 2).repeat_interleave(h // kv, 1) for x in (kc, vc)),
         torch.zeros(b, h, 1, s, dtype=q.dtype, device="cuda").masked_fill(
             pos >= ln[:, None, None, None], float("-inf")))
        for q, kc, vc, ln in (next(caches) for _ in range(4))])

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            *next(lib_in), True)

    print(f"  decode 4x32 over [4,2112,8,64] bf16 at lens "
          f"{'/'.join(map(str, DECODE_MAIN_LENS))}: with lse "
          f"{time_ms(with_lse, 200):.4f} ms (device "
          f"{device_profile(with_lse)[0]:.4f}), without "
          f"{time_ms(without, 200):.4f} ms (device "
          f"{device_profile(without)[0]:.4f}); the plain version with its "
          f"lse {time_ms(plain, 50):.4f} ms (device "
          f"{device_profile(plain)[0]:.4f}); the library call with its lse "
          f"(memory-efficient SDPA, compute_log_sumexp, KV repeated to "
          f"{h} heads) {time_ms(library, 200):.4f} ms (device "
          f"{device_profile(library)[0]:.4f})")


def time_kernels(ops, ref):
    """Phase 4: per-kernel times at the main-path shapes."""
    gen = torch.Generator().manual_seed(1)
    rows, dev = {}, {}
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import tdfir as fir
    m, k, n = MATMUL_MAIN
    a, b = randn(gen, m, k), randn(gen, k, n)
    t_bound, by = bound(*mm.work(m, n, k))
    rows["matmul"], dev["matmul"] = time_row(
        lambda: ops.matmul(a, b), lambda: ref.matmul_ref(a, b),
        lambda: torch.matmul(a, b), t_bound, by)
    p = mm.plan(m, n, k)
    print(f"  matmul 512^3 float32 plan: grid {p.grid_m} x {p.grid_n} = "
          f"{p.blocks} blocks of {mm.BLOCK_M}x{mm.BLOCK_N} tiles, K split "
          f"over {p.warps} warps of each block (no split across blocks)")
    require(p.blocks >= 128, "the matmul grid at 512^3 is under 128 blocks")
    time_matmul_bf16(ops, ref, a, b, rows, dev)

    f, nn, kk = TDFIR_MAIN
    x, h = randn(gen, f, nn), randn(gen, f, kk) * 0.1
    w = h.flip(-1)[:, None, :]
    t_bound, by = bound(*fir.work(f, nn, kk))
    rows["tdfir"], dev["tdfir"] = time_row(
        lambda: ops.tdfir(x, h, block_n=TDFIR_MAIN_BLOCK_N),
        lambda: ref.tdfir_ref(x, h),
        lambda: F.conv1d(x[None], w, padding=kk - 1, groups=f), t_bound, by,
        plain_iters=20)
    p = fir.plan(f, nn, kk)
    print(f"  tdfir plan at {f}x{nn}x{kk}: {fir.OUTPUTS_PER_THREAD} outputs "
          f"a thread, {p.threads} threads a block ({p.tile}-output tiles, "
          f"{p.window}-sample windows), grid {p.grid_n} x {p.grid_f} = "
          f"{p.blocks} blocks, {p.blocks * p.threads / 32 / 132:.2f} warps "
          f"a SM")
    require(p.blocks >= 132, "the tdfir grid leaves SMs without a block")
    xi, hi = randn(gen, f, nn), randn(gen, f, kk) * 0.1
    # one grouped convolution over the stacked (re, im) channels of each
    # filter, weights [[h_re, -h_im], [h_im, h_re]] flipped
    xs = F.pad(torch.stack([x, xi], 1).reshape(1, 2 * f, nn), (kk - 1, 0))
    w2 = torch.stack([torch.stack([h, -hi], 1), torch.stack([hi, h], 1)],
                     1).reshape(2 * f, 2, kk).flip(-1).contiguous()

    def complex_kernel():
        return ops.tdfir_complex(x, xi, h, hi, block_n=TDFIR_MAIN_BLOCK_N)

    def complex_library():
        return F.conv1d(xs, w2, groups=f)

    def four_real():
        return (ops.tdfir(x, h, block_n=TDFIR_MAIN_BLOCK_N)
                - ops.tdfir(xi, hi, block_n=TDFIR_MAIN_BLOCK_N),
                ops.tdfir(x, hi, block_n=TDFIR_MAIN_BLOCK_N)
                + ops.tdfir(xi, h, block_n=TDFIR_MAIN_BLOCK_N))

    want = torch.stack(ref.tdfir_complex_ref(x, xi, h, hi), 1)
    lib_err = max_abs_err(complex_library()[0].reshape(f, 2, nn), want)
    # the function's least work: 8 F N K (an output's combine can fold
    # into its sums); the modeled cost, fir.complex_work, also charges
    # the kernel's own 2 F N combine
    t_bound, by = bound(8.0 * f * nn * kk, 4.0 * (4 * f * nn + 2 * f * kk))
    row, cdev = time_row(complex_kernel,
                         lambda: ref.tdfir_complex_ref(x, xi, h, hi),
                         complex_library, t_bound, by, plain_iters=10)
    rows["tdfir"]["complex"] = row
    dev["tdfir_complex"] = cdev
    print(f"  tdfir_complex 64x4096x128: one launch {row['ms']:.4f} ms "
          f"(device {cdev['kernel']:.4f})  bound {t_bound:.4f} ms ({by})  "
          f"plain {row['plain_ms']:.4f} ms  grouped F.conv1d "
          f"{row['library_ms']:.4f} ms (device {cdev['library']:.4f}, "
          f"max_abs_err {lib_err:.1e} against the plain version)")
    print(f"  tdfir_complex as four real launches and the combine: "
          f"{time_ms(four_real, 100):.4f} ms (device "
          f"{device_profile(four_real)[0]:.4f})")
    time_attention(ops, ref, gen, rows, dev)
    time_backward(ops, ref, gen, rows, dev)
    check_decode_lse(ops, ref, gen)
    time_softcap(ops, ref, gen, rows, dev)
    listed = dict(rows, tdfir_complex=rows["tdfir"]["complex"],
                  **{f"matmul_{k}": rows["matmul"][k]
                     for k in ("bf16", "bf16_mlp", "bf16_unaligned")})
    for name, r in listed.items():
        print(f"  {name:16s} kernel {r['ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms")
    print("  device time per call (torch.profiler):")
    for name, d in dev.items():
        print(f"  {name:16s} kernel {d['kernel']:.4f} ms  plain "
              f"{d['plain']:.4f} ms  library {d['library']:.4f} ms")
    return rows


def time_matmul_bf16(ops, ref, a, b, rows, dev) -> None:
    """Phase 4, PERF.md rows 1', 1'' and the unaligned route: the bf16
    matmul at 3mm's 512^3 (``a``, ``b`` rounded to bf16), at granite-3-2b's
    MLP up-projection and at the unaligned shape, each beside its plain
    version, ``torch.matmul`` and the bound (bf16 operations at the tensor
    cores' peak, or the bytes); the rows join the ``matmul`` entry of the
    JSON line under ``bf16``, ``bf16_mlp`` and ``bf16_unaligned``."""
    from repro_torch.kernels import matmul as mm
    gen = torch.Generator().manual_seed(31)   # phase 4's draws stay
    cases = (("bf16", a.to(torch.bfloat16), b.to(torch.bfloat16)),)
    for key, (m, k, n) in (("bf16_mlp", MATMUL_MLP),
                           ("bf16_unaligned", MATMUL_UNALIGNED)):
        cases += ((key, randn(gen, m, k, dtype=torch.bfloat16),
                   randn(gen, k, n, dtype=torch.bfloat16)),)
    for key, x, y in cases:
        (m, k), n = x.shape, y.shape[1]
        p = mm.bf16_plan(m, n, k, mm.bf16_mappable(
            n, k, x.data_ptr(), y.data_ptr()))
        t_bound, by = bound(*mm.work(m, n, k, itemsize=2), BF16_PEAK_FLOPS)
        slow = m * n * k > 1e10
        row, d = time_row(lambda: ops.matmul(x, y),
                          lambda: ref.matmul_ref(x, y),
                          lambda: torch.matmul(x, y), t_bound, by,
                          iters=50 if slow else 200,
                          plain_iters=10 if slow else None)
        row["route"] = p.route
        rows["matmul"][key], dev[f"matmul_{key}"] = row, d
        print(f"  matmul {m}x{k}x{n} bfloat16 ({p.route}: "
              f"{p.tile.tile_m}x{p.tile.tile_n} tiles, {p.blocks} blocks of "
              f"{p.tile.threads} threads, {p.tile.stages} stages, "
              f"{p.tile.smem} B shared): kernel {row['ms']:.4f} ms (device "
              f"{d['kernel']:.4f})  bound {t_bound:.5f} ms ({by}; "
              f"{t_bound / d['kernel']:.1%} of it)  plain "
              f"{row['plain_ms']:.4f} ms (device {d['plain']:.4f})  "
              f"torch.matmul {row['library_ms']:.4f} ms (device "
              f"{d['library']:.4f}; {d['kernel'] / d['library']:.2f}x)")
    require(mm.bf16_plan(*MATMUL_MAIN).blocks >= 64,
            "the bf16 matmul grid at 512^3 is under 64 blocks")


def attended_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal prefill of ``s`` tokens attends, under
    a window (0: none): sum over q of min(q + 1, window)."""
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def sdpa_kind(s, window) -> str:
    """The SDPA call that :func:`flash_case` times beside a prefill of S
    keys under ``window`` (0: none)."""
    return ("boolean causal-and-window mask" if window and window < s
            else "causal")


def flash_case(ops, ref, gen, s, d, window=0, h=FLASH_MAIN[1],
               kv=FLASH_MAIN[2]):
    """Causal bf16 prefill at B=1 (H=32 over KV=8 unless given): (kernel,
    plain, SDPA) calls and the bound (4 FLOP per attended (query, key) pair
    and head dim; q, k, v read and o written once), held to the bf16
    tensor-core peak.  Under a window shorter than S, SDPA takes the
    boolean causal-and-window mask; a window of at least S masks nothing
    the causal mask keeps, so SDPA is then causal."""
    b = FLASH_MAIN[0]
    q, k, v, rep = flash_inputs(gen, s, torch.bfloat16, h=h, kv=kv, d=d)
    q4, k4, v4 = q.reshape(b, h, s, d), k.reshape(b, kv, s, d), \
        v.reshape(b, kv, s, d)
    t_bound, by = bound(4.0 * b * h * d * attended_pairs(s, window),
                        2.0 * (2 * b * h * s * d + 2 * b * kv * s * d),
                        BF16_PEAK_FLOPS)
    if window and window < s:
        pos = torch.arange(s, device="cuda")
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < window)

        def library():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True)
    else:
        def library():
            return F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True)
    return (lambda: ops.flash_attention(q, k, v, kv_group=rep,
                                        window=window),
            lambda: ref.mha_ref(q, k, v, kv_group=rep, window=window),
            library, t_bound, by)


def time_attention(ops, ref, gen, rows, dev):
    """Phase 4, attention kernels at the serving path's bf16 shapes, held to
    the bf16 tensor-core peak; fills ``rows`` and ``dev``."""
    kernel, plain, library, t_bound, by = flash_case(
        ops, ref, gen, FLASH_MAIN[3], FLASH_MAIN[4])
    rows["flash_attention"], dev["flash_attention"] = time_row(
        kernel, plain, library, t_bound, by, iters=50, plain_iters=10)
    for s, d in ((FLASH_RAGGED_S, FLASH_MAIN[4]),
                 (FLASH_MAIN[3], FLASH_WIDE_D)):
        kernel, plain, library, t_bound, by = flash_case(ops, ref, gen, s, d)
        ms, lib_ms = time_ms(kernel, 50), time_ms(library, 50)
        dev_ms, dev_lib = device_profile(kernel)[0], device_profile(library)[0]
        print(f"  flash_attention S={s} D={d}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  bound {t_bound:.4f} ms ({by})  plain "
              f"{time_ms(plain, 10):.4f} ms (device "
              f"{device_profile(plain, 3)[0]:.4f})  SDPA "
              f"{lib_ms:.4f} ms (device {dev_lib:.4f})")

    # four cache pairs in turn (69 MB > the 50 MB L2): each call finds its
    # cache cold, as each layer of a decode step does
    b, h, kv, s, d = DECODE_MAIN
    q, _, _, lens = decode_inputs(gen, torch.bfloat16, b, h, kv, s, d,
                                  DECODE_MAIN_LENS)
    caches = itertools.cycle([
        decode_inputs(gen, torch.bfloat16, b, h, kv, s, d,
                      DECODE_MAIN_LENS)[1:3] for _ in range(4)])
    mask = (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def library():
        kc, vc = next(caches)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    def kernel():
        return ops.decode_attention(q, *next(caches), lens)

    def plain():
        return ref.decode_attention_ref(q, *next(caches), lens)

    # the valid cache rows are what this run's lengths need
    valid = sum(DECODE_MAIN_LENS)
    t_bound, by = bound(4.0 * h * d * valid,
                        2.0 * (2 * valid * kv * d + 2 * b * h * d),
                        BF16_PEAK_FLOPS)
    rows["decode_attention"], dev["decode_attention"] = time_row(
        kernel, plain, library, t_bound, by, plain_iters=50)
    from repro_torch.kernels import decode_attention as da
    p = decode_plan(torch.bfloat16)
    print(f"  decode_attention plan: route {p.route}, chunk {p.chunk} keys, "
          f"grid {p.n_splits}"
          f" splits x {b * kv} (slot, KV head) = {p.n_splits * b * kv} "
          f"blocks, {da.live_blocks(p, DECODE_MAIN_LENS, kv)} live at lengths"
          f" {DECODE_MAIN_LENS}")
    launched = device_kernels(kernel)
    print(f"  decode_attention: one call runs {len(launched)} device "
          f"kernel(s): {launched}")
    require(len(launched) == 1, "a decode_attention call is not one device "
            "kernel")
    full = torch.full((b,), s, dtype=torch.int32, device="cuda")
    full_mask = torch.ones_like(mask)
    t_full, by_full = bound(4.0 * h * d * b * s,
                            2.0 * (2 * b * s * kv * d + 2 * b * h * d),
                            BF16_PEAK_FLOPS)

    def kernel_full():
        return ops.decode_attention(q, *next(caches), full)

    def library_full():
        kc, vc = next(caches)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=full_mask, enable_gqa=True)

    def plain_full():
        return ref.decode_attention_ref(q, *next(caches), full)

    print(f"  decode_attention, every slot at {s}: kernel "
          f"{time_ms(kernel_full, 200):.4f} ms (device "
          f"{device_profile(kernel_full)[0]:.4f})  bound {t_full:.4f} ms "
          f"({by_full})  plain {time_ms(plain_full, 50):.4f} ms (device "
          f"{device_profile(plain_full, 3)[0]:.4f})  SDPA "
          f"{time_ms(library_full, 200):.4f} ms (device "
          f"{device_profile(library_full)[0]:.4f})")
    time_family_rows(ops, ref, gen)


def print_row(what: str, row: dict, dev: dict) -> None:
    print(f"  {what}: kernel {row['ms']:.4f} ms (device {dev['kernel']:.4f})"
          f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  plain "
          f"{row['plain_ms']:.4f} ms (device {dev['plain']:.4f})  library "
          f"{row['library_ms']:.4f} ms (device {dev['library']:.4f})")


def decode_case(ops, ref, gen, shape, lens):
    """bf16 decode of H query heads over a [B, S, KV, D] pool at per-slot
    ``lens``, four cache pairs in turn so that each call finds its cache
    cold: (kernel, plain, masked SDPA) calls and the bound (the valid cache
    rows' bytes, q read and o written once)."""
    b, h, kv, s, d = shape
    q, _, _, ln = decode_inputs(gen, torch.bfloat16, *shape, lens)
    caches = itertools.cycle([
        decode_inputs(gen, torch.bfloat16, *shape, lens)[1:3]
        for _ in range(4)])
    mask = (torch.arange(s, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]

    def library():
        kc, vc = next(caches)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    valid = sum(lens)
    t_bound, by = bound(4.0 * h * d * valid,
                        2.0 * (2 * valid * kv * d + 2 * b * h * d),
                        BF16_PEAK_FLOPS)
    return (lambda: ops.decode_attention(q, *next(caches), ln),
            lambda: ref.decode_attention_ref(q, *next(caches), ln),
            library, t_bound, by)


def time_family_rows(ops, ref, gen):
    """Phase 4, the kernel shapes that phase 7 adds, each beside its bound,
    its plain version and SDPA: h2o-danube's bf16 prefill at D=80, S=5000
    under its 4096 window (SDPA with the boolean causal-and-window mask)
    and without it, and S=1000 under the window (causal SDPA both: the
    window masks nothing at S=1000); its decode
    pool [4,4096,8,80] at lengths 1/1000/4096/4096 (masked SDPA); and at
    D=128 with 6 and 12 query heads a KV head (nemotron-4-15b,
    command-r-plus-104b), the prefill at S=2048 and 1000 and the decode
    pool [4,2112,8,128] at the serving lengths; the same at arctic-480b's
    56 over 8 and moonshot-v1-16b-a3b's 16 over 16 query heads (decode
    over [4,2112,KV,128]); and recurrentgemma-2b's D=256 at 10 query heads
    over one KV head: the prefill under its 2048 window at S=4096 (SDPA
    with the boolean causal-and-window mask) and S=1000 (causal GQA SDPA:
    the window masks nothing there), the decode ring [4,2048,1,256] at
    lengths 1/1000/2048/2048 (masked SDPA)."""
    d = H2O_FLASH[4]
    cases = [(f"flash_attention S={s} D={d} window {w} "
              f"({attended_pairs(s, w) / 1e6:.2f} M pairs a head; SDPA "
              f"{sdpa_kind(s, w)})",
              flash_case(ops, ref, gen, s, d, w), 50, 3)
             for s, w in ((H2O_FLASH[3], H2O_WINDOW), (H2O_FLASH[3], 0),
                          (FLASH_RAGGED_S, H2O_WINDOW))]
    cases.append((decode_label(H2O_DECODE, H2O_DECODE_LENS),
                   decode_case(ops, ref, gen, H2O_DECODE, H2O_DECODE_LENS),
                   200, 50))
    b, _, _, s_pool, _ = DECODE_MAIN
    for h, kv in WIDE_LAYOUTS:
        for s in (FLASH_MAIN[3], FLASH_RAGGED_S):
            cases.append((f"flash_attention H={h} KV={kv} S={s} "
                          f"D={FLASH_WIDE_D}",
                          flash_case(ops, ref, gen, s, FLASH_WIDE_D, h=h,
                                     kv=kv),
                          50, 3))
        shape = (b, h, kv, s_pool, FLASH_WIDE_D)
        cases.append((decode_label(shape, DECODE_MAIN_LENS),
                      decode_case(ops, ref, gen, shape, DECODE_MAIN_LENS),
                      200, 50))
    _, h, kv, s_main, d = GRIFFIN_FLASH
    for s in (s_main, FLASH_RAGGED_S):
        cases.append((f"flash_attention H={h} KV={kv} S={s} D={d} window "
                      f"{GRIFFIN_WINDOW} "
                      f"({attended_pairs(s, GRIFFIN_WINDOW) / 1e6:.2f} M "
                      f"pairs a head; SDPA {sdpa_kind(s, GRIFFIN_WINDOW)})",
                      flash_case(ops, ref, gen, s, d, GRIFFIN_WINDOW, h=h,
                                 kv=kv),
                      50, 3))
    cases.append((decode_label(GRIFFIN_DECODE, GRIFFIN_DECODE_LENS,
                               f" at {h} query heads,"),
                   decode_case(ops, ref, gen, GRIFFIN_DECODE,
                               GRIFFIN_DECODE_LENS),
                   200, 50))
    for what, (kernel, plain, library, t_bound, by), iters, plain_iters \
            in cases:
        row, dev = time_row(kernel, plain, library, t_bound, by,
                            iters=iters, plain_iters=plain_iters)
        print_row(what, row, dev)
    time_cross_rows(ops, ref, gen)


def cross_case(ops, ref, gen, sq, skv, h, kv, d):
    """Non-causal bf16 flash at B=1 from Sq queries over Skv keys: (kernel,
    plain, non-causal SDPA) calls and the bound (4 FLOP per (query, key)
    pair and head dim, every pair attended; q, k, v read and o written
    once), held to the bf16 tensor-core peak."""
    q, k, v, rep = flash_inputs(gen, sq, torch.bfloat16, h=h, kv=kv, d=d,
                                skv=skv)
    q4, k4, v4 = q[None], k[None], v[None]
    t_bound, by = bound(4.0 * h * d * sq * skv,
                        2.0 * (2 * h * sq * d + 2 * kv * skv * d),
                        BF16_PEAK_FLOPS)

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4,
                                              enable_gqa=kv < h)
    return (lambda: ops.flash_attention(q, k, v, causal=False,
                                        kv_group=rep),
            lambda: ref.mha_ref(q, k, v, causal=False, kv_group=rep),
            library, t_bound, by)


def time_cross_rows(ops, ref, gen):
    """Phase 4, the kernel shapes that phase 10 adds, each beside its
    bound, its plain version and SDPA: llama-3.2-vision-90b's cross
    attention (H=64 over KV=8, D=128, Sq 2048 and 1000 over its 1024 image
    tokens; non-causal GQA SDPA) and causal self-attention at S=2048
    (causal GQA SDPA); seamless-m4t-medium's non-causal encoder (H=16,
    S=3072, D=64), its cross attention (Sq 2048 and 1000 over 3072 frames;
    non-causal SDPA) and causal self-attention at S=2048; decode over the
    VLM's [4,2112,8,128] pool at the serving lengths and its full
    [4,1024,8,128] context, and over the audio [4,2112,16,64] pool and its
    full [4,3072,16,64] frames (masked SDPA)."""
    h, kv, d = VLM_HEADS
    ah, akv, ad = AUDIO_HEADS
    cases = [(f"flash_attention VLM cross H={h} KV={kv} Sq={s} "
              f"Skv={VLM_CTX} D={d} (SDPA non-causal GQA)",
              cross_case(ops, ref, gen, s, VLM_CTX, h, kv, d))
             for s in SERVE_PROMPTS[::-1]]
    cases.append((f"flash_attention VLM self H={h} KV={kv} "
                  f"S={FLASH_MAIN[3]} D={d} (SDPA causal GQA)",
                  flash_case(ops, ref, gen, FLASH_MAIN[3], d, h=h, kv=kv)))
    cases.append((f"flash_attention audio encoder H={ah} S={AUDIO_CTX} "
                  f"D={ad} non-causal (SDPA non-causal)",
                  cross_case(ops, ref, gen, AUDIO_CTX, AUDIO_CTX, ah, akv,
                             ad)))
    cases += [(f"flash_attention audio cross H={ah} Sq={s} Skv={AUDIO_CTX} "
               f"D={ad} (SDPA non-causal)",
               cross_case(ops, ref, gen, s, AUDIO_CTX, ah, akv, ad))
              for s in SERVE_PROMPTS[::-1]]
    cases.append((f"flash_attention audio self H={ah} S={FLASH_MAIN[3]} "
                  f"D={ad} (SDPA causal)",
                  flash_case(ops, ref, gen, FLASH_MAIN[3], ad, h=ah,
                             kv=akv)))
    b, _, _, s_pool, _ = DECODE_MAIN
    for hh, kk, ctx, dd in ((h, kv, VLM_CTX, d), (ah, akv, AUDIO_CTX, ad)):
        for ss, lens in ((s_pool, DECODE_MAIN_LENS), (ctx, (ctx,) * b)):
            shape = (b, hh, kk, ss, dd)
            cases.append((decode_label(shape, lens),
                           decode_case(ops, ref, gen, shape, lens)))
    for what, (kernel, plain, library, t_bound, by) in cases:
        decode = what.startswith("decode")
        row, dev = time_row(kernel, plain, library, t_bound, by,
                            iters=200 if decode else 50,
                            plain_iters=50 if decode else 3)
        print_row(what, row, dev)


def decode_label(shape, lens, extra: str = "") -> str:
    """Phase 4's name of a bf16 decode row: its pool, lengths and route."""
    route = decode_plan(torch.bfloat16, shape).route
    return f"decode_attention over {list(shape)}{extra} lens {lens} [{route}]"


def decode_plan(dtype, shape=DECODE_MAIN):
    """The decode kernel's splits at ``shape`` (B, H, KV, S, D)."""
    from repro_torch.kernels import decode_attention as da
    b, h, kv, s, d = shape
    return da.plan(b, h, kv, s, d, dtype)


def is_decode_kernel(name: str) -> bool:
    """Whether a device kernel's name is one of decode attention's (the
    CUDA-core route's or the tensor-core route's)."""
    return any(k in name for k in DECODE_KERNELS)


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (a torch.profiler
    trace after a warm-up)."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    _, traced = traced_kernels(fn, [ProfilerActivity.CUDA])
    return [name for name, _ in traced]


@functools.lru_cache(maxsize=None)
def library_sass(cuobjdump: str, library: str) -> str:
    """The SASS of a kernel library (named by its content hash, so one
    disassembly serves every count of phase 2)."""
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def count_sass(build, name: str, opcode: str) -> int:
    """How many ``opcode`` instructions the SASS of kernel library ``name``
    holds (cuobjdump from the toolkit that built it)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = library_sass(cuobjdump, str(build.library_path(name)))
    return len(re.findall(rf"\b{re.escape(opcode)}[.\s]", sass))


def ptxas_kernels(log: str) -> list:
    """(mangled name, registers, spill-store bytes) of each kernel in an
    ``-Xptxas -v`` report."""
    found = []
    for m in re.finditer(r"Function properties for (\S+)\s*\n\s*\d+ bytes "
                         r"stack frame, (\d+) bytes spill stores.*?\n"
                         r"ptxas info\s*: Used (\d+) registers", log):
        found.append((m.group(1), int(m.group(3)), int(m.group(2))))
    return found


def function_sass(build, name: str) -> dict:
    """The SASS of each kernel of library ``name``, by mangled name."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = library_sass(cuobjdump, str(build.library_path(name)))
    parts = re.split(r"Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def check_bwd_build(log: str) -> None:
    """Phase 2, the flash backward's build: its tensor-core kernels must
    not spill, the D = 256 ones (``*_wgmma256_kernel``: dK/dV and dQ,
    general or not) must be there with ``HGMMA`` in their own SASS, no
    bf16 instance of the CUDA-core kernels may be left, and
    ``kernels/flash_attention_bwd.plan`` must equal the compiled plan (the
    wrapper checks when it loads)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as fab
    kernels = ptxas_kernels(log)
    wgmma = [k for k in kernels if "wgmma" in k[0]]
    for name, regs, spill in wgmma:
        print(f"  flash_attention_bwd {name[:70]}: {regs} registers, "
              f"{spill} bytes spill stores")
    require(wgmma and not any(spill for _, _, spill in wgmma),
            "a tensor-core kernel of the flash backward spills registers "
            "(or the report lists none)")
    sass = function_sass(_build, "flash_attention_bwd")
    d256 = {n: len(re.findall(r"\bHGMMA[.\s]", text))
            for n, text in sass.items() if "wgmma256" in n}
    print(f"  flash_attention_bwd D = 256 kernels, HGMMA in each: "
          + ", ".join(f"{n[:60]} {c}" for n, c in d256.items()))
    require(len(d256) == 4 and all(d256.values())
            and len([k for k in wgmma if "wgmma256" in k[0]]) == 4,
            "the flash backward's D = 256 tensor-core kernels (dK/dV and "
            "dQ, general or not) are missing or have no HGMMA")
    cuda_cores = [n for n, _, _ in kernels if re.search(
        r"bwd_(dkdv|dq)_kernel", n)]
    require(cuda_cores and not any("bfloat16" in n for n in cuda_cores),
            f"a bf16 instance of the CUDA-core backward is left: "
            f"{[n for n in cuda_cores if 'bfloat16' in n]}")
    fab._lib()
    for dtype in (torch.bfloat16, torch.float32):
        for d in fab.HEAD_DIMS:
            print(f"  flash_attention_bwd plan D={d} {dtype}: "
                  f"{fab.plan(d, dtype)}")


def check_decode_build(log: str) -> None:
    """Phase 2, the decode library's build: its grouped bf16 route runs on
    the tensor cores (HMMA, mma.sync, in its SASS), and none of that
    route's kernels spills (``-Xptxas -v``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    n_hmma = count_sass(_build, "decode_attention", "HMMA")
    print(f"  decode_attention SASS: {n_hmma} HMMA (mma.sync) instructions")
    require(n_hmma > 0, "the decode_attention library has no HMMA: its "
            "grouped bf16 route does not run on the tensor cores")
    mma = [k for k in ptxas_kernels(log) if "decode_mma_kernel" in k[0]]
    for name, regs, spill in mma:
        print(f"  decode_attention {name[:70]}: {regs} registers, {spill} "
              f"bytes spill stores")
    require(len(mma) == 2 * len(da.HEAD_DIMS)
            and not any(spill for _, _, spill in mma),
            "a tensor-core decode kernel spills registers (or the report "
            "lists fewer than one capped and one uncapped a head dim)")


def check_plan_report(name: str, report) -> None:
    """Phase 5's verdicts on one planner report (phase 11 holds its own
    reports to them too)."""
    recs = report.records
    require(len(recs) == 6, f"{name}: {len(recs)} verifications, not 6")
    sel = report.selected
    require(sel is not None and sel.correct
            and sel.best_time_s < float("inf"),
            f"{name}: no correct destination selected")
    fpga_loop = [r for r in recs if r.paper_analogue == "FPGA"
                 and r.method == "loop"]
    require(len(fpga_loop) == 1 and fpga_loop[0].n_measurements <= 4,
            f"{name}: FPGA loop verification measured more than 4")
    if name == "NAS.BT":
        require(sel.choice.get("seidel_relax", "seq") not in ("dp", "tp"),
                "NAS.BT: the wrong Jacobi smoother was selected")


def verdicts(report) -> list:
    """(destination, method, correct) of each verification of a report."""
    return [(r.destination, r.method, r.correct) for r in report.records]


def run_planner(ops):
    """Phase 5: the port's main path; then each app linted
    (:func:`run_linted`).  Returns launches per kernel (both runs'), the
    planner's wall seconds per app and each app's verdicts."""
    from repro_torch.core.planner import UserTarget
    from repro_torch.quickstart import print_report, run_app

    ops.reset_launch_counts()
    grew, walls, seen = {}, {}, {}
    for name in PLANNER_APPS:
        before = ops.launch_counts()
        t0 = time.perf_counter()
        report = run_app(name, UserTarget(), full=True, policy="host-time",
                         device="cuda")
        walls[name] = time.perf_counter() - t0
        after = ops.launch_counts()
        print_report(name, report)
        print(f"  [{walls[name]:.1f} s, kernel launches "
              f"{ {k: after[k] - before[k] for k in after} }]", flush=True)
        grew[name] = {k: after[k] - before[k] for k in after}
        check_plan_report(name, report)
        seen[name] = verdicts(report)
    require(grew["3mm"]["matmul"] > 0, "3mm never launched the matmul kernel")
    require(grew["tdFIR"]["tdfir"] > 0, "tdFIR never launched the tdfir "
            "kernel")
    run_linted(ops)
    return ops.launch_counts(), walls, seen


def run_linted(ops) -> None:
    """Phase 5's linted runs: each app at its small size through
    ``plan_offload(lint_choice=)`` on the card, with a lint that rejects
    one pattern the app's loop searches meet (``PLAN_LINT_REJECT``): that
    pattern is never built or measured, the records count it
    (``static_pruned``), the FPGA analogue measures at most 4 patterns and
    the selection is correct.  The matmul and tdfir launches of these runs
    count into the ``kernels`` line."""
    from repro_torch.analysis import Finding
    from repro_torch.apps import APPS
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.measure import TimedRunner
    from repro_torch.core.planner import UserTarget, plan_offload

    for name in PLANNER_APPS:
        nest, impls = PLAN_LINT_REJECT[name]
        app = APPS[name]()
        built, build = [], app.build

        def spying(choice, build=build, built=built):
            built.append(dict(choice))
            return build(choice)

        def lint_choice(choice, nest=nest, impls=impls):
            if choice.get(nest) in impls:
                return [Finding("X001", "error",
                                f"{nest} on {choice[nest]} rejected")]
            return []

        app.build = spying
        before = ops.launch_counts()
        t0 = time.perf_counter()
        report = plan_offload(
            app, UserTarget(),
            inputs=app.make_inputs(seed=0, small=True, device="cuda"),
            runner=TimedRunner(repeats=1),
            ga_cfg=GAConfig.for_gene_length(min(app.gene_length, 6), seed=0),
            device="cuda", lint_choice=lint_choice)
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v != before[k]}
        pruned = {r.destination + "/" + r.method:
                  r.cache_stats.get("static_pruned")
                  for r in report.records if r.cache_stats.get(
                      "static_pruned")}
        sel = report.selected
        fpga = [r for r in report.records if r.paper_analogue == "FPGA"
                and r.method == "loop"]
        print(f"  linted {name:6s} (small, {nest} on {'/'.join(impls)} "
              f"rejected): {wall:.1f} s, {len(built)} patterns built, "
              f"pruned {pruned}, FPGA loop measured "
              f"{fpga[0].n_measurements if fpga else None}, selected "
              f"{sel.paper_analogue} {sel.method} "
              f"{ {k: v for k, v in sel.choice.items() if v != 'seq'} }, "
              f"launches {grew}", flush=True)
        require(all(c.get(nest) not in impls for c in built),
                f"(5) linted {name}: a rejected pattern was measured")
        require(sum(pruned.values()) >= 1,
                f"(5) linted {name}: nothing was statically pruned")
        require(len(fpga) == 1 and fpga[0].n_measurements <= 4,
                f"(5) linted {name}: the FPGA loop measured more than 4")
        require(sel is not None and sel.correct
                and sel.choice.get(nest) not in impls,
                f"(5) linted {name}: no correct selection")
        if name == "3mm":
            require(pruned.get(fpga[0].destination + "/loop", 0) >= 1
                    and grew.get("matmul", 0) > 0,
                    f"(5) linted 3mm: the FPGA pattern was not pruned, or "
                    f"the matmul kernel did not launch ({grew})")
        if name == "tdFIR":
            require(grew.get("tdfir", 0) > 0,
                    "(5) linted tdFIR never launched the tdfir kernel")


def run_modeled(ops, plan_walls, plan_verdicts, tmp: str):
    """Phase 11: the modeled-cost path.  Each app at the paper's sizes
    through ``plan_offload`` with a ``CompiledCostRunner`` on the one-device
    mesh and a ``PlanLookup`` over a ``SearchCache`` on disk, under the
    host-time and the modeled policy (the host-time runs with a
    ``lint_choice`` that rejects nothing, whose verdicts must be phase 5's
    unlinted ones); every correct dp / tp record must
    carry a modeled time and its roofline (the FPGA analogue's none), no
    kernel may launch while a candidate is analysed, the lookup must hold
    each destination's verdict, and a second scoring pass over it, with the
    tracer poisoned, must trace nothing.  Its launches are printed on a
    line of their own; the ``kernels`` line keeps phase 5's.  Returns the
    lookup (its disk layer in ``tmp``), which phase 12 routes over."""
    from repro_torch.core import trace_analysis
    from repro_torch.core.measure import CompiledCostRunner
    from repro_torch.core.plan_lookup import PlanLookup, serve_key
    from repro_torch.core.planner import UserTarget
    from repro_torch.core.search_cache import SearchCache
    from repro_torch.dist.bridge import LocalMesh
    from repro_torch.quickstart import print_report, run_app

    class WatchedCostRunner(CompiledCostRunner):
        """Counts the traces and their seconds; no kernel may launch while
        one runs."""
        traces, trace_s = 0, 0.0

        def measure(self, fn, inputs, **kw):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            ev = super().measure(fn, inputs, **kw)
            self.trace_s += time.perf_counter() - t0
            self.traces += 1
            require(ops.launch_counts() == before, "a kernel launched while "
                    "a candidate was analysed")
            if not ev.correct:
                print(f"  analysis failed: {ev.info.get('error')}")
            return ev

    runner = WatchedCostRunner(mesh=LocalMesh())
    selected, winners = {}, []
    lookup = PlanLookup(SearchCache(os.path.join(tmp, "lookup.json")))
    ops.reset_launch_counts()
    by_app = {name: [] for name in PLANNER_APPS}
    for name in PLANNER_APPS:
        for policy in MODELED_POLICIES:
            linted = policy == MODELED_POLICIES[0]
            kw = {"lint_choice": lambda choice: []} if linted else {}
            t0 = time.perf_counter()
            report = run_app(name, UserTarget(), full=True,
                             policy=policy, device="cuda",
                             cost_runner=runner, publish=lookup, **kw)
            wall = time.perf_counter() - t0
            print_report(name, report)
            print(f"  [{wall:.1f} s with the cost runner; phase 5 "
                  f"without it {plan_walls[name]:.1f} s]", flush=True)
            check_plan_report(name, report)
            if linted:
                require(verdicts(report) == plan_verdicts[name],
                        f"(11) {name}: a lint that rejects nothing changed "
                        f"the verdicts {verdicts(report)} from phase 5's "
                        f"{plan_verdicts[name]}")
            modeled_table(name, report)
            by_app[name].extend(report.records)
            if policy == MODELED_POLICIES[0]:
                winners += [(name, BRIDGE_ROLES[r.paper_analogue],
                             dict(r.choice), r.mesh_time_s)
                            for r in report.records
                            if r.method == "loop" and r.mesh_time_s
                            and r.paper_analogue in BRIDGE_ROLES]
                if name == PLANNER_APPS[-1]:
                    bridge = start_bridge(winners, tmp)
            sel = report.selected
            selected[(name, policy)] = (
                f"{sel.paper_analogue} {sel.method} "
                f"{ {k: v for k, v in sel.choice.items() if v != 'seq'} }")
    launches = ops.launch_counts()
    print(f"  kernel launches in the phase {launches}; {runner.traces} "
          f"traces, {runner.trace_s:.2f} s tracing")
    require(launches["matmul"] > 0 and launches["tdfir"] > 0,
            "phase 11 never launched the matmul or the tdfir kernel")
    for (name, policy), what in selected.items():
        print(f"  selected {name:6s} under {policy:9s}: {what}")
    finish_bridge(*bridge)
    keys = check_lookup(lookup, by_app, serve_key)
    # the second pass: lookups only, with the tracer poisoned
    misses, lookups = lookup.stats.misses, lookup.stats.lookups
    saved = trace_analysis.trace

    def poisoned(*args, **kw):
        raise SmokeFailure("a plan lookup traced a candidate")

    trace_analysis.trace = poisoned
    try:
        scored = {k: lookup.score(k) for k in keys}
    finally:
        trace_analysis.trace = saved
    require(lookup.stats.lookups == lookups + len(keys)
            and lookup.stats.misses == misses,
            "the second scoring pass did not stay on lookups")
    for key, ev in scored.items():
        print(f"  lookup {key[1]:13s} {key[2]:6s} "
              + ("failure" if ev is None else
                 f"{ev.time_s * 1e6:10.2f} us modeled"))
    print(f"  lookup stats {lookup.stats.to_dict()}")
    return lookup


def start_bridge(winners, tmp: str):
    """Phase 11's sharded bridge: each app's dp and tp winners (``winners``:
    (app, role, choice, one-device modeled s)) traced on a ("data",
    "model") mesh of BRIDGE_MESH of the fake process group, in a child
    process (its group stays out of the later phases'), started beside
    the last planner run; returns what :func:`finish_bridge` takes."""
    require(len(winners) == 2 * len(PLANNER_APPS),
            f"phase 11 has {len(winners)} dp / tp winners with a modeled "
            f"time, not {2 * len(PLANNER_APPS)}")
    path = os.path.join(tmp, "bridge.json")
    with open(path, "w") as f:
        json.dump(winners, f)
    proc = subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                             f"chip_smoke.bridge_mesh_child({path!r})"],
                            cwd=ROOT)
    _CHILDREN.append(proc)
    return winners, path, proc, time.perf_counter()


def finish_bridge(winners, path: str, proc, t0: float) -> None:
    """Wait for the bridge's child (at most 300 s): every pair must be
    correct, with no kernel launched while it is traced; its modeled ms
    and collective bytes per device are printed beside the one-device
    ones."""
    try:
        proc.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure("(11) the bridge's child ran past 300 s")
    require(proc.returncode == 0, f"(11) the bridge's child failed "
            f"({proc.returncode})")
    wall = time.perf_counter() - t0
    with open(path) as f:
        got = json.load(f)
    print(f"  the bridge on a (data, model) mesh of {BRIDGE_MESH} (fake "
          f"process group, one device traced), {wall:.1f} s in a child "
          f"process beside the last planner run:")
    for (name, role, _, local_s), ev in zip(winners, got):
        print(f"    {name:6s} {role:5s}: modeled {ev['ms']:.6f} ms "
              f"(one device {local_s * 1e3:.6f}), collective bytes per "
              f"device {ev['coll']:.0f} (one device 0), FLOPs per device "
              f"{ev['flops']:.4g}, dominant {ev['dominant']}, traced in "
              f"{ev['trace_s']:.2f} s, launches {ev['launches']}")
        require(ev["correct"], f"(11) {name} {role} on the mesh: "
                f"{ev['error']}")
        require(not ev["launches"], f"(11) {name} {role}: a kernel "
                f"launched while it was traced on the mesh")


def bridge_mesh_child(path: str) -> None:
    """The child process of :func:`start_bridge`: reads the winners from
    ``path``, writes each one's Evaluation there."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.apps import APPS
    from repro_torch.backends import FPGA, GPU, MANY_CORE
    from repro_torch.core import function_blocks
    from repro_torch.core.measure import CompiledCostRunner
    from repro_torch.dist import bridge
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    with open(path) as f:
        winners = json.load(f)
    dests = {"data": MANY_CORE, "model": GPU}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(BRIDGE_MESH)))
    out = []
    try:
        runner = CompiledCostRunner(make_test_mesh(
            BRIDGE_MESH, ("data", "model"), device="cpu"))
        for name, role, choice, _ in winners:
            app = APPS[name]()
            # the planner's function-block impls, which a winner may name
            matches = function_blocks.detect(app)
            for dest in (MANY_CORE, GPU, FPGA):
                function_blocks.apply_matches(app, matches, dest.key)
            inputs = app.make_inputs(0, small=False, device="cpu")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            ev = bridge.mesh_verify(runner, dests[role], app.build(choice),
                                    inputs)
            trace_s = time.perf_counter() - t0
            rl = ev.info.get("roofline", {})
            out.append({"correct": ev.correct, "ms": ev.time_s * 1e3,
                        "error": ev.info.get("error", ""),
                        "coll": ev.info.get("collective_bytes_per_device",
                                            0.0),
                        "flops": ev.info.get("flops_per_device", 0.0),
                        "dominant": rl.get("dominant", ""),
                        "trace_s": trace_s,
                        "launches": {k: v for k, v in
                                     ops.launch_counts().items() if v}})
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def modeled_table(name: str, report) -> None:
    """Per record: measured and modeled ms, their ratio, the dominant term,
    the FLOPs by dtype and the bytes; requires a modeled time and a
    roofline on every correct dp / tp record and none on the FPGA's."""
    print(f"  {'record':28s} {'measured ms':>11s} {'modeled ms':>11s} "
          f"{'ratio':>9s} {'dominant':>9s}  flops by dtype, bytes")
    for r in report.records:
        usable = r.correct and r.best_time_s < float("inf")
        what = f"{r.order}. {r.paper_analogue} {r.method}"
        if r.paper_analogue == "FPGA" or not usable:
            require(r.mesh_time_s is None and not r.mesh_info,
                    f"{name}: {what} carries a modeled time")
            continue
        rl = r.mesh_info.get("roofline")
        require(r.mesh_time_s is not None and r.mesh_time_s > 0 and rl,
                f"{name}: {what} has no modeled time or roofline")
        split = {d: f"{v:.4g}" for d, v in rl["flops_by_dtype"].items() if v}
        print(f"  {what:28s} {r.best_time_s * 1e3:11.4f} "
              f"{r.mesh_time_s * 1e3:11.6f} "
              f"{r.mesh_time_s / r.best_time_s:9.5f} {rl['dominant']:>9s}  "
              f"{split}, {rl['bytes_per_device']:.4g} B")


def check_lookup(lookup, by_app, serve_key) -> list:
    """Each (destination, app): a warm key where a record was correct, a
    failure where every record was wrong; returns the keys."""
    keys = []
    for name, recs in by_app.items():
        for dest in sorted({r.destination for r in recs}):
            mine = [r for r in recs if r.destination == dest]
            key = serve_key(dest, name)
            payload = lookup.cache.lookup(key, count=False)
            if any(r.correct and r.best_time_s < float("inf") for r in mine):
                require(lookup.usable(payload), f"{name} on {dest}: no warm "
                        f"lookup entry for a correct destination")
            elif any(not r.correct for r in mine):
                require(payload is not None and "error" in payload,
                        f"{name} on {dest}: no failure for a destination "
                        f"proven wrong")
            else:
                continue
            keys.append(key)
    return keys


# phase 12: a seeded open-loop trace a app of FLEET_REQUESTS requests, one
# arrival a tick; the kill scenario of the reference's benchmarks/chaos.py
# (the selected endpoint dead from FLEET_KILL to FLEET_REVIVE)
FLEET_REQUESTS = 120
FLEET_KILL, FLEET_REVIVE = 20, 60
FLEET_TICK_S = 0.01
# the three models no card holds whole (phase 7 (e), 8 (h), 10 (k) cut them)
WHOLE_MODELS = ("command-r-plus-104b", "arctic-480b", "llama-3.2-vision-90b")


class CardBackend:
    """The serving cells' destination: the card running the captured
    engine, charged at the H100 envelope (duck-typed ``Backend``)."""
    name = "h100-engine"
    price = 1.0
    paper_analogue = ""

    def __init__(self):
        from repro_torch.power import H100_SXM
        self.power = H100_SXM


def copy_verdicts(lookup, backends, apps):
    """A fresh ``PlanLookup`` holding ``lookup``'s verdict for each
    (destination, app): its analysis, or its failure.  Each chaos run
    starts from this copy, so the lookup counters its trace records start
    at the same values run after run."""
    from repro_torch.core.plan_lookup import PlanLookup, serve_key
    out = PlanLookup()
    for app in apps:
        for b in backends:
            key = serve_key(b.name, app)
            payload = lookup.cache.lookup(key, count=False)
            if payload is None:
                continue
            if "error" in payload:
                out.register_failure(key, payload["error"])
            else:
                out.register(key, payload["analysis"])
    return out


def run_fleet(ops, lookup, cells: list, tmp: str) -> None:
    """Phase 12: the router, health, fleet, control and observability
    layers over phase 11's published H100 verdicts, all of it under
    ``kernels.ops.no_device_work`` (a trace, a graph capture or a launch
    fails the phase).  (1) Each app's open-loop trace routed through a
    ``Router`` over one ``Endpoint`` a destination under the modeled
    policy: every request completes, each on a destination with a correct
    verdict, the lookup's trace counter stays flat; routes per second on
    the host.  (2) Each bf16 serving cell of phases 6–10 as an endpoint
    with its config as built, 4 slots, its cache_len and its measured
    decode step published through ``analysis_from_time``: the lint at the
    H100's 80 GiB prunes none of its requests, and rejects
    command-r-plus-104b, arctic-480b and llama-3.2-vision-90b whole (P019);
    the lint's params + pool beside what the card held.  (3) A
    ``FleetPlanner`` placement of the three apps over the three
    destinations, then per app the kill scenario: a ``ControlLoop`` whose
    ``FaultInjector`` kills the endpoint the router selects mid-trace and
    revives it, with 0 dropped, 0 double completions, a recovered circuit,
    no replan onto a failure verdict, the fleet draw never negative and a
    second run's JSONL byte-identical; the JSONL and Chrome trace go to
    ``tmp`` and ``python -m repro_torch.obs.report`` must exit 0 on the
    JSONL."""
    from repro_torch import obs
    from repro_torch.analysis import DEVICE_MEMORY_BYTES, lint_plan
    from repro_torch.analysis.plan_lint import serve_kv_bytes
    from repro_torch.backends import DEFAULT_REGISTRY
    from repro_torch.configs import get_config
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.plan_lookup import (PlanLookup, analysis_from_time,
                                              serve_key)
    from repro_torch.dist.plan import Plan
    from repro_torch.fleet import FleetApp, FleetPlanner, PoolBackend
    from repro_torch.runtime.control import (ControlLoop, Fault,
                                             FaultInjector, FleetController)
    from repro_torch.serve import (HEALTHY, PROBING, QUARANTINED, Endpoint,
                                   HealthConfig, Request, Router)

    backends = list(DEFAULT_REGISTRY)

    def usable(lk, dest, app):
        return lk.usable(lk.cache.lookup(serve_key(dest, app), count=False))

    def endpoints(app, n_slots):
        return [Endpoint(name=f"{b.name}/{app}", backend=b, arch=app,
                         n_slots=n_slots) for b in backends]

    with ops.no_device_work():
        # (1) routing over the published verdicts
        for app in PLANNER_APPS:
            verdicts = {b.name: usable(lookup, b.name, app)
                        for b in backends}
            rng = np.random.default_rng(12)
            trace = [Request(rid=f"{app}-{i:04d}", arch=app,
                             prompt_len=int(rng.integers(8, 65)),
                             max_gen=int(rng.integers(1, 9)),
                             arrival_s=i * FLEET_TICK_S)
                     for i in range(FLEET_REQUESTS)]
            router = Router(endpoints(app, SERVE_SLOTS), lookup,
                            policy="modeled")
            misses = lookup.stats.misses
            loop = ControlLoop(router, trace, tick_s=FLEET_TICK_S,
                               max_ticks=50 * FLEET_REQUESTS)
            out = loop.run()
            require(out["completed"] == FLEET_REQUESTS and not out["dropped"]
                    and out["double_completed"] == 0,
                    f"{app}: the routed trace did not complete whole: {out}")
            wrong = [name for _, _, name in loop.dispatch_log
                     if not verdicts[name.split("/")[0]]]
            require(not wrong, f"{app}: requests went to destinations "
                    f"without a correct verdict: {sorted(set(wrong))}")
            timing = Router(endpoints(app, SERVE_SLOTS), lookup,
                            policy="modeled")
            t0 = time.perf_counter()
            for r in trace:
                timing.route(r)
            rate = len(trace) / (time.perf_counter() - t0)
            require(lookup.stats.misses == misses,
                    f"{app}: routing added {lookup.stats.misses - misses} "
                    f"entries to the lookup")
            print(f"  {app}: verdicts {verdicts}; {out['completed']} "
                  f"requests over {out['ticks']} ticks, dispatches "
                  f"{out['dispatches']}; {rate:.0f} routes per second on "
                  f"the host")

        # (2) the serving cells as endpoints, linted at the H100's memory
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  lint capacity DEVICE_MEMORY_BYTES {DEVICE_MEMORY_BYTES} B "
              f"({DEVICE_MEMORY_BYTES / 2**30:.0f} GiB); torch total_memory "
              f"{total} B ({total / 2**30:.2f} GiB)")
        card = CardBackend()
        lk = PlanLookup()
        for c in cells:
            cfg, plan = c["cfg"], c["plan"]
            ep = Endpoint(name=c["label"], backend=card, arch=cfg.name,
                          n_slots=SERVE_SLOTS, cache_len=c["cache_len"],
                          plan=plan, cfg=cfg)
            lk.register(ep.lookup_key(), analysis_from_time(c["step_s"]))
            router = Router([ep], lk, policy="modeled")
            for i, n in enumerate(c["prompts"]):
                d = router.route(Request(rid=f"{c['label']}{i}",
                                         arch=cfg.name, prompt_len=n,
                                         max_gen=SERVE_MAX_GEN))
                require(d.accepted, f"({c['label']}) the router refused a "
                        f"request the card served: {d.reason}")
            quant = bool(plan is not None and plan.kv_cache_quant)
            pool = SERVE_SLOTS * serve_kv_bytes(cfg, c["cache_len"],
                                                quant=quant)
            params = cfg.n_params() * 2          # bf16, as the cells ran
            print(f"  ({c['label']}) {cfg.name}, {cfg.n_layers} layers: "
                  f"lint params {params / 1e9:.3f} + pool {pool / 1e9:.3f} "
                  f"= {(params + pool) / 1e9:.3f} GB against "
                  f"{c['held'] / 1e9:.3f} GB held "
                  f"(ratio {(params + pool) / c['held']:.3f}); step "
                  f"{c['step_s'] * 1e3:.3f} ms published, modeled "
                  f"{d.service_time_s * 1e3:.3f} ms a request")
        require(lk.stats.static_pruned == 0,
                f"the lint pruned {lk.stats.static_pruned} requests of "
                f"cells the card held")
        for arch in WHOLE_MODELS:
            cfg = get_config(arch)
            found = lint_plan(Plan(), cfg=cfg, serve={
                "n_slots": SERVE_SLOTS, "cache_len": SERVE_CACHE_LEN,
                "prompt_len": max(SERVE_PROMPTS), "max_gen": SERVE_MAX_GEN})
            p019 = [f for f in found if f.rule_id == "P019"]
            require(p019 and p019[0].severity == "error",
                    f"{arch} whole is not a P019 error at 80 GiB")
            ctx = p019[0].context
            print(f"  {arch} whole: P019 error, params "
                  f"{ctx['param_bytes'] / 1e9:.1f} + pool "
                  f"{ctx['pool_bytes'] / 1e9:.2f} GB > "
                  f"{ctx['capacity_bytes'] / 1e9:.1f} GB")

        # (3) placement and the kill scenario
        pool = [PoolBackend(name=b.name, backend=b, slots=16.0)
                for b in backends]
        apps = [FleetApp(name=app, arch=app, load_rps=1.0,
                         tokens_per_request=2.0) for app in PLANNER_APPS]
        planner = FleetPlanner(pool, lookup, ga_cfg=GAConfig(
            population=4, generations=4, seed=0,
            cardinalities=[len(pool)] * len(apps)))
        placement = planner.plan(apps)
        require(placement.feasible, f"no feasible placement: "
                f"{placement.violations}")
        require(all(usable(lookup, b, a)
                    for a, b in placement.by_app.items()),
                f"a placement on a failure verdict: {placement.by_app}")
        print(f"  placement {placement.by_app}: fleet draw "
              f"{placement.fleet_draw_w:.3f} W, "
              f"{placement.joules_per_request:.6f} J a request")

        def chaos(app, victim):
            tracer = obs.Tracer()
            with obs.use_tracer(tracer):
                tracer.set_time(0.0)
                lk = copy_verdicts(lookup, backends, [app])
                router = Router(endpoints(app, 8), lk, policy="modeled",
                                health_cfg=HealthConfig(
                                    error_threshold=1, backoff_ticks=4,
                                    backoff_mult=2.0, probe_quota=1,
                                    probe_successes=1))
                fleet = FleetPlanner(pool, lk, ga_cfg=GAConfig(
                    population=4, generations=4, seed=0,
                    cardinalities=[len(pool)]))
                mine = [FleetApp(name=app, arch=app, load_rps=1.0,
                                 tokens_per_request=2.0)]
                controller = FleetController(
                    router, fleet, mine, placement=fleet.plan(mine),
                    tick_s=FLEET_TICK_S)
                trace = [Request(rid=f"{app}-{i:04d}", arch=app,
                                 prompt_len=8, max_gen=1,
                                 arrival_s=i * FLEET_TICK_S)
                         for i in range(FLEET_REQUESTS)]
                loop = ControlLoop(
                    router, trace, controller=controller,
                    injector=FaultInjector([Fault(
                        kind="kill", endpoint=victim, at_tick=FLEET_KILL,
                        until_tick=FLEET_REVIVE)]),
                    tick_s=FLEET_TICK_S, max_ticks=50 * FLEET_REQUESTS)
                misses = lk.stats.misses
                out = loop.run()
                tracer.clear_time()
            require(lk.stats.misses == misses, f"{app}: the control loop "
                    f"added entries to the lookup")
            return out, router, controller, trace, tracer

        for app in PLANNER_APPS:
            first = Router(endpoints(app, 8), copy_verdicts(
                lookup, backends, [app]), policy="modeled").route(
                Request(rid="probe", arch=app, prompt_len=8, max_gen=1))
            require(first.accepted, f"{app}: no destination to kill")
            victim = first.endpoint.name
            out, router, controller, trace, tracer = chaos(app, victim)
            again = chaos(app, victim)[4]
            text = "".join(obs.jsonl_line(r) + "\n" for r in tracer.records)
            require(text == "".join(obs.jsonl_line(r) + "\n"
                                    for r in again.records),
                    f"{app}: two runs of the kill scenario gave different "
                    f"JSONL")
            require(not out["dropped"] and out["double_completed"] == 0
                    and out["completed"] == FLEET_REQUESTS
                    and out["unrouted"] == 0,
                    f"{app}: the kill scenario lost requests: {out}")
            health = router.health[victim]
            seq = [(t["from"], t["to"]) for t in health.transitions]
            require(seq and seq[0] == (HEALTHY, QUARANTINED)
                    and seq[-1] == (PROBING, HEALTHY)
                    and health.recoveries >= 1,
                    f"{app}: the circuit of {victim} did not open and "
                    f"recover: {seq}")
            replans = [e for e in controller.events
                       if e["event"] == "replan"]
            for e in replans:
                require(all(usable(lookup, b, a)
                            for a, b in e["by_app"].items()),
                        f"{app}: a replan onto a failure verdict: {e}")
                require(e["fleet_draw_w"] >= 0.0, f"{app}: negative draw")
            require(out["fleet_draw_w_min"] >= 0.0,
                    f"{app}: the fleet draw went negative")
            opened = [t["tick"] for t in health.transitions
                      if t["to"] == QUARANTINED]
            recovered = [t["tick"] for t in health.transitions
                         if t["to"] == HEALTHY]

            def joules(rids) -> str:
                ms = [router.metrics.requests[r] for r in rids]
                ms = [m for m in ms if m.service_s is not None]
                return f"{sum(m.energy_j for m in ms) / len(ms):.6g}" \
                    if ms else "none"

            j_pre = joules([r.rid for r in trace
                            if r.arrival_s < FLEET_KILL * FLEET_TICK_S])
            j_post = joules([r.rid for r in trace
                             if r.arrival_s > recovered[-1] * FLEET_TICK_S])
            events = os.path.join(tmp, f"chaos_{app}.jsonl")
            obs.write_jsonl(tracer.records, events)
            obs.write_chrome_trace(tracer.records,
                                   os.path.join(tmp, f"chaos_{app}.json"))
            report = subprocess.run(
                [sys.executable, "-m", "repro_torch.obs.report", events],
                capture_output=True, text=True, timeout=120,
                env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
            require(report.returncode == 0, f"{app}: the report CLI exited "
                    f"{report.returncode}: {report.stderr[-2000:]}")
            print(f"  {app}: killed {victim} at tick {FLEET_KILL}, revived "
                  f"at {FLEET_REVIVE}: circuit opened at tick {opened[0]}, "
                  f"recovered at {recovered[-1]} ({recovered[-1] - opened[0]} "
                  f"ticks, {len(opened)} quarantines); {out['completed']} "
                  f"completed, {out['failed']} failed attempts, 0 dropped, "
                  f"{len(replans)} replans "
                  f"{[e['by_app'][app] for e in replans]}; joules a request "
                  f"{j_pre} before the kill, {j_post} after "
                  f"recovery; {len(tracer.records)} trace records, report "
                  f"{len(report.stdout.splitlines())} lines")


def watched_lm(cfg, seed: int, plan=None, params=None):
    """The port's LM on the card from seeded random weights (or from
    ``params``), noting on the card whether any logit it returns is NaN
    (``lm.nan``) and counting the decode steps it runs from Python
    (``lm.eager_steps``: a replayed graph runs its step without Python).
    Under an MoE it counts routed and dropped pairs (``lm.drops``,
    ``LM.count_moe_drops``) and keeps each prefill length's
    (``lm.prefill_drops``: length -> [pairs, dropped, experts
    routed to])."""
    from repro_torch.models.lm import LM, init_params

    class WatchedLM(LM):
        def prefill(self, batch, cache_len):
            before = None if self.drops is None else self.drops[0].tolist()
            logits, cache = super().prefill(batch, cache_len)
            self.nan |= torch.isnan(logits).any()
            if before is not None:
                got = self.prefill_drops.setdefault(
                    torch.as_tensor(batch["tokens"]).shape[1], [0, 0, 0])
                for i, (a, b) in enumerate(zip(before,
                                               self.drops[0].tolist())):
                    got[i] += b - a
            return logits, cache

        def decode_step(self, cache, tokens, pos, **kw):
            self.eager_steps += 1
            logits, cache = super().decode_step(cache, tokens, pos, **kw)
            self.nan |= torch.isnan(logits).any()
            return logits, cache

    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, gen, "cuda")
    lm = WatchedLM(cfg, params, plan)
    lm.nan = torch.zeros((), dtype=torch.bool, device="cuda")
    lm.eager_steps = 0
    lm.drops = lm.count_moe_drops() if cfg.moe is not None else None
    lm.prefill_drops = {}
    return lm


def serve_trace(cfg, gens, seed: int, prompts=SERVE_PROMPTS):
    """Staggered requests, one arrival per tick, prompt lengths taken in
    turn from ``prompts``, tokens drawn from ``seed``; a VLM or audio
    request carries its own context, drawn from ``(seed, i)``
    (``launch.serve.request_extras``)."""
    from repro_torch.launch.serve import request_extras
    from repro_torch.serve import Request
    from repro_torch.serve.batching import DEFAULT_TICK_S
    rng = np.random.default_rng(seed)
    reqs = []
    for i, g in enumerate(gens):
        n = prompts[i % len(prompts)]
        reqs.append(Request(
            rid=f"r{i}", arch=cfg.name, prompt_len=n, max_gen=g,
            tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            arrival_s=i * DEFAULT_TICK_S,
            extras=request_extras(cfg, seed, i)))
    return reqs


def request_batch(r) -> dict:
    """A request's batch-1 prefill input: its tokens and its context."""
    return {"tokens": torch.from_numpy(r.tokens[None]), **r.extras}


def smoke_batcher(lm, cache_len: int, *, eager: bool = False,
                  record: bool = False):
    """The port's ContinuousBatcher over ``lm`` (its decode step captured
    in a CUDA graph and replayed each tick); ``eager`` skips the capture,
    so the step runs from Python as before the graph (the comparison this
    script makes; the port has no such switch); ``record`` keeps each
    step's logits (``engine.logits``)."""
    from repro_torch.power import envelope_for
    from repro_torch.serve import ContinuousBatcher

    class SmokeBatcher(ContinuousBatcher):
        def _capture_step(self):
            if not eager:
                super()._capture_step()

        def _step(self):
            logits = super()._step()
            if record:
                self.logits.append(logits.clone())
            return logits

    engine = SmokeBatcher(lm, n_slots=SERVE_SLOTS, cache_len=cache_len,
                          envelope=envelope_for(None))
    engine.logits = []
    require((engine.graph is None) == eager,
            "the engine on the card did not capture its decode step")
    return engine


def attention_launches(lm):
    """(flash launches a prefill, decode launches a step) of the LM: one
    each per self-attention layer (the hybrid's local attention blocks;
    none in the SSM) and per cross layer, and a flash launch per audio
    encoder layer; no decode launch of a self-attention layer under the
    int8 cache, whose decode attention is plain torch."""
    from repro_torch.models.lm import CrossBlock, DenseBlock
    dense = sum(isinstance(blk, DenseBlock) for blk in lm.layers)
    cross = sum(isinstance(blk, CrossBlock) for blk in lm.layers)
    encoder = len(getattr(lm, "enc_blocks", ()))
    return (dense + cross + encoder,
            (0 if lm.plan.kv_cache_quant else dense) + cross)


def check_engine_run(engine, lm, reqs, out, launches, label: str):
    """Every request complete, no NaN logit, flash once per attention layer
    (self, cross and encoder) and prefill, decode once per self and cross
    layer and step (none for a self layer under the int8 cache, whose
    decode attention is plain torch), no planner kernel, and no step run
    from Python where the graph replays."""
    per_prefill, per_step = attention_launches(lm)
    print(f"  ({label}) engine calls {engine.calls}, kernel launches "
          f"{launches}, decode steps run from Python {lm.eager_steps}")
    require(engine.calls["prefill"] == len(reqs), f"({label}) prefills")
    require(launches["flash_attention"] == per_prefill * len(reqs),
            f"({label}) flash_attention launches != layers x prefills")
    require(launches["decode_attention"]
            == per_step * engine.calls["decode_step"],
            f"({label}) decode_attention launches != layers x decode steps")
    require(launches["matmul"] == launches["tdfir"] == 0,
            f"({label}) the serve path launched a planner kernel")
    if engine.graph is not None:
        require(lm.eager_steps == 0, f"({label}) the engine ran a decode "
                f"step from Python instead of replaying its graph")
    for r in reqs:
        require(len(out[r.rid]) == r.max_gen,
                f"({label}) {r.rid}: {len(out[r.rid])} of {r.max_gen} "
                f"tokens")
    require(not bool(lm.nan), f"({label}) a logit was NaN")


def serve_engine(ops, lm, reqs, label: str, *, eager: bool = False,
                 record: bool = False, cache_len: int = SERVE_CACHE_LEN):
    """One engine run with the launch counters set to 0 just before and
    read just after; returns (engine, tokens, wall seconds, launches)."""
    engine = smoke_batcher(lm, cache_len, eager=eager, record=record)
    torch.cuda.synchronize()
    engine.allocated = torch.cuda.memory_allocated()
    lm.eager_steps = 0
    if lm.drops is not None:      # the capture's warm-up step routed too
        lm.drops.zero_()
        lm.prefill_drops.clear()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_engine_run(engine, lm, reqs, out, launches, label)
    return engine, out, wall, launches


def engine_idle_share(lm, reqs, cache_len: int, eager: bool):
    """The device's busy time over an engine run: a fresh engine's run
    without the profiler, then another's under torch.profiler (device
    activity only); returns (wall s of the unprofiled run, wall s of the
    traced one, which the profiler lengthens, device busy ms: the sum of the
    traced run's kernels, which run one at a time on one stream, and their
    count).  The pad of ``traced_kernels`` opens each trace; a trace that
    lost it is taken again with another fresh engine."""
    from torch.profiler import ProfilerActivity, profile
    engine = smoke_batcher(lm, cache_len, eager=eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    for attempt in range(TRACE_TRIES):
        engine = smoke_batcher(lm, cache_len, eager=eager)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_trace(attempt)
            t0 = time.perf_counter()
            engine.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        kept = [ms for name, ms in kernels if PAD_KERNEL not in name]
        if len(kept) < len(kernels):
            return plain_wall, wall, sum(kept), len(kept)
    raise SmokeFailure(f"{TRACE_TRIES} traces of an engine run lost their "
                       f"pad kernels")


def step_times(engine, lm, prompts, label: str, eager_too: bool = True,
               profile: bool = True):
    """A decode step over the engine's pool (each slot 32 tokens past a
    prompt), replayed from the graph and, where ``eager_too``, run eagerly:
    host-clock ms per step (20 steps, synchronised) and device ms per step
    from a profile (without ``profile``: CUDA-event ms per step over 50,
    the stream's time, which for a graph replay is its kernels' and the
    gaps between them; late in a process a profiler trace can lose its pad
    kernels, ``traced_kernels``); returns the replay's (wall, device) ms."""
    engine._last_tok[:] = 0
    engine._pos[:] = [prompts[i % len(prompts)] + 32
                      for i in range(SERVE_SLOTS)]
    toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.from_numpy(engine._pos.copy()).cuda()
    runs = [("graph replay", engine._step)]
    if eager_too:
        runs.append(("eager", lambda: lm.decode_step(
            engine.pool, toks, pos, route_per_row=True)))
    got = {}
    for what, fn in runs:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 20 * 1e3
        dev_ms = device_profile(fn, 5)[0] if profile else time_ms(fn, 50)
        got[what] = (wall_ms, dev_ms)
        print(f"  ({label}) decode step over {SERVE_SLOTS} slots, {what}: "
              f"{wall_ms:.3f} ms wall (host clock, synchronised), "
              f"{dev_ms:.3f} ms {'device' if profile else 'CUDA events'}")
    return got["graph replay"]


def reference_tokens(ops, lm, reqs, label: str,
                     cache_len: int = SERVE_CACHE_LEN):
    """Batch-1 ``generate`` per request (the sequential reference), each
    with its launches counted."""
    from repro_torch.launch.serve import generate
    out = {}
    per_prefill, per_step = attention_launches(lm)
    for r in reqs:
        ops.reset_launch_counts()
        toks = generate(lm, request_batch(r), r.prompt_len, r.max_gen,
                        cache_len)
        got = ops.launch_counts()
        require(got["flash_attention"] == per_prefill
                and got["decode_attention"] == per_step * (r.max_gen - 1),
                f"({label}) generate {r.rid}: launches {got}")
        out[r.rid] = toks[0].cpu().numpy()
    require(not bool(lm.nan), f"({label}) a generate logit was NaN")
    return out


def print_profile(what: str, wall_ms: float, fn, iters: int,
                  share_of: tuple = ()) -> None:
    """Where one call's time goes: device time against its host-clock
    wall time, the heaviest kernels, the heaviest host ops, and the share of
    the device time that kernels named ``share_of`` take."""
    dev_ms, kernels, host = device_profile(fn, iters)
    if dev_ms <= 0:
        print(f"  (b) {what}: the profiler saw no device time; device share "
              f"not measured")
        return
    print(f"  (b) {what}: {dev_ms:.3f} ms of device time per call, "
          f"{dev_ms / wall_ms:.1%} of its {wall_ms:.2f} ms wall time "
          f"(device idle {1 - dev_ms / wall_ms:.1%}); heaviest kernels, "
          f"ms per call:")
    for name, ms in kernels[:8]:
        print(f"      {ms:8.4f}  {name[:90]}")
    if share_of:
        mine = sum(ms for name, ms in kernels
                   if any(k in name for k in share_of))
        print(f"      {' + '.join(share_of)}: {mine:.4f} ms per call, "
              f"{mine / dev_ms:.1%}"
              f" of the device time")
    print("      heaviest host ops by self CPU time under the profiler, ms "
          "per call:")
    for name, ms in host:
        print(f"      {ms:8.4f}  {name[:90]}")


def pool_bytes(engine) -> int:
    from repro_torch.models.lm import slot_leaves
    return sum(t.nbytes for _, t, _ in slot_leaves(engine.pool))


def note_cell(cells: list, label: str, lm, plan, cache_len: int, prompts,
              before: int, engine, step_ms: float) -> None:
    """Note one bf16 serving cell for phase 12 (its config as built, plan,
    cache_len, prompts, the graph replay's decode-step seconds) and print
    what the card held for it: ``torch.cuda.memory_allocated`` before its
    weights were made and once its engine was built (weights, slot pool
    and the engine's buffers).  Reported only."""
    held = engine.allocated - before
    print(f"  ({label}) torch.cuda.memory_allocated: {before / 1e9:.3f} GB "
          f"before the model, {engine.allocated / 1e9:.3f} GB once the "
          f"engine was built: {held / 1e9:.3f} GB held (weights, pool, "
          f"buffers)")
    cells.append({"label": label, "cfg": lm.cfg, "plan": plan,
                  "cache_len": cache_len, "prompts": tuple(prompts),
                  "held": held, "step_s": step_ms / 1e3})


def run_serve(ops, cells: list):
    """Phase 6: the port's serving path on granite-3-2b at full width;
    returns (the launches of (b), (b)'s pool bytes) and notes (b) in
    ``cells`` (``note_cell``)."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)

    print(f" (a) {SERVE_ARCH} full width, 2 layers, float32: 8 staggered "
          f"requests, prompts {SERVE_PROMPTS}, max_gen {SERVE_GENS}, "
          f"{SERVE_SLOTS} slots, cache_len {SERVE_CACHE_LEN}; the decode "
          f"step replayed from a CUDA graph, beside an eager engine")
    cfg_a = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                param_dtype="float32")
    lm = watched_lm(cfg_a, seed=0)
    reqs = serve_trace(cfg_a, SERVE_GENS, seed=0)
    graph_engine, out, wall, _ = serve_engine(ops, lm, reqs, "a",
                                              record=True)
    eager_engine, out_e, wall_e, _ = serve_engine(
        ops, lm, reqs, "a, eager", eager=True, record=True)
    require(len(graph_engine.logits) == len(eager_engine.logits),
            "(a) the graph and eager engines ran different step counts")
    step_err = max(max_abs_err(g, e) for g, e in zip(graph_engine.logits,
                                                     eager_engine.logits))
    print(f"  (a) {len(graph_engine.logits)} steps: graph-replayed logits "
          f"within {step_err:.3e} of the eager engine's (limit 1e-5); wall "
          f"{wall:.2f} s (graph) against {wall_e:.2f} s (eager)")
    require(step_err <= 1e-5, "(a) graph-replayed logits differ from the "
            "eager engine's by more than 1e-5")
    want = reference_tokens(ops, lm, reqs, "a")
    same = [np.array_equal(out[r.rid], want[r.rid]) for r in reqs]
    print(f"  (a) tokens identical to batch-1 generate for {sum(same)}/"
          f"{len(reqs)} requests (graph engine)")
    require(all(same), "(a) engine tokens differ from batch-1 generate")
    del lm, graph_engine, eager_engine
    free_card()

    cfg, cut = cut_depth(cfg, SERVE_LAYERS, "cut to pay for phases 18 and "
                         "19; phase 18 (b) serves all 40")
    print(f" (b) {SERVE_ARCH} full width, {cut}, bfloat16: the same trace "
          f"shape, max_gen {SERVE_MAX_GEN}; the graph-replayed engine beside "
          f"an eager one")
    before = torch.cuda.memory_allocated()
    lm = watched_lm(cfg, seed=1)
    reqs = serve_trace(cfg, (SERVE_MAX_GEN,) * len(SERVE_GENS), seed=1)
    engine, out, wall, launches = serve_engine(ops, lm, reqs, "b")
    _, out_e, wall_e, _ = serve_engine(ops, lm, reqs, "b, eager",
                                       eager=True)
    summary = engine.metrics.summary()
    n_tok = sum(len(t) for t in out.values())
    for what, w in (("graph", wall), ("eager", wall_e)):
        print(f"  (b) {what}: wall {w:.2f} s, {n_tok} tokens, "
              f"{n_tok / w:.1f} generated tokens per wall second")
    print(f"  (b) {engine.calls['decode_step']} decode steps; tick clock: "
          f"ttft p50 {summary['ttft_p50_s']} s, p95 {summary['ttft_p95_s']} "
          f"s, tpot mean {summary['tpot_mean_s']} s")
    for what, eager in (("graph", False), ("eager", True)):
        w, t, busy, n = engine_idle_share(lm, reqs, SERVE_CACHE_LEN, eager)
        print(f"  (b) {what} engine: {busy / 1e3:.3f} s of device time in "
              f"{n} kernels (a profiled run); device idle "
              f"{1 - busy / (w * 1e3):.1%} of an unprofiled run's {w:.2f} s "
              f"wall ({1 - busy / (t * 1e3):.1%} of the profiled run's "
              f"{t:.2f} s)")

    for r in reqs[:len(SERVE_PROMPTS)]:
        batch = {"tokens": torch.from_numpy(r.tokens[None])}
        lm.prefill(batch, SERVE_CACHE_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            lm.prefill(batch, SERVE_CACHE_LEN)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"  (b) prefill of {r.prompt_len} tokens: {prefill_ms:.2f} ms "
              f"(host clock, synchronised)")
        print_profile(f"prefill of {r.prompt_len} tokens", prefill_ms,
                      lambda: lm.prefill(batch, SERVE_CACHE_LEN), 3)
    step_wall, _ = step_times(engine, lm, SERVE_PROMPTS, "b")
    note_cell(cells, "b", lm, None, SERVE_CACHE_LEN, SERVE_PROMPTS, before,
              engine, step_wall)
    print_profile("decode step (graph replay)", step_wall, engine._step, 5,
                  share_of=DECODE_KERNELS)

    want = reference_tokens(ops, lm, reqs, "b")
    agree = sum(int((out[r.rid] == want[r.rid]).sum()) for r in reqs)
    same_e = sum(int((out[r.rid] == out_e[r.rid]).sum()) for r in reqs)
    print(f"  (b) tokens that agree with batch-1 generate: {agree}/{n_tok} "
          f"({agree / n_tok:.1%}; bf16, reported only); with the eager "
          f"engine: {same_e}/{n_tok}")
    b_pool = pool_bytes(engine)
    del lm, engine
    free_card()
    return launches, b_pool


def free_card() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def run_family(ops, b_pool: int, cells: list):
    """Phase 7: the rest of the dense family in bf16 through the captured
    engine, 8 requests a cell (one arrival a tick, 4 slots, max_gen 64),
    each model freed before the next; returns the flash and decode
    launches summed over the cells and notes each in ``cells``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.plan import Plan
    total = {"flash_attention": 0, "decode_attention": 0}
    for label, arch, n_layers, prompts, cache_len, quant in FAMILY_CELLS:
        cfg, cut = cut_depth(get_config(arch), n_layers)
        seed = 1 if arch == SERVE_ARCH else 2
        before = torch.cuda.memory_allocated()
        lm = watched_lm(cfg, seed, Plan(kv_cache_quant=quant))
        print(f" ({label}) {arch}: full width (d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, D={cfg.head_dim}, "
              f"d_ff {cfg.d_ff} {cfg.ffn_act}, {cfg.norm}, window "
              f"{cfg.window if cfg.attn_kind == 'swa' else 0}), {cut}, "
              f"bfloat16, {weights(lm)}"
              f"{', int8 KV cache' if quant else ''}; prompts {prompts}, "
              f"cache_len {cache_len}")
        reqs = serve_trace(cfg, (SERVE_MAX_GEN,) * len(SERVE_GENS), seed=1,
                           prompts=prompts)
        engine, out, wall, launches = serve_engine(ops, lm, reqs, label,
                                                   cache_len=cache_len)
        for k in total:
            total[k] += launches[k]
        n_tok = sum(len(t) for t in out.values())
        w = engine.pool["attn"]["k"].shape[2]
        print(f"  ({label}) wall {wall:.2f} s, {n_tok} tokens, "
              f"{n_tok / wall:.1f} generated tokens per wall second; pool "
              f"{pool_bytes(engine) / 1e9:.3f} GB, {w} slots a row")
        if cfg.attn_kind == "swa":
            require(w == min(cache_len, cfg.window) < max(prompts),
                    f"({label}) the pool is not a ring shorter than the "
                    f"longest prompt")
        step_wall, _ = step_times(engine, lm, prompts, label,
                                  eager_too=False)
        note_cell(cells, label, lm, Plan(kv_cache_quant=quant), cache_len,
                  prompts, before, engine, step_wall)
        if quant:
            check_int8_cell(lm, reqs[0], cache_len, label)
            print(f"  ({label}) pool {pool_bytes(engine) / 1e6:.1f} MB "
                  f"against {b_pool / 1e6:.1f} MB for (b)'s bf16 cache "
                  f"({pool_bytes(engine) / b_pool:.1%})")
        del lm, engine
        free_card()
    return total


def cut_depth(cfg, n_layers, why: str = "would not fit one card"):
    """``cfg`` with its first ``n_layers`` layers (None: all), and the cut
    as printed, with ``why``."""
    if n_layers is None:
        return cfg, f"all {cfg.n_layers} layers"
    return (dataclasses.replace(cfg, n_layers=n_layers),
            f"depth cut to {n_layers} of {cfg.n_layers} layers (all "
            f"{cfg.n_layers}, {cfg.n_params() * 2 / 1e9:.0f} GB of bf16, "
            f"{why})")


def weights(lm) -> str:
    """The LM's parameters as allocated (routed and shared experts, the
    router and the dense residual included), counted and in GB."""
    n = sum(t.numel() for t in lm.state_dict().values())
    nbytes = sum(t.nbytes for t in lm.state_dict().values())
    return f"{n / 1e9:.2f} B parameters ({nbytes / 1e9:.1f} GB)"


def check_int8_cell(lm, req, cache_len: int, label: str) -> None:
    """The int8 cache's first decode step against the exact cache's on the
    same weights: probabilities within 0.05 (the JAX package's bound,
    tests/test_lm_consistency.py:112)."""
    from repro_torch.models.lm import LM
    exact = LM(lm.cfg, dict(lm.state_dict()))
    batch = {"tokens": torch.from_numpy(req.tokens[None])}
    la, ca = exact.prefill(batch, cache_len)
    lq, cq = lm.prefill(batch, cache_len)
    tok = la.argmax(-1)[:, None]
    pa = exact.decode_step(ca, tok, req.prompt_len)[0].softmax(-1)
    pq = lm.decode_step(cq, tok, req.prompt_len)[0].softmax(-1)
    err = max_abs_err(pa, pq)
    print(f"  ({label}) first decode step, int8 against exact cache: "
          f"probabilities within {err:.3e} (limit 0.05)")
    require(err < 0.05, f"({label}) int8 probabilities differ from the "
            f"exact cache's by {err:.3e}")


# cuBLAS kernel names (a graph replay's GEMMs, the experts' bmm among them)
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")


def run_moe(ops, cells: list):
    """Phase 8: the MoE family through the captured engine, phase 7's trace
    (8 requests, one arrival a tick, 4 slots, max_gen 64, prompts 1000 and
    2048, cache_len 2112), each model freed before the next: (g') the
    parity cell, then (g) and (h) in bf16; returns the flash and decode
    launches summed over (g) and (h) and notes each in ``cells``."""
    from repro_torch.configs import get_config
    check_moe_parity(ops)
    total = {"flash_attention": 0, "decode_attention": 0}
    for label, arch, n_layers, why in MOE_CELLS:
        cfg, cut = cut_depth(get_config(arch), n_layers, why)
        m = cfg.moe
        before = torch.cuda.memory_allocated()
        lm = watched_lm(cfg, seed=2)
        print(f" ({label}) {arch}: full width (d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, D={cfg.head_dim}, "
              f"{m.n_experts} experts top-{m.top_k}, d_expert {m.d_expert} "
              f"{cfg.ffn_act}, {m.shared_experts} shared experts, dense "
              f"residual {m.dense_d_ff if m.dense_residual else 0}, capacity "
              f"factor {m.capacity_factor}), {cut}, bfloat16, {weights(lm)}; "
              f"prompts {SERVE_PROMPTS}, cache_len {SERVE_CACHE_LEN}")
        reqs = serve_trace(cfg, (SERVE_MAX_GEN,) * len(SERVE_GENS), seed=1)
        engine, out, wall, launches = serve_engine(ops, lm, reqs, label)
        for k in total:
            total[k] += launches[k]
        run_routed = check_moe_drops(lm, engine, label)
        n_tok = sum(len(t) for t in out.values())
        print(f"  ({label}) wall {wall:.2f} s, {n_tok} tokens, "
              f"{n_tok / wall:.1f} generated tokens per wall second; pool "
              f"{pool_bytes(engine) / 1e9:.3f} GB")
        step_wall, step_dev = step_times(engine, lm, SERVE_PROMPTS, label,
                                         eager_too=False)
        note_cell(cells, label, lm, None, SERVE_CACHE_LEN, SERVE_PROMPTS,
                  before, engine, step_wall)
        moe_step_bounds(lm, engine, step_dev, run_routed, label)
        w, t, busy, n = engine_idle_share(lm, reqs, SERVE_CACHE_LEN, False)
        print(f"  ({label}) graph engine: {busy / 1e3:.3f} s of device time "
              f"in {n} kernels (a profiled run); device idle "
              f"{1 - busy / (w * 1e3):.1%} of an unprofiled run's {w:.2f} s "
              f"wall ({1 - busy / (t * 1e3):.1%} of the profiled run's "
              f"{t:.2f} s)")
        moe_step_split(lm, engine, label)
        moe_drop_layers(lm, reqs[0], label)
        del lm, engine
        free_card()
    return total


def check_moe_drops(lm, engine, label: str) -> float:
    """Print the dropped share of (token, k) pairs at each prefill length;
    require every decode step's pairs routed, none dropped; returns the
    experts routed to in a mean decode step, summed over the layers."""
    from repro_torch.models import moe
    cfg = lm.cfg
    for n, (pairs, dropped, _) in sorted(lm.prefill_drops.items()):
        print(f"  ({label}) prefills of {n} tokens: {dropped} of {pairs} "
              f"(token, k) pairs dropped ({dropped / pairs:.4%}; capacity "
              f"{moe.capacity_of(cfg, n)} an expert)")
    pairs, dropped, routed = lm.drops[1].tolist()
    steps = engine.calls["decode_step"]
    want = cfg.n_layers * steps * SERVE_SLOTS * cfg.moe.top_k
    print(f"  ({label}) decode: {dropped} of {pairs} (token, k) pairs "
          f"dropped over {steps} steps (each slot its own group, capacity "
          f"{moe.capacity_of(cfg, 1)} an expert); "
          f"{routed / (cfg.n_layers * steps):.2f} of {cfg.moe.n_experts} "
          f"experts routed to a layer and step")
    require(pairs == want, f"({label}) {pairs} decode pairs routed, not "
            f"layers x steps x slots x k = {want}")
    require(dropped == 0, f"({label}) a decode step dropped {dropped} pairs")
    return routed / steps


def check_moe_parity(ops) -> None:
    """(g'): moonshot at full width, 2 layers in fp32, phase 6 (a)'s trace:
    no decode drop, the graph-replayed logits bitwise equal to an eager
    engine's, one state's step replayed twice for the same bits, and greedy
    tokens equal to batch-1 ``generate``'s (per-row and batch-1 routing
    coincide)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MOE_PARITY_ARCH), n_layers=2,
                              dtype="float32", param_dtype="float32")
    lm = watched_lm(cfg, seed=0)
    print(f" (g') {MOE_PARITY_ARCH} full width, 2 layers, float32, "
          f"{weights(lm)}: 8 staggered requests, prompts {SERVE_PROMPTS}, "
          f"max_gen {SERVE_GENS}, {SERVE_SLOTS} slots, cache_len "
          f"{SERVE_CACHE_LEN}; the graph engine beside an eager one")
    reqs = serve_trace(cfg, SERVE_GENS, seed=0)
    graph_engine, out, wall, _ = serve_engine(ops, lm, reqs, "g'",
                                              record=True)
    check_moe_drops(lm, graph_engine, "g'")
    eager_engine, _, wall_e, _ = serve_engine(ops, lm, reqs, "g', eager",
                                              eager=True, record=True)
    require(len(graph_engine.logits) == len(eager_engine.logits),
            "(g') the graph and eager engines ran different step counts")
    same = sum(torch.equal(g, e) for g, e in zip(graph_engine.logits,
                                                 eager_engine.logits))
    print(f"  (g') {same}/{len(graph_engine.logits)} steps' graph-replayed "
          f"logits bitwise equal to the eager engine's; wall {wall:.2f} s "
          f"(graph) against {wall_e:.2f} s (eager)")
    require(same == len(graph_engine.logits), "(g') graph-replayed logits "
            "differ from the eager engine's")
    start = {k: v.clone() for k, v in graph_engine.pool["attn"].items()}
    graph_engine._last_tok[:] = np.arange(SERVE_SLOTS) * 7
    graph_engine._pos[:] = [SERVE_PROMPTS[i % 2] + 32
                            for i in range(SERVE_SLOTS)]
    first = graph_engine._step().clone()
    for k, v in start.items():
        graph_engine.pool["attn"][k].copy_(v)
    require_same_bits("(g') one state's decode step replayed twice", first,
                      graph_engine._step(), "the MoE step is not "
                      "deterministic")
    want = reference_tokens(ops, lm, reqs, "g'")
    same = [np.array_equal(out[r.rid], want[r.rid]) for r in reqs]
    print(f"  (g') tokens identical to batch-1 generate for {sum(same)}/"
          f"{len(reqs)} requests (graph engine)")
    require(all(same), "(g') engine tokens differ from batch-1 generate")
    del lm, graph_engine, eager_engine
    free_card()


def moe_step_split(lm, engine, label: str) -> None:
    """Where a decode step's device time goes: a graph replay's kernels by
    name (decode attention, cuBLAS GEMMs, the rest: elementwise, sorts,
    gathers, scatters), and an eager step's kernels split by the
    ``record_function`` ranges of ``models.moe.apply_moe`` (routing and
    dispatch, the expert FFNs, the combine, the shared or dense FFN: the
    device time of the aten ops in each) and by name (decode attention,
    launched through ctypes, belongs to no aten op).  Fails where a range
    of the MoE gets no device time."""
    from torch.profiler import ProfilerActivity
    dev_ms, kernels, _ = device_profile(engine._step, 5)
    attn = sum(ms for n, ms in kernels if is_decode_kernel(n))
    gemm = sum(ms for n, ms in kernels
               if any(g in n for g in GEMM_NAMES) and not is_decode_kernel(n))
    rest = dev_ms - attn - gemm
    print(f"  ({label}) graph replay, {dev_ms:.3f} ms of device time: decode "
          f"attention {attn:.3f} ms ({attn / dev_ms:.1%}), cuBLAS GEMMs "
          f"{gemm:.3f} ({gemm / dev_ms:.1%}), the rest {rest:.3f} "
          f"({rest / dev_ms:.1%}); heaviest kernels:")
    for name, ms in kernels[:6]:
        print(f"      {ms:8.4f}  {name[:90]}")

    toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.from_numpy(engine._pos.copy()).cuda()

    def step():
        lm.decode_step(engine.pool, toks, pos, route_per_row=True)
    step()
    torch.cuda.synchronize()
    prof, traced = traced_kernels(step, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    m = lm.cfg.moe
    names = {"moe.route": "routing and dispatch",
             "moe.experts": "expert FFNs",
             "moe.combine": "combine"}
    if m.shared_experts:
        names["moe.shared"] = "shared experts"
    if m.dense_residual:
        names["moe.dense"] = "dense residual"
    # the ranges' own device-side spans are not kernels
    traced = [(n, ms) for n, ms in traced if not n.startswith("moe.")]
    total = sum(ms for _, ms in traced)
    attn = sum(ms for n, ms in traced if is_decode_kernel(n))
    ms = {tag: sum(e.device_time_total for e in prof.events()
                   if e.name == tag
                   and not str(e.device_type).endswith("CUDA")) / 1e3
          for tag in names}
    rest = total - sum(ms.values()) - attn
    parts = ", ".join(f"{what} {ms[tag]:.3f} ({ms[tag] / total:.1%})"
                      for tag, what in names.items())
    print(f"  ({label}) eager step, {len(traced)} kernels, {total:.3f} ms "
          f"of device time: {parts}, decode attention {attn:.3f} "
          f"({attn / total:.1%}), the rest (projections, norms, RoPE, cache "
          f"writes, unembedding) {rest:.3f} ({rest / total:.1%})")
    for tag, what in names.items():
        require(ms[tag] > 0, f"({label}) the profiler put no device time "
                f"under the {tag} range: the step's MoE split is not "
                f"measured")


def moe_step_bounds(lm, engine, step_dev: float, run_routed: float,
                    label: str) -> None:
    """The graph-replayed step's device time against two bounds at the
    state ``step_times`` timed: every weight read once (what the dispatch
    reads: all E experts a layer, the whole embedding table), and the
    bytes the step needs: the weights but the experts and the embedding
    table (whose four rows are left out), the cache up to each slot's
    position, and the experts routed to, ``run_routed`` a step (the serve
    run's mean, counted on the device) and, beside it, those of the timed
    state (every slot fed token 0), counted by one more replay."""
    cfg, m = lm.cfg, lm.cfg.moe
    state = lm.state_dict()
    nbytes = sum(t.nbytes for t in state.values())
    expert_bytes = sum(t.nbytes for k, t in state.items()
                       if ".ffn.experts." in k)
    embed = 0 if cfg.tie_embeddings else state["embed"].nbytes
    per_expert = expert_bytes // (cfg.n_layers * m.n_experts)
    lm.drops.zero_()
    engine._step()
    timed_routed = int(lm.drops[1, 2])
    k = engine.pool["attn"]["k"]
    keys = int(sum(int(p) + 1 for p in engine._pos))
    cache = keys * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim \
        * k.element_size()
    other = nbytes - expert_bytes - embed + cache
    t_all = nbytes / HBM_BYTES_PER_S * 1e3
    t_run, t_timed = ((other + n * per_expert) / HBM_BYTES_PER_S * 1e3
                      for n in (run_routed, timed_routed))
    print(f"  ({label}) decode step bound, all experts: every weight read "
          f"once (what the dispatch reads: all {m.n_experts} experts a "
          f"layer), {nbytes / 1e9:.1f} GB at 3.35 TB/s = {t_all:.2f} ms; "
          f"the step's device time is {step_dev / t_all:.2f}x that")
    print(f"  ({label}) decode step bound, routed: the weights but the "
          f"experts and the embedding table, and the cache up to each "
          f"slot's position ({keys} keys and values a layer, "
          f"{cache / 1e9:.2f} GB), {other / 1e9:.2f} GB, with the experts "
          f"routed to, {run_routed / cfg.n_layers:.2f} a layer in the serve "
          f"run's mean step ({run_routed * per_expert / 1e9:.2f} GB): "
          f"{t_run:.2f} ms, the step's device time {step_dev / t_run:.2f}x "
          f"that; at the timed state, {timed_routed / cfg.n_layers:.2f} a "
          f"layer ({timed_routed * per_expert / 1e9:.2f} GB): "
          f"{t_timed:.2f} ms, {step_dev / t_timed:.2f}x")
    most = cfg.n_layers * min(m.n_experts, SERVE_SLOTS * m.top_k)
    require(0 < timed_routed <= most and 0 < run_routed <= most,
            f"({label}) {timed_routed} and {run_routed} experts routed to in "
            f"one step")


def moe_drop_layers(lm, req, label: str) -> None:
    """Why a prefill drops: one prefill of ``req`` with each layer's router
    input kept (a ``TorchFunctionMode`` that notes the matmuls whose second
    operand is a router), then per layer the dropped share of its pairs as
    the model routes them (logits in the activation dtype), the share with
    the same inputs routed on fp32 logits, the share of tokens whose k-th
    and (k+1)-th logits tie (the stable sort gives such ties to the lower
    expert id), and the tokens' mean cosine to their mean (how alike the
    layer's inputs are)."""
    from torch.overrides import TorchFunctionMode

    from repro_torch.models import moe
    routers = {id(blk.ffn.router): i for i, blk in enumerate(lm.blocks)}
    seen = {}

    class KeepRouterInputs(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.matmul and id(args[1]) in routers:
                seen[routers[id(args[1])]] = (args[0], args[1])
            return func(*args, **(kwargs or {}))

    with KeepRouterInputs():
        lm.prefill({"tokens": torch.from_numpy(req.tokens[None])},
                   SERVE_CACHE_LEN)
    require(len(seen) == lm.cfg.n_layers, f"({label}) {len(seen)} router "
            f"inputs kept of {lm.cfg.n_layers} layers")
    cfg, k = lm.cfg, lm.cfg.moe.top_k
    cap = moe.capacity_of(cfg, req.prompt_len)
    print(f"  ({label}) one prefill of {req.prompt_len} tokens, per layer: "
          f"dropped share as routed (bf16 logits) / on fp32 logits of the "
          f"same inputs, tokens with a tie at the k-th logit (bf16 / fp32), "
          f"the inputs' mean cosine to their mean")
    rows = []
    for i in range(cfg.n_layers):
        tokens, router = seen[i]
        r16 = moe.route(router, cfg, tokens, cap)
        r32 = moe.route(router.float(), cfg, tokens.float(), cap)
        ties = []
        for r in (r16, r32):
            top = torch.sort(r.logits, dim=-1, descending=True).values
            ties.append(float((top[..., k - 1] == top[..., k]).float()
                              .mean()))
        x = tokens.float().reshape(-1, cfg.d_model)
        cos = float(torch.nn.functional.cosine_similarity(
            x, x.mean(0, keepdim=True)).mean())
        rows.append((float((~r16.keep).float().mean()),
                     float((~r32.keep).float().mean()), *ties, cos))
        print(f"    layer {i:2d}: dropped {rows[-1][0]:7.2%} / "
              f"{rows[-1][1]:7.2%}; ties {ties[0]:6.2%} / {ties[1]:6.2%}; "
              f"cosine {cos:.3f}")
    n = max(1, cfg.n_layers // 4)
    first = [sum(col) / n for col in zip(*rows[:n])]
    last = [sum(col) / n for col in zip(*rows[-n:])]
    print(f"  ({label}) first {n} layers against the last {n}: dropped "
          f"{first[0]:.2%} / {last[0]:.2%} (fp32 logits {first[1]:.2%} / "
          f"{last[1]:.2%}), ties {first[2]:.2%} / {last[2]:.2%}, cosine "
          f"{first[4]:.3f} / {last[4]:.3f}")


def run_recurrent(ops, cells: list):
    """Phase 9: the recurrent families through the captured engine, 8
    requests a cell (one arrival a tick, 4 slots, max_gen 64 in bf16,
    phase 6 (a)'s mixed max_gen in fp32), each model freed before the next:
    the parity cell of each family, then the model in bf16 at the depth
    RECURRENT_CELLS keeps; returns
    the flash and decode launches summed over (i) and (j) and notes each
    in ``cells``."""
    from repro_torch.configs import get_config
    total = {"flash_attention": 0, "decode_attention": 0}
    for label, arch, n_layers, prompts, cache_len in RECURRENT_CELLS:
        check_parity(ops, label, arch, prompts, cache_len)
        cfg, depth = cut_depth(get_config(arch), n_layers,
                               "cut to pay for phases 16, 18 and 19")
        before = torch.cuda.memory_allocated()
        lm = watched_lm(cfg, seed=2)
        print(f" ({label}) {arch}: full width ({describe(cfg)}), {depth}, "
              f"bfloat16, {weights(lm)}; prompts {prompts}, cache_len "
              f"{cache_len}")
        reqs = serve_trace(cfg, (SERVE_MAX_GEN,) * len(SERVE_GENS), seed=1,
                           prompts=prompts)
        engine, out, wall, launches = serve_engine(ops, lm, reqs, label,
                                                   cache_len=cache_len)
        for k in total:
            total[k] += launches[k]
        n_attn = attention_launches(lm)[0]
        want_attn = n_attn * len(reqs)
        print(f"  ({label}) {n_attn} attention layers: "
              f"{launches['flash_attention']} flash launches over "
              f"{len(reqs)} prefills (want {want_attn}), "
              f"{launches['decode_attention']} decode launches over "
              f"{engine.calls['decode_step']} graph replays")
        n_tok = sum(len(t) for t in out.values())
        print(f"  ({label}) wall {wall:.2f} s, {n_tok} tokens, "
              f"{n_tok / wall:.1f} generated tokens per wall second; pool "
              f"{pool_bytes(engine) / 1e9:.3f} GB")
        if cfg.family == "hybrid":
            ring = engine.pool["groups"]["b2"]["k"].shape[2]
            require(ring == min(cache_len, cfg.window) < max(prompts),
                    f"({label}) the local attention's pool is not a ring "
                    f"shorter than the longest prompt")
        step_wall, step_dev = step_times(engine, lm, prompts, label,
                                         eager_too=False)
        note_cell(cells, label, lm, None, cache_len, prompts, before,
                  engine, step_wall)
        recurrent_step_bound(lm, engine, step_dev, label)
        w, t, busy, n = engine_idle_share(lm, reqs, cache_len, False)
        print(f"  ({label}) graph engine: {busy / 1e3:.3f} s of device time "
              f"in {n} kernels (a profiled run); device idle "
              f"{1 - busy / (w * 1e3):.1%} of an unprofiled run's {w:.2f} s "
              f"wall ({1 - busy / (t * 1e3):.1%} of the profiled run's "
              f"{t:.2f} s)")
        for r in reqs[:len(prompts)]:
            batch = {"tokens": torch.from_numpy(r.tokens[None])}
            lm.prefill(batch, cache_len)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                lm.prefill(batch, cache_len)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
            dev_ms = device_profile(lambda: lm.prefill(batch, cache_len),
                                    2)[0]
            print(f"  ({label}) prefill of {r.prompt_len} tokens: "
                  f"{prefill_ms:.2f} ms wall (host clock, synchronised), "
                  f"{dev_ms:.2f} ms device")
        recurrent_step_split(lm, engine, label)
        del lm, engine
        free_card()
    return total


def describe(cfg) -> str:
    """The widths of an SSM, hybrid, VLM or audio config, as printed."""
    heads = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads, D={cfg.head_dim}, "
             f"d_ff {cfg.d_ff} {cfg.ffn_act}, {cfg.norm}")
    if cfg.family == "vlm":
        groups, per = cfg.n_layers // (cfg.cross_attn_every + 1), \
            cfg.cross_attn_every
        return (f"d_model {cfg.d_model}, {heads}; {groups} group(s) of "
                f"{per} self and 1 cross layer over {cfg.n_img_tokens} image "
                f"tokens")
    if cfg.family == "audio":
        return (f"d_model {cfg.d_model}, {heads}, biases; "
                f"{cfg.encoder_layers} encoder layers over {cfg.n_frames} "
                f"frames, {cfg.n_layers} decoder layers of self and cross "
                f"attention")
    if cfg.family == "ssm":
        m = cfg.ssm
        return (f"d_model {cfg.d_model}, d_inner {m.d_inner(cfg.d_model)}, "
                f"{m.n_heads(cfg.d_model)} SSD heads of {m.headdim}, d_state "
                f"{m.d_state}, chunk {m.chunk}")
    return (f"d_model {cfg.d_model}, LRU width {cfg.hybrid.lru_width}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, D={cfg.head_dim}, "
            f"window {cfg.window}, d_ff {cfg.d_ff} {cfg.ffn_act}, pattern "
            f"{'/'.join(cfg.hybrid.pattern)}")


def check_parity(ops, label, arch, prompts, cache_len) -> None:
    """(i'), (j'), (k') and (l'): the family at full width and a few layers
    (``PARITY_LAYERS``; None: all) in fp32, phase 6 (a)'s mixed max_gen:
    the graph-replayed logits within 1e-5 of an eager engine's, one
    state's step replayed twice for the same bits, and greedy tokens equal
    to batch-1 ``generate``'s."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import slot_leaves
    full = get_config(arch)
    n_layers = PARITY_LAYERS[label] or full.n_layers
    cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32",
                              param_dtype="float32")
    lm = watched_lm(cfg, seed=0)
    tag = f"{label}'"
    print(f" ({tag}) {arch} full width ({describe(cfg)}), {n_layers} of "
          f"{full.n_layers} layers, float32, {weights(lm)}: 8 "
          f"staggered requests, prompts {prompts}, max_gen {SERVE_GENS}, "
          f"{SERVE_SLOTS} slots, cache_len {cache_len}; the graph engine "
          f"beside an eager one")
    reqs = serve_trace(cfg, SERVE_GENS, seed=0, prompts=prompts)
    graph_engine, out, wall, _ = serve_engine(ops, lm, reqs, tag,
                                              record=True,
                                              cache_len=cache_len)
    eager_engine, _, wall_e, _ = serve_engine(
        ops, lm, reqs, f"{tag}, eager", eager=True, record=True,
        cache_len=cache_len)
    require(len(graph_engine.logits) == len(eager_engine.logits),
            f"({tag}) the graph and eager engines ran different step counts")
    step_err = max(max_abs_err(g, e) for g, e in zip(graph_engine.logits,
                                                     eager_engine.logits))
    print(f"  ({tag}) {len(graph_engine.logits)} steps: graph-replayed "
          f"logits within {step_err:.3e} of the eager engine's (limit 1e-5);"
          f" wall {wall:.2f} s (graph) against {wall_e:.2f} s (eager)")
    require(step_err <= 1e-5, f"({tag}) graph-replayed logits differ from "
            f"the eager engine's by more than 1e-5")
    start = [buf.clone() for _, buf, _ in slot_leaves(graph_engine.pool)]
    graph_engine._last_tok[:] = np.arange(SERVE_SLOTS) * 7
    graph_engine._pos[:] = [prompts[i % 2] + 32 for i in range(SERVE_SLOTS)]
    first = graph_engine._step().clone()
    for (_, buf, _), s0 in zip(slot_leaves(graph_engine.pool), start):
        buf.copy_(s0)
    require_same_bits(f"({tag}) one state's decode step replayed twice",
                      first, graph_engine._step(), "the captured step is "
                      "not deterministic")
    want = reference_tokens(ops, lm, reqs, tag, cache_len)
    same = [np.array_equal(out[r.rid], want[r.rid]) for r in reqs]
    print(f"  ({tag}) tokens identical to batch-1 generate for {sum(same)}/"
          f"{len(reqs)} requests (graph engine)")
    require(all(same), f"({tag}) engine tokens differ from batch-1 generate")
    del lm, graph_engine, eager_engine
    free_card()


def recurrent_step_bound(lm, engine, step_dev: float, label: str) -> None:
    """The graph-replayed step's device time against the bytes it must
    move at the state ``step_times`` timed: every weight read once (the
    tied embedding table is read whole as the unembedding), the recurrent
    state (conv windows, SSD states, RG-LRU h) read and written once, and
    the local attention's rings read up to each slot's length."""
    from repro_torch.models.lm import layer_caches
    nbytes = sum(t.nbytes for t in lm.state_dict().values())
    state = ring = 0
    for layer in layer_caches(lm.cfg, engine.pool):
        for name, buf in layer.items():
            if name in ("k", "v"):      # a ring [B, W, KV, D]
                w = buf.shape[1]
                rows = sum(min(int(p) + 1, w) for p in engine._pos)
                ring += buf[0, 0].nbytes * rows
            else:
                state += 2 * buf.nbytes
    t_bound = (nbytes + state + ring) / HBM_BYTES_PER_S * 1e3
    print(f"  ({label}) decode step bound: the weights read once "
          f"({nbytes / 1e9:.2f} GB), the recurrent state read and written "
          f"once ({state / 1e9:.3f} GB), the rings' valid rows read "
          f"({ring / 1e9:.3f} GB) at 3.35 TB/s = {t_bound:.3f} ms; the "
          f"step's device time is {step_dev / t_bound:.2f}x that")


def recurrent_step_split(lm, engine, label: str) -> None:
    """Where a decode step's device time goes: a graph replay's kernels by
    name (decode attention, cuBLAS GEMMs, the rest), and an eager step's
    split into decode attention and GEMMs (by kernel name), the scan and
    state updates (the ``ssm.state`` / ``rglru.state`` ranges of
    ``models/ssm.py`` and ``models/rglru.py``: the conv, the gates'
    elementwise math, the state update and readout; no GEMM runs there) and
    the rest (norms, RoPE, the FFNs' activations, cache writes, the
    unembedding's mask).  Fails where the ranges get no device time."""
    from torch.profiler import ProfilerActivity
    dev_ms, kernels, _ = device_profile(engine._step, 5)
    attn = sum(ms for n, ms in kernels if is_decode_kernel(n))
    gemm = sum(ms for n, ms in kernels
               if any(g in n for g in GEMM_NAMES) and not is_decode_kernel(n))
    rest = dev_ms - attn - gemm
    print(f"  ({label}) graph replay, {dev_ms:.3f} ms of device time: decode "
          f"attention {attn:.3f} ms ({attn / dev_ms:.1%}), cuBLAS GEMMs "
          f"{gemm:.3f} ({gemm / dev_ms:.1%}), the rest {rest:.3f} "
          f"({rest / dev_ms:.1%}); heaviest kernels:")
    for name, ms in kernels[:6]:
        print(f"      {ms:8.4f}  {name[:90]}")
    toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.from_numpy(engine._pos.copy()).cuda()

    def step():
        lm.decode_step(engine.pool, toks, pos)
    step()
    torch.cuda.synchronize()
    prof, traced = traced_kernels(step, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    tag = "ssm.state" if lm.cfg.family == "ssm" else "rglru.state"
    traced = [(n, ms) for n, ms in traced if n != tag]
    total = sum(ms for _, ms in traced)
    attn = sum(ms for n, ms in traced if is_decode_kernel(n))
    gemm = sum(ms for n, ms in traced
               if any(g in n for g in GEMM_NAMES) and not is_decode_kernel(n))
    state = sum(e.device_time_total for e in prof.events()
                if e.name == tag
                and not str(e.device_type).endswith("CUDA")) / 1e3
    rest = total - attn - gemm - state
    print(f"  ({label}) eager step, {len(traced)} kernels, {total:.3f} ms of "
          f"device time: decode attention {attn:.3f} ({attn / total:.1%}), "
          f"GEMMs {gemm:.3f} ({gemm / total:.1%}), scan and state updates "
          f"({tag}) {state:.3f} ({state / total:.1%}), the rest {rest:.3f} "
          f"({rest / total:.1%})")
    require(state > 0, f"({label}) the profiler put no device time under "
            f"the {tag} range: the step's split is not measured")


def run_cross(ops, cells: list):
    """Phase 10: the cross-attention families through the captured engine,
    phase 7's trace (8 requests, one arrival a tick, 4 slots, prompts 1000
    and 2048, cache_len 2112, max_gen 64; each request with its own
    seeded context), each model freed before the next: the parity cell of
    each family (phase 6 (a)'s checks), then the model in bf16 with phase
    9's metrics; returns the flash and decode launches summed over (k) and
    (l) and notes each in ``cells``."""
    from repro_torch.configs import get_config
    total = {"flash_attention": 0, "decode_attention": 0}
    for label, arch, n_layers, per_prefill, per_step in CROSS_CELLS:
        check_parity(ops, label, arch, SERVE_PROMPTS, SERVE_CACHE_LEN)
        cfg, cut = cut_depth(get_config(arch), n_layers)
        before = torch.cuda.memory_allocated()
        lm = watched_lm(cfg, seed=2)
        print(f" ({label}) {arch}: full width ({describe(cfg)}), {cut}, "
              f"bfloat16, {weights(lm)}; prompts {SERVE_PROMPTS}, cache_len "
              f"{SERVE_CACHE_LEN}")
        require(attention_launches(lm) == (per_prefill, per_step),
                f"({label}) the model has {attention_launches(lm)} attention "
                f"launches a prefill and a step, not "
                f"{(per_prefill, per_step)}")
        reqs = serve_trace(cfg, (SERVE_MAX_GEN,) * len(SERVE_GENS), seed=1)
        engine, out, wall, launches = serve_engine(ops, lm, reqs, label)
        for k in total:
            total[k] += launches[k]
        print(f"  ({label}) {launches['flash_attention']} flash launches over "
              f"{len(reqs)} prefills ({per_prefill} a prefill), "
              f"{launches['decode_attention']} decode launches over "
              f"{engine.calls['decode_step']} graph replays ({per_step} a "
              f"step)")
        n_tok = sum(len(t) for t in out.values())
        cross_b = sum(t.nbytes for t in engine.pool["cross"].values())
        print(f"  ({label}) wall {wall:.2f} s, {n_tok} tokens, "
              f"{n_tok / wall:.1f} generated tokens per wall second; pool "
              f"{pool_bytes(engine) / 1e9:.3f} GB (cross K/V "
              f"{cross_b / 1e9:.3f} GB)")
        step_wall, step_dev = step_times(engine, lm, SERVE_PROMPTS, label,
                                         eager_too=False)
        note_cell(cells, label, lm, None, SERVE_CACHE_LEN, SERVE_PROMPTS,
                  before, engine, step_wall)
        cross_step_bound(lm, engine, step_dev, label)
        w, t, busy, n = engine_idle_share(lm, reqs, SERVE_CACHE_LEN, False)
        print(f"  ({label}) graph engine: {busy / 1e3:.3f} s of device time "
              f"in {n} kernels (a profiled run); device idle "
              f"{1 - busy / (w * 1e3):.1%} of an unprofiled run's {w:.2f} s "
              f"wall ({1 - busy / (t * 1e3):.1%} of the profiled run's "
              f"{t:.2f} s)")
        for r in reqs[:len(SERVE_PROMPTS)]:
            batch = request_batch(r)
            lm.prefill(batch, SERVE_CACHE_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                lm.prefill(batch, SERVE_CACHE_LEN)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
            print(f"  ({label}) prefill of {r.prompt_len} tokens: "
                  f"{prefill_ms:.2f} ms wall (host clock, synchronised)")
            range_split(lm, lambda: lm.prefill(batch, SERVE_CACHE_LEN),
                        f"prefill of {r.prompt_len} tokens", label,
                        per_prefill)
        toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device="cuda")
        pos = torch.from_numpy(engine._pos.copy()).cuda()
        range_split(lm, lambda: lm.decode_step(engine.pool, toks, pos),
                    "eager decode step", label, per_step)
        del lm, engine
        free_card()
    return total


def cross_step_bound(lm, engine, step_dev: float, label: str) -> None:
    """The graph-replayed step's device time against the bytes it must
    move at the state ``step_times`` timed: the decoder's weights read
    once (its self and cross layers, the final norm and the unembedding;
    not the embedding table, of which a step reads 4 rows, nor the audio
    encoder, which only prefill runs), the self-attention pool's valid
    rows and every slot's whole cross K/V read."""
    from repro_torch.models.lm import CrossBlock, layer_caches
    skip = ("embed",) if not lm.cfg.tie_embeddings else ()
    weights_b = sum(t.nbytes for name, t in lm.state_dict().items()
                    if name not in skip and not name.startswith("enc_"))
    pool = cross = 0
    for blk, layer in zip(lm.layers, layer_caches(lm.cfg, engine.pool)):
        for buf in layer.values():
            if isinstance(blk, CrossBlock):
                cross += buf.nbytes
            else:
                w = buf.shape[1]
                rows = sum(min(int(p) + 1, w) for p in engine._pos)
                pool += buf[0, 0].nbytes * rows
    t_bound = (weights_b + pool + cross) / HBM_BYTES_PER_S * 1e3
    print(f"  ({label}) decode step bound: the decoder's weights read once "
          f"({weights_b / 1e9:.2f} GB), the self-attention pool's valid rows "
          f"({pool / 1e9:.3f} GB) and the cross K/V ({cross / 1e9:.3f} GB) "
          f"read at 3.35 TB/s = {t_bound:.3f} ms; the step's device time is "
          f"{step_dev:.3f} ms, {step_dev / t_bound:.2f}x that")


def range_split(lm, fn, what: str, label: str, n_attn: int) -> None:
    """Where one eager call's device time goes: self attention, cross
    attention, the audio encoder (in prefill), cuBLAS GEMMs outside the
    encoder, and the rest.  The flash and decode kernels launch through
    ``ctypes``, outside any aten op, so torch.profiler gives a
    ``record_function`` range around them none of their device time;
    instead the call's ``n_attn`` attention kernels are labelled by their
    order on the stream: the encoder's first (in prefill), then one per
    decoder layer in ``lm.layers``' order, self or cross.  The encoder's
    time is the kernel time of ``lm.encode`` traced alone (its GEMMs taken
    out of the GEMMs)."""
    from torch.profiler import ProfilerActivity
    from repro_torch.models.lm import CrossBlock
    fn()
    torch.cuda.synchronize()
    prof, _ = traced_kernels(fn, [ProfilerActivity.CUDA])
    kernels = [(n, ms) for _, n, ms in sorted(
        (e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
        for e in prof.events()
        if str(e.device_type).endswith("CUDA") and PAD_KERNEL not in e.name)]
    total = sum(ms for _, ms in kernels)
    attn = [ms for n, ms in kernels if any(
        k in n for k in ("flash_bf16_kernel", "flash_f32_kernel")
        + DECODE_KERNELS)]
    require(len(attn) == n_attn, f"({label}) the {what} ran {len(attn)} "
            f"attention kernels, not {n_attn}")
    n_enc = n_attn - len(lm.layers)
    kinds = ["cross" if isinstance(blk, CrossBlock) else "self"
             for blk in lm.layers]
    got = {kind: sum(ms for ms, k in zip(attn[n_enc:], kinds) if k == kind)
           for kind in ("self", "cross")}

    def gemms(ks):
        return sum(ms for n, ms in ks if any(g in n for g in GEMM_NAMES))
    gemm, encoder = gemms(kernels), 0.0
    if n_enc:           # the encoder traced alone: its kernels and GEMMs
        frames = torch.zeros((1, lm.cfg.n_frames, lm.cfg.d_model),
                             dtype=lm.dtype, device="cuda")
        _, enc = traced_kernels(lambda: lm.encode(frames),
                                [ProfilerActivity.CUDA])
        encoder = sum(ms for _, ms in enc)
        gemm -= gemms(enc)
    rest = total - gemm - encoder - got["self"] - got["cross"]
    enc_part = (f"the encoder {encoder:.3f} ({encoder / total:.1%}), "
                if n_enc else "")
    print(f"  ({label}) {what}, {len(kernels)} kernels, {total:.3f} ms of "
          f"device time: self attention {got['self']:.3f} "
          f"({got['self'] / total:.1%}), cross attention {got['cross']:.3f} "
          f"({got['cross'] / total:.1%}), {enc_part}GEMMs {gemm:.3f} "
          f"({gemm / total:.1%}), the rest {rest:.3f} ({rest / total:.1%})")


def bwd_inputs(gen, h, kv, sq, skv, d, dtype, b=1):
    """q, do [B*H, Sq, D] and k, v [B*KV, Skv, D] as strided views of [B, S,
    heads, D] projections (copies when B > 1), as ``layers.attention`` and
    its autograd hand them to the kernels."""
    def heads(n, length):
        return randn(gen, b, length, n, d, dtype=dtype).transpose(
            1, 2).reshape(b * n, length, d)
    return heads(h, sq), heads(kv, skv), heads(kv, skv), heads(h, sq)


def check_lse(ref, shape: str, dtype, lse, q, k, v, **kw) -> tuple:
    """The forward kernel's saved L2 against ``ref.mha_ref(...,
    return_lse=True)`` in fp32 at ``parity.LSE_TOL``, beside the simulated
    fault ``parity.lse_fault`` that the limit must reject: (the reading,
    the fault's reading)."""
    from repro_torch.kernels import parity
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ref.mha_ref(qf, kf, vf, return_lse=True, **kw)[1]
    err, tol = max_abs_err(lse, want), parity.LSE_TOL
    ferr = max_abs_err(parity.lse_fault(qf, kf, vf, **kw), want)
    print(f"  lse {shape} {dtype}: max_abs_err {err:.3e}  tol {tol:g}  "
          f"{'ok' if err <= tol else 'MISMATCH'}  (control, l from bf16 P: "
          f"{ferr:.3e} {'rejected' if ferr > tol else 'PASSES'})")
    require(err <= tol, f"flash_attention {shape} {dtype}: the saved "
            f"log-sum-exp disagrees with the plain one")
    require(ferr > tol, f"flash_attention {shape}: the log-sum-exp limit "
            f"passes a simulated fault (l summed from bf16 P)")
    return err, ferr


def check_flash_backward(ops, ref, gen, cases=BWD_CASES) -> float:
    """Phase 3, the flash-attention backward kernel against the plain
    backward (``ref.mha_backward_ref``) at every shape of ``cases``
    (``BWD_CASES``; ``SOFTCAP_BWD_CASES`` add a soft cap and a query
    offset, whose fault controls are ``parity.bwd_cap_fault_controls``,
    which fp32's 2e-4 must reject too),
    on the forward kernel's own output and log-sum-exp (which is held to
    the plain one first: ``parity.LSE_TOL``, beside ``parity.lse_fault``;
    granite's shape is ``FLASH_MAIN``'s):
    fp32 at 2e-4, and bf16 against the plain backward in fp32 at
    ``parity.BWD_ABS_TOL`` of each gradient's largest entry and
    ``parity.BWD_ROW_TOL`` on ``row_err``, beside the simulated faults
    (``parity.bwd_fault_controls``) that the limits must reject; each call
    made twice for the same bits.  Returns the bf16 max_abs_err at
    granite's shape (over dq, dk and dv, against the plain backward in
    fp32)."""
    from repro_torch.kernels import parity
    print(f" flash_attention_bwd (the forward's lse at {parity.LSE_TOL} "
          f"absolute, beside a simulated fault; fp32 at 2e-4; bf16 "
          f"against the plain backward in fp32 at {parity.BWD_ABS_TOL} of "
          f"each gradient's largest entry and row_err {parity.BWD_ROW_TOL} "
          f"(each row's rms floored at {parity.BWD_ROW_FLOOR} of the "
          f"tensor's), beside simulated faults; every call twice for the "
          f"same bits)")
    main_err = None
    sound = {"abs": 0.0, "row": 0.0}
    faults = {"abs": float("inf"), "row": float("inf")}
    lse_sound, lse_ctrl = 0.0, float("inf")
    for case in cases:
        what, h, kv, sq, skv, d, causal, window = case[:8]
        masks = dict(zip(("softcap", "q_offset"), case[8:]))
        kw = dict(causal=causal, kv_group=h // kv, window=window, **masks)
        shape = (f"{what} H={h} KV={kv} Sq={sq} Skv={skv} D={d}"
                 f"{' causal' if causal else ''}"
                 f"{f' window {window}' if window else ''}"
                 + "".join(f" {k} {v}" for k, v in masks.items() if v))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = bwd_inputs(gen, h, kv, sq, skv, d, dtype)
            o, lse = ops.flash_attention_lse(q, k, v, **kw)
            err, ferr = check_lse(ref, shape, dtype, lse, q, k, v, **kw)
            lse_sound, lse_ctrl = max(lse_sound, err), min(lse_ctrl, ferr)
            got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            for name, g, a in zip(("dq", "dk", "dv"), got, again):
                require(torch.equal(g, a), f"flash_attention_bwd {shape} "
                        f"{dtype}: {name} of two identical calls differ")
            if dtype == torch.float32:
                want = ref.mha_backward_ref(
                    q, k, v, o, do,
                    ref.mha_ref(q, k, v, return_lse=True, **kw)[1], **kw)
                err = max(max_abs_err(g, w) for g, w in zip(got, want))
                ok = all(torch.allclose(g, w, rtol=2e-4, atol=2e-4)
                         for g, w in zip(got, want))
                print(f"  bwd {shape} fp32: max_abs_err {err:.3e}  "
                      f"{'ok' if ok else 'MISMATCH'}  (twice: same bits)")
                require(ok, f"flash_attention_bwd {shape} fp32: kernel "
                        f"disagrees with its plain version")
                for fault, bad in (parity.bwd_cap_fault_controls(
                        q, k, v, o, do, h // kv, causal=causal,
                        window=window, **masks) if masks else {}).items():
                    fok = all(torch.allclose(b, w, rtol=2e-4, atol=2e-4)
                              for b, w in zip(bad, want))
                    ferr = max(max_abs_err(b, w) for b, w in zip(bad, want))
                    print(f"    control, {fault:28s} max_abs_err {ferr:.3e}"
                          f"  {'PASSES' if fok else 'rejected'}")
                    require(not fok, f"flash_attention_bwd {shape} fp32: "
                            f"2e-4 passes a simulated fault ({fault})")
                continue
            want32 = parity.bwd_want32(q, k, v, o, do, **kw)
            ok, err, rerr = parity.bwd_within_limits(got, want32)
            print("    row_err of dq, dk, dv: " + ", ".join(
                f"{parity.bwd_row_err(g, w):.3e} (unfloored "
                f"{parity.row_err(g, w):.3e})" for g, w in zip(got, want32)))
            print(f"  bwd {shape} bf16: err {err:.3e} of max  row_err "
                  f"{rerr:.3e}  {'ok' if ok else 'MISMATCH'}  (twice: same "
                  f"bits)")
            require(ok, f"flash_attention_bwd {shape} bf16: kernel "
                    f"disagrees with its plain version (abs {err:.3e}, row "
                    f"{rerr:.3e})")
            sound["abs"], sound["row"] = (max(sound["abs"], err),
                                          max(sound["row"], rerr))
            if main_err is None:
                main_err = max(max_abs_err(g, w) for g, w in zip(got, want32))
                print(f"    max_abs_err {main_err:.3e} (the kernels line's)")
            controls = (parity.bwd_cap_fault_controls(
                q, k, v, o, do, h // kv, causal=causal, window=window,
                **masks) if masks else parity.bwd_fault_controls(
                    q, k, v, o, do, h // kv, causal, window))
            for fault, bad in controls.items():
                fok, ferr, frerr = parity.bwd_within_limits(bad, want32)
                print(f"    control, {fault:28s} err {ferr:.3e}  row_err "
                      f"{frerr:.3e}  {'PASSES' if fok else 'rejected'}")
                require(not fok, f"flash_attention_bwd {shape}: the bf16 "
                        f"limits pass a simulated fault ({fault})")
                faults["abs"], faults["row"] = (min(faults["abs"], ferr),
                                                min(faults["row"], frerr))
            free_card()
    print(f"  lse: largest sound reading {lse_sound:.3e}, smallest fault "
          f"reading {lse_ctrl:.3e}")
    print(f"  bwd bf16: largest sound reading err {sound['abs']:.3e}, "
          f"row_err {sound['row']:.3e}; smallest fault reading err "
          f"{faults['abs']:.3e}, row_err {faults['row']:.3e}")
    return main_err


def check_masked(what: str, got, want, controls: dict) -> None:
    """A capped or offset call against its plain version at the limits of
    the uncapped call (bf16: ``parity.within_limits``; fp32: 2e-4), beside
    fault controls that those limits must reject."""
    from repro_torch.kernels import parity
    bf16 = got.dtype == torch.bfloat16
    if bf16:
        check_flash_bf16(what, got, want)
    else:
        check_close(what, got, want, 2e-4)
    for fault, bad in controls.items():
        if bf16:
            ok, ferr, frerr = parity.within_limits(bad, want)
        else:
            ok = torch.allclose(bad.float(), want.float(), rtol=2e-4,
                                atol=2e-4)
            ferr, frerr = max_abs_err(bad, want), parity.row_err(bad, want)
        print(f"    control, {fault:26s} max_abs_err {ferr:.3e}  row_err "
              f"{frerr:.3e}  {'PASSES' if ok else 'rejected'}")
        require(not ok, f"{what}: the limits pass a simulated fault "
                f"({fault})")


def check_softcap(ops, ref, gen) -> None:
    """Phase 3, logit soft caps and the query offset in the three attention
    kernels, each against its plain version at the limits of the uncapped
    call beside fault controls that those limits must reject (the cap
    dropped, the offset dropped: ``parity.cap_fault_controls``,
    ``decode_cap_fault_controls``): flash at row 3's shape capped and at
    the offset case (a causal chunk, Sq < Skv) with and without the cap,
    in bf16 and fp32; every head dim's tile capped and offset (bf16 at two
    lengths, causal and not, kv_group 1 and 4; fp32 at one); decode at row
    4's shape capped (its lse too, and two calls bitwise equal) and at
    recurrentgemma's D 256 group; then the backward at
    ``SOFTCAP_BWD_CASES``."""
    from repro_torch.kernels import parity
    cap, (sq, skv) = SOFTCAP_CHECK, OFFSET_CASE
    print(f" soft cap {cap} and query offset (flash H=32 KV=8 D=64 at "
          f"S={FLASH_MAIN[3]} capped, and a causal chunk of {sq} queries "
          f"over {skv} keys at offset {OFFSET}; bf16 at both flash limits, "
          f"fp32 at 2e-4, each beside fault controls that they must reject)")
    for dtype in (torch.bfloat16, torch.float32):
        for what, s, kv_len, kw in (
                (f"S={FLASH_MAIN[3]} capped", FLASH_MAIN[3], None,
                 dict(softcap=cap)),
                (f"Sq={sq} Skv={skv} offset {OFFSET}", sq, skv,
                 dict(q_offset=OFFSET)),
                (f"Sq={sq} Skv={skv} offset {OFFSET} capped", sq, skv,
                 dict(q_offset=OFFSET, softcap=cap))):
            q, k, v, rep = flash_inputs(gen, s, dtype, skv=kv_len)
            got = ops.flash_attention(q, k, v, kv_group=rep, **kw)
            want = ref.mha_ref(q, k, v, kv_group=rep, **kw)
            check_masked(f"flash {what} {dtype}", got, want,
                         parity.cap_fault_controls(q, k, v, rep, **kw))
    print(f" flash under a cap of {cap}, every head dim: bf16 at S 63 and "
          f"200, causal and not, kv_group 1 and 4 (strided views), all "
          f"queries and the last two thirds at their offset; fp32 at S 200 "
          f"(H=8 over KV=2), both ways; max over each head dim")
    for d in parity.SWEEP_D:
        worst, worst_row = 0.0, 0.0
        for s in (63, 200):
            for rep, causal, q, k, v in parity.sweep_cases(gen, d, s):
                for off in (0, s // 3):
                    kw = dict(causal=causal, kv_group=rep, softcap=cap,
                              q_offset=off)
                    got = ops.flash_attention(q[:, off:], k, v, **kw)
                    want = ref.mha_ref(q[:, off:], k, v, **kw)
                    torch.cuda.synchronize()
                    ok, err, rerr = parity.within_limits(got, want)
                    require(ok, f"flash bf16 D={d} S={s} {kw}: kernel "
                            f"disagrees with its plain version (abs "
                            f"{err:.3e}, row {rerr:.3e})")
                    worst, worst_row = max(worst, err), max(worst_row, rerr)
        q, k, v, rep = flash_inputs(gen, 200, torch.float32, h=8, kv=2, d=d)
        err32 = 0.0
        for causal, off in ((True, 0), (True, 67), (False, 0)):
            kw = dict(causal=causal, kv_group=rep, softcap=cap,
                      q_offset=off)
            got = ops.flash_attention(q[:, off:], k, v, **kw)
            want = ref.mha_ref(q[:, off:], k, v, **kw)
            torch.cuda.synchronize()
            require(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                    f"flash fp32 D={d} {kw}: kernel disagrees with its "
                    f"plain version")
            err32 = max(err32, max_abs_err(got, want))
        print(f"  flash capped D={d:<3d} bf16 max_abs_err {worst:.3e}  "
              f"row_err {worst_row:.3e}; fp32 max_abs_err {err32:.3e}  ok")

    print(f" decode_attention capped at {cap} (4 slots x 32 heads over "
          f"[4,2112,8,64], lens 1/300/1000/2112; recurrentgemma's 10 heads "
          f"over [4,2048,1,256]): bf16 at 5e-2 and row_err "
          f"{parity.DECODE_ROW_TOL} against the plain version in fp32, fp32 "
          f"at 2e-4, beside the cap dropped; the lse (fp32 1e-4, bf16 "
          f"1e-3) and two calls bitwise equal")
    neg = float(np.float32(ref.NEG_INF))
    for shape, lens in ((DECODE_MAIN, DECODE_MAIN_LENS),
                        (GRIFFIN_DECODE, GRIFFIN_DECODE_LENS)):
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc, ln = decode_inputs(gen, dtype, *shape, lens)
            what = f"decode {list(shape)} capped {dtype}"
            lse = torch.empty(q.shape[:2], dtype=torch.float32,
                              device="cuda")
            got = ops.decode_attention(q, kc, vc, ln, lse=lse, softcap=cap)
            want = ref.decode_attention_ref(q, kc, vc, ln, softcap=cap)
            want32, want_lse = ref.decode_attention_ref(
                q.float(), kc.float(), vc.float(), ln, softcap=cap,
                return_lse=True)
            controls = parity.decode_cap_fault_controls(q, kc, vc, ln)
            if dtype == torch.bfloat16:
                torch.cuda.synchronize()
                ok, err, rerr = parity.within_decode_limits(got, want,
                                                            want32)
                print(f"  {what:48s} max_abs_err {err:.3e}  row_err "
                      f"{rerr:.3e}  {'ok' if ok else 'MISMATCH'}")
                require(ok, f"{what}: kernel disagrees with its plain "
                        f"version")
                for fault, bad in controls.items():
                    frerr = parity.row_err(bad, want32)
                    print(f"    control, {fault:26s} row_err {frerr:.3e}  "
                          f"{'PASSES' if frerr <= parity.DECODE_ROW_TOL else 'rejected'}")
                    require(frerr > parity.DECODE_ROW_TOL, f"{what}: the "
                            f"row limit passes a simulated fault ({fault})")
            else:
                check_close(what, got, want, 2e-4)
                for fault, bad in controls.items():
                    ok = torch.allclose(bad, want, rtol=2e-4, atol=2e-4)
                    print(f"    control, {fault:26s} max_abs_err "
                          f"{max_abs_err(bad, want):.3e}  "
                          f"{'PASSES' if ok else 'rejected'}")
                    require(not ok, f"{what}: 2e-4 passes a simulated "
                            f"fault ({fault})")
            lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
            lse_err = max_abs_err(lse, want_lse)
            empty = torch.tensor(lens, device="cuda") == 0
            print(f"    lse max_abs_err {lse_err:.2e} (limit {lse_tol:.0e})")
            require(lse_err <= lse_tol and bool((lse[empty] == neg).all()),
                    f"{what}: the lse is {lse_err:.2e} from the plain "
                    f"version's")
            require_same_bits(f"{what}, called twice", got,
                              ops.decode_attention(q, kc, vc, ln,
                                                   softcap=cap))
    check_flash_backward(ops, ref, gen, SOFTCAP_BWD_CASES)


def backward_case(ops, ref, gen, b, h, kv, s, d, window=0, check=False):
    """The flash backward at B, H over KV, S, D (causal, bf16, under
    ``window``; 0: none): (kernel, plain, library, bound ms, bound_by).
    The bound: 10 FLOP per attended pair and head dim at the bf16
    tensor-core peak; q, k, v, o, do read and dq, dk, dv written once.
    The library call: SDPA's backward (autograd through
    ``F.scaled_dot_product_attention``: a yardstick, never on the path),
    ``is_causal`` where the window masks nothing, else under the boolean
    causal-and-window mask.  ``check``: first hold the kernel at these
    inputs to the plain backward in fp32 at phase 3's bf16 limits
    (:func:`check_backward_rows`)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do = bwd_inputs(gen, h, kv, s, s, d, torch.bfloat16, b=b)
    kw = dict(kv_group=h // kv, window=window)
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    if check:
        check_backward_rows(ops, f"B={b} H={h} KV={kv} S={s} D={d} window "
                            f"{window}", (q, k, v, o, do, lse), kw, b * kv)
    q4, k4, v4 = (x.detach().reshape(b, -1, s, d).requires_grad_()
                  for x in (q, k, v))
    if window and window < s:
        pos = torch.arange(s, device="cuda")
        diff = pos[:, None] - pos[None, :]
        out = F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=(diff >= 0) & (diff < window),
            enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                             enable_gqa=True)
    do4 = do.reshape(b, h, s, d)
    t_bound, by = bound(*fab.work(b * h, s, s, d, h // kv, True, window),
                        BF16_PEAK_FLOPS)
    return (lambda: ops.flash_attention_bwd(q, k, v, o, do, lse, **kw),
            lambda: ref.mha_backward_ref(q, k, v, o, do, lse, **kw),
            lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                        retain_graph=True),
            t_bound, by)


def check_backward_rows(ops, what: str, inputs, kw, kv_rows: int) -> None:
    """Phase 4, a timed backward shape with more than one KV row (B > 1 at
    one KV head) against the plain backward in fp32 at phase 3's bf16
    limits (``parity.bwd_within_limits``), called twice for the same bits,
    beside a control that the limits must reject: each KV row's dk and dv
    and its query heads' dq in another KV row's place (what a kernel that
    reads or writes the wrong KV row's tiles gives)."""
    from repro_torch.kernels import parity
    q, k, v, o, do, lse = inputs
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for name, g, a in zip(("dq", "dk", "dv"), got, again):
        require(torch.equal(g, a), f"flash_attention_bwd {what}: {name} of "
                f"two identical calls differ")
    want32 = parity.bwd_want32(q, k, v, o, do, **kw)
    ok, err, rerr = parity.bwd_within_limits(got, want32)
    print(f"  bwd {what} bf16 ({kv_rows} KV rows): err {err:.3e} of max  "
          f"row_err {rerr:.3e}  {'ok' if ok else 'MISMATCH'}  (twice: same "
          f"bits)")
    require(ok, f"flash_attention_bwd {what} bf16: kernel disagrees with "
            f"its plain version (abs {err:.3e}, row {rerr:.3e})")
    dq, dk, dv = got
    swapped = (dq.roll(q.shape[0] // kv_rows, 0), dk.roll(1, 0),
               dv.roll(1, 0))
    fok, ferr, frerr = parity.bwd_within_limits(swapped, want32)
    print(f"    control, {'KV rows swapped':28s} err {ferr:.3e}  row_err "
          f"{frerr:.3e}  {'PASSES' if fok else 'rejected'}")
    require(not fok, f"flash_attention_bwd {what}: the bf16 limits pass "
            f"gradients in another KV row's place")
    del got, again, want32, swapped
    free_card()


def time_backward(ops, ref, gen, rows, dev) -> None:
    """Phase 4, the flash backward at granite-3-2b's training shape (B 4,
    so 128 query rows over 32 KV rows, S 2048, D 64, causal, bf16), at
    nemotron-4-15b's heads (B 1, H 48 over KV 8, S 2048, D 128) and at
    recurrentgemma-2b's (H 10 over KV 1, D 256, window 2048: its training
    shape, B 2 at S 4096, and B 4 at S 2048, where the window masks
    nothing), each beside its bound, the plain backward and SDPA's backward
    (``backward_case``), with the device time of each of a call's three
    kernels."""
    b, s = TRAIN_SHAPE
    _, h, kv, _, d = FLASH_MAIN
    kernel, plain, library, t_bound, by = backward_case(ops, ref, gen, b, h,
                                                        kv, s, d)
    rows["flash_attention_bwd"], dev["flash_attention_bwd"] = time_row(
        kernel, plain, library, t_bound, by, iters=20, plain_iters=5)
    print_row(f"flash_attention_bwd B={b} H={h} KV={kv} S={s} D={d} causal "
              f"bf16 (SDPA backward as the library call)",
              rows["flash_attention_bwd"], dev["flash_attention_bwd"])
    three_kernels(kernel, f"D={d}")
    h, kv, d = WIDE_GROUP_HEADS[0], 8, FLASH_WIDE_D
    kernel, plain, library, t_bound, by = backward_case(ops, ref, gen, 1, h,
                                                        kv, s, d)
    row, rdev = time_row(kernel, plain, library, t_bound, by, iters=20,
                         plain_iters=5)
    print_row(f"flash_attention_bwd B=1 H={h} KV={kv} S={s} D={d} causal "
              f"bf16 (nemotron-4-15b's heads; SDPA backward as the library "
              f"call)", row, rdev)
    three_kernels(kernel, f"D={d}")
    free_card()
    # recurrentgemma-2b's attention backward (13 (d)): its training shape
    # under the window, and S 2048, where the window masks nothing; each
    # held to the plain backward first (phase 3's D = 256 cases have one
    # KV row, these two and four)
    _, h, kv, s, d = GRIFFIN_FLASH
    for b, s, lib in ((2, s, "boolean causal-and-window mask"),
                      (4, s // 2, "is_causal, GQA")):
        kernel, plain, library, t_bound, by = backward_case(
            ops, ref, gen, b, h, kv, s, d, GRIFFIN_WINDOW, check=True)
        row, rdev = time_row(kernel, plain, library, t_bound, by, iters=20,
                             plain_iters=2)
        print_row(f"flash_attention_bwd B={b} H={h} KV={kv} S={s} D={d} "
                  f"causal window {GRIFFIN_WINDOW} bf16 (recurrentgemma-2b; "
                  f"SDPA backward, {lib}, as the library call)", row, rdev)
        three_kernels(kernel, f"D={d} S={s}")
        free_card()


def uncapped(rows, dev, name: str) -> None:
    """Phase 4: the uncapped row that the next capped one stands beside,
    as timed earlier in the phase."""
    print(f"  {name} uncapped (above): kernel {rows[name]['ms']:.4f} ms "
          f"(device {dev[name]['kernel']:.4f})")


def masked_row(what: str, kernel, plain, t_bound: float, by: str,
               library=None, iters: int = 50, plain_iters: int = 5) -> None:
    """Phase 4, one capped or offset row: the kernel's CUDA-event and
    device ms per call beside its bound, its plain version's CUDA-event ms
    and, where one PyTorch call computes the same function, that call's
    (else "none": SDPA has no cap)."""
    ms, dev_ms = time_ms(kernel, iters), device_profile(kernel)[0]
    lib = (f"{time_ms(library, iters):.4f} ms (device "
           f"{device_profile(library)[0]:.4f})" if library is not None
           else "none (SDPA has no cap)")
    print(f"  {what}: kernel {ms:.4f} ms (device {dev_ms:.4f})  bound "
          f"{t_bound:.4f} ms ({by})  plain "
          f"{time_ms(plain, plain_iters):.4f} ms  library {lib}")


def time_softcap(ops, ref, gen, rows, dev) -> None:
    """Phase 4, the capped and offset rows of PERF.md (3-cap, 3-off,
    3-bwd-cap, 3-bwd-off, 4-cap) under Gemma 2's cap, each beside the
    uncapped call at the same shape timed earlier in this phase (``rows``,
    ``dev``) and its bound: the flash forward at row 3's shape,
    the backward at row 3-bwd's (B 4), decode at row 4's (four cache pairs
    in turn, cold in L2), and the offset case (a causal chunk of Sq
    queries over Skv keys) forward and backward, whose SDPA call takes a
    boolean mask of the chunk's positions.  The cap adds no FLOP to the
    bound (a tanh, like the exponential, is not counted)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    cap = SOFTCAP_GEMMA
    b, h, kv, s, d = FLASH_MAIN
    q, k, v, rep = flash_inputs(gen, s, torch.bfloat16)
    t_bound, by = bound(*fa.work(b * h, s, s, d, rep, True), BF16_PEAK_FLOPS)
    uncapped(rows, dev, "flash_attention")
    masked_row(f"flash_attention S={s} D={d} causal bf16 cap {cap:g}",
               lambda: ops.flash_attention(q, k, v, kv_group=rep,
                                           softcap=cap),
               lambda: ref.mha_ref(q, k, v, kv_group=rep, softcap=cap),
               t_bound, by)
    sq, skv = OFFSET_CASE
    q, k, v, rep = flash_inputs(gen, sq, torch.bfloat16, skv=skv)
    keep = (torch.arange(sq, device="cuda")[:, None] + OFFSET
            >= torch.arange(skv, device="cuda")[None, :])
    q4, k4, v4 = (x.reshape(b, -1, x.shape[1], d) for x in (q, k, v))
    t_bound, by = bound(*fa.work(b * h, sq, skv, d, rep, True,
                                 q_offset=OFFSET), BF16_PEAK_FLOPS)
    masked_row(f"flash_attention Sq={sq} Skv={skv} offset {OFFSET} causal "
               f"bf16",
               lambda: ops.flash_attention(q, k, v, kv_group=rep,
                                           q_offset=OFFSET),
               lambda: ref.mha_ref(q, k, v, kv_group=rep, q_offset=OFFSET),
               t_bound, by,
               lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=keep, enable_gqa=True))

    bt, s = TRAIN_SHAPE
    uncapped(rows, dev, "flash_attention_bwd")
    for what, sq, skv, kw in (("", s, s, ({"softcap": cap},)),
                              (f" offset {OFFSET}", *OFFSET_CASE,
                               ({"q_offset": OFFSET},))):
        q, k, v, do = bwd_inputs(gen, h, kv, sq, skv, d, torch.bfloat16,
                                 b=bt)
        t_bound, by = bound(*fab.work(bt * h, sq, skv, d, h // kv, True,
                                      q_offset=OFFSET if what else 0),
                            BF16_PEAK_FLOPS)
        library = None
        if what:        # SDPA's backward under the chunk's boolean mask
            keep = (torch.arange(sq, device="cuda")[:, None] + OFFSET
                    >= torch.arange(skv, device="cuda")[None, :])
            q4, k4, v4 = (x.detach().reshape(bt, -1, x.shape[1], d)
                          .requires_grad_() for x in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep,
                                                  enable_gqa=True)
            do4 = do.reshape(bt, h, sq, d)

            def library():
                return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True)
        for m in kw:
            o, lse = ops.flash_attention_lse(q, k, v, kv_group=h // kv, **m)
            tag = " ".join(f"{n} {x:g}" for n, x in m.items())
            masked_row(f"flash_attention_bwd B={bt} H={h} KV={kv} Sq={sq} "
                       f"Skv={skv} D={d} causal bf16{what} {tag}",
                       functools.partial(ops.flash_attention_bwd, q, k, v,
                                         o, do, lse, kv_group=h // kv, **m),
                       functools.partial(ref.mha_backward_ref, q, k, v, o,
                                         do, lse, kv_group=h // kv, **m),
                       t_bound, by, library, iters=20, plain_iters=2)
        free_card()

    b, h, kv, s, d = DECODE_MAIN
    q, _, _, lens = decode_inputs(gen, torch.bfloat16, b, h, kv, s, d,
                                  DECODE_MAIN_LENS)
    caches = itertools.cycle([
        decode_inputs(gen, torch.bfloat16, b, h, kv, s, d,
                      DECODE_MAIN_LENS)[1:3] for _ in range(4)])
    valid = sum(DECODE_MAIN_LENS)
    t_bound, by = bound(4.0 * h * d * valid,
                        2.0 * (2 * valid * kv * d + 2 * b * h * d),
                        BF16_PEAK_FLOPS)
    uncapped(rows, dev, "decode_attention")
    masked_row(f"decode_attention [4,2112,8,64] bf16 cap {cap:g}",
               lambda: ops.decode_attention(q, *next(caches), lens,
                                            softcap=cap),
               lambda: ref.decode_attention_ref(q, *next(caches), lens,
                                                softcap=cap),
               t_bound, by, iters=200, plain_iters=20)


def three_kernels(kernel, shape: str) -> None:
    """Phase 4: one flash_attention_bwd call is exactly three device
    launches (prep, dK/dV, dQ), each printed with its device ms per call."""
    launched = device_kernels(kernel)
    print(f"  flash_attention_bwd {shape}: one call runs {len(launched)} "
          f"device kernels: " + ", ".join(
              f"{n[:60]} {ms:.4f} ms" for n, ms in device_profile(kernel)[1]))
    require(len(launched) == 3, f"a flash_attention_bwd call at {shape} is "
            f"not its three kernels (prep, dK/dV, dQ): {launched}")


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

def train_batch(cfg, b: int, s: int, step: int, device="cuda") -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens, data_config_for
    data = SyntheticTokens(data_config_for(
        cfg, ShapeConfig("smoke", s, b, "train")), device=device)
    return data.batch(step)


@contextmanager
def one_cpu_thread():
    """The CPU reference on one thread, the count restored after: a
    reduction's order (torch's parallel reductions, MKL's GEMMs) then
    depends on no thread count, fixed or chosen at run time.  In run 28C
    the first of two calls of one function in one process moved its loss
    by 1.06e-6 relative and a gradient past 13 (a')'s 2e-4; one thread
    holds the CPU's two losses bit for bit, which (a') requires."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def check_train_parity(ops, softcap: float = 0.0, label: str = "a'",
                       batch_size: int = TRAIN_PARITY[1]) -> None:
    """(a'): granite-3-2b at full width, 2 layers in fp32, B 2, S 256
    (``softcap``: under that logit soft cap at ``batch_size``, 18 (a)): the
    loss and every gradient of ``LM.train_loss`` and one
    ``make_train_step`` on the card (the flash forward and backward
    kernels) against the same on the CPU (their plain versions), from the
    same weights and batch: the loss within 1e-5 relative, every gradient
    and updated parameter within 2e-4 of its leaf's largest entry; the
    step launches flash forward twice a layer (block remat) and the
    backward once.  AdamW's eps is 1e-4 here: a first Adam step is
    g / (|g| + eps), which at the default 1e-8 turns the two devices'
    fp32 rounding in a near-zero gradient into a sixth of a step (5e-4 of
    a parameter's max, seen on the card), as tests/test_torch_train.py
    notes for the JAX package's step.  The CPU's side runs on one thread
    (:func:`one_cpu_thread`), and its two losses of the one function (the
    first call's and the step's) must agree bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.models.lm import LM
    from repro_torch.train import optimizer, train_step
    layers, _, s = TRAIN_PARITY
    b = batch_size
    cfg = dataclasses.replace(cut_depth(get_config(TRAIN_ARCH), layers)[0],
                              dtype="float32", param_dtype="float32",
                              logit_softcap=softcap)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                       eps=1e-4)
    gpu = watched_lm(cfg, 5, Plan(remat="block"))
    cpu = LM(cfg, {n: p.detach().cpu() for n, p in gpu.params().items()},
             Plan(remat="block"))
    batch = train_batch(cfg, b, s, 0)
    out = {}
    for where, lm in (("cuda", gpu), ("cpu", cpu)):
        with one_cpu_thread() if where == "cpu" else nullcontext():
            lm.requires_grad_(True)
            mb = {k: x.to(where) for k, x in batch.items()}
            total, _ = lm.train_loss(mb)
            grads = torch.autograd.grad(total, list(lm.params().values()))
            step = train_step.make_train_step(lm, tcfg)
            ops.reset_launch_counts()
            params, _, metrics = step(lm.params(), optimizer.init(
                lm.params(), tcfg), mb, 0)
            out[where] = (total.item(), [g.cpu() for g in grads],
                          [p.detach().cpu() for p in params.values()],
                          float(metrics["loss"]), ops.launch_counts())
    names = list(gpu.params())
    (l_gpu, g_gpu, p_gpu, m_gpu, n_gpu), (l_cpu, g_cpu, p_cpu, m_cpu, _) = \
        out["cuda"], out["cpu"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst_g = max((a - c).abs().max().item() / c.abs().max().clamp_min(
        1e-30).item() for a, c in zip(g_gpu, g_cpu))
    worst_p = max((a - c).abs().max().item() / c.abs().max().clamp_min(
        1e-30).item() for a, c in zip(p_gpu, p_cpu))
    cap = f", cap {softcap:g}" if softcap else ""
    print(f"  ({label}) {TRAIN_ARCH} {layers} layers fp32{cap} B={b} S={s}: "
          f"loss card {l_gpu:.7f} CPU {l_cpu:.7f} (rel {rel:.2e}); step "
          f"loss card {m_gpu:.7f} CPU {m_cpu:.7f} (the CPU's two losses "
          f"{'bitwise equal' if l_cpu == m_cpu else 'DIFFER'}, one thread); "
          f"{len(names)} gradient leaves, largest error {worst_g:.2e} of "
          f"the leaf's max; updated params {worst_p:.2e}; step launches "
          f"{n_gpu}")
    require(l_cpu == m_cpu, f"({label}) the CPU's loss moved between two "
            f"calls of one function: {l_cpu!r} and {m_cpu!r}")
    require(rel <= 1e-5 and abs(m_gpu - m_cpu) <= 1e-5 * abs(m_cpu),
            f"({label}) the card's loss is {rel:.2e} from the CPU's")
    require(worst_g <= 2e-4, f"({label}) a gradient is {worst_g:.2e} of its "
            f"max from the CPU's")
    require(worst_p <= 2e-4, f"({label}) an updated parameter is "
            f"{worst_p:.2e} of its max from the CPU's")
    require(n_gpu["flash_attention"] == 2 * layers
            and n_gpu["flash_attention_bwd"] == layers,
            f"({label}) the step launched {n_gpu}, not flash forward twice "
            f"and backward once a layer")


def train_split(label: str, step, xent_ms: float, xent_gemm_ms: float):
    """One profiled training step's device time split into GEMMs, flash
    forward, flash backward, the loss (``xent_ms``: its forward, recompute
    and backward traced alone, ``xent_gemm_ms`` of it GEMMs), the
    optimizer (its ``train.optimizer`` profiler range) and the rest;
    returns the step's device ms and the names of its kernels."""
    from torch.profiler import ProfilerActivity
    prof, traced = traced_kernels(step, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    traced = [(n, ms) for n, ms in traced if not n.startswith("train.")]
    total = sum(ms for _, ms in traced)
    fwd = sum(ms for n, ms in traced if "flash_bf16_kernel" in n)
    bwd = sum(ms for n, ms in traced if any(
        k in n for k in ("bwd_prep_kernel", "bwd_dkdv_", "bwd_dq_")))
    gemm = sum(ms for n, ms in traced if any(g in n for g in GEMM_NAMES))
    opt = sum(e.device_time_total for e in prof.events()
              if e.name == "train.optimizer"
              and not str(e.device_type).endswith("CUDA")) / 1e3
    gemm -= xent_gemm_ms
    rest = total - gemm - fwd - bwd - xent_ms - opt
    parts = (("GEMMs", gemm), ("flash fwd", fwd), ("flash bwd", bwd),
             ("xent", xent_ms), ("optimizer", opt), ("the rest", rest))
    print(f"  ({label}) one step, {len(traced)} kernels, {total:.1f} ms of "
          f"device time: " + ", ".join(f"{w} {ms:.1f} ({ms / total:.1%})"
                                       for w, ms in parts))
    print(f"  ({label}) heaviest kernels of the step:")
    by_name = {}
    for n, ms in traced:
        by_name[n] = by_name.get(n, 0.0) + ms
    for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"      {ms:9.3f}  {n[:90]}")
    require(fwd > 0 and bwd > 0 and opt > 0, f"({label}) the step's split "
            f"found no flash forward, flash backward or optimizer time")
    return total, set(by_name)


def train_cell(ops, label: str, cfg, b: int, s: int, steps: int,
               seed: int) -> dict:
    """One training cell: ``cfg`` in bf16 with AdamW (fp32 moments, no
    master copy), block remat and vocab_chunk TRAIN_VOCAB_CHUNK at B, S: a
    warm-up step, ``steps`` timed steps (every loss finite, the last below
    the first, no NaN in the parameters, the flash forward twice and the
    backward once an attention layer a step), step wall and device ms,
    tokens per second, the model-FLOPs share of the bf16 peak, the idle
    share, the device split and peak memory.  Returns the timed steps'
    launches, the peak, the profiled step's device ms and its kernels'
    names, and the mean step wall ms."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.train import optimizer, train_step
    plan = Plan(remat="block", vocab_chunk=TRAIN_VOCAB_CHUNK)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps + 2)
    lm = watched_lm(cfg, seed, plan)
    n_params = sum(p.numel() for p in lm.params().values())
    n_attn = cfg.n_attention_layers
    step_fn = train_step.make_train_step(lm, tcfg)
    opt = optimizer.init(lm.params(), tcfg)
    batches = [train_batch(cfg, b, s, i) for i in range(steps + 2)]
    window = cfg.window if cfg.attn_kind == "local" else 0
    print(f"  ({label}) {cfg.name} {describe_depth(cfg)}: d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, D="
          f"{cfg.head_dim}{f', window {window}' if window else ''}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, bf16, "
          f"{n_params / 1e9:.3f} B parameters, "
          f"B={b} S={s}, remat block, vocab_chunk {TRAIN_VOCAB_CHUNK}, "
          f"AdamW fp32 moments; {torch.cuda.memory_allocated() / 2**30:.1f} "
          f"GiB held before the first step")
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i, batch in enumerate(batches[:steps + 1]):
        if i == 1:
            ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt, metrics = step_fn(lm.params(), opt, batch, i)
        losses.append(metrics["loss"].item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    per_step = {k: v / steps for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    print(f"  ({label}) losses {[round(x, 4) for x in losses]} (warm-up "
          f"first)")
    nan = any(torch.isnan(p).any().item() for p in lm.params().values())
    require(all(np.isfinite(losses)), f"({label}) a training loss is not "
            f"finite")
    require(losses[-1] < losses[0], f"({label}) the loss did not fall: "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    require(not nan, f"({label}) a parameter is NaN after training")
    require(per_step.get("flash_attention") == 2 * n_attn
            and per_step.get("flash_attention_bwd") == n_attn,
            f"({label}) launches per step {per_step}, not {2 * n_attn} "
            f"flash forward (block remat) and {n_attn} backward")
    wall = float(np.mean(walls[1:]))
    tokens = b * s
    # 6 N per token, and causal attention: 12 FLOP per attended pair, head
    # dim, head and attention layer (2 + 2 forward, twice that backward)
    model_flops = (6.0 * n_params * tokens + 12.0 * n_attn * b
                   * cfg.n_heads * cfg.head_dim * fab.attended_pairs(
                       s, s, True, window))

    # the loss alone, traced: its forward, recompute and backward (the
    # unembedding's weight gradient too)
    from torch.profiler import ProfilerActivity
    hid = randn(torch.Generator().manual_seed(9), b, s, cfg.d_model,
                dtype=lm.dtype).requires_grad_()
    w = lm.embed if cfg.tie_embeddings else lm.unembed

    def xent():
        torch.autograd.grad(lm.chunked_softmax_xent(
            hid, batches[0]["labels"]), (hid, w))
    xent()
    _, xk = traced_kernels(xent, [ProfilerActivity.CUDA])
    xent_ms = sum(ms for _, ms in xk)
    xent_gemm = sum(ms for n, ms in xk if any(g in n for g in GEMM_NAMES))
    del hid
    batch = batches[-1]

    def step():
        step_fn(lm.params(), opt, batch, steps + 1)
    dev_ms, names = train_split(label, step, xent_ms, xent_gemm)
    share = model_flops / (wall / 1e3) / BF16_PEAK_FLOPS
    print(f"  ({label}) step wall {wall:.1f} ms (mean of {steps}; each "
          f"{[round(w, 1) for w in walls[1:]]}), device {dev_ms:.1f} ms "
          f"(profiled step), idle share {max(0.0, 1 - dev_ms / wall):.1%}; "
          f"{tokens / (wall / 1e3):.0f} tokens/s; model FLOPs "
          f"{model_flops:.3e} a step, {share:.1%} of the "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 peak; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"launches a step {per_step}; {nvidia_smi_line()}")
    del lm, opt, step_fn, batches, batch
    free_card()
    return {"launches": launches, "peak_bytes": peak, "device_ms": dev_ms,
            "wall_ms": wall, "kernels": names}


def describe_depth(cfg) -> str:
    attn = cfg.n_attention_layers
    return (f"{cfg.n_layers} layers" if attn == cfg.n_layers
            else f"{cfg.n_layers} layers ({attn} attention)")


@contextmanager
def recorded_backward(ops):
    """Every flash backward call the kernels' autograd function makes,
    recorded as (its inputs, its keywords, its outputs), each cloned."""
    calls, bwd = [], ops.flash_attention_bwd

    def record(*args, **kw):
        out = bwd(*args, **kw)
        calls.append(([t.detach().clone() for t in args], dict(kw),
                      [t.detach().clone() for t in out]))
        return out
    ops.flash_attention_bwd = record
    try:
        yield calls
    finally:
        ops.flash_attention_bwd = bwd


def check_griffin_step(ops) -> None:
    """(d)'s checks, on its step cut to one group of the pattern
    (TRAIN_RG_CHECK: 3 layers, the third local attention) at full width,
    B 1, S 4096: the first bf16 step's loss within PART_BF16_TOL relative
    of the same weights' loss in fp32 on the card, and the flash
    backward's dq, dk, dv in that step, on the inputs the step passed it
    (q, k, v, o, dO and lse, recorded by :func:`recorded_backward`), held
    to the plain backward in fp32 at phase 3's bf16 limits
    (``parity.bwd_within_limits``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.kernels import parity
    from repro_torch.models.lm import LM
    from repro_torch.train import optimizer, train_step
    layers, b = TRAIN_RG_CHECK
    s = TRAIN_RG_SHAPE[1]
    cfg, cut = cut_depth(get_config(TRAIN_RG_ARCH), layers,
                         "one group of the pattern, for the checks")
    plan = Plan(remat="block", vocab_chunk=TRAIN_VOCAB_CHUNK)
    lm = watched_lm(cfg, 8, plan)
    batch = train_batch(cfg, b, s, 0)
    with torch.no_grad():
        lm32 = LM(dataclasses.replace(cfg, dtype="float32",
                                      param_dtype="float32"),
                  {n: p.detach().float() for n, p in lm.params().items()},
                  plan)
        loss32 = lm32.train_loss(batch)[0].item()
        del lm32
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=2)
    step_fn = train_step.make_train_step(lm, tcfg)
    with recorded_backward(ops) as calls:
        _, _, metrics = step_fn(lm.params(), optimizer.init(lm.params(),
                                                            tcfg), batch, 0)
    loss16 = metrics["loss"].item()
    rel = abs(loss16 - loss32) / abs(loss32)
    print(f"  (d) checks, {cut}, B={b} S={s}: first bf16 loss {loss16:.5f}, "
          f"the same weights in fp32 {loss32:.5f} (rel {rel:.2e}, limit "
          f"{PART_BF16_TOL:g}); {len(calls)} flash backward call(s) "
          f"recorded")
    require(rel <= PART_BF16_TOL, f"(d) the bf16 loss is {rel:.2e} from "
            f"the fp32 loss of the same weights")
    require(len(calls) == cfg.n_attention_layers, f"(d) the step made "
            f"{len(calls)} flash backward calls, not one an attention "
            f"layer")
    for (q, k, v, o, do, lse), kw, got in calls:
        want32 = parity.bwd_want32(q, k, v, o, do, **kw)
        ok, err, rerr = parity.bwd_within_limits(got, want32)
        print(f"  (d) the step's backward, q {list(q.shape)} k "
              f"{list(k.shape)} {q.dtype} {kw}: err {err:.3e} of max, "
              f"row_err {rerr:.3e} (limits {parity.BWD_ABS_TOL}, "
              f"{parity.BWD_ROW_TOL}) {'ok' if ok else 'MISMATCH'}")
        require(q.shape[-1] == 256 and q.dtype == torch.bfloat16,
                f"(d) the step's backward is not bf16 at D = 256")
        require(ok, f"(d) the step's flash backward disagrees with the "
                f"plain backward (abs {err:.3e}, row {rerr:.3e})")
    del lm, step_fn, calls, batch
    free_card()


def run_train(ops) -> dict:
    """Phase 13: (a') the parity cell, (b) granite-3-2b whole in bf16 with
    AdamW (fp32 moments, no master copy), TRAIN_STEPS timed steps, and (d)
    recurrentgemma-2b whole in bf16 at TRAIN_RG_SHAPE, TRAIN_RG_STEPS timed
    steps, whose attention backward runs the D = 256 tensor-core kernels
    (``train_cell``; (d)'s checks first, ``check_griffin_step``); (c)
    ``launch.train.main`` on reduced granite.  Returns the launches of (b)
    and (d), and (b)'s peak memory, profiled step's device ms (phase 17
    (d)) and mean step wall ms (phase 18)."""
    from repro_torch.configs import get_config
    check_train_parity(ops)
    free_card()
    b, s = TRAIN_SHAPE
    meas = train_cell(ops, "b", get_config(TRAIN_ARCH), b, s, TRAIN_STEPS, 6)
    run_train_cli()
    check_griffin_step(ops)
    b, s = TRAIN_RG_SHAPE
    griffin = train_cell(ops, "d", get_config(TRAIN_RG_ARCH), b, s,
                         TRAIN_RG_STEPS, 7)
    d256 = [n for n in griffin["kernels"] if "wgmma256" in n]
    cuda_cores = [n for n in griffin["kernels"]
                  if re.search(r"bwd_(dkdv|dq)_kernel", n)]
    print(f"  (d) the step's backward kernels: {[n[:50] for n in d256]}; "
          f"CUDA-core backward kernels: {cuda_cores or 'none'}")
    require(any("dkdv" in n for n in d256) and any("dq" in n for n in d256)
            and not cuda_cores, "(d) the step's flash backward did not run "
            "the D = 256 tensor-core kernels alone")
    launches = meas["launches"]
    for name, n in griffin["launches"].items():
        launches[name] = launches.get(name, 0) + n
    return launches, {k: meas[k] for k in ("peak_bytes", "device_ms",
                                           "wall_ms")}


def run_train_cli() -> None:
    """(c): ``repro_torch.launch.train.main`` on reduced granite-3-2b on
    the card, as tests/test_system.py:40-60: 25 steps whose loss falls by
    more than 0.2, then 10 steps saving every 5 and 15 that resume at step
    10 from the checkpoint, whose parameters equal the saved ones bit for
    bit."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.train import main as train_main
    with tempfile.TemporaryDirectory() as tmp:
        res = train_main(["--arch", TRAIN_ARCH, "--reduced", "--steps", "25",
                          "--batch", "4", "--seq", "64", "--save-every",
                          "10", "--ckpt-dir", f"{tmp}/a", "--log-every",
                          "100"])
        losses = [h["loss"] for h in res.metrics_history]
        print(f"  (c) launch.train --reduced, 25 steps: loss {losses[0]:.4f}"
              f" -> {losses[-1]:.4f}")
        require(losses[-1] < losses[0] - 0.2, "(c) the loss fell by 0.2 or "
                "less")
        args = ["--arch", TRAIN_ARCH, "--reduced", "--batch", "2", "--seq",
                "32", "--save-every", "5", "--ckpt-dir", f"{tmp}/b",
                "--log-every", "100"]
        first = train_main(["--steps", "10", *args])
        saved, extra = Checkpointer(f"{tmp}/b").restore(10, device="cuda")
        same = all(torch.equal(saved["params"][n], p.detach())
                   for n, p in first.state["params"].items())
        res = train_main(["--steps", "15", *args])
        steps = [h["step"] for h in res.metrics_history]
        print(f"  (c) 10 steps saved every 5, then resumed at step "
              f"{extra['next_step']}: steps {steps[0]}..{steps[-1]}, the "
              f"restored parameters {'bitwise equal to' if same else 'DIFFER from'}"
              f" the saved ones")
        require(same, "(c) the restored parameters differ from the saved")
        require(steps and min(steps) >= 10 and res.last_step == 15,
                "(c) the second run did not resume at step 10")


# ---------------------------------------------------------------------------
# phase 14: distribution
# ---------------------------------------------------------------------------

def run_dist(ops) -> dict:
    """Phase 14: (a) the pod-parallel step on one NCCL rank at full width,
    (b) two gloo ranks on the one card; returns (a)'s timed steps'
    launches."""
    launches = dist_pod_step(ops)
    free_card()
    dist_two_ranks()
    return launches


def dist_pod_step(ops, device="cuda") -> dict:
    """(a): granite-3-2b at full width, DIST_POD_LAYERS of its layers, in
    bf16 at 13 (b)'s shape, seed, plan and
    AdamW, on a ("pod", "data", "model") mesh of (1, 1, 1) over a one-rank
    NCCL group.  From the same state: the uncompressed pod step's loss,
    gradients and updated parameters bitwise equal to ``make_train_step``'s
    (both reductions are identities on one rank); the compressed step's
    reduced gradients within max|g| / 254 of each leaf's plain gradient
    (plus fp32 rounding: one rank's ``compressed_psum`` is the int8 round
    trip) and its error feedback exactly g - out; then a warm-up and
    DIST_STEPS timed compressed steps (losses finite and falling, the flash
    forward twice and the backward once a layer a step), step wall and
    device ms of the plain and the compressed pod step, the error
    feedback's bytes and the peak memory.  Returns the timed steps'
    launches."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.launch.mesh import init_local_group, make_test_mesh
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import grad_compression, optimizer, train_step
    from torch.profiler import ProfilerActivity
    cfg, cut = cut_depth(get_config(TRAIN_ARCH), DIST_POD_LAYERS,
                         "cut to pay for 13 (d)")
    b, s = TRAIN_SHAPE
    plan = Plan(remat="block", vocab_chunk=TRAIN_VOCAB_CHUNK)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=DIST_STEPS + 4)
    require(init_local_group(device), "(a) a process group already exists")
    # the compressed steps peak within 12 GiB of the card's memory (67.6
    # of 79.2 GiB on an H100 80GB): segments that grow in place keep
    # fragmentation from failing them (an out-of-memory there has been
    # seen with 11 GiB reserved but unallocated)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"),
                              device=device)
        gen = torch.Generator(device=device).manual_seed(6)
        lm = LM(cfg, init_params(cfg, gen, device), plan)
        params = lm.params()
        batches = [train_batch(cfg, b, s, i, device)
                   for i in range(DIST_STEPS + 2)]
        print(f"  (a) {TRAIN_ARCH}, {cut}, bf16, B={b} S={s}, remat block, "
              f"AdamW; {dist.get_backend()} group of "
              f"{dist.get_world_size()}, mesh {mesh}")
        # the gradients: the plain path and the pod path, uncompressed
        lm.requires_grad_(True)
        total, metrics = lm.train_loss(batches[0])
        g_plain = dict(zip(params, torch.autograd.grad(
            total, list(params.values()))))
        loss_plain = metrics["loss"].detach()
        g_pod, _, loss_pod, _ = train_step.make_pod_gradients(lm, mesh)(
            params, None, batches[0])
        differ = [n for n in g_plain if not torch.equal(g_plain[n], g_pod[n])]
        print(f"  (a) uncompressed pod gradients against the plain ones: "
              f"{len(g_plain) - len(differ)} of {len(g_plain)} leaves "
              f"bitwise equal; loss {loss_pod.item():.6f} against "
              f"{loss_plain.item():.6f}")
        require(not differ, f"(a) pod gradients differ: {differ[:3]}")
        require(torch.equal(loss_pod, loss_plain), "(a) the pod loss differs")
        del g_pod
        # the compressed gradients: the int8 round trip on one rank
        # the same weights (shared storage) under the compressing plan
        lm_c = LM(cfg, {n: p.detach() for n, p in params.items()},
                  dataclasses.replace(plan, grad_compression=True))
        ef0 = grad_compression.init_error_feedback(params)
        g_c, ef_c, _, _ = train_step.make_pod_gradients(lm_c, mesh)(
            lm_c.params(), ef0, batches[0])
        del ef0
        worst, ef_exact = 0.0, True
        for n, g in g_plain.items():
            gf = g.float()
            top = gf.abs().max().item()
            err = (g_c[n] - gf).abs().max().item()
            require(err <= top * (1 / 254 + 2 ** -22) + 1e-12,
                    f"(a) {n}: the int8 error {err:.3e} is past max|g|/254 "
                    f"= {top / 254:.3e}")
            worst = max(worst, err / max(top / 254, 1e-30))
            ef_exact &= torch.equal(ef_c[n], gf - g_c[n])
        print(f"  (a) compressed pod gradients: largest error "
              f"{worst:.4f} of each leaf's max|g|/254; error feedback "
              f"{'exactly' if ef_exact else 'NOT'} g - out")
        require(ef_exact, "(a) the error feedback is not g - out")
        del g_c, ef_c, g_plain, total, metrics
        free_card()
        # one step each from the same state
        snap = {n: p.detach().clone() for n, p in params.items()}
        _, _, m_plain = train_step.make_train_step(lm, tcfg)(
            params, optimizer.init(params, tcfg), batches[0], 0)
        after = {n: p.detach().clone() for n, p in params.items()}
        lm.load_params(snap)
        pod_step = train_step.make_pod_parallel_train_step(lm, tcfg, mesh)
        opt = optimizer.init(params, tcfg)
        _, opt, m_pod = pod_step(params, opt, batches[0], 0)
        differ = [n for n in after if not torch.equal(after[n], params[n])]
        print(f"  (a) one step from the same state: the pod step's "
              f"parameters {'bitwise equal to' if not differ else 'DIFFER from'}"
              f" make_train_step's ({len(after)} leaves), loss "
              f"{m_pod['loss'].item():.6f} against "
              f"{m_plain['loss'].item():.6f}")
        require(not differ, f"(a) updated parameters differ: {differ[:3]}")
        require(torch.equal(m_pod["loss"], m_plain["loss"]),
                "(a) the pod step's loss differs from make_train_step's")
        del after

        def timed(step_fn, model, state, first):
            walls, losses = [], []
            for i in range(DIST_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, state, m = step_fn(model.params(), state,
                                      batches[first + i], first + i)
                losses.append(m["loss"].item())
                walls.append((time.perf_counter() - t0) * 1e3)
            return state, walls, losses

        def device_ms(step_fn, model, state):
            def run():
                step_fn(model.params(), state, batches[-1], DIST_STEPS + 3)
            _, k = traced_kernels(run, [ProfilerActivity.CUDA])
            return sum(ms for _, ms in k)

        opt, plain_walls, _ = timed(pod_step, lm, opt, 1)
        plain_dev = device_ms(pod_step, lm, opt)
        del opt
        lm.load_params(snap)
        del snap
        free_card()
        # the compressed step from the initial weights: a warm-up,
        # DIST_STEPS timed
        pod_c = train_step.make_pod_parallel_train_step(lm_c, tcfg, mesh)
        opt_c = optimizer.init(lm_c.params(), tcfg)
        torch.cuda.reset_peak_memory_stats()
        _, opt_c, m0 = pod_c(lm_c.params(), opt_c, batches[0], 0)
        ops.reset_launch_counts()
        opt_c, walls, losses = timed(pod_c, lm_c, opt_c, 1)
        launches = ops.launch_counts()
        losses = [m0["loss"].item()] + losses
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / DIST_STEPS for k, v in launches.items() if v}
        comp_dev = device_ms(pod_c, lm_c, opt_c)
        ef_bytes = sum(t.nbytes for t in opt_c["ef"].values())
        print(f"  (a) compressed steps: losses {[round(x, 4) for x in losses]}"
              f" (warm-up first); launches a step {per_step}")
        require(all(np.isfinite(losses)), "(a) a compressed loss is not "
                "finite")
        require(losses[-1] < losses[0], f"(a) the compressed loss did not "
                f"fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
        require(per_step.get("flash_attention") == 2 * cfg.n_layers
                and per_step.get("flash_attention_bwd") == cfg.n_layers,
                f"(a) launches a step {per_step}, not {2 * cfg.n_layers} "
                f"flash forward and {cfg.n_layers} backward")
        print(f"  (a) pod step, plain: wall {np.mean(plain_walls):.1f} ms "
              f"(each {[round(w, 1) for w in plain_walls]}), device "
              f"{plain_dev:.1f} ms; compressed: wall {np.mean(walls):.1f} ms "
              f"(each {[round(w, 1) for w in walls]}), device "
              f"{comp_dev:.1f} ms; the int8 pass over "
              f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B "
              f"parameters costs {comp_dev - plain_dev:.1f} ms of device "
              f"time ({(comp_dev - plain_dev) / plain_dev:.1%}); error "
              f"feedback {ef_bytes / 2**30:.2f} GiB (fp32); peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
        del lm, lm_c, opt_c, params, batches
        return launches
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
        dist.destroy_process_group()


def dist_two_ranks() -> None:
    """(b): two processes on the one card over a gloo group (NCCL refuses
    two ranks on one device; card tensors pass gloo's point-to-point ops
    through host memory, ``dist.collectives``): the pod step, the pipeline
    and expert-parallel MoE, each rank checking its own numbers
    (``dist_rank``)."""
    from repro_torch.launch.mesh import run_ranks
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_ranks(dist_rank, 2, tmp, "cuda", backend="gloo", timeout_s=600)
        wall = time.perf_counter() - t0
        got = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(2)]
    for line in got[0]["lines"]:
        print(f"  (b) {line}")
    print(f"  (b) host-staged point-to-point ops (rank 0, rank 1): "
          f"{got[0]['staged']}, {got[1]['staged']}; two ranks' wall "
          f"{wall:.1f} s, start-up included")
    require(got[0]["sums"] == got[1]["sums"], "(b) the two ranks hold "
            "different gradients")


def dist_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One rank of (b): checks its numbers (a failure fails the phase) and
    writes its report to ``tmp``."""
    from repro_torch.dist import collectives as col
    if device == "cuda":
        torch.cuda.set_device(0)
    lines, sums = [], {}
    dist_rank_pod(rank, device, lines, sums)
    dist_rank_pipeline(rank, device, lines, sums)
    dist_rank_moe(rank, device, lines, sums)
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump({"lines": lines, "sums": sums,
                   "staged": col.staged_ops()}, f)


def _leaf_err(got, want) -> float:
    """Largest |got - want| of a leaf over the leaf's largest |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def dist_rank_pod(rank, device, lines, sums, arch=TRAIN_ARCH,
                  shape=DIST_POD) -> None:
    """The pod step of granite-3-2b at full width, fp32, pod = 2: the
    uncompressed gradients and one step's parameters within 2e-4 of each
    leaf's max of the plain step on the whole batch in this process;
    compressed, each leaf within max over pods of max|g_p| / 127 of the
    uncompressed mean and the pods' gradients less their error feedback
    summing to what was reduced."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import collectives as col
    from repro_torch.dist.plan import Plan
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import grad_compression, optimizer, train_step
    layers, b, s = shape
    cfg = dataclasses.replace(cut_depth(get_config(arch), layers)[0],
                              dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                       eps=1e-4)
    plan = Plan(remat="block")
    mesh = make_test_mesh((2,), ("pod",), device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    lm = LM(cfg, init_params(cfg, gen, device), plan)
    params = lm.params()
    batch = train_batch(cfg, b, s, 0, device)
    lm.requires_grad_(True)

    def grads_of(rows):
        total, _ = lm.train_loss({k: x[rows] for k, x in batch.items()})
        return dict(zip(params, torch.autograd.grad(
            total, list(params.values()))))

    whole = grads_of(slice(0, b))
    own = grads_of(slice(rank * b // 2, (rank + 1) * b // 2))
    g_pod, _, _, _ = train_step.make_pod_gradients(lm, mesh)(
        params, None, batch)
    worst_g = max(_leaf_err(g_pod[n], whole[n]) for n in whole)
    lm_c = LM(cfg, {n: p.detach() for n, p in params.items()},
              dataclasses.replace(plan, grad_compression=True))
    g_c, ef, _, _ = train_step.make_pod_gradients(lm_c, mesh)(
        lm_c.params(), grad_compression.init_error_feedback(params), batch)
    pod = mesh.get_group("pod")
    worst_c, worst_sent = 0.0, 0.0
    for n in whole:
        bound = col.all_reduce(own[n].abs().max(), op=dist.ReduceOp.MAX,
                               group=pod).item() / 127
        err = (g_c[n] - g_pod[n]).abs().max().item()
        require(err <= bound * 1.001 + 1e-7, f"(b) {n}: the compressed "
                f"gradient is {err:.3e} from the mean, past {bound:.3e}")
        worst_c = max(worst_c, err / max(bound, 1e-30))
        sent = col.all_reduce(own[n] - ef[n], group=pod)
        worst_sent = max(worst_sent, _leaf_err(sent, 2 * g_c[n]))
    require(worst_sent <= 1e-5, f"(b) the pods' gradients less their error "
            f"feedback are {worst_sent:.2e} from what was reduced")
    del whole, own, g_pod, g_c, ef
    snap = {n: p.detach().clone() for n, p in params.items()}
    _, _, m_plain = train_step.make_train_step(lm, tcfg)(
        params, optimizer.init(params, tcfg), batch, 0)
    after = {n: p.detach().clone() for n, p in params.items()}
    lm.load_params(snap)
    _, _, m_pod = train_step.make_pod_parallel_train_step(lm, tcfg, mesh)(
        params, optimizer.init(params, tcfg), batch, 0)
    worst_p = max(_leaf_err(params[n], after[n]) for n in after)
    lm.load_params(snap)
    _, _, m_c = train_step.make_pod_parallel_train_step(lm_c, tcfg, mesh)(
        lm_c.params(), optimizer.init(params, tcfg), batch, 0)
    finite = all(torch.isfinite(p).all().item() for p in params.values())
    rel = abs(m_pod["loss"].item() - m_plain["loss"].item()) / abs(
        m_plain["loss"].item())
    lines.append(
        f"pod step, {arch} {layers} layers fp32 B={b} S={s}, pod = 2: "
        f"gradients {worst_g:.2e} of each leaf's max from the whole-batch "
        f"step's, one step's parameters {worst_p:.2e}, loss rel {rel:.2e}; "
        f"compressed: {worst_c:.3f} of the int8 bound, sent less reduced "
        f"{worst_sent:.2e}, parameters {'finite' if finite else 'NOT finite'}"
        f", loss {m_c['loss'].item():.6f}")
    require(worst_g <= 2e-4 and worst_p <= 2e-4 and rel <= 1e-5,
            f"(b) the pod step is {worst_g:.2e} / {worst_p:.2e} / {rel:.2e} "
            f"from the whole-batch step")
    require(finite, "(b) the compressed step left a parameter not finite")
    sums["pod"] = [round(p.double().sum().item(), 6)
                   for p in params.values()]


def _allclose_err(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 passes."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def dist_rank_pipeline(rank, device, lines, sums, shape=DIST_PIPE) -> None:
    """``pipeline_apply`` (forward, and the gradients of ``(out *
    ct).sum()`` for the weights and the input) and
    ``make_pipeline_train_step`` over the two ranks at m in {1, S, 4S}
    for each of DIST_PIPE_CASES, in this process against
    ``sequential_apply`` on the same microbatches (the same products
    shapes, so the reference test's elementwise allclose applies: 1e-5
    forward, 1e-4 gradients, 1e-5 absolute) and on the whole batch (its
    products have other shapes and round otherwise: 1e-5 and 1e-4 of each
    tensor's max), and the step's loss and parameters against the
    sequential step's (1e-5; 1e-4 relative, 1e-5 absolute)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.pipeline import pipeline_apply, sequential_apply
    from repro_torch.dist.plan import Plan
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import optimizer, train_step
    d, b = shape
    mesh = make_test_mesh((2,), ("pod",), device=device)
    # eps 1e-4, as in 13 (a'): a first Adam step is g / (|g| + eps), which
    # at 1e-8 turns rounding in a near-zero gradient into a whole step
    tcfg = TrainConfig(lr=1e-2, warmup_steps=1, eps=1e-4)
    gen = torch.Generator(device=device).manual_seed(21)

    def stage(w, h):
        return torch.tanh(h @ w)

    def rnd(*sz):
        return torch.randn(sz, generator=gen, device=device)

    for sched, n_stages, v in DIST_PIPE_CASES:
        ws = rnd(n_stages, d, d) / d ** 0.5
        x, y, ct = rnd(b, d), rnd(b, d), rnd(b, d)

        def grads(fn):
            w = ws.clone().requires_grad_()
            xx = x.clone().requires_grad_()
            out = fn(w, xx)
            return (out.detach(),) + torch.autograd.grad(
                (out * ct).sum(), [w, xx])

        def trained(mesh_, plan):
            p = ws.clone()
            _, _, m = train_step.make_pipeline_train_step(
                stage, tcfg, mesh_, plan)(
                    p, optimizer.init({"stages": p}, tcfg), (x, y), 0)
            return p, m["loss"].item()

        whole = grads(lambda w, xx: sequential_apply(stage, w, xx))
        p_want, l_want = trained(None, Plan())
        for m in (1, n_stages, 4 * n_stages):
            got = grads(lambda w, xx: pipeline_apply(
                stage, w, xx, mesh, microbatches=m, schedule=sched,
                virtual_stages=v))
            want = grads(lambda w, xx: torch.cat([
                sequential_apply(stage, w, c) for c in xx.chunk(m)]))
            plan = Plan(microbatches=m, pipeline_schedule=sched,
                        virtual_stages=v)
            p_got, l_got = trained(mesh, plan)
            fwd = _allclose_err(got[0], want[0], 1e-5, 1e-5)
            bwd = max(_allclose_err(g, w, 1e-4, 1e-5)
                      for g, w in zip(got[1:], want[1:]))
            fwd_w = _leaf_err(got[0], whole[0]) / 1e-5
            bwd_w = max(_leaf_err(g, w) for g, w in zip(got[1:], whole[1:])
                        ) / 1e-4
            par = _allclose_err(p_got, p_want, 1e-4, 1e-5)
            lines.append(
                f"pipeline {sched}, {n_stages} stages (V={v}) on 2 ranks, "
                f"D={d} B={b} m={m}: of their limits, forward {fwd:.3f} and "
                f"gradients {bwd:.3f} against the same microbatches, "
                f"{fwd_w:.3f} and {bwd_w:.3f} against the whole batch, "
                f"step parameters {par:.3f}; loss {l_got:.6f} against "
                f"{l_want:.6f}")
            require(max(fwd, bwd, fwd_w, bwd_w, par) <= 1
                    and abs(l_got - l_want) <= 1e-5 * max(1.0, abs(l_want)),
                    f"(b) past its limits: {lines[-1]}")
            sums[f"pipe/{sched}/{m}"] = round(got[1].double().sum().item(),
                                              6)


def dist_rank_moe(rank, device, lines, sums, arch=DIST_MOE_ARCH,
                  shape=DIST_MOE_X) -> None:
    """``apply_moe_ep`` on the MoE layer at full width over model = 2 (half
    the experts a rank) against ``apply_moe`` on the whole input: y within
    1e-4, aux within 0.05 (a per-shard estimator, as
    tests/test_distributed.py holds it), every gradient nonzero."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    cfg = get_config(arch)
    mesh = make_test_mesh((2,), ("model",), device=device)
    gen = torch.Generator(device=device).manual_seed(22)
    p = moe.init_moe(cfg, gen, device, torch.float32)
    b, s = shape
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    ct = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    with torch.no_grad():
        y_ref, aux_ref = moe.apply_moe(p, cfg, x, groups=1)
    leaves = {f"{k}.{n}" if isinstance(v, dict) else k: t
              for k, v in p.items()
              for n, t in (v.items() if isinstance(v, dict) else [(k, v)])}
    for t in leaves.values():
        t.requires_grad_(True)
    x.requires_grad_(True)
    y, aux = moe.apply_moe_ep(p, cfg, x, rules=Rules(mesh))
    got = torch.autograd.grad((y * ct).sum() + aux,
                              [x, *leaves.values()])
    err = (y.detach() - y_ref).abs().max().item()
    zero = [n for n, g in zip(["x", *leaves], got) if not g.abs().sum() > 0]
    lines.append(
        f"expert-parallel MoE, {arch} layer at full width ({cfg.moe.n_experts}"
        f" experts, {cfg.moe.n_experts // 2} a rank, top {cfg.moe.top_k}), "
        f"x {list(x.shape)} fp32, model = 2: y {err:.2e} from apply_moe's, "
        f"aux {aux.item():.5f} against {aux_ref.item():.5f}, "
        f"{len(got)} gradients, {len(zero)} zero")
    require(err <= 1e-4, f"(b) expert-parallel y is {err:.2e} from "
            f"apply_moe's")
    require(abs(aux.item() - aux_ref.item()) <= 0.05, "(b) aux is off")
    require(not zero, f"(b) zero gradients: {zero}")
    sums["moe"] = [round(g.double().sum().item(), 6) for g in got]


# ---------------------------------------------------------------------------
# phase 15: automatic partitioning
# ---------------------------------------------------------------------------

def run_partition() -> dict:
    """Phase 15: two processes on the one card over a gloo group, each a
    rank of a ("data", "model") mesh of PART_MESH, granite-3-2b and (d)
    every other family at full width partitioned by ``Rules``
    (``part_rank``); each rank checks its own numbers, and both must hold
    the same losses and tokens.  Returns the kernel launches of the
    sharded runs, both ranks summed."""
    from repro_torch.launch.mesh import run_ranks
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_ranks(part_rank, 2, tmp, backend="gloo", timeout_s=600)
        wall = time.perf_counter() - t0
        got = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(2)]
    for r, rank in enumerate(got):
        print(f"  rank {r} collectives staged through host memory: "
              f"{rank['staged']}")
    print(f"  two ranks' wall {wall:.1f} s, start-up included")
    for key in got[0]["same"]:
        require(got[0]["same"][key] == got[1]["same"][key],
                f"(15) the two ranks disagree on {key}: "
                f"{got[0]['same'][key]} vs {got[1]['same'][key]}")
    return {k: got[0]["launches"].get(k, 0) + got[1]["launches"].get(k, 0)
            for k in ("flash_attention", "flash_attention_bwd",
                      "decode_attention")}


def part_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 15: (a), (b), (c), (d) on the mesh; writes its
    report to ``tmp`` (a failed check raises, and so fails the phase)."""
    from collections import Counter
    from repro_torch.dist import collectives as col
    from repro_torch.launch.mesh import make_test_mesh
    torch.cuda.set_device(0)
    mesh = make_test_mesh(PART_MESH, ("data", "model"), device="cuda")
    same, launches = {}, Counter()

    def note(line):         # printed as it comes, the rank first
        print(f"  rank {rank} {line}", flush=True)

    part_train_parity(mesh, note, same, launches)
    free_card()
    part_train_steps(mesh, note, same, launches)
    free_card()
    part_serve(mesh, note, same, launches)
    for spec in PART_FAMILIES:
        part_family(mesh, rank, spec, note, same, launches)
        free_card()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump({"same": same, "launches": launches,
                   "staged": col.staged_ops()}, f)


def part_lm(cfg, seed: int, plan, mesh):
    """The plain LM and the partitioned one over the same seeded weights
    (whole on every rank: the same generator on the same card)."""
    from repro_torch.dist.sharding import Rules
    from repro_torch.models.lm import LM, init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    plain = LM(cfg, {n: p.clone() for n, p in params.items()}, plan)
    return plain, LM(cfg, params, plan, rules=Rules(mesh, plan))


def part_train_parity(mesh, note, same, launches) -> None:
    """(a): PART_TRAIN in fp32, block remat: every gradient of
    ``train_loss`` gathered and one sharded ``make_train_step`` against the
    plain LM's in this process; the step's flash launches counted."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.dist.sharding import whole
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer, train_step
    layers, b, s = PART_TRAIN
    cfg = dataclasses.replace(cut_depth(get_config(TRAIN_ARCH), layers)[0],
                              dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                       eps=1e-4)
    plain, part = part_lm(cfg, 5, Plan(remat="block"), mesh)
    batch = train_batch(cfg, b, s, 0)
    out = {}
    for name, lm in (("plain", plain), ("part", part)):
        step = train_step.make_train_step(lm, tcfg)
        total, _ = lm.train_loss(batch)
        grads = [whole(g) for g in torch.autograd.grad(
            total, list(lm.params().values()))]
        ops.reset_launch_counts()
        params, _, metrics = step(lm.params(), optimizer.init(
            lm.params(), tcfg), batch, 0)
        n = ops.launch_counts()
        out[name] = (float(metrics["loss"]), grads,
                     [whole(p.detach()) for p in params.values()], n)
    launches.update(out["part"][3])
    (l_plain, g_plain, p_plain, _), (l_part, g_part, p_part, n) = \
        out["plain"], out["part"]
    rel = abs(l_part - l_plain) / abs(l_plain)
    worst_g = max(_leaf_err(a, c) for a, c in zip(g_part, g_plain))
    worst_p = max(_leaf_err(a, c) for a, c in zip(p_part, p_plain))
    heads = [str(t.placements) for t in (part.blocks[0].attn["wq"],
                                         part.blocks[0].attn["wk"])]
    note(f"(a) {layers} layers fp32 B={b} S={s}: step loss "
                 f"sharded {l_part:.7f}, plain {l_plain:.7f} (rel "
                 f"{rel:.2e}); {len(g_part)} gathered gradients, largest "
                 f"error {worst_g:.2e} of the leaf's max; updated params "
                 f"{worst_p:.2e}; wq, wk placements {heads}; launches "
                 f"{dict((k, v) for k, v in n.items() if v)}")
    require(rel <= 1e-5, f"(a) the sharded loss is {rel:.2e} from the "
            f"plain one")
    require(worst_g <= 2e-4, f"(a) a gathered gradient is {worst_g:.2e} of "
            f"its max from the plain one")
    require(worst_p <= 2e-4, f"(a) an updated parameter is {worst_p:.2e} of "
            f"its max from the plain one")
    require(n["flash_attention"] == 2 * layers
            and n["flash_attention_bwd"] == layers,
            f"(a) the sharded step launched {n}, not flash forward twice "
            f"and the backward once a layer")
    same["a_loss"] = l_part


def part_train_steps(mesh, note, same, launches) -> None:
    """(b): PART_STEPS in bf16, block remat: a warm-up and the timed steps
    (CUDA-synchronised wall), a profiled step's device time and heaviest
    host ops, the peak memory of this process."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.dist.sharding import Rules
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import optimizer, train_step
    from torch.profiler import ProfilerActivity
    layers, b, s, steps = PART_STEPS
    cfg = cut_depth(get_config(TRAIN_ARCH), layers)[0]
    plan = Plan(remat="block", vocab_chunk=TRAIN_VOCAB_CHUNK)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps + 3)
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(6), "cuda"), plan,
            rules=Rules(mesh, plan))
    step_fn = train_step.make_train_step(lm, tcfg)
    opt = optimizer.init(lm.params(), tcfg)
    batches = [train_batch(cfg, b, s, i) for i in range(steps + 2)]
    losses, walls = [], []
    for i in range(steps + 1):
        if i == 1:
            ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt, metrics = step_fn(lm.params(), opt, batches[i], i)
        losses.append(metrics["loss"].item())
        walls.append((time.perf_counter() - t0) * 1e3)
    n = ops.launch_counts()
    launches.update(n)
    prof, kernels = traced_kernels(
        lambda: step_fn(lm.params(), opt, batches[-1], steps + 1),
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    dev_ms = sum(ms for _, ms in kernels)
    host = sorted(((a.key, a.self_cpu_time_total / 1e3)
                   for a in prof.key_averages()), key=lambda kv: -kv[1])
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.mean(walls[1:]))
    note(f"(b) {layers} of {get_config(TRAIN_ARCH).n_layers} layers "
                 f"bf16 B={b} S={s}, block remat: losses "
                 f"{[round(x, 4) for x in losses]} (warm-up first); step "
                 f"wall {wall:.1f} ms (each {[round(w, 1) for w in walls[1:]]}"
                 f"), device {dev_ms:.1f} ms (a profiled step: "
                 f"{len(kernels)} kernels), idle share "
                 f"{max(0.0, 1 - dev_ms / wall):.1%}; peak memory "
                 f"{peak / 2**30:.2f} GiB; launches in the timed steps "
                 f"{dict((k, v) for k, v in n.items() if v)}; the profiled "
                 f"step's heaviest host ops by self time (ms) "
                 f"{[(k, round(ms, 1)) for k, ms in host[:6]]}")
    require(all(np.isfinite(losses)), "(b) a loss is not finite")
    require(losses[-1] < losses[0], f"(b) the loss did not fall: "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    require(n["flash_attention"] == 2 * layers * steps
            and n["flash_attention_bwd"] == layers * steps,
            f"(b) the timed steps launched {n}")
    same["b_losses"] = losses


def part_serve(mesh, note, same, launches) -> None:
    """(c): PART_SERVE in fp32, heads-sharded and with
    ``decode_kv_seq_shard``: a prefill and greedy decode steps through
    ``make_prefill_step`` / ``make_serve_step`` against the plain LM's."""
    from repro_torch.configs import get_config
    from repro_torch.dist.plan import Plan
    from repro_torch.kernels import ops
    from repro_torch.train import train_step
    layers, nreq, plen, cache_len, steps = PART_SERVE
    cfg = dataclasses.replace(cut_depth(get_config(TRAIN_ARCH), layers)[0],
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (nreq, plen), generator=gen,
                            device="cuda")

    def greedy(lm):
        logits, cache = train_step.make_prefill_step(lm, cache_len)(
            {"tokens": prompts})
        got, toks = [logits], []
        step = train_step.make_serve_step(lm)
        for i in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok)
            logits, cache = step(cache, tok, plen + i)
            got.append(logits)
        return got, torch.cat(toks, 1), cache

    for mode, kw in (("heads", {}), ("kv_seq",
                                     {"decode_kv_seq_shard": True})):
        plain, part = part_lm(cfg, 8, Plan(remat="none", **kw), mesh)
        with torch.no_grad():
            want, want_tok, _ = greedy(plain)
            ops.reset_launch_counts()
            got, tok, cache = greedy(part)
            n = ops.launch_counts()
        launches.update(n)
        err = max(max_abs_err(a, c) for a, c in zip(got, want))
        local = tuple(cache["attn"]["k"].to_local().shape)
        note(f"(c) {mode}: {layers} layers fp32, {nreq} prompts of "
                     f"{plen} into {cache_len} slots, {steps} greedy steps: "
                     f"logits max_abs_err {err:.2e} against the plain LM, "
                     f"tokens equal {torch.equal(tok, want_tok)}; this "
                     f"rank's cache [L, B, W, KV, D] {local} of "
                     f"{tuple(cache['attn']['k'].shape)}; launches "
                     f"{dict((k, v) for k, v in n.items() if v)}")
        require(err <= 1e-4, f"(c) {mode}: logits {err:.2e} from the plain "
                f"LM's")
        require(torch.equal(tok, want_tok), f"(c) {mode}: greedy tokens "
                f"differ from the plain LM's")
        require(n["decode_attention"] == layers * steps
                and n["flash_attention"] == layers,
                f"(c) {mode}: launched {n}, not the decode kernel once a "
                f"layer and step and flash once a layer")
        same["c_tokens"] = same.get("c_tokens", []) + tok.tolist()
        del plain, part, cache
        free_card()


def part_context(cfg, b: int, seed: int) -> dict:
    """A batch's seeded context (the VLM's image embeddings, the audio
    frames; nothing for the other families) on the card."""
    from repro_torch.launch.serve import request_extras
    parts = [request_extras(cfg, seed, i) for i in range(b)]
    return {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
            .cuda() for k in parts[0]}


def part_family(mesh, rank: int, spec, note, same, launches) -> None:
    """(d), one family: ``PART_FAMILY_TRAIN`` and ``PART_FAMILY_SERVE``
    through ``make_train_step`` and a prefill with greedy decode steps,
    the partitioned LM against the plain one from the same seeded weights
    (whole on the card, in this process; the two ranks take turns at the
    plain run where it is large): the train step's loss and each updated
    parameter (this rank's shard against the plain one's slice), the
    logits of the prefill and each step (the plain LM's tokens fed to
    both) and the greedy tokens; the partitioned runs' kernel launches
    counted."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.dist.sharding import Rules
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import optimizer, train_step
    label, arch, layers, dtype, kw, mode, train_n, prefill_n, step_n = spec
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cut = {"encoder_layers": layers} if full.family == "audio" else {}
    cfg = dataclasses.replace(full, n_layers=layers, dtype=dtype,
                              param_dtype=dtype, **cut)
    plan = Plan(remat="block", decode_kv_seq_shard=mode == "kv_seq", **kw)
    rules = Rules(mesh, plan)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                       eps=1e-4, master_dtype=dtype)
    b, s = PART_FAMILY_TRAIN
    nreq, plen, cache_len, steps = PART_FAMILY_SERVE
    seed = 20 + [f[0] for f in PART_FAMILIES].index(label)
    batch = dict(train_batch(cfg, b, s, 0), **part_context(cfg, b, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, (nreq, plen),
                                       generator=gen, device="cuda"),
               **part_context(cfg, nreq, seed + 100)}

    def fresh():
        return init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), "cuda")

    elem = torch.finfo(getattr(torch, dtype)).bits // 8
    turns = 4 * cfg.n_params() * elem > PART_TURNS_BYTES
    want = None
    for turn in range(2):
        if (turn == rank) if turns else turn == 0:
            want = part_family_plain(cfg, plan, rules, tcfg, fresh(), batch,
                                     prompts, cache_len, steps)
            free_card()
        if turns:
            dist.barrier()
    plain_s = time.perf_counter() - t0

    part = LM(cfg, fresh(), plan, rules=rules)
    free_card()
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, cache = part.prefill(prompts, cache_len)
        got, written = [logits], []
        for i in range(steps):
            logits, cache = part.decode_step(cache, want["tokens"][:, i:i + 1],
                                             plen + i)
            got.append(logits)
            if plan.kv_cache_quant:
                written.append({k: cache["attn"][k].full_tensor()
                                for k in ("k", "v")})
    n_serve = ops.launch_counts()
    del cache
    step = train_step.make_train_step(part, tcfg)
    ops.reset_launch_counts()
    params, _, metrics = step(part.params(), optimizer.init(part.params(),
                                                            tcfg), batch, 0)
    n_train = ops.launch_counts()
    launches.update(n_serve)
    launches.update(n_train)
    loss = float(metrics["loss"])
    floor = 1e-4 * max(m for _, m in want["slices"].values())
    worst_p = max(
        ((p.to_local().float() - w.float()).abs().max().item()
         / max(m, floor)) for (p, (w, m)) in
        ((params[n], want["slices"][n]) for n in params))
    rel = abs(loss - want["loss"]) / abs(want["loss"])
    errs, flips, probs = [], [], []
    for i, (a, c) in enumerate(zip(got, want["logits"])):
        err = max_abs_err(a, c)
        if dtype == "bfloat16":
            err /= c.abs().max().item()
        moved = 0
        if plan.kv_cache_quant and i:
            moved = sum(int((written[i - 1][k] != want["written"][i - 1][k])
                            .sum()) for k in ("k", "v"))
        if moved:
            probs.append(max_abs_err(a.softmax(-1), c.softmax(-1)))
        flips.append(moved)
        errs.append(err)
    tokens = torch.cat([g.argmax(-1, keepdim=True) for g in got[:-1]], 1)
    same_tok = torch.equal(tokens, want["tokens"])
    peak = torch.cuda.max_memory_allocated()
    note(f"(d) {label}: {arch} full width, {layers} of {full.n_layers} "
         f"layers{' (and encoder layers)' if cut else ''}, {dtype}, "
         f"{mode}-sharded decode; train B={b} S={s}: loss sharded "
         f"{loss:.7f}, plain {want['loss']:.7f} (rel {rel:.2e}); updated "
         f"params, this rank's shards, largest error {worst_p:.2e} of the "
         f"leaf's max; serve {nreq} prompts of {plen} into {cache_len} "
         f"slots, {steps} steps: logits max_abs_err "
         f"{'of their largest ' if dtype == 'bfloat16' else ''}"
         f"{[float(f'{e:.2e}') for e in errs]} (prefill first), tokens "
         f"equal {same_tok}"
         + (f", int8 values written unlike the plain LM's a step "
            f"{flips[1:]}, probabilities there within {max(probs):.2e}"
            if probs else "")
         + f"; launches serve {dict((k, v) for k, v in n_serve.items() if v)}"
         f", train {dict((k, v) for k, v in n_train.items() if v)}; "
         f"plain reference {'in turns' if turns else 'alongside'} "
         f"{plain_s:.1f} s, the family {time.perf_counter() - t0:.1f} s, "
         f"peak memory {peak / 2**30:.2f} GiB")
    if dtype == "bfloat16":
        tol_loss = tol_p = tol_logits = PART_BF16_TOL
    else:
        tol_loss, tol_p, tol_logits = 1e-5, 2e-4, 1e-4
        require(same_tok, f"(d) {label}: greedy tokens differ from the "
                f"plain LM's")
    require(rel <= tol_loss, f"(d) {label}: the sharded loss is {rel:.2e} "
            f"from the plain one")
    require(worst_p <= tol_p, f"(d) {label}: an updated parameter is "
            f"{worst_p:.2e} of its leaf's max from the plain one")
    for e, moved in zip(errs, flips):
        require(e <= tol_logits or moved, f"(d) {label}: logits {e:.2e} "
                f"from the plain LM's")
    require(all(p < 0.05 for p in probs), f"(d) {label}: int8 "
            f"probabilities {probs} from the plain LM's")
    fwd, bwd = train_n
    require(n_train["flash_attention"] == fwd
            and n_train["flash_attention_bwd"] == bwd,
            f"(d) {label}: the train step launched {n_train}, not flash "
            f"{fwd} and its backward {bwd}")
    require(n_serve["flash_attention"] == prefill_n
            and n_serve["decode_attention"] == step_n * steps,
            f"(d) {label}: serving launched {n_serve}, not flash "
            f"{prefill_n} and decode {step_n} a step")
    same[f"d_{label}"] = [loss] + tokens.flatten().tolist()
    del part, params, step


def part_family_plain(cfg, plan, rules, tcfg, params, batch, prompts,
                      cache_len: int, steps: int) -> dict:
    """The plain LM of (d) on ``params``: the prefill's and greedy steps'
    logits and tokens (and, under the int8 cache, the K/V each step
    leaves), then one train step's loss and, of each updated parameter,
    the slice this rank's shard holds under ``rules`` and the leaf's
    largest magnitude."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.models.lm import LM, param_axes
    from repro_torch.train import optimizer, train_step
    lm = LM(cfg, params, plan)
    plen = prompts["tokens"].shape[1]
    with torch.no_grad():
        logits, cache = lm.prefill(prompts, cache_len)
        got, toks, written = [logits], [], []
        for i in range(steps):
            toks.append(logits.argmax(-1, keepdim=True))
            logits, cache = lm.decode_step(cache, toks[-1], plen + i)
            got.append(logits)
            if plan.kv_cache_quant:
                written.append({k: cache["attn"][k].clone()
                                for k in ("k", "v")})
    del cache
    step = train_step.make_train_step(lm, tcfg)
    params, _, metrics = step(lm.params(), optimizer.init(lm.params(), tcfg),
                              batch, 0)
    axes = param_axes(cfg)
    slices = {}
    for n, p in params.items():
        pl = rules.sharding(axes[n], tuple(p.shape)).placements
        shape, off = compute_local_shape_and_global_offset(
            p.shape, rules.mesh, pl)
        part = p.detach()[tuple(slice(o, o + k) for o, k in zip(off, shape))]
        slices[n] = (part.clone(), p.detach().abs().max().item())
    return {"loss": float(metrics["loss"]), "logits": got,
            "tokens": torch.cat(toks, 1), "written": written,
            "slices": slices}


# ---------------------------------------------------------------------------
# phase 16: the pod-parallel step partitioned inside each pod
# ---------------------------------------------------------------------------

def run_pod_partition() -> dict:
    """Phase 16: four processes on the one card over a gloo group, each a
    rank of a ("pod", "data", "model") mesh of POD_PART_MESH, granite-3-2b
    at full width built with ``Rules`` (partitioned on its pod's ("data",
    "model") sub-mesh: 16 of 32 heads a rank), 2 layers in fp32
    (``pod_part_rank``); each rank checks its own numbers, and all must
    hold the same losses.  Returns the flash launches of the partitioned
    pod steps, the ranks summed."""
    from repro_torch.launch.mesh import run_ranks
    world = int(np.prod(POD_PART_MESH))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_ranks(pod_part_rank, world, tmp, backend="gloo", timeout_s=600)
        wall = time.perf_counter() - t0
        got = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(world)]
    print(f"  {world} ranks' wall {wall:.1f} s, start-up included")
    for r in range(1, world):
        require(got[r]["same"] == got[0]["same"], f"(16) rank {r} holds "
                f"other losses than rank 0: {got[r]['same']} vs "
                f"{got[0]['same']}")
    return {k: sum(g["launches"].get(k, 0) for g in got)
            for k in ("flash_attention", "flash_attention_bwd")}


def pod_part_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 16 (a failed check raises, and so fails the
    phase): the partitioned pod step's gradients and one step against the
    whole-batch step of the same LM unpartitioned in this process, the
    compressed gradients against the plain ones within the int8 bound, the
    placements and shard shapes, then POD_PART_STEPS timed steps."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import collectives as col
    from repro_torch.dist.plan import Plan
    from repro_torch.dist.sharding import Rules, whole
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import LM, init_params, param_axes
    from repro_torch.train import grad_compression, optimizer, train_step
    from torch.profiler import ProfilerActivity
    torch.cuda.set_device(0)
    mesh = make_test_mesh(POD_PART_MESH, ("pod", "data", "model"),
                          device="cuda")
    layers, b, s = POD_PART_TRAIN
    cfg = dataclasses.replace(cut_depth(get_config(TRAIN_ARCH), layers)[0],
                              dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                       eps=1e-4)
    plan = Plan(remat="block")
    cplan = dataclasses.replace(plan, grad_compression=True)
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(8),
                          "cuda")
    batch = train_batch(cfg, b, s, 0)
    pods = POD_PART_MESH[0]
    pod = dict(zip(("pod", "data", "model"), mesh.get_coordinate()))["pod"]

    def note(line):
        print(f"  rank {rank} {line}", flush=True)

    # the plain LM in this process: the whole batch's and this pod's
    # gradients, and the whole-batch step
    plain = LM(cfg, {n: p.clone() for n, p in params0.items()}, plan)
    plain.requires_grad_(True)
    pp = plain.params()

    def grads_of(rows):
        total, _ = plain.train_loss({k: x[rows] for k, x in batch.items()})
        return dict(zip(pp, torch.autograd.grad(total, list(pp.values()))))

    g_whole = grads_of(slice(0, b))
    g_own = grads_of(slice(pod * b // pods, (pod + 1) * b // pods))
    _, _, m_plain = train_step.make_train_step(plain, tcfg)(
        pp, optimizer.init(pp, tcfg), batch, 0)
    p_plain = {n: p.detach().clone() for n, p in pp.items()}
    del plain, pp
    free_card()

    part = LM(cfg, {n: p.clone() for n, p in params0.items()}, plan,
              rules=Rules(mesh, plan))
    part_c = LM(cfg, params0, cplan, rules=Rules(mesh, cplan))
    require(part.partitioned and part.rules.mesh.mesh_dim_names
            == ("data", "model"), "(16) the LM is not partitioned on its "
            "pod's (data, model) sub-mesh")
    ops.reset_launch_counts()
    g_pod, _, loss_pod, _ = train_step.make_pod_gradients(part, mesh)(
        part.params(), None, batch)
    ef0 = grad_compression.init_error_feedback(part_c.params())
    g_c, ef, _, _ = train_step.make_pod_gradients(part_c, mesh)(
        part_c.params(), ef0, batch)
    n = ops.launch_counts()
    worst_g = max(_leaf_err(whole(g_pod[k]), g_whole[k]) for k in g_whole)
    # compressed: each shard within max over pods of max|g_p| / 127 of the
    # plain mean (each pod's code within half its scale, the re-rounding
    # to the pods' largest within half of that)
    pod_group = mesh.get_group("pod")
    worst_c, shards = 0.0, []
    for k, want in g_pod.items():
        bound = col.all_reduce(g_own[k].abs().max(), op=dist.ReduceOp.MAX,
                               group=pod_group).item() / 127
        err = (g_c[k].to_local() - want.to_local()).abs().max().item()
        worst_c = max(worst_c, err / max(bound, 1e-30))
        p = part.params()[k]
        shards.append((k, tuple(p.to_local().shape), tuple(p.shape),
                       tuple(ef[k].to_local().shape)))
    require(worst_c <= 1.001, f"(16) a compressed gradient is {worst_c:.3f} "
            f"of its int8 bound from the plain one")
    # placements: each leaf's local shape its share of the devices its
    # spec names (a heads, ff or vocab leaf split over "model"), the error
    # feedback shard-shaped
    sizes = dict(zip(("pod", "data", "model"), POD_PART_MESH))
    for k, local, full, ef_local in shards:
        axes = param_axes(cfg)[k]
        split = int(np.prod([sizes[a] for e in part.rules.spec(axes, full)
                             for a in ((e,) if isinstance(e, str)
                                       else e or ())]))
        require(int(np.prod(local)) * split == int(np.prod(full))
                and ef_local == local, f"(16) {k}: local {local} of "
                f"{full}, error feedback {ef_local}")
        require(split > 1 or not {"heads", "ff", "vocab"} & set(axes),
                f"(16) {k} {axes} is whole on every rank")
    del g_pod, g_c, ef, ef0, g_own, part_c
    free_card()
    # one step against the whole-batch step
    step = train_step.make_pod_parallel_train_step(part, tcfg, mesh)
    opt = optimizer.init(part.params(), tcfg)
    ops.reset_launch_counts()
    params, opt, m = step(part.params(), opt, batch, 0)
    n_step = ops.launch_counts()
    rel = abs(m["loss"].item() - m_plain["loss"].item()) / abs(
        m_plain["loss"].item())
    worst_p = max(_leaf_err(whole(params[k].detach()), p_plain[k])
                  for k in p_plain)
    require(rel <= 1e-5 and worst_g <= 2e-4 and worst_p <= 2e-4,
            f"(16) the partitioned pod step is {rel:.2e} (loss) / "
            f"{worst_g:.2e} (gradients) / {worst_p:.2e} (parameters) from "
            f"the whole-batch step")
    require(n_step["flash_attention"] == 2 * layers
            and n_step["flash_attention_bwd"] == layers,
            f"(16) the pod step launched {n_step}, not the flash forward "
            f"twice and the backward once a layer")
    wq = part.blocks[0].attn["wq"]
    note(f"{layers} layers fp32 B={b} S={s} on (pod, data, model) "
         f"{POD_PART_MESH}: loss {m['loss'].item():.7f}, whole-batch step "
         f"{m_plain['loss'].item():.7f} (rel {rel:.2e}); gradients "
         f"{worst_g:.2e} and one step's parameters {worst_p:.2e} of each "
         f"leaf's max from the whole-batch step's; compressed "
         f"{worst_c:.3f} of the int8 bound; wq {tuple(wq.to_local().shape)}"
         f" of {tuple(wq.shape)} {wq.placements}; launches of the two "
         f"pod-gradient calls {dict((k, v) for k, v in n.items() if v)}")
    # the timed steps
    torch.cuda.reset_peak_memory_stats()
    batches = [train_batch(cfg, b, s, i) for i in range(1, POD_PART_STEPS + 2)]
    walls = []
    for i in range(POD_PART_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i], i + 1)
        m["loss"].item()
        walls.append((time.perf_counter() - t0) * 1e3)
    n_timed = ops.launch_counts()
    staged = dict(col.staged_ops())
    _, kernels = traced_kernels(
        lambda: step(params, opt, batches[-1], POD_PART_STEPS + 1),
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    dev_ms = sum(ms for _, ms in kernels)
    peak = torch.cuda.max_memory_allocated()
    note(f"{POD_PART_STEPS} timed steps: wall {[round(w, 1) for w in walls]}"
         f" ms, device {dev_ms:.1f} ms (a profiled step: {len(kernels)} "
         f"kernels), idle share {max(0.0, 1 - dev_ms / np.mean(walls)):.1%}"
         f"; peak memory {peak / 2**30:.2f} GiB; collectives staged through "
         f"host memory so far {staged}")
    require(n_timed["flash_attention"] == 2 * layers * (POD_PART_STEPS + 1)
            and n_timed["flash_attention_bwd"]
            == layers * (POD_PART_STEPS + 1),
            f"(16) the timed steps launched {n_timed}")
    launches = {k: n[k] + n_timed[k]
                for k in ("flash_attention", "flash_attention_bwd")}
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump({"same": [round(loss_pod.item(), 6),
                            round(m["loss"].item(), 6)],
                   "launches": launches}, f)


# ---------------------------------------------------------------------------
# phase 17: static analysis and the dry run
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 18: logit soft caps on the LM
# ---------------------------------------------------------------------------

def run_softcap(ops, train_meas) -> dict:
    """Phase 18: (a) granite-3-2b at full width, 2 layers in fp32, under a
    cap of SOFTCAP_PARITY: 4 requests through the captured batcher on the
    card and the batcher on the CPU must give the same tokens, the capped
    prefill logits must differ from the uncapped LM's on the same weights
    far past the 1e-5 limit, and one train step must hold 13 (a')'s limits
    against the CPU's; (b) the whole model in bf16 under Gemma 2's cap of
    SOFTCAP_GEMMA: 4 requests of phase 6's prompts, SOFTCAP_SERVE_GEN
    tokens each, through the captured engine, beside the same weights
    uncapped (decode ms a step, peak memory), then SOFTCAP_TRAIN_STEPS
    timed steps at 13 (b)'s shape in a child process
    (:func:`softcap_train_child`: wall and device ms a step, peak memory,
    beside 13 (b)'s).  Returns the flash, backward and decode launches of
    (a)'s engine and step and (b)'s engines and steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.power import envelope_for
    from repro_torch.serve import ContinuousBatcher
    cfg = get_config(TRAIN_ARCH)
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    cap = SOFTCAP_PARITY
    cfg_a = dataclasses.replace(cut_depth(cfg, 2)[0], dtype="float32",
                                param_dtype="float32", logit_softcap=cap)
    cache_len = max(SOFTCAP_PROMPTS) + max(SOFTCAP_GENS)
    print(f" (a) {TRAIN_ARCH} full width, 2 layers, float32, logit soft cap "
          f"{cap:g}: {len(SOFTCAP_GENS)} requests, prompts "
          f"{SOFTCAP_PROMPTS}, max_gen {SOFTCAP_GENS}, {SERVE_SLOTS} slots, "
          f"cache_len {cache_len}; the card's captured batcher against the "
          f"CPU's")
    lm = watched_lm(cfg_a, seed=18)
    reqs = serve_trace(cfg_a, SOFTCAP_GENS, seed=18, prompts=SOFTCAP_PROMPTS)
    _, out, wall, launches = serve_engine(ops, lm, reqs, "18 a",
                                          cache_len=cache_len)
    add(launches)
    cpu = LM(cfg_a, {n: p.detach().cpu() for n, p in lm.params().items()})
    t0 = time.perf_counter()
    want = ContinuousBatcher(cpu, n_slots=SERVE_SLOTS, cache_len=cache_len,
                             envelope=envelope_for(None)).run(reqs)
    cpu_s = time.perf_counter() - t0
    same = [np.array_equal(out[r.rid], want[r.rid]) for r in reqs]
    print(f"  (a) tokens identical to the CPU batcher's (the plain "
          f"versions) for {sum(same)}/{len(reqs)} requests; card {wall:.2f} "
          f"s, CPU {cpu_s:.2f} s")
    require(all(same), "(18 a) the card's capped tokens differ from the "
            "CPU's")
    plain = LM(dataclasses.replace(cfg_a, logit_softcap=0.0), lm.params())
    batch = request_batch(reqs[1])
    capped_logits = lm.prefill(batch, cache_len)[0]
    plain_logits = plain.prefill(batch, cache_len)[0]
    moved = max_abs_err(capped_logits, plain_logits)
    flips = sum(int((out[r.rid] != generate_plain(plain, r, cache_len)
                     ).sum()) for r in reqs[:2])
    print(f"  (a) the cap moves a {reqs[1].prompt_len}-token prefill's "
          f"logits by {moved:.3e} (the limit is 1e-5); {flips} of the first "
          f"two requests' {sum(r.max_gen for r in reqs[:2])} tokens differ "
          f"uncapped")
    require(moved > 1e3 * 1e-5, "(18 a) the cap does not move the logits "
            "past the parity limit")
    del lm, plain, cpu
    free_card()
    ops.reset_launch_counts()
    check_train_parity(ops, softcap=cap, label="18 a", batch_size=1)
    add(ops.launch_counts())
    free_card()

    cap = SOFTCAP_GEMMA
    cfg_b = dataclasses.replace(cfg, logit_softcap=cap)
    print(f" (b) {TRAIN_ARCH} whole ({cfg.n_layers} layers), bfloat16, logit "
          f"soft cap {cap:g} (Gemma 2's, arXiv:2408.00118): 4 requests of "
          f"prompts {SERVE_PROMPTS}, max_gen {SOFTCAP_SERVE_GEN}, on the "
          f"captured engine; then {SOFTCAP_TRAIN_STEPS} train steps at B="
          f"{TRAIN_SHAPE[0]} S={TRAIN_SHAPE[1]}")
    torch.cuda.reset_peak_memory_stats()
    lm = watched_lm(cfg_b, seed=19)
    plain = watched_lm(dataclasses.replace(cfg_b, logit_softcap=0.0), 19,
                       params=lm.params())
    reqs = serve_trace(cfg_b, (SOFTCAP_SERVE_GEN,) * 4, seed=19)
    steps = {}
    for what, m in (("uncapped", plain), (f"cap {cap:g}", lm)):
        engine, out, wall, launches = serve_engine(ops, m, reqs,
                                                   f"18 b, {what}")
        add(launches)
        steps[what] = step_times(engine, m, SERVE_PROMPTS, f"18 b, {what}",
                                 eager_too=False, profile=False)
        del engine
    peak = torch.cuda.max_memory_allocated()
    print(f"  (b) decode step over {SERVE_SLOTS} slots, graph replay, ms "
          f"wall / CUDA events: " + ", ".join(
              f"{w} {a:.3f} / {e:.3f}" for w, (a, e) in steps.items())
          + f"; serving peak {peak / 2**30:.2f} GiB (both engines); "
          f"launches of the capped engine {launches}")
    del lm, plain
    free_card()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.json")
        subprocess.run([sys.executable, "-c", "import chip_smoke; "
                        f"chip_smoke.softcap_train_child({path!r})"],
                       cwd=ROOT, check=True, timeout=300)
        with open(path) as f:
            got = json.load(f)
    add(got["launches"])
    per_step = {k: n / SOFTCAP_TRAIN_STEPS
                for k, n in got["launches"].items() if n}
    print(f"  (b) in a child process: losses "
          f"{[round(x, 4) for x in got['losses']]} (warm-up first); step "
          f"wall {got['wall_ms']:.1f} ms, device {got['device_ms']:.1f} ms "
          f"(a profiled step), peak memory {got['peak'] / 2**30:.2f} GiB; "
          f"13 (b) uncapped in this run: wall {train_meas['wall_ms']:.1f}, "
          f"device {train_meas['device_ms']:.1f}, peak "
          f"{train_meas['peak_bytes'] / 2**30:.2f} GiB; launches a step "
          f"{per_step}")
    require(all(np.isfinite(got["losses"])), "(18 b) a training loss is not "
            "finite")
    require(per_step.get("flash_attention") == 2 * cfg.n_layers
            and per_step.get("flash_attention_bwd") == cfg.n_layers,
            f"(18 b) launches a step {per_step}, not {2 * cfg.n_layers} "
            f"flash forward and {cfg.n_layers} backward")
    return total


def softcap_train_child(path: str) -> None:
    """Phase 18 (b)'s training, in a process of its own: a profiler trace
    late in a long process loses its first records past any pad
    (``traced_kernels``; run 29B), so the device time of the capped step
    is taken in a fresh one.  granite-3-2b whole in bf16 under Gemma 2's
    cap at 13 (b)'s shape: a warm-up step, SOFTCAP_TRAIN_STEPS timed steps
    (synchronised wall), a profiled step's device time (its kernels,
    summed as 13 (b)'s), the peak memory and the launches of the timed
    steps, written to ``path``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer, train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              logit_softcap=SOFTCAP_GEMMA)
    b, s = TRAIN_SHAPE
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=SOFTCAP_TRAIN_STEPS + 2)
    lm = watched_lm(cfg, 20, Plan(remat="block",
                                  vocab_chunk=TRAIN_VOCAB_CHUNK))
    step_fn = train_step.make_train_step(lm, tcfg)
    opt = optimizer.init(lm.params(), tcfg)
    batches = [train_batch(cfg, b, s, i)
               for i in range(SOFTCAP_TRAIN_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i, batch in enumerate(batches):
        if i == 1:
            ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt, metrics = step_fn(lm.params(), opt, batch, i)
        losses.append(metrics["loss"].item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    # the kernels of one profiled step, as train_split sums 13 (b)'s: the
    # ``train.*`` ranges the trace also lists on the device are left out
    from torch.profiler import ProfilerActivity
    _, traced = traced_kernels(
        lambda: step_fn(lm.params(), opt, batches[-1],
                        SOFTCAP_TRAIN_STEPS + 1),
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    dev_ms = sum(ms for n, ms in traced if not n.startswith("train."))
    with open(path, "w") as f:
        json.dump({"losses": losses, "wall_ms": float(np.mean(walls[1:])),
                   "device_ms": dev_ms, "launches": launches,
                   "peak": torch.cuda.max_memory_allocated()}, f)


def generate_plain(lm, r, cache_len: int) -> np.ndarray:
    """Batch-1 ``generate`` of one request's tokens (18 (a)'s uncapped
    comparison)."""
    from repro_torch.launch.serve import generate
    return generate(lm, request_batch(r), r.prompt_len, r.max_gen,
                    cache_len)[0].cpu().numpy()


# ---------------------------------------------------------------------------
# phase 19: the examples
# ---------------------------------------------------------------------------

def start_autoplan(tmp: str) -> subprocess.Popen:
    """Start :func:`autoplan_child` in its own process (its fake process
    group stays out of every other phase's), writing to ``tmp``."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.autoplan_child({tmp!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def autoplan_child(tmp: str) -> None:
    """Phase 19's child: ``python -m repro_torch.autoplan_model`` at
    EXAMPLE_AUTOPLAN on the card's device type, twice over one disk cache
    in ``tmp``; for each run the structural key of every candidate whose
    step was built (one build a trace), the cache's stats, the kernel
    launches and the card bytes allocated while it ran (both must stay 0),
    and its seconds.  Writes ``tmp/autoplan.json``."""
    from repro_torch import autoplan_model
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    # two tracing threads of one core's Python, beside the build's nvcc
    # processes and the dry-run child (run 29B, with four threads and the
    # default intra-op threads, slowed the build from 80 to 131 s)
    torch.set_num_threads(1)
    keys = []
    build = dryrun.build_step

    def counting(cfg, shape, mesh, plan, device=None):
        keys.append(repr(plan.structural_key()))
        return build(cfg, shape, mesh, plan, device)
    dryrun.build_step = counting
    gens, pop = EXAMPLE_AUTOPLAN
    runs = []
    for _ in range(2):
        before, held = ops.launch_counts(), torch.cuda.memory_allocated()
        keys.clear()
        t0 = time.perf_counter()
        _, best, st = autoplan_model.main(
            ["--generations", str(gens), "--population", str(pop),
             "--compile-workers", "2",
             "--cache-dir", os.path.join(tmp, "autoplan")])
        runs.append({"wall_s": time.perf_counter() - t0, "keys": list(keys),
                     "stats": st.to_dict(), "best_s": best.time_s,
                     "launches": {k: v - before[k] for k, v in
                                  ops.launch_counts().items()
                                  if v != before[k]},
                     "allocated": torch.cuda.memory_allocated() - held})
    with open(os.path.join(tmp, "autoplan.json"), "w") as f:
        json.dump(runs, f)


def finish_autoplan(proc: subprocess.Popen, tmp: str) -> list:
    """Wait for the child (at most EXAMPLE_TIMEOUT s) and read its runs;
    its output's tail is printed."""
    try:
        log, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"(19) the autoplan child ran past "
                           f"{EXAMPLE_TIMEOUT} s")
    tail = "\n".join(log.splitlines()[-40:])
    require(proc.returncode == 0, f"(19) the autoplan child failed:\n{tail}")
    print("\n".join(line for line in log.splitlines()[-18:]
                    if "Warning" not in line))
    with open(os.path.join(tmp, "autoplan.json")) as f:
        return json.load(f)


def run_examples(ops, autoplan: list, tmp: str) -> dict:
    """Phase 19: ``repro_torch.autoplan_model`` (its child's two runs: no
    launch and no card byte, at most one trace per unique structural key,
    none on the warm disk cache), then on the card ``serve_lm --trace 6``
    over its trio (every request complete), ``train_lm --steps
    EXAMPLE_TRAIN_STEPS`` (the loss falls by 0.2, no restart) and
    ``train_lm --wide --steps EXAMPLE_WIDE_STEPS`` (the reference's ~100M
    config; finite losses); each one's seconds.  Returns their launches."""
    from repro_torch import serve_lm, train_lm
    from repro_torch.configs import ARCHS
    cold, warm = autoplan
    for what, run in (("cold", cold), ("warm", warm)):
        st = run["stats"]
        print(f"  autoplan_model {EXAMPLE_AUTOPLAN[0]} generations of "
              f"{EXAMPLE_AUTOPLAN[1]}, {what} cache: {run['wall_s']:.1f} s, "
              f"{st['candidates']} candidates, {len(run['keys'])} traces "
              f"({len(set(run['keys']))} structural keys), unique traces "
              f"{st['unique_compiles']}, disk hits {st['disk_hits']}, trace "
              f"{st['compile_s']:.1f} s, best {run['best_s'] * 1e6:.1f} us "
              f"modeled; launches {run['launches']}, card bytes "
              f"{run['allocated']}")
        require(not run["launches"] and run["allocated"] == 0,
                f"(19) autoplan ({what}) launched or allocated on the card")
    require(cold["keys"] and len(set(cold["keys"])) == len(cold["keys"])
            == cold["stats"]["unique_compiles"],
            "(19) autoplan traced a structural key more than once")
    require(not warm["keys"] and warm["stats"]["unique_compiles"] == 0
            and warm["stats"]["disk_hits"] > 0,
            "(19) autoplan traced again over its warm disk cache")
    require(warm["best_s"] == cold["best_s"], "(19) the warm search chose "
            "another plan")
    total = {}

    def timed(what, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, n in ops.launch_counts().items():
            total[k] = total.get(k, 0) + n
        print(f"  {what}: {secs:.1f} s; launches {ops.launch_counts()}")
        return got

    out = timed("serve_lm --trace 6", lambda: serve_lm.main(["--trace", "6"]))
    for arch in serve_lm.TRIO:
        require(len(out[arch]) == 6 and all(len(t) == 12
                                            for t in out[arch].values()),
                f"(19) serve_lm: {arch} did not complete its 6 requests")
    res = timed(f"train_lm --steps {EXAMPLE_TRAIN_STEPS}",
                lambda: train_lm.main(["--steps", str(EXAMPLE_TRAIN_STEPS),
                                       "--ckpt-dir",
                                       os.path.join(tmp, "train_lm")]))
    losses = [float(h["loss"]) for h in res.metrics_history if "loss" in h]
    require(len(losses) == EXAMPLE_TRAIN_STEPS and res.restarts == 0
            and losses[-1] < losses[0] - 0.2,
            f"(19) train_lm: losses {losses}, restarts {res.restarts}")
    try:
        res = timed(f"train_lm --wide --steps {EXAMPLE_WIDE_STEPS}",
                    lambda: train_lm.main(
                        ["--wide", "--steps", str(EXAMPLE_WIDE_STEPS),
                         "--ckpt-dir", os.path.join(tmp, "train_wide")]))
    finally:
        ARCHS.pop(f"{TRAIN_ARCH}-100m", None)
    losses = [float(h["loss"]) for h in res.metrics_history if "loss" in h]
    require(len(losses) == EXAMPLE_WIDE_STEPS and all(np.isfinite(losses)),
            f"(19) train_lm --wide: losses {losses}")
    free_card()
    return total


def start_dryrun(tmp: str) -> subprocess.Popen:
    """Start :func:`dryrun_child` in its own process (its fake process group
    stays out of every other phase's), writing to ``tmp``."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.dryrun_child({os.path.join(tmp, 'dryrun.json')!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def dryrun_child(path: str) -> None:
    """Phase 17's child: each of DRYRUN_CELLS through
    ``launch.dryrun.run_cell`` on the card's device type (a fake process
    group of 512 ranks, the production mesh), DRYRUN_PRUNED, and phase 13
    (b)'s training shape traced on one device (no mesh); for each, the
    kernel launches and the card bytes allocated while it ran (both must
    stay 0).  Writes the results to ``path`` as JSON."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import cost_model
    from repro_torch.dist.plan import Plan
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    def watched(fn):
        before, held = ops.launch_counts(), torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn()
        return got, {"wall_s": time.perf_counter() - t0,
                     "launches": {k: v - before[k] for k, v in
                                  ops.launch_counts().items()
                                  if v != before[k]},
                     "allocated": torch.cuda.memory_allocated() - held}

    out = {"cells": []}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, mesh in DRYRUN_CELLS:
            res, w = watched(lambda: dryrun.run_cell(
                arch, shape, mesh, out_dir=Path(tmp), use_cache=False,
                device="cuda"))
            out["cells"].append({**{k: res.get(k) for k in (
                "arch", "shape", "mesh", "n_chips", "trace_s", "memory",
                "kernel_calls", "roofline", "fits_80GiB", "energy",
                "collectives", "error")}, **w})
        arch, shape, mesh, over = DRYRUN_PRUNED
        res, w = watched(lambda: dryrun.run_cell(
            arch, shape, mesh, out_dir=Path(tmp), overrides=over,
            use_cache=False, device="cuda"))
        out["pruned"] = {**{k: res.get(k) for k in ("error", "lint",
                                                    "trace_s")}, **w}
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_SHAPE
    shape = ShapeConfig("phase-13b", seq_len=s, global_batch=b, kind="train")
    plan = Plan(remat="block", vocab_chunk=TRAIN_VOCAB_CHUNK)
    (art, trace_s), w = watched(lambda: dryrun.trace_cell(
        cfg, shape, None, plan, "cuda"))
    rl = cost_model.roofline_from_analysis(
        art.analyze(), n_chips=1,
        model_flops=cost_model.model_flops_for(cfg, shape))
    out["one_rank"] = {"trace_s": trace_s, "memory": art.memory,
                       "roofline": rl.to_dict(),
                       "kernel_calls": dryrun.kernel_calls(art), **w}
    with open(path, "w") as f:
        json.dump(out, f)


def finish_dryrun(proc: subprocess.Popen, tmp: str) -> dict:
    """Wait for the child (at most DRYRUN_TIMEOUT s) and read its results;
    its output is printed."""
    try:
        log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"(17) the dry-run child ran past "
                           f"{DRYRUN_TIMEOUT} s")
    tail = "\n".join(log.splitlines()[-40:])
    require(proc.returncode == 0, f"(17) the dry-run child failed:\n{tail}")
    with open(os.path.join(tmp, "dryrun.json")) as f:
        return json.load(f)


def lint_launch_plans():
    """(a): the CUDA kernel lint over the launch plans of the shapes phases
    3-16 launched (the serving, training, cross-attention and planner
    shapes of the constants above) and at its defaults: no error."""
    from repro_torch.analysis import has_errors, kernel_lint as kl
    p = functools.partial
    factories = list(kl.default_factories())
    m, k, n = MATMUL_MAIN
    factories += [p(kl.matmul_model, m, n, k, dtype="float32"),
                 p(kl.matmul_model, m, n, k, dtype="bfloat16"),
                 p(kl.matmul_model, MATMUL_MLP[0], MATMUL_MLP[2],
                   MATMUL_MLP[1], dtype="bfloat16"),
                 p(kl.matmul_model, MATMUL_UNALIGNED[0], MATMUL_UNALIGNED[2],
                   MATMUL_UNALIGNED[1], dtype="bfloat16"),
                 p(kl.tdfir_model, *TDFIR_MAIN),
                 p(kl.tdfir_model, *TDFIR_MAIN, planes=2)]
    flash = [(FLASH_MAIN[1], FLASH_MAIN[2], FLASH_MAIN[3], FLASH_MAIN[3],
              FLASH_MAIN[4]),
             (FLASH_MAIN[1], FLASH_MAIN[2], FLASH_RAGGED_S, FLASH_RAGGED_S,
              FLASH_MAIN[4]),
             (H2O_FLASH[1], H2O_FLASH[2], H2O_FLASH[3], H2O_FLASH[3],
              H2O_FLASH[4]),
             (GRIFFIN_FLASH[1], GRIFFIN_FLASH[2], GRIFFIN_FLASH[3],
              GRIFFIN_FLASH[3], GRIFFIN_FLASH[4]),
             (VLM_HEADS[0], VLM_HEADS[1], 2048, VLM_CTX, VLM_HEADS[2]),
             (AUDIO_HEADS[0], AUDIO_HEADS[1], AUDIO_CTX, AUDIO_CTX,
              AUDIO_HEADS[2])]
    flash += [(h, kv, 2048, 2048, FLASH_WIDE_D) for h, kv in WIDE_LAYOUTS]
    flash += [(h, kv, sq, skv, d) for _, h, kv, sq, skv, d, _, _
              in BWD_CASES]
    b_train, s_train = TRAIN_SHAPE
    flash.append((b_train * 32, 8 * b_train, s_train, s_train, 64))
    b_train, s_train = TRAIN_RG_SHAPE
    flash.append((b_train * GRIFFIN_FLASH[1], b_train * GRIFFIN_FLASH[2],
                  s_train, s_train, GRIFFIN_FLASH[4]))
    for h, kv, sq, skv, d in flash:
        for dtype in ("bfloat16", "float32"):
            factories.append(p(kl.flash_attention_model, h, sq, skv, d,
                              dtype=dtype, kv_group=h // kv))
            factories.append(p(kl.flash_attention_bwd_model, h, sq, skv, d,
                              dtype=dtype, kv_group=h // kv))
    decode = [DECODE_MAIN, DECODE_WRAP, H2O_DECODE, GRIFFIN_DECODE,
              (4, VLM_HEADS[0], VLM_HEADS[1], 2112, VLM_HEADS[2]),
              (4, VLM_HEADS[0], VLM_HEADS[1], VLM_CTX, VLM_HEADS[2]),
              (4, AUDIO_HEADS[0], AUDIO_HEADS[1], 2112, AUDIO_HEADS[2]),
              (4, AUDIO_HEADS[0], AUDIO_HEADS[1], AUDIO_CTX,
               AUDIO_HEADS[2])]
    decode += [(4, h, kv, 2112, FLASH_WIDE_D) for h, kv in WIDE_LAYOUTS]
    for b, h, kv, s, d in decode:
        for dtype in ("bfloat16", "float32"):
            factories.append(p(kl.decode_attention_model, b, h, kv, s, d,
                              dtype=dtype))
    t0 = time.perf_counter()
    models, errs = kl.kernel_models(factories)
    findings = errs + [f for m in models for f in kl.check_model(m)]
    bad = [f for f in findings if f.severity == "error"]
    for f in bad:
        print(f"  [error] {f.subject}: {f.rule_id} {f.message}")
    print(f"  (a) kernel lint: {len(models)} launch plans of {len(factories)} "
          f"shapes, {len(bad)} errors, {time.perf_counter() - t0:.2f} s")
    require(not has_errors(findings), "(17) the kernel lint found errors")


def run_analysis(got: dict, train_meas: dict, smi: str) -> None:
    """Phase 17: (a) :func:`lint_launch_plans`; (b) the dry-run cells of the
    child (no launch, no card allocation while traced, the fake attention
    calls of their step kind, a finite positive roofline, ``fits_80GiB``
    printed); (c) the pruned cell (P002, no trace); (d) phase 13 (b)'s
    training shape traced on one device beside what phase 13 (b)
    measured: the dry run's peak over the measured peak memory and its
    modeled step over the measured device ms (reported, not gated)."""
    lint_launch_plans()
    for c in got["cells"]:
        what = f"{c['arch']} x {c['shape']} x {c['mesh']}"
        require(not c.get("error"), f"(17) {what}: {c.get('error')}")
        rl, mem, calls = c["roofline"], c["memory"], c["kernel_calls"]
        print(f"  (b) {what}: {c['n_chips']} cards, traced in "
              f"{c['trace_s']} s ({c['wall_s']:.1f} s the cell), peak "
              f"{mem['peak_estimate_bytes'] / 2**30:.2f} GiB a card (args "
              f"{mem['argument_bytes'] / 2**30:.3f}, temps "
              f"{mem['temp_bytes'] / 2**30:.2f}, aliased "
              f"{mem['alias_bytes'] / 2**30:.3f}), fits_80GiB "
              f"{c['fits_80GiB']}, modeled step {rl['step_time_s'] * 1e3:.3f}"
              f" ms ({rl['dominant']}), collective bytes a card "
              f"{rl['collective_bytes_per_device']:.4g}, energy "
              f"{c['energy']['energy_j']:.1f} J; fake kernel calls "
              f"{ {k: v['calls'] for k, v in calls.items()} }; launches "
              f"{c['launches']}, card bytes allocated {c['allocated']}")
        require(not c["launches"] and c["allocated"] == 0,
                f"(17) {what}: the dry run launched {c['launches']} or "
                f"allocated {c['allocated']} bytes on the card")
        want = (("flash_attention", "flash_attention_bwd")
                if c["shape"].startswith("train") else ("decode_attention",))
        require(all(calls.get(k, {}).get("calls", 0) > 0 for k in want),
                f"(17) {what}: no fake {want} call in the trace: {calls}")
        require(np.isfinite(rl["step_time_s"]) and rl["step_time_s"] > 0,
                f"(17) {what}: roofline step {rl['step_time_s']}")
    pr = got["pruned"]
    print(f"  (c) {DRYRUN_PRUNED[:3]} with {DRYRUN_PRUNED[3]}: "
          f"{pr['error'][:120]}...")
    require(pr["error"] and "statically pruned" in pr["error"]
            and any(f["rule_id"] == "P002" for f in pr["lint"])
            and pr["trace_s"] is None and not pr["launches"],
            f"(17) the microbatches=3 cell was not pruned untraced: {pr}")
    one = got["one_rank"]
    rl, mem = one["roofline"], one["memory"]
    require(not one["launches"] and one["allocated"] == 0,
            f"(17) (d): the one-device trace launched {one['launches']} or "
            f"allocated {one['allocated']} bytes")
    peak_ratio = mem["peak_estimate_bytes"] / train_meas["peak_bytes"]
    step_ratio = rl["step_time_s"] * 1e3 / train_meas["device_ms"]
    print(f"  (d) phase 13 (b)'s shape ({TRAIN_ARCH} bf16, B={TRAIN_SHAPE[0]}"
          f" S={TRAIN_SHAPE[1]}, block remat, vocab_chunk "
          f"{TRAIN_VOCAB_CHUNK}) traced on one device in "
          f"{one['trace_s']:.1f} s: peak estimate "
          f"{mem['peak_estimate_bytes'] / 2**30:.2f} GiB (args "
          f"{mem['argument_bytes'] / 2**30:.2f}, temps "
          f"{mem['temp_bytes'] / 2**30:.2f}) against the measured "
          f"{train_meas['peak_bytes'] / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated): {peak_ratio:.3f}x; modeled "
          f"step {rl['step_time_s'] * 1e3:.1f} ms ({rl['dominant']}) "
          f"against the measured device {train_meas['device_ms']:.1f} ms: "
          f"{step_ratio:.3f}x; fake kernel calls "
          f"{ {k: v['calls'] for k, v in one['kernel_calls'].items()} } "
          f"[{smi}]")


def run_digests() -> int:
    """``--digests``: flash (no window, no cap, no offset) and decode
    attention on seeded inputs at the serving shapes, the flash backward at
    13 (b)'s training shape, then the planner's fp32 matmul and tdFIR
    kernels (real and complex) at the paper's sizes, through the wrapper
    calls that every checkout since the port's second slice takes; prints
    each output's SHA-256 and its ms per call (CUDA events, and profiler
    device time)."""
    import hashlib
    from repro_torch.kernels import _build, ops
    print(f"  {nvidia_smi_line()}")
    _build.build_all()
    gen = torch.Generator().manual_seed(7)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for h, s, d in ((32, FLASH_MAIN[3], FLASH_MAIN[4]),
                        (32, FLASH_RAGGED_S, FLASH_MAIN[4]),
                        (32, FLASH_MAIN[3], FLASH_WIDE_D),
                        (WIDE_GROUP_HEADS[0], FLASH_MAIN[3], FLASH_WIDE_D)):
            q, k, v, rep = flash_inputs(gen, s, dtype, h=h, d=d)
            cases.append((f"flash H={h} KV=8 S={s} D={d} {dtype}",
                          functools.partial(ops.flash_attention, q, k, v,
                                            kv_group=rep)))
        for shape in (DECODE_MAIN, (4, WIDE_GROUP_HEADS[1], 8, 2112, 128)):
            q, kc, vc, ln = decode_inputs(gen, dtype, *shape,
                                          DECODE_MAIN_LENS)
            cases.append((f"decode {list(shape)} {dtype}",
                          functools.partial(ops.decode_attention, q, kc, vc,
                                            ln)))
    # the non-causal cross shape and the backward at 13 (b)'s training
    # shape, after the rest (their inputs unchanged)
    b, s = TRAIN_SHAPE
    q, k, v, do = bwd_inputs(gen, 32, 8, s, s, FLASH_MAIN[4],
                             torch.bfloat16, b=b)
    o, lse = ops.flash_attention_lse(q, k, v, kv_group=4)
    cases.append((f"flash bwd B={b} H=32 KV=8 S={s} D={FLASH_MAIN[4]} bf16",
                  functools.partial(ops.flash_attention_bwd, q, k, v, o, do,
                                    lse, kv_group=4)))
    h, kv, d = VLM_HEADS
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, rep = flash_inputs(gen, FLASH_MAIN[3], dtype, h=h, kv=kv,
                                    d=d, skv=VLM_CTX)
        cases.append((f"flash H={h} KV={kv} Sq={FLASH_MAIN[3]} "
                      f"Skv={VLM_CTX} D={d} non-causal {dtype}",
                      functools.partial(ops.flash_attention, q, k, v,
                                        causal=False, kv_group=rep)))
    # the planner's kernels (their own generator: the inputs above stay)
    gen = torch.Generator().manual_seed(11)
    m, k, n = MATMUL_MAIN
    a, b = randn(gen, m, k), randn(gen, k, n)
    cases.append((f"matmul {m}x{k}x{n} fp32",
                  functools.partial(ops.matmul, a, b)))

    f, nn, kk = TDFIR_MAIN
    x, xi = randn(gen, f, nn), randn(gen, f, nn)
    h, hi = randn(gen, f, kk) * 0.1, randn(gen, f, kk) * 0.1
    cases.append((f"tdfir {f}x{nn}x{kk}",
                  functools.partial(ops.tdfir, x, h,
                                    block_n=TDFIR_MAIN_BLOCK_N)))
    cases.append((f"tdfir_complex {f}x{nn}x{kk}",
                  functools.partial(ops.tdfir_complex, x, xi, h, hi,
                                    block_n=TDFIR_MAIN_BLOCK_N)))
    # the bf16 matmul at 3mm's shape and the MLP up-projection (a generator
    # of their own: the inputs above stay those of earlier checkouts)
    gen = torch.Generator().manual_seed(12)
    for m, k, n in (MATMUL_MAIN, MATMUL_MLP):
        x = randn(gen, m, k, dtype=torch.bfloat16)
        y = randn(gen, k, n, dtype=torch.bfloat16)
        cases.append((f"matmul {m}x{k}x{n} bf16",
                      functools.partial(ops.matmul, x, y)))
    # the flash backward at recurrentgemma-2b's training shape (13 (d)) and
    # at S 2048, where its window masks nothing (a generator of their own)
    gen = torch.Generator().manual_seed(13)
    _, h, kv, s, d = GRIFFIN_FLASH
    for b, s in ((TRAIN_RG_SHAPE[0], s), (4, s // 2)):
        q, k, v, do = bwd_inputs(gen, h, kv, s, s, d, torch.bfloat16, b=b)
        kw = dict(kv_group=h // kv, window=GRIFFIN_WINDOW)
        o, lse = ops.flash_attention_lse(q, k, v, **kw)
        cases.append((f"flash bwd B={b} H={h} KV={kv} S={s} D={d} window "
                      f"{GRIFFIN_WINDOW} bf16",
                      functools.partial(ops.flash_attention_bwd, q, k, v, o,
                                        do, lse, **kw)))
    for what, fn in cases:
        out = fn()
        if isinstance(out, tuple):
            out = (torch.stack(out) if len({t.shape for t in out}) == 1
                   else torch.cat([t.reshape(-1) for t in out]))
        out = out.contiguous()
        digest = hashlib.sha256(out.view(torch.uint8).cpu().numpy()
                                .tobytes()).hexdigest()[:16]
        events = time_ms(fn, 100)
        dev = device_profile(fn, 10)[0]
        print(f"  digest {what:42s} {digest}  {events:.4f} ms events  "
              f"{dev:.4f} ms device")
    return 0


# processes the phases start, which main stops if they outlive a failure
_CHILDREN: list = []


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--digests"]:
        return run_digests()
    if sys.argv[1:]:
        print(f"usage: {sys.argv[0]} [--digests]", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        try:
            return run_phases(tmp)
        finally:
            # a failure before phase 2's end leaves the dry-run child
            # running: stop it
            for proc in _CHILDREN:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def run_phases(tmp: str) -> int:
    from repro_torch import device as port_device
    from repro_torch.kernels import _build, ops, ref

    with phase("1 card"):
        smi = nvidia_smi_line()
        print(f"  power.draw before the card is opened: {idle_draw()}")
        port_device.resolve("cuda")
        print(f"  {smi}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        print(f"  torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        print(f"  torch.backends.cudnn.allow_tf32 = "
              f"{torch.backends.cudnn.allow_tf32}")
        require(not torch.backends.cuda.matmul.allow_tf32
                and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    # phase 17's dry-run cells trace on the host's CPU (fake tensors, no
    # kernel): their child runs beside the build and is waited for at its end
    child = start_dryrun(tmp)
    _CHILDREN.append(child)
    # phase 19's autoplan search traces on the host's CPU too: beside it
    planner_child = start_autoplan(tmp)
    _CHILDREN.append(planner_child)
    with phase("2 build"):
        logs = _build.build_all()
        for name, log in logs.items():
            print(f"  [{name}] {_build.library_path(name).name}\n{log}")
        for name in ("flash_attention", "flash_attention_bwd", "matmul"):
            n_hgmma = count_sass(_build, name, "HGMMA")
            print(f"  {name} SASS: {n_hgmma} HGMMA (wgmma) instructions")
            require(n_hgmma > 0, f"the {name} library has no HGMMA: its "
                    "bf16 kernels do not run on the tensor cores")
        check_bwd_build(logs["flash_attention_bwd"])
        for name in ("matmul", "decode_attention"):
            n_ldgsts = count_sass(_build, name, "LDGSTS")
            print(f"  {name} SASS: {n_ldgsts} LDGSTS (cp.async) instructions")
            require(n_ldgsts > 0, f"the {name} library has no LDGSTS: its "
                    "copies are not asynchronous")
        check_decode_build(logs["decode_attention"])
        spills = [int(v) for v in
                  re.findall(r"(\d+) bytes spill stores", logs["tdfir"])]
        n_lds128 = count_sass(_build, "tdfir", "LDS.128")
        print(f"  tdfir: spill stores {spills} bytes (one per kernel); SASS: "
              f"{n_lds128} LDS.128 (16-byte shared loads)")
        require(spills and not any(spills), "a tdfir kernel spills registers")
        t0 = time.perf_counter()
        dry = finish_dryrun(child, tmp)
        print(f"  the dry-run child (phase 17) waited for "
              f"{time.perf_counter() - t0:.1f} s past the build")
        t0 = time.perf_counter()
        autoplan = finish_autoplan(planner_child, tmp)
        print(f"  the autoplan child (phase 19) waited for "
              f"{time.perf_counter() - t0:.1f} s past the dry-run child")
    with phase("3 check"):
        errs = check_kernels(ops, ref)
    with phase("4 time"):
        times = time_kernels(ops, ref)
    with phase("5 plan"):
        launches, plan_walls, plan_verdicts = run_planner(ops)
    cells = []          # the bf16 serving cells, for phase 12
    with phase("6 serve"):
        served, b_pool = run_serve(ops, cells)
    with phase("7 family"):
        family = run_family(ops, b_pool, cells)
    with phase("8 moe"):
        moe_cells = run_moe(ops, cells)
    with phase("9 recurrent"):
        recurrent = run_recurrent(ops, cells)
    with phase("10 cross"):
        cross = run_cross(ops, cells)
    with tempfile.TemporaryDirectory() as tmp11:
        with phase("11 modeled"):
            lookup = run_modeled(ops, plan_walls, plan_verdicts, tmp11)
        with phase("12 fleet"):
            run_fleet(ops, lookup, cells, tmp11)
    with phase("13 train"):
        trained, train_meas = run_train(ops)
    free_card()
    with phase("14 dist"):
        distributed = run_dist(ops)
    free_card()
    with phase("15 part"):
        partitioned = run_partition()
    free_card()
    with phase("16 pod part"):
        pod_part = run_pod_partition()
    with phase("17 analysis"):
        run_analysis(dry, train_meas, smi)
    with phase("18 softcap"):
        capped = run_softcap(ops, train_meas)
    with phase("19 examples"):
        examples = run_examples(ops, autoplan, tmp)
    # flash and decode: the serving cells' launches, each cell counted
    # from 0 on its own (6 b, 7 c-f, 8 g-h, 9 i-j, 10 k-l), flash
    # forward and backward in the training steps of 13 (b) and the timed
    # pod-parallel steps of 14 (a), all three in phase 15's sharded runs
    # on both ranks, and flash forward and backward in phase 16's
    # partitioned pod steps on all four ranks
    launches.update({k: served[k] + family[k] + moe_cells[k] + recurrent[k]
                     + cross[k] for k in family})
    launches["decode_attention"] += partitioned["decode_attention"]
    launches["flash_attention"] += (trained["flash_attention"]
                                    + distributed["flash_attention"]
                                    + partitioned["flash_attention"]
                                    + pod_part["flash_attention"])
    launches["flash_attention_bwd"] = (trained["flash_attention_bwd"]
                                       + distributed["flash_attention_bwd"]
                                       + partitioned["flash_attention_bwd"]
                                       + pod_part["flash_attention_bwd"])
    # and the capped LM's (18: serving and training) and the examples' (19)
    for name in ("flash_attention", "decode_attention",
                 "flash_attention_bwd"):
        launches[name] += capped.get(name, 0) + examples.get(name, 0)

    sources = {"matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:18"),
               "tdfir": ("src/repro_torch/csrc/tdfir.cu",
                         "src/repro/kernels/tdfir.py:21"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:22"),
               "decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:26"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "gradient of src/repro/kernels/flash_attention.py:22 "
                   "(the reference differentiates "
                   "src/repro/models/layers.py:211)")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], **times[name]}
               for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

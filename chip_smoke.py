#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) and nothing of the JAX package:

1. prints the card's name and power limit (``nvidia-smi``); fails without
   a CUDA device;
2. builds the hand-written kernels (``sodda_inner``, ``flash_attention``
   and ``ssd_scan``, each of the last two in a wgmma source for bf16 and
   one for f32 (both on the tensor cores, every f32 operand in three bf16
   pieces), and each one's backward) from the sources in the checkout, one
   ``nvcc`` per source, all at once, and prints the build time and the
   compiler's register report, failing on any spill or serialised wgmma;
3. holds ``sodda_inner`` against its plain PyTorch version on the card for
   all three losses at the Table-1 widths (15, 64, 1200), (15, 64, 1400)
   and (15, 64, 1800), at an unaligned (2, 8, 100), at a row pitch that is
   no multiple of 16 bytes (3, 5, 301), at L = 1, above the register
   buckets (3, 16, 2100) and at the largest mt the first slice's kernel
   took, (2, 3, 19344); requires two launches to agree bitwise; times the
   kernel by a CUDA graph of launches (the kernel alone) beside its bound,
   the wrapper's host time a call, CUDA events around back-to-back wrapper
   calls (the earlier method) and the plain version;
4. runs a small problem on the ``cuda`` backend against the ``reference``
   backend on the CPU, fed the same data and samples;
5. runs the paper's Table-1 instance (250 000 x 18 000, X = 18.0 GB on the
   card) through ``repro_torch.core.driver.run`` on the ``cuda`` backend —
   the main path, with the launch counts set to 0 just before it — and on
   the ``reference`` backend, checks descent, agreement, launches and peak
   device memory, and breaks one iteration down by layer, consume_update
   into its gather, kernel and concatenation; then frees X;
6. materialises the ``tiled`` data plane of Table-1 on the card, prints
   its time and its peak device memory over X (at most 1.1 x X), and holds
   one tile and one label block bitwise to the same blocks regenerated
   alone;
7. holds ``sodda_inner`` at radisa-avg's launch (15, 64, 6000) against its
   plain version for all three losses, bitwise across launches, and times
   it by a CUDA graph beside its bound;
8. runs ``radisa-avg`` and ``async`` for 20 iterations each through
   ``driver.run`` on that data, with the launch counts set to 0 just
   before each: 20 launches each, radisa-avg within F32_REDUCTION of its
   plain path (hinge at each iteration, kernel and plain stepped from the
   same state, and the hinge trajectory at the objective level against the
   plain path rounded as the kernel rounds, with fused multiply-adds; a
   logistic twin's trajectory in full),
   async at staleness 0 bitwise ``cuda``'s trajectory and at staleness 1
   within STALENESS of it, descent everywhere; then prints the paper's
   comparison, SODDA against RADiSA-avg per iteration, per gradient
   coordinate and per second (no gate);
9. drives ``driver.run_resumable`` on that data (20 iterations, 2
   segments of 10, the launch counts set to 0 just before each run and
   read just after): bitwise ``driver.run`` back to back; a ``cuda`` run
   killed after its first boundary, and one killed at a mid-segment commit
   (``commit_every=5``, at iteration 15), each resumed bitwise, as are
   ``async`` at staleness 1 and ``radisa-avg`` killed after a boundary;
   each run launches the kernel once an iteration it runs, a resume of a
   completed run never; ``replay_segment`` matches; the checkpoints are
   read back by hand (json, numpy, zlib) in the reference's layout; and
   it prints the ms an iteration against ``driver.run``'s, a save's ms and
   the data fingerprint's seconds;
10. holds ``sodda_inner`` at (12, 64, 1500) as in 7, then runs
    ``run_elastic`` on ``cuda``, shrinking P from 5 to 4 at iteration 10:
    20 launches, bitwise the same composition by hand
    (``migrate_resumable`` and ``run_resumable`` over ``shrink_plane``),
    descent;
11. holds epoch 0 of the ``streaming`` plane bitwise to the tiled X and a
    one-segment streaming run bitwise to the tiled run, times the static
    ``cuda`` run and frees X; then streams Table-1 as 4 windows (no tile
    cache, a window a segment of 5): prefetched at depth 1 and 2, each
    bitwise a loop here that materialises each window on the main stream
    with no thread, killed and resumed bitwise, with the ms an iteration,
    the prefetcher's accounting and the peak over X (at most 2.2 x X at
    depth 1);
12. runs Table-1 doubly distributed, before the streaming windows: on the
    tiled plane's X it records ``cuda``'s iterate at every iteration, the
    exchange of iterations 1 and 10, ``async`` at staleness 1 and the
    logistic twin; frees X; holds ``sodda_inner`` at the mesh's launch
    (1, 64, 1200), one chain a rank, as in 7; then spawns a 5 x 3 grid of
    15 ranks sharing the card over gloo (each draws only its 1.2 GB tile)
    for one spawn of every mesh run, 20 iterations each, objective every
    5, the launch counts set to 0 just before each run in each rank:
    ``shard_map+cuda`` (the mesh's main path), ``async-mesh`` at staleness
    0 and 1, the int8 wires, the delta all-reduce, and ``run_resumable``
    interrupted at its seam and resumed. It holds every rank's w and
    history bitwise equal; one launch a rank an iteration, a resume only
    its own; ``consume_local`` bitwise ``consume_update``; every step from
    ``cuda``'s iterate and the trajectory (hinge, and the logistic twin)
    within F32_REDUCTION of ``cuda``; staleness 0 bitwise, staleness 1
    within STALENESS of ``async``; the int8 wires within QUANTIZED; the
    resume bitwise, rank 0 alone writing; and prints the ms an iteration,
    each collective's payload beside ``iteration_collective_bytes``, the
    ranks' summed peak over X, the card's used memory, a ``shard_map+cuda``
    iteration by layer (the engine's bundle, the device synchronised
    around each collective) and one all-reduce of n f32 over all 15 ranks.
    Then a 1 x 1 grid over NCCL, bitwise ``cuda`` on the same data.
    Then the elastic rescale and the streaming plane on the mesh: with X
    still resident it records the single-device ``run_elastic`` runs
    (``cuda`` shrinking P from 5 to 4 at 10 and growing back at 15,
    ``async`` at staleness 1, the logistic twin) and the tile digests of
    the 4 stream windows' slices; holds ``sodda_inner`` at the shrunk
    mesh's launch (1, 64, 1500) as in 7; then spawns the 15 ranks and 6
    spare processes for one spawn of: ``shard_map+cuda`` streaming 4
    windows a segment of 5 at prefetch depth 1 and one window's run, each
    rank's tile of every window, the static runs beside them, then
    ``run_elastic`` shrinking to 4 x 3 at 10 and regrowing to 5 x 3 at 15
    (the lost row leaves the group, the survivors re-form it, 3 spares
    join as the regrown row; a fault after its last commit), the same by
    hand (``run_resumable``, the group re-formed, ``rescale_bundle``,
    ``migrate_resumable``, ``run_resumable``), the shrink with a fault
    after a commit in each phase and by hand, ``run_elastic_auto`` with
    the last rank's segment from 5 read as 30 s slow, ``async-mesh`` and
    the logistic twin, the launch counts set to 0 just before each run in
    each process. It holds every rank's w, history and report bitwise
    equal; the planned departures and regrown ranks that held nothing;
    one launch a rank an iteration (5 at (1, 64, 1500) on the 4 x 3 grid,
    none on a resume of a completed phase); each run bitwise its
    composition by hand, the faulted runs and the straggler's shrink
    bitwise the planned ones; the logistic twin within F32_REDUCTION of
    ``cuda``'s (the hinge runs against ``cuda``'s are printed),
    ``async-mesh`` within STALENESS of ``async``; one window's stream
    bitwise the tiled mesh run and each placed tile the window's slice by
    digest; and prints the ms an iteration by segment, the seconds from a
    rescale's commit to the first segment on the re-formed group and
    until the regrown ranks hold their tiles, the streaming ms an
    iteration against the static run's, each rank's ``place_s``,
    ``wait_s`` and ``overlap_ratio`` and the memory. Each hinge mesh
    trajectory (the static run, the shrink, the shrink-then-grow, the
    stream) is held to F32_REDUCTION against the single-device plain path
    summed in the mesh's order
    (``testing.mesh_order.snapshot_gradient_in_mesh_order``: z over the Q
    partial GEMVs and mu over the P partial products, as gloo's ring adds
    them);
13. holds ``flash_attention`` against its plain version at the gemma2-9b
   prefill shape (B=4, H=16, KV=8, S=4608, D=256, bf16) for a local and a
   global layer, at a decode offset, at zamba2-7b's shared attention layer
   (4, 32, 32, 4096, 112) and a phi3-mini layer (head dim 96), at
   unaligned bf16 shapes for the other head dims (16, 64, 96, 112, 128:
   causal, non-causal, window + softcap, decode offset), at the same
   unaligned shapes in f32 for every head dim (16, 64, 96, 112, 128, 256)
   and with q, k, v bf16 views whose data is not 16-byte aligned (bitwise
   the aligned copies' output), and times it at the gemma2, zamba2 and
   phi3-mini layer shapes beside its bound, its plain version and
   ``scaled_dot_product_attention``; holds and times it the same way at
   the other dense-stack layers: chatglm3-6b's (4, 32, 2, 4064, 128), a
   GQA group of 16, internvl2-26b's (4, 48, 8, 4064, 128), a group of 6,
   minitron-8b's (4, 32, 8, 4064, 128) and musicgen-large's (4, 32, 32,
   1468, 64), and the MoE family's (4, 64, 8, 4064, 128), a group of 8
   (arctic-480b's 56 heads padded to 64, kimi-k2's 64), which it also holds
   in f32; holds f32 at groups 6 and 16 (unaligned, causal, and window
   + softcap); and times it in f32 at zamba2's layer beside
   both bounds (the tensor cores' split products and the CUDA cores' f32
   rate) and that call in f32.
   bf16 takes the wgmma kernel, f32 the wgmma-f32 one (its registers by
   instantiation are logged). An f32 output must be within 2e-5 of the
   plain version, which the split control (every tensor-core operand
   rounded once to bf16) must fail. A bf16 output must
   be its f32 value correctly rounded (see ``F32_NOISE``), and two
   controls must fail that rule: scores rounded to bf16, and P rounded to
   bf16 before P.V (the textbook tensor-core kernel);
14. runs gemma2-9b at full width, cut to 4 layers, in f32, on 4608-token
    prompts through ``serve`` with the kernel and with the plain version:
    prefill logits and 8 decode steps' logits within 2e-4, and 8 greedy
    tokens identical;
15. serves 4 requests of 4608 prompt tokens for 32 tokens each through
    full-depth bf16 gemma2-9b (``repro_torch.launch.serve.serve``, the
    second main path, with the flash launch count set to 0 just before it):
    42 launches in the prefill and none in the decode, finite logits, and
    prefill time, decode time per token and peak device memory. Then each
    of the 42 layers' attention, on the plain path's activations, is held
    to the rounding rule of 13 (both controls failing it), and the rms gap of
    the kernel path's logits to the plain path's to 1.2x the plain path's
    gap to itself summed in another order;
16. runs phi3-mini-3.8b, minitron-8b, chatglm3-6b, musicgen-large and
    internvl2-26b at full width, cut to 4 layers, in f32, through ``serve``
    with the kernel (4 launches on the wgmma-f32 route) and with the plain
    version, on 2 x 1024 prompt tokens (internvl2: 256 stand-in frontend
    embeddings of ``input_specs``' shape ahead of 2 x 768): prefill logits
    and 8 decode steps' logits within 2e-4, and 8 greedy tokens identical;
17. serves each of the five at full depth in bf16, one on the card at a
    time (``serve``, the dense stack's other main paths, with the flash
    launch count set to 0 just before each call and read just after): 4
    requests of 4064 prompt tokens for 8 tokens each (internvl2: 256
    frontend embeddings + 3808 text tokens; musicgen: 1468 codec tokens),
    exactly L launches in the prefill (32, 32, 28, 48, 48) and none in
    decode, on the wgmma route, finite logits, and prefill time, decode
    time per token and peak device memory beside their floors (the
    non-embedding weights' FLOP at the bf16 peak; the bf16 weights read
    at the HBM rate); then the first, middle and last layers' attention
    on the plain path's activations (the plain path taking 1 / sqrt(D) in
    f32, as the kernel does) held to the rounding rule of 13, both
    controls failing it, and the rms gap of the kernel path's logits to
    the plain path's to 1.2x the plain path's gap to itself summed in
    another order;
18. holds ``models.moe.route`` on the card bitwise to ``route`` on the
    CPU, fed the same f32 probabilities (the top-k indices, gates,
    capacity ranks, keep mask, destinations and slot map) at arctic-480b's
    prefill (16 256 tokens, 128 experts, top-2, bf16 router logits, with
    the tokens tied at the k-th place counted), kimi-k2's (384, top-8) and
    a skewed router that puts more than an expert's capacity on it (the
    tokens dropped counted);
19. runs arctic-480b (all 128 experts, the dense residual) and kimi-k2
    (192 of its 384 experts, top-8 kept) at full width, one layer, in f32,
    through ``serve`` with the kernel (1 launch a prefill, the wgmma-f32
    route) and with the plain version, on 2 x 1024 prompt tokens, each
    route recorded: at most 0.1% of the (token, slot) routes may differ
    between the two paths, and where a token's routes agree its prefill
    and 8 decode steps' logits are held within 2e-4 and its greedy tokens
    must be identical;
20. serves arctic-480b at 2 of its 35 layers and kimi-k2 at 1 of its 61 in
    bf16, full width (every expert), one on the card at a time, as 17 does
    (4 x 4064 prompt tokens, 8 generated; exactly L launches in the
    prefill and none in decode), with prefill and decode times beside the
    floors (the active weights' FLOP, with the capacity-padded expert FLOP
    beside it; every weight read), peak memory, each layer's expert load
    and tokens dropped, the sampled layers' attention held to the rounding
    rule of 13 on the plain path's activations, and the logits' rms gap to
    the plain path logged beside the number of routes that differ (not
    gated: in bf16 a route flip moves its token's logits);
21. holds ``ssd_scan`` against its plain chunked version at the mamba2-130m
    serving layer shape (B=16, S=2048, H=24, P=64, G=1, N=128), with
    Mamba-2's dt and A and a slow-decay case, at the training layer (8,
    2048, 24, 64, 1, 128), at S = 1000, at an unaligned (4, 1000, 8, 16, 2,
    16), at (1, 333, 6, 32, 2, 32) (3 heads a group), at G = 2 and at
    zamba2-7b's layer shape (4, 4096, 112, 64, 1, 64), in f32 (the
    wgmma-f32 route, rtol = atol = 1e-4, and within 1e-5 of max|y| off the
    plain chunked SSD in f64, which two controls must fail: the carry
    dropped, and every operand of the tensor-core products rounded once to
    bf16) and bf16 (the wgmma route, the rounding rule of 13 over max|y|,
    which four controls must fail: the carry dropped, and each f32 operand
    of the tensor-core products rounded once to bf16: W, the state as
    C . state reads it, and x_j w_j of the state update), requires two
    launches to agree bitwise, prints each case's route and the
    inter-chunk share ||y_inter|| / ||y||, runs x, B and C as views whose
    data is not 16-byte aligned in both dtypes (bitwise the aligned
    copies' output), and times kernel and plain version beside the bound
    (the least of the work at the dtype's peak and as the split
    tensor-core products take it) at the mamba2 serving and training and
    the zamba2 layer shapes;
22. runs full-depth mamba2-130m in f32 (B=2, 512 prompt tokens, Mamba-2's
    A_log and dt_bias): the kernel path's prefill logits within 2e-4 of the
    plain path's and of the decode warm-up's last logits (the scan against
    the recurrence), and 8 decode steps' logits, fed random tokens, within
    2e-4 of the scan's at the same positions;
23. prefills 16 requests of 2048 prompt tokens alone (the time to the
    first token), then serves their first 256 for 32 tokens each through
    bf16 mamba2-130m at full width, cut to 12 of its 24 layers (``serve``,
    the third main path, with the SSD launch counts set to 0 just before
    it): 12 launches in the prefill, all on the wgmma route, and none in
    the warm-up or decode, finite logits, and prefill time, warm-up time
    (timed inside the call), decode time per token and peak device
    memory. Then each layer's SSD, on the plain path's activations, is
    held to the rounding rule of 13, every control failing it;
24. runs zamba2-7b at full width, cut to 12 layers (2 sites of the shared
    attention + MLP block), in f32 (B=2, 256 prompt tokens, Mamba-2's
    A_log and dt_bias): every flash launch (D = 112, the wgmma-f32 route)
    and every SSD launch on the plain path's activations within 1e-4 of
    its plain version, and the kernel path's prefill logits and the
    decode warm-up's last logits against the plain path's, their rms gaps
    within 2x the floor (the plain path at chunk 64), a carry-dropping
    control outside it;
25. serves full-size bf16 zamba2-7b (81 layers, 13 sites; ``serve``, the
    fourth main path, with the flash and SSD launch counts set to 0 just
    before each call and read just after): the prefill alone on 4 x 4096
    prompt tokens (13 flash launches at D = 112 and 81 SSD launches, all
    on the wgmma routes; its time and peak memory), then a whole serve
    call on 4 x 64 prompt tokens fed through decode and 32 generated
    (the same launches in its prefill, none in the warm-up or decode;
    prefill, warm-up and decode times, peak memory), and prints each
    kernel's share of the 4 x 4096 prefill;
26. holds the SSD scan's backward kernel (``ops.ssd_scan_bwd``, on the
    tensor cores) against its plain gradient (autograd through the
    chunked scan in f32 at chunk 64) at mamba2-130m's training layer (8,
    2048, 24, 64, 1, 128) in f32 and bf16, at zamba2-7b's (2, 4096, 112,
    64, 1, 64) in f32 and at an unaligned (4, 1000, 8, 16, 2, 16) in both:
    every leaf within 1e-5 of its max in f32, the rounding rule of 13 in
    bf16, two controls failing it on every leaf the state or a product
    reaches (each 64-step chunk differentiated alone: no dstate carried;
    the kernel's decomposition with every product operand rounded once
    to bf16, ``ref.ssd_bwd_decomposed``, where the kernel splits an f32
    operand into three pieces); two launches bitwise; and times it at
    the two layers beside the earlier CUDA-core design's time, its bound
    (the CUDA cores' f32 rate for f32), the tensor-core route's bound (its
    split products at the bf16 rate) and the plain version;
27. holds the flash-attention backward kernel (``ops.flash_attention_bwd``,
    on the tensor cores) against its plain version (``ref.attention_grads``)
    on the out and lse of the card's forward kernel (whose out must be
    bitwise the forward's without lse, its lse within 1e-5 of the plain
    one, in f32 its out within 2e-5 of the plain one, the split control
    outside, and in bf16, where every row sees a key, its out within the
    rounding rule of 13, both controls outside) at gemma2-9b's local and global training layers (1,
    16, 8, 4608, 256, softcap 50), zamba2-7b's (1, 32, 32, 4608, 112)
    with and without its long-context window, a phi3-mini layer (head dim
    96), the training layers of the dense stack at 1 x 4096 and of the
    MoE family at 2 x 4096 (minitron-8b's, internvl2-26b's, the MoE
    layer's and chatglm3-6b's at GQA groups 4, 6, 8 and 16,
    musicgen-large's at D = 64), D = 16, 64 and 128, a decode offset
    over an unaligned key range and rows that see no key, each in f32 (every gradient within 1e-5 of
    its max) and bf16 (the rounding rule of 13), the control (dS rounded
    once to bf16 before the dQ and dK products) failing both on dq and
    dk; two launches bitwise; and times it at the three training layers
    (and the MoE layer in bf16, chatglm3-6b's in f32) beside its bound,
    the plain version and the backward of
    ``scaled_dot_product_attention`` (causal, no softcap, k and v
    expanded), and the f32 forward with its lse at the three layers
    beside both bounds and, where the layer has no window, the kernel and
    ``scaled_dot_product_attention`` in f32 on the softcap-free function;
28. trains mamba2-130m on the card, f32: (a) cut to 4 layers at full
    width (2 x 1024 tokens), the kernel path's loss and every gradient
    leaf within F32_REDUCTION of the plain path's, the carry-dropping
    control outside, and remat='full' bitwise remat='none' with twice the
    forward launches; (b) full size, 6 adamw steps of ``make_train_step``
    on 8 x 2048 tokens from ``TokenPipeline(seed=0)`` (the training main
    path, the launch counts set to 0 just before each run and read after
    each step: 24 forward and 24 backward SSD launches a step, no flash),
    twice, and one step at accum_steps=2 (48 + 48): ms a step, tokens/s,
    peak memory, a falling loss, the two runs compared bitwise; (c) the
    CLI's SODDA-SVRG loop for 6 steps (2 gradients a step, 3 at the
    refresh; 12 of the 24 layers); (d) the CLI
    (``python -m repro_torch.launch.train``) in a
    fresh process, killed (SIGKILL) once it logs step 5, three steps past
    its checkpoint at step 3, then a fresh process resuming from step 3
    to 6: params and losses bitwise (b)'s; then dense and hybrid
    training through the flash backward, f32, full width: (e) gemma2-9b
    cut to 2 layers (1 local, 1 global) and (f) zamba2-7b
    cut to 12 (2
    sites of the shared block), 1 x 4608 tokens a step: 5 adamw steps
    twice (the second run bitwise the first, the loss falling) and one
    step at accum_steps=2 over 2 x 4608, with ms a step, tokens/s, peak
    memory and exact launch counts (gemma2 2 + 2 flash, no SSD; zamba2 12
    + 12 SSD, 2 + 2 flash); then the exactness cell at 1 x 4608 tokens
    (zamba2 2048; wq and wk scaled for unit-std scores), the loss and
    every gradient leaf within F32_REDUCTION of the plain path, a control
    outside it (gemma2: the softcap's derivative dropped from the
    backward; zamba2: the causal mask dropped from it), remat='full'
    bitwise remat='none' with the forwards relaunched;
29. trains the rest of the dense stack and the MoE family: (g)
    phi3-mini, minitron-8b, chatglm3-6b, musicgen-large and
    internvl2-26b at full width, cut to 2 layers, f32, adamw at 3e-4, 1 x
    4096 positions a step (internvl2: 256 frontend embeddings + 3840 text
    tokens), each as (e): 5 steps twice, bitwise, the loss falling, an
    accum_steps=2 step (not minitron, whose two gradient trees do not
    fit), the exactness cell at 1 x 2048 with the causal mask dropped as
    the control, remat bitwise; (h) arctic-480b (1 of 35 layers, all 128
    experts, 56 heads padded to 64) and kimi-k2 (1 of 61, 192 of 384
    experts) in bf16 at the reference's production settings (adafactor,
    bf16 gradients, remat 'full'), 2 x 4096 tokens a step, 3 steps twice,
    bitwise (by each leaf's digest), 2 flash forward and 1 backward
    launches a step on the wgmma route, the padded heads' wo rows exactly
    0 after every step, each step's expert load and drops, ms a step
    against its floor, the gradient and the update timed apart; (i) the
    MoE exactness cells in f32 (arctic with 16 experts, kimi with 32, 1 x
    2048 tokens): the routes that differ between the kernel and plain
    paths counted, the loss, aux and every gradient leaf within
    F32_REDUCTION where none differs, the gates-detached control outside
    on the router leaf, the causal-mask control outside, remat bitwise,
    and one adafactor accum_steps=2 step at grad_dtype bfloat16 and one
    at float32. Every new cell's peak stays under 72 GB;
30. runs the LM stack over a (data x model) mesh of 4 gloo ranks sharing
    the card (``phase_mesh_lm``), chatglm3-6b at full width cut to 2 of its
    28 layers, f32, after the one-device serving reference is computed
    and freed in the parent; each rank computes the one-device step in
    turn and keeps its own shards of it: (a) on (2, 2), the 'heads'
    layout, adamw at 3e-4 with ZeRO-1 and remat 'collectives', 2 x 2048
    tokens a step, 2 steps: the first step's loss and grad norm within
    F32_REDUCTION of the one-device step's, every gradient leaf within
    1e-4 of the leaf's largest and every parameter after the update
    within UPDATE_TOL x the one-device step's largest update of the leaf
    (each rank's shard against the same shard of the one-device step: the
    gathered leaf's rule), the input collective's backward all-reduce
    dropped as a control outside the gradient rule, ZeRO-1's state slices
    and parameters bitwise an update unsplit over 'data' from the same
    summed gradients, 'collectives' bitwise 'none' with the same
    all-reduces and fewer than 'full' (which runs on the rows' first 256
    positions: the count does not depend on them), the losses falling;
    on (1, 4), the
    kv heads replicated, the gradients in the rule and the kv weights'
    partial gradients left unsummed as a control outside it; it logs the
    flash launches a rank a step, ms a step, the payload a step by tag,
    the last step's collectives timed apart, each rank's seconds by part
    and peak; (b) serving 4 x 1024 prompts into a 1040-position cache,
    then 8 greedy decode steps, on (1, 4) in 'seq' decode (a rank's cache
    (2, 4, 260, 2, 128)) and on (2, 2) in 'heads' decode: the logits
    within 2e-4 of the one-device port's, the tokens identical, each
    rank's cache the shape ``cache_pspecs`` gives, 2 flash launches a
    prefill a rank and none a decode step, with the prefill's ms and the
    ms a token;
31. in the same spawn of 4 ranks, each rank's allocator cache emptied
    between the jobs, runs the MoE family over the mesh: arctic-480b at
    full width (56 q heads padded to 64 and inert, the dense residual,
    top-2) cut to 1 of its 35 layers and 8 of its 128 experts, f32, after
    its one-device serving reference is computed and freed in the parent;
    each rank computes the one-device adafactor steps in turn and keeps
    its own shards of them: (c) on (2, 2) in the 'gather' and the
    'token_tp' layout, adafactor at 3e-4 with ZeRO-1 and remat 'full', 2
    x 2048 tokens a step, 2 steps from the same parameters (the second
    reading the sharded state the first wrote): every rank's route
    bitwise ``moe.route`` of the probabilities it gathered and the same
    on every rank, the routes that differ from the one-device step's
    counted (at most 0.1%), the first step's loss and grad norm within
    F32_REDUCTION, every gradient leaf within 1e-4 of its largest and the
    parameters after each step within UPDATE_TOL x the one-device update
    where no route differs, the two layouts within F32_REDUCTION of each
    other (through the one-device step), and on a skewed router that
    drops tokens the per-rank route and the layout's control ('gather':
    the gathered weights' gradient not reduce-scattered; 'token_tp': the
    expert outputs' 'model' all-reduce dropped) outside the gradient
    rule; 2 flash forward and 1 backward launches a rank a step; it logs
    ms a step, the calls and payload by tag, the second step's
    collectives timed apart, each rank's peak, the expert load and the
    drops; (d) serving 4 x 1024 prompts on (2, 2) in both layouts, 8
    greedy steps in 'token_tp' and 2 in 'gather' (which gathers the
    expert FFN every step), each step routing the global batch: the
    logits within 2e-4 of the one-device port's, the tokens identical, 1
    flash launch a prefill a rank and none a decode step, with the
    prefill's ms and the ms a token;
32. in the same spawn, the SSM and hybrid families over the mesh:
    mamba2-130m at full size and zamba2-7b at full width cut to 6 of its
    81 layers (one shared-attention site), f32, after their one-device
    serving references are computed and freed in the parent; the ranks
    compute the one-device adamw steps two at a time and keep their own
    shards of them: (e) on (2, 2), adamw at 3e-4 with ZeRO-1 and remat
    'full', 2 steps of 2048-position rows: mamba2 at batch 2 (the SSM
    heads over 'model', 12 a rank) and 4 (a row a rank over both axes,
    every head, the split leaves gathered), zamba2 at batch 2 (56 SSM
    and 16 q heads a rank): each step's loss and grad norm within
    F32_REDUCTION of the one-device step's, the first step's gradient
    shards within 1e-4 of each leaf's largest, its parameters within
    UPDATE_TOL x the one-device update wherever the gradient rule fixes
    adamw's first move (at most 1e-3 of a leaf outside), ZeRO-1 bitwise
    an unsplit update, the controls (mamba2: the gated norm's backward
    all-reduce dropped, the B/C weights' partial gradients unsummed, a
    gathered leaf keeping its own gradient slice) outside the gradient
    rule, exactly 2L SSD forward and L backward launches a rank a step
    (with 2 flash forward and 1 backward for zamba2's site); it logs ms a
    step, calls and payload by tag, the second step's collectives timed
    apart and each rank's peak; (f) serving 4 x 32 prompts (once 64)
    through ``warm_up`` on the cache's rows, then 8 greedy steps:
    the tokens identical, the conv history within 2e-4 of the one-device
    cache's, each rank's cache the shape ``cache_pspecs`` gives, L SSD
    launches (and one flash launch a site) a prefill a rank and none in
    warm-up or decode, the logits within 2e-4 at zamba2's cut depth and
    at mamba2's full depth an rms gap within FLOOR_FACTOR x the
    one-device port's own gap between its prefill and its warm-up; with
    the prefill's ms, the warm-up's ms a position and the ms a token;
33. in the same spawn, the 'pod' axis: the same 4 ranks on a (pod,
    data, model) = (2, 1, 2) mesh, the reference's multi-pod layout ('pod'
    joins 'data' for the batch, ZeRO-1 stays over 'data'), built over the
    same group after the other grids; each cell takes the global batch
    and the one-device steps of a cell above: (g) chatglm3-6b's (2, 2)
    cell, 2 x 2048, the rows over ('pod', 'data'), remat 'collectives';
    (h) mamba2-130m's layout-B cell, 4 x 2048, the rows over ('pod',
    'data', 'model'), remat 'full'. Each: step 1 in its parts (the loss
    and grad norm within F32_REDUCTION of the one-device step's, the
    gradient rule, the 'pod_grad' control (the sum over 'pod' dropped,
    each pod keeping its own gradient) outside it, the parameters after
    the update within UPDATE_TOL x the one-device update (where the
    gradient rule fixes adamw's move, for mamba2), ZeRO-1 bitwise an
    unsplit update), step 2 through the step function (its loss and grad
    norm held to the (2, 2) cell's second step, or the one-device one),
    the two pods' parameter shards bitwise equal after each step (by
    digest), the launches a rank a step (chatglm3-6b 4 flash forward and
    2 backward, mamba2 48 SSD forward and 24 backward); it logs ms a step,
    the calls and payload by tag (the sum over 'pod' under 'pod_grads'),
    the second step's collectives timed apart and each rank's peak; then
    serving on (2, 1, 2), the rows over ('pod', 'data'): chatglm3-6b's
    4 x 1024 prompts in 'heads' decode and mamba2's 4 x 32 through
    ``warm_up``, held by the same checks as their (2, 2) serving (one
    checker each for a cell's training and its serving, on any grid).

Each phase's wall seconds go to a log line of their own as it ends, and
all of them to one line before the records. Exits non-zero if any phase
fails. The last three lines of standard output
are the card line, a JSON ``kernels`` record and a JSON ``ok`` record.
"""
import collections
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B  # noqa: E402
from repro_torch.configs.chatglm3_6b import CONFIG as CHATGLM3_6B  # noqa: E402
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B  # noqa: E402
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B  # noqa: E402
from repro_torch.configs.kimi_k2 import CONFIG as KIMI_K2  # noqa: E402
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B  # noqa: E402
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE  # noqa: E402
from repro_torch.configs.phi3_mini import CONFIG as PHI3_MINI  # noqa: E402
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M  # noqa: E402
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.sodda_svm import SoddaConfig, TABLE1_250K_18K  # noqa: E402
from repro_torch.core import (driver, engine, losses, partition,  # noqa: E402
                               radisa, sodda)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.plane import (DenseDataPlane,  # noqa: E402
                                    StreamingDataPlane, TiledDataPlane)
from repro_torch.data.synthetic import make_svm_data  # noqa: E402
from repro_torch.distributed import run_elastic, shrink_plane  # noqa: E402
from repro_torch.distributed.sharding_rules import split_size  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as flash_build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sodda_inner as kernel_build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402
from repro_torch.launch import serve as serve_module  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.launch import train as train_module  # noqa: E402
from repro_torch.launch.serve import (make_serve_steps, serve,  # noqa: E402
                                      warm_up)
from repro_torch.models import Model, input_specs, transformer  # noqa: E402
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import moe as mmoe  # noqa: E402
from repro_torch.models import ssm as mssm  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.testing import tolerances as tol  # noqa: E402
from repro_torch.testing.mesh_order import (  # noqa: E402
    snapshot_as, snapshot_gradient_in_mesh_order)
from repro_torch.testing.multiprocess import tile_digest  # noqa: E402
from repro_torch.testing.padded_heads import padded_wo_gradient  # noqa: E402

ITERS = 20  # outer iterations of each Table-1 run
RECORD_EVERY = 5
SEED = 0

# H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# flash_attention against its plain version: tests/test_kernels.py:201
# holds the Pallas kernel to its oracle at 2e-5 in f32. The f32 route runs
# on the bf16 tensor cores (q, k, v and P in three bf16 pieces each), so
# a control must fail it: every operand of the tensor-core products rounded
# once to bf16 (``ref.attention_ref(in_pieces=1, mid_pieces=1)``; on the
# CPU its gap is >= 9.7e-4 of max|v|, the kernel's emulation 2.0e-7,
# tests/test_torch_flash_fwd_split.py).
FLASH_F32_TOL = 2e-5
F32_SPLIT_CONTROL = dict(in_pieces=1, mid_pieces=1)
# In bf16 a sound kernel rounds its f32 result to the nearest bf16, so each
# output lies within half a bf16 ulp of the plain version run on f32 copies
# of the inputs, give or take the f32 summation noise of either, which is
# held to F32_NOISE x max|v|. Two controls must fail it: scores rounded to
# bf16 before the softmax (as the JAX reference's einsum does), and P
# rounded to bf16 before P.V (as a textbook tensor-core kernel does). On an
# H100 the wgmma kernel's excess was at most 7.837e-07, the bf16-score
# control's at least 6.845e-05 and the P-in-bf16 control's at least
# 3.089e-05 (every bf16 case and all 42 layers of the serving run): the
# limit sits ~5x from the kernel and ~8x from the nearer control.
F32_NOISE = 2.0 ** -18
# the decode-vs-forward tolerance of tests/test_models.py:74
MODEL_TOL = 2e-4
# ssd_scan against its plain version: tests/test_kernels.py:258 holds the
# Pallas kernel to the recurrence at 1e-4 in f32; in bf16 the rule is
# F32_NOISE's, over max|y|.
SSD_F32_TOL = 1e-4
SSD_SHAPE = (16, 2048, 24, 64, 1, 128)  # (B, S, H, P, G, N): a serving layer
SSD_TRAIN_SHAPE = (8, 2048, 24, 64, 1, 128)  # mamba2-130m's training layer
# The f32 route runs on the bf16 tensor cores (every operand in three bf16
# pieces), so beside the 1e-4 rule each f32 output is held within
# SSD_F32_ORACLE_TOL x max|y| of the f64 oracle (the plain chunked SSD on
# f64 copies, at the kernel's chunk). The CPU emulation of the kernel's
# pieces is ~1e-8 off (tests/test_torch_ssd_fwd_split.py). Two controls must
# fail it: the carry dropped, and every operand of the tensor-core products
# rounded once to bf16 (``ref.ssd_chunk_terms(in_pieces=1, mid_pieces=1)``,
# 3e-4 to 1.3e-3 on the CPU).
SSD_F32_ORACLE_TOL = 1e-5
# the f32 route's earlier CUDA-core design (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §5-6): the times the tensor-core kernel replaces
SSD_F32_CUDA_CORE_MS = {"mamba2 training layer": 2.167,
                        "mamba2 layer": 3.3041, "zamba2 layer": 5.0282}
# a prompt of 512 (2 chunks of the floor's 256): its decode warm-up, one
# position at a time through 24 f32 layers, took ~25 s of the run at 1024
SSM_F32_B, SSM_F32_PROMPT, SSM_F32_FED = 2, 512, 8
# Full-depth f32 mamba2: the plain path against itself at another chunk
# length (the same function summed in another order) moves single logits
# by ~3e-4, past the elementwise 2e-4 rule, so the logits are held by
# their rms gap to that floor; each layer's SSD is held to SSD_F32_TOL.
FLOOR_FACTOR = 2.0
# 2048: the context of the Mamba-2 paper's language-model runs; served at
# SSM_SERVE_LAYERS of mamba2-130m's 24 layers (full width): the decode
# warm-up over the prompt is host-bound, ~1.7 ms a layer a position, and
# at full depth took 82 s on an H100 80GB HBM3 (700 W) host
SSM_SERVE_B, SSM_SERVE_PROMPT, SSM_SERVE_GEN = 16, 2048, 32
SSM_SERVE_LAYERS = 12
# the whole serve call feeds the first SSM_SERVE_FED prompt positions
# through decode (the time to the first token is the 2048-position prefill,
# timed alone): the host-bound warm-up takes ~14 ms a position, 28.5 s of
# the run over all 2048 on an H100 80GB HBM3 at 700 W; zamba2's is cut
# the same way (HYB_SERVE_PROMPT)
SSM_SERVE_FED = 256
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 4608, 32  # 4608 = 36 x 128 > 4096
# zamba2-7b: the shared attention's flash layer (B, H, KV, S, S, D) at the
# serving prefill, and phi3-mini's (head dim 96, the same kernel layout)
ZAMBA2_FLASH = (4, 32, 32, 4096, 4096, 112)
PHI3_FLASH = (4, 32, 32, 4096, 4096, 96)
ZAMBA2_SSD = (4, 4096, 112, 64, 1, 64)  # (B, S, H, P, G, N) of its prefill
# the serving cell: 4 x 4096 prompt tokens prefilled alone (the time to the
# first token), then a whole serve call on 4 x 64 fed through decode
# (eager decode costs ~81 layers of launches a position: 256 positions
# took 38.5 s of the run) and 32 generated
HYB_B, HYB_PROMPT, HYB_SERVE_PROMPT, HYB_GEN = 4, 4096, 64, 32
# the exactness cell: full width, 12 layers (2 shared-block sites), f32
HYB_F32_LAYERS, HYB_F32_B, HYB_F32_PROMPT = 12, 2, 256
CUT_DEPTH_LAYERS, CUT_DEPTH_B, CUT_DEPTH_GEN = 4, 2, 8
# The rest of the dense stack (phi3-mini, minitron-8b, chatglm3-6b,
# musicgen-large and internvl2-26b): each cell's text prompt tokens at full
# size (4 requests, 32 generated) and at the 4-layer f32 cut (2 requests, 8
# generated). 4064 + 32 = 4096 positions, phi3-mini-4k's and minitron's
# context; internvl2 puts its 256 frontend embeddings ahead of 3808 text
# tokens (4096 again); musicgen 1468 + 32 = 1500 codec frames, 30 s at
# EnCodec's 50 Hz.
DENSE_CELLS = ((PHI3_MINI, 4064, 1024), (MINITRON_8B, 4064, 1024),
               (CHATGLM3_6B, 4064, 1024), (MUSICGEN_LARGE, 1468, 1024),
               (INTERNVL2_26B, 3808, 768))
# 8 generated: eager decode is host-bound at 22-106 ms a token on an
# H100 80GB HBM3 at 700 W, and the run's time limit is shared
DENSE_B, DENSE_GEN = 4, 8
# their flash layers (B, H, KV, S, S, D) at the serving prefill, beside
# phi3-mini's (PHI3_FLASH): GQA groups of 16, 6, 4 and 1, an unaligned S
DENSE_FLASH = (("chatglm3-6b layer", (4, 32, 2, 4064, 4064, 128)),
               ("internvl2-26b layer", (4, 48, 8, 4064, 4064, 128)),
               ("minitron-8b layer", (4, 32, 8, 4064, 4064, 128)),
               ("musicgen-large layer", (4, 32, 32, 1468, 1468, 64)))
# The MoE family's flash layer at the serving prefill: 64 q heads over 8 kv
# heads (arctic-480b's 56 padded to 64, whose padded heads' wo rows are
# zero; kimi-k2's 64 of head dim 128), the same call for both
MOE_FLASH = (("arctic-480b / kimi-k2 layer", (4, 64, 8, 4064, 4064, 128)),)
# Serving in bf16 at full width, cut in depth to fit one card: arctic keeps
# all 128 experts at 2 of its 35 layers (26.78 GB of expert weights a
# layer), kimi all 384 at 1 of its 61 (33.82 GB a layer; 2 would not fit).
# 4 requests of 4064 prompt tokens, 32 generated, as the dense cells.
MOE_SERVE = ((ARCTIC_480B, 2), (KIMI_K2, 1))
MOE_PROMPT = 4064
# The exactness cells, f32, 1 layer: arctic with all 128 experts (56.3 GB),
# kimi with 192 of its 384 (43.7 GB; all 384 would take 77.5 GB), top-8.
MOE_CUT = ((ARCTIC_480B, 128), (KIMI_K2, 192))
MOE_CUT_B, MOE_CUT_PROMPT = 2, 1024
# At most this share of the (token, slot) routes may differ between the
# kernel and plain paths in f32: a route flips only where a token's k-th
# and (k+1)-th router probabilities lie within the paths' f32 gap.
MOE_FLIP_LIMIT = 1e-3
# phase_moe_routing: the logit added to expert 0 so that more than its
# capacity of tokens choose it
MOE_SKEW = 4.0
# Full depth in bf16: the rms gap of the kernel path's last-token logits to
# the plain path's, against the plain path's gap to itself summed in
# 256-key chunks (the summation-order floor of 42 bf16 layers).
RMS_GAP_FACTOR = 1.2

# tests/test_kernels.py:35 — one kernel call against its plain version:
# the kernel hoists z0 and reduces in another order than the plain loop.
KERNEL_RTOL, KERNEL_ATOL = 3e-4, 2e-5
# Step size of the kernel-check inputs. Hinge and logistic have bounded
# derivatives; the squared loss's chain multiplies the x-direction by
# (1 - gamma*|x|^2) each step, so it needs gamma*|x|^2 < 2 (|x|^2 ~ mt).
KERNEL_GAMMA = {"hinge": 0.01, "logistic": 0.01, "squared": 1e-4}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)



# prctl(2): orphans of this process's descendants are handed to it
PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans():
    """Make this process the reaper of its descendants' orphans, so a
    process left behind by a child that was killed stays below it, where
    ``stop_descendants`` finds it."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail(f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno "
             f"{ctypes.get_errno()}")


def descendants():
    """{pid: command line} of every process below this one, zombies too."""
    parent, me = {}, os.getpid()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:  # exited meanwhile
            continue
        parent[int(entry)] = int(stat[stat.rindex(")") + 2:].split()[1])
    below, grew = set(), True
    while grew:
        new = {p for p, pp in parent.items()
               if (pp == me or pp in below) and p not in below}
        below |= new
        grew = bool(new)
    out = {}
    for pid in sorted(below):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        out[pid] = cmd.strip() or "(zombie)"
    return out


def stop_descendants():
    """Stop every process this one started that is still there: the
    multiprocessing resource tracker of the mesh spawns by its own
    shutdown, then anything else by SIGKILL, each reaped. Logs and
    returns the command lines of those it had to kill."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    killed = {}
    for _ in range(100):
        left = descendants()
        if not left:
            if killed:
                log(f"stopped {len(killed)} processes left at the end: "
                    f"{list(killed.values())}")
            return list(killed.values())
        for pid, cmd in left.items():
            killed.setdefault(pid, cmd)
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        while True:  # reap: every orphan is a child of this process
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
        time.sleep(0.05)
    fail(f"processes still running after SIGKILL: {descendants()}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(B, L, mt, gen):
    """Inputs shaped like the main path's: unit-variance X rows, +-1
    labels, a small iterate and exchange vector."""
    dev = "cuda"
    Xl = (torch.rand(B, L, mt, generator=gen, device=dev) * 2 - 1) * 3 ** 0.5
    yl = torch.where(torch.rand(B, L, generator=gen, device=dev) < 0.5,
                     -1.0, 1.0)
    w0 = torch.randn(B, mt, generator=gen, device=dev) * 0.01
    mu = torch.randn(B, mt, generator=gen, device=dev) * 1e-3
    return w0, Xl, yl, mu


def kernel_bound_ms(B, L, mt):
    """Least time for one call: bytes (each input read once, the output
    written once) over HBM rate vs f32 operations over the f32 peak."""
    nbytes = 4 * (3 * B * mt + B * L * mt + B * L + 1)
    flops = 8.0 * B * L * mt  # z0 dots 2, per step dot 2 + update 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# sodda_inner's cases: the Table-1 widths m_tilde = 1200 (SMALL and the
# 250k x 18k instance), 1400 (MEDIUM) and 1800 (LARGE); an unaligned mt, a
# row pitch that is no multiple of 16 bytes (the cp.async copy), L = 1, an
# mt above the register buckets (wbar in shared memory) and the largest mt
# the one-block-per-chain kernel of the first slice took at L = 3.
KERNEL_SHAPES = ((15, 64, 1200), (15, 64, 1400), (15, 64, 1800), (2, 8, 100),
                 (3, 5, 301), (3, 1, 1200), (3, 16, 2100), (2, 3, 19344))
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 10


def graph_ms(fn):
    """Device time of one fn() by a CUDA graph of GRAPH_LAUNCHES calls,
    replayed GRAPH_REPLAYS times between CUDA events: the kernels alone,
    without the host's time per call."""
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * GRAPH_LAUNCHES)


def host_us(fn, reps=200):
    """Host time of one fn() call in microseconds (no synchronisation
    inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * spent / reps


def phase_kernel():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    for (B, L, mt) in KERNEL_SHAPES:
        for loss in ("hinge", "logistic", "squared"):
            args = kernel_inputs(B, L, mt, gen)
            gamma = KERNEL_GAMMA[loss]
            a = ops.sodda_inner(*args, gamma, loss, force="cuda")
            b = ops.sodda_inner(*args, gamma, loss, force="cuda")
            want = ops.sodda_inner(*args, gamma, loss, force="ref")
            torch.cuda.synchronize()
            check(torch.equal(a, b),
                  f"sodda_inner {loss} {(B, L, mt)}: two launches differ")
            check(bool(torch.isfinite(a).all()),
                  f"sodda_inner {loss} {(B, L, mt)}: non-finite output")
            torch.testing.assert_close(a, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
            err = float((a - want).abs().max())
            max_err = max(max_err, err)
            log(f"kernel {loss:8s} {(B, L, mt)}: bitwise across launches, "
                f"max|kernel-plain| = {err:.3e}; bucket "
                f"{kernel_build.bucket(mt)}, {kernel_build.ring_slots(L, mt)}"
                f" ring slots, {kernel_build.row_copy(mt, args[1].data_ptr())}"
                f" row copy, {kernel_build.shared_memory_bytes(L, mt)} bytes "
                "of shared memory")

    B, L, mt = 15, 64, 1200  # Table-1: P*Q chains of L rows, m_tilde wide
    args = kernel_inputs(B, L, mt, gen)

    def launch():
        return ops.sodda_inner(*args, 0.01, "hinge", force="cuda")

    ms = graph_ms(launch)
    wrapper_ms = cuda_ms(launch, reps=200)
    wrapper_host_us = host_us(launch)
    plain_ms = cuda_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                               force="ref"), reps=10)
    bound_ms, bound_by = kernel_bound_ms(B, L, mt)
    log(f"kernel sodda_inner (15, 64, 1200) hinge: {ms:.5f} ms (a CUDA graph "
        f"of {GRAPH_LAUNCHES} launches replayed {GRAPH_REPLAYS} times: the "
        f"kernel), bound {bound_ms:.5f} ms ({bound_by}), kernel/bound "
        f"{ms / bound_ms:.1f}x; the wrapper takes {wrapper_host_us:.1f} us "
        f"of host time a call; plain {plain_ms:.4f} ms")
    log(f"kernel sodda_inner (15, 64, 1200) hinge, CUDA events around "
        f"back-to-back wrapper calls (the earlier method): {wrapper_ms:.5f} "
        "ms")
    for mt_wide in (1400, 1800):
        wide = kernel_inputs(B, L, mt_wide, gen)
        wide_ms = graph_ms(lambda: ops.sodda_inner(*wide, 0.01, "hinge",
                                                   force="cuda"))
        log(f"kernel sodda_inner (15, 64, {mt_wide}) hinge: {wide_ms:.5f} ms "
            f"(CUDA graph), bound {kernel_bound_ms(B, L, mt_wide)[0]:.5f} ms")
    return dict(name="sodda_inner", route="cuda",
                source="src/repro_torch/kernels/csrc/sodda_inner.cu",
                replaces="src/repro/kernels/sodda_inner.py:75",
                launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def phase_small():
    """The cuda backend on the card against the reference backend on the
    CPU: same data, same samples (drawn on the CPU and copied over)."""
    for loss in ("hinge", "logistic", "squared"):
        cfg = SoddaConfig(name=f"smoke-small-{loss}", loss=loss, P=4, Q=3,
                          n=500, m=120, L=8,
                          lr0=0.02 if loss == "squared" else 0.05)
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        X, y, _ = make_svm_data(gen, cfg.N, cfg.M, device="cpu")
        b, c, d = sodda._counts(cfg)

        def sampler_on(dev):
            def sampler(t):
                s = partition.sample_iteration(SEED, t, cfg.P, cfg.Q, cfg.n,
                                               cfg.M, cfg.L, b, c, d, "cpu")
                return partition.IterationSample(*(f.to(dev) for f in s))
            return sampler

        ref_state, ref_hist = driver.run(SEED, (X, y), cfg, 10, "reference",
                                         record_every=2, device="cpu",
                                         sampler=sampler_on("cpu"))
        state, hist = driver.run(SEED, (X.cuda(), y.cuda()), cfg, 10, "cuda",
                                 record_every=2, device="cuda",
                                 sampler=sampler_on("cuda"))
        tol.assert_trajectories_close([ref_state.w.numpy()],
                                      [state.w.cpu().numpy()],
                                      tol.F32_REDUCTION, f"small {loss}")
        for (t, f_ref), (_, f) in zip(ref_hist, hist):
            tol.assert_objectives_close(f_ref, f, tol.F32_REDUCTION,
                                        f"small {loss} t={t}")
        check(hist[-1][1] < hist[0][1], f"small {loss}: no descent {hist}")
        log(f"small {loss:8s} cuda vs cpu reference: F32_REDUCTION holds, "
            f"F {hist[0][1]:.6f} -> {hist[-1][1]:.6f}")


def phase_breakdown(cfg, X, y, w):
    """Device time of each layer of one Table-1 iteration (CUDA events)."""
    b, c, d = sodda._counts(cfg)

    def draw():
        return partition.sample_iteration(SEED, 7, cfg.P, cfg.Q, cfg.n,
                                          cfg.M, cfg.L, b, c, d, X.device)

    smp = draw()
    mu = sodda.snapshot_gradient(cfg.loss, X, y, w, smp, cfg.P * d)
    gamma = float(sodda._gamma(cfg, 7))
    parts = {
        "sample_iteration": cuda_ms(draw, reps=10),
        "snapshot_gradient (2 GEMVs)": cuda_ms(
            lambda: sodda.snapshot_gradient(cfg.loss, X, y, w, smp,
                                            cfg.P * d), reps=10),
        "consume_update (gather + kernel + concat)": cuda_ms(
            lambda: sodda.consume_update(X, y, w, mu, smp, gamma, cfg, True),
            reps=10),
        "objective (1 GEMV)": cuda_ms(
            lambda: losses.objective(cfg.loss, X, y, w), reps=10),
    }
    for name, ms in parts.items():
        log(f"breakdown {name}: {ms:.4f} ms")
    split = consume_update_split(cfg, X, y, w, mu, smp, gamma)
    log("breakdown consume_update split: "
        + ", ".join(f"{name} {ms:.4f} ms" for name, ms in split.items())
        + f"; sum {sum(split.values()):.4f} ms")
    return parts


def consume_update_split(cfg, X, y, w, mu, smp, gamma):
    """Device time of the three parts of ``sodda.consume_update`` with the
    kernel (CUDA events, each part alone): the gather of the working sets,
    the kernel, and the conflict-free concatenation. The parts repeat that
    function's lines; ``core/sodda.py`` is not changed for it."""
    P, Q, n, m, L, mt = cfg.P, cfg.Q, cfg.n, cfg.m, cfg.L, cfg.m_tilde
    dev = X.device
    p_ar = torch.arange(P, device=dev)
    q_ar = torch.arange(Q, device=dev)

    def gather():
        k = smp.pi.T
        rows = p_ar[:, None, None] * n + smp.J
        col0 = partition.block_col_start(q_ar[None, :], k, m, mt)
        cols = col0[..., None] + torch.arange(mt, device=dev)
        Xl = X[rows[..., :, None], cols[..., None, :]]
        wb = w.view(Q, P, mt)
        return (wb[q_ar[None, :], k].reshape(P * Q, mt),
                Xl.reshape(P * Q, L, mt), y[rows].reshape(P * Q, L),
                mu.view(Q, P, mt)[q_ar[None, :], k].reshape(P * Q, mt))

    w0, Xl, yl, mu_blk = gather()
    wL = ops.sodda_inner(w0, Xl, yl, mu_blk, gamma, cfg.loss).view(P, Q, mt)

    def concat():
        new_wb = w.view(Q, P, mt).clone()
        new_wb[q_ar.repeat_interleave(P), smp.pi.reshape(-1)] = (
            wL.transpose(0, 1).reshape(Q * P, mt))
        return new_wb.view(cfg.M)

    check(torch.equal(concat(), sodda.consume_update(X, y, w, mu, smp, gamma,
                                                     cfg, True)),
          "consume_update split: the parts do not give consume_update")
    return {"gather": cuda_ms(gather, reps=10),
            "kernel": cuda_ms(lambda: ops.sodda_inner(w0, Xl, yl, mu_blk,
                                                      gamma, cfg.loss),
                              reps=10),
            "concatenation": cuda_ms(concat, reps=10)}


def phase_table1(cfg):
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    X, y, _ = make_svm_data(gen, cfg.N, cfg.M)
    torch.cuda.synchronize()
    x_bytes = X.numel() * X.element_size()
    log(f"table1 data {cfg.N} x {cfg.M} generated on the card in "
        f"{time.perf_counter() - t0:.3f} s; X = {x_bytes / 1e9:.3f} GB")
    check(bool(torch.isfinite(X[:1000]).all()), "non-finite data")

    for backend in ("cuda", "reference"):  # warm-up: cuBLAS handles etc.
        driver.run(SEED, (X, y), cfg, 2, backend, record_every=2)
    runs = {}
    for backend in ("cuda", "reference"):
        if backend == "cuda":
            ops.sodda_inner.launches = 0  # the main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = driver.run(SEED, (X, y), cfg, ITERS, backend,
                                 record_every=RECORD_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if backend == "cuda":
            launches = ops.sodda_inner.launches  # ... and ends here
        runs[backend] = (state, hist, 1e3 * wall / ITERS)
        log(f"table1 {backend:9s}: {1e3 * wall / ITERS:.3f} ms/iteration "
            f"over {ITERS} iterations (objective every {RECORD_EVERY}); "
            f"history {[(t, round(f, 6)) for t, f in hist]}")

    check(launches == ITERS,
          f"sodda_inner launched {launches} times in {ITERS} iterations")
    (st_c, h_c, ms_c), (_, h_r, _) = runs["cuda"], runs["reference"]
    check(all(math.isfinite(f) for _, f in h_c), f"non-finite objective {h_c}")
    check(h_c[-1][1] < h_c[0][1], f"objective did not descend: {h_c}")
    check(bool(torch.isfinite(st_c.w).all()), "non-finite iterate")
    # Hinge's derivative is a step at y*z = 1, so the kernel's reduction
    # order may flip a branch in a long trajectory: hold hinge at the
    # objective level (F32_REDUCTION's obj_rel), and the logistic twin below
    # to the full F32_REDUCTION trajectory policy.
    for (t, f_r), (_, f_c) in zip(h_r, h_c):
        tol.assert_objectives_close(f_r, f_c, tol.F32_REDUCTION,
                                    f"table1 hinge t={t}")
    log("table1 hinge: cuda and reference histories agree (F32_REDUCTION "
        "objective level)")

    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    ws, hs = [], []
    for backend in ("cuda", "reference"):
        st, h = driver.run(SEED, (X, y), lcfg, ITERS, backend,
                           record_every=RECORD_EVERY)
        ws.append(st.w.cpu().numpy())
        hs.append(h)
    tol.assert_trajectories_close([ws[1]], [ws[0]], tol.F32_REDUCTION,
                                  "table1 logistic final w")
    for (t, f_r), (_, f_c) in zip(hs[1], hs[0]):
        tol.assert_objectives_close(f_r, f_c, tol.F32_REDUCTION,
                                    f"table1 logistic t={t}")
    log(f"table1 logistic twin: F32_REDUCTION holds, F {hs[0][0][1]:.6f} -> "
        f"{hs[0][-1][1]:.6f}")

    peak = torch.cuda.max_memory_allocated()
    log(f"table1 peak device memory {peak / 1e9:.3f} GB = "
        f"{peak / x_bytes:.4f} x X")
    check(peak <= 1.1 * x_bytes, f"peak memory {peak} > 1.1 x X")
    return X, y, st_c.w, launches, ms_c


# ---------------------------------------------------------------------------
# The paper's baseline and the stale-by-one backend over the tiled plane
# ---------------------------------------------------------------------------
RADISA_SHAPE = (15, 64, 6000)  # radisa-avg at Table-1: P*Q chains, m wide


def plain_run(cfg, X, y, step):
    """``driver.run``'s loop and ticks around ``step(state) -> state``, for
    a plain-version step no backend runs."""
    state = sodda.init_state(SEED, cfg.M, X.device)
    hist = []
    for length in driver._chunk_lengths(ITERS, RECORD_EVERY):
        hist.append(losses.objective(cfg.loss, X, y, state.w))
        for _ in range(length):
            state = step(state)
    hist.append(losses.objective(cfg.loss, X, y, state.w))
    return state, list(zip(driver.record_ticks(ITERS, RECORD_EVERY),
                           torch.stack(hist).tolist()))


def timed_run(data, cfg, backend, iters=ITERS, record_every=RECORD_EVERY,
              **options):
    """``driver.run`` between synchronisations: (state, history, ms per
    iteration)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = driver.run(SEED, data, cfg, iters, backend,
                             record_every=record_every, **options)
    torch.cuda.synchronize()
    return state, hist, 1e3 * (time.perf_counter() - t0) / iters


def inner_loop_fused(loss, w0, Xl, yl, mu, gamma):
    """``kref.sodda_inner_ref`` with each step's update rounded as fused
    multiply-adds (``addcmul``, ``add(alpha=)``), as the kernel rounds it:
    the plain version a hinge trajectory is held to."""
    wbar = w0
    for i in range(Xl.shape[-2]):
        x, yy = Xl[..., i, :], yl[..., i]
        c = (losses.loss_deriv(loss, (x * wbar).sum(-1), yy)
             - losses.loss_deriv(loss, (x * w0).sum(-1), yy))
        wbar = torch.add(wbar, torch.addcmul(mu, c[..., None], x),
                         alpha=-gamma)
    return wbar


@contextlib.contextmanager
def radisa_inner_as(fn):
    """Route ``radisa_avg_step``'s plain chains to fn inside the block."""
    orig = radisa.inner_loop
    radisa.inner_loop = fn
    try:
        yield
    finally:
        radisa.inner_loop = orig


def kink_sides(X, y, w_a, w_b):
    """Rows of X on different sides of the hinge kink y x.w = 1 at w_a and
    at w_b."""
    return int(((y * (X @ w_a) < 1) != (y * (X @ w_b) < 1)).sum())


def phase_tiled_plane(cfg):
    """The tiled plane materialised on the card: its time, its peak over X,
    and one tile and one label block against the same blocks regenerated
    alone. Also logs whether ``uniform_`` writing into a strided view of X
    gives the tile's bits (the plane copies from a contiguous temporary,
    so its bits do not depend on the answer)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plane = TiledDataPlane(SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    t0 = time.perf_counter()
    X, y = plane.materialize_for("radisa-avg")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x_bytes = X.numel() * X.element_size()
    peak = (torch.cuda.max_memory_allocated() - base) / x_bytes
    log(f"tiled plane {cfg.N} x {cfg.M} on a ({cfg.P}, {cfg.Q}) grid "
        f"materialised on the card in {seconds:.3f} s; X = "
        f"{x_bytes / 1e9:.3f} GB, a tile {plane.tile_nbytes / 1e9:.3f} GB; "
        f"peak {peak:.4f} x X")
    check(peak <= 1.1, f"tiled plane: peak {peak:.4f} x X > 1.1")
    n, m = plane.n, plane.m
    p, q = cfg.P - 2, cfg.Q - 2
    view = X[p * n:(p + 1) * n, q * m:(q + 1) * m]
    check(torch.equal(view, plane.x_tile(p, q)),
          f"tiled plane: tile ({p}, {q}) differs from the tile alone")
    check(torch.equal(y[(p + 1) * n:(p + 2) * n], plane.y_block(p + 1)),
          f"tiled plane: label block {p + 1} differs from the block alone")
    check(bool(torch.isfinite(X[:1000]).all()), "non-finite data")
    gen = partition.seeded_generator(X.device, SEED, synthetic._X_STREAM, p,
                                     q)
    view.uniform_(-1.0, 1.0, generator=gen)
    view.mul_(float(synthetic.SVM_UNIT_VARIANCE_SCALE))
    same = torch.equal(view, plane.x_tile(p, q))
    view.copy_(plane.x_tile(p, q))
    log(f"tiled plane: tile ({p}, {q}) and label block {p + 1} bitwise "
        "equal to the blocks regenerated alone; uniform_ into the strided "
        f"view of X gives the tile's bits: {same}")
    return X, y


def phase_kernel_at(shape, seed):
    """sodda_inner at one launch shape of a path, for all three losses:
    bitwise across launches, within tolerance of the plain version, and
    timed by a CUDA graph beside its bound. Returns the hinge time in ms."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, L, mt = shape
    for loss in ("hinge", "logistic", "squared"):
        args = kernel_inputs(B, L, mt, gen)
        gamma = KERNEL_GAMMA[loss]
        a = ops.sodda_inner(*args, gamma, loss, force="cuda")
        b = ops.sodda_inner(*args, gamma, loss, force="cuda")
        want = ops.sodda_inner(*args, gamma, loss, force="ref")
        torch.cuda.synchronize()
        check(torch.equal(a, b),
              f"sodda_inner {loss} {shape}: two launches differ")
        check(bool(torch.isfinite(a).all()),
              f"sodda_inner {loss} {shape}: non-finite output")
        torch.testing.assert_close(a, want, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        log(f"kernel {loss:8s} {shape}: bitwise across launches, "
            f"max|kernel-plain| = {float((a - want).abs().max()):.3e}; "
            f"bucket {kernel_build.bucket(mt)}, "
            f"{kernel_build.ring_slots(L, mt)} ring slots, "
            f"{kernel_build.row_copy(mt, args[1].data_ptr())} row copy, "
            f"{kernel_build.shared_memory_bytes(L, mt)} bytes of shared "
            "memory")
    args = kernel_inputs(B, L, mt, gen)
    ms = graph_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                          force="cuda"))
    plain_ms = cuda_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                               force="ref"), reps=5)
    bound_ms, bound_by = kernel_bound_ms(B, L, mt)
    log(f"kernel sodda_inner {shape} hinge: {ms:.5f} ms (CUDA "
        f"graph), bound {bound_ms:.5f} ms ({bound_by}), kernel/bound "
        f"{ms / bound_ms:.1f}x; plain {plain_ms:.4f} ms")
    return ms


def phase_radisa_kernel():
    """sodda_inner at radisa-avg's Table-1 launch."""
    phase_kernel_at(RADISA_SHAPE, SEED + 1)


def phase_radisa_async(cfg, X, y):
    """radisa-avg and async through ``driver.run`` on the materialised
    tiled plane (wrapped as a dense plane, so it is not generated again):
    launches, agreement with the plain path and with ``cuda``, descent,
    and the paper's SODDA vs RADiSA-avg comparison (a finding, no gate)."""
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    for backend in ("radisa-avg", "async", "cuda"):  # warm-up
        driver.run(SEED, data, cfg, 2, backend, record_every=2)

    ops.sodda_inner.launches = 0  # the radisa-avg path starts here
    st_r, h_r, ms_r = timed_run(data, cfg, "radisa-avg")
    launches = ops.sodda_inner.launches  # ... and ends here
    log(f"radisa-avg: {ms_r:.3f} ms/iteration over {ITERS} iterations "
        f"(objective every {RECORD_EVERY}); {launches} launches; history "
        f"{[(t, round(f, 6)) for t, f in h_r]}")
    check(launches == ITERS,
          f"radisa-avg launched sodda_inner {launches} times in {ITERS} "
          "iterations")
    check(all(math.isfinite(f) for _, f in h_r), f"non-finite {h_r}")
    check(h_r[-1][1] < h_r[0][1], f"radisa-avg did not descend: {h_r}")
    # Hinge. (1) Every iteration of that trajectory, stepped from the same
    # state by the kernel and by the plain version, to F32_REDUCTION in
    # full. (2) The trajectory, at the objective level, to F32_REDUCTION
    # against the plain path whose chains round their update as the kernel
    # does (fused multiply-adds). Hinge's subgradient is a step at
    # y*z = 1, so that rounding alone moves rows of X across the kink over
    # 20 iterations; the plain path with unfused updates departs from both,
    # which is printed beside it, not gated.
    state, worst = sodda.init_state(SEED, cfg.M, X.device), 0.0
    for t in range(1, ITERS + 1):
        k = radisa.radisa_avg_step(state, X, y, cfg, use_kernel=True)
        p = radisa.radisa_avg_step(state, X, y, cfg, use_kernel=False)
        tol.assert_trajectories_close([p.w.cpu().numpy()],
                                      [k.w.cpu().numpy()], tol.F32_REDUCTION,
                                      f"radisa-avg hinge step {t}")
        tol.assert_objectives_close(
            float(losses.objective(cfg.loss, X, y, p.w)),
            float(losses.objective(cfg.loss, X, y, k.w)), tol.F32_REDUCTION,
            f"radisa-avg hinge step {t}")
        worst = max(worst, float((k.w - p.w).abs().max()))
        state = k
    check(torch.equal(state.w, st_r.w),
          "radisa-avg: stepping by hand is not driver.run's trajectory")
    log(f"radisa-avg hinge: each of the {ITERS} iterations, kernel and plain "
        "from the same state, within F32_REDUCTION (w and objective); "
        f"max|w_kernel - w_plain| = {worst:.3e}")
    with radisa_inner_as(inner_loop_fused):
        st_f, h_fused = plain_run(cfg, X, y, lambda s: radisa.radisa_avg_step(
            s, X, y, cfg, use_kernel=False))
    for (t, f_f), (_, f_k) in zip(h_fused, h_r):
        tol.assert_objectives_close(f_f, f_k, tol.F32_REDUCTION,
                                    f"radisa-avg hinge t={t} (fused plain)")
    st_p, h_plain = plain_run(cfg, X, y, lambda s: radisa.radisa_avg_step(
        s, X, y, cfg, use_kernel=False))

    def gaps(a, b):
        floor = tol.F32_REDUCTION.obj_floor
        return [f"{abs(fa - fb) / max(abs(fa), floor):.2e}"
                for (_, fa), (_, fb) in zip(a, b)]

    log(f"radisa-avg hinge trajectory: within F32_REDUCTION of the plain "
        f"path with fused multiply-adds in the chains at every tick, "
        f"relative gap {gaps(h_fused, h_r)}; the unfused plain path "
        f"(a finding, not gated) {[round(f, 6) for _, f in h_plain]}, "
        f"relative gap to the kernel {gaps(h_plain, h_r)}, to the fused "
        f"plain path {gaps(h_plain, h_fused)} (F32_REDUCTION allows "
        f"{tol.F32_REDUCTION.obj_rel:.0e}); rows of X on other sides of the "
        f"hinge kink at the final iterates: kernel vs unfused plain "
        f"{kink_sides(X, y, st_r.w, st_p.w)}, fused vs unfused plain "
        f"{kink_sides(X, y, st_f.w, st_p.w)}, kernel vs fused plain "
        f"{kink_sides(X, y, st_r.w, st_f.w)} of {cfg.N}")
    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    st_l, h_l = driver.run(SEED, data, lcfg, ITERS, "radisa-avg",
                           record_every=RECORD_EVERY)
    st_lp, h_lp = plain_run(lcfg, X, y, lambda s: radisa.radisa_avg_step(
        s, X, y, lcfg, use_kernel=False))
    tol.assert_trajectories_close([st_lp.w.cpu().numpy()],
                                  [st_l.w.cpu().numpy()], tol.F32_REDUCTION,
                                  "radisa-avg logistic final w")
    for (t, f_p), (_, f_k) in zip(h_lp, h_l):
        tol.assert_objectives_close(f_p, f_k, tol.F32_REDUCTION,
                                    f"radisa-avg logistic t={t}")
    check(h_l[-1][1] < h_l[0][1], f"radisa-avg logistic: no descent {h_l}")
    log("radisa-avg logistic twin: kernel and plain trajectories within "
        f"F32_REDUCTION in full, F {h_l[0][1]:.6f} -> {h_l[-1][1]:.6f}")

    sync = engine.make_bundle(cfg, "cuda")
    stale0 = engine.make_bundle(cfg, "async", staleness=0)
    state = sodda.init_state(SEED, cfg.M, X.device)
    carry = stale0.init_carry(state, X, y)
    for t in range(1, ITERS + 1):
        state, carry = sync.step(state, X, y), stale0.step(carry, X, y)
        check(torch.equal(state.w, carry.w),
              f"async staleness 0 differs from cuda at iteration {t}")
    st_c, h_c, ms_c = timed_run(data, cfg, "cuda")
    st_0, h_0, _ = timed_run(data, cfg, "async", staleness=0)
    check(h_0 == h_c and torch.equal(st_0.w, st_c.w),
          f"async staleness 0 history {h_0} is not cuda's {h_c}")
    log(f"async staleness 0: bitwise cuda's trajectory, each of {ITERS} "
        "iterates and the history")
    ops.sodda_inner.launches = 0  # the async path starts here
    _, h_a, ms_a = timed_run(data, cfg, "async")
    launches_a = ops.sodda_inner.launches  # ... and ends here
    log(f"async staleness 1: {ms_a:.3f} ms/iteration; {launches_a} "
        f"launches; history {[(t, round(f, 6)) for t, f in h_a]}")
    check(launches_a == ITERS,
          f"async launched sodda_inner {launches_a} times in {ITERS} "
          "iterations")
    check(h_a[-1][1] < h_a[0][1], f"async did not descend: {h_a}")
    tol.assert_objectives_close(h_c[-1][1], h_a[-1][1], tol.STALENESS,
                                "async staleness 1 vs cuda")
    log(f"async staleness 1: final objective {h_a[-1][1]:.6f} within "
        f"STALENESS of cuda's {h_c[-1][1]:.6f}")

    # the paper's comparison: every iteration's objective, by cost and time
    _, h_s1 = driver.run(SEED, data, cfg, ITERS, "cuda")
    _, h_r1 = driver.run(SEED, data, cfg, ITERS, "radisa-avg")
    f_s, f_r = sodda.iteration_flops(cfg), radisa.radisa_avg_iteration_flops(
        cfg)
    it_cost = int(ITERS * f_s / f_r)
    it_wall = min(ITERS, int(ITERS * ms_c / ms_r))
    log(f"paper comparison (a finding, no gate): cuda (SODDA) "
        f"{ms_c:.3f} ms/iteration, radisa-avg {ms_r:.3f}; gradient "
        f"coordinates an iteration {f_s:.4e} vs {f_r:.4e} ({f_r / f_s:.4f}x)")
    log(f"paper comparison histories: sodda "
        f"{[round(f, 6) for _, f in h_s1]}; radisa-avg "
        f"{[round(f, 6) for _, f in h_r1]}")
    log(f"paper comparison at SODDA's {ITERS} iterations of cost: sodda "
        f"F = {h_s1[ITERS][1]:.6f}; radisa-avg after {it_cost} iterations "
        f"(equal gradient coordinates) F = {h_r1[it_cost][1]:.6f}, after "
        f"{it_wall} (equal wall time) F = {h_r1[it_wall][1]:.6f}")


# ---------------------------------------------------------------------------
# Checkpoints, resumable runs, the streaming plane and elastic rescale
# ---------------------------------------------------------------------------
RESUME_SEGMENT = 10  # phase_resumable: 2 segments of the 20 iterations
STREAM_SEGMENT = 5  # phase_streaming: 4 windows in 20 iterations
ELASTIC_P = 4  # phase_elastic: the grid after one partition is lost
ELASTIC_SHAPE = (ELASTIC_P * TABLE1_250K_18K.Q, TABLE1_250K_18K.L,
                 TABLE1_250K_18K.M // (ELASTIC_P * TABLE1_250K_18K.Q))
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_checkpoints")
# the reference's resume-guard stamp (src/repro/core/driver.py,
# run_resumable's `want`), read from the manifest without the port's code
STAMP_KEYS = ("history", "backend", "record_every", "segment_iters",
              "options", "data", "streaming", "key")


class Killed(RuntimeError):
    """An injected kill."""


def kill_at(step):
    def seam(done):
        if done == step:
            raise Killed(f"injected kill at iteration {done}")
    return seam


def ckpt_dir(name):
    path = os.path.join(CKPT_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def launched(fn, *args, **kwargs):
    """fn(*args, **kwargs) with the sodda_inner launch count set to 0 just
    before it: (result, launches, seconds). The run's seconds start at its
    first segment (after a synchronisation there), so they leave out the
    resume guard's data fingerprint, and end synchronised."""
    t_first = []

    def first_segment(done):
        if not t_first:
            torch.cuda.synchronize()
            t_first.append(time.perf_counter())
        if chained is not None:
            chained(done)

    chained = kwargs.pop("on_segment_start", None)
    if fn in (driver.run_resumable, run_elastic):
        kwargs["on_segment_start"] = first_segment
    torch.cuda.synchronize()
    ops.sodda_inner.launches = 0  # this run starts here
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    finally:
        launches = ops.sodda_inner.launches  # ... and ends here
    torch.cuda.synchronize()
    return out, launches, time.perf_counter() - (t_first or [t0])[0]


def same_run(a, b, what):
    (s_a, h_a), (s_b, h_b) = a, b
    check(h_a == h_b, f"{what}: histories differ: {h_a} vs {h_b}")
    check(torch.equal(s_a.w, s_b.w) and s_a.t == s_b.t,
          f"{what}: final iterates differ")


def read_manifest_by_hand(step_dir):
    """A checkpoint read back with the reference's manifest layout, by
    json, numpy and zlib alone: the leaf names, files, dtypes, shapes and
    crc of every leaf, and the guard stamp. Returns the leaves."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        man = json.load(f)
    check(os.path.exists(os.path.join(step_dir, "_COMMITTED")),
          f"{step_dir}: no _COMMITTED marker")
    leaves = {}
    for name, meta in man["leaves"].items():
        check(meta["file"] == name + ".0.npy",
              f"leaf {name}: file {meta['file']}")
        arr = np.load(os.path.join(step_dir, meta["file"]))
        check(str(arr.dtype) == meta["dtype"]
              and list(arr.shape) == meta["shape"]
              and zlib.crc32(arr.tobytes()) & 0xFFFFFFFF == meta["crc"],
              f"leaf {name}: dtype/shape/crc do not match the manifest")
        leaves[name] = arr
    check(set(STAMP_KEYS) <= set(man["extra"]),
          f"stamp {sorted(man['extra'])} lacks {STAMP_KEYS}")
    return man, leaves


def phase_resumable(cfg, X, y):
    """run_resumable at Table-1 over the tiled plane's data: bitwise
    driver.run back to back; killed after a boundary and at a mid-segment
    commit, then resumed, bitwise (cuda; async at staleness 1 and
    radisa-avg after a boundary); no recomputation on a resume of a
    completed run; replay_segment; the checkpoint read back by hand in the
    reference's layout; and the times of the driver, a save and the data
    fingerprint."""
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    kw = dict(segment_iters=RESUME_SEGMENT, record_every=RECORD_EVERY)
    one, n_one, s_one = launched(driver.run, SEED, data, cfg, ITERS, "cuda",
                                 record_every=RECORD_EVERY)
    d_full = ckpt_dir("resumable-cuda")
    full, n_full, s_full = launched(driver.run_resumable, SEED, data, cfg,
                                    ITERS, "cuda", checkpoint_dir=d_full, **kw)
    check(n_one == n_full == ITERS,
          f"launches: driver.run {n_one}, run_resumable {n_full}")
    same_run(full, one, "run_resumable vs driver.run (cuda)")
    ms_one, ms_full = 1e3 * s_one / ITERS, 1e3 * s_full / ITERS
    log(f"resumable: run_resumable (cuda, {ITERS // RESUME_SEGMENT} segments"
        f" of {RESUME_SEGMENT}) bitwise driver.run in w and history; "
        f"{ms_full:.3f} ms/iteration against driver.run's {ms_one:.3f} "
        f"({100 * (ms_full / ms_one - 1):+.2f}%); {n_full} launches each")

    def kill_and_resume(backend, name, killed_kw, resumed_kw, done_at,
                        want, **options):
        d = ckpt_dir(name)
        ops.sodda_inner.launches = 0
        try:
            driver.run_resumable(SEED, data, cfg, ITERS, backend,
                                 checkpoint_dir=d, **kw, **killed_kw,
                                 **options)
            fail(f"{name}: the injected kill did not fire")
        except Killed:
            pass
        check(ops.sodda_inner.launches == done_at,
              f"{name}: the killed run launched {ops.sodda_inner.launches}"
              f" times in {done_at} iterations")
        check(checkpoint.latest_step(d) == done_at,
              f"{name}: latest commit {checkpoint.committed_steps(d)}, "
              f"expected {done_at}")
        got, n, _ = launched(driver.run_resumable, SEED, data, cfg, ITERS,
                             backend, checkpoint_dir=d, **kw, **resumed_kw,
                             **options)
        check(n == ITERS - done_at,
              f"{name}: resume launched {n}, expected {ITERS - done_at}")
        same_run(got, want, f"{name}: resumed vs uninterrupted")
        log(f"resumable: {name}: killed at {done_at}, resumed with {n} "
            "launches, bitwise the uninterrupted run")
        return d

    kill_and_resume("cuda", "cuda-boundary",
                    dict(on_segment=kill_at(RESUME_SEGMENT)), {},
                    RESUME_SEGMENT, full)
    mid = RESUME_SEGMENT + RECORD_EVERY
    d_mid = kill_and_resume("cuda", "cuda-commit",
                            dict(commit_every=RECORD_EVERY,
                                 on_commit=kill_at(mid)),
                            dict(commit_every=RECORD_EVERY), mid, full)
    for backend, options in (("async", {"staleness": 1}), ("radisa-avg", {})):
        ref_run, n, _ = launched(driver.run_resumable, SEED, data, cfg,
                                 ITERS, backend,
                                 checkpoint_dir=ckpt_dir(backend + "-full"),
                                 **kw, **options)
        check(n == ITERS, f"{backend}: {n} launches in {ITERS} iterations")
        kill_and_resume(backend, backend + "-boundary",
                        dict(on_segment=kill_at(RESUME_SEGMENT)), {},
                        RESUME_SEGMENT, ref_run, **options)

    again, n, _ = launched(driver.run_resumable, SEED, data, cfg, ITERS,
                           "cuda", checkpoint_dir=d_full, **kw)
    check(n == 0, f"resume of a completed run launched {n} times")
    same_run(again, full, "resume of a completed run")
    rep, n, _ = launched(driver.replay_segment, SEED, data, cfg, "cuda",
                         checkpoint_dir=d_mid, **kw)
    check(rep.get("match") is True and n == rep["end"] - rep["start"],
          f"replay_segment: {rep}, {n} launches")
    log(f"resumable: a resume of the completed run launched 0 times; "
        f"replay_segment {rep} with {n} launches")

    man, leaves = read_manifest_by_hand(
        os.path.join(d_full, f"step_{ITERS:010d}"))
    check(list(man["leaves"]) == [".w", ".t", ".key"]
          and [str(leaves[k].dtype) for k in (".w", ".t", ".key")]
          == ["float32", "int32", "uint32"],
          f"leaves {[(k, v['dtype']) for k, v in man['leaves'].items()]}")
    check(leaves[".key"].tolist() == [0, SEED] and int(leaves[".t"]) ==
          ITERS + 1 and np.array_equal(leaves[".w"],
                                       full[0].w.cpu().numpy()),
          "the checkpoint does not hold the run's final state")
    check(man["extra"]["backend"] == "cuda"
          and man["extra"]["key"] == [0, SEED],
          f"stamp {man['extra']['backend']!r}, key {man['extra']['key']}")
    _, async_leaves = read_manifest_by_hand(os.path.join(
        CKPT_ROOT, "async-full", f"step_{ITERS:010d}"))
    check(list(async_leaves) == [".w", ".t", ".key", ".mu"],
          f"async leaves {list(async_leaves)}")
    log("resumable: the checkpoints read back by hand in the reference's "
        "layout: leaves .w float32, .t int32, .key uint32 [0, seed] (and "
        ".mu for async), files <leaf>.0.npy, crc and the guard stamp "
        f"{STAMP_KEYS} all as the reference writes them")

    record = sodda.carry_record(full[0])
    save_s = []
    for k in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckpt_dir("save"), ITERS + k,
                                   sodda.carry_record(full[0]),
                                   extra={"history": full[1]})
        save_s.append(time.perf_counter() - t0)
    fp_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        driver._data_fingerprint(data)
        fp_s.append(time.perf_counter() - t0)
    log(f"resumable: a checkpoint save ({record.w.nbytes / 1e3:.1f} KB of w,"
        f" the iterate copied from the card) {1e3 * min(save_s):.3f} ms "
        f"(min of 5; mean {1e3 * sum(save_s) / 5:.3f}); _data_fingerprint "
        f"(a {data.tile_nbytes / 1e9:.3f} GB tile to the host, hashed) "
        f"{fp_s[0]:.3f} / {fp_s[1]:.3f} s")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def threadless_stream_run(plane, cfg, iters, segment_iters):
    """The streaming run as a loop that materialises each window on the
    calling thread's stream, no prefetcher: what the driver's prefetched
    run must give bitwise."""
    bundle = engine.make_bundle(cfg, "cuda")
    carry, hist = sodda.init_state(SEED, cfg.M, plane.device), []
    for done in range(0, iters, segment_iters):
        Xw, yw = plane.at_epoch(done // segment_iters).materialize()
        for it in range(done, min(done + segment_iters, iters)):
            if it % RECORD_EVERY == 0:
                hist.append(losses.objective(cfg.loss, Xw, yw, carry.w))
            carry = bundle.step(carry, Xw, yw)
    hist.append(losses.objective(cfg.loss, Xw, yw, carry.w))
    return carry, list(zip(driver.record_ticks(iters, RECORD_EVERY),
                           torch.stack(hist).tolist()))


def stream_plane(cfg):
    """The streaming Table-1 plane with no tile cache."""
    return StreamingDataPlane(SEED, cfg.N, cfg.M, cfg.P, cfg.Q,
                              resident_tile_budget=0)


def phase_streaming_anchor(cfg, X, y):
    """The streaming plane against the tiled plane's X: epoch 0 bitwise,
    a one-segment streaming run bitwise the tiled run, and the static cuda
    run's ms an iteration (returned)."""
    stream = stream_plane(cfg)
    Xs, ys = stream.materialize_for("cuda")
    check(torch.equal(Xs, X) and torch.equal(ys, y),
          "streaming epoch 0 is not the tiled plane's data")
    del Xs, ys
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    kw = dict(segment_iters=STREAM_SEGMENT, record_every=RECORD_EVERY)
    one_tiled = driver.run(SEED, data, cfg, STREAM_SEGMENT, "cuda",
                           record_every=RECORD_EVERY)
    one_stream = driver.run_resumable(SEED, stream, cfg, STREAM_SEGMENT,
                                      "cuda", checkpoint_dir=ckpt_dir("one"),
                                      **kw)
    same_run(one_stream, one_tiled, "one-segment streaming vs tiled run")
    (_, _), n_static, s_static = launched(driver.run, SEED, data, cfg, ITERS,
                                          "cuda", record_every=RECORD_EVERY)
    ms_static = 1e3 * s_static / ITERS
    log(f"streaming: epoch 0 bitwise the tiled plane's X and y; a "
        f"one-segment streaming run bitwise the tiled run; static cuda "
        f"{ms_static:.3f} ms/iteration ({n_static} launches)")
    return ms_static


def phase_streaming(cfg, ms_static):
    """The streaming Table-1 plane (no tile cache, a window a segment),
    with no X resident beside it: prefetched runs at depth 1 and 2, and a
    run of the plane and the driver at their defaults (tile cache on),
    bitwise the threadless loop; a kill and resume bitwise; ms an iteration
    against the static cuda run's, the prefetcher's accounting and the peak
    memory over X (at most 2.2 x X at depth 1)."""
    stream = stream_plane(cfg)
    kw = dict(segment_iters=STREAM_SEGMENT, record_every=RECORD_EVERY)
    x_bytes = 4 * cfg.N * cfg.M
    plain = threadless_stream_run(stream, cfg, ITERS, STREAM_SEGMENT)
    runs = {}
    # depth 1 and 2 without the tile cache, then the plane and the driver
    # at their defaults (the cache's budget, depth 1)
    cases = [("depth 1", stream, {"prefetch_depth": 1}),
             ("depth 2", stream, {"prefetch_depth": 2}),
             ("defaults", StreamingDataPlane(SEED, cfg.N, cfg.M, cfg.P,
                                             cfg.Q), {})]
    for name, plane, opts in cases:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stats = {}
        got, n, secs = launched(driver.run_resumable, SEED, plane, cfg,
                                ITERS, "cuda",
                                checkpoint_dir=ckpt_dir(name.replace(" ", "")),
                                stream_stats=stats, **opts, **kw)
        peak = (torch.cuda.max_memory_allocated() - base) / x_bytes
        check(n == ITERS, f"streaming {name}: {n} launches")
        same_run(got, plain, f"streaming {name} vs threadless loop")
        runs[name] = got
        log(f"streaming {name}: bitwise the threadless loop; "
            f"{1e3 * secs / ITERS:.3f} ms/iteration against static "
            f"{ms_static:.3f}; {n} launches; place_s "
            f"{stats['place_s']:.4f}, wait_s {stats['wait_s']:.4f}, "
            f"overlap_ratio {stats['overlap_ratio']:.4f}, consumed "
            f"{stats['consumed']}, cold_misses {stats['cold_misses']}, "
            f"queue_high_water {stats['queue_high_water']}; tile cache "
            f"{stats['cache']} of budget {plane.resident_tile_budget}; peak "
            f"{peak:.4f} x X; history "
            f"{[(t, round(f, 6)) for t, f in got[1]]}")
        if name != "depth 2":
            check(peak <= 2.2, f"streaming {name}: peak {peak:.4f} x X > 2.2")
        del plane
    check(runs["depth 1"][1][-1][1] < runs["depth 1"][1][0][1],
          "streaming: no descent")

    d = ckpt_dir("stream-kill")
    try:
        driver.run_resumable(SEED, stream, cfg, ITERS, "cuda",
                             checkpoint_dir=d,
                             on_segment=kill_at(2 * STREAM_SEGMENT), **kw)
        fail("streaming: the injected kill did not fire")
    except Killed:
        pass
    got, n, _ = launched(driver.run_resumable, SEED, stream, cfg, ITERS,
                         "cuda", checkpoint_dir=d, **kw)
    check(n == ITERS - 2 * STREAM_SEGMENT, f"streaming resume: {n} launches")
    same_run(got, runs["depth 1"], "streaming killed and resumed")
    log(f"streaming: killed at {2 * STREAM_SEGMENT} (epoch 2 being "
        f"prefetched), resumed with {n} launches, bitwise")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def phase_elastic(cfg, X, y):
    """run_elastic on cuda at Table-1, P 5 -> 4 at iteration 10: the
    kernel at the shrunk launch first, then the trajectory against the
    same composition by hand (migrate_resumable and run_resumable over
    shrink_plane), bitwise, and descent."""
    ms = phase_kernel_at(ELASTIC_SHAPE, SEED + 2)
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    kw = dict(segment_iters=RESUME_SEGMENT, record_every=RECORD_EVERY)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (st, hist, report), n, secs = launched(
        run_elastic, SEED, data, cfg, ITERS, "cuda",
        checkpoint_dir=ckpt_dir("elastic"),
        lose_partition_at=RESUME_SEGMENT, new_P=ELASTIC_P, **kw)
    above = (torch.cuda.max_memory_allocated() - base) / (4 * cfg.N * cfg.M)
    check(n == ITERS, f"elastic: {n} launches in {ITERS} iterations")
    new_cfg = report["new_cfg"]
    check(new_cfg.P == ELASTIC_P and
          (new_cfg.P * new_cfg.Q, new_cfg.L, new_cfg.m_tilde) ==
          ELASTIC_SHAPE, f"elastic: shrunk to {new_cfg}")
    s1, h1 = driver.run_resumable(SEED, data, cfg, RESUME_SEGMENT, "cuda",
                                  checkpoint_dir=ckpt_dir("hand-1"), **kw)
    survivors = shrink_plane(data, ELASTIC_P)
    d2 = ckpt_dir("hand-2")
    driver.migrate_resumable(SEED, survivors, new_cfg, RESUME_SEGMENT, s1,
                             "cuda", checkpoint_dir=d2, history=h1[:-1],
                             **kw)
    by_hand = driver.run_resumable(SEED, survivors, new_cfg, ITERS, "cuda",
                                   checkpoint_dir=d2, **kw)
    same_run((st, hist), by_hand, "elastic vs by hand")
    f = dict(hist)
    check(f[ITERS] < f[RESUME_SEGMENT] < f[0],
          f"elastic: the objective does not descend: {hist}")
    log(f"elastic: P {cfg.P} -> {ELASTIC_P} at {RESUME_SEGMENT}, kernel "
        f"launches {n} (the last {ITERS - RESUME_SEGMENT} at "
        f"{ELASTIC_SHAPE}, {ms:.5f} ms each by a CUDA graph); bitwise the "
        "composition by hand (migrate_resumable + run_resumable over "
        f"shrink_plane); history {[(t, round(v, 6)) for t, v in hist]}; "
        f"{secs:.3f} s from the first segment (the survivors are a row view "
        f"of X, placed with no copy); peak {above:.4f} x X above X")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


# ---------------------------------------------------------------------------
# The doubly-distributed mesh over torch.distributed: 15 ranks on one card
# ---------------------------------------------------------------------------
MESH_SHAPE = (1, TABLE1_250K_18K.L, TABLE1_250K_18K.m_tilde)  # a chain a rank
MESH_CONSUME_TS = (1, 10)  # consume_local held to consume_update at these t
MESH_TIMEOUT_S = 600
MESH_DEVICE = "cuda:0"  # every rank's device: the one card, shared
NCCL_CFG = SoddaConfig(name="smoke-nccl-1x1", P=1, Q=1, n=20_000, m=1200,
                       L=64, lr0=0.05)
MESH_TRANSPORT = ("gloo process group; every collective on the rank's "
                  "cuda:0 tensors (gloo stages them through host memory "
                  "itself)")


def phase_mesh_refs(cfg, X, y):
    """The single-device runs the mesh is held to, on the tiled plane's X
    (the data every rank's tile is drawn from): cuda's iterate at every
    iteration (stepped by hand, bitwise driver.run) and its history; the
    exchange mu of the iterations consume_local is held at; async at
    staleness 1; and the logistic twin on cuda."""
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    sync = engine.make_bundle(cfg, "cuda")
    state = sodda.init_state(SEED, cfg.M, X.device)
    ws, consume = [state.w.cpu().numpy()], []
    for t in range(1, ITERS + 1):
        if t in MESH_CONSUME_TS:
            _, mu = sodda._issue(cfg, X, y, state.w, t, SEED)
            consume.append((ws[-1], mu.cpu().numpy(), t, True))
        state = sync.step(state, X, y)
        ws.append(state.w.cpu().numpy())
    st_c, h_c = driver.run(SEED, data, cfg, ITERS, "cuda",
                           record_every=RECORD_EVERY)
    check(np.array_equal(st_c.w.cpu().numpy(), ws[-1]),
          "mesh refs: stepping cuda by hand is not driver.run's trajectory")
    st_a, h_a = driver.run(SEED, data, cfg, ITERS, "async",
                           record_every=RECORD_EVERY)
    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    st_l, h_l = driver.run(SEED, data, lcfg, ITERS, "cuda",
                           record_every=RECORD_EVERY)
    with snapshot_as(snapshot_gradient_in_mesh_order(cfg.n, cfg.m)):
        st_o, h_o = driver.run(SEED, data, cfg, ITERS, "cuda",
                               record_every=RECORD_EVERY)
    return dict(ws=ws, h_c=h_c, consume=consume, h_a=h_a, lcfg=lcfg, h_l=h_l,
                w_l=st_l.w.cpu().numpy(), h_o=h_o, w_o=st_o.w.cpu().numpy())


def hold_in_mesh_order(name, h_ref, h, w_ref, w):
    """A hinge mesh trajectory against the single-device plain path summed
    in the mesh's order (``snapshot_gradient_in_mesh_order``: z over the Q
    partial GEMVs, mu over the P partial products, as gloo's ring adds
    them), to F32_REDUCTION (ROADMAP C1); also says whether it is
    bitwise."""
    held, _ = hold_mesh_trajectory(name + " in the mesh's summation order",
                                   h_ref, h, w_ref, w)
    log(f"mesh {name}: final iterate bitwise the plain path in the mesh's "
        f"order: {bool(np.array_equal(w_ref, w))}")
    check(held, f"mesh {name} departs from the single-device plain path "
          "in the mesh's summation order")


def mesh_runs(ckpt):
    """The spawn's runs on Table-1, in order: a warm-up, the main path
    (shard_map+cuda), async-mesh at staleness 0 and 1, the int8 wires, the
    delta all-reduce, and run_resumable interrupted at its seam and
    resumed."""
    def run(backend="shard_map+cuda", iters=ITERS, **options):
        return dict(backend=backend, iters=iters, record_every=RECORD_EVERY,
                    seed=SEED, options=options)

    resumable = dict(checkpoint_dir=ckpt, segment_iters=RESUME_SEGMENT)
    return {"warm-up": run(iters=RECORD_EVERY),
            "shard_map+cuda": run(),
            "async-mesh/0": run("async-mesh", staleness=0),
            "async-mesh/1": run("async-mesh", staleness=1),
            "int8": run(compress_z=True, compress_mu=True),
            "delta-psum": run(gather_deltas=False),
            "interrupted": dict(run(), resumable=dict(
                resumable, interrupt_at=RESUME_SEGMENT)),
            "resumed": dict(run(), resumable=resumable)}


def hold_mesh_trajectory(name, h_ref, h, w_ref, w):
    """F32_REDUCTION of a mesh run against its reference at every tick and
    on the final iterate; (held, relative gaps by tick)."""
    floor = tol.F32_REDUCTION.obj_floor
    gaps = [abs(fa - fb) / max(abs(fa), floor)
            for (_, fa), (_, fb) in zip(h_ref, h)]
    scale = max(float(np.abs(w_ref).max()), 1.0)
    w_gap = float(np.abs(w_ref - w).max())
    held = (max(gaps) <= tol.F32_REDUCTION.obj_rel and
            w_gap <= tol.F32_REDUCTION.w_rel * scale)
    log(f"mesh {name}: max relative objective gap "
        f"{max(gaps):.3e} by tick {[f'{g:.2e}' for g in gaps]}, "
        f"max|dw| {w_gap:.3e} (F32_REDUCTION allows "
        f"{tol.F32_REDUCTION.obj_rel:.0e} and "
        f"{tol.F32_REDUCTION.w_rel * scale:.3e}): "
        f"{'held' if held else 'DEPARTS'}")
    return held, gaps


MESH_COLLECTIVES = ("all_reduce", "all_gather_cat")  # the Mesh's methods


def mesh_breakdown_rank(cfg, spec, device):
    """A mesh rank's wall time of each layer of a ``shard_map+cuda``
    iteration, over ITERS iterations of the engine's own bundle from w = 0
    with the objective at every one; the first iteration is left out of the
    means. The mesh's collectives are wrapped to synchronise the device
    before and after each call (every rank runs the same collectives in the
    same order), so the time to a collective is the compute that feeds it
    and the time in it is the collective's; ``after delta`` is the
    scatter of the gathered blocks. Then the time of one all-reduce of n
    f32 over the whole group (200 KB at Table-1). Returns (mean ms by
    layer, that all-reduce's mean ms, the final w gathered to (M,))."""
    import torch.distributed as dist

    from repro_torch.testing import multiprocess as mp

    device = mp._device(device)
    mesh = engine.make_mesh_for(cfg, device)
    X, y = mp._plane(spec, device).materialize_for("shard_map+cuda",
                                                   mesh=mesh, device=device)
    bundle = engine.make_bundle(cfg, "shard_map+cuda", device=device,
                                mesh=mesh)
    totals, clock = {}, {"last": 0.0, "on": False}

    def stamp(name):
        mp._sync(device)
        now = time.perf_counter()
        if clock["on"]:
            totals[name] = totals.get(name, 0.0) + now - clock["last"]
        clock["last"] = now

    def timed(method):
        def call(t, axis, *args, tag=None, **kwargs):
            stamp(f"compute to {tag}")
            out = method(t, axis, *args, tag=tag, **kwargs)
            stamp(f"{tag} {method.__name__} over {axis}")
            return out
        return call

    for name in MESH_COLLECTIVES:
        setattr(mesh, name, timed(getattr(mesh, name)))
    try:
        carry = bundle.init_carry(sodda.init_state(SEED, cfg.M, device), X, y)
        for t in range(1, ITERS + 1):
            clock["on"] = t > 1
            stamp("between iterations")
            carry = bundle.step(carry, X, y)
            stamp("after delta")
            bundle.objective(X, y, carry.w)
            stamp("after objective")
        clock["on"] = False
        w = bundle.finalize(carry).w
    finally:
        for name in MESH_COLLECTIVES:
            delattr(mesh, name)
    means = {k: 1e3 * v / (ITERS - 1) for k, v in totals.items()
             if k != "between iterations"}
    z = torch.ones(cfg.n, device=device)
    for _ in range(3):
        dist.all_reduce(z)
    mp._sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        dist.all_reduce(z)
    mp._sync(device)
    world_ms = 1e3 * (time.perf_counter() - t0) / ITERS
    return means, world_ms, w.cpu().numpy()


def phase_mesh(cfg, refs):
    """Table-1 on a 5 x 3 grid of 15 ranks sharing the card over gloo, one
    spawn (see the module docstring, 12). Returns the kernel's time at the
    mesh launch (1, 64, 1200) by a CUDA graph."""
    from repro_torch.core import distributed as cdist
    from repro_torch.testing import multiprocess as mp

    ms_b1 = phase_kernel_at(MESH_SHAPE, SEED + 3)
    bound_b1, by_b1 = kernel_bound_ms(*MESH_SHAPE)
    torch.cuda.empty_cache()
    world = cfg.P * cfg.Q
    spec = ("tiled", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    d = ckpt_dir("mesh")
    runs = mesh_runs(d)
    jobs = [(mp.rank_runs, (cfg, spec, list(runs.values()), MESH_DEVICE)),
            (mp.rank_runs, (refs["lcfg"], spec,
                            [runs["shard_map+cuda"]], MESH_DEVICE)),
            (mp.rank_steps, (cfg, spec, "shard_map+cuda", refs["ws"][:-1],
                             list(range(1, ITERS + 1)), SEED, None, None,
                             MESH_DEVICE)),
            (mp.rank_consume, (cfg, spec, refs["consume"], SEED,
                               MESH_DEVICE)),
            (mesh_breakdown_rank, (cfg, spec, MESH_DEVICE))]
    t0 = time.perf_counter()
    launch = mp.launch_coordinated(mp.rank_batch, world, (jobs,),
                                   backend="gloo", timeout=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    check(launch.exit_codes == {}, f"mesh ranks died: {launch.exit_codes}")
    ranks = launch.results
    res = [dict(zip(runs, r[0])) for r in ranks]  # per rank, by run name
    logistic = [r[1][0] for r in ranks]
    entered, joined = (max(st[k] for st in launch.stamps)
                       for k in ("entered", "joined"))
    log(f"mesh: {cfg.P} x {cfg.Q} grid, {world} ranks on one card, "
        f"transport: {MESH_TRANSPORT}; one spawn of {spawn_s:.1f} s: the "
        f"last rank up (interpreter and imports) at {entered:.1f} s, in the "
        f"process group at {joined:.1f} s, then the tile draws and every "
        "run below")

    # every rank returns the same state and history, bitwise
    for name in runs:
        for r in range(1, world):
            a, b = res[0][name], res[r][name]
            check(a["history"] == b["history"] and a["t"] == b["t"] and
                  (a["w"] is None or np.array_equal(a["w"], b["w"])),
                  f"mesh {name}: rank {r} differs from rank 0")
    for r in range(1, world):
        check(np.array_equal(logistic[r]["w"], logistic[0]["w"]) and
              logistic[r]["history"] == logistic[0]["history"],
              f"mesh logistic: rank {r} differs from rank 0")

    # one launch a rank an iteration; a resume launches only its own
    want = {"warm-up": RECORD_EVERY, "interrupted": RESUME_SEGMENT,
            "resumed": ITERS - RESUME_SEGMENT}
    for name in runs:
        n = [res[r][name]["launches"] for r in range(world)]
        check(n == [want.get(name, ITERS)] * world,
              f"mesh {name}: sodda_inner launches by rank {n}")
    log(f"mesh launches: every rank launched sodda_inner at {MESH_SHAPE} "
        f"once an iteration: {ITERS} in each {ITERS}-iteration run, "
        f"{RESUME_SEGMENT} before the interruption and "
        f"{ITERS - RESUME_SEGMENT} in the resume")

    main = res[0]["shard_map+cuda"]
    # consume_local bitwise consume_update from the same w and mu
    for (w, mu, t, _), got in zip(refs["consume"], ranks[0][3]):
        check(np.array_equal(got, refs["ws"][t]),
              f"mesh consume_local at t={t} is not consume_update, bitwise "
              f"(max|d| {float(np.abs(got - refs['ws'][t]).max()):.3e})")
    log(f"mesh consume_local: bitwise consume_update (cuda) from the same w "
        f"and mu at t = {MESH_CONSUME_TS}")
    # every step from cuda's state, to F32_REDUCTION
    worst = 0.0
    for t, got in enumerate(ranks[0][2], start=1):
        tol.assert_trajectories_close([refs["ws"][t]], [got],
                                      tol.F32_REDUCTION,
                                      f"mesh step {t} from cuda's w^{t - 1}")
        worst = max(worst, float(np.abs(got - refs["ws"][t]).max()))
    log(f"mesh steps: each of the {ITERS} iterations, stepped by the mesh "
        f"from cuda's iterate, within F32_REDUCTION of cuda's step; "
        f"max|dw| {worst:.3e}")
    # the trajectory against cuda (hinge), and the logistic twin in full
    held, _ = hold_mesh_trajectory("shard_map+cuda vs cuda (hinge)",
                                   refs["h_c"], main["history"],
                                   refs["ws"][-1], main["w"])
    held_l, _ = hold_mesh_trajectory(
        "shard_map+cuda vs cuda (logistic twin)", refs["h_l"],
        logistic[0]["history"], refs["w_l"], logistic[0]["w"])
    check(held_l, "mesh logistic twin departs from cuda")
    hold_in_mesh_order("shard_map+cuda vs cuda (hinge)", refs["h_o"],
                       main["history"], refs["w_o"], main["w"])
    if not held:
        X, y = TiledDataPlane(SEED, cfg.N, cfg.M, cfg.P, cfg.Q).materialize()
        w_c, w_m = (torch.tensor(v, device="cuda")
                    for v in (refs["ws"][-1], main["w"]))
        log(f"mesh hinge: rows of X on other sides of the hinge kink at the "
            f"final iterates, mesh vs cuda: {kink_sides(X, y, w_m, w_c)} of "
            f"{cfg.N}; every step from the same state held, the logistic "
            "twin held in full (a finding: the mesh sums z over "
            f"{cfg.Q} partial GEMVs)")
        del X, y, w_c, w_m
        torch.cuda.empty_cache()
    for name in runs:
        h = res[0][name]["history"]
        if h is not None:
            check(all(math.isfinite(f) for _, f in h) and h[-1][1] < h[0][1],
                  f"mesh {name}: no descent or non-finite {h}")

    # async-mesh: staleness 0 bitwise, staleness 1 within STALENESS
    a0, a1 = res[0]["async-mesh/0"], res[0]["async-mesh/1"]
    check(a0["history"] == main["history"] and
          np.array_equal(a0["w"], main["w"]),
          "async-mesh at staleness 0 is not shard_map+cuda, bitwise")
    tol.assert_objectives_close(refs["h_a"][-1][1], a1["history"][-1][1],
                                tol.STALENESS, "async-mesh/1 vs async")
    log(f"mesh async-mesh: staleness 0 bitwise shard_map+cuda; staleness 1 "
        f"F {a1['history'][-1][1]:.6f} within STALENESS of async's "
        f"{refs['h_a'][-1][1]:.6f}")
    # the wires: int8 within QUANTIZED, the delta all-reduce F32_REDUCTION
    q8, dp = res[0]["int8"], res[0]["delta-psum"]
    tol.assert_objectives_close(main["history"][-1][1], q8["history"][-1][1],
                                tol.QUANTIZED, "mesh int8 wires")
    held_d, _ = hold_mesh_trajectory("delta all-reduce vs all-gather",
                                     main["history"], dp["history"],
                                     main["w"], dp["w"])
    check(held_d, "mesh delta all-reduce departs from the all-gather")
    log(f"mesh int8 wires: F {q8['history'][-1][1]:.6f} within QUANTIZED of "
        f"the exact run's {main['history'][-1][1]:.6f}")

    # interrupted at the seam and resumed: bitwise, rank 0 alone wrote
    it, rs = res[0]["interrupted"], res[0]["resumed"]
    check(it["interrupted"] == RESUME_SEGMENT and
          rs["history"] == main["history"] and
          np.array_equal(rs["w"], main["w"]),
          "mesh resume is not the uninterrupted run, bitwise")
    saves = [(res[r]["interrupted"]["saves"], res[r]["resumed"]["saves"])
             for r in range(world)]
    check(saves == [(1, 1)] + [(0, 0)] * (world - 1),
          f"mesh checkpoint saves by rank: {saves}")
    _, leaves = read_manifest_by_hand(os.path.join(
        d, f"step_{ITERS:010d}"))
    check(np.array_equal(leaves[".w"], main["w"]),
          "mesh checkpoint: w is not the run's final iterate")
    log(f"mesh resumable: interrupted after its commit at {RESUME_SEGMENT} "
        "and resumed in the same ranks, bitwise the uninterrupted run; rank "
        "0 alone saved (one save a boundary), the checkpoint in the "
        "reference's layout")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)

    # what the card measured: time, payload, memory (reported, no limit)
    x_bytes = 4 * cfg.N * cfg.M
    peak = sum(res[r]["shard_map+cuda"]["peak"] or 0 for r in range(world))
    used = max(res[r]["shard_map+cuda"]["device_used"] or 0
               for r in range(world))
    for name in ("shard_map+cuda", "async-mesh/1", "int8", "delta-psum"):
        secs = [res[r][name]["seconds"] for r in range(world)]
        log(f"mesh {name}: {1e3 * secs[0] / ITERS:.3f} ms/iteration on rank "
            f"0 ({1e3 * max(secs) / ITERS:.3f} slowest rank), {ITERS} "
            f"iterations with the objective every {RECORD_EVERY}")
    for name, flags in (("shard_map+cuda", {}),
                        ("int8", dict(compress_z=True, compress_mu=True)),
                        ("delta-psum", dict(gather_deltas=False))):
        pay = res[0][name]["payload"]
        per_it = {k: pay.get(k, 0) / ITERS for k in ("z", "mu", "delta")}
        ring = cdist.iteration_collective_bytes(cfg, **flags)
        log(f"mesh {name} payload a rank an iteration (bytes handed to "
            f"each collective): {per_it}; ring volume "
            f"(iteration_collective_bytes) {ring}; objective "
            f"{pay.get('objective', 0)} and final gather "
            f"{pay.get('gather', 0)} bytes a run")
    log(f"mesh memory: the ranks' max_memory_allocated sum to "
        f"{peak / 1e9:.3f} GB = {peak / x_bytes:.4f} x X "
        f"(X = {x_bytes / 1e9:.3f} GB); the card's used memory at the end "
        f"of the run (every context) {used / 1e9:.3f} GB")
    breakdown, world_ms, w_b = ranks[0][4]
    check(np.array_equal(w_b, main["w"]),
          "mesh breakdown: its timed run does not give shard_map+cuda's "
          "iterate")
    slowest = {k: max(r[4][0][k] for r in ranks) for k in breakdown}
    step = [k for k in breakdown if "objective" not in k]
    log("mesh breakdown of a shard_map+cuda iteration on rank 0, the "
        "engine's bundle with the device synchronised around each "
        "collective, mean of iterations 2-20 (slowest rank in brackets): "
        + ", ".join(f"{k} {v:.3f} ({slowest[k]:.3f}) ms"
                    for k, v in breakdown.items())
        + f"; the step {sum(breakdown[k] for k in step):.3f} ms; its "
        "iterate bitwise the run's")
    log(f"mesh: an all-reduce of {cfg.n} f32 ({4 * cfg.n} bytes) over all "
        f"{world} ranks on cuda:0 tensors, mean of {ITERS}: "
        f"{world_ms:.3f} ms on rank 0")
    log(f"mesh kernel at {MESH_SHAPE}: {ms_b1:.5f} ms by a CUDA graph, bound "
        f"{bound_b1:.5f} ms ({by_b1}), {ms_b1 / bound_b1:.1f}x; "
        f"{world} launches an iteration across the ranks")
    return ms_b1


def phase_nccl():
    """The mesh path on one rank over NCCL (a 1 x 1 grid), bitwise cuda on
    the same data: the only NCCL run one card allows."""
    from repro_torch.testing import multiprocess as mp

    cfg = NCCL_CFG
    spec = ("tiled", SEED, cfg.N, cfg.M, 1, 1)
    plane = TiledDataPlane(*spec[1:])
    st, hist = driver.run(SEED, plane, cfg, ITERS, "cuda",
                          record_every=RECORD_EVERY)
    run = dict(backend="shard_map+cuda", iters=ITERS,
               record_every=RECORD_EVERY, seed=SEED)
    launch = mp.launch_coordinated(mp.rank_runs, 1, (cfg, spec, [run],
                                                     MESH_DEVICE),
                                   backend="nccl", timeout=300)
    check(launch.exit_codes == {}, f"nccl rank died: {launch.exit_codes}")
    got = launch.results[0][0]
    check(got["launches"] == ITERS,
          f"nccl 1x1: {got['launches']} launches in {ITERS} iterations")
    check(got["history"] == hist and
          np.array_equal(got["w"], st.w.cpu().numpy()),
          f"nccl 1x1 mesh is not cuda, bitwise: {got['history']} vs {hist}")
    log(f"mesh 1 x 1 over NCCL ({cfg.N} x {cfg.M}): bitwise the cuda "
        f"backend on the same data, w and history; {ITERS} launches; "
        f"transport: NCCL on cuda:0 tensors")


# ---------------------------------------------------------------------------
# The elastic rescale and the streaming plane on the mesh: one spawn of the
# 15 ranks and 6 spares for the regrown rows
# ---------------------------------------------------------------------------
MESH_LOSE, MESH_REGROW = 10, 15  # the lost row leaves at 10, returns at 15
MESH_SHRUNK_SHAPE = (1, TABLE1_250K_18K.L,
                     TABLE1_250K_18K.M // (ELASTIC_P * TABLE1_250K_18K.Q))
# run_elastic_auto: the last rank's supervisor clock (a FakeClock, as every
# rank's) reads the segment from 5 as 30 s slow; the group's max makes it
# every rank's straggler, flagged at the boundary at 10 against the one
# segment before it
MESH_STRAGGLER = (TABLE1_250K_18K.P * TABLE1_250K_18K.Q - 1, RECORD_EVERY,
                  30.0)
MESH_POLICY = dict(window=3, warmup=1)
MESH_WINDOWS = ITERS // STREAM_SEGMENT


class RegrowableRows(DenseDataPlane):
    """The tiled plane's X, resident, as a dense plane that can regrow:
    its lost partitions regenerate from the tiled plane's seed."""

    def __init__(self, X, y, grid, seed, flip_prob=0.01):
        super().__init__(X, y, grid=grid)
        self.seed, self.flip_prob = seed, flip_prob


def phase_mesh_elastic_refs(cfg, X, y):
    """The single-device elastic runs the mesh's are held to, on the
    tiled plane's X: run_elastic on cuda shrinking P 5 -> 4 at 10 (and
    growing back at 15), on async at staleness 1, and the logistic twin's
    shrink; plus, window by window, the tile digests of each stream
    window's (p, q) slices and cuda's stream run (hinge: its iterate at
    every iteration, the states the streaming mesh steps from; and the
    logistic twin)."""
    data = RegrowableRows(X, y, (cfg.P, cfg.Q), SEED)
    kw = dict(segment_iters=STREAM_SEGMENT, record_every=RECORD_EVERY,
              lose_partition_at=MESH_LOSE, new_P=ELASTIC_P)
    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    # cuda's trajectory on the shrunk grid, a step at a time from w^10:
    # the states the mesh steps from on the re-formed 4 x 3 group
    state, _ = driver.run(SEED, data, cfg, MESH_LOSE, "cuda",
                          record_every=RECORD_EVERY)
    new_cfg = engine.rescale_config(cfg, ELASTIC_P)
    Xs, ys = shrink_plane(data, ELASTIC_P).materialize()
    shrunk = engine.make_bundle(new_cfg, "cuda")
    ws = [state.w.cpu().numpy()]
    for _ in range(MESH_LOSE, ITERS):
        state = shrunk.step(state, Xs, ys)
        ws.append(state.w.cpu().numpy())
    del Xs, ys
    refs = {"steps": ws}
    in_order = snapshot_gradient_in_mesh_order(cfg.n, cfg.m)
    grow = dict(regrow_at=MESH_REGROW, regrow_P=cfg.P)
    for name, run_cfg, backend, extra, snapshot in (
            ("shrink", cfg, "cuda", {}, sodda.snapshot_gradient),
            ("grow", cfg, "cuda", grow, sodda.snapshot_gradient),
            ("async", cfg, "async", dict(staleness=1),
             sodda.snapshot_gradient),
            ("logistic", lcfg, "cuda", {}, sodda.snapshot_gradient),
            ("shrink-order", cfg, "cuda", {}, in_order),
            ("grow-order", cfg, "cuda", grow, in_order)):
        with snapshot_as(snapshot):
            st, hist, report = run_elastic(
                SEED, data, run_cfg, ITERS, backend,
                checkpoint_dir=ckpt_dir("elastic-ref-" + name), **kw,
                **extra)
        refs[name] = dict(w=st.w.cpu().numpy(), history=hist,
                          events=report["events"], cfg=run_cfg)
        torch.cuda.empty_cache()
    del data
    stream = stream_plane(cfg)
    n, m = cfg.n, cfg.m
    digests = []
    # threadless_stream_run's loop for both losses, a window at a time
    runs = {name: dict(cfg=c, bundle=engine.make_bundle(c, "cuda"),
                       state=sodda.init_state(SEED, cfg.M, X.device),
                       ws=[], hist=[], snapshot=snapshot)
            for name, c, snapshot in (
                ("stream", cfg, sodda.snapshot_gradient),
                ("stream-logistic", lcfg, sodda.snapshot_gradient),
                ("stream-order", cfg, in_order))}
    for e in range(MESH_WINDOWS):
        Xw, yw = stream.at_epoch(e).materialize()
        digests.append({(p, q): (tile_digest(Xw[p * n:(p + 1) * n,
                                                q * m:(q + 1) * m]),
                                 tile_digest(yw[p * n:(p + 1) * n]))
                        for p in range(cfg.P) for q in range(cfg.Q)})
        for r in runs.values():
            for it in range(e * STREAM_SEGMENT, (e + 1) * STREAM_SEGMENT):
                r["ws"].append(r["state"].w.cpu().numpy())
                if it % RECORD_EVERY == 0:
                    r["hist"].append(losses.objective(r["cfg"].loss, Xw, yw,
                                                      r["state"].w))
                with snapshot_as(r["snapshot"]):
                    r["state"] = r["bundle"].step(r["state"], Xw, yw)
        if e == MESH_WINDOWS - 1:
            for r in runs.values():
                r["hist"].append(losses.objective(r["cfg"].loss, Xw, yw,
                                                  r["state"].w))
        del Xw, yw
        torch.cuda.empty_cache()
    refs["digests"] = digests
    for name, r in runs.items():
        refs[name] = dict(
            ws=r["ws"] + [r["state"].w.cpu().numpy()],
            history=list(zip(driver.record_ticks(ITERS, RECORD_EVERY),
                             torch.stack(r["hist"]).tolist())))
    check(np.array_equal(ws[-1], refs["shrink"]["w"]),
          "mesh elastic refs: cuda stepped on the survivors is not "
          "run_elastic's trajectory")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    log(f"mesh elastic refs: run_elastic on cuda (P {cfg.P} -> {ELASTIC_P} at "
        f"{MESH_LOSE}, and back to {cfg.P} at {MESH_REGROW}), async at "
        f"staleness 1 and the logistic twin, segments of {STREAM_SEGMENT}; "
        f"tile digests of the {MESH_WINDOWS} stream windows' slices")
    return refs


def mesh_elastic_runs(root, lcfg, ws):
    """The spawn's elastic runs, in order (``rank_elastic``): the main
    shrink-then-grow run (a fault after its last commit), its composition
    by hand, the shrink with a fault in each of its phases and by hand,
    the straggler's automatic shrink, async-mesh, the logistic twin, and
    a step from each of cuda's states `ws` on the re-formed 4 x 3 group."""
    def run(kind, name, backend="shard_map+cuda", **extra):
        base = dict(kind=kind, backend=backend, iters=ITERS,
                    record_every=RECORD_EVERY, seed=SEED,
                    segment_iters=STREAM_SEGMENT, new_P=ELASTIC_P,
                    checkpoint_dir=os.path.join(root, name))
        if kind != "auto":
            base["lose_at"] = MESH_LOSE
        return dict(base, **extra)

    grow = dict(regrow_at=MESH_REGROW, regrow_P=TABLE1_250K_18K.P)
    return {"grow": run("elastic", "grow", faults={ITERS: 1}, **grow),
            "hand-grow": run("by-hand", "hand-grow", **grow),
            "shrink": run("elastic", "shrink",
                          faults={RECORD_EVERY: 1, MESH_REGROW: 1}),
            "hand": run("by-hand", "hand"),
            "auto": run("auto", "auto", straggler=MESH_STRAGGLER,
                        policy=MESH_POLICY, patience=1),
            "async": run("elastic", "async", "async-mesh",
                         options={"staleness": 1}),
            "logistic": run("elastic", "logistic", cfg=lcfg),
            "steps": run("steps", "steps", ws=ws[:-1],
                         ts=list(range(MESH_LOSE + 1, ITERS + 1)))}


def mesh_resumable(root, name, iters):
    """A ``shard_map+cuda`` ``run_resumable`` of ``rank_runs`` in segments
    of 5 (a window a segment on a streaming plane, prefetch depth 1)."""
    return dict(backend="shard_map+cuda", iters=iters,
                record_every=RECORD_EVERY, seed=SEED,
                resumable=dict(checkpoint_dir=os.path.join(root, name),
                               segment_iters=STREAM_SEGMENT,
                               prefetch_depth=1))


def segment_ms(run):
    """ms an iteration of a run from its first segment's start to its
    last segment's end (its timeline), set-up left out as phase_streaming
    leaves it out."""
    at = {(e, d): t for e, d, t, _ in run["timeline"]}
    last = max(d for e, d in at if e == "end")
    return 1e3 * (at[("end", last)] - at[("start", 0)]) / last


def mesh_elastic_spawn(cfg, refs):
    """One spawn of the 5 x 3 grid and 6 spares over gloo on the card:
    the streaming runs, each rank's tile of every window, the static runs
    they are compared with, a step from each of cuda's stream states on
    its window, then the elastic runs. Returns what the phases read."""
    from repro_torch.testing import multiprocess as mp

    world = cfg.P * cfg.Q
    root = ckpt_dir("mesh-elastic")
    stream_spec = ("streaming", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    tiled_spec = ("tiled", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    lcfg = refs["logistic"]["cfg"]
    streams = [mesh_resumable(root, "stream", ITERS),
               mesh_resumable(root, "one-window", STREAM_SEGMENT)]
    statics = [mesh_resumable(root, "static", ITERS),
               mesh_resumable(root, "static-one", STREAM_SEGMENT)]
    elastic = mesh_elastic_runs(root, lcfg, refs["steps"])
    spares = sum((r["regrow_P"] - ELASTIC_P) * cfg.Q
                 for r in elastic.values() if "regrow_at" in r)
    ws = refs["stream"]["ws"]
    steps = [(mp.rank_steps, (
        cfg, stream_spec, "shard_map+cuda",
        ws[e * STREAM_SEGMENT:(e + 1) * STREAM_SEGMENT],
        list(range(e * STREAM_SEGMENT + 1, (e + 1) * STREAM_SEGMENT + 1)),
        SEED,
        None, None, MESH_DEVICE, e)) for e in range(MESH_WINDOWS)]
    jobs = [(mp.rank_runs, (cfg, stream_spec, streams, MESH_DEVICE)),
            (mp.rank_runs, (lcfg, stream_spec,
                            [mesh_resumable(root, "logistic", ITERS)],
                            MESH_DEVICE)),
            (mp.rank_tiles, (cfg, stream_spec, list(range(MESH_WINDOWS)),
                             MESH_DEVICE)),
            (mp.rank_runs, (cfg, tiled_spec, statics, MESH_DEVICE)),
            *steps,
            (mp.rank_elastic, (cfg, tiled_spec, list(elastic.values()),
                               MESH_DEVICE))]
    free, total = torch.cuda.mem_get_info()
    log(f"mesh elastic spawn: the card's used memory before it "
        f"{(total - free) / 1e9:.3f} GB (this process: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved)")
    t0 = time.perf_counter()
    launch = mp.launch_coordinated(mp.rank_batch, world, (jobs,),
                                   backend="gloo", spares=spares,
                                   timeout=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    check(launch.exit_codes == {},
          f"mesh elastic spawn: processes died: {launch.exit_codes}"
          + raised(launch))
    ranks = launch.results[:world]
    log(f"mesh elastic spawn: {world} ranks and {spares} spares on one card "
        f"over gloo, {spawn_s:.1f} s: the last process up at "
        f"{max(st['entered'] for st in launch.stamps):.1f} s, the last rank "
        f"in the group at "
        f"{max(st['joined'] for st in launch.stamps[:world]):.1f} s, then "
        "every run below")
    return dict(
        launch=launch, world=world, spares=spares,
        stream={"stream": [r[0][0] for r in ranks],
                "one-window": [r[0][1] for r in ranks],
                "logistic": [r[1][0] for r in ranks],
                "static": [r[3][0] for r in ranks],
                "static-one": [r[3][1] for r in ranks]},
        tiles=[r[2] for r in ranks],
        steps=np.concatenate([ranks[0][4 + e] for e in range(MESH_WINDOWS)]),
        steps_equal=all(np.array_equal(r[4 + e], ranks[0][4 + e])
                        for r in ranks for e in range(MESH_WINDOWS)),
        elastic={name: [res[-1][k] if res[-1] is not None else None
                        for res in launch.results]
                 for k, name in enumerate(elastic)})


def raised(launch):
    """What the processes of a failed launch raised: each one's last
    traceback line, and in full the first traceback that is not a peer's
    closed connection (the consequence of another process's fault)."""
    if not launch.errors:
        return ""
    lines = {r: tb.strip().splitlines()[-1] for r, tb in launch.errors.items()}
    cause = [r for r, line in sorted(lines.items())
             if "Connection closed" not in line and
             "Connection reset" not in line] or sorted(lines)
    return (f"; raised: {lines}; process {cause[0]}:\n"
            f"{launch.errors[cause[0]]}")


def same_on_every_rank(name, results):
    """The finished results of a run: every one's w, history and report
    bitwise equal. Returns them."""
    done = [r for r in results if r is not None and r.get("left") is None]
    for r in done[1:]:
        check(r["history"] == done[0]["history"] and
              np.array_equal(r["w"], done[0]["w"]) and
              r.get("report") == done[0].get("report"),
              f"mesh {name}: a rank differs from rank 0")
    return done


def phase_mesh_elastic(cfg, spawn, refs):
    """run_elastic, run_elastic_auto and the composition by hand on the
    5 x 3 mesh, shrunk to 4 x 3 at 10 (the kernel at (1, 64, 1500)) and
    regrown at 15 (see the module docstring, 12)."""
    world, launch = spawn["world"], spawn["launch"]
    runs = dict(spawn["elastic"])
    steps = runs.pop("steps")
    lost = list(range(ELASTIC_P * cfg.Q, world))
    shrinks = [3 * k for k in range(len(runs) + 1)]  # and the steps'
    check(launch.departed == {r: shrinks for r in lost},
          f"mesh elastic: planned departures {launch.departed}, expected "
          f"ranks {lost} at generations {shrinks}")

    # each step on the re-formed 4 x 3 group from cuda's state
    steps = [r["steps"] for r in steps[:world] if r["left"] is None]
    check(len(steps) == ELASTIC_P * cfg.Q and
          all(np.array_equal(s, steps[0]) for s in steps),
          "mesh elastic steps: the survivors differ")
    worst = 0.0
    for k, got in enumerate(steps[0]):
        want = refs["steps"][k + 1]
        tol.assert_trajectories_close(
            [want], [got], tol.F32_REDUCTION,
            f"mesh step {MESH_LOSE + k + 1} on the 4 x 3 grid")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"mesh elastic steps: each of iterations {MESH_LOSE + 1}-{ITERS}, "
        "stepped on the re-formed 4 x 3 group from cuda's iterate on the "
        f"survivors, within F32_REDUCTION of cuda's step; max|dw| "
        f"{worst:.3e}")

    done = {name: same_on_every_rank("elastic " + name, res)
            for name, res in runs.items()}
    for name, res in runs.items():
        grows = name in ("grow", "hand-grow")
        want = world if grows else ELASTIC_P * cfg.Q
        check(len(done[name]) == want and
              all(r["world"] == want for r in done[name]),
              f"mesh elastic {name}: {len(done[name])} ranks finished")
        left = [r for r in res[:world] if r["left"] is not None]
        check([r["left"] for r in left] == [MESH_LOSE] * len(lost),
              f"mesh elastic {name}: lost ranks left at "
              f"{[r['left'] for r in left]}")
        # one launch a rank an iteration run: the lost row's 10 before it
        # left, a regrown rank's 5, and none on a resume of a completed
        # phase (the faults after the last commits)
        n = [r["launches"] for r in res if r is not None]
        expect = [ITERS] * (ELASTIC_P * cfg.Q) + [MESH_LOSE] * len(lost) + (
            [ITERS - MESH_REGROW] * (world - ELASTIC_P * cfg.Q)
            if grows else [])
        check(n == expect, f"mesh elastic {name}: sodda_inner launches by "
              f"process {n}, expected {expect}")
        for r in done[name]:
            at = {(e, d): n for e, d, _, n in r["timeline"]}
            if ("end", MESH_REGROW) in at and ("start", MESH_LOSE) in at:
                k = at[("end", MESH_REGROW)] - at[("start", MESH_LOSE)]
                check(k == MESH_REGROW - MESH_LOSE,
                      f"mesh elastic {name}: {k} launches on the 4 x 3 grid")
    check(done["grow"][0]["report"]["new_cfg"].m_tilde == MESH_SHRUNK_SHAPE[2],
          f"mesh elastic: shrunk m_tilde "
          f"{done['grow'][0]['report']['new_cfg'].m_tilde}")
    log(f"mesh elastic launches: every rank launched sodda_inner once an "
        f"iteration it ran: 20 a survivor, {MESH_LOSE} a lost rank before "
        f"it left, {ITERS - MESH_REGROW} a regrown rank, the "
        f"{MESH_REGROW - MESH_LOSE} on the 4 x 3 grid at {MESH_SHRUNK_SHAPE};"
        " none on a resume of a completed phase")

    spares = launch.results[world:]
    held = [r for res in spares for r in res[-1] if r is not None]
    check(len(held) == spawn["spares"] and
          all(r["held"] == {"group": False, "cuda": False} for r in held),
          f"mesh elastic: regrown ranks held {[r['held'] for r in held]}")
    log(f"mesh elastic: ranks {lost} left the group at every shrink (exit "
        f"0, a planned departure); the {spawn['spares']} regrown ranks "
        "joined holding no group and no device context, each for one run")

    for a, b in (("grow", "hand-grow"), ("shrink", "hand"), ("auto", "hand")):
        x, z = done[a][0], done[b][0]
        check(x["history"] == z["history"] and np.array_equal(x["w"], z["w"]),
              f"mesh elastic {a} is not {b}, bitwise")
    events = done["shrink"][0]["report"]["events"]
    check([e for e in events if e.startswith("restart")] ==
          [f"restart#1@{RECORD_EVERY}:Preemption",
           f"restart#1@{MESH_REGROW}:Preemption"],
          f"mesh elastic shrink: events {events}")
    auto = done["auto"][0]["report"]
    check(auto["rescaled"] and auto["boundary"] == MESH_LOSE and
          f"straggler@{MESH_LOSE}:{MESH_STRAGGLER[2]:.3f}s" in auto["events"],
          f"mesh elastic auto: {auto}")
    log("mesh elastic: run_elastic bitwise its composition by hand "
        "(run_resumable, the group re-formed, rescale_bundle, "
        "migrate_resumable, run_resumable) for the shrink and the "
        "shrink-then-grow; faults after commits in every phase retried "
        "bitwise; the straggler (rank "
        f"{MESH_STRAGGLER[0]}'s segment from {MESH_STRAGGLER[1]}) shrunk away "
        f"at {MESH_LOSE} on every rank alike, bitwise the planned shrink; "
        f"events {auto['events']}")

    held_s, _ = hold_mesh_trajectory(
        "elastic shrink vs cuda run_elastic (hinge)",
        refs["shrink"]["history"], done["shrink"][0]["history"],
        refs["shrink"]["w"], done["shrink"][0]["w"])
    held_g, _ = hold_mesh_trajectory(
        "elastic shrink-then-grow vs cuda run_elastic (hinge)",
        refs["grow"]["history"], done["grow"][0]["history"],
        refs["grow"]["w"], done["grow"][0]["w"])
    held_l, _ = hold_mesh_trajectory(
        "elastic shrink vs cuda run_elastic (logistic twin)",
        refs["logistic"]["history"], done["logistic"][0]["history"],
        refs["logistic"]["w"], done["logistic"][0]["w"])
    check(held_l, "mesh elastic logistic twin departs from cuda")
    for name, label in (("shrink", "elastic shrink"),
                        ("grow", "elastic shrink-then-grow")):
        hold_in_mesh_order(f"{label} vs cuda run_elastic (hinge)",
                           refs[name + "-order"]["history"],
                           done[name][0]["history"],
                           refs[name + "-order"]["w"], done[name][0]["w"])
    if not (held_s and held_g):
        log("mesh elastic hinge: a finding, the hinge trajectory parts from "
            "cuda's (queue C); the logistic twin held in full")
    for name in ("shrink", "grow"):
        got, want = ([e for e in events if e.startswith("rescale")]
                     for events in (done[name][0]["report"]["events"],
                                    refs[name]["events"]))
        check(got == want, f"mesh elastic {name}: rescale events {got}, "
              f"run_elastic's {want}")
    a1 = done["async"][0]["history"][-1][1]
    tol.assert_objectives_close(refs["async"]["history"][-1][1], a1,
                                tol.STALENESS, "elastic async-mesh vs async")
    log(f"mesh elastic async-mesh: F {a1:.6f} within STALENESS of async's "
        f"{refs['async']['history'][-1][1]:.6f} under the same shrink")
    for name, r in done.items():
        h = r[0]["history"]
        check(all(math.isfinite(f) for _, f in h) and h[-1][1] < h[0][1],
              f"mesh elastic {name}: no descent or non-finite {h}")

    # what the card measured: segment times, the rebuilds, memory
    main = done["grow"][0]
    at = {(e, d): t for e, d, t, _ in main["timeline"]}
    seg = [(d, 1e3 * (at[("end", d + STREAM_SEGMENT)] - at[("start", d)]) /
            STREAM_SEGMENT) for d in range(0, ITERS, STREAM_SEGMENT)]
    shrink_s = at[("start", MESH_LOSE)] - at[("end", MESH_LOSE)]
    grow_s = at[("start", MESH_REGROW)] - at[("end", MESH_REGROW)]
    regrown = [r for r in runs["grow"][world:] if r is not None]
    joined_s = max(
        {(e, d): t for e, d, t, _ in r["timeline"]}[("start", MESH_REGROW)]
        for r in regrown) - at[("end", MESH_REGROW)]
    x_bytes = 4 * cfg.N * cfg.M
    peak = sum(r["peak"] or 0 for r in runs["grow"] if r is not None)
    used = max(r["device_used"] or 0 for r in runs["grow"] if r is not None)
    rendezvous = [h["end"] - h["start"]
                  for st in launch.stamps[:ELASTIC_P * cfg.Q]
                  for h in st["history"] if h["event"] == "joined"
                  and h["generation"] in (1, 2)]
    log("mesh elastic shrink-then-grow (rank 0, shard_map+cuda): ms an "
        "iteration by segment, " + ", ".join(
            f"[{d}, {d + STREAM_SEGMENT}) {ms:.3f}" for d, ms in seg)
        + f" (5 x 3, 5 x 3, 4 x 3, 5 x 3); {shrink_s:.3f} s from the commit "
        f"at {MESH_LOSE} to the first segment on the 4 x 3 group (barrier, "
        "the lost row's departure, teardown, rendezvous, rescale_bundle, "
        f"migration, placement), {grow_s:.3f} s from the commit at "
        f"{MESH_REGROW} to the first on the regrown group; the regrown "
        f"ranks in the group with their tiles {joined_s:.3f} s after that "
        f"commit; each rendezvous {min(rendezvous):.3f}-"
        f"{max(rendezvous):.3f} s; the ranks' max_memory_allocated sum to "
        f"{peak / 1e9:.3f} GB = {peak / x_bytes:.4f} x X; the card's used "
        f"memory {used / 1e9:.3f} GB")
    # the rebuilds' parts, timed in the run (SegmentSupervisor.rebuilds)
    for r in main["rebuilds"]:
        log(f"mesh elastic rebuild at {r['at']} onto {r['grid'][0]} x "
            f"{r['grid'][1]} (rank 0, timed in the run): "
            f"{r['reform_s']:.3f} s from the commit to the new group "
            f"(barrier, departures, teardown; the rendezvous itself "
            f"{r['rendezvous_s']:.3f} s), {r['mesh_s']:.3f} s the mesh and "
            f"bundle, {r['migrate_s']:.3f} s the migration (the fingerprint "
            "of the resident tile, the save, the barrier), then "
            f"{at[('start', r['at'])] - r['end']:.3f} s the phase's set-up "
            "to its first segment (the resident tile and the kept stamp: "
            "no tile drawn, none hashed)")
    for r in regrown:
        b = r["rebuilds"][0]
        start = {(e, d): t for e, d, t, _ in r["timeline"]}[
            ("start", MESH_REGROW)]
        log(f"mesh elastic regrown rank: rendezvous {b['rendezvous_s']:.3f} "
            f"s (waiting from launch for the survivors' commit at "
            f"{MESH_REGROW}), the mesh and bundle {b['mesh_s']:.3f} s, the "
            f"migration {b['migrate_s']:.3f} s, then {start - b['end']:.3f} "
            "s drawing its own tile and warming up to its first segment")
    for name, res in done.items():
        at = {}
        for e, d, t, _ in res[0]["timeline"]:
            at.setdefault((e, d), t)  # a retried boundary: its first pass
        segs = [1e3 * (at[("end", d + STREAM_SEGMENT)] - at[("start", d)])
                / STREAM_SEGMENT for d in range(0, ITERS, STREAM_SEGMENT)
                if ("start", d) in at and ("end", d + STREAM_SEGMENT) in at]
        segs = [f"{ms:.3f}" for ms in segs]
        secs = max(r["seconds"] for r in res if r["held"] is None)
        log(f"mesh elastic {name}: ms an iteration by segment of 5 on rank "
            f"0 {segs}; {secs:.3f} s for the run (the slowest rank of the "
            "launch's group; set-up, rescales and retries included)")


def phase_mesh_elastic_killed(cfg, spawn):
    """The shrink-then-grow run killed after its commit at 15, inside the
    shrunk phase (every survivor exits), then rerun in a second spawn with
    the regrown row's spares: bitwise the uninterrupted run, no launch on
    a resume of a completed phase."""
    from repro_torch.testing import multiprocess as mp

    world, survivors = cfg.P * cfg.Q, ELASTIC_P * cfg.Q
    run = dict(kind="elastic", backend="shard_map+cuda", iters=ITERS,
               record_every=RECORD_EVERY, seed=SEED,
               segment_iters=STREAM_SEGMENT, new_P=ELASTIC_P,
               lose_at=MESH_LOSE, regrow_at=MESH_REGROW, regrow_P=cfg.P,
               checkpoint_dir=ckpt_dir("mesh-killed"))
    spec = ("tiled", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    out, secs = [], []
    for kill, spares in ((MESH_REGROW, 0), (None, world - survivors)):
        t0 = time.perf_counter()
        out.append(mp.launch_coordinated(
            mp.rank_elastic, world,
            (cfg, spec, [dict(run, kill_at=kill)], MESH_DEVICE),
            backend="gloo", spares=spares, timeout=MESH_TIMEOUT_S))
        secs.append(time.perf_counter() - t0)
    killed, rerun = out
    check(killed.exit_codes == {r: mp.KILL_EXIT_CODE
                                for r in range(survivors)},
          f"mesh elastic kill: exit codes {killed.exit_codes}"
          + raised(killed))
    check(rerun.exit_codes == {}, f"mesh elastic rerun: processes died "
          f"{rerun.exit_codes}" + raised(rerun))
    want = same_on_every_rank("elastic grow", spawn["elastic"]["grow"])[0]
    got = [res[0] for res in rerun.results]
    done = same_on_every_rank("elastic rerun", got)
    check(len(done) == world and done[0]["history"] == want["history"] and
          np.array_equal(done[0]["w"], want["w"]),
          "mesh elastic: the run killed at 15 and rerun is not the "
          "uninterrupted run, bitwise")
    n = [r["launches"] for r in got]
    expect = ([ITERS - MESH_REGROW] * survivors + [0] * (world - survivors)
              + [ITERS - MESH_REGROW] * (world - survivors))
    check(n == expect, f"mesh elastic rerun: sodda_inner launches {n}, "
          f"expected {expect}")
    log(f"mesh elastic kill and rerun: the shrink-then-grow run killed "
        f"after its commit at {MESH_REGROW} ({survivors} survivors exited "
        f"{mp.KILL_EXIT_CODE}, the lost row had left at {MESH_LOSE}), "
        f"{secs[0]:.1f} s; rerun with {world - survivors} spares, "
        f"{secs[1]:.1f} s: bitwise the uninterrupted run, launches "
        f"{n} (none for the completed phases)")


def phase_mesh_streaming(cfg, spawn):
    """The streaming plane on the 5 x 3 mesh: 4 windows a segment of 5 at
    depth 1, against the static mesh run of the same spawn and the
    single-device stream (see the module docstring, 12)."""
    world, runs = spawn["world"], spawn["stream"]
    done = {name: same_on_every_rank(name, res)
            for name, res in runs.items()}
    for name, n in (("stream", ITERS), ("one-window", STREAM_SEGMENT),
                    ("logistic", ITERS), ("static", ITERS),
                    ("static-one", STREAM_SEGMENT)):
        got = [r["launches"] for r in done[name]]
        check(got == [n] * world,
              f"mesh streaming {name}: sodda_inner launches {got}")
    one, static_one = done["one-window"][0], done["static-one"][0]
    check(one["history"] == static_one["history"] and
          np.array_equal(one["w"], static_one["w"]),
          "mesh streaming: window 0 is not the tiled mesh run, bitwise")
    for rank, tiles in enumerate(spawn["tiles"]):
        for e, got in enumerate(tiles):
            # digests from the card (arrays when the ranks ran on the CPU)
            got = tuple(g if isinstance(g, int) else
                        tile_digest(torch.as_tensor(g)) for g in got)
            check(got == spawn["refs"]["digests"][e][divmod(rank, cfg.Q)],
                  f"mesh streaming: rank {rank}'s tile of window {e} is not "
                  "the single-device window's slice")
    log(f"mesh streaming: every rank bitwise equal; {ITERS} launches a rank "
        f"({STREAM_SEGMENT} for one window); one window's run bitwise the "
        "tiled mesh run; each rank's tile and label block of every window "
        "bitwise (by digest on the card) the single-device window's slice")

    # each step of the stream from cuda's state, on its window, to
    # F32_REDUCTION: the gate the hinge trajectory's parting leaves
    refs = spawn["refs"]
    check(spawn["steps_equal"], "mesh streaming steps: the ranks differ")
    worst = 0.0
    for t, got in enumerate(spawn["steps"], start=1):
        want = refs["stream"]["ws"][t]
        tol.assert_trajectories_close(
            [want], [got], tol.F32_REDUCTION,
            f"mesh streaming step {t} from cuda's w^{t - 1}")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"mesh streaming steps: each of the {ITERS} iterations, stepped on "
        "the 5 x 3 mesh from cuda's stream iterate on its window's tiles, "
        f"within F32_REDUCTION of cuda's step; max|dw| {worst:.3e}")
    stream, logistic = done["stream"][0], done["logistic"][0]
    held, _ = hold_mesh_trajectory(
        "streaming vs the single-device stream (hinge)",
        refs["stream"]["history"], stream["history"],
        refs["stream"]["ws"][-1], stream["w"])
    held_l, _ = hold_mesh_trajectory(
        "streaming vs the single-device stream (logistic twin)",
        refs["stream-logistic"]["history"], logistic["history"],
        refs["stream-logistic"]["ws"][-1], logistic["w"])
    check(held_l, "mesh streaming logistic twin departs from the "
          "single-device stream")
    hold_in_mesh_order("streaming vs the single-device stream (hinge)",
                       refs["stream-order"]["history"], stream["history"],
                       refs["stream-order"]["ws"][-1], stream["w"])
    if not held:
        log("mesh streaming hinge: a finding, the hinge trajectory parts "
            "from the single-device stream's (queue C); each step from the "
            "same state held above, the logistic twin in full")
    for run in (stream, logistic):
        h = run["history"]
        check(all(math.isfinite(f) for _, f in h) and h[-1][1] < h[0][1],
              f"mesh streaming: no descent or non-finite {h}")

    x_bytes = 4 * cfg.N * cfg.M
    ms = [segment_ms(r) for r in done["stream"]]
    ms_static = [segment_ms(r) for r in done["static"]]
    setup = [r["seconds"] - segment_ms(r) * ITERS / 1e3
             for r in done["stream"]]
    peak = sum((r["peak"] or 0) - (r["allocated"] or 0)
               for r in done["stream"])
    used = max(r["device_used"] or 0 for r in done["stream"])
    stats = [r["stream"] for r in done["stream"]]
    log(f"mesh streaming: {ms[0]:.3f} ms an iteration on rank 0 "
        f"({max(ms):.3f} slowest) against the static mesh run's "
        f"{ms_static[0]:.3f} ({max(ms_static):.3f}) in the same spawn, "
        "both run_resumable in segments of 5 timed from the first segment's"
        f" start; the set-up before it (the resume guard's fingerprint on "
        f"rank 0, window 0 placed cold) {setup[0]:.3f} s on rank 0; "
        "place_s / wait_s / overlap_ratio by rank: "
        + "; ".join(f"{s['place_s']:.4f} / {s['wait_s']:.4f} / "
                    f"{s['overlap_ratio']:.4f}" for s in stats)
        + f"; the ranks' max_memory_allocated above their start sum to "
        f"{peak / 1e9:.3f} GB = {peak / x_bytes:.4f} x X (predicted <= 2.2);"
        f" the card's used memory {used / 1e9:.3f} GB; history "
        f"{[(t, round(f, 6)) for t, f in stream['history']]}")


def phase_mesh_elastic_streaming(cfg, refs):
    """The kernel at the shrunk mesh launch, then one spawn for both
    phases."""
    ms = phase_kernel_at(MESH_SHRUNK_SHAPE, SEED + 4)
    bound, by = kernel_bound_ms(*MESH_SHRUNK_SHAPE)
    log(f"mesh kernel at {MESH_SHRUNK_SHAPE}: {ms:.5f} ms by a CUDA graph, "
        f"bound {bound:.5f} ms ({by}), {ms / bound:.1f}x; "
        f"{ELASTIC_P * TABLE1_250K_18K.Q} launches an iteration across the "
        "4 x 3 grid")
    torch.cuda.empty_cache()
    spawn = mesh_elastic_spawn(cfg, refs)
    spawn["refs"] = refs
    phase_mesh_streaming(cfg, spawn)
    phase_mesh_elastic(cfg, spawn, refs)
    phase_mesh_elastic_killed(cfg, spawn)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


# ---------------------------------------------------------------------------
# flash_attention and the gemma2-9b serving path
# ---------------------------------------------------------------------------
def attention_pairs(Sq, Sk, causal=True, window=0, q_offset=0):
    """Unmasked (query, key) pairs of one head: the work the mask leaves."""
    n = 0
    for r in range(Sq):
        qpos = q_offset + r
        hi = min(Sk, qpos + 1) if causal else Sk
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def flash_bound_ms(B, H, KV, Sq, Sk, D, dtype, backward=False,
                   split=False, **mask):
    """Least time for one call, (ms, what binds): the function's products
    of 2 B H D FLOP an unmasked pair (forward: S and P.V; backward: S, dP,
    dV, dQ and dK) over the dtype's peak, vs the bytes over the HBM rate
    (forward: q, k, v read once and out written once; backward: q, out,
    dout, k, v and lse read once and dq, dk, dv written once). `split`:
    the products as the tensor-core kernels take them, bf16 piece products
    at 989 TFLOP/s; f32: six piece products each (three pieces an operand,
    a + b <= 2; ``ref.attention_ref(in_pieces=3, mid_pieces=3)``); bf16: S
    and dP as one, P.V, dV, dQ and dK as two (P and dS in two halves). The
    backward's recomputation of S and dP in the dQ kernel is the design's,
    not the function's, and is not counted."""
    products = 5 if backward else 2
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    if split:
        products = (6 * products if dtype == torch.float32
                    else 1 + 1 + 2 * 3 if backward else 1 + 2)
        peak = BF16_FLOP_PER_S
    flops = 2.0 * products * B * H * D * attention_pairs(Sq, Sk, **mask)
    item = torch.tensor([], dtype=dtype).element_size()
    io = 4 if backward else 2
    nbytes = item * (io * B * Sq * H * D + io * B * Sk * KV * D) \
        + (4 * B * H * Sq if backward else 0)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_inputs(B, H, KV, Sq, Sk, D, dtype, gen):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) on the card, unit-variance entries,
    as the model's projections of a normed residual give them."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, Sq, H, D), rnd(B, Sk, KV, D), rnd(B, Sk, KV, D)


def attention_bf16_scores(q, k, v, **opts):
    """The control: attention whose scores are rounded to bf16 before the
    f32 softmax (``attention_naive``'s einsum runs in the input dtype, as
    the JAX reference's does), one batch row at a time."""
    return torch.cat([kref.attention_naive(q[b:b + 1], k[b:b + 1],
                                           v[b:b + 1], **opts)
                      for b in range(q.shape[0])])


def bf16_scale_is_exact(D):
    """Whether sqrt(D) is a bf16 number, so that the plain version's bf16
    scale equals the f32 one."""
    return float(torch.tensor(math.sqrt(D)).to(torch.bfloat16)) == \
        math.sqrt(D)


def bf16_excess(q, k, v, opts, **outs):
    """`tol.half_ulp_excess` against the plain version run on f32 copies of
    the inputs, over max|v|, with a second control among the outputs:
    that plain version with P rounded once to bf16 before P.V, as a
    textbook tensor-core kernel takes it."""
    f = [t.float() for t in (q, k, v)]
    oracle = kref.attention_ref(*f, **opts)
    p_bf16 = kref.attention_ref(*f, p_split=1, **opts).to(q.dtype)
    return tol.half_ulp_excess(oracle, float(v.float().abs().max()),
                               control_p_bf16=p_bf16, **outs)


def check_excess(tag, ex):
    """kernel and plain within the rounding rule; every control outside."""
    held = {k: v for k, v in ex.items() if not k.startswith("control")}
    check(all(v <= F32_NOISE for v in held.values()),
          f"{tag}: beyond half a bf16 ulp of the f32 result by {ex} x "
          f"the output scale (limit {F32_NOISE})")
    controls = {k: v for k, v in ex.items() if k.startswith("control")}
    check(controls and all(v > F32_NOISE for v in controls.values()),
          f"{tag}: a control passes the rounding rule ({ex}), so the rule "
          "cannot tell such a kernel apart")


def f32_tol_excess(got, want):
    """How far the worst entry of `got` lies outside
    ``assert_close(got, want, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)``
    (<= 0: it holds; > 0: it fails)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} against {tuple(want.shape)} "
          f"{want.dtype}")
    over = (got - want).abs() - FLASH_F32_TOL * (1.0 + want.abs())
    return float(over.max())


def check_f32_tol(tag, got, want, ctrl):
    """The f32 rule (``f32_tol_excess``) on the kernel's `got` and the
    split control's `ctrl` against the plain `want`: the kernel within it,
    the control outside; a log note of both excesses."""
    k_over, c_over = f32_tol_excess(got, want), f32_tol_excess(ctrl, want)
    check(k_over <= 0, f"{tag}: outside the f32 tolerance {FLASH_F32_TOL} "
          f"by {k_over:.3e}")
    check(c_over > 0, f"{tag}: the split control passes the f32 tolerance "
          f"(excess {c_over:.3e})")
    return (f"tol {FLASH_F32_TOL}: kernel excess {k_over:.3e}, the split "
            f"control {float((ctrl - want).abs().max()):.3e} off (excess "
            f"{c_over:.3e})")


def phase_flash():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # the f32 route's instantiations (spills and serialised wgmma already
    # failed the build check)
    registers = kernel_registers(kbuild.library_path(flash_build.SOURCE))
    log(f"flash f32 forward registers by instantiation: {registers}")
    check(sorted(registers) == [f"flash_fwd_f32<{L}>"
                                for L in (128, 16, 256, 64)],
          f"flash f32 forward: instantiations {sorted(registers)}, expected "
          "one per layout (16, 64, 128, 256)")
    S = SERVE_PROMPT
    cases = [
        ("gemma2 local layer", (4, 16, 8, S, S, 256), bf16,
         dict(window=4096, softcap=50.0)),
        ("gemma2 global layer", (4, 16, 8, S, S, 256), bf16,
         dict(softcap=50.0)),
        ("gemma2 decode offset", (4, 16, 8, 1, S, 256), bf16,
         dict(window=4096, softcap=50.0, q_offset=S - 1)),
    ]
    # zamba2-7b's shared attention layer and a phi3-mini layer (head dims
    # 112 and 96, on the 128 layout zero-padded inside the kernel)
    cases += [
        ("zamba2 shared layer", ZAMBA2_FLASH, bf16, dict()),
        ("phi3-mini layer", PHI3_FLASH, bf16, dict()),
    ]
    # the other dense-stack layers: GQA groups of 16 (chatglm3-6b) and 6
    # (internvl2-26b, 48 heads), 4 (minitron-8b), and musicgen-large's
    # unaligned 1468 positions at D = 64
    cases += [(name, shape, bf16, dict()) for name, shape in DENSE_FLASH]
    # the MoE family's layer (a GQA group of 8, 64 heads), in both dtypes
    cases += [(name, shape, dtype, dict()) for name, shape in MOE_FLASH
              for dtype in (bf16, f32)]
    # a rank's 16 of zamba2-7b's 32 heads in phase_mesh_lm's SSM cell: a
    # training row and a prefill's two rows of MESH_SSM_PROMPT, f32
    cases += [
        ("f32 zamba2 mesh rank layer", (1, 16, 16, MESH_SSM_S, MESH_SSM_S,
                                        112), f32, dict()),
        ("f32 zamba2 mesh rank prefill", (2, 16, 16, MESH_SSM_PROMPT,
                                          MESH_SSM_PROMPT, 112), f32,
         dict()),
    ]
    # every other bf16 head dim the wgmma kernel takes, unaligned
    for D in (16, 64, 96, 112, 128):
        cases += [
            (f"bf16 D={D} causal", (2, 4, 2, 200, 200, D), bf16, dict()),
            (f"bf16 D={D} non-causal", (2, 4, 2, 200, 200, D), bf16,
             dict(causal=False)),
            (f"bf16 D={D} window+softcap", (2, 4, 2, 200, 200, D), bf16,
             dict(window=64, softcap=30.0)),
            (f"bf16 D={D} decode offset", (2, 4, 2, 1, 200, D), bf16,
             dict(window=64, softcap=30.0, q_offset=199)),
        ]
    # every head dim on the wgmma-f32 route, unaligned
    for D in flash_build.HEAD_DIMS:
        cases += [
            (f"f32 D={D} causal", (2, 4, 2, 200, 200, D), f32, dict()),
            (f"f32 D={D} non-causal", (2, 4, 2, 200, 200, D), f32,
             dict(causal=False)),
            (f"f32 D={D} window+softcap", (2, 4, 2, 200, 200, D), f32,
             dict(window=64, softcap=30.0)),
            (f"f32 D={D} decode offset", (2, 4, 2, 1, 200, D), f32,
             dict(window=64, softcap=30.0, q_offset=199)),
        ]
    # the wgmma-f32 route at internvl2-26b's and chatglm3-6b's head layouts
    # (GQA groups of 6 and 16), unaligned
    cases += [
        ("f32 group 6 causal", (2, 48, 8, 200, 200, 128), f32, dict()),
        ("f32 group 16 causal", (2, 32, 2, 200, 200, 128), f32, dict()),
        ("f32 group 16 window+softcap", (2, 32, 2, 200, 200, 128), f32,
         dict(window=64, softcap=30.0)),
    ]
    max_err = 0.0
    for name, (B, H, KV, Sq, Sk, D), dtype, opts in cases:
        q, k, v = flash_inputs(B, H, KV, Sq, Sk, D, dtype, gen)
        a = ops.flash_attention(q, k, v, force="cuda", **opts)
        b = ops.flash_attention(q, k, v, force="cuda", **opts)
        want = ops.flash_attention(q, k, v, force="ref", **opts)
        torch.cuda.synchronize()
        tag = f"flash {name} {(B, H, KV, Sq, Sk, D)} {dtype} {opts}"
        check(torch.equal(a, b), f"{tag}: two launches differ")
        check(bool(torch.isfinite(a).all()), f"{tag}: non-finite output")
        if dtype == bf16:
            ex = bf16_excess(q, k, v, opts, kernel=a, plain=want,
                             control=attention_bf16_scores(q, k, v, **opts))
            # The plain version takes 1 / sqrt(D) rounded to bf16, as the
            # reference does; the kernels and the oracle take it in f32. At
            # D = 96, 112 and 128 the two differ (their square roots are no
            # bf16 numbers), so there the plain version is shown, not held.
            held = {name: e for name, e in ex.items()
                    if name != "plain" or bf16_scale_is_exact(D)}
            check_excess(tag, held)
            rule = (f"excess over half a bf16 ulp / max|v|: kernel "
                    f"{ex['kernel']:.3e}, plain {ex['plain']:.3e}"
                    f"{'' if 'plain' in held else ' (not held)'}, bf16-score "
                    f"control {ex['control']:.3e}, P-in-bf16 control "
                    f"{ex['control_p_bf16']:.3e} (limit {F32_NOISE:.3e}); "
                    f"route {flash_build.route(dtype, D)}")
        else:
            # the split control: every tensor-core operand rounded once to
            # bf16, as a textbook tensor-core kernel takes f32 inputs
            ctrl = kref.attention_ref(q, k, v, **opts, **F32_SPLIT_CONTROL)
            rule = (check_f32_tol(tag, a, want, ctrl)
                    + f"; route {flash_build.route(dtype, D)}")
            del ctrl
        err = float((a.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        log(f"{tag}: bitwise across launches, max|kernel-plain| = "
            f"{err:.3e}; {rule}")

    offset_view_case("flash", lambda *t: ops.flash_attention(*t,
                                                            force="cuda"),
                     flash_inputs(2, 4, 2, 200, 200, 64, bf16, gen),
                     (0, 1, 2), flash_build.route(bf16, 64))

    B, H, KV, D = 4, 16, 8, 256  # one gemma2-9b prefill layer
    q, k, v = flash_inputs(B, H, KV, S, S, D, bf16, gen)
    times = {}
    for layer, window in (("local", 4096), ("global", 0)):
        opts = dict(window=window, softcap=50.0)
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda",
                                                 **opts), reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="ref",
                                                       **opts),
                           reps=2, warmup=1)
        bound_ms, bound_by = flash_bound_ms(B, H, KV, S, S, D, bf16,
                                            window=window)
        times[layer] = (ms, plain_ms, bound_ms, bound_by)
        log(f"flash {layer} layer (4, 16, 8, {S}, 256) bf16: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), kernel/bound {ms / bound_ms:.1f}x")
    # the one PyTorch call for the same function: causal, no softcap, no
    # window (a yardstick only; the port never calls it)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10, warmup=2)
    same_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda"),
                      reps=5, warmup=1)
    log(f"flash global-layer shape, causal, GQA, no softcap: torch "
        f"scaled_dot_product_attention {sdpa_ms:.4f} ms, the kernel "
        f"{same_ms:.4f} ms")
    del q, k, v, qt, kt, vt
    # the padded head dims at their layers' shapes: causal, no softcap, the
    # function scaled_dot_product_attention computes too
    by_dim = {}
    for name, (B, H, KV, Sq, Sk, D) in (("zamba2 shared layer", ZAMBA2_FLASH),
                                         ("phi3-mini layer", PHI3_FLASH)):
        q, k, v = flash_inputs(B, H, KV, Sq, Sk, D, bf16, gen)
        d_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda"),
                       reps=5, warmup=1)
        d_plain = cuda_ms(lambda: ops.flash_attention(q, k, v, force="ref"),
                          reps=2, warmup=1)
        d_bound, d_by = flash_bound_ms(B, H, KV, Sq, Sk, D, bf16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        d_sdpa = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), reps=10, warmup=2)
        by_dim[D] = dict(shape=[B, H, KV, Sq, Sk, D], ms=d_ms,
                         plain_ms=d_plain, bound_ms=d_bound, bound_by=d_by,
                         library_ms=d_sdpa, launches=None)
        log(f"flash {name} {(B, H, KV, Sq, D)} bf16 causal: kernel "
            f"{d_ms:.4f} ms, plain {d_plain:.4f} ms, bound {d_bound:.5f} ms "
            f"({d_by}), kernel/bound {d_ms / d_bound:.1f}x; torch "
            f"scaled_dot_product_attention {d_sdpa:.4f} ms; layout head dim "
            f"{flash_build.layout_head_dim(D)}")
        del q, k, v, qt, kt, vt
    # the other dense-stack layers and the MoE family's, causal (with GQA
    # where KV < H)
    layers = {}
    for name, (B, H, KV, Sq, Sk, D) in DENSE_FLASH + MOE_FLASH:
        q, k, v = flash_inputs(B, H, KV, Sq, Sk, D, bf16, gen)
        l_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda"),
                       reps=5, warmup=1)
        l_plain = cuda_ms(lambda: ops.flash_attention(q, k, v, force="ref"),
                          reps=2, warmup=1)
        l_bound, l_by = flash_bound_ms(B, H, KV, Sq, Sk, D, bf16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        l_sdpa = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=KV < H),
            reps=10, warmup=2)
        layers[name] = dict(shape=[B, H, KV, Sq, Sk, D], ms=l_ms,
                            plain_ms=l_plain, bound_ms=l_bound, bound_by=l_by,
                            library_ms=l_sdpa, launches=None)
        log(f"flash {name} {(B, H, KV, Sq, D)} bf16 causal (group "
            f"{H // KV}): kernel {l_ms:.4f} ms, plain {l_plain:.4f} ms, "
            f"bound {l_bound:.5f} ms ({l_by}), kernel/bound "
            f"{l_ms / l_bound:.1f}x; torch scaled_dot_product_attention "
            f"{l_sdpa:.4f} ms")
        del q, k, v, qt, kt, vt
    # the f32 route (csrc/flash_attention.cu, wgmma-f32) at zamba2's shared
    # layer at the serving prefill, causal: the shape of the f32 exactness
    # cells (the training layers are timed in phase_flash_backward)
    B, H, KV, Sq, Sk, D = ZAMBA2_FLASH
    q, k, v = flash_inputs(B, H, KV, Sq, Sk, D, f32, gen)
    f_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda"),
                   reps=3, warmup=1)
    f_plain = cuda_ms(lambda: ops.flash_attention(q, k, v, force="ref"),
                      reps=2, warmup=1)
    f_bounds = bound_keys(f32, flash_bound_ms(B, H, KV, Sq, Sk, D, f32),
                          flash_bound_ms(B, H, KV, Sq, Sk, D, f32,
                                         split=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    f_sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=5, warmup=2)
    f32_record = dict(shape=list(ZAMBA2_FLASH), route=flash_build.route(f32, D),
                      source="src/repro_torch/kernels/csrc/flash_attention.cu",
                      ms=f_ms, plain_ms=f_plain, **f_bounds,
                      library_ms=f_sdpa, launches=None, registers=registers)
    log(f"flash zamba2 shared layer {(B, H, KV, Sq, D)} f32 causal "
        f"({f32_record['route']} route): kernel {f_ms:.4f} ms, plain "
        f"{f_plain:.4f} ms, tensor-core bound {f_bounds['bound_ms']:.5f} ms "
        f"({f_bounds['bound_by']}), CUDA-core bound "
        f"{f_bounds['cuda_core_bound_ms']:.5f} ms, kernel/bound "
        f"{f_ms / f_bounds['bound_ms']:.1f}x; torch "
        f"scaled_dot_product_attention in f32 {f_sdpa:.4f} ms")
    del q, k, v, qt, kt, vt
    ms, plain_ms, bound_ms, bound_by = times["global"]
    record = dict(name="flash_attention", route="cuda",
                  source="src/repro_torch/kernels/csrc/"
                         "flash_attention_wgmma.cu",
                  replaces="src/repro/kernels/flash_attention.py:74",
                  launches=None, max_abs_err=max_err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=sdpa_ms,
                  head_dims={str(D): r for D, r in by_dim.items()},
                  layers=layers, f32=f32_record)
    return record, times


def offset_view(t):
    """`t`'s values in a contiguous view that starts one element into its
    buffer, so its data is not 16-byte aligned (as a slice of a flat
    buffer may be)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "offset_view: the view is aligned")
    return view


def offset_view_case(name, run, inputs, tma, route):
    """Unaligned views of the TMA operands (positions `tma` of `inputs`)
    through a wgmma route give bitwise the aligned copies' output (ops
    copies such a view before TMA reads it)."""
    want = run(*inputs)
    got = run(*(offset_view(t) if i in tma else t
                for i, t in enumerate(inputs)))
    torch.cuda.synchronize()
    check(route.startswith("wgmma"),
          f"{name} offset view: route {route}, not a wgmma one")
    check(torch.equal(got, want), f"{name} offset view: the output differs "
          "from the aligned copy's")
    item = inputs[tma[0]].element_size()
    log(f"{name} offset {inputs[tma[0]].dtype} views (data {item} bytes past "
        f"16-byte alignment, {route} route): bitwise the aligned copy's "
        "output")


def decode_logits(model, params, prompts, tokens, force,
                  frontend_embeds=None):
    """Prefill `prompts` (after `frontend_embeds`, if given) through
    `make_serve_steps(model, force=force)`, copy the cache as `serve` does, then
    decode the given tokens (B, n) one step at a time: the logits of every
    step, (B, n, Vp)."""
    prefill_step, decode_step = make_serve_steps(model, force=force)
    batch = {"tokens": prompts}
    if frontend_embeds is not None:
        batch["frontend_embeds"] = frontend_embeds
    _, pre = prefill_step(params, batch)
    B, P = pre["k"].shape[1:3]  # the frontend's positions and the prompt's
    cache = model.cache_template(B, P + tokens.shape[1], dtype=pre["k"].dtype)
    cache["k"][:, :, :P].copy_(pre["k"])
    cache["v"][:, :, :P].copy_(pre["v"])
    del pre
    out = []
    for i in range(tokens.shape[1]):
        pos = torch.full((B,), P + i, dtype=torch.long, device=prompts.device)
        logits, cache = decode_step(params, cache, tokens[:, i:i + 1], pos)
        out.append(logits)
    return torch.stack(out, dim=1)


def phase_cut_depth():
    """gemma2-9b at full width, 4 layers (2 local, 2 global), f32: the
    kernel path against the plain path on the same weights and prompts."""
    cfg = dataclasses.replace(GEMMA2_9B, num_layers=CUT_DEPTH_LAYERS)
    model = Model(cfg, param_dtype=torch.float32)
    params = model.init(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (CUT_DEPTH_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    before = ops.flash_attention.launches
    tok_k, logits_k = serve(model, params, prompts, CUT_DEPTH_GEN)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches - before
    tok_r, logits_r = serve(model, params, prompts, CUT_DEPTH_GEN,
                            force="ref")
    torch.cuda.synchronize()
    check(launches == CUT_DEPTH_LAYERS,
          f"cut-depth: {launches} flash launches for {CUT_DEPTH_LAYERS} "
          "layers")
    check(bool(torch.isfinite(logits_k).all()), "cut-depth: non-finite")
    torch.testing.assert_close(logits_k, logits_r, rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    check(torch.equal(tok_k, tok_r),
          f"cut-depth: greedy tokens differ\n{tok_k}\n{tok_r}")
    gap = float((logits_k - logits_r).abs().max())
    # The random-weight model's greedy choice repeats one token, so the
    # decode steps are also held by their logits, fed random tokens over
    # the cache that each path's prefill built.
    fed = torch.randint(0, cfg.vocab_size, (CUT_DEPTH_B, CUT_DEPTH_GEN),
                        generator=gen, device="cuda")
    dec_k = decode_logits(model, params, prompts, fed, "auto")
    dec_r = decode_logits(model, params, prompts, fed, "ref")
    check(bool(torch.isfinite(dec_k).all()), "cut-depth: non-finite decode")
    torch.testing.assert_close(dec_k, dec_r, rtol=MODEL_TOL, atol=MODEL_TOL)
    dec_gap = float((dec_k - dec_r).abs().max())
    log(f"cut-depth gemma2-9b ({CUT_DEPTH_LAYERS} layers, full width, f32, "
        f"B={CUT_DEPTH_B}, prompt {SERVE_PROMPT}): kernel vs plain prefill "
        f"logits max gap {gap:.3e}, {CUT_DEPTH_GEN} decode steps' logits "
        f"max gap {dec_gap:.3e} (tol {MODEL_TOL}); {CUT_DEPTH_GEN} greedy "
        f"tokens identical: {tok_k.tolist()}; decode argmax "
        f"{dec_k.argmax(-1).tolist()}")


def phase_serve():
    """The second main path: full-depth bf16 gemma2-9b serving a batch."""
    cfg = GEMMA2_9B
    model = Model(cfg)  # bf16 weights on the card
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    log(f"serve gemma2-9b: {model.param_count()} parameters "
        f"({weight_bytes / 1e9:.3f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    serve(model, params, prompts[:, :16], 2)  # warm-up: handles, library
    # time to the first token: serve one token, i.e. prefill and cache copy
    ops.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(model, params, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.flash_attention.launches

    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    tokens, logits = serve(model, params, prompts, SERVE_GEN)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = ops.flash_attention.launches  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    check(prefill_launches == cfg.num_layers,
          f"serve: {prefill_launches} flash launches in the prefill, "
          f"expected {cfg.num_layers}")
    check(launches == prefill_launches,
          f"serve: {launches - prefill_launches} flash launches in decode")
    check(tuple(tokens.shape) == (SERVE_B, SERVE_GEN),
          f"serve: tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "serve: a token outside the vocabulary")
    check(tuple(logits.shape) == (SERVE_B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "serve: prefill logits not finite or of the wrong shape")
    steps = SERVE_GEN - 1
    decode_s = total_s - prefill_s
    kv_bytes = (2 * cfg.num_layers * SERVE_B * (SERVE_PROMPT + SERVE_GEN)
                * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
    log(f"serve {SERVE_B} x {SERVE_PROMPT} prompt tokens, {SERVE_GEN} "
        f"generated each: prefill {1e3 * prefill_s:.3f} ms "
        f"({SERVE_B * SERVE_PROMPT / prefill_s:.1f} prompt tok/s), "
        f"decode {1e3 * decode_s / steps:.3f} ms/token over {steps} steps "
        f"({SERVE_B * steps / decode_s:.1f} tok/s), end to end "
        f"{SERVE_B * SERVE_GEN / total_s:.1f} generated tok/s")
    log(f"serve flash launches: {prefill_launches} in prefill, "
        f"{launches - prefill_launches} in decode; the prefill's bf16 "
        f"D={cfg.resolved_head_dim} calls take the "
        f"{flash_build.route(torch.bfloat16, cfg.resolved_head_dim)} route")
    log(f"serve peak device memory {peak / 1e9:.3f} GB; weights "
        f"{weight_bytes / 1e9:.3f} GB + KV cache {kv_bytes / 1e9:.3f} GB = "
        f"{(weight_bytes + kv_bytes) / 1e9:.3f} GB")
    log(f"serve sample tokens: {tokens[0, :16].tolist()}")

    # Every layer's attention at the main path's shape and dtype, on the
    # activations the plain path feeds it: the kernel and the bf16-score
    # control against the rounding rule (the plain path goes on unchanged).
    layer_ex = []

    def held(q, k, v, force, **opts):
        out = kernel_wrapper(q, k, v, force=force, **opts)
        layer_ex.append(bf16_excess(
            q, k, v, opts, plain=out,
            kernel=kernel_wrapper(q, k, v, force="cuda", **opts),
            control=attention_bf16_scores(q, k, v, **opts)))
        return out

    with attention_as(held) as kernel_wrapper:
        logits_ref, _ = model.prefill(params, {"tokens": prompts},
                                      force="ref")
    check(len(layer_ex) == cfg.num_layers,
          f"serve: {len(layer_ex)} attention calls held, expected "
          f"{cfg.num_layers}")
    for i, ex in enumerate(layer_ex):
        check_excess(f"serve layer {i}", ex)
    log("serve every layer's attention on the plain path's activations, "
        f"excess over half a bf16 ulp / max|v| (limit {F32_NOISE:.3e}): "
        f"kernel max {max(e['kernel'] for e in layer_ex):.3e}, plain max "
        f"{max(e['plain'] for e in layer_ex):.3e}, bf16-score control min "
        f"{min(e['control'] for e in layer_ex):.3e} / max "
        f"{max(e['control'] for e in layer_ex):.3e}, P-in-bf16 control min "
        f"{min(e['control_p_bf16'] for e in layer_ex):.3e} / max "
        f"{max(e['control_p_bf16'] for e in layer_ex):.3e}")

    # The logits at full depth, against the plain path summed in another
    # order (the floor) and the plain path with bf16 scores (the control).
    with attention_as(lambda q, k, v, force, **opts: kref.attention_ref(
            q, k, v, chunk=256, **opts)):
        logits_floor, _ = model.prefill(params, {"tokens": prompts},
                                        force="ref")
    with attention_as(lambda q, k, v, force, **opts: attention_bf16_scores(
            q, k, v, **opts)):
        logits_ctl, _ = model.prefill(params, {"tokens": prompts},
                                      force="ref")
    gaps = {}
    for name, x in (("kernel", logits), ("floor", logits_floor),
                    ("control", logits_ctl)):
        d = x - logits_ref
        gaps[name] = (float(d.abs().max()), float(d.pow(2).mean().sqrt()))
    ratio = {name: r / gaps["floor"][1] for name, (_, r) in gaps.items()}
    log(f"serve last-prompt-token logits (capped at "
        f"+-{cfg.final_logit_softcap}) against the plain path, max |gap| / "
        f"rms gap / rms over the floor's: "
        + "; ".join(f"{name} {a:.4f} / {r:.5f} / {ratio[name]:.4f}"
                    for name, (a, r) in gaps.items())
        + f" (floor: plain in 256-key chunks; control: bf16 scores; limit "
          f"{RMS_GAP_FACTOR})")
    check(ratio["kernel"] <= RMS_GAP_FACTOR,
          f"serve: rms logit gap {gaps['kernel'][1]} > {RMS_GAP_FACTOR} x "
          f"the summation-order floor {gaps['floor'][1]}")
    return launches, 1e3 * prefill_s


def dense_inputs(cfg, B, text, dtype, gen):
    """A cell's prompts (B, text) and, where the config has a frontend,
    stand-in embeddings of ``input_specs``' shape in `dtype`
    (unit-variance, as the token embeddings are drawn), else None."""
    prompts = torch.randint(0, cfg.vocab_size, (B, text), generator=gen,
                            device="cuda")
    spec = input_specs(cfg, ShapeConfig(cfg.name, "prefill", text, B)).get(
        "frontend_embeds")
    if spec is None:
        return prompts, None
    return prompts, torch.randn(spec.shape, generator=gen,
                                device="cuda").to(dtype)


def free_model():
    """Release a model's weights and caches before the next is drawn."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_dense_cut_depth():
    """phi3-mini, minitron-8b, chatglm3-6b, musicgen-large and internvl2-26b
    at full width, cut to 4 layers, f32: ``serve`` through the kernel (the
    wgmma-f32 route, one launch a layer) against the plain path on the
    same weights, prompts and (internvl2) frontend embeddings."""
    f32 = torch.float32
    for full, _, text in DENSE_CELLS:
        cfg = dataclasses.replace(full, num_layers=CUT_DEPTH_LAYERS)
        D, F = cfg.resolved_head_dim, cfg.frontend_tokens
        route = flash_build.route(f32, D)
        check(route == "wgmma-f32", f"cut-depth {cfg.name}: route {route}")
        model = Model(cfg, param_dtype=f32)
        params = model.init(SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        prompts, embeds = dense_inputs(cfg, CUT_DEPTH_B, text, f32, gen)
        before = ops.flash_attention.launches
        tok_k, logits_k = serve(model, params, prompts, CUT_DEPTH_GEN,
                                frontend_embeds=embeds)
        torch.cuda.synchronize()
        launches = ops.flash_attention.launches - before
        tok_r, logits_r = serve(model, params, prompts, CUT_DEPTH_GEN,
                                force="ref", frontend_embeds=embeds)
        torch.cuda.synchronize()
        tag = f"cut-depth {cfg.name}"
        check(launches == CUT_DEPTH_LAYERS,
              f"{tag}: {launches} flash launches for {CUT_DEPTH_LAYERS} "
              "layers")
        check(bool(torch.isfinite(logits_k).all()), f"{tag}: non-finite")
        torch.testing.assert_close(logits_k, logits_r, rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
        check(torch.equal(tok_k, tok_r),
              f"{tag}: greedy tokens differ\n{tok_k}\n{tok_r}")
        gap = float((logits_k - logits_r).abs().max())
        # decode held by its logits too, fed random tokens over the cache
        # each path's prefill built (greedy choices repeat on random weights)
        fed = torch.randint(0, cfg.vocab_size, (CUT_DEPTH_B, CUT_DEPTH_GEN),
                            generator=gen, device="cuda")
        dec_k = decode_logits(model, params, prompts, fed, "auto", embeds)
        dec_r = decode_logits(model, params, prompts, fed, "ref", embeds)
        check(bool(torch.isfinite(dec_k).all()), f"{tag}: non-finite decode")
        torch.testing.assert_close(dec_k, dec_r, rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
        dec_gap = float((dec_k - dec_r).abs().max())
        log(f"{tag} ({CUT_DEPTH_LAYERS} layers, full width, f32, B="
            f"{CUT_DEPTH_B}, {F} frontend + {text} prompt tokens; D={D}, "
            f"GQA group {cfg.num_heads // cfg.num_kv_heads}, {route} route, "
            f"{launches} launches in the prefill): kernel vs plain prefill "
            f"logits max gap {gap:.3e}, {CUT_DEPTH_GEN} decode steps' logits "
            f"max gap {dec_gap:.3e} (tol {MODEL_TOL}); {CUT_DEPTH_GEN} greedy "
            f"tokens identical: {tok_k[0].tolist()}")
        del model, params, logits_k, logits_r, dec_k, dec_r
        free_model()


def f32_scale_attention(q, k, v, chunk=512, **opts):
    """The plain version on f32 copies of q, k, v, rounded once to their
    dtype: the function the kernels round (1 / sqrt(D) in f32). The model's
    plain version takes 1 / sqrt(D) rounded to bf16 first, as the reference
    does; at D = 96 and 128 that is another function
    (``bf16_scale_is_exact``)."""
    return kref.attention_ref(*(t.float() for t in (q, k, v)), chunk=chunk,
                              **opts).to(q.dtype)


@contextlib.contextmanager
def routes_recorded():
    """Record every ``models.moe.route`` call inside the block: yields the
    list its ``Route``s are appended to, in call order (an MoE layer's
    calls in layer order, a prefill's before its decode steps')."""
    orig, calls = mmoe.route, []

    def recording(probs, k, capacity_factor=1.25):
        r = orig(probs, k, capacity_factor)
        calls.append(r)
        return r

    mmoe.route = recording
    try:
        yield calls
    finally:
        mmoe.route = orig


def route_flips(a, b):
    """(T, k) bool: the (token, slot) routes (the expert, and whether the
    slot is kept) that differ between two ``Route``s of one call."""
    return (a.idx != b.idx) | (a.keep != b.keep).view(a.idx.shape)


def expert_loads(r, E):
    """(E,): the tokens each expert holds in its capacity buffer."""
    return (r.slots.view(E, r.cap) < r.idx.shape[0]).sum(1)


def serve_floors(model, params, positions):
    """(prefill FLOP, the same with the experts' capacity-padded products,
    weight bytes) of one serving cell: 2 FLOP a weight a position for the
    weights a token uses (an MoE layer's k experts of E), every weight
    read once."""
    cfg = model.cfg
    embed = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    active = model.param_count() - embed
    padded = 0.0
    if cfg.num_experts:
        E, k, L = cfg.num_experts, cfg.experts_per_token, cfg.num_layers
        expert = 3 * cfg.d_model * cfg.d_ff
        active -= L * (E - k) * expert
        cap = mmoe.capacity(positions, k, E)
        padded = 2.0 * L * expert * (E * cap - positions * k)
    flop = 2.0 * active * positions
    return flop, flop + padded, weight_bytes


def dense_serve_cell(cfg, text):
    """One full-size bf16 serving cell of the dense stack (or the MoE
    family's, whose layers run the MoE block in place of the MLP): the
    prefill alone, then a whole serve call (the main path, the flash count
    set to 0 just before it and read just after), then the first, middle
    and last layers' attention under the rounding rule and the logits' rms
    gap (gated for the dense stack; logged for MoE beside the routes that
    differ between the paths, with each layer's expert load and drops).
    Returns its numbers."""
    L, D, F = cfg.num_layers, cfg.resolved_head_dim, cfg.frontend_tokens
    bf16 = torch.bfloat16
    tag = f"serve {cfg.name}"
    model = Model(cfg)  # bf16 weights on the card
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    positions = DENSE_B * (F + text)
    flop, padded_flop, weight_bytes = serve_floors(model, params, positions)
    residual = " with the dense residual" if cfg.moe_dense_residual else ""
    moe_note = (f", {cfg.num_experts} experts of {cfg.d_ff} top-"
                f"{cfg.experts_per_token}{residual}, "
                f"{mattn.padded_heads(cfg)} q heads as run"
                if cfg.num_experts else "")
    log(f"{tag}: {model.param_count()} parameters ({weight_bytes / 1e9:.3f} "
        f"GB bf16) drawn on the card in {time.perf_counter() - t0:.2f} s; "
        f"{L} layers, {cfg.num_heads} heads of {D} over {cfg.num_kv_heads} "
        f"kv heads{moe_note}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    prompts, embeds = dense_inputs(cfg, DENSE_B, text, bf16, gen)
    batch = {"tokens": prompts}
    if embeds is not None:
        batch["frontend_embeds"] = embeds
    route = flash_build.route(bf16, D)
    check(route == "wgmma", f"{tag}: flash route {route}")
    # warm-up at the cell's own shapes (cuBLAS's choices, the allocator's
    # blocks): after a 256-token warm-up, arctic-480b's first full-size
    # prefill took 121.7 ms against a median of 89.1 after it
    # (tools/moe_serve_profile.py; NVIDIA H100 80GB HBM3, 700 W)
    serve(model, params, prompts, 2, frontend_embeds=embeds)

    # time to the first token: serve one token, i.e. prefill and cache copy
    ops.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(model, params, prompts, 1, frontend_embeds=embeds)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.flash_attention.launches

    torch.cuda.reset_peak_memory_stats()
    with routes_recorded() as routes:
        ops.flash_attention.launches = 0  # the main path starts here
        t0 = time.perf_counter()
        tokens, logits = serve(model, params, prompts, DENSE_GEN,
                               frontend_embeds=embeds)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = ops.flash_attention.launches  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    check(prefill_launches == L, f"{tag}: {prefill_launches} flash launches "
          f"in the prefill, expected {L}")
    check(launches == prefill_launches,
          f"{tag}: {launches - prefill_launches} flash launches in decode")
    # greedy argmax reads the padded vocabulary, as the reference's does
    check(tuple(tokens.shape) == (DENSE_B, DENSE_GEN)
          and bool(((tokens >= 0) & (tokens < cfg.padded_vocab)).all()),
          f"{tag}: tokens {tuple(tokens.shape)} or outside the padded "
          "vocabulary")
    check(tuple(logits.shape) == (DENSE_B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"{tag}: prefill logits not finite or of the wrong shape")
    steps = DENSE_GEN - 1
    decode_s = total_s - prefill_s
    prefill_floor_s = flop / BF16_FLOP_PER_S
    decode_floor_s = weight_bytes / HBM_BYTES_PER_S
    kv_bytes = (2 * L * DENSE_B * (F + text + DENSE_GEN) * cfg.num_kv_heads
                * D * 2)
    padded_note = (f"; with the experts' capacity-padded products "
                   f"{1e3 * padded_flop / BF16_FLOP_PER_S:.1f} ms"
                   if cfg.num_experts else "")
    log(f"{tag} {DENSE_B} x ({F} frontend + {text} prompt) positions, "
        f"{DENSE_GEN} generated each: prefill {1e3 * prefill_s:.3f} ms "
        f"(floor {1e3 * prefill_floor_s:.1f} ms, "
        f"{prefill_s / prefill_floor_s:.1f}x{padded_note}), decode "
        f"{1e3 * decode_s / steps:.3f} ms/token over {steps} steps (floor "
        f"{1e3 * decode_floor_s:.2f} ms, "
        f"{decode_s / steps / decode_floor_s:.1f}x), end to end "
        f"{DENSE_B * DENSE_GEN / total_s:.1f} generated tok/s; peak device "
        f"memory {peak / 1e9:.3f} GB (weights {weight_bytes / 1e9:.3f} GB + "
        f"KV cache {kv_bytes / 1e9:.3f} GB)")
    log(f"{tag} flash launches: {prefill_launches} in prefill, "
        f"{launches - prefill_launches} in decode, on the {route} route "
        f"(D={D}, GQA group {mattn.padded_heads(cfg) // cfg.num_kv_heads}); "
        f"sample tokens {tokens[0, :16].tolist()}")
    if cfg.num_experts:
        check(len(routes) == L * DENSE_GEN,
              f"{tag}: {len(routes)} MoE routes in the serve call, expected "
              f"{L * DENSE_GEN}")
        E = cfg.num_experts
        for i, r in enumerate(routes[:L]):  # the prefill's layers
            load = expert_loads(r, E)
            log(f"{tag} layer {i} prefill routing: capacity {r.cap}, expert "
                f"load min {int(load.min())} / max {int(load.max())} of "
                f"{r.idx.numel()} (token, slot)s, "
                f"{int((~r.keep).sum())} dropped")
        dropped = sum(int((~r.keep).sum()) for r in routes[L:])
        log(f"{tag} decode routing: {steps} steps x {L} layers of "
            f"{DENSE_B} tokens over {E} x {routes[L].cap} slots, {dropped} "
            "(token, slot)s dropped")

    # The first, middle and last layers' attention at the main path's shape
    # and dtype, on the plain path's activations: the kernel and the
    # controls against the rounding rule. The plain path here takes its
    # attention at the kernel's f32 scale (f32_scale_attention).
    picks = sorted({0, L // 2, L - 1})
    layer_ex, calls = {}, []

    def held(q, k, v, force, **opts):
        out = f32_scale_attention(q, k, v, **opts)
        if len(calls) in picks:
            layer_ex[len(calls)] = bf16_excess(
                q, k, v, opts, kernel=kernel_wrapper(q, k, v, force="cuda",
                                                     **opts),
                control=attention_bf16_scores(q, k, v, **opts))
        calls.append(tuple(q.shape))
        return out

    with attention_as(held) as kernel_wrapper, routes_recorded() as plain:
        logits_ref, _ = model.prefill(params, batch, force="ref")
    check(len(calls) == L and sorted(layer_ex) == picks,
          f"{tag}: {len(calls)} attention calls, {sorted(layer_ex)} held")
    for i, ex in layer_ex.items():
        check_excess(f"{tag} layer {i} {calls[i]}", ex)
    log(f"{tag} layers {tuple(picks)}' attention on the plain path's "
        f"activations, excess over half a bf16 ulp / max|v| (limit "
        f"{F32_NOISE:.3e}): "
        + "; ".join(f"layer {i}: kernel {ex['kernel']:.3e}, bf16-score "
                    f"control {ex['control']:.3e}, P-in-bf16 control "
                    f"{ex['control_p_bf16']:.3e}"
                    for i, ex in layer_ex.items()))
    # the logits against the plain path, beside the plain path summed in
    # 256-key chunks (the floor)
    with attention_as(lambda q, k, v, force, **opts: f32_scale_attention(
            q, k, v, chunk=256, **opts)), routes_recorded() as floor:
        logits_floor, _ = model.prefill(params, batch, force="ref")
    gaps = {}
    for name, x in (("kernel", logits), ("floor", logits_floor)):
        d = x - logits_ref
        gaps[name] = (float(d.abs().max()), float(d.pow(2).mean().sqrt()))
    ratio = (gaps["kernel"][1] / gaps["floor"][1] if gaps["floor"][1] > 0
             else 0.0 if gaps["kernel"][1] == 0 else math.inf)
    flips = ""
    if cfg.num_experts:
        n = sum(r.idx.numel() for r in plain)
        kernel_flips, floor_flips = (
            sum(int(route_flips(a, b).sum()) for a, b in zip(other, plain))
            for other in (routes, floor))
        flips = (f"; (token, slot) routes that differ from the plain path's "
                 f"over the {L} layers: kernel {kernel_flips}, floor "
                 f"{floor_flips} of {n} (the rms gap "
                 "is not gated here: in bf16 a flipped route moves its "
                 "token's logits)")
    log(f"{tag} last-prompt-token logits against the plain path, max |gap| "
        f"/ rms gap: kernel {gaps['kernel'][0]:.4f} / {gaps['kernel'][1]:.5f}"
        f", floor {gaps['floor'][0]:.4f} / {gaps['floor'][1]:.5f}; kernel "
        f"rms over the floor's {ratio:.4f} (limit {RMS_GAP_FACTOR}"
        f"{', not applied' if cfg.num_experts else ''}){flips}")
    if not cfg.num_experts:
        check(ratio <= RMS_GAP_FACTOR,
              f"{tag}: rms logit gap {gaps['kernel'][1]} > {RMS_GAP_FACTOR} "
              f"x the summation-order floor {gaps['floor'][1]}")
    return dict(launches=launches, prefill_ms=1e3 * prefill_s,
                decode_ms=1e3 * decode_s / steps, peak_gb=peak / 1e9)


def phase_dense_serve():
    """The rest of the dense stack at full size in bf16, one model on the
    card at a time: phi3-mini (D = 96), minitron-8b, chatglm3-6b (a GQA
    group of 16, half-dim rotary), musicgen-large (D = 64) and internvl2-26b
    (a group of 6, 256 frontend embeddings ahead of the text)."""
    cells = {}
    for cfg, text, _ in DENSE_CELLS:
        free_model()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cells[cfg.name] = dense_serve_cell(cfg, text)
        free_model()
        log(f"serve {cfg.name}: {time.perf_counter() - t0:.1f} s")
    return cells


def dense_flash_records(flash_record, dense):
    """Fill the flash record's launches on the dense-stack serving paths
    (each layer shape's record: phi3-mini's under head dim 96, the others
    under ``layers``) and log the kernel's share of each prefill."""
    times = dict(flash_record["layers"],
                 **{"phi3-mini-3.8b layer": flash_record["head_dims"]["96"]})
    for name, cell in dense.items():
        layer = times[f"{name} layer"]
        layer["launches"] = cell["launches"]
        k_ms = cell["launches"] * layer["ms"]
        log(f"serve {name} flash kernel share of the prefill: "
            f"{cell['launches']} x {layer['ms']:.4f} ms (at "
            f"{tuple(layer['shape'])}) = {k_ms:.3f} / "
            f"{cell['prefill_ms']:.3f} ms = {k_ms / cell['prefill_ms']:.2%}")


def phase_moe_routing():
    """``route`` on the card against ``route`` on the CPU, fed the same f32
    probabilities: bitwise in every output, at arctic-480b's and kimi-k2's
    prefill widths from bf16 router logits (ties at the k-th place
    counted) and with a skewed router that drops tokens."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    T, d = DENSE_B * MOE_PROMPT, ARCTIC_480B.d_model
    for name, cfg, skew in (("arctic-480b", ARCTIC_480B, 0.0),
                            ("kimi-k2", KIMI_K2, 0.0),
                            ("skewed arctic-480b", ARCTIC_480B, MOE_SKEW)):
        E, k = cfg.num_experts, cfg.experts_per_token
        # the router as the model draws it, its product in bf16
        x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(d, E, generator=gen, device="cuda")
             * (0.1 / math.sqrt(d))).bfloat16()
        logits = (x @ w).float()
        logits[:, 0] += skew
        probs = torch.softmax(logits, dim=-1)
        card = mmoe.route(probs, k)
        cpu = mmoe.route(probs.cpu(), k)
        torch.cuda.synchronize()
        tag = f"moe routing {name} (T {T}, E {E}, top-{k})"
        check(probs.is_cuda and card.idx.is_cuda and card.slots.is_cuda,
              f"{tag}: routed off the card")
        check(card.cap == cpu.cap, f"{tag}: capacity {card.cap} vs {cpu.cap}")
        for field in ("idx", "gate", "pos", "keep", "dest", "slots"):
            a, b = getattr(card, field).cpu(), getattr(cpu, field)
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"{tag}: {field} differs between the card and the CPU")
        top = torch.sort(probs, dim=-1, descending=True)[0]
        ties = int((top[:, k - 1] == top[:, k]).sum())
        dropped = int((~card.keep).sum())
        load = expert_loads(card, E)
        if skew:
            check(int((card.idx == 0).sum()) > card.cap and dropped > 0,
                  f"{tag}: expert 0 holds {int((card.idx == 0).sum())} "
                  f"routes for {card.cap} slots, {dropped} dropped")
        else:
            check(ties > 0, f"{tag}: no tie at the k-th place to hold")
        log(f"{tag}: bitwise the CPU's in idx, gate, pos, keep, dest and the "
            f"slot map; capacity {card.cap}; {ties} tokens tied at the k-th "
            f"place; expert load min {int(load.min())} / max "
            f"{int(load.max())}; {dropped} (token, slot)s dropped")


def phase_moe_cut_depth():
    """arctic-480b (128 experts) and kimi-k2 (192 of 384 experts, top-8)
    at full width, 1 layer, f32: ``serve`` through the kernel against the
    plain path on the same weights and prompts, each route recorded. With
    one layer the MoE block comes last, so a route that differs between
    the paths moves only its own token's logits: those are left out, and
    the rest are held to 2e-4."""
    f32 = torch.float32
    for full, experts in MOE_CUT:
        cfg = dataclasses.replace(full, num_layers=1, num_experts=experts)
        tag = f"cut-depth {cfg.name}"
        D, B, S = cfg.resolved_head_dim, MOE_CUT_B, MOE_CUT_PROMPT
        route = flash_build.route(f32, D)
        check(route == "wgmma-f32", f"{tag}: route {route}")
        model = Model(cfg, param_dtype=f32)
        params = model.init(SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device="cuda")
        fed = torch.randint(0, cfg.vocab_size, (B, CUT_DEPTH_GEN),
                            generator=gen, device="cuda")
        runs = {}
        for force in ("auto", "ref"):
            before = ops.flash_attention.launches
            with routes_recorded() as served:
                tok, logits = serve(model, params, prompts, CUT_DEPTH_GEN,
                                    force=force)
                torch.cuda.synchronize()
            launches = ops.flash_attention.launches - before
            with routes_recorded() as fed_routes:
                dec = decode_logits(model, params, prompts, fed, force)
            runs[force] = (tok, logits, served, dec, fed_routes, launches)
        tok_k, logits_k, served_k, dec_k, fed_k, launches = runs["auto"]
        tok_r, logits_r, served_r, dec_r, fed_r, ref_launches = runs["ref"]
        check(launches == 1 and ref_launches == 0,
              f"{tag}: {launches} flash launches in the kernel path's serve, "
              f"{ref_launches} in the plain path's")
        check(bool(torch.isfinite(logits_k).all())
              and bool(torch.isfinite(dec_k).all()), f"{tag}: non-finite")
        check(len(served_k) == len(served_r) == CUT_DEPTH_GEN
              and len(fed_k) == len(fed_r) == 1 + CUT_DEPTH_GEN,
              f"{tag}: {len(served_k)} / {len(fed_k)} routes recorded")
        flips = [route_flips(a, b) for a, b in zip(served_k + fed_k,
                                                   served_r + fed_r)]
        n = sum(f.numel() for f in flips)
        n_flips = sum(int(f.sum()) for f in flips)
        check(n_flips <= MOE_FLIP_LIMIT * n,
              f"{tag}: {n_flips} of {n} (token, slot) routes differ between "
              f"the paths (limit {MOE_FLIP_LIMIT:.1%})")
        # a token's routes agree where none of its k slots flipped; the
        # prefill's logits are the last prompt token's of each row
        last = torch.arange(B, device="cuda") * S + S - 1
        agree = [~f.any(1) for f in flips]
        served_agree = [agree[0][last]] + agree[1:CUT_DEPTH_GEN]
        fed_agree = torch.stack(agree[CUT_DEPTH_GEN + 1:], 1)  # (B, steps)
        torch.testing.assert_close(logits_k[served_agree[0]],
                                   logits_r[served_agree[0]],
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        # each fed decode step's logits where that step's routes agree
        torch.testing.assert_close(dec_k[fed_agree], dec_r[fed_agree],
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        # greedy tokens: a row's token j is held while every route before
        # it in that row agreed (the prefill's last token, decode steps < j)
        held = torch.stack(served_agree, 1).cumprod(1).bool()
        check(torch.equal(tok_k[held], tok_r[held]),
              f"{tag}: greedy tokens differ where the routes agree\n"
              f"{tok_k}\n{tok_r}")
        gap = float((logits_k - logits_r)[served_agree[0]].abs().max()) \
            if bool(served_agree[0].any()) else float("nan")
        dec_gap = float((dec_k - dec_r)[fed_agree].abs().max())
        log(f"{tag} (1 layer, full width, {cfg.num_experts} experts top-"
            f"{cfg.experts_per_token}, f32, B={B}, prompt {S}; D={D}, GQA "
            f"group {mattn.padded_heads(cfg) // cfg.num_kv_heads}, {route} "
            f"route, {launches} launch a prefill): (token, slot) routes that "
            f"differ between the paths {n_flips} of {n} (limit "
            f"{MOE_FLIP_LIMIT:.1%}); where a token's routes agree, prefill "
            f"logits max gap {gap:.3e} ({int(served_agree[0].sum())} of {B} "
            f"rows), {CUT_DEPTH_GEN} fed decode steps' logits max gap "
            f"{dec_gap:.3e} ({int(fed_agree.sum())} of {fed_agree.numel()}) "
            f"(tol {MODEL_TOL}); greedy tokens identical where held "
            f"({int(held.sum())} of {held.numel()}): {tok_k[0].tolist()}")
        del model, params, runs, logits_k, logits_r, dec_k, dec_r
        del served_k, served_r, fed_k, fed_r
        free_model()


def phase_moe_serve():
    """The MoE family at full width in bf16, cut in depth to fit the card,
    one model at a time: arctic-480b at 2 layers (all 128 experts, the
    dense residual, 56 heads padded to 64) and kimi-k2 at 1 (all 384
    experts, head dim 128 over d_model 7168)."""
    cells = {}
    for full, layers in MOE_SERVE:
        cfg = dataclasses.replace(full, num_layers=layers)
        free_model()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        log(f"serve {cfg.name}: {layers} of its {full.num_layers} layers")
        cells[cfg.name] = dense_serve_cell(cfg, MOE_PROMPT)
        free_model()
        log(f"serve {cfg.name}: {time.perf_counter() - t0:.1f} s")
    return cells


def moe_flash_records(flash_record, moe_cells):
    """Fill the MoE layer's flash record with its launches on the MoE
    serving paths and log the kernel's share of each prefill."""
    layer = flash_record["layers"][MOE_FLASH[0][0]]
    layer["launches_by_path"] = {f"{name} serve": cell["launches"]
                                 for name, cell in moe_cells.items()}
    layer["launches"] = sum(layer["launches_by_path"].values())
    for name, cell in moe_cells.items():
        k_ms = cell["launches"] * layer["ms"]
        log(f"serve {name} flash kernel share of the prefill: "
            f"{cell['launches']} x {layer['ms']:.4f} ms (at "
            f"{tuple(layer['shape'])}) = {k_ms:.3f} / "
            f"{cell['prefill_ms']:.3f} ms = {k_ms / cell['prefill_ms']:.2%}")


@contextlib.contextmanager
def attention_as(fn):
    """Route the model's attention calls to fn(q, k, v, force, **opts)
    inside the block; yields the wrapper they reach otherwise."""
    orig = mattn.kops
    mattn.kops = types.SimpleNamespace(flash_attention=fn)
    try:
        yield orig.flash_attention
    finally:
        mattn.kops = orig


# ---------------------------------------------------------------------------
# ssd_scan and the mamba2-130m serving path
# ---------------------------------------------------------------------------
def ssd_bound_ms(B, S, H, P, G, N, dtype, chunk=64):
    """Least time for one call: x, dt, B, C read once and y written once
    over the HBM rate, vs the chunked work over the dtype's peak: per
    chunk of q steps C.B^T once per group (q^2 N), and per head W.x over
    j <= i (q(q+1)/2 P) and the two state terms (2 q N P), 2 FLOP each.
    The chunk is fixed at 64, whatever chunk a kernel takes, so the bound
    stays one yardstick across kernel designs."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) \
        + 4 * 2 * H  # A and D in f32
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        flops += 2 * (B * G * q * q * N
                      + B * H * (q * (q + 1) // 2 * P + 2 * q * N * P))
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_fwd_tc_bound_ms(B, S, H, P, G, N, dtype, chunk=64):
    """The same least time for the tensor-core routes: the bytes of
    ``ssd_bound_ms`` against its chunked work as the bf16 tensor-core
    products take it (989 TFLOP/s). f32: every product of two f32
    operands as six piece products (three pieces each, a + b <= 2;
    ``ref.ssd_chunk_terms(in_pieces=3, mid_pieces=3)``); bf16: C.B^T as
    one, each product with an f32 operand split hi + lo as two."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) \
        + 4 * 2 * H
    k_in, k_mid = (3, 3) if dtype == torch.float32 else (1, 2)
    in_in = sum(1 for a in range(k_in) for b in range(k_in) if a + b <= 2)
    in_mid = sum(1 for a in range(k_mid) for b in range(k_in) if a + b <= 2)
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        flops += 2 * (in_in * B * G * q * q * N
                      + in_mid * B * H * (q * (q + 1) // 2 * P
                                          + 2 * q * N * P))
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_keys(dtype, plain, tc):
    """A record's bound keys from the function's work at its dtype's own
    peak (`plain`: f32 on the CUDA cores, bf16 on the tensor cores) and as
    the split tensor-core products take it (`tc`), each (ms, by).
    ``bound_ms`` is the least of the two: for f32 the tensor-core one (six
    piece products at 989 TFLOP/s take less time than one at 67), kept
    beside the CUDA-core figure; for bf16 the unsplit work, kept beside the
    split products' figure."""
    (p_ms, p_by), (t_ms, t_by) = plain, tc
    if dtype == torch.float32:
        return dict(bound_ms=t_ms, bound_by=t_by, cuda_core_bound_ms=p_ms,
                    cuda_core_bound_by=p_by)
    return dict(bound_ms=p_ms, bound_by=p_by, tensor_core_bound_ms=t_ms,
                tensor_core_bound_by=t_by)


def ssd_inputs(B, S, H, P, G, N, decay, gen):
    """x, dt, A, Bm, Cm, D on the card, f32. "mamba2": A = -U[1, 16] and
    dt log-uniform in [1e-3, 1e-1], as Mamba-2 initialises them; "slow":
    A = -U[0.5, 1] and dt log-uniform in [1e-3, 1e-2], so exp(sum dt A)
    over a 64-step chunk stays above 0.5 and the carry dominates."""
    lo, hi, a_lo, a_hi = ((1e-3, 1e-1, 1.0, 16.0) if decay == "mamba2"
                          else (1e-3, 1e-2, 0.5, 1.0))

    def uniform(shape, a, b):
        return torch.rand(shape, generator=gen, device="cuda") * (b - a) + a

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std

    return (normal((B, S, H, P), 0.5),
            torch.exp(uniform((B, S, H), math.log(lo), math.log(hi))),
            -uniform((H,), a_lo, a_hi),
            normal((B, S, G, N), 0.3), normal((B, S, G, N), 0.3),
            1.0 + normal((H,), 0.5))


def ssd_terms(x, dt, A, Bm, Cm, D, dtype=torch.float32, **splits):
    """The plain chunked SSD on copies in `dtype` (f32, or f64 for the f32
    route's oracle), at the kernel's chunk, as (y, y_intra + D x, inter
    share): the oracle, the control that drops the state the kernel
    carries from chunk to chunk (before rounding), and ||y_inter|| /
    ||y||. `splits` go to ``ref.ssd_chunk_terms``: how the operands of the
    tensor-core products are rounded."""
    f = [t.to(dtype) for t in (x, dt, A, Bm, Cm)]
    y_intra, y_inter = kref.ssd_chunk_terms(*f, chunk=ssd_build.CHUNK,
                                            **splits)
    dx = D.to(dtype)[None, None, :, None] * f[0]
    y = y_intra + y_inter + dx
    share = float(y_inter.detach().norm() / y.detach().norm())
    return y, y_intra + dx, share


# The single-rounding controls: each f32 operand of a tensor-core product
# rounded once to bf16 (``ref.ssd_chunk_terms``'s splits; the wgmma kernel
# takes each as hi + lo). On the CPU each fails the rule by 2-50x
# (tests/test_torch_ssd_split.py).
SSD_ROUNDING_CONTROLS = {"control_w_bf16": dict(w_split=1),
                         "control_state_bf16": dict(state_split=1),
                         "control_update_bf16": dict(update_split=1)}
# the controls that act only through the state carried from one chunk to
# the next: a launch of one chunk (a mesh rank's 64-position prefill) has
# none to break, so they are held only where S exceeds the kernel's chunk
SSD_CARRY_CONTROLS = ("control_carry", "control_state_bf16",
                      "control_update_bf16")


def ssd_excess(x, dt, A, Bm, Cm, D, **outs):
    """The bf16 rounding rule for SSD outputs (`tol.half_ulp_excess` over
    max|y|), with every control: the carry dropped, and each of W, the
    state as C . state reads it and x_j w_j of the state update rounded
    once to bf16."""
    oracle, dropped, share = ssd_terms(x, dt, A, Bm, Cm, D)
    bf16 = torch.bfloat16
    controls = {name: ssd_terms(x, dt, A, Bm, Cm, D, **splits)[0].to(bf16)
                for name, splits in SSD_ROUNDING_CONTROLS.items()}
    ex = tol.half_ulp_excess(oracle, float(oracle.abs().max()),
                             control_carry=dropped.to(bf16), **controls,
                             **outs)
    return ex, share


def ssd_f32_oracle_gaps(x, dt, A, Bm, Cm, D, out):
    """The f32 route's rule: |y - oracle| / max|oracle| of the kernel's
    output and of both controls, the oracle the plain chunked SSD in f64:
    the carry dropped, and every operand of the tensor-core products
    rounded once to bf16. Computed one at a time: f64 at zamba2's layer
    takes GBs."""
    oracle, dropped, _ = ssd_terms(x, dt, A, Bm, Cm, D, dtype=torch.float64)
    scale = float(oracle.abs().max())
    gaps = {"kernel": float((out.double() - oracle).abs().max()) / scale,
            "control_carry": float((dropped - oracle).abs().max()) / scale}
    del dropped
    single, _, _ = ssd_terms(x, dt, A, Bm, Cm, D, dtype=torch.float64,
                             in_pieces=1, mid_pieces=1)
    gaps["control_bf16_operands"] = float((single - oracle).abs().max()) \
        / scale
    return gaps


def phase_ssd():
    """ssd_scan against its plain version at the mamba2-130m layer shapes
    (serving and training), zamba2's and unaligned ones, in both dtypes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    B, S, H, P, G, N = SSD_SHAPE
    cases = [
        ("mamba2 layer", (B, S, H, P, G, N), "mamba2"),
        ("slow decay", (B, S, H, P, G, N), "slow"),
        ("mamba2 training layer", SSD_TRAIN_SHAPE, "mamba2"),
        ("unaligned S=1000", (B, 1000, H, P, G, N), "mamba2"),
        ("unaligned P16 N16 G2", (4, 1000, 8, 16, 2, 16), "mamba2"),
        # 3 heads a group: the block of the last pair has one head, and the
        # second consumer warpgroup computes on zeros through every barrier
        ("odd heads a group P32 N32", (1, 333, 6, 32, 2, 32), "mamba2"),
        ("G=2", (4, S, H, P, 2, N), "mamba2"),
        ("zamba2 layer", ZAMBA2_SSD, "mamba2"),
    ]
    # a rank's launches in phase_mesh_lm's SSM cells: its heads of
    # mamba2-130m's 24 and zamba2-7b's 112 on (2, 2) (and on MESH_POD), a
    # training row and a prefill's two rows of MESH_SSM_PROMPT
    cases += [(f"{name} mesh rank {part}", (rows, seq, heads, P, 1, n),
               "mamba2")
              for name, heads, n in (("mamba2", 12, 128), ("zamba2", 56, 64))
              for part, rows, seq in (("layer", 1, MESH_SSM_S),
                                      ("prefill", 2, MESH_SSM_PROMPT))]
    max_err, worst_f32 = 0.0, 0.0
    for name, shape, decay in cases:
        x, dt, A, Bm, Cm, D = ssd_inputs(*shape, decay, gen)
        for dtype in (f32, bf16):
            args = [t.to(dtype) for t in (x, dt)] + [A] \
                + [t.to(dtype) for t in (Bm, Cm)] + [D]
            kind = ssd_build.route(dtype, shape[3], shape[5])
            tag = f"ssd {name} {shape} {dtype} {decay} ({kind} route)"
            routes = dict(ops.ssd_scan.route_launches)
            a = ops.ssd_scan(*args, force="cuda")
            b = ops.ssd_scan(*args, force="cuda")
            want = ops.ssd_scan(*args, chunk=256, force="ref")
            torch.cuda.synchronize()
            check(ops.ssd_scan.route_launches[kind] == routes[kind] + 2,
                  f"{tag}: the launches did not take that route ({routes} "
                  f"-> {ops.ssd_scan.route_launches})")
            check(torch.equal(a, b), f"{tag}: two launches differ")
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite output")
            carried = shape[1] > ssd_build.CHUNK
            if dtype == bf16:
                ex, share = ssd_excess(*args, kernel=a, plain=want)
                check_excess(tag, {k: v for k, v in ex.items() if carried
                                   or k not in SSD_CARRY_CONTROLS})
                rule = ("excess over half a bf16 ulp / max|y|: "
                        + ", ".join(f"{k} {v:.3e}" for k, v in ex.items())
                        + f" (limit {F32_NOISE:.3e})")
            else:
                torch.testing.assert_close(a, want, rtol=SSD_F32_TOL,
                                           atol=SSD_F32_TOL)
                oracle, dropped, share = ssd_terms(*args)
                gap = float((dropped - oracle).abs().max())
                check(gap > 10 * SSD_F32_TOL or not carried,
                      f"{tag}: dropping the carry moves y by only {gap}")
                del oracle, dropped
                gaps = ssd_f32_oracle_gaps(*args, a)
                check(gaps["kernel"] <= SSD_F32_ORACLE_TOL,
                      f"{tag}: {gaps['kernel']:.3e} of max|y| off the f64 "
                      f"oracle, above {SSD_F32_ORACLE_TOL}")
                for control in ("control_carry", "control_bf16_operands")[
                        0 if carried else 1:]:
                    check(gaps[control] > SSD_F32_ORACLE_TOL,
                          f"{tag}: the {control} is only "
                          f"{gaps[control]:.3e} of max|y| off the f64 "
                          "oracle: the rule cannot see it")
                worst_f32 = max(worst_f32, gaps["kernel"])
                rule = (f"tol {SSD_F32_TOL}; the carry-dropping control is "
                        f"{gap:.3e} off; off the f64 oracle / max|y|: "
                        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
                        + f" (limit {SSD_F32_ORACLE_TOL})")
            err = float((a.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            log(f"{tag}: bitwise across launches, max|kernel-plain| = "
                f"{err:.3e}, ||y_inter||/||y|| = {share:.4f}; {rule}")

    log(f"ssd f32 route ({ssd_build.route(f32, P, N)}): every case within "
        f"{worst_f32:.3e} of max|y| off the f64 oracle (limit "
        f"{SSD_F32_ORACLE_TOL}), both controls outside it")

    x, dt, A, Bm, Cm, D = ssd_inputs(2, 300, 4, P, G, N, "mamba2", gen)
    for dtype in (bf16, f32):
        offset_view_case("ssd", lambda *t: ops.ssd_scan(*t, force="cuda"),
                         [x.to(dtype), dt.to(dtype), A, Bm.to(dtype),
                          Cm.to(dtype), D], (0, 3, 4),
                         ssd_build.route(dtype, P, N))

    times = {}
    for layer, shape in (("mamba2 layer", SSD_SHAPE),
                         ("mamba2 training layer", SSD_TRAIN_SHAPE),
                         ("zamba2 layer", ZAMBA2_SSD)):
        x, dt, A, Bm, Cm, D = ssd_inputs(*shape, "mamba2", gen)
        for dtype in (bf16, f32):
            args = [t.to(dtype) for t in (x, dt)] + [A] \
                + [t.to(dtype) for t in (Bm, Cm)] + [D]
            ms = cuda_ms(lambda: ops.ssd_scan(*args, force="cuda"), reps=10,
                         warmup=2)
            plain_ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk=256,
                                                    force="ref"),
                               reps=3, warmup=1)
            plain = ssd_bound_ms(*shape, dtype)
            tc = ssd_fwd_tc_bound_ms(*shape, dtype)
            bounds = bound_keys(dtype, plain, tc)
            times[layer, dtype] = dict(
                shape=list(shape), ms=ms, plain_ms=plain_ms, **bounds,
                library_ms=None, launches=None)
            other, (o_ms, o_by) = (("CUDA-core bound", plain) if dtype == f32
                                   else ("split products' bound", tc))
            before = ("" if dtype == bf16 else
                      f", the CUDA-core design {SSD_F32_CUDA_CORE_MS[layer]}"
                      f" ms ({SSD_F32_CUDA_CORE_MS[layer] / ms:.2f}x)")
            log(f"ssd {layer} {shape} {dtype} ({ssd_build.route(dtype, P, N)}"
                f" route): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bounds['bound_ms']:.5f} ms ({bounds['bound_by']}), "
                f"kernel/bound {ms / bounds['bound_ms']:.1f}x; the {other} "
                f"{o_ms:.5f} ms ({o_by}), kernel/that {ms / o_ms:.1f}x"
                f"{before}")
        del x, dt, A, Bm, Cm, D, args
    top = times["mamba2 layer", bf16]
    f32_record = dict(times["mamba2 training layer", f32],
                      source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                      route=ssd_build.route(f32, P, N), max_f32_oracle_gap=
                      worst_f32, shapes={
                          layer: times[layer, f32]
                          for layer in ("mamba2 layer", "zamba2 layer")})
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu",
                replaces="src/repro/kernels/ssd_scan.py:67",
                launches=None, max_abs_err=max_err, ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=None,
                shapes={"zamba2 layer": times["zamba2 layer", bf16]},
                f32=f32_record)


def ssm_params(model, seed):
    """Weights of an SSM or hybrid model from `seed`, with A_log = log U[1, 16] and dt_bias =
    softplus^-1(log-uniform [1e-3, 1e-1]) per layer and head, as Mamba-2
    initialises them: the template's A_log = 1, dt_bias = 0 decay the state
    to 0 within a chunk, so no check could see the carry."""
    params = model.init(seed)
    gen = torch.Generator(device=model.device).manual_seed(seed + 100)
    ssm_p = params["layers"]["ssm"]
    shape = ssm_p["A_log"].shape
    u = torch.rand(shape, generator=gen, device=model.device)
    ssm_p["A_log"].copy_(torch.log(1.0 + 15.0 * u))
    u = torch.rand(shape, generator=gen, device=model.device)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    ssm_p["dt_bias"].copy_(torch.log(torch.expm1(dt0)))
    return params


def gap_stats(a, b):
    """Max and rms of |a - b|, and how many entries break the elementwise
    rtol = atol = MODEL_TOL rule against b."""
    d = (a - b).abs()
    return dict(max=float(d.max()), rms=float(d.pow(2).mean().sqrt()),
                over=int((d > MODEL_TOL + MODEL_TOL * b.abs()).sum()))


def ssd_at_chunk(chunk):
    """The plain version at a fixed chunk length, whatever the model asks:
    the same function summed in another order (the floor)."""
    def fn(x, dt, A, Bm, Cm, D, **_):
        return kref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    return fn


def ssd_carry_dropped(x, dt, A, Bm, Cm, D, **_):
    """The control: the SSD with the state between the kernel's chunks
    dropped."""
    _, dropped, _ = ssd_terms(x, dt, A, Bm, Cm, D)
    return dropped.to(x.dtype)


def phase_ssm_f32():
    """Full-depth mamba2-130m in f32. Each layer's SSD, on the plain path's
    activations, within SSD_F32_TOL of its plain version (a carry-dropping
    control must fail that). At the logits, the kernel path's prefill, the
    decode warm-up's last logits (the recurrence) and 8 decode steps fed
    random tokens, against the plain path: their rms gaps within
    FLOOR_FACTOR of the floor, the plain path against itself at the
    kernel's chunk length; the carry-dropping control outside it."""
    cfg = MAMBA2_130M
    B, P, n = SSM_F32_B, SSM_F32_PROMPT, SSM_F32_FED
    model = Model(cfg, param_dtype=torch.float32)
    params = ssm_params(model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # the prompt, the fed tokens, and more, so the scan over all of them
    # keeps the reference's S % chunk == 0
    toks = torch.randint(0, cfg.vocab_size, (B, P + cfg.ssm_chunk),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :P]}
    before = ops.ssd_scan.launches
    f32_route = ssd_build.route(torch.float32, cfg.ssm_head_dim,
                                cfg.ssm_state)
    core = ops.ssd_scan.route_launches[f32_route]
    logits_k, _ = model.prefill(params, batch)
    torch.cuda.synchronize()
    launches = ops.ssd_scan.launches - before
    check(f32_route == "wgmma-f32" and launches == cfg.num_layers
          and ops.ssd_scan.route_launches[f32_route] - core == launches,
          f"mamba2 f32: {launches} ssd launches in a {cfg.num_layers}-layer "
          f"prefill, not all on the wgmma-f32 route ({f32_route})")

    layers = []

    def held(x, dt, A, Bm, Cm, D, chunk, force):
        out = kernel_wrapper(x, dt, A, Bm, Cm, D, chunk=chunk, force=force)
        k = kernel_wrapper(x, dt, A, Bm, Cm, D, force="cuda")
        dropped = ssd_carry_dropped(x, dt, A, Bm, Cm, D)
        torch.testing.assert_close(k, out, rtol=SSD_F32_TOL, atol=SSD_F32_TOL)
        over = (dropped - out).abs() - (SSD_F32_TOL + SSD_F32_TOL * out.abs())
        check(float(over.max()) > 0, f"mamba2 f32 layer {len(layers)}: the "
              "carry-dropping control passes the f32 tolerance")
        layers.append((float((k - out).abs().max()),
                       float((dropped - out).abs().max())))
        return out

    with ssd_as(held) as kernel_wrapper:
        logits_r, _ = model.prefill(params, batch, force="ref")
    check(len(layers) == cfg.num_layers,
          f"mamba2 f32: {len(layers)} ssd calls held")
    log(f"mamba2-130m f32 every layer's SSD on the plain path's activations "
        f"(B={B}, prompt {P}): max|kernel-plain| "
        f"{max(k for k, _ in layers):.3e} (tol {SSD_F32_TOL}); the "
        f"carry-dropping control min {min(c for _, c in layers):.3e} off")

    with ssd_as(ssd_at_chunk(ssd_build.CHUNK)):
        logits_f, _ = model.prefill(params, batch, force="ref")
        scan_f, _ = transformer.forward(params, toks, cfg, force="ref")
    with ssd_as(ssd_carry_dropped):
        logits_c, _ = model.prefill(params, batch, force="ref")
    warm, cache = warm_up(model, params, toks[:, :P],
                          model.cache_template(B, P + n))
    dec = []
    for i in range(P, P + n):
        pos = torch.full((B,), i, dtype=torch.long, device="cuda")
        logits, cache = model.decode(params, cache, toks[:, i:i + 1], pos)
        dec.append(logits)
    dec = torch.stack(dec, dim=1)
    scan_k, _ = transformer.forward(params, toks, cfg)
    scan_r, _ = transformer.forward(params, toks, cfg, force="ref")
    at = slice(P, P + n)
    torch.cuda.synchronize()
    for name, x in (("kernel", logits_k), ("plain", logits_r), ("warm", warm),
                    ("decode", dec), ("scan", scan_k)):
        check(bool(torch.isfinite(x).all()), f"mamba2 f32: {name} non-finite")
    prefill = {"kernel path": gap_stats(logits_k, logits_r),
               "decode warm-up (recurrence)": gap_stats(warm, logits_r),
               "floor: plain at chunk 64": gap_stats(logits_f, logits_r),
               "control: carry dropped": gap_stats(logits_c, logits_r)}
    steps = {"kernel path's scan": gap_stats(scan_k[:, at], scan_r[:, at]),
             f"{n} decode steps (recurrence)": gap_stats(dec, scan_r[:, at]),
             "floor: plain at chunk 64": gap_stats(scan_f[:, at],
                                                   scan_r[:, at])}
    for where, gaps in (("prefill last-token logits", prefill),
                        (f"logits at the {n} fed positions", steps)):
        floor = gaps["floor: plain at chunk 64"]["rms"]
        log(f"mamba2-130m f32 {where} against the plain path (chunk "
            f"{cfg.ssm_chunk}), max / rms / entries over rtol=atol="
            f"{MODEL_TOL} / rms over the floor's: "
            + "; ".join(f"{k} {g['max']:.3e} / {g['rms']:.3e} / {g['over']} "
                        f"/ {g['rms'] / floor:.3f}" for k, g in gaps.items())
            + f" (limit {FLOOR_FACTOR} x the floor's rms; logits max|.| "
              f"{float(logits_r.abs().max()):.2f})")
        for k, g in gaps.items():
            if k.startswith("floor"):
                continue
            if k.startswith("control"):
                check(g["rms"] > FLOOR_FACTOR * floor,
                      f"mamba2 f32 {where}: the {k} control is within "
                      f"{FLOOR_FACTOR} x the floor ({g}, floor {floor})")
            else:
                check(g["rms"] <= FLOOR_FACTOR * floor,
                      f"mamba2 f32 {where}: {k} rms gap {g['rms']} > "
                      f"{FLOOR_FACTOR} x the floor {floor}")
    log(f"mamba2-130m f32 decode argmax {dec.argmax(-1).tolist()}")


@contextlib.contextmanager
def ssd_as(fn):
    """Route the model's SSD calls to fn(x, dt, A, Bm, Cm, D, chunk=...,
    force=...) inside the block; yields the wrapper they reach otherwise."""
    orig = mssm.kops
    mssm.kops = types.SimpleNamespace(ssd_scan=fn)
    try:
        yield orig.ssd_scan
    finally:
        mssm.kops = orig


@contextlib.contextmanager
def tma_copies():
    """Count ``ops.tma_operand``'s calls inside the block, and the copies
    it makes (a strided or misaligned operand) with their bytes."""
    seen = dict(calls=0, copies=0, bytes=0)
    orig = ops.tma_operand

    def counted(t):
        out = orig(t)
        seen["calls"] += 1
        if out is not t:
            seen["copies"] += 1
            seen["bytes"] += out.numel() * out.element_size()
        return out

    ops.tma_operand = counted
    try:
        yield seen
    finally:
        ops.tma_operand = orig


def phase_ssm_serve():
    """The third main path: bf16 mamba2-130m at full width, cut to
    SSM_SERVE_LAYERS layers, serving a batch."""
    cfg = dataclasses.replace(MAMBA2_130M, num_layers=SSM_SERVE_LAYERS)
    B, P, n = SSM_SERVE_B, SSM_SERVE_PROMPT, SSM_SERVE_GEN
    model = Model(cfg)  # bf16 weights on the card
    params = ssm_params(model, SEED)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda")
    serve(model, params, prompts[:, :16], 2)  # warm-up: handles, library
    # time to the first token: serve one token, i.e. the prefill
    ops.ssd_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(model, params, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.ssd_scan.launches

    # the main path: a whole serve call on the first SSM_SERVE_FED
    # positions, its decode warm-up over them timed inside it
    # (``timed_warm_up``), the greedy decode steps after it
    fed = prompts[:, :SSM_SERVE_FED]
    torch.cuda.reset_peak_memory_stats()
    ops.ssd_scan.launches = 0  # the main path starts here
    for kind in ops.ssd_scan.route_launches:
        ops.ssd_scan.route_launches[kind] = 0
    torch.cuda.synchronize()
    with timed_warm_up({}) as marks:
        t0 = time.perf_counter()
        tokens, logits = serve(model, params, fed, n)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = ops.ssd_scan.launches  # ... and ends here
    check("counts" in marks, "mamba2 serve: no warm-up ran")
    warm_s = marks["end"] - marks["start"]
    decode_s = total_s - (marks["end"] - t0)
    by_route = dict(ops.ssd_scan.route_launches)
    peak = torch.cuda.max_memory_allocated()

    check(prefill_launches == cfg.num_layers,
          f"mamba2 serve: {prefill_launches} ssd launches in the prefill, "
          f"expected {cfg.num_layers}")
    check(launches == prefill_launches,
          f"mamba2 serve: {launches - prefill_launches} ssd launches in the "
          "warm-up and decode")
    check(by_route["wgmma"] == launches == cfg.num_layers,
          f"mamba2 serve: ssd launches by route {by_route}, expected all "
          f"{cfg.num_layers} on the wgmma route")
    check(tuple(tokens.shape) == (B, n), f"mamba2 serve: tokens "
          f"{tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "mamba2 serve: a token outside the vocabulary")
    check(tuple(logits.shape) == (B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "mamba2 serve: prefill logits not finite or of the wrong shape")
    steps = n - 1
    log(f"mamba2 serve ({cfg.num_layers} of {MAMBA2_130M.num_layers} "
        f"layers) {B} x {P} prompt tokens: prefill "
        f"{1e3 * prefill_s:.3f} ms ({B * P / prefill_s:.1f} prompt tok/s); "
        f"a serve call on the first {SSM_SERVE_FED}, {n} generated each: "
        f"decode warm-up over them {1e3 * warm_s:.3f} ms "
        f"({1e3 * warm_s / SSM_SERVE_FED:.3f} ms a position), decode "
        f"{1e3 * decode_s / steps:.3f} ms/token over {steps} steps; serve "
        f"end to end {1e3 * total_s:.3f} ms, {B * n / total_s:.1f} generated "
        "tok/s")
    log(f"mamba2 serve ssd launches: {prefill_launches} in the prefill, "
        f"{launches - prefill_launches} in the warm-up and decode; by route "
        f"{by_route}")
    log(f"mamba2 serve peak device memory {peak / 1e9:.3f} GB; weights "
        f"{weight_bytes / 1e9:.3f} GB bf16")
    log(f"mamba2 serve sample tokens: {tokens[0, :16].tolist()}")

    # Every layer's SSD at the main path's shape and dtype, on the
    # activations the plain path feeds it: the kernel and every control
    # against the rounding rule (the plain path goes on unchanged).
    layer_ex = []

    def held(x, dt, A, Bm, Cm, D, chunk, force):
        out = kernel_wrapper(x, dt, A, Bm, Cm, D, chunk=chunk, force=force)
        ex, share = ssd_excess(
            x, dt, A, Bm, Cm, D, plain=out,
            kernel=kernel_wrapper(x, dt, A, Bm, Cm, D, force="cuda"))
        layer_ex.append((ex, share))
        return out

    with ssd_as(held) as kernel_wrapper:
        model.prefill(params, {"tokens": prompts}, force="ref")
    check(len(layer_ex) == cfg.num_layers,
          f"mamba2 serve: {len(layer_ex)} ssd calls held, expected "
          f"{cfg.num_layers}")
    for i, (ex, _) in enumerate(layer_ex):
        check_excess(f"mamba2 serve layer {i}", ex)
    names = layer_ex[0][0].keys()
    log("mamba2 serve every layer's SSD on the plain path's activations, "
        f"excess over half a bf16 ulp / max|y| (limit {F32_NOISE:.3e}): "
        + "; ".join(f"{k} min {min(e[k] for e, _ in layer_ex):.3e} max "
                    f"{max(e[k] for e, _ in layer_ex):.3e}" for k in names)
        + "; ||y_inter||/||y|| min "
          f"{min(s for _, s in layer_ex):.4f} max "
          f"{max(s for _, s in layer_ex):.4f}")
    return launches, 1e3 * prefill_s


# ---------------------------------------------------------------------------
# zamba2-7b: the hybrid family's serving path (flash at D = 112, the SSD)
# ---------------------------------------------------------------------------
def counts():
    """The flash and SSD launch counts and the SSD's by route, now."""
    return (ops.flash_attention.launches, ops.ssd_scan.launches,
            dict(ops.ssd_scan.route_launches))


def zero_counts():
    ops.flash_attention.launches = 0
    ops.ssd_scan.launches = 0
    for kind in ops.ssd_scan.route_launches:
        ops.ssd_scan.route_launches[kind] = 0


def phase_hybrid_f32():
    """zamba2-7b at full width, cut to 12 layers (2 sites of the shared
    block), in f32. Every flash launch (D = 112, the wgmma-f32 route) and
    every SSD launch, on the plain path's activations, within SSD_F32_TOL
    of its plain version (a carry-dropping control must fail that for the
    SSD). At the logits, the kernel path's prefill and the decode warm-up's
    last logits over the same prompt, against the plain path: their rms
    gaps within FLOOR_FACTOR of the floor (the plain path with the SSD at
    the kernel's chunk length), the carry-dropping control outside it."""
    cfg = dataclasses.replace(ZAMBA2_7B, num_layers=HYB_F32_LAYERS)
    sites = transformer.n_attn_sites(cfg)
    B, P = HYB_F32_B, HYB_F32_PROMPT
    model = Model(cfg, param_dtype=torch.float32)
    params = ssm_params(model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                         device="cuda")
    batch = {"tokens": toks}
    f0, s0, r0 = counts()
    logits_k, _ = model.prefill(params, batch)
    torch.cuda.synchronize()
    f1, s1, r1 = counts()
    check(f1 - f0 == sites and s1 - s0 == cfg.num_layers
          and r1["wgmma-f32"] - r0["wgmma-f32"] == cfg.num_layers,
          f"zamba2 f32: {f1 - f0} flash and {s1 - s0} ssd launches ({r0} -> "
          f"{r1}) in a {cfg.num_layers}-layer prefill with {sites} sites, "
          "expected every ssd launch on the wgmma-f32 route")
    check(flash_build.route(torch.float32, cfg.resolved_head_dim)
          == "wgmma-f32", "zamba2 f32: flash does not take the wgmma-f32 "
          "route")

    flash_gaps, ssd_gaps = [], []

    def held_flash(q, k, v, force, **opts):
        out = flash_wrapper(q, k, v, force=force, **opts)
        kern = flash_wrapper(q, k, v, force="cuda", **opts)
        torch.testing.assert_close(kern, out, rtol=SSD_F32_TOL,
                                   atol=SSD_F32_TOL)
        flash_gaps.append(float((kern - out).abs().max()))
        return out

    def held_ssd(x, dt, A, Bm, Cm, D, chunk, force):
        out = ssd_wrapper(x, dt, A, Bm, Cm, D, chunk=chunk, force=force)
        kern = ssd_wrapper(x, dt, A, Bm, Cm, D, force="cuda")
        dropped = ssd_carry_dropped(x, dt, A, Bm, Cm, D)
        torch.testing.assert_close(kern, out, rtol=SSD_F32_TOL,
                                   atol=SSD_F32_TOL)
        over = (dropped - out).abs() - (SSD_F32_TOL + SSD_F32_TOL * out.abs())
        check(float(over.max()) > 0, f"zamba2 f32 layer {len(ssd_gaps)}: the "
              "carry-dropping control passes the f32 tolerance")
        ssd_gaps.append((float((kern - out).abs().max()),
                         float((dropped - out).abs().max())))
        return out

    with attention_as(held_flash) as flash_wrapper, \
            ssd_as(held_ssd) as ssd_wrapper:
        logits_r, _ = model.prefill(params, batch, force="ref")
    check(len(flash_gaps) == sites and len(ssd_gaps) == cfg.num_layers,
          f"zamba2 f32: {len(flash_gaps)} flash and {len(ssd_gaps)} ssd "
          "calls held")
    log(f"zamba2-7b f32 ({cfg.num_layers} layers, {sites} sites, full width, "
        f"B={B}, prompt {P}) every launch on the plain path's activations: "
        f"flash D={cfg.resolved_head_dim} max|kernel-plain| "
        f"{max(flash_gaps):.3e}, ssd max|kernel-plain| "
        f"{max(k for k, _ in ssd_gaps):.3e} (tol {SSD_F32_TOL}); the ssd "
        f"carry-dropping control min {min(c for _, c in ssd_gaps):.3e} off")

    with ssd_as(ssd_at_chunk(ssd_build.CHUNK)):
        logits_f, _ = model.prefill(params, batch, force="ref")
    with ssd_as(ssd_carry_dropped):
        logits_c, _ = model.prefill(params, batch, force="ref")
    warm, _ = warm_up(model, params, toks, model.cache_template(B, P))
    torch.cuda.synchronize()
    for name, x in (("kernel", logits_k), ("plain", logits_r),
                    ("warm", warm)):
        check(bool(torch.isfinite(x).all()), f"zamba2 f32: {name} non-finite")
    gaps = {"kernel path": gap_stats(logits_k, logits_r),
            "decode warm-up": gap_stats(warm, logits_r),
            "floor: plain at chunk 64": gap_stats(logits_f, logits_r),
            "control: carry dropped": gap_stats(logits_c, logits_r)}
    floor = gaps["floor: plain at chunk 64"]["rms"]
    log(f"zamba2-7b f32 prefill last-token logits against the plain path "
        f"(chunk {min(cfg.ssm_chunk, P)}), max / rms / entries over "
        f"rtol=atol={MODEL_TOL} / rms over the floor's: "
        + "; ".join(f"{k} {g['max']:.3e} / {g['rms']:.3e} / {g['over']} / "
                    f"{g['rms'] / floor:.3f}" for k, g in gaps.items())
        + f" (limit {FLOOR_FACTOR} x the floor's rms; logits max|.| "
          f"{float(logits_r.abs().max()):.2f})")
    for k, g in gaps.items():
        if k.startswith("floor"):
            continue
        if k.startswith("control"):
            check(g["rms"] > FLOOR_FACTOR * floor,
                  f"zamba2 f32: the {k} control is within {FLOOR_FACTOR} x "
                  f"the floor ({g}, floor {floor})")
        else:
            check(g["rms"] <= FLOOR_FACTOR * floor,
                  f"zamba2 f32: {k} rms gap {g['rms']} > {FLOOR_FACTOR} x "
                  f"the floor {floor}")
    log(f"zamba2-7b f32 greedy token of the prefill / warm-up: "
        f"{logits_k.argmax(-1).tolist()} / {warm.argmax(-1).tolist()}")


@contextlib.contextmanager
def timed_warm_up(marks):
    """Time the warm-up inside ``serve`` (synchronised at its start and end)
    and note the launch counts when it starts."""
    orig = serve_module.warm_up

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        marks["start"], marks["counts"] = time.perf_counter(), counts()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        marks["end"] = time.perf_counter()
        return out

    serve_module.warm_up = timed
    try:
        yield marks
    finally:
        serve_module.warm_up = orig


def phase_hybrid_serve():
    """The fourth main path: full-size bf16 zamba2-7b serving a batch. The
    prefill alone on 4 x 4096 prompt tokens (13 flash launches at D = 112
    and 81 SSD launches, all on the wgmma routes), then a whole serve call
    on 4 x 64 prompt tokens fed through decode and 32 generated (the same
    launches in its prefill, none in the warm-up or decode)."""
    cfg = ZAMBA2_7B
    sites = transformer.n_attn_sites(cfg)
    model = Model(cfg)  # bf16 weights on the card
    t0 = time.perf_counter()
    params = ssm_params(model, SEED)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    log(f"zamba2 serve: {model.param_count()} parameters "
        f"({weight_bytes / 1e9:.3f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; {cfg.num_layers} layers, "
        f"{sites} sites of the shared block")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    prompts = torch.randint(0, cfg.vocab_size, (HYB_B, HYB_PROMPT),
                            generator=gen, device="cuda")
    serve(model, params, prompts[:, :HYB_SERVE_PROMPT], 1)  # handles, library
    d_route = flash_build.route(torch.bfloat16, cfg.resolved_head_dim)
    check(d_route == "wgmma", f"zamba2 serve: flash route {d_route}")

    # time to the first token: the prefill alone on 4 x 4096
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the prefill's path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, logits = serve(model, params, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_flash, pre_ssd, pre_routes = counts()  # ... and ends here
    pre_peak = torch.cuda.max_memory_allocated()
    check(pre_flash == sites and pre_ssd == cfg.num_layers
          and pre_routes["wgmma"] == cfg.num_layers,
          f"zamba2 serve prefill: {pre_flash} flash and {pre_ssd} ssd "
          f"launches ({pre_routes}), expected {sites} and {cfg.num_layers} "
          "on the wgmma route")
    check(tuple(logits.shape) == (HYB_B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "zamba2 serve: prefill logits not finite or of the wrong shape")

    # the main path: a whole serve call, its warm-up timed inside
    short = prompts[:, :HYB_SERVE_PROMPT]
    del logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the main path starts here
    torch.cuda.synchronize()
    with timed_warm_up({}) as marks:
        t0 = time.perf_counter()
        tokens, first_logits = serve(model, params, short, HYB_GEN)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    flash_n, ssd_n, routes = counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    check("counts" in marks, "zamba2 serve: no warm-up ran")
    in_prefill = marks["counts"][:2]
    check(in_prefill == (sites, cfg.num_layers)
          and routes["wgmma"] == cfg.num_layers,
          f"zamba2 serve: {in_prefill} flash and ssd launches in its "
          f"prefill ({routes}), expected {(sites, cfg.num_layers)} on the "
          "wgmma route")
    check((flash_n, ssd_n) == in_prefill,
          f"zamba2 serve: {flash_n - in_prefill[0]} flash and "
          f"{ssd_n - in_prefill[1]} ssd launches in the warm-up and decode")
    check(tuple(tokens.shape) == (HYB_B, HYB_GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"zamba2 serve: tokens {tuple(tokens.shape)} or out of the "
          "vocabulary")
    check(bool(torch.isfinite(first_logits).all()),
          "zamba2 serve: prefill logits not finite")
    steps = HYB_GEN - 1
    P = HYB_SERVE_PROMPT
    pre_short_s = marks["start"] - t0
    warm_s = marks["end"] - marks["start"]
    decode_s = total_s - (marks["end"] - t0)
    log(f"zamba2 serve {HYB_B} x {HYB_PROMPT} prompt tokens, prefill alone "
        f"(time to the first token): {1e3 * prefill_s:.3f} ms "
        f"({HYB_B * HYB_PROMPT / prefill_s:.1f} prompt tok/s); peak device "
        f"memory {pre_peak / 1e9:.3f} GB")
    log(f"zamba2 serve {HYB_B} x {P} prompt tokens, {HYB_GEN} generated "
        f"each: prefill {1e3 * pre_short_s:.3f} ms, decode warm-up over the "
        f"prompt {1e3 * warm_s:.3f} ms ({1e3 * warm_s / P:.3f} ms a "
        f"position), decode {1e3 * decode_s / steps:.3f} ms/token over "
        f"{steps} steps; serve end to end {1e3 * total_s:.3f} ms; peak "
        f"device memory {peak / 1e9:.3f} GB; weights "
        f"{weight_bytes / 1e9:.3f} GB")
    log(f"zamba2 serve launches: flash {in_prefill[0]} (D="
        f"{cfg.resolved_head_dim}, {d_route} route) and ssd {in_prefill[1]} "
        f"({routes}) in the prefill, {flash_n - in_prefill[0]} and "
        f"{ssd_n - in_prefill[1]} in the warm-up and decode")
    log(f"zamba2 serve sample tokens: {tokens[0, :16].tolist()}")
    return dict(flash=flash_n, ssd=ssd_n, prefill_ms=1e3 * prefill_s)


# ---------------------------------------------------------------------------
# Training: the SSD scan's backward kernel, then mamba2-130m trained
# on the card through make_train_step, the SODDA-SVRG loop and the CLI
# ---------------------------------------------------------------------------
# (label, (B, S, H, P, G, N), dtypes): mamba2-130m's training layer (8 x 2048
# tokens a step) and zamba2-7b's (2 x 4096)
SSD_BWD_CASES = (("mamba2 training layer", (8, 2048, 24, 64, 1, 128),
                  (torch.float32, torch.bfloat16)),
                 ("zamba2 layer", (2, 4096, 112, 64, 1, 64),
                  (torch.float32,)),
                 ("unaligned", (4, 1000, 8, 16, 2, 16),
                  (torch.float32, torch.bfloat16)),
                 ("unaligned, 3 heads a group", (1, 333, 6, 32, 2, 32),
                  (torch.float32, torch.bfloat16)),
                 # a rank's heads in phase_mesh_lm's SSM cells on (2, 2)
                 ("mamba2 mesh rank layer", (1, 2048, 12, 64, 1, 128),
                  (torch.float32,)),
                 ("zamba2 mesh rank layer", (1, 2048, 56, 64, 1, 64),
                  (torch.float32,)))
# the (H, G) of the sweep over every (P, N) the kernel is built for, at a
# ragged S: an odd number of heads a group (the last pair of heads leaves
# one consumer warpgroup idle) and one head a group (H == G)
SSD_BWD_SWEEP_S, SSD_BWD_SWEEP_HG = 200, ((6, 2), (6, 6))
# the cases timed beside their bounds (the unaligned one is not a layer)
SSD_BWD_TIMED = ("mamba2 training layer", "zamba2 layer")
# the kernel's earlier CUDA-core design at mamba2's training layer, f32
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the time the tensor-core
# kernel replaces
SSD_BWD_CUDA_CORE_MS = 3.5675
SSD_BWD_LEAVES = ("dx", "ddt", "dA", "dBm", "dCm", "dD")
# f32: each gradient leaf within SSD_BWD_F32_TOL x its largest entry of the
# plain gradient (autograd through the chunked scan in f32, at the
# kernel's chunk of 64). The kernel sums the same terms in another order:
# 64-term products inside a chunk, 32-64 chunks of carried state, and per
# head partials of dB and dC summed over 24-112 heads; f32 sums of that
# length move the last few bits, ~1e-6 of the largest entry, and 1e-5
# leaves a margin of ~10. bf16: the rounding rule of the forward
# (F32_NOISE), the dA and dD leaves (f32) at SSD_BWD_F32_TOL. The control
# (each 64-step chunk differentiated alone: no state, so no dstate,
# carried across a boundary) must fail it on every leaf but dD, which
# is sum dy * x and does not see the state.
SSD_BWD_F32_TOL = 1e-5
SSD_BWD_CARRY_LEAVES = ("dx", "ddt", "dA", "dBm", "dCm")
# The split control: the kernel's decomposition with every operand of its
# tensor-core products rounded once to bf16 (``ref.ssd_bwd_decomposed``
# with one piece each, computed on the card in f32), where the kernel
# takes three pieces of an f32 operand. It must fail the rule on every
# leaf a product feeds (all but dD; tests/test_torch_ssd_bwd_split.py
# shows it on the CPU).
SSD_BWD_SPLIT_LEAVES = SSD_BWD_CARRY_LEAVES
# phase_train: (a) the exactness cell, 4 layers at full width, f32; (b)-(d)
# full-size mamba2-130m, f32 as the reference's CLI trains it, 8 x 2048
# tokens a step from TokenPipeline(seed=0), the CLI's init (model.init(0))
TRAIN_CUT_LAYERS, TRAIN_CUT_B, TRAIN_CUT_S = 4, 2, 1024
# (b)-(d) run TRAIN_STEPS steps (~0.54 s a step in (b), ~0.65 s in (c) on
# an H100 80GB HBM3 at 700 W; in (b) the loss fell 154.5 -> 145.0 over 6
# steps, -> 78.2 over 20)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 2048, 6, 3e-4
# (d): the CLI checkpoints every TRAIN_CKPT_EVERY steps and is killed
# (SIGKILL) once it logs step TRAIN_KILL_AT, three steps past a checkpoint
TRAIN_CKPT_EVERY, TRAIN_KILL_AT = 3, 5
# SODDA-SVRG's step is a plain gradient step on the variance-reduced
# gradient: the CLI's 3e-4 moves this loss too little in 20 steps to see
# (on the CPU at full width, 2 layers, 2 x 256 tokens: 1e-2 falls, 1e-3
# barely), so the phase takes 1e-2.
SODDA_LR = 1e-2
# (c) runs on mamba2-130m cut to 12 of its 24 layers, so that the run, with
# the mesh phase, stays under 1200 s on a slower host
SODDA_LAYERS = 12
# (e), (f): gemma2-9b and zamba2-7b at full width and cut depth, f32,
# ATTN_TRAIN_STEPS adamw steps at TRAIN_LR of B x ATTN_TRAIN_S tokens from
# TokenPipeline(seed=0), and a step over 2 x ATTN_TRAIN_S by accum_steps=2;
# the exactness cells at 1 x ATTN_TRAIN_S. At 9B width neither fits one
# card at full depth with adamw's state in f32. B = 1: on an H100 (80 GB) a
# 2 x 4608 step ran gemma2 out of memory (its f32 logits over a 256 000
# vocabulary) and took zamba2 to 72.964 GB, past the cell's 72 GB limit.
# gemma2 at 2 layers, one local and one global (cut from 4 so that the run,
# with the mesh phase, stays under 1200 s on a slower host)
GEMMA2_TRAIN_LAYERS, GEMMA2_TRAIN_B = 2, 1
ZAMBA2_TRAIN_LAYERS, ZAMBA2_TRAIN_B = 12, 1
# zamba2's exactness cell on 2048 tokens: at 4608 the plain path (the
# chunked SSD and attention, differentiated by autograd) ran the card out
# of memory
ZAMBA2_EXACT_S = 2048
ATTN_TRAIN_STEPS = 5
QK_GAIN = 4.0  # the exactness cells' wq and wk over the template's
# (g): the rest of the dense stack, f32 at the reference CLI's settings
# (f32 params, src/repro/launch/train.py:200; adamw at TRAIN_LR), cut to
# DENSE_TRAIN_LAYERS at full width (2: at 4 layers the five cells took
# 115.3 s, past what the run's time allows), 1 x DENSE_TRAIN_POS positions
# a step (train_4k's sequence, src/repro/configs/base.py:34; internvl2-26b
# 256 frontend embeddings + 3840 text tokens), DENSE_TRAIN_STEPS steps
# twice (5, as (e) and (f): in 3 adamw steps at 3e-4 minitron-8b's loss
# went 12.9359 -> 13.5513 -> 13.1044, the first sign-like step
# overshooting), the exactness cell at 1 x DENSE_EXACT_POS. The
# accum_steps=2 step runs where its two gradient trees fit beside adamw's:
# minitron-8b's 2 layers hold 10.3 GB of f32 weights (8.4 GB of them its
# two 256 000-row embeddings), so weights, moments and two gradient trees
# take 51.6 GB before its logits' 4.2 GB tensors (its 4-layer step alone
# peaked at 64.7 GB).
DENSE_TRAIN = (PHI3_MINI, MINITRON_8B, CHATGLM3_6B, MUSICGEN_LARGE,
               INTERNVL2_26B)
DENSE_TRAIN_LAYERS, DENSE_TRAIN_STEPS = 2, 5
DENSE_TRAIN_POS, DENSE_EXACT_POS = 4096, 2048
DENSE_TRAIN_NO_ACCUM = ("minitron-8b",)
# (h): the MoE family in bf16 at the reference's production settings
# (src/repro/launch/dryrun.py:54-57: adafactor, grad_dtype bfloat16,
# remat "full"; bf16 params, the reference Model's default) at lr
# TRAIN_LR, full width, 1 layer: arctic-480b with all 128 experts, the
# dense residual and its 56 q heads padded to 64; kimi-k2 with 192 of its
# 384 experts (all 384 take 38.8 GB of bf16 weights and as much again in
# gradients). MOE_TRAIN_B x MOE_TRAIN_S tokens a step, accum_steps 1 (the
# reference's 8 / 16 are a pod's; (i) accumulates).
MOE_TRAIN = ((ARCTIC_480B, 128), (KIMI_K2, 192))
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 2, 4096, 3
# (i): MoE exactness, f32, 1 layer at full width on 1 x MOE_EXACT_S tokens:
# arctic with 16 of its 128 experts (9.5 GB of weights), kimi with 32 of
# 384 (15.5 GB); the cell holds two gradient trees at once
MOE_EXACT = ((ARCTIC_480B, 16), (KIMI_K2, 32))
MOE_EXACT_S = 2048
# every training cell's peak device memory stays under this (of 80 GB)
TRAIN_PEAK_LIMIT = 72e9


def ssd_bwd_bound_ms(B, S, H, P, G, N, dtype, chunk=64):
    """Least time for one backward call: x, dt, B, C, dy read once and dx,
    ddt, dB, dC written once (A, D, dA, dD in f32) over the HBM rate, vs
    its chunked work over the dtype's peak (the CUDA cores' f32 rate for
    f32; bf16 inputs are computed in f32 but bounded at the bf16 tensor
    rate, as the forward's are): per chunk of q steps C.B^T once per group
    over j <= i (q(q+1)/2 N), and per head dy.x^T and W^T.dy (q(q+1)/2 P
    each), dG.B and dG^T.C (q(q+1)/2 N each), the three state terms
    dS.B, dy.S0 and x.dS and the two carries, state and dS (5 q N P),
    2 FLOP each. The chunk is fixed at 64, as ``ssd_bound_ms``'s."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * G * N) \
        + 4 * 4 * H
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        tri = q * (q + 1) // 2
        flops += 2 * (B * G * tri * N
                      + B * H * (tri * (2 * P + 2 * N) + 5 * q * N * P))
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_bwd_tc_bound_ms(B, S, H, P, G, N, dtype, chunk=64):
    """The same least time for the tensor-core route: the bytes of
    ``ssd_bwd_bound_ms`` against the chunked work as its bf16 tensor-core
    products take it (989 TFLOP/s): each product of two f32 operands as
    six piece products, a bf16 input's with an f32 operand as three and
    two bf16 inputs' (C.B^T, dy.x^T) as one (``ref.ssd_bwd_decomposed``:
    f32 inputs take three pieces, bf16 one, f32 intermediates three)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * G * N) \
        + 4 * 4 * H
    k_in = ssd_build.bwd_in_pieces(dtype)
    pairs = [(a, b) for a in range(3) for b in range(3) if a + b <= 2]
    in_in = sum(1 for a, b in pairs if a < k_in and b < k_in)
    in_mid = sum(1 for a, b in pairs if a < k_in)
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        tri = q * (q + 1) // 2
        flops += 2 * (in_in * (B * G * tri * N + B * H * tri * P)
                      + in_mid * B * H * (tri * (P + 2 * N)
                                          + 5 * q * N * P))
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_grads_alone(x, dt, A, Bm, Cm, D, dy, chunk=64):
    """The control: the plain gradient (f32) with each chunk differentiated
    alone, so no state and no dstate cross a chunk boundary. A ragged S is
    padded with zero steps (dt = 0, x = dy = 0: they add to no gradient)."""
    B, S = x.shape[:2]
    pad = -S % chunk

    def cut(t):
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(B * (S + pad) // chunk, chunk, *t.shape[2:])

    grads = kref.ssd_chunked_grads(cut(x), cut(dt), A, cut(Bm), cut(Cm), D,
                                   cut(dy), chunk=chunk)
    return [g.reshape(B, S + pad, *g.shape[2:])[:, :S] if g.dim() > 1 else g
            for g in grads]


def leaf_paths(tree, prefix=()):
    """The key path of every leaf of a nested dict, in sorted key order
    (``tree_leaves``'s)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                             prefix + (k,))]
    return [prefix]


def rel_gap(a, b):
    """max |a - b| over max |b|, in f32."""
    return float((a.float() - b).abs().max() / b.abs().max())


def phase_ssd_backward():
    """The SSD scan's backward kernel against its plain gradient at
    mamba2's training layer (f32 and bf16), zamba2's (f32) and two
    unaligned cases (P 16, N 16, G 2 and P 32, N 32, 3 heads a group,
    ragged S; both dtypes), then over every (P, N) it is built for, its
    carry-dropping control and its split control (every product operand
    rounded once to bf16) outside the rule, bitwise across two launches,
    and its time beside the earlier CUDA-core design's, its two bounds and
    the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    f32, bf16 = torch.float32, torch.bfloat16
    max_err, times = 0.0, {}
    for name, shape, dtypes in SSD_BWD_CASES:
        x, dt, A, Bm, Cm, D = ssd_inputs(*shape, "mamba2", gen)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        for dtype in dtypes:
            args = [t.to(dtype) for t in (x, dt)] + [A] \
                + [t.to(dtype) for t in (Bm, Cm)] + [D, dy.to(dtype)]
            # the oracle and the controls on f32 copies of the inputs as
            # the kernel reads them
            f = [t.float() for t in args]
            want = kref.ssd_chunked_grads(*f, chunk=ssd_build.CHUNK)
            alone = ssd_grads_alone(*f)
            single = kref.ssd_bwd_decomposed(*f, in_pieces=1, mid_pieces=1)
            tag = f"ssd backward {name} {shape} {dtype}"
            before = ops.ssd_scan_bwd.launches
            a = ops.ssd_scan_bwd(*args, force="cuda")
            b = ops.ssd_scan_bwd(*args, force="cuda")
            torch.cuda.synchronize()
            check(ops.ssd_scan_bwd.launches == before + 2,
                  f"{tag}: {ops.ssd_scan_bwd.launches - before} launches")
            check(all(torch.equal(p, q) for p, q in zip(a, b)),
                  f"{tag}: two launches differ")
            check(all(bool(torch.isfinite(g).all()) for g in a),
                  f"{tag}: non-finite gradients")
            check([g.dtype for g in a] == [dtype, dtype, f32, dtype, dtype,
                                           f32], f"{tag}: dtypes "
                  f"{[g.dtype for g in a]}")
            parts = []
            for leaf, g, w, c, sp in zip(SSD_BWD_LEAVES, a, want, alone,
                                         single):
                err = rel_gap(g, w)
                if dtype == f32:  # bf16's absolute gaps are its rounding
                    max_err = max(max_err, float((g - w).abs().max()))
                if g.dtype == f32:
                    ctrl, split = rel_gap(c, w), rel_gap(sp, w)
                    check(err <= SSD_BWD_F32_TOL,
                          f"{tag}: {leaf} {err:.3e} of its max off the "
                          f"plain gradient (tol {SSD_BWD_F32_TOL})")
                    limit = SSD_BWD_F32_TOL
                else:
                    ex = tol.half_ulp_excess(w, float(w.abs().max()),
                                             kernel=g,
                                             control=c.to(dtype),
                                             split=sp.to(dtype))
                    err, ctrl, split = ex["kernel"], ex["control"], \
                        ex["split"]
                    check(err <= F32_NOISE, f"{tag}: {leaf} beyond half a "
                          f"bf16 ulp by {err:.3e} of its max (limit "
                          f"{F32_NOISE:.3e})")
                    limit = F32_NOISE
                if leaf in SSD_BWD_CARRY_LEAVES:
                    check(ctrl > limit, f"{tag}: {leaf}: the carry-dropping "
                          f"control passes ({ctrl:.3e} <= {limit:.3e})")
                if leaf in SSD_BWD_SPLIT_LEAVES:
                    check(split > limit, f"{tag}: {leaf}: the single-"
                          f"rounding split control passes ({split:.3e} <= "
                          f"{limit:.3e})")
                parts.append(f"{leaf} {err:.3e} (carry control {ctrl:.3e},"
                             f" split control {split:.3e})")
            rule = (f"of each leaf's max (limit {SSD_BWD_F32_TOL:.3e})"
                    if dtype == f32 else
                    f"excess over half a bf16 ulp / max (limit "
                    f"{F32_NOISE:.3e}), dA and dD of their max (limit "
                    f"{SSD_BWD_F32_TOL:.3e})")
            log(f"{tag}: bitwise across launches; kernel vs plain {rule}: "
                + ", ".join(parts))
            del want, alone, single, a, b, f
        if name in SSD_BWD_TIMED:
            for dtype in dtypes:
                args = [t.to(dtype) for t in (x, dt)] + [A] \
                    + [t.to(dtype) for t in (Bm, Cm)] + [D, dy.to(dtype)]
                ms = cuda_ms(lambda: ops.ssd_scan_bwd(*args, force="cuda"),
                             reps=10, warmup=2)
                plain_ms = cuda_ms(lambda: ops.ssd_scan_bwd(*args,
                                                            force="ref"),
                                   reps=2, warmup=1)
                plain = ssd_bwd_bound_ms(*shape, dtype)
                tc = ssd_bwd_tc_bound_ms(*shape, dtype)
                times[name, dtype] = dict(ms=ms, plain_ms=plain_ms,
                                          **bound_keys(dtype, plain, tc),
                                          library_ms=None)
                log(f"ssd backward {name} {shape} {dtype}: kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms; the function's work at "
                    f"the dtype's peak (the CUDA cores' f32 rate for f32) "
                    f"{plain[0]:.5f} ms ({plain[1]}), kernel/that "
                    f"{ms / plain[0]:.2f}x; the tensor-core route's split "
                    f"products at 989 TFLOP/s {tc[0]:.5f} ms ({tc[1]}), "
                    f"kernel/that {ms / tc[0]:.2f}x; bound_ms the least")
        del x, dt, A, Bm, Cm, D, dy, args
        torch.cuda.empty_cache()
    worst = {(f32, f32): (0.0,), (bf16, bf16): (0.0,), (bf16, f32): (0.0,)}
    for P in ssd_build.HEAD_DIMS:
        for N in ssd_build.STATE_DIMS:
            for H, G in SSD_BWD_SWEEP_HG:
                shape = (1, SSD_BWD_SWEEP_S, H, P, G, N)
                x, dt, A, Bm, Cm, D = ssd_inputs(*shape, "mamba2", gen)
                dy = torch.randn(x.shape, generator=gen, device="cuda")
                for dtype in (f32, bf16):
                    args = [t.to(dtype) for t in (x, dt)] + [A] \
                        + [t.to(dtype) for t in (Bm, Cm)] + [D, dy.to(dtype)]
                    # in f64: at a few heads the f32 plain dA is itself
                    # up to ~5e-6 of its max off
                    want = kref.ssd_chunked_grads(
                        *[t.double() for t in args], chunk=ssd_build.CHUNK)
                    a = ops.ssd_scan_bwd(*args, force="cuda")
                    b = ops.ssd_scan_bwd(*args, force="cuda")
                    tag = f"ssd backward sweep {shape} {dtype}"
                    check(all(torch.equal(p, q) for p, q in zip(a, b)),
                          f"{tag}: two launches differ")
                    for leaf, g, w in zip(SSD_BWD_LEAVES, a, want):
                        check(bool(torch.isfinite(g).all()),
                              f"{tag}: {leaf} not finite")
                        if g.dtype == f32:
                            err, limit = rel_gap(g, w), SSD_BWD_F32_TOL
                        else:
                            err = tol.half_ulp_excess(
                                w, float(w.abs().max()), kernel=g)["kernel"]
                            limit = F32_NOISE
                        check(err <= limit, f"{tag}: {leaf} {err:.3e} "
                              f"(limit {limit:.3e})")
                        worst[dtype, g.dtype] = max(
                            worst[dtype, g.dtype], (err, leaf, shape))
    log(f"ssd backward sweep over every (P, N) in {ssd_build.HEAD_DIMS} x "
        f"{ssd_build.STATE_DIMS} at S {SSD_BWD_SWEEP_S}, (H, G) in "
        f"{SSD_BWD_SWEEP_HG}, against the plain gradient in f64: bitwise "
        f"across launches; worst (gap, leaf, shape): f32 {worst[f32, f32]} "
        f"of its max (limit {SSD_BWD_F32_TOL:.3e}); bf16 inputs "
        f"{worst[bf16, bf16]} excess over half a bf16 ulp / max (limit "
        f"{F32_NOISE:.3e}), their f32 dA, dD {worst[bf16, f32]} of the "
        f"max (limit {SSD_BWD_F32_TOL:.3e})")
    top = times["mamba2 training layer", f32]
    ms = top["ms"]
    log(f"ssd backward at mamba2's training layer, f32: {ms:.4f} ms against "
        f"the earlier CUDA-core design's {SSD_BWD_CUDA_CORE_MS} ms "
        f"({SSD_BWD_CUDA_CORE_MS / ms:.2f}x), the bound (the tensor-core "
        f"route's) {top['bound_ms']:.5f} ms ({ms / top['bound_ms']:.2f}x) "
        f"and the CUDA cores' {top['cuda_core_bound_ms']:.5f} ms "
        f"({ms / top['cuda_core_bound_ms']:.2f}x)")
    shapes = {f"{name} {str(dtype).replace('torch.', '')}": rec
              for (name, dtype), rec in times.items()
              if (name, dtype) != ("mamba2 training layer", f32)}
    return dict(name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                replaces="none: port only; the reference differentiates its "
                         "plain jnp scan, src/repro/models/ssm.py:49",
                launches=None, max_abs_err=max_err, **top,
                shape=list(SSD_BWD_CASES[0][1]), shapes=shapes)


# ---------------------------------------------------------------------------
# flash attention's backward, and dense and hybrid training
# ---------------------------------------------------------------------------
ATTN_TRAIN_S = 4608  # the training cells' sequence: > 4096, so gemma2's
# local layers' window masks
# (label, (B, H, KV, Sq, Sk, D), options): gemma2-9b's two training layers
# and zamba2-7b's (its shared block; training gives it no window: the
# reference's long_context is a serving flag) at phase_train's 1 x 4608
# tokens a step, the same zamba2 layer under its long-context window, a
# phi3-mini layer (head dim 96), the other head dims, a decode-style offset
# over an unaligned key range, and rows that see no key (lse -inf); each
# in f32 and bf16
FLASH_BWD_CASES = (
    ("gemma2 local training layer", (1, 16, 8, 4608, 4608, 256),
     dict(window=4096, softcap=50.0)),
    ("gemma2 global training layer", (1, 16, 8, 4608, 4608, 256),
     dict(softcap=50.0)),
    ("zamba2 training layer", (1, 32, 32, 4608, 4608, 112), dict()),
    ("zamba2 long-context window", (1, 32, 32, 4608, 4608, 112),
     dict(window=4096)),
    # a rank's 16 of zamba2-7b's 32 heads in phase_mesh_lm's SSM cell
    ("zamba2 mesh rank layer", (1, 16, 16, 2048, 2048, 112), dict()),
    ("phi3-mini layer", (1, 32, 32, 4096, 4096, 96), dict()),
    # the training layers of phase_train_dense_stack at its 1 x 4096
    # tokens a step and of phase_train_moe at its MOE_TRAIN_B x 4096: GQA
    # groups 4, 6, 8, 16 and 1 at D = 64 (the MoE layer is arctic-480b's
    # 56 q heads padded to 64, and kimi-k2's 64)
    ("minitron-8b training layer", (1, 32, 8, 4096, 4096, 128), dict()),
    ("internvl2-26b training layer", (1, 48, 8, 4096, 4096, 128), dict()),
    ("MoE training layer", (MOE_TRAIN_B, 64, 8, MOE_TRAIN_S, MOE_TRAIN_S,
                            128), dict()),
    ("chatglm3-6b training layer", (1, 32, 2, 4096, 4096, 128), dict()),
    ("musicgen-large training layer", (1, 32, 32, 4096, 4096, 64), dict()),
    ("D=16 window+softcap", (2, 8, 4, 1000, 1000, 16),
     dict(window=300, softcap=30.0)),
    ("D=64 non-causal", (2, 8, 2, 1000, 1000, 64), dict(causal=False)),
    ("D=128 window+softcap", (2, 8, 4, 1000, 1000, 128),
     dict(window=300, softcap=30.0)),
    ("unaligned decode offset", (2, 4, 2, 200, 333, 64),
     dict(window=64, softcap=30.0, q_offset=133)),
    ("rows that see no key", (1, 4, 2, 70, 100, 64),
     dict(window=40, q_offset=120)),
)
# (case, dtype) timed beside the bound, the plain version and SDPA's
# backward (f32 ones also time the f32 forward with its lse)
FLASH_BWD_TIMED = tuple(
    (name, dtype) for name in ("gemma2 local training layer",
                               "gemma2 global training layer",
                               "zamba2 training layer")
    for dtype in (torch.float32, torch.bfloat16)) + (
    ("MoE training layer", torch.bfloat16),
    ("chatglm3-6b training layer", torch.float32))
# f32: each of dq, dk, dv within FLASH_BWD_F32_TOL x its largest entry of
# the plain backward (ref.attention_grads on the same q, k, v, out, lse and
# dout), which sums the same terms in another order (4608 keys a row, up to
# 4608 queries a key, 2 heads a group); bf16: the rounding rule of the
# forward (F32_NOISE) against the plain backward on f32 copies. Controls:
# dS rounded once to bf16 before the dQ and dK products (as a textbook
# tensor-core kernel takes it) must fail either rule on dq and dk; in f32,
# every tensor-core operand rounded once to bf16 (the split control,
# ``ref.attention_grads(in_pieces=1, mid_pieces=1)``) must fail the f32 rule
# on every leaf; in bf16, P rounded once to bf16 before dV must fail the
# rounding rule on dv.
FLASH_BWD_F32_TOL = 1e-5
FLASH_BWD_LEAVES = ("dq", "dk", "dv")
FLASH_BWD_CONTROL_LEAVES = ("dq", "dk")
FLASH_BWD_P_CONTROL_LEAVES = ("dv",)


def kernel_registers(lib):
    """{instantiation: registers} from a library's ptxas report, names as
    ``flash_bwd_dkdv<float, 256>`` or ``flash_fwd_f32<256>``."""
    regs, current = {}, None
    for line in lib.with_name(lib.name + ".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            k = re.search(r"(flash_(?:bwd_\w+?|fwd_f32))I"
                          r"(f|13__nv_bfloat16)?(?:Li(\d+))?E", current)
            args = ([] if not k or not k.group(2) else
                    ["float" if k.group(2) == "f" else "bf16"]) \
                + ([k.group(3)] if k and k.group(3) else [])
            name = f"{k.group(1)}<{', '.join(args)}>" if k else current
            regs[name] = int(m.group(1))
    return regs


def mask_opts(opts):
    """The mask's part of a flash case's options (``attention_pairs``)."""
    return {k: v for k, v in opts.items()
            if k in ("causal", "window", "q_offset")}


def sdpa_bwd_ms(q, k, v, dout, reps):
    """Device ms of the backward of one torch
    ``scaled_dot_product_attention`` call (causal, no softcap, k and v
    expanded to every query head) on these inputs: a yardstick only."""
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for t in (k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    grad = dout.transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), grad,
                                             retain_graph=True),
                 reps=reps, warmup=1)
    del out, qt, kt, vt, grad
    return ms


def flash_f32_training_forward(name, shape, opts, q, k, v):
    """The forward route training launches, f32 with lse (wgmma-f32), at
    one training layer: its time beside both bounds; where the layer has
    no window, also the kernel and torch ``scaled_dot_product_attention``
    in f32 (k and v expanded to every query head) on the softcap-free
    function (a yardstick only)."""
    B, H, KV, Sq, Sk, D = shape
    mask = mask_opts(opts)
    ms = cuda_ms(lambda: flash_build.flash_attention_cuda(
        q, k, v, return_lse=True, **opts), reps=3, warmup=1)
    rec = dict(shape=list(shape), options=opts,
               route=flash_build.route(q.dtype, D), ms=ms,
               **bound_keys(q.dtype,
                            flash_bound_ms(*shape, q.dtype, **mask),
                            flash_bound_ms(*shape, q.dtype, split=True,
                                           **mask)),
               library_ms=None)
    if opts.get("window", 0) == 0:
        nocap = dict(opts, softcap=0.0)
        rec["same_function_ms"] = cuda_ms(
            lambda: flash_build.flash_attention_cuda(q, k, v,
                                                     return_lse=True,
                                                     **nocap),
            reps=3, warmup=1)
        group = H // KV
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), reps=3, warmup=1)
        del qt, kt, vt
    log(f"flash forward {name} {shape} f32 with lse ({rec['route']} "
        f"route): {ms:.4f} ms, tensor-core bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}), CUDA-core bound "
        f"{rec['cuda_core_bound_ms']:.5f} ms, kernel/bound "
        f"{ms / rec['bound_ms']:.1f}x"
        + (f"; causal without softcap: kernel {rec['same_function_ms']:.4f} "
           f"ms, torch scaled_dot_product_attention in f32 (k, v expanded) "
           f"{rec['library_ms']:.4f} ms" if rec["library_ms"] is not None
           else ""))
    return rec


def phase_flash_backward():
    """The flash-attention backward kernel against its plain version
    (``ref.attention_grads``) on every FLASH_BWD_CASES case in f32 and
    bf16, its out and lse from the card's forward kernel (whose out must
    be bitwise the forward's without lse, in f32 within FLASH_F32_TOL of
    the plain version's, the split control outside, and in bf16 within
    the rounding rule, both controls outside, where every row sees a
    key): f32 within
    FLASH_BWD_F32_TOL of each gradient's max, bf16 the rounding rule, the
    dS-in-bf16 control failing both on dq and dk; two launches bitwise;
    its time beside its bound, the plain version's and SDPA's backward at
    the training layers; the f32 forward with its lse at the three
    training layers (``flash_f32_training_forward``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    f32, bf16 = torch.float32, torch.bfloat16
    lib = kbuild.library_path(flash_build.BWD_SOURCE)
    for line in kbuild.compiler_report(lib):
        log(f"flash backward nvcc {lib.name}: {line}")
    registers = kernel_registers(lib)
    log(f"flash backward registers by instantiation: {registers}")
    check(len([n for n in registers if "dkdv" in n or "_dq" in n]) == 16,
          f"flash backward: {len(registers)} instantiations in the report")
    max_err, times, fwd_times = 0.0, {}, {}
    for name, shape, opts in FLASH_BWD_CASES:
        B, H, KV, Sq, Sk, D = shape
        q32, k32, v32 = flash_inputs(B, H, KV, Sq, Sk, D, f32, gen)
        dout32 = torch.randn(q32.shape, generator=gen, device="cuda")
        for dtype in (f32, bf16):
            q, k, v, dout = (t.to(dtype) for t in (q32, k32, v32, dout32))
            tag = f"flash backward {name} {shape} {dtype} {opts}"
            out, lse = flash_build.flash_attention_cuda(q, k, v,
                                                        return_lse=True,
                                                        **opts)
            plain_out = flash_build.flash_attention_cuda(q, k, v, **opts)
            f = [t.float() for t in (q, k, v, out)]
            want_out, want_lse = kref.attention_ref(*f[:3], return_lse=True,
                                                    **opts)
            torch.cuda.synchronize()
            check(torch.equal(out, plain_out), f"{tag}: the forward's output "
                  "with lse differs from its output without")
            fwd_rule = ""
            if dtype == f32:
                # the f32 forward at this layer's shape: within
                # FLASH_F32_TOL of the plain version, the split control not
                fwd_ctrl = kref.attention_ref(*f[:3], **opts,
                                              **F32_SPLIT_CONTROL)
                fwd_rule = "; out against plain " + check_f32_tol(
                    f"{tag}: forward", out, want_out, fwd_ctrl)
                del fwd_ctrl
            del want_out
            dead = torch.isinf(want_lse)
            if dtype == bf16 and not bool(dead.any()):
                # the bf16 forward at this layer's shape: the rounding rule
                # against the plain version on f32 copies, the bf16-score
                # and P-in-bf16 controls outside it (a row that sees no key
                # has no softmax to round)
                ex = bf16_excess(q, k, v, opts, kernel=out,
                                 control=attention_bf16_scores(q, k, v,
                                                               **opts))
                check_excess(f"{tag}: forward", ex)
                fwd_rule = (f"; out against plain: excess over half a bf16 "
                            f"ulp / max|v| {ex['kernel']:.3e} (bf16-score "
                            f"control {ex['control']:.3e}, P-in-bf16 control "
                            f"{ex['control_p_bf16']:.3e}; limit "
                            f"{F32_NOISE:.3e})")
            check(torch.equal(torch.isinf(lse), dead)
                  and bool((lse[dead] < 0).all()),
                  f"{tag}: lse is -inf on other rows than the plain one's")
            lse_gap = float((lse[~dead] - want_lse[~dead]).abs().max()) \
                if bool((~dead).any()) else 0.0
            check(lse_gap <= 1e-5, f"{tag}: lse {lse_gap:.3e} off the plain "
                  "version's (limit 1e-5)")
            before = ops.flash_attention_bwd.launches
            a = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                        force="cuda", **opts)
            b = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                        force="cuda", **opts)
            want = kref.attention_grads(*f, lse, dout.float(), **opts)
            ctrl = kref.attention_grads(*f, lse, dout.float(), ds_split=1,
                                        **opts)
            # f32: every tensor-core operand rounded once to bf16; bf16: P
            # rounded once before dV
            ctrl2 = kref.attention_grads(
                *f, lse, dout.float(), **opts,
                **(dict(in_pieces=1, mid_pieces=1) if dtype == f32
                   else dict(p_split=1)))
            torch.cuda.synchronize()
            check(ops.flash_attention_bwd.launches == before + 2,
                  f"{tag}: {ops.flash_attention_bwd.launches - before} "
                  "launches")
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{tag}: two launches differ")
            check([g.dtype for g in a] == [dtype] * 3,
                  f"{tag}: dtypes {[g.dtype for g in a]}")
            check(all(bool(torch.isfinite(g).all()) for g in a),
                  f"{tag}: non-finite gradients")
            if bool(dead.any()):
                rows = dead[0, 0]  # the same rows in every head
                check(bool((a[0][:, rows] == 0).all()),
                      f"{tag}: a row that sees no key has a nonzero dq")
            parts = []
            c2_name = "split" if dtype == f32 else "P-in-bf16"
            c2_leaves = (FLASH_BWD_LEAVES if dtype == f32
                         else FLASH_BWD_P_CONTROL_LEAVES)
            for leaf, g, w, c, c2 in zip(FLASH_BWD_LEAVES, a, want, ctrl,
                                         ctrl2):
                scale = float(w.abs().max())
                if dtype == f32:
                    err, c_err, c2_err = (rel_gap(g, w), rel_gap(c, w),
                                          rel_gap(c2, w))
                    max_err = max(max_err, float((g - w).abs().max()))
                    limit = FLASH_BWD_F32_TOL
                else:
                    ex = tol.half_ulp_excess(w, scale, kernel=g,
                                             control=c.to(dtype),
                                             control2=c2.to(dtype))
                    err, c_err, c2_err, limit = (ex["kernel"], ex["control"],
                                                 ex["control2"], F32_NOISE)
                check(err <= limit, f"{tag}: {leaf} {err:.3e} (limit "
                      f"{limit:.3e})")
                if leaf in FLASH_BWD_CONTROL_LEAVES:
                    check(c_err > limit, f"{tag}: {leaf}: the dS-in-bf16 "
                          f"control passes ({c_err:.3e} <= {limit:.3e})")
                if leaf in c2_leaves:
                    check(c2_err > limit, f"{tag}: {leaf}: the {c2_name} "
                          f"control passes ({c2_err:.3e} <= {limit:.3e})")
                parts.append(f"{leaf} {err:.3e} (dS-in-bf16 control "
                             f"{c_err:.3e}, {c2_name} control {c2_err:.3e})")
            rule = (f"of each gradient's max (limit {FLASH_BWD_F32_TOL:.0e})"
                    if dtype == f32 else "excess over half a bf16 ulp / max "
                    f"(limit {F32_NOISE:.3e})")
            log(f"{tag}: route {flash_build.bwd_route(dtype, D)}; out "
                f"bitwise without lse{fwd_rule}, lse within {lse_gap:.3e}, "
                f"{int(dead.sum())} rows -inf; bitwise across launches; "
                f"kernel vs plain {rule}: " + ", ".join(parts))
            if (name, dtype) in FLASH_BWD_TIMED:
                ms = cuda_ms(lambda: ops.flash_attention_bwd(
                    q, k, v, out, lse, dout, force="cuda", **opts),
                    reps=3, warmup=1)
                plain_ms = cuda_ms(lambda: ops.flash_attention_bwd(
                    q, k, v, out, lse, dout, force="ref", **opts),
                    reps=1, warmup=1)
                bound = flash_bound_ms(*shape, dtype, backward=True,
                                       **mask_opts(opts))
                tc = flash_bound_ms(*shape, dtype, backward=True, split=True,
                                    **mask_opts(opts))
                rec = dict(shape=list(shape), options=opts,
                           route=flash_build.bwd_route(dtype, D), ms=ms,
                           plain_ms=plain_ms, **bound_keys(dtype, bound, tc),
                           launches=None)
                if opts.get("window", 0) == 0:
                    # the function SDPA computes too: causal, no softcap
                    nocap = dict(opts, softcap=0.0)
                    o2, l2 = flash_build.flash_attention_cuda(
                        q, k, v, return_lse=True, **nocap)
                    rec["same_function_ms"] = cuda_ms(
                        lambda: ops.flash_attention_bwd(
                            q, k, v, o2, l2, dout, force="cuda", **nocap),
                        reps=3, warmup=1)
                    rec["library_ms"] = sdpa_bwd_ms(q, k, v, dout, reps=3)
                    del o2, l2
                else:
                    rec["library_ms"] = None
                times[name, dtype] = rec
                log(f"flash backward {name} {shape} {dtype} "
                    f"({rec['route']}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
                    f"({bound[1]}), tensor-core bound {tc[0]:.5f} ms "
                    f"({tc[1]}), kernel/least bound "
                    f"{ms / rec['bound_ms']:.1f}x"
                    + (f"; causal without softcap: kernel "
                       f"{rec['same_function_ms']:.4f} ms, torch "
                       f"scaled_dot_product_attention's backward (k, v "
                       f"expanded) {rec['library_ms']:.4f} ms"
                       if rec["library_ms"] is not None else ""))
                if dtype == f32:
                    fwd_times[name] = flash_f32_training_forward(
                        name, shape, opts, q, k, v)
            del a, b, want, ctrl, ctrl2, f, out, lse, plain_out
        del q32, k32, v32, dout32, q, k, v, dout
        torch.cuda.empty_cache()
    top = times["gemma2 global training layer", f32]
    shapes = {f"{name} {str(dtype).replace('torch.', '')}": rec
              for (name, dtype), rec in times.items()
              if (name, dtype) != ("gemma2 global training layer", f32)}
    record = dict(name="flash_attention_bwd", route="cuda",
                  source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                  replaces="none: port only; the reference differentiates "
                           "its plain attention, src/repro/kernels/ref.py:40",
                  launches=None, max_abs_err=max_err, ms=top["ms"],
                  plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                  bound_by=top["bound_by"], library_ms=top["library_ms"],
                  cuda_core_bound_ms=top["cuda_core_bound_ms"],
                  cuda_core_bound_by=top["cuda_core_bound_by"],
                  same_function_ms=top["same_function_ms"],
                  kernel_route=top["route"],
                  routes={str(t).replace("torch.", ""):
                          flash_build.bwd_route(t, 256) for t in (f32, bf16)},
                  registers=registers, shape=top["shape"], shapes=shapes)
    return record, fwd_times


def control_attention(**grad_opts):
    """A model attention (for ``attention_as``) on the plain path whose
    backward is wrong: ``ref.attention_grads`` with `grad_opts` over the
    forward's options (``softcap_grad=False``: the cap's derivative
    dropped; ``causal=False``: the causal mask dropped from the
    backward's mask)."""
    class Control(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, opts):
            out, lse = kref.attention_ref(q, k, v, return_lse=True, **opts)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.opts = opts
            return out

        @staticmethod
        def backward(ctx, dout):
            grads = kref.attention_grads(*ctx.saved_tensors,
                                         dout.contiguous(),
                                         **dict(ctx.opts, **grad_opts))
            return (*grads, None)

    return lambda q, k, v, force, **opts: Control.apply(q, k, v, opts)


def train_counts():
    """(ssd forward, ssd backward, flash forward, flash backward) launch
    counts, now."""
    return (ops.ssd_scan.launches, ops.ssd_scan_bwd.launches,
            ops.flash_attention.launches, ops.flash_attention_bwd.launches)


def zero_train_counts():
    zero_counts()
    ops.ssd_scan_bwd.launches = 0
    ops.flash_attention_bwd.launches = 0


def train_steps(model, steps, accum=1, batch=TRAIN_B, seq=TRAIN_S,
                settings=None, frontend=0, each_step=None):
    """`steps` steps of make_train_step (by default adamw at TRAIN_LR;
    `settings` a TrainSettings, whose accum_steps `accum` overrides) from
    the CLI's init on TokenPipeline(seed=0) at batch x seq text tokens,
    with `frontend` stand-in frontend embeddings a row ahead of them (drawn
    from a generator seeded by the step), the launch counts set to 0 just
    before; ``each_step(step, params, metrics)`` runs after each step:
    (params, losses, ms of each step, launches of each step, peak device
    memory)."""
    settings = dataclasses.replace(
        settings or train_module.TrainSettings(optimizer="adamw",
                                               lr=TRAIN_LR),
        accum_steps=accum)
    step_fn, opt = train_module.make_train_step(
        model, ShapeConfig("chip", "train", seq, batch), settings)
    params = model.init(0)
    opt_state = opt.init(params)
    pipe = TokenPipeline(seed=0, batch=batch, seq_len=seq,
                         vocab_size=model.cfg.vocab_size)
    losses, ms, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()  # the training path starts here
    for step in range(steps):
        data = pipe.next()
        if frontend:
            gen = torch.Generator(device="cuda").manual_seed(SEED + step)
            data["frontend_embeds"] = torch.randn(
                (batch, frontend, model.cfg.d_model), generator=gen,
                device="cuda")
        before = train_counts()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, data, step)
        losses.append(float(metrics["loss"]))  # waits for the step
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(tuple(n - m for n, m in zip(train_counts(), before)))
        if each_step is not None:
            each_step(step, params, metrics)
    return params, losses, ms, launches, torch.cuda.max_memory_allocated()


def attention_params(params, block):
    """`params` with the attention's wq and wk in ``params[block]``
    ("layers", or the hybrid's "shared") scaled by QK_GAIN: the template's
    fan-in init (d_model x the padded heads) gives scores of std 1/16,
    where the softcap's derivative is 1 within ~2e-6 and no check could
    see it; scaled, the scores have unit std, as the kernel checks' inputs
    give them."""
    for name in ("wq", "wk"):
        params[block]["attn"][name].mul_(QK_GAIN)
    return params


def attention_train_cell(tag, cfg, exact_params, control, control_name, B,
                         exact_s, steps=ATTN_TRAIN_STEPS, seq=ATTN_TRAIN_S,
                         accum=True):
    """A dense or hybrid model at full width and cut depth, f32, through
    the flash forward and backward kernels: `steps` adamw steps of
    make_train_step at B x `seq` positions, twice (the second bitwise the
    first), one step at accum_steps=2 over 2 x `seq` (where `accum`), then
    the exactness cell (1 x `exact_s` positions, the weights of
    `exact_params`) against the plain path, `control` (a wrong backward)
    outside F32_REDUCTION, remat="full" bitwise remat="none". A config
    with a frontend (internvl2-26b) takes its ``frontend_tokens`` stand-in
    embeddings ahead of the text in every batch, so the positions are
    frontend + text, and the accum step splits the frontend rows between
    its micro-batches. The steps come first, on a freshly emptied cache
    (the earlier phases' garbage collected first): the plain path's many
    differently sized tensors leave the caching allocator's segments cut
    up, and gemma2's step (62.4 GB of an 80 GB card) then found no 4.4 GiB
    block among 20.7 GiB of free cached memory. Returns the step's figures
    and its launches a micro-batch."""
    f32 = torch.float32
    L = cfg.num_layers
    hybrid = cfg.family == "hybrid"
    sites = transformer.n_attn_sites(cfg) if hybrid else L
    ssd = L if hybrid else 0
    F = cfg.frontend_tokens
    text, exact_text = seq - F, exact_s - F
    # (ssd forward, ssd backward, flash forward, flash backward)
    want = (ssd, ssd, sites, sites)
    label = (f"train ({tag}) {cfg.name} f32, {L} layers at full width"
             + (f" ({sites} shared-block sites)" if hybrid else ""))
    model = Model(cfg, param_dtype=f32)
    gc.collect()
    torch.cuda.empty_cache()
    # the training path: `steps` adamw steps, twice
    first = train_steps(model, steps, batch=B, seq=text, frontend=F)
    params, losses, ms, launches, peak = first
    kept = params_digest(params)
    del first, params
    torch.cuda.empty_cache()
    second = train_steps(model, steps, batch=B, seq=text, frontend=F)
    losses2, ms2, launches2 = second[1:4]
    bitwise = losses2 == losses and params_digest(second[0]) == kept
    del second
    torch.cuda.empty_cache()
    check(all(n == want for n in launches + launches2),
          f"{label}: launches a step {launches}, {launches2}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{label}: the loss does not fall: {losses}")
    check(bitwise, f"{label}: two runs differ: losses {losses} vs "
          f"{losses2}")
    step_ms = float(np.median(ms[1:] + ms2[1:]))
    tokens = B * seq
    log(f"{label} adamw lr {TRAIN_LR}, {B} x {seq} positions a step"
        + (f" ({F} frontend embeddings + {text} text tokens)" if F else "")
        + f", {steps} steps twice: {step_ms:.3f} ms a step (median of steps "
        f"1-{steps - 1} of both runs; first steps {ms[0]:.3f} / "
        f"{ms2[0]:.3f}), {tokens / (step_ms / 1e3):.1f} tokens/s, peak "
        f"device memory {peak / 1e9:.3f} GB; loss step 0 {losses[0]:.4f}, "
        f"step {steps - 1} {losses[-1]:.4f}; launches a step {want}; the "
        "second run bitwise the first")
    acc = None
    if accum:
        acc_losses, acc_ms, acc_launches, acc_peak = train_steps(
            model, 1, accum=2, batch=2, seq=text, frontend=F)[1:]
        want_acc = tuple(2 * n for n in want)
        check(acc_launches == [want_acc], f"{label} accum 2: launches "
              f"{acc_launches}, expected {want_acc}")
        check(math.isfinite(acc_losses[0]), f"{label} accum 2: loss "
              f"{acc_losses}")
        log(f"{label} accum_steps=2 over 2 x {seq} positions"
            + (" (each micro-batch one row of frontend embeddings)" if F
               else "") + f": one step {acc_ms[0]:.3f} ms (the first of "
            f"its run), launches {acc_launches[0]}, loss "
            f"{acc_losses[0]:.4f}, peak {acc_peak / 1e9:.3f} GB")
        acc = dict(ms=acc_ms[0], launches=acc_launches[0], peak=acc_peak)
        torch.cuda.empty_cache()

    # exactness: the kernel path against the plain path on 1 x exact_s
    params = exact_params(model)
    batch = TokenPipeline(seed=1, batch=1, seq_len=exact_text,
                          vocab_size=cfg.vocab_size).next()
    if F:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        batch["frontend_embeds"] = torch.randn((1, F, cfg.d_model),
                                               generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = train_counts()
    loss_k, _, g_k = train_module.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    c1 = train_counts()
    exact_peak = torch.cuda.max_memory_allocated()
    got = tuple(b - a for a, b in zip(c0, c1))
    check(got == want, f"{label}: launches {got}, expected {want} (ssd "
          "forward, ssd backward, flash forward, flash backward)")
    remat = Model(cfg, param_dtype=f32, remat="full")
    c0 = train_counts()
    loss_m, _, g_m = train_module.loss_and_grads(remat, params, batch)
    torch.cuda.synchronize()
    c1 = train_counts()
    got_m = tuple(b - a for a, b in zip(c0, c1))
    want_m = (2 * ssd, ssd, 2 * sites, sites)
    check(got_m == want_m, f"{label} remat: launches {got_m}, expected "
          f"{want_m}")
    check(torch.equal(loss_m, loss_k) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g_m), tree_leaves(g_k))),
        f"{label}: remat='full' changes the gradients")
    del g_m
    loss_r, _, g_r = train_module.loss_and_grads(model, params, batch,
                                                 force="ref")
    names = [".".join(p) for p in leaf_paths(g_r)]
    gaps = {n: rel_gap(k, r) for n, k, r in
            zip(names, tree_leaves(g_k), tree_leaves(g_r))}
    del g_k
    with attention_as(control):
        loss_c, _, g_c = train_module.loss_and_grads(model, params, batch,
                                                     force="ref")
    ctrl = {n: rel_gap(c, r) for n, c, r in
            zip(names, tree_leaves(g_c), tree_leaves(g_r))}
    del g_c, g_r, params
    torch.cuda.empty_cache()
    worst = max(gaps, key=gaps.get)
    log(f"{label}, 1 x {exact_s} positions: loss kernel "
        f"{float(loss_k):.6f} plain {float(loss_r):.6f} control "
        f"{float(loss_c):.6f}; every gradient leaf within "
        f"{gaps[worst]:.3e} of its max ({worst}; tol "
        f"{tol.F32_REDUCTION.w_rel}); the control ({control_name}) "
        f"{max(ctrl.values()):.3e} ({max(ctrl, key=ctrl.get)}); launches "
        f"{got}, remat='full' {got_m} and bitwise; peak "
        f"{exact_peak / 1e9:.3f} GB")
    check(abs(float(loss_k) - float(loss_r))
          <= tol.F32_REDUCTION.obj_rel * abs(float(loss_r)),
          f"{label}: loss {float(loss_k)} vs plain {float(loss_r)}")
    check(gaps[worst] <= tol.F32_REDUCTION.w_rel,
          f"{label}: gradient gaps {gaps}")
    check(max(ctrl.values()) > tol.F32_REDUCTION.w_rel,
          f"{label}: the control ({control_name}) passes ({ctrl})")
    return dict(name=cfg.name, step_ms=step_ms, launches=want,
                tokens_per_s=tokens / (step_ms / 1e3), peak=peak,
                losses=losses, exact_gap=gaps[worst],
                control_gap=max(ctrl.values()), accum=acc,
                exact_peak=exact_peak)


def train_attention_cells():
    """phase_train's (e) gemma2-9b and (f) zamba2-7b cells
    (``attention_train_cell``): {"gemma2": ..., "zamba2": ...}. They run
    with the caching allocator's expandable segments on, put back off
    after them: even on an emptied cache, gemma2's first step once found
    no block for its 4.4 GiB logits among 23.6 GiB of cut-up cached
    memory after the earlier phases had run."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return dict(
            gemma2=attention_train_cell(
                "e", dataclasses.replace(GEMMA2_9B,
                                         num_layers=GEMMA2_TRAIN_LAYERS),
                lambda m: attention_params(m.init(SEED), "layers"),
                control_attention(softcap_grad=False),
                "the softcap's derivative dropped", GEMMA2_TRAIN_B,
                ATTN_TRAIN_S),
            zamba2=attention_train_cell(
                "f", dataclasses.replace(ZAMBA2_7B,
                                         num_layers=ZAMBA2_TRAIN_LAYERS),
                lambda m: attention_params(ssm_params(m, SEED), "shared"),
                control_attention(causal=False),
                "the causal mask dropped", ZAMBA2_TRAIN_B, ZAMBA2_EXACT_S))
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


def train_floor_ms(cfg, tokens, dtype):
    """The least time of a training step: 6 FLOP a weight a token for the
    non-embedding weights at the dtype's tensor-core rate (f32: the CUDA
    cores' 67 TFLOP/s), an MoE layer's expert products counted over every
    capacity slot (E x cap rows, not the T x k routed ones)."""
    template = transformer.model_template(cfg)
    layers = sum(math.prod(t.shape) for t in tree_leaves(template["layers"]))
    flop = 6.0 * layers * tokens
    if cfg.num_experts:
        E, k, L = cfg.num_experts, cfg.experts_per_token, cfg.num_layers
        experts = L * E * 3 * cfg.d_model * cfg.d_ff
        cap = mmoe.capacity(tokens, k, E)
        flop = 6.0 * (layers - experts) * tokens + 6.0 * experts * cap
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    return 1e3 * flop / rate


def phase_train_dense_stack():
    """(g) phi3-mini, minitron-8b, chatglm3-6b, musicgen-large and
    internvl2-26b trained at full width, cut to DENSE_TRAIN_LAYERS, f32,
    through the flash forward and backward kernels
    (``attention_train_cell``: GQA groups 1, 4, 16, 1 and 6, head dims 96,
    128, 128, 64 and 128; internvl2 with its frontend embeddings), the
    causal mask dropped from the backward as the control, each model on a
    freshly emptied cache under expandable segments."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    cells = {}
    try:
        for full in DENSE_TRAIN:
            cfg = dataclasses.replace(full, num_layers=DENSE_TRAIN_LAYERS)
            D = cfg.resolved_head_dim
            check(flash_build.route(torch.float32, D) == "wgmma-f32"
                  and flash_build.bwd_route(torch.float32, D) == "wgmma-f32",
                  f"train (g) {cfg.name}: routes")
            free_model()
            t0 = time.perf_counter()
            cell = attention_train_cell(
                "g", cfg, lambda m: attention_params(m.init(SEED), "layers"),
                control_attention(causal=False), "the causal mask dropped",
                1, DENSE_EXACT_POS, steps=DENSE_TRAIN_STEPS,
                seq=DENSE_TRAIN_POS,
                accum=cfg.name not in DENSE_TRAIN_NO_ACCUM)
            cell["floor_ms"] = train_floor_ms(cfg, DENSE_TRAIN_POS,
                                              torch.float32)
            peaks = [cell["peak"], cell["exact_peak"]] + (
                [cell["accum"]["peak"]] if cell["accum"] else [])
            check(max(peaks) <= TRAIN_PEAK_LIMIT, f"train (g) {cfg.name}: "
                  f"peaks {peaks} past {TRAIN_PEAK_LIMIT:.0f} B")
            log(f"train (g) {cfg.name}: {cell['step_ms']:.3f} ms a step "
                f"against a floor of {cell['floor_ms']:.3f} ms (6 x "
                f"non-embedding weights x {DENSE_TRAIN_POS} tokens at "
                f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s), "
                f"{cell['step_ms'] / cell['floor_ms']:.1f}x; "
                f"{time.perf_counter() - t0:.1f} s")
            cells[cfg.name] = cell
            free_model()
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    return cells


def params_digest(params):
    """Each leaf's ``tile_digest`` (its bits, on the device): two trees of
    equal digests are bitwise equal but for a collision."""
    return [tile_digest(p) for p in tree_leaves(params)]


def moe_train_cell(full, experts):
    """(h) one MoE model in bf16 at the reference's production settings,
    1 layer at full width with `experts` experts: MOE_TRAIN_STEPS steps of
    make_train_step at MOE_TRAIN_B x MOE_TRAIN_S tokens, twice (the second
    bitwise the first: losses and every leaf's digest), each step's
    launches (2 flash forward under remat, 1 backward), expert loads and
    drops, and the padded heads' wo rows (exactly 0 after every step)."""
    bf16 = torch.bfloat16
    cfg = dataclasses.replace(full, num_layers=1, num_experts=experts)
    E, D = cfg.num_experts, cfg.resolved_head_dim
    label = (f"train (h) {cfg.name} bf16, 1 of {full.num_layers} layers at "
             f"full width, {E} of {full.num_experts} experts top-"
             f"{cfg.experts_per_token}")
    check(flash_build.route(bf16, D) == "wgmma"
          and flash_build.bwd_route(bf16, D) == "wgmma",
          f"{label}: routes {flash_build.route(bf16, D)}, "
          f"{flash_build.bwd_route(bf16, D)}")
    settings = train_module.TrainSettings(optimizer="adafactor", lr=TRAIN_LR,
                                          grad_dtype="bfloat16")
    model = Model(cfg, param_dtype=bf16, remat="full")
    want = (0, 0, 2, 1)  # ssd fwd / bwd, flash fwd (remat: twice), bwd
    runs = []
    for run in range(2):
        free_model()
        steps_log = []
        with routes_recorded() as calls:
            def each_step(step, params, metrics):
                # the forward's route and the backward's recompute of it
                fwd, again = calls
                calls.clear()
                check(torch.equal(fwd.idx, again.idx)
                      and torch.equal(fwd.slots, again.slots),
                      f"{label}: the recompute routed otherwise at step "
                      f"{step}")
                loads = expert_loads(fwd, E)
                steps_log.append(dict(
                    wo=padded_wo_gradient(cfg, params, tree_leaves(params)),
                    drops=int((~fwd.keep).sum()),
                    load_min=int(loads.min()), load_max=int(loads.max()),
                    aux=float(metrics["aux"]),
                    grad_norm=float(metrics["grad_norm"])))

            out = train_steps(model, MOE_TRAIN_STEPS, batch=MOE_TRAIN_B,
                              seq=MOE_TRAIN_S, settings=settings,
                              each_step=each_step)
        params, losses, ms, launches, peak = out
        del out
        runs.append(dict(digest=params_digest(params), losses=losses, ms=ms,
                         launches=launches, peak=peak, steps=steps_log))
        del params
    a, b = runs
    check(all(n == want for r in runs for n in r["launches"]),
          f"{label}: launches a step {a['launches']}, {b['launches']}, "
          f"expected {want}")
    check(all(math.isfinite(x) for x in a["losses"])
          and a["losses"][-1] < a["losses"][0],
          f"{label}: the loss does not fall: {a['losses']}")
    check(a["losses"] == b["losses"] and a["digest"] == b["digest"],
          f"{label}: two runs differ: losses {a['losses']} vs "
          f"{b['losses']}, digests equal "
          f"{[x == y for x, y in zip(a['digest'], b['digest'])]}")
    check(all(st["wo"] == 0.0 for r in runs for st in r["steps"]),
          f"{label}: the padded heads' wo rows moved: "
          f"{[st['wo'] for st in a['steps']]}")
    peak = max(a["peak"], b["peak"])
    check(peak <= TRAIN_PEAK_LIMIT, f"{label}: peak {peak / 1e9:.3f} GB")
    # where a step's time goes: the gradient (forward, the remat forward,
    # backward) and the adafactor update, each alone, on steps 0 and 1 of
    # a fresh run; step 1's are the warm ones (step 0 also grows the
    # allocator's segments)
    free_model()
    opt = train_module.make_optimizer(settings)
    params = model.init(0)
    state = opt.init(params)
    pipe = TokenPipeline(seed=0, batch=MOE_TRAIN_B, seq_len=MOE_TRAIN_S,
                         vocab_size=cfg.vocab_size)
    parts = []
    for step in range(2):
        batch = pipe.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = train_module.loss_and_grads(model, params, batch)[2]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            opt.update(grads, state, params, step)
        torch.cuda.synchronize()
        parts.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))
        del grads, batch
    (cold_grad_ms, cold_update_ms), (grad_ms, update_ms) = parts
    weights = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    del params, state
    free_model()
    tokens = MOE_TRAIN_B * MOE_TRAIN_S
    step_ms = float(np.median(a["ms"][1:] + b["ms"][1:]))
    floor = train_floor_ms(cfg, tokens, bf16)
    cap = mmoe.capacity(tokens, cfg.experts_per_token, E)
    padded = mattn.padded_heads(cfg) - cfg.num_heads
    log(f"{label}, adafactor lr {TRAIN_LR}, grad_dtype bfloat16, remat "
        f"full, {MOE_TRAIN_B} x {MOE_TRAIN_S} tokens a step, "
        f"{MOE_TRAIN_STEPS} steps twice: {step_ms:.3f} ms a step (median "
        f"of steps 1-{MOE_TRAIN_STEPS - 1} of both runs; first steps "
        f"{a['ms'][0]:.3f} / {b['ms'][0]:.3f}), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, floor {floor:.3f} ms (6 x "
        f"non-embedding weights x tokens at {BF16_FLOP_PER_S / 1e12:.0f} "
        f"TFLOP/s, the experts over {E} x {cap} capacity slots), "
        f"{step_ms / floor:.1f}x; step 1 of a fresh run (warm): the "
        f"gradient alone {grad_ms:.3f} ms, the update alone "
        f"{update_ms:.3f} ms, together {grad_ms + update_ms:.3f} ms (step 0, "
        f"cold: {cold_grad_ms:.3f} and {cold_update_ms:.3f} ms); peak "
        f"device memory "
        f"{peak / 1e9:.3f} GB against {2 * weights / 1e9:.3f} GB of weights "
        f"and gradients; losses {a['losses']}; launches a step {want} "
        f"(flash forward "
        f"twice under remat, all on the wgmma route); the second run "
        f"bitwise the first; {padded} padded heads' wo rows "
        f"{[st['wo'] for st in a['steps']]} after each step")
    for i, st in enumerate(a["steps"]):
        log(f"{label} step {i}: expert load {st['load_min']}-"
            f"{st['load_max']} of {cap} slots, {st['drops']} of "
            f"{tokens * cfg.experts_per_token} (token, slot)s dropped, aux "
            f"{st['aux']:.4f}, grad norm {st['grad_norm']:.4f}")
    return dict(name=cfg.name, step_ms=step_ms, launches=want,
                tokens_per_s=tokens / (step_ms / 1e3), peak=peak,
                floor_ms=floor, losses=a["losses"], steps=a["steps"],
                grad_ms=grad_ms, update_ms=update_ms,
                cold_grad_ms=cold_grad_ms, cold_update_ms=cold_update_ms)


def phase_train_moe():
    """(h) arctic-480b and kimi-k2 trained in bf16 at the reference's
    production settings (``moe_train_cell``), one at a time, each on a
    freshly emptied cache under expandable segments."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        cells = {}
        for full, experts in MOE_TRAIN:
            t0 = time.perf_counter()
            cell = moe_train_cell(full, experts)
            cells[cell["name"]] = cell
            log(f"train (h) {cell['name']}: {time.perf_counter() - t0:.1f} s")
            free_model()
        return cells
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


@contextlib.contextmanager
def gates_detached():
    """Inside the block the MoE combine's gates are detached: the router
    then learns from the auxiliary loss alone (a control)."""
    orig = mmoe.route

    def detached(probs, k, capacity_factor=1.25):
        r = orig(probs, k, capacity_factor)
        return dataclasses.replace(r, gate=r.gate.detach())

    mmoe.route = detached
    try:
        yield
    finally:
        mmoe.route = orig


def moe_exact_cell(full, experts):
    """(i) one MoE model in f32, 1 layer at full width with `experts`
    experts, on 1 x MOE_EXACT_S tokens (wq and wk scaled by QK_GAIN): the
    kernel path's loss, aux and every gradient leaf against the plain
    path's at F32_REDUCTION where no (token, slot) route differs between
    the paths (else the expert slices no differing route touches, the rest
    logged); remat="full" bitwise "none"; two controls outside the rule:
    the combine's gates detached (on the router leaf) and the causal mask
    dropped; then one accum_steps=2 adafactor step at grad_dtype bfloat16
    and one at float32, launches doubled, the loss finite."""
    f32 = torch.float32
    cfg = dataclasses.replace(full, num_layers=1, num_experts=experts)
    E = cfg.num_experts
    label = (f"train (i) {cfg.name} f32, 1 layer at full width, {E} of "
             f"{full.num_experts} experts top-{cfg.experts_per_token}")
    model = Model(cfg, param_dtype=f32)
    params = attention_params(model.init(SEED), "layers")
    batch = TokenPipeline(seed=1, batch=1, seq_len=MOE_EXACT_S,
                          vocab_size=cfg.vocab_size).next()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = train_counts()
    with routes_recorded() as rk:
        loss_k, m_k, g_k = train_module.loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
    got = tuple(b - a for a, b in zip(c0, train_counts()))
    check(got == (0, 0, 1, 1), f"{label}: launches {got}")
    remat = Model(cfg, param_dtype=f32, remat="full")
    c0 = train_counts()
    loss_m, _, g_m = train_module.loss_and_grads(remat, params, batch)
    torch.cuda.synchronize()
    got_m = tuple(b - a for a, b in zip(c0, train_counts()))
    check(got_m == (0, 0, 2, 1), f"{label} remat: launches {got_m}")
    check(torch.equal(loss_m, loss_k) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g_m), tree_leaves(g_k))),
        f"{label}: remat='full' changes the gradients")
    del g_m
    with routes_recorded() as rr:
        loss_r, m_r, g_r = train_module.loss_and_grads(model, params, batch,
                                                       force="ref")
    flips = route_flips(rk[0], rr[0])
    n_flips = int(flips.sum())
    names = [".".join(p) for p in leaf_paths(g_r)]
    gaps = {n: rel_gap(k, r) for n, k, r in
            zip(names, tree_leaves(g_k), tree_leaves(g_r))}
    held = dict(gaps)
    if n_flips:
        # the experts a differing route names on either path: their slices
        # and every leaf upstream of the routes move; the other experts'
        # slices are held
        touched = torch.zeros(E, dtype=torch.bool, device=flips.device)
        touched[rk[0].idx[flips]] = True
        touched[rr[0].idx[flips]] = True
        keep = ~touched
        held = {}
        for n, k, r in zip(names, tree_leaves(g_k), tree_leaves(g_r)):
            if n.startswith("layers.moe.w") and bool(keep.any()):
                held[n] = rel_gap(k[:, keep], r[:, keep])
    del g_k
    with gates_detached():
        _, _, g_d = train_module.loss_and_grads(model, params, batch,
                                                force="ref")
    router = names.index("layers.moe.router")
    gates_gap = rel_gap(tree_leaves(g_d)[router], tree_leaves(g_r)[router])
    del g_d
    with attention_as(control_attention(causal=False)):
        loss_c, _, g_c = train_module.loss_and_grads(model, params, batch,
                                                     force="ref")
    ctrl = {n: rel_gap(c, r) for n, c, r in
            zip(names, tree_leaves(g_c), tree_leaves(g_r))}
    exact_peak = torch.cuda.max_memory_allocated()
    del g_c, g_r, params
    free_model()
    worst = max(held, key=held.get) if held else None
    n_routes = flips.numel()
    log(f"{label}, 1 x {MOE_EXACT_S} tokens: (token, slot) routes that "
        f"differ between the kernel and plain paths {n_flips} of {n_routes}"
        + (f" (experts {sorted(set(rk[0].idx[flips].tolist()) | set(rr[0].idx[flips].tolist()))}; "
           f"only the other experts' slices held)" if n_flips else "")
        + f"; loss kernel {float(loss_k):.6f} plain {float(loss_r):.6f}, "
        f"aux kernel {float(m_k['aux']):.6f} plain {float(m_r['aux']):.6f}; "
        + (f"every held gradient leaf within {held[worst]:.3e} of its max "
           f"({worst}; tol {tol.F32_REDUCTION.w_rel}); " if held else "")
        + f"controls: the combine's gates detached, router leaf "
        f"{gates_gap:.3e}; the causal mask dropped {max(ctrl.values()):.3e} "
        f"({max(ctrl, key=ctrl.get)}); launches {got}, remat='full' {got_m} "
        f"and bitwise; peak {exact_peak / 1e9:.3f} GB")
    if n_flips == 0:
        for what, k, r in (("loss", loss_k, loss_r),
                           ("aux", m_k["aux"], m_r["aux"])):
            check(abs(float(k) - float(r))
                  <= tol.F32_REDUCTION.obj_rel * abs(float(r)),
                  f"{label}: {what} {float(k)} vs plain {float(r)}")
    if held:
        check(held[worst] <= tol.F32_REDUCTION.w_rel,
              f"{label}: gradient gaps {held}")
    check(gates_gap > tol.F32_REDUCTION.w_rel,
          f"{label}: the gates-detached control passes on the router "
          f"({gates_gap:.3e})")
    check(max(ctrl.values()) > tol.F32_REDUCTION.w_rel,
          f"{label}: the causal-mask control passes ({ctrl})")
    check(exact_peak <= TRAIN_PEAK_LIMIT, f"{label}: peak "
          f"{exact_peak / 1e9:.3f} GB")
    accum = {}
    for gdt in ("bfloat16", "float32"):
        free_model()
        # (the run's parameters dropped at once: kept, they would sit
        # beside the next run's)
        losses, ms, launches, peak = train_steps(
            model, 1, accum=2, batch=2, seq=MOE_EXACT_S,
            settings=train_module.TrainSettings(
                optimizer="adafactor", lr=TRAIN_LR, grad_dtype=gdt))[1:]
        check(launches == [(0, 0, 2, 2)] and math.isfinite(losses[0]),
              f"{label} accum 2, grad_dtype {gdt}: launches {launches}, "
              f"loss {losses}")
        check(peak <= TRAIN_PEAK_LIMIT, f"{label} accum 2: peak "
              f"{peak / 1e9:.3f} GB")
        log(f"{label} adafactor accum_steps=2 over 2 x {MOE_EXACT_S} tokens,"
            f" grad_dtype {gdt}: one step {ms[0]:.3f} ms (the first of its "
            f"run), launches {launches[0]}, loss {losses[0]:.4f}, peak "
            f"{peak / 1e9:.3f} GB")
        accum[gdt] = dict(ms=ms[0], launches=launches[0], peak=peak)
    free_model()
    return dict(name=cfg.name, flips=n_flips, routes=n_routes,
                exact_gap=held[worst] if held else None,
                gates_gap=gates_gap, control_gap=max(ctrl.values()),
                launches=got, accum=accum, peak=exact_peak)


def phase_train_moe_exact():
    """(i) the MoE family's exactness cells, f32 (``moe_exact_cell``),
    under expandable segments."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return {c["name"]: c for c in
                (moe_exact_cell(full, experts) for full, experts in
                 MOE_EXACT)}
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


def phase_train():
    """Training on the card: (a) mamba2-130m's 4-layer exactness cell
    against the plain path, remat bitwise; (b) 20 adamw steps of
    full-size mamba2-130m through make_train_step, twice (the second run
    bitwise the first), and one step with accum_steps=2; (c) the CLI's
    SODDA-SVRG loop; (d) the CLI killed after its checkpoint at step 10
    and resumed in a fresh process, against (b); then through the flash
    backward (``attention_train_cell``): (e) gemma2-9b cut to 2 layers and
    (f) zamba2-7b cut to 12, at full width."""
    f32 = torch.float32
    # (a) exactness: the kernel path's loss and gradients against the plain
    # path's, the carry-dropping control outside; remat bitwise
    cfg = dataclasses.replace(MAMBA2_130M, num_layers=TRAIN_CUT_LAYERS)
    L = cfg.num_layers
    model = Model(cfg, param_dtype=f32)
    params = ssm_params(model, SEED)
    batch = TokenPipeline(seed=1, batch=TRAIN_CUT_B, seq_len=TRAIN_CUT_S,
                          vocab_size=cfg.vocab_size).next()
    c0 = train_counts()
    with tma_copies() as seen:
        loss_k, _, g_k = train_module.loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
    c1 = train_counts()
    check(tuple(b - a for a, b in zip(c0, c1)) == (L, L, 0, 0),
          f"train (a): launches {[b - a for a, b in zip(c0, c1)]}, expected "
          f"{L} forward and {L} backward ssd, 0 flash")
    # the f32 forward reads B, C by TMA and x at its fragments' places, the
    # backward x, B, C (saved by the forward) and dy by TMA: the model hands
    # them over contiguous and aligned, so none is copied
    check(seen["calls"] == 7 * L and seen["copies"] == 0,
          f"train (a): tma_operand {seen}, expected {7 * L} calls (x, B, C "
          "of the forward and x, B, C, dy of the backward a layer) and no "
          "copy")
    log(f"train (a): the forward's and the backward's TMA operands (x, B, "
        f"C; x, B, C, dy of {L} layers): {seen['calls']} calls, "
        f"{seen['copies']} copies ({seen['bytes']} bytes)")
    loss_r, _, g_r = train_module.loss_and_grads(model, params, batch,
                                                 force="ref")
    with ssd_as(ssd_carry_dropped):
        loss_c, _, g_c = train_module.loss_and_grads(model, params, batch,
                                                     force="ref")
    names = [".".join(p) for p in leaf_paths(g_r)]
    gaps = {n: rel_gap(k, r) for n, k, r in
            zip(names, tree_leaves(g_k), tree_leaves(g_r))}
    ctrl = {n: rel_gap(c, r) for n, c, r in
            zip(names, tree_leaves(g_c), tree_leaves(g_r))}
    worst = max(gaps, key=gaps.get)
    log(f"train (a) mamba2-130m f32, {L} layers at full width, "
        f"{TRAIN_CUT_B} x {TRAIN_CUT_S} tokens: loss kernel "
        f"{float(loss_k):.6f}"
        f" plain {float(loss_r):.6f} control {float(loss_c):.6f}; every "
        f"gradient leaf within {max(gaps.values()):.3e} of its max ({worst}; "
        f"tol {tol.F32_REDUCTION.w_rel}); the carry-dropping control "
        f"{max(ctrl.values()):.3e} ({max(ctrl, key=ctrl.get)})")
    check(abs(float(loss_k) - float(loss_r))
          <= tol.F32_REDUCTION.obj_rel * abs(float(loss_r)),
          f"train (a): loss {float(loss_k)} vs plain {float(loss_r)}")
    check(max(gaps.values()) <= tol.F32_REDUCTION.w_rel,
          f"train (a): gradient gaps {gaps}")
    check(max(ctrl.values()) > tol.F32_REDUCTION.w_rel,
          f"train (a): the carry-dropping control passes ({ctrl})")
    remat = Model(cfg, param_dtype=f32, remat="full")
    c0 = train_counts()
    loss_m, _, g_m = train_module.loss_and_grads(remat, params, batch)
    torch.cuda.synchronize()
    c1 = train_counts()
    check((c1[0] - c0[0], c1[1] - c0[1]) == (2 * L, L),
          f"train (a) remat: launches {[b - a for a, b in zip(c0, c1)]}, "
          f"expected {2 * L} forward and {L} backward")
    check(torch.equal(loss_m, loss_k) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g_m), tree_leaves(g_k))),
        "train (a): remat='full' changes the gradients")
    log(f"train (a) remat='full': gradients bitwise remat='none', "
        f"{c1[0] - c0[0]} forward and {c1[1] - c0[1]} backward ssd launches")
    del model, remat, params, g_k, g_r, g_c, g_m
    torch.cuda.empty_cache()

    # (b) adamw on full-size mamba2-130m: the training main path
    cfg = MAMBA2_130M
    L = cfg.num_layers
    model = Model(cfg, param_dtype=f32)
    runs = [train_steps(model, TRAIN_STEPS) for _ in range(2)]
    params, losses, ms, launches, peak = runs[0]
    want = (L, L, 0, 0)
    check(all(n == want for run in runs for n in run[3]),
          f"train (b): launches a step {runs[0][3]}, expected {want} "
          "(ssd forward, ssd backward, flash forward, flash backward)")
    f32_route = ssd_build.route(f32, cfg.ssm_head_dim, cfg.ssm_state)
    check(f32_route == "wgmma-f32" and ops.ssd_scan.route_launches
          == {"wgmma": 0, "wgmma-f32": ops.ssd_scan.launches}
          and ops.ssd_scan.launches == TRAIN_STEPS * L,
          f"train (b): ssd forward launches by route "
          f"{ops.ssd_scan.route_launches} in the second run's "
          f"{ops.ssd_scan.launches}, expected all on wgmma-f32")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train (b): the loss does not fall: {losses}")
    bitwise = runs[1][1] == losses and all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[1][0]), tree_leaves(params)))
    step_ms = float(np.median(ms[1:] + runs[1][2][1:]))
    tokens = TRAIN_B * TRAIN_S
    log(f"train (b) mamba2-130m f32 adamw lr {TRAIN_LR}, {TRAIN_B} x "
        f"{TRAIN_S} tokens a step, {TRAIN_STEPS} steps twice: "
        f"{step_ms:.3f} ms a step (median of steps 1-{TRAIN_STEPS - 1} of "
        f"each run; runs' medians {np.median(ms[1:]):.3f} / "
        f"{np.median(runs[1][2][1:]):.3f}; first step {ms[0]:.3f}), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, peak device memory "
        f"{peak / 1e9:.3f} GB; loss step 0 {losses[0]:.4f}, step "
        f"{TRAIN_STEPS - 1} {losses[-1]:.4f}; launches a step {want}; the "
        f"second run {'bitwise' if bitwise else 'NOT bitwise'} the first")
    if not bitwise:
        spread = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(runs[1][0]), tree_leaves(params)))
        log(f"train (b): two uninterrupted runs part by {spread:.3e} "
            f"(losses {runs[1][1]} vs {losses})")
    del runs
    torch.cuda.empty_cache()
    _, acc_losses, acc_ms, acc_launches, acc_peak = train_steps(
        model, 1, accum=2)
    check(acc_launches == [(2 * L, 2 * L, 0, 0)],
          f"train (b) accum 2: launches {acc_launches}, expected "
          f"{(2 * L, 2 * L, 0, 0)}")
    log(f"train (b) accum_steps=2: one step {acc_ms[0]:.3f} ms (the first "
        f"of its run), launches {acc_launches[0]}, loss {acc_losses[0]:.4f}"
        f", peak {acc_peak / 1e9:.3f} GB")
    torch.cuda.empty_cache()

    # (c) the CLI's SODDA-SVRG loop, at SODDA_LAYERS
    sodda_model = Model(dataclasses.replace(cfg, num_layers=SODDA_LAYERS),
                        param_dtype=f32)
    L = SODDA_LAYERS
    pipe = TokenPipeline(seed=0, batch=TRAIN_B, seq_len=TRAIN_S,
                         vocab_size=cfg.vocab_size)
    sodda_params = sodda_model.init(0)
    torch.cuda.synchronize()
    zero_train_counts()
    t0 = time.perf_counter()
    _, s_losses = train_module.sodda_loop(sodda_model, sodda_params, pipe,
                                          TRAIN_STEPS, SODDA_LR,
                                          log=lambda _: None)
    torch.cuda.synchronize()
    s_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    s_counts = train_counts()
    grads = 2 * TRAIN_STEPS + 1  # a refresh at step 0
    check(s_counts == (grads * L, grads * L, 0, 0),
          f"train (c): launches {s_counts}, expected {grads} gradients of "
          f"{L} forward and {L} backward ssd launches")
    check(all(math.isfinite(x) for x in s_losses)
          and s_losses[-1] < s_losses[0],
          f"train (c): the SODDA-SVRG loss does not fall: {s_losses}")
    log(f"train (c) SODDA-SVRG (the CLI's loop, refresh at step 0, lr "
        f"{SODDA_LR}; {L} of {cfg.num_layers} layers): {s_ms:.3f} ms a step (the mean of {TRAIN_STEPS}; "
        f"2 gradients a step, 3 at the refresh), launches {s_counts} "
        f"(ssd forward, backward, flash forward, backward) = {grads} "
        f"gradients; loss step 0 {s_losses[0]:.4f}, step {TRAIN_STEPS - 1} "
        f"{s_losses[-1]:.4f}")
    del sodda_model, sodda_params
    L = cfg.num_layers
    torch.cuda.empty_cache()

    # (d) kill and resume: the CLI in a fresh process, killed by SIGKILL
    # once it logs step TRAIN_KILL_AT (the steps past its last checkpoint
    # uncommitted), then a fresh process resumes to TRAIN_STEPS; against
    # (b)'s first run
    ckpt_path = ckpt_dir("train")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           cfg.name, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--lr",
           str(TRAIN_LR), "--ckpt_dir", ckpt_path, "--ckpt_every",
           str(TRAIN_CKPT_EVERY), "--log_every", "1", "--steps",
           str(TRAIN_STEPS)]
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    t0 = time.perf_counter()
    # a session of its own: the kill takes the CLI's whole process group
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def kill_cli():
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)

    watchdog = threading.Timer(600, kill_cli)
    watchdog.start()
    killed_after, lines = None, []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith(f"step {TRAIN_KILL_AT:5d} "):
            kill_cli()
            killed_after = TRAIN_KILL_AT
            break
    proc.stdout.close()
    proc.wait()
    watchdog.cancel()
    check(killed_after is not None and proc.returncode == -signal.SIGKILL,
          f"train (d): the first process was not killed at step "
          f"{TRAIN_KILL_AT} (exit {proc.returncode}):\n"
          f"{''.join(lines)[-4000:]}")
    committed = checkpoint.latest_step(ckpt_path)
    check(committed == TRAIN_CKPT_EVERY, f"train (d): the killed run's last "
          f"checkpoint is at {committed}, not {TRAIN_CKPT_EVERY}")
    proc = subprocess.run(cmd + ["--resume"], env=env, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"train (d): --resume exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-4000:]}")
    resume_s = time.perf_counter() - t0
    check(f"resumed at step {TRAIN_CKPT_EVERY}" in proc.stdout,
          f"train (d): the second process did not resume: {proc.stdout}")
    template = {"params": params,
                "opt_state": train_module.make_optimizer(
                    train_module.TrainSettings()).init(params)}
    step, tree, extra = checkpoint.restore_checkpoint(ckpt_path, template)
    check(step == TRAIN_STEPS, f"train (d): last checkpoint at {step}")
    resumed = [torch.from_numpy(np.array(a)) for a in
               tree_leaves(tree["params"])]
    final = [p.cpu() for p in tree_leaves(params)]
    gap = max(float((a - b).abs().max()) for a, b in zip(resumed, final))
    same = extra["losses"] == losses and gap == 0.0
    log(f"train (d) the CLI killed (SIGKILL) after step {TRAIN_KILL_AT}, "
        f"past its checkpoint at step {TRAIN_CKPT_EVERY}, and resumed from "
        f"it in a fresh process to {TRAIN_STEPS} "
        f"({resume_s:.1f} s for both processes): params max|resumed - "
        f"uninterrupted| {gap:.3e}, losses "
        f"{'equal' if extra['losses'] == losses else 'differ'}")
    if bitwise:
        check(same, "train (d): the resumed run is not bitwise the "
              f"uninterrupted one (gap {gap}, losses {extra['losses']} vs "
              f"{losses})")
    else:
        check(gap <= spread, f"train (d): the resume parts by {gap}, "
              f"beyond two uninterrupted runs' {spread}")
    shutil.rmtree(ckpt_path, ignore_errors=True)

    # (e), (f): dense and hybrid training through the flash backward
    cells = train_attention_cells()
    return dict(step_ms=step_ms, launches=launches[0], sodda_ms=s_ms,
                sodda_launches=s_counts, peak=peak, **cells)


MESH_LM_CUT = 2  # chatglm3-6b's layers in the mesh cells (of 28)
MESH_LM_B, MESH_LM_S, MESH_LM_STEPS, MESH_LM_LR = 2, 2048, 2, 3e-4
MESH_LM_PROMPT, MESH_LM_GEN, MESH_LM_CACHE = 1024, 9, 1040
MESH_LM_SERVE_B = 4
MESH_LM_GRAD_TOL = 1e-4  # of each gradient leaf's largest entry
MESH_LM_UPDATE_TOL = 2e-3  # x the one-device step's largest update
# adamw's first update is lr x sign(g) where |g| >> eps: an entry whose
# gradient the two sums give opposite signs moves the other way (the rule
# of tests/test_torch_train_moe.py: at most this share of a leaf)
MESH_LM_ADAMW_FLIPS = 1e-3
MESH_LM_LOGIT_TOL = 2e-4  # rtol = atol, as the cut-depth f32 cells
MESH_LM_GRIDS = {"seq": (1, 4), "heads": (2, 2)}
MESH_LM_REMATS = ("none", "full", "collectives")
MESH_LM_FULL_S = 256  # the positions a rank's "full" remat gradient takes


def mesh_lm_cfg():
    return dataclasses.replace(CHATGLM3_6B, num_layers=MESH_LM_CUT)


def mesh_lm_counts(mesh):
    """(flash forward, flash backward, SSD forward, SSD backward launches,
    collective calls and payload by tag), now."""
    return (ops.flash_attention.launches, ops.flash_attention_bwd.launches,
            ops.ssd_scan.launches, ops.ssd_scan_bwd.launches,
            dict(mesh.calls), dict(mesh.payload))


def mesh_lm_since(mesh, before):
    now = mesh_lm_counts(mesh)
    return dict(flash=now[0] - before[0], flash_bwd=now[1] - before[1],
                ssd=now[2] - before[2], ssd_bwd=now[3] - before[3],
                calls={k: v - before[4].get(k, 0) for k, v in now[4].items()
                       if v != before[4].get(k, 0)},
                payload={k: v - before[5].get(k, 0)
                         for k, v in now[5].items()
                         if v != before[5].get(k, 0)})


def mesh_lm_timed(mesh, sync):
    """Time each of `mesh`'s collectives from here on (the device
    synchronised before and after it): seconds by tag, filled as they
    run."""
    spent = collections.Counter()
    for name in ("all_reduce", "all_gather_cat", "all_to_all_single"):
        def timed(t, axis, *args, _fn=getattr(mesh, name), **kw):
            sync()
            t0 = time.perf_counter()
            out = _fn(t, axis, *args, **kw)
            sync()
            spent[kw.get("tag") or axis] += time.perf_counter() - t0
            return out
        setattr(mesh, name, timed)
    return spent


def mesh_lm_reference(cfg, batch, device, settings, layouts):
    """The one-device step from the seed's parameters on `batch`: per
    leaf, its gradient's largest entry, the largest move of the one-device
    update, and for each of `layouts` (name -> (mesh, param specs,
    whether the update is held there)) this rank's shard of the gradient
    (and of the updated parameter). The full trees are freed before it
    returns."""
    from repro_torch.distributed import tensor_parallel as tpm

    one = Model(cfg, device=device, param_dtype=torch.float32)
    params = one.init(SEED)
    loss, _, grads = train_module.loss_and_grads(one, params, batch)
    out = dict(loss=float(loss), grad_norm=float(torch.sqrt(sum(
        train_module.square_sum(g) for g in tree_leaves(grads)))),
        top=[], moved=[], shards={n: ([], []) for n in layouts})
    plain = train_module.make_optimizer(settings)
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        with torch.no_grad():
            y = {"x": p.clone()}
            y, _ = plain.update({"x": g}, plain.init(y), y, 0)
        out["top"].append(float(g.abs().max()))
        out["moved"].append(float((y["x"] - p).abs().max()))
        for name, (mesh, specs, updated) in layouts.items():
            spec = tree_leaves(specs)[i]
            out["shards"][name][0].append(tpm.shard(g, spec, mesh))
            if updated:
                out["shards"][name][1].append(tpm.shard(y["x"], spec, mesh))
        del y
    del one, params, grads, loss
    return out


def mesh_lm_held(ref, layout, grads, control=None, params=None):
    """Per leaf, this rank's shard against the one-device step's shard of
    it (``mesh_lm_reference``): the largest gradient gap and the leaf's
    largest gradient entry, the control's gap, and the updated
    parameters outside MESH_LM_UPDATE_TOL x the leaf's largest one-device
    move (a count, with the shard's size). Taken over the ranks, the
    largest gap is the gathered leaf's and the counts sum to its own."""
    g_ref, p_ref = ref["shards"][layout]
    out = []
    for i, g in enumerate(tree_leaves(grads)):
        e = dict(top=ref["top"][i], grad=float((g - g_ref[i]).abs().max()))
        if control is not None:
            e["control"] = float((tree_leaves(control)[i] - g_ref[i])
                                 .abs().max())
        if params is not None:
            bound = MESH_LM_UPDATE_TOL * ref["moved"][i]
            p = tree_leaves(params)[i]
            e["missed"] = int(((p - p_ref[i]).abs() > bound).sum())
            e["size"] = p.numel()
        out.append(e)
    return out


def mesh_lm_rank(cfg, prompts, sizes, device):
    """A rank of phase_mesh_lm: (a) the (2, 2) training cell and the
    (1, 4) gradients, each rank holding its shards to the same shards of
    the one-device step (which each rank computes in turn from the same
    parameters and batch); (b) serving on both grids. `sizes` are the
    cells' (the MESH_LM_* constants, passed so that a rehearsal may
    shrink them). Returns numbers and the serving results; the parent
    checks them."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.testing import multiprocess as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mp._device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def peak():
        return torch.cuda.max_memory_allocated(device) if cuda else 0

    rank = dist.get_rank()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    f32 = torch.float32
    settings = train_module.TrainSettings(optimizer="adamw", lr=MESH_LM_LR,
                                          zero1=True)
    shape = ShapeConfig("mesh-lm", "train", sizes["S"], sizes["B"])
    pipe = TokenPipeline(seed=SEED, batch=sizes["B"], seq_len=sizes["S"],
                         vocab_size=cfg.vocab_size, device=device)
    batches = [pipe.next() for _ in range(sizes["steps"])]
    out = dict(rank=rank, stamps=[])
    t_start = time.perf_counter()

    def stamp(what):
        """Seconds since the rank began, at the end of each part."""
        sync()
        out["stamps"].append((what, time.perf_counter() - t_start))

    # the one-device step, two ranks at a time (the others hold nothing
    # large yet; 16.9 GB a rank at its peak), kept as this rank's
    # shards of both layouts
    wide = Model(cfg, device=device, param_dtype=f32,
                 mesh=mp.lm_mesh((1, 4), device))
    model = Model(cfg, device=device, param_dtype=f32, remat="collectives",
                  mesh=mp.lm_mesh((2, 2), device))
    # (g)'s (pod, data, model) mesh, over the same group after the grids
    pod = Model(cfg, device=device, param_dtype=f32, remat="collectives",
                mesh=mp.lm_mesh(MESH_POD, device))
    mesh, tp = model.mesh, model.tp
    for turn in range(0, dist.get_world_size(), 2):
        if rank in (turn, turn + 1):
            ref = mesh_lm_reference(cfg, batches[0], device, settings, {
                "heads": (mesh, model.pspecs(), True),
                "seq": (wide.mesh, wide.pspecs(), False)})
            mp._release(device)
        dist.barrier()
    out["ref_loss"], out["ref_grad_norm"] = ref["loss"], ref["grad_norm"]
    stamp("one-device reference")

    def drawn():
        return Model(cfg, device=device, param_dtype=f32).init(SEED)

    # (a) training on (2, 2): the first step's gradients under each remat
    step_fn, opt, (_, _, pspecs, sspecs, _) = train_module.jit_train_step(
        model, shape, settings)
    params = tpm.shard_params(drawn(), pspecs, mesh)
    mp._release(device)
    rows = train_module.rank_rows(model, shape, batches[0])
    grads, runs = {}, {}
    for remat in MESH_LM_REMATS:  # the rank's gradients, before 'data'
        model.remat = remat
        before = mesh_lm_counts(mesh)
        # "full" only counts its all-reduces, which the length of the
        # rows does not change: on their first MESH_LM_FULL_S positions
        part = rows if remat != "full" else {
            k: v[:, :sizes["full_s"]] for k, v in rows.items()}
        loss, metrics, g = train_module.loss_and_grads(model, params, part)
        sync()
        runs[remat] = dict(mesh_lm_since(mesh, before), loss=float(loss))
        if remat != "full":
            grads[remat] = (loss, metrics, g)
        del g
        mp._release(device)
    out["bitwise_remat"] = runs["none"]["loss"] == runs["collectives"][
        "loss"] and all(torch.equal(a, b) for a, b in zip(
            tree_leaves(grads["none"][2]),
            tree_leaves(grads["collectives"][2])))
    del grads["none"]
    metrics, grads["step"] = train_module.sum_over_data(
        model, *grads.pop("collectives"))
    runs["collectives"]["grad_norm"] = float(metrics["grad_norm"])
    runs["collectives"]["loss"] = float(metrics["loss"])
    model.remat, tp.controls = "none", frozenset(("input_grad",))
    grads["control"] = train_module.mesh_grads(model, params, batches[0],
                                               shape, settings)[1]
    model.remat, tp.controls = "collectives", frozenset()
    out["runs"] = runs
    mp._release(device)
    stamp("gradients")

    # ZeRO-1's update; beside it, the same update unsplit over 'data' (of
    # the rank's model shard, from the same summed gradients), leaf by
    # leaf, cut to the rank's 'data' slice of the state
    state = opt.init(params)
    params, state, out["zero1_bitwise"] = mesh_zero1_update(
        opt, settings, mesh, sspecs, grads["step"], params, state)
    out["leaves"] = mesh_lm_held(ref, "heads", grads["step"],
                                 grads["control"], params)
    del grads
    mp._release(device)
    stamp("zero1 update, held")

    out["losses"], out["steps"] = [runs["collectives"]["loss"]], []
    for step in range(1, sizes["steps"]):
        # the last step with every collective timed apart, the device
        # synchronised around each (the step's breakdown)
        spent = mesh_lm_timed(mesh, sync) if step == sizes["steps"] - 1 \
            else None
        before = mesh_lm_counts(mesh)
        sync()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batches[step], step)
        out["losses"].append(float(metrics["loss"]))  # waits for the step
        sync()
        out["steps"].append(dict(mesh_lm_since(mesh, before),
                                 grad_norm=float(metrics["grad_norm"]),
                                 ms=(time.perf_counter() - t0) * 1e3,
                                 collective_ms=None if spent is None else {
                                     k: v * 1e3 for k, v in spent.items()}))
    for name in ("all_reduce", "all_gather_cat", "all_to_all_single"):
        mesh.__dict__.pop(name, None)
    del params, state
    mp._release(device)
    stamp("steps 1-2")

    # (g) the same two steps on (pod, data, model) = MESH_POD, from the
    # (2, 2) cell's batches: rank r there has the pspecs and the model
    # coordinate of rank r on (2, 2), so the one-device step's shards are
    # the 'heads' layout's
    prior = peak()
    out["pod"] = mesh_pod_cell(
        pod, tpm.shard_params(drawn(), pod.pspecs(), pod.mesh), batches,
        shape, settings, sync,
        lambda g, c, p, step=0: None if step else mesh_lm_held(
            ref, "heads", g, c, p))
    if cuda:  # the cell reset the peak: the rank's is the larger
        out["pod"]["prior_peak"] = prior
    stamp("(g) pod steps 1-2")

    # (1, 4): the kv heads replicated; the partial kv gradients' control
    whole = drawn()  # kept for serving
    params = tpm.shard_params(whole, wide.pspecs(), wide.mesh)
    wide_grads = {}
    for name, controls in (("grad", ()), ("control", ("kv_grad",))):
        wide.tp.controls = frozenset(controls)
        wide_grads[name] = train_module.mesh_grads(wide, params, batches[0],
                                                   shape, settings)[1]
        mp._release(device)
    wide.tp.controls = frozenset()
    out["wide"] = mesh_lm_held(ref, "seq", wide_grads["grad"],
                               wide_grads["control"])
    del params, wide_grads, ref
    # (g) reset the rank's peak: the larger of the two is the rank's
    out["train_peak"] = max(peak(), out.get("pod", {}).get("prior_peak", 0))
    mp._release(device)
    stamp("(1, 4) gradients")

    # (b) serving on both grids
    out["serve"] = {mode: mp.lm_job(cfg, whole, dict(
        kind="serve", grid=grid, prompts=prompts, gen_len=sizes["gen"],
        cache_len=sizes["cache"]), device)
        for mode, grid in {**MESH_LM_GRIDS, "pod": MESH_POD}.items()}
    out["peak"] = max(peak(), out["train_peak"])
    del whole
    mp._release(device)
    stamp("serving")
    return out


def mesh_zero1_update(opt, settings, mesh, sspecs, grads, params, state):
    """ZeRO-1's adamw update of the rank's shards (its 'data' slice of the
    state), beside the same update unsplit over 'data' (of the rank's
    model shard, from the same summed gradients), leaf by leaf, cut to the
    rank's 'data' slice of the state: (params, state, whether the two are
    bitwise one)."""
    from repro_torch.distributed import tensor_parallel as tpm

    first = [t.clone() for t in tree_leaves(params)]
    with torch.no_grad():
        params, state = opt.update(grads, state, params, 0)
    plain = train_module.make_optimizer(settings)
    bitwise = True
    for p0, g, p1, m, v, sm in zip(
            first, tree_leaves(grads), tree_leaves(params),
            tree_leaves(state["m"]), tree_leaves(state["v"]),
            tree_leaves(sspecs["m"])):
        with torch.no_grad():
            x = {"x": p0}
            x, st = plain.update({"x": g}, plain.init(x), x, 0)
        data_only = tuple(a if a == "data" else None for a in sm)
        bitwise &= (torch.equal(x["x"], p1) and torch.equal(
            tpm.shard(st["m"]["x"], data_only, mesh), m) and torch.equal(
            tpm.shard(st["v"]["x"], data_only, mesh), v))
        del x, st
    return params, state, bitwise


MESH_POD = (2, 1, 2)  # the (pod, data, model) grid of cells (g) and (h)


def mesh_pod_cell(model, params, batches, shape, settings, sync, held):
    """Cells (g) and (h): `model`'s first steps on the (pod, data, model)
    mesh, from `params` (the rank's shards of the seed's parameters).
    Step 1 in its parts: the rank's gradients of its rows (over ('pod',
    'data'), or ('pod', 'data', 'model') for the SSM family's layout B),
    taken once and summed over those axes twice, as the step sums them
    and under the 'pod_grad' control (the sum over 'pod' dropped: each pod
    keeps its own gradient); the ZeRO-1 update against an unsplit one
    (``mesh_zero1_update``); then `held(grads, control, params, step)`,
    this rank's gaps to the one-device step (after step 2 with no
    gradients). Step 2 through the step function,
    each collective timed apart. Returns per step the ms, the launches and
    the calls and payload by tag (the sum over 'pod' under 'pod_grads'),
    the loss and grad norm, the digests of the rank's parameter shards
    after each step (the parent holds the two pods' equal), the held gaps
    and the rank's peak over the cell."""
    from repro_torch.distributed.sharding_rules import batch_axes
    from repro_torch.testing import multiprocess as mp

    mesh, tp = model.mesh, model.tp
    device = mesh.device
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step_fn, opt, (_, _, _, sspecs, _) = train_module.jit_train_step(
        model, shape, settings)
    state = opt.init(params)
    axes = batch_axes(model.cfg, shape, mesh)
    out = dict(axes=axes, steps=[], digests=[])

    before = mesh_lm_counts(mesh)
    sync()
    t0 = time.perf_counter()
    loss, metrics, grads = train_module.loss_and_grads(
        model, params, train_module.rank_rows(model, shape, batches[0]),
        pspec_fn=train_module.mesh_pspec_fn(model, shape, settings))
    control = train_module.tree_map(torch.clone, grads)
    metrics, grads = train_module.sum_over_data(model, loss, metrics, grads,
                                                axes=axes)
    sync()
    t_grad = time.perf_counter() - t0
    grads_part = mesh_lm_since(mesh, before)
    tp.controls = frozenset(("pod_grad",))
    train_module.sum_over_data(model, loss, {}, control, axes=axes)
    tp.controls = frozenset()
    first = dict(loss=float(metrics["loss"]),
                 grad_norm=float(metrics["grad_norm"]))
    before = mesh_lm_counts(mesh)
    t0 = time.perf_counter()
    params, state, out["zero1_bitwise"] = mesh_zero1_update(
        opt, settings, mesh, sspecs, grads, params, state)
    sync()
    update_part = mesh_lm_since(mesh, before)
    out["steps"].append(dict(
        grads_part, **first,
        ms=(t_grad + time.perf_counter() - t0) * 1e3,
        **{k: dict(collections.Counter(grads_part[k])
                   + collections.Counter(update_part[k]))
           for k in ("calls", "payload")}))
    out["digests"].append(params_digest(params))
    out["held"] = held(grads, control, params)
    del grads, control
    mp._release(device)

    spent = mesh_lm_timed(mesh, sync)
    before = mesh_lm_counts(mesh)
    sync()
    t0 = time.perf_counter()
    params, state, metrics = step_fn(params, state, batches[1], 1)
    loss = float(metrics["loss"])
    sync()
    out["steps"].append(dict(mesh_lm_since(mesh, before), loss=loss,
                             grad_norm=float(metrics["grad_norm"]),
                             ms=(time.perf_counter() - t0) * 1e3,
                             collective_ms={k: v * 1e3
                                            for k, v in spent.items()}))
    for name in ("all_reduce", "all_gather_cat", "all_to_all_single"):
        mesh.__dict__.pop(name, None)
    out["digests"].append(params_digest(params))
    out["held_step2"] = held(None, None, params, step=1)
    out["peak"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    del params, state
    mp._release(device)
    return out


def mesh_lm_serve_reference(cfg, prompts, cache_len=None, gen=None):
    """The one-device port's greedy serving of `prompts` into a cache of
    `cache_len` positions (MESH_LM_CACHE), `gen` tokens (MESH_LM_GEN):
    the prefill's and each decode step's logits (B, gen, Vp), the tokens,
    and for the SSM and hybrid families (their cache built by
    ``warm_up``) the conv history and the rms gap between the prefill's
    logits and the warm-up's at the same last prompt position (the scan
    against the recurrence: the floor of full-depth mamba2's rule), on
    the host; the model freed."""
    cache_len, gen = cache_len or MESH_LM_CACHE, gen or MESH_LM_GEN
    model = Model(cfg, device=MESH_DEVICE, param_dtype=torch.float32)
    params = model.init(SEED)
    prefill, decode = make_serve_steps(model)
    with torch.no_grad():
        logits, pre = prefill(params, {"tokens": prompts})
        B, P = prompts.shape
        warm = None
        if pre is None:
            warm, cache = serve_module.warm_up(model, params, prompts,
                                               model.cache_template(
                                                   B, cache_len))
        else:
            cache = serve_module.fill_cache(model, model.cache_template(
                B, cache_len), pre, P)
        del pre
        out, tok = [logits], logits.argmax(dim=-1)
        toks = [tok]
        for i in range(gen - 1):
            pos = torch.full((B,), P + i, dtype=torch.long,
                             device=prompts.device)
            logits, cache = decode(params, cache, tok[:, None], pos)
            tok = logits.argmax(dim=-1)
            out.append(logits)
            toks.append(tok)
    res = (torch.stack(out, 1).cpu().numpy(),
           torch.stack(toks, 1).cpu().numpy())
    if warm is not None:  # the conv history, and the floor of the rule
        res += (cache["conv"].cpu().numpy(),
                float((warm - out[0]).pow(2).mean().sqrt()))
    del model, params, cache
    free_model()
    return res


MESH_MOE_EXPERTS = 8  # arctic-480b's experts in the mesh cell (of 128)
MESH_MOE_B, MESH_MOE_S, MESH_MOE_STEPS, MESH_MOE_LR = 2, 2048, 2, 3e-4
# the skewed case of the controls: the router's expert-0 column scaled,
# so that expert 0 takes more routes than its capacity on both data ranks
MESH_MOE_SKEW = 40.0
MESH_MOE_ROUTE_SHARE = 1e-3  # routes that may differ from the one device's
MESH_MOE_LAYOUTS = ("gather", "token_tp")
# the tokens each layout serves: 'gather' gathers the expert FFN over
# 'data' at every decode step (2.1-2.8 s a token on an H100 80GB HBM3 at
# 700 W), so it decodes 2
MESH_MOE_GEN = {"gather": 3, "token_tp": MESH_LM_GEN}
# the deliberately broken piece of each layout (tensor_parallel.CONTROLS)
MESH_MOE_CONTROLS = {"gather": "weight_grad", "token_tp": "expert_sum"}


def mesh_moe_cfg():
    return dataclasses.replace(ARCTIC_480B, num_layers=1,
                               num_experts=MESH_MOE_EXPERTS)


def mesh_moe_settings(layout="gather"):
    return train_module.TrainSettings(optimizer="adafactor", lr=MESH_MOE_LR,
                                      zero1=True, moe_layout=layout)


def mesh_moe_reference(cfg, batches, device, specs, mesh, settings=None):
    """The one-device port's steps from the seed's parameters under
    `settings` (the MoE cell's adafactor by default), one a batch: per
    step its loss, grad norm and routes (each MoE layer's idx and keep),
    per leaf its first gradient's largest entry and each update's largest
    move, and this rank's shards (on the host) of the first gradient and
    of the parameters after each step under every layout's specs
    (`specs`: layout -> leaf specs), each distinct shard once. The full
    trees are freed before it returns."""
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.testing import multiprocess as mp

    one = Model(cfg, device=device, param_dtype=torch.float32)
    params = one.init(SEED)
    opt = train_module.make_optimizer(settings or mesh_moe_settings())
    state = opt.init(params)
    out = dict(loss=[], grad_norm=[], routes=[], top=[], moved=[],
               shards={})

    def keep(what, i, t):
        for sp in specs.values():
            key = (what, i, tuple(sp[i]))
            if key not in out["shards"]:
                out["shards"][key] = tpm.shard(t, sp[i], mesh).cpu()

    for step, batch in enumerate(batches):
        with mp.routes_recorded() as seen:
            loss, _, grads = train_module.loss_and_grads(one, params, batch)
        out["routes"].append([(r.idx.cpu(), r.keep.cpu())
                              for _, r in seen[:cfg.num_layers]])
        del seen
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(torch.sqrt(sum(
            train_module.square_sum(g) for g in tree_leaves(grads)))))
        if step == 0:
            for i, g in enumerate(tree_leaves(grads)):
                out["top"].append(float(g.abs().max()))
                keep("grad", i, g)
        before = [p.clone() for p in tree_leaves(params)]
        with torch.no_grad():
            params, state = opt.update(grads, state, params, step)
        del grads
        out["moved"].append([float((p - b).abs().max()) for p, b in zip(
            tree_leaves(params), before)])
        del before
        for i, p in enumerate(tree_leaves(params)):
            keep(f"params{step}", i, p)
    del one, params, state
    return out


def mesh_moe_gaps(ref, what, specs, tree, bounds=None, determined=None):
    """Per leaf, the largest gap of this rank's shard in `tree` to the
    same shard of the one-device step's `what` (``mesh_moe_reference``);
    with `bounds` (per leaf) also the entries farther than the bound and
    the shard's size, and with `determined` (per leaf, a function of the
    first one-device gradient's magnitudes to a mask) the same counted
    over the entries it keeps."""
    out = []
    for i, (t, sp) in enumerate(zip(tree_leaves(tree), specs)):
        r = ref["shards"][(what, i, tuple(sp))].to(t.device)
        gap = (t - r).abs()
        e = dict(gap=float(gap.max()))
        if bounds is not None:
            over = gap > bounds[i]
            e["missed"] = int(over.sum())
            e["size"] = t.numel()
            if determined is not None:
                big = determined[i](ref["shards"][("grad", i, tuple(sp))]
                                    .to(t.device).abs())
                e["missed_det"] = int((over & big).sum())
                e["size_det"] = int(big.sum())
                del big
            del over
        out.append(e)
        del r, gap
    return out


def mesh_moe_rank(cfg, prompts, sizes, device):
    """A rank of phase_mesh_lm's arctic-480b cell, in the spawn of the
    chatglm3-6b jobs: (c) two adafactor steps on (2, 2) in each MoE
    layout, each rank holding its shards to the same shards of the
    one-device steps (which each rank computes in turn); the controls on
    a skewed router; (d) serving in each layout. Returns numbers and the
    serving results; the parent checks them."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.distributed.sharding_rules import MOE_LAYOUTS
    from repro_torch.testing import multiprocess as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mp._device(device)
    cuda = device.type == "cuda"
    mp._release(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rank = dist.get_rank()
    f32 = torch.float32
    shape = ShapeConfig("mesh-moe", "train", sizes["S"], sizes["B"])
    pipe = TokenPipeline(seed=SEED + 32, batch=sizes["B"],
                         seq_len=sizes["S"], vocab_size=cfg.vocab_size,
                         device=device)
    batches = [pipe.next() for _ in range(sizes["steps"])]
    out = dict(rank=rank, stamps=[], layouts={})
    t_start = time.perf_counter()

    def stamp(what):
        sync()
        out["stamps"].append((what, time.perf_counter() - t_start))

    models = {lay: Model(cfg, device=device, param_dtype=f32, remat="full",
                         mesh=mp.lm_mesh((2, 2), device),
                         rules_overrides=MOE_LAYOUTS[lay])
              for lay in MESH_MOE_LAYOUTS}
    mesh = models["gather"].mesh
    specs = {lay: tree_leaves(m.pspecs()) for lay, m in models.items()}
    # two ranks at a time (~21 GB each on the card)
    for turn in range(0, dist.get_world_size(), 2):
        if rank in (turn, turn + 1):
            ref = mesh_moe_reference(cfg, batches, device, specs, mesh)
            mp._release(device)
        dist.barrier()
    out["ref"] = {k: ref[k] for k in ("loss", "grad_norm", "top", "moved")}
    stamp("one-device reference")

    def drawn():
        return Model(cfg, device=device, param_dtype=f32).init(SEED)

    def routes_differ(seen, step):
        """(token, slot)s whose expert or keep differs from the one-device
        step's, over the layers."""
        n = 0
        for (probs, r), (idx, kept) in zip(seen, ref["routes"][step]):
            n += int(((r.idx.cpu() != idx) | (r.keep.cpu().view(idx.shape)
                                              != kept.view(idx.shape)))
                     .sum())
        return n

    for lay in MESH_MOE_LAYOUTS:
        model = models[lay]
        settings = mesh_moe_settings(lay)
        step_fn, opt, (_, _, pspecs, _, _) = train_module.jit_train_step(
            model, shape, settings)
        params = tpm.shard_params(drawn(), pspecs, mesh)
        mp._release(device)
        state = opt.init(params)
        res = dict(steps=[])

        # step 1 in its parts: the gradients held, the update held
        before = mesh_lm_counts(mesh)
        sync()
        t0 = time.perf_counter()
        with mp.routes_recorded() as seen:
            metrics, grads = train_module.mesh_grads(model, params,
                                                     batches[0], shape,
                                                     settings)
        sync()
        t_grad = time.perf_counter() - t0
        grads_part = mesh_lm_since(mesh, before)
        res["routes"] = mp.route_record(seen, cfg.num_layers)
        res["route_diffs"] = [routes_differ(seen, 0)]
        del seen
        res["loss"], res["grad_norm"] = (float(metrics["loss"]),
                                         float(metrics["grad_norm"]))
        res["grads"] = mesh_moe_gaps(ref, "grad", specs[lay], grads)
        # the layout's control, from the same parameters (remat 'none':
        # the same gradients as 'full', bitwise), against the one-device
        # step
        control = MESH_MOE_CONTROLS[lay]
        model.remat, model.tp.controls = "none", frozenset((control,))
        _, bad = train_module.mesh_grads(model, params, batches[0], shape,
                                         settings)
        res["controls"] = {control: [e["gap"] for e in mesh_moe_gaps(
            ref, "grad", specs[lay], bad)]}
        del bad
        model.remat, model.tp.controls = "full", frozenset()
        mp._release(device)
        before = mesh_lm_counts(mesh)
        t0 = time.perf_counter()
        with torch.no_grad():
            params, state = opt.update(grads, state, params, 0)
        sync()
        update_part = mesh_lm_since(mesh, before)
        res["steps"].append(dict(
            grads_part, loss=res["loss"],
            ms=(t_grad + time.perf_counter() - t0) * 1e3,
            **{k: dict(collections.Counter(grads_part[k])
                       + collections.Counter(update_part[k]))
               for k in ("calls", "payload")}))
        del grads
        mp._release(device)
        res["params"] = [mesh_moe_gaps(ref, "params0", specs[lay], params,
                                       [MESH_LM_UPDATE_TOL * m
                                        for m in ref["moved"][0]])]
        stamp(f"{lay} step 1")

        # step 2, each collective timed apart (the device synchronised
        # around each)
        spent = mesh_lm_timed(mesh, sync)
        before = mesh_lm_counts(mesh)
        sync()
        t0 = time.perf_counter()
        with mp.routes_recorded() as seen:
            params, state, metrics = step_fn(params, state, batches[1], 1)
        loss = float(metrics["loss"])
        sync()
        res["steps"].append(dict(mesh_lm_since(mesh, before), loss=loss,
                                 ms=(time.perf_counter() - t0) * 1e3,
                                 collective_ms={k: v * 1e3
                                                for k, v in spent.items()}))
        for name in ("all_reduce", "all_gather_cat", "all_to_all_single"):
            mesh.__dict__.pop(name, None)
        res["route_diffs"].append(routes_differ(seen, 1))
        res["step2_routes"] = mp.route_record(seen, cfg.num_layers)
        del seen
        res["params"].append(mesh_moe_gaps(ref, "params1", specs[lay],
                                           params, [MESH_LM_UPDATE_TOL * m
                                                    for m in
                                                    ref["moved"][1]]))
        del state
        mp._release(device)
        stamp(f"{lay} step 2")

        # the per-rank route (in 'token_tp', the cheaper layout), on a
        # skewed router that drops tokens, against the same router's
        # gradient
        if lay == "token_tp":
            router = params["layers"]["moe"]["router"]
            router[..., 0] *= MESH_MOE_SKEW
            model.remat = "none"
            with mp.routes_recorded() as seen:
                _, good = train_module.mesh_grads(model, params, batches[0],
                                                  shape, settings)
            res["skewed_routes"] = mp.route_record(seen, cfg.num_layers)
            del seen
            res["skewed_top"] = [float(g.abs().max())
                                 for g in tree_leaves(good)]
            model.tp.controls = frozenset(("local_route",))
            _, bad = train_module.mesh_grads(model, params, batches[0],
                                             shape, settings)
            res["local_route"] = [float((a - b).abs().max()) for a, b in zip(
                tree_leaves(bad), tree_leaves(good))]
            model.tp.controls, model.remat = frozenset(), "full"
            del good, bad, router
            stamp(f"{lay} per-rank route control")
        del params
        mp._release(device)
        out["layouts"][lay] = res
    del ref
    out["train_peak"] = (torch.cuda.max_memory_allocated(device)
                         if cuda else 0)
    mp._release(device)

    # (d) serving in each layout
    whole = drawn()
    out["serve"] = {}
    for lay in MESH_MOE_LAYOUTS:
        with mp.routes_recorded() as seen:
            out["serve"][lay] = mp.lm_job(cfg, whole, dict(
                kind="serve", grid=(2, 2), layout=lay, prompts=prompts,
                gen_len=sizes["gen"][lay], cache_len=sizes["cache"]), device)
        out["serve"][lay]["routes"] = mp.route_record(seen, len(seen))
        del seen
        mp._release(device)
    out["peak"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    del whole
    mp._release(device)
    stamp("serving")
    return out


def mesh_moe_checks(cfg, ranks, ref_logits, ref_tokens):
    """phase_mesh_lm's checks of the arctic-480b cell (the ranks' results
    of ``mesh_moe_rank``). Returns the flash launches a rank of a (2, 2)
    step and of a prefill."""
    r0 = ranks[0]
    ref = r0["ref"]
    label = (f"mesh moe {cfg.name} (1 of {ARCTIC_480B.num_layers} layers, "
             f"{cfg.num_experts} of {ARCTIC_480B.num_experts} experts, "
             "f32)")
    paths = ["/".join(p) for p in leaf_paths(
        Model(cfg, device="cpu").template)]
    T = MESH_MOE_B * MESH_MOE_S
    gaps = {}
    for lay in MESH_MOE_LAYOUTS:
        res = [r["layouts"][lay] for r in ranks]
        tag = f"{label} (2, 2) {lay}"
        # the route: the global batch's, bitwise the same on every rank
        keys = ("routes", "step2_routes") + (
            ("skewed_routes",) if "skewed_routes" in res[0] else ())
        for step_key in keys:
            for layer in range(cfg.num_layers):
                recs = [x[step_key][layer] for x in res]
                check(all(x["again"] for x in recs),
                      f"{tag}: a rank's route is not moe.route of its "
                      f"gathered probabilities ({step_key})")
                check(all(np.array_equal(x["idx"], recs[0]["idx"])
                          and np.array_equal(x["keep"], recs[0]["keep"])
                          for x in recs) and recs[0]["idx"].shape[0] == T,
                      f"{tag}: the ranks' routes differ ({step_key})")
        diffs = res[0]["route_diffs"]
        check(max(diffs) <= MESH_MOE_ROUTE_SHARE * T
              * cfg.experts_per_token,
              f"{tag}: {diffs} (token, slot)s route otherwise than on one "
              "device")
        for key in ("loss", "grad_norm"):
            want = ref[key][0]
            check(abs(res[0][key] - want) <= tol.F32_REDUCTION.obj_rel
                  * abs(want), f"{tag}: {key} {res[0][key]} against the "
                  f"one-device {want}")
        gap = [max(x["grads"][i]["gap"] for x in res) / ref["top"][i]
               for i in range(len(paths))]
        gaps[lay] = [max(x["grads"][i]["gap"] for x in res)
                     for i in range(len(paths))]
        worst = int(np.argmax(gap))
        if diffs[0] == 0:
            check(max(gap) <= MESH_LM_GRAD_TOL,
                  f"{tag}: gradient leaf {paths[worst]} off by "
                  f"{gap[worst]:.3e} of its largest")
        missed = [[sum(x["params"][s][i]["missed"] for x in res)
                   for i in range(len(paths))] for s in range(2)]
        for s in range(2):
            if sum(diffs[:s + 1]) == 0:
                check(sum(missed[s]) == 0,
                      f"{tag}: parameters after step {s + 1} outside "
                      f"{MESH_LM_UPDATE_TOL} x the one-device update: "
                      f"{dict(zip(paths, missed[s]))}")
        control = MESH_MOE_CONTROLS[lay]
        ctrl = {control: max(max(x["controls"][control][i] for x in res)
                             / ref["top"][i] for i in range(len(paths)))}
        skewed = ""
        if "skewed_routes" in res[0]:
            skew = res[0]["skewed_routes"][0]
            dropped = ~skew["keep"].reshape(T, -1).all(1)
            check(dropped.any(), f"{tag}: the skewed router drops no token")
            ctrl["local_route"] = max(
                max(x["local_route"][i] for x in res)
                / max(res[0]["skewed_top"][i], 1e-30)
                for i in range(len(paths)))
            skewed = (f"; the skewed router's load {skew['load'].tolist()}, "
                      f"dropped {int((~skew['keep']).sum())} (token, slot)s "
                      f"({int(dropped[:T // 2].sum())} tokens of data rank "
                      f"0, {int(dropped[T // 2:].sum())} of 1)")
        for name, value in ctrl.items():
            check(value > MESH_LM_GRAD_TOL,
                  f"{tag}: the {name} control stays within the rule "
                  f"({value:.3e})")
        steps = [x["steps"] for x in res]
        flash = {(s["flash"], s["flash_bwd"]) for st in steps for s in st}
        check(flash == {(2 * cfg.num_layers, cfg.num_layers)},
              f"{tag}: flash launches a rank a step {flash}, expected "
              f"{2 * cfg.num_layers} forward (remat recomputes) and "
              f"{cfg.num_layers} backward")
        losses = [st["loss"] for st in steps[0]]
        load = res[0]["routes"][0]["load"]
        log(f"{tag}, adafactor {MESH_MOE_LR} ZeRO-1, remat 'full', "
            f"{MESH_MOE_B} x {MESH_MOE_S} tokens a step: loss "
            f"{res[0]['loss']:.6f} (one device {ref['loss'][0]:.6f}), grad "
            f"norm {res[0]['grad_norm']:.6f} ({ref['grad_norm'][0]:.6f}); "
            f"routes differing from one device by step {diffs}; largest "
            f"gradient gap {gap[worst]:.3e} of its leaf's largest "
            f"({paths[worst]}); parameters outside {MESH_LM_UPDATE_TOL} x "
            f"the one-device update by step {[sum(m) for m in missed]}; "
            f"controls {ctrl}; losses {losses}; expert load step 1 "
            f"{load.tolist()} of {res[0]['routes'][0]['cap']} slots, "
            f"dropped {int((~res[0]['routes'][0]['keep']).sum())}, step 2 "
            f"{res[0]['step2_routes'][0]['load'].tolist()}, dropped "
            f"{int((~res[0]['step2_routes'][0]['keep']).sum())}{skewed}")
        log(f"{tag}: ms a step by rank "
            f"{[[round(s['ms'], 3) for s in st] for st in steps]}; flash "
            f"launches a rank a step {sorted(flash)}; calls a step by tag "
            f"(rank 0) {steps[0][-1]['calls']}; payload a step by tag "
            f"(rank 0, bytes) {steps[0][-1]['payload']}")
        last = steps[0][-1]
        log(f"{tag}: rank 0's step 2, each collective timed apart (the "
            f"device synchronised around each): {last['ms']:.3f} ms, of it "
            f"collectives by tag (ms) "
            f"{ {k: round(v, 3) for k, v in last['collective_ms'].items()} }"
            f", {sum(last['collective_ms'].values()):.3f} ms in all")
    # 'gather' against 'token_tp', through the one-device step: the sum of
    # their gaps to it within F32_REDUCTION
    loss_gap = abs(ranks[0]["layouts"]["gather"]["loss"]
                   - ranks[0]["layouts"]["token_tp"]["loss"])
    check(loss_gap <= tol.F32_REDUCTION.obj_rel * abs(ref["loss"][0]),
          f"{label}: the layouts' losses part by {loss_gap}")
    lay_gap = [(gaps["gather"][i] + gaps["token_tp"][i])
               / max(ref["top"][i], 1.0) for i in range(len(paths))]
    check(max(lay_gap) <= tol.F32_REDUCTION.w_rel,
          f"{label}: 'gather' and 'token_tp' gradients part by "
          f"{max(lay_gap):.3e} (leaf {paths[int(np.argmax(lay_gap))]})")
    log(f"{label}: 'gather' against 'token_tp': losses part by "
        f"{loss_gap:.3e}, gradients by at most {max(lay_gap):.3e} of "
        f"max(the leaf's largest, 1); each rank's seconds at the end of "
        f"each part {[[(w, round(t, 1)) for w, t in r['stamps']] for r in ranks]}"
        f"; peaks (GB) training "
        f"{[round(r['train_peak'] / 1e9, 3) for r in ranks]}, with serving "
        f"{[round(r['peak'] / 1e9, 3) for r in ranks]}")

    # (d) serving against the one-device port
    rows = MESH_LM_SERVE_B // 2
    for lay in MESH_MOE_LAYOUTS:
        tag = f"{label} serve (2, 2) {lay}"
        errs, times = [], []
        gen = MESH_MOE_GEN[lay]
        for r in ranks:
            res = r["serve"][lay]
            p = res["coordinate"][0]
            mine = slice(p * rows, (p + 1) * rows)
            want_logits = ref_logits[mine][:, :gen]
            check(np.array_equal(res["tokens"], ref_tokens[mine][:, :gen]),
                  f"{tag}: rank {r['rank']}'s greedy tokens differ from the "
                  "one-device port's")
            err = float(np.abs(res["logits"] - want_logits).max())
            check(np.allclose(res["logits"], want_logits,
                              rtol=MESH_LM_LOGIT_TOL, atol=MESH_LM_LOGIT_TOL),
                  f"{tag}: rank {r['rank']}'s logits off by {err:.3e}")
            check((res["prefill_flash"], res["decode_flash"]) ==
                  (cfg.num_layers, 0),
                  f"{tag}: flash launches {res['prefill_flash']} a prefill, "
                  f"{res['decode_flash']} in decode")
            recs = res["routes"]
            check(all(x["again"] for x in recs) and all(
                np.array_equal(x["idx"], y["idx"]) for x, y in zip(
                    recs, ranks[0]["serve"][lay]["routes"])),
                  f"{tag}: rank {r['rank']}'s routes are not the global "
                  "batch's")
            errs.append(err)
            times.append((res["prefill_s"] * 1e3,
                          res["decode_s"] * 1e3 / (gen - 1)))
        log(f"{tag}: {MESH_LM_SERVE_B} x {MESH_LM_PROMPT} prompts into "
            f"{MESH_LM_CACHE} positions, {gen - 1} greedy decode "
            f"steps, each routing the global batch; tokens identical; "
            f"largest logit gap {max(errs):.3e}; prefill ms / ms a token by "
            f"rank {[(round(a, 3), round(b, 3)) for a, b in times]}; "
            f"collectives a decode step {ranks[0]['serve'][lay]['decode_calls']}")
    return (ranks[0]["layouts"]["gather"]["steps"][-1]["flash"],
            ranks[0]["layouts"]["gather"]["steps"][-1]["flash_bwd"],
            ranks[0]["serve"]["gather"]["prefill_flash"])


MESH_SSM_S, MESH_SSM_STEPS, MESH_SSM_LR = 2048, 2, 3e-4
MESH_SSM_CUT = 6  # zamba2-7b's layers in its mesh cell (of 81): one site
# 4 x 32 through warm_up (once 64: the eager warm-up's positions cost
# 53-202 ms each on the mesh), 8 steps
MESH_SSM_PROMPT, MESH_SSM_GEN = 32, 9
# each model's cells: layout -> global batch: A the heads over 'model'
# and the rows over 'data'; B the rows over ('data', 'model')
MESH_SSM_CELLS = {"mamba2-130m": {"A": 2, "B": 4}, "zamba2-7b": {"A": 2}}
# the deliberately broken pieces of each layout (tensor_parallel.CONTROLS),
# run on mamba2-130m (zamba2-7b's layers run the same SSM code, and each
# of its control gradients would move 1.8 GB a rank through gloo)
MESH_SSM_CONTROLS = {"A": ("norm_grad", "bc_grad"), "B": ("scatter_grad",)}
# (h): mamba2-130m's layout B run on MESH_POD too, the rows over ('pod',
# 'data', 'model'), from the (2, 2) cell's batches and one-device steps
MESH_SSM_POD_CELL = "B"
ADAMW_EPS = 1e-8  # optim.optimizers.adamw's eps


def mesh_ssm_cfgs():
    """mamba2-130m at full size and zamba2-7b at full width, cut to
    MESH_SSM_CUT layers."""
    return (MAMBA2_130M,
            dataclasses.replace(ZAMBA2_7B, num_layers=MESH_SSM_CUT))


def mesh_ssm_settings():
    """The reference's production settings of both archs
    (``src/repro/launch/dryrun.py``: adamw, remat 'full'), with ZeRO-1."""
    return train_module.TrainSettings(optimizer="adamw", lr=MESH_SSM_LR,
                                      zero1=True)


def adamw_determined(delta, bound):
    """The entries whose first adamw move the gradient rule fixes within
    `bound`: a mask of the one-device gradient's magnitudes a. The move is
    lr g / (|g| + eps); a gradient within `delta` of g keeps its sign where
    a > delta and moves it by at most lr eps delta / (a - delta + eps)^2."""
    def mask(a):
        return (a > delta) & (MESH_SSM_LR * ADAMW_EPS * delta
                              <= bound * (a - delta + ADAMW_EPS) ** 2)
    return mask


def mesh_ssm_rank(cfg, prompts, sizes, device):
    """A rank of phase_mesh_lm's SSM cells, in the spawn of the chatglm3-6b
    and arctic-480b jobs, for one model: (e) per cell (``sizes["cells"]``:
    name -> global batch) two adamw steps on (2, 2) under remat 'full',
    each rank holding its shards to the same shards of the one-device
    steps (which the ranks compute two at a time), the layout's controls,
    ZeRO-1's update against an unsplit one; (f) serving through
    ``warm_up``. Returns numbers and the serving results; the parent
    checks them."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.testing import multiprocess as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mp._device(device)
    cuda = device.type == "cuda"
    mp._release(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rank = dist.get_rank()
    f32 = torch.float32
    settings = mesh_ssm_settings()
    model = Model(cfg, device=device, param_dtype=f32, remat="full",
                  mesh=mp.lm_mesh((2, 2), device))
    mesh, tp = model.mesh, model.tp
    specs = tree_leaves(model.pspecs())
    out = dict(rank=rank, stamps=[], cells={})
    pod_cell = sizes.get("pod")  # (h): the layout run on MESH_POD too
    if pod_cell:
        # rank r has the pspecs and the model coordinate of rank r on
        # (2, 2): the one-device steps' shards are the (2, 2) ones
        pod = Model(cfg, device=device, param_dtype=f32, remat="full",
                    mesh=mp.lm_mesh(MESH_POD, device))
    t_start = time.perf_counter()

    def stamp(what):
        sync()
        out["stamps"].append((what, time.perf_counter() - t_start))

    def drawn():
        return Model(cfg, device=device, param_dtype=f32).init(SEED)

    for name, B in sizes["cells"].items():
        shape = ShapeConfig("mesh-ssm", "train", sizes["S"], B)
        pipe = TokenPipeline(seed=SEED + 33, batch=B, seq_len=sizes["S"],
                             vocab_size=cfg.vocab_size, device=device)
        batches = [pipe.next() for _ in range(sizes["steps"])]
        for turn in range(0, dist.get_world_size(), 2):  # two at a time
            if rank in (turn, turn + 1):
                ref = mesh_moe_reference(cfg, batches, device,
                                         {"mesh": specs}, mesh, settings)
                mp._release(device)
            dist.barrier()
        res = dict(ref={k: ref[k] for k in ("loss", "grad_norm", "top",
                                            "moved")}, steps=[])
        stamp(f"{name} one-device reference")
        step_fn, opt, (_, _, pspecs, sspecs, _) = \
            train_module.jit_train_step(model, shape, settings)
        params = tpm.shard_params(drawn(), pspecs, mesh)
        mp._release(device)
        state = opt.init(params)

        # step 1 in its parts: the gradients held, the controls, the update
        before = mesh_lm_counts(mesh)
        sync()
        t0 = time.perf_counter()
        metrics, grads = train_module.mesh_grads(model, params, batches[0],
                                                 shape, settings)
        sync()
        t_grad = time.perf_counter() - t0
        grads_part = mesh_lm_since(mesh, before)
        first = dict(loss=float(metrics["loss"]),
                     grad_norm=float(metrics["grad_norm"]))
        res["grads"] = mesh_moe_gaps(ref, "grad", specs, grads)
        res["controls"] = {}
        for control in sizes["controls"].get(name, ()):
            # remat 'none': the same gradients as 'full', bitwise
            model.remat, tp.controls = "none", frozenset((control,))
            _, bad = train_module.mesh_grads(model, params, batches[0],
                                             shape, settings)
            res["controls"][control] = [e["gap"] for e in mesh_moe_gaps(
                ref, "grad", specs, bad)]
            del bad
            mp._release(device)
        model.remat, tp.controls = "full", frozenset()
        before = mesh_lm_counts(mesh)
        t0 = time.perf_counter()
        params, state, res["zero1_bitwise"] = mesh_zero1_update(
            opt, settings, mesh, sspecs, grads, params, state)
        sync()
        update_part = mesh_lm_since(mesh, before)
        res["steps"].append(dict(
            grads_part, **first,
            ms=(t_grad + time.perf_counter() - t0) * 1e3,
            **{k: dict(collections.Counter(grads_part[k])
                       + collections.Counter(update_part[k]))
               for k in ("calls", "payload")}))
        del grads
        mp._release(device)
        bounds = [MESH_LM_UPDATE_TOL * m for m in ref["moved"][0]]
        res["params"] = [mesh_moe_gaps(
            ref, "params0", specs, params, bounds,
            [adamw_determined(MESH_LM_GRAD_TOL * t, b)
             for t, b in zip(ref["top"], bounds)])]
        stamp(f"{name} step 1")

        # step 2 through the step function, each collective timed apart
        # (the device synchronised around each)
        spent = mesh_lm_timed(mesh, sync)
        before = mesh_lm_counts(mesh)
        sync()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batches[1], 1)
        loss = float(metrics["loss"])
        sync()
        res["steps"].append(dict(mesh_lm_since(mesh, before), loss=loss,
                                 grad_norm=float(metrics["grad_norm"]),
                                 ms=(time.perf_counter() - t0) * 1e3,
                                 collective_ms={k: v * 1e3
                                                for k, v in spent.items()}))
        for fn in ("all_reduce", "all_gather_cat", "all_to_all_single"):
            mesh.__dict__.pop(fn, None)
        res["params"].append(mesh_moe_gaps(ref, "params1", specs, params,
                                           [MESH_LM_UPDATE_TOL * m
                                            for m in ref["moved"][1]]))
        del params, state
        mp._release(device)
        out["cells"][name] = res
        stamp(f"{name} step 2")
        if name == pod_cell:
            # (h) the cell's two steps on MESH_POD, from its batches, held
            # as the (2, 2) cell is (its keys: grads, controls, params)
            def held(g, c, p, step=0):
                bounds = [MESH_LM_UPDATE_TOL * m for m in ref["moved"][step]]
                if step:
                    return mesh_moe_gaps(ref, "params1", specs, p, bounds)
                return dict(
                    grads=mesh_moe_gaps(ref, "grad", specs, g),
                    controls={"pod_grad": [e["gap"] for e in mesh_moe_gaps(
                        ref, "grad", specs, c)]},
                    params=[mesh_moe_gaps(
                        ref, "params0", specs, p, bounds,
                        [adamw_determined(MESH_LM_GRAD_TOL * t, b)
                         for t, b in zip(ref["top"], bounds)])])

            prior = torch.cuda.max_memory_allocated(device) if cuda else 0
            cell = mesh_pod_cell(
                pod, tpm.shard_params(drawn(), pod.pspecs(), pod.mesh),
                batches, shape, settings, sync, held)
            cell.update(cell.pop("held"), ref=res["ref"], prior_peak=prior)
            cell["params"].append(cell.pop("held_step2"))
            out["pod"] = cell
            stamp(f"(h) pod {name} steps 1-2")
        del ref
    out["train_peak"] = max(
        torch.cuda.max_memory_allocated(device) if cuda else 0,
        out.get("pod", {}).get("prior_peak", 0))

    # (f) serving: the prompt through warm_up on the cache's rows; (h) on
    # MESH_POD too, the rows over ('pod', 'data')
    whole = drawn()
    out["serve"] = mp.lm_job(cfg, whole, dict(
        kind="serve", grid=(2, 2), prompts=prompts, gen_len=sizes["gen"]),
        device)
    if pod_cell:
        out["serve_pod"] = mp.lm_job(cfg, whole, dict(
            kind="serve", grid=MESH_POD, prompts=prompts,
            gen_len=sizes["gen"]), device)
    out["peak"] = max(torch.cuda.max_memory_allocated(device) if cuda else 0,
                      out["train_peak"])
    del whole
    mp._release(device)
    stamp("serving")
    return out


def mesh_ssm_checks(cfg, ranks, ref_logits, ref_tokens, ref_conv, floor):
    """phase_mesh_lm's checks of an SSM model (the ranks' results of
    ``mesh_ssm_rank``): each cell on (2, 2) and, where the ranks ran it,
    (h)'s on MESH_POD (``mesh_ssm_cell_checks``, ``mesh_pod_checks``),
    then serving on the same grids (``mesh_serve_checks``). Returns the
    SSD launches (forward, backward) and flash launches (forward,
    backward) a rank of a case-A step, the SSD and flash launches a rank
    of a prefill, and (h)'s SSD launches (forward, backward) a rank a step
    and a prefill (None where it did not run)."""
    full = MAMBA2_130M if cfg.family == "ssm" else ZAMBA2_7B
    label = (f"mesh ssm {cfg.name} ({cfg.num_layers} of {full.num_layers} "
             "layers, f32)")
    paths = ["/".join(p) for p in leaf_paths(
        Model(cfg, device="cpu").template)]
    launches = {}
    for name, B in MESH_SSM_CELLS[cfg.name].items():
        controls = MESH_SSM_CONTROLS[name] if cfg.family == "ssm" else ()
        launches[name] = mesh_ssm_cell_checks(
            cfg, f"{label} (2, 2) {name}, {B} x {MESH_SSM_S}",
            [r["cells"][name] for r in ranks], paths, controls)
    log(f"{label}: each rank's seconds at the end of each part "
        f"{[[(w, round(t, 1)) for w, t in r['stamps']] for r in ranks]}; "
        f"peaks (GB) training {[round(r['train_peak'] / 1e9, 3) for r in ranks]}"
        f", with serving {[round(r['peak'] / 1e9, 3) for r in ranks]}")
    if "pod" in ranks[0]:
        name = MESH_SSM_POD_CELL
        tag = (f"{label} {MESH_POD} {name}, "
               f"{MESH_SSM_CELLS[cfg.name][name]} x {MESH_SSM_S}")
        pods = [r["pod"] for r in ranks]
        launches["pod"] = mesh_ssm_cell_checks(cfg, tag, pods, paths,
                                               ("pod_grad",))
        mesh_pod_checks(tag, pods)

    # (f) serving against the one-device port: elementwise at a cut depth;
    # at mamba2's full depth the elementwise rule is below the f32 floor
    # (ROADMAP C4), so the rms gap is held to FLOOR_FACTOR x the one-device
    # port's own gap between its scan and its recurrence at one position
    depth_cut = cfg.num_layers < full.num_layers
    rule = (f"rtol = atol = {MESH_LM_LOGIT_TOL}" if depth_cut else
            f"rms gap <= {FLOOR_FACTOR} x the floor {floor:.3e}")
    prefill = {key: mesh_serve_checks(
        cfg, f"{label} serve {grid}", grid, [r[key] for r in ranks],
        ref_logits, ref_tokens, MESH_SSM_PROMPT + MESH_SSM_GEN,
        MESH_SSM_PROMPT, MESH_SSM_GEN, rule,
        None if depth_cut else FLOOR_FACTOR * floor, ref_conv)
        for key, grid in (("serve", (2, 2)), ("serve_pod", MESH_POD))
        if key in ranks[0]}
    a = launches["A"]
    pod = ((launches["pod"][2:], prefill["serve_pod"][1])
           if "pod" in launches else None)
    return (a[2:] + a[:2], prefill["serve"][::-1], pod)


def mesh_ssm_cell_checks(cfg, tag, res, paths, controls):
    """An SSM cell on any grid (`res`: each rank's cell, from
    ``mesh_ssm_rank``'s (2, 2) steps or ``mesh_pod_cell``) held to the
    one-device steps: each step's loss and grad norm, ZeRO-1 and the
    launches (``mesh_step_checks``: 2L SSD forward and L backward, 2 flash
    forward and 1 backward a site, remat 'full' recomputing each
    forward), the gradient rule, each of `controls` outside it, step 1's
    parameters where the gradient rule fixes adamw's move. Returns the
    launches a rank a step (flash forward, backward, SSD forward,
    backward)."""
    ref = res[0]["ref"]
    L, sites = cfg.num_layers, transformer.n_attn_sites(cfg)
    got = mesh_step_checks(tag, res, [
        dict(loss=loss, grad_norm=norm, of="the one-device step")
        for loss, norm in zip(ref["loss"], ref["grad_norm"])],
        (2 * sites, sites, 2 * L, L))

    def share(step, key):
        """Per leaf, the share of its entries outside the update rule
        (over the ranks' shards); `key` 'det': of the entries whose
        one-device gradient lies beyond the gradient rule's bound."""
        sfx = "_det" if key == "det" else ""
        return [sum(x["params"][step][i]["missed" + sfx] for x in res)
                / max(sum(x["params"][step][i]["size" + sfx] for x in res), 1)
                for i in range(len(paths))]

    gap = [max(x["grads"][i]["gap"] for x in res) / ref["top"][i]
           for i in range(len(paths))]
    worst = int(np.argmax(gap))
    check(gap[worst] <= MESH_LM_GRAD_TOL,
          f"{tag}: gradient leaf {paths[worst]} off by {gap[worst]:.3e} "
          "of its largest")
    det = share(0, "det")
    check(max(det) <= MESH_LM_ADAMW_FLIPS,
          f"{tag}: parameters after step 1 outside {MESH_LM_UPDATE_TOL} "
          f"x the one-device update where the gradient rule fixes the "
          f"move ({max(det):.3e} of {paths[int(np.argmax(det))]})")
    moved = [share(s, "all") for s in range(2)]
    ctrl = {c: max(max(x["controls"][c][i] for x in res) / ref["top"][i]
                   for i in range(len(paths)))
            for c in controls}
    for c, value in ctrl.items():
        check(value > MESH_LM_GRAD_TOL,
              f"{tag}: the {c} control stays within the rule "
              f"({value:.3e})")
    log(f"{tag}, adamw {MESH_SSM_LR} ZeRO-1, remat 'full': loss and "
        f"grad norm by step "
        f"{[(round(s['loss'], 6), round(s['grad_norm'], 6)) for s in res[0]['steps']]}"
        f" (one device "
        f"{[(round(a, 6), round(b, 6)) for a, b in zip(ref['loss'], ref['grad_norm'])]}"
        f"); largest gradient gap {gap[worst]:.3e} of its leaf's "
        f"largest ({paths[worst]}); step 1's parameters "
        f"outside {MESH_LM_UPDATE_TOL} x the one-device update: the "
        f"largest share of a leaf's entries the gradient rule fixes "
        f"{max(det):.3e}, of all its entries {max(moved[0]):.3e} "
        f"({paths[int(np.argmax(moved[0]))]}); step 2's, of all "
        f"{max(moved[1]):.3e} ({paths[int(np.argmax(moved[1]))]}; "
        f"adamw's second move is lr x a ratio of each entry's two "
        f"gradients); controls "
        f"{ {c: f'{v:.3e}' for c, v in ctrl.items()} }")
    return got


def mesh_step_checks(tag, cells, want_metrics, want_launches):
    """The checks of a training cell on any grid that do not depend on
    its family (`cells`: each rank's, with its steps and its ZeRO-1
    flag): each step's loss and grad norm (rank 0's) to F32_REDUCTION of
    `want_metrics`' (whose 'of' says what they are); ZeRO-1 bitwise an
    unsplit update; the launches (flash forward, backward, SSD forward,
    backward) a rank a step `want_launches`. Logs each rank's ms a step,
    rank 0's calls and payload a step by tag and its last step's
    collectives timed apart. Returns the launches."""
    for step, want in enumerate(want_metrics):
        for key in ("loss", "grad_norm"):
            got = cells[0]["steps"][step][key]
            check(abs(got - want[key]) <= tol.F32_REDUCTION.obj_rel
                  * abs(want[key]), f"{tag}: step {step + 1}'s {key} {got} "
                  f"against {want[key]} ({want['of']})")
    check(all(c["zero1_bitwise"] for c in cells),
          f"{tag}: ZeRO-1's state slices or its parameters differ from an "
          "update unsplit over 'data' of the same summed gradients")
    got = {(s["flash"], s["flash_bwd"], s["ssd"], s["ssd_bwd"])
           for c in cells for s in c["steps"]}
    check(got == {want_launches}, f"{tag}: launches a rank a step (flash "
          f"forward, backward, SSD forward, backward) {got}, expected "
          f"{want_launches}")
    last = cells[0]["steps"][-1]
    log(f"{tag}: ms a step by rank "
        f"{[[round(s['ms'], 3) for s in c['steps']] for c in cells]}; "
        f"launches a rank a step (flash fwd, bwd, SSD fwd, bwd) "
        f"{sorted(got)}; calls a step by tag (rank 0) {last['calls']}; "
        f"payload a step by tag (rank 0, bytes) {last['payload']}; rank 0's "
        f"step 2, each collective timed apart (the device synchronised "
        f"around each): {last['ms']:.3f} ms, of it collectives by tag (ms) "
        f"{ {k: round(v, 3) for k, v in last['collective_ms'].items()} }, "
        f"{sum(last['collective_ms'].values()):.3f} ms in all; ZeRO-1 "
        f"bitwise")
    return got.pop()


def mesh_pod_checks(tag, pods):
    """What a cell on MESH_POD adds to the checks of its grid (`pods`:
    each rank's ``mesh_pod_cell`` result): the two pods' parameter shards
    bitwise equal after each step (rank r's and rank r + half's digests)
    and the sum over 'pod' run under its tag ('pod_grads'). Logs the
    batch's axes and each rank's peak over the cell."""
    half = len(pods) // 2
    for step in range(len(pods[0]["digests"])):
        check(all(pods[r]["digests"][step] == pods[r + half]["digests"][step]
                  for r in range(half)),
              f"{tag}: the two pods' parameters differ after step {step + 1}")
    check(all(p["steps"][0]["calls"].get("pod_grads", 0) > 0 for p in pods),
          f"{tag}: no gradient summed over 'pod' ('pod_grads')")
    log(f"{tag}: the rows over {pods[0]['axes']}; the pods bitwise equal "
        f"after each step; peaks over the cell (GB) "
        f"{[round(p['peak'] / 1e9, 3) for p in pods]}")


def mesh_held_checks(tag, held, paths, control):
    """A dense cell's gaps to the one-device step on any grid (`held`:
    each rank's ``mesh_lm_held`` leaves, of its shards): the gradient rule
    over each leaf's shards, the control (`control` says what it drops)
    outside it, and where the ranks held an update, the share of a leaf's
    parameters outside MESH_LM_UPDATE_TOL x its one-device update within
    MESH_LM_ADAMW_FLIPS. Returns the largest gradient gap, its leaf, the
    control's gap and the update's share (None where not held)."""
    leaves = []
    for per_rank in zip(*held):
        e = dict(top=per_rank[0]["top"], grad=max(x["grad"] for x in per_rank),
                 control=max(x["control"] for x in per_rank))
        if "missed" in per_rank[0]:
            e["missed"] = sum(x["missed"] for x in per_rank) / sum(
                x["size"] for x in per_rank)
        leaves.append(e)
    gap = [e["grad"] / e["top"] for e in leaves]
    worst = int(np.argmax(gap))
    check(gap[worst] <= MESH_LM_GRAD_TOL,
          f"{tag}: gradient leaf {paths[worst]} off by {gap[worst]:.3e} of "
          "its largest")
    ctrl = max(e["control"] / e["top"] for e in leaves)
    check(ctrl > MESH_LM_GRAD_TOL,
          f"{tag}: {control} stays within the rule ({ctrl:.3e})")
    upd = None
    if "missed" in leaves[0]:
        upd = max(e["missed"] for e in leaves)
        check(upd <= MESH_LM_ADAMW_FLIPS,
              f"{tag}: parameters after the update outside "
              f"{MESH_LM_UPDATE_TOL} x the one-device update ({upd:.3e} of "
              "a leaf)")
    return gap[worst], paths[worst], ctrl, upd


def mesh_serve_checks(cfg, tag, grid, results, ref_logits, ref_tokens, S,
                      prompt, gen, rule, rms_limit=None, ref_conv=None):
    """Serving on `grid` ((data, model) or (pod, data, model)) against the
    one-device port (`ref_logits`, `ref_tokens`, for the SSM family
    `ref_conv`, the conv history): each rank's rows (its block over
    ``serve.serve_row_axes``) get the one-device tokens, their logits
    within MESH_LM_LOGIT_TOL (or with `rms_limit` an rms gap within it),
    each rank's cache the shape ``cache_pspecs`` gives, and the flash and
    SSD launches a prefill (none in the warm-up and decode). Logs the
    prefill's ms, the SSM and hybrid families' warm-up ms a position and
    the ms a token. Returns rank 0's flash and SSD launches a prefill."""
    B = MESH_LM_SERVE_B
    sizes = dict(zip(("pod", "data", "model")[-len(grid):], grid))
    layout = Model(cfg, device="cpu", mesh=sizes)
    shape = ShapeConfig("mesh-serve", "decode", S, B)
    specs = layout.cache_pspecs(shape)
    whole = Model(cfg, device="cpu").cache_template(B, S, device="meta")
    want_shapes = {k: tuple(n // split_size(sizes, a)
                            for n, a in zip(whole[k].shape, specs[k]))
                   for k in whole}
    row_axes = serve_module.serve_row_axes(layout, shape)
    rows = B // split_size(sizes, row_axes)
    L = cfg.num_layers
    ssm = cfg.family in ("ssm", "hybrid")
    sites = transformer.n_attn_sites(cfg) if cfg.family == "hybrid" else (
        0 if ssm else L)
    want = (L if ssm else 0, sites, 0, 0, 0, 0)
    errs, rms, times = [], [], []
    for res in results:
        k = res["row_block"]
        mine = slice(k * rows, (k + 1) * rows)
        who = f"rank at {res['coordinate']}"
        check(np.array_equal(res["tokens"], ref_tokens[mine]),
              f"{tag}: {who}'s greedy tokens differ from the one-device "
              "port's")
        d = np.abs(res["logits"] - ref_logits[mine])
        errs.append(float(d.max()))
        rms.append(float(np.sqrt((d.astype(np.float64) ** 2).mean())))
        if rms_limit is None:
            check(np.allclose(res["logits"], ref_logits[mine],
                              rtol=MESH_LM_LOGIT_TOL, atol=MESH_LM_LOGIT_TOL),
                  f"{tag}: {who}'s logits off by {errs[-1]:.3e}")
        else:
            check(rms[-1] <= rms_limit, f"{tag}: {who}'s logits' rms gap "
                  f"{rms[-1]:.3e} > {rms_limit:.3e}")
        if ref_conv is not None:
            check(np.allclose(res["conv"], ref_conv[:, mine],
                              rtol=MESH_LM_LOGIT_TOL, atol=MESH_LM_LOGIT_TOL),
                  f"{tag}: {who}'s conv history is not the one-device "
                  "cache's")
        check(res["cache_shapes"] == want_shapes,
              f"{tag}: {who}'s cache {res['cache_shapes']}, cache_pspecs "
              f"gives {want_shapes}")
        got = (res["prefill_ssd"], res["prefill_flash"], res["warm_ssd"],
               res["warm_flash"], res["decode_ssd"], res["decode_flash"])
        check(got == want, f"{tag}: SSD and flash launches a prefill, "
              f"warm-up and decode {got}, expected {want}")
        times.append((res["prefill_s"] * 1e3,)
                     + ((res["warm_s"] * 1e3 / prompt,) if ssm else ())
                     + (res["decode_s"] * 1e3 / (gen - 1),))
    log(f"{tag}: {B} x {prompt} prompts into {S} positions, a rank's rows "
        f"{rows} (over {row_axes}){', through warm_up' if ssm else ''}, "
        f"{gen - 1} greedy decode steps; a rank's cache {want_shapes}; "
        f"tokens identical; logit gaps ({rule}; max|logits| "
        f"{float(np.abs(ref_logits).max()):.3f}) max {max(errs):.3e}, rms "
        f"{max(rms):.3e}; prefill ms"
        f"{' / warm-up ms a position' if ssm else ''} / ms a token by rank "
        f"{[tuple(round(x, 3) for x in t) for t in times]}; collectives a "
        f"decode step {results[0]['decode_calls']}")
    return results[0]["prefill_flash"], results[0]["prefill_ssd"]


def phase_mesh_lm():
    """The LM stack over a (data x model) mesh of 4 ranks sharing the
    card (see the module docstring, 30 and 31). Returns the flash
    launches a rank of chatglm3-6b's (2, 2) step and of its prefill, and
    of arctic-480b's."""
    from repro_torch.testing import multiprocess as mp

    cfg = mesh_lm_cfg()
    moe_cfg = mesh_moe_cfg()
    ssm_cfgs = mesh_ssm_cfgs()
    gen = torch.Generator(device=MESH_DEVICE).manual_seed(SEED + 31)
    prompts = torch.randint(0, cfg.vocab_size,
                            (MESH_LM_SERVE_B, MESH_LM_PROMPT),
                            generator=gen, device=MESH_DEVICE)
    moe_prompts = torch.randint(0, moe_cfg.vocab_size,
                                (MESH_LM_SERVE_B, MESH_LM_PROMPT),
                                generator=gen, device=MESH_DEVICE)
    ssm_prompts = [torch.randint(0, c.vocab_size,
                                 (MESH_LM_SERVE_B, MESH_SSM_PROMPT),
                                 generator=gen, device=MESH_DEVICE)
                   for c in ssm_cfgs]
    ref_logits, ref_tokens = mesh_lm_serve_reference(cfg, prompts)
    moe_ref = mesh_lm_serve_reference(moe_cfg, moe_prompts)
    ssm_refs = [mesh_lm_serve_reference(
        c, p, MESH_SSM_PROMPT + MESH_SSM_GEN, MESH_SSM_GEN)
        for c, p in zip(ssm_cfgs, ssm_prompts)]
    prompts = prompts.cpu().numpy()
    moe_prompts = moe_prompts.cpu().numpy()
    t0 = time.perf_counter()
    launch = mp.launch_coordinated(
        mp.rank_batch, 4,
        ([(mesh_lm_rank, (cfg, prompts, dict(
            B=MESH_LM_B, S=MESH_LM_S, steps=MESH_LM_STEPS, gen=MESH_LM_GEN,
            cache=MESH_LM_CACHE, full_s=MESH_LM_FULL_S), MESH_DEVICE)),
          (mesh_moe_rank, (moe_cfg, moe_prompts, dict(
              B=MESH_MOE_B, S=MESH_MOE_S, steps=MESH_MOE_STEPS,
              gen=MESH_MOE_GEN, cache=MESH_LM_CACHE), MESH_DEVICE))]
         + [(mesh_ssm_rank, (c, p.cpu().numpy(), dict(
             cells=MESH_SSM_CELLS[c.name], S=MESH_SSM_S,
             steps=MESH_SSM_STEPS, gen=MESH_SSM_GEN,
             controls=MESH_SSM_CONTROLS if c.family == "ssm" else {},
             pod=MESH_SSM_POD_CELL if c.family == "ssm" else None),
             MESH_DEVICE))
            for c, p in zip(ssm_cfgs, ssm_prompts)],),
        backend="gloo", timeout=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    check(launch.exit_codes == {} and not launch.errors,
          f"mesh lm: ranks died or raised: {launch.exit_codes}"
          + raised(launch))
    ranks = [r[0] for r in launch.results]
    moe = mesh_moe_checks(moe_cfg, [r[1] for r in launch.results],
                          *moe_ref)
    ssm = {c.name: mesh_ssm_checks(c, [r[2 + i] for r in launch.results],
                                   *ssm_refs[i])
           for i, c in enumerate(ssm_cfgs)}
    r0 = ranks[0]
    label = (f"mesh lm {cfg.name} ({MESH_LM_CUT} of "
             f"{CHATGLM3_6B.num_layers} layers, f32)")
    log(f"{label}: one spawn of 4 gloo ranks on one card, {spawn_s:.1f} s; "
        f"the last rank up at "
        f"{max(st['entered'] for st in launch.stamps):.1f} s")

    # (a) the first step against the one-device step: each leaf's gaps
    # taken over the ranks' shards, its missed updates summed over them
    paths = ["/".join(p) for p in leaf_paths(
        Model(cfg, device="cpu").template)]
    runs = r0["runs"]
    coll = runs["collectives"]
    for key in ("loss", "grad_norm"):
        want = r0[f"ref_{key}"]
        check(abs(coll[key] - want) <= tol.F32_REDUCTION.obj_rel * abs(want),
              f"{label} (2, 2): {key} {coll[key]} against the one-device "
              f"{want}")
    gap, leaf, ctrl, upd = mesh_held_checks(
        f"{label} (2, 2)", [r["leaves"] for r in ranks], paths,
        "the input collective's backward dropped")
    check(all(r["zero1_bitwise"] for r in ranks),
          f"{label} (2, 2): ZeRO-1's state slices or its parameters differ "
          "from an update unsplit over 'data' of the same summed gradients, "
          f"on ranks {[r['rank'] for r in ranks if not r['zero1_bitwise']]}")
    check(all(r["bitwise_remat"] for r in ranks),
          f"{label} (2, 2): remat 'collectives' is not bitwise 'none'")

    def all_reduces(run):
        return sum(v for k, v in run["calls"].items()
                   if k not in ("gather",))

    check(coll["calls"] == runs["none"]["calls"]
          and all_reduces(coll) < all_reduces(runs["full"]),
          f"{label} (2, 2): all-reduces a gradient: collectives "
          f"{all_reduces(coll)}, none {all_reduces(runs['none'])}, full "
          f"{all_reduces(runs['full'])}")
    check(r0["losses"][-1] < r0["losses"][0],
          f"{label} (2, 2): the loss does not fall: {r0['losses']}")
    wgap, wleaf, wctrl, _ = mesh_held_checks(
        f"{label} (1, 4)", [r["wide"] for r in ranks], paths,
        "the kv weights' partial gradients unsummed")
    steps = [r["steps"] for r in ranks]
    flash = {(s["flash"], s["flash_bwd"]) for st in steps for s in st}
    check(flash == {(2 * MESH_LM_CUT, MESH_LM_CUT)},
          f"{label} (2, 2): flash launches a rank a step {flash}, expected "
          f"{2 * MESH_LM_CUT} forward (remat recomputes) and {MESH_LM_CUT} "
          "backward")
    log(f"{label} (2, 2), adamw {MESH_LM_LR} ZeRO-1, remat 'collectives', "
        f"{MESH_LM_B} x {MESH_LM_S} tokens a step: loss {coll['loss']:.6f} "
        f"(one device {r0['ref_loss']:.6f}), grad norm "
        f"{coll['grad_norm']:.6f} ({r0['ref_grad_norm']:.6f}); largest "
        f"gradient gap {gap:.3e} of its leaf's largest "
        f"({leaf}), the control's {ctrl:.3e}; the largest "
        f"share of a leaf's parameters outside {MESH_LM_UPDATE_TOL} x its "
        f"one-device update {upd:.3e}; ZeRO-1 "
        f"bitwise; remat 'collectives' bitwise 'none'; losses "
        f"{', '.join(f'{x:.6f}' for x in r0['losses'])}")
    log(f"{label} (2, 2): 'model' all-reduces a rank's gradient none "
        f"{all_reduces(runs['none'])}"
        f", collectives {all_reduces(coll)}, full "
        f"{all_reduces(runs['full'])}; flash launches a rank a step "
        f"{sorted(flash)} (forward, backward); ms a step by rank "
        f"{[[round(s['ms'], 3) for s in st] for st in steps]}; payload a "
        f"step by tag (rank 0, bytes) {steps[0][-1]['payload']}; peaks "
        f"(GB) training {[round(r['train_peak'] / 1e9, 3) for r in ranks]}, "
        f"with serving {[round(r['peak'] / 1e9, 3) for r in ranks]}")
    last = steps[0][-1]
    log(f"{label} (2, 2): rank 0's last step, each collective "
        f"timed apart (the device synchronised around each): {last['ms']:.3f}"
        f" ms, of it collectives by tag (ms) "
        f"{ {k: round(v, 3) for k, v in last['collective_ms'].items()} }, "
        f"{sum(last['collective_ms'].values()):.3f} ms in all")
    log(f"{label}: each rank's seconds at the end of each part "
        f"{[[(w, round(t, 1)) for w, t in r['stamps']] for r in ranks]}")
    log(f"{label} (1, 4), kv heads replicated: largest gradient gap "
        f"{wgap:.3e} ({wleaf}), the unsummed kv control's "
        f"{wctrl:.3e}")

    # (g) the (2, 2) cell's steps on MESH_POD, held to the same one-device
    # step (its first) and to the (2, 2) cell's second step
    tag = f"{label} {MESH_POD}"
    pods = [r["pod"] for r in ranks]
    pgap, pleaf, pctrl, pupd = mesh_held_checks(
        tag, [p["held"] for p in pods], paths, "the pod_grad control")
    plosses = [s_["loss"] for s_ in pods[0]["steps"]]
    check(plosses[-1] < plosses[0], f"{tag}: the loss does not fall: "
          f"{plosses}")
    pod_launches = mesh_step_checks(tag, pods, [
        dict(loss=r0["ref_loss"], grad_norm=r0["ref_grad_norm"],
             of="the one-device step"),
        dict(loss=r0["losses"][1], grad_norm=steps[0][-1]["grad_norm"],
             of="the (2, 2) cell's step 2")], (2 * MESH_LM_CUT, MESH_LM_CUT,
                                              0, 0))
    mesh_pod_checks(tag, pods)
    log(f"{tag}, adamw {MESH_LM_LR} ZeRO-1 over 'data' (one rank: the whole "
        f"state on each rank of a pod), remat 'collectives', {MESH_LM_B} x "
        f"{MESH_LM_S} tokens a step: loss and grad norm by step "
        f"{[(round(s_['loss'], 6), round(s_['grad_norm'], 6)) for s_ in pods[0]['steps']]}"
        f" (one device {r0['ref_loss']:.6f}, {r0['ref_grad_norm']:.6f}); "
        f"largest gradient gap {pgap:.3e} of its leaf's largest "
        f"({pleaf}), the pod_grad control's {pctrl:.3e}; the "
        f"largest share of a leaf's parameters outside {MESH_LM_UPDATE_TOL} "
        f"x its one-device update {pupd:.3e}")

    # (b) serving against the one-device port, on both grids and (g)'s
    prefill = {mode: mesh_serve_checks(
        cfg, f"{label} serve {'heads' if mode == 'pod' else mode} {grid}",
        grid, [r["serve"][mode] for r in ranks], ref_logits, ref_tokens,
        MESH_LM_CACHE, MESH_LM_PROMPT, MESH_LM_GEN,
        f"rtol = atol = {MESH_LM_LOGIT_TOL}")[0]
        for mode, grid in {**MESH_LM_GRIDS, "pod": MESH_POD}.items()}
    return ((steps[0][-1]["flash"], steps[0][-1]["flash_bwd"],
             prefill["seq"]) + moe
            + (ssm, dict(flash=pod_launches[0], flash_bwd=pod_launches[1],
                         prefill=prefill["pod"])))


def flash_training_records(flash_record, bwd_record, train_fwd, train,
                           dense_train, moe_train, moe_exact):
    """Fill the flash records' launches on the training paths (f32 dense,
    hybrid and the MoE exactness cells: the wgmma-f32 forward route, with
    lse; bf16 MoE: the wgmma route; the backward on both) and log the
    kernels' share of each step. A micro-batch's launches of each
    path."""
    f32_cells = {**{train[m]["name"]: train[m] for m in ("gemma2", "zamba2")},
                 **dense_train}
    by_path = {f"{name} train step": cell["launches"][2]
               for name, cell in f32_cells.items()}
    by_path.update({f"{name} exactness (f32)": cell["launches"][2]
                    for name, cell in moe_exact.items()})
    f32_rec = flash_record["f32"]
    f32_rec["launches"] = train["gemma2"]["launches"][2]
    f32_rec["launches_by_path"] = by_path
    f32_rec["training"] = train_fwd
    flash_record["launches_by_path"].update({
        f"{name} train step (bf16, remat)": cell["launches"][2]
        for name, cell in moe_train.items()})
    bwd_record["launches"] = train["gemma2"]["launches"][3]
    bwd_record["launches_by_path"] = {
        **{f"{name} train step": cell["launches"][3]
           for name, cell in {**f32_cells, **moe_train}.items()},
        **{f"{name} exactness (f32)": cell["launches"][3]
           for name, cell in moe_exact.items()}}
    glm = dense_train["chatglm3-6b"]
    glm_ms = bwd_record["shapes"]["chatglm3-6b training layer float32"]["ms"]
    log(f"train chatglm3-6b flash backward share of a step "
        f"({glm['step_ms']:.3f} ms): {glm['launches'][3]} x {glm_ms:.4f} ms "
        f"= {glm['launches'][3] * glm_ms:.3f} ms "
        f"({glm['launches'][3] * glm_ms / glm['step_ms']:.2%})")
    # a layer's kernel ms at the training shapes (gemma2: half its layers
    # local, half global)
    shapes = dict(bwd_record["shapes"],
                  **{"gemma2 global training layer float32": bwd_record})
    bwd_ms = {"gemma2": np.mean([shapes[f"gemma2 {w} training layer "
                                        "float32"]["ms"]
                                 for w in ("local", "global")]),
              "zamba2": shapes["zamba2 training layer float32"]["ms"]}
    fwd_ms = {"gemma2": np.mean([train_fwd[f"gemma2 {w} training layer"]
                                 ["ms"] for w in ("local", "global")]),
              "zamba2": train_fwd["zamba2 training layer"]["ms"]}
    for m, cell in ((m, train[m]) for m in ("gemma2", "zamba2")):
        b_ms = cell["launches"][3] * bwd_ms[m]
        log(f"train {cell['name']} flash backward share of a step "
            f"({cell['step_ms']:.3f} ms): {cell['launches'][3]} x "
            f"{bwd_ms[m]:.4f} ms = {b_ms:.3f} ms "
            f"({b_ms / cell['step_ms']:.2%})"
            + f"; f32 forward {cell['launches'][2]} x {fwd_ms[m]:.4f} ms "
              f"({cell['launches'][2] * fwd_ms[m] / cell['step_ms']:.2%})")


def timed_phase(seconds, phase, *args):
    """phase(*args), its wall seconds logged on a line of their own and
    kept in `seconds` by name (so the run's time limit can be read phase by
    phase)."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        seconds[phase.__name__] = time.perf_counter() - t0
        log(f"phase {phase.__name__}: {seconds[phase.__name__]:.1f} s")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA "
             "device")
    adopt_orphans()
    try:
        card, kernels = run()
    finally:
        stop_descendants()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run():
    """Every phase in order; returns the card line and the kernels'
    records."""
    # full f32 GEMVs and no TF32 anywhere in the port
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    seconds = {}  # wall seconds by phase, in the order run
    libs = kbuild.build_all([kernel_build.SOURCE, *flash_build.SOURCES,
                             *ssd_build.SOURCES])
    log(f"built {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, together)")
    for lib in libs:
        report = kbuild.compiler_report(lib)
        for line in report:
            log(f"  nvcc {lib.name}: {line}")
        lost = [line for line in report if "Performance Loss" in line
                or re.search(r"[1-9]\d* bytes spill", line)]
        check(not lost, f"{lib.name}: ptxas spills or serialises wgmma: "
              f"{lost[:4]}")

    record = timed_phase(seconds, phase_kernel)
    timed_phase(seconds, phase_small)
    cfg = TABLE1_250K_18K
    X, y, w, launches, ms_c = timed_phase(seconds, phase_table1, cfg)
    record["launches"] = launches
    log(f"table1 kernel share of a cuda-backend iteration: "
        f"{record['ms']:.4f} / {ms_c:.3f} ms = {record['ms'] / ms_c:.4%}")
    timed_phase(seconds, phase_breakdown, cfg, X, y, w)
    del X, y, w  # free the 18 GB before the next phase
    torch.cuda.empty_cache()

    X, y = timed_phase(seconds, phase_tiled_plane, cfg)
    timed_phase(seconds, phase_radisa_kernel)
    timed_phase(seconds, phase_radisa_async, cfg, X, y)
    timed_phase(seconds, phase_resumable, cfg, X, y)
    timed_phase(seconds, phase_elastic, cfg, X, y)
    ms_static = timed_phase(seconds, phase_streaming_anchor, cfg, X, y)
    mesh_refs = timed_phase(seconds, phase_mesh_refs, cfg, X, y)
    elastic_refs = timed_phase(seconds, phase_mesh_elastic_refs, cfg, X, y)
    del X, y  # free the 18 GB before the mesh, streaming and serving phases
    torch.cuda.empty_cache()
    timed_phase(seconds, phase_mesh, cfg, mesh_refs)
    timed_phase(seconds, phase_nccl)
    timed_phase(seconds, phase_mesh_elastic_streaming, cfg, elastic_refs)
    timed_phase(seconds, phase_streaming, cfg, ms_static)

    flash_record, times = timed_phase(seconds, phase_flash)
    timed_phase(seconds, phase_cut_depth)
    torch.cuda.empty_cache()
    flash_record["launches"], prefill_ms = timed_phase(seconds, phase_serve)
    n_local = GEMMA2_9B.num_layers // 2
    kernel_ms = n_local * (times["local"][0] + times["global"][0])
    log(f"serve flash kernel share of the prefill: {n_local} x "
        f"({times['local'][0]:.4f} + {times['global'][0]:.4f}) ms = "
        f"{kernel_ms:.3f} / {prefill_ms:.3f} ms = "
        f"{kernel_ms / prefill_ms:.2%}")

    torch.cuda.empty_cache()
    timed_phase(seconds, phase_dense_cut_depth)
    dense = timed_phase(seconds, phase_dense_serve)
    dense_flash_records(flash_record, dense)
    timed_phase(seconds, phase_moe_routing)
    free_model()
    timed_phase(seconds, phase_moe_cut_depth)
    moe_cells = timed_phase(seconds, phase_moe_serve)
    moe_flash_records(flash_record, moe_cells)

    torch.cuda.empty_cache()
    ssd_record = timed_phase(seconds, phase_ssd)
    timed_phase(seconds, phase_ssm_f32)
    torch.cuda.empty_cache()
    ssd_record["launches"], ssm_prefill_ms = timed_phase(seconds, phase_ssm_serve)
    ssd_ms = ssd_record["launches"] * ssd_record["ms"]
    log(f"mamba2 serve ssd kernel share of the prefill: "
        f"{ssd_record['launches']} x {ssd_record['ms']:.4f} ms = "
        f"{ssd_ms:.3f} / {ssm_prefill_ms:.3f} ms = "
        f"{ssd_ms / ssm_prefill_ms:.2%}")

    torch.cuda.empty_cache()
    timed_phase(seconds, phase_hybrid_f32)
    torch.cuda.empty_cache()
    hybrid = timed_phase(seconds, phase_hybrid_serve)
    z_flash = flash_record["head_dims"]["112"]
    z_ssd = ssd_record["shapes"]["zamba2 layer"]
    z_flash["launches"], z_ssd["launches"] = hybrid["flash"], hybrid["ssd"]
    flash_record["launches_by_path"] = {
        "gemma2-9b serve": flash_record["launches"],
        "zamba2-7b serve": hybrid["flash"],
        **{f"{name} serve": cell["launches"]
           for name, cell in {**dense, **moe_cells}.items()}}
    ssd_record["launches_by_path"] = {
        "mamba2-130m serve": ssd_record["launches"],
        "zamba2-7b serve": hybrid["ssd"]}
    f_ms = hybrid["flash"] * z_flash["ms"]
    s_ms = hybrid["ssd"] * z_ssd["ms"]
    log(f"zamba2 serve kernel shares of the 4 x {HYB_PROMPT} prefill "
        f"({hybrid['prefill_ms']:.3f} ms): flash {hybrid['flash']} x "
        f"{z_flash['ms']:.4f} ms = {f_ms:.3f} ms ({f_ms / hybrid['prefill_ms']:.2%}), "
        f"ssd {hybrid['ssd']} x {z_ssd['ms']:.4f} ms = {s_ms:.3f} ms "
        f"({s_ms / hybrid['prefill_ms']:.2%})")

    torch.cuda.empty_cache()
    bwd_record = timed_phase(seconds, phase_ssd_backward)
    torch.cuda.empty_cache()
    flash_bwd_record, flash_train_fwd = timed_phase(seconds, phase_flash_backward)
    torch.cuda.empty_cache()
    train = timed_phase(seconds, phase_train)
    fwd, bwd = train["launches"][:2]
    ssd_record["launches_by_path"]["mamba2-130m train step"] = fwd
    ssd_record["f32"]["launches"] = fwd  # every one on the wgmma-f32 route
    ssd_record["f32"]["launches_by_path"] = {"mamba2-130m train step": fwd}
    bwd_record["launches"] = bwd
    bwd_record["launches_by_path"] = {
        "mamba2-130m train step": bwd,
        "mamba2-130m (12 of 24 layers) SODDA-SVRG, 20 steps":
            train["sodda_launches"][1]}
    ssd_record["backward"] = bwd_record
    log(f"train ssd kernel share of a step ({train['step_ms']:.3f} ms): "
        f"{fwd} forward launches (f32, the wgmma-f32 route) and {bwd} x "
        f"{bwd_record['ms']:.4f} ms backward = "
        f"{bwd * bwd_record['ms']:.3f} ms "
        f"({bwd * bwd_record['ms'] / train['step_ms']:.2%}) in backward")

    torch.cuda.empty_cache()
    dense_train = timed_phase(seconds, phase_train_dense_stack)
    moe_train = timed_phase(seconds, phase_train_moe)
    moe_exact = timed_phase(seconds, phase_train_moe_exact)
    flash_training_records(flash_record, flash_bwd_record, flash_train_fwd,
                           train, dense_train, moe_train, moe_exact)
    torch.cuda.empty_cache()
    (mesh_fwd, mesh_bwd, mesh_prefill, moe_fwd, moe_bwd, moe_prefill,
     ssm, pod) = timed_phase(seconds, phase_mesh_lm)
    (m_ssd, m_ssd_bwd, _, _), (m_pre, _), m_pod = ssm["mamba2-130m"]
    (z_ssd, z_ssd_bwd, z_fl, z_fl_bwd), (z_pre, z_pre_fl), _ = ssm[
        mesh_ssm_cfgs()[1].name]
    (m_pod_ssd, m_pod_ssd_bwd), m_pod_pre = m_pod
    flash_record["f32"]["launches_by_path"].update({
        "chatglm3-6b mesh (2, 2) train step, a rank": mesh_fwd,
        "chatglm3-6b mesh prefill, a rank": mesh_prefill,
        "arctic-480b mesh (2, 2) train step, a rank": moe_fwd,
        "arctic-480b mesh prefill, a rank": moe_prefill,
        "zamba2-7b mesh (2, 2) train step, a rank, (1, 16, 16, 2048, 112)":
            z_fl,
        "zamba2-7b mesh prefill, a rank": z_pre_fl,
        f"chatglm3-6b mesh {MESH_POD} train step, a rank": pod["flash"],
        f"chatglm3-6b mesh {MESH_POD} prefill, a rank": pod["prefill"]})
    flash_bwd_record["launches_by_path"].update({
        "chatglm3-6b mesh (2, 2) train step, a rank": mesh_bwd,
        "arctic-480b mesh (2, 2) train step, a rank": moe_bwd,
        "zamba2-7b mesh (2, 2) train step, a rank, (1, 16, 16, 2048, 112)":
            z_fl_bwd,
        f"chatglm3-6b mesh {MESH_POD} train step, a rank": pod["flash_bwd"]})
    ssd_record["f32"]["launches_by_path"].update({
        "mamba2-130m mesh (2, 2) train step, a rank, H = 12": m_ssd,
        "zamba2-7b mesh (2, 2) train step, a rank, H = 56": z_ssd,
        "mamba2-130m mesh prefill, a rank, H = 12": m_pre,
        "zamba2-7b mesh prefill, a rank, H = 56": z_pre,
        f"mamba2-130m mesh {MESH_POD} train step, a rank, H = 24": m_pod_ssd,
        f"mamba2-130m mesh {MESH_POD} prefill, a rank, H = 12": m_pod_pre})
    bwd_record["launches_by_path"].update({
        "mamba2-130m mesh (2, 2) train step, a rank, H = 12": m_ssd_bwd,
        "zamba2-7b mesh (2, 2) train step, a rank, H = 56": z_ssd_bwd,
        f"mamba2-130m mesh {MESH_POD} train step, a rank, H = 24":
            m_pod_ssd_bwd})
    log("seconds by phase: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in seconds.items())
        + f"; {sum(seconds.values()):.1f} s in the phases, "
        f"{time.perf_counter() - t0:.1f} s since the build started")
    return card, [record, flash_record, ssd_record, flash_bwd_record]


if __name__ == "__main__":
    main()

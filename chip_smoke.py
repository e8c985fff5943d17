#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. It drives the port only — nothing of JAX or of
`paddle_tpu` — in twenty-seven phases, two of multi-step dispatch (18b,
18c), one of generation and serving (20), one of nested sequences and
the structured heads (21), one of beam and speculative decode over the
paged KV pool (22), one of the layer tail, the VAE and GAN and the v1
front end (23), one of the flight recorder and the fleet (24), one of
the custom ops and export (25), one of the mesh (26), one of the
v1-era runtime (27), one of head dim 256 (28), one of the op framework
(29), seven that run its paths or its kernels' forms under the bf16
flag (3b, 5b, 6c, 6d, 7b, 9c, 13b) and one of the flash kernels at head
dims above 128 (3c), and any failure exits non-zero:

1. the card (`nvidia-smi` name and power limit), torch and CUDA
   versions; TF32 off;
2. builds every kernel from `paddle_tpu_torch/csrc` (one nvcc per
   source, in parallel) and prints the build seconds and ptxas report;
3. holds the flash-attention kernel against its plain PyTorch version
   on the card at eleven shapes, four of them the prefill shapes of
   phase 4, one phase 22's beam and speculative prefill (B=4, T=1024,
   kv_len 9, 960, 500, 64) and one LM (b)'s training forward of phase 6
   (max |diff| <= 1e-4
   on out and on the lse of rows with a visible key: f32 with another
   summation order; rows with no visible key exactly out == 0 and lse
   == 1e30; bit-identical on a repeat), and times
   kernel, plain version and `scaled_dot_product_attention` (a
   yardstick only — the port never calls it);
3b. holds the kernel's bf16 form against its bf16 plain version at the
   same ten shapes, the long-context trainer's (B=4, T=4096, H=8,
   D=64, causal) and the edges of its 128-row tiles at D = 32, 64, 96
   and 128 (`BF16_EDGE_SHAPES`: T = 127, 129, 200, kv_len mid-tile,
   Tq != Tk with q_len and a kv_len = 0 row, K and V rows past kv_len
   holding NaN): out element by element within one bf16 ulp plus
   2e-3 of the largest entry, lse within 1e-4, rows with no visible key
   exactly out 0 and lse 1e30, bit-identical on a repeat, only the bf16
   form launched, and no farther from the f32 plain version on the same
   inputs than the bf16 plain version is (within an ulp); times it, the
   bf16 plain version and SDPA on bf16 with is_causal and no mask (a
   yardstick) beside the bound (bf16 bytes; one pass at 989 TFLOP/s);
3c. holds the D-split forms (head dim > 128, `csrc/flash_dsplit.cuh`) of
   the forward and both backward kernels, f32 and bf16, against their
   plain versions at D = 160, 256 and 384 (a causal ragged batch,
   cross-attention with q_len and a kv_len = 0 row, causal with q_len at
   T = 127) and at phase 28's shapes: f32 at 1e-4 (out, lse; the
   gradients of the largest entry), bf16 at one ulp + 2e-3 (out) and +
   5e-3 (the gradients) with the witness, rows without a key and keys
   past kv_len exactly 0, bit-identical repeats, only the D-split forms
   launched; times them at phase 28's shapes beside the plain versions,
   SDPA (a yardstick) and two bounds: the function's and the D-split's
   as it runs (S recomputed once per output chunk);
4. serves the paged Transformer LM at the repo's served width
   (LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
   attn_impl="flash") over PagedKVCache(num_pages=256, page_size=16,
   max_pages_per_seq=64), weights from a numpy seed) behind the TCP
   front end, sends concurrent requests through ServeClient, checks
   every answer against the port's dense full-recompute reference
   through the first eos, and checks that every prefill went through
   the kernel (one launch per layer per prefill);
5. holds the flash-attention backward kernels (dkv and dq) against
   their plain PyTorch version on the card at the training shapes of
   phase 6 (B=32, T=128 full; B=8, T=1024 ragged) and four more (D=32
   with odd T, D=128 cross-attention with q_len, a kv_len=0 row, D=96):
   max |diff| / max |plain| <= 1e-4 for dq, dk and dv, dq of rows with
   no visible key and dk, dv of keys past kv_len exactly 0, every value
   finite, bit-identical on a repeat; times the kernels (CUDA events,
   and their device time from torch.profiler, which the kernels line
   gives beside as `device_ms`), the plain version and the backward of
   `scaled_dot_product_attention` (a yardstick only: forward+backward
   minus forward) beside their bounds (three TF32 passes, as phase 3's);
5b. the same for the backward kernels' bf16 forms against their bf16
   plain version at phase 5's six shapes, the long-context one and
   `BF16_EDGE_SHAPES` (within one bf16 ulp plus 5e-3 of the largest entry), from the bf16
   forward's out and lse, with SDPA's bf16 backward as the yardstick;
6. trains the Transformer LM at the same width through the port's
   trainer (`SGD.train`, attn_impl="flash", weights from a numpy
   seed): first one train step (`TrainStep`) of the flash conf
   against the same step of the dense conf at B=32, T=128 and at B=8,
   T=1024 (loss and every gradient within 1e-4 relative; the dense step
   runs at the flash step's ReLU gates, so that a gate whose
   preactivation lies within rounding of 0 cannot open in one step and
   not the other — the free dense step's flips are printed), then
   (a) 20 steps of momentum SGD (lr 0.001, mu 0.9) at
   B=32, T=128 and (b) 300 steps of adam (lr 0.001) on one fixed batch
   at B=8, T=1024 with ragged lengths (next-token batches from a fixed
   random walk over the vocabulary); every loss finite, (b) falls to
   at most half its first value, and each flash kernel launched once
   per layer per step;
6c. trains the LM at bench.py::bench_lm_train's settings (the same
   width, B=32, T=128, dense attention, momentum 0.001 / 0.9) under the
   bf16 flag (`matmul_precision`, the AMP cast rule): one step held
   against the f32 step from the same weights (every gradient within
   2e-2 plus twice the most bf16 moves the JAX package's gradient of
   the LM at this width, capped at 0.3), then 20 steps on (a)'s batches:
   every loss finite, the last below the first, the first within 5% of
   the f32 loss, masters f32; tokens/s and profile;
6d. trains bench.py::bench_longctx's model (longctx_conf: vocab 32000,
   d 512, 8 heads, 2 layers, 512 classes; its feed, seed 0; adam 1e-3)
   under the bf16 flag, attn_impl flash against dense from one weight
   map: (a) one held step at B=4, T=4096 (losses within 5%, each
   gradient within 2e-2 plus twice the most bf16 moves the JAX
   package's gradient of this conf, in relative L2 norm); (b) 20 steps
   an arm at B=4, T=4096 and (c) 10 at B=1, T=8192 through
   SGD.train_batch, in windows of 5 taken in turns (bench.py's
   _interleaved_best): every loss finite, each arm's last below its
   first, ms/step, tokens/s, fused_speedup, peak memory and profiles;
   the flash arm launches each bf16 form once a layer a step and no
   f32 form, the dense arm none;
7. holds the fused BN->ReLU->1x1-conv kernels (B1 forward, B2 and B3
   backward, `csrc/bn_act_conv1x1.cu`) against their plain PyTorch
   versions at the nine ResNet-50 site shapes at batch 32 and four
   ragged shapes, each with act relu or linear and with or without a
   residual (max |diff| / max |plain| <= 1e-4 for y, ssum, ssq, du,
   dscale, dshift, dres and dw, with non-zero cotangents of ssum and
   ssq; all three bit-identical on a repeat), then times them at the
   sites' batch-64 shapes beside the plain versions, the bare GEMM in
   torch.matmul (a yardstick only) and their bounds (on the tensor
   cores, three TF32 passes), with each kernel's launch plan;
7b. holds the kernels' bf16 forms (the wgmma kernels B1
   `fwd_wgmma_kernel`, B2 and B3, whose build must report no
   serialised wgmma) against their bf16 plain versions at the nine
   sites at batch 32, four ragged shapes (widths multiples of 8) and
   fourteen at the edges of the tiles and stages (rows 1, 127, 129,
   255, 257; widths 8, 72, 136, 200, 2048, Cout 264, Cin 520 and 2056;
   a B3 row split whose chunk boundary falls inside a stage; three B1
   walks whose ring and y buffers wrap), act relu or
   linear, with or without a residual, non-zero
   cotangents of ssum and ssq: the f32 outputs (ssum, ssq, dscale,
   dshift, dw before its cast) within 1e-4 of the largest, the bf16
   ones (y, du, dres, dw after its cast) element by element within one
   bf16 ulp plus 1e-4 of the largest, bit-identical on a repeat, no f32
   form launched; then times them at the sites' batch-256 shapes beside
   the bf16 plain versions, torch.matmul of the bf16 GEMM (a yardstick)
   and their bounds (one bf16 pass, bf16 bytes);
8. runs ResNet-50 (224x224x3, 1000 classes, weights from a seed)
   through `Inferencer` on [8, 224, 224, 3], plain and fused from the
   same weights and running statistics (advanced by three train-mode
   forwards): logits within 1e-4 of the largest, 29 B1 launches a
   fused forward;
9. trains it through the port's trainer with momentum (lr 0.001,
   mu 0.9): (a) one fused step against one plain step at B=8 (loss
   and new BN state within 1e-4; gradients held where no ReLU gate
   between them and the loss flipped), and the same for the two-block
   net of the CPU tests, where every gradient is held (its ReLU gate
   flips are printed; none may flip); (b) 30 fused
   steps of `SGD.train` on one fixed batch at B=64: every loss
   finite, the last below the first, 29 launches of each fused kernel
   a step; then 10 plain steps for their step time; each run profiled
   for 5 more steps;
9c. trains it under the bf16 flag at bench.py::bench_resnet50's
   settings: (a) one step at B=8 three ways from one weight map, plain
   f32, plain AMP and fused AMP: the fused AMP loss, new BN state and
   each gradient within twice the plain AMP step's own distance from
   the f32 step plus 1e-3 (relative), beside a witness, the f32 step
   on weights and images rounded to bf16; the same four arms with every
   BN on running statistics (this batch's own), where no gradient
   cancels in the statistics: the loss and each gradient held by the
   same rule, and every gradient's bound below 0.5, so that a zeroed or
   doubled gradient (1.0 from f32) fails; (b) 20
   fused steps of `SGD.train` at B=256 on one fixed batch: every loss
   finite, the last below the first, 29 launches of each bf16 form a
   step (B1 `fwd_wgmma_kernel`, B2 and B3 the backward wgmma kernels)
   and none of an f32 form; (c) 10 plain AMP steps; images/s, ms/step,
   peak memory and the profiles, with each port kernel's device ms a
   step;
10. holds the LSTM and GRU sequence kernels (B5 forward with and
    without the cell sequence, B6 backward, `csrc/lstm_seq.cu`; B7
    forward and B8 backward, `csrc/gru_seq.cu`) against their plain
    PyTorch versions at the path shapes (the classifier's layers, B=64,
    T=100, h=256; the NMT encoder, B=256, T=32, h=256; 13d's encoders,
    B=256, T=32, h=512 and B=80, T=50, h=1000), at the bench's other
    widths h=512 and 1280, at h=336 (B7 on the cluster route, B8 on the
    grid route), and at ragged lengths with a 0 and a 1 (max |diff| /
    max |plain| <= 1e-4 for every output, exactly 0 past each row's
    length), prints each case's routes (`fwd_plan`, `bwd_plan`: the
    cluster route where the kernel's weight slice fits a block, h <=
    320, B7 352, else the grid route), holds every route bit-identical
    on a repeat and the grid route against the plain version too
    wherever a case takes both routes, and times kernel, plain version,
    each kernel on the grid route where a case takes both routes, and
    cuDNN's torch.nn.LSTM/GRU (another function: a reference point
    only) with the bounds;
11. runs the IMDB stacked-LSTM classifier (vocab 30000, emb 128, two
    layers of h=256; weights from a seed) through `Inferencer` on
    [64, 100] ids, the kernel arm against the scan arm
    (use_pallas_rnn=False): probabilities within 1e-5, two B5 launches,
    both on the cluster route;
12. one adam train step of the classifier (lr 2e-3) and of the
    attention NMT (vocab 30000, emb 512, hidden 512, GRU h=256 a
    direction; lr 1e-3), kernel arm against scan arm from one weight
    map at ragged lengths, with the scan arm in f64 as the exact
    reference: the loss within 1e-4, every gradient within 1e-4 (of its
    largest entry) plus twice the scan arm's own f32 error against f64,
    and the kernel arm as close to f64 as the scan arm, within 1e-4;
13. trains both through `SGD.train` at the bench's full lengths on one
    fixed batch — the classifier 30 steps at B=64, T=100, the NMT 20
    steps at B=256, T=32 — then 10 steps of each on the scan arm: every
    loss falls, ms/step, tokens/s, peak memory and the profile table
    (a kernel arm's over 5 steps, a scan arm's over 1),
    and the kernel arm launches 2 B5 + 2 B6 (classifier) or 2 B7 + 2 B8
    (NMT) a step, every one on the cluster route;
13c. the classifier at bench_lstm's h = 512 and 1280, where B5 and B6
    take the grid route: a held adam step as 12's (the max pool at the
    f64 arm's steps), 10 kernel-arm and 3 scan-arm SGD steps with
    profiles, one inference forward;
13d. the attention NMT at encoder widths 512 (bench_nmt's settings at
    hidden 1024) and 1000 (RNNsearch's widths: hidden 2000, emb 620,
    B=80, T=50), where B7 and B8 take the grid route: a held adam step
    as 12's, 10 kernel-arm and 3 scan-arm SGD steps with profiles (2 B7
    + 2 B8 a step, all on the grid route), one adam step under the bf16
    flag held as 13b holds the NMT;
13b. one adam step of the classifier and of the NMT on the kernel arm
    under the bf16 flag (B5-B8 cast bf16 up to f32 around the kernels):
    loss finite and within 5% of the f32 step's, gradients f32 and
    each held against the f32 step's as in 6c, B5 and B6 (classifier)
    or B7 and B8 (NMT) launched twice each, on the cluster route;
14. holds the sparse-row kernels (B9, `csrc/sparse_rows.cu`: the rule
    kernel and the generic route's gather and scatter) against their
    plain PyTorch version at the two bench shapes (V = 2^20 x 64, N =
    65 536 and 16 384, momentum), SGD, adagrad, a user's function,
    overflow, 16 384 occurrences on 100 ids, D = 4/16/128, ids >= V, and
    140 000 distinct ids with one negative (past one slot a warp):
    the touched rows and slots within 1e-6 of the largest, every other
    row bit-equal to the start, the kernel bit-identical run to run;
    times kernel, torch.sort, the plain version, SGD's index_add_ (a
    yardstick only) and the bounds;
15. the standalone update as bench.py::bench_sparse_ctr: momentum
    tables of 2^20 and 2^22 x 64, 65 536 ids a step, 20 steps a
    `SparseUpdater.run_steps`, held against 20 plain steps (rtol 1e-5,
    atol 1e-6), ms a step and the V ratio; at 2^20 the bench's own
    update function through the generic route too;
16. the wide&deep large-table train step as
    bench.py::bench_ctr_widedeep_sparse (bs 256, t 64, tower 64/32/2,
    dense SGD 0.05, row momentum 0.01/0.9) at V = 2^20 and 2^22: one
    step kernel route vs plain route within 1e-6, then 5 warm and 5 x
    10 timed steps, examples/s, the V ratio and a profile;
17. the sharded embedding tier (2^30 logical rows x 64, 2^18 cached,
    adagrad) for 40 steps of 256 x 64 ids from a hot set of 2^20 ids,
    one shard, then 5 steps with 8 shards and hash placement, each held
    against the same steps of a CPU table through the export payloads;
18. the CTR models through SGD: ctr_wide_deep at its defaults, adam
    0.02, 30 steps on one batch of 256 x 64 features (the loss halves),
    and one ctr_linear step with adagrad;
18b. multi-step dispatch on the main path: the classifier at
    bench_lstm's settings (h = 256, B=64, adam 2e-3) through `SGD.train`
    fed by the port's readers (`batched(shuffle(...))` over 1617 samples
    of lengths 10-100) and `DataFeeder` (buckets 32/64/100), two passes
    at steps_per_dispatch = 10 (two CUDA graphs: chunks of 10 and 5; the
    short last batch eager) against two runs at 1: every cost and the
    final params and slots bit-equal wherever the two K = 1 runs agree,
    elsewhere within twice their distance; every wrapper launch counted;
    ms a step, and a third pass profiled: device ms, idle share, B5/B6
    on the cluster route and no other port kernel;
18c. a CUDA graph of 10 steps against eager chunks for the classifier
    at h = 512 (B5/B6 grid route: cooperative launches and their
    memsets), the NMT at bench_nmt's settings (B7/B8 cluster route,
    recurrent_group) and at hidden 1024 (B7/B8 grid route), LM (a) in
    f32 with flash (B4f/B4b f32), the long-context flash step at B=4,
    T=4096 and bench_lm_train's LM under the bf16 flag, ResNet-50 fused
    AMP at B=256 (the bf16 B1-B3; a NaN image in the 5th batch of each
    chunk, skipped) and ctr_wide_deep: two chunks eagerly, again, and as
    two replays of one graph (the second at global step + 10 with
    lr_scale 0.5, a poly schedule): params, slots, layer state and
    health rows held as in 18b; each arm's ms a step; a third replay
    profiled: the port kernels it runs, by route and form, and how often
    the profiler saw each a step;
19. the training lifecycle: the classifier through the CLI (train,
    a SIGTERM and a resume, test, time, merge_model, infer), the
    watchdog ladder under graphs and async checkpoints on ResNet-50's
    AMP step;
20. beam-search generation and NMT serving at bench.py's widths
    (hidden 512, emb 512, vocab 30000): (a) one step of
    seq2seq_attention(fused_decoder=True) against the generic
    recurrent_group arm from one weight map at ragged lengths (loss and
    every gradient within 1e-4 of the largest entry), then each arm
    through SGD at steps_per_dispatch 10 (bench_nmt's B=256, T=32, adam
    1e-3; two passes of 10 batches, the second timed; B7/B8 on the
    cluster route); (b) beam search from (a)'s fused parameters at
    bench_beam_decode's settings (B=32, t_src=32, beam 4, max_len 32):
    the encoder through B7 (held against its scan arm within 1e-4),
    then eager at K = 1, CUDA-graph replays at K = 8 and 1 (seqs, lens
    and scores `torch.equal` to eager, the same steps, chain depth
    ceil(steps / K)), the host rung per token (tokens by the serving
    rule: equal unless the reference's smallest top-(K+1) gap up to the
    first differing token is below 1e-4) and chunked at K = 8 (equal to
    eager), an adjust hook forbidding a token on the device and host
    rungs (same tokens by the rule, no beam carrying it): tokens/s,
    `last_timeline` and chain depth an arm; (c) `GenerationModel` with
    `encode` and a named hook behind `InferenceServer` (max_batch 8,
    buckets 16/32) and the TCP front end: 16 requests from 4 threads,
    source lengths 8-32, one naming the hook (path "host"), each answer
    against a lone generate() of its source by the rule; median and max
    latency_ms, served tokens/s;
21. nested sequences and the structured heads: (a) the document
    classifiers at bench_lstm's widths (vocab 30000, emb 128, hidden
    256; `hierarchical_lstm_classifier` and the same walk with an
    `simple_lstm` sentence encoder, max_subseq_len 25) on 64 documents
    of 8 sentence slots of 1-25 words (an empty sentence mid-document,
    an all-zero last column) through `DataFeeder`: the loss and every
    gradient on the card against the port on the CPU (the kernels'
    plain versions; within 1e-4 of the largest entry plus twice the
    CPU's own f32 distance from f64), then `SGD.train` two passes of 8
    batches eagerly (twice) and at steps_per_dispatch 4 (one CUDA graph,
    held bit for bit against the eager runs): ms a step each way; B5/B6
    launch once per sentence slot a step on the cluster route; (b)
    `linear_crf_tagger` and `rnn_crf_tagger` (defaults, and emb 128 /
    hidden 256) at B=64, ragged lengths up to 100: loss and gradients
    against the CPU, 6 adam steps through SGD (two B5 and two B6 a
    step for the bidirectional LSTM), then `crf_decoding` of one batch
    from the trained parameters, the ids equal to the CPU's; (c) AlexNet
    at bench.py's alexnet_bs64 setting, 10 steps in f32 and 10 under the
    bf16 flag (ms a step, images/s), and its `norm` layer on the card's
    conv1 activation against the CPU; (d) every new layer type and
    level (`LAYER_CASES`: the strided, sub-sequence and max-index
    levels, the ten sequence types, CTC, CRF, the cross-map norm,
    row_l2_norm) on the card against the CPU from one seeded input:
    outputs and gradients within 1e-4 of the largest entry, ids and
    lengths exactly;
22. beam and speculative decode over the paged KV pool, the
    speculative NMT rung and the top-level API: (a)
    `PagedLM.beam_generate` at the served LM's width (phase 4's spec
    and weights) over 1280 16-token pages, prompts of 9, 960, 500 and
    64 tokens (page 0 is the first group's and holds generated
    tokens), K = 4, 32 new tokens: one prefill of the four rows through
    B4f (a launch a layer), each group's beams as a set against the
    port's dense full recompute on the card (tokens exact, scores
    within 1e-4, unless the reference's smallest gap among a group's
    top K + 1 candidates up to the first differing step is below
    1e-4), another request's pages 0-3 and every page the free list
    never hands out holding a sentinel before and after, a second
    decode equal to the first: ms, tokens/s, chain depth, the
    dispatch/device split, the parent copy's bytes a step; (b)
    `SpeculativePagedLM` with (a)'s target and prompts, propose_k 4,
    the target as its own draft (accept rate 1.0, a chain shorter than
    32) and a draft of vocab 2048, d_model 128, 2 heads, 1 layer (its
    own seed and pool): tokens equal to the target's
    `PagedLM.generate` by phase 4's rule, scores within 1e-4, B4f once
    a layer of each net a run; (c) `SpeculativeGreedyDecoder` on the
    NMT at bench_beam_decode's widths from 20(a)'s weights (B=32,
    t_src 32, max_len 32; the target a beam-1 decoder as CUDA graphs),
    a self-draft and a draft of weights moved by 0.3 of their standard
    deviation: seqs and lens equal to the target's generate() by the
    serving rule, scores within 1e-5; then `GenerationModel(...,
    speculative=..., draft_params=...)` over TCP with 20(c)'s traffic,
    answers on path "spec" and one hook request on the host rung, each
    equal to a lone call by the rule; (d) `paddle_tpu_torch.init`,
    then `paddle.dataset.imdb.train()` through `paddle.reader.batched`,
    `DataFeeder` and `paddle.SGD` on the classifier at bench_lstm's
    settings for two passes: every loss finite, B5 and B6 twice a step;
23. the layer tail, the VAE and GAN confs and the v1 front end: (a)
    every layer type the tail added (`TAIL_CASES`: basic, cost, extras,
    maxout / spp / blockexpand, conv_trans, conv_operator, mdlstm in
    every direction and on a 28 x 28 grid at h = 32, hsigmoid, nce in
    eval mode, sampling_id, max_id, multiplex, priorbox, multibox_loss,
    detection_output) on the card against the port on the CPU from one
    seeded input: outputs and gradients within 1e-4 of the largest
    entry plus twice the CPU's f32-vs-f64 distance, ids and lengths
    exactly, each type's forward ms; (b) `vae_conf` at its defaults, B =
    128, 20 eager steps then 20 as CUDA graphs of 10, held against two
    eager runs (bit-equal where they agree), both costs finite and
    their sum falling; (c) the GAN at `gan_conf`'s defaults, B = 256 on
    an 8-Gaussian ring: the first train_d and train_g held against the
    CPU, then 200 alternating steps with finite losses; (d) a
    quick_start-style v1 LSTM config and its @provider at bench_lstm's
    widths through `python -m paddle_tpu_torch train` (one pass, in
    this process through runpy so that B5/B6 are counted), `--job=test`
    and `dump_config` (subprocesses): the dumped conf equal to the
    parse here, the first cost equal to a CPU forward from the same
    seed, B5 and B6 once a step; (e) SSD300's heads (8 732 priors, 21
    classes, nms_top_k 400, keep_top_k 200, B = 8): multibox_loss and
    its gradients, detection_output's rows (labels exact) against the
    CPU, and their ms;
24. the flight recorder and the fleet (subprocess replicas and workers
    on the card, `testing_faults.py`): (a) phase 20's GenerationModel
    served with a flight recorder and its torch.profiler capture on,
    an SLO below any latency and a model failing three times: exactly
    one `slo_breach` bundle holding the requests' serve.request /
    queued / dispatch spans, the captured profile and its trace, the
    `breaker_open` trigger suppressed, the bundle lint's rc 0, and a
    dump's ms with and without the capture; (b) the host-fallback
    rescue: the decoder's device decode raising once, the request
    answered on the host rung with the device decode's tokens by the
    serving rule, one breaker failure, B7 on both rungs; (c) two
    phase-13 classifiers co-dispatched through MultiForwardHost:
    `batches_codispatch` >= 1, each batch's scores equal to the model
    served alone and within 1e-5 (probabilities) of the scan arm, B5's
    inference form; (d) bench_serve_fleet_loadtest: three replicas from
    the verified cache, 8 clients, 3 s a point, one SIGKILLed halfway
    and restarted from the cache: zero admitted requests lost, goodput,
    p99 and the rejoin s; (e) bench_serve_coldstart (48 x 256): store_s,
    compile-mode and cache-mode boot s; (f) the elastic CTR worker at
    _bench_ctr_bigvocab's full setting SIGKILLed and respawned
    (batches lost and retrained 0, kill_recover_s, B9 from its done
    record), then the online loop through one ctr replica with a
    rollout() every 10 batches (zero lost, the served logloss falling);
    (g) one stitched incident bundle read by tools/fleet_view.py and
    `python -m paddle_tpu_torch fleetz --json`;
25. the kernels as custom ops, export and the recompile guard (A6b) and
    the moe layer: (a) `torch.library.opcheck` of each kernel's
    `paddle_tpu_torch::` op on CUDA tensors at one shape of PERF.md's
    table (B1-B3 also bf16), each op's outputs against its plain
    version; (b) export_compiled / load_compiled of ResNet-50 (fused,
    B = 256, f32 and under the bf16 flag), the IMDB classifier at h =
    512 and the LM's forward with flash attention: export, load and
    call times, the blob's bytes, the loaded outputs against eager
    `infer`, the op nodes, the kernels' counters rising in the loaded
    call; (c) ResNet-50's forward through store_verified /
    load_verified, a policy that passes and one that fails on
    n_instructions_max; (d) the recompile guard, strict: the classifier
    through SGD at steps_per_dispatch 4 (the second pass clean, a new
    length raising RecompileError before its capture) and a
    GenerationModel server (a cold bucket fails its request, the warm
    one keeps serving); (e) the moe layer (D 512, hidden 2048, 8
    experts, 4096 tokens) trained 3 adam steps on the card, f32 and
    under the bf16 flag, against the same steps on the CPU;
26. the mesh (`core/mesh.py`, `parallel/`): (a) a one-rank NCCL world,
    the fused ResNet-50 AMP step at B = 256 through TrainStep(mesh=
    {data: 1}) bit-equal to the meshless step for 3 steps, and `multi`
    at K = 10 as a CUDA graph with its NCCL calls captured, bit-equal to
    eager by 18c's rule; then one gloo world of 2 ranks sharing the card
    (spawned once): (b) DP ResNet-50 at a global B = 256 and
    mc_lstm_h512_tbs256_dp2's classifier against the one-rank step, f32
    and under the bf16 flag, the bf16 hold on two res4 blocks, and an
    async pass of the DP ranks loaded back; (c) Ulysses (flash) and the
    ring at T = 32 768 over {data: 1, seq: 2} against the one-rank flash
    step; (d) GPipe over 2 stages; (e) moe with its experts over model =
    2; (f) the sharded tier with one shard a rank against the
    one-process two-shard tier;
27. the v1-era runtime (`native/`, `data/master_*`, `compat/swig_api`,
    `compat/py2run`, `api`, `capi_bridge`) on the IMDB classifier at
    bench_lstm's setting and h = 512 (`V1_CLS`, a v1 config): (a) the
    native runtime built with g++ from the port's sources, bench_lstm's
    seeded feed (64 batches) through `dataset.common.convert` into
    recordio chunks, read back equal; (b) `python -m paddle_tpu_torch
    master` over them, one pass through `reader.elastic(MasterClient)`,
    `DataProviderConverter`, `GradientMachine.forwardBackward` and
    `ParameterUpdater` with every parameter mirrored on the host, the
    first 3 steps bit-equal to `TrainStep` (loss, parameters, slots), the
    master SIGKILLed after 7 chunks and restarted from its snapshot
    (every chunk and record trained once), B5/B6 on the grid route twice
    a step; ms a step against `TrainStep`'s, the mirrors' bytes and ms;
    (c) `libpaddle_tpu_torch_capi.so` and the four example programs
    (cc) on the card: `sequence` on (b)'s merged model equal to
    `Inferencer.infer` within 1e-6, `dense` / `sparse_binary` /
    `multi_thread` on a small dense model, then the model through
    `ctypes` in this process (B5's inference form counted; the first
    call's ms; 4 threads at once) and a bad path's error; (d)
    `api.SequenceGenerator` over phase 20's NMT, bit-equal to
    `BeamSearchDecoder.generate` (B7 twice on the encoder); (e) a
    python-2 API driver (`PY2_DRIVER`) through `run_py2_script` for 5
    steps, its losses equal to the same steps called directly;
28. head dim 256 (Gemma's) on the main paths, through the D-split forms
    of the flash kernels (`csrc/flash_dsplit.cuh`), each path with every
    flash counter zeroed just before it and read just after, only the
    D-split forms launched: (a) phase 4's server at d_model 1024, 4
    heads, the answers held as phase 4's; (b) LM (b) at d_model 1024, 4
    heads: the flash step held against the dense step at its ReLU gates
    (phase 6's hold), then 20 adam steps through SGD.train (the loss
    falls); (c) bench_longctx's conf at d 1024, 4 heads under the bf16
    flag: 6d's held step and 10 steps an arm at B = 4, T = 4096;
29. the Fluid-style op framework (`framework/`): the reference's MLP as
    an op net (mul, rowwise_add, sigmoid, softmax, onehot_cross_entropy,
    mean, backward(), sgd) trained 20 steps eagerly op by op (the loss
    falls), the same steps through `net_to_fn` captured as one CUDA
    graph bit-equal to them, the first step within 1e-4 of the port on
    the CPU; a one-memory RNN RecurrentOp (T = 16) eagerly and through
    `scan_fn`, equal, its grad op within 1e-4 of autograd over
    `scan_fn`, both within 1e-4 of the CPU;
30. prints the kernels' JSON line and, last, the device line.

Exits 2 without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12
H100_BF16_FLOPS = 989e12     # dense bf16 mma
TOL = 1e-4
SEED = 0
EOS = 1
MAX_NEW = 32
PROMPT_LENS = (990, 700, 513, 620, 850, 300, 64, 17)
# the served LM (phases 4 and 22): the repo's served width
SERVED_LM = dict(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                 attn_impl="flash")
# phase 6(b): adam's learning rate and the steps it needs on one batch of
# this width to halve the loss. On an H100, lr 0.01 took 30 steps of
# random labels only to 0.80x, and 200 steps of the next-token batch
# diverged (to 1.29x): a step of 0.01 is a sixth of the weights' 1/16
# scale.
LR_B = 0.001
STEPS_B = 300


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def time_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of fn() over `reps` back-to-back calls, from
    CUDA events (warm; inputs stay resident in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def visible_pairs(B, Tq, Tk, causal, kv_len, q_len):
    """Number of (query, key) pairs the masks leave visible, per head."""
    n = 0
    for b in range(B):
        kl = Tk if kv_len is None else min(kv_len[b], Tk)
        ql = Tq if q_len is None else min(q_len[b], Tq)
        for i in range(ql):
            n += min(kl, i + 1) if causal else kl
    return n


def set_amp(on):
    """The port's `matmul_precision` flag: "bfloat16" (the AMP cast rule,
    as bench.py::_setup sets it for every bench row) or "default"."""
    from paddle_tpu_torch.core import flags

    flags.set_flag("matmul_precision", "bfloat16" if on else "default")


def rel_err(got, ref):
    """max |got - ref| / max |ref| (0 when both are 0), and max |diff|."""
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return (diff / scale if scale > 0 else diff), diff


def lens_tensor(torch, x):
    return None if x is None else torch.tensor(x, dtype=torch.int32,
                                               device="cuda")


def sdpa_mask(torch, B, Tq, Tk, causal, kv_len, q_len):
    """[B, 1, Tq, Tk] bool, True = may attend (SDPA's convention)."""
    qpos = torch.arange(Tq, device="cuda")[:, None]
    kpos = torch.arange(Tk, device="cuda")[None, :]
    mask = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device="cuda")
    if kv_len is not None:
        mask &= kpos < kv_len.view(B, 1, 1, 1)
    if q_len is not None:
        mask &= qpos < q_len.view(B, 1, 1, 1)
    if causal:
        mask &= kpos <= qpos
    return mask


def check_kernel(torch, fa, case, gen):
    """Kernel vs plain version on the card at one shape; returns the
    case's numbers."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    dev = torch.device("cuda")
    q = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    k = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    v = torch.randn((B, Tk, H, D), generator=gen, device=dev)

    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    out_k, lse_k = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    out_p, lse_p = fa.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1]), (
        f"{case['name']}: kernel not bit-identical on a repeat")
    alive = lse_p < 1e29                               # [B, H, Tq]
    dead = ~alive
    err_out = (out_k - out_p).abs().max().item()
    err_lse = (lse_k - lse_p).abs()[alive].max().item()
    dead_out = out_k.permute(0, 2, 1, 3)[dead]
    dead_ok = bool((dead_out == 0).all().item()
                   and (lse_k[dead] == 1e30).all().item())
    n_dead = int(dead.sum().item())
    if case.get("expect_dead"):
        assert n_dead > 0, f"{case['name']}: expected fully-masked rows"
    assert torch.isfinite(out_k).all().item(), case["name"]
    assert err_out <= TOL and err_lse <= TOL, (
        f"{case['name']}: kernel vs plain out {err_out:.3g} lse "
        f"{err_lse:.3g} > {TOL}"
    )
    assert dead_ok, f"{case['name']}: masked rows not exactly 0 / 1e30"

    kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(torch, lambda: fa.attention_plain(q, k, v, **kw))
    # scaled_dot_product_attention on the same inputs, [B, H, T, D]
    # layout made beforehand
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = sdpa_mask(torch, B, Tq, Tk, case["causal"], kv_len, q_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask))

    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    flops = 4 * D * H * pairs                 # QK^T and PV, 2 per MAC
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + out_k.numel()
                  + lse_k.numel()
                  + (B if kv_len is not None else 0)
                  + (B if q_len is not None else 0))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    # three TF32 passes on the tensor cores (hi*hi + hi*lo + lo*hi)
    t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
    res = {
        "name": case["name"], "err_out": err_out, "err_lse": err_lse,
        "masked_rows": n_dead, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }
    print(json.dumps(res), flush=True)
    return res


def random_params(spec, lm, seed=SEED):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in lm.lm_param_shapes(spec).items():
        if len(shape) == 1:
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape)
                         / np.sqrt(shape[0])).astype(np.float32)
    return out


def serve_lm(torch, fa, spec_kw=SERVED_LM):
    """Phase 4 (and 28(a) at head dim 256): the paged LM `spec_kw`
    served over TCP, every answer held against the dense full-recompute
    reference; every flash counter zeroed just before the requests and
    read just after, one form launched. Returns {that form: launches}."""
    from paddle_tpu_torch.decoding.kv_cache import PagedKVCache, PagedLM
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.serving.lm_engine import PagedLMModel
    from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig
    from paddle_tpu_torch.serving.tcp import ServeClient, ServingTCPServer
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(**spec_kw)
    params = params_from_numpy(random_params(spec, lm), device="cuda")
    cache = PagedKVCache(spec, num_pages=256, page_size=16,
                         max_pages_per_seq=64, device="cuda")
    assert max(PROMPT_LENS) + MAX_NEW <= cache.max_seq_len
    plm = PagedLM(spec, params, cache, eos_id=EOS)
    model = PagedLMModel(plm, slots=4, max_new=MAX_NEW)
    buckets = tuple(16 * 2 ** i for i in range(7))     # 16 .. 1024
    server = InferenceServer(ServeConfig(buckets=buckets,
                                         default_deadline_s=60))
    server.add_model("lm", model)
    tcp = ServingTCPServer(server)

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(2, spec.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    answers = [None] * len(prompts)

    def client(i):
        with ServeClient(f"127.0.0.1:{tcp.port}") as cl:
            answers[i] = cl.call("lm", prompts[i], timeout=600)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for n in fa.COUNTERS:
        setattr(fa, n, 0)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launched = {n: getattr(fa, n) for n in fa.COUNTERS if getattr(fa, n)}
    assert len(launched) == 1, f"flash forms launched: {launched}"
    (launches,) = launched.values()
    assert not any(t.is_alive() for t in threads), "a request hung"

    tcp.stop_accepting()
    server.shutdown(drain=True, timeout=60)
    tcp.stop(drain=True)
    stats = server.stats()
    print("server stats " + json.dumps(stats), flush=True)
    for i, a in enumerate(answers):
        assert a is not None and a.get("ok"), f"request {i}: {a}"
    assert stats["completed"] == len(prompts) and stats["failed"] == 0

    eng = model.lm_engine
    n_tok = sum(len(a["tokens"]) for a in answers)
    lat = sorted(a["latency_ms"] for a in answers)
    print(f"served {len(prompts)} requests, {n_tok} tokens in "
          f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s "
          f"({stats['batches']} batches); request latency ms "
          f"median {lat[len(lat) // 2]} max {lat[-1]}", flush=True)
    print("engine " + json.dumps({
        "prefills": eng.prefill_dispatches,
        "decode_steps": eng.decode_dispatches,
        "enqueue_s": eng.timeline["dispatch_s"],
        "device_s": eng.timeline["device_s"],
        "cache_hit_frac": eng.cache_hit_frac,
        "reprefilled_tokens": eng.reprefilled_tokens,
        "prefilled_tokens": cache.prefilled_tokens,
        "appended_tokens": cache.appended_tokens,
        "cached_prefix_tokens": cache.cached_prefix_tokens,
        "evictions": cache.evictions,
        "free_pages": cache.free_page_count(),
    }), flush=True)
    assert cache.free_page_count() == cache.num_pages - 1  # scratch page
    print(f"flash launches {launches} for {eng.prefill_dispatches} "
          f"prefills x {spec.num_layers} layers", flush=True)
    assert eng.prefill_dispatches >= len(prompts)
    assert launches >= spec.num_layers * eng.prefill_dispatches, (
        "the prefill did not go through the flash kernel"
    )

    # the reference: dense full recompute, plain torch, on the card
    ref_spec = dataclasses.replace(spec, attn_impl="dense")
    lens = np.asarray(PROMPT_LENS, np.int32)
    ids = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    ref, _ = lm.greedy_decode_recompute(ref_spec, params, ids, lens,
                                        MAX_NEW, EOS)
    for i, a in enumerate(answers):
        row = [int(x) for x in ref[i]]
        want = row[:row.index(EOS)] if EOS in row else row
        got = a["tokens"]
        if got == want:
            print(f"request {i} (len {lens[i]}): {len(got)} tokens "
                  f"equal to the reference", flush=True)
            continue
        t = next(j for j in range(min(len(got), len(want)) + 1)
                 if j >= len(got) or j >= len(want) or got[j] != want[j])
        seq = np.concatenate([prompts[i], np.asarray(want[:t], np.int32)])
        with torch.no_grad():
            logits = lm.lm_forward(
                ref_spec, params,
                torch.as_tensor(seq[None], device="cuda"),
            )
        top2 = torch.topk(lm.lm_logp(logits[0, -1]), 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"request {i} (len {lens[i]}): differs at step {t}; "
              f"reference top-2 log-prob margin {margin:.3g}", flush=True)
        assert margin < 1e-4, f"request {i} disagrees with the reference"
    return launched


def bwd_bounds(B, Tq, Tk, H, D, pairs, n_lens, bf16=False):
    """{"bwd" | "dkv" | "dq": (bound ms, "bytes" | "operations")} of the
    flash backward at one shape with `pairs` visible pairs a head and
    `n_lens` int32 [B] masks: the larger of each input read once and
    each output written once over 3.35 TB/s, and its flops as three
    TF32 passes on the tensor cores (hi*hi + hi*lo + lo*hi) over 495
    TFLOP/s, or for the bf16 forms (bf16 q, k, v, out, dO, dq, dk, dv;
    lse and delta f32) one bf16 pass over 989 TFLOP/s."""
    f32 = 4
    el = 2 if bf16 else f32
    qo = B * Tq * H * D * el           # one [B, Tq, H, D] tensor
    kv = B * Tk * H * D * el           # one [B, Tk, H, D] tensor
    rows = B * H * Tq * f32            # lse or delta
    lens = f32 * B * n_lens
    passes, peak = (1, H100_BF16_FLOPS) if bf16 else (3, H100_TF32_FLOPS)

    def bound(flops_per_pair, nbytes):
        t_ops = passes * flops_per_pair * D * H * pairs / peak * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    return {
        # the whole backward: recomputed QK^T, dV, dP, dQ, dK (2 flops
        # per MAC each); q, k, v, out, dO and lse read, dq, dk, dv written
        "bwd": bound(10, 4 * qo + 4 * kv + rows + lens),
        # dkv: QK^T, dP, dV, dK; q, k, v, dO, lse, delta read, dk, dv
        # written
        "dkv": bound(8, 2 * qo + 2 * kv + 2 * rows + 2 * kv + lens),
        # dq: QK^T, dP, dQ; q, k, v, dO, lse, delta read, dq written
        "dq": bound(6, 2 * qo + 2 * kv + 2 * rows + qo + lens),
    }


def check_backward(torch, fa, case, gen):
    """Backward kernels vs attention_bwd_plain on the card at one shape;
    returns the case's numbers."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    dev = torch.device("cuda")
    q = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    k = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    v = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    do = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    out, lse = fa.flash_attention(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (
        f"{case['name']}: backward kernels not bit-identical on a repeat")
    errs = {n: rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), got,
                                                 ref)}
    for b, n in enumerate(case.get("kv_len") or []):
        assert bool((got[1][b, n:] == 0).all().item()
                    and (got[2][b, n:] == 0).all().item()), (
            f"{case['name']}: dk, dv of keys past kv_len not exactly 0")
    dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)          # [B, Tq, H]
    n_dead = int(dead.sum().item())
    if case.get("expect_dead"):
        assert n_dead > 0, f"{case['name']}: expected rows without keys"
    assert bool((got[0][dead] == 0).all().item()), (
        f"{case['name']}: dq of rows without keys is not exactly 0")
    for n, g in zip(("dq", "dk", "dv"), got):
        assert torch.isfinite(g).all().item(), f"{case['name']}: {n}"
        assert errs[n][0] <= TOL, (
            f"{case['name']}: kernel vs plain {n} relative error "
            f"{errs[n][0]:.3g} > {TOL}")

    delta = torch.einsum("bqhd,bqhd->bhq", do, out).contiguous()

    def dkv():
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

    def dq():
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)

    dkv_ms = time_ms(torch, dkv)
    dq_ms = time_ms(torch, dq)
    # the kernels' own device time: where a call's host work outlasts
    # its kernel (LM (a)'s shape), back-to-back calls time the host
    device_ms = {
        n: profile_fn(torch, fn, steps=20)["port_kernels_ms_per_step"][
            f"B4b flash_attn_bwd_{n}"] for n, fn in (("dkv", dkv), ("dq", dq))}
    bwd_ms = time_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, **kw))
    fwd_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(torch, lambda: fa.attention_bwd_plain(
        q, k, v, out, lse, do, **kw))
    # SDPA's backward: forward+backward minus forward, [B, H, T, D]
    # layout made beforehand
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = sdpa_mask(torch, B, Tq, Tk, case["causal"], kv_len, q_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, attn_mask=mask)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt),
                            dot)

    library_ms = (time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd))

    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    bounds = bwd_bounds(B, Tq, Tk, H, D, pairs,
                        (kv_len is not None) + (q_len is not None))
    bwd_bound, dkv_bound, dq_bound = (bounds[n] for n in ("bwd", "dkv",
                                                            "dq"))
    res = {
        "name": case["name"], "masked_rows": n_dead,
        "rel_err": {n: e[0] for n, e in errs.items()},
        "max_abs_err": {n: e[1] for n, e in errs.items()},
        "dkv_ms": dkv_ms, "dq_ms": dq_ms,
        "dkv_device_ms": device_ms["dkv"], "dq_device_ms": device_ms["dq"],
        "bwd_ms": bwd_ms,
        "fwd_ms": fwd_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
        "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
        "pairs_per_head": pairs,
    }
    print(json.dumps(res), flush=True)
    return res


# ---- the bf16 forms of B4f and B4b (phases 3b, 5b) ---------------------

# Phases 3b and 5b hold each bf16 output element by element within one
# bf16 ulp of the bf16 plain version plus a fraction of its largest
# entry: the kernel rounds p against the running max, the plain version
# against the row's final one, and s, dp are summed in another order.
# tests/test_torch_attention.py and tests/test_torch_flash_bwd.py state
# these fractions from their readings (the library kernel in interpret
# mode and an emulation of the forward kernel against the plain
# versions: up to 9.8e-4 and 3.4e-3 of the largest entry beyond an ulp).
BF16_OUT_FRAC, BF16_GRAD_FRAC = 2e-3, 5e-3
# the long-context trainer's attention (phase 6d at B=4, T=4096)
LONGCTX_SHAPE = dict(name="longctx_b4_t4096_h8_d64", B=4, Tq=4096, Tk=4096,
                     H=8, D=64, causal=True)
# the edges of the bf16 kernels' tiles (128-row query and key blocks,
# 64-key and 64- or 32-query walked tiles): T one short of and one past a
# tile, a kv_len ending mid-tile, Tq != Tk with q_len and a kv_len = 0 row,
# and K, V rows past kv_len holding NaN (TMA fills only rows past T: the
# masks must keep them out), at every head dim the wrapper takes (96 runs
# padded to 128); not profiled
BF16_EDGE_SHAPES = [
    dict(name=f"edge_{name}_d{D}", D=D, edge=True, **case)
    for D in (32, 64, 96, 128)
    for name, case in (
        ("causal_t127_ragged", dict(B=2, Tq=127, Tk=127, H=2, causal=True,
                                    kv_len=[127, 70])),
        ("causal_t129", dict(B=1, Tq=129, Tk=129, H=2, causal=True)),
        ("causal_t200_kvlen_mid_tile", dict(B=2, Tq=200, Tk=200, H=2,
                                            causal=True, kv_len=[200, 150])),
        ("cross_tq129_tk200_qlen_kvlen0", dict(
            B=2, Tq=129, Tk=200, H=2, causal=False, kv_len=[0, 77],
            q_len=[129, 100], expect_dead=True)),
        ("causal_t200_nan_past_kvlen", dict(
            B=2, Tq=200, Tk=200, H=2, causal=True, kv_len=[130, 61],
            nan_past_kv_len=True)),
    )
]


def bf16_beyond(torch, got, ref):
    """The largest |got - ref| beyond one bf16 ulp of ref, over max |ref|
    (at most 0: within an ulp everywhere)."""
    got, ref = got.float(), ref.float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    top = ref.abs().max().item()
    return ((got - ref).abs() - ulp).max().item() / (top if top > 0 else 1.0)


def no_farther(torch, got, plain, exact, what):
    """The witness: the kernel's output no farther from the f32 plain
    version on the same bf16 inputs than the bf16 plain version is,
    within one bf16 ulp of the largest entry. Returns both distances."""
    top = exact.abs().max()
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8).item()
    far_k = (got.float() - exact).abs().max().item()
    far_p = (plain.float() - exact).abs().max().item()
    assert far_k <= far_p + ulp, (
        f"{what}: kernel {far_k:.4g} from f32, bf16 plain {far_p:.4g} "
        f"(+ ulp {ulp:.3g})")
    return far_k, far_p


def bf16_qkv(torch, case, gen, with_dout=False):
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    shapes = [(B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D)]
    if with_dout:
        shapes.append((B, Tq, H, D))
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in shapes]


def kernel_kv(case, k, v):
    """k and v as the kernels get them: for a `nan_past_kv_len` case,
    copies with every row at or past kv_len[b] set to NaN (no visible
    pair reads them; the references take the finite k and v)."""
    if not case.get("nan_past_kv_len"):
        return k, v
    k, v = k.clone(), v.clone()
    for b, n in enumerate(case["kv_len"]):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    return k, v


def check_kernel_bf16(torch, fa, case, gen):
    """Phase 3b: the bf16 form of B4f against attention_plain_bf16 on the
    card at one shape: out within one bf16 ulp + BF16_OUT_FRAC of the
    largest entry, lse within TOL where a key is visible, rows without
    one exactly out 0 and lse 1e30, bit-identical on a repeat, only the
    bf16 form launched, and the witness (`no_farther`). Times the
    kernel, the bf16 plain version and scaled_dot_product_attention on
    the bf16 [B, H, T, D] inputs with is_causal and no mask (its flash
    backend, a yardstick the port never calls: it does not apply
    kv_len or q_len) beside the bound (bf16 bytes; one bf16 pass)."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    q, k, v = bf16_qkv(torch, case, gen)
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    kk, vk = kernel_kv(case, k, v)
    before = {n: getattr(fa, n) for n in fa.COUNTERS}
    out_k, lse_k = fa.flash_attention(q, kk, vk, **kw)
    again = fa.flash_attention(q, kk, vk, **kw)
    torch.cuda.synchronize()
    ran = {n: getattr(fa, n) - c for n, c in before.items() if
           getattr(fa, n) != c}
    assert ran == {"bf16_launches": 2}, f"{case['name']}: launched {ran}"
    out_p, lse_p = fa.attention_plain_bf16(q, k, v, **kw)
    exact, _ = fa.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1]), (
        f"{case['name']}: bf16 kernel not bit-identical on a repeat")
    assert out_k.dtype == torch.bfloat16 and lse_k.dtype == torch.float32
    assert torch.isfinite(out_k).all().item(), case["name"]
    alive = lse_p < 1e29
    dead = ~alive
    beyond = bf16_beyond(torch, out_k, out_p)
    err_lse = (lse_k - lse_p).abs()[alive].max().item()
    assert beyond <= BF16_OUT_FRAC and err_lse <= TOL, (
        f"{case['name']}: bf16 kernel vs plain out {beyond:.3g} of the "
        f"largest beyond an ulp (> {BF16_OUT_FRAC}), lse {err_lse:.3g}")
    n_dead = int(dead.sum().item())
    if case.get("expect_dead"):
        assert n_dead > 0, f"{case['name']}: expected fully-masked rows"
    assert bool((out_k.permute(0, 2, 1, 3)[dead] == 0).all().item()
                and (lse_k[dead] == 1e30).all().item()), (
        f"{case['name']}: masked rows not exactly 0 / 1e30")
    far_k, far_p = no_farther(torch, out_k, out_p, exact, case["name"])
    del exact, again

    kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, kk, vk, **kw))
    plain_ms = time_ms(torch, lambda: fa.attention_plain_bf16(q, k, v,
                                                              **kw),
                       reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt,
                                             is_causal=case["causal"]))
    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    flops = 4 * D * H * pairs
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + out_k.numel())
              + 4 * (lse_k.numel() + B * ((kv_len is not None)
                                          + (q_len is not None))))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    res = {
        "name": case["name"], "beyond_ulp_frac": beyond, "err_lse": err_lse,
        "max_abs_err": (out_k.float() - out_p.float()).abs().max().item(),
        "witness_kernel_vs_f32": far_k, "witness_plain_vs_f32": far_p,
        "masked_rows": n_dead, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }
    print("bf16 " + json.dumps(res), flush=True)
    return res


def check_backward_bf16(torch, fa, case, gen):
    """Phase 5b: the bf16 forms of B4b against attention_bwd_plain_bf16
    on the card at one shape, from the bf16 forward's out and lse: dq,
    dk and dv within one bf16 ulp + BF16_GRAD_FRAC of the largest entry,
    dq of rows without keys and dk, dv of keys past kv_len exactly 0,
    finite, bit-identical on a repeat, only the bf16 forms launched, and
    the witness against the f32 plain backward on the same inputs. Times
    dkv and dq (CUDA events, and device time from torch.profiler), the
    bf16 plain version and SDPA's backward on bf16 with is_causal and no
    mask (forward+backward minus forward; a yardstick) beside the
    bounds (bf16 bytes; one bf16 pass)."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    q, k, v, do = bf16_qkv(torch, case, gen, with_dout=True)
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    kk, vk = kernel_kv(case, k, v)
    out, lse = fa.flash_attention(q, kk, vk, **kw)
    before = {n: getattr(fa, n) for n in fa.COUNTERS}
    got = fa.flash_attention_bwd(q, kk, vk, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, kk, vk, out, lse, do, **kw)
    torch.cuda.synchronize()
    ran = {n: getattr(fa, n) - c for n, c in before.items() if
           getattr(fa, n) != c}
    assert ran == {"bwd_dkv_bf16_launches": 2, "bwd_dq_bf16_launches": 2}, (
        f"{case['name']}: launched {ran}")
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (
        f"{case['name']}: bf16 backward kernels not bit-identical")
    del again
    ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
    out32, lse32 = fa.attention_plain(q, k, v, **kw)
    exact = fa.attention_bwd_plain(q, k, v, out32, lse32, do, **kw)
    del out32, lse32
    res = {"name": case["name"], "beyond_ulp_frac": {}, "max_abs_err": {},
           "witness": {}}
    for n, g, r, e in zip(("dq", "dk", "dv"), got, ref, exact):
        assert g.dtype == torch.bfloat16, f"{case['name']}: {n} {g.dtype}"
        assert torch.isfinite(g).all().item(), f"{case['name']}: {n}"
        res["beyond_ulp_frac"][n] = bf16_beyond(torch, g, r)
        res["max_abs_err"][n] = (g.float() - r.float()).abs().max().item()
        assert res["beyond_ulp_frac"][n] <= BF16_GRAD_FRAC, (
            f"{case['name']}: bf16 {n} {res['beyond_ulp_frac'][n]:.3g} of "
            f"the largest beyond an ulp (> {BF16_GRAD_FRAC})")
        res["witness"][n] = no_farther(torch, g, r, e,
                                       f"{case['name']} {n}")
    del ref, exact
    for b, n in enumerate(case.get("kv_len") or []):
        assert bool((got[1][b, n:] == 0).all().item()
                    and (got[2][b, n:] == 0).all().item()), (
            f"{case['name']}: bf16 dk, dv of keys past kv_len not 0")
    dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)
    res["masked_rows"] = int(dead.sum().item())
    if case.get("expect_dead"):
        assert res["masked_rows"] > 0, f"{case['name']}: expected dead rows"
    assert bool((got[0][dead] == 0).all().item()), (
        f"{case['name']}: bf16 dq of rows without keys is not exactly 0")

    delta = fa.row_delta(do, out)
    # the kernels' own inputs: D padded as flash_attention_bwd pads it
    d_pad = fa.kernel_head_dim(D, fa.BF16_KERNEL_HEAD_DIMS)
    qp, kp, vp, dop = (fa.pad_head_dim(x, d_pad) for x in (q, kk, vk, do))
    kwp = dict(kw, scale=1.0 / D ** 0.5)

    def dkv():
        fa.flash_attention_bwd_dkv(qp, kp, vp, dop, lse, delta, **kwp)

    def dq():
        fa.flash_attention_bwd_dq(qp, kp, vp, dop, lse, delta, **kwp)

    res["dkv_ms"], res["dq_ms"] = time_ms(torch, dkv), time_ms(torch, dq)
    for n, fn in (("dkv", dkv), ("dq", dq)):
        prof = None if case.get("edge") else profile_fn(torch, fn, steps=20)
        res[f"{n}_device_ms"] = (None if prof is None else
                                 prof["port_kernels_ms_per_step"].get(
                                     f"B4b flash_attn_bwd_{n}_bf16"))
    res["plain_ms"] = time_ms(torch, lambda: fa.attention_bwd_plain_bf16(
        q, k, v, out, lse, do, **kw), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=case["causal"])

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=case["causal"]),
                            (qt, kt, vt), dot)

    res["library_ms"] = time_ms(torch, sdpa_fwd_bwd) - time_ms(torch,
                                                               sdpa_fwd)
    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    bounds = bwd_bounds(B, Tq, Tk, H, D, pairs,
                        (kv_len is not None) + (q_len is not None),
                        bf16=True)
    for n in ("dkv", "dq"):
        res[f"{n}_bound_ms"], res[f"{n}_bound_by"] = bounds[n]
    res["pairs_per_head"] = pairs
    print("bf16 " + json.dumps(res), flush=True)
    return res


# ---- B4f and B4b at head dim D > 128: the D-split forms (phase 3c) -----

# the D-split's kernel-vs-plain shapes at D = 160 (padded to 192), 256 and
# 384: a causal ragged batch, cross-attention with q_len and a kv_len = 0
# row, and causal self-attention with q_len at an odd T
DSPLIT_DIMS = (160, 256, 384)
DSPLIT_SHAPES = [
    dict(name=f"{name}_d{D}", D=D, **case)
    for D in DSPLIT_DIMS
    for name, case in (
        ("causal_t200_ragged", dict(B=2, Tq=200, Tk=200, H=2, causal=True,
                                    kv_len=[200, 131])),
        ("cross_tq129_tk200_qlen_kvlen0", dict(
            B=2, Tq=129, Tk=200, H=2, causal=False, kv_len=[0, 77],
            q_len=[129, 100], expect_dead=True)),
        ("causal_t127_qlen", dict(B=1, Tq=127, Tk=127, H=3, causal=True,
                                  q_len=[100])),
    )
]
# the main paths' attention at head dim 256 (phase 28), where phase 3c
# also times the forms: (a) the served LM's longest prefill, (b) LM (b)'s
# training batch (f32), (c) the long-context trainer's (bf16)
DSPLIT_PATHS = {
    "served": dict(name="served_b1_t1024_h4_d256", B=1, Tq=1024, Tk=1024,
                   H=4, D=256, causal=True, kv_len=[PROMPT_LENS[0]]),
    "lm": dict(name="lm_b8_t1024_h4_d256_ragged", B=8, Tq=1024, Tk=1024,
               H=4, D=256, causal=True, kv_len=list(PROMPT_LENS)),
    "longctx": dict(name="longctx_b4_t4096_h4_d256", B=4, Tq=4096, Tk=4096,
                    H=4, D=256, causal=True),
}
DSPLIT_FORMS = {False: ("dsplit_launches", "bwd_dkv_dsplit_launches",
                        "bwd_dq_dsplit_launches"),
                True: ("dsplit_bf16_launches", "bwd_dkv_dsplit_bf16_launches",
                       "bwd_dq_dsplit_bf16_launches")}


def dsplit_bounds(B, Tq, Tk, H, D, pairs, n_lens, bf16):
    """{form: {"unsplit" | "split": (ms, "bytes" | "operations")}} of the
    forward, dkv and dq at head dim D with `pairs` visible pairs a head:
    the unsplit bound is the function's (each input read once, each
    output written once; 4 D flops a pair forward, 8 D dkv, 6 D dq), the
    split one the D-split's as it runs at the padded dim Dp (S, and in
    the backward dP, once per output chunk: ceil(Dp / 128) forward
    chunks, Dp / 64 backward ones; q and k, in the backward also dO, v,
    lse and delta, read once per chunk, every chunk's blocks needing all
    of them). f32: three TF32 passes over 495 TFLOP/s; bf16: one pass
    over 989."""
    Dp = -(-D // 64) * 64
    el, f32 = (2 if bf16 else 4), 4
    passes, peak = (1, H100_BF16_FLOPS) if bf16 else (3, H100_TF32_FLOPS)
    nc_f, nc_b = -(-Dp // 128), Dp // 64

    def tq(d):
        return B * Tq * H * d * el

    def tk(d):
        return B * Tk * H * d * el

    rows = B * H * Tq * f32
    lens = f32 * B * n_lens

    def bound(flops, nbytes):
        t_ops = passes * flops * H * pairs / peak * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    return {
        "fwd": {"unsplit": bound(4 * D, 2 * tq(D) + 2 * tk(D) + rows + lens),
                "split": bound((2 * nc_f + 2) * Dp,
                               nc_f * (tq(Dp) + tk(Dp)) + tk(Dp) + tq(Dp)
                               + rows + lens)},
        "dkv": {"unsplit": bound(8 * D, 2 * tq(D) + 4 * tk(D) + 2 * rows
                                 + lens),
                "split": bound((4 * nc_b + 4) * Dp,
                               nc_b * (2 * tq(Dp) + 2 * tk(Dp) + 2 * rows)
                               + 2 * tk(Dp) + lens)},
        "dq": {"unsplit": bound(6 * D, 3 * tq(D) + 2 * tk(D) + 2 * rows
                                + lens),
               "split": bound((4 * nc_b + 2) * Dp,
                              nc_b * (2 * tq(Dp) + 2 * tk(Dp)) + 2 * rows
                              + tq(Dp) + lens)},
    }


def check_dsplit(torch, fa, case, gen, bf16, timed=False):
    """Phase 3c: the D-split forms of B4f and B4b (f32, or bf16) against
    their plain versions on the card at one shape of head dim D > 128:
    f32 out and lse within TOL, dq, dk, dv within TOL of the largest
    entry; bf16 out within one bf16 ulp + BF16_OUT_FRAC of the largest,
    lse within TOL, the gradients within an ulp + BF16_GRAD_FRAC and no
    farther from the f32 plain backward than the bf16 plain one (within
    an ulp); rows without a visible key exactly out 0, lse 1e30 and dq 0,
    dk and dv of keys past kv_len exactly 0, everything finite and
    bit-identical on a repeat, and only the D-split forms launched (two
    of each). With `timed`, times the kernels (CUDA events), the plain
    versions and scaled_dot_product_attention's forward and backward (a
    yardstick the port never calls; f32 with the masks, bf16 with
    is_causal and no mask) beside the unsplit and the split bounds."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    if bf16:
        q, k, v, do = bf16_qkv(torch, case, gen, with_dout=True)
    else:
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda")
                       for s in ((B, Tq, H, D), (B, Tk, H, D),
                                 (B, Tk, H, D), (B, Tq, H, D)))
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    before = {n: getattr(fa, n) for n in fa.COUNTERS}
    out, lse = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    ran = flash_launched(fa, before)
    assert ran == dict.fromkeys(DSPLIT_FORMS[bf16], 2), (
        f"{case['name']}: launched {ran}")
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1]) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2)), (
        f"{case['name']}: D-split kernels not bit-identical on a repeat")
    del again, grads2
    plain = fa.attention_plain_bf16 if bf16 else fa.attention_plain
    plain_bwd = (fa.attention_bwd_plain_bf16 if bf16
                 else fa.attention_bwd_plain)
    out_p, lse_p = plain(q, k, v, **kw)
    ref = plain_bwd(q, k, v, out, lse, do, **kw)
    alive = lse_p < 1e29
    dead = ~alive
    err_lse = (lse - lse_p).abs()[alive].max().item()
    res = {"name": case["name"], "dtype": "bf16" if bf16 else "f32",
           "err_lse": err_lse, "max_abs_err": {}, "err": {}}
    res["max_abs_err"]["out"] = (out.float() - out_p.float()).abs().max(
    ).item()
    res["err"]["out"] = (bf16_beyond(torch, out, out_p) if bf16
                         else res["max_abs_err"]["out"])
    bound = {"out": BF16_OUT_FRAC if bf16 else TOL}
    for n, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == q.dtype and torch.isfinite(g).all().item(), (
            f"{case['name']}: {n}")
        res["max_abs_err"][n] = (g.float() - r.float()).abs().max().item()
        res["err"][n] = (bf16_beyond(torch, g, r) if bf16
                         else rel_err(g, r)[0])
        bound[n] = BF16_GRAD_FRAC if bf16 else TOL
    assert torch.isfinite(out).all().item() and err_lse <= TOL and all(
        res["err"][n] <= bound[n] for n in bound), (
        f"{case['name']}: D-split vs plain {res['err']}, lse {err_lse:.3g} "
        f"(bounds {bound})")
    if bf16:
        out32, lse32 = fa.attention_plain(q, k, v, **kw)
        exact = fa.attention_bwd_plain(q, k, v, out32, lse32, do, **kw)
        res["witness"] = {"out": no_farther(torch, out, out_p, out32,
                                            f"{case['name']} out")}
        for n, g, r, e in zip(("dq", "dk", "dv"), grads, ref, exact):
            res["witness"][n] = no_farther(torch, g, r, e,
                                           f"{case['name']} {n}")
        del out32, lse32, exact
    del ref
    res["masked_rows"] = int(dead.sum().item())
    if case.get("expect_dead"):
        assert res["masked_rows"] > 0, f"{case['name']}: expected dead rows"
    dead_q = dead.permute(0, 2, 1)
    assert bool((out[dead_q] == 0).all().item()
                and (lse[dead] == fa.LSE_MASKED).all().item()
                and (grads[0][dead_q] == 0).all().item()), (
        f"{case['name']}: rows without a key not exactly out 0, lse 1e30, "
        "dq 0")
    for b, n in enumerate(case.get("kv_len") or []):
        assert bool((grads[1][b, n:] == 0).all().item()
                    and (grads[2][b, n:] == 0).all().item()), (
            f"{case['name']}: dk, dv of keys past kv_len not exactly 0")
    if timed:
        res.update(time_dsplit(torch, fa, case, q, k, v, do, out, lse, kw,
                               bf16))
    print("dsplit " + json.dumps(res), flush=True)
    return res


def time_dsplit(torch, fa, case, q, k, v, do, out, lse, kw, bf16):
    """Phase 3c's times of the D-split forms at a path shape (D a
    multiple of 64, as the kernels take it): see check_dsplit."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    delta = fa.row_delta(do, out)
    r = {
        "fwd_ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)),
        "dkv_ms": time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw)),
        "dq_ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw)),
    }
    plain = fa.attention_plain_bf16 if bf16 else fa.attention_plain
    plain_bwd = (fa.attention_bwd_plain_bf16 if bf16
                 else fa.attention_bwd_plain)
    r["plain_fwd_ms"] = time_ms(torch, lambda: plain(q, k, v, **kw), reps=5,
                                warmup=1)
    r["plain_bwd_ms"] = time_ms(torch, lambda: plain_bwd(
        q, k, v, out, lse, do, **kw), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (None if bf16 else sdpa_mask(torch, B, Tq, Tk, case["causal"],
                                        kw["kv_len"], kw["q_len"]))
    causal = bf16 and case["causal"]

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, attn_mask=mask, is_causal=causal)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=mask,
                                 is_causal=causal), (qt, kt, vt), dot)

    r["library_fwd_ms"] = time_ms(torch, sdpa_fwd)
    r["library_bwd_ms"] = time_ms(torch, sdpa_fwd_bwd) - r["library_fwd_ms"]
    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    bounds = dsplit_bounds(B, Tq, Tk, H, D, pairs,
                           (kw["kv_len"] is not None)
                           + (kw["q_len"] is not None), bf16)
    for form, b in bounds.items():
        r[f"{form}_bound_ms"], r[f"{form}_bound_by"] = b["unsplit"]
        r[f"{form}_split_bound_ms"], r[f"{form}_split_bound_by"] = b["split"]
    r["pairs_per_head"] = pairs
    return r


def dsplit_kernels(torch, fa, gen):
    """Phase 3c: every D-split form against its plain version at
    DSPLIT_SHAPES and at the paths' shapes (DSPLIT_PATHS: f32 at the
    served prefill and LM (b)'s batch, bf16 at the long-context
    trainer's), timed at the latter. Returns {"checks": [...], "paths":
    {path: numbers}}."""
    checks = [check_dsplit(torch, fa, c, gen, bf16)
              for bf16 in (False, True) for c in DSPLIT_SHAPES]
    paths = {}
    for name, bf16 in (("served", False), ("lm", False), ("longctx", True)):
        paths[name] = check_dsplit(torch, fa, DSPLIT_PATHS[name], gen, bf16,
                                   timed=True)
        torch.cuda.empty_cache()
    return {"checks": checks + list(paths.values()), "paths": paths}


def lm_batches(rng, n, B, T, lens, vocab):
    """n next-token batches (ids, labels, lens): each row walks one
    fixed random permutation of the vocabulary from a random start and
    the label is the next token, so the target is learnable; ids and
    labels are 0 past each row's length."""
    perm = rng.permutation(vocab)
    live = np.arange(T)[None, :] < lens[:, None]
    out = []
    for _ in range(n):
        seq = np.empty((B, T + 1), np.int64)
        seq[:, 0] = rng.integers(0, vocab, B)
        for t in range(T):
            seq[:, t + 1] = perm[seq[:, t]]
        out.append(((seq[:, :-1] * live).astype(np.int32),
                    (seq[:, 1:] * live).astype(np.int32), lens))
    return out


def lm_feed(batch):
    from paddle_tpu_torch.core.arg import id_arg

    ids, lbl, lens = batch
    return {"ids": id_arg(ids, lens, device="cuda"),
            "label": id_arg(lbl, lens, device="cuda")}


# the port's kernels in a profile, by a piece of their (demangled) names:
# every template instantiation of one kernel adds to its row
PORT_KERNELS = {
    "B1 bn_act_conv1x1_fwd": "namespace)::fwd_kernel<",
    "B2 bn_act_conv1x1_bwd_dx": "bwd_dx_kernel<",
    "B3 bn_act_conv1x1_bwd_dw": "bwd_dw_kernel<",
    "B1 bn_act_conv1x1_fwd_bf16_wgmma": "namespace)::fwd_wgmma_kernel<",
    "B2 bn_act_conv1x1_bwd_dx_bf16_wgmma": "bwd_dx_wgmma_kernel<",
    "B3 bn_act_conv1x1_bwd_dw_bf16_wgmma": "bwd_dw_wgmma_kernel<",
    "B4f flash_attn_fwd": "flash_fwd_kernel<",
    "B4b flash_attn_bwd_dkv": "flash_bwd_dkv_kernel<",
    "B4b flash_attn_bwd_dq": "flash_bwd_dq_kernel<",
    "B4f flash_attn_fwd_bf16": "flash_fwd_wgmma_kernel<",
    "B4b flash_attn_bwd_dkv_bf16": "flash_bwd_dkv_wgmma_kernel<",
    "B4b flash_attn_bwd_dq_bf16": "flash_bwd_dq_wgmma_kernel<",
    "B4f flash_attn_fwd_dsplit":
        "fwd_kernel<(anonymous namespace)::dsplit::F32>",
    "B4b flash_attn_bwd_dkv_dsplit":
        "dkv_kernel<(anonymous namespace)::dsplit::F32>",
    "B4b flash_attn_bwd_dq_dsplit":
        "dq_kernel<(anonymous namespace)::dsplit::F32>",
    "B4f flash_attn_fwd_dsplit_bf16":
        "fwd_kernel<(anonymous namespace)::dsplit::BF16>",
    "B4b flash_attn_bwd_dkv_dsplit_bf16":
        "dkv_kernel<(anonymous namespace)::dsplit::BF16>",
    "B4b flash_attn_bwd_dq_dsplit_bf16":
        "dq_kernel<(anonymous namespace)::dsplit::BF16>",
    "B5 lstm_seq_fwd cluster walk": "lstm_fwd_cluster_kernel<",
    "B5 lstm_seq_fwd grid route": "lstm_fwd_grid_kernel<",
    "B6 lstm_seq_bwd cluster walk": "lstm_bwd_cluster_kernel<",
    "B6 lstm_seq_bwd grid route": "lstm_bwd_grid_kernel<",
    "B6 lstm_seq_bwd grid route's db7": "lstm_bias_grad_kernel",
    "B7 gru_seq_fwd cluster walk": "gru_fwd_cluster_kernel<",
    "B7 gru_seq_fwd grid route": "gru_fwd_grid_kernel<",
    "B8 gru_seq_bwd cluster walk": "gru_bwd_cluster_kernel<",
    "B8 gru_seq_bwd grid route": "gru_bwd_grid_kernel<",
    "B8 gru_seq_bwd grid route's db": "gru_bias_grad_kernel",
    # the cluster and grid routes' hoisted pre-activations and dW (B6's in
    # the classifier's step, B8's in the NMT's)
    "B6/B8 tc_kernel (hoisted products, dW)": "tc_kernel<",
}


def profile_fn(torch, fn, steps=5):
    """Where the time of fn() goes: `steps` calls under torch.profiler.
    Returns the device's kernel ms per call, the eight kernels with the
    most device time, the port's kernels' ms per call (all their
    instantiations), and the profile's own wall time with the
    profiler's post-processing; None when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    # the profiler now and then records no device activity at all (on an
    # H100, about once a smoke, at phase 5's smallest backward case): such
    # a window is taken again
    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0]
        if kernels:
            break
        print(f"profiler: no device time in window {attempt + 1}",
              flush=True)
    else:
        return None
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for label, piece in PORT_KERNELS.items():
        us = sum(e.self_device_time_total for e in kernels if piece in e.key)
        if us:
            port[label] = us / steps / 1e3
    return {
        "device_ms_per_step": busy_us / steps / 1e3,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "port_kernels_ms_per_step": port,
        "top": [{"name": e.key[:60], "ms_per_step":
                 e.self_device_time_total / steps / 1e3,
                 "calls_per_step": e.count / steps} for e in top],
        "steps": steps, "wall_s": time.perf_counter() - t0,
    }


def profile_steps(torch, sgd, feed, steps=5):
    """Where a train step's time goes: `steps` steps under
    torch.profiler, after the counted run (these launches are not the
    main path's)."""
    return profile_fn(torch, lambda: sgd.train_batch(feed), steps)


def held_flash_dense_step(torch, spec, np_params, name, batch):
    """One TrainStep of the LM's flash conf against the same step of its
    dense conf (plain torch): same params, same feed, momentum from a
    zero state, so each new momentum slot is -lr * the parameter's
    gradient. A ReLU whose preactivation lies within f32 rounding of 0
    can open in one step and not the other, and every gradient below it
    then differs by that token's share (LM (b) flips one). So the dense
    step runs at the flash step's gates: its feed-forward ReLUs become
    products with the flash step's 0/1 masks (the same function
    wherever the gates agree), and the loss and every gradient are held
    at TOL. Returns the numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import params_from_numpy

    opt_a = OptimizationConf(learning_method="momentum",
                             learning_rate=0.001, momentum=0.9)
    feed = lm_feed(batch)
    got = {}
    for impl in ("flash", "dense"):
        net = Network(lm.transformer_lm(dataclasses.replace(
            spec, attn_impl=impl)))
        params = params_from_numpy(np_params, device="cuda")
        with torch.no_grad():
            gates = [net.forward(params, feed)[0][f"lm_ff{i}"].value > 0
                     for i in range(spec.num_layers)]
        if impl == "dense":
            for i, mask in enumerate(got["flash"][2]):
                net.layers[f"lm_ff{i}"].activation = (
                    lambda m=mask: lambda y: y * m)
        opt = create_optimizer(opt_a, net.param_confs)
        step = TrainStep(net, opt, watchdog=True, device="cuda")
        _p, mom, _s, health, _o = step(params, opt.init_state(params),
                                       {}, feed, 0, None)
        got[impl] = (health, mom, gates)
    (hf, mf, gf), (hd, md, gd) = got["flash"], got["dense"]
    loss_rel = abs(hf[0].item() - hd[0].item()) / abs(hd[0].item())
    worst = max((rel_err(mf[k]["mom"], md[k]["mom"])[0], k) for k in md)
    flips = sum(int((a != b).sum().item()) for a, b in zip(gf, gd))
    r = {"loss_flash": hf[0].item(), "loss_dense": hd[0].item(),
         "loss_rel": loss_rel, "grad_rel": worst[0],
         "worst_param": worst[1],
         "relu_gate_flips_of_the_free_dense_step": flips,
         "finite": bool(hf[1].item() and hd[1].item())}
    print("flash vs dense (at the flash gates) train step " + json.dumps(
        {name: r}), flush=True)
    assert r["finite"] and loss_rel <= TOL, (
        f"flash and dense train steps disagree at {name}: {r}")
    assert worst[0] <= TOL, (
        f"flash and dense gradients disagree at {name}: {r}")
    return r


def train_lm(torch, fa):
    """Phase 6: the LM through the port's trainer on the card. Returns
    the numbers of both runs."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                     attn_impl="flash")
    conf = lm.transformer_lm(spec)
    np_params = random_params(spec, lm)
    rng = np.random.default_rng(SEED + 2)
    full = np.full((32,), 128, np.int32)
    ragged = np.asarray(PROMPT_LENS, np.int32)
    batches_a = lm_batches(rng, 20, 32, 128, full, spec.vocab)
    batch_b = lm_batches(rng, 1, 8, 1024, ragged, spec.vocab)[0]

    parity = {name: held_flash_dense_step(torch, spec, np_params, name,
                                          batch)
              for name, batch in (("b32_t128", batches_a[0]),
                                  ("b8_t1024", batch_b))}

    runs = {}
    for name, opt, batches, ntok in (
        ("a_momentum_b32_t128",
         OptimizationConf(learning_method="momentum", learning_rate=0.001,
                          momentum=0.9),
         batches_a, int(full.sum())),
        ("b_adam_b8_t1024_ragged",
         OptimizationConf(learning_method="adam", learning_rate=LR_B),
         [batch_b] * STEPS_B, int(ragged.sum())),
    ):
        sgd = SGD(conf, opt, params=params_from_numpy(np_params, "cuda"),
                  device="cuda")
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)          # fetched: the step is done
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
        t0 = time.perf_counter()
        sgd.train(reader=lambda b=batches: iter(b), feeder=lm_feed,
                  num_passes=1, event_handler=on_event)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa.launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
        steps = len(batches)
        steady = np.diff(stamps) * 1e3           # ms per step after the 1st
        r = {
            "steps": steps, "wall_s": wall,
            "ms_per_step_median": float(np.median(steady)),
            "ms_first_step": (stamps[0] - t0) * 1e3,
            "train_tokens_per_s": ntok / (float(np.median(steady)) / 1e3),
            "real_tokens_per_step": ntok,
            "loss_first": costs[0], "loss_last": costs[-1],
            "launches_fwd": counts[0], "launches_bwd_dkv": counts[1],
            "launches_bwd_dq": counts[2],
        }
        print(f"train {name} " + json.dumps(r), flush=True)
        assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
        want = spec.num_layers * steps
        assert counts == (want, want, want), (
            f"{name}: launches {counts}, want {want} of each kernel")
        prof = profile_steps(torch, sgd, lm_feed(batches[0]))
        if prof is not None:
            # the device's idle share of an unprofiled step
            prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                      / r["ms_per_step_median"])
        print(f"profile {name} " + json.dumps(prof), flush=True)
        runs[name] = r
    b = runs["b_adam_b8_t1024_ragged"]
    assert b["loss_last"] <= 0.5 * b["loss_first"], (
        f"phase (b) loss fell only from {b['loss_first']:.4g} to "
        f"{b['loss_last']:.4g}")
    return parity, runs


# Phases 6c and 13b hold each gradient of one AMP step against the f32
# step's from the same weights. A gradient's distance is the norm of the
# difference over the norm of the f32 gradient, or over AMP_GRAD_FLOOR
# of the model's largest such norm where its own is below that (the
# NMT's attention decoder projection at init: 6e-9 of it, its bf16
# value rounding noise in either package). The norm, not the largest
# entry: a max pool's argmax or a ReLU gate that bf16 rounding flips
# moves whole rows of a gradient (the classifier's T = 100 max pool: up
# to 0.44 of the largest entry), and the norm reads them at their
# weight. The bound is 2e-2 plus twice the largest such distance bf16
# moves the JAX package's gradient of the same model at these widths
# (tests/test_torch_amp.py::test_card_amp_readings measures them on the
# CPU at a cut batch and holds these numbers), never more than 0.3 (a
# zeroed gradient reads 1, a flipped one 2). Phase 6d holds the flash
# step's gradients against the dense step's, both under the flag, to
# the bound of its conf (each is about that distance from f32).
AMP_GRAD_TOL, AMP_GRAD_CAP, AMP_GRAD_FLOOR = 2e-2, 0.3, 1e-4
JAX_BF16_GRAD_MOVE = {"lm": 0.0616, "classifier": 0.125, "nmt": 0.0452,
                      "longctx": 0.0874}


def amp_grad_distances(st_amp, st_f32, slot):
    """{parameter: distance} of one AMP optimizer step's gradients from
    the f32 step's, read from `slot` (momentum's, or adam's first moment:
    after one step from zero, a fixed multiple of the gradient)."""
    top = max(v[slot].norm().item() for v in st_f32.values())
    return {k: (st_amp[k][slot] - v[slot]).norm().item()
            / max(v[slot].norm().item(), AMP_GRAD_FLOOR * top)
            for k, v in st_f32.items()}


def amp_grads_held(name, model, st_amp, st_f32, slot):
    """Every gradient of one AMP step within min(AMP_GRAD_TOL + 2 *
    JAX_BF16_GRAD_MOVE[model], AMP_GRAD_CAP) of the f32 step's. Returns
    the largest distance."""
    bound = min(AMP_GRAD_TOL + 2 * JAX_BF16_GRAD_MOVE[model], AMP_GRAD_CAP)
    d = amp_grad_distances(st_amp, st_f32, slot)
    worst = max(d, key=d.get)
    print(f"amp gradients vs f32 {name} " + json.dumps(
        {"bound": bound, "worst": worst, "each": d}), flush=True)
    assert d[worst] <= bound, (
        f"{name}: gradient {worst} moved {d[worst]:.3g} from f32 under "
        f"the flag, bound {bound:.3g}")
    return d[worst]


def train_lm_amp(torch, fa):
    """Phase 6c: the LM at bench.py::bench_lm_train's settings (B=32,
    T=128, d 256, 4 heads, 2 layers, vocab 2048, dense attention,
    momentum 0.001 / 0.9) under the bf16 flag. First one momentum
    TrainStep in f32 and one under the flag from the same weights on
    phase 6(a)'s first batch: every gradient held (`amp_grads_held`).
    Then 20 steps of `SGD.train` on (a)'s next-token batches: every loss
    finite, the last below the first, the first within 5% of the f32
    step's loss (tests/test_amp.py's bound), and no flash kernel
    launched (dense attention). Returns the run's numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                     attn_impl="dense")
    conf = lm.transformer_lm(spec)
    opt_conf = OptimizationConf(learning_method="momentum",
                                learning_rate=0.001, momentum=0.9)
    np_params = random_params(spec, lm)
    rng = np.random.default_rng(SEED + 2)     # phase 6(a)'s batches
    full = np.full((32,), 128, np.int32)
    batches = lm_batches(rng, 20, 32, 128, full, spec.vocab)
    net = Network(conf)
    held = {}
    for amp in (False, True):
        set_amp(amp)
        try:
            opt = create_optimizer(opt_conf, net.param_confs)
            p = params_from_numpy(np_params, "cuda")
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            _p, mom, _s, health, _o = step(p, opt.init_state(p), {},
                                           lm_feed(batches[0]), 0, None)
            held[amp] = (health[0].item(), bool(health[1].item()), mom)
        finally:
            set_amp(False)
    loss_f32 = held[False][0]
    assert held[True][1], "lm amp: the held step is not finite"
    grad_worst = amp_grads_held("lm_amp_dense_b32_t128", "lm", held[True][2],
                                held[False][2], "mom")
    set_amp(True)
    try:
        sgd = SGD(conf, opt_conf,
                  params=params_from_numpy(np_params, "cuda"),
                  device="cuda")
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)          # fetched: the step is done
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
        t0 = time.perf_counter()
        sgd.train(reader=lambda: iter(batches), feeder=lm_feed,
                  num_passes=1, event_handler=on_event)
        torch.cuda.synchronize()
        counts = (fa.launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
        steady = float(np.median(np.diff(stamps))) * 1e3
        ntok = int(full.sum())
        r = {"steps": len(batches), "wall_s": time.perf_counter() - t0,
             "ms_first_step": (stamps[0] - t0) * 1e3,
             "ms_per_step_median": steady,
             "train_tokens_per_s": ntok / (steady / 1e3),
             "loss_f32_first_batch": loss_f32,
             "held_step_loss_amp": held[True][0],
             "held_step_grad_rel_vs_f32_max": grad_worst,
             "loss_first": costs[0], "loss_last": costs[-1],
             "first_vs_f32_rel": abs(costs[0] - loss_f32) / abs(loss_f32),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "flash_launches": list(counts),
             "master_dtypes": sorted({str(v.dtype)
                                      for v in sgd.params.values()})}
        print("train lm_amp_dense_b32_t128 " + json.dumps(r), flush=True)
        prof = profile_steps(torch, sgd, lm_feed(batches[0]))
        if prof is not None:
            prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
        print("profile lm_amp_dense_b32_t128 " + json.dumps(prof),
              flush=True)
    finally:
        set_amp(False)
    r["profile"] = prof
    assert np.isfinite(costs).all(), "lm amp: a loss is not finite"
    assert costs[-1] < costs[0], (
        f"lm amp: loss rose from {costs[0]:.6g} to {costs[-1]:.6g}")
    assert r["first_vs_f32_rel"] <= 0.05, (
        f"lm amp: first loss {costs[0]:.6g} vs f32 {loss_f32:.6g}")
    assert counts == (0, 0, 0), f"lm amp: flash launched {counts}"
    assert r["master_dtypes"] == ["torch.float32"], r["master_dtypes"]
    return r


# ---- the long-context trainer under the bf16 flag (phase 6d) -----------

# bench.py::bench_longctx's settings (:629; its conf longctx_conf :576,
# its feed longctx_feed :602): vocab 32000, d 512, 8 heads (D = 64), 2
# layers, 512 classes, adam 1e-3; (B, T, steps an arm) of its two rows
LONGCTX = dict(d=512, heads=8, layers=2, classes=512, vocab=32000)
LONGCTX_LR = 1e-3
LONGCTX_RUNS = ((4, 4096, 20), (1, 8192, 10))
LONGCTX_WINDOW = 5                 # steps a timing window


def longctx_conf(d=512, heads=8, layers=2, classes=512, attn_impl="dense",
                 vocab=32000):
    """bench.py::longctx_conf (:576-600) in the port's DSL, on one
    device: embedding -> `layers` causal multi-head attention blocks
    with a residual fc -> a per-token classifier."""
    from paddle_tpu_torch import dsl

    with dsl.model() as m:
        ids = dsl.data("ids", dim=(), is_ids=True, is_seq=True)
        lbl = dsl.data("label", dim=(), is_ids=True, is_seq=True)
        x = dsl.embedding(ids, size=d, vocab_size=vocab)
        for _ in range(layers):
            att = dsl._add(
                "multi_head_attention", [x], size=d,
                num_heads=heads, causal=True,
                seq_parallel="none", attn_impl=attn_impl,
            )
            x = dsl.addto(att, dsl.fc(att, size=d, act="relu"))
        out = dsl.fc(x, size=classes, act="")
        dsl.classification_cost(out, lbl)
    return m.conf


def longctx_feed(bs, t, classes=512, vocab=32000, device="cuda"):
    """bench.py::longctx_feed (:602, seed 0) on `device`: random ids and
    labels, every row full length."""
    from paddle_tpu_torch.core.arg import id_arg

    rng = np.random.default_rng(0)
    lens = np.full((bs,), t, np.int32)
    return {
        "ids": id_arg(rng.integers(0, vocab, (bs, t)).astype(np.int32),
                      lens, device=device),
        "label": id_arg(rng.integers(0, classes, (bs, t)).astype(np.int32),
                        lens, device=device),
    }


def longctx_params(torch, cfg=LONGCTX):
    """The long-context model's weights from a seed, as numpy (both arms
    and tests/test_torch_amp.py's reading start from them)."""
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.weights import params_to_numpy

    return params_to_numpy(Network(longctx_conf(**cfg)).init_params(
        torch.Generator().manual_seed(SEED + 3), device="cpu"))


def flash_launched(fa, before):
    """{counter: launches since `before`} of the counters that moved."""
    return {n: getattr(fa, n) - c for n, c in before.items()
            if getattr(fa, n) != c}


BF16_FORMS = ("bf16_launches", "bwd_dkv_bf16_launches",
              "bwd_dq_bf16_launches")


def longctx_held_step(torch, fa, np_params, feed, cfg=LONGCTX,
                      forms=BF16_FORMS):
    """Phase 6d (a): one adam TrainStep of the flash conf and one of the
    dense conf from one weight map, both under the bf16 flag: both
    finite, the losses within 5% (tests/test_amp.py's bound), every
    gradient (adam's first moment) held as 6c holds its own
    (`amp_grads_held`, the bound from the JAX package's bf16 distance of
    this conf), the flash step's bf16 forms (`forms`: the D-split's at
    28(c)) launched once a layer and no other flash form, the dense step
    no flash form."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import params_from_numpy

    got = {}
    set_amp(True)
    try:
        for impl in ("flash", "dense"):
            net = Network(longctx_conf(attn_impl=impl, **cfg))
            opt = create_optimizer(OptimizationConf(
                learning_method="adam", learning_rate=LONGCTX_LR),
                net.param_confs)
            p = params_from_numpy(np_params, "cuda")
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            torch.cuda.synchronize()
            before = {n: getattr(fa, n) for n in fa.COUNTERS}
            _p, st, _s, health, _o = step(p, opt.init_state(p), {}, feed, 0,
                                          None)
            torch.cuda.synchronize()
            got[impl] = (health[0].item(), bool(health[1].item()), st,
                         flash_launched(fa, before))
            del _p, _o, p, step
    finally:
        set_amp(False)
    (lf, ff, sf, cf), (ld, fd, sd, cd) = got["flash"], got["dense"]
    layers = cfg["layers"]
    r = {"loss_flash": lf, "loss_dense": ld, "rel": abs(lf - ld) / abs(ld),
         "finite": ff and fd, "launches_flash": cf, "launches_dense": cd,
         "grad_dtypes": sorted({str(v["m"].dtype) for v in sf.values()})}
    print("longctx held amp step flash vs dense " + json.dumps(r),
          flush=True)
    assert r["finite"] and r["rel"] <= 0.05, f"longctx held step: {r}"
    assert r["grad_dtypes"] == ["torch.float32"], r
    assert cf == dict.fromkeys(forms, layers), cf
    assert cd == {}, f"the dense step launched {cd}"
    r["grad_rel_max"] = amp_grads_held(
        f"longctx_flash_vs_dense_b4_t4096_d{cfg['d']}_h{cfg['heads']}",
        "longctx", sf, sd, "m")
    return r


def longctx_train(torch, fa, np_params, B, T, steps, cfg=LONGCTX,
                  forms=BF16_FORMS):
    """Phase 6d (b), (c): `steps` adam steps of the flash arm and of the
    dense arm under the bf16 flag through `SGD.train_batch`, each arm its
    own SGD from one weight map on bench.py::longctx_feed's fixed batch,
    in windows of LONGCTX_WINDOW steps taken in turns as
    bench.py::_interleaved_best takes them (each arm's best window is
    its ms/step). Every loss finite and each arm's last below its first;
    the flash arm launches each bf16 form once a layer a step and no f32
    form (`forms`: the D-split's at 28(c)), the dense arm no flash form.
    Reports ms/step, tokens/s (B*T a
    step), fused_speedup (dense ms / flash ms), the peak memory of each
    arm's windows, and each arm's profile. Returns the numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    feed = longctx_feed(B, T, cfg["classes"], cfg["vocab"])
    opt = OptimizationConf(learning_method="adam", learning_rate=LONGCTX_LR)
    set_amp(True)
    try:
        arms = {impl: SGD(longctx_conf(attn_impl=impl, **cfg), opt,
                          params=params_from_numpy(np_params, "cuda"),
                          device="cuda")
                for impl in ("flash", "dense")}
        r = {impl: {"losses": [], "windows_ms": [], "launches": {},
                    "peak_mem_gb": 0.0} for impl in arms}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        for _ in range(steps // LONGCTX_WINDOW):
            for impl, sgd in arms.items():
                a = r[impl]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = {n: getattr(fa, n) for n in fa.COUNTERS}
                t0 = time.perf_counter()
                for _ in range(LONGCTX_WINDOW):
                    a["losses"].append(sgd.train_batch(feed))  # fetched
                a["windows_ms"].append(
                    (time.perf_counter() - t0) * 1e3 / LONGCTX_WINDOW)
                for n, c in flash_launched(fa, before).items():
                    a["launches"][n] = a["launches"].get(n, 0) + c
                a["peak_mem_gb"] = max(a["peak_mem_gb"],
                                       torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
        for impl, sgd in arms.items():
            a = r[impl]
            a["ms_per_step"] = min(a["windows_ms"])
            a["tokens_per_s"] = B * T / (a["ms_per_step"] / 1e3)
            a["loss_first"], a["loss_last"] = a["losses"][0], a["losses"][-1]
            prof = profile_fn(torch, lambda s=sgd: s.train_batch(feed),
                              steps=3)
            if prof is not None:
                prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                          / a["ms_per_step"])
            print(f"profile longctx_{impl}_b{B}_t{T} " + json.dumps(prof),
                  flush=True)
            a["profile"] = prof
    finally:
        set_amp(False)
    out = {"B": B, "T": T, "steps_per_arm": steps,
           "resident_gb_before_windows": resident,
           "fused_speedup": (r["dense"]["ms_per_step"]
                             / r["flash"]["ms_per_step"]),
           **{impl: {k: v for k, v in a.items() if k != "profile"}
              for impl, a in r.items()}}
    print(f"train longctx_amp_b{B}_t{T}_d{cfg['d']} " + json.dumps(out),
          flush=True)
    want = steps * cfg["layers"]
    for impl, a in r.items():
        assert np.isfinite(a["losses"]).all(), f"longctx {impl}: a loss"
        assert a["loss_last"] < a["loss_first"], (
            f"longctx {impl} B={B} T={T}: loss rose from "
            f"{a['loss_first']:.6g} to {a['loss_last']:.6g}")
    assert r["flash"]["launches"] == dict.fromkeys(forms, want), (
        f"longctx flash arm launched {r['flash']['launches']}")
    assert r["dense"]["launches"] == {}, (
        f"longctx dense arm launched {r['dense']['launches']}")
    return out


def train_longctx_amp(torch, fa):
    """Phase 6d: the long-context trainer (bench.py::bench_longctx's
    conf, feed and adam) under the bf16 flag, attn_impl flash against
    dense: (a) the held step at B=4, T=4096; (b) 20 steps an arm at B=4,
    T=4096; (c) 10 an arm at B=1, T=8192. Returns ((a), [(b), (c)])."""
    np_params = longctx_params(torch)
    B, T, _steps = LONGCTX_RUNS[0]
    held = longctx_held_step(torch, fa, np_params,
                             longctx_feed(B, T, LONGCTX["classes"],
                                          LONGCTX["vocab"]))
    runs = [longctx_train(torch, fa, np_params, B, T, steps)
            for B, T, steps in LONGCTX_RUNS]
    return held, runs


# ---- ResNet-50 and the fused BN->ReLU->1x1-conv kernels (B1-B3) ---------

# the 29 fused sites of a ResNet-50 forward: (name, rows an image, Cin,
# Cout, act, sites)
FUSED_SITES = [
    ("res2a_a", 3136, 64, 64, "", 1),
    ("res2bc_a", 3136, 256, 64, "", 2),
    ("res3bcd_a", 784, 512, 128, "", 3),
    ("res4b-f_a", 196, 1024, 256, "", 5),
    ("res5bc_a", 49, 2048, 512, "", 2),
    ("res2_tail", 3136, 64, 256, "relu", 3),
    ("res3_tail", 784, 128, 512, "relu", 4),
    ("res4_tail", 196, 256, 1024, "relu", 6),
    ("res5_tail", 49, 512, 2048, "relu", 3),
]
# ragged against the 128-row tile and the 64/128-column tiles
FUSED_RAGGED = [("n100_24_16", 100, 24, 16), ("n1_24_16", 1, 24, 16),
                ("n517_70_130", 517, 70, 130), ("n300_200_72", 300, 200, 72)]
RESNET_OPT = dict(learning_method="momentum", learning_rate=0.001,
                  momentum=0.9)
RESNET_STEPS = 30
# phase 9c: bench.py::bench_resnet50's batch under the bf16 flag
RESNET_AMP_BATCH = 256
RESNET_AMP_STEPS = 20
RESNET_AMP_PLAIN_STEPS = 10
# steps a ResNet-50 run's profile covers (~5 800 kernels a step): cut
# from 5 to 2 when phase 26 brought the smoke's result line to 1052.9 s
# on an H100, where the four 5-step windows took 87 s
RESNET_PROFILE_STEPS = 2


def fused_inputs(torch, gen, n, cin, cout, with_res):
    """u, scale, shift, w, residual and the cotangents dy, d1, d2 of one
    case, on the card (the scale of d2 keeps 2*y*d2 near dy's)."""
    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    u, scale, shift = rnd(n, cin), rnd(cin), rnd(cin)
    w = rnd(cin, cout, s=(2.0 / cin) ** 0.5)
    res = rnd(n, cin) if with_res else None
    return u, scale, shift, w, res, rnd(n, cout), rnd(cout), rnd(cout, s=0.1)


def check_fused(torch, op, name, inputs, act):
    """The three fused kernels against their plain versions on one
    case's inputs: max |diff| / max |plain| <= TOL for y, ssum, ssq, du,
    dscale, dshift, dres and dw, and every output bit-identical on a
    repeat. Returns {output: (relative, absolute)}."""
    u, scale, shift, w, res, dy, d1, d2 = inputs
    got = op.bn_act_conv1x1_fwd(u, scale, shift, w, res, act)
    ref = op.bn_act_conv1x1_plain(u, scale, shift, w, res, act)
    y = ref[0]
    got += op.bn_act_conv1x1_bwd_dx(u, scale, shift, w, res, y, dy, d1, d2,
                                    act)
    ref += op.bn_act_conv1x1_bwd_dx_plain(u, scale, shift, w, res, y, dy, d1,
                                          d2, act)
    got += (op.bn_act_conv1x1_bwd_dw(u, scale, shift, res, y, dy, d1, d2,
                                     act),)
    ref += (op.bn_act_conv1x1_bwd_dw_plain(u, scale, shift, res, y, dy, d1,
                                           d2, act),)
    again = op.bn_act_conv1x1_fwd(u, scale, shift, w, res, act)
    again += op.bn_act_conv1x1_bwd_dx(u, scale, shift, w, res, y, dy, d1, d2,
                                      act)
    again += (op.bn_act_conv1x1_bwd_dw(u, scale, shift, res, y, dy, d1, d2,
                                       act),)
    torch.cuda.synchronize()
    for out, a, b in zip(("y", "ssum", "ssq", "du", "dscale", "dshift",
                          "dres", "dw"), got, again):
        assert (a is None and b is None) or torch.equal(a, b), (
            f"{name} act={act!r}: {out} not bit-identical on a repeat")
    errs = {}
    for out, g, r in zip(("y", "ssum", "ssq", "du", "dscale", "dshift",
                          "dres", "dw"), got, ref):
        if r is None:
            assert g is None, f"{name}: {out} should be None"
            continue
        assert torch.isfinite(g).all().item(), f"{name}: {out} not finite"
        errs[out] = rel_err(g, r)
        assert errs[out][0] <= TOL, (
            f"{name} act={act!r} res={res is not None}: kernel vs plain "
            f"{out} relative error {errs[out][0]:.3g} > {TOL}")
    return errs


def time_fused(torch, op, site, batch, gen):
    """Kernel, plain, GEMM-alone (torch.matmul, f32, TF32 off: a
    yardstick the port never calls) and bound ms of B1, B2 and B3 at one
    site of the path (act as the layers call it, no residual)."""
    name, rows, cin, cout, act, count = site
    n = rows * batch
    inputs = fused_inputs(torch, gen, n, cin, cout, False)
    errs = check_fused(torch, op, f"{name}_b{batch}", inputs, act)
    u, scale, shift, w, _res, dy, d1, d2 = inputs
    y = op.bn_act_conv1x1_plain(u, scale, shift, w, None, act)[0]
    z = u * scale + shift
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    f32 = 4
    flops = 2 * n * cin * cout

    def bound(nbytes):
        # on the tensor cores in three TF32 passes (hi*hi + hi*lo + lo*hi)
        t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    nu, ny, nw = n * cin * f32, n * cout * f32, cin * cout * f32
    vin, vout = 2 * cin * f32, 2 * cout * f32
    kern = {
        # u, scale, shift, w read; y, ssum, ssq written
        "fwd": (lambda: op.bn_act_conv1x1_fwd(u, scale, shift, w, None, act),
                lambda: op.bn_act_conv1x1_plain(u, scale, shift, w, None,
                                                act),
                lambda: torch.matmul(z, w),
                bound(nu + vin + nw + ny + vout)),
        # u, scale, shift, w, y, dy, d1, d2 read; du, dscale, dshift
        # written
        "bwd_dx": (lambda: op.bn_act_conv1x1_bwd_dx(
            u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dx_plain(
                u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: torch.matmul(dy, w.t()),
            bound(nu + vin + nw + 2 * ny + vout + nu + vin)),
        # u, scale, shift, y, dy, d1, d2 read; dw written
        "bwd_dw": (lambda: op.bn_act_conv1x1_bwd_dw(
            u, scale, shift, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dw_plain(
                u, scale, shift, None, y, dy, d1, d2, act),
            lambda: torch.matmul(z.t(), dy),
            bound(nu + vin + 2 * ny + vout + nw)),
    }
    res = {"site": name, "n": n, "cin": cin, "cout": cout, "act": act,
           "sites": count, "flops": flops,
           "max_abs_err": max(e[1] for e in errs.values()),
           "max_rel_err": {k: v[0] for k, v in errs.items()},
           "plan": op.launch_plan(n, cin, cout)}
    for k, (kfn, pfn, lfn, (b_ms, b_by)) in kern.items():
        res[k] = {"ms": time_ms(torch, kfn), "plain_ms": time_ms(torch, pfn),
                  "library_ms": time_ms(torch, lfn), "bound_ms": b_ms,
                  "bound_by": b_by}
    print("fused timing " + json.dumps(res), flush=True)
    return res


def fused_kernels(torch, op):
    """Phase 7: every site shape at batch 32 and the ragged shapes, each
    with act in {relu, ""} x residual in {none, given}; then times at
    the training shapes (batch 64). Returns (max abs error per kernel,
    timings)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    which = {"y": "fwd", "ssum": "fwd", "ssq": "fwd", "du": "bwd_dx",
             "dscale": "bwd_dx", "dshift": "bwd_dx", "dres": "bwd_dx",
             "dw": "bwd_dw"}
    cases = [(f"{s[0]}_b32", s[1] * 32, s[2], s[3]) for s in FUSED_SITES]
    cases += FUSED_RAGGED
    n_checked = 0
    for name, n, cin, cout in cases:
        rels = {}
        for act in ("relu", ""):
            for with_res in (False, True):
                errs = check_fused(torch, op, name, fused_inputs(
                    torch, gen, n, cin, cout, with_res), act)
                n_checked += 1
                for out, (rel, ab) in errs.items():
                    worst[which[out]] = max(worst[which[out]], ab)
                    rels[out] = max(rels.get(out, 0.0), rel)
        print(f"fused {name} N={n} {cin}->{cout}: max relative error "
              + json.dumps(rels), flush=True)
    print(f"fused kernels equal their plain versions in {n_checked} cases",
          flush=True)
    timings = [time_fused(torch, op, site, 64, gen) for site in FUSED_SITES]
    per_step = {k: {m: sum(t["sites"] * t[k][m] for t in timings)
                    for m in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for k in ("fwd", "bwd_dx", "bwd_dw")}
    print("fused kernels, sum over the 29 sites of one step at batch 64 "
          "(ms) " + json.dumps(per_step), flush=True)
    return worst, timings


# a B3 row split into two chunks whose boundary falls inside a 64-row
# stage (304 rows a chunk): B3's plan must split it so
FUSED_SPLIT_BF16 = ("n600_64_64_split2", 600, 64, 64)
# the bf16 forms take widths that are multiples of 8: ragged rows against
# the 128-row tile, a width past the 64/128-column tiles; then the edges of
# the wgmma kernels' 128 x 128 tiles (B1's 128 x 64 at Cout <= 64, 128 x
# 256 at Cout >= 256) and 64-row stages (rows 1, 127, 129, 255, 257; Cin
# and Cout 8, 72, 136, 200, 2048; Cout 264 past a 256-column tile; Cin 520
# and 2056 with a partial last stage), the split above, and three of B1's
# persistent walks (one a tile width) long enough that its ring and y
# buffers wrap
FUSED_RAGGED_BF16 = [("n100_24_16", 100, 24, 16), ("n1_24_16", 1, 24, 16),
                     ("n517_72_136", 517, 72, 136),
                     ("n300_200_72", 300, 200, 72),
                     ("n1_8_8", 1, 8, 8), ("n127_8_72", 127, 8, 72),
                     ("n129_72_8", 129, 72, 8),
                     ("n255_136_200", 255, 136, 200),
                     ("n257_200_136", 257, 200, 136),
                     ("n129_2048_72", 129, 2048, 72),
                     ("n257_72_2048", 257, 72, 2048), FUSED_SPLIT_BF16,
                     ("n127_64_8", 127, 64, 8), ("n129_520_64", 129, 520, 64),
                     ("n257_2056_264", 257, 2056, 264),
                     ("n4001_72_1032", 4001, 72, 1032),
                     ("n20001_72_200", 20001, 72, 200),
                     ("n118301_64_64", 118301, 64, 64)]
FUSED_OUTS = ("y", "ssum", "ssq", "du", "dscale", "dshift", "dres", "dw")


def fused_inputs_bf16(torch, gen, n, cin, cout, with_res):
    """fused_inputs with u, w, residual and dy in bf16 (scale, shift,
    d1, d2 stay f32, as the AMP rule hands them to the op)."""
    u, scale, shift, w, res, dy, d1, d2 = fused_inputs(torch, gen, n, cin,
                                                       cout, with_res)
    b = torch.bfloat16
    return (u.to(b), scale, shift, w.to(b),
            None if res is None else res.to(b), dy.to(b), d1, d2)


def check_fused_bf16(torch, op, name, inputs, act):
    """The bf16 forms of B1-B3 against their bf16 plain versions on one
    case's inputs: the f32 outputs (ssum, ssq, dscale, dshift, and dw
    before its cast) within TOL of the largest; the bf16 outputs (y, du,
    dres, and dw after its cast) element by element within one bf16 ulp
    plus TOL of the largest; every output bit-identical on a repeat; no
    f32 form launched. Returns {output: (relative, absolute)}."""
    u, scale, shift, w, res, dy, d1, d2 = inputs
    ref = op.bn_act_conv1x1_plain(u, scale, shift, w, res, act)
    y = ref[0]
    ref += op.bn_act_conv1x1_bwd_dx_plain(u, scale, shift, w, res, y, dy, d1,
                                          d2, act)
    ref += (op.bn_act_conv1x1_bwd_dw_plain(u, scale, shift, res, y, dy, d1,
                                           d2, act),)
    f32_before = (op.fwd_launches, op.bwd_dx_launches, op.bwd_dw_launches)

    def run():
        return (op.bn_act_conv1x1_fwd(u, scale, shift, w, res, act)
                + op.bn_act_conv1x1_bwd_dx(u, scale, shift, w, res, y, dy,
                                           d1, d2, act)
                + (op.bn_act_conv1x1_bwd_dw(u, scale, shift, res, y, dy, d1,
                                            d2, act),))

    got, again = run(), run()
    torch.cuda.synchronize()
    assert (op.fwd_launches, op.bwd_dx_launches,
            op.bwd_dw_launches) == f32_before, f"{name}: an f32 form ran"
    where = f"{name} act={act!r} res={res is not None}"
    errs = {}
    for out, g, g2, r in zip(FUSED_OUTS, got, again, ref):
        if r is None:
            assert g is None and g2 is None, f"{name}: {out} should be None"
            continue
        assert torch.equal(g, g2), f"{where}: {out} not bit-identical"
        assert g.dtype == r.dtype, f"{where}: {out} is {g.dtype}"
        assert torch.isfinite(g).all().item(), f"{where}: {out} not finite"
        errs[out] = rel_err(g.float(), r.float())
        if g.dtype == torch.bfloat16:
            # where the kernel's and the plain version's f32 accumulators
            # straddle a rounding boundary, that single flip is all the
            # bound admits
            off = bf16_beyond(torch, g, r)
            assert off <= TOL, (f"{where}: {out} {off:.3g} of the largest "
                                f"beyond one bf16 ulp (> {TOL})")
        else:
            assert errs[out][0] <= TOL, (
                f"{where}: kernel vs plain {out} relative error "
                f"{errs[out][0]:.3g} > {TOL}")
    b = torch.bfloat16          # dw as the Function returns it to a bf16 w
    off = bf16_beyond(torch, got[-1].to(b), ref[-1].to(b))
    assert off <= TOL, f"{where}: bf16 dw {off:.3g} beyond the bound"
    errs["dw_bf16"] = rel_err(got[-1].to(b).float(), ref[-1].to(b).float())
    return errs


def time_fused_bf16(torch, op, site, batch, gen):
    """The bf16 forms' kernel, plain, GEMM-alone (torch.matmul of the
    bf16 operands: a yardstick the port never calls) and bound ms at one
    site of the path (act as the layers call it, no residual). The
    bound: bf16 u, w, y, dy, du in bytes, f32 vectors and dw (B3 writes
    it in f32), and one bf16 pass on the tensor cores."""
    name, rows, cin, cout, act, count = site
    n = rows * batch
    inputs = fused_inputs_bf16(torch, gen, n, cin, cout, False)
    errs = check_fused_bf16(torch, op, f"{name}_b{batch}", inputs, act)
    u, scale, shift, w, _res, dy, d1, d2 = inputs
    y = op.bn_act_conv1x1_plain(u, scale, shift, w, None, act)[0]
    z = u.float() * scale + shift
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    z = z.to(torch.bfloat16)
    flops = 2 * n * cin * cout

    def bound(nbytes):
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    nu, ny, nw = 2 * n * cin, 2 * n * cout, 2 * cin * cout
    vin, vout = 2 * cin * 4, 2 * cout * 4
    kern = {
        # u, scale, shift, w read; y, ssum, ssq written
        "fwd": (lambda: op.bn_act_conv1x1_fwd(u, scale, shift, w, None, act),
                lambda: op.bn_act_conv1x1_plain(u, scale, shift, w, None,
                                                act),
                lambda: torch.matmul(z, w),
                bound(nu + vin + nw + ny + vout)),
        # u, scale, shift, w, y, dy, d1, d2 read; du, dscale, dshift
        # written
        "bwd_dx": (lambda: op.bn_act_conv1x1_bwd_dx(
            u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dx_plain(
                u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: torch.matmul(dy, w.t()),
            bound(nu + vin + nw + 2 * ny + vout + nu + vin)),
        # u, scale, shift, y, dy, d1, d2 read; dw (f32) written
        "bwd_dw": (lambda: op.bn_act_conv1x1_bwd_dw(
            u, scale, shift, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dw_plain(
                u, scale, shift, None, y, dy, d1, d2, act),
            lambda: torch.matmul(z.t(), dy),
            bound(nu + vin + 2 * ny + vout + 2 * nw)),
    }
    res = {"site": name, "n": n, "cin": cin, "cout": cout, "act": act,
           "sites": count, "flops": flops,
           "max_abs_err": max(e[1] for e in errs.values()),
           "max_rel_err": {k: v[0] for k, v in errs.items()},
           "plan": op.launch_plan(n, cin, cout, dtype=torch.bfloat16)}
    for k, (kfn, pfn, lfn, (b_ms, b_by)) in kern.items():
        res[k] = {"ms": time_ms(torch, kfn), "plain_ms": time_ms(torch, pfn),
                  "library_ms": time_ms(torch, lfn), "bound_ms": b_ms,
                  "bound_by": b_by}
    print("fused bf16 timing " + json.dumps(res), flush=True)
    return res


def fused_kernels_bf16(torch, op):
    """Phase 7b: the bf16 forms at every site shape at batch 32 and the
    bf16 ragged shapes, each with act in {relu, ""} x residual in {none,
    given}; then times at the bench's training shapes (batch 256).
    Returns (max abs error per kernel, timings)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    # the kernels' own outputs (dw_bf16, the Function's cast of B3's f32
    # dw, is held by check_fused_bf16 and printed, not a kernel's error)
    which = {"y": "fwd", "ssum": "fwd", "ssq": "fwd", "du": "bwd_dx",
             "dscale": "bwd_dx", "dshift": "bwd_dx", "dres": "bwd_dx",
             "dw": "bwd_dw"}
    cases = [(f"{s[0]}_b32", s[1] * 32, s[2], s[3]) for s in FUSED_SITES]
    cases += FUSED_RAGGED_BF16
    split = op.launch_plan(*FUSED_SPLIT_BF16[1:],
                           dtype=torch.bfloat16)["bwd_dw"]
    assert (split["blocks"] == 2 and split["chunk"] % 64
            and split["chunk"] < FUSED_SPLIT_BF16[1]), (
        f"{FUSED_SPLIT_BF16[0]}: B3's rows not split mid-stage: {split}")
    n_checked = 0
    for name, n, cin, cout in cases:
        rels = {}
        for act in ("relu", ""):
            for with_res in (False, True):
                errs = check_fused_bf16(torch, op, name, fused_inputs_bf16(
                    torch, gen, n, cin, cout, with_res), act)
                n_checked += 1
                for out, (rel, ab) in errs.items():
                    if out in which:
                        worst[which[out]] = max(worst[which[out]], ab)
                    rels[out] = max(rels.get(out, 0.0), rel)
        print(f"fused bf16 {name} N={n} {cin}->{cout}: max relative error "
              + json.dumps(rels), flush=True)
    print(f"fused bf16 forms meet their bounds in {n_checked} cases",
          flush=True)
    timings = [time_fused_bf16(torch, op, site, RESNET_AMP_BATCH, gen)
               for site in FUSED_SITES]
    per_step = {k: {m: sum(t["sites"] * t[k][m] for t in timings)
                    for m in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for k in ("fwd", "bwd_dx", "bwd_dw")}
    print(f"fused bf16 forms, sum over the 29 sites of one step at batch "
          f"{RESNET_AMP_BATCH} (ms) " + json.dumps(per_step), flush=True)
    return worst, timings


def image_feed(batch, seed):
    """bench.py::_image_feed on the card: N(0, 1) images, random labels."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    rng = np.random.default_rng(seed)
    image = rng.standard_normal((batch, 224, 224, 3)).astype(np.float32)
    label = rng.integers(0, 1000, batch).astype(np.int32)
    return {"image": non_seq(image, device="cuda"),
            "label": id_arg(label, device="cuda")}


def resnet_nets(torch):
    """The plain and fused ResNet-50 networks, the plain weights from a
    seed, and the plain state advanced by three train-mode forwards (so
    the running statistics are not their initial values)."""
    from paddle_tpu_torch.models.image import resnet
    from paddle_tpu_torch.network import Network

    plain = Network(resnet(50, (224, 224, 3), 1000, fused=False))
    fused = Network(resnet(50, (224, 224, 3), 1000, fused=True))
    params = plain.init_params(torch.Generator().manual_seed(SEED),
                               device="cuda")
    state = plain.init_state("cuda")
    with torch.no_grad():
        for i in range(3):
            feed = image_feed(8, SEED + 10 + i)
            _o, state = plain.forward(params, feed, state=state, train=True,
                                      outputs=["output"])
    return plain, fused, params, state


def resnet_infer(torch, op, plain, fused, params, state):
    """Phase 8: the [8, 224, 224, 3] forward of __graft_entry__.entry()
    through Inferencer, plain and fused from mapped weights and state;
    logits within TOL of the largest, 29 B1 launches a fused forward."""
    from paddle_tpu_torch.trainer.trainer import Inferencer
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    feed = {"image": image_feed(8, SEED + 20)["image"]}
    out = {}
    for name, net, p, st in (("plain", plain, params, state),
                             ("fused", fused, fparams, fstate)):
        inf = Inferencer(net, p, st, outputs=["output"], device="cuda")
        inf.infer(feed)                       # warm: cuDNN picks its algos
        torch.cuda.synchronize()
        op.fwd_launches = 0
        t0 = time.perf_counter()
        logits = inf.infer(feed)["output"]
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = (logits, ms, op.fwd_launches)
    (lp, ms_p, _), (lf, ms_f, launches) = out["plain"], out["fused"]
    rel = float(np.abs(lf - lp).max() / np.abs(lp).max())
    r = {"shape": list(lp.shape), "finite": bool(np.isfinite(lf).all()),
         "logits_rel": rel, "plain_ms": ms_p, "fused_ms": ms_f,
         "fused_images_per_s": 8 / (ms_f / 1e3), "b1_launches": launches}
    print("resnet50 inference " + json.dumps(r), flush=True)
    assert r["shape"] == [8, 1000] and r["finite"]
    assert rel <= TOL, f"fused and plain logits differ by {rel:.3g}"
    assert launches == 29, f"{launches} B1 launches in a fused forward"
    return r


def relu_gates(torch, plain, fused, params, fparams, state, fstate, feed):
    """ReLU gate flips between the two graphs on one train-mode forward,
    per gate site of the fused graph: {fused layer: flips}. The tail's
    in-gate is recomputed from its input as the layer computes it."""
    from paddle_tpu_torch.layers.norm import bn_affine, moments

    with torch.no_grad():
        po, _ = plain.forward(params, feed, state=state, train=True)
        fo, _ = fused.forward(fparams, feed, state=fstate, train=True)
        flips = {}
        for name in fused.order:
            lc = fused.conf.layer(name)
            if lc.type == "batch_norm" and lc.active_type == "relu":
                pairs = [(fo[name].value, po[name].value)]
            elif lc.type == "fused_conv1x1_bn":
                pairs = [(fo[name].value, po[f"{name}_bn"].value)]
            elif lc.type == "fused_bottleneck_tail":
                blk = name[:-len("_tail")]
                x = fo[lc.input_names()[0]].value
                g = fparams[f"_{name}.bnig"], fparams[f"_{name}.bnib"]
                scale, shift = bn_affine(*g, *moments(x), 1e-5)
                pairs = [(fo[name].value, po[f"{blk}_add"].value),
                         (x * scale + shift, po[f"{blk}_b_bn"].value)]
            else:
                continue
            flips[name] = sum(int(((a > 0) != (b > 0)).sum().item())
                              for a, b in pairs)
    return flips


def held_step(torch, plain, fused, params, state, feed, name):
    """One momentum TrainStep of the fused graph against the plain graph
    from mapped weights and state: loss, the new BN state and every
    gradient (from the new momentum, -lr * grad) within TOL of the
    largest entry. A flipped ReLU gate moves every gradient below it
    (PR 2's lesson), so a gradient is held only when its layer comes
    after every gate that flipped."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import fused_resnet_from_plain, \
        fused_resnet_map

    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    pmap, smap = fused_resnet_map(fused)
    got = {}
    for arm, net, p, st in (("plain", plain, params, state),
                            ("fused", fused, fparams, fstate)):
        opt = create_optimizer(OptimizationConf(**RESNET_OPT),
                               net.param_confs)
        step = TrainStep(net, opt, watchdog=True, device="cuda")
        _p, mom, new_state, health, _o = step(p, opt.init_state(p), st, feed,
                                              0, None)
        got[arm] = (health, mom, new_state)
    (hp, mp, sp), (hf, mf, sf) = got["plain"], got["fused"]
    loss_rel = abs(hf[0].item() - hp[0].item()) / abs(hp[0].item())
    flips = relu_gates(torch, plain, fused, params, fparams, state, fstate,
                       feed)
    index = {n: i for i, n in enumerate(fused.order)}
    highest_flip = max((index[n] for n, f in flips.items() if f),
                       default=-1)
    owner = {g: layer for layer, slots in fused.layer_params.items()
             for g in slots.values()}
    held, free = {}, {}
    for k, src in pmap.items():
        e = rel_err(mf[k]["mom"].reshape(mp[src]["mom"].shape),
                    mp[src]["mom"])[0]
        (held if index[owner[k]] > highest_flip else free)[k] = e
    state_rel = max(rel_err(sf[layer][s], sp[pl][ps])[0]
                    for layer, slots in smap.items()
                    for s, (pl, ps) in slots.items())
    r = {"loss_plain": hp[0].item(), "loss_fused": hf[0].item(),
         "loss_rel": loss_rel, "finite": bool(hp[1].item() and hf[1].item()),
         "relu_gate_flips": sum(flips.values()),
         "flips_by_site": {n: f for n, f in flips.items() if f},
         "grads_held": len(held), "grads_total": len(pmap),
         "grad_rel_held_max": max(held.values(), default=0.0),
         "grad_rel_unheld_max": max(free.values(), default=0.0),
         "state_rel_max": state_rel}
    print(f"fused vs plain train step {name} " + json.dumps(r), flush=True)
    assert r["finite"] and loss_rel <= TOL, f"{name}: losses disagree: {r}"
    assert state_rel <= TOL, f"{name}: the new BN state disagrees: {r}"
    assert r["grad_rel_held_max"] <= TOL, f"{name}: gradients disagree: {r}"
    return r


def tiny_resnet(fused):
    """test_layers_extras.py::TestFusedBottleneck's two-block net: few
    enough ReLU gates that none flips, so every gradient is held."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.models.image import _bottleneck
    from paddle_tpu_torch.network import Network

    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        lbl = dsl.data("label", (1,), is_ids=True)
        h = _bottleneck("blk_a", img, 4, 1, project=True, fused=fused)
        h = _bottleneck("blk_b", h, 4, 1, project=False, fused=fused)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        out = dsl.fc(h, size=3, name="output", act="softmax")
        dsl.classification_cost(out, lbl, name="cost")
    return Network(g.conf)


FUSED_COUNTERS = ("fwd_launches", "bwd_dx_launches", "bwd_dw_launches",
                  "fwd_bf16_launches", "bwd_dx_bf16_launches",
                  "bwd_dw_bf16_launches")


def resnet_train(torch, op, conf, batch, steps, name, amp=False):
    """Phase 9(b) and 9c: SGD.train (momentum 0.001 / 0.9) on one fixed
    batch, under the bf16 flag with `amp`; returns the run's numbers
    (every fused kernel's launch count, f32 and bf16 forms, read just
    after)."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    set_amp(amp)
    try:
        sgd = SGD(conf, OptimizationConf(**RESNET_OPT), seed=SEED + 1,
                  device="cuda")
        feed = image_feed(batch, SEED + 40)
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)          # fetched: the step is done
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in FUSED_COUNTERS:
            setattr(op, c, 0)
        t0 = time.perf_counter()
        sgd.train(reader=lambda: iter([feed] * steps), feeder=lambda b: b,
                  num_passes=1, event_handler=on_event)
        torch.cuda.synchronize()
        counts = {c: getattr(op, c) for c in FUSED_COUNTERS}
        steady = float(np.median(np.diff(stamps))) * 1e3
        r = {"steps": steps, "batch": batch, "amp": amp,
             "wall_s": time.perf_counter() - t0,
             "ms_first_step": (stamps[0] - t0) * 1e3,
             "ms_per_step_median": steady,
             "images_per_s": batch / (steady / 1e3),
             "loss_first": costs[0], "loss_last": costs[-1],
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches_fwd": counts["fwd_launches"],
             "launches_bwd_dx": counts["bwd_dx_launches"],
             "launches_bwd_dw": counts["bwd_dw_launches"],
             "launches_bf16": {c: v for c, v in counts.items()
                               if "bf16" in c}}
        print(f"train {name} " + json.dumps(r), flush=True)
        assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
        prof = profile_steps(torch, sgd, feed, RESNET_PROFILE_STEPS)
    finally:
        set_amp(False)
    if prof is not None:
        prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
    print(f"profile {name} " + json.dumps(prof), flush=True)
    r["profile"] = prof
    return r


def amp_arms(torch, plain, fused, params, state, feed):
    """One momentum TrainStep from one weight map four ways: plain f32,
    plain under the bf16 flag, fused under the flag, and the witness, the
    plain f32 step on the weights and images rounded to bf16 (a
    perturbation of 2^-9 of each entry, no bf16 arithmetic). Returns
    {arm: (health, momentum slots, new state)}."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    def rounded(t):
        return t.to(torch.bfloat16).float() if t.is_floating_point() else t

    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    rparams = {k: rounded(v) for k, v in params.items()}
    rfeed = {k: a if a.value is None else
             dataclasses.replace(a, value=rounded(a.value))
             for k, a in feed.items()}
    got = {}
    for arm, net, p, st, f, amp in (
            ("plain_f32", plain, params, state, feed, False),
            ("plain_amp", plain, params, state, feed, True),
            ("fused_amp", fused, fparams, fstate, feed, True),
            ("witness_f32_rounded_inputs", plain, rparams, state, rfeed,
             False)):
        set_amp(amp)
        try:
            opt = create_optimizer(OptimizationConf(**RESNET_OPT),
                                   net.param_confs)
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            _p, mom, new_state, health, _o = step(p, opt.init_state(p), st,
                                                  f, 0, None)
        finally:
            set_amp(False)
        got[arm] = (health, mom, new_state)
    return got


def amp_grads_vs_f32(fused, got, dist):
    """{fused parameter: {arm: dist(its gradient, the plain f32 step's)}}
    for the fused AMP, plain AMP and witness arms (gradients read from
    the new momentum, -lr * grad)."""
    from paddle_tpu_torch.weights import fused_resnet_map

    pmap, _smap = fused_resnet_map(fused)
    m32, mp, mf, mw = (got[a][1] for a in (
        "plain_f32", "plain_amp", "fused_amp", "witness_f32_rounded_inputs"))
    return {k: {"fused_amp": dist(mf[k]["mom"].reshape(
                    m32[src]["mom"].shape), m32[src]["mom"]),
                "plain_amp": dist(mp[src]["mom"], m32[src]["mom"]),
                "witness": dist(mw[src]["mom"], m32[src]["mom"])}
            for k, src in pmap.items()}


def grad_spread(grads, arm):
    v = np.sort([g[arm] for g in grads.values()])
    return {"min": float(v[0]), "median": float(np.median(v)),
            "max": float(v[-1])}


def held_amp_step(torch, plain, fused, params, state, feed):
    """Phase 9c(a): one momentum TrainStep at B=8 four ways from one
    weight map (`amp_arms`). The fused-AMP step's loss, new BN state and
    each gradient are held against the plain f32 step's within twice the
    plain-AMP step's own distance from it plus 1e-3 (relative; the state
    over all its slots). The witness's distances show how far this net
    at this batch carries bf16's rounding of its inputs alone: on batch
    statistics at init, most gradients move by more than half their norm
    (so the gradient bound here is near 1 or above; `held_amp_blocks`
    holds the same arms where it is small)."""
    from paddle_tpu_torch.weights import fused_resnet_map

    _pmap, smap = fused_resnet_map(fused)
    got = amp_arms(torch, plain, fused, params, state, feed)
    (h32, _m32, s32), (hp, _mp, sp), (hf, mf, sf), (hw, _mw, _sw) = (
        got["plain_f32"], got["plain_amp"], got["fused_amp"],
        got["witness_f32_rounded_inputs"])
    ref = h32[0].item()
    loss = {"plain_amp": abs(hp[0].item() - ref) / abs(ref),
            "fused_amp": abs(hf[0].item() - ref) / abs(ref),
            "witness": abs(hw[0].item() - ref) / abs(ref)}
    st = {"plain_amp": max(rel_err(sp[pl][ps], s32[pl][ps])[0]
                           for slots in smap.values()
                           for (pl, ps) in slots.values()),
          "fused_amp": max(rel_err(sf[layer][s], s32[pl][ps])[0]
                           for layer, slots in smap.items()
                           for s, (pl, ps) in slots.items())}
    grads = amp_grads_vs_f32(fused, got, lambda a, b: rel_err(a, b)[0])
    outside = [k for k, g in grads.items()
               if g["fused_amp"] > 2 * g["plain_amp"] + 1e-3]
    r = {"loss_f32": ref, "loss_plain_amp": hp[0].item(),
         "loss_fused_amp": hf[0].item(), "loss_witness": hw[0].item(),
         "loss_rel_vs_f32": loss, "state_rel_vs_f32": st,
         "finite": bool(h32[1].item() and hp[1].item() and hf[1].item()),
         "grads_outside_the_bound": outside, "grads_total": len(grads),
         "grad_rel_vs_f32": {a: grad_spread(grads, a) for a in
                             ("fused_amp", "plain_amp", "witness")},
         "output_fc_grad_rel_vs_f32": {k: grads[k] for k in
                                       ("_output.w0", "_output.wbias")},
         "master_dtypes": sorted({str(v["mom"].dtype) for v in mf.values()})}
    print("amp train step resnet50_b8 " + json.dumps(r), flush=True)
    print("amp train step resnet50_b8 gradients vs f32 " + json.dumps(grads),
          flush=True)
    assert r["finite"], r
    assert loss["fused_amp"] <= 2 * loss["plain_amp"] + 1e-3, r
    assert st["fused_amp"] <= 2 * st["plain_amp"] + 1e-3, r
    assert not outside, f"gradients outside the bound: {outside}"
    assert r["master_dtypes"] == ["torch.float32"], r
    return r


# phase 9c(a)'s hold that can fail: the four arms of `amp_arms` on fewer
# blocks at ResNet-50's widths, two fused bottlenecks at res4's (14 x 14 x
# 1024 in, 256 wide; six ReLU layers), where a 2^-9 rounding of the inputs
# moves no gradient by more than ~0.14 in relative L2 (at ResNet-50's 53
# layers at init it moves most of them by more than their norm: the
# witness of `held_amp_step`); every gradient's bound must be below the
# ceiling, where a zeroed or a doubled gradient (1.0 from f32) fails
AMP_BLOCKS = dict(image=(14, 14, 1024), ch=256, blocks=2, batch=32)
AMP_BOUND_CEILING = 0.5


def amp_blocks_net(fused):
    """AMP_BLOCKS' net: its bottlenecks (`_bottleneck`, fused or plain),
    an average pool and a 1000-way classifier."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.models.image import _bottleneck
    from paddle_tpu_torch.network import Network

    img = AMP_BLOCKS["image"]
    with dsl.model() as g:
        h = dsl.data("image", img)
        lbl = dsl.data("label", (1,), is_ids=True)
        for i in range(AMP_BLOCKS["blocks"]):
            h = _bottleneck(f"blk{i}", h, AMP_BLOCKS["ch"], 1, project=False,
                            fused=fused)
        h = dsl.pool(h, img[0], 1, pool_type="avg")
        dsl.classification_cost(dsl.fc(h, size=1000, name="output"), lbl,
                                name="cost")
    return Network(g.conf)


def rel_l2(got, ref):
    """|got - ref| / |ref| in the L2 norm, in f64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm())


def held_amp_blocks(torch, op):
    """Phase 9c(a), the hold that can fail: `amp_arms` on
    `amp_blocks_net` (B1-B3's bf16 forms at res4's sites) at B = 32. The
    fused AMP step's loss and each gradient against the plain f32 step's
    within twice the plain AMP step's own distance plus 1e-3, in relative
    L2, as `held_amp_step`'s rule; every gradient's bound below
    AMP_BOUND_CEILING; B1-B3's bf16 forms launched in the fused arm."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    plain, fused = amp_blocks_net(False), amp_blocks_net(True)
    params = plain.init_params(torch.Generator().manual_seed(SEED),
                               device="cuda")
    rng = np.random.default_rng(SEED + 32)
    b = AMP_BLOCKS["batch"]
    feed = {"image": non_seq(rng.standard_normal(
                (b,) + AMP_BLOCKS["image"]).astype(np.float32), device="cuda"),
            "label": id_arg(rng.integers(0, 1000, b).astype(np.int32),
                            device="cuda")}
    before = {c: getattr(op, c) for c in FUSED_COUNTERS}
    got = amp_arms(torch, plain, fused, params, plain.init_state("cuda"),
                   feed)
    launched = {c: getattr(op, c) - before[c] for c in FUSED_COUNTERS}
    grads = amp_grads_vs_f32(fused, got, rel_l2)
    bounds = {k: 2 * g["plain_amp"] + 1e-3 for k, g in grads.items()}
    outside = [k for k, g in grads.items() if g["fused_amp"] > bounds[k]]
    ref = got["plain_f32"][0][0].item()
    loss = {a: abs(got[a][0][0].item() - ref) / abs(ref)
            for a in ("plain_amp", "fused_amp")}
    r = {"net": AMP_BLOCKS, "loss_f32": ref, "loss_rel_vs_f32": loss,
         "finite": all(bool(got[a][0][1].item()) for a in got),
         "bf16_launches": {c: v for c, v in launched.items() if v},
         "grads": len(grads), "grads_outside_the_bound": outside,
         "bound_max": max(bounds.values()),
         "grad_rel_l2_vs_f32": {a: grad_spread(grads, a) for a in (
             "fused_amp", "plain_amp", "witness")},
         "worst_fused_over_bound": max((g["fused_amp"] / bounds[k], k)
                                       for k, g in grads.items())}
    print("amp train step two res4 blocks " + json.dumps(r), flush=True)
    assert r["finite"], r
    assert all(launched[c] for c in FUSED_COUNTERS if "bf16" in c), r
    assert loss["fused_amp"] <= 2 * loss["plain_amp"] + 1e-3, r
    assert not outside, f"gradients outside the bound: {outside}"
    assert r["bound_max"] < AMP_BOUND_CEILING, (
        f"a gradient bound of {r['bound_max']:.3g} would pass a zeroed "
        "gradient")
    return r


def resnet_training_amp(torch, op, plain, fused, params, state):
    """Phase 9c: ResNet-50 under the bf16 flag at bench_resnet50's
    settings. (a) the held B=8 step four ways, and the same four arms on
    two res4 blocks (`held_amp_blocks`); (b) 20 fused steps at
    B=256 (each bf16 form 29 launches a step, no f32 form); (c) 10 plain
    steps at B=256."""
    held = held_amp_step(torch, plain, fused, params, state,
                         image_feed(8, SEED + 30))
    held_blocks = held_amp_blocks(torch, op)
    b = resnet_train(torch, op, fused.conf, RESNET_AMP_BATCH,
                     RESNET_AMP_STEPS,
                     f"resnet50_fused_amp_b{RESNET_AMP_BATCH}", amp=True)
    assert b["loss_last"] < b["loss_first"], (
        f"loss rose from {b['loss_first']:.4g} to {b['loss_last']:.4g}")
    want = 29 * RESNET_AMP_STEPS
    assert b["launches_bf16"] == dict.fromkeys(
        ("fwd_bf16_launches", "bwd_dx_bf16_launches",
         "bwd_dw_bf16_launches"), want), (
        f"bf16 launches {b['launches_bf16']}, want {want} of each")
    assert (b["launches_fwd"], b["launches_bwd_dx"],
            b["launches_bwd_dw"]) == (0, 0, 0), "an f32 form launched"
    p = resnet_train(torch, op, plain.conf, RESNET_AMP_BATCH,
                     RESNET_AMP_PLAIN_STEPS,
                     f"resnet50_plain_amp_b{RESNET_AMP_BATCH}", amp=True)
    assert p["loss_last"] < p["loss_first"], (
        f"plain amp loss rose from {p['loss_first']:.4g} to "
        f"{p['loss_last']:.4g}")
    assert p["launches_fwd"] == 0 and not any(p["launches_bf16"].values())
    return (held, held_blocks), b, p


def resnet_training(torch, op, plain, fused, params, state):
    """Phase 9: (a) the held step: ResNet-50 at B=8, and the two-block
    net of the CPU tests, where every gradient is held; (b) 30 steps of
    the fused graph at B=64 (and 10 of the plain graph, for its step
    time)."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    held = held_step(torch, plain, fused, params, state,
                     image_feed(8, SEED + 30), "resnet50_b8")
    tp, tf = tiny_resnet(False), tiny_resnet(True)
    rng = np.random.default_rng(SEED + 31)
    tiny = held_step(
        torch, tp, tf,
        tp.init_params(torch.Generator().manual_seed(SEED), device="cuda"),
        tp.init_state("cuda"),
        {"image": non_seq(rng.standard_normal((4, 8, 8, 16)).astype(
            np.float32), device="cuda"),
         "label": id_arg(rng.integers(0, 3, 4).astype(np.int32),
                         device="cuda")}, "two_blocks_b4")
    print(f"two-block held step: {tiny['relu_gate_flips']} ReLU gates "
          f"flipped", flush=True)
    assert tiny["relu_gate_flips"] == 0 and (
        tiny["grads_held"] == tiny["grads_total"]), (
        "the two-block held step needs a feed whose ReLU gates agree")
    b = resnet_train(torch, op, fused.conf, 64, RESNET_STEPS,
                     "resnet50_fused_b64")
    assert b["loss_last"] < b["loss_first"], (
        f"loss rose from {b['loss_first']:.4g} to {b['loss_last']:.4g}")
    want = 29 * RESNET_STEPS
    got = (b["launches_fwd"], b["launches_bwd_dx"], b["launches_bwd_dw"])
    assert got == (want, want, want), (
        f"launches {got}, want {want} of each fused kernel")
    assert not any(b["launches_bf16"].values()), "a bf16 form launched"
    p = resnet_train(torch, op, plain.conf, 64, 10, "resnet50_plain_b64")
    assert p["launches_fwd"] == 0
    return (held, tiny), b, p


# ---- the sequence slice: LSTM/GRU kernels (B5-B8), classifier, NMT -------

# the bench rows at their published widths (bench.py bench_lstm, bench_nmt)
CLS = dict(vocab_size=30000, emb_dim=128, hidden=256, num_layers=2,
           num_classes=2)
CLS_B, CLS_T, CLS_STEPS, CLS_LR = 64, 100, 30, 2e-3
NMT = dict(src_vocab=30000, trg_vocab=30000, emb_dim=512, hidden=512)
NMT_B, NMT_T, NMT_STEPS, NMT_LR = 256, 32, 20, 1e-3
SCAN_STEPS = 10
# (name, cell, B, T, h, lens or None for full): the path shapes (both
# classifier layers; the NMT encoder, h = 512 / 2 a direction; phase 13d's
# encoders, h = 512 at bench_nmt's B and T, and RNNsearch's h = 1000 at
# its B = 80, T = 50), the bench's other LSTM and GRU widths, h = 336
# (B7 on the cluster route, B8 on the grid route), and ragged cases with
# a zero length and a length of 1
RAGGED = [37, 0, 1, 20, 36, 5, 37, 2, 11]
RNN_CASES = [
    ("classifier_b64_t100_h256", "lstm", CLS_B, CLS_T, 256, None),
    ("nmt_enc_b256_t32_h256", "gru", NMT_B, NMT_T, 256, None),
    ("lstm_b64_t100_h512", "lstm", CLS_B, CLS_T, 512, None),
    ("lstm_b64_t100_h1280", "lstm", CLS_B, CLS_T, 1280, None),
    ("gru_b256_t32_h512", "gru", NMT_B, NMT_T, 512, None),
    ("gru_b256_t32_h1280", "gru", NMT_B, NMT_T, 1280, None),
    ("gru_b80_t50_h1000", "gru", 80, 50, 1000, None),
    ("gru_ragged_b37_t9_h1000", "gru", 37, 9, 1000,
     [9, 0, 1] + [(4 * i) % 9 + 1 for i in range(34)]),
    ("gru_ragged_b6_t7_h336", "gru", 6, 7, 336, [7, 0, 1, 7, 3, 5]),
    ("lstm_ragged_b9_t37_h256", "lstm", 9, 37, 256, RAGGED),
    ("gru_ragged_b9_t37_h256", "gru", 9, 37, 256, RAGGED),
]
RNN_COUNTERS = ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
                "lstm_fwd_grid_launches", "lstm_fwd_infer_launches",
                "lstm_fwd_infer_cluster_launches",
                "lstm_fwd_infer_grid_launches", "lstm_bwd_launches",
                "lstm_bwd_cluster_launches", "lstm_bwd_grid_launches",
                "gru_fwd_launches", "gru_fwd_cluster_launches",
                "gru_fwd_grid_launches", "gru_bwd_launches",
                "gru_bwd_cluster_launches", "gru_bwd_grid_launches")


def zero_rnn_counts(rnn):
    for c in RNN_COUNTERS:
        setattr(rnn, c, 0)


def rnn_counts(rnn):
    return {c: getattr(rnn, c) for c in RNN_COUNTERS}


def rnn_inputs(torch, gen, cell, b, t, h, lens):
    """x, the weights at the layers' init scale (1/sqrt(h)), biases, lens
    and dy of one case, on the card."""
    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    live = np.full(b, t) if lens is None else np.asarray(lens)
    lens_t = torch.as_tensor(live, dtype=torch.int32, device="cuda")
    if cell == "lstm":
        ws = (rnd(h, 4 * h, s=h ** -0.5), rnd(7 * h, s=0.1))
        x = rnd(b, t, 4 * h)
    else:
        ws = (rnd(h, 2 * h, s=h ** -0.5), rnd(h, h, s=h ** -0.5),
              rnd(3 * h, s=0.1))
        x = rnd(b, t, 3 * h)
    return x, ws, lens_t, rnd(b, t, h), int(live.sum())


def check_rnn(torch, rnn, case, gen):
    """B5 (both variants) and B6, or B7 and B8, against their plain
    versions at one case: max |diff| / max |plain| <= TOL for every
    output, exactly 0 past each row's length; each kernel on the route
    of its rule (`rnn.fwd_plan`, `rnn.bwd_plan`), bit-identical on a
    repeat, and, where it is the cluster route, on the grid route too;
    then kernel, plain, other route and cuDNN
    (torch.nn.LSTM/GRU: another function — no peepholes, its own input
    GEMM, no masks; a reference point only) times and the bounds.
    Returns the case's numbers."""
    name, cell, b, t, h, lens = case
    x, ws, lens_t, dy, live = rnn_inputs(torch, gen, cell, b, t, h, lens)
    dead = torch.arange(t, device="cuda")[None, :] >= lens_t[:, None]
    f32 = 4
    second = "grid"          # beside the cluster route
    if cell == "lstm":
        w, b7 = ws
        parts = torch.split(b7, [4 * h, h, h, h])
        y, c = rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=True)
        y_noc, _ = rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=False)
        yp, cp = rnn.lstm_plain(x, w, *parts, lens_t, want_c=True)
        got = (y, c) + rnn.lstm_seq_bwd(x, w, b7, lens_t, yp, cp, dy)
        ref = (yp, cp) + rnn.lstm_bwd_plain(x, w, b7, lens_t, yp, cp, dy)
        names = ("y", "c", "dx", "dw", "db7")
        which = {"y": "fwd", "c": "fwd", "dx": "bwd", "dw": "bwd",
                 "db7": "bwd"}
        kern = {
            "fwd": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=True),
            "fwd_infer": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t,
                                                  want_c=False),
            "bwd": lambda: rnn.lstm_seq_bwd(x, w, b7, lens_t, yp, cp, dy)}
        fwd_second = {
            "fwd": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=True,
                                            route=second),
            "fwd_infer": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t,
                                                  want_c=False,
                                                  route=second)}

        def bwd_second():
            return rnn.lstm_seq_bwd(x, w, b7, lens_t, yp, cp, dy,
                                    route=second)

        plain = {
            "fwd": lambda: rnn.lstm_plain(x, w, *parts, lens_t, want_c=True),
            "fwd_infer": lambda: rnn.lstm_plain(x, w, *parts, lens_t),
            "bwd": lambda: rnn.lstm_bwd_plain(x, w, b7, lens_t, yp, cp, dy)}
        mac = live * h * 4 * h           # one [h] @ [h, 4h] a live step
        seq = b * t * h * f32
        io = x.numel() * f32 + (w.numel() + b7.numel() + b) * f32
        # fwd: x, w, b7, lens read, y (and c) written; bwd: + y, c, dy
        # read, dx, dw, db7 written; 2 flops a MAC: fwd one product a
        # step, bwd three (the recomputed gates, dh = dg w^T, dW)
        work = {"fwd": (2 * mac, io + 2 * seq),
                "fwd_infer": (2 * mac, io + seq),
                "bwd": (6 * mac, io + 3 * seq + x.numel() * f32
                        + (w.numel() + b7.numel()) * f32)}
        cudnn = torch.nn.LSTM(h, h, batch_first=True).cuda()
        assert bool(torch.equal(y, y_noc)), f"{name}: the variants differ"
    else:
        w_g, w_c, bias = ws
        y = rnn.gru_seq_fwd(x, w_g, w_c, bias, lens_t)
        yp = rnn.gru_plain(x, w_g, w_c, bias, lens_t)
        got = (y,) + rnn.gru_seq_bwd(x, w_g, w_c, bias, lens_t, yp, dy)
        ref = (yp,) + rnn.gru_bwd_plain(x, w_g, w_c, bias, lens_t, yp, dy)
        names = ("y", "dx", "dw_g", "dw_c", "db")
        which = {"y": "fwd", "dx": "bwd", "dw_g": "bwd", "dw_c": "bwd",
                 "db": "bwd"}
        kern = {"fwd": lambda: (rnn.gru_seq_fwd(x, w_g, w_c, bias, lens_t),),
                "bwd": lambda: rnn.gru_seq_bwd(x, w_g, w_c, bias, lens_t, yp,
                                               dy)}
        fwd_second = {"fwd": lambda: (rnn.gru_seq_fwd(x, w_g, w_c, bias,
                                                      lens_t, route=second),)}

        def bwd_second():
            return rnn.gru_seq_bwd(x, w_g, w_c, bias, lens_t, yp, dy,
                                   route=second)

        plain = {"fwd": lambda: rnn.gru_plain(x, w_g, w_c, bias, lens_t),
                 "bwd": lambda: rnn.gru_bwd_plain(x, w_g, w_c, bias, lens_t,
                                                  yp, dy)}
        mac = live * h * h               # [h] @ [h, h] a live step
        seq = b * t * h * f32
        wts = (w_g.numel() + w_c.numel() + bias.numel()) * f32
        io = x.numel() * f32 + wts + b * f32
        # fwd: 3 h^2 MACs a step (u, r and c); bwd: 9 (the recomputed
        # gates 3, d(rh) 1, dh 2, dW_g 2, dW_c 1)
        work = {"fwd": (6 * mac, io + seq),
                "bwd": (18 * mac, io + 2 * seq + x.numel() * f32 + wts)}
        cudnn = torch.nn.GRU(h, h, batch_first=True).cuda()
    torch.cuda.synchronize()
    errs = {}
    for n, g, r in zip(names, got, ref):
        assert torch.isfinite(g).all().item(), f"{name}: {n} not finite"
        errs[n] = rel_err(g, r)
        assert errs[n][0] <= TOL, (
            f"{name}: kernel vs plain {n} relative error {errs[n][0]:.3g} "
            f"> {TOL}")
    assert bool((got[0][dead] == 0).all().item()), f"{name}: y past len"
    dx = got[2] if cell == "lstm" else got[1]
    assert bool((dx[dead] == 0).all().item()), f"{name}: dx past len"
    kernel = rnn.LSTM_KERNEL if cell == "lstm" else rnn.GRU_KERNEL
    plan = rnn.bwd_plan(kernel, b, h, x.device)
    fplan = rnn.fwd_plan(kernel, b, h, x.device)
    both = plan["route"] == "cluster"
    fboth = fplan["route"] == "cluster"
    first = 2 if cell == "lstm" else 1           # B6/B8's outputs in got
    # B5/B7 and B6/B8: bit-identical on a repeat on the cluster and grid
    # routes (the inference variant too)
    for kind, outs in (("fwd", got[:first]),
                       ("fwd_infer", (y_noc,) if cell == "lstm" else None),
                       ("bwd", got[first:])):
        if outs is None:
            continue
        again = kern[kind]()
        torch.cuda.synchronize()
        for n, g, a in zip(names if kind == "fwd_infer" else
                           names[:first] if kind == "fwd" else names[first:],
                           outs, again):
            assert bool(torch.equal(g, a)), (
                f"{name}: {kind} {n} differs on a repeat")
    second_err = {}
    if fboth:   # B5/B7 on the cluster route: the other route holds too
        by_second = fwd_second["fwd"]()
        seconds = [by_second]
        if cell == "lstm":
            seconds.append(fwd_second["fwd_infer"]())
        torch.cuda.synchronize()
        for n, sk, r in zip(names[:first], by_second, ref):
            second_err[n] = rel_err(sk, r)[0]
            assert second_err[n] <= TOL, (
                f"{name}: {second} route vs plain {n} relative error "
                f"{second_err[n]:.3g} > {TOL}")
        for sk in seconds:
            assert bool((sk[0][dead] == 0).all().item()), (
                f"{name}: {second} route y past len")
            assert bool(torch.equal(sk[0], by_second[0])), (
                f"{name}: the {second} route's variants differ")
    if both:                 # the other route holds too
        by_second = bwd_second()
        torch.cuda.synchronize()
        for n, sk, r in zip(names[first:], by_second, ref[first:]):
            second_err[n] = rel_err(sk, r)[0]
            assert second_err[n] <= TOL, (
                f"{name}: {second} route vs plain {n} relative error "
                f"{second_err[n]:.3g} > {TOL}")
        assert bool((by_second[0][dead] == 0).all().item()), (
            f"{name}: {second} route dx past len")

    slow = h >= 1280
    res = {"name": name, "cell": cell, "B": b, "T": t, "h": h,
           "live_steps": live, "fwd_plan": fplan, "bwd_plan": plan,
           "rel_err": {n: e[0] for n, e in errs.items()},
           "second_route": second, "second_rel_err": second_err}
    for k in kern:
        flops, nbytes = work[k]
        # the card's f32-accurate peak whichever route runs: three TF32
        # passes on the tensor cores (hi*hi + hi*lo + lo*hi), as the
        # cluster routes compute their products
        t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        res[k] = {
            "ms": time_ms(torch, kern[k], reps=5 if slow else 20),
            "plain_ms": time_ms(torch, plain[k], reps=3 if slow else 5,
                                warmup=1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
            "max_abs_err": max((e[1] for n, e in errs.items()
                                if which[n] == k[:3]), default=0.0),
        }
    if fboth:   # the same functions on the other route
        for k, fn in fwd_second.items():
            res[f"{k}_{second}_ms"] = time_ms(torch, fn)
    if both:
        res[f"bwd_{second}_ms"] = time_ms(torch, bwd_second)
    # cuDNN's LSTM/GRU over [B, T, h] (its input GEMM included): forward,
    # and forward+backward minus forward
    xin = torch.randn((b, t, h), generator=gen, device="cuda",
                      requires_grad=True)

    def cudnn_fwd():
        with torch.no_grad():
            cudnn(xin)

    def cudnn_fwd_bwd():
        out, _ = cudnn(xin)
        out.backward(dy)

    res["cudnn_fwd_ms"] = time_ms(torch, cudnn_fwd)
    res["cudnn_bwd_ms"] = time_ms(torch, cudnn_fwd_bwd) - res["cudnn_fwd_ms"]
    print("rnn kernel " + json.dumps(res), flush=True)
    return res


def rnn_kernels(torch, rnn):
    """Phase 10: every case of RNN_CASES. Returns the results by name."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    out = {case[0]: check_rnn(torch, rnn, case, gen) for case in RNN_CASES}
    print(f"rnn kernels equal their plain versions in {len(out)} cases",
          flush=True)
    return out


def text_feeds(seed, ragged):
    """The classifier's and the NMT's feeds, bench.py's (random ids, full
    lengths) or with ragged lengths (1 .. T, so that no row is empty)."""
    from paddle_tpu_torch.core.arg import id_arg

    rng = np.random.default_rng(seed)
    cl = (rng.integers(1, CLS_T + 1, CLS_B) if ragged
          else np.full(CLS_B, CLS_T)).astype(np.int32)
    nl = (rng.integers(1, NMT_T + 1, NMT_B) if ragged
          else np.full(NMT_B, NMT_T)).astype(np.int32)
    cls = {"words": id_arg(rng.integers(0, CLS["vocab_size"], (CLS_B, CLS_T))
                           .astype(np.int32), cl, device="cuda"),
           "label": id_arg(rng.integers(0, 2, CLS_B).astype(np.int32),
                           device="cuda")}
    nmt = {k: id_arg(rng.integers(2, NMT["src_vocab"], (NMT_B, NMT_T))
                     .astype(np.int32), nl, device="cuda")
           for k in ("src", "trg_in", "trg_out")}
    return cls, nmt


def set_rnn_arm(arm):
    """"kernels": the default policy (None: the kernels on the card);
    "scan": use_pallas_rnn = False."""
    from paddle_tpu_torch.core import flags

    flags.set_flag("use_pallas_rnn", None if arm == "kernels" else False)


def classifier_infer(torch, rnn):
    """Phase 11: the classifier through Inferencer at [64, 100] ids, the
    kernel arm (B5 without c) against the scan arm from the same weights:
    probabilities within 1e-5; two B5 launches a forward."""
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.trainer import Inferencer

    net = Network(stacked_lstm_classifier(**CLS))
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cuda")
    cls, _nmt = text_feeds(SEED + 60, ragged=True)
    feed = {"words": cls["words"]}
    out = {}
    for arm in ("kernels", "scan"):
        set_rnn_arm(arm)
        inf = Inferencer(net, params, outputs=["output"], device="cuda")
        inf.infer(feed)
        torch.cuda.synchronize()
        zero_rnn_counts(rnn)
        t0 = time.perf_counter()
        logits = inf.infer(feed)["output"]
        ms = (time.perf_counter() - t0) * 1e3
        out[arm] = (logits, ms, rnn_counts(rnn))
    set_rnn_arm("kernels")
    (lk, ms_k, counts), (ls, ms_s, counts_s) = out["kernels"], out["scan"]

    def probs(z):
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    diff = float(np.abs(probs(lk) - probs(ls)).max())
    r = {"shape": list(lk.shape), "finite": bool(np.isfinite(lk).all()),
         "prob_max_abs_diff": diff, "kernel_ms": ms_k, "scan_ms": ms_s,
         "kernel_sequences_per_s": CLS_B / (ms_k / 1e3),
         "b5_infer_launches": counts["lstm_fwd_infer_launches"],
         "launches": counts, "scan_launches": counts_s}
    print("classifier inference " + json.dumps(r), flush=True)
    assert r["shape"] == [CLS_B, 2] and r["finite"]
    assert diff <= 1e-5, f"kernel and scan probabilities differ by {diff:.3g}"
    assert counts["lstm_fwd_infer_launches"] == 2, counts
    assert counts["lstm_fwd_infer_cluster_launches"] == 2, counts
    assert sum(counts_s.values()) == 0, counts_s
    return r


def text_confs():
    from paddle_tpu_torch.models.text import seq2seq_attention, \
        stacked_lstm_classifier

    return stacked_lstm_classifier(**CLS), seq2seq_attention(**NMT)


def held_text_step(torch, conf, feed, lr, name, fixed_pool=False):
    """One adam TrainStep of the kernel arm against the scan arm from one
    weight map, and of the scan arm in f64 (the exact reference): the
    loss within TOL, and every gradient (from the new first moment,
    (1 - beta1) * grad) within TOL + 2 * noise of the scan arm's, noise
    being the scan arm's own f32 error against f64. Where a gradient is
    well conditioned the noise is ~1e-6 and the bound is TOL; where
    f32 rounding alone moves it (a sum that cancels to a small
    remainder: the attention's score path at init), the bound widens by
    what f32 arithmetic itself gives there. The kernel arm must also be
    as close to the f64 gradient as the scan arm, within TOL.

    `fixed_pool`: every max pool over time takes, in all three arms, the
    step the f64 arm's forward takes (a gather at its argmax; the same
    value away from ties). At init the wide classifier's LSTM outputs
    barely move over time, and a pool's top two steps can lie within
    f32 rounding of each other (5.5e-9 apart at h = 1280): an arm that
    breaks such a tie the other way routes that feature's whole gradient
    to another step, which moves every gradient below the pool by ~1e-2,
    a discontinuity and not a difference of the function. The count of
    decisions each f32 arm would have taken otherwise is reported; every
    max pool of the conf must have been recorded once and pinned once in
    each arm."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.layers.sequence import SequencePoolLayer
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.ops import sequence_ops as sops
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep

    net = Network(conf)
    params = net.init_params(torch.Generator().manual_seed(SEED + 1),
                             device="cuda")
    pool_ops = SequencePoolLayer._OPS
    real_max = pool_ops["max"]
    argmax, flips = [], {}
    # the conf's max pools (SequencePoolLayer.forward's choice of kind)
    max_pools = sum(
        isinstance(l, SequencePoolLayer) and l.conf.attrs.get(
            "pool_type", l.conf.type if l.conf.type in ("average", "max")
            else "sum") == "max"
        for l in net.layers.values())

    def masked(x, lens):
        keep = sops._mask(lens, x.shape[1], x.dtype) > 0
        return torch.where(keep[..., None], x, torch.full_like(x, -1e30))

    def record_max(x, lens):       # the f64 arm's steps, pool by pool
        argmax.append(masked(x, lens).argmax(1))
        return real_max(x, lens)

    def fixed_max(x, lens, arm):   # the recorded steps, in pool order
        i = len(flips[arm])
        assert i < len(argmax), f"{name}: max pool {i} was not recorded"
        idx = argmax[i]
        flips[arm].append(int((masked(x.detach(), lens).argmax(1)
                               != idx).sum().item()))
        return x.gather(1, idx[:, None, :]).squeeze(1)

    if fixed_pool:
        set_rnn_arm("scan")
        pool_ops["max"] = record_max
        try:
            with torch.no_grad():
                net.loss_fn({k: v.double() for k, v in params.items()},
                            feed)
        finally:
            pool_ops["max"] = real_max
        assert max_pools > 0 and len(argmax) == max_pools, (
            f"{name}: {len(argmax)} max pools recorded, the conf has "
            f"{max_pools}")
    got = {}
    for arm, dtype in (("kernels", torch.float32), ("scan", torch.float32),
                       ("f64", torch.float64)):
        set_rnn_arm("kernels" if arm == "kernels" else "scan")
        p = {k: v.to(dtype) for k, v in params.items()}
        opt = create_optimizer(OptimizationConf(learning_method="adam",
                                                learning_rate=lr),
                               net.param_confs)
        step = TrainStep(net, opt, watchdog=True, device="cuda")
        flips[arm] = []
        if fixed_pool:
            pool_ops["max"] = lambda x, lens, arm=arm: fixed_max(x, lens, arm)
        try:
            _p, st, _s, health, _o = step(p, opt.init_state(p), {}, feed, 0,
                                          None)
        finally:
            pool_ops["max"] = real_max
        assert not fixed_pool or len(flips[arm]) == max_pools, (
            f"{name}: {len(flips[arm])} max pools pinned in the {arm} arm, "
            f"the conf has {max_pools}")
        got[arm] = (health, st)
    set_rnn_arm("kernels")
    (hk, sk), (hs, ss), (_h64, s64) = (got["kernels"], got["scan"],
                                       got["f64"])
    loss_rel = abs(hk[0].item() - hs[0].item()) / abs(hs[0].item())
    per = {}
    for k in ss:
        ref = s64[k]["m"]
        per[k] = {"kernels_vs_scan": rel_err(sk[k]["m"], ss[k]["m"])[0],
                  "kernels_vs_f64": rel_err(sk[k]["m"].double(), ref)[0],
                  "scan_vs_f64": rel_err(ss[k]["m"].double(), ref)[0]}
    bad = {k: e for k, e in per.items()
           if e["kernels_vs_scan"] > TOL + 2 * e["scan_vs_f64"]
           or e["kernels_vs_f64"] > TOL + e["scan_vs_f64"]}
    noisy = {k: e for k, e in per.items() if e["scan_vs_f64"] > TOL / 10}
    r = {"loss_kernels": hk[0].item(), "loss_scan": hs[0].item(),
         "loss_rel": loss_rel, "finite": bool(hk[1].item() and hs[1].item()),
         "grads": len(per),
         "kernels_vs_scan_max": max(e["kernels_vs_scan"]
                                    for e in per.values()),
         "kernels_vs_scan_max_where_f32_noise_below_1e-5": max(
             (e["kernels_vs_scan"] for k, e in per.items()
              if k not in noisy), default=0.0),
         "kernels_vs_f64_max": max(e["kernels_vs_f64"] for e in per.values()),
         "scan_vs_f64_max": max(e["scan_vs_f64"] for e in per.values()),
         "f32_noisy_grads": noisy, "failing": bad,
         "pool_steps_fixed": fixed_pool,
         "pool_decisions_off_the_f64_arms": {a: f for a, f in flips.items()
                                             if a != "f64"}}
    print(f"kernel vs scan train step {name} " + json.dumps(r), flush=True)
    assert r["finite"] and loss_rel <= TOL, f"{name}: losses disagree: {r}"
    assert not bad, f"{name}: gradients disagree: {bad}"
    return r


# steps a training run's profile covers: the scan arms (the kernels'
# reference) launch 7 000-15 000 kernels a step, and the profiler's
# post-processing of 5 such steps took 20-44 s a run on an H100's host,
# most of phases 13-13d; one step gives their device ms and top kernels.
# The kernel arms' windows were cut from 5 steps to 2 when phase 26 made
# the whole smoke reach its result line at 1052.9 s on an H100: the
# NMT's 5-step profile took 15.2 s
PROFILE_STEPS = {"kernels": 2, "scan": 1}


def text_train(torch, rnn, conf, feed, lr, steps, tokens, name,
               prof_steps=5):
    """SGD.train (adam) on one fixed batch; returns the run's numbers
    (launch counts read just after the run, before a profile of
    `prof_steps` steps)."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    sgd = SGD(conf, OptimizationConf(learning_method="adam",
                                     learning_rate=lr),
              seed=SEED + 1, device="cuda")
    stamps, costs = [], []

    def on_event(e):
        if isinstance(e, EndIteration):
            costs.append(e.cost)          # fetched: the step is done
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_rnn_counts(rnn)
    t0 = time.perf_counter()
    sgd.train(reader=lambda: iter([feed] * steps), feeder=lambda b: b,
              num_passes=1, event_handler=on_event)
    torch.cuda.synchronize()
    counts = rnn_counts(rnn)
    steady = float(np.median(np.diff(stamps))) * 1e3
    r = {"steps": steps, "wall_s": time.perf_counter() - t0,
         "ms_first_step": (stamps[0] - t0) * 1e3,
         "ms_per_step_median": steady,
         "tokens_per_step": tokens,
         "tokens_per_s": tokens / (steady / 1e3),
         "loss_first": costs[0], "loss_last": costs[-1],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
         "launches": counts}
    print(f"train {name} " + json.dumps(r), flush=True)
    assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
    prof = profile_steps(torch, sgd, feed, prof_steps)
    if prof is not None:
        prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
    print(f"profile {name} " + json.dumps(prof), flush=True)
    r["profile"] = prof
    return r


def amp_text_step(torch, rnn, conf, feed, lr, name, want, model=None):
    """Phase 13b: one adam TrainStep of the kernel arm in f32 and under
    the bf16 flag from one weight map (B5-B8 cast the bf16 inputs up to
    f32 around the kernels, as the JAX wrappers do): the AMP loss finite
    and within 5% of the f32 step's (tests/test_amp.py's bound), the
    gradients f32 and each held against the f32 step's from adam's first
    moment (`amp_grads_held`, with `model`'s bound, else `name`'s), and
    the AMP step's launches `want` (counts read just after it)."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep

    net = Network(conf)
    params = net.init_params(torch.Generator().manual_seed(SEED + 1),
                             device="cuda")
    set_rnn_arm("kernels")
    got = {}
    for amp in (False, True):
        set_amp(amp)
        try:
            opt = create_optimizer(OptimizationConf(learning_method="adam",
                                                    learning_rate=lr),
                                   net.param_confs)
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            torch.cuda.synchronize()
            zero_rnn_counts(rnn)
            _p, st, _s, health, _o = step(params, opt.init_state(params), {},
                                          feed, 0, None)
            torch.cuda.synchronize()
            got[amp] = (health, st, rnn_counts(rnn))
        finally:
            set_amp(False)
    (h32, s32, _c32), (h16, s16, counts) = got[False], got[True]
    r = {"loss_f32": h32[0].item(), "loss_amp": h16[0].item(),
         "rel": abs(h16[0].item() - h32[0].item()) / abs(h32[0].item()),
         "finite": bool(h16[1].item()),
         "grad_dtypes": sorted({str(v["m"].dtype) for v in s16.values()}),
         "launches": counts}
    print(f"amp train step {name} " + json.dumps(r), flush=True)
    assert r["finite"] and r["rel"] <= 0.05, f"{name}: {r}"
    assert r["grad_dtypes"] == ["torch.float32"], r
    r["grad_rel_vs_f32_max"] = amp_grads_held(name, model or name, s16, s32,
                                              "m")
    expect = dict.fromkeys(RNN_COUNTERS, 0)
    expect.update(want)
    assert counts == expect, f"{name}: launches {counts}, want {expect}"
    return r


# phase 13c: the classifier at bench_lstm's wider widths (bench.py's
# lstm_bs*_h512 and lstm_bs*_h1280 rows), where B5 and B6 take the grid
# route
CLS_WIDE = (512, 1280)
CLS_WIDE_STEPS, CLS_WIDE_SCAN_STEPS = 10, 3


def wide_infer(torch, rnn, conf, name):
    """One Inferencer forward of `conf` at [64, 100] ragged ids, the kernel
    arm (B5's inference variant, twice on the grid route) against the scan
    arm from the same weights: probabilities within 1e-5."""
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.trainer import Inferencer

    net = Network(conf)
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cuda")
    cls, _nmt = text_feeds(SEED + 60, ragged=True)
    feed = {"words": cls["words"]}
    out = {}
    for arm in ("kernels", "scan"):
        set_rnn_arm(arm)
        inf = Inferencer(net, params, outputs=["output"], device="cuda")
        torch.cuda.synchronize()
        zero_rnn_counts(rnn)
        t0 = time.perf_counter()
        logits = inf.infer(feed)["output"]
        ms = (time.perf_counter() - t0) * 1e3
        out[arm] = (logits, ms, rnn_counts(rnn))
    set_rnn_arm("kernels")
    (lk, ms_k, counts), (ls, ms_s, counts_s) = out["kernels"], out["scan"]
    pk, ps = (np.exp(z - z.max(axis=1, keepdims=True)) for z in (lk, ls))
    diff = float(np.abs(pk / pk.sum(axis=1, keepdims=True)
                        - ps / ps.sum(axis=1, keepdims=True)).max())
    r = {"shape": list(lk.shape), "finite": bool(np.isfinite(lk).all()),
         "prob_max_abs_diff": diff, "kernel_ms": ms_k, "scan_ms": ms_s,
         "launches": counts}
    print(f"inference {name} " + json.dumps(r), flush=True)
    assert r["shape"] == [CLS_B, 2] and r["finite"], r
    assert diff <= 1e-5, f"{name}: probabilities differ by {diff:.3g}"
    want = dict.fromkeys(RNN_COUNTERS, 0)
    want.update(lstm_fwd_infer_launches=2, lstm_fwd_infer_grid_launches=2)
    assert counts == want, f"{name}: launches {counts}, want {want}"
    assert sum(counts_s.values()) == 0, counts_s
    return r


def wide_classifier(torch, rnn):
    """Phase 13c: bench_lstm's classifier (vocab 30000, emb 128, 2 LSTM
    layers, B=64, T=100, adam 2e-3), f32, at h = 512 and 1280, where B5
    and B6 take the grid route: the held adam step (`held_text_step`,
    its max pool at the f64 arm's steps) at ragged lengths;
    CLS_WIDE_STEPS kernel-arm and CLS_WIDE_SCAN_STEPS
    scan-arm steps through SGD at full lengths with profiles, the loss
    falling in both, the kernel arm launching 2 B5 + 2 B6 a step, every
    one on the grid route (counts read just after the run); then one
    inference forward (`wide_infer`). Returns the numbers by width."""
    from paddle_tpu_torch.models.text import stacked_lstm_classifier

    cls_r, _nmt = text_feeds(SEED + 90, ragged=True)
    cls_f, _nmt = text_feeds(SEED + 91, ragged=False)
    out = {}
    for h in CLS_WIDE:
        conf = stacked_lstm_classifier(**dict(CLS, hidden=h))
        name = f"classifier_h{h}"
        held = held_text_step(torch, conf, cls_r, CLS_LR, name,
                              fixed_pool=True)
        runs = {}
        for arm, steps in (("kernels", CLS_WIDE_STEPS),
                           ("scan", CLS_WIDE_SCAN_STEPS)):
            set_rnn_arm(arm)
            runs[arm] = text_train(torch, rnn, conf, cls_f, CLS_LR, steps,
                                   CLS_B * CLS_T,
                                   f"{name}_{arm}_b{CLS_B}_t{CLS_T}",
                                   PROFILE_STEPS[arm])
        set_rnn_arm("kernels")
        for arm, r in runs.items():
            assert r["loss_last"] < r["loss_first"], (
                f"{name} {arm}: loss rose from {r['loss_first']:.4g} to "
                f"{r['loss_last']:.4g}")
        want = dict.fromkeys(RNN_COUNTERS, 0)
        n = 2 * CLS_WIDE_STEPS
        want.update(lstm_fwd_launches=n, lstm_fwd_grid_launches=n,
                    lstm_bwd_launches=n, lstm_bwd_grid_launches=n)
        got = runs["kernels"]["launches"]
        assert got == want, f"{name} launches {got}, want {want}"
        assert sum(runs["scan"]["launches"].values()) == 0, runs["scan"]
        out[h] = {"held": held, "runs": runs,
                  "infer": wide_infer(torch, rnn, conf, name)}
    return out


# phase 13d: the attention NMT where the encoder's GRUs take the grid route
# (B7 above h = 352, B8 above h = 320): (name, conf kwargs, B, T). nmt_h1024
# is bench.py::bench_nmt's settings (:1029; vocab 30000, emb 512, adam
# 1e-3, B=256, T=32) at hidden 1024, a GRU of h = 512 a direction;
# nmt_rnnsearch RNNsearch's widths (Bahdanau, Cho and Bengio, ICLR 2015,
# 4.2 and appendix A: 1000 GRU units a direction, emb 620, vocab 30000,
# minibatch 80, sentences of at most 50 words), hidden 2000. Its decoder
# is `hidden` wide, not RNNsearch's 1000: the repo's model ties the
# decoder's width to the encoder's concat.
NMT_WIDE = (
    ("nmt_h1024", dict(NMT, hidden=1024), NMT_B, NMT_T),
    ("nmt_rnnsearch", dict(NMT, emb_dim=620, hidden=2000), 80, 50),
)
NMT_WIDE_STEPS, NMT_WIDE_SCAN_STEPS = 10, 3


def nmt_feed(seed, b, t, ragged):
    """The NMT's feed at (b, t): bench.py's random ids, at full lengths or
    ragged (1 .. t, so that no row is empty)."""
    from paddle_tpu_torch.core.arg import id_arg

    rng = np.random.default_rng(seed)
    lens = (rng.integers(1, t + 1, b) if ragged
            else np.full(b, t)).astype(np.int32)
    return {k: id_arg(rng.integers(2, NMT["src_vocab"], (b, t))
                      .astype(np.int32), lens, device="cuda")
            for k in ("src", "trg_in", "trg_out")}


def wide_nmt(torch, rnn):
    """Phase 13d: each NMT_WIDE configuration, f32: the held adam step
    (`held_text_step`) at ragged lengths; NMT_WIDE_STEPS kernel-arm and
    NMT_WIDE_SCAN_STEPS scan-arm steps through SGD at full lengths with
    profiles, every loss finite and the last below the first in both,
    the kernel arm launching 2 B7 + 2 B8 a step, every one on the grid
    route (counts read just after the run), none on the cluster route;
    one adam step under the bf16 flag, held against the f32 step as 13b
    holds the NMT (`amp_text_step`, the NMT's bound). Returns the
    numbers by name."""
    from paddle_tpu_torch.models.text import seq2seq_attention

    out = {}
    for i, (name, kw, b, t) in enumerate(NMT_WIDE):
        conf = seq2seq_attention(**kw)
        held = held_text_step(torch, conf, nmt_feed(SEED + 100 + i, b, t,
                                                     True), NMT_LR, name)
        feed = nmt_feed(SEED + 110 + i, b, t, False)
        runs = {}
        for arm, steps in (("kernels", NMT_WIDE_STEPS),
                           ("scan", NMT_WIDE_SCAN_STEPS)):
            set_rnn_arm(arm)
            runs[arm] = text_train(torch, rnn, conf, feed, NMT_LR, steps,
                                   b * t, f"{name}_{arm}_b{b}_t{t}",
                                   PROFILE_STEPS[arm])
        set_rnn_arm("kernels")
        for arm, r in runs.items():
            assert r["loss_last"] < r["loss_first"], (
                f"{name} {arm}: loss rose from {r['loss_first']:.4g} to "
                f"{r['loss_last']:.4g}")
        want = dict.fromkeys(RNN_COUNTERS, 0)
        n = 2 * NMT_WIDE_STEPS
        want.update(gru_fwd_launches=n, gru_fwd_grid_launches=n,
                    gru_bwd_launches=n, gru_bwd_grid_launches=n)
        got = runs["kernels"]["launches"]
        assert got == want, f"{name} launches {got}, want {want}"
        assert sum(runs["scan"]["launches"].values()) == 0, runs["scan"]
        amp = amp_text_step(torch, rnn, conf, feed, NMT_LR, name,
                            dict(gru_fwd_launches=2, gru_fwd_grid_launches=2,
                                 gru_bwd_launches=2,
                                 gru_bwd_grid_launches=2), model="nmt")
        out[name] = {"held": held, "runs": runs, "amp": amp}
    return out


def text_training(torch, rnn):
    """Phases 12, 13, 13c, 13d and 13b: the held steps at ragged lengths,
    then the training runs at the bench's full lengths, kernel arm then
    scan arm. Each kernel arm launches 2 B5 + 2 B6 (classifier) or 2 B7 +
    2 B8 (NMT) a step, every one on the cluster route (13c's classifier
    at h = 512 and 1280 and 13d's NMT at encoder widths 512 and 1000: on
    the grid route), and its loss falls."""
    cls_conf, nmt_conf = text_confs()
    cls_r, nmt_r = text_feeds(SEED + 70, ragged=True)
    held = (held_text_step(torch, cls_conf, cls_r, CLS_LR, "classifier"),
            held_text_step(torch, nmt_conf, nmt_r, NMT_LR, "nmt"))
    phase("13. train the classifier and the NMT through SGD")
    cls_f, nmt_f = text_feeds(SEED + 80, ragged=False)
    cls_tok = CLS_B * CLS_T
    nmt_tok = NMT_B * NMT_T                # target tokens, as bench_nmt
    runs = {}
    for arm in ("kernels", "scan"):
        set_rnn_arm(arm)
        n_cls = CLS_STEPS if arm == "kernels" else SCAN_STEPS
        n_nmt = NMT_STEPS if arm == "kernels" else SCAN_STEPS
        runs[f"classifier_{arm}"] = text_train(
            torch, rnn, cls_conf, cls_f, CLS_LR, n_cls, cls_tok,
            f"classifier_{arm}_b{CLS_B}_t{CLS_T}", PROFILE_STEPS[arm])
        runs[f"nmt_{arm}"] = text_train(
            torch, rnn, nmt_conf, nmt_f, NMT_LR, n_nmt, nmt_tok,
            f"nmt_{arm}_b{NMT_B}_t{NMT_T}", PROFILE_STEPS[arm])
    set_rnn_arm("kernels")
    for name, r in runs.items():
        assert r["loss_last"] < r["loss_first"], (
            f"{name}: loss rose from {r['loss_first']:.4g} to "
            f"{r['loss_last']:.4g}")
    c, n = runs["classifier_kernels"]["launches"], runs["nmt_kernels"][
        "launches"]
    want_c = dict.fromkeys(RNN_COUNTERS, 0)
    want_c.update(lstm_fwd_launches=2 * CLS_STEPS,
                  lstm_fwd_cluster_launches=2 * CLS_STEPS,
                  lstm_bwd_launches=2 * CLS_STEPS,
                  lstm_bwd_cluster_launches=2 * CLS_STEPS)
    want_n = dict.fromkeys(RNN_COUNTERS, 0)
    want_n.update(gru_fwd_launches=2 * NMT_STEPS,
                  gru_fwd_cluster_launches=2 * NMT_STEPS,
                  gru_bwd_launches=2 * NMT_STEPS,
                  gru_bwd_cluster_launches=2 * NMT_STEPS)
    assert c == want_c, f"classifier launches {c}, want {want_c}"
    assert n == want_n, f"nmt launches {n}, want {want_n}"
    for arm in ("classifier_scan", "nmt_scan"):
        assert sum(runs[arm]["launches"].values()) == 0, runs[arm]
    phase("13c. the classifier at bench_lstm's h = 512 and 1280 through "
          "SGD (the grid route)")
    wide = wide_classifier(torch, rnn)
    phase("13d. the NMT at encoder widths 512 and 1000 through SGD (the "
          "grid route)")
    wide_n = wide_nmt(torch, rnn)
    phase("13b. classifier and NMT adam steps under the bf16 flag")
    amp = (amp_text_step(torch, rnn, cls_conf, cls_f, CLS_LR, "classifier",
                         dict(lstm_fwd_launches=2,
                              lstm_fwd_cluster_launches=2,
                              lstm_bwd_launches=2,
                              lstm_bwd_cluster_launches=2)),
           amp_text_step(torch, rnn, nmt_conf, nmt_f, NMT_LR, "nmt",
                         dict(gru_fwd_launches=2, gru_fwd_cluster_launches=2,
                              gru_bwd_launches=2,
                              gru_bwd_cluster_launches=2)))
    return held, runs, amp, wide, wide_n


# ---- the sparse CTR slice: B9, SparseUpdater, the sharded tier, CTR ------

# bench.py::bench_sparse_ctr (:771) and bench_ctr_widedeep_sparse (:835)
SP_D = 64
SP_TOUCHED = 65536
SP_INNER = 20
SP_V = (1 << 20, 1 << 22)
SP_LR, SP_MU = 0.01, 0.9
WD_BS, WD_T, WD_H1, WD_H2 = 256, 64, 64, 32
WD_DENSE_LR = 0.05
WD_WARM, WD_WINDOWS, WD_INNER = 5, 5, 10
WD_DENSE = ("w1", "b1", "w2", "b2", "wo")
# the sharded tier (phase 17)
TIER = dict(rows_total=1 << 30, dim=64, capacity=1 << 18, num_slots=16384)
TIER_HOT, TIER_STEPS, TIER_SHARDED_STEPS = 1 << 20, 40, 5
# the CTR models (phase 18): models/ctr.py's defaults, adam 0.02 as
# tests/test_compat_ctr.py; a label is 1 when a feature id < CTR_CLICK,
# which makes about half of the 64-feature examples 1
CTR_B, CTR_F, CTR_STEPS, CTR_CLICK = 256, 64, 30, 1080
SPARSE_TOL = 1e-6
SPARSE_COUNTERS = ("sparse_row_update_launches",
                   "sparse_row_gather_launches",
                   "sparse_row_scatter_launches")


def zero_sparse_counts(sr):
    for name in SPARSE_COUNTERS:
        setattr(sr, name, 0)


def sparse_counts(sr):
    return {name: getattr(sr, name) for name in SPARSE_COUNTERS}


def momentum_upd(p, g, m):
    """bench.py's `upd` (:790-792) as a user's function: the generic
    route."""
    m2 = 0.9 * m + g
    return p - 0.01 * m2, m2


def sparse_rules(tss):
    return {"sgd": (tss.sgd_row_update(0.5), 0),
            "momentum": (tss.momentum_row_update(SP_LR, SP_MU), 1),
            "adagrad": (tss.adagrad_row_update(0.1), 1),
            "lambda_state": (momentum_upd, 1),
            "lambda": (lambda p, g: p * 0.99 - 0.25 * g, 0)}


# (name, rule, V, D, N, num_slots or None, id range or None for V,
#  number of distinct ids or None): the two bench shapes, every rule and
# route, overflow, heavy duplication, D of 4/16/128 and ids >= V
SPARSE_CASES = [
    ("bench_momentum_v1m_d64_n65536", "momentum", 1 << 20, 64, 65536, None,
     None, None),
    ("widedeep_momentum_v1m_d64_n16384", "momentum", 1 << 20, 64, 16384,
     None, None, None),
    ("bench_sgd_v1m_d64_n65536", "sgd", 1 << 20, 64, 65536, None, None,
     None),
    ("adagrad_v1m_d64_n16384", "adagrad", 1 << 20, 64, 16384, None, None,
     None),
    ("bench_lambda_state_v1m_d64_n65536", "lambda_state", 1 << 20, 64,
     65536, None, None, None),
    ("lambda_v100k_d16_n4096", "lambda", 100000, 16, 4096, None, None,
     None),
    ("overflow_momentum_v64k_d64_n8192_k1024", "momentum", 1 << 16, 64,
     8192, 1024, None, None),
    ("heavy_dup_momentum_v1m_d64_n16384_100ids", "momentum", 1 << 20, 64,
     16384, None, None, 100),
    ("sgd_v64k_d4_n8192", "sgd", 1 << 16, 4, 8192, None, None, None),
    ("adagrad_v64k_d16_n8192", "adagrad", 1 << 16, 16, 8192, None, None,
     None),
    ("momentum_v64k_d128_n8192", "momentum", 1 << 16, 128, 8192, None,
     None, None),
    ("ids_past_v_adagrad_v1000_d5_n4000", "adagrad", 1000, 5, 4000, None,
     1300, None),
]


def sparse_inputs(torch, gen, v, d, n, n_state, high, distinct):
    dev = torch.device("cuda")
    p = torch.randn((v, d), generator=gen, device=dev)
    # adagrad's accumulator is never negative
    s = [torch.rand((v, d), generator=gen, device=dev)
         for _ in range(n_state)]
    if distinct:
        pick = torch.randperm(v, generator=gen, device=dev)[:distinct]
        ids = pick[torch.randint(0, distinct, (n,), generator=gen,
                                 device=dev)]
    else:
        ids = torch.randint(0, high or v, (n,), generator=gen, device=dev)
    g = torch.randn((n, d), generator=gen, device=dev)
    return [p, *s], ids.to(torch.int32), g


def sparse_bytes(n, k, kv, d, n_tables):
    """Bytes a B9 step must move: the N gradient rows, the int32
    perm/uids/off once, each valid touched row of each table read and
    written once."""
    return n * d * 4 + (n + 2 * k + 1) * 4 + 2 * n_tables * kv * d * 4


def check_sparse(torch, sr, tss, case, gen):
    """Kernel route vs plain version on the card at one case: the touched
    rows within SPARSE_TOL of the largest, every other row bit-equal to
    the start, the kernel bit-identical over two runs."""
    name, rule_name, v, d, n, k, high, distinct = case
    fn, n_state = sparse_rules(tss)[rule_name]
    start, ids, g = sparse_inputs(torch, gen, v, d, n, n_state, high,
                                  distinct)
    return hold_sparse(torch, sr, name, rule_name, fn, start, ids, g,
                       k or n, v)


def hold_sparse(torch, sr, name, rule_name, fn, start, ids, g, k, v):
    """check_sparse's comparison on given tables, ids and gradients."""
    d, n = start[0].shape[1], ids.numel()
    runs = []
    for _ in range(2):
        tabs = [t.clone() for t in start]
        sr.sparse_rows(fn, tabs, ids, g, k, v)
        runs.append(tabs)
    plain = [t.clone() for t in start]
    sr.sparse_rows_plain(fn, plain, ids, g, k, v)
    torch.cuda.synchronize()
    uids, _perm, _off = sr.kernel_indices(ids, k)
    valid = uids[(uids >= 0) & (uids < v)].long()
    touched = torch.zeros(v, dtype=torch.bool, device="cuda")
    touched[valid] = True
    errs, diffs = [], []
    for got, again, ref, s in zip(runs[0], runs[1], plain, start):
        assert torch.equal(got, again), f"{name}: not bit-identical run to run"
        assert torch.equal(got[~touched], s[~touched]), (
            f"{name}: a row not touched changed")
        rel, diff = rel_err(got[touched], ref[touched])
        assert np.isfinite(rel) and rel <= SPARSE_TOL, (
            f"{name}: {rel:.3g} > {SPARSE_TOL}")
        errs.append(rel)
        diffs.append(diff)
    r = {"case": name, "rule": rule_name, "V": v, "D": d, "N": n, "k": k,
         "touched": int(valid.numel()), "rel_err": max(errs),
         "max_abs_err": max(diffs)}
    print("sparse " + json.dumps(r), flush=True)
    return r


def time_sparse(torch, sr, tss, case, gen):
    """Times at one shape: the B9 launch alone (kernel_indices done
    once), torch.sort alone, the whole preparation, the plain version,
    and — for SGD — `index_add_` (the one PyTorch call computing the
    same function); for the generic route the gather and scatter
    kernels. Warm, CUDA events, the same inputs every rep."""
    name, rule_name, v, d, n, k, high, distinct = case
    fn, n_state = sparse_rules(tss)[rule_name]
    tabs, ids, g = sparse_inputs(torch, gen, v, d, n, n_state, high,
                                 distinct)
    k = k or n
    uids, perm, off = sr.kernel_indices(ids, k)
    kv = int(((uids >= 0) & (uids < v)).sum())
    flat = ids.long()
    r = {"case": name, "V": v, "D": d, "N": n, "k": k, "touched": kv,
         "sort_ms": time_ms(torch, lambda: torch.sort(flat, stable=True)),
         "prep_ms": time_ms(torch, lambda: sr.kernel_indices(ids, k)),
         "plain_ms": time_ms(torch, lambda: sr.sparse_rows_plain(
             fn, tabs, ids, g, k, v), reps=5)}
    if isinstance(fn, sr.RowRule):
        r["ms"] = time_ms(torch, lambda: sr.update_kernel(
            fn, tabs, g, uids, perm, off, v))
        r["wrapper_ms"] = time_ms(torch, lambda: sr.sparse_rows(
            fn, tabs, ids, g, k, v))
        nbytes = sparse_bytes(n, k, kv, d, len(tabs))
        if rule_name == "sgd":
            r["library_ms"] = time_ms(torch, lambda: tabs[0].index_add_(
                0, flat, g, alpha=-fn.lr))
    else:
        gsum, rows = sr.gather_kernel(tabs, g, uids, perm, off, v)
        r["gather_ms"] = time_ms(torch, lambda: sr.gather_kernel(
            tabs, g, uids, perm, off, v))
        r["scatter_ms"] = time_ms(torch, lambda: sr.scatter_kernel(
            tabs, rows, uids, v))
        r["wrapper_ms"] = time_ms(torch, lambda: sr.sparse_rows(
            fn, tabs, ids, g, k, v))
        # gather: grads, indices, table rows read; gsum and rows written
        gb = (n * d * 4 + (n + 2 * k + 1) * 4
              + len(tabs) * (kv + k) * d * 4 + k * d * 4)
        # scatter: uids and rows read, table rows written
        sb = k * 4 + len(tabs) * (k + kv) * d * 4
        r["gather_bound_ms"] = gb / H100_BYTES_PER_S * 1e3
        r["scatter_bound_ms"] = sb / H100_BYTES_PER_S * 1e3
        nbytes = gb + sb
    r["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    print("sparse_time " + json.dumps(r), flush=True)
    return r


def check_negative_id(torch, sr, tss, gen):
    """A negative id past one slot a warp: k = N = 140 000 distinct ids
    (momentum, D = 64), one of them -7. It sorts into slot 0; above
    131 072 slots a warp walks more than one, and the id must not end
    that walk (a fault of the first B9, repaired since)."""
    v = n = 140_000
    fn, _n_state = sparse_rules(tss)["momentum"]
    start, _ids, g = sparse_inputs(torch, gen, v, SP_D, n, 1, None, None)
    ids = torch.randperm(v, generator=gen, device="cuda").to(torch.int32)
    ids[ids == 4321] = -7
    r = hold_sparse(torch, sr, "negative_id_momentum_v140k_d64_k140000",
                    "momentum", fn, start, ids, g, n, v)
    assert r["touched"] == v - 1, r
    return r


def sparse_kernels(torch, sr, tss):
    """Phase 14: every case held (and the negative id past one slot a
    warp), then the times at the bench shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140)
    checks = [check_sparse(torch, sr, tss, c, gen) for c in SPARSE_CASES]
    checks.append(check_negative_id(torch, sr, tss, gen))
    times = {c[0]: time_sparse(torch, sr, tss, c, gen)
             for c in SPARSE_CASES if c[0].startswith(("bench_",
                                                       "widedeep_"))}
    return checks, times


def sparse_standalone(torch, sr, tsp, tss):
    """Phase 15, as bench_sparse_ctr: momentum tables at V = 2^20 and
    2^22 x 64, 65 536 touched ids a step, 20 steps a `run_steps`; the
    first run counted and held against 20 plain steps from the same
    start; at 2^20 also the bench's own `upd` as a user function (the
    generic route). Then the step times, in turns 2^20, 2^22, 2^22,
    2^20 (2 warm + best of 5 runs each), with the host's enqueue time
    apart from the wait for the device."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    dev = torch.device("cuda")
    rule = tss.momentum_row_update(SP_LR, SP_MU)
    res, state, launches = {}, {}, dict.fromkeys(SPARSE_COUNTERS, 0)
    for v in SP_V:
        upd = tsp.SparseUpdater(rule)
        param = upd.place(torch.zeros((v, SP_D), device=dev))
        mom = upd.place(torch.zeros((v, SP_D), device=dev))
        ids_seq = torch.randint(0, v, (SP_INNER, SP_TOUCHED), generator=gen,
                                device=dev, dtype=torch.int32)
        grads_seq = torch.randn((SP_INNER, SP_TOUCHED, SP_D), generator=gen,
                                device=dev)
        start = (param.clone(), mom.clone())
        torch.cuda.synchronize()
        zero_sparse_counts(sr)
        t0 = time.perf_counter()
        param, (mom,) = upd.run_steps(param, ids_seq, grads_seq, (mom,))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / SP_INNER
        counts = sparse_counts(sr)
        assert counts["sparse_row_update_launches"] == SP_INNER, counts
        for key in SPARSE_COUNTERS:
            launches[key] += counts[key]
        ref = [t.clone() for t in start]
        for i in range(SP_INNER):
            sr.sparse_rows_plain(rule, ref, ids_seq[i], grads_seq[i],
                                 SP_TOUCHED, v)
        for got, want in zip((param, mom), ref):
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), (
                f"V={v}: 20 kernel steps differ from 20 plain steps by "
                f"{(got - want).abs().max().item():.3g}")
        held = max((got - want).abs().max().item()
                   for got, want in zip((param, mom), ref))
        del ref
        res[v] = {"V": v, "first_run_ms_per_step": first_ms,
                  "held_max_abs_diff": held, "launches": counts}
        if v == SP_V[0]:
            gp, gm = (t.clone() for t in start)
            generic = tsp.SparseUpdater(momentum_upd)
            zero_sparse_counts(sr)
            gp, (gm,) = generic.run_steps(gp, ids_seq, grads_seq, (gm,))
            torch.cuda.synchronize()
            gcounts = sparse_counts(sr)
            assert gcounts == {"sparse_row_update_launches": 0,
                               "sparse_row_gather_launches": SP_INNER,
                               "sparse_row_scatter_launches": SP_INNER}, (
                gcounts)
            for key in SPARSE_COUNTERS:
                launches[key] += gcounts[key]
            for got, want in zip((gp, gm), (param, mom)):
                assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), (
                    "generic route differs from the momentum rule")
            res[v].update(
                generic_bit_equal=bool(torch.equal(gp, param)
                                       and torch.equal(gm, mom)),
                generic_ms_per_step=best_run_ms(
                    torch, lambda: generic.run_steps(
                        gp, ids_seq, grads_seq, (gm,)))[0] / SP_INNER,
                generic_launches=gcounts)
            del gp, gm
        del start
        # the device's share: B9 alone on step 0's indices, and the
        # kernel time of one profiled run_steps
        uids, perm, off = sr.kernel_indices(ids_seq[0], SP_TOUCHED)
        views = [param.view(-1, SP_D), mom.view(-1, SP_D)]
        res[v]["kernel_ms"] = time_ms(torch, lambda: sr.update_kernel(
            rule, views, grads_seq[0], uids, perm, off, v))
        prof = profile_fn(torch, lambda: upd.run_steps(
            param, ids_seq, grads_seq, (mom,)), steps=1)
        res[v]["device_ms_per_step"] = (prof["device_ms_per_step"]
                                        / SP_INNER if prof else None)
        state[v] = (upd, param, mom, ids_seq, grads_seq)
    # the host's clock moves between moments on a shared host: time the
    # two tables in turns
    for v in (SP_V[0], SP_V[1], SP_V[1], SP_V[0]):
        upd, param, mom, ids_seq, grads_seq = state[v]
        total, enqueue = best_run_ms(torch, lambda: upd.run_steps(
            param, ids_seq, grads_seq, (mom,)))
        res[v].setdefault("turns_ms_per_step", []).append(total / SP_INNER)
        res[v].setdefault("turns_enqueue_ms_per_step", []).append(
            enqueue / SP_INNER)
    for v in SP_V:
        res[v]["ms_per_step"] = float(np.mean(res[v]["turns_ms_per_step"]))
        print("standalone " + json.dumps(res[v]), flush=True)
    del state
    torch.cuda.empty_cache()
    ratio = res[SP_V[1]]["ms_per_step"] / res[SP_V[0]]["ms_per_step"]
    print(f"standalone time(2^22)/time(2^20) = {ratio:.4f}", flush=True)
    return {"runs": res, "ratio": ratio, "launches": launches}


def best_run_ms(torch, fn, warm=2, reps=5):
    """(best host-clock ms of fn() followed by a synchronize, the ms
    that run took to return from fn(): the host's enqueue), after warm
    calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    best = (float("inf"), None)
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        best = min(best, ((time.perf_counter() - t0) * 1e3,
                          (t1 - t0) * 1e3))
    return best


def widedeep_step(torch, dense, table, ids, labels, apply_rows):
    """One wide&deep train step as bench_ctr_widedeep_sparse: rows
    gathered from the placed table, the dense tower (mean pool, 64 -> 64
    -> 32 -> 2, relu) forward and backward through autograd, SGD 0.05 on
    the dense weights, then the per-occurrence row gradients applied by
    `apply_rows(flat ids, grads [N, D])`. Returns the loss."""
    flat = ids.reshape(-1)
    rows = table.view(-1, SP_D).index_select(0, flat).view(
        WD_BS, WD_T, SP_D).requires_grad_(True)
    params = [dense[k].requires_grad_(True) for k in WD_DENSE]
    w1, b1, w2, b2, wo = params
    h = torch.relu(rows.mean(1) @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    logp = torch.log_softmax(h @ wo, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    grads = torch.autograd.grad(loss, [rows, *params])
    with torch.no_grad():
        for key, g in zip(WD_DENSE, grads[1:]):
            dense[key] = dense[key].detach() - WD_DENSE_LR * g
    apply_rows(flat, grads[0].reshape(-1, SP_D))
    return loss.detach()


def widedeep(torch, sr, tsp, tss):
    """Phase 16, as bench_ctr_widedeep_sparse at V = 2^20 and 2^22: a
    held step (kernel route vs plain route) at 2^20, then 5 warm steps
    and 5 windows of 10 timed steps (sync on the table at each window's
    end), counted, and a profile of 5 more steps."""
    dev = torch.device("cuda")
    rule = tss.momentum_row_update(SP_LR, SP_MU)
    n = WD_BS * WD_T
    res, launches, held = {}, 0, None
    for v in SP_V:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
        upd = tsp.SparseUpdater(rule)
        table = upd.place(torch.randn((v, SP_D), generator=gen, device=dev)
                          * 0.01)
        mom = upd.place(torch.zeros((v, SP_D), device=dev))
        dense = {
            "w1": torch.randn((SP_D, WD_H1), generator=gen, device=dev) * 0.05,
            "b1": torch.zeros(WD_H1, device=dev),
            "w2": torch.randn((WD_H1, WD_H2), generator=gen, device=dev)
            * 0.05,
            "b2": torch.zeros(WD_H2, device=dev),
            "wo": torch.randn((WD_H2, 2), generator=gen, device=dev) * 0.05,
        }
        ids = torch.randint(0, v, (WD_BS, WD_T), generator=gen, device=dev,
                            dtype=torch.int32)
        labels = torch.randint(0, 2, (WD_BS,), generator=gen, device=dev)

        def kernel_rows(flat, g, table=table, mom=mom, upd=upd):
            upd(table, flat, g, (mom,))

        if v == SP_V[0]:
            start = (table.clone(), mom.clone(), dict(dense))
            pt, pm, pd = start[0].clone(), start[1].clone(), dict(start[2])
            kt, km, kd = start[0].clone(), start[1].clone(), dict(start[2])
            lp = widedeep_step(torch, pd, pt, ids, labels, lambda f, g:
                               sr.sparse_rows_plain(rule, [pt, pm], f, g, n,
                                                    v))
            lk = widedeep_step(torch, kd, kt, ids, labels, lambda f, g:
                               upd(kt, f, g, (km,)))
            torch.cuda.synchronize()
            rel_loss = abs(lk.item() - lp.item()) / abs(lp.item())
            errs = [rel_err(a, b)[0] for a, b in ((kt, pt), (km, pm))]
            errs += [rel_err(kd[key], pd[key])[0] for key in WD_DENSE]
            held = {"loss": lk.item(), "loss_rel_err": rel_loss,
                    "table_rel_err": errs[0], "mom_rel_err": errs[1],
                    "dense_rel_err": max(errs[2:])}
            print("widedeep_held " + json.dumps(held), flush=True)
            assert rel_loss <= SPARSE_TOL and max(errs) <= SPARSE_TOL, held
            del start, pt, pm, pd, kt, km, kd
        torch.cuda.synchronize()
        zero_sparse_counts(sr)
        losses = [widedeep_step(torch, dense, table, ids, labels, kernel_rows)
                  for _ in range(WD_WARM)]
        best = float("inf")
        for _ in range(WD_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(WD_INNER):
                losses.append(widedeep_step(torch, dense, table, ids, labels,
                                            kernel_rows))
            table[0].sum().item()      # the window ends when the table does
            best = min(best, (time.perf_counter() - t0) * 1e3 / WD_INNER)
        counts = sparse_counts(sr)
        want = WD_WARM + WD_WINDOWS * WD_INNER
        assert counts["sparse_row_update_launches"] == want, counts
        launches += want
        losses = torch.stack(losses).cpu().numpy()
        assert np.isfinite(losses).all(), "a wide&deep loss is not finite"
        prof = profile_fn(torch, lambda: widedeep_step(
            torch, dense, table, ids, labels, kernel_rows))
        if prof is not None:
            prof["idle_share"] = 1 - prof["device_ms_per_step"] / best
        res[v] = {"V": v, "ms_per_step": best,
                  "examples_per_s": WD_BS / (best / 1e3),
                  "loss_first": float(losses[0]),
                  "loss_last": float(losses[-1]), "launches": counts,
                  "profile": prof}
        print("widedeep " + json.dumps(res[v]), flush=True)
        del table, mom, upd
        torch.cuda.empty_cache()
    ratio = res[SP_V[1]]["ms_per_step"] / res[SP_V[0]]["ms_per_step"]
    print(f"widedeep time(2^22)/time(2^20) = {ratio:.4f}", flush=True)
    return {"runs": res, "ratio": ratio, "held": held, "launches": launches}


def tier_steps(seed, steps):
    """`steps` batches of 256 x 64 ids from a fixed hot set of ~2^20 ids
    of the 2^30-row table, with their gradients (numpy seed)."""
    rng = np.random.default_rng(seed)
    hot = np.unique(rng.integers(0, TIER["rows_total"], TIER_HOT))
    return [(hot[rng.integers(0, len(hot), (WD_BS, WD_T))],
             rng.standard_normal((WD_BS * WD_T, TIER["dim"]))
             .astype(np.float32)) for _ in range(steps)]


def drive_tier(torch, table, batches, timed):
    """lookup + update per batch; with `timed`, the host clock of each
    step (synchronized) and of its residency work (`ensure_resident`:
    the host maps and the spill copies)."""
    host = [0.0]
    resident = table.ensure_resident

    def timed_resident(uids):
        t0 = time.perf_counter()
        resident(uids)
        host[0] += time.perf_counter() - t0

    if timed:
        table.ensure_resident = timed_resident
    steps_ms = []
    try:
        for ids, grads in batches:
            t0 = time.perf_counter()
            table.lookup(ids)
            table.update(ids, grads)
            if timed:
                torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        table.ensure_resident = resident
    return steps_ms, host[0] * 1e3


def payloads_close(got, want, what):
    """Export payloads: ids, slots and spill ids equal, every row and
    slot within 1e-5 of the largest entry. Returns the largest error."""
    worst = 0.0
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b), what
        for key in ("ids", "slots", "spill_ids"):
            assert np.array_equal(a[key], b[key]), f"{what}: {key} differ"
        for key in a:
            if key not in ("ids", "slots", "spill_ids") and len(b[key]):
                scale = max(float(np.abs(b[key]).max()), 1e-30)
                err = float(np.abs(a[key] - b[key]).max()) / scale
                assert err <= 1e-5, f"{what}: {key} {err:.3g}"
                worst = max(worst, err)
    return worst


def sharded_tier(torch, sr, tss):
    """Phase 17: the 2^30-row tier on the card, one shard, adagrad — 40
    steps timed and counted, held against the same steps of a CPU table
    through the export payloads; then 5 steps with 8 shards and hash
    placement, held the same way."""
    rule = tss.adagrad_row_update(0.1)
    out = {}
    for name, shards, placement, steps in (
            ("one_shard_range", 1, "range", TIER_STEPS),
            ("eight_shards_hash", 8, "hash", TIER_SHARDED_STEPS)):
        cfg = tss.ShardedTableConfig(placement=placement, **TIER)
        batches = tier_steps(SEED + 170, steps)
        card = tss.ShardedEmbeddingTable(cfg, num_shards=shards,
                                         update_fn=rule, num_state=1,
                                         device="cuda")
        torch.cuda.synchronize()
        zero_sparse_counts(sr)
        t0 = time.perf_counter()
        steps_ms, host_ms = drive_tier(torch, card, batches[:-3], True)
        prof = profile_fn(torch, lambda it=iter(batches[-3:]): drive_tier(
            torch, card, [next(it)], False), steps=2)
        wall = time.perf_counter() - t0
        counts = sparse_counts(sr)
        assert counts["sparse_row_update_launches"] == steps, counts
        cpu = tss.ShardedEmbeddingTable(cfg, num_shards=shards,
                                        update_fn=rule, num_state=1,
                                        device="cpu")
        drive_tier(torch, cpu, batches, False)
        assert card.stats == cpu.stats, (card.stats, cpu.stats)
        err = payloads_close(card.export_shards(), cpu.export_shards(), name)
        n = len(steps_ms)
        r = {"shards": shards, "placement": placement, "steps": steps,
             "wall_s": wall, "ms_per_step_median":
             float(np.median(steps_ms[1:])) if n > 1 else steps_ms[0],
             "residency_host_ms_per_step": host_ms / n,
             "stats": card.stats, "rows_materialized":
             card.rows_materialized, "cache_rows": card._S,
             "export_max_rel_err": err, "launches": counts,
             "profile": prof}
        if prof is not None:
            r["device_ms_per_step"] = prof["device_ms_per_step"]
        print("tier " + json.dumps(r), flush=True)
        if shards == 1:
            assert card.stats["evictions"] > 0, "the cache never evicted"
        out[name] = r
        del card, cpu
        torch.cuda.empty_cache()
    return out


def ctr_models(torch):
    """Phase 18: ctr_wide_deep at models/ctr.py's defaults through SGD
    (adam 0.02) on one fixed batch for 30 steps — the loss falls below
    half its first value — and one step of ctr_linear with adagrad."""
    from paddle_tpu_torch.core.arg import id_arg
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    rng = np.random.default_rng(SEED + 180)
    feats = rng.integers(0, 100000, (CTR_B, CTR_F)).astype(np.int32)
    label = (feats < CTR_CLICK).any(axis=1).astype(np.int32)
    feed = {"features": id_arg(feats, np.full(CTR_B, CTR_F, np.int32),
                               device="cuda"),
            "label": id_arg(label, device="cuda")}
    out = {"label_mean": float(label.mean())}
    for name, conf, method, lr, steps in (
            ("wide_deep_adam", ctr.ctr_wide_deep(), "adam", 0.02,
             CTR_STEPS),
            ("linear_adagrad", ctr.ctr_linear(), "adagrad", 0.1, 1)):
        sgd = SGD(conf, OptimizationConf(learning_method=method,
                                         learning_rate=lr),
                  seed=SEED + 181, device="cuda")
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.train(reader=lambda: iter([feed] * steps), feeder=lambda b: b,
                  num_passes=1, event_handler=on_event)
        assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
        ms = (float(np.median(np.diff(stamps))) * 1e3 if steps > 1
              else (stamps[0] - t0) * 1e3)
        out[name] = {"steps": steps, "loss_first": costs[0],
                     "loss_last": costs[-1], "ms_per_step": ms,
                     "examples_per_s": CTR_B / (ms / 1e3)}
        print(f"ctr {name} " + json.dumps(out[name]), flush=True)
    wd = out["wide_deep_adam"]
    assert wd["loss_last"] < 0.5 * wd["loss_first"], (
        f"wide&deep loss fell only from {wd['loss_first']:.4g} to "
        f"{wd['loss_last']:.4g}")
    return out


# ---- multi-step dispatch: K train steps as one CUDA graph ----------------

# phase 18b: the classifier at bench_lstm's settings through SGD.train fed
# by the port's readers and DataFeeder, bench.py::bench_lstm's inner=10 as
# steps_per_dispatch; 25 full batches and a short one a pass
MS_K = 10
MS_SAMPLES = CLS_B * 25 + 17
MS_BUCKETS = (32, 64, 100)
# phase 18c: both chunks at later global steps, the LR on a poly schedule
MS_STEP0 = 1000
MS_POLY = dict(learning_rate_schedule="poly", learning_rate_decay_a=1e-3,
               learning_rate_decay_b=0.5)
# kernels that serve a route's walk (its hoisted products and dW, its
# bias gradient): present wherever the walk is
MS_HELPERS = ("tc_kernel", "'s db")


def cls_data():
    """Phase 18b's and 19a's data: (train reader, test reader, feeder).
    The reader is `batched(shuffle(samples, 1000, seed), 64,
    drop_last=False)` over MS_SAMPLES samples of lengths 10-100 from a
    seed, the test reader LC_TEST_SAMPLES others from another seed, the
    feeder `DataFeeder` with buckets MS_BUCKETS."""
    from paddle_tpu_torch.data import feeder as dfeeder
    from paddle_tpu_torch.data import reader as dreader

    vocab = CLS["vocab_size"]

    def samples(seed, n):
        rng = np.random.default_rng(seed)
        return [(rng.integers(0, vocab, t).tolist(),
                 int(rng.integers(0, 2))) for t in rng.integers(10, 101, n)]

    train, test = samples(SEED + 200, MS_SAMPLES), samples(SEED + 201,
                                                           LC_TEST_SAMPLES)
    reader = dreader.batched(
        dreader.shuffle(lambda: iter(train), 1000, seed=SEED), CLS_B,
        drop_last=False)
    test_reader = dreader.batched(lambda: iter(test), CLS_B,
                                  drop_last=False)
    feeder = dfeeder.DataFeeder(
        {"words": 0, "label": 1},
        {"words": dfeeder.integer_value_sequence(vocab),
         "label": dfeeder.integer_value(2)}, buckets=MS_BUCKETS)
    return reader, test_reader, feeder


def counted_profile(torch, fn):
    """fn() under torch.profiler. The profiler can miss a few kernels in
    a long window (in the whole smoke it recorded 50 of a pass's 52 B5
    launches, the wrappers' counts 52), so its counts show which
    kernels ran, not exactly how often."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def kernel_calls(torch, fn):
    """One call of fn() (a replay of a captured graph) under
    torch.profiler: the device ms, each port kernel's launches
    (PORT_KERNELS' labels) and the memsets the call ran on the card."""
    return device_calls(torch, counted_profile(torch, fn), 1)


def ran_only(calls, want, name):
    """The profile's port kernels (`calls`, PORT_KERNELS' labels; the
    walks' helper kernels aside) are exactly those of `want`, each
    launched; the counts are printed beside `want`'s."""
    got = {k for k in calls if not any(x in k for x in MS_HELPERS)}
    assert got == set(want) and all(calls[k] for k in want), (
        f"{name}: the profile shows {calls}, want {want}")


def device_calls(torch, prof, steps):
    """A profile's device ms a step, each port kernel's launches and the
    memsets (all over `steps`)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == cuda and e.self_device_time_total > 0]
    calls = {label: sum(e.count for e in events if piece in e.key)
             for label, piece in PORT_KERNELS.items()}
    return {"device_ms_per_step": sum(e.self_device_time_total
                                      for e in events) / steps / 1e3,
            "calls": {k: v for k, v in calls.items() if v},
            "memsets": sum(e.count for e in events
                           if "memset" in e.key.lower())}


def leaves(tree, prefix=""):
    """{path: tensor} of nested dicts of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def held_graph_vs_eager(torch, name, e1, e2, g):
    """The graph arm's leaves against the eager arms' ({path: tensor}
    each): bit-equal (NaN where NaN) wherever the two eager runs agree bit
    for bit, elsewhere no farther than twice the eager runs' own distance.
    Returns the leaves where the eager runs differ, with both
    distances."""
    def same(a, b):
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))

    def dist(a, b):
        return float((a.nan_to_num(0.0) - b.nan_to_num(0.0)).abs().max())

    nondet = {}
    for k, a in e1.items():
        b, c = e2[k], g[k]
        if same(a, b):
            assert same(c, a), (
                f"{name}: {k} differs from two eager runs that agree bit "
                f"for bit (by {dist(c, a):.3g})")
            continue
        own, far = dist(a, b), dist(c, a)
        nondet[k] = {"eager_vs_eager": own, "graph_vs_eager": far}
        assert torch.equal(c.isnan(), a.isnan()) and far <= 2 * own, (
            f"{name}: {k} is {far:.3g} from the eager run, more than twice "
            f"the eager runs' own {own:.3g}")
    return nondet


def classifier_multistep(torch):
    """Phase 18b: the classifier (bench_lstm: vocab 30000, emb 128, two
    LSTMs at h = 256, B=64, adam 2e-3) through `SGD.train`, the reader
    `batched(shuffle(samples, 1000, seed), 64, drop_last=False)` over
    MS_SAMPLES samples of lengths 10-100 and `DataFeeder(...,
    buckets=MS_BUCKETS)`; two passes at steps_per_dispatch = 1 (twice)
    and 10 from one start. The K = 10 arm captures two graphs (chunks of
    10 and of 5; the short last batch runs eagerly), and its costs, final
    params and slots are held against the K = 1 arms
    (`held_graph_vs_eager`). The wrappers' launch counts over the two
    passes are exact (the K = 10 arm's: its eager steps, warm-ups and
    captures). ms a step of the second pass, then a third pass profiled:
    device ms a step, idle share, and the port kernels it ran: B5 and
    B6 on the cluster route and no other. Returns the arms' numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.events import BeginPass, EndIteration, \
        EndPass
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.trainer.watchdog import WatchdogConfig

    reader, _test_reader, feeder = cls_data()
    from paddle_tpu_torch.ops import rnn

    steps = -(-MS_SAMPLES // CLS_B)
    conf = stacked_lstm_classifier(**CLS)
    p0 = Network(conf).init_params(torch.Generator().manual_seed(SEED),
                                   device="cuda")
    arms = {}
    # the ladder's spike rung armed past the run: this data's loss spikes
    # at pass 1 batch 19, and the LR backoff then starts a batch later at
    # K = 1 and a chunk later at K = 10 (the JAX trainer's rule), so the
    # arms would part there (phase 19b drives the ladder)
    no_spikes = WatchdogConfig(warmup_batches=2 * steps + 1)
    for arm, spd in (("k1", 1), ("k1_again", 1), ("k10", MS_K)):
        sgd = SGD(conf, OptimizationConf(learning_method="adam",
                                         learning_rate=CLS_LR),
                  seed=SEED + 1, device="cuda", steps_per_dispatch=spd,
                  params={k: v.clone() for k, v in p0.items()},
                  watchdog=no_spikes)
        costs, stamps = [], {}

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)
            elif isinstance(e, (BeginPass, EndPass)):
                stamps[(type(e).__name__, e.pass_id)] = time.perf_counter()

        zero_rnn_counts(rnn)
        sgd.train(reader=reader, feeder=feeder, num_passes=2,
                  event_handler=on_event)
        torch.cuda.synchronize()
        # the wrappers count eager launches, the warm-up step and the
        # captures, not the replays (the profile below counts those)
        counts = {k: v for k, v in rnn_counts(rnn).items() if v}

        def ms(p):
            return (stamps[("EndPass", p)] - stamps[("BeginPass", p)]) \
                / steps * 1e3

        r = {"steps_per_dispatch": spd, "steps": len(costs),
             "ms_per_step_pass1": ms(0), "ms_per_step": ms(1),
             "graphs_captured": sgd.graphs_captured,
             "loss_first": costs[0], "loss_last": costs[-1],
             "launch_counts": counts}
        # copies: the K = 10 arm's tensors are the graphs' own, and the
        # profiled pass below moves them on
        held = {"costs": torch.tensor(costs, dtype=torch.float64),
                **{k: v.clone() for k, v in {
                    **leaves(sgd.params, "param/"),
                    **leaves(sgd.opt_state, "slot/")}.items()}}
        prof = counted_profile(torch, lambda: sgd.train(
            reader=reader, feeder=feeder, num_passes=1))
        r.update(device_calls(torch, prof, steps))
        r["idle_share"] = 1 - r["device_ms_per_step"] / r["ms_per_step"]
        # the wrappers' launches over both passes: every step eagerly at
        # K = 1; at K = 10 the short batch of each pass eagerly, one
        # warm-up step a graph and the 10 + 5 captured steps
        n = 2 * steps if spd == 1 else 2 + 2 + MS_K + 5
        want = {"B5 lstm_seq_fwd cluster walk": 2 * steps,
                "B6 lstm_seq_bwd cluster walk": 2 * steps}
        r["calls_want"] = want
        print(f"multistep classifier {arm} " + json.dumps(r), flush=True)
        assert np.isfinite(costs).all() and len(costs) == 2 * steps, r
        assert r["loss_last"] < r["loss_first"], r
        assert counts == dict.fromkeys(
            ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
             "lstm_bwd_launches", "lstm_bwd_cluster_launches"), 2 * n), (
            f"{arm}: the wrappers launched {counts}, want {2 * n} each")
        ran_only(r["calls"], want, f"classifier {arm}")
        arms[arm] = (r, held)
        del sgd
    # chunks of 10, 10 and 5, and the short batch alone: two graphs
    assert arms["k10"][0]["graphs_captured"] == 2, arms["k10"][0]
    nondet = held_graph_vs_eager(torch, "classifier k10", arms["k1"][1],
                                 arms["k1_again"][1], arms["k10"][1])
    print("multistep classifier held " + json.dumps(
        {"leaves": len(arms["k1"][1]), "eager_runs_differ": nondet}),
        flush=True)
    torch.cuda.empty_cache()
    return {arm: r for arm, (r, _h) in arms.items()}


def ms_models(torch):
    """Phase 18c's models: (name, conf, optimizer kwargs, params, state,
    2 * MS_K feeds on the card, the bf16 flag, the port kernels a replay
    must launch a step, the indices of feeds with a NaN image)."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.models import ctr, lm
    from paddle_tpu_torch.models.image import resnet
    from paddle_tpu_torch.models.text import seq2seq_attention, \
        stacked_lstm_classifier
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.weights import params_from_numpy

    n = 2 * MS_K
    rng = np.random.default_rng(SEED + 210)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 210)

    def init(conf):
        net = Network(conf)
        return (net.init_params(torch.Generator().manual_seed(SEED), "cuda"),
                net.init_state("cuda"))

    def cls_feed():
        lens = rng.integers(1, CLS_T + 1, CLS_B).astype(np.int32)
        return {"words": id_arg(rng.integers(0, CLS["vocab_size"],
                                             (CLS_B, CLS_T)), lens,
                                device="cuda"),
                "label": id_arg(rng.integers(0, 2, CLS_B), device="cuda")}

    out = []
    conf = stacked_lstm_classifier(**dict(CLS, hidden=512))
    out.append(("classifier_h512", conf,
                dict(learning_method="adam", learning_rate=CLS_LR),
                *init(conf), [cls_feed() for _ in range(n)], False,
                {"B5 lstm_seq_fwd grid route": 2,
                 "B6 lstm_seq_bwd grid route": 2}, ()))
    for name, kw, want in (
            ("nmt", NMT, {"B7 gru_seq_fwd cluster walk": 2,
                          "B8 gru_seq_bwd cluster walk": 2}),
            ("nmt_h1024", dict(NMT, hidden=1024),
             {"B7 gru_seq_fwd grid route": 2,
              "B8 gru_seq_bwd grid route": 2})):
        conf = seq2seq_attention(**kw)
        out.append((name, conf, dict(learning_method="adam",
                                     learning_rate=NMT_LR),
                    *init(conf), [nmt_feed(SEED + 220 + i, NMT_B, NMT_T, True)
                                  for i in range(n)], False, want, ()))
    full = np.full((32,), 128, np.int32)
    for name, impl, amp, want in (
            ("lm_a_f32_flash", "flash", False,
             {"B4f flash_attn_fwd": 2, "B4b flash_attn_bwd_dkv": 2,
              "B4b flash_attn_bwd_dq": 2}),
            ("lm_bench_lm_train_amp", "dense", True, {})):
        spec = lm.LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                         attn_impl=impl)
        out.append((name, lm.transformer_lm(spec),
                    dict(learning_method="momentum", learning_rate=0.001,
                         momentum=0.9),
                    params_from_numpy(random_params(spec, lm), "cuda"), {},
                    [lm_feed(b) for b in lm_batches(rng, n, 32, 128, full,
                                                    spec.vocab)],
                    amp, want, ()))
    lens = np.full((4,), 4096, np.int32)
    out.append(("longctx_flash_amp_b4_t4096",
                longctx_conf(**LONGCTX, attn_impl="flash"),
                dict(learning_method="adam", learning_rate=LONGCTX_LR),
                params_from_numpy(longctx_params(torch), "cuda"), {},
                [{"ids": id_arg(rng.integers(0, LONGCTX["vocab"], (4, 4096)),
                                lens, device="cuda"),
                  "label": id_arg(rng.integers(0, LONGCTX["classes"],
                                               (4, 4096)), lens,
                                  device="cuda")} for _ in range(n)],
                True, {"B4f flash_attn_fwd_bf16": 2,
                       "B4b flash_attn_bwd_dkv_bf16": 2,
                       "B4b flash_attn_bwd_dq_bf16": 2}, ()))
    # ResNet-50 fused at bench_resnet50's B=256 under the flag: two image
    # batches in turn, one NaN image in the 5th batch of each chunk
    conf = resnet(50, (224, 224, 3), 1000, fused=True)
    images = [torch.randn((RESNET_AMP_BATCH, 224, 224, 3), generator=gen,
                          device="cuda") for _ in range(2)]
    poisoned = images[0].clone()
    poisoned[3, 100, 100, 1] = float("nan")
    nan_at = (4, MS_K + 4)
    out.append(("resnet50_fused_amp_b256", conf, dict(RESNET_OPT),
                *init(conf),
                [{"image": non_seq(poisoned if i in nan_at
                                   else images[i % 2]),
                  "label": id_arg(rng.integers(0, 1000, RESNET_AMP_BATCH),
                                  device="cuda")} for i in range(n)],
                True, {"B1 bn_act_conv1x1_fwd_bf16_wgmma": 29,
                       "B2 bn_act_conv1x1_bwd_dx_bf16_wgmma": 29,
                       "B3 bn_act_conv1x1_bwd_dw_bf16_wgmma": 29}, nan_at))
    conf = ctr.ctr_wide_deep()
    feats = [rng.integers(0, 100000, (CTR_B, CTR_F)) for _ in range(n)]
    out.append(("ctr_wide_deep", conf,
                dict(learning_method="adam", learning_rate=0.02),
                *init(conf),
                [{"features": id_arg(f, np.full(CTR_B, CTR_F, np.int32),
                                     device="cuda"),
                  "label": id_arg((f < CTR_CLICK).any(axis=1),
                                  device="cuda")} for f in feats],
                False, {}, ()))
    return out


def graph_vs_eager(torch, name, conf, opt_kw, params, state, feeds, amp,
                   want, nan_at):
    """Phase 18c for one model: two chunks of MS_K steps under a poly
    schedule, the first at global step MS_STEP0, the second at MS_STEP0
    + MS_K with lr_scale 0.5, with the watchdog: eagerly (TrainStep
    calls), eagerly again, and as two replays of one graph
    (`TrainStep.multi`), each from the same params. Holds the graph
    arm's params, slots, layer state and health rows
    (`held_graph_vs_eager`) and the skip of the NaN batches in every arm;
    then profiles a third replay: it runs the port kernels of `want`
    (their launches a step printed beside `want`'s), and no kernel of
    another route or form. Returns the numbers."""
    from paddle_tpu_torch.core import rng as trng
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep, stack_feeds

    t_model = time.perf_counter()
    set_amp(amp)
    try:
        net = Network(conf)
        opt = create_optimizer(OptimizationConf(**opt_kw, **MS_POLY),
                               net.param_confs)
        root = trng.generator(SEED + 230, "cuda")
        arms = {}
        for arm in ("eager", "eager_again", "graph"):
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            p = {k: v.clone() for k, v in params.items()}
            o = opt.init_state(p)
            s = {k: {slot: t.clone() for slot, t in v.items()}
                 for k, v in state.items()}
            healths, ms = [], []
            for c in range(2):
                step0, scale = MS_STEP0 + c * MS_K, (1.0, 0.5)[c]
                chunk = feeds[c * MS_K:(c + 1) * MS_K]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if arm == "graph":
                    p, o, s, h, _ = step.multi(p, o, s, stack_feeds(chunk),
                                               step0, root, lr_scale=scale)
                else:
                    hs = []
                    for k, f in enumerate(chunk):
                        p, o, s, h1, _ = step(
                            p, o, s, f, step0 + k,
                            trng.split_for_step(root, step0 + k),
                            lr_scale=scale)
                        hs.append(h1)
                    h = torch.stack(hs)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) / MS_K * 1e3)
                healths.append(h)
            arms[arm] = {"step": step, "ms": ms, "p": p, "o": o, "s": s,
                         "held": {"health": torch.cat(healths),
                                  **leaves(p, "param/"),
                                  **leaves(o, "slot/"),
                                  **leaves(s, "state/")}}
        want_finite = [float(i not in nan_at) for i in range(2 * MS_K)]
        for arm, a in arms.items():
            got = a["held"]["health"][:, 1].tolist()
            assert got == want_finite, f"{name} {arm}: finite {got}"
        g = arms["graph"]
        nondet = held_graph_vs_eager(torch, name, arms["eager"]["held"],
                                     arms["eager_again"]["held"], g["held"])
        stacked = stack_feeds(feeds[:MS_K])
        replay = kernel_calls(torch, lambda: g["step"].multi(
            g["p"], g["o"], g["s"], stacked, MS_STEP0 + 2 * MS_K, root,
            lr_scale=0.5))
        for k in replay["calls"]:
            replay["calls"][k] /= MS_K
        r = {"eager_ms_per_step": arms["eager"]["ms"],
             "eager_again_ms_per_step": arms["eager_again"]["ms"],
             "graph_ms_per_step": g["ms"],
             "graph_device_ms_per_step": replay["device_ms_per_step"] / MS_K,
             "graph_idle_share": 1 - replay["device_ms_per_step"] / MS_K
             / g["ms"][1],
             "graphs_captured": g["step"].graphs_captured,
             "leaves_held": len(g["held"]),
             "eager_runs_differ": nondet,
             "nan_batches_skipped": [i for i, f in enumerate(want_finite)
                                     if not f],
             "replay_calls_per_step": replay["calls"],
             "replay_calls_per_step_want": want,
             "replay_memsets_per_step": replay["memsets"] / MS_K,
             "seconds": time.perf_counter() - t_model}
        print(f"multistep graph {name} " + json.dumps(r), flush=True)
        assert r["graphs_captured"] == 1, r
        ran_only(replay["calls"], want, f"{name} replay")
        for a in arms.values():
            if a["step"].graphs is not None:
                a["step"].graphs.release()
        return r
    finally:
        set_amp(False)


def multistep_graphs(torch):
    """Phase 18c: every model of ms_models, graph against eager
    (`graph_vs_eager`); each model's graphs released before the next."""
    out = {}
    for model in ms_models(torch):
        out[model[0]] = graph_vs_eager(torch, *model)
        torch.cuda.empty_cache()
    return out


# ---- phase 19: the training lifecycle ------------------------------------

# 19a: the classifier through the CLI at bench_lstm's settings (18b's
# data and steps_per_dispatch); the run SIGTERMed once pass 1 has printed
# a batch at or past LC_PREEMPT_AT
LC_TEST_SAMPLES = CLS_B * 4 + 9
LC_PREEMPT_AT = 12
LC_TIME_BATCHES = 20
LC_EVALS = [{"type": "classification_error", "name": "error",
             "input": "output", "label": "label"},
            {"type": "precision_recall", "name": "pr", "input": "output",
             "label": "label"}]
LC_CONFIG = '''"""chip_smoke.py phase 19a's training config: the IMDB classifier at
bench_lstm's settings, steps_per_dispatch {k}, two evaluators."""
import sys

sys.path.insert(0, {smoke_dir!r})
import {smoke} as cs  # noqa: E402

from paddle_tpu_torch.core import flags  # noqa: E402
from paddle_tpu_torch.core.config import OptimizationConf  # noqa: E402
from paddle_tpu_torch.models.text import stacked_lstm_classifier  # noqa

flags.set_flag("seed", cs.SEED + 1)
flags.set_flag("steps_per_dispatch", cs.MS_K)
# the ladder's EWMA lives in one train() call (in both packages): on this
# data the uninterrupted run meets a loss spike at pass 1 batch 19 and
# backs its LR off, which a run resumed after that point cannot know
flags.set_flag("watchdog", False)
_train, _test, feeder = cs.cls_data()
evaluators = cs.LC_EVALS


def get_config():
    return (stacked_lstm_classifier(**cs.CLS),
            OptimizationConf(learning_method="adam",
                             learning_rate=cs.CLS_LR))


def train_reader():
    return _train


def test_reader():
    return _test
'''
# 19b/19c: bench_resnet50's fused AMP step (B = 256, momentum) with
# steps_per_dispatch 10; pass 0 ten clean batches, pass 1 twenty with
# NaN images at LC_NAN_AT: a skip, then skip_budget + 1 in a row roll
# back to pass 0's checkpoint, promoted by the two clean batches before
LC_IMAGE = (224, 224, 3)
LC_WATCHDOG = dict(skip_budget=2, good_batches=2, warmup_batches=1000)
LC_NAN_AT = (2, 4, 5, 6)


def run_cli(args, log, on_line=None, timeout=300, cwd=None):
    """`python -m paddle_tpu_torch <args>` from the checkout (or `cwd`) in
    a subprocess; returns (exit code, [(seconds since start, stdout
    line)]).
    Its stderr goes to `log`; `on_line(proc, line)` sees each line as it
    comes. The process is killed if it outlives `timeout`."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch", *args],
            cwd=cwd or repo,
            env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        lines, t0 = [], time.perf_counter()
        try:
            for line in proc.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip("\n")))
                if on_line is not None:
                    on_line(proc, line)
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc not in (0, 75):
        print(open(log).read()[-4000:], file=sys.stderr, flush=True)
    return rc, lines


def same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x.files)


def lifecycle_cli(torch, rnn, work):
    """Phase 19a: the classifier's lifecycle through `python -m
    paddle_tpu_torch` (the config LC_CONFIG: 18b's reader and feeder, a
    held-out test reader, classification_error and precision_recall,
    steps_per_dispatch 10). Runs: A trains 2 passes; B the same into
    another save_dir, SIGTERMed once pass 1 has printed a batch >=
    LC_PREEMPT_AT (exit 75, `PREEMPTED`); B' relaunched (`resuming ...
    skip N`, then exit 0), its pass-00001 params and slots bit-equal to
    A's; `--job=test` on A; `--job=time`; `merge_model` of A's last pass
    and `infer --example`. In process, on the card: two passes with the
    evaluators and two without (ms a step of the second pass), `test()`
    ms, a sync save's ms; `test()` on A's last pass prints what
    `--job=test` printed; `Inferencer.from_merged` bit-equal to an
    Inferencer on A's loaded params; B5/B6 launched on the cluster
    route."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    from paddle_tpu_torch.trainer.events import BeginPass, EndPass
    from paddle_tpu_torch.trainer.trainer import SGD, Inferencer

    smoke = os.path.abspath(__file__)
    conf_path = os.path.join(work, "classifier_conf.py")
    with open(conf_path, "w") as f:
        f.write(LC_CONFIG.format(
            k=MS_K, smoke_dir=os.path.dirname(smoke),
            smoke=os.path.splitext(os.path.basename(smoke))[0]))
    dirs = {r: os.path.join(work, r) for r in ("a", "b")}
    steps = -(-MS_SAMPLES // CLS_B)
    train = ["train", "--config", conf_path, "--num_passes", "2",
             "--log_period", "1", "--device", "cuda"]
    out = {}

    def timed(name, rc, lines, t_wall, **extra):
        r = {"rc": rc, "wall_s": t_wall, **extra}
        stamps = [t for t, ln in lines if ln.startswith("pass ")]
        if len(stamps) > 1:
            # between the first and the last printed batch (the chunks
            # land in bursts; a pass's checkpoint included)
            r["steps_printed"] = len(stamps)
            r["ms_per_step"] = (stamps[-1] - stamps[0]) / (
                len(stamps) - 1) * 1e3
        out[name] = r
        print(f"lifecycle cli {name} " + json.dumps(r), flush=True)

    t0 = time.perf_counter()
    rc, lines_a = run_cli(train + ["--save_dir", dirs["a"]],
                          os.path.join(work, "a.log"))
    timed("A", rc, lines_a, time.perf_counter() - t0)
    assert rc == 0, f"run A exited {rc}"

    sent = []

    def preempt(proc, line):
        if not sent and line.startswith("pass 1 batch ") and \
                int(line.split()[3]) >= LC_PREEMPT_AT:
            proc.send_signal(__import__("signal").SIGTERM)
            sent.append(line.strip())

    t0 = time.perf_counter()
    rc, lines_b = run_cli(train + ["--save_dir", dirs["b"]],
                          os.path.join(work, "b.log"), on_line=preempt)
    timed("B", rc, lines_b, time.perf_counter() - t0)
    pre = [ln for _t, ln in lines_b if ln.startswith("PREEMPTED ")]
    assert rc == 75 and len(pre) == 1, (
        f"run B: exit {rc}, SIGTERM after {sent}, PREEMPTED lines {pre}")
    done = int(pre[0].split()[-1])
    # the flush covers the chunks that ran before the flag was seen
    assert pre[0] == f"PREEMPTED pass 1 batch {done}" and \
        LC_PREEMPT_AT < done <= steps, pre
    t0 = time.perf_counter()
    rc, lines_b2 = run_cli(train + ["--save_dir", dirs["b"]],
                           os.path.join(work, "b2.log"))
    timed("B_relaunched", rc, lines_b2, time.perf_counter() - t0)
    resumed = (f"resuming from {dirs['b']}: start pass 1, skip {done} "
               f"batches")
    assert rc == 0 and resumed in [ln for _t, ln in lines_b2], (
        f"run B': exit {rc}, no line {resumed!r}")
    first = [ln for _t, ln in lines_b2 if ln.startswith("pass ")][:1]
    assert first == [] if done == steps else first[0].startswith(
        f"pass 1 batch {done} "), first
    final = {n: same_npz(os.path.join(dirs["a"], "pass-00001", n),
                         os.path.join(dirs["b"], "pass-00001", n))
             for n in ("params.npz", "opt_state.npz")}
    print("lifecycle cli preempted " + json.dumps(
        {"sigterm_after": sent[0], "preempted": pre[0], "resumed": resumed,
         "pass1_bit_equal_to_A": final}), flush=True)
    assert all(final.values()), final

    # --job=test beside merge_model and infer (the card is shared only by
    # processes whose time is not reported); then --job=time alone
    from concurrent.futures import ThreadPoolExecutor

    model = os.path.join(work, "classifier.npz")
    with ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        job_test = pool.submit(run_cli, [
            "train", "--config", conf_path, "--job", "test", "--save_dir",
            dirs["a"], "--device", "cuda"], os.path.join(work, "test.log"))
        rc, lines_m = run_cli(["merge_model", "--config", conf_path,
                               "--model_dir", dirs["a"], "--output", model],
                              os.path.join(work, "merge.log"))
        assert rc == 0 and lines_m[-1][1].endswith("-> " + model), lines_m
        rc, lines_i = run_cli(["infer", "--model", model, "--example",
                               "--batch", "2", "--device", "cuda"],
                              os.path.join(work, "infer.log"))
        got = [ln for _t, ln in lines_i]
        print("lifecycle cli merge/infer " + json.dumps(
            [lines_m[-1][1]] + got), flush=True)
        assert rc == 0 and got == ["outputs: ['output']",
                                   "output: shape (2, 2)"], got
        rc, lines_t = job_test.result()
    timed("test_merge_infer", rc, lines_t, time.perf_counter() - t0)
    assert rc == 0 and lines_t[-1][1].startswith("test cost "), lines_t
    t0 = time.perf_counter()
    rc, lines_time = run_cli(["train", "--config", conf_path, "--job",
                              "time", "--time_batches",
                              str(LC_TIME_BATCHES), "--device", "cuda"],
                             os.path.join(work, "time.log"))
    assert rc == 0 and lines_time[-1][1].startswith("time: "), lines_time
    timed("time", rc, lines_time, time.perf_counter() - t0,
          ms_per_batch=float(lines_time[-1][1].split()[1]))

    # in process: the same config on the card
    flags.reset_flags()
    reader, test_reader, feeder = cls_data()
    conf = stacked_lstm_classifier(**CLS)
    opt = OptimizationConf(learning_method="adam", learning_rate=CLS_LR)
    p0 = Network(conf).init_params(torch.Generator().manual_seed(SEED),
                                   device="cuda")
    zero_rnn_counts(rnn)
    runs = {}
    for arm, evals in (("evaluators_off", []), ("evaluators_on", LC_EVALS)):
        sgd = SGD(conf, opt, seed=SEED + 1, device="cuda",
                  steps_per_dispatch=MS_K, evaluators=evals,
                  params={k: v.clone() for k, v in p0.items()})
        stamps = {}

        def on_event(e):
            if isinstance(e, (BeginPass, EndPass)):
                stamps[(type(e).__name__, e.pass_id)] = time.perf_counter()

        sgd.train(reader=reader, feeder=feeder, num_passes=2,
                  event_handler=on_event)
        runs[arm] = (stamps[("EndPass", 1)] - stamps[("BeginPass", 1)]) \
            / steps * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sgd.test(test_reader, feeder)
    test_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ckpt.save_pass(os.path.join(work, "sync"), 0, sgd.params, sgd.opt_state,
                   sgd.state, meta={"global_step": sgd.global_step})
    save_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in rnn_counts(rnn).items() if v}
    del sgd
    # --job=test's line is the in-process test() of A's last pass
    a = SGD(conf, opt, seed=SEED + 5, device="cuda", evaluators=LC_EVALS)
    a.resume(dirs["a"])
    res_a = a.test(test_reader, feeder)
    line = (f"test cost {res_a['cost']:.6f} "
            + " ".join(f"{k}={v}" for k, v in res_a["evaluators"].items()))
    feed = feeder(next(iter(test_reader())))
    merged = Inferencer.from_merged(model, device="cuda").infer(
        feed)["output"]
    held = Inferencer(Network(conf), a.params, device="cuda").infer(
        feed)["output"]
    r = {"ms_per_step_evaluators_off": runs["evaluators_off"],
         "ms_per_step_evaluators_on": runs["evaluators_on"],
         "test_ms": test_ms, "test_batches": -(-LC_TEST_SAMPLES // CLS_B),
         "sync_save_ms": save_ms, "test": res, "job_test_line": line,
         "from_merged_bit_equal": bool(np.array_equal(merged, held)),
         "launch_counts": counts}
    out["in_process"] = r
    print("lifecycle classifier " + json.dumps(r), flush=True)
    assert lines_t[-1][1] == line, (lines_t[-1][1], line)
    assert r["from_merged_bit_equal"], "from_merged differs"
    assert all(0 < r[k] for k in ("ms_per_step_evaluators_off",
                                  "ms_per_step_evaluators_on"))
    for c in ("lstm_fwd", "lstm_bwd", "lstm_fwd_infer"):
        assert counts.get(f"{c}_launches", 0) > 0 and counts[
            f"{c}_launches"] == counts.get(f"{c}_cluster_launches"), (
            f"{c}: {counts}")
    del a
    torch.cuda.empty_cache()
    return out


def lc_resnet_conf():
    from paddle_tpu_torch.models.image import resnet

    return resnet(50, LC_IMAGE, 1000, fused=True)


def lc_resnet_feeds(torch):
    """Pass 0's ten clean feeds and pass 1's twenty, NaN images at
    LC_NAN_AT, made on the card from a seed (two image batches in
    turn)."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 300)
    images = [torch.randn((RESNET_AMP_BATCH, *LC_IMAGE), generator=gen,
                          device="cuda") for _ in range(2)]
    poisoned = images[0].clone()
    poisoned[3, 10, 10, 1] = float("nan")
    rng = np.random.default_rng(SEED + 301)

    def feed(image):
        return {"image": non_seq(image),
                "label": id_arg(rng.integers(0, 1000, RESNET_AMP_BATCH),
                                device="cuda")}

    return ([feed(images[i % 2]) for i in range(MS_K)],
            [feed(poisoned if i in LC_NAN_AT else images[i % 2])
             for i in range(2 * MS_K)])


def lifecycle_watchdog(torch, op, work):
    """Phase 19b: the watchdog ladder under graphs on bench_resnet50's
    fused AMP step (B = 256, the bf16 flag, momentum), steps_per_dispatch
    10, sync checkpoints each pass. Pass 0: ten clean batches; pass 1:
    batches 0-1 clean (pass 0's checkpoint promoted), 2 NaN (a skip), 3
    clean, 4-6 NaN (skip_budget + 1 in a row: a rollback to pass 0), then
    clean. Checks: each ladder event at the batch the reader set up, with
    the JAX trainer's global-step stamps (a chunk's events carry the
    step at its end); right after the rollback the graphs' static trees
    hold pass 0's checkpoint bit for bit; the next chunk's costs equal an
    eager run from that checkpoint over the same batches; training ends
    finite; B1-B3 bf16 launched (the wrappers' counts: the graph's
    warm-up and capture, the eager run). Returns (numbers, the trainer,
    pass 1's clean feeds)."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    from paddle_tpu_torch.trainer import watchdog as wdg
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    set_amp(True)
    conf = lc_resnet_conf()
    opt = OptimizationConf(**RESNET_OPT)
    pass0, pass1 = lc_resnet_feeds(torch)
    passes = [pass0, pass1]
    calls = []

    def reader():
        calls.append(1)
        return iter(passes[len(calls) - 1])

    save_dir = os.path.join(work, "resnet_sync")
    for c in FUSED_COUNTERS:
        setattr(op, c, 0)
    sgd = SGD(conf, opt, seed=SEED + 302, device="cuda",
              steps_per_dispatch=MS_K,
              watchdog=wdg.WatchdogConfig(**LC_WATCHDOG))
    rolled = []
    real_resume = sgd.resume

    def resume(d, pass_id=-1):
        # right after the rollback's load: the graphs' static trees
        # against the checkpoint's bytes
        start = real_resume(d, pass_id)
        p, o, s, _meta = ckpt.load_pass(d, pass_id)
        g = sgd.step_fn.graphs
        seated = (g is not None and sgd.params is g.params
                  and sgd.opt_state is g.opt_state and sgd.state is g.state)
        want = {**leaves(p, "param/"), **leaves(o, "slot/"),
                **leaves(s, "state/")}
        got = {**leaves(g.params, "param/"), **leaves(g.opt_state, "slot/"),
               **leaves(g.state, "state/")}
        differ = [k for k, v in want.items()
                  if not np.array_equal(got[k].cpu().numpy(), v)]
        rolled.append({"pass_id": pass_id, "seated": seated,
                       "leaves": len(want), "differ": differ,
                       "global_step": sgd.global_step})
        return start

    sgd.resume = resume
    costs, at = {}, []
    seen = [0]

    def on_event(e):
        if isinstance(e, EndIteration):
            costs[(e.pass_id, e.batch_id)] = e.cost
            events = sgd.last_watchdog_report.events
            at.extend((ev.kind, ev.global_step, e.pass_id, e.batch_id)
                      for ev in events[seen[0]:])
            seen[0] = len(events)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgd.train(reader=reader, feeder=lambda b: b, num_passes=2,
              event_handler=on_event, save_dir=save_dir,
              checkpoint_mode="sync")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del sgd.resume  # the trainer's own again
    graph_counts = {c: getattr(op, c) for c in FUSED_COUNTERS}
    # the eager run from pass 0's checkpoint over the chunk after the
    # rollback
    eager = SGD(conf, opt, seed=SEED + 303, device="cuda")
    eager.resume(save_dir, 0)
    eager_costs = [eager.run_step(f)[0] for f in pass1[MS_K:]]
    del eager
    counts = {c: getattr(op, c) for c in FUSED_COUNTERS}
    after = [costs[(1, b)] for b in range(MS_K, 2 * MS_K)]
    finite = all(bool(torch.isfinite(v).all()) for v in sgd.params.values())
    want_at = ([("promote", 2 * MS_K - 1, 1, 1)]
               + [("skip", 2 * MS_K - 1, 1, b) for b in LC_NAN_AT]
               + [("rollback", MS_K, 1, LC_NAN_AT[-1])])
    r = {"wall_s": wall, "graphs_captured": sgd.graphs_captured,
         "events": at, "report": sgd.last_watchdog_report.to_dict(),
         "rollback": rolled, "costs_after_rollback": after,
         "eager_costs": eager_costs,
         "costs_equal_eager": after == eager_costs,
         "finite": finite, "launch_counts": counts,
         "graph_run_counts": graph_counts}
    set_amp(False)
    print("lifecycle watchdog " + json.dumps(r), flush=True)
    assert [tuple(e) for e in at] == want_at, (at, want_at)
    assert len(rolled) == 1 and rolled[0]["seated"] and \
        not rolled[0]["differ"], rolled
    assert r["costs_equal_eager"], (after, eager_costs)
    assert finite and all(np.isfinite(after)), "training did not end finite"
    # the graph run: one warm-up step and the capture of ten (the rest
    # are replays); the eager run: ten steps; 29 fused sites a step
    n = 1 + MS_K
    assert graph_counts == dict.fromkeys(FUSED_COUNTERS[:3], 0) | \
        dict.fromkeys(FUSED_COUNTERS[3:], 29 * n), graph_counts
    assert counts == dict.fromkeys(FUSED_COUNTERS[:3], 0) | \
        dict.fromkeys(FUSED_COUNTERS[3:], 29 * (n + MS_K)), counts
    return r, sgd, pass1[MS_K:]


def lifecycle_async(torch, sgd, feeds, work):
    """Phase 19c: async checkpoints of 19b's trainer (the graphs' static
    trees). Three saves, each followed by a chunk of ten steps: the ms
    `save()` blocks the loop (the pinned device->host snapshot) against
    a step's ms and a sync `save_pass`; then the chunk after the third
    save is run again after `resume()` from that async pass (ms): costs,
    params and slots equal to the uninterrupted run's, though the first
    run overwrote the static trees while the writer serialized; a torn
    shard (truncated on purpose) is skipped by `latest_complete_pass`."""
    from paddle_tpu_torch.trainer import async_checkpoint as actp
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    set_amp(True)
    d = os.path.join(work, "resnet_async")
    cp = actp.AsyncCheckpointer(d)
    stalls, steps_ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp.save(i, sgd.params, sgd.opt_state, sgd.state,
                meta={"global_step": sgd.global_step})
        stalls.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cs, fs, _outs = sgd.run_steps(feeds)
        steps_ms.append((time.perf_counter() - t0) / len(feeds) * 1e3)
    held = {k: v.clone() for k, v in {**leaves(sgd.params, "param/"),
                                      **leaves(sgd.opt_state, "slot/"),
                                      **leaves(sgd.state, "state/")}.items()}
    step_after = sgd.global_step
    cp.wait()
    nbytes = os.path.getsize(os.path.join(d, "pass-00002", "shard-p0.npz"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = sgd.resume(d)
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    cs2, _fs2, _outs2 = sgd.run_steps(feeds)
    again = {**leaves(sgd.params, "param/"), **leaves(sgd.opt_state, "slot/"),
             **leaves(sgd.state, "state/")}
    differ = [k for k, v in held.items() if not torch.equal(v, again[k])]
    syncs = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_pass(os.path.join(work, "resnet_sync_timed"), i,
                       sgd.params, sgd.opt_state, sgd.state,
                       meta={"global_step": sgd.global_step})
        syncs.append((time.perf_counter() - t0) * 1e3)
    shard = os.path.join(d, "pass-00002", "shard-p0.npz")
    with open(shard, "r+b") as f:
        f.truncate(nbytes // 2)
    latest = actp.latest_complete_pass(d)
    cp.close()
    set_amp(False)
    step_ms = float(np.median(steps_ms))
    r = {"snapshot_bytes": nbytes, "stall_ms": stalls,
         "step_ms": steps_ms, "stall_share_of_step": [
             s / step_ms for s in stalls],
         "sync_save_ms": syncs, "resume_ms": resume_ms,
         "resume_start_pass": start, "steps_equal_after_resume":
         cs2 == cs and not differ, "leaves_differ": differ,
         "torn_latest_complete_pass": latest}
    print("lifecycle async " + json.dumps(r), flush=True)
    assert start == 3 and sgd.global_step == step_after, (start,
                                                          sgd.global_step)
    assert cs2 == cs and not differ, (cs, cs2, differ)
    assert latest == 1, latest
    return r


def lifecycle(torch, rnn, op):
    """Phase 19: 19a, 19b and 19c in a scratch directory (TMPDIR);
    returns their numbers."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    try:
        phase("19a. the classifier's lifecycle through the CLI")
        cli = lifecycle_cli(torch, rnn, work)
        phase("19b. the watchdog ladder under graphs, ResNet-50 AMP B=256")
        wd, sgd, feeds = lifecycle_watchdog(torch, op, work)
        phase("19c. async checkpoints of the ResNet-50 AMP step")
        asy = lifecycle_async(torch, sgd, feeds, work)
        del sgd
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"cli": cli, "watchdog": wd, "async": asy}


# ---- phase 20: beam-search generation and NMT serving ----------------------

GEN_STEPS = 10                # SGD batches a pass, and steps_per_dispatch
GEN_B, GEN_T_SRC, GEN_BEAM, GEN_MAX_LEN, GEN_K = 32, 32, 4, 32, 8
GEN_MARGIN = 1e-4             # PERF.md §2's serving rule
GEN_REPS = 3                  # timed decodes an arm, after a warm one
SERVE_GEN = dict(max_batch=8, buckets=(16, 32), requests=16, clients=4,
                 src_lens=(8, 32))
GRU_COUNTERS = ("gru_fwd_launches", "gru_fwd_cluster_launches",
                "gru_bwd_launches", "gru_bwd_cluster_launches")


def gru_counts(rnn):
    """The B7/B8 wrappers' counts that moved, all other RNN counts 0."""
    counts = rnn_counts(rnn)
    assert not any(v for k, v in counts.items() if k not in GRU_COUNTERS), (
        f"a kernel other than B7/B8 on the cluster route launched: {counts}")
    return {k: counts[k] for k in GRU_COUNTERS}


def fused_nmt(torch, rnn):
    """Phase 20(a): bench_nmt's fused arm (hidden 512, emb 512, vocab
    30000, B=256, T=32, adam 1e-3). One step of
    seq2seq_attention(fused_decoder=True) against the generic
    recurrent_group arm from one weight map at ragged lengths, with the
    generic arm in f64 (scan encoder) as the exact reference: the loss
    within TOL, every gradient within TOL of the largest entry plus
    twice the generic arm's own f32 error against f64, and as close to
    f64 as the generic arm, within TOL. Then each arm
    through SGD at steps_per_dispatch GEN_STEPS, two passes of
    GEN_STEPS batches (one CUDA graph: the first pass pays its warm-up
    and capture, the second is timed): every cost finite, the last below
    the first; the wrappers count the warm-up step and the captured
    steps, 2 B7 + 2 B8 a step, all on the cluster route. Returns the
    numbers and the fused arm's trained parameters."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models.text import seq2seq_attention
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.events import BeginPass, EndIteration, \
        EndPass
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.trainer.watchdog import WatchdogConfig

    confs = {"fused": seq2seq_attention(fused_decoder=True, **NMT),
             "generic": seq2seq_attention(**NMT)}
    p0 = Network(confs["fused"]).init_params(
        torch.Generator().manual_seed(SEED + 200), device="cuda")
    assert set(Network(confs["generic"]).param_confs) == set(p0)
    ragged = nmt_feed(SEED + 201, NMT_B, NMT_T, ragged=True)
    held = {}
    for arm, conf, dtype in (("fused", "fused", torch.float32),
                             ("generic", "generic", torch.float32),
                             ("generic_f64", "generic", torch.float64)):
        # the f64 arm on the scan encoder: the exact reference
        set_rnn_arm("scan" if dtype == torch.float64 else "kernels")
        p = {k: v.detach().to(dtype).clone().requires_grad_(True)
             for k, v in p0.items()}
        loss, _ = Network(confs[conf]).loss_fn(p, ragged)
        loss.backward()
        held[arm] = (loss.item(), {k: v.grad.double() for k, v in p.items()})
        del p, loss
    set_rnn_arm("kernels")
    (lf, gf), (lg, gg), (l64, g64) = (held[a] for a in (
        "fused", "generic", "generic_f64"))
    # every gradient of the fused arm within TOL + twice the generic arm's
    # own f32 error against f64 (phase 12's rule: the attention's
    # projection gradient cancels — near-uniform attention weights at
    # init — and f32 rounding alone moves it ~5e-4 at these widths), and
    # as close to f64 as the generic arm, within TOL
    rows = {}
    for k in gf:
        noise = rel_err(gg[k], g64[k])[0]
        rows[k] = {"vs_generic": rel_err(gf[k], gg[k])[0], "noise": noise,
                   "fused_vs_f64": rel_err(gf[k], g64[k])[0]}
    worst = max(rows, key=lambda k: rows[k]["vs_generic"]
                - 2 * rows[k]["noise"])
    r = {"loss_fused": lf, "loss_generic": lg, "loss_f64": l64,
         "loss_rel_err": abs(lf - lg) / abs(lg),
         "grad_max_rel_err": max(v["vs_generic"] for v in rows.values()),
         "grad_max_noise": max(v["noise"] for v in rows.values()),
         "grad_worst": worst, **{f"worst_{k}": v
                                 for k, v in rows[worst].items()}}
    print("generation fused_held " + json.dumps(r), flush=True)
    assert r["loss_rel_err"] <= TOL, r
    for k, v in rows.items():
        assert v["vs_generic"] <= TOL + 2 * v["noise"], (k, v)
        assert v["fused_vs_f64"] <= v["noise"] + TOL, (k, v)
    del held, gf, gg, g64
    out = {"held": r}
    feed = nmt_feed(SEED + 202, NMT_B, NMT_T, ragged=False)
    for arm, conf in confs.items():
        sgd = SGD(conf, OptimizationConf(learning_method="adam",
                                         learning_rate=NMT_LR),
                  seed=SEED + 1, device="cuda", steps_per_dispatch=GEN_STEPS,
                  params={k: v.clone() for k, v in p0.items()},
                  watchdog=WatchdogConfig(warmup_batches=2 * GEN_STEPS + 1))
        costs, stamps = [], {}

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)
            elif isinstance(e, (BeginPass, EndPass)):
                stamps[(type(e).__name__, e.pass_id)] = time.perf_counter()

        torch.cuda.synchronize()
        zero_rnn_counts(rnn)
        sgd.train(reader=lambda: iter([feed] * GEN_STEPS),
                  feeder=lambda b: b, num_passes=2, event_handler=on_event)
        torch.cuda.synchronize()
        counts = gru_counts(rnn)

        def ms(p):
            return (stamps[("EndPass", p)] - stamps[("BeginPass", p)]) \
                / GEN_STEPS * 1e3

        run = {"steps": len(costs), "ms_per_step_pass1": ms(0),
               "ms_per_step": ms(1),
               "tokens_per_s": NMT_B * NMT_T / (ms(1) / 1e3),
               "graphs_captured": sgd.graphs_captured,
               "loss_first": costs[0], "loss_last": costs[-1],
               "launches": counts}
        print(f"generation train_{arm} " + json.dumps(run), flush=True)
        assert np.isfinite(costs).all() and len(costs) == 2 * GEN_STEPS, run
        assert run["loss_last"] < run["loss_first"], run
        assert run["graphs_captured"] == 1, run
        # the wrappers count one warm-up step and the captured steps
        n = 2 * (1 + GEN_STEPS)
        assert counts == dict.fromkeys(GRU_COUNTERS, n), (
            f"{arm}: B7/B8 launched {counts}, want {n} each")
        out[arm] = run
        if arm == "fused":
            trained = {k: v.detach().clone() for k, v in sgd.params.items()}
        # the graph freed here, not by a later collection
        sgd.step_fn.graphs.release()
        del sgd
        torch.cuda.empty_cache()
    return out, trained


class MarginRecorder:
    """Host-rung hooks that change nothing (or forbid a token, with
    `inner`) and record, at each step, each row's smallest gap between
    consecutive scores among its top K + 1 candidates: the margin of the
    serving rule (a finished beam is one whose last word is eos)."""

    def __init__(self, eos, inner=None):
        self.eos, self.inner = eos, inner
        self.margins = []
        self.scores = self.finished = None

    def adjust(self, logp, t):
        if self.inner is not None:
            logp = self.inner(logp, t)
        b, k, v = logp.shape
        if t == 0:
            self.scores = np.full((b, k), -1e30, np.float32)
            self.scores[:, 0] = 0.0
            self.finished = np.zeros((b, k), bool)
        fin_row = np.full((v,), -1e30, np.float32)
        fin_row[self.eos] = 0.0
        cand = (self.scores[..., None] + np.where(
            self.finished[..., None], fin_row, logp)).reshape(b, -1)
        top = -np.sort(np.partition(-cand, k, axis=1)[:, :k + 1], axis=1)
        self.margins.append(np.min(top[:, :-1] - top[:, 1:], axis=1))
        return logp

    def drop(self, words, scores, t):
        self.scores, self.finished = scores.copy(), words == self.eos
        return scores, np.zeros(words.shape, bool)

    def hooks(self):
        from paddle_tpu_torch.beam_search import BeamHooks

        return BeamHooks(adjust=self.adjust, drop=self.drop)


def best_tokens(seqs, lens, i):
    return [int(x) for x in seqs[i, 0, :int(lens[i, 0])]]


def margin_rule(name, got, ref, margins):
    """Each row's best-beam tokens of `got` equal `ref`'s, unless the
    reference's margin at some step up to the first differing token is
    below GEN_MARGIN (`margins`: [steps][rows], or a function of the
    row giving its steps' margins). Returns (rows equal, rows excused)."""
    equal = excused = 0
    for i in range(len(got[0])):
        a, b = best_tokens(got[0], got[1], i), best_tokens(ref[0], ref[1], i)
        if a == b:
            equal += 1
            continue
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        m = margins(i) if callable(margins) else [s[i] for s in margins]
        low = min(m[:t + 1])
        assert low < GEN_MARGIN, (
            f"{name}: row {i} differs at token {t} with the reference's "
            f"smallest margin {low:.3g} >= {GEN_MARGIN} (got {a}, want {b})")
        excused += 1
    return equal, excused


def beam_generation(torch, rnn, params):
    """Phase 20(b): generation at bench_beam_decode's settings (B=32,
    t_src=32, beam 4, max_len 32) from (a)'s trained parameters. The
    encoder runs through B7 (2 launches, cluster route), held against
    its scan arm (enc and dec_boot within TOL of the largest entry, the
    decoded tokens by the margin rule). Arms: eager K=1, graphs at K=8
    and K=1 (`torch.equal` seqs, lens and scores to the eager arm, its
    steps, chain depth ceil(steps / K)), the host rung per token (by
    the margin rule; its run records the margins) and chunked at K=8
    (equal to the eager arm: the same device chunks); an adjust hook
    forbidding the eager arm's most frequent token on the device rung
    (eager, a substep a token) and on the host rung: the same tokens by
    the margin rule, and no beam carries it. Each arm: best-beam
    tokens/s (B * max_len over the best of GEN_REPS decodes, as
    bench_beam_decode counts), `last_timeline` and the chain depth."""
    from paddle_tpu_torch.beam_search import BeamHooks
    from paddle_tpu_torch.core.arg import id_arg
    from paddle_tpu_torch.models.text import seq2seq_attention, \
        seq2seq_attention_decoder
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.serving.host_decode import host_generate

    net = Network(seq2seq_attention(fused_decoder=True, **NMT))

    def encode(ids, lens):
        with torch.no_grad():
            outs, _ = net.forward(params, {"src": id_arg(ids, lens,
                                                         device="cuda")},
                                  outputs=["enc", "dec_boot"])
        return [outs["enc"]], {"dec_state": outs["dec_boot"].value}

    def decoder(k_tok, graphs=True, hooks=None, beam=GEN_BEAM):
        dec = seq2seq_attention_decoder(
            trg_vocab=NMT["trg_vocab"], emb_dim=NMT["emb_dim"],
            hidden=NMT["hidden"], bos_id=0, eos_id=EOS, beam_size=beam,
            max_length=GEN_MAX_LEN, tokens_per_dispatch=k_tok)
        dec.use_graphs = graphs
        dec.hooks = hooks or dec.hooks
        return dec

    rng = np.random.default_rng(SEED + 210)
    src = rng.integers(2, NMT["src_vocab"], (GEN_B, GEN_T_SRC)).astype(
        np.int32)
    lens = np.full(GEN_B, GEN_T_SRC, np.int32)
    zero_rnn_counts(rnn)
    statics, boots = encode(src, lens)
    torch.cuda.synchronize()
    enc_counts = gru_counts(rnn)
    assert enc_counts == dict(gru_fwd_launches=2, gru_fwd_cluster_launches=2,
                              gru_bwd_launches=0,
                              gru_bwd_cluster_launches=0), enc_counts
    set_rnn_arm("scan")
    s_statics, s_boots = encode(src, lens)
    set_rnn_arm("kernels")
    enc_err = {"enc": rel_err(statics[0].value, s_statics[0].value)[0],
               "dec_boot": rel_err(boots["dec_state"],
                                   s_boots["dec_state"])[0]}
    print("generation encoder " + json.dumps(
        {"launches": enc_counts, "max_rel_err_vs_scan": enc_err}), flush=True)
    assert max(enc_err.values()) <= TOL, enc_err

    def timed(name, dec, fn, reps=GEN_REPS):
        out = fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        r = {"tokens_per_s": GEN_B * GEN_MAX_LEN / best, "ms": best * 1e3,
             "steps": dec.last_steps, "chain_depth": dec.last_chain_depth,
             **dec.last_timeline}
        print(f"generation decode_{name} " + json.dumps(r), flush=True)
        return r, tuple(x.cpu().numpy() if torch.is_tensor(x) else x
                        for x in out)

    def device(dec, st=statics, bt=boots):
        return lambda: dec.generate(params, st, bt)

    arms, outs = {}, {}
    dec = decoder(1, graphs=False)
    arms["eager_k1"], outs["eager_k1"] = timed("eager_k1", dec, device(dec))
    steps = arms["eager_k1"]["steps"]
    for name, k_tok in (("graph_k8", GEN_K), ("graph_k1", 1)):
        dec = decoder(k_tok)
        arms[name], outs[name] = timed(name, dec, device(dec))
        assert all(np.array_equal(a, b) for a, b in zip(
            outs[name], outs["eager_k1"])), f"{name} differs from eager"
        assert arms[name]["steps"] == steps, arms[name]
        assert arms[name]["chain_depth"] == -(-steps // k_tok), arms[name]
        if name == "graph_k8":
            # where a replayed decode's device time goes
            prof = profile_fn(torch, device(dec), steps=3)
            if prof is not None:
                prof["idle_share"] = 1 - prof["device_ms_per_step"] / \
                    arms[name]["ms"]
            print("generation profile_graph_k8 " + json.dumps(prof),
                  flush=True)
            arms[name]["profile"] = prof
    dec = decoder(1)
    arms["host_k1"], outs["host_k1"] = timed(
        "host_k1", dec, lambda: host_generate(dec, params, statics, boots),
        reps=1)
    # the host rung again with hooks that only record its margins: the
    # same decode
    rec = MarginRecorder(EOS)
    recorded = host_generate(dec, params, statics, boots, hooks=rec.hooks())
    assert all(np.array_equal(a, b) for a, b in zip(
        recorded, outs["host_k1"])), "recording hooks changed the decode"
    margins = rec.margins
    host_rule = margin_rule("host_k1", outs["eager_k1"], outs["host_k1"],
                            margins)
    dec = decoder(GEN_K)
    arms["host_k8"], outs["host_k8"] = timed(
        "host_k8", dec, lambda: host_generate(dec, params, statics, boots))
    assert all(np.array_equal(a, b) for a, b in zip(
        outs["host_k8"], outs["eager_k1"])), "the chunked host rung differs"
    assert arms["host_k8"]["chain_depth"] == -(-steps // GEN_K)
    # the tokens from the scan arm's encoder, by the margin rule
    dec = decoder(GEN_K)
    scan_out = tuple(x.cpu().numpy() for x in dec.generate(
        params, s_statics, s_boots))
    scan_rule = margin_rule("scan encoder", scan_out, outs["eager_k1"],
                            margins)
    # an adjust hook forbidding the most frequent generated token
    words = np.concatenate([best_tokens(*outs["eager_k1"][:2], i)
                            for i in range(GEN_B)])
    words = words[words != EOS]
    forbid = int(np.bincount(words).argmax())

    def no_forbid(logp, t):
        logp = logp.copy()
        logp[:, :, forbid] = -1e30
        return logp

    dec = decoder(1, hooks=BeamHooks(adjust=no_forbid))
    arms["hook_device"], outs["hook_device"] = timed(
        "hook_device", dec, device(dec), reps=1)
    recs = []

    def hook_host():
        recs.append(MarginRecorder(EOS, inner=no_forbid))
        return host_generate(dec, params, statics, boots,
                             hooks=recs[-1].hooks())

    dec = decoder(1)
    arms["hook_host"], outs["hook_host"] = timed("hook_host", dec,
                                                 hook_host, reps=1)
    hook_rule = margin_rule("hook", outs["hook_device"], outs["hook_host"],
                            recs[-1].margins)
    for name in ("hook_device", "hook_host"):
        seqs, lens_ = outs[name][:2]
        for i in range(GEN_B):
            for k in range(GEN_BEAM):
                assert forbid not in seqs[i, k, :lens_[i, k]], (
                    f"{name}: row {i} beam {k} carries {forbid}")
    r = {"forbidden_token": forbid, "host_vs_eager": host_rule,
         "scan_encoder_vs_kernel": scan_rule,
         "hook_device_vs_host": hook_rule}
    print("generation checks " + json.dumps(r), flush=True)
    return {"arms": arms, "checks": r, "encode": encode, "decoder": decoder,
            "enc_launches": enc_counts}


def serve_generation(torch, rnn, params, gen, speculative=None,
                     draft_params=None):
    """Phase 20(c): an InferenceServer with GenerationModel(encode=...,
    named_hooks={"forbid": ...}) behind the TCP front end, max_batch 8,
    buckets (16, 32), the decoder at K = 8 (graphs). 16 requests from 4
    client threads, source lengths 8-32 drawn from the seed, one naming
    the hook; a first round warms the graphs, the second is checked and
    timed. Each answer's tokens equal a lone generate() of its source at
    its bucket (another decoder) by the margin rule; the hook answer's
    path is "host", its tokens a lone host_generate with the hook's and
    without the token. Prints the median and max latency_ms and the
    served tokens/s.

    With `speculative` (phase 22(c)): the model serves its target (a
    beam-1 decoder) with the speculative rung, `draft_params` and the
    target's encoding for the draft (`draft_encode`); the hook-free
    answers' path is "spec", and every answer is held against a lone
    call of a beam-1 decoder."""
    import threading

    from paddle_tpu_torch.beam_search import BeamHooks
    from paddle_tpu_torch.serving.host_decode import host_generate
    from paddle_tpu_torch.serving.models import GenerationModel
    from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig
    from paddle_tpu_torch.serving.tcp import ServeClient, ServingTCPServer

    forbid = gen["checks"]["forbidden_token"]

    def no_forbid(logp, t):
        logp = logp.copy()
        logp[:, :, forbid] = -1e30
        return logp

    cfg = SERVE_GEN
    beam = GEN_BEAM if speculative is None else 1
    model = GenerationModel(
        gen["decoder"](GEN_K) if speculative is None else speculative.target,
        params, encode=gen["encode"],
        named_hooks={"forbid": BeamHooks(adjust=no_forbid)},
        speculative=speculative, draft_params=draft_params,
        draft_encode=None if speculative is None else gen["encode"])
    server = InferenceServer(ServeConfig(
        max_queue=64, max_batch=cfg["max_batch"], buckets=cfg["buckets"],
        default_deadline_s=60.0))
    server.add_model("nmt", model)
    tcp = ServingTCPServer(server)
    rng = np.random.default_rng(SEED + 220)
    n_req = cfg["requests"]
    src_lens = rng.integers(cfg["src_lens"][0], cfg["src_lens"][1] + 1,
                            n_req)
    sources = [rng.integers(2, NMT["src_vocab"], n).astype(np.int32)
               for n in src_lens]
    hooked = int(rng.integers(n_req))
    per = n_req // cfg["clients"]

    def round_trip():
        answers = [None] * n_req

        def client(c):
            with ServeClient(f"127.0.0.1:{tcp.port}") as cl:
                for j in range(c * per, (c + 1) * per):
                    answers[j] = cl.call(
                        "nmt", sources[j].tolist(), timeout=120,
                        hooks="forbid" if j == hooked else None)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(cfg["clients"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        return answers, time.perf_counter() - t0

    zero_rnn_counts(rnn)
    try:
        warm, _ = round_trip()
        answers, wall = round_trip()
    finally:
        tcp.stop(drain=True)
        server.shutdown(drain=True)
    counts = gru_counts(rnn)
    assert all(a is not None and a["ok"] for a in warm + answers), [
        a for a in warm + answers if a is None or not a["ok"]]
    lone = gen["decoder"](GEN_K, beam=beam)
    equal = excused = 0
    for j, a in enumerate(answers):
        bucket = next(b for b in cfg["buckets"] if b >= len(sources[j]))
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :len(sources[j])] = sources[j]
        statics, boots = gen["encode"](ids, np.asarray([len(sources[j])],
                                                       np.int32))
        rec = MarginRecorder(EOS, inner=no_forbid if j == hooked else None)
        if j == hooked:
            assert a["path"] == "host", a
            assert forbid not in a["tokens"], a
            ref = host_generate(lone, params, statics, boots,
                                hooks=rec.hooks())
        else:
            assert a["path"] == ("jit" if speculative is None
                                 else "spec"), a
            ref = tuple(x.cpu().numpy() for x in lone.generate(
                params, statics, boots))
        got = (np.asarray([[a["tokens"]]]), np.asarray([[len(a["tokens"])]]))

        def margins(_i, ref_rec=rec, st=statics, bt=boots):
            # the hook-free reference's margins, from a host run that
            # records them (only where the tokens differ)
            if not ref_rec.margins:
                host_generate(gen["decoder"](1, beam=beam), params, st, bt,
                              hooks=ref_rec.hooks())
            return [m[0] for m in ref_rec.margins]

        e, x = margin_rule(f"served request {j}", got, ref, margins)
        equal, excused = equal + e, excused + x
    lat = sorted(a["latency_ms"] for a in answers)
    tokens = sum(len(a["tokens"]) for a in answers)
    r = {"requests": n_req, "clients": cfg["clients"],
         "src_lens": [int(x) for x in src_lens], "hooked": hooked,
         "latency_ms_median": float(np.median(lat)),
         "latency_ms_max": lat[-1], "wall_s": wall,
         "served_tokens": tokens, "served_tokens_per_s": tokens / wall,
         "tokens_equal": equal, "tokens_excused_by_margin": excused,
         "launches": counts, "server": server.stats()}
    print(("generation serve " if speculative is None
           else "speculative serve ") + json.dumps(r), flush=True)
    assert counts["gru_fwd_launches"] > 0 and counts[
        "gru_fwd_cluster_launches"] == counts["gru_fwd_launches"], counts
    return r


def generation(torch, rnn):
    """Phase 20: (a) the fused decoder's training arm, (b) beam
    generation from its parameters, (c) serving it over TCP."""
    phase("20a. the attention NMT's fused decoder arm through SGD")
    trained, params = fused_nmt(torch, rnn)
    phase("20b. beam-search generation at bench_beam_decode's settings")
    gen = beam_generation(torch, rnn, params)
    phase("20c. the NMT served over TCP by GenerationModel")
    served = serve_generation(torch, rnn, params, gen)
    torch.cuda.empty_cache()
    return {"train": trained, "generate": gen["arms"],
            "checks": gen["checks"], "enc_launches": gen["enc_launches"],
            "serve": served, "params": params, "encode": gen["encode"],
            "decoder": gen["decoder"]}


# ---- phase 21: nested sequences and the structured heads ----------------

# 21a: the document classifiers at bench_lstm's widths (the conf's
# defaults, vocab 1000 / emb 16 / hidden 32, are a unit-test size):
# DOC_B documents of DOC_S sentence slots, each sentence 1..DOC_WORDS
# words, the last slot empty in every document (an all-zero subseq_lens
# column) and one sentence mid-document empty in the first row of every
# batch; the feeder pads every batch to DOC_T words, so all batches share
# one shape (one graph)
DOC = dict(vocab_size=30000, emb_dim=128, hidden=256)
DOC_B, DOC_S, DOC_WORDS, DOC_T = 64, 8, 25, 200
DOC_BATCHES, DOC_K, DOC_LR = 8, 4, 2e-3
# a gradient on the card against the port on the CPU (plain versions), of
# its largest entry, plus twice the CPU's own f32 distance from f64
HELD_TOL = 1e-4
# 21b: the CRF taggers, B = CRF_B, ragged lengths up to CRF_T (one row at
# CRF_T in every batch)
CRF_B, CRF_T, CRF_STEPS, CRF_LR = 64, 100, 6, 2e-3
CRF_CONFS = (("linear_crf_tagger", "linear_crf_tagger", {}),
             ("rnn_crf_tagger", "rnn_crf_tagger", {}),
             ("rnn_crf_tagger_h256", "rnn_crf_tagger",
              dict(emb_dim=128, hidden=256)))
# 21c: bench.py's alexnet_bs64 row (bench_image: 224 x 224 x 3, 1000
# classes, momentum 0.001 / 0.9)
ALEX_B, ALEX_STEPS = 64, 10


def doc_conf(kind):
    """21a's confs: `hierarchical_lstm_classifier` at DOC, or the same
    walk with the sentence encoder's `recurrent` replaced by
    `simple_lstm(emb, hidden)` (B5/B6 once per sentence slot); the
    group's max_subseq_len at DOC_WORDS, the data's longest sentence
    (nothing is truncated; the inner walk is DOC_WORDS steps, not
    DOC_T)."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.models.text import hierarchical_lstm_classifier

    if kind == "hierarchical":
        conf = hierarchical_lstm_classifier(**DOC)
    else:
        h = DOC["hidden"]
        with dsl.model() as g:
            words = dsl.data("words", (1,), is_seq=True, is_ids=True,
                             has_subseq=True)
            lbl = dsl.data("label", (1,), is_ids=True)

            def sentence_step(w_sub):
                doc_prev = dsl.memory("doc", size=h)
                emb = dsl.embedding(w_sub, size=DOC["emb_dim"],
                                    vocab_size=DOC["vocab_size"],
                                    name="word_emb")
                enc = dsl.simple_lstm(emb, h, name="sent_lstm")
                last = dsl.last_seq(enc, name="sent_vec")
                return dsl.mixed(h, [(last, "identity"),
                                     (doc_prev, "full_matrix")],
                                 act="tanh", bias=False, name="doc")

            sent = dsl.recurrent_group(sentence_step, [words],
                                       name="doc_enc")
            out = dsl.fc(dsl.last_seq(sent, name="doc_vec"), size=2,
                         name="output")
            dsl.classification_cost(out, lbl)
            g.conf.output_layer_names.append("output")
        conf = g.conf
    conf.layer("doc_enc").attrs["max_subseq_len"] = DOC_WORDS
    return conf


def doc_data():
    """21a's batches (lists of (document, label) samples) and the
    port's DataFeeder with a `sub_sequence` input."""
    from paddle_tpu_torch.data import feeder as dfeeder

    rng = np.random.default_rng(SEED + 300)
    batches = []
    for _ in range(DOC_BATCHES + 1):
        docs = []
        for b in range(DOC_B):
            lens = rng.integers(1, DOC_WORDS + 1, DOC_S)
            lens[-1] = 0
            if b == 0:
                lens[DOC_S // 2] = 0
            docs.append(([rng.integers(0, DOC["vocab_size"], n).tolist()
                          for n in lens], int(rng.integers(0, 2))))
        batches.append(docs)
    feeder = dfeeder.DataFeeder(
        {"words": 0, "label": 1},
        {"words": dfeeder.integer_value_sub_sequence(DOC["vocab_size"]),
         "label": dfeeder.integer_value(2)}, buckets=(DOC_T,))
    return batches, feeder


def held_grads(torch, name, conf, params, feed):
    """The loss and every gradient of `conf` on the card against the port
    on the CPU (the kernels' plain versions) from the same parameters and
    feed: each within HELD_TOL of its largest entry plus twice the CPU
    f32 run's distance from the CPU f64 run, the loss at rtol HELD_TOL.
    Returns the numbers."""
    from paddle_tpu_torch.network import Network

    from paddle_tpu_torch.core import flags

    net = Network(conf)

    def run(device, dtype):
        p = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
             for k, v in params.items()}
        loss, _ = net.loss_fn(p, {k: a.to(device) for k, a in feed.items()})
        loss.backward()
        return loss.item(), {k: v.grad.detach().double().cpu()
                             for k, v in p.items()}

    # the kernels' path on both devices: B5/B6 on the card, their plain
    # versions on the CPU
    flags.set_flag("use_pallas_rnn", True)
    try:
        (lc, gc), (l32, g32), (l64, g64) = (run("cuda", torch.float32),
                                            run("cpu", torch.float32),
                                            run("cpu", torch.float64))
    finally:
        flags.set_flag("use_pallas_rnn", None)
    errs = {k: (rel_err(gc[k], g32[k])[0], rel_err(g32[k], g64[k])[0])
            for k in gc}
    outside = [k for k, (e, noise) in errs.items()
               if not e <= HELD_TOL + 2 * noise]
    r = {"loss_card": lc, "loss_cpu": l32, "loss_cpu_f64": l64,
         "loss_rel": abs(lc - l32) / abs(l32), "grads": len(errs),
         "grad_rel_max": max(e for e, _n in errs.values()),
         "cpu_f32_vs_f64_max": max(n for _e, n in errs.values()),
         "grads_outside": outside}
    print(f"held card vs cpu {name} " + json.dumps(r), flush=True)
    assert np.isfinite(lc) and r["loss_rel"] <= HELD_TOL, r
    assert not outside, f"{name}: gradients outside the bound: {outside}"
    return r


def sgd_arms(torch, rnn, name, conf, params, batches, feeder, lr, arms):
    """`SGD.train` over `batches` for two passes from `params`, one run
    for each (arm, steps_per_dispatch) of `arms`. Returns {arm: (numbers,
    {path: tensor} of the costs, params and adam slots)}; the numbers:
    ms a step of each pass, graphs captured, first and last loss, and
    the LSTM wrappers' launch counts over both passes."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.events import BeginPass, EndIteration, \
        EndPass
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.trainer.watchdog import WatchdogConfig

    out = {}
    for arm, spd in arms:
        sgd = SGD(conf, OptimizationConf(learning_method="adam",
                                         learning_rate=lr),
                  seed=SEED + 1, device="cuda", steps_per_dispatch=spd,
                  params={k: v.clone() for k, v in params.items()},
                  watchdog=WatchdogConfig(
                      warmup_batches=2 * len(batches) + 1))
        costs, stamps = [], {}

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)
            elif isinstance(e, (BeginPass, EndPass)):
                stamps[(type(e).__name__, e.pass_id)] = time.perf_counter()

        zero_rnn_counts(rnn)
        sgd.train(reader=lambda: iter(batches), feeder=feeder, num_passes=2,
                  event_handler=on_event)
        torch.cuda.synchronize()
        counts = {k: v for k, v in rnn_counts(rnn).items() if v}
        r = {"steps_per_dispatch": spd, "steps": len(costs),
             "ms_per_step_pass1": (stamps[("EndPass", 0)]
                                   - stamps[("BeginPass", 0)])
             / len(batches) * 1e3,
             "ms_per_step": (stamps[("EndPass", 1)]
                             - stamps[("BeginPass", 1)])
             / len(batches) * 1e3,
             "graphs_captured": sgd.graphs_captured,
             "loss_first": costs[0], "loss_last": costs[-1],
             "launch_counts": counts}
        print(f"train {name} {arm} " + json.dumps(r), flush=True)
        assert np.isfinite(costs).all() and len(costs) == 2 * len(
            batches), r
        out[arm] = (r, {"costs": torch.tensor(costs, dtype=torch.float64),
                        **{k: v.clone() for k, v in {
                            **leaves(sgd.params, "param/"),
                            **leaves(sgd.opt_state, "slot/")}.items()}})
        del sgd
    return out


def nested_vs_flat_lstm(torch, rnn, sub):
    """21a: B5 (training form, with c) and B6 over one batch's words as
    the nested walk launches them, once a sentence slot on [B, DOC_WORDS]
    with that slot's lengths, against one flat walk of the same words
    ([B, T], a row's sentences back to back, T its longest row): CUDA
    events over all of each side's launches (`time_ms`), random inputs
    at DOC's hidden width."""
    h = DOC["hidden"]
    b, s = sub.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 301)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    flat_lens = sub.sum(dim=1, dtype=torch.int32)
    t = int(flat_lens.max())
    w, b7 = rand(h, 4 * h, scale=h ** -0.5), rand(7 * h, scale=0.1)
    x_flat = rand(b, t, 4 * h)
    x_sub = [rand(b, DOC_WORDS, 4 * h) for _ in range(s)]
    lens_sub = [sub[:, i].contiguous() for i in range(s)]
    ys = [rnn.lstm_seq_fwd(x_sub[i], w, b7, lens_sub[i]) for i in range(s)]
    yf, cf = rnn.lstm_seq_fwd(x_flat, w, b7, flat_lens)
    dys = [torch.randn_like(y) for y, _c in ys]
    dyf = torch.randn_like(yf)
    r = {"slots": s, "sub_t": DOC_WORDS, "flat_t": t, "words": int(
        flat_lens.sum()),
         "nested_fwd_ms": time_ms(torch, lambda: [
             rnn.lstm_seq_fwd(x_sub[i], w, b7, lens_sub[i])
             for i in range(s)]),
         "flat_fwd_ms": time_ms(torch, lambda: rnn.lstm_seq_fwd(
             x_flat, w, b7, flat_lens)),
         "nested_bwd_ms": time_ms(torch, lambda: [
             rnn.lstm_seq_bwd(x_sub[i], w, b7, lens_sub[i], ys[i][0],
                              ys[i][1], dys[i]) for i in range(s)]),
         "flat_bwd_ms": time_ms(torch, lambda: rnn.lstm_seq_bwd(
             x_flat, w, b7, flat_lens, yf, cf, dyf))}
    print("nested vs flat lstm walk " + json.dumps(r), flush=True)
    return r


def nested_docs(torch, rnn):
    """Phase 21a: both document classifiers (`doc_conf`) at DOC through
    the port's DataFeeder: the first batch's loss and gradients on the
    card against the CPU (`held_grads`), then `SGD.train` two passes of
    DOC_BATCHES batches eagerly (twice) and at steps_per_dispatch DOC_K
    (one CUDA graph), the graph arm held bit for bit against the eager
    ones (`held_graph_vs_eager`: costs, params, adam slots). The LSTM
    conf's wrappers launch B5 and B6 once per sentence slot a step, all
    on the cluster route: DOC_S each a step eagerly, and at K = DOC_K
    only the warm-up step and the DOC_K captured ones. Returns each
    conf's numbers."""
    from paddle_tpu_torch.network import Network

    batches, feeder = doc_data()
    held_feed = feeder(batches[-1])
    assert (held_feed["words"].subseq_lens[:, -1] == 0).all()
    assert (held_feed["words"].subseq_lens[0, DOC_S // 2] == 0)
    out = {}
    for kind in ("hierarchical", "nested_lstm"):
        conf = doc_conf(kind)
        p0 = Network(conf).init_params(torch.Generator().manual_seed(SEED),
                                       device="cpu")
        held = held_grads(torch, f"doc {kind}", conf, p0, held_feed)
        p0 = {k: v.to("cuda") for k, v in p0.items()}
        arms = sgd_arms(torch, rnn, f"doc {kind}", conf, p0,
                        batches[:DOC_BATCHES], feeder, DOC_LR,
                        (("k1", 1), ("k1_again", 1), (f"k{DOC_K}", DOC_K)))
        g, _ = arms[f"k{DOC_K}"]
        assert g["graphs_captured"] == 1, g
        nondet = held_graph_vs_eager(torch, f"doc {kind}", arms["k1"][1],
                                     arms["k1_again"][1],
                                     arms[f"k{DOC_K}"][1])
        steps = 2 * DOC_BATCHES
        if kind == "nested_lstm":
            for arm, n in (("k1", steps), ("k1_again", steps),
                           (f"k{DOC_K}", 1 + DOC_K)):
                got = arms[arm][0]["launch_counts"]
                want = dict.fromkeys(
                    ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
                     "lstm_bwd_launches", "lstm_bwd_cluster_launches"),
                    n * DOC_S)
                assert got == want, f"{kind} {arm}: launched {got}, want {want}"
        else:
            assert not any(a[0]["launch_counts"] for a in arms.values())
        r = {"held": held,
             "nested_vs_flat": (nested_vs_flat_lstm(
                 torch, rnn, held_feed["words"].subseq_lens.to("cuda"))
                 if kind == "nested_lstm" else None), "eager_ms_per_step": arms["k1"][0]["ms_per_step"],
             "graph_ms_per_step": g["ms_per_step"],
             "graph_ms_per_step_pass1": g["ms_per_step_pass1"],
             "eager_runs_differ": nondet,
             "launches": {arm: a[0]["launch_counts"]
                          for arm, a in arms.items()}}
        print(f"nested {kind} " + json.dumps(r), flush=True)
        out[kind] = r
        torch.cuda.empty_cache()
    return out


def crf_data(seed, n_batches):
    """21b's batches: CRF_B sentences of 1..CRF_T words (one of CRF_T in
    each batch) with random tags, and the port's DataFeeder (it pads ids
    and tags with 0)."""
    from paddle_tpu_torch.data import feeder as dfeeder

    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        lens = rng.integers(1, CRF_T + 1, CRF_B)
        lens[0] = CRF_T
        batches.append([(rng.integers(0, 5000, n).tolist(),
                         rng.integers(0, 9, n).tolist()) for n in lens])
    feeder = dfeeder.DataFeeder(
        {"words": 0, "tags": 1},
        {"words": dfeeder.integer_value_sequence(5000),
         "tags": dfeeder.integer_value_sequence(9)})
    return batches, feeder


def crf_taggers(torch, rnn):
    """Phase 21b: `linear_crf_tagger` and `rnn_crf_tagger` at their
    defaults (vocab 5000, 9 tags) and `rnn_crf_tagger` at emb 128 /
    hidden 256: one batch's loss and gradients on the card against the
    CPU (`held_grads`), CRF_STEPS adam steps through `SGD.train` (two B5
    and two B6 launches a step for the bidirectional LSTM), then
    crf_decoding of one batch from the trained parameters: the ids on
    the card equal the CPU's exactly. Returns each conf's numbers."""
    from paddle_tpu_torch.models import text
    from paddle_tpu_torch.network import Network

    out = {}
    for name, fn, kw in CRF_CONFS:
        conf = getattr(text, fn)(**kw)
        net = Network(conf)
        batches, feeder = crf_data(SEED + 310, CRF_STEPS + 1)
        p0 = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cpu")
        held = held_grads(torch, f"crf {name}", conf, p0,
                          feeder(batches[-1]))
        runs = sgd_arms(torch, rnn, f"crf {name}", conf,
                        {k: v.to("cuda") for k, v in p0.items()},
                        batches[:CRF_STEPS], feeder, CRF_LR, (("k1", 1),))
        r, trained = runs["k1"]
        n_lstm = 2 * 2 * CRF_STEPS if fn == "rnn_crf_tagger" else 0
        got = r["launch_counts"]
        assert got.get("lstm_fwd_launches", 0) == n_lstm and got.get(
            "lstm_bwd_launches", 0) == n_lstm, (name, got)
        params = {k[len("param/"):]: v for k, v in trained.items()
                  if k.startswith("param/")}
        feed = feeder(batches[-1])
        decoded = {}
        for device in ("cuda", "cpu"):
            with torch.no_grad():
                o, _ = net.forward(
                    {k: v.to(device) for k, v in params.items()},
                    {k: a.to(device) for k, a in feed.items()},
                    outputs=["decoded"])
            decoded[device] = o["decoded"].ids.cpu()
        lens = feed["words"].seq_lens
        same = torch.equal(decoded["cuda"], decoded["cpu"])
        r = {"held": held, "ms_per_step": r["ms_per_step"],
             "loss_first": r["loss_first"], "loss_last": r["loss_last"],
             "launches": got, "decoded_equal": same,
             "decoded_tokens": int(lens.sum())}
        print(f"crf {name} " + json.dumps(r), flush=True)
        assert same, f"{name}: the card's decoded ids differ from the CPU's"
        out[name] = r
        torch.cuda.empty_cache()
    return out


def alexnet_steps(torch, op):
    """Phase 21c: AlexNet at bench.py's alexnet_bs64 setting through
    `SGD.train` (`resnet_train`: one fixed batch, ALEX_STEPS steps), in
    f32 and under the bf16 flag; and its `norm` layer on the card's conv1
    activation against the same layer on the CPU (within TOL of the
    largest entry). Returns the numbers."""
    from paddle_tpu_torch.core.arg import Arg
    from paddle_tpu_torch.layers.base import Ctx
    from paddle_tpu_torch.models.image import alexnet
    from paddle_tpu_torch.network import Network

    conf = alexnet()
    out = {}
    for amp in (False, True):
        name = f"alexnet_b{ALEX_B}" + ("_amp" if amp else "")
        out[name] = resnet_train(torch, op, conf, ALEX_B, ALEX_STEPS, name,
                                 amp=amp)
    net = Network(conf)
    norm = next(lc for lc in conf.layers if lc.type == "norm")
    (conv1,) = norm.input_names()
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cuda")
    with torch.no_grad():
        o, _ = net.forward(params, image_feed(8, SEED + 320),
                           outputs=[norm.name])
        cpu = net.layers[norm.name].forward(
            {}, [Arg(value=o[conv1].value.cpu())], Ctx())
    err = rel_err(o[norm.name].value.cpu(), cpu.value)[0]
    r = {"norm_layer": norm.name, "input": conv1,
         "shape": list(o[norm.name].value.shape), "rel_err": err}
    print("alexnet norm card vs cpu " + json.dumps(r), flush=True)
    assert err <= TOL, r
    out["norm"] = r
    torch.cuda.empty_cache()
    return out


# 21d: every new layer type and level, one small conf each: (inputs,
# build(dsl, *refs) making "out"); inputs as in `layer_feeds`
LAYER_D = 6


def _window_conf(dsl, x):
    ref = dsl._add("slice", [x], name="out", begin=2)
    dsl.current().conf.layer("out").attrs["size"] = 5
    return ref


def _norm_conf(dsl, img):
    ref = dsl._add("norm", [img], name="out")
    dsl.current().conf.layer("out").attrs.update(size=5, scale=0.3)
    return ref


LAYER_CASES = {
    **{f"seqpool_stride3_{p}": (("x",), lambda d, x, p=p: d.seq_pool(
        x, p, stride=3, name="out")) for p in ("sum", "average", "max")},
    **{f"seqpool_subseq_{p}": (("n",), lambda d, n, p=p: d.seq_pool(
        n, p, level="subseq", name="out"))
       for p in ("sum", "average", "sqrt_average", "max", "last", "first")},
    "seqpool_subseq_plain": (("x",), lambda d, x: d.seq_pool(
        x, "max", level="subseq", name="out")),
    "seqpool_max_index": (("x",), lambda d, x: d.seq_pool(
        x, "max", output_max_index=True, name="out")),
    "last_seq_stride3": (("x",), lambda d, x: d.last_seq(x, stride=3,
                                                         name="out")),
    "first_seq_stride3": (("x",), lambda d, x: d.first_seq(x, stride=3,
                                                           name="out")),
    "last_seq_subseq": (("n",), lambda d, n: d.last_seq(n, level="subseq",
                                                        name="out")),
    "first_seq_subseq": (("n",), lambda d, n: d.first_seq(
        n, level="subseq", name="out")),
    "expand_nested": (("v", "n"), lambda d, v, n: d.expand(
        v, n, level="seq", name="out")),
    "seqconcat": (("x", "y"), lambda d, x, y: d.seq_concat(x, y,
                                                           name="out")),
    "seqreshape": (("x",), lambda d, x: d._add("seqreshape", [x],
                                               name="out", size=3)),
    "seqreverse": (("x",), lambda d, x: d.seq_reverse(x, name="out")),
    "slice": (("x",), _window_conf),
    "padding": (("img",), lambda d, i: d._add(
        "padding", [i], name="out", pad_c=(1, 2), pad_h=(0, 1),
        pad_w=(2, 0))),
    "crop": (("img",), lambda d, i: d._add("crop", [i], name="out",
                                           crop_h=(1, 3), crop_w=(2, 4))),
    "rotate": (("flat",), lambda d, f: d._add("rotate", [f], name="out",
                                              height=3, width=4)),
    "subseq": (("x", "off", "size"), lambda d, x, o, s: d.sub_seq(
        x, o, s, name="out")),
    "sub_nested_seq": (("n", "sel"), lambda d, n, s: d.sub_nested_seq(
        n, s, name="out")),
    "ctc": (("x", "lab"), lambda d, x, lab: d._add(
        "warp_ctc", [x, lab], name="out", bias=False, blank=0,
        norm_by_times=True)),
    "crf": (("x", "tags"), lambda d, x, t: d.crf(x, t, num_tags=LAYER_D,
                                                 name="out")),
    "crf_decoding": (("x",), lambda d, x: d.crf_decoding(
        x, num_tags=LAYER_D, name="out")),
    "norm": (("img",), _norm_conf),
    "row_l2_norm": (("x",), lambda d, x: d._add("row_l2_norm", [x],
                                                name="out")),
}


def layer_feeds(seed):
    """{name: Arg} on the CPU: sequences with an empty row and one at
    the full length, a nested sequence with an empty sentence mid-row and
    an all-zero last column, images, ids."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq, seq, sub_seq

    rng = np.random.default_rng(seed)
    b, t, d = 8, 40, LAYER_D
    lens = rng.integers(0, t + 1, b).astype(np.int32)
    lens[:2] = (0, t)
    sub = rng.integers(0, 9, (b, 5)).astype(np.int32)
    sub[:, -1] = 0
    sub[0, 2] = 0
    n_sub = (sub > 0).sum(axis=1).astype(np.int32)
    flat = sub.sum(axis=1)

    def values(shape, lengths):
        v = rng.standard_normal(shape).astype(np.float32)
        return v * (np.arange(shape[1])[None, :, None]
                    < lengths[:, None, None])

    lab = [rng.integers(1, d, n // 3).tolist() for n in lens]
    lab_lens = np.asarray([len(x) for x in lab], np.int32)
    lab_ids = np.zeros((b, t), np.int32)
    for i, x in enumerate(lab):
        lab_ids[i, :len(x)] = x
    return {
        "x": seq(values((b, t, d), lens), lens),
        "y": seq(values((b, 9, d), lens % 9), lens % 9),
        "n": sub_seq(values((b, int(flat.max()), d), flat), sub),
        "v": seq(values((b, 5, d), n_sub), n_sub),
        "img": non_seq(rng.standard_normal((b, 9, 7, d)).astype(
            np.float32)),
        "flat": non_seq(rng.standard_normal((b, 24)).astype(np.float32)),
        "off": id_arg(rng.integers(0, t, b).astype(np.int32)),
        "size": id_arg(rng.integers(0, t, b).astype(np.int32)),
        "sel": id_arg(rng.integers(-1, 5, (b, 3)).astype(np.int32),
                      rng.integers(0, 4, b).astype(np.int32)),
        "lab": id_arg(lab_ids, lab_lens),
        "tags": id_arg(rng.integers(0, d, (b, t)).astype(np.int32), lens),
    }


def new_layers(torch):
    """Phase 21d: each of LAYER_CASES on the card against the same conf on
    the CPU from one seeded input: the output within TOL of its largest
    entry (ids and lengths exactly), and the gradient of a seeded
    projection of it in every float input and parameter within TOL."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.network import Network

    feeds = layer_feeds(SEED + 330)
    worst = {}
    for case, (names, build) in LAYER_CASES.items():
        with dsl.model() as g:
            refs = []
            for n in names:
                a = feeds[n]
                dim = (1 if a.ids is not None
                       else tuple(a.value.shape[2 if a.is_seq else 1:]))
                refs.append(dsl.data(n, dim, is_seq=a.is_seq,
                                     is_ids=a.ids is not None,
                                     has_subseq=a.has_subseq))
            build(dsl, *refs)
        net = Network(g.conf)
        p0 = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cpu")
        got = {}
        for device in ("cuda", "cpu"):
            p = {k: v.to(device).requires_grad_(True) for k, v in p0.items()}
            feed = {n: feeds[n].to(device) for n in names}
            xs = {n: a.value.clone().requires_grad_(True)
                  for n, a in feed.items() if a.value is not None}
            feed = {n: a.with_value(xs[n]) if n in xs else a
                    for n, a in feed.items()}
            o = net.forward(p, feed, outputs=["out"])[0]["out"]
            grads = {}
            if o.value is not None and o.value.requires_grad:
                r = torch.randn(o.value.shape, generator=torch.Generator(
                    ).manual_seed(SEED), dtype=o.value.dtype)
                (o.value * r.to(device)).sum().backward()
                grads = {k: v.grad for k, v in {**xs, **p}.items()
                         if v.grad is not None}
            got[device] = (o, grads)
        (oc, gc), (o32, g32) = got["cuda"], got["cpu"]
        for f in ("ids", "seq_lens", "subseq_lens"):
            a, b = getattr(oc, f), getattr(o32, f)
            assert (a is None) == (b is None) and (
                a is None or torch.equal(a.cpu(), b)), f"{case}: {f}"
        errs = [0.0]
        if oc.value is not None:
            # max pooling's -1e30 fill of an empty (sub-)sequence must
            # match exactly, and stays out of the scale of the rest
            got, ref = oc.value.detach().cpu(), o32.value.detach()
            fill = ref.abs() >= 1e29
            assert torch.equal(got[fill], ref[fill]), case
            errs.append(rel_err(got[~fill], ref[~fill])[0]
                        if (~fill).any() else 0.0)
        assert sorted(gc) == sorted(g32), case
        errs += [rel_err(gc[k].cpu(), g32[k])[0] for k in gc]
        worst[case] = max(errs)
        assert worst[case] <= TOL, f"{case}: card vs cpu {worst[case]:.3g}"
    print("new layers card vs cpu " + json.dumps(worst), flush=True)
    return worst


def nested_and_structured(torch, rnn, op):
    """Phase 21: (a) nested sequences, (b) the CRF taggers, (c) AlexNet,
    (d) every new layer type on the card."""
    phase("21a. the document classifiers over nested sequences through "
          "SGD and DataFeeder, eager and as a CUDA graph")
    docs = nested_docs(torch, rnn)
    phase("21b. the CRF taggers through SGD, then crf_decoding")
    crf = crf_taggers(torch, rnn)
    phase("21c. AlexNet at bench.py's alexnet_bs64 setting, f32 and under "
          "the bf16 flag")
    alex = alexnet_steps(torch, op)
    phase("21d. every new layer type and level, card against CPU")
    layers = new_layers(torch)
    return {"docs": docs, "crf": crf, "alexnet": alex, "layers": layers}


# ---- phase 22: beam and speculative decode over the paged KV pool --------

# 22(a): four prompts, the short one first, so that page 0 (its first beam
# row's first page) holds generated tokens; BEAM_K beams, BEAM_MAX_NEW
# tokens. The pool: 16 rows at the 1024 bucket (64 pages each) and their
# growth, and FOREIGN pages (0..3, where the page table's padded slots
# point) that another request holds
BEAM_LENS = (9, 960, 500, 64)
BEAM_K, BEAM_MAX_NEW = 4, 32
BEAM_PAGES, FOREIGN = 1280, 4
SENTINEL = 12345.0
# 22(b): the draft LM (its own seed and pool) and the proposal length; a
# speculative pool holds 4 rows at the 1024 bucket and their growth
DRAFT_LM = dict(vocab=2048, d_model=128, num_heads=2, num_layers=1,
                attn_impl="flash")
PROPOSE_K, SPEC_PAGES = 4, 300
# 22(c): the NMT's draft with other parameters: each weight moved by
# DRAFT_NOISE of its own standard deviation
DRAFT_NOISE = 0.3


def beam_prompts(spec):
    rng = np.random.default_rng(SEED + 230)
    lens = np.asarray(BEAM_LENS, np.int32)
    ids = np.zeros((len(lens), int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, spec.vocab, n)
    return ids, lens


def beam_reference(torch, lm, spec, params, ids, lens):
    """The port's full-recompute beam, dense attention in plain torch on
    the card, with each step's margins: per group, the smallest gap
    between consecutive candidates among its top K + 1 (the serving
    rule's margin, as MarginRecorder's). Returns (tokens, scores,
    margins [steps, B])."""
    margins = []
    init, step = lm.beam_init_select, lm.beam_step_select

    def gap(cand, k):
        top = torch.topk(cand.reshape(cand.shape[0], -1), k + 1).values
        margins.append((top[:, :-1] - top[:, 1:]).min(1).values.cpu()
                       .numpy())

    def rec_init(logp0, k):
        gap(logp0, k)
        return init(logp0, k)

    def rec_step(scores, logp, finished, eos_id):
        eos = torch.arange(logp.shape[-1], device=logp.device) == eos_id
        fin = torch.where(eos, scores[..., None],
                          torch.full_like(logp, -1e30))
        gap(torch.where(finished[..., None], fin, scores[..., None] + logp),
            scores.shape[1])
        return step(scores, logp, finished, eos_id)

    lm.beam_init_select, lm.beam_step_select = rec_init, rec_step
    try:
        toks, scores = lm.beam_decode_recompute(
            dataclasses.replace(spec, attn_impl="dense"), params, ids, lens,
            BEAM_K, BEAM_MAX_NEW, EOS)
    finally:
        lm.beam_init_select, lm.beam_step_select = init, step
    return toks, scores, np.stack(margins)


def beam_groups_held(got, ref, margins):
    """Each group's beams as a set equal to the reference's (tokens
    exact, each beam's score within 1e-4 of |score| + 1e-4), unless the
    reference's margin at some step up to the first step whose set of
    prefixes differs is below GEN_MARGIN. Returns (groups equal, groups
    excused)."""
    (gt, gs), (rt, rs) = got, ref
    equal = excused = 0
    for g in range(rt.shape[0]):
        a = {tuple(int(x) for x in gt[g, j]): float(gs[g, j])
             for j in range(gt.shape[1])}
        b = {tuple(int(x) for x in rt[g, j]): float(rs[g, j])
             for j in range(rt.shape[1])}
        if set(a) == set(b):
            for toks, sc in b.items():
                assert abs(a[toks] - sc) <= 1e-4 * (1 + abs(sc)), (
                    f"group {g}: score {a[toks]} vs {sc}")
            equal += 1
            continue
        t = next(t for t in range(rt.shape[2])
                 if sorted(x[:t + 1] for x in a)
                 != sorted(x[:t + 1] for x in b))
        low = float(margins[:t + 1, g].min())
        assert low < GEN_MARGIN, (
            f"group {g}: beams differ at step {t} with the reference's "
            f"smallest margin {low:.3g} >= {GEN_MARGIN}")
        excused += 1
    return equal, excused


def paged_beam(torch, fa):
    """Phase 22(a): `PagedLM.beam_generate` at the served LM's width over
    a pool of BEAM_PAGES 16-token pages (64 a sequence), prompts
    BEAM_LENS, K = BEAM_K, BEAM_MAX_NEW tokens. The pages no row owns
    (FOREIGN, held by another request, and every page the free list
    never hands out) hold SENTINEL before and after the decode. One
    prefill of the B rows through B4f (a launch a layer). Held against
    the port's dense full recompute on the card (`beam_groups_held`); a
    second decode, timed, equal to the first. Prints ms, tokens/s, the
    chain depth, the dispatch/device split, the B4f launches and the
    parent copy's bytes a step. Returns (numbers, spec, params, prompts)."""
    from paddle_tpu_torch.decoding.kv_cache import PagedKVCache, PagedLM
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(**SERVED_LM)
    params = params_from_numpy(random_params(spec, lm), device="cuda")
    ids, lens = beam_prompts(spec)
    cache = PagedKVCache(spec, num_pages=BEAM_PAGES, page_size=16,
                         max_pages_per_seq=64, device="cuda")
    foreign = cache.alloc(FOREIGN)
    assert foreign == list(range(FOREIGN)), foreign
    handed = set()
    alloc = cache.alloc

    def recording_alloc(n):
        got = alloc(n)
        handed.update(got)
        return got

    cache.alloc = recording_alloc
    pool_k, pool_v = cache.ensure_pool()
    pool_k.fill_(SENTINEL)
    pool_v.fill_(SENTINEL)
    plm = PagedLM(spec, params, cache, eos_id=EOS)
    torch.cuda.synchronize()
    fa.launches = 0
    got = plm.beam_generate(ids, lens, BEAM_K, BEAM_MAX_NEW)
    torch.cuda.synchronize()
    launches = fa.launches
    unowned = [p for p in range(cache.num_pages) if p not in handed]
    assert set(foreign) <= set(unowned)
    untouched = all(bool((pool[:, unowned] == SENTINEL).all().item())
                    for pool in (pool_k, pool_v))
    assert untouched, "the beam decode wrote a page no row owns"
    assert launches == spec.num_layers, (
        f"B4f launched {launches} times, want one prefill of "
        f"{spec.num_layers} layers")
    copy_per_step = plm.last_copy_bytes / (BEAM_MAX_NEW - 1)
    t0 = time.perf_counter()
    again = plm.beam_generate(ids, lens, BEAM_K, BEAM_MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(np.array_equal(a, b) for a, b in zip(again, got)), (
        "the beam decode differs run to run")
    ref_t, ref_s, margins = beam_reference(torch, lm, spec, params, ids,
                                           lens)
    equal, excused = beam_groups_held(got, (ref_t, ref_s), margins)
    b = len(lens)
    r = {"prompt_lens": list(BEAM_LENS), "beam": BEAM_K,
         "max_new": BEAM_MAX_NEW, "ms": wall * 1e3,
         "tokens_per_s": b * BEAM_MAX_NEW / wall,
         "beam_tokens_per_s": b * BEAM_K * BEAM_MAX_NEW / wall,
         "chain_depth": plm.last_chain_depth, **plm.last_timeline,
         "b4f_launches": launches, "copy_bytes_per_step": copy_per_step,
         "copy_bytes": plm.last_copy_bytes,
         "pages_never_handed_out": len(unowned),
         "sentinel_pages_untouched": untouched,
         "groups_equal": equal, "groups_excused_by_margin": excused,
         "reference_min_margin": float(margins.min()),
         "prefilled_tokens": cache.prefilled_tokens,
         "appended_tokens": cache.appended_tokens,
         "cached_prefix_tokens": cache.cached_prefix_tokens}
    print("paged beam " + json.dumps(r), flush=True)
    assert plm.last_chain_depth == BEAM_MAX_NEW, r
    assert cache.free_page_count() == cache.num_pages - FOREIGN, r
    return r, spec, params, (ids, lens)


def greedy_held(torch, lm, spec, params, ids, lens, got, ref, name):
    """Each row's tokens of `got` equal the target's greedy paged output
    `ref`, unless the dense reference's top-2 log-prob margin at the
    first differing step is below GEN_MARGIN (phase 4's rule); the
    scores of equal rows within 1e-4 of |score| + 1e-4. Returns (rows
    equal, rows excused)."""
    equal = excused = 0
    dense = dataclasses.replace(spec, attn_impl="dense")
    for i in range(len(lens)):
        a, b = got[0][i].tolist(), ref[0][i].tolist()
        if a == b:
            assert abs(got[1][i] - ref[1][i]) <= 1e-4 * (
                1 + abs(ref[1][i])), (name, i, got[1][i], ref[1][i])
            equal += 1
            continue
        t = next(j for j in range(len(b)) if a[j] != b[j])
        seq = np.concatenate([ids[i, :lens[i]], np.asarray(b[:t], np.int32)])
        with torch.no_grad():
            logits = lm.lm_forward(dense, params,
                                   torch.as_tensor(seq[None], device="cuda"))
        top2 = torch.topk(lm.lm_logp(logits[0, -1]), 2).values
        margin = (top2[0] - top2[1]).item()
        assert margin < GEN_MARGIN, (
            f"{name}: row {i} differs at step {t}, reference margin "
            f"{margin:.3g}")
        excused += 1
    return equal, excused


def speculative_lm(torch, fa, spec, params, prompts):
    """Phase 22(b): `SpeculativePagedLM` with (a)'s target (its own pool of
    SPEC_PAGES pages) over (a)'s prompts, PROPOSE_K, BEAM_MAX_NEW tokens,
    against the target's `PagedLM.generate` (`greedy_held`): the target
    as its own draft (accept rate 1.0, a chain shorter than
    BEAM_MAX_NEW) and a DRAFT_LM draft (its own seed and pool). Each
    run's prefills go through B4f (a launch a layer of each net). Prints
    the accept rate, chain depth, ms and tokens/s of each."""
    from paddle_tpu_torch.decoding.kv_cache import PagedKVCache, PagedLM, \
        SpeculativePagedLM
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.weights import params_from_numpy

    ids, lens = prompts

    def plm(s, p):
        return PagedLM(s, p, PagedKVCache(s, num_pages=SPEC_PAGES,
                                          page_size=16, max_pages_per_seq=64,
                                          device="cuda"), eos_id=EOS)

    ref = plm(spec, params).generate(ids, lens, BEAM_MAX_NEW)
    dspec = lm.LMSpec(**DRAFT_LM)
    drafts = {"self_draft": (spec, params),
              "draft": (dspec, params_from_numpy(
                  random_params(dspec, lm, SEED + 22), device="cuda"))}
    out = {}
    for name, (ds, dp) in drafts.items():
        sp = SpeculativePagedLM(plm(spec, params), plm(ds, dp),
                                propose_k=PROPOSE_K)
        torch.cuda.synchronize()
        fa.launches = 0
        t0 = time.perf_counter()
        got = sp.generate(ids, lens, BEAM_MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.launches
        equal, excused = greedy_held(torch, lm, spec, params, ids, lens,
                                     got, ref, name)
        r = {"propose_k": PROPOSE_K, "accept_rate": sp.last_accept_rate,
             "chain_depth": sp.last_chain_depth, "ms": wall * 1e3,
             "tokens_per_s": len(lens) * BEAM_MAX_NEW / wall,
             "b4f_launches": launches,
             "rows_equal": equal, "rows_excused_by_margin": excused}
        print(f"speculative paged {name} " + json.dumps(r), flush=True)
        assert launches == spec.num_layers + ds.num_layers, r
        if name == "self_draft":
            assert sp.last_accept_rate == 1.0, r
            assert sp.last_chain_depth < BEAM_MAX_NEW, r
        for p in (sp.target, sp.draft):
            assert p.cache.free_page_count() == p.cache.num_pages
        out[name] = r
    return out


def speculative_nmt(torch, rnn, gen):
    """Phase 22(c): `SpeculativeGreedyDecoder` over the attention NMT at
    bench_beam_decode's widths (B=32, t_src 32, max_len 32) from 20(a)'s
    trained parameters: the target a beam-1 decoder (CUDA graphs at
    K = 1), the drafts the target's net with the same parameters and
    with each weight moved by DRAFT_NOISE of its standard deviation
    (seeded), both on the target's encoding. Each: seqs and lens equal
    to the target's generate() by the margin rule (exact where no near
    tie), scores within 1e-5 of |score|; accept rate, chain depth,
    steps, ms and tokens/s. Then `GenerationModel(target, params,
    encode, speculative=..., draft_params=...)` over TCP with 20(c)'s
    traffic (`serve_generation`): answers on path "spec" and one hook
    request on the host rung, each equal to a lone call. Returns the
    numbers and the encoder's B7 launches."""
    from paddle_tpu_torch.decoding import SpeculativeGreedyDecoder

    params, encode, decoder = gen["params"], gen["encode"], gen["decoder"]
    rng = np.random.default_rng(SEED + 240)
    src = rng.integers(2, NMT["src_vocab"], (GEN_B, GEN_T_SRC)).astype(
        np.int32)
    lens = np.full(GEN_B, GEN_T_SRC, np.int32)
    zero_rnn_counts(rnn)
    statics, boots = encode(src, lens)
    torch.cuda.synchronize()
    enc = gru_counts(rnn)
    target = decoder(1, beam=1)
    ref = tuple(x.cpu().numpy() for x in target.generate(params, statics,
                                                         boots))
    gen_rng = torch.Generator(device="cuda").manual_seed(SEED + 241)
    other = {k: v + DRAFT_NOISE * v.std() * torch.randn(
        v.shape, generator=gen_rng, device="cuda") if v.numel() > 1
        else v for k, v in params.items()}
    rec = MarginRecorder(EOS)

    def margins(_i):
        if not rec.margins:
            from paddle_tpu_torch.serving.host_decode import host_generate

            host_generate(decoder(1, beam=1), params, statics, boots,
                          hooks=rec.hooks())
        return [m[_i] for m in rec.margins]

    out, specs = {}, {}
    for name, dp in (("self_draft", params), ("draft", other)):
        sp = SpeculativeGreedyDecoder(target, decoder(1, beam=1),
                                      propose_k=PROPOSE_K)
        t0 = time.perf_counter()
        got = sp.generate(params, dp, statics=statics, boots=boots,
                          draft_statics=statics, draft_boots=boots)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        equal, excused = margin_rule(f"speculative nmt {name}", got[:2],
                                     ref[:2], margins)
        same = [i for i in range(GEN_B)
                if best_tokens(*got[:2], i) == best_tokens(*ref[:2], i)]
        score_err = max(abs(float(got[2][i, 0]) - float(ref[2][i, 0]))
                        / max(1.0, abs(float(ref[2][i, 0]))) for i in same)
        r = {"propose_k": PROPOSE_K, "accept_rate": sp.last_accept_rate,
             "chain_depth": sp.last_chain_depth, "steps": sp.last_steps,
             "ms": wall * 1e3, "tokens_per_s": GEN_B * GEN_MAX_LEN / wall,
             "rows_equal": equal, "rows_excused_by_margin": excused,
             "score_max_rel_err": score_err}
        print(f"speculative nmt {name} " + json.dumps(r), flush=True)
        assert score_err <= 1e-5, r
        if name == "self_draft":
            assert sp.last_accept_rate == 1.0, r
        out[name], specs[name] = r, sp
    served = serve_generation(torch, rnn, params, gen,
                              speculative=specs["draft"], draft_params=other)
    out["serve"] = served
    return out, {k: enc[k] + served["launches"][k] for k in enc}


def api_imdb(torch, rnn):
    """Phase 22(d): the top-level API: `paddle_tpu_torch.init(...)`, then
    `paddle.dataset.imdb.train(word_dict)` through
    `paddle.reader.batched` (64 a batch), `DataFeeder` and `paddle.SGD`
    on the classifier at bench_lstm's settings (CLS, adam 2e-3), two
    passes on the card: every loss finite, B5 and B6 twice a step on the
    cluster route. Returns the numbers."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.data import feeder as dfeeder
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.trainer.events import EndIteration

    old = flags.get_flag("log_period")
    paddle.init(log_period=1000)
    try:
        word_dict = paddle.dataset.imdb.word_dict()
        reader = paddle.reader.batched(paddle.dataset.imdb.train(word_dict),
                                       CLS_B, drop_last=False)
        feeder = dfeeder.DataFeeder(
            {"words": 0, "label": 1},
            {"words": dfeeder.integer_value_sequence(CLS["vocab_size"]),
             "label": dfeeder.integer_value(2)}, buckets=(32, 64))
        sgd = paddle.SGD(stacked_lstm_classifier(**CLS),
                         OptimizationConf(learning_method="adam",
                                          learning_rate=CLS_LR),
                         seed=SEED + 1, device="cuda")
        costs = []
        zero_rnn_counts(rnn)
        t0 = time.perf_counter()
        sgd.train(reader=reader, feeder=feeder, num_passes=2,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, EndIteration) else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        flags.set_flag("log_period", old)
    counts = {k: v for k, v in rnn_counts(rnn).items() if v}
    r = {"words": len(word_dict), "steps": len(costs), "wall_s": wall,
         "loss_first": costs[0], "loss_last": costs[-1],
         "launches": counts}
    print("api imdb " + json.dumps(r), flush=True)
    assert np.isfinite(costs).all() and len(costs) == 8, r
    n = 2 * len(costs)
    assert counts == dict.fromkeys(
        ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
         "lstm_bwd_launches", "lstm_bwd_cluster_launches"), n), r
    return r


def paged_and_speculative(torch, fa, rnn, gen):
    """Phase 22: (a) paged beam, (b) the speculative paged LM, (c) the
    speculative NMT and its serving, (d) the top-level API."""
    phase("22a. paged beam search at the served LM's width")
    beam, spec, params, prompts = paged_beam(torch, fa)
    phase("22b. SpeculativePagedLM with (a)'s target")
    spec_lm = speculative_lm(torch, fa, spec, params, prompts)
    del params
    torch.cuda.empty_cache()
    phase("22c. SpeculativeGreedyDecoder on the NMT and its serving rung")
    spec_nmt, nmt_launches = speculative_nmt(torch, rnn, gen)
    phase("22d. the top-level API: dataset.imdb through reader, DataFeeder "
          "and SGD")
    api = api_imdb(torch, rnn)
    b4f = (beam["b4f_launches"]
           + sum(r["b4f_launches"] for r in spec_lm.values()))
    return {"beam": beam, "spec_lm": spec_lm, "spec_nmt": spec_nmt,
            "api": api, "b4f_launches": b4f, "gru_launches": nmt_launches}


# ---- phase 23: the layer tail, the VAE and GAN, the v1 front end --------

# 23(d): a quick_start-style v1 LSTM text classifier at bench_lstm's
# widths (vocab 30000, emb 128, lstm h 256, B 64, lengths 10-100), as a
# user's unmodified v1 config file and its @provider module; the
# provider draws each label's words from its own half of the vocabulary
V1_LSTM_CONFIG = """\
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 30000)
hidden = get_config_arg("hidden", int, 256)
define_py_data_sources2(train_list="train.list", test_list="test.list",
                        module="imdb_like_provider", obj="process",
                        args={"vocab": vocab,
                              "n": get_config_arg("n", int, 512),
                              "seed": get_config_arg("seed", int, 0)})
settings(batch_size=get_config_arg("batch_size", int, 64),
         learning_rate=2e-3, learning_method=AdamOptimizer(),
         gradient_clipping_threshold=25)

word = data_layer(name="word", size=vocab)
emb = embedding_layer(input=word, size=get_config_arg("emb", int, 128))
lstm = simple_lstm(input=emb, size=hidden)
pooled = pooling_layer(input=lstm, pooling_type=MaxPooling())
output = fc_layer(input=pooled, size=2, act=SoftmaxActivation())
label = data_layer(name="label", size=2)
cost = classification_cost(input=output, label=label)
classification_error_evaluator(input=output, label=label, name="err")
outputs(cost)
"""
V1_LSTM_PROVIDER = """\
from paddle.trainer.PyDataProvider2 import *
import numpy as np


def hook(settings, vocab, n, seed, file_list, **_):
    settings.vocab, settings.n, settings.seed = vocab, n, seed
    settings.input_types = [integer_value_sequence(vocab), integer_value(2)]


@provider(init_hook=hook, should_shuffle=False)
def process(settings, filename):
    rng = np.random.default_rng([settings.seed, sum(map(ord, filename))])
    half = settings.vocab // 2
    for _ in range(settings.n):
        length = int(rng.integers(10, 101))
        lab = int(rng.integers(0, 2))
        ids = rng.integers(lab * half, (lab + 1) * half, length)
        yield ids.tolist(), lab
"""


def write_v1_config(work, **config_args):
    """The v1 config, its provider and its file lists in `work`; returns
    the config's path and its --config_args string."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "v1_lstm.py"), "w") as f:
        f.write(V1_LSTM_CONFIG)
    with open(os.path.join(work, "imdb_like_provider.py"), "w") as f:
        f.write(V1_LSTM_PROVIDER)
    for part in ("train", "test"):
        with open(os.path.join(work, f"{part}.list"), "w") as f:
            f.write(f"{part}-0\n")
    args = ",".join(f"{k}={v}" for k, v in sorted(config_args.items()))
    return os.path.join(work, "v1_lstm.py"), args


# 23(a): each new layer type at small widths (TAIL_B examples, TAIL_D
# features, ragged sequences up to TAIL_T), mdlstm also on a 28 x 28 grid
# at h = 32 (MD_GRID), card against the port on the CPU in f32 and f64
TAIL_B, TAIL_T, TAIL_D = 8, 12, 6
MD_GRID = (28, 28, 32)
# 23(b): vae_conf's defaults, B = 128, adam 1e-3: 20 steps eagerly, then
# 20 as graphs of VAE_K (against two eager runs of all 40)
VAE_B, VAE_STEPS, VAE_K, VAE_LR = 128, 20, 10, 1e-3
# 23(c): gan_conf's defaults, B = 256 real and 256 fake, on a mixture of
# 8 Gaussians on a circle; momentum 1e-3 / 0.9 as gan_trainer.py;
# GAN_STEPS alternating D and G steps
GAN_B, GAN_STEPS, GAN_LR = 256, 200, 1e-3
# 23(e): SSD300's heads (Liu et al. 2016): 300 x 300 images, feature maps
# 38/19/10/5/3/1 with (min, max) sizes and aspect ratios of the
# reference's ssd300 config, 8 732 priors, 21 classes (VOC), nms_top_k
# 400, keep_top_k 200, B = 8, up to SSD_G ground-truth boxes an image
SSD_MAPS = ((38, 30, 60, (2.0,)), (19, 60, 111, (2.0, 3.0)),
            (10, 111, 162, (2.0, 3.0)), (5, 162, 213, (2.0, 3.0)),
            (3, 213, 264, (2.0,)), (1, 264, 315, (2.0,)))
SSD_B, SSD_C, SSD_G = 8, 21, 6
# priors a map: a min and a max box, two for each aspect ratio (flipped)
SSD_PRIORS = tuple(s * s * (2 + 2 * len(ars)) for s, _mn, _mx, ars in SSD_MAPS)


def tail_feeds(seed):
    """{name: Arg} on the CPU for 23(a): dense rows, ragged sequences (an
    empty row, one at TAIL_T), scores with ties, images, ids, ground
    truth."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq, seq

    rng = np.random.default_rng(seed)
    b, t, d = TAIL_B, TAIL_T, TAIL_D
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[:2] = (0, t)
    mask = np.arange(t)[None, :, None] < lens[:, None, None]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def uniform(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    lo = rng.uniform(0.0, 0.6, (b, 3, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (b, 3, 2))],
                         -1).astype(np.float32)
    box_lens = rng.integers(0, 4, b).astype(np.int32)
    return {
        "a": non_seq(normal(b, d)), "b": non_seq(normal(b, d)),
        "c": non_seq(normal(b, d)), "w1": non_seq(uniform(0.1, 0.9, b, 1)),
        "b18": non_seq(normal(b, 3 * d)),
        "pos": non_seq(uniform(0.5, 2.0, b, d)),
        "prob": non_seq(uniform(0.05, 0.95, b, d)),
        "soft": non_seq(uniform(0, 1, b, d)),
        "bin": non_seq(rng.integers(0, 2, (b, d)).astype(np.float32)),
        "sel": non_seq(rng.integers(0, 2, (b, 5)).astype(np.float32)),
        "s1": non_seq(normal(b, 1)), "s2": non_seq(normal(b, 1)),
        "t": non_seq(uniform(0, 1, b, 1)),
        "lab": id_arg(rng.integers(0, d, b)),
        "lab7": id_arg(rng.integers(0, 7, b)),
        "lab2": id_arg(rng.integers(0, 2, b)),
        "pick": id_arg(rng.integers(0, 3, b)),
        "x": seq(normal(b, t, d) * mask, lens),
        "tied": seq((rng.integers(-2, 3, (b, t, 1)) * 0.5).astype(
            np.float32) * mask, lens),
        "rel": seq(rng.integers(0, 4, (b, t, 1)).astype(np.float32) * mask,
                   lens),
        "tok": id_arg(rng.integers(0, 4, (b, t)), lens),
        "probs": seq(rng.dirichlet(np.ones(d), (b, t)).astype(np.float32),
                     lens),
        "img": non_seq(normal(b, 6, 5, 4)),
        "sq": non_seq(normal(b, 4, 4, 2)),
        "flt": non_seq(normal(b, 3 * 3 * 2 * 3)),
        "grid": non_seq(normal(b, 3, 4, 5 * 3)),
        "md": non_seq(0.5 * normal(2, MD_GRID[0], MD_GRID[1],
                                   5 * MD_GRID[2])),
        "x4": non_seq(normal(b, 12)), "h": non_seq(normal(b, 3)),
        "cst": non_seq(normal(b, 3)),
        "fmap": non_seq(normal(b, 3, 3, 2)),
        "image": non_seq(np.zeros((b, 12, 12, 1), np.float32)),
        "gt": seq(box, box_lens),
        "gt_lab": id_arg(rng.integers(1, 4, (b, 3)), box_lens),
        "loc": non_seq(0.5 * normal(b, 36 * 4)),
        "conf": non_seq(normal(b, 36 * 4)),
    }


def _tail_out(d, type_, inputs, size=0, act="", bias=False, **attrs):
    return d._add(type_, inputs, name="out", size=size, act=act, bias=bias,
                  **attrs)


def _tail_get_output(d, x4, h, c):
    ls = d._add("lstm_step", [x4, h, c], name="ls", size=3)
    ref = _tail_out(d, "get_output", [ls])
    d.current().conf.layer("out").inputs[0].attrs[
        "input_layer_argument"] = "state"
    return ref


def _tail_priorbox(d, fmap, image):
    return d.priorbox(fmap, image, min_size=[4.0], max_size=[8.0],
                      aspect_ratio=[2.0], name="pb")


TAIL_CASES = {
    "cos": (("a", "b"), lambda d, a, b: _tail_out(d, "cos", [a, b],
                                                  scale=2.0)),
    "cos_k3": (("a", "b18"), lambda d, a, b: _tail_out(d, "cos", [a, b],
                                                       size=3)),
    "interpolation": (("w1", "a", "b"), lambda d, w, a, b: _tail_out(
        d, "interpolation", [w, a, b])),
    "dot_mul": (("a", "b"), lambda d, a, b: _tail_out(d, "dot_mul", [a, b],
                                                      act="tanh")),
    "slope_intercept": (("a",), lambda d, a: _tail_out(
        d, "slope_intercept", [a], slope=-1.5, intercept=0.25)),
    "tensor": (("a", "b"), lambda d, a, b: _tail_out(
        d, "tensor", [a, b], size=4, act="tanh", bias=True)),
    **{t: (("a", "w1"), lambda d, a, w, t=t: _tail_out(d, t, [a, w]))
       for t in ("outer_prod", "out_prod")},
    "sum_to_one_norm": (("pos",), lambda d, a: _tail_out(
        d, "sum_to_one_norm", [a])),
    "trans": (("b18",), lambda d, a: _tail_out(d, "trans", [a], height=3,
                                               width=6)),
    "resize": (("img",), lambda d, a: _tail_out(d, "resize", [a], size=120)),
    "smooth_l1": (("a", "b"), lambda d, a, b: _tail_out(d, "smooth_l1",
                                                        [a, b])),
    "sum_cost": (("x",), lambda d, x: _tail_out(d, "sum_cost", [x])),
    **{t: (("prob", s), lambda d, p, y, t=t: _tail_out(d, t, [p, y]))
       for t, s in (("soft_binary_class_cross_entropy", "soft"),
                    ("multi_binary_label_cross_entropy", "bin"))},
    "rank-cost": (("s1", "s2", "t"), lambda d, a, b, t: _tail_out(
        d, "rank-cost", [a, b, t])),
    **{t: (("s1", "lab2"), lambda d, s, y, t=t: _tail_out(d, t, [s, y]))
       for t in ("huber", "huber-two-class", "huber_classification")},
    "lambda_cost": (("tied", "rel"), lambda d, s, r: _tail_out(
        d, "lambda_cost", [s, r], NDCG_num=3)),
    "softmax": (("a",), lambda d, a: _tail_out(d, "softmax", [a])),
    "multi_class_cross_entropy_with_selfnorm": (
        ("pos", "lab"), lambda d, p, y: _tail_out(
            d, "multi_class_cross_entropy_with_selfnorm", [p, y])),
    "selective_fc": (("a", "sel"), lambda d, a, s: _tail_out(
        d, "selective_fc", [a, s], size=5, act="softmax", bias=True)),
    "conv_shift": (("a",), lambda d, a: d.conv_shift(
        a, d.fc(a, size=3, name="filt"), name="out")),
    "bilinear_interp": (("img",), lambda d, i: _tail_out(
        d, "bilinear_interp", [i], out_size_x=7, out_size_y=4)),
    **{t: (("w1", "b18"), lambda d, w, x, t=t: _tail_out(
        d, t, [d.fc(w, size=3, name="wts"), x], size=TAIL_D))
       for t in ("convex_comb", "linear_comb")},
    "eos_id": (("tok",), lambda d, t: _tail_out(d, "eos_id", [t], eos_id=2)),
    "power": (("w1", "pos"), lambda d, w, x: _tail_out(d, "power", [w, x])),
    "clip": (("a",), lambda d, a: _tail_out(d, "clip", [a], min=-0.5,
                                            max=0.7)),
    "row_conv": (("x",), lambda d, x: _tail_out(d, "row_conv", [x],
                                                context_length=3)),
    "featmap_expand": (("a",), lambda d, a: _tail_out(
        d, "featmap_expand", [a], num_filters=3)),
    "prelu": (("img",), lambda d, a: _tail_out(d, "prelu", [a],
                                               partial_sum=30)),
    "gated_unit": (("a",), lambda d, a: _tail_out(
        d, "gated_unit", [a], size=4, act="tanh", bias=True)),
    "repeat": (("x",), lambda d, x: _tail_out(d, "repeat", [x],
                                              num_repeats=3)),
    "kmax_seq_score": (("tied",), lambda d, s: _tail_out(
        d, "kmax_seq_score", [s], beam_size=4)),
    "cos_vm": (("a", "b18"), lambda d, v, m: _tail_out(d, "cos_vm", [v, m],
                                                       size=3)),
    "data_norm": (("a",), lambda d, a: _tail_out(d, "data_norm", [a])),
    "print": (("c",), lambda d, a: _tail_out(d, "print", [a])),
    "get_output": (("x4", "h", "cst"), _tail_get_output),
    "eltmul": (("a", "b"), lambda d, a, b: _tail_out(d, "eltmul", [a, b],
                                                     scale=0.5)),
    "maxout": (("img",), lambda d, i: _tail_out(d, "maxout", [i], groups=2)),
    "spp": (("img",), lambda d, i: _tail_out(d, "spp", [i],
                                             pyramid_height=3)),
    **{t: (("img",), lambda d, i, t=t: _tail_out(
        d, t, [i], block=(2, 3), stride=(2, 1), padding=1))
       for t in ("blockexpand", "block_expand")},
    **{t: (("img",), lambda d, i, t=t, f=f, s=s, p=p: _tail_out(
        d, t, [i], size=3, bias=True, act="tanh", num_filters=3,
        filter_size=f, stride=s, padding=p))
       for t, f, s, p in (("exconvt", 3, 1, 0), ("conv_trans", 3, 2, 1),
                          ("cudnn_convt", 4, 3, 2))},
    "conv_operator": (("sq", "flt"), lambda d, i, f: _tail_out(
        d, "conv_operator", [i, f], num_filters=3, num_channels=2,
        filter_size=3, stride=2, padding=1)),
    "conv_operator_trans": (("sq", "flt"), lambda d, i, f: _tail_out(
        d, "conv_operator", [i, f], num_filters=3, num_channels=2,
        filter_size=3, stride=2, padding=1, trans=True)),
    **{f"{t}_{int(r)}{int(c)}": (("grid",), lambda d, g, t=t, r=r, c=c:
                                 _tail_out(d, t, [g], size=3, bias=True,
                                           act="tanh", directions=(r, c)))
       for t, r, c in (("mdlstm", True, True), ("mdlstm", False, True),
                       ("mdlstmemory", True, False),
                       ("mdlstmemory", False, False))},
    "mdlstm_28x28_h32": (("md",), lambda d, g: _tail_out(
        d, "mdlstm", [g], size=MD_GRID[2], bias=True, act="tanh")),
    "hsigmoid": (("a", "b", "lab7"), lambda d, a, b, y: _tail_out(
        d, "hsigmoid", [a, b, y], bias=True, num_classes=7)),
    "nce": (("a", "b", "lab7"), lambda d, a, b, y: _tail_out(
        d, "nce", [a, b, y], bias=True, num_classes=7, num_neg_samples=5)),
    **{t: (("a",), lambda d, a, t=t: _tail_out(d, t, [a]))
       for t in ("max_id", "maxid")},
    "sampling_id": (("probs",), lambda d, p: _tail_out(d, "sampling_id",
                                                       [p])),
    "multiplex": (("pick", "a", "b", "c"), lambda d, s, a, b, c: _tail_out(
        d, "multiplex", [s, a, b, c])),
    "priorbox": (("fmap", "image"), lambda d, f, i: _tail_out(
        d, "priorbox", [f, i], min_size=[4.0], max_size=[8.0],
        aspect_ratio=[2.0])),
    "multibox_loss": (("fmap", "image", "gt", "gt_lab", "loc", "conf"),
                      lambda d, f, i, g, gl, lo, co: _tail_out(
                          d, "multibox_loss",
                          [_tail_priorbox(d, f, i), g, gl, lo, co],
                          num_classes=4, overlap_threshold=0.3)),
    # random heads: a tie within an ulp orders by the device's rounding
    # (the CPU tests hold exact ties against the JAX layer)
    "detection_output": (("fmap", "image", "loc", "conf"),
                         lambda d, f, i, lo, co: _tail_out(
                             d, "detection_output",
                             [_tail_priorbox(d, f, i), lo, co],
                             num_classes=4, nms_threshold=0.3, nms_top_k=10,
                             keep_top_k=12)),
}


def tail_run(torch, net, p0, feed, names, device, dtype, seed):
    """The output Arg of `net` on `device` in `dtype`, and the gradients
    of sum(out * R) (R seeded) in every parameter and float input."""
    from paddle_tpu_torch.core import rng as trng

    p = {k: v.to(device=device, dtype=dtype, copy=True).requires_grad_(True)
         for k, v in p0.items()}
    feed = {n: feed[n].to(device) for n in names}
    xs = {n: a.value.to(dtype=dtype, copy=True).requires_grad_(True)
          for n, a in feed.items() if a.value is not None}
    feed = {n: a.with_value(xs[n]) if n in xs else a for n, a in feed.items()}
    key = trng.StepKey(torch.tensor(seed, device=device))
    o = net.forward(p, feed, outputs=["out"], rng=key)[0]["out"]
    grads = {}
    if o.value is not None and o.value.requires_grad:
        r = torch.randn(o.value.shape, generator=torch.Generator(
            ).manual_seed(seed), dtype=torch.float64).to(device, dtype)
        (o.value * r).sum().backward()
        grads = {k: v.grad for k, v in {**xs, **p}.items()
                 if v.grad is not None}
    return o, grads


def tail_layers(torch):
    """Phase 23(a): each of TAIL_CASES on the card against the same conf
    on the CPU from one seeded input (parameters drawn from a seed, no
    constant among them): the output and the gradients of a seeded
    projection of it in every float input and parameter within
    HELD_TOL of the largest entry plus twice the CPU's f32-vs-f64
    distance, non-finite entries (an spp bin wholly in padding) equal,
    ids and lengths exactly. Prints each case's forward ms on the card
    (the print layer's aside)."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.core import rng as trng
    from paddle_tpu_torch.network import Network

    feeds = tail_feeds(SEED + 230)
    worst, noises, ms, types = {}, {}, {}, set()
    for case, (names, build) in TAIL_CASES.items():
        with dsl.model() as g:
            refs = []
            for n in names:
                a = feeds[n]
                dim = (1 if a.ids is not None
                       else tuple(a.value.shape[2 if a.is_seq else 1:]))
                refs.append(dsl.data(n, dim, is_seq=a.is_seq,
                                     is_ids=a.ids is not None))
            build(dsl, *refs)
        types |= {lc.type for lc in g.conf.layers}
        net = Network(g.conf)
        gen = torch.Generator().manual_seed(SEED + 231)
        p0 = {k: 0.5 * torch.randn(pc.dims, generator=gen)
              for k, pc in sorted(net.param_confs.items())}
        (oc, gc), (o32, g32), (o64, g64) = (
            tail_run(torch, net, p0, feeds, names, dev, dt, SEED + 232)
            for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                            ("cpu", torch.float64)))
        for f in ("ids", "seq_lens", "subseq_lens"):
            a, b = getattr(oc, f), getattr(o32, f)
            assert (a is None) == (b is None) and (
                a is None or torch.equal(a.cpu(), b)), f"{case}: {f}"

        def held(got, ref, ref64, what):
            got, ref, ref64 = got.detach().cpu(), ref.detach(), ref64.detach()
            fin = torch.isfinite(ref)
            assert torch.equal(got[~fin], ref[~fin]), f"{case} {what}"
            if not fin.any():
                return 0.0, 0.0
            e = rel_err(got[fin], ref[fin])[0]
            noise = rel_err(ref[fin].double(), ref64[fin])[0]
            assert e <= HELD_TOL + 2 * noise, (
                f"{case} {what}: card vs cpu {e:.3g}, cpu f32 vs f64 "
                f"{noise:.3g}")
            return e, noise

        errs = [(0.0, 0.0)]
        if oc.value is not None:
            errs.append(held(oc.value, o32.value, o64.value, "out"))
        assert sorted(gc) == sorted(g32), case
        errs += [held(gc[k], g32[k], g64[k], k) for k in gc]
        worst[case] = max(e for e, _n in errs)
        noises[case] = max(n_ for _e, n_ in errs)
        if case != "print":
            feed = {n: feeds[n].to("cuda") for n in names}
            pc = {k: v.to("cuda") for k, v in p0.items()}
            key = trng.StepKey(torch.tensor(SEED, device="cuda"))
            with torch.no_grad():
                ms[case] = time_ms(torch, lambda: net.forward(
                    pc, feed, outputs=["out"], rng=key), reps=5, warmup=1)
    r = {"cases": len(TAIL_CASES), "types": len(types), "max_err": worst,
         "cpu_f32_vs_f64": noises, "forward_ms": ms}
    print("tail layers card vs cpu " + json.dumps(r), flush=True)
    return r


def vae_train(torch):
    """Phase 23(b): vae_conf at its defaults (x 784, hidden 256, latent 16)
    on VAE_B synthetic [0, 1] images a batch (eps from the seed), adam:
    two eager runs of 2 * VAE_STEPS steps, and a third run of VAE_STEPS
    eager steps, then VAE_STEPS as graphs of VAE_K (`TrainStep.multi`).
    The third run's params, slots and cost rows are held against the
    eager runs (`held_graph_vs_eager`: bit-equal where the two eager
    runs agree); both costs stay finite, and their sum falls. Returns
    the numbers."""
    from paddle_tpu_torch.core import rng as trng
    from paddle_tpu_torch.core.arg import non_seq
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models.vae import vae_conf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep, stack_feeds

    conf = vae_conf()
    net = Network(conf)
    opt = create_optimizer(OptimizationConf(learning_method="adam",
                                            learning_rate=VAE_LR),
                           net.param_confs)
    params = net.init_params(torch.Generator().manual_seed(SEED + 233),
                             device="cuda")
    rng = np.random.default_rng(SEED + 234)
    n = 2 * VAE_STEPS
    # a few fixed "digits" (smooth blobs) with noise, in [0, 1]
    protos = rng.uniform(0, 1, (10, 784)).astype(np.float32) ** 3
    feeds = []
    for _ in range(n):
        x = np.clip(protos[rng.integers(0, 10, VAE_B)]
                    + 0.1 * rng.standard_normal((VAE_B, 784)), 0, 1)
        feeds.append({
            "x": non_seq(x.astype(np.float32), device="cuda"),
            "eps": non_seq(rng.standard_normal((VAE_B, 16)).astype(
                np.float32), device="cuda")})
    root = trng.generator(SEED + 235, "cuda")
    arms = {}
    for arm in ("eager", "eager_again", "graph"):
        step = TrainStep(net, opt, watchdog=True, device="cuda")
        p = {k: v.clone() for k, v in params.items()}
        o = opt.init_state(p)
        costs, ms = [], []
        for c in range(n // VAE_K):
            chunk = feeds[c * VAE_K:(c + 1) * VAE_K]
            step0 = c * VAE_K
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if arm == "graph" and step0 >= VAE_STEPS:
                p, o, _s, h, outs = step.multi(p, o, {}, stack_feeds(chunk),
                                               step0, root)
                costs.append(torch.stack(
                    [outs["recon_cost"].value.detach().mean(1),
                     outs["kl_cost"].value.detach().mean(1), h[:, 0]], 1))
            else:
                rows = []
                for k, f in enumerate(chunk):
                    p, o, _s, h, outs = step(p, o, {}, f, step0 + k, None)
                    rows.append(torch.stack(
                        [outs["recon_cost"].value.detach().mean(),
                         outs["kl_cost"].value.detach().mean(), h[0]]))
                costs.append(torch.stack(rows))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / VAE_K * 1e3)
        arms[arm] = {"step": step, "ms": ms,
                     "held": {"costs": torch.cat(costs), **leaves(p, "param/"),
                              **leaves(o, "slot/")}}
    nondet = held_graph_vs_eager(torch, "vae", arms["eager"]["held"],
                                 arms["eager_again"]["held"],
                                 arms["graph"]["held"])
    costs = arms["graph"]["held"]["costs"].cpu().numpy()
    r = {"steps": n, "graphs_captured": arms["graph"]["step"].graphs_captured,
         "eager_ms_per_step": arms["eager"]["ms"],
         "graph_ms_per_step": arms["graph"]["ms"],
         "recon_first": float(costs[0, 0]), "recon_last": float(costs[-1, 0]),
         "kl_first": float(costs[0, 1]), "kl_last": float(costs[-1, 1]),
         "loss_first5": float(costs[:5, 2].mean()),
         "loss_last5": float(costs[-5:, 2].mean()),
         "eager_runs_differ": nondet}
    print("vae " + json.dumps(r), flush=True)
    assert np.isfinite(costs).all(), r
    assert r["loss_last5"] < r["loss_first5"], r
    assert r["graphs_captured"] == 1, r
    arms["graph"]["step"].graphs.release()
    return r


def gan_train(torch):
    """Phase 23(c): the GAN at gan_conf's defaults on GAN_B samples of an
    8-Gaussian ring: the first train_d and train_g on the card against
    the port on the CPU from the same numpy parameters (losses at rtol
    HELD_TOL, every parameter within HELD_TOL of its largest entry plus
    twice the CPU's f32-vs-f64 distance), then GAN_STEPS alternating
    steps on the card with finite losses. Returns the numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models.gan import GAN

    opt = OptimizationConf(learning_method="momentum", momentum=0.9,
                           learning_rate=GAN_LR)
    rng = np.random.default_rng(SEED + 236)

    def real(n):
        ang = rng.integers(0, 8, n) * (np.pi / 4)
        c = np.stack([np.cos(ang), np.sin(ang)], 1) * 2.0
        return (c + 0.05 * rng.standard_normal((n, 2))).astype(np.float32)

    def noise(n):
        return rng.standard_normal((n, 10)).astype(np.float32)

    start = {k: v.cpu().numpy() for k, v in GAN(
        opt, seed=SEED + 237, device="cpu").params.items()}
    r0, z0, z1 = real(GAN_B), noise(GAN_B), noise(GAN_B)
    arms = {}
    for arm, dev, dt in (("card", "cuda", np.float32),
                         ("cpu", "cpu", np.float32),
                         ("cpu64", "cpu", np.float64)):
        gan = GAN(opt, params={k: v.astype(dt) for k, v in start.items()},
                  device=dev)
        d = gan.train_d(r0, z0, 0)
        g = gan.train_g(z1, 0)
        arms[arm] = (gan, d, g, {k: v.detach().cpu().double()
                                 for k, v in gan.params.items()})
    gan, dl, gl, pc = arms["card"]
    _, dl32, gl32, p32 = arms["cpu"]
    p64 = arms["cpu64"][3]
    errs = {k: (rel_err(pc[k], p32[k])[0], rel_err(p32[k], p64[k])[0])
            for k in pc}
    outside = [k for k, (e, noise_) in errs.items()
               if not e <= HELD_TOL + 2 * noise_]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, GAN_STEPS + 1):
        losses.append((gan.train_d(real(GAN_B), noise(GAN_B), i),
                       gan.train_g(noise(GAN_B), i)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = np.asarray(losses)
    fake = gan.sample(noise(1024)).cpu().numpy()
    r = {"d_loss_card": dl, "d_loss_cpu": dl32, "g_loss_card": gl,
         "g_loss_cpu": gl32, "param_rel_max": max(e for e, _ in errs.values()),
         "cpu_f32_vs_f64_max": max(n_ for _, n_ in errs.values()),
         "params_outside": outside, "steps": GAN_STEPS,
         "ms_per_step_pair": wall / GAN_STEPS * 1e3,
         "d_loss_last": float(losses[-1, 0]),
         "g_loss_last": float(losses[-1, 1]),
         "fake_radius_mean": float(np.linalg.norm(fake, axis=1).mean())}
    print("gan " + json.dumps(r), flush=True)
    assert abs(dl - dl32) <= HELD_TOL * abs(dl32), r
    assert abs(gl - gl32) <= HELD_TOL * abs(gl32), r
    assert not outside, r
    assert np.isfinite(losses).all() and np.isfinite(fake).all(), r
    return r


def v1_cli(torch, rnn, work):
    """Phase 23(d): the smoke's v1 LSTM config at bench_lstm's widths
    through the port's CLI on the card: `python -m paddle_tpu_torch
    train` for one pass (run in this process with runpy, so that the
    B5/B6 wrappers' counts are this process's), then `--job=test` on its
    checkpoint and `dump_config` as subprocesses. Holds the dumped conf
    against the conf the same file parses to here, and the first printed
    cost against a CPU forward of the first batch from the same initial
    parameters (the same root seed, through the `seed` flag: the
    kernels' plain versions, f32, with the f32-vs-f64 distance as in
    held_grads). Returns the numbers."""
    import contextlib
    import io
    import runpy

    from paddle_tpu_torch.__main__ import _v1_setup
    from paddle_tpu_torch.compat.config_parser import parse_config
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.trainer.trainer import SGD

    path, args = write_v1_config(work, seed=SEED + 238)
    seed = SEED + 239
    here = os.getcwd()
    os.chdir(work)
    try:
        parsed = parse_config(path, args)
        model, opt, reader, feeder, evals = _v1_setup(path, args)
        sgd = SGD(model, opt, seed=seed, evaluators=evals, device="cpu")
        feed = feeder(next(iter(reader())))
        flags.set_flag("use_pallas_rnn", True)
        try:
            want = {}
            for dt in (torch.float32, torch.float64):
                p = {k: v.to(dt) for k, v in sgd.params.items()}
                f = {k: a.with_value(a.value.to(dt)) if a.value is not None
                     and a.value.is_floating_point() else a
                     for k, a in feed.items()}
                with torch.no_grad():
                    want[dt] = sgd.net.loss_fn(p, f, train=True)[0].item()
        finally:
            flags.set_flag("use_pallas_rnn", None)
        out = io.StringIO()
        argv = sys.argv
        sys.argv = ["paddle_tpu_torch", "train", f"--config={path}",
                    f"--config_args={args}", "--log_period=1",
                    "--save_dir", os.path.join(work, "ck")]
        # the trainer's root seed when SGD gets none: the CLI's initial
        # parameters are the reference's
        flags.set_flag("seed", seed)
        zero_rnn_counts(rnn)
        # a fresh __main__, as `python -m` runs it
        sys.modules.pop("paddle_tpu_torch.__main__", None)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_module("paddle_tpu_torch", run_name="__main__",
                                 alter_sys=True)
        except SystemExit as e:
            assert e.code in (0, None), f"train exited {e.code}"
        finally:
            sys.argv = argv
            flags.set_flag("seed", 0)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = {k: v for k, v in rnn_counts(rnn).items() if v}
    finally:
        os.chdir(here)
    costs = [float(ln.split()[-1]) for ln in out.getvalue().splitlines()
             if ln.startswith("pass 0 batch")]
    rc, test_lines = run_cli(
        ["train", f"--config={path}", f"--config_args={args}", "--job=test",
         "--save_dir", os.path.join(work, "ck")],
        os.path.join(work, "test.log"), cwd=work)
    assert rc == 0, "--job=test failed"
    rc, dump = run_cli(["dump_config", f"--config={path}",
                        f"--config_args={args}"],
                       os.path.join(work, "dump.log"), cwd=work)
    assert rc == 0, "dump_config failed"
    dumped = json.loads("\n".join(line for _t, line in dump))
    test_line = [ln for _t, ln in test_lines if ln.startswith("test cost")]
    noise = abs(want[torch.float32] - want[torch.float64]) / abs(
        want[torch.float64])
    r = {"steps": len(costs), "train_s": train_s,
         "cost_first_card": costs[0] if costs else None,
         "cost_first_cpu": want[torch.float32],
         "cost_first_cpu_f64": want[torch.float64],
         "cost_last": costs[-1] if costs else None,
         "test": test_line, "launches": counts}
    print("v1 cli " + json.dumps(r), flush=True)
    assert dumped["model"] == json.loads(parsed.model.to_json()), (
        "dumped conf")
    assert dumped["optimization"] == json.loads(json.dumps(
        vars(parsed.opt), default=str)), "dumped optimization"
    assert len(costs) == 8 and np.isfinite(costs).all(), r
    # the CLI prints 6 decimals
    assert abs(costs[0] - want[torch.float32]) <= (
        (HELD_TOL + 2 * noise) * abs(want[torch.float32]) + 1e-6), r
    assert len(test_line) == 1 and "err=" in test_line[0], r
    assert counts == dict.fromkeys(
        ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
         "lstm_bwd_launches", "lstm_bwd_cluster_launches"), 8), r
    return r


def ssd_conf():
    """SSD300's priors over SSD_MAPS, concatenated, feeding
    multibox_loss and detection_output; the heads are data layers."""
    from paddle_tpu_torch import dsl

    with dsl.model() as g:
        image = dsl.data("image", (300, 300, 1))
        pbs = []
        for i, (s, mn, mx, ars) in enumerate(SSD_MAPS):
            fmap = dsl.data(f"fmap{i}", (s, s, 1))
            pbs.append(dsl.priorbox(fmap, image, min_size=[float(mn)],
                                    max_size=[float(mx)],
                                    aspect_ratio=list(ars),
                                    variance=[0.1, 0.1, 0.2, 0.2],
                                    name=f"pb{i}"))
        pb = dsl.concat(*pbs, name="priors")
        p = sum(SSD_PRIORS)
        loc = dsl.data("loc", 4 * p)
        conf = dsl.data("conf", SSD_C * p)
        gt = dsl.data("gt", 4, is_seq=True)
        gt_lab = dsl.data("gt_lab", 1, is_seq=True, is_ids=True)
        dsl.multibox_loss(pb, gt, gt_lab, loc, conf, num_classes=SSD_C,
                          name="loss")
        dsl.detection_output(pb, loc, conf, num_classes=SSD_C,
                             nms_top_k=400, keep_top_k=200, name="dets")
    return g.conf


def ssd_feeds(seed):
    """{name: Arg} on the CPU: SSD_B images' random heads (loc, conf),
    1..SSD_G ground-truth boxes an image with labels 1..SSD_C-1, and the
    shape-only image and feature maps."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq, seq

    rng = np.random.default_rng(seed)
    p = sum(SSD_PRIORS)
    lo = rng.uniform(0.0, 0.7, (SSD_B, SSD_G, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (SSD_B, SSD_G, 2))],
                         -1).astype(np.float32)
    lens = rng.integers(1, SSD_G + 1, SSD_B).astype(np.int32)
    feeds = {
        "image": non_seq(np.zeros((SSD_B, 300, 300, 1), np.float32)),
        "loc": non_seq((0.5 * rng.standard_normal((SSD_B, 4 * p))).astype(
            np.float32)),
        "conf": non_seq(rng.standard_normal((SSD_B, SSD_C * p)).astype(
            np.float32)),
        "gt": seq(box, lens),
        "gt_lab": id_arg(rng.integers(1, SSD_C, (SSD_B, SSD_G)), lens),
    }
    for i, (s, *_rest) in enumerate(SSD_MAPS):
        feeds[f"fmap{i}"] = non_seq(np.zeros((SSD_B, s, s, 1), np.float32))
    return feeds


def detection_heads(torch):
    """Phase 23(e): SSD300's multibox_loss (forward and the gradients in
    loc and conf) and detection_output on the card against the port on
    the CPU from the same random heads: the loss and gradients within
    HELD_TOL of the largest entry plus twice the CPU's f32-vs-f64
    distance; detection_output's rows, each image's in (label, -score)
    order, with equal labels and scores and boxes within HELD_TOL.
    Prints the ms of each on the card. Returns the numbers."""
    from paddle_tpu_torch.network import Network

    net = Network(ssd_conf())
    assert net.specs["priors"].size == 8 * 8732, net.specs["priors"]
    feeds = ssd_feeds(SEED + 240)

    def loss_run(device, dtype):
        f = {k: a.to(device) for k, a in feeds.items()}
        x = {k: f[k].value.to(dtype=dtype, copy=True).requires_grad_(True)
             for k in ("loc", "conf")}
        f.update({k: f[k].with_value(v) for k, v in x.items()})
        o = net.forward({}, f, outputs=["loss"])[0]["loss"].value
        o.mean().backward()
        return o.detach(), {k: v.grad for k, v in x.items()}

    (lc, gc), (l32, g32), (l64, g64) = (loss_run(d, t) for d, t in (
        ("cuda", torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64)))
    errs = {"loss": (rel_err(lc.cpu(), l32)[0],
                     rel_err(l32.double(), l64)[0])}
    errs.update({k: (rel_err(gc[k].cpu(), g32[k])[0],
                     rel_err(g32[k].double(), g64[k])[0]) for k in gc})
    outside = [k for k, (e, n_) in errs.items() if not e <= HELD_TOL + 2 * n_]

    def dets(device):
        f = {k: a.to(device) for k, a in feeds.items()}
        with torch.no_grad():
            o = net.forward({}, f, outputs=["dets"])[0]["dets"].value
        return o.reshape(SSD_B, -1, 6).cpu()

    dc, d32 = dets("cuda"), dets("cpu")
    kept = []
    for b in range(SSD_B):
        rows = []
        for d in (dc[b], d32[b]):
            key = d[:, 0] * 10 - d[:, 1]
            rows.append(d[torch.argsort(key, stable=True)])
        assert torch.equal(rows[0][:, 0], rows[1][:, 0]), f"image {b} labels"
        kept.append(int((rows[1][:, 1] > 0).sum()))
        errs[f"dets{b}"] = (rel_err(rows[0][:, 1:], rows[1][:, 1:])[0], 0.0)
    outside += [k for k, (e, _n) in errs.items()
                if k.startswith("dets") and e > HELD_TOL]
    fc = {k: a.to("cuda") for k, a in feeds.items()}
    xc = {k: fc[k].value.clone().requires_grad_(True)
          for k in ("loc", "conf")}
    fc.update({k: fc[k].with_value(v) for k, v in xc.items()})

    def loss_step():
        net.forward({}, fc, outputs=["loss"])[0]["loss"].value.mean(
            ).backward()

    with torch.no_grad():
        dets_ms = time_ms(torch, lambda: net.forward(
            {}, fc, outputs=["dets"]), reps=3, warmup=1)
    r = {"priors": sum(SSD_PRIORS), "loss_card": float(lc.mean()),
         "loss_cpu": float(l32.mean()),
         "max_err": {k: e for k, (e, _n) in errs.items()},
         "cpu_f32_vs_f64": {k: n_ for k, (_e, n_) in errs.items()
                            if not k.startswith("dets")},
         "outside": outside, "kept_rows": kept,
         "multibox_loss_fwd_bwd_ms": time_ms(torch, loss_step, reps=5,
                                             warmup=1),
         "detection_output_ms": dets_ms}
    print("ssd heads " + json.dumps(r), flush=True)
    assert not outside, r
    assert np.isfinite(r["loss_card"]) and min(kept) > 0, r
    return r


def layer_tail(torch, rnn):
    """Phase 23: (a) every new layer type, (b) the VAE, (c) the GAN,
    (d) a v1 config through the CLI, (e) the SSD heads."""
    import tempfile

    phase("23a. every new layer type, card against CPU")
    layers = tail_layers(torch)
    phase("23b. the VAE at vae_conf's defaults, eager and as CUDA graphs")
    vae = vae_train(torch)
    phase("23c. the GAN at gan_conf's defaults")
    gan = gan_train(torch)
    phase("23d. a v1 LSTM config through the CLI")
    with tempfile.TemporaryDirectory() as work:
        v1 = v1_cli(torch, rnn, work)
    phase("23e. SSD300's detection heads, card against CPU")
    ssd = detection_heads(torch)
    return {"layers": layers, "vae": vae, "gan": gan, "v1": v1, "ssd": ssd}


# ---- phase 24: the flight recorder and the fleet --------------------------

# 24a: GEN_FLIGHT requests (traced) from FLIGHT_CLIENTS threads at 20(c)'s
# buckets, an admitted-p99 SLO below any latency (slo_breach after the
# 20th), then a model failing BREAKER_THRESHOLD times (breaker_open,
# suppressed inside the recorder's interval)
GEN_FLIGHT, FLIGHT_CLIENTS, FLIGHT_SLO_MS, BREAKER_THRESHOLD = 24, 4, 0.001, 3
# 24c: CODISPATCH requests a classifier, lengths 10..CLS_T, one batch a
# model of up to CODISPATCH_BATCH
CODISPATCH, CODISPATCH_BATCH = 32, 32
# 24d: bench_serve_fleet_loadtest's settings
FLEET = dict(replicas=3, clients=8, window_s=3.0, layers=4, d=32,
             max_queue=64, breaker_reset_s=0.4)
# 24e: bench_serve_coldstart's settings
COLDSTART = dict(layers=48, d=256)
# 24f: bench_multichip.py::_bench_ctr_bigvocab's full setting (8 logical
# shards on the one card) for the elastic worker, then the online loop of
# tests/test_online_learning.py over a table of that size
CTR_BIG = dict(SHARDS=8, ROWS_TOTAL=1 << 30, BATCHES=48, CAPACITY=4096,
               NUM_SLOTS=1024, HOT=4096, BATCH=8, FEATS=4, DIM=8,
               BATCH_SLEEP=0.05)
ONLINE = dict(hot=32, batch=32, feats=4, batches=40, lr=1.0, swap_every=10,
              seed=11)
# 24f: the card's CTR tables and losses against a CPU table's (phase 15's)
CTR_TOL = 1e-5
# 24g: a slow and a fast toy replica against a 100 ms p99 SLO
INCIDENT = dict(slow_s=0.3, fast_s=0.004, slo_ms=100.0)
REPO = os.path.dirname(os.path.abspath(__file__))


def until(pred, timeout, step=0.01):
    """Poll `pred` until it holds or `timeout` s pass; its last value."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def flight_bundles(d):
    """The flight bundles that have landed in `d` (the final .json, not
    the .json.tmp a dump writes first nor the .attrib.json beside it)."""
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if f.startswith("flight-")
                  and f.endswith(".json") and ".json." not in f)


def registry_total(family):
    from paddle_tpu_torch.obs import aggregate, metrics

    return aggregate.family_total(
        metrics.get_registry().snapshot()["counters"], family)


def start_replicas(n, dev, **env):
    """Start n serving replicas in parallel on `dev`; [(proc, port)].
    If one fails to boot, all are killed."""
    from paddle_tpu_torch import testing_faults as tf

    out = [None] * n

    def go(i):
        out[i] = tf.start_serving_replica(REPO, boot_timeout=240,
                                          DEVICE=dev, **env)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if any(o is None or o[1] is None for o in out):
        for o in out:
            if o is not None:
                tf.kill_process(o[0])
        raise AssertionError([o and o[0].boot_line for o in out])
    return out


class Booting:
    """`start_replicas` on a thread, so that replicas boot while other
    sub-phases run; `wait()` returns its [(proc, port)] (or raises its
    error) and `kill()` stops whatever it started."""

    def __init__(self, n, dev, **env):
        self._out = {}
        self._thread = threading.Thread(target=self._run,
                                        args=(n, dev, env))
        self._thread.start()

    def _run(self, n, dev, env):
        try:
            self._out["ok"] = start_replicas(n, dev, **env)
        except BaseException as e:  # handed to wait()
            self._out["error"] = e

    def alive(self):
        """Whether its replicas are still booting."""
        return self._thread.is_alive()

    def wait(self):
        self._thread.join(360)
        if "error" in self._out:
            raise self._out["error"]
        return self._out["ok"]

    def kill(self):
        from paddle_tpu_torch import testing_faults as tf

        self._thread.join(360)
        for p, _ in self._out.get("ok", ()):
            tf.kill_process(p)


def serve_anomalies(torch, rnn, gen, work, dev):
    """24a: phase 20's GenerationModel behind an InferenceServer with a
    flight recorder writing bundles under its profiler capture. An SLO below
    any latency trips `slo_breach` once 20 traced requests completed; a
    model failing BREAKER_THRESHOLD times trips `breaker_open` inside
    the recorder's interval: exactly one bundle, the rest counted on
    `flight.dumps_suppressed`. The bundle holds the requests' spans,
    a captured profile and its trace, and the bundle lint accepts it.
    Then a dump's ms with and without the capture."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.obs import flight_recorder as fr
    from paddle_tpu_torch.obs import metrics, tracing
    from paddle_tpu_torch.serving.models import GenerationModel
    from paddle_tpu_torch.serving.server import (InferenceServer,
                                                 ServeConfig, ServeError)

    class Poisoned:
        can_host = False
        engine = None
        named_hooks = {}

        def run_batch(self, ids, lens, hooks, host):
            raise RuntimeError("poisoned program")

    d = os.path.join(work, "flight")
    rec = fr.enable_flight_recorder(dump_dir=d, min_interval_s=3600.0,
                                    max_bundles=8, profiler_capture=True)
    flags.set_flag("serve_p99_slo_ms", FLIGHT_SLO_MS)
    suppressed0 = registry_total("flight.dumps_suppressed")
    model = GenerationModel(gen["decoder"](GEN_K), gen["params"],
                            encode=gen["encode"])
    server = InferenceServer(ServeConfig(
        max_queue=64, max_batch=SERVE_GEN["max_batch"],
        buckets=SERVE_GEN["buckets"], default_deadline_s=120.0,
        breaker_threshold=BREAKER_THRESHOLD, breaker_reset_s=60.0))
    server.add_model("nmt", model)
    server.add_model("bad", Poisoned())
    rng = np.random.default_rng(SEED + 240)
    sources = [rng.integers(2, NMT["src_vocab"], int(n)).tolist()
               for n in rng.integers(SERVE_GEN["src_lens"][0],
                                     SERVE_GEN["src_lens"][1] + 1,
                                     GEN_FLIGHT)]
    answers = [None] * GEN_FLIGHT
    per = GEN_FLIGHT // FLIGHT_CLIENTS

    def client(c):
        for j in range(c * per, (c + 1) * per):
            answers[j] = server.submit(
                "nmt", sources[j],
                trace={"trace_id": tracing.new_trace_id(),
                       "span_id": ""}).result(300)

    zero_rnn_counts(rnn)
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(FLIGHT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        serve_s = time.perf_counter() - t0
        assert all(a is not None and "tokens" in a for a in answers), \
            answers
        assert until(lambda: len(flight_bundles(d)) == 1, 60), os.listdir(d)
        failures = []
        for _ in range(BREAKER_THRESHOLD):
            try:
                server.submit("bad", [2, 3]).result(60)
            except ServeError as e:
                failures.append(str(e))
        assert len(failures) == BREAKER_THRESHOLD, failures
        assert until(lambda: registry_total("flight.dumps_suppressed")
                     > suppressed0, 30)
        stats = server.stats()
    finally:
        server.shutdown(drain=True)
        flags.set_flag("serve_p99_slo_ms", 0)
    counts = gru_counts(rnn)
    files = flight_bundles(d)
    assert len(files) == 1, files
    path = os.path.join(d, files[0])
    doc = json.load(open(path))
    spans = {e["name"] for e in rec.spans()}
    bundle_spans = {e["name"] for e in doc["events"]
                    if e.get("kind") == "span"}
    events = [(e.get("event"), e.get("model")) for e in rec.snapshot()
              if e.get("kind") == "serving"]
    lint = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "check_bench_record.py"),
         "bundle", path], capture_output=True, text=True, timeout=120)
    # a dump's own cost, with and without the capture; the capture's
    # window sees a matmul loop on the card (the serving worker above
    # waits in its own capture, so that trace holds no kernel)
    timed, busy = {}, threading.Event()

    def matmuls():
        n = 2048 if dev == "cuda" else 256
        a = torch.randn(n, n, device=dev) / n ** 0.5
        while not busy.is_set():
            a = torch.tanh(a @ a)
            if dev == "cuda":
                torch.cuda.synchronize()

    for capture in (False, True):
        r2 = fr.FlightRecorder(dump_dir=os.path.join(work, f"t{capture}"),
                               registry=metrics.get_registry(),
                               min_interval_s=0.0,
                               profiler_capture=capture)
        for e in rec.snapshot():
            r2.record(e)
        side = threading.Thread(target=matmuls)
        busy.clear()
        side.start()
        try:
            t0 = time.perf_counter()
            assert r2.maybe_dump("timed") is not None
            timed[capture] = (time.perf_counter() - t0) * 1e3
        finally:
            busy.set()
            side.join(60)
    fr.disable_flight_recorder()
    attrib = r2.last_bundle["profile"].get("attrib")
    shares = json.load(open(attrib))["shares"] if attrib else None
    r = {"requests": GEN_FLIGHT, "serve_s": serve_s,
         "bundle": files[0], "reason": doc["reason"],
         "context": doc["context"], "bundle_events": len(doc["events"]),
         "bundle_spans": sorted(bundle_spans), "ring_spans": sorted(spans),
         "serving_events": events,
         "suppressed": registry_total("flight.dumps_suppressed")
         - suppressed0,
         "profile": {k: doc["profile"].get(k) for k in
                     ("captured", "attrib")},
         "trace_bytes": (os.path.getsize(doc["profile"]["trace"])
                         if doc["profile"].get("trace") else 0),
         "lint_rc": lint.returncode,
         "dump_ms": timed[False], "dump_with_capture_ms": timed[True],
         "timed_capture_attrib_shares": shares,
         "launches": counts, "server": stats}
    print("flight serve " + json.dumps(r), flush=True)
    assert doc["reason"] == "slo_breach", doc["reason"]
    assert {"serve.request", "serve.queued", "serve.dispatch"} <= spans
    assert {"serve.request", "serve.queued", "serve.dispatch"} <= \
        bundle_spans
    assert ("slo_breach", None) in events and ("breaker_open",
                                               "bad") in events
    assert r["suppressed"] >= 1, r
    assert doc["profile"]["captured"] is True, doc["profile"]
    assert os.path.exists(doc["profile"]["trace"]), doc["profile"]
    assert lint.returncode == 0, lint.stdout + lint.stderr
    if dev == "cuda":
        assert counts["gru_fwd_launches"] > 0, counts
        # the card's kernels reached the attribution tool
        assert shares is not None, r2.last_bundle["profile"]
    return r


class FailOnce:
    """A decoder whose device `generate` raises once (the rescue's
    fault; everything else is the wrapped decoder's)."""

    def __init__(self, inner):
        self.inner = inner
        self.failed = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def generate(self, *a, **k):
        if not self.failed:
            self.failed += 1
            raise RuntimeError("device decode failed")
        return self.inner.generate(*a, **k)


def rescue(torch, rnn, gen, dev):
    """24b: the host-fallback rescue. The decoder's device decode raises
    once: the request is answered on the host rung (path "host"), its
    tokens those of a device decode of the same request by the serving
    rule, the breaker counts exactly one failure, `completed_host` is 1,
    and B7 ran on both rungs (the encoder, twice each)."""
    from paddle_tpu_torch.serving.host_decode import host_generate
    from paddle_tpu_torch.serving.models import GenerationModel
    from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig

    params = gen["params"]
    model = GenerationModel(FailOnce(gen["decoder"](GEN_K)), params,
                            encode=gen["encode"])
    server = InferenceServer(ServeConfig(
        max_queue=8, max_batch=1, buckets=SERVE_GEN["buckets"],
        default_deadline_s=120.0, host_fallback=True))
    server.add_model("rescue", model)
    rng = np.random.default_rng(SEED + 241)
    src = rng.integers(2, NMT["src_vocab"], 20).astype(np.int32)
    before = registry_total("serving.dispatch_failures")
    zero_rnn_counts(rnn)
    try:
        t0 = time.perf_counter()
        out = server.submit("rescue", src.tolist()).result(300)
        ms = (time.perf_counter() - t0) * 1e3
        stats = server.stats()
    finally:
        server.shutdown(drain=True)
    counts = gru_counts(rnn)
    bucket = next(b for b in SERVE_GEN["buckets"] if b >= len(src))
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(src)] = src
    statics, boots = gen["encode"](ids, np.asarray([len(src)], np.int32))
    lone = gen["decoder"](GEN_K)
    ref = tuple(x.cpu().numpy() for x in lone.generate(params, statics,
                                                        boots))
    got = (np.asarray([[out["tokens"]]]), np.asarray([[len(out["tokens"])]]))
    rec = MarginRecorder(EOS)

    def margins(_i):
        host_generate(gen["decoder"](1), params, statics, boots,
                      hooks=rec.hooks())
        return [m[0] for m in rec.margins]

    equal, excused = margin_rule("rescued request", got, ref, margins)
    r = {"path": out["path"], "tokens": len(out["tokens"]),
         "tokens_equal": equal, "tokens_excused_by_margin": excused,
         "breaker_failures": registry_total("serving.dispatch_failures")
         - before, "completed_host": stats["completed_host"],
         "failed": stats["failed"], "ms": ms, "launches": counts}
    print("flight rescue " + json.dumps(r), flush=True)
    assert out["path"] == "host", out
    assert r["breaker_failures"] == 1, r
    assert stats["completed_host"] == 1 and stats["failed"] == 0, stats
    assert stats["models"]["rescue"]["breaker"] == "closed", stats
    if dev == "cuda":
        # the encoder (two B7 launches) on the device rung before its
        # decode raised, and again on the host rung
        assert counts["gru_fwd_launches"] == 4, counts
    return r


def codispatch(torch, rnn, dev):
    """24c: two phase-13 classifiers (h = 256, T up to CLS_T) merged by
    MultiForwardHost behind one server; a gate model holds the worker
    while both models' requests queue, so the next dispatch takes one
    batch of each (`batches_codispatch`). Every co-dispatched batch's
    scores equal each model's batch served alone (torch.equal), and its
    probabilities the scan arm's within 1e-5 (phase 11's tolerance);
    B5's inference form launched."""
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.serving.models import MultiForwardHost
    from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig

    host = MultiForwardHost(
        {"a": stacked_lstm_classifier(**CLS),
         "b": stacked_lstm_classifier(**{**CLS, "num_classes": 3})},
        generator=torch.Generator().manual_seed(SEED + 242), device=dev)
    groups = []
    run_group = host.run_group

    def recording(packed):
        out = run_group(packed)
        groups.append((packed, out))
        return out

    host.run_group = recording
    started, release = threading.Event(), threading.Event()

    class Gate:
        can_host = False
        engine = None
        named_hooks = {}

        def run_batch(self, ids, lens, hooks, host):
            started.set()
            release.wait(60)
            return [{"tokens": [], "score": 0.0}] * ids.shape[0]

    server = InferenceServer(ServeConfig(
        max_queue=4 * CODISPATCH, max_batch=CODISPATCH_BATCH,
        buckets=(CLS_T,), default_deadline_s=120.0))
    server.add_model("gate", Gate())
    for name in host.names:
        server.add_model(name, host.sub(name))
    rng = np.random.default_rng(SEED + 243)
    reqs = [(name, rng.integers(1, CLS["vocab_size"],
                                int(rng.integers(10, CLS_T + 1))).tolist())
            for name in host.names for _ in range(CODISPATCH)]
    zero_rnn_counts(rnn)
    try:
        gate = server.submit("gate", [1])
        assert started.wait(60)
        pend = [(n, server.submit(n, ids)) for n, ids in reqs]
        release.set()
        gate.result(60)
        t0 = time.perf_counter()
        answers = [(n, p.result(300)) for n, p in pend]
        wall = time.perf_counter() - t0
        stats = server.stats()
    finally:
        release.set()
        server.shutdown(drain=True)
    counts = rnn_counts(rnn)
    co = [(p, o) for p, o in groups if len(p) > 1]
    assert co, [sorted(p) for p, _ in groups]
    alone_equal, scan_diff = True, 0.0

    def probs(rows):
        z = np.asarray([r["scores"] for r in rows], np.float64)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    for packed, out in co:
        for name in packed:
            alone = run_group({name: packed[name]})[name]
            alone_equal &= all(np.array_equal(a["scores"], b["scores"])
                               for a, b in zip(alone, out[name]))
        set_rnn_arm("scan")
        scan = run_group(packed)
        set_rnn_arm("kernels")
        for name in packed:
            scan_diff = max(scan_diff, float(np.abs(
                probs(scan[name]) - probs(out[name])).max()))
    r = {"requests": len(reqs), "wall_s": wall,
         "batches_codispatch": stats["batches_codispatch"],
         "batches": stats["batches"], "codispatch_groups": len(co),
         "alone_equal": bool(alone_equal), "scan_prob_max_abs_diff":
         scan_diff, "b5_infer_launches": counts["lstm_fwd_infer_launches"],
         "launches": {k: v for k, v in counts.items() if v}}
    print("flight codispatch " + json.dumps(r), flush=True)
    assert all(a["path"] == "device" for _, a in answers)
    assert stats["batches_codispatch"] >= 1, stats
    assert alone_equal, r
    assert scan_diff <= 1e-5, r
    if dev == "cuda":
        assert counts["lstm_fwd_infer_launches"] > 0, counts
        assert counts["lstm_fwd_infer_launches"] == counts[
            "lstm_fwd_infer_cluster_launches"], counts
    return r


def fleet_point(router, secs, on_half=None, clients=FLEET["clients"]):
    """bench_serve_fleet_loadtest's closed-loop point: `clients` threads
    calling for `secs` s (with `on_half` run halfway); goodput, p50/p99
    and the admitted requests lost (anything but ok or an explicit
    overloaded shed)."""
    lock = threading.Lock()
    stop = threading.Event()
    lat, shed, lost = [], [0], [0]

    def loop():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                r = router.call("m", [1, 2, 3], deadline_ms=5000,
                                trace=False)
            except Exception:
                with lock:
                    lost[0] += 1
                continue
            with lock:
                if r.get("ok"):
                    lat.append(time.perf_counter() - t0)
                elif r.get("error") == "overloaded":
                    shed[0] += 1
                else:
                    lost[0] += 1

    workers = [threading.Thread(target=loop, daemon=True)
               for _ in range(clients)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    if on_half is not None:
        time.sleep(secs / 2)
        on_half()
    time.sleep(max(t0 + secs - time.perf_counter(), 0.0))
    stop.set()
    for w in workers:
        w.join(timeout=30)
    span = time.perf_counter() - t0
    lat.sort()
    n = len(lat)
    return {"completed": n, "goodput_rps": n / span,
            "p50_ms": lat[n // 2] * 1e3 if n else None,
            "p99_ms": lat[int(0.99 * (n - 1))] * 1e3 if n else None,
            "shed": shed[0], "admitted_lost": lost[0], "seconds": span}


def fleet_cache(torch, work, dev):
    """24d's verified cache entry: replica_program_fn(4, 32) on `dev`.
    Returns the module and the replicas' environment."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch import testing_faults as tf

    cache = os.path.join(work, "fleet-cache")
    fn = tf.replica_program_fn(FLEET["layers"], FLEET["d"]).to(dev)
    inference.store_verified(cache, "fleet", fn,
                             (torch.zeros((1, 8), device=dev),))
    return fn, dict(REPLICA_MODE="cache", CACHE_DIR=cache,
                    CACHE_KEY="fleet", MODEL_TAG="v1",
                    MAX_QUEUE=FLEET["max_queue"])


def fleet_sigkill(torch, dev, fn, env, booting):
    """24d: three cache-mode replicas on the card (replica_program_fn(4,
    32) from the verified cache, `booting` since the phase began) behind
    a FleetRouter, 8 closed-loop clients, 3 s a point: one point whole,
    then one with r1 SIGKILLed halfway. Zero admitted requests lost; r1
    rotated out, restarted from the cache and rejoined through the
    half-open probe; its answer the program's."""
    from paddle_tpu_torch import testing_faults as tf
    from paddle_tpu_torch.serving.fleet import FleetConfig, FleetRouter
    from paddle_tpu_torch.serving.tcp import ServeClient

    started = booting.wait()
    procs = {f"r{i}": p for i, (p, _) in enumerate(started)}
    addrs = {f"r{i}": f"127.0.0.1:{port}"
             for i, (_, port) in enumerate(started)}
    fcfg = FleetConfig(poll_interval_s=0.05,
                       breaker_reset_s=FLEET["breaker_reset_s"])
    router = FleetRouter(dict(addrs), fcfg)
    try:
        assert until(lambda: all(router.handle(n).metricz for n in addrs),
                     30)
        whole = fleet_point(router, FLEET["window_s"])
        rotated, t_kill = [None], [None]

        def kill_r1():
            t_kill[0] = time.monotonic()
            tf.kill_process(procs["r1"])
            rotated[0] = until(
                lambda: router.states()["r1"]["breaker"] != "closed",
                fcfg.breaker_reset_s * 4)

        kill = fleet_point(router, FLEET["window_s"], on_half=kill_r1)
        (p, port), = start_replicas(1, dev, **{**env, "MODEL_TAG": "v2"})
        procs["r1"] = p
        t_set = time.monotonic()
        router.set_address("r1", f"127.0.0.1:{port}")
        rejoined = until(
            lambda: router.states()["r1"]["breaker"] == "closed", 30)
        t_rejoin = time.monotonic()
        with ServeClient(f"127.0.0.1:{port}") as c:
            out = c.call("m", [1, 2, 3], deadline_ms=10000, timeout=60)
        x = torch.tensor([[1.0, 2.0, 3.0] + [0.0] * 5], device=dev)
        want = float(fn(x))
    finally:
        router.close()
        for proc in procs.values():
            tf.kill_process(proc)
    r = {"replicas": FLEET["replicas"], "clients": FLEET["clients"],
         "window_s": FLEET["window_s"],
         "boot_s": [tf.replica_boot_seconds(q) for q, _ in started],
         "whole": whole, "kill": kill, "rotated_out": rotated[0],
         "rejoined": rejoined,
         "restart_boot_s": tf.replica_boot_seconds(p),
         "rejoin_s": t_rejoin - t_set, "kill_to_rejoin_s": t_rejoin
         - t_kill[0], "rejoined_answer": out,
         "admitted_lost": whole["admitted_lost"] + kill["admitted_lost"]}
    print("fleet sigkill " + json.dumps(r), flush=True)
    assert r["admitted_lost"] == 0, r
    assert rotated[0] and rejoined, r
    assert p.boot_line.startswith("BOOT cache"), p.boot_line
    assert out["ok"] and out["tag"] == "v2", out
    assert abs(out["score"] - want) <= 1e-6, (out, want)
    return r


def coldstart(torch, work, dev):
    """24e: bench_serve_coldstart on the card: the replica's program at
    48 layers x 256 stored in the verified cache (store_s), then one
    replica booted in compile mode (build and export, nothing
    published) and one in cache mode (digests, audit, torch.export.load);
    both boot times printed, no ordering asserted (the JAX row's premise,
    an XLA compile, does not carry over), both answers the program's."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch import testing_faults as tf
    from paddle_tpu_torch.serving.tcp import ServeClient

    cache = os.path.join(work, "coldstart-cache")
    fn = tf.replica_program_fn(COLDSTART["layers"], COLDSTART["d"]).to(dev)
    t0 = time.perf_counter()
    meta = inference.store_verified(cache, "cold", fn,
                                    (torch.zeros((1, 8), device=dev),))
    store_s = time.perf_counter() - t0
    x = torch.tensor([[0.0, 1.0, 2.0] + [0.0] * 5], device=dev)
    want = float(fn(x))
    boots, scores = {}, {}
    for mode, env in (("compile", dict(FN_LAYERS=COLDSTART["layers"],
                                       FN_DIM=COLDSTART["d"])),
                      ("cache", dict(CACHE_DIR=cache, CACHE_KEY="cold"))):
        (p, port), = start_replicas(1, dev, REPLICA_MODE=mode, **env)
        try:
            boots[mode] = tf.replica_boot_seconds(p)
            assert p.boot_line.startswith(f"BOOT {mode}"), p.boot_line
            with ServeClient(f"127.0.0.1:{port}") as c:
                scores[mode] = c.call("m", [0, 1, 2], deadline_ms=10000,
                                      timeout=60)["score"]
        finally:
            tf.kill_process(p)
    r = {"layers": COLDSTART["layers"], "d": COLDSTART["d"],
         "store_s": store_s, "compile_boot_s": boots["compile"],
         "cache_boot_s": boots["cache"],
         "compile_over_cache": boots["compile"] / boots["cache"],
         "n_instructions": meta["n_instructions"],
         "total_bytes": meta["total_bytes"], "scores": scores,
         "want": want}
    print("fleet coldstart " + json.dumps(r), flush=True)
    for mode, s in scores.items():
        assert abs(s - want) <= 1e-6, (mode, s, want)
    return r


def online_cpu_run(work, name, table_cfg, shards, lr, traffic,
                   warm_ids=None):
    """The plain reference of 24f: an OnlineCTRTrainer over a CPU table
    of the same config (the sparse-row kernels' plain versions) fed the
    same traffic. Returns (table, per-batch losses)."""
    from paddle_tpu_torch.parallel import sparse_shard as tss
    from paddle_tpu_torch.trainer import online

    table = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(**table_cfg), num_shards=shards,
        update_fn=tss.sgd_row_update(lr), device="cpu")
    if warm_ids is not None:
        table.lookup(warm_ids)
    trainer = online.OnlineCTRTrainer(table, os.path.join(work, name))
    try:
        losses = [trainer.train_step(ids, labels) for ids, labels in traffic]
    finally:
        trainer.close()
    return table, losses


def hold_tables(card, cpu, tol):
    """Largest |card - cpu| over the exported shards (resident ids in
    LRU order and the spill store must be equal)."""
    err = 0.0
    for a, b in zip(card.export_shards(), cpu.export_shards()):
        for ki, kr in (("ids", "rows"), ("spill_ids", "spill_rows")):
            assert np.array_equal(np.asarray(a[ki]), np.asarray(b[ki])), ki
            ra, rb = np.asarray(a[kr]), np.asarray(b[kr])
            if ra.size:
                err = max(err, float(np.max(np.abs(ra - rb))))
    assert err <= tol, (err, tol)
    return err


def ctr_worker(torch, work, dev):
    """24f (i): the elastic CTR worker at _bench_ctr_bigvocab's full
    setting, SIGKILLed after three acknowledged batches and respawned:
    every batch acknowledged exactly once (batches_lost ==
    batches_retrained == 0), kill_recover_s from the respawn to its
    first newly acknowledged batch, B9's launches from the done
    record."""
    from paddle_tpu_torch import testing_faults as tf

    save = os.path.join(work, "ctr-gens")
    os.makedirs(save)
    out = os.path.join(work, "ctr-ledger.jsonl")
    env = {**CTR_BIG, "DEVICE": dev}

    def trained():
        return [r["trained"] for r in tf.read_worker_records(out)
                if "trained" in r]

    p = tf.start_sharded_ctr_trainer(REPO, save, out, **env)
    try:
        ok = until(lambda: len(trained()) >= 3 or p.poll() is not None,
                   300, 0.02)
        assert ok and p.poll() is None, p.communicate(timeout=60)
    finally:
        tf.kill_process(p)
    acked = set(trained())
    assert len(acked) < CTR_BIG["BATCHES"], "kill landed after the epoch"
    t1 = time.monotonic()
    p2 = tf.start_sharded_ctr_trainer(REPO, save, out, **env)
    try:
        assert until(lambda: set(trained()) - acked or
                     p2.poll() is not None, 300, 0.02)
        kill_recover_s = time.monotonic() - t1
        _out, err = p2.communicate(timeout=600)
    finally:
        tf.kill_process(p2)
    assert p2.returncode == 0, err[-3000:]
    respawn_s = time.monotonic() - t1
    recs = tf.read_worker_records(out)
    done = [x for x in recs if x.get("done")][-1]
    got = trained()
    r = {"batches": CTR_BIG["BATCHES"], "acked_before_kill": len(acked),
         "batches_lost": len(set(range(CTR_BIG["BATCHES"])) - set(got)),
         "batches_retrained": len(got) - len(set(got)),
         "kill_recover_s": kill_recover_s, "respawn_to_done_s": respawn_s,
         "rows_total": done["rows_total"],
         "rows_materialized": done["rows_materialized"],
         "evictions": done["evictions"], "device": done["device"],
         "launches": done["launches"],
         "resume": [x for x in recs if "resume" in x][-1]}
    # the ledger's losses against the same traffic through a CPU table
    # (seed 7, SGD at lr 0.5: the worker's fixed settings)
    from paddle_tpu_torch.trainer import online

    hot = online.hot_id_set(7, CTR_BIG["HOT"], CTR_BIG["ROWS_TOTAL"])
    _, want = online_cpu_run(
        work, "ctr-cpu",
        dict(rows_total=CTR_BIG["ROWS_TOTAL"], dim=CTR_BIG["DIM"],
             capacity=CTR_BIG["CAPACITY"], num_slots=CTR_BIG["NUM_SLOTS"],
             seed=7),
        CTR_BIG["SHARDS"], 0.5,
        [online.make_batch(7, b, CTR_BIG["BATCH"], CTR_BIG["FEATS"], hot)
         for b in range(CTR_BIG["BATCHES"])])
    held = [x for x in recs if x.get("loss") is not None]
    r["loss_max_abs_err"] = max(abs(x["loss"] - want[x["trained"]])
                                for x in held)
    r["losses_held"] = len(held)
    print("fleet ctr worker " + json.dumps(r), flush=True)
    assert r["batches_lost"] == 0 and r["batches_retrained"] == 0, r
    assert held and r["loss_max_abs_err"] <= CTR_TOL, r
    if dev == "cuda":
        assert done["launches"]["sparse_row_update_launches"] > 0, done
    return r


def online_loop(torch, sr, work, dev):
    """24f (ii): the online loop of tests/test_online_learning.py on the
    card over a table of CTR_BIG's size: 40 batches of traffic scored
    through the router by one ctr replica before the trainer learns from
    them (B9 through `table.update`), a rollout() onto the newest
    committed generation every 10 batches. Zero requests lost across the
    swaps, the served logloss over the last 10 batches below the first
    10's, each swap's ms."""
    from paddle_tpu_torch import testing_faults as tf
    from paddle_tpu_torch.parallel import sparse_shard as tss
    from paddle_tpu_torch.serving.fleet import FleetConfig, FleetRouter
    from paddle_tpu_torch.trainer import online

    o = ONLINE
    save = os.path.join(work, "online-gens")
    os.makedirs(save)
    table = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(rows_total=CTR_BIG["ROWS_TOTAL"],
                               dim=CTR_BIG["DIM"],
                               capacity=CTR_BIG["CAPACITY"],
                               num_slots=CTR_BIG["NUM_SLOTS"],
                               seed=o["seed"]),
        num_shards=CTR_BIG["SHARDS"], update_fn=tss.sgd_row_update(o["lr"]),
        device=dev)
    trainer = online.OnlineCTRTrainer(table, save)
    hot = online.hot_id_set(o["seed"], o["hot"], CTR_BIG["ROWS_TOTAL"])
    table.lookup(hot.reshape(-1, 1))
    trainer.save_generation(0, 0)
    trainer.drain()
    sr.sparse_row_update_launches = 0
    (p, port), = start_replicas(1, dev, REPLICA_MODE="ctr", MODEL_NAME="ctr",
                                MODEL_TAG="gen0", MODEL_DIR=save)
    router = FleetRouter({"r0": f"127.0.0.1:{port}"},
                         FleetConfig(monitor=False))
    served, swaps, lost, requests, traffic = [], [], 0, 0, []
    try:
        for b in range(o["batches"]):
            ids, labels = online.make_batch(o["seed"], b, o["batch"],
                                            o["feats"], hot)
            traffic.append((ids, labels))
            ps = []
            for row in ids:
                resp = router.call("ctr", row.tolist(), deadline_ms=10_000)
                requests += 1
                if resp.get("ok"):
                    ps.append(float(resp["score"]))
                else:
                    lost += 1
                    ps.append(0.5)
            served.append(online.logloss(np.array(ps), labels))
            trainer.train_step(ids, labels)
            if b % o["swap_every"] == o["swap_every"] - 1:
                gen_id = b // o["swap_every"] + 1
                trainer.save_generation(gen_id, b + 1)
                trainer.drain()
                t0 = time.perf_counter()
                report = router.rollout("ctr", tag=f"gen{gen_id}")
                swaps.append({"ms": (time.perf_counter() - t0) * 1e3,
                              **report.per_replica["r0"]})
                assert report["r0"].get("tag") == f"gen{gen_id}", report
        final = router.call("ctr", ids[0].tolist(), deadline_ms=10_000)
    finally:
        router.close()
        tf.kill_process(p)
        trainer.close()
    launches = sr.sparse_row_update_launches
    # the card's table against the same traffic through a CPU table
    cpu_table, _ = online_cpu_run(
        work, "online-cpu",
        dict(rows_total=CTR_BIG["ROWS_TOTAL"], dim=CTR_BIG["DIM"],
             capacity=CTR_BIG["CAPACITY"], num_slots=CTR_BIG["NUM_SLOTS"],
             seed=o["seed"]),
        CTR_BIG["SHARDS"], o["lr"], traffic, warm_ids=hot.reshape(-1, 1))
    table_err = hold_tables(table, cpu_table, CTR_TOL)
    probe = np.stack([ids for ids, _ in traffic])
    probe = probe.reshape(-1, probe.shape[-1])
    logit_err = float(np.max(np.abs(online.predict_logits(table, probe)
                                    - online.predict_logits(cpu_table,
                                                            probe))))
    r = {"batches": o["batches"], "requests": requests,
         "swap_downtime_requests_lost": lost, "swaps": swaps,
         "logloss_first10": float(np.mean(served[:10])),
         "logloss_last10": float(np.mean(served[-10:])),
         "final": final, "b9_launches": launches,
         "rows_materialized": table.rows_materialized,
         "table_max_abs_err": table_err, "logit_max_abs_err": logit_err}
    print("fleet online loop " + json.dumps(r), flush=True)
    assert lost == 0, r
    assert logit_err <= CTR_TOL, r
    assert r["logloss_last10"] < r["logloss_first10"] - 0.05, r
    assert final["ok"] and final["tag"] == f"gen{len(swaps)}", final
    if dev == "cuda":
        assert launches >= o["batches"], launches
    return r


def incident_and_cli(torch, work, booting):
    """24g: a slow and a fast toy replica on the card (`booting` since
    the phase began) behind a router
    with the burn-rate monitor at a 100 ms p99 SLO: exactly one stitched
    incident bundle (both replicas' rings over flightz, the router's
    ring, the merged fleet view) naming the slow replica, accepted by the
    bundle lint and read by tools/fleet_view.py (a subprocess, rc 0);
    then `python -m paddle_tpu_torch fleetz --json` against the live
    replicas names each."""
    from paddle_tpu_torch.obs import flight_recorder as fr
    from paddle_tpu_torch import testing_faults as tf
    from paddle_tpu_torch.serving.fleet import FleetConfig, FleetRouter

    d = os.path.join(work, "incidents")
    started = dict(zip(("slow", "fast"), [b.wait()[0] for b in booting]))
    procs = {n: p for n, (p, _) in started.items()}
    addrs = {n: f"127.0.0.1:{port}" for n, (_, port) in started.items()}

    def files():
        if not os.path.isdir(d):
            return []
        return [f for f in os.listdir(d)
                if f.startswith("incident-") and f.endswith(".json")]

    fr.enable_flight_recorder(dump_dir=None, capacity=512)
    router = FleetRouter(dict(addrs), FleetConfig(
        poll_interval_s=0.05, monitor=True, slo_p99_ms=INCIDENT["slo_ms"],
        burn_windows=((0.9, 2.7, 14.4),), burn_min_decisions=20,
        incident_dir=d, incident_min_interval_s=3600.0,
        incident_max_bundles=4))
    suppressed0 = registry_total("fleet.incidents_suppressed")
    stop = threading.Event()

    def load():
        while not stop.is_set():
            try:
                router.call("m", [1, 2], deadline_ms=20000, trace=True)
            except Exception:
                pass

    workers = [threading.Thread(target=load, daemon=True)
               for _ in range(3)]
    try:
        assert until(lambda: all(router.handle(n).metricz for n in addrs),
                     30)
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        assert until(files, 60), "no incident bundle"
        to_incident = time.perf_counter() - t0
        assert until(lambda: registry_total("fleet.incidents_suppressed")
                     > suppressed0, 30)
        stop.set()
        for w in workers:
            w.join(30)
        fleetz = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "fleetz", "--json",
             "--interval", "0.5"] + [a for n, ad in addrs.items()
                                     for a in ("--addr", f"{n}={ad}")],
            cwd=REPO, capture_output=True, text=True, timeout=120)
    finally:
        stop.set()
        router.close()
        fr.disable_flight_recorder()
        for p in procs.values():
            tf.kill_process(p)
    got = files()
    assert len(got) == 1, got
    path = os.path.join(d, got[0])
    doc = json.load(open(path))
    view = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "fleet_view.py"), path],
        capture_output=True, text=True, timeout=120)
    lint = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_bench_record.py"),
         "bundle", path], capture_output=True, text=True, timeout=120)
    fz = json.loads(fleetz.stdout)
    r = {"to_incident_s": to_incident, "bundle": got[0],
         "alerts": [a["alert"] for a in doc["alerts"]],
         "offending": doc["offending"], "replicas": sorted(doc["replicas"]),
         "ring_events": {n: len(v.get("events", []))
                         for n, v in doc["replicas"].items()},
         "router_events": len(doc["events"]), "fleet_view_rc":
         view.returncode, "lint_rc": lint.returncode,
         "fleetz_rc": fleetz.returncode, "fleetz_fleet": fz["fleet"],
         "fleetz_replicas": sorted(x["replica"] for x in fz["replicas"])}
    print("fleet incident " + json.dumps(r), flush=True)
    assert doc["schema"] == "paddle-tpu-fleet-incident/v1"
    assert doc["offending"] == "slow", r
    assert set(doc["replicas"]) == {"slow", "fast"}, r
    for name in ("slow", "fast"):
        ring = doc["replicas"][name]
        assert ring.get("enabled") and ring["pid"] == procs[name].pid, name
        assert any(e.get("kind") == "span" for e in ring["events"]), name
    assert view.returncode == 0 and "offending=slow" in view.stdout, (
        view.stdout + view.stderr)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    assert fleetz.returncode in (0, 1), fleetz.stderr
    assert r["fleetz_replicas"] == ["fast", "slow"], r
    assert all(x["up"] for x in fz["replicas"]), fz
    return r


def flight_and_fleet(torch, rnn, sr, gen, dev="cuda"):
    """Phase 24: the flight recorder and the fleet, (a)-(g). Returns the
    sub-phases' numbers; the kernels line adds their B5, B7 and B9
    launches."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    out = {}
    # 24d's and 24g's replicas boot (a process reaching the card) while
    # 24a-24c run in this one
    fn, env = fleet_cache(torch, work, dev)
    booting = {"fleet": Booting(FLEET["replicas"], dev, **env),
               "incident": [Booting(1, dev, REPLICA_MODE="toy",
                                    TOY_DELAY_S=s)
                            for s in (INCIDENT["slow_s"],
                                      INCIDENT["fast_s"])]}
    groups = [booting["fleet"], *booting["incident"]]
    # how many of the booting groups were still starting when each of
    # 24a-24c began and ended: their times share the host and the card
    # with those boots
    overlap = {}

    def beside_boots(name, fn, *args):
        before = sum(g.alive() for g in groups)
        r = fn(*args)
        overlap[name] = [before, sum(g.alive() for g in groups)]
        return r

    try:
        phase("24a. the flight recorder on a serving anomaly")
        out["flight"] = beside_boots("24a", serve_anomalies, torch, rnn,
                                     gen, work, dev)
        phase("24b. the host-fallback rescue of a failed device decode")
        out["rescue"] = beside_boots("24b", rescue, torch, rnn, gen, dev)
        phase("24c. co-dispatch of two classifiers through MultiForwardHost")
        out["codispatch"] = beside_boots("24c", codispatch, torch, rnn, dev)
        out["boots_overlapping"] = overlap
        print("fleet 24a-c beside booting groups (of %d, before / after) %s"
              % (len(groups), json.dumps(overlap)), flush=True)
        phase("24d. the fleet under a SIGKILL, the rejoin from the verified "
              "cache")
        out["fleet"] = fleet_sigkill(torch, dev, fn, env, booting["fleet"])
        phase("24e. cold start: compile mode against the verified cache")
        out["coldstart"] = coldstart(torch, work, dev)
        phase("24f. the elastic CTR worker and the online loop")
        out["ctr"] = ctr_worker(torch, work, dev)
        out["online"] = online_loop(torch, sr, work, dev)
        phase("24g. a fleet incident bundle and the fleetz command")
        out["incident"] = incident_and_cli(torch, work,
                                           booting["incident"])
    finally:
        for b in [booting["fleet"], *booting["incident"]]:
            b.kill()
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---- phase 25: the kernels as custom ops, export / load, the recompile
# guard, the moe layer

# 25a: one shape a kernel from PERF.md's table (B1-B3 at the res2 tail
# site, f32 at batch 64 and bf16 at batch 256; B4f/B4b at the LM's
# training shape; B5/B6 at the classifier's, B7/B8 at the NMT encoder's;
# B9 at the wide&deep step's). An op's outputs against its plain version
# on the same card inputs: f32 within TOL of the largest entry, bf16
# within OPS_BF16_TOL, B9 within SPARSE_TOL.
OPS_BF16_TOL = 1e-2
OPS_FUSED = dict(n=64 * 3136, cin=64, cout=256)
OPS_FLASH = dict(B=32, T=128, H=4, D=64)
OPS_FLASH_SPLIT = dict(B=2, T=128, H=2, D=256)   # the D-split forms
OPS_LSTM = dict(B=CLS_B, T=CLS_T, h=256)
OPS_GRU = dict(B=NMT_B, T=NMT_T, h=256)
OPS_SPARSE = dict(rows=1 << 20, d=64, n=16384)
# 25b: the three exported forwards
EXPORT_RESNET_B = 256
EXPORT_LM = dict(B=8, T=1024)
EXPORT_REPS = 3
EXPORT_BF16_TOL = 1e-2
# 25d: the guarded classifier's passes (steps_per_dispatch 4: chunks of
# 4, 4 and 1) and the cold length
GUARD_K, GUARD_BATCHES, GUARD_COLD_T = 4, 9, 50
# 25e: the moe layer: D 512, hidden 2048, 8 experts, capacity factor
# 1.25, 4096 tokens (groups of 1024), adam, 3 steps; the card against the
# port on the CPU from the same start: losses and aux within MOE_TOL (f32)
# and MOE_BF16_TOL under the bf16 flag (CPU and card bf16 GEMMs round
# differently)
MOE = dict(d=512, hidden=2048, experts=8, cf=1.25, tokens=4096, classes=16,
           steps=3, lr=1e-3)
MOE_TOL, MOE_BF16_TOL = 1e-4, 3e-2


def _held(name, got, ref, tol):
    """max rel err of each output pair; asserts within tol."""
    errs = []
    for g, r in zip(got, ref):
        if r is None or r.numel() == 0:
            continue
        errs.append(rel_err(g.float(), r.float())[0])
    err = max(errs)
    assert err <= tol, f"{name}: {err:.3g} relative to max > {tol}"
    return err


def op_checks(torch, fop, fa, rnn, sr, dev="cuda"):
    """25a: `torch.library.opcheck` of every kernel's op on CUDA tensors
    (schema, fake against real, autograd registration, AOT dispatch with
    dynamic shapes), and each op's outputs against its plain version."""
    from paddle_tpu_torch.ops import _library

    g = torch.Generator(device=dev).manual_seed(SEED + 250)

    def randn(*shape, scale=1.0, dtype=torch.float32, grad=False):
        x = (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
        return x.requires_grad_(True) if grad else x

    out = {}

    def check(name, op, args, got_ref, tol):
        t0 = time.perf_counter()
        torch.library.opcheck(op, args)
        err = _held(name, *got_ref(), tol)
        out[name] = {"max_rel_err": err, "tol": tol,
                     "s": time.perf_counter() - t0}

    def no_grad(args):
        return tuple(a.detach() if torch.is_tensor(a) else a for a in args)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        n = OPS_FUSED["n"] * (4 if dtype == torch.bfloat16 else 1)
        cin, cout = OPS_FUSED["cin"], OPS_FUSED["cout"]
        tol = OPS_BF16_TOL if dtype == torch.bfloat16 else TOL
        u = randn(n, cin, dtype=dtype, grad=True)
        r = randn(n, cin, dtype=dtype, grad=True)
        sc, sh = randn(cin, grad=True), randn(cin, grad=True)
        w = randn(cin, cout, scale=0.1, dtype=dtype, grad=True)
        args = (u, sc, sh, w, r, "relu")
        check(f"bn_act_conv1x1_fwd_{tag}", fop.fwd_op, args,
              lambda: (fop.fwd_op(*no_grad(args)),
                       fop.bn_act_conv1x1_plain(*no_grad(args))), tol)
        y, _s1, _s2 = fop.bn_act_conv1x1_plain(*no_grad(args))
        dy = randn(n, cout, dtype=dtype)
        d1, d2 = randn(cout), randn(cout, scale=0.01)
        dx_args = (*no_grad(args[:5]), y, dy, d1, d2, "relu")
        check(f"bn_act_conv1x1_bwd_dx_{tag}", fop.bwd_dx_op, dx_args,
              lambda: (fop.bwd_dx_op(*dx_args),
                       fop.bn_act_conv1x1_bwd_dx_plain(*dx_args)), tol)
        dw_args = (*no_grad(args[:3]), r.detach(), y, dy, d1, d2, "relu")
        check(f"bn_act_conv1x1_bwd_dw_{tag}", fop.bwd_dw_op, dw_args,
              lambda: ((fop.bwd_dw_op(*dw_args),),
                       (fop.bn_act_conv1x1_bwd_dw_plain(*dw_args),)), tol)
        del u, r, w, y, dy, args, dx_args, dw_args

    # the flash ops at OPS_FLASH's head dim and, as D-splits, at 256
    for flash, tag in ((OPS_FLASH, ""), (OPS_FLASH_SPLIT, "_d256")):
        B, T, H, D = (flash[k] for k in ("B", "T", "H", "D"))
        q, k, v = (randn(B, T, H, D, grad=True) for _ in range(3))
        f_args = (q, k, v, True, None, None, None)
        check(f"flash_attention_fwd{tag}", fa.fwd_op, f_args,
              lambda: (fa.fwd_op(*no_grad(f_args)),
                       fa.attention_plain(*no_grad(f_args[:3]),
                                          causal=True)), TOL)
        qd, kd, vd = (x.detach() for x in (q, k, v))
        o, lse = fa.attention_plain(qd, kd, vd, causal=True)
        dout = randn(B, T, H, D)
        delta = fa.row_delta(dout, o)
        b_args = (qd, kd, vd, dout, lse, delta, True, None, None, None)
        ref = fa.attention_bwd_plain(qd, kd, vd, o, lse, dout, causal=True)
        check(f"flash_attention_bwd_dkv{tag}", fa.bwd_dkv_op, b_args,
              lambda: (fa.bwd_dkv_op(*b_args), ref[1:]), TOL)
        check(f"flash_attention_bwd_dq{tag}", fa.bwd_dq_op, b_args,
              lambda: ((fa.bwd_dq_op(*b_args),), ref[:1]), TOL)

    B, T, h = (OPS_LSTM[k] for k in ("B", "T", "h"))
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    x, w = randn(B, T, 4 * h, grad=True), randn(h, 4 * h, scale=h ** -0.5,
                                                grad=True)
    b7 = randn(7 * h, scale=0.1, grad=True)
    l_args = (x, w, b7, lens, True, None)
    split = [4 * h, h, h, h]
    check("lstm_seq_fwd", rnn.lstm_fwd_op, l_args,
          lambda: (rnn.lstm_fwd_op(*no_grad(l_args)),
                   rnn.lstm_plain(x.detach(), w.detach(),
                                  *torch.split(b7.detach(), split), lens,
                                  want_c=True)), TOL)
    yl, cl = rnn.lstm_plain(x.detach(), w.detach(),
                            *torch.split(b7.detach(), split), lens,
                            want_c=True)
    dy = randn(B, T, h)
    lb_args = (x.detach(), w.detach(), b7.detach(), lens, yl, cl, dy, None)
    check("lstm_seq_bwd", rnn.lstm_bwd_op, lb_args,
          lambda: (rnn.lstm_bwd_op(*lb_args),
                   rnn.lstm_bwd_plain(*lb_args[:7])), TOL)

    B, T, h = (OPS_GRU[k] for k in ("B", "T", "h"))
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    gru = (randn(B, T, 3 * h, grad=True),
           randn(h, 2 * h, scale=h ** -0.5, grad=True),
           randn(h, h, scale=h ** -0.5, grad=True),
           randn(3 * h, scale=0.1, grad=True))
    g_args = (*gru, lens, None)
    gd = tuple(t.detach() for t in gru)
    check("gru_seq_fwd", rnn.gru_fwd_op, g_args,
          lambda: ((rnn.gru_fwd_op(*gd, lens),), (rnn.gru_plain(*gd, lens),)),
          TOL)
    yg = rnn.gru_plain(*gd, lens)
    gb_args = (*gd, lens, yg, randn(B, T, h), None)
    check("gru_seq_bwd", rnn.gru_bwd_op, gb_args,
          lambda: (rnn.gru_bwd_op(*gb_args), rnn.gru_bwd_plain(*gb_args[:7])),
          TOL)

    rows, d, n = (OPS_SPARSE[k] for k in ("rows", "d", "n"))
    table = randn(rows + 1, 1, d)
    slot = randn(rows + 1, 1, d).abs()
    ids = torch.randint(0, rows, (n,), generator=g, device=dev)
    grads = randn(n, d)

    def tabs():
        return [table.clone(), slot.clone()]

    def updated(fn):
        t = tabs()
        fn(t)
        return t

    u_args = (tabs(), ids, grads, "momentum", 0.01, 0.9, n, rows)
    check("sparse_row_update", sr.rule_update_op, u_args,
          lambda: (updated(lambda t: sr.rule_update_op(t, *u_args[1:])),
                   updated(lambda t: sr._rule_update_plain(t, *u_args[1:]))),
          SPARSE_TOL)
    ga_args = (tabs(), ids, grads, n, rows)
    got = sr.gather_op(*ga_args)
    check("sparse_row_gather", sr.gather_op, ga_args,
          lambda: ((got[0], got[1], *got[2]),
                   (lambda p: (p[0], p[1], *p[2]))(
                       sr._gather_plain(*ga_args))), SPARSE_TOL)
    new = [x + 1.0 for x in got[2]]
    s_args = (tabs(), new, got[0], rows)
    check("sparse_row_scatter", sr.scatter_op, s_args,
          lambda: (updated(lambda t: sr.scatter_op(t, *s_args[1:])),
                   updated(lambda t: sr._scatter_plain(t, *s_args[1:]))),
          SPARSE_TOL)
    checked = {k.rsplit("_f32", 1)[0].rsplit("_bf16", 1)[0]
               .rsplit("_d256", 1)[0] for k in out}
    assert checked == set(_library.OPS), (checked, _library.OPS)
    print("ops opcheck " + json.dumps(out), flush=True)
    return out


def _outs_equal(name, got, want, tol):
    """The loaded program's {name: Arg} against eager `infer`'s numpy
    outputs: (bit-equal, max relative diff); asserts within tol."""
    worst, equal = 0.0, True
    for n, ref in want.items():
        a = got[n].value if got[n].value is not None else got[n].ids
        a = a.float().cpu().numpy()
        equal &= bool(np.array_equal(a, ref))
        scale = float(np.abs(ref).max()) or 1.0
        worst = max(worst, float(np.abs(a - ref).max()) / scale)
    assert worst <= tol, f"{name}: loaded vs eager {worst:.3g} > {tol}"
    return equal, worst


def export_round_trip(torch, name, inf, feed, counters, tol, dev="cuda"):
    """export_compiled / load_compiled of `inf`'s forward at `feed`: the
    times, the blob's bytes, the loaded call against eager `infer` (ms,
    outputs), the `paddle_tpu_torch::` nodes and the launch counters'
    rise during the loaded call (`counters`: [(module, counter name)])."""
    from paddle_tpu_torch import inference

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    eager = inf.infer(feed)      # warm
    blob, export_ms = wall(lambda: inference.export_compiled(inf, feed))
    fn, load_ms = wall(lambda: inference.load_compiled(blob, source=name))
    nodes = sorted({str(n.target) for n in fn.graph.nodes
                    if str(n.target).startswith("paddle_tpu_torch.")})

    def call():
        outs = fn(inf.params, inf.state, feed)
        return {n: (a.value if a.value is not None else a.ids).cpu()
                for n, a in outs.items()}

    call()                       # warm
    for mod, c in counters:
        setattr(mod, c, 0)
    got = fn(inf.params, inf.state, feed)
    torch.cuda.synchronize()
    rose = {c: getattr(mod, c) for mod, c in counters}
    loaded_ms = min(wall(call)[1] for _ in range(EXPORT_REPS))
    eager_ms = min(wall(lambda: inf.infer(feed))[1]
                   for _ in range(EXPORT_REPS))
    equal, worst = _outs_equal(name, got, eager, tol)
    r = {"export_s": export_ms / 1e3, "blob_bytes": len(blob),
         "load_s": load_ms / 1e3, "loaded_ms": loaded_ms,
         "eager_ms": eager_ms, "bit_equal": equal, "max_rel_diff": worst,
         "op_nodes": nodes, "launches": rose}
    print(f"export {name} " + json.dumps(r), flush=True)
    assert nodes, f"{name}: no paddle_tpu_torch node in the graph"
    if dev != "cpu":
        assert all(v > 0 for v in rose.values()), f"{name}: counters {rose}"
    return r


def exports(torch, fop, fa, rnn, dev="cuda"):
    """25b and 25c: ResNet-50 (fused, B1) in f32 and under the bf16 flag,
    the IMDB classifier at h = 512 (B5 on the grid route) and the LM's
    forward with flash attention (B4f) through export_compiled /
    load_compiled; then ResNet-50's forward through the verified cache,
    with an audit policy that passes and one that fails."""
    import tempfile

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.core.arg import id_arg
    from paddle_tpu_torch.models import lm as tlm
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.trainer import Inferencer
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    out = {}
    plain, fused, params, state = resnet_nets(torch)
    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    del plain, params, state
    feed = {"image": image_feed(EXPORT_RESNET_B, SEED + 251)["image"]}
    inf = Inferencer(fused, fparams, fstate, outputs=["output"], device=dev)
    for amp in (False, True):
        set_amp(amp)
        counter = "fwd_bf16_launches" if amp else "fwd_launches"
        name = f"resnet50_b{EXPORT_RESNET_B}" + ("_bf16" if amp else "")
        out[name] = export_round_trip(
            torch, name, inf, feed, [(fop, counter)],
            EXPORT_BF16_TOL if amp else 1e-5, dev)
        if dev != "cpu":
            assert out[name]["launches"][counter] == 29, out[name]
    set_amp(False)

    # 25c: the verified cache over ResNet-50's exported forward
    cache = tempfile.mkdtemp(prefix="phase25_cache_")
    args = (inf.params, inf.state, feed)
    t0 = time.perf_counter()
    meta = inference.store_verified(cache, "resnet50",
                                    inference.InferencerForward(inf), args,
                                    policy={"host_transfer_budget": 0})
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = inference.load_verified(cache, "resnet50", device=dev)
    boot_s = time.perf_counter() - t0
    fop.fwd_launches = 0
    got = prog(*args)
    torch.cuda.synchronize()
    b1 = fop.fwd_launches
    equal, worst = _outs_equal("verified resnet50", got, inf.infer(feed),
                               1e-5)
    refused = None
    try:
        inference.load_verified(cache, "resnet50", device=dev, policy={
            "n_instructions_max": meta["n_instructions"] - 1})
    except inference.VerifiedCacheError as e:
        refused = str(e)
    out["verified_resnet50"] = r = {
        "store_s": store_s, "boot_s": boot_s,
        "n_instructions": meta["n_instructions"],
        "host_transfers": meta["host_transfers"],
        "total_bytes": meta["total_bytes"], "bit_equal": equal,
        "max_rel_diff": worst, "b1_launches": b1, "refused": refused}
    print("verified cache " + json.dumps(r), flush=True)
    assert b1 == (0 if dev == "cpu" else 29), r
    assert meta["host_transfers"] == 0, r
    assert refused is not None and "n_instructions" in refused, r
    del inf, prog, got, fparams, fstate, fused
    torch.cuda.empty_cache()

    conf = stacked_lstm_classifier(**dict(CLS, hidden=CLS_WIDE[0]))
    net = Network(conf)
    cls, _nmt = text_feeds(SEED + 252, ragged=True)
    inf = Inferencer(net, net.init_params(
        torch.Generator().manual_seed(SEED), device=dev),
        outputs=["output"], device=dev)
    out["classifier_h512"] = export_round_trip(
        torch, "classifier_h512", inf, {"words": cls["words"]},
        [(rnn, "lstm_fwd_infer_launches"),
         (rnn, "lstm_fwd_infer_grid_launches")], 1e-5, dev)
    if dev != "cpu":
        assert out["classifier_h512"]["launches"] == {
            "lstm_fwd_infer_launches": 2, "lstm_fwd_infer_grid_launches": 2}

    spec = tlm.LMSpec(**SERVED_LM)
    net = Network(tlm.transformer_lm(spec))
    rng = np.random.default_rng(SEED + 253)
    B, T = EXPORT_LM["B"], EXPORT_LM["T"]
    lens = np.asarray(PROMPT_LENS[:B], np.int32)
    ids = rng.integers(2, spec.vocab, (B, T)).astype(np.int32)
    inf = Inferencer(net, net.init_params(
        torch.Generator().manual_seed(SEED), device=dev), device=dev)
    out["lm_flash"] = export_round_trip(
        torch, "lm_flash", inf, {"ids": id_arg(ids, lens, device=dev)},
        [(fa, "launches")], 1e-5, dev)
    if dev != "cpu":
        assert out["lm_flash"]["launches"]["launches"] == spec.num_layers
    return out


def guarded_classifier(torch, dev="cuda"):
    """25d(1): the classifier (h = 256) for two passes of GUARD_BATCHES
    under recompile_guard "strict" and steps_per_dispatch GUARD_K: the
    first pass captures its graph (the tail runs eagerly), the second is
    clean; then a batch of a new length raises RecompileError from the
    capture, before it begins (no graph is added)."""
    from paddle_tpu_torch.analysis.recompile_guard import RecompileError
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.arg import id_arg
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.trainer.trainer import SGD

    rng = np.random.default_rng(SEED + 254)

    def batches(n, t):
        return [(rng.integers(0, CLS["vocab_size"], (CLS_B, t)).astype(
            np.int32), np.full(CLS_B, t, np.int32),
            rng.integers(0, 2, CLS_B).astype(np.int32)) for _ in range(n)]

    def feeder(raw):
        return {"words": id_arg(raw[0], raw[1]), "label": id_arg(raw[2])}

    flags.set_flag("recompile_guard", "strict")
    try:
        sgd = SGD(stacked_lstm_classifier(**CLS),
                  OptimizationConf(learning_method="adam",
                                   learning_rate=CLS_LR),
                  steps_per_dispatch=GUARD_K, device=dev)
        warm = batches(GUARD_BATCHES, CLS_T)
        sgd.train(reader=lambda: iter(warm), feeder=feeder, num_passes=2)
        guard = sgd.step_fn.recompile_guard
        r = {"armed": guard.armed, "warmup_traces": guard.warmup_traces,
             "graphs_captured": sgd.graphs_captured,
             "violations_after_pass_2": len(sgd.recompile_violations())}
        raised = None
        try:
            sgd.train(reader=lambda: iter(batches(GUARD_K, GUARD_COLD_T)),
                      feeder=feeder, num_passes=1)
        except RecompileError as e:
            raised = str(e)
        r.update(raised=raised, violations=len(sgd.recompile_violations()),
                 graphs_after=sgd.graphs_captured)
    finally:
        flags.set_flag("recompile_guard", "off")
    print("guard classifier " + json.dumps(r), flush=True)
    assert r["armed"] and r["violations_after_pass_2"] == 0
    # the K = 4 chunk's capture (two notes, the chunk and its body) and
    # the eager tail's (a chunk of one: two notes)
    assert r["warmup_traces"] == 4, r
    want_graphs = 0 if dev == "cpu" else 1
    assert r["graphs_captured"] == want_graphs, r
    assert raised is not None and "train_step" in raised, r
    assert r["violations"] == 1 and r["graphs_after"] == want_graphs, r
    return r


def guarded_server(torch, gen):
    """25d(2): a GenerationModel server armed strictly after warmup: a
    request of a cold (batch, bucket) fails loudly (RecompileError, not
    rescued on the host rung), and the server keeps serving the warm
    bucket, its answer equal to the warmup's."""
    from paddle_tpu_torch.serving.models import GenerationModel
    from paddle_tpu_torch.serving.server import (
        InferenceServer,
        ServeConfig,
        ServeError,
    )

    dec = gen["decoder"](GEN_K)
    model = GenerationModel(dec, gen["params"], encode=gen["encode"])
    server = InferenceServer(ServeConfig(
        max_queue=8, max_batch=1, buckets=SERVE_GEN["buckets"],
        default_deadline_s=120.0, host_fallback=True))
    server.add_model("guarded", model)
    rng = np.random.default_rng(SEED + 255)
    warm_src = rng.integers(2, NMT["src_vocab"], 12).tolist()
    cold_src = rng.integers(2, NMT["src_vocab"], 20).tolist()
    try:
        first = server.submit("guarded", warm_src).result(300)
        armed = server.arm_recompile_guard(strict=True)
        t0 = time.perf_counter()
        failed = None
        try:
            server.submit("guarded", cold_src).result(300)
        except ServeError as e:
            failed = str(e)
        fail_ms = (time.perf_counter() - t0) * 1e3
        again = server.submit("guarded", warm_src).result(300)
        stats = server.stats()
        violations = server.recompile_violations()
    finally:
        server.disarm_recompile_guard()
        server.shutdown(drain=True)
    r = {"armed": [g.label for g in armed], "cold_failed": failed,
         "cold_ms": fail_ms, "warm_equal": again["tokens"] == first["tokens"],
         "violations": len(violations), "completed_host":
         stats["completed_host"], "failed": stats["failed"]}
    print("guard server " + json.dumps(r), flush=True)
    assert r["armed"] == ["beam_decode"], r
    assert failed is not None and "RecompileError" in failed, r
    assert r["warm_equal"] and r["violations"] == 1, r
    assert r["completed_host"] == 0 and r["failed"] == 1, r
    return r


def moe_conf():
    from paddle_tpu_torch import dsl

    with dsl.model() as g:
        x = dsl.data("x", MOE["d"])
        y = dsl.data("label", (1,), is_ids=True)
        m = dsl.moe(x, num_experts=MOE["experts"], hidden=MOE["hidden"],
                    capacity_factor=MOE["cf"], name="moe")
        out = dsl.fc(m, size=MOE["classes"], name="output")
        dsl.classification_cost(out, y, name="cost")
    return g.conf


def moe_steps(torch, dev, amp, params, feed):
    """MOE["steps"] adam steps of the moe conf on `dev` from `params`:
    each step's loss and aux."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep

    set_amp(amp)
    try:
        net = Network(moe_conf())
        opt = create_optimizer(OptimizationConf(
            learning_method="adam", learning_rate=MOE["lr"]),
            net.param_confs)
        step = TrainStep(net, opt, keep_outputs=["moe@aux"], device=dev)
        p = {k: v.to(dev) for k, v in params.items()}
        st, s = opt.init_state(p), net.init_state(dev)
        losses, auxes = [], []
        t0 = time.perf_counter()
        for i in range(MOE["steps"]):
            p, st, s, loss, outs = step(p, st, s, feed, i, None)
            losses.append(float(loss))
            auxes.append(float(outs["moe@aux"].value.detach().float().sum()))
        return losses, auxes, time.perf_counter() - t0
    finally:
        set_amp(False)


def moe_train(torch, dev="cuda"):
    """25e: the moe layer trained on the card, in f32 and under the bf16
    flag, against the same steps of the port on the CPU."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.network import Network

    net = Network(moe_conf())
    params = net.init_params(torch.Generator().manual_seed(SEED + 256),
                             device="cpu")
    rng = np.random.default_rng(SEED + 257)
    feed = {"x": non_seq(rng.standard_normal(
        (MOE["tokens"], MOE["d"])).astype(np.float32)),
        "label": id_arg(rng.integers(0, MOE["classes"], MOE["tokens"])
                        .astype(np.int32))}
    out = {}
    for amp in (False, True):
        card = moe_steps(torch, dev, amp, params, feed)
        cpu = moe_steps(torch, "cpu", amp, params, feed)
        tol = MOE_BF16_TOL if amp else MOE_TOL
        err = max(abs(a - b) / max(abs(b), 1e-6)
                  for a, b in zip(card[0] + card[1], cpu[0] + cpu[1]))
        name = "bf16" if amp else "f32"
        out[name] = r = {"losses": card[0], "aux": card[1],
                         "cpu_losses": cpu[0], "cpu_aux": cpu[1],
                         "max_rel_diff": err, "tol": tol, "card_s": card[2],
                         "cpu_s": cpu[2]}
        print(f"moe train {name} " + json.dumps(r), flush=True)
        assert all(np.isfinite(card[0] + card[1])), r
        assert err <= tol, f"moe {name}: card vs CPU {err:.3g} > {tol}"
    return out


def ops_export_guard_moe(torch, fop, fa, rnn, sr, gen, dev="cuda"):
    """Phase 25: 25a-25e, each under a phase line of its own."""
    out = {}
    phase("25a. every kernel's custom op: opcheck on the card, output "
          "against its plain version")
    out["ops"] = op_checks(torch, fop, fa, rnn, sr, dev)
    torch.cuda.empty_cache()
    phase("25b/c. export_compiled / load_compiled of ResNet-50, the IMDB "
          "classifier at h = 512 and the flash LM; the verified cache")
    out["exports"] = exports(torch, fop, fa, rnn, dev)
    torch.cuda.empty_cache()
    phase("25d. the recompile guard: the trainer and the server, strict")
    out["guard"] = {"classifier": guarded_classifier(torch, dev),
                    "server": guarded_server(torch, gen)}
    phase("25e. the moe layer trained on the card against the CPU")
    out["moe"] = moe_train(torch, dev)
    return out


# ---- phase 26: the mesh ----------------------------------------------------

# 26a/26b: bench_resnet50's fused ResNet-50 at B = 256 (momentum, as
# phases 9 and 9c); 26a's multi-step chunk
MESH_RESNET_B, MESH_K = 256, 10
# 26b: mc_lstm_h512_tbs256_dp2 (bench_multichip.py:178-196, :849-864):
# h = 512, 2 layers, total batch 256, T = 100, adam 2e-3
MESH_CLS = dict(CLS, hidden=512)
MESH_CLS_B, MESH_CLS_LR = 256, 2e-3
# 26c: mc_longctx_{ulysses,ring}_t32768_sp2 (bench_multichip.py:262-330):
# LONGCTX's widths at B = 1, T = 32 768, adam 1e-3, under the bf16 flag
MESH_LONGCTX_T, MESH_LONGCTX_STEPS = 32768, 3
# 26d: two fc stages at d = 1024, 8 microbatches of 256 rows
MESH_PIPE = dict(d=1024, micro=8, rows=256, steps=3)
# 26f: the tier at _bench_ctr_bigvocab's setting (24f's CTR_BIG), one
# shard a rank
MESH_TIER = dict(rows_total=CTR_BIG["ROWS_TOTAL"], dim=CTR_BIG["DIM"],
                 capacity=CTR_BIG["CAPACITY"],
                 num_slots=CTR_BIG["NUM_SLOTS"])
MESH_TIER_LR = 0.5
MESH_MOE_TOL = 1e-5
MESH_RANKS = 2


def mesh_resnet(fused=True):
    from paddle_tpu_torch.models.image import resnet
    from paddle_tpu_torch.network import Network

    return Network(resnet(50, (224, 224, 3), 1000, fused=fused))


def mesh_image_feed(batch, seed, dev="cuda"):
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    rng = np.random.default_rng(seed)
    image = rng.standard_normal((batch, 224, 224, 3)).astype(np.float32)
    label = rng.integers(0, 1000, batch).astype(np.int32)
    return {"image": non_seq(image, device=dev),
            "label": id_arg(label, device=dev)}


def mesh_step(torch, net, opt_kw, p, st, feed, mesh=None, amp=False,
              keep=None, steps=1, save_dir=None):
    """`steps` TrainSteps of `net` from (p, st) on `feed` (one feed, or
    a list), with a mesh or without: {loss, health, slots, state,
    params, ms, peak_gb, step}."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep

    set_amp(amp)
    try:
        opt = create_optimizer(OptimizationConf(**opt_kw), net.param_confs)
        step = TrainStep(net, opt, watchdog=True, device="cuda", mesh=mesh,
                         keep_outputs=keep)
        o = opt.init_state(p)
        if mesh is not None:
            p, o, st = step.place(p, o, st)
        feeds = feed if isinstance(feed, list) else [feed] * steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        healths, outs, ms = [], [], []
        for i, f in enumerate(feeds):
            t0 = time.perf_counter()
            p, o, st, h, out = step(p, o, st, f, i, None)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            healths.append(h)
            outs.append(out)
        if save_dir is not None:
            from paddle_tpu_torch.trainer.async_checkpoint import \
                AsyncCheckpointer

            with AsyncCheckpointer(save_dir) as ck:
                ck.save(0, p, o, st, shards=step.shard_layout(o))
            if mesh is not None and mesh.distributed:
                import torch.distributed as dist

                dist.barrier()  # every rank's shard file has landed
        return {"health": torch.stack(healths), "slots": o, "state": st,
                "params": p, "outs": outs, "ms": ms, "step": step,
                "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        set_amp(False)


def tree_np(tree):
    """Nested dicts of tensors as numpy on the host."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def tree_sums(tree):
    """{leaf path: (sum, sum of |x|)} in f64: a cross-rank fingerprint."""
    return {k: (float(v.double().sum()), float(v.double().abs().sum()))
            for k, v in leaves(tree).items()}


def max_rel(got, want):
    """max |got - want| / max |want| (numpy), 0 for an all-zero want."""
    scale = float(np.abs(want).max()) if want.size else 0.0
    return float(np.abs(got - want).max()) / scale if scale else 0.0


def rel_l2_np(got, want):
    n = float(np.linalg.norm(want.astype(np.float64)))
    d = float(np.linalg.norm((got - want).astype(np.float64)))
    return d / n if n else d


def rank_result(mesh, out, full=False):
    """What a rank hands back: the health rows, ms and peak memory, its
    host-staged bytes, a fingerprint of its slots and state; with `full`
    (rank 0) the slots and state themselves."""
    r = {"rank": mesh.rank, "health": out["health"].cpu().numpy().tolist(),
         "ms": out["ms"], "peak_gb": out["peak_gb"],
         "host_bytes": mesh.host_bytes,
         "sums": tree_sums({"slots": out["slots"], "state": out["state"]})}
    if full:
        r["slots"] = tree_np(out["slots"])
        r["state"] = tree_np(out["state"])
    return r


def rank_counts(mod, names):
    return {n: getattr(mod, n) for n in names}


def gate_fingerprints(torch, net, p, st, feed, mesh=None):
    """{gate site: [rows] int64}: per row of the batch a fingerprint of
    the ReLU gates (the signs) at each gate site of the fused ResNet
    graph (relu_gates' sites, the tail's in-gate recomputed), from one
    train-mode forward; on a mesh this rank's rows of the global batch.
    Two rows with one flipped gate differ (a sum of position hashes)."""
    from paddle_tpu_torch.core.mesh import batch_context
    from paddle_tpu_torch.layers.norm import bn_affine, moments

    def rows(v):
        g = (v > 0).reshape(v.shape[0], -1)
        pos = torch.arange(g.shape[1], device=g.device, dtype=torch.int64)
        h = (pos * 2654435761 + 12345) % 2147483647
        return (g * h).sum(1).cpu().numpy()

    out = {}
    with torch.no_grad(), batch_context(mesh):
        outs, _ = net.forward(p, feed, state=st, train=True)
        for name in net.order:
            lc = net.conf.layer(name)
            if (lc.type == "batch_norm" and lc.active_type == "relu"
                    or lc.type == "fused_conv1x1_bn"):
                vs = [outs[name].value]
            elif lc.type == "fused_bottleneck_tail":
                x = outs[lc.input_names()[0]].value
                scale, shift = bn_affine(p[f"_{name}.bnig"],
                                         p[f"_{name}.bnib"], *moments(x),
                                         1e-5)
                vs = [outs[name].value, x * scale + shift]
            else:
                continue
            out[name] = np.stack([rows(v) for v in vs])
        del outs
    return out


def mesh_rank_resnet(amp, save_dir=None):
    """26b's rank: the fused ResNet-50 DP step at a global B = 256 over
    the world's data axis (128 a rank), from the seed's weights; with
    `save_dir`, the step's pass saved async (every rank its shard file)
    and loaded back by rank 0, bit for bit."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.ops import bn_act_conv1x1 as fop

    mesh = tmesh.make_mesh({"data": -1})
    net = mesh_resnet()
    p = net.init_params(torch.Generator().manual_seed(SEED), device="cuda")
    feed = mesh_image_feed(MESH_RESNET_B, SEED + 260)
    for c in FUSED_COUNTERS:
        setattr(fop, c, 0)
    out = mesh_step(torch, net, RESNET_OPT, p, net.init_state("cuda"), feed,
                    mesh=mesh, amp=amp, save_dir=save_dir)
    r = rank_result(mesh, out, full=mesh.rank == 0)
    r["launches"] = rank_counts(fop, FUSED_COUNTERS)
    if not amp:
        del out["outs"]
        torch.cuda.empty_cache()
        set_amp(amp)
        try:
            from paddle_tpu_torch.parallel.dp import shard_feed

            r["gates"] = gate_fingerprints(torch, net, p,
                                           net.init_state("cuda"),
                                           shard_feed(feed, mesh), mesh)
        finally:
            set_amp(False)
    if save_dir is not None and mesh.rank == 0:
        from paddle_tpu_torch.trainer.async_checkpoint import load_pass

        tree, _meta = load_pass(save_dir)
        r["pass_bit_equal"] = all(
            np.array_equal(tree["params"][k], v.cpu().numpy())
            for k, v in out["params"].items()) and all(
            np.array_equal(tree["opt_state"][k][s], t.cpu().numpy())
            for k, slots in out["slots"].items() for s, t in slots.items())
    return r


def mesh_rank_blocks(feed_np, amp=True):
    """26b's holds on AMP_BLOCKS' net: the fused DP step (under the bf16
    flag with `amp`) over the data axis from the seed's weights (mapped
    from the plain net's); in f32 also the gate fingerprints of the
    rank's rows."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    mesh = tmesh.make_mesh({"data": -1})
    plain, fused = amp_blocks_net(False), amp_blocks_net(True)
    params = plain.init_params(torch.Generator().manual_seed(SEED),
                               device="cuda")
    fp, fs = fused_resnet_from_plain(fused, params, plain.init_state("cuda"))
    feed = {"image": non_seq(feed_np["image"], device="cuda"),
            "label": id_arg(feed_np["label"], device="cuda")}
    out = mesh_step(torch, fused, RESNET_OPT, fp, fs, feed, mesh=mesh,
                    amp=amp)
    r = rank_result(mesh, out, full=mesh.rank == 0)
    if not amp:
        from paddle_tpu_torch.parallel.dp import shard_feed

        r["gates"] = gate_fingerprints(torch, fused, fp, fs,
                                       shard_feed(feed, mesh), mesh)
    return r


def mesh_cls_feed(dev="cuda"):
    from paddle_tpu_torch.core.arg import id_arg

    rng = np.random.default_rng(SEED + 261)
    lens = rng.integers(1, CLS_T + 1, MESH_CLS_B).astype(np.int32)
    return {"words": id_arg(rng.integers(0, MESH_CLS["vocab_size"],
                                         (MESH_CLS_B, CLS_T))
                            .astype(np.int32), lens, device=dev),
            "label": id_arg(rng.integers(0, 2, MESH_CLS_B).astype(np.int32),
                            device=dev)}


def mesh_cls_net():
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.network import Network

    return Network(stacked_lstm_classifier(**MESH_CLS))


def mesh_rank_classifier(amp):
    """26b's rank: mc_lstm_h512_tbs256_dp2's classifier, one adam DP step
    at a global B = 256 with ragged lengths (B5/B6 on the grid route)."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.ops import rnn

    mesh = tmesh.make_mesh({"data": -1})
    net = mesh_cls_net()
    p = net.init_params(torch.Generator().manual_seed(SEED + 262),
                        device="cuda")
    zero_rnn_counts(rnn)
    out = mesh_step(torch, net, dict(learning_method="adam",
                                     learning_rate=MESH_CLS_LR), p, {},
                    mesh_cls_feed(), mesh=mesh, amp=amp)
    r = rank_result(mesh, out, full=mesh.rank == 0)
    r["launches"] = rnn_counts(rnn)
    return r


def mesh_longctx_conf(mode):
    """longctx_conf at LONGCTX's widths with `seq_parallel` = mode
    ("none": the one-rank flash step)."""
    conf = longctx_conf(attn_impl="flash", **LONGCTX)
    for lc in conf.layers:
        if lc.type == "multi_head_attention":
            lc.attrs["seq_parallel"] = mode
    return conf


def mesh_longctx_steps(torch, mode, mesh=None):
    """MESH_LONGCTX_STEPS adam steps of the long-context model under the
    bf16 flag at B = 1, T = 32 768 from the seed's weights: the health
    rows, the first step's first moments, ms, peak memory."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import params_from_numpy

    net = Network(mesh_longctx_conf(mode))
    opt = create_optimizer(OptimizationConf(
        learning_method="adam", learning_rate=LONGCTX_LR), net.param_confs)
    p = params_from_numpy(longctx_params(torch), "cuda")
    feed = longctx_feed(1, MESH_LONGCTX_T, classes=LONGCTX["classes"],
                        vocab=LONGCTX["vocab"])
    step = TrainStep(net, opt, watchdog=True, device="cuda", mesh=mesh)
    o = opt.init_state(p)
    set_amp(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        healths, ms, first = [], [], None
        for i in range(MESH_LONGCTX_STEPS):
            t0 = time.perf_counter()
            p, o, _s, h, _o = step(p, o, {}, feed, i, None)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            healths.append(h.cpu().numpy().tolist())
            if first is None:
                first = {k: {"m": v["m"].clone()} for k, v in o.items()}
        return {"health": healths, "m": first, "ms": ms,
                "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        set_amp(False)


def mesh_rank_longctx(mode):
    """26c's rank: the long-context model with seq_parallel = mode over
    a {data: 1, seq: 2} mesh (the flash kernels' bf16 forms on the
    Ulysses arm, counted)."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.ops import flash_attention as fa

    mesh = tmesh.make_mesh({"data": 1, "seq": -1})
    tmesh.set_mesh(mesh)
    for c in fa.COUNTERS:
        setattr(fa, c, 0)
    out = mesh_longctx_steps(torch, mode, mesh)
    r = {"rank": mesh.rank, "health": out["health"], "ms": out["ms"],
         "peak_gb": out["peak_gb"], "host_bytes": mesh.host_bytes,
         "launches": rank_counts(fa, fa.COUNTERS)}
    if mesh.rank == 0:
        r["m"] = tree_np(out["m"])
    return r


def mesh_pipe_inputs(torch):
    g = torch.Generator().manual_seed(SEED + 263)
    d, s = MESH_PIPE["d"], MESH_RANKS
    w = torch.randn((s, d, d), generator=g) / d ** 0.5
    b = 0.1 * torch.randn((s, d), generator=g)
    xs = torch.randn((MESH_PIPE["micro"], MESH_PIPE["rows"], d), generator=g)
    ct = torch.randn(xs.shape, generator=g)
    return w, b, xs, ct


def _pipe_stage(p, x):
    import torch

    return torch.relu(x @ p["w"] + p["b"])


def mesh_rank_pipeline():
    """26d's rank: GPipe over a {pipe: 2} mesh, one fc stage a rank, held
    against the sequential stack on the same rank: outputs and the
    gradients of its stage and of the microbatches under one cotangent
    within TOL of the largest entry."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.parallel import pipeline as tpipe

    mesh = tmesh.make_mesh({"pipe": -1})
    w, b, xs, ct = (t.to("cuda") for t in mesh_pipe_inputs(torch))
    stage = tpipe.shard_stacked_params(mesh, "pipe", {"w": w, "b": b})
    ms = []
    for _ in range(MESH_PIPE["steps"]):
        p = {k: v.detach().requires_grad_(True) for k, v in stage.items()}
        x = xs.detach().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tpipe.pipeline_apply(mesh, "pipe", _pipe_stage, p, x)
        grads = torch.autograd.grad(out, [p["w"], p["b"], x], ct)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    i = mesh.axis_index("pipe")
    ps = [{"w": w[s].detach().requires_grad_(True),
           "b": b[s].detach().requires_grad_(True)}
          for s in range(MESH_RANKS)]
    x = xs.detach().requires_grad_(True)
    h = x
    for sp in ps:
        h = _pipe_stage(sp, h)
    want = torch.autograd.grad(h, [ps[i]["w"], ps[i]["b"], x], ct)
    err = {"out": max_rel(out.detach().cpu().numpy(),
                          h.detach().cpu().numpy())}
    for name, a, c in zip(("dw", "db", "dx"), grads, want):
        if name == "dx" and i != 0:
            continue  # the microbatches' gradient reaches stage 0
        err[name] = max_rel(a.cpu().numpy(), c.cpu().numpy())
    return {"rank": mesh.rank, "stage": i, "ms": ms, "err": err,
            "host_bytes": mesh.host_bytes,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def mesh_moe_inputs(torch):
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.network import Network

    params = Network(moe_conf()).init_params(
        torch.Generator().manual_seed(SEED + 256), device="cpu")
    rng = np.random.default_rng(SEED + 257)
    feed = {"x": non_seq(rng.standard_normal(
        (MOE["tokens"], MOE["d"])).astype(np.float32), device="cuda"),
        "label": id_arg(rng.integers(0, MOE["classes"], MOE["tokens"])
                        .astype(np.int32), device="cuda")}
    return params, feed


def mesh_rank_moe():
    """26e's rank: the moe conf's adam steps with the experts over
    {data: 1, model: 2} (4 experts a rank, the dispatch an all-to-all)."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.network import Network

    mesh = tmesh.make_mesh({"data": 1, "model": -1})
    tmesh.set_mesh(mesh)
    params, feed = mesh_moe_inputs(torch)
    net = Network(moe_conf())
    out = mesh_step(torch, net, dict(learning_method="adam",
                                     learning_rate=MOE["lr"]),
                    {k: v.to("cuda") for k, v in params.items()},
                    net.init_state("cuda"), feed, mesh=mesh,
                    keep=["moe@aux"], steps=MOE["steps"])
    return {"rank": mesh.rank,
            "losses": [float(h[0]) for h in out["health"]],
            "aux": [float(o["moe@aux"].value.float().sum())
                    for o in out["outs"]],
            "experts_local": tuple(out["params"]["_moe.w0_in"].shape),
            "ms": out["ms"], "peak_gb": out["peak_gb"],
            "host_bytes": mesh.host_bytes}


def mesh_tier_stream():
    rng = np.random.default_rng(SEED + 264)
    hot = rng.integers(0, MESH_TIER["rows_total"], CTR_BIG["HOT"])
    n = CTR_BIG["BATCH"] * CTR_BIG["FEATS"]
    return [(hot[rng.integers(0, len(hot), n)],
             rng.standard_normal((n, MESH_TIER["dim"])).astype(np.float32))
            for _ in range(CTR_BIG["BATCHES"])]


def mesh_tier_run(torch, tss, table):
    for ids, grads in mesh_tier_stream():
        table.lookup(ids)
        table.update(ids, grads)
    torch.cuda.synchronize()
    return table.export_shards()


def mesh_rank_tier():
    """26f's rank: the sharded tier with one of its 2 shards on each rank
    of the data axis, every rank given the same stream; B9 updates the
    rank's rows."""
    import torch

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.ops import sparse_rows as sr
    from paddle_tpu_torch.parallel import sparse_shard as tss

    mesh = tmesh.make_mesh({"data": -1})
    table = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(**MESH_TIER), num_shards=MESH_RANKS,
        update_fn=tss.sgd_row_update(MESH_TIER_LR), device="cuda",
        mesh=mesh, axis="data")
    zero_sparse_counts(sr)
    t0 = time.perf_counter()
    payloads = mesh_tier_run(torch, tss, table)
    r = {"rank": mesh.rank, "wall_s": time.perf_counter() - t0,
         "local_shards": table.local_shards, "stats": dict(table.stats),
         "launches": sparse_counts(sr), "cache_rows": table._S}
    if mesh.rank == 0:
        r["payloads"] = payloads
    return r


def print_mesh(name, r):
    print(f"mesh {name} " + json.dumps(r, default=float), flush=True)


def mesh_one_rank_nccl(torch, op, work):
    """26a: a one-rank NCCL world on the card. The fused ResNet-50 AMP
    step at B = 256 through TrainStep(mesh={data: 1}) (its BN sums, the
    gradients' and the loss's all-reduces and the watchdog's min are
    NCCL calls) against the meshless step, 3 steps, bit-equal where two
    meshless runs agree (18c's rule); then `multi` at K = 10 as a CUDA
    graph with the NCCL calls captured, against two eager chunks of the
    mesh step by the same rule, and a second replay timed (it issues no
    collective from Python: they are in the graph)."""
    import torch.distributed as dist

    from paddle_tpu_torch.core import mesh as tmesh
    from paddle_tpu_torch.core import rng as trng
    from paddle_tpu_torch.parallel.dp import stack_feeds

    tmesh.distributed_init(num_processes=1, process_id=0, device="cuda",
                           store=dist.FileStore(
                               os.path.join(work, "nccl_store"), 1))
    out = {}
    try:
        mesh = tmesh.make_mesh({"data": 1})
        assert mesh.backend == "nccl" and mesh.distributed, mesh
        net = mesh_resnet()
        p0 = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cuda")
        s0 = net.init_state("cuda")
        feeds = [mesh_image_feed(MESH_RESNET_B, SEED + 265 + i)
                 for i in range(MESH_K)]
        for c in FUSED_COUNTERS:
            setattr(op, c, 0)
        arms = {}
        for arm, m in (("meshless", None), ("meshless_again", None),
                       ("mesh", mesh)):
            got = mesh_step(torch, net, RESNET_OPT, p0, s0, feeds[:3],
                            mesh=m, amp=True)
            arms[arm] = {"health": got["health"], **leaves(got["params"],
                         "param/"), **leaves(got["slots"], "slot/"),
                         **leaves(got["state"], "state/")}
            arms[arm + "_ms"] = got["ms"]
            del got
        nondet = held_graph_vs_eager(torch, "26a mesh vs meshless",
                                     arms["meshless"],
                                     arms["meshless_again"], arms["mesh"])
        out["three_steps"] = {
            "ms_meshless": arms["meshless_ms"], "ms_mesh": arms["mesh_ms"],
            "leaves_held": len(arms["mesh"]), "meshless_runs_differ": nondet,
            "health": arms["mesh"]["health"].cpu().numpy().tolist()}
        del arms
        torch.cuda.empty_cache()
        # K = 10: two eager chunks of the mesh step, then the graph
        from paddle_tpu_torch.core.config import OptimizationConf
        from paddle_tpu_torch.optimizers import create_optimizer
        from paddle_tpu_torch.parallel.dp import TrainStep

        root = trng.generator(SEED + 266, "cuda")
        chunks = {}
        set_amp(True)
        try:
            for arm in ("eager", "eager_again", "graph"):
                opt = create_optimizer(OptimizationConf(**RESNET_OPT),
                                       net.param_confs)
                step = TrainStep(net, opt, watchdog=True, device="cuda",
                                 mesh=mesh)
                p = {k: v.clone() for k, v in p0.items()}
                o = opt.init_state(p)
                s = {k: {sl: t.clone() for sl, t in v.items()}
                     for k, v in s0.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls0 = mesh.calls
                if arm == "graph":
                    # the first call: one warm-up step, then the capture
                    p, o, s, h, _ = step.multi(p, o, s, stack_feeds(feeds),
                                               0, root)
                else:
                    hs = []
                    for k, f in enumerate(feeds):
                        p, o, s, h1, _ = step(p, o, s, f, k,
                                              trng.split_for_step(root, k))
                        hs.append(h1)
                    h = torch.stack(hs)
                torch.cuda.synchronize()
                chunks[arm] = {"ms": (time.perf_counter() - t0) / MESH_K
                               * 1e3, "calls": mesh.calls - calls0,
                               "step": step, "p": p, "o": o, "s": s,
                               "held": {"health": h, **leaves(p, "param/"),
                                        **leaves(o, "slot/"),
                                        **leaves(s, "state/")}}
            g = chunks["graph"]
            nondet = held_graph_vs_eager(torch, "26a graph vs eager",
                                         chunks["eager"]["held"],
                                         chunks["eager_again"]["held"],
                                         g["held"])
            stacked = stack_feeds(feeds)
            calls0 = mesh.calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g["step"].multi(g["p"], g["o"], g["s"], stacked, MESH_K, root)
            torch.cuda.synchronize()
            replay_ms = (time.perf_counter() - t0) * 1e3
            replay_calls = mesh.calls - calls0
        finally:
            set_amp(False)
        out["graph"] = {
            "k": MESH_K, "graphs_captured": g["step"].graphs_captured,
            "ms_per_step_eager": chunks["eager"]["ms"],
            "ms_per_step_graph_first_chunk": g["ms"],
            "ms_per_step_replay": replay_ms / MESH_K,
            "collectives_per_eager_chunk": chunks["eager"]["calls"],
            "collectives_in_warmup_and_capture": g["calls"],
            "collectives_issued_by_a_replay": replay_calls,
            "eager_runs_differ": nondet,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "host_bytes": mesh.host_bytes}
        out["launches"] = rank_counts(op, FUSED_COUNTERS)
        print_mesh("26a one-rank nccl resnet50 amp b256", out)
        gr = out["graph"]
        assert gr["graphs_captured"] == 1, gr
        # the capture recorded the K steps' NCCL calls (and a warm-up
        # step's); a replay runs them without issuing any from Python
        assert gr["collectives_in_warmup_and_capture"] == \
            (MESH_K + 1) * gr["collectives_per_eager_chunk"] // MESH_K, gr
        assert gr["collectives_issued_by_a_replay"] == 0, gr
        assert mesh.host_bytes == 0, "a host copy under NCCL"
        for c in chunks.values():
            if c["step"].graphs is not None:
                c["step"].graphs.release()
        del chunks, g
    finally:
        dist.destroy_process_group()
        tmesh.set_mesh(None)
        torch.cuda.empty_cache()
    return out


def mesh_dp_resnet(torch, world, work):
    """26b (ResNet-50): the DP step over 2 gloo ranks sharing the card
    against the one-rank step at B = 256: f32 (loss, BN running
    statistics and every gradient within TOL of the largest entry) and
    under the bf16 flag (held as 9c(a) holds the fused AMP step: each
    gradient against the one-rank f32 step's within twice the one-rank
    AMP step's own distance + 1e-3, relative L2); then the bf16 hold
    that can fail, on AMP_BLOCKS' net (held_amp_blocks' rule and
    ceiling). The f32 ranks save an async pass, which rank 0 loads bit
    for bit and this process loads whole."""
    from paddle_tpu_torch.weights import fused_resnet_map

    net = mesh_resnet()
    p = net.init_params(torch.Generator().manual_seed(SEED), device="cuda")
    feed = mesh_image_feed(MESH_RESNET_B, SEED + 260)
    one = {}
    for amp in (False, True):
        got = mesh_step(torch, net, RESNET_OPT, p, net.init_state("cuda"),
                        feed, amp=amp)
        one[amp] = {"health": got["health"].cpu().numpy().tolist(),
                    "slots": tree_np(got["slots"]),
                    "state": tree_np(got["state"]), "ms": got["ms"],
                    "peak_gb": got["peak_gb"]}
        del got
        torch.cuda.empty_cache()
    gates = gate_fingerprints(torch, net, p, net.init_state("cuda"), feed)
    del p, feed
    torch.cuda.empty_cache()
    save_dir = os.path.join(work, "mesh_pass")
    ranks = {False: world.run(mesh_rank_resnet, False, save_dir),
             True: world.run(mesh_rank_resnet, True)}
    out = {}
    for amp, rs in ranks.items():
        r0, ref = rs[0], one[amp]
        assert all(r["sums"] == r0["sums"] for r in rs), "ranks differ"
        loss_rel = abs(r0["health"][0][0] - ref["health"][0][0]) / abs(
            ref["health"][0][0])
        state_rel = max(max_rel(r0["state"][l][s], ref["state"][l][s])
                        for l in ref["state"] for s in ref["state"][l])
        grad = {k: max_rel(r0["slots"][k]["mom"], ref["slots"][k]["mom"])
                for k in ref["slots"]}
        name = "bf16" if amp else "f32"
        r = {"loss_dp": r0["health"][0][0], "loss_one": ref["health"][0][0],
             "loss_rel": loss_rel, "state_rel_max": state_rel,
             "grad_rel_max": max(grad.values()),
             "grad_worst": max(grad, key=grad.get),
             "grad_rel_l2_max": max(
                 rel_l2_np(r0["slots"][k]["mom"], ref["slots"][k]["mom"])
                 for k in ref["slots"]),
             "finite": all(h[0][1] == 1.0 for h in (r0["health"],
                                                     ref["health"])),
             "ms_dp_rank": [r["ms"] for r in rs], "ms_one": ref["ms"],
             "peak_gb_rank": [r["peak_gb"] for r in rs],
             "peak_gb_one": ref["peak_gb"],
             "host_bytes_rank": [r["host_bytes"] for r in rs],
             "launches": {c: sum(r["launches"][c] for r in rs)
                          for c in FUSED_COUNTERS}}
        if amp:
            f32 = one[False]["slots"]
            own = {k: rel_l2_np(ref["slots"][k]["mom"], f32[k]["mom"])
                   for k in f32}
            dp = {k: rel_l2_np(r0["slots"][k]["mom"], f32[k]["mom"])
                  for k in f32}
            outside = [k for k in f32 if dp[k] > 2 * own[k] + 1e-3]
            r.update(bound="2 x the one-rank AMP step's relative L2 from "
                     "f32 + 1e-3", grads_outside_the_bound=outside,
                     dp_vs_f32_rel_l2_max=max(dp.values()),
                     one_vs_f32_rel_l2_max=max(own.values()))
        else:
            # phase 9's rule (`held_step`): a ReLU gate that flipped
            # between the two forwards moves every gradient below it, so
            # a gradient is held at TOL when its layer comes after every
            # gate site where a row of the DP forward flipped
            b = MESH_RESNET_B // MESH_RANKS
            flips = {n: sum(int((x["gates"][n] != gates[n][:, i * b:
                                                           (i + 1) * b])
                                .any(0).sum()) for i, x in enumerate(rs))
                     for n in gates}
            index = {n: i for i, n in enumerate(net.order)}
            top = max((index[n] for n, f in flips.items() if f), default=-1)
            owner = {g: layer for layer, slots in net.layer_params.items()
                     for g in slots.values()}
            held = {k: e for k, e in grad.items() if index[owner[k]] > top}
            free = {k: e for k, e in grad.items() if k not in held}
            r.update(bound=TOL, pass_bit_equal=r0["pass_bit_equal"],
                     gate_sites=len(gates),
                     rows_with_flips_by_site={n: f for n, f in flips.items()
                                              if f},
                     grads_held=len(held), grads_total=len(grad),
                     grad_rel_held_max=max(held.values(), default=0.0),
                     grad_rel_unheld_max=max(free.values(), default=0.0))
        print_mesh(f"26b dp resnet50 {name} b256 over {MESH_RANKS} ranks",
                   r)
        assert r["finite"], r
        if amp:
            assert r["loss_rel"] <= 0.05, r
            assert not outside, f"26b bf16: outside the bound: {outside}"
            assert all(r["launches"][c] for c in FUSED_COUNTERS
                       if "bf16" in c), r
        else:
            assert loss_rel <= TOL and state_rel <= TOL, r
            assert r["grad_rel_held_max"] <= TOL, r
            assert r0["pass_bit_equal"], "the saved pass did not load back"
            assert all(r["launches"][c] for c in FUSED_COUNTERS
                       if "bf16" not in c), r
        out[name] = r
    # this process loads the ranks' pass whole
    from paddle_tpu_torch.trainer.async_checkpoint import load_pass

    tree, meta = load_pass(save_dir)
    pmap, _smap = fused_resnet_map(net)
    out["pass"] = {"leaves": len(leaves(tree)), "meta": meta,
                   "shard_files": sorted(n for n in os.listdir(
                       os.path.join(save_dir, "pass-00000"))
                       if n.endswith(".npz"))}
    assert out["pass"]["shard_files"] == ["shard-p0.npz", "shard-p1.npz"]
    mom = ranks[False][0]["slots"]
    for k in mom:
        assert np.array_equal(tree["opt_state"][k]["mom"], mom[k]["mom"]), k
    print_mesh("26f async pass of the dp ranks", out["pass"])
    out["blocks"] = mesh_dp_blocks(torch, world)
    return out


def mesh_dp_blocks(torch, world):
    """26b's bf16 hold that can fail: held_amp_blocks' arms on one rank
    (plain f32, plain AMP) and the fused AMP DP step over 2 ranks; each
    DP gradient within twice the one-rank plain AMP step's distance from
    f32 + 1e-3 (relative L2), every bound below AMP_BOUND_CEILING."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.weights import fused_resnet_map

    plain, fused = amp_blocks_net(False), amp_blocks_net(True)
    params = plain.init_params(torch.Generator().manual_seed(SEED),
                               device="cuda")
    rng = np.random.default_rng(SEED + 32)
    b = AMP_BLOCKS["batch"]
    feed_np = {"image": rng.standard_normal(
        (b,) + AMP_BLOCKS["image"]).astype(np.float32),
        "label": rng.integers(0, 1000, b).astype(np.int32)}
    feed = {"image": non_seq(feed_np["image"], device="cuda"),
            "label": id_arg(feed_np["label"], device="cuda")}
    got = amp_arms(torch, plain, fused, params, plain.init_state("cuda"),
                   feed)
    rs = world.run(mesh_rank_blocks, feed_np)
    r0 = rs[0]
    pmap, _smap = fused_resnet_map(fused)
    m32, mp = got["plain_f32"][1], got["plain_amp"][1]
    dist, bounds = {}, {}
    for k, src in pmap.items():
        ref = m32[src]["mom"].float().cpu().numpy()
        own = rel_l2_np(mp[src]["mom"].float().cpu().numpy(), ref)
        bounds[k] = 2 * own + 1e-3
        dist[k] = rel_l2_np(r0["slots"][k]["mom"].reshape(ref.shape), ref)
    outside = [k for k in dist if dist[k] > bounds[k]]
    ref_loss = got["plain_f32"][0][0].item()
    r = {"net": AMP_BLOCKS, "ranks": MESH_RANKS,
         "loss_rel_vs_f32": abs(r0["health"][0][0] - ref_loss)
         / abs(ref_loss),
         "plain_amp_loss_rel": abs(got["plain_amp"][0][0].item() - ref_loss)
         / abs(ref_loss),
         "grads": len(dist), "grads_outside_the_bound": outside,
         "bound_max": max(bounds.values()),
         "worst_over_bound": max((dist[k] / bounds[k], k) for k in dist),
         "ms_rank": [x["ms"] for x in rs]}
    print_mesh("26b dp bf16 two res4 blocks", r)
    assert all(x["sums"] == r0["sums"] for x in rs), "ranks differ"
    assert r["loss_rel_vs_f32"] <= 2 * r["plain_amp_loss_rel"] + 1e-3, r
    assert not outside, f"26b blocks: outside the bound: {outside}"
    assert r["bound_max"] < AMP_BOUND_CEILING, r
    # f32 on the same net: loss, BN state and every gradient above the
    # highest gate site where a row flipped within TOL of the one-rank
    # fused step's (phase 9's rule)
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    fp, fs = fused_resnet_from_plain(fused, params, plain.init_state("cuda"))
    one = mesh_step(torch, fused, RESNET_OPT, fp, fs, feed)
    gates = gate_fingerprints(torch, fused, fp, fs, feed)
    rs = world.run(mesh_rank_blocks, feed_np, False)
    r0, half = rs[0], b // MESH_RANKS
    flips = {n: sum(int((x["gates"][n] != gates[n][:, i * half:
                                                   (i + 1) * half])
                        .any(0).sum()) for i, x in enumerate(rs))
             for n in gates}
    index = {n: i for i, n in enumerate(fused.order)}
    top = max((index[n] for n, f in flips.items() if f), default=-1)
    owner = {g: layer for layer, slots in fused.layer_params.items()
             for g in slots.values()}
    grad = {k: max_rel(r0["slots"][k]["mom"],
                       v["mom"].float().cpu().numpy())
            for k, v in one["slots"].items()}
    held = {k: e for k, e in grad.items() if index[owner[k]] > top}
    state = tree_np(one["state"])
    r32 = {"loss_rel": abs(r0["health"][0][0] - one["health"][0][0].item())
           / abs(one["health"][0][0].item()),
           "state_rel_max": max(max_rel(r0["state"][l][s], state[l][s])
                                for l in state for s in state[l]),
           "rows_with_flips_by_site": {n: f for n, f in flips.items() if f},
           "grads_held": len(held), "grads_total": len(grad),
           "grad_rel_held_max": max(held.values(), default=0.0),
           "grad_rel_max": max(grad.values()), "bound": TOL}
    print_mesh("26b dp f32 two res4 blocks", r32)
    assert r32["loss_rel"] <= TOL and r32["state_rel_max"] <= TOL, r32
    assert r32["grad_rel_held_max"] <= TOL, r32
    r["f32"] = r32
    return r


def mesh_dp_classifier(torch, world):
    """26b (classifier): mc_lstm_h512_tbs256_dp2's DP adam step over 2
    ranks against the one-rank step at B = 256: f32 within TOL of the
    largest entry (loss, every first moment); under the bf16 flag the DP
    step's gradients against the one-rank f32 step's as 13b holds the
    classifier's (`amp_grads_held`)."""
    net = mesh_cls_net()
    p = net.init_params(torch.Generator().manual_seed(SEED + 262),
                        device="cuda")
    ref = mesh_step(torch, net, dict(learning_method="adam",
                                     learning_rate=MESH_CLS_LR), p, {},
                    mesh_cls_feed())
    ref_m = tree_np(ref["slots"])
    ref_loss = float(ref["health"][0][0])
    out = {}
    for amp in (False, True):
        rs = world.run(mesh_rank_classifier, amp)
        r0 = rs[0]
        assert all(x["sums"] == r0["sums"] for x in rs), "ranks differ"
        grad = {k: max_rel(r0["slots"][k]["m"], ref_m[k]["m"])
                for k in ref_m}
        name = "bf16" if amp else "f32"
        r = {"loss_dp": r0["health"][0][0], "loss_one": ref_loss,
             "loss_rel": abs(r0["health"][0][0] - ref_loss) / abs(ref_loss),
             "grad_rel_max": max(grad.values()),
             "ms_dp_rank": [x["ms"] for x in rs], "ms_one": ref["ms"],
             "peak_gb_rank": [x["peak_gb"] for x in rs],
             "host_bytes_rank": [x["host_bytes"] for x in rs],
             "launches": {c: sum(x["launches"][c] for x in rs)
                          for c in RNN_COUNTERS
                          if any(x["launches"][c] for x in rs)}}
        print_mesh(f"26b dp classifier h512 {name} b256 over {MESH_RANKS} "
                   "ranks", r)
        assert r0["health"][0][1] == 1.0, r
        assert r["launches"].get("lstm_fwd_grid_launches") and \
            r["launches"].get("lstm_bwd_grid_launches"), r
        if amp:
            assert r["loss_rel"] <= 0.05, r
            got = {k: {"m": torch.from_numpy(v["m"])}
                   for k, v in r0["slots"].items()}
            want = {k: {"m": torch.from_numpy(v["m"])}
                    for k, v in ref_m.items()}
            r["grad_rel_vs_f32_max"] = amp_grads_held(
                "26b dp classifier", "classifier", got, want, "m")
        else:
            assert r["loss_rel"] <= TOL and r["grad_rel_max"] <= TOL, r
        out[name] = r
    return out


def mesh_seq_parallel(torch, world):
    """26c: the long-context model at T = 32 768 with Ulysses (flash
    locally: B4f/B4b's bf16 forms) and with the ring over {data: 1,
    seq: 2}, 3 adam steps each under the bf16 flag, against the one-rank
    flash step: every loss within 5% and the first step's gradients
    (adam's first moments) held as 6d holds its own (`amp_grads_held`)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    ref = mesh_longctx_steps(torch, "none")
    ref_m = {k: {"m": v["m"].float().cpu()} for k, v in ref["m"].items()}
    del ref["m"]
    torch.cuda.empty_cache()
    out = {}
    for mode in ("ulysses", "ring"):
        rs = world.run(mesh_rank_longctx, mode)
        r0 = rs[0]
        losses = [h[0] for h in r0["health"]]
        rel = [abs(a - h[0]) / abs(h[0])
               for a, h in zip(losses, ref["health"])]
        r = {"losses": losses, "one_rank_losses": [h[0] for h in
                                                   ref["health"]],
             "loss_rel": rel, "bound_loss_rel": 0.05,
             "ms_rank": [x["ms"] for x in rs], "ms_one": ref["ms"],
             "peak_gb_rank": [x["peak_gb"] for x in rs],
             "peak_gb_one": ref["peak_gb"],
             "host_bytes_rank": [x["host_bytes"] for x in rs],
             "launches": {c: sum(x["launches"][c] for x in rs)
                          for c in fa.COUNTERS}}
        print_mesh(f"26c {mode} t{MESH_LONGCTX_T} seq2", r)
        assert all(h[1] == 1.0 for h in r0["health"]), r
        assert max(rel) <= 0.05, r
        got = {k: {"m": torch.from_numpy(v["m"])} for k, v in r0["m"].items()}
        r["grad_rel_max"] = amp_grads_held(f"26c {mode}", "longctx", got,
                                           ref_m, "m")
        if mode == "ulysses":
            layers = LONGCTX["layers"] * MESH_LONGCTX_STEPS * MESH_RANKS
            assert r["launches"]["bf16_launches"] == layers, r
            assert r["launches"]["bwd_dkv_bf16_launches"] == layers, r
            assert r["launches"]["bwd_dq_bf16_launches"] == layers, r
        else:
            assert not any(r["launches"].values()), r
        out[mode] = r
    return out


def mesh_pipeline(torch, world):
    """26d: GPipe over 2 ranks, held on each rank against the stack."""
    rs = world.run(mesh_rank_pipeline)
    r = {"stages": MESH_RANKS, **MESH_PIPE, "ms_rank": [x["ms"] for x in rs],
         "err": [x["err"] for x in rs], "bound": TOL,
         "peak_gb_rank": [x["peak_gb"] for x in rs],
         "host_bytes_rank": [x["host_bytes"] for x in rs]}
    print_mesh("26d pipeline 2 stages d1024", r)
    assert sorted(x["stage"] for x in rs) == list(range(MESH_RANKS))
    assert all(e <= TOL for x in rs for e in x["err"].values()), r
    assert all(x["host_bytes"] > 0 for x in rs), "no hop went through host"
    return r


def mesh_moe(torch, world):
    """26e: the moe conf with its experts over model = 2 against one
    rank's steps: losses and aux within MESH_MOE_TOL (f32)."""
    params, feed = mesh_moe_inputs(torch)
    one = moe_steps(torch, "cuda", False, params, feed)
    rs = world.run(mesh_rank_moe)
    r0 = rs[0]
    err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in
              zip(r0["losses"] + r0["aux"], one[0] + one[1]))
    r = {"losses": r0["losses"], "aux": r0["aux"], "one_rank_losses": one[0],
         "one_rank_aux": one[1], "max_rel_diff": err, "tol": MESH_MOE_TOL,
         "experts_local": r0["experts_local"],
         "ms_rank": [x["ms"] for x in rs],
         "peak_gb_rank": [x["peak_gb"] for x in rs],
         "host_bytes_rank": [x["host_bytes"] for x in rs]}
    print_mesh("26e moe experts over model 2", r)
    assert all(x["losses"] == r0["losses"] for x in rs), r
    assert r0["experts_local"][0] == MOE["experts"] // MESH_RANKS, r
    assert err <= MESH_MOE_TOL, r
    return r


def mesh_tier(torch, world):
    """26f: the tier with one shard a rank against the one-process
    two-shard tier on the card: the export payloads equal."""
    from paddle_tpu_torch.parallel import sparse_shard as tss

    one = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(**MESH_TIER), num_shards=MESH_RANKS,
        update_fn=tss.sgd_row_update(MESH_TIER_LR), device="cuda")
    want = mesh_tier_run(torch, tss, one)
    rs = world.run(mesh_rank_tier)
    err = payloads_close(rs[0]["payloads"], want, "26f tier")
    r = {"shards": MESH_RANKS, **MESH_TIER, "batches": CTR_BIG["BATCHES"],
         "export_max_rel_err": err, "wall_s_rank": [x["wall_s"] for x in rs],
         "stats_rank": [x["stats"] for x in rs], "one_stats": one.stats,
         "cache_rows_rank": [x["cache_rows"] for x in rs],
         "launches": {c: sum(x["launches"][c] for x in rs)
                      for c in SPARSE_COUNTERS}}
    print_mesh("26f tier one shard a rank", r)
    assert [x["local_shards"] for x in rs] == [[i] for i in
                                              range(MESH_RANKS)], r
    for key in ("hits", "misses", "evictions"):
        assert sum(x["stats"][key] for x in rs) == one.stats[key], r
    assert all(x["launches"]["sparse_row_update_launches"]
               == CTR_BIG["BATCHES"] for x in rs), r
    return r


def the_mesh(torch, op, work):
    """Phase 26: 26a in this process (a one-rank NCCL world), 26b-26f in
    one gloo world of 2 ranks sharing the card (spawned once, after the
    kernels were built in phase 2)."""
    from paddle_tpu_torch.parallel.world import World

    out = {}
    t0 = time.perf_counter()
    phase("26a. a one-rank NCCL world: ResNet-50 AMP at B = 256 through "
          "TrainStep(mesh={data: 1}), and a CUDA graph of 10 steps with "
          "the NCCL calls captured")
    out["a"] = mesh_one_rank_nccl(torch, op, work)
    with World(MESH_RANKS, os.path.join(work, "world"), device="cuda",
               timeout=600) as world:
        phase("26b. DP over 2 gloo ranks sharing the card: ResNet-50 and "
              "the h = 512 classifier against the one-rank step")
        out["b"] = mesh_dp_resnet(torch, world, work)
        out["b_cls"] = mesh_dp_classifier(torch, world)
        phase("26c. sequence parallel at T = 32 768: Ulysses (flash) and "
              "the ring over {data: 1, seq: 2}")
        out["c"] = mesh_seq_parallel(torch, world)
        phase("26d. the pipeline: 2 fc stages at d = 1024, 8 microbatches")
        out["d"] = mesh_pipeline(torch, world)
        phase("26e. moe with its experts over model = 2")
        out["e"] = mesh_moe(torch, world)
        phase("26f. the sharded tier with one shard a rank")
        out["f"] = mesh_tier(torch, world)
    out["seconds"] = time.perf_counter() - t0
    print(f"mesh phase 26 seconds {out['seconds']:.1f}", flush=True)
    return out


# ---- phase 27: the v1-era runtime ----------------------------------------

# the IMDB classifier at bench.py::bench_lstm's setting (:536-556; vocab
# 30 000, emb 128, 2 LSTM layers, fixed T = 100, adam 2e-3, B = 64) at
# h = 512, written as a v1 config (the reference's own benchmark model,
# benchmark/paddle/rnn/rnn.py, is one; max-pooled as
# models/text.py::stacked_lstm_classifier) and driven through the v1 API
V1_CLS = dict(vocab=30000, emb=128, hidden=512, layers=2, batch_size=64)
V1_T = 100
V1_BATCHES = 64           # one pass: bench_lstm's seeded feed, 64 batches
V1_CHUNK = 256            # samples a recordio file (convert's line_count)
V1_HELD = 3               # v1 steps held against TrainStep, bit for bit
V1_KILL_AT = 7            # chunks acked before the master is SIGKILLed
V1_TIME_STEPS = 10        # TrainStep eager steps timed beside the v1 loop
PY2_STEPS = 5
CAPI_EXAMPLES = ("dense", "sequence", "sparse_binary", "multi_thread")
CAPI_CALLS = 5            # in-process C ABI calls after the first
CAPI_THREADS = 4          # threads calling the C ABI at once
CAPI_TOL = 1e-6           # the examples print %.6f
PROC_TIMEOUT = 300        # any subprocess of phase 27

V1_CLS_CONFIG = """\
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 30000)
settings(batch_size=get_config_arg("batch_size", int, 64),
         learning_rate=2e-3, learning_method=AdamOptimizer())

net = data_layer(name="words", size=vocab)
net = embedding_layer(input=net, size=get_config_arg("emb", int, 128))
for i in range(get_config_arg("layers", int, 2)):
    net = simple_lstm(input=net, size=get_config_arg("hidden", int, 512),
                      name="lstm%d" % i)
net = pooling_layer(input=net, pooling_type=MaxPooling())
output = fc_layer(input=net, size=2, act=SoftmaxActivation(), name="output")
label = data_layer(name="label", size=2)
outputs(classification_cost(input=output, label=label))
"""

# a python-2 API driver in the shape of v1_api_demo/quick_start/
# api_train.py: argv = config, config args, a model to load, a pickle of
# batches, steps, use_gpu
PY2_DRIVER = """\
import sys
import cPickle

from py_paddle import swig_paddle, DataProviderConverter
from paddle.trainer.PyDataProvider2 import (integer_value,
                                           integer_value_sequence)
from paddle.trainer.config_parser import parse_config

LOSSES = []


def main():
    config, config_args, model, data, steps, use_gpu = sys.argv[1:7]
    swig_paddle.initPaddle("--use_gpu=" + use_gpu)
    conf = parse_config(config, config_args)
    args = dict(kv.split("=") for kv in config_args.split(","))
    m = swig_paddle.GradientMachine.createFromConfigProto(conf.model_config)
    m.loadParameters(model)
    updater = swig_paddle.ParameterUpdater.createLocalUpdater(
        conf.opt_config)
    updater.init(m)
    converter = DataProviderConverter(
        [integer_value_sequence(int(args["vocab"])), integer_value(2)])
    batches = cPickle.load(open(data, "rb"))
    out_args = swig_paddle.Arguments.createArguments(0)
    updater.startPass()
    for i in xrange(int(steps)):
        batch = batches[i % len(batches)]
        updater.startBatch(len(batch))
        cost = m.forwardBackward(converter(batch), out_args,
                                 swig_paddle.PASS_TRAIN)
        for param in m.getParameters():
            updater.update(param)
        updater.finishBatch(cost)
        LOSSES.append(cost)
        print "step %d cost %.6f" % (i, cost)
    updater.finishPass()


if __name__ == "__main__":
    main()
"""


def write_v1_cls(work, **config_args):
    """The v1 classifier config in `work`; returns its path and its
    --config_args string (V1_CLS, overridden by `config_args`)."""
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "v1_cls.py")
    with open(path, "w") as f:
        f.write(V1_CLS_CONFIG)
    args = dict(V1_CLS, **config_args)
    return path, ",".join(f"{k}={v}" for k, v in sorted(args.items()))


class SmokeProc:
    """A subprocess of the checkout whose stdout lines are read on a
    thread, so that every wait has its own timeout; `stop()` kills it."""

    def __init__(self, cmd, env=None):
        import queue

        self.cmd = cmd
        self.p = subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env or dict(os.environ, PYTHONPATH=REPO))
        self.lines, self.err = queue.Queue(), []
        for f, out in ((self.p.stdout, True), (self.p.stderr, False)):
            threading.Thread(target=self._pump, args=(f, out),
                             daemon=True).start()

    def _pump(self, f, out):
        for line in f:
            (self.lines.put if out else self.err.append)(line.rstrip("\n"))

    def wait_line(self, prefix, timeout=PROC_TIMEOUT):
        import queue

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=0.5)
            except queue.Empty:
                if self.p.poll() is not None:
                    break
                continue
            if line.startswith(prefix):
                return line
        self.stop()
        raise AssertionError(f"no {prefix!r} line from {self.cmd}:\n"
                             + "\n".join(self.err[-40:]))

    def join(self, timeout=PROC_TIMEOUT):
        try:
            return self.p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{self.cmd} did not exit in {timeout} s")

    def stop(self):
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=30)


def v1_records(work):
    """Phase 27(a): the port's native runtime and C ABI library built
    with g++ from their own sources, then bench_lstm's seeded
    feed, V1_BATCHES batches of (ids, label, index) records, written
    through dataset.common.convert into recordio chunks and read back
    equal."""
    from paddle_tpu_torch.data import reader as R
    from paddle_tpu_torch.data.dataset import common
    from paddle_tpu_torch import native
    from paddle_tpu_torch.native.recordio import count_chunks

    built = {}
    for name, build in (("native_build_s", native.build),
                        ("capi_build_s", native.build_capi)):
        t0 = time.perf_counter()
        build()
        built[name] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    bs, records = V1_CLS["batch_size"], []
    for _ in range(V1_BATCHES):
        # bench_lstm's draws: the first batch is its feed
        ids = rng.integers(0, V1_CLS["vocab"], (bs, V1_T)).astype(np.int32)
        lab = rng.integers(0, 2, bs).astype(np.int32)
        records += [(ids[i].tolist(), int(lab[i]), len(records) + i)
                    for i in range(bs)]
    t3 = time.perf_counter()
    paths = common.convert(os.path.join(work, "records"),
                           lambda: iter(records), V1_CHUNK, "imdb_lstm")
    t4 = time.perf_counter()
    back = list(R.recordio(paths)())
    t5 = time.perf_counter()
    assert back == records, "recordio read back differs"
    r = {**built, "records": len(records), "files": len(paths),
         "chunks": sum(count_chunks(p) for p in paths),
         "bytes": sum(os.path.getsize(p) for p in paths),
         "write_s": t4 - t3, "read_s": t5 - t4}
    print("v1 records " + json.dumps(r), flush=True)
    return paths, records, r


def v1_elastic(torch, rnn, work, paths, records, dev="cuda"):
    """Phase 27(b): `python -m paddle_tpu_torch master` over the chunks
    (a subprocess), and the classifier trained one pass through
    `reader.elastic(MasterClient)` -> DataProviderConverter ->
    Arguments -> GradientMachine.forwardBackward(PASS_TRAIN) +
    ParameterUpdater, every parameter set through its inplace mirror
    first (the testTrain idiom, so each step syncs and refreshes them).
    The first V1_HELD steps are held bit for bit (loss, every parameter
    and slot) against TrainStep from the same weights on the same
    batches. After V1_KILL_AT acked chunks the master is SIGKILLed and
    restarted from its snapshot on the same port: every chunk is trained
    exactly once, every record once. B5 and B6 on the grid route, twice
    a step (the held arm's launches taken out)."""
    from paddle_tpu_torch.compat import swig_api as api
    from paddle_tpu_torch.compat.config_parser import parse_config
    from paddle_tpu_torch.compat.py_paddle import DataProviderConverter
    from paddle_tpu_torch.data import reader as R
    from paddle_tpu_torch.data.feeder import integer_value, \
        integer_value_sequence
    from paddle_tpu_torch.data.master_client import MasterClient
    from paddle_tpu_torch.native.recordio import count_chunks
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import params_from_numpy

    config, config_args = write_v1_cls(work)
    tc = parse_config(config, config_args)
    api.initPaddle(f"--use_gpu={int(dev == 'cuda')}")
    gm = api.GradientMachine.createFromConfigProto(tc.model_config)
    gm.randParameters(SEED + 27)
    init = {k: v.cpu().numpy() for k, v in gm.params.items()}
    for p in gm.getParameters():
        p.getBuf(api.PARAMETER_VALUE).toNumpyArrayInplace()[:] = \
            init[p.getName()].ravel()
    updater = api.ParameterUpdater.createLocalUpdater(tc.opt_config)
    updater.init(gm)
    converter = DataProviderConverter(
        [integer_value_sequence(V1_CLS["vocab"]), integer_value(2)])
    net = Network(tc.model_config)
    step = TrainStep(net, create_optimizer(tc.opt_config, net.param_confs),
                     device=dev)
    ref_p = params_from_numpy(init, device=dev)
    ref_o = step.opt.init_state(ref_p)
    ref_s = net.init_state(dev)

    snap = os.path.join(work, "master.snap")
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "master", *paths,
           "--timeout", "600", "--snapshot", snap]
    procs = [SmokeProc(cmd)]
    procs[0].wait_line("elastic master over")
    port = int(procs[0].wait_line("LISTENING").split()[1])
    restart = {}

    class Acking(MasterClient):
        """Logs the acked chunks and snapshots the master after each ack
        (a deterministic snapshot point); the V1_KILL_AT-th ack SIGKILLs
        the master and restarts it from the snapshot."""

        acked, leases = [], {}

        def get_task(self):
            t = super().get_task()
            if t is not None:
                self.leases[t[0]] = t[1].decode()
            return t

        def task_done(self, task_id):
            ok = super().task_done(task_id)
            assert ok, f"lease {task_id} lost"
            self.acked.append(self.leases[task_id])
            self.snapshot()
            if len(self.acked) == V1_KILL_AT:
                t0 = time.perf_counter()
                procs[-1].p.kill()
                procs[-1].join()
                procs.append(SmokeProc(cmd + ["--port", str(port)]))
                line = procs[-1].wait_line("elastic master")
                assert "restored from" in line, line
                procs[-1].wait_line("LISTENING")
                restart.update(s=time.perf_counter() - t0, line=line)
            return ok

    client = Acking(f"127.0.0.1:{port}", retry_seconds=120)
    out_args = api.Arguments.createArguments(0)
    losses, step_ms, trained, feeds, held = [], [], [], [], []
    ref_launched = dict.fromkeys(RNN_COUNTERS, 0)
    mb0 = dict(gm.mirror_bytes)
    try:
        zero_rnn_counts(rnn)
        t_pass = time.perf_counter()
        for i, batch in enumerate(R.batched(R.elastic(client),
                                            V1_CLS["batch_size"])()):
            t0 = time.perf_counter()
            in_args = converter(batch)
            updater.startBatch(len(batch))
            cost = gm.forwardBackward(in_args, out_args, api.PASS_TRAIN)
            for p in gm.getParameters():
                updater.update(p)
            updater.finishBatch(cost)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(cost)
            trained += [s[2] for s in batch]
            if len(feeds) < V1_TIME_STEPS:
                feeds.append(in_args._feed(net.input_names))
            if i < V1_HELD:
                before = rnn_counts(rnn)
                ref_p, ref_o, ref_s, loss, _ = step(ref_p, ref_o, ref_s,
                                                    feeds[i], i, None)
                for c, n in rnn_counts(rnn).items():
                    ref_launched[c] += n - before[c]
                d = {"loss": abs(float(loss) - cost)}
                d["params"] = max(float((gm.params[k] - v).abs().max())
                                  for k, v in ref_p.items())
                d["slots"] = max(float((updater._opt_state[k][s] - t)
                                       .abs().max())
                                 for k, v in ref_o.items()
                                 for s, t in v.items())
                d["bit_equal"] = (float(loss) == cost and all(
                    torch.equal(gm.params[k], v) for k, v in ref_p.items())
                    and all(torch.equal(updater._opt_state[k][s], t)
                            for k, v in ref_o.items()
                            for s, t in v.items()))
                held.append(d)
        pass_s = time.perf_counter() - t_pass
        launched = {c: n - ref_launched[c]
                    for c, n in rnn_counts(rnn).items()}
        assert client.pass_finished()
        client.shutdown()
        assert procs[-1].join() == 0
    finally:
        for p in procs:
            p.stop()
    steps = len(losses)
    n_tasks = sum(count_chunks(p) for p in paths)
    chunks = [json.loads(a) for a in client.acked]
    mirror = {k: (gm.mirror_bytes[k] - mb0[k]) / steps for k in mb0}
    param_bytes = sum(t.numel() * t.element_size()
                      for t in gm.params.values())
    # TrainStep's eager ms on the same feeds, the mirrors' sync and
    # refresh alone, and v1 steps with no mirror registered: where the
    # v1 loop's host time goes
    def timed(fn):
        sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        return (time.perf_counter() - t0) * 1e3

    def ref_step(f):
        nonlocal ref_p, ref_o, ref_s
        ref_p, ref_o, ref_s, loss, _ = step(ref_p, ref_o, ref_s, f, 0, None)
        float(loss)

    def v1_step(f):
        args = api.Arguments.createArguments(0)
        for k, a in zip(net.input_names, f.values()):
            args._setSlotArg(len(args._slots), a)
        updater.startBatch(V1_CLS["batch_size"])
        cost = gm.forwardBackward(args, out_args, api.PASS_TRAIN)
        for p in gm.getParameters():
            updater.update(p)
        updater.finishBatch(cost)

    times = [timed(lambda: ref_step(f)) for f in feeds]
    sync_ms = [timed(gm._sync_views) for _ in range(5)]
    refresh_ms = [timed(gm._refresh_views) for _ in range(5)]
    views, gm._inplace_views = gm._inplace_views, {}
    bare_ms = [timed(lambda: v1_step(f)) for f in feeds]
    gm._inplace_views = views
    gm._refresh_views()
    r = {"steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
         "held": held, "pass_s": pass_s,
         "v1_ms_per_step_median": float(np.median(step_ms[V1_HELD:])),
         "v1_ms_per_step": [round(x, 3) for x in step_ms],
         "trainstep_eager_ms_median": float(np.median(times[1:])),
         "mirror_sync_ms_median": float(np.median(sync_ms)),
         "mirror_refresh_ms_median": float(np.median(refresh_ms)),
         "v1_no_mirror_ms_median": float(np.median(bare_ms[1:])),
         "mirror_bytes_per_step": mirror, "param_bytes": param_bytes,
         "master_restart_s": restart.get("s"), "acked": len(chunks),
         "tasks": n_tasks, "launches": {k: v for k, v in launched.items()
                                        if v}}
    print("v1 elastic " + json.dumps(r), flush=True)
    assert steps == V1_BATCHES and np.isfinite(losses).all(), r
    assert len(procs) == 2 and restart, "the master was not restarted"
    assert sorted(json.dumps(c, sort_keys=True) for c in chunks) == sorted(
        json.dumps({"chunk": k, "path": p}, sort_keys=True)
        for p in paths for k in range(count_chunks(p))), chunks
    assert sorted(trained) == list(range(len(records))), "a record twice"
    for d in held:
        assert d["bit_equal"], f"v1 step vs TrainStep: {held}"
    if dev == "cuda":
        assert mirror == {"h2d": param_bytes, "d2h": param_bytes}, mirror
        n = 2 * steps
        want = dict.fromkeys(RNN_COUNTERS, 0)
        want.update(lstm_fwd_launches=n, lstm_fwd_grid_launches=n,
                    lstm_bwd_launches=n, lstm_bwd_grid_launches=n)
        assert launched == want, f"v1 loop launches {launched}"
    return {"r": r, "gm": gm, "tc": tc, "config": (config, config_args),
            "launches": launched}


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _capi_small_model(work):
    """The JAX C-ABI tests' dense model (x: 8 -> fc 16 tanh -> fc 3
    "output"), seeded, merged; returns (path, Network, params)."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    with dsl.model() as g:
        x = dsl.data("x", 8)
        y = dsl.data("y", 1, is_ids=True)
        h = dsl.fc(x, size=16, act="tanh")
        out = dsl.fc(h, size=3, name="output")
        dsl.classification_cost(out, y, name="cost")
    net = Network(g.conf)
    params = {k: v.numpy() for k, v in
              net.init_params(_rng.generator(SEED + 28), "cpu").items()}
    path = os.path.join(work, "dense_merged.npz")
    ckpt.merge_model(path, g.conf, params)
    return path, net, params


def capi_examples(torch, rnn, work, gm, tc, dev="cuda"):
    """Phase 27(c): the C inference ABI. `libpaddle_tpu_torch_capi.so`
    (built in (a)) and the four example programs built with cc from the
    port's copy; 27(b)'s model merged. Each example runs in its own
    process on `dev` (all four at once): `sequence` on the classifier,
    its output equal to in-process `Inferencer.infer` on the card at
    CAPI_TOL; `dense`, `sparse_binary` and `multi_thread` (4 threads x 5
    calls, all equal) on the JAX tests' small dense model. Then the
    classifier through `ctypes` in this process (`pt_capi_init` reuses
    the running interpreter), counting B5's inference launches: the
    first call's ms and CAPI_CALLS more; a bad path's error text."""
    import ctypes as C

    from paddle_tpu_torch import native
    from paddle_tpu_torch.core.arg import id_arg, non_seq
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    from paddle_tpu_torch.trainer.trainer import Inferencer
    from paddle_tpu_torch.weights import params_to_numpy, state_to_numpy

    lib = native.build_capi()
    merged = os.path.join(work, "cls_merged.npz")
    ckpt.merge_model(merged, tc.model_config, params_to_numpy(gm.params),
                     state_to_numpy(gm.state))
    small, _snet, _sp = _capi_small_model(work)
    t0 = time.perf_counter()
    builds = {n: subprocess.Popen(
        ["cc", os.path.join(native.EXAMPLES_DIR, n, "main.c"), "-o",
         os.path.join(work, f"ex_{n}"), "-ldl", "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in CAPI_EXAMPLES}
    for n, p in builds.items():
        out, _ = p.communicate(timeout=PROC_TIMEOUT)
        assert p.returncode == 0, f"cc {n}: {out}"
    cc_s = time.perf_counter() - t0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in sys.path if p]))
    env.pop("PADDLE_TPU_FORCE_CPU", None)
    if dev == "cpu":
        env["PADDLE_TPU_FORCE_CPU"] = "1"
    argv = {"dense": [small, "output"], "sequence": [merged, "output"],
            "sparse_binary": [small, "output", "8"],
            "multi_thread": [small, "output"]}
    runs, started = {}, {}
    for n in CAPI_EXAMPLES:
        started[n] = time.perf_counter()
        runs[n] = subprocess.Popen(
            [os.path.join(work, f"ex_{n}"), lib, REPO, *argv[n]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    outs, wall = {}, {}
    try:
        for n, p in runs.items():
            out, err = p.communicate(timeout=PROC_TIMEOUT)
            wall[n] = time.perf_counter() - started[n]
            assert p.returncode == 0, f"example {n}: rc {p.returncode}\n" \
                                      f"{out}\n{err[-3000:]}"
            outs[n] = out
    finally:
        for p in runs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert "OK" in outs["multi_thread"], outs["multi_thread"]
    vals = {n: np.asarray([float(x) for x in outs[n].split()], np.float32)
            for n in ("dense", "sequence", "sparse_binary")}
    # the same feeds in this process, on the card
    ids = np.zeros((2, 5), np.int32)
    ids[0] = [13, 8, 2, 14, 9]
    ids[1, :4] = [7, 3, 14, 5]
    cls = Inferencer.from_merged(merged, outputs=["output"], device=dev)
    want_seq = cls.infer({"words": id_arg(ids, np.asarray([5, 4],
                                                          np.int32))})
    small_inf = Inferencer.from_merged(small, outputs=["output"], device=dev)
    x = (np.arange(16, dtype=np.float32) / 16.0).reshape(2, 8)
    sparse = np.zeros((2, 8), np.float32)
    sparse[0, [1, 3]] = 1.0
    sparse[1, [0, 5, 6]] = 1.0
    want = {"sequence": want_seq["output"],
            "dense": small_inf.infer({"x": non_seq(x)})["output"],
            "sparse_binary": small_inf.infer({"x": non_seq(sparse)})[
                "output"]}
    err = {n: float(np.abs(vals[n] - want[n].ravel()).max()) for n in want}

    # in-process through ctypes: pt_capi_init reuses this interpreter
    so = C.CDLL(lib)
    so.pt_capi_init.argtypes = [C.c_char_p]
    so.pt_capi_create.restype = C.c_int64
    so.pt_capi_create.argtypes = [C.c_char_p, C.c_char_p]
    so.pt_capi_error.restype = C.c_char_p
    so.pt_capi_forward_slots.argtypes = [C.c_int64, C.c_void_p, C.c_int,
                                         C.POINTER(C.c_float), C.c_int64,
                                         C.POINTER(C.c_int64)]
    so.pt_capi_destroy.argtypes = [C.c_int64]
    env_cpu = os.environ.pop("PADDLE_TPU_FORCE_CPU", None)
    if dev == "cpu":
        os.environ["PADDLE_TPU_FORCE_CPU"] = "1"
    try:
        assert so.pt_capi_init(REPO.encode()) == 0, so.pt_capi_error()
        assert so.pt_capi_create(b"/nonexistent/model.npz", b"output") == 0
        bad = so.pt_capi_error().decode()
        assert "create failed" in bad and "nonexistent" in bad, bad
        h = so.pt_capi_create(merged.encode(), b"output")
        assert h > 0, so.pt_capi_error()
        from paddle_tpu_torch.capi_bridge import Slot
        flat = np.ascontiguousarray([13, 8, 2, 14, 9, 7, 3, 14, 5], np.int32)
        pos = np.ascontiguousarray([0, 5, 9], np.int32)
        s = Slot(name=b"words", kind=2,
                 buf=flat.ctypes.data_as(C.c_void_p),
                 seq_pos=pos.ctypes.data_as(C.POINTER(C.c_int32)), n_seq=3)
        out = (C.c_float * 64)()
        oshape = (C.c_int64 * 8)()
        zero_rnn_counts(rnn)
        call_ms = []
        for _ in range(1 + CAPI_CALLS):
            t0 = time.perf_counter()
            rank = so.pt_capi_forward_slots(h, C.byref(s), 1, out, 64,
                                            oshape)
            call_ms.append((time.perf_counter() - t0) * 1e3)
            assert rank == 2 and list(oshape[:2]) == [2, 2], \
                so.pt_capi_error()
        # CAPI_THREADS threads calling at once: the calls hold the GIL
        # while they run, so they serialise
        errors = []

        def worker():
            o, sh = (C.c_float * 64)(), (C.c_int64 * 8)()
            for _ in range(CAPI_CALLS):
                if so.pt_capi_forward_slots(h, C.byref(s), 1, o, 64,
                                            sh) != 2 or list(o[:4]) != \
                        list(out[:4]):
                    errors.append(so.pt_capi_error())
        threads = [threading.Thread(target=worker)
                   for _ in range(CAPI_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PROC_TIMEOUT)
        threaded_s = time.perf_counter() - t0
        assert not errors and not any(t.is_alive() for t in threads), errors
        launched = rnn_counts(rnn)
        got = np.asarray(out[:4], np.float32)
        so.pt_capi_destroy(h)
    finally:
        os.environ.pop("PADDLE_TPU_FORCE_CPU", None)
        if env_cpu is not None:
            os.environ["PADDLE_TPU_FORCE_CPU"] = env_cpu
    err["in_process"] = float(np.abs(got - want_seq["output"].ravel()).max())
    r = {"cc_s": cc_s, "example_wall_s": wall, "max_abs_err": err,
         "bound": CAPI_TOL, "first_call_ms": call_ms[0],
         "call_ms_median": float(np.median(call_ms[1:])),
         "threads": CAPI_THREADS,
         "threaded_ms_per_call": threaded_s * 1e3
         / (CAPI_THREADS * CAPI_CALLS),
         "launches": {k: v for k, v in launched.items() if v}}
    print("capi " + json.dumps(r), flush=True)
    assert max(err.values()) <= CAPI_TOL, err
    if dev == "cuda":
        n = 2 * (1 + CAPI_CALLS + CAPI_THREADS * CAPI_CALLS)
        assert launched["lstm_fwd_infer_launches"] == n and \
            launched["lstm_fwd_launches"] == 0 and \
            launched["lstm_bwd_launches"] == 0, launched
    return {"r": r, "merged": merged, "launches": launched}


def api_generator(torch, rnn, gen, dev="cuda"):
    """Phase 27(d): `api.SequenceGenerator` over phase 20's attention NMT
    at its settings (B=32, t_src 32, beam 4, max_len 32, its trained
    parameters): the encoder through `api.GradientMachine.forward` (B7
    twice, cluster route), then the generator; tokens, lengths and
    scores bit-equal to `BeamSearchDecoder.generate` on the same
    params and statics."""
    from paddle_tpu_torch import api
    from paddle_tpu_torch.core.arg import id_arg
    from paddle_tpu_torch.models.text import seq2seq_attention

    params = gen["params"]
    gm = api.GradientMachine(seq2seq_attention(fused_decoder=True, **NMT),
                             device=dev)
    for k, v in params.items():
        gm.setParameter(k, v)
    rng = np.random.default_rng(SEED + 270)
    src = rng.integers(2, NMT["src_vocab"], (GEN_B, GEN_T_SRC)).astype(
        np.int32)
    lens = np.full(GEN_B, GEN_T_SRC, np.int32)
    zero_rnn_counts(rnn)
    t0 = time.perf_counter()
    outs = gm.forward({"src": id_arg(src, lens)}, outputs=["enc",
                                                           "dec_boot"])
    sync(torch, dev)
    launched = gru_counts(rnn)
    sg = api.SequenceGenerator(gen["decoder"](1), params,
                               num_results=GEN_BEAM, device=dev)
    res = sg.generate([outs["enc"]],
                      boots={"dec_state": outs["dec_boot"].value})
    sync(torch, dev)
    gen_s = time.perf_counter() - t0
    ref = gen["decoder"](1).generate(
        params, [outs["enc"]], boots={"dec_state": outs["dec_boot"].value})
    equal = all(torch.equal(a, b) for a, b in zip(sg.last_result, ref))
    r = {"rows": len(res), "beams": len(res[0]), "seconds": gen_s,
         "bit_equal": equal, "launches": launched}
    print("api generator " + json.dumps(r), flush=True)
    assert equal and len(res) == GEN_B and len(res[0]) == GEN_BEAM, r
    if dev == "cuda":
        assert launched["gru_fwd_launches"] == 2 and \
            launched["gru_fwd_cluster_launches"] == 2 and \
            launched["gru_bwd_launches"] == 0, launched
    return {"r": r, "launches": launched}


def py2_driver(torch, rnn, work, b, merged, records, dev="cuda"):
    """Phase 27(e): PY2_DRIVER (a python-2 API driver: print statements,
    xrange, cPickle, `from py_paddle import swig_paddle`) trains (b)'s
    classifier from (c)'s merged model for PY2_STEPS steps through
    `run_py2_script`; its losses equal the same steps through
    GradientMachine called directly, and its `py_paddle` is the port's
    namespace. B5 and B6 on the grid route, twice a step."""
    import pickle

    from paddle_tpu_torch.compat import py_paddle, swig_api as api
    from paddle_tpu_torch.compat.py2run import run_py2_script
    from paddle_tpu_torch.compat.py_paddle import DataProviderConverter
    from paddle_tpu_torch.data.feeder import integer_value, \
        integer_value_sequence

    driver = os.path.join(work, "py2_api_train.py")
    with open(driver, "w") as f:
        f.write(PY2_DRIVER)
    bs = V1_CLS["batch_size"]
    batches = [records[i * bs:(i + 1) * bs] for i in range(PY2_STEPS)]
    data = os.path.join(work, "batches.pkl")
    with open(data, "wb") as f:
        pickle.dump(batches, f, 2)
    config, config_args = b["config"]
    mods = set(sys.modules)
    zero_rnn_counts(rnn)
    t0 = time.perf_counter()
    g = run_py2_script(driver, argv=[config, config_args, merged, data,
                                     str(PY2_STEPS),
                                     "1" if dev == "cuda" else "0"])
    sync(torch, dev)
    driver_s = time.perf_counter() - t0
    launched = rnn_counts(rnn)
    assert g["swig_paddle"] is py_paddle.swig_paddle
    assert g["DataProviderConverter"] is DataProviderConverter
    assert not any(m.split(".")[0] in ("py_paddle", "paddle")
                   for m in set(sys.modules) - mods)
    # the same steps through GradientMachine called directly
    gm = api.GradientMachine.createFromConfigProto(b["tc"].model_config)
    gm.loadParameters(merged)
    up = api.ParameterUpdater.createLocalUpdater(b["tc"].opt_config)
    up.init(gm)
    conv = DataProviderConverter(
        [integer_value_sequence(V1_CLS["vocab"]), integer_value(2)])
    direct = []
    for batch in batches:
        up.startBatch(len(batch))
        cost = gm.forwardBackward(conv(batch),
                                  api.Arguments.createArguments(0),
                                  api.PASS_TRAIN)
        for p in gm.getParameters():
            up.update(p)
        up.finishBatch(cost)
        direct.append(cost)
    try:
        import lib2to3  # noqa: F401
        converter = "lib2to3"
    except ImportError:
        converter = "tokens (no lib2to3 here)"
    r = {"losses": g["LOSSES"], "direct": direct, "driver_s": driver_s,
         "converter": converter,
         "launches": {k: v for k, v in launched.items() if v}}
    print("py2 driver " + json.dumps(r), flush=True)
    assert g["LOSSES"] == direct and len(direct) == PY2_STEPS, r
    if dev == "cuda":
        n = 2 * PY2_STEPS
        want = dict.fromkeys(RNN_COUNTERS, 0)
        want.update(lstm_fwd_launches=n, lstm_fwd_grid_launches=n,
                    lstm_bwd_launches=n, lstm_bwd_grid_launches=n)
        assert launched == want, launched
    return {"r": r, "launches": launched}


def v1_runtime(torch, rnn, gen, work, dev="cuda"):
    """Phase 27: 27a-27e (the v1-era runtime)."""
    t0 = time.perf_counter()
    phase("27a. the native runtime built from the port's sources; "
          "bench_lstm's feed through dataset.common.convert into recordio")
    paths, records, a = v1_records(work)
    phase("27b. the elastic job through the v1 API: the master command, "
          "reader.elastic, GradientMachine + ParameterUpdater, the master "
          "SIGKILLed and restarted")
    b = v1_elastic(torch, rnn, work, paths, records, dev)
    phase("27c. the C inference ABI: the four example programs and the "
          "classifier through ctypes")
    c = capi_examples(torch, rnn, work, b["gm"], b["tc"], dev)
    phase("27d. api.SequenceGenerator over phase 20's NMT")
    d = api_generator(torch, rnn, gen, dev)
    phase("27e. a py2 API driver through run_py2_script")
    e = py2_driver(torch, rnn, work, b, c["merged"], records, dev)
    seconds = time.perf_counter() - t0
    print(f"v1 runtime phase 27 seconds {seconds:.1f}", flush=True)
    return {"a": a, "b": b["launches"], "c": c["launches"],
            "d": d["launches"], "e": e["launches"], "seconds": seconds}


# ---- phase 28: the main paths at head dim 256 (the D-split forms) ------

# Gemma's head dim (Gemma Team 2024: 256 at every size) on the repo's
# paths: (a) phase 4's served LM and (b) LM (b) of phase 6 at d_model
# 1024 with 4 heads; (c) bench_longctx's conf at d 1024, 4 heads
SERVED_LM_D256 = dict(SERVED_LM, d_model=1024)
LM_D256_STEPS = 20
LONGCTX_D256 = dict(LONGCTX, d=1024, heads=4)
LONGCTX_D256_STEPS = 10


def serve_d256(torch, fa):
    """28(a): phase 4's serving path at head dim 256: every prefill's
    attention through the f32 D-split forward."""
    launched = serve_lm(torch, fa, SERVED_LM_D256)
    assert list(launched) == ["dsplit_launches"], f"28(a): {launched}"
    return launched


def train_lm_d256(torch, fa):
    """28(b): LM (b)'s setting (B = 8 x 1024 ragged, adam 0.001) at
    d_model 1024, 4 heads: the flash step held against the dense step at
    the flash step's ReLU gates (phase 6's hold), then LM_D256_STEPS
    adam steps through SGD.train, every loss finite and the last below
    the first, each f32 D-split form launched once a layer a step and no
    other flash form. Returns the numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(**SERVED_LM_D256)
    np_params = random_params(spec, lm)
    rng = np.random.default_rng(SEED + 2)
    ragged = np.asarray(PROMPT_LENS, np.int32)
    batch = lm_batches(rng, 1, 8, 1024, ragged, spec.vocab)[0]
    held = held_flash_dense_step(torch, spec, np_params, "d256_b8_t1024",
                                 batch)
    sgd = SGD(lm.transformer_lm(spec),
              OptimizationConf(learning_method="adam", learning_rate=LR_B),
              params=params_from_numpy(np_params, "cuda"), device="cuda")
    costs, stamps = [], []

    def on_event(e):
        if isinstance(e, EndIteration):
            costs.append(e.cost)
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    for n in fa.COUNTERS:
        setattr(fa, n, 0)
    t0 = time.perf_counter()
    sgd.train(reader=lambda: iter([batch] * LM_D256_STEPS), feeder=lm_feed,
              num_passes=1, event_handler=on_event)
    torch.cuda.synchronize()
    launched = {n: getattr(fa, n) for n in fa.COUNTERS if getattr(fa, n)}
    assert launched == dict.fromkeys(
        DSPLIT_FORMS[False], spec.num_layers * LM_D256_STEPS), (
        f"28(b): flash launches {launched}")
    steady = float(np.median(np.diff(stamps))) * 1e3
    r = {"held": held, "steps": LM_D256_STEPS,
         "wall_s": time.perf_counter() - t0, "ms_per_step_median": steady,
         "ms_first_step": (stamps[0] - t0) * 1e3,
         "train_tokens_per_s": int(ragged.sum()) / (steady / 1e3),
         "loss_first": costs[0], "loss_last": costs[-1],
         "launches": launched}
    print("train lm_d256_b8_t1024 " + json.dumps(r), flush=True)
    assert np.isfinite(costs).all(), "28(b): a loss is not finite"
    assert costs[-1] < costs[0], f"28(b): loss rose: {costs}"
    prof = profile_steps(torch, sgd, lm_feed(batch), steps=2)
    if prof is not None:
        prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
    print("profile lm_d256_b8_t1024 " + json.dumps(prof), flush=True)
    return r


def train_longctx_d256(torch, fa):
    """28(c): bench_longctx's conf at d 1024, 4 heads under the bf16
    flag, flash against dense: 6d's held step and LONGCTX_D256_STEPS
    steps an arm at B = 4, T = 4096 (6d's bounds), the flash arm through
    the bf16 D-split forms only. Returns ((held), (run))."""
    np_params = longctx_params(torch, LONGCTX_D256)
    B, T = 4, 4096
    forms = DSPLIT_FORMS[True]
    held = longctx_held_step(
        torch, fa, np_params,
        longctx_feed(B, T, LONGCTX_D256["classes"], LONGCTX_D256["vocab"]),
        cfg=LONGCTX_D256, forms=forms)
    # longctx_train holds its windows' launches of every flash form to
    # `forms`, once a layer a step (its profiles launch more)
    for n in fa.COUNTERS:
        setattr(fa, n, 0)
    run = longctx_train(torch, fa, np_params, B, T, LONGCTX_D256_STEPS,
                        cfg=LONGCTX_D256, forms=forms)
    return held, run


def head_dim_256(torch, fa):
    """Phase 28: (a), (b) and (c), each with every flash counter zeroed
    just before it and read just after. Returns {path: numbers}."""
    out = {}
    phase("28a. the served LM at d_model 1024, 4 heads (head dim 256)")
    out["a"] = serve_d256(torch, fa)
    phase("28b. LM (b) at d_model 1024, 4 heads through SGD (f32)")
    out["b"] = train_lm_d256(torch, fa)
    torch.cuda.empty_cache()
    phase("28c. the long-context trainer at d 1024, 4 heads under the "
          "bf16 flag, flash vs dense")
    out["c"] = train_longctx_d256(torch, fa)
    torch.cuda.empty_cache()
    return out


# ---- phase 29: the Fluid-style op framework (ROADMAP A12) ---------------

# the reference's MLP on MNIST-sized rows, and a one-memory RNN step net
FW_MLP = dict(batch=128, inputs=784, classes=10, steps=20, lr=0.5)
FW_RNN = dict(T=16, batch=64, inputs=128, hidden=256)


def fw_mlp(F, G):
    """The MLP as an op net (mul, rowwise_add, sigmoid, softmax,
    onehot_cross_entropy, mean), its backward() net and the sgd ops on w
    and b, as one training step net."""
    net = F.NetOp()
    net.add_op("mul", {"X": "x", "Y": "w"}, {"Out": "xw"})
    net.add_op("rowwise_add", {"X": "xw", "b": "b"}, {"Out": "z"})
    net.add_op("sigmoid", {"X": "z"}, {"Y": "h"})
    net.add_op("softmax", {"X": "h"}, {"Y": "p"})
    net.add_op("onehot_cross_entropy", {"X": "p", "label": "label"},
               {"Y": "ce"})
    net.add_op("mean", {"X": "ce"}, {"Out": "loss"})
    net.complete_add_op()
    bwd = F.backward(net, no_grad={"x", "label"}, seeded={"loss"})
    step = F.NetOp()
    for o in net.ops + bwd.ops:
        step.append_op(o)
    for p in ("w", "b"):
        step.add_op("sgd", {"param": p, "grad": p + G}, {"param_out": p},
                    {"learning_rate": FW_MLP["lr"]})
    step.complete_add_op()
    return net, bwd, step


def fw_data(torch, dev):
    """The MLP's data and weights from a seed: labels a linear teacher's
    argmax, so the loss can fall."""
    rng = np.random.default_rng(SEED + 29)
    n, d, c = FW_MLP["batch"], FW_MLP["inputs"], FW_MLP["classes"]
    x = rng.standard_normal((n, d)).astype(np.float32)
    teacher = rng.standard_normal((d, c)).astype(np.float32)
    vals = {"x": x, "label": np.argmax(x @ teacher, 1).astype(np.int32),
            "w": (rng.standard_normal((d, c)) / np.sqrt(d)).astype(
                np.float32),
            "b": np.zeros(c, np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in vals.items()}


def fw_eager(torch, F, G, dev, steps):
    """`steps` eager steps op by op; returns (losses, w, b, grads of the
    first step)."""
    net, bwd, _step = fw_mlp(F, G)
    scope = F.Scope(device=dev)
    for k, v in fw_data(torch, dev).items():
        scope.set(k, v)
    one = torch.tensor(1.0, device=dev)
    upd = F.NetOp()
    for p in ("w", "b"):
        upd.add_op("sgd", {"param": p, "grad": p + G}, {"param_out": p},
                   {"learning_rate": FW_MLP["lr"]})
    losses, first = [], None
    for i in range(steps):
        net.run(scope)
        losses.append(scope.get("loss").clone())
        scope.set("loss" + G, one)
        bwd.run(scope)
        if i == 0:
            first = {n: scope.get(n + G).clone() for n in ("w", "b")}
        upd.run(scope)
    return torch.stack(losses), scope.get("w"), scope.get("b"), first


def fw_graph(torch, F, G, steps):
    """The same steps as `net_to_fn` of the step net captured as one
    CUDA graph, replayed `steps` times with w and b written back."""
    from paddle_tpu_torch.parallel.graph import no_gc

    _net, _bwd, step = fw_mlp(F, G)
    fn = F.net_to_fn(step, ["x", "label", "w", "b", "loss" + G],
                     ["loss", "w", "b"])
    d = fw_data(torch, "cuda")
    static = [d["x"], d["label"], d["w"].clone(), d["b"].clone(),
              torch.tensor(1.0, device="cuda")]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)                       # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_gc(), torch.cuda.graph(graph):
        outs = fn(*static)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        graph.replay()
        losses.append(outs[0].clone())
        static[2].copy_(outs[1])
        static[3].copy_(outs[2])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(losses), static[2], static[3], ms


def fw_rnn(torch, F, dev):
    """The one-memory RNN step net over T = 16: eager (per-step scopes)
    and through scan_fn, its grad op and torch.autograd over scan_fn;
    returns the numbers on `dev`."""
    step = F.NetOp()
    step.add_op("mul", {"X": "x", "Y": "W"}, {"Out": "xw"})
    step.add_op("mul", {"X": "h_pre", "Y": "U"}, {"Out": "hu"})
    step.add_op("add", {"X": "xw", "Y": "hu"}, {"Out": "z"})
    step.add_op("sigmoid", {"X": "z"}, {"Y": "h"})
    step.complete_add_op()
    op = F.RecurrentOp(stepnet=step, inlinks=["x"], outlinks=["h"],
                       memories=[F.MemoryAttr(var="h", pre_var="h_pre",
                                              boot_var="h0")])
    rng = np.random.default_rng(SEED + 30)
    t, b, i, h = (FW_RNN[k] for k in ("T", "batch", "inputs", "hidden"))
    vals = {"x": rng.standard_normal((t, b, i)),
            "W": rng.standard_normal((i, h)) / np.sqrt(i),
            "U": rng.standard_normal((h, h)) / np.sqrt(h),
            "h0": np.zeros((b, h))}
    vals = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in vals.items()}
    scope = F.Scope(device=dev)
    for k, v in vals.items():
        scope.set(k, v)
    op.run(scope)
    eager = scope.get("h")
    scope.set("h@GRAD", torch.ones_like(eager))
    op.build_grad_op().run(scope)
    names = ("W", "U", "h0", "x")
    grad_op = {n: scope.get(n + "@GRAD") for n in names}
    xs = [vals[n].clone().requires_grad_(True) for n in names]
    (scan,) = op.scan_fn(op.extern_names())(xs[:2], [xs[2]], [xs[3]])
    auto = dict(zip(names, torch.autograd.grad(scan.sum(), xs)))
    return {"eager": eager, "scan": scan.detach(), "grad_op": grad_op,
            "autograd": auto}


def fw_card_default(torch, F):
    """The reference op tests' pattern with no device named anywhere:
    gaussian_random weights into mul with a numpy x, both on the card
    (the scope's default); then the v2 op-test harness (an OpTestMeta
    case and GradientChecker.check_grad of mul), which runs each op on
    the CPU and on the card. Returns mul's error against x @ w on the
    CPU."""
    import io
    import unittest

    from paddle_tpu_torch.compat.v2_framework import core
    from paddle_tpu_torch.compat.v2_framework import gradient_checker as gc
    from paddle_tpu_torch.compat.v2_framework.op_test_util import OpTestMeta

    rng = np.random.default_rng(SEED + 31)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    scope = F.Scope()
    scope.set("x", x)
    net = F.NetOp()
    net.add_op("gaussian_random", {}, {"Out": "w"}, dict(dims=[64, 16],
                                                         seed=3))
    net.add_op("mul", {"X": "x", "Y": "w"}, {"Out": "y"})
    net.run(scope)
    w, y = scope.get("w"), scope.get("y")
    assert w.is_cuda and y.is_cuda, (w.device, y.device)
    err = rel_err(y.cpu(), torch.from_numpy(x) @ w.cpu())[0]

    a = rng.uniform(0.1, 1, (8, 12)).astype(np.float32)
    b = rng.uniform(0.1, 1, (12, 5)).astype(np.float32)

    class MulOp(unittest.TestCase, metaclass=OpTestMeta):
        def setUp(self):
            self.type = "mul"
            self.inputs = {"X": a, "Y": b}
            self.outputs = {"Out": a @ b}

    class MulGrad(gc.GradientChecker):
        def test_mul(self):
            self.check_grad(gc.create_op("mul"), {"X": a, "Y": b},
                            {"X", "Y"}, "Out", max_relative_error=0.01)

    assert core.is_compile_gpu()
    suite = unittest.TestSuite(
        [unittest.defaultTestLoader.loadTestsFromTestCase(c)
         for c in (MulOp, MulGrad)])
    res = unittest.TextTestRunner(stream=io.StringIO()).run(suite)
    assert res.wasSuccessful() and res.testsRun == 2, (
        f"29: the op-test harness failed: {res.failures + res.errors}")
    return err


def op_framework(torch):
    """Phase 29: the op framework on the card. The MLP trained
    FW_MLP["steps"] steps eagerly, op by op (the loss falls); the same
    steps through `net_to_fn` captured as a CUDA graph, bit-equal to the
    eager steps; the first step's loss, gradients and update within TOL
    of the port on the CPU; the RNN eager and through scan_fn equal on
    the card, its grad op within TOL of autograd over scan_fn, and both
    within TOL of the CPU; random weights into mul with a numpy input
    and the v2 op-test harness on the card with no device named
    (`fw_card_default`). Returns the numbers."""
    from paddle_tpu_torch import framework as F

    G = F.GRAD_SUFFIX
    steps = FW_MLP["steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, w, b, first = fw_eager(torch, F, G, "cuda", steps)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / steps
    g_losses, gw, gb, graph_ms = fw_graph(torch, F, G, steps)
    c_losses, cw, cb, cfirst = fw_eager(torch, F, G, "cpu", 1)
    rnn, rnn_cpu = fw_rnn(torch, F, "cuda"), fw_rnn(torch, F, "cpu")
    card_default_err = fw_card_default(torch, F)
    r = {"loss_first": losses[0].item(), "loss_last": losses[-1].item(),
         "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
         "graph_bit_equal": bool(torch.equal(losses, g_losses)
                                 and torch.equal(w, gw)
                                 and torch.equal(b, gb)),
         "first_step_vs_cpu": max(
             [abs(losses[0].item() - c_losses[0].item())
              / abs(c_losses[0].item())]
             + [rel_err(first[n].cpu(), cfirst[n])[0] for n in ("w", "b")]),
         "rnn_scan_equals_eager": bool(torch.equal(rnn["scan"],
                                                   rnn["eager"])),
         "rnn_grad_op_vs_autograd": max(
             rel_err(rnn["grad_op"][n], rnn["autograd"][n])[0]
             for n in rnn["grad_op"]),
         "rnn_vs_cpu": max(
             [rel_err(rnn["eager"].cpu(), rnn_cpu["eager"])[0]]
             + [rel_err(rnn["grad_op"][n].cpu(), rnn_cpu["grad_op"][n])[0]
                for n in rnn["grad_op"]]),
         "numpy_mul_on_card_vs_cpu": card_default_err}
    print("op framework " + json.dumps(r), flush=True)
    assert torch.isfinite(losses).all() and r["loss_last"] < r["loss_first"], (
        f"29: the MLP's loss did not fall: {losses.tolist()}")
    assert r["graph_bit_equal"], "29: the graph's steps differ from eager"
    assert r["first_step_vs_cpu"] <= TOL, f"29: card vs CPU {r}"
    assert r["rnn_scan_equals_eager"], "29: the RNN's scan differs"
    assert r["rnn_grad_op_vs_autograd"] <= TOL, f"29: RNN grads {r}"
    assert r["rnn_vs_cpu"] <= TOL, f"29: RNN card vs CPU {r}"
    assert r["numpy_mul_on_card_vs_cpu"] <= TOL, f"29: numpy mul {r}"
    return r


def sparse_kernel_rows(checks, times, standalone, wide_deep, tier, slice24,
                       slice26):
    """The B9 kernels' rows of the kernels line, at the standalone bench
    shape (V = 2^20, D = 64, N = 65 536): the rule kernel with momentum
    (no single PyTorch call computes a momentum row update; SGD's
    index_add_ is printed in phase 14) and the generic route's kernels
    with the bench's own update function. Launches: phases 15-17,
    24(f)'s CTR worker (its done record) and online loop, and 26(f)'s
    ranks."""
    bench = times["bench_momentum_v1m_d64_n65536"]
    generic = times["bench_lambda_state_v1m_d64_n65536"]
    launches = standalone["launches"]
    update = (launches["sparse_row_update_launches"] + wide_deep["launches"]
              + sum(r["launches"]["sparse_row_update_launches"]
                    for r in tier.values())
              + slice24["ctr"]["launches"]["sparse_row_update_launches"]
              + slice24["online"]["b9_launches"]
              + slice26["f"]["launches"]["sparse_row_update_launches"])

    def row(name, at, ms, bound, launched, rules):
        return {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/sparse_rows.cu",
            "replaces": "paddle_tpu/parallel/sparse.py:330",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in checks
                               if r["rule"] in rules),
            "ms": at[ms], "plain_ms": at["plain_ms"],
            "bound_ms": at[bound], "bound_by": "bytes",
            "library_ms": None,
        }

    rules, generic_rules = ("sgd", "momentum", "adagrad"), ("lambda",
                                                           "lambda_state")
    return [
        row("sparse_row_update", bench, "ms", "bound_ms", update, rules),
        row("sparse_row_gather", generic, "gather_ms", "gather_bound_ms",
            launches["sparse_row_gather_launches"], generic_rules),
        row("sparse_row_scatter", generic, "scatter_ms", "scatter_bound_ms",
            launches["sparse_row_scatter_launches"], generic_rules),
    ]


def dsplit_kernel_rows(dsplit, slice28):
    """The D-split forms' rows of the kernels line: f32 at phase 28's
    shapes (the forward at (a)'s longest prefill, dkv and dq at (b)'s
    batch), bf16 at (c)'s; max_abs_err over phase 3c's cases of the form;
    bound_ms the function's (unsplit), split_bound_ms the D-split's as it
    runs (S recomputed per chunk). Launches: phase 28's runs."""
    paths = dsplit["paths"]
    b, c = slice28["b"]["launches"], slice28["c"][1]["flash"]["launches"]

    def row(name, form, at, bf16, launched, keys):
        r = paths[at]
        return {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_dsplit.cuh",
            "replaces": "paddle_tpu/parallel/ring.py:265",
            "launches": launched,
            "max_abs_err": max(x["max_abs_err"][k]
                               for x in dsplit["checks"]
                               if (x["dtype"] == "bf16") == bf16
                               for k in keys),
            "ms": r[f"{form}_ms"],
            "plain_ms": r[f"plain_{'fwd' if form == 'fwd' else 'bwd'}_ms"],
            "bound_ms": r[f"{form}_bound_ms"],
            "bound_by": r[f"{form}_bound_by"],
            "split_bound_ms": r[f"{form}_split_bound_ms"],
            "library_ms": r[f"library_{'fwd' if form == 'fwd' else 'bwd'}"
                            "_ms"],
            "at": r["name"],
        }

    fwd32, dkv32, dq32 = DSPLIT_FORMS[False]
    fwd16, dkv16, dq16 = DSPLIT_FORMS[True]
    return [
        row("flash_attn_fwd_dsplit", "fwd", "served", False,
            slice28["a"][fwd32] + b[fwd32], ("out",)),
        row("flash_attn_bwd_dkv_dsplit", "dkv", "lm", False, b[dkv32],
            ("dk", "dv")),
        row("flash_attn_bwd_dq_dsplit", "dq", "lm", False, b[dq32],
            ("dq",)),
        row("flash_attn_fwd_dsplit_bf16", "fwd", "longctx", True, c[fwd16],
            ("out",)),
        row("flash_attn_bwd_dkv_dsplit_bf16", "dkv", "longctx", True,
            c[dkv16], ("dk", "dv")),
        row("flash_attn_bwd_dq_dsplit_bf16", "dq", "longctx", True,
            c[dq16], ("dq",)),
    ]


def no_serialised_wgmma(log, name):
    """Fail where ptxas serialised a kernel's wgmma (a wgmma on a path it
    cannot prove warp-uniform: every product then waits for the last)."""
    bad = [line for line in log.splitlines()
           if "wgmma.mma_async instructions are serialized" in line]
    assert not bad, f"{name}: ptxas serialised wgmma:\n" + "\n".join(bad)


def ptxas_report(log):
    """One line a kernel of an nvcc -Xptxas -v log: its name, registers,
    shared memory and spills."""
    import re

    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)", m.group(1))
            # the template's int arguments (a Tile<...>'s among them)
            ints = re.findall(r"Li(\d+)E", m.group(1))
            name = (k.group(1) + (f"<{','.join(ints)}>" if ints else "")
                    if k else m.group(1))
        elif name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.split(':')[-1].strip()}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import bn_act_conv1x1 as fop
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import rnn
    from paddle_tpu_torch.ops import sparse_rows as sr
    from paddle_tpu_torch.parallel import sparse as tsp
    from paddle_tpu_torch.parallel import sparse_shard as tss

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in _build.build_log(fa.KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas: " + line.strip(), flush=True)

    phase("3. flash kernel vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the first four are prefill shapes of phase 4 (B=1, a bucket T,
    # kv_len = the prompt length); the others cover batch, odd T, the
    # other head dims, q_len and an empty row
    cases = [
        dict(name="served_b1_t1024_h4_d64", B=1, Tq=1024, Tk=1024, H=4,
             D=64, causal=True, kv_len=[1000]),
        dict(name="served_b1_t512_h4_d64", B=1, Tq=512, Tk=512, H=4,
             D=64, causal=True, kv_len=[300]),
        dict(name="served_b1_t64_h4_d64", B=1, Tq=64, Tk=64, H=4, D=64,
             causal=True, kv_len=[64]),
        dict(name="served_b1_t32_h4_d64", B=1, Tq=32, Tk=32, H=4, D=64,
             causal=True, kv_len=[17]),
        dict(name="b4_t1024_h4_d64_ragged", B=4, Tq=1024, Tk=1024, H=4,
             D=64, causal=True, kv_len=[1024, 700, 333, 1]),
        dict(name="b2_t48_h2_d32", B=2, Tq=48, Tk=48, H=2, D=32,
             causal=True),
        dict(name="b2_tq64_tk200_h4_d128_cross", B=2, Tq=64, Tk=200, H=4,
             D=128, causal=False, kv_len=[200, 123], q_len=[50, 64],
             expect_dead=True),
        dict(name="b2_t64_h2_d64_kvlen0", B=2, Tq=64, Tk=64, H=2, D=64,
             causal=True, kv_len=[0, 64], expect_dead=True),
        # LM (b)'s training forward (phase 6)
        dict(name="train_b8_t1024_h4_d64_ragged", B=8, Tq=1024, Tk=1024,
             H=4, D=64, causal=True, kv_len=list(PROMPT_LENS)),
        # a head dim the kernel instantiates beyond 32/64/128
        dict(name="b2_t300_h3_d96_ragged", B=2, Tq=300, Tk=300, H=3, D=96,
             causal=True, kv_len=[300, 151]),
        # phase 22's beam and speculative prefill (B rows at the 1024
        # bucket, kv_len = the prompt lengths)
        dict(name="beam_prefill_b4_t1024_h4_d64", B=4, Tq=1024, Tk=1024,
             H=4, D=64, causal=True, kv_len=list(BEAM_LENS)),
    ]
    results = [check_kernel(torch, fa, c, gen) for c in cases]

    phase("3b. the flash kernel's bf16 form vs its bf16 plain version")
    results_bf16 = [check_kernel_bf16(torch, fa, c, gen)
                    for c in cases + [LONGCTX_SHAPE] + BF16_EDGE_SHAPES]

    phase("3c. the flash kernels' D-split forms (head dim > 128) vs their "
          "plain versions")
    dsplit = dsplit_kernels(torch, fa, gen)

    phase("4. serve the paged LM through the port")
    served = serve_lm(torch, fa)
    assert list(served) == ["launches"], f"4: flash forms {served}"
    launches = served["launches"]

    phase("5. flash backward kernels vs plain version")
    for line in _build.build_log(fa.BWD_KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas: " + line.strip(), flush=True)
    # the first two are the training shapes of phase 6; the others
    # cover the other head dims, odd T, q_len and an empty row
    bwd_cases = [
        dict(name="train_b32_t128_h4_d64", B=32, Tq=128, Tk=128, H=4,
             D=64, causal=True),
        dict(name="train_b8_t1024_h4_d64_ragged", B=8, Tq=1024, Tk=1024,
             H=4, D=64, causal=True, kv_len=list(PROMPT_LENS)),
        dict(name="b2_t77_h3_d32", B=2, Tq=77, Tk=77, H=3, D=32,
             causal=True, kv_len=[77, 40]),
        dict(name="b2_tq64_tk200_h4_d128_cross", B=2, Tq=64, Tk=200, H=4,
             D=128, causal=False, kv_len=[200, 123], q_len=[50, 64],
             expect_dead=True),
        dict(name="b2_t64_h2_d64_kvlen0", B=2, Tq=64, Tk=64, H=2, D=64,
             causal=True, kv_len=[0, 64], expect_dead=True),
        dict(name="b2_t300_h3_d96_ragged", B=2, Tq=300, Tk=300, H=3, D=96,
             causal=True, kv_len=[300, 151]),
    ]
    bwd = [check_backward(torch, fa, c, gen) for c in bwd_cases]

    phase("5b. the flash backward kernels' bf16 forms vs their bf16 plain "
          "version")
    bwd_bf16 = [check_backward_bf16(torch, fa, c, gen)
                for c in bwd_cases + [LONGCTX_SHAPE] + BF16_EDGE_SHAPES]

    phase("6. train the LM through SGD")
    _parity, runs = train_lm(torch, fa)
    train_fwd = sum(r["launches_fwd"] for r in runs.values())

    phase("6c. train the LM at bench_lm_train's settings under the bf16 "
          "flag")
    train_lm_amp(torch, fa)

    phase("6d. the long-context trainer at bench_longctx's settings under "
          "the bf16 flag, flash vs dense")
    _held_longctx, longctx_runs = train_longctx_amp(torch, fa)

    phase("7. fused BN-ReLU-1x1 kernels vs plain version")
    ptxas_report(_build.build_log(fop.KERNEL))
    no_serialised_wgmma(_build.build_log(fop.KERNEL), fop.KERNEL)
    fused_err, fused_times = fused_kernels(torch, fop)

    phase("7b. the fused kernels' bf16 forms vs their bf16 plain versions")
    fused_err_bf16, fused_times_bf16 = fused_kernels_bf16(torch, fop)

    phase("8. ResNet-50 inference through Inferencer")
    plain, fused, rparams, rstate = resnet_nets(torch)
    infer = resnet_infer(torch, fop, plain, fused, rparams, rstate)

    phase("9. ResNet-50 training through SGD")
    _held, train_b, _train_plain = resnet_training(torch, fop, plain, fused,
                                                   rparams, rstate)

    phase("9c. ResNet-50 training under the bf16 flag at bench_resnet50's "
          "settings")
    _held_amp, train_amp, _train_plain_amp = resnet_training_amp(
        torch, fop, plain, fused, rparams, rstate)
    del plain, fused, rparams, rstate

    phase("10. LSTM/GRU sequence kernels vs plain version")
    for kernel in (rnn.LSTM_KERNEL, rnn.GRU_KERNEL):
        ptxas_report(_build.build_log(kernel))
    rnn_res = rnn_kernels(torch, rnn)

    phase("11. IMDB classifier inference through Inferencer")
    cls_infer = classifier_infer(torch, rnn)

    phase("12. held classifier and NMT train steps, kernels vs scan")
    _held_text, text_runs, _amp_text, wide, wide_n = text_training(torch,
                                                                   rnn)

    phase("14. sparse-row kernels (B9) vs plain version")
    ptxas_report(_build.build_log(sr.KERNEL))
    sparse_checks, sparse_times = sparse_kernels(torch, sr, tss)

    phase("15. standalone sparse update through SparseUpdater.run_steps")
    standalone = sparse_standalone(torch, sr, tsp, tss)

    phase("16. the wide&deep large-table train step")
    wide_deep = widedeep(torch, sr, tsp, tss)

    phase("17. the sharded embedding tier, 2^30 logical rows")
    tier = sharded_tier(torch, sr, tss)

    phase("18. the CTR models through SGD")
    ctr_models(torch)

    phase("18b. multi-step dispatch: the classifier through SGD.train and "
          "DataFeeder at steps_per_dispatch = 10")
    print(smi, flush=True)
    classifier_multistep(torch)

    phase("18c. multi-step dispatch: a CUDA graph of 10 steps against eager "
          "chunks, model by model")
    multistep_graphs(torch)
    print(smi, flush=True)

    phase("19. the training lifecycle: evaluators, checkpoints, resume, "
          "preemption, the watchdog ladder, the CLI")
    print(smi, flush=True)
    lifecycle(torch, rnn, fop)
    print(smi, flush=True)

    phase("20. beam-search generation and NMT serving: the fused decoder "
          "arm, K-token decode graphs, the host rung, GenerationModel "
          "over TCP")
    print(smi, flush=True)
    gen = generation(torch, rnn)
    print(smi, flush=True)

    phase("21. nested sequences and the structured heads: the document "
          "classifiers, the CRF taggers, AlexNet, every new layer type")
    print(smi, flush=True)
    slice21 = nested_and_structured(torch, rnn, fop)
    print(smi, flush=True)

    phase("22. beam and speculative decode over the paged KV pool, the "
          "speculative NMT rung, the top-level API and the datasets")
    print(smi, flush=True)
    slice22 = paged_and_speculative(torch, fa, rnn, gen)
    print(smi, flush=True)

    phase("23. the layer tail, the VAE and the GAN, a v1 config through "
          "the CLI, SSD300's detection heads")
    print(smi, flush=True)
    slice23 = layer_tail(torch, rnn)
    print(smi, flush=True)

    phase("24. the flight recorder and the fleet: anomaly dumps, the "
          "host-fallback rescue, co-dispatch, FleetRouter under a SIGKILL, "
          "the verified cache, the online CTR loop, an incident and fleetz")
    print(smi, flush=True)
    torch.cuda.empty_cache()
    slice24 = flight_and_fleet(torch, rnn, sr, gen)
    print(smi, flush=True)

    phase("25. the kernels as custom ops, export_compiled / load_compiled "
          "and the verified cache, the recompile guard, the moe layer")
    print(smi, flush=True)
    slice25 = ops_export_guard_moe(torch, fop, fa, rnn, sr, gen)
    print(smi, flush=True)

    phase("26. the mesh: a one-rank NCCL world, then data-parallel, "
          "sequence-parallel, pipeline, expert-sharded and sharded-tier "
          "training over 2 gloo ranks sharing the card")
    print(smi, flush=True)
    mesh_work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        slice26 = the_mesh(torch, fop, mesh_work)
    finally:
        shutil.rmtree(mesh_work, ignore_errors=True)
    print(smi, flush=True)

    phase("27. the v1-era runtime: the native runtime and recordio, the "
          "elastic master, the v1 API on the card, the C inference ABI, "
          "api.SequenceGenerator and a py2 driver")
    print(smi, flush=True)
    v1_work = tempfile.mkdtemp(prefix="chip_smoke_v1_")
    try:
        slice27 = v1_runtime(torch, rnn, gen, v1_work)
    finally:
        shutil.rmtree(v1_work, ignore_errors=True)
    print(smi, flush=True)

    phase("28. head dim 256 on the main paths: (a) serving, (b) f32 LM "
          "training, (c) bf16 long-context training, through the D-split "
          "forms")
    print(smi, flush=True)
    slice28 = head_dim_256(torch, fa)
    print(smi, flush=True)

    phase("29. the Fluid-style op framework: the MLP op net eagerly and as "
          "a CUDA graph, a RecurrentOp eagerly and through scan_fn")
    op_framework(torch)

    phase("30. result")
    served = results[0]
    train = bwd[0]
    print(f"flash_attn_fwd launches: serving {launches}, training "
          f"{train_fwd}, paged beam and speculative "
          f"{slice22['b4f_launches']}", flush=True)

    def bwd_row(kernel, key):
        return {
            "name": f"flash_attn_bwd_{kernel}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "paddle_tpu/parallel/ring.py:265",
            "launches": sum(r[f"launches_bwd_{kernel}"]
                            for r in runs.values()),
            "max_abs_err": max(r["max_abs_err"][n] for r in bwd
                               for n in key),
            "ms": train[f"{kernel}_ms"],
            # the kernel's own time from torch.profiler (ms, like every
            # row's, is CUDA events over calls through the wrapper)
            "device_ms": train[f"{kernel}_device_ms"],
            "plain_ms": train["plain_ms"],
            "bound_ms": train[f"{kernel}_bound_ms"],
            "bound_by": train[f"{kernel}_bound_by"],
            "library_ms": train["library_ms"],
        }

    # the bf16 forms' numbers at the long-context trainer's shape; their
    # launches are phase 6d's flash arms' (the main path under the flag)
    long_fwd = next(r for r in results_bf16
                    if r["name"] == LONGCTX_SHAPE["name"])
    long_bwd = next(r for r in bwd_bf16
                    if r["name"] == LONGCTX_SHAPE["name"])

    def bf16_launched(counter):
        # phase 6d's flash arms and 26(c)'s Ulysses ranks
        return (sum(r["flash"]["launches"][counter] for r in longctx_runs)
                + slice26["c"]["ulysses"]["launches"][counter])

    def mesh_fused(counter):
        # 26(a)'s one-rank NCCL steps and 26(b)'s DP ranks
        return (slice26["a"]["launches"][counter]
                + slice26["b"]["f32"]["launches"][counter]
                + slice26["b"]["bf16"]["launches"][counter])

    def mesh_lstm(counter):
        # 26(b)'s DP classifier ranks (f32 and under the bf16 flag)
        return sum(slice26["b_cls"][a]["launches"].get(counter, 0)
                   for a in ("f32", "bf16"))

    def bwd_bf16_row(kernel, key):
        return {
            "name": f"flash_attn_bwd_{kernel}_bf16",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "paddle_tpu/parallel/ring.py:265",
            "launches": bf16_launched(f"bwd_{kernel}_bf16_launches"),
            "max_abs_err": max(r["max_abs_err"][n] for r in bwd_bf16
                               for n in key),
            "ms": long_bwd[f"{kernel}_ms"],
            "device_ms": long_bwd[f"{kernel}_device_ms"],
            "plain_ms": long_bwd["plain_ms"],
            "bound_ms": long_bwd[f"{kernel}_bound_ms"],
            "bound_by": long_bwd[f"{kernel}_bound_by"],
            "library_ms": long_bwd["library_ms"],
        }

    # the fused kernels' numbers at the res2 tail site at batch 64 (the
    # largest N of the training path)
    tail = next(t for t in fused_times if t["site"] == "res2_tail")

    # the bf16 forms' at the same site at batch 256 (bench_resnet50's)
    tail_bf16 = next(t for t in fused_times_bf16 if t["site"] == "res2_tail")

    def fused_row(kernel, tpu_line, launched, bf16=False):
        # the bf16 B1, B2 and B3 are the wgmma kernels (fwd_wgmma_kernel,
        # bwd_*_wgmma_kernel)
        return {
            "name": f"bn_act_conv1x1_{kernel}"
                    + ("_bf16_wgmma" if bf16 else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/bn_act_conv1x1.cu",
            "replaces": f"paddle_tpu/ops/pallas_fused.py:{tpu_line}",
            "launches": launched,
            "max_abs_err": (fused_err_bf16 if bf16 else fused_err)[kernel],
            **(tail_bf16 if bf16 else tail)[kernel],
        }

    # the sequence kernels' numbers at the path shapes (classifier layers,
    # NMT encoder); max_abs_err over every case of phase 10
    path = {"lstm": rnn_res["classifier_b64_t100_h256"],
            "gru": rnn_res["nmt_enc_b256_t32_h256"]}
    cls_launches = text_runs["classifier_kernels"]["launches"]
    nmt_launches = text_runs["nmt_kernels"]["launches"]

    # the grid route's numbers at bench_lstm's widest width (phase 10's
    # lstm_b64_t100_h1280), its launches phase 13c's kernel arms' (both
    # widths); max_abs_err over phase 10's LSTM cases on the grid route
    grid_at = rnn_res["lstm_b64_t100_h1280"]
    assert grid_at["fwd_plan"]["route"] == "grid", grid_at["fwd_plan"]
    assert grid_at["bwd_plan"]["route"] == "grid", grid_at["bwd_plan"]

    def wide_launched(counter, part="runs"):
        if part == "runs":
            return sum(w["runs"]["kernels"]["launches"][counter]
                       for w in wide.values())
        return sum(w["infer"]["launches"][counter] for w in wide.values())

    def grid_row(name, tpu_line, kind, launched):
        at = grid_at[kind]
        plan = "bwd_plan" if kind == "bwd" else "fwd_plan"
        return {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{tpu_line}",
            "launches": launched,
            "max_abs_err": max(r[kind]["max_abs_err"]
                               for r in rnn_res.values()
                               if r["cell"] == "lstm"
                               and r[plan]["route"] == "grid"),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            # as the rnn rows': cuDNN's LSTM is another function
            "library_ms": None,
        }

    # the GRU's grid route at the RNNsearch encoder's shape (phase 10's
    # gru_b80_t50_h1000), its launches phase 13d's kernel arms' (both
    # configurations); max_abs_err over phase 10's GRU cases on the grid
    # route; cuDNN's GRU (another function) beside it
    gru_grid_at = rnn_res["gru_b80_t50_h1000"]
    assert gru_grid_at["fwd_plan"]["route"] == "grid", gru_grid_at
    assert gru_grid_at["bwd_plan"]["route"] == "grid", gru_grid_at

    def gru_grid_row(name, tpu_line, kind, counter):
        at = gru_grid_at[kind]
        plan = "bwd_plan" if kind == "bwd" else "fwd_plan"
        return {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gru_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{tpu_line}",
            "launches": sum(w["runs"]["kernels"]["launches"][counter]
                            for w in wide_n.values()),
            "max_abs_err": max(r[kind]["max_abs_err"]
                               for r in rnn_res.values()
                               if r["cell"] == "gru"
                               and r[plan]["route"] == "grid"),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": None,
            "cudnn_ms": gru_grid_at[f"cudnn_{kind}_ms"],
        }

    def rnn_row(name, cell, tpu_line, kind, launched):
        at = path[cell][kind]
        return {
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{cell}_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{tpu_line}",
            "launches": launched,
            "max_abs_err": max(r[kind]["max_abs_err"]
                               for r in rnn_res.values()
                               if r["cell"] == cell),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            # no single PyTorch call computes these functions (peepholes,
            # the reset before the candidate product, masked carry);
            # cuDNN's LSTM/GRU time is printed in phase 10 as a
            # reference point of another function
            "library_ms": None,
        }

    def slice21_launched(counter):
        # phase 21's training runs: 21a's LSTM document classifier (every
        # arm: eager steps, the graph's warm-up and capture) and 21b's
        # taggers
        docs = slice21["docs"]["nested_lstm"]["launches"]
        return (sum(a.get(counter, 0) for a in docs.values())
                + sum(r["launches"].get(counter, 0)
                      for r in slice21["crf"].values()))

    def gen_launched(counter):
        # phase 20's paths on the cluster route: both training arms, the
        # generation encoder and the served encodes; phase 22(c)'s
        # encoder and its served encodes; phase 24(a)'s served encodes
        # and 24(b)'s on both rungs
        return (sum(gen["train"][arm]["launches"][counter]
                    for arm in ("fused", "generic"))
                + gen["enc_launches"][counter]
                + gen["serve"]["launches"][counter]
                + slice22["gru_launches"][counter]
                + slice24["flight"]["launches"][counter]
                + slice24["rescue"]["launches"][counter])

    def api_launched(counter):
        # phase 22(d)'s classifier through the top-level API and phase
        # 23(d)'s v1 config through the CLI
        return (slice22["api"]["launches"].get(counter, 0)
                + slice23["v1"]["launches"].get(counter, 0))

    def v1_launched(counter):
        # phase 27: (b) the v1 loop, (c) the C ABI in this process, (d)
        # the NMT encoder under api.SequenceGenerator, (e) the py2 driver
        return sum(slice27[k].get(counter, 0) for k in "bcde")

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/parallel/ring.py:265",
        "launches": launches + train_fwd + slice22["b4f_launches"],
        "max_abs_err": max(max(r["err_out"], r["err_lse"])
                           for r in results),
        "ms": served["kernel_ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"],
    }, bwd_row("dkv", ("dk", "dv")), bwd_row("dq", ("dq",)), {
        "name": "flash_attn_fwd_bf16",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/parallel/ring.py:265",
        "launches": bf16_launched("bf16_launches"),
        "max_abs_err": max(r["max_abs_err"] for r in results_bf16),
        "ms": long_fwd["kernel_ms"],
        "plain_ms": long_fwd["plain_ms"],
        "bound_ms": long_fwd["bound_ms"],
        "bound_by": long_fwd["bound_by"],
        "library_ms": long_fwd["library_ms"],
    }, bwd_bf16_row("dkv", ("dk", "dv")), bwd_bf16_row("dq", ("dq",)),
        fused_row("fwd", 71, infer["b1_launches"] + train_b["launches_fwd"]
                  + mesh_fused("fwd_launches")),
        fused_row("bwd_dx", 155, train_b["launches_bwd_dx"]
                  + mesh_fused("bwd_dx_launches")),
        fused_row("bwd_dw", 203, train_b["launches_bwd_dw"]
                  + mesh_fused("bwd_dw_launches")),
        fused_row("fwd", 71, train_amp["launches_bf16"]["fwd_bf16_launches"]
                  + mesh_fused("fwd_bf16_launches"), bf16=True),
        fused_row("bwd_dx", 155,
                  train_amp["launches_bf16"]["bwd_dx_bf16_launches"]
                  + mesh_fused("bwd_dx_bf16_launches"), bf16=True),
        fused_row("bwd_dw", 203,
                  train_amp["launches_bf16"]["bwd_dw_bf16_launches"]
                  + mesh_fused("bwd_dw_bf16_launches"), bf16=True),
        rnn_row("lstm_seq_fwd", "lstm", 311, "fwd",
                cls_launches["lstm_fwd_launches"]
                + slice21_launched("lstm_fwd_launches")
                + api_launched("lstm_fwd_launches")),
        rnn_row("lstm_seq_fwd_infer", "lstm", 311, "fwd_infer",
                cls_infer["launches"]["lstm_fwd_infer_launches"]
                + slice24["codispatch"]["b5_infer_launches"]
                + v1_launched("lstm_fwd_infer_cluster_launches")),
        rnn_row("lstm_seq_bwd", "lstm", 358, "bwd",
                cls_launches["lstm_bwd_launches"]
                + slice21_launched("lstm_bwd_launches")
                + api_launched("lstm_bwd_launches")),
        grid_row("lstm_seq_fwd_grid", 311, "fwd",
                 wide_launched("lstm_fwd_grid_launches")
                 + mesh_lstm("lstm_fwd_grid_launches")
                 + v1_launched("lstm_fwd_grid_launches")),
        grid_row("lstm_seq_fwd_infer_grid", 311, "fwd_infer",
                 wide_launched("lstm_fwd_infer_grid_launches", "infer")
                 + v1_launched("lstm_fwd_infer_grid_launches")),
        grid_row("lstm_seq_bwd_grid", 358, "bwd",
                 wide_launched("lstm_bwd_grid_launches")
                 + mesh_lstm("lstm_bwd_grid_launches")
                 + v1_launched("lstm_bwd_grid_launches")),
        rnn_row("gru_seq_fwd", "gru", 724, "fwd",
                nmt_launches["gru_fwd_launches"]
                + gen_launched("gru_fwd_launches")
                + v1_launched("gru_fwd_launches")),
        rnn_row("gru_seq_bwd", "gru", 657, "bwd",
                nmt_launches["gru_bwd_launches"]
                + gen_launched("gru_bwd_launches")),
        gru_grid_row("gru_seq_fwd_grid", 724, "fwd", "gru_fwd_grid_launches"),
        gru_grid_row("gru_seq_bwd_grid", 657, "bwd", "gru_bwd_grid_launches"),
        *sparse_kernel_rows(sparse_checks, sparse_times, standalone,
                            wide_deep, tier, slice24, slice26),
        *dsplit_kernel_rows(dsplit, slice28)]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving (bf16 and int8, direct, over HTTP,
on a device mesh and under the recycling supervisor), finetune, the finetune
protocol (``cli.train``, checkpoints, ``cli.serve --ckpt``, the val pass's
summaries on the card), self-supervised pretraining (``cli.pretrain``), the
raw-video path (``cli.summarize``, the extractors, on-device shot
selection), long-video finetune, sequence-parallel finetune and the
multi-GPU modes (data, tensor and pipeline parallelism, multi-process runs,
the int8 wire on a mesh) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line (any failure exits non-zero, no phase is
caught and passed over):

1. device: the card's name and power limit (``nvidia-smi``).
2. build: every CUDA kernel of the path (``nvcc``, one process per source,
   started together) and the host C++ eval runtime (``g++``), from this
   checkout's sources; the compilers' register/shared-memory report goes to
   stderr, and the registers and spill bytes of every instantiation of the
   bf16 serving attention (``masked_attention_mma_kernel``), the serving
   GEMMs (``gemm_bf16_wgmma_kernel``, with its dynamic shared memory, and
   the f32 ``gemm_f32_kernel``), the int8 GEMM
   (``int8_gemm_wgmma_kernel``, with its dynamic shared memory; a
   warpgroup product in its SASS) and the training GEMM
   (``bt_gemm_kernel``)
   and the f32 FMA attention (``fma_fwd_kernel``, ``fma_dq_kernel``,
   ``fma_dkdv_kernel`` in both training libraries, the forward in the
   serving one) to the build line, with the count of ``HGMMA``
   instructions in the serving GEMM's SASS and of ``LDGSTS`` (cp.async) in
   the FMA attention kernels' (``cuobjdump``), and those of the ring
   kernels (``ring_fwd_kernel``, ``ring_dq_kernel``, ``ring_dkdv_kernel``,
   the FMA attention's tiles) with their ``LDGSTS`` count. A GEMM, FMA
   attention or ring instantiation that spills, no ``HGMMA`` or no
   ``LDGSTS`` fails the run. ``sliced_ptxas``: the registers, spills and
   fixed dynamic shared memory of every head_dim-sliced instantiation
   (heads past 128 columns in 128-column slices), by library.
3. kernels: each route of the two hand-written kernels against its plain
   PyTorch version on the card, in bf16 and f32 (TF32 off), at the shapes
   the serving path gives it: the fused block at (B, N) = (32, 512) (the
   per-element route) and (8, 256) (the grouped route), flash attention at
   N = 6,016 and 1,280 (single pass; 1,280 is the bucket of the serve
   phase's 1,200-frame request, whose fused blocks run this attention at
   that shape in the same order) and 16,384 (key-folded). Each prints its
   max abs
   and relative RMS error and its tolerance (for attention also the error
   of a planted fault, one key tile dropped, which must fail that
   tolerance, and in bf16 the error against the other order of rounding P,
   which must be at least twice its own), the median CUDA-event time of
   the kernel, its plain version and one library call
   (``nn.TransformerEncoderLayer`` / ``F.scaled_dot_product_attention``,
   timed as a yardstick only; the port never calls them), and the bound:
   the larger of the bytes the function must move over the card's memory
   rate and its operations over the card's peak rate for the input type;
   the blocks and flash attention also give their own and the library
   call's device time (``torch.profiler``) and TFLOP/s; the f32 blocks
   three profiles in a row, each with its kernels by device time (the
   ``block_profile`` lines).
   gemm: each product of the serving block's chain (kernel 1's GEMMs) at
   (32, 512) and (8, 256) in bf16 and f32 (f32 in both tiles in turns, a
   request's rows alone bit-equal to the same rows in the batch, a skipped
   k tile failing the bound), and of the training block's (kernel 9:
   the forward's four, the backward's dX and split-K dW products) at
   (32, 512) in f32, alone: the path it took by its counter (a serving
   product on the ``mma.sync`` fallback fails the run), device ms,
   TFLOP/s, bound, its error (bf16 against the plain version; f32 against
   ``torch.matmul`` in f64 at the summation-order bound, two runs
   bit-equal), ``torch.matmul`` on the same operands (timed only), the
   two CTA shapes of the bf16 kernel in turns (bit-equal), and the dW
   products at half and twice their split. Then the int8 GEMM alone
   (``int8_gemm_lines``): kernel 13's four products at (32, 512) and (8,
   256) and the probe's shift product (18b) at 2048^3 and 8192^3, each
   with its tile, device ms, TOP/s and bound, bit-equal to the plain
   version (LayerNorm rows within 1e-5 in f32, one step in bf16, their
   codes the quantizer's), both CTA row counts in turns (bit-equal), a
   request's rows alone bit-equal to the batch's, a zeroed K tile failing
   the check, and ``torch._int_mm`` on the same codes (timed only).
   Then the serving attention alone at the shapes the serving path gives
   it, bf16 and f32, in both CTA shapes (64 and 128 query rows, timed in
   turns; both must give the same bits): the comparison behind
   ``ops/attention.mma_cta_rows``.
   int8 kernels: TPU kernels 13/14 (``ops/block_kernel_int8.py``: the
   int8 GEMM and quantizer of ``csrc/int8_gemm.cu`` with
   ``csrc/masked_attention.cu``) at (32, 512) and (8, 256), bf16 and f32,
   ``qk_int8`` off and on, against their plain version: |diff| at the median
   <= 5e-3 and at the max <= 5e-2 (``INT8_BOUND``), the share of bit-equal
   outputs, and the kernel run with one layer's QKV scales rolled by one
   channel (a planted fault; the check block's output channels are scaled
   log-uniformly in [1/2, 2] so that channels differ in absmax) must fail
   that bound; the median CUDA-event ms
   of the kernel, its plain version and the lossless bf16 (f32) block at
   the same shape (timed only), and the bound (the int8 products at the
   int8 peak, Q.K^T and P.V at the input type's peak, Q.K^T at the int8
   peak with ``qk_int8``, or the bytes); in bf16 with ``qk_int8`` off (the
   serving default) a ``block_profile`` line: the block's device time by
   kernel beside the lossless bf16 block's.
   int8 probe: TPU kernel 18 (``tools/probe_int8_mma.py``) at 2048^3, the
   probe's own measurement (ms, TOPS, ``torch.matmul`` / ``torch._int_mm``
   yardsticks; again at 8192^3, timed only), then 18b bit for bit and 18a
   within one bf16 step (plus an f32 summation-order bound) of their plain
   versions.
4. train kernels: the four training routes of the fused block
   (``ops/block_train.py``, TPU kernels 9-12) at (B, N) = (32, 512)
   (per-element) and (8, 256) (grouped), dropout 0.3, f32 and bf16 inputs,
   and at the pretrain recipe's (256, 384) (grouped, 98,304 rows) in f32:
   the forward, dx and all packed parameter grads against autograd of the
   plain version with the same dropout bits, each by an elementwise and a
   relative RMS bound at f32 summation-order level (rows with an fc1 input
   within rounding of 0 get a zero cotangent, so no ReLU branch flip enters
   the grads); the kernels run at seed + 1 (a planted fault) must
   fail them, and two backward runs must give identical bits. Prints the
   median CUDA-event ms of each route, its plain version and
   ``nn.TransformerEncoderLayer(dropout=0.3)`` in train mode (forward, and
   forward + backward; timed only), the bound against the f32 peak (the
   products are f32) and the memory rate, and a ``torch.profiler``
   breakdown of the (32, 512) f32 routes by kernel.
5. train attention kernels: the four routes of ``flash_attention_dropout``
   (``ops/attention_train.py``, TPU kernels 5-8) called directly at
   (B, H, N, Dh) = (2, 4, 8192, 64), valid lengths (8100, 5000), dropout
   0.3, f32 and bf16: o, lse, dq, dk and dv against the plain versions on
   the card (the folded one over the kernel's 64-key tiles) by an
   elementwise and a relative RMS bound; the kernels at seed + 1 must fail
   them, two backward runs must give identical bits, and in bf16 each
   forward route must lie at least twice as close to its own plain version
   as to the other route's (which shows that the tensor-core forwards still
   round where their TPU kernels round: normalised P in the single pass,
   the unnormalised e per 64-key tile in the fold). Prints the median
   CUDA-event ms of each route, its plain version and
   ``F.scaled_dot_product_attention(dropout_p=0.3)`` (forward, and forward +
   backward; timed only), and the bound (products at the input type's
   peak; in the f32 FMA family the backward's dp and dV at the f32 peak, in
   the bf16 tensor-core kernels of both routes dp at the bf16 peak and dV
   as three bf16 products, with the FMA family's bound beside it); the f32
   lines also the FMA rate on the valid keys' products, the share of live
   64-key tiles and the FMA kernels' ``ptxas`` registers and spills.
   ring kernels: TPU kernels 15-17 (``parallel/ring_attention.py``,
   ``csrc/ring_attention.cu``) against their plain steps: kernel 15 at
   (B, H, Nl, Dh) = (1, 4, 4,096, 64) (a 16,384-frame request over 4
   shards, bf16 K/V), kernels 16/17 at (4, 4, 2,048, 64) (batch 4 x 8,192
   frames, dropout 0.3), one shard partly padded: the o, m, l carries and
   dq, dk, dv within their bounds, also on shard 3's partly padded block
   (whole padded key tiles, which the kernels skip); an all-padded block
   leaves the carry (15, 16) and dq, dk, dv (17) bit for bit; planted
   faults fail them (a dropped key tile for 15, seed + 1 and the
   neighbouring shard's k0 for 16/17); two backward runs give identical
   bits; every CTA shape of each kernel gives identical bits. Prints each
   kernel's median CUDA-event ms, its plain step's, its bound (4 (17: 10)
   B H Nq Nk Dh at the f32 peak), its TFLOP/s and share of the bound, its
   CTA shape and ``ptxas`` registers and spills at head_dim 64, and the
   whole ring (16 launches each way) beside SDPA over the unsharded f32
   sequence (timed only); kernel 15's line also times the call with K/V
   already f32 (``ms_kv_f32``: the wrapper's widening is the difference).
   A ``ring_cta_variants`` line times each kernel in each of its CTA
   shapes (device ms, in turns) at kernel 15's grids for a 16,384- and a
   140,000-frame request and 16/17's here and in the seq step, at head_dim
   64, 96 and 128, beside the shape ``ring_cta_shape`` picks, and the device ms of every call
   (``device_ms``; ``ring_kernel_ms`` for the ring kernels alone) goes on
   the ``ring_kernel`` lines. Then the same checks of one
   step past the TPU kernels' VMEM envelope, where the CUDA routes take
   the kernels all the same: kernel 15 at Nl 8,192, kernels 16/17 at Nl
   4,096.
   d 512, d 384, d 768, d 192, d 320, d 896, d 1024: d_model 512 with 4
   heads (head_dim 128), 384 with 4 and 768 with 8 (head_dim 96), 192 with
   4 (48), 320 with 4 (80) and 896 with 8 (112) (the kernels run those
   head_dims zero-padded to 64, 96 and 128) and 1,024 with 8 (the widest
   rows the row kernels hold in registers) through every family against
   its plain version at small shapes (the block routes, the int8 block
   routes, the training block routes, the four training attention routes
   in bf16 and f32, the ring steps), then a WIDE_LAYERS-layer model of
   that shape: bf16 and f32 scores card against CPU, int8 scores within the lossy budget of the
   bf16 ones, one finetune step card against CPU (the fused block; past
   its training envelope, at d 896 and 1,024, the flash route).
   d640_h4, d1024_h4, d1280_h4, d1056_h8, d2048_h8, d200_h4 (WIDE_SLICED):
   the same checks of head_dims 160, 256 and 320 (two and three
   128-column slices in every attention family), of LayerNorm rows past
   1,024 columns and of a d_model off the 32-column grid, past head_dim
   128 also the int8 block with ``qk_int8``; the model part at 1 layer and
   256 frames, its step under STEP_SPARE / STEP_CAP. Planted faults, every
   run: attention on Q and K with their second slice zeroed must fail the
   attention bound, rows normalised over their first 1,024 columns only
   must fail the block bound.
   wide_path: the slice's main paths at d_model 1,024 with 4 heads
   (head_dim 256), 4 layers: the 13 serving requests in bf16, f32 and on
   the int8 wire (served == solo; the shorter ones against the CPU; int8
   within its budget of bf16), a finetune step and a pretrain step card
   against CPU, the pretrain batch (256, 384) on the card, and a
   16,384-frame request over the ring of a (1, 4) mesh of cuda:0.
5c. pglsum: PGL-SUM's kernels at the shapes of the ``serve-pglsum-long``
   cell (eight videos of 2,401-14,400 rows, odd lengths among them, in
   their 14,464-row bucket): ``fma_fwd_posbias_kernel`` on the global
   branch's (8, 8, 14,464, 128) and the local branch's (32, 4, 3,616, 64)
   elements against the plain version over the valid rows at the f32
   attention tolerance (the attention without the bias must fail it), the
   fusion and both LayerNorms (``l2_fuse_kernel``, ``layernorm_rows_kernel``)
   at 14,400 and 115,712 rows of 1,024 against theirs at the f32 block
   tolerance (an L1 norm in the fusion and a LayerNorm that keeps the mean
   must fail it), each with its CUDA-event ms, its plain version's and its
   bound; then one ``PGLSum`` forward of the batch through
   ``make_eval_forward`` at the published widths with PGL-SUM's counters
   set to 0 before it: 17 launches (12 GEMMs, 2 attention, 3 row launches),
   32 segments, no staged operand or GEMM fallback, every video within
   1e-5 of ``benchmark/reference/pglsum.py``; its ms and peak bytes.
6. serve: ``ScoringService`` with seeded flagship weights (d 256, 4 heads,
   4 layers, bf16) takes 13 requests: 320/480/512 frames with auto-KTS,
   1,200 frames, 6,000 frames (past the block envelope: flash) and 16,384
   frames (key-folded), the last two with given shots. Checks: every future
   resolves, summaries are binary and within budget, every route's launch
   counter moved during this phase (counters are zeroed just before it),
   and each request's served scores equal its solo ``make_eval_forward``
   scores bit for bit.
   serve f32: the same 13 requests at ``ModelConfig()``'s default dtype,
   f32 (the ``cli.serve`` model): the same checks on the f32 chain (the
   FMA GEMM and attention), no product on a fallback, no attention
   staged; wall, p50/p95 and launches on the ``serve_f32`` line.
   serve int8: the same 13 requests through ``ScoringService(attn_impl=
   "int8_block", wire_dtype="int8")``: both int8 counters and both flash
   counters must move (384-frame bucket at batch 4: kernel 14; 512 and
   1,280: kernel 13; 6,016 and 16,384 leave quantisation for flash), each
   request's scores equal its solo scores on the same dequantised input bit
   for bit and lie within the lossy budget (median < 2e-2, max < 1.5e-1) of
   the lossless bf16 route's solo scores; summaries binary, within budget.
   serve http: ``serve_http.make_server`` on 127.0.0.1 over an int8 service:
   three ``.npz`` requests answered 200 with the service's own scores, then
   a 413 (body past the cap) and a 404.
   serve mesh: ``ScoringService(mesh=<(1, 4) mesh of cuda:0>,
   long_threshold=8,192)``, bf16: 8 short requests (320/480/512 frames) on
   the single-device batch path (the entries repeat one card), 16,384 and
   20,000 frames over the ring; kernel 15 and the short routes' kernels
   must launch; served scores equal the direct solo /
   ``make_seq_sharded_forward`` scores bit for bit; an f32 16,384-frame
   long request lies within 2e-4 of the single-device f32 route; prints the
   bf16 |dp| against the single-device route. Then a service with the
   default threshold (139,136 frames in bf16) serves a 140,000-frame
   request over the ring (Nl 35,072): kernel 15 launches 64 times, served
   == direct.
   ring multi card: with two or more cards, the 16,384-frame ring over two
   cards bit-equal to one card; with one, a stated skip.
7. train: the finetune recipe (d 256, 4 heads, 4 layers, dropout 0.3, Adam
   lr 1e-3 / wd 1e-4, batch 4, f32) with seeded weights on in-memory videos
   in the DSNet schema made with numpy from ``--seed``: first one step on
   the first long batch on the card and on the CPU's plain path with the
   same dropout seeds (loss and each parameter's gradient must agree), and
   (a) the same on the ``"flash"`` route (N = 1,152: TPU kernels 5/6) with
   the same residual and MLP keep masks and attention seeds on both sides;
   then, with the counters zeroed, 10 epochs of ``_train_epoch`` over 8
   short videos (100-380 frames: grouped routes) and over 8 long ones
   (520-1,100 frames: per-element routes), 20 steps each, and ``_val_epoch``
   over 4 videos. Checks: finite losses, all four block training counters
   moved, val F in [0, 100] and finite tau/rho. Prints the CUDA-event ms per
   step (median, quartiles, range) at the recipe's shapes and at (32, 512),
   and a ``torch.profiler`` breakdown of both steps (device busy share,
   the attention kernels' share, kernels by device time). (d) With the
   counters zeroed, 3 epochs in f32 on the ``"flash"`` route over the long
   set (buckets up to 1,152: the f32 single-pass kernels, TPU kernels
   5/6): each step launches both once per layer, with D from the
   forward's o (no first pass), and nothing else of the training
   kernels; step ms and a profile of one step.
7b. finetune: the finetune protocol through its entry points at the
   recipe's width (d 256, 4 heads, 4 layers, dropout 0.3, f32, batch 4),
   on 20 numpy-made videos in the DSNet schema (``video_1`` ...
   ``video_20``: 12 of 100-380 frames, 8 of 520-1,100) that a stand-in for
   ``train.finetune.fold_datasets`` serves in place of the h5 files (the
   card's machine has no h5py). (1) ``cli.train.main`` with a split file
   of 2 folds (16 train / 4 val keys each), 3 epochs, ``--metrics`` and
   ``--profile_dir``: the printed F in [0, 100] and finite tau/rho, 6
   metric records and the final one, ``model_mae.ckpt``,
   ``train_state.ckpt`` and ``summary.json`` written, the trace naming
   ``bt_gemm_kernel`` and an FMA attention kernel, all four block training
   counters and a serving block counter moved (counters zeroed just
   before), the training attention ones not. (2) Exact resume: fold 0
   three epochs straight and two then ``resume=True`` to three through
   ``train.finetune.finetune``: both checkpoint files bit-equal (parameters
   and Adam moments) and the epoch-2 metric records equal but ``ts``. (3)
   ``cli.serve``'s ``load_model`` and ``make_service`` from ``--ckpt`` on
   step 1's ``model_mae.ckpt`` score the last fold's 4 val videos (with
   their shots) bit-equal to a service over the trained model, with equal
   picks. The line gives the epoch and fold walls, each epoch's train, val
   and checkpoint-copy seconds (host clocks around the loop's stages) and
   their median shares, the checkpoint writes' seconds on the writer's
   thread, ``count_params``, the counters and the checks, beside the card
   and its power limit.
7c. pretrain: ``cli.pretrain.main`` at the ``run_pretrain.sh`` width (d 256,
   4 heads, 4 layers, dropout 0.2, lr 1e-3, batch 256, f32; 2 epochs, the
   recipe's 200 cut to 2) over 520 numpy-made clips of 60-380 frames (the
   second cut: the schedule's 13,000 samples make 50 steps an epoch)
   (``frames/*.npy`` + ``video/*.npy``, 1024-d features, 512-d reps, about
   0.45 GB in a temporary directory): 2 steps an epoch at (256, 384), every
   layer of every step on the grouped block training routes (TPU kernels
   11/12, counters zeroed before); finite losses; the frozen
   ``video_transform`` equal to its initial bits; both checkpoint files
   written. Then ``--epochs 1`` and ``--resume --epochs 2`` in a second
   directory: history, parameters, Adam state and the encoder file bit for
   bit those of the straight run. Then one step at the recipe width cut to
   ``CPU_CHECK_LAYERS`` (2) layers on
   batches of 16, card against the CPU's plain path with the same dropout
   seeds (the four losses within 1e-4 relative, each grad by the step
   bound with at most 0.1 % of a tensor's entries past its elementwise
   part and none by more than 0.1 % of the largest grad,
   ``video_transform`` unmoved
   on both): with a 600-frame clip
   (bucket 640: kernels 9/10) and at bucket 384 (11/12). The line gives the
   steps' CUDA-event ms, each epoch's host clocks (collation, step calls,
   checkpoint copy, the rest), the load and write seconds, peak memory,
   the launches and the card-vs-CPU figures.
   (1b) ``cli.train`` again on the same folds with ``--eval_impl device``:
   every metric record (F, tau, rho, the losses), the printed result and
   the trained model equal the host run's bit for bit; the line gives each
   epoch's val pass and its summaries-and-metrics seconds on both routes.
7d. recycle: ``python -m vidsum_tpu_torch.cli.serve --recycle_after_requests
   4 --warmup ""`` started as a supervisor from the repo root (the f32
   ``ModelConfig()`` service, random weights); 12 requests of 60-512 frames
   posted 0.6 s apart all answered 200 with one finite score a frame; the
   log shows at least 2 recycles and no worker crash; SIGINT ends it with
   0. The line gives requests, recycles, worker generations and wall.
7e. summarize: ``cli.summarize.main`` at its defaults (``ModelConfig()``,
   f32, GoogLeNet pool5 at 224, budget 0.15) with seeded scorer weights in a
   port checkpoint and seeded GoogLeNet weights in a torchvision-layout
   ``.pth``, over three numpy-made videos fed through the decoder seam
   (``preprocess.reduce_fps.iter_reduced_frames``; the card's machine has no
   cv2 or PIL): 480, 2,400 and 7,200 samples at 2 fps of 30-fps videos (4,
   20 and 60 minutes), 224 x 398 frames in scenes of 8-31 s with per-frame
   noise (``SyntheticVideos``), under PyTorch's default cuDNN flags (TF32
   allowed: the backbones turn it off for their own calls). At 480 and
   2,400 with ``--kts_impl host`` and ``device``: equal change points and
   selected frames; at 7,200 the device KTS only. Each run: binary summary
   within budget, finite scores, its wall, the decode stand-in's seconds,
   peak memory and launches (zeroed before each run): the fused block
   (rows 1/2) at 480, the flash route (rows 3/4) at 7,200. Then the 7,200
   video through ``summarize_video(mesh=make_mesh((1, 4), cuda:0))``:
   kernel 15 launches and its scores lie within 2e-4 of the single-device
   route's. Then the 480 video's features and scores on the card against
   the port's CPU run of the same path (``FEATURE_TOL``, ``SCORE_TOL``; one
   inception branch's weights rolled by one output channel must fail);
   each stage of the real path per video (``breakdown``: ``_begin_video``
   and ``_finish_video`` with ``embed`` and ``score_features`` timed in
   CUDA events, each KTS route and the selection in the host clock); and
   the 2,400 and 7,200 videos' card scores (the fused block at T 2,432,
   the flash single pass at 7,296, the mesh's ring) against the plain
   dense route on the CPU over the same features (``scores_vs_plain``:
   ``SCORE_TOL``, the mesh ``MESH_SCORE_TOL``; a scorer with one layer's
   value weights rolled by one channel must fail each).
7f. extract: ``FeatureExtractor("google")`` on 64 frames at 224 and
   ``("r3d18")`` on a 16-frame clip at 112, card against CPU (the same
   bound and planted fault), their ms; ``device_normalize`` on the card
   against the host normalisation over every uint8 value (max ULP); then
   ``entry_from_features`` of the 480 video from card and CPU features: the
   same change points, user summaries and gtscore.
7g. device eval: ``device_generate_summary`` in one call on the card over
   1,000 videos of the JAX fuzz's flavours and seed
   (``eval_fuzz_video``), against the host oracle ``generate_summary``:
   zero mismatches; both calls' ms and the host's.
8. long train: (b) the ``"flash"`` route on one 8,100-frame video (bucket
   8,192, f32: the folded route, TPU kernels 7/8), card against CPU as in
   (a), the flagship cut to ``CPU_CHECK_LAYERS`` (2) layers; (c) with the counters zeroed before each, 5 recipe epochs on the
   auto route over 8 videos of 7,950-9,000 frames (10 steps at batch 4),
   once in f32 (demoted to the folded route) and once in bf16 (the
   single-pass route), then 5 in bf16 over 8 videos of 11,000-14,000
   frames (buckets 11,008-14,080, past the single pass's 10,880: the
   folded route's tensor-core kernels). Checks: finite losses, each step
   launched its route's kernels once per layer and the other training
   attention route and the block training kernels not at all (the
   demotion), all four training attention counters moved; after the bf16
   folded run its two kernels are held against the plain fold at the
   largest bucket it gave them (batch 4, the 4 longest videos' valid
   lengths) as in phase 5 (bounds, seed + 1 fault, identical backward
   bits). Prints the step ms (median, quartiles, range), wall time, peak
   memory and a ``torch.profiler`` breakdown of one step per run.
   seq train: ``make_seq_sharded_finetune_step`` on a (1, 4) mesh of
   cuda:0: one step on one 8,100-frame video (f32, dropout 0.3, the
   flagship cut to 1 layer for the CPU's sake) against the CPU's plain
   path with the same seeds (per parameter, the step bound), one step at
   N 8,320 (an odd multiple of 128: shards of 2,080 frames, padded to
   2,112 for the kernels' 64-key tiles) against the plain ring on the card,
   then 5 recipe epochs over phase 8's videos in buckets of 512 (10 steps,
   Nl <= 2,304): kernels 16 and 17 launch 16 times per layer per step, the
   flash and block training kernels never; finite losses; step ms, peak
   memory and a ``torch.profiler`` breakdown of one step.
8b. the multi-GPU modes, every mesh's entries cuda:0 (the machine has one
   card): ``dp_train`` (the kernels' data-parallel step on (4, 1) at
   (32, 512) against the one-device fused step, a dropped shard failing;
   at dropout 0.3 against its shards' replay, two runs bit-equal; a
   padded final batch on (2, 1) against the smaller batch; step ms and a
   profile beside the one-device step's), ``tp_train`` (dp x tp on (2, 2)
   and (1, 4) against the one-device dense step, dropped partials failing;
   the (2, 2) pretrain step at (256, 384) against the one-device one),
   ``pp_train`` (the pipeline on 2 and 4 stages against the dense forward
   and step, a wrong owner failing), ``finetune_mesh`` (``cli.train --dp``
   bit-equal to the plain CLI run; ``finetune(mesh=)`` on (4, 1) with its
   epoch walls), ``distributed`` (two gloo processes of 2 entries, spawned
   as ``chip_smoke.py --dist-worker ...``, bit-equal to one process of 4;
   coordinator-only files; a killed coordinator and a resume bit-equal to
   the straight run) and ``serve_mesh_int8`` (the 13 requests on the int8
   wire over (1, 4): shorts bit-equal to the single-device int8 service,
   the long one to the lossless ring; ``make_replica_forward_int8`` over
   four entries; ``cli.serve --devices 2``). Every step comparison is the
   step bound per parameter (``compare_steps``).
9. a ``timeline`` line (each phase's wall seconds), then the ``kernels``
   line (29 routes, the f32 serving ones named
   ``<route>.f32`` with their launches from the f32 serve pass, the
   training attention ones named
   ``attention_train.<route>``, the folded ones also in bf16 as
   ``attention_train.<route>.bf16``, the single-pass ones also in f32 as
   ``attention_train.<route>.f32``, the int8 ones ``block_int8``,
   ``block_int8_grouped``, ``probe_mm_bf16`` and ``probe_mm_int8``, the
   ring ones ``ring_block``, ``ring_train_fwd``, ``ring_train_bwd``,
   PGL-SUM's ``attention_posbias`` and ``row_norms`` (phase 5c's numbers;
   PGL-SUM has no TPU kernel); the
   GEMM routes with their design and ``ptxas`` report; the f32 serving
   routes and the ring also ``launches_summarize``, phase 7e's launches;
   rows 9-12 ``launches_dp_train`` and ``launches_finetune_mesh``, the int8
   wire's routes ``launches_serve_mesh_int8``, phase 8b's; every route
   run at the widths past the old limits ``launches_wide`` (the
   WIDE_SLICED checks) and ``launches_wide_path``),
   the card's name
   and power limit, and last ``{"ok": true, "device": {...}}``. No
   product of any phase may take a serving GEMM fallback, and no f32
   attention may stage its operands.

    python3 chip_smoke.py --compare PARENT_DIR

runs the kernel phases (kernels, gemm, int8 kernels, int8 probe, train
kernels, train attention kernels, ring kernels), the train phase, mesh
serving and the sequence-parallel step of the checkout at PARENT_DIR and
of this one in turns (parent, change, change, parent), each from its own
tree and build, and prints their lines after a ``compare_turn`` line per
turn.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Dense peaks of the card the runs measured (NVIDIA H100 SXM data sheet):
# bf16 tensor cores, f32 outside the tensor cores (the kernels' f32 path does
# exact f32 FMA), int8 tensor cores (TOP/s), memory rate. Another card needs
# its own entry.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                              "int8": 1979e12, "bytes": 3.35e12},
}
# Per kernel and dtype: elementwise |got - want| <= atol + rtol |want|, and
# the relative RMS error ||got - want|| / ||want|| <= rel. The attention
# outputs at these shapes are means over thousands of keys (typical size
# 0.01-0.02), so their bounds are absolute ones far below that size, rtol one
# bf16 step; a kernel that drops one 64-key tile fails them (checked below,
# every run). The bf16 block bound is the JAX tests' own
# (tests/test_block_kernel.py) on outputs of size 1.
TOL = {
    # one GEMM of the serving chain: its products are exact in f32 (bf16
    # operands), so the f32 output differs from the plain version by
    # summation order and the bf16 output by one bf16 step (the card tests'
    # bounds, tests/test_torch_cuda.py)
    ("gemm", "bfloat16"): dict(atol=1e-2, rtol=8e-3, rel=1e-2),
    ("gemm", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("block", "bfloat16"): dict(atol=5e-2, rtol=5e-2, rel=1e-2),
    ("block", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("attention", "bfloat16"): dict(atol=2e-3, rtol=8e-3, rel=1e-2),
    ("attention", "float32"): dict(atol=1e-5, rtol=1e-5, rel=1e-5),
    # training block: forward outputs are LayerNorm outputs of size 1 (the
    # block bounds); gradients are sums over up to B*N rows whose size
    # varies by parameter, so their atol is relative to the tensor's largest
    # entry. In f32 kernel and plain version differ by summation order
    # (measured relative RMS 1e-7 to 7e-7 on every tensor), and the check
    # keeps it so: rows whose fc1 input lies within NEAR_ZERO of 0 get a zero
    # cotangent (see phase_train_kernels), since there the ReLU may take the
    # other branch in the two versions and move the row's grads by a real
    # amount. The kernels run at seed + 1 are off by ~0.3. With bf16 inputs
    # the output and dx are also rounded to bf16 (one step)
    ("train_fwd", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("train_fwd", "bfloat16"): dict(atol=5e-2, rtol=5e-2, rel=1e-2),
    ("train_grad", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("train_dx", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("train_dx", "bfloat16"): dict(atol=1e-2, rtol=1e-2, rel=1e-2),
    # a whole 4-layer finetune step, card against CPU, each parameter's grad
    # on its own: atol relative to the largest grad of the step, relative
    # RMS per tensor. Here no row can be spared a ReLU flip (attention mixes
    # rows between layers), and a flip in a later layer moves every grad
    # upstream of it by a relative RMS of up to ~1e-3 (measured 3e-5 to
    # 9e-4, the embed weight's the largest: its grad is a sum of rank-one
    # terms that mostly cancel). This check is for the wiring (the autograd
    # Function, the packing of Q/K/V, a grad reaching the wrong parameter:
    # errors of order 1); the kernels' precision is held by the f32 bounds
    # above. A grad whose reference norm is at rounding level (below
    # ROUNDING_NORM of the largest: the key bias's, which softmax's shift
    # invariance makes 0) is held by the elementwise bound only
    ("step_grad", "float32"): dict(atol=1e-4, rtol=1e-3, rel=2e-3),
    # training attention (TPU kernels 5-8): o at the slice-1 attention
    # bounds; lse at f32 summation-order level in both dtypes; grads with
    # atol relative to the tensor's largest entry, f32 at summation-order
    # level, bf16 one bf16 step (ds is rounded to bf16 before dq and dk, and
    # the outputs are bf16). The kernels run at seed + 1 are off by ~0.5
    ("attn_train_o", "float32"): dict(atol=1e-5, rtol=1e-5, rel=1e-5),
    ("attn_train_o", "bfloat16"): dict(atol=2e-3, rtol=8e-3, rel=1e-2),
    ("attn_train_lse", "float32"): dict(atol=1e-5, rtol=1e-5, rel=1e-6),
    ("attn_train_lse", "bfloat16"): dict(atol=1e-5, rtol=1e-5, rel=1e-6),
    ("attn_train_grad", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("attn_train_grad", "bfloat16"): dict(atol=1e-2, rtol=1e-2, rel=1e-2),
}
# The ring kernels (TPU kernels 15-17) against their plain steps: the carries
# m and l at the f32 attention bound; o is unnormalised (a sum over thousands
# of keys, size ~10-50), so its atol is relative to its largest entry, as for
# the grads, which take the training attention's grad bound
RING_GRAD = ("attn_train_grad", "float32")
# The int8 block (TPU kernels 13/14) against its plain version: |got - want|
# at the median and at the max, the JAX tests' own limits
# (tests/test_quant.py:94-107) on LayerNorm outputs of size 1. Kernel and
# plain version share their int8 codes except where an f32 summation order
# moves a value across a rounding boundary; one flipped code moves its row
# by about one quantisation step. The int8 route against the lossless bf16
# one on the same requests: |dp| of the sigmoid scores, the lossy budget of
# tests/test_quant.py:65-79.
INT8_BOUND = dict(median=5e-3, max=5e-2)
INT8_VS_BF16 = dict(median=2e-2, max=1.5e-1)
# fc1 inputs nearer 0 than this share of their RMS may take the other ReLU
# branch in kernel and plain version (their difference is < 2e-5 of the RMS)
NEAR_ZERO = 2e-4
ROUNDING_NORM = 1e-6
# what the kernels line says of TPU kernels 3 and 4's bf16 kernel
SERVING_ATTENTION_DESIGN = (
    "bf16: masked_attention_mma_kernel, mma.sync m16n8k16 on K/V tiles "
    "double-buffered by 16-byte cp.async, only the 64-key tiles that hold an "
    "unpadded key walked, 128-query CTAs (8 warps) where the grid fills the "
    "card else 64 (ops/attention.mma_cta_rows), exp as ex2.approx, at most "
    "128 registers a thread at 8 warps; f32: attention_core.cuh's "
    "fma_fwd_kernel (SERVING_F32_DESIGN)")


# what the kernels line says of the serving block's bf16 GEMM (TPU kernels
# 1, 2 and the probe's 18a) and of the training block's f32 GEMM (9-12)
SERVING_GEMM_DESIGN = (
    "bf16: gemm_bf16_wgmma_kernel, wgmma.mma_async m64nNk16 (N 128 or 256) "
    "from a 4-stage ring of 64-deep 128-byte-swizzled tiles filled by TMA "
    "(one producer warp, mbarriers), 128-row CTAs (two consumer "
    "warpgroups) or 64 where the grid is small (ops/block_kernel."
    "gemm_cta_rows), LayerNorm rows reduced by quad shuffles; the mma.sync "
    "kernel only for operands TMA cannot take (gemm_bias_epilogue."
    "fallback_launches); f32: gemm_f32_kernel (SERVING_F32_DESIGN)")
# what the kernels line says of the f32 serving chain (TPU kernels 1-4 in
# f32, the default ModelConfig's service)
SERVING_F32_DESIGN = (
    "products: gemm_f32_kernel, exact f32 FMAs on fma_gemm.cuh's mainloop "
    "(bt_gemm's: 8 x 8 a thread read as float4 from k-major shared tiles "
    "16 deep, 16-byte loads double buffered under the FMAs), 128 x 128 "
    "CTAs, or 64 x 64 of 4 x 4 a thread where the grid is small "
    "(ops/block_kernel.gemm_f32_tile), no split-k, LayerNorm rows by the "
    "row kernel; attention: attention_core.cuh's fma_fwd_kernel (the f32 "
    "training forward: 8 x 8 a thread, 4 x 8 at head_dim 96 and 128, from "
    "cp.async-filled row-major tiles, live 64-key tiles only, one online "
    "pass, any N), no dropout, no lse; a row's bits independent of the "
    "batch")
# what the kernels line says of the f32 training attention (TPU kernels 5-8
# in f32; the training block's attention launches the same kernels)
FMA_ATTENTION_DESIGN = (
    "f32: fma_fwd_kernel / fma_dq_kernel / fma_dkdv_kernel, exact f32 FMAs, "
    "8 x 8 a thread (4 x 8 at head_dim 128) read as float4 from row-major "
    "shared tiles that 16-byte cp.async streams in (dQ, dK/dV double "
    "buffered), only the 64-key tiles that hold an unpadded key walked, one "
    "online forward pass on both routes, D = rowsum(dO o) given o, two "
    "thread groups a backward CTA, 128-row CTAs where the grid fills the "
    "card else 64")
# what the kernels line says of the int8 GEMM (the products of TPU kernels
# 13/14 and the probe's 18b)
INT8_GEMM_DESIGN = (
    "int8_gemm_wgmma_kernel: wgmma.mma_async m64nNk32 s32.s8.s8 (N 128 or "
    "256) from a 4-stage ring of 128-deep 128-byte-swizzled tiles filled by "
    "TMA (one producer warp, mbarriers, setmaxnreg 40/232), 128- or 64-row "
    "CTAs x 256 or 128 columns by ops/quant.int8_gemm_tile; epilogues on "
    "the accumulator fragments (dequantise, bias, ReLU, residual, the "
    "probe's shift), a LayerNorm row of <= 256 columns staged through the "
    "idle ring and finished by one warp with its int8 codes, wider rows by "
    "the row kernel; "
    "operands off 16 bytes copied onto them (int8_gemm.fallback_launches)")
# what the kernels line says of the ring (TPU kernels 15-17)
RING_DESIGN = (
    "ring_fwd_kernel / ring_dq_kernel / ring_dkdv_kernel on attention_core."
    "cuh's FMA tiles: exact f32 FMAs, 8 x 8 a thread (4 x 8 at head_dim 96 "
    "and 128) read as float4 from row-major shared tiles that 16-byte "
    "cp.async streams in (dQ, dK/dV double buffered), only the 64-key tiles "
    "that hold an unpadded key walked (a block with none passes its carry "
    "or dq/dk/dv through), the carry m in natural units, ex2 per score, "
    "two thread groups a backward CTA; at head_dim <= 64 CTAs 16 threads "
    "deep of 8 or 4 rows a thread, whichever grid ends soonest at the "
    "card's occupancy (parallel/ring_attention.ring_cta_shape), past it one "
    "shape; bf16 K/V widened to f32 before kernel 15")
TRAIN_GEMM_DESIGN = (
    "bt_gemm_kernel on fma_gemm.cuh's mainloop (shared with the f32 serving "
    "GEMM): exact f32 FMAs, 128 x 128 CTAs, 8 x 8 a thread read "
    "as float4 from k-major shared tiles 16 deep, double buffered by 16-byte "
    "cp.async (row-contiguous operands) or 16-byte register staging "
    "(k-contiguous ones), two CTAs an SM; split-K partials summed in order")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def line(**kw) -> None:
    """A phase's line keyed by its name: ``{"pretrain": {...}}``."""
    print(json.dumps(kw), flush=True)


def peaks_for(name: str) -> dict:
    if name not in PEAKS:
        raise RuntimeError(f"no peak rates for {name!r}: add the card's "
                           f"data-sheet peaks to PEAKS")
    return PEAKS[name]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    return statistics.median(cuda_times(fn, reps, warmup))


def cuda_times(fn, reps: int, warmup: int = 2) -> list:
    """CUDA-event times of ``reps`` runs of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def spread(times: list) -> dict:
    """Median, quartiles and range of a list of times."""
    q1, _, q3 = statistics.quantiles(times, n=4)
    return {"n": len(times), "median": statistics.median(times), "q1": q1,
            "q3": q3, "min": min(times), "max": max(times)}


def device_profile(fn, reps: int, top: int = 8, groups=None) -> dict:
    """``fn`` run ``reps`` times under ``torch.profiler``: host wall ms per
    run (ending in a synchronise), device kernel ms per run, the device's
    busy share of the wall, and the ``top`` kernels by device time (ms per
    run, launches per run); with ``groups`` ({group: name substrings}) also
    each group's device ms per run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler now and then lists no kernel, or a part of the launches,
    # for a window (seen on the card: a chain's device time read at half
    # its value in one window of several): every call launches the same
    # kernels, so take the window again until each kernel's launches are a
    # multiple of the calls
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        kernels = {}
        for e in prof.events():
            # kernels only: a range annotation (Optimizer.step) spans others
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                ms, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                   n + 1)
        if kernels and not any(n % reps for _, n in kernels.values()):
            break
    device = sum(ms for ms, _ in kernels.values()) / reps
    attention = sum(ms for name, (ms, _) in kernels.items()
                    if any(t in name for t in ATTENTION_KERNELS)) / reps
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"wall_ms": wall, "device_ms": device,
           "busy_share": device / wall if wall else None,
           "attention_ms": attention,
           "attention_share": attention / device if device else None,
           "top": [[name[:60], ms / reps, n / reps]
                   for name, (ms, n) in ranked]}
    if groups:
        out["groups_ms"] = {g: sum(ms for name, (ms, _) in kernels.items()
                                   if any(t in name for t in subs)) / reps
                            for g, subs in groups.items()}
    return out


# what names the attention kernels in a profile: the training attention
# families (vs::attn, vs::attn_mma), the serving attention and the ring's
ATTENTION_KERNELS = ("attn::", "attention", "ring_")


def pad_mask(B: int, N: int, rng, device):
    """Key padding with a ragged tail per row and >= 1 real key per row."""
    import numpy as np
    import torch

    m = np.zeros((B, N), bool)
    for b in range(B):
        m[b, int(rng.integers(N // 2, N + 1)):] = True
    return torch.from_numpy(m).to(device)


def errors(got, want) -> tuple:
    """(max abs error, relative RMS error); inf if got is not finite."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf")
    diff = g - w
    return (float(diff.abs().max()),
            float(diff.norm() / w.norm().clamp_min(1e-30)))


def within(got, want, tol: dict) -> bool:
    g, w = got.float(), want.float()
    _, rel = errors(got, want)
    return bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all()
                ) and rel <= tol["rel"]


def check_close(got, want, tol: dict, what: str = "") -> tuple:
    err, rel = errors(got, want)
    if not within(got, want, tol):
        raise AssertionError(f"kernel disagrees with its plain version{what}: "
                             f"max abs err {err}, relative RMS {rel} "
                             f"(tolerance {tol})")
    return err, rel


def scaled(tol: dict, want) -> dict:
    """``tol`` with its atol relative to the largest entry of ``want``."""
    return {**tol, "atol": tol["atol"] * float(want.float().abs().max())}


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return {"smi": smi, "name": name}


def ptxas_report(log: str, kernel: str) -> list:
    """Registers and spill bytes (stores, loads) that ``ptxas -v`` reports
    for each instantiation of ``kernel`` in an nvcc log, by demangled name
    (``c++filt``) where the toolkit's host has it."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur is not None:
            cur["static_smem"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            o["kernel"] for o in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
    except OSError:
        names = []
    for o, name in zip(out, names):
        o["kernel"] = name.replace("(anonymous namespace)::",
                                   "").split("(")[0].removeprefix("void ")
    return [o for o in out if kernel in o["kernel"]]


def sass_count(lib: str, op: str, function: str = "") -> int:
    """How many ``op`` instructions ``cuobjdump -sass`` lists in a built
    library (the toolkit's cuobjdump, beside nvcc), in the functions whose
    (mangled) name holds ``function``."""
    from vidsum_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    n, inside = 0, not function
    for line in sass.splitlines():
        if "Function : " in line:
            inside = function in line
        elif inside and op in line:
            n += 1
    return n


# The fixed dynamic shared memory of the head_dim-sliced instantiations
# (bytes, without the live-tile list that follows it), by the formulas of
# the sources (the unsliced kernels' at head_dim 128 in the same CTA
# shapes; each launcher's note states them)
SLICED_SMEM = {
    "masked_attention_mma_sliced_kernel": 87168,   # 63,104 with QK8
    "masked_attention_q8_sliced_kernel": 116480,
    "fma_fwd_sliced_kernel": 119872,
    "fma_dq_sliced_kernel": 178304,
    "fma_dkdv_sliced_kernel": 188416,
    "fwd_mma_sliced_kernel": 87168,
    "dq_mma_sliced_kernel": 104576,
    "dkdv_mma_sliced_kernel": 105472,
    "ring_fwd_sliced_kernel": 119872,
    "ring_dq_sliced_kernel": 221312,
    "ring_dkdv_sliced_kernel": 188928,
}


def sliced_report(logs: dict) -> dict:
    """ptxas's registers and spills of every head_dim-sliced instantiation
    (the kernels that run a head past 128 columns in 128-column slices), by
    library, with each one's fixed dynamic shared memory (SLICED_SMEM).
    Fails if a library that launches them compiled none."""
    out = {}
    for name in ("masked_attention", "attention_train", "block_train",
                 "ring_attention"):
        regs = ptxas_report(logs[name], "sliced")
        for r in regs:
            base = r["kernel"].split("<")[0].split("::")[-1]
            r["dynamic_smem"] = (63104 if base.startswith(
                "masked_attention_mma") and r["kernel"].rstrip(
                    " >").endswith("true") else SLICED_SMEM.get(base))
        if not regs:
            raise RuntimeError(f"ptxas reported no sliced kernel in {name}")
        out[name] = regs
    return out


def phase_build() -> tuple:
    """Builds every kernel; returns ptxas's registers and spills of the
    bf16 serving attention's instantiations, of the GEMMs' (the wgmma
    kernel with its dynamic shared memory, the training block's bt_gemm,
    the f32 serving GEMM), of the FMA attention kernels (training, and
    the serving forward) and of the ring kernels. Fails if a GEMM, FMA
    attention or ring instantiation spills, if the serving GEMM's library
    holds no ``HGMMA``, or if the FMA attention or ring kernels' SASS holds
    no ``LDGSTS`` (cp.async) in a library that launches them."""
    from vidsum_tpu_torch import native
    from vidsum_tpu_torch.native import build as native_build
    from vidsum_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    logs = _cuda.build(ptxas_verbose=True)
    t_cuda = time.monotonic() - t0
    for name, log in logs.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr, flush=True)
    t1 = time.monotonic()
    native_build.build(verbose=False)
    if not native.available():
        raise RuntimeError(f"native eval runtime did not load: "
                           f"{native.load_error()}")
    regs = ptxas_report(logs["masked_attention"],
                        "masked_attention_mma_kernel")
    if not regs:
        raise RuntimeError("ptxas reported no masked_attention_mma_kernel")
    lib = _cuda.load("gemm_bias_epilogue")
    gemm = ptxas_report(logs["gemm_bias_epilogue"], "gemm_bf16_wgmma_kernel")
    for r in gemm:
        import re

        m = re.search(r"<(\d+), (\d+)|ILi(\d+)ELi(\d+)", r["kernel"])
        rows, cols = (int(v) for v in m.groups() if v is not None)
        r["dynamic_smem"] = lib.vs_gemm_wgmma_smem(rows, cols)
    bt_gemm = ptxas_report(logs["block_train"], "bt_gemm_kernel")
    # the f32 serving GEMM on csrc/fma_gemm.cuh's mainloop: two tiles x two
    # load modes x three epilogues
    f32_gemm = ptxas_report(logs["gemm_bias_epilogue"], "gemm_f32_kernel")
    # the int8 GEMM: four tiles x five epilogues
    lib8 = _cuda.load("int8_gemm")
    int8 = ptxas_report(logs["int8_gemm"], "int8_gemm_wgmma_kernel")
    for r in int8:
        import re

        m = re.search(r"<(\d+), (\d+)|ILi(\d+)ELi(\d+)", r["kernel"])
        rows, cols = (int(v) for v in m.groups() if v is not None)
        r["dynamic_smem"] = lib8.vs_int8_gemm_smem(rows, cols)
    if (len(gemm) != 16 or len(bt_gemm) != 4 or len(f32_gemm) != 12
            or len(int8) != 20):
        raise RuntimeError(f"ptxas reported {len(gemm)} wgmma, "
                           f"{len(bt_gemm)} bt_gemm, {len(f32_gemm)} "
                           f"gemm_f32 and {len(int8)} int8 wgmma "
                           f"instantiations")
    spilled = [r["kernel"] for r in gemm + bt_gemm + f32_gemm + int8
               if any(r.get("spill", []))]
    if spilled:
        raise RuntimeError(f"GEMM instantiations spill: {spilled}")
    hgmma = sass_count(_cuda.lib_path("gemm_bias_epilogue"), "HGMMA")
    if hgmma == 0:
        raise RuntimeError("no HGMMA in the serving GEMM's SASS")
    # the int8 library's warpgroup products (IGMMA in the SASS)
    igmma = sass_count(_cuda.lib_path("int8_gemm"), "GMMA")
    if igmma == 0:
        raise RuntimeError("no warpgroup product in the int8 GEMM's SASS")
    # the f32 FMA attention (csrc/attention_core.cuh): per head_dim two
    # forwards, two dQ and two dK/dV (the CTA depths; dK/dV keeps the
    # 8-deep one at 128), the same in both training libraries; the serving
    # library launches its forwards only (the header's dispatchers compile
    # the rest there too)
    n_dh = len(_cuda.HEAD_DIMS)
    fma = [r for r in ptxas_report(logs["attention_train"], "fma_")
           if "sliced" not in r["kernel"]]
    fma_bt = [r for r in ptxas_report(logs["block_train"], "fma_")
              if "sliced" not in r["kernel"]]
    fma_serve = ptxas_report(logs["masked_attention"], "fma_fwd_kernel")
    # (and there its own, at any N: 64-row CTAs of 4 rows a thread, and
    # 128-row ones of 8 at head_dim <= 64)
    n_serve = 3 * n_dh + sum(dh <= 64 for dh in _cuda.HEAD_DIMS)
    if (len(fma), len(fma_bt), len(fma_serve)) != (6 * n_dh - 1,
                                                   6 * n_dh - 1, n_serve):
        raise RuntimeError(f"ptxas reported {len(fma)}, {len(fma_bt)} and "
                           f"{len(fma_serve)} FMA attention instantiations, "
                           f"expected {6 * n_dh - 1}, {6 * n_dh - 1} and "
                           f"{n_serve}")
    spilled = [r["kernel"] for r in fma + fma_bt + fma_serve
               if any(r.get("spill", []))]
    if spilled:
        raise RuntimeError(f"FMA attention instantiations spill: {spilled}")
    # the ring kernels (csrc/ring_attention.cu, on the same FMA tiles): per
    # head_dim a forward, a dQ and a dK/dV in each CTA shape
    ra = ring_module()
    n_ring = sum(len(ra.ring_shapes(k, dh)) for k in ra.RING_KERNELS
                 for dh in _cuda.HEAD_DIMS)
    ring = [r for r in ptxas_report(logs["ring_attention"], "ring_")
            if "sliced" not in r["kernel"]]
    if len(ring) != n_ring:
        raise RuntimeError(f"ptxas reported {len(ring)} ring kernel "
                           f"instantiations, expected {n_ring}")
    spilled = [r["kernel"] for r in ring if any(r.get("spill", []))]
    if spilled:
        raise RuntimeError(f"ring kernel instantiations spill: {spilled}")
    ldgsts = {n: sass_count(_cuda.lib_path(n), "LDGSTS", f)
              for n, f in (("attention_train", "fma_"),
                           ("block_train", "fma_"),
                           ("masked_attention", "fma_fwd"),
                           ("ring_attention", "ring_"))}
    if not all(ldgsts.values()):
        raise RuntimeError(f"no LDGSTS (cp.async) in the FMA attention "
                           f"kernels' SASS: {ldgsts}")
    # PGL-SUM's position-biased forward (its two head_dims) and fusion
    posbias = (ptxas_report(logs["masked_attention"],
                            "fma_fwd_posbias_kernel")
               + ptxas_report(logs["row_norms"], "l2_fuse_kernel"))
    if len(posbias) != 3:
        raise RuntimeError(f"ptxas reported {len(posbias)} PGL-SUM kernel "
                           f"instantiations, expected 3")
    spilled = [r["kernel"] for r in posbias if any(r.get("spill", []))]
    if spilled:
        raise RuntimeError(f"PGL-SUM kernels spill: {spilled}")
    sliced = sliced_report(logs)
    emit("build", cuda_s=round(t_cuda, 3),
         native_s=round(time.monotonic() - t1, 3),
         libraries=sorted(os.path.basename(_cuda.lib_path(n))
                          for n in _cuda.KERNELS),
         masked_attention_mma_ptxas=regs, gemm_wgmma_ptxas=gemm,
         bt_gemm_ptxas=bt_gemm, gemm_f32_ptxas=f32_gemm,
         int8_gemm_wgmma_ptxas=int8, gemm_sass_hgmma=hgmma,
         int8_gemm_sass_gmma=igmma, fma_attention_ptxas=fma,
         serving_fma_attention_ptxas=fma_serve, ring_ptxas=ring,
         fma_attention_sass_ldgsts=ldgsts, sliced_ptxas=sliced,
         pglsum_ptxas=posbias)
    return regs, gemm, bt_gemm, fma, f32_gemm, fma_serve, int8, ring, posbias


def library_block(block, d: int, H: int, dtype, dropout: float = 0.0):
    """nn.TransformerEncoderLayer computing the same function as the block:
    its Q weights are scaled by sqrt(head_dim / d_model), so its
    head_dim**-0.5 scale becomes the reference's d_model**-0.5. With
    ``dropout`` it is in train mode, else in eval mode."""
    import torch
    from torch import nn

    layer = nn.TransformerEncoderLayer(d, H, 4 * d, dropout=dropout,
                                       batch_first=True)
    sa = block.sa
    with torch.no_grad():
        f = (d // H / d) ** 0.5
        layer.self_attn.in_proj_weight.copy_(torch.cat(
            [sa.q.weight * f, sa.k.weight, sa.v.weight]))
        layer.self_attn.in_proj_bias.copy_(torch.cat(
            [sa.q.bias * f, sa.k.bias, sa.v.bias]))
        layer.self_attn.out_proj.weight.copy_(sa.feature_projection.weight)
        layer.self_attn.out_proj.bias.copy_(sa.feature_projection.bias)
        layer.linear1.weight.copy_(block.mlp.fc1.weight)
        layer.linear1.bias.copy_(block.mlp.fc1.bias)
        layer.linear2.weight.copy_(block.mlp.fc2.weight)
        layer.linear2.bias.copy_(block.mlp.fc2.bias)
        for dst, src in ((layer.norm1, block.norm1),
                         (layer.norm2, block.norm2)):
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
    layer = layer.to(device=block.norm1.weight.device, dtype=dtype)
    return layer.train() if dropout else layer.eval()


def phase_kernels(dev: dict, seed: int) -> dict:
    """Every route against its plain version in bf16 and f32; returns the
    numbers per route for the kernels line (bf16 under the route's name,
    f32 under ``<route>.f32``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import block_kernel as bk

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    cuda = torch.device("cuda")
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed)
                   ).encoder.module_list[0]
    rng = np.random.default_rng(seed)
    out = {}

    def bound(flops, nbytes, dtype_name):
        t_ops = flops / peaks[dtype_name] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    for B, N, route in ((32, 512, "_fused_block"),
                        (8, 256, "_fused_block_grouped")):
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            w = bk.block_weights(block, dtype)
            layer = library_block(block, d, H, dtype)
            counter = getattr(bk, route)
            before = counter.launches
            with torch.inference_mode():
                got = bk.fused_encoder_block(block, x, mask, H,
                                             cfg.attn_scale)
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"({B}, {N}) did not take {route}")
                want = bk.encoder_block_reference(w, x, mask, H,
                                                  cfg.attn_scale)
                tol = TOL[("block", dn)]
                err, rel = check_close(got, want, tol)
                ms = cuda_ms(lambda: bk.fused_encoder_block(
                    block, x, mask, H, cfg.attn_scale), reps=20)
                plain_ms = cuda_ms(lambda: bk.encoder_block_reference(
                    w, x, mask, H, cfg.attn_scale), reps=5)
                lib_ms = cuda_ms(lambda: layer(x, src_key_padding_mask=mask),
                                 reps=20)
                # the chain's own device time (torch.profiler), without the
                # host time of its five launches that CUDA events take in;
                # in f32 three profiles in a row, each with its kernels by
                # device time (the spread of one run, and where it goes)
                runs = [device_profile(lambda: bk.fused_encoder_block(
                    block, x, mask, H, cfg.attn_scale), reps=10, top=12)
                    for _ in range(3 if dtype == torch.float32 else 1)]
                device = {
                    "kernel": statistics.median(r["device_ms"]
                                                for r in runs),
                    "library": device_profile(lambda: layer(
                        x, src_key_padding_mask=mask), reps=10)["device_ms"]}
                if len(runs) > 1:
                    emit("block_profile", route=route, B=B, N=N, dtype=dn,
                         device_ms=[r["device_ms"] for r in runs],
                         wall_ms=[r["wall_ms"] for r in runs],
                         kernels=[r["top"] for r in runs])
            itm = x.element_size()
            flops = B * N * 24 * d * d + 4 * N * valid * d
            nbytes = (2 * B * N * d * itm + 12 * d * d * itm
                      + 13 * d * 4 + B * N)
            b_ms, b_by = bound(flops, nbytes, dn)
            emit("kernel", route=route, B=B, N=N, dtype=dn, max_abs_err=err,
                 rel_rms_err=rel, tolerance=tol, ms=ms, device_ms=device,
                 tflops=flops / device["kernel"] / 1e9,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, flops=flops, bytes=nbytes)
            key = route if dtype == torch.bfloat16 else route + ".f32"
            out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms, device_ms=device)

    # kernel 3 at N 6,016 (its row in the kernels line) and at 1,280 (the
    # bucket of the serve phase's 1,200-frame request, whose fused blocks
    # run this attention at that shape: a grid of 40 128-row CTAs), kernel
    # 4 at 16,384
    for N, route in ((6016, "_flash_attention"),
                     (16384, "_flash_attention_folded"),
                     (1280, "_flash_attention")):
        B = 1
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v = (torch.from_numpy(rng.normal(size=(B, H, N, Dh)).astype(
                np.float32)).to(cuda, dtype) for _ in range(3))
            counter = getattr(at, route)
            before = counter.launches
            with torch.inference_mode():
                got = at.flash_attention(q, k, v, mask, cfg.attn_scale)
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"N={N} did not take {route}")
                # the plain version of each route's order of rounding: the
                # single pass rounds normalised P, the fold (over the
                # kernel's 64-key tiles) unnormalised P
                folded = route == "_flash_attention_folded"
                normalised = lambda: at.attention_reference(  # noqa: E731
                    q, k, v, mask, cfg.attn_scale)
                online = lambda: at.attention_folded_reference(  # noqa
                    q, k, v, mask, cfg.attn_scale, at.KEY_TILE)
                plain, other = (online, normalised) if folded else (
                    normalised, online)
                want = plain()
                tol = TOL[("attention", dn)]
                err, rel = check_close(got, want, tol)
                rel_other = None
                if dtype == torch.bfloat16:
                    # P is rounded where the route's TPU kernel rounds it:
                    # the other order is at least twice as far off
                    _, rel_other = errors(got, other())
                    if not rel < rel_other / 2:
                        raise AssertionError(
                            f"{route}: relative RMS {rel} against its own "
                            f"rounding order, {rel_other} against the other")
                # the tolerance is tight enough to see a planted fault: the
                # kernel run with its first (always unpadded) 64-key tile
                # masked out must fail it
                dropped = mask.clone()
                dropped[:, :at.KEY_TILE] = True
                bad = at.masked_attention(q, k, v, dropped, cfg.attn_scale,
                                          norm_first=not folded)
                fault_err, fault_rel = errors(bad, want)
                if within(bad, want, tol):
                    raise AssertionError(
                        f"{route} {dn}: a kernel that drops a key tile "
                        f"passes the tolerance {tol} (max abs err "
                        f"{fault_err}, relative RMS {fault_rel})")
                ms = cuda_ms(lambda: at.flash_attention(
                    q, k, v, mask, cfg.attn_scale), reps=10)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                keep = ~mask[:, None, None, :]
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=keep, scale=cfg.attn_scale)
                lib_ms = cuda_ms(sdpa, reps=10)
                # the kernels' own device time (torch.profiler), without
                # the host time that a single call's CUDA events take in
                device = {
                    "kernel": device_profile(lambda: at.flash_attention(
                        q, k, v, mask, cfg.attn_scale), reps=10)["device_ms"],
                    "library": device_profile(sdpa, reps=10)["device_ms"]}
            itm = q.element_size()
            flops = 4 * H * Dh * N * valid
            nbytes = 4 * B * H * N * Dh * itm + B * N
            b_ms, b_by = bound(flops, nbytes, dn)
            emit("kernel", route=route, B=B, N=N, dtype=dn, max_abs_err=err,
                 rel_rms_err=rel, rel_rms_err_other_order=rel_other,
                 tolerance=tol, dropped_tile_err=[fault_err, fault_rel],
                 ms=ms, device_ms=device,
                 tflops=flops / device["kernel"] / 1e9, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, flops=flops, bytes=nbytes)
            point = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         device_ms=device)
            key = route if dtype == torch.bfloat16 else route + ".f32"
            if key in out:  # kernel 3's second point
                out[key]["at_n1280"] = point
            else:
                out[key] = point
    # on the card the kernels take a length off the 128-row tile (the CPU
    # takes the plain path there, as JAX): N 1,000 launches kernel 3 and
    # agrees with the plain version at its bound
    N = 1000
    mask = pad_mask(1, N, rng, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q, k, v = (torch.from_numpy(rng.normal(size=(1, H, N, Dh)).astype(
            np.float32)).to(cuda, dtype) for _ in range(3))
        before = at._flash_attention.launches
        with torch.inference_mode():
            got = at.flash_attention(q, k, v, mask, cfg.attn_scale)
            torch.cuda.synchronize()
            if at._flash_attention.launches != before + 1:
                raise AssertionError(f"N={N} {dn} did not take the kernel")
            err, rel = check_close(got, at.attention_reference(
                q, k, v, mask, cfg.attn_scale), TOL[("attention", dn)],
                f" at N {N}")
        emit("flash_off_tile", N=N, dtype=dn, max_abs_err=err,
             rel_rms_err=rel, tolerance=TOL[("attention", dn)])
    attention_cta_variants(rng)
    return out


def attention_cta_variants(rng) -> None:
    """The serving attention alone at the shapes the serving path gives it
    (the blocks' (32, 512) and (8, 256), kernel 3 at N 1,280 and 6,016,
    kernel 4 at 16,384; H 4, head_dim 64, ragged masks), bf16 and f32, in
    both CTA shapes, each shape's device time (torch.profiler, 10 calls)
    taken in turns (64, 128, 128, 64 query rows): the comparison behind
    ``ops/attention.mma_cta_rows``. Both shapes must give the same bits."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.ops import attention as at

    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H, Dh = 4, 64
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for B, N, norm_first in ((32, 512, True), (8, 256, True),
                                 (1, 1280, True), (1, 6016, True),
                                 (1, 16384, False)):
            mask = pad_mask(B, N, rng, cuda)
            q, k, v = (torch.from_numpy(rng.normal(
                size=(B, H, N, Dh)).astype(np.float32)).to(cuda, dtype)
                for _ in range(3))

            def run(r):
                pick = at.mma_cta_rows
                at.mma_cta_rows = lambda *a: r  # the shape under test
                try:
                    return at.masked_attention(q, k, v, mask, 0.125,
                                               norm_first=norm_first)
                finally:
                    at.mma_cta_rows = pick

            with torch.inference_mode():
                if not torch.equal(run(64), run(128)):
                    raise AssertionError(f"({B}, {N}) {dtype}: the two CTA "
                                         f"shapes give different bits")
                times = {64: [], 128: []}
                for r in (64, 128, 128, 64):
                    times[r].append(device_profile(lambda: run(r),
                                                   reps=10)["device_ms"])
            rows.append({"dtype": str(dtype).split(".")[1], "B": B, "N": N,
                         "norm_first": norm_first,
                         "picked": at.mma_cta_rows(B, H, N, Dh, sms),
                         "device_ms_64": times[64],
                         "device_ms_128": times[128]})
    emit("attention_cta_variants", sms=sms, shapes=rows)


def gemm_f64_bound(a, b, K: int, extra=None, scale: float = 1.0):
    """(want, tol) of an f32 product ``a . b`` held against f64: any f32
    summation order of K products stays within (K + 2) 2^-24 sum |a||b|
    (plus ``extra``'s magnitudes, the epilogue's addends), times the
    dropout's ``scale``."""
    want = a.double() @ b.double()
    size = a.double().abs() @ b.double().abs()
    if extra is not None:
        want = want + extra.double()
        size = size + extra.double().abs()
    return want, scale * (K + 2) * 2.0 ** -24 * size


def phase_gemm(dev: dict, seed: int) -> None:
    """Each product of kernel 1's chain at (32, 512) and (8, 256) in bf16
    and in f32, and of kernel 9's (forward, dX and split-K dW) at (32, 512)
    in f32, on its own: the path it took (by the wrapper's counters: every
    serving product must take the wgmma kernel or, in f32, the FMA kernel's
    16-byte loads, never a fallback), its device time (torch.profiler, 10
    calls), TFLOP/s and bound, its error against the plain version (kernel
    1: ``gemm_bias_epilogue_reference`` at the card tests' GEMM bounds;
    kernel 9: torch.matmul in f64 at the summation-order bound), two runs
    bit-equal, and torch.matmul on the same operands (timed only, never
    called by the port). bf16: both CTA shapes in turns (64, 128, 128, 64
    rows), bit-equal; f32 kernel 1: both tiles in turns (64, 128, 128, 64),
    bit-equal, a request's 256 rows alone bit-equal to the same rows in the
    batch, and the product with one k tile of x zeroed (a planted fault)
    failing the bound; kernel 9 dW: the split rule's split against half and
    twice it."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_train as bt

    peaks = peaks_for(dev["name"])
    cuda = torch.device("cuda")
    d = ModelConfig().d_model
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed + 30)
                   ).encoder.module_list[0]
    rng = np.random.default_rng(seed + 31)

    def rand(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, dtype)

    def bound(flops, nbytes, dtype_name):
        t_ops = flops / peaks[dtype_name] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def device_ms(fn):
        return device_profile(fn, reps=10)["device_ms"]

    def library(fn):
        """torch.matmul's device ms, or its CUDA-event ms where the
        profiler lists none of its kernels (seen for f32), and which."""
        ms = device_ms(fn)
        return (ms, "device") if ms > 0 else (cuda_ms(fn, reps=20),
                                              "cuda_events")

    # kernel 1: the four products of the serving chain, bf16
    w = bk.block_weights(block, torch.bfloat16)
    for B, N in ((32, 512), (8, 256)):
        M = B * N
        x = rand(M, d, dtype=torch.bfloat16)
        h1_f = rand(M, d)
        products = (
            ("qkv", x, w.wqkv, w.bqkv, "none", {}),
            ("proj_ln1", rand(M, d, dtype=torch.bfloat16), w.wp, w.bp,
             "residual_ln", dict(residual=x, ln_g=w.ln1_g, ln_b=w.ln1_b,
                                 want_f32=True)),
            ("fc1", h1_f.to(torch.bfloat16), w.w1, w.b1, "relu", {}),
            ("fc2_ln2", rand(M, 4 * d, dtype=torch.bfloat16).relu(), w.w2,
             w.b2, "residual_ln", dict(residual=h1_f, ln_g=w.ln2_g,
                                       ln_b=w.ln2_b)))
        for name, a, wt, b, epi, kw in products:
            Nn, K = wt.shape
            fn = bk.gemm_bias_epilogue
            before = (fn.launches, fn.fallback_launches)
            got_t, got_f = fn(a, wt, b, epi, **kw)
            torch.cuda.synchronize()
            if (fn.launches, fn.fallback_launches) != (before[0] + 1,
                                                       before[1]):
                raise AssertionError(f"({B}, {N}) {name} did not take the "
                                     f"wgmma kernel")
            want_t, want_f = bk.gemm_bias_epilogue_reference(a, wt, b, epi,
                                                             **kw)
            err, rel = check_close(got_t, want_t, TOL[("gemm", "bfloat16")],
                                   f" ({name})")
            if got_f is not None:
                check_close(got_f, want_f, TOL[("gemm", "float32")],
                            f" ({name}, f32)")
            rows = bk.gemm_cta_rows(M, Nn, torch.cuda.get_device_properties(
                0).multi_processor_count)
            call = lambda: fn(a, wt, b, epi, **kw)  # noqa: E731
            ms = device_ms(call)
            pick = bk.gemm_cta_rows
            variants, bits = {64: [], 128: []}, {}
            try:
                for r in (64, 128, 128, 64):
                    bk.gemm_cta_rows = lambda *_, r=r: r  # the shape tested
                    variants[r].append(device_ms(call))
                    bits[r] = call()[0]
            finally:
                bk.gemm_cta_rows = pick
            if not torch.equal(bits[64], bits[128]):
                raise AssertionError(f"({B}, {N}) {name}: the two CTA "
                                     f"shapes give different bits")
            lib, lib_clock = library(lambda: torch.matmul(a, wt.t()))
            flops = 2 * M * Nn * K
            nbytes = ((M * K + Nn * K) * 2 + M * Nn * 2 + Nn * 4
                      + (M * Nn * (4 if kw.get("want_f32") else 0))
                      + (M * Nn * kw["residual"].element_size()
                         + 8 * Nn if epi == "residual_ln" else 0))
            b_ms, b_by = bound(flops, nbytes, "bfloat16")
            emit("gemm", kernel=1, B=B, N=N, product=name, dtype="bfloat16",
                 M=M, N_out=Nn, K=K, epilogue=epi, path="wgmma",
                 cta_rows=rows, tile_n=bk.gemm_tile_n(Nn),
                 device_ms=ms, tflops=flops / ms / 1e9, bound_ms=b_ms,
                 bound_by=b_by, max_abs_err=err, rel_rms_err=rel,
                 tolerance=TOL[("gemm", "bfloat16")],
                 cta_variants_device_ms={str(r): v
                                         for r, v in variants.items()},
                 library_ms=lib, library_clock=lib_clock,
                 library_tflops=flops / lib / 1e9)

    # kernel 1 in f32: the same four products on the FMA kernel (fma_gemm.
    # cuh's mainloop), in both tile shapes in turns (64, 128, 128, 64: the
    # comparison behind ops/block_kernel.gemm_f32_tile), bit-equal
    w = bk.block_weights(block, torch.float32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, N in ((32, 512), (8, 256)):
        M = B * N
        x, h1 = rand(M, d), rand(M, d)
        products = (
            ("qkv", x, w.wqkv, w.bqkv, "none", {}),
            ("proj_ln1", rand(M, d), w.wp, w.bp, "residual_ln",
             dict(residual=x, ln_g=w.ln1_g, ln_b=w.ln1_b, want_f32=True)),
            ("fc1", h1, w.w1, w.b1, "relu", {}),
            ("fc2_ln2", rand(M, 4 * d).relu(), w.w2, w.b2, "residual_ln",
             dict(residual=h1, ln_g=w.ln2_g, ln_b=w.ln2_b)))
        for name, a, wt, b, epi, kw in products:
            Nn, K = wt.shape
            fn = bk.gemm_bias_epilogue
            before = (fn.launches, fn.fallback_launches)
            got = fn(a, wt, b, epi, **kw)[0]
            again = fn(a, wt, b, epi, **kw)[0]
            torch.cuda.synchronize()
            if (fn.launches, fn.fallback_launches) != (before[0] + 2,
                                                       before[1]):
                raise AssertionError(f"f32 ({B}, {N}) {name} took the "
                                     f"scalar-load fallback")
            if not torch.equal(got, again):
                raise AssertionError(f"f32 ({B}, {N}) {name}: two runs "
                                     f"differ")
            want = bk.gemm_bias_epilogue_reference(a, wt, b, epi, **kw)[0]
            err, rel = check_close(got, want, TOL[("gemm", "float32")],
                                   f" (f32 {name})")
            # the bound sees a planted fault: the product with one 16-deep
            # k tile of x zeroed (a skipped k tile) must fail it
            skipped = a.clone()
            skipped[:, 16:32] = 0.0
            bad = fn(skipped, wt, b, epi, **kw)[0]
            fault = errors(bad, want)
            if within(bad, want, TOL[("gemm", "float32")]):
                raise AssertionError(f"f32 ({B}, {N}) {name}: a skipped k "
                                     f"tile passes the bound ({fault})")
            # a request's 256 rows alone (another tile, at a small grid)
            # equal the same rows in the batch
            sub = {k: (v[:256] if k == "residual" else v)
                   for k, v in kw.items()}
            if not torch.equal(fn(a[:256], wt, b, epi, **sub)[0],
                               got[:256]):
                raise AssertionError(f"f32 ({B}, {N}) {name}: rows differ "
                                     f"alone and in the batch")
            call = lambda: fn(a, wt, b, epi, **kw)  # noqa: E731
            ms = device_ms(call)
            pick = bk.gemm_f32_tile
            variants, bits = {64: [], 128: []}, {}
            try:
                for t in (64, 128, 128, 64):
                    bk.gemm_f32_tile = lambda *_, t=t: t  # the tile tested
                    variants[t].append(device_ms(call))
                    bits[t] = call()[0]
            finally:
                bk.gemm_f32_tile = pick
            if not torch.equal(bits[64], bits[128]):
                raise AssertionError(f"f32 ({B}, {N}) {name}: the two tiles "
                                     f"give different bits")
            lib, lib_clock = library(lambda: torch.matmul(a, wt.t()))
            flops = 2 * M * Nn * K
            nbytes = ((M * K + Nn * K + M * Nn) * 4 + Nn * 4
                      + (M * Nn * 4 + 8 * Nn if epi == "residual_ln" else 0))
            b_ms, b_by = bound(flops, nbytes, "float32")
            emit("gemm", kernel=1, B=B, N=N, product=name, dtype="float32",
                 M=M, N_out=Nn, K=K, epilogue=epi, path="fma_vec4",
                 tile=bk.gemm_f32_tile(M, Nn, sms), device_ms=ms,
                 tflops=flops / ms / 1e9, bound_ms=b_ms, bound_by=b_by,
                 max_abs_err=err, rel_rms_err=rel,
                 tolerance=TOL[("gemm", "float32")],
                 skipped_k_tile_err=list(fault), bit_equal_repeat=True,
                 rows_alone_equal=True,
                 tile_variants_device_ms={str(t): v
                                          for t, v in variants.items()},
                 library_ms=lib, library_clock=lib_clock,
                 library_tflops=flops / lib / 1e9)

    # kernel 9: bt_gemm's products at (32, 512), f32
    tw = bt.train_weights(block)
    tw = bt.TrainWeights(*(t.detach() for t in tw))
    M = 32 * 512
    rate = 0.3
    dr = bt._Drop(int(rng.integers(0, 2**31 - 1)), 512, bt._threshold(rate),
                  bt._keep_scale(rate))
    x32, o, h1 = rand(M, d), rand(M, d), rand(M, d)
    m1d, a1 = rand(M, 4 * d), rand(M, 4 * d)
    dm2, dproj, dqkv = rand(M, d), rand(M, d), rand(M, 3 * d)
    da1, addend = rand(M, 4 * d), rand(M, d)
    keep_idx = torch.arange(M, device=cuda)

    def keep_mask(cols):
        return bt._keep_bits(dr.seed, torch.tensor(bt.S_MLP, device=cuda),
                             (keep_idx // 512)[:, None],
                             (keep_idx % 512)[:, None],
                             torch.arange(cols, device=cuda)[None, :], rate)

    # (name, a, b, _gemm options, the plain product's operands)
    products = (
        ("fwd_qkv", x32, tw.wqkv, dict(tb=True, bias=tw.bqkv),
         (x32, tw.wqkv.t())),
        ("fwd_proj", o, tw.wp, dict(tb=True, bias=tw.bp), (o, tw.wp.t())),
        ("fwd_fc1", h1, tw.wf1, dict(tb=True, bias=tw.bf1,
                                     epilogue="relu_drop", dr=dr,
                                     site=bt.S_MLP, keep_pre=True),
         (h1, tw.wf1.t())),
        ("fwd_fc2", m1d, tw.wf2, dict(tb=True, bias=tw.bf2),
         (m1d, tw.wf2.t())),
        ("dx_da1", dm2, tw.wf2, dict(epilogue="drop_relu_bwd", dr=dr,
                                     site=bt.S_MLP, aux=a1), (dm2, tw.wf2)),
        ("dx_dh1", da1, tw.wf1, dict(addend=addend), (da1, tw.wf1)),
        ("dx_dattn", dproj, tw.wp, {}, (dproj, tw.wp)),
        ("dx_dx", dqkv, tw.wqkv, dict(addend=addend), (dqkv, tw.wqkv)),
        ("dw_wf2", dm2, m1d, dict(ta=True), (dm2.t(), m1d)),
        ("dw_wf1", da1, h1, dict(ta=True), (da1.t(), h1)),
        ("dw_wp", dproj, o, dict(ta=True), (dproj.t(), o)),
        ("dw_wqkv", dqkv, x32, dict(ta=True), (dqkv.t(), x32)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, a, b, kw, (pa, pb) in products:
        Mo, K = pa.shape
        No = pb.shape[1]
        epi = kw.get("epilogue", "bias")
        splits = bt.gemm_splits(Mo, No, K, sms) if epi == "bias" else 1
        before = bt._gemm.launches
        runs = [bt._gemm(a, b, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        if bt._gemm.launches != before + 2:
            raise AssertionError(f"{name}: bt_gemm did not launch")
        got, again = ((r[0] if kw.get("keep_pre") else r) for r in runs)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two runs differ")
        extra = kw.get("bias")
        if kw.get("addend") is not None:
            extra = kw["addend"] + (0.0 if extra is None else extra)
        want, tol = gemm_f64_bound(pa, pb, K, extra)
        if epi == "relu_drop":
            pre = runs[0][1].double()
            if not bool(((pre - want).abs() <= tol).all()):
                raise AssertionError(f"{name}: pre-ReLU off f64")
            want = torch.where(keep_mask(No), want.clamp_min(0) * dr.kscale,
                               0.0)
            tol = tol * dr.kscale + 2.0 ** -23 * want.abs()
        elif epi == "drop_relu_bwd":
            want = torch.where(keep_mask(No) & (a1 > 0), want * dr.kscale,
                               0.0)
            tol = tol * dr.kscale + 2.0 ** -23 * want.abs()
        diff = (got.double() - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"{name}: off torch.matmul in f64 past the "
                                 f"summation-order bound by "
                                 f"{float((diff - tol).max())}")
        ms = device_ms(lambda: bt._gemm(a, b, **kw))
        variants = None
        if name.startswith("dw_"):
            variants = {str(s): device_ms(lambda s=s: bt._gemm(
                a, b, splits=s, **kw)) for s in sorted(
                    {max(1, splits // 2), splits, 2 * splits})}
        lib, lib_clock = library(lambda: torch.matmul(pa, pb))
        flops = 2 * Mo * No * K
        nbytes = (Mo * K + K * No + Mo * No) * 4
        b_ms, b_by = bound(flops, nbytes, "float32")
        emit("gemm", kernel=9, B=32, N=512, product=name, dtype="float32",
             M=Mo, N_out=No, K=K, epilogue=epi,
             path="bt_gemm" + (f", split-K {splits}" if splits > 1 else ""),
             device_ms=ms, tflops=flops / ms / 1e9, bound_ms=b_ms,
             bound_by=b_by, max_abs_err=float(diff.max()),
             worst_share_of_bound=float((diff / tol.clamp_min(1e-30)).max()),
             bit_equal_repeat=True, split_variants_device_ms=variants,
             library_ms=lib, library_clock=lib_clock,
             library_tflops=flops / lib / 1e9)
    int8_gemm_lines(dev, seed)


def int8_gemm_lines(dev: dict, seed: int) -> None:
    """The int8 GEMM (``csrc/int8_gemm.cu``'s wgmma kernel) alone at the
    shapes its paths give it: kernel 13's four products (the bf16 serving
    chain's QKV, proj + LN1 with its row codes, fc1 + ReLU in f32, fc2 +
    LN2) at (32, 512) and (8, 256), and the probe's shift product (18b) at
    2048^3 and 8192^3. Each line: the tile ``ops/quant.int8_gemm_tile``
    took, device ms (torch.profiler, 10 calls), TOP/s and the bound
    (operations at the int8 peak against the bytes moved), the outputs
    against ``int8_gemm_reference`` (bit for bit but for the LayerNorm
    rows, which are held at 1e-5 with their row codes equal to the plain
    quantizer's codes of the kernel's own rows, and give their bit-equal
    share), both CTA row counts (64 and 128, timed in turns, bit-equal), a
    request's 512 rows alone bit-equal to the same rows in the batch, the
    product with one 128-deep K tile of x zeroed (a planted fault) failing
    the check, no operand staged (``int8_gemm.fallback_launches``), and
    ``torch._int_mm`` on the same codes (int32 out; timed only, never
    called by the port)."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import quant
    from vidsum_tpu_torch.tools import probe_int8_mma as probe

    peaks = peaks_for(dev["name"])
    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = ModelConfig().d_model
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed + 32)
                   ).encoder.module_list[0]
    qb = quant.quantize_block(block)
    rng = np.random.default_rng(seed + 33)
    fn = quant.int8_gemm
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda)

    def codes(t):
        q, sc = quant.quantize_rows(t)
        return q, sc.view(-1)

    def device_ms(call):
        return device_profile(call, reps=10)["device_ms"]

    def held(got, want, epi, what):
        """Raises unless ``got`` passes the check against ``want``;
        returns the LayerNorm rows' bit-equal share (1.0 elsewhere)."""
        if epi != "residual_ln":
            for a, b in zip(got, want):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"int8 {what}: not bit-equal to "
                                         f"its plain version")
            return 1.0
        y = got[1] if got[1] is not None else got[0]
        wy = want[1] if want[1] is not None else want[0]
        # f32 rows at summation-order level; bf16 rows one bf16 step
        tol = (dict(atol=1e-5, rtol=1e-5) if y.dtype == torch.float32
               else dict(atol=1e-2, rtol=8e-3))
        if not torch.allclose(y.float(), wy.float(), **tol):
            raise AssertionError(f"int8 {what}: LayerNorm rows off their "
                                 f"plain version past {tol}: "
                                 f"{errors(y, wy)}")
        if got[2] is not None:
            wq, ws = quant.quantize_rows_reference(got[1])
            if not (torch.equal(got[2], wq) and torch.equal(got[3],
                                                            ws[:, 0])):
                raise AssertionError(f"int8 {what}: row codes differ from "
                                     f"the quantizer's")
        return float((y == wy).float().mean())

    cases = []
    for B, N in ((32, 512), (8, 256)):
        M = B * N
        x = rand(M, d).to(bf16)
        h1 = rand(M, d)
        ln1 = dict(ln_g=qb.ln1_g, ln_b=qb.ln1_b)
        ln2 = dict(ln_g=qb.ln2_g, ln_b=qb.ln2_b)
        cases += [
            (13, f"({B}, {N})", "qkv", *codes(x), qb.wqkv, qb.sqkv, qb.bqkv,
             "none", dict(out_dtype=bf16)),
            (13, f"({B}, {N})", "proj_ln1", *codes(rand(M, d)), qb.wp, qb.sp,
             qb.bp, "residual_ln", dict(residual=x, want_f32=True,
                                        want_q=True, **ln1)),
            (13, f"({B}, {N})", "fc1", *codes(h1), qb.w1, qb.s1, qb.b1,
             "relu", dict(want_f32=True)),
            (13, f"({B}, {N})", "fc2_ln2", *codes(rand(M, 4 * d).relu()),
             qb.w2, qb.s2, qb.b2, "residual_ln",
             dict(residual=h1, out_dtype=bf16, **ln2))]
    for n in (2048, 8192):
        _, _, xi, wi = probe.inputs(n, n, n)
        cases.append(("18b", f"{n}^3", "shift", xi, None, wi, None, None,
                      "shift", {}))
    pick = quant.int8_gemm_tile
    for kernel, shape, name, x8, sx, w8, sw, b, epi, kw in cases:
        M, K = x8.shape
        Nn = w8.shape[0]
        what = f"{shape} {name}"

        def call(x8=x8, sx=sx, kw=kw):
            out = fn(x8, sx, w8, sw, b, epi, **kw)
            return out if epi != "shift" else (out,)

        before = (fn.launches, fn.fallback_launches)
        got = call()
        torch.cuda.synchronize()
        if (fn.launches, fn.fallback_launches) != (before[0] + 1, before[1]):
            raise AssertionError(f"int8 {what}: did not launch once, or "
                                 f"staged its operands")
        want = quant.int8_gemm_reference(x8, sx, w8, sw, b, epi, **kw)
        want = want if epi != "shift" else (want,)
        equal_share = held(got, want, epi, what)
        # a request's 512 rows alone, at another grid
        sub = {k: (v[:512] if k == "residual" else v) for k, v in kw.items()}
        alone = call(x8[:512], None if sx is None else sx[:512], sub)
        for a, c in zip(alone, got):
            if a is not None and not torch.equal(a, c[:512]):
                raise AssertionError(f"int8 {what}: rows differ alone and "
                                     f"in the batch")
        # the planted fault: one 128-deep K tile of x zeroed
        bad_x = x8.clone()
        bad_x[:, :128] = 0
        try:
            held(call(bad_x), want, epi, what)
        except AssertionError as e:
            fault = str(e)[:80]
        else:
            raise AssertionError(f"int8 {what}: a zeroed K tile passes")
        tile = pick(M, Nn, sms, epi == "residual_ln")
        ms = device_ms(call)
        variants, bits = {64: [], 128: []}, {}
        try:
            for r in (64, 128, 128, 64):
                quant.int8_gemm_tile = lambda *_, r=r: (r, tile[1])
                variants[r].append(device_ms(call))
                bits[r] = call()
        finally:
            quant.int8_gemm_tile = pick
        for a, c in zip(bits[64], bits[128]):
            if a is not None and not torch.equal(a, c):
                raise AssertionError(f"int8 {what}: the two CTA row counts "
                                     f"give different bits")
        lib = device_ms(lambda: torch._int_mm(x8, w8.t()))
        ops = 2 * M * Nn * K
        out_bytes = sum(t.numel() * t.element_size() for t in got
                        if t is not None)
        nbytes = (M * K + Nn * K + out_bytes
                  + (4 * M + 8 * Nn if epi != "shift" else 0)
                  + (kw["residual"].numel() * kw["residual"].element_size()
                     + 8 * Nn if epi == "residual_ln" else 0))
        t_ops = ops / peaks["int8"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        emit("gemm", kernel=kernel, shape=shape, product=name, dtype="int8",
             M=M, N_out=Nn, K=K, epilogue=epi, path="int8_wgmma",
             cta_rows=tile[0], tile_n=tile[1], device_ms=ms,
             tops=ops / ms / 1e9, bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             bytes=nbytes, bit_equal_share=equal_share,
             rows_alone_equal=True, zeroed_k_tile=fault,
             cta_variants_device_ms={str(r): v for r, v in variants.items()},
             library_ms=lib, library="torch._int_mm",
             library_tops=ops / lib / 1e9)


def diff_stats(got, want) -> dict:
    """|got - want| at the median and the max, and the share of bit-equal
    elements."""
    g, w = got.detach().float(), want.detach().float()
    d = (g - w).abs()
    return {"median": float(d.median()), "max": float(d.max()),
            "bit_equal_share": float((got == want).float().mean())}


def int8_within(st: dict) -> bool:
    return (st["median"] <= INT8_BOUND["median"]
            and st["max"] <= INT8_BOUND["max"])


def phase_int8_kernels(dev: dict, seed: int) -> dict:
    """TPU kernels 13/14 (``ops/block_kernel_int8.py``) against their plain
    version at (B, N) = (32, 512) (per-element) and (8, 256) (grouped), bf16
    and f32, ``qk_int8`` off and on; returns the bf16, ``qk_int8``-off
    numbers per route (the serving default) for the kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_kernel_int8 as bk8
    from vidsum_tpu_torch.ops.quant import quantize_block

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    d, H, scale = cfg.d_model, cfg.num_heads, cfg.attn_scale
    cuda = torch.device("cuda")
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed + 7)
                   ).encoder.module_list[0]
    # output channels of different sizes (log-uniform in [1/2, 2]), as a
    # trained layer's are: the uniform init gives every channel nearly the
    # same absmax, so a scale read from the wrong channel would go unseen
    g = torch.Generator().manual_seed(seed + 8)
    with torch.no_grad():
        for lin in (block.sa.q, block.sa.k, block.sa.v,
                    block.sa.feature_projection, block.mlp.fc1,
                    block.mlp.fc2):
            f = 2.0 ** (2 * torch.rand(lin.out_features, generator=g) - 1)
            lin.weight.mul_(f.to(cuda)[:, None])
    qb = quantize_block(block)
    # a planted fault: one layer's QKV scales rolled by one channel
    bad_qb = dataclasses.replace(qb, sqkv=torch.roll(qb.sqkv, 1))
    rng = np.random.default_rng(seed + 7)
    out = {}
    for B, N, route in ((32, 512, "_fused_block_int8"),
                        (8, 256, "_fused_block_int8_grouped")):
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        counter = getattr(bk8, route)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            def lossless():
                return bk.fused_encoder_block(block, x, mask, H, scale)

            with torch.inference_mode():
                lossless_ms = cuda_ms(lossless, reps=20)
            for qk in (False, True):
                def run(q=qb):
                    return bk8.fused_encoder_block_int8(q, x, mask, H, scale,
                                                        qk_int8=qk)

                def plain():
                    return bk8.int8_block_reference(qb, x, mask, H, scale,
                                                    qk)

                before = counter.launches
                got = run()
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"({B}, {N}) did not take {route}")
                want = plain()
                st = diff_stats(got, want)
                if not int8_within(st):
                    raise AssertionError(
                        f"{route} {dn} qk_int8={qk}: kernel disagrees with "
                        f"its plain version: {st} (bound {INT8_BOUND})")
                fault = diff_stats(run(bad_qb), want)
                if int8_within(fault):
                    raise AssertionError(
                        f"{route} {dn} qk_int8={qk}: a kernel with rolled "
                        f"QKV scales passes the bound: {fault}")
                ms = cuda_ms(run, reps=20)
                plain_ms = cuda_ms(plain, reps=5)
                itm = x.element_size()
                t_i8 = 24 * B * N * d * d / peaks["int8"]
                attn_half = 2 * d * N * valid
                t_att = (attn_half / peaks["int8" if qk else dn]
                         + attn_half / peaks[dn])
                t_ops = t_i8 + t_att
                nbytes = (2 * B * N * d * itm + 12 * d * d + 22 * d * 4
                          + B * N)
                t_bytes = nbytes / peaks["bytes"]
                b_ms = max(t_ops, t_bytes) * 1e3
                b_by = "operations" if t_ops >= t_bytes else "bytes"
                emit("int8_kernel", route=route, B=B, N=N, dtype=dn,
                     qk_int8=qk, diff=st, bound=INT8_BOUND,
                     rolled_scales_diff=fault, ms=ms, plain_ms=plain_ms,
                     lossless_block_ms=lossless_ms, library_ms=None,
                     bound_ms=b_ms, bound_by=b_by,
                     int8_ops=24 * B * N * d * d, attn_flops=2 * attn_half,
                     bytes=nbytes)
                if dtype == torch.bfloat16 and not qk:
                    # the serving default's device time by kernel, beside
                    # the lossless block's on the same inputs
                    with torch.inference_mode():
                        prof = device_profile(run, reps=10, top=12)
                        base = device_profile(lossless, reps=10)
                    products = sum(ms_ for name, ms_, _ in prof["top"]
                                   if "int8_gemm_wgmma" in name)
                    emit("block_profile", route=route, B=B, N=N, dtype=dn,
                         qk_int8=False, device_ms=prof["device_ms"],
                         wall_ms=prof["wall_ms"], products_ms=products,
                         kernels=prof["top"],
                         lossless_device_ms=base["device_ms"],
                         lossless_kernels=base["top"])
                if dtype == torch.bfloat16 and not qk:
                    out[route] = dict(max_abs_err=st["max"], ms=ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=None,
                                      device_ms=prof["device_ms"])
    return out


PROBE_ROUTES = ("mm_bf16", "mm_int8")


def phase_int8_probe(dev: dict) -> tuple:
    """TPU kernel 18 (``tools/probe_int8_mma.py``) at 2048^3: the probe's
    own measurement (its launches counted), then each kernel against its
    plain version: 18b bit for bit, 18a within one bf16 step of the plain
    value plus the rounding bound of an f32 sum in another order (K 2^-24
    sum |x||w|, which a result near 0 from cancellation can exceed a step
    by). Returns (the kernels-line numbers per route, the launches)."""
    import torch

    from vidsum_tpu_torch.tools import probe_int8_mma as probe

    peaks = peaks_for(dev["name"])
    M = N = K = 2048
    for fn in (probe.mm_bf16, probe.mm_int8):
        fn.launches = 0
    meas = probe.measure(M, N, K, reps=50)
    launches = {r: getattr(probe, r).launches for r in PROBE_ROUTES}
    if not all(launches.values()):
        raise AssertionError(f"probe kernels never launched: {launches}")
    # the same question at a size that fills the card for longer
    meas_8192 = probe.measure(8192, 8192, 8192, reps=10)
    xb, wb, xi, wi = probe.inputs(M, N, K)
    got8 = probe.mm_int8(xi, wi)
    want8 = probe.mm_int8_reference(xi, wi)
    if not torch.equal(got8, want8):
        raise AssertionError("probe mm_int8 differs from its plain version")
    got = probe.mm_bf16(xb, wb).float()
    want = probe.mm_bf16_reference(xb, wb).float()
    tol = want.abs() * 2.0 ** -7 + K * 2.0 ** -24 * torch.matmul(
        xb.float().abs(), wb.float().abs().t())
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"probe mm_bf16 off its plain version by "
                             f"{float(err.max())}")
    plain_ms = {"mm_bf16": cuda_ms(lambda: probe.mm_bf16_reference(xb, wb),
                                   reps=10),
                "mm_int8": cuda_ms(lambda: probe.mm_int8_reference(xi, wi),
                                   reps=10)}
    ops = 2 * M * N * K
    out = {}
    for route, key, lib, peak, itm, out_itm in (
            ("mm_bf16", "bf16_kernel", "bf16_torch_matmul", "bfloat16", 2,
             2),
            ("mm_int8", "int8_kernel", "int8_torch_int_mm", "int8", 1, 1)):
        t_ops = ops / peaks[peak]
        t_bytes = ((M * K + N * K) * itm + M * N * out_itm) / peaks["bytes"]
        out[route] = dict(
            max_abs_err=float(err.max()) if route == "mm_bf16" else 0.0,
            ms=meas[key]["ms"], plain_ms=plain_ms[route],
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=meas[lib]["ms"])
    emit("int8_probe", measure=meas, measure_8192=meas_8192,
         launches=launches,
         mm_int8_bit_equal=True, mm_bf16_bit_equal_share=float(
             (got == want).float().mean()), mm_bf16_max_abs_err=float(
                 err.max()), plain_ms=plain_ms,
         bound_ms={r: out[r]["bound_ms"] for r in PROBE_ROUTES})
    return out, launches


def phase_train_kernels(dev: dict, seed: int) -> dict:
    """The four training routes against autograd of their plain version;
    returns the f32 numbers per route (the recipe trains in f32)."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import block_train as bt

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    d, H, rate, scale = cfg.d_model, cfg.num_heads, 0.3, cfg.attn_scale
    cuda = torch.device("cuda")
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed + 2)
                   ).encoder.module_list[0]
    with torch.no_grad():
        w = bt.train_weights(block)
    rng = np.random.default_rng(seed + 3)
    dseed = int(rng.integers(0, 2**31 - 1))
    out = {}

    def bound(flops, nbytes):
        t_ops = flops / peaks["float32"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    # (256, 384) is a pretrain recipe step's batch (rows 11/12 over 98,304
    # rows: larger grids and offsets, more column-sum splits of dW than the
    # finetune shapes); checked in f32, the dtype pretraining runs, while
    # the finetune shapes' f32 numbers feed the kernels line
    both = (torch.bfloat16, torch.float32)
    for B, N, grouped, dtypes in ((32, 512, False, both),
                                  (8, 256, True, both),
                                  (256, 384, True, (torch.float32,))):
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        fwd = bt._fwd_kernel_grouped if grouped else bt._fwd_kernel
        bwd = bt._bwd_kernel_grouped if grouped else bt._bwd_kernel
        if (bt._pick_train_group(B, N) > 1) != grouped:
            raise AssertionError(f"({B}, {N}) does not route as expected")
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            x = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            do = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            # a zero cotangent for each row with an fc1 input near 0 (see
            # TOL): nothing of that row reaches its ReLU's derivative
            _, kept = bt._forward_chain(x, mask, dseed, w, H, scale, rate,
                                        keep=True)
            a1 = kept["a1"]
            near = (a1.abs() < NEAR_ZERO * a1.pow(2).mean().sqrt()).any(-1)
            do = do.masked_fill(near.view(B, N, 1), 0.0)
            del kept, a1
            f0, b0 = fwd.launches, bwd.launches
            got = fwd(x, mask, dseed, w, H, scale, rate)
            dx, grads = bwd(x, mask, dseed, w, do, H, scale, rate)
            torch.cuda.synchronize()
            if (fwd.launches, bwd.launches) != (f0 + 1, b0 + 1):
                raise AssertionError(f"({B}, {N}) did not launch its routes")
            want = bt.block_reference_with_masks(x, w, mask, dseed, H, scale,
                                                 rate)
            wdx, wgrads = bt.block_reference_backward(x, w, mask, dseed, do,
                                                      H, scale, rate)
            ftol = TOL[("train_fwd", dn)]
            gtol = TOL[("train_grad", "float32")]
            dxtol = TOL[("train_dx", dn)]
            fwd_err = check_close(got, want, ftol)
            dx_err = check_close(dx, wdx, scaled(dxtol, wdx), " (dx)")
            grad_err = {n: check_close(a, b, scaled(gtol, b), f" (d{n})")
                        for n, a, b in zip(bt.TrainWeights._fields, grads,
                                           wgrads)}
            # a planted fault: the kernels at seed + 1 fail the bounds
            bad = fwd(x, mask, dseed + 1, w, H, scale, rate)
            bad_dx, bad_grads = bwd(x, mask, dseed + 1, w, do, H, scale,
                                    rate)
            if (within(bad, want, ftol)
                    or within(bad_dx, wdx, scaled(dxtol, wdx))
                    or within(bad_grads.wqkv, wgrads.wqkv,
                              scaled(gtol, wgrads.wqkv))):
                raise AssertionError(f"({B}, {N}) {dn}: the kernels at seed "
                                     f"+ 1 pass the bounds")
            fault = (errors(bad, want)[1], errors(bad_dx, wdx)[1])
            dx2, grads2 = bwd(x, mask, dseed, w, do, H, scale, rate)
            if not (torch.equal(dx, dx2) and all(
                    torch.equal(a, b) for a, b in zip(grads, grads2))):
                raise AssertionError(f"({B}, {N}) {dn}: two backward runs "
                                     f"differ")
            ms_f = cuda_ms(lambda: fwd(x, mask, dseed, w, H, scale, rate),
                           reps=10)
            ms_b = cuda_ms(lambda: bwd(x, mask, dseed, w, do, H, scale,
                                       rate), reps=10)
            plain_f = cuda_ms(lambda: bt.block_reference_with_masks(
                x, w, mask, dseed, H, scale, rate), reps=3, warmup=1)
            plain_b = cuda_ms(lambda: bt.block_reference_backward(
                x, w, mask, dseed, do, H, scale, rate), reps=3, warmup=1)
            layer = library_block(block, d, H, dtype, dropout=rate)
            xl = x.detach().requires_grad_()

            def lib_fwd_bwd():
                layer(xl, src_key_padding_mask=mask).backward(do)

            with torch.no_grad():
                lib_f = cuda_ms(lambda: layer(x, src_key_padding_mask=mask),
                                reps=10)
            lib_b = cuda_ms(lib_fwd_bwd, reps=10)
            prof = None
            if dtype == torch.float32 and not grouped:
                prof = {"fwd": device_profile(lambda: fwd(
                    x, mask, dseed, w, H, scale, rate), reps=3),
                        "bwd": device_profile(lambda: bwd(
                            x, mask, dseed, w, do, H, scale, rate), reps=3)}
            itm = x.element_size()
            w_bytes = 12 * d * d * 4 + 13 * d * 4
            flops_f = 24 * B * N * d * d + 4 * d * N * valid
            bytes_f = 2 * B * N * d * itm + w_bytes + B * N
            flops_b = 48 * B * N * d * d + 8 * d * N * valid
            bytes_b = 3 * B * N * d * itm + 2 * w_bytes + B * N
            bf_ms, bf_by = bound(flops_f, bytes_f)
            bb_ms, bb_by = bound(flops_b, bytes_b)
            name_f = fwd.__name__
            name_b = bwd.__name__
            worst = max(grad_err, key=lambda n: grad_err[n][1])
            emit("train_kernel", route=name_f, B=B, N=N, dtype=dn,
                 max_abs_err=fwd_err[0], rel_rms_err=fwd_err[1],
                 tolerance=ftol, seed_plus_one_rel_rms=fault[0], ms=ms_f,
                 plain_ms=plain_f, library_ms=lib_f, bound_ms=bf_ms,
                 bound_by=bf_by, flops=flops_f, bytes=bytes_f)
            emit("train_kernel", route=name_b, B=B, N=N, dtype=dn,
                 dx_err=dx_err, rows_zero_cotangent=int(near.sum()),
                 worst_grad=[worst, *grad_err[worst]],
                 grad_rel_rms={n: e[1] for n, e in grad_err.items()},
                 tolerance_dx=dxtol, tolerance_grad=gtol,
                 seed_plus_one_dx_rel_rms=fault[1], deterministic=True,
                 ms=ms_b, plain_ms=plain_b, library_ms=lib_b,
                 bound_ms=bb_ms, bound_by=bb_by, flops=flops_b,
                 bytes=bytes_b, profile=prof)
            if dtype == torch.float32 and name_f not in out:
                out[name_f] = dict(max_abs_err=fwd_err[0], ms=ms_f,
                                   plain_ms=plain_f, bound_ms=bf_ms,
                                   bound_by=bf_by, library_ms=lib_f)
                out[name_b] = dict(max_abs_err=max(
                    [dx_err[0]] + [e[0] for e in grad_err.values()]),
                    ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms,
                    bound_by=bb_by, library_ms=lib_b)
    return out


def compare_steps(results, what: str, spare: float = 0.0,
                  cap: float | None = None) -> dict:
    """A training forward + backward on the card against the CPU's plain
    path: the loss within 1e-4 relative and each parameter's grad by the
    step bound (a grad whose reference norm is at rounding level by the
    elementwise bound only). With ``spare``, up to that share of a
    tensor's entries may pass the elementwise part, none by more than
    ``cap`` of the step's largest grad. ``results`` is [(loss, grads)] for
    card, CPU."""
    (loss_card, g_card), (loss_cpu, g_cpu) = results
    if not abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError(f"{what}: loss on the card {loss_card} != CPU "
                             f"{loss_cpu}")
    gtol = TOL[("step_grad", "float32")]
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    nmax = max(float(g.norm()) for g in g_cpu.values())
    per_tensor, rounding_level, past = {}, [], {}
    for k, want in g_cpu.items():
        tol = {**gtol, "atol": gtol["atol"] * gmax}
        if float(want.norm()) < ROUNDING_NORM * nmax:
            rounding_level.append(k)
            tol["rel"] = float("inf")
        if not spare:
            per_tensor[k] = check_close(g_card[k], want, tol,
                                        f" ({what}: d {k})")
            continue
        got = g_card[k].float()
        err, rel = errors(got, want)
        over = float((~((got - want).abs() <= tol["atol"] + tol["rtol"]
                        * want.abs())).float().mean())
        if rel > tol["rel"] or over > spare or err > cap * gmax:
            raise AssertionError(
                f"{what}: d {k} on the card against the CPU: max abs err "
                f"{err} (cap {cap * gmax}), relative RMS {rel} (bound "
                f"{tol['rel']}), {over} of its entries past the elementwise "
                f"bound (at most {spare})")
        per_tensor[k] = err, rel
        if over:
            past[k] = over
    out = dict(loss=[loss_card, loss_cpu],
               grads=[max(e[0] for e in per_tensor.values()),
                      max(e[1] for k, e in per_tensor.items()
                          if k not in rounding_level)],
               largest_grad=gmax, tolerance=gtol,
               grad_rel_rms={k: e[1] for k, e in per_tensor.items()},
               rounding_level=rounding_level)
    if spare:
        out.update(spare=spare, cap=cap, past_elementwise=past)
    return out


def flash_card_vs_cpu(model, cfg, xb, tb, mb, rng, what: str,
                      routes, spare: float = 0.0,
                      cap: float | None = None) -> dict:
    """The flash training route's forward, masked-MSE loss and backward on
    the card and on the CPU, with the same numpy-made residual and MLP keep
    masks (``dropout_masks``) and per-layer attention seeds
    (``block_seeds``): the card draws other dropout bits than the CPU from
    a generator, and ``make_finetune_step`` takes no masks. ``routes`` are
    the training attention routes the card's run must launch; ``spare`` and
    ``cap`` go to ``compare_steps``."""
    import copy

    import torch

    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.ops.losses import mse_with_mask_loss

    B, N = mb.shape
    d, L, keep = cfg.d_model, cfg.num_layers, 1.0 - cfg.dropout
    masks = [{"res1": rng.random((B, N, d)) < keep,
              "mlp": rng.random((B, N, cfg.mlp_scale * d)) < keep,
              "res2": rng.random((B, N, d)) < keep} for _ in range(L)]
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, L)]
    results, t_s = [], {}
    for dev in ("cuda", "cpu"):
        before = [getattr(at, r).launches for r in routes]
        t0 = time.monotonic()
        m = copy.deepcopy(model).to(dev)
        x, t, mk = (torch.as_tensor(a).to(dev) for a in (xb, tb, mb))
        scores, _ = m(x, mk, attn_impl="flash", deterministic=False,
                      dropout_masks=masks, block_seeds=seeds)
        loss = mse_with_mask_loss(scores, t, mk)
        loss.backward()
        results.append((float(loss.detach()),
                        {k: p.grad.detach().float().cpu()
                         for k, p in m.named_parameters()}))
        t_s[dev] = time.monotonic() - t0
        moved = [getattr(at, r).launches - b for r, b in zip(routes, before)]
        if dev == "cuda" and moved != [L] * len(routes):
            raise AssertionError(f"{what}: launches {moved} of {routes}, "
                                 f"expected {L} each")
    return dict(B=B, N=N, layers=L, routes=[attn_train_name(r)
                                            for r in routes],
                wall_s=t_s, **compare_steps(results, what, spare, cap))


ATTN_TRAIN_ROUTES = ("_fwd_kernel", "_bwd_kernel", "_fwd_kernel_folded",
                     "_bwd_kernel_folded")


def attn_train_name(route: str) -> str:
    """The counter and kernels-line name of a training attention route,
    qualified by its module (``block_train`` has routes of the same names)."""
    return f"attention_train.{route}"


def hold_attn_train(folded: bool, q, k, v, do, mask, dseed: int,
                    rate: float, scale: float, kb: int) -> dict:
    """Hold one training attention route's kernels (the fold if ``folded``,
    else the single pass) against their plain versions on the card: o, lse
    and the grads within the ``attn_train_*`` bounds of q's dtype, the
    kernels at dseed + 1 (a planted fault) outside them, and two backward
    runs equal bit for bit. Returns the errors, the fault's relative RMS
    (o, dq), the kernel's and the plain version's outputs, and the four
    calls at a given seed (kernel and plain, forward and backward)."""
    import torch

    from vidsum_tpu_torch.ops import attention_train as at

    N, dn = q.shape[2], str(q.dtype).split(".")[1]
    fwd = at._fwd_kernel_folded if folded else at._fwd_kernel
    bwd = at._bwd_kernel_folded if folded else at._bwd_kernel
    if folded:
        # all rows over the kernel's 64-key tiles: in bf16 the unnormalised
        # e is rounded per tile
        def run_f(s):
            return fwd(q, k, v, mask, s, rate, scale, kb)

        def run_b(s, lse, o):
            return bwd(q, k, v, mask, s, lse, do, o, rate, scale, kb)

        def pf(s):
            return at.attention_train_fwd_folded_reference(
                q, k, v, mask, s, rate, scale, at.KEY_TILE, rows=N)

        def pb(s, lse, o):
            return at.attention_train_bwd_folded_reference(
                q, k, v, mask, s, lse, do, o, rate, scale, at.KEY_TILE,
                rows=N)
    else:
        # 1,024 query rows at a time; the backward given o, as the Function
        # gives it (f32 kernels take D = rowsum(do * o) from it)
        def run_f(s):
            return fwd(q, k, v, mask, s, rate, scale)

        def run_b(s, lse, o):
            return bwd(q, k, v, mask, s, lse, do, rate, scale, o=o)

        def pf(s):
            return at.attention_train_fwd_reference(
                q, k, v, mask, s, rate, scale, rows=1024)

        def pb(s, lse, o):
            return at.attention_train_bwd_reference(
                q, k, v, mask, s, lse, do, rate, scale, rows=1024)

    f0, b0 = fwd.launches, bwd.launches
    o, lse = run_f(dseed)
    want_o, want_lse = pf(dseed)
    # both backward versions take the plain forward's lse and o
    grads = run_b(dseed, want_lse, want_o)
    torch.cuda.synchronize()
    if (fwd.launches, bwd.launches) != (f0 + 1, b0 + 1):
        raise AssertionError(f"{fwd.__name__} did not launch")
    want = pb(dseed, want_lse, want_o)
    otol = TOL[("attn_train_o", dn)]
    ltol = TOL[("attn_train_lse", dn)]
    gtol = TOL[("attn_train_grad", dn)]
    o_err = check_close(o, want_o, otol, " (o)")
    lse_err = check_close(lse, want_lse, ltol, " (lse)")
    grad_err = {n: check_close(a, b, scaled(gtol, b), f" (d{n})")
                for n, a, b in zip("qkv", grads, want)}
    # a planted fault: the kernels at seed + 1 fail the bounds
    bad_o, _ = run_f(dseed + 1)
    bad = run_b(dseed + 1, want_lse, want_o)
    if within(bad_o, want_o, otol) or any(
            within(a, b, scaled(gtol, b)) for a, b in zip(bad, want)):
        raise AssertionError(f"{fwd.__name__} {dn}: the kernels at "
                             f"seed + 1 pass the bounds")
    fault = (errors(bad_o, want_o)[1], errors(bad[0], want[0])[1])
    again = run_b(dseed, want_lse, want_o)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{bwd.__name__} {dn}: two backward runs "
                             f"differ")
    return dict(o=o, want_o=want_o, want_lse=want_lse, o_err=o_err,
                lse_err=lse_err, grad_err=grad_err, fault=fault,
                o_tol=otol, grad_tol=gtol, calls=(run_f, run_b, pf, pb))


def phase_train_attention(dev: dict, seed: int, fma_ptxas=()) -> dict:
    """The four training attention routes (``ops/attention_train.py``, TPU
    kernels 5-8) against their plain versions at (B, H, N, Dh) =
    (2, 4, 8192, 64), valid lengths (8100, 5000), dropout 0.3, f32 and bf16;
    returns per route the numbers of each dtype: the single-pass routes in
    bf16 (``<route>``) and f32 (``<route>.f32``), the folded ones in f32
    (``<route>``) and bf16 (``<route>.bf16``). Each f32 line also gives the
    FMA rate on valid keys, the share of live key tiles and the FMA
    kernels' ``ptxas`` report at head_dim 64 (``fma_ptxas``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.ops import attention_train as at

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    B, H, N, Dh = 2, cfg.num_heads, 8192, cfg.head_dim
    rate, scale = 0.3, cfg.attn_scale
    cuda = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    dseed = int(rng.integers(0, 2**31 - 2))
    valid = (8100, 5000)
    mask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    for b, n in enumerate(valid):
        mask[b, :n] = False
    keep_sdpa = ~mask[:, None, None, :]
    kb = at._pick_key_block(N)
    sum_valid = sum(valid)
    # the 64-key tiles holding an unpadded key: what the kernels walk
    live_share = float((~mask).view(B, N // at.KEY_TILE, at.KEY_TILE)
                       .any(-1).float().mean())
    fma_64 = [r for r in fma_ptxas if "<64," in r["kernel"]
              or "ILi64E" in r["kernel"]]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        itm = torch.finfo(dtype).bits // 8
        q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, N, Dh)).astype(
            np.float32)).to(cuda, dtype) for _ in range(4))
        own = {}
        for folded in (False, True):
            fwd = at._fwd_kernel_folded if folded else at._fwd_kernel
            bwd = at._bwd_kernel_folded if folded else at._bwd_kernel
            held = hold_attn_train(folded, q, k, v, do, mask, dseed, rate,
                                   scale, kb)
            run_f, run_b, pf, pb = held["calls"]
            o_err, lse_err, grad_err, fault = (
                held[e] for e in ("o_err", "lse_err", "grad_err", "fault"))
            want_o, want_lse = held["want_o"], held["want_lse"]
            otol, gtol = held["o_tol"], held["grad_tol"]
            own[folded] = (held["o"], want_o)
            ms_f = cuda_ms(lambda: run_f(dseed), reps=10)
            ms_b = cuda_ms(lambda: run_b(dseed, want_lse, want_o), reps=10)
            plain_f = cuda_ms(lambda: pf(dseed), reps=3, warmup=1)
            plain_b = cuda_ms(lambda: pb(dseed, want_lse, want_o), reps=3,
                              warmup=1)
            # library yardstick: SDPA with its own dropout, timed only
            lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep_sdpa, dropout_p=rate, scale=scale),
                reps=10)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            lib_b = cuda_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=keep_sdpa, dropout_p=rate,
                scale=scale).backward(do), reps=10)
            del ql, kl, vl
            # bounds: the forward's two products at the input type's peak;
            # in the FMA family (f32) the backward's dp and dV are f32 x
            # f32, dQ and dK at the input type's peak; the bf16 tensor-core
            # kernels (both routes) take dp, dQ and dK at the bf16 peak and
            # dV's f32 pd as three bf16 products (the recompute not
            # counted). The FMA family's backward bound is printed beside
            # (bound_ms_fma)
            flops = 4 * H * Dh * N * sum_valid
            mma = dtype == torch.bfloat16
            t_f = flops / peaks[dn]
            t_b_fma = flops / peaks["float32"] + flops / peaks[dn]
            t_b = 3 * flops / peaks[dn] if mma else t_b_fma
            qkv_bytes = B * H * N * Dh * itm
            bytes_f = 4 * qkv_bytes + B * N + B * H * N * 4
            bytes_b = ((7 + int(folded)) * qkv_bytes + B * N + B * H * N * 4)
            bf_ms = max(t_f, bytes_f / peaks["bytes"]) * 1e3
            bb_ms = max(t_b, bytes_b / peaks["bytes"]) * 1e3
            bf_by = "operations" if t_f >= bytes_f / peaks["bytes"] \
                else "bytes"
            bb_by = "operations" if t_b >= bytes_b / peaks["bytes"] \
                else "bytes"
            name_f, name_b = (attn_train_name(fwd.__name__),
                              attn_train_name(bwd.__name__))
            # the f32 FMA family: its rate on the valid keys' products
            # (the bound's operations over the time), the live tiles, ptxas;
            # the single pass also without o (D summed in a first pass)
            fma = {} if mma else dict(
                fma_tflops_valid=[flops / ms_f * 1e-9,
                                  2 * flops / ms_b * 1e-9],
                live_tile_share=live_share, ptxas=fma_64)
            if not mma and not folded:
                fma["ms_without_o"] = cuda_ms(lambda: bwd(
                    q, k, v, mask, dseed, want_lse, do, rate, scale),
                    reps=10)
            emit("train_attention_kernel", route=name_f, B=B, H=H, N=N,
                 Dh=Dh, valid=list(valid), dtype=dn, o_err=o_err,
                 lse_err=lse_err, tolerance=otol,
                 seed_plus_one_rel_rms=fault[0], ms=ms_f, plain_ms=plain_f,
                 library_ms=lib_f, bound_ms=bf_ms, bound_by=bf_by,
                 tensor_cores=mma, flops=flops, bytes=bytes_f, **fma)
            emit("train_attention_kernel", route=name_b, B=B, H=H, N=N,
                 Dh=Dh, valid=list(valid), dtype=dn,
                 grad_err={n: list(e) for n, e in grad_err.items()},
                 tolerance=gtol, seed_plus_one_dq_rel_rms=fault[1],
                 deterministic=True, ms=ms_b, plain_ms=plain_b,
                 library_ms=lib_b, bound_ms=bb_ms, bound_by=bb_by,
                 bound_ms_fma=max(t_b_fma, bytes_b / peaks["bytes"]) * 1e3,
                 tensor_cores=mma, flops=(3 if mma else 2) * flops,
                 bytes=bytes_b, **fma)
            # the kernels line, every route in both dtypes: the single-pass
            # routes in bf16 (the bf16 long-video step up to 10,880 frames)
            # and f32 (".f32": the flash route's f32 step, phase 7), the
            # folded ones in f32 (the f32 long-video step) and bf16
            # (".bf16": past 10,880 frames)
            tag = ((".bf16" if folded else "") if mma
                   else ("" if folded else ".f32"))
            name_f, name_b = name_f + tag, name_b + tag
            out[name_f] = dict(dtype=dn,
                               max_abs_err=max(o_err[0], lse_err[0]),
                               ms=ms_f, plain_ms=plain_f, bound_ms=bf_ms,
                               bound_by=bf_by, library_ms=lib_f)
            out[name_b] = dict(
                dtype=dn, max_abs_err=max(e[0] for e in grad_err.values()),
                ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms, bound_by=bb_by,
                library_ms=lib_b)
        if dtype == torch.bfloat16:
            # each bf16 forward route rounds where its TPU kernel does: it
            # lies at least twice as close to its own plain version as to
            # the other route's
            for folded in (False, True):
                got, mine = own[folded]
                _, other = own[not folded]
                r_own, r_other = errors(got, mine)[1], errors(got, other)[1]
                if not r_own < r_other / 2:
                    raise AssertionError(
                        f"bf16 forward (folded={folded}): relative RMS "
                        f"{r_own} against its own plain version, {r_other} "
                        f"against the other route's")
                emit("train_attention_rounding", folded=folded,
                     rel_rms_own=r_own, rel_rms_other_route=r_other)
        del q, k, v, do, own
        torch.cuda.empty_cache()
    return out


# d_model 512 with 4 heads (head_dim 128): the JAX package's wide scorer
# (tests/test_block_kernel.py:101, ckpts/soak_d512v200)
D512 = dict(d_model=512, num_heads=4)
# head_dim 96: ModelConfig(d_model=384, num_heads=4) and d_model 768 with 8
# heads, the widest row the row kernels take
D384 = dict(d_model=384, num_heads=4)
D768 = dict(d_model=768, num_heads=8)
# head_dims the kernels run zero-padded (48 -> 64, 80 -> 96, 112 -> 128) and
# the widest d_model the row kernels take (1,024 with 8 heads: 128)
D192 = dict(d_model=192, num_heads=4)
D320 = dict(d_model=320, num_heads=4)
D896 = dict(d_model=896, num_heads=8)
D1024 = dict(d_model=1024, num_heads=8)
# a wide model's bf16 scores on the card against the CPU's plain bf16 path
# (sigmoid scores, two layers): the int8 block's limits, a wiring check; each
# kernel family's precision is held by its own bound above
WIDE_SCORES = dict(median=5e-3, max=5e-2)
# the depth of the model part of phase_wide's shapes (a wiring check: each
# family is held at its own shapes before it), 1 so that the run keeps to
# its time
WIDE_LAYERS = 1
# widths the kernels refused before head_dim slices and the looping row
# kernels: head_dim 160 (d 640 with 4 heads: two slices, the second 32
# columns wide, zero-padded), 256 (1,024 with 4; 2,048 with 8), 320 (1,280
# with 4: three slices, the last 64 wide), 132 (1,056 with 8: LayerNorm
# rows past 1,024 columns, heads padded to two slices) and 50 (200 with 4:
# d_model off the 32-column grid); their model part at 1 layer and 256
# frames
WIDE_SLICED = [dict(d_model=640, num_heads=4), dict(d_model=1024, num_heads=4),
               dict(d_model=1280, num_heads=4), dict(d_model=1056, num_heads=8),
               dict(d_model=2048, num_heads=8), dict(d_model=200, num_heads=4)]


def phase_wide(seed: int, shape: dict, layers: int = WIDE_LAYERS,
               n_model: int = 512) -> dict:
    """A model shape past the flagship's (``shape``: d_model 512 with 4
    heads, head_dim 128; d_model 384 with 4 heads and 768 with 8, head_dim
    96; 192 and 320 with 4 and 896 with 8, head_dims 48, 80 and 112, which
    the kernels run zero-padded; 1,024 with 8; and the shapes of
    WIDE_SLICED: head_dims past 128, which every attention family runs in
    128-column slices, LayerNorm rows past 1,024 columns and a d_model off
    the 32-column grid) through every kernel family
    against its plain version at small shapes: the serving block (1-2;
    its LayerNorm rows past the GEMM's 256-column tile), the int8 block
    (13-14), the training block (9-12,
    forward, dx and grads), the training attention (5-8, bf16 and f32) and
    the ring steps (15-17). Past head_dim 128, the serving attention run
    with the second slice of Q and K zeroed (a kernel that skips that
    slice of Q.K^T) must fail the attention bound, and past d 1,024 a
    LayerNorm whose statistics take the first 1,024 columns only must fail
    the block bound. Then a ``layers``-layer model of that shape scores
    (batch 2 x ``n_model`` frames) in
    bf16 and in f32 (card against the CPU's plain path), int8-scores
    (within the lossy budget of its bf16 scores) and takes one finetune
    step on the JAX package's route for the shape (the fused block, or
    past its training envelope, as at d 896 and 1,024, the flash route
    with the same dropout masks on both sides; card against CPU, the step
    bound). Returns the checks' report and the launches of the routes it
    ran (the kernels line's ``launches_wide``); they are checks, not the
    main path's."""
    import copy

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import _cuda
    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_kernel_int8 as bk8
    from vidsum_tpu_torch.ops import block_train as bt
    from vidsum_tpu_torch.ops.quant import quantize_block
    from vidsum_tpu_torch.train.steps import make_finetune_step, make_optimizer

    cuda = torch.device("cuda")
    reset_counters()
    cfg = ModelConfig(num_layers=1, **shape)
    d, H, Dh, scale, rate = cfg.d_model, cfg.num_heads, cfg.head_dim, \
        cfg.attn_scale, 0.3
    block = SimNet(cfg, device=cuda,
                   generator=torch.Generator().manual_seed(seed + 20)
                   ).encoder.module_list[0]
    rng = np.random.default_rng(seed + 20)
    dseed = int(rng.integers(0, 2**31 - 2))
    rep = {}

    def randn(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, dtype)

    def launched(fn, counter, what):
        before = counter.launches
        out = fn()
        torch.cuda.synchronize()
        if counter.launches != before + 1:
            raise AssertionError(f"d {d}: {what} did not launch")
        return out

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        # 1-2, each entry point (in f32 past the copied TPU envelope)
        w = bk.block_weights(block, dtype)
        for B, N, route in ((1, 512, "_fused_block"),
                            (2, 128, "_fused_block_grouped")):
            x, mask = randn(B, N, d, dtype=dtype), pad_mask(B, N, rng, cuda)
            fn = getattr(bk, route)
            with torch.inference_mode():
                got = launched(lambda: fn(w, x, mask, H, scale), fn, route)
                want = bk.encoder_block_reference(w, x, mask, H, scale)
            rep[f"{route}.{dn}"] = check_close(got, want, TOL[("block", dn)],
                                               f" (d {d} {route})")
        # 13-14, each entry point (d 768 is past the copied TPU envelope)
        qb = quantize_block(block)
        # past head_dim 128 also with qk_int8: the sliced kernels' int8
        # scores, summed over the slices in s32
        for B, N, route, qk8 in ((1, 512, "_fused_block_int8", False),
                                 (2, 256, "_fused_block_int8_grouped", False),
                                 *(((2, 256, "_fused_block_int8_grouped",
                                     True),) if Dh > 128 else ())):
            x, mask = randn(B, N, d, dtype=dtype), pad_mask(B, N, rng, cuda)
            with torch.inference_mode():
                fn = getattr(bk8, route)
                got = launched(lambda: fn(qb, x, mask, H, scale, qk8), fn,
                               route)
                want = bk8.int8_block_reference(qb, x, mask, H, scale, qk8)
            st = diff_stats(got, want)
            if not int8_within(st):
                raise AssertionError(f"d {d} {route} {dn} qk_int8={qk8}: "
                                     f"{st} past {INT8_BOUND}")
            rep[f"{route}.{dn}" + (".qk_int8" if qk8 else "")] = st
        # 5-8 at head_dim 128, valid lengths 2,000 and 1,100 of 2,048
        B, N = 2, 2048
        mask = torch.ones(B, N, dtype=torch.bool, device=cuda)
        mask[0, :2000] = False
        mask[1, :1100] = False
        q, k, v, do = (randn(B, H, N, Dh, dtype=dtype) for _ in range(4))
        for folded in (False, True):
            fwd = at._fwd_kernel_folded if folded else at._fwd_kernel
            bwd = at._bwd_kernel_folded if folded else at._bwd_kernel
            kb = at.KEY_TILE
            if folded:
                o, lse = launched(lambda: fwd(q, k, v, mask, dseed, rate,
                                              scale, kb), fwd, fwd.__name__)
                wo, wl = at.attention_train_fwd_folded_reference(
                    q, k, v, mask, dseed, rate, scale, kb, rows=N)
                grads = launched(lambda: bwd(q, k, v, mask, dseed, wl, do, wo,
                                             rate, scale, kb), bwd,
                                 bwd.__name__)
                want = at.attention_train_bwd_folded_reference(
                    q, k, v, mask, dseed, wl, do, wo, rate, scale, kb,
                    rows=N)
            else:
                o, lse = launched(lambda: fwd(q, k, v, mask, dseed, rate,
                                              scale), fwd, fwd.__name__)
                wo, wl = at.attention_train_fwd_reference(
                    q, k, v, mask, dseed, rate, scale, rows=512)
                grads = launched(lambda: bwd(q, k, v, mask, dseed, wl, do,
                                             rate, scale), bwd, bwd.__name__)
                want = at.attention_train_bwd_reference(
                    q, k, v, mask, dseed, wl, do, rate, scale, rows=512)
            name = f"{attn_train_name(fwd.__name__)}.{dn}"
            rep[name] = {
                "o": check_close(o, wo, TOL[("attn_train_o", dn)],
                                 f" (d {d} {name} o)"),
                "lse": check_close(lse, wl, TOL[("attn_train_lse", dn)],
                                   f" (d {d} {name} lse)"),
                **{f"d{n}": check_close(
                    a, b, scaled(TOL[("attn_train_grad", dn)], b),
                    f" (d {d} {name} d{n})")
                   for n, a, b in zip("qkv", grads, want)}}
        del q, k, v, do

    # 9-12 (f32 products in both dtypes; f32 here)
    with torch.no_grad():
        tw = bt.train_weights(block)
    for B, N, grouped in ((1, 512, False), (4, 256, True)):
        fwd = bt._fwd_kernel_grouped if grouped else bt._fwd_kernel
        bwd = bt._bwd_kernel_grouped if grouped else bt._bwd_kernel
        if (bt._pick_train_group(B, N) > 1) != grouped:
            raise AssertionError(f"d {d} ({B}, {N}) does not route as "
                                 f"expected")
        x, do, mask = randn(B, N, d), randn(B, N, d), pad_mask(B, N, rng,
                                                                cuda)
        _, kept = bt._forward_chain(x, mask, dseed, tw, H, scale, rate,
                                    keep=True)
        a1 = kept["a1"]
        near = (a1.abs() < NEAR_ZERO * a1.pow(2).mean().sqrt()).any(-1)
        do = do.masked_fill(near.view(B, N, 1), 0.0)
        del kept, a1
        got = launched(lambda: fwd(x, mask, dseed, tw, H, scale, rate), fwd,
                       fwd.__name__)
        dx, grads = launched(lambda: bwd(x, mask, dseed, tw, do, H, scale,
                                         rate), bwd, bwd.__name__)
        want = bt.block_reference_with_masks(x, tw, mask, dseed, H, scale,
                                             rate)
        wdx, wgrads = bt.block_reference_backward(x, tw, mask, dseed, do, H,
                                                  scale, rate)
        gtol = TOL[("train_grad", "float32")]
        rep[f"{fwd.__name__}.block_train"] = {
            "fwd": check_close(got, want, TOL[("train_fwd", "float32")],
                               f" (d {d} block train)"),
            "dx": check_close(dx, wdx, scaled(gtol, wdx),
                              f" (d {d} block train dx)"),
            "worst_grad_rel_rms": max(
                check_close(a, b, scaled(gtol, b), f" (d {d} d{n})")[1]
                for n, a, b in zip(bt.TrainWeights._fields, grads,
                                   wgrads))}

    # 15-17 at head_dim 128: one shard of 1,024 of a 4,096-frame sequence
    ra = ring_module()
    B, Nl = 2, 1024
    q32 = randn(B, H, Nl, Dh) * scale
    k, v, g = (randn(B, H, Nl, Dh) for _ in range(3))
    mask = torch.zeros(B, Nl, dtype=torch.bool, device=cuda)
    mask[1, 700:] = True
    carry = ra._init_carries(q32)
    for kv_dtype in (torch.bfloat16, torch.float32):
        kd, vd = k.to(kv_dtype), v.to(kv_dtype)
        got = launched(lambda: ra._ring_block_step(q32, kd, vd, mask,
                                                   *carry),
                       ra._ring_block_step, "ring block step")
        want = ra.ring_block_step_reference(q32, kd, vd, mask, *carry)
        rep[f"ring_block.{str(kv_dtype).split('.')[1]}"] = check_carries(
            got, want, f"d {d} ring block step")
    info = (dseed, 2, 1024, 2048)
    got = launched(lambda: ra._ring_train_step(q32, k, v, mask, info,
                                               *carry, rate),
                   ra._ring_train_step, "ring train step")
    want = ra.ring_train_step_reference(q32, k, v, mask, info, *carry, rate)
    rep["ring_train_fwd"] = check_carries(got, want, f"d {d} ring train step")
    o, m, l = want
    dr = (g * o / l).sum(-1, keepdim=True)
    acc = tuple(torch.zeros_like(t) for t in (q32, k, v))
    args = (q32, k, v, g, dr, m, l, mask, info, *acc, rate)
    grads = launched(lambda: ra._ring_train_step_bwd(*args),
                     ra._ring_train_step_bwd, "ring train backward")
    ref = ra.ring_train_step_bwd_reference(*args)
    rep["ring_train_bwd"] = {
        f"d{n}": check_close(a, b, scaled(TOL[RING_GRAD], b),
                             f" (d {d} ring d{n})")
        for n, a, b in zip("qkv", grads, ref)}
    del q32, k, v, g
    faults = wide_faults(cfg, rng) if Dh > 128 or d > 1024 else {}
    launches = read_counters()

    # a ``layers``-layer model: bf16 and int8 scores, f32 scores, one
    # finetune step
    mcfg = ModelConfig(num_layers=layers, compute_dtype="bfloat16", **shape)
    model = SimNet(mcfg, generator=torch.Generator().manual_seed(seed + 21))
    x = torch.from_numpy(rng.normal(
        size=(2, n_model, mcfg.in_features)).astype(np.float32))
    mask = pad_mask(2, n_model, rng, "cpu")
    with torch.inference_mode():
        card, _ = model.to(cuda)(x.to(cuda), mask.to(cuda))
        card8, _ = model(x.to(cuda), mask.to(cuda), attn_impl="int8_block")
        cpu, _ = copy.deepcopy(model).to("cpu")(x, mask)
    live = ~mask.to(cuda)
    p16, p8 = torch.sigmoid(card.float()[..., 0]), torch.sigmoid(
        card8.float()[..., 0])
    vs_cpu = diff_stats(p16[live], torch.sigmoid(cpu.float()[..., 0])
                        .to(cuda)[live])
    vs_bf16 = diff_stats(p8[live], p16[live])
    if not (vs_cpu["median"] <= WIDE_SCORES["median"]
            and vs_cpu["max"] <= WIDE_SCORES["max"]):
        raise AssertionError(f"d {d} bf16 scores, card against CPU: {vs_cpu}")
    if not (vs_bf16["median"] < INT8_VS_BF16["median"]
            and vs_bf16["max"] < INT8_VS_BF16["max"]):
        raise AssertionError(f"d {d} int8 scores against bf16: {vs_bf16}")
    # f32 scores (the default dtype's service), card against CPU
    fcfg = ModelConfig(num_layers=layers, **shape)
    model = SimNet(fcfg, generator=torch.Generator().manual_seed(seed + 23))
    with torch.inference_mode():
        card, _ = model.to(cuda)(x.to(cuda), mask.to(cuda))
        cpu, _ = copy.deepcopy(model).to("cpu")(x, mask)
    vs_cpu32 = check_close(card.cpu(), cpu, TOL[("block", "float32")],
                           f" (d {d} f32 scores, card against CPU)")
    tcfg = ModelConfig(num_layers=layers, **shape)
    model = SimNet(tcfg, generator=torch.Generator().manual_seed(seed + 22))
    # the widths of WIDE_SLICED take the pretrain step's rule: at d 1,280 a
    # ReLU flip moved fc1's grads past the elementwise part (max 1.7e-4 of
    # the largest grad, relative RMS 8.9e-4 within its bound) while every
    # kernel held its own bound at 1e-5
    spare = (STEP_SPARE, STEP_CAP) if shape in WIDE_SLICED else ()
    t = torch.from_numpy(rng.random((2, n_model)).astype(np.float32))
    if bt.fused_block_train_supported(2, n_model, d, H):
        seeds = [int(s) for s in rng.integers(0, 2**31 - 1,
                                              tcfg.num_layers)]
        results = []
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model).to(dev)
            loss = make_finetune_step(tcfg, "fused_block", device=dev)(
                m, make_optimizer(m, 1e-3, 1e-4), x, t, mask, None,
                block_seeds=seeds)
            results.append((float(loss), {k: p.grad.detach().float().cpu()
                                          for k, p in
                                          m.named_parameters()}))
        step = compare_steps(results, f"d {d} fused_block step", *spare)
    else:
        # past the fused block's training envelope the JAX package's route
        # (and so the step's) is the flash one: TPU kernels 5/6
        step = flash_card_vs_cpu(model, tcfg, x.numpy(), t.numpy(),
                                 mask.numpy(), rng, f"d {d} flash step",
                                 ("_fwd_kernel", "_bwd_kernel"), *spare)
    emit(f"d{d}_h{H}" if shape in WIDE_SLICED else f"d{d}", d_model=d,
         num_heads=H, head_dim=Dh,
         kernel_head_dim=_cuda.kernel_head_dim(Dh, "kernels"),
         head_slices=_cuda.head_slices(Dh),
         ln_rows=_cuda.ln_rows_path(d, False), layers=layers,
         model_frames=n_model, kernels=rep, planted_faults=faults,
         scores_bf16_card_vs_cpu=vs_cpu, scores_int8_vs_bf16=vs_bf16,
         scores_f32_card_vs_cpu=vs_cpu32, step_card_vs_cpu=step)
    return rep, launches


def wide_faults(cfg, rng) -> dict:
    """The planted faults of a wide shape. Past head_dim 128: the serving
    attention (both dtypes) on Q and K whose second 128-column slice is
    zeroed, which is what a kernel that skips that slice of Q.K^T computes,
    held against the plain version of the whole head, must fail the
    attention bound. Past d 1,024: the residual+LayerNorm epilogue's rows
    as a row kernel that holds 1,024 columns would leave them (the old
    32-a-lane one, unguarded): the first 1,024 columns normalised with
    their own mean and variance, the rest left pre-LN, held against the
    plain version, must fail the block bound (the kernel's own rows pass
    it)."""
    import torch

    from vidsum_tpu_torch.ops import attention as attn_mod
    from vidsum_tpu_torch.ops import block_kernel as bk

    cuda = torch.device("cuda")
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    out = {}

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            "float32")).to(cuda)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        if Dh > 128:
            q, k, v = (randn(2, H, 512, Dh).to(dtype) for _ in range(3))
            mask = pad_mask(2, 512, rng, cuda)
            want = attn_mod.attention_reference(q, k, v, mask, cfg.attn_scale)
            got = attn_mod.masked_attention(q, k, v, mask, cfg.attn_scale)
            check_close(got, want, TOL[("attention", dn)],
                        f" (d {d} sliced attention)")
            qz, kz = q.clone(), k.clone()
            qz[..., 128:256] = 0
            kz[..., 128:256] = 0
            skipped = attn_mod.masked_attention(qz, kz, v, mask,
                                                cfg.attn_scale)
            torch.cuda.synchronize()
            out[f"skip_slice_1.{dn}"] = must_fail(
                lambda: check_close(skipped, want, TOL[("attention", dn)],
                                    " (a kernel skipping slice 1)"),
                f"d {d} attention without head_dim slice 1")
        if d > 1024:
            M = 64
            x = randn(M, d).to(dtype)
            w = (randn(d, d) / d ** 0.5).to(dtype)
            b, res = randn(d), randn(M, d)
            g = torch.from_numpy(rng.random(d).astype("float32")).to(
                cuda) + 0.5
            got, _ = bk.gemm_bias_epilogue(x, w, b, "residual_ln",
                                           residual=res, ln_g=g, ln_b=b)
            want, _ = bk.gemm_bias_epilogue_reference(
                x, w, b, "residual_ln", residual=res, ln_g=g, ln_b=b)
            check_close(got, want, TOL[("block", dn)], f" (d {d} LN rows)")
            z = x.float() @ w.float().t() + b + res
            head = z[:, :1024]
            mean = head.mean(-1, keepdim=True)
            var = head.var(-1, unbiased=False, keepdim=True)
            short = z.clone()
            short[:, :1024] = ((head - mean) / torch.sqrt(var + 1e-5)
                               * g[:1024] + b[:1024])
            short = short.to(dtype)
            out[f"ln_first_1024.{dn}"] = must_fail(
                lambda: check_close(short, want, TOL[("block", dn)],
                                    " (a LayerNorm over 1,024 columns)"),
                f"d {d} LayerNorm over the first 1,024 columns")
    return out


# the slice's main paths at full width (phase_wide_path): d_model 1,024
# with 4 heads (head_dim 256, two 128-column slices in every attention
# family), 4 layers, the flagship ModelConfig otherwise
WIDE_PATH = dict(d_model=1024, num_heads=4)
WIDE_PATH_LAYERS = 4
# its requests held against the CPU's plain path (every layer at d 1,024
# costs the CPU 16 times the flagship's: the 6,000- and 16,384-frame ones
# would take it minutes), and the batch of its pretrain step's card-vs-CPU
# check (the card's own step runs the pretrain batch, (256, 384); at batch
# 4 and 2 layers the CPU took 1.5 s)
WIDE_PATH_CPU_LENGTHS = (320, 512, 1200)
# the f32 scores of the WIDE_PATH_LAYERS-layer model, card against CPU: the
# f32 block bound once per layer (summation-order differences compound
# through the layers: the 1,200-frame request's relative RMS read 1.08e-5
# at 4 layers, past the one-block 1e-5)
WIDE_PATH_F32 = {k: v * WIDE_PATH_LAYERS
                 for k, v in TOL[("block", "float32")].items()}
WIDE_PATH_PT_CHECK_BATCH = 16


def serve_requests(model, cfg, videos, **kw) -> tuple:
    """``videos`` through one ``ScoringService(model, cfg, **kw)``, the long
    ones with given shot bounds: (results, launch counts, stats, wall s)."""
    from vidsum_tpu_torch.serve import ScoringService

    with ScoringService(model, cfg, max_batch=8, max_delay_ms=50.0,
                        **kw) as svc:
        reset_counters()
        t0 = time.monotonic()
        futs = [svc.submit(v, change_points=(shot_bounds(v.shape[0])
                                             if v.shape[0] >= 6000 else None))
                for v in videos]
        results = [f.result(timeout=900) for f in futs]
        wall = time.monotonic() - t0
        counts = read_counters()
        st = svc.stats()
    if st.completed != len(videos) or st.failed:
        raise AssertionError(f"serving stats: {st}")
    return results, counts, st, wall


def phase_wide_path(seed: int) -> dict:
    """The slice's main paths at WIDE_PATH (d_model 1,024, 4 heads: head_dim
    256), WIDE_PATH_LAYERS layers, where every attention kernel runs its
    head in two 128-column slices. (a) The 13 serving requests through
    ``ScoringService`` in bf16, in f32 and on the int8 wire
    (``attn_impl="int8_block"``; past the int8 block's envelope at this
    width the JAX predicates send every bucket to the flash route, as they
    send the bf16 and f32 ones): served == solo bit for bit; the requests of
    WIDE_PATH_CPU_LENGTHS against the CPU's plain path (bf16 sigmoid
    scores within WIDE_SCORES, f32 raw scores at the f32 block bound); the
    int8 wire's scores within INT8_VS_BF16 of the bf16 route's. (b) One
    finetune step on the JAX package's route for the shape (past the fused
    block's training envelope: the flash route, TPU kernels 5/6) card
    against CPU at the step bound. (c) One
    pretrain step at the pretrain batch (256, 384) on the card at full
    depth (finite losses, the flash kernels once a layer), and one at
    (WIDE_PATH_PT_CHECK_BATCH, 384) card against CPU under STEP_SPARE /
    STEP_CAP at dropout 0. (d) A 16,384-frame f32 request
    over the ring of a (1, 4) mesh of cuda:0 (kernel 15 over 4,096-row
    shards): served == ``make_seq_sharded_forward``, within 2e-4 of the
    single-device route. Returns the launches of every route the phase
    ran (the kernels line's ``launches_wide_path``)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig, pretrain_recipe
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.parallel import make_mesh, make_seq_sharded_forward
    from vidsum_tpu_torch.serve.transport import quantize_frames
    from vidsum_tpu_torch.train.steps import make_eval_forward

    t_phase = time.monotonic()
    rng = np.random.default_rng(seed + 40)
    launches, report, t_s = {}, {}, {}

    def add(counts):
        for r, n in counts.items():
            launches[r] = launches.get(r, 0) + n

    def cfg_of(dtype="float32", layers=WIDE_PATH_LAYERS):
        return ModelConfig(compute_dtype=dtype, num_layers=layers,
                           **WIDE_PATH)

    videos = [rng.random((n, cfg_of().in_features), dtype=np.float32)
              for n in SERVE_LENGTHS]
    lossless = None
    for tag, dtype, kw in (("bf16", "bfloat16", {}), ("f32", "float32", {}),
                           ("int8", "bfloat16",
                            dict(attn_impl="int8_block",
                                 wire_dtype="int8"))):
        t0 = time.monotonic()
        cfg = cfg_of(dtype)
        model = SimNet(cfg, generator=torch.Generator().manual_seed(
            seed + 41))
        results, counts, st, wall = serve_requests(model, cfg, videos, **kw)
        add(counts)
        if not (counts["_flash_attention"] + counts["_flash_attention_folded"]
                and counts["masked_attention"]):
            raise AssertionError(f"wide path {tag}: the attention kernels "
                                 f"never launched ({counts})")
        check_no_gemm_fallback(f"wide path {tag}")
        fwd = make_eval_forward(cfg, kw.get("attn_impl"))
        solos = []
        for v, r in zip(videos, results):
            n = v.shape[0]
            check_summary(r, n)
            x, mask = padded(cfg, v)
            if tag == "int8":
                q, sc = quantize_frames(x[0])
                x = (torch.from_numpy(q).cuda().float()
                     * torch.from_numpy(sc).cuda()[:, None])[None]
            solo = fwd(model, x, mask)[0, :n].float().cpu().numpy()
            if not np.array_equal(solo, r.scores):
                raise AssertionError(
                    f"wide path {tag}: served != solo for a {n}-frame "
                    f"request (max diff "
                    f"{float(np.abs(solo - r.scores).max())})")
            solos.append(solo)
        rep = dict(requests=len(videos), wall_s=wall,
                   latency_p50_s=st.latency_p50_s,
                   latency_p95_s=st.latency_p95_s, batches=st.batches,
                   frames_per_s=sum(SERVE_LENGTHS) / wall, launches={
                       r: n for r, n in counts.items() if n},
                   served_equals_solo=True)
        if tag == "bf16":
            lossless = solos
        if tag == "int8":
            d = np.concatenate([np.abs(a - b)
                                for a, b in zip(solos, lossless)])
            rep["vs_bf16"] = {"median": float(np.median(d)),
                              "max": float(d.max())}
            if not (rep["vs_bf16"]["median"] < INT8_VS_BF16["median"]
                    and rep["vs_bf16"]["max"] < INT8_VS_BF16["max"]):
                raise AssertionError(f"wide path int8 scores off the bf16 "
                                     f"route by {rep['vs_bf16']}")
        else:
            cpu = copy.deepcopy(model).to("cpu")
            vs_cpu = {}
            for n in WIDE_PATH_CPU_LENGTHS:
                v = videos[SERVE_LENGTHS.index(n)]
                x, mask = padded(cfg, v)
                with torch.inference_mode():
                    card, _ = model(torch.from_numpy(x).cuda(),
                                    torch.from_numpy(mask).cuda())
                    ref, _ = cpu(torch.from_numpy(x), torch.from_numpy(mask))
                card, ref = card[0, :n, 0].float().cpu(), ref[0, :n, 0].float()
                if tag == "f32":
                    vs_cpu[n] = check_close(card, ref, WIDE_PATH_F32,
                                            f" (wide path f32, {n} frames)")
                else:
                    vs_cpu[n] = diff_stats(torch.sigmoid(card),
                                           torch.sigmoid(ref))
                    if not (vs_cpu[n]["median"] <= WIDE_SCORES["median"]
                            and vs_cpu[n]["max"] <= WIDE_SCORES["max"]):
                        raise AssertionError(f"wide path bf16 scores, card "
                                             f"against CPU: {vs_cpu[n]}")
            rep["card_vs_cpu"] = vs_cpu
            del cpu
        report[f"serve_{tag}"] = rep
        t_s[f"serve_{tag}"] = time.monotonic() - t0
        del model
        torch.cuda.empty_cache()

    # (b) one finetune step, card against CPU (the flash route past the
    # fused block's training envelope at d 1,024)
    t0 = time.monotonic()
    tcfg = cfg_of()
    model = SimNet(tcfg, generator=torch.Generator().manual_seed(seed + 42))
    x = rng.normal(size=(2, 512, tcfg.in_features)).astype(np.float32)
    t = rng.random((2, 512)).astype(np.float32)
    mask = pad_mask(2, 512, rng, "cpu").numpy()
    reset_counters()
    report["finetune_step"] = flash_card_vs_cpu(
        model, tcfg, x, t, mask, rng, "wide path flash step",
        ("_fwd_kernel", "_bwd_kernel"))
    add(read_counters())
    t_s["finetune_step"] = time.monotonic() - t0

    # (c) pretrain: the card's step at the pretrain batch, full depth; the
    # card against the CPU at a cut batch and depth
    t0 = time.monotonic()
    recipe = pretrain_recipe()
    pcfg = recipe.pretrain
    proj = rng.normal(size=(tcfg.in_features, 512)).astype(np.float32)

    def clips(ns):
        feats = [rng.standard_normal((n, tcfg.in_features), dtype=np.float32)
                 for n in ns]
        return feats, [(f.mean(0) @ proj).astype(np.float32) for f in feats]

    lengths = [int(n) for n in rng.integers(300, 385, pcfg.batch_size)]
    reset_counters()
    report["pretrain_card"] = wide_pretrain_step(
        cfg_of(), pcfg, *clips(lengths))
    add(read_counters())
    # at dropout 0: past the fused block's envelope the step takes the
    # flash route, whose residual and MLP dropout draws from a generator
    # (other bits on the card than on the CPU), and the pretrain step takes
    # no masks
    reset_counters()
    report["pretrain_card_vs_cpu"] = pretrain_card_vs_cpu(
        dataclasses.replace(tcfg, dropout=0.0),
        dataclasses.replace(pcfg, batch_size=WIDE_PATH_PT_CHECK_BATCH),
        *clips(lengths[:WIDE_PATH_PT_CHECK_BATCH]), rng,
        "wide path pretrain step", ("_fwd_kernel", "_bwd_kernel"), mod=att)
    add(read_counters())
    t_s["pretrain"] = time.monotonic() - t0

    # (d) one long request over the ring of a (1, 4) mesh of cuda:0
    t0 = time.monotonic()
    cfg = cfg_of()
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed + 43))
    mesh = make_mesh((1, RING_SHARDS), "cuda:0")
    v = rng.random((16384, cfg.in_features), dtype=np.float32)
    results, counts, st, _ = serve_requests(model, cfg, [v], mesh=mesh,
                                            long_threshold=8192)
    add(counts)
    if not counts["_ring_block_step"] or st.long_requests != 1:
        raise AssertionError(f"wide path: the long request did not take the "
                             f"ring ({counts})")
    granule = 128 * RING_SHARDS
    xl, ml = padded(cfg, v, granule)
    seq = make_seq_sharded_forward(cfg, mesh)
    direct = torch.sigmoid(seq(model, xl, ml)[0][0, :16384, 0]).float(
    ).cpu().numpy()
    if not np.array_equal(direct, results[0].scores):
        raise AssertionError("wide path: ring served != direct")
    x, mask = padded(cfg, v)
    single = make_eval_forward(cfg)(model, x, mask)[0, :16384].float(
    ).cpu().numpy()
    ring_err = float(np.abs(results[0].scores - single).max())
    if not ring_err <= 2e-4:
        raise AssertionError(f"wide path: the ring off the single-device "
                             f"route by {ring_err} (bound 2e-4)")
    report["ring"] = dict(frames=16384, mesh=[1, RING_SHARDS],
                          launches={r: n for r, n in counts.items() if n},
                          served_equals_direct=True,
                          vs_single_device_max_abs=ring_err)
    t_s["ring"] = time.monotonic() - t0
    del model
    torch.cuda.empty_cache()
    emit("wide_path", d_model=WIDE_PATH["d_model"],
         num_heads=WIDE_PATH["num_heads"], head_dim=256, head_slices=2,
         num_layers=WIDE_PATH_LAYERS,
         reduced=[f"serving card_vs_cpu: the {WIDE_PATH_CPU_LENGTHS}-frame "
                  f"requests",
                  f"pretrain card_vs_cpu: batch {pcfg.batch_size} -> "
                  f"{WIDE_PATH_PT_CHECK_BATCH}, dropout {tcfg.dropout} -> "
                  f"0"],
         seconds=t_s, wall_s=time.monotonic() - t_phase, **report,
         launches=launches)
    return launches

def phase_wide_timings(dev: dict, seed: int) -> None:
    """One ``wide_kernel`` line per point: every attention row (TPU kernels
    3-8 and 15-17) at head_dim 256 with 4 heads (two 128-column slices,
    each slice's CTAs recomputing the scores over the whole head: the
    kernels do ``head_slices`` times the score products the bound counts
    once) at its table shape, and rows 1/2 and 9-12 at d_model 1,056 with 8
    heads (LayerNorm rows past 1,024 columns: the row kernels' looping
    variant; head_dim 132 runs padded to two slices), in bf16 and f32 where
    the row takes both: the CUDA-event ms, the plain version's ms, the
    bound from these inputs and the library call's ms (SDPA for 3-8,
    ``nn.TransformerEncoderLayer`` for 1/2 and 9-12, none for the ring)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import _cuda
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_train as bt

    peaks = peaks_for(dev["name"])
    cuda = torch.device("cuda")
    rng = np.random.default_rng(seed + 50)
    smi = dev["smi"]

    def randn(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, dtype)

    def point(row, shape, dn, fn, plain, lib, flops, nbytes, **kw):
        t_ops = flops / peaks[dn] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        # the plain versions once; the fold's over 64-key tiles at N 8,192
        # not at all (~4.5 s a call; rows 7/8's plain times stand in the
        # table at head_dim 64)
        ms = cuda_ms(fn, reps=5)
        emit("wide_kernel", row=row, shape=shape, dtype=dn, card=smi, ms=ms,
             plain_ms=None if plain is None else cuda_ms(plain, reps=1,
                                                         warmup=0),
             library_ms=None if lib is None else cuda_ms(lib, reps=5),
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             flops=flops, bytes=nbytes, **kw)

    # 3 and 4: (1, 4, 6,016, 256) single pass, (1, 4, 16,384, 256) folded
    H, Dh = 4, 256
    sl = _cuda.head_slices(Dh)
    scale = Dh ** -0.5
    for N, row, folded in ((6016, 3, False), (16384, 4, True)):
        mask = pad_mask(1, N, rng, cuda)
        valid = int((~mask).sum())
        keep = ~mask[:, None, None, :]
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v = (randn(1, H, N, Dh, dtype=dtype) for _ in range(3))
            with torch.inference_mode():
                point(row, [1, H, N, Dh], dn,
                      lambda: at.flash_attention(q, k, v, mask, scale),
                      (lambda: at.attention_folded_reference(
                          q, k, v, mask, scale, at.KEY_TILE)) if folded
                      else (lambda: at.attention_reference(q, k, v, mask,
                                                           scale)),
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, attn_mask=keep, scale=scale),
                      4 * H * Dh * N * valid,
                      4 * H * N * Dh * q.element_size() + N, head_slices=sl)
            del q, k, v
    # 5-8: (2, 4, 8,192, 256), valid 8,100 and 5,000, dropout 0.3
    B, N, rate = 2, 8192, 0.3
    mask = torch.ones(B, N, dtype=torch.bool, device=cuda)
    mask[0, :8100] = False
    mask[1, :5000] = False
    valid = 8100 + 5000
    dseed = int(rng.integers(0, 2**31 - 2))
    keep = ~mask[:, None, None, :]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q, k, v, do = (randn(B, H, N, Dh, dtype=dtype) for _ in range(4))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep,
                                               dropout_p=rate, scale=scale)
            o.backward(do)

        nbytes = 4 * B * H * N * Dh * q.element_size() + B * N
        for folded in (False, True):
            kb = att.KEY_TILE
            if folded:
                o, lse = att._fwd_kernel_folded(q, k, v, mask, dseed, rate,
                                                scale, kb)
                fwd = lambda: att._fwd_kernel_folded(  # noqa: E731
                    q, k, v, mask, dseed, rate, scale, kb)
                bwd = lambda: att._bwd_kernel_folded(  # noqa: E731
                    q, k, v, mask, dseed, lse, do, o, rate, scale, kb)
                pfwd = pbwd = None
            else:
                o, lse = att._fwd_kernel(q, k, v, mask, dseed, rate, scale)
                fwd = lambda: att._fwd_kernel(  # noqa: E731
                    q, k, v, mask, dseed, rate, scale)
                pfwd = lambda: att.attention_train_fwd_reference(  # noqa
                    q, k, v, mask, dseed, rate, scale, rows=512)
                bwd = lambda: att._bwd_kernel(  # noqa: E731
                    q, k, v, mask, dseed, lse, do, rate, scale)
                pbwd = lambda: att.attention_train_bwd_reference(  # noqa
                    q, k, v, mask, dseed, lse, do, rate, scale, rows=512)
            rows = (7, 8) if folded else (5, 6)
            point(rows[0], [B, H, N, Dh], dn, fwd, pfwd,
                  lambda: F.scaled_dot_product_attention(
                      q, k, v, attn_mask=keep, dropout_p=rate, scale=scale),
                  4 * H * Dh * N * valid, nbytes, head_slices=sl)
            point(rows[1], [B, H, N, Dh], dn, bwd, pbwd, sdpa_bwd,
                  8 * H * Dh * N * valid, 2 * nbytes, head_slices=sl)
        del q, k, v, do, qg, kg, vg, o, lse
        torch.cuda.empty_cache()
    # 15: (1, 4, 4,096, 256), K/V bf16; 16/17: (4, 4, 2,048, 256), rate 0.3
    ra = ring_module()
    for B, Nl, rows in ((1, 4096, (15,)), (4, 2048, (16, 17))):
        q32 = randn(B, H, Nl, Dh) * scale
        k, v, g = (randn(B, H, Nl, Dh) for _ in range(3))
        mask = torch.zeros(B, Nl, dtype=torch.bool, device=cuda)
        carry = ra._init_carries(q32)
        flops = 4 * B * H * Nl * Nl * Dh
        nbytes = 6 * B * H * Nl * Dh * 4 + B * Nl
        if rows == (15,):
            kd, vd = k.bfloat16(), v.bfloat16()
            point(15, [B, H, Nl, Dh], "float32",
                  lambda: ra._ring_block_step(q32, kd, vd, mask, *carry),
                  lambda: ra.ring_block_step_reference(q32, kd, vd, mask,
                                                       *carry),
                  None, flops, nbytes, head_slices=sl, kv="bfloat16")
        else:
            info = (int(rng.integers(0, 2**31 - 2)), 0, Nl, 2 * Nl)
            point(16, [B, H, Nl, Dh], "float32",
                  lambda: ra._ring_train_step(q32, k, v, mask, info, *carry,
                                              0.3),
                  lambda: ra.ring_train_step_reference(q32, k, v, mask, info,
                                                       *carry, 0.3),
                  None, flops, nbytes, head_slices=sl)
            o, m, l = ra.ring_train_step_reference(q32, k, v, mask, info,
                                                   *carry, 0.3)
            dr = (g * o / l).sum(-1, keepdim=True)
            acc = tuple(torch.zeros_like(t) for t in (q32, k, v))
            args = (q32, k, v, g, dr, m, l, mask, info, *acc, 0.3)
            point(17, [B, H, Nl, Dh], "float32",
                  lambda: ra._ring_train_step_bwd(*args),
                  lambda: ra.ring_train_step_bwd_reference(*args),
                  None, 10 * B * H * Nl * Nl * Dh, 2 * nbytes,
                  head_slices=sl)
        del q32, k, v, g
        torch.cuda.empty_cache()
    # 1/2 and 9-12 at d 1,056 with 8 heads
    cfg = ModelConfig(num_layers=1, d_model=1056, num_heads=8)
    d, H = cfg.d_model, cfg.num_heads
    block = SimNet(cfg, device=cuda, generator=torch.Generator().manual_seed(
        seed + 51)).encoder.module_list[0]
    with torch.no_grad():
        tw = bt.train_weights(block)
    ln = _cuda.ln_rows_path(d, False)
    for B, N, route in ((32, 512, "_fused_block"),
                        (8, 256, "_fused_block_grouped")):
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x = randn(B, N, d, dtype=dtype)
            w = bk.block_weights(block, dtype)
            layer = library_block(block, d, H, dtype)
            fn = getattr(bk, route)
            itm = x.element_size()
            with torch.inference_mode():
                point(1 if route == "_fused_block" else 2, [B, N, d], dn,
                      lambda: fn(w, x, mask, H, cfg.attn_scale),
                      lambda: bk.encoder_block_reference(w, x, mask, H,
                                                         cfg.attn_scale),
                      lambda: layer(x, src_key_padding_mask=mask),
                      B * N * 24 * d * d + 4 * N * valid * d,
                      2 * B * N * d * itm + 12 * d * d * itm + 13 * d * 4
                      + B * N, ln_rows=ln)
        x, do = randn(B, N, d), randn(B, N, d)
        flops = B * N * 24 * d * d + 4 * N * valid * d
        nbytes = 2 * B * N * d * 4 + 12 * d * d * 4 + 13 * d * 4 + B * N
        grouped = route == "_fused_block_grouped"
        fwd = bt._fwd_kernel_grouped if grouped else bt._fwd_kernel
        bwd = bt._bwd_kernel_grouped if grouped else bt._bwd_kernel
        layer = library_block(block, d, H, torch.float32, dropout=0.3)
        xg = x.detach().clone().requires_grad_()

        def lib_bwd():
            layer(xg, src_key_padding_mask=mask).backward(do)

        point(11 if grouped else 9, [B, N, d], "float32",
              lambda: fwd(x, mask, 7, tw, H, cfg.attn_scale, 0.3),
              lambda: bt.block_reference_with_masks(x, tw, mask, 7, H,
                                                    cfg.attn_scale, 0.3),
              lambda: layer(x, src_key_padding_mask=mask), flops, nbytes,
              ln_rows="wide")
        point(12 if grouped else 10, [B, N, d], "float32",
              lambda: bwd(x, mask, 7, tw, do, H, cfg.attn_scale, 0.3),
              lambda: bt.block_reference_backward(x, tw, mask, 7, do, H,
                                                  cfg.attn_scale, 0.3),
              lib_bwd, 2 * flops, 2 * nbytes, ln_rows="wide")
        del x, do, xg
        torch.cuda.empty_cache()


def wide_pretrain_step(cfg, pcfg, feats, reps) -> dict:
    """One pretrain step (``make_pretrain_step``, frozen
    ``video_transform``) on the card at ``cfg``'s depth and the batch given:
    finite losses, each training attention route once a layer, the step's
    wall and device time."""
    import math

    import torch

    from vidsum_tpu_torch.data.collate import pad_batch_pretrain
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.train.schedule import reference_pretrain_schedule
    from vidsum_tpu_torch.train.steps import (
        make_optimizer, make_pretrain_step,
    )

    x, v, m = pad_batch_pretrain(feats, reps)
    model = PretrainModel(cfg, pcfg, device="cuda",
                          generator=torch.Generator().manual_seed(pcfg.seed))
    schedule = reference_pretrain_schedule(
        pcfg.lr, max(pcfg.scheduler_samples // pcfg.batch_size, 1),
        pcfg.warmup_epochs, pcfg.epochs)
    opt = make_optimizer([("encoder." + n, p) for n, p in
                          model.encoder.named_parameters()], pcfg.lr,
                         pcfg.weight_decay)
    step = make_pretrain_step(cfg, pcfg, schedule, device="cuda")
    before = {r: getattr(att, r).launches for r in ("_fwd_kernel",
                                                    "_bwd_kernel")}
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.monotonic()
    start.record()
    out = step(model, opt, x, v, m, torch.Generator().manual_seed(1))
    end.record()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(t) for t in out.cpu()]
    moved = {r: getattr(att, r).launches - b for r, b in before.items()}
    if not all(math.isfinite(v) for v in losses) or set(moved.values()) != {
            cfg.num_layers}:
        raise AssertionError(f"wide pretrain step: losses {losses}, "
                             f"launches {moved}")
    del model, opt
    torch.cuda.empty_cache()
    return dict(B=int(x.shape[0]), N=int(x.shape[1]), layers=cfg.num_layers,
                losses=losses, launches=moved, wall_s=wall,
                device_ms=start.elapsed_time(end))


def synthetic_videos(rng, lengths, in_features: int) -> list:
    """In-memory items in the schema of ``vidsum_tpu/data/synthetic.py``:
    (features, gtscore, UserSummaries), gtscore a linear probe of the
    features through a sigmoid, 15 frames per pick, 4-8 shots, 5 users."""
    import numpy as np

    from vidsum_tpu_torch.data.datasets import UserSummaries

    probe = (rng.normal(size=(in_features,)) / np.sqrt(in_features)
             ).astype(np.float32)
    items = []
    for vi, n in enumerate(lengths):
        picks = np.arange(n) * 15
        n_frames = int(picks[-1] + rng.integers(1, 16))
        feats = rng.normal(size=(n, in_features)).astype(np.float32)
        gt = (1 / (1 + np.exp(-(feats @ probe)))).astype(np.float32)
        n_shots = int(rng.integers(4, 9))
        cuts = np.sort(rng.choice(np.arange(1, n_frames), size=n_shots - 1,
                                  replace=False))
        bounds = np.concatenate([[0], cuts, [n_frames]])
        cps = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)
        frame = np.repeat(gt, 15)[:n_frames]
        user_scores = np.clip(frame[None] + 0.1 * rng.normal(
            size=(5, n_frames)), 0, None).astype(np.float32)
        base = (frame >= np.quantile(frame, 0.85)).astype(np.int8)
        user_summary = np.stack([base ^ (rng.random(n_frames) < 0.05)
                                 .astype(np.int8) for _ in range(5)])
        items.append((feats, gt, UserSummaries(
            user_summary=user_summary, user_scores=user_scores,
            change_points=cps, n_frames=n_frames, picks=picks,
            name=f"video_{vi}")))
    return items


TRAIN_ROUTES = ("_fwd_kernel", "_bwd_kernel", "_fwd_kernel_grouped",
                "_bwd_kernel_grouped")
# recipe epochs over each of the short and long sets: 2 steps each, so the
# step times are medians of 20
TRAIN_EPOCHS = 10


def phase_train(seed: int) -> dict:
    import copy
    import math

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import finetune_recipe
    from vidsum_tpu_torch.data.collate import make_batches, pad_batch
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.steps import (
        make_eval_forward, make_finetune_step, make_optimizer,
    )

    conf = finetune_recipe()
    cfg, tc = conf.model, conf.train
    rng = np.random.default_rng(seed + 4)
    short = synthetic_videos(rng, rng.integers(100, 381, 8), cfg.in_features)
    long_ = synthetic_videos(rng, rng.integers(520, 1101, 8),
                             cfg.in_features)
    val = synthetic_videos(rng, rng.integers(100, 1101, 4), cfg.in_features)
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed))
    step = make_finetune_step(cfg, tc.attn_impl)
    if step.attn_impl != "fused_block":
        raise AssertionError(f"the recipe trains on {step.attn_impl!r}")

    # one step on the first long batch, on the card and on the CPU's plain
    # path with the same per-layer dropout seeds
    first = next(make_batches(len(long_), tc.batch_size, shuffle=True,
                              rng=np.random.default_rng((tc.seed, 0, 1))))
    xb, tb, mb = pad_batch([long_[i][0] for i in first],
                           [long_[i][1] for i in first])
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, cfg.num_layers)]
    results = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        loss = make_finetune_step(cfg, "fused_block", device=dev)(
            m, make_optimizer(m, tc.lr, tc.weight_decay), xb, tb, mb, None,
            block_seeds=seeds)
        results.append((float(loss), {k: p.grad.detach().float().cpu()
                                      for k, p in m.named_parameters()}))
    card_vs_cpu = compare_steps(results, "fused_block step")
    # (a) the flash route on the same batch (N = 1,152: the single-pass
    # training attention, TPU kernels 5/6), card against CPU
    flash_vs_cpu = flash_card_vs_cpu(model, cfg, xb, tb, mb, rng, "flash "
                                     "route, first long batch",
                                     ("_fwd_kernel", "_bwd_kernel"))

    optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
    times = {"short": [], "long": []}
    losses = []
    epoch_losses = {"short": [], "long": []}

    def timed(kind):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*args)
            end.record()
            times[kind].append((start, end))
            losses.append(loss)
            return loss
        return run

    fwd = make_eval_forward(cfg)
    reset_counters()
    t0 = time.monotonic()
    # epoch e trains on the short set with the streams of (split 0, epoch
    # 2e), then on the long set with those of (0, 2e + 1): 2 steps each
    for epoch in range(TRAIN_EPOCHS):
        for i, (kind, items) in enumerate((("short", short),
                                           ("long", long_))):
            rng_np, gen = ft.epoch_streams(tc.seed, 0, 2 * epoch + i)
            epoch_losses[kind].append(ft._train_epoch(
                timed(kind), model, optimizer, items, conf, rng_np, gen))
    val_loss, f, tau, rho = ft._val_epoch(fwd, model, val, conf)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counters()
    missing = [r for r in TRAIN_ROUTES if counts[r] == 0]
    if missing:
        raise AssertionError(f"training routes never launched: {missing} "
                             f"(counters {counts})")
    step_losses = [float(x) for x in losses]
    if not all(math.isfinite(v) for v in step_losses + [val_loss]):
        raise AssertionError(f"non-finite losses: {step_losses}, {val_loss}")
    if not (0.0 <= f <= 100.0 and math.isfinite(tau)
            and math.isfinite(rho)):
        raise AssertionError(f"val metrics F {f}, tau {tau}, rho {rho}")
    step_ms = {k: spread([s.elapsed_time(e) for s, e in v])
               for k, v in times.items()}

    # a step at the flagship batch shape (32, 512), and profiles of it and
    # of a step on the first long batch
    x32 = rng.normal(size=(32, 512, cfg.in_features)).astype(np.float32)
    t32 = rng.random((32, 512)).astype(np.float32)
    m32 = np.zeros((32, 512), bool)
    xt, tt, mt = (torch.from_numpy(a).cuda() for a in (x32, t32, m32))
    step_ms["flagship_32x512"] = spread(cuda_times(
        lambda: step(model, optimizer, xt, tt, mt, gen), reps=20))
    xl, tl, ml = (torch.from_numpy(a).cuda() for a in (xb, tb, mb))
    step_profile = {
        "recipe_long_batch": device_profile(
            lambda: step(model, optimizer, xl, tl, ml, gen), reps=3),
        "flagship_32x512": device_profile(
            lambda: step(model, optimizer, xt, tt, mt, gen), reps=3)}
    flash_f32 = train_flash_f32(model, conf, long_, (xl, tl, ml), gen)
    counts.update(flash_f32.pop("launches_f32"))
    emit("train", lengths_short=[int(it[0].shape[0]) for it in short],
         lengths_long=[int(it[0].shape[0]) for it in long_],
         card_vs_cpu=card_vs_cpu, flash_card_vs_cpu=flash_vs_cpu,
         epoch_loss_short=epoch_losses["short"],
         epoch_loss_long=epoch_losses["long"],
         step_losses=step_losses, val_loss=val_loss, fscore=f,
         kendall_tau=tau, spearman_rho=rho, wall_s=wall, step_ms=step_ms,
         step_profile=step_profile, flash_f32=flash_f32,
         launches=counts,
         launches_per_step={r: counts[r] / len(step_losses)
                            for r in TRAIN_ROUTES})
    return counts


# recipe epochs of the f32 flash run over the long set (8 videos at batch
# 4: 2 steps each)
FLASH_EPOCHS = 3


def train_flash_f32(model, conf, items, batch, gen) -> dict:
    """(d) The f32 single-pass training attention (TPU kernels 5/6, the FMA
    family) on a main path: recipe epochs on the ``"flash"`` route (what
    ``attn_impl="flash"`` trains through) over the long set, buckets up to
    1,152, with the counters zeroed just before. Each step launches both
    single-pass kernels once per layer, with D from the forward's o (no
    first pass), and no block or folded kernel. Returns the step ms, a
    profile of one step on ``batch`` and the launches under
    ``<route>.f32``."""
    import copy
    import math

    import torch

    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.steps import (
        make_finetune_step, make_optimizer,
    )

    cfg, tc = conf.model, conf.train
    model = copy.deepcopy(model)
    optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
    step = make_finetune_step(cfg, "flash")
    times, losses = [], []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(*args)
        end.record()
        times.append((start, end))
        losses.append(loss)
        return loss

    reset_counters()
    passes = at._bwd_kernel.d_pass_launches
    for epoch in range(FLASH_EPOCHS):
        ft._train_epoch(timed, model, optimizer, items, conf,
                        *ft.epoch_streams(tc.seed, 0, epoch))
    torch.cuda.synchronize()
    counts = read_counters()
    single = [attn_train_name(r) for r in ("_fwd_kernel", "_bwd_kernel")]
    others = [r for r in TRAIN_ROUTES if counts[r]] + [
        attn_train_name(r) for r in ("_fwd_kernel_folded",
                                     "_bwd_kernel_folded")
        if counts[attn_train_name(r)]]
    if [counts[n] for n in single] != [cfg.num_layers * len(losses)] * 2 \
            or others or at._bwd_kernel.d_pass_launches != passes:
        n_pass = at._bwd_kernel.d_pass_launches - passes
        raise AssertionError(f"f32 flash epochs: launches {counts}, D "
                             f"passes {n_pass}")
    step_losses = [float(x) for x in losses]
    if not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"non-finite losses: {step_losses}")
    return dict(
        steps=len(losses), step_losses=step_losses,
        step_ms=spread([s.elapsed_time(e) for s, e in times]),
        step_profile=device_profile(
            lambda: step(model, optimizer, *batch, gen), reps=3),
        launches_f32={n + ".f32": counts[n] for n in single})


# recipe epochs over the long-video set per dtype: 8 videos at batch 4, 2
# steps each, so the step times are medians of 10
LONG_EPOCHS = 5


def hold_folded_at_bucket(cfg, batch_shapes, lengths, rng) -> dict:
    """The bf16 fold's kernels (TPU kernels 7/8) at the largest bucket a
    long-video run gave them: (B, H, N, Dh) of that batch, valid lengths
    the B longest videos', the recipe's dropout; held against the plain
    fold over ``KEY_TILE`` by ``hold_attn_train``."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.data.collate import bucket_length
    from vidsum_tpu_torch.ops import attention_train as at

    B, N = max(batch_shapes, key=lambda s: s[1])
    valid = sorted(int(n) for n in lengths)[-B:]
    if bucket_length(valid[-1]) != N:
        raise AssertionError(f"the longest video ({valid[-1]} frames) does "
                             f"not bucket to the largest batch's N {N}")
    H, Dh = cfg.num_heads, cfg.head_dim
    cuda = torch.device("cuda")
    mask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    for b, n in enumerate(valid):
        mask[b, :n] = False
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, N, Dh)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(4))
    dseed = int(rng.integers(0, 2**31 - 2))
    held = hold_attn_train(True, q, k, v, do, mask, dseed, cfg.dropout,
                           cfg.attn_scale, at._pick_key_block(N))
    out = dict(B=B, H=H, N=N, Dh=Dh, valid=valid, rate=cfg.dropout,
               o_err=held["o_err"], lse_err=held["lse_err"],
               grad_err={n: list(e) for n, e in held["grad_err"].items()},
               o_tolerance=held["o_tol"], grad_tolerance=held["grad_tol"],
               seed_plus_one_rel_rms=list(held["fault"]), deterministic=True)
    del held, q, k, v, do
    torch.cuda.empty_cache()
    return out


# the fold loop's protocol (phase 7b): 2 folds of 16 train / 4 val videos
FT_FOLDS = 2
FT_EPOCHS = 3
FT_KEY = "eccv16_dataset_tvsum_google_pool5.h5/"


def finetune_videos(rng, in_features: int) -> dict:
    """20 videos named video_1 ... video_20 in the DSNet schema
    (``synthetic_videos``): 12 of 100-380 frames and 8 of 520-1,100 in a
    shuffled order, so that batches of 4 fall on both fused-block training
    routes (grouped below a 512 bucket, per-element from it)."""
    import dataclasses

    import numpy as np

    lengths = np.concatenate([rng.integers(100, 381, 12),
                              rng.integers(520, 1101, 8)])
    rng.shuffle(lengths)
    return {f"video_{i + 1}": (f, t, dataclasses.replace(
        u, name=f"video_{i + 1}"))
        for i, (f, t, u) in enumerate(synthetic_videos(rng, lengths,
                                                       in_features))}


def memory_fold_datasets(videos: dict):
    """A stand-in for ``train.finetune.fold_datasets`` serving ``videos``
    (the card's machine has no h5py): a fold's train items ``(features,
    gtscore)`` past ``min_train_frames`` and val items ``(features, gtscore,
    UserSummaries)``, by the split's keys as ``TSDataset`` reads them."""
    from vidsum_tpu_torch.data.splits import split_keys_to_names

    def fold_datasets(cfg, split):
        train = [videos[n][:2]
                 for n in split_keys_to_names(split["train_keys"])
                 if videos[n][0].shape[0] > cfg.data.min_train_frames]
        val = [videos[n] for n in split_keys_to_names(split["test_keys"])]
        return train, val

    return fold_datasets


class StageClock:
    """Host clocks on a loop's stages, wrapped in place (module attributes)
    while the ``with`` block runs: ``targets`` are (module, name, stage,
    replacement or None); each call appends (stage, start, end) to
    ``events``."""

    def __init__(self, targets) -> None:
        self.events, self._saved, self._targets = [], [], targets

    def _timed(self, stage, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.events.append((stage, t0, time.perf_counter()))
        return run

    def _patch(self, mod, name, fn) -> None:
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __enter__(self):
        for mod, name, stage, fn in self._targets:
            self._patch(mod, name, self._timed(stage,
                                               fn or getattr(mod, name)))
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


class FoldLoopClock(StageClock):
    """Host clocks on the stages of ``train.finetune.finetune``: the fold's
    data (``fold_datasets``), each epoch's ``_train_epoch`` and
    ``_val_epoch`` (both end on a host fetch, so they include their device
    time) and, inside them, the batches' collation (``pad_batch``) and the
    val pass's summaries and metrics on the host (``eval_metrics``), the
    checkpoint copy to the host on the caller thread (``host_snapshot``)
    and each checkpoint write on the checkpointer's thread
    (``train.checkpoint._write``). Also keeps every model the loop trains
    (by ``make_optimizer``)."""

    def __init__(self, fold_datasets) -> None:
        from vidsum_tpu_torch.train import checkpoint as ck
        from vidsum_tpu_torch.train import finetune as ft

        super().__init__([(ft, "fold_datasets", "fold", fold_datasets),
                          (ft, "_train_epoch", "train", None),
                          (ft, "_val_epoch", "val", None),
                          (ft, "pad_batch", "collate", None),
                          (ft, "eval_metrics", "metrics", None),
                          (ft, "host_snapshot", "fetch", None),
                          (ck, "_write", "write", None)])
        self.models, self._ft = [], ft

    def __enter__(self) -> "FoldLoopClock":
        super().__enter__()
        make_optimizer = self._ft.make_optimizer

        def recording(model, *args):
            self.models.append(model)
            return make_optimizer(model, *args)

        self._patch(self._ft, "make_optimizer", recording)
        return self

    def summary(self) -> dict:
        """Per epoch: the wall from its train pass to the end of its last
        checkpoint copy, and the train / val / copy seconds in it (the rest,
        ``other_s``, is metric logging and queueing the writes), with the
        collation seconds inside train and val and the host metrics' inside
        val; per fold: the wall from reading its data (the summary export
        included) to its last epoch's end; the medians of the four shares;
        the writes' seconds."""
        import statistics

        epochs, folds = [], []
        for stage, t0, t1 in sorted((e for e in self.events
                                     if e[0] != "write"),
                                    key=lambda e: e[1]):
            if stage == "fold":
                folds.append([t0, t1])
                continue
            if stage == "train":
                epochs.append({"start": t0, "end": t1, "train_s": 0.0,
                               "val_s": 0.0, "fetch_s": 0.0,
                               "collate_s": 0.0, "metrics_s": 0.0})
            epochs[-1][stage + "_s"] += t1 - t0
            epochs[-1]["end"] = max(epochs[-1]["end"], t1)
            if folds:
                folds[-1][1] = max(folds[-1][1], epochs[-1]["end"])
        for e in epochs:
            e["wall_s"] = e.pop("end") - e.pop("start")
            e["other_s"] = e["wall_s"] - e["train_s"] - e["val_s"] - e[
                "fetch_s"]
        shares = {k: statistics.median(e[k + "_s"] / e["wall_s"]
                                       for e in epochs)
                  for k in ("train", "val", "fetch", "other")}
        return {"epochs": epochs, "fold_wall_s": [b - a for a, b in folds],
                "median_share": shares,
                "write_s": [t1 - t0 for s, t0, t1 in self.events
                            if s == "write"]}


def trace_kernel_names(trace_dir: str) -> dict:
    """Whether the Chrome trace in ``trace_dir`` names the training block's
    GEMM and its f32 FMA attention kernels."""
    import re

    with open(os.path.join(trace_dir, "trace.json")) as f:
        text = f.read()
    return {"bt_gemm_kernel": "bt_gemm_kernel" in text,
            "fma_attention": sorted(set(re.findall(
                r"fma_(?:fwd|dq|dkdv)_kernel", text)))}


def phase_finetune(dev: dict, seed: int) -> None:
    """7b. The finetune protocol through its entry points at the recipe's
    width (module docstring, phase 7b)."""
    import contextlib
    import dataclasses
    import io
    import math
    import tempfile

    import numpy as np
    import torch

    from vidsum_tpu_torch.cli import serve as serve_cli
    from vidsum_tpu_torch.cli import train as train_cli
    from vidsum_tpu_torch.config import ModelConfig, finetune_recipe
    from vidsum_tpu_torch.models.simnet import count_params
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.checkpoint import load_checkpoint

    conf = finetune_recipe()
    rng = np.random.default_rng(seed + 14)
    videos = finetune_videos(rng, conf.model.in_features)
    names = list(videos)
    order = rng.permutation(len(names))
    folds = []
    for k in range(FT_FOLDS):
        test = [names[i] for i in order[4 * k:4 * k + 4]]
        folds.append({"train_keys": [FT_KEY + n for n in names
                                     if n not in test],
                      "test_keys": [FT_KEY + n for n in test]})
    fold_datasets = memory_fold_datasets(videos)

    with tempfile.TemporaryDirectory() as tmp:
        # 1. the protocol through the CLI (the recipe is its defaults)
        wd, data = os.path.join(tmp, "run"), os.path.join(tmp, "data")
        os.makedirs(data)
        split_path = os.path.join(tmp, "splits.json")
        with open(split_path, "w") as f:
            json.dump(folds, f)
        argv = ["--data", data, "--split_path", split_path, "--max_epoch",
                str(FT_EPOCHS), "--workdir", wd,
                "--metrics", os.path.join(wd, "metrics.jsonl"),
                "--profile_dir", os.path.join(tmp, "trace")]
        out = io.StringIO()
        reset_counters()
        t0 = time.monotonic()
        with FoldLoopClock(fold_datasets) as clock, \
                contextlib.redirect_stdout(out):
            train_cli.main(argv)
        torch.cuda.synchronize()
        cli_wall = time.monotonic() - t0
        counts = read_counters()
        printed = json.loads(out.getvalue().strip().splitlines()[-1])
        if not (0.0 <= printed["fscore"] <= 100.0
                and math.isfinite(printed["kendall_tau"])
                and math.isfinite(printed["spearman_rho"])):
            raise AssertionError(f"cli.train printed {printed}")
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if ([(r.get("split"), r.get("epoch")) for r in records]
                != [(s, e) for s in range(FT_FOLDS)
                    for e in range(FT_EPOCHS)] + [(None, None)]):
            raise AssertionError(f"metric records: {records}")
        files = {n: os.path.exists(os.path.join(wd, n)) for n in (
            "model_mae.ckpt", "train_state.ckpt", "summary.json")}
        if not all(files.values()):
            raise AssertionError(f"files written: {files}")
        traced = trace_kernel_names(os.path.join(tmp, "trace"))
        if not (traced["bt_gemm_kernel"] and traced["fma_attention"]):
            raise AssertionError(f"the trace names {traced}")
        missing = [r for r in TRAIN_ROUTES if counts[r] == 0]
        serving = {r: counts[r] for r in SERVE_ROUTES}
        attn_train = {attn_train_name(r): counts[attn_train_name(r)]
                      for r in ATTN_TRAIN_ROUTES}
        if missing or not any(serving.values()) or any(attn_train.values()):
            raise AssertionError(
                f"training routes never launched: {missing}; serving "
                f"routes {serving}; training attention {attn_train} (must "
                f"stay 0: every bucket fits the fused block)")
        check_no_gemm_fallback("the finetune protocol")
        timeline = clock.summary()

        # 1b. the same CLI run with --eval_impl device: the same training,
        # the val pass's summaries on the card; every record's F, tau and
        # rho (and the losses) must be the host run's bit for bit
        wd_dev = os.path.join(tmp, "run_device_eval")
        argv_dev = ["--data", data, "--split_path", split_path,
                    "--max_epoch", str(FT_EPOCHS), "--workdir", wd_dev,
                    "--metrics", os.path.join(wd_dev, "metrics.jsonl"),
                    "--eval_impl", "device"]
        out_dev = io.StringIO()
        with FoldLoopClock(fold_datasets) as clock_dev, \
                contextlib.redirect_stdout(out_dev):
            train_cli.main(argv_dev)
        torch.cuda.synchronize()
        printed_dev = json.loads(out_dev.getvalue().strip().splitlines()[-1])
        with open(os.path.join(wd_dev, "metrics.jsonl")) as f:
            records_dev = [json.loads(line) for line in f]
        strip = [[{k: v for k, v in r.items() if k != "ts"} for r in rs]
                 for rs in (records, records_dev)]
        model_equal = all(
            torch.equal(v, load_checkpoint(os.path.join(
                wd_dev, "model_mae.ckpt"))[0][k])
            for k, v in load_checkpoint(os.path.join(
                wd, "model_mae.ckpt"))[0].items())
        if strip[0] != strip[1] or printed_dev != printed or not model_equal:
            raise AssertionError(
                f"--eval_impl device: records {strip[1]} against the host "
                f"run's {strip[0]}; printed {printed_dev} / {printed}; "
                f"trained models equal: {model_equal}")
        timeline_dev = clock_dev.summary()
        eval_routes = {
            impl: {"val_s": [round(e["val_s"], 6) for e in t["epochs"]],
                   "metrics_s": [round(e["metrics_s"], 6)
                                 for e in t["epochs"]]}
            for impl, t in (("host", timeline), ("device", timeline_dev))}

        # 2. exact resume: fold 0 three epochs straight, and two + one
        one = folds[:1]
        tc = dataclasses.replace(conf.train, use_pretrained=False)
        runs = {"straight": (FT_EPOCHS,), "resumed": (FT_EPOCHS - 1,
                                                      FT_EPOCHS)}
        resume_walls = {}
        with FoldLoopClock(fold_datasets) as clock2:
            for run, epochs in runs.items():
                rd = os.path.join(tmp, run)
                t0 = time.monotonic()
                for i, n in enumerate(epochs):
                    ft.finetune(dataclasses.replace(conf, train=dataclasses
                                                    .replace(tc, max_epoch=n)),
                                one, workdir=rd, export_summary=False,
                                resume=i > 0,
                                metrics_path=os.path.join(rd, "m.jsonl"))
                resume_walls[run] = time.monotonic() - t0
        trees = {}
        for run in runs:
            rd = os.path.join(tmp, run)
            trees[run] = {n: load_checkpoint(os.path.join(rd, n))[0]
                          for n in ("model_mae.ckpt", "train_state.ckpt")}
            with open(os.path.join(rd, "m.jsonl")) as f:
                trees[run]["epoch_2"] = [
                    {k: v for k, v in r.items() if k != "ts"}
                    for r in map(json.loads, f) if r.get("epoch") == 2]
        a, b = trees["straight"], trees["resumed"]
        bad = [k for k, v in a["model_mae.ckpt"].items()
               if not torch.equal(v, b["model_mae.ckpt"][k])]
        sa, sb = (t["train_state.ckpt"]["opt_state"]["state"]
                  for t in (a, b))
        bad += [f"adam {i}.{k}" for i in sa for k in sa[i]
                if not torch.equal(sa[i][k], sb[i][k])]
        if bad or a["epoch_2"] != b["epoch_2"] or len(a["epoch_2"]) != 1:
            raise AssertionError(
                f"resume is not exact: tensors {bad[:8]}; epoch-2 records "
                f"{a['epoch_2']} / {b['epoch_2']}")

        # 3. serve the CLI run's checkpoint: cli.serve's model and service
        args = serve_cli.build_parser().parse_args(
            ["--ckpt", os.path.join(wd, "model_mae.ckpt")])
        scfg = ModelConfig(d_model=args.d_model, num_heads=args.num_heads,
                           num_layers=args.num_layers)
        served = []
        val = [videos[n] for n in
               (k.split("/")[-1] for k in folds[-1]["test_keys"])]
        for model in (clock.models[-1], serve_cli.load_model(args, scfg)):
            with serve_cli.make_service(args, scfg, model) as svc:
                futs = [svc.submit(f, picks=u.picks, n_frames=u.n_frames,
                                   change_points=u.change_points)
                        for f, _, u in val]
                served.append([fu.result(timeout=300) for fu in futs])
        for r_mem, r_ckpt in zip(*served):
            if not (np.array_equal(r_mem.scores, r_ckpt.scores)
                    and np.array_equal(r_mem.summary, r_ckpt.summary)):
                raise AssertionError("the --ckpt service disagrees with the "
                                     "trained model's")

    epochs = [{k: round(v, 6) for k, v in e.items()}
              for e in timeline["epochs"]]
    emit("finetune", card=dev["smi"],
         data=("numpy-made videos in the DSNet schema (synthetic_videos), "
               "served by a stand-in for train.finetune.fold_datasets (no "
               "h5 file is read)"),
         lengths={n: int(v[0].shape[0]) for n, v in videos.items()},
         folds=[[k.split("/")[-1] for k in f["test_keys"]] for f in folds],
         cli_argv=argv[2:], cli_wall_s=cli_wall, printed=printed,
         metric_records=len(records), files=files, trace=traced,
         launches=counts, epochs=epochs, fold_wall_s=timeline["fold_wall_s"],
         median_share=timeline["median_share"],
         ckpt_fetch_s=[e["fetch_s"] for e in epochs],
         ckpt_write_s=timeline["write_s"],
         resume_epochs=[{k: round(v, 6) for k, v in e.items()}
                        for e in clock2.summary()["epochs"]],
         resume_wall_s=resume_walls,
         count_params=count_params(clock.models[-1]),
         resume_bit_equal=True, resume_epoch_2_records_equal=True,
         ckpt_service_bit_equal=True, ckpt_service_picks_equal=True,
         eval_impl_device={"records_equal_to_host": True,
                           "trained_models_equal": True,
                           "printed": printed_dev, "by_route": eval_routes})


# clips of the pretrain phase's numpy-made tree (60-380 frames each: two
# steps of batch 256 an epoch, buckets <= 384, the grouped block training
# routes) and its epochs (the run_pretrain.sh recipe's 200 cut to 2)
PT_CLIPS = 520
PT_EPOCHS = 2


def pretrain_tree(root: str, rng, n_clips: int, in_features: int) -> list:
    """Write the pretraining data as ``vidsum_tpu_torch/data/synthetic.
    make_synthetic_pretrain_tree`` does (``frames/*.npy`` features,
    ``video/*.npy`` 512-d reps: the features' mean through a fixed random
    projection), with clips of 60-380 frames. Returns the lengths."""
    import numpy as np

    os.makedirs(os.path.join(root, "frames"))
    os.makedirs(os.path.join(root, "video"))
    proj = rng.normal(size=(in_features, 512)).astype(np.float32)
    lengths = [int(n) for n in rng.integers(60, 381, n_clips)]
    for i, n in enumerate(lengths):
        feats = rng.standard_normal((n, in_features), dtype=np.float32)
        np.save(os.path.join(root, "frames", f"clip_{i:04d}.npy"), feats)
        np.save(os.path.join(root, "video", f"clip_{i:04d}.npy"),
                (feats.mean(0) @ proj).astype(np.float32))
    return lengths


class PretrainClock(StageClock):
    """Host clocks on ``train.pretraining.pretrain``'s stages: the dataset
    load (``PreTrainDataset``), each epoch (from one ``epoch_streams`` call
    to the next, or to the run's end), and in it the batches' collation
    (``pad_batch_pretrain``), the step calls (their host time: a step
    returns unsynchronised) and the checkpoint copy to the host
    (``host_snapshot``); the writes on the checkpointer's thread
    (``train.checkpoint._write``). Every step is also timed by CUDA events
    and its four losses kept."""

    def __init__(self) -> None:
        from vidsum_tpu_torch.data import datasets as ds
        from vidsum_tpu_torch.train import checkpoint as ck
        from vidsum_tpu_torch.train import pretraining as pt

        super().__init__([(ds, "PreTrainDataset", "load", None),
                          (pt, "epoch_streams", "epoch", None),
                          (pt, "pad_batch_pretrain", "collate", None),
                          (pt, "host_snapshot", "fetch", None),
                          (ck, "_write", "write", None)])
        self.steps, self.losses, self._pt = [], [], pt

    def __enter__(self) -> "PretrainClock":
        import torch

        super().__enter__()
        make_step = self._pt.make_pretrain_step

        def making(*args, **kw):
            step = make_step(*args, **kw)

            def timed(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses = step(*a, **k)
                end.record()
                self.steps.append((start, end))
                self.losses.append(losses)
                return losses

            return self._timed("step", timed)

        self._patch(self._pt, "make_pretrain_step", making)
        return self

    def summary(self, end: float) -> dict:
        """Per epoch its wall and the collate / step / fetch seconds in it
        (``other_s``: indexing the dataset, the loss fetch that waits for the
        device, logging, queueing the writes); the load and write seconds;
        the step CUDA-event ms."""
        marks = [t0 for s, t0, _ in self.events if s == "epoch"] + [end]
        epochs = []
        for a, b in zip(marks, marks[1:]):
            e = {"wall_s": b - a, "collate_s": 0.0, "step_s": 0.0,
                 "fetch_s": 0.0}
            for s, t0, t1 in self.events:
                if s in ("collate", "step", "fetch") and a <= t0 < b:
                    e[s + "_s"] += t1 - t0
            e["other_s"] = e["wall_s"] - e["collate_s"] - e["step_s"] - e[
                "fetch_s"]
            epochs.append(e)
        return {"load_s": [t1 - t0 for s, t0, t1 in self.events
                           if s == "load"],
                "epochs": epochs,
                "write_s": [t1 - t0 for s, t0, t1 in self.events
                            if s == "write"],
                "step_ms": [s.elapsed_time(e) for s, e in self.steps]}


def pretrain_card_vs_cpu(cfg, pcfg, feats, reps, rng, what: str,
                         routes, mod=None) -> dict:
    """One pretrain step (``make_pretrain_step`` on ``"fused_block"``,
    frozen ``video_transform``) from the same seeded model on the card and
    on the CPU's plain path with the same per-layer dropout seeds: the four
    losses within 1e-4 relative and each parameter's grad by the step bound
    (``compare_steps`` with STEP_SPARE and STEP_CAP; the grads, since
    Adam's first update moves every parameter by about lr whatever its grad and amplifies the
    difference of a grad near 0 past eps); ``video_transform`` keeps its
    bits on both; the card launches each of ``routes`` (counters of
    ``mod``, by default ``ops.block_train``) once a layer."""
    import copy

    import torch

    from vidsum_tpu_torch.data.collate import pad_batch_pretrain
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    from vidsum_tpu_torch.ops import block_train as bt
    from vidsum_tpu_torch.train.schedule import reference_pretrain_schedule
    from vidsum_tpu_torch.train.steps import (
        make_optimizer, make_pretrain_step,
    )

    x, v, m = pad_batch_pretrain(feats, reps)
    model = PretrainModel(cfg, pcfg, device="cpu",
                          generator=torch.Generator().manual_seed(pcfg.seed))
    schedule = reference_pretrain_schedule(
        pcfg.lr, max(pcfg.scheduler_samples // pcfg.batch_size, 1),
        pcfg.warmup_epochs, pcfg.epochs)
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, cfg.num_layers)]
    mod = mod or bt
    results, losses, t_s = [], [], {}
    for dev in ("cuda", "cpu"):
        before = [getattr(mod, r).launches for r in routes]
        t0 = time.monotonic()
        md = copy.deepcopy(model).to(dev)
        vt = {k: t.clone() for k, t in md.video_transform.state_dict()
              .items()}
        opt = make_optimizer([("encoder." + n, p) for n, p in
                              md.encoder.named_parameters()], pcfg.lr,
                             pcfg.weight_decay)
        out = make_pretrain_step(cfg, pcfg, schedule, "fused_block",
                                 device=dev)(md, opt, x, v, m, None,
                                             block_seeds=seeds)
        losses.append([float(t) for t in out.cpu()])
        results.append((losses[-1][0],
                        {k: p.grad.detach().float().cpu()
                         for k, p in md.named_parameters()}))
        t_s[dev] = time.monotonic() - t0
        if any(not torch.equal(t, vt[k]) for k, t in
               md.video_transform.state_dict().items()):
            raise AssertionError(f"{what}: video_transform moved on {dev}")
        moved = [getattr(mod, r).launches - b
                 for r, b in zip(routes, before)]
        if dev == "cuda" and moved != [cfg.num_layers] * len(routes):
            raise AssertionError(f"{what}: launches {moved} of {routes}, "
                                 f"expected {cfg.num_layers} each")
    for name, a, b in zip(("total", "main", "center", "repel"), *losses):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{what}: {name} loss on the card {a} != "
                                 f"CPU {b}")
    return dict(B=int(x.shape[0]), N=int(x.shape[1]), layers=cfg.num_layers,
                routes=list(routes), losses=losses, wall_s=t_s,
                **compare_steps(results, what, STEP_SPARE, STEP_CAP))


# The pretrain step's grads, card against CPU: the step bound
# (TOL["step_grad"]) with at most STEP_SPARE of a tensor's entries past its
# elementwise part, none by more than STEP_CAP of the largest grad. The
# pretrain losses' grads are small sums of larger terms, and a ReLU flip
# in a later layer moves a few fc1 entries upstream: at batch 16, bucket
# 384, 42 of 262,144 entries of one layer's fc1.weight by up to ~2e-4 of
# the largest grad (that tensor's relative RMS 9.9e-5); another run, up to
# 1.3e-4 (bucket 640) and 1.8e-4 (bucket 384) of it, 2.3e-5 of a tensor's
# entries past. A wiring fault moves whole tensors
STEP_SPARE = 1e-3
STEP_CAP = 1e-3
# The card-vs-CPU checks of phases 7c (the pretrain steps) and 8 (b) (the
# flash step on an 8,100-frame video) run the flagship cut to this many
# layers, to make room for phase 8b in the run's time (every layer runs the
# same code; the kernels are held at 4 layers on the card's own runs): at 4
# layers the CPU took 21.7 + 11.5 s and 35.1 s of the run
CPU_CHECK_LAYERS = 2


# what names the block training kernels (TPU kernels 9-12) in a profile:
# block_train.cu's kernels and the FMA attention they launch
BLOCK_TRAIN_KERNELS = ("bt_", "fma_")


def pretrain_step_profile(cfg, pcfg, feats, reps, seed: int) -> dict:
    """Where a recipe step's time goes, on one (256, N) batch: the step
    under ``torch.profiler`` (device ms, busy share, the block training
    kernels' device ms beside the rest, the top kernels) and the three
    losses alone, forward and backward from the encoder's outputs
    (``PretrainModel.objective``, CUDA-event ms)."""
    import torch

    from vidsum_tpu_torch.data.collate import pad_batch_pretrain
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    from vidsum_tpu_torch.train.schedule import reference_pretrain_schedule
    from vidsum_tpu_torch.train.steps import (
        make_optimizer, make_pretrain_step,
    )

    x, v, m = (torch.from_numpy(a).cuda()
               for a in pad_batch_pretrain(feats, reps))
    model = PretrainModel(cfg, pcfg,
                          generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer([("encoder." + n, p) for n, p in
                          model.encoder.named_parameters()], pcfg.lr,
                         pcfg.weight_decay)
    step = make_pretrain_step(cfg, pcfg, reference_pretrain_schedule(
        pcfg.lr, max(pcfg.scheduler_samples // pcfg.batch_size, 1),
        pcfg.warmup_epochs, pcfg.epochs))
    gen = torch.Generator().manual_seed(seed)
    prof = device_profile(lambda: step(model, opt, x, v, m, gen), reps=3,
                          groups={"block_training": BLOCK_TRAIN_KERNELS})
    with torch.no_grad():
        scores, hidden = model.encoder(x, m)
    scores.requires_grad_()
    hidden.requires_grad_()
    cw, rw = pcfg.center_weight, pcfg.repel_weight

    def losses():
        main, center, repel = model.objective(scores, hidden, v, m)
        (main + cw * center + rw * repel).backward()

    return dict(B=int(x.shape[0]), N=int(x.shape[1]), **prof,
                losses_ms=spread(cuda_times(losses, reps=5)))


def phase_pretrain(dev: dict, seed: int) -> None:
    """7c. Self-supervised pretraining through its entry point at the
    ``run_pretrain.sh`` width (module docstring, phase 7c)."""
    import dataclasses
    import math
    import tempfile

    import numpy as np
    import torch

    from vidsum_tpu_torch.cli import pretrain as pretrain_cli
    from vidsum_tpu_torch.config import pretrain_recipe
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    from vidsum_tpu_torch.train.checkpoint import load_checkpoint

    recipe = pretrain_recipe()
    cfg, pcfg = recipe.model, recipe.pretrain
    rng = np.random.default_rng(seed + 15)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.monotonic()
        lengths = pretrain_tree(data, rng, PT_CLIPS, cfg.in_features)
        write_s = time.monotonic() - t0

        def argv(save, epochs, *extra):
            return ["--data", data, "--d_model", str(cfg.d_model),
                    "--num_heads", str(cfg.num_heads), "--num_layers",
                    str(cfg.num_layers), "--dropout", str(cfg.dropout),
                    "--lr", str(pcfg.lr), "--batch_size",
                    str(pcfg.batch_size), "--sparsity", "0.0", "--epochs",
                    str(epochs), "--save", save, *extra]

        # 1. the recipe through the CLI, two epochs straight
        straight = os.path.join(tmp, "straight")
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with PretrainClock() as clock:
            out = pretrain_cli.main(argv(straight, PT_EPOCHS))
            torch.cuda.synchronize()
            end = time.perf_counter()
        cli_wall = time.monotonic() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        counts = read_counters()
        timeline = clock.summary(end)
        step_losses = torch.stack(clock.losses).cpu().tolist()
        history = out["history"]
        if not all(math.isfinite(v) for row in step_losses for v in row) \
                or len(history) != PT_EPOCHS:
            raise AssertionError(f"pretrain losses {step_losses}, history "
                                 f"{history}")
        n_steps = PT_EPOCHS * (PT_CLIPS // pcfg.batch_size)
        if len(step_losses) != n_steps:
            raise AssertionError(f"{len(step_losses)} steps, expected "
                                 f"{n_steps}")
        grouped = ("_fwd_kernel_grouped", "_bwd_kernel_grouped")
        launches = {r: counts[r] for r in TRAIN_ROUTES}
        if any(launches[r] != n_steps * cfg.num_layers for r in grouped):
            raise AssertionError(f"block training launches {launches}: the "
                                 f"grouped routes must run every layer of "
                                 f"every step (buckets <= 384)")
        init = PretrainModel(cfg, pcfg, device="cpu",
                             generator=torch.Generator().manual_seed(
                                 pcfg.seed))
        for k, t in init.video_transform.state_dict().items():
            if not torch.equal(out["params"]["video_transform." + k].cpu(),
                               t):
                raise AssertionError(f"the frozen video_transform.{k} moved")
        files = {n: os.path.exists(os.path.join(straight, n)) for n in (
            "pretrain.ckpt", "pretrain_state.ckpt")}
        if not all(files.values()):
            raise AssertionError(f"files written: {files}")

        # 2. exact resume: one epoch, then --resume to two
        resumed = os.path.join(tmp, "resumed")
        t0 = time.monotonic()
        pretrain_cli.main(argv(resumed, 1))
        out_r = pretrain_cli.main(argv(resumed, PT_EPOCHS, "--resume"))
        resume_wall = time.monotonic() - t0
        bad = [k for k, t in out["params"].items()
               if not torch.equal(t, out_r["params"][k])]
        sa, sb = (load_checkpoint(os.path.join(d, "pretrain_state.ckpt"))[0]
                  ["opt_state"]["state"] for d in (straight, resumed))
        bad += [f"adam {i}.{k}" for i in sa for k in sa[i]
                if not torch.equal(sa[i][k], sb[i][k])]
        ea, eb = (load_checkpoint(os.path.join(d, "pretrain.ckpt"))[0]
                  for d in (straight, resumed))
        bad += [f"pretrain.ckpt {k}" for k in ea
                if not torch.equal(ea[k], eb[k])]
        if bad or out_r["history"] != history:
            raise AssertionError(f"resume is not exact: tensors {bad[:8]}; "
                                 f"history {history} / {out_r['history']}")

    # 3. one step at the recipe width, batch 16, card against CPU: a
    # 600-frame clip (bucket 640: the per-element routes, rows 9/10), then
    # clips of the tree's lengths (bucket 384: the grouped routes, 11/12)
    proj = rng.normal(size=(cfg.in_features, 512)).astype(np.float32)

    def clips(ns):
        feats = [rng.standard_normal((n, cfg.in_features), dtype=np.float32)
                 for n in ns]
        return feats, [(f.mean(0) @ proj).astype(np.float32) for f in feats]

    check_cfg = dataclasses.replace(pcfg, batch_size=16)
    profile = pretrain_step_profile(cfg, pcfg, *clips(lengths[:256]), seed)
    ccfg = dataclasses.replace(cfg, num_layers=CPU_CHECK_LAYERS)
    card_vs_cpu = {
        "bucket_640": pretrain_card_vs_cpu(
            ccfg, check_cfg, *clips([600] + lengths[:15]), rng,
            "pretrain step, bucket 640", ("_fwd_kernel", "_bwd_kernel")),
        "bucket_384": pretrain_card_vs_cpu(
            ccfg, check_cfg, *clips(lengths[15:31]), rng,
            "pretrain step, bucket 384", grouped)}
    line(pretrain=dict(
        card=dev["smi"],
        recipe=dict(d_model=cfg.d_model, num_heads=cfg.num_heads,
                    num_layers=cfg.num_layers, dropout=cfg.dropout,
                    lr=pcfg.lr, weight_decay=pcfg.weight_decay,
                    batch_size=pcfg.batch_size, epochs=PT_EPOCHS),
        reduced=[f"epochs {pcfg.epochs} -> {PT_EPOCHS}",
                 f"card_vs_cpu: layers {cfg.num_layers} -> "
                 f"{CPU_CHECK_LAYERS}",
                 f"data {pcfg.scheduler_samples:,} samples (the schedule's "
                 f"scheduler_samples, kept) -> {PT_CLIPS} clips, so an epoch "
                 f"is {PT_CLIPS // pcfg.batch_size} steps, not "
                 f"{pcfg.scheduler_samples // pcfg.batch_size}",
                 "run_pretrain.sh's width, batch and learning rate kept"],
        data=(f"{PT_CLIPS} numpy-made clips of 60-380 frames, "
              f"{cfg.in_features}-d features and 512-d reps "
              f"(frames/*.npy + video/*.npy), written in {write_s:.1f} s"),
        cli_argv=argv("SAVE", PT_EPOCHS)[2:], cli_wall_s=cli_wall,
        steps=len(step_losses), step_ms=spread(timeline["step_ms"]),
        step_losses=step_losses, history=history,
        load_s=timeline["load_s"],
        epochs=[{k: round(v, 6) for k, v in e.items()}
                for e in timeline["epochs"]],
        ckpt_write_s=timeline["write_s"], peak_memory_gib=peak_gib,
        launches=launches,
        launches_card_vs_cpu={k: v["routes"] for k, v in
                              card_vs_cpu.items()},
        resume_wall_s=resume_wall, resume_bit_equal=True,
        video_transform_frozen=True, step_profile=profile,
        card_vs_cpu=card_vs_cpu))


# requests of the recycle phase and the supervisor's threshold
# ---------------------------------------------------------------------------
# 7e-7g. the raw-video path: summarize, extract, device eval
# ---------------------------------------------------------------------------

# sampled frames of the summarize phase's three videos: 4, 20 and 60 minutes
# at 30 fps, sampled at 2 fps (every 15th frame)
SUM_PICKS = (480, 2400, 7200)
SUM_STEP = 15
# a 16:9 frame already at GoogLeNet's 224 shorter side (no resize, no PIL)
SUM_FRAME = (224, 398)
# card against the CPU: pool5 features and sigmoid scores, each entry within
# atol + rtol |want| and the relative RMS within rel (set from the readings
# with headroom; a weight rolled by one output channel must fail them)
FEATURE_TOL = {"atol": 1e-4, "rtol": 1e-4, "rel": 1e-5}
SCORE_TOL = {"atol": 1e-5, "rtol": 1e-5, "rel": 1e-5}
# the seq forward's bound against the single-device route (the JAX test's)
MESH_SCORE_TOL = {"atol": 2e-5, "rtol": 2e-4, "rel": 2e-4}


class SyntheticVideos:
    """Numpy-made videos in place of decoded files (the card's machine has
    no cv2): ``stream("synthetic_<n>")`` is a ``ReducedStream`` of n sampled
    frames (``SUM_FRAME`` uint8) in scenes of 16-63 samples (8-31 s), each
    scene a random base frame plus per-frame noise in [-8, 8) from a pool of
    8 patterns, so KTS has cuts to find and variance inside a scene. The
    stream is the ``reduce_fps.iter_reduced_frames`` seam; ``decode_s``
    sums the seconds spent making frames (the decoder's stand-in)."""

    def __init__(self, seed: int) -> None:
        import numpy as np

        self.seed = seed
        self.decode_s = 0.0
        rng = np.random.default_rng(seed + 160)
        self.noise = rng.integers(0, 16, (8, *SUM_FRAME, 3), dtype=np.uint8)

    def scenes(self, n: int) -> list:
        """The scene lengths of the n-sample video (seeded by n)."""
        import numpy as np

        rng = np.random.default_rng(self.seed + n)
        lens = []
        while sum(lens) < n:
            lens.append(int(rng.integers(16, 64)))
        lens[-1] -= sum(lens) - n
        return [x for x in lens if x > 0]

    def cuts(self, n: int) -> list:
        """The planted cuts, in sample indices."""
        import itertools

        return list(itertools.accumulate(self.scenes(n)))[:-1]

    def frames(self, n: int):
        import numpy as np

        rng = np.random.default_rng(self.seed + 7 * n)
        i = 0
        for length in self.scenes(n):
            t0 = time.perf_counter()
            base = rng.integers(0, 240, (*SUM_FRAME, 3), dtype=np.uint8)
            self.decode_s += time.perf_counter() - t0
            for _ in range(length):
                t0 = time.perf_counter()
                frame = base + self.noise[i % 8]   # <= 254: no wrap
                self.decode_s += time.perf_counter() - t0
                i += 1
                yield frame

    def stream(self, path: str, fps: int = 2):
        from vidsum_tpu_torch.preprocess.reduce_fps import ReducedStream

        n = int(path.rsplit("_", 1)[1])
        return ReducedStream(frames=self.frames(n), n_frames=n * SUM_STEP,
                             step=SUM_STEP, final_count=n,
                             height=SUM_FRAME[0], width=SUM_FRAME[1])


def tol_report(got, want, tol: dict) -> dict:
    """Max abs error, relative RMS and whether ``got`` is within ``tol``."""
    err, rel = errors(got, want)
    return {"max_abs_err": err, "rel_rms": rel,
            "within": within(got, want, tol)}


def rolled_branch(net):
    """A copy of a GoogLeNet or R3D-18 with one conv's weights rolled by one
    output channel (a planted fault)."""
    import copy

    import torch

    bad = copy.deepcopy(net)
    conv = (bad.inception4a.branch2[1].conv if hasattr(bad, "inception4a")
            else bad.layer3[0].conv1[0])
    with torch.no_grad():
        conv.weight.copy_(torch.roll(conv.weight, 1, dims=0))
    return bad


def rolled_scorer(scorer):
    """A copy of a SimNet with its second layer's value weights rolled by
    one output channel (a planted fault in what the attention carries)."""
    import copy

    import torch

    bad = copy.deepcopy(scorer)
    v = bad.encoder.module_list[1].sa.v.weight
    with torch.no_grad():
        v.copy_(torch.roll(v, 1, dims=0))
    return bad


def timed_stages(pl, videos, n: int, kts_impls, begin) -> tuple:
    """The stages of the real path on the n-sample video: ``begin(n)``
    (``pipeline._begin_video``) then ``pipeline._finish_video`` once per
    KTS route, with the names that pipeline.py looks up at call time
    wrapped: ``embed`` (each chunk) and ``score_features`` in CUDA events,
    ``shot_bounds`` and ``generate_summary`` in the host clock. Returns
    (the stage times, the pending video)."""
    import torch

    events = {"backbone": [], "scorer": []}
    host = {}
    real = {name: getattr(pl, name) for name in (
        "embed", "score_features", "shot_bounds", "generate_summary")}

    def on_card(stage, fn):
        def wrapped(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events[stage].append((start, end))
            return out
        return wrapped

    def on_host(stage, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host[stage] = (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    try:
        pl.embed = on_card("backbone", real["embed"])
        pl.score_features = on_card("scorer", real["score_features"])
        pl.shot_bounds = on_host("kts", real["shot_bounds"])
        pl.generate_summary = on_host("selection", real["generate_summary"])
        videos.decode_s = 0.0
        pending = begin(n)
        torch.cuda.synchronize()
        kts = {}
        for impl in kts_impls:
            pl._finish_video(pending, 0.15, impl)
            kts[impl + "_ms"] = host["kts"]
    finally:
        for name, fn in real.items():
            setattr(pl, name, fn)
    card = {stage: sum(s.elapsed_time(e) for s, e in pairs)
            for stage, pairs in events.items()}
    return {"frames": n, "decode_stand_in_s": videos.decode_s,
            "backbone_ms": card["backbone"],
            "backbone_chunks": len(events["backbone"]),
            "scorer_ms": card["scorer"], "kts_ms": kts,
            "selection_ms": host["selection"]}, pending


def phase_summarize(dev: dict, seed: int) -> dict:
    """7e. ``cli.summarize`` at its defaults on three numpy-made videos
    (module docstring, phase 7e). Returns the launches of its runs and the
    480-sample video's card and CPU features for the extract phase."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from vidsum_tpu_torch import pipeline as pl
    from vidsum_tpu_torch.cli import summarize as sum_cli
    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.parallel.mesh import make_mesh
    from vidsum_tpu_torch.preprocess import GoogLeNet
    from vidsum_tpu_torch.preprocess import reduce_fps as rf
    from vidsum_tpu_torch.train.checkpoint import save_checkpoint

    from vidsum_tpu_torch.device import resolve_device

    gpu = resolve_device(None)
    first, longest = SUM_PICKS[0], SUM_PICKS[-1]
    videos = SyntheticVideos(seed)
    recorded = {}
    real_summarize = pl.summarize_video

    def recording(path, *args, **kw):
        out = real_summarize(path, *args, **kw)
        recorded[(path, kw.get("kts_impl", "host"),
                  kw.get("mesh") is not None)] = out
        return out

    runs, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        st.callback(setattr, rf, "iter_reduced_frames",
                    rf.iter_reduced_frames)
        st.callback(setattr, pl, "summarize_video", real_summarize)
        rf.iter_reduced_frames = videos.stream
        pl.summarize_video = recording
        # PyTorch's default (cuDNN may use TF32 for f32 convolutions), which
        # main() turns off for the kernel checks: the backbones must turn it
        # off for their own calls, and the card-vs-CPU check below shows it
        st.enter_context(torch.backends.cudnn.flags(enabled=True,
                                                    allow_tf32=True))
        ckpt = os.path.join(tmp, "scorer.ckpt")
        gweights = os.path.join(tmp, "googlenet.pth")
        save_checkpoint(ckpt, SimNet(
            ModelConfig(), device="cpu",
            generator=torch.Generator().manual_seed(seed + 16)).state_dict())
        torch.save(GoogLeNet(generator=torch.Generator().manual_seed(
            seed + 17)).state_dict(), gweights)
        base = ["--ckpt", ckpt, "--google_weights", gweights]

        # 1. the CLI on every video and KTS route
        for n in SUM_PICKS:
            for impl in (("host", "device") if n < longest else ("device",)):
                out = os.path.join(tmp, f"{n}_{impl}.json")
                reset_counters()
                torch.cuda.reset_peak_memory_stats()
                videos.decode_s = 0.0
                t0 = time.monotonic()
                sum_cli.main(base + ["--video", f"synthetic_{n}",
                                     "--kts_impl", impl, "--out", out])
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                counts = {k: v for k, v in read_counters().items() if v}
                with open(out) as f:
                    printed = json.load(f)
                r = recorded[(f"synthetic_{n}", impl, False)]
                sel = printed["selected_frames"]
                if not (printed["n_frames"] == n * SUM_STEP
                        and r.summary.shape == (n * SUM_STEP,)
                        and set(np.unique(r.summary)) <= {0, 1}
                        and len(sel) <= int(n * SUM_STEP * 0.15)
                        and np.isfinite(r.scores).all()
                        and r.scores.shape == (n,)):
                    raise AssertionError(f"summarize {n} {impl}: bad output")
                runs.append({"frames": n, "kts_impl": impl, "wall_s": wall,
                             "decode_stand_in_s": videos.decode_s,
                             "peak_memory_gib":
                                 torch.cuda.max_memory_allocated() / 2**30,
                             "shots": len(r.change_points),
                             "selected": len(sel), "launches": counts})
                launches[(n, impl)] = counts
        planted = {}
        for n in SUM_PICKS[:2]:
            h = recorded[(f"synthetic_{n}", "host", False)]
            d = recorded[(f"synthetic_{n}", "device", False)]
            if not (np.array_equal(h.change_points, d.change_points)
                    and np.array_equal(h.summary, d.summary)):
                raise AssertionError(
                    f"{n} samples: device KTS {len(d.change_points)} shots "
                    f"against the host's {len(h.change_points)}")
            found = set((h.change_points[:, 0] // SUM_STEP).tolist())
            planted[n] = [sum(c in found for c in videos.cuts(n)),
                          len(videos.cuts(n))]
        block = sum(launches[(first, i)].get(r, 0)
                    for i in ("host", "device")
                    for r in ("_fused_block", "_fused_block_grouped"))
        flash = sum(launches[(longest, "device")].get(r, 0) for r in (
            "_flash_attention", "_flash_attention_folded"))
        if not block or not flash:
            raise AssertionError(f"the block route launched {block} times at "
                                 f"{first} samples, the flash route {flash} "
                                 f"times at {longest}: {launches}")

        # 2. the 7,200-sample video over a (1, 4) mesh of this card
        args = sum_cli.build_parser().parse_args(base + ["--video", "x"])
        cfg, scorer, google = sum_cli.load_models(args)
        mesh = make_mesh((1, 4), gpu)
        reset_counters()
        t0 = time.monotonic()
        sharded = pl.summarize_video(f"synthetic_{longest}", scorer, cfg,
                                     google, mesh=mesh, kts_impl="device")
        torch.cuda.synchronize()
        mesh_wall = time.monotonic() - t0
        mesh_counts = {k: v for k, v in read_counters().items() if v}
        single = recorded[(f"synthetic_{longest}", "device", False)]
        mesh_check = tol_report(torch.from_numpy(sharded.scores),
                                torch.from_numpy(single.scores),
                                MESH_SCORE_TOL)
        if not mesh_check["within"] or not mesh_counts.get(
                "_ring_block_step"):
            raise AssertionError(f"mesh route: {mesh_check}, launches "
                                 f"{mesh_counts}")
        launches["mesh"] = mesh_counts

        # 3. the 480-sample video: card against the port's CPU run
        dev_cpu = torch.device("cpu")
        cfg_c, scorer_c, google_c = sum_cli.load_models(args, "cpu")
        t0 = time.monotonic()
        p_cpu = pl._begin_video(f"synthetic_{first}", scorer_c, cfg_c,
                                google_c, 2, 224, 64, None, 256, dev_cpu)
        cpu_s = time.monotonic() - t0
        p_gpu = pl._begin_video(f"synthetic_{first}", scorer, cfg, google, 2,
                                224, 64, None, 256, gpu)
        feats_g, feats_c = p_gpu.feats.cpu(), p_cpu.feats
        feat_check = tol_report(feats_g, feats_c, scaled(FEATURE_TOL,
                                                         feats_c))
        score_check = tol_report(p_gpu.scores[:first].cpu(),
                                 p_cpu.scores[:first], SCORE_TOL)
        p_bad = pl._begin_video(f"synthetic_{first}", scorer, cfg,
                                rolled_branch(google), 2, 224, 64, None,
                                256, gpu)
        fault = tol_report(p_bad.feats.cpu(), feats_c,
                           scaled(FEATURE_TOL, feats_c))
        if not (feat_check["within"] and score_check["within"]) \
                or fault["within"]:
            raise AssertionError(f"card against CPU at {first} samples: "
                                 f"features {feat_check}, scores "
                                 f"{score_check}, planted fault {fault}")

        # 4. each stage of the real path, timed where it runs
        breakdown, pending = [], {}
        for n in SUM_PICKS:
            stages, pending[n] = timed_stages(
                pl, videos, n,
                ("host", "device") if n < longest else ("device",),
                lambda n: pl._begin_video(f"synthetic_{n}", scorer, cfg,
                                          google, 2, 224, 64, None, 256,
                                          gpu))
            breakdown.append(stages)

        # 5. the kernels' scores at 2,400 (the fused block, T 2,432) and
        # 7,200 (the flash single pass, T 7,296), and the mesh's (the ring,
        # 7,232 over 4 shards), against the plain dense route on the CPU
        # over the same card features; a scorer with one weight rolled
        # must fail each bound
        bad = rolled_scorer(scorer)
        against_plain = {}
        for n in SUM_PICKS[1:]:
            feats = pending[n].feats
            t0 = time.monotonic()
            plain = pl.score_features(scorer_c, cfg_c, feats.cpu())[:n]
            plain_s = time.monotonic() - t0
            routes = {"single": (pending[n].scores[:n].cpu(), SCORE_TOL,
                                 pl.score_features(bad, cfg, feats))}
            if n == longest:
                routes["mesh"] = (
                    torch.from_numpy(sharded.scores), MESH_SCORE_TOL,
                    pl.score_features(bad, cfg, feats, mesh=mesh))
            for route, (got, tol, faulty) in routes.items():
                check = tol_report(got, plain, tol)
                missed = tol_report(faulty[:n].cpu(), plain, tol)
                if not check["within"] or missed["within"]:
                    raise AssertionError(
                        f"{route} scores at {n} samples against the plain "
                        f"route: {check}, planted fault {missed}")
                against_plain[f"{n}_{route}"] = dict(
                    check, planted_fault=missed, tolerance=tol,
                    plain_cpu_s=plain_s)
        del pending, bad

    emit("summarize", card=dev["smi"],
         config=("ModelConfig() (d 256, 4 heads, 4 layers, f32), GoogLeNet "
                 "pool5 at 224, budget 0.15, the CLI's defaults; seeded "
                 "weights from a port checkpoint and a torchvision-layout "
                 ".pth"),
         videos={n: {"samples": n, "frames": n * SUM_STEP,
                     "scenes": len(videos.scenes(n))} for n in SUM_PICKS},
         runs=runs, planted_cuts_found_by_host=planted,
         host_equals_device_kts=True,
         mesh={"wall_s": mesh_wall, "launches": mesh_counts,
               "scores_vs_single": mesh_check,
               "padded_length": pl.score_length(longest, 64, mesh)},
         card_vs_cpu={"features": feat_check, "scores": score_check,
                      "planted_fault": fault, "cpu_begin_s": cpu_s,
                      "tolerance": {"features": FEATURE_TOL,
                                    "scores": SCORE_TOL}},
         scores_vs_plain=against_plain, breakdown=breakdown)
    return {"launches": launches, "feats_480": (feats_g.numpy(),
                                                feats_c.numpy())}


def phase_extract(dev: dict, seed: int, feats_480) -> None:
    """7f. The offline extractors on the card against their CPU run, and
    the dataset entry of one video (module docstring, phase 7f)."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.device import resolve_device
    from vidsum_tpu_torch.preprocess import FeatureExtractor
    from vidsum_tpu_torch.preprocess.annotations import VideoAnnotation
    from vidsum_tpu_torch.preprocess.build_dataset import entry_from_features
    from vidsum_tpu_torch.preprocess.transforms import (
        device_normalize, imagenet_normalize, video_normalize,
    )

    rng = np.random.default_rng(seed + 170)
    lines = {}
    for kind, shape, size in (("google", (64, 224, 398, 3), 224),
                              ("r3d18", (16, 112, 149, 3), 112)):
        video = rng.integers(0, 256, shape, dtype=np.uint8)
        ex, ex_c = (FeatureExtractor(kind, device=d) for d in (None, "cpu"))
        run = ((lambda e: e.frames(video, size)) if kind == "google"
               else (lambda e: e.clip(video, size)))
        got, want = (torch.from_numpy(run(e)) for e in (ex, ex_c))
        check = tol_report(got, want, scaled(FEATURE_TOL, want))
        good, ex.net = ex.net, rolled_branch(ex.net)
        fault = tol_report(torch.from_numpy(run(ex)), want,
                           scaled(FEATURE_TOL, want))
        ex.net = good
        if not check["within"] or fault["within"]:
            raise AssertionError(f"{kind} extractor, card against CPU: "
                                 f"{check}; planted fault {fault}")
        ms = cuda_ms(lambda: run(ex), reps=3)
        lines[kind] = {"input": list(shape), "size": size,
                       "out": list(got.shape), "ms": ms,
                       "frames_per_s": shape[0] / ms * 1e3,
                       "batch_size": ex.batch_size, "check": check,
                       "planted_fault": fault}

    allv = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None],
                           (1, 256, 3)).copy()
    ulp = {}
    for kind, host in (("google", imagenet_normalize),
                       ("r3d18", video_normalize)):
        want = host(allv)
        got = device_normalize(torch.from_numpy(allv).to(
            resolve_device(None)), kind).cpu()
        ulp[kind] = float((np.abs(got.numpy() - want)
                           / np.spacing(np.abs(want))).max())

    feats_g, feats_c = feats_480
    n = feats_g.shape[0]
    picks = np.arange(n) * SUM_STEP
    arng = np.random.default_rng(seed + 171)
    gt = arng.random(n * SUM_STEP).astype(np.float32)
    anno = VideoAnnotation(video_id=f"synthetic_{n}", gt_score=gt,
                           n_frames=n * SUM_STEP,
                           user_anno=(gt[None] * 4 + arng.random(
                               (5, n * SUM_STEP))).astype(np.float32))
    entries = [entry_from_features(f, None, picks, n * SUM_STEP, anno)
               for f in (feats_g, feats_c)]
    same = {k: bool(np.array_equal(entries[0][k], entries[1][k]))
            for k in ("change_points", "user_summary", "gtscore", "picks")}
    if not all(same.values()):
        raise AssertionError(f"entry_from_features, card against CPU "
                             f"features: {same}")
    emit("extract", card=dev["smi"], extractors=lines,
         device_normalize_max_ulp=ulp, entry_equal_to_cpu=same,
         entry_shots=len(entries[0]["change_points"]))


EVAL_FLAVORS = ("plain", "ties", "tiny_shots", "exact_end", "overhang",
                "nonmono", "short_scores", "int32_picks", "float_picks")
EVAL_VIDEOS = 1000


def eval_fuzz_video(rng, flavor: str):
    """One randomized DSNet-shaped video of a JAX fuzz flavour (the JAX
    package's ``tests/test_reference_differential._random_video``, drawn in
    the same order): (picks, n_frames, scores, change points)."""
    import numpy as np

    n_picks = int(rng.integers(8, 140))
    step = int(rng.integers(1, 20))
    picks = np.arange(n_picks) * step
    n_frames = int(picks[-1] + rng.integers(1, step + 1))
    if flavor == "exact_end":
        n_frames = int(picks[-1]) if picks[-1] > 0 else 1
    elif flavor == "overhang":
        n_frames = max(1, int(picks[-1] - rng.integers(0, step + 1)))
    elif flavor == "nonmono":
        picks = picks.copy()
        rng.shuffle(picks[:-1])
    scores = rng.random(n_picks).astype(np.float32)
    if flavor == "ties":
        scores = (rng.integers(0, 4, size=n_picks) / 4.0).astype(np.float32)
    elif flavor == "short_scores":
        scores = scores[: max(1, n_picks - 1)]
    if flavor == "tiny_shots":
        seg = rng.integers(1, 4)
        bounds = np.concatenate([np.arange(0, n_frames, seg), [n_frames]])
    else:
        n_shots = int(rng.integers(1, 16))
        n_cuts = min(n_shots - 1, max(0, n_frames - 1))
        cuts = (np.sort(rng.choice(np.arange(1, n_frames), n_cuts,
                                   replace=False)) if n_cuts
                else np.array([], int))
        bounds = np.concatenate([[0], cuts, [n_frames]])
    cp = np.stack([bounds[:-1], bounds[1:] - 1], axis=1).astype(np.int64)
    if flavor == "int32_picks":
        picks = picks.astype(np.int32)
    elif flavor == "float_picks":
        picks = picks.astype(np.float64)
    return picks, n_frames, scores, cp


def phase_device_eval(dev: dict) -> None:
    """7g. ``device_generate_summary`` on the card against the host oracle
    over 1,000 fuzz videos (module docstring, phase 7g)."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.ops.device_eval import (
        device_eligible, device_generate_summary,
    )
    from vidsum_tpu_torch.ops.summary import generate_summary

    rng = np.random.default_rng(0)   # the JAX fuzz's default seed
    videos = [eval_fuzz_video(rng, EVAL_FLAVORS[i % len(EVAL_FLAVORS)])
              for i in range(EVAL_VIDEOS)]
    args = ([v[3] for v in videos], [v[2] for v in videos],
            [v[1] for v in videos], [v[0] for v in videos])
    eligible = sum(device_eligible(v[0], v[2], v[1]) for v in videos)
    t0 = time.perf_counter()
    host = generate_summary(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    calls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = device_generate_summary(*args)
        calls.append((time.perf_counter() - t0) * 1e3)
    bad = [i for i, (h, g) in enumerate(zip(host, got))
           if not np.array_equal(h, g)]
    if bad:
        raise AssertionError(f"device summaries differ from the host "
                             f"oracle's for {len(bad)} of {EVAL_VIDEOS} "
                             f"videos: {bad[:10]}")
    emit("device_eval", card=dev["smi"], videos=EVAL_VIDEOS,
         flavors=EVAL_FLAVORS, seed=0, on_device=eligible,
         to_host=EVAL_VIDEOS - eligible, mismatches=0,
         device_call_ms=calls, host_ms=host_ms,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         max_shots=max(len(v[3]) for v in videos),
         max_frames=max(v[1] for v in videos))


RECYCLE_REQUESTS = 12
RECYCLE_EVERY = 4


def phase_recycle(seed: int) -> None:
    """7d. ``python -m vidsum_tpu_torch.cli.serve --recycle_after_requests
    4 --warmup ""`` as a supervisor from the repo root: 12 requests of
    60-512 frames posted 0.6 s apart (past the workers' 0.5 s monitor
    poll) must all succeed (200, one finite score a frame) across at least
    two recycles, with no worker crash in the log; SIGINT must end the
    supervisor with 0."""
    import io
    import signal
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np

    rng = np.random.default_rng(seed + 16)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "vidsum_tpu_torch.cli.serve", "--host",
           "127.0.0.1", "--port", str(port), "--recycle_after_requests",
           str(RECYCLE_EVERY), "--warmup", ""]
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "serve.log")
        t0 = time.monotonic()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, cwd=HERE, stdout=log,
                                    stderr=subprocess.STDOUT)
        request_s, lengths = [], []
        try:
            deadline = time.monotonic() + 300
            while True:
                try:
                    with urllib.request.urlopen(url + "/healthz",
                                                timeout=10):
                        break
                except (urllib.error.URLError, OSError):
                    if proc.poll() is not None or time.monotonic() > deadline:
                        raise AssertionError("the supervised server never "
                                             "came up")
                    time.sleep(0.5)
            for n in rng.integers(60, 513, RECYCLE_REQUESTS):
                buf = io.BytesIO()
                np.savez(buf, features=rng.standard_normal(
                    (int(n), 1024), dtype=np.float32))
                req = urllib.request.Request(
                    url + "/summarize", data=buf.getvalue(), method="POST")
                t1 = time.monotonic()
                with urllib.request.urlopen(req, timeout=300) as resp:
                    status, out = resp.status, json.loads(resp.read())
                request_s.append(time.monotonic() - t1)
                scores = np.asarray(out["scores"])
                if (status != 200 or scores.shape != (int(n),)
                        or not np.isfinite(scores).all()):
                    raise AssertionError(f"a {n}-frame request: status "
                                         f"{status}, scores {scores.shape}")
                lengths.append(int(n))
                time.sleep(0.6)
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=180)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = "killed after 180 s"
            wall = time.monotonic() - t0
            with open(log_path) as f:
                log = f.read()
    recycles = log.count("recycled after")
    generations = log.count("serving on http")
    if rc != 0 or recycles < 2 or "died rc=" in log:
        print(log[-4000:], file=sys.stderr)
        raise AssertionError(f"supervisor exit {rc}, {recycles} recycles, "
                             f"crash in the log: {'died rc=' in log}")
    line(recycle=dict(requests=len(lengths), recycles=recycles,
                      generations=generations, wall_s=wall,
                      request_s=request_s, lengths=lengths,
                      every=RECYCLE_EVERY, exit_code=rc))


def phase_long_train(seed: int) -> dict:
    """Finetuning on videos past the block-train envelope (N > 7,936 at
    d 256): (b) the flash route on one 8,100-frame video (bucket 8,192; f32
    takes the folded route, TPU kernels 7/8), card against CPU; (c) recipe
    epochs on the auto route over 8 videos of 7,950-9,000 frames, in f32
    (demoted to the folded route) and bf16 (the single-pass route, kernels
    5/6), and over 8 videos of 11,000-14,000 frames in bf16 (buckets past
    the single pass's 10,880: the folded route's tensor-core kernels).
    After (c) the bf16 fold's kernels are held against the plain fold at
    the largest bucket of the 11,000-14,000-frame run. Returns the training
    attention routes' launches in (c), the bf16 folded run's under
    ``<route>.bf16``, the 7,950-9,000-frame videos, and the bf16 fold's max
    abs errors at that bucket by ``<route>.bf16``."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import finetune_recipe
    from vidsum_tpu_torch.data.collate import pad_batch
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.steps import (
        make_finetune_step, make_optimizer,
    )

    conf = finetune_recipe()
    cfg, tc = conf.model, conf.train
    rng = np.random.default_rng(seed + 6)

    # (b), at CPU_CHECK_LAYERS layers
    [item] = synthetic_videos(rng, [8100], cfg.in_features)
    xb, tb, mb = pad_batch([item[0]], [item[1]])
    if xb.shape[1] != 8192 or at._single_pass_ok(8192, cfg.head_dim, 4):
        raise AssertionError(f"an 8,100-frame video buckets to "
                             f"{xb.shape[1]} frames")
    ccfg = dataclasses.replace(cfg, num_layers=CPU_CHECK_LAYERS)
    cmodel = SimNet(ccfg, generator=torch.Generator().manual_seed(seed + 1))
    folded_vs_cpu = flash_card_vs_cpu(
        cmodel, ccfg, xb, tb, mb, rng, "flash route, one 8,100-frame video",
        ("_fwd_kernel_folded", "_bwd_kernel_folded"))
    del cmodel

    # (c)
    videos = synthetic_videos(rng, rng.integers(7950, 9001, 8),
                              cfg.in_features)
    longer = synthetic_videos(rng, rng.integers(11000, 14001, 8),
                              cfg.in_features)
    block_routes = TRAIN_ROUTES
    folded_routes = ("_fwd_kernel_folded", "_bwd_kernel_folded")
    single_routes = ("_fwd_kernel", "_bwd_kernel")
    report, launches = {}, {}
    # (report key, dtype, routes, videos, launch key suffix, bucket range)
    runs = (("float32", "float32", folded_routes, videos, "", None),
            ("bfloat16", "bfloat16", single_routes, videos, "", None),
            ("bfloat16_folded", "bfloat16", folded_routes, longer, ".bf16",
             (10880, 20480)))
    for key, dtype, routes, items, suffix, buckets in runs:
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        dconf = dataclasses.replace(conf, model=dcfg)
        model = SimNet(dcfg, generator=torch.Generator().manual_seed(seed))
        step = make_finetune_step(dcfg, tc.attn_impl)
        optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
        times, losses, shapes = [], [], []

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*args)
            end.record()
            times.append((start, end))
            losses.append(loss)
            shapes.append(tuple(args[2].shape[:2]))
            return loss

        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        epoch_losses = [ft._train_epoch(timed, model, optimizer, items,
                                        dconf, *ft.epoch_streams(tc.seed, 1,
                                                                 epoch))
                        for epoch in range(LONG_EPOCHS)]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        counts = read_counters()
        names = [attn_train_name(r) for r in routes]
        others = [attn_train_name(r) for r in ATTN_TRAIN_ROUTES
                  if r not in routes]
        n_steps = len(losses)
        if [counts[n] for n in names] != [cfg.num_layers * n_steps] * 2:
            raise AssertionError(f"{key} long-video epochs: launches "
                                 f"{counts}, expected {cfg.num_layers} of "
                                 f"{names} per step")
        moved = [r for r in block_routes if counts[r]] + [
            n for n in others if counts[n]]
        if moved:
            raise AssertionError(f"{key} long-video epochs launched "
                                 f"{moved}: another route than {names}")
        if buckets and not all(buckets[0] < n <= buckets[1]
                               for _, n in shapes):
            raise AssertionError(f"{key} long-video epochs: buckets "
                                 f"{shapes} outside {buckets}")
        step_losses = [float(x) for x in losses]
        if not all(math.isfinite(v) for v in step_losses):
            raise AssertionError(f"non-finite losses: {step_losses}")
        for n in names:
            launches[n + suffix] = counts[n]
        xl, tl, ml = (torch.from_numpy(a).cuda() for a in pad_batch(
            [it[0] for it in items[:tc.batch_size]],
            [it[1] for it in items[:tc.batch_size]]))
        gen = torch.Generator().manual_seed(seed)
        report[key] = dict(
            dtype=dtype, routes=names, steps=n_steps, batch_shapes=shapes,
            step_ms=spread([s.elapsed_time(e) for s, e in times]),
            wall_s=wall, peak_memory_gib=peak_gb, epoch_loss=epoch_losses,
            step_losses=step_losses,
            launches={n: counts[n] for n in names},
            block_train_launches={r: counts[r] for r in block_routes},
            step_profile=device_profile(
                lambda: step(model, optimizer, xl, tl, ml, gen), reps=2))
        del model, optimizer
        torch.cuda.empty_cache()
    # the bf16 fold's kernels against the plain fold at the largest bucket
    # the run gave them (after the run: these launches are not its count)
    at_bucket = hold_folded_at_bucket(
        cfg, report["bfloat16_folded"]["batch_shapes"],
        [it[0].shape[0] for it in longer], rng)
    report["bfloat16_folded"]["kernels_at_largest_bucket"] = at_bucket
    bucket_err = {
        attn_train_name("_fwd_kernel_folded") + ".bf16": max(
            at_bucket["o_err"][0], at_bucket["lse_err"][0]),
        attn_train_name("_bwd_kernel_folded") + ".bf16": max(
            e[0] for e in at_bucket["grad_err"].values())}
    missing = [n for n in map(attn_train_name, ATTN_TRAIN_ROUTES)
               if not launches.get(n)]
    if missing:
        raise AssertionError(f"training attention routes never launched: "
                             f"{missing}")
    emit("long_train", lengths=[int(it[0].shape[0]) for it in videos],
         lengths_bfloat16_folded=[int(it[0].shape[0]) for it in longer],
         flash_folded_card_vs_cpu=folded_vs_cpu, **report)
    return launches, videos, bucket_err


RING_ROUTES = ("_ring_block_step", "_ring_train_step", "_ring_train_step_bwd")
RING_NAMES = {"_ring_block_step": "ring_block",
              "_ring_train_step": "ring_train_fwd",
              "_ring_train_step_bwd": "ring_train_bwd"}
RING_SHARDS = 4


def ring_module():
    """``parallel/ring_attention.py`` (the package re-exports a function of
    the same name over it)."""
    import importlib

    return importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")


def check_carries(got, want, what: str) -> dict:
    """o (atol relative to its largest entry), m and l (the f32 attention
    bound) of a ring step against the plain step's; raises past them."""
    tol = TOL[("attention", "float32")]
    return {"o": check_close(got[0], want[0], scaled(tol, want[0]),
                             f" ({what}: o)"),
            "m": check_close(got[1], want[1], tol, f" ({what}: m)"),
            "l": check_close(got[2], want[2], tol, f" ({what}: l)")}


def carries_within(got, want) -> bool:
    tol = TOL[("attention", "float32")]
    return (within(got[0], want[0], scaled(tol, want[0]))
            and within(got[1], want[1], tol) and within(got[2], want[2], tol))


def ring_shapes_agree(ra, call, what: str) -> None:
    """Runs ``call`` (a ring kernel wrapper's call, returning tensors) with
    every ring kernel in each of its CTA shapes in turn (``ring_shapes``:
    128- and 64-row at head_dim <= 64) and fails unless every output is
    bit-equal."""
    import torch

    pick = ra.ring_cta_shape
    outs = []
    try:
        for i in range(2):  # no ring kernel has more than two shapes
            ra.ring_cta_shape = (
                lambda kernel, B, H, N, Dh, sms, slots, i=i:
                ra.ring_shapes(kernel, Dh)[
                    min(i, len(ra.ring_shapes(kernel, Dh)) - 1)])
            outs.append([t.clone() for t in call()])
    finally:
        ra.ring_cta_shape = pick
    torch.cuda.synchronize()
    if not all(torch.equal(a, b)
               for o in outs[1:] for a, b in zip(outs[0], o)):
        raise AssertionError(f"{what}: the CTA shapes give different bits")


def ring_rates(flops: int, ms: float, b_ms: float, device: dict) -> dict:
    """A ring kernel's achieved f32 rate and its share of the bound's, from
    the wrapper call's CUDA-event time ``ms`` (host work between launches
    included: the GPU idles while the wrapper prepares its operands) and
    from ``device`` (a ``ring_device`` profile): the ring kernels' own
    device time."""
    kern = device["ring_kernel_ms"]
    return {"tflops": flops / ms / 1e9, "share_of_bound": b_ms / ms,
            "device_ms": device["device_ms"], "ring_kernel_ms": kern,
            "kernel_tflops": flops / kern / 1e9,
            "kernel_share_of_bound": b_ms / kern}


def ring_device(fn) -> dict:
    """``fn`` (one ring wrapper call) under ``torch.profiler``: device ms
    per call of every kernel it launches, and of the ring kernels alone."""
    prof = device_profile(fn, reps=10)
    return {"device_ms": prof["device_ms"],
            "ring_kernel_ms": sum(ms for name, ms, _ in prof["top"]
                                  if "ring_" in name)}


def ring_kernel_ms(fn) -> dict:
    """``fn`` (one ring wrapper call) under ``torch.profiler``: device ms
    per call of each ring kernel it launches, by ``RING_KERNELS`` name."""
    top = device_profile(fn, reps=10)["top"]
    return {kk: sum(ms for name, ms, _ in top
                    if f"ring_{kk}_kernel" in name)
            for kk in ("fwd", "dq", "dkdv")}


def phase_ring_kernels(dev: dict, seed: int, ring_ptxas=()) -> dict:
    """TPU kernels 15-17 (``parallel/ring_attention.py``,
    ``csrc/ring_attention.cu``) against their plain steps on the card, at
    the shapes the main paths give them: carries and grads within their
    bounds, planted faults failing them, a block whose keys are all padded
    passing the carry and dq/dk/dv through bit for bit, shard 3's partly
    padded block (whole padded key tiles: the live-tile path), every CTA
    shape bit-equal; ``ring_ptxas`` (the build's ptxas report of the ring
    kernels) goes on the lines at head_dim 64. Returns the numbers per route
    for the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.parallel.mesh import make_mesh

    ra = ring_module()
    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    H, Dh, scale, P = cfg.num_heads, cfg.head_dim, cfg.attn_scale, RING_SHARDS
    cuda = torch.device("cuda")

    def ptxas(*kernels):
        return [r for r in ring_ptxas if r["kernel"].startswith(kernels)
                and f"<{Dh}," in r["kernel"]]

    rng = np.random.default_rng(seed + 7)
    mesh = make_mesh((1, P), "cuda:0")
    out = {}

    def rand(B, N, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=(B, H, N, Dh)).astype(
            np.float32)).to(cuda, dtype)

    def bound(flops, nbytes):
        t_ops = flops / peaks["float32"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def shard(t, s, dim=2):
        n = t.shape[dim] // P
        return t.narrow(dim, s * n, n).contiguous()

    # -- kernel 15: a 16,384-frame request (15,000 valid: shard 3 partly
    # padded) over 4 shards of 4,096, K/V in bf16 (the serving dtype).
    # Checked: shard 1 folding its own block into a fresh carry (t = 0),
    # then the fully valid block of shard 0 (t = 1; timed), and shard 3's
    # partly padded block
    B, N = 1, 16384
    Nl = N // P
    mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
    mask[:, 15000:] = True
    q, k, v = (rand(B, N, torch.bfloat16) for _ in range(3))
    q32 = [shard(q, s).float() * scale for s in range(P)]
    ks, vs = ([shard(t, s) for s in range(P)] for t in (k, v))
    ms = [shard(mask, s, 1) for s in range(P)]
    t0 = ra.ring_block_step_reference(q32[1], ks[1], vs[1], ms[1],
                                      *ra._init_carries(q32[1]))
    cases = {"t0_own_block": (q32[1], ks[1], vs[1], ms[1],
                              *ra._init_carries(q32[1])),
             "t1_block_0": (q32[1], ks[0], vs[0], ms[0], *t0),
             "t2_padded_block_3": (q32[1], ks[3], vs[3], ms[3], *t0)}
    errs = {}
    before = ra._ring_block_step.launches
    for name, args in cases.items():
        got = ra._ring_block_step(*args)
        errs[name] = check_carries(got, ra.ring_block_step_reference(*args),
                                   f"kernel 15 {name}")
    torch.cuda.synchronize()
    if ra._ring_block_step.launches != before + len(cases):
        raise AssertionError("kernel 15 did not launch")
    # a block whose keys are all padded leaves the carry bit for bit
    kept = ra._ring_block_step(q32[1], ks[0], vs[0],
                               torch.ones_like(ms[0]), *t0)
    if not all(torch.equal(a, b) for a, b in zip(kept, t0)):
        raise AssertionError("kernel 15: an all-padded block moved the carry")
    for name in ("t1_block_0", "t2_padded_block_3"):
        ring_shapes_agree(ra, lambda: ra._ring_block_step(*cases[name]),
                          f"kernel 15 {name}")
    # planted fault: one key tile dropped
    args = cases["t1_block_0"]
    want = ra.ring_block_step_reference(*args)
    dropped = args[3].clone()
    dropped[:, :ra.KEY_TILE] = True
    bad = ra._ring_block_step(*args[:3], dropped, *args[4:])
    if carries_within(bad, want):
        raise AssertionError("kernel 15: a dropped key tile passes the bound")
    fault = errors(bad[0], want[0])
    ms15 = cuda_ms(lambda: ra._ring_block_step(*args), reps=20)
    # the same call with K/V already f32: the wrapper's widening is the
    # difference (a ring on one device widens once a layer, not a step)
    args32 = (args[0], args[1].float(), args[2].float(), *args[3:])
    ms15_kv32 = cuda_ms(lambda: ra._ring_block_step(*args32), reps=20)
    dev15 = ring_device(lambda: ra._ring_block_step(*args))
    plain15 = cuda_ms(lambda: ra.ring_block_step_reference(*args), reps=5)
    # the whole ring (P x P = 16 launches) against SDPA over the unsharded
    # f32 sequence (timed only), and against the plain ring (checked)
    fwd = ra.make_ring_forward(mesh, scale)
    ring = fwd(q, k, v, mask)
    ring_plain = ra.make_ring_forward(mesh, scale, block_impl="plain")(
        q, k, v, mask)
    ring_err = check_close(ring, ring_plain, TOL[("attention", "bfloat16")],
                           " (kernel 15 ring against the plain ring)")
    ring_ms = cuda_ms(lambda: fwd(q, k, v, mask), reps=5)
    qf, kf, vf = q.float(), k.float(), v.float()
    keep = ~mask[:, None, None, :]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, attn_mask=keep, scale=scale), reps=5)
    flops = 4 * B * H * Nl * Nl * Dh
    nbytes = B * H * Nl * Dh * (4 + 2 + 2 + 4 + 4) + B * H * Nl * 16 + B * Nl
    b_ms, b_by = bound(flops, nbytes)
    emit("ring_kernel", route="ring_block", B=B, H=H, Nl=Nl, Dh=Dh,
         shards=P, kv_dtype="bfloat16", valid=15000, errors=errs,
         dropped_tile_o_err=list(fault), ring_vs_plain_err=list(ring_err),
         all_padded_block_kept=True, shapes_bit_equal=True,
         cta_shape=ra._shape("fwd", B, H, Nl, Nl, Dh, cuda),
         ms=ms15, ms_kv_f32=ms15_kv32, plain_ms=plain15, bound_ms=b_ms,
         bound_by=b_by, **ring_rates(flops, ms15, b_ms, dev15), flops=flops,
         bytes=nbytes,
         ring_ms=ring_ms, sdpa_f32_unsharded_ms=sdpa_ms,
         ptxas=ptxas("ring_fwd_kernel"))
    out["_ring_block_step"] = dict(
        max_abs_err=max(e[0] for c in errs.values() for e in c.values()),
        ms=ms15, plain_ms=plain15, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, **dev15,
        yardstick={"ring_16_launches_ms": ring_ms,
                   "sdpa_f32_unsharded_ms": sdpa_ms})
    del q, k, v, qf, kf, vf, ring, ring_plain, cases, args, args32
    torch.cuda.empty_cache()

    # -- kernels 16/17: batch 4 x 8,192 frames (valid 8,192, 8,100, 7,950,
    # 7,000: shard 3 partly padded) over 4 shards of 2,048, f32, dropout
    # 0.3. Checked and timed: shard 1 at t = 1 folding shard 0's (fully
    # valid) block, k0 = 0; the backward of the same step from the final
    # forward carries
    B, N, rate = 4, 8192, 0.3
    Nl = N // P
    dseed = int(rng.integers(0, 2**31 - 2))
    mask = torch.ones(B, N, dtype=torch.bool, device=cuda)
    for b, n in enumerate((8192, 8100, 7950, 7000)):
        mask[b, :n] = False
    q, k, v, g = (rand(B, N) for _ in range(4))
    q32 = [shard(q, s) * scale for s in range(P)]
    ks, vs = ([shard(t, s) for s in range(P)] for t in (k, v))
    ms = [shard(mask, s, 1) for s in range(P)]
    info = lambda t, s=1, sd=dseed: (sd, 0, s * Nl,  # noqa: E731
                                     ((s - t) % P) * Nl)
    carry = ra.ring_train_step_reference(q32[1], ks[1], vs[1], ms[1],
                                         info(0), *ra._init_carries(q32[1]),
                                         rate)
    fargs = (q32[1], ks[0], vs[0], ms[0])
    before = ra._ring_train_step.launches
    got = ra._ring_train_step(*fargs, info(1), *carry, rate)
    want = ra.ring_train_step_reference(*fargs, info(1), *carry, rate)
    torch.cuda.synchronize()
    if ra._ring_train_step.launches != before + 1:
        raise AssertionError("kernel 16 did not launch")
    err16 = {"t1_block_0": check_carries(got, want, "kernel 16")}
    faults16 = {}
    for fname, finfo in (("seed_plus_one", info(1, sd=dseed + 1)),
                         ("k0_neighbour", info(0))):
        bad = ra._ring_train_step(*fargs, finfo, *carry, rate)
        if carries_within(bad, want):
            raise AssertionError(f"kernel 16: the {fname} fault passes")
        faults16[fname] = errors(bad[0], want[0])[1]
    # a block whose keys are all padded passes the carry through
    kept = ra._ring_train_step(*fargs[:3], torch.ones_like(ms[0]), info(1),
                               *carry, rate)
    if not all(torch.equal(a, b) for a, b in zip(kept, carry)):
        raise AssertionError("kernel 16: an all-padded block moved the carry")
    # shard 3's block (t = 2 on shard 1): whole padded key tiles at the end
    # of three of its rows, skipped
    fargs3 = (q32[1], ks[3], vs[3], ms[3])
    err16["t2_padded_block_3"] = check_carries(
        ra._ring_train_step(*fargs3, info(2), *carry, rate),
        ra.ring_train_step_reference(*fargs3, info(2), *carry, rate),
        "kernel 16 t2_padded_block_3")
    for name, fa, i in (("t1_block_0", fargs, info(1)),
                        ("t2_padded_block_3", fargs3, info(2))):
        ring_shapes_agree(ra, lambda: ra._ring_train_step(*fa, i, *carry,
                                                          rate),
                          f"kernel 16 {name}")
    ms16 = cuda_ms(lambda: ra._ring_train_step(*fargs, info(1), *carry,
                                               rate), reps=20)
    dev16 = ring_device(lambda: ra._ring_train_step(*fargs, info(1), *carry,
                                                    rate))
    plain16 = cuda_ms(lambda: ra.ring_train_step_reference(
        *fargs, info(1), *carry, rate), reps=5)
    # the backward step: final (m, l) of shard 1 from the whole plain ring
    c = ra._init_carries(q32[1])
    for t in range(P):
        blk = (1 - t) % P
        c = ra.ring_train_step_reference(q32[1], ks[blk], vs[blk], ms[blk],
                                         info(t), *c, rate)
    o1 = ra._normalize(c[0], c[2], torch.float32)
    g1 = shard(g, 1)
    d1 = (g1 * o1).sum(-1, keepdim=True)
    partial = tuple(0.01 * torch.randn_like(t)
                    for t in (q32[1], ks[0], vs[0]))
    bargs = lambda i: (q32[1], ks[0], vs[0], g1, d1, c[1], c[2],  # noqa
                       ms[0], i, *partial, rate)
    before = ra._ring_train_step_bwd.launches
    grads = ra._ring_train_step_bwd(*bargs(info(1)))
    again = ra._ring_train_step_bwd(*bargs(info(1)))
    torch.cuda.synchronize()
    if ra._ring_train_step_bwd.launches != before + 2:
        raise AssertionError("kernel 17 did not launch")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("kernel 17: two backward runs differ")
    want_g = ra.ring_train_step_bwd_reference(*bargs(info(1)))
    gtol = TOL[RING_GRAD]
    err17 = {n: check_close(a, b, scaled(gtol, b), f" (kernel 17: d{n})")
             for n, a, b in zip("qkv", grads, want_g)}
    faults17 = {}
    for fname, finfo in (("seed_plus_one", info(1, sd=dseed + 1)),
                         ("k0_neighbour", info(0))):
        bad = ra._ring_train_step_bwd(*bargs(finfo))
        if any(within(a, b, scaled(gtol, b)) for a, b in zip(bad, want_g)):
            raise AssertionError(f"kernel 17: the {fname} fault passes")
        faults17[fname] = errors(bad[0], want_g[0])[1]
    # a block whose keys are all padded passes dq, dk, dv through
    kept = ra._ring_train_step_bwd(*bargs(info(1))[:7],
                                   torch.ones_like(ms[0]), info(1),
                                   *partial, rate)
    if not all(torch.equal(a, b) for a, b in zip(kept, partial)):
        raise AssertionError("kernel 17: an all-padded block moved dq/dk/dv")
    bargs3 = (q32[1], ks[3], vs[3], g1, d1, c[1], c[2], ms[3], info(2),
              *partial, rate)
    err17 = {"t1_block_0": err17, "t2_padded_block_3": {
        n: check_close(a, b, scaled(gtol, b),
                       f" (kernel 17 t2_padded_block_3: d{n})")
        for n, a, b in zip("qkv", ra._ring_train_step_bwd(*bargs3),
                           ra.ring_train_step_bwd_reference(*bargs3))}}
    for name, ba in (("t1_block_0", bargs(info(1))),
                     ("t2_padded_block_3", bargs3)):
        ring_shapes_agree(ra, lambda: ra._ring_train_step_bwd(*ba),
                          f"kernel 17 {name}")
    ms17 = cuda_ms(lambda: ra._ring_train_step_bwd(*bargs(info(1))),
                   reps=20)
    dev17 = ring_device(lambda: ra._ring_train_step_bwd(*bargs(info(1))))
    plain17 = cuda_ms(lambda: ra.ring_train_step_bwd_reference(
        *bargs(info(1))), reps=3, warmup=1)
    # the whole training ring (16 + 16 launches) against SDPA(dropout 0.3)
    # over the unsharded f32 sequence, forward and forward + backward
    split = lambda t, d=2: [shard(t, s, d) for s in range(P)]  # noqa: E731
    ring_f = lambda qq, kk, vv: ra.ring_attention_train(  # noqa: E731
        split(qq), split(kk), split(vv), split(mask, 1), scale, dseed, rate)
    gs = split(g)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def ring_fb():
        outs = ring_f(ql, kl, vl)
        torch.autograd.backward(outs, gs)

    with torch.no_grad():
        train_ring_ms = cuda_ms(lambda: ring_f(q, k, v), reps=3)
    train_ring_fb_ms = cuda_ms(ring_fb, reps=3)
    keep = ~mask[:, None, None, :]
    sdpa_f = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, dropout_p=rate, scale=scale), reps=5)
    sdpa_fb = cuda_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=keep, dropout_p=rate,
        scale=scale).backward(g), reps=5)
    del ql, kl, vl
    row = B * H * Nl
    for (route, ms_, plain_, flops, nbytes, errs_, faults_, ring_ms_, sd_ms,
         kernels, shape, dev_) in (
            ("_ring_train_step", ms16, plain16, 4 * row * Nl * Dh,
             row * Dh * 20 + row * 16 + B * Nl, err16, faults16,
             train_ring_ms, sdpa_f, ("ring_fwd_kernel",),
             {"fwd": ra._shape("fwd", B, H, Nl, Nl, Dh, cuda)}, dev16),
            ("_ring_train_step_bwd", ms17, plain17, 10 * row * Nl * Dh,
             row * Dh * 40 + row * 12 + B * Nl, err17, faults17,
             train_ring_fb_ms, sdpa_fb, ("ring_dq_kernel",
                                         "ring_dkdv_kernel"),
             {k: ra._shape(k, B, H, Nl, Nl, Dh, cuda)
              for k in ("dq", "dkdv")}, dev17)):
        b_ms, b_by = bound(flops, nbytes)
        emit("ring_kernel", route=RING_NAMES[route], B=B, H=H, Nl=Nl, Dh=Dh,
             shards=P, rate=rate, valid=[8192, 8100, 7950, 7000],
             errors=errs_, faults_rel_rms=faults_,
             deterministic=route.endswith("bwd") or None,
             all_padded_block_kept=True, shapes_bit_equal=True,
             cta_shape=shape, ms=ms_, plain_ms=plain_, bound_ms=b_ms,
             bound_by=b_by, **ring_rates(flops, ms_, b_ms, dev_), flops=flops,
             bytes=nbytes, ring_ms=ring_ms_, sdpa_f32_unsharded_ms=sd_ms,
             ptxas=ptxas(*kernels))
        out[route] = dict(
            max_abs_err=max(e[0] for c in errs_.values()
                            for e in c.values()),
            ms=ms_, plain_ms=plain_, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, **dev_,
            yardstick={("ring_fwd_bwd_32_launches_ms" if route.endswith(
                "bwd") else "ring_fwd_16_launches_ms"): ring_ms_,
                "sdpa_f32_unsharded_ms": sd_ms})
    del q, k, v, g
    torch.cuda.empty_cache()
    emit("ring_cta_variants", grids=ring_cta_variants(ra))
    emit("ring_past_tpu_envelope",
         **ring_past_envelope(ra, rand, shard, scale))
    torch.cuda.empty_cache()
    return out


def ring_cta_variants(ra) -> list:
    """Each ring kernel in each of its CTA shapes (``ring_shapes``) at the
    grids the main paths give it, no key padded: kernel 15 at a 16,384- and
    a 140,000-frame request's shards (1, 4, 4,096 / 35,072; bf16 K/V), 16
    and 17 at (4, 4, 2,048) (this phase's) and (4, 4, 2,304) (the seq
    step's over 9,216 frames), f32, rate 0.3; at head_dim 64 (the
    flagship's), 96 and 128 (the heads of the d 384 / 768 and d 512
    models; one shape a kernel there, timed all the same). Per grid: each
    ring kernel's device ms (``torch.profiler``) in each of its shapes,
    timed in turns (the shapes in order, then reversed; the backward's dQ
    and dK/dV both in their i-th shape, or their last), the CTAs of each
    shape an SM holds and the shape ``ring_cta_shape`` picks: the
    comparison behind that rule. The carries and grads are random (every
    shape does the same work on any values)."""
    import torch

    cuda = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    H = 4
    pick = ra.ring_cta_shape
    nth = lambda kernel, Dh, i: ra.ring_shapes(kernel, Dh)[  # noqa: E731
        min(i, len(ra.ring_shapes(kernel, Dh)) - 1)]
    lines = []
    for Dh, (route, B, N) in itertools.product(
            (64, 96, 128), (("_ring_block_step", 1, 4096),
                            ("_ring_block_step", 1, 35072),
                            ("_ring_train_step", 4, 2048),
                            ("_ring_train_step", 4, 2304),
                            ("_ring_train_step_bwd", 4, 2048),
                            ("_ring_train_step_bwd", 4, 2304))):
        kernels = ("dq", "dkdv") if route.endswith("bwd") else ("fwd",)
        n = max(len(ra.ring_shapes(kk, Dh)) for kk in kernels)
        q, k, v, o = (torch.randn(B, H, N, Dh, device=cuda, generator=gen)
                      for _ in range(4))
        m, d = (torch.randn(B, H, N, 1, device=cuda, generator=gen)
                for _ in range(2))
        l = torch.rand(B, H, N, 1, device=cuda, generator=gen) + 1.0
        mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
        info = (7, 0, N, 0)
        if route == "_ring_block_step":
            kb, vb = k.bfloat16(), v.bfloat16()
            call = lambda: ra._ring_block_step(  # noqa: E731
                q, kb, vb, mask, o, m, l)
        elif route == "_ring_train_step":
            call = lambda: ra._ring_train_step(  # noqa: E731
                q, k, v, mask, info, o, m, l, 0.3)
        else:
            call = lambda: ra._ring_train_step_bwd(  # noqa: E731
                q, k, v, o, d, m, l, mask, info, o, k, v, 0.3)
        times = {kk: {} for kk in kernels}
        try:
            for order in (range(n), reversed(range(n))):
                for i in order:
                    ra.ring_cta_shape = (
                        lambda kernel, B, H, N, Dh, sms, slots, i=i:
                        nth(kernel, Dh, i))
                    got = ring_kernel_ms(call)
                    for kk in kernels:
                        times[kk].setdefault(str(nth(kk, Dh, i)),
                                             []).append(got[kk])
        finally:
            ra.ring_cta_shape = pick
        lines.append({
            "route": RING_NAMES[route], "B": B, "H": H, "N": N, "Dh": Dh,
            "kernel_ms": times,
            "picked": {kk: ra._shape(kk, B, H, N, N, Dh, cuda)
                       for kk in kernels},
            "slots": {kk: {str(sh): ra._card_slots(kk, Dh, N)(*sh)
                           for sh in ra.ring_shapes(kk, Dh)}
                      for kk in kernels}})
        del q, k, v, o, m, d, l, call
        torch.cuda.empty_cache()
    return lines


def ring_past_envelope(ra, rand, shard, scale: float) -> dict:
    """Kernels 15-17 at lengths past the TPU kernels' VMEM envelope, where
    the CUDA routes take them all the same: kernel 15 at Nl 8,192 (> 6,912;
    a 32,768-frame request over 4 shards, bf16 K/V), kernels 16/17 at Nl
    4,096 (> 2,944; a 16,384-frame video, f32, dropout 0.3), one ring step
    each against its plain step. Returns the errors."""
    import torch

    P = RING_SHARDS
    cuda = torch.device("cuda")
    B, N = 1, 32768
    Nl = N // P
    if ra._ring_block_supported(Nl, Nl, 64, 4):
        raise AssertionError(f"Nl {Nl} lies inside kernel 15's TPU envelope")
    mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
    mask[:, N - 3000:] = True
    q, k, v = (rand(B, N, torch.bfloat16) for _ in range(3))
    q32 = shard(q, 1).float() * scale
    own = (shard(k, 1), shard(v, 1), shard(mask, 1, 1))
    carry = ra.ring_block_step_reference(q32, *own, *ra._init_carries(q32))
    args = (q32, shard(k, 3), shard(v, 3), shard(mask, 3, 1), *carry)
    before = ra._ring_block_step.launches
    got = ra._ring_block_step(*args)
    if ra._ring_block_step.launches != before + 1:
        raise AssertionError("kernel 15 did not launch past the envelope")
    err15 = check_carries(got, ra.ring_block_step_reference(*args),
                          f"kernel 15 at Nl {Nl}")
    del q, k, v, q32, own, carry, args, got
    torch.cuda.empty_cache()

    B, N, rate = 1, 16384, 0.3
    Nl = N // P
    if ra._ring_train_supported(Nl, Nl, 64):
        raise AssertionError(f"Nl {Nl} lies inside kernels 16/17's TPU "
                             f"envelope")
    mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
    mask[:, 16000:] = True
    q, k, v, g = (rand(B, N) for _ in range(4))
    q32 = shard(q, 3) * scale
    kb, vb, mb = shard(k, 2), shard(v, 2), shard(mask, 2, 1)
    info = (12345, 0, 3 * Nl, 2 * Nl)
    carry = ra.ring_train_step_reference(q32, shard(k, 3), shard(v, 3),
                                         shard(mask, 3, 1),
                                         (12345, 0, 3 * Nl, 3 * Nl),
                                         *ra._init_carries(q32), rate)
    before = (ra._ring_train_step.launches, ra._ring_train_step_bwd.launches)
    got = ra._ring_train_step(q32, kb, vb, mb, info, *carry, rate)
    want = ra.ring_train_step_reference(q32, kb, vb, mb, info, *carry, rate)
    err16 = check_carries(got, want, f"kernel 16 at Nl {Nl}")
    o = ra._normalize(want[0], want[2], torch.float32)
    g3 = shard(g, 3)
    d = (g3 * o).sum(-1, keepdim=True)
    partial = tuple(0.01 * torch.randn_like(t) for t in (q32, kb, vb))
    bargs = (q32, kb, vb, g3, d, want[1], want[2], mb, info, *partial, rate)
    grads = ra._ring_train_step_bwd(*bargs)
    torch.cuda.synchronize()
    if (ra._ring_train_step.launches, ra._ring_train_step_bwd.launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError("kernels 16/17 did not launch past the envelope")
    gtol = TOL[RING_GRAD]
    err17 = {n: check_close(a, b, scaled(gtol, b),
                            f" (kernel 17 at Nl {Nl}: d{n})")
             for n, a, b in zip("qkv", grads,
                                ra.ring_train_step_bwd_reference(*bargs))}
    return {"ring_block": {"Nl": 8192, "errors": err15},
            "ring_train_fwd": {"Nl": Nl, "errors": err16},
            "ring_train_bwd": {"Nl": Nl, "errors": err17}}


MESH_SHORT = [320, 320, 320, 480, 480, 480, 512, 512]
MESH_LONG = [16384, 20000]


def phase_serve_mesh(seed: int) -> dict:
    """``ScoringService(mesh=<(1, 4) mesh of cuda:0>, long_threshold=8,192)``
    with the flagship bf16 weights: the short mix on the single-device batch
    path (the mesh's entries repeat one card, so they only shard the ring),
    a 16,384-frame (Nl 4,096) and a 20,000-frame (padded to 20,480, Nl
    5,120) request over the ring (kernel 15). Served scores equal the direct
    solo and ``make_seq_sharded_forward`` scores bit for bit; an f32
    16,384-frame long request lies within 2e-4 of the single-device f32
    route; the bf16 long requests' |dp| against the single-device route is
    reported. Then the default threshold (the single-device ladder's
    envelope, 139,136 frames in bf16): a 140,000-frame request (Nl 35,072)
    takes the ring and kernel 15, served == direct. Returns the launch
    counts of the first service."""
    import dataclasses

    import numpy as np
    import torch

    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.parallel import make_mesh, make_seq_sharded_forward
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.train.steps import make_eval_forward

    cfg, model = serve_model(seed)
    mesh = make_mesh((1, RING_SHARDS), "cuda:0")
    rng = np.random.default_rng(seed + 3)
    lengths = MESH_SHORT + MESH_LONG
    videos = [rng.random((n, cfg.in_features), dtype=np.float32)
              for n in lengths]
    with ScoringService(model, cfg, mesh=mesh, long_threshold=8192,
                        max_batch=8, max_delay_ms=50.0) as svc:
        reset_counters()
        t0 = time.monotonic()
        futs = [svc.submit(v, change_points=(shot_bounds(v.shape[0])
                                             if v.shape[0] >= 6000 else None))
                for v in videos]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        counts = read_counters()
        st = svc.stats()
    if svc._rep_fwd is not None or st.rows_moved:
        raise AssertionError("a mesh of one card took the replica route")
    short = counts["_fused_block"] + counts["_fused_block_grouped"]
    if not (counts["_ring_block_step"] and short
            and counts["gemm_bias_epilogue"]):
        raise AssertionError(f"mesh serving did not launch kernel 15 and the "
                             f"short routes' kernels: {counts}")
    if (st.completed != len(videos) or st.failed
            or st.long_requests != len(MESH_LONG)):
        raise AssertionError(f"mesh serving stats: {st}")

    fwd = make_eval_forward(cfg)
    seq = make_seq_sharded_forward(cfg, mesh)
    granule = svc.bucket * RING_SHARDS
    dp = []
    for v, r in zip(videos, results):
        n = v.shape[0]
        check_summary(r, n)
        x, mask = padded(cfg, v)
        single = fwd(model, x, mask)[0, :n].float().cpu().numpy()
        if n <= 8192:
            direct = single
        else:
            xl, ml = padded(cfg, v, granule)
            direct = torch.sigmoid(seq(model, xl, ml)[0][0, :n, 0]).float(
            ).cpu().numpy()
            dp.append(np.abs(r.scores - single))
        if not np.array_equal(direct, r.scores):
            raise AssertionError(
                f"mesh served != direct for a {n}-frame request (max diff "
                f"{float(np.abs(direct - r.scores).max())})")
    d = np.concatenate(dp)
    bf16_vs_single = {"median": float(np.median(d)), "max": float(d.max())}

    # f32: the long route against the single-device f32 route
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = SimNet(cfg32, generator=torch.Generator().manual_seed(seed))
    v = videos[len(MESH_SHORT)]
    n = v.shape[0]
    with ScoringService(model32, cfg32, mesh=mesh, long_threshold=8192,
                        max_delay_ms=5.0) as svc32:
        r32 = svc32.submit(v, want_summary=False).result(timeout=600)
        if svc32.stats().long_requests != 1:
            raise AssertionError("the f32 long request did not take the ring")
    x, mask = padded(cfg32, v)
    single32 = make_eval_forward(cfg32)(model32, x, mask)[0, :n].float(
    ).cpu().numpy()
    f32_err = float(np.abs(r32.scores - single32).max())
    if not f32_err <= 2e-4:
        raise AssertionError(f"f32 long route off the single-device route by "
                             f"{f32_err} (bound 2e-4)")
    del model32, svc32
    default = serve_default_threshold(cfg, model, mesh, seq, granule, rng)
    emit("serve_mesh", mesh=[1, RING_SHARDS], devices=["cuda:0"] * 4,
         lengths=lengths, long_threshold=8192, wall_s=wall,
         long_requests=st.long_requests, batches=st.batches,
         batch_hist=st.batch_hist, rows_moved=st.rows_moved,
         latency_s=[round(r.latency_s, 6) for r in results],
         launches=counts, served_equals_direct=True,
         bf16_long_vs_single_device_dp=bf16_vs_single,
         f32_long_vs_single_device_max_abs=f32_err, f32_bound=2e-4,
         default_threshold=default)
    return counts


def serve_default_threshold(cfg, model, mesh, seq, granule, rng) -> dict:
    """A request just past the default long_threshold through a service
    built without one: it takes the ring, each of the model's layers
    launches kernel 15 P x P times, and the served scores equal the direct
    ``make_seq_sharded_forward`` scores bit for bit."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.serve import ScoringService

    n = 140000
    v = rng.random((n, cfg.in_features), dtype=np.float32)
    with ScoringService(model, cfg, mesh=mesh, max_delay_ms=5.0) as svc:
        threshold = svc._long_threshold
        if not threshold < n:
            raise AssertionError(f"default long_threshold {threshold} is not "
                                 f"below {n}")
        reset_counters()
        t0 = time.monotonic()
        r = svc.submit(v, want_summary=False).result(timeout=600)
        wall = time.monotonic() - t0
        counts = read_counters()
        st = svc.stats()
    want = RING_SHARDS ** 2 * cfg.num_layers
    if st.long_requests != 1 or counts["_ring_block_step"] != want:
        raise AssertionError(
            f"a {n}-frame request at the default threshold: long_requests "
            f"{st.long_requests}, kernel 15 launches "
            f"{counts['_ring_block_step']} (expected {want})")
    if r.scores.shape != (n,) or not np.all((r.scores > 0)
                                            & (r.scores < 1)):
        raise AssertionError(f"bad scores for the {n}-frame request")
    xl, ml = padded(cfg, v, granule)
    direct = torch.sigmoid(seq(model, xl, ml)[0][0, :n, 0]).float().cpu(
    ).numpy()
    if not np.array_equal(direct, r.scores):
        raise AssertionError(
            f"mesh served != direct for the {n}-frame request (max diff "
            f"{float(np.abs(direct - r.scores).max())})")
    return {"long_threshold": threshold, "frames": n,
            "Nl": int(ml.shape[1]) // RING_SHARDS, "wall_s": wall,
            "ring_block_launches": counts["_ring_block_step"],
            "served_equals_direct": True}


def phase_ring_multi_card(seed: int) -> None:
    """With two or more cards, the 16,384-frame ring on a (1, 4) mesh that
    alternates two cards (the rotation is a peer copy) against the same ring
    on one card, bit for bit; with one card, a stated skip."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.parallel.mesh import make_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        emit("ring_multi_card", skipped=f"{n_cards} card(s)")
        return
    ra = ring_module()
    cfg = ModelConfig()
    rng = np.random.default_rng(seed + 9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, cfg.num_heads, 16384,
                                                 cfg.head_dim)).astype(
        np.float32)).to("cuda:0", torch.bfloat16) for _ in range(3))
    mask = torch.zeros(1, 16384, dtype=torch.bool, device="cuda:0")
    mask[:, 15000:] = True
    one = ra.make_ring_forward(make_mesh((1, RING_SHARDS), "cuda:0"),
                               cfg.attn_scale)
    two = ra.make_ring_forward(make_mesh((1, RING_SHARDS),
                                         ["cuda:0", "cuda:1"]),
                               cfg.attn_scale)
    a, b = one(q, k, v, mask), two(q, k, v, mask)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("the ring over two cards differs from one card")
    emit("ring_multi_card", cards=n_cards, devices=["cuda:0", "cuda:1"] * 2,
         bit_equal=True, one_card_ms=cuda_ms(lambda: one(q, k, v, mask), 3),
         two_cards_ms=cuda_ms(lambda: two(q, k, v, mask), 3))


# layers of the seq-train step's card-against-CPU check: the CPU's plain
# ring at 8,192 frames (the hash masks and the recompute over (1, 4, 2,048,
# 2,048) blocks) took 55-80 s for a 2-layer step on an H100 host's 8
# cores, so it runs 1 of the flagship's 4 (the line says so in "layers",
# and its time in "wall_s"), which keeps the run short. The N 8,320 check
# against the plain ring on the card runs all 4: the later layers' dropout
# seeds, the residual gradients fed into an earlier layer's ring backward
# and the dx that kernel 17 hands up the stack are held there
SEQ_CPU_LAYERS = 1


def phase_seq_train(seed: int, long_videos: list) -> dict:
    """``make_seq_sharded_finetune_step`` on a (1, 4) mesh of cuda:0: one
    step on one 8,100-frame video (bucket 8,192, f32, dropout 0.3) against
    the same step on the CPU's plain path with the same seeds (per
    parameter, the step bound), one step at N 8,320 (shards of 2,080
    frames, padded to 2,112) against the plain ring on the card, then 5
    recipe epochs (10 steps, batch 4)
    over phase_long_train's videos in buckets of 512 (Nl <= 2,304). Kernels
    16 and 17 must launch P x P times per layer per step, the flash and
    block training kernels never. Returns the launch counts."""
    import copy
    import dataclasses
    import math

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import finetune_recipe
    from vidsum_tpu_torch.data.collate import pad_batch
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.parallel import (
        make_mesh, make_seq_sharded_finetune_step,
    )
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.steps import make_optimizer

    conf = finetune_recipe()
    cfg, tc = conf.model, conf.train
    P = RING_SHARDS
    rng = np.random.default_rng(seed + 10)
    mesh = make_mesh((1, P), "cuda:0")
    routes = ("_ring_train_step", "_ring_train_step_bwd")
    others = TRAIN_ROUTES + tuple(attn_train_name(r)
                                  for r in ATTN_TRAIN_ROUTES)

    # one step, card against CPU
    ccfg = dataclasses.replace(cfg, num_layers=SEQ_CPU_LAYERS)
    model = SimNet(ccfg, generator=torch.Generator().manual_seed(seed + 2))
    [item] = synthetic_videos(rng, [8100], cfg.in_features)
    xb, tb, mb = pad_batch([item[0]], [item[1]])
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, ccfg.num_layers)]
    results, t_s = [], {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        step = make_seq_sharded_finetune_step(
            ccfg, make_mesh((1, P), "cuda:0" if dev == "cuda" else "cpu"))
        reset_counters()
        t0 = time.monotonic()
        loss = step(m, make_optimizer(m, tc.lr, tc.weight_decay), xb, tb,
                    mb, seeds=seeds)
        results.append((float(loss), {k: p.grad.detach().float().cpu()
                                      for k, p in m.named_parameters()}))
        t_s[dev] = time.monotonic() - t0
        counts = read_counters()
        want = [P * P * ccfg.num_layers if dev == "cuda" else 0] * 2
        if [counts[r] for r in routes] != want:
            raise AssertionError(f"seq step on {dev}: launches "
                                 f"{[counts[r] for r in routes]}, expected "
                                 f"{want}")
    card_vs_cpu = dict(B=1, N=int(mb.shape[1]), layers=ccfg.num_layers,
                       wall_s=t_s, **compare_steps(results, "seq step"))

    # a bucket that is an odd multiple of 128: N 8,320 gives shards of
    # 2,080 frames, not a multiple of the ring kernels' 64-key tile; the
    # step pads them to 2,112. The kernels against the plain ring on the
    # card, the flagship's 4 layers, same seeds (the step bound)
    [item] = synthetic_videos(rng, [8200], cfg.in_features)
    xo, to_, mo = pad_batch([item[0]], [item[1]])
    if xo.shape[1] != 8320:
        raise AssertionError(f"an 8,200-frame video buckets to "
                             f"{xo.shape[1]} frames")
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed + 3))
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, cfg.num_layers)]
    results = []
    for impl in ("auto", "plain"):
        m = copy.deepcopy(model).to("cuda")
        step = make_seq_sharded_finetune_step(cfg, mesh, block_impl=impl)
        reset_counters()
        loss = step(m, make_optimizer(m, tc.lr, tc.weight_decay), xo, to_,
                    mo, seeds=seeds)
        results.append((float(loss), {k: p.grad.detach().float().cpu()
                                      for k, p in m.named_parameters()}))
        counts = read_counters()
        want = [P * P * cfg.num_layers if impl == "auto" else 0] * 2
        if [counts[r] for r in routes] != want:
            raise AssertionError(f"seq step at N 8,320 ({impl}): launches "
                                 f"{[counts[r] for r in routes]}, expected "
                                 f"{want}")
    odd_bucket = dict(B=1, N=int(mo.shape[1]), Nl=int(mo.shape[1]) // P,
                      Nl_padded=-(-int(mo.shape[1]) // (64 * P)) * 64,
                      layers=cfg.num_layers,
                      **compare_steps(results, "seq step at N 8,320, "
                                               "kernels against the plain "
                                               "ring"))
    del model, results

    # recipe epochs over the long-video set, buckets of 512
    dconf = dataclasses.replace(conf, data=dataclasses.replace(
        conf.data, length_bucket=512))
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed))
    step = make_seq_sharded_finetune_step(cfg, mesh)
    optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
    times, losses, shapes = [], [], []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(*args)
        end.record()
        times.append((start, end))
        losses.append(loss)
        shapes.append(tuple(np.shape(args[2])[:2]))
        return loss

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    epoch_losses = [ft._train_epoch(timed, model, optimizer, long_videos,
                                    dconf, *ft.epoch_streams(tc.seed, 2,
                                                             epoch))
                    for epoch in range(LONG_EPOCHS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    counts = read_counters()
    n_steps = len(losses)
    expected = P * P * cfg.num_layers * n_steps
    if [counts[r] for r in routes] != [expected] * 2:
        raise AssertionError(f"seq-train epochs: launches "
                             f"{[counts[r] for r in routes]}, expected "
                             f"{expected} each")
    moved = [r for r in others if counts[r]]
    if moved:
        raise AssertionError(f"seq-train epochs launched {moved}")
    step_losses = [float(x) for x in losses]
    if not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"non-finite losses: {step_losses}")
    xl, tl, ml = (torch.from_numpy(a).cuda() for a in pad_batch(
        [it[0] for it in long_videos[:tc.batch_size]],
        [it[1] for it in long_videos[:tc.batch_size]], bucket=512))
    gen = torch.Generator().manual_seed(seed)
    emit("seq_train", mesh=[1, P], devices=["cuda:0"] * P,
         card_vs_cpu=card_vs_cpu, odd_bucket=odd_bucket, steps=n_steps,
         batch_shapes=shapes,
         step_ms=spread([s.elapsed_time(e) for s, e in times]),
         wall_s=wall, peak_memory_gib=peak_gb, epoch_loss=epoch_losses,
         step_losses=step_losses, launches={r: counts[r] for r in routes},
         launches_per_step={r: counts[r] / n_steps for r in routes},
         step_profile=device_profile(
             lambda: step(model, optimizer, xl, tl, ml, gen), reps=2))
    return {r: counts[r] for r in routes}


# ------------------------------------------------------- the multi-GPU modes
# Every mode runs over a mesh whose entries all name cuda:0 (the machine
# has one card): the arithmetic, the kernels and their launch counts are
# those of D cards, and the moves between entries are the tensors themselves.
DP_ENTRIES = 4
MESH_REPS = 5        # timed steps per mode (CUDA events, after 2 warm-ups)
DIST_EPOCHS = 2


def grads_of(model) -> dict:
    return {k: p.grad.detach().float().cpu()
            for k, p in model.named_parameters()}


def stepped(step, model, *args, lr=1e-3, wd=1e-4, **kw) -> tuple:
    """One step of ``step`` on a copy of ``model`` with a fresh optimizer:
    ``(loss, grads, the stepped copy)``."""
    import copy

    from vidsum_tpu_torch.train.steps import make_optimizer

    m = copy.deepcopy(model)
    loss = step(m, make_optimizer(m, lr, wd), *args, **kw)
    return float(loss), grads_of(m), m


def must_fail(check, what: str) -> str:
    """Run ``check`` (a comparison with a planted fault); it must raise
    ``AssertionError``. Returns the head of its message."""
    try:
        check()
    except AssertionError as e:
        return str(e)[:240]
    raise AssertionError(f"the planted fault ({what}) passed the check")


class patched:
    """``setattr(mod, name, fn)`` while the ``with`` block runs."""

    def __init__(self, mod, name: str, fn) -> None:
        self.mod, self.name, self.fn = mod, name, fn

    def __enter__(self):
        self.saved = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.fn)

    def __exit__(self, *exc) -> None:
        setattr(self.mod, self.name, self.saved)


def ragged_batch(rng, B: int, N: int, in_features: int, low: int):
    """(x, target, pad_mask) numpy with video lengths in [low, N) and the
    first video N long, so a data shard's longest video differs from the
    batch's (a denominator taken per shard shows)."""
    import numpy as np

    x = rng.normal(size=(B, N, in_features)).astype(np.float32)
    t = rng.random((B, N)).astype(np.float32)
    lengths = rng.integers(low, N, B)
    lengths[0] = N
    mask = np.arange(N)[None] >= lengths[:, None]
    return x, t, mask


def step_ms(step, model, *args, profile: bool = False, **kw) -> dict:
    """CUDA-event ms of ``MESH_REPS`` steps (two warm-ups) on a copy; with
    ``profile`` also ``device_profile`` of 3 more (wall, device ms, busy
    share, the top kernels)."""
    import copy

    from vidsum_tpu_torch.train.steps import make_optimizer

    m = copy.deepcopy(model)
    opt = make_optimizer(m, 1e-3, 1e-4)
    out = spread(cuda_times(lambda: step(m, opt, *args, **kw),
                            reps=MESH_REPS))
    if profile:
        out["profile"] = device_profile(lambda: step(m, opt, *args, **kw),
                                        reps=3, groups={
                                            "bt_gemm": ("bt_gemm",)})
    return out


def phase_dp_train(seed: int) -> dict:
    """``parallel.dp_shardmap.make_dp_shardmap_finetune_step`` on a (4, 1)
    mesh of cuda:0 at the flagship width: each shard's forward and backward
    on the fused block's training kernels (TPU kernels 9-12). (a) At dropout
    0 one step at (32, 512) against the one-device fused-block step (the
    step bound per parameter), with a planted fault (the last shard's
    gradients dropped from the sum) that must fail it; (b) at dropout 0.3
    against a replay of the four shards' single-device forwards on the same
    seeds, two runs bit-equal; (c) a padded final batch (5 videos at batch
    4 on a (2, 1) mesh, the repeats weighed 0) against the one-video step;
    step ms beside the one-device step's. Returns the launches of rows
    9-12 in the dp steps."""
    import dataclasses

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import MeshConfig, ModelConfig
    from vidsum_tpu_torch.data.collate import (
        item_weights, make_batches, pad_batch,
    )
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops.losses import mse_with_mask_loss
    from vidsum_tpu_torch.parallel import dp_shardmap, make_mesh
    from vidsum_tpu_torch.train.steps import make_finetune_step

    cfg = ModelConfig()
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    rng = np.random.default_rng(seed + 21)
    x, t, m = ragged_batch(rng, 32, 512, cfg.in_features, 384)
    model = SimNet(cfg0, generator=torch.Generator().manual_seed(seed))
    mesh = make_mesh(MeshConfig(data=DP_ENTRIES), ["cuda:0"] * DP_ENTRIES)
    dp0 = dp_shardmap.make_dp_shardmap_finetune_step(cfg0, mesh,
                                                     "fused_block")
    one = make_finetune_step(cfg0, "fused_block")
    gen = torch.Generator().manual_seed(seed)
    launches = {r: 0 for r in TRAIN_ROUTES}

    def counted(fn):
        reset_counters()
        out = fn()
        torch.cuda.synchronize()
        for r, n in read_counters().items():
            if r in launches:
                launches[r] += n
        return out

    got = counted(lambda: stepped(dp0, model, x, t, m, gen))
    want = stepped(one, model, x, t, m, gen)
    vs_one = compare_steps([got[:2], want[:2]], "dp step against the "
                           "one-device step")
    real = dp_shardmap.sum_shards

    def drop_last(per_shard):
        return real(per_shard[:-1] if len(per_shard) == DP_ENTRIES
                    else per_shard)

    with patched(dp_shardmap, "sum_shards", drop_last):
        bad = stepped(dp0, model, x, t, m, gen)
    fault = must_fail(lambda: compare_steps([bad[:2], want[:2]], "fault"),
                      "the last shard's grads dropped")

    # (b) dropout 0.3: the replay of the four shards on the same seeds
    model3 = SimNet(cfg, generator=torch.Generator().manual_seed(seed))
    seeds = [[int(s) for s in rng.integers(0, 2**31 - 1, cfg.num_layers)]
             for _ in range(DP_ENTRIES)]
    dp3 = dp_shardmap.make_dp_shardmap_finetune_step(cfg, mesh,
                                                     "fused_block")
    a = counted(lambda: stepped(dp3, model3, x, t, m, seeds=seeds))
    b = stepped(dp3, model3, x, t, m, seeds=seeds)
    twice = all(torch.equal(a[1][k], b[1][k]) for k in a[1]) and all(
        torch.equal(v, b[2].state_dict()[k])
        for k, v in a[2].state_dict().items())
    if not twice or a[0] != b[0]:
        raise AssertionError("two dp steps on the same seeds differ")
    rep = SimNet(cfg, device="cuda")
    rep.load_state_dict(model3.state_dict())
    Bl = x.shape[0] // DP_ENTRIES
    denom = float((~m).sum(1).max())
    total = 0.0
    for i in range(DP_ENTRIES):
        rows = slice(i * Bl, (i + 1) * Bl)
        scores, _ = rep(torch.from_numpy(x[rows]).cuda(),
                        torch.from_numpy(m[rows]).cuda(),
                        attn_impl="fused_block", deterministic=False,
                        generator=dp_shardmap.shard_generator(seeds[i]),
                        block_seeds=seeds[i])
        loss = mse_with_mask_loss(scores, torch.from_numpy(t[rows]).cuda(),
                                  torch.from_numpy(m[rows]).cuda(),
                                  denom_len=denom) / DP_ENTRIES
        loss.backward()
        total += float(loss.detach())
    vs_replay = compare_steps([a[:2], (total, grads_of(rep))],
                              "dp step at dropout 0.3 against its replay")

    # (c) the padded final batch: 5 videos at batch 4 on a (2, 1) mesh
    videos = [(rng.normal(size=(n, cfg.in_features)).astype(np.float32),
               rng.random(n).astype(np.float32))
              for n in rng.integers(100, 381, 5)]
    last = list(make_batches(5, 4, shuffle=False, pad_to_batch=True))[-1]
    xp, tp, mp = pad_batch([videos[i][0] for i in last],
                           [videos[i][1] for i in last])
    x1, t1, m1 = pad_batch([videos[4][0]], [videos[4][1]])
    mesh2 = make_mesh(MeshConfig(data=2), ["cuda:0"] * 2)
    dp2 = dp_shardmap.make_dp_shardmap_finetune_step(cfg0, mesh2,
                                                     "fused_block")
    padded_got = counted(lambda: stepped(dp2, model, xp, tp, mp, gen,
                                         item_weight=item_weights(last)))
    padded_want = stepped(one, model, x1, t1, m1, gen)
    vs_smaller = compare_steps([padded_got[:2], padded_want[:2]],
                               "padded final batch against the smaller "
                               "batch")
    missing = [r for r in TRAIN_ROUTES if launches[r] == 0]
    if missing:
        raise AssertionError(f"dp steps never launched {missing}")
    xc, tc_, mc = (torch.from_numpy(a_).cuda() for a_ in (x, t, m))
    ms = {"dp_4x1": step_ms(dp0, model, xc, tc_, mc, gen, profile=True),
          "one_device": step_ms(one, model, xc, tc_, mc, gen,
                                profile=True)}
    emit("dp_train", mesh=[DP_ENTRIES, 1], devices=["cuda:0"] * DP_ENTRIES,
         shape=[32, 512], width=dataclasses.asdict(cfg),
         vs_one_device=vs_one, planted_fault=fault,
         dropout_03_vs_replay=vs_replay, two_runs_bit_equal=True,
         padded_final_batch={"videos": [int(v[0].shape[0]) for v in videos],
                             "batch": last,
                             "weights": item_weights(last).tolist(),
                             "vs_smaller_batch": vs_smaller},
         step_ms=ms, launches=launches)
    return launches


def phase_tp_train(seed: int) -> None:
    """``parallel.train_parallel.make_sharded_finetune_step`` (dp x tp, the
    dense route: the JAX package's own for this mode) on (2, 2) and (1, 4)
    meshes of cuda:0 at (32, 512), dropout 0, against the one-device dense
    step (the step bound), with a planted fault (the last model shard's
    partial sums dropped) that must fail it; then
    ``make_sharded_pretrain_step`` on (2, 2) at the pretrain batch (256,
    384) against the one-device pretrain step (the fused block's kernels),
    by ``STEP_SPARE`` / ``STEP_CAP``; ``video_transform`` keeps its bits."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import (
        MeshConfig, ModelConfig, pretrain_recipe,
    )
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.parallel import make_mesh, train_parallel
    from vidsum_tpu_torch.train.schedule import reference_pretrain_schedule
    from vidsum_tpu_torch.train.steps import (
        make_finetune_step, make_optimizer, make_pretrain_step,
    )

    cfg0 = ModelConfig(dropout=0.0)
    rng = np.random.default_rng(seed + 22)
    x, t, m = ragged_batch(rng, 32, 512, cfg0.in_features, 384)
    model = SimNet(cfg0, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed)
    dense = make_finetune_step(cfg0, "dense")
    want = stepped(dense, model, x, t, m, gen)
    out = {}
    xc, tc_, mc = (torch.from_numpy(a).cuda() for a in (x, t, m))
    ms = {"one_device_dense": step_ms(dense, model, xc, tc_, mc, gen)}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(MeshConfig(*shape), ["cuda:0"] * 4)
        step = train_parallel.make_sharded_finetune_step(cfg0, mesh)
        got = stepped(step, model, x, t, m, gen)
        out[f"{shape[0]}x{shape[1]}"] = compare_steps(
            [got[:2], want[:2]], f"dp x tp step {shape}")
        ms[f"{shape[0]}x{shape[1]}"] = step_ms(step, model, xc, tc_, mc, gen)
        if shape == (2, 2):
            real = train_parallel.sum_partials
            with patched(train_parallel, "sum_partials",
                         lambda parts, dev: real(parts[:-1], dev)):
                bad = stepped(step, model, x, t, m, gen)
            fault = must_fail(lambda: compare_steps([bad[:2], want[:2]],
                                                    "fault"),
                              "the last model shard's partials dropped")

    # the pretrain step at the pretrain batch, against the one-device step
    conf = pretrain_recipe()
    pcfg = conf.pretrain
    mcfg = dataclasses.replace(conf.model, dropout=0.0)
    lengths = rng.integers(60, 385, pcfg.batch_size)
    lengths[0] = 384
    xp = rng.normal(size=(pcfg.batch_size, 384, mcfg.in_features)).astype(
        np.float32)
    mp = np.arange(384)[None] >= lengths[:, None]
    xp[mp] = 1000.0
    vp = rng.normal(size=(pcfg.batch_size, 512)).astype(np.float32)
    schedule = reference_pretrain_schedule(
        pcfg.lr, max(pcfg.scheduler_samples // pcfg.batch_size, 1),
        pcfg.warmup_epochs, pcfg.epochs)
    pmodel = PretrainModel(mcfg, pcfg, generator=torch.Generator()
                           .manual_seed(pcfg.seed))
    vt = {k: v.clone() for k, v in pmodel.video_transform.state_dict()
          .items()}
    res, losses, pt_ms = [], [], {}
    mesh = make_mesh(MeshConfig(2, 2), ["cuda:0"] * 4)
    for name, step in (
            ("2x2", train_parallel.make_sharded_pretrain_step(
                mcfg, pcfg, schedule, mesh)),
            ("one_device", make_pretrain_step(mcfg, pcfg, schedule))):
        pm = copy.deepcopy(pmodel)
        opt = make_optimizer([("encoder." + n, p) for n, p in
                              pm.encoder.named_parameters()], pcfg.lr,
                             pcfg.weight_decay)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = step(pm, opt, xp, vp, mp, gen)
        losses.append([float(v) for v in got.cpu()])
        pt_ms[name] = (time.monotonic() - t0) * 1e3
        res.append((losses[-1][0], grads_of(pm.encoder)))
        if any(not torch.equal(v, vt[k]) for k, v in
               pm.video_transform.state_dict().items()):
            raise AssertionError(f"video_transform moved on the {name} step")
    for what, a, b in zip(("total", "main", "center", "repel"), *losses):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"sharded pretrain {what} loss {a} != {b}")
    pretrain_cmp = compare_steps(res, "sharded pretrain step against the "
                                 "one-device step", STEP_SPARE, STEP_CAP)
    emit("tp_train", shape=[32, 512], route="dense", meshes=out,
         planted_fault=fault, step_ms=ms,
         pretrain={"mesh": [2, 2], "shape": [pcfg.batch_size, 384],
                   "losses": losses, "step_wall_ms": pt_ms,
                   "video_transform_bit_equal": True, **pretrain_cmp})


def phase_pp_train(seed: int) -> None:
    """``parallel.pipeline``: the forward and one train step on 2 and 4
    stages of cuda:0 at (32, 512), dropout 0, against the one-device dense
    forward (``SCORE_TOL``) and step (the step bound), with a planted fault
    (each layer streamed from the wrong owner) that must fail it."""
    import copy

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.parallel import make_mesh, pipeline
    from vidsum_tpu_torch.train.steps import make_finetune_step, make_optimizer

    cfg0 = ModelConfig(dropout=0.0)
    rng = np.random.default_rng(seed + 23)
    x, t, m = ragged_batch(rng, 32, 512, cfg0.in_features, 384)
    model = SimNet(cfg0, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        ref_scores, _ = model(torch.from_numpy(x).cuda(),
                              torch.from_numpy(m).cuda(), attn_impl="dense")
    want = stepped(make_finetune_step(cfg0, "dense"), model, x, t, m, gen)
    out = {}
    for stages in (2, 4):
        mesh = make_mesh((stages,), "cuda:0", ("stage",))
        fwd = pipeline.make_pp_forward(cfg0, mesh)(model, x, m)
        fwd_err = check_close(fwd, ref_scores, SCORE_TOL,
                              f" (pipeline forward, {stages} stages)")
        init, step = pipeline.make_pp_train_step(cfg0, mesh)

        def pp_step(net, *args, **kw):
            net = init(copy.deepcopy(net))
            loss = step(net, make_optimizer(net, 1e-3, 1e-4), *args, **kw)
            return float(loss), grads_of(net)

        got = pp_step(model, x, t, m, gen)
        out[stages] = {"forward": fwd_err,
                       **compare_steps([got, want[:2]],
                                       f"pipeline step, {stages} stages")}
        if stages == 4:
            real = pipeline.owner

            def wrong(layer, per_stage):
                stage, local = real(layer, per_stage)
                return (stage + 1) % stages, local

            with patched(pipeline, "owner", wrong):
                bad = pp_step(model, x, t, m, gen)
            fault = must_fail(lambda: compare_steps([bad, want[:2]],
                                                    "fault"),
                              "layers streamed from the wrong owner")
    emit("pp_train", shape=[32, 512], route="dense", stages=out,
         planted_fault=fault)


def dist_folds(seed: int):
    """The folds and the in-memory data of the distributed phase (and of
    its worker processes): ``finetune_videos`` under the seed of phase 7b,
    one fold of 16 train and 4 val videos."""
    import numpy as np

    conf_rng = np.random.default_rng(seed + 14)
    videos = finetune_videos(conf_rng, 1024)
    names = list(videos)
    test = names[:4]
    folds = [{"train_keys": [FT_KEY + n for n in names if n not in test],
              "test_keys": [FT_KEY + n for n in test]}]
    return folds, memory_fold_datasets(videos)


def dist_run(seed: int, workdir: str, mesh, max_epoch: int,
             resume: bool = False):
    """``finetune(mesh=)`` at the recipe's width over ``dist_folds``."""
    import dataclasses

    from vidsum_tpu_torch.config import finetune_recipe
    from vidsum_tpu_torch.train import finetune as ft

    conf = finetune_recipe()
    conf = dataclasses.replace(conf, train=dataclasses.replace(
        conf.train, max_epoch=max_epoch, use_pretrained=False))
    folds, fold_datasets = dist_folds(seed)
    with patched(ft, "fold_datasets", fold_datasets):
        return ft.finetune(conf, folds, workdir=workdir,
                           export_summary=False, resume=resume,
                           metrics_path=os.path.join(workdir, "m.jsonl"),
                           mesh=mesh)


def dist_worker(argv) -> int:
    """One process of the distributed phase (``chip_smoke.py --dist-worker
    PID PORT WORKDIR MAX_EPOCH RESUME KILL_AFTER SEED``): two processes on
    cuda:0 under gloo, each a 2-entry data mesh of it. With KILL_AFTER k > 0
    the coordinator exits hard (``os._exit(137)``) once its k-th state file
    is on disk. Prints one JSON line."""
    import torch

    from vidsum_tpu_torch.config import MeshConfig
    from vidsum_tpu_torch.parallel.distributed import (
        DistributedConfig, global_mesh, init_distributed, is_coordinator,
    )
    from vidsum_tpu_torch.train import checkpoint as ck

    pid, port, workdir, max_epoch, resume, kill_after, seed = argv
    kill_after = int(kill_after)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    backend = init_distributed(DistributedConfig(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=int(pid)))
    t_init = time.monotonic()
    if kill_after > 0 and is_coordinator():
        real = ck.AsyncCheckpointer.save
        saves = []

        def save_then_die(self, path, tree, meta=None):
            real(self, path, tree, meta)
            if os.path.basename(path) == "train_state.ckpt":
                saves.append(path)
                if len(saves) >= kill_after:
                    self.flush()
                    os._exit(137)
        ck.AsyncCheckpointer.save = save_then_die
    mesh = global_mesh(MeshConfig(data=4), ["cuda:0", "cuda:0"])
    res = dist_run(int(seed), workdir, mesh, int(max_epoch), resume == "1")
    torch.cuda.synchronize()
    t_done = time.monotonic()
    print(json.dumps({"rank": int(pid), "backend": backend,
                      "coordinator": is_coordinator(),
                      "mesh": mesh.shape, "fscore": res.fscore,
                      "wall_s": t_done - t0, "t_start": t0,
                      "t_init": t_init, "t_done": t_done}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def dist_pair(seed: int, workdir: str, max_epoch: int, resume: str = "0",
              kill_after: str = "0") -> list:
    """Start two ``--dist-worker`` processes; ``dist_wait`` collects them."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--dist-worker",
         str(pid), str(port), workdir, str(max_epoch), resume, kill_after,
         str(seed)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]


def dist_wait(procs: list, crash: bool = False) -> list:
    """The two workers' JSON lines (none where the coordinator is to crash:
    it must exit 137, and its partner is stopped); every process ends."""
    try:
        out0, err0 = procs[0].communicate(timeout=300)
        if crash:
            if procs[0].returncode != 137:
                raise AssertionError(f"the coordinator did not crash: "
                                     f"{err0[-2000:]}")
            try:
                procs[1].wait(timeout=60)
            except subprocess.TimeoutExpired:
                procs[1].kill()
            return []
        out1, err1 = procs[1].communicate(timeout=300)
        lines = []
        for p, out, err in zip(procs, (out0, out1), (err0, err1)):
            if p.returncode != 0:
                raise AssertionError(f"a worker failed ({p.returncode}): "
                                     f"{err[-3000:]}")
            lines.append(json.loads(out.strip().splitlines()[-1]))
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def dist_state(workdir: str) -> tuple:
    """(model state, epoch records without timestamps) of a workdir."""
    from vidsum_tpu_torch.train.checkpoint import load_checkpoint

    with open(os.path.join(workdir, "m.jsonl")) as f:
        recs = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f if line.strip()]
    return load_checkpoint(os.path.join(workdir, "model_mae.ckpt"))[0], recs


def phase_distributed(seed: int) -> None:
    """Multi-process finetuning (``parallel/distributed.py``): two
    processes on cuda:0 under gloo (NCCL will not give one card to two
    ranks), each a 2-entry data mesh, run ``DIST_EPOCHS`` epochs of
    ``finetune`` at the recipe's width; their records and final parameters
    equal the one-process 4-entry run's bit for bit (the shards' grads sum
    as one pairwise tree either way: ``dp_shardmap.sum_shards``), and only
    the coordinator writes files. Then the coordinator is killed after its
    first state file and both restart with ``resume``: parameters and
    records bit-equal to the straight two-process run."""
    import tempfile

    import torch

    from vidsum_tpu_torch.config import MeshConfig
    from vidsum_tpu_torch.parallel import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        one, two, res = (os.path.join(tmp, n) for n in ("one", "two", "res"))
        t0 = time.monotonic()
        dist_run(seed, one, make_mesh(MeshConfig(data=4), ["cuda:0"] * 4),
                 DIST_EPOCHS)
        torch.cuda.synchronize()
        one_wall = time.monotonic() - t0
        # the straight pair and the pair whose coordinator is killed after
        # its first state file start at once; the resumed pair starts as
        # soon as the crash is collected (at most four processes on the
        # card)
        started = []
        try:
            t0 = time.monotonic()
            started.append(dist_pair(seed, two, DIST_EPOCHS))
            started.append(dist_pair(seed, res, DIST_EPOCHS,
                                     kill_after="1"))
            dist_wait(started[1], crash=True)
            with open(os.path.join(res, "train_state.ckpt.meta.json")) as f:
                meta = json.load(f)
            if meta["epoch"] != 0:
                raise AssertionError(f"the crash left epoch "
                                     f"{meta['epoch']}")
            t1 = time.monotonic()
            started.append(dist_pair(seed, res, DIST_EPOCHS, resume="1"))
            lines = dist_wait(started[0])
            two_wall = time.monotonic() - t0
            dist_wait(started[2])
            resume_wall = time.monotonic() - t1
        finally:
            for p in (p for pair in started for p in pair):
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        if ({ln["backend"] for ln in lines} != {"gloo"}
                or [ln["coordinator"] for ln in lines] != [True, False]):
            raise AssertionError(f"the workers said {lines}")
        files = sorted(os.listdir(two))
        if files != sorted(["m.jsonl", "model_mae.ckpt",
                            "model_mae.ckpt.meta.json", "train_state.ckpt",
                            "train_state.ckpt.meta.json"]):
            raise AssertionError(f"the two-process run wrote {files}")
        (p1, r1), (p2, r2) = dist_state(one), dist_state(two)
        bad = [k for k in p1 if not torch.equal(p1[k], p2[k])]
        if bad or r2 != r1:
            raise AssertionError(f"two processes against one: tensors "
                                 f"{bad[:6]} differ; records {r2} / {r1}")
        p3, r3 = dist_state(res)
        bad = [k for k in p2 if not torch.equal(p2[k], p3[k])]
        if bad or r3 != r2:
            raise AssertionError(f"kill and resume is not exact: {bad[:6]}; "
                                 f"records {r3} / {r2}")
    emit("distributed", processes=2, backend="gloo",
         mesh_per_process=[2, 1], devices=["cuda:0"] * 2,
         epochs=DIST_EPOCHS, one_process_wall_s=one_wall,
         two_process_wall_s=two_wall,
         worker_walls_s=[ln["wall_s"] for ln in lines],
         # per worker of the straight pair: seconds from the launch to its
         # code running (interpreter, torch, the card), in the process
         # group's rendezvous, and in finetune
         worker_stages_s=[{"start": ln["t_start"] - t0,
                           "init": ln["t_init"] - ln["t_start"],
                           "run": ln["t_done"] - ln["t_init"]}
                          for ln in lines],
         records_and_params_equal_to_one_process=True,
         coordinator_only_files=files, kill_and_resume_bit_equal=True,
         resume_wall_s=resume_wall)


def phase_finetune_mesh(seed: int) -> dict:
    """``finetune(mesh=)`` through its entry points: ``cli.train --dp`` (a
    (1, 1) mesh of the one card; 16 train videos at batch 4, so no batch is
    padded) at the recipe's dropout against the same CLI run without
    ``--dp``: every record bit for bit (phase 7b's rule for its second CLI
    run; one shard draws its (1, 4) seed table from the epoch's generator
    as the single-device step draws its four layer seeds); then
    ``finetune(mesh=<(4, 1) of cuda:0>)`` over 2 folds x 2 epochs at the
    recipe's dropout (rows 9-12 on every shard), with its epoch walls.
    Returns the launches of that run."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import numpy as np
    import torch

    from vidsum_tpu_torch.cli import train as train_cli
    from vidsum_tpu_torch.config import MeshConfig, finetune_recipe
    from vidsum_tpu_torch.parallel import make_mesh
    from vidsum_tpu_torch.train import finetune as ft

    rng = np.random.default_rng(seed + 14)
    videos = finetune_videos(rng, 1024)
    names = list(videos)
    folds = [{"train_keys": [FT_KEY + n for n in names
                             if n not in names[4 * k:4 * k + 4]],
              "test_keys": [FT_KEY + n for n in names[4 * k:4 * k + 4]]}
             for k in range(2)]
    fold_datasets = memory_fold_datasets(videos)
    with tempfile.TemporaryDirectory() as tmp:
        split_path = os.path.join(tmp, "splits.json")
        with open(split_path, "w") as f:
            json.dump(folds[:1], f)
        recs, printed = {}, {}
        for name, extra in (("plain", []), ("dp", ["--dp"])):
            wd = os.path.join(tmp, name)
            argv = ["--data", tmp, "--split_path", split_path,
                    "--max_epoch", "2", "--workdir", wd,
                    "--metrics", os.path.join(wd, "m.jsonl")] + extra
            out = io.StringIO()
            with patched(ft, "fold_datasets", fold_datasets), \
                    contextlib.redirect_stdout(out):
                train_cli.main(argv)
            printed[name] = json.loads(out.getvalue().strip()
                                       .splitlines()[-1])
            with open(os.path.join(wd, "m.jsonl")) as f:
                recs[name] = [{k: v for k, v in json.loads(line).items()
                               if k != "ts"} for line in f]
        if recs["dp"] != recs["plain"] or printed["dp"] != printed["plain"]:
            raise AssertionError(f"cli.train --dp records {recs['dp']} != "
                                 f"{recs['plain']}")
        conf = finetune_recipe()
        conf = dataclasses.replace(conf, train=dataclasses.replace(
            conf.train, max_epoch=2, use_pretrained=False))
        mesh = make_mesh(MeshConfig(data=4), ["cuda:0"] * 4)
        reset_counters()
        with FoldLoopClock(fold_datasets) as clock:
            res = ft.finetune(conf, folds, workdir=os.path.join(tmp, "mesh"),
                              export_summary=False, mesh=mesh,
                              metrics_path=os.path.join(tmp, "mesh.jsonl"))
        torch.cuda.synchronize()
        counts = read_counters()
        with open(os.path.join(tmp, "mesh.jsonl")) as f:
            mesh_recs = [json.loads(line) for line in f]
    # 4 shards of a batch of 4: one video a shard, the per-element route
    if not (counts["_fwd_kernel"] and counts["_bwd_kernel"]
            and 0.0 <= res.fscore <= 100.0):
        raise AssertionError(f"finetune(mesh=) launched {counts}, F "
                             f"{res.fscore}")
    if len(mesh_recs) != 2 * 2 + 1 or not all(
            np.isfinite(r["train_loss"]) for r in mesh_recs[:-1]):
        raise AssertionError(f"finetune(mesh=) records {mesh_recs}")
    summary = clock.summary()
    emit("finetune_mesh", cli_dp={"mesh": [1, 1], "records": len(recs["dp"]),
                                  "records_bit_equal_to_no_mesh": True,
                                  "printed": printed["dp"]},
         mesh={"shape": [4, 1], "devices": ["cuda:0"] * 4, "folds": 2,
               "epochs": 2, "fscore": res.fscore,
               "epoch_wall_s": [round(e["wall_s"], 6)
                                for e in summary["epochs"]],
               "train_s": [round(e["train_s"], 6)
                           for e in summary["epochs"]],
               "fold_wall_s": summary["fold_wall_s"]},
         launches=counts)
    return {r: counts[r] for r in TRAIN_ROUTES}


def phase_serve_mesh_int8(seed: int) -> dict:
    """The int8 wire on a mesh: ``ScoringService(mesh=<(1, 4) of cuda:0>,
    attn_impl="int8_block", wire_dtype="int8", long_threshold=8,192)`` over
    the serve phase's 13 requests. The entries repeat one card, so short
    requests take the single-device int8 route (TPU kernels 13/14): their
    scores equal the single-device int8 service's bit for bit; the
    16,384-frame request takes the ring on the lossless wire and equals the
    lossless mesh service's. ``make_replica_forward_int8`` called over four
    entries of cuda:0 equals dequantise-then-score bit for bit. ``cli.serve
    --devices 2`` exits with the JAX message on a one-card machine; on two
    or more cards a (1, 2) mesh serves (a stated skip here otherwise).
    Returns the launches of the mesh service's pass."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.cli import serve as serve_cli
    from vidsum_tpu_torch.parallel import make_mesh
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.serve import mesh as serve_mesh
    from vidsum_tpu_torch.serve.transport import quantize_frames

    cfg, model = serve_model(seed)
    rng = np.random.default_rng(seed + 1)
    videos = [rng.random((n, cfg.in_features), dtype=np.float32)
              for n in SERVE_LENGTHS]
    mesh = make_mesh((1, 4), "cuda:0")

    def serve(**kw):
        with ScoringService(model, cfg, max_batch=8, max_delay_ms=50.0,
                            **kw) as svc:
            futs = [svc.submit(v, want_summary=False) for v in videos]
            return [f.result(timeout=600).scores for f in futs], svc.stats()

    single, _ = serve(attn_impl="int8_block", wire_dtype="int8")
    reset_counters()
    t0 = time.monotonic()
    got, st = serve(attn_impl="int8_block", wire_dtype="int8", mesh=mesh,
                    long_threshold=8192)
    wall = time.monotonic() - t0
    counts = read_counters()
    lossless, _ = serve(mesh=mesh, long_threshold=8192)
    if st.long_requests != 1 or st.failed:
        raise AssertionError(f"mesh int8 serving stats: {st}")
    for n, a, b, c in zip(SERVE_LENGTHS, got, single, lossless):
        want = c if n > 8192 else b
        if not np.array_equal(a, want):
            other = ("the lossless ring" if n > 8192
                     else "the single-device int8 service")
            raise AssertionError(f"a {n}-frame request on the int8 mesh "
                                 f"service != {other}")
    if not all(counts[r] for r in INT8_ROUTES) or not counts[
            "_ring_block_step"]:
        raise AssertionError(f"int8 mesh serving launched {counts}")

    # make_replica_forward_int8 over four entries of cuda:0
    devs = mesh.devices
    rep = serve_mesh._make_replica_forward(cfg, model, devs, "int8_block")
    fwd8 = serve_mesh.make_replica_forward_int8(cfg, rep)
    pairs, deq = [], []
    for _ in range(4):
        q, s = zip(*[quantize_frames(rng.random((512, cfg.in_features),
                                                dtype=np.float32))
                     for _ in range(2)])
        qt = torch.from_numpy(np.stack(q)).cuda()
        st_ = torch.from_numpy(np.stack(s)).cuda()
        pairs.append((qt, st_))
        deq.append(qt.float() * st_[..., None])
    mask = np.zeros((8, 512), bool)
    mask[:, 480:] = True
    replica_equal = np.array_equal(fwd8(pairs, mask), rep(deq, mask))
    if not replica_equal:
        raise AssertionError("make_replica_forward_int8 != dequantise then "
                             "score")
    if torch.cuda.device_count() < 2:
        try:
            serve_cli.main(["--devices", "2", "--warmup", ""])
        except SystemExit as e:
            msg = str(e)
        else:
            raise AssertionError("cli.serve --devices 2 served on one card")
        if msg != "--devices 2 but only 1 present":
            raise AssertionError(f"cli.serve --devices 2 said {msg!r}")
        two_cards = {"skipped": "one card: --devices 2 exits with "
                                f"{msg!r}"}
    else:
        m2 = serve_cli.serve_mesh(2)
        with ScoringService(model, cfg, mesh=m2, max_delay_ms=5.0) as svc:
            r = svc.submit(videos[0], want_summary=False).result(timeout=300)
        two_cards = {"mesh": [1, 2], "devices": [str(d) for d in m2.devices],
                     "served": bool(np.array_equal(r.scores, lossless[0]))}
    emit("serve_mesh_int8", mesh=[1, 4], devices=["cuda:0"] * 4,
         lengths=SERVE_LENGTHS, wall_s=wall, batches=st.batches,
         long_requests=st.long_requests, launches=counts,
         shorts_equal_single_device_int8=True,
         long_equals_lossless_ring=True,
         replica_forward_int8_equal=replica_equal, cli_devices_2=two_cards)
    return counts


def _counted():
    """(name, function) of every launch counter on the paths."""
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_kernel_int8 as bk8
    from vidsum_tpu_torch.ops import block_train as bt
    from vidsum_tpu_torch.ops import quant
    from vidsum_tpu_torch.tools import probe_int8_mma as probe

    ra = ring_module()

    return [("_fused_block", bk._fused_block),
            ("_fused_block_grouped", bk._fused_block_grouped),
            ("_flash_attention", at._flash_attention),
            ("_flash_attention_folded", at._flash_attention_folded),
            ("gemm_bias_epilogue", bk.gemm_bias_epilogue),
            ("masked_attention", at.masked_attention),
            *((r, getattr(bt, r)) for r in TRAIN_ROUTES),
            *((attn_train_name(r), getattr(att, r))
              for r in ATTN_TRAIN_ROUTES),
            *((r, getattr(bk8, r)) for r in INT8_ROUTES),
            ("quantize_rows", quant.quantize_rows),
            ("int8_gemm", quant.int8_gemm),
            *((r, getattr(probe, r)) for r in PROBE_ROUTES),
            *((r, getattr(ra, r)) for r in RING_ROUTES)]


def check_no_gemm_fallback(what: str) -> None:
    """Fails if any product so far took a serving GEMM fallback (bf16: the
    mma.sync kernel; f32: the FMA kernel's scalar loads) or any f32
    attention or int8 product staged its operands: every path's shapes must
    take the wgmma kernels straight from their operands, the 16-byte loads
    and the FMA attention's 16-byte copies."""
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import quant

    n = bk.gemm_bias_epilogue.fallback_launches
    na = at.masked_attention.fallback_launches
    n8 = quant.int8_gemm.fallback_launches
    if n or na or n8:
        raise AssertionError(f"{what}: {n} products took the GEMM fallback, "
                             f"{na} attention calls and {n8} int8 products "
                             f"staged their operands")


def reset_counters() -> None:
    for _, fn in _counted():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in _counted()}


def phase_serve(seed: int, compute_dtype: str = "bfloat16") -> dict:
    """The 13 requests through ``ScoringService`` in ``compute_dtype``: bf16
    (the ``serve`` line) or float32, ``ModelConfig()``'s default and so the
    ``cli.serve`` model (the ``serve_f32`` line)."""
    import numpy as np

    from vidsum_tpu_torch.ops import knapsack as kn
    from vidsum_tpu_torch.ops.summary import generate_summary
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.train.steps import make_eval_forward

    cfg, model = serve_model(seed, compute_dtype)
    rng = np.random.default_rng(seed + 1)
    lengths = SERVE_LENGTHS
    videos = [rng.random((n, cfg.in_features), dtype=np.float32)
              for n in lengths]
    with ScoringService(model, cfg, max_batch=8,
                        max_delay_ms=50.0) as svc:
        reset_counters()
        t0 = time.monotonic()
        futs = [svc.submit(v, change_points=(shot_bounds(v.shape[0])
                                             if v.shape[0] >= 6000 else None))
                for v in videos]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        counts = read_counters()
        st = svc.stats()
    missing = [r for r in SERVE_ROUTES if counts[r] == 0]
    if missing:
        raise AssertionError(f"routes never launched while serving: "
                             f"{missing} (counters {counts})")
    check_no_gemm_fallback(f"serving in {compute_dtype}")
    if st.completed != len(videos) or st.failed:
        raise AssertionError(f"serving stats: {st}")

    fwd = make_eval_forward(cfg)
    for v, r in zip(videos, results):
        n = v.shape[0]
        check_summary(r, n)
        x, mask = padded(cfg, v)
        solo = fwd(model, x, mask)[0, :n].float().cpu().numpy()
        if not np.array_equal(solo, r.scores):
            raise AssertionError(
                f"served != solo for a {n}-frame request (max diff "
                f"{float(np.abs(solo - r.scores).max())})")
    # the native and NumPy knapsacks pick the same shots for the 1,200-frame
    # request
    r = results[10]
    native_pick = r.summary
    kn._knapsack_native, saved = None, kn._knapsack_native
    try:
        [numpy_pick] = generate_summary([r.change_points], [r.scores],
                                        [r.n_frames], [np.arange(1200)])
    finally:
        kn._knapsack_native = saved
    if not np.array_equal(native_pick, numpy_pick):
        raise AssertionError("native and NumPy knapsack disagree")

    emit("serve" if compute_dtype == "bfloat16" else "serve_f32",
         compute_dtype=compute_dtype, requests=len(videos), lengths=lengths,
         wall_s=wall,
         latency_s=[round(r.latency_s, 6) for r in results],
         latency_p50_s=st.latency_p50_s, latency_p95_s=st.latency_p95_s,
         batches=st.batches, batch_hist=st.batch_hist,
         frames_per_s=sum(lengths) / wall, launches=counts,
         served_equals_solo=True)
    return counts


INT8_ROUTES = ("_fused_block_int8", "_fused_block_int8_grouped")
SERVE_ROUTES = ("_fused_block", "_fused_block_grouped", "_flash_attention",
                "_flash_attention_folded")
SERVE_LENGTHS = [320, 320, 320, 320, 480, 480, 480, 512, 512, 512, 1200,
                 6000, 16384]


def serve_model(seed: int, compute_dtype: str = "bfloat16"):
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet

    cfg = ModelConfig(compute_dtype=compute_dtype)
    return cfg, SimNet(cfg, generator=torch.Generator().manual_seed(seed))


def shot_bounds(n: int):
    """Given shot bounds for the long requests: 60-frame shots."""
    import numpy as np

    starts = np.arange(0, n, 60, dtype=np.int64)
    return np.stack([starts, np.minimum(starts + 59, n - 1)], axis=1)


def check_summary(r, n: int) -> None:
    import numpy as np

    if r.scores.shape != (n,) or not np.all((r.scores > 0)
                                            & (r.scores < 1)):
        raise AssertionError(f"bad scores for a {n}-frame request")
    s = r.summary
    budget = int(r.n_frames * 0.15)
    if s is None or s.shape != (r.n_frames,) or not set(
            np.unique(s)) <= {0, 1} or int(s.sum()) > budget:
        raise AssertionError(f"bad summary for a {n}-frame request")


def padded(cfg, v, bucket: int = 128):
    """A request's row padded to its bucket with the serving pad value, and
    its mask, batch 1."""
    import numpy as np

    from vidsum_tpu_torch.data.collate import bucket_length

    n = v.shape[0]
    nb = bucket_length(n, bucket)
    x = np.full((1, nb, cfg.in_features), 1000.0, np.float32)
    x[0, :n] = v
    mask = np.ones((1, nb), bool)
    mask[0, :n] = False
    return x, mask


def phase_serve_int8(seed: int) -> dict:
    """The 13 requests of the serve phase through ``ScoringService(
    attn_impl="int8_block", wire_dtype="int8")``: the 384-frame bucket at
    batch 4 takes TPU kernel 14, the 512- and 1,280-frame buckets kernel
    13, the 6,016- and 16,384-frame ones leave quantisation for the flash
    routes. Each request's scores equal its solo ``make_eval_forward``
    scores on the same dequantised input bit for bit, and lie within the
    lossy budget of the lossless bf16 route's solo scores."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.serve.transport import quantize_frames
    from vidsum_tpu_torch.train.steps import make_eval_forward

    cfg, model = serve_model(seed)
    rng = np.random.default_rng(seed + 1)
    videos = [rng.random((n, cfg.in_features), dtype=np.float32)
              for n in SERVE_LENGTHS]
    with ScoringService(model, cfg, attn_impl="int8_block",
                        wire_dtype="int8", max_batch=8,
                        max_delay_ms=50.0) as svc:
        reset_counters()
        t0 = time.monotonic()
        futs = [svc.submit(v, change_points=(shot_bounds(v.shape[0])
                                             if v.shape[0] >= 6000 else None))
                for v in videos]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        counts = read_counters()
        st = svc.stats()
    routes = INT8_ROUTES + ("_flash_attention", "_flash_attention_folded")
    missing = [r for r in routes if counts[r] == 0]
    if missing:
        raise AssertionError(f"routes never launched on the int8 serving "
                             f"pass: {missing} (counters {counts})")
    if st.completed != len(videos) or st.failed:
        raise AssertionError(f"serving stats: {st}")
    fwd8 = make_eval_forward(cfg, "int8_block")
    fwd = make_eval_forward(cfg)
    deltas = []
    for v, r in zip(videos, results):
        n = v.shape[0]
        check_summary(r, n)
        x, mask = padded(cfg, v)
        q, sc = quantize_frames(x[0])
        xd = (torch.from_numpy(q).cuda().float()
              * torch.from_numpy(sc).cuda()[:, None])[None]
        solo = fwd8(model, xd, mask)[0, :n].float().cpu().numpy()
        if not np.array_equal(solo, r.scores):
            raise AssertionError(
                f"int8 served != solo for a {n}-frame request (max diff "
                f"{float(np.abs(solo - r.scores).max())})")
        lossless = fwd(model, x, mask)[0, :n].float().cpu().numpy()
        deltas.append(np.abs(r.scores - lossless))
    d = np.concatenate(deltas)
    vs_bf16 = {"median": float(np.median(d)), "max": float(d.max())}
    if not (vs_bf16["median"] < INT8_VS_BF16["median"]
            and vs_bf16["max"] < INT8_VS_BF16["max"]):
        raise AssertionError(f"int8 scores off the lossless bf16 route by "
                             f"{vs_bf16} (budget {INT8_VS_BF16})")
    emit("serve_int8", requests=len(videos), lengths=SERVE_LENGTHS,
         wall_s=wall, latency_p50_s=st.latency_p50_s,
         latency_p95_s=st.latency_p95_s, batches=st.batches,
         batch_hist=st.batch_hist, frames_per_s=sum(SERVE_LENGTHS) / wall,
         launches=counts, served_equals_solo=True,
         vs_lossless_bf16=vs_bf16, budget=INT8_VS_BF16,
         per_request_max_dp=[float(x.max()) for x in deltas])
    return counts


def phase_serve_http(seed: int) -> None:
    """``serve_http.make_server`` on 127.0.0.1, port 0, over an int8
    service: three ``.npz`` requests answered 200 with the service's own
    scores, then a 413 (a body past the cap) and a 404."""
    import io
    import urllib.error
    import urllib.request

    import numpy as np

    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.serve_http import make_server, run_in_thread

    cfg, model = serve_model(seed)
    rng = np.random.default_rng(seed + 2)
    cap = 16 * 1024 * 1024
    with ScoringService(model, cfg, attn_impl="int8_block",
                        wire_dtype="int8", max_delay_ms=5.0) as svc:
        server = make_server(svc, host="127.0.0.1", port=0,
                             max_body_bytes=cap)
        thread = run_in_thread(server)
        host, port = server.server_address
        url = f"http://{host}:{port}"

        def post(path, feats):
            buf = io.BytesIO()
            np.savez(buf, features=feats)
            req = urllib.request.Request(url + path, data=buf.getvalue(),
                                         method="POST")
            return urllib.request.urlopen(req, timeout=300)

        def status(fn) -> int:
            try:
                with fn() as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        codes, t_s = [], []
        try:
            for n in (320, 512, 1200):
                feats = rng.random((n, cfg.in_features), dtype=np.float32)
                t0 = time.monotonic()
                with post("/summarize", feats) as r:
                    codes.append(r.status)
                    out = json.loads(r.read())
                t_s.append(time.monotonic() - t0)
                want = svc.summarize(feats)
                if not np.array_equal(np.asarray(out["scores"], np.float32),
                                      want.scores):
                    raise AssertionError(f"HTTP scores != the service's for "
                                         f"a {n}-frame request")
                if out["summary_frames"] != np.nonzero(
                        want.summary)[0].tolist():
                    raise AssertionError("HTTP summary != the service's")
            big = np.zeros((cap // (4 * cfg.in_features) + 1,
                            cfg.in_features), np.float32)
            codes.append(status(lambda: post("/summarize", big)))
            codes.append(status(lambda: urllib.request.urlopen(
                url + "/nope", timeout=60)))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    if codes != [200, 200, 200, 413, 404]:
        raise AssertionError(f"HTTP status codes {codes}")
    emit("serve_http", statuses=codes, request_s=t_s, max_body_bytes=cap)


# the phases --compare runs from each tree (a parent checkout's
# chip_smoke.py must have them, with these signatures)
COMPARE_CODE = """
import os, sys
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from vidsum_tpu_torch.native import build as native_build
from vidsum_tpu_torch.ops import _cuda
dev = cs.phase_device()
_cuda.build()
native_build.build(verbose=False)
cs.phase_kernels(dev, {seed})
cs.phase_gemm(dev, {seed})
cs.phase_int8_kernels(dev, {seed})
cs.phase_int8_probe(dev)
cs.phase_train_kernels(dev, {seed})
cs.phase_train_attention(dev, {seed})
cs.phase_train({seed})
cs.phase_ring_kernels(dev, {seed})
cs.phase_serve_mesh({seed})
import numpy as np
from vidsum_tpu_torch.config import finetune_recipe
rng = np.random.default_rng({seed} + 6)
cs.phase_seq_train({seed}, cs.synthetic_videos(
    rng, rng.integers(7950, 9001, 8), finetune_recipe().model.in_features))
"""


# PGL-SUM at the shapes of the serve-pglsum-long cell: 2,400-14,400-row
# videos in 128-row buckets, batches of up to 8 (odd lengths among them,
# whose last bias column is 0, and unequal last segments)
PGL_LENGTHS = (14400, 14399, 2401, 6703, 9999, 12001, 3000, 14273)
POSBIAS_DESIGN = (
    "fma_fwd_posbias_kernel on attention_core.cuh's FMA forward tile "
    "(fma_fwd_tile, shared with fma_fwd_kernel, inlined): exact f32 FMAs, "
    "scale 1, each key tile's position bias added to its scores from the "
    "element's own length, one IEEE division and sincosf a row and column "
    "pair from torch's float32 den table, 64-row CTAs at head_dim 64 and "
    "128; no T x T tensor; PGL-SUM's local segments run as batch elements")
ROW_NORMS_DESIGN = (
    "l2_fuse_kernel (row_norms.cu): one warp a row, its 1,024 values in "
    "registers, both L2 norms and n(a) + n(b) + x IEEE-rounded in a fixed "
    "order; then common.cuh's layernorm_rows_kernel in place (the fusion's "
    "norm_y and, alone, norm_linear)")


def phase_pglsum(dev: dict, seed: int, lengths=PGL_LENGTHS,
                 in_features: int = 1024) -> dict:
    """PGL-SUM's kernels at the serving cell's shapes (``pglsum`` lines):
    ``masked_attention_posbias`` on the global branch's (8, 8, N, 128) and
    the local branch's (32, 4, ceil(N / 4), 64) elements of ``lengths``
    (N their 128-row bucket), against ``attention_posbias_reference`` over
    the valid rows at the f32 attention tolerance, which the plain
    attention without the bias must fail; ``fuse_layernorm`` and
    ``layernorm_`` at 14,400 rows and at the batch's B N rows against their
    plain versions at the f32 block tolerance, which an L1 norm in the
    fusion and a LayerNorm that keeps the mean must fail; each kernel's
    CUDA-event ms, its plain version's, and the bound (valid queries x keys
    at the f32 peak, or the bytes). Then one ``PGLSum`` forward of the
    batch through ``make_eval_forward`` at the published widths, with
    PGL-SUM's counters set to 0 just before it: 17 launches (12 GEMMs, 2
    attention, 3 row launches), no staged operand or GEMM fallback, every
    video's scores within 1e-5 of the plain reference (``benchmark/
    reference/pglsum.py``), its ms and peak device bytes. Returns the
    kernels line's PGL-SUM entries' numbers."""
    import torch
    import torch.nn.functional as F

    from benchmark.reference import pglsum as ref
    from vidsum_tpu_torch.config import pglsum_config
    from vidsum_tpu_torch.data.collate import bucket_length
    from vidsum_tpu_torch.models.pglsum import PGLSum
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import row_norms as rn
    from vidsum_tpu_torch.train.steps import make_eval_forward

    peaks = peaks_for(dev["name"])
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(seed + 230)
    cfg = pglsum_config(in_features=in_features, d_model=in_features)
    d, S = cfg.in_features, cfg.num_segments
    B, N = len(lengths), bucket_length(max(lengths))
    den = at.position_bias_den(max(8192, N), d, cfg.pos_freq, cuda)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    def bound(flops, nbytes):
        t_ops = flops / peaks["float32"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    # the local branch's elements: segment m of video b is element m B + b
    size = [-(-T // S) for T in lengths]
    local = [max(0, min(size[b], T - m * size[b]))
             for m in range(S) for b, T in enumerate(lengths)]
    out = {}
    tol = TOL[("attention", "float32")]
    for branch, lens, heads, dh, n in (
            ("global", list(lengths), cfg.num_heads, d // cfg.num_heads, N),
            ("local", local, cfg.local_heads, d // S // cfg.local_heads,
             -(-N // S))):
        E = len(lens)
        q, k, v = (randn(E, heads, n, dh, scale=dh ** -0.25)
                   for _ in range(3))
        lt = torch.tensor(lens, device=cuda)
        valid = torch.arange(n, device=cuda)[None, :] < lt[:, None]
        rows = lambda t: t.transpose(1, 2)[valid]  # noqa: E731
        got = at.masked_attention_posbias(q, k, v, lt, den)
        want = at.attention_posbias_reference(q, k, v, lt, den)
        err, rel = check_close(rows(got), rows(want), tol,
                               f" ({branch} {tuple(q.shape)})")
        # the plain attention without the bias must fail the tolerance
        plain = torch.zeros_like(want)
        for e, T in enumerate(lens):
            if T:
                plain[e:e + 1, :, :T] = at.attention_reference(
                    q[e:e + 1, :, :T], k[e:e + 1, :, :T], v[e:e + 1, :, :T],
                    None, 1.0)
        fault_err, fault_rel = errors(rows(plain), rows(want))
        if within(rows(plain), rows(want), tol):
            raise AssertionError(f"{branch}: the attention without the "
                                 f"position bias passes the tolerance {tol}")
        del plain
        ms = cuda_ms(lambda: at.masked_attention_posbias(q, k, v, lt, den),
                     reps=5)
        plain_ms = cuda_ms(lambda: at.attention_posbias_reference(
            q, k, v, lt, den), reps=1, warmup=0)
        flops = sum(4 * heads * dh * T * T for T in lens)
        nbytes = 4 * q.numel() * 4
        b_ms, b_by = bound(flops, nbytes)
        emit("pglsum", kernel="attention_posbias", branch=branch,
             shape=list(q.shape), lengths=lens, max_abs_err=err,
             rel_rms_err=rel, tolerance=tol,
             no_bias_err=[fault_err, fault_rel], ms=ms, plain_ms=plain_ms,
             tflops=flops / ms / 1e9, bound_ms=b_ms, bound_by=b_by,
             flops=flops, bytes=nbytes, card=dev["smi"])
        out[branch] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, shape=list(q.shape))
        del q, k, v, got, want

    tol = TOL[("block", "float32")]
    for M in (14400, B * N):
        a, b, x = randn(M, d, scale=3.0), randn(M, d, scale=0.5), randn(M, d)
        g, beta = randn(d).abs() + 0.5, randn(d)
        got = rn.fuse_layernorm(a, b, x, g, beta, 1e-6)
        want = rn.fuse_layernorm_reference(a, b, x, g, beta, 1e-6)
        err, rel = check_close(got, want, tol, f" (fuse_layernorm, {M} rows)")
        z = (F.normalize(a, dim=-1) + F.normalize(b, p=1, dim=-1)) + x
        if within(F.layer_norm(z, (d,), g, beta, 1e-6), want, tol):
            raise AssertionError("an L1 norm in the fusion passes the "
                                 f"tolerance {tol}")
        r = torch.relu(randn(M, d, scale=3.0))   # the regressor's ReLU rows
        got_ln = rn.layernorm_(r.clone(), g, beta, 1e-6)
        want_ln = rn.layernorm_reference(r, g, beta, 1e-6)
        err_ln, rel_ln = check_close(got_ln, want_ln, tol,
                                     f" (layernorm_, {M} rows)")
        rms = r * torch.rsqrt(r.pow(2).mean(-1, keepdim=True) + 1e-6)
        if within(rms * g + beta, want_ln, tol):
            raise AssertionError("a LayerNorm that keeps the mean passes "
                                 f"the tolerance {tol}")
        ms = cuda_ms(lambda: rn.fuse_layernorm(a, b, x, g, beta, 1e-6),
                     reps=10)
        plain_ms = cuda_ms(lambda: rn.fuse_layernorm_reference(
            a, b, x, g, beta, 1e-6), reps=3, warmup=1)
        scratch = r.clone()
        ms_ln = cuda_ms(lambda: rn.layernorm_(scratch, g, beta, 1e-6),
                        reps=10)
        b_ms, b_by = bound(0, 4 * M * d * 4)
        b_ln, _ = bound(0, 2 * M * d * 4)
        emit("pglsum", kernel="row_norms", rows=M, cols=d,
             fuse_err=[err, rel], layernorm_err=[err_ln, rel_ln],
             tolerance=tol, fuse_ms=ms, fuse_plain_ms=plain_ms,
             fuse_bound_ms=b_ms, layernorm_ms=ms_ln, layernorm_bound_ms=b_ln,
             bound_by=b_by, card=dev["smi"])
        out["row_norms" if M == 14400 else "row_norms_batch"] = dict(max_abs_err=max(err, err_ln), ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, layernorm_ms=ms_ln,
                                     layernorm_bound_ms=b_ln)
        del a, b, x, r, got, want, got_ln, want_ln, scratch

    # one forward of the batch at the published widths
    model = PGLSum(cfg, device=cuda,
                   generator=torch.Generator().manual_seed(seed + 231))
    reference = ref.build({"in_features": d, "num_heads": cfg.num_heads,
                           "num_segments": S,
                           "local_heads": cfg.local_heads,
                           "pos_freq": cfg.pos_freq},
                          model.state_dict(), cuda)
    x = torch.full((B, N, d), 1000.0, device=cuda)
    mask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    for i, T in enumerate(lengths):
        x[i, :T] = randn(T, d)
        mask[i, :T] = False
    fwd = make_eval_forward(cfg)
    fwd(model, x, mask)            # the den table and the packed weights
    torch.cuda.synchronize()
    gemms = bk.gemm_bias_epilogue.launches
    gemm_fallback = bk.gemm_bias_epilogue.fallback_launches
    segments = PGLSum.segments()
    PGLSum.launches = 0
    at.masked_attention_posbias.launches = 0
    at.masked_attention_posbias.fallback_launches = 0
    rn.fuse_layernorm.launches = 0
    rn.layernorm_.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    scores = fwd(model, x, mask)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts = {"PGLSum.launches": PGLSum.launches,
              "gemm_bias_epilogue": bk.gemm_bias_epilogue.launches - gemms,
              "gemm_fallback": (bk.gemm_bias_epilogue.fallback_launches
                                - gemm_fallback),
              "masked_attention_posbias":
              at.masked_attention_posbias.launches,
              "posbias_staged": at.masked_attention_posbias.fallback_launches,
              "fuse_layernorm": rn.fuse_layernorm.launches,
              "layernorm_": rn.layernorm_.launches,
              "segments": PGLSum.segments() - segments}
    want_counts = {"PGLSum.launches": 17, "gemm_bias_epilogue": 12,
                   "gemm_fallback": 0, "masked_attention_posbias": 2,
                   "posbias_staged": 0, "fuse_layernorm": 2, "layernorm_": 1,
                   "segments": sum(t > 0 for t in local)}
    if counts != want_counts:
        raise AssertionError(f"PGL-SUM forward counts {counts}, expected "
                             f"{want_counts}")
    gaps = []
    for i, T in enumerate(lengths):
        want = ref.scores(reference, x[i, :T])
        gaps.append(float((scores[i, :T] - want).abs().max()))
    if not max(gaps) < 1e-5:
        raise AssertionError(f"PGL-SUM scores off the reference by {gaps}")
    ms = cuda_ms(lambda: fwd(model, x, mask), reps=3)
    emit("pglsum", kernel="forward", shape=[B, N, d], lengths=list(lengths),
         counts=counts, max_abs_score_err=gaps, ms=ms,
         peak_bytes_over_inputs=peak, card=dev["smi"])
    out["launches"] = counts
    return out


def compare_trees(parent: str, seed: int) -> int:
    """The kernel phases (kernels, gemm, int8 kernels, int8 probe, train
    kernels, train attention kernels), the train phase, the ring kernels,
    mesh serving and the sequence-parallel step (over 8 videos of
    7,950-9,000 frames drawn here) of the checkout at ``parent`` and of
    this one, each
    in its own process from its own tree (its own build), in turns: parent,
    change, change, parent. Each turn's lines follow a ``compare_turn``
    line naming its tree."""
    trees = (("parent", os.path.abspath(parent)), ("change", HERE),
             ("change", HERE), ("parent", os.path.abspath(parent)))
    for turn, (label, tree) in enumerate(trees):
        emit("compare_turn", turn=turn, tree=label, dir=tree)
        rc = subprocess.run([sys.executable, "-c",
                             COMPARE_CODE.format(seed=seed)],
                            cwd=tree).returncode
        if rc:
            print(f"chip_smoke.py: the {label} tree's phases failed "
                  f"(exit {rc})", file=sys.stderr)
            return rc
    return 0


class PhaseClock:
    """Wall seconds of the run's phases, for the ``timeline`` line: each
    ``mark(name)`` closes the phase since the previous mark."""

    def __init__(self) -> None:
        self.start = self.last = time.monotonic()
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.monotonic()
        self.seconds[name] = round(now - self.last, 3)
        self.last = now

    def total(self) -> float:
        return round(time.monotonic() - self.start, 3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", metavar="PARENT_DIR",
                    help="run the kernel, train, mesh serving and "
                         "sequence-parallel phases of the checkout at "
                         "PARENT_DIR and of this one in turns (parent, "
                         "change, change, parent) instead of the full run")
    ap.add_argument("--dist-worker", nargs=7, metavar="ARG",
                    help=argparse.SUPPRESS)   # a process of phase 8b
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "vidsum_tpu_torch")):
        print("chip_smoke.py: the vidsum_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.compare:
        return compare_trees(args.compare, args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock = PhaseClock()
    dev = phase_device()
    (mma_regs, gemm_regs, bt_regs, fma_regs, f32_gemm_regs,
     fma_serve_regs, int8_regs, ring_regs, pgl_regs) = phase_build()
    clock.mark("build")
    timings = phase_kernels(dev, args.seed)
    phase_gemm(dev, args.seed)
    clock.mark("kernels_gemm")
    timings.update(phase_int8_kernels(dev, args.seed))
    probe_timings, probe_launches = phase_int8_probe(dev)
    timings.update(probe_timings)
    clock.mark("int8")
    timings.update(phase_train_kernels(dev, args.seed))
    timings.update(phase_train_attention(dev, args.seed, fma_regs))
    clock.mark("train_kernels")
    timings.update(phase_ring_kernels(dev, args.seed, ring_regs))
    clock.mark("ring_kernels")
    for shape in (D512, D384, D768, D192, D320, D896, D1024):
        phase_wide(args.seed, shape)
    wide_launches = {}
    for shape in WIDE_SLICED:
        for r, n in phase_wide(args.seed, shape, layers=1,
                               n_model=256)[1].items():
            wide_launches[r] = wide_launches.get(r, 0) + n
    clock.mark("wide")
    wide_path_launches = phase_wide_path(args.seed)
    phase_wide_timings(dev, args.seed)
    clock.mark("wide_path")
    pgl = phase_pglsum(dev, args.seed)
    clock.mark("pglsum")
    counts = phase_serve(args.seed)
    counts.update({r + ".f32": n for r, n in phase_serve(
        args.seed, "float32").items() if r in SERVE_ROUTES})
    counts.update({r: n for r, n in phase_serve_int8(args.seed).items()
                   if r in INT8_ROUTES})
    phase_serve_http(args.seed)
    counts["_ring_block_step"] = phase_serve_mesh(args.seed)[
        "_ring_block_step"]
    phase_ring_multi_card(args.seed)
    counts.update(probe_launches)
    clock.mark("serve")
    counts.update({r: n for r, n in phase_train(args.seed).items()
                   if r in TRAIN_ROUTES or r.endswith(".f32")})
    clock.mark("train")
    phase_finetune(dev, args.seed)
    clock.mark("finetune")
    phase_pretrain(dev, args.seed)
    clock.mark("pretrain")
    phase_recycle(args.seed)
    clock.mark("recycle")
    summarized = phase_summarize(dev, args.seed)
    clock.mark("summarize")
    phase_extract(dev, args.seed, summarized["feats_480"])
    clock.mark("extract")
    phase_device_eval(dev)
    clock.mark("device_eval")
    long_launches, long_videos, bucket_err = phase_long_train(args.seed)
    counts.update(long_launches)
    # the bf16 fold's max_abs_err: the larger of its two checks, at
    # (2, 4, 8192, 64) and at the long-video run's largest bucket
    for name, err in bucket_err.items():
        timings[name]["max_abs_err"] = max(timings[name]["max_abs_err"], err)
    clock.mark("long_train")
    counts.update(phase_seq_train(args.seed, long_videos))
    clock.mark("seq_train")
    mgpu = {"dp_train": phase_dp_train(args.seed)}
    clock.mark("dp_train")
    phase_tp_train(args.seed)
    clock.mark("tp_train")
    phase_pp_train(args.seed)
    clock.mark("pp_train")
    mgpu["finetune_mesh"] = phase_finetune_mesh(args.seed)
    clock.mark("finetune_mesh")
    phase_distributed(args.seed)
    clock.mark("distributed")
    mgpu["serve_mesh_int8"] = {r: n for r, n in phase_serve_mesh_int8(
        args.seed).items() if n}
    clock.mark("serve_mesh_int8")
    check_no_gemm_fallback("the run")

    replaces = {
        "_fused_block": "vidsum_tpu/ops/block_kernel.py:39",
        "_fused_block_grouped": "vidsum_tpu/ops/block_kernel.py:98",
        "_flash_attention": "vidsum_tpu/ops/attention.py:40",
        "_flash_attention_folded": "vidsum_tpu/ops/attention.py:76",
        **{r + ".f32": rep for r, rep in (
            ("_fused_block", "vidsum_tpu/ops/block_kernel.py:39"),
            ("_fused_block_grouped", "vidsum_tpu/ops/block_kernel.py:98"),
            ("_flash_attention", "vidsum_tpu/ops/attention.py:40"),
            ("_flash_attention_folded", "vidsum_tpu/ops/attention.py:76"))},
        "_fwd_kernel": "vidsum_tpu/ops/block_train.py:198",
        "_bwd_kernel": "vidsum_tpu/ops/block_train.py:221",
        "_fwd_kernel_grouped": "vidsum_tpu/ops/block_train.py:410",
        "_bwd_kernel_grouped": "vidsum_tpu/ops/block_train.py:421",
        **{attn_train_name(r): f"vidsum_tpu/ops/attention_train.py:{line}"
           for r, line in zip(ATTN_TRAIN_ROUTES, (83, 112, 175, 228))},
        **{attn_train_name(r) + ".bf16":
           f"vidsum_tpu/ops/attention_train.py:{line}"
           for r, line in (("_fwd_kernel_folded", 175),
                           ("_bwd_kernel_folded", 228))},
        **{attn_train_name(r) + ".f32":
           f"vidsum_tpu/ops/attention_train.py:{line}"
           for r, line in (("_fwd_kernel", 83), ("_bwd_kernel", 112))},
        "_fused_block_int8": "vidsum_tpu/ops/block_kernel_int8.py:63",
        "_fused_block_int8_grouped": "vidsum_tpu/ops/block_kernel_int8.py:143",
        "mm_bf16": "scripts/probe_int8_mxu.py:63",
        "mm_int8": "scripts/probe_int8_mxu.py:69",
        "_ring_block_step": "vidsum_tpu/parallel/ring_attention.py:134",
        "_ring_train_step": "vidsum_tpu/parallel/ring_attention.py:422",
        "_ring_train_step_bwd": "vidsum_tpu/parallel/ring_attention.py:478",
    }
    summarize_launches = {}
    for run_counts in summarized["launches"].values():
        for r, n in run_counts.items():
            summarize_launches[r] = summarize_launches.get(r, 0) + n
    csrc = "vidsum_tpu_torch/csrc/"
    block_src = [csrc + "gemm_bias_epilogue.cu", csrc + "masked_attention.cu",
                 csrc + "mma_tiles.cuh"]
    attn_src = [csrc + "masked_attention.cu", csrc + "mma_tiles.cuh"]
    train_src = [csrc + "block_train.cu"]
    attn_train_src = [csrc + "attention_train.cu",
                      csrc + "attention_core.cuh"]
    attn_mma_src = [csrc + "attention_train_mma.cuh",
                    csrc + "attention_train.cu", csrc + "mma_tiles.cuh"]
    mma_routes = {attn_train_name(r) for r in ("_fwd_kernel", "_bwd_kernel")
                  } | {attn_train_name(r) + ".bf16"
                       for r in ("_fwd_kernel_folded", "_bwd_kernel_folded")}
    int8_src = [csrc + "int8_gemm.cu", csrc + "tma_ring.cuh",
                csrc + "masked_attention.cu", csrc + "mma_tiles.cuh"]
    ring_src = [csrc + "ring_attention.cu", csrc + "attention_core.cuh",
                csrc + "mma_tiles.cuh"]
    f32_block_src = [csrc + "gemm_bias_epilogue.cu", csrc + "fma_gemm.cuh",
                     csrc + "masked_attention.cu", csrc + "attention_core.cuh"]
    f32_attn_src = [csrc + "masked_attention.cu", csrc + "attention_core.cuh"]
    names = {"_fused_block_int8": "block_int8",
             "_fused_block_int8_grouped": "block_int8_grouped",
             "mm_bf16": "probe_mm_bf16", "mm_int8": "probe_mm_int8",
             **RING_NAMES}
    kernels = []
    for route, rep in replaces.items():
        srcs = (f32_block_src if route in ("_fused_block.f32",
                                           "_fused_block_grouped.f32")
                else f32_attn_src if route.endswith(".f32")
                and route.startswith("_flash")
                else ring_src if route in RING_ROUTES
                else attn_mma_src if route in mma_routes
                else attn_train_src if route.startswith("attention_train.")
                else train_src if route in TRAIN_ROUTES
                else int8_src if route in INT8_ROUTES
                else [csrc + "gemm_bias_epilogue.cu"] if route == "mm_bf16"
                else [csrc + "int8_gemm.cu", csrc + "tma_ring.cuh"]
                if route == "mm_int8"
                else block_src if "block" in route else attn_src)
        entry = {"name": names.get(route, route.lstrip("_")),
                 "route": "cuda", "source": srcs[0], "sources": srcs,
                 "replaces": rep, "launches": counts[route],
                 **timings[route]}
        # the launches at the widths past the old limits: phase_wide's
        # checks of WIDE_SLICED (both dtypes where the route serves both)
        # and the wide_path phase's main paths at d 1,024 / head_dim 256
        wide_name = route.removesuffix(".f32").removesuffix(".bf16")
        for key, got in (("launches_wide", wide_launches),
                         ("launches_wide_path", wide_path_launches)):
            if got.get(wide_name):
                entry[key] = got[wide_name]
        for ph, run_counts in mgpu.items():
            if route in run_counts:
                # the multi-GPU phases' main paths (rows 9-12 on every dp
                # shard; the int8 mesh wire's single-device int8 route)
                entry["launches_" + ph] = run_counts[route]
        if route.split(".")[0] in summarize_launches and (
                route.endswith(".f32") or route in RING_ROUTES):
            # the summarize phase's f32 scorer (its CLI runs and the mesh)
            entry["launches_summarize"] = summarize_launches[
                route.split(".")[0]]
        if route in ("_fused_block.f32", "_fused_block_grouped.f32"):
            entry["design"] = SERVING_F32_DESIGN
            entry["ptxas"] = f32_gemm_regs + [
                r for r in fma_serve_regs if "<64," in r["kernel"]]
        elif route in ("_flash_attention.f32",
                       "_flash_attention_folded.f32"):
            entry["design"] = SERVING_F32_DESIGN
            entry["ptxas"] = [r for r in fma_serve_regs
                              if "<64," in r["kernel"]]
        elif route in ("_flash_attention", "_flash_attention_folded"):
            entry["design"] = SERVING_ATTENTION_DESIGN
            entry["ptxas"] = [r for r in mma_regs if "<64," in r["kernel"]]
        elif route in ("_fused_block", "_fused_block_grouped", "mm_bf16"):
            entry["design"] = SERVING_GEMM_DESIGN
            entry["ptxas"] = gemm_regs
        elif route in INT8_ROUTES or route == "mm_int8":
            entry["design"] = INT8_GEMM_DESIGN
            entry["ptxas"] = int8_regs
        elif route in TRAIN_ROUTES:
            entry["design"] = TRAIN_GEMM_DESIGN
            entry["ptxas"] = bt_regs
        elif (route.startswith("attention_train.")
              and route not in mma_routes):
            entry["design"] = FMA_ATTENTION_DESIGN
            entry["ptxas"] = [r for r in fma_regs if "<64," in r["kernel"]]
        elif route in RING_ROUTES:
            entry["design"] = RING_DESIGN
            kinds = (("ring_dq", "ring_dkdv") if route.endswith("bwd")
                     else ("ring_fwd",))
            entry["ptxas"] = [r for r in ring_regs if "<64," in r["kernel"]
                              and r["kernel"].startswith(kinds)]
        kernels.append(entry)
    # PGL-SUM's kernels (phase 5c): the JAX package has no PGL-SUM, so they
    # replace no TPU kernel; launches are one forward's
    for name, srcs, parts, regs, n, design in (
            ("attention_posbias", f32_attn_src, ("global", "local"),
             [r for r in pgl_regs if "posbias" in r["kernel"]],
             pgl["launches"]["masked_attention_posbias"], POSBIAS_DESIGN),
            ("row_norms", [csrc + "row_norms.cu", csrc + "common.cuh"],
             ("row_norms", "row_norms_batch"),
             [r for r in pgl_regs if "l2_fuse" in r["kernel"]],
             pgl["launches"]["fuse_layernorm"]
             + pgl["launches"]["layernorm_"], ROW_NORMS_DESIGN)):
        kernels.append({"name": name, "route": "cuda", "source": srcs[0],
                        "sources": srcs, "replaces": None,
                        "launches": n, **pgl[parts[0]],
                        "at_" + parts[1]: pgl[parts[1]],
                        "design": design, "ptxas": regs})
    emit("timeline", seconds=clock.seconds, total_s=clock.total())
    print(dev["smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

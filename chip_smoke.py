#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device   — require CUDA, print the card's name and power limit, turn
              TF32 off;
2. build    — build the six kernels (``src/repro_torch/csrc/*.cu``) into
              ``build/kernels/``, one nvcc per source, all started together;
3. kernel   — each kernel against its plain PyTorch version on the card:
              the megakernel on all 20 Table-I programs × {float32, int8,
              int16} at a seeded bucket of 64 (grid vs per-sample bitwise;
              integer outputs exact, 1 LSB only after a float PE) and on a
              segment built to land on rounding ties (numpy's half to even,
              exactly); the chain kernels on every chain step of the same
              60 programs compiled with ``use_pallas=True``, on random
              programs over every stage (rank 3, ragged n), on views at
              storage offsets of 0-15 bytes (``at_offset``) and on a
              1-element stream with length-1 vecs, and a chain call
              captured in a CUDA graph, whose replay must equal the eager
              call bitwise (also on new operands copied in); spmv at tile
              densities 0, 0.1 and 1, on ragged shapes, with a row block
              that keeps no tile and at B = 1 with unaligned rows of x, two
              calls bitwise equal; matmul/gemv in
              float32 and bfloat16 up to 4096³ (``MATMUL_SHAPES``), both
              layouts of b, on every route of ``plan_matmul``: wgmma with
              TMA or thread staging, split-K, the float32 CUDA-core kernel;
4. serve    — the two served paths: ``ClassicalServeEngine`` on
              bonsai/curet-m and protonn/curet-m, float32 and int8, 256
              requests each, with ``exec_mode="megakernel_grid"`` (the
              megakernel) and with ``use_pallas=True`` on the interpret
              lane (the chain kernels); predictions must agree with the
              port's ``use_pallas=False`` interpret lane on ≥ 99 % of
              requests; each path's launches are counted over its own run
              and the chain launches must equal chains × buckets;
5. ops      — the kernel library's entry point ``repro_torch.kernels.ops``:
              ``spmv`` x2 and ``gemv`` x2 and ``matmul`` x1 in float32 and
              again in bfloat16 at the report's shapes, their launches
              counted over this phase (bfloat16 on ``matmul_wgmma``), the
              results checked against the plain versions;
6. lm-kernel — the two attention kernels against their plain versions on
              the card: flash attention at qwen2.5-3b's heads (H 16, KV 2,
              dh 128), B = 1, Sq = Sk in {8, 100, 1024, 2048}, float32 and
              bfloat16, p in fp32 and p rounded, plus G in {1, 4, 8} at small
              shapes, one non-causal case, dh 256, dh 100 and G = 6 (bf16
              on the tensor cores in row tiles of whole tokens), dh 320
              causal and full (output
              columns split over blocks), 600 tokens (more row tiles than
              SMs) and q, k, v as strided views of a fused QKV projection, each
              case on the kernel ``flash_route`` picks; decode attention at
              B = 8, S = 2048 with ragged cache lengths including 1 and S,
              with the lengths of phase 7's last decode step (given on the
              host and on the card) and with every length 1, two calls
              bitwise equal; at G = 128, dh = 320; and with the lengths on
              the card under CUDA's sync debug mode (no synchronisation)
              and captured in a CUDA graph, whose replay must equal the
              eager call bitwise; float32 and bfloat16.  Then both kernels
              at phase 7's other heads (``FAMILY_HEADS``): flash at S =
              1024 for olmoe (H = KV = 16), granite (32 / 8), codeqwen
              (32 / 32) and deepseek-v2's MLA prefill (H = KV = 128, dh
              192, and v zero-padded from 128 to 192), decode at the first
              three at the served lengths; then flash at S = 1024 for
              command-r (64 / 8), internvl2 (48 / 8) and musicgen (24 / 24,
              dh 64), zamba2's shared block (H = KV = 32, dh 224) at S =
              100 and 1024, a window of 256 at dh 224 and at qwen's heads,
              and float32 with p rounded to bfloat16 (``round_p=
              torch.bfloat16``, the model's ``probs_bf16``); internvl2's
              G 6 (``G6_HEADS``) at S 1,024 and 4,096, causal, full and
              with a window of 256, and G 3 and G 5 at dh 64 (63- and
              60-row tiles), each required to take ``fa_tc_kernel`` in
              bfloat16; decode at
              those heads at the served lengths against LM_MAX_LEN slots,
              zamba2's as its served config decodes (no window), and at
              zamba2's against a ring of 256 slots (lengths min(pos + 1, 256), most
              past the ring's width), also under CUDA's sync debug mode and
              captured in a CUDA graph; a sliding window on the
              full-length cache (``WINDOWS``: 256 and 1,024) at qwen's and
              zamba2's heads, lengths 1, W - 1, W, W + 1 and S, starts
              max(0, len - W) on the card (the windowed grid of ceil(W /
              chunk) + 1 splits), under CUDA's sync debug mode, two calls
              and a CUDA graph's replay bitwise equal, and a rank's piece
              of a sequence split over 4 ranks (local starts, a piece
              wholly below its start: zeros and lse -inf) with the
              log-sum-exp output (``TP_LSE_TOL``); and the chunked SSD scan against
              its sequential oracle at one full-width layer of mamba2 (H
              64, P 64, N 128) and zamba2 (H 112, N 64), S = 1024.
              Limits: float32 ``rtol = atol = 1e-5``; bfloat16, and float32
              with bf16 p, one bf16 ulp of the output's largest magnitude;
              the SSD scan ``1e-5 x max |y|``;
7. lm-serve — the port's ``ServeEngine`` on qwen2.5-3b at full width (36
              layers, every published width), random weights from seed 0
              made on the card, 8 requests of 16–1024 prompt tokens (drawn
              from seed 0) and 32 new tokens each, ``max_batch = 8``,
              ``max_len = 2048``: run 1 in float32 (activations and
              parameters), every served token equal to the argmax of the
              port's teacher-forced ``forward_full`` except printed near-ties
              (``LM_F32_GAP``), and those logits within ``LM_F32_ATOL`` of a
              ``forward_full`` whose attention runs the plain versions; run 2
              in the inference dtypes of ``cell_config(decode_32k)``
              (bfloat16), teacher-forced agreement >= 95 %.  In each engine
              run, flash launches = 36 x prefills on the path of its dtype
              (float32: ``flash_attention``, bfloat16:
              ``flash_attention_wgmma``) and none on the other, and decode
              launches = 36 x decode steps, exactly; a decode step makes
              one host-to-device copy (tokens and positions; the 36 layers'
              lengths are made on the card from it), counted at
              PyTorch's dispatcher (``htod_ops``; the trace shows no
              more), and no synchronisation
              (CUDA's sync debug mode).  Then the same traffic, the same
              prompt lengths (tokens within each vocabulary), through
              ``LM_FAMILY_ENGINES``: olmoe-1b-7b (all 16 layers) and
              deepseek-v2-236b (full width, depth cut to 2 of 60 layers:
              the whole model is 472 GB in bf16) in float32 and bfloat16,
              granite-8b and codeqwen1.5-7b in bfloat16, each freed before
              the next (before them qwen2.5-3b with ``attn_window`` 256 at
              every width, ``LM_WINDOW_LAYERS`` of its 36 layers: float32
              held and timed as run 1, bfloat16 as run 2, the teacher-forced
              forward cutting the same window); flash launches = layers x prefills, decode launches
              = layers x steps (0 for MLA, whose absorbed decode is plain
              PyTorch), the decode step's device time beside its bytes
              bound (every weight, every expert, the caches' valid prefix)
              and peak memory.  Dense: bf16 teacher-forced agreement >= 95
              %.  MoE at the served capacity, where teacher forcing is no
              oracle (a longer input drops other copies): each prefill
              bucket's dropped copies by layer and, in float32, its logits
              with the kernels within ``LM_F32_ATOL`` of the same bucket
              with their plain versions; then the same weights with every
              copy kept (``nodrop``: cap >= T at every T), served again:
              float32 tokens = the teacher-forced argmax except near-ties,
              logits within ``LM_F32_ATOL`` of the plain-attention forward
              (where a router chose otherwise only at gates within
              ``ROUTE_TIE``, the difference is reported, not failed);
              bfloat16 agreement >= 95 % over the positions that the engine
              and the teacher-forced forward routed to the same experts in
              every layer (a bf16 rounding can move a token to another
              expert; those positions are counted and printed).  Then also
              mamba2-1.3b (48 layers; exact-length prefills, the
              recurrent decode against the chunked scan's teacher forcing)
              and zamba2-7b (68 Mamba2 layers, 13 shared applications) in
              float32 and bfloat16, musicgen-medium, internvl2-26b (bf16
              flash on the tensor cores at G 6: ``flash_attention`` 0) and
              command-r-35b (~65 GB)
              in bfloat16, all at full depth: float32 as qwen's run, bf16
              >= 95 %, or for mamba2 and internvl2 every disagreement a
              rounding tie (see ``LM_BF16_TIES``), launches = attention
              layers x prefills and x steps (0 for mamba2), the bound
              counting the float32 state read and written and zamba2's
              shared block once per application; internvl2 also runs one
              ``forward_full`` behind a seeded 1,024-row prefix, each
              layer's flash output there within one bf16 ulp of its plain
              version on the same inputs;
8. front    — the front of the paper's pipeline on the card.  Trained
              programs: bonsai/curet-m and protonn/curet-m trained with the
              port's ``train`` (``build(trained=True)``: 1,024 rows, 120
              steps, on the card), seconds and train/test accuracy; float32
              and int8 (calibrated on the training split) compiled on
              ``megakernel_grid`` and with ``use_pallas=True``; every segment
              and chain against its plain version (grid == per-sample
              bitwise), the int8 test-accuracy drop against float32.
              MLPerf-Tiny: ``kws_mlp`` and ``tiny_cnn`` imported through the
              port's ONNX importer, compiled at float32, int8 and int8
              per-channel (calibration ``sample_inputs(name, 128, seed=7)``)
              on ``megakernel_grid``: 1 segment and 2 / 8 interpreted islands,
              each matrix's placement, the segment against its plain version
              and grid == per-sample bitwise on the values the islands hand
              it, the whole program against the ``interpret`` lane (float32
              ``rtol = atol = 1e-5``, int8 within 1 LSB of the output scale:
              the float ``softmax`` island), the int8 argmax agreement with
              the float32 teacher over 256 inputs within ``INT8_MAX_DROP``,
              and a bucket under CUDA's sync debug mode (no island copies to
              the host) with one host-to-device copy (the input).  Serving:
              256 requests per engine through ``ClassicalServeEngine``;
              over these runs megakernel launches = segments x buckets and
              chain launches = chains x buckets, exactly; requests/s on the
              host clock, the segment's device time and bound, its share of
              a bucket and the islands' share of a bucket's device time;
9. store    — the compile-artifact store and profile-guided compilation.
              bonsai/curet-m and protonn/curet-m at float32 and int8 on both
              served paths (8 engines) compiled through ``get_program`` into
              a fresh ``ArtifactStore``, cold compile seconds printed, a
              seeded bucket of 64 run on each (launches: megakernel 1,
              chains = chains); an artifact with the JAX package's magic is
              a miss and never unpickled; ``AsyncServeEngine(max_resident=1,
              artifact_store=...)`` serves the two float32 megakernel
              tenants in 6 turns, every turn after the first restored from
              the store (5 cache hits), predictions equal to the resident
              program's; ``profile_device(quick=True)`` on the card (its
              seconds, the gemv/add/relu, chain and segment fits, chain and
              per-sample megakernel launches > 0) and ``autotune_knobs``
              (each ``chain_split_bytes`` candidate's µs, the winner), the
              table published; bonsai/curet-m float32 and int8 compiled with
              ``cost_source="measured", autotune=True,
              chain_split_bytes="auto", use_pallas=True``: cost_source stays
              "measured", outputs bitwise equal to the analytic compile's,
              assignments and schedule totals printed, no profiling.  Then
              a fresh process (``chip_smoke.py --store-child``) loads every
              engine with a fresh compiler: ``pf_source == "artifact"``, the
              parent's fingerprint, the parent's outputs bitwise (through an
              ``.npz``), the expected launches, load seconds beside the cold
              compile seconds; and its measured-mode compiles find the table
              in the store (0 calls into ``profile_device``);
10. lm-train — training on the card.  The flash backward kernels
              (``flash_attention_bwd``: the tensor-core route, counted as
              ``flash_attention_bwd_wgmma``, where ``flash_bwd_route``
              picks it, else the CUDA-core route) against their plain
              version (autograd through ``flash_attention_ref``) at B 1, S
              1,024 (``FLASH_BWD_S``), float32 and bfloat16, at every head
              shape phase 7 serves: qwen2.5-3b's (16 / 2 / 128),
              ``FAMILY_HEADS`` (deepseek-v2's MLA with v and the output's
              gradient zero past column 128), ``NEW_HEADS``,
              ``SHARED_HEADS`` without and with a window of 256, and
              qwen2.5-3b's with that window and with full attention; each
              case's route printed and counted (every head shape must
              take the tensor cores in both dtypes, float32 at DHP 256 in
              row tiles of 16 slots; each float32 case also on
              ``route="simt"``, the CUDA cores), a
              second call bitwise equal to the first; dq, dk, dv within ``FLASH_BWD_F32_REL`` of each one's
              largest magnitude (float32) or ``FLASH_BWD_BF16_ULPS`` bf16
              ulps of it (bfloat16), the rows' log-sum-exp within
              ``FLASH_BWD_LSE_REL``; the same at qwen2.5-3b's heads at the
              lengths the 36-layer run trains (S 4,096 and 2,048), and at
              internvl2's, the MLA and zamba2 heads at S 4,096, in both
              dtypes; in float32 with q and k ``FLASH_BWD_PEAK`` times
              larger (peaked scores) at qwen2.5-3b's and internvl2's heads
              at S 4,096, on the tensor cores, within the same limits; and
              with q and k ``FLASH_BWD_PEAKS`` times larger at the four
              ``FLASH_BWD_PEAK_HEADS``, S 1,024, within the same limits of
              the exact gradient (float64 from the same inputs), at x8 also
              of the plain version, two calls bitwise equal, and at
              ``FLASH_BWD_PEAK_READ`` the same shares read, held to
              neither;
              and in
              every case the training forward (``flash_attention_fused``,
              p in fp32) on the same inputs against its plain version
              within phase 6's limits (``attn_compare``).  The float32 twin: qwen2.5-3b at every
              width, 4 layers, S 1,024, batch 2, seed 0: the first gradient
              of every weight (each must exist) within
              ``LM_TRAIN_GRAD_REL`` of the same model's with the attention's
              plain version, then 3 AdamW steps of each, losses within
              ``LM_TRAIN_LOSS_RTOL``.  The backward with p rounded to
              bfloat16 (``round_p``, the model's ``attn_probs_bf16``) on
              the route it takes (bfloat16: the tensor cores, counted as
              ``flash_attention_bwd_wgmma``, each case forced onto the
              CUDA-core pair beside it, ``route="simt"``; float32: the
              CUDA-core pair, counted as ``flash_attention_bwd``)
              at qwen2.5-3b's, MLA's and zamba2's heads, S 1,024, both
              dtypes, and at qwen2.5-3b's at S 4,096 in bfloat16 (the
              36-layer run's shape; v rounded to bfloat16 as the model
              rounds it), as the cases above (``bwd_case``), against the
              plain version's gradient (the row max attached): float32
              within ``FLASH_BWD_ROUNDED_REL`` of each gradient's largest,
              bfloat16 within ``FLASH_BWD_BF16_ULPS`` bf16 ulps, and both,
              over the whole tensor, nearer the rounded gradient than the
              fp32-p or detached-max one (``FLASH_BWD_FAULT_SHARE``),
              where the fp32-p backward, run beside each case as a
              control, must fail them; two calls bitwise equal; the float32
              call read against the reference's several-chunk function
              (kv_chunk 256); the forward (both kernels round p against
              the row's max) within phase 6's limits, and in bfloat16
              bitwise on ``FLASH_ROW_MAX_BITWISE`` of its outputs, which
              the key tile's running max must fail; at the same heads
              on one-hot attention, where dq and dk are each row's argmax
              share (so they show that the dkdv kernels' S^T equals the dq
              kernel's max bitwise), within ``FLASH_BWD_ARGMAX_REL`` of the
              shares' largest; the bfloat16 forward on scores that rise
              along the keys at S 1,024 and 4,096, causal and full,
              against the same bitwise limit and control; then the
              float32 twin again with
              ``attn_probs_bf16`` (``flash_attention`` forward with p
              rounded against the row's max, ``flash_attention_bwd``
              backward): losses within ``LM_TRAIN_LOSS_RTOL``, first
              gradients within ``FLASH_BWD_BF16_ULPS`` bf16 ulps of each
              leaf's largest (``LM_TRAIN_PROBS``: it shows the route runs,
              not that the rounding is right).
              olmoe-1b-7b at every width, 2 layers,
              bfloat16: the first gradient (finite), 2 steps (finite
              losses), and ``ProductF32``'s backward at its expert ``bmm``
              and an ``mm`` against autograd through the upcast product
              (one bf16 ulp).  The families whose heads need the
              tensor-core backward's DHP 256 or whole-token row tiles,
              bfloat16 at every width, batch
              2, a first gradient (every weight finite) and 2 steps (finite
              losses), seconds a step, tokens/s, peak memory:
              ``LM_TRAIN_FAMILIES`` zamba2-7b (12 layers: two periods, 2
              applications of the shared block, S 4,096; 2,048 only if it
              does not fit, printed) and internvl2-26b (2 of 48 layers, S
              4,096 of which 256 rows are a seeded vision prefix);
              deepseek-v2-236b's one layer is only counted (5.02 B
              parameters, 84.2 GiB of training state: it does not fit the
              card).  zamba2-7b in float32 (``LM_TRAIN_F32_DHP256``: one
              period, 6 layers, S 1,024): its shared block's dh 224 trains
              on the tensor-core backward's 16-slot row tiles.
              qwen2.5-3b in float32 at every width (``LM_TRAIN_F32``: 8 of
              36 layers, S 4,096, global batch 2 in 2 microbatches, one
              warm-up step and 2 timed, one traced): the float32 backward
              on the tensor cores in training, seconds a step, tokens/s,
              peak memory, launches and the flash backward's share of the
              traced step.  qwen2.5-3b at full width and depth (36
              layers), bfloat16 activations, float32 masters, remat
              ``"nothing"``, S 4,096 (train_4k's; 2,048 only if 4,096 does
              not fit, printed), global batch 2 in 2 microbatches
              (reduced from 256 in 4): one warm-up step and 3 timed steps,
              each's loss (finite), grad norm, seconds, tokens/s, peak
              memory, launches; one more step in a profiler trace for the
              flash backward's and forward's share of device time.  The
              same run again with ``attn_probs_bf16`` (p rounded to
              bfloat16 in P.V, ``LM_TRAIN_PROBS_STEPS``: one warm-up step
              and 2 timed, one traced): finite losses, the rounded-p
              backward on the tensor cores (``flash_attention_bwd_wgmma``
              = layers x microbatches a step, ``flash_attention_bwd``
              none), seconds a step and tokens/s beside the fp32-p run.  Resume:
              ``launch.train.run_training`` on the 4-layer float32 copy (B
              1, S 512), 4 steps straight against 2 steps, a checkpoint and
              2 resumed steps: every master and moment bitwise equal.  In
              every run flash forward launches = 2 x layers x microbatches
              x steps (the forward and its remat recompute) on its dtype's
              kernel, backward launches = layers x microbatches x steps
              (the split and both backward kernels as one) on its route
              (``flash_attention_bwd_wgmma`` in every run), and none on
              the plain twins;
11. dist    — distribution on ``torch.distributed``: a one-rank NCCL group
              (a store in a temporary directory) and the mesh (pod 1,
              data 1, model 1); ``plan_for``'s PF report, notes and bytes a
              device for qwen2.5-3b's train_4k on it; qwen2.5-3b at every
              width, ``DIST_LAYERS`` layers (phase 10's twin), bf16
              activations, fp32 masters, S ``DIST_S``, batch ``DIST_BATCH``
              in ``DIST_MB`` microbatches: ``DIST_STEPS`` steps through
              ``launch.steps.build_cell``'s step with the state placed on
              the plan as the launcher places it, the fp32 reduce (losses,
              grad norms, every master and moment bitwise equal to
              ``make_train_step`` without a mesh from the same seed) and
              ``int8_ef`` (bitwise equal to the EF math of one pod on the
              host around the one-process gradient, the residuals too);
              flash launches over each run = 2 x layers x microbatches x
              steps (``flash_attention_wgmma``) and layers x microbatches
              x steps (``flash_attention_bwd_wgmma``); the step's seconds
              on the mesh and without, peak memory; then ``dryrun.run_cell``
              for the ten archs x four shapes x both production meshes on
              the host, one line of totals.  Several ranks cannot share
              one card under NCCL: 2 and 4 ranks are held on the CPU by
              ``tests/test_torch_distributed.py`` (gloo);
12. tp      — the dense split over ``model`` (``sharding/tp.py``: heads,
              KV groups, FFN columns and the vocabulary, Megatron's
              scheme), its ranks processes on this card over a gloo group
              (``tp_child``; NCCL refuses two ranks on one card; gloo takes
              the CUDA tensors as they lie).  First the decode kernel's
              log-sum-exp output against its plain version (``TP_LSE_TOL``;
              bf16 and f32, one split and many, lengths 0 included: zeros
              and -inf; the output then float32: what a cache over the
              sequence merges before its one rounding), two calls bitwise.  Then this process runs the
              one-process references: qwen2.5-3b at every width,
              ``TP_LAYERS`` layers, float32, ``TP_STEPS`` steps at S
              ``TP_S``, batch ``TP_BATCH`` in ``TP_MB`` microbatches, and a
              ``TP_FWD_S``-token forward; the bf16 engines of ``TP_SERVE``.
              2 ranks at (data 1, model 2): the same training through
              ``build_cell``'s step on the rank's model (its shards), held
              to ``TP_LOGIT_REL``, ``TP_FIRST_REL`` (each rank's first
              moments against its slice of the reference's),
              ``TP_GNORM_RTOL``, ``TP_LOSS_RTOL``; then qwen2.5-3b x4
              (``wk``/``wv`` whole, ``bk``/``bv`` split) and granite-8b x2
              (``wk``/``wv`` split) served on a plan; 4 ranks at (data 1,
              model 4): qwen2.5-3b x4 served on a cache over the sequence
              (each rank its positions; q gathered, the decode kernel's
              log-sum-exp merging the ranks' outputs).  Every rank emits
              the same tokens, within phase 7's bf16 rule against the
              one-process model's teacher forcing.  Launches a rank: flash
              2 x layers x microbatches x steps (``flash_attention``,
              float32) and layers x microbatches x steps
              (``flash_attention_bwd_wgmma``); serving layers x prefills
              (``flash_attention_wgmma``) and layers x decode steps.  Each
              rank's parameter GiB against the whole model's, peak GiB,
              and the step's seconds (ranks time-share the card: a
              rehearsal of correctness, not a scaling figure);
13. tp-moe  — the MoE family over ``model`` (``sharding/tp.py``,
              ``models/moe.py``: the experts' slots, the shared experts'
              columns, MLA's heads with the latent cache over the
              sequence; the full config's plan on the mesh), ranks as in
              phase 12.  2 ranks at (data 1, model 2): olmoe-1b-7b at
              every width, ``TPM_TRAIN`` layers, float32, ``TPM_STEPS``
              steps at S ``TPM_S``, batch ``TPM_BATCH`` in ``TPM_MB``
              microbatches, then a ``TPM_FWD_S``-token forward, on the
              rank's model (32 of 64 experts, 8 of 16 heads, the router
              whole: its gradient summed over ``model``), every MoE
              layer's choices logged (``route_log``); then
              ``TPM_SERVE``'s olmoe-1b-7b x2 and
              deepseek-v2-236b x2 (80 of 160 experts, 64 of 128 MLA heads,
              the shared experts' columns, the latent cache over the
              sequence) served in bfloat16 on a plan; 4 ranks at (data 1,
              model 4): deepseek-v2-236b x2.  Each served twice, phase
              12's traffic: at the served capacity (every rank the same
              tokens; the share equal to the one-process engine's printed)
              and on the no-drop copy (``nodrop``), held to phase 7's MoE
              bf16 rule against the one-process model's teacher forcing
              (built after the ranks ran, one arch at a time).  After the
              ranks this process runs the one-process training and
              forward, each MoE layer routed on the ranks' choices
              (``route_log(force=)``, gated by its own router), and holds
              every rank's losses, grad norms, first moments and logits to
              phase 12's limits; a choice its own router would have made
              otherwise must be a near-tie (``ROUTE_TIE``), reported, and
              the ranks must have routed alike.  Launches a
              rank: flash 2 x layers x microbatches x steps
              (``flash_attention``, float32) and layers x microbatches x
              steps (``flash_attention_bwd_wgmma``); serving layers x
              prefills (``flash_attention_wgmma``: MLA at dh 192 on 64 or
              32 heads) and layers x decode steps (0 under MLA, whose
              absorbed decode is PyTorch products); parameter GiB a rank
              against the whole model's;
14. tp-ssm  — the ``ssm`` and ``hybrid`` families over ``model``
              (``sharding/tp.py``, ``models/mamba2.py``: Mamba2's SSM heads,
              conv channels and state; zamba2's shared block on its own
              heads, KV heads at G 1 and FFN columns; the full configs'
              plans), ranks as phase 12's.  This process first runs the
              one-process float32 train references (``tp_train_ref``) of
              ``TPS_TRAIN``: mamba2-1.3b at every width, 4 of 48 layers,
              and zamba2-7b at every width, 6 of 81 block applications
              (one period: 5 Mamba2 layers and the shared block), each S
              ``TP_S``, batch ``TP_BATCH`` in ``TP_MB`` microbatches,
              ``TP_STEPS`` steps, and the bf16 engines of ``TPS_SERVE``;
              then 2 ranks at (data 1, model 2) train both (32 of 64 and 56
              of 112 SSM heads a rank, zamba2's shared block on 16 of 32
              heads: ``fa_kernel`` forward, ``fbt_dkdv2_kernel`` at DHP 256)
              and serve mamba2-1.3b x4 and zamba2-7b x6 in bfloat16 on the
              plan of decode_32k's config (phase 12's traffic; each slot's
              ``h`` over the rank's heads, ``conv_x`` over its channels, the
              shared cache over 16 KV heads: ``fa_tc_kernel`` and
              ``da_kernel`` + ``da_combine`` at dh 224), then 4 ranks at
              (data 1, model 4) serve both again (8 KV heads a rank).
              Held as phase 12's runs: every rank's losses, grad norms
              and a ``TP_FWD_S``-token forward's logits at phase 12's
              limits, its first moments within ``TPS_FIRST_REL`` of each
              leaf's largest (float32 reordering alone moves some leaves of
              these models past phase 12's 1e-5; see the constant); every
              rank the same tokens, phase 7's
              bf16 rule against the one-process model's teacher forcing
              (``LM_BF16_TIES``: mamba2's flips rounding ties); launches a
              rank: flash 2 x applications x microbatches x steps
              (``flash_attention``) and 1 x (``flash_attention_bwd_wgmma``),
              serving applications x prefills (``flash_attention_wgmma``)
              and applications x decode steps (0 for mamba2); parameter
              GiB a rank against the model's, peak GiB and step seconds
              (read, not gated).  No new kernel: each it launches has its
              plain-version check in phases 6 and 10;
15. tp-dp   — serving over data-parallel ranks (``serve/engine.py``,
              ``sharding/tp.py``'s ``DataSplit``; ranks as phase 12's):
              ``TPD_SERVE``'s qwen2.5-3b x4, deepseek-v2-236b x2 and
              zamba2-7b x6 in bfloat16 on the plan of decode_32k's config
              at (data 2, model 1) (2 ranks) and (data 2, model 2) (4
              ranks), phase 12's traffic: each data rank holds and decodes
              4 of the 8 slots, the model split of phases 12-14 inside it
              (qwen's cache over KV heads, deepseek's latents over the
              sequence, zamba2's ``h``/``conv_x`` over SSM heads and its
              shared cache over KV heads at model 2), the MoE decode
              routed over the whole batch (the data ranks as the token
              group), every rank prefilling every request, and deepseek's
              weights on the plan's FSDP over ``data`` (8.99 B parameters:
              more than 8 GB of bf16 a model rank): a rank holds its data
              shard, gathers a layer's leaves while the layer runs, and
              runs the experts, the embedding, the head and ``wo`` on their
              shards (the activations move, not the weights).  Held as
              phases 12-14's serving runs (every rank the same tokens,
              phase 7's bf16 rule against the one-process model's teacher
              forcing; MoE: at the served capacity and on the no-drop
              copy, each request's routes from the rank that decoded it),
              launches a rank = attention applications x prefills (flash)
              and x decode steps (its rows), each rank's caches at 4 rows,
              its resident parameters its model shard's less, under FSDP,
              the other data rank's share of the FSDP leaves.  No new
              kernel;
16. count   — one whole step counted (``launch/op_analysis.py``, the
              dry-run's count): qwen2.5-3b at every width,
              ``COUNT_LAYERS`` layers, bfloat16 activations and float32
              masters, one train step (the optimizer included) at S
              ``COUNT_S``, batch ``COUNT_BATCH`` in ``COUNT_MB``
              microbatches, counted twice: on meta tensors (nothing
              allocated, as the dry-run counts) and run on the card under
              ``analyze``.  Both must give equal flops and products, the
              same kernel calls by name, equal to the card step's
              ``LAUNCHES`` deltas (flash forward 2 x layers x microbatches
              for the remat, the backward layers x microbatches), and
              bytes within ``COUNT_BYTES_REL`` of each other (each op
              whose count differs printed), the card's count after a warm
              step; then the step timed alone (median of ``COUNT_REPS``,
              synchronised): the counted TFLOP beside the step's seconds
              and the share of the card's 989 TFLOP/s bf16 peak they
              give.  No new kernel;
17. tp-uneven — the planner's uneven splits over ``model``
              (``allow_uneven``: GSPMD's pieces, ``ceil(n / m)`` a rank)
              at (data 1, model 3), ranks as phase 12's: the kernels with
              a head offset (a rank's query heads need not be whole KV
              groups: ``fa_tc_kernel``, ``fa_kernel``, ``fbt_*`` and
              ``fb_*`` in both dtypes, ``da_kernel``) against their plain
              versions at granite-8b's and qwen2.5-3b's rank-1 shapes,
              each timed beside the same call on whole groups; qwen2.5-3b
              x4 and granite-8b x2 (K and V gathered) and olmoe-1b-7b x2
              (experts 22, 22, 20) trained one float32 step and served in
              bfloat16 on the uneven plans, held as phases 12 and 13 hold
              theirs (the first moments at ``TPU_FIRST_REL``, measured
              against a float64 step); a planted fault (``TPU_FAULT``:
              granite-8b's step with K and V's gradient not summed over
              model) must keep the logits' limit and fail the first
              moments'; qwen2.5-3b's step counted on meta
              (the dry-run's ``count_cell``) and on the card for rank 0
              (the largest piece) and rank 2 (the shortest): flops,
              products and kernel
              calls equal, bytes within ``COUNT_BYTES_REL``; each rank's
              resident parameter GiB beside its GSPMD piece; the main
              path's attention calls on heads that are not whole groups
              counted (``offset_calls``).  No new kernel;
18. report  — the chain kernels' launch floor (an empty kernel with their
              parameter block) beside each served chain call's device time
              and time per call, against ``CHAIN_DEVICE_MS`` /
              ``CHAIN_FLOOR_X`` / ``CHAIN_CALL_MS`` (printed, not checked);
              the device time of every kernel, its plain version and,
              where one PyTorch call computes the same function, that call
              (kernel durations from a ``torch.profiler`` trace, per call);
              each kernel's time per call between CUDA events, which
              includes the wrapper's host work; the bounds; the engines'
              serving rate on the host clock and the megakernel's share of
              it; the LM engine's prefill ms per request, decode ms per
              step at batch 8, generated tokens/s and the attention
              kernels' share of a decode step's device time (decode
              attention's two passes, ``DECODE_PASSES``); the flash
              backward at qwen2.5-3b's, internvl2's, the MLA and zamba2
              heads, S 4,096 and 1,024, bfloat16 and float32, on the
              tensor cores and (float32, and bfloat16 at S 1,024 and at
              qwen's) on the CUDA cores, beside its plain version, SDPA's backward
              (alone, and with its forward), its bound (five products at
              the type's peak; for the float32 tensor-core route three
              16-bit products for each of the five at the 16-bit peak,
              beside the fp32 one and the 16-bit bound of the products
              the kernels issue, as ``fbt_query`` states them, and the
              plan's shared memory checked against the kernels'; the
              kernels line's ``flash_attention_bwd`` is zamba2's float32
              at S 1,024 on ``route="simt"``; its model path is float32
              training with ``attn_probs_bf16``, timed beside it as
              ``rounded``);
              internvl2's G 6 forward at S
              4,096 beside masked SDPA; decode attention at qwen2.5-3b's
              served shape with the log-sum-exp output, and in bfloat16
              with it and a float32 output, beside the row without it,
              and with a window of 256 on the full-length cache beside
              SDPA with the window's mask (the bound reads the window's
              keys); the backward with p rounded to bfloat16 at qwen's
              heads, S 4,096 and 1,024 (bfloat16: on the tensor cores and
              forced onto the CUDA cores) and 1,024 (float32: the CUDA
              cores), beside the tensor cores' fp32-p call and its plain
              version (no PyTorch call
              rounds p: no library time), and the bfloat16 forward with p
              rounded against the row's max beside the key tile's running
              max at S 1,024, and alone at the 36-layer run's S; the
              kernels line's ``flash_attention_bwd_wgmma_rounded`` and
              ``flash_attention_wgmma_row_max`` (launches: the 36-layer
              ``attn_probs_bf16`` run's; times and max abs errors at its
              shape, S 4,096);
              the
              ``kernels`` JSON line (the forward flash kernels' launches
              are the served paths', their training launches beside them,
              and phases 12's to 15's and 17's summed over their ranks,
              ``tp_launches``; the ``*_offset`` entries: phase 17's
              kernels with a head offset, their launches phase 17's and
              ``offset_calls`` the calls on heads that are not whole
              groups),
              the card line, and last ``{"ok": true, "device": {...}}``.

Every path runs at its full depth, except deepseek-v2-236b (2 of 60
layers, every width kept), phase 10's training runs beside qwen2.5-3b
(every width kept; depths as ``LM_TRAIN_FAMILIES`` states), phase 11's
mesh runs (``DIST_LAYERS`` of qwen2.5-3b's 36 layers, every width kept),
phase 12's (``TP_LAYERS`` of qwen2.5-3b's, 2 of granite-8b's 36),
phase 13's (2 of olmoe-1b-7b's 16, 2 of deepseek-v2-236b's 60), phase
14's (4 of mamba2-1.3b's 48 layers, 6 of zamba2-7b's 81 block
applications), phase 15's (phases 12-14's depths) and phase 17's (4 of
qwen2.5-3b's 36, 2 of granite-8b's 36, 2 of olmoe-1b-7b's 16), each cut
for the phase's time, every width kept.

Needs only the repository (``src/`` on the path) and one card.  Writes the
full per-case report to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 10 trains qwen2.5-3b at full width in ~70 of the card's 79 GiB:
# segments that grow keep the allocator's free memory in one piece
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # fp32 outside the tensor cores
            "bfloat16": 989e12,    # dense bf16 tensor-core peak
            "int8": 1979e12, "int16": 1979e12}   # int8 tensor-core peak
BUCKET = 64
SERVE_REQUESTS = 256
# phase 8: the trained Table-I programs; the training-split rows int8
# calibrates on (as the program cache does); the MLPerf-Tiny int8 gate
# (tests/test_onnx_frontend.py's INT8_MAX_DROP) and islands per plan
TRAINED = ("bonsai/curet-m", "protonn/curet-m")
TRAINED_CALIB = 256
INT8_MAX_DROP = 0.015
TINY_ISLANDS = {"kws_mlp": 2, "tiny_cnn": 8}
MK_KERNEL = "mk_segment_kernel"     # the megakernel, by name in a trace
F32_RTOL = F32_ATOL = 1e-5
# aims of a served chain call, printed beside its times (not checked): device
# ms, that over an empty kernel's, ms per call between CUDA events
CHAIN_DEVICE_MS, CHAIN_FLOOR_X, CHAIN_CALL_MS = 0.0013, 1.5, 0.020
LM_ARCH = "qwen2.5-3b"
LM_REQUESTS, LM_NEW_TOKENS, LM_MAX_BATCH, LM_MAX_LEN = 8, 32, 8, 2048
LM_PROMPT_LEN = (16, 1024)
# float32 served path vs teacher forcing: a served token may differ from the
# teacher-forced argmax only where that argmax leads the served token by less
# than LM_F32_GAP (a near-tie the two paths' rounding can flip: prefill on a
# padded bucket and one token at a time through the decode kernel, against
# one unpadded flash pass).  LM_F32_ATOL bounds the teacher-forced logits
# against the same forward with the attention kernels' plain versions.
LM_F32_GAP = 1e-3
LM_F32_ATOL = 1e-3
LM_BF16_AGREE = 0.95
# bf16 engines that read below LM_BF16_AGREE on the card without a fault found
# (ROADMAP Queue C item 11): mamba2-1.3b, whose engine decodes by the
# recurrence while its teacher forcing runs the chunked scan, and
# internvl2-26b.  There every disagreement must instead be a rounding tie:
# the teacher-forced argmax leads the served token by no more than moving
# each element of the head's bf16 input by one ulp can change the two
# logits' difference, sum_i ulp(h_i) |W[i, argmax] - W[i, served]|
# (``tie_grain``).  The limit depends on the weights and the normed input
# only, not on how far a kernel is off its plain version.
LM_BF16_TIES = ("mamba2-1.3b", "internvl2-26b")
# phase 7's engines beside qwen2.5-3b: (arch, dtype, layers; None: all).
# deepseek-v2's 60 layers (472 GB in bf16) do not fit on one card, so it
# runs at full width on 2 layers.
LM_FAMILY_ENGINES = (("olmoe-1b-7b", "float32", None),
                     ("olmoe-1b-7b", "bfloat16", None),
                     ("deepseek-v2-236b", "float32", 2),
                     ("deepseek-v2-236b", "bfloat16", 2),
                     ("granite-8b", "bfloat16", None),
                     ("codeqwen1.5-7b", "bfloat16", None),
                     ("mamba2-1.3b", "float32", None),
                     ("mamba2-1.3b", "bfloat16", None),
                     ("zamba2-7b", "float32", None),
                     ("zamba2-7b", "bfloat16", None),
                     ("musicgen-medium", "bfloat16", None),
                     ("internvl2-26b", "bfloat16", None),
                     ("command-r-35b", "bfloat16", None))
# A MoE router's choices may differ between two float32 runs of one input
# that differ only in rounding (the attention kernels against their plain
# versions) where two gates lie within ROUTE_TIE of each other: the token
# then goes to another expert, and its logits move by more than LM_F32_ATOL
# with no fault.  Such a difference passes only where every choice that
# differs in the first layer with a difference is such a near-tie (later
# layers see that layer's other output).
ROUTE_TIE = 1e-4
# the two passes of csrc/decode_attention.cu, by kernel name in a trace
DECODE_PASSES = ("da_kernel", "da_combine")
HTOD = "Memcpy HtoD"               # a host-to-device copy, by name in a trace
TRACE_TRIES = 3                    # traces taken before CUDA events stand in
# (H, KV, dh) of phase 7's other prefills and decodes: olmoe-1b-7b,
# granite-8b, codeqwen1.5-7b, and deepseek-v2's MLA prefill (q and k of
# 128 + 64, v zero-padded to them; its decode runs no kernel)
FAMILY_HEADS = ((16, 16, 128), (32, 8, 128), (32, 32, 128), (128, 128, 192))
# (H, KV, dh) of the remaining dense heads served: command-r-35b,
# internvl2-26b (G 6: bf16 on the CUDA-core kernel) and musicgen-medium;
# then zamba2-7b's shared block (2 x 3584 / 32 = 224), whose decode runs
# against a ring of RING_WIDTH slots at long context and whose prefill
# there takes a window of the same width (``PROBE_WINDOW``)
NEW_HEADS = ((64, 8, 128), (48, 8, 128), (24, 24, 64))
SHARED_HEADS = (32, 32, 224)
RING_WIDTH = PROBE_WINDOW = 256
# Sliding windows on a full-length decode cache (phase 6): W of
# PROBE_WINDOW and 1,024 at S = LM_MAX_LEN
WINDOWS = (PROBE_WINDOW, 1024)
# ... and in serving (phase 7): qwen2.5-3b with attn_window PROBE_WINDOW at
# every width, its depth cut to this many of 36 layers (phase 12's, for time)
LM_WINDOW_LAYERS = 4
# the chunked SSD scan against its sequential oracle, one full-width layer
# of each model: (label, H, P, N) at B 1, S 1024, chunk 128; float32 limit
# max |difference| <= SSD_RTOL x max |y|
SSD_LAYERS = (("mamba2-1.3b", 64, 64, 128), ("zamba2-7b", 112, 64, 64))
SSD_RTOL = 1e-5
# lm-train.  The flash backward kernels against their plain version
# (autograd through flash_attention_ref on the same inputs), each of dq, dk,
# dv against its own largest magnitude: float32 within FLASH_BWD_F32_REL of
# it (the kernels sum up to S x G terms in fp32 in another order than the
# plain version, and ds = p (dp - D) cancels, which lifts the rounding of
# the sums above 2^-24 of the result; the CPU tests hold the plain version
# to XLA's autodiff within 1e-5 of the same scale); bfloat16 within
# FLASH_BWD_BF16_ULPS bf16 ulps of it (both round one fp32 result once: up
# to one ulp each way); the rows' log-sum-exp (fp32 in both) within
# FLASH_BWD_LSE_REL of its largest magnitude.  B 1, S FLASH_BWD_S.
FLASH_BWD_F32_REL = 1e-4
FLASH_BWD_BF16_ULPS = 2
# ... with p rounded to bfloat16 (attn_probs_bf16), float32: within
# FLASH_BWD_ROUNDED_REL of each gradient's largest.  The kernels read up to
# about 2e-4 of it; the two faults this limit is there to catch lie beyond
# it at these shapes: the fp32-p gradient (1.8e-3 to 3.9e-3 of dq's or dk's
# largest) and the rounded gradient with the row max detached (2.3e-3 to
# 8.5e-3; tests/test_torch_probs_bf16.py::test_rounded_limit_sees_both_faults).
# The fp32-p backward runs beside each float32 case as a control that must
# fail it.  bfloat16: FLASH_BWD_BF16_ULPS bf16 ulps.  Float32 runs on fb_*
# (whose sums follow the plain version's order): the tensor cores'
# fp16-term arithmetic read 2.1e-3 at MLA's heads (PERF.md §6).
FLASH_BWD_ROUNDED_REL = 1e-3
# ... and in either dtype over the whole tensor, where a bfloat16 gradient's
# FLASH_BWD_BF16_ULPS hide both faults: each gradient's share of the way
# from the plain rounded gradient towards each fault (fp32 p, the detached
# max; profile_kernels.fault_shares) at most FLASH_BWD_FAULT_SHARE, so nearer
# the rounded gradient than the fault's.  A share is read where the output's
# own rounding moves it by at most FLASH_BWD_FAULT_NOISE, and each case reads
# every fault in one gradient at least; the fp32-p backward, run beside each
# case as the control, must exceed it.
FLASH_BWD_FAULT_SHARE, FLASH_BWD_FAULT_NOISE = 0.5, 0.1
# One-hot attention (profile_kernels.argmax_inputs): the rounded-p gradient's
# dq and dk are 0 up to fp32 rounding, and without a row's argmax share they
# are its size; held within FLASH_BWD_ARGMAX_REL of the largest that the
# detached max gives them (the shares alone)
FLASH_BWD_ARGMAX_REL = 1e-3
# The bfloat16 forward rounding p against the row's max: at least
# FLASH_ROW_MAX_BITWISE of its outputs bitwise the plain version's, which the
# key tile's running max (round_p=True on the same inputs, the kernel it
# replaced) must fail.  Read on the card (PERF.md §6): the row's max
# 0.9525 to 0.9969 (the least on scores rising along 4,096 keys, full), the
# tile's 0.6008 to 0.8876 (the most on rising scores, 1,024 keys, full)
FLASH_ROW_MAX_BITWISE = 0.92
FLASH_BWD_LSE_REL = 1e-5
FLASH_BWD_S = 1024
# The float32 backward's peaked-score cases: q and k this many times larger
# (scaled scores of standard deviation 25, a row's attention on a few keys)
FLASH_BWD_PEAK = 5.0
# ... and further, at FLASH_BWD_S and every float32 head of FLASH_BWD_PEAK_HEADS:
# held to the exact gradient (float64 from the same inputs; the plain
# version is itself up to 0.9 of the limits from it at x12), at x8 also to
# the plain version; FLASH_BWD_PEAK_READ read against both, held to neither
FLASH_BWD_PEAKS, FLASH_BWD_PEAK_READ = (8.0, 12.0), 16.0
# qwen2.5-3b's, internvl2-26b's (G 6), zamba2-7b's (dh 224) and deepseek-v2's
# MLA heads (dh 192, v zero-padded)
FLASH_BWD_PEAK_HEADS = ((16, 2, 128), (48, 8, 128), (32, 32, 224), (128, 128, 192))
# The float32 twin check: qwen2.5-3b at every width, LM_TRAIN_LAYERS layers,
# S LM_TRAIN_S, LM_TRAIN_STEPS AdamW steps from seed 0, against the same
# model differentiating the attention's plain version: each step's loss
# within rtol LM_TRAIN_LOSS_RTOL, each parameter's first-step gradient
# within LM_TRAIN_GRAD_REL of its largest magnitude (the forward kernel
# moves the output by 1e-5 and the backward kernels the attention's
# gradients by 1e-4 of their scale; a gradient cut off at a kernel without
# a backward is off by all of it).
LM_TRAIN_LAYERS, LM_TRAIN_S, LM_TRAIN_STEPS = 4, 1024, 3
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_REL = 1e-4, 1e-3
# LM_TRAIN_PROBS: the twin again with attn_probs_bf16 (p rounded to
# bfloat16 in P.V): losses within LM_TRAIN_LOSS_RTOL, each first-step
# gradient within FLASH_BWD_BF16_ULPS bf16 ulps of its leaf's largest.
# Not LM_TRAIN_GRAD_REL: fp32 arithmetic fixes the rounded function's
# gradient only to about 1e-3 of its largest at the twin's attention (each
# layer's dq: the kernels and the plain version alike 6.0e-4 to 1.85e-3
# from the same function in float64, 2.5e-4 to 6.7e-4 from each other; the
# leaves part by up to 2.25e-3: tools/probs_bf16_f64.py on the card).  So
# the twin shows that training with attn_probs_bf16 runs through the
# rounded kernels end to end, not that the rounding is right: an fp32-p
# backward parts from the rounded one by about as much (2.2e-3) and would
# pass.  The kernel cases above (FLASH_BWD_ROUNDED_REL, with the fp32-p
# control) carry that check.
# olmoe-1b-7b in bfloat16 at every width: the router and the expert bmm's
# backward (arch, layers, steps)
LM_TRAIN_MOE = ("olmoe-1b-7b", 2, 2)
# qwen2.5-3b at full width and depth, train_4k's sequence length; reduced:
# global batch 256 -> 2, microbatches 4 -> 2.  LM_TRAIN_FULL_S_OOM if that
# does not fit the card.
LM_TRAIN_FULL_S, LM_TRAIN_FULL_S_OOM = 4096, 2048
LM_TRAIN_FULL_BATCH, LM_TRAIN_FULL_MB = 2, 2
LM_TRAIN_FULL_STEPS, LM_TRAIN_FULL_WARM = 3, 1
# ... and again with attn_probs_bf16 (p rounded to bfloat16 in P.V: the
# row-max forward and the rounded-p backward on the tensor cores), one
# warm-up step and two steps, beside the run with p in fp32
LM_TRAIN_PROBS_STEPS, LM_TRAIN_PROBS_WARM = 2, 1
# the bf16 families whose heads need the tensor-core backward's DHP 256
# or whole-token row tiles, at every width: (arch, layers, S, S should S
# not fit the card).
# zamba2-7b: two periods of its pattern (10 Mamba2 layers, 2 applications
# of the shared block, dh 224); internvl2-26b: 2 of 48 layers (G 6), S
# counting LM_TRAIN_PREFIX seeded vision-prefix rows.  Batch
# LM_TRAIN_FAMILY_BATCH in one microbatch, a first gradient, then
# LM_TRAIN_FAMILY_STEPS steps.  deepseek-v2-236b is not trained: one of its
# layers holds 5.02 B parameters (``LM_TRAIN_NOT_FIT``), whose f32 masters,
# Adam moments and bf16 weights (14 bytes each) with the f32 gradient sum
# (4 more) need 84.2 GiB of the card's 79.2.
LM_TRAIN_FAMILIES = (("zamba2-7b", 12, 4096, 2048), ("internvl2-26b", 2, 4096, 2048))
# zamba2-7b in float32, one period of its pattern (5 Mamba2 layers, 1
# application of the shared block), S 1,024, as the families above: its dh
# 224 (DHP 256) trains on the float32 backward's 16-slot row tiles
LM_TRAIN_F32_DHP256 = ("zamba2-7b", 6, 1024, 1024)
# qwen2.5-3b in float32 at every width: LM_TRAIN_F32 layers of 36 at S
# LM_TRAIN_FULL_S, global batch and microbatches as the 36-layer run,
# LM_TRAIN_F32_WARM + LM_TRAIN_F32_STEPS steps and one traced
LM_TRAIN_F32, LM_TRAIN_F32_STEPS, LM_TRAIN_F32_WARM = 8, 2, 1
# The float32 backward on the tensor cores: the fewest 16-bit products that
# meet the float32 limits for each of the five products the gradient needs
# (two fp16 terms of each operand, hi.hi + hi.mid + mid.hi: one term fewer
# of any operand misses, tests/test_torch_flash_f32tc.py)
FLASH_BWD_F32_MIN_PRODUCTS = 3
# internvl2-26b's heads, G 6: the forward's and backward's whole-token tiles
G6_HEADS = (48, 8, 128)
LM_TRAIN_FAMILY_BATCH, LM_TRAIN_FAMILY_STEPS, LM_TRAIN_PREFIX = 2, 2, 256
LM_TRAIN_NOT_FIT = ("deepseek-v2-236b", 1)
# launch.train.run_training on the 4-layer float32 copy: LM_RESUME_STEPS
# steps straight, against LM_RESUME_AT steps, a checkpoint, and a resumed
# run to the end; batch and length of each step
LM_RESUME_STEPS, LM_RESUME_AT, LM_RESUME_BATCH, LM_RESUME_S = 4, 2, 1, 512
# phase dist: qwen2.5-3b at every width, DIST_LAYERS of 36 layers (phase
# 10's twin), S DIST_S, global batch DIST_BATCH in DIST_MB microbatches,
# DIST_STEPS steps on the mesh (pod 1, data 1, model 1) of a one-rank NCCL
# group, fp32 and int8_ef, each against its reference from seed 0
DIST_LAYERS, DIST_S, DIST_BATCH, DIST_MB, DIST_STEPS = 4, 4096, 2, 2, 2
# then the fp32 step's seconds on the mesh and without, in turns after a
# warm-up step of each
DIST_TIMING = ("plain", "mesh", "mesh", "plain", "plain", "mesh")
# phase tp: the dense split over `model` (src/repro_torch/sharding/tp.py),
# its ranks processes on this one card over a gloo group (NCCL refuses two
# ranks on one card).  Training: qwen2.5-3b at every width, TP_LAYERS of 36
# layers (phase 11's depth), float32, S TP_S, global batch TP_BATCH in
# TP_MB microbatches, TP_STEPS steps at (data 1, model 2), against the
# one-process step this process runs first from the same seed.  Limits,
# stated before the first card run (a sum split over ranks only reorders
# float32 adds): a forward's logits (one sequence of TP_FWD_S tokens)
# within TP_LOGIT_REL of the one-process forward's largest logit; the first
# update's moments (the first gradient) within TP_FIRST_REL of each leaf's
# largest magnitude; grad norms rtol TP_GNORM_RTOL, losses rtol
# TP_LOSS_RTOL.  Masters are not compared element by element after AdamW:
# its first update is lr·sign(g) wherever |g| >> eps, so a rounding-level
# difference on a near-zero gradient moves a master by up to 2·lr.
TP_LAYERS, TP_S, TP_BATCH, TP_MB, TP_STEPS, TP_FWD_S = 4, 1024, 2, 2, 2, 128
# phase 16: the counted step (qwen2.5-3b, bf16 activations), and how far
# apart the meta and card counts' bytes may lie (ops the two devices run
# differently: none is known, so any difference is printed by op)
COUNT_LAYERS, COUNT_S, COUNT_BATCH, COUNT_MB, COUNT_REPS = 4, 1024, 2, 2, 3
COUNT_BYTES_REL = 0.01
TP_LOGIT_REL, TP_FIRST_REL, TP_GNORM_RTOL, TP_LOSS_RTOL = 1e-5, 1e-5, 1e-5, 1e-4
# serving: the bfloat16 engine on a plan, (arch, layers, model ranks), each
# rank the same TP_REQUESTS requests of TP_PROMPT_LEN prompt tokens (seed 0),
# TP_NEW_TOKENS each (phase 7's traffic, prompts cut to fit TP_MAX_LEN): qwen2.5-3b (wk/wv whole, bk/bv split) at model 2,
# granite-8b (wk/wv split) at model 2, and qwen2.5-3b at model 4, where its
# 2 KV heads do not divide the axis: a cache over the sequence, the decode
# kernel's log-sum-exp.  Tokens under phase 7's bf16 rule (teacher-forced
# agreement >= LM_BF16_AGREE) against the one-process model.
TP_SERVE = (("qwen2.5-3b", 4, 2), ("granite-8b", 2, 2), ("qwen2.5-3b", 4, 4))
TP_REQUESTS, TP_NEW_TOKENS, TP_MAX_BATCH, TP_MAX_LEN = 8, 32, 8, 512
TP_PROMPT_LEN = (16, 256)
# the decode kernel's log-sum-exp against its plain version: |lse - lse'|
# <= TP_LSE_TOL * max(1, |lse'|); -inf (no keys) exactly
TP_LSE_TOL = 1e-5
# phase tp-moe: the MoE family over `model` (experts, the shared experts'
# columns, MLA's heads with the latent cache over the sequence; the plan of
# the full config on the mesh).  Training: olmoe-1b-7b at every width,
# TPM_TRAIN[1] of 16 layers, float32, S TPM_S, global batch TPM_BATCH in
# TPM_MB microbatches, TPM_STEPS steps at (data 1, model 2) against the
# one-process step this process runs after the ranks from the same seed,
# under phase tp's limits (TP_LOSS_RTOL, TP_GNORM_RTOL, TP_FIRST_REL,
# TP_LOGIT_REL, stated before the first card run).  A split reorders the
# attention's fp32 sums, so a router at a near-tie may choose another
# expert: the ranks' routes are logged (route_log) and the one-process
# run routes on them (route_log(force=)), so steps, first moments and
# logits are held on every run; a choice its own router would have made
# otherwise must be a near-tie (ROUTE_TIE), reported.  Serving:
# (arch, layers, model ranks) in bfloat16 on the plan of decode_32k's
# config, phase tp's traffic, at the served capacity (every rank the same
# tokens; the share equal to the one-process engine's printed) and on the
# no-drop copy (nodrop), held to phase 7's MoE bf16 rule: teacher-forced
# agreement >= LM_BF16_AGREE over the positions routed alike.
TPM_TRAIN = ("olmoe-1b-7b", 2)
TPM_S, TPM_BATCH, TPM_MB, TPM_STEPS, TPM_FWD_S = 1024, 2, 2, 2, 128
TPM_SERVE = (("olmoe-1b-7b", 2, 2), ("deepseek-v2-236b", 2, 2),
             ("deepseek-v2-236b", 2, 4))
# phase tp-ssm: the ssm and hybrid families over `model` (Mamba2's SSM
# heads, conv channels and state; zamba2's shared block: heads, KV heads at
# G 1, FFN columns; the plans of the full configs).  Training: (arch,
# layers) at every width, float32, phase tp's cell (TP_S, TP_BATCH in
# TP_MB microbatches, TP_STEPS steps, a TP_FWD_S-token forward) at (data 1,
# model 2) against the one-process step this process runs first from the
# same seed, under phase tp's limits: mamba2-1.3b 4 of 48 layers, zamba2-7b
# one period (5 Mamba2 layers and the shared block: 6 of 81 block
# applications), depths cut for the phase's time; the first moments within
# TPS_FIRST_REL of each leaf's largest, not phase tp's TP_FIRST_REL: on a
# sound split of these models float32 reordering alone moves some leaves
# by more than 1e-5 (zamba2-7b x6's shared norm1 reads 1.40e-5, wq and wk
# 1.25e-5, conv_b_w 1.12e-5; mamba2-1.3b x4's A_log 9.79e-6), while a
# planted fault reads four orders of magnitude above the limit
# (tools/tp_ssm_faults.py: w_b left out of the partial leaves, w_b's first
# moments 0.815-1.09 off; the gated norm without its backward all-reduce,
# conv_c_b's 0.362-0.381; NVIDIA H100 80GB HBM3, 700.00 W).  Against a
# float64 step (tools/tp_ssm_first.py, same card) each run lies up to about
# 1e-5 from the exact first update on its own: the float32 one-process step
# 9.73e-6 (mamba2 x4's A_log) and 1.10e-5 (zamba2 x6's shared wq; its
# shared norm1 8.91e-6), a rank 1.19e-5 and 1.26e-5; what the phase holds
# is the distance between the two, which can reach the sum of theirs, so
# the limit stays 2e-5 (1e-5 is under the float32 reference's own error).
# Serving:
# (arch, layers, model ranks) in bfloat16 on the plan of decode_32k's
# config, phase tp's traffic, every rank the same tokens, held to phase
# 7's bf16 rule (LM_BF16_TIES) against the one-process model's teacher
# forcing.
TPS_TRAIN = (("mamba2-1.3b", 4), ("zamba2-7b", 6))
TPS_SERVE = (("mamba2-1.3b", 4, 2), ("zamba2-7b", 6, 2),
             ("mamba2-1.3b", 4, 4), ("zamba2-7b", 6, 4))
TPS_FIRST_REL = 2e-5
# phase tp-dp: serving over data-parallel ranks (pod x data > 1;
# src/repro_torch/serve/engine.py, sharding/tp.py's DataSplit): the
# engine's slots split as the plan splits the caches' batch (TP_MAX_BATCH /
# 2 a data rank), phases 12-14's model split inside each data rank, the
# MoE decode routed over the whole batch, and FSDP's weights over data
# where the plan asks for it (deepseek-v2-236b x2: 8.99 B parameters, more
# than 8 GB of bf16 a model rank at model 1 and 2).  (arch, layers) in
# bfloat16 on the plan of decode_32k's config at each mesh of TPD_MESHES,
# phase tp's traffic, held as phases 12-14's serving runs: every rank the
# same tokens, phase 7's bf16 rule against the one-process model's teacher
# forcing (LM_BF16_TIES; the MoE rule on the no-drop copy), launches a rank
# = attention applications x prefills (every rank prefills every request)
# and x decode steps (its rows); each rank's caches hold TP_MAX_BATCH / 2
# rows, and its resident parameters are its model shard's less, under
# FSDP, all but its 1 / data share of the leaves the plan puts over data.
TPD_SERVE = (("qwen2.5-3b", 4), ("deepseek-v2-236b", 2), ("zamba2-7b", 6))
TPD_MESHES = ((2, 1), (2, 2))
# phase tp-uneven: the planner's uneven splits over `model`
# (allow_uneven: GSPMD's pieces, ceil(n / m) a rank, the last short) at
# (data 1, model TPU_M), ranks as phase 12's.  Training (float32, phase
# 12's cell, TPU_STEPS step): (arch, layers) of TPU_TRAIN (qwen2.5-3b: 16
# heads over 3, 6, 6, 4, ranks 1 and 2 from KV head 0's and 1's middle;
# granite-8b: 32 over 3, 11, 11, 10, its wk/wv 3, 3, 2, so K and V are
# gathered) and the MoE's TPM_TRAIN (olmoe-1b-7b: experts 22, 22, 20,
# heads 6, 6, 4, the vocabulary 16,811, 16,811, 16,810 of 50,432 padded),
# under phase 12's limits but for the first moments' (TPU_FIRST_REL) and
# phase 13's routing (one process routed on the ranks' choices);
# qwen2.5-3b's step then counted on the card by ranks 0
# (the largest piece) and 2 (the shortest) against the dry-run's meta count
# of each (flops, products, kernel calls exact; bytes within
# COUNT_BYTES_REL).  Serving: (arch, layers) of TPU_SERVE in bfloat16 on
# decode_32k's plan at model TPU_M (caches over the sequence: 171, 171 and
# 170 of 512 slots), phase 12's traffic and bf16 rule, olmoe on the no-drop
# copy.  The kernels with a head offset (TPU_OFFSETS: a rank's heads as
# model 3 cuts them, B 1, S TPU_S) against their plain versions at phase
# 6's and 10's limits, each timed beside the same call on whole groups (the
# KV heads' G heads each, offset 0).
TPU_M, TPU_STEPS, TPU_S = 3, 1, 1024
# The first moments at TPU_FIRST_REL (phase 14's measured TPS_FIRST_REL),
# not phase 12's 1e-5: against a float64 step (tools/tp_ssm_first.py
# --train qwen2.5-3b 4 --train granite-8b 2 --model 3 --uneven; NVIDIA H100
# 80GB HBM3, 700.00 W) the float32 one-process step itself lies up to
# 1.77e-5 (qwen2.5-3b x4) and 1.92e-5 (granite-8b x2, wk) from the exact
# first update, and the ranks up to 1.73e-5, so two sound float32 runs
# part by more than 1e-5 (qwen's rank 2 read 1.11e-5, w_gate).  The
# logits keep TP_LOGIT_REL (1e-5; they read 2.2e-6): a dropped head offset
# misses them by far more (tests/test_torch_uneven_split.py).
TPU_FIRST_REL = TPS_FIRST_REL
TPU_TRAIN = (("qwen2.5-3b", 4), ("granite-8b", 2))
TPU_SERVE = (("qwen2.5-3b", 4), ("granite-8b", 2), ("olmoe-1b-7b", 2))
TPU_COUNT = ("qwen2.5-3b", 4, (0, TPU_M - 1))     # the ranks counted
# the first moments' control: (arch, layers) of TPU_TRAIN trained once more
# with K and V gathered over model but their gradient not summed over the
# ranks (granite-8b: KV heads 2 and 5 keep one rank's share), a fault in
# the backward alone: its logits must hold TP_LOGIT_REL and some rank's
# first moments must miss TPU_FIRST_REL
TPU_FAULT = ("granite-8b", 2)
# (label, dtype, H, KV, G, offset, dh): rank 1 of granite-8b and of
# qwen2.5-3b at model 3, in each dtype
TPU_OFFSETS = (("granite-8b rank 1", "bfloat16", 11, 4, 4, 3, 128),
               ("granite-8b rank 1", "float32", 11, 4, 4, 3, 128),
               ("qwen2.5-3b rank 1", "float32", 6, 2, 8, 6, 128),
               ("qwen2.5-3b rank 1", "bfloat16", 6, 2, 8, 6, 128))
# the two routes' kernels, as a trace names them (by substring)
FLASH_BWD_KERNELS = ("fb_dq_kernel", "fb_dkdv_kernel", "fbt_dq_kernel",
                     "fbt_dkdv_kernel", "fbt_dkdv2_kernel", "fbs_split_kernel")
# matmul/gemv cases (M, K, N) of phase 3, each in float32 and bfloat16 with
# both layouts of b: aligned and unaligned pitches, split and unsplit K
MATMUL_SHAPES = ((129, 65, 70), (128, 128, 128), (64, 610, 24),
                 (64, 4096, 4096), (1024, 1024, 1024), (2048, 1020, 2100),
                 (4096, 4096, 4096))


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def fail(name: str, msg: str) -> int:
    print(f"[{name}] FAILED: {msg}", flush=True)
    return 1


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def median_ms(fn, reps: int, warm: int = 3) -> float:
    """Median of per-call times between CUDA events, after a warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_median_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn`` to a synchronised end, after one warm
    call: what a caller waits for, host work included."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def device_ms(fn, reps: int, warm: int = 3) -> tuple[float, str]:
    """Device time per call: the summed durations of the kernels, copies
    and sets the card ran during ``reps`` calls, from a ``torch.profiler``
    (CUPTI) trace, over ``reps``.  Where the trace shows no device
    activity, the time between CUDA events around the ``reps`` calls run
    back to back, over ``reps``.  Returns ``(ms, "profiler" | "events")``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(t for _, t in trace_acts(p)[0])
    if us > 0:
        return us / 1e3 / reps, "profiler"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, "events"


def serve_wall_s(eng, X) -> float:
    """Host-clock seconds for the engine to drain ``X`` (queued first):
    stacking, the copy in, one launch per bucket, the copy out."""
    import torch

    for row in X:
        eng.submit(row)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def segment_work(seg, nb: int) -> tuple[float, float]:
    """(bytes, operations) one bucket of ``seg`` needs: each input, matrix
    and constant read once at the width of its values, each output written
    once; two operations per multiply-add, three per squared-distance term,
    one per other element.

    On the integer lanes the compiler holds weights, vectors and shifts as
    int32 words, but their values are narrow (``seg.bits``): they count at
    that width.  Matvec biases (int32 at the accumulator scale) and SQL2
    points (float32) count at four bytes."""
    import numpy as np

    item = seg.bits // 8 if seg.quantized else 4
    widths = seg.slot_widths
    wide_consts = {ins.operand[1] for ins in seg.instrs
                   if ins.op in ("MATVEC", "SPMV") and ins.operand[1] is not None}
    float_mats = {ins.operand[0] for ins in seg.instrs if ins.op == "SQL2"}
    nbytes = sum(np.size(m) * (4 if mi in float_mats else item)
                 for mi, m in enumerate(seg.matrices))
    nbytes += sum(np.size(c) * (4 if ci in wide_consts else item)
                  for ci, c in enumerate(seg.consts))
    ops = 0
    for ins in seg.instrs:
        if ins.op == "LOAD_VEC" and ins.operand[0] == "in":
            nbytes += nb * widths[ins.dst] * item
        elif ins.op == "STORE":
            dt = (seg.out_dtypes[ins.operand] if seg.out_dtypes else
                  ("float32" if not seg.quantized else f"int{seg.bits}"))
            nbytes += nb * seg.out_widths[ins.operand] * np.dtype(dt).itemsize
        elif ins.op in ("MATVEC", "SPMV"):
            m, k = np.shape(seg.matrices[ins.operand[0]])
            ops += nb * 2 * m * k
        elif ins.op == "SQL2":
            d, m = np.shape(seg.matrices[ins.operand[0]])
            ops += nb * 3 * d * m
        elif ins.op in ("ELEMENTWISE", "REQUANTIZE"):
            ops += nb * widths[ins.dst]
        elif ins.op in ("REDUCE", "ARGMAX", "DOT"):
            ops += nb * widths[ins.src[0]] * (2 if ins.op == "DOT" else 1)
    return float(nbytes), float(ops)


def bound_ms(seg, nb: int, precision: str) -> tuple[float, str]:
    nbytes, ops = segment_work(seg, nb)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[precision] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bucket_inputs(prog, seed: int, n: int = BUCKET):
    """One seeded bucket as the executor hands it to the segment: float32
    rows, quantized at the plan's input scales on the integer lanes."""
    import numpy as np
    import torch

    from repro_torch.core.quantize import quantize_t

    (name, spec), = prog.dfg.graph_inputs.items()
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n,) + tuple(spec.shape)).astype(np.float32)
    x = torch.from_numpy(X).to(prog.device)
    if prog.precision != "float32":
        x = quantize_t(x, prog.plan.input_exps[name], prog.plan.bits)
    return X, x.reshape(n, -1).contiguous()


def walk_plan(prog, X):
    """The batch ``X`` through a one-segment hybrid plan as the executor's
    batched grid lane runs it: the graph input, quantized on the integer
    lanes, through each interpreted island (``vmap``'d) and the segment
    (one grid launch).  Returns the segment's inputs, one ``(len(X),
    width)`` tensor each, and every island as ``(step, its inputs)``."""
    import torch

    from repro_torch.core.quantize import quantize_t
    from repro_torch.kernels.megakernel import run_segment_grid

    plan = prog.plan
    (name, _), = prog.dfg.graph_inputs.items()
    x = torch.from_numpy(X).to(prog.device)
    if prog.precision != "float32":
        x = quantize_t(x, plan.input_exps[name], plan.bits)
    env, seg_in, islands = {name: x}, None, []
    for kind, payload in plan.megakernel.items:
        if kind == "seg":
            if seg_in is not None:
                raise ValueError("the plan has more than one segment")
            seg_in = [env[r].reshape(len(X), -1).contiguous()
                      for r in payload.in_refs]
            for r, v, shape in zip(payload.out_refs,
                                   run_segment_grid(payload, seg_in),
                                   payload.out_shapes):
                env[r] = v.reshape((len(X),) + tuple(shape))
            continue
        step = plan.steps[payload]
        args = [env[r] for r in step.inputs]
        islands.append((step, args))
        env[step.nid] = torch.func.vmap(step.fn)(*args)
    if seg_in is None:
        raise ValueError("the plan has no megakernel segment")
    return seg_in, islands


def compare(seg, kern, plain) -> tuple[bool, float, int]:
    """(within tolerance, max abs err, count of 1-LSB elements) over the
    outputs of one segment.  Integer outputs agree exactly, except that an
    output with a float PE on its path (``float_pe_outputs``) may differ by
    1 LSB; index outputs (int32) always agree exactly."""
    import torch

    from repro_torch.kernels.ref import float_pe_outputs

    ok, err, lsb = True, 0.0, 0
    for a, b, pe in zip(kern, plain, float_pe_outputs(seg)):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False, float("inf"), 0
        d = (a.double() - b.double()).abs()
        if d.numel():
            err = max(err, float(d.max()))
        if a.dtype == torch.float32:
            ok &= bool(torch.allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL))
        elif pe and a.dtype != torch.int32:
            lsb += int((d == 1).sum())
            ok &= bool((d <= 1).all())
        else:
            ok &= bool(torch.equal(a, b))
    return ok, err, lsb


def tie_segment():
    """A two-output int8 segment over every int8 value: ``relu(x / 2)``
    through ``q_unary`` lands on a tie at every odd positive ``x`` (so it
    tells half-to-even from half-away-from-zero), and ``q_scalar_mul`` by 3
    with a requantizing shift of 1 exercises the rounding add.  Returns the
    segment, its input rows and the outputs numpy expects."""
    import numpy as np

    from repro_torch.kernels.megakernel import Instr, MegakernelSegment

    seg = MegakernelSegment(
        instrs=(Instr("LOAD_VEC", dst=0, operand=("in", 0)),
                Instr("ELEMENTWISE", dst=1, src=(0,),
                      operand=(("q_unary", ("relu", 1, 0)), ())),
                Instr("ELEMENTWISE", dst=2, src=(0,),
                      operand=(("q_scalar_mul", (3, 1)), ())),
                Instr("STORE", src=(1,), operand=0),
                Instr("STORE", src=(2,), operand=1)),
        slot_widths=(256, 256, 256), consts=(), matrices=(), in_refs=("x",),
        out_refs=("half", "triple"), out_widths=(256, 256),
        out_shapes=((256,), (256,)), quantized=True, bits=8)
    x = np.arange(-128, 128, dtype=np.int8)
    x = np.stack([x, x[::-1]])
    half = np.clip(np.rint(np.maximum(x, 0) * np.float32(0.5)), -127, 127)
    triple = np.clip((x.astype(np.int32) * 3 + 1) >> 1, -127, 127)
    return seg, x, [half.astype(np.int8), triple.astype(np.int8)]


FLOAT_STAGES = ("scalar_mul", "add_vec", "sub_vec", "hadamard_vec", "tanh",
                "sigmoid", "relu", "exp", "add_arr", "sub_arr", "hadamard_arr")
Q_STAGES = ("q_scalar_mul", "q_add_vec", "q_sub_vec", "q_hadamard_vec",
            "q_add_arr", "q_sub_arr", "q_hadamard_arr", "q_unary")


def random_chain(rng, names, n: int, bits: int | None = None):
    """A well-formed stage program over ``names`` with seeded operands and
    small shifts: ``(stages, vecs, n_extras)``.  Float programs (``bits``
    None) embed their ``*_vec`` operands (float32, length ``n``); ``q_*``
    programs index ``vecs`` (int8/int16 values, length ``n``).  Each
    ``*_arr`` stage reads a new extra."""
    import numpy as np

    stages, vecs, n_extras = [], [], 0
    qm = None if bits is None else (1 << (bits - 1)) - 1
    for op in names:
        if op == "scalar_mul":
            stages.append((op, float(rng.uniform(-1.5, 1.5))))
        elif op in ("add_vec", "sub_vec", "hadamard_vec"):
            stages.append((op, (0.5 * rng.standard_normal(n))
                           .astype(np.float32)))
        elif op in ("add_arr", "sub_arr", "hadamard_arr"):
            stages.append((op, n_extras))
            n_extras += 1
        elif op in ("tanh", "sigmoid", "relu", "exp"):
            stages.append((op, None))
        elif op == "q_scalar_mul":
            stages.append((op, (int(rng.integers(-5, 6)),
                                int(rng.integers(-2, 4)))))
        elif op == "q_unary":
            stages.append((op, (str(rng.choice(["tanh", "sigmoid", "relu",
                                                "exp"])),
                                int(rng.integers(3, 7)),
                                int(rng.integers(3, 7)))))
        else:
            if op.endswith("_vec"):
                vecs.append(rng.integers(-qm, qm + 1, size=n)
                            .astype(f"int{bits}"))
                idx = len(vecs) - 1
            else:
                idx = n_extras
                n_extras += 1
            if op.startswith("q_hadamard"):
                stages.append((op, (idx, int(rng.integers(1, 5)))))
            else:
                stages.append((op, (idx, int(rng.integers(-2, 3)),
                                    int(rng.integers(-2, 3)),
                                    int(rng.integers(-1, 3)))))
    return stages, vecs, n_extras


def random_stream(rng, shape, bits: int | None = None):
    """Seeded stream values: float32 normals, or int8/int16 over the whole
    saturated range."""
    import numpy as np

    if bits is None:
        return rng.standard_normal(shape).astype(np.float32)
    qm = (1 << (bits - 1)) - 1
    return rng.integers(-qm, qm + 1, size=shape).astype(f"int{bits}")


def at_offset(t, nbytes: int):
    """A copy of ``t`` in a contiguous view whose data starts ``nbytes``
    bytes (a multiple of its item size) past a 16-byte boundary: a view at a
    storage offset, as a slice of a larger tensor is."""
    import torch

    item = t.element_size()
    buf = torch.zeros(t.numel() + 32 // item, dtype=t.dtype, device=t.device)
    view = buf[nbytes // item:nbytes // item + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def chain_case(prog, step, seed: int, nb: int = BUCKET):
    """A served chain step with one seeded bucket: ``(chain, x, extras)``
    on the program's device, at the shape the interpret lane gives it."""
    import numpy as np
    import torch

    from repro_torch.kernels.linear_pipeline import Chain

    bits = prog.plan.bits if step.quantized else None
    shape = (nb,) + tuple(prog.dfg.out_shape(step.terminal))
    rng = np.random.default_rng(seed)
    x, *extras = [torch.from_numpy(random_stream(rng, shape, bits))
                  .to(prog.device) for _ in range(1 + len(step.extras))]
    return Chain(step.stages, step.vecs, step.quantized, bits or 8), x, extras


def chain_work(chain, x, extras) -> tuple[float, float]:
    """(bytes, operations) of one chain call: the stream and each extra
    read once and the output written once at their width, each vec read
    once at the width of its values; one operation per element per stage."""
    import numpy as np

    item = x.element_size()
    nbytes = (2 + len(extras)) * x.numel() * item
    vecs = (chain.vecs if chain.quantized else
            [s for n, s in chain.stages if n.endswith("_vec")])
    nbytes += sum(np.size(v) for v in vecs) * item
    return float(nbytes), float(x.numel() * len(chain.stages))


def work_bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_chain(chain, got, want) -> tuple[bool, float, int]:
    """(within tolerance, max abs err, 1-LSB count) of a chain kernel's
    output against its plain version: float32 ``rtol=atol=1e-5``; integer
    outputs exact, except 1 LSB on a chain with a ``q_unary`` stage."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf"), 0
    fin = torch.isfinite(want.double())
    d = (got.double() - want.double()).abs()
    err = float(d[fin].max()) if bool(fin.any()) else 0.0
    if got.dtype == torch.float32:
        return bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL,
                                   equal_nan=True)), err, 0
    if any(op == "q_unary" for op, _ in chain.stages):
        return bool((d <= 1).all()), err, int((d == 1).sum())
    return bool(torch.equal(got, want)), err, 0


def product_tol(dtype, k: int) -> tuple[float, float]:
    """(rtol, atol) of a product with k-term fp32 sums against its plain
    version, whose sums run in another order: ``tests/test_kernels.py``'s
    tolerances (spmv/matmul float32 ``rtol=5e-4, atol=1e-4``, bfloat16
    ``3e-2``), with the float32 atol grown as sqrt(k / 16) beyond k = 16
    for the random walk of the rounding errors of long sums."""
    import torch

    if dtype == torch.bfloat16:
        return 3e-2, 3e-2
    return 5e-4, 1e-4 * max(1.0, math.sqrt(k / 16))


def compare_product(got, want, k: int) -> tuple[bool, float]:
    """(within ``product_tol``, max abs err) of a product's output."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf")
    g, w = got.float(), want.float()
    rtol, atol = product_tol(got.dtype, k)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return bool(torch.allclose(g, w, rtol=rtol, atol=atol)), err


def tile_sparse(m: int, n: int, density: float, bm: int, bk: int, seed: int,
                device):
    """A seeded (m, n) float32 matrix on ``device`` whose (bm × bk) tiles
    are each non-zero with probability ``density`` (normal values inside)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((m, n), generator=g, device=device)
    keep = torch.rand((-(-m // bm), -(-n // bk)), generator=g,
                      device=device) < density
    mask = keep.repeat_interleave(bm, 0)[:m].repeat_interleave(bk, 1)[:, :n]
    return w * mask


def spmv_work(packed, B: int) -> tuple[float, float]:
    """(bytes, operations) of one spmv call on this data: x read once, each
    kept tile and the tile tables read once, the output written once; two
    operations per multiply-add of the kept tiles."""
    kept = int(packed.valid.sum().item())
    tile = packed.bm * packed.bk
    nbytes = 4 * (B * packed.n + kept * tile + 2 * packed.valid.numel()
                  + B * packed.m)
    return float(nbytes), float(2 * B * kept * tile)


def matmul_work(M: int, N: int, K: int, item: int) -> tuple[float, float]:
    """(bytes, operations) of ``(M, K) @ (K, N)``: each operand read once,
    the output written once; two operations per multiply-add."""
    return float(item * (M * K + K * N + M * N)), float(2 * M * N * K)


def attn_compare(got, want) -> tuple[bool, float, float]:
    """(within the limit, max abs err, the limit) of an attention kernel's
    output against its plain version: float32 ``rtol = atol = 1e-5``
    (the limit reported is the atol; p rounded to bfloat16 too:
    ``fa_kernel`` rounds it against the row's max, as the plain version
    does); bfloat16 one bf16 ulp at the output's largest magnitude."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf"), 0.0
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if got.dtype == torch.float32:
        return bool(torch.allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL)), err, F32_ATOL
    ulp = 2.0 ** (math.floor(math.log2(float(w.abs().max()))) - 7)
    return err <= ulp, err, ulp


def flash_work(B: int, Sq: int, Sk: int, H: int, KV: int, dh: int, item: int,
               causal: bool, window: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one flash-attention call: q, k, v read once
    and the output written once; four operations per (query, key, dh)
    element of the pairs the mask keeps (q·k and p·v; a window keeps at
    most ``window`` keys a query)."""
    pairs = (sum(min(t + 1, Sk, window or Sk) for t in range(Sq)) if causal
             else Sq * Sk)
    nbytes = item * (2 * B * Sq * H * dh + 2 * B * Sk * KV * dh)
    return float(nbytes), float(4 * B * H * dh * pairs)


def decode_work(lens, H: int, KV: int, dh: int, item: int) -> tuple[float, float]:
    """(bytes, operations) of one decode-attention call: q read and the
    output written once, the valid prefix of k and v read once, the
    lengths; four operations per (head, valid key, dh) element."""
    n, B = int(sum(lens)), len(lens)
    nbytes = item * (2 * B * H * dh + 2 * n * KV * dh) + 4 * B
    return float(nbytes), float(4 * n * H * dh)


def trace_acts(p) -> tuple[list, int]:
    """Of a finished ``torch.profiler`` trace ``p``: its device activities
    (kernels, copies, sets) as (name, us), and the host's calls of the CUDA
    runtime's copy functions (``cudaMemcpy*``), read from the trace's raw
    (kineto) events.  ``p.events()`` gives the same, but first builds every
    host event's tree: 7 s for three of zamba2-7b's decode steps, against
    0.07 s (NVIDIA H100 80GB HBM3)."""
    from torch.autograd import DeviceType

    acts, calls = [], 0
    for e in p.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acts.append((e.name(), (e.end_ns() - e.start_ns()) / 1e3))
        elif (e.device_type() == DeviceType.CPU
              and e.name().startswith("cudaMemcpy")):
            calls += 1
    return acts, calls


def device_trace(fn, reps: int = 3) -> tuple[list | None, int]:
    """One ``torch.profiler`` (CUPTI) trace of ``reps`` calls of ``fn``,
    after one warm call: the device activities (kernels, copies, sets) as
    (name, us), and the host's calls of the CUDA runtime's copy functions
    (``cudaMemcpy*``).  A trace that recorded no device activity at all
    (the profiler drops events now and then) is taken again, up to
    ``TRACE_TRIES`` times; then (None, its copy calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        acts, calls = trace_acts(p)
        if acts:
            return acts, calls
    return None, calls


def trace_split(acts: list, names: tuple[str, ...], reps: int,
                count: bool = False) -> tuple[float, dict, float]:
    """Of a ``device_trace`` of ``reps`` calls: device ms per call, of that
    the ms of the activities whose names contain each of ``names`` (with
    ``count``: how many of them run per call), and the number of device
    activities per call."""
    total, part = 0.0, dict.fromkeys(names, 0.0)
    for name, us in acts:
        total += us
        for n in names:
            if n in name:
                part[n] += 1 if count else us
    scale = reps if count else 1e3 * reps
    return (total / 1e3 / reps, {n: v / scale for n, v in part.items()},
            len(acts) / reps)


def trace_top(acts: list, reps: int, n: int = 6
              ) -> list[tuple[str, float, float]]:
    """Of a ``device_trace`` of ``reps`` calls: the ``n`` kernels (by name)
    that take the most device time in a call, as (name, ms per call,
    launches per call)."""
    by: dict[str, list] = {}
    for name, us in acts:
        acc = by.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return [(name, us / 1e3 / reps, k / reps) for name, (us, k) in top]


def trace_htod(acts: list | None, reps: int) -> float:
    """Of a ``device_trace`` of ``reps`` calls: the host-to-device copies
    per call that it shows on the card (``HTOD``; a trace may drop a small
    one)."""
    return sum(1 for name, _ in acts or () if HTOD in name) / reps


def device_split(fn, names: tuple[str, ...], reps: int = 3,
                 count: bool = False) -> tuple[float, dict, float]:
    """``trace_split`` of a ``device_trace`` of ``fn``; where no trace
    recorded a device activity, as in ``device_ms``, the time between CUDA
    events around ``reps`` calls run back to back, over ``reps``, with the
    split and the activities not measured (NaN)."""
    import torch

    acts, _ = device_trace(fn, reps)
    if acts is not None:
        return trace_split(acts, names, reps, count)
    print(f"    {TRACE_TRIES} profiler traces of {reps} calls recorded no "
          "device activity: CUDA events, the split not measured", flush=True)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    nan = float("nan")
    return a.elapsed_time(b) / reps, dict.fromkeys(names, nan), nan


def htod_copies(fn, reps: int = 5) -> tuple[float, float]:
    """Host-to-device copies per call of ``fn``: the copies a profiler trace
    shows on the card (``trace_htod``), and the host's calls of the CUDA
    runtime's copy functions (``cudaMemcpy*``), which ``fn`` makes only for
    host-to-device copies when its results stay on the card."""
    acts, calls = device_trace(fn, reps)
    return trace_htod(acts, reps), calls / reps


@contextlib.contextmanager
def flash_check():
    """Hold every flash launch the model's attention makes while the block
    is open against the kernel's plain version on the same inputs
    (``attn_compare``); yields the list of (within the limit, max abs err,
    the limit), one a launch.  Not for timed runs."""
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import attention

    held: list[tuple[bool, float, float]] = []
    real = attention.flash_attention_fused

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        held.append(attn_compare(out, flash_attention_ref(q, k, v, **kw)))
        return out

    attention.flash_attention_fused = spy
    try:
        yield held
    finally:
        attention.flash_attention_fused = real


@contextlib.contextmanager
def route_log(enabled: bool = True, force: list | None = None):
    """Record every MoE layer the port runs while the block is open, in
    order: its tokens, capacity, choices (T, k), the least gap between
    adjacent gates among each token's top k + 1 (T,) and its dropped
    copies (a tensor on the card), recomputed beside the layer (under a
    split, from the whole router: its columns gathered where the plan
    splits them), and ``used``, the choices the layer routed on.  Not for
    timed runs.  With ``force`` (the ``used`` choices of another run's
    log, one a layer call in the same order) each layer routes on those
    choices instead, gated by its own router's probabilities, while
    ``top_i`` keeps the choices its router makes.  Raises unless the block
    ran exactly ``len(force)`` layers."""
    import torch

    from repro_torch.models import moe, transformer
    from repro_torch.sharding.tp import gather_from_model

    log: list[dict] = []
    if not enabled:
        yield log
        return
    real, real_route = transformer.moe_ffn, moe._route

    def forced_route(top_i, logits, k, cap, tokens=None):
        gates = torch.softmax(logits, dim=-1)
        top_g = gates.gather(1, top_i)
        top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)
        slot, keep = moe._slots(top_i, logits.shape[1], cap, tokens)
        return gates, top_g, top_i, slot, keep

    def spy(p, x, *, k, capacity_factor, **kw):
        T = x.shape[0] * x.shape[1]
        router, sp = p["router"], kw.get("split")
        with torch.no_grad():
            if sp is not None and sp.router is not None:     # its columns
                router = gather_from_model(router.detach(), -1, sp, of="router")
            cap = moe.capacity(T, k, router.shape[-1], capacity_factor)
            gates, _, top_i, _, keep = moe.route(router, x.reshape(T, -1), k,
                                                 cap)
            top = gates.topk(k + 1, dim=-1).values
        entry = dict(T=T, cap=cap, top_i=top_i,
                     gap=(top[:, :-1] - top[:, 1:]).min(-1).values,
                     dropped=(~keep).sum())
        log.append(entry)
        if force is not None and len(log) > len(force):
            raise AssertionError(f"route_log: more than the {len(force)} MoE "
                                 "layers to force")
        route = (real_route if force is None else functools.partial(
            forced_route, force[len(log) - 1].to(x.device)))

        def recorded(*args, **kwargs):
            out = route(*args, **kwargs)
            entry["used"] = out[2].detach()
            return out

        moe._route = recorded
        try:
            return real(p, x, k=k, capacity_factor=capacity_factor, **kw)
        finally:
            moe._route = real_route

    transformer.moe_ffn = spy
    try:
        yield log
    finally:
        transformer.moe_ffn = real
    if force is not None and len(log) != len(force):
        raise AssertionError(f"route_log: {len(log)} MoE layers ran, "
                             f"{len(force)} forced")


@contextlib.contextmanager
def offset_calls():
    """Count the model's attention calls whose query heads are not whole
    KV groups (a rank's share of an uneven split: a head offset, or a short
    last group), by the kernel wrapper the model calls (flash forward,
    flash with its backward, decode): yields the dict, filled as the calls
    run (spies on ``models.attention``'s names; the wrappers' own counts,
    ``LAUNCHES``, are untouched)."""
    from repro_torch.models import attention as att

    counts: dict[str, int] = {}
    names = ("flash_attention_fused", "flash_attention_train",
             "decode_attention")
    saved = {n: getattr(att, n) for n in names}

    def spy(name, fn):
        def call(q, k, *args, group=None, head_offset=0, **kw):
            H, KV = q.shape[-2], k.shape[2]
            if group is not None and H and (head_offset or H != KV * group):
                counts[name] = counts.get(name, 0) + 1
            return fn(q, k, *args, group=group, head_offset=head_offset, **kw)
        return call

    for n, fn in saved.items():
        setattr(att, n, spy(n, fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(att, n, fn)


def route_flips(a: list[dict], b: list[dict], key: str = "top_i",
                key_b: str | None = None) -> dict | None:
    """The first layer in which two logs of one input chose other experts
    (or another order of them): the layer, its tokens and their least gate
    gaps in either run; None where every choice agrees.  ``key`` (and
    ``key_b`` for ``b``, by default the same) names the choices compared:
    ``top_i``, the router's, or ``used``, those the layer routed on."""
    import torch

    for layer, (x, y) in enumerate(zip(a, b)):
        rows = (x[key] != y[key_b or key]).any(-1)
        if bool(rows.any()):
            idx = rows.nonzero()[:, 0]
            gaps = torch.minimum(x["gap"][idx], y["gap"][idx])
            return dict(layer=layer, tokens=idx.tolist(), gaps=gaps.tolist())
    return None


def htod_ops(fn) -> int:
    """Host-to-device copies one call of ``fn`` asks for: the ``_to_copy``
    and ``copy_`` operations, seen at PyTorch's dispatcher, whose source
    lies on the host and whose result lies on the card.  Exact where the
    profiler's trace drops a small copy now and then (ROADMAP Queue C item
    8), and blind to the card's own copies, which the runtime's
    ``cudaMemcpy*`` calls also count."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten._to_copy.default:
                src, dst = args[0], out
            elif func is torch.ops.aten.copy_.default:
                dst, src = args[0], args[1]
            else:
                return out
            if src.device.type == "cpu" and dst.device.type == "cuda":
                self.n += 1
            return out

    fn()
    torch.cuda.synchronize()
    counter = Count()
    with counter:
        fn()
    torch.cuda.synchronize()
    return counter.n


def engine_routes(eng_log: list[dict], done, L: int,
                  rows: tuple[int, int] | None = None) -> dict:
    """The experts (sorted, per layer: (tokens, k)) that chose each served
    token in an engine run logged by ``route_log``: the prefill of request
    r (the first ``len(done)`` forwards, every request admitted at once)
    at its last prompt position, then decode step j - 1 at the request's
    slot.  On a data rank that decodes the slots ``rows`` = [r0, r1) (the
    engine's ``rows``), only the requests in those slots."""
    import torch

    n = len(done)
    r0, r1 = rows or (0, 1 << 30)
    if len(eng_log) % L or len(eng_log) // L < n:
        raise AssertionError(f"{len(eng_log)} MoE layers logged, not "
                             f"{L} per forward")
    out = {}
    for i, r in enumerate(sorted(done, key=lambda q: q.rid)):
        if not r0 <= r.slot < r1:
            continue
        per_layer = []
        for layer in range(L):
            rows_ = [eng_log[i * L + layer]["top_i"][len(r.prompt) - 1]]
            rows_ += [eng_log[(n + j - 1) * L + layer]["top_i"][r.slot - r0]
                      for j in range(1, len(r.tokens))]
            per_layer.append(torch.stack(rows_).sort(-1).values)
        out[r.rid] = per_layer
    return out


def teacher_forced(model, done, vocab: int, plain: bool, eng_routes=None):
    """Hold every served token against the argmax of the model's
    teacher-forced ``forward_full`` over the prompt and the tokens served
    before it.  Returns (positions, disagreements, max |logits - logits
    with the attention kernels' plain versions| over the requests whose
    routers chose alike in both runs, or None; the requests whose routers
    chose otherwise: the first such layer, its tokens and gate gaps, and
    the logits' difference; the positions whose router chose the same
    experts in every layer in the engine's run (``eng_routes``, from
    ``engine_routes``) and in the teacher-forced one, or None).  Each
    disagreement says whether its position was routed alike."""
    import numpy as np
    import torch

    moe = model.cfg.family == "moe"
    n, worse, diff, flipped = 0, [], (0.0 if plain else None), []
    n_alike = None if eng_routes is None else 0
    for r in done:
        full = np.asarray(r.prompt + r.tokens, np.int32)[None, :]
        with (route_log(moe and (plain or eng_routes is not None)) as ka,
              head_inputs(model) as heads):
            logits, _, _ = model.forward_full(full)
        alike = None
        if eng_routes is not None:
            p0, m = len(r.prompt) - 1, len(r.tokens)
            alike = torch.ones(m, dtype=torch.bool, device=logits.device)
            for e, tf in zip(eng_routes[r.rid], ka):
                alike &= (e == tf["top_i"][p0:p0 + m].sort(-1).values).all(-1)
            alike = alike.tolist()
            n_alike += sum(alike)
        if plain:
            with route_log(moe) as pa:
                ref, _, _ = model.forward_full(full, plain_attention=True)
            d = float((logits - ref).abs().max())
            flips = route_flips(ka, pa) if moe else None
            if flips is None:
                diff = max(diff, d)
            else:
                flipped.append(dict(rid=r.rid, diff=d, **flips))
            del ref, ka, pa
        p0 = len(r.prompt) - 1
        lf = logits[0, p0:p0 + len(r.tokens)].clone()
        del logits
        lf[:, vocab:] = -torch.inf
        top = lf.topk(2, dim=-1)
        arg = top.indices[:, 0].tolist()
        gap = (top.values[:, 0] - top.values[:, 1]).tolist()
        for i, tok in enumerate(r.tokens):
            n += 1
            if tok != arg[i]:
                worse.append(dict(rid=r.rid, step=i, served=tok, argmax=arg[i],
                                  top2_gap=gap[i],
                                  served_gap=float(lf[i, arg[i]] - lf[i, tok]),
                                  tie=tie_grain(model, heads[0][0, p0 + i],
                                                arg[i], tok),
                                  routed_alike=None if alike is None
                                  else alike[i]))
        del heads
    return n, worse, diff, flipped, n_alike


@contextlib.contextmanager
def head_inputs(model):
    """Record what the model's head reads while the block is open: each
    ``_logits`` call's input after the final norm, in the activation dtype,
    as ``_logits`` computes it."""
    from repro_torch.models.layers import rms_norm

    seen: list = []
    real = model._logits

    def spy(x):
        seen.append(rms_norm(x, model.final_norm, model.cfg.norm_eps))
        return real(x)

    model._logits = spy
    try:
        yield seen
    finally:
        del model._logits


def tie_grain(model, h, a: int, b: int) -> float:
    """How far moving each element of the head's input ``h`` (D,) by one
    ulp of its dtype can change the difference of logits ``a`` and ``b``:
    sum_i ulp(h_i) |W[i, a] - W[i, b]|."""
    import torch

    hf = h.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(hf))) * torch.finfo(h.dtype).eps
    w = model.lm_head
    return float((ulp * (w[:, a].float() - w[:, b].float()).abs()).sum())


def bucket_check(model, prompts, plain: bool) -> list[dict]:
    """Each prompt's prefill bucket (zero-padded, as the engine pads it)
    through ``forward_full`` with the kernels: the capacity and each
    layer's dropped copies; with ``plain`` also the logits' max abs
    difference from the same bucket with the kernels' plain versions, and
    the first layer whose router chose otherwise (``route_flips``)."""
    import numpy as np

    from repro_torch.serve.scheduling import bucket_for

    cfg = model.cfg
    out = []
    for i, p in enumerate(prompts):
        sp = bucket_for(len(p), LM_MAX_LEN, floor=8)
        padded = np.zeros((1, sp), np.int32)
        padded[0, :len(p)] = p
        with route_log() as ka:
            lk, _, _ = model.forward_full(padded)
        rec = dict(rid=i, bucket=sp, cap=ka[0]["cap"],
                   copies=sp * cfg.experts_per_token,
                   dropped=[int(e["dropped"]) for e in ka])
        if plain:
            with route_log() as pa:
                lp, _, _ = model.forward_full(padded, plain_attention=True)
            rec.update(diff=float((lk - lp).abs().max()),
                       flips=route_flips(ka, pa))
            del lp
        del lk
        out.append(rec)
    return out


def nodrop(cfg):
    """``cfg`` with the capacity factor raised to (E + 0.5) / k, so that
    every expert has a slot for every token (cap >= T at any T)."""
    return dataclasses.replace(
        cfg, capacity_factor=(cfg.n_experts + 0.5) / cfg.experts_per_token)


def decode_bound(model, lens) -> tuple[float, float]:
    """(bytes, ms) a decode step at batch ``len(lens)`` must move: every
    weight read once (all experts: the capacity dispatch runs each over
    its slots; the hybrid's shared block once per application: its 1 GB
    in bf16 does not stay in the 50 MB L2), of the embedding only the
    batch's rows, the valid prefix ``lens`` of every attention layer's
    caches (a ring, or a window on the full-length cache: at most its
    width), and the Mamba2 layers' states, the
    float32 ``h`` and the conv states, read and written; over
    ``HBM_BYTES_PER_S``."""
    cfg = model.cfg
    emb = model.embed
    item = emb.element_size()
    B, n = len(lens), int(sum(lens))
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    nbytes -= (emb.shape[0] - B) * emb.shape[1] * item
    if cfg.family in ("dense", "moe"):
        per_pos = ((cfg.kv_lora_rank + cfg.d_rope) if cfg.use_mla
                   else 2 * cfg.n_kv_heads_eff * cfg.d_head)
        if cfg.attn_window and not cfg.use_mla:
            n = sum(min(int(x), cfg.attn_window) for x in lens)
        nbytes += cfg.n_layers * n * per_pos * item
        return float(nbytes), nbytes / HBM_BYTES_PER_S * 1e3
    state = (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
             + (cfg.ssm_conv - 1) * cfg.d_conv_ch * item)
    nbytes += 2 * cfg.n_mamba_layers * B * state
    if cfg.family == "hybrid":
        G, dh2 = cfg.hybrid_groups, 2 * cfg.d_model // cfg.n_heads
        shared = sum(p.numel() * p.element_size()
                     for p in model.shared_attn.parameters())
        nbytes += (G - 1) * shared
        win = cfg.attn_window or LM_MAX_LEN
        valid = sum(min(int(x), win) for x in lens)
        nbytes += G * valid * 2 * cfg.n_kv_heads * dh2 * item
    return float(nbytes), nbytes / HBM_BYTES_PER_S * 1e3


def attention_layers(cfg) -> int:
    """The attention layers a forward runs: the hybrid's shared
    applications, none for the ``ssm``, every layer otherwise."""
    if cfg.family == "hybrid":
        return cfg.hybrid_groups
    return 0 if cfg.family == "ssm" else cfg.n_layers


def flash_heads(cfg) -> tuple[int, int, int]:
    """(H, KV, dh) of the model's prefill attention."""
    if cfg.use_mla:
        return cfg.n_heads, cfg.n_heads, cfg.d_head + cfg.d_rope
    if cfg.family == "hybrid":
        return cfg.n_heads, cfg.n_kv_heads, 2 * cfg.d_model // cfg.n_heads
    return cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.d_head


# ------------------------------------------------------- phase 9: the store
# engines restored from the store: (bench, precision, lane, compile knobs)
STORE_ENGINES = tuple(
    (bench, prec, lane, kw) for bench in TRAINED for prec in ("float32", "int8")
    for lane, kw in (("megakernel_grid", {"exec_mode": "megakernel_grid"}),
                     ("use_pallas", {"use_pallas": True})))
STORE_MEASURED = "bonsai/curet-m"     # compiled with cost_source="measured"
STORE_TURNS = 6                       # async flushes, two tenants in turns
# the header and payload of an artifact of the JAX package: its magic, and
# a pickle that would import that package's compiler if it were unpickled
REF_MAGIC = b"MAFIA-ARTIFACT\n"
REF_PAYLOAD = b"\x80\x04crepro.core.compiler\nCompiledProgram\n."
MEASURED_KW = dict(cost_source="measured", autotune=True,
                   chain_split_bytes="auto", use_pallas=True)


def _store_label(bench: str, prec: str, lane: str) -> str:
    return f"{bench.replace('/', '-')}-{prec}-{lane}"


def _store_calib(bench: str, prec: str):
    """The calibration rows ``get_program`` gives a fixed-point compile."""
    from repro_torch.configs.classical import training_split
    from repro_torch.serve.classical_engine import _CALIB_SAMPLES

    return (None if prec == "float32"
            else training_split(bench, seed=0)[0][:_CALIB_SAMPLES])


def _store_expected(prog) -> dict[str, int]:
    """Launches one bucket of ``prog`` makes: one megakernel launch per
    segment on the grid lane, one chain launch per chain step else."""
    from repro_torch.core.lowering import ChainStep

    if prog.exec_mode == "megakernel_grid":
        return {"megakernel": len(prog.plan.megakernel.segments)}
    name = "linear_chain" if prog.precision == "float32" else "linear_chain_q"
    return {name: sum(isinstance(s, ChainStep) for s in prog.plan.steps)}


def _run_bucket(prog, X, launches: dict) -> dict:
    """One bucket through ``prog`` as numpy outputs; checks and adds the
    launches it made."""
    import torch

    from repro_torch.kernels.build import LAUNCHES

    before = dict(LAUNCHES)
    out = {k: v.cpu().numpy() for k, v in prog.batch(BUCKET)(x=X).items()}
    torch.cuda.synchronize()
    made = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    want = _store_expected(prog)
    if made != want:
        raise AssertionError(f"a bucket of {prog.exec_mode} "
                             f"use_pallas={prog.use_pallas} {prog.precision} "
                             f"launched {made}, expected {want}")
    for k, v in made.items():
        launches[k] = launches.get(k, 0) + v
    return out


def _same_outputs(label: str, got: dict, want: dict) -> None:
    import numpy as np

    if set(got) != set(want):
        raise AssertionError(f"{label}: outputs {sorted(got)} != {sorted(want)}")
    for k in want:
        if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{label}: output {k} differs bitwise")


def store_phase(dev, tmp: str) -> tuple[dict, dict]:
    """Phase 9 in the parent: cold compiles into a fresh store, a refused
    artifact of the JAX package, the async engine's evictions, profiling and
    autotuning on the card, measured-mode compiles; then a fresh process
    restores everything.  Returns (record, launches of the phase)."""
    import hashlib
    import pickle

    import numpy as np

    from repro_torch.configs.classical import build
    from repro_torch.core import autotune as at
    from repro_torch.core.artifacts import ArtifactError, ArtifactStore, load_program
    from repro_torch.core.compiler import MafiaCompiler
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve.async_engine import AsyncServeEngine
    from repro_torch.serve.classical_engine import get_program

    store = ArtifactStore(os.path.join(tmp, "store"))
    rec: dict = {"engines": [], "measured": []}
    launches: dict[str, int] = {}
    arrays: dict[str, object] = {}
    progs = {}
    # -- cold compiles, published to the store
    for bench, prec, lane, kw in STORE_ENGINES:
        label = _store_label(bench, prec, lane)
        t1 = time.perf_counter()
        prog = get_program(bench, precision=prec, device=dev,
                           artifact_store=store, **kw)
        cold_s = time.perf_counter() - t1
        if prog.pf_source != "cold":
            raise AssertionError(f"{label}: pf_source {prog.pf_source}")
        (spec,) = prog.dfg.graph_inputs.values()
        X = np.random.default_rng(11).standard_normal(
            (BUCKET,) + tuple(spec.shape)).astype(np.float32)
        out = _run_bucket(prog, X, launches)
        arrays[f"{label}:x"] = X
        arrays.update({f"{label}:{k}": v for k, v in out.items()})
        progs[bench, prec, lane] = prog, out
        rec["engines"].append(dict(
            label=label, bench=bench, precision=prec, lane=lane, kw=kw,
            cold_s=cold_s, fingerprint=prog.plan.megakernel.fingerprint(),
            expected=_store_expected(prog)))
    if store.saves != len(STORE_ENGINES) or store.misses != len(STORE_ENGINES):
        raise AssertionError(f"cold compiles: {store}")
    # -- an artifact of the JAX package: a miss, never unpickled
    foreign = store.path("f" * 64)
    digest = hashlib.sha256(REF_PAYLOAD).hexdigest()
    with open(foreign, "wb") as fh:
        fh.write(REF_MAGIC + f"version=2 digest={digest}\n".encode()
                 + REF_PAYLOAD)
    unpickled, real_loads = [], pickle.loads
    pickle.loads = lambda *a, **k: unpickled.append(a) or real_loads(*a, **k)
    try:
        misses = store.misses
        if store.load("f" * 64, dev) is not None or store.misses != misses + 1:
            raise AssertionError("an artifact of the JAX package was not a miss")
        try:
            load_program(foreign, dev)
            raise AssertionError("load_program took an artifact of the JAX package")
        except ArtifactError as e:
            refused = str(e)
    finally:
        pickle.loads = real_loads
    os.remove(foreign)
    if unpickled or any(m.split(".")[0] == "repro" for m in sys.modules):
        raise AssertionError("an artifact of the JAX package reached the unpickler")
    rec["foreign"] = refused
    print(f"  an artifact with the JAX package's magic: a miss, refused before "
          f"unpickling ({refused.split(': ', 1)[-1]})", flush=True)
    # -- the async engine: two tenants in turns, one resident
    eng = AsyncServeEngine(max_resident=1, artifact_store=store)
    tenants = list(TRAINED)
    for b in tenants:
        eng.register_model(b, b, max_batch=BUCKET, device=dev,
                           exec_mode="megakernel_grid")
    before = LAUNCHES["megakernel"]
    for turn in range(STORE_TURNS):
        b = tenants[(turn + 1) % 2]          # the resident one first
        _, out = progs[b, "float32", "megakernel_grid"]
        X = arrays[f"{_store_label(b, 'float32', 'megakernel_grid')}:x"]
        for row in X:
            eng.submit(b, row)
        done = eng.flush(b)
        preds = np.array([int(r.pred) for r in done])
        if not np.array_equal(preds, out["Pred"].reshape(-1)):
            raise AssertionError(f"async turn {turn} {b}: predictions differ "
                                 "from the resident program's")
    hits, misses = eng.metrics.cache_hits, eng.metrics.cache_misses
    launches["megakernel"] = (launches.get("megakernel", 0)
                              + LAUNCHES["megakernel"] - before)
    if hits != STORE_TURNS - 1 or misses:
        raise AssertionError(f"async engine: {hits} cache hits, {misses} "
                             f"misses over {STORE_TURNS} turns")
    rec["async"] = dict(turns=STORE_TURNS, cache_hits=hits,
                        cache_misses=misses,
                        megakernel=LAUNCHES["megakernel"] - before)
    print(f"  async engine, max_resident=1, two tenants: {STORE_TURNS} flushes, "
          f"{hits} restored from the store (cache hits), {misses} misses; "
          "predictions equal the resident program's", flush=True)
    # -- profiling and autotuning on the card
    before = dict(LAUNCHES)
    t1 = time.perf_counter()
    table = at.profile_device(quick=True, device=dev)
    prof_s = time.perf_counter() - t1
    prof = {k: LAUNCHES[k] - before[k] for k in ("linear_chain", "megakernel")}
    if min(prof.values()) <= 0:
        raise AssertionError(f"profiling launched {prof}")
    t1 = time.perf_counter()
    at.autotune_knobs(table, device=dev)
    tune_s = time.perf_counter() - t1
    for k in LAUNCHES:
        if LAUNCHES[k] != before[k]:
            launches[k] = launches.get(k, 0) + LAUNCHES[k] - before[k]
    model = at.CalibratedCostModel.fit(table)
    store.save_calibration(table)
    rec["profile"] = dict(
        device_class=table.device_class, seconds=prof_s, autotune_s=tune_s,
        samples=len(table.samples), launches=prof,
        autotune_launches=LAUNCHES["linear_chain"] - before["linear_chain"]
        - prof["linear_chain"],
        op_fit={op: model.op_fit[op] for op in ("gemv", "add", "relu")},
        global_fit=model.global_fit, chain_fit=model.chain_fit,
        segment_fit=model.segment_fit,
        split_sweep_us=[[c, us] for c, us in table.knobs["split_sweep_us"]],
        chain_split_bytes=table.knobs["chain_split_bytes"])
    print(f"  profile_device(quick=True) on {table.device_class}: "
          f"{len(table.samples)} samples in {prof_s:.2f} s; launches "
          f"linear_chain {prof['linear_chain']}, megakernel (nb = 1) "
          f"{prof['megakernel']}", flush=True)
    for op in ("gemv", "add", "relu"):
        t0_, s_ = model.op_fit[op]
        print(f"    {op}: intercept {t0_:.2f} us, slope {s_:.5f} us/cycle")
    print(f"    chain: {model.chain_fit[0]:.2f} us a launch + "
          f"{model.chain_fit[1]:.3f} us a stage; segment: "
          f"{model.segment_fit[0]:.2f} us a launch + "
          f"{model.segment_fit[1]:.3f} us an instruction; global "
          f"{model.global_fit[0]:.2f} us + {model.global_fit[1]:.5f} us/cycle")
    print(f"  autotune_knobs in {tune_s:.2f} s: chain_split_bytes " + ", ".join(
        f"{c} {us:.1f} us" for c, us in table.knobs["split_sweep_us"])
        + f"; winner {table.knobs['chain_split_bytes']}", flush=True)
    # -- measured-mode compiles: the table from the store, no profiling
    profiled, real_profile = [], at.profile_device
    at.profile_device = lambda **kw: profiled.append(kw) or real_profile(**kw)
    try:
        for prec in ("float32", "int8"):
            label = _store_label(STORE_MEASURED, prec, "measured")
            comp = MafiaCompiler(precision=prec, artifact_store=store,
                                 device=dev, **MEASURED_KW)
            if comp.cost_source != "measured":
                raise AssertionError(f"{label}: cost_source {comp.cost_source}")
            pm = comp.compile(build(STORE_MEASURED)[0],
                              calib=_store_calib(STORE_MEASURED, prec))
            pa, want = progs[STORE_MEASURED, prec, "use_pallas"]
            X = arrays[f"{_store_label(STORE_MEASURED, prec, 'use_pallas')}:x"]
            out = _run_bucket(pm, X, launches)
            _same_outputs(f"{label} vs the analytic compile", out, want)
            arrays.update({f"{label}:{k}": v for k, v in out.items()})
            rec["measured"].append(dict(
                label=label, precision=prec, cost_source=pm.cost_source,
                chain_split_bytes=comp.chain_split_bytes,
                assignment=pm.assignment, analytic_assignment=pa.assignment,
                schedule_us=pm.schedule.total_cycles,
                analytic_cycles=pa.schedule.total_cycles,
                chain_splits=pm.plan.chain_splits,
                analytic_chain_splits=pa.plan.chain_splits,
                fingerprint=pm.plan.megakernel.fingerprint()))
            print(f"  measured {STORE_MEASURED} {prec}: cost_source "
                  f"{pm.cost_source}, chain_split_bytes {comp.chain_split_bytes}"
                  f", schedule {pm.schedule.total_cycles:.2f} us (analytic "
                  f"{pa.schedule.total_cycles:.0f} cycles), chain splits "
                  f"{pm.plan.chain_splits} (analytic {pa.plan.chain_splits}); "
                  f"assignment {pm.assignment}; analytic {pa.assignment}; "
                  "outputs bitwise equal to the analytic compile's", flush=True)
    finally:
        at.profile_device = real_profile
    if profiled:
        raise AssertionError(f"measured compiles profiled {len(profiled)} times "
                             "with the table in the store")
    # -- a fresh process restores everything
    np.savez(os.path.join(tmp, "outputs.npz"), **arrays)
    with open(os.path.join(tmp, "engines.json"), "w") as fh:
        json.dump(rec, fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t1 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--store-child", tmp], capture_output=True, text=True,
                         env=env, timeout=600)
    child_s = time.perf_counter() - t1
    for line in res.stdout.splitlines()[:-1]:
        print("  child:", line, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"the fresh process failed (rc {res.returncode}): "
                             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    child = json.loads(res.stdout.splitlines()[-1])
    for k, v in child["launches"].items():
        launches[k] = launches.get(k, 0) + v
    rec.update(child=child, child_s=child_s)
    for e, c in zip(rec["engines"], child["engines"]):
        e.update(load_s=c["load_s"], warm_load_s=c["warm_load_s"])
        print(f"  {e['label']}: get_program seconds: cold compile "
              f"{e['cold_s']:.4f} (parent), load {c['load_s']:.4f} (fresh "
              f"process, first) and {c['warm_load_s']:.4f} (again)", flush=True)
    return rec, launches


def store_child(tmp: str) -> int:
    """Phase 9 in a fresh process: every engine through ``get_program``
    with a fresh compiler from the store (``pf_source == "artifact"``, the
    parent's fingerprint, its outputs bitwise, the expected launches), and
    measured-mode compiles that find the table in the store without
    profiling.  Prints one JSON line last."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.classical import build
    from repro_torch.core import autotune as at
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.compiler import MafiaCompiler
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve.classical_engine import (clear_program_cache,
                                                    get_program)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    store = ArtifactStore(os.path.join(tmp, "store"))
    with open(os.path.join(tmp, "engines.json")) as fh:
        rec = json.load(fh)
    data = np.load(os.path.join(tmp, "outputs.npz"))
    profiled, real_profile = [], at.profile_device
    at.profile_device = lambda **kw: profiled.append(kw) or real_profile(**kw)
    launches: dict[str, int] = {}
    out_rec = {"engines": [], "measured": []}
    for e in rec["engines"]:
        label = e["label"]
        t1 = time.perf_counter()
        prog = get_program(e["bench"], precision=e["precision"], device=dev,
                           artifact_store=store, **e["kw"])
        load_s = time.perf_counter() - t1
        if prog.pf_source != "artifact":
            raise AssertionError(f"{label}: pf_source {prog.pf_source}")
        if prog.plan.megakernel.fingerprint() != e["fingerprint"]:
            raise AssertionError(f"{label}: fingerprint differs from the parent's")
        X = data[f"{label}:x"]
        got = _run_bucket(prog, X, launches)
        _same_outputs(label, got, {k.split(":", 1)[1]: data[k] for k in data.files
                                   if k.startswith(label + ":")
                                   and k != f"{label}:x"})
        out_rec["engines"].append(dict(label=label, load_s=load_s))
        print(f"{label}: pf_source artifact, fingerprint equal, bucket of "
              f"{BUCKET} bitwise equal, launches {_store_expected(prog)}; "
              f"loaded in {load_s:.3f} s", flush=True)
    # the same loads again, past this process's one-time costs (imports,
    # the analytic estimator bank every compiler builds)
    clear_program_cache()
    for e, r in zip(rec["engines"], out_rec["engines"]):
        t1 = time.perf_counter()
        prog = get_program(e["bench"], precision=e["precision"], device=dev,
                           artifact_store=store, **e["kw"])
        r["warm_load_s"] = time.perf_counter() - t1
        if prog.pf_source != "artifact":
            raise AssertionError(f"{e['label']} again: {prog.pf_source}")
    for m in rec["measured"]:
        prec = m["precision"]
        comp = MafiaCompiler(precision=prec, artifact_store=store, device=dev,
                             **MEASURED_KW)
        if comp.cost_source != "measured":
            raise AssertionError(f"{m['label']}: cost_source {comp.cost_source}")
        prog = comp.compile(build(STORE_MEASURED)[0],
                            calib=_store_calib(STORE_MEASURED, prec))
        if prog.pf_source != "artifact" or prog.cost_source != "measured":
            raise AssertionError(f"{m['label']}: {prog.pf_source}, "
                                 f"{prog.cost_source}")
        X = data[f"{_store_label(STORE_MEASURED, prec, 'use_pallas')}:x"]
        got = _run_bucket(prog, X, launches)
        _same_outputs(m["label"], got, {
            k.split(":", 1)[1]: data[k] for k in data.files
            if k.startswith(m["label"] + ":")})
        out_rec["measured"].append(dict(label=m["label"],
                                        pf_source=prog.pf_source))
        print(f"{m['label']}: the table from the store, pf_source artifact, "
              "outputs bitwise equal", flush=True)
    if profiled:
        raise AssertionError(f"profile_device ran {len(profiled)} times")
    out_rec.update(launches=launches, profile_calls=len(profiled),
                   store_hits=store.hits, store_misses=store.misses)
    print(f"profile_device calls: {len(profiled)}; store {store.hits} hits, "
          f"{store.misses} misses; launches {launches}", flush=True)
    print(json.dumps(out_rec))
    return 0


def flash_bwd_work(B: int, S: int, H: int, KV: int, dh: int, item: int,
                   window: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one causal flash-attention backward: q, k, v
    and the output's gradient read once, dq, dk, dv and the rows' float32
    log-sum-exp written once; five products (s, dp, dv, dk, dq) of two
    operations per (query, key, dh) element of the pairs the mask keeps."""
    pairs = sum(min(t + 1, window or S) for t in range(S))
    nbytes = item * (3 * B * S * H * dh + 4 * B * S * KV * dh) + 4 * B * H * S
    return float(nbytes), float(10 * B * H * dh * pairs)


def bwd_cases() -> list[tuple[int, int, int, int, int, bool, bool, bool]]:
    """(S, H, KV, dh, window, mla, causal, float32 too) of every head shape
    phase 7 serves, at ``FLASH_BWD_S``, causal, in float32 and bfloat16:
    qwen2.5-3b's, ``FAMILY_HEADS`` (deepseek-v2's MLA with v zero-padded
    from 128 to 192), ``NEW_HEADS``, ``SHARED_HEADS`` without and with a
    window of ``PROBE_WINDOW``; qwen2.5-3b's with that window and with full
    attention (the tensor-core route's other masks); then qwen2.5-3b's at
    the lengths the 36-layer run trains (``LM_TRAIN_FULL_S``, and
    ``LM_TRAIN_FULL_S_OOM`` should it fall back); and the heads of DHP 256
    and G 6 (MLA, zamba2's shared block, internvl2's) at
    ``LM_TRAIN_FULL_S``, the length their families train at, in both
    dtypes."""
    heads = [(16, 2, 128)] + list(FAMILY_HEADS) + list(NEW_HEADS)
    out = [(H, KV, dh, 0, dh == 192, True) for H, KV, dh in heads]
    out += [(*SHARED_HEADS, 0, False, True),
            (*SHARED_HEADS, PROBE_WINDOW, False, True),
            (16, 2, 128, PROBE_WINDOW, False, True), (16, 2, 128, 0, False, False)]
    return ([(FLASH_BWD_S, *case, True) for case in out]
            + [(S, 16, 2, 128, 0, False, True, True)
               for S in (LM_TRAIN_FULL_S, LM_TRAIN_FULL_S_OOM)]
            + [(LM_TRAIN_FULL_S, H, KV, dh, 0, dh == 192, True, True)
               for H, KV, dh in ((128, 128, 192), SHARED_HEADS, G6_HEADS)])


# The heads of phase 10's rounded-p cases: qwen2.5-3b's, deepseek-v2's MLA
# (v zero-padded from 128 to 192) and zamba2-7b's shared block
ROUNDED_HEADS = ((16, 2, 128), (128, 128, 192), SHARED_HEADS)


def rounded_cases() -> list[tuple]:
    """(dtype, S, H, KV, dh) of phase 10's backward with p rounded to
    bfloat16: ``ROUNDED_HEADS`` at ``FLASH_BWD_S`` in float32 and bfloat16,
    and qwen2.5-3b's at ``LM_TRAIN_FULL_S`` in bfloat16, the shape of the
    36-layer run with ``attn_probs_bf16``."""
    import torch

    return ([(dt, FLASH_BWD_S, *heads) for dt in (torch.float32, torch.bfloat16)
             for heads in ROUNDED_HEADS]
            + [(torch.bfloat16, LM_TRAIN_FULL_S, 16, 2, 128)])


def train_phase(dev) -> tuple[dict, dict, dict]:
    """Phase lm-train (see the module docstring).  Returns (record, checks of
    the backward kernels by route, launches over the training runs by
    kernel); raises AssertionError on a failed check."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fused,
                                                     flash_bwd_route,
                                                     flash_route)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)
    from repro_torch.launch.profile_kernels import (argmax_inputs, exact_flash_bwd,
                                                    fault_shares,
                                                    rounded_bwd_faults)
    from repro_torch.launch.train import run_training
    from repro_torch.models.attention import flash_attention as streaming
    from repro_torch.models.layers import ProductF32
    from repro_torch.models.transformer import Transformer, _flatten, _leaves, lm_loss
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_loop import init_state, make_train_step

    rec: dict = {"bwd_cases": [], "bwd_peaked": [], "fwd_row_max": []}
    counted = ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
               "flash_attention_bwd_wgmma")
    launches = dict.fromkeys(counted, 0)
    spec = get_arch(LM_ARCH)

    def ulp(x: float) -> float:
        return 2.0 ** (math.floor(math.log2(x)) - 7)

    def reset():
        for key in counted:
            LAUNCHES[key] = 0

    def take(label, want: dict, quiet: bool = False) -> dict:
        """Check the launches since ``reset()``; add them to the training
        runs' (``quiet``: a check's calls, neither printed nor added)."""
        torch.cuda.synchronize()
        got = {key: LAUNCHES[key] for key in counted}
        if not quiet:
            print(f"  {label}: launches {got} (expected {want})", flush=True)
        if any(got[key] != want.get(key, 0) for key in counted):
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if not quiet:
            for key in counted:
                launches[key] += got[key]
        return got

    def probe(cfg):
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        return [torch.empty((1, 1, h, dh), dtype=cfg.adt, device=dev)
                for h in (H, KV, KV)]

    def fwd_kernel(cfg) -> str:
        return ("flash_attention_wgmma" if flash_route(*probe(cfg)) == "wgmma"
                else "flash_attention")

    def bwd_kernel(cfg) -> str:
        rp = torch.bfloat16 if cfg.attn_probs_bf16 else False
        return ("flash_attention_bwd_wgmma"
                if flash_bwd_route(*probe(cfg), rp) == "wgmma"
                else "flash_attention_bwd")

    def batches(cfg, batch, S, n):
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=batch, seq_len=S)
        return [pipe.batch_at(PipelineState(step=i))[0] for i in range(n)]

    def first_grads(model, tokens, plain: bool, prefix=None):
        weights = [t for ts in _leaves(model).values() for t in ts]
        loss = lm_loss(model, tokens, prefix_embeds=prefix, plain_attention=plain)
        # raises if a weight is cut off the loss's path
        return float(loss.detach()), torch.autograd.grad(loss, weights)

    # 1. the backward kernels against their plain version, and the training
    # forward against its own on the same inputs; each case on the route
    # flash_bwd_route picks, counted, and a second call bitwise equal to the
    # first; a float32 case the tensor cores take, and every rounded-p case
    # they take, also forced onto the CUDA cores (route="simt").  With
    # round_p (p rounded to bfloat16, attn_probs_bf16; v rounded to bfloat16
    # as the model rounds it) against the plain version's rounded gradient
    # (the row max attached): float32 within FLASH_BWD_ROUNDED_REL of each
    # gradient's largest, bfloat16 within FLASH_BWD_BF16_ULPS bf16 ulps, and
    # both within FLASH_BWD_FAULT_SHARE of it towards each fault, with the
    # fp32-p backward as the control that must fail both; the forward
    # (rounding against the row's max on either kernel) at phase 6's limits,
    # and bfloat16 also bitwise on FLASH_ROW_MAX_BITWISE of its outputs
    def bwd_case(dt, S, H, KV, dh, w, mla, causal, peak=1.0, round_p=False):
        bf = torch.bfloat16
        rp = bf if round_p else False
        g = torch.Generator(device=dev).manual_seed(
            H * 1000 + dh + (7 if round_p else w + S + (not causal)))
        q, go = (torch.randn((1, S, H, dh), generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((1, S, KV, dh), generator=g, device=dev).to(dt)
                for _ in range(2))
        if round_p:
            v = v.to(bf).to(dt)
        if peak != 1.0:
            q, k = q * peak, k * peak
        if mla:                 # v and out's gradient past 128 are zeros
            v[..., 128:] = 0
            go[..., 128:] = 0
        label = (f"{str(dt)[6:]} B=1 S={S} H={H} KV={KV} dh={dh}"
                 + ("" if causal else " full")
                 + (f" window {w}" if w else "")
                 + (" mla v 128->192" if mla else "")
                 + (f" q, k x{peak:g}" if peak != 1.0 else "")
                 + (" p rounded to bfloat16" if round_p else ""))
        fwd = flash_attention_fused(q, k, v, causal=causal, window=w, round_p=rp)
        plain = flash_attention_ref(q, k, v, causal=causal, window=w, round_p=rp)
        fwd_ok, fwd_err, fwd_lim = attn_compare(fwd, plain)
        if round_p and dt == bf:
            # the control: the key tile's running max on the same inputs
            tiles = flash_attention_fused(q, k, v, causal=causal, window=w,
                                          round_p=True)
            same, same_t = (float((x == plain).float().mean()) for x in (fwd, tiles))
            fwd_ok = fwd_ok and same >= FLASH_ROW_MAX_BITWISE > same_t
            rec["fwd_row_max"].append(dict(case=label, S=S, err=fwd_err,
                                           limit=fwd_lim, bitwise=same,
                                           tile_max_bitwise=same_t, ok=fwd_ok))
            print(f"  flash_attention_fused {label} (the row's max): max abs err "
                  f"{fwd_err:.3g} (limit {fwd_lim:.3g}), {same:.4f} of the "
                  f"outputs bitwise the plain version's; the key tile's running "
                  f"max {same_t:.4f} (at least {FLASH_ROW_MAX_BITWISE} and below "
                  "it)", flush=True)
            del tiles
        del fwd, plain
        route = flash_bwd_route(q, k, v, rp)
        # every served head on the tensor cores, both dtypes, but float32
        # with p rounded (fb_*, csrc/flash_attention.cu point 6)
        if route != ("simt" if round_p and dt == torch.float32 else "wgmma"):
            raise AssertionError(f"{label} takes the {route} backward")
        want = flash_attention_bwd_ref(q, k, v, go, causal=causal, window=w,
                                       round_p=rp)
        control = None
        if round_p:
            rounded, faults = rounded_bwd_faults(q, k, v, go, causal, w)
            # each fault read (the output's rounding moves its share by at
            # most FLASH_BWD_FAULT_NOISE) in one gradient at least
            unread = [f for f, s in fault_shares(want[:3], rounded, faults).items()
                      if not any(x and x[1] <= FLASH_BWD_FAULT_NOISE
                                 for x in s.values())]
            if unread:
                raise AssertionError(f"{label}: the faults {unread} are not read")
            # the control: the fp32-p backward fails the limits
            fp32 = flash_attention_bwd(q, k, v, go, causal=causal, window=w)[:3]
            control = dict(shares=fault_shares(fp32, rounded, faults), rel={
                n: float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for n, a, b in zip(("dq", "dk", "dv"), fp32, want)})
            del fp32

        def check(got, forced):
            if not round_p:
                return fwd_ok, {}, ""
            shares = fault_shares(got[:3], rounded, faults)
            ok = fwd_ok and not fault_seen(shares) and fault_seen(
                control["shares"]) and (dt == bf or max(
                    control["rel"].values()) > FLASH_BWD_ROUNDED_REL)
            chunked = None
            if (H, KV, dh, S) == (16, 2, 128, FLASH_BWD_S) and not forced \
                    and dt == torch.float32:
                # the reference's function at kv_chunk 256 < S: p rounded
                # against each chunk's running max (a reading; its dv is
                # rounded to bfloat16 by the cast of v, as the model's
                # _bf16_v rounds the kernel's)
                qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
                out = streaming(qq, kk, vv, kv_chunk=256, probs_bf16=True)
                chunk_g = torch.autograd.grad(out, (qq, kk, vv), go)
                mine = (got[0], got[1], got[2].bfloat16().float())
                chunked = {n: float((a - c).abs().max()) / float(c.abs().max())
                           for n, a, c in zip(("dq", "dk", "dv"), mine, chunk_g)}
                del qq, kk, vv, out, chunk_g
            text = (f"; towards each fault (at most {FLASH_BWD_FAULT_SHARE}): "
                    + shares_text(shares) + "; the fp32-p control: "
                    + shares_text(control["shares"]) + ", " + ", ".join(
                        f"{n} {x:.3g}" for n, x in control["rel"].items())
                    + " of each largest")
            if chunked is not None:
                text += ("; against kv_chunk 256 (the reference's several-chunk "
                         "function, read): " + ", ".join(
                             f"{n} {x:.3g} of its largest" for n, x in chunked.items()))
            return ok, dict(fault_shares=shares, fp32_p_control=control,
                            kv_chunk_256=chunked), text

        # the route flash_bwd_route picks; a float32 call or a rounded-p
        # call it gives the tensor cores also forced onto the CUDA cores
        held(label, route, (dt == torch.float32 or round_p) and route == "wgmma"
             and peak == 1.0,
             lambda forced: flash_attention_bwd(q, k, v, go, causal=causal, window=w,
                                                round_p=rp, route=forced),
             want, lambda name, top: (
                 FLASH_BWD_LSE_REL * max(top, 1.0) if name == "lse"
                 else FLASH_BWD_BF16_ULPS * ulp(top) if dt == bf
                 else (FLASH_BWD_ROUNDED_REL if round_p else FLASH_BWD_F32_REL) * top),
             check, dict(rounded=round_p), {"out": (fwd_err, fwd_lim)})
        del q, k, v, go, want

    def held(label, route, also_simt, call, want, limit, check=None, info=None,
             first=None):
        """The backward ``call(forced)`` on ``route`` (and with ``also_simt``
        forced onto the CUDA cores, ``forced="simt"``): two calls, counted
        and bitwise equal, dq, dk, dv and lse each within ``limit(name,
        its largest)`` of ``want``, and ``check(got, forced)`` -> (ok,
        record, text) where given; ``first``: readings {name: (err,
        limit)} printed ahead.  Records each route in ``rec["bwd_cases"]``
        with ``info``; raises on a failed one."""
        for r in (route, "simt") if also_simt else (route,):
            kernel = ("flash_attention_bwd_wgmma" if r == "wgmma"
                      else "flash_attention_bwd")
            forced = "simt" if r != route else None
            reset()
            got, again = call(forced), call(forced)
            take(f"backward {r} {label}", {kernel: 2}, quiet=True)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            errs = {n: x[0] for n, x in (first or {}).items()}
            lims = {n: x[1] for n, x in (first or {}).items()}
            for name, a, b in zip(("dq", "dk", "dv", "lse"), got, want):
                lims[name] = limit(name, float(b.float().abs().max()))
                errs[name] = float((a.float() - b.float()).abs().max())
            ok, more, text = check(got, forced) if check else (True, {}, "")
            ok = ok and same and all(errs[n] <= lims[n] for n in errs
                                     if n not in (first or {}))
            rec["bwd_cases"].append(dict(case=label, route=r, errs=errs, limits=lims,
                                         bitwise=same, ok=ok,
                                         forced=forced is not None,
                                         **(info or {}), **more))
            print(f"  flash_attention_bwd {label} ({r}"
                  + (", forced" if forced else "") + "): max abs err "
                  + ", ".join(f"{n} {errs[n]:.3g} (limit {lims[n]:.3g})"
                              for n in errs)
                  + ("; two calls bitwise equal" if same else "; TWO CALLS DIFFER")
                  + text, flush=True)
            if not ok:
                raise AssertionError(f"flash_attention_bwd {label} ({r}): {errs} "
                                     f"over the limits {lims}, two calls differ "
                                     f"({not same}), or its own check failed: "
                                     f"{more}")
            del got, again

    def fault_seen(shares) -> bool:
        """A gradient read that lies nearer a fault than the rounded one."""
        return any(x and x[1] <= FLASH_BWD_FAULT_NOISE and x[0] > FLASH_BWD_FAULT_SHARE
                   for s in shares.values() for x in s.values())

    def shares_text(shares) -> str:
        return "; ".join(f"{f} " + ", ".join(
            f"{n} {x[0]:.3f}" + (" (unread)" if x[1] > FLASH_BWD_FAULT_NOISE else "")
            for n, x in s.items() if x) for f, s in shares.items())

    # p rounded to bfloat16 on one-hot attention (argmax_inputs): where
    # every row's share is the whole of dq and dk, so that they show that
    # each kernel found the row's max where its scores equal it bitwise
    # (S = q.k^T in the dq kernel's passes, S^T = k.q^T in the dkdv
    # kernels); dq and dk within FLASH_BWD_ARGMAX_REL of the detached max's
    # largest, dv and lse at bwd_case's limits; each route as bwd_case's
    def argmax_case(dt, H, KV, dh):
        S, bf = FLASH_BWD_S, torch.bfloat16
        q, k, v, go = argmax_inputs(S, H, KV, dh, dt, dev, seed=H + dh,
                                    dhv=128 if dh == 192 else None)
        label = (f"{str(dt)[6:]} B=1 S={S} H={H} KV={KV} dh={dh} one-hot "
                 "p rounded to bfloat16")
        route = flash_bwd_route(q, k, v, bf)
        if route != ("simt" if dt == torch.float32 else "wgmma"):
            raise AssertionError(f"{label} takes the {route} backward")
        want = flash_attention_bwd_ref(q, k, v, go, round_p=bf)
        size = dict(zip(("dq", "dk"), (float(t.abs().max()) for t in rounded_bwd_faults(
            q, k, v, go)[1]["detached max"][:2])))
        held(label, route, route == "wgmma",
             lambda forced: flash_attention_bwd(q, k, v, go, round_p=bf, route=forced),
             want, lambda name, top: (
                 FLASH_BWD_ARGMAX_REL * size[name] if name in size
                 else FLASH_BWD_LSE_REL * max(top, 1.0) if name == "lse"
                 else FLASH_BWD_BF16_ULPS * ulp(top) if dt == bf
                 else FLASH_BWD_ROUNDED_REL * top),
             lambda got, forced: (True, {}, "; without the shares " + ", ".join(
                 f"{n} {x:.3g}" for n, x in size.items())),
             dict(rounded=True, one_hot=True, share_size=size))
        del q, k, v, go, want

    # the bfloat16 forward with p rounded against the row's max on scores
    # that rise along the keys (a row's running max moves in every key
    # tile), qwen2.5-3b's heads: within one bf16 ulp of the plain version
    # and bitwise on FLASH_ROW_MAX_BITWISE of the outputs, which the key
    # tile's running max (round_p=True on the same inputs) must fail
    def row_max_case(S, causal):
        rng = np.random.default_rng(5)
        u = rng.standard_normal(128).astype(np.float32)
        q = (u + 0.3 * rng.standard_normal((1, S, 16, 128))).astype(np.float32)
        k = (np.linspace(0, 4, S, dtype=np.float32)[None, :, None, None] * u
             + 0.3 * rng.standard_normal((1, S, 2, 128))).astype(np.float32)
        v = rng.standard_normal((1, S, 2, 128)).astype(np.float32)
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v))
        label = (f"bfloat16 B=1 S={S} H=16 KV=2 dh=128" + ("" if causal else " full")
                 + " scores rising along the keys")
        plain = flash_attention_ref(q, k, v, causal=causal, round_p=torch.bfloat16)
        reset()
        rows_ = flash_attention_fused(q, k, v, causal=causal, round_p=torch.bfloat16)
        tiles = flash_attention_fused(q, k, v, causal=causal, round_p=True)
        take(f"forward {label}", {"flash_attention_wgmma": 2}, quiet=True)
        ok, err, lim = attn_compare(rows_, plain)
        same, same_t = (float((x == plain).float().mean()) for x in (rows_, tiles))
        ok = ok and same >= FLASH_ROW_MAX_BITWISE > same_t
        rec["fwd_row_max"].append(dict(case=label, S=S, err=err, limit=lim,
                                       bitwise=same, tile_max_bitwise=same_t,
                                       ok=ok))
        print(f"  flash_attention_fused {label} (the row's max): max abs err "
              f"{err:.3g} (limit {lim:.3g}), {same:.4f} of the outputs bitwise "
              f"the plain version's; the key tile's running max {same_t:.4f} "
              f"(must be below {FLASH_ROW_MAX_BITWISE})", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_fused {label}: max abs err "
                                 f"{err} (limit {lim}), bitwise {same}, the "
                                 f"tile max's {same_t}")

    # q and k FLASH_BWD_PEAKS times larger: held to the exact gradient
    # (float64), at x8 also to the plain version; FLASH_BWD_PEAK_READ read
    def peak_case(H, KV, dh, peak):
        S, mla = FLASH_BWD_S, dh == 192
        g = torch.Generator(device=dev).manual_seed(H * 1000 + dh + S)
        q, go = (torch.randn((1, S, H, dh), generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((1, S, KV, dh), generator=g, device=dev)
                for _ in range(2))
        q, k = q * peak, k * peak
        if mla:
            v[..., 128:] = 0
            go[..., 128:] = 0
        if flash_bwd_route(q, k, v) != "wgmma":
            raise AssertionError(f"peaked H={H} KV={KV} dh={dh}: not the tensor cores")
        reset()
        got = flash_attention_bwd(q, k, v, go)
        again = flash_attention_bwd(q, k, v, go)
        take(f"peaked backward H={H} KV={KV} dh={dh}",
             {"flash_attention_bwd_wgmma": 2}, quiet=True)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        shares = {}
        for ref, want in (("exact", exact_flash_bwd(q, k, v, go)),
                          ("plain", flash_attention_bwd_ref(q, k, v, go))):
            shares[ref] = {}
            for name, a, b in zip(("dq", "dk", "dv", "lse"), got, want):
                top = float(b.abs().max())
                lim = (FLASH_BWD_LSE_REL * max(top, 1.0) if name == "lse"
                       else FLASH_BWD_F32_REL * top)
                shares[ref][name] = float((a - b).abs().max()) / lim
        held = (("exact", "plain") if peak <= FLASH_BWD_PEAKS[0] else ("exact",)
                if peak in FLASH_BWD_PEAKS else ())
        ok = same and all(max(shares[r].values()) <= 1.0 for r in held)
        label = (f"float32 B=1 S={S} H={H} KV={KV} dh={dh}"
                 + (" mla v 128->192" if mla else "") + f" q, k x{peak:g}")
        rec["bwd_peaked"].append(dict(case=label, shares=shares, held=held,
                                      bitwise=same, ok=ok))
        print(f"  flash_attention_bwd {label} (wgmma): share of the limits "
              + "; ".join(f"against the {r} gradient "
                          + ", ".join(f"{n} {x:.3f}" for n, x in shares[r].items())
                          for r in shares)
              + (f" (held: {', '.join(held)})" if held else " (a reading)")
              + ("; two calls bitwise equal" if same else "; TWO CALLS DIFFER"),
              flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {label}: {shares} over "
                                 f"the limits ({held}), or two calls differ")
        del q, k, v, go, got, again

    def bwd_checks():
        for dt in (torch.float32, torch.bfloat16):
            for S, H, KV, dh, w, mla, causal, f32 in bwd_cases():
                if dt == torch.float32 and not f32:
                    continue
                bwd_case(dt, S, H, KV, dh, w, mla, causal)
        # peaked scores: q and k FLASH_BWD_PEAK times larger, float32 on
        # the tensor cores at the trained length
        for H, KV, dh in ((16, 2, 128), G6_HEADS):
            bwd_case(torch.float32, LM_TRAIN_FULL_S, H, KV, dh, 0, False, True,
                     peak=FLASH_BWD_PEAK)
        for H, KV, dh in FLASH_BWD_PEAK_HEADS:
            for peak in FLASH_BWD_PEAKS + (FLASH_BWD_PEAK_READ,):
                peak_case(H, KV, dh, peak)
        # p rounded to bfloat16 (attn_probs_bf16) at qwen2.5-3b's, MLA's and
        # zamba2's heads, S FLASH_BWD_S, both dtypes, and at qwen2.5-3b's
        # at the 36-layer run's S in bfloat16; one-hot attention at the
        # same heads; the forward on rising scores at both lengths
        for dt, S, H, KV, dh in rounded_cases():
            bwd_case(dt, S, H, KV, dh, 0, dh == 192, True, round_p=True)
        for dt in (torch.float32, torch.bfloat16):
            for H, KV, dh in ROUNDED_HEADS:
                argmax_case(dt, H, KV, dh)
        for S in (FLASH_BWD_S, LM_TRAIN_FULL_S):
            for causal in (True, False):
                row_max_case(S, causal)
        out = {}
        for route, kernel in (("simt", "flash_attention_bwd"),
                              ("wgmma", "flash_attention_bwd_wgmma")):
            cases = [c for c in rec["bwd_cases"] if c["route"] == route
                     and not c["rounded"]]
            out[kernel] = {"cases": len(cases), "max_abs_err": max(
                max(c["errs"][n] for n in ("dq", "dk", "dv")) for c in cases)}
        rec["bwd_rounded_max_abs_err"] = {r: max(
            max(c["errs"][n] for n in ("dq", "dk", "dv"))
            for c in rec["bwd_cases"] if c["route"] == r and c["rounded"])
            for r in ("simt", "wgmma")}
        return out

    # 2. the float32 twin: kernels against the attention's plain version;
    # with ``probs`` the config's attn_probs_bf16 on (p rounded to bfloat16
    # in P.V: the CUDA-core backward with the rounding, float32's route,
    # against autograd through the plain version with the row max attached)
    def twin(probs: bool = False):
        L = LM_TRAIN_LAYERS
        cfg = dataclasses.replace(spec.model, n_layers=L, act_dtype="float32",
                                  attn_probs_bf16=probs)
        data = batches(cfg, 2, LM_TRAIN_S, LM_TRAIN_STEPS)
        model, state = init_state(cfg, 0, device=dev)
        paths = [(p, len(ts)) for p, ts in _leaves(model).items()]
        fk, bk = fwd_kernel(cfg), bwd_kernel(cfg)
        # p rounded: float32 takes the CUDA-core pair (flash_bwd_route)
        if bk != ("flash_attention_bwd" if probs else "flash_attention_bwd_wgmma"):
            raise AssertionError(f"the float32 twin takes the {bk} backward")
        reset()
        loss_k, gk = first_grads(model, data[0]["tokens"], False)
        take(f"{cfg.name} x{L} float32 first gradient", {fk: 2 * L, bk: L})
        reset()
        loss_p, gp = first_grads(model, data[0]["tokens"], True)
        take(f"{cfg.name} x{L} float32 first gradient, plain attention", {})
        grad_errs = {}
        it_k, it_p = iter(gk), iter(gp)
        for path, n in paths:
            a = torch.stack([next(it_k) for _ in range(n)]).float()
            b = torch.stack([next(it_p) for _ in range(n)]).float()
            top = float(b.abs().max())
            err = float((a - b).abs().max())
            grad_errs[path] = (err, top)
            # p rounded: the rounded backward's own limit (LM_TRAIN_PROBS)
            lim = (FLASH_BWD_BF16_ULPS * ulp(top) if probs and top > 0
                   else LM_TRAIN_GRAD_REL * top)
            if not (math.isfinite(err) and top > 0 and err <= lim):
                raise AssertionError(f"twin gradient {path}: max abs err {err} "
                                     f"against largest {top} (limit {lim})")
        worst = max(grad_errs, key=lambda p: grad_errs[p][0] / grad_errs[p][1])
        print(f"  {cfg.name} x{L} float32 S={LM_TRAIN_S}: loss {loss_k:.6f} "
              f"(plain attention {loss_p:.6f}); every one of {len(paths)} leaves "
              f"has a gradient; worst {worst} {grad_errs[worst][0]:.3g} of "
              f"{grad_errs[worst][1]:.3g}", flush=True)
        del gk, gp
        oc = OptConfig(lr=1e-4, warmup_steps=0, total_steps=LM_TRAIN_STEPS)
        losses = {}
        for plain in (False, True):
            if plain:
                del model, state
                gc.collect()
                model, state = init_state(cfg, 0, device=dev)
            step = make_train_step(model, oc, plain_attention=plain)
            reset()
            losses[plain] = []
            for b in data:
                state, m = step(state, b)
                losses[plain].append(float(m["loss"]))
            take(f"{cfg.name} x{L} float32 {LM_TRAIN_STEPS} steps"
                 + (", plain attention" if plain else ""),
                 {} if plain else {fk: 2 * L * LM_TRAIN_STEPS,
                                   bk: L * LM_TRAIN_STEPS})
        print(f"  {cfg.name} x{L} float32 losses {losses[False]} (plain attention "
              f"{losses[True]})", flush=True)
        if not all(math.isfinite(x) for x in losses[False]) or not all(
                abs(a - b) <= LM_TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(losses[False], losses[True])):
            raise AssertionError(f"twin losses {losses[False]} against the plain "
                                 f"attention's {losses[True]}")
        rec["twin_probs_bf16" if probs else "twin"] = dict(
            config=(f"{cfg.name} x{L} float32 S={LM_TRAIN_S} B=2"
                    + (" attn_probs_bf16" if probs else "")),
            loss=loss_k, loss_plain=loss_p, losses=losses[False],
            losses_plain=losses[True], worst_grad=(worst, *grad_errs[worst]))

    # 2b. the twin with attn_probs_bf16 (LM_TRAIN_PROBS)
    def twin_probs():
        twin(probs=True)

    # 3. olmoe-1b-7b in bfloat16: the router and the expert bmm's backward
    def moe():
        arch, L, n = LM_TRAIN_MOE
        cfg = dataclasses.replace(get_arch(arch).model, n_layers=L,
                                  act_dtype="bfloat16")
        data = batches(cfg, 2, LM_TRAIN_S, n)
        model, state = init_state(cfg, 0, device=dev)
        fk, bk = fwd_kernel(cfg), bwd_kernel(cfg)
        if bk != "flash_attention_bwd_wgmma":
            raise AssertionError(f"{cfg.name} bf16 takes the {bk} backward")
        reset()
        loss0, grads = first_grads(model, data[0]["tokens"], False)
        names = [f"{p}[{i}]" for p, ts in _leaves(model).items()
                 for i in range(len(ts))]
        bad = [name for name, g in zip(names, grads)
               if not bool(torch.isfinite(g).all())]
        nonzero = sum(bool(g.any()) for g in grads)
        del grads
        step = make_train_step(model, OptConfig(lr=1e-4, warmup_steps=0,
                                                total_steps=n))
        moe_losses = []
        for b in data:
            state, m = step(state, b)
            moe_losses.append(float(m["loss"]))
        take(f"{cfg.name} x{L} bfloat16 first gradient and {n} steps",
             {fk: 2 * L * (n + 1), bk: L * (n + 1)})
        print(f"  {cfg.name} x{L} bfloat16 S={LM_TRAIN_S}: first loss {loss0:.4f}, "
              f"{nonzero} of {len(names)} weights with a "
              f"non-zero gradient, losses {moe_losses}", flush=True)
        if bad or not all(math.isfinite(x) for x in [loss0] + moe_losses):
            raise AssertionError(f"{cfg.name} bf16: non-finite gradients {bad[:5]} "
                                 f"or losses {moe_losses}")
        # ProductF32's backward against autograd through the upcast product
        E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        gen = torch.Generator(device=dev).manual_seed(5)
        prod_err = 0.0
        for sa, sb in (((E, 64, D), (E, D, Fe)), ((512, D), (D, Fe))):
            a = torch.randn(sa, generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn(sb, generator=gen, device=dev)
                 * D ** -0.5).to(torch.bfloat16)
            go = torch.randn(sa[:-1] + sb[-1:], generator=gen, device=dev)
            a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
            ProductF32.apply(a1, w1).backward(go)
            a2, w2 = a.clone().requires_grad_(), w.clone().requires_grad_()
            (a2.float() @ w2.float()).backward(go)
            for x, y in ((a1.grad, a2.grad), (w1.grad, w2.grad)):
                err = float((x.float() - y.float()).abs().max())
                prod_err = max(prod_err, err)
                if err > ulp(float(y.float().abs().max())):
                    raise AssertionError(f"ProductF32 backward {sa} x {sb}: max "
                                         f"abs err {err}")
        print(f"  ProductF32 backward (expert bmm and mm, bf16) against autograd "
              f"through the upcast product: max abs err {prod_err:.3g}", flush=True)
        rec["moe"] = dict(config=f"{cfg.name} x{L} bfloat16 S={LM_TRAIN_S} B=2",
                          first_loss=loss0, losses=moe_losses,
                          nonzero_grads=nonzero, product_err=prod_err)

    # 4. the bf16 families on the tensor-core backward's DHP 256 and G 6
    # heads, at every width; deepseek-v2-236b's memory need, from its shapes
    def families():
        arch, L = LM_TRAIN_NOT_FIT
        cfg = dataclasses.replace(get_arch(arch).model, n_layers=L,
                                  act_dtype="bfloat16")
        n = sum(t.numel() for ts in _leaves(Transformer(cfg, torch.device(
            "meta"))).values() for t in ts)
        need = 18 * n / 2**30
        print(f"  {cfg.name} x{L} bf16: {n / 1e9:.3f} B parameters; f32 masters, "
              f"m, v, bf16 weights and the f32 gradient sum {need:.1f} GiB of the "
              f"card's {torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}:"
              " not trained (its heads' backward is held above)", flush=True)
        rec["families"] = [dict(config=f"{cfg.name} x{L} bfloat16", trained=False,
                                params=n, need_gib=need)]
        for arch, L, S, S_oom in LM_TRAIN_FAMILIES:
            rec["families"].append(family(arch, L, S, S_oom))
        rec["families"].append(family(*LM_TRAIN_F32_DHP256, dtype="float32"))

    def family(arch, L, S, S_oom, dtype="bfloat16") -> dict:
        """The tensor-core backward in either dtype (float32 at DHP 256:
        its 16-slot row tiles)."""
        cfg = dataclasses.replace(get_arch(arch).model, n_layers=L,
                                  act_dtype=dtype)
        fk, bk = fwd_kernel(cfg), bwd_kernel(cfg)
        if bk != "flash_attention_bwd_wgmma":
            raise AssertionError(f"{cfg.name} {dtype} takes the {bk} backward")
        na, B, n = attention_layers(cfg), LM_TRAIN_FAMILY_BATCH, LM_TRAIN_FAMILY_STEPS
        Np = LM_TRAIN_PREFIX if cfg.modality == "vision_prefix" else 0
        while True:
            oom = None
            try:
                torch.cuda.reset_peak_memory_stats()
                model, state = init_state(cfg, 0, device=dev)
                params = sum(t.numel() for ts in _leaves(model).values() for t in ts)
                data = batches(cfg, B, S - Np, n)
                gp = torch.Generator(device=dev).manual_seed(21)
                for b in data if Np else ():   # internvl2's patch stub, N(0, 0.02²)
                    b["prefix"] = (0.02 * torch.randn((B, Np, cfg.d_model), generator=gp,
                                                      device=dev)).to(cfg.adt)
                reset()
                loss0, grads = first_grads(model, data[0]["tokens"], False,
                                           data[0].get("prefix"))
                names = [f"{p}[{i}]" for p, ts in _leaves(model).items()
                         for i in range(len(ts))]
                bad = [name for name, g in zip(names, grads)
                       if not bool(torch.isfinite(g).all())]
                nonzero = sum(bool(g.any()) for g in grads)
                del grads
                step = make_train_step(model, OptConfig(lr=1e-4, warmup_steps=0,
                                                        total_steps=n))
                losses, secs = [], []
                for b in data:
                    t1 = time.perf_counter()
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
                    secs.append(time.perf_counter() - t1)
                break
            except torch.cuda.OutOfMemoryError as e:
                if S == S_oom:
                    raise
                oom = f"{e}".splitlines()[0]
                traceback.print_exc()
            # out of the handler, so that its frames no longer hold the tensors
            print(f"  {cfg.name} x{L} at S={S} does not fit the card ({oom}); "
                  f"S={S_oom}", flush=True)
            model = state = step = None
            gc.collect()
            torch.cuda.empty_cache()
            S = S_oom
        label = (f"{cfg.name} x{L} {dtype} (f32 masters) S={S}"
                 + (f" ({Np} prefix rows)" if Np else "") + f" B={B}, remat "
                 f"{cfg.remat_policy}")
        got = take(f"{label}: first gradient and {n} steps",
                   {fk: 2 * na * (n + 1), bk: na * (n + 1)})
        r = dict(config=label, trained=True, params=params, seq_len=S, prefix=Np,
                 first_loss=loss0, losses=losses, nonzero_grads=nonzero,
                 leaves=len(names), seconds=statistics.median(secs),
                 tokens_per_s=B * (S - Np) / statistics.median(secs),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=got,
                 oom=oom)
        print(f"  {label}: {params / 1e9:.3f} B parameters; first loss {loss0:.4f}, "
              f"{nonzero} of {len(names)} weights with a non-zero gradient; losses "
              f"{losses}; a step {r['seconds']:.3f} s (median of {n}), "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gib']:.2f} GiB",
              flush=True)
        if bad or not all(math.isfinite(x) for x in [loss0] + losses):
            raise AssertionError(f"{cfg.name} {dtype}: non-finite gradients "
                                 f"{bad[:5]} or losses {losses}")
        return r

    # 5. qwen2.5-3b at every width: in float32 at LM_TRAIN_F32 layers, then
    # in bfloat16 at full depth
    def full_f32():
        full("full_f32", dataclasses.replace(spec.model, n_layers=LM_TRAIN_F32,
                                             act_dtype="float32"),
             LM_TRAIN_F32_WARM, LM_TRAIN_F32_STEPS)

    # 5b. the 36-layer bfloat16 run with attn_probs_bf16: the rounded-p
    # backward on the tensor cores and the row-max forward on every layer
    def full_probs():
        full("full_probs", dataclasses.replace(spec.model, attn_probs_bf16=True),
             LM_TRAIN_PROBS_WARM, LM_TRAIN_PROBS_STEPS)

    def full(key="full", cfg=None, warm=LM_TRAIN_FULL_WARM,
             steps=LM_TRAIN_FULL_STEPS):
        cfg = cfg or spec.model
        L = cfg.n_layers
        dname = cfg.act_dtype + (" attn_probs_bf16" if cfg.attn_probs_bf16 else "")
        fk, bk = fwd_kernel(cfg), bwd_kernel(cfg)
        if bk != "flash_attention_bwd_wgmma":
            raise AssertionError(f"{cfg.name} {dname} takes the {bk} backward")
        S = LM_TRAIN_FULL_S
        while True:
            oom = None
            try:
                print(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
                      f"before {cfg.name} x{L} at S={S}", flush=True)
                torch.cuda.reset_peak_memory_stats()
                model, state = init_state(cfg, 0, device=dev)
                print(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
                      "with the model, masters and moments", flush=True)
                step = make_train_step(model, OptConfig(),
                                       n_microbatches=LM_TRAIN_FULL_MB)
                data = batches(cfg, LM_TRAIN_FULL_BATCH, S, warm + steps + 1)
                full_steps = []
                for i, b in enumerate(data[:-1]):
                    reset()
                    t1 = time.perf_counter()
                    state, m = step(state, b)
                    loss = float(m["loss"])
                    sec = time.perf_counter() - t1
                    per = LM_TRAIN_FULL_MB * L
                    got = take(f"{cfg.name} step {i}", {fk: 2 * per, bk: per})
                    row = dict(step=i, warm=i < warm, loss=loss,
                               grad_norm=float(m["grad_norm"]), seconds=sec,
                               tokens_per_s=LM_TRAIN_FULL_BATCH * S / sec,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                               launches=got)
                    full_steps.append(row)
                    print(f"  {cfg.name} x{L} {dname} S={S} step {i}"
                          + (" (warm-up)" if row["warm"] else "")
                          + f": loss {loss:.4f}, grad norm {row['grad_norm']:.3f}, "
                          f"{sec:.3f} s, {row['tokens_per_s']:.0f} tokens/s, peak "
                          f"{row['peak_gib']:.2f} GiB", flush=True)
                    if not (math.isfinite(loss) and math.isfinite(row["grad_norm"])
                            and row["grad_norm"] > 0):
                        raise AssertionError(f"{cfg.name} step {i}: loss {loss}, "
                                             f"grad norm {row['grad_norm']}")
                break
            except torch.cuda.OutOfMemoryError as e:
                if S == LM_TRAIN_FULL_S_OOM:
                    raise
                oom = f"{e}".splitlines()[0]
                traceback.print_exc()
            # out of the handler, so that its frames no longer hold the tensors
            print(f"  {cfg.name} x{L} at S={S} does not fit the card ({oom}); "
                  f"S={LM_TRAIN_FULL_S_OOM}", flush=True)
            rec[f"{key}_oom"] = dict(seq_len=S, error=oom)
            model = state = step = None
            gc.collect()
            torch.cuda.empty_cache()
            S = LM_TRAIN_FULL_S_OOM
        # one more step in a profiler trace: the backward kernels' share
        reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            state, m = step(state, data[-1])
            torch.cuda.synchronize()
        per = LM_TRAIN_FULL_MB * L
        got = take(f"{cfg.name} traced step", {fk: 2 * per, bk: per})
        launched = {n: got[n] + sum(r["launches"][n] for r in full_steps)
                    for n in got}
        by: dict[str, float] = {}
        for name, us in trace_acts(p)[0]:
            by[name] = by.get(name, 0.0) + us / 1e3
        # a trace that lost every device activity (ROADMAP Queue C item 8)
        # leaves the split not measured (NaN)
        total = sum(by.values()) or float("nan")
        bwd = sum(v for name, v in by.items()
                  if any(k in name for k in FLASH_BWD_KERNELS)) or float("nan")
        fwd = sum(v for name, v in by.items()
                  if "fa_tc_kernel" in name or "fa_kernel" in name) or float("nan")
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        timed = [r for r in full_steps if not r["warm"]]
        rec[key] = dict(
            config=f"{cfg.name} x{L} {dname} (f32 masters) S={S} "
                   f"B={LM_TRAIN_FULL_BATCH} in {LM_TRAIN_FULL_MB} microbatches, "
                   f"remat {cfg.remat_policy}",
            seq_len=S, steps=full_steps,
            seconds=statistics.median(r["seconds"] for r in timed),
            tokens_per_s=statistics.median(r["tokens_per_s"] for r in timed),
            peak_gib=max(r["peak_gib"] for r in full_steps),
            device_ms=total, flash_bwd_ms=bwd, flash_fwd_ms=fwd,
            top=[(name, ms) for name, ms in top], launches=launched)
        r = rec[key]
        print(f"  {cfg.name} x{L} {dname} S={S}: a step {r['seconds']:.3f} s "
              f"(median of {len(timed)}), {r['tokens_per_s']:.0f} tokens/s, "
              f"peak {r['peak_gib']:.2f} GiB; traced step {total:.1f} ms on "
              f"the device ({'; '.join(f'{n[:40]} {ms:.1f}' for n, ms in top)}), "
              f"flash backward {bwd:.1f} ms ({bwd / total:.1%}), flash forward "
              f"{fwd:.1f} ms ({fwd / total:.1%})", flush=True)

    # 6. resume from a checkpoint: launch.train.run_training, 4-layer f32 copy
    def resume():
        kw = dict(smoke=False, batch=LM_RESUME_BATCH, seq_len=LM_RESUME_S,
                  ckpt_every=LM_RESUME_AT, microbatches=1, lr=1e-3, log_every=1,
                  device=dev, layers=LM_TRAIN_LAYERS, act_dtype="float32", seed=0)
        L = LM_TRAIN_LAYERS
        f32 = dataclasses.replace(spec.model, act_dtype="float32")
        fk, bk = fwd_kernel(f32), bwd_kernel(f32)
        if bk != "flash_attention_bwd_wgmma":
            raise AssertionError(f"the float32 resume takes the {bk} backward")
        with tempfile.TemporaryDirectory(prefix="mafia-ckpt-") as d:
            print(f"  checkpoints under a temporary directory, "
                  f"{shutil.disk_usage(d).free / 2**30:.0f} GiB free", flush=True)
            reset()
            t1 = time.perf_counter()
            straight = run_training(LM_ARCH, steps=LM_RESUME_STEPS, ckpt_dir=None,
                                    **kw)["state"]
            run_training(LM_ARCH, steps=LM_RESUME_AT, ckpt_dir=d, **kw)
            resumed = run_training(LM_ARCH, steps=LM_RESUME_STEPS, ckpt_dir=d,
                                   **kw)["state"]
            n_steps = 2 * LM_RESUME_STEPS          # straight, then 2 + 2 resumed
            take("launch.train straight, to the checkpoint, resumed",
                 {fk: 2 * L * n_steps, bk: L * n_steps})
            resume_s = time.perf_counter() - t1
        diffs = []
        for part in ("params", "m", "v"):
            flat_a = _flatten(getattr(straight, part))
            flat_b = _flatten(getattr(resumed, part))
            for path in flat_a:
                if not torch.equal(flat_a[path], flat_b[path]):
                    diffs.append((f"{part}/{path}", float(
                        (flat_a[path] - flat_b[path]).abs().max())))
        same_step = int(straight.step) == int(resumed.step) == LM_RESUME_STEPS
        rec["resume"] = dict(steps=LM_RESUME_STEPS, at=LM_RESUME_AT,
                             seconds=resume_s, differing=diffs,
                             leaves=3 * len(_flatten(straight.params)))
        print(f"  resume: {LM_RESUME_STEPS} steps straight against "
              f"{LM_RESUME_AT} + checkpoint + {LM_RESUME_STEPS - LM_RESUME_AT} "
              f"resumed: {len(diffs)} of {rec['resume']['leaves']} leaves differ"
              + (f" (largest {max(x for _, x in diffs):.3g}: "
                 f"{[p for p, _ in diffs[:6]]})" if diffs else ", bitwise equal")
              + f"; {resume_s:.1f} s", flush=True)
        if diffs or not same_step:
            raise AssertionError(f"resume is not bitwise: {diffs[:6]}, steps "
                                 f"{int(straight.step)} / {int(resumed.step)}")

    # each part in its own function: its tensors die when it returns
    checks = None
    for part in (bwd_checks, twin, twin_probs, moe, families, full_f32, full,
                 full_probs, resume):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              f"before the {part.__name__} part", flush=True)
        checks = part() or checks
    return rec, checks, launches


def dist_phase(dev) -> tuple[dict, dict]:
    """Phase dist (see the module docstring).  Returns (record, launches of
    the flash kernels over the mesh's steps); raises AssertionError on a
    failed check."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import ARCH_IDS, SHAPES, ShapeCell, get_arch
    from repro_torch.data.tokens import PipelineState, TokenPipeline
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_group, make_mesh, mesh_axes
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten, _nest
    from repro_torch.sharding.placement import local_rows
    from repro_torch.train import compression as tcomp
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig, adamw_update, global_norm

    counted = ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
               "flash_attention_bwd_wgmma")
    launches = dict.fromkeys(counted, 0)
    rec: dict = {}
    spec = get_arch(LM_ARCH)
    spec4 = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_layers=DIST_LAYERS))
    cell = ShapeCell("dist", "train", DIST_S, DIST_BATCH)
    cfg = spec4.cell_config(cell)
    L, mb = DIST_LAYERS, DIST_MB
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=DIST_BATCH,
                         seq_len=DIST_S)
    data = [{k: torch.as_tensor(v) for k, v in
             pipe.batch_at(PipelineState(step=i))[0].items()}
            for i in range(DIST_STEPS)]
    want = {"flash_attention_wgmma": 2 * L * mb * DIST_STEPS,
            "flash_attention_bwd_wgmma": L * mb * DIST_STEPS}

    def sync_time(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def run_mesh(mesh, pod_reduce: str) -> dict:
        """DIST_STEPS steps through build_cell's step on the mesh; the
        launches counted over them."""
        ef = pod_reduce == "int8_ef"
        torch.cuda.reset_peak_memory_stats()
        model, state = tloop.init_state(cfg, 0, device=dev, ef=ef)
        prog = build_cell(spec4, cell, mesh, pod_reduce=pod_reduce,
                          microbatch_override=mb, oc=oc, model=model)
        state = tloop.shard_state(state, prog.in_shardings[0], mesh)
        rows = prog.in_shardings[1]["tokens"]
        for key in counted:
            LAUNCHES[key] = 0
        steps = []
        for b in data:
            (state, m), sec = sync_time(
                lambda: prog.fn(state, local_rows(b, rows, mesh)))
            steps.append(dict(loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              lr=float(m["lr"]), seconds=sec))
        got = {key: LAUNCHES[key] for key in counted}
        print(f"  {pod_reduce} on the mesh: launches {got} (expected {want})",
              flush=True)
        if any(got[key] != want.get(key, 0) for key in counted):
            raise AssertionError(f"{pod_reduce}: launches {got}, expected {want}")
        for key in counted:
            launches[key] += got[key]
        full = tloop.gather_state(state)
        return dict(steps=steps, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    params=_flatten(full.params), m=_flatten(full.m),
                    v=_flatten(full.v),
                    ef=_flatten(full.ef) if ef else None, plan=prog.plan)

    def compare(label: str, got: dict, ref: dict, parts) -> int:
        same = [a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                and a["lr"] == b["lr"] for a, b in zip(got["steps"], ref["steps"])]
        diffs = [f"{part}/{path}" for part in parts
                 for path in ref[part] if not torch.equal(got[part][path],
                                                          ref[part][path])]
        n = sum(len(ref[part]) for part in parts)
        print(f"  {label}: losses {[s['loss'] for s in got['steps']]} against "
              f"{[s['loss'] for s in ref['steps']]}, grad norms "
              f"{[s['grad_norm'] for s in got['steps']]}; {len(diffs)} of {n} "
              "leaves differ" + (f": {diffs[:6]}" if diffs else ", bitwise equal"),
              flush=True)
        if diffs or not all(same):
            raise AssertionError(f"{label} is not bitwise: steps {same}, "
                                 f"leaves {diffs[:6]}")
        return n

    def fp32_reference() -> dict:
        model, st = tloop.init_state(cfg, 0, device=dev)
        step = tloop.make_train_step(model, oc, n_microbatches=mb)
        steps = []
        for b in data:
            (st, m), sec = sync_time(lambda: step(st, b))
            steps.append(dict(loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              lr=float(m["lr"]), seconds=sec))
        return dict(steps=steps, params=_flatten(st.params), m=_flatten(st.m),
                    v=_flatten(st.v))

    def int8_reference() -> dict:
        """The EF math of one pod on the host around the one-process
        gradient: c = g + ef, its int8 quantization, the mean of one pod's
        dequantized values, the residual c - q·scale."""
        model, st = tloop.init_state(cfg, 0, device=dev)
        accumulate = tloop._accumulator(model, mb, False)
        ef = {}
        steps = []
        for b in data:
            acc, loss_sum = accumulate(b)
            mean = {}
            for path, a in acc.items():
                c = a.mul_(1.0 / mb).cpu() + ef.get(path, 0.0)
                deq = tcomp.dequantize_int8(*tcomp.quantize_int8(c))
                ef[path] = c - deq
                mean[path] = deq.to(dev)          # the mean of one pod
            del acc
            mean = _nest(mean)
            gnorm = global_norm(mean)
            _, _, _, m = adamw_update(st.params, mean, st.m, st.v, st.step, oc,
                                      gnorm=gnorm)
            st = tloop.TrainState(st.params, st.m, st.v, st.step + 1, None)
            tloop.load_masters(model, st.params)
            steps.append(dict(loss=float(loss_sum * (1.0 / mb) / 1),
                              grad_norm=float(gnorm), lr=float(m["lr"])))
        return dict(steps=steps, params=_flatten(st.params), m=_flatten(st.m),
                    v=_flatten(st.v), ef={k: v.to(dev) for k, v in ef.items()})

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def timing(mesh) -> dict:
        """The fp32 step on the mesh and without it, both alive, in turns
        (ABBA after one warm-up step each): seconds a step."""
        model, state = tloop.init_state(cfg, 0, device=dev)
        prog = build_cell(spec4, cell, mesh, microbatch_override=mb, oc=oc,
                          model=model)
        state = tloop.shard_state(state, prog.in_shardings[0], mesh)
        rows = prog.in_shardings[1]["tokens"]
        model2, st2 = tloop.init_state(cfg, 0, device=dev)
        plain = tloop.make_train_step(model2, oc, n_microbatches=mb)
        secs: dict[str, list] = {"mesh": [], "plain": []}
        for i, who in enumerate(("mesh", "plain") + DIST_TIMING):
            b = data[i % len(data)]
            if who == "mesh":
                (state, _), sec = sync_time(
                    lambda: prog.fn(state, local_rows(b, rows, mesh)))
            else:
                (st2, _), sec = sync_time(lambda: plain(st2, b))
            if i >= 2:
                secs[who].append(sec)
        return secs

    with tempfile.TemporaryDirectory(prefix="mafia-dist-") as tmp:
        backend = init_group(dev, init_method=f"file://{tmp}/store",
                             world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), dev)
            print(f"  {backend} group of {dist.get_world_size()} rank, mesh "
                  f"{mesh_axes(mesh)} (several ranks cannot share one card "
                  "under NCCL: the tests hold 2 and 4 gloo ranks on the CPU)",
                  flush=True)
            # the plan of qwen2.5-3b's train_4k on this mesh
            full_prog = build_cell(spec, SHAPES["train_4k"], mesh)
            plan = full_prog.plan
            rec["plan"] = dict(
                pf_report=plan.pf_report, notes=plan.notes,
                arg_bytes_per_device=dryrun.args_bytes_per_device(
                    full_prog, mesh_axes(mesh)))
            print(f"  plan of {LM_ARCH} train_4k: pf {plan.pf_report}; notes "
                  f"{plan.notes}; {rec['plan']['arg_bytes_per_device'] / 2**30:.2f}"
                  " GiB of state and batch a device", flush=True)
            del full_prog, plan

            # fp32 reduce against the step without a mesh, then int8_ef
            # against the EF math of one pod on the host
            for pod_reduce, reference, parts in (
                    ("fp32", fp32_reference, ("params", "m", "v")),
                    ("int8_ef", int8_reference, ("params", "m", "v", "ef"))):
                free()
                got = run_mesh(mesh, pod_reduce)
                got.pop("plan")
                free()
                ref = reference()
                n = compare(f"{pod_reduce} on the mesh against "
                            + ("the step without a mesh" if pod_reduce == "fp32"
                               else "the host's EF math"), got, ref, parts)
                rec[pod_reduce] = dict(
                    steps=got["steps"], ref_steps=ref["steps"],
                    peak_gib=got["peak_gib"], leaves=n)
                del got, ref
            free()
            rec["timing"] = timing(mesh)
        finally:
            dist.destroy_process_group()
    free()
    r, secs = rec["fp32"], rec["timing"]
    dist_s = statistics.median(secs["mesh"])
    ref_s = statistics.median(secs["plain"])
    rec.update(mesh_step_s=dist_s, plain_step_s=ref_s,
               overhead=dist_s / ref_s - 1.0)
    print(f"  {cfg.name} x{L} {cfg.act_dtype} (f32 masters) S={DIST_S} "
          f"B={DIST_BATCH} in {mb} microbatches: a step {dist_s:.4f} s on the "
          f"mesh, {ref_s:.4f} s without (medians of {len(secs['mesh'])}, in "
          f"turns: {secs}; {rec['overhead']:+.2%}); peak {r['peak_gib']:.2f} "
          f"GiB (fp32), {rec['int8_ef']['peak_gib']:.2f} GiB (int8_ef)",
          flush=True)

    # the dry-run of every cell on both production meshes, on the host
    t1 = time.perf_counter()
    counts: dict[str, int] = {}
    arg_bytes = []
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            for multi_pod in (False, True):
                cell_rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod)
                counts[cell_rec["status"]] = counts.get(cell_rec["status"], 0) + 1
                if cell_rec["status"] == "ok":
                    arg_bytes.append(cell_rec["arg_bytes_per_device"])
                elif cell_rec["status"] == "error":
                    raise AssertionError(f"dry-run {arch} {shape_name} "
                                         f"multi_pod={multi_pod}: "
                                         f"{cell_rec['error']}")
    rec["dryrun"] = dict(counts=counts, seconds=time.perf_counter() - t1,
                         max_arg_gib=max(arg_bytes) / 2**30)
    print(f"  dry-run: {sum(counts.values())} cells (archs x shapes x 2 "
          f"meshes): {counts}; largest state and batch a device "
          f"{rec['dryrun']['max_arg_gib']:.2f} GiB; "
          f"{rec['dryrun']['seconds']:.2f} s on the host", flush=True)
    return rec, launches


def count_phase(dev) -> dict:
    """Phase count (see the module docstring).  Returns its record; raises
    AssertionError on a failed check."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.roofline import H100
    from repro_torch.launch.steps import abstract_train_state
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    spec = get_arch(LM_ARCH)
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_layers=COUNT_LAYERS))
    cfg = spec.cell_config(ShapeCell("count", "train", COUNT_S, COUNT_BATCH))
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    L, mb = COUNT_LAYERS, COUNT_MB
    saved = dict(LAUNCHES)

    meta_step = tloop.make_train_step(Transformer(cfg, "meta"), oc,
                                      n_microbatches=mb)
    tokens = torch.empty((COUNT_BATCH, COUNT_S), dtype=torch.int32,
                         device="meta")
    t1 = time.perf_counter()
    meta = analyze(meta_step, abstract_train_state(cfg), {"tokens": tokens})
    meta_s = time.perf_counter() - t1

    model, state = tloop.init_state(cfg, 0, device=dev)
    step = tloop.make_train_step(model, oc, n_microbatches=mb)
    gen = torch.Generator(device="cpu").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (COUNT_BATCH, COUNT_S),
                                     generator=gen, dtype=torch.int32).to(dev)}
    step(state, batch)        # warm: one-off work (a route's probe) first
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    card = analyze(step, state, batch)
    torch.cuda.synchronize()
    delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
             if LAUNCHES[k] != before[k]}
    secs = []
    for _ in range(COUNT_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    step_s = statistics.median(secs)
    LAUNCHES.clear()
    LAUNCHES.update(saved)
    del model, state, step
    torch.cuda.empty_cache()

    calls = lambda c: {k: int(v["calls"]) for k, v in c.kernels.items()}
    want = {"flash_attention_wgmma": 2 * L * mb,
            "flash_attention_bwd_wgmma": L * mb}
    row = lambda c, k: c.by_op.get(k, {"calls": 0, "flops": 0.0, "bytes": 0.0})
    differ = {k: (row(meta, k), row(card, k))
              for k in set(meta.by_op) | set(card.by_op)
              if row(meta, k) != row(card, k)}
    for k, (a, b) in sorted(differ.items()):
        print(f"    count: {k}: {a['calls']} calls, {a['flops']:.12g} flops, "
              f"{a['bytes']:.12g} bytes on meta; {b['calls']}, "
              f"{b['flops']:.12g}, {b['bytes']:.12g} on the card")
    bytes_rel = abs(meta.bytes - card.bytes) / card.bytes
    share = card.flops / step_s / H100.peak_flops_bf16
    rec = dict(config=f"{cfg.name} x{L} {cfg.act_dtype}", seq_len=COUNT_S,
               batch=COUNT_BATCH, microbatches=mb, meta_s=meta_s,
               meta=dict(flops=meta.flops, products=meta.products,
                         bytes=meta.bytes, transcendentals=meta.transcendentals,
                         kernels=meta.kernels),
               card=dict(flops=card.flops, products=card.products,
                         bytes=card.bytes,
                         transcendentals=card.transcendentals,
                         kernels=card.kernels),
               launches=delta, bytes_rel=bytes_rel,
               ops_differ={k: list(v) for k, v in differ.items()},
               step_s=step_s, step_secs=secs, tflop=card.flops / 1e12,
               peak_share=share)
    if meta.flops != card.flops or meta.products != card.products:
        raise AssertionError(
            f"count: flops {meta.flops:.6g} (products {meta.products:.6g}) on "
            f"meta, {card.flops:.6g} ({card.products:.6g}) on the card")
    if not calls(meta) == calls(card) == delta == want:
        raise AssertionError(
            f"count: kernel calls {calls(meta)} on meta, {calls(card)} on the "
            f"card; launches {delta}; expected {want}")
    if bytes_rel > COUNT_BYTES_REL:
        raise AssertionError(
            f"count: bytes {meta.bytes:.6g} on meta, {card.bytes:.6g} on the "
            f"card ({bytes_rel:.2%} apart; limit {COUNT_BYTES_REL:.0%})")
    print(f"  count: {rec['config']} S={COUNT_S} B={COUNT_BATCH} in {mb} "
          f"microbatches, one step: {card.flops / 1e12:.4f} TFLOP "
          f"({card.products / 1e12:.4f} in products), {card.bytes / 1e9:.3f} "
          f"GB, on meta in {meta_s:.2f} s and on the card alike (bytes "
          f"{bytes_rel:.3%} apart); kernel calls {calls(card)} = launches; "
          f"the step {step_s:.4f} s (median of {COUNT_REPS}): "
          f"{card.flops / step_s / 1e12:.1f} TFLOP/s, {share:.1%} of "
          f"{H100.peak_flops_bf16 / 1e12:.0f} TFLOP/s", flush=True)
    return rec


def _tp_serve_cfg(arch: str, layers: int):
    """The bfloat16 inference config of ``arch`` (decode_32k's) cut to
    ``layers`` layers, every width kept."""
    from repro_torch.configs.registry import SHAPES, get_arch

    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.cell_config(SHAPES["decode_32k"]),
                              n_layers=layers)
    return dataclasses.replace(spec, model=cfg), cfg


def _tp_prompts(vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(TP_PROMPT_LEN[0], TP_PROMPT_LEN[1] + 1,
                         size=TP_REQUESTS)
    return [rng.integers(1, vocab, size=n).tolist() for n in plens]


def _tp_train_cfg(arch: str = LM_ARCH, layers: int = TP_LAYERS):
    """``arch``'s float32 config cut to ``layers`` layers, every width
    kept, and phase tp's train cell."""
    from repro_torch.configs.registry import ShapeCell, get_arch

    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_layers=layers, act_dtype="float32"))
    cell = ShapeCell("tp", "train", TP_S, TP_BATCH)
    return spec, cell, spec.cell_config(cell)


def _tp_data(vocab: int) -> list[dict]:
    import torch

    from repro_torch.data.tokens import PipelineState, TokenPipeline

    pipe = TokenPipeline(vocab_size=vocab, batch=TP_BATCH, seq_len=TP_S)
    return [{k: torch.as_tensor(v) for k, v in
             pipe.batch_at(PipelineState(step=i))[0].items()}
            for i in range(TP_STEPS)]


def _tp_fwd_tokens(vocab: int):
    import numpy as np

    return np.random.default_rng(3).integers(
        1, vocab, size=(1, TP_FWD_S)).astype(np.int32)


def _tp_bytes(model) -> float:
    return float(sum(p.numel() * p.element_size() for p in model.parameters()))


def _tp_piece_gib(cfg, plan, mesh) -> float:
    """The GiB of the parameters this rank of ``mesh`` holds under
    ``plan``'s specs: each leaf's GSPMD piece (``placement.local_slices``:
    ``ceil(n / m)`` from the first rank on, the last short or empty) in the
    whole model's dtype."""
    from repro_torch.models.transformer import Transformer, _flatten, _leaves
    from repro_torch.sharding.placement import local_slices

    specs = _flatten(plan.param_specs)
    names = mesh.mesh_dim_names
    axes = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    total = 0
    for path, ts in _leaves(Transformer(cfg, "meta")).items():
        spec = tuple(specs[path] or ())
        if path.startswith("blocks/"):
            spec = spec[1:]
        for t in ts:
            sl = local_slices(tuple(t.shape), spec, axes, coord)
            total += math.prod(x.stop - x.start for x in sl) * t.element_size()
    return total / 2**30


def _tp_layout(split) -> str:
    """What a rank's split computes, as a phase prints it."""
    if split is None:
        return "whole over model"
    parts = [f"{k} {getattr(split, k)}" for k in ("heads", "kv", "ffn", "ssm",
                                                  "inner", "experts")
             if getattr(split, k) is not None]
    if split.block is not None:
        b = split.block
        parts.append(f"shared block heads {b.heads}, KV {b.kv}, FFN {b.ffn}")
    return ", ".join(parts) or "vocabulary only"


def _tpm_train_cfg():
    from repro_torch.configs.registry import ShapeCell, get_arch

    arch, layers = TPM_TRAIN
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_layers=layers, act_dtype="float32"))
    cell = ShapeCell("tp-moe", "train", TPM_S, TPM_BATCH)
    return spec, cell, spec.cell_config(cell)


def _tpm_data(vocab: int) -> list[dict]:
    import torch

    from repro_torch.data.tokens import PipelineState, TokenPipeline

    pipe = TokenPipeline(vocab_size=vocab, batch=TPM_BATCH, seq_len=TPM_S)
    return [{k: torch.as_tensor(v) for k, v in
             pipe.batch_at(PipelineState(step=i))[0].items()}
            for i in range(TPM_STEPS)]


def _tpm_fwd_tokens(vocab: int):
    import numpy as np

    return np.random.default_rng(4).integers(
        1, vocab, size=(1, TPM_FWD_S)).astype(np.int32)


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def _cpu_routes(log: list[dict]) -> list[dict]:
    """A ``route_log`` on the host: each layer's choices (the router's and
    those it routed on) and gate gaps."""
    return [dict(top_i=e["top_i"].cpu(), used=e["used"].cpu(),
                 gap=e["gap"].cpu()) for e in log]


def tp_child(rank: int, world: int, tmp: str, jobs, device: str) -> None:
    """One rank of phase tp, a process on the parent's card ``device``:
    joins the gloo group of ``world`` ranks and runs ``jobs``, each writing
    its results under ``tmp``.  Raises on any failure (the parent's spawn
    reports it)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import attention
    from repro_torch.models.transformer import (Transformer, _flatten,
                                                _leaves, init_params)
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.placement import local_rows
    from repro_torch.sharding.planner import plan_for
    from repro_torch.sharding.tp import data_split, gather_from_model, model_split
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    torch.set_num_threads(2)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_group(dev, init_method=f"file://{tmp}/store{world}",
               world_size=world, rank=rank, backend="gloo")
    counted = ("flash_attention", "flash_attention_wgmma",
               "flash_attention_bwd", "flash_attention_bwd_wgmma",
               "decode_attention")

    def sync_time(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def train(shape, arch=LM_ARCH, layers=TP_LAYERS, uneven=False,
              n_steps=TP_STEPS, count=False, fault=False):
        spec, cell, cfg = _tp_train_cfg(arch, layers)
        mesh = make_mesh(shape, ("data", "model"), dev)
        torch.cuda.reset_peak_memory_stats()
        split = build_cell(spec, cell, mesh, allow_uneven=uneven).split(mesh)
        model, state = tloop.init_state(cfg, 0, device=dev, split=split)
        prog = build_cell(spec, cell, mesh, microbatch_override=TP_MB,
                          oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                          model=model, allow_uneven=uneven)
        state = tloop.shard_state(state, prog.in_shardings[0], mesh)
        gc.collect()
        torch.cuda.empty_cache()
        whole = _tp_bytes(Transformer(cfg, "meta"))
        rows = prog.in_shardings[1]["tokens"]
        ref_first = torch.load(os.path.join(tmp, f"tp_ref_first_{arch}_{rank}.pt"))
        for k in counted:
            LAUNCHES[k] = 0
        steps, first_err = [], {}
        real = attention.gather_from_model
        if fault:            # phase tp-uneven's planted fault (TPU_FAULT)
            attention.gather_from_model = (
                lambda x, dim, split, grad_sum=False, of=None: real(
                    x, dim, split, grad_sum=grad_sum and of != "kv", of=of))
        try:
            for i, b in enumerate(_tp_data(cfg.vocab_size)[:n_steps]):
                (state, m), sec = sync_time(
                    lambda: prog.fn(state, local_rows(b, rows, mesh)))
                steps.append(dict(loss=float(m["loss"]),
                                  grad_norm=float(m["grad_norm"]), seconds=sec))
                if i == 0:   # this rank's first moments against the reference's
                    got = _flatten(state.m)
                    for path, want in ref_first.items():
                        w = want.to(dev)
                        first_err[path] = (
                            float((got[path].to_local() - w).abs().max())
                            / max(float(w.abs().max()), 1e-30))
                        del w
        finally:
            attention.gather_from_model = real
        launches = {k: LAUNCHES[k] for k in counted}
        with torch.no_grad():
            logits, _, _ = model.forward_full(_tp_fwd_tokens(cfg.vocab_size))
            logits = gather_from_model(logits, -1, split, of="vocab_out")
        want = torch.load(os.path.join(tmp, f"tp_ref_logits_{arch}.pt")).to(dev)
        logit_err = float((logits - want).abs().max()) / float(want.abs().max())
        out = dict(steps=steps, first_err=first_err, launches=launches,
                   logit_err=logit_err, param_gib=_tp_bytes(model) / 2**30,
                   whole_gib=whole / 2**30, piece_gib=_tp_piece_gib(
                       cfg, prog.plan, mesh),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   partial=sorted(split.partial), layout=_tp_layout(split))
        if count:                     # one more step, counted on the card
            b = local_rows(_tp_data(cfg.vocab_size)[0], rows, mesh)
            for k in counted:
                LAUNCHES[k] = 0
            torch.cuda.synchronize()
            op = analyze(prog.fn, state, b)
            torch.cuda.synchronize()
            out["count"] = dict(flops=op.flops, products=op.products,
                                bytes=op.bytes, calls={
                                    k: int(v["calls"]) for k, v in
                                    op.kernels.items()},
                                launches=_nonzero({k: LAUNCHES[k]
                                                   for k in counted}),
                                by_op=dict(op.by_op))
        del model, state, prog, logits, want, ref_first
        return out

    def serve_model(arch, layers, shape, uneven=False):
        """(cfg, mesh, plan, the rank's model on the plan, its record)."""
        spec, cfg = _tp_serve_cfg(arch, layers)
        mesh = make_mesh(shape, ("data", "model"), dev)
        torch.cuda.reset_peak_memory_stats()
        plan = plan_for(spec, mesh, mode="decode",
                        cell=ShapeCell("tp", "decode", TP_MAX_LEN, TP_MAX_BATCH),
                        cache_batch=TP_MAX_BATCH, cache_len=TP_MAX_LEN,
                        allow_uneven=uneven)
        split = model_split(cfg, plan.param_specs, mesh, plan.cache_specs)
        data = data_split(cfg, plan, mesh)
        model = init_params(cfg, 0, dev, split, data)
        model.forward_full(np.arange(1, 9, dtype=np.int32)[None, :])  # warm up
        shard = Transformer(cfg, "meta", split)      # a (1, m) rank's model
        over = data.fsdp if data is not None else {}
        rec = dict(cache=None if split is None else split.cache,
                   heads=None if split is None else split.heads,
                   layout=_tp_layout(split), fsdp=len(over),
                   data_ranks=1 if data is None else data.f,
                   param_gib=_tp_bytes(model) / 2**30,
                   piece_gib=_tp_piece_gib(cfg, plan, mesh),
                   shard_gib=_tp_bytes(shard) / 2**30,
                   fsdp_gib=sum(t.numel() * t.element_size() for path, ts in
                                _leaves(shard).items() if path in over
                                for t in ts) / 2**30,
                   whole_gib=_tp_bytes(Transformer(cfg, "meta")) / 2**30)
        return cfg, mesh, plan, model, rec

    def run_engine(cfg, model, mesh, plan) -> dict:
        eng = ServeEngine(cfg, model, max_batch=TP_MAX_BATCH,
                          max_len=TP_MAX_LEN, mesh=mesh, plan=plan, device=dev)
        for p in _tp_prompts(cfg.vocab_size):
            eng.submit(p, max_new_tokens=TP_NEW_TOKENS)
        torch.cuda.synchronize()
        for k in counted:
            LAUNCHES[k] = 0
        done, sec = sync_time(eng.run_to_completion)
        out = dict(tokens=[(r.rid, r.prompt, r.tokens, r.slot) for r in done],
                   launches={k: LAUNCHES[k] for k in counted},
                   steps=eng.metrics.snapshot()["batches"], seconds=sec,
                   rows=eng.rows,
                   cache_rows={k: c.shape[1] for k, c in eng.caches.items()})
        del eng
        return out

    def serve(arch, layers, shape, uneven=False):
        cfg, mesh, plan, model, out = serve_model(arch, layers, shape, uneven)
        split = model.split
        out.update(run_engine(cfg, model, mesh, plan), kv=split and split.kv,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   sharded_wk=split is not None and split.sharded(
                       "blocks/attn/wk"))
        del model
        return out

    def moe_train(shape, uneven=False, n_steps=TPM_STEPS):
        spec, cell, cfg = _tpm_train_cfg()
        mesh = make_mesh(shape, ("data", "model"), dev)
        torch.cuda.reset_peak_memory_stats()
        split = build_cell(spec, cell, mesh, allow_uneven=uneven).split(mesh)
        model, state = tloop.init_state(cfg, 0, device=dev, split=split)
        prog = build_cell(spec, cell, mesh, microbatch_override=TPM_MB,
                          oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                          model=model, allow_uneven=uneven)
        state = tloop.shard_state(state, prog.in_shardings[0], mesh)
        gc.collect()
        torch.cuda.empty_cache()
        whole = _tp_bytes(Transformer(cfg, "meta"))
        rows = prog.in_shardings[1]["tokens"]
        for k in counted:
            LAUNCHES[k] = 0
        run, routes = [], []
        for i, b in enumerate(_tpm_data(cfg.vocab_size)[:n_steps]):
            with route_log() as log:      # every step: the reference routes alike
                (state, m), sec = sync_time(
                    lambda: prog.fn(state, local_rows(b, rows, mesh)))
            routes.append(_cpu_routes(log))
            run.append(dict(loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]), seconds=sec))
            if i == 0:       # this rank's first moments, for the parent to hold
                torch.save({path: t.to_local().cpu()
                            for path, t in _flatten(state.m).items()},
                           os.path.join(tmp, f"tpm_first_{rank}.pt"))
            del log
        launches = {k: LAUNCHES[k] for k in counted}
        with torch.no_grad(), route_log() as log:
            logits, _, _ = model.forward_full(_tpm_fwd_tokens(cfg.vocab_size))
            if split.vocab_out is not None:
                logits = gather_from_model(logits, -1, split, of="vocab_out")
        out = dict(steps=run, launches=launches,
                   logits=logits.cpu(), routes=routes,
                   fwd_routes=_cpu_routes(log), param_gib=_tp_bytes(model) / 2**30,
                   whole_gib=whole / 2**30, piece_gib=_tp_piece_gib(
                       cfg, prog.plan, mesh),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   partial=sorted(split.partial), experts=split.experts,
                   heads=split.heads)
        del model, state, prog, logits
        return out

    def moe_serve(arch, layers, shape, uneven=False):
        cfg, mesh, plan, model, out = serve_model(arch, layers, shape, uneven)
        split = model.split
        out.update(experts=split and split.experts, shared=split and split.shared)
        for key, run_cfg in (("served", cfg), ("nodrop", nodrop(cfg))):
            model.cfg = run_cfg
            with route_log(key == "nodrop") as log:
                out[key] = run_engine(run_cfg, model, mesh, plan)
            routes = (engine_routes(log, [types.SimpleNamespace(
                rid=rid, prompt=p, tokens=t, slot=sl)
                for rid, p, t, sl in out[key]["tokens"]], layers,
                out[key]["rows"]) if key == "nodrop" else None)
            out[key]["routes"] = None if routes is None else {
                rid: [t.cpu() for t in ts] for rid, ts in routes.items()}
            del log
        model.cfg = cfg
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del model
        return out

    try:
        for name, *args in jobs:
            with offset_calls() as offsets:
                res = {"train": train, "serve": serve, "moe_train": moe_train,
                       "moe_serve": moe_serve}[name](*args)
            res["offset_calls"] = dict(offsets)
            torch.save(res, os.path.join(tmp, f"tp_{name}_{'_'.join(map(str, args))}"
                                              f"_{rank}.pt"))
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()


def tp_train_ref(dev, tmp: str, arch: str, layers: int, m: int = 2,
                 uneven: bool = False, n_steps: int = TP_STEPS) -> list[dict]:
    """The one-process float32 train step of ``_tp_train_cfg(arch,
    layers)`` from seed 0: a ``TP_FWD_S``-token forward's logits
    (``tp_ref_logits_<arch>.pt``), ``n_steps`` steps and, for each rank of
    (data 1, model ``m``), its slices of the first moments under the
    plan's split (``allow_uneven`` with ``uneven``;
    ``tp_ref_first_<arch>_<rank>.pt``), all under ``tmp``.  Returns the
    steps: loss, grad norm, seconds."""
    import gc

    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten
    from repro_torch.sharding.spec import MeshShape
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    spec, cell, cfg = _tp_train_cfg(arch, layers)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model, st = tloop.init_state(cfg, 0, device=dev)
    with torch.no_grad():
        logits, _, _ = model.forward_full(_tp_fwd_tokens(cfg.vocab_size))
    torch.save(logits.cpu(), os.path.join(tmp, f"tp_ref_logits_{arch}.pt"))
    del logits
    step = tloop.make_train_step(model, oc, n_microbatches=TP_MB)
    prog = build_cell(spec, cell, MeshShape((1, m), ("data", "model")),
                      allow_uneven=uneven)
    ref_steps = []
    for i, b in enumerate(_tp_data(cfg.vocab_size)[:n_steps]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, mt = step(st, b)
        torch.cuda.synchronize()
        ref_steps.append(dict(loss=float(mt["loss"]),
                              grad_norm=float(mt["grad_norm"]),
                              seconds=time.perf_counter() - t1))
        if i == 0:           # each rank's slice of the first moments
            tp_save_first(tmp, arch, cfg, prog.plan, _flatten(st.m), m)
    del model, st, step
    gc.collect()
    torch.cuda.empty_cache()
    return ref_steps


def tp_save_first(tmp: str, arch: str, cfg, plan, m1: dict,
                  m: int = 2) -> None:
    """Each (data 1, model ``m``) rank's slices under ``plan``'s split of
    the whole first moments ``m1`` (leaf path → tensor, ``blocks/``
    stacked), as ``tp_ref_first_<arch>_<rank>.pt`` under ``tmp``: what the
    ranks' ``train`` jobs hold their own against."""
    import torch

    from repro_torch.sharding.tp import plan_split

    for r in range(m):
        sp = plan_split(cfg, plan.param_specs, m, r)
        part = {}
        for path, x in m1.items():
            if sp is None:                  # nothing split: the whole leaf
                part[path] = x.cpu()
                continue
            if path.startswith("blocks/"):
                sl = (slice(None),) + sp.local_slices(path, tuple(x.shape[1:]))
            else:
                sl = sp.local_slices(path, tuple(x.shape))
            part[path] = x[sl].cpu()
        torch.save(part, os.path.join(tmp, f"tp_ref_first_{arch}_{r}.pt"))
        del part


def tp_train_reading(got: dict, ref_steps: list[dict]) -> dict:
    """How far a rank's train run (``tp_child``'s ``train``) lies from the
    one-process steps: the largest relative error of the losses and of the
    grad norms, the leaf whose first moments lie furthest off relative to
    their largest (path, error), and the forward logits' error."""
    rel = lambda a, b: abs(a - b) / abs(b)      # noqa: E731
    pairs = list(zip(got["steps"], ref_steps, strict=True))
    first = max(got["first_err"].items(), key=lambda kv: kv[1])
    return dict(loss=max(rel(a["loss"], b["loss"]) for a, b in pairs),
                grad_norm=max(rel(a["grad_norm"], b["grad_norm"])
                              for a, b in pairs),
                first=first, logits=got["logit_err"])


def tp_train_hold(label: str, ranks: list[dict], ref_steps: list[dict],
                  want: dict, launches: dict,
                  first_rel: float = TP_FIRST_REL) -> list[dict]:
    """Hold each rank's train run (``tp_child``'s ``train``) to phase tp's
    limits against the one-process steps (the first moments to
    ``first_rel``) and its launches to ``want``.  Print each, add the
    launches to ``launches``, return the runs.  Raises AssertionError on a
    failed check."""
    for r, got in enumerate(ranks):
        for a, b in zip(got["steps"], ref_steps, strict=True):
            if not (math.isclose(a["loss"], b["loss"], rel_tol=TP_LOSS_RTOL)
                    and math.isclose(a["grad_norm"], b["grad_norm"],
                                     rel_tol=TP_GNORM_RTOL)):
                raise AssertionError(f"tp {label} rank {r}: steps "
                                     f"{got['steps']} against {ref_steps}")
        worst = tp_train_reading(got, ref_steps)["first"]
        print(f"  {label} rank {r} (data 1, model {len(ranks)}; "
              f"{got['layout']}): losses "
              f"{[s['loss'] for s in got['steps']]} against "
              f"{[s['loss'] for s in ref_steps]}, grad norms "
              f"{[s['grad_norm'] for s in got['steps']]} against "
              f"{[s['grad_norm'] for s in ref_steps]}; first moments: largest "
              f"relative error {worst[1]:.3g} ({worst[0]}; limit {first_rel}"
              f"); forward logits {got['logit_err']:.3g} of the largest "
              f"(limit {TP_LOGIT_REL}); launches {_nonzero(got['launches'])} (expected "
              f"{want}); parameters {got['param_gib']:.3f} of "
              f"{got['whole_gib']:.3f} GiB (its GSPMD piece "
              f"{got['piece_gib']:.3f}), peak {got['peak_gib']:.2f} GiB; "
              f"step seconds {[round(s['seconds'], 4) for s in got['steps']]}"
              f"; partial leaves {got['partial']}", flush=True)
        if worst[1] > first_rel or got["logit_err"] > TP_LOGIT_REL:
            raise AssertionError(f"tp {label} rank {r}: first moments {worst}, "
                                 f"logits {got['logit_err']}")
        if any(got["launches"][k] != want.get(k, 0) for k in got["launches"]):
            raise AssertionError(f"tp {label} rank {r}: launches "
                                 f"{got['launches']}, expected {want}")
        for k, n in got["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return ranks


def tp_serve_hold(ranks: list[dict], arch: str, layers: int, m: int, rmodel,
                  ref_done: list, launches: dict, shape=None) -> dict:
    """Hold a served run on a plan (``tp_child``'s ``serve``, one record a
    rank; on the mesh (data, model) = ``shape``, (1, m) where None): every
    rank the same tokens, teacher-forced agreement with the one-process
    model ``rmodel`` >= ``LM_BF16_AGREE`` (for ``LM_BF16_TIES`` below it
    only where every disagreement is a rounding tie), each rank's launches
    = attention applications x prefills (flash; every rank prefills every
    request) and x decode steps; print it, add the launches to
    ``launches``, return its record.  Raises AssertionError on a failed
    check."""
    shape = shape or (1, m)
    scfg = rmodel.cfg
    toks = ranks[0]["tokens"]
    if any(x["tokens"] != toks for x in ranks):
        raise AssertionError(f"tp serve {arch} {shape}: ranks differ")
    done = [types.SimpleNamespace(rid=rid, prompt=p, tokens=t)
            for rid, p, t, _ in toks]
    n, worse, _, _, _ = teacher_forced(rmodel, done, scfg.vocab_size, False)
    agree = 1 - len(worse) / n
    ties = sum(w["served_gap"] <= w["tie"] for w in worse)
    same = sum(a == b for (_, _, ta, _), (_, _, tb) in zip(toks, ref_done)
               for a, b in zip(ta, tb)) / n
    x = ranks[0]
    apps = attention_layers(scfg)
    want = {"flash_attention_wgmma": apps * TP_REQUESTS,
            "decode_attention": apps * x["steps"]}
    case = dict(arch=arch, layers=layers, model=m, mesh=shape,
                cache=x["cache"], layout=x["layout"],
                sharded_wk=x["sharded_wk"], agreement=agree,
                disagreements=len(worse), rounding_ties=ties,
                same_as_one_process=same, positions=n,
                launches=[y["launches"] for y in ranks],
                param_gib=[y["param_gib"] for y in ranks],
                shard_gib=x["shard_gib"], whole_gib=x["whole_gib"],
                fsdp=x["fsdp"], cache_rows=[y["cache_rows"] for y in ranks],
                peak_gib=[y["peak_gib"] for y in ranks],
                seconds=x["seconds"], steps=x["steps"])
    print(f"  serve {arch} x{layers} bf16 at (data, model) {shape}: cache "
          f"over {x['cache']}, rows {x['rows']} (rank 0: {x['layout']}); {n} "
          f"tokens, teacher-forced "
          f"agreement {agree:.4f} (limit {LM_BF16_AGREE}; {len(worse)} "
          f"disagreements, {ties} of them rounding ties), equal to the "
          f"one-process engine's {same:.4f}; launches a rank "
          f"{_nonzero(x['launches'])} (expected {want}); parameters a rank "
          f"{[round(g, 3) for g in case['param_gib']]} of {x['whole_gib']:.3f} "
          f"GiB, peak {[round(p, 2) for p in case['peak_gib']]} GiB; "
          f"{x['seconds']:.2f} s for {x['steps']} decode steps (ranks "
          "time-share the card)", flush=True)
    if agree < LM_BF16_AGREE and (arch not in LM_BF16_TIES or ties < len(worse)):
        raise AssertionError(f"tp serve {arch} {shape}: agreement {agree}"
                             f" ({ties} of {len(worse)} disagreements rounding "
                             f"ties): {worse[:4]}")
    for y in ranks:
        if any(y["launches"][k] != want.get(k, 0) for k in y["launches"]):
            raise AssertionError(f"tp serve {arch} {shape}: launches "
                                 f"{y['launches']}, expected {want}")
        for k, c in y["launches"].items():
            launches[k] = launches.get(k, 0) + c
    return case


def tp_phase(dev, tmp: str) -> tuple[dict, dict]:
    """Phase tp (see the module docstring): the decode kernel's
    log-sum-exp against its plain version, the one-process references,
    then the ranks as processes on this card.  Returns (record, launches
    summed over the ranks' main-path runs); raises AssertionError on a
    failed check."""
    import gc

    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    rec: dict = {"lse_cases": []}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # 1. the decode kernel's log-sum-exp output against its plain version, at
    # the local pieces qwen2.5-3b's model-4 engine decodes (B 8, 128 of 512
    # slots a rank, lengths 0 included) and a split cache of 2,048 slots; its
    # output float32 (what gqa_decode merges on a cache over the sequence,
    # rounding once after the merge)
    g = torch.Generator(device=dev).manual_seed(11)
    for dt in (torch.bfloat16, torch.float32):
        for B, S, lens in ((TP_MAX_BATCH, TP_MAX_LEN // 4,
                             [0, 1, 3 * TP_MAX_LEN // 20, TP_MAX_LEN // 4, 0,
                              TP_MAX_LEN // 8, TP_MAX_LEN // 4 - 1, 0]),
                           (8, 2048, [0, 1, 33, 700, 1024, 1500, 2047, 2048])):
            q = torch.randn((B, 16, 128), generator=g, device=dev).to(dt)
            k = torch.randn((B, S, 2, 128), generator=g, device=dev).to(dt)
            v = torch.randn((B, S, 2, 128), generator=g, device=dev).to(dt)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            out, lse = decode_attention(q, k, v, ln, round_p=False,
                                        return_lse=True)
            out2, lse2 = decode_attention(q, k, v, ln, round_p=False,
                                          return_lse=True)
            w_out, w_lse = decode_attention_ref(q, k, v, ln, return_lse=True)
            torch.cuda.synchronize()
            ok, err, lim = attn_compare(out, w_out)
            empty = w_lse == -torch.inf
            lse_ok = bool(torch.equal(lse == -torch.inf, empty))
            fin = ~empty
            lse_err = float(((lse - w_lse)[fin].abs()
                             / torch.clamp_min(w_lse[fin].abs(), 1.0)).max())
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
            case = dict(dtype=str(dt).split(".")[-1], B=B, S=S,
                        lens=lens, max_abs_err=err, limit=lim,
                        lse_rel_err=lse_err, bitwise_repeat=same)
            rec["lse_cases"].append(case)
            print(f"  decode lse {case['dtype']} output "
                  f"{str(out.dtype).split('.')[-1]} B={B} S={S} lens {lens}: out "
                  f"err {err:.3g} (limit {lim:.3g}), lse rel err "
                  f"{lse_err:.3g} (limit {TP_LSE_TOL}), -inf where no keys "
                  f"{lse_ok}, two calls bitwise {same}", flush=True)
            if not (ok and lse_ok and lse_err <= TP_LSE_TOL and same):
                raise AssertionError(f"decode lse case {case}")
    del q, k, v, out, lse, out2, lse2, w_out, w_lse
    free()

    # 2. the one-process references: the float32 train step, then the bf16
    # engines (kept for the teacher-forced checks)
    ref_steps = tp_train_ref(dev, tmp, LM_ARCH, TP_LAYERS)
    rec["train_ref"] = ref_steps
    free()
    ref_models = {(arch, layers): tp_serve_ref(dev, arch, layers)
                  for arch, layers in dict.fromkeys((a, n) for a, n, _ in
                                                    TP_SERVE)}
    free()

    # 3. the ranks: 2 processes (training at model 2, serving at model 2),
    # then 4 (serving at model 4)
    t1 = time.perf_counter()
    jobs2 = [("train", (1, 2))] + [("serve", a, n, (1, m))
                                   for a, n, m in TP_SERVE if m == 2]
    jobs4 = [("serve", a, n, (1, m)) for a, n, m in TP_SERVE if m == 4]
    for world, jobs in ((2, jobs2), (4, jobs4)):
        try:
            mp.spawn(tp_child, args=(world, tmp, jobs, str(dev)), nprocs=world,
                     join=True)
        except Exception as e:        # a rank's traceback, as the check's failure
            raise AssertionError(f"phase tp ranks ({world}): {e}") from None
    rec["ranks_s"] = time.perf_counter() - t1
    load = lambda name, args, r: torch.load(os.path.join(
        tmp, f"tp_{name}_{'_'.join(map(str, args))}_{r}.pt"), weights_only=False)
    launches: dict[str, int] = {}

    # training: every rank within the limits of the one-process step
    L, mb = TP_LAYERS, TP_MB
    want_train = {"flash_attention": 2 * L * mb * TP_STEPS,
                  "flash_attention_bwd_wgmma": L * mb * TP_STEPS}
    rec["train"] = tp_train_hold(
        "train", [load("train", [(1, 2)], r) for r in range(2)], ref_steps,
        want_train, launches)
    # the last step (the first warms every kernel and library up)
    rec["step_s"] = rec["train"][0]["steps"][-1]["seconds"]
    rec["ref_step_s"] = ref_steps[-1]["seconds"]
    print(f"  train: step {TP_STEPS} took {rec['step_s']:.4f} s on 2 ranks "
          f"sharing this card ({card_line()}; the two processes time-share "
          f"one card: a rehearsal of correctness, not a scaling figure), "
          f"{rec['ref_step_s']:.4f} s in one process", flush=True)

    # serving: every rank the same tokens, each within phase 7's bf16 rule
    # against the one-process model's teacher forcing
    rec["serve"] = []
    for arch, layers, m in TP_SERVE:
        rmodel, ref_done = ref_models[arch, layers]
        rec["serve"].append(tp_serve_hold(
            [load("serve", [arch, layers, (1, m)], r) for r in range(m)], arch,
            layers, m, rmodel, ref_done, launches))
    del ref_models
    free()
    return rec, launches


def tpm_phase(dev, tmp: str) -> tuple[dict, dict]:
    """Phase tp-moe (see the module docstring): the ranks as processes on
    this card (2, then 4), the one-process training reference on the
    ranks' routes, then the serving references one model at a time.  Returns (record, launches
    summed over the ranks' main-path runs); raises AssertionError on a
    failed check."""
    import gc

    import torch
    import torch.multiprocessing as mp

    rec: dict = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # 1. the ranks: 2 processes (training and serving at model 2), then 4
    t1 = time.perf_counter()
    jobs2 = [("moe_train", (1, 2))] + [("moe_serve", a, n, (1, m))
                                       for a, n, m in TPM_SERVE if m == 2]
    jobs4 = [("moe_serve", a, n, (1, m)) for a, n, m in TPM_SERVE if m == 4]
    for world, jobs in ((2, jobs2), (4, jobs4)):
        try:
            mp.spawn(tp_child, args=(world, tmp, jobs, str(dev)), nprocs=world,
                     join=True)
        except Exception as e:        # a rank's traceback, as the check's failure
            raise AssertionError(f"phase tp-moe ranks ({world}): {e}") from None
    rec["ranks_s"] = time.perf_counter() - t1
    load = lambda name, args, r: torch.load(os.path.join(
        tmp, f"tp_{name}_{'_'.join(map(str, args))}_{r}.pt"), weights_only=False)
    launches: dict[str, int] = {}

    # 2. the one-process training reference, routed on the ranks' choices,
    # and every rank held to it
    rec.update(tpm_train_hold(dev, tmp, [load("moe_train", [(1, 2)], r)
                                         for r in range(2)], launches))
    free()

    # serving: the one-process model of each arch built after the ranks
    # ran, its engine's tokens at the served capacity, then the no-drop
    # copy's teacher forcing of the ranks' no-drop tokens
    rec["serve"] = []
    for arch in dict.fromkeys(a for a, _, _ in TPM_SERVE):
        cases = [(a, n, m) for a, n, m in TPM_SERVE if a == arch]
        rmodel, ref_done = tpm_serve_ref(dev, arch, cases[0][1])
        for a, layers, m in cases:
            rec["serve"].append(tpm_serve_hold(
                [load("moe_serve", [a, layers, (1, m)], r) for r in range(m)],
                a, layers, (1, m), rmodel, ref_done, launches))
        del rmodel
        free()
    return rec, launches


def tpm_train_hold(dev, tmp: str, got: list[dict], launches: dict,
                   uneven: bool = False, n_steps: int = TPM_STEPS,
                   first_rel: float = TP_FIRST_REL) -> dict:
    """Hold the ranks' MoE train runs (``tp_child``'s ``moe_train``, one
    record a rank, at (data 1, model ``len(got)``), the plan
    ``allow_uneven`` with ``uneven``) to phase tp's limits (the first
    moments to ``first_rel``) against the one-process step and forward run
    after them on the ranks' routes; add
    their launches to ``launches``; return the record (``train_ref``,
    ``train``, ``step_s``, ``ref_step_s``).  Raises AssertionError on a
    failed check."""
    import gc

    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import _flatten
    from repro_torch.sharding.spec import MeshShape
    from repro_torch.sharding.tp import plan_split
    from repro_torch.train import train_loop as tloop
    from repro_torch.train.optim import OptConfig

    rec: dict = {}
    # the one-process training reference, routed on the ranks' choices:
    # a split reorders the attention's fp32 sums, so a router at a
    # near-tie may choose another expert; forced onto the ranks' choices
    # (each layer gated by its own router) the two runs compute one
    # function, held at the limits, and each choice the reference's router
    # would have made otherwise must be a near-tie (reported)
    spec, cell, cfg = _tpm_train_cfg()
    m = len(got)
    for r in range(1, m):
        for i, (a, b) in enumerate(zip(got[r]["routes"] + [got[r]["fwd_routes"]],
                                       got[0]["routes"] + [got[0]["fwd_routes"]])):
            f = route_flips(a, b, "used")
            if f is not None or len(a) != len(b):
                raise AssertionError(f"tpm train: rank {r} routed otherwise "
                                     f"than rank 0 (run {i}): {f}")
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model, st = tloop.init_state(cfg, 0, device=dev)
    with torch.no_grad(), route_log(force=[e["used"] for e in
                                           got[0]["fwd_routes"]]) as log:
        logits, _, _ = model.forward_full(_tpm_fwd_tokens(cfg.vocab_size))
    ref_logits, fwd_flips = logits.cpu(), route_flips(log, log, "top_i", "used")
    del logits, log
    step = tloop.make_train_step(model, oc, n_microbatches=TPM_MB)
    prog = build_cell(spec, cell, MeshShape((1, m), ("data", "model")),
                      allow_uneven=uneven)
    ref_steps, flips, first_err = [], [], [{} for _ in range(m)]
    for i, b in enumerate(_tpm_data(cfg.vocab_size)[:n_steps]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with route_log(force=[e["used"] for e in got[0]["routes"][i]]) as log:
            st, mt = step(st, b)
        torch.cuda.synchronize()
        ref_steps.append(dict(loss=float(mt["loss"]),
                              grad_norm=float(mt["grad_norm"]),
                              seconds=time.perf_counter() - t1))
        flips.append(route_flips(log, log, "top_i", "used"))
        del log
        if i == 0:       # each rank's first moments against its slices
            m1 = _flatten(st.m)
            for r in range(m):
                sp = plan_split(cfg, prog.plan.param_specs, m, r)
                part = torch.load(os.path.join(tmp, f"tpm_first_{r}.pt"))
                for path, x in m1.items():
                    if path.startswith("blocks/"):
                        sl = (slice(None),) + sp.local_slices(
                            path, tuple(x.shape[1:]))
                    else:
                        sl = sp.local_slices(path, tuple(x.shape))
                    want, have = x[sl], part.pop(path).to(dev)
                    first_err[r][path] = (float((have - want).abs().max())
                                          / max(float(want.abs().max()), 1e-30))
                    del want, have
                if part:
                    raise AssertionError(f"tpm train rank {r}: first moments "
                                         f"of leaves the reference lacks: "
                                         f"{sorted(part)}")
                del part
            del m1
    rec["train_ref"] = ref_steps
    del model, st, step
    gc.collect()
    torch.cuda.empty_cache()

    # training: every rank within the limits, on every run
    L, mb = cfg.n_layers, TPM_MB
    want_train = {"flash_attention": 2 * L * mb * n_steps,
                  "flash_attention_bwd_wgmma": L * mb * n_steps}
    rec["train"] = []
    for r in range(m):
        g = got[r]
        err = float((g["logits"] - ref_logits).abs().max())
        logit_err = err / float(ref_logits.abs().max())
        worst = max(first_err[r].items(), key=lambda kv: kv[1])
        rec["train"].append(dict(
            {k: v for k, v in g.items() if k not in ("logits", "routes",
                                                     "fwd_routes")},
            first_err=first_err[r], flips=flips, fwd_flips=fwd_flips,
            logit_err=logit_err))
        print(f"  moe train rank {r} (data 1, model {m}; experts {g['experts']}"
              f", heads {g['heads']}): losses "
              f"{[s['loss'] for s in g['steps']]} against "
              f"{[s['loss'] for s in ref_steps]}, grad norms "
              f"{[s['grad_norm'] for s in g['steps']]} against "
              f"{[s['grad_norm'] for s in ref_steps]} (one process routed on "
              f"the ranks' choices; its router's own choices differ at {flips} "
              f"by step, {fwd_flips} in the forward); first moments: largest "
              f"relative error {worst[1]:.3g} ({worst[0]}; limit {first_rel}); "
              f"forward logits {logit_err:.3g} of the largest over "
              f"{TPM_FWD_S} positions (limit {TP_LOGIT_REL}); launches "
              f"{_nonzero(g['launches'])} (expected {want_train}); parameters "
              f"{g['param_gib']:.3f} of {g['whole_gib']:.3f} GiB (its GSPMD "
              f"piece {g['piece_gib']:.3f}), peak "
              f"{g['peak_gib']:.2f} GiB; partial leaves {g['partial']}",
              flush=True)
        for f in flips + [fwd_flips]:
            if f is not None and not max(f["gaps"]) < ROUTE_TIE:
                raise AssertionError(f"tpm train rank {r}: routes differ beyond "
                                     f"a near-tie: {f}")
        for a, b in zip(g["steps"], ref_steps):
            if not (math.isclose(a["loss"], b["loss"], rel_tol=TP_LOSS_RTOL)
                    and math.isclose(a["grad_norm"], b["grad_norm"],
                                     rel_tol=TP_GNORM_RTOL)):
                raise AssertionError(f"tpm train rank {r}: steps "
                                     f"{g['steps']} against {ref_steps}")
        if worst[1] > first_rel:
            raise AssertionError(f"tpm train rank {r}: first moments {worst}")
        if logit_err > TP_LOGIT_REL:
            raise AssertionError(f"tpm train rank {r}: logits {logit_err}")
        if any(g["launches"][k] != want_train.get(k, 0)
               for k in g["launches"]):
            raise AssertionError(f"tpm train rank {r}: launches "
                                 f"{g['launches']}, expected {want_train}")
        for k, n in g["launches"].items():
            launches[k] = launches.get(k, 0) + n
    del got
    rec["step_s"] = rec["train"][0]["steps"][-1]["seconds"]
    rec["ref_step_s"] = ref_steps[-1]["seconds"]
    print(f"  moe train: step {n_steps} took {rec['step_s']:.4f} s on {m} ranks "
          f"sharing this card ({card_line()}; a rehearsal of correctness, not "
          f"a scaling figure; both runs log their routes), "
          f"{rec['ref_step_s']:.4f} s in one process", flush=True)

    return rec


def tp_serve_ref(dev, arch: str, layers: int):
    """The one-process bf16 model of ``_tp_serve_cfg(arch, layers)`` from
    seed 0 and its engine's tokens (phase tp's traffic): (model, [(rid,
    prompt, tokens)])."""
    import numpy as np

    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    _, scfg = _tp_serve_cfg(arch, layers)
    rmodel = init_params(scfg, 0, dev)
    rmodel.forward_full(np.arange(1, 9, dtype=np.int32)[None, :])
    eng = ServeEngine(scfg, rmodel, max_batch=TP_MAX_BATCH,
                      max_len=TP_MAX_LEN, device=dev)
    for p in _tp_prompts(scfg.vocab_size):
        eng.submit(p, max_new_tokens=TP_NEW_TOKENS)
    return rmodel, [(r.rid, r.prompt, r.tokens) for r in eng.run_to_completion()]


def tpm_serve_ref(dev, arch: str, layers: int):
    """:func:`tp_serve_ref` of a MoE arch (its tokens at the served
    capacity), the model returned as the no-drop copy (``nodrop``), for the
    teacher forcing of the ranks' no-drop runs."""
    rmodel, ref_done = tp_serve_ref(dev, arch, layers)
    rmodel.cfg = nodrop(rmodel.cfg)
    return rmodel, ref_done


def tpm_serve_hold(ranks: list[dict], a: str, layers: int, shape, rmodel,
                   ref_done: list, launches: dict) -> dict:
    """Hold a MoE run on a plan (``tp_child``'s ``moe_serve``, one record a
    rank, on the mesh (data, model) = ``shape``): every rank the same
    tokens at the served capacity and on the no-drop copy, the no-drop
    copy's teacher-forced agreement with ``rmodel`` (the one-process
    no-drop model) >= ``LM_BF16_AGREE`` over the positions routed alike
    (each request's routes from the rank that decoded its slot), each
    rank's launches = layers x prefills (flash; every rank prefills every
    request) and x decode steps (0 under MLA); print it, add the launches
    to ``launches``, return its record.  Raises AssertionError on a failed
    check."""
    dev = rmodel.device
    scfg = rmodel.cfg
    x = ranks[0]
    m = shape[1]
    for key in ("served", "nodrop"):
        if any(y[key]["tokens"] != x[key]["tokens"] for y in ranks):
            raise AssertionError(f"tpm serve {a} {shape} {key}: ranks differ")
    toks = x["served"]["tokens"]
    n_tok = sum(len(t) for _, _, t, _ in toks)
    same = sum(ta == tb for (_, _, t1, _), (_, _, t2) in zip(toks, ref_done)
               for ta, tb in zip(t1, t2)) / n_tok
    done = [types.SimpleNamespace(rid=rid, prompt=p, tokens=t, slot=sl)
            for rid, p, t, sl in x["nodrop"]["tokens"]]
    routes = {}
    for y in ranks:                  # each request from its slot's data rank
        routes.update({rid: [t.to(dev) for t in ts]
                       for rid, ts in y["nodrop"]["routes"].items()})
    n, worse, _, _, n_alike = teacher_forced(rmodel, done, scfg.vocab_size,
                                             False, routes)
    miss = sum(1 for w in worse if w["routed_alike"])
    agree = 1 - miss / n_alike
    case = dict(arch=a, layers=layers, model=m, mesh=shape, cache=x["cache"],
                heads=x["heads"], experts=x["experts"], shared=x["shared"],
                same_as_one_process=same, positions=n, routed_alike=n_alike,
                agreement_routed_alike=agree, disagreements=len(worse),
                param_gib=[y["param_gib"] for y in ranks],
                shard_gib=x["shard_gib"], whole_gib=x["whole_gib"],
                fsdp=x["fsdp"], cache_rows=[y["served"]["cache_rows"]
                                            for y in ranks],
                peak_gib=[y["peak_gib"] for y in ranks],
                launches={k: [y[k]["launches"] for y in ranks]
                          for k in ("served", "nodrop")},
                seconds={k: x[k]["seconds"] for k in ("served", "nodrop")},
                steps={k: x[k]["steps"] for k in ("served", "nodrop")})
    print(f"  moe serve {a} x{layers} bf16 at (data, model) {shape}: experts "
          f"{x['experts']} of rank 0, heads {x['heads']}, shared columns "
          f"{x['shared']}, cache over {x['cache']}, rows {x['served']['rows']} "
          f"of rank 0, {x['fsdp']} leaves over data (FSDP); at the served "
          f"capacity every rank the same tokens, {same:.4f} of them the "
          f"one-process engine's; no-drop copy: {n_alike}/{n} positions "
          f"routed alike, teacher-forced agreement {agree:.4f} over them "
          f"(limit {LM_BF16_AGREE}; {len(worse)} disagreements in all); "
          f"launches a rank: served {_nonzero(case['launches']['served'][0])}, "
          f"no-drop {_nonzero(case['launches']['nodrop'][0])}; parameters a "
          f"rank {[round(g, 3) for g in case['param_gib']]} of "
          f"{x['whole_gib']:.3f} GiB ({x['shard_gib']:.3f} a model rank's "
          f"shard), peak {[round(g, 2) for g in case['peak_gib']]} GiB; "
          f"{x['served']['seconds']:.2f} s for {x['served']['steps']} decode "
          "steps (ranks time-share the card)", flush=True)
    if agree < LM_BF16_AGREE:
        raise AssertionError(f"tpm serve {a} {shape}: agreement {agree} where "
                             f"routed alike: {worse[:4]}")
    for key in ("served", "nodrop"):
        steps_k = x[key]["steps"]
        w = {"flash_attention_wgmma": layers * TP_REQUESTS,
             "decode_attention": 0 if scfg.use_mla else layers * steps_k}
        for y in ranks:
            got = y[key]["launches"]
            if any(got[k] != w.get(k, 0) for k in got):
                raise AssertionError(f"tpm serve {a} {shape} {key}: launches "
                                     f"{got}, expected {w}")
            for k, c in got.items():
                launches[k] = launches.get(k, 0) + c
    return case


def tps_phase(dev, tmp: str) -> tuple[dict, dict]:
    """Phase tp-ssm (see the module docstring): the one-process float32
    train references and bf16 engines, then the ranks as processes on this
    card (2, then 4).  Returns (record, launches summed over the ranks'
    main-path runs); raises AssertionError on a failed check."""
    import gc

    import torch
    import torch.multiprocessing as mp

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # 1. the one-process references: the float32 train steps, then the bf16
    # engines (kept for the teacher-forced checks)
    rec: dict = {"train_ref": {arch: tp_train_ref(dev, tmp, arch, layers)
                               for arch, layers in TPS_TRAIN}}
    ref_models = {(arch, layers): tp_serve_ref(dev, arch, layers)
                  for arch, layers in dict.fromkeys((a, n) for a, n, _ in
                                                    TPS_SERVE)}
    free()

    # 2. the ranks: 2 processes (training and serving at model 2), then 4
    t1 = time.perf_counter()
    jobs2 = ([("train", (1, 2), a, n) for a, n in TPS_TRAIN]
             + [("serve", a, n, (1, m)) for a, n, m in TPS_SERVE if m == 2])
    jobs4 = [("serve", a, n, (1, m)) for a, n, m in TPS_SERVE if m == 4]
    for world, jobs in ((2, jobs2), (4, jobs4)):
        try:
            mp.spawn(tp_child, args=(world, tmp, jobs, str(dev)), nprocs=world,
                     join=True)
        except Exception as e:        # a rank's traceback, as the check's failure
            raise AssertionError(f"phase tp-ssm ranks ({world}): {e}") from None
    rec["ranks_s"] = time.perf_counter() - t1
    load = lambda name, args, r: torch.load(os.path.join(
        tmp, f"tp_{name}_{'_'.join(map(str, args))}_{r}.pt"), weights_only=False)
    launches: dict[str, int] = {}

    # training: every rank within the limits of the one-process step
    rec["train"] = {}
    for arch, layers in TPS_TRAIN:
        _, _, cfg = _tp_train_cfg(arch, layers)
        apps = attention_layers(cfg)
        want = {"flash_attention": 2 * apps * TP_MB * TP_STEPS,
                "flash_attention_bwd_wgmma": apps * TP_MB * TP_STEPS}
        ref = rec["train_ref"][arch]
        ranks = tp_train_hold(f"{arch} x{layers} train",
                              [load("train", [(1, 2), arch, layers], r)
                               for r in range(2)], ref, want, launches,
                              TPS_FIRST_REL)
        rec["train"][arch] = ranks
        print(f"  {arch} x{layers} train: step {TP_STEPS} took "
              f"{ranks[0]['steps'][-1]['seconds']:.4f} s on 2 ranks sharing "
              f"this card ({card_line()}; a rehearsal of correctness, not a "
              f"scaling figure), {ref[-1]['seconds']:.4f} s in one process",
              flush=True)

    # serving: every rank the same tokens, each within phase 7's bf16 rule
    # against the one-process model's teacher forcing
    rec["serve"] = []
    for arch, layers, m in TPS_SERVE:
        rmodel, ref_done = ref_models[arch, layers]
        rec["serve"].append(tp_serve_hold(
            [load("serve", [arch, layers, (1, m)], r) for r in range(m)], arch,
            layers, m, rmodel, ref_done, launches))
    del ref_models
    free()
    return rec, launches


def tpd_phase(dev, tmp: str) -> tuple[dict, dict]:
    """Phase tp-dp (see the module docstring): the ranks as processes on
    this card (2 at (data 2, model 1), then 4 at (data 2, model 2)), then
    the one-process references one model at a time.  Returns (record,
    launches summed over the ranks' main-path runs); raises AssertionError
    on a failed check."""
    import gc

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs.registry import get_arch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    moe = {a: get_arch(a).model.family == "moe" for a, _ in TPD_SERVE}
    job = lambda a: "moe_serve" if moe[a] else "serve"      # noqa: E731
    rec: dict = {"serve": []}
    t1 = time.perf_counter()
    for shape in TPD_MESHES:
        world = shape[0] * shape[1]
        jobs = [(job(a), a, n, shape) for a, n in TPD_SERVE]
        try:
            mp.spawn(tp_child, args=(world, tmp, jobs, str(dev)), nprocs=world,
                     join=True)
        except Exception as e:        # a rank's traceback, as the check's failure
            raise AssertionError(f"phase tp-dp ranks {shape}: {e}") from None
    rec["ranks_s"] = time.perf_counter() - t1
    load = lambda name, args, r: torch.load(os.path.join(    # noqa: E731
        tmp, f"tp_{name}_{'_'.join(map(str, args))}_{r}.pt"), weights_only=False)
    launches: dict[str, int] = {}
    for arch, layers in TPD_SERVE:
        rmodel, ref_done = (tpm_serve_ref if moe[arch] else tp_serve_ref)(
            dev, arch, layers)
        for shape in TPD_MESHES:
            ranks = [load(job(arch), [arch, layers, shape], r)
                     for r in range(shape[0] * shape[1])]
            if moe[arch]:
                case = tpm_serve_hold(ranks, arch, layers, shape, rmodel,
                                      ref_done, launches)
            else:
                case = tp_serve_hold(ranks, arch, layers, shape[1], rmodel,
                                     ref_done, launches, shape)
            rows = TP_MAX_BATCH // shape[0]
            print(f"    launches a rank: flash = {attention_layers(rmodel.cfg)}"
                  f" attention applications x {TP_REQUESTS} prefills (every "
                  "rank prefills every request), decode = applications x "
                  f"decode steps (each rank its {rows} rows; 0 under MLA)",
                  flush=True)
            for r, y in enumerate(ranks):
                cr = y["served"]["cache_rows"] if moe[arch] else y["cache_rows"]
                want = y["shard_gib"] - y["fsdp_gib"] * (1 - 1 / y["data_ranks"])
                print(f"    rank {r}: cache rows {sorted(set(cr.values()))} of "
                      f"{TP_MAX_BATCH}; parameters {y['param_gib']:.3f} GiB "
                      f"(expected {want:.3f}), "
                      f"{y['param_gib'] / y['shard_gib']:.4f} of a (1, "
                      f"{shape[1]}) rank's {y['shard_gib']:.3f} and "
                      f"{y['param_gib'] / y['whole_gib']:.4f} of the model's "
                      f"{y['whole_gib']:.3f} GiB ({y['fsdp']} leaves, "
                      f"{y['fsdp_gib']:.3f} GiB of the shard, over data)",
                      flush=True)
                if set(cr.values()) != {rows}:
                    raise AssertionError(f"tp-dp {arch} {shape} rank {r}: cache "
                                         f"rows {cr}, expected {rows}")
                if not math.isclose(y["param_gib"], want, rel_tol=1e-9):
                    raise AssertionError(
                        f"tp-dp {arch} {shape} rank {r}: resident parameters "
                        f"{y['param_gib']} GiB, expected {want}")
            rec["serve"].append(case)
        del rmodel
        free()
    return rec, launches


def tpu_kernels(dev) -> tuple[list[dict], dict[str, int]]:
    """Phase tp-uneven's kernel cases: for each of ``TPU_OFFSETS`` the
    forward (the route ``flash_route`` picks: ``fa_tc_kernel`` for
    bfloat16), the backward on its route and forced onto the CUDA cores, and
    the decode kernel (B 8 against 512 slots, ragged lengths), each with the
    head offset against its plain version (forward and decode
    ``attn_compare``; backward ``FLASH_BWD_F32_REL`` of each gradient's
    largest in float32, ``FLASH_BWD_BF16_ULPS`` bf16 ulps in bfloat16, lse
    ``FLASH_BWD_LSE_REL``), two calls bitwise equal, each timed (device
    time from a trace, per call between events) beside the same call on
    whole groups (KV · G heads, offset 0) and its plain version, with its
    bound (the rank's heads' work; the float32 backward on the tensor
    cores as phase 10 bounds it, each product as
    ``FLASH_BWD_F32_MIN_PRODUCTS`` 16-bit products).  Returns (the rows,
    the checks' launches); raises AssertionError on a failed check."""
    import torch

    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fused,
                                                     flash_bwd_route,
                                                     flash_route)
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref)

    before = dict(LAUNCHES)
    rows = []
    for label, dts, H, KV, G, off, dh in TPU_OFFSETS:
        dt = getattr(torch, dts)
        item = 4 if dt == torch.float32 else 2
        g = torch.Generator(device=dev).manual_seed(H * 100 + off)
        rnd = lambda *shape: torch.randn(shape, generator=g,  # noqa: E731
                                         device=dev).to(dt)
        kw = dict(group=G, head_offset=off)
        HA = KV * G                              # the same KV heads, whole
        q, go = rnd(1, TPU_S, H, dh), rnd(1, TPU_S, H, dh)
        k, v = rnd(1, TPU_S, KV, dh), rnd(1, TPU_S, KV, dh)
        qa, ga = rnd(1, TPU_S, HA, dh), rnd(1, TPU_S, HA, dh)
        shape = f"{dts} B=1 S={TPU_S} H={H} KV={KV} G={G} offset {off} dh={dh}"

        def trace(fn):
            # one trace of 10 calls: (device ms a call, each kernel's count)
            acts, _ = device_trace(fn, reps=10)
            names = collections.Counter(n.split("<")[0].split("(")[0]
                                        for n, _ in acts or ())
            return sum(us for _, us in acts or ()) / 1e3 / 10, names

        def traced(fn, bound, call_ms):
            # two traces that agree kernel by kernel, each kernel a whole
            # number of the calls, between the work's bound and the time
            # between events around one call (one stream's kernels cannot
            # outlast it): a trace that lost some of the calls' kernels
            # (Queue C item 8) or over-read is taken again; then the
            # per-call events stand in.  Returns (ms, timer, traces taken,
            # the last trace's kernels and their counts)
            last = None
            for i in range(1, TRACE_TRIES + 2):
                ms, kn = trace(fn)
                ok = (kn and all(c % 10 == 0 for c in kn.values())
                      and bound <= ms <= call_ms)
                if ok and kn == last:
                    return ms, "profiler", i, dict(kn)
                last = kn if ok else None
            return call_ms, "events", TRACE_TRIES + 1, dict(kn)

        def timed(name, fn, aligned, plain, work):
            nbytes, ops = work
            bound, by = work_bound(nbytes, ops, dts)
            fp32_bound = None
            if name == "flash_attention_bwd_wgmma" and dt == torch.float32:
                # float32 on the tensor cores: each of the five products as
                # FLASH_BWD_F32_MIN_PRODUCTS 16-bit products at the 16-bit
                # peak (as phase 10's bwd_row), the float32 peak's beside it
                fp32_bound = bound
                bound, by = work_bound(nbytes, ops * FLASH_BWD_F32_MIN_PRODUCTS,
                                       "bfloat16")
            call_ms, a_call_ms = median_ms(fn, reps=10), median_ms(aligned, reps=10)
            d_ms, timer, tries, kn = traced(fn, bound, call_ms)
            a_ms, a_timer, a_tries, a_kn = traced(aligned, bound, a_call_ms)
            return dict(name=name, case=label, shape=shape, ms=d_ms, timer=timer,
                        traces=tries, trace_kernels=kn, call_ms=call_ms,
                        aligned_ms=a_ms, aligned_timer=a_timer,
                        aligned_traces=a_tries, aligned_trace_kernels=a_kn,
                        aligned_call_ms=a_call_ms,
                        plain_ms=median_ms(plain, reps=3, warm=1),
                        bound_ms=bound, bound_by=by, fp32_bound_ms=fp32_bound,
                        library_ms=None)

        # forward
        route = flash_route(q, k, v, G)
        if route != ("wgmma" if dt == torch.bfloat16 else "simt"):
            raise AssertionError(f"tp-uneven {shape}: the {route} forward")
        fwd = lambda: flash_attention_fused(q, k, v, round_p=False, **kw)  # noqa: E731
        got, again = fwd(), fwd()
        want = flash_attention_ref(q, k, v, **kw)
        ok, err, lim = attn_compare(got, want)
        name = "flash_attention_wgmma" if route == "wgmma" else "flash_attention"
        row = timed(name, fwd, lambda: flash_attention_fused(
            qa, k, v, round_p=False), lambda: flash_attention_ref(q, k, v, **kw),
            flash_work(1, TPU_S, TPU_S, H, KV, dh, item, True))
        row.update(max_abs_err=err, limit=lim, route=route,
                   bitwise_repeat=bool(torch.equal(got, again)))
        rows.append(row)
        if not (ok and row["bitwise_repeat"]):
            raise AssertionError(f"tp-uneven forward {shape}: {row}")
        del got, again, want
        # backward, on its route and on the CUDA cores
        want = flash_attention_bwd_ref(q, k, v, go, **kw)
        broute = flash_bwd_route(q, k, v, False, G)
        if broute != "wgmma":
            raise AssertionError(f"tp-uneven {shape}: the {broute} backward")
        for forced in (None, "simt"):
            bwd = lambda f=forced: flash_attention_bwd(  # noqa: E731
                q, k, v, go, route=f, **kw)
            got, again = bwd(), bwd()
            errs, lims = {}, {}
            for n, a, b in zip(("dq", "dk", "dv", "lse"), got, want):
                top = float(b.float().abs().max())
                errs[n] = float((a.float() - b.float()).abs().max())
                lims[n] = (FLASH_BWD_LSE_REL * max(top, 1.0) if n == "lse"
                           else FLASH_BWD_F32_REL * top if dt == torch.float32
                           else FLASH_BWD_BF16_ULPS
                           * 2.0 ** (math.floor(math.log2(top)) - 7))
            name = ("flash_attention_bwd" if forced
                    else "flash_attention_bwd_wgmma")
            row = timed(name, bwd, lambda f=forced: flash_attention_bwd(
                qa, k, v, ga, route=f), lambda: flash_attention_bwd_ref(
                    q, k, v, go, **kw), flash_bwd_work(1, TPU_S, H, KV, dh, item))
            row.update(max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                       errs=errs, limits=lims, route=forced or broute,
                       bitwise_repeat=all(torch.equal(a, b)
                                          for a, b in zip(got, again)))
            rows.append(row)
            if not (row["bitwise_repeat"]
                    and all(errs[n] <= lims[n] for n in errs)):
                raise AssertionError(f"tp-uneven backward {shape}: {row}")
            del got, again
        del want
        # decode: B 8 against 512 slots, ragged lengths on the card
        qd, qda = rnd(8, H, dh), rnd(8, HA, dh)
        kd, vd = rnd(8, TP_MAX_LEN, KV, dh), rnd(8, TP_MAX_LEN, KV, dh)
        S = TP_MAX_LEN
        lens = [1, 17, S // 5, S // 2 - 1, S // 2, 4 * S // 5, S - 1, S]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        dec = lambda: decode_attention(qd, kd, vd, ln, round_p=False, **kw)  # noqa: E731
        got, again = dec(), dec()
        ok, err, lim = attn_compare(got, decode_attention_ref(qd, kd, vd, ln, **kw))
        row = timed("decode_attention", dec, lambda: decode_attention(
            qda, kd, vd, ln, round_p=False), lambda: decode_attention_ref(
                qd, kd, vd, ln, **kw), decode_work(lens, H, KV, dh, item))
        row.update(shape=f"{dts} B=8 S={TP_MAX_LEN} H={H} KV={KV} G={G} offset "
                   f"{off} dh={dh} lengths {lens}", max_abs_err=err, limit=lim,
                   bitwise_repeat=bool(torch.equal(got, again)))
        rows.append(row)
        if not (ok and row["bitwise_repeat"]):
            raise AssertionError(f"tp-uneven decode {shape}: {row}")
        del q, go, k, v, qa, ga, qd, qda, kd, vd, got, again
    for r in rows:
        print(f"  {r['name']} {r['shape']} ({r['route'] if 'route' in r else 'da'}"
              f"): max abs err {r['max_abs_err']:.3g}, two calls bitwise "
              f"{r['bitwise_repeat']}; {r['ms']:.5f} ms on the device "
              f"({r['timer']}; {r['traces']} traces), per call "
              f"{r['call_ms']:.4f}; the same call on whole groups "
              f"{r['aligned_ms']:.5f} ({r['aligned_timer']}; "
              f"{r['aligned_traces']} traces), "
              f"per call {r['aligned_call_ms']:.4f}; plain version "
              f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.5f} ({r['bound_by']}"
              + ("" if r["fp32_bound_ms"] is None else
                 f"; {FLASH_BWD_F32_MIN_PRODUCTS} 16-bit products a product; "
                 f"at the float32 peak {r['fp32_bound_ms']:.5f}") + ")",
              flush=True)
    return rows, {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES
                  if LAUNCHES[k] != before.get(k, 0)}


def tpu_count_hold(dev, ranks: list[dict]) -> dict:
    """Phase tp-uneven's count: ``TPU_COUNT``'s step counted on meta by the
    dry-run (``dryrun.count_cell`` at (data 1, model TPU_M), the uneven
    plan) for each of its ranks, against the same rank's count of its step
    on the card (``tp_child``'s ``train``): flops, products and kernel calls
    exactly, the kernel calls = the card step's launches, bytes within
    ``COUNT_BYTES_REL``.  Returns the record; raises AssertionError."""
    from repro_torch.launch import dryrun

    arch, layers, counted = TPU_COUNT
    spec, cell, cfg = _tp_train_cfg(arch, layers)
    rec = {}
    for r in counted:
        t1 = time.perf_counter()
        _, meta = dryrun.count_cell(spec, cell, (1, TPU_M), ("data", "model"),
                                    rank=r, allow_uneven=True,
                                    microbatch_override=TP_MB)
        meta_s = time.perf_counter() - t1
        card = ranks[r]["count"]
        calls = {k: int(v["calls"]) for k, v in meta.kernels.items()}
        rel = abs(meta.bytes - card["bytes"]) / card["bytes"]
        differ = {k: (meta.by_op.get(k), card["by_op"].get(k))
                  for k in set(meta.by_op) | set(card["by_op"])
                  if meta.by_op.get(k) != card["by_op"].get(k)}
        for k, (a, b) in sorted(differ.items()):
            print(f"    count rank {r}: {k}: {a} on meta, {b} on the card")
        rec[r] = dict(meta=dict(flops=meta.flops, products=meta.products,
                                bytes=meta.bytes, calls=calls), meta_s=meta_s,
                      card={k: v for k, v in card.items() if k != "by_op"},
                      bytes_rel=rel, ops_differ={k: list(v) for k, v in
                                                  differ.items()})
        print(f"  count {arch} x{layers} float32 rank {r} of {TPU_M} "
              f"({ranks[r]['layout']}): {meta.flops / 1e12:.4f} TFLOP "
              f"({meta.products / 1e12:.4f} in products), {meta.bytes / 1e9:.3f}"
              f" GB on meta in {meta_s:.2f} s; the card {card['flops'] / 1e12:.4f}"
              f" TFLOP, {card['bytes'] / 1e9:.3f} GB ({rel:.3%} apart; limit "
              f"{COUNT_BYTES_REL:.0%}); kernel calls {calls} on meta, "
              f"{card['calls']} on the card, launches {card['launches']}",
              flush=True)
        if meta.flops != card["flops"] or meta.products != card["products"]:
            raise AssertionError(f"tp-uneven count rank {r}: flops {meta.flops} "
                                 f"/ {card['flops']}, products {meta.products} "
                                 f"/ {card['products']}")
        if not calls == card["calls"] == card["launches"]:
            raise AssertionError(f"tp-uneven count rank {r}: calls {calls}, "
                                 f"{card['calls']}, launches {card['launches']}")
        if rel > COUNT_BYTES_REL:
            raise AssertionError(f"tp-uneven count rank {r}: bytes {rel:.3%} "
                                 "apart")
    if not rec[counted[1]]["meta"]["flops"] < rec[counted[0]]["meta"]["flops"]:
        raise AssertionError("tp-uneven count: the shortest rank counts no less "
                             "than the largest")
    return rec


def tpu_fault_hold(ranks: list[dict], ref_steps: list[dict]) -> dict:
    """Phase tp-uneven's planted fault (``TPU_FAULT``'s step with K and V's
    gradient not summed over model, ``tp_child``'s ``train(fault=True)``)
    against the one-process step: every rank's forward logits within
    ``TP_LOGIT_REL`` (the fault is in the backward alone) and some rank's
    first moments beyond ``TPU_FIRST_REL``, which shows that the first
    moments' limit sees a fault the logits cannot.  Returns the readings;
    raises AssertionError where the limits do not tell the fault."""
    arch, layers = TPU_FAULT
    reads = [tp_train_reading(y, ref_steps) for y in ranks]
    for r, x in enumerate(reads):
        print(f"  planted fault, {arch} x{layers} train with K and V's gradient "
              f"not summed over model, rank {r}: first moments "
              f"{x['first'][1]:.3g} of the largest ({x['first'][0]}; limit "
              f"{TPU_FIRST_REL}), forward logits {x['logits']:.3g} (limit "
              f"{TP_LOGIT_REL}), grad norm {x['grad_norm']:.3g} apart (rtol "
              f"{TP_GNORM_RTOL}), loss {x['loss']:.3g} (rtol {TP_LOSS_RTOL})",
              flush=True)
    worst = max(x["first"][1] for x in reads)
    if worst <= TPU_FIRST_REL or any(x["logits"] > TP_LOGIT_REL for x in reads):
        raise AssertionError(f"tp-uneven planted fault: first moments at most "
                             f"{worst} (limit {TPU_FIRST_REL}), logits "
                             f"{[x['logits'] for x in reads]}")
    return dict(ranks=reads, first_over_limit=worst / TPU_FIRST_REL)


def tpu_phase(dev, tmp: str) -> tuple[dict, dict, dict]:
    """Phase tp-uneven (see the module docstring): the offset kernels
    against their plain versions (``tpu_kernels``), the one-process
    references, the ranks (3 processes on this card), then every run held
    as phases 12 and 13 hold theirs and the count (``tpu_count_hold``).
    Returns (record, launches summed over the ranks' main-path runs, the
    kernel checks' launches); raises AssertionError on a failed check."""
    import gc

    import torch
    import torch.multiprocessing as mp

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    rec: dict = {}
    rec["kernels"], kernel_launches = tpu_kernels(dev)
    free()
    rec["train_ref"] = {arch: tp_train_ref(dev, tmp, arch, layers, TPU_M, True,
                                           TPU_STEPS)
                        for arch, layers in TPU_TRAIN}
    free()
    dense = [(a, n) for a, n in TPU_SERVE if a != TPM_TRAIN[0]]
    ref_models = {(a, n): tp_serve_ref(dev, a, n) for a, n in dense}
    free()

    shape = (1, TPU_M)
    train_jobs = [("train", shape, a, n, True, TPU_STEPS, a == TPU_COUNT[0])
                  for a, n in TPU_TRAIN]
    fault_job = ("train", shape, *TPU_FAULT, True, TPU_STEPS, False, True)
    moe_job = ("moe_train", shape, True, TPU_STEPS)
    serve_jobs = [("serve", a, n, shape, True) for a, n in dense]
    moe_serve_job = ("moe_serve", TPM_TRAIN[0], TPM_TRAIN[1], shape, True)
    jobs = train_jobs + [fault_job, moe_job] + serve_jobs + [moe_serve_job]
    t1 = time.perf_counter()
    try:
        mp.spawn(tp_child, args=(TPU_M, tmp, jobs, str(dev)), nprocs=TPU_M,
                 join=True)
    except Exception as e:            # a rank's traceback, as the check's failure
        raise AssertionError(f"phase tp-uneven ranks: {e}") from None
    rec["ranks_s"] = time.perf_counter() - t1
    load = lambda job, r: torch.load(os.path.join(  # noqa: E731
        tmp, f"tp_{job[0]}_{'_'.join(map(str, job[1:]))}_{r}.pt"),
        weights_only=False)
    launches: dict[str, int] = {}
    offsets: dict[str, int] = {}

    def add_offsets(ranks):
        for y in ranks:
            for k, n in y["offset_calls"].items():
                offsets[k] = offsets.get(k, 0) + n

    rec["train"] = {}
    for job in train_jobs:
        arch, layers = job[2], job[3]
        _, _, cfg = _tp_train_cfg(arch, layers)
        ranks = [load(job, r) for r in range(TPU_M)]
        want = {"flash_attention": 2 * layers * TP_MB * TPU_STEPS,
                "flash_attention_bwd_wgmma": layers * TP_MB * TPU_STEPS}
        rec["train"][arch] = tp_train_hold(f"{arch} x{layers} train", ranks,
                                           rec["train_ref"][arch], want, launches,
                                           TPU_FIRST_REL)
        add_offsets(ranks)
        if arch == TPU_COUNT[0]:
            rec["count"] = tpu_count_hold(dev, ranks)
    rec["fault"] = tpu_fault_hold([load(fault_job, r) for r in range(TPU_M)],
                                  rec["train_ref"][TPU_FAULT[0]])
    moe = [load(moe_job, r) for r in range(TPU_M)]
    add_offsets(moe)
    rec["moe_train"] = tpm_train_hold(dev, tmp, moe, launches, uneven=True,
                                      n_steps=TPU_STEPS,
                                      first_rel=TPU_FIRST_REL)
    del moe
    free()
    rec["serve"] = []
    for (arch, layers), job in zip(dense, serve_jobs):
        ranks = [load(job, r) for r in range(TPU_M)]
        add_offsets(ranks)
        rmodel, ref_done = ref_models.pop((arch, layers))
        rec["serve"].append(tp_serve_hold(ranks, arch, layers, TPU_M, rmodel,
                                          ref_done, launches))
        del rmodel
        free()
    ranks = [load(moe_serve_job, r) for r in range(TPU_M)]
    add_offsets(ranks)
    rmodel, ref_done = tpm_serve_ref(dev, *TPM_TRAIN)
    rec["serve"].append(tpm_serve_hold(ranks, *TPM_TRAIN, shape, rmodel,
                                       ref_done, launches))
    del rmodel, ranks
    free()
    # the main path's calls on heads that are not whole KV groups: the
    # training forward and backward (flash_attention_train) and the served
    # prefill (flash_attention_fused) of qwen2.5-3b's and granite-8b's ranks
    # 1 and 2; none in decode (a cache over the sequence gathers every
    # head's query, so each rank decodes whole groups)
    rec["offset_calls"] = offsets
    print(f"  attention calls with a head offset or a short group, all ranks: "
          f"{offsets}", flush=True)
    if not (offsets.get("flash_attention_train") and
            offsets.get("flash_attention_fused")):
        raise AssertionError(f"tp-uneven: the offset calls {offsets}")
    return rec, launches, kernel_launches


def main() -> int:
    t0 = time.perf_counter()
    # ------------------------------------------------------------ 1. device
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail("device", f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("device", "CUDA is not available; this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x{count}",
          flush=True)
    phase("device", t0, card)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs import mlperf_tiny as mt
        from repro_torch.configs.classical import (BENCHMARKS, TRAIN_SPLIT,
                                                   build)
        from repro_torch.core.compiler import MafiaCompiler
        from repro_torch.data.datasets import get_spec, make_dataset
        from repro_torch.models import bonsai, protonn
        from repro_torch.core.lowering import ChainStep
        from repro_torch.kernels import build as kb
        from repro_torch.kernels import linear_pipeline as lp
        from repro_torch.kernels import megakernel as mk
        from repro_torch.kernels import ops
        from repro_torch.kernels.gemv import plan_matmul
        from repro_torch.kernels.ref import (gemv_ref, matmul_ref,
                                             run_segment_grid_ref, spmv_ref)
        from repro_torch.serve.classical_engine import (ClassicalServeEngine,
                                                        get_program)
        from repro_torch.configs.registry import SHAPES, get_arch
        from repro_torch.kernels.decode_attention import (decode_attention,
                                                          plan_decode)
        from repro_torch.kernels.flash_attention import (bwd_kernel_facts,
                                                         flash_attention_bwd,
                                                         flash_attention_fused,
                                                         flash_bwd_route,
                                                         flash_route,
                                                         plan_flash_bwd)
        from repro_torch.kernels.ref import (decode_attention_ref,
                                             flash_attention_bwd_ref,
                                             flash_attention_ref)
        from repro_torch.kernels.ref import mamba2_ssd_ref
        from repro_torch.models.layers import MM_F32_ROUTE
        from repro_torch.models.mamba2 import ssd_chunked
        from repro_torch.models.moe import capacity
        from repro_torch.models.transformer import init_params
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.scheduling import bucket_for
    except ImportError as e:
        return fail("device", f"the port is not importable: {e}")
    dev = torch.device("cuda")
    LAUNCHES = kb.LAUNCHES

    # ------------------------------------------------------------- 2. build
    t = time.perf_counter()
    try:
        libs = kb.build()
    except Exception as e:                     # noqa: BLE001 — report, exit 1
        return fail("build", str(e))
    for name, path in libs.items():
        secs = kb.BUILD_SECONDS.get(name)
        print(f"  {name}.cu: " + ("already built" if secs is None
                                  else f"{secs:.1f} s") +
              f" -> {os.path.relpath(path, ROOT)}")
    for line in "\n".join(kb.BUILD_LOG).splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or line.endswith(".cu:")):
            print("  ptxas:", line.strip())
    phase("build", t, f"{len(libs)} libraries")

    # ------------------------------------------------- 3. kernel vs plain
    t = time.perf_counter()
    report: dict = {"card": card, "kind": kind, "cases": [], "checks": {}}
    worst: dict[str, dict] = {}
    for bench in (b.name for b in BENCHMARKS):
        for prec in ("float32", "int8", "int16"):
            prog = get_program(bench, precision=prec,
                               exec_mode="megakernel_grid", device=dev)
            mkp = prog.plan.megakernel
            if mkp.n_islands or len(mkp.segments) != 1:
                return fail("kernel", f"{bench}/{prec}: {mkp.summary()}")
            (seg,) = mkp.segments
            _, x = bucket_inputs(prog, seed=1)
            grid = mk.run_segment_grid(seg, [x])
            per = [mk.run_segment(seg, [x[i]]) for i in range(BUCKET)]
            plain = run_segment_grid_ref(seg, [x])
            torch.cuda.synchronize()
            for j, g in enumerate(grid):
                if not torch.equal(g, torch.stack([p[j] for p in per])):
                    return fail("kernel", f"{bench}/{prec}: grid vs per-sample "
                                f"differ on output {seg.out_refs[j]}")
            ok, err, lsb = compare(seg, grid, plain)
            report["cases"].append(dict(bench=bench, precision=prec,
                                        max_abs_err=err, lsb_1=lsb, ok=ok))
            w = worst.setdefault(prec, {"max_abs_err": 0.0, "lsb_1": 0})
            w["max_abs_err"] = max(w["max_abs_err"], err)
            w["lsb_1"] += lsb
            if not ok:
                return fail("kernel", f"{bench}/{prec}: kernel vs plain out of "
                            f"tolerance (max abs err {err}, 1-LSB count {lsb})")
    for prec, w in worst.items():
        print(f"  megakernel {prec}: worst max abs err {w['max_abs_err']:.3g}, "
              f"1-LSB elements {w['lsb_1']}")
    seg, x, want = tie_segment()
    x = torch.from_numpy(x).to(dev)
    for lane, got in (("kernel", mk.run_segment_grid(seg, [x])),
                      ("plain", run_segment_grid_ref(seg, [x]))):
        for name, g, w in zip(seg.out_refs, got, want):
            if not np.array_equal(g.cpu().numpy(), w):
                return fail("kernel", f"ties: the {lane} version's {name!r} "
                            "is not numpy's round-half-to-even result")
    print("  ties: kernel and plain version round half to even, exactly")
    checks = {k: {"cases": 0, "max_abs_err": 0.0, "lsb_1": 0}
              for k in ("linear_chain", "linear_chain_q", "spmv", "matmul",
                        "matmul_wgmma")}
    report["checks"] = checks
    routes: dict[str, int] = {}

    def note(kernel: str, label: str, ok: bool, err: float, lsb: int = 0):
        c = checks[kernel]
        c["cases"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
        c["lsb_1"] += lsb
        if not ok:
            raise AssertionError(f"{kernel} {label}: kernel vs plain out of "
                                 f"tolerance (max abs err {err}, 1-LSB {lsb})")

    def check_chain(label, chain, x, extras):
        got = lp.run_chain(chain, x, extras)
        want = lp.chain_ref(chain, x, extras)
        torch.cuda.synchronize()
        note("linear_chain_q" if chain.quantized else "linear_chain", label,
             *compare_chain(chain, got, want))

    try:
        for bench in (b.name for b in BENCHMARKS):
            for prec in ("float32", "int8", "int16"):
                prog = get_program(bench, precision=prec, use_pallas=True,
                                   device=dev)
                steps = [s for s in prog.plan.steps if isinstance(s, ChainStep)]
                if not steps:
                    return fail("kernel", f"{bench}/{prec}: no chain step")
                for i, step in enumerate(steps):
                    check_chain(f"{bench}/{prec} chain {i}",
                                *chain_case(prog, step, seed=i))
        for bits in (None, 8, 16):
            for seed, shape in ((0, (4, 16, 976)), (1, (3, 5, 40)),
                                (2, (2, 7, 129))):
                rng = np.random.default_rng(seed)
                pool = FLOAT_STAGES if bits is None else Q_STAGES
                names = (list(rng.permutation(pool))
                         + list(rng.choice(pool, len(pool))))
                stages, vecs, n_arr = random_chain(rng, names, shape[-1], bits)
                x, *extras = [torch.from_numpy(random_stream(rng, shape, bits))
                              .to(dev) for _ in range(1 + n_arr)]
                check_chain(f"random bits={bits} {shape}",
                            lp.Chain(tuple(stages), tuple(vecs),
                                     bits is not None, bits or 8), x, extras)
        # views at storage offsets of 1-15 bytes (the elements before an
        # operand's first 16-byte boundary and after its last are the
        # threads' own loads), a 1-element stream with length-1 vecs
        n_views = 0
        for bits in (None, 8, 16):
            rng = np.random.default_rng(40 + (bits or 0))
            pool = FLOAT_STAGES if bits is None else Q_STAGES
            for shape in ((4, 16, 976), (3, 5, 40), (1,)):
                stages, vecs, n_arr = random_chain(rng, list(rng.permutation(pool)),
                                                   shape[-1], bits)
                chain = lp.Chain(tuple(stages), tuple(vecs), bits is not None,
                                 bits or 8)
                operands = [torch.from_numpy(random_stream(rng, shape, bits))
                            .to(dev) for _ in range(1 + n_arr)]
                item = operands[0].element_size()
                for off in range(0, 16, item):
                    x, *extras = [at_offset(t, (off + 5 * k * item) % 16)
                                  for k, t in enumerate(operands)]
                    check_chain(f"view bits={bits} {shape} at +{off} bytes",
                                chain, x, extras)
                    n_views += 1
        print(f"  linear_chain views: {n_views} cases at storage offsets of "
              "0-15 bytes, incl. a 1-element stream")
        # a chain call captured in a CUDA graph replays as the eager call does,
        # also on new operands copied in
        for prec in ("float32", "int8"):
            prog = get_program("bonsai/curet-m", precision=prec, use_pallas=True,
                               device=dev)
            step = [s for s in prog.plan.steps if isinstance(s, ChainStep)][-1]
            chain, x, extras = chain_case(prog, step, seed=5)
            eager = lp.run_chain(chain, x, extras)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                lp.run_chain(chain, x, extras)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = lp.run_chain(chain, x, extras)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(captured, eager):
                raise AssertionError(f"chain {prec}: the graph's replay differs "
                                     "from the eager call")
            _, x2, extras2 = chain_case(prog, step, seed=6)
            for dst, src in zip((x, *extras), (x2, *extras2)):
                dst.copy_(src)
            graph.replay()
            want = lp.run_chain(chain, x, extras)
            torch.cuda.synchronize()
            if not torch.equal(captured, want):
                raise AssertionError(f"chain {prec}: the replay on new operands "
                                     "differs from the eager call")
        print("  linear_chain captured in a CUDA graph: replays equal the eager "
              "calls bitwise (float32, int8)")
        gx = torch.Generator(device=dev).manual_seed(11)
        zx = next(np.asarray(n.params["matrix"], np.float32)
                  for n in build("bonsai/curet-m")[0].nodes.values()
                  if n.id == "Zx")
        spmv_cases = [(torch.from_numpy(zx).to(dev), 64, 128),
                      (tile_sparse(1000, 3000, 0.3, 64, 64, 3, dev), 37, 64),
                      (tile_sparse(300, 200, 0.5, 16, 16, 4, dev), 5, 16)]
        spmv_cases += [(tile_sparse(4096, 4096, d, 128, 128, 5, dev), 64, 128)
                       for d in (0.0, 0.1, 1.0)]
        # a row block with no kept tile; Zx and a 611-wide weight at B = 1
        # (x's rows unaligned)
        w_hole = tile_sparse(512, 512, 1.0, 128, 128, 7, dev)
        w_hole[128:256] = 0.0
        spmv_cases += [(w_hole, 64, 128), (spmv_cases[0][0], 1, 128),
                       (torch.randn((24, 611), generator=gx, device=dev), 1, 128)]
        for w, B, bm in spmv_cases:
            x = torch.randn((B, w.shape[1]), generator=gx, device=dev)
            packed = ops.pack_bcsr(w.cpu().numpy(), bm=bm, bk=bm, device=dev)
            got, again = ops.spmv(packed, x), ops.spmv(packed, x)
            want = spmv_ref(w, x)
            torch.cuda.synchronize()
            label = (f"{tuple(w.shape)} B={B} tiles {bm} density "
                     f"{packed.density:.3f}")
            if not torch.equal(got, again):
                raise AssertionError(f"spmv {label}: two calls differ")
            note("spmv", label, *compare_product(got, want, w.shape[1]))
        # every route of plan_matmul: wgmma with TMA staging (aligned bf16),
        # with thread staging (K = 610, 65 or 33: unaligned pitches), split-K
        # (fewer output tiles than SMs: the GEMVs at B = 64), and the
        # float32 CUDA-core kernel, at the same shapes
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for dt in (torch.float32, torch.bfloat16):
            for M, K, N in MATMUL_SHAPES:
                a, b, bt = (torch.randn(s, generator=gx, device=dev).to(dt)
                            for s in ((M, K), (K, N), (N, K)))
                for tb, got, want, bb in (
                        (False, ops.matmul(a, b),
                         matmul_ref(a.float(), b.float()), b),
                        (True, ops.matmul(a, bt, transpose_b=True),
                         matmul_ref(a.float(), bt.float().T), bt)):
                    torch.cuda.synchronize()
                    plan = plan_matmul(M, N, K, dt, tb, a.data_ptr(),
                                       bb.data_ptr(), sms)
                    route = (f"{plan.kernel}/{plan.staging}"
                             + ("/split-k" if plan.splits > 1 else ""))
                    routes[route] = routes.get(route, 0) + 1
                    note("matmul" if plan.kernel == "simt" else "matmul_wgmma",
                         f"{dt} {(M, K, N)} transpose_b={tb} "
                         f"{route} splits {plan.splits}",
                         *compare_product(got, want.to(dt), K))
        for want in ("wgmma/tma", "wgmma/threads", "wgmma/tma/split-k",
                     "wgmma/threads/split-k", "simt/cp.async",
                     "simt/cp.async/split-k"):
            if not routes.get(want):
                raise AssertionError(f"matmul route {want} not exercised: "
                                     f"{routes}")
    except AssertionError as e:
        return fail("kernel", str(e))
    for k, c in checks.items():
        print(f"  {k}: {c['cases']} cases, worst max abs err "
              f"{c['max_abs_err']:.3g}, 1-LSB elements {c['lsb_1']}")
    print(f"  matmul routes (cases): {routes}")
    report["matmul_routes"] = routes
    phase("kernel", t, f"{len(report['cases'])} megakernel program x precision "
          "cases (grid == per-sample bitwise) and every chain, spmv and matmul "
          "case within tolerance of its plain version")

    # ------------------------------------------------------- 4. serve (main)
    t = time.perf_counter()

    def requests(eng):
        shape = eng.program.dfg.graph_inputs["x"].shape
        rng = np.random.default_rng(7)
        return rng.standard_normal((SERVE_REQUESTS,) + tuple(shape)).astype(
            np.float32)

    def agree(bench, prec, eng, done, X, lane):
        ref = get_program(bench, precision=prec, exec_mode="interpret",
                          device=dev)
        preds = [r.pred for r in done]
        want = ref.batch(BUCKET, mode="vmap")(x=X)["Pred"].reshape(-1).cpu().tolist()
        n_ok = sum(int(a == b) for a, b in zip(preds, want))
        logits = [r.outputs[next(k for k in r.outputs if k != "Pred")]
                  for r in done]
        finite = all(bool(np.isfinite(v).all()) for v in logits)
        print(f"  {lane} {bench} {prec}: {len(done)} requests, {n_ok}/"
              f"{len(want)} predictions agree with the interpret lane",
              flush=True)
        ok = len(done) == SERVE_REQUESTS and finite and n_ok >= 0.99 * len(want)
        return ok, dict(lane=lane, bench=bench, precision=prec,
                        requests=len(done), agree=n_ok, finite=finite)

    served = []
    engines = [(bench, prec, ClassicalServeEngine(
                    bench, exec_mode="megakernel_grid", max_batch=BUCKET,
                    precision=prec, device=dev))
               for bench in ("bonsai/curet-m", "protonn/curet-m")
               for prec in ("float32", "int8")]
    LAUNCHES["megakernel"] = 0
    results = []
    for bench, prec, eng in engines:
        X = requests(eng)
        for row in X:
            eng.submit(row)
        results.append((bench, prec, eng, X, eng.run_to_completion()))
    torch.cuda.synchronize()
    launches = {"megakernel": LAUNCHES["megakernel"]}
    for bench, prec, eng, X, done in results:
        ok, rec = agree(bench, prec, eng, done, X, "megakernel_grid")
        served.append(rec)
        if not ok:
            return fail("serve", f"megakernel_grid {bench}/{prec}: {rec}")
    if launches["megakernel"] <= 0:
        return fail("serve", "the main path launched the megakernel 0 times")

    chain_engines = []
    launches.update(linear_chain=0, linear_chain_q=0)
    for bench in ("bonsai/curet-m", "protonn/curet-m"):
        for prec in ("float32", "int8"):
            eng = ClassicalServeEngine(bench, use_pallas=True,
                                       exec_mode="interpret", max_batch=BUCKET,
                                       precision=prec, device=dev)
            n_chains = sum(isinstance(s, ChainStep)
                           for s in eng.program.plan.steps)
            X = requests(eng)
            LAUNCHES["linear_chain"] = LAUNCHES["linear_chain_q"] = 0
            for row in X:
                eng.submit(row)
            done = eng.run_to_completion()
            torch.cuda.synchronize()
            mine = "linear_chain" if prec == "float32" else "linear_chain_q"
            other = "linear_chain_q" if prec == "float32" else "linear_chain"
            got, expect = LAUNCHES[mine], n_chains * (SERVE_REQUESTS // BUCKET)
            launches[mine] += got
            print(f"  use_pallas {bench} {prec}: {n_chains} chains per "
                  f"forward, {mine} launches {got} (expected {expect})")
            if got != expect or LAUNCHES[other] != 0:
                return fail("serve", f"use_pallas {bench}/{prec}: {mine} "
                            f"launched {got} times, expected {expect}")
            ok, rec = agree(bench, prec, eng, done, X, "use_pallas")
            served.append(rec)
            if not ok:
                return fail("serve", f"use_pallas {bench}/{prec}: {rec}")
            chain_engines.append((bench, prec, eng))
    phase("serve", t, f"{len(served)} engines; launches {launches}")

    # ---------------------------------------------------------- 5. ops (main)
    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(13)
    w_zx = torch.from_numpy(zx).to(dev)
    w_sp = tile_sparse(4096, 4096, 0.1, 128, 128, 6, dev)
    w_dn = torch.randn((4096, 4096), generator=g, device=dev)
    x_zx = torch.randn((BUCKET, 610), generator=g, device=dev)
    x_4k = torch.randn((BUCKET, 4096), generator=g, device=dev)
    a_4k = torch.randn((4096, 4096), generator=g, device=dev)
    p_zx = ops.pack_bcsr(zx, device=dev)
    p_sp = ops.pack_bcsr(w_sp.cpu().numpy(), device=dev)
    bf = torch.bfloat16
    w_zx16, x_zx16 = w_zx.to(bf), x_zx.to(bf)
    w_dn16, x_4k16, a_4k16 = w_dn.to(bf), x_4k.to(bf), a_4k.to(bf)
    LAUNCHES["spmv"] = LAUNCHES["matmul"] = LAUNCHES["matmul_wgmma"] = 0
    outs = [(ops.spmv(p_zx, x_zx), spmv_ref(w_zx, x_zx)),
            (ops.spmv(p_sp, x_4k), spmv_ref(w_sp, x_4k)),
            (ops.gemv(w_zx, x_zx), gemv_ref(w_zx, x_zx)),
            (ops.gemv(w_dn, x_4k), gemv_ref(w_dn, x_4k)),
            (ops.matmul(a_4k, w_dn), matmul_ref(a_4k, w_dn)),
            (ops.gemv(w_zx16, x_zx16),
             gemv_ref(w_zx16.float(), x_zx16.float()).to(bf)),
            (ops.gemv(w_dn16, x_4k16),
             gemv_ref(w_dn16.float(), x_4k16.float()).to(bf)),
            (ops.matmul(a_4k16, w_dn16),
             matmul_ref(a_4k16.float(), w_dn16.float()).to(bf))]
    torch.cuda.synchronize()
    launches.update(spmv=LAUNCHES["spmv"], matmul=LAUNCHES["matmul"],
                    matmul_wgmma=LAUNCHES["matmul_wgmma"])
    for (got, want), k in zip(outs, (610, 4096, 610, 4096, 4096, 610, 4096,
                                     4096)):
        ok, err = compare_product(got, want, k)
        if not ok or not bool(torch.isfinite(got).all()):
            return fail("ops", f"result of shape {tuple(got.shape)} off its "
                        f"plain version by {err}")
    if (launches["spmv"] != 2 or launches["matmul"] != 3
            or launches["matmul_wgmma"] != 3):
        return fail("ops", f"launches {launches}: expected spmv 2, matmul 3 "
                    "(float32, CUDA cores), matmul_wgmma 3 (bfloat16)")
    phase("ops", t, f"spmv x2, gemv x2 and matmul x1 in float32, gemv x2 and "
          f"matmul x1 in bfloat16 through repro_torch.kernels.ops; launches "
          f"spmv {launches['spmv']}, matmul {launches['matmul']}, "
          f"matmul_wgmma {launches['matmul_wgmma']}")

    # ------------------------------------------------------ 6. lm-kernel
    t = time.perf_counter()
    attn_cases: list[dict] = []
    ga = torch.Generator(device=dev).manual_seed(17)
    # the cache lengths of phase 7's last decode step: its prompts (the same
    # draw) plus the tokens decoded before it
    served_lens = (np.random.default_rng(0).integers(
        LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1, size=LM_REQUESTS)
        + LM_NEW_TOKENS - 1)

    def rnd(shape, dt):
        return torch.randn(shape, generator=ga, device=dev).to(dt)

    def attn_case(kernel, label, got, want):
        torch.cuda.synchronize()
        ok, err, lim = attn_compare(got, want)
        attn_cases.append(dict(kernel=kernel, case=label, max_abs_err=err,
                               limit=lim, ok=ok))
        print(f"  {kernel} {label}: max abs err {err:.3g} (limit {lim:.3g})",
              flush=True)
        if not ok:
            raise AssertionError(f"{kernel} {label}: max abs err {err} over "
                                 f"its limit {lim}")

    try:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            flash_shapes = [(1, S, S, 16, 2, 128, True) for S in (8, 100, 1024, 2048)]
            flash_shapes += [(2, 77, 77, H, KV, 64, True)
                             for H, KV in ((8, 8), (8, 2), (16, 2))]
            flash_shapes += [(2, 100, 100, 16, 2, 128, False),
                             (1, 300, 300, 8, 2, 256, True),
                             (1, 70, 70, 8, 2, 100, True),
                             (1, 600, 600, 16, 2, 128, True),
                             (1, 64, 64, 12, 2, 64, True),
                             (1, 70, 70, 8, 2, 320, True),
                             (2, 33, 45, 4, 1, 320, False)]
            # phase 7's other prefills at their largest bucket: olmoe (H =
            # KV = 16), granite (32 / 8), codeqwen (32 / 32) and
            # deepseek-v2's MLA (H = KV = 128, q and k of dh 192)
            flash_shapes += [(1, 1024, 1024, H, KV, dh, True)
                             for H, KV, dh in FAMILY_HEADS]
            # the remaining served heads at their largest bucket: command-r,
            # internvl2, musicgen, and zamba2's shared block at S = 100 and
            # 1024; then a window of PROBE_WINDOW at dh 224 and at qwen's heads
            flash_shapes += [(1, 1024, 1024, H, KV, dh, True)
                             for H, KV, dh in NEW_HEADS]
            flash_shapes += [(1, S, S) + SHARED_HEADS + (True,) for S in (100, 1024)]
            flash_shapes += [(1, 1024, 1024) + heads + (True, PROBE_WINDOW)
                             for heads in (SHARED_HEADS, (16, 2, 128))]
            # internvl2's G 6 at both trained lengths, causal (1,024 is in
            # NEW_HEADS), full and with a window; G 3 and G 5 at dh 64
            flash_shapes += [(1, S, S) + G6_HEADS + (causal, w)
                             for S in (1024, 4096)
                             for causal, w in ((True, 0), (False, 0),
                                               (True, PROBE_WINDOW))
                             if (S, causal, w) != (1024, True, 0)]
            flash_shapes += [(1, 300, 300, 6, 2, 64, True),
                             (1, 257, 257, 10, 2, 64, False)]
            cases = []
            for B, Sq, Sk, H, KV, dh, causal, *win in flash_shapes:
                w = win[0] if win else 0
                q = rnd((B, Sq, H, dh), dt)
                k, v = rnd((B, Sk, KV, dh), dt), rnd((B, Sk, KV, dh), dt)
                cases.append((f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} dh={dh} "
                              f"{'causal' if causal else 'full'}"
                              + (f" window {w}" if w else ""), q, k, v, causal, w))
            # q, k and v as slices of one fused QKV projection (B, S, H + 2 KV,
            # dh): strided views, read in place
            qkv = rnd((2, 1024, 16 + 2 + 2, 128), dt)
            cases.append(("fused QKV view B=2 Sq=Sk=1024 H=16 KV=2 dh=128 "
                          "causal", qkv[:, :, :16], qkv[:, :, 16:18],
                          qkv[:, :, 18:], True, 0))
            # MLA's prefill: v of width 128 zero-padded to q's and k's 192
            qm = rnd((1, 1024, 128, 192), dt)
            km = rnd((1, 1024, 128, 192), dt)
            vm = torch.nn.functional.pad(rnd((1, 1024, 128, 128), dt), (0, 64))
            cases.append(("MLA B=1 Sq=Sk=1024 H=KV=128 dh=192, v of 128 "
                          "zero-padded", qm, km, vm, True, 0))
            for label, q, k, v, causal, w in cases:
                route = flash_route(q, k, v)
                # bfloat16 at a G that does not divide 128 (internvl2's 6,
                # 3, 5) must take the tensor cores' whole-token row tiles
                if (dt == torch.bfloat16 and (q.shape[2] // k.shape[2]) in (3, 5, 6)
                        and route != "wgmma"):
                    raise AssertionError(f"{dname} {label}: flash_route {route}")
                kname = ("flash_attention_wgmma" if route == "wgmma"
                         else "flash_attention")
                # bfloat16 also with attn_probs_bf16's rounding: p against
                # the row's max (a first pass over the keys)
                for rp in ((False, True, torch.bfloat16) if dt == torch.bfloat16
                           else (False, True)):
                    attn_case(kname,
                              f"{dname} {label} p "
                              + ("rounded against the row's max"
                                 if rp is torch.bfloat16
                                 else "rounded" if rp else "fp32"),
                              flash_attention_fused(q, k, v, causal=causal,
                                                    window=w, round_p=rp),
                              flash_attention_ref(q.contiguous(), k.contiguous(),
                                                  v.contiguous(), causal=causal,
                                                  window=w, round_p=rp))
            del cases, qkv, qm, km, vm
            if dt == torch.float32:
                # the model's probs_bf16 at float32 (Queue C item 10): v
                # rounded to bfloat16 before the kernel, p rounded to
                # bfloat16 against the row's max by fa_kernel (mode 3)
                for heads, w in (((16, 2, 128), 0), (SHARED_HEADS, 0),
                                 (SHARED_HEADS, PROBE_WINDOW)):
                    H, KV, dh = heads
                    q = rnd((1, 1024, H, dh), dt)
                    k = rnd((1, 1024, KV, dh), dt)
                    v = rnd((1, 1024, KV, dh), dt).bfloat16().float()
                    attn_case("flash_attention",
                              f"float32 B=1 Sq=Sk=1024 H={H} KV={KV} dh={dh} "
                              f"causal{f' window {w}' if w else ''} p rounded to "
                              "bfloat16 (probs_bf16)",
                              flash_attention_fused(q, k, v, window=w,
                                                    round_p=torch.bfloat16),
                              flash_attention_ref(q, k, v, window=w,
                                                  round_p=torch.bfloat16))
            # decode at qwen2.5-3b's heads: ragged lengths with 1 and S, the
            # lengths of phase 7's last decode step (given on the host and on
            # the card), and every length 1; each case twice, bitwise equal
            B, S = LM_MAX_BATCH, LM_MAX_LEN
            ragged = np.random.default_rng(5).integers(1, S + 1, size=B)
            ragged[0], ragged[-1] = 1, S
            q = rnd((B, 16, 128), dt)
            kc, vc = rnd((B, S, 2, 128), dt), rnd((B, S, 2, 128), dt)
            for name, lens, on_card in (("ragged", ragged, False),
                                        ("served", served_lens, False),
                                        ("served, on the card", served_lens, True),
                                        ("all 1", np.ones(B, np.int64), False)):
                ld = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
                given = ld if on_card else np.asarray(lens, np.int32)
                for rp in (False, True):
                    got = decode_attention(q, kc, vc, given, round_p=rp)
                    again = decode_attention(q, kc, vc, given, round_p=rp)
                    label = (f"{dname} B={B} S={S} H=16 KV=2 dh=128 {name} lens "
                             f"{np.asarray(lens).tolist()} p "
                             f"{'rounded' if rp else 'fp32'}")
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"decode_attention {label}: two "
                                             "calls differ")
                    attn_case("decode_attention", label, got,
                              decode_attention_ref(q, kc, vc, ld, round_p=rp))
            # phase 7's other GQA decodes: olmoe, granite and codeqwen's
            # heads at the served lengths, given on the card as the engine
            # gives them
            ld = torch.from_numpy(np.asarray(served_lens, np.int32)).to(dev)
            for H, KV, dh in FAMILY_HEADS[:3]:
                qf = rnd((B, H, dh), dt)
                kf, vf = rnd((B, S, KV, dh), dt), rnd((B, S, KV, dh), dt)
                for rp in (False, True):
                    attn_case("decode_attention",
                              f"{dname} B={B} S={S} H={H} KV={KV} dh={dh} "
                              f"served lens on the card p "
                              f"{'rounded' if rp else 'fp32'}",
                              decode_attention(qf, kf, vf, ld, round_p=rp),
                              decode_attention_ref(qf, kf, vf, ld, round_p=rp))
                del qf, kf, vf
            # the remaining served heads at the served lengths, zamba2's
            # shared block included: with no window its decode reads a cache
            # of LM_MAX_LEN slots
            for H, KV, dh in NEW_HEADS + (SHARED_HEADS,):
                qf = rnd((B, H, dh), dt)
                kf, vf = rnd((B, S, KV, dh), dt), rnd((B, S, KV, dh), dt)
                for rp in (False, True):
                    attn_case("decode_attention",
                              f"{dname} B={B} S={S} H={H} KV={KV} dh={dh} "
                              f"served lens on the card p "
                              f"{'rounded' if rp else 'fp32'}",
                              decode_attention(qf, kf, vf, ld, round_p=rp),
                              decode_attention_ref(qf, kf, vf, ld, round_p=rp))
                del qf, kf, vf
            # zamba2's shared decode against a ring of RING_WIDTH slots at the
            # served positions (most past its width): valid_len = min(pos +
            # 1, W) on the card; under CUDA's sync debug mode, and captured
            # in a CUDA graph whose replay equals the eager call bitwise
            H, KV, dh = SHARED_HEADS
            ring_lens = np.minimum(served_lens, RING_WIDTH).astype(np.int32)
            lr = torch.from_numpy(ring_lens).to(dev)
            qr = rnd((B, H, dh), dt)
            kr_, vr = rnd((B, RING_WIDTH, KV, dh), dt), rnd((B, RING_WIDTH, KV, dh), dt)
            ring_label = (f"{dname} B={B} ring of {RING_WIDTH} H={H} KV={KV} "
                          f"dh={dh} lens {ring_lens.tolist()} on the card")
            for rp in (False, True):
                attn_case("decode_attention",
                          f"{ring_label} p {'rounded' if rp else 'fp32'}",
                          decode_attention(qr, kr_, vr, lr, round_p=rp),
                          decode_attention_ref(qr, kr_, vr, lr, round_p=rp))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = decode_attention(qr, kr_, vr, lr, round_p=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                decode_attention(qr, kr_, vr, lr, round_p=False)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = decode_attention(qr, kr_, vr, lr, round_p=False)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(captured, eager):
                raise AssertionError(f"decode_attention {ring_label}: the "
                                     "graph's replay differs from the eager call")
            attn_case("decode_attention", f"{ring_label} p fp32, no "
                      "synchronisation, graph replay", captured,
                      decode_attention_ref(qr, kr_, vr, lr, round_p=False))
            del graph, captured, eager, qr, kr_, vr
            # a sliding window on the full-length cache (a dense or MoE
            # config with attn_window): starts max(0, len - W) on the card,
            # at qwen's and zamba2's heads, W of PROBE_WINDOW and 1,024,
            # lengths 1, W - 1, W, W + 1 and S beside served ones; the
            # windowed grid (ceil(W / chunk) + 1 splits), no
            # synchronisation, two calls and a CUDA graph's replay bitwise
            # equal; then a rank's piece of a sequence split over 4 ranks
            # (local lengths and starts, one piece wholly below its start)
            # with the log-sum-exp output
            for H, KV, dh in ((16, 2, 128), SHARED_HEADS):
                qw_ = rnd((B, H, dh), dt)
                kw_, vw_ = rnd((B, S, KV, dh), dt), rnd((B, S, KV, dh), dt)
                for W in WINDOWS:
                    lens = np.array([1, W - 1, W, W + 1, S] + list(served_lens[:3]),
                                    np.int32)
                    ld = torch.from_numpy(lens).to(dev)
                    sd = (ld - W).clamp(min=0)
                    if not plan_decode(B, KV, H // KV, S, dh, dt,
                                       window=W).windowed:
                        raise AssertionError(f"decode W={W}: not a windowed grid")
                    win = dict(cache_start=sd, window=W)
                    label = (f"{dname} B={B} S={S} H={H} KV={KV} dh={dh} window "
                             f"{W} lens {lens.tolist()} on the card")
                    for rp in (False, True):
                        attn_case("decode_attention",
                                  f"{label} p {'rounded' if rp else 'fp32'}",
                                  decode_attention(qw_, kw_, vw_, ld,
                                                   round_p=rp, **win),
                                  decode_attention_ref(qw_, kw_, vw_, ld,
                                                       round_p=rp, **win))
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        eager = decode_attention(qw_, kw_, vw_, ld,
                                                 round_p=False, **win)
                        again = decode_attention(qw_, kw_, vw_, ld,
                                                 round_p=False, **win)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(side):
                        decode_attention(qw_, kw_, vw_, ld, round_p=False, **win)
                    torch.cuda.current_stream(dev).wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        captured = decode_attention(qw_, kw_, vw_, ld,
                                                    round_p=False, **win)
                    graph.replay()
                    torch.cuda.synchronize()
                    if not (torch.equal(eager, again) and torch.equal(captured, eager)):
                        raise AssertionError(f"decode_attention {label}: two calls "
                                             "or the graph's replay differ")
                    attn_case("decode_attention", f"{label} p fp32, no "
                              "synchronisation, two calls and graph replay "
                              "bitwise", captured,
                              decode_attention_ref(qw_, kw_, vw_, ld, **win))
                    Sl = S // 4                  # rank 1's piece of 4
                    pl, ps = (ld - Sl).clamp(0, Sl), (sd - Sl).clamp(0, Sl)
                    kp, vp = kw_[:, Sl:2 * Sl], vw_[:, Sl:2 * Sl]
                    out, lse = decode_attention(qw_, kp, vp, pl, cache_start=ps,
                                                window=W, round_p=False,
                                                return_lse=True)
                    wout, wlse = decode_attention_ref(qw_, kp, vp, pl,
                                                      cache_start=ps, window=W,
                                                      return_lse=True)
                    torch.cuda.synchronize()
                    empty = ps >= pl
                    if not (bool(empty.any()) and not bool(empty.all())
                            and bool(torch.isneginf(lse[empty]).all())
                            and not bool(out[empty].any())):
                        raise AssertionError(f"decode_attention {label}: a piece "
                                             "below its start is not zeros and -inf")
                    lse_err = float((lse[~empty] - wlse[~empty]).abs().max())
                    if not lse_err <= TP_LSE_TOL * max(1.0, float(
                            wlse[~empty].abs().max())):
                        raise AssertionError(f"decode_attention {label}: piece lse "
                                             f"off by {lse_err}")
                    attn_case("decode_attention", f"{label}: rank 1 of 4's piece "
                              f"(local starts {ps.tolist()}), with lse (max abs "
                              f"err {lse_err:.3g})", out, wout)
                    del graph, captured, eager, again, out, lse, wout, wlse
                del qw_, kw_, vw_
            # wider than any config: G = 128 query rows per KV head (two
            # groups of 64) and dh = 320, lengths on the host and the card
            qw = rnd((2, 128, 320), dt)
            kw, vw = rnd((2, 64, 1, 320), dt), rnd((2, 64, 1, 320), dt)
            lw = np.array([64, 33], np.int32)
            for on_card in (False, True):
                given = torch.from_numpy(lw).to(dev) if on_card else lw
                for rp in (False, True):
                    attn_case("decode_attention",
                              f"{dname} B=2 S=64 H=128 KV=1 dh=320 lens "
                              f"{lw.tolist()}{' on the card' if on_card else ''}"
                              f" p {'rounded' if rp else 'fp32'}",
                              decode_attention(qw, kw, vw, given, round_p=rp),
                              decode_attention_ref(qw, kw, vw,
                                                   torch.from_numpy(lw).to(dev),
                                                   round_p=rp))
            # lengths on the card: no synchronisation (CUDA's sync debug
            # mode raises on one), and one call captured in a CUDA graph
            # whose replay equals the eager call bitwise
            ld = torch.from_numpy(np.asarray(served_lens, np.int32)).to(dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = decode_attention(q, kc, vc, ld, round_p=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                decode_attention(q, kc, vc, ld, round_p=False)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = decode_attention(q, kc, vc, ld, round_p=False)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(captured, eager):
                raise AssertionError(f"decode_attention {dname}: the graph's "
                                     "replay differs from the eager call")
            attn_case("decode_attention", f"{dname} B={B} S={S} served lens on "
                      "the card, no synchronisation, graph replay", captured,
                      decode_attention_ref(q, kc, vc, ld, round_p=False))
            del graph, captured
        # the chunked SSD scan (PyTorch ops, as in the reference: no TPU
        # kernel computes it) against its sequential oracle on the card
        ssd_cases = []
        for label, H, P, N in SSD_LAYERS:
            x = rnd((1, 1024, H, P), torch.float32)
            a = -(0.1 + torch.rand((1, 1024, H), generator=ga, device=dev))
            b, c = rnd((1, 1024, N), torch.float32), rnd((1, 1024, N), torch.float32)
            y, _ = ssd_chunked(x, a, b, c, chunk=128)
            want = mamba2_ssd_ref(x, a, b, c)
            torch.cuda.synchronize()
            err, lim = float((y - want).abs().max()), SSD_RTOL * float(want.abs().max())
            ms, timer = device_ms(lambda: ssd_chunked(x, a, b, c, chunk=128), 5)
            ssd_cases.append(dict(case=f"{label} B=1 S=1024 H={H} P={P} N={N}",
                                  max_abs_err=err, limit=lim, ok=err <= lim,
                                  chunked_ms=ms, timer=timer))
            print(f"  ssd_chunked {label} B=1 S=1024 H={H} P={P} N={N} chunk "
                  f"128 vs the sequential scan: max abs err {err:.3g} (limit "
                  f"{lim:.3g}); chunked {ms:.3f} ms on the device ({timer})",
                  flush=True)
            if err > lim:
                raise AssertionError(f"ssd_chunked {label}: max abs err {err} "
                                     f"over its limit {lim}")
            del x, a, b, c, y, want
    except AssertionError as e:
        return fail("lm-kernel", str(e))
    for name in ("flash_attention", "flash_attention_wgmma",
                 "decode_attention"):
        errs = [c["max_abs_err"] for c in attn_cases if c["kernel"] == name]
        checks[name] = {"cases": len(errs), "max_abs_err": max(errs)}
    phase("lm-kernel", t, f"{len(attn_cases)} attention cases within their "
          f"limits of the plain versions; {len(ssd_cases)} SSD scans within "
          f"{SSD_RTOL} x max |y| of the sequential one")

    # ------------------------------------------------------- 7. lm-serve (main)
    t = time.perf_counter()
    spec = get_arch(LM_ARCH)
    rng = np.random.default_rng(0)
    plens = rng.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1, size=LM_REQUESTS)
    prompts = [rng.integers(1, spec.model.vocab_size, size=n).tolist()
               for n in plens]
    lm_runs: list[dict] = []
    launches.update(flash_attention=0, flash_attention_wgmma=0,
                    decode_attention=0)
    prefills = steps_total = 0
    lm_counts = ("flash_attention", "flash_attention_wgmma", "decode_attention")

    def lm_serve(label, cfg, model, prompts, plain_check, timed=True,
                 teacher=True, log_routes=False):
        """Serve ``prompts`` through a fresh engine on ``model``: launches
        counted over the run and checked; with ``timed`` the steady-state
        times, the device split, the host-to-device copies and a decode
        step under CUDA's sync debug mode; with ``teacher`` every served
        token against the teacher-forced argmax, and with ``log_routes``
        (a MoE model, an untimed run) whether each token's position was
        routed alike in the engine and the teacher-forced forward."""
        nonlocal prefills, steps_total
        model.forward_full(np.arange(1, 9, dtype=np.int32)[None, :])  # warm up
        eng = ServeEngine(cfg, model, max_batch=LM_MAX_BATCH,
                          max_len=LM_MAX_LEN, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
        torch.cuda.synchronize()
        for k in lm_counts:
            LAUNCHES[k] = 0
        t1 = time.perf_counter()
        with route_log(log_routes) as eng_log:
            done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = {k: LAUNCHES[k] for k in lm_counts}
        snap = eng.metrics.snapshot()
        steps, decode_s = snap["batches"], snap["device_s"]
        L = attention_layers(cfg)
        # bf16 prefills run on the tensor cores where flash_route takes the
        # heads (every served head, internvl2's G 6 included: its engine
        # launches flash_attention 0 times), float32 on the CUDA cores;
        # MLA's decode is plain PyTorch (no decode kernel takes it)
        H, KV, dh = flash_heads(cfg)
        probe = [torch.empty((1, 1, h, dh), dtype=cfg.adt, device=dev)
                 for h in (H, KV, KV)] if L else None
        flash, other = (("flash_attention_wgmma", "flash_attention")
                        if L and flash_route(*probe) == "wgmma"
                        else ("flash_attention", "flash_attention_wgmma"))
        if (H, KV, dh) == G6_HEADS and cfg.adt == torch.bfloat16 \
                and flash != "flash_attention_wgmma":
            raise AssertionError(f"{label}: G 6 prefill on {flash}")
        want_decode = 0 if cfg.use_mla else L * steps
        print(f"  {label}: {len(done)} requests, {steps} decode steps, "
              f"launches {got} (expected {flash} {L} x {len(done)}, {other} "
              f"0, decode {want_decode})", flush=True)
        if (got[flash] != L * len(done) or got[other] != 0
                or got["decode_attention"] != want_decode
                or len(done) != LM_REQUESTS
                or any(len(r.tokens) != LM_NEW_TOKENS for r in done)):
            raise AssertionError(f"{label}: launches {got}, {len(done)} "
                                 f"requests, {steps} steps")
        for k in lm_counts:
            launches[k] += got[k]
        prefills += len(done)
        steps_total += steps
        n_tok = sum(len(r.tokens) for r in done)
        rec = dict(run=label, arch=cfg.name, dtype=cfg.act_dtype,
                   params=cfg.param_dtype, layers=cfg.n_layers,
                   attention_layers=L,
                   capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
                   requests=len(done), prompt_lens=[len(p) for p in prompts],
                   new_tokens=n_tok, decode_steps=steps, launches=got,
                   wall_s=wall, tokens_per_s=n_tok / wall,
                   decode_ms_per_step=decode_s / steps * 1e3,
                   prefill_ms_per_request=(wall - decode_s) / len(done) * 1e3,
                   final_lens=eng.pos.tolist())
        msg = (f"{n_tok / wall:.1f} tokens/s, prefill "
               f"{rec['prefill_ms_per_request']:.1f} ms/request, decode "
               f"{rec['decode_ms_per_step']:.2f} ms/step at batch "
               f"{LM_MAX_BATCH} (host clock)")
        t2 = time.perf_counter()
        if timed:
            # steady state: one decode step at batch 8, and one prefill of
            # the largest bucket, each warm, median on the host clock
            step = lambda: model.forward_decode(              # noqa: E731
                eng.last_token, eng.caches, eng.pos)
            step_ms = host_median_ms(step, reps=5)
            bucket = bucket_for(max(len(p) for p in prompts), LM_MAX_LEN,
                                floor=8)
            prefill = lambda: model.forward_full(              # noqa: E731
                np.ones((1, bucket), np.int32), return_cache=True)
            pre_ms = host_median_ms(prefill, reps=3)
            # the attention kernels' share of one decode step's and of one
            # prefill's device time, and the device activities of each;
            # one trace of 3 decode steps gives the step's split, its
            # heaviest kernels and the copies it shows
            acts, _ = device_trace(step)
            if acts is None:        # CUDA events, the split not measured
                step_dev, part, step_n = device_split(step, DECODE_PASSES)
                acts = []
            else:
                step_dev, part, step_n = trace_split(acts, DECODE_PASSES, 3)
            attn_ms = sum(part[k] for k in DECODE_PASSES)
            # host-to-device copies of a decode step: tokens and positions
            # in one; the layers' lengths are made on the card from it.
            # Counted at the dispatcher (the trace drops a small copy now
            # and then: ROADMAP Queue C item 8), and the trace may show no
            # more
            htod = htod_ops(step)
            in_trace = trace_htod(acts, 3)
            if htod != 1 or in_trace > 1:
                raise AssertionError(f"{label}: {htod} host-to-device copies "
                                     f"per decode step ({in_trace} in the "
                                     "trace), expected 1")
            # no synchronisation inside a decode step (the MoE dispatch
            # reads nothing back): CUDA's sync debug mode raises on one
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step()
            except RuntimeError as e:
                raise AssertionError(f"{label}: a decode step synchronised: "
                                     f"{e}") from e
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            pre_dev, pre_part, pre_n = device_split(
                prefill, ("fa_kernel", "fa_tc_kernel"))
            flash_ms = pre_part["fa_kernel"] + pre_part["fa_tc_kernel"]
            b_bytes, b_ms = decode_bound(model, eng.pos + 1)
            top = trace_top(acts, 3)
            rec.update(decode_ms_steady=step_ms, prefill_bucket=bucket,
                       prefill_ms_bucket=pre_ms,
                       decode_step_device_ms=step_dev,
                       decode_attention_device_ms=attn_ms,
                       decode_attention_pass_ms={k: part[k]
                                                 for k in DECODE_PASSES},
                       attention_share=attn_ms / step_dev,
                       decode_step_device_activities=step_n,
                       decode_step_htod_copies=htod,
                       decode_step_htod_in_trace=in_trace,
                       decode_step_sync_free=True,
                       decode_step_bound_bytes=b_bytes,
                       decode_step_bound_ms=b_ms,
                       decode_step_top_kernels=top,
                       prefill_device_ms=pre_dev,
                       prefill_flash_device_ms=flash_ms,
                       prefill_device_activities=pre_n)
            msg += (f" (warm: {step_ms:.2f} ms/step, prefill of {bucket} "
                    f"tokens {pre_ms:.1f} ms); decode step device "
                    f"{step_dev:.3f} ms against a bytes bound of {b_ms:.3f} ms "
                    f"({b_bytes / 1e9:.2f} GB over {HBM_BYTES_PER_S / 1e12} "
                    f"TB/s), attention {attn_ms:.3f} ms "
                    f"({attn_ms / step_dev:.1%}: " + ", ".join(
                        f"{k} {part[k]:.3f}" for k in DECODE_PASSES)
                    + f"), {step_n:.0f} device activities ({htod:.0f} "
                    f"host-to-device copy, no synchronisation); prefill of "
                    f"{bucket} tokens device {pre_dev:.3f} ms, flash "
                    f"{flash_ms:.3f} ms, {pre_n:.0f} activities; a decode "
                    f"step's heaviest kernels: " + "; ".join(
                        f"{name[:60]} {ms:.3f} ms x{k:.0f}"
                        for name, ms, k in top))
        t3 = time.perf_counter()
        if teacher:
            n_pos, worse, diff, flipped, n_alike = teacher_forced(
                model, done, cfg.vocab_size, plain_check,
                engine_routes(eng_log, done, L) if log_routes else None)
            rec.update(positions=n_pos, disagreements=worse,
                       agreement=1 - len(worse) / n_pos, plain_logit_diff=diff,
                       route_flips=flipped)
            if n_alike is not None:
                miss = sum(1 for w in worse if w["routed_alike"])
                rec.update(routed_alike=n_alike,
                           agreement_routed_alike=1 - miss / n_alike)
                msg = (f"{n_alike}/{n_pos} positions routed alike in every "
                       f"layer in both runs, {n_alike - miss} of them served "
                       f"the teacher-forced argmax; " + msg)
            for w in worse:
                print(f"    request {w['rid']} token {w['step']}: served "
                      f"{w['served']}, teacher-forced argmax {w['argmax']}, "
                      f"top-2 gap {w['top2_gap']:.3g}, argmax leads the served "
                      f"token by {w['served_gap']:.3g}" + (
                          "" if w["routed_alike"] is None else
                          ", routed alike" if w["routed_alike"] else
                          ", routed otherwise"))
            for f in flipped:
                print(f"    request {f['rid']}: the router chose otherwise in "
                      f"layer {f['layer']} at tokens {f['tokens'][:8]} (gate "
                      f"gaps {[round(g, 8) for g in f['gaps'][:8]]}); logits "
                      f"{f['diff']:.3g} apart")
            msg = (f"{n_pos - len(worse)}/{n_pos} served tokens equal the "
                   f"teacher-forced argmax; " + ("" if diff is None else
                   f"logits vs plain-attention forward max abs diff "
                   f"{diff:.3g}; ") + msg)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec.update(timed_s=t3 - t2, teacher_s=time.perf_counter() - t3)
        print(f"  {label}: {msg}; peak {rec['peak_gib']:.1f} GiB; seconds: "
              f"served {wall:.1f}, timed {rec['timed_s']:.1f}, teacher-forced "
              f"{rec['teacher_s']:.1f}", flush=True)
        lm_runs.append(rec)
        return eng, rec

    def check_f32(label, rec):
        bad = [w for w in rec["disagreements"] if w["served_gap"] >= LM_F32_GAP]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} served tokens differ "
                                 f"from the teacher-forced argmax by more than "
                                 f"a near-tie ({LM_F32_GAP}): {bad[:4]}")
        if (rec["plain_logit_diff"] is not None
                and not rec["plain_logit_diff"] <= LM_F32_ATOL):
            raise AssertionError(f"{label}: logits off the plain-attention "
                                 f"forward by {rec['plain_logit_diff']}")
        for f in rec["route_flips"]:
            if f["diff"] > LM_F32_ATOL and not max(f["gaps"]) < ROUTE_TIE:
                raise AssertionError(f"{label}: logits off the plain-attention "
                                     f"forward by {f['diff']} where the router "
                                     f"chose otherwise beyond a near-tie: {f}")

    def check_ties(label, rec):
        """A bf16 run of LM_BF16_TIES under LM_BF16_AGREE: every
        disagreement a rounding tie, its served gap within ``tie``."""
        beyond = [w for w in rec["disagreements"]
                  if not w["served_gap"] <= w["tie"]]
        print(f"  {label}: agreement {rec['agreement']:.4f} < {LM_BF16_AGREE}; "
              "served gap / one-ulp tie grain by disagreement: "
              + ", ".join(f"{w['served_gap']:.3g}/{w['tie']:.3g}"
                          for w in rec["disagreements"])
              + f"; beyond it: {len(beyond)}", flush=True)
        if beyond:
            raise AssertionError(f"{label}: teacher-forced agreement "
                                 f"{rec['agreement']:.3f} < {LM_BF16_AGREE} and "
                                 f"{len(beyond)} disagreements beyond a "
                                 f"rounding tie: {beyond[:4]}")

    def prefix_check(label, cfg, model, prompt):
        """One ``forward_full`` of ``prompt`` behind a seeded prefix of
        ``vision_prefix_len`` embeddings (N(0, 0.02²), internvl2's patch
        stub): finite logits of Np + S positions, one flash launch per
        layer, and each launch's output within ``attn_compare``'s limit of
        its plain version on the same inputs (``flash_check``)."""
        gp = torch.Generator(device=dev).manual_seed(21)
        Np = cfg.vision_prefix_len
        prefix = (0.02 * torch.randn((1, Np, cfg.d_model), generator=gp,
                                     device=dev)).to(cfg.adt)
        toks = np.asarray(prompt, np.int32)[None, :]
        before = {k: LAUNCHES[k] for k in lm_counts}
        with flash_check() as held:
            lk, _, _ = model.forward_full(toks, prefix_embeds=prefix)
        torch.cuda.synchronize()
        got = sum(LAUNCHES[k] - before[k] for k in lm_counts)
        S = Np + toks.shape[1]
        worst = max(held, key=lambda c: c[1] / c[2])
        out = dict(prefix=Np, tokens=toks.shape[1], launches=got,
                   shape=list(lk.shape), finite=bool(torch.isfinite(lk).all()),
                   flash_held=len(held), flash_within=sum(c[0] for c in held),
                   flash_max_err=worst[1], flash_limit=worst[2])
        print(f"  {label}: a {Np}-row prefix before a {toks.shape[1]}-token "
              f"prompt: logits {tuple(lk.shape)}, {got} flash launches, "
              f"{out['flash_within']}/{len(held)} flash outputs within one "
              f"bf16 ulp of their plain versions on the same inputs (worst "
              f"{worst[1]:.3g} against {worst[2]:.3g})", flush=True)
        if (tuple(lk.shape) != (1, S, cfg.padded_vocab) or not out["finite"]
                or got != cfg.n_layers or len(held) != cfg.n_layers
                or out["flash_within"] != len(held)):
            raise AssertionError(f"{label}: prefix check {out}")
        del lk
        return out

    try:
        t1 = time.perf_counter()
        cfg32 = dataclasses.replace(spec.model, act_dtype="float32",
                                    param_dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg32, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        eng, rec = lm_serve("float32", cfg32, model, prompts, plain_check=True)
        rec["init_s"] = init_s
        check_f32("float32", rec)
        lens32 = rec["final_lens"]
        del model, eng
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cfg16 = spec.cell_config(SHAPES["decode_32k"])
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg16, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        eng, rec = lm_serve("bfloat16", cfg16, model, prompts, plain_check=False)
        rec["init_s"] = init_s
        if rec["agreement"] < LM_BF16_AGREE:
            raise AssertionError(f"bfloat16: teacher-forced agreement "
                                 f"{rec['agreement']:.3f} < {LM_BF16_AGREE}")
        lens16 = rec["final_lens"]
        del model, eng
        torch.cuda.empty_cache()

        # a sliding window on the full-length cache: qwen2.5-3b at every
        # width, LM_WINDOW_LAYERS of its 36 layers, attn_window
        # PROBE_WINDOW, the same traffic; float32 timed (one host-to-device
        # copy a step, no synchronisation) and held as run 1, bfloat16 as
        # run 2; the teacher-forced forward and its plain twin cut the same
        # window
        for base in (cfg32, cfg16):
            cfgw = dataclasses.replace(base, n_layers=LM_WINDOW_LAYERS,
                                       attn_window=PROBE_WINDOW)
            f32 = cfgw.act_dtype == "float32"
            label = (f"{LM_ARCH} x{LM_WINDOW_LAYERS} {cfgw.act_dtype} window "
                     f"{PROBE_WINDOW}")
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            model = init_params(cfgw, 0, dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t1
            eng, rec = lm_serve(label, cfgw, model, prompts, plain_check=f32,
                                timed=f32)
            rec.update(init_s=init_s, window=PROBE_WINDOW,
                       full_layers=spec.model.n_layers)
            if f32:
                check_f32(label, rec)
            elif rec["agreement"] < LM_BF16_AGREE:
                raise AssertionError(f"{label}: teacher-forced agreement "
                                     f"{rec['agreement']:.3f} < {LM_BF16_AGREE}")
            del model, eng
            torch.cuda.empty_cache()

        # the dense and MoE families at full width: the same prompt lengths,
        # tokens drawn from the same seed within each vocabulary
        fam_lens: dict[str, list] = {}
        for arch, dtype, layers in LM_FAMILY_ENGINES:
            fspec = get_arch(arch)
            cfg = (dataclasses.replace(fspec.model, act_dtype="float32",
                                       param_dtype="float32")
                   if dtype == "float32"
                   else fspec.cell_config(SHAPES["decode_32k"]))
            label = f"{arch} {dtype}"
            if layers is not None:
                print(f"  {label}: depth cut to {layers} of {cfg.n_layers} "
                      "layers, every width kept", flush=True)
                cfg = dataclasses.replace(cfg, n_layers=layers)
            r = np.random.default_rng(0)
            r.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1, size=LM_REQUESTS)
            fprompts = [r.integers(1, cfg.vocab_size, size=n).tolist()
                        for n in plens]
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            model = init_params(cfg, 0, dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t1
            moe_arch = cfg.family == "moe"
            f32 = dtype == "float32"
            eng, rec = lm_serve(label, cfg, model, fprompts,
                                plain_check=f32 and not moe_arch
                                and cfg.family != "ssm", teacher=not moe_arch)
            rec.update(init_s=init_s, full_layers=fspec.model.n_layers)
            fam_lens[label] = rec["final_lens"]
            if cfg.vision_prefix_len:
                rec["prefix"] = prefix_check(label, cfg, model, fprompts[0])
            if not moe_arch and f32:
                check_f32(label, rec)
            elif not moe_arch:
                if rec["agreement"] < LM_BF16_AGREE:
                    if arch not in LM_BF16_TIES:
                        raise AssertionError(f"{label}: teacher-forced "
                                             f"agreement {rec['agreement']:.3f}"
                                             f" < {LM_BF16_AGREE}")
                    check_ties(label, rec)
            else:
                # the served capacity: each prefill bucket's dropped copies
                # and, in float32, its logits with the kernels against the
                # same bucket with their plain versions
                buckets = bucket_check(model, fprompts, plain=f32)
                rec["buckets"] = buckets
                for b in buckets:
                    print(f"    bucket {b['bucket']} (request {b['rid']}): "
                          f"capacity {b['cap']}, dropped copies by layer "
                          f"{b['dropped']} of {b['copies']} a layer"
                          + ("" if not f32 else f"; logits vs plain versions "
                             f"max abs diff {b['diff']:.3g}"), flush=True)
                    if f32 and b["diff"] > LM_F32_ATOL and not (
                            b["flips"] and max(b["flips"]["gaps"]) < ROUTE_TIE):
                        raise AssertionError(
                            f"{label}: bucket {b['bucket']} logits off the "
                            f"plain versions by {b['diff']} (router flips "
                            f"{b['flips']})")
                # a copy with every copy kept: there teacher forcing is an
                # oracle (a longer input drops no other copies)
                nd = nodrop(cfg)
                tf_lens = [len(p) + LM_NEW_TOKENS for p in fprompts]
                for T in ([bucket_for(n, LM_MAX_LEN, floor=8) for n in plens]
                          + tf_lens + [LM_MAX_BATCH]):
                    if capacity(T, nd.experts_per_token, nd.n_experts,
                                nd.capacity_factor) < T:
                        raise AssertionError(f"{label}: the no-drop copy "
                                             f"drops at {T} tokens")
                model.cfg = nd
                eng2, rec2 = lm_serve(f"{label} no-drop (capacity factor "
                                   f"{nd.capacity_factor:.4g})", nd, model,
                                   fprompts, plain_check=f32, timed=False,
                                   log_routes=not f32)
                model.cfg = cfg
                del eng2
                rec["no_drop"] = rec2["run"]
                if f32:
                    check_f32(rec2["run"], rec2)
                elif rec2["agreement_routed_alike"] < LM_BF16_AGREE:
                    raise AssertionError(
                        f"{rec2['run']}: teacher-forced agreement "
                        f"{rec2['agreement_routed_alike']:.3f} < "
                        f"{LM_BF16_AGREE} where both runs routed alike")
            del model, eng
            torch.cuda.empty_cache()
    except AssertionError as e:
        return fail("lm-serve", str(e))
    phase("lm-serve", t, f"qwen2.5-3b, {spec.model.n_layers} layers, float32 "
          f"and bfloat16; " + ", ".join(
              f"{a} {d}" + (f" ({n} layers)" if n else "")
              for a, d, n in LM_FAMILY_ENGINES)
          + f"; {prefills} prefills, {steps_total} decode steps; "
          f"launches flash {launches['flash_attention']} (CUDA cores: float32 "
          f"and internvl2's G 6), {launches['flash_attention_wgmma']} "
          f"(bfloat16, tensor cores), decode "
          f"{launches['decode_attention']}; bf16 products with an fp32 result "
          f"via {MM_F32_ROUTE.get('bfloat16', 'none')}")

    # ------------------------------------------------------- 8. front (main)
    t = time.perf_counter()
    front: dict = {"trained": [], "tiny": [], "served": []}
    front_timed: list[dict] = []

    def check_segment(label, seg, xs):
        """The segment against its plain version on ``xs``; grid ==
        per-sample bitwise.  Returns (max abs err, 1-LSB count)."""
        grid = mk.run_segment_grid(seg, xs)
        per = [mk.run_segment(seg, [x[i] for x in xs])
               for i in range(int(xs[0].shape[0]))]
        plain = run_segment_grid_ref(seg, xs)
        torch.cuda.synchronize()
        for j, g in enumerate(grid):
            if not torch.equal(g, torch.stack([p[j] for p in per])):
                raise AssertionError(f"{label}: grid vs per-sample differ on "
                                     f"output {seg.out_refs[j]}")
        ok, err, lsb = compare(seg, grid, plain)
        if not ok:
            raise AssertionError(f"{label}: kernel vs plain out of tolerance "
                                 f"(max abs err {err}, 1-LSB count {lsb})")
        return err, lsb

    def time_engine(label, eng, X, prec):
        """Serving rate on the host clock; the segment's device time, plain
        version and bound; its share of a bucket; a bucket's device time
        (its input already on the card) and the islands' share of it (the
        islands replayed alone on the inputs the bucket gives them)."""
        (seg,) = eng.program.plan.megakernel.segments
        xs, islands = walk_plan(eng.program, np.ascontiguousarray(X[:BUCKET]))
        wall = statistics.median(serve_wall_s(eng, X) for _ in range(3))
        buckets = len(X) // BUCKET
        d_ms, timer = device_ms(lambda: mk.run_segment_grid(seg, xs), reps=50)
        call_ms = median_ms(lambda: mk.run_segment_grid(seg, xs), reps=50)
        p_ms, _ = device_ms(lambda: run_segment_grid_ref(seg, xs), reps=3,
                            warm=1)
        b_ms, b_by = bound_ms(seg, BUCKET, prec)
        xb = torch.from_numpy(np.ascontiguousarray(X[:BUCKET])).to(dev)
        name = next(iter(eng.program.dfg.graph_inputs))
        tot, part, n_act = device_split(
            lambda: eng.batched(**{name: xb}), (MK_KERNEL,), reps=5)
        isl_ms = (device_ms(lambda: [torch.func.vmap(st.fn)(*a)
                                     for st, a in islands], reps=20)[0]
                  if islands else 0.0)
        bucket_ms = wall / buckets * 1e3
        rec = dict(bench=label, precision=prec, ms=d_ms, timer=timer,
                   call_ms=call_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                   serve_rps=len(X) / wall, serve_bucket_ms=bucket_ms,
                   device_busy=buckets * d_ms / (wall * 1e3),
                   bucket_device_ms=tot, bucket_kernel_ms=part[MK_KERNEL],
                   bucket_activities=n_act, islands=len(islands),
                   islands_ms=isl_ms, islands_share=isl_ms / tot)
        print(f"  megakernel {label} {prec}: bucket of {BUCKET}: segment "
              f"{d_ms:.5f} ms on the device ({timer}), {call_ms:.4f} ms per "
              f"call, plain {p_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}); "
              f"served {len(X) / wall:.0f} requests/s, {bucket_ms:.3f} ms per "
              f"bucket on the host clock, segment {d_ms / bucket_ms:.1%} of "
              f"it; a bucket's device time {tot:.5f} ms over {n_act:.0f} "
              f"activities, of which the megakernel {part[MK_KERNEL]:.5f} ms "
              f"and {len(islands)} islands {isl_ms:.5f} ms "
              f"({rec['islands_share']:.1%})", flush=True)
        return rec

    # (label, precision, lane, engine, requests, the interpret-lane program
    # to agree with or None, launches per bucket)
    serve_front = []
    try:
        # -- trained Table-I programs: train on the card, compile, check
        for bench in TRAINED:
            algo, ds = bench.split("/")
            mod = bonsai if algo == "bonsai" else protonn
            t1 = time.perf_counter()
            _, params, cfg = build(bench, trained=True)   # train: the card
            train_s = time.perf_counter() - t1
            Xtr, ytr, Xte, yte = make_dataset(get_spec(ds), n_train=TRAIN_SPLIT,
                                              seed=0)
            rec = dict(bench=bench, train_s=train_s, steps=120, rows=len(Xtr),
                       train_acc=mod.accuracy(params, cfg, Xtr, ytr),
                       test_acc=mod.accuracy(params, cfg, Xte, yte))
            progs = {}
            for prec in ("float32", "int8"):
                calib = None if prec == "float32" else Xtr[:TRAINED_CALIB]
                for lane, kw in (("megakernel_grid",
                                  dict(exec_mode="megakernel_grid")),
                                 ("use_pallas", dict(use_pallas=True)),
                                 ("interpret", {})):
                    dfg = mod.build_dfg(params, cfg,
                                        name=bench.replace("/", "_"))
                    progs[prec, lane] = MafiaCompiler(
                        precision=prec, device=dev, **kw).compile(dfg,
                                                                  calib=calib)
                prog = progs[prec, "megakernel_grid"]
                mkp = prog.plan.megakernel
                if mkp.n_islands or len(mkp.segments) != 1:
                    raise AssertionError(f"trained {bench}/{prec}: "
                                         f"{mkp.summary()}")
                rec[f"{prec}_segment_err"], _ = check_segment(
                    f"trained {bench}/{prec}", mkp.segments[0],
                    [bucket_inputs(prog, seed=1)[1]])
                steps = [s for s in progs[prec, "use_pallas"].plan.steps
                         if isinstance(s, ChainStep)]
                for i, step in enumerate(steps):
                    check_chain(f"trained {bench}/{prec} chain {i}",
                                *chain_case(progs[prec, "use_pallas"], step,
                                            seed=i))
                rec[f"{prec}_chains"] = len(steps)
                pred = prog.batch(BUCKET)(x=Xte)["Pred"].reshape(-1).cpu().numpy()
                rec[f"{prec}_test_acc_served"] = float((pred == yte).mean())
                eng = ClassicalServeEngine(prog, max_batch=BUCKET)
                X = requests(eng)
                serve_front.append((bench, prec, "megakernel_grid", eng, X,
                                    progs[prec, "interpret"], 1))
                eng = ClassicalServeEngine(progs[prec, "use_pallas"],
                                           max_batch=BUCKET)
                serve_front.append((bench, prec, "use_pallas", eng, X,
                                    progs[prec, "interpret"], len(steps)))
            rec["int8_drop"] = (rec["float32_test_acc_served"]
                                - rec["int8_test_acc_served"])
            print(f"  trained {bench}: {train_s:.2f} s for 120 steps on "
                  f"{len(Xtr)} rows (the card), train accuracy "
                  f"{rec['train_acc']:.4f}, test accuracy {rec['test_acc']:.4f}"
                  f"; served test accuracy float32 "
                  f"{rec['float32_test_acc_served']:.4f}, int8 "
                  f"{rec['int8_test_acc_served']:.4f} (drop "
                  f"{rec['int8_drop']:+.4f}); chains float32 "
                  f"{rec['float32_chains']}, int8 {rec['int8_chains']}; "
                  "segments and chains within tolerance of their plain "
                  "versions", flush=True)
            front["trained"].append(rec)

        # -- MLPerf-Tiny through the ONNX importer: hybrids with islands
        for name in mt.WORKLOADS:
            calib = {"input": mt.sample_inputs(name, 128, seed=7)}
            x_eval = mt.sample_inputs(name, SERVE_REQUESTS)
            f32 = MafiaCompiler(exec_mode="megakernel_grid",
                                device=dev).compile(mt.build(name))
            labels = mt.teacher_labels(f32, x_eval)   # per-sample lane
            for prec, pc in (("float32", False), ("int8", False),
                             ("int8", True)):
                label = f"{name} {prec}" + (" per-channel" if pc else "")
                prog = f32 if prec == "float32" else MafiaCompiler(
                    precision=prec, per_channel=pc, exec_mode="megakernel_grid",
                    device=dev).compile(mt.build(name), calib=calib)
                interp = MafiaCompiler(precision=prec, per_channel=pc,
                                       device=dev).compile(
                    mt.build(name), calib=None if prec == "float32" else calib)
                mkp = prog.plan.megakernel
                if len(mkp.segments) != 1 or mkp.n_islands != TINY_ISLANDS[name]:
                    raise AssertionError(f"{label}: {mkp.summary()}")
                (seg,) = mkp.segments
                places = mk.pack_segment(seg)["placements"]
                print(f"  {label}: {mkp.summary()}; matrices " + ", ".join(
                    f"{'x'.join(map(str, np.shape(seg.matrices[mi])))} {pl}"
                    for mi, pl in places.items()), flush=True)
                xs, _ = walk_plan(prog, x_eval[:BUCKET])
                err, lsb = check_segment(label, seg, xs)
                out = next(iter(prog.batch(BUCKET)(input=x_eval).values()))
                ref = next(iter(interp.batch(BUCKET)(input=x_eval).values()))
                torch.cuda.synchronize()
                d = (out.double() - ref.double()).abs()
                if prec == "float32":
                    lane_ok = bool(torch.allclose(out, ref, rtol=F32_RTOL,
                                                  atol=F32_ATOL))
                    n_lsb = 0
                else:
                    (e_out,) = prog.plan.output_exps.values()
                    lane_ok = bool((d <= 2.0 ** -e_out).all())
                    n_lsb = int((d > 0).sum())
                pred = out.argmax(-1).cpu().numpy()
                drop = 1.0 - float((pred == labels).mean())
                finite = bool(torch.isfinite(out).all())
                rec = dict(program=name, precision=prec, per_channel=pc,
                           summary=mkp.summary(), placements={
                               "x".join(map(str, np.shape(seg.matrices[mi]))): pl
                               for mi, pl in places.items()},
                           segment_err=err, segment_lsb_1=lsb,
                           lane_max_abs_err=float(d.max()), lane_lsb_1=n_lsb,
                           teacher_agree=1.0 - drop, drop=drop, finite=finite)
                front["tiny"].append(rec)
                print(f"  {label}: segment within tolerance of its plain "
                      f"version (max abs err {err:.3g}), grid == per-sample; "
                      f"program vs interpret lane max abs err "
                      f"{float(d.max()):.3g} ({n_lsb} elements off by 1 LSB)"
                      f"; argmax agreement with the float32 teacher "
                      f"{1.0 - drop:.4f} (drop {drop:.4f}, limit "
                      f"{INT8_MAX_DROP})", flush=True)
                if not (lane_ok and finite and out.shape == ref.shape):
                    raise AssertionError(f"{label}: program vs interpret lane "
                                         f"max abs err {float(d.max())}")
                if drop > INT8_MAX_DROP:
                    raise AssertionError(f"{label}: accuracy drop {drop:.4f} "
                                         f"> {INT8_MAX_DROP}")
                # islands on the card copy nothing to the host: one bucket
                # with its input on the card under CUDA's sync debug mode
                xb = torch.from_numpy(x_eval[:BUCKET]).to(dev)
                batched = prog.batch(BUCKET)
                batched(input=xb)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    batched(input=xb)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                print(f"  {label}: a bucket on the card under CUDA's sync "
                      "debug mode: no synchronisation", flush=True)
                eng = ClassicalServeEngine(prog, max_batch=BUCKET)
                on_dev, calls = htod_copies(lambda: eng.batched(
                    input=x_eval[:BUCKET]))
                print(f"  {label}: a bucket from the host makes {calls:g} "
                      f"host-to-device copy call(s) ({on_dev:g} in the trace)",
                      flush=True)
                if calls != 1 or on_dev > 1:
                    raise AssertionError(f"{label}: {calls} host-to-device "
                                         f"copy calls in a bucket ({on_dev} in "
                                         "the trace), expected 1 (the input)")
                rec["bucket_htod_copies"] = calls
                serve_front.append((name + (" per-channel" if pc else ""),
                                    prec, "megakernel_grid", eng, x_eval,
                                    None, 1))

        # -- serving: launches over these runs only
        LAUNCHES["megakernel"] = 0
        LAUNCHES["linear_chain"] = LAUNCHES["linear_chain_q"] = 0
        want = {"megakernel": 0, "linear_chain": 0, "linear_chain_q": 0}
        finished = []
        for label, prec, lane, eng, X, interp, n in serve_front:
            kname = ("megakernel" if lane == "megakernel_grid" else
                     "linear_chain" if prec == "float32" else "linear_chain_q")
            want[kname] += n * (len(X) // BUCKET)
            for row in X:
                eng.submit(row)
            finished.append(eng.run_to_completion())
        torch.cuda.synchronize()
        got = {k: LAUNCHES[k] for k in want}
        print(f"  served {len(serve_front)} engines x {SERVE_REQUESTS} "
              f"requests: launches {got} (expected {want}: segments or chains "
              f"x {SERVE_REQUESTS // BUCKET} buckets)", flush=True)
        if got != want:
            raise AssertionError(f"launches {got}, expected {want}")
        for k in want:
            launches[k] += got[k]
        for (label, prec, lane, eng, X, interp, n), done in zip(serve_front,
                                                               finished):
            if len(done) != len(X):
                raise AssertionError(f"{label} {prec} {lane}: {len(done)} of "
                                     f"{len(X)} requests served")
            if interp is not None:     # trained: predictions vs interpret
                want_p = interp.batch(BUCKET)(x=X)["Pred"].reshape(-1).cpu()
                n_ok = sum(int(r.pred == int(w)) for r, w in zip(done, want_p))
                front["served"].append(dict(lane=lane, bench=label,
                                            precision=prec, agree=n_ok,
                                            requests=len(done)))
                print(f"  {lane} trained {label} {prec}: {n_ok}/{len(done)} "
                      "predictions agree with the interpret lane", flush=True)
                if n_ok < 0.99 * len(done):
                    raise AssertionError(f"{label} {lane}: {n_ok}/{len(done)} "
                                         "agree with the interpret lane")
            else:
                out = np.stack([next(iter(r.outputs.values())) for r in done])
                direct = next(iter(eng.program.batch(BUCKET)(
                    input=X).values())).cpu().numpy()
                if not (np.isfinite(out).all() and np.array_equal(out, direct)):
                    raise AssertionError(f"{label} {prec}: served outputs "
                                         "differ from the program's")
        for label, prec, lane, eng, X, interp, n in serve_front:
            if lane == "megakernel_grid":
                front_timed.append(time_engine(label, eng, X, prec))
    except AssertionError as e:
        return fail("front", str(e))
    phase("front", t, f"{len(TRAINED)} programs trained on the card; "
          f"{len(front['tiny'])} MLPerf-Tiny program x precision cases with "
          f"islands; {len(serve_front)} engines served; launches "
          f"megakernel {got['megakernel']}, chains "
          f"{got['linear_chain'] + got['linear_chain_q']}")

    # ------------------------------------------------------------ 9. store
    t = time.perf_counter()
    import tempfile

    try:
        with tempfile.TemporaryDirectory(prefix="mafia-store-") as tmp:
            store_rec, store_launches = store_phase(dev, tmp)
    except AssertionError as e:
        return fail("store", str(e))
    for k, v in store_launches.items():
        launches[k] = launches.get(k, 0) + v
    phase("store", t, f"{len(STORE_ENGINES)} engines compiled into a store "
          f"and restored in a fresh process (in "
          f"{store_rec['child_s']:.2f} s); profile "
          f"{store_rec['profile']['seconds']:.2f} s; launches "
          f"{store_launches}")

    # -------------------------------------------------------- 10. lm-train
    t = time.perf_counter()
    try:
        train_rec, bwd_checks, train_launches = train_phase(dev)
        checks.update(bwd_checks)
    except AssertionError as e:
        return fail("lm-train", str(e))
    full, f32, probs = train_rec["full"], train_rec["full_f32"], train_rec["full_probs"]
    n_tc = sum(c["route"] == "wgmma" for c in train_rec["bwd_cases"])
    phase("lm-train", t, f"{len(train_rec['bwd_cases'])} forward and backward "
          f"cases ({n_tc} of them on the tensor-core backward) within "
          f"their limits, two calls bitwise equal; the float32 twin within "
          f"its limits; "
          f"{train_rec['moe']['config']} trained; "
          + "".join(f"{r['config']}: {r['seconds']:.3f} s a step, "
                    f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gib']:.2f} "
                    "GiB; " for r in train_rec["families"] if r["trained"])
          + "".join(f"{r['config']}: {r['seconds']:.3f} s a step, "
                    f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gib']:.2f} "
                    f"GiB, flash backward {r['flash_bwd_ms'] / r['device_ms']:.1%} "
                    "of a traced step; " for r in (f32, full, probs))
          + "resume bitwise; launches "
          f"{train_launches}")

    # ------------------------------------------------------------- 11. dist
    t = time.perf_counter()
    try:
        dist_rec, dist_launches = dist_phase(dev)
    except AssertionError as e:
        return fail("dist", str(e))
    dist_rec["seconds"] = time.perf_counter() - t
    phase("dist", t, f"{LM_ARCH} x{DIST_LAYERS} S={DIST_S} on a one-rank mesh: "
          f"fp32 ({dist_rec['fp32']['leaves']} leaves) and int8_ef "
          f"({dist_rec['int8_ef']['leaves']} leaves) bitwise equal to their "
          f"references; a step {dist_rec['mesh_step_s']:.4f} s on the mesh, "
          f"{dist_rec['plain_step_s']:.4f} s without; "
          f"{sum(dist_rec['dryrun']['counts'].values())} dry-run cells; "
          f"launches {dist_launches}")

    # --------------------------------------------------------------- 12. tp
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="mafia-tp-") as tmp:
            tp_rec, tp_launches = tp_phase(dev, tmp)
    except AssertionError as e:
        return fail("tp", str(e))
    tp_rec["seconds"] = time.perf_counter() - t
    phase("tp", t, f"{LM_ARCH} x{TP_LAYERS} float32 trained at (data 1, model "
          f"2) within the limits of the one-process step; "
          + "; ".join(f"{c['arch']} x{c['layers']} served at model {c['model']}"
                      f" (cache over {c['cache']}): agreement "
                      f"{c['agreement']:.4f}" for c in tp_rec["serve"])
          + f"; ranks as processes on this card over gloo; launches "
          f"{tp_launches}")

    # ----------------------------------------------------------- 13. tp-moe
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="mafia-tpm-") as tmp:
            tpm_rec, tpm_launches = tpm_phase(dev, tmp)
    except AssertionError as e:
        return fail("tp-moe", str(e))
    tpm_rec["seconds"] = time.perf_counter() - t
    for k, n in tpm_launches.items():
        tp_launches[k] = tp_launches.get(k, 0) + n
    phase("tp-moe", t, f"{TPM_TRAIN[0]} x{TPM_TRAIN[1]} float32 trained at "
          f"(data 1, model 2), experts split; "
          + "; ".join(f"{c['arch']} x{c['layers']} served at model {c['model']}"
                      f" (cache over {c['cache']}): no-drop agreement "
                      f"{c['agreement_routed_alike']:.4f}"
                      for c in tpm_rec["serve"])
          + f"; launches {tpm_launches}")

    # ----------------------------------------------------------- 14. tp-ssm
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="mafia-tps-") as tmp:
            tps_rec, tps_launches = tps_phase(dev, tmp)
    except AssertionError as e:
        return fail("tp-ssm", str(e))
    tps_rec["seconds"] = time.perf_counter() - t
    for k, n in tps_launches.items():
        tp_launches[k] = tp_launches.get(k, 0) + n
    phase("tp-ssm", t, "; ".join(
        f"{a} x{n} float32 trained at (data 1, model 2)" for a, n in TPS_TRAIN)
          + " within the limits of the one-process step; "
          + "; ".join(f"{c['arch']} x{c['layers']} served at model {c['model']}"
                      f": agreement {c['agreement']:.4f}"
                      for c in tps_rec["serve"])
          + f"; launches {_nonzero(tps_launches)}")

    # ------------------------------------------------------------ 15. tp-dp
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="mafia-tpd-") as tmp:
            tpd_rec, tpd_launches = tpd_phase(dev, tmp)
    except AssertionError as e:
        return fail("tp-dp", str(e))
    tpd_rec["seconds"] = time.perf_counter() - t
    for k, n in tpd_launches.items():
        tp_launches[k] = tp_launches.get(k, 0) + n
    phase("tp-dp", t, "; ".join(
        f"{c['arch']} x{c['layers']} served at (data, model) {c['mesh']}: "
        + (f"no-drop agreement {c['agreement_routed_alike']:.4f}"
           if "agreement_routed_alike" in c else
           f"agreement {c['agreement']:.4f}") for c in tpd_rec["serve"])
          + f"; launches {_nonzero(tpd_launches)}")

    # ------------------------------------------------------------ 16. count
    t = time.perf_counter()
    try:
        count_rec = count_phase(dev)
    except AssertionError as e:
        return fail("count", str(e))
    count_rec["seconds"] = time.perf_counter() - t
    phase("count", t, f"{count_rec['config']}: one train step counted on "
          f"meta and on the card alike, {count_rec['tflop']:.4f} TFLOP in "
          f"{count_rec['step_s']:.4f} s ({count_rec['peak_share']:.1%} of the "
          f"bf16 peak)")

    # -------------------------------------------------------- 17. tp-uneven
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="mafia-tpu-") as tmp:
            tpu_rec, tpu_launches, tpu_kernel_launches = tpu_phase(dev, tmp)
    except AssertionError as e:
        return fail("tp-uneven", str(e))
    tpu_rec["seconds"] = time.perf_counter() - t
    for k, n in tpu_launches.items():
        tp_launches[k] = tp_launches.get(k, 0) + n
    phase("tp-uneven", t, f"{len(tpu_rec['kernels'])} offset kernel cases "
          "within their limits; " + "; ".join(
              f"{a} x{n} float32 trained at (data 1, model {TPU_M})"
              for a, n in TPU_TRAIN + (TPM_TRAIN,))
          + " within the limits of the one-process step; " + "; ".join(
              f"{c['arch']} x{c['layers']} served at model {TPU_M}: "
              + (f"no-drop agreement {c['agreement_routed_alike']:.4f}"
                 if "agreement_routed_alike" in c else
                 f"agreement {c['agreement']:.4f}") for c in tpu_rec["serve"])
          + f"; counted on meta = the card for ranks {TPU_COUNT[2]}; offset "
          f"calls {tpu_rec['offset_calls']}; launches {_nonzero(tpu_launches)}")

    # ----------------------------------------------------------- 18. report
    t = time.perf_counter()
    saved = dict(LAUNCHES)
    timed = []
    for bench, prec, eng, X, done in results:
        (seg,) = eng.program.plan.megakernel.segments
        _, x = bucket_inputs(eng.program, seed=3)
        k_ms = median_ms(lambda: mk.run_segment_grid(seg, [x]), reps=50)
        k1_ms = median_ms(lambda: mk.run_segment_grid(seg, [x[:1]]), reps=50)
        d_ms, timer = device_ms(lambda: mk.run_segment_grid(seg, [x]), reps=50)
        d1_ms, _ = device_ms(lambda: mk.run_segment_grid(seg, [x[:1]]), reps=50)
        p_ms, _ = device_ms(lambda: run_segment_grid_ref(seg, [x]), reps=3,
                            warm=1)
        p1_ms, _ = device_ms(lambda: run_segment_grid_ref(seg, [x[:1]]),
                             reps=3, warm=1)
        b_ms, b_by = bound_ms(seg, BUCKET, prec)
        b1_ms, b1_by = bound_ms(seg, 1, prec)
        wall = statistics.median(serve_wall_s(eng, X) for _ in range(3))
        buckets = len(X) // BUCKET
        timed.append(dict(bench=bench, precision=prec, ms=d_ms, ms_nb1=d1_ms,
                          timer=timer, call_ms=k_ms, call_ms_nb1=k1_ms,
                          plain_ms=p_ms, plain_ms_nb1=p1_ms, bound_ms=b_ms,
                          bound_by=b_by, bound_ms_nb1=b1_ms, bound_by_nb1=b1_by,
                          serve_rps=len(X) / wall,
                          serve_bucket_ms=wall / buckets * 1e3,
                          device_busy=buckets * d_ms / (wall * 1e3)))
        print(f"  megakernel {bench} {prec}: bucket of {BUCKET}: kernel "
              f"{d_ms:.5f} ms on the device ({timer}; nb=1 {d1_ms:.5f}), "
              f"{k_ms:.4f} ms per call (nb=1 {k1_ms:.4f}), plain {p_ms:.3f} ms "
              f"(nb=1 {p1_ms:.3f}), bound {b_ms:.6f} ms ({b_by}; nb=1 "
              f"{b1_ms:.7f}, {b1_by}); served {len(X) / wall:.0f} requests/s, "
              f"{wall / buckets * 1e3:.3f} ms per bucket on the host clock, "
              f"kernel busy {buckets * d_ms / (wall * 1e3):.1%}", flush=True)

    def row(kernel, shape, fn, plain, library, reps, work, dtype):
        """Device times of the kernel, its plain version and the library
        call (None: there is none), the kernel's time per call between
        CUDA events, and the bound."""
        k_ms, timer = device_ms(fn, reps)
        call_ms = median_ms(fn, reps)
        p_ms, _ = device_ms(plain, reps)
        lib_ms = None if library is None else device_ms(library, reps)[0]
        b_ms, b_by = work_bound(*work, dtype)
        print(f"  {kernel} {shape}: kernel {k_ms:.5f} ms on the device "
              f"({timer}), {call_ms:.5f} ms per call, plain {p_ms:.5f} ms, "
              f"library " + ("none" if lib_ms is None else f"{lib_ms:.5f} ms")
              + f", bound {b_ms:.7f} ms ({b_by})", flush=True)
        return dict(shape=shape, ms=k_ms, timer=timer, call_ms=call_ms,
                    plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by)

    rows: dict[str, list] = {k: [] for k in checks}
    for bench, prec, eng in chain_engines:
        wall = statistics.median(serve_wall_s(eng, requests(eng))
                                 for _ in range(3))
        steps = [s for s in eng.program.plan.steps if isinstance(s, ChainStep)]
        for i, step in enumerate(steps):
            chain, x, extras = chain_case(eng.program, step, seed=i)
            kname = "linear_chain_q" if chain.quantized else "linear_chain"
            r = row(kname, f"{bench} {prec} chain {i} "
                    f"{[s[0] for s in chain.stages]} {tuple(x.shape)}",
                    lambda: lp.run_chain(chain, x, extras),
                    lambda: lp.chain_ref(chain, x, extras), None, 50,
                    chain_work(chain, x, extras),
                    "float32" if not chain.quantized else prec)
            r["serve_rps"] = SERVE_REQUESTS / wall
            rows[kname].append(r)
        print(f"  use_pallas {bench} {prec}: served "
              f"{SERVE_REQUESTS / wall:.0f} requests/s on the host clock")
    lc_lib = kb.load("linear_chain", lp._declare)
    lc_stream = torch.cuda.current_stream(dev).cuda_stream
    floor_fn = lambda: lc_lib.lc_launch_empty(lc_stream)    # noqa: E731
    chain_floor = dict(ms=device_ms(floor_fn, 50)[0],
                       call_ms=median_ms(floor_fn, 50))
    print(f"  chain launch floor (an empty kernel with the chain kernels' "
          f"parameter block): {chain_floor['ms']:.5f} ms on the device, "
          f"{chain_floor['call_ms']:.5f} ms per call", flush=True)
    for r in rows["linear_chain"] + rows["linear_chain_q"]:
        print(f"    {r['shape']}: {r['ms']:.5f} ms on the device = "
              f"{r['ms'] / chain_floor['ms']:.2f} x the floor (target "
              f"{CHAIN_DEVICE_MS} ms, {CHAIN_FLOOR_X} x), {r['call_ms']:.5f} ms "
              f"per call (target {CHAIN_CALL_MS} ms)")
    F = torch.nn.functional
    for label, packed, w, x in (("bonsai/curet-m Zx (24, 610) B=64", p_zx,
                                 w_zx, x_zx),
                                ("(4096, 4096) tile density 0.1 B=64", p_sp,
                                 w_sp, x_4k)):
        rows["spmv"].append(row(
            "spmv", f"{label} tiles 128", lambda: ops.spmv(packed, x),
            lambda: spmv_ref(w, x), lambda: F.linear(x, w), 50,
            spmv_work(packed, int(x.shape[0])), "float32"))
    for label, w, x in (("gemv (24, 610) B=64", w_zx, x_zx),
                        ("gemv (4096, 4096) B=64", w_dn, x_4k),
                        ("gemv (24, 610) B=64 bfloat16", w_zx16, x_zx16),
                        ("gemv (4096, 4096) B=64 bfloat16", w_dn16, x_4k16)):
        m, n = w.shape
        name = str(w.dtype).split(".")[-1]
        kname = "matmul_wgmma" if w.dtype == torch.bfloat16 else "matmul"
        rows[kname].append(row(
            kname, label, lambda: ops.gemv(w, x),
            lambda: gemv_ref(w.float(), x.float()).to(w.dtype),
            lambda: F.linear(x, w), 50,
            matmul_work(int(x.shape[0]), m, n, w.element_size()), name))
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        a, b = a_4k.to(dt), w_dn.to(dt)
        kname = "matmul_wgmma" if dt == torch.bfloat16 else "matmul"
        rows[kname].append(row(
            kname, f"matmul 4096^3 {name}", lambda: ops.matmul(a, b),
            lambda: matmul_ref(a.float(), b.float()).to(dt),
            lambda: torch.matmul(a, b), 10,
            matmul_work(4096, 4096, 4096, a.element_size()), name))
    for dt, lens in ((torch.bfloat16, lens16), (torch.float32, lens32)):
        dname = str(dt).split(".")[-1]
        S = 1024                             # the largest prefill bucket served
        q = rnd((1, S, 16, 128), dt)
        k, v = rnd((1, S, 2, 128), dt), rnd((1, S, 2, 128), dt)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kname = ("flash_attention_wgmma" if flash_route(q, k, v) == "wgmma"
                 else "flash_attention")
        # bfloat16: p fp32, rounded against each key tile's running max
        # (round_p=True) and against the row's max (attn_probs_bf16's
        # torch.bfloat16: a first pass over the keys)
        for rp in ((False, True, torch.bfloat16) if dt == torch.bfloat16
                   else (False,)):
            rows[kname].append(row(
                kname, f"{dname} B=1 Sq=Sk={S} H=16 KV=2 dh=128 causal p "
                + ("rounded to bfloat16 against the row's max"
                   if rp is torch.bfloat16 else "rounded" if rp else "fp32"),
                lambda: flash_attention_fused(q, k, v, round_p=rp),
                lambda: flash_attention_ref(q, k, v, round_p=rp),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True,
                                                       enable_gqa=True), 20,
                flash_work(1, S, S, 16, 2, 128, q.element_size(), True), dname))
        if dt == torch.bfloat16:
            # the row's max at the length the 36-layer run trains with
            # attn_probs_bf16 (the kernels line's row-max entry)
            Sm = train_rec["full_probs"]["seq_len"]
            qm = rnd((1, Sm, 16, 128), dt)
            km, vm = rnd((1, Sm, 2, 128), dt), rnd((1, Sm, 2, 128), dt)
            qmt, kmt, vmt = (x.transpose(1, 2) for x in (qm, km, vm))
            rows[kname].append(row(
                kname, f"{dname} B=1 Sq=Sk={Sm} H=16 KV=2 dh=128 causal p "
                "rounded to bfloat16 against the row's max",
                lambda: flash_attention_fused(qm, km, vm, round_p=torch.bfloat16),
                lambda: flash_attention_ref(qm, km, vm, round_p=torch.bfloat16),
                lambda: F.scaled_dot_product_attention(qmt, kmt, vmt,
                                                       is_causal=True,
                                                       enable_gqa=True), 10,
                flash_work(1, Sm, Sm, 16, 2, 128, qm.element_size(), True), dname))
            del qm, km, vm, qmt, kmt, vmt
        B, Sc = LM_MAX_BATCH, LM_MAX_LEN
        qd = rnd((B, 16, 128), dt)
        kc, vc = rnd((B, Sc, 2, 128), dt), rnd((B, Sc, 2, 128), dt)
        lh = torch.tensor(lens, dtype=torch.int32)
        ld = lh.to(dev)
        mask = (torch.arange(Sc, device=dev)[None, :] < ld[:, None])[:, None, None]
        q4, k4, v4 = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        r = row("decode_attention", f"{dname} B={B} S={Sc} H=16 KV=2 dh=128 "
                f"served lens {lens} (on the card) p fp32",
                lambda: decode_attention(qd, kc, vc, ld, round_p=False),
                lambda: decode_attention_ref(qd, kc, vc, ld),
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       attn_mask=mask,
                                                       enable_gqa=True), 50,
                decode_work(lens, 16, 2, 128, qd.element_size()), dname)
        _, passes, _ = device_split(
            lambda: decode_attention(qd, kc, vc, ld, round_p=False),
            DECODE_PASSES, reps=50)
        r["pass_ms"] = passes
        print(f"    decode_attention {dname} passes: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in passes.items()), flush=True)
        rows["decode_attention"].append(r)
        # the same call with the log-sum-exp output (gqa_decode on a cache
        # over the sequence): B x H more floats written, the output float32
        lb, lo = decode_work(lens, 16, 2, 128, qd.element_size())
        wider = (4 - qd.element_size()) * B * 16 * 128
        rows["decode_attention"].append(row(
            "decode_attention", f"{dname} B={B} S={Sc} H=16 KV=2 dh=128 "
            f"served lens {lens} (on the card) p fp32, with lse, output "
            "float32",
            lambda: decode_attention(qd, kc, vc, ld, round_p=False,
                                     return_lse=True),
            lambda: decode_attention_ref(qd, kc, vc, ld, return_lse=True),
            None, 50, (lb + 4 * B * 16 + wider, lo), dname))
        # the same call with a window of PROBE_WINDOW on the full-length
        # cache (starts on the card, the windowed grid): the bound reads
        # the window's keys; beside SDPA with the window's mask
        W = PROBE_WINDOW
        sd = (ld - W).clamp(min=0)
        pos = torch.arange(Sc, device=dev)[None, :]
        wmask = ((pos < ld[:, None]) & (pos >= sd[:, None]))[:, None, None]
        wb, wo = decode_work([min(int(x), W) for x in lens], 16, 2, 128,
                             qd.element_size())
        rows["decode_attention"].append(row(
            "decode_attention", f"{dname} B={B} S={Sc} H=16 KV=2 dh=128 "
            f"served lens {lens} window {W} (starts on the card) p fp32",
            lambda: decode_attention(qd, kc, vc, ld, cache_start=sd, window=W,
                                     round_p=False),
            lambda: decode_attention_ref(qd, kc, vc, ld, cache_start=sd,
                                         window=W),
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=wmask,
                                                   enable_gqa=True), 50,
            (wb + 4 * B, wo), dname))
    # the same two kernels at phase 7's other heads: flash at the largest
    # bucket (MLA's v zero-padded to dh 192, as mla_prefill gives it), decode
    # at the served lengths
    for dt, lens in ((torch.bfloat16, lens16), (torch.float32, lens32)):
        dname = str(dt).split(".")[-1]
        S = 1024
        for H, KV, dh in FAMILY_HEADS:
            q = rnd((1, S, H, dh), dt)
            k = rnd((1, S, KV, dh), dt)
            v = rnd((1, S, KV, dh), dt)
            if dh == 192:
                v[..., 128:] = 0
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kname = ("flash_attention_wgmma" if flash_route(q, k, v) == "wgmma"
                     else "flash_attention")
            rows[kname].append(row(
                kname, f"{dname} B=1 Sq=Sk={S} H={H} KV={KV} dh={dh} causal "
                "p fp32" + (" (MLA, v zero-padded from 128)" if dh == 192 else ""),
                lambda: flash_attention_fused(q, k, v, round_p=False),
                lambda: flash_attention_ref(q, k, v, round_p=False),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True,
                                                       enable_gqa=True), 10,
                flash_work(1, S, S, H, KV, dh, q.element_size(), True), dname))
            del q, k, v, qt, kt, vt
        B, Sc = LM_MAX_BATCH, LM_MAX_LEN
        ld = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(Sc, device=dev)[None, :] < ld[:, None])[:, None, None]
        for H, KV, dh in FAMILY_HEADS[:3]:
            qd = rnd((B, H, dh), dt)
            kc, vc = rnd((B, Sc, KV, dh), dt), rnd((B, Sc, KV, dh), dt)
            q4, k4, v4 = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            rows["decode_attention"].append(row(
                "decode_attention", f"{dname} B={B} S={Sc} H={H} KV={KV} "
                f"dh={dh} served lens {lens} (on the card) p fp32",
                lambda: decode_attention(qd, kc, vc, ld, round_p=False),
                lambda: decode_attention_ref(qd, kc, vc, ld),
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       attn_mask=mask,
                                                       enable_gqa=True), 50,
                decode_work(lens, H, KV, dh, qd.element_size()), dname))
            del qd, kc, vc, q4, k4, v4
    # the remaining served heads: flash at the largest bucket (zamba2's
    # shared block also with a window of PROBE_WINDOW, and the float32 p
    # rounded to bfloat16 of probs_bf16), decode at the served lengths
    # (zamba2's against a ring of RING_WIDTH)
    for dt, lens in ((torch.bfloat16, lens16), (torch.float32, lens32)):
        dname = str(dt).split(".")[-1]
        S = 1024
        probes = [(heads, 0, False) for heads in NEW_HEADS + (SHARED_HEADS,)]
        probes += [(SHARED_HEADS, PROBE_WINDOW, False)]
        if dt == torch.float32:
            probes += [((16, 2, 128), 0, True), (SHARED_HEADS, 0, True)]
        for (H, KV, dh), w, bf16_p in probes:
            q = rnd((1, S, H, dh), dt)
            k = rnd((1, S, KV, dh), dt)
            v = rnd((1, S, KV, dh), dt)
            if bf16_p:
                v = v.bfloat16().float()
            rp = torch.bfloat16 if bf16_p else False
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pos = torch.arange(S, device=dev)
            allowed = pos[None, :] <= pos[:, None]
            if w:
                allowed &= pos[None, :] > pos[:, None] - w
            kname = ("flash_attention_wgmma" if flash_route(q, k, v) == "wgmma"
                     else "flash_attention")
            rows[kname].append(row(
                kname, f"{dname} B=1 Sq=Sk={S} H={H} KV={KV} dh={dh} causal"
                + (f" window {w}" if w else "")
                + (" p rounded to bfloat16 (probs_bf16)" if bf16_p else " p fp32"),
                lambda: flash_attention_fused(q, k, v, window=w, round_p=rp),
                lambda: flash_attention_ref(q, k, v, window=w, round_p=rp),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=allowed,
                                                       enable_gqa=True), 10,
                flash_work(1, S, S, H, KV, dh, q.element_size(), True, w), dname))
            del q, k, v, qt, kt, vt, allowed
        B, Sc = LM_MAX_BATCH, LM_MAX_LEN
        for (H, KV, dh), width in [(h, Sc) for h in NEW_HEADS + (SHARED_HEADS,)
                                   ] + [(SHARED_HEADS, RING_WIDTH)]:
            lw = [min(int(x), width) for x in lens]
            ld = torch.tensor(lw, dtype=torch.int32, device=dev)
            mask = (torch.arange(width, device=dev)[None, :]
                    < ld[:, None])[:, None, None]
            qd = rnd((B, H, dh), dt)
            kc, vc = rnd((B, width, KV, dh), dt), rnd((B, width, KV, dh), dt)
            q4, k4, v4 = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            rows["decode_attention"].append(row(
                "decode_attention", f"{dname} B={B} "
                + (f"ring of {width}" if width != Sc else f"S={Sc}")
                + f" H={H} KV={KV} dh={dh} served lens {lw} (on the card) p fp32",
                lambda: decode_attention(qd, kc, vc, ld, round_p=False),
                lambda: decode_attention_ref(qd, kc, vc, ld),
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       attn_mask=mask,
                                                       enable_gqa=True), 50,
                decode_work(lw, H, KV, dh, qd.element_size()), dname))
            del qd, kc, vc, q4, k4, v4
    # the flash backward at the trained shapes (causal): qwen2.5-3b's heads
    # and those of DHP 256 and G 6 (deepseek-v2's MLA with v zero-padded as
    # the model pads it, zamba2's shared block, internvl2's), bfloat16 and
    # float32 on both routes (the tensor cores, and the CUDA cores they
    # replaced; bfloat16 at S 4,096 the tensor cores alone but qwen's); each
    # beside its plain version and SDPA's backward alone (k and v expanded
    # over G; its forward run once outside the timer; forward and backward
    # together printed beside it)
    rows["flash_attention_bwd"], rows["flash_attention_bwd_wgmma"] = [], []

    def bwd_issued(dh):
        """Products the float32 tensor-core kernels issue for each of the
        five, as the library states them."""
        f = bwd_kernel_facts(dh, torch.float32)
        return f["dq_products"] + f["dkdv_products"]

    def bwd_row(S, H, KV, dh, dt, mla=False):
        gen = torch.Generator(device=dev).manual_seed(S + H + dh)
        q, go = (torch.randn((1, S, H, dh), generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((1, S, KV, dh), generator=gen, device=dev).to(dt)
                for _ in range(2))
        if mla:
            v[..., 128:] = 0
            go[..., 128:] = 0
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        gs = go.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  enable_gqa=H != KV)

        out = sdpa()
        # milliseconds a call: CUDA events time these as well as a trace
        # would, and a trace this late in the run may drop some of the
        # kernels (ROADMAP Queue C item 8)
        shape = (f"{str(dt)[6:]} B=1 S={S} H={H} KV={KV} dh={dh} causal"
                 + (" mla v 128->192" if mla else ""))
        # on the route the call takes (checked: the tensor cores), then
        # forced onto the CUDA cores
        routes = ((flash_bwd_route(q, k, v),)
                  + (("simt",) if (H, KV, dh) == (16, 2, 128) or S == FLASH_BWD_S
                     or dt == torch.float32 else ()))
        if routes[0] != "wgmma":
            raise AssertionError(f"flash_attention_bwd {shape}: {routes[0]}")
        # the plan's bytes are the kernels' own
        plan, facts = plan_flash_bwd(1, S, S, H, KV, dh, dtype=dt), bwd_kernel_facts(dh, dt)
        if (plan.dq_smem, plan.dkdv_smem) != (facts["dq_smem"], facts["dkdv_smem"]):
            raise AssertionError(f"flash_attention_bwd {shape}: plan's shared "
                                 f"memory {plan.dq_smem}, {plan.dkdv_smem}; "
                                 f"the kernels' {facts}")
        k_ms = {r: median_ms(lambda r=r: flash_attention_bwd(
            q, k, v, go, route="simt" if r == "simt" else None), 5)
            for r in routes}
        p_ms = median_ms(lambda: flash_attention_bwd_ref(q, k, v, go), 5)
        lib_ms = median_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), gs, retain_graph=True), 5)
        both_ms = median_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), gs), 5)
        nbytes, ops = flash_bwd_work(1, S, H, KV, dh, q.element_size())
        b_ms, b_by = work_bound(nbytes, ops, str(dt)[6:])
        # float32 on the tensor cores: each of the five products as the
        # fewest 16-bit products that meet the float32 limits
        # (FLASH_BWD_F32_MIN_PRODUCTS) at the 16-bit peak, the float32
        # bytes; beside it the 16-bit bound of the products the kernels issue
        tc_ms = tc_by = issued_ms = None
        if dt == torch.float32 and routes[0] == "wgmma":
            tc_ms, tc_by = work_bound(nbytes, ops * FLASH_BWD_F32_MIN_PRODUCTS,
                                      "bfloat16")
            issued_ms = work_bound(nbytes, ops * bwd_issued(dh) / 5, "bfloat16")[0]
        print(f"  flash_attention_bwd {shape}: "
              + ", ".join(f"{r} kernels {k_ms[r]:.5f} ms a call" for r in routes)
              + f" (events), plain {p_ms:.5f} ms, SDPA backward {lib_ms:.5f} "
              f"ms (forward and backward {both_ms:.5f} ms), bound "
              f"{b_ms:.7f} ms ({b_by})"
              + ("" if tc_ms is None else f"; on the tensor cores "
                 f"{FLASH_BWD_F32_MIN_PRODUCTS} x 5 16-bit products "
                 f"{tc_ms:.7f} ms ({tc_by}), the {bwd_issued(dh)} issued "
                 f"{issued_ms:.7f} ms"),
              flush=True)
        for r in routes:
            name = "flash_attention_bwd" + ("_wgmma" if r == "wgmma" else "")
            tc = r == "wgmma" and tc_ms is not None
            rows[name].append(dict(
                shape=shape, ms=k_ms[r], timer="events", call_ms=k_ms[r],
                plain_ms=p_ms, library_ms=lib_ms, library_fwd_bwd_ms=both_ms,
                bound_ms=tc_ms if tc else b_ms, bound_by=tc_by if tc else b_by,
                fp32_bound_ms=b_ms if tc else None,
                issued_bound_ms=issued_ms if tc else None))

    def rounded_row(S, dt):
        """The backward with p rounded to bfloat16 (attn_probs_bf16) at
        qwen2.5-3b's heads on the route it takes (bfloat16: the tensor
        cores, and forced onto the CUDA-core pair beside them; float32: the
        CUDA-core pair), beside the tensor cores' fp32-p call on the same
        inputs and the plain version; no PyTorch call
        rounds p, so no library time; the bound is the function's five
        products (float32: as ``bwd_row`` states it, each as
        FLASH_BWD_F32_MIN_PRODUCTS 16-bit products at the 16-bit peak, the
        float32 peak's bound beside it)."""
        gen = torch.Generator(device=dev).manual_seed(S + 3)
        q, go = (torch.randn((1, S, 16, 128), generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((1, S, 2, 128), generator=gen, device=dev).to(dt)
                for _ in range(2))
        v = v.bfloat16().to(dt)
        bf = torch.bfloat16
        route = flash_bwd_route(q, k, v, bf)
        if route != ("simt" if dt == torch.float32 else "wgmma"):
            raise AssertionError(f"the rounded backward at S={S} {dt}: {route}")
        k_ms = {r: median_ms(lambda r=r: flash_attention_bwd(
            q, k, v, go, round_p=bf, route=r), 5)
            for r in ((None, "simt") if route == "wgmma" else (None,))}
        fp32_ms = median_ms(lambda: flash_attention_bwd(q, k, v, go), 5)
        p_ms = median_ms(lambda: flash_attention_bwd_ref(q, k, v, go, round_p=bf), 3)
        nbytes, ops = flash_bwd_work(1, S, 16, 2, 128, q.element_size())
        b_ms, b_by = work_bound(nbytes, ops, str(dt)[6:])
        f32_ms = None
        if dt == torch.float32:
            f32_ms = b_ms
            b_ms, b_by = work_bound(nbytes, ops * FLASH_BWD_F32_MIN_PRODUCTS,
                                    "bfloat16")
        shape = (f"{str(dt)[6:]} B=1 S={S} H=16 KV=2 dh=128 causal p rounded "
                 "to bfloat16")
        print(f"  flash_attention_bwd {shape}: {route} kernels {k_ms[None]:.5f} ms "
              "a call" + (f", simt kernels {k_ms['simt']:.5f} ms" if "simt" in k_ms
                          else "") + f" (events); p in fp32 on the tensor cores "
              f"{fp32_ms:.5f} ms; plain {p_ms:.5f} ms, no "
              f"library call, bound {b_ms:.7f} ms ({b_by})"
              + ("" if f32_ms is None else
                 f"; at the float32 peak {f32_ms:.7f} ms"), flush=True)
        return dict(shape=shape, route=route, ms=k_ms[None], timer="events",
                    call_ms=k_ms[None], simt_ms=k_ms.get("simt", k_ms[None]),
                    fp32_p_ms=fp32_ms, plain_ms=p_ms,
                    library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    fp32_bound_ms=f32_ms)

    try:
        rows["flash_attention_bwd_rounded"] = [
            rounded_row(S, dt) for S, dt in ((probs["seq_len"], torch.bfloat16),
                                             (FLASH_BWD_S, torch.bfloat16),
                                             (FLASH_BWD_S, torch.float32))]
        for S in (full["seq_len"], FLASH_BWD_S):
            for dt in (torch.bfloat16, torch.float32):
                bwd_row(S, 16, 2, 128, dt)
        for H, KV, dh in ((128, 128, 192), SHARED_HEADS, G6_HEADS):
            for S in (LM_TRAIN_FULL_S, FLASH_BWD_S):
                for dt in (torch.bfloat16, torch.float32):
                    bwd_row(S, H, KV, dh, dt, mla=dh == 192)
    except AssertionError as e:
        return fail("report", str(e))
    # internvl2's G 6 forward at its trained length, bfloat16, p in fp32
    # (its training forward), beside masked SDPA
    S = LM_TRAIN_FULL_S
    q = rnd((1, S) + G6_HEADS[:1] + G6_HEADS[2:], torch.bfloat16)
    k, v = (rnd((1, S) + G6_HEADS[1:], torch.bfloat16) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows["flash_attention_wgmma"].append(row(
        "flash_attention_wgmma", f"bfloat16 B=1 Sq=Sk={S} H={G6_HEADS[0]} "
        f"KV={G6_HEADS[1]} dh={G6_HEADS[2]} causal p fp32",
        lambda: flash_attention_fused(q, k, v, round_p=False),
        lambda: flash_attention_ref(q, k, v, round_p=False),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), 10,
        flash_work(1, S, S, *G6_HEADS, 2, True), "bfloat16"))
    del q, k, v, qt, kt, vt
    for r in lm_runs:
        if "decode_step_device_ms" not in r:
            continue
        print(f"  lm-serve {r['run']}: prefill {r['prefill_ms_per_request']:.2f} "
              f"ms per request, decode {r['decode_ms_per_step']:.3f} ms per step "
              f"at batch {LM_MAX_BATCH} (warm {r['decode_ms_steady']:.3f}; "
              f"prefill of {r['prefill_bucket']} tokens warm "
              f"{r['prefill_ms_bucket']:.2f} ms), {r['tokens_per_s']:.1f} generated "
              f"tokens/s (host clock); decode step {r['decode_step_device_ms']:.3f}"
              f" ms on the device, attention {r['attention_share']:.1%} of it; "
              f"prefill of {r['prefill_bucket']} tokens "
              f"{r['prefill_device_ms']:.3f} ms on the device, flash "
              f"{r['prefill_flash_device_ms'] / r['prefill_device_ms']:.1%} of "
              f"it; decode step bytes bound {r['decode_step_bound_ms']:.3f} ms; "
              f"peak {r['peak_gib']:.1f} GiB")
    LAUNCHES.update(saved)
    phase("report", t, "device times from the profiler trace; per-call times "
          "between CUDA events; serving wall time on the host clock")
    report.update(lm_train=train_rec, train_launches=train_launches,
                  dist=dist_rec, dist_launches=dist_launches, tp=tp_rec,
                  tp_moe=tpm_rec, tp_ssm=tps_rec, tp_dp=tpd_rec,
                  tp_uneven=tpu_rec, tp_launches=tp_launches, count=count_rec)
    report.update(served=served, timed=timed, launches=launches, rows=rows,
                  chain_floor=chain_floor,
                  attention_cases=attn_cases, ssd_cases=ssd_cases,
                  lm_runs=lm_runs, front=front,
                  front_timed=front_timed, store=store_rec,
                  mm_f32_route=MM_F32_ROUTE.get("bfloat16"))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    head = timed[0]                    # bonsai/curet-m float32, bucket of 64
    kernels = [{
        "name": "megakernel", "route": "cuda",
        "source": "src/repro_torch/csrc/megakernel.cu",
        "replaces": "src/repro/kernels/megakernel.py:230",
        "launches": launches["megakernel"],
        "max_abs_err": max(c["max_abs_err"] for c in report["cases"]),
        "ms": head["ms"], "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": f"{head['bench']} {head['precision']} bucket {BUCKET}",
        "cases": timed + front_timed,
    }]
    for name, source, replaces, pick in (
            ("linear_chain", "linear_chain.cu", "kernels/linear_pipeline.py:142",
             lambda r: "(64, 976)" in r["shape"] and "bonsai" in r["shape"]),
            ("linear_chain_q", "linear_chain.cu", "kernels/linear_pipeline.py:197",
             lambda r: "(64, 976)" in r["shape"] and "bonsai" in r["shape"]),
            ("spmv", "spmv.cu", "kernels/spmv.py:95", lambda r: "4096" in r["shape"]),
            ("matmul", "gemv.cu", "kernels/gemv.py:25",
             lambda r: r["shape"] == "matmul 4096^3 float32"),
            ("matmul_wgmma", "gemv.cu", "kernels/gemv.py:25",
             lambda r: r["shape"] == "matmul 4096^3 bfloat16"),
            ("flash_attention", "flash_attention.cu", "kernels/flash_attention.py:39",
             lambda r: r["shape"].startswith("float32")),
            ("flash_attention_wgmma", "flash_attention.cu",
             "kernels/flash_attention.py:39",
             lambda r: r["shape"].startswith("bfloat16") and "fp32" in r["shape"]),
            ("decode_attention", "decode_attention.cu", "kernels/decode_attention.py:32",
             lambda r: r["shape"].startswith("bfloat16")),
            ("flash_attention_bwd", "flash_attention.cu",
             "models/attention.py:70",
             lambda r: r["shape"].startswith(
                 f"float32 B=1 S={FLASH_BWD_S} H={SHARED_HEADS[0]} "
                 f"KV={SHARED_HEADS[1]} dh={SHARED_HEADS[2]}")),
            ("flash_attention_bwd_wgmma", "flash_attention.cu",
             "models/attention.py:70",
             lambda r: r["shape"].startswith(f"bfloat16 B=1 S={full['seq_len']}"))):
        h = next(r for r in rows[name] if pick(r))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/{replaces}",
            "launches": (train_launches[name] if name.startswith(
                "flash_attention_bwd") else launches[name]),
            "train_launches": train_launches.get(name, 0),
            "dist_launches": dist_launches.get(name, 0),
            "tp_launches": tp_launches.get(name, 0),
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": h["ms"], "call_ms": h["call_ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"], "shape": h["shape"],
            "cases": rows[name]})
    # the CUDA-core backward's model path is float32 training with
    # attn_probs_bf16 (p rounded, timed as "rounded"); otherwise route="simt"
    # and the calls the tensor cores refuse (phase 10 holds it on every
    # float32 case, the served bfloat16 heads and the rounded-p cases)
    bwd = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    bwd["main_path"] = ("float32 training with attn_probs_bf16 (round_p="
                        "torch.bfloat16: phase 10's twin); else "
                        "flash_attention_bwd(route='simt'), dh not a multiple "
                        "of 8, views off 16 bytes, G the row tiles cannot hold")
    bwd["rounded"] = rows["flash_attention_bwd_rounded"]
    bwd["rounded_max_abs_err"] = train_rec["bwd_rounded_max_abs_err"]["simt"]
    # training with attn_probs_bf16 on the tensor cores: the rounded-p
    # backward (fbt_*'s RP instances, counted as flash_attention_bwd_wgmma)
    # and the forward rounding p against the row's max (fa_tc_kernel's mode
    # 3, counted as flash_attention_wgmma), launched by the 36-layer
    # bfloat16 run with attn_probs_bf16; no PyTorch call rounds p, so no
    # library time
    # each held to its plain version at the main path's shape (phase 10's
    # cases at qwen2.5-3b's heads, S LM_TRAIN_FULL_S, bfloat16)
    probs = train_rec["full_probs"]
    main = f"bfloat16 B=1 S={LM_TRAIN_FULL_S} H=16 KV=2 dh=128 p rounded"
    bwd_main = next(c for c in train_rec["bwd_cases"] if c["case"].startswith(main)
                    and c["route"] == "wgmma")
    fwd_main = next(c for c in train_rec["fwd_row_max"] if c["case"].startswith(main))
    for name, counter, kind_rows, pick, err in (
            ("flash_attention_bwd_wgmma_rounded", "flash_attention_bwd_wgmma",
             rows["flash_attention_bwd_rounded"],
             lambda r: r["shape"].startswith(f"bfloat16 B=1 S={probs['seq_len']}"),
             max(bwd_main["errs"][n] for n in ("dq", "dk", "dv"))),
            ("flash_attention_wgmma_row_max", "flash_attention_wgmma",
             rows["flash_attention_wgmma"],
             lambda r: "row's max" in r["shape"]
             and f"Sq=Sk={probs['seq_len']} " in r["shape"], fwd_main["err"])):
        h = next(r for r in kind_rows if pick(r))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": ("src/repro/models/attention.py:70" if "bwd" in name
                         else "src/repro/kernels/flash_attention.py:39"),
            "launches": probs["launches"][counter],
            "max_abs_err": err, "ms": h["ms"], "call_ms": h["call_ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": None,
            "sdpa_ms": h.get("library_ms") if "bwd" not in name else None,
            "shape": h["shape"], "main_path": probs["config"],
            "cases": [r for r in kind_rows if pick(r) or "bwd" in name]})
    da = next(k for k in kernels if k["name"] == "decode_attention")
    da["window"] = next(r for r in rows["decode_attention"]
                        if r["shape"].startswith("bfloat16")
                        and f"window {PROBE_WINDOW}" in r["shape"])
    # the kernels with a head offset (phase 17): each at granite-8b's rank 1
    # at model 3 in the dtype its main path runs (the served prefill
    # bfloat16; training float32), beside the same call on whole groups;
    # launches: phase 17's ranks' main-path launches of the kernel, and of
    # those the calls on heads that are not whole groups (decode: none,
    # every rank decodes whole groups on a cache over the sequence)
    offset_calls = tpu_rec["offset_calls"]
    for name, dts, calls in (
            ("flash_attention_wgmma", "bfloat16", "flash_attention_fused"),
            ("flash_attention", "float32", "flash_attention_train"),
            ("flash_attention_bwd_wgmma", "float32", "flash_attention_train"),
            ("decode_attention", "bfloat16", "decode_attention")):
        # the backward's cases with both routes' (fb_* forced: on no
        # model's path here)
        cases = [r for r in tpu_rec["kernels"] if r["name"] == name or (
            "bwd" in name and r["name"] == "flash_attention_bwd")]
        h = next(r for r in cases if r["name"] == name
                 and r["case"] == TPU_OFFSETS[0][0] and r["shape"].startswith(dts))
        kernels.append({
            "name": f"{name}_offset", "route": "cuda",
            "source": ("src/repro_torch/csrc/decode_attention.cu"
                       if name == "decode_attention"
                       else "src/repro_torch/csrc/flash_attention.cu"),
            "replaces": ("src/repro/kernels/decode_attention.py:32"
                         if name == "decode_attention" else
                         "src/repro/models/attention.py:70" if "bwd" in name
                         else "src/repro/kernels/flash_attention.py:39"),
            "launches": tpu_launches.get(name, 0),
            "offset_calls": offset_calls.get(calls, 0),
            "check_launches": tpu_kernel_launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": h["ms"], "timer": h["timer"], "call_ms": h["call_ms"],
            "plain_ms": h["plain_ms"], "aligned_ms": h["aligned_ms"],
            "aligned_timer": h["aligned_timer"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "fp32_bound_ms": h["fp32_bound_ms"],
            "library_ms": None, "shape": h["shape"],
            "main_path": f"phase 17: qwen2.5-3b, granite-8b, olmoe-1b-7b at "
                         f"(data 1, model {TPU_M}) under the uneven plan",
            "cases": cases})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--store-child"]:
        sys.exit(store_child(sys.argv[2]))
    sys.exit(main())

"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card

Phases, each failing loudly (any failure exits nonzero):

1. ``kernels``: build every CUDA kernel from ``paddle_tpu_torch/csrc/``,
   hold each against its plain PyTorch version at the shapes the serving
   main path gives it (llama3-8b), and time kernel, plain version and the
   nearest single PyTorch library call. K8 in bf16 through its split /
   TMA ring / wgmma variant (the C launcher's plan ``rpa_plan_c`` equal to
   ``rpa_plan``), eager and device (CUDA graph) times beside SDPA's, a
   digest of its output, and row independence at mb 16 and 32: the same
   query rows carried by decode, 4-row verify and 16-row prefill chunks
   at every offset, on page and split edges, are bit-equal.
2. ``engine``: ``ServingEngine(llama_presets("llama3-8b"))`` at full
   width with random bf16 weights drawn on the card from a seed, serving
   eight requests (half share a 256-token prefix, greedy and sampled);
   the attention kernel's launch count must equal layers x steps.
3. ``int8``: the same traffic through the weight-only int8 engine; the
   int8 matmul kernel's launch count must equal (7 x layers + 1) x steps,
   every one through its TMA + wgmma variant.
4. ``cpu``: a small fp32 config (head dim 128) on the card and on the
   CPU with identical weights; greedy streams must be equal except where
   the CPU's top-2 logit margin is under 1e-4.
5. ``train_kernels``: the training kernels against their plain versions:
   flash attention forward (K1) and backward (K2) at the gpt3-350m
   attention shape and a small fp32 case at head dim 64 and 128 (K2 run
   twice, bitwise equal), and the vocab-streaming cross-entropy forward
   (K4) and backward (K5) at the gpt3-350m loss shape and a small case
   with ragged tiles in fp32 and bf16 (every bf16 product through the
   TMA + wgmma route as the C entries report it, the C launchers' plan
   ``ce_plan_c`` equal to ``ce_plan``); kernel (eager and in a CUDA
   graph), plain, the bf16 cuBLAS products they compute and library
   times beside the bound. Outputs are held element by element (see
   ``_scaled_err``), and dhead also on the vocab columns no token has as
   its label, where dl is the softmax part alone. Then the residual +
   bias + norm epilogue (K6) at the gpt3-350m norm shape in its layer
   forms (residual + bias, norm-only, with the gelu), the rms form at
   H 4096 and small fp32 cases, r bit-equal and y by row; and the bias +
   gelu (K7) at the gpt3-350m FFN shape and a small fp32 case (its 2-D
   walk the C launcher's, ``bias_gelu_plan_c`` equal to
   ``bias_gelu_plan``; the first 256 rows alone bit-equal to those rows
   of the whole call; eager and device times beside F.gelu's). The split
   flash backward (K3): in its fused-qkv mode at gpt3-1.3b's S 8192
   shape (B 1, h 16, d 128, bf16) bit-equal to K2 and timed beside it,
   at S 2048 against its plain version; in its separate mode at
   llama1b's training shape (B 2, S 2048, h 16, d 128) against its
   plain version and bit-equal to the fused mode on the same values;
   small fp32 cases at head dims 64, 128 and 256, causal and not; K3's
   (and K2's) device time in a CUDA graph beside the eager one. The
   head-major flash (K17, forward and split backward on [B, h, S, d]):
   bit-equal to K1-sep and K3-sep on the same values and held against
   its plain version at gpt3-350m's attention (B 16, S 1024, h 16, d 64,
   bf16; timed beside SDPA on the same head-major operands), at h 5
   (odd heads, d 64) and in small fp32 cases.
6. ``train``: ``make_train_step(gpt3-350m)`` at full width (24 layers,
   B 16, S 1024, bf16 moments, fp32 masters) on random weights drawn on
   the card, with the fusion compiler on (its default), 3 warm-up steps
   and the best of 3 windows of 4 steps; the loss must start near ln(V)
   and fall, K1/K2 must launch 24 times per step, K4/K5 once per step (2
   launches and 3 per 8192-column vocab slab, 21; every one of their
   1 + 3 x 7 bf16 products a step through the wgmma route, and the C
   launchers' plan ``ce_plan``'s), K6 2L + 1 = 49 times
   and K7 24 times, and the fusion report must list 49 applied
   ``layer_epilogue`` and 24 applied ``bias_gelu`` sites and no error.
   The same step then runs with ``use_auto_fusion`` off, and its step
   time and peak memory are printed beside the fused step's; and a third
   time, fusion on, under ``FLAGS_flash_attention_native_layout=0``: K17
   forward 24 and dq + dk/dv 48 launches a step, no K1/K2, its first
   loss (same weights and batch) within rtol 1e-3 of the native step's.
7. ``train_cpu``: a small fp32 GPT trained 3 steps on the card and on the
   CPU from identical weights, fusion on for both; losses within rtol
   1e-4 and parameters within atol 1e-4 (TF32 off), every training kernel
   launched on the card: without remat, under remat=True and "full", and
   with flash_attention_fused_dqkv off (K3, never K2); then a small fp32
   LLaMA (head dim 128, G 2): llama_loss and its gradients on the card
   (K11, K3, K6, K12) against the CPU, by row within 1e-4.
7a. ``train_13b``: ``make_train_step(gpt3-1.3b)`` at full width (24
   layers, hidden 2048, vocab 50304), bf16 moments, weights="sr-bf16"
   (no master; the SR function's unbiasedness checked on the card
   first), fusion on, random weights drawn on the card, at bench.py's
   three configurations: B 4 S 1024 remat=True, B 1 S 4096 remat=True,
   B 1 S 8192 remat="full"; 3 warm-up steps, best of 3 windows. The loss
   starts within 0.5 of ln(V) and falls; per step K1 launches L = 24
   times (both policies save the flash o/lse), K2 L at S 1024 and 4096,
   K3 2L at S 8192 (the 6 MiB gate), K6 4L + 1 and K7 2L (recomputed in
   the backward), K4/K5's products all through wgmma; at S 4096 the
   peak memory of the forward + backward falls from remat False to True
   to "full" (the whole step's peak is printed beside it). Prints
   bench.py's gpt3_1p3b_* keys (MFU against 989 TFLOP/s) and the peaks
   on one line.
7b. ``llama_train``: gradients of llama_loss at llama1b (16 layers,
   bf16), B 2, S 2048, remat=True: fusion on (K11 L times in the forward,
   K11 L again and K3 2L in the backward, no K2) and off (K1-sep and K3);
   finite loss and gradients; both routes' gradients against fp32 ones
   (weights cast up, fusion off), the fused route's mean relative error
   within 1.1x the unfused one's; forward and backward ms and peak
   memory printed.
8. ``decode_kernels``: the LLaMA engine's kernels against their plain
   versions at the llama1b shapes: dense GQA decode attention (K10) at
   B 1, 8, 16 and five cache positions (one allocation a call, the
   output; the C launcher's cluster plan ``decode_plan``'s; eager and
   CUDA-graph device times beside SDPA's), flash with RoPE in the tile (K11,
   bit-equal to K1 on apply_rope'd inputs; device times in a CUDA graph,
   beside SDPA on rotated q/k and apply_rope + SDPA, the composition K11
   replaces), K1's separate-input mode and
   swiglu (K12, also at llama3-8b's width), each with kernel, plain,
   library time and bound; and K6 in the rms form at the prefill's rows
   and width (residual and norm-only, r bit-equal, y by row).
9. ``decode``: ``LlamaForCausalLM`` at llama1b (vocab 32000, hidden 2048,
   16 layers, 16 heads, 4 kv heads, ffn 5504; random bf16 weights drawn
   on the card from seed 0) on the reference bench's decode protocol:
   512-token prompts, prefill ms and decode tokens/s at B 1, 8 and 16
   (128 new tokens, greedy), a sampled run, the weight-only int8 engine
   at B 8, the fusion-off engine at B 1 against the fused one by teacher
   forcing (the fused greedy stream fed to the fused, the unfused and an
   fp32 engine; every step's logits of each bf16 engine held to the fp32
   one's, the fused one's mean error within 1.1x the unfused one's), a
   profiled decode window, and llama3-8b at B 1. Per generate K10
   launches L x (new - 1), K11 and K12 L and K6 2L + 1 (the prefill's
   fusion report: 2L + 1 rms_epilogue, L rope_attention, L swiglu
   applied, no error), K9 (7L + 1) x new with int8 weights.
10. ``decode_cpu``: a small fp32 LLaMA (head dim 128, G 2) generating on
   the card and on the CPU from identical weights, fusion on; greedy
   streams equal except where the CPU's top-2 margin is under 1e-4.
11. ``serving_kernels``: the serving engine's int8, speculative and
   multi-tenant kernels against their plain versions: K8q (int8 pages,
   the wgmma variant in bf16, device times, a digest, row independence)
   at the llama3-8b step's attention shapes in bf16 and fp32 and K10q
   (int8 dense cache) at K10's shapes, each bit-equal to its fp kernel on
   the inputs dequantized beforehand; K13 (grouped LoRA BGMV: a cluster
   a packed row, the shrink split over H) at the step's q and v
   projections, within 1e-5 of its fp32 plain version, slot-0 rows
   exactly 0, a row's bits the same at other (c, i) in calls of other C,
   its C plan ``lora_plan``'s; kernel, plain, library time and bound
   (K13 and K10q also on the device, K10q one allocation a call).
12. ``serving``: llama3-8b serving (random bf16 weights from seed 0):
   (a) int8 KV pages against bf16 (K8q L per step, 65552 KV bytes per
   token); (b) speculative decode, k 3, with the n-gram proposer and with
   drafts known to be right or wrong, streams held to the
   non-speculative engine's; (c) two LoRA adapters, priorities and a
   schema-constrained request on a tight pool (K13 2L per step, every
   launch through the cluster kernel at ``lora_plan_c == lora_plan``, a
   preemption, the ledger summed after every step, no-adapter streams
   held to the LoRA-off engine's); (d) card against CPU, small fp32, int8
   KV with the multi-tenant axes and with speculation; (e) the public
   int8 decode entry (K10q). Streams are held by ``_serving_streams_agree``:
   equal, except from a token the reference engine's own logits hold
   within 1e-4 of the other pick.
13. ``paged_kernels``: the incubate paged decode's kernels against their
   plain versions: K15 (d-major k pages, GQA native; p rounded to bf16 as
   the kernel does) at llama2-7b's width (32 heads of 128, page 128, 16
   blocks) and llama3-8b's GQA (8 kv heads, 4 q heads each), K14
   (token-major pages) and K16 (warp-specialised, bit-equal to K14),
   with ragged lengths (1, mid-page, a full table, 0) on a shuffled
   table, bf16 and fp32, K16 also at its rings' edges (d 64 / 128 / 256,
   pages of 16 / 64 / 128); the C ring plans ``paged_mxu_plan``'s and
   ``paged_dma_plan``'s; kernel and SDPA on
   pre-gathered pages, eager and on the device, plain and the bound (the
   valid tokens' k and v, q and o) at the paged phase's last step.
14. ``paged``: ``block_multihead_attention`` at llama2-7b's attention
   width: 32 PagedKVCaches (bf16, page 128, 2048 tokens, B 8), a
   1024-token prefill (K1-sep 32 times) and 64 decode steps on d-major
   pages (K15 32 times a step), then on token-major pages (K14 32 times
   a step); layer 0 of every 16th step and every layer of the last held
   against the plain version; K16 on the token-major caches, bit-equal to
   K14; a GQA pass at llama3-8b's width through paged_decode_attention
   (K15); a small fp32 cache on the card against the CPU.

15. ``fleet``: llama3-8b replicas on one params dict: a prefill and a
   decode replica over the wire (overlapped and synchronous), two
   colocated replicas under bench.py's fleet traffic with one killed, an
   int8 prefill replica into a bf16 one.
16. ``rollout``: llama3-8b at the serving settings, v1 (seed 0) and v2
   (seed 1): a deploy of v2 fired mid-decode by ``FleetDriver(deploys=)``
   under the same traffic, every stream equal to a lone engine's on the
   version it was pinned to; a ``rollout.canary`` failure (one rollback,
   back on v1); a ``rollout.swap`` raise (a replacement on v2); autoscale
   1 -> 2 -> 1 replicas with no request dropped; SLO shed of three
   never-accepted predicted misses. The ledgers sum on every tick, K8
   launches L x every engine's steps, all wgmma. Prints
   ``WeightCatalog.put`` ms and GB/s, ``rollout_ms``,
   ``rollout_stall_ms``, each ``set_params`` swap, goodput, TTFT p50 / p99
   and peak memory.
17. ``resilient``: gpt3-350m at the train phase's settings under
   ResilientTrainLoop (``donated_step``; save_every 2, keep 2): 6 steps
   through a NaN at step 3 (restored bitwise from the step-2 checkpoint),
   a torn step-6 save, a new loop resuming at step 4 with the
   checkpoint's bytes and the uninterrupted run's next losses, and
   ``run_elastic`` over this script's ``--resilient-worker`` mode (2
   layers): a generation killed after a torn save, relaunched at step 2
   without rebuilding a kernel. Prints the state's bytes, save / verify /
   load ms, crc32 GB/s, the step with and without the watchdog's guard,
   and K1, K2, K4-K7's launches (flash and CE by variant).

18. ``dist``: the sharded entry, ``make_sharded_train_step`` on the
   (1,1,1) mesh, as bench.py calls it: (a) gpt3-350m (bf16, fp32 masters,
   bf16 moments, zero1 off; B 16, S 1024, 3 steps) and (a2) gpt3-1.3b
   (sr-bf16, bf16 moments, unroll, remat; B 1, S 4096, 2 steps), each
   run after ``make_train_step`` from the same seed and held to it
   bitwise (losses and every parameter; the SR generator included), both
   step times printed, the sharded run's K1, K2, K4-K7 launches exact;
   (b) GPT-MoE at gpt3-350m's widths (8 experts in 2 MoE layers,
   capacity 1.25, B 16, S 1024: N 16384, C 2560; bf16, fp32 masters,
   fusion on, 6 steps): the loss starts within 0.5 of ln V and falls,
   the fusion report lists 2L + M + 1 layer epilogues and L bias_gelu,
   every MoE layer's dispatch and combine are bitwise the reference's
   dense one-hot form on the card, and it prints the dropped share a
   layer, the step against (a)'s, the MoE layers' forward + backward ms
   by CUDA events and the peak memory; (c) a small fp32 GPT-MoE through
   the sharded entry on the card and on the CPU, within TRAIN_CPU_RTOL
   / TRAIN_CPU_ATOL. NCCL puts one rank on one device, so a mesh of
   more ranks runs here only over gloo: phase ``pipe`` runs two such
   ranks on the card; tests/test_torch_sharded_*.py, test_torch_pipeline
   and test_torch_ring hold every mesh to the reference on the CPU.
19. ``pipe``: the pipeline and ring attention over two gloo ranks that
   share the card (``init_from_env(backend="gloo")``; NCCL
   refuses two ranks on one device, so the times are not a pp = 2
   speed), started after the parent built every kernel. (a)
   gpt3-350m at pp 2 (12 layers a stage), M 4, B 16, S 1024, bf16 with
   fp32 masters, 3 steps of "1f1b" and 3 of "gpipe": the first loss
   within PIPE_LOSS_RTOL of make_train_step's from the same seed, the
   losses falling, each rank's launches exact (stash and replay: K1
   2·12·M, K2 12·M, K6 4·12·M, K7 2·12·M a step; the last stage's tail
   K6, K4, K5 once a microbatch), every bf16 flash launch wgmma; a small
   fp32 GPT pipelined against make_train_step on the card within
   TRAIN_CPU_RTOL / TRAIN_CPU_ATOL. Prints each schedule's step ms, the
   staged bytes a step, each rank's peak memory and stash. (b)
   ring attention over sep 2 at [1, 8192, 16, 64], fp32 and bf16,
   forward and gradients against the function in fp64 (fp32 also
   against the cp = 1 block attention; PIPE_RING_TOL, scaled; dq's
   first row to the zero-row floor). (c) ``ring_axis="mp"`` through the
   sharded entry on the one-device mesh at gpt3-350m: K1-sep and K3-sep
   first held at its attention shape [16, 1024, 16, 64] bf16 against
   their plain versions and bitwise against K1 and K3's fused mode on
   the packed qkv; then 3 steps, K1-sep 24 and K3-sep 48 a step, no K1
   or K2, each loss within PIPE_LOSS_RTOL of the fused-qkv step's.

20. ``eager``: the Paddle eager API on the card. (a) The eager
    ``models.gpt.GPT`` Layer at gpt3-350m (B 16, S 1024, bf16 compute,
    fp32 parameters; ``to_tensor``, ``optimizer.AdamW`` with
    ``nn.ClipGradByGlobalNorm(1.0)``, ``loss.backward(); opt.step();
    opt.clear_grad()``) for three steps on phase train's batch: its
    first loss bit-equal to ``make_train_step``'s, its launches a step
    phase train's (K1 24, K2 24, K4 2, K5 21, K6 49, K7 24), one funnel
    op a step; step ms, ``opt.step()`` ms, peak memory. (b)
    ``nn.functional.scaled_dot_product_attention`` at BERT-base's
    attention shape, [8, 512, 12, 64] bf16, causal and not, through the
    funnel: K1-sep once and K3-sep twice a call, held against their
    plain versions; the flag-off route (the reference's expression)
    beside it; K1-sep, K3-sep and SDPA timed non-causal. (c)
    ``check_nan_inf`` at levels 0 and 1 and off. (d) AMP: O1 casts, the
    fp16 GradScaler's skipped step, O2 decoration. (e) An fp32 Layer
    (2 layers, hidden 256) three AdamW steps on the card and the CPU.

21. ``bert``: BERT-base pretraining through the Paddle API
    (``models.bert``: ``nn.Embedding``, ``nn.TransformerEncoder`` and
    its ``MultiHeadAttention``, ``nn.LayerNorm``, ``F.cross_entropy``).
    (a) ``bert_base()`` with attention dropout 0 (hidden dropout 0.1),
    B 32, S 512, fp32 parameters, AMP O1 bf16, AdamW (lr 1e-4, weight
    decay 0.01): one warm-up step and 3 timed ones, each with 12 funnel
    ops ``pallas_flash_attention`` and none ``scaled_dot_product_
    attention``, K1-sep 12 and K3-sep 24 launches, all wgmma; the first
    loss finite and within BERT_LOSS_RTOL of the same weights' with
    ``use_pallas_attention`` off (the same dropout draws); K1-sep and
    K3-sep at [32, 512, 12, 64] bf16 held against their plain versions
    and timed beside SDPA; step ms, tokens/s, ``opt.step()`` ms, peak
    memory, MFU. (b) ``model.eval()`` at the default config (dropouts
    0.1): K1-sep 12 and K3-sep 0 launches, the logits within BF16_TOL
    (scaled) of the flag-off route's. (c) Training at the default
    config: attention dropout 0.1 takes the plain expression, no flash
    launch; its step ms beside (a)'s. One more step of (a) runs under
    torch.profiler (device busy share, launches, time by kernel kind of
    the forward + backward and of ``opt.step()``). (d) A small fp32 BERT (2 layers,
    hidden 256, 4 heads of 64, S 128): three AdamW steps on the card
    and on the CPU from the same weights, losses within TRAIN_CPU_RTOL.

22. ``resnet``: ResNet-50 training through the Paddle API
    (``vision.models.resnet50``: ``nn.Conv2D`` / ``F.conv2d`` on cuDNN,
    ``nn.BatchNorm2D``, ``nn.MaxPool2D``, ``nn.AdaptiveAvgPool2D``,
    ``optimizer.Momentum``). (a) 1000 classes, B 64 of 3 x 224 x 224 from
    seed 0, AMP O1 bf16, Momentum (lr 0.1, momentum 0.9, weight decay
    1e-4): 2 warm-up steps and 5 timed ones; step ms, images/s, peak
    memory, MFU (conv and fc FLOPs), the funnel ops a step, no launch of
    the 21 port kernels; the first loss within RESNET_LOSS_RTOL of the
    fp32 route's on the same weights; the losses finite; one more step
    under torch.profiler. (b) ``save`` / ``load`` of the model's and the
    Momentum state after the warm-up, into a fresh model and optimizer:
    the next step's loss and every tensor bitwise equal to the
    uninterrupted run's (cuDNN deterministic for both). (c) fp32 card
    against CPU: resnet18 (B 4, 64 x 64) logits and first conv gradient,
    the conv / pooling / grid_sample cases that differ from torch's
    defaults, a 2-layer bidirectional LSTM and GRU (hidden 256, T 64, B 8).
    (d) PyLayer, saved_tensors_hooks and jacobian / hessian / vjp / jvp on
    CUDA tensors against the CPU.

23. ``ops``: the op library's long tail (``ops/linalg.py``, ``extra.py``,
    ``extra2.py``, ``parity.py``). (a) Every op of the four modules, on
    the cases of the CPU tests (``tests/torch_ops_cases.py``), on CUDA
    tensors against the same op on CPU tensors: integers exact, floats
    within FP32_TOL of the largest magnitude, decompositions by their
    invariants. (b) The slice at full width, each row's error, bar and
    time on one line: ``flash_attn_qkvpacked`` at gpt3-350m's attention
    ([16, 1024, 3, 16, 64] bf16, causal, forward and backward through
    K1-sep / K3-sep, one and two launches) against the plain versions at
    BF16_TOL, beside SDPA; ``top_p_sampling`` at llama3-8b's vocabulary
    with a seed (the card's ids the CPU's, each in its nucleus);
    ``llm_int8_linear`` at llama3-8b's MLP against the CPU, beside
    torch.matmul; the MoE auxiliaries at the GPT-MoE routing, equal to
    the CPU; ``svd_lowrank`` / ``pca_lowrank`` of a rank-16 [4096, 4096]
    matrix; ``einsum("bhqd,bhkd->bhqk")`` at [16, 16, 1024, 64] bf16;
    ``cholesky`` / ``solve`` / ``inverse`` / ``slogdet`` of a [1024,
    1024] SPD matrix; ``multiclass_nms3`` at 80 classes x 1000 boxes.

24. ``dp_mp``: the collective API, ``DataParallel`` and the fleet's
    tensor-parallel Layers on two gloo ranks that share the card
    (``fleet.init`` joins them over gloo: NCCL refuses two ranks on one
    device, so the times are not a dp or mp speed). (a) BASELINE.md
    configuration 2: BERT-base pretraining (dropouts 0, 80 MLM labels a
    sequence) under ``fleet.distributed_model`` (``DataParallel``), dp 2
    x B 16, S 512, AMP O1 bf16, AdamW, 3 steps: the mean of the ranks'
    first losses within BERT_LOSS_RTOL of one rank's at B 32 on the same
    weights, the synced gradients bitwise the average of the two B 16
    halves' gradients taken on one rank, and that average (in fp32)
    within FP32_TOL of the B 32 gradient (relative Frobenius); under AMP
    each leaf of the synced gradients within BF16_TOL of one rank's at
    B 32 (relative Frobenius), or within that rank's own AMP distance
    from the fp32 gradient where that is larger (the key biases, 0 in
    exact arithmetic, within BF16_TOL of the largest gradient), two B 32
    steps' gradients bitwise
    equal, the token-type table's gradient within BF16_TOL of its exact
    sum (the port's fp32-summed lookup backward; torch's bf16 one
    printed), the parameters bitwise equal on both ranks after 3 steps,
    the bytes all-reduced a step exactly the gradients' bytes, K1-sep 12
    and K3-sep 24 launches a rank a step, all wgmma. (b) Configuration
    3: a GPT at GPT-3 1.3B's widths (hidden 2048, 24 layers, 16 heads
    of 128, vocab 50304; tests/torch_mp_gpt.py) of
    ``VocabParallelEmbedding``, ``ColumnParallelLinear``,
    ``RowParallelLinear`` and ``ParallelCrossEntropy`` at mp 2, B 4, S
    1024, AMP O1, AdamW with ``ClipGradByGlobalNorm`` through
    ``fleet.distributed_optimizer``, 3 steps: the first loss and clip
    norm within DP_MP_RTOL of the same global weights' at mp 1 on one
    rank, K1-sep 24 and K3-sep 48 a rank a step on its 8 heads, all
    wgmma; every block under ``fleet.recompute`` from the same weights:
    its gradients within BF16_TOL (scaled) of the plain step's, its
    peak under the plain forward + backward's. (c) Small fp32 cases, a
    BERT under DataParallel at dp 2 and the mp GPT at mp 2, 3 steps on
    the card and on the CPU over the same ranks: losses within
    TRAIN_CPU_RTOL, parameters within TRAIN_CPU_ATOL. (d) DataParallel
    over NCCL at world 1: the wrapped step bitwise the unwrapped one.
    (e) Every eager collective of ``distributed/collective.py`` on CUDA
    tensors over the two gloo ranks, held to its definition (the split
    all-to-all with uneven splits, ``all_gather_object``, ``barrier``,
    send / recv through pinned host memory). Prints each part's step
    ms, tokens/s, peaks, the all-reduce ms of (a) and the mp all-reduce
    ms of (b).

After each of the phases train, train_13b, llama_train, decode, paged,
resilient, dist, pipe and dp_mp (the ranks' launches included), eager,
bert and ops every bf16 flash launch at head dim 64 or 128 must have taken
the TMA + wgmma variant, as the C launchers report what they launched
(``flash_attention.LAUNCHES_BY_PLAN``), and at every shape launched the
C launchers' plan must be ``flash_plan``'s. After each of the phases
engine and int8, cpu, serving and rollout every K8 / K8q launch must
have taken its plan's variant, every bf16 one at head dim 128 the split
/ TMA ring / wgmma one (``ragged_paged_attention.LAUNCHES_BY_PLAN``), and
at every shape launched ``rpa_plan_c`` must equal ``rpa_plan``.

Prints the card's name and power limit, one JSON line ``{"kernels": ...}``
and, last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

PHASES = ("kernels", "engine", "int8", "cpu", "train_kernels", "train",
          "train_cpu", "train_13b", "llama_train", "decode_kernels",
          "decode", "decode_cpu", "serving_kernels", "serving",
          "paged_kernels", "paged", "fleet", "rollout", "resilient",
          "dist", "pipe", "eager", "bert", "resnet", "ops", "dp_mp")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores (K6, K7)
RPA_BF16_ATOL = 2e-2             # bf16 output; plain rounds p/l to bf16
RPA_FP32_ATOL = 1e-4             # fp32 inputs, TF32 off, sum order only
QMM_ATOL = 1e-3                  # fp32 accumulators, sum order only
MARGIN = 1e-4                    # CPU top-2 logit margin of a tie
# training kernels: each element's error over the larger of its own
# magnitude and the RMS of its row (head row of o / dqkv, token row of dx,
# vocab column of dhead), see _scaled_err
BF16_TOL = 3 * 2 ** -7           # 3 bf16 ulps (an ulp is <= 2^-7 of a value):
                                 # each side's output rounding, and p or dl
                                 # rounded against another running max
ZERO_ROW = 1e-3                  # rows under this share of the tensor's RMS
                                 # are rounding noise of an exact 0 (dq of
                                 # query 0: ds = p (dp - delta) = 0)
FP32_TOL = 1e-4                  # fp32 inputs, TF32 off, sum order only
CE_FWD_ATOL = 1e-3               # fp32 nll / lse from bf16 operands
CE_LOGIT_STD = 3.0               # x ~ N(0, 1), wte ~ N(0, 9 / H): the top
                                 # probability of a row is ~0.1, not ~1 / V
TRAIN_CPU_RTOL = 1e-4            # card vs CPU losses, fp32
TRAIN_CPU_ATOL = 1e-4            # card vs CPU parameters after 3 steps


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed, so that the host's share (the wrapper, the launch)
    drops out of the reading."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5, warmup=1) / iters


def _bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# phases whose every bf16 flash launch at head dim 64 or 128 must take the
# TMA + wgmma variant (flash_attention.flash_plan)
FLASH_WGMMA_PHASES = ("train", "train_13b", "llama_train", "decode", "paged",
                      "resilient", "dist", "pipe", "eager", "bert", "ops",
                      "dp_mp")


def _flash_launch_counts() -> collections.Counter:
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return collections.Counter(fa.LAUNCHES_BY_PLAN)


def _check_flash_variants(tag: str, before: collections.Counter) -> None:
    """The flash launches since ``before``, by (variant as the C launcher
    reported it, dtype, head dim, S, part, (batch, head) pairs): every
    bf16 one at head dim 64 or 128 took "wgmma", at least one did, and at
    every shape launched the C launchers' plan (``flash_plan_c``) is
    flash_plan's."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    diff = fa.LAUNCHES_BY_PLAN - before
    for (variant, dt, d, S, part, bh), n in sorted(diff.items()):
        dtype = getattr(torch, dt)
        plan = fa.flash_plan(S, d, dtype, part, bh=bh)
        if fa.flash_plan_c(S, d, dtype, part, bh=bh) != plan:
            raise AssertionError(f"{tag}: flash_plan_c {S} {d} {dt} {part} "
                                 f"!= flash_plan {plan}")
        if dt == "bfloat16" and d in (64, 128) and variant != "wgmma":
            raise AssertionError(f"{tag}: {n} bf16 d{d} flash {part} "
                                 f"launches took {variant}")
    wg = sum(n for key, n in diff.items() if key[0] == "wgmma")
    print(f"{tag}: flash launches by (variant, dtype, d, S, part, bh): "
          + ", ".join(f"{k}: {n}" for k, n in sorted(diff.items())))
    if wg == 0:
        raise AssertionError(f"{tag}: no flash launch took the wgmma variant")


RPA_SHAPE = (32, 16, 32, 8, 128, 128, 16, 129)  # C qb nH nKV d bs mb P
# phases whose every bf16 d 128 K8 / K8q launch must take the split / TMA
# ring / wgmma variant (ragged_paged_attention.rpa_plan)
RPA_WGMMA_PHASES = ("engine/int8", "cpu", "serving", "rollout")


def _rpa_launch_counts() -> collections.Counter:
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    return collections.Counter(rpa.LAUNCHES_BY_PLAN)


def _check_rpa_variants(tag: str, before: collections.Counter) -> None:
    """The K8 / K8q launches since ``before``, by (variant as the C entry
    reported it, dtype, d, bs, mb, G, qb, int8 pages): each took its
    plan's variant, every bf16 one at head dim 128 "wgmma", at least one
    launched, and at every shape launched the C launcher's plan
    (``rpa_plan_c``) is ``rpa_plan``'s."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    diff = rpa.LAUNCHES_BY_PLAN - before
    if not diff:
        raise AssertionError(f"{tag}: no K8 / K8q launch")
    clusters = []
    for (variant, dt, d, bs, mb, G, qb, quant), n in sorted(diff.items()):
        dtype = getattr(torch, dt)
        plan = rpa.rpa_plan(mb, bs, d, G, qb, dtype, quant)
        plan_c = rpa.rpa_plan_c(mb, bs, d, G, qb, dtype, quant)
        if {k: plan_c[k] for k in plan} != plan:
            raise AssertionError(f"{tag}: rpa_plan_c {plan_c} != rpa_plan "
                                 f"{plan} at mb {mb} bs {bs} d {d} {dt}")
        if variant != plan["variant"] or (dt == "bfloat16" and d == 128
                                          and variant != "wgmma"):
            raise AssertionError(f"{tag}: {n} {dt} d{d} K8 launches took "
                                 f"{variant}, plan {plan['variant']}")
        clusters.append(plan_c["clusters"])
    print(f"{tag}: K8/K8q launches by (variant, dtype, d, bs, mb, G, qb, "
          "int8): " + ", ".join(f"{k}: {n}" for k, n in sorted(diff.items()))
          + f"; clusters the card holds at once (wgmma) {clusters}")


def _rpa_rows(dev):
    """The llama3-8b engine step's attention rows: decode rows, page-
    straddling prefill chunks, partial chunks and idle sink rows. Returns
    (rows, pos0, n_valid) on ``dev``, the number of pages the chunks
    reach (a page shared by chunks counted once) and the flops of the
    valid query rows' dots over their causal keys."""
    C, qb, nH, nKV, d, bs, mb, P = RPA_SHAPE
    rng = np.random.RandomState(1)
    rows = np.zeros((C, mb), np.int32)
    pos0 = np.zeros((C,), np.int32)
    nval = np.ones((C,), np.int32)
    for c in range(24):
        rows[c] = rng.permutation(np.arange(1, P))[:mb]
        if c < 8:                                  # decode rows
            pos0[c], nval[c] = rng.randint(0, mb * bs), 1
        elif c < 20:                               # prefill chunks
            pos0[c] = 120 + 128 * (c - 8) % 1900   # straddle pages
            nval[c] = qb
        else:                                      # partial chunks
            pos0[c], nval[c] = rng.randint(0, 1500), rng.randint(2, qb)
    # rows 24.. stay idle against the sink page: pos0 0, n_valid 1
    pages = set()
    flops = 0.0
    for c in range(C):
        last = pos0[c] + nval[c] - 1
        pages.update(int(p) for p in rows[c, :last // bs + 1])
        for i in range(nval[c]):
            flops += 4.0 * nH * d * (pos0[c] + i + 1)
    return (tuple(torch.from_numpy(a).to(dev) for a in (rows, pos0, nval)),
            len(pages), flops)


def _sdpa_on_pages(q, kp, vp, rows_t, pos_t, nv_t, scale):
    """The library yardstick of K8 and K8q: SDPA over the pre-gathered
    pages (GQA expanded) with the engine's mask; a timing closure."""
    C, qb, nH, d = q.shape
    nKV, bs, mb = kp.shape[1], kp.shape[3], rows_t.shape[1]
    dev = q.device
    idx = rows_t.long()
    kg = kp[idx].permute(0, 2, 1, 4, 3).reshape(C, nKV, mb * bs, d)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(C, nKV, mb * bs, d)
    kg = kg.repeat_interleave(nH // nKV, dim=1)
    vg = vg.repeat_interleave(nH // nKV, dim=1)
    qh = q.transpose(1, 2)
    qpos = pos_t[:, None] + torch.minimum(
        torch.arange(qb, device=dev)[None, :], nv_t[:, None] - 1)
    mask = (torch.arange(mb * bs, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kg, vg, attn_mask=mask, scale=scale)


# query positions the row-independence holds put on tile (64) and page
# (128) edges and on split edges (1024 keys a split at mb 16 and 32)
RPA_EDGE_POS = (0, 1, 63, 64, 127, 128, 129, 255, 256, 511, 512, 1023, 1024,
                1025, 1500, 2047, 2048, 3071, 3072, 4095)


def _digest(*ts) -> str:
    """A short digest of tensors' bits, to compare two checkouts' output."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _rpa_row_independence(dev, mb: int, quant: bool, seed: int) -> int:
    """K8 (K8q with ``quant``) at llama3-8b's attention width (nH 32, nKV
    8, d 128, bs 128, qb 16, bf16): the same query rows carried by a
    decode chunk (n_valid 1), a verify chunk of 4 rows and a 16-row
    prefill chunk, at every offset of those chunks, for positions on page
    and split edges (``RPA_EDGE_POS``), beside filler chunks (decode rows
    of other requests, idle sink rows), spread over calls of different C.
    Every carried row must be torch.equal to the decode chunk's. Returns
    the rows held."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    nH, nKV, d, bs, qb = 32, 8, 128, 128, 16
    S = mb * bs
    P = mb + 9
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16
    q_all = torch.randn((S, nH, d), generator=gen, device=dev).to(bf)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8)
                  for shape in ((P, nKV, d, bs), (P, nKV, bs, d)))
        sc = [torch.rand((P, nKV), generator=gen, device=dev) * 0.02 + 0.01
              for _ in range(2)]
    else:
        kp = torch.randn((P, nKV, d, bs), generator=gen, device=dev).to(bf)
        vp = torch.randn((P, nKV, bs, d), generator=gen, device=dev).to(bf)
        sc = [None, None]
    table = np.asarray(rng.permutation(np.arange(1, P))[:mb], np.int32)
    carriers = [(p, nv, o) for p in RPA_EDGE_POS if p < S
                for nv in (1, 4, 16) for o in range(nv)
                if p - o >= 0 and p - o + nv <= S]
    order = rng.permutation(len(carriers))
    got = {}
    i, call, sizes = 0, 0, (37, 64, 5, 61, 23, 64, 48)
    while i < len(order):
        n = min(sizes[call % len(sizes)], len(order) - i)
        call += 1
        fill = rng.randint(0, 4)
        C = n + fill
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(bf)
        rows = np.zeros((C, mb), np.int32)
        pos0 = np.zeros(C, np.int32)
        nval = np.ones(C, np.int32)
        slots = rng.permutation(C)
        mine = []
        for k, idx in enumerate(order[i:i + n]):
            p, nv, o = carriers[idx]
            c = int(slots[k])
            rows[c], pos0[c], nval[c] = table, p - o, nv
            q[c, :nv] = q_all[p - o:p - o + nv]
            mine.append((c, carriers[idx]))
        for c in slots[n:]:
            if rng.rand() < 0.5:             # another request's decode row
                rows[c] = rng.randint(1, P, size=mb)
                pos0[c] = rng.randint(0, S)
            # else idle against the sink page: pos0 0, n_valid 1
        out = rpa.ragged_paged_attention(
            q, kp, vp, *(torch.from_numpy(a).to(dev)
                         for a in (rows, pos0, nval)), d ** -0.5,
            k_scales=sc[0], v_scales=sc[1])
        for c, (p, nv, o) in mine:
            got[(p, nv, o)] = out[c, o]
        i += n
    held = 0
    for (p, nv, o), row in got.items():
        ref = got[(p, 1, 0)]
        if not torch.equal(row, ref):
            n_diff = (row != ref).sum().item()
            raise AssertionError(
                f"K8{'q' if quant else ''} mb {mb}: position {p} carried at "
                f"offset {o} of a {nv}-row chunk differs from the decode "
                f"chunk's row in {n_diff} elements")
        held += 1
    return held


def check_rpa(dev) -> dict:
    """K8 at the llama3-8b attention shapes (``_rpa_rows``): fp32 (the FMA
    kernel) and bf16 (the split / TMA ring / wgmma kernel, whose C plan
    must be ``rpa_plan``'s) against the plain version; eager and device
    (CUDA graph) times beside SDPA on pre-gathered pages; a digest of the
    bf16 output; row independence at mb 16 and 32."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    C, qb, nH, nKV, d, bs, mb, P = RPA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    (rows_t, pos_t, nv_t), n_pages, flops = _rpa_rows(dev)
    scale = 1.0 / math.sqrt(d)
    errs = {}
    for dt, tol in ((torch.float32, RPA_FP32_ATOL),
                    (torch.bfloat16, RPA_BF16_ATOL)):
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(dt)
        kp = torch.randn((P, nKV, d, bs), generator=gen, device=dev).to(dt)
        vp = torch.randn((P, nKV, bs, d), generator=gen, device=dev).to(dt)
        before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
        got = rpa.ragged_paged_attention(q, kp, vp, rows_t, pos_t, nv_t,
                                         scale)
        ref = rpa.ragged_paged_attention_plain(q, kp, vp, rows_t, pos_t,
                                               nv_t, scale)
        torch.cuda.synchronize()
        _check_rpa_variants(f"rpa {dt}", before)
        valid = (torch.arange(qb, device=dev)[None, :] < nv_t[:, None])
        err = (got.float() - ref.float()).abs()[valid].max().item()
        print(f"rpa {dt}: max_abs_err {err:.3e} (atol {tol})")
        if not err <= tol:
            raise AssertionError(f"rpa {dt}: max_abs_err {err} > {tol}")
        errs[dt] = err
    print(f"rpa bf16 output digest {_digest(got)}")
    fn = lambda: rpa.ragged_paged_attention(q, kp, vp, rows_t, pos_t, nv_t,
                                            scale)
    ms, graph_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: rpa.ragged_paged_attention_plain(
        q, kp, vp, rows_t, pos_t, nv_t, scale))
    sdpa = _sdpa_on_pages(q, kp, vp, rows_t, pos_t, nv_t, scale)
    library_ms, graph_library_ms = _time_ms(sdpa), _graph_ms(sdpa)
    # what these inputs need: q and o once, every page a chunk reaches
    # once (pages shared between chunks counted once), and the dots of
    # the valid query rows over their causal keys
    nbytes = (2 * q.numel() * 2 + n_pages * 2 * nKV * bs * d * 2
              + (rows_t.numel() + 2 * C) * 4)
    bound_ms, bound_by = _bound(nbytes, flops)
    held = sum(_rpa_row_independence(dev, m, False, 30 + m)
               for m in (16, 32))
    print(f"rpa bf16: row independence: {held} carried rows bit-equal to "
          "their decode chunk's (mb 16 and 32)")
    print(f"rpa bf16: kernel {ms:.4f} ms (device {graph_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (device "
          f"{graph_library_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "ragged_paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:85",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32":
            errs[torch.float32], "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "graph_library_ms": graph_library_ms,
            "shape": f"C{C} qb{qb} nH{nH} nKV{nKV} d{d} bs{bs} mb{mb}"}


def check_rpa_int8(dev) -> dict:
    """K8q at the llama3-8b attention shapes (``_rpa_rows``), int8 pages
    with [P, nKV] fp32 scales, bf16 (the wgmma kernel, int8 boxes through
    its ring) and fp32 q (FMA kernel): equal to K8 on the pre-dequantized
    pages (torch.equal: the dequantized tiles are the same bits, so any
    difference is the dequant), and within K8's tolerance of the plain
    version; eager and device times, a digest, row independence at mb
    16."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.quant import dequantize_int8

    C, qb, nH, nKV, d, bs, mb, P = RPA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(21)
    (rows_t, pos_t, nv_t), n_pages, flops = _rpa_rows(dev)
    scale = 1.0 / math.sqrt(d)
    kq, vq = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8)
              for shape in ((P, nKV, d, bs), (P, nKV, bs, d)))
    ks, vs = (torch.rand((P, nKV), generator=gen, device=dev) * 0.02 + 0.01
              for _ in range(2))
    valid = (torch.arange(qb, device=dev)[None, :] < nv_t[:, None])
    errs = {}
    for dt, tol in ((torch.float32, RPA_FP32_ATOL),
                    (torch.bfloat16, RPA_BF16_ATOL)):
        q = torch.randn((C, qb, nH, d), generator=gen, device=dev).to(dt)
        kd = dequantize_int8(kq, ks[:, :, None, None], dt)
        vd = dequantize_int8(vq, vs[:, :, None, None], dt)
        before = collections.Counter(rpa.LAUNCHES_BY_PLAN)
        got = rpa.ragged_paged_attention_int8(q, kq, vq, ks, vs, rows_t,
                                              pos_t, nv_t, scale)
        torch.cuda.synchronize()
        _check_rpa_variants(f"K8q {dt}", before)
        k8 = rpa.ragged_paged_attention(q, kd, vd, rows_t, pos_t, nv_t,
                                        scale)
        ref = rpa.ragged_paged_attention_plain(q, kq, vq, rows_t, pos_t,
                                               nv_t, scale, ks, vs)
        torch.cuda.synchronize()
        if not torch.equal(got, k8):
            n = (got != k8).sum().item()
            raise AssertionError(f"K8q {dt}: {n} elements differ from K8 "
                                 "on the pre-dequantized pages")
        err = (got.float() - ref.float()).abs()[valid].max().item()
        print(f"K8q {dt}: equal to K8 on dequantized pages; max_abs_err "
              f"{err:.3e} against plain (atol {tol})")
        if not err <= tol:
            raise AssertionError(f"K8q {dt}: max_abs_err {err} > {tol}")
        errs[dt] = err
    print(f"K8q bf16 output digest {_digest(got)}")
    fn = lambda: rpa.ragged_paged_attention_int8(q, kq, vq, ks, vs, rows_t,
                                                 pos_t, nv_t, scale)
    ms, graph_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: rpa.ragged_paged_attention_plain(
        q, kq, vq, rows_t, pos_t, nv_t, scale, ks, vs))
    sdpa = _sdpa_on_pages(q, kd, vd, rows_t, pos_t, nv_t, scale)
    library_ms, graph_library_ms = _time_ms(sdpa), _graph_ms(sdpa)
    # q and o (bf16) once, the int8 pages the chunks reach once with
    # their two fp32 scales, the int32 rows
    nbytes = (2 * q.numel() * 2 + n_pages * 2 * nKV * (bs * d + 4)
              + (rows_t.numel() + 2 * C) * 4)
    bound_ms, bound_by = _bound(nbytes, flops)
    held = _rpa_row_independence(dev, 16, True, 41)
    print(f"K8q bf16: row independence: {held} carried rows bit-equal to "
          "their decode chunk's (mb 16)")
    print(f"K8q bf16: kernel {ms:.4f} ms (device {graph_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa on dequantized pages {library_ms:.4f} "
          f"ms (device {graph_library_ms:.4f}), bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"name": "ragged_paged_attention_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:85",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32], "ms": ms,
            "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "graph_library_ms": graph_library_ms,
            "shape": f"C{C} qb{qb} nH{nH} nKV{nKV} d{d} bs{bs} mb{mb} int8"}


LORA_TOL = 1e-5        # fp32 products of exact bf16 widenings; sum order


def _lora_launch_counts() -> collections.Counter:
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    return collections.Counter(lm.LAUNCHES_BY_PLAN)


def _check_lora_variants(tag: str, before: collections.Counter,
                         want: int | None = None) -> int:
    """The K13 launches since ``before``, by (variant as the C entry
    reported it, dtype, H, N, r): every one took the cluster kernel, at
    every shape launched the C launcher's plan (``lora_plan_c``) is
    ``lora_plan``'s, and there are ``want`` of them where given. Returns
    their number."""
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    diff = lm.LAUNCHES_BY_PLAN - before
    for (variant, dt, H, N, r), n in sorted(diff.items()):
        es = torch.empty((), dtype=getattr(torch, dt)).element_size()
        plan = lm.lora_plan(H, N, r, es)
        if lm.lora_plan_c(H, N, r, es) != plan:
            raise AssertionError(f"{tag}: lora_plan_c {H} {N} {r} {dt} != "
                                 f"lora_plan {plan}")
        if variant != "cluster":
            raise AssertionError(f"{tag}: {n} K13 launches took {variant}")
    total = sum(diff.values())
    print(f"{tag}: K13 launches by (variant, dtype, H, N, r): "
          + ", ".join(f"{k}: {n}" for k, n in sorted(diff.items())))
    if total == 0 or (want is not None and total != want):
        raise AssertionError(f"{tag}: {total} K13 launches, want "
                             f"{want if want is not None else '> 0'}")
    return total


def _lora_row_independence(lm, x, a, b, ids, gen) -> int:
    """Rows of ``x`` carried again at other (c, i) in calls of other C
    (1, 5 and 40 packed rows, the rest random rows on random slots):
    each carried row's output is ``torch.equal`` to the first call's."""
    C, qb, H = x.shape
    S = a.shape[0]
    ref = lm.lora_matmul(x, a, b, ids)
    rng = np.random.RandomState(5)
    held = 0
    for C2 in (1, 5, 40):
        x2 = torch.randn((C2, qb, H), generator=gen, device=x.device).to(
            x.dtype)
        ids2 = torch.from_numpy(rng.randint(0, S, size=C2).astype(
            np.int32)).to(x.device)
        moves = []
        for _ in range(min(C2 * qb, 12)):
            src = (rng.randint(C), rng.randint(qb))
            dst = (rng.randint(C2), rng.randint(qb))
            if any(m[1][0] == dst[0] for m in moves):
                continue                     # one source row's slot a c
            x2[dst] = x[src]
            ids2[dst[0]] = ids[src[0]]
            moves.append((src, dst))
        got = lm.lora_matmul(x2, a, b, ids2)
        for src, dst in moves:
            if not torch.equal(got[dst], ref[src]):
                raise AssertionError(f"K13: row {src} carried at {dst} of "
                                     f"a {C2}-row call differs")
            held += 1
    return held


def check_lora(dev) -> dict:
    """K13 at the llama3-8b engine step's shapes: x [32, 16, 4096] bf16,
    rank 8, 5 slots (slot 0 the zero identity), N 4096 (q) and 1024 (v),
    mixed ids with 0; fp32 out held by row to the plain version within
    LORA_TOL (``_scaled_err``), slot-0 rows exactly 0; a row's bits the
    same at other (c, i) in calls of other C; every launch through the
    cluster kernel at ``lora_plan_c == lora_plan``; eager and device
    (CUDA graph) times beside two fp32 bmm on the pre-gathered A and B;
    a digest of each output."""
    from paddle_tpu_torch.ops.kernels import lora_matmul as lm

    gen = torch.Generator(device=dev).manual_seed(22)
    C, qb, H, r, S = 32, 16, 4096, 8, 5
    x = torch.randn((C, qb, H), generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(22).randint(
        0, S, size=C).astype(np.int32)).to(dev)
    ids[:3] = torch.tensor([0, 1, 4], dtype=torch.int32, device=dev)
    recs = {}
    before = _lora_launch_counts()
    for N in (4096, 1024):
        a = (torch.randn((S, H, r), generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        b = (torch.randn((S, r, N), generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        a[0], b[0] = 0, 0
        got = lm.lora_matmul(x, a, b, ids)
        ref = lm.lora_matmul_plain(x, a, b, ids)
        torch.cuda.synchronize()
        err = _hold(f"K13 N{N}", got, ref, LORA_TOL)
        zero = got[ids == 0]
        if not (zero == 0).all():
            raise AssertionError(f"K13 N{N}: slot-0 rows are not exactly 0")
        held = _lora_row_independence(lm, x, a, b, ids, gen)
        fn = lambda: lm.lora_matmul(x, a, b, ids)  # noqa: E731
        ms, graph_ms = _time_ms(fn), _graph_ms(fn)
        plain_ms = _time_ms(lambda: lm.lora_matmul_plain(x, a, b, ids))
        # library yardstick: two fp32 bmm on the pre-gathered A and B
        xf = x.float()
        ag, bg = a[ids.long()].float(), b[ids.long()].float()
        lib = lambda: torch.bmm(torch.bmm(xf, ag), bg)  # noqa: E731
        library_ms, graph_library_ms = _time_ms(lib), _graph_ms(lib)
        used = len(set(ids.tolist()))
        nbytes = (x.numel() * 2 + used * (H * r + r * N) * 2 + C * 4
                  + C * qb * N * 4)
        bound_ms, bound_by = _bound(nbytes, 2.0 * C * qb * r * (H + N),
                                    FP32_FLOP_PER_S)
        print(f"K13 N{N}: {int((ids == 0).sum())} slot-0 rows exactly 0; "
              f"{held} rows carried at other (c, i) and C bit-equal; output "
              f"digest {_digest(got)}; kernel {ms:.4f} ms (device "
              f"{graph_ms:.4f}), plain {plain_ms:.4f} ms, two fp32 bmm "
              f"{library_ms:.4f} ms (device {graph_library_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        recs[N] = {"name": "lora_matmul", "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/lora_matmul.cu",
                   "replaces": "paddle_tpu/ops/pallas/lora_matmul.py:57",
                   "max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms,
                   "graph_library_ms": graph_library_ms,
                   "shape": f"C{C} qb{qb} H{H} r{r} N{N} bf16"}
        del xf, ag, bg
    _check_lora_variants("K13 kernel checks", before)
    for key in ("ms", "graph_ms", "bound_ms", "library_ms",
                "graph_library_ms"):
        recs[4096][f"{key}_n1024"] = recs[1024][key]
    return recs[4096]


QMM_SHAPES = (  # (M, K, N): the layer matmuls at C*qb = 512, the head at C
    (512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336),
    (512, 14336, 4096), (32, 4096, 128256))
# K9 launches of one llama3-8b engine step by shape: per layer wq and wo,
# wk and wv, w1 and w3, w2; the head once
QMM_STEP_WEIGHTS = (2 * 32, 2 * 32, 2 * 32, 32, 1)


def _int8pack_mm_on_card() -> bool:
    """Whether PyTorch has a CUDA kernel for aten::_weight_int8pack_mm
    (a yardstick only: the port never calls it)."""
    dump = torch._C._dispatch_dump("aten::_weight_int8pack_mm")
    return any(line.startswith("CUDA") for line in dump.splitlines())


def check_qmm(dev) -> dict:
    """K9 at every matmul shape of the int8 engine step, with the variant
    and tile ``qmm_plan`` gave it; the launch-weighted total of one engine
    step; the entry kept for the kernels line is the FFN up-projection,
    the largest."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qmm
    from paddle_tpu_torch.ops.quant import absmax_quantize_int8

    gen = torch.Generator(device=dev).manual_seed(2)
    main = None
    int8pack = _int8pack_mm_on_card()
    step = {"ms": 0.0, "library_ms": 0.0, "int8pack_ms": 0.0,
            "bound_ms": 0.0, "graph_ms": 0.0, "graph_library_ms": 0.0}
    for (M, K, N), n in zip(QMM_SHAPES, QMM_STEP_WEIGHTS):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        wq, s = absmax_quantize_int8(w, axis=-2, scale_dtype=torch.bfloat16)
        plan = qmm.qmm_plan(M, K, N)
        before = qmm.quant_matmul.launches_wgmma
        got = qmm.quant_matmul(x, wq, s)
        ref = qmm.quant_matmul_plain(x, wq, s)
        torch.cuda.synchronize()
        if qmm.quant_matmul.launches_wgmma != before + 1:
            raise AssertionError(f"qmm {M}x{K}x{N}: not the wgmma variant")
        err = (got - ref).abs().max().item()
        if not err <= QMM_ATOL:
            raise AssertionError(f"qmm {M}x{K}x{N}: max_abs_err {err}")
        ms = _time_ms(lambda: qmm.quant_matmul(x, wq, s))
        plain_ms = _time_ms(lambda: qmm.quant_matmul_plain(x, wq, s))
        wb = w.contiguous()
        library_ms = _time_ms(lambda: torch.matmul(x, wb))
        graph_ms = _graph_ms(lambda: qmm.quant_matmul(x, wq, s))
        graph_lib_ms = _graph_ms(lambda: torch.matmul(x, wb))
        pack_ms = None
        if int8pack:
            wt = wq.t().contiguous()                    # [N, K]
            sf = s.reshape(N).to(torch.bfloat16)
            pack_ms = _time_ms(
                lambda: torch._weight_int8pack_mm(x, wt, sf))
            step["int8pack_ms"] += n * pack_ms
            del wt
        nbytes = M * K * 2 + K * N + N * 2 + M * N * 4
        bound_ms, bound_by = _bound(nbytes, 2.0 * M * K * N)
        for k, v in (("ms", ms), ("library_ms", library_ms),
                     ("bound_ms", bound_ms), ("graph_ms", graph_ms),
                     ("graph_library_ms", graph_lib_ms)):
            step[k] += n * v
        tile = {k: plan[k] for k in ("bm", "bn", "tiles", "splits",
                                     "stages")}
        pack = "none on this card" if pack_ms is None else f"{pack_ms:.4f} ms"
        print(f"qmm M{M} K{K} N{N} ({plan['variant']} {tile}): max_abs_err "
              f"{err:.3e} (atol {QMM_ATOL}), kernel {ms:.4f} ms (device "
              f"{graph_ms:.4f} in a CUDA graph), plain {plain_ms:.4f} ms, "
              f"bf16 matmul {library_ms:.4f} ms (device {graph_lib_ms:.4f}), "
              f"_weight_int8pack_mm {pack}, bound {bound_ms:.4f} ms "
              f"({bound_by}), {n} a step")
        rec = {"name": "quant_matmul", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
               "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:53",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "int8pack_ms": pack_ms,
               "graph_ms": graph_ms, "graph_library_ms": graph_lib_ms,
               "shape": f"M{M} K{K} N{N}", "variant": plan["variant"]}
        if N == 14336:
            main = rec
        del x, w, wq, s, wb, got, ref
    print(f"qmm one llama3-8b engine step ({sum(QMM_STEP_WEIGHTS)} K9 "
          f"launches): kernel {step['ms']:.3f} ms (device "
          f"{step['graph_ms']:.3f}), bf16 matmul {step['library_ms']:.3f} ms "
          f"(device {step['graph_library_ms']:.3f}), _weight_int8pack_mm "
          f"{step['int8pack_ms']:.3f} ms (never called by the port), "
          f"bound {step['bound_ms']:.3f} ms")
    main["engine_step_ms"] = step["ms"]
    main["engine_step_library_ms"] = step["library_ms"]
    main["engine_step_graph_ms"] = step["graph_ms"]
    return main


def _requests(cls, vocab: int, seed: int = 0):
    """Eight requests, four at t = 0 and four at t = 0.3 s: half share a
    256-token prefix (the late ones find it in the prefix cache), prompts
    40-600 tokens, greedy and sampled (temperature 0.9, top_p 0.85),
    16-32 new tokens."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab, size=256).astype(np.int32)
    reqs = []
    for i in range(8):
        if i % 2 == 0:
            tail = rng.randint(1, vocab, size=rng.randint(8, 345))
            prompt = np.concatenate([prefix, tail.astype(np.int32)])
        else:
            prompt = rng.randint(1, vocab, size=rng.randint(40, 601)).astype(
                np.int32)
        kw = dict(temperature=0.9, top_p=0.85, seed=100 + i) if i % 4 >= 2 \
            else {}
        reqs.append(cls(rid=i, prompt=prompt, arrival=0.3 * (i >= 4),
                        max_new_tokens=int(rng.randint(16, 33)), **kw))
    return reqs


def run_engine(cfg, params, dev, weight_only_int8: bool,
               profile: bool = False):
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention

    eng = ServingEngine(cfg, params=params, max_batch=8, page_size=128,
                        max_seq=2048, weight_only_int8=weight_only_int8,
                        device=dev)
    reqs = _requests(Request, cfg.vocab_size)
    step_s = []                   # host seconds of each step() call
    step = eng.step

    def timed_step(*args, **kw):
        t = time.perf_counter()
        out = step(*args, **kw)
        step_s.append(time.perf_counter() - t)
        return out

    eng.step = timed_step
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    quant_matmul.launches = quant_matmul.launches_wgmma = 0
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            stats = eng.run(reqs)
            torch.cuda.synchronize()
        _print_profile(prof, stats)
    else:
        stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "quant_matmul": quant_matmul.launches,
                "quant_matmul_wgmma": quant_matmul.launches_wgmma}
    steps = stats["unified_steps"]
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or r.t_done is None:
            raise AssertionError(f"request {r.rid} did not complete")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
    if stats["prefix_cache_hits"] == 0:
        raise AssertionError("no prefix-cache hit on the shared prefix")
    acc = eng.page_accounting()
    if acc["total"] != eng.n_pages - 1:
        raise AssertionError(f"page ledger {acc} != {eng.n_pages - 1}")
    L = cfg.n_layers
    if launches["ragged_paged_attention"] != L * steps:
        raise AssertionError(f"attention launches {launches} != {L} x "
                             f"{steps} steps")
    want_qmm = (7 * L + 1) * steps if weight_only_int8 else 0
    if launches["quant_matmul"] != want_qmm or \
            launches["quant_matmul_wgmma"] != want_qmm:
        raise AssertionError(f"int8 matmul launches {launches} != "
                             f"{want_qmm}")
    tag = "int8" if weight_only_int8 else "bf16"
    print(f"engine {tag}{' (profiled)' if profile else ''}: {len(reqs)} "
          f"requests, {steps} steps, "
          f"{stats['wall_s'] / steps * 1e3:.1f} ms/step (step() median "
          f"{1e3 * float(np.median(step_s)):.1f} ms, first "
          f"{1e3 * step_s[0]:.1f} ms), "
          f"{stats['total_new_tokens']} tokens, "
          f"{stats['throughput_tok_s']:.1f} tok/s, ttft p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms, prefix hits "
          f"{stats['prefix_cache_hits']}, launches {launches}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return reqs, launches


def _print_profile(prof, stats) -> None:
    """Device time by kernel over the engine run (device-side events only:
    a host op's entry would count its kernels twice), and the device's
    busy share of the run's wall time (the profiler's own cost included)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if e.device_type == cuda and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in evs)
    wall_us = stats["wall_s"] * 1e6
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of "
          f"{wall_us / 1e3:.1f} ms wall ({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile: {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def _dense_logits(cfg, params, tokens: np.ndarray) -> torch.Tensor:
    """Plain causal forward of the whole sequence on the CPU (no pages):
    the next-token logits after ``tokens``."""
    from paddle_tpu_torch.models.llama import (_mm, apply_rope, rms_norm,
                                               rope_angles)

    T = len(tokens)
    nH, nKV, dH = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(T, dtype=torch.int32)
    cos, sin = rope_angles(cfg, pos)
    cos, sin = cos[:, None, :], sin[:, None, :]
    x = params["wte"][torch.from_numpy(tokens).long()].to(cfg.dtype)
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    for layer in range(cfg.n_layers):
        bp = {k: v[layer] for k, v in params["blocks"].items()}
        h = rms_norm(x, bp["attn_norm"], cfg.rms_eps)
        q = apply_rope(_mm(h, bp["wq"], cfg).reshape(T, nH, dH), cos, sin)
        k = apply_rope(_mm(h, bp["wk"], cfg).reshape(T, nKV, dH), cos, sin)
        v = _mm(h, bp["wv"], cfg).reshape(T, nKV, dH)
        k = k.repeat_interleave(nH // nKV, dim=1)
        v = v.repeat_interleave(nH // nKV, dim=1)
        s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) / math.sqrt(dH)
        p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, v.float()).to(cfg.dtype)
        x = x + _mm(o.reshape(T, nH * dH), bp["wo"], cfg)
        h = rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
        g = torch.nn.functional.silu(_mm(h, bp["w_gate"], cfg).float())
        x = x + _mm(g.to(cfg.dtype) * _mm(h, bp["w_up"], cfg),
                    bp["w_down"], cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _mm(x[-1:], params["head"], cfg).float()[0]


def check_cuda_vs_cpu(dev) -> None:
    """Greedy streams of a small fp32 config (head dim 128, page 16) on
    the card and on the CPU from identical weights."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params

    cfg = LlamaConfig(vocab_size=1024, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(3),
                                   "cpu")
    cuda_params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                       if isinstance(v, dict) else v.to(dev))
                   for k, v in cpu_params.items()}
    streams = {}
    for name, params, device in (("cpu", cpu_params, "cpu"),
                                 ("cuda", cuda_params, dev)):
        rng = np.random.RandomState(4)
        reqs = [Request(rid=i, prompt=rng.randint(
                    1, 1024, size=rng.randint(10, 120)).astype(np.int32),
                    max_new_tokens=12) for i in range(5)]
        eng = ServingEngine(cfg, params=params, max_batch=2, page_size=16,
                            max_seq=512, prefill_budget=64, device=device)
        eng.run(reqs)
        streams[name] = (reqs, eng.page_accounting())
    exceptions = 0
    for a, b in zip(streams["cpu"][0], streams["cuda"][0]):
        if a.out_tokens == b.out_tokens:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.out_tokens,
                                                   b.out_tokens)) if x != y)
        ctx = np.concatenate([a.prompt, np.asarray(a.out_tokens[:j],
                                                   np.int32)])
        top2 = torch.topk(_dense_logits(cfg, cpu_params, ctx), 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"cpu/cuda: request {a.rid} differs at token {j}, CPU top-2 "
              f"margin {margin:.3e}")
        if margin >= MARGIN:
            raise AssertionError(f"request {a.rid}: streams differ at {j} "
                                 f"with margin {margin}")
        exceptions += 1
    if streams["cpu"][1] != streams["cuda"][1]:
        raise AssertionError(f"ledgers differ: {streams['cpu'][1]} vs "
                             f"{streams['cuda'][1]}")
    print(f"cpu/cuda: {len(streams['cpu'][0])} greedy streams equal, "
          f"{exceptions} near-tie exceptions")


def _scaled_err(got, ref, dim: int = -1) -> tuple[float, float]:
    """(max |got - ref|, max of |got - ref| / max(|ref|, RMS of ref along
    ``dim``)): each element's error in units of its own magnitude, floored
    by its row's RMS so that elements near zero are held to the row's
    scale and rows of small values to their own; rows whose RMS is under
    ZERO_ROW of the whole tensor's are held to that floor."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    rms = r.pow(2).mean(dim=dim, keepdim=True).sqrt()
    floor = ZERO_ROW * r.pow(2).mean().sqrt().item()
    scale = torch.maximum(r.abs(), rms).clamp_min(max(floor, 1e-30))
    return diff.max().item(), (diff / scale).max().item()


def _hold(name: str, got, ref, tol: float, dim: int = -1) -> float:
    err, scaled = _scaled_err(got, ref, dim)
    print(f"{name}: max_abs_err {err:.3e}, scaled {scaled:.3e} (tol "
          f"{tol:.3e})")
    if not scaled <= tol:
        raise AssertionError(f"{name}: scaled error {scaled} > {tol}")
    return err


def _heads(dqkv, h: int):
    """[B, S, 3*h*d] -> [B, S, 3, h, d]: rows of one head of q, k or v."""
    B, S, H3 = dqkv.shape
    return dqkv.reshape(B, S, 3, h, H3 // (3 * h))


def check_flash(dev) -> tuple[dict, dict]:
    """K1 and K2 at the gpt3-350m attention shape (bf16, causal) and at a
    small fp32 case for head dims 64 and 128 (causal and not)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(5)
    for d in (64, 128):
        for causal in (True, False):
            h, S = 256 // d * 2, 256
            qkv = torch.randn((2, S, 3 * h * d), generator=gen, device=dev)
            do = torch.randn((2, S, h, d), generator=gen, device=dev)
            o, lse = fa.flash_fwd(qkv, h, causal, d ** -0.5)
            ro, rlse = fa.flash_fwd_plain(qkv, h, causal, d ** -0.5)
            tag = f"flash fp32 d{d} causal={causal}"
            _hold(tag + " o", o, ro, FP32_TOL)
            _hold(tag + " lse", lse, rlse, FP32_TOL)
            dqkv = fa.flash_bwd(qkv, o, lse, do, h, causal, d ** -0.5)
            ref = fa.flash_bwd_plain(qkv, ro, rlse, do, h, causal, d ** -0.5)
            _hold(tag + " dqkv", _heads(dqkv, h), _heads(ref, h), FP32_TOL)
    B, S, h, d = 16, 1024, 16, 64
    scale = d ** -0.5
    qkv = torch.randn((B, S, 3 * h * d), generator=gen,
                      device=dev).to(torch.bfloat16)
    do = torch.randn((B, S, h, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    o, lse = fa.flash_fwd(qkv, h, True, scale)
    ro, rlse = fa.flash_fwd_plain(qkv, h, True, scale)
    err_o = _hold("flash bf16 o", o, ro, BF16_TOL)
    _hold("flash bf16 o, rows 768..1023", o[:, 768:], ro[:, 768:], BF16_TOL)
    _hold("flash bf16 lse", lse, rlse, FP32_TOL)
    dqkv = fa.flash_bwd(qkv, o, lse, do, h, True, scale)
    again = fa.flash_bwd(qkv, o, lse, do, h, True, scale)
    if not torch.equal(dqkv, again):
        raise AssertionError("flash backward is not deterministic")
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, True, scale)
    err_d = _hold("flash bf16 dqkv", _heads(dqkv, h), _heads(ref, h),
                  BF16_TOL)
    del ro, rlse, ref, again
    torch.cuda.empty_cache()
    fwd_ms = _time_ms(lambda: fa.flash_fwd(qkv, h, True, scale))
    bwd_ms = _time_ms(lambda: fa.flash_bwd(qkv, o, lse, do, h, True, scale))
    fwd_plain = _time_ms(lambda: fa.flash_fwd_plain(qkv, h, True, scale),
                         iters=3, warmup=1)
    bwd_plain = _time_ms(lambda: fa.flash_bwd_plain(qkv, o, lse, do, h,
                                                    True, scale),
                         iters=3, warmup=1)
    # library yardstick: SDPA on contiguous head-major q, k, v
    q, k, v = (t.reshape(B, S, h, d).transpose(1, 2).contiguous()
               .requires_grad_(True) for t in qkv.split(h * d, dim=-1))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = _time_ms(lambda: sdpa(q, k, v, is_causal=True))
    out = sdpa(q, k, v, is_causal=True)
    do_h = do.transpose(1, 2).contiguous()
    lib_bwd = _time_ms(lambda: torch.autograd.grad(out, (q, k, v), do_h,
                                                   retain_graph=True))
    pairs = B * h * S * (S + 1) / 2          # causal (query, key) pairs
    qkv_b, o_b, st_b = qkv.numel() * 2, o.numel() * 2, B * h * S * 4
    f_bound = _bound(qkv_b + o_b + st_b, 4.0 * d * pairs)
    b_bound = _bound(2 * qkv_b + o_b + 2 * st_b, 10.0 * d * pairs)
    print(f"flash fwd: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
          f"sdpa {lib_fwd:.4f} ms, bound {f_bound[0]:.4f} ms ({f_bound[1]})")
    print(f"flash bwd: kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
          f"sdpa bwd {lib_bwd:.4f} ms, bound {b_bound[0]:.4f} ms "
          f"({b_bound[1]})")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = f"B{B} S{S} h{h} d{d} causal"
    return ({"name": "flash_fwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":139", "max_abs_err": err_o,
             "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": f_bound[0],
             "bound_by": f_bound[1], "library_ms": lib_fwd, "shape": shape},
            {"name": "flash_bwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":298", "max_abs_err": err_d,
             "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": b_bound[0],
             "bound_by": b_bound[1], "library_ms": lib_bwd, "shape": shape})


def _hold_long_dqkv(name: str, got, ref) -> float:
    """dqkv [B, S, 3, h, d] at a long sequence: dk, dv and dq's rows
    1..S-1 by row at BF16_TOL; dq's row 0 is 0 in exact arithmetic
    (ds_00 = dp_00 - delta_0 with o_0 = v_0), rounding noise on both
    sides, whose size does not fall with S while the tensor's RMS, and so
    the ZERO_ROW floor, does: both sides' row 0 must lie under that
    floor."""
    err = max(_hold(name + " dk, dv", got[:, :, 1:], ref[:, :, 1:],
                    BF16_TOL),
              _hold(name + " dq rows 1..", got[:, 1:, 0], ref[:, 1:, 0],
                    BF16_TOL))
    floor = ZERO_ROW * ref[:, :, 0].float().pow(2).mean().sqrt().item()
    row0 = max(got[:, 0, 0].float().abs().max().item(),
               ref[:, 0, 0].float().abs().max().item())
    print(f"{name} dq row 0: max |value| {row0:.3e} (floor {floor:.3e})")
    if not row0 <= floor:
        raise AssertionError(f"{name}: dq row 0 reaches {row0} > {floor}")
    return max(err, (got[:, 0, 0].float() - ref[:, 0, 0].float()).abs()
               .max().item())


def _split_timing(fa, inputs, sep: bool, B, S, h, d, plain_iters=3):
    """(K3 ms, K2 ms or None, plain ms, SDPA backward ms, bound, K3
    device ms) of K3 in one mode at one shape: kernel, the merged K2 on
    the same inputs (fused mode), the plain version and the library
    yardstick (the backward of causal SDPA on contiguous head-major q, k,
    v); K3's device time (and K2's) in a CUDA graph of 5 calls."""
    scale = d ** -0.5
    if sep:
        q, k, v, o, lse, do = inputs
        k3 = lambda: fa.flash_bwd_sep(q, k, v, o, lse, do, True, scale)
        ms = _time_ms(k3)
        k2_ms = k2_dev = None
        plain_ms = _time_ms(lambda: fa.flash_bwd_sep_plain(
            q, k, v, o, lse, do, True, scale), iters=plain_iters, warmup=1)
        heads = (q, k, v)
    else:
        qkv, o, lse, do = inputs
        k3 = lambda: fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
        ms = _time_ms(k3)
        k2 = lambda: fa.flash_bwd(qkv, o, lse, do, h, True, scale)
        k2_ms = _time_ms(k2)
        k2_dev = _graph_ms(k2, iters=5)
        plain_ms = _time_ms(lambda: fa.flash_bwd_plain(
            qkv, o, lse, do, h, True, scale), iters=plain_iters, warmup=1)
        heads = qkv.split(h * d, dim=-1)
    dev_ms = _graph_ms(k3, iters=5)
    torch.cuda.empty_cache()
    qh, kh, vh = (t.reshape(B, S, h, d).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in heads)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(qh, kh, vh, is_causal=True)
    do_h = do.transpose(1, 2).contiguous()
    lib_ms = _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do_h,
                                                  retain_graph=True))
    del out, qh, kh, vh, do_h
    torch.cuda.empty_cache()
    pairs = B * h * S * (S + 1) / 2          # causal (query, key) pairs
    qkv_b, o_b, st_b = 3 * B * S * h * d * 2, B * S * h * d * 2, B * h * S * 4
    # the function needs 5 products of 2d flop a pair (s, dp, dq, dk, dv),
    # as K2's bound counts; the dq kernel's second s and dp are K3's cost
    bound = _bound(2 * qkv_b + o_b + 2 * st_b, 10.0 * d * pairs)
    print(f"  device times (CUDA graph): K3 {dev_ms:.4f} ms"
          + ("" if k2_dev is None else f", K2 {k2_dev:.4f} ms"))
    return ms, k2_ms, plain_ms, lib_ms, bound, dev_ms


def check_flash_split(dev) -> tuple[dict, dict]:
    """K3, the split flash backward, in its two modes: fused-qkv at
    gpt3-1.3b's long-context shape (B 1, S 8192, h 16, d 128, bf16; the
    step the 6 MiB gate sends to K3) bit-equal to K2 on the same inputs
    and timed beside it; fused-qkv at S 2048 against its plain version;
    separate at llama1b's training shape (B 2, S 2048, h 16, d 128,
    bf16) against its plain version and bit-equal to the fused mode on
    the same values packed into one qkv; small fp32 cases at head dims
    64, 128 and 256, causal and not, both modes."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(13)
    for d in (64, 128, 256):
        for causal in (True, False):
            h, S = 2, 256
            q, k, v, do = (torch.randn((2, S, h, d), generator=gen,
                                       device=dev) for _ in range(4))
            qkv = torch.cat([t.reshape(2, S, h * d) for t in (q, k, v)], -1)
            o, lse = fa.flash_fwd(qkv, h, causal, d ** -0.5)
            tag = f"flash split fp32 d{d} causal={causal}"
            got = fa.flash_bwd_split(qkv, o, lse, do, h, causal, d ** -0.5)
            ref = fa.flash_bwd_plain(qkv, o, lse, do, h, causal, d ** -0.5)
            _hold(tag + " dqkv", _heads(got, h), _heads(ref, h), FP32_TOL)
            if not torch.equal(got, fa.flash_bwd(qkv, o, lse, do, h, causal,
                                                 d ** -0.5)):
                raise AssertionError(tag + ": K3 != K2")
            sep = fa.flash_bwd_sep(q, k, v, o, lse, do, causal, d ** -0.5)
            if not torch.equal(got, torch.cat([t.reshape(2, S, h * d)
                                               for t in sep], -1)):
                raise AssertionError(tag + ": separate != fused mode")
    bf = torch.bfloat16
    # fused mode at S 2048 against the plain version
    B, S, h, d = 1, 2048, 16, 128
    scale = d ** -0.5
    qkv = torch.randn((B, S, 3 * h * d), generator=gen, device=dev).to(bf)
    do = torch.randn((B, S, h, d), generator=gen, device=dev).to(bf)
    o, lse = fa.flash_fwd(qkv, h, True, scale)
    got = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, True, scale)
    _hold("flash split bf16 S2048 dqkv", _heads(got, h), _heads(ref, h),
          BF16_TOL)
    del got, ref
    torch.cuda.empty_cache()
    ms, k2_ms, plain_ms, lib_ms, bound, _ = _split_timing(
        fa, (qkv, o, lse, do), False, B, S, h, d)
    print(f"flash split bwd B{B} S{S} h{h} d{d}: K3 {ms:.4f} ms, K2 "
          f"{k2_ms:.4f} ms on the same inputs, plain {plain_ms:.4f} ms, "
          f"sdpa bwd {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    del qkv, do, o, lse
    torch.cuda.empty_cache()
    # fused mode at the S 8192 step: K3 == K2, both timed
    B, S = 1, 8192
    qkv = torch.randn((B, S, 3 * h * d), generator=gen, device=dev).to(bf)
    do = torch.randn((B, S, h, d), generator=gen, device=dev).to(bf)
    o, lse = fa.flash_fwd(qkv, h, True, scale)
    got = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    again = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    k2 = fa.flash_bwd(qkv, o, lse, do, h, True, scale)
    if not (torch.equal(got, k2) and torch.equal(got, again)):
        raise AssertionError("flash split S8192: K3 != K2 (or not "
                             "deterministic)")
    ref = fa.flash_bwd_plain(qkv, o, lse, do, h, True, scale)
    err_f = _hold_long_dqkv("flash split bf16 S8192", _heads(got, h),
                            _heads(ref, h))
    del got, again, k2, ref
    torch.cuda.empty_cache()
    ms, k2_ms, plain_ms, lib_ms, bound, dev_f = _split_timing(
        fa, (qkv, o, lse, do), False, B, S, h, d, plain_iters=2)
    print(f"flash split bwd B{B} S{S} h{h} d{d}: K3 {ms:.4f} ms, K2 "
          f"{k2_ms:.4f} ms on the same inputs, plain {plain_ms:.4f} ms, "
          f"sdpa bwd {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/flash_attention.py"
    rec_f = {"name": "flash_bwd_split", "route": "cuda", "source": src,
             "replaces": ref_py + ":195,236", "max_abs_err": err_f,
             "ms": ms, "device_ms": dev_f, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
             "k2_ms": k2_ms, "shape": f"B{B} S{S} h{h} d{d} causal fused"}
    del qkv, do, o, lse
    torch.cuda.empty_cache()
    # separate mode at llama1b's training shape
    B, S = 2, 2048
    q, k, v, do = (torch.randn((B, S, h, d), generator=gen,
                               device=dev).to(bf) for _ in range(4))
    o, lse = fa.flash_fwd_sep(q, k, v, True, scale)
    sep = fa.flash_bwd_sep(q, k, v, o, lse, do, True, scale)
    ref = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, True, scale)
    err_s = 0.0
    for name, a, b in zip("qkv", sep, ref):
        err_s = max(err_s, _hold(f"flash sep bf16 B{B} S{S} d{name}", a, b,
                                 BF16_TOL))
    qkv = torch.cat([t.reshape(B, S, h * d) for t in (q, k, v)], -1)
    fused = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    if not torch.equal(fused, torch.cat([t.reshape(B, S, h * d)
                                         for t in sep], -1)):
        raise AssertionError("flash sep: separate != fused mode on packed "
                             "inputs")
    del qkv, fused, sep, ref
    torch.cuda.empty_cache()
    ms, _, plain_ms, lib_ms, bound, dev_s = _split_timing(
        fa, (q, k, v, o, lse, do), True, B, S, h, d)
    print(f"flash sep bwd B{B} S{S} h{h} d{d}: K3 {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    rec_s = {"name": "flash_bwd_sep", "route": "cuda", "source": src,
             "replaces": ref_py + ":195,236", "max_abs_err": err_s,
             "ms": ms, "device_ms": dev_s, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
             "shape": f"B{B} S{S} h{h} d{d} causal separate"}
    return rec_f, rec_s


def _hm(*ts):
    """[B, S, h, d] -> contiguous head-major [B, h, S, d]."""
    return [t.transpose(1, 2).contiguous() for t in ts]


def _k17_equal_to_sep(fa, tag, q, k, v, do, causal, scale) -> tuple:
    """K17 on head-major copies of separate q, k, v against K1-sep and
    K3-sep on the originals: the same bodies with head strides, so
    bit-equal (torch.equal). Returns K17's (o, lse, dq, dk, dv)."""
    q_, k_, v_, do_ = _hm(q, k, v, do)
    o, lse = fa.flash_fwd_hm(q_, k_, v_, causal, scale)
    grads = fa.flash_bwd_hm(q_, k_, v_, o, lse, do_, causal, scale)
    o_sep, lse_sep = fa.flash_fwd_sep(q, k, v, causal, scale)
    sep = fa.flash_bwd_sep(q, k, v, o_sep, lse_sep, do, causal, scale)
    torch.cuda.synchronize()
    if not (torch.equal(o.transpose(1, 2), o_sep)
            and torch.equal(lse, lse_sep)):
        raise AssertionError(f"{tag}: K17 forward != K1-sep")
    for name, a, b in zip("qkv", grads, sep):
        if not torch.equal(a.transpose(1, 2), b):
            raise AssertionError(f"{tag}: K17 d{name} != K3-sep")
    return (o, lse, *grads)


def check_flash_head_major(dev) -> tuple[dict, dict]:
    """K17, the head-major flash forward and split backward ([B, h, S, d],
    FLAGS_flash_attention_native_layout=0 and odd head counts at d 64):
    bit-equal to K1-sep and K3-sep on the same values and within the
    tolerance of its plain version, in small fp32 cases (head dims 64
    with 5 heads, 128, 256; causal and not), at gpt3-350m's attention (B
    16, S 1024, h 16, d 64, bf16; timed) and at h 5, d 64."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(17)

    def case(B, S, h, d, dt):
        return [torch.randn((B, S, h, d), generator=gen, device=dev).to(dt)
                for _ in range(4)]

    for h, d in ((5, 64), (2, 128), (1, 256)):
        for causal in (True, False):
            q, k, v, do = case(2, 256, h, d, torch.float32)
            tag = f"K17 fp32 h{h} d{d} causal={causal}"
            o, lse, *grads = _k17_equal_to_sep(fa, tag, q, k, v, do, causal,
                                               d ** -0.5)
            q_, k_, v_, do_ = _hm(q, k, v, do)
            ro, rlse = fa.flash_fwd_hm_plain(q_, k_, v_, causal, d ** -0.5)
            _hold(tag + " o", o, ro, FP32_TOL)
            _hold(tag + " lse", lse, rlse, FP32_TOL)
            ref = fa.flash_bwd_hm_plain(q_, k_, v_, o, lse, do_, causal,
                                        d ** -0.5)
            for name, a, b in zip("qkv", grads, ref):
                _hold(f"{tag} d{name}", a, b, FP32_TOL)
    bf = torch.bfloat16
    err_f = err_b = 0.0
    for B, S, h, d in ((16, 1024, 5, 64), (16, 1024, 16, 64)):
        scale = d ** -0.5
        q, k, v, do = case(B, S, h, d, bf)
        tag = f"K17 bf16 B{B} S{S} h{h} d{d}"
        o, lse, *grads = _k17_equal_to_sep(fa, tag, q, k, v, do, True, scale)
        q_, k_, v_, do_ = _hm(q, k, v, do)
        ro, _ = fa.flash_fwd_hm_plain(q_, k_, v_, True, scale)
        err_f = max(err_f, _hold(tag + " o", o, ro, BF16_TOL))
        del ro
        ref = fa.flash_bwd_hm_plain(q_, k_, v_, o, lse, do_, True, scale)
        for name, a, b in zip("qkv", grads, ref):
            err_b = max(err_b, _hold(f"{tag} d{name}", a, b, BF16_TOL))
        del ref, grads
        torch.cuda.empty_cache()
    # timed at gpt3-350m's attention, the flagged step's shape
    fwd_ms = _time_ms(lambda: fa.flash_fwd_hm(q_, k_, v_, True, scale))
    bwd_ms = _time_ms(lambda: fa.flash_bwd_hm(q_, k_, v_, o, lse, do_, True,
                                              scale))
    fwd_plain = _time_ms(lambda: fa.flash_fwd_hm_plain(q_, k_, v_, True,
                                                       scale),
                         iters=3, warmup=1)
    bwd_plain = _time_ms(lambda: fa.flash_bwd_hm_plain(
        q_, k_, v_, o, lse, do_, True, scale), iters=3, warmup=1)
    # library yardstick: SDPA on the same head-major q, k, v
    qh, kh, vh = (t.clone().requires_grad_(True) for t in (q_, k_, v_))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = _time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    out = sdpa(qh, kh, vh, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do_,
                                                   retain_graph=True))
    del out, qh, kh, vh
    torch.cuda.empty_cache()
    pairs = B * h * S * (S + 1) / 2          # causal (query, key) pairs
    in_b, st_b = q.numel() * 2, B * h * S * 4
    f_bound = _bound(3 * in_b + in_b + st_b, 4.0 * d * pairs)
    # q, k, v, do and lse, delta read, dq, dk, dv written (K2's count)
    b_bound = _bound(7 * in_b + 2 * st_b, 10.0 * d * pairs)
    print(f"K17 fwd B{B} S{S} h{h} d{d}: kernel {fwd_ms:.4f} ms, plain "
          f"{fwd_plain:.4f} ms, sdpa {lib_fwd:.4f} ms, bound "
          f"{f_bound[0]:.4f} ms ({f_bound[1]})")
    print(f"K17 bwd B{B} S{S} h{h} d{d}: kernel {bwd_ms:.4f} ms (dq + "
          f"dk/dv), plain {bwd_plain:.4f} ms, sdpa bwd {lib_bwd:.4f} ms, "
          f"bound {b_bound[0]:.4f} ms ({b_bound[1]})")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = f"B{B} S{S} h{h} d{d} causal, head-major, bf16"
    return ({"name": "flash_fwd_hm", "route": "cuda", "source": src,
             "replaces": ref_py + ":490", "max_abs_err": err_f,
             "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": f_bound[0],
             "bound_by": f_bound[1], "library_ms": lib_fwd, "shape": shape},
            {"name": "flash_bwd_hm", "route": "cuda", "source": src,
             "replaces": ref_py + ":545,585", "max_abs_err": err_b,
             "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": b_bound[0],
             "bound_by": b_bound[1], "library_ms": lib_bwd, "shape": shape})


def check_ce(dev) -> tuple[dict, dict]:
    """K4 and K5 at the gpt3-350m loss shape (bf16, N 16384, H 1024,
    V 50304) and at a small case with ragged token and vocab tiles, fp32
    and bf16."""
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    gen = torch.Generator(device=dev).manual_seed(6)

    def case(N, H, V, dt):
        x = torch.randn((N, H), generator=gen, device=dev).to(dt)
        wte = (torch.randn((V, H), generator=gen, device=dev)
               * (CE_LOGIT_STD / math.sqrt(H))).to(dt)
        lab = torch.randint(0, V, (N,), generator=gen, device=dev)
        g = torch.full((N,), 1.0 / N, device=dev)
        return x, wte, lab, g

    def hold_bwd(tag, dx, dh, rdx, rdh, lab, tol):
        """dx by token row, dhead by vocab column; the columns that are
        no token's label hold only the softmax part of dl."""
        err = max(_hold(tag + " dx", dx, rdx, tol),
                  _hold(tag + " dhead", dh, rdh, tol, dim=0))
        free = torch.ones(dh.shape[1], dtype=torch.bool, device=dev)
        free[lab] = False
        _hold(f"{tag} dhead, {int(free.sum())} columns without a label",
              dh[:, free], rdh[:, free], tol, dim=0)
        return err

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = collections.Counter(ce.PRODUCTS)
    # ragged token and vocab tiles, two vocab slabs, the last ragged
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        if ce.ce_plan_c(300, 128, ce.SLAB + 1000, dt) != ce.ce_plan(
                300, 128, ce.SLAB + 1000, dt, sms=sms):
            raise AssertionError(f"ce_plan_c != ce_plan, small {dt}")
        x, wte, lab, g = case(300, 128, ce.SLAB + 1000, dt)
        nll, lse = ce.fused_ce_fwd(x, wte.t(), lab)
        rnll, rlse = ce.fused_ce_fwd_plain(x, wte.t(), lab)
        _hold(f"ce {dt} small nll", nll, rnll, FP32_TOL)
        _hold(f"ce {dt} small lse", lse, rlse, FP32_TOL)
        dx, dh = ce.fused_ce_bwd(x, wte.t(), lab, lse, g)
        rdx, rdh = ce.fused_ce_bwd_plain(x, wte.t(), lab, lse, g)
        hold_bwd(f"ce {dt} small", dx, dh, rdx, rdh, lab, tol)

    N, H, V = 16384, 1024, 50304
    if ce.ce_plan_c(N, H, V) != ce.ce_plan(N, H, V, sms=sms):
        raise AssertionError("ce_plan_c != ce_plan at the gpt3-350m shape")
    x, wte, lab, g = case(N, H, V, torch.bfloat16)
    head = wte.t()
    nll, lse = ce.fused_ce_fwd(x, head, lab)
    rnll, rlse = ce.fused_ce_fwd_plain(x, head, lab)
    err_f = (nll - rnll).abs().max().item()
    err_l = (lse - rlse).abs().max().item()
    top_p = torch.exp(torch.matmul(x[:1024].float(), wte.float().t())
                      .amax(-1) - rlse[:1024]).mean().item()
    print(f"ce bf16 nll / lse: max_abs_err {err_f:.3e} / {err_l:.3e} "
          f"(atol {CE_FWD_ATOL}); mean top probability {top_p:.3f} over "
          "1024 tokens")
    if not max(err_f, err_l) <= CE_FWD_ATOL:
        raise AssertionError(f"ce fwd: max_abs_err {err_f} / {err_l}")
    del rnll, rlse
    dx, dh = ce.fused_ce_bwd(x, head, lab, lse, g)
    dx2, dh2 = ce.fused_ce_bwd(x, head, lab, lse, g)
    if not (torch.equal(dx, dx2) and torch.equal(dh, dh2)):
        raise AssertionError("ce backward is not deterministic")
    del dx2, dh2
    rdx, rdh = ce.fused_ce_bwd_plain(x, head, lab, lse, g)
    err_b = hold_bwd("ce bf16", dx, dh, rdx, rdh, lab, BF16_TOL)
    del rdx, rdh, dx, dh
    torch.cuda.empty_cache()
    # every bf16 product above went through the wgmma route, as the C
    # entries reported what they launched
    seen = ce.PRODUCTS - before
    variants = sorted({v for v, dt, _ in seen if dt == "bfloat16"})
    if variants != ["wgmma"]:
        raise AssertionError(f"ce bf16 products took {variants}: {seen}")
    fwd_ms = _time_ms(lambda: ce.fused_ce_fwd(x, head, lab), iters=5)
    bwd_ms = _time_ms(lambda: ce.fused_ce_bwd(x, head, lab, lse, g),
                      iters=3)
    fwd_dev = _graph_ms(lambda: ce.fused_ce_fwd(x, head, lab), iters=5)
    bwd_dev = _graph_ms(lambda: ce.fused_ce_bwd(x, head, lab, lse, g),
                        iters=3)
    # the products the kernels compute, as bf16 cuBLAS calls: x @ w^T for
    # K4; per vocab slab x @ w_slab^T, dl @ w_slab and dl^T @ x for K5
    slabs = [wte[v0:v0 + ce.SLAB] for v0 in range(0, V, ce.SLAB)]
    dls = [(1e-4 * torch.randn((N, ws.shape[0]), generator=gen,
                               device=dev)).to(torch.bfloat16)
           for ws in slabs]

    def bwd_products():
        for ws, dl in zip(slabs, dls):
            x @ ws.t()
            dl @ ws
            dl.t() @ x

    fwd_products = _time_ms(lambda: x @ wte.t(), iters=5)
    bwd_products_ms = _time_ms(bwd_products, iters=3)
    del slabs, dls
    torch.cuda.empty_cache()
    fwd_plain = _time_ms(lambda: ce.fused_ce_fwd_plain(x, head, lab),
                         iters=3, warmup=1)
    bwd_plain = _time_ms(lambda: ce.fused_ce_bwd_plain(x, head, lab, lse,
                                                       g), iters=2, warmup=1)
    # library yardstick: F.cross_entropy on the fp32 logits x @ wte.T
    xf = x.float().requires_grad_(True)
    wf = wte.float().requires_grad_(True)
    xent = torch.nn.functional.cross_entropy

    def lib_fwd():
        return xent(xf @ wf.t(), lab, reduction="sum")

    lib_fwd_ms = _time_ms(lib_fwd, iters=3, warmup=1)
    loss = lib_fwd() / N
    lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        loss, (xf, wf), retain_graph=True), iters=3, warmup=1)
    del loss, xf, wf
    torch.cuda.empty_cache()
    io = (N * H + V * H) * 2 + N * 4
    f_bound = _bound(io + 2 * N * 4, 2.0 * N * H * V)
    b_bound = _bound(io + 2 * N * 4 + (N * H + V * H) * 2, 6.0 * N * H * V)
    print(f"ce fwd: kernel {fwd_ms:.4f} ms (device {fwd_dev:.4f}), plain "
          f"{fwd_plain:.4f} ms, bf16 products {fwd_products:.4f} ms, "
          f"cross_entropy {lib_fwd_ms:.4f} ms, bound {f_bound[0]:.4f} ms "
          f"({f_bound[1]})")
    print(f"ce bwd: kernel {bwd_ms:.4f} ms (device {bwd_dev:.4f}), plain "
          f"{bwd_plain:.4f} ms, bf16 products {bwd_products_ms:.4f} ms, "
          f"cross_entropy bwd {lib_bwd_ms:.4f} ms, bound {b_bound[0]:.4f} "
          f"ms ({b_bound[1]})")
    src = "paddle_tpu_torch/csrc/fused_ce.cu"
    ref_py = "paddle_tpu/ops/pallas/fused_ce.py"
    shape = f"N{N} H{H} V{V}"
    return ({"name": "fused_ce_fwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":81", "max_abs_err": max(err_f, err_l),
             "ms": fwd_ms, "device_ms": fwd_dev, "plain_ms": fwd_plain,
             "bound_ms": f_bound[0], "bound_by": f_bound[1],
             "library_ms": lib_fwd_ms, "products_ms": fwd_products,
             "variant": variants[0], "shape": shape},
            {"name": "fused_ce_bwd", "route": "cuda", "source": src,
             "replaces": ref_py + ":125", "max_abs_err": err_b,
             "ms": bwd_ms, "device_ms": bwd_dev, "plain_ms": bwd_plain,
             "bound_ms": b_bound[0], "bound_by": b_bound[1],
             "library_ms": lib_bwd_ms, "products_ms": bwd_products_ms,
             "variant": variants[0], "shape": shape})


def _vec(gen, dev, h: int, mean: float, std: float, dtype=torch.float32):
    return (mean + std * torch.randn((h,), generator=gen, device=dev)).to(
        dtype)


def _norm_case(gen, dev, worst, tag, n, h, dt, norm, sub, bias, beta,
               act=None, gain_dtype=torch.float32):
    """One K6 case against its plain version: r bit-equal, y held by
    _scaled_err by row; the worst y error goes into ``worst[dt]``."""
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

    x = torch.randn((n, h), generator=gen, device=dev).to(dt)
    s = (torch.randn((n, h), generator=gen, device=dev).to(dt)
         if sub else None)
    b = _vec(gen, dev, h, 0.0, 0.5) if bias else None
    g = _vec(gen, dev, h, 1.0, 0.2, gain_dtype)
    be = _vec(gen, dev, h, 0.0, 0.2) if beta else None
    r, y = fne.norm_epilogue_fwd(x, s, b, g, be, norm, 1e-5, act)
    rr, ry = fne.norm_epilogue_plain(x, s, b, g, be, norm, 1e-5, act)
    torch.cuda.synchronize()
    if not torch.equal(r, rr):
        raise AssertionError(f"K6 {tag}: r is not bit-equal to the plain "
                             "composition")
    tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
    worst[dt] = max(worst[dt], _hold(f"K6 {tag} y (r bit-equal)", y, ry,
                                     tol))
    return x, s, b, g, be


def check_norm_epilogue(dev) -> dict:
    """K6 against its plain version: at the gpt3-350m norm shape
    ([16384, 1024] bf16) in the residual + bias layer form (ln2 and the
    next layer's ln1), the norm-only form (layer 0's ln1), with the tanh
    gelu, the rms form at H 4096 (llama3-8b's), and small fp32 cases. r
    must be bit-equal; y is held by _scaled_err by row."""
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}

    def case(*args, **kw):
        return _norm_case(gen, dev, worst, *args, **kw)

    N, H = 16384, 1024
    bf = torch.bfloat16
    x, s, b, g, be = case("layer residual+bias bf16 [16384, 1024]", N, H, bf,
                          "layer", True, True, True)
    case("layer norm-only bf16 [16384, 1024]", N, H, bf, "layer", False,
         False, True)
    case("layer residual+bias gelu bf16 [16384, 1024]", N, H, bf, "layer",
         True, True, True, "gelu")
    case("rms residual bf16 [4096, 4096]", 4096, 4096, bf, "rms", True,
         False, False)
    case("layer residual+bias fp32 [512, 256]", 512, 256, torch.float32,
         "layer", True, True, True)
    case("rms residual+bias gelu fp32 [512, 4096]", 512, 4096,
         torch.float32, "rms", True, True, False, "gelu")
    ms = _time_ms(lambda: fne.norm_epilogue_fwd(x, s, b, g, be, "layer",
                                                1e-5))
    plain_ms = _time_ms(lambda: fne.norm_epilogue_plain(x, s, b, g, be,
                                                        "layer", 1e-5))
    # nearest library call: F.layer_norm on a precomputed r (the adds
    # left out), weight and bias in r's dtype
    r = (x + s) + b.to(bf)
    gb, beb = g.to(bf), be.to(bf)
    library_ms = _time_ms(lambda: torch.nn.functional.layer_norm(
        r, (H,), gb, beb, 1e-5))
    bound_ms, bound_by = _bound(4 * N * H * 2 + 3 * H * 4, 10.0 * N * H,
                                FP32_FLOP_PER_S)
    print(f"K6 layer residual+bias bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, layer_norm on r {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "fused_norm_epilogue", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_norm_epilogue.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_norm_epilogue.py:106",
            "max_abs_err": worst[bf], "max_abs_err_fp32":
            worst[torch.float32], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"N{N} H{H} layer, residual + bias, bf16"}


def check_bias_gelu(dev) -> dict:
    """K7 against its plain version at the gpt3-350m FFN shape
    ([16384, 4096] bf16, fp32 bias) and a small fp32 case."""
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    gen = torch.Generator(device=dev).manual_seed(10)
    errs = {}
    for (n, f), dt, tol in (((16384, 4096), torch.bfloat16, BF16_TOL),
                            ((512, 256), torch.float32, FP32_TOL)):
        x = (2.0 * torch.randn((n, f), generator=gen, device=dev)).to(dt)
        b = _vec(gen, dev, f, 0.0, 0.5)
        y = fba.bias_gelu_fwd(x, b)
        ref = fba.bias_gelu_plain(x, b)
        torch.cuda.synchronize()
        errs[dt] = _hold(f"K7 {dt} [{n}, {f}]", y, ref, tol)
    x = (2.0 * torch.randn((16384, 4096), generator=gen,
                           device=dev)).to(torch.bfloat16)
    b = _vec(gen, dev, 4096, 0.0, 0.5)
    # the 2-D walk: the C launcher's is bias_gelu_plan's, and the first
    # 256 rows alone give the bits of those rows of the whole call
    N, Fd = x.shape
    walk = fba.bias_gelu_plan_c(N, Fd, x.dtype, b.dtype)
    if walk != fba.bias_gelu_plan(N, Fd, x.element_size(),
                                  walk["resident"]):
        raise AssertionError(f"bias_gelu_plan_c {walk} != bias_gelu_plan")
    if not torch.equal(fba.bias_gelu_fwd(x[:256], b),
                       fba.bias_gelu_fwd(x, b)[:256]):
        raise AssertionError("K7: rows 0-255 alone differ from the call's")
    ms = _time_ms(lambda: fba.bias_gelu_fwd(x, b))
    device_ms = _graph_ms(lambda: fba.bias_gelu_fwd(x, b))
    plain_ms = _time_ms(lambda: fba.bias_gelu_plain(x, b))
    # nearest library call: the tanh gelu on a pre-biased input (the add
    # left out)
    xb = x + b.to(torch.bfloat16)
    library_ms = _time_ms(lambda: torch.nn.functional.gelu(
        xb, approximate="tanh"))
    library_device_ms = _graph_ms(lambda: torch.nn.functional.gelu(
        xb, approximate="tanh"))
    bound_ms, bound_by = _bound(2 * N * Fd * 2 + Fd * 4, 12.0 * N * Fd,
                                FP32_FLOP_PER_S)
    variant = (f"2-D walk: {walk['cols']} vectors x {walk['rows']} rows a "
               f"block, grid {walk['grid'][0]} x {walk['grid'][1]}, "
               f"{walk['unroll']} loads in flight")
    print(f"K7 bias gelu bf16: kernel {ms:.4f} ms (device {device_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, gelu on x + b {library_ms:.4f} ms "
          f"(device {library_device_ms:.4f}), bound {bound_ms:.4f} ms "
          f"({bound_by}); {variant}")
    # K7 computes no product: products_ms is null
    return {"name": "fused_bias_act", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_bias_act.py:91",
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32":
            errs[torch.float32], "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "products_ms": None, "variant": variant,
            "shape": f"N{N} F{Fd} bf16"}


def _train_counters():
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    return {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
            "fused_ce_fwd": ce.fused_ce_fwd, "fused_ce_bwd": ce.fused_ce_bwd,
            "fused_norm_epilogue": fne.norm_epilogue_fwd,
            "fused_bias_act": fba.bias_gelu_fwd}


def _check_ce_products(tag: str, before: collections.Counter, steps: int,
                       N: int, H: int, V: int) -> None:
    """The cross-entropy products since ``before`` are exactly ``steps``
    forwards and backwards at x [N, H] bf16 over V, every one through the
    wgmma route as the C entries reported it (K4's "stats" once a step,
    K5's "dl", "dx", "dw" once a slab), and the C launchers' plan
    (``ce_plan_c``) is ``ce_plan``'s at that shape."""
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    diff = dict(ce.PRODUCTS - before)
    slabs = -(-V // ce.SLAB)
    want = {("wgmma", "bfloat16", p): steps * (1 if p == "stats" else slabs)
            for p in ("stats", "dl", "dx", "dw")}
    if diff != want:
        raise AssertionError(f"{tag}: CE products {diff} != {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if ce.ce_plan_c(N, H, V) != ce.ce_plan(N, H, V, sms=sms):
        raise AssertionError(f"{tag}: ce_plan_c != ce_plan at N{N} H{H} "
                             f"V{V}")
    print(f"{tag}: CE products by (variant, dtype, product): {diff}")


TRAIN_CATEGORIES = (
    ("K4/K5 cross-entropy", ("ce_wg_kernel", "ce_fma_kernel",
                             "ce_stats_reduce")),
    ("K1/K2 flash attention", ("fwd_wg_kernel", "bwd_wg_kernel",
                               "fwd_fma_kernel", "bwd_fma_kernel")),
    ("K6/K7 norm epilogue, bias gelu", ("norm_epilogue_kernel",
                                        "bias_gelu_kernel")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
)


def _device_us_by_kind(prof) -> tuple[dict, int]:
    """({kind: device µs} over TRAIN_CATEGORIES and the rest, kernel
    launches) of a torch.profiler run."""
    cuda = torch.autograd.DeviceType.CUDA
    sums = {name: 0.0 for name, _ in TRAIN_CATEGORIES}
    rest, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != cuda or e.self_device_time_total <= 0:
            continue
        launches += e.count
        for name, keys in TRAIN_CATEGORIES:
            if any(k in e.key for k in keys):
                sums[name] += e.self_device_time_total
                break
        else:
            rest += e.self_device_time_total
    sums["elementwise, copies, reductions (incl. AdamW)"] = rest
    return sums, launches


def _profile_train(step, params, opt, toks, labs, tag: str,
                   n: int = 2) -> None:
    """Device time of n flagship steps by kind of kernel, the device's
    busy share of their wall time (profiler cost included), and the
    AdamW update timed alone (zero gradients, the same arithmetic)."""
    from paddle_tpu_torch.parallel.train_step import adamw_update

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            loss, params, opt = step(params, opt, toks, labs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_profile(prof, {"wall_s": wall})
    sums, _ = _device_us_by_kind(prof)
    for name, us in sums.items():
        print(f"train profile ({tag}): {name}: {us / 1e3 / n:.2f} ms/step")
    gtree = _map_leaves(params, torch.zeros_like)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw_update(params, gtree, opt, 1e-4, m_dtype="bfloat16",
                     v_dtype="bfloat16")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"train profile ({tag}): AdamW update alone "
          f"{min(times[1:]) * 1e3:.2f} "
          "ms (host clock, synchronized)")


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


# make_train_step's first losses and host seconds a step, as phases
# train and train_13b record them at the configurations phase dist runs
# through the sharded entry: {key: (losses, seconds)}
ONE_DEVICE_RUNS: dict = {}


def _template_counts(report) -> dict:
    counts: dict = {}
    for row in report.sites:
        key = (row["template"], row["applied"])
        counts[key] = counts.get(key, 0) + 1
    return counts


def run_train(dev, profile: bool = False, fused: bool = True,
              native: bool = True):
    """gpt3-350m at full width, the reference bench's flagship step:
    B 16, S 1024, bf16 moments, fp32 masters; best of 3 windows of 4
    steps after 3 warm-up steps. ``fused`` sets ``use_auto_fusion`` (the
    default, True, is the main path); ``native`` False sets
    ``flash_attention_native_layout`` off: the attention takes the
    head-major K17 (forward L, dq and dk/dv 2L launches a step) in place
    of K1/K2. Returns (launches of the timed windows, {step_ms, tok_s,
    mfu, peak_gib, loss0})."""
    import dataclasses

    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.gpt import gpt_flops_per_token, gpt_presets
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce
    from paddle_tpu_torch.parallel.train_step import make_train_step

    cfg = dataclasses.replace(gpt_presets("gpt3-350m"), unroll=True,
                              remat=False)
    batch, warmup, windows, win = 16, 3, 3, 4
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", fused)
    GLOBAL_FLAGS.set("flash_attention_native_layout", native)
    try:
        torch.cuda.reset_peak_memory_stats()
        step, params, opt = make_train_step(cfg, lr=1e-4, seed=0,
                                            m_dtype="bfloat16",
                                            v_dtype="bfloat16", device=dev)
        rng = np.random.RandomState(0)
        toks = step.put_batch(rng.randint(0, cfg.vocab_size,
                                          size=(batch, cfg.seq_len)))
        labs = step.put_batch(rng.randint(0, cfg.vocab_size,
                                          size=(batch, cfg.seq_len)))
        losses, warm_s = [], []
        for _ in range(warmup):
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
            warm_s.append(time.perf_counter() - t0)
        t_first = warm_s[0]             # the first step traces the model
        if fused and native and not profile:
            ONE_DEVICE_RUNS["gpt3-350m"] = (list(losses), warm_s)
        if profile:
            _profile_train(step, params, opt, toks, labs,
                           "fusion on" if fused else "fusion off")
            return {}, {}
        # the head-major kernels (K17) count too: 0 in the native layout
        counters = {**_train_counters(), "flash_fwd_hm": fa.flash_fwd_hm,
                    "flash_bwd_hm": fa.flash_bwd_hm}
        for fn in counters.values():
            fn.launches = 0
        ce_before = collections.Counter(ce.PRODUCTS)
        best = float("inf")
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(win):
                loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())     # syncs
            best = min(best, time.perf_counter() - t0)
        report = compiler.last_report() if fused else None
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
        GLOBAL_FLAGS.set("flash_attention_native_layout", True)
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = windows * win
    L = cfg.n_layers
    slabs = -(-cfg.vocab_size // ce.SLAB)
    flash = L * steps if native else 0
    want = {"flash_fwd": flash, "flash_bwd": flash,
            "flash_fwd_hm": L * steps - flash,
            "flash_bwd_hm": 2 * (L * steps - flash),
            "fused_ce_fwd": 2 * steps, "fused_ce_bwd": 3 * slabs * steps,
            "fused_norm_epilogue": (2 * L + 1) * steps if fused else 0,
            "fused_bias_act": L * steps if fused else 0}
    if launches != want:
        raise AssertionError(f"train launches {launches} != {want}")
    _check_ce_products("train", ce_before, steps, batch * cfg.seq_len,
                       cfg.hidden, cfg.vocab_size)
    if fused:
        counts = _template_counts(report)
        want_sites = {("layer_epilogue", True): 2 * L + 1,
                      ("bias_gelu", True): L}
        if counts != want_sites or report.errors:
            raise AssertionError(f"fusion report {counts} (errors "
                                 f"{report.errors}) != {want_sites}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step-1 loss {losses[0]} not near "
                             f"ln(V) = {math.log(cfg.vocab_size):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    step_s = best / win
    tok_s = batch * cfg.seq_len / step_s
    mfu = gpt_flops_per_token(cfg) * tok_s / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = ("fusion on" if fused else "fusion off") + \
        ("" if native else ", head-major layout")
    print(f"train gpt3-350m B{batch} S{cfg.seq_len} ({tag}): step "
          f"{step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, MFU {mfu:.4f} "
          f"(bf16 peak {BF16_FLOP_PER_S:.0e}), first step (trace "
          f"included) {t_first * 1e3:.0f} ms, losses "
          f"{[round(v, 4) for v in losses]}, launches {launches}, peak mem "
          f"{peak:.2f} GiB")
    if fused:
        print(f"train fusion report: program {report.program_hash}, "
              f"{report.n_applied}/{report.n_sites} sites applied: "
              + ", ".join(f"{c} {t}" for (t, _), c in counts.items()))
    return launches, {"step_ms": step_s * 1e3, "tok_s": tok_s, "mfu": mfu,
                      "peak_gib": peak, "loss0": losses[0]}


def _train_cpu_case(dev, tag: str, **cfg_kw) -> dict:
    """3 fp32 AdamW steps of a small GPT (H 256, 4 heads of 64, 2 layers,
    S 256, B 2) on the card and on the CPU from identical weights, fusion
    on for both; returns the card's launches."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.parallel.train_step import (adamw_init,
                                                      make_train_step)

    cfg = GPTConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=4,
                    seq_len=256, dtype=torch.float32,
                    param_dtype=torch.float32, **cfg_kw)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    labs = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    runs = {}
    counters = _split_counters()
    for fn in counters.values():
        fn.launches = 0
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        step, _, _ = make_train_step(cfg, lr=1e-4, device=device)
        params = {k: ({kk: vv.clone().to(device) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone().to(device))
                  for k, v in cpu_params.items()}
        opt = adamw_init(params)
        losses = []
        for _ in range(3):
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
        runs[name] = (losses, params)
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    launches = {k: fn.launches for k, fn in counters.items()}
    if not np.allclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"{tag}: losses differ: cuda {lg} vs cpu {lc}")
    worst = 0.0
    for k, v in pc.items():
        for kk, a in (v.items() if isinstance(v, dict) else [(k, v)]):
            b = pg[k][kk] if isinstance(v, dict) else pg[k]
            worst = max(worst, (a.detach() - b.detach().cpu()).abs().max()
                        .item())
    if not worst <= TRAIN_CPU_ATOL:
        raise AssertionError(f"{tag}: params differ by {worst} > "
                             f"{TRAIN_CPU_ATOL}")
    print(f"train cpu/cuda ({tag}, fusion on): losses {lg} vs {lc}, params "
          f"max diff {worst:.3e}, card launches {launches}")
    return launches


def _llama_cpu_case(dev) -> None:
    """llama_loss and its gradients of a small fp32 LLaMA (hidden 256, 2
    heads of 128, 1 kv head, 2 layers, S 256, B 2, remat on, fusion on)
    on the card (K11, K3, K6, K12) and on the CPU from identical weights:
    loss within rtol 1e-4, every gradient leaf by row within 1e-4."""
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               init_llama_params, llama_loss)

    cfg = LlamaConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_hidden=384, max_seq_len=256,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(9),
                                   "cpu")
    rng = np.random.RandomState(10)
    toks, labs = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               size=(2, 256)))
                  for _ in range(2))
    counters = _llama_counters()
    for fn in counters.values():
        fn.launches = 0
    res = {}
    for device in ("cpu", dev):
        params = {k: ({kk: vv.clone().to(device) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone().to(device))
                  for k, v in cpu_params.items()}
        flat = _leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = llama_loss(params, toks.to(device), labs.to(device), cfg)
        res[str(device)] = (loss.item(), torch.autograd.grad(loss, flat))
    launches = {k: fn.launches for k, fn in counters.items()}
    (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
    if not (launches["rope_flash_fwd"] and launches["flash_bwd_sep"]):
        raise AssertionError(f"llama cpu/cuda: K11 / K3 did not run: "
                             f"{launches}")
    if not np.isclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"llama cpu/cuda: loss {lg} vs {lc}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        worst = max(worst, _hold(f"llama cpu/cuda grad leaf {i}", a.cpu(),
                                 b, FP32_TOL))
    print(f"llama train cpu/cuda: loss {lg} vs {lc}, grads max abs diff "
          f"{worst:.3e}, card launches {launches}")


def check_train_cpu(dev) -> None:
    """The small fp32 GPT on the card and on the CPU from identical
    weights, fusion on: without remat (the fp32 K1/K2, K4/K5, K6 and K7
    kernels), under remat=True and "full", and with
    flash_attention_fused_dqkv off (K3 on the card); then a small fp32
    LLaMA's llama_loss gradients, card against CPU. Each case must launch
    every training kernel of its route: K1 once a layer a step under
    every remat setting, and K2 once a layer a step, or K3's two entries
    with the flag off, never both."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS

    flash = 2 * 3                        # the case's layers x steps
    for tag, kw, merged in (("remat False", dict(remat=False), True),
                            ("remat True", dict(remat=True), True),
                            ("remat full", dict(remat="full"), True),
                            ("fused_dqkv off", dict(remat=False), False)):
        GLOBAL_FLAGS.set("flash_attention_fused_dqkv", merged)
        try:
            ln = _train_cpu_case(dev, tag, **kw)
        finally:
            GLOBAL_FLAGS.set("flash_attention_fused_dqkv", True)
        want = {"flash_fwd": flash, "flash_bwd": flash if merged else 0,
                "flash_bwd_split": 0 if merged else 2 * flash}
        if any(ln[k] != n for k, n in want.items()) or \
                not all(ln[k] for k in ln if k not in want):
            raise AssertionError(f"{tag}: launches {ln}, want {want} and "
                                 "every other kernel at least once")
    _llama_cpu_case(dev)


# ---------------------------------------------------------------------------
# gpt3-1.3b training (sr-bf16, remat policies) and LLaMA's backward: K3
# ---------------------------------------------------------------------------

# bench.py's gpt3-1.3b configurations: (batch, seq, remat, steps a window)
GPT13B_RUNS = ((4, 1024, True, 4), (1, 4096, True, 3), (1, 8192, "full", 2))
GPT13B_KEYS = {1024: "gpt3_1p3b_train", 4096: "gpt3_1p3b_s4096",
               8192: "gpt3_1p3b_s8192"}


def _split_counters():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {**_train_counters(), "flash_bwd_split": fa.flash_bwd_split}


def _check_sr_state(params, opt) -> None:
    """sr-bf16: no master; >= 2-D leaves bf16, 1-D fp32; moments bf16
    (>= 2-D) and fp32 (1-D)."""
    if "master" in opt:
        raise AssertionError("sr-bf16 state holds a master copy")
    for tree, lo in ((params, torch.bfloat16), (opt["m"], torch.bfloat16),
                     (opt["v"], torch.bfloat16)):
        for leaf in _leaves(tree):
            want = lo if leaf.dim() >= 2 else torch.float32
            if leaf.dtype != want:
                raise AssertionError(f"sr-bf16 leaf {tuple(leaf.shape)} is "
                                     f"{leaf.dtype}, not {want}")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _gpt13b(dev, S: int, remat):
    from paddle_tpu_torch.models.gpt import gpt_presets
    from paddle_tpu_torch.parallel.train_step import make_train_step

    cfg = dataclasses.replace(gpt_presets("gpt3-1.3b"), seq_len=S,
                              remat=remat)
    step, params, opt = make_train_step(cfg, lr=1e-4, seed=0,
                                        m_dtype="bfloat16",
                                        v_dtype="bfloat16",
                                        weights="sr-bf16", device=dev)
    return cfg, step, params, opt


def _gpt13b_batch(step, cfg, B: int):
    rng = np.random.RandomState(0)
    return [step.put_batch(rng.randint(0, cfg.vocab_size,
                                       size=(B, cfg.seq_len)))
            for _ in range(2)]


def run_train_13b(dev) -> dict:
    """make_train_step(gpt3-1.3b) at full width (24 layers, hidden 2048,
    vocab 50304), bf16 moments, weights="sr-bf16", fusion on, random
    weights drawn on the card: bench.py's three configurations (B 4
    S 1024 remat=True; B 1 S 4096 remat=True; B 1 S 8192 remat="full"),
    3 warm-up steps and the best of 3 windows; then peak memory at S 4096
    under remat False, True and "full" on the same weights and batch (of
    the forward + backward, and of the whole step), and the AdamW update
    timed alone.
    Returns {"flash_bwd_split": launches in the timed windows}."""
    from paddle_tpu_torch.models.gpt import gpt_flops_per_token
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce
    from paddle_tpu_torch.parallel.train_step import _stochastic_round

    x = torch.full((1 << 22,), 1.0 + 1.5e-3, device=dev)
    sr = _stochastic_round(x, torch.bfloat16,
                           torch.Generator(device=dev).manual_seed(7)).float()
    vals = sorted(torch.unique(sr).tolist())
    if vals != [1.0, 1.0078125] or abs(sr.mean().item() - 1.0015) >= 5e-4:
        raise AssertionError(f"stochastic rounding on the card: values "
                             f"{vals}, mean {sr.mean().item()}")
    print(f"train 13b: stochastic rounding of 1.0015 on the card: values "
          f"{vals}, mean {sr.mean().item():.6f}")
    del x, sr
    keys, peaks, split_launches = {}, {}, 0
    for B, S, remat, win in GPT13B_RUNS:
        torch.cuda.reset_peak_memory_stats()
        cfg, step, params, opt = _gpt13b(dev, S, remat)
        _check_sr_state(params, opt)
        toks, labs = _gpt13b_batch(step, cfg, B)
        losses, warm_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
            warm_s.append(time.perf_counter() - t0)
        if (B, S, remat) == (1, 4096, True):
            ONE_DEVICE_RUNS["gpt3-1.3b S4096"] = (list(losses), warm_s)
        counters = _split_counters()
        for fn in counters.values():
            fn.launches = 0
        ce_before = collections.Counter(ce.PRODUCTS)
        best, windows = float("inf"), 3
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(win):
                loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())     # syncs
            best = min(best, time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in counters.items()}
        steps, L = windows * win, cfg.n_layers
        merged = fa.fused_dqkv_ok(S, cfg.head_dim, 2)
        slabs = -(-cfg.vocab_size // ce.SLAB)
        # K1 once a layer (both policies save o/lse); K6 and K7 run again
        # in the backward's recompute of every block (2L + 1 + 2L, 2L)
        want = {"flash_fwd": L * steps,
                "flash_bwd": L * steps if merged else 0,
                "flash_bwd_split": 0 if merged else 2 * L * steps,
                "fused_ce_fwd": 2 * steps,
                "fused_ce_bwd": 3 * slabs * steps,
                "fused_norm_epilogue": (4 * L + 1) * steps,
                "fused_bias_act": 2 * L * steps}
        if launches != want:
            raise AssertionError(f"train 13b S{S} launches {launches} != "
                                 f"{want}")
        _check_ce_products(f"train 13b S{S}", ce_before, steps, B * S,
                           cfg.hidden, cfg.vocab_size)
        split_launches += launches["flash_bwd_split"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite loss in {losses}")
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            raise AssertionError(f"13b S{S} step-1 loss {losses[0]} not near "
                                 f"ln(V) = {math.log(cfg.vocab_size):.3f}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"13b S{S} loss did not fall: {losses}")
        _check_sr_state(params, opt)
        step_s = best / win
        tok_s = B * S / step_s
        mfu = gpt_flops_per_token(cfg) * tok_s / BF16_FLOP_PER_S
        peak = torch.cuda.max_memory_allocated() / 2**30
        key = GPT13B_KEYS[S]
        if S == 1024:
            keys.update({f"{key}_tokens_per_sec_per_chip": tok_s,
                         f"{key}_mfu": mfu, "gpt3_1p3b_step_ms":
                         step_s * 1e3, "gpt3_1p3b_loss": losses[-1]})
        else:
            keys.update({f"{key}_tokens_per_sec_per_chip": tok_s,
                         f"{key}_mfu": mfu, f"{key}_step_ms": step_s * 1e3})
        peaks[f"B{B} S{S} remat={remat}"] = peak
        print(f"train gpt3-1.3b B{B} S{S} remat={remat} sr-bf16: step "
              f"{step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, MFU {mfu:.4f} "
              f"(against {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s), backward "
              f"{'K2' if merged else 'K3'}, losses "
              f"{[round(v, 4) for v in losses]}, launches {launches}, peak "
              f"mem {peak:.2f} GiB")
        del step, params, opt, toks, labs, loss
        torch.cuda.empty_cache()
    # peak memory at S 4096 under the three remat settings, on the same
    # weights and batch: of the forward + backward (what remat changes),
    # and of the whole step (AdamW's fp32 temporaries included)
    from paddle_tpu_torch.models.gpt import loss_fn
    from paddle_tpu_torch.parallel.train_step import adamw_update

    mem, step_mem = {}, {}
    for remat in (False, True, "full"):
        cfg, step, params, opt = _gpt13b(dev, 4096, remat)
        toks, labs = _gpt13b_batch(step, cfg, 1)
        loss, params, opt = step(params, opt, toks, labs)   # traces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, params, opt = step(params, opt, toks, labs)
        torch.cuda.synchronize()
        step_mem[remat] = torch.cuda.max_memory_allocated() / 2**30
        flat = _leaves(params)
        for p in flat:
            p.requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(loss_fn(params, toks, labs, cfg), flat)
        torch.cuda.synchronize()
        mem[remat] = torch.cuda.max_memory_allocated() / 2**30
        del grads
        if remat == "full":
            gtree = _map_leaves(params, torch.zeros_like)
            gen = torch.Generator(device=dev).manual_seed(0)
            times = []
            with torch.no_grad():
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    adamw_update(params, gtree, opt, 1e-4,
                                 m_dtype="bfloat16", v_dtype="bfloat16",
                                 stochastic_round=True, sr_generator=gen)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            print(f"train gpt3-1.3b: AdamW update alone (sr-bf16, bf16 "
                  f"moments) {min(times) * 1e3:.2f} ms (host clock, "
                  "synchronized)")
            del gtree
        del step, params, opt, toks, labs, loss, flat
        torch.cuda.empty_cache()
    print(f"train gpt3-1.3b B1 S4096 peak memory: forward + backward, "
          f"remat False {mem[False]:.2f} GiB, True {mem[True]:.2f} GiB, "
          f"full {mem['full']:.2f} GiB; whole step {step_mem[False]:.2f} / "
          f"{step_mem[True]:.2f} / {step_mem['full']:.2f} GiB")
    if not mem[False] > mem[True] > mem["full"]:
        raise AssertionError(f"forward + backward peak memory not False > "
                             f"True > full: {mem}")
    keys["peak_gib"] = peaks
    print("train 13b bench.py keys (MFU against 989 TFLOP/s): "
          + json.dumps(keys))
    return {"flash_bwd_split": split_launches}


def _llama_counters():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    return {"rope_flash_fwd": fra.rope_flash_fwd,
            "flash_fwd_sep": fa.flash_fwd_sep,
            "flash_bwd_sep": fa.flash_bwd_sep, "flash_bwd": fa.flash_bwd,
            "flash_bwd_split": fa.flash_bwd_split,
            "fused_norm_epilogue": fne.norm_epilogue_fwd,
            "swiglu": fba.swiglu_fwd}


def _llama_want(L: int, fused: bool) -> tuple[dict, dict]:
    """Launches of one forward and of its backward: remat recomputes
    every block whole (the reference's jax.checkpoint), so the block's
    forward kernels run again in the backward, then K3 twice a layer."""
    fwd = dict.fromkeys(_llama_counters(), 0)
    if fused:
        fwd.update(rope_flash_fwd=L, fused_norm_epilogue=2 * L + 1,
                   swiglu=L)
        bwd = dict(fwd, fused_norm_epilogue=2 * L)
    else:
        fwd.update(flash_fwd_sep=L)
        bwd = dict(fwd)
    bwd["flash_bwd_sep"] = 2 * L
    return fwd, bwd


def run_llama_train(dev) -> dict:
    """Gradients of llama_loss at llama1b (vocab 32000, hidden 2048, 16
    layers, 16 heads, 4 kv heads, ffn 5504, bf16; random weights from
    seed 0 on the card), B 2, S 2048, remat=True, with the fusion
    compiler on (K11 + its backward through K3) and off (K1-sep + K3):
    launches of the forward and the backward counted apart, finite loss
    and gradients, each route's gradients held to fp32 ones taken with
    plain attention (no port kernel) within LLAMA_GRAD_TOL, the fused
    route no further from them than the unfused one; a bf16 control on
    the same plain path is held and printed beside them. Returns
    {"flash_bwd_sep": launches of one fused backward}."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               init_llama_params, llama_loss)

    cfg = LlamaConfig(**LLAMA1B, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    L, B, S = cfg.n_layers, 2, 2048
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    flat = _leaves(params)
    for p in flat:
        p.requires_grad_(True)
    rng = np.random.RandomState(0)
    toks, labs = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               size=(B, S))).to(dev)
                  for _ in range(2))
    counters = _llama_counters()
    grads, out = {}, {}
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    try:
        for fused in (True, False):
            GLOBAL_FLAGS.set("use_auto_fusion", fused)
            torch.autograd.grad(llama_loss(params, toks, labs, cfg), flat)
            torch.cuda.synchronize()         # the first call traces
            fwd_ms, bwd_ms = [], []
            for it in range(3):
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss = llama_loss(params, toks, labs, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fwd_n = {k: fn.launches for k, fn in counters.items()}
                g = torch.autograd.grad(loss, flat)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                bwd_n = {k: fn.launches - fwd_n[k]
                         for k, fn in counters.items()}
                fwd_ms.append((t1 - t0) * 1e3)
                bwd_ms.append((t2 - t1) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = _llama_want(L, fused)
            if (fwd_n, bwd_n) != want:
                raise AssertionError(f"llama train fused={fused}: launches "
                                     f"fwd {fwd_n} bwd {bwd_n} != {want}")
            if not math.isfinite(loss.item()) or not all(
                    torch.isfinite(t).all().item() for t in g):
                raise AssertionError(f"llama train fused={fused}: "
                                     "non-finite loss or gradient")
            if abs(loss.item() - math.log(cfg.vocab_size)) > 0.5:
                raise AssertionError(f"llama loss {loss.item()} not near "
                                     f"ln(V)")
            grads[fused] = g
            out[fused] = bwd_n
            print(f"llama train llama1b B{B} S{S} bf16 remat (fusion "
                  f"{'on' if fused else 'off'}): loss {loss.item():.4f}, "
                  f"forward {min(fwd_ms):.2f} ms, backward "
                  f"{min(bwd_ms):.2f} ms, peak mem {peak:.2f} GiB, "
                  f"launches fwd {fwd_n} bwd {bwd_n}")
            del loss, g
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    # the two routes round differently (K6's sums, K12) and the bf16
    # differences compound through 16 layers' backward: each route is
    # held to fp32 gradients taken on block_apply's plain attention
    # (weights cast up, fusion off: no port kernel runs), within
    # LLAMA_GRAD_TOL by the mean over leaves and by the worst leaf, and
    # the fused one no further from them than FUSED_VS_FP32 x the
    # unfused one, as the decode phase holds its logits
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = _map_leaves(params, lambda t: t.detach().float()
                      .requires_grad_(True))
    loss32, g32 = _plain_attention_grads(p32, toks, labs, cfg32)
    _, grads["control"] = _plain_attention_grads(params, toks, labs, cfg)
    names = [f"{k}.{kk}" if isinstance(v, dict) else k
             for k, v in params.items()
             for kk in (v if isinstance(v, dict) else [None])]
    rel = {k: [] for k in grads}
    for i, ref in enumerate(g32):
        scale = ref.abs().mean().item()
        for k in grads:
            rel[k].append((grads[k][i].float() - ref).abs().mean().item()
                          / scale)
    agg = {k: sum(v) / len(v) for k, v in rel.items()}
    vs = max(_scaled_err(a, b, dim=0 if n == "head" else -1)[1]
             for n, a, b in zip(names, grads[True], grads[False]))
    for k, tag in ((True, "fused"), (False, "unfused"),
                   ("control", "bf16 plain attention")):
        worst = max(range(len(names)), key=lambda i: rel[k][i])
        print(f"llama train grads against fp32 plain attention (loss "
              f"{loss32.item():.4f}), {tag}: mean relative error over "
              f"{len(names)} leaves {agg[k]:.4e}, worst leaf {names[worst]} "
              f"{rel[k][worst]:.4e} (limits {LLAMA_GRAD_TOL[0]}, "
              f"{LLAMA_GRAD_TOL[1]})")
        if not (agg[k] <= LLAMA_GRAD_TOL[0] and
                rel[k][worst] <= LLAMA_GRAD_TOL[1]):
            raise AssertionError(f"llama grads ({tag}) too far from fp32: "
                                 f"mean {agg[k]}, {names[worst]} "
                                 f"{rel[k][worst]}")
    print(f"llama train grads: fused vs unfused max scaled {vs:.4e}")
    if not agg[True] <= FUSED_VS_FP32 * agg[False]:
        raise AssertionError(f"llama grads: the fused route is further "
                             f"from fp32 than the unfused one: {agg}")
    return {"flash_bwd_sep": out[True]["flash_bwd_sep"]}


def _plain_attention_grads(params, toks, labs, cfg):
    """(loss, gradients) of llama_loss with fusion off and block_apply's
    attention on its plain branch (``_sdpa``): asserts that no port
    kernel launched."""
    from unittest import mock

    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models import llama as lm

    counters = _llama_counters()
    for fn in counters.values():
        fn.launches = 0
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", False)
    try:
        with mock.patch.object(lm, "flash_supported", lambda *a: False):
            loss = lm.llama_loss(params, toks, labs, cfg)
            grads = torch.autograd.grad(loss, _leaves(params))
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if ran:
        raise AssertionError(f"plain-attention llama ran kernels: {ran}")
    return loss, grads


# ---------------------------------------------------------------------------
# LLaMA prefill + decode engine (LlamaForCausalLM): K10, K11, K12, K1-sep
# ---------------------------------------------------------------------------

LLAMA1B = dict(vocab_size=32000, hidden=2048, n_layers=16, n_heads=16,
               n_kv_heads=4, ffn_hidden=5504, max_seq_len=2048)
DECODE_PROMPT, DECODE_NEW = 512, 128
FUSED_VS_FP32 = 1.1              # fused / unfused mean logit error vs fp32
LLAMA_GRAD_TOL = (0.045, 0.054)  # llama1b bf16 gradients vs fp32, mean
                                 # relative error over leaves and worst
                                 # leaf: 1.5x the largest readings (3.0010e-2,
                                 # blocks.wk 3.5701e-2) against fp32
DECODE_LOGIT_TOL = 0.18          # bf16 engine vs fp32 logits, scaled: 1.5x
                                 # the largest reading (0.1230, unfused;
                                 # fused 0.1175) of 128 forced llama1b steps


def _decode_counters():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
    from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    return {"decode_attention": da.decode_attention,
            "rope_flash_fwd": fra.rope_flash_fwd, "swiglu": fba.swiglu_fwd,
            "flash_fwd_sep": fa.flash_fwd_sep,
            "fused_norm_epilogue": fne.norm_epilogue_fwd,
            "quant_matmul": quant_matmul}


def _counted(fn, counters_of=_decode_counters):
    """(fn(), launches of a path's kernels during it): every count set to
    0 just before, read just after."""
    counters = counters_of()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def _allocations(fn):
    """(fn(), the caching allocator's allocations during it)."""
    key = "allocation.all.allocated"
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()[key]
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()[key] - before


def _check_decode_plan(B, nKV, G, S, d, pos, dtype, quant) -> None:
    """K10's C launcher plans the launch as decode_plan does."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    want = da.decode_plan(B, nKV, G, d, pos, dtype, quant)
    got = da.decode_plan_c(B, nKV, G, S, d, pos, dtype, quant)
    if got != want:
        raise AssertionError(f"decode_plan_c {got} != decode_plan {want} "
                             f"at B{B} nKV{nKV} G{G} d{d} pos {pos} {dtype} "
                             f"quant {quant}")


def check_decode_attention(dev) -> dict:
    """K10 at the llama1b decode shapes: B 1, 8, 16, nKV 4, G 4, S 2048,
    d 128, bf16, pos 0 (the first chunk alone), 100 (a ragged chunk), 511
    and 639 (the prompt's end and the last step of a 128-token decode),
    2047 (the whole cache); once in fp32."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(11)
    nKV, G, S, d = 4, 4, 2048, 128
    scale = d ** -0.5
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = [(B, torch.bfloat16) for B in (1, 8, 16)] + [(2, torch.float32)]
    for B, dt in cases:
        q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(dt)
        ck = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(dt)
        cv = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(dt)
        for pos in (0, 100, 511, 639, 2047):
            _check_decode_plan(B, nKV, G, S, d, pos, dt, False)
            got, n_alloc = _allocations(
                lambda: da.decode_attention(q, ck, cv, pos, scale))
            if n_alloc != 1:
                raise AssertionError(f"K10 B{B} pos {pos}: {n_alloc} "
                                     "allocations a call, want the output's")
            ref = da.decode_attention_plain(q, ck, cv, pos, scale)
            again = da.decode_attention(q, ck, cv, pos, scale)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("K10 is not deterministic")
            tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
            worst[dt] = max(worst[dt], _hold(
                f"K10 {dt} B{B} pos {pos}", got, ref, tol))
    B, pos = 16, DECODE_PROMPT + DECODE_NEW - 1
    q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    ck = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(
        torch.bfloat16)
    cv = torch.randn((B, nKV, S, d), generator=gen, device=dev).to(
        torch.bfloat16)
    fn = lambda: da.decode_attention(q, ck, cv, pos, scale)  # noqa: E731
    ms, device_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: da.decode_attention_plain(q, ck, cv, pos,
                                                          scale))
    # library yardstick: SDPA on the repeated cache cut at pos
    qh = q[:, :, None, :]
    kr = ck[:, :, :pos + 1].repeat_interleave(G, dim=1)
    vr = cv[:, :, :pos + 1].repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qh, kr, vr, scale=scale)  # noqa: E731
    library_ms, library_device_ms = _time_ms(lib), _graph_ms(lib)
    nbytes = 2 * B * nKV * (pos + 1) * d * 2 + 2 * q.numel() * 2
    bound_ms, bound_by = _bound(nbytes, 4.0 * B * nKV * G * (pos + 1) * d)
    print(f"K10 bf16 B{B} pos {pos}: kernel {ms:.4f} ms (device "
          f"{device_ms:.4f}), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms (device {library_device_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/decode_attention.py:74",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_fp32": worst[torch.float32], "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "shape": f"B{B} nKV{nKV} G{G} S{S} d{d} pos {pos} bf16"}


def check_decode_int8(dev) -> dict:
    """K10q at K10's shapes (B 16, nKV 4, G 4, S 2048, d 128), int8 caches
    with [B, nKV, S] fp32 scales, bf16 and fp32 q, at five positions:
    equal to K10 on the pre-dequantized cache (torch.equal) and within
    K10's tolerance of the plain version."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.quant import dequantize_int8

    gen = torch.Generator(device=dev).manual_seed(23)
    B, nKV, G, S, d = 16, 4, 4, 2048, 128
    scale = d ** -0.5
    kq, vq = (torch.randint(-127, 128, (B, nKV, S, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, nKV, S), generator=gen, device=dev) * 0.02
              + 0.01 for _ in range(2))
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(dt)
        kd = dequantize_int8(kq, ks[..., None], dt)
        vd = dequantize_int8(vq, vs[..., None], dt)
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        worst[dt] = 0.0
        for pos in (0, 100, 511, 639, 2047):
            _check_decode_plan(B, nKV, G, S, d, pos, dt, True)
            got, n_alloc = _allocations(lambda: da.decode_attention_int8(
                q, kq, vq, ks, vs, pos, scale))
            if n_alloc != 1:
                raise AssertionError(f"K10q pos {pos}: {n_alloc} "
                                     "allocations a call, want the output's")
            k10 = da.decode_attention(q, kd, vd, pos, scale)
            ref = da.decode_attention_plain(q, kq, vq, pos, scale, ks, vs)
            torch.cuda.synchronize()
            if not torch.equal(got, k10):
                raise AssertionError(f"K10q {dt} pos {pos}: differs from "
                                     "K10 on the pre-dequantized cache")
            worst[dt] = max(worst[dt], _hold(f"K10q {dt} pos {pos}", got,
                                             ref, tol))
    pos = DECODE_PROMPT + DECODE_NEW - 1
    fn = lambda: da.decode_attention_int8(  # noqa: E731
        q, kq, vq, ks, vs, pos, scale)
    ms, device_ms = _time_ms(fn), _graph_ms(fn)
    plain_ms = _time_ms(lambda: da.decode_attention_plain(
        q, kq, vq, pos, scale, ks, vs))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kr = kd[:, :, :pos + 1].repeat_interleave(G, dim=1)
    vr = vd[:, :, :pos + 1].repeat_interleave(G, dim=1)
    qh = q[:, :, None, :]
    lib = lambda: sdpa(qh, kr, vr, scale=scale)  # noqa: E731
    library_ms, library_device_ms = _time_ms(lib), _graph_ms(lib)
    nbytes = 2 * B * nKV * (pos + 1) * (d + 4) + 2 * q.numel() * 2
    bound_ms, bound_by = _bound(nbytes, 4.0 * B * nKV * G * (pos + 1) * d)
    print(f"K10q bf16 B{B} pos {pos}: equal to K10 on dequantized caches; "
          f"kernel {ms:.4f} ms (device {device_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa on the dequantized repeated cache "
          f"{library_ms:.4f} ms (device {library_device_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/decode_attention.py:74",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_fp32": worst[torch.float32], "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "shape": f"B{B} nKV{nKV} G{G} S{S} d{d} pos {pos} int8"}


def _rope_case(gen, dev, B, S, h, d, dt):
    from paddle_tpu_torch.models.llama import LlamaConfig, rope_angles

    q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev).to(dt)
               for _ in range(3))
    cfg = LlamaConfig(hidden=h * d, n_heads=h)
    cos, sin = rope_angles(cfg, torch.arange(S, device=dev))
    return q, k, v, cos, sin


def check_rope_flash(dev) -> tuple[dict, dict]:
    """K11 at the llama1b prefill shapes ([1, 512, 16, 128] and [16, 512,
    16, 128] bf16, q rotated alone and with k) and small fp32 cases at
    head dims 128 and 256; and K1's separate-input mode at [1, 512, 16,
    128]. K11 must equal K1-separate on apply_rope'd inputs bit for bit:
    the same tile loop, so any difference is the in-tile rotation."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_rope_attention as fra

    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = [((1, 512, 16, 128), torch.bfloat16),
             ((16, 512, 16, 128), torch.bfloat16),
             ((2, 128, 2, 128), torch.float32),
             ((2, 128, 1, 256), torch.float32)]
    for shape, dt in cases:
        q, k, v, cos, sin = _rope_case(gen, dev, *shape, dt)
        cb, sb = cos[None, :, None, :], sin[None, :, None, :]
        scale = shape[-1] ** -0.5
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        for rope_k in (False, True):
            got = fra.rope_flash_fwd(q, k, v, cos, sin, True, scale, True,
                                     rope_k)[0]
            ref = fra.rope_flash_plain(q, k, v, cos, sin, True, scale, True,
                                       rope_k)[0]
            qr = fra._apply_rope_ref(q, cb, sb)
            kr = fra._apply_rope_ref(k, cb, sb) if rope_k else k
            k1 = fa.flash_fwd_sep(qr, kr, v, True, scale)[0]
            torch.cuda.synchronize()
            tag = f"K11 {dt} {list(shape)} rope_k={rope_k}"
            if not torch.equal(got, k1):
                raise AssertionError(f"{tag}: not bit-equal to K1 on the "
                                     "apply_rope'd inputs (the rotation "
                                     "in the tile is off)")
            worst[dt] = max(worst[dt], _hold(tag + " (== K1 on rotated)",
                                             got, ref, tol))
    q, k, v, cos, sin = _rope_case(gen, dev, 1, 512, 16, 128, torch.bfloat16)
    scale = 128 ** -0.5
    got = fa.flash_fwd_sep(q, k, v, True, scale)[0]
    ref = fa.flash_sep_plain(q, k, v, True, scale)[0]
    torch.cuda.synchronize()
    err_sep = _hold("K1-separate bf16 [1, 512, 16, 128]", got, ref, BF16_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timings(B):
        q, k, v, cos, sin = _rope_case(gen, dev, B, 512, 16, 128,
                                       torch.bfloat16)
        cb, sb = cos[None, :, None, :], sin[None, :, None, :]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (
            fra._apply_rope_ref(q, cb, sb), fra._apply_rope_ref(k, cb, sb),
            v))
        lib = _time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
        lib_dev = _graph_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
        pairs = B * 16 * 512 * 513 / 2
        bound = _bound(4 * q.numel() * 2, 4.0 * 128 * pairs)
        return q, k, v, cos, sin, lib, lib_dev, bound

    def rope_then_sdpa(q, k, v, cos, sin):
        """The composition K11 fuses, q rotated alone: apply_rope on q,
        then SDPA on head-major operands (k, v already rotated)."""
        cb, sb = cos[None, :, None, :], sin[None, :, None, :]
        qh = fra._apply_rope_ref(q, cb, sb).transpose(1, 2)
        return sdpa(qh, k.transpose(1, 2), v.transpose(1, 2), is_causal=True)

    q, k, v, cos, sin, lib_rope, lib_rope_dev, b_rope = timings(16)
    k11 = lambda: fra.rope_flash_fwd(q, k, v, cos, sin, True, scale, True,
                                     False)
    ms_rope = _time_ms(k11)
    dev_rope = _graph_ms(k11)
    comp_ms = _time_ms(lambda: rope_then_sdpa(q, k, v, cos, sin))
    comp_dev = _graph_ms(lambda: rope_then_sdpa(q, k, v, cos, sin))
    plain_rope = _time_ms(lambda: fra.rope_flash_plain(
        q, k, v, cos, sin, True, scale, True, False), iters=5, warmup=1)
    # the same tile loop without the rotation: K1-sep on q rotated before
    qr = fra._apply_rope_ref(q, cos[None, :, None, :], sin[None, :, None, :])
    unrot_dev = _graph_ms(lambda: fa.flash_fwd_sep(qr, k, v, True, scale))
    print(f"K11 bf16 [16, 512, 16, 128] q only: kernel {ms_rope:.4f} ms "
          f"(device {dev_rope:.4f}), plain {plain_rope:.4f} ms, sdpa on "
          f"rotated q/k {lib_rope:.4f} ms (device {lib_rope_dev:.4f}), "
          f"apply_rope + sdpa {comp_ms:.4f} ms (device {comp_dev:.4f}), "
          f"K1-sep on the rotated q (the loop without the rotation) device "
          f"{unrot_dev:.4f} ms, bound {b_rope[0]:.4f} ms ({b_rope[1]})")
    q, k, v, cos, sin, lib_sep, lib_sep_dev, b_sep = timings(1)
    ms_sep = _time_ms(lambda: fa.flash_fwd_sep(q, k, v, True, scale))
    dev_sep = _graph_ms(lambda: fa.flash_fwd_sep(q, k, v, True, scale))
    plain_sep = _time_ms(lambda: fa.flash_sep_plain(q, k, v, True, scale),
                         iters=5, warmup=1)
    print(f"K1-separate bf16 [1, 512, 16, 128]: kernel {ms_sep:.4f} ms "
          f"(device {dev_sep:.4f}), plain {plain_sep:.4f} ms, sdpa "
          f"{lib_sep:.4f} ms (device {lib_sep_dev:.4f}), bound "
          f"{b_sep[0]:.4f} ms ({b_sep[1]})")
    return ({"name": "rope_flash_fwd", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/fused_rope_attention.cu",
             "replaces": "paddle_tpu/ops/pallas/fused_rope_attention.py:116",
             "max_abs_err": worst[torch.bfloat16],
             "max_abs_err_fp32": worst[torch.float32], "ms": ms_rope,
             "device_ms": dev_rope, "plain_ms": plain_rope,
             "bound_ms": b_rope[0], "bound_by": b_rope[1],
             "library_ms": lib_rope, "library_device_ms": lib_rope_dev,
             "rope_then_sdpa_ms": comp_ms, "unrotated_device_ms": unrot_dev,
             "shape": "B16 S512 h16 d128 causal, q rotated, bf16"},
            {"name": "flash_fwd_sep", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_attention.cu",
             "replaces": "paddle_tpu/ops/pallas/flash_attention.py:139",
             "max_abs_err": err_sep, "ms": ms_sep, "device_ms": dev_sep,
             "plain_ms": plain_sep, "bound_ms": b_sep[0],
             "bound_by": b_sep[1], "library_ms": lib_sep,
             "shape": "B1 S512 h16 d128 causal, separate q/k/v, bf16"})


def check_swiglu(dev) -> dict:
    """K12 at the llama1b prefill FFN shapes ([512, 5504] at B 1, [8192,
    5504] at B 16), llama3-8b's ([512, 14336]) in bf16, and a small fp32
    case."""
    from paddle_tpu_torch.ops.kernels import fused_bias_act as fba

    gen = torch.Generator(device=dev).manual_seed(13)
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (n, f), dt in (((512, 5504), torch.bfloat16),
                       ((8192, 5504), torch.bfloat16),
                       ((512, 14336), torch.bfloat16),
                       ((512, 256), torch.float32)):
        g = (2.0 * torch.randn((n, f), generator=gen, device=dev)).to(dt)
        u = torch.randn((n, f), generator=gen, device=dev).to(dt)
        y = fba.swiglu_fwd(g, u)
        ref = fba.swiglu_plain(g, u)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        errs[dt] = max(errs[dt], _hold(
            f"K12 {dt} [{n}, {f}] (bit-equal: {torch.equal(y, ref)})", y,
            ref, tol))
    g = (2.0 * torch.randn((8192, 5504), generator=gen, device=dev)).to(
        torch.bfloat16)
    u = torch.randn((8192, 5504), generator=gen, device=dev).to(
        torch.bfloat16)
    ms = _time_ms(lambda: fba.swiglu_fwd(g, u))
    plain_ms = _time_ms(lambda: fba.swiglu_plain(g, u))
    g32 = g.float()
    silu_ms = _time_ms(lambda: torch.nn.functional.silu(g32))
    N, Fd = g.shape
    bound_ms, bound_by = _bound(3 * N * Fd * 2, 6.0 * N * Fd,
                                FP32_FLOP_PER_S)
    print(f"K12 swiglu bf16 [{N}, {Fd}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no single library call (F.silu on the fp32 "
          f"gate alone {silu_ms:.4f} ms), bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"name": "swiglu", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_bias_act.py:97",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "silu_fp32_ms": silu_ms,
            "shape": f"N{N} F{Fd} bf16"}


def check_llama_norm_epilogue(dev) -> None:
    """K6 in the rms form at the llama1b prefill's shapes ([512, 2048] at
    B 1, [8192, 2048] at B 16, bf16 gains as the weights are): the
    residual form (ffn_norm and the next layer's attn_norm) and the
    norm-only form (layer 0's attn_norm, the final norm)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = {torch.bfloat16: 0.0}
    H, bf = LLAMA1B["hidden"], torch.bfloat16
    for n in (DECODE_PROMPT, 16 * DECODE_PROMPT):
        for form, sub in (("residual", True), ("norm-only", False)):
            _norm_case(gen, dev, worst, f"rms {form} bf16 [{n}, {H}]", n, H,
                       bf, "rms", sub, False, False, gain_dtype=bf)


def _forced_logits(m, prompt: torch.Tensor, toks: np.ndarray):
    """The logits an engine picks each token of ``toks`` from when it is
    fed ``toks`` (teacher forcing): the prefill's, then one decode step
    per token but the last. fp32 [n, B, V]."""
    with torch.no_grad():
        cache = m._empty_cache(prompt.shape[0])
        logits, cache = m._prefill_impl(prompt, cache)
        out, T = [logits], prompt.shape[1]
        for s in range(toks.shape[1] - 1):
            tok = torch.from_numpy(toks[:, s]).to(prompt.device)
            logits, cache = m._decode_impl(cache, tok, T + s)
            out.append(logits)
    return torch.stack(out).float()


def _logits_at(m, prompt: torch.Tensor, toks: np.ndarray, j: int):
    """The logits the engine picked token j from."""
    return _forced_logits(m, prompt, toks[:, :j + 1])[-1]


def _streams_agree(tag, m_ref, prompt, ref, got) -> int:
    """Rows of ``got`` must equal ``ref``'s except from a token where
    ``m_ref``'s logits (recomputed there) of the two picks are within
    MARGIN of each other: a near-tie, which for a runner-up pick is the
    top-2 margin. Returns the number of such rows."""
    exceptions = 0
    for b in range(ref.shape[0]):
        diff = np.nonzero(ref[b] != got[b])[0]
        if not len(diff):
            continue
        j = int(diff[0])
        logits = _logits_at(m_ref, prompt, ref, j)[b].float()
        top = torch.topk(logits, 2)
        margin = (top.values[0] - top.values[1]).item()
        gap = (logits[int(ref[b, j])] - logits[int(got[b, j])]).item()
        print(f"{tag}: row {b} differs at token {j}: tokens {ref[b, j]} vs "
              f"{got[b, j]}, logit gap {gap:.3e} (limit {MARGIN:.3e}), "
              f"top-2 {top.indices.tolist()} margin {margin:.3e}")
        if not 0.0 <= gap < MARGIN:
            raise AssertionError(f"{tag}: row {b} differs at token {j} "
                                 f"with logit gap {gap}")
        exceptions += 1
    return exceptions


def _fusion_off_agrees(m, cfg, params, prompt, on: np.ndarray,
                       off: np.ndarray) -> str:
    """The unfused engine against the fused one (bf16), by teacher
    forcing: the fused engine's greedy stream ``on`` is fed to three
    engines — the fused one, the unfused one and an fp32 one (weights
    cast up, fusion off) — and the logits of every step are held, so a
    near-tie that parts the two greedy streams ends no comparison.
    - Each engine's picks from its forced logits are its own stream (the
      unfused one's up to where ``off`` parts from ``on``).
    - Each bf16 engine's logits are held to the fp32 engine's by
      _scaled_err along the vocab, within DECODE_LOGIT_TOL.
    - The fused engine is no further from fp32 than the unfused one:
      mean absolute error within FUSED_VS_FP32 of the unfused one's."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    was = GLOBAL_FLAGS.get("use_auto_fusion")
    logits = {}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = LlamaForCausalLM(cfg32, params=_map_leaves(params,
                                                     torch.Tensor.float),
                           max_batch=1, max_seq_len=m.max_seq,
                           device=prompt.device)
    try:
        for name, fused, eng in (("fused", True, m), ("unfused", False, m),
                                 ("fp32", False, m32)):
            GLOBAL_FLAGS.set("use_auto_fusion", fused)
            logits[name] = _forced_logits(eng, prompt, on)
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    del m32
    n = on.shape[1]
    parted = np.nonzero((on != off).any(axis=0))[0]
    j = int(parted[0]) if len(parted) else n
    picks = {k: v.argmax(-1).t().cpu().numpy() for k, v in logits.items()}
    if not (np.array_equal(picks["fused"], on)
            and np.array_equal(picks["unfused"][:, :j + 1],
                               off[:, :j + 1])):
        raise AssertionError("fusion off vs on: the forced logits do not "
                             "give the engines' own streams")
    ref = logits["fp32"]
    stats = {}
    for k in ("fused", "unfused"):
        err, scaled = _scaled_err(logits[k], ref)
        stats[k] = ((logits[k] - ref).abs().mean().item(), err, scaled)
    vs = _scaled_err(logits["fused"], logits["unfused"])
    print(f"fusion off vs on: {n} teacher-forced steps against fp32: mean "
          "/ max abs / max scaled logit error fused "
          "{:.4e} / {:.4e} / {:.4e}, unfused {:.4e} / {:.4e} / {:.4e}; "
          "fused vs unfused max abs {:.4e}, scaled {:.4e} (tol {:.3e}); "
          "fp32 picks equal the fused stream at {:.3f} of tokens".format(
              *stats["fused"], *stats["unfused"], *vs, DECODE_LOGIT_TOL,
              (picks["fp32"] == on).mean()))
    if not max(stats["fused"][2], stats["unfused"][2]) <= DECODE_LOGIT_TOL:
        raise AssertionError(f"decode logits against fp32: {stats}")
    if not stats["fused"][0] <= FUSED_VS_FP32 * stats["unfused"][0]:
        raise AssertionError(f"the fused engine is further from fp32 "
                             f"than the unfused one: {stats}")
    if j == n:
        return "greedy streams equal"
    return f"greedy streams equal up to token {j} of {n}"


def _timed_generate(m, prompt, k, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = m.generate(prompt, max_new_tokens=k, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _check_generate_launches(tag, L, new, ln, int8=False, fused=True):
    want = {"decode_attention": L * (new - 1),
            "rope_flash_fwd": L if fused else 0,
            "swiglu": L if fused else 0,
            "flash_fwd_sep": 0 if fused else L,
            "fused_norm_epilogue": 2 * L + 1 if fused else 0,
            "quant_matmul": (7 * L + 1) * new if int8 else 0}
    if ln != want:
        raise AssertionError(f"{tag}: launches {ln} != {want}")


def _check_fusion_report(L) -> str:
    from paddle_tpu_torch import compiler

    rep = compiler.last_report()
    counts = _template_counts(rep)
    want = {("rms_epilogue", True): 2 * L + 1, ("rope_attention", True): L,
            ("swiglu", True): L}
    if counts != want or rep.errors:
        raise AssertionError(f"prefill fusion report {counts} (errors "
                             f"{rep.errors}) != {want}")
    return (f"program {rep.program_hash}, {rep.n_applied}/{rep.n_sites} "
            "sites applied: " + ", ".join(f"{c} {t}" for (t, _), c
                                          in counts.items()))


def run_decode(dev) -> dict:
    """LlamaForCausalLM at llama1b, random bf16 weights drawn on the card
    from seed 0, the reference bench's decode protocol (bench.py
    _bench_decode): prompts of 512 tokens from RandomState(0), prefill ms
    (max_new_tokens=1) and decode tokens/s by prefill subtraction, min of
    2 each after a warm-up call of each, at B 1, 8 and 16, 128 new tokens,
    greedy; then a sampled generate at B 8, the weight-only int8 engine
    at B 8, the fusion-off engine at B 1 against the fused one (teacher
    forced, each held to an fp32 engine), a profiled decode window, and
    llama3-8b at B 1 (32 new tokens). Each run's launches are checked
    with its counts set to 0 just before it. Returns the main path's own
    counts: K10, K11 and K12 from the B 16 greedy generate, K1's
    separate-input mode from the fusion-off one."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               init_llama_params,
                                               llama_presets)

    cfg = LlamaConfig(**LLAMA1B)
    L, n = cfg.n_layers, DECODE_NEW
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.RandomState(0)
    counts = {}
    results, greedy_b1, greedy_b8, prompts, report = {}, None, None, {}, ""
    for B in (1, 8, 16):
        m = LlamaForCausalLM(cfg, params=params, max_batch=B,
                             max_seq_len=cfg.max_seq_len, device=dev)
        prompts[B] = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (B, DECODE_PROMPT))).to(dev)
        (_, toks), ln = _counted(lambda: _timed_generate(m, prompts[B], n))
        _check_generate_launches(f"decode B{B}", L, n, ln)
        if B == 16:
            counts.update((k, ln[k]) for k in ("decode_attention",
                                               "rope_flash_fwd", "swiglu"))
        report = _check_fusion_report(L)
        if toks.shape != (B, n) or not ((toks >= 0) & (toks < cfg.vocab_size)
                                        ).all():
            raise AssertionError(f"decode B{B}: tokens {toks.shape} out of "
                                 "range")
        _timed_generate(m, prompts[B], 1)
        t_pre = min(_timed_generate(m, prompts[B], 1)[0] for _ in range(2))
        runs = [_timed_generate(m, prompts[B], n) for _ in range(2)]
        for _, again in runs:
            if not np.array_equal(again, toks):
                raise AssertionError(f"decode B{B}: greedy stream changed "
                                     "between calls")
        dt = min(t for t, _ in runs) - t_pre
        results[B] = (t_pre * 1e3, B * (n - 1) / dt)
        print(f"decode llama1b B{B}: prefill {DECODE_PROMPT} tokens "
              f"{t_pre * 1e3:.2f} ms, decode {B * (n - 1) / dt:.1f} "
              f"tokens/s ({dt / (n - 1) * 1e3:.2f} ms/step), launches per "
              f"generate {ln}")
        if B == 1:
            greedy_b1 = (m, toks)
        if B == 8:
            greedy_b8 = toks
            (_, samp), ln = _counted(lambda: _timed_generate(
                m, prompts[8], n, temperature=0.8, top_p=0.9, seed=1))
            _check_generate_launches("sampled B8", L, n, ln)
            if samp.shape != (8, n) or np.array_equal(samp, toks):
                raise AssertionError("sampled B8: shape or stream wrong")
            print(f"decode llama1b B8 sampled (T 0.8, top_p 0.9): "
                  f"{(samp == toks).mean():.3f} of tokens equal the greedy "
                  "stream's")
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                wall, _ = _timed_generate(m, prompts[8], 32)
            _print_profile(prof, {"wall_s": wall})
        del m
        torch.cuda.empty_cache()
    print(f"decode fusion report: {report}")

    # weight-only int8 at B 8
    mq = LlamaForCausalLM(dataclasses.replace(cfg, weight_only_int8=True),
                          params=params, max_batch=8, device=dev)
    (_, qtoks), ln = _counted(lambda: _timed_generate(mq, prompts[8], n))
    _check_generate_launches("int8 B8", L, n, ln, int8=True)
    _timed_generate(mq, prompts[8], 1)
    tq = min(_timed_generate(mq, prompts[8], 1)[0] for _ in range(2))
    dq = min(_timed_generate(mq, prompts[8], n)[0] for _ in range(2)) - tq
    results["int8"] = (tq * 1e3, 8 * (n - 1) / dq)
    print(f"decode llama1b int8 B8: prefill {tq * 1e3:.2f} ms, decode "
          f"{8 * (n - 1) / dq:.1f} tokens/s, launches per generate {ln}; "
          f"{(qtoks == greedy_b8).mean():.3f} of greedy tokens equal the "
          "bf16 engine's (random weights: near-flat logits)")
    del mq
    torch.cuda.empty_cache()

    # fusion off at B 1: the prefill through K1-separate and plain
    # composition, held to the fused greedy stream
    m, toks = greedy_b1
    was = GLOBAL_FLAGS.get("use_auto_fusion")
    GLOBAL_FLAGS.set("use_auto_fusion", False)
    try:
        (_, off), ln = _counted(lambda: _timed_generate(m, prompts[1], n))
        t_off = min(_timed_generate(m, prompts[1], 1)[0] for _ in range(2))
    finally:
        GLOBAL_FLAGS.set("use_auto_fusion", was)
    _check_generate_launches("fusion off B1", L, n, ln, fused=False)
    counts["flash_fwd_sep"] = ln["flash_fwd_sep"]
    agree = _fusion_off_agrees(m, cfg, params, prompts[1], toks, off)
    print(f"decode fusion off B1: prefill {t_off * 1e3:.2f} ms (fused "
          f"{results[1][0]:.2f}); {agree}")
    del m, greedy_b1
    del params
    torch.cuda.empty_cache()

    # llama3-8b at B 1
    cfg8 = llama_presets("llama3-8b")
    m8 = LlamaForCausalLM(cfg8, max_batch=1, max_seq_len=2048, device=dev)
    p8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg8.vocab_size, (1, DECODE_PROMPT))).to(dev)
    (_, t8), ln = _counted(lambda: _timed_generate(m8, p8, 32))
    _check_generate_launches("llama3-8b B1", cfg8.n_layers, 32, ln)
    _check_fusion_report(cfg8.n_layers)
    t_pre8 = min(_timed_generate(m8, p8, 1)[0] for _ in range(2))
    t_all8 = min(_timed_generate(m8, p8, 32)[0] for _ in range(2))
    print(f"decode llama3-8b B1: prefill {t_pre8 * 1e3:.2f} ms, decode "
          f"{31 / (t_all8 - t_pre8):.1f} tokens/s, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del m8
    torch.cuda.empty_cache()
    return counts


def check_decode_cpu(dev) -> None:
    """A small fp32 LLaMA (head dim 128, G 2) generating on the card and
    on the CPU from identical weights, fusion on for both: the card runs
    K6, K11, K12 and K10 in fp32; greedy streams equal except where the
    CPU's top-2 margin is under MARGIN."""
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               init_llama_params)

    cfg = LlamaConfig(vocab_size=1024, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(14),
                                   "cpu")
    prompt = np.random.RandomState(15).randint(0, 1024, (2, 128))
    out = {}
    m_cpu = LlamaForCausalLM(cfg, params=cpu_params, device="cpu")
    out["cpu"] = m_cpu.generate(prompt, max_new_tokens=24)
    gpu_params = _map_leaves(cpu_params, lambda t: t.to(dev))
    m_gpu = LlamaForCausalLM(cfg, params=gpu_params, device=dev)
    out["cuda"], ln = _counted(lambda: m_gpu.generate(prompt,
                                                      max_new_tokens=24))
    if not all(ln[k] for k in ("decode_attention", "rope_flash_fwd",
                               "swiglu", "fused_norm_epilogue")):
        raise AssertionError(f"a kernel did not run on the card: {ln}")
    exc = _streams_agree("decode cpu/cuda", m_cpu, torch.from_numpy(prompt),
                         out["cpu"], out["cuda"])
    print(f"decode cpu/cuda (fp32, fusion on): 2 greedy streams of 24 "
          f"tokens equal, {exc} near-tie exceptions, card launches {ln}")


def _serving_counters():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.kernels.lora_matmul import lora_matmul

    return {"ragged_paged_attention": rpa.ragged_paged_attention,
            "ragged_paged_attention_int8": rpa.ragged_paged_attention_int8,
            "lora_matmul": lora_matmul,
            "decode_attention": da.decode_attention,
            "decode_attention_int8": da.decode_attention_int8}


def _serving_counted(fn):
    return _counted(fn, _serving_counters)


class _LogitTap:
    """Records, for every token an engine emits, the top-8 logits of the
    row it was picked from: ``tokens[(rid, j)] = (values, ids)`` for
    token j of request rid. It wraps the serving module's
    ``_pick_tokens`` (each dispatch's logits, after any constraint mask)
    and the engine's step and harvest (which row gave which token)."""

    def __init__(self, eng):
        from paddle_tpu_torch.inference import serving

        self.eng, self.mod, self.tokens = eng, serving, {}
        self._pick, self._last, self._by_out = serving._pick_tokens, None, {}
        step, harvest = eng._unified_step_impl, eng._harvest

        def pick(logits, *a, **kw):
            top = torch.topk(logits, 8, dim=-1)
            self._last = (top.values.cpu(), top.indices.cpu())
            return self._pick(logits, *a, **kw)

        def step_impl(*a, **kw):
            out = step(*a, **kw)
            self._by_out[id(out)] = self._last
            return out

        def harvest_(inflight):
            out, snap = inflight
            vals, ids = self._by_out.pop(id(out))
            before = {idx: len(req.out_tokens)
                      for idx, _s, req, _k, _m, _d in snap}
            harvest(inflight)
            qb = eng.qb if eng.spec_k else 1
            for idx, _s, req, kind, m, _d in snap:
                for t in range(len(req.out_tokens) - before[idx]):
                    row = idx * qb + ((m - 1 if kind == "fin" else t)
                                      if eng.spec_k else 0)
                    self.tokens[(req.rid, before[idx] + t)] = (vals[row],
                                                               ids[row])

        self._pick_tap = pick
        eng._unified_step_impl, eng._harvest = step_impl, harvest_

    def __enter__(self):
        self.mod._pick_tokens = self._pick_tap
        return self

    def __exit__(self, *exc):
        self.mod._pick_tokens = self._pick
        del self.eng._unified_step_impl, self.eng._harvest


def _serving_streams_agree(tag, ref, got, tap) -> tuple[int, int]:
    """Greedy requests of ``got`` must emit ``ref``'s streams, except from
    a token where the logits ``ref``'s engine picked it from (``tap``)
    hold the two picks within MARGIN of each other (a near-tie). Returns
    (tokens equal up to the first difference, near-tie exceptions)."""
    same, exceptions = 0, 0
    for a, b in zip(ref, got):
        if a.temperature:
            continue
        diff = [j for j, (x, y) in enumerate(zip(a.out_tokens, b.out_tokens))
                if x != y]
        if len(a.out_tokens) != len(b.out_tokens):
            raise AssertionError(f"{tag}: request {a.rid} lengths differ")
        if not diff:
            same += len(a.out_tokens)
            continue
        j = diff[0]
        same += j
        vals, ids = tap.tokens[(a.rid, j)]

        def logit(tok):
            hit = (ids == tok).nonzero()
            return vals[hit[0, 0]].item() if len(hit) else -math.inf

        top, gap = vals[0].item(), logit(a.out_tokens[j]) - logit(
            b.out_tokens[j])
        print(f"{tag}: request {a.rid} differs at token {j}: "
              f"{a.out_tokens[j]} vs {b.out_tokens[j]}, logit gap {gap:.3e} "
              f"(limit {MARGIN:.3e})")
        if not (0.0 <= gap < MARGIN and logit(a.out_tokens[j]) == top):
            raise AssertionError(f"{tag}: request {a.rid} differs at token "
                                 f"{j} with logit gap {gap}")
        exceptions += 1
    return same, exceptions


def _drive(eng, reqs, tick: float = 0.0) -> int:
    """The engine's ``run`` loop, with the page ledger held to the pool
    after every step; returns the number of steps. ``tick`` > 0 runs the
    arrivals on a clock of ``tick`` seconds per step instead of the wall
    clock, so that two engines see the same schedule."""
    for r in sorted(reqs, key=lambda r: r.arrival):
        eng.submit(r)
    t0, n = time.perf_counter(), 0

    def now():
        return n * tick if tick else time.perf_counter() - t0

    while eng.step(now=now()):
        n += 1
        acc = eng.page_accounting()
        if acc["total"] != eng.n_pages - 1:
            raise AssertionError(f"ledger {acc} != {eng.n_pages - 1}")
        if eng._inflight is None and not any(eng.slots) and eng.queue:
            time.sleep(0.005)
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or r.t_done is None:
            raise AssertionError(f"request {r.rid} did not complete")
    return eng.stats["unified_steps"]


class _OracleProposer:
    """Drafts a request's tokens from the non-speculative engine's streams
    of the same requests (found by prompt), with the second draft of
    every odd request off by one token: verification must accept the
    right drafts and roll the wrong ones back. On random weights the
    n-gram proposer seldom drafts (a random model's next token rarely
    occurred before in the history); these drafts exercise the verify
    rows whatever the weights."""

    def __init__(self, reqs, vocab: int):
        self.reqs, self.vocab = reqs, vocab

    def propose(self, history, k: int) -> list:
        for r in self.reqs:
            n = len(r.prompt)
            if len(history) > n and np.array_equal(history[:n], r.prompt):
                d = list(r.out_tokens[len(history) - n:][:k])
                if r.rid % 2 and len(d) > 1:
                    d[1] = (d[1] + 1) % self.vocab
                return d
        return []


def _printable_vocab(V: int) -> list:
    """A toy tokenizer for the schema: ids 1..94 the printable characters,
    every other id an empty piece (never legal), id 0 the pad token."""
    import string

    vocab = [""] * V
    for i, ch in enumerate(string.printable[:94]):
        vocab[i + 1] = ch
    return vocab


SERVING_ENGINE = dict(max_batch=8, page_size=128, max_seq=2048)


def _spec_requests(cls, vocab: int):
    """Eight requests whose prompts repeat a random 64-token pattern 2-8
    times, greedy and sampled, 16-32 new tokens."""
    rng = np.random.RandomState(7)
    out = []
    for i in range(8):
        pat = rng.randint(1, vocab, size=64).astype(np.int32)
        kw = dict(temperature=0.9, top_p=0.85, seed=200 + i) if i % 4 == 3 \
            else {}
        out.append(cls(rid=i, prompt=np.tile(pat, rng.randint(2, 9)),
                       max_new_tokens=int(rng.randint(16, 33)), **kw))
    return out


def _tenant_requests(cls, vocab: int, lora: bool):
    """Six low-priority requests of ``_requests`` at t = 0 (rids 1 and 4
    on adapter a1, 2 on a2 when ``lora``, rid 3 constrained to a schema),
    and a high-priority 900-token request at t = 0.5 s that finds the
    pool full and preempts."""
    reqs = _requests(cls, vocab)[:6]
    for r in reqs:
        r.arrival = 0.0
        if lora and r.rid in (1, 2, 4):
            r.adapter_id = "a2" if r.rid == 2 else "a1"
        if r.rid == 3:
            r.schema_id = "animal"
    hi = np.random.RandomState(8).randint(1, vocab, size=900).astype(
        np.int32)
    reqs.append(cls(rid=6, prompt=hi, max_new_tokens=24, priority=2,
                    arrival=0.5))
    return reqs


def _tenant_engine(cfg, params, dev, lora: bool, n_pages: int):
    from paddle_tpu_torch.inference.multitenant import (json_schema_dfa,
                                                        make_lora)
    from paddle_tpu_torch.inference.serving import ServingEngine

    eng = ServingEngine(cfg, params=params, device=dev, n_pages=n_pages,
                        lora=lora, priorities=True, constrained=True,
                        **SERVING_ENGINE)
    if lora:
        for name, seed in (("a1", 1), ("a2", 2)):
            eng.register_adapter(name, make_lora(cfg, 8, seed=seed))
    vocab = _printable_vocab(cfg.vocab_size)
    eng.register_schema("animal", json_schema_dfa(
        {"enum": ["cat", "car", "dog"]}, vocab).fresh)
    return eng, vocab


def run_serving(dev) -> dict:
    """The serving engine's int8 KV, speculative and multi-tenant paths
    at llama3-8b (32 layers, f 14336, vocab 128256, random bf16 weights
    from seed 0 on the card), then card against CPU on a small fp32
    config, and the public int8 decode entry. Returns the launches of
    each path's own kernel in its own run: K8q in (a), K13 in (c), K10q
    in (e)."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import init_llama_params, llama_presets

    cfg = llama_presets("llama3-8b")
    L = cfg.n_layers
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    counts = {}

    # (a) int8 KV pages against the bf16 engine
    runs = {}
    for kv_quant in (False, True):
        eng = ServingEngine(cfg, params=params, device=dev,
                            kv_quant=kv_quant, **SERVING_ENGINE)
        reqs = _requests(Request, cfg.vocab_size)
        stats, ln = _serving_counted(lambda: eng.run(reqs))
        steps = stats["unified_steps"]
        for r in reqs:
            if len(r.out_tokens) != r.max_new_tokens or r.t_done is None:
                raise AssertionError(f"kv_quant={kv_quant}: request "
                                     f"{r.rid} did not complete")
        acc = eng.page_accounting()
        if acc["total"] != eng.n_pages - 1:
            raise AssertionError(f"page ledger {acc}")
        want = (0, L * steps) if kv_quant else (L * steps, 0)
        got = (ln["ragged_paged_attention"],
               ln["ragged_paged_attention_int8"])
        if got != want:
            raise AssertionError(f"kv_quant={kv_quant}: K8 / K8q launches "
                                 f"{got} != {want}")
        # llama3-8b: 65552 (int8 k and v + the two fp32 scales of a page
        # over its 128 tokens) against 131072 in bf16
        bpt = eng.kv_bytes_per_token()
        item = torch.finfo(cfg.dtype).bits // 8
        per_layer = cfg.n_kv_heads * (2 * cfg.head_dim + 8 / eng.bs
                                      if kv_quant else 2 * item * cfg.head_dim)
        if bpt != L * per_layer:
            raise AssertionError(f"kv bytes per token {bpt} != "
                                 f"{L * per_layer}")
        runs[kv_quant] = reqs
        print(f"serving llama3-8b kv_quant={kv_quant}: {steps} steps, "
              f"{stats['wall_s'] / steps * 1e3:.1f} ms/step, "
              f"{stats['throughput_tok_s']:.1f} tok/s, ttft p50 "
              f"{stats['ttft_p50_s'] * 1e3:.1f} ms, {bpt:.0f} KV bytes per "
              f"token, launches K8 {got[0]} K8q {got[1]}")
        if kv_quant:
            counts["ragged_paged_attention_int8"] = got[1]
        del eng
    greedy = [(a.out_tokens, b.out_tokens) for a, b in zip(runs[False],
                                                          runs[True])
              if a.temperature == 0]
    same = sum(x == y for a, b in greedy for x, y in zip(a, b))
    print(f"serving int8 KV vs bf16 greedy agreement: first token "
          f"{sum(a[0] == b[0] for a, b in greedy)}/{len(greedy)}, all "
          f"tokens {same}/{sum(len(a) for a, _ in greedy)} (random weights:"
          " near-flat logits)")

    # (b) speculative decode against the non-speculative engine, with
    # the n-gram proposer, then with drafts known to be right or wrong
    eng = ServingEngine(cfg, params=params, device=dev, **SERVING_ENGINE)
    base = _spec_requests(Request, cfg.vocab_size)
    with _LogitTap(eng) as tap:
        base_st = eng.run(base)
    del eng
    for name in ("n-gram", "oracle"):
        eng = ServingEngine(cfg, params=params, device=dev, speculative_k=3,
                            **SERVING_ENGINE)
        if name == "oracle":
            eng._proposer = _OracleProposer(base, cfg.vocab_size)
        reqs = _spec_requests(Request, cfg.vocab_size)
        st = eng.run(reqs)
        del eng
        same, exc = _serving_streams_agree(f"serving spec {name}", base,
                                           reqs, tap)
        samp = sum(a.out_tokens == b.out_tokens
                   for a, b in zip(base, reqs) if a.temperature)
        if name == "oracle" and not (st["spec_accepted_tokens"] and
                                     st["waste_spec_rejected_slot_tokens"]):
            raise AssertionError(f"oracle drafts: {st}")
        print(f"serving spec k=3 ({name} drafts): {st['unified_steps']} "
              f"steps against {base_st['unified_steps']}, "
              f"{st['wall_s'] / st['unified_steps'] * 1e3:.1f} ms/step, "
              f"accept rate {st['spec_accept_rate']:.3f} "
              f"({st['spec_accepted_tokens']}/{st['spec_proposed_tokens']}, "
              f"{st['waste_spec_rejected_slot_tokens']} rejected); greedy "
              f"tokens equal {same}, {exc} near-tie exceptions; sampled "
              f"streams equal {samp}/2")

    # (c) LoRA + priorities + constrained decoding on a tight pool
    bs = SERVING_ENGINE["page_size"]
    need = sum(-(-(len(r.prompt) + r.max_new_tokens) // bs)
               for r in _tenant_requests(Request, cfg.vocab_size, True)[:6])
    n_pages = 1 + need + 2 + 2          # + one page per adapter, slack 2
    res = {}
    for lora in (False, True):
        eng, vocab = _tenant_engine(cfg, params, dev, lora, n_pages)
        reqs = _tenant_requests(Request, cfg.vocab_size, lora)
        lora_before = _lora_launch_counts()
        with _LogitTap(eng) as tap:
            steps, ln = _serving_counted(lambda: _drive(eng, reqs))
        res[lora] = (reqs, tap, eng.stats, ln, steps)
        if lora:
            if ln["lora_matmul"] != 2 * L * steps:
                raise AssertionError(f"K13 launches {ln['lora_matmul']} != "
                                     f"2 x {L} x {steps}")
            _check_lora_variants("serving multi-tenant", lora_before,
                                 2 * L * steps)
            counts["lora_matmul"] = ln["lora_matmul"]
            held = eng.adapters.n_pages_held()
        del eng
    reqs, _, st, ln, steps = res[True]
    if st["preemptions"] < 1 or not any(r.n_preempted for r in reqs):
        raise AssertionError(f"no preemption: {st['preemptions']}")
    text = "".join(vocab[t] for t in reqs[3].out_tokens)
    if text[:3] not in ("cat", "car", "dog") or any(reqs[3].out_tokens[3:]):
        raise AssertionError(f"constrained stream {reqs[3].out_tokens}")
    plain = [r for r in res[False][0] if r.rid not in (1, 2, 4)]
    tenant = [r for r in reqs if r.rid not in (1, 2, 4)]
    same, exc = _serving_streams_agree("serving lora", plain, tenant,
                                       res[False][1])
    print(f"serving multi-tenant: {steps} steps on {n_pages} pages, "
          f"preemptions {st['preemptions']} (victims "
          f"{[r.rid for r in reqs if r.n_preempted]}, all completed), "
          f"adapter pages {held}, constrained stream {text!r}, "
          f"no-adapter tokens equal to the LoRA-off engine's {same}, "
          f"{exc} near-tie exceptions; launches {ln}")
    del params, res
    torch.cuda.empty_cache()

    # (d) card against CPU, small fp32, every axis
    check_serving_cpu(dev)

    # (e) the public int8 decode entry: a 128-step decode over a dense
    # int8 cache at the llama1b decode shapes
    counts["decode_attention_int8"] = _int8_decode_entry(dev)
    return counts


def _int8_decode_entry(dev) -> int:
    """``decode_attention(..., k_scale=, v_scale=)``, the reference's only
    route to its int8 arm, at K10's decode shapes (B 16, nKV 4, G 4,
    d 128, S 2048) over positions 512..639 of a per-position int8 cache
    quantized from a bf16 one; every call must reach K10q."""
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention
    from paddle_tpu_torch.ops.quant import absmax_quantize_int8

    gen = torch.Generator(device=dev).manual_seed(24)
    B, nKV, G, S, d = 16, 4, 4, 2048, 128
    cache = [torch.randn((B, nKV, S, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    (kq, ks), (vq, vs) = (absmax_quantize_int8(c, axis=-1) for c in cache)
    ks, vs = ks[..., 0], vs[..., 0]
    q = torch.randn((B, nKV * G, d), generator=gen, device=dev).to(
        torch.bfloat16)

    def loop():
        return [decode_attention(q, kq, vq, pos, d ** -0.5, k_scale=ks,
                                 v_scale=vs)
                for pos in range(DECODE_PROMPT, DECODE_PROMPT + DECODE_NEW)]

    outs, ln = _serving_counted(loop)
    if ln["decode_attention_int8"] != DECODE_NEW or ln["decode_attention"]:
        raise AssertionError(f"int8 decode entry launches {ln}")
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("int8 decode entry: non-finite output")
    print(f"int8 decode entry: {DECODE_NEW} calls at B{B}, launches {ln}")
    return ln["decode_attention_int8"]


def check_serving_cpu(dev) -> None:
    """A small fp32 engine (head dim 128, G 2, page 16) on the card and on
    the CPU from identical weights, int8 KV pages on, twice: with LoRA,
    priorities and constrained decoding on a tight pool, and with
    speculation (constrained decoding refuses it). Greedy streams equal
    except where the CPU engine's logits hold the two picks within
    MARGIN; ledgers equal; K8q, and K13 with LoRA, launched on the card."""
    from paddle_tpu_torch.inference.multitenant import (json_schema_dfa,
                                                        make_lora)
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params

    cfg = LlamaConfig(vocab_size=1024, hidden=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32)
    cpu_params = init_llama_params(cfg, torch.Generator().manual_seed(25),
                                   "cpu")
    cuda_params = _map_leaves(cpu_params, lambda t: t.to(dev))
    vocab = _printable_vocab(cfg.vocab_size)

    def requests(tenant: bool):
        rng = np.random.RandomState(26)
        pat = rng.randint(1, 1024, size=12).astype(np.int32)
        reqs = []
        for i in range(6):
            prompt = (np.tile(pat, rng.randint(2, 6)) if i % 2 else
                      rng.randint(1, 1024, size=rng.randint(10, 90)).astype(
                          np.int32))
            kw = {}
            if tenant:
                kw = dict(priority=int(i == 5), arrival=0.4 * (i == 5),
                          adapter_id=("a1", None, "a2")[i % 3],
                          schema_id="animal" if i == 2 else None)
            reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=12,
                                **kw))
        return reqs

    for tag, kw in (("lora+priorities+constrained",
                     dict(lora=True, priorities=True, constrained=True,
                          n_pages=24)),
                    ("speculative", dict(speculative_k=3))):
        res = {}
        for name, params, device in (("cpu", cpu_params, "cpu"),
                                     ("cuda", cuda_params, dev)):
            eng = ServingEngine(cfg, params=params, max_batch=3,
                                page_size=16, max_seq=512, prefill_budget=64,
                                kv_quant=True, device=device, **kw)
            if "lora" in kw:
                for a, seed in (("a1", 1), ("a2", 2)):
                    eng.register_adapter(a, make_lora(cfg, 8, seed=seed,
                                                      scale=0.3))
                eng.register_schema("animal", json_schema_dfa(
                    {"enum": ["cat", "car", "dog"]}, vocab).fresh)
            reqs = requests("lora" in kw)
            lora_before = _lora_launch_counts()
            with _LogitTap(eng) as tap:
                if name == "cuda":
                    _, ln = _serving_counted(lambda: _drive(eng, reqs, 0.05))
                else:
                    _drive(eng, reqs, 0.05)
            if name == "cuda" and "lora" in kw:
                _check_lora_variants(f"serving cpu/cuda {tag}", lora_before,
                                     ln["lora_matmul"])
            res[name] = (reqs, tap, eng.page_accounting(), dict(eng.stats))
        want = ["ragged_paged_attention_int8"] + (
            ["lora_matmul"] if "lora" in kw else [])
        if not all(ln[k] for k in want) or ln["ragged_paged_attention"]:
            raise AssertionError(f"serving cpu/cuda {tag}: launches {ln}")
        same, exc = _serving_streams_agree(f"serving cpu/cuda {tag}",
                                           res["cpu"][0], res["cuda"][0],
                                           res["cpu"][1])
        if res["cpu"][2] != res["cuda"][2]:
            raise AssertionError(f"ledgers differ: {res['cpu'][2]} vs "
                                 f"{res['cuda'][2]}")
        st = res["cuda"][3]
        print(f"serving cpu/cuda (fp32, int8 KV, {tag}): {same} greedy "
              f"tokens equal, {exc} near-tie exceptions, preemptions "
              f"{st['preemptions']}, accepted drafts "
              f"{st['spec_accepted_tokens']}, card launches {ln}")


# llama2-7b's attention width (models/llama.py presets): 32 heads of 128,
# 32 layers; the paged cache at bf16, page 128, 2048 tokens a sequence
PAGED = dict(L=32, B=8, nh=32, d=128, bs=128, max_seq=2048, prompt=1024,
             steps=64)


def _paged_counters():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"paged_decode_attention_mxu": da.paged_decode_attention_mxu,
            "paged_decode_attention_kernel": da.paged_decode_attention_kernel,
            "paged_decode_attention_dma": da.paged_decode_attention_dma,
            "flash_fwd_sep": fa.flash_fwd_sep}


def _paged_case(gen, dev, dt, B, nkv, G, d, bs, mb, lens, d_major):
    """q, pages (d-major k with ``d_major``), a shuffled table and
    ``lens`` (clipped to the table) on ``dev``."""
    P = B * mb + 5
    q = torch.randn((B, nkv * G, d), generator=gen, device=dev).to(dt)
    k = torch.randn((P, nkv, d, bs) if d_major else (P, nkv, bs, d),
                    generator=gen, device=dev).to(dt)
    v = torch.randn((P, nkv, bs, d), generator=gen, device=dev).to(dt)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * mb]
    table = perm.reshape(B, mb).to(torch.int32)
    lens = torch.tensor([min(n, mb * bs) for n in lens], dtype=torch.int32,
                        device=dev)
    return q, k, v, table, lens


def _paged_timing(fn, plain, q, k, v, table, lens, d_major):
    """(kernel ms, its device ms, plain ms, SDPA ms on pre-gathered pages,
    its device ms, bound): device times from CUDA graphs of 20 calls; the
    bound counts each valid token's k and v, q and o."""
    B, nq, d = q.shape
    nkv, bs = v.shape[1], v.shape[2]
    mb = table.shape[1]
    scale = d ** -0.5
    args = (q, k, v, table, lens, scale)
    ms, device_ms = _time_ms(lambda: fn(*args)), _graph_ms(lambda: fn(*args))
    plain_ms = _time_ms(lambda: plain(*args), iters=5, warmup=1)
    t = table.long()
    kg = k[t].transpose(3, 4) if d_major else k[t]   # [B, mb, nkv, bs, d]
    kg, vg = (x.transpose(1, 2).reshape(B, nkv, mb * bs, d)
              .repeat_interleave(nq // nkv, dim=1).contiguous()
              for x in (kg, v[t]))
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = q[:, :, None, :]
    lib = lambda: sdpa(qh, kg, vg, attn_mask=mask, scale=scale)  # noqa
    lib_ms, lib_device_ms = _time_ms(lib), _graph_ms(lib)
    es = q.element_size()
    n_tok = int(lens.sum().item())
    nbytes = 2 * n_tok * nkv * d * es + 2 * q.numel() * es
    return (ms, device_ms, plain_ms, lib_ms, lib_device_ms,
            _bound(nbytes, 4.0 * n_tok * nq * d))


def _check_mxu_plan(d, bs, G, dtype) -> None:
    """K15's C launcher plans its ring as paged_mxu_plan does."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    es = torch.empty((), dtype=dtype).element_size()
    want, got = da.paged_mxu_plan(d, bs, G, es), \
        da.paged_mxu_plan_c(d, bs, G, es)
    if got != want:
        raise AssertionError(f"paged_mxu_plan_c {got} != paged_mxu_plan "
                             f"{want} at d{d} bs{bs} G{G} {dtype}")


def _check_dma_plan(d, bs, dtype) -> None:
    """K16's C launcher plans its rings as paged_dma_plan does."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    es = torch.empty((), dtype=dtype).element_size()
    want, got = da.paged_dma_plan(d, bs, es), da.paged_dma_plan_c(d, bs, es)
    if got != want:
        raise AssertionError(f"paged_dma_plan_c {got} != paged_dma_plan "
                             f"{want} at d{d} bs{bs} {dtype}")


def _dma_ring_edges(gen, dev) -> int:
    """K16 (the warp-specialised kernel) bit-equal to K14 at its rings'
    edges, d 64 / 128 / 256, pages of 16 / 64 / 128, bf16 and fp32:
    lengths 1, 0 (every page), ending on a tile, inside the second tile,
    on the k ring's last stage, a page and one, a full table; its C plan
    paged_dma_plan's. Returns the cases held."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    held = 0
    for dt in (torch.bfloat16, torch.float32):
        for d in (64, 128, 256):
            for bs in (16, 64, 128):
                _check_dma_plan(d, bs, dt)
                tile, ks = da.paged_dma_plan(d, bs, dt.itemsize)[:2]
                lens = [1, 0, tile, tile + 3, tile * ks, bs + 1, 4 * bs]
                q, k, v, table, sl = _paged_case(gen, dev, dt, len(lens), 4,
                                                 1, d, bs, 4, lens, False)
                args = (q, k, v, table, sl, d ** -0.5)
                if not torch.equal(da.paged_decode_attention_dma(*args),
                                   da.paged_decode_attention_kernel(*args)):
                    raise AssertionError(f"K16 != K14 at d{d} bs{bs} {dt} "
                                         f"lens {lens}")
                held += 1
    return held


def check_paged(dev) -> tuple[dict, dict, dict]:
    """K15, K14 and K16 against their plain versions: ragged lengths (1,
    mid-page, a full table, 0) on a shuffled table, bf16 and fp32, at
    llama2-7b's width (32 heads of 128, page 128, 16 blocks; K15 also at
    llama3-8b's GQA, 8 kv heads of 4 q heads; K14/K16 at 8 heads in fp32,
    where the reference's gate refuses 32); K16 bit-equal to K14 there
    and at its rings' edges (``_dma_ring_edges``), its C plan
    ``paged_dma_plan``'s. Timed at the paged phase's last decode step (B
    8, 1088 tokens a sequence, bf16), eager and on the device (CUDA
    graphs), beside SDPA on pre-gathered pages."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(21)
    lens = [1, 700, 2048, 0, 129, 1088]
    worst = {k: 0.0 for k in ("mxu", "tok")}
    for dt in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        for nkv, G in ((32, 1), (8, 4)):
            q, kt, v, table, sl = _paged_case(gen, dev, dt, len(lens), nkv,
                                              G, 128, 128, 16, lens, True)
            _check_mxu_plan(128, 128, G, dt)
            got = da.paged_decode_attention_mxu(q, kt, v, table, sl,
                                                128 ** -0.5)
            ref = da.paged_decode_mxu_plain(q, kt, v, table, sl,
                                            128 ** -0.5)
            worst["mxu"] = max(worst["mxu"], _hold(
                f"K15 {dt} nkv{nkv} G{G} lens {lens}", got, ref, tol))
        # in fp32 the reference's 12 MiB gate takes 8 heads, not 32
        nh = 32 if dt == torch.bfloat16 else 8
        q, k, v, table, sl = _paged_case(gen, dev, dt, len(lens), nh, 1, 128,
                                         128, 16, lens, False)
        _check_dma_plan(128, 128, dt)
        k14 = da.paged_decode_attention_kernel(q, k, v, table, sl,
                                               128 ** -0.5)
        k16 = da.paged_decode_attention_dma(q, k, v, table, sl, 128 ** -0.5)
        ref = da.paged_decode_plain(q, k, v, table, sl, 128 ** -0.5)
        torch.cuda.synchronize()
        if not torch.equal(k14, k16):
            raise AssertionError(f"K16 != K14 ({dt})")
        worst["tok"] = max(worst["tok"], _hold(
            f"K14 (== K16) {dt} nh{nh} lens {lens}", k14, ref, tol))
    print(f"K16 == K14 at {_dma_ring_edges(gen, dev)} ring-edge cases")
    B, nh, d, bs = PAGED["B"], PAGED["nh"], PAGED["d"], PAGED["bs"]
    mb = PAGED["max_seq"] // bs
    n = PAGED["prompt"] + PAGED["steps"]
    recs = []
    src = "paddle_tpu_torch/csrc/paged_decode_attention.cu"
    ref_py = "paddle_tpu/ops/pallas/decode_attention.py"
    for name, line, fn, plain, d_major, err in (
            ("paged_decode_attention_mxu", 327, da.paged_decode_attention_mxu,
             da.paged_decode_mxu_plain, True, worst["mxu"]),
            ("paged_decode_attention_kernel", 156,
             da.paged_decode_attention_kernel, da.paged_decode_plain, False,
             worst["tok"]),
            ("paged_decode_attention_dma", 198,
             da.paged_decode_attention_dma, da.paged_decode_plain, False,
             worst["tok"])):
        inputs = _paged_case(gen, dev, torch.bfloat16, B, nh, 1, d, bs, mb,
                             [n] * B, d_major)
        ms, dev_ms, plain_ms, lib_ms, lib_dev_ms, bound = _paged_timing(
            fn, plain, *inputs, d_major)
        shape = f"B{B} nh{nh} d{d} bs{bs} mb{mb} {n} tokens, bf16"
        print(f"{name} {shape}: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, sdpa on pre-gathered pages "
              f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        recs.append({"name": name, "route": "cuda", "source": src,
                     "replaces": f"{ref_py}:{line}", "max_abs_err": err,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "shape": shape})
        del inputs
    inputs = _paged_case(gen, dev, torch.bfloat16, B, 8, 4, d, bs, mb,
                         [n] * B, True)
    ms, dev_ms, plain_ms, lib_ms, lib_dev_ms, bound = _paged_timing(
        da.paged_decode_attention_mxu, da.paged_decode_mxu_plain, *inputs,
        True)
    print(f"K15 GQA (llama3-8b: nkv 8, G 4) B{B} {n} tokens bf16: kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"sdpa on pre-gathered repeated pages {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}), bound {bound[0]:.4f} ms ({bound[1]})")
    torch.cuda.empty_cache()
    return tuple(recs)


def _paged_layout_pass(dev, layout: str, gen) -> tuple[dict, list, list]:
    """block_multihead_attention over PAGED["L"] layers with ``layout``
    pages: one prefill, then PAGED["steps"] decode steps. Layer 0 of
    every 16th step and every layer of the last step are held against
    the plain version of the kernel the route took. Returns (launches of
    the decode loop, the caches, the last step's q per layer)."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer \
        as ft
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    L, B, nh, d, bs = (PAGED[k] for k in ("L", "B", "nh", "d", "bs"))
    S, steps = PAGED["prompt"], PAGED["steps"]
    bf = torch.bfloat16
    route, kernel, plain = (("mxu", "paged_decode_attention_mxu",
                             da.paged_decode_mxu_plain)
                            if layout == "d_major" else
                            ("kernel", "paged_decode_attention_kernel",
                             da.paged_decode_plain))
    mb = PAGED["max_seq"] // bs
    caches = [ft.PagedKVCache(B * mb, nh, bs, d, B, PAGED["max_seq"],
                              dtype=bf, k_layout=layout, device=dev)
              for _ in range(L)]

    def prefill():
        """Each layer's prompt qkv drawn, then its call timed alone;
        returns (layer 0's qkv and output, the calls' seconds)."""
        first, secs = None, 0.0
        for c in caches:
            qkv = torch.randn((B, S, 3, nh, d), generator=gen,
                              device=dev).to(bf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ft.block_multihead_attention(qkv, c)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            first = first or (qkv, o)
        return first, secs

    before = ft.ROUTES["flash"]
    ((qkv0, o0), secs), ln = _counted(prefill, _paged_counters)
    prefill_ms = secs * 1e3
    if ln["flash_fwd_sep"] != L or ft.ROUTES["flash"] - before != L:
        raise AssertionError(f"paged {layout} prefill: K1-sep launched "
                             f"{ln['flash_fwd_sep']} times, want {L}")
    # layer 0's prefill attention against the plain flash (pages written)
    ref = fa.flash_sep_plain(qkv0[:, :, 0], qkv0[:, :, 1], qkv0[:, :, 2],
                             True, d ** -0.5)[0]
    _hold(f"paged {layout} prefill layer 0 (K1-sep)", o0, ref, BF16_TOL)
    del qkv0, o0, ref
    torch.cuda.empty_cache()
    scale = d ** -0.5
    step_s, worst = [], 0.0
    counters = _paged_counters()
    for c in counters.values():
        c.launches = 0
    before = ft.ROUTES[route]
    for step in range(steps):
        qkvs = [torch.randn((B, 1, 3, nh, d), generator=gen,
                            device=dev).to(bf) for _ in range(L)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [ft.block_multihead_attention(qkv, c)
                for qkv, c in zip(qkvs, caches)]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        held = range(L) if step == steps - 1 else \
            (range(1) if step % 16 == 0 else ())
        for i in held:             # the plain versions launch nothing
            c = caches[i]
            ref = plain(qkvs[i][:, 0, 0], c.k_pages, c.v_pages,
                        c.block_table, c.seq_lens, scale)
            err = _scaled_err(outs[i][:, 0], ref)[1]
            if not err <= BF16_TOL:
                raise AssertionError(f"paged {layout} step {step} layer {i}"
                                     f": scaled error {err} > {BF16_TOL}")
            worst = max(worst, err)
    last_q = [qkv[:, 0, 0].contiguous() for qkv in qkvs]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    want = L * steps
    if layout == "d_major":
        _check_mxu_plan(d, bs, 1, bf)
    if launches[kernel] != want or ft.ROUTES[route] - before != want:
        raise AssertionError(f"paged {layout}: {kernel} launched "
                             f"{launches[kernel]} times (route {route} "
                             f"{ft.ROUTES[route] - before}), want {want}")
    print(f"paged llama2-7b {layout}: prefill {prefill_ms:.2f} ms (B{B} S{S}"
          f", {L} layers, K1-sep {ln['flash_fwd_sep']}), decode "
          f"{1e3 * sum(step_s) / steps:.3f} ms a step (best "
          f"{1e3 * min(step_s):.3f}, {L} layers), {kernel} {launches[kernel]}"
          f" launches over {steps} steps; layer 0 every 16th step and all "
          f"{L} layers of the last step held to the plain version: worst "
          f"scaled error {worst:.3e} (tol {BF16_TOL:.3e})")
    return launches, caches, last_q


def _hold_first_cpu_prefill(ft, qkv, fresh_cache, got, tag: str) -> None:
    """Hold the process's first CPU prefill of the case, on a fresh cache,
    to the card's output ``got`` at FP32_TOL, as the compared one is: the
    case's CPU reference once read 2.4e-4 on the first CPU prefill of a
    process that had run the card phases (ROADMAP Queue 3, open). Where
    its bits differ from a second call's, both calls' errors against a
    float64 evaluation of the same attention are printed first."""
    first = ft.block_multihead_attention(qkv, fresh_cache())
    second = ft.block_multihead_attention(qkv, fresh_cache())
    if not torch.equal(first, second):
        q, k, v = (qkv[:, :, i].double() for i in range(3))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        mask = torch.ones(s.shape[-1], s.shape[-1], dtype=torch.bool).tril()
        p = torch.softmax(torch.where(mask, s, float("-inf")), -1)
        ref = torch.einsum("bhqk,bkhd->bqhd", p, v)
        print(f"{tag}: first CPU prefill != second; scaled error against "
              f"float64 {_scaled_err(first, ref)[1]:.3e} (first), "
              f"{_scaled_err(second, ref)[1]:.3e} (second)")
    _hold(tag + " (first CPU call)", got, first, FP32_TOL)


def _paged_cpu_case(dev) -> None:
    """A small fp32 paged cache on the card and on the CPU from the same
    inputs, both layouts: prefill (K1-sep), 3 decode steps (K15 or K14)
    and K16 on the token-major pages, held within FP32_TOL."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer \
        as ft
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator().manual_seed(23)
    B, nh, d, bs, S = 2, 8, 128, 128, 128

    def cache(layout, device):
        return ft.PagedKVCache(B * 3, nh, bs, d, B, 3 * bs,
                               dtype=torch.float32, k_layout=layout,
                               device=device)

    for layout in ("d_major", "token_major"):
        caches = [cache(layout, x) for x in (dev, "cpu")]
        for T in (S, 1, 1, 1):
            qkv = torch.randn((B, T, 3, nh, d), generator=gen)
            got = ft.block_multihead_attention(qkv.to(dev), caches[0]).cpu()
            tag = f"paged fp32 card vs CPU {layout} T{T}"
            if T > 1:   # the prefill
                _hold_first_cpu_prefill(ft, qkv, lambda: cache(layout, "cpu"),
                                        got, tag)
            want = ft.block_multihead_attention(qkv, caches[1])
            _hold(tag, got, want, FP32_TOL)
        if layout == "token_major":
            q = torch.randn((B, nh, d), generator=gen)
            c, cc = caches
            got = da.paged_decode_attention_dma(
                q.to(dev), c.k_pages, c.v_pages, c.block_table, c.seq_lens,
                d ** -0.5)
            want = da.paged_decode_attention_dma(
                q, cc.k_pages, cc.v_pages, cc.block_table, cc.seq_lens,
                d ** -0.5)
            _hold("paged fp32 card vs CPU K16", got.cpu(), want, FP32_TOL)


def run_paged(dev) -> dict:
    """The incubate paged decode at llama2-7b's attention width: 32
    PagedKVCaches (one a layer; bf16, page 128, 2048 tokens, B 8), a
    1024-token prefill through block_multihead_attention (K1-sep 32
    times) and 64 decode steps with d-major pages (K15 32 times a step),
    then the same with token-major pages (K14 32 times a step); K16 (the
    warp-specialised kernel, its own rings) once a layer on the
    token-major caches, each layer bit-equal to K14; one GQA pass at
    llama3-8b's width (32 q heads, 8 kv heads) through
    paged_decode_attention (K15's native GQA); a small fp32 case, card
    against CPU. Returns the launches of K15 and K14 (decode loops) and
    K16 (its pass)."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer \
        as ft
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    ln, caches, _ = _paged_layout_pass(dev, "d_major", gen)
    launches = {"paged_decode_attention_mxu":
                ln["paged_decode_attention_mxu"]}
    del caches
    torch.cuda.empty_cache()
    ln, caches, last_q = _paged_layout_pass(dev, "token_major", gen)
    launches["paged_decode_attention_kernel"] = \
        ln["paged_decode_attention_kernel"]
    print(f"paged: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB (32 layers x 128 pages x 2 x 1 MiB a layout)")
    scale = PAGED["d"] ** -0.5

    def dma_pass():
        return [da.paged_decode_attention_dma(q, c.k_pages, c.v_pages,
                                              c.block_table, c.seq_lens,
                                              scale)
                for q, c in zip(last_q, caches)]

    k16, ln = _counted(dma_pass, _paged_counters)
    launches["paged_decode_attention_dma"] = ln["paged_decode_attention_dma"]
    for i, (q, c) in enumerate(zip(last_q, caches)):
        k14 = da.paged_decode_attention_kernel(q, c.k_pages, c.v_pages,
                                               c.block_table, c.seq_lens,
                                               scale)
        if not torch.equal(k14, k16[i]):
            raise AssertionError(f"paged: K16 != K14 at layer {i}")
    if launches["paged_decode_attention_dma"] != PAGED["L"]:
        raise AssertionError(f"paged: K16 launched {ln}")
    _check_dma_plan(PAGED["d"], PAGED["bs"], torch.bfloat16)
    print(f"paged: K16 on the {PAGED['L']} token-major caches, bit-equal to "
          f"K14 ({launches['paged_decode_attention_dma']} launches)")
    del caches, last_q, k16
    torch.cuda.empty_cache()
    # GQA at llama3-8b's width: 8 kv heads, 32 q heads, d-major pages
    B, bs, d, nkv, nq = PAGED["B"], PAGED["bs"], PAGED["d"], 8, 32
    mb = PAGED["max_seq"] // bs
    c = ft.PagedKVCache(B * mb, nkv, bs, d, B, PAGED["max_seq"],
                        dtype=torch.bfloat16, device=dev)
    k, v = (torch.randn((B, PAGED["prompt"], nkv, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    c.write_prefill(k, v)
    k, v = (torch.randn((B, 1, nkv, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    c.write_decode(k, v)
    q = torch.randn((B, 1, nq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    before = ft.ROUTES["mxu"]
    _check_mxu_plan(d, bs, nq // nkv, torch.bfloat16)
    got = ft.paged_decode_attention(q, c.k_pages, c.v_pages, c.block_table,
                                    c.seq_lens, k_layout="d_major")
    if ft.ROUTES["mxu"] != before + 1:
        raise AssertionError("paged GQA: K15 did not take the call")
    ref = da.paged_decode_mxu_plain(q[:, 0], c.k_pages, c.v_pages,
                                    c.block_table, c.seq_lens, scale)
    _hold("paged GQA llama3-8b (K15, nkv 8, G 4)", got[:, 0], ref, BF16_TOL)
    del c, k, v
    torch.cuda.empty_cache()
    _paged_cpu_case(dev)
    return launches


FLEET_ENGINE = dict(SERVING_ENGINE)       # llama3-8b replicas of the fleet


def _fleet_requests(cls, vocab: int, n: int = 8, seed: int = 40):
    """``n`` requests with 600-1100-token prompts, 32 new tokens each,
    every second one sampled."""
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(1, vocab, size=rng.randint(
        600, 1101)).astype(np.int32), max_new_tokens=32,
        **(dict(temperature=0.9, top_p=0.85, seed=300 + i) if i % 2
           else {})) for i in range(n)]


def _warm(eng, rid: int) -> None:
    """One short request through the engine before it is timed (the
    kernels are built already; this is the first launch of each), then
    its counters back at 0."""
    from paddle_tpu_torch.inference.serving import Request

    eng.run([Request(rid=rid, prompt=np.ones(640, np.int32),
                     max_new_tokens=2)])
    eng.pool.release(eng._deferred_free)
    eng._deferred_free = []
    eng.pool.commit_evictable()
    eng.stats = {k: 0 for k in eng.stats}


def _fleet_ledgers(router, tag: str) -> None:
    acc = router.page_accounting()
    for eid, a in acc["engines"].items():
        if a["total"] != router.replicas[eid].engine.n_pages - 1:
            raise AssertionError(f"{tag}: engine {eid} ledger {a}")


def _drive_fleet(router, reqs, tag: str) -> tuple[int, float]:
    """Submit ``reqs`` and tick the router until it is idle, holding both
    ledgers after every tick; returns (ticks, seconds)."""
    for r in reqs:
        router.submit(r, now=1e18)
    t0, n = time.perf_counter(), 0
    while router.step(now=1e18):
        n += 1
        _fleet_ledgers(router, tag)
        if n > 5000:
            raise AssertionError(f"{tag}: the fleet did not drain")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for r in reqs:
        if (r.aborted or r.t_done is None
                or len(r.out_tokens) != r.max_new_tokens):
            raise AssertionError(f"{tag}: request {r.rid} did not complete")
    for rep in router.replicas:
        if rep.alive and rep.engine.page_accounting()["in_flight"]:
            raise AssertionError(f"{tag}: pages left in flight")
    return n, secs


def _disagg_arm(cfg, params, dev, overlap: bool, kv_quant=(False, False),
                reqs=None, **router_kw):
    """One prefill and one decode replica of llama3-8b on one params
    dict, warmed, joined by the wire (``overlap`` or not); returns the
    router, the requests, (ticks, seconds) and the launches."""
    from paddle_tpu_torch.inference.fleet import FleetRouter
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    engs = [ServingEngine(cfg, params=params, device=dev, engine_id=i,
                          wire_overlap=overlap, kv_quant=kv_quant[i],
                          **FLEET_ENGINE) for i in range(2)]
    for i, e in enumerate(engs):
        _warm(e, -1 - i)
    router = FleetRouter(engines=engs, disagg_prefill=1, **router_kw)
    reqs = reqs or _fleet_requests(Request, cfg.vocab_size)
    tag = f"fleet disagg overlap={overlap} kv_quant={kv_quant}"
    (n, secs), ln = _serving_counted(lambda: _drive_fleet(router, reqs, tag))
    return router, reqs, (n, secs), ln


def _per_handoff(router) -> dict:
    st = router.fleet_stats()
    h = max(1, st["n_handoffs"])
    return {"handoffs": st["n_handoffs"],
            "pages": st["disagg_shipped_pages"],
            "bytes_per_handoff": st["shipped_bytes"] / h,
            "export_ms": st["wire_export_ms"] / h,
            "adopt_ms": st["wire_adopt_ms"] / h}


def _adopted_equal_cpu_conversion(cfg, params, dev) -> int:
    """An int8 replica's shipment adopted by a bf16 replica on the card:
    the adopted pages equal the host conversion of the same shipment,
    bit for bit; returns the pages compared. ``adopt_pages`` converts on
    the host too, so this holds the host-to-device copy and the
    ``index_copy_`` scatter; the conversion itself is held bitwise to
    the reference's by the CPU tests of ``tests/test_torch_wire.py``."""
    from paddle_tpu_torch.inference.serving import Request, ServingEngine

    donor = ServingEngine(cfg, params=params, device=dev, kv_quant=True,
                          **FLEET_ENGINE)
    recv = ServingEngine(cfg, params=params, device=dev, engine_id=1,
                         **FLEET_ENGINE)
    req = _fleet_requests(Request, cfg.vocab_size, n=1, seed=41)[0]
    donor.submit(req)
    while not req.out_tokens:
        donor.step(now=1e18)
    ship = donor.finalize_shipment(donor.stage_request_pages(req.rid))
    conv = recv._convert_shipment(ship)
    if recv.adopt_pages(ship) != len(conv["hashes"]):
        raise AssertionError("fleet mixed: adoption refused")
    for j, h in enumerate(conv["hashes"]):
        page = recv.pool.cache[h]
        for name, pool in (("k", recv.k_pages), ("v", recv.v_pages)):
            got = pool[:, page].cpu().view(torch.int16).numpy()
            if got.tobytes() != conv[name][j].tobytes():
                raise AssertionError(f"fleet mixed: adopted {name} page {j}"
                                     " differs from the host conversion")
    n = len(conv["hashes"])
    del donor, recv
    torch.cuda.empty_cache()
    return n


def run_fleet(dev) -> dict:
    """The serving fleet at llama3-8b (random bf16 weights from seed 0),
    replicas sharing one params dict: (a) one prefill and one decode
    replica over the wire, overlapped and synchronous, streams held to a
    lone engine's; (b) two colocated replicas under bench.py's fleet
    traffic (FleetDriver, wall clock) with replica 1 killed at the
    33rd-percentile arrival; (c) an int8 prefill replica (K8q) into a
    bf16 decode replica (K8): the adopted pages equal the host conversion
    bitwise, the int8 wire ships 65552 / 131072 of the bf16 bytes a
    page, and a chaos ``migration.stage`` corrupt is rejected by crc
    while the request still completes. Returns the launches of each
    kernel in the fleet runs."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.fleet import FleetRouter
    from paddle_tpu_torch.inference.loadgen import (FleetDriver, WorkloadSpec,
                                                    synthesize)
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import init_llama_params, llama_presets
    from paddle_tpu_torch.testing import chaos

    cfg = llama_presets("llama3-8b")
    L = cfg.n_layers
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    total = collections.Counter()

    # (a) disaggregated: a lone engine first, its logits tapped
    solo = ServingEngine(cfg, params=params, device=dev, **FLEET_ENGINE)
    _warm(solo, -9)
    ref = _fleet_requests(Request, cfg.vocab_size)
    with _LogitTap(solo) as tap:
        solo.run(ref)
    del solo
    streams, figures = {}, {}
    for overlap in (True, False):
        router, reqs, (n, secs), ln = _disagg_arm(cfg, params, dev, overlap)
        total.update(ln)
        steps = [rep.engine.stats["unified_steps"] for rep in router.replicas]
        st = router.fleet_stats()
        if st["n_handoffs"] != len(reqs) or st["disagg_shipped_pages"] <= 0:
            raise AssertionError(f"fleet disagg overlap={overlap}: {st}")
        want = {"ragged_paged_attention": L * sum(steps)}
        if {k: v for k, v in ln.items() if v} != want:
            raise AssertionError(f"fleet disagg overlap={overlap}: launches "
                                 f"{ln} != {want} (steps {steps})")
        if router.replicas[0].engine.stats["decode_steps"]:
            raise AssertionError("fleet disagg: the prefill replica decoded")
        same, exc = _serving_streams_agree(
            f"fleet disagg overlap={overlap}", ref, reqs, tap)
        samp = [(a.out_tokens == b.out_tokens)
                for a, b in zip(ref, reqs) if a.temperature]
        if not all(samp):
            raise AssertionError(f"fleet disagg overlap={overlap}: sampled "
                                 f"streams equal {samp}")
        streams[overlap] = [r.out_tokens for r in reqs]
        figures[overlap] = dict(_per_handoff(router), ticks=n,
                                ms_per_tick=secs / n * 1e3, steps=steps)
        print(f"fleet disagg llama3-8b overlap={overlap}: {n} ticks, "
              f"{secs / n * 1e3:.2f} ms a tick, steps prefill/decode "
              f"{steps}, {same} greedy tokens equal to the lone engine's, "
              f"{exc} near-tie exceptions, sampled streams equal "
              f"{sum(samp)}/{len(samp)}; {figures[overlap]}; launches "
              f"K8 {ln['ragged_paged_attention']}")
        del router
        torch.cuda.empty_cache()
    if streams[True] != streams[False]:
        raise AssertionError("fleet disagg: overlapped and synchronous wire "
                             "streams differ")
    # the host's crc32 of one llama3-8b bf16 page (k and v: 2 x 8 MiB)
    shape = (1, L, cfg.n_kv_heads, cfg.head_dim, FLEET_ENGINE["page_size"])
    page = np.random.RandomState(0).randint(0, 1 << 16, size=shape,
                                            dtype=np.uint16)
    crc_ms = {}
    for name, fn in (("chained", lambda: serving._page_crc(
            page, page, None, None, 0)),
                     ("concatenated", lambda: zlib.crc32(
                         page[0].tobytes() + page[0].tobytes()))):
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        crc_ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"fleet wire: host crc32 of one bf16 page ({2 * page.nbytes} B) "
          f"{crc_ms['chained']:.2f} ms "
          f"({2 * page.nbytes / crc_ms['chained'] / 1e6:.2f} GB/s); the "
          f"reference's form (a copy of the page's bytes first) "
          f"{crc_ms['concatenated']:.2f} ms")

    # (b) replica loss under bench.py's fleet traffic
    engs = [ServingEngine(cfg, params=params, device=dev, engine_id=i,
                          **FLEET_ENGINE) for i in range(2)]
    for i, e in enumerate(engs):
        _warm(e, -1 - i)
    router = FleetRouter(engines=engs)
    wl = synthesize(WorkloadSpec(
        n_requests=48, seed=7, vocab_size=cfg.vocab_size,
        process="poisson", rate=30.0, prefix_len=512, n_prefixes=1,
        shared_frac=0.9, tail_log_mean=5.3, tail_log_sigma=0.6,
        tail_min=32, tail_max=512, new_min=64, new_max=128,
        max_seq=1536, n_tenants=8, tenant_skew=1.2, n_sessions=6,
        deadline_ttft=30.0, deadline_e2e=120.0))
    kill_at = float(np.percentile([r.arrival for r in wl], 33))
    m, ln = _serving_counted(lambda: FleetDriver(router, clock="wall").run(
        wl, kills={kill_at: 1}))
    total.update(ln)
    steps = sum(rep.engine.stats["unified_steps"] for rep in router.replicas)
    bad = [r.rid for r in wl if r.aborted
           or len(r.out_tokens) != r.max_new_tokens]
    if bad or m["migrated_pages"] <= 0 or m["n_killed"] != 1:
        raise AssertionError(f"fleet replica loss: incomplete {bad} "
                             f"({m['n_deadline_expired']} past a deadline, "
                             f"wall {m['wall_s']} s), migrated "
                             f"{m['migrated_pages']}, killed {m['n_killed']}")
    if ln["ragged_paged_attention"] != L * steps:
        raise AssertionError(f"fleet replica loss: K8 launches {ln} != "
                             f"{L} x {steps}")
    _fleet_ledgers(router, "fleet replica loss")
    print(f"fleet replica loss llama3-8b (2 replicas, {len(wl)} requests, "
          f"kill at {kill_at:.3f} s): goodput {m['goodput_tok_s']} tok/s, "
          f"ttft p50 {m['ttft_p50_s']} s p99 {m['ttft_p99_s']} s, "
          f"migrated pages {m['migrated_pages']} "
          f"({m['migration_bytes']} B), recovery_ms max "
          f"{m['recovery_ms_max']} mean {m['recovery_ms_mean']}, recovered "
          f"{m['n_recovered']}, wall {m['wall_s']} s, {m['steps']} ticks, "
          f"deadline misses {m['n_deadline_expired']}; launches K8 "
          f"{ln['ragged_paged_attention']}")
    del router, engs
    torch.cuda.empty_cache()

    # (c) int8 prefill replica into a bf16 decode replica
    n_cmp = _adopted_equal_cpu_conversion(cfg, params, dev)
    chaos.arm(chaos.FaultPlan(seed=0).add("migration.stage", "corrupt",
                                          once=True, pool="prefill"))
    try:
        router, reqs, (n, secs), ln = _disagg_arm(
            cfg, params, dev, True, kv_quant=(True, False),
            reqs=_fleet_requests(Request, cfg.vocab_size, n=4, seed=42))
    finally:
        chaos.disarm()
    total.update(ln)
    steps = [rep.engine.stats["unified_steps"] for rep in router.replicas]
    want = {"ragged_paged_attention_int8": L * steps[0],
            "ragged_paged_attention": L * steps[1]}
    if {k: v for k, v in ln.items() if v} != want:
        raise AssertionError(f"fleet mixed: launches {ln} != {want}")
    st = router.fleet_stats()
    fig = _per_handoff(router)
    bf16 = figures[True]
    per_page = st["shipped_bytes"] / max(1, st["disagg_shipped_pages"])
    per_page_bf16 = bf16["bytes_per_handoff"] * bf16["handoffs"] / bf16[
        "pages"]
    # int8 k and v and two fp32 scales a head and layer, against bf16 k
    # and v: 65552 / 131072 at llama3-8b (head dim 128, page 128)
    bs, kv = FLEET_ENGINE["page_size"], L * cfg.n_kv_heads
    want = (kv * (2 * cfg.head_dim * bs + 8), kv * 4 * cfg.head_dim * bs)
    if st["migration_rejected"] < 1 or (per_page, per_page_bf16) != want:
        raise AssertionError(f"fleet mixed: rejected "
                             f"{st['migration_rejected']}, bytes a page "
                             f"{per_page} vs bf16 {per_page_bf16}, want "
                             f"{want}")
    print(f"fleet mixed int8 -> bf16: {n_cmp} adopted pages equal to the "
          f"host conversion; {per_page:.0f} wire bytes a page against "
          f"{per_page_bf16:.0f} in bf16 (ratio "
          f"{per_page / per_page_bf16:.6f}); corrupt staging rejected "
          f"{st['migration_rejected']} time(s), retries exhausted "
          f"{st['n_retry_exhausted']}, all {len(reqs)} requests completed; "
          f"{fig}; steps {steps}; launches K8q "
          f"{ln['ragged_paged_attention_int8']} K8 "
          f"{ln['ragged_paged_attention']}")
    del router, params
    torch.cuda.empty_cache()
    return {k: v for k, v in total.items() if v}


# -- the runtime plane: rollout, autoscale, SLO shed -------------------------

ROLLOUT_TRAFFIC = dict(       # the fleet phase's bench.py traffic, no deadlines
    n_requests=48, seed=7, process="poisson", rate=30.0, prefix_len=512,
    n_prefixes=1, shared_frac=0.9, tail_log_mean=5.3, tail_log_sigma=0.6,
    tail_min=32, tail_max=512, new_min=64, new_max=128, max_seq=1536,
    n_tenants=8, tenant_skew=1.2, n_sessions=6)


def _release() -> None:
    """Free the card's memory held by what the caller dropped: a router
    and its engines form reference cycles (``_watch``'s wrapper, ship
    jobs), which only the cycle collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def _ledgers_sum(router, tag: str) -> None:
    """Every engine's 7-class census sums to its pool (dead and retired
    ones included while the router holds them) and the fleet's too."""
    acc = router.page_accounting()
    for rep in router.replicas:
        a = acc["engines"][rep.engine.engine_id]
        if a["total"] != rep.engine.n_pages - 1:
            raise AssertionError(f"{tag}: engine {rep.engine.engine_id} "
                                 f"ledger {a}")
    if acc["fleet"]["total"] != acc["expected"]:
        raise AssertionError(f"{tag}: fleet ledger {acc}")


def _watch(router, tag: str) -> dict:
    """Wrap ``router.step`` so that every tick holds the ledgers and
    records every engine the fleet had (replacements and retired ones
    too) and whether a stream was mid-decode when a rollout began."""
    seen = {"engines": {}, "mid_decode_at_rollout": None}
    step = router.step

    def watched(now: float = 0.0) -> bool:
        active = router.rollout_active
        if active and seen["mid_decode_at_rollout"] is None:
            seen["mid_decode_at_rollout"] = any(
                r is not None and 0 < len(r.out_tokens) < r.max_new_tokens
                for rep in router.replicas for r in rep.engine.slots)
        more = step(now=now)
        _ledgers_sum(router, tag)
        for rep in router.replicas:
            seen["engines"][rep.engine.engine_id] = rep.engine
        return more

    router.step = watched
    for rep in router.replicas:
        seen["engines"][rep.engine.engine_id] = rep.engine
    return seen


def _tick(router, reqs, tag: str, now: float = 1e18, until=None,
          extra: int = 0) -> int:
    """Submit ``reqs`` and tick until the router is idle (or ``until()``
    holds), then ``extra`` more ticks; returns the ticks."""
    for r in reqs:
        router.submit(r, now=now)
    n = 0
    while router.step(now=now):
        n += 1
        if until is not None and until():
            return n
        if n > 20000:
            raise AssertionError(f"{tag}: the fleet did not drain")
    for _ in range(extra):
        router.step(now=now)
        n += 1
    return n


def _mid_decode(router) -> bool:
    return any(r is not None and 0 < len(r.out_tokens) < r.max_new_tokens
               for rep in router.replicas for r in rep.engine.slots)


def _all_done(tag: str, reqs) -> None:
    bad = [r.rid for r in reqs
           if r.aborted or len(r.out_tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"{tag}: requests {bad} did not complete")


def _k8_steps(seen) -> int:
    return sum(e.stats["unified_steps"] for e in seen["engines"].values())


def _replicas(cfg, params, dev, n: int, first_id: int = 0) -> list:
    from paddle_tpu_torch.inference.serving import ServingEngine

    engs = [ServingEngine(cfg, params=params, device=dev,
                          engine_id=first_id + i, **FLEET_ENGINE)
            for i in range(n)]
    for e in engs:
        _warm(e, -1 - e.engine_id)
    return engs


def _lone_agree(cfg, params, dev, tag: str, reqs) -> tuple[int, int]:
    """Copies of ``reqs`` (the same request may appear in several runs:
    one copy each) through one lone engine on ``params``: greedy streams
    held by ``_serving_streams_agree`` (equal, except from a near-tie of
    the lone engine's own logits), sampled ones exactly. Returns (greedy
    tokens equal, near-tie exceptions)."""
    from paddle_tpu_torch.inference.serving import Request

    def key(r):
        return (np.asarray(r.prompt).tobytes(), r.max_new_tokens,
                r.temperature, r.top_p, r.seed)

    uniq = {}
    for r in reqs:
        uniq.setdefault(key(r), Request(
            rid=len(uniq), prompt=np.asarray(r.prompt).copy(),
            max_new_tokens=r.max_new_tokens, temperature=r.temperature,
            top_p=r.top_p, seed=r.seed))
    solo = _replicas(cfg, params, dev, 1, first_id=90)[0]
    with _LogitTap(solo) as tap:
        solo.run(list(uniq.values()))
    ref = [uniq[key(r)] for r in reqs]
    same, exc = _serving_streams_agree(tag, ref, reqs, tap)
    bad = [b.rid for a, b in zip(ref, reqs)
           if a.temperature and a.out_tokens != b.out_tokens]
    if bad:
        raise AssertionError(f"{tag}: sampled streams {bad} differ from the "
                             "lone engine's")
    del solo, tap
    _release()
    return same, exc


def _params_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def run_rollout(dev) -> dict:
    """The fleet's zero-downtime operations at llama3-8b (random bf16
    weights: v1 from seed 0, v2 from seed 1; replicas at the serving
    settings sharing one params dict a version): (a) a rollout to v2
    fired mid-decode by ``FleetDriver(deploys=...)`` under the fleet
    phase's bench.py traffic, converging to v2, every stream equal to a
    lone engine's on the version it was pinned to; (b) ``rollout.canary``
    failing on engine 0: one rollback, the fleet back on v1; (c)
    ``rollout.swap`` raising: the engine replaced, the fleet on v2; (d)
    autoscale adding a replica under a burst and retiring one when idle,
    no request dropped; (e) SLO shed dropping only never-accepted
    predicted misses. The 7-class ledgers sum on every tick. Returns the
    K8 launches of the fleet runs."""
    from paddle_tpu_torch.inference.fleet import FleetRouter, WeightCatalog
    from paddle_tpu_torch.inference.loadgen import (FleetDriver, WorkloadSpec,
                                                    synthesize)
    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama import init_llama_params, llama_presets
    from paddle_tpu_torch.testing import chaos

    cfg = llama_presets("llama3-8b")
    L = cfg.n_layers
    _release()
    torch.cuda.reset_peak_memory_stats()
    v1, v2 = (init_llama_params(cfg, torch.Generator(device=dev)
                                .manual_seed(s), dev) for s in (0, 1))
    nbytes = _params_bytes(v1)
    catalog = WeightCatalog()
    put_ms = {}
    for name, p in (("v1", v1), ("v2", v2), ("v2 again", v2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ver = catalog.put(p)
        put_ms[name] = (time.perf_counter() - t0) * 1e3
        if name == "v1":
            ver1 = ver
        else:
            ver2 = ver
    if ver1 == ver2 or catalog.versions() != sorted([ver1, ver2]):
        raise AssertionError(f"rollout: catalog {catalog.versions()}")
    print(f"rollout WeightCatalog.put llama3-8b ({nbytes} B, device to host "
          f"and sha1): v1 {put_ms['v1']:.1f} ms "
          f"({nbytes / put_ms['v1'] / 1e6:.3f} GB/s), v2 {put_ms['v2']:.1f} "
          f"ms ({nbytes / put_ms['v2'] / 1e6:.3f} GB/s); v2 again (its "
          f"tensors unchanged, not hashed) {put_ms['v2 again']:.3f} ms")
    swaps = []
    set_params = ServingEngine.set_params

    def timed_set_params(self, params, version=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        set_params(self, params, version=version)
        torch.cuda.synchronize()
        swaps.append((self.engine_id, version,
                      (time.perf_counter() - t0) * 1e3))

    ServingEngine.set_params = timed_set_params
    total = collections.Counter()
    pinned = {ver1: [], ver2: []}
    try:
        # (a) a deploy through the load generator, mid-decode
        router = FleetRouter(engines=_replicas(cfg, v1, dev, 2))
        router.catalog = catalog
        seen = _watch(router, "rollout (a)")
        wl = synthesize(WorkloadSpec(vocab_size=cfg.vocab_size,
                                     **ROLLOUT_TRAFFIC))
        deploy_at = float(np.percentile([r.arrival for r in wl], 33))
        m, ln = _serving_counted(lambda: FleetDriver(router, clock="wall")
                                 .run(wl, deploys={deploy_at: ver2}))
        total.update(ln)
        st = router.fleet_stats()
        _all_done("rollout (a)", wl)
        # a stream that finished before the deploy named versions ran on
        # v1 unpinned (param_version None)
        groups = {v: [r for r in wl if (r.param_version or ver1) == v]
                  for v in (ver1, ver2)}
        if (st["fleet_versions"] != [ver2] or st["n_rollouts"] != 1
                or st["n_rollback"] or not seen["mid_decode_at_rollout"]
                or sum(map(len, groups.values())) != len(wl)
                or not all(groups.values())):
            raise AssertionError(
                f"rollout (a): {st}, mid-decode at the deploy "
                f"{seen['mid_decode_at_rollout']}, pinned "
                f"{ {v: len(g) for v, g in groups.items()} }")
        if ln["ragged_paged_attention"] != L * _k8_steps(seen):
            raise AssertionError(f"rollout (a): K8 launches {ln} != {L} x "
                                 f"{_k8_steps(seen)}")
        for v, g in groups.items():
            pinned[v] += [("a", r) for r in g]
        print(f"rollout (a) llama3-8b, 2 replicas, {len(wl)} requests, "
              f"deploy at {deploy_at:.3f} s (mid-decode): rollout_ms "
              f"{st['rollout_ms']}, rollout_stall_ms "
              f"{st['rollout_stall_ms']}, swaps (engine, ms) "
              f"{[(e, round(ms, 3)) for e, _v, ms in swaps]}, goodput "
              f"{m['goodput_tok_s']} tok/s, ttft p50 {m['ttft_p50_s']} s "
              f"p99 {m['ttft_p99_s']} s, wall {m['wall_s']} s, "
              f"{m['steps']} ticks, pinned v1/v2 {len(groups[ver1])}/"
              f"{len(groups[ver2])}, canary steps included; launches K8 "
              f"{ln['ragged_paged_attention']}")
        del router, seen
        _release()

        small = _fleet_requests(Request, cfg.vocab_size, n=8, seed=43)

        def fresh():
            return [Request(rid=r.rid, prompt=r.prompt.copy(),
                            max_new_tokens=r.max_new_tokens,
                            temperature=r.temperature, top_p=r.top_p,
                            seed=r.seed) for r in small]

        # (b) a canary failure rolls the fleet back; (c) a swap that raises
        for run, point, kind, want in (("b", "rollout.canary", "fail", ver1),
                                       ("c", "rollout.swap", "raise", ver2)):
            tag = f"rollout ({run}) {point} {kind}"
            router = FleetRouter(engines=_replicas(cfg, v1, dev, 2))
            router.catalog = catalog
            seen = _watch(router, tag)
            reqs = fresh()
            chaos.arm(chaos.FaultPlan(seed=0).add(point, kind, at=0,
                                                  engine=0))
            try:
                def drive():
                    _tick(router, reqs, tag, until=lambda: _mid_decode(router))
                    router.rollout(version=ver2)
                    return _tick(router, [], tag)
                _, ln = _serving_counted(drive)
            finally:
                chaos.disarm()
            total.update(ln)
            st = router.fleet_stats()
            _all_done(tag, reqs)
            ok = st["fleet_versions"] == [want] and (
                (st["n_canary_fail"], st["n_rollback"], st["n_killed"])
                == (1, 1, 0) if point == "rollout.canary" else
                (st["n_swap_deaths"], st["n_killed"], st["n_rollback"])
                == (1, 1, 0))
            if not ok or any(r.param_version not in pinned for r in reqs):
                raise AssertionError(f"{tag}: {st}")
            if ln["ragged_paged_attention"] != L * _k8_steps(seen):
                raise AssertionError(f"{tag}: K8 launches {ln} != {L} x "
                                     f"{_k8_steps(seen)}")
            for r in reqs:
                pinned[r.param_version].append((run, r))
            print(f"{tag}: versions {st['fleet_versions']}, n_canary_fail "
                  f"{st['n_canary_fail']}, n_rollback {st['n_rollback']}, "
                  f"n_swap_deaths {st['n_swap_deaths']}, replicas "
                  f"{[(r.engine.engine_id, r.alive) for r in router.replicas]}"
                  f", rollout_ms {st['rollout_ms']}, rollout_stall_ms "
                  f"{st['rollout_stall_ms']}; launches K8 "
                  f"{ln['ragged_paged_attention']}")
            del router, seen
            _release()

        # (d) autoscale: one replica, a burst, then idle
        tag = "rollout (d) autoscale"
        router = FleetRouter(engines=_replicas(cfg, v1, dev, 1),
                             autoscale=True, min_engines=1, max_engines=2,
                             scale_high=0.2, scale_low=0.05, scale_ewma=1.0,
                             scale_cooldown=0.0)
        seen = _watch(router, tag)
        reqs = fresh()
        _, ln = _serving_counted(lambda: _tick(router, reqs, tag, extra=4))
        total.update(ln)
        st = router.fleet_stats()
        _all_done(tag, reqs)
        if (st["n_scale_up"] < 1 or st["n_scale_down"] < 1
                or st["autoscale_n_engines_max"] != 2
                or sum(r.alive for r in router.replicas) != 1
                or router._retiring is not None):
            raise AssertionError(f"{tag}: {st}")
        if ln["ragged_paged_attention"] != L * _k8_steps(seen):
            raise AssertionError(f"{tag}: K8 launches {ln} != {L} x "
                                 f"{_k8_steps(seen)}")
        pinned[ver1] += [("d", r) for r in reqs]
        print(f"{tag}: scale up {st['n_scale_up']}, down "
              f"{st['n_scale_down']}, engines max "
              f"{st['autoscale_n_engines_max']} min "
              f"{st['autoscale_n_engines_min']}, every request completed, "
              f"engines seen {sorted(seen['engines'])}; launches K8 "
              f"{ln['ragged_paged_attention']}")
        del router, seen
        _release()

        # (e) SLO shed at a pinned rate prior (1 token/s an engine)
        tag = "rollout (e) slo shed"
        router = FleetRouter(engines=_replicas(cfg, v1, dev, 2),
                             slo_shed=True, slo_rate=1.0)
        seen = _watch(router, tag)
        safe = fresh()
        doomed = [Request(rid=100 + i, prompt=np.arange(1, 200,
                                                        dtype=np.int32),
                          max_new_tokens=8, deadline_ttft=0.5)
                  for i in range(3)]
        _, ln = _serving_counted(lambda: _tick(router, safe + doomed, tag,
                                               now=0.0))
        total.update(ln)
        st = router.fleet_stats()
        _all_done(tag, safe)
        if (st["n_slo_shed"] != 3
                or not all(d.aborted and not d.out_tokens for d in doomed)):
            raise AssertionError(f"{tag}: {st}, doomed "
                                 f"{[(d.aborted, d.out_tokens) for d in doomed]}")
        if ln["ragged_paged_attention"] != L * _k8_steps(seen):
            raise AssertionError(f"{tag}: K8 launches {ln} != {L} x "
                                 f"{_k8_steps(seen)}")
        pinned[ver1] += [("e", r) for r in safe]
        print(f"{tag}: shed {st['n_slo_shed']} never-accepted requests with "
              f"a 0.5 s TTFT budget, the {len(safe)} without one completed; "
              f"launches K8 {ln['ragged_paged_attention']}")
        del router, seen
        _release()
    finally:
        ServingEngine.set_params = set_params
    peak = torch.cuda.max_memory_allocated() / 2**30

    # every stream against a lone engine on the version it was pinned to
    for v, params in ((ver1, v1), (ver2, v2)):
        name = "v1" if v == ver1 else "v2"
        runs = collections.Counter(run for run, _r in pinned[v])
        same, exc = _lone_agree(cfg, params, dev, f"rollout on {name}",
                                [r for _run, r in pinned[v]])
        print(f"rollout: {sum(runs.values())} streams pinned to {name} (by "
              f"run {dict(sorted(runs.items()))}) equal to a lone {name} "
              f"engine's: {same} greedy tokens, {exc} near-tie exceptions")
    print(f"rollout: peak memory {peak:.2f} GiB (v1 + v2 weights "
          f"{2 * nbytes / 2**30:.2f} GiB), set_params swaps "
          f"{[(e, round(ms, 3)) for e, _v, ms in swaps]}")
    del v1, v2, catalog
    _release()
    return {k: v for k, v in total.items() if v}


# -- the runtime plane: training's self-healing loop --------------------------

RESILIENT_WORKER = "--resilient-worker"


def _gpt350m(n_layers=None):
    from paddle_tpu_torch.models.gpt import gpt_presets

    cfg = dataclasses.replace(gpt_presets("gpt3-350m"), unroll=True,
                              remat=False)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _train_batch(cfg, batch: int = 16):
    rng = np.random.RandomState(0)
    return (rng.randint(0, cfg.vocab_size, size=(batch, cfg.seq_len)),
            rng.randint(0, cfg.vocab_size, size=(batch, cfg.seq_len)))


def _step_launches(cfg, steps: int) -> dict:
    """K1, K2, K4, K5, K6, K7 launches of ``steps`` fused gpt steps."""
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    L = cfg.n_layers
    slabs = -(-cfg.vocab_size // ce.SLAB)
    return {"flash_fwd": L * steps, "flash_bwd": L * steps,
            "fused_ce_fwd": 2 * steps, "fused_ce_bwd": 3 * slabs * steps,
            "fused_norm_epilogue": (2 * L + 1) * steps,
            "fused_bias_act": L * steps}


def _resilient_loop(cfg, root: str, dev, seed: int = 0, **kw):
    from paddle_tpu_torch.parallel.resilient_step import make_resilient_loop

    return make_resilient_loop(
        cfg, root, step_kwargs=dict(lr=1e-4, seed=seed, m_dtype="bfloat16",
                                    v_dtype="bfloat16", device=dev), **kw)


def _host_leaves(state) -> dict:
    from paddle_tpu_torch.distributed.checkpoint import flatten_state_dict

    return {k: v.detach().cpu() for k, v in
            flatten_state_dict(state).items()}


def _equal_to_npz(state, path: str) -> int:
    """Every leaf of ``state`` bitwise equal to its chunk in the
    checkpoint's npz (read directly, not through the loader); returns the
    bytes compared."""
    from paddle_tpu_torch.distributed.checkpoint import flatten_state_dict

    n = 0
    with np.load(f"{path}/0_0.npz") as npz:
        for k, v in flatten_state_dict(state).items():
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            got = t.numpy().tobytes()
            if got != npz[f"{k}#0"].tobytes():
                raise AssertionError(f"resilient: {k} differs from {path}")
            n += len(got)
    return n


def _resilient_worker() -> int:
    """One generation of the elastic run of ``run_resilient`` (d): a
    gpt3-350m-wide, 2-layer fused step under ResilientTrainLoop on the
    card, faults from ``PT_CHAOS_PLAN`` in generation 0 only. Prints
    BUILT (libraries this process had to compile), RESUMED, STEP, the
    launches of its steps, DONE."""
    import os

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.testing import chaos

    if int(os.environ.get("PADDLE_ELASTIC_RESTART", "0")):
        chaos.disarm()
    before = set(_build.BUILD_DIR.glob("*.so"))
    _build.build_all()
    built = set(_build.BUILD_DIR.glob("*.so")) - before
    print(f"BUILT {len(built)} in {_build.last_build_seconds:.2f} s",
          flush=True)
    cfg = _gpt350m(n_layers=2)
    loop = _resilient_loop(cfg, os.environ["CHAOS_CKPT_DIR"], "cuda",
                           save_every=1, keep_last_k=3, max_bad_steps=2,
                           step_timeout=120.0, retries=2)
    resumed = loop.resume()
    print(f"RESUMED step={-1 if resumed is None else resumed}", flush=True)
    batch = _train_batch(cfg)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    loss = None
    while loop.step < int(os.environ["CHAOS_TOTAL_STEPS"]):
        loss = loop.run_step(batch)
        print(f"STEP {loop.step} LOSS {loss:.6f} LAUNCHES " + json.dumps(
            {k: fn.launches for k, fn in counters.items()}), flush=True)
    print(f"DONE step={loop.step} final_loss={loss:.6f} "
          f"stats={loop.stats}", flush=True)
    return 0


def run_resilient(dev) -> dict:
    """Training's self-healing loop on the card: gpt3-350m at the train
    phase's settings (24 layers, B 16, S 1024, bf16 moments, fp32 masters,
    fusion on) under ResilientTrainLoop over the port's in-place step
    (``donated_step``), checkpoints on local disk (save_every 2, keep 2):
    (a) 6 committed steps with a ``nan`` fault at step 3, restored from
    the step-2 checkpoint bitwise and continued; (b) the step-6 save torn
    (``checkpoint.save`` torn), which the walk-back passes; (c) a new loop
    in the same process resumes at step 4, its state equal to the
    checkpoint's bytes, its next losses against the uninterrupted run's;
    (d) ``run_elastic`` over this script's worker mode (2 layers): a
    generation killed by ``train.step`` raise after a torn save,
    relaunched, resuming at step 2 without rebuilding a kernel. Returns
    the launches of K1, K2, K4, K5, K6, K7 in (a) and (c)."""
    import os
    import re
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed.fleet.elastic import run_elastic
    from paddle_tpu_torch.ops.kernels import fused_ce as ce
    from paddle_tpu_torch.testing import chaos

    cfg = _gpt350m()
    batch = _train_batch(cfg)
    _release()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilient_")
    root = os.path.join(tmp, "ckpt")
    counters = _train_counters()
    try:
        torch.cuda.reset_peak_memory_stats()
        loop = _resilient_loop(cfg, root, dev, save_every=2, keep_last_k=2,
                               max_bad_steps=3, step_timeout=120.0)
        if not loop.donated_step:
            raise AssertionError("resilient: the in-place step must run "
                                 "with donated_step")
        leaves = _leaves(loop.state)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        save_ms = []
        save = loop._save

        def timed_save():
            t0 = time.perf_counter()
            save()
            save_ms.append((time.perf_counter() - t0) * 1e3)

        loop._save = timed_save
        for fn in counters.values():
            fn.launches = 0
        ce_before = collections.Counter(ce.PRODUCTS)
        steps_run = 0
        # (a) + (b): NaN read at the third step, the third save torn
        chaos.arm(chaos.FaultPlan(seed=0).add("train.step", "nan", at=2)
                  .add("checkpoint.save", "torn", at=2))
        losses, snap2, restored = {}, None, None
        try:
            while loop.step < 6:
                before = loop.stats["rollbacks"]
                out = loop.run_step(batch)
                steps_run += 1
                if out is not None:
                    losses[loop.step] = out
                if loop.step == 2 and snap2 is None:
                    snap2 = _host_leaves(loop.state)
                if loop.stats["rollbacks"] > before:
                    restored = _host_leaves(loop.state)
        finally:
            chaos.disarm()
        if (steps_run, loop.step, loop.stats["skipped"],
                loop.stats["rollbacks"]) != (7, 6, 1, 1):
            raise AssertionError(f"resilient (a): {steps_run} steps run, "
                                 f"at {loop.step}, stats {loop.stats}")
        if snap2.keys() != restored.keys() or not all(
                torch.equal(snap2[k], restored[k]) for k in snap2):
            raise AssertionError("resilient (a): the restored state is not "
                                 "the step-2 state")
        ls = [losses[s] for s in sorted(losses)]
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"resilient (a): losses {losses}")
        d4, d6 = ck.step_dir(root, 4), ck.step_dir(root, 6)
        dirs = sorted(n for n in os.listdir(root) if n.startswith("step_"))
        if (ck.verify_checkpoint(d6)[0] or not ck.verify_checkpoint(d4)[0]
                or ck.latest_step(root) != 6
                or dirs != ["step_00000004", "step_00000006"]):
            raise AssertionError(f"resilient (b): dirs {dirs}, step 6 "
                                 f"{ck.verify_checkpoint(d6)}")
        print(f"resilient (a)+(b) gpt3-350m B16 S1024: {steps_run} steps run"
              f", {loop.step} committed, stats {loop.stats}, losses "
              f"{ {s: round(v, 5) for s, v in losses.items()} }; the "
              f"rollback restored the step-2 state bitwise; step 6's save "
              f"torn (verify: {ck.verify_checkpoint(d6)[1][:1]}); state "
              f"{nbytes} B, saves {[round(x, 1) for x in save_ms]} ms")
        del loop, leaves, snap2, restored
        _release()

        # (c) a new loop (other initial weights) resumes at step 4
        loop = _resilient_loop(cfg, root, dev, seed=1, save_every=100,
                               keep_last_k=2, step_timeout=120.0)
        t0 = time.perf_counter()
        ok, problems = ck.verify_checkpoint(d4)
        verify_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        resumed = loop.resume()
        resume_ms = (time.perf_counter() - t0) * 1e3
        if resumed != 4 or loop.step != 4 or not ok:
            raise AssertionError(f"resilient (c): resumed {resumed}")
        n_eq = _equal_to_npz(loop.state, d4)
        t0 = time.perf_counter()
        ck.load_state_dict(loop.state, d4)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        again = {s: loop.run_step(batch) for s in (5, 6)}
        steps_run += 2
        exact = {s: again[s] == losses[s] for s in (5, 6)}
        rel = {s: abs(again[s] - losses[s]) / abs(losses[s]) for s in (5, 6)}
        # step 5's loss is a forward of the same bytes: bitwise; step 6's
        # follows an update whose kernels may sum in another order
        if not exact[5] or rel[6] > 1e-3:
            raise AssertionError(f"resilient (c): losses {again} against "
                                 f"the uninterrupted {losses}")
        host = [a.numpy() if a.dtype != torch.bfloat16 else
                a.view(torch.int16).numpy()
                for a in _host_leaves(loop.state).values()]
        t0 = time.perf_counter()
        for a in host:
            ck._crc(a)
        crc_s = time.perf_counter() - t0
        del host
        # the step with and without the watchdog's guard (and the chaos
        # probe, the loss fetch); no saves in either
        guarded, bare = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.run_step(batch)
            guarded.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            loss, loop.state = loop.step_fn(loop.state, batch)
            loss.item()
            bare.append(time.perf_counter() - t0)
        steps_run += 6
        ln = {k: fn.launches for k, fn in counters.items()}
        want = _step_launches(cfg, steps_run)
        if ln != want:
            raise AssertionError(f"resilient: launches {ln} != {want}")
        _check_ce_products("resilient", ce_before, steps_run,
                           batch[0].size, cfg.hidden, cfg.vocab_size)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"resilient (c): resumed at step 4 past the torn step 6, "
              f"{n_eq} B equal to the checkpoint's npz; next losses "
              f"{again} vs uninterrupted {[losses[5], losses[6]]}: step 5 "
              f"bitwise {exact[5]}, step 6 bitwise {exact[6]} (relative "
              f"{rel[6]:.3e}, limit 1e-3)")
        print(f"resilient checkpoint ({nbytes} B on local disk): save "
              f"{min(save_ms):.1f}-{max(save_ms):.1f} ms, verify "
              f"{verify_ms:.1f} ms, resume (walk-back, verify, load) "
              f"{resume_ms:.1f} ms, load {load_ms:.1f} ms, crc32 "
              f"{nbytes / crc_s / 1e9:.3f} GB/s; step "
              f"{min(guarded) * 1e3:.2f} ms guarded (watchdog, chaos probe, "
              f"loss fetch) vs {min(bare) * 1e3:.2f} ms bare; peak memory "
              f"{peak:.2f} GiB; launches {ln} ({steps_run} steps)")
        del loop
        _release()

        # (d) an elastic generation killed and relaunched, 2 layers
        plan = chaos.FaultPlan(seed=0, name="chip")
        plan.add("checkpoint.save", "torn", at=2)   # step 3's save
        plan.add("train.step", "raise", at=3)       # the step-4 attempt
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        rc = run_elastic(
            os.path.abspath(__file__), [RESILIENT_WORKER], nprocs=1,
            max_restarts=2, log_dir=os.path.join(tmp, "logs"),
            env_extra={"PYTHONPATH": here, "CHAOS_TOTAL_STEPS": "5",
                       "CHAOS_CKPT_DIR": os.path.join(tmp, "elastic"),
                       **plan.to_env()})
        secs = time.perf_counter() - t0
        logs = []
        for g in (0, 1):
            with open(os.path.join(tmp, "logs", f"restart_{g}",
                                   "worker.0.log")) as f:
                logs.append(f.read())
        cfg2 = _gpt350m(n_layers=2)
        gens = []
        for g, text in enumerate(logs):
            steps = [int(s) for s in re.findall(r"STEP (\d+) ", text)]
            last = re.findall(r"LAUNCHES (\{.*\})", text)
            ln2 = json.loads(last[-1]) if last else {}
            if ln2 != _step_launches(cfg2, len(steps)):
                raise AssertionError(f"resilient (d) gen {g}: launches "
                                     f"{ln2} for steps {steps}")
            gens.append((steps, re.findall(r"BUILT (\d+)", text)))
        want = [([1, 2, 3], ["0"]), ([3, 4, 5], ["0"])]
        if (rc != 0 or gens != want or "RESUMED step=-1" not in logs[0]
                or "chaos: train step failure" not in logs[0]
                or "RESUMED step=2" not in logs[1]
                or "DONE step=5" not in logs[1]):
            raise AssertionError(f"resilient (d): rc {rc}, generations "
                                 f"{gens}\n{logs[0][-2000:]}\n"
                                 f"{logs[1][-2000:]}")
        print(f"resilient (d) run_elastic, gpt3-350m width at 2 layers: "
              f"generation 0 ran steps 1-3 (step 3's save torn) and died on "
              f"the injected raise; generation 1 resumed at step 2, ran "
              f"steps 3-5; no kernel rebuilt in either; {secs:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ln


# ---------------------------------------------------------------------------
# dist: the sharded entry on one card, and GPT-MoE at full width
# ---------------------------------------------------------------------------

MOE_EXPERTS, MOE_LAYERS, MOE_CAPACITY = 8, 2, 1.25


def _one_device_mesh():
    from paddle_tpu_torch.distributed.process_mesh import build_mesh

    return build_mesh((1, 1, 1), ("dp", "pp", "mp"))


def _steps(step, params, opt, toks, labs, n: int):
    """(losses, params, opt, host seconds of each step, synchronized)."""
    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, toks, labs)
        losses.append(loss.item())          # syncs
        secs.append(time.perf_counter() - t0)
    return losses, params, opt, secs


def _check_launches(tag: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")


def _is_one_device_step(step) -> bool:
    """Whether ``step`` is the step function ``make_train_step`` makes."""
    from paddle_tpu_torch.parallel.train_step import make_train_step

    return any(step.__code__ is c
               for c in make_train_step.__code__.co_consts)


def _dist_bitwise(dev, tag: str, key: str, cfg, B: int, steps: int,
                  want_fn, **kw) -> tuple[dict, float]:
    """make_sharded_train_step on the one-device mesh (bench.py's call),
    ``steps`` steps from seed 0 and phase train's batch. On a one-rank
    mesh it returns make_train_step's own step, which is checked; its
    losses are held bitwise to those make_train_step gave from the same
    seed, batch and options in phase train or train_13b
    (``ONE_DEVICE_RUNS[key]``), when that phase ran in this call. The
    run is the main path: its launches are counted (exact, per
    ``want_fn(steps)``). Returns (launches, step ms), the step time the
    mean of the steps after the first (which traces the model)."""
    from paddle_tpu_torch.parallel import make_sharded_train_step

    mesh = _one_device_mesh()
    counters = _train_counters()
    torch.cuda.reset_peak_memory_stats()
    step, params, opt = make_sharded_train_step(
        cfg, mesh, lr=1e-4, seed=0, zero1=False, device=dev, **kw)
    if step.mesh is not mesh or not _is_one_device_step(step):
        raise AssertionError(f"{tag}: the one-rank mesh's step is not "
                             "make_train_step's")
    rng = np.random.RandomState(0)
    toks = step.put_batch(rng.randint(0, cfg.vocab_size,
                                      size=(B, cfg.seq_len)))
    labs = step.put_batch(rng.randint(0, cfg.vocab_size,
                                      size=(B, cfg.seq_len)))
    for fn in counters.values():
        fn.launches = 0
    losses, params, opt, secs = _steps(step, params, opt, toks, labs, steps)
    launches = {k: fn.launches for k, fn in counters.items()}
    ms = sum(secs[1:]) / (steps - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    del step, params, opt, toks, labs
    torch.cuda.empty_cache()
    _check_launches(tag, launches, want_fn(steps))
    if not losses[-1] < losses[0] or \
            abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"{tag}: losses {losses}")
    if key in ONE_DEVICE_RUNS:
        one, one_s = ONE_DEVICE_RUNS[key]
        if losses != one[:steps]:
            raise AssertionError(f"{tag}: losses {losses} != "
                                 f"make_train_step's {one[:steps]}")
        one_ms = sum(one_s[1:steps]) / (steps - 1) * 1e3
        versus = (f"== make_train_step's losses bitwise (its run in this "
                  f"call); step {ms:.2f} ms vs its {one_ms:.2f} ms")
    else:
        versus = (f"not compared (make_train_step's run at {key} is in "
                  f"another phase); step {ms:.2f} ms")
    print(f"dist {tag}: make_sharded_train_step on the (1,1,1) mesh is "
          f"make_train_step's step; losses {[round(v, 4) for v in losses]} "
          f"{versus} (each the mean of steps 2-{steps}), peak {peak:.2f} "
          f"GiB; launches {launches}")
    return launches, ms


def _moe_inputs(params, toks, cfg) -> list:
    """Each MoE layer's input, from an unfused forward (the fused one
    replays a traced graph)."""
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.models import gpt

    seen = []
    plain = gpt.moe_block_apply

    def record(mp, x, cfg, shards=None):
        seen.append(x.detach())
        return plain(mp, x, cfg, shards)

    GLOBAL_FLAGS.set("use_auto_fusion", False)
    gpt.moe_block_apply = record
    try:
        with torch.no_grad():
            gpt.loss_fn(params, toks, toks, cfg)
    finally:
        gpt.moe_block_apply = plain
        GLOBAL_FLAGS.set("use_auto_fusion", True)
    return seen


def _route(x, mp: dict, cfg):
    """A MoE layer's routing of its input ``x`` under its weights ``mp``:
    (LayerNorm'd rows [N, H], gate, slot, capacity C, expert per token,
    tokens per expert, dropped share)."""
    from paddle_tpu_torch.models import gpt

    N, E = x.shape[0] * x.shape[1], cfg.n_experts
    C = max(1, int(cfg.moe_capacity_factor * N / E))
    flat = gpt._layer_norm(x, mp["ln_g"], mp["ln_b"], cfg.eps).reshape(
        N, cfg.hidden)
    _, onehot, gate, slot = gpt.moe_route(flat, mp["router_w"], C)
    return (flat, gate, slot, C, onehot.argmax(-1), onehot.sum(0).tolist(),
            (slot == E * C).float().mean().item())


def _moe_layer(params, j: int) -> dict:
    return {k: v[j].detach() for k, v in params["moe"].items()}


def _moe_loads(params, toks, cfg) -> tuple[list, list]:
    """Each MoE layer's (expert per token, tokens per expert, dropped
    share), from an unfused forward."""
    with torch.no_grad():
        return [_route(x, _moe_layer(params, j), cfg)[4:]
                for j, x in enumerate(_moe_inputs(params, toks, cfg))]


def _moe_layer_checks(params, toks, cfg) -> float:
    """On every MoE layer's input: the slot-index dispatch and combine
    held bitwise to the reference's dense one-hot form (each slot holds
    one token, so the one-hot products sum one nonzero term: exact in any
    order); returns the layers' forward + backward ms by CUDA events."""
    from paddle_tpu_torch.models import gpt

    xs = _moe_inputs(params, toks, cfg)
    if len(xs) != cfg.n_moe_layers:
        raise AssertionError(f"{len(xs)} MoE inputs, {cfg.n_moe_layers} "
                             "layers")
    total_ms = 0.0
    E, H = cfg.n_experts, cfg.hidden
    for j, x in enumerate(xs):
        mp = _moe_layer(params, j)
        flat, gate, slot, C = _route(x, mp, cfg)[:4]
        xin = gpt.moe_dispatch(flat, slot, E, C)
        if not torch.equal(xin, gpt.moe_dispatch_dense(flat, slot, E, C)):
            raise AssertionError(f"MoE layer {j}: dispatch != one-hot form")
        hout = torch.bmm(xin, mp["w1"].to(cfg.dtype))[..., :H].contiguous()
        if not torch.equal(gpt.moe_combine(hout, slot, gate),
                           gpt.moe_combine_dense(hout, slot, gate)):
            raise AssertionError(f"MoE layer {j}: combine != one-hot form")
        leaves = [t.requires_grad_(True) for t in mp.values()]
        xg = x.clone().requires_grad_(True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for it in range(3):                 # the last of 3 is timed
            start.record()
            y, aux = gpt.moe_block_apply(mp, xg, cfg)
            torch.autograd.grad((y.float().sum() + aux), leaves + [xg])
            end.record()
        torch.cuda.synchronize()
        total_ms += start.elapsed_time(end)
        del xin, hout, flat
    return total_ms


def _first_moe_layer_after(params, toks, cfg, dev, depth: int):
    """The first MoE layer's routing (``_moe_loads``'s row) after the
    first ``depth`` dense layers, on ``dev``: the same weights cast to
    fp32, the plain attention."""
    small = dataclasses.replace(cfg, n_layers=depth, n_moe_layers=1,
                                dtype=torch.float32,
                                param_dtype=torch.float32, use_flash=False)
    cut = {"blocks": lambda t: t[:depth], "moe": lambda t: t[:1]}
    p = {k: _map_leaves(v, lambda t, f=cut.get(k, lambda t: t):
                        f(t.detach()).to(dev, torch.float32))
         for k, v in params.items()}
    idx, loads, dropped = _moe_loads(p, toks.to(dev), small)[0]
    return idx.cpu(), loads, dropped


def _moe_cfg():
    return dataclasses.replace(_gpt350m(), n_experts=MOE_EXPERTS,
                               n_moe_layers=MOE_LAYERS,
                               moe_capacity_factor=MOE_CAPACITY)


def _moe_batch(step, cfg, B: int = 16):
    rng = np.random.RandomState(0)
    return [step.put_batch(rng.randint(0, cfg.vocab_size,
                                       size=(B, cfg.seq_len)))
            for _ in range(2)]


# the layers of a forward before the first MoE layer in the routing
# witness (the card against the CPU on the same weights)
WITNESS_DEPTH, WITNESS_ROWS = 2, 2
# fp32 on both sides, the same ops: only the order of sums differs
# (~1e-6 of a router logit), so only a near-exact tie of two experts can
# route a token differently
WITNESS_FLIPS = 1e-3


def _dist_moe(dev, dense_ms: float) -> tuple[dict, list]:
    """GPT-MoE at gpt3-350m's widths through the sharded entry on the
    one-device mesh: 8 experts in 2 MoE layers after the 24 dense ones,
    capacity factor 1.25, bf16 with fp32 masters and bf16 moments, B 16,
    S 1024 (N 16384, C 2560), fusion on, 6 steps. Then, on the weights
    after them, every MoE layer's checks (``_moe_layer_checks``) and the
    routing witness: the first MoE layer's routing after
    ``WITNESS_DEPTH`` dense layers, on the card (B 16) and on the CPU
    (its first ``WITNESS_ROWS`` rows), in fp32 from the same weights.
    Returns (its launches, its losses)."""
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.parallel import make_sharded_train_step

    cfg = _moe_cfg()
    B, steps = 16, 6
    torch.cuda.reset_peak_memory_stats()
    step, params, opt = make_sharded_train_step(
        cfg, _one_device_mesh(), lr=1e-4, seed=0, zero1=False,
        m_dtype="bfloat16", v_dtype="bfloat16", device=dev)
    toks, labs = _moe_batch(step, cfg, B)
    init = _moe_loads(params, toks, cfg)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, params, opt, secs = _steps(step, params, opt, toks, labs, steps)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = compiler.last_report()
    L, M = cfg.n_layers, cfg.n_moe_layers
    want = _step_launches(cfg, steps)
    want["fused_norm_epilogue"] = (2 * L + M + 1) * steps
    _check_launches("dist moe", launches, want)
    counts = _template_counts(report)
    want_sites = {("layer_epilogue", True): 2 * L + M + 1,
                  ("bias_gelu", True): L}
    if counts != want_sites or report.errors:
        raise AssertionError(f"dist moe fusion report {counts} (errors "
                             f"{report.errors}) != {want_sites}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dist moe: non-finite loss in {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"dist moe: first loss {losses[0]} not within "
                             f"0.5 of ln(V) {math.log(cfg.vocab_size):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"dist moe: loss did not fall: {losses}")
    step_ms = sum(secs[1:]) / (steps - 1) * 1e3
    moe_ms = _moe_layer_checks(params, toks, cfg)
    after = _moe_loads(params, toks, cfg)
    N = B * cfg.seq_len
    print(f"dist moe gpt3-350m widths, {MOE_EXPERTS} experts x {M} MoE "
          f"layers, capacity {MOE_CAPACITY} (N {N}, C "
          f"{int(MOE_CAPACITY * N / MOE_EXPERTS)}), B{B} S{cfg.seq_len}, "
          f"bf16 + fp32 masters, fusion on: losses "
          f"{[round(v, 4) for v in losses]}; step {step_ms:.2f} ms vs the "
          f"dense step {dense_ms:.2f} ms (each the mean of the steps "
          f"after the first); MoE layers' forward + backward "
          f"{moe_ms:.2f} ms by CUDA events ({moe_ms / step_ms:.3f} of the "
          f"step); tokens routed to each expert by layer on the initial "
          f"weights {[r[1] for r in init]} (dropped "
          f"{[round(r[2], 4) for r in init]}), after step {steps} "
          f"{[r[1] for r in after]} (dropped "
          f"{[round(r[2], 4) for r in after]}); dispatch and combine of "
          f"every MoE layer bitwise the one-hot form; peak mem {peak:.2f} "
          f"GiB; fusion {counts}; launches {launches}")
    card, card_loads, card_drop = _first_moe_layer_after(
        params, toks, cfg, dev, WITNESS_DEPTH)
    rows = WITNESS_ROWS * cfg.seq_len
    cpu, cpu_loads, _ = _first_moe_layer_after(
        params, toks[:WITNESS_ROWS], cfg, "cpu", WITNESS_DEPTH)
    flips = (card[:rows] != cpu).float().mean().item()
    if not flips <= WITNESS_FLIPS:
        raise AssertionError(f"dist moe witness: {flips} of the tokens "
                             "route to another expert on the CPU")
    print(f"dist moe routing witness ({WITNESS_DEPTH} dense layers, then "
          f"MoE layer 1, the weights after step {steps} in fp32): card "
          f"B{B} loads {card_loads}, dropped {card_drop:.4f}; card vs CPU "
          f"on the first {WITNESS_ROWS} rows: loads "
          f"{torch.bincount(card[:rows], minlength=MOE_EXPERTS).tolist()} "
          f"vs {cpu_loads}, {flips:.5f} of the tokens route differently "
          f"(bar {WITNESS_FLIPS})")
    del step, params, opt, toks, labs
    torch.cuda.empty_cache()
    return launches, losses


def _check_ce_vocab_slabs(dev) -> None:
    """K4 and K5 on the two vocab slabs of the gpt3-350m head, as the
    sharded step runs them over mp 2 (``gpt._VocabParallelCE``): each
    slab with its own labels (-1, no gold, outside it), held to
    the plain versions; the slabs' log-sum-exps and gold combined, held
    to K4 on the whole head; K5 on each slab with the combined
    log-sum-exp held to the plain version, and the slabs' dx summed held
    to K5's on the whole head."""
    from paddle_tpu_torch.models.gpt import _slab_labels
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    gen = torch.Generator(device=dev).manual_seed(16)
    N, H, V, n = 4096, 1024, 50304, 2
    x = torch.randn((N, H), generator=gen, device=dev).to(torch.bfloat16)
    wte = (torch.randn((V, H), generator=gen, device=dev)
           * (CE_LOGIT_STD / math.sqrt(H))).to(torch.bfloat16)
    lab = torch.randint(0, V, (N,), generator=gen, device=dev)
    g = torch.full((N,), 1.0 / N, device=dev)
    v = V // n
    # v 25152 ends inside a vocab tile: the tile's masked columns are
    # above v, which a slab label never reaches
    slabs = [(wte[r * v:(r + 1) * v].t(), _slab_labels(lab, r, v))
             for r in range(n)]
    lses, golds = [], []
    for r, (head, sl) in enumerate(slabs):
        nll, lse = ce.fused_ce_fwd(x, head, sl)
        rnll, rlse = ce.fused_ce_fwd_plain(x, head, sl)
        err = max((nll - rnll).abs().max().item(),
                  (lse - rlse).abs().max().item())
        if not err <= CE_FWD_ATOL:
            raise AssertionError(f"ce slab {r}: nll / lse max_abs_err {err}")
        lses.append(lse)
        golds.append(torch.where(sl >= 0, lse - nll, 0.0))
    full_nll, full_lse = ce.fused_ce_fwd(x, wte.t(), lab)
    lse_all = torch.logsumexp(torch.stack(lses), 0)
    err = max((lse_all - full_lse).abs().max().item(),
              (lse_all - sum(golds) - full_nll).abs().max().item())
    if not err <= CE_FWD_ATOL:
        raise AssertionError(f"ce slabs combined: max_abs_err {err}")
    dxs = []
    for r, (head, sl) in enumerate(slabs):
        dx, dh = ce.fused_ce_bwd(x, head, sl, lse_all, g)
        rdx, rdh = ce.fused_ce_bwd_plain(x, head, sl, lse_all, g)
        _hold(f"ce slab {r} dx", dx, rdx, BF16_TOL)
        _hold(f"ce slab {r} dhead", dh, rdh, BF16_TOL, dim=0)
        dxs.append(dx.float())
    _hold("ce slabs' dx summed", sum(dxs),
          ce.fused_ce_bwd(x, wte.t(), lab, full_lse, g)[0], BF16_TOL)
    print(f"dist: K4/K5 on {n} vocab slabs of [{N}, {H}] x {V} with the "
          f"slabs' labels, combined: nll / lse within {err:.3e} of K4 on "
          f"the whole head (atol {CE_FWD_ATOL})")
    torch.cuda.empty_cache()


# the sharded step's own forward (K6 and K7 placed by hand, the LayerNorm
# folds of the compiler's plan not all taken) against make_train_step's
# losses on the same weights, bf16: the bar of phase train's head-major
# check (its first loss within 1e-3)
SHARDED_FWD_RTOL = 1e-3


def _dist_sharded_class(dev, moe_losses: list) -> dict:
    """The sharded step's class on the one-rank mesh, where every
    collective is the identity (``make_sharded_train_step`` returns
    ``make_train_step`` there, so this is the one way to run the code of
    the multi-rank step on one card): (b)'s config, weights and batch, 3
    steps. The launches are exact (K6 at the 2L + M + 1 LayerNorms and K7
    at the L gelus of ``sharded_loss_fn``, K1/K2, K4/K5) and the losses
    within ``SHARDED_FWD_RTOL`` of (b)'s. Returns its launches."""
    from paddle_tpu_torch.parallel import make_sharded_train_step
    from paddle_tpu_torch.parallel.train_step import _ShardedStep

    cfg = _moe_cfg()
    steps = 3
    one, params, opt = make_sharded_train_step(
        cfg, _one_device_mesh(), lr=1e-4, seed=0, zero1=False,
        m_dtype="bfloat16", v_dtype="bfloat16", device=dev)
    toks, labs = _moe_batch(one, cfg)
    step = _ShardedStep(cfg, _one_device_mesh(), 1e-4, False,
                        torch.device(dev), 0)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, params, opt, secs = _steps(step, params, opt, toks, labs, steps)
    launches = {k: fn.launches for k, fn in counters.items()}
    L, M = cfg.n_layers, cfg.n_moe_layers
    want = _step_launches(cfg, steps)
    want["fused_norm_epilogue"] = (2 * L + M + 1) * steps
    _check_launches("dist sharded step class", launches, want)
    if not np.allclose(losses, moe_losses[:steps], rtol=SHARDED_FWD_RTOL,
                       atol=0):
        raise AssertionError(f"dist sharded step class: losses {losses} vs "
                             f"the one-device step's {moe_losses[:steps]}")
    ms = sum(secs[1:]) / (steps - 1) * 1e3
    print(f"dist sharded step class on the (1,1,1) mesh, (b)'s GPT-MoE: "
          f"losses {[round(v, 5) for v in losses]} vs the one-device "
          f"step's {[round(v, 5) for v in moe_losses[:steps]]} (rtol "
          f"{SHARDED_FWD_RTOL}); step {ms:.2f} ms (mean of steps "
          f"2-{steps}); launches {launches}")
    del step, one, params, opt, toks, labs
    torch.cuda.empty_cache()
    return launches


def _dist_cpu_case(dev) -> dict:
    """A small fp32 GPT-MoE (H 256, 4 heads of 64, 2 dense layers, 4
    experts in 1 MoE layer, S 256, B 2) through the sharded entry on the
    one-device mesh, 3 steps on the card and on the CPU from identical
    weights, fusion on: losses within TRAIN_CPU_RTOL, parameters within
    TRAIN_CPU_ATOL; every training kernel launched on the card."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.parallel import make_sharded_train_step
    from paddle_tpu_torch.parallel.train_step import adamw_init

    cfg = GPTConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=4,
                    seq_len=256, n_experts=4, n_moe_layers=1,
                    dtype=torch.float32, param_dtype=torch.float32,
                    remat=False)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(11), "cpu")
    rng = np.random.RandomState(12)
    toks = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    labs = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        step, _, _ = make_sharded_train_step(cfg, _one_device_mesh(),
                                             lr=1e-4, device=device)
        params = _map_leaves(cpu_params, lambda t: t.clone().to(device))
        opt = adamw_init(params)
        losses = []
        for _ in range(3):
            loss, params, opt = step(params, opt, toks, labs)
            losses.append(loss.item())
        runs[name] = (losses, _leaves(params))
    launches = {k: fn.launches for k, fn in counters.items()}
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    if not np.allclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"dist cpu/cuda: losses {lg} vs {lc}")
    worst = max((a.detach() - b.detach().cpu()).abs().max().item()
                for a, b in zip(pc, pg))
    if not worst <= TRAIN_CPU_ATOL:
        raise AssertionError(f"dist cpu/cuda: params differ by {worst}")
    if not all(launches.values()):
        raise AssertionError(f"dist cpu/cuda: a kernel did not run on the "
                             f"card: {launches}")
    print(f"dist cpu/cuda (small fp32 GPT-MoE, sharded entry, fusion on): "
          f"losses {lg} vs {lc}, params max diff {worst:.3e}, card "
          f"launches {launches}")
    return launches


def run_dist(dev) -> dict:
    """(a) bench.py's sharded call on one card at gpt3-350m (bf16, fp32
    masters, bf16 moments, zero1 off; B 16, S 1024, 3 steps) and (a2) at
    gpt3-1.3b (sr-bf16, bf16 moments, unroll, remat; B 1, S 4096, 2
    steps): make_train_step's own step, its losses bitwise those of
    phases train and train_13b where they ran in this call; (b) GPT-MoE
    at gpt3-350m's widths, with its routing witness; (d) the sharded
    step's class on the one-rank mesh at (b)'s config; K4/K5 on vocab
    slabs as the mp route runs them; (c) a small fp32 GPT-MoE through
    the sharded entry, card against CPU. Returns the
    main path's launches, (a) + (a2) + (b) + (d)."""
    from paddle_tpu_torch.models.gpt import gpt_presets
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    total = collections.Counter()
    cfg = _gpt350m()
    ln, dense_ms = _dist_bitwise(
        dev, "(a) gpt3-350m B16 S1024", "gpt3-350m", cfg, 16, 3,
        lambda n: _step_launches(cfg, n), m_dtype="bfloat16",
        v_dtype="bfloat16")
    total.update(ln)
    big = dataclasses.replace(gpt_presets("gpt3-1.3b"), seq_len=4096,
                              unroll=True, remat=True)
    if not fa.fused_dqkv_ok(4096, big.head_dim, 2):
        raise AssertionError("gpt3-1.3b at S 4096 should take K2")

    def want_13b(n):
        L = big.n_layers
        slabs = -(-big.vocab_size // ce.SLAB)
        # remat=True: K6 and K7 run again in every block's recompute
        return {"flash_fwd": L * n, "flash_bwd": L * n,
                "fused_ce_fwd": 2 * n, "fused_ce_bwd": 3 * slabs * n,
                "fused_norm_epilogue": (4 * L + 1) * n,
                "fused_bias_act": 2 * L * n}

    ln, _ = _dist_bitwise(dev, "(a2) gpt3-1.3b sr-bf16 B1 S4096",
                          "gpt3-1.3b S4096", big, 1, 2, want_13b,
                          m_dtype="bfloat16", v_dtype="bfloat16",
                          weights="sr-bf16")
    total.update(ln)
    ln, moe_losses = _dist_moe(dev, dense_ms)
    total.update(ln)
    total.update(_dist_sharded_class(dev, moe_losses))
    _check_ce_vocab_slabs(dev)
    _dist_cpu_case(dev)
    return dict(total)


# -- phase pipe: the pipeline and ring attention over gloo ranks ------------

PIPE_WORKER = "--pipe-worker"
PIPE_M, PIPE_STEPS = 4, 3            # microbatches, steps of each schedule
PIPE_RING = (1, 8192, 16, 64)        # ring attention's q, k, v [B, S, H, D]
PIPE_SEP = (16, 1024, 16, 64)        # (c)'s attention q, k, v [B, S, h, d]
# scaled, against the function in fp64 on the same inputs
# (``_attention_f64``) and, fp32, against cp 1 too. fp32 is FP32_TOL, sum
# order only: at S 8192 dk sums up to 8192 terms of both signs, and cp
# 1's own fp32 dk lies 6.1e-5 scaled from fp64 on an H100. bf16 is
# BF16_TOL, held to fp64 alone: cp 1's backward (autograd through the
# probabilities' cast to bf16) rounds dp to bf16 before dp - delta
# cancels (its dk 4.1e-2 from the ring's, which keeps dp in fp32); the
# ring rounds its probabilities a hop at a time (against each hop's own
# maximum), so its delta differs from fp64's by bf16 rounding, which
# dp - delta cancels against: dq 2.004e-2 scaled there
PIPE_RING_TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}
PIPE_LOSS_RTOL = 1e-3                # bf16 step's first loss vs the one-device
PIPE_SMALL_M = 2


def _pipe_small_cfg():
    """The small fp32 GPT of the pipe phase's card-vs-one-device case."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=4,
                     seq_len=256, dtype=torch.float32,
                     param_dtype=torch.float32, remat=False)


def _pipe_want(cfg, stage: int, n_stages: int, M: int, steps: int) -> dict:
    """Launches of one rank's ``steps`` pipelined steps. Each stage runs
    its Ls = L / S blocks once a microbatch without saving anything and
    once more in the backward's replay, whose backward follows: K1 2 Ls M,
    K2 Ls M, K6 two a block a run (4 Ls M), K7 one (2 Ls M); the last
    stage's tail runs once a microbatch: K6 at the final LayerNorm, K4
    (two launches a call) and K5 (3 a vocab slab a call)."""
    from paddle_tpu_torch.ops.kernels import fused_ce as ce

    Ls = cfg.n_layers // n_stages
    last = stage == n_stages - 1
    slabs = -(-cfg.vocab_size // ce.SLAB)
    return {"flash_fwd": 2 * Ls * M * steps, "flash_bwd": Ls * M * steps,
            "fused_norm_epilogue": (4 * Ls * M + (M if last else 0)) * steps,
            "fused_bias_act": 2 * Ls * M * steps,
            "fused_ce_fwd": (2 * M if last else 0) * steps,
            "fused_ce_bwd": (3 * slabs * M if last else 0) * steps}


def _pipe_ring_inputs(dev, dtype):
    """The ring case's q, k, v and output cotangent, drawn on the card
    from one seed (the same on every rank and in the parent)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    return [torch.randn(PIPE_RING, generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def _time_parts() -> dict:
    """Wrap the sharded step's two parts, the forward + backward
    (``_pipeline_grads``) and the gradient sync + AdamW (``update``), and
    in the latter each leaf's gradient sync (``_sync``) and moment
    writes (``_store``), with synchronized host timers: {part: [ms a
    call]}."""
    from paddle_tpu_torch.parallel import train_step as ts

    parts: dict = collections.defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    for name in ("_pipeline_grads", "update", "_sync", "_store"):
        setattr(ts._ShardedStep, name,
                timed(name, getattr(ts._ShardedStep, name)))
    return parts


def _pipe_worker(root: str) -> int:
    """One of the pipe phase's two gloo ranks sharing the card: (a) the
    pipelined gpt3-350m step, "1f1b" then "gpipe", and the small fp32
    case; (b) ring attention over the sep axis. Writes
    ``root/rank<r>.json`` and the tensors the parent checks."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.autograd_collectives import ppermute
    from paddle_tpu_torch.distributed.launch import init_from_env
    from paddle_tpu_torch.distributed.process_mesh import build_mesh
    from paddle_tpu_torch.distributed.sharding import gather_tree
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import (make_sharded_train_step,
                                           ring_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_from_env(device="cuda", backend="gloo"):
        raise RuntimeError("pipe worker: no launcher environment")
    rank = dist.get_rank()
    dev = torch.device("cuda")
    out = {"rank": rank}
    parts = _time_parts()
    cfg = _gpt350m()
    toks, labs = _train_batch(cfg)
    counters = _train_counters()
    for sched in ("1f1b", "gpipe"):
        mesh = build_mesh((1, 2, 1), ("dp", "pp", "mp"))
        torch.cuda.reset_peak_memory_stats()
        step, params, opt = make_sharded_train_step(
            cfg, mesh, lr=1e-4, seed=0, n_microbatches=PIPE_M,
            m_dtype="bfloat16", v_dtype="bfloat16", device=dev)
        step.pipe.schedule = sched
        for fn in counters.values():
            fn.launches = 0
        flash = ("flash_fwd", "flash_bwd")
        wgmma = {k: counters[k].launches_wgmma for k in flash}
        staged = ppermute.staged_bytes
        parts.clear()
        losses, params, opt, secs = _steps(step, params, opt, toks, labs,
                                           PIPE_STEPS)
        out[sched] = {
            "parts_ms": {k: sum(v[len(v) // PIPE_STEPS:]) / (PIPE_STEPS - 1)
                         for k, v in parts.items()},
            "losses": losses,
            "launches": {k: fn.launches for k, fn in counters.items()},
            "wgmma": {k: counters[k].launches_wgmma - wgmma[k]
                      for k in flash},
            "ms": sum(secs[1:]) / (PIPE_STEPS - 1) * 1e3,
            "staged_bytes_per_step":
                (ppermute.staged_bytes - staged) / PIPE_STEPS,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_stash": step.pipe.peak_stash,
            "stage": step.pipe.stage}
        del step, params, opt
        torch.cuda.empty_cache()
    out["flash_by_plan"] = [[list(k), n]
                            for k, n in fa.LAUNCHES_BY_PLAN.items()]
    # what one all-reduce of wte's fp32 gradient costs over gloo, from the
    # card and from the host
    for where in ("cuda", "cpu"):
        g = torch.ones((cfg.vocab_size, cfg.hidden), device=where)
        dist.all_reduce(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(g)
        torch.cuda.synchronize()
        out[f"allreduce_{where}_ms"] = (time.perf_counter() - t0) * 1e3
        del g
    small = _pipe_small_cfg()
    step, params, opt = make_sharded_train_step(
        small, build_mesh((1, 2, 1), ("dp", "pp", "mp")), lr=1e-4, seed=11,
        n_microbatches=PIPE_SMALL_M, device=dev)
    st, sl = _train_batch(small, 4)
    out["small_losses"] = _steps(step, params, opt, st, sl, 3)[0]
    whole = gather_tree(params, step.mesh)
    if rank == 0:
        torch.save(_map_leaves(whole, lambda t: t.detach().cpu()),
                   os.path.join(root, "small_params.pt"))
    del step, params, opt, whole
    mesh = build_mesh((2,), ("sep",))
    n = PIPE_RING[1] // 2
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t[:, rank * n:(rank + 1) * n].contiguous()
                       for t in _pipe_ring_inputs(dev, dt))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        for _ in range(2):                   # the second is timed
            start.record()
            o = ring_attention(q, k, v, mesh, axis="sep", causal=True)
            grads = torch.autograd.grad(o, (q, k, v), do)
            end.record()
        torch.cuda.synchronize()
        name = str(dt).split(".")[-1]
        out[f"ring_{name}_ms"] = start.elapsed_time(end)
        torch.save({"o": o.detach().cpu(), "dq": grads[0].cpu(),
                    "dk": grads[1].cpu(), "dv": grads[2].cpu()},
                   os.path.join(root, f"ring_{name}.r{rank}.pt"))
        del q, k, v, do, o, grads
        torch.cuda.empty_cache()
    out["ring_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _hold_dq(name: str, got, ref, rows: slice, tol: float) -> float:
    """A rank's chunk ``rows`` of the ring's dq [B, S, H, D] against the
    whole reference's: every query row but the sequence's first by
    ``_hold``; that row is 0 in exact arithmetic (causal: it attends to
    key 0 alone, so ds = dp - delta with o = v_0), rounding noise on
    both sides, held in absolute value to the ZERO_ROW floor of the
    tensor's RMS (as ``_hold_long_dqkv`` holds K2's)."""
    part = ref[:, rows]
    if rows.start:
        return _hold(name, got, part, tol)
    err = _hold(name + " rows 1..", got[:, 1:], part[:, 1:], tol)
    floor = ZERO_ROW * ref.float().pow(2).mean().sqrt().item()
    row0 = max(got[:, 0].float().abs().max().item(),
               part[:, 0].float().abs().max().item())
    print(f"{name} row 0: max |value| {row0:.3e} (floor {floor:.3e})")
    if not row0 <= floor:
        raise AssertionError(f"{name}: row 0 reaches {row0} > {floor}")
    return max(err, (got[:, 0].float() - part[:, 0].float()).abs()
               .max().item())


def _attention_f64(q, k, v, do) -> dict:
    """Causal attention [B, S, H, D] and its gradients in fp64, a head at
    a time, on the host: the function the block attention computes (the
    probabilities rounded to v's dtype before the value product, as the
    reference's ``_block_attn``), differentiated exactly (that rounding
    passes the gradient through)."""
    out = {n: [] for n in ("o", "dq", "dk", "dv")}
    S, D = q.shape[1], q.shape[-1]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    for h in range(q.shape[2]):
        qh, kh, vh = (t[:, :, h].double().requires_grad_(True)
                      for t in (q, k, v))
        s = torch.einsum("bqd,bkd->bqk", qh, kh) / math.sqrt(D)
        p = torch.softmax(torch.where(mask, s, -math.inf), dim=-1)
        p = p + (p.to(v.dtype).double() - p).detach()
        o = torch.einsum("bqk,bkd->bqd", p, vh)
        grads = torch.autograd.grad(o, (qh, kh, vh), do[:, :, h].double())
        for name, t in zip(out, (o.detach(),) + grads):
            out[name].append(t.cpu())
        del s, p, o, grads
    return {n: torch.stack(ts, dim=2) for n, ts in out.items()}


def _scaled_errs(got: dict, ref: dict, rows: slice) -> str:
    """The scaled errors of a ring result's four tensors, ``got`` holding
    the sequence's ``rows``, against ``ref``'s, the sequence's first
    query row left out (dq's is 0 in exact arithmetic: ``_hold_dq``)."""
    skip = 1 if rows.start == 0 else 0
    errs = (_scaled_err(got[key][:, skip:], ref[key][:, rows][:, skip:])[1]
            for key in ("o", "dq", "dk", "dv"))
    return ", ".join(f"{key} {e:.3e} scaled"
                     for key, e in zip(("o", "dq", "dk", "dv"), errs))


def _pipe_ring_reference(dev) -> dict:
    """ring_attention at cp 1 (the plain block attention) on the whole
    sequence and its gradients, by dtype, on the host; and, under
    "float64 of <dtype>", the function in fp64 on that dtype's inputs."""
    from paddle_tpu_torch.distributed.process_mesh import build_mesh
    from paddle_tpu_torch.parallel import ring_attention

    mesh = build_mesh((1,), ("sep",))
    refs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = _pipe_ring_inputs(dev, dt)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        o = ring_attention(q, k, v, mesh, axis="sep", causal=True)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        refs[str(dt).split(".")[-1]] = {
            "o": o.detach().cpu(), "dq": dq.cpu(), "dk": dk.cpu(),
            "dv": dv.cpu()}
        del q, k, v, do, o, dq, dk, dv
        torch.cuda.empty_cache()
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        refs[f"float64 of {name}"] = _attention_f64(
            *_pipe_ring_inputs(dev, dt))
        torch.cuda.empty_cache()
    return refs


def _pipe_one_device(dev, cfg, steps: int, seed: int = 0, batch: int = 16,
                     **kw):
    """make_train_step's losses and parameters on the card from ``seed``
    (the pipelined step's weights: both draw them on the card from one
    generator)."""
    from paddle_tpu_torch.parallel.train_step import make_train_step

    step, params, opt = make_train_step(cfg, lr=1e-4, seed=seed, device=dev,
                                        **kw)
    toks, labs = _train_batch(cfg, batch)
    losses, params, opt, _ = _steps(step, params, opt, toks, labs, steps)
    return losses, params


def _hold_sep_kernels(dev) -> float:
    """K1-sep and K3-sep at (c)'s attention shape, PIPE_SEP bf16 causal,
    on random inputs: against their plain versions, o and dq, dk, dv at
    BF16_TOL (dq's first row to the zero-row floor: ``_hold_long_dqkv``),
    lse at FP32_TOL; and bit-equal to K1 and to K3's fused-qkv mode on
    the same values packed into one qkv (one body, other strides).
    Returns the worst max_abs_err."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S, h, d = PIPE_SEP
    scale = d ** -0.5
    tag = f"pipe (c) bf16 {list(PIPE_SEP)}"
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn(PIPE_SEP, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_sep(q, k, v, True, scale)
    o_ref, lse_ref = fa.flash_sep_plain(q, k, v, True, scale)
    err = max(_hold(tag + " K1-sep o", o, o_ref, BF16_TOL),
              _hold(tag + " K1-sep lse", lse, lse_ref, FP32_TOL))
    del o_ref, lse_ref
    sep = fa.flash_bwd_sep(q, k, v, o, lse, do, True, scale)
    ref = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, True, scale)
    err = max(err, _hold_long_dqkv(tag + " K3-sep", torch.stack(sep, 2),
                                   torch.stack(ref, 2)))
    del ref
    torch.cuda.empty_cache()
    qkv = torch.cat([t.reshape(B, S, h * d) for t in (q, k, v)], -1)
    o_f, lse_f = fa.flash_fwd(qkv, h, True, scale)
    if not (torch.equal(o, o_f) and torch.equal(lse, lse_f)):
        raise AssertionError(tag + ": K1-sep != K1 on the packed qkv")
    fused = fa.flash_bwd_split(qkv, o, lse, do, h, True, scale)
    if not torch.equal(fused, torch.cat([t.reshape(B, S, h * d)
                                         for t in sep], -1)):
        raise AssertionError(tag + ": K3-sep != K3's fused mode on the "
                             "packed qkv")
    print(f"{tag}: K1-sep == K1 and K3-sep == K3 fused on the packed qkv, "
          "bitwise")
    del q, k, v, do, o, lse, sep, qkv, o_f, lse_f, fused
    torch.cuda.empty_cache()
    return err


def _pipe_ring_axis(dev, one: list) -> dict:
    """(c) ``ring_axis="mp"`` on the one-device mesh through the sharded
    entry: gpt3-350m, B 16, S 1024, 3 steps; no axis to ring over, so
    attention takes the split q, k, v: K1-sep L and K3-sep 2L (dq, then
    dk / dv) a step, no K1 or K2, both held first at that shape
    (``_hold_sep_kernels``); each loss within PIPE_LOSS_RTOL of the
    fused-qkv step's ``one`` (make_train_step's 3 losses from the same
    seed). Returns its launches."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import make_sharded_train_step

    err = _hold_sep_kernels(dev)
    cfg = dataclasses.replace(_gpt350m(), ring_axis="mp")
    steps, L = 3, cfg.n_layers
    step, params, opt = make_sharded_train_step(
        cfg, _one_device_mesh(), lr=1e-4, seed=0, m_dtype="bfloat16",
        v_dtype="bfloat16", device=dev)
    toks, labs = (step.put_batch(a) for a in _train_batch(cfg))
    counters = {**_train_counters(), "flash_fwd_sep": fa.flash_fwd_sep,
                "flash_bwd_sep": fa.flash_bwd_sep}
    for fn in counters.values():
        fn.launches = 0
    losses, params, opt, secs = _steps(step, params, opt, toks, labs, steps)
    launches = {k: fn.launches for k, fn in counters.items()}
    want = dict(_step_launches(cfg, steps), flash_fwd=0, flash_bwd=0,
                flash_fwd_sep=L * steps, flash_bwd_sep=2 * L * steps)
    _check_launches("pipe (c) ring_axis one device", launches, want)
    if not np.allclose(losses, one[:steps], rtol=PIPE_LOSS_RTOL, atol=0):
        raise AssertionError(f"pipe (c): losses {losses} vs the fused-qkv "
                             f"step's {one[:steps]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"pipe (c): loss did not fall: {losses}")
    print(f"pipe (c) ring_axis='mp' on the (1,1,1) mesh, gpt3-350m B16 "
          f"S1024: losses {[round(v, 5) for v in losses]} vs the fused-qkv "
          f"step's {[round(v, 5) for v in one[:steps]]} (rtol "
          f"{PIPE_LOSS_RTOL}; largest difference "
          f"{max(abs(a - b) for a, b in zip(losses, one)):.3e}); step "
          f"{sum(secs[1:]) / (steps - 1) * 1e3:.2f} ms (mean of steps "
          f"2-{steps}); launches {launches}; K1-sep / K3-sep at this shape "
          f"max_abs_err {err:.3e}")
    del step, params, opt, toks, labs
    torch.cuda.empty_cache()
    return launches


def run_pipe(dev) -> dict:
    """(a) the pipelined gpt3-350m step (24 layers, 12 a stage; bf16,
    fp32 masters, bf16 moments; B 16, S 1024, M 4) on two gloo ranks that
    share the card (NCCL refuses two ranks on one device), 3 steps of
    "1f1b" and 3 of "gpipe": the first loss within PIPE_LOSS_RTOL of
    make_train_step's from the same seed, the losses falling, each rank's
    launches exact (``_pipe_want``), every bf16 flash launch through
    wgmma; a small fp32 GPT pipelined against make_train_step on the card
    within TRAIN_CPU_RTOL / TRAIN_CPU_ATOL; (b) ring attention over sep =
    2 at PIPE_RING, bf16 and fp32, forward and gradients against the
    function in fp64 (fp32 also against the plain block attention, cp 1)
    within PIPE_RING_TOL scaled; (c)
    ``_pipe_ring_axis``. Times, staged bytes and peak memory are those of
    2 ranks sharing one H100, not a pp = 2 speed. Returns the main path's
    launches: both ranks' (a) and (c)'s."""
    import os
    import tempfile

    from paddle_tpu_torch.distributed.launch import launch_procs
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = _gpt350m()
    if "gpt3-350m" in ONE_DEVICE_RUNS:
        one = ONE_DEVICE_RUNS["gpt3-350m"][0][:PIPE_STEPS]
        origin = "phase train's run"
    else:
        one = _pipe_one_device(dev, cfg, PIPE_STEPS, m_dtype="bfloat16",
                               v_dtype="bfloat16")[0]
        origin = "make_train_step's steps here"
        torch.cuda.empty_cache()
    loss0 = one[0]
    small = _pipe_small_cfg()
    s_losses, s_params = _pipe_one_device(dev, small, 3, seed=11, batch=4)
    s_params = _map_leaves(s_params, lambda t: t.detach().cpu())
    refs = _pipe_ring_reference(dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    t0 = time.perf_counter()
    rc = launch_procs(os.path.abspath(__file__), [PIPE_WORKER, root], 2,
                      log_dir=os.path.join(root, "logs"), timeout=400)
    wall = time.perf_counter() - t0
    if rc != 0:
        for name in sorted(os.listdir(os.path.join(root, "logs"))):
            print(open(os.path.join(root, "logs", name)).read()[-3000:])
        raise AssertionError(f"pipe: a rank exited {rc}")
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(2)]
    total = collections.Counter()
    for r, got in enumerate(ranks):
        for sched in ("1f1b", "gpipe"):
            run = got[sched]
            want = _pipe_want(cfg, run["stage"], 2, PIPE_M, PIPE_STEPS)
            _check_launches(f"pipe (a) rank {r} {sched}", run["launches"],
                            want)
            if run["wgmma"] != {k: want[k] for k in ("flash_fwd",
                                                      "flash_bwd")}:
                raise AssertionError(f"pipe (a) rank {r} {sched}: wgmma "
                                     f"flash launches {run['wgmma']}")
            total.update(run["launches"])
            losses = run["losses"]
            if not abs(losses[0] - loss0) <= PIPE_LOSS_RTOL * abs(loss0):
                raise AssertionError(f"pipe (a) {sched}: first loss "
                                     f"{losses[0]} vs make_train_step's "
                                     f"{loss0}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"pipe (a) {sched}: losses {losses}")
        fa.LAUNCHES_BY_PLAN.update({tuple(k): n
                                    for k, n in got["flash_by_plan"]})
        if ranks[0]["1f1b"]["losses"] != got["1f1b"]["losses"]:
            raise AssertionError("pipe (a): the ranks report other losses")
        if not np.allclose(got["small_losses"], s_losses,
                           rtol=TRAIN_CPU_RTOL, atol=0):
            raise AssertionError(f"pipe (a) small fp32: losses "
                                 f"{got['small_losses']} vs {s_losses}")
    pp_params = torch.load(os.path.join(root, "small_params.pt"))
    worst = max((a - b).abs().max().item() for a, b in
                zip(_leaves(pp_params), _leaves(s_params)))
    if not worst <= TRAIN_CPU_ATOL:
        raise AssertionError(f"pipe (a) small fp32: params differ by "
                             f"{worst}")
    for sched in ("1f1b", "gpipe"):
        print(f"pipe (a) gpt3-350m pp 2 (12 layers a stage) M {PIPE_M} "
              f"B16 S1024 {sched}, 2 ranks sharing one H100 over gloo: "
              f"losses {[round(v, 5) for v in ranks[0][sched]['losses']]} "
              f"(first vs make_train_step's {loss0:.5f} from {origin}, "
              f"rtol {PIPE_LOSS_RTOL}); step "
              + ", ".join(f"rank {r} {g[sched]['ms']:.1f} ms"
                          for r, g in enumerate(ranks))
              + " (mean of steps 2-3; of it forward + backward "
              + ", ".join(f"{g[sched]['parts_ms']['_pipeline_grads']:.1f}"
                          for g in ranks)
              + " ms, gradient sync + AdamW "
              + ", ".join(f"{g[sched]['parts_ms']['update']:.1f}"
                          for g in ranks)
              + " ms, of that the gradient sync "
              + ", ".join(f"{g[sched]['parts_ms']['_sync']:.1f}"
                          for g in ranks)
              + " ms and the moment writes "
              + ", ".join(f"{g[sched]['parts_ms']['_store']:.1f}"
                          for g in ranks)
              + " ms); staged bytes a step "
              + ", ".join(f"rank {r} {g[sched]['staged_bytes_per_step']:.0f}"
                          for r, g in enumerate(ranks))
              + "; peak mem "
              + ", ".join(f"rank {r} {g[sched]['peak_gib']:.2f} GiB"
                          for r, g in enumerate(ranks))
              + "; peak stash "
              + ", ".join(f"rank {r} {g[sched]['peak_stash']}"
                          for r, g in enumerate(ranks))
              + "; launches a rank "
              + "; ".join(f"rank {r} {g[sched]['launches']}"
                          for r, g in enumerate(ranks)))
    print(f"pipe (a) one gloo all-reduce of wte's fp32 gradient "
          f"({cfg.vocab_size * cfg.hidden * 4} B), 2 ranks sharing one H100: "
          + ", ".join(f"rank {r} {g['allreduce_cuda_ms']:.1f} ms from the "
                      f"card, {g['allreduce_cpu_ms']:.1f} ms from the host"
                      for r, g in enumerate(ranks)))
    print(f"pipe (a) small fp32 GPT pp 2 M {PIPE_SMALL_M} vs make_train_step "
          f"on the card: losses {ranks[0]['small_losses']} vs {s_losses}, "
          f"params max diff {worst:.3e}")
    n = PIPE_RING[1] // 2
    for name in ("float32", "bfloat16"):
        ref, f64 = refs[name], refs[f"float64 of {name}"]
        tol = PIPE_RING_TOL[name]
        errs = []
        for r in range(2):
            got = torch.load(os.path.join(root, f"ring_{name}.r{r}.pt"))
            rows = slice(r * n, (r + 1) * n)
            against = [("fp64", f64)] + ([("cp 1", ref)]
                                         if name == "float32" else [])
            for tag, want in against:
                for key in ("o", "dk", "dv"):
                    errs.append(_hold(f"pipe (b) ring {name} {key} rank {r} "
                                      f"vs {tag}", got[key],
                                      want[key][:, rows], tol))
                errs.append(_hold_dq(f"pipe (b) ring {name} dq rank {r} vs "
                                     f"{tag}", got["dq"], want["dq"], rows,
                                     tol))
            if name == "bfloat16":
                print(f"pipe (b) ring bfloat16 rank {r} vs cp 1 (not held): "
                      + _scaled_errs(got, ref, rows))
        print(f"pipe (b) cp 1 {name} vs fp64: "
              + _scaled_errs(ref, f64, slice(0, PIPE_RING[1])))
        print(f"pipe (b) ring attention sep 2 at {list(PIPE_RING)} {name}, "
              f"causal, 2 ranks sharing one H100: forward + backward "
              + ", ".join(f"rank {r} {g[f'ring_{name}_ms']:.1f} ms"
                          for r, g in enumerate(ranks))
              + f"; worst max_abs_err {max(errs):.3e} (scaled bar {tol})")
    print(f"pipe (b) ring peak mem "
          + ", ".join(f"rank {r} {g['ring_peak_gib']:.2f} GiB"
                      for r, g in enumerate(ranks))
          + f"; the ranks' launch to exit {wall:.1f} s")
    total.update(_pipe_ring_axis(dev, one))
    return dict(total)


EAGER_SDPA_SHAPE = (8, 512, 12, 64)     # BERT-base attention: B S h d


def _eager_gpt(dev, cfg, toks_np, labs_np) -> dict:
    """(a) The eager Layer at gpt3-350m: three steps of the user's loop
    on phase train's batch; returns its record."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as ce
    from paddle_tpu_torch.parallel.train_step import make_train_step

    # make_train_step's losses on the same weights and batch (its own
    # AdamW: fp32 moments, no clip), the first of which must be the
    # eager loop's bit for bit
    step, params, opt = make_train_step(cfg, lr=1e-4, seed=0, device=dev)
    toks, labs = step.put_batch(toks_np), step.put_batch(labs_np)
    ref = []
    for _ in range(3):
        loss, params, opt = step(params, opt, toks, labs)
        ref.append(loss.item())
    del step, params, opt, loss
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    model = GPT(cfg, seed=0)
    optim = pt.optimizer.AdamW(learning_rate=1e-4,
                               parameters=model.parameters(),
                               grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    tok, lab = pt.to_tensor(toks_np), pt.to_tensor(labs_np)
    counters = {**_train_counters(), "flash_fwd_hm": fa.flash_fwd_hm,
                "flash_bwd_hm": fa.flash_bwd_hm}
    for fn in counters.values():
        fn.launches = 0
    ce_before = collections.Counter(ce.PRODUCTS)
    ops: list = []
    dispatch.DISPATCH_HOOKS.append(ops.append)
    losses, step_s, opt_s = [], [], []
    try:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = model.loss(tok, lab)
            loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            optim.step()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            optim.clear_grad()
            losses.append(loss.item())
            step_s.append(time.perf_counter() - t0)
            opt_s.append(t2 - t1)
    finally:
        dispatch.DISPATCH_HOOKS.remove(ops.append)
    if losses[0] != ref[0]:
        raise AssertionError(f"eager first loss {losses[0]!r} is not "
                             f"make_train_step's {ref[0]!r}")
    launches = {k: fn.launches for k, fn in counters.items()}
    L, steps = cfg.n_layers, 3
    slabs = -(-cfg.vocab_size // ce.SLAB)
    per_step = {"flash_fwd": L, "flash_bwd": L, "flash_fwd_hm": 0,
                "flash_bwd_hm": 0, "fused_ce_fwd": 2,
                "fused_ce_bwd": 3 * slabs, "fused_norm_epilogue": 2 * L + 1,
                "fused_bias_act": L}
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"eager launches {launches} != {want} "
                             f"(phase train's a step: {per_step})")
    _check_ce_products("eager", ce_before, steps,
                       toks_np.size, cfg.hidden, cfg.vocab_size)
    if ops != ["gpt_loss"] * steps:
        raise AssertionError(f"eager funnel ops {collections.Counter(ops)}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"eager losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = {"step_ms": float(np.median(step_s[1:])) * 1e3,
           "opt_step_ms": float(np.median(opt_s[1:])) * 1e3,
           "funnel_ops_per_step": len(ops) / steps, "peak_gib": peak,
           "losses": losses, "make_train_step_losses": ref}
    print(f"eager GPT gpt3-350m B{toks_np.shape[0]} S{cfg.seq_len} (bf16 "
          f"compute, fp32 parameters, AdamW + global-norm clip): step "
          f"{rec['step_ms']:.2f} ms (median of steps 2-3, host clock, "
          f"synchronized), opt.step() {rec['opt_step_ms']:.2f} ms, "
          f"{rec['funnel_ops_per_step']:g} funnel op(s) a step, peak mem "
          f"{peak:.2f} GiB, losses {losses} vs make_train_step's {ref} "
          f"(first bit-equal), launches a step {per_step}")
    del model, optim, loss, tok, lab
    return rec


def _eager_sdpa_grads(pt, arrays, do, causal: bool, flag: bool):
    """(o, (dq, dk, dv), funnel ops) of SDPA through the funnel with
    ``use_pallas_attention`` at ``flag``."""
    from paddle_tpu_torch.core import dispatch

    ops: list = []
    pt.set_flags({"use_pallas_attention": flag})
    dispatch.DISPATCH_HOOKS.append(ops.append)
    try:
        q, k, v = (pt.to_tensor(a, stop_gradient=False) for a in arrays)
        o = pt.nn.functional.scaled_dot_product_attention(q, k, v,
                                                          is_causal=causal)
        grads = pt.grad([o], [q, k, v], [pt.to_tensor(do)])
    finally:
        dispatch.DISPATCH_HOOKS.remove(ops.append)
        pt.set_flags({"use_pallas_attention": True})
    return o._data, tuple(g._data for g in grads), ops


def _eager_sdpa(dev) -> dict:
    """(b) SDPA at BERT-base's attention shape through the funnel: K1-sep
    forward, K3-sep backward, held against the plain versions; the
    flag-off route (the reference's expression) within BF16_TOL of it;
    K1-sep and K3-sep timed non-causal beside their bounds and SDPA."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S, h, d = EAGER_SDPA_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, do = (torch.randn((B, S, h, d), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    worst = {"fwd": 0.0, "bwd": 0.0}
    for causal in (False, True):
        tag = f"eager sdpa bf16 B{B} S{S} h{h} d{d} causal={causal}"
        fa.flash_fwd_sep.launches = fa.flash_bwd_sep.launches = 0
        o, grads, ops = _eager_sdpa_grads(pt, (q, k, v), do, causal, True)
        n = (fa.flash_fwd_sep.launches, fa.flash_bwd_sep.launches)
        if ops != ["pallas_flash_attention"] or n != (1, 2):
            raise AssertionError(f"{tag}: funnel ops {ops}, K1-sep / K3-sep "
                                 f"launches {n} (want 1 and 2)")
        o2, lse = fa.flash_fwd_sep(q, k, v, causal, scale)
        if not torch.equal(o2, o):
            raise AssertionError(f"{tag}: the funnel's o is not K1-sep's")
        po, plse = fa.flash_sep_plain(q, k, v, causal, scale)
        worst["fwd"] = max(worst["fwd"], _hold(tag + " o", o, po, BF16_TOL))
        _hold(tag + " lse", lse, plse, FP32_TOL)
        pg = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, causal, scale)
        for name, a, b in zip("qkv", grads, pg):
            worst["bwd"] = max(worst["bwd"], _hold(f"{tag} d{name}", a, b,
                                                   BF16_TOL))
        o_off, g_off, ops = _eager_sdpa_grads(pt, (q, k, v), do, causal,
                                              False)
        if ops != ["scaled_dot_product_attention"]:
            raise AssertionError(f"{tag}: flag off took {ops}")
        # the flag-off route is the reference's expression autodiffed in
        # bf16: it rounds p and dp where the kernels round o, so where
        # ds = p (dp - delta) cancels (dq of early queries, dk of late
        # keys when causal) single rows part by more than an element
        # bound can hold; o is held element by element, the gradients
        # as whole tensors (Frobenius norm of the difference)
        _hold(tag + " flag off vs on: o", o_off, o, BF16_TOL)
        for name, a, b in zip("qkv", g_off, grads):
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            print(f"{tag} flag off vs on: d{name} relative Frobenius "
                  f"error {rel:.3e} (tol {BF16_TOL:.3e})")
            if not rel <= BF16_TOL:
                raise AssertionError(f"{tag}: flag off d{name} {rel}")
        del o, grads, o_off, g_off, pg, po
        torch.cuda.empty_cache()
    # non-causal times: kernel, plain version, SDPA on head-major operands
    o, lse = fa.flash_fwd_sep(q, k, v, False, scale)
    f_ms = _time_ms(lambda: fa.flash_fwd_sep(q, k, v, False, scale))
    b_ms = _time_ms(lambda: fa.flash_bwd_sep(q, k, v, o, lse, do, False,
                                             scale))
    f_plain = _time_ms(lambda: fa.flash_sep_plain(q, k, v, False, scale),
                       iters=3, warmup=1)
    b_plain = _time_ms(lambda: fa.flash_bwd_sep_plain(
        q, k, v, o, lse, do, False, scale), iters=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f_lib = _time_ms(lambda: sdpa(qh, kh, vh))
    # device times: 20 calls in a CUDA graph, the host's share out
    f_dev = _graph_ms(lambda: fa.flash_fwd_sep(q, k, v, False, scale))
    b_dev = _graph_ms(lambda: fa.flash_bwd_sep(q, k, v, o, lse, do, False,
                                               scale), iters=5)
    with torch.no_grad():
        f_lib_dev = _graph_ms(lambda: sdpa(qh, kh, vh))
    out = sdpa(qh, kh, vh)
    do_h = do.transpose(1, 2).contiguous()
    b_lib = _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do_h,
                                                 retain_graph=True))
    pairs = B * h * S * S
    x_b, st_b = B * S * h * d * 2, B * h * S * 4
    f_bound = _bound(4 * x_b + st_b, 4.0 * d * pairs)
    b_bound = _bound(2 * 3 * x_b + x_b + 2 * st_b, 10.0 * d * pairs)
    rec = {"shape": f"B{B} S{S} h{h} d{d} bf16 non-causal",
           "fwd_ms": f_ms, "fwd_device_ms": f_dev, "bwd_device_ms": b_dev,
           "fwd_sdpa_device_ms": f_lib_dev,
           "fwd_plain_ms": f_plain, "fwd_sdpa_ms": f_lib,
           "fwd_bound_ms": f_bound[0], "fwd_bound_by": f_bound[1],
           "bwd_ms": b_ms, "bwd_plain_ms": b_plain, "bwd_sdpa_ms": b_lib,
           "bwd_bound_ms": b_bound[0], "bwd_bound_by": b_bound[1],
           "fwd_max_abs_err": worst["fwd"], "bwd_max_abs_err": worst["bwd"]}
    print(f"eager sdpa device times (CUDA graph): K1-sep {f_dev:.4f} ms, "
          f"K3-sep {b_dev:.4f} ms, sdpa fwd {f_lib_dev:.4f} ms")
    print(f"eager sdpa {rec['shape']}: K1-sep {f_ms:.4f} ms (plain "
          f"{f_plain:.4f}, sdpa fwd {f_lib:.4f}, bound {f_bound[0]:.4f} ms "
          f"{f_bound[1]}); K3-sep {b_ms:.4f} ms (plain {b_plain:.4f}, sdpa "
          f"bwd {b_lib:.4f}, bound {b_bound[0]:.4f} ms {b_bound[1]})")
    print("eager sdpa record " + json.dumps(rec))
    return rec


def _eager_nan_inf(dev) -> None:
    """(c) check_nan_inf on the card: level 0 raises naming the op, level
    1 warns and goes on, off checks nothing."""
    import contextlib
    import io

    import paddle_tpu_torch as pt

    x = pt.to_tensor([1.0, float("inf")])
    if x.place != str(dev) and not x.place.startswith("cuda"):
        raise AssertionError(f"eager nan/inf: tensor on {x.place}")
    try:
        pt.set_flags({"check_nan_inf": True, "check_nan_inf_level": 0})
        try:
            pt.exp(x)
        except FloatingPointError as e:
            if "'exp'" not in str(e):
                raise AssertionError(f"eager nan/inf: {e} names no op")
        else:
            raise AssertionError("eager nan/inf: level 0 did not raise")
        pt.set_flags({"check_nan_inf_level": 1})
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            y = pt.exp(x)
        if "'exp'" not in buf.getvalue() or \
                not math.isinf(y.numpy()[1]):
            raise AssertionError("eager nan/inf: level 1 did not warn")
    finally:
        pt.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})
    if not math.isinf(pt.exp(x).numpy()[1]):
        raise AssertionError("eager nan/inf: flag off changed the output")
    print("eager check_nan_inf on the card: level 0 raises naming 'exp', "
          "level 1 warns, off checks nothing")


def _eager_linear(pt, i: int, o: int):
    class Lin(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([i, o])
            self.bias = self.create_parameter([o], is_bias=True)

        def forward(self, x):
            return pt.matmul(x, self.weight) + self.bias

    return Lin()


def _eager_amp(dev) -> None:
    """(d) AMP on the card: O1 bf16 matmul out in bf16 and a black-list
    op in fp32; GradScaler in fp16 skips the step on an inf; decorate O2
    casts the parameters."""
    import paddle_tpu_torch as pt

    x, w = pt.randn([64, 64]), pt.randn([64, 64])
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = pt.matmul(x, w)
        e = pt.exp(x.astype("bfloat16"))
    if y.dtype != torch.bfloat16 or e.dtype != torch.float32:
        raise AssertionError(f"eager amp O1: matmul {y.dtype}, exp {e.dtype}")
    m = _eager_linear(pt, 64, 8)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    w0 = m.weight.numpy().copy()
    with pt.amp.auto_cast(level="O1", dtype="float16"):
        h = pt.matmul(pt.full([4, 64], 300.0), m.weight)
        out = m(pt.full([4, 64], 300.0))
    if h.dtype != torch.float16:
        raise AssertionError(f"eager amp fp16: matmul out {h.dtype}")
    # d loss / d out is ~1e7 after scaling: past fp16's range in the
    # matmul's backward, so the weight gradient is inf
    scaler.scale(out.mean() * 1e4).backward()
    scaler.step(opt)
    scaler.update()
    if not np.array_equal(m.weight.numpy(), w0) or \
            scaler.get_loss_scaling() >= 2.0 ** 15:
        raise AssertionError("eager amp: GradScaler did not skip the inf "
                             "step")
    pt.amp.decorate(m, level="O2", dtype="bfloat16")
    if m.weight.dtype != torch.bfloat16 or m.weight.stop_gradient:
        raise AssertionError("eager amp: decorate O2 did not cast")
    if not pt.amp.is_bfloat16_supported():
        raise AssertionError("eager amp: bf16 reported unsupported")
    print("eager amp on the card: O1 matmul bf16, exp fp32, fp16 "
          "GradScaler skipped the inf step (scale "
          f"{scaler.get_loss_scaling():g}), decorate O2 bf16")


def _eager_card_vs_cpu(dev) -> None:
    """(e) An fp32 GPT Layer (2 layers, hidden 256, 4 heads of 64, S 256,
    B 2) takes three AdamW steps on the card and on the CPU from the same
    weights: losses within TRAIN_CPU_RTOL, parameters within
    TRAIN_CPU_ATOL."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=1024, hidden=256, n_layers=2, n_heads=4,
                    seq_len=256, dtype=torch.float32,
                    param_dtype=torch.float32)
    rng = np.random.RandomState(12)
    toks = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    labs = rng.randint(0, cfg.vocab_size, size=(2, cfg.seq_len))
    runs = {}
    state = None
    try:
        for where in ("cpu", "gpu:0"):
            pt.set_device(where)
            model = GPT(cfg, seed=7)
            if state is None:
                state = {k: v.numpy() for k, v in model.state_dict().items()}
            else:
                model.set_state_dict(state)
            opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                     parameters=model.parameters(),
                                     grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
            losses = []
            for _ in range(3):
                loss = model.loss(pt.to_tensor(toks), pt.to_tensor(labs))
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            runs[where] = (losses, [p.numpy() for p in model.parameters()])
    finally:
        pt.set_device("gpu:0")
    (lc, pc), (lg, pg) = runs["cpu"], runs["gpu:0"]
    if not np.allclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"eager cpu/cuda: losses {lg} vs {lc}")
    worst = max(float(np.abs(a - b).max()) for a, b in zip(pg, pc))
    if not worst <= TRAIN_CPU_ATOL:
        raise AssertionError(f"eager cpu/cuda: params differ by {worst}")
    print(f"eager GPT Layer cpu/cuda (fp32): losses {lg} vs {lc}, params "
          f"max diff {worst:.3e}")


def run_eager(dev) -> dict:
    """Phase eager: the Paddle eager API on the card. (a) the eager GPT
    Layer at gpt3-350m (``to_tensor``, ``GPT(cfg, seed=0)``, AdamW with
    the global-norm clip, ``loss.backward(); opt.step();
    opt.clear_grad()``) on phase train's batch: its first loss bit-equal
    to ``make_train_step``'s, its launches a step phase train's; (b)
    ``scaled_dot_product_attention`` at BERT-base's attention shape
    through the funnel (K1-sep, K3-sep); (c) ``check_nan_inf``; (d) AMP;
    (e) the card against the CPU. Returns the launches of (a)'s three
    steps and of one (b) call."""
    import dataclasses

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import gpt_presets

    pt.set_device("gpu:0")
    cfg = dataclasses.replace(gpt_presets("gpt3-350m"), unroll=True,
                              remat=False)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(16, cfg.seq_len))
    labs = rng.randint(0, cfg.vocab_size, size=(16, cfg.seq_len))
    gpt = _eager_gpt(dev, cfg, toks, labs)
    torch.cuda.empty_cache()
    _eager_sdpa(dev)
    torch.cuda.empty_cache()
    _eager_nan_inf(dev)
    _eager_amp(dev)
    _eager_card_vs_cpu(dev)
    L = cfg.n_layers
    return {"gpt3-350m steps": 3, "flash_fwd": 3 * L, "flash_bwd": 3 * L,
            "fused_norm_epilogue": 3 * (2 * L + 1),
            "fused_bias_act": 3 * L, "flash_fwd_sep (a call)": 1,
            "flash_bwd_sep (a call)": 2, "step_ms": gpt["step_ms"]}

BERT_SHAPE = (32, 512)                  # B, S: pretraining's phase 2
BERT_LOSS_RTOL = 2 ** -8                # the flash route's first loss vs
                                        # the plain expression's: fp32 CE
                                        # over bf16 logits, the two routes
                                        # rounding attention apart
BERT_SMALL = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=1024,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _bert_batch(cfg, B: int, S: int, seed: int = 0):
    """ids, token types (segment B from a random cut), MLM labels (-100
    but on 15% of positions), NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, S))
    tt = (np.arange(S)[None, :] >= rng.randint(S // 4, S, (B, 1))).astype(
        np.int64)
    mlm = rng.randint(0, cfg.vocab_size, (B, S))
    mlm[rng.rand(B, S) >= 0.15] = -100
    return ids, tt, mlm, rng.randint(0, 2, (B,))


def bert_flops_per_token(cfg, S: int) -> float:
    """Training FLOPs a token: 6 x the parameters of every product
    (L (4 H^2 + 2 H F) in the layers, H^2 in the MLM transform, V H in
    the tied decoder over every position) plus attention's scores and
    values, 12 L S H (2 products of 2 S H a token forward, x3 with the
    backward). The pooler and the NSP head touch one row a sequence."""
    H, L, F, V = (cfg.hidden_size, cfg.num_hidden_layers,
                  cfg.intermediate_size, cfg.vocab_size)
    return 6.0 * (L * (4 * H * H + 2 * H * F) + H * H + V * H) + \
        12.0 * L * S * H


def _bert_forward(pt, model, crit, batch, flag: bool, seed: int):
    """One forward under AMP O1 bf16 with ``use_pallas_attention`` at
    ``flag``, the generator reseeded (the same dropout draws on both
    routes): (loss, logits, funnel ops)."""
    from paddle_tpu_torch.core import dispatch

    ids, tt, mlm, nsp = batch
    ops: list = []
    pt.set_flags({"use_pallas_attention": flag})
    pt.seed(seed)
    dispatch.DISPATCH_HOOKS.append(ops.append)
    try:
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(ids, tt)
            loss = crit(*logits, mlm, nsp)
    finally:
        dispatch.DISPATCH_HOOKS.remove(ops.append)
        pt.set_flags({"use_pallas_attention": True})
    return loss, logits, ops


def _bert_steps(pt, model, crit, opt, batch, n: int, tag: str,
                flash: bool) -> dict:
    """``n`` steps of the user's loop (the generator reseeded to the step
    number each time); each step's launches and funnel ops checked:
    K1-sep L and K3-sep 2L with every launch wgmma and L
    ``pallas_flash_attention`` ops when ``flash``, no flash launch and L
    ``scaled_dot_product_attention`` ops otherwise. Returns losses and
    host times and each step's launch counts (set to 0 before the step,
    read after it)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    L = model.bert.config.num_hidden_layers
    losses, step_s, opt_s, reads = [], [], [], []
    for i in range(n):
        for fn in (fa.flash_fwd_sep, fa.flash_bwd_sep, fa.flash_fwd,
                   fa.flash_bwd, fa.flash_fwd_hm, fa.flash_bwd_hm):
            fn.launches = 0
        wg = (fa.flash_fwd_sep.launches_wgmma, fa.flash_bwd_sep.launches_wgmma)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, ops = _bert_forward(pt, model, crit, batch, True, i)
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = {"flash_fwd_sep": fa.flash_fwd_sep.launches,
               "flash_bwd_sep": fa.flash_bwd_sep.launches,
               "other flash": fa.flash_fwd.launches + fa.flash_bwd.launches
               + fa.flash_fwd_hm.launches + fa.flash_bwd_hm.launches}
        want = ({"flash_fwd_sep": L, "flash_bwd_sep": 2 * L,
                 "other flash": 0} if flash else
                {"flash_fwd_sep": 0, "flash_bwd_sep": 0, "other flash": 0})
        if got != want:
            raise AssertionError(f"{tag} step {i}: launches {got} != {want}")
        wg_got = (fa.flash_fwd_sep.launches_wgmma - wg[0],
                  fa.flash_bwd_sep.launches_wgmma - wg[1])
        if flash and wg_got != (L, 2 * L):
            raise AssertionError(f"{tag} step {i}: wgmma launches {wg_got}")
        op = "pallas_flash_attention" if flash else \
            "scaled_dot_product_attention"
        other = "scaled_dot_product_attention" if flash else \
            "pallas_flash_attention"
        if ops.count(op) != L or other in ops:
            raise AssertionError(f"{tag} step {i}: funnel ops "
                                 f"{collections.Counter(ops)}")
        losses.append(loss.item())
        step_s.append(t2 - t0)
        opt_s.append(t2 - t1)
        reads.append(got)
    return {"losses": losses, "step_s": step_s, "opt_s": opt_s,
            "launches": reads}


def _bert_profile(pt, model, crit, opt, batch) -> None:
    """One more step of (a)'s loop under torch.profiler, the forward +
    backward and ``opt.step()`` traced apart: each part's device busy
    share of its wall time (the profiler's cost included), kernel
    launches, the top kernels and the device time by kind."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for part in ("forward + backward", "opt.step()"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if part == "opt.step()":
                opt.step()
                opt.clear_grad()
            else:
                loss, _, _ = _bert_forward(pt, model, crit, batch, True, 9)
                loss.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"bert profile, {part}:")
        _print_profile(prof, {"wall_s": wall})
        sums, n = _device_us_by_kind(prof)
        print(f"bert profile, {part}: {n} kernel "
              "launches; device ms by kind: " + ", ".join(
                  f"{k} {v / 1e3:.2f}" for k, v in sums.items()))


def _bert_kernels(dev) -> dict:
    """K1-sep and K3-sep at the BERT-base step's attention, [32, 512, 12,
    64] bf16 non-causal: held against their plain versions at BF16_TOL
    (scaled), timed eager and on the device beside the plain versions
    and SDPA, with their bounds."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S = BERT_SHAPE
    h, d = 12, 64
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, do = (torch.randn((B, S, h, d), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    tag = f"bert K1-sep/K3-sep bf16 B{B} S{S} h{h} d{d}"
    o, lse = fa.flash_fwd_sep(q, k, v, False, scale)
    po, plse = fa.flash_sep_plain(q, k, v, False, scale)
    f_err = _hold(tag + " o", o, po, BF16_TOL)
    _hold(tag + " lse", lse, plse, FP32_TOL)
    grads = fa.flash_bwd_sep(q, k, v, o, lse, do, False, scale)
    pg = fa.flash_bwd_sep_plain(q, k, v, o, lse, do, False, scale)
    b_err = max(_hold(f"{tag} d{n}", a, b, BF16_TOL)
                for n, a, b in zip("qkv", grads, pg))
    del po, plse, pg, grads
    torch.cuda.empty_cache()
    f_ms = _time_ms(lambda: fa.flash_fwd_sep(q, k, v, False, scale))
    b_ms = _time_ms(lambda: fa.flash_bwd_sep(q, k, v, o, lse, do, False,
                                             scale))
    f_dev = _graph_ms(lambda: fa.flash_fwd_sep(q, k, v, False, scale))
    b_dev = _graph_ms(lambda: fa.flash_bwd_sep(q, k, v, o, lse, do, False,
                                               scale), iters=5)
    f_plain = _time_ms(lambda: fa.flash_sep_plain(q, k, v, False, scale),
                       iters=3, warmup=1)
    b_plain = _time_ms(lambda: fa.flash_bwd_sep_plain(
        q, k, v, o, lse, do, False, scale), iters=3, warmup=1)
    torch.cuda.empty_cache()
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f_lib = _time_ms(lambda: sdpa(qh, kh, vh))
    out = sdpa(qh, kh, vh)
    do_h = do.transpose(1, 2).contiguous()
    b_lib = _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do_h,
                                                 retain_graph=True))
    pairs = B * h * S * S
    x_b, st_b = B * S * h * d * 2, B * h * S * 4
    f_bound = _bound(4 * x_b + st_b, 4.0 * d * pairs)
    b_bound = _bound(2 * 3 * x_b + x_b + 2 * st_b, 10.0 * d * pairs)
    rec = {"shape": f"B{B} S{S} h{h} d{d} bf16 non-causal",
           "fwd_ms": f_ms, "fwd_device_ms": f_dev, "fwd_plain_ms": f_plain,
           "fwd_sdpa_ms": f_lib, "fwd_bound_ms": f_bound[0],
           "fwd_bound_by": f_bound[1], "bwd_ms": b_ms,
           "bwd_device_ms": b_dev, "bwd_plain_ms": b_plain,
           "bwd_sdpa_ms": b_lib, "bwd_bound_ms": b_bound[0],
           "bwd_bound_by": b_bound[1], "fwd_max_abs_err": f_err,
           "bwd_max_abs_err": b_err}
    print(f"{tag}: K1-sep {f_ms:.4f} ms (device {f_dev:.4f}, plain "
          f"{f_plain:.4f}, sdpa fwd {f_lib:.4f}, bound {f_bound[0]:.4f} ms "
          f"{f_bound[1]}); K3-sep {b_ms:.4f} ms (device {b_dev:.4f}, plain "
          f"{b_plain:.4f}, sdpa bwd {b_lib:.4f}, bound {b_bound[0]:.4f} ms "
          f"{b_bound[1]})")
    print("bert kernels record " + json.dumps(rec))
    return rec


def _bert_card_vs_cpu(pt) -> None:
    """(d) A small fp32 BERT takes three AdamW steps on the card and on
    the CPU from the same weights: losses within TRAIN_CPU_RTOL."""
    from paddle_tpu_torch.models import bert as tb

    cfg = tb.BertConfig(**BERT_SMALL)
    arrays = _bert_batch(cfg, 2, 128, seed=3)
    runs, state = {}, None
    try:
        for where in ("cpu", "gpu:0"):
            pt.set_device(where)
            model = tb.BertForPretraining(cfg)
            if state is None:
                state = {k: v.numpy() for k, v in model.state_dict().items()}
            else:
                model.set_state_dict(state)
            crit = tb.BertPretrainingCriterion(cfg.vocab_size)
            opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                     parameters=model.parameters())
            batch = [pt.to_tensor(a) for a in arrays]
            losses = []
            for _ in range(3):
                loss = crit(*model(*batch[:2]), *batch[2:])
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            runs[where] = losses
    finally:
        pt.set_device("gpu:0")
    lc, lg = runs["cpu"], runs["gpu:0"]
    if not np.allclose(lg, lc, rtol=TRAIN_CPU_RTOL, atol=0):
        raise AssertionError(f"bert cpu/cuda: losses {lg} vs {lc}")
    print(f"bert small fp32 cpu/cuda: losses {lg} vs {lc} (rtol "
          f"{TRAIN_CPU_RTOL:g})")


def run_bert(dev) -> dict:
    """Phase bert: BERT-base pretraining through the Paddle API. Returns
    the launches of (a)'s three timed steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert as tb
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    pt.set_device("gpu:0")
    B, S = BERT_SHAPE
    cfg = dataclasses.replace(tb.bert_base(), attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    arrays = _bert_batch(cfg, B, S)
    batch = [pt.to_tensor(a) for a in arrays]
    pt.seed(0)
    model = tb.BertForPretraining(cfg)
    crit = tb.BertPretrainingCriterion(cfg.vocab_size)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=model.parameters())
    n_params = sum(p.size for p in model.parameters())
    # (a) the flag-off route's first loss on the same weights and draws
    with pt.no_grad():
        off, _, ops = _bert_forward(pt, model, crit, batch, False, 0)
    if ops.count("scaled_dot_product_attention") != L:
        raise AssertionError(f"bert flag off: {collections.Counter(ops)}")
    off = off.item()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm = _bert_steps(pt, model, crit, opt, batch, 1, "bert (a) warm-up",
                       True)
    first = warm["losses"][0]
    if not math.isfinite(first) or \
            not abs(first - off) <= BERT_LOSS_RTOL * abs(off):
        raise AssertionError(f"bert first loss {first!r} vs the flag-off "
                             f"route's {off!r} (rtol {BERT_LOSS_RTOL})")
    before = _flash_launch_counts()
    timed = _bert_steps(pt, model, crit, opt, batch, 3, "bert (a)", True)
    _check_flash_variants("bert (a)", before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm["losses"] + timed["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bert losses {losses}")
    step_ms = float(np.median(timed["step_s"])) * 1e3
    opt_ms = float(np.median(timed["opt_s"])) * 1e3
    tokens = B * S
    flops = bert_flops_per_token(cfg, S) * tokens
    mfu = flops / (step_ms / 1e3) / BF16_FLOP_PER_S
    print(f"bert-base pretraining B{B} S{S} (AMP O1 bf16, fp32 parameters, "
          f"{n_params / 1e6:.2f}M parameters, AdamW; attention dropout 0, "
          f"hidden 0.1): step {step_ms:.2f} ms (median of 3 timed steps, "
          f"host clock, synchronized; {timed['step_s']}), "
          f"{tokens / (step_ms / 1e3):.0f} tokens/s, opt.step() "
          f"{opt_ms:.2f} ms, peak mem {peak:.2f} GiB, MFU {mfu:.4f} "
          f"(FLOPs a token 6 (L (4H^2 + 2HF) + H^2 + VH) + 12 L S H = "
          f"{bert_flops_per_token(cfg, S):.4e}, x {tokens} tokens over "
          f"{BF16_FLOP_PER_S:.3e} FLOP/s); losses {losses}; first loss vs "
          f"flag off {first!r} / {off!r} (rtol {BERT_LOSS_RTOL}); "
          f"launches a step K1-sep {L}, K3-sep {2 * L}, all wgmma")
    launches = {k: sum(r[k] for r in timed["launches"])
                for k in ("flash_fwd_sep", "flash_bwd_sep")}
    _bert_profile(pt, model, crit, opt, batch)
    torch.cuda.empty_cache()
    rec = _bert_kernels(dev)
    # (b) eval at the default config: 12 K1-sep launches, no backward
    default = tb.bert_base()
    ev = tb.BertForPretraining(default)
    ev.set_state_dict(model.state_dict())
    del opt
    ev.eval()
    fa.flash_fwd_sep.launches = fa.flash_bwd_sep.launches = 0
    with pt.no_grad():
        _, on, ops = _bert_forward(pt, ev, crit, batch, True, 0)
        n = (fa.flash_fwd_sep.launches, fa.flash_bwd_sep.launches)
        if n != (L, 0) or ops.count("pallas_flash_attention") != L:
            raise AssertionError(f"bert eval: launches {n}, ops "
                                 f"{collections.Counter(ops)}")
        _, offl, _ = _bert_forward(pt, ev, crit, batch, False, 0)
        # the two routes round attention apart in every layer and the
        # difference compounds through 12 bf16 layers: the logits are
        # held as whole tensors (relative Frobenius norm), as phase eager
        # holds the two routes' gradients
        for name, a, b in zip(("mlm", "nsp"), on, offl):
            a, b = a._data.float(), b._data.float()
            rel = ((a - b).norm() / b.norm()).item()
            print(f"bert (b) eval {name} logits flag on vs off: relative "
                  f"Frobenius error {rel:.3e} (tol {BF16_TOL:.3e}), "
                  f"largest scaled element error "
                  f"{_scaled_err(a, b)[1]:.3e}")
            if not rel <= BF16_TOL:
                raise AssertionError(f"bert eval {name} logits: {rel}")
    del on, offl
    torch.cuda.empty_cache()
    # (c) training at the default config: attention dropout 0.1 takes the
    # plain expression
    del model
    ev.train()
    opt_c = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                               parameters=ev.parameters())
    plain = _bert_steps(pt, ev, crit, opt_c, batch, 2,
                        "bert (c) attention dropout 0.1", False)
    plain_ms = plain["step_s"][-1] * 1e3
    print(f"bert (c) default config (attention dropout 0.1, the plain "
          f"expression): step {plain_ms:.2f} ms against (a)'s "
          f"{step_ms:.2f} ms; losses {plain['losses']}")
    del ev, opt_c
    torch.cuda.empty_cache()
    _bert_card_vs_cpu(pt)
    summary = {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
               "opt_step_ms": opt_ms, "peak_gib": peak, "mfu": mfu,
               "losses": losses, "first_loss_flag_off": off,
               "plain_route_step_ms": plain_ms, "kernels": rec,
               "launches": launches}
    print("bert record " + json.dumps(summary))
    return launches


RESNET_B = 64                   # the per-card batch of Paddle's ImageNet
                                # ResNet-50 recipe
RESNET_WARMUP, RESNET_TIMED = 2, 5
RESNET_LOSS_RTOL = 1e-2         # AMP O1 bf16 first loss vs the fp32 route's
# card vs CPU, fp32, TF32 off: sum order only (scaled, _scaled_err)
RESNET_CPU_TOL = 1e-3           # resnet18 logits / first conv's gradient
                                # through 8 train-mode BatchNorms
VISION_CPU_TOL = 1e-5           # one conv, pool or grid_sample
RNN_CPU_TOL = 1e-4              # 2-layer bidirectional, T 64 recurrences
AUTOGRAD_CPU_TOL = 1e-5


def _port_kernel_launches() -> dict:
    """{module.wrapper: launches} of every kernel wrapper of the port (a
    callable of ``paddle_tpu_torch.ops.kernels`` with a ``launches``
    count)."""
    import importlib
    import pkgutil

    from paddle_tpu_torch.ops import kernels

    out = {}
    for m in pkgutil.iter_modules(kernels.__path__):
        if m.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{m.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                out[f"{m.name}.{name}"] = fn.launches
    return out


def resnet_flops(model, pt, image_shape) -> float:
    """Training FLOPs of one image: 3 x the forward's 2 x multiply-adds
    of every convolution (N Cout Hout Wout Cin / groups kh kw, output
    shapes read by forward post-hooks on one image) and of the fc; the
    elementwise work (BatchNorm, relu, the residual adds, pooling) is
    left out."""
    from paddle_tpu_torch.nn import Conv2D, Linear

    macs, hooks = [0.0], []

    def conv_hook(layer, inputs, out):
        w = layer.weight
        macs[0] += out.size * w.shape[1] * w.shape[2] * w.shape[3]

    def fc_hook(layer, inputs, out):
        macs[0] += out.size * layer.weight.shape[0]

    for layer in model.sublayers():
        if isinstance(layer, Conv2D):
            hooks.append(layer.register_forward_post_hook(conv_hook))
        elif isinstance(layer, Linear):
            hooks.append(layer.register_forward_post_hook(fc_hook))
    state = {k: v._data.clone() for k, v in model.state_dict().items()}
    try:
        with pt.no_grad():
            model(pt.to_tensor(np.zeros((1,) + image_shape, np.float32)))
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():                     # BatchNorm's statistics
            for k, v in model.state_dict().items():
                v._data.copy_(state[k])
    return 3 * 2 * macs[0]


def _resnet_step(pt, model, opt, x, y, ops=None) -> float:
    """The user's loop, one step: (loss value). ``ops`` collects the
    funnel's op names."""
    from paddle_tpu_torch.core import dispatch

    F = pt.nn.functional
    if ops is not None:
        dispatch.DISPATCH_HOOKS.append(ops.append)
    try:
        model.train()
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    finally:
        if ops is not None:
            dispatch.DISPATCH_HOOKS.remove(ops.append)
    return loss.item()


RESNET_CATEGORIES = (
    ("convolutions and the fc (cuDNN, cuBLAS)",
     ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "gemm",
      "nhwc", "nchw", "cutlass", "nvjet", "sm90_")),
    ("reductions (BatchNorm statistics and its backward, the loss)",
     ("reduce_kernel",)),
    ("casts and copies (AMP)", ("copy_kernel",)),
)


def _resnet_profile(pt, model, opt, x, y) -> None:
    """One more step under torch.profiler: the device's busy share of
    the step's wall time (the profiler's cost included), kernel launches
    and the top device operations; then the forward + backward and
    ``opt.step()`` traced apart for their device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _resnet_step(pt, model, opt, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print("resnet profile, one step:")
    _print_profile(prof, {"wall_s": wall})
    cuda = torch.autograd.DeviceType.CUDA
    sums = {name: 0.0 for name, _ in RESNET_CATEGORIES}
    sums["elementwise (BatchNorm apply, relu, adds, Momentum)"] = 0.0
    launches = 0
    for e in prof.key_averages():
        if e.device_type != cuda or e.self_device_time_total <= 0:
            continue
        launches += e.count
        name = next((n for n, keys in RESNET_CATEGORIES
                     if any(k in e.key.lower() for k in keys)),
                    "elementwise (BatchNorm apply, relu, adds, Momentum)")
        sums[name] += e.self_device_time_total
    print(f"resnet profile: {launches} kernel launches a step; device ms "
          "by kind: " + ", ".join(f"{k} {v / 1e3:.2f}"
                                   for k, v in sums.items()))
    F = pt.nn.functional
    for part in ("forward + backward", "opt.step()"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if part == "opt.step()":
                opt.step()
                opt.clear_grad()
            else:
                with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
                    loss = F.cross_entropy(model(x), y)
                loss.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == cuda) / 1e3
        print(f"resnet profile, {part}: device {busy:.2f} ms of "
              f"{wall * 1e3:.2f} ms wall")


def _resnet_save_load(pt, model, opt, x, y, root) -> dict:
    """(b) Save the model's and the optimizer's state after the warm-up
    steps, load both into a fresh model and optimizer on the card, run
    the next step on each (cuDNN deterministic for both): the losses and
    every parameter and buffer bitwise equal. The optimizer's entries
    are keyed by parameter name and the fresh model's parameters have
    names of their own: the state is carried over by position."""
    import os

    from paddle_tpu_torch.vision.models import resnet50

    mpath, opath = os.path.join(root, "r50.pdparams"), \
        os.path.join(root, "r50.pdopt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.save(model.state_dict(), mpath)
    pt.save(opt.state_dict(), opath)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(mpath) + os.path.getsize(opath)
    fresh = resnet50()
    fresh_opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                      weight_decay=1e-4,
                                      parameters=fresh.parameters())
    t0 = time.perf_counter()
    fresh.set_state_dict(pt.load(mpath))
    saved = pt.load(opath)
    by_pos = [saved["state"][n] for n in opt._parameter_names]
    fresh_opt.set_state_dict({"step_count": saved["step_count"], "state": {
        p.name: s for p, s in zip(fresh_opt._parameter_list, by_pos)}})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = _resnet_step(pt, model, opt, x, y)
        b = _resnet_step(pt, fresh, fresh_opt, x, y)
    finally:
        torch.backends.cudnn.deterministic = prev
    if a != b:
        raise AssertionError(f"resnet (b) resumed step loss {b!r} vs the "
                             f"uninterrupted one's {a!r}")
    ms, fs = model.state_dict(), fresh.state_dict()
    diff = [k for k in ms if not torch.equal(ms[k]._data, fs[k]._data)]
    if diff:
        raise AssertionError(f"resnet (b) after the resumed step "
                             f"{len(diff)} tensors differ: {diff[:5]}")
    print(f"resnet (b) save / load: {nbytes / 2 ** 20:.1f} MiB "
          f"(model + Momentum state), save {save_s * 1e3:.1f} ms, load "
          f"{load_s * 1e3:.1f} ms (to the card; warm page cache); the "
          f"resumed step's loss {b!r} and all {len(ms)} tensors bitwise "
          f"equal to the uninterrupted step's")
    return {"file_mib": nbytes / 2 ** 20, "save_ms": save_s * 1e3,
            "load_ms": load_s * 1e3, "loss": a}


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _resnet_card_vs_cpu(pt, dev) -> None:
    """(c) fp32, TF32 off, the same inputs on the card and the CPU."""
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.utils.convert import layer_state_from_jax
    from paddle_tpu_torch.vision.models import resnet18

    F = pt.nn.functional
    rng = np.random.default_rng(1)
    # resnet18, B 4 at 64 x 64: layer4's train-mode BatchNorm normalises
    # over B x 2 x 2 = 16 values a channel (at 32 x 32 over 4; over 2,
    # the CPU tests saw sum-order noise grow to 17% of the logits)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 1000, (4,)).astype(np.int64)
    res = {}
    state = None
    try:
        for where in ("cpu", "gpu:0"):
            pt.set_device(where)
            m = resnet18()
            if state is None:
                state = {k: v.numpy() for k, v in m.state_dict().items()}
            else:
                m.set_state_dict(layer_state_from_jax(state, dev))
            logits = m(pt.to_tensor(x))
            F.cross_entropy(logits, pt.to_tensor(y)).backward()
            res[where] = (logits._data.cpu(), m.conv1.weight.grad._data.cpu())
    finally:
        pt.set_device("gpu:0")
    for name, i in (("logits", 0), ("conv1 weight gradient", 1)):
        _hold(f"resnet (c) resnet18 B4 64x64 fp32 card vs cpu {name}",
              res["gpu:0"][i], res["cpu"][i], RESNET_CPU_TOL)

    def both(fn, *arrays, **kw):
        """fn on the card's and the CPU's tensors: (card, cpu) outputs."""
        outs = []
        for d in (dev, torch.device("cpu")):
            o = fn(*[Tensor(t) for t in _on(d, *arrays)], **kw)
            o = o if isinstance(o, (tuple, list)) else (o,)
            outs.append([t._data.cpu() for t in o])
        return outs

    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x2, x3 = f(2, 8, 33, 35), f(1, 4, 9, 10, 11)
    cases = [
        ("conv2d SAME stride 2", F.conv2d, (x2, f(16, 4, 3, 3)),
         dict(stride=2, padding="SAME", groups=2)),
        ("conv2d asymmetric pairs", F.conv2d, (x2, f(16, 8, 5, 3)),
         dict(stride=(2, 1), padding=[[2, 1], [0, 2]], dilation=(1, 2))),
        ("conv2d_transpose output_padding", F.conv2d_transpose,
         (x2, f(8, 6, 3, 3)), dict(stride=2, padding=[1, 0, 2, 1],
                                   output_padding=1)),
        ("conv2d_transpose output_size", F.conv2d_transpose,
         (x2, f(8, 6, 4, 4)), dict(stride=2, padding=1,
                                   output_size=[65, 69])),
        ("conv3d SAME stride 2", F.conv3d, (x3, f(6, 4, 3, 3, 3)),
         dict(stride=2, padding="SAME")),
        ("avg_pool2d ceil_mode exclusive=False", F.avg_pool2d, (x2,),
         dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
              exclusive=False)),
        ("max_pool2d ceil_mode return_mask", F.max_pool2d, (x2,),
         dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
              return_mask=True)),
        ("adaptive_avg_pool2d non-uniform", F.adaptive_avg_pool2d, (x2,),
         dict(output_size=(5, 7))),
        ("adaptive_max_pool2d non-uniform", F.adaptive_max_pool2d, (x2,),
         dict(output_size=(6, 4))),
        ("grid_sample bilinear reflection", F.grid_sample,
         (x2, rng.uniform(-1.2, 1.2, (2, 9, 7, 2)).astype(np.float32)),
         dict(mode="bilinear", padding_mode="reflection",
              align_corners=False)),
        ("grid_sample nearest border", F.grid_sample,
         (x2, rng.uniform(-1.2, 1.2, (2, 9, 7, 2)).astype(np.float32)),
         dict(mode="nearest", padding_mode="border")),
    ]
    for name, fn, arrays, kw in cases:
        card, cpu = both(fn, *arrays, **kw)
        for j, (a, b) in enumerate(zip(card, cpu)):
            if a.dtype.is_floating_point:
                _hold(f"resnet (c) {name} output {j}", a, b, VISION_CPU_TOL)
            elif not torch.equal(a, b):
                raise AssertionError(f"resnet (c) {name} output {j}: "
                                     "integer outputs differ")
    # 2-layer bidirectional LSTM and GRU, hidden 256, T 64, B 8
    xs = f(8, 64, 128)
    for cls in ("LSTM", "GRU"):
        outs, state = {}, None
        try:
            for where in ("cpu", "gpu:0"):
                pt.set_device(where)
                layer = getattr(pt.nn, cls)(128, 256, num_layers=2,
                                            direction="bidirect")
                if state is None:
                    state = {k: v.numpy()
                             for k, v in layer.state_dict().items()}
                else:
                    layer.set_state_dict(layer_state_from_jax(state, dev))
                xt = pt.to_tensor(xs, stop_gradient=False)
                out, _ = layer(xt)
                out.sum().backward()
                outs[where] = (out._data.cpu(), xt.grad._data.cpu(),
                               layer.weight_hh_l0.grad._data.cpu())
        finally:
            pt.set_device("gpu:0")
        for name, i in (("output", 0), ("input gradient", 1),
                        ("weight_hh_l0 gradient", 2)):
            _hold(f"resnet (c) {cls} 2-layer bidirect H256 T64 B8 {name}",
                  outs["gpu:0"][i], outs["cpu"][i], RNN_CPU_TOL)


def _resnet_autograd(pt, dev) -> None:
    """(d) PyLayer, saved_tensors_hooks and the functional transforms on
    CUDA tensors."""
    PyLayer = pt.autograd.PyLayer

    class Tanh(PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = pt.tanh(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor
            return dy * (1 - y * y)

    rng = np.random.default_rng(2)
    xs = rng.standard_normal((64, 256)).astype(np.float32)
    x = pt.to_tensor(xs, stop_gradient=False)
    packed = []

    def pack(t):
        packed.append(1)
        return t

    with pt.autograd.saved_tensors_hooks(pack, lambda t: t):
        y = Tanh.apply(x)
        (y * y).sum().backward()
    x2 = pt.to_tensor(xs, stop_gradient=False)
    (pt.tanh(x2) ** 2).sum().backward()
    if x.grad._data.device.type != dev.type or len(packed) != 1:
        raise AssertionError(f"resnet (d) PyLayer: device "
                             f"{x.grad._data.device}, packs {len(packed)}")
    _hold("resnet (d) PyLayer Tanh gradient vs autograd's", x.grad._data,
          x2.grad._data, AUTOGRAD_CPU_TOL)
    a, b = (rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal((4,)).astype(np.float32))
    fn = lambda u, v: pt.matmul(pt.tanh(u), v * v)  # noqa: E731
    scalar = lambda u, v: (fn(u, v) ** 2).sum()  # noqa: E731
    got = {}
    try:
        for where in ("cpu", "gpu:0"):
            pt.set_device(where)
            u, v = pt.to_tensor(a), pt.to_tensor(b)
            outs = [pt.autograd.jacobian(fn, [u, v]),
                    pt.autograd.hessian(scalar, [u, v]),
                    pt.autograd.vjp(fn, [u, v])[1],
                    pt.autograd.jvp(fn, [u, v])[1]]
            flat = []

            def walk(t):
                if isinstance(t, (tuple, list)):
                    for s in t:
                        walk(s)
                else:
                    flat.append(t._data)
            walk(outs)
            got[where] = flat
    finally:
        pt.set_device("gpu:0")
    if any(t.device.type != dev.type for t in got["gpu:0"]):
        raise AssertionError("resnet (d) a transform's result left the card")
    for i, (c, h) in enumerate(zip(got["gpu:0"], got["cpu"])):
        _hold(f"resnet (d) jacobian/hessian/vjp/jvp block {i}", c.cpu(), h,
              AUTOGRAD_CPU_TOL)


def run_resnet(dev) -> dict:
    """Phase resnet: ResNet-50 training through the Paddle API. Returns
    the phase's record."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import resnet50

    t_phase = time.perf_counter()
    pt.set_device("gpu:0")
    pt.seed(0)
    model = resnet50()
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                weight_decay=1e-4,
                                parameters=model.parameters())
    n_params = sum(p.size for p in model.parameters())
    flops_img = resnet_flops(model, pt, (3, 224, 224))
    rng = np.random.default_rng(0)
    B = RESNET_B
    x = pt.to_tensor(rng.standard_normal((B, 3, 224, 224)).astype(
        np.float32))
    y = pt.to_tensor(rng.integers(0, 1000, (B,)).astype(np.int64))
    # the fp32 route's first loss on the same weights (train mode: batch
    # statistics; the BatchNorm buffers it moves are put back)
    state = {k: v._data.clone() for k, v in model.state_dict().items()}
    with pt.no_grad():
        fp32 = pt.nn.functional.cross_entropy(model(x), y).item()
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v._data.copy_(state[k])
    del state
    before = _port_kernel_launches()
    losses, ops = [], []
    for i in range(RESNET_WARMUP):
        losses.append(_resnet_step(pt, model, opt, x, y,
                                   ops if i == 0 else None))
    if not abs(losses[0] - fp32) <= RESNET_LOSS_RTOL * abs(fp32):
        raise AssertionError(f"resnet first loss {losses[0]!r} vs the fp32 "
                             f"route's {fp32!r} (rtol {RESNET_LOSS_RTOL})")
    with tempfile.TemporaryDirectory() as root:
        saved = _resnet_save_load(pt, model, opt, x, y, root)
    losses.append(saved["loss"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(RESNET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_resnet_step(pt, model, opt, x, y))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = _port_kernel_launches()
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if ran:
        raise AssertionError(f"resnet: port kernels launched {ran}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet losses {losses}")
    step_ms = float(np.median(step_s)) * 1e3
    flops = flops_img * B
    mfu = flops / (step_ms / 1e3) / BF16_FLOP_PER_S
    counts = collections.Counter(ops)
    print(f"resnet-50 training B{B} 3x224x224 (AMP O1 bf16, fp32 "
          f"parameters, {n_params} parameters, Momentum lr 0.1 momentum "
          f"0.9 weight decay 1e-4, cuDNN convolutions): step {step_ms:.2f} "
          f"ms (median of {RESNET_TIMED} timed steps, host clock, "
          f"synchronized; {step_s}), {B / (step_ms / 1e3):.1f} images/s, "
          f"peak mem {peak:.2f} GiB, MFU {mfu:.4f} (training FLOPs an "
          f"image 6 x conv + fc multiply-adds = {flops_img:.4e}, x {B} "
          f"over {BF16_FLOP_PER_S:.3e} FLOP/s); losses {losses}; first "
          f"loss vs the fp32 route's {losses[0]!r} / {fp32!r} (rtol "
          f"{RESNET_LOSS_RTOL}); funnel ops a step {sum(counts.values())} "
          f"({dict(counts.most_common(8))}); port kernel launches a step 0 "
          "(none of the 21 lies on this path)")
    _resnet_profile(pt, model, opt, x, y)
    del model, opt, x
    torch.cuda.empty_cache()
    _resnet_card_vs_cpu(pt, dev)
    _resnet_autograd(pt, dev)
    rec = {"step_ms": step_ms, "images_per_s": B / (step_ms / 1e3),
           "peak_gib": peak, "mfu": mfu, "flops_per_image": flops_img,
           "losses": losses, "first_loss_fp32": fp32,
           "funnel_ops_a_step": sum(counts.values()), "save_load": saved,
           "phase_s": time.perf_counter() - t_phase}
    print("resnet record " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# ops: the op library's long tail (ops/linalg.py, extra.py, extra2.py,
# parity.py) on the card
# ---------------------------------------------------------------------------

OPS_PACKED = (16, 1024, 16, 64)      # gpt3-350m attention: B S h d
OPS_VOCAB = (16, 128256)             # llama3-8b's vocabulary, 16 rows
OPS_TOP_P = 0.9
OPS_INT8 = (512, 4096, 14336)        # llama3-8b MLP: tokens, hidden, ffn
OPS_INT8_CPU_ROWS = 64               # rows the CPU recomputes
OPS_MOE_TOKENS = 16 * 1024           # GPT-MoE routing: B 16 x S 1024
OPS_LOWRANK = (4096, 16)             # llama3-8b q_proj width, rank q
OPS_LOWRANK_OVER = 8                 # oversampling of the held U S V^T:
                                     # at q = rank the fp32 range finder's
                                     # error scales with the conditioning
                                     # of the square sketch V^T Omega
                                     # (1.8e-5 to 4.3e-3 of the largest
                                     # magnitude over draws), at q = rank
                                     # + 8 it is ~1e-5
OPS_EINSUM = (16, 16, 1024, 64)      # [B, h, S, d] bf16
OPS_EINSUM_CPU_B = 2                 # batches the CPU recomputes
OPS_SPD = 1024
OPS_NMS = (80, 1000, 100)            # COCO classes, boxes, keep_top_k


def _ops_cases_module():
    """tests/torch_ops_cases.py: the op cases of the CPU tests, numpy
    only (imports nothing of JAX)."""
    return _test_module("torch_ops_cases")


def _on_device(pt, device: str, fn):
    """``fn()`` with ``device`` the package's current device."""
    pt.set_device(device)
    try:
        return fn()
    finally:
        pt.set_device("gpu:0")


def _to_numpy(out) -> list:
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    res = []
    for o in outs:
        if isinstance(o, (list, tuple)):
            res.extend(_to_numpy(o))
        elif o is None:
            res.append(None)
        else:
            t = o._data if hasattr(o, "_data") else o
            if isinstance(t, torch.Tensor):
                if t.dtype == torch.bfloat16:
                    t = t.float()
                res.append(t.detach().resolve_conj().cpu().numpy())
            else:
                res.append(np.asarray(t))
    return res


def _ops_card_vs_cpu(pt, dev) -> dict:
    """(a) Every op case of the four modules (the CPU tests' cases) on
    CUDA tensors against the same port op on CPU tensors: integer and
    boolean outputs exact, floating outputs within FP32_TOL of the
    output's largest magnitude (TF32 off), decompositions by their
    invariants (the cases' checks)."""
    from paddle_tpu_torch.core.dispatch import OP_REGISTRY, op_call

    oc = _ops_cases_module()
    tables = {**oc.LINALG_CASES, **oc.EXTRA_CASES, **oc.PARITY_CASES}
    rows, worst = [], 0.0

    def tensors(obj):
        if isinstance(obj, np.ndarray):
            return pt.to_tensor(obj)
        if isinstance(obj, list) and obj and isinstance(obj[0], np.ndarray):
            return [pt.to_tensor(o) for o in obj]
        return obj

    def compare(tag, card, cpu, check=None):
        nonlocal worst
        if check is not None:
            check(card, cpu)
            rows.append((tag, "invariants"))
            return
        if len(card) != len(cpu):
            raise AssertionError(f"ops {tag}: {len(card)} outputs on the "
                                 f"card, {len(cpu)} on the CPU")
        err = 0.0
        for i, (a, b) in enumerate(zip(card, cpu)):
            if a is None or b is None:
                if (a is None) != (b is None):
                    raise AssertionError(f"ops {tag} output {i}: None")
                continue
            oc.assert_same(a, b, FP32_TOL, f"ops {tag} output {i}")
            if b.dtype.kind in "fc" and b.size:
                d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
                err = max(err, float(np.nanmax(d)) if d.size else 0.0)
        worst = max(worst, err)
        rows.append((tag, f"{err:.2e}"))

    unordered = []
    for name in sorted(tables):
        opdef = OP_REGISTRY[name]
        for cid, factory, opts in tables[name]:
            if opts.get("unordered"):
                unordered.append(f"{name}[{cid}]")
                continue
            if factory is None or isinstance(factory, tuple):
                args, kwargs = oc.contract_case(name, opdef.impl,
                                                domain=factory)
            else:
                args, kwargs = factory()

            def call(args=args, kwargs=kwargs, opdef=opdef):
                a = [tensors(x) for x in args]
                k = {n: tensors(v) for n, v in kwargs.items()}
                if opdef.name == "view_dtype":
                    return _to_numpy(pt.view(*a, **k))
                return _to_numpy(op_call(opdef, a, k))

            card = _on_device(pt, "gpu:0", call)
            cpu = _on_device(pt, "cpu", call)
            compare(f"{name}[{cid}]", card, cpu, opts.get("check"))
    for name, fn in sorted(oc.EXTRA_FUNCS.items()):
        compare(name, _on_device(pt, "gpu:0", lambda: _to_numpy(fn(pt))),
                _on_device(pt, "cpu", lambda: _to_numpy(fn(pt))))
    for name, (mk, kw) in sorted(oc.FFT_CASES.items()):
        x = mk()
        x = x.astype(np.complex64) if np.iscomplexobj(x) else x

        def fft(name=name, x=x, kw=kw):
            return _to_numpy(getattr(pt.fft, name)(pt.to_tensor(x), **kw))

        compare(f"fft.{name}", _on_device(pt, "gpu:0", fft),
                _on_device(pt, "cpu", fft))
    # the functions and random ops the tables hold elsewhere, by their
    # deterministic parts
    f32 = oc.f32
    extra = {
        "fractional_max_pool2d": lambda: pt.ops.parity.fractional_max_pool2d(
            pt.to_tensor(f32(2, 3, 17, 19)), (5, 7), random_u=0.3),
        "fractional_max_pool3d": lambda: pt.ops.parity.fractional_max_pool3d(
            pt.to_tensor(f32(1, 2, 7, 8, 9)), (3, 3, 4)),
        "random_routing": lambda: pt.ops.parity.random_routing(
            pt.to_tensor(f32(64, lo=0, hi=1)),
            pt.to_tensor(f32(64, 2, lo=0, hi=0.5, seed=1)),
            pt.to_tensor(np.arange(128).reshape(64, 2))),
        "flash_attn_varlen_qkvpacked": lambda:
            pt.ops.parity.flash_attn_varlen_qkvpacked(
                pt.to_tensor(f32(96, 3, 2, 32)),
                pt.to_tensor(np.array([0, 40, 96], np.int32)),
                pt.to_tensor(np.array([0, 40, 96], np.int32)),
                causal=True)[0],
        "flashmask_attention": lambda: pt.ops.parity.flashmask_attention(
            *[pt.to_tensor(f32(2, 32, 2, 16, seed=s)) for s in range(3)],
            causal=True),
        "fp8_fp8_half_gemm_fused": lambda: pt.linalg.fp8_fp8_half_gemm_fused(
            pt.to_tensor(torch.from_numpy(np.round(f32(8, 32) * 4) / 4)
                         .to(torch.float8_e4m3fn)),
            pt.to_tensor(torch.from_numpy(np.round(f32(16, 32, seed=1) * 4)
                                          / 4).to(torch.float8_e4m3fn)),
            transpose_y=True, scale=0.5, output_dtype="bfloat16"),
    }
    for name, fn in sorted(extra.items()):
        compare(name, _on_device(pt, "gpu:0", lambda: _to_numpy(fn())),
                _on_device(pt, "cpu", lambda: _to_numpy(fn())))
    pt.seed(5)
    z = pt.ops.parity.truncated_gaussian_random((1 << 20,), a=-1.0, b=2.0)
    zc = z._data
    if not (zc.device.type == dev.type and zc.min().item() > -1.0
            and zc.max().item() < 2.0
            and abs(zc.mean().item() - 0.2296) < 0.01):
        raise AssertionError("ops truncated_gaussian_random on the card: "
                             f"{zc.device} {zc.min().item()} "
                             f"{zc.max().item()} {zc.mean().item()}")
    rows.append(("truncated_gaussian_random", "mean 0.2296 +- 0.01"))
    print(f"ops (a) card vs CPU: {len(rows)} cases of "
          f"{len(tables) + len(oc.EXTRA_FUNCS) + len(oc.FFT_CASES)} ops "
          f"and functions held (bar: integers exact, floats FP32_TOL "
          f"{FP32_TOL:.0e} of the largest magnitude, decompositions by "
          f"their invariants at {oc.DECOMP_RTOL:.0e}); largest float "
          f"difference {worst:.3e}; not run (a scatter writing one place "
          f"twice, unordered on the card): {unordered}")
    for i in range(0, len(rows), 6):
        print("  " + "; ".join(f"{t} {e}" for t, e in rows[i:i + 6]))
    return {"cases": len(rows), "max_abs_err": worst}


def _ops_row(rec: dict, name: str, err: float, bar: str, ms: float,
             extra: str = "", cpu_ms: float | None = None) -> None:
    rec[name] = {"max_abs_err": err, "bar": bar, "ms": ms, "cpu_ms": cpu_ms}
    cpu = "" if cpu_ms is None else f" (the CPU {cpu_ms:.3f} ms)"
    print(f"ops {name}: err {err:.3e} (bar {bar}), {ms:.4f} ms{cpu}{extra}")


def _cpu_ms(pt, fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn()`` with the CPU the package's
    device, after one warm-up call."""
    def timed():
        fn()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    return _on_device(pt, "cpu", timed)


def _ops_packed_flash(pt, dev, rec: dict) -> dict:
    """flash_attn_qkvpacked at gpt3-350m's attention: K1-sep forward and
    K3-sep backward through flash_attention_raw, held against the plain
    versions, timed beside SDPA on the same tensors."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S, h, d = OPS_PACKED
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(31)
    qkv = torch.randn((B, S, 3, h, d), generator=gen, device=dev) \
        .to(torch.bfloat16)
    do = torch.randn((B, S, h, d), generator=gen, device=dev) \
        .to(torch.bfloat16)
    x = pt.to_tensor(qkv, stop_gradient=False)
    n0 = (fa.flash_fwd_sep.launches, fa.flash_bwd_sep.launches)
    out = pt.ops.parity.flash_attn_qkvpacked(x, causal=True)
    (g,) = pt.grad([out], [x], [pt.to_tensor(do)])
    n = (fa.flash_fwd_sep.launches - n0[0], fa.flash_bwd_sep.launches - n0[1])
    if n != (1, 2):
        raise AssertionError(f"ops packed flash: K1-sep / K3-sep launches "
                             f"{n}, want (1, 2)")
    q, k, v = qkv.unbind(2)
    po, plse = fa.flash_sep_plain(q, k, v, True, scale)
    tag = f"packed flash [{B}, {S}, 3, {h}, {d}] bf16 causal"
    e_f = _hold(tag + " o", out._data, po, BF16_TOL)
    pg = fa.flash_bwd_sep_plain(q, k, v, po.to(torch.bfloat16), plse, do,
                                True, scale)
    e_b = max(_hold(f"{tag} d{c}", g._data[:, :, i], pg[i], BF16_TOL)
              for i, c in enumerate("qkv"))
    del po, plse, pg, g
    torch.cuda.empty_cache()
    qkv_r = qkv.clone().requires_grad_(True)

    def packed_fwd():
        with torch.no_grad():
            return pt.ops.parity.flash_attn_qkvpacked(qkv, causal=True)

    def packed_fwd_bwd():
        o = pt.ops.parity.flash_attn_qkvpacked(qkv_r, causal=True)
        return torch.autograd.grad(o, qkv_r, do)

    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    do_h = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa(qh, kh, vh, is_causal=True)

    def sdpa_fwd_bwd():
        o = sdpa(qh, kh, vh, is_causal=True)
        return torch.autograd.grad(o, (qh, kh, vh), do_h)

    f_ms, fb_ms = _time_ms(packed_fwd), _time_ms(packed_fwd_bwd)
    s_f, s_fb = _time_ms(sdpa_fwd), _time_ms(sdpa_fwd_bwd)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    o, lse = fa.flash_fwd_sep(qc, kc, vc, True, scale)
    f_dev = _graph_ms(lambda: fa.flash_fwd_sep(qc, kc, vc, True, scale))
    b_dev = _graph_ms(lambda: fa.flash_bwd_sep(qc, kc, vc, o, lse, do,
                                               True, scale), iters=5)
    s_dev = _graph_ms(sdpa_fwd)
    pairs = B * h * S * (S + 1) / 2
    x_b, st_b = B * S * h * d * 2, B * h * S * 4
    f_bound = _bound(4 * x_b + st_b, 4.0 * d * pairs)
    b_bound = _bound(2 * 3 * x_b + x_b + 2 * st_b, 10.0 * d * pairs)
    _ops_row(rec, "flash_attn_qkvpacked fwd", e_f, f"BF16_TOL "
             f"{BF16_TOL:.3e} scaled", f_ms,
             f" eager (SDPA {s_f:.4f}); device K1-sep {f_dev:.4f}, SDPA "
             f"{s_dev:.4f}, bound {f_bound[0]:.4f} ({f_bound[1]})")
    _ops_row(rec, "flash_attn_qkvpacked fwd+bwd", e_b, f"BF16_TOL "
             f"{BF16_TOL:.3e} scaled", fb_ms,
             f" eager (SDPA {s_fb:.4f}); device K3-sep {b_dev:.4f}, bound "
             f"{b_bound[0]:.4f} ({b_bound[1]})")
    rec["flash_attn_qkvpacked fwd"].update(
        sdpa_ms=s_f, k1_sep_device_ms=f_dev, sdpa_device_ms=s_dev,
        bound_ms=f_bound[0])
    rec["flash_attn_qkvpacked fwd+bwd"].update(
        sdpa_ms=s_fb, k3_sep_device_ms=b_dev, bound_ms=b_bound[0])
    del qkv_r, qh, kh, vh, o, lse
    torch.cuda.empty_cache()
    # the entry's one forward and backward; the timing calls after it
    # are not the path's
    return {"flash_fwd_sep": n[0], "flash_bwd_sep": n[1]}


def _ops_top_p(pt, dev, rec: dict) -> None:
    """top_p_sampling at llama3-8b's vocabulary with a seed: the card's
    ids equal the CPU's, and every id lies in its row's nucleus."""
    B, V = OPS_VOCAB
    gen = torch.Generator(device=dev).manual_seed(41)
    probs = torch.softmax(torch.randn((B, V), generator=gen, device=dev)
                          * 4, dim=-1)
    ps = torch.full((B,), OPS_TOP_P, device=dev)

    def card():
        return pt.top_p_sampling(pt.to_tensor(probs), pt.to_tensor(ps),
                                 seed=7)

    vals, ids = card()
    pc, psc = probs.cpu(), ps.cpu()
    pt.set_device("cpu")
    try:
        cvals, cids = pt.top_p_sampling(pt.to_tensor(pc), pt.to_tensor(psc),
                                        seed=7)
    finally:
        pt.set_device("gpu:0")
    ids_c = ids._data.cpu()
    if not torch.equal(ids_c, cids._data) or not torch.equal(
            vals._data.cpu(), cvals._data):
        raise AssertionError(f"ops top_p: card ids {ids_c.view(-1)} vs CPU "
                             f"{cids._data.view(-1)}")
    p = pc.double().numpy()
    for b in range(B):
        order = np.argsort(-p[b], kind="stable")
        before = np.concatenate([[0.0], np.cumsum(p[b][order])[:-1]])
        nucleus = set(order[before < OPS_TOP_P].tolist())
        if int(ids_c[b, 0]) not in nucleus:
            raise AssertionError(f"ops top_p: row {b} id {int(ids_c[b, 0])} "
                                 f"outside its nucleus of {len(nucleus)}")
    ms = _time_ms(card, iters=10, warmup=2)
    cpu_ms = _cpu_ms(pt, lambda: pt.top_p_sampling(
        pt.to_tensor(pc), pt.to_tensor(psc), seed=7))
    _ops_row(rec, "top_p_sampling", 0.0, "ids equal, in the nucleus", ms,
             f" ([{B}, {V}] fp32, ps {OPS_TOP_P}, seed 7; ids "
             f"{ids_c.view(-1).tolist()})", cpu_ms)


def _ops_int8(pt, dev, rec: dict) -> None:
    """llm_int8_linear at llama3-8b's MLP against the CPU (its first
    rows), timed beside torch.matmul with the weight dequantized
    beforehand."""
    M, K, N = OPS_INT8
    gen = torch.Generator(device=dev).manual_seed(51)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((N,), generator=gen, device=dev) * 0.04 + 0.01
    xt, wt, st = pt.to_tensor(x), pt.to_tensor(w), pt.to_tensor(s)
    out = pt.ops.parity.llm_int8_linear(xt, wt, st)._data
    r = OPS_INT8_CPU_ROWS
    pt.set_device("cpu")
    try:
        cpu = pt.ops.parity.llm_int8_linear(
            pt.to_tensor(x[:r].cpu()), pt.to_tensor(w.cpu()),
            pt.to_tensor(s.cpu()))._data
    finally:
        pt.set_device("gpu:0")
    err = _hold(f"llm_int8_linear [{M}, {K}] x int8 [{N}, {K}] rows 0-{r - 1}"
                " card vs CPU", out[:r], cpu.to(dev), BF16_TOL)
    w_deq = w.to(torch.bfloat16) * (s.to(torch.bfloat16) / 127.0)[:, None]
    ms = _time_ms(lambda: pt.ops.parity.llm_int8_linear(xt, wt, st))
    lib = _time_ms(lambda: torch.matmul(x, w_deq.mT))
    bound = _bound(M * K * 2 + N * K + M * N * 2, 2.0 * M * N * K)
    _ops_row(rec, "llm_int8_linear", err, f"BF16_TOL {BF16_TOL:.3e} scaled",
             ms, f" (torch.matmul of the dequantized bf16 weight {lib:.4f};"
             f" bound {bound[0]:.4f} {bound[1]})")
    rec["llm_int8_linear"].update(library_ms=lib, bound_ms=bound[0])


def _ops_moe(pt, dev, rec: dict) -> None:
    """The MoE auxiliaries at the GPT-MoE routing (8 experts, capacity
    1.25, 16 x 1024 tokens, top-1 of skewed router logits): card equal to
    the CPU."""
    N, E = OPS_MOE_TOKENS, MOE_EXPERTS
    gen = torch.Generator(device=dev).manual_seed(61)
    skew = torch.linspace(0.0, 1.0, E, device=dev)
    gate = (torch.randn((N, E), generator=gen, device=dev) + skew) \
        .argmax(-1)
    cap = int(MOE_CAPACITY * N / E)
    P = pt.ops.parity

    def chain(g):
        counts = P.number_count(g, E)
        lim = P.limit_by_capacity(counts, pt.full([E], cap, "int64"), 1)
        pruned = P.prune_gate_by_capacity(g, lim, E)
        pos = P.assign_pos(g, pt.cumsum(counts, 0))
        return counts, lim, pruned, pos

    card = [t._data.cpu() for t in chain(pt.to_tensor(gate))]
    pt.set_device("cpu")
    try:
        cpu = [t._data for t in chain(pt.to_tensor(gate.cpu()))]
    finally:
        pt.set_device("gpu:0")
    for name, a, b in zip(("number_count", "limit_by_capacity",
                           "prune_gate_by_capacity", "assign_pos"), card,
                          cpu):
        if not torch.equal(a, b):
            raise AssertionError(f"ops moe {name}: card != CPU")
    gt = pt.to_tensor(gate)
    ms = _time_ms(lambda: chain(gt), iters=10)
    gc_ = gate.cpu()
    cpu_ms = _cpu_ms(pt, lambda: chain(pt.to_tensor(gc_)))
    dropped = int((card[2] < 0).sum())
    _ops_row(rec, "moe auxiliaries", 0.0, "equal to the CPU", ms,
             f" (the four in a chain; N {N}, {E} experts, capacity {cap}; "
             f"loads {card[0].tolist()}, {dropped} tokens pruned)", cpu_ms)


def _ops_lowrank(pt, dev, rec: dict) -> None:
    """svd_lowrank and pca_lowrank of an exactly rank-16 [4096, 4096]
    fp32 matrix, card and CPU alike: at q 16 the singular values are the
    known ones within FP32_TOL; at q 16 + OPS_LOWRANK_OVER the leading
    16 too, and U S Vᵀ is the matrix within FP32_TOL of its largest
    magnitude. U's columns are orthogonal to the ones vector, so the
    matrix's columns have mean 0 and pca_lowrank's centring keeps the
    rank at 16."""
    n, r = OPS_LOWRANK
    gen = torch.Generator(device=dev).manual_seed(71)
    g = torch.randn((n, r), generator=gen, device=dev)
    u = torch.linalg.qr(g - g.mean(0, keepdim=True))[0]
    v = torch.linalg.qr(torch.randn((n, r), generator=gen, device=dev))[0]
    s_true = torch.linspace(2.0, 1.0, r, device=dev)
    a = (u * s_true) @ v.mT

    def errors(fn, q):
        """(singular values, U S Vᵀ) relative errors, worst of card and
        CPU."""
        out = []
        for device in ("gpu:0", "cpu"):
            src = a if device == "gpu:0" else a.cpu()
            U, S, Vt = _on_device(pt, device, lambda: getattr(pt.linalg, fn)(
                pt.to_tensor(src), q=q))
            U, S, Vt = (t._data.to(dev) for t in (U, S, Vt))
            out.append((((S[:r] - s_true).abs() / s_true).max().item(),
                        ((U * S) @ Vt.mT - a).abs().max().item()
                        / a.abs().max().item()))
        return tuple(max(e) for e in zip(*out))

    q_over = r + OPS_LOWRANK_OVER
    for fn in ("svd_lowrank", "pca_lowrank"):
        e_s, e_rec16 = errors(fn, r)
        e_s_over, e_rec = errors(fn, q_over)
        if not (max(e_s, e_s_over) <= FP32_TOL and e_rec <= FP32_TOL):
            raise AssertionError(f"ops {fn}: singular values {e_s} (q {r}) "
                                 f"{e_s_over} (q {q_over}), U S V^T {e_rec}"
                                 f" (q {q_over})")
        at = pt.to_tensor(a)
        ms = _time_ms(lambda: getattr(pt.linalg, fn)(at, q=r), iters=5,
                      warmup=1)
        ac = a.cpu()
        cpu_ms = _cpu_ms(pt, lambda: getattr(pt.linalg, fn)(
            pt.to_tensor(ac), q=r))
        _ops_row(rec, fn, max(e_s, e_s_over, e_rec), f"FP32_TOL "
                 f"{FP32_TOL:.0e} relative", ms,
                 f" at q {r} ([{n}, {n}] fp32 rank {r}, niter 2; card and "
                 f"CPU): singular values {e_s:.3e} at q {r}, {e_s_over:.3e} "
                 f"at q {q_over}; U S V^T {e_rec:.3e} at q {q_over} ("
                 f"{e_rec16:.3e} at q {r}, not held: the square sketch)",
                 cpu_ms)


def _ops_einsum(pt, dev, rec: dict) -> None:
    B, h, S, d = OPS_EINSUM
    gen = torch.Generator(device=dev).manual_seed(81)
    q, k = (torch.randn((B, h, S, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    qt, kt = pt.to_tensor(q), pt.to_tensor(k)
    eq = "bhqd,bhkd->bhqk"
    out = pt.einsum(eq, qt, kt)._data
    b = OPS_EINSUM_CPU_B
    qc, kc = q[:b].cpu(), k[:b].cpu()
    cpu = _on_device(pt, "cpu", lambda: pt.einsum(
        eq, pt.to_tensor(qc), pt.to_tensor(kc)))._data
    err = _hold(f"einsum {eq} [{B}, {h}, {S}, {d}] bf16 batches 0-{b - 1} "
                "card vs CPU", out[:b], cpu.to(dev), BF16_TOL)
    ms = _time_ms(lambda: pt.einsum(eq, qt, kt))
    lib = _time_ms(lambda: torch.matmul(q, k.mT))
    bound = _bound(2 * B * h * S * d * 2 + B * h * S * S * 2,
                   2.0 * B * h * S * S * d)
    _ops_row(rec, "einsum", err, f"BF16_TOL {BF16_TOL:.3e} scaled", ms,
             f" (torch.matmul {lib:.4f}; bound {bound[0]:.4f} {bound[1]})")
    rec["einsum"].update(library_ms=lib, bound_ms=bound[0])


def _ops_spd(pt, dev, rec: dict) -> None:
    n = OPS_SPD
    gen = torch.Generator(device=dev).manual_seed(91)
    m = torch.randn((n, n), generator=gen, device=dev)
    a = m @ m.mT / n + torch.eye(n, device=dev)
    rhs = torch.randn((n, 16), generator=gen, device=dev)
    cases = {
        "cholesky": lambda A, R: pt.cholesky(A),
        "solve": lambda A, R: pt.solve(A, R),
        "inverse": lambda A, R: pt.inverse(A),
        "slogdet": lambda A, R: pt.slogdet(A),
    }
    for name, fn in cases.items():
        card = fn(pt.to_tensor(a), pt.to_tensor(rhs))._data
        cpu = _on_device(pt, "cpu", lambda: fn(pt.to_tensor(a.cpu()),
                                        pt.to_tensor(rhs.cpu())))._data
        err = (card.cpu() - cpu).abs().max().item()
        bar = FP32_TOL * cpu.abs().max().item()
        if not err <= bar:
            raise AssertionError(f"ops {name} [{n}, {n}] SPD: card vs CPU "
                                 f"{err} > {bar}")
        at, rt = pt.to_tensor(a), pt.to_tensor(rhs)
        ms = _time_ms(lambda: fn(at, rt), iters=10)
        ac, rc = a.cpu(), rhs.cpu()
        cpu_ms = _cpu_ms(pt, lambda: fn(pt.to_tensor(ac), pt.to_tensor(rc)))
        _ops_row(rec, name, err, f"FP32_TOL {FP32_TOL:.0e} of the largest "
                 "magnitude", ms, f" ([{n}, {n}] SPD fp32, card vs CPU)",
                 cpu_ms)


def _ops_nms(pt, dev, rec: dict) -> None:
    C, N, top = OPS_NMS
    gen = torch.Generator(device=dev).manual_seed(101)
    xy = torch.rand((N, 2), generator=gen, device=dev) * 600
    wh = torch.rand((N, 2), generator=gen, device=dev) * 120 + 8
    boxes = torch.cat([xy, xy + wh], 1)
    scores = torch.rand((C, N), generator=gen, device=dev)
    bt, st = pt.to_tensor(boxes), pt.to_tensor(scores)
    card = pt.ops.parity.multiclass_nms3(bt, st, keep_top_k=top)._data
    cpu = _on_device(pt, "cpu", lambda: pt.ops.parity.multiclass_nms3(
        pt.to_tensor(boxes.cpu()), pt.to_tensor(scores.cpu()),
        keep_top_k=top))._data
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError("ops multiclass_nms3: card != CPU")
    ms = _time_ms(lambda: pt.ops.parity.multiclass_nms3(bt, st,
                                                        keep_top_k=top),
                  iters=3, warmup=1)
    bc, sc = boxes.cpu(), scores.cpu()
    cpu_ms = _cpu_ms(pt, lambda: pt.ops.parity.multiclass_nms3(
        pt.to_tensor(bc), pt.to_tensor(sc), keep_top_k=top), reps=1)
    _ops_row(rec, "multiclass_nms3", 0.0, "equal to the CPU", ms,
             f" ({C} classes x {N} boxes, keep_top_k {top}; the classes' "
             f"greedy loops batched: {N} steps)", cpu_ms)


def run_ops(dev) -> dict:
    """Phase ops: the op library's long tail on the card. (a) every op of
    ops/linalg.py, extra.py, extra2.py and parity.py against the same op
    on the CPU; (b) the slice at full width, each row with its error, its
    bar and its time. Returns the launches of K1-sep / K3-sep."""
    import paddle_tpu_torch as pt

    t_phase = time.perf_counter()
    print("ops on " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    pt.set_device("gpu:0")
    rec = {"card_vs_cpu": _ops_card_vs_cpu(pt, dev)}
    launches = _ops_packed_flash(pt, dev, rec)
    _ops_top_p(pt, dev, rec)
    _ops_int8(pt, dev, rec)
    _ops_moe(pt, dev, rec)
    _ops_lowrank(pt, dev, rec)
    _ops_einsum(pt, dev, rec)
    _ops_spd(pt, dev, rec)
    _ops_nms(pt, dev, rec)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print("ops record " + json.dumps(rec))
    return launches


DP_MP_WORKER = "--dp-mp-worker"
DP_MP_B, DP_MP_S = 16, 512           # (a) a rank's batch: dp 2 x B 16 is
                                     # phase bert's global batch of 32
DP_MP_MASKED = 80                    # MLM labels a sequence at S 512 (BERT
                                     # pretraining's max_predictions_per_seq)
DP_MP_GPT_B = 4                      # (b) GPT-3 1.3B at mp 2, S 1024
DP_MP_STEPS = 3
DP_MP_RTOL = 1e-3                    # (b) mp 2 vs mp 1: first loss and clip
                                     # norm (the row layers sum bf16 partials)
DP_MP_CLIP = 1.0
DP_MP_SMALL_GPT = dict(vocab_size=1024, hidden=256, n_layers=2, n_heads=4,
                       seq_len=128)


def _test_module(name: str):
    """A module of tests/ that imports nothing of JAX (the cases and
    models the CPU tests share with this script)."""
    import importlib
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def _dp_mp_bert_cfg():
    """BERT-base with both dropouts 0: the ranks and the one-rank
    reference draw no masks, so they compute one function."""
    from paddle_tpu_torch.models import bert as tb

    return dataclasses.replace(tb.bert_base(), hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)


def _dp_mp_bert_batch(cfg, B: int):
    """ids, token types, MLM labels (DP_MP_MASKED a sequence), NSP labels:
    every rank's mean MLM loss averages over the same count, so the mean
    of the ranks' losses is the global batch's."""
    return _test_module("torch_dist_common").bert_batch(
        cfg.vocab_size, B, DP_MP_S, DP_MP_MASKED, seed=0)


def _bert_amp_loss(pt, model, crit, arrays):
    ids, tt, mlm, nsp = (a if hasattr(a, "_data") else pt.to_tensor(a)
                         for a in arrays)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        return crit(*model(ids, tt), mlm, nsp)


def _reset_topology() -> None:
    from paddle_tpu_torch.distributed import parallel, topology

    topology.set_hybrid_communicate_group(None)
    parallel._DEFAULT_GROUP = None


def _fleet_init(dp: int = 1, mp: int = 1):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(s.hybrid_configs, dp_degree=dp, mp_degree=mp)
    return fleet.init(strategy=s)


def _sep_counts(fa) -> tuple:
    return (fa.flash_fwd_sep.launches, fa.flash_bwd_sep.launches,
            fa.flash_fwd_sep.launches_wgmma, fa.flash_bwd_sep.launches_wgmma)


def _zero_sep_counts(fa) -> tuple:
    for fn in (fa.flash_fwd_sep, fa.flash_bwd_sep, fa.flash_fwd,
               fa.flash_bwd):
        fn.launches = 0
    return _sep_counts(fa)


def _sep_step_counts(fa, before: tuple) -> dict:
    now = _sep_counts(fa)
    return {"flash_fwd_sep": now[0], "flash_bwd_sep": now[1],
            "wgmma": [now[2] - before[2], now[3] - before[3]],
            "other": fa.flash_fwd.launches + fa.flash_bwd.launches}


def _params_digest(model) -> str:
    """crc32 of every parameter's bytes, in order."""
    crc = 0
    for p in model.parameters():
        crc = zlib.crc32(p._data.detach().contiguous().view(torch.uint8)
                         .cpu().numpy().tobytes(), crc)
    return f"{crc:08x}"


def _dp_mp_bert_rank(pt, root: str, out: dict) -> None:
    """(a) BERT-base pretraining under ``fleet.distributed_model``
    (DataParallel) at dp 2, B 16 a rank, AMP O1 bf16, AdamW: the first
    step's synced gradients (rank 0 writes them), each step's launches,
    the buckets' bytes, step times and the parameters' digest after
    DP_MP_STEPS steps."""
    import os

    from paddle_tpu_torch.distributed import all_reduce, fleet
    from paddle_tpu_torch.models import bert as tb
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    hcg = _fleet_init(dp=2)
    cfg = _dp_mp_bert_cfg()
    model = tb.BertForPretraining(cfg)
    model.set_state_dict({k: pt.to_tensor(v) for k, v in torch.load(
        os.path.join(root, "bert_init.pt")).items()})
    dp = fleet.distributed_model(model)
    crit = tb.BertPretrainingCriterion(cfg.vocab_size)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=dp.parameters())
    batch = [dp.scale_batch(a) for a in _dp_mp_bert_batch(
        cfg, 2 * DP_MP_B)]
    torch.cuda.reset_peak_memory_stats()
    rec = {"kind": type(dp).__name__, "losses": [], "step_s": [],
           "launches": [], "buckets": len(dp._buckets),
           "grad_bytes": sum(p._data.numel() * p._data.element_size()
                             for p in model.parameters())}
    for i in range(DP_MP_STEPS):
        before = _zero_sep_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _bert_amp_loss(pt, dp, crit, batch)
        loss.backward()
        if i == 0 and hcg.get_data_parallel_rank() == 0:
            torch.save({n: p._data.grad.detach().cpu()
                        for n, p in model.named_parameters()},
                       os.path.join(root, "bert_grads.pt"))
        opt.step()
        opt.clear_grad()
        rec["losses"].append(loss.item())
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        rec["launches"].append(_sep_step_counts(fa, before))
    rec.update(stats=dict(dp.stats), digest=_params_digest(model),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # one all-reduce of the gradients' bytes, by itself
    flat = torch.ones(rec["grad_bytes"] // 4,
                      device=model.parameters()[0]._data.device)
    all_reduce(flat, group=dp.group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_reduce(flat, group=dp.group)
    torch.cuda.synchronize()
    rec["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
    out["bert"] = rec
    del model, dp, opt, batch, flat, loss
    gc.collect()
    torch.cuda.empty_cache()


def _timed_allreduces():
    """Wrap ``autograd_collectives._reduce``, the all-reduce of the mp
    Layers' autograd pairs (both directions), with synchronized host
    timers: returns the list of ms and the undo."""
    from paddle_tpu_torch.distributed import autograd_collectives as ac

    times, plain = [], ac._reduce

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain(x, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return y

    ac._reduce = timed
    return times, lambda: setattr(ac, "_reduce", plain)


def _gpt_amp_loss(pt, model, tok, lab):
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        return model.loss(tok, lab)


def _dp_mp_gpt_rank(pt, out: dict) -> None:
    """(b) GPT-3 1.3B of the fleet's mp Layers at mp 2 (8 of the 16 heads
    a rank), B 4, S 1024, AMP O1 bf16, through ``distributed_model`` and
    ``distributed_optimizer`` (AdamW, ClipGradByGlobalNorm): the first
    loss and clip norm, each step's launches and time, the forward +
    backward peak, the mp all-reduces' time; then every block under
    ``fleet.recompute`` from the same weights: its gradients against the
    plain first step's (BF16_TOL scaled) and its peak."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    G = _test_module("torch_mp_gpt")
    _fleet_init(mp=2)
    cfg = G.gpt3_1p3b()
    pt.seed(0)
    pm = G.build(pt, cfg)
    init = {k: v._data.detach().clone() for k, v in pm.state_dict().items()}
    model = fleet.distributed_model(pm)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(DP_MP_CLIP)))
    tok, lab = (pt.to_tensor(a) for a in G.batch(cfg, DP_MP_GPT_B))
    rec = {"kind": type(model).__name__, "losses": [], "norms": [],
           "step_s": [], "launches": [],
           "params": sum(p.size for p in pm.parameters())}
    grads = None
    for i in range(DP_MP_STEPS):
        before = _zero_sep_counts(fa)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = _gpt_amp_loss(pt, model, tok, lab)
        loss.backward()
        if i == 0:
            torch.cuda.synchronize()
            rec["fwd_bwd_peak_gib"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
            grads = {n: p._data.grad.detach().clone()
                     for n, p in pm.named_parameters()}
        opt.step()
        opt.clear_grad()
        rec["losses"].append(loss.item())
        rec["norms"].append(float(opt._inner_opt._grad_clip.last_norm))
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        rec["launches"].append(_sep_step_counts(fa, before))
    rec["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    times, restore = _timed_allreduces()
    try:
        _gpt_amp_loss(pt, model, tok, lab).backward()
    finally:
        restore()
    rec["mp_allreduce_ms"] = sum(times)
    rec["mp_allreduces"] = len(times)
    del opt, model
    pm.clear_gradients()
    del pm
    gc.collect()
    torch.cuda.empty_cache()
    # every block under fleet.recompute, from the same weights and batch
    rc = G.build(pt, cfg, recompute=True)
    rc.set_state_dict({k: pt.to_tensor(v) for k, v in init.items()})
    del init
    torch.cuda.empty_cache()
    before = _zero_sep_counts(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = _gpt_amp_loss(pt, rc, tok, lab)
    loss.backward()
    torch.cuda.synchronize()
    rec["recompute_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["recompute_launches"] = _sep_step_counts(fa, before)
    rec["recompute_loss"] = loss.item()
    rec["recompute_grad_scaled_err"] = max(
        [_scaled_err(p._data.grad.reshape(-1), grads[n].reshape(-1))[1], n]
        for n, p in rc.named_parameters())
    out["gpt"] = rec
    del rc, grads, loss
    gc.collect()
    torch.cuda.empty_cache()


def _dp_mp_small_rank(pt, out: dict) -> None:
    """(c) small fp32 cases on the card and on the CPU over the same gloo
    ranks: a BERT under DataParallel at dp 2 and the mp GPT at mp 2, 3
    AdamW steps each; each rank's largest loss (relative) and parameter
    differences card vs CPU."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert as tb

    G = _test_module("torch_mp_gpt")
    res = {}
    for case, dims in (("bert dp 2", {"dp": 2}), ("gpt mp 2", {"mp": 2})):
        runs, state = {}, None
        for where in ("cpu", "gpu:0"):
            pt.set_device(where)
            try:
                hcg = _fleet_init(**dims)
                pt.seed(3)
                if case.startswith("bert"):
                    cfg = tb.BertConfig(**BERT_SMALL)
                    model = tb.BertForPretraining(cfg)
                    crit = tb.BertPretrainingCriterion(cfg.vocab_size)
                    wrapped = fleet.distributed_model(model)
                    arrays = _test_module("torch_dist_common").bert_batch(
                        cfg.vocab_size, 4, 128, 20, seed=3)
                    batch = [wrapped.scale_batch(a) for a in arrays]

                    def loss_fn():
                        return crit(*wrapped(*batch[:2]), *batch[2:])
                else:
                    cfg = G.MPGPTConfig(**DP_MP_SMALL_GPT)
                    model = G.build(pt, cfg)
                    wrapped = fleet.distributed_model(model)
                    tok, lab = (pt.to_tensor(a) for a in G.batch(cfg, 2))

                    def loss_fn():
                        return wrapped.loss(tok, lab)
                # the CPU's draws, on the card too (the generators of the
                # two devices draw apart)
                if state is None:
                    state = {k: v._data.detach().clone()
                             for k, v in model.state_dict().items()}
                else:
                    model.set_state_dict({k: pt.to_tensor(v)
                                          for k, v in state.items()})
                if hcg.get_model_parallel_world_size() > 1:
                    assert type(wrapped).__name__ == "TensorParallel"
                opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
                    learning_rate=1e-4, parameters=model.parameters(),
                    grad_clip=pt.nn.ClipGradByGlobalNorm(DP_MP_CLIP)))
                losses = []
                for _ in range(3):
                    loss = loss_fn()
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    losses.append(loss.item())
                runs[where] = (losses, [p._data.detach().cpu()
                                        for p in model.parameters()])
            finally:
                pt.set_device("gpu:0")
        (lg, pg), (lc, pc) = runs["gpu:0"], runs["cpu"]
        res[case] = {"losses": [lg, lc], "loss_rel": max(
            abs(a - b) / abs(b) for a, b in zip(lg, lc)),
            "param_diff": max((a - b).abs().max().item()
                              for a, b in zip(pg, pc))}
    out["small"] = res


def _dp_mp_collectives(pt, out: dict) -> None:
    """(e) every collective of the port's eager API on CUDA tensors over
    the two gloo ranks, each held to its definition on the ranks' inputs
    (``ok`` or the error, by name): ``all_gather_object`` and
    ``barrier`` first, the split all-to-all with uneven splits last;
    ``send`` / ``recv`` stage through pinned host memory (counted)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.autograd_collectives import ppermute

    _fleet_init(dp=2)
    r, n = dist.get_rank(), 2
    res = {}

    def full(k, v):
        t = pt.to_tensor(np.full(k, v, np.float32))
        assert t._data.is_cuda
        return t

    def check(name, fn):
        try:
            got, want = fn()
            got = np.asarray(got.numpy() if hasattr(got, "numpy") else got)
            res[name] = "ok" if np.array_equal(got, np.asarray(want)) else \
                f"{got.tolist()} != {np.asarray(want).tolist()}"
        except Exception as e:      # recorded; the phase fails on it
            res[name] = f"{type(e).__name__}: {e}"[:300]

    def objects():
        got = []
        dist.all_gather_object(got, {"rank": r})
        return [o["rank"] for o in got], [0, 1]

    def barrier():
        dist.barrier()
        return 0, 0

    def all_reduce(op, want):
        t = full(4, r + 1.0)
        dist.all_reduce(t, op=op)
        return t, np.full(4, want, np.float32)

    def all_gather():
        lst = []
        dist.all_gather(lst, full(2, r + 1.0))
        return np.stack([t.numpy() for t in lst]), [[1, 1], [2, 2]]

    def reduce_scatter():
        return dist.reduce_scatter(full((4, 2), 1.0)).wait(), \
            np.full((2, 2), 2.0)

    def reduce():
        t = full(3, r + 1.0)
        dist.reduce(t, dst=1)
        return t, np.full(3, 3.0 if r == 1 else r + 1.0)

    def broadcast():
        t = full(3, r + 1.0)
        dist.broadcast(t, src=1)
        return t, np.full(3, 2.0)

    def scatter():
        t = full(2, 0.0)
        dist.scatter(t, [full(2, 10.0), full(2, 11.0)] if r == 0 else None,
                     src=0)
        return t, np.full(2, 10.0 + r)

    def alltoall():
        got = dist.alltoall([full(2, 10.0 * k + r) for k in range(n)]).wait()
        return np.stack([t.numpy() for t in got]), \
            np.stack([np.full(2, 10.0 * r + k) for k in range(n)])

    def send_recv():
        before = ppermute.staged_copies
        t = full(3, 5.0) if r == 0 else full(3, 0.0)
        (dist.send if r == 0 else dist.recv)(t, 1 - r)
        staged = ppermute.staged_copies - before
        return t.numpy().tolist() + [staged], [5.0] * 3 + [1]

    def isend_irecv():
        t = full(2, 7.0 + r)
        back = full(2, 0.0)
        tasks = [dist.isend(t, 1 - r), dist.irecv(back, 1 - r)]
        for task in tasks:
            task.wait()
        return back, np.full(2, 8.0 - r)

    def alltoall_single():
        x = pt.to_tensor(np.arange(4, dtype=np.float32) + 10 * r)
        return dist.alltoall_single(x).wait(), np.concatenate(
            [np.arange(2 * r, 2 * r + 2) + 10 * j for j in range(n)])

    def alltoall_uneven():
        # rank j sends i + j + 1 rows to rank i: 100 j + 10 i + arange
        ins = [i + r + 1 for i in range(n)]
        outs = [r + j + 1 for j in range(n)]
        x = pt.to_tensor(np.concatenate(
            [100 * r + 10 * i + np.arange(k) for i, k in enumerate(ins)])
            .astype(np.float32))
        got = dist.alltoall_single(x, in_split_sizes=ins,
                                   out_split_sizes=outs).wait()
        return got, np.concatenate(
            [100 * j + 10 * r + np.arange(k) for j, k in enumerate(outs)])

    check("all_gather_object", objects)
    check("barrier", barrier)
    for op, want in (("SUM", 3.0), ("MAX", 2.0), ("MIN", 1.0),
                     ("AVG", 1.5)):
        check(f"all_reduce {op}", lambda op=op, want=want: all_reduce(
            getattr(dist.ReduceOp, op), want))
    for name, fn in (("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter), ("reduce", reduce),
                     ("broadcast", broadcast), ("scatter", scatter),
                     ("alltoall", alltoall), ("send / recv", send_recv),
                     ("isend / irecv", isend_irecv),
                     ("alltoall_single", alltoall_single),
                     ("alltoall_single uneven", alltoall_uneven)):
        check(name, fn)
    torch.cuda.synchronize()
    out["collectives"] = res


def _dp_mp_worker(root: str) -> int:
    """One of phase dp_mp's two gloo ranks sharing the card: (a), (b)
    and (c) in turn; writes ``root/rank<r>.json``."""
    import os

    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_device("gpu:0")
    # fleet.init joins the launcher's world: gloo, the ranks outnumbering
    # the card
    _fleet_init(dp=2)
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    _dp_mp_bert_rank(pt, root, out)
    _dp_mp_gpt_rank(pt, out)
    _dp_mp_small_rank(pt, out)
    _dp_mp_collectives(pt, out)
    out["flash_by_plan"] = [[list(k), n]
                            for k, n in fa.LAUNCHES_BY_PLAN.items()]
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


TT_LEAF = "bert.embeddings.token_type_embeddings.weight"


def _rel(got, ref) -> float:
    """Relative Frobenius distance of ``got`` from ``ref`` (in fp64)."""
    g, r = got.double(), ref.double().to(got.device)
    return ((g - r).norm() / r.norm().clamp_min(1e-300)).item()


def _err_over(diff, mag, dim: int = -1) -> float:
    """``_scaled_err``'s measure of the error ``diff`` against the
    magnitudes ``mag``: max of |diff| / max(mag, mag's RMS along ``dim``,
    ZERO_ROW of its whole RMS)."""
    mag = mag.float()
    rms = mag.pow(2).mean(dim=dim, keepdim=True).sqrt()
    floor = ZERO_ROW * mag.pow(2).mean().sqrt().item()
    scale = torch.maximum(mag, rms).clamp_min(max(floor, 1e-30))
    return (diff.float().abs() / scale).max().item()


def _token_type_sums(g, tt, leaf) -> dict:
    """The token-type table's gradient from the bf16 gradient ``g`` that
    reached its lookup's output ([B, S, H]; ``tt`` the ids), summed
    three ways against the exact (fp64) sum: the port's leaf (``leaf``:
    the embedding's backward sums in fp32 and rounds once); torch's
    index backward on the bf16 table, adding the rows one at a time in
    bf16; and the same rows summed in fp32."""
    H = g.shape[-1]
    rows = g.reshape(-1, H)
    ids = torch.as_tensor(np.asarray(tt), device=g.device).reshape(-1)
    exact = torch.zeros(2, H, dtype=torch.float64, device=g.device) \
        .index_add_(0, ids, rows.double())
    bf16 = torch.zeros(2, H, dtype=torch.bfloat16, device=g.device) \
        .index_put_((ids,), rows, accumulate=True)
    fp32 = torch.zeros(2, H, dtype=torch.float32, device=g.device) \
        .index_put_((ids,), rows.float(), accumulate=True)
    return {"port": _rel(leaf, exact), "bf16_rows": _rel(bf16, exact),
            "fp32_rows": _rel(fp32, exact), "tokens": int(ids.numel())}


def _dp_mp_references(pt, dev, root: str) -> dict:
    """The one-rank sides: (a) BERT-base at B 32 from the weights the
    ranks load (written to ``root``), its first loss and gradients, and
    the average of the gradients of its two B 16 halves (each rank's
    rows);
    (b) GPT-3 1.3B of the mp Layers at mp 1 from the ranks' seed, its
    first loss and global gradient norm."""
    import os

    from paddle_tpu_torch.models import bert as tb

    G = _test_module("torch_mp_gpt")
    cfg = _dp_mp_bert_cfg()
    pt.seed(0)
    model = tb.BertForPretraining(cfg)
    torch.save({k: v._data.detach().cpu()
                for k, v in model.state_dict().items()},
               os.path.join(root, "bert_init.pt"))
    crit = tb.BertPretrainingCriterion(cfg.vocab_size)
    arrays = _dp_mp_bert_batch(cfg, 2 * DP_MP_B)
    refs = {}
    # the gradient reaching the token-type lookup's bf16 output
    caught = []
    hook = model.bert.embeddings.token_type_embeddings \
        .register_forward_post_hook(lambda layer, args, out: caught.append(
            out._data.register_hook(lambda g: caught.append(g.detach()))))
    loss = _bert_amp_loss(pt, model, crit, arrays)
    loss.backward()
    hook.remove()
    refs["bert_grads"] = {n: p._data.grad.detach().cpu()
                          for n, p in model.named_parameters()}
    refs["bert_loss"] = loss.item()
    model.clear_gradients()
    # the same B 32 step again: its AMP gradients are the first's, bitwise
    _bert_amp_loss(pt, model, crit, arrays).backward()
    refs["bert_rerun_bitwise"] = all(
        torch.equal(p._data.grad.detach().cpu(), refs["bert_grads"][n])
        for n, p in model.named_parameters())
    model.clear_gradients()
    refs["tt_sums"] = _token_type_sums(caught[-1], arrays[1],
                                       refs["bert_grads"][TT_LEAF])
    del caught
    halves = [{}, {}]
    for r in range(2):
        part = [a[r * DP_MP_B:(r + 1) * DP_MP_B] for a in arrays]
        _bert_amp_loss(pt, model, crit, part).backward()
        for n, p in model.named_parameters():
            halves[r][n] = p._data.grad.detach().cpu()
        model.clear_gradients()
    refs["bert_h"] = halves
    refs["bert_halves"] = {n: (g + halves[1][n]) / 2
                           for n, g in halves[0].items()}
    # the same in fp32 (AMP off): the halves' average against B 32
    def fp32_grads(part):
        ids, tt, mlm, nsp = (pt.to_tensor(a) for a in part)
        crit(*model(ids, tt), mlm, nsp).backward()
        out = {n: p._data.grad.detach().double().cpu()
               for n, p in model.named_parameters()}
        model.clear_gradients()
        return out

    b32 = fp32_grads(arrays)
    h0, h1 = (fp32_grads([a[r * DP_MP_B:(r + 1) * DP_MP_B] for a in arrays])
              for r in range(2))
    num = sum(((h0[n] + h1[n]) / 2 - g).norm().item() ** 2
              for n, g in b32.items())
    den = sum(g.norm().item() ** 2 for g in b32.values())
    refs["fp32_halves_rel"] = math.sqrt(num / den)
    refs["fp32_tt_halves_rel"] = _rel((h0[TT_LEAF] + h1[TT_LEAF]) / 2,
                                      b32[TT_LEAF])
    refs["bert_f32"] = {n: g.float() for n, g in b32.items()}
    del model, loss
    torch.cuda.empty_cache()
    _fleet_init()
    try:
        gcfg = G.gpt3_1p3b()
        pt.seed(0)
        gm = G.build(pt, gcfg)
        tok, lab = (pt.to_tensor(a) for a in G.batch(gcfg, DP_MP_GPT_B))
        loss = _gpt_amp_loss(pt, gm, tok, lab)
        loss.backward()
        sq = sum(p._data.grad.float().pow(2).sum() for p in gm.parameters())
        refs.update(gpt_loss=loss.item(), gpt_norm=sq.sqrt().item())
        del gm, loss, sq
    finally:
        _reset_topology()
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def _dp_mp_nccl_one_rank(pt, dev) -> dict:
    """(d) DataParallel over NCCL at world 1: an fp32 MLP's AdamW step
    through the wrapper (its bucket all-reduced over the NCCL world of
    one rank) bitwise the unwrapped step from the same weights."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import DataParallel, init_parallel_env
    from paddle_tpu_torch.distributed.launch import _free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        init_parallel_env()
        x = pt.to_tensor(np.random.RandomState(4).randn(64, 1024)
                         .astype(np.float32))
        params, stats = [], None
        for wrap in (False, True):
            pt.seed(4)
            net = pt.nn.Sequential(pt.nn.Linear(1024, 4096), pt.nn.GELU(),
                                   pt.nn.Linear(4096, 1024),
                                   pt.nn.LayerNorm(1024))
            model = DataParallel(net) if wrap else net
            opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=net.parameters())
            (model(x) ** 2).mean().backward()
            opt.step()
            params.append([p._data.detach().clone()
                           for p in net.parameters()])
            if wrap:
                stats = dict(model.stats)
        same = all(torch.equal(a, b) for a, b in zip(*params))
        return {"backend": dist.get_backend(), "bitwise": same,
                "stats": stats}
    finally:
        _reset_topology()
        dist.destroy_process_group()


def run_dp_mp(dev) -> dict:
    """Phase dp_mp: (a) BASELINE configuration 2, BERT-base pretraining
    under DataParallel at dp 2; (b) configuration 3, GPT-3 1.3B of the
    fleet's mp Layers at mp 2; (c) small fp32 cases card vs CPU; on two
    gloo ranks sharing the card (NCCL refuses two ranks on one device:
    the times are not a dp or mp speed); (d) DataParallel over NCCL at
    world 1. Returns the ranks' K1-sep / K3-sep launches of (a) and
    (b)."""
    import os
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.launch import launch_procs
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    pt.set_device("gpu:0")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_mp_")
    refs = _dp_mp_references(pt, dev, root)
    t0 = time.perf_counter()
    rc = launch_procs(os.path.abspath(__file__), [DP_MP_WORKER, root], 2,
                      log_dir=os.path.join(root, "logs"), timeout=400)
    wall = time.perf_counter() - t0
    if rc != 0:
        for name in sorted(os.listdir(os.path.join(root, "logs"))):
            print(open(os.path.join(root, "logs", name)).read()[-4000:])
        raise AssertionError(f"dp_mp: a rank exited {rc}")
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(2)]
    for got in ranks:
        for k, n in got["flash_by_plan"]:
            fa.LAUNCHES_BY_PLAN[tuple(k)] += n
        if got["backend"] != "gloo":
            raise AssertionError(f"dp_mp: backend {got['backend']}")
    cfg = _dp_mp_bert_cfg()
    L = cfg.num_hidden_layers
    total = collections.Counter()
    # (a)
    bert = [g["bert"] for g in ranks]
    for r, b in enumerate(bert):
        if b["kind"] != "DataParallel":
            raise AssertionError(f"dp_mp (a): wrapped as {b['kind']}")
        for i, ln in enumerate(b["launches"]):
            want = {"flash_fwd_sep": L, "flash_bwd_sep": 2 * L,
                    "wgmma": [L, 2 * L], "other": 0}
            if ln != want:
                raise AssertionError(f"dp_mp (a) rank {r} step {i}: "
                                     f"launches {ln} != {want}")
            total.update({k: ln[k] for k in ("flash_fwd_sep",
                                             "flash_bwd_sep")})
        st = b["stats"]
        if st["steps"] != DP_MP_STEPS or \
                st["allreduce_bytes"] != DP_MP_STEPS * b["grad_bytes"]:
            raise AssertionError(f"dp_mp (a) rank {r}: stats {st}, "
                                 f"gradient bytes {b['grad_bytes']}")
    if bert[0]["digest"] != bert[1]["digest"]:
        raise AssertionError(f"dp_mp (a): the ranks' parameters differ "
                             f"after {DP_MP_STEPS} steps: "
                             f"{bert[0]['digest']} vs {bert[1]['digest']}")
    loss0 = (bert[0]["losses"][0] + bert[1]["losses"][0]) / 2
    if not abs(loss0 - refs["bert_loss"]) <= \
            BERT_LOSS_RTOL * abs(refs["bert_loss"]):
        raise AssertionError(f"dp_mp (a): first loss {loss0} vs one rank "
                             f"at B 32 {refs['bert_loss']}")
    synced = torch.load(os.path.join(root, "bert_grads.pt"))
    # the synced gradients are the average of the two halves' gradients,
    # each half's taken by one rank of this process: bitwise
    for n, h in refs["bert_halves"].items():
        if not torch.equal(synced[n], h):
            raise AssertionError(f"dp_mp (a): synced gradient {n} != the "
                                 "average of the halves' gradients")
    # and the halves' average is the B 32 gradient: in fp32 to FP32_TOL
    if not refs["fp32_halves_rel"] <= FP32_TOL:
        raise AssertionError(f"dp_mp (a): fp32 halves' average vs B 32: "
                             f"{refs['fp32_halves_rel']} > {FP32_TOL}")
    if not refs["bert_rerun_bitwise"]:
        raise AssertionError("dp_mp (a): two AMP B 32 steps from the same "
                             "weights gave different gradients")
    # under AMP: the synced gradients against one rank's at B 32, by leaf
    # (relative Frobenius), within BF16_TOL or, where one rank's AMP
    # gradient is itself farther than that from the fp32 one, within
    # that distance: two AMP roundings of the global batch's gradient
    # agree as closely as AMP resolves it. AMP misses the fp32 gradient
    # by more than BF16_TOL on most leaves at this initialisation (the
    # attention backward's delta, rowsum(dO * O) from a bf16 O, cancels
    # where a deep layer's values nearly coincide, and a sum of
    # cancelling terms such as nsp.bias rounds alike): printed. Printed
    # by element too, scaled by |B 32| and by the larger of |B 32| and
    # the halves' magnitudes (a rank's gradient is its half's sum rounded
    # to bf16). The key projections' biases, 0 in exact arithmetic (the
    # softmax over keys ignores a shift common to every key), are
    # rounding on both sides: each held to BF16_TOL of the gradient's
    # largest element
    top = max(g.abs().max().item() for g in refs["bert_grads"].values())
    leaves, by_halves, by_b32 = [], [], []
    for n, g in refs["bert_grads"].items():
        if n.endswith("k_proj.bias"):
            continue
        got, ref, f32 = (t.to(dev) for t in (synced[n], g,
                                             refs["bert_f32"][n]))
        e_amp = _rel(ref, f32)
        leaves.append((_rel(got, ref), n, max(BF16_TOL, e_amp), e_amp))
        mag = torch.maximum(ref.abs(), torch.maximum(
            refs["bert_h"][0][n].to(dev).abs(),
            refs["bert_h"][1][n].to(dev).abs()))
        by_halves.append((_err_over(got - ref, mag), n))
        by_b32.append((_scaled_err(got, ref)[1], n))
    leaves, by_halves, by_b32 = (sorted(v)[::-1]
                                 for v in (leaves, by_halves, by_b32))
    amp_far = sorted(((a, n) for _, n, _, a in leaves if a > BF16_TOL),
                     reverse=True)
    kbias = max(max(synced[n].abs().max().item(), g.abs().max().item())
                for n, g in refs["bert_grads"].items()
                if n.endswith("k_proj.bias")) / top
    late = []
    over = [v for v in leaves if v[0] > v[2]]
    if over or not kbias <= BF16_TOL:
        late.append(f"dp_mp (a): synced gradients vs one rank at B 32 "
                    f"(leaf, error, bound, AMP vs fp32): {over[:4]}, key "
                    f"biases {kbias:.3e} of the largest gradient")
    tts = refs["tt_sums"]
    if not tts["port"] <= BF16_TOL:
        late.append(f"dp_mp (a): the token-type table's gradient "
                    f"{tts['port']} from its exact sum")
    tokens = 2 * DP_MP_B * DP_MP_S
    step_ms = [np.median(b["step_s"][1:]) * 1e3 for b in bert]
    print(f"dp_mp (a) BERT-base pretraining under fleet.distributed_model "
          f"(DataParallel) dp 2 x B{DP_MP_B} S{DP_MP_S}, AMP O1 bf16, "
          f"AdamW, 2 gloo ranks sharing one H100: first loss (mean of the "
          f"ranks') {loss0:.6f} vs one rank at B 32 {refs['bert_loss']:.6f} "
          f"(rtol {BERT_LOSS_RTOL}); synced gradients bitwise the average "
          f"of the two B 16 halves' gradients taken on one rank; in fp32 "
          f"that average vs B 32 {refs['fp32_halves_rel']:.3e} relative "
          f"Frobenius (tol {FP32_TOL:g}; token types "
          f"{refs['fp32_tt_halves_rel']:.3e}); under AMP vs one rank at B 32 "
          f"by leaf (relative Frobenius, within {BF16_TOL:.3e} or AMP's own "
          f"distance from fp32) median {leaves[len(leaves) // 2][0]:.3e}, "
          f"worst " + ", ".join(f"{n} {e:.3e} (bound {t:.3e})"
                                for e, n, t, _ in leaves[:3])
          + f", token types {[e for e, n, _, _ in leaves if n == TT_LEAF]}"
          f"; AMP's B 32 gradient vs fp32 over {BF16_TOL:.3e} on "
          f"{len(amp_far)} of {len(leaves)} leaves, worst "
          + ", ".join(f"{n} {a:.3e}" for a, n in amp_far[:3])
          + f"; the key biases {kbias:.3e} of the largest gradient; by "
          f"element (not held) scaled by |B 32| "
          + ", ".join(f"{n} {e:.3e}" for e, n in by_b32[:3])
          + ", by the larger of |B 32| and the halves' magnitudes "
          + ", ".join(f"{n} {e:.3e}" for e, n in by_halves[:3])
          + "; the AMP B 32 gradients bitwise on a second run; the "
          f"token-type table's gradient ({tts['tokens']} rows onto 2) vs "
          f"its exact sum: the port's {tts['port']:.3e}, torch's bf16 "
          f"index backward {tts['bf16_rows']:.3e}, an fp32 sum "
          f"{tts['fp32_rows']:.3e}; "
          f"parameters after {DP_MP_STEPS} steps bitwise equal on both "
          f"ranks (crc32 {bert[0]['digest']}); {bert[0]['buckets']} "
          f"buckets, {bert[0]['stats']['allreduce_bytes'] // DP_MP_STEPS} B "
          f"all-reduced a step = the gradients' {bert[0]['grad_bytes']} B; "
          f"step " + ", ".join(f"rank {r} {m:.1f} ms" for r, m in
                               enumerate(step_ms))
          + f" (median of steps 2-{DP_MP_STEPS}; "
          f"{tokens / (max(step_ms) / 1e3):.0f} tokens/s over both ranks); "
          f"bucket waits in the backward's callback "
          + ", ".join(f"{b['stats']['wait_ms'] / DP_MP_STEPS:.1f}"
                      for b in bert)
          + " ms a step; one all-reduce of the gradients' bytes "
          + ", ".join(f"{b['allreduce_ms']:.1f}" for b in bert)
          + " ms; peak mem " + ", ".join(f"rank {r} {b['peak_gib']:.2f} GiB"
                                         for r, b in enumerate(bert))
          + f"; losses {bert[0]['losses']} / {bert[1]['losses']}; launches "
          f"a rank a step K1-sep {L}, K3-sep {2 * L}, all wgmma")
    # (b)
    gpt = [g["gpt"] for g in ranks]
    G = _test_module("torch_mp_gpt")
    GL = G.gpt3_1p3b().n_layers
    for r, b in enumerate(gpt):
        if b["kind"] != "TensorParallel":
            raise AssertionError(f"dp_mp (b): wrapped as {b['kind']}")
        for i, ln in enumerate(b["launches"]):
            want = {"flash_fwd_sep": GL, "flash_bwd_sep": 2 * GL,
                    "wgmma": [GL, 2 * GL], "other": 0}
            if ln != want:
                raise AssertionError(f"dp_mp (b) rank {r} step {i}: "
                                     f"launches {ln} != {want}")
            total.update({k: ln[k] for k in ("flash_fwd_sep",
                                             "flash_bwd_sep")})
        want = {"flash_fwd_sep": 2 * GL, "flash_bwd_sep": 2 * GL,
                "wgmma": [2 * GL, 2 * GL], "other": 0}
        if b["recompute_launches"] != want:
            raise AssertionError(f"dp_mp (b) rank {r} recompute: launches "
                                 f"{b['recompute_launches']} != {want}")
        for key, ref_v in (("losses", refs["gpt_loss"]),
                           ("norms", refs["gpt_norm"])):
            if not abs(b[key][0] - ref_v) <= DP_MP_RTOL * abs(ref_v):
                raise AssertionError(f"dp_mp (b) rank {r}: first "
                                     f"{key[:-1]} {b[key][0]} vs mp 1's "
                                     f"{ref_v}")
        if not b["recompute_grad_scaled_err"][0] <= BF16_TOL:
            raise AssertionError(f"dp_mp (b) rank {r}: recompute gradients "
                                 f"{b['recompute_grad_scaled_err']}")
        if not b["recompute_peak_gib"] < b["fwd_bwd_peak_gib"]:
            raise AssertionError(f"dp_mp (b) rank {r}: recompute peak "
                                 f"{b['recompute_peak_gib']} not under "
                                 f"{b['fwd_bwd_peak_gib']}")
    if gpt[0]["losses"] != gpt[1]["losses"]:
        raise AssertionError(f"dp_mp (b): the ranks' losses differ")
    gms = [np.median(b["step_s"][1:]) * 1e3 for b in gpt]
    gtok = DP_MP_GPT_B * G.gpt3_1p3b().seq_len
    print(f"dp_mp (b) GPT-3 1.3B widths (hidden 2048, 24 layers, 16 heads "
          f"of 128, vocab 50304; {gpt[0]['params'] / 1e6:.1f}M parameters a "
          f"rank) of VocabParallelEmbedding / ColumnParallelLinear / "
          f"RowParallelLinear / ParallelCrossEntropy at mp 2, B{DP_MP_GPT_B} "
          f"S{G.gpt3_1p3b().seq_len}, AMP O1 bf16, AdamW with "
          f"ClipGradByGlobalNorm({DP_MP_CLIP}) through "
          f"fleet.distributed_optimizer, 2 gloo ranks sharing one H100: "
          f"first loss {gpt[0]['losses'][0]:.6f} vs mp 1 "
          f"{refs['gpt_loss']:.6f}, clip norm {gpt[0]['norms'][0]:.6f} vs "
          f"mp 1 {refs['gpt_norm']:.6f} (rtol {DP_MP_RTOL}); losses "
          f"{gpt[0]['losses']}; step "
          + ", ".join(f"rank {r} {m:.1f} ms" for r, m in enumerate(gms))
          + f" (median of steps 2-{DP_MP_STEPS}; "
          f"{gtok / (max(gms) / 1e3):.0f} tokens/s); mp all-reduces of one "
          f"forward + backward "
          + ", ".join(f"{b['mp_allreduces']} taking {b['mp_allreduce_ms']:.1f}"
                      for b in gpt)
          + " ms; forward + backward peak "
          + ", ".join(f"rank {r} {b['fwd_bwd_peak_gib']:.2f} GiB"
                      for r, b in enumerate(gpt))
          + " (step " + ", ".join(f"{b['step_peak_gib']:.2f}" for b in gpt)
          + " GiB); under fleet.recompute on every block: peak "
          + ", ".join(f"rank {r} {b['recompute_peak_gib']:.2f} GiB"
                      for r, b in enumerate(gpt))
          + ", gradients vs recompute off worst scaled error "
          + ", ".join(f"{b['recompute_grad_scaled_err'][0]:.3e} "
                      f"({b['recompute_grad_scaled_err'][1]})" for b in gpt)
          + f" (tol {BF16_TOL:.3e}); launches a rank a step K1-sep {GL}, "
          f"K3-sep {2 * GL} (recompute: K1-sep {2 * GL}), all wgmma")
    # (c)
    for r, got in enumerate(ranks):
        for case, res in got["small"].items():
            if not (res["loss_rel"] <= TRAIN_CPU_RTOL
                    and res["param_diff"] <= TRAIN_CPU_ATOL):
                raise AssertionError(f"dp_mp (c) rank {r} {case}: card vs "
                                     f"CPU {res}")
    print("dp_mp (c) small fp32, card vs CPU over the same gloo ranks: "
          + "; ".join(f"rank {r} {case} losses {res['losses'][0]} vs "
                      f"{res['losses'][1]}, params max diff "
                      f"{res['param_diff']:.3e}"
                      for r, got in enumerate(ranks)
                      for case, res in got["small"].items())
          + f" (rtol {TRAIN_CPU_RTOL:g}, atol {TRAIN_CPU_ATOL:g})")
    # (d)
    d = _dp_mp_nccl_one_rank(pt, dev)
    if not (d["backend"] == "nccl" and d["bitwise"]
            and d["stats"]["allreduce_calls"] > 0):
        raise AssertionError(f"dp_mp (d): {d}")
    print(f"dp_mp (d) DataParallel over NCCL at world 1: the wrapped AdamW "
          f"step bitwise the unwrapped one; stats {d['stats']}; the ranks' "
          f"launch to exit {wall:.1f} s")
    # (e)
    for r, got in enumerate(ranks):
        bad = {k: v for k, v in got["collectives"].items() if v != "ok"}
        if bad:
            late.append(f"dp_mp (e) rank {r}: {bad}")
    print(f"dp_mp (e) the eager collectives on CUDA tensors over the 2 gloo "
          f"ranks: " + ", ".join(f"{k} {v}" for k, v in
                                 ranks[0]["collectives"].items()))
    if late:
        raise AssertionError("; ".join(late))
    return dict(total)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; 'profile' and 'train_profile' (never by default) "
                    "run the bf16 engine and two flagship training steps "
                    "(fusion on, then off) under torch.profiler")
    args, rest = ap.parse_known_args(argv)
    if rest == [RESILIENT_WORKER]:
        return _resilient_worker()       # run_resilient's elastic children
    if len(rest) == 2 and rest[0] == PIPE_WORKER:
        return _pipe_worker(rest[1])     # run_pipe's gloo ranks
    if len(rest) == 2 and rest[0] == DP_MP_WORKER:
        return _dp_mp_worker(rest[1])    # run_dp_mp's gloo ranks
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.models.llama import llama_presets, \
        init_llama_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
          "for matmul and cuDNN")
    _build.build_all()
    print(f"built {sorted(_build.build_all())} in "
          f"{_build.last_build_seconds:.1f} s")
    kernels = {}
    t0 = t_start = time.perf_counter()
    flash_before = _flash_launch_counts()
    rpa_before = _rpa_launch_counts()

    def done(phase: str) -> None:
        nonlocal t0, flash_before, rpa_before
        now = time.perf_counter()
        if phase in FLASH_WGMMA_PHASES:
            _check_flash_variants(phase, flash_before)
        if phase in RPA_WGMMA_PHASES:
            _check_rpa_variants(phase, rpa_before)
        flash_before = _flash_launch_counts()
        rpa_before = _rpa_launch_counts()
        print(f"phase {phase}: {now - t0:.1f} s")
        t0 = now

    if "kernels" in phases:
        kernels["ragged_paged_attention"] = check_rpa(dev)
        kernels["quant_matmul"] = check_qmm(dev)
        torch.cuda.empty_cache()
        done("kernels")
    launches = {}
    if {"engine", "int8", "profile"} & set(phases):
        cfg = llama_presets("llama3-8b")
        params = init_llama_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        fp_reqs = None
        if "engine" in phases:
            fp_reqs, ln = run_engine(cfg, params, dev, False)
            launches["ragged_paged_attention"] = ln["ragged_paged_attention"]
        if "profile" in phases:
            run_engine(cfg, params, dev, False, profile=True)
        if "int8" in phases:
            q_reqs, ln = run_engine(cfg, params, dev, True)
            launches["quant_matmul"] = ln["quant_matmul"]
            if fp_reqs is not None:
                greedy = [(a.out_tokens, b.out_tokens)
                          for a, b in zip(fp_reqs, q_reqs)
                          if a.temperature == 0]
                first = sum(a[0] == b[0] for a, b in greedy)
                same = sum(x == y for a, b in greedy for x, y in zip(a, b))
                tot = sum(len(a) for a, _ in greedy)
                print(f"int8 vs bf16 greedy agreement: first token "
                      f"{first}/{len(greedy)}, all tokens {same}/{tot} "
                      "(random weights: near-flat logits)")
        del params
        torch.cuda.empty_cache()
        done("engine/int8")
    if "cpu" in phases:
        check_cuda_vs_cpu(dev)
        done("cpu")
    if "train_kernels" in phases:
        kernels["flash_fwd"], kernels["flash_bwd"] = check_flash(dev)
        torch.cuda.empty_cache()
        kernels["flash_bwd_split"], kernels["flash_bwd_sep"] = \
            check_flash_split(dev)
        torch.cuda.empty_cache()
        kernels["flash_fwd_hm"], kernels["flash_bwd_hm"] = \
            check_flash_head_major(dev)
        torch.cuda.empty_cache()
        kernels["fused_ce_fwd"], kernels["fused_ce_bwd"] = check_ce(dev)
        torch.cuda.empty_cache()
        kernels["fused_norm_epilogue"] = check_norm_epilogue(dev)
        kernels["fused_bias_act"] = check_bias_gelu(dev)
        torch.cuda.empty_cache()
        done("train_kernels")
    if "train" in phases:
        ln, on = run_train(dev)
        launches.update(ln)
        torch.cuda.empty_cache()
        _, off = run_train(dev, fused=False)
        torch.cuda.empty_cache()
        print("train fusion on vs off: step "
              f"{on['step_ms']:.2f} vs {off['step_ms']:.2f} ms, peak mem "
              f"{on['peak_gib']:.2f} vs {off['peak_gib']:.2f} GiB")
        ln, hm = run_train(dev, native=False)
        torch.cuda.empty_cache()
        for name in ("flash_fwd_hm", "flash_bwd_hm"):
            launches[name] = ln[name]
        if not abs(hm["loss0"] - on["loss0"]) <= 1e-3 * abs(on["loss0"]):
            raise AssertionError(f"train head-major: first loss "
                                 f"{hm['loss0']} vs native {on['loss0']}")
        print("train native vs head-major layout (K1/K2 vs K17): step "
              f"{on['step_ms']:.2f} vs {hm['step_ms']:.2f} ms, peak mem "
              f"{on['peak_gib']:.2f} vs {hm['peak_gib']:.2f} GiB, first "
              f"loss {on['loss0']:.6f} vs {hm['loss0']:.6f}")
        done("train")
    if "train_profile" in phases:
        for fused in (True, False):
            run_train(dev, profile=True, fused=fused)
            torch.cuda.empty_cache()
        done("train_profile")
    if "train_cpu" in phases:
        check_train_cpu(dev)
        done("train_cpu")
    if "train_13b" in phases:
        launches.update(run_train_13b(dev))
        done("train_13b")
    if "llama_train" in phases:
        launches.update(run_llama_train(dev))
        torch.cuda.empty_cache()
        done("llama_train")
    if "decode_kernels" in phases:
        kernels["decode_attention"] = check_decode_attention(dev)
        kernels["rope_flash_fwd"], kernels["flash_fwd_sep"] = \
            check_rope_flash(dev)
        kernels["swiglu"] = check_swiglu(dev)
        check_llama_norm_epilogue(dev)
        torch.cuda.empty_cache()
        done("decode_kernels")
    if "decode" in phases:
        launches.update(run_decode(dev))
        done("decode")
    if "decode_cpu" in phases:
        check_decode_cpu(dev)
        done("decode_cpu")
    if "serving_kernels" in phases:
        kernels["ragged_paged_attention_int8"] = check_rpa_int8(dev)
        kernels["lora_matmul"] = check_lora(dev)
        kernels["decode_attention_int8"] = check_decode_int8(dev)
        torch.cuda.empty_cache()
        done("serving_kernels")
    if "serving" in phases:
        launches.update(run_serving(dev))
        done("serving")
    if "paged_kernels" in phases:
        (kernels["paged_decode_attention_mxu"],
         kernels["paged_decode_attention_kernel"],
         kernels["paged_decode_attention_dma"]) = check_paged(dev)
        done("paged_kernels")
    if "paged" in phases:
        launches.update(run_paged(dev))
        done("paged")
    if "fleet" in phases:
        print(f"fleet launches {run_fleet(dev)}")
        done("fleet")
    if "rollout" in phases:
        print(f"rollout launches {run_rollout(dev)}")
        done("rollout")
    if "resilient" in phases:
        print(f"resilient launches {run_resilient(dev)}")
        done("resilient")
    if "dist" in phases:
        print(f"dist launches {run_dist(dev)}")
        done("dist")
    if "pipe" in phases:
        ln = run_pipe(dev)
        print(f"pipe launches {ln}")
        for k, n in ln.items():
            launches[k] = launches.get(k, 0) + n
        done("pipe")
    if "eager" in phases:
        print(f"eager launches {run_eager(dev)}")
        torch.cuda.empty_cache()
        done("eager")
    if "bert" in phases:
        ln = run_bert(dev)
        print(f"bert launches {ln}")
        for k in ("flash_fwd_sep", "flash_bwd_sep"):
            launches[k] = launches.get(k, 0) + ln[k]
        torch.cuda.empty_cache()
        done("bert")
    if "resnet" in phases:
        run_resnet(dev)
        torch.cuda.empty_cache()
        done("resnet")
    if "ops" in phases:
        ln = run_ops(dev)
        print(f"ops launches {ln}")
        for k in ("flash_fwd_sep", "flash_bwd_sep"):
            launches[k] = launches.get(k, 0) + ln[k]
        done("ops")
    if "dp_mp" in phases:
        ln = run_dp_mp(dev)
        print(f"dp_mp launches {ln}")
        for k in ("flash_fwd_sep", "flash_bwd_sep"):
            launches[k] = launches.get(k, 0) + ln[k]
        torch.cuda.empty_cache()
        done("dp_mp")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of phases "
          f"after the build ({_build.last_build_seconds:.1f} s)")
    if set(phases) != set(PHASES):
        print(f"phases {phases} only: no result line")
        return 0
    recs = []
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
        recs.append(rec)
    print(json.dumps({"kernels": recs}))
    # count: the cards this script drove, one
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke.json]

Phases (any failed check raises, so the run exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build the six CUDA kernels' libraries from the checkout's sources, in
     parallel and timed, with ptxas' registers, spills and warnings (no
     kernel of ``conv1d_fwd``, ``depthwise_conv1d_fwd``,
     ``conv1d_bwd_weight``, ``flash_fwd`` or ``flash_bwd`` may spill, and
     no flash or ``conv1d_bwd_weight`` kernel may have its wgmmas
     serialized); count the HGMMA (wgmma)
     instructions of each flash and each ``conv1d_bwd_weight`` kernel in
     the libraries' SASS (``cuobjdump -sass``): the 13 bf16 flash kernels
     (head_dim 64, 112, 128 and 192; at 192 the dK/dV kernel runs as a
     dV and a dK pass) and
     every ``bwd_weight_partial`` kernel (the fp32 ones run three TF32
     terms) must have some; the FFMA and LDS instructions of each
     ``conv1d_fwd`` kernel's main loop, and the instructions, HGMMA and LDS
     of each ``bwd_weight_partial`` kernel's main loop;
  2. the kernel ``conv1d_fwd`` against its plain PyTorch version on the
     card at every layer shape of the serving path (stem 1->15, conv1,
     conv2 with residual, the two 15->1 heads), at the stream-step shape
     (4 slots x chunk 4096 over a 400 + 4096 window) and at the one-shot
     causal width 60,000, in fp32; the same in bf16 at C=K=16; gelu, silu
     and SAME padding once each; two generic cases (fig5: fp32 C=K=64,
     d=1, S=25; fig6: bf16 C=K=32, d=4, S=51; batch 4 x 5,000), checked
     only.  Device times (CUDA graphs replayed between CUDA events) of the
     kernel, the plain version and ``F.conv1d`` (weights permuted to (K,
     C, S), cuDNN TF32 off) beside the least time the card could take,
     the rate (GFLOP/s), the share of the bound and the register tile the
     launch took, and the time of one call as a caller sees it (host work
     included); at the stream step also the host time of one call through
     ``ops.conv1d`` (as the server makes it) beside the bare wrapper's;
  3. serve the full ``atacworks`` config (C=K=15, S=51, d=8, 25 layers;
     seeded weights, random non-zero biases) with ``ConvStreamServer``: 4
     slots, chunk 4096, 4096-sample histories, 8 queued ragged streams of
     about 50,000 samples; both outputs of every served stream must equal
     the one-shot causal forward through the kernel bitwise, and stream 0
     the plain forward within atol=rtol=1e-4; the kernel must have
     launched 25 times per stream step.  The same streams are then served
     again SERVE_REPEATS times, so chunk p50/p99 and samples/s are read
     per run and pooled, with their spread between runs;
  4. the training path's kernels at every layer shape it runs (batch 8 x
     width 60,000, SAME, fp32: stem 1->15, conv 15->15, the 15->1 heads):
     the forward, bwd-data through ``conv1d_fwd`` (the padded cotangent
     against the flipped, transposed weights) and ``conv1d_bwd_weight``
     with and without dbias, each against its plain version, with device,
     call, plain and library times (cuDNN's gradients through
     ``torch.nn.grad``, TF32 off) beside the bound, with the rate, the
     share of the bound and the forward's tile; each bwd-weight row has
     two bounds: the three-term TF32 bound its tensor-core body answers to
     (the bytes, or three products of the unpadded (S*C, K) GEMM at 495
     TFLOP/s) and the fp32 FMA bound of the kernel it replaced,
     with the share of each; ``save_preact`` against the plain
     pre-activation (gelu, silu); bf16 at C=K=16; bwd-weight with and
     without dbias at phase 2's generic shapes (fig5, fig6; batch 4 x
     5,000), checked only; two launches of each pass bitwise equal;
  5. the whole model's gradient: the full ``atacworks`` widths at batch 2
     x width 8,192 (seeded weights, random non-zero biases): the loss and
     all 50 parameter gradients through the kernels against autograd over
     the plain version on the card, TF32 off; then 3 AdamW steps both ways,
     their losses and the parameters they leave;
  6. train ``atacworks`` through ``repro_torch.launch.train``'s own entry
     point at batch 8 x 60,000 for 10 steps: every loss finite,
     ``conv1d_fwd`` launched 49 times per step (25 forward + 24 bwd-data)
     and ``conv1d_bwd_weight`` 25 times; step p50, samples/s, and the
     kernels' device time per step against the step; then PROFILE_STEPS
     more steps under ``torch.profiler``: device time by kernel and the
     device's busy share of a step;
  7. the depthwise kernels against their plain versions at the Mamba2-370M
     conv layer of its training cell (batch 8 x 2,048, C = 2304, S = 4):
     the forward (bf16 in, bias + silu, fp32 out and preact), bwd-data
     (the padded fp32 cotangent against the flipped taps, bf16 out) and
     bwd-weight (bf16 x, fp32 cotangent) with and without dbias, two
     launches of each bitwise equal, one fp32, one residual and one
     dilation-3 case; device, call, plain and library
     (``F.conv1d(groups=C)``, ``torch.nn.grad``) times beside the bound,
     the rate (GB/s) and the share of the bound;
  8. the whole Mamba2 gradient: the full widths in an fp32 copy of the
     config cut to 2 layers (remat on), batch 2 x 512, TF32 off: the loss
     and all 12 gradients through the kernels against autograd over the
     plain version, and 3 x 2 forward and 2 bwd-weight launches;
  9. train ``mamba2-370m`` (48 layers, bf16, remat on) through
     ``repro_torch.launch.train``'s own entry point at batch 8 x 2,048 for
     4 steps: every loss and gradient norm finite, 144 depthwise forward
     launches (forward, recompute, bwd-data) and 48 bwd-weight launches a
     step; step p50, tokens/s, peak memory; then M2_PROFILE_STEPS more
     steps under ``torch.profiler``: device time of the depthwise
     kernels, the projections' matrix products, the SSD's batched
     products, the rest, and the idle time;
  10. the flash kernels against their plain versions at StarCoder2-3B's
      attention in its training cell (batch 4 x 4,096, 24 heads over 2
      KV heads of 128, bf16, causal): o, lse, dq, dk, dv, two backward
      launches bitwise equal; one fp32, one non-causal, one G = 1, one
      ragged (T = 1,000) and one head_dim 64 case (forward and backward),
      the forward with q_offset 1,024 over 2,048 keys at head_dim 64, and
      forward and backward with 1,024 queries over 2,048 keys (no offset);
      device, call, plain and library (``F.scaled_dot_product_attention``,
      a yardstick the port never calls) times beside the bound, and the
      rate each kernel reaches (the bound's flops over its time);
  11. the whole StarCoder2-3B gradient: the full widths in an fp32 copy of
      the config cut to 2 layers (remat on), batch 2 x 512, TF32 off: the
      loss and all 19 gradients through the flash kernels against
      autograd over the plain attention (``attn_impl="chunked"``), and
      2 x 2 ``flash_fwd`` and 2 ``flash_bwd`` launches;
  12. train ``starcoder2-3b`` (30 layers, bf16, remat on) through
      ``repro_torch.launch.train``'s own entry point with ``--attn-impl
      flash`` at batch 4 x 4,096 for 4 steps: every loss and gradient norm
      finite, no step skipped, 60 ``flash_fwd`` (forward and remat
      recompute) and 30 ``flash_bwd`` launches a step, peak memory under
      80 GB; step p50, tokens/s; then LM_PROFILE_STEPS more steps under
      ``torch.profiler``: device time of the flash kernels, the matrix
      products, the rest, and the idle time;
  13. the paper's Figs 4-6 grid (``repro_torch.tune.sweep``: fig4 fp32
      C=K=15 d=8, fig5 fp32 C=K=64 d=1, fig6 bf16 C=K=32 d=4; S in {5,
      25, 51} x Q in {1,000, 5,000, 20,000}; batch 4, SAME): per cell the
      forward and the forward + backward on the kernels (their own
      tiles), cuDNN (``backend="library"``, TF32 off, deterministic) and
      ``backend="auto"`` after a measured ``tune`` of the three passes
      (top 3 each) into a fresh cache; device ms (graph replay),
      GFLOP/s, efficiency against the dtype's peak, speedup over cuDNN,
      each backward pass's own time and the taps/unit race of
      ``conv1d_bwd_weight``.  Checked: the kernels' outputs within
      ``TOL`` and gradients within ``BWD_TOL`` of the plain version;
      every tile and body the kernels instantiate launched unless their
      own rule refuses it (a tile changes no forward or bwd-data bit; a
      body's dw within ``BWD_TOL``, bitwise on two launches); each
      ``"auto"`` result bitwise equal to the call with its plan pinned.
      One summary line a figure: median efficiency of kernel and cuDNN,
      the cells the kernel wins, the worst cell, ``"auto"``'s winners;
  14. serve the language models at their published widths through
      ``repro_torch.launch.serve.serve_lm`` (seeded weights, random
      non-zero biases and norms): Mamba2-370M (bf16, fp32 cache) at batch
      8 and StarCoder2-3B (bf16, bf16 cache) at batch 4, a 100-token
      prompt prefilled by sequential decode steps and 32 tokens generated
      greedily, with no kernel launched in any decode step; then the
      fused prefill step (``make_prefill_step``) on the same prompt: 48
      ``depthwise_conv1d_fwd`` launches (Mamba2), 30 ``flash_fwd``
      (StarCoder2, ``attn_impl="flash"``) and nothing else, its last
      logits within ``serve.prefill_tol`` (bf16: 2^-7 + n_layers x 2^-9
      of the largest) of the decode's at position 199, the greedy tokens
      equal in the rows whose top-2 margin is over twice that.  Decode
      step p50/p99, tokens/s, the sequential prefill's seconds, the fused
      prefill's call and device time, peak memory (the model's bytes plus
      the most the cell allocated above what it started with), the
      decode's device busy share (``torch.profiler`` over 6 steps) and a
      decode step's bound (``roofline.flops.hbm_bytes_decode`` at 3.35
      TB/s).  ``depthwise_conv1d_streaming`` at
      Mamba2's conv (8 x 2304, bf16 in, bias + silu, fp32 out) over 2,048
      columns in chunks of 1, 64 and a ragged rest: bitwise the one-shot
      causal kernel call, within DW_TOL_F32 of the plain version.  The two
      prefill kernels at the prefill's shapes against their plain versions,
      timed beside bound and library call.  A 2-layer fp32 copy of each
      model at full width: prefill against decode within 1e-4;
  15. data parallelism (``train/data_parallel.py``).  (a) DP_RANKS gloo
      ranks sharing the one card (NCCL refuses two ranks on one GPU), each
      on its half of the global batch 8 x 60,000 at the full AtacWorks
      widths (seeded weights, random non-zero biases): the loss within
      LOSS_RTOL and every gradient leaf elementwise within DP_TOL of its
      largest value against the one-process gradient at batch 8 on the
      kernels, and within LOSS_RTOL and GRAD_TOL of the one-process
      gradient through the plain version, the ranks' gradients bitwise
      equal, per rank and step 49 ``conv1d_fwd`` and 25
      ``conv1d_bwd_weight`` launches and 25 all-reduces; the same with
      ``grad_reduce_chunks=DP_CHUNKS`` (25 x DP_CHUNKS bwd-weight launches
      and all-reduces); the gradient's host-clock time per rank (gloo
      stages every reduce through the host).  The kernels at the shapes
      this path gives them (a rank's 4 x 60,000 and one chunk's 15,000
      columns) against their plain versions within BWD_TOL, timed beside
      bound and library call, and the chunk's two copies timed.
      (b) ``sharded_conv1d`` at a 15->15 layer and
      ``sharded_depthwise_conv1d`` at the Mamba2 conv layer (fp32) on two
      ranks: each rank's output rows and the summed w and bias gradients
      against the unsharded op on the kernels and through the plain
      version.  (c) the launcher over an NCCL group of
      one rank (every layer's all-reduce issued) for 10 steps beside the
      plain launcher's 10 in this call: the same losses, step p50 of
      each, and the all-reduce's device time per step from
      ``torch.profiler``;
  16. tensor parallelism (``kernels/sharded.py``, ``blocks._mp_apply``,
      the 2D ``make_sharded_grad_fn``) on atacworks-bf16 (C=K=16, S=51,
      d=8, 25 layers; atacworks' 15 does not divide over 2).  (a) one
      process, its first bf16 training on the card: the launcher 10
      steps at 8 x 60,000 (finite losses, 49 + 25 launches a step, step
      p50, samples/s) and the whole bf16 gradient at 2 x 8,192 against
      the fp32 one no further than the plain bf16 version's (twice,
      plus one bf16 rounding: TP_BF16_FACTOR, BF16_ULP); (b) two gloo
      ranks as (data 1, model 2), fp32 at the same widths, global batch
      8 x 60,000: the K-sharded forward bitwise the one-process forward,
      the gradient within BWD_TOL of the one-process kernel gradient
      (bitwise leaves counted) and GRAD_TOL of the plain one, TP_CHUNKS
      dx column ranges bitwise the unchunked gradient, a K-sharded
      16->16 layer's dx within TP_DX_TOL of the unsharded dx; (c) four
      ranks as (2, 2): within DP_TOL of the one-process gradient and
      GRAD_TOL of the plain one, chunked too, the ranks bitwise equal;
      on both layouts the bf16 gradient within TP_BF16_TOL of the
      one-process bf16 gradient, its leaves that pass no dx sum bitwise
      the data-parallel bf16 gradient, the ranks bitwise equal; (d) each
      rank's launches and collectives a gradient against the count read
      from the code (``_tp_want``); (e) the two dense kernels at the
      local shapes (forward 16->8 and 1->8, bwd-data 8->16 whole and on
      one column range with its copy, bwd-weight 16->8 and 1->8), in
      fp32 and bf16, against their plain versions, timed beside bound
      and library call, with the tile or body each takes; (f) the
      launcher with ``--model-parallel 2`` over two gloo ranks from
      torchrun's variables, 5 steps, its first TP_LAUNCH_HELD losses
      within TP_LAUNCH_RTOL of the one-process launcher's; (g)
      ``model_sharded_depthwise_conv1d`` at
      the Mamba2 conv layer over the two ranks, bitwise the unsharded
      kernel, no model collective;
  17. telemetry (``repro_torch.obs``; ``telemetry_check``): (a) the
      AtacWorks training cell 6 steps through the launcher without and
      with ``--telemetry``: losses and gradient norms bitwise equal, 49 +
      25 launches a step (plus the probe cell's), 25 / 24 / 25 pass spans
      a step timed by CUDA events, each within (0, 1.05] of its peak, no
      15->15 span shorter than 0.9 x phase 4's device time of its pass,
      the step phases, clean monitor rollups, ``report.check`` == [] and
      a trace export; (b) 2 served streams bitwise equal with telemetry
      on, a ``serve.conv.chunk`` span a step, ``check_serving`` == [];
      (c) a fig4 problem tuned into a fresh cache: candidate events and a
      cache hit; (d) the ``--model-parallel 2`` launcher on two gloo
      ranks sharing one log: ``check_model_parallel`` == [], both pids;
      (e) the disabled hooks' cost and a stream step's 25 ``ops.conv1d``
      calls' host time beside phase 2's;
  18. the elastic drill (``elastic_check``): 4 gloo ranks sharing the
      card train the full atacworks config at a global 8 x 60,000
      through the supervisor of ``launch/train.py``: uninterrupted;
      ``device_loss@5:2`` (dp 4 -> 2, accumulation 1 -> 2, restore step
      4, with telemetry and ``check_elastic`` == []); ``preempt@5`` then
      ``--resume``; ``straggle@5:1x6`` over 14 steps (launch rank 1
      rotated out, launch rank 3 idle).  The losses before a restore
      point and after a same-layout resume bitwise the uninterrupted
      run's, the replay within JAX's cross-mesh bound, the final
      parameters by phase 5's rule; 49 + 25 launches a rank a
      microbatch step; the detect and restore times, the step medians
      before and after, ``post_shrink_efficiency`` and the phase's
      seconds are printed;
  19. Whisper-large-v3 at its published widths (``whisper_check``; 32 +
      32 layers, d_model 1280, 20 heads of 64, bf16, flash), built once:
      (a) the conv frontend on mel (8, 128, 3,000) through the kernels
      (2 ``conv1d_fwd`` launches) against the plain version, each
      element within TOL; 128 -> 1280 and 1280 -> 1280 (S=3, bias +
      gelu) each checked and timed beside ``F.conv1d`` and the bound;
      the frontend's fp32 gradient at 1 x 3,000 (4 ``conv1d_fwd``, and
      ``conv1d_bwd_weight`` once a channel range that fits its shared
      memory) within BWD_TOL, and ``conv1d_bwd_weight`` at both layers
      timed beside ``torch.nn.grad.conv1d_weight`` and the bound; (b) ``serve_lm`` at batch
      8, a 4-token prompt, 32 generated tokens, ``--smoke``: 32
      ``flash_fwd`` launches in ``fill_cross_cache``, 64 in the fused
      prefill, none in the decode steps, finite logits, the prefill
      within ``serve.prefill_tol`` of the decode; encode time, decode
      p50/p99, tokens/s, peak memory, the decode bound; (c) the launcher
      3 steps at batch 4 x 448 (128 + 64 flash launches a step, finite,
      none skipped; step p50, tokens/s, useful TFLOP/s, peak memory),
      BREAKDOWN_STEPS more steps traced (``_train_breakdown``: the
      device time of the flash kernels, the matrix products, the sorts
      and gathers, AdamW and the rest, and the idle time),
      then a 2 + 2-layer fp32 copy's whole gradient over 1,500 frames
      against plain attention; (d) both flash kernels at the encoder's
      attention (1,500 frames, G = 1, hd 64, non-causal) against plain,
      timed beside SDPA and the bound; the phase's seconds;
  20. Zamba2-7B at its published widths (``zamba2_check``; 81 Mamba2
      layers, d_model 3584, conv over 7,296 channels, one shared
      attention block of 32 heads over 32 KV heads of 112 applied 13
      times, bf16, flash): (a) the depthwise kernels at (4, 7,296, 4,096)
      by phase 7's rule and the flash kernels at (4, 4,096, 32 heads of
      112, causal) in bf16 and at a small shape in fp32 by phase 10's,
      timed beside the library call and the bound; (b) ``serve_lm`` on
      the config cut to 12 layers (two applications of the shared block)
      at batch 8, a 100-token prompt, 32 generated
      tokens, ``--smoke``: 12 ``depthwise_conv1d_fwd`` and 2 ``flash_fwd``
      launches in the fused prefill, none in the decode steps, finite
      logits, the prefill within ``serve.prefill_tol`` of the decode;
      decode p50/p99, tokens/s, prefill times, peak memory, the decode's
      busy share and bound; (c) the launcher 3 steps on the config cut to
      12 layers (``zamba2-7b-12l``, registered here) at batch 4 x 4,096
      (36 + 12 depthwise and 4 + 2 flash launches a step; step p50,
      tokens/s, useful TFLOP/s, peak memory), BREAKDOWN_STEPS more steps
      traced (as phase 19), then its fp32 copy's whole gradient at 1 x
      512 against the plain attention and conv; the phase's seconds;
  21. Moonlight-16B-A3B at its published widths (``moonlight_check``; 48
      layers, d_model 2048, the first dense (d_ff 11,264), 47 MoE layers
      of 64 routed experts top-6 by sigmoid scores (d_ff 1,408) and 2
      shared, 16 heads over 16 KV heads of 128, bf16, flash): (a) the
      flash kernels at (4, 4,096, 16 heads of 128, G = 1, causal) in bf16
      and at a small shape in fp32 by phase 10's rule, timed beside SDPA
      and the bound; (b) ``serve_lm`` on the config cut to 6 layers
      (``moonshot-v1-16b-a3b-6l-serve``, registered here: the dense layer
      and 5 MoE layers) at batch 8, a 100-token prompt, 32 generated tokens,
      ``--smoke``: the fused prefill within ``serve.prefill_tol`` of the
      decode with the decode's expert selection replayed, its own
      selection's flips per layer reported, 12 ``flash_fwd`` launches a
      fused prefill and none in the decode steps, finite logits; decode
      p50/p99, tokens/s, prefill times, peak memory, the syncs of a
      decode step, the decode's busy share and its bound two ways (the
      weights a token uses, and the experts the batch's selections
      touch); (c) the
      launcher 3 steps on the config cut to 6 layers
      (``moonshot-v1-16b-a3b-6l``, registered here, the streamed
      cross-entropy over 1,024-position chunks) at batch 4 x 4,096 (12 +
      6 flash launches a step; step p50, tokens/s, useful TFLOP/s, peak
      memory), BREAKDOWN_STEPS more steps traced (as phase 19, with the
      MoE FFNs' own time), then its fp32 copy's whole gradient at 1 x 512
      against the plain attention, both paths' expert selections equal
      first (a flip fails), and the syncs of one gradient; the phase's
      seconds;
  22. DeepSeek-V3's Multi-head Latent Attention at its published widths
      (``deepseek_check``; d_model 7,168, 128 heads, q_lora 1,536,
      kv_lora 512, q and k heads of 128 + 64, v heads of 128, 256 routed
      experts top-8 by sigmoid scores and 1 shared, bf16, flash): (a) the
      flash kernels at head_dim 192, v padded from 128 as the MLA block
      pads it, at (4, 4,096, 128 heads, G = 1, causal) in bf16 and at a
      small shape in fp32 (padded v, and v of 192 real columns) by phase
      10's rule, timed beside SDPA on the same q, k and padded v and the
      bound of the useful work; (b) ``serve_lm`` on the config cut to 4
      layers (``deepseek-v3-671b-4l``, registered here: the 3 dense
      layers and 1 MoE layer of all 256 experts) at batch 8, phase 21's
      traffic and checks (4 ``flash_fwd`` a fused prefill, none in a
      decode step), then the absorbed decode (``make_serve_step(absorb=
      True)``) against the plain one on the same cache and tokens with
      the plain decode's selection replayed, within
      ``serve.prefill_tol``, no kernel launched; (c) the launcher 3 steps
      on the config cut to 2 layers of 16 routed experts
      (``deepseek-v3-671b-2l-16e``, registered here; streamed
      cross-entropy) at batch 4 x 4,096 (4 + 2 flash launches a step),
      BREAKDOWN_STEPS more steps traced, then its fp32 copy's whole
      gradient at 1 x 512 against the plain attention, both paths' expert
      selections equal first; the phase's seconds;
  23. InternVL2-2B, the VLM family, at its published widths and full
      depth (``vlm_check``; 24 layers, d_model 2,048, 16 query heads over
      8 KV heads of 128, 256 image embeddings before the text, bf16,
      flash): (a) the flash kernels at its training shape (4, 4,096, 16
      over 8 heads of 128, G = 2, causal) and its image prefill's (8,
      356: 256 + 100, ragged against the tile) in bf16, and at a small
      shape in fp32, by phase 10's rule, timed beside SDPA and the bound;
      (b) ``serve_lm`` at batch 8, phase 14's traffic (text decode, no
      kernel in a decode step), the fused text prefill within
      ``serve.prefill_tol`` of the decode (24 ``flash_fwd``), then the
      fused prefill of the prompt behind 256 seeded image embeddings
      through flash against the same prefill with ``attn_impl="chunked"``
      within ``serve.prefill_tol`` (24 ``flash_fwd``), and a 2-layer fp32
      copy at full width checked both ways; (c) the launcher 3 steps at
      batch 4 x 4,096 (48 + 24 flash launches a step; step p50, tokens/s
      counting the image positions, useful TFLOP/s, peak memory),
      BREAKDOWN_STEPS more traced; (d) a 2-layer fp32 copy's whole
      gradient at 2 x 512 (256 image + 256 text positions) against the
      plain attention; (e) the ``"dots"`` remat policy against
      ``"nothing"`` at full depth, batch 2 x 4,096: the launcher 2 steps
      each (losses and gradient norms bitwise equal) and every gradient
      of one batch bitwise equal, with each policy's peak memory and step
      time; the phase's seconds;
  24. tensor-parallel serving (``tp_serve_check``; ``serve
      --model-parallel 2``, ``models/sharding.py``'s blocks): ``flash_fwd``
      at a rank's prefill shapes (StarCoder2-3B's (8, 24, 1 KV head, G
      12, 128); DeepSeek-V3's 64 MLA heads of 192, v padded from 128;
      Zamba2-7B's 16 heads of 112; Whisper's encoder, (8, 1,500, 10
      heads of 64), non-causal) timed beside SDPA and the bound, and
      ``depthwise_conv1d_fwd`` at a rank's (8, channels, 24) (Mamba2-370M's
      1,280, Zamba2-7B's 3,712: the rank's x channels and B and C whole)
      beside ``F.conv1d`` and the bound; one process serves StarCoder2-3B
      (cut to 12 layers; phase 14 serves all 30), DeepSeek-V3's
      ``deepseek-v3-671b-2l-16e`` (recording its expert selection),
      Mamba2-370M (48 layers), Zamba2-7B's 12-layer cut and
      Whisper-large-v3 (cut to 8 + 8 layers, a 4-token prompt), each in
      bf16 at batch 8, a 24-token prompt (DeepSeek-V3: 200) and 8
      generated tokens, and each one's fp32 copy at a 24-token prompt at
      most (StarCoder2's drawn, the others the bf16 weights cast and cut
      to 2 layers, Zamba2's to 6); 2 gloo ranks start up meanwhile, then
      serve each on the card through the launcher from
      torchrun's variables, each reading the model the one process drew
      back from its saved state dict on the host and keeping its blocks:
      each rank's logits at the prompt's last position within
      ``serve.prefill_tol`` (fp32: 1e-5) of the one process's largest
      logit, greedy tokens equal where the margin is clear, the ranks'
      logits and tokens bitwise equal, each rank's kernel launches and
      input shapes (``_ts_want``: 12 ``flash_fwd``, StarCoder2's; 4,
      DeepSeek-V3's replayed and free prefill; 48 ``depthwise_conv1d_fwd``,
      Mamba2's; 12 and 2, Zamba2's; 8 ``flash_fwd`` a Whisper
      ``fill_cross_cache`` and 16 a fused prefill) and none in a decode
      step; DeepSeek-V3's decode with the one process's selection
      replayed, then free (its flips reported, its selections bitwise
      equal across the ranks), and its absorbed decode on a rank over
      the prompt's first 16 positions; decode
      p50/p99, tokens/s, a rank's peak memory, weights and cache bytes,
      the collectives a step and their host time; the phase's seconds;
  25. FSDP training of the language models (``fsdp_check``; the JAX
      launcher's placement on a (dp, 1) mesh): ``flash_fwd`` and
      ``flash_bwd`` at a rank's StarCoder2-3B attention (2 x 4,096, 24
      heads over 2 KV heads of 128, bf16, causal) and both depthwise
      kernels at a rank's Mamba2-370M layer (4 x 2,304 x 2,048) against
      their plain versions, timed beside the library and the bound; one
      process trains StarCoder2-3B cut to 4 layers (bf16, flash, remat;
      phase 12 trains all 30) at 4 x 4,096 and Mamba2-370M (48 layers) at
      8 x 2,048 through the launcher, 3 steps each; then 2 gloo ranks on
      the card do the same FSDP through the launcher from torchrun's
      variables, reading the one process's draws: (a) the first step's
      gradient blocks bitwise those of the whole-parameter data-parallel
      path on the same ranks and batch, (b)
      the first loss within 1e-3 of the one process's, (c) each later one
      within FS_LATER_RTOL, (d) an fp32 copy (the bf16 weights cast, cut
      to 2 layers; 2 steps at 2 x 512, TF32 off) trained FSDP within 1e-5
      of the largest parameter of the same copy trained in one process on
      the rank, (e) a rank's
      parameter and moment bytes its blocks' (about half the one
      process's), (f) each rank's kernel launches a step (8 + 4 flash,
      144 + 48 depthwise) and its gathers and scatters (2 x layers + the
      tables', layers + the tables'); step p50, tokens/s a rank, peak
      memory against the one process's, the collectives' host seconds;
  26. serving on the JAX serve launcher's (world / mp, mp) host mesh
      (``dp_serve_check``; the parameters FSDP-placed on 'data', the
      batch and cache on 'data'): ``flash_fwd`` at a data row's
      StarCoder2-3B prefill (4 x 4, 2 KV heads at (2, 1), 1 at (2, 2), G
      12, 128) and ``depthwise_conv1d_fwd`` at a data row's Mamba2-370M
      prefill (4 x 2,304 x 4) against their plain versions, timed beside
      SDPA and ``F.conv1d`` and the bound; one process serves
      StarCoder2-3B cut to 2 layers (bf16, flash) and Mamba2-370M (48
      layers) at batch 8 over 4 + 4 tokens, and each one's fp32 copy (the
      bf16 weights cast, 2 layers) over 2 + 2; then gloo ranks on the
      card serve each through the launcher from torchrun's variables, as
      (2, 1) on 2 ranks (both models) and as (2, 2) on 4 (StarCoder2-3B):
      the fp32 copies' logits within 1e-5 of the one process's largest
      logit and their tokens equal, the bf16 runs' within
      ``serve.prefill_tol`` (tokens equal where the margin is clear), the
      ranks bitwise equal, a rank's weight bytes its blocks', a decode
      step's data gathers (one a layer and the tables: 3 StarCoder2, 50
      Mamba2) and model sums, each data row's fused prefill (``--smoke``)
      launching 2 ``flash_fwd`` or 48 ``depthwise_conv1d_fwd`` at its
      rows' shapes and no decode step launching any; a rank's decode
      p50/p99, tokens/s, gathers a step and their host seconds, weights
      and peak memory beside the one process's;
  27. tensor-parallel serving where the heads or KV heads do not divide
      the model axis (``head_layouts_check``; ``sharding.head_blocks``'
      head-aligned blocks): ``flash_fwd`` at each new rank prefill shape
      (Qwen2-7B's G 4 and 3 at 8 x 8, StarCoder2-3B's G 6 at a (2, 4)
      data row's 4 x 8, Whisper-large-v3's encoder on 3 and 2 heads of
      64 over 8 x 1,500 frames and its decoder at 8 x 4) against its plain
      version, timed beside SDPA and the bound; one process serves
      Qwen2-7B and StarCoder2-3B cut to 2 layers and Whisper-large-v3 cut
      to 2 + 2 (bf16, flash, every width; batch 8 over 8 + 4 tokens,
      Whisper 4 + 4) and each one's fp32 copy (the bf16 weights cast;
      batch 2 over 4 + 2) and saves both draws; then one world of 8 gloo
      ranks on the card serves each (once its draws are saved) through
      the launcher from torchrun's variables, Qwen2-7B and Whisper as (1,
      8) (a KV head on 2 ranks, 4 and 3 query heads a rank; 3, 3, 3, 3,
      2, 2, 2, 2 heads),
      StarCoder2-3B as (2, 4) (a KV head on 2 ranks of a data row, 6 query
      heads a rank): the fp32 copies' logits within 1e-5 of the one
      process's largest logit and their tokens equal, the bf16 runs'
      within ``serve.prefill_tol`` (tokens equal where the margin is
      clear), the ranks bitwise equal, a rank's weight bytes exactly its
      head-aligned blocks (its replicated KV heads' columns included) and
      its cache bytes those of its heads, the collectives a decode step,
      each fused prefill (``--smoke``) launching one ``flash_fwd`` a layer
      at the rank's heads (Whisper's ``fill_cross_cache`` one an encoder
      layer) and no decode step launching any; a rank's decode p50/p99,
      tokens/s and peak memory beside the one process's;
  28. the dry-run against the card (``dryrun_check``): one rank, the
      origin, of StarCoder2-3B (bf16, flash) and Mamba2-370M cut to 2
      layers at ``prefill_32k`` on the (16, 16) production mesh
      (``launch/specs.py build_cell``: 2 rows of 32,768 tokens; 2 query
      heads over 1 KV head of 128, or 384 conv channels), counted on the
      meta device by ``launch/dryrun.py``, then run on the card with its
      blocks drawn there over counting groups: each kernel's launches
      equal to the count, the parameter bytes exactly the count's, the
      peak allocated within 20% of the predicted arguments plus the peak
      beyond them, the logits finite; the step's time beside the
      roofline terms (reported); ``flash_fwd`` at that rank's 2 x 32,768
      (G 2, 128) against its plain version taken 4,096 queries at a time,
      and ``depthwise_conv1d_fwd`` at 2 x 384 x 32,768 against its plain
      version, timed beside SDPA and ``F.conv1d`` and the bound;
  29. the seconds of each phase, a JSON line of the six kernels, the
      card's line, and last the result line.

Exits non-zero without printing a result when there is no CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The least time of a call (the H100 SXM's published peaks, stated against
# the card's power limit): the larger of its bytes over HBM bandwidth and
# its operations over the peak of their type (repro_torch.roofline).
from repro_torch.roofline import analysis as roofline  # noqa: E402
# outputs |kernel - plain| <= atol + rtol * |plain| per dtype (TOL); the
# backward passes max|kernel - plain| <= BWD_TOL * max|plain|; one copy,
# with the sweep that holds Figs 4-6 to them (its comment says why)
from repro_torch.tune.sweep import BWD_TOL, TOL  # noqa: E402
# whole model: each of the 50 gradients within GRAD_TOL * max|plain| of
# autograd over the plain version (25 layers of fp32 sums taken in another
# order, the errors carried through the chain), the loss within LOSS_RTOL
GRAD_TOL, LOSS_RTOL = 1e-3, 1e-5
# after GRAD_STEPS AdamW steps (lr ADAMW_LR) both ways: the losses within
# LOSS_RTOL, and the parameters within PARAM_ATOL, except that AdamW's
# first updates are sign-like (about lr each), so an element whose
# gradient lies within the gradients' error of zero may step the other
# way: at most PARAM_FLIP_FRAC of all elements may differ by more
ADAMW_LR, PARAM_ATOL, PARAM_FLIP_FRAC = 3e-4, 1e-5, 1e-4

MAIN_SHAPE = "conv1 b+relu 15->15 stream"  # the row the kernels line reports
DEVICE = "cuda"

# the serving cell: 4 slots x chunk 4096, 4096-sample histories, 8 queued
# streams of 50,000 + U[0, 4096) samples (more streams than slots, ragged)
SLOTS, CHUNK, PROMPT_LEN, STREAMS, TRACK_LEN = 4, 4096, 4096, 8, 50000
SERVE_REPEATS = 5  # timed runs after the checked one

# the training cell: batch 8 x width 60,000 (paper §4.2), 10 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 60000, 10
# the whole-model gradient check: full widths at batch 2 x 8,192
GRAD_BATCH, GRAD_SEQ, GRAD_STEPS = 2, 8192, 3
PROFILE_STEPS = 4  # training steps traced by torch.profiler after the run

# the Mamba2-370M conv layer of the training cell: batch 8 x 2,048,
# conv_dim 2304 (d_inner 2048 + 2 x d_state 128), conv width 4
DW_BATCH, DW_SEQ, DW_CHANNELS, DW_TAPS = 8, 2048, 2304, 4
# depthwise kernels vs plain: max|kernel - plain| <= tol * max|plain|.
# fp32 results: sums of S products, or of 16,384 per channel for the
# weight gradient, in another order; bf16 results: one bf16 rounding
DW_TOL_F32, DW_TOL_BF16 = 1e-5, 2.0 ** -7
# the whole Mamba2 gradient: the full widths in fp32, 2 layers, batch 2 x
# 512; the loss within LOSS_RTOL, each gradient within GRAD_TOL of its
# leaf's largest value (as for AtacWorks)
M2_GRAD_LAYERS, M2_GRAD_BATCH, M2_GRAD_SEQ = 2, 2, 512
# the Mamba2-370M training cell: batch 8 x 2,048 (the Mamba-2 paper's
# pretraining context), 4 steps; then M2_PROFILE_STEPS traced (the
# trace's processing on the host, about 14 s a step, sets the count)
M2_BATCH, M2_SEQ, M2_STEPS, M2_PROFILE_STEPS = 8, 2048, 4, 1

# StarCoder2-3B's attention in its training cell: batch 4 x 4,096, 24
# query heads over 2 KV heads (G = 12) of 128, bf16, causal
FA_B, FA_T, FA_KV, FA_G, FA_HD = 4, 4096, 2, 12, 128
# flash kernels vs plain.  fp32 results: max|kernel - plain| <= FA_TOL_F32
# * max|plain|, since dk and dv sum up to 4,096 x 12 = 49,152 terms in
# another order, whose rounding alone is sqrt(n) x 2^-24, about 1e-5 of
# the largest value; lse (one log-sum-exp per row, fp32 in both dtypes)
# within FA_TOL_LSE of the largest.  bf16 results, each element against
# its own value: |kernel - plain| <= FA_RTOL_BF16 * |plain| + FA_ATOL_BF16
# * max|plain|.  Both sides round fp32 values that differ only in
# summation order once to bf16 (to nearest even), so they differ by at
# most one bf16 ulp, 2^-7 of the value, plus the fp32 difference (about
# 1e-5 of the largest value), which the atol covers many times over.  A
# bound held per element also holds the late causal rows, whose values
# are 50 to 100 times smaller than the first rows'.
FA_TOL_F32, FA_TOL_LSE = 1e-4, 1e-5
FA_RTOL_BF16, FA_ATOL_BF16 = 2.0 ** -7, 1e-3
# the whole StarCoder2-3B gradient: the full widths in fp32, 2 layers,
# batch 2 x 512; the loss within LOSS_RTOL, each gradient within GRAD_TOL
# of its leaf's largest value (as for AtacWorks and Mamba2)
LM_GRAD_LAYERS, LM_GRAD_BATCH, LM_GRAD_SEQ = 2, 2, 512
# the StarCoder2-3B training cell: batch 4 x 4,096 (its pretraining
# context), 4 steps; then LM_PROFILE_STEPS traced
LM_BATCH, LM_SEQ, LM_STEPS, LM_PROFILE_STEPS = 4, 4096, 4, 1
LM_MEMORY_LIMIT_GB = 80.0
# phase 14, LM serving at the published widths: Mamba2-370M at batch 8
# and StarCoder2-3B at batch 4 (its flash prefill), a 100-token prompt
# (not a multiple of the SSD chunk or the flash tile) and 32 generated
# tokens (phases 19-23 serve the same traffic); the decode's busy share
# traced over 2 + 5 - 1 steps; a 2-layer fp32 copy of each at batch 2;
# Mamba2's conv streamed over 2,048 columns
# (16 chunks of 1, then chunks of 64, then the ragged rest)
M2_SERVE_BATCH, SC2_SERVE_BATCH, LM_PROMPT, LM_GEN = 8, 4, 100, 32
LM_TRACE_PROMPT, LM_TRACE_GEN = 2, 5
LM_FP32_LAYERS, LM_FP32_BATCH = 2, 2
STREAM_SEQ, STREAM_ONES, STREAM_CHUNK = 2048, 16, 64
# the paper's Figs 4-6 sweep: graph replays per timing (cut these, never
# the cells, if the phase runs long); the tuner times every candidate
SWEEP_ITERS = 1
# phase 15, data parallelism: DP_RANKS gloo ranks on the one card, the
# global batch DP_BATCH x DP_SEQ split between them; each gradient leaf
# elementwise within DP_TOL of its largest value against the one-process
# gradient (the weight gradients sum 480,000 products a element, half of
# them on each rank, the two halves added after the all-reduce: fp32
# rounding in another order, and BWD_TOL's bound for the same sums);
# and within GRAD_TOL (as phase 5) of the one-process gradient through the
# plain version; DP_TIMED timed gradients a rank after the counted one; the
# kernels at a rank's local batch and one chunk's width against their plain
# versions within BWD_TOL (as phase 4); the launcher over
# one NCCL rank for DP_NCCL_STEPS steps, DP_PROFILE_STEPS more traced
DP_RANKS, DP_BATCH, DP_SEQ, DP_CHUNKS, DP_TIMED = 2, 8, 60000, 4, 3
DP_TOL = 1e-4
DP_NCCL_BACKEND, DP_NCCL_STEPS, DP_PROFILE_STEPS = "nccl", 10, 4
# phase 16, tensor parallelism, on atacworks-bf16 (C=K=16, paper §4.4):
# atacworks' C=K=15 does not divide over TP_MP = 2 model ranks (the JAX
# launcher refuses it too).  (a) The one-process bf16 gradient through the
# kernels is held to the fp32 gradient of the same bf16-valued weights and
# inputs: per leaf, its distance from it within TP_BF16_FACTOR times that
# of the plain bf16 gradient plus BF16_ULP of the leaf's largest value,
# one bf16 rounding.  Every path rounds every layer's output to bf16, the
# kernel's bf16 forward lands on the other bf16 neighbour of the plain
# value in a few outputs (phase 16's bf16 rows count them), and 25 layers
# at init carry those steps into every gradient: on an H100 80GB HBM3 at
# 700 W the plain bf16 gradient itself sits 4.4e-2 of the largest value
# from the fp32 one at res.0.conv1.w (2 x 8,192), so no fixed bound
# between the two bf16 paths is safe.  (b, c) The K-sharded bf16
# gradient on (1, 2) and (2, 2) is held to the one-process bf16 gradient
# through the kernels: each leaf within TP_BF16_TOL of its largest value,
# the JAX package's bound for its sharded bf16 gradients
# (tests/test_model_parallel.py, test_8dev_ksharded_grads); they differ
# where a dx summed over the model group in another order rounds to the
# other bf16 neighbour (6.2e-3 at worst on (1, 2) at 8 x 60,000, same
# card).  Its leaves whose cotangent passes no dx sum (TP_NO_DX_SUM) are
# bitwise the data-parallel bf16 gradient on the same data group: the
# sums follow JAX's order, the fp32 data sum, one cast, then the exact
# model sum of zero-padded blocks.  A K-sharded layer's dx, whose K
# contraction is split over the ranks and summed, within TP_DX_TOL of its
# largest value (fp32 sums of 16 x 51 products in another order).
# TP_CHUNKS dx column ranges; a rank's gradient timed TP_TIMED times after
# the counted one.  (f) The launcher over TP_MP gloo ranks runs
# TP_LAUNCH_STEPS steps; its first TP_LAUNCH_HELD losses are held within
# TP_LAUNCH_RTOL (relative) of the one-process launcher's.  Step 0 is the
# same forward; steps 1 and 2 start from weights moved by bf16 gradients
# that differ as in (b) and read 0 and 1.6e-5 on that card.  From step 3
# the bf16 model's gradient norm, 18.7 at step 0, reaches 1,710 by step 4
# and the two trajectories part (7.2e-4 at step 3, 9.8e-4 at step 4):
# those steps are reported, not held.
TP_ARCH, TP_MP, TP_CHUNKS, TP_TIMED = "atacworks-bf16", 2, 4, 2
TP_BF16_FACTOR, BF16_ULP, TP_DX_TOL = 2.0, 2.0 ** -8, 1e-5
TP_BF16_TOL = 3e-2
TP_NO_DX_SUM = ("res.10.conv2.w", "res.10.conv2.b", "head_signal.w",
                "head_signal.b", "head_peak.w", "head_peak.b")
TP_LAUNCH_STEPS, TP_LAUNCH_HELD, TP_LAUNCH_RTOL = 5, 3, 1e-4
# phase 17, telemetry on the card (repro_torch.obs): the training cell
# TEL_STEPS steps with and without --telemetry; every pass span of the
# batch-8 cells within (0, TEL_EFF_MAX] of its peak, and no 15->15 span
# shorter than TEL_DUR_MIN x phase 4's graph-replayed device time of its
# pass (a span brackets the pass's kernels on the stream, so it can only
# be longer, up to replay-to-replay noise); TEL_STREAMS streams served;
# the tensor-parallel launcher over TP_MP gloo ranks at TEL_TP_BATCH x
# TEL_TP_SEQ for TEL_TP_STEPS steps; disabled hooks timed over
# TEL_HOOK_CALLS calls
TEL_STEPS, TEL_EFF_MAX, TEL_DUR_MIN, TEL_STREAMS = 6, 1.05, 0.9, 2
TEL_TP_BATCH, TEL_TP_SEQ, TEL_TP_STEPS, TEL_HOOK_CALLS = 2, 8192, 2, 20000
# phase 18, the elastic drill (runtime/elastic, runtime/faults, the
# supervisor in launch/train.py): EL_RANKS gloo ranks sharing the card
# train the full atacworks config at a global EL_BATCH x EL_SEQ for
# EL_STEPS steps (the straggle drill EL_STRAGGLE_STEPS; cut those, never
# the widths, if the phase runs long).  A recovery's replayed steps run
# dp 2 x accum 2 where the uninterrupted run ran dp 4: the same sums in
# another fp32 order, held with JAX's cross-mesh bound (losses within
# EL_RTOL and EL_ATOL, tests/test_elastic_drill.py) and phase 5's rule
# for the parameters (PARAM_ATOL, PARAM_FLIP_FRAC)
EL_RANKS, EL_BATCH, EL_SEQ, EL_STEPS, EL_STRAGGLE_STEPS = 4, 8, 60000, 10, 14
EL_RTOL, EL_ATOL = 1e-3, 1e-4
# phase 19, Whisper-large-v3 (arXiv:2212.04356) at its published widths,
# built once in bf16 with attn_impl="flash" (random non-zero biases and
# norms) and reused.  (a) The conv frontend on seeded mel (WH_MEL_BATCH,
# 128, WH_MEL_T: 30 s of audio) through the kernels against the plain
# version, each bf16 element within TOL (as phase 16's bf16 rows), each
# of its two convolutions timed; its gradient in fp32 at WH_GRAD_MEL_BATCH
# x WH_MEL_T within BWD_TOL (as phase 4).  (b) ``serve_lm`` at batch
# WH_SERVE_BATCH, a WH_PROMPT-token prompt (the length of Whisper's
# start-of-transcript sequence) and WH_GEN generated tokens.  (c) The
# launcher WH_STEPS steps at WH_BATCH x WH_SEQ (the decoder's 448-token
# context), then a WH_GRAD_LAYERS + WH_GRAD_LAYERS-layer fp32 copy's whole
# gradient at WH_GRAD_BATCH x WH_GRAD_SEQ over 1,500 frames against the
# plain attention (phase 11's rule).  (d) The flash kernels at the
# encoder's attention (1,500 frames, 20 heads over 20 KV heads of 64,
# bf16, non-causal): forward timed at batch WH_FA_FWD_B, backward at
# WH_FA_BWD_B (flash_kernel_checks' rule).
WH_ARCH = "whisper-large-v3"
WH_MEL_BATCH, WH_MEL_T, WH_GRAD_MEL_BATCH = 8, 3000, 1
WH_SERVE_BATCH, WH_PROMPT, WH_GEN = 8, 4, 32
WH_BATCH, WH_SEQ, WH_STEPS = 4, 448, 3
WH_GRAD_LAYERS, WH_GRAD_BATCH, WH_GRAD_SEQ = 2, 2, 448
WH_FA_FWD_B, WH_FA_BWD_B = 8, 4
# K's self-attention bias: without rotary embeddings it adds q . bk to a
# whole row of scores, which the softmax ignores, so its exact gradient is
# zero and both paths hold rounding noise there: held within GRAD_TOL of
# the K projection's largest gradient
WH_ZERO_GRAD = {"enc_layers.attn.bk": "enc_layers.attn.wk",
                "dec_layers.attn.bk": "dec_layers.attn.wk"}
# phase 20, Zamba2-7B (arXiv:2411.15242), the hybrid family, at its
# published widths (conv over 7,296 channels; the shared block's 32 heads
# of 112).  (a) The kernels at its training shapes: the depthwise pair at
# (ZB_BATCH, 7,296, ZB_SEQ) by phase 7's rule, the flash pair at (ZB_BATCH,
# ZB_SEQ, 32 heads over 32 KV heads of 112, bf16, causal) and in fp32 at
# ZB_FA_F32 (B, T, KV, G) by phase 10's, each timed beside its library call
# and the bound.  (b) ``serve_lm`` on the config cut to ZB_SERVE_LAYERS
# layers, built once in bf16 with attn_impl="flash" (random non-zero norms, conv biases, D,
# dt_bias and A_log), at batch ZB_SERVE_BATCH, phase 14's LM_PROMPT-token
# prompt and LM_GEN generated tokens, ``--smoke``; the decode traced over
# ZB_TRACE_PROMPT + ZB_TRACE_GEN - 1 steps for its busy share (5,360
# kernels a step: as few steps as phase 14's keep the trace short).  (c) The
# launcher ZB_STEPS steps at ZB_BATCH x ZB_SEQ on ZB_TRAIN_ARCH, the config
# cut to ZB_TRAIN_LAYERS layers (the published widths; its training state
# at full depth, about 12 bytes a parameter, is 81 GB), then an fp32 copy
# of that cut (the served weights cast, ZB_SERVE_LAYERS being
# ZB_TRAIN_LAYERS) and its whole gradient at ZB_GRAD_BATCH x ZB_GRAD_SEQ
# against the plain attention and conv (phase 11's rule; the shared block
# applied twice, so its gradient is a sum, as is the embedding table's).
ZB_ARCH, ZB_TRAIN_ARCH, ZB_TRAIN_LAYERS = "zamba2-7b", "zamba2-7b-12l", 12
# served at a cut depth (the 81 layers' serial draw took 66.7 of the
# phase's 191.6 s on an H100 80GB HBM3 at 700 W): 12 layers keep two
# applications of the shared block (attn_every 6), every width kept
ZB_SERVE_LAYERS = ZB_TRAIN_LAYERS
ZB_SERVE_BATCH, ZB_BATCH, ZB_SEQ, ZB_STEPS = 8, 4, 4096, 3
ZB_GRAD_BATCH, ZB_GRAD_SEQ = 1, 512
ZB_FA_F32 = (1, 1024, 8, 1)
ZB_TRACE_PROMPT, ZB_TRACE_GEN = 2, 5
# the training steps of phases 19 to 23 traced by torch.profiler after
# each launcher run, for where a step's device time goes
# (``_train_breakdown``): one, the launcher's first (its host work
# includes the first calls' set-up; the trace's processing on the host,
# 5-12 s a step, sets the count)
BREAKDOWN_STEPS = 1
# phase 21, Moonlight-16B-A3B (hf:moonshotai/Moonlight-16B-A3B), the MoE
# family, at its published widths (one dense layer of d_ff 11,264, then
# 47 layers of 64 routed experts, top-6 by sigmoid scores, of d_ff 1,408
# and 2 shared; attention 16 over 16 KV heads of 128).  (a) The flash
# pair at (MN_BATCH, MN_SEQ, 16 heads of 128, G = 1, bf16, causal) and
# in fp32 at MN_FA_F32 (B, T, KV, G) by phase 10's rule, timed beside
# SDPA and the bound.  (b) ``serve_lm`` on MN_SERVE_ARCH, the config cut
# to MN_SERVE_LAYERS layers (the dense one and 5 MoE layers; every
# width: all 48 layers' draw and host-bound decode took most of the
# phase's time), built once in bf16 with attn_impl="flash" (random
# non-zero norms and router biases), at batch MN_SERVE_BATCH, phase 14's
# LM_PROMPT-token prompt and LM_GEN generated tokens, ``--smoke``: the fused prefill held to the decode
# within ``serve.prefill_tol`` with the decode's expert selection
# replayed (routing is discontinuous: where a token's 6th and 7th scores
# lie closer than bf16's rounding moves them, the prefill picks another
# expert, a jump no rounding tolerance covers), the prefill's own
# selection's flips per layer reported; the decode traced over
# MN_TRACE_PROMPT + MN_TRACE_GEN - 1 steps, the syncs of one decode step
# counted.  (c) The launcher MN_STEPS steps on MN_TRAIN_ARCH, the config
# cut to MN_TRAIN_LAYERS layers (the dense one and 5 MoE layers at the
# published widths: 3.70 B parameters, about 44 GB of training state; the
# full depth's is about 341 GB) with the streamed cross-entropy over
# MN_XENT_CHUNK positions at MN_BATCH x MN_SEQ, BREAKDOWN_STEPS more
# traced; then an fp32 copy of that cut's whole gradient at MN_GRAD_BATCH
# x MN_GRAD_SEQ against the plain attention (phase 11's rule), each MoE
# layer's selection recorded on both sides first: a flip fails the phase.
MN_ARCH, MN_TRAIN_ARCH = "moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b-6l"
MN_SERVE_ARCH, MN_SERVE_LAYERS = "moonshot-v1-16b-a3b-6l-serve", 6
MN_TRAIN_LAYERS, MN_XENT_CHUNK = 6, 1024
MN_SERVE_BATCH, MN_BATCH, MN_SEQ, MN_STEPS = 8, 4, 4096, 3
MN_GRAD_BATCH, MN_GRAD_SEQ = 1, 512
MN_FA_F32 = (1, 1024, 16, 1)
MN_TRACE_PROMPT, MN_TRACE_GEN = 2, 3
# phase 22, DeepSeek-V3 (arXiv:2412.19437), Multi-head Latent Attention
# at the published widths (d_model 7,168; 128 heads; q_lora 1,536,
# kv_lora 512, nope 128 + rope 64 for q and k, v 128; 256 routed experts
# top-8 by sigmoid scores of d_ff 2,048 and 1 shared; dense d_ff 18,432;
# vocab 129,280).  (a) The flash pair at head_dim 192 with v padded from
# 128, as the MLA block runs it, at (DS_BATCH, DS_SEQ, 128 heads, G = 1,
# bf16, causal) timed beside SDPA and the bound of the useful work, and in
# fp32 at DS_FA_F32 (B, T, KV, G), by phase 10's rule.  (b) ``serve_lm`` on
# DS_SERVE_ARCH, the config cut to DS_SERVE_LAYERS layers (the 3 dense
# layers and 1 MoE layer of all 256 experts, every width: 15.11 B
# parameters, 30.2 GB in bf16; the full depth's 671 B cannot be held),
# built once in bf16 with attn_impl="flash", at batch DS_SERVE_BATCH,
# phase 14's traffic, ``--smoke``, as phase 21's; then the absorbed
# decode against the plain one over the prompt's first DS_ABSORB_STEPS
# positions.  (c) The launcher DS_STEPS steps on DS_TRAIN_ARCH, cut to
# DS_TRAIN_LAYERS layers (1 dense, 1 MoE) and DS_TRAIN_EXPERTS routed
# experts (top-8 kept): 3.37 B parameters, about 40 GB of training state
# (4 layers of 256 experts would need about 180 GB), the streamed
# cross-entropy over DS_XENT_CHUNK positions, at DS_BATCH x DS_SEQ;
# BREAKDOWN_STEPS more traced; its fp32 copy's whole gradient at
# DS_GRAD_BATCH x DS_GRAD_SEQ against the plain attention, selections
# equal first (as phase 21's).
DS_ARCH = "deepseek-v3-671b"
DS_SERVE_ARCH, DS_SERVE_LAYERS = "deepseek-v3-671b-4l", 4
DS_TRAIN_ARCH = "deepseek-v3-671b-2l-16e"
DS_TRAIN_LAYERS, DS_TRAIN_EXPERTS, DS_XENT_CHUNK = 2, 16, 1024
DS_SERVE_BATCH, DS_BATCH, DS_SEQ, DS_STEPS = 8, 4, 4096, 3
DS_GRAD_BATCH, DS_GRAD_SEQ = 1, 512
DS_FA_F32 = (1, 1024, 16, 1)
DS_ABSORB_STEPS = 32
# phase 23, InternVL2-2B (arXiv:2404.16821), the VLM family, at its
# published widths and full depth (1.889 B parameters, about 23 GB of
# training state).  (a) The flash pair at (VL_BATCH, VL_SEQ, 16 heads over
# 8 KV heads of 128, G = 2, bf16, causal) and at the image prefill's
# (VL_SERVE_BATCH, 256 + LM_PROMPT) timed beside SDPA and the bound, and
# in fp32 at VL_FA_F32 (B, T, KV, G), by phase 10's rule.  (b)
# ``serve_lm`` at batch VL_SERVE_BATCH and phase 14's traffic (the decode
# runs text, as JAX's launcher), then the fused prefill of the prompt
# behind 256 seeded image embeddings through flash against the same
# prefill through the plain attention, within ``serve.prefill_tol``; a
# LM_FP32_LAYERS-layer fp32 copy checked both ways.  (c) The launcher
# VL_STEPS steps at VL_BATCH x VL_SEQ (VL_SEQ counts the 256 image
# positions, as JAX's ``vlm_batch``), BREAKDOWN_STEPS more traced.  (d)
# An fp32 copy cut to LM_FP32_LAYERS layers: its whole gradient at
# VL_GRAD_BATCH x VL_GRAD_SEQ against the plain attention (phase 11's
# rule).  (e) ``remat_policy="dots"`` (``VL_DOTS_ARCH``, registered in
# the phase) against "nothing" at full depth, VL_DOTS_STEPS launcher
# steps each at VL_DOTS_BATCH x VL_SEQ from the same seed, then one
# batch's every gradient under each; "dots" keeps 7 product outputs a
# layer, 24,576 bf16 values a position (9.7 GB at 2 x 4,096 over 24
# layers, 19.3 GB at batch 4, where the "nothing" step peaks near 48 GB).
VL_ARCH, VL_DOTS_ARCH = "internvl2-2b", "internvl2-2b-dots"
VL_SERVE_BATCH, VL_BATCH, VL_SEQ, VL_STEPS = 8, 4, 4096, 3
VL_GRAD_BATCH, VL_GRAD_SEQ = 2, 512
VL_DOTS_BATCH, VL_DOTS_STEPS = 2, 3
VL_FA_F32 = (1, 1024, 8, 2)
# phase 24, tensor-parallel serving of the transformer language models
# (``serve --model-parallel``, ``models/sharding.py``'s blocks): TS_MP
# gloo ranks spawned on the one card run the launcher from torchrun's
# variables (a localhost port), each reading back on the host the seeded
# model the one process drew (random non-zero biases and norms; saved in
# the phase's temporary directory) and keeping its blocks.  (a)
# StarCoder2-3B at its published widths, TS_SC2_LAYERS layers, bf16,
# flash: one process serves it at a TS_PROMPT-token prompt at batch
# TS_BATCH, then the ranks serve it with ``--smoke`` (each rank's fused
# prefill runs TS_SC2_LAYERS ``flash_fwd`` on its (TS_BATCH, TS_PROMPT, 1,
# 12, 128) heads); each rank's decode logits at the prompt's last position
# within ``serve.prefill_tol`` of the one process's largest logit, the greedy
# tokens equal where the top-2 margin is clear, the two ranks' logits and
# tokens bitwise equal; an LM_FP32_LAYERS-layer fp32 copy within
# TS_F32_TOL.  (b) DeepSeek-V3's DS_TRAIN_ARCH (every width; 1 dense + 1
# MoE layer of 16 routed experts): 64 MLA heads of 192 and 8 routed
# experts a rank, as (a) with the one process's expert selection replayed
# in the ranks' decode, then a free run (its flips over the prompt
# against the one process reported, its selections bitwise equal across
# the ranks), the absorbed decode on a rank's blocks against the one
# process's (gated in fp32, reported in bf16), and the fp32 copy (the cut
# is 2 layers already; its bf16 weights cast, not drawn again).  (c)
# Mamba2-370M at all 48 layers (each rank's fused prefill runs 48
# ``depthwise_conv1d_fwd`` on its (TS_BATCH, 1,024 + 256, TS_PROMPT)
# channels: its heads' x, B and C whole), Zamba2-7B's ZB_TRAIN_ARCH
# (phase 20's 12-layer cut, every width: 12 ``depthwise_conv1d_fwd`` on
# 3,584 + 128 channels and 2 ``flash_fwd`` on 16 heads of 112 a rank's
# prefill) and Whisper-large-v3 at full width, cut to TS_WH_LAYERS encoder
# and TS_WH_LAYERS decoder layers (a WH_PROMPT-token prompt; 8
# ``flash_fwd`` on the encoder's 10 heads of 64 a rank's
# ``fill_cross_cache``, 16 a fused prefill), as (a); their fp32 copies are
# the bf16 weights cast and cut to their first TS_F32_LAYERS layers
# (Zamba2's to TS_ZB_F32_LAYERS: one application of the shared block;
# Whisper's encoder and decoder each).  To keep the phase's time,
# StarCoder2-3B is served here cut to TS_SC2_LAYERS layers (phase 14
# serves all 30 in one process), StarCoder2, Mamba2 and Zamba2 serve a
# TS_PROMPT-token prompt (a rank's sequential prefill runs a decode step
# a token, about 100 gloo collectives for Mamba2) and every bf16 run
# generates TS_GEN tokens (7 timed decode steps).  DeepSeek-V3 keeps
# TS_DS_PROMPT: at 72 a rank's 2-layer bf16 fused prefill sat 1.26e-2
# of the largest logit from its decode, past
# ``serve.prefill_tol``'s 1.17e-2 (an H100 80GB HBM3 at 700 W); its fp32
# copy takes TS_PROMPT.  Whisper is cut to TS_WH_LAYERS + TS_WH_LAYERS
# layers for the time: at 32 + 32 a rank's run took 22 s on that card,
# the encoder's sums moving (8, 1,500, 1,280) bf16 activations through
# gloo.  The absorbed decode runs over the prompt's first TS_ABSORB_STEPS
# positions (phase 22's one process over DS_ABSORB_STEPS).  TS_PROMPT is
# no multiple of the SSD chunk (128); it was 72, then 40, before it was
# cut for the whole script's time.  The ranks serve a model once the one
# process has drawn, saved and served it (an MoE model's selection
# saved), while the one process goes on with the next: from the second
# model on, the one process's times are taken beside the ranks' runs
# (with the ranks waiting for every model the phase took 144.5 s of a
# whole script's 1,031.7 s on an H100 80GB HBM3 at 700 W).
TS_SC2, TS_MP, TS_BATCH, TS_F32_TOL = "starcoder2-3b", 2, 8, 1e-5
TS_SC2_LAYERS, TS_PROMPT, TS_GEN, TS_DS_PROMPT = 12, 24, 8, 200
TS_F32_LAYERS, TS_ZB_F32_LAYERS = 2, 6
TS_WH_LAYERS, TS_ABSORB_STEPS = 8, 16
# phase 25, FSDP training of the language models (the JAX launcher's
# placement on a (dp, 1) mesh): FS_DP gloo ranks on the one card (NCCL
# refuses two ranks on one GPU) run the launcher from torchrun's variables
# on StarCoder2-3B (bf16, flash, remat) cut to FS_SC2_LAYERS layers
# (registered as FS_SC2_ARCH) at a global batch of FS_SC2_BATCH x LM_SEQ,
# and on Mamba2-370M (48 layers) at M2_BATCH x M2_SEQ, FS_STEPS steps each
# (the first not timed) from seed FS_SEED; one process trains the same
# models on the same global batches.  (a) The first gradient's blocks are
# bitwise the whole-parameter data-parallel path's on the same ranks (a
# sum of two does not depend on its order); (b) the first loss within
# FS_LOSS_RTOL of the one process's: the same parameters, only the batch
# split differs, so only the products' rounding at half the rows does;
# (c) each later loss within FS_LATER_RTOL: at lr 0 in the first step
# (the warm-up) the second step's forward again differs by the split
# alone, and the third's parameters also by the first update's bf16
# rounding of values whose gradients summed in another order (PERF.md
# gives the prediction this tolerance was set by, before the first run);
# (d) fp32 copies (the bf16 weights cast) cut to LM_FP32_LAYERS layers,
# TF32 off, FS_F32_STEPS steps at FS_F32_BATCH x FS_F32_SEQ, trained FSDP
# and in one process on each rank: each parameter within FS_F32_TOL
# times the one process's largest parameter (a unit norm scale) of its
# value there; AdamW's first updates are sign-like, and a zero-initialised
# bias holds values of about lr after them, so a bound on each leaf's own
# largest value would hold those leaves to the rounding of their near-zero
# gradients' signs
FS_DP, FS_SC2_LAYERS, FS_SC2_BATCH, FS_STEPS, FS_SEED = 2, 4, 4, 3, 0
FS_SC2_ARCH = "starcoder2-3b-4l"
FS_LOSS_RTOL, FS_LATER_RTOL = 1e-3, 5e-3
FS_F32_BATCH, FS_F32_SEQ, FS_F32_STEPS, FS_F32_TOL = 2, 512, 2, 1e-5
# phase 26, serving on JAX's serve launcher's (world / mp, mp) host mesh:
# the parameters FSDP-placed on 'data' (a rank holds its 2-D blocks and
# gathers a layer's column block over its data group where the layer
# runs), the batch and cache on 'data'.  Gloo ranks on the one card (NCCL
# refuses two ranks on one GPU) serve through the launcher from torchrun's
# variables, as (2, 1) on 2 ranks: StarCoder2-3B (bf16, flash) cut to
# DPS_SC2_LAYERS layers and Mamba2-370M (48 layers); as (2, 2) on 4
# ranks: the same StarCoder2-3B; batch DPS_BATCH (DPS_BATCH / 2 rows a
# data row), DPS_PROMPT sequential prefill tokens and DPS_GEN generated
# (``--smoke``: each data row's fused prefill held to its decode), and
# fp32 copies (the bf16 weights cast, cut to LM_FP32_LAYERS layers) over
# DPS_F32_PROMPT + DPS_F32_GEN tokens.  One process serves each model at
# the same batch.  Gates: the fp32 copies' logits within DPS_F32_TOL of
# one process's largest logit and their tokens equal; the bf16 runs
# within ``serve.prefill_tol``; the ranks bitwise equal (their gathered
# rows, each data row's computed by its model row); a rank's parameter
# bytes exactly its blocks'; a decode step's data gathers one a layer
# plus the tables (StarCoder2's tied one, Mamba2's two); the fused
# prefill's launches and the kernels' input shapes a data row's.  A data
# rank's decode step moves each layer's column block through gloo at
# about 0.8 GB/s (``tools/gloo_bench.py --fsdp``), 0.6-0.9 s a decode
# step of a rank of either model at (2, 1) on an H100 80GB HBM3 at 700 W:
# the token counts are cut for the phase's time (16 + 4 and 4 + 2 took
# the phase 93.6 s there, 8 + 4 and 2 + 2 66.6 s in the whole script on
# a slower host)
DPS_BATCH, DPS_SC2_LAYERS, DPS_PROMPT, DPS_GEN = 8, 2, 4, 4
DPS_F32_PROMPT, DPS_F32_GEN, DPS_F32_TOL = 2, 2, 1e-5
DPS_LAYOUTS = ((2, 1), (2, 2))
# phase 27, tensor-parallel serving where the heads or KV heads do not
# divide the model axis (``sharding.head_blocks``: a rank holds whole
# query heads of one group and the KV heads they read).  One world of
# HL_WORLD gloo ranks on the one card (NCCL refuses two ranks on one GPU)
# serves through the launcher from torchrun's variables, every published
# width kept, each model cut to HL_LAYERS layers (Whisper-large-v3 to
# HL_LAYERS encoder and HL_LAYERS decoder layers): Qwen2-7B as (1, 8)
# (each of its 4 KV heads on 2 ranks, 4 and 3 of each group's 7 query
# heads a rank, its QKV biases), Whisper-large-v3 as (1, 8) (its 20 heads
# 3, 3, 3, 3, 2, 2, 2, 2; the encoder over 8 x 1,500 frames) and
# StarCoder2-3B as (2, 4) (each of its 2 KV heads on 2 ranks of a data
# row, 6 query heads a rank; the parameters FSDP-placed on 'data', 4 rows
# a data row): bf16 with flash at batch HL_BATCH over HL_PROMPT + HL_GEN
# tokens (Whisper WH_PROMPT + HL_GEN), each data row's fused prefill held
# to its decode (``--smoke``), and fp32 copies (the bf16 weights cast) at
# LM_FP32_BATCH over HL_F32_PROMPT + HL_F32_GEN.  One process serves each
# model on the card at the same batch and saves both dtypes' weights,
# which the ranks read back memory-mapped (a rank's own fp32 cast of
# Qwen2-7B's 2-layer cut would hold 6.2 GB of host memory, 50 GB over 8
# ranks); the ranks serve a model once its go file is written, while the
# one process goes on with the next (so the one process's Whisper and
# StarCoder2 runs are timed beside the ranks' Qwen2 runs).  The token
# counts are cut for the script's time: 24 + 8 and 8 + 4 took the phase
# 75.6-81.9 s, the whole script 1,031.7 s (the (2, 4) decode is its data
# gathers, 0.44 s a bf16 step, 0.78 fp32).  Gates: the fp32 copies'
# logits within HL_F32_TOL of the one process's largest logit and their
# tokens equal; the bf16 runs' within ``serve.prefill_tol``, tokens equal
# where the top-2 margin is clear; the ranks bitwise equal; each rank's
# heads HL_HEADS' and its weight bytes exactly its head-aligned blocks
# (``_hl_blocks_bytes``), its cache bytes its heads'; a decode step's
# model sums, logit gathers and data gathers; each fused prefill's
# ``flash_fwd`` launches (one a layer, Whisper's ``fill_cross_cache`` one
# an encoder layer) at the rank's heads; no launch in a decode step
HL_WORLD, HL_LAYERS, HL_BATCH, HL_PROMPT, HL_GEN = 8, 2, 8, 8, 4
HL_F32_PROMPT, HL_F32_GEN, HL_F32_TOL = 4, 2, 1e-5
HL_LAYOUTS = {"qwen2": (1, 8), "whisper": (1, 8), "starcoder2": (2, 4)}
# each model rank's (query heads, KV heads) at its model's layout
HL_HEADS = {"qwen2": [(4, 1), (3, 1)] * 4,
            "whisper": [(3, 3)] * 4 + [(2, 2)] * 4,
            "starcoder2": [(6, 1)] * 4}
# the bf16 flash kernels: forward and dQ at 4 head dims, the fused dK/dV
# at 3 and its two passes at 192
FLASH_WGMMA_KERNELS = 13
# Phase 28 (the dry-run against the card): one rank of each DR_CELLS
# config's prefill_32k cell on the (16, 16) production mesh, the origin,
# cut to DR_LAYERS layers, counted on the meta device by the dry-run and
# run on the card (its blocks drawn from DR_SEED, counting groups): each
# kernel's launches equal to the count, the parameter bytes exactly the
# count's, the card's peak within DR_PEAK_TOL of the predicted arguments
# plus the peak beyond them; the plain flash at 32,768 tokens in query
# chunks of DR_Q_CHUNK (the whole (T, T) fp32 scores would be 17 GB)
DR_LAYERS, DR_SEED, DR_PEAK_TOL, DR_Q_CHUNK = 2, 28, 0.2, 4096
DR_SHAPE = "prefill_32k"
DR_CELLS = {"starcoder2": ("starcoder2-3b", {"attn_impl": "flash"}),
            "mamba2": ("mamba2-370m", {})}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _call_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of single calls as a caller sees them: the
    host's work in the call (checks, allocation, launch) is inside the
    window whenever it is longer than the device's."""
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, per_graph: int = 10, reps: int = 5) -> float:
    """Device time of one call: ``per_graph`` calls captured in one CUDA
    graph, replayed ``reps`` times back to back between two events, so no
    host work sits between the kernels (``repro_torch.tune.measure``)."""
    from repro_torch.tune.measure import device_ms
    return device_ms(fn, per_graph, reps)


def _counters(conv1d_brgemm, fa):
    """The six kernel wrappers, whose ``launches`` count their launches."""
    return (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight,
            conv1d_brgemm.depthwise_conv1d_fwd,
            conv1d_brgemm.depthwise_conv1d_bwd_weight, fa.flash_fwd,
            fa.flash_bwd)


def _counted(counters, fn):
    """``fn()`` with every counter set to 0 just before it; returns its
    result and each kernel's launches in it."""
    for c in counters:
        c.launches = 0
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def _host_us(fn, reps: int = 200, rounds: int = 5) -> float:
    """Host time of one call in microseconds: ``reps`` calls enqueued back
    to back, timed on the host clock to the last return while the device
    runs behind; median over ``rounds``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def _fwd_tile(conv1d_brgemm, N, C, K, S, Wp, d):
    """The register tile ``conv1d_fwd`` takes at this shape on this card:
    "J=8 KT=16" (J columns spaced d apart x KT filters a thread)."""
    code = conv1d_brgemm.fwd_tile(N, C, K, S, Wp, d)
    if code is None:
        raise AssertionError("conv1d_fwd_tile refused the shape")
    return f"J={code // 100} KT={code % 100}"


def _rates(row, flops=None, nbytes=None):
    """The rate the row's device time reaches (GFLOP/s of ``flops``, GB/s of
    ``nbytes``) and its share of the bound (bound / time)."""
    ms = row["kernel_ms"]
    if flops is not None:
        row["gflop_per_s"] = flops / ms / 1e6
    if nbytes is not None:
        row["gb_per_s"] = nbytes / ms / 1e6
    row["bound_share"] = row["bound_ms"] / ms


def kernel_checks(torch, conv1d_brgemm, ops, ref, ep):
    """Phase 2: every layer shape of the path, kernel vs plain version."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    # (label, C, K, activation, residual, out_dtype is fp32)
    layers = [("stem", 1, 15, "relu", False, False),
              ("conv1", 15, 15, "relu", False, False),
              ("conv2", 15, 15, "relu", True, False),
              ("head_signal", 15, 1, "relu", False, True),
              ("head_peak", 15, 1, None, False, True)]
    cases = []  # ... (S, dilation), dtype, N, Q, padding, where
    for name, C, K, act, res, f32out in layers:
        cases.append((name, C, K, act, res, f32out, (51, 8), "float32", 4,
                      4096, "CAUSAL", "stream"))
        cases.append((name, C, K, act, res, f32out, (51, 8), "float32", 1,
                      60000, "CAUSAL", "oneshot"))
    for name, C, K, act, res, f32out in layers:  # atacworks-bf16: C=K=16
        cases.append((name, 1 if C == 1 else 16, 1 if K == 1 else 16, act,
                      res, f32out, (51, 8), "bfloat16", 4, 4096, "CAUSAL",
                      "stream"))
    cases.append(("conv1", 15, 15, "gelu", False, False, (51, 8), "float32",
                  4, 4096, "SAME", "stream"))
    cases.append(("conv2", 15, 15, "silu", True, False, (51, 8), "float32",
                  4, 4096, "CAUSAL", "stream"))
    # the generic tiling beyond the path (the paper's Figure 5 and 6
    # parameter sets, repro/tune/presets.py): K > 16 in filter tiles,
    # dilation 1 and 4, bf16; checked, not timed
    cases.append(("fig5", 64, 64, "relu", False, False, (25, 1), "float32",
                  4, 5000, "SAME", "d=1 S=25"))
    cases.append(("fig6", 32, 32, "relu", False, False, (51, 4), "bfloat16",
                  4, 5000, "SAME", "d=4 S=51"))

    rows = []
    for (name, C, K, act, res, f32out, (S, d), dt, N, Q, padding,
         where) in cases:
        span = (S - 1) * d
        dtype = getattr(torch, dt)
        x = torch.randn((N, C, Q), generator=gen, device=DEVICE).to(dtype)
        w = (torch.randn((S, K, C), generator=gen, device=DEVICE)
             * (C * S) ** -0.5).to(dtype)
        b = (0.1 * torch.randn((K,), generator=gen, device=DEVICE)).to(dtype)
        r = ((torch.randn((N, K, Q), generator=gen, device=DEVICE)).to(dtype)
             if res else None)
        out_dtype = torch.float32 if f32out else None
        kw = dict(bias=b, activation=act, residual=r, dilation=d,
                  padding=padding, out_dtype=out_dtype)
        got = ops.conv1d(x, w, backend="cuda", **kw)
        want = ops.conv1d(x, w, backend="ref", **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        max_abs = diff.max().item()
        max_rel = max_abs / max(want.float().abs().max().item(), 1e-30)
        atol, rtol = TOL[dt]
        ok = bool((diff <= atol + rtol * want.float().abs()).all().item())
        sig = ep.signature(True, act, res)
        label = f"{name} {sig} {C}->{K} {where}" + (
            f" {padding}" if padding != "CAUSAL" else "") + (
            " bf16" if dt == "bfloat16" else "")
        row = dict(shape=label, dtype=dt, N=N, C=C, K=K, S=S, dilation=d,
                   Q=Q, max_abs_err=max_abs, max_rel_diff=max_rel,
                   atol=atol, rtol=rtol, ok=ok,
                   tile=_fwd_tile(conv1d_brgemm, N, C, K, S, Q + span, d))
        if not ok:
            raise AssertionError(f"kernel disagrees with plain version: {row}")
        if dt == "float32" and padding == "CAUSAL" and act in ("relu", None):
            # times at the path's shapes: the kernel on the padded input,
            # the plain version on the same, and one library call
            xp = F.pad(x, (span, 0)).contiguous()
            w_kcs = w.permute(1, 2, 0).contiguous()  # (K, C, S) for torch

            def kernel():
                return conv1d_brgemm.conv1d_fwd(
                    xp, w, bias=b, residual=r, activation=act, dilation=d,
                    out_dtype=out_dtype)

            def plain():
                return ref.conv1d_fused_ref(
                    xp, w, bias=b, residual=r, activation=act, dilation=d,
                    out_dtype=out_dtype)

            def library():
                return F.conv1d(xp, w_kcs, b, dilation=d)

            row["kernel_ms"] = _device_ms(kernel)
            row["plain_ms"] = _device_ms(plain, per_graph=2)
            row["library_ms"] = _device_ms(library)
            row["kernel_call_ms"] = _call_ms(kernel)
            row["library_call_ms"] = _call_ms(library)
            row["bound_ms"], row["bound_by"] = roofline.conv1d_fwd_bound(
                N, C, K, S, Q + span, Q, dt, True, res, 4)
            _rates(row, flops=2.0 * N * K * C * S * Q)
            if where == "stream":
                # what ops adds to a served call on the host: the server
                # calls ops.conv1d VALID on [state | chunk] under
                # inference_mode, which ends in the wrapper call
                def via_ops():
                    return ops.conv1d(
                        xp, w, bias=b, residual=r, activation=act,
                        dilation=d, padding="VALID", out_dtype=out_dtype)

                with torch.inference_mode():
                    row["wrapper_host_us"] = _host_us(kernel)
                    row["ops_host_us"] = _host_us(via_ops)
                row["ops_added_host_us"] = (row["ops_host_us"]
                                            - row["wrapper_host_us"])
        rows.append(row)
        print("kernel-check " + json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows


def _serve_model(torch, configs, blocks):
    """The served atacworks model: seeded weights, random non-zero
    biases."""
    cfg = configs.get("atacworks")
    # seed 4: with these biases the signal head's relu passes about two
    # thirds of the columns (seed 0 zeroes nearly all of them, which would
    # leave the signal comparison empty)
    model = blocks.init_params(cfg, seed=4, device=DEVICE)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # biases are zeros at init: make them count
        for name, p in model.named_parameters():
            if name.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return cfg, model


def _make_server(np, serve, model, cfg, streams):
    """A server of the serving cell with ``streams`` seeded ragged streams
    queued, each with a history."""
    rng = np.random.default_rng(0)
    server = serve.ConvStreamServer(model, cfg, batch=SLOTS, chunk=CHUNK,
                                    prompt_len=PROMPT_LEN, device=DEVICE)
    for rid in range(streams):
        n = TRACK_LEN + int(rng.integers(0, CHUNK))
        server.submit(serve.StreamRequest(
            rid, rng.normal(size=n).astype(np.float32),
            history=rng.normal(size=PROMPT_LEN).astype(np.float32)))
    return server


def serve_check(torch, np, configs, blocks, serve, conv1d_brgemm):
    """Phase 3: the full atacworks config served through the kernel."""
    cfg, model = _serve_model(torch, configs, blocks)

    def make_server():
        return _make_server(np, serve, model, cfg, STREAMS)

    def timed_run(server):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    server = make_server()
    (done, wall), launches = _counted((conv1d_brgemm.conv1d_fwd,),
                                      lambda: timed_run(server))
    launches = launches["conv1d_fwd"]
    prefills = sum(r.history is not None for r in done)
    per_step = (launches - 25 * prefills) / server.chunks_run
    if len(done) != STREAMS:
        raise AssertionError(f"{len(done)} of {STREAMS} streams done")
    if per_step < 25:
        raise AssertionError(f"{per_step} kernel launches per stream step; "
                             "the serve path must launch it 25 times")
    times = np.asarray(server.chunk_times[1:])
    samples = sum(len(r.track) for r in done)
    stats = dict(streams=len(done), samples=samples,
                 chunks_run=server.chunks_run, prefills=prefills,
                 launches=launches, launches_per_step=per_step, wall_s=wall,
                 chunk_p50_ms=float(np.median(times) * 1e3),
                 chunk_p99_ms=float(np.percentile(times, 99) * 1e3),
                 streams_per_s=len(done) / wall, samples_per_s=samples / wall)

    for req in done:  # outputs are finite and of the expected shape
        sig, peak = req.result()
        if sig.shape != req.track.shape or peak.shape != req.track.shape:
            raise AssertionError(f"stream {req.id}: shapes {sig.shape}, "
                                 f"{peak.shape} != {req.track.shape}")
        if not (np.isfinite(sig).all() and np.isfinite(peak).all()):
            raise AssertionError(f"stream {req.id}: non-finite outputs")
        want = serve.one_shot(model, cfg, req.track, server.context(req))
        for name, got, ref_ in (("signal", sig, want[0]),
                                ("peak", peak, want[1])):
            if not np.array_equal(got, ref_):
                raise AssertionError(
                    f"stream {req.id} {name} != one-shot causal forward "
                    f"through the kernel (maxdiff {np.abs(got - ref_).max()})")
    got0 = np.stack(done[0].result())
    plain = np.stack(serve.one_shot(model, cfg, done[0].track,
                                    server.context(done[0]), backend="ref"))
    plain_err = float(np.abs(got0 - plain).max())
    if not np.allclose(got0, plain, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"stream 0 vs the plain forward: max abs diff "
                             f"{plain_err}, beyond atol=rtol=1e-4")
    torch.cuda.synchronize()
    stats.update(bitwise_vs_oneshot_kernel=True,
                 max_abs_err_vs_plain_forward=plain_err,
                 max_abs_output=float(np.abs(plain).max()),
                 signal_nonzero_frac=float((got0[0] != 0).mean()))

    # the same streams again, timed only: the run-to-run spread of the
    # host-clock metrics, and p50/p99 over all runs' chunk times pooled
    runs, pooled = [], list(times)
    for _ in range(SERVE_REPEATS):
        again = make_server()
        _, wall_r = timed_run(again)
        t = np.asarray(again.chunk_times[1:])
        pooled += list(t)
        runs.append(dict(chunk_p50_ms=float(np.median(t) * 1e3),
                         chunk_p99_ms=float(np.percentile(t, 99) * 1e3),
                         samples_per_s=samples / wall_r))
    pooled = np.asarray(pooled)
    stats.update(
        repeats=runs,
        pooled_chunks=len(pooled),
        pooled_chunk_p50_ms=float(np.median(pooled) * 1e3),
        pooled_chunk_p99_ms=float(np.percentile(pooled, 99) * 1e3),
        repeat_samples_per_s_min=min(r["samples_per_s"] for r in runs),
        repeat_samples_per_s_max=max(r["samples_per_s"] for r in runs),
        repeat_chunk_p50_ms_min=min(r["chunk_p50_ms"] for r in runs),
        repeat_chunk_p50_ms_max=max(r["chunk_p50_ms"] for r in runs))
    torch.cuda.synchronize()
    print("serve " + json.dumps(stats), flush=True)
    return stats


def _check_close(label, got, want, tol):
    """max|got - want| <= tol * max|want|; returns (max_abs, max_rel)."""
    scale = max(want.float().abs().max().item(), 1e-30)
    max_abs = (got.float() - want.float()).abs().max().item()
    if not max_abs <= tol * scale:
        raise AssertionError(f"{label}: max abs diff {max_abs} > {tol} x "
                             f"max|plain| {scale}")
    return max_abs, max_abs / scale


def _check_elementwise(label, got, want, rtol, atol_of_max):
    """|got - want| <= rtol * |want| + atol_of_max * max|want| for every
    element; returns (max_abs, max_abs / max|want|, the largest share of
    its own limit that an element uses: at most 1)."""
    g, w = got.float(), want.float()
    scale = max(w.abs().max().item(), 1e-30)
    diff = (g - w).abs()
    share = diff / (rtol * w.abs() + atol_of_max * scale)
    use = share.max().item()
    if not use <= 1.0:
        i = int(share.argmax())
        raise AssertionError(
            f"{label}: element {i}: |kernel - plain| "
            f"{diff.flatten()[i].item()} > {rtol} x |plain| "
            f"{w.flatten()[i].abs().item()} + {atol_of_max} x max|plain| "
            f"{scale}")
    max_abs = diff.max().item()
    return max_abs, max_abs / scale, use


def bwd_kernel_checks(torch, conv1d_brgemm, ref):
    """Phase 4: the training path's kernels at its layer shapes."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    N, Q, S, d = TRAIN_BATCH, TRAIN_SEQ, 51, 8
    span = (S - 1) * d
    Wp = Q + span
    # (label, C, K, dtype): every layer shape of the training path, fp32,
    # and the bf16 config's widths
    layers = [("stem", 1, 15, "float32"), ("conv", 15, 15, "float32"),
              ("head", 15, 1, "float32"), ("stem", 1, 16, "bfloat16"),
              ("conv", 16, 16, "bfloat16"), ("head", 16, 1, "bfloat16")]

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    rows = []
    for name, C, K, dt in layers:
        dtype = getattr(torch, dt)
        tol = BWD_TOL[dt]
        x = rnd(N, C, Wp, dtype=dtype)                 # padded input
        w = (rnd(S, K, C) * (C * S) ** -0.5).to(dtype)
        b = (0.1 * rnd(K)).to(dtype)
        g = rnd(N, K, Q, dtype=dtype)                  # cotangent of u
        g_pad = F.pad(g, (span, span))
        w_t = w.flip(0).transpose(1, 2).contiguous()   # (S, C, K)
        w_kcs = w.permute(1, 2, 0).contiguous()        # (K, C, S), torch's
        fp32 = dt == "float32"

        def fwd():
            return conv1d_brgemm.conv1d_fwd(x, w, bias=b, activation="relu",
                                            dilation=d)

        def bwd_data():
            return conv1d_brgemm.conv1d_fwd(g_pad, w_t, dilation=d)

        def bwd_w(with_dbias=True):
            return conv1d_brgemm.conv1d_bwd_weight(x, g, S=S, dilation=d,
                                                   with_dbias=with_dbias)

        passes = {
            "fwd": (fwd, lambda: ref.conv1d_fused_ref(
                x, w, bias=b, activation="relu", dilation=d),
                lambda: F.conv1d(x, w_kcs, b, dilation=d),
                2.0 * N * K * C * S * Q,
                (N * C * Wp + S * K * C + K + N * K * Q) * x.element_size()),
            "bwd_data": (bwd_data, lambda: ref.conv1d_bwd_data_ref(
                g, w, dilation=d),
                lambda: torch.nn.grad.conv1d_input(
                    (N, C, Wp), w_kcs, g, dilation=d),
                # the function: only the Q cotangent columns are non-zero
                # (the span padding is zeros the wrapper adds), so
                # 2NKCSQ flops, and g read unpadded
                2.0 * N * K * C * S * Q,
                (N * K * Q + S * K * C + N * C * Wp) * x.element_size()),
            "bwd_weight": (bwd_w, lambda: (
                ref.conv1d_bwd_weight_ref(x, g, dilation=d),
                ref.conv1d_dbias_ref(g)),
                lambda: torch.nn.grad.conv1d_weight(
                    x, (K, C, S), g, dilation=d),
                2.0 * N * K * C * S * Q,
                (N * C * Wp + N * K * Q) * x.element_size()
                + (S * K * C + K) * 4),
        }
        for pname, (kern, plain, lib, flops, nbytes) in passes.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            label = f"{pname} {name} {C}->{K} N={N} Q={Q}" + (
                "" if fp32 else " bf16")
            if pname == "bwd_weight":
                err_w = _check_close(label + " dw", got[0], want[0], tol)
                err_b = _check_close(label + " dbias", got[1], want[1], tol)
                nod = bwd_w(with_dbias=False)
                err_n = _check_close(label + " dw (no dbias)", nod, want[0],
                                     tol)
                again = bwd_w()
                torch.cuda.synchronize()
                if not (torch.equal(again[0], got[0])
                        and torch.equal(again[1], got[1])
                        and torch.equal(nod, got[0])):
                    raise AssertionError(f"{label}: two launches differ")
                max_abs = max(err_w[0], err_b[0], err_n[0])
                max_rel = max(err_w[1], err_b[1], err_n[1])
            else:
                max_abs, max_rel = _check_close(label, got, want, tol)
                again = kern()
                torch.cuda.synchronize()
                if not torch.equal(again, got):
                    raise AssertionError(f"{label}: two launches differ")
            row = dict(shape=label, pass_=pname, layer=name, dtype=dt, N=N,
                       C=C, K=K, S=S, dilation=d, Q=Q, max_abs_err=max_abs,
                       max_rel_diff=max_rel, tol_rel_to_max_plain=tol,
                       bitwise_two_launches=True, ok=True)
            if pname == "fwd":
                row["tile"] = _fwd_tile(conv1d_brgemm, N, C, K, S, Wp, d)
            elif pname == "bwd_data":  # K channels in, C filters out
                row["tile"] = _fwd_tile(conv1d_brgemm, N, K, C, S,
                                        Wp + span, d)
            if fp32:
                row["kernel_ms"] = _device_ms(kern)
                row["kernel_call_ms"] = _call_ms(kern)
                row["plain_ms"] = _device_ms(plain, per_graph=2)
                row["library_ms"] = _device_ms(lib)
                row["bound_ms"], row["bound_by"] = roofline.bound(flops,
                                                                  nbytes, dt)
                if pname == "bwd_weight":
                    # the FMA bound of the kernel this one replaced beside
                    # the three-term TF32 bound of its tensor-core bodies
                    row["fma_bound_ms"] = row["bound_ms"]
                    row["fma_bound_by"] = row["bound_by"]
                    row["fma_bound_share"] = row["fma_bound_ms"] / row[
                        "kernel_ms"]
                    row["bound_ms"], row["bound_by"] = roofline.bound(
                        roofline.tf32_flops(N, C, K, S, Q), nbytes, "tf32")
                _rates(row, flops=flops)
            rows.append(row)
            print("bwd-check " + json.dumps(row), flush=True)

    # bwd-weight at phase 2's generic shapes (the paper's Figure 5 and 6
    # parameter sets): more filters and channels than one block takes,
    # dilation 1 (the unit body) and 4 (the taps body), bf16; checked only
    for name, C, K, S_, d_, dt in (("fig5", 64, 64, 25, 1, "float32"),
                                   ("fig6", 32, 32, 51, 4, "bfloat16")):
        dtype, Nf, Qf = getattr(torch, dt), 4, 5000
        tol = BWD_TOL[dt]
        x = rnd(Nf, C, Qf + (S_ - 1) * d_, dtype=dtype)
        g = rnd(Nf, K, Qf, dtype=dtype)
        label = f"bwd_weight {name} {C}->{K} d={d_} S={S_} N={Nf} Q={Qf}" + (
            " bf16" if dt == "bfloat16" else "")
        got = conv1d_brgemm.conv1d_bwd_weight(x, g, S=S_, dilation=d_,
                                              with_dbias=True)
        nod = conv1d_brgemm.conv1d_bwd_weight(x, g, S=S_, dilation=d_)
        again = conv1d_brgemm.conv1d_bwd_weight(x, g, S=S_, dilation=d_,
                                                with_dbias=True)
        torch.cuda.synchronize()
        want = ref.conv1d_bwd_weight_ref(x, g, dilation=d_)
        errs = (_check_close(label + " dw", got[0], want, tol),
                _check_close(label + " dbias", got[1],
                             ref.conv1d_dbias_ref(g), tol),
                _check_close(label + " dw (no dbias)", nod, want, tol))
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
                and torch.equal(nod, got[0])):
            raise AssertionError(f"{label}: two launches differ")
        row = dict(shape=label, pass_="bwd_weight", layer=name, dtype=dt,
                   N=Nf, C=C, K=K, S=S_, dilation=d_, Q=Qf,
                   max_abs_err=max(e[0] for e in errs),
                   max_rel_diff=max(e[1] for e in errs),
                   tol_rel_to_max_plain=tol, bitwise_two_launches=True,
                   ok=True)
        rows.append(row)
        print("bwd-check " + json.dumps(row), flush=True)

    # save_preact: the fp32 pre-activation beside the output, gelu and silu
    C = K = 15
    x, r = rnd(N, C, Wp), rnd(N, K, Q)
    w, b = rnd(S, K, C) * (C * S) ** -0.5, 0.1 * rnd(K)
    for act in ("gelu", "silu"):
        y, u = conv1d_brgemm.conv1d_fwd(x, w, bias=b, residual=r,
                                        activation=act, save_preact=True,
                                        dilation=d)
        want_u = ref.conv1d_preact_ref(x, w, bias=b, residual=r, dilation=d)
        want_y = ref.conv1d_fused_ref(x, w, bias=b, residual=r,
                                      activation=act, dilation=d)
        label = f"save_preact {act} conv {C}->{K} N={N} Q={Q}"
        err_u = _check_close(label + " preact", u, want_u, BWD_TOL["float32"])
        err_y = _check_close(label + " out", y, want_y, BWD_TOL["float32"])
        row = dict(shape=label, pass_="save_preact", dtype="float32",
                   max_abs_err=max(err_u[0], err_y[0]),
                   max_rel_diff=max(err_u[1], err_y[1]),
                   tol_rel_to_max_plain=BWD_TOL["float32"], ok=True)
        rows.append(row)
        print("bwd-check " + json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows


def dw_kernel_checks(torch, conv1d_brgemm, ref, model="mamba2",
                     shape=(DW_BATCH, DW_CHANNELS, DW_SEQ), more=True):
    """Phase 7: both depthwise kernels against their plain versions at the
    Mamba2-370M layer shape of the training cell (batch 8 x 2,048, C =
    2304, S = 4, CAUSAL): the forward (bf16 in, silu, fp32 out and
    preact), bwd-data (the padded fp32 cotangent against the flipped,
    widened taps, bf16 out) and bwd-weight (bf16 x, fp32 cotangent) with
    and without dbias, two launches of each bitwise equal; then (``more``)
    one fp32, one residual and one dilation-3 case.  Device, call, plain
    and library times beside the bound, the rate and the share of the
    bound for the three passes of the path.  ``model`` and ``shape`` (N,
    C, Q) name another model's layer (phase 20: Zamba2's)."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    (N, C, Q), S = shape, DW_TAPS
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, dtype=f32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE)
                ).to(dtype)

    def operands(d, dtype):
        span = (S - 1) * d
        return (rnd(N, C, Q + span, dtype=dtype),
                rnd(S, C, dtype=dtype, scale=S ** -0.5),
                rnd(C, dtype=dtype, scale=0.1), rnd(N, C, Q), span)

    def tol_of(t):
        return DW_TOL_BF16 if t.dtype == bf16 else DW_TOL_F32

    rows = []

    def record(label, pname, pairs, extra=None):
        errs = [_check_close(f"{label} {k}", got, want, tol_of(got))
                for k, (got, want) in pairs.items()]
        row = dict(shape=label, pass_=pname, N=N, C=C, Q=Q, S=S,
                   max_abs_err=max(e[0] for e in errs),
                   max_rel_diff=max(e[1] for e in errs),
                   tol_rel_to_max_plain={k: tol_of(g) for k, (g, _) in
                                         pairs.items()}, ok=True)
        row.update(extra or {})
        rows.append(row)
        print("dw-check " + json.dumps(row), flush=True)
        return row

    # the path's three passes, timed
    x, w, b, g, span = operands(1, bf16)
    g_pad = F.pad(g, (span, span))
    w_flip = w.flip(0).float().contiguous()
    w_c1s = w.t().unsqueeze(1).contiguous()          # (C, 1, S), torch's
    x32, w32_c1s = x.float(), w_c1s.float()

    def fwd():
        return conv1d_brgemm.depthwise_conv1d_fwd(
            x, w, bias=b, activation="silu", save_preact=True,
            out_dtype=f32)

    def fwd_plain():
        u = ref.depthwise_conv1d_preact_ref(x, w, bias=b)
        return F.silu(u), u

    def bwd_data():
        return conv1d_brgemm.depthwise_conv1d_fwd(g_pad, w_flip,
                                                  out_dtype=bf16)

    def bwd_w(with_dbias=True):
        return conv1d_brgemm.depthwise_conv1d_bwd_weight(
            x, g, S=S, with_dbias=with_dbias)

    def bwd_w_plain():
        return (ref.depthwise_conv1d_bwd_weight_ref(x, g),
                ref.conv1d_dbias_ref(g))

    Wp = Q + span
    # bytes: each input read once, each output written once; the ops are
    # fp32 FMAs whatever the input type
    passes = {
        "fwd": (fwd, fwd_plain,
                lambda: F.conv1d(x, w_c1s, b, groups=C),
                2.0 * N * C * S * Q,
                N * C * Wp * 2 + (S * C + C) * 2 + 2 * N * C * Q * 4),
        "bwd_data": (bwd_data, lambda: ref.depthwise_conv1d_bwd_data_ref(
            g, w.float(), out_dtype=bf16),
            lambda: torch.nn.grad.conv1d_input((N, C, Wp), w32_c1s, g,
                                               groups=C),
            2.0 * N * C * S * Q, N * C * Q * 4 + S * C * 4 + N * C * Wp * 2),
        "bwd_weight": (bwd_w, bwd_w_plain,
                       lambda: torch.nn.grad.conv1d_weight(
                           x32, (C, 1, S), g, groups=C),
                       2.0 * N * C * (S + 1) * Q,
                       N * C * Wp * 2 + N * C * Q * 4 + (S * C + C) * 4),
    }
    for pname, (kern, plain, lib, flops, nbytes) in passes.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        label = f"{pname} {model} C={C} N={N} Q={Q}"
        extra = {}
        if pname in ("fwd", "bwd_data"):
            again = kern()
            torch.cuda.synchronize()
            same = (torch.equal(again[0], got[0])
                    and torch.equal(again[1], got[1]) if pname == "fwd"
                    else torch.equal(again, got))
            if not same:
                raise AssertionError(f"{label}: two launches differ")
            extra["bitwise_two_launches"] = True
            # each thread: 8 outputs of one row, one register window for
            # all taps at dilation 1 (depthwise_conv1d_fwd.cu)
            extra["tile"] = "8 outputs a thread, one window"
        if pname == "fwd":
            pairs = {"out": (got[0], want[0]), "preact": (got[1], want[1])}
        elif pname == "bwd_data":
            pairs = {"dx": (got, want)}
        else:
            nod = bwd_w(with_dbias=False)
            again = bwd_w()
            torch.cuda.synchronize()
            if not (torch.equal(again[0], got[0])
                    and torch.equal(again[1], got[1])
                    and torch.equal(nod, got[0])):
                raise AssertionError(f"{label}: two launches differ")
            pairs = {"dw": (got[0], want[0]), "dbias": (got[1], want[1]),
                     "dw (no dbias)": (nod, want[0])}
            extra["bitwise_two_launches"] = True
        extra["kernel_ms"] = _device_ms(kern)
        extra["kernel_call_ms"] = _call_ms(kern)
        extra["plain_ms"] = _device_ms(plain, per_graph=2)
        extra["library_ms"] = _device_ms(lib)
        extra["bound_ms"], extra["bound_by"] = roofline.bound(
            flops, nbytes, "float32")
        _rates(extra, nbytes=nbytes)
        record(label, pname, pairs, extra)
    if not more:
        return rows

    # one fp32, one residual (gelu, bf16 out) and one dilation-3 case
    x, w, b, g, _ = operands(1, f32)
    y, u = conv1d_brgemm.depthwise_conv1d_fwd(x, w, bias=b,
                                              activation="silu",
                                              save_preact=True)
    record(f"fwd fp32 silu C={C}", "fwd", {
        "out": (y, F.silu(ref.depthwise_conv1d_preact_ref(x, w, bias=b))),
        "preact": (u, ref.depthwise_conv1d_preact_ref(x, w, bias=b))})
    dw, db = conv1d_brgemm.depthwise_conv1d_bwd_weight(x, g, S=S,
                                                       with_dbias=True)
    record(f"bwd_weight fp32 C={C}", "bwd_weight", {
        "dw": (dw, ref.depthwise_conv1d_bwd_weight_ref(x, g)),
        "dbias": (db, ref.conv1d_dbias_ref(g))})
    x, w, b, _, _ = operands(1, bf16)
    r = rnd(N, C, Q, dtype=bf16)
    record(f"fwd bf16 gelu+residual C={C}", "fwd", {"out": (
        conv1d_brgemm.depthwise_conv1d_fwd(x, w, bias=b, residual=r,
                                           activation="gelu"),
        ref.depthwise_conv1d_fused_ref(x, w, bias=b, residual=r,
                                       activation="gelu"))})
    x, w, b, g, _ = operands(3, bf16)
    record(f"fwd+bwd_weight dilation 3 C={C}", "fwd", {
        "out": (conv1d_brgemm.depthwise_conv1d_fwd(
            x, w, bias=b, activation="silu", dilation=3, out_dtype=f32),
            ref.depthwise_conv1d_fused_ref(x, w, bias=b, activation="silu",
                                           dilation=3, out_dtype=f32)),
        "dw": (conv1d_brgemm.depthwise_conv1d_bwd_weight(x, g, S=S,
                                                         dilation=3),
               ref.depthwise_conv1d_bwd_weight_ref(x, g, dilation=3))})
    torch.cuda.synchronize()
    return rows


def _batch(torch, synthetic, cfg, batch, seq, seed):
    """A synthetic batch of the config's family on the card."""
    return {k: torch.as_tensor(v).to(DEVICE) for k, v in
            synthetic.make_batch(cfg, batch, seq, seed=seed).items()}


def _seeded_model(torch, blocks, cfg, seed):
    """The stack from a seed, with random non-zero biases (zeros at init
    would leave the bias path untested)."""
    model = blocks.init_params(cfg, seed=seed, device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def model_grad_check(torch, configs, blocks, synthetic, adamw,
                     conv1d_brgemm):
    """Phase 5: the whole model's loss and gradients through the kernels
    against autograd over the plain version, then 3 AdamW steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("atacworks")
    model = _seeded_model(torch, blocks, cfg, seed=5)
    batch = _batch(torch, synthetic, cfg, GRAD_BATCH, GRAD_SEQ, 7)
    names = [n for n, _ in model.named_parameters()]

    def loss_and_grads(m, backend):
        params = [p for _, p in m.named_parameters()]
        loss, _ = blocks.loss_fn(m, cfg, batch, backend=backend)
        return loss.detach(), torch.autograd.grad(loss, params)

    (loss_k, grads_k), launched = _counted(
        (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight),
        lambda: loss_and_grads(model, None))
    launched = tuple(launched.values())
    loss_p, grads_p = loss_and_grads(model, "ref")
    torch.cuda.synchronize()
    if launched != (49, 25):
        raise AssertionError(f"one gradient launched {launched} kernels, "
                             "expected (49 conv1d_fwd, 25 bwd_weight)")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"loss through the kernels {loss_k.item()} vs "
                             f"plain {loss_p.item()}: rel {loss_rel}")
    if len(grads_k) != 50:
        raise AssertionError(f"{len(grads_k)} gradients, expected 50")
    worst = (0.0, "")
    for name, gk, gp in zip(names, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"non-finite gradient of {name}")
        _, rel = _check_close(f"grad {name}", gk, gp, GRAD_TOL)
        worst = max(worst, (rel, name))

    def adamw_steps(backend):
        m = copy.deepcopy(model)
        state = adamw.init(dict(m.named_parameters()))
        losses = []
        for _ in range(GRAD_STEPS):
            loss, grads = loss_and_grads(m, backend)
            grads = dict(zip(names, grads))
            gnorm = adamw.global_norm(grads)
            adamw.update_(grads, state, dict(m.named_parameters()),
                          lr=ADAMW_LR, grad_norm=gnorm,
                          finite=torch.isfinite(gnorm))
            losses.append(loss.item())
        return losses, m

    (steps_k, model_k), (steps_p, model_p) = (adamw_steps(None),
                                              adamw_steps("ref"))
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(steps_k, steps_p))
    if not step_rel <= LOSS_RTOL:
        raise AssertionError(f"AdamW losses through the kernels {steps_k} "
                             f"vs plain {steps_p}: rel {step_rel}")
    diffs = torch.cat([(pk.detach() - pp.detach()).abs().flatten()
                       for pk, pp in zip(model_k.parameters(),
                                         model_p.parameters())])
    beyond = int((diffs > PARAM_ATOL).sum().item())
    param_max = diffs.max().item()
    if beyond > PARAM_FLIP_FRAC * diffs.numel():
        raise AssertionError(
            f"after {GRAD_STEPS} AdamW steps {beyond} of {diffs.numel()} "
            f"parameters differ by more than {PARAM_ATOL} (max {param_max})")
    stats = dict(batch=GRAD_BATCH, seq=GRAD_SEQ, loss_kernel=loss_k.item(),
                 loss_plain=loss_p.item(), loss_rel_diff=loss_rel,
                 n_grads=len(grads_k), worst_grad_rel_diff=worst[0],
                 worst_grad=worst[1], grad_tol_rel_to_max_plain=GRAD_TOL,
                 adamw_losses_kernel=steps_k, adamw_losses_plain=steps_p,
                 adamw_loss_max_rel_diff=step_rel,
                 adamw_param_max_abs_diff=param_max,
                 adamw_params_beyond_atol=beyond, adamw_params=diffs.numel(),
                 adamw_param_atol=PARAM_ATOL,
                 launches_per_gradient=list(launched))
    print("model-grad " + json.dumps(stats), flush=True)
    return stats


def train_check(torch, np, train, conv1d_brgemm):
    """Phase 6: train atacworks through the launcher's own entry point."""
    torch.cuda.reset_peak_memory_stats()
    summary, launched = _counted(
        (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight),
        lambda: train.run(["--arch", "atacworks", "--steps",
                           str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ)]))
    fwd, bw = launched.values()
    losses = summary["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if (fwd, bw) != (49 * TRAIN_STEPS, 25 * TRAIN_STEPS):
        raise AssertionError(
            f"{fwd} conv1d_fwd and {bw} conv1d_bwd_weight launches in "
            f"{TRAIN_STEPS} steps; expected 49 and 25 per step")
    times = np.asarray(summary["step_s"][train.WARMUP_STEPS:])
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 losses=losses, step_s=summary["step_s"],
                 step_p50_ms=float(np.median(times) * 1e3),
                 step_min_ms=float(times.min() * 1e3),
                 step_max_ms=float(times.max() * 1e3),
                 samples_per_s=summary["samples_per_s"],
                 conv1d_fwd_launches=fwd, conv1d_bwd_weight_launches=bw,
                 fwd_launches_per_step=fwd / TRAIN_STEPS,
                 bwd_weight_launches_per_step=bw / TRAIN_STEPS,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    stats.update(_model_rate("atacworks", TRAIN_BATCH, TRAIN_SEQ,
                             stats["step_p50_ms"]))
    print("train " + json.dumps(stats), flush=True)
    return stats


def _model_rate(arch, batch, seq, step_ms):
    """A training step's useful work and least memory traffic by the
    roofline's count (``repro_torch.roofline.flops``: 6 N D plus the
    attention or SSD terms; 3x the forward for the conv net) and the rate
    the measured step ran at."""
    from repro_torch import configs
    from repro_torch.roofline import flops as counts

    cfg, shape = configs.get(arch), counts.StepShape("train", seq, batch)
    flops = counts.model_flops(cfg, shape)
    return dict(model_flops_per_step=flops,
                model_bytes_per_step=counts.model_bytes(cfg, shape),
                model_tflops_per_s=flops / (step_ms * 1e-3) / 1e12)


def _trace(torch, fn, port_names, per=1):
    """Run ``fn()`` under ``torch.profiler``; returns its result, the
    device kernels by name (calls, device ms per one of ``per`` units,
    ``port`` if the name holds one of ``port_names``; longest first), and
    each host op's self device ms per unit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()

    def dev_ms(e, self_only):
        for attr in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else
                     ("device_time_total", "cuda_time_total")):
            us = getattr(e, attr, None)
            if us is not None:
                return us / 1e3 / per
        return 0.0

    kernels, by_op = [], {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels.append(dict(
                name=e.key[:120], calls=e.count, ms_per_step=dev_ms(e, False),
                port=any(t in e.key for t in port_names)))
        else:
            by_op[e.key] = by_op.get(e.key, 0.0) + dev_ms(e, True)
    kernels.sort(key=lambda k: -k["ms_per_step"])
    return result, kernels, by_op


@contextlib.contextmanager
def _drawn_once(torch, train):
    """Within it, the launcher's ``init_model`` draws a language model's
    weights on the host once a (config, seed) and gives each run a model
    of them on its device: the values a draw to the device gives (the
    draw is on the host, a function of the seed alone), without a second
    draw's host time (a timed run and its traced run draw alike)."""
    real, kept = train.init_model, {}

    def init_model(cfg, *, seed=0, device="cpu"):
        if cfg.family == "conv":
            return real(cfg, seed=seed, device=device)
        key = (repr(cfg), seed)
        if key not in kept:
            host = real(cfg, seed=seed, device="cpu")
            kept[key] = type(host), host.state_dict()
        cls, leaves = kept[key]
        return cls(cfg, {k: t.to(device, copy=True)
                         for k, t in leaves.items()})

    train.init_model = init_model
    try:
        yield
    finally:
        train.init_model = real


def _profile_steps(torch, train, argv, steps, port_names):
    """Run the launcher with ``argv`` (``steps`` steps) under
    ``torch.profiler`` (``_trace``, per step)."""
    return _trace(torch, lambda: train.run(argv), port_names, steps)


# device kernels by name: cuBLAS's matrix products, and the sorts,
# gathers, scatters and searches (a MoE layer's routing and dispatch, the
# embedding's gradient, the loss's gather)
PRODUCT_KERNELS = ("nvjet", "gemm", "Gemm", "cutlass", "xmma")
GATHER_KERNELS = ("sort", "Sort", "radix", "index", "Index", "gather",
                  "Gather", "scatter", "Scatter", "searchsorted", "embedding",
                  "topk", "TopK", "bitonic")


def _train_breakdown(torch, train, label, argv, steps, port_names):
    """Where a training step's device time goes: the launcher with
    ``argv`` (``steps`` steps) under ``torch.profiler``, ``adamw.update_``
    in a ``record_function`` range and ``moe.moe_ffn`` in another; per
    step, the device ms of the port's kernels (``port_names``), of the
    matrix products (PRODUCT_KERNELS, by kernel name), of the sorts,
    gathers and scatters (GATHER_KERNELS), of AdamW (its range's span on
    the device's timeline: elementwise chains over every leaf, launched
    faster than they run, so back to back), the rest (elementwise work:
    norms, activations, rotary embeddings, the loss, casts, copies), the
    span of the MoE FFNs' forward and recompute (routing, dispatch, expert
    products, combine, and the device's waits on the host inside them),
    and the device's idle time against the steps' host-clock time; the
    upload of the model before the first step is left out."""
    from repro_torch.models import moe
    from repro_torch.optim import adamw

    def ranged(name, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return wrapped

    real = adamw.update_, moe.moe_ffn
    adamw.update_ = ranged("adamw.update_", adamw.update_)
    moe.moe_ffn = ranged("moe.moe_ffn", moe.moe_ffn)
    try:
        torch.cuda.empty_cache()
        summary, kernels, _ = _profile_steps(torch, train, argv, steps,
                                             port_names)
    finally:
        adamw.update_, moe.moe_ffn = real
    # the ranges show as device rows, their spans on the device's
    # timeline, gaps included: not kernels
    spans = {k["name"]: k["ms_per_step"] for k in kernels
             if k["name"] in ("adamw.update_", "moe.moe_ffn")}
    kernels = [k for k in kernels if k["name"] not in spans]
    step_ms = 1e3 * sum(summary["step_s"]) / steps
    upload = sum(k["ms_per_step"] for k in kernels
                 if k["name"].startswith("Memcpy HtoD"))
    busy = sum(k["ms_per_step"] for k in kernels) - upload

    def named(parts):
        return sum(k["ms_per_step"] for k in kernels if not k["port"]
                   and any(p in k["name"] for p in parts))

    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    products, gathers = named(PRODUCT_KERNELS), named(GATHER_KERNELS)
    opt = spans.get("adamw.update_", 0.0)
    stats = dict(steps=steps, traced_step_ms=step_ms,
                 upload_ms_per_step=upload, device_busy_ms_per_step=busy,
                 port_kernels_ms_per_step=ours,
                 products_ms_per_step=products,
                 sort_gather_ms_per_step=gathers,
                 adamw_ms_per_step=opt,
                 elementwise_and_rest_ms_per_step=(
                     busy - ours - products - gathers - opt),
                 moe_ffn_span_ms_per_step=spans.get("moe.moe_ffn", 0.0),
                 idle_ms_per_step=step_ms - busy,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernels_per_step=sum(
                     k["calls"] for k in kernels
                     if not k["name"].startswith("Memcpy HtoD")) / steps,
                 kernel_names=len(kernels), top=kernels[:15])
    print(f"{label}-breakdown " + json.dumps(stats), flush=True)
    return stats


def train_profile(torch, train):
    """Phase 6, second part: where a training step's time goes.
    PROFILE_STEPS more steps of the launcher under ``torch.profiler``
    (kept apart from the timed run, whose step times it would inflate):
    device time by kernel name per step, and the device's busy share,
    the kernels' summed time over the steps' summed host-clock time."""
    summary, kernels, _ = _profile_steps(
        torch, train, ["--arch", "atacworks", "--steps", str(PROFILE_STEPS),
                       "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)],
        PROFILE_STEPS, ("conv1d_fwd_kernel", "bwd_weight_partial",
                        "reduce_partials"))
    step_ms = 1e3 * sum(summary["step_s"]) / PROFILE_STEPS
    busy = sum(k["ms_per_step"] for k in kernels)
    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    stats = dict(steps=PROFILE_STEPS, traced_step_ms=step_ms,
                 device_busy_ms_per_step=busy,
                 port_kernels_ms_per_step=ours,
                 other_device_ms_per_step=busy - ours,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernel_names=len(kernels), top=kernels[:15])
    print("train-profile " + json.dumps(stats), flush=True)
    return stats


def _mamba2_model(torch, cfg, init_model, seed):
    """Mamba2 from a seed with random non-zero conv biases (zeros at init
    would leave the fused bias path untested)."""
    model = init_model(cfg, seed=seed, device=DEVICE)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        b = model.layers.mixer.conv_b
        b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    return model


def _model_grad_check(torch, losses, label, cfg, model, batch, run_kernel,
                      run_plain, counters, expected, why, n_grads,
                      scale_of=None):
    """The loss and every gradient of ``model`` on ``batch`` through the
    kernels (``run_kernel(tokens)`` -> logits, or an MoE model's (logits,
    aux), whose loss is JAX's total ``nll + AUX_WEIGHT * aux``) against
    autograd over the plain version (``run_plain``): the loss within
    LOSS_RTOL, each of the
    ``n_grads`` gradients finite and within GRAD_TOL of its leaf's
    largest value (of leaf ``scale_of[name]``'s where given: a leaf whose
    exact gradient is zero holds rounding noise on both sides); the
    kernel run must have launched ``counters`` ``expected`` times (``why``
    says what they are).  A leaf the loss does not read gets zeros."""
    from repro_torch.train.data_parallel import param_grads

    names, params = zip(*model.named_parameters())
    scale_of = scale_of or {}

    def loss_and_grads(run):
        out = run(batch["tokens"])
        logits, aux = out if isinstance(out, tuple) else (out, None)
        loss = losses.softmax_xent(logits, batch["labels"])
        if aux is not None:
            loss = loss + losses.AUX_WEIGHT * aux
        return loss.detach(), param_grads(loss, params)

    (loss_k, grads_k), launched = _counted(
        counters, lambda: loss_and_grads(run_kernel))
    launched = tuple(launched.values())
    loss_p, grads_p = loss_and_grads(run_plain)
    torch.cuda.synchronize()
    if launched != expected:
        raise AssertionError(f"{label}: one gradient launched {launched} of "
                             f"{[c.__name__ for c in counters]}, expected "
                             f"{expected} ({why})")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"{label} loss through the kernels "
                             f"{loss_k.item()} vs plain {loss_p.item()}: "
                             f"rel {loss_rel}")
    if len(grads_k) != n_grads:
        raise AssertionError(f"{len(grads_k)} gradients, expected {n_grads}")
    worst = (0.0, "")
    plain = dict(zip(names, grads_p))
    for name, gk, gp in zip(names, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"non-finite gradient of {name}")
        if name in scale_of:
            scale = plain[scale_of[name]].float().abs().max().item()
            rel = (gk.float() - gp.float()).abs().max().item() / scale
            if not rel <= GRAD_TOL:
                raise AssertionError(f"{label} grad {name}: {rel} of "
                                     f"max|{scale_of[name]}|")
        else:
            _, rel = _check_close(f"{label} grad {name}", gk, gp, GRAD_TOL)
        worst = max(worst, (rel, name))
    stats = dict(layers=cfg.n_layers, d_model=cfg.d_model,
                 batch=batch["tokens"].shape[0],
                 seq=batch["tokens"].shape[1], dtype=cfg.dtype,
                 remat=cfg.remat, loss_kernel=loss_k.item(),
                 loss_plain=loss_p.item(), loss_rel_diff=loss_rel,
                 n_grads=len(grads_k), worst_grad_rel_diff=worst[0],
                 worst_grad=worst[1], grad_tol_rel_to_max_plain=GRAD_TOL,
                 launches_per_gradient=list(launched))
    print(f"{label}-grad " + json.dumps(stats), flush=True)
    return stats


def _train_check(np, train, label, argv, steps, counters, per_step,
                 memory_limit_gb=None):
    """Train through the launcher's own entry point with ``argv``
    (``steps`` steps): every loss and gradient norm finite, no step
    skipped, ``counters`` launched ``per_step`` times a step, and peak
    device memory under ``memory_limit_gb`` where given.  Returns the
    step times, throughput, peak memory and launches."""
    summary, launches = _counted(counters, lambda: train.run(argv))
    losses = summary["losses"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{label} training losses {losses}")
    if not np.isfinite(summary["grad_norms"]).all():
        raise AssertionError(f"{label} gradient norms "
                             f"{summary['grad_norms']}")
    if summary["skipped_steps"]:
        raise AssertionError(f"{summary['skipped_steps']} {label} steps "
                             "skipped for a non-finite gradient norm")
    want = {c.__name__: n * steps for c, n in zip(counters, per_step)}
    if launches != want:
        raise AssertionError(f"{label}: {launches} launches in {steps} "
                             f"steps; expected {want}")
    if memory_limit_gb and not summary["peak_memory_gb"] < memory_limit_gb:
        raise AssertionError(f"{label}: peak device memory "
                             f"{summary['peak_memory_gb']} GB")
    times = np.asarray(summary["step_s"][train.WARMUP_STEPS:])
    stats = dict(argv=argv, steps=steps, losses=losses,
                 grad_norms=summary["grad_norms"], step_s=summary["step_s"],
                 step_p50_ms=float(np.median(times) * 1e3),
                 step_min_ms=float(times.min() * 1e3),
                 step_max_ms=float(times.max() * 1e3),
                 tokens_per_s=summary["tokens_per_s"],
                 samples_per_s=summary["samples_per_s"],
                 peak_memory_gb=summary["peak_memory_gb"],
                 launches=launches,
                 launches_per_step={k: n / steps for k, n in launches.items()})
    arg = dict(zip(argv[::2], argv[1::2]))
    stats.update(_model_rate(arg["--arch"], int(arg["--batch"]),
                             int(arg["--seq"]), stats["step_p50_ms"]))
    print(f"{label}-train " + json.dumps(stats), flush=True)
    return stats


def mamba2_grad_check(torch, configs, init_model, synthetic, losses,
                      conv1d_brgemm):
    """Phase 8: the whole Mamba2 gradient at the full widths (an fp32 copy
    of mamba2-370m cut to M2_GRAD_LAYERS layers, remat on) at batch 2 x
    512: the loss and all 12 gradients through the depthwise kernels
    against autograd over the plain version on the card, TF32 off."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("mamba2-370m"),
                              n_layers=M2_GRAD_LAYERS, dtype="float32")
    model = _mamba2_model(torch, cfg, init_model, seed=21)
    batch = _batch(torch, synthetic, cfg, M2_GRAD_BATCH, M2_GRAD_SEQ, 22)
    L = cfg.n_layers
    return _model_grad_check(
        torch, losses, "mamba2", cfg, model, batch,
        lambda x: model(x, backend=None), lambda x: model(x, backend="ref"),
        (conv1d_brgemm.depthwise_conv1d_fwd,
         conv1d_brgemm.depthwise_conv1d_bwd_weight), (3 * L, L),
        "forward, recompute and bwd-data; bwd-weight", 12)


def _m2_argv(steps):
    return ["--arch", "mamba2-370m", "--steps", str(steps), "--batch",
            str(M2_BATCH), "--seq", str(M2_SEQ)]


def mamba2_train_check(torch, np, train, conv1d_brgemm, n_layers):
    """Phase 9: train the full Mamba2-370M through the launcher's own entry
    point at batch 8 x 2,048 for M2_STEPS steps: every loss and gradient
    norm finite (no step skipped), the depthwise forward launched 3 x 48
    times a step (forward, remat recompute, bwd-data) and the weight
    gradient 48 times."""
    torch.cuda.empty_cache()
    return _train_check(
        np, train, "mamba2", _m2_argv(M2_STEPS), M2_STEPS,
        (conv1d_brgemm.depthwise_conv1d_fwd,
         conv1d_brgemm.depthwise_conv1d_bwd_weight),
        (3 * n_layers, n_layers))


def mamba2_profile(torch, train):
    """Phase 9, second part: M2_PROFILE_STEPS more steps under
    ``torch.profiler``: device time per step of the depthwise kernels, of
    the matrix products outside the SSD (``aten::mm``/``addmm``: the
    projections, the unembedding and their gradients, bf16), of the SSD's
    batched products (``aten::bmm``, fp32), of everything else, and the
    device's idle time against the steps' host-clock time."""
    n = M2_PROFILE_STEPS
    summary, kernels, by_op = _profile_steps(
        torch, train, _m2_argv(n), n,
        ("dw_fwd_kernel", "dw_bwd_weight_partial", "dw_reduce_partials"))
    step_ms = 1e3 * sum(summary["step_s"]) / n
    busy = sum(k["ms_per_step"] for k in kernels)
    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    mm = sum(by_op.get(k, 0.0) for k in ("aten::mm", "aten::addmm"))
    bmm = sum(by_op.get(k, 0.0) for k in ("aten::bmm", "aten::baddbmm"))
    stats = dict(steps=n, traced_step_ms=step_ms,
                 device_busy_ms_per_step=busy,
                 depthwise_kernels_ms_per_step=ours,
                 projection_matmuls_ms_per_step=mm,
                 ssd_bmm_ms_per_step=bmm,
                 other_device_ms_per_step=busy - ours - mm - bmm,
                 idle_ms_per_step=step_ms - busy,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernel_names=len(kernels), top=kernels[:15])
    print("mamba2-profile " + json.dumps(stats), flush=True)
    return stats


def _attn_flops(B, T, H, width, causal):
    """Flops of (B, H, T, T)-shaped products over the (query, key) pairs
    the mask keeps, ``width`` the sum of the products' inner or outer
    widths (a forward at one head dim hd: 2 hd)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    return 2.0 * B * H * width * pairs


def _attn_bound(B, T, H, width, causal, dtype_name, nbytes):
    """Least time of ``_attn_flops`` against ``nbytes`` (see ``_bound``)."""
    return roofline.bound(_attn_flops(B, T, H, width, causal), nbytes,
                          dtype_name)


def _flash_fwd_bytes(rows_q, rows_k, hd, vd, es):
    """The bytes ``flash_fwd`` must move: q and k in at hd, v in and o
    out at vd (``es`` bytes an element), lse out in fp32."""
    return (rows_q + rows_k) * (hd + vd) * es + rows_q * 4


def _flash_errs(label, pairs, lse, lse_p, bf16):
    """Each (kernel, plain) pair of ``pairs`` against its tolerance (bf16:
    per element; fp32: FA_TOL_F32 of the largest value) and lse within
    FA_TOL_LSE -> {name: (max_abs, max_abs / max|plain|, share of the
    per-element limit used or None)}."""
    errs = {"lse": (*_check_close(f"{label} lse", lse, lse_p, FA_TOL_LSE),
                    None)}
    for name, (got, want) in pairs.items():
        if bf16:
            errs[name] = _check_elementwise(f"{label} {name}", got, want,
                                            FA_RTOL_BF16, FA_ATOL_BF16)
        else:
            errs[name] = (*_check_close(f"{label} {name}", got, want,
                                        FA_TOL_F32), None)
    return errs


def _flash_err_fields(errs, bf16):
    """A flash-check row's error readings and the tolerances they meet."""
    fields = dict(max_abs_err={k: e[0] for k, e in errs.items()},
                  max_rel_diff={k: e[1] for k, e in errs.items()},
                  lse_tol_rel_to_max_plain=FA_TOL_LSE)
    if bf16:
        fields.update(rtol=FA_RTOL_BF16, atol_rel_to_max_plain=FA_ATOL_BF16,
                      elementwise_limit_use={k: e[2] for k, e in errs.items()
                                             if e[2] is not None})
    else:
        fields.update(tol_rel_to_max_plain=FA_TOL_F32)
    return fields


def _flash_operands(torch, gen, B, T, KV, G, hd, dtype, vd=None):
    """Seeded q (a (B, T, KV, G, hd) view of (B, T, H, hd)), k, v and dO;
    with ``vd`` < hd, v's and dO's columns past vd are zeros (the MLA
    block's padded v and the cotangent its slice passes back)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    q = rnd(B, T, KV * G, hd).view(B, T, KV, G, hd)
    k, v, do = rnd(B, T, KV, hd), rnd(B, T, KV, hd), rnd(B, T, KV, G, hd)
    if vd is not None and vd < hd:
        v[..., vd:] = 0
        do[..., vd:] = 0
    return q, k, v, do


def _flash_check(torch, fa, ref, gen, rows, label, B, T, KV, G, dtype,
                 causal, timed=(), hd=FA_HD, vd=None):
    """One flash-check row (appended to ``rows``): ``flash_fwd`` and
    ``flash_bwd`` against their plain versions on seeded operands, the
    backward from the kernel's o and lse, two backward launches bitwise
    equal, bf16 elements each within their own bound; for each pass in
    ``timed`` ("fwd", "bwd"; True: both) device, call, plain and SDPA
    times beside the bound.  ``vd`` < hd: v's and dO's columns past vd
    are zeros (MLA's padded v, ``_flash_operands``), and the bound counts
    the useful work: q and k at hd, v, o and dO at vd (the forward's two
    products of widths hd and vd, the backward's three of hd and two of
    vd), so the padding shows as lost share."""
    import torch.nn.functional as F

    timed = ("fwd", "bwd") if timed is True else tuple(timed)
    vd = hd if vd is None else vd
    q, k, v, do = _flash_operands(torch, gen, B, T, KV, G, hd, dtype, vd)

    def fwd():
        return fa.flash_fwd(q, k, v, causal=causal)

    o, lse = fwd()

    def bwd():
        return fa.flash_bwd(q, k, v, o, lse, do, causal=causal)

    grads, again = bwd(), bwd()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{label}: two flash_bwd launches differ")
    o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=causal)
    grads_p = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)
    bf16 = dtype == torch.bfloat16
    pairs = dict(o=(o, o_p), **{n: (g, gp) for n, g, gp in zip(
        ("dq", "dk", "dv"), grads, grads_p)})
    errs = _flash_errs(label, pairs, lse, lse_p, bf16)
    del o_p, lse_p, grads_p, again, pairs
    dtype_name = str(dtype).removeprefix("torch.")
    row = dict(shape=label, B=B, T=T, H=KV * G, KV=KV, hd=hd,
               dtype=dtype_name, causal=causal,
               **_flash_err_fields(errs, bf16),
               bitwise_two_bwd_launches=True, ok=True)
    if vd != hd:
        row["v_hd"] = vd
    if timed:
        H, es = KV * G, q.element_size()
        rows_q, rows_k = B * T * H, B * T * KV
        # fwd: q, k, v in, o and lse out; bwd: q, k, v, o, do, lse in,
        # dq, dk, dv out (delta is computed inside the call); q, k, dq
        # and dk hd wide, v, o, do and dv vd wide
        f_bytes = _flash_fwd_bytes(rows_q, rows_k, hd, vd, es)
        b_bytes = ((2 * rows_q + 2 * rows_k) * hd
                   + (2 * rows_q + 2 * rows_k) * vd) * es + rows_q * 4
        qt, kt, vt = (t.transpose(1, 2) for t in (
            q.reshape(B, T, H, hd), k, v))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

        def lib_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        o_lib = F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, enable_gqa=True)
        do_lib = do.reshape(B, T, H, hd).transpose(1, 2)

        def lib_bwd():
            return torch.autograd.grad(o_lib, (qg, kg, vg), do_lib,
                                       retain_graph=True)

        # the products' widths: fwd q.k^T (hd) and p.v (vd); bwd q.k^T,
        # dS.k and dS^T.q (hd), dO.v^T and p^T.dO (vd)
        for name, kern, plain, lib, width, nbytes in (
                ("fwd", fwd, lambda: ref.flash_fwd_ref(
                    q, k, v, causal=causal), lib_fwd, hd + vd, f_bytes),
                ("bwd", bwd, lambda: ref.flash_bwd_ref(
                    q, k, v, o, lse, do, causal=causal), lib_bwd,
                 3 * hd + 2 * vd, b_bytes)):
            if name not in timed:
                continue
            row[f"{name}_kernel_ms"] = _device_ms(kern, per_graph=2,
                                                  reps=3)
            row[f"{name}_kernel_call_ms"] = _call_ms(kern, reps=5)
            row[f"{name}_plain_ms"] = _call_ms(plain, reps=3)
            row[f"{name}_library_ms"] = _call_ms(lib, reps=5)
            (row[f"{name}_bound_ms"],
             row[f"{name}_bound_by"]) = _attn_bound(
                B, T, H, width, causal, dtype_name, nbytes)
            # the bound's flops over the kernel's time, and its share
            # of the bound
            row[f"{name}_tflops"] = (_attn_flops(B, T, H, width, causal)
                                     / row[f"{name}_kernel_ms"] / 1e9)
            row[f"{name}_bound_share"] = (row[f"{name}_bound_ms"]
                                          / row[f"{name}_kernel_ms"])
        del o_lib
    rows.append(row)
    print("flash-check " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()


def flash_kernel_checks(torch, fa, ref):
    """Phase 10: ``flash_fwd`` and ``flash_bwd`` against their plain
    versions at StarCoder2-3B's attention in the training cell (batch 4 x
    4,096, 24 heads over 2 KV heads of 128, bf16, causal; q a (B, T, KV,
    G, hd) view of the model's (B, T, H, hd)), the backward from the
    kernel's o and lse, two backward launches bitwise equal, each bf16
    element within its own bound; then the same shape in fp32, one
    non-causal, one G = 1 and one ragged case, the forward with a query
    offset at head_dim 64, and forward and backward with fewer queries
    than keys.  Device, call, plain and library times
    beside the bound at the cell's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    rows = []
    check = functools.partial(_flash_check, torch, fa, ref, gen, rows)
    bf16, f32 = torch.bfloat16, torch.float32
    check(f"cell B={FA_B} T={FA_T} KV={FA_KV} G={FA_G} bf16 causal", FA_B,
          FA_T, FA_KV, FA_G, bf16, True, timed=True)
    check(f"cell B={FA_B} T={FA_T} KV={FA_KV} G={FA_G} fp32 causal", FA_B,
          FA_T, FA_KV, FA_G, f32, True)
    check("bf16 non-causal T=2048", 1, 2048, FA_KV, FA_G, bf16, False)
    check("G=1 bf16 causal T=2048 (8 heads of their own)", 1, 2048, 8, 1,
          bf16, True)
    check("ragged T=1000 bf16 causal", 2, 1000, FA_KV, FA_G, bf16, True)
    check("hd=64 bf16 causal T=2048", 1, 2048, FA_KV, FA_G, bf16, True,
          hd=64)

    # queries at q_offset + t over a longer key row, head_dim 64: the
    # forward only (the backward, as in JAX, takes no offset)
    B, Tq, Tk, KV, G, hd, off = 1, 1024, 2048, 2, 4, 64, 1024

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(bf16)

    q, k, v = rnd(B, Tq, KV, G, hd), rnd(B, Tk, KV, hd), rnd(B, Tk, KV, hd)
    o, lse = fa.flash_fwd(q, k, v, causal=True, bq=256, q_offset=off)
    o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=True, q_offset=off)
    label = f"q_offset={off} Tq={Tq} Tk={Tk} hd={hd} bf16 causal forward"
    errs = _flash_errs(label, dict(o=(o, o_p)), lse, lse_p, True)
    row = dict(shape=label, B=B, T=Tq, Tk=Tk, H=KV * G, KV=KV, hd=hd,
               dtype="bfloat16", causal=True, q_offset=off,
               **_flash_err_fields(errs, True), ok=True)
    rows.append(row)
    print("flash-check " + json.dumps(row), flush=True)

    # the backward with fewer queries than keys (no offset: query t sees
    # keys 0..t, so keys past Tq get no gradient), head_dim 64
    do = rnd(B, Tq, KV, G, hd)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    grads = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    again = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    label = f"Tq={Tq} Tk={Tk} hd={hd} bf16 causal backward"
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{label}: two flash_bwd launches differ")
    o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=True)
    grads_p = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=True)
    errs = _flash_errs(label, dict(o=(o, o_p), **{
        n: (g, gp) for n, g, gp in zip(("dq", "dk", "dv"), grads, grads_p)}),
        lse, lse_p, True)
    row = dict(shape=label, B=B, T=Tq, Tk=Tk, H=KV * G, KV=KV, hd=hd,
               dtype="bfloat16", causal=True,
               **_flash_err_fields(errs, True),
               bitwise_two_bwd_launches=True, ok=True)
    rows.append(row)
    print("flash-check " + json.dumps(row), flush=True)
    return rows


def _lm_model(torch, cfg, init_model, seed, device=None):
    """StarCoder2, Whisper, Zamba2, Moonlight or DeepSeek-V3 from a seed
    with random non-zero biases and norm parameters (MLA's ``q_norm`` and
    ``kv_norm`` among them), Zamba2's conv biases, D, dt_bias and A_log
    and the MoE layers' router biases moved (zeros, ones and the init's
    values would leave those paths untested), on ``device`` (default
    DEVICE)."""
    model = init_model(cfg, seed=seed, device=device or DEVICE)
    gen = torch.Generator().manual_seed(seed + 100)
    stacks = ("dense_layers.", "moe_layers.", "enc_layers.", "dec_layers.",
              "layers.")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 2 or (p.dim() == 2 and not name.startswith(stacks)):
                continue  # projections, taps and the embeddings keep theirs
            noise = 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(p + noise.to(p.device, p.dtype))
    return model


def lm_grad_check(torch, configs, init_model, synthetic, losses, fa):
    """Phase 11: the whole StarCoder2-3B gradient at the full widths (an
    fp32 copy of the config cut to LM_GRAD_LAYERS layers, remat on) at
    batch 2 x 512: the loss and all 19 gradients through the flash
    kernels against autograd over the plain attention on the card, TF32
    off."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("starcoder2-3b"),
                              n_layers=LM_GRAD_LAYERS, dtype="float32",
                              attn_impl="flash")
    model = _lm_model(torch, cfg, init_model, seed=51)
    batch = _batch(torch, synthetic, cfg, LM_GRAD_BATCH, LM_GRAD_SEQ, 52)

    def run(attn_impl):
        def logits(tokens):
            model.cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
            return model(tokens)
        return logits

    L = cfg.n_layers
    return _model_grad_check(
        torch, losses, "starcoder2", cfg, model, batch, run("flash"),
        run("chunked"), (fa.flash_fwd, fa.flash_bwd), (2 * L, L),
        "forward and remat recompute; backward", 19)


def _lm_argv(steps):
    return ["--arch", "starcoder2-3b", "--attn-impl", "flash", "--steps",
            str(steps), "--batch", str(LM_BATCH), "--seq", str(LM_SEQ)]


def lm_train_check(torch, np, train, fa, n_layers):
    """Phase 12: train the full StarCoder2-3B through the launcher's own
    entry point at batch 4 x 4,096 for LM_STEPS steps: every loss and
    gradient norm finite (no step skipped), ``flash_fwd`` launched 2 x 30
    times a step (forward, remat recompute) and ``flash_bwd`` 30 times,
    peak device memory under LM_MEMORY_LIMIT_GB."""
    torch.cuda.empty_cache()
    return _train_check(np, train, "starcoder2", _lm_argv(LM_STEPS),
                        LM_STEPS, (fa.flash_fwd, fa.flash_bwd),
                        (2 * n_layers, n_layers), LM_MEMORY_LIMIT_GB)


def lm_profile(torch, train):
    """Phase 12, second part: LM_PROFILE_STEPS more steps under
    ``torch.profiler``: device time per step of the flash kernels, of the
    matrix products (``aten::mm``/``addmm``: the projections, the
    unembedding and their gradients, bf16), of everything else, and the
    device's idle time against the steps' host-clock time.  The window
    also holds the model's upload before the first step (host-to-device
    copies, outside the steps' time): it is reported apart."""
    torch.cuda.empty_cache()
    n = LM_PROFILE_STEPS
    summary, kernels, by_op = _profile_steps(
        torch, train, _lm_argv(n), n,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_"))
    step_ms = 1e3 * sum(summary["step_s"]) / n
    upload = sum(k["ms_per_step"] for k in kernels
                 if k["name"].startswith("Memcpy HtoD"))
    busy = sum(k["ms_per_step"] for k in kernels) - upload
    ours = sum(k["ms_per_step"] for k in kernels if k["port"])
    fwd_ms = sum(k["ms_per_step"] for k in kernels
                 if "flash_fwd_" in k["name"])
    mm = sum(by_op.get(k, 0.0) for k in ("aten::mm", "aten::addmm"))
    stats = dict(steps=n, traced_step_ms=step_ms,
                 upload_ms_per_step=upload,
                 device_busy_ms_per_step=busy,
                 flash_kernels_ms_per_step=ours,
                 flash_fwd_ms_per_step=fwd_ms,
                 flash_bwd_ms_per_step=ours - fwd_ms,
                 matmuls_ms_per_step=mm,
                 other_device_ms_per_step=busy - ours - mm,
                 idle_ms_per_step=step_ms - busy,
                 device_busy_share=busy / step_ms if step_ms else None,
                 kernel_names=len(kernels), top=kernels[:15])
    print("starcoder2-profile " + json.dumps(stats), flush=True)
    return stats


def sweep_check(sweep):
    """Phase 13: the paper's Figs 4-6 grid (``repro_torch.tune.sweep``):
    every cell's forward and forward + backward on the kernels (their own
    tiles), cuDNN (TF32 off) and ``"auto"`` after a measured tune of its
    three passes into a fresh cache; every result checked (see the sweep's
    ``--check``); one line a row, then one summary line a figure."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = sweep.run(grad=True, tuned=True, algs=True, check=True,
                        device="cuda", cache=os.path.join(tmp, "tune.json"),
                        iters=SWEEP_ITERS,
                        log=lambda r: print("sweep " + json.dumps(r),
                                            flush=True))
    for chk in res["checks"]:
        print("sweep-check " + json.dumps(chk), flush=True)
    for fig, summ in res["summary"].items():
        print(f"sweep-summary {fig} " + json.dumps(summ), flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"sweep: {len(res['checks'])} cells, {len(res['rows'])} rows in "
          f"{res['seconds']:.1f} s", flush=True)
    return res


def _decode_bound(cfg, batch, kv_len, cache_dtype):
    """The least time of one decode step at ``kv_len`` cached positions
    (``roofline.bound``) from the roofline's counts
    (``repro_torch.roofline.flops``: ``model_flops`` and
    ``hbm_bytes_decode`` of a decode step that leaves ``kv_len + 1``
    positions, the cache in ``cache_dtype``)."""
    from repro_torch.roofline import flops as counts
    shape = counts.StepShape("decode", kv_len + 1, batch)
    nbytes = counts.hbm_bytes_decode(cfg, shape, cache_dtype.itemsize)
    cache = counts.decode_cache_bytes(cfg, batch, kv_len + 1,
                                      cache_dtype.itemsize)
    ms, by = roofline.bound(counts.model_flops(cfg, shape), nbytes,
                            "bfloat16")
    return dict(bound_ms=ms, bound_by=by, param_bytes=nbytes - cache,
                cache_bytes=cache)


def _serve_lm_cell(torch, serve, counters, arch, cfg, model, batch):
    """One model's serving at full width: ``serve_lm`` (sequential prefill
    of LM_PROMPT tokens, LM_GEN generated) with no kernel launched, then
    the fused prefill step on the same prompt, whose last logits must
    match the decode's at the prompt's last position within
    ``serve.prefill_tol``, its launches counted; the fused prefill timed
    and traced, the decode traced for its busy share."""
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--seed", "61"]
    args = serve.parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the model and earlier leftovers
    model_bytes = sum(t.numel() * t.element_size() for t in
                      (*model.parameters(), *model.buffers()))
    stats, launched = _counted(counters,
                               lambda: serve.serve_lm(args, cfg, model))
    if any(launched.values()):
        raise AssertionError(f"{arch}: the decode steps launched {launched}")
    gap, prefill = _counted(counters, lambda: serve.prefill_gap(
        model, cfg, stats["prompt"], stats["prompt_logits"]))
    if not (gap["gap"] <= gap["tol"] and gap["tokens_equal"]):
        raise AssertionError(f"{arch}: fused prefill vs decode {gap}")
    peak = (torch.cuda.max_memory_allocated() - held + model_bytes) / 1e9
    step = serve.make_prefill_step(cfg)
    prompt = {"tokens": stats["prompt"]}
    prefill_call_ms = _call_ms(lambda: step(model, prompt), reps=5)
    _, kernels, _ = _trace(torch, lambda: step(model, prompt),
                           ("dw_fwd_kernel", "flash_fwd_"))
    prefill_dev = sum(k["ms_per_step"] for k in kernels)
    # the decode's busy share: LM_TRACE_PROMPT + LM_TRACE_GEN - 1 steps
    small = serve.parse_args(argv[:2] + [
        "--batch", str(batch), "--prompt-len", str(LM_TRACE_PROMPT),
        "--gen", str(LM_TRACE_GEN)])
    n = LM_TRACE_PROMPT + LM_TRACE_GEN - 1
    traced, dkernels, _ = _trace(
        torch, lambda: serve.serve_lm(small, cfg, model), (), n)
    traced_step_ms = (traced["prefill_s"] + sum(traced["step_s"])) * 1e3 / n
    busy = sum(k["ms_per_step"] for k in dkernels)
    cache_dtype = serve.lm_cache_dtype(cfg)
    kv_len = LM_PROMPT + LM_GEN // 2  # the generated steps' middle
    bound = _decode_bound(cfg, batch, kv_len, cache_dtype)
    out = dict(arch=arch, batch=batch, prompt_len=LM_PROMPT, gen=LM_GEN,
               dtype=cfg.dtype, cache_dtype=stats["cache_dtype"],
               sequential_prefill_s=stats["prefill_s"],
               step_p50_ms=stats["step_p50_ms"],
               step_p99_ms=stats["step_p99_ms"],
               tokens_per_s=stats["tokens_per_s"],
               decode_launches=launched, prefill_launches=prefill,
               prefill_vs_decode=gap, prefill_call_ms=prefill_call_ms,
               prefill_device_ms=prefill_dev,
               prefill_port_kernel_ms=sum(k["ms_per_step"] for k in kernels
                                          if k["port"]),
               peak_memory_gb=peak, model_gb=model_bytes / 1e9,
               decode_traced_step_ms=traced_step_ms,
               decode_device_busy_ms=busy,
               decode_device_busy_share=busy / traced_step_ms,
               decode_busy_share_of_p50=busy / stats["step_p50_ms"],
               decode_kernels_per_step=sum(k["calls"] for k in dkernels) / n,
               decode_bound_at_kv_len=kv_len, **bound,
               decode_bound_share=bound["bound_ms"] / stats["step_p50_ms"],
               decode_top=dkernels[:8])
    print(f"{arch}-serve " + json.dumps(out), flush=True)
    return out


def _fp32_prefill_check(torch, serve, init_model, cfg, arch, seed, counters):
    """A 2-layer fp32 copy of a config at its full widths: the fused
    prefill against the sequential decode at ``serve.prefill_tol``'s fp32
    tolerance, TF32 off."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = dataclasses.replace(cfg, n_layers=LM_FP32_LAYERS, dtype="float32")
    model = (_mamba2_model(torch, c, init_model, seed) if c.family == "ssm"
             else _lm_model(torch, c, init_model, seed))
    args = serve.parse_args(["--arch", arch, "--batch", str(LM_FP32_BATCH),
                             "--prompt-len", str(LM_PROMPT), "--gen", "4",
                             "--seed", str(seed)])
    stats = serve.serve_lm(args, c, model)
    gap, launched = _counted(counters, lambda: serve.prefill_gap(
        model, c, stats["prompt"], stats["prompt_logits"]))
    if not (gap["gap"] <= gap["tol"] and gap["tokens_equal"]):
        raise AssertionError(f"{arch} fp32: fused prefill vs decode {gap}")
    out = dict(arch=arch, layers=c.n_layers, dtype=c.dtype,
               attn_impl=c.attn_impl, batch=LM_FP32_BATCH,
               prompt_len=LM_PROMPT, prefill_vs_decode=gap,
               prefill_launches=launched)
    print(f"{arch}-fp32-prefill " + json.dumps(out), flush=True)
    return out


def _stream_check(torch, ops, ref, counters):
    """``depthwise_conv1d_streaming`` at Mamba2-370M's conv (batch 8 x
    2304 channels, S = 4, bf16 in, bias + silu, fp32 out) over a
    STREAM_SEQ-column stream: STREAM_ONES chunks of 1 column, then chunks
    of STREAM_CHUNK, then the ragged rest, from a fresh state.  The
    streamed outputs bitwise equal to the one-shot causal kernel call and
    within DW_TOL_F32 of the plain version, the last state bitwise the
    stream's last 3 columns; a stream step's call time at 1 and at
    STREAM_CHUNK columns."""
    gen = torch.Generator(device=DEVICE).manual_seed(81)
    N, C, S, T = M2_SERVE_BATCH, DW_CHANNELS, DW_TAPS, STREAM_SEQ
    bf16, f32 = torch.bfloat16, torch.float32
    x = torch.randn((N, C, T), generator=gen, device=DEVICE).to(bf16)
    w = (S ** -0.5 * torch.randn((S, C), generator=gen, device=DEVICE)
         ).to(bf16)
    b = (0.1 * torch.randn((C,), generator=gen, device=DEVICE)).to(bf16)
    kw = dict(bias=b, activation="silu", out_dtype=f32)
    rest = T - STREAM_ONES
    widths = [1] * STREAM_ONES + [STREAM_CHUNK] * (rest // STREAM_CHUNK)
    if rest % STREAM_CHUNK:
        widths.append(rest % STREAM_CHUNK)

    def stream():
        state = ops.conv_stream_state(N, C, S, 1, bf16, DEVICE)
        outs, lo = [], 0
        for width in widths:
            y, state = ops.depthwise_conv1d_streaming(
                x[:, :, lo:lo + width], w, state=state, **kw)
            outs.append(y)
            lo += width
        return torch.cat(outs, dim=-1), state

    with torch.inference_mode():
        (got, state), launched = _counted(counters, stream)
        launched = launched["depthwise_conv1d_fwd"]
        whole = ops.depthwise_conv1d(x, w, padding="CAUSAL", **kw)
        plain = ref.depthwise_conv1d_fused_ref(
            torch.nn.functional.pad(x, (S - 1, 0)), w, **kw)
    torch.cuda.synchronize()
    if launched != len(widths):
        raise AssertionError(f"stream: {launched} launches for "
                             f"{len(widths)} chunks")
    if not torch.equal(got, whole):
        raise AssertionError("stream: the chunked outputs differ from the "
                             "one-shot causal kernel call (max diff "
                             f"{(got - whole).abs().max().item()})")
    if not torch.equal(state, x[:, :, -(S - 1):]):
        raise AssertionError("stream: the last state is not the stream's "
                             "last columns")
    max_abs, rel = _check_close("stream vs plain", got, plain, DW_TOL_F32)
    st1 = ops.conv_stream_state(N, C, S, 1, bf16, DEVICE)
    row = dict(shape=f"stream N={N} C={C} S={S} T={T}", chunks=len(widths),
               widths=sorted(set(widths)), launches=launched,
               bitwise_one_shot=True, max_abs_err=max_abs,
               max_rel_diff=rel, tol_rel_to_max_plain=DW_TOL_F32)
    for width in (1, STREAM_CHUNK):
        xs = x[:, :, :width].contiguous()
        row[f"step_call_ms_q{width}"] = _call_ms(
            lambda: ops.depthwise_conv1d_streaming(xs, w, state=st1, **kw))
    print("dw-stream " + json.dumps(row), flush=True)
    return row


def _prefill_kernel_rows(torch, conv1d_brgemm, fa, ref):
    """The two kernels of the fused prefill at its shapes against their
    plain versions, timed beside the bound and the library call:
    ``depthwise_conv1d_fwd`` at Mamba2-370M's (8 x 2304, 3 + LM_PROMPT
    columns, bf16 in, bias + silu, fp32 out), ``flash_fwd`` at
    StarCoder2-3B's (batch 4 x LM_PROMPT, 24 heads over 2 KV of 128,
    bf16, causal; LM_PROMPT is not a multiple of the kernel's tile)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(91)
    bf16, f32 = torch.bfloat16, torch.float32
    N, C, S, Q = M2_SERVE_BATCH, DW_CHANNELS, DW_TAPS, LM_PROMPT
    Wp = Q + S - 1
    x = torch.randn((N, C, Wp), generator=gen, device=DEVICE).to(bf16)
    w = (S ** -0.5 * torch.randn((S, C), generator=gen, device=DEVICE)
         ).to(bf16)
    b = (0.1 * torch.randn((C,), generator=gen, device=DEVICE)).to(bf16)
    w_c1s = w.t().unsqueeze(1).contiguous()

    def dw():
        return conv1d_brgemm.depthwise_conv1d_fwd(
            x, w, bias=b, activation="silu", out_dtype=f32)

    def dw_plain():
        return ref.depthwise_conv1d_fused_ref(x, w, bias=b,
                                              activation="silu",
                                              out_dtype=f32)

    max_abs, rel = _check_close("prefill dw", dw(), dw_plain(), DW_TOL_F32)
    nbytes = N * C * Wp * 2 + (S * C + C) * 2 + N * C * Q * 4
    def dw_library():
        return F.conv1d(x, w_c1s, b, groups=C)

    dw_row = dict(shape=f"prefill mamba2 N={N} C={C} Q={Q}",
                  max_abs_err=max_abs, max_rel_diff=rel,
                  kernel_ms=_device_ms(dw), plain_ms=_device_ms(dw_plain),
                  library_ms=_device_ms(dw_library), call_ms=_call_ms(dw),
                  library_call_ms=_call_ms(dw_library))
    dw_row["bound_ms"], dw_row["bound_by"] = roofline.bound(
        2.0 * N * C * S * Q, nbytes, "float32")
    _rates(dw_row, nbytes=nbytes)

    B, T, KV, G, hd = SC2_SERVE_BATCH, LM_PROMPT, FA_KV, FA_G, FA_HD
    H = KV * G
    q = torch.randn((B, T, H, hd), generator=gen, device=DEVICE).to(
        bf16).view(B, T, KV, G, hd)
    k, v = (torch.randn((B, T, KV, hd), generator=gen, device=DEVICE).to(
        bf16) for _ in range(2))
    bq = min(256, T)  # the model's query tile, min(attn_chunk, T)

    def fl():
        return fa.flash_fwd(q, k, v, causal=True, bq=bq)

    (o, lse), (o_p, lse_p) = fl(), ref.flash_fwd_ref(q, k, v, causal=True)
    errs = _flash_errs("prefill flash", {"o": (o, o_p)}, lse, lse_p, True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q.reshape(B, T, H, hd), k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    f_bytes = (2 * B * T * H * hd + 2 * B * T * KV * hd) * 2 + B * T * H * 4
    fl_row = dict(shape=f"prefill starcoder2 B={B} T={T} H={H} KV={KV} "
                  f"hd={hd} bf16 causal", **_flash_err_fields(errs, True),
                  kernel_ms=_device_ms(fl), plain_ms=_device_ms(
                      lambda: ref.flash_fwd_ref(q, k, v, causal=True)),
                  library_ms=_device_ms(sdpa), call_ms=_call_ms(fl),
                  library_call_ms=_call_ms(sdpa))
    fl_row["bound_ms"], fl_row["bound_by"] = _attn_bound(
        B, T, H, 2 * hd, True, "bfloat16", f_bytes)
    fl_row["bound_share"] = fl_row["bound_ms"] / fl_row["kernel_ms"]
    torch.cuda.synchronize()
    for row in (dw_row, fl_row):
        print("prefill-kernel " + json.dumps(row), flush=True)
    return dw_row, fl_row


def lm_serve_check(torch, configs, init_model, serve, ops, ref,
                   conv1d_brgemm, fa):
    """Phase 14: serve Mamba2-370M and StarCoder2-3B at their published
    widths (``_serve_lm_cell``), Mamba2's conv stream (``_stream_check``),
    the prefill's two kernels at its shapes (``_prefill_kernel_rows``),
    and a 2-layer fp32 copy of each at full width
    (``_fp32_prefill_check``)."""
    import dataclasses
    counters = _counters(conv1d_brgemm, fa)
    out = {}
    m2 = configs.get("mamba2-370m")
    model = _mamba2_model(torch, m2, init_model, seed=61)
    out["mamba2"] = _serve_lm_cell(torch, serve, counters, "mamba2-370m", m2,
                                   model, M2_SERVE_BATCH)
    del model
    sc2 = dataclasses.replace(configs.get("starcoder2-3b"), attn_impl="flash")
    model = _lm_model(torch, sc2, init_model, seed=71)
    out["starcoder2"] = _serve_lm_cell(torch, serve, counters,
                                       "starcoder2-3b", sc2, model,
                                       SC2_SERVE_BATCH)
    del model
    torch.cuda.empty_cache()
    want = {"mamba2": ("depthwise_conv1d_fwd", m2.n_layers),
            "starcoder2": ("flash_fwd", sc2.n_layers)}
    for key, (name, n) in want.items():
        got = out[key]["prefill_launches"]
        if got != {**{k: 0 for k in got}, name: n}:
            raise AssertionError(f"{key}: one fused prefill launched {got}; "
                                 f"expected {n} {name} and nothing else")
    out["stream"] = _stream_check(torch, ops, ref, counters)
    out["prefill_kernels"] = _prefill_kernel_rows(torch, conv1d_brgemm, fa,
                                                  ref)
    out["fp32"] = [
        _fp32_prefill_check(torch, serve, init_model, m2, "mamba2-370m", 62,
                            counters),
        _fp32_prefill_check(torch, serve, init_model, sc2, "starcoder2-3b",
                            72, counters)]
    for key in ("mamba2", "starcoder2"):
        r = out[key]
        gap = r["prefill_vs_decode"]
        print(f"{key} serving: decode step p50 {r['step_p50_ms']:.3f} ms, "
              f"p99 {r['step_p99_ms']:.3f} ms, {r['tokens_per_s']:.1f} "
              f"tokens/s, sequential prefill {r['sequential_prefill_s']:.3f}"
              f" s, fused prefill {r['prefill_device_ms']:.3f} ms of device "
              f"time ({r['prefill_call_ms']:.3f} ms a call), peak "
              f"{r['peak_memory_gb']:.2f} GB, decode busy "
              f"{r['decode_device_busy_share']:.3f}, decode bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['decode_bound_share']:.3f} of p50), prefill vs decode "
              f"{gap['gap']:.4g} (tol {gap['tol']:.4g}; tokens checked in "
              f"{gap['rows_with_clear_margin']} of {r['batch']} rows)",
              flush=True)
    return out


def _dp_sharded_ops(torch, ops, sharded, conv1d_brgemm, group, rank, st):
    """Phase 15 (b), in one rank: ``sharded_conv1d`` at an AtacWorks layer
    and ``sharded_depthwise_conv1d`` at the Mamba2 conv layer (fp32), on
    this rank's rows of a seeded global batch, against the unsharded op on
    the whole batch in the same process, on the kernels and through the
    plain version: the rank's output rows within TOL, the w and bias
    gradients (summed over the ranks by the wrapper) within BWD_TOL of
    the largest value.  Each wrapper's kernels are counted in their own
    call (``_check_dp_counts``)."""
    dev = st["device"]
    gen = torch.Generator().manual_seed(11)
    N, n = st["batch"], st["batch"] // st["world"]
    rows = slice(rank * n, (rank + 1) * n)
    cases = (
        ("conv1d 15->15 b+relu", sharded.sharded_conv1d, ops.conv1d,
         (N, 15, st["seq"]), (51, 15, 15), 15,
         dict(activation="relu", dilation=8, padding="SAME"),
         (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight)),
        ("depthwise b+silu", sharded.sharded_depthwise_conv1d,
         ops.depthwise_conv1d, (N, st["dw_channels"], st["dw_seq"]),
         (4, st["dw_channels"]), st["dw_channels"],
         dict(activation="silu", padding="CAUSAL"),
         (conv1d_brgemm.depthwise_conv1d_fwd,
          conv1d_brgemm.depthwise_conv1d_bwd_weight)))
    out = []
    for label, shard_fn, plain_fn, xs, ws, nb, kw, counters in cases:
        x = torch.randn(xs, generator=gen).to(dev)
        w0 = (0.1 * torch.randn(ws, generator=gen)).to(dev)
        b0 = (0.1 * torch.randn(nb, generator=gen)).to(dev)
        g = torch.randn((xs[0], nb, xs[2]), generator=gen).to(dev)

        def run(fn, xx, gg, **extra):
            w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
            y = fn(xx, w, bias=b, **kw, **extra)
            (y * gg).sum().backward()
            return y.detach(), w.grad, b.grad

        (y, dw, db), launched = _counted(
            counters, lambda: run(shard_fn, x[rows].contiguous(),
                                  g[rows].contiguous(), group=group))
        row = dict(op=label, shape=list(xs), rank=rank, launches=launched)
        rtol, atol = TOL["float32"]
        for ref_name, extra in (("", {}), ("plain_", dict(backend="ref"))):
            y1, dw1, db1 = run(plain_fn, x, g, **extra)
            what = f"the unsharded op{' (plain)' if extra else ''}"
            fwd_err = (y - y1[rows]).abs().max().item()
            if not ((y - y1[rows]).abs()
                    <= atol + rtol * y1[rows].abs()).all():
                raise AssertionError(f"sharded {label}: rank {rank}'s rows "
                                     f"differ from {what} by {fwd_err}")
            row.update({
                f"{ref_name}fwd_max_abs": fwd_err,
                f"{ref_name}fwd_bitwise": bool(torch.equal(y, y1[rows])),
                f"{ref_name}dw_rel_err": _check_close(
                    f"sharded {label} dw vs {what}", dw, dw1,
                    BWD_TOL["float32"])[1],
                f"{ref_name}dbias_rel_err": _check_close(
                    f"sharded {label} dbias vs {what}", db, db1,
                    BWD_TOL["float32"])[1]})
        out.append(row)
    return out


def _dp_kernel_rows(torch, conv1d_brgemm):
    """Phase 15 (a), the kernels at the shapes the data-parallel path
    gives them, against their plain versions within BWD_TOL (as phase 4)
    and timed beside the bound and the library call: a rank's 15->15
    layer at its local batch DP_BATCH / DP_RANKS x DP_SEQ (forward,
    bwd-data, bwd-weight) and bwd-weight on the first of DP_CHUNKS width
    ranges, with the two copies that range's slices take
    (``ops._param_grads``) timed on their own."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    N, Q, S, d, C = DP_BATCH // DP_RANKS, DP_SEQ, 51, 8, 15
    span = (S - 1) * d
    x = torch.randn((N, C, Q + span), generator=gen, device=DEVICE)
    w = torch.randn((S, C, C), generator=gen, device=DEVICE) * (C * S) ** -0.5
    b = 0.1 * torch.randn((C,), generator=gen, device=DEVICE)
    g = torch.randn((N, C, Q), generator=gen, device=DEVICE)
    g_pad = F.pad(g, (span, span))
    w_t = w.flip(0).transpose(1, 2).contiguous()
    w_kcs = w.permute(1, 2, 0).contiguous()
    lo, hi = ops._chunk_ranges(Q, DP_CHUNKS)[0]
    xc = x[:, :, lo:hi + span].contiguous()
    gc = g[:, :, lo:hi].contiguous()

    def bwd_w(xx, gg):
        return lambda: conv1d_brgemm.conv1d_bwd_weight(
            xx, gg, S=S, dilation=d, with_dbias=True)

    def bwd_w_plain(xx, gg):
        return lambda: (ref.conv1d_bwd_weight_ref(xx, gg, dilation=d),
                        ref.conv1d_dbias_ref(gg))

    def bwd_w_lib(xx, gg):
        return lambda: torch.nn.grad.conv1d_weight(xx, (C, C, S), gg,
                                                   dilation=d)

    def nbytes(n, q):
        return (n * C * (q + span) + n * C * q + S * C * C + C) * 4

    fwd_flops = 2.0 * N * C * C * S * Q
    cases = (
        ("fwd", N, Q, lambda: conv1d_brgemm.conv1d_fwd(
            x, w, bias=b, activation="relu", dilation=d),
         lambda: ref.conv1d_fused_ref(x, w, bias=b, activation="relu",
                                      dilation=d),
         lambda: F.conv1d(x, w_kcs, b, dilation=d), fwd_flops, "float32"),
        ("bwd_data", N, Q, lambda: conv1d_brgemm.conv1d_fwd(
            g_pad, w_t, dilation=d),
         lambda: ref.conv1d_bwd_data_ref(g, w, dilation=d),
         lambda: torch.nn.grad.conv1d_input((N, C, Q + span), w_kcs, g,
                                            dilation=d),
         fwd_flops, "float32"),
        ("bwd_weight", N, Q, bwd_w(x, g), bwd_w_plain(x, g),
         bwd_w_lib(x, g), roofline.tf32_flops(N, C, C, S, Q), "tf32"),
        ("bwd_weight chunk", N, hi - lo, bwd_w(xc, gc), bwd_w_plain(xc, gc),
         bwd_w_lib(xc, gc), roofline.tf32_flops(N, C, C, S, hi - lo),
         "tf32"))
    rows = []
    for name, n, q, kern, plain, lib, flops, kind in cases:
        label = f"dp {name} 15->15 N={n} Q={q}"
        got, want = kern(), plain()
        if isinstance(got, tuple):
            errs = [_check_close(f"{label} {part}", a, p_, BWD_TOL["float32"])
                    for part, a, p_ in zip(("dw", "dbias"), got, want)]
            max_abs, max_rel = (max(e[0] for e in errs),
                                max(e[1] for e in errs))
        else:
            max_abs, max_rel = _check_close(label, got, want,
                                            BWD_TOL["float32"])
        row = dict(shape=label, pass_=name, N=n, Q=q, max_abs_err=max_abs,
                   max_rel_diff=max_rel,
                   tol_rel_to_max_plain=BWD_TOL["float32"],
                   kernel_ms=_device_ms(kern),
                   plain_ms=_device_ms(plain, per_graph=2),
                   library_ms=_device_ms(lib))
        row["bound_ms"], row["bound_by"] = roofline.bound(flops,
                                                          nbytes(n, q), kind)
        _rates(row, flops=2.0 * n * C * C * S * q)
        rows.append(row)
    rows[-1]["slice_copies_ms"] = _device_ms(
        lambda: (x[:, :, lo:hi + span].contiguous(),
                 g[:, :, lo:hi].contiguous()))
    torch.cuda.synchronize()
    for row in rows:
        print("dp-kernel " + json.dumps(row), flush=True)
    return rows


def _dp_rank(rank, st):
    """Phase 15, one of ``st["world"]`` gloo ranks sharing the card: the
    data-parallel gradient of the full AtacWorks model at this rank's
    share of the seeded global batch, unchunked and chunked (counted, then
    timed), and the sharded ops; the results go to a file the parent
    reads."""
    import torch

    from repro_torch import configs
    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    from repro_torch.kernels import conv1d_brgemm, ops, sharded
    from repro_torch.launch import mesh
    from repro_torch.train.data_parallel import (make_sharded_grad_fn,
                                                 shard_batch)

    global DEVICE
    DEVICE = st["device"]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    group = mesh.init_data_group("gloo", f"file://{st['store']}",
                                 st["world"], rank)
    try:
        cfg = configs.get("atacworks")
        model = _seeded_model(torch, blocks, cfg, seed=5)
        batch = shard_batch(_batch(torch, synthetic, cfg, st["batch"],
                                   st["seq"], 7), group)
        out = {}
        for chunks in (1, st["chunks"]):
            fn = make_sharded_grad_fn(cfg, group, grad_reduce_chunks=chunks)
            mesh.GradReducer.launches = 0
            ((loss, _), grads), launched = _counted(
                (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight),
                lambda: fn(model, batch))
            reduces = mesh.GradReducer.launches
            pending = fn.reducer.pending
            grads = [g.detach().cpu() for g in grads]
            times = []
            for _ in range(st["timed"]):
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(model, batch)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[chunks] = dict(loss=float(loss), grads=grads,
                               launches=launched, all_reduces=reduces,
                               pending_after=pending, grad_ms=times)
        out["sharded"] = _dp_sharded_ops(torch, ops, sharded, conv1d_brgemm,
                                         group, rank, st)
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(st["out"], f"rank{rank}.pt"))


def _dp_nccl_run(torch, train, conv1d_brgemm, mesh, store, steps):
    """Phase 15 (c): the launcher over an NCCL group of one rank (every
    layer's all-reduce issued; on one rank NCCL sums in place with no
    device work): ``steps`` steps counted and timed, then
    DP_PROFILE_STEPS under ``torch.profiler``: per step, the calls and
    host time of the collective ops (names holding "nccl" or "c10d") and
    the device time of NCCL's kernels and of all kernels; the group
    ended."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dist.init_process_group(DP_NCCL_BACKEND, init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        argv = ["--arch", "atacworks", "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ)]
        mesh.GradReducer.launches = 0
        summary, launched = _counted(
            (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight),
            lambda: train.run(argv + ["--steps", str(steps)]))
        reduces = mesh.GradReducer.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = train.run(argv + ["--steps", str(DP_PROFILE_STEPS)])
            torch.cuda.synchronize()
    finally:
        mesh.destroy()

    def per_step(us):
        return (us or 0.0) / 1e3 / DP_PROFILE_STEPS

    ops, busy, nccl_dev = {}, 0.0, 0.0
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        key = e.key.lower()
        if e.device_type == DeviceType.CUDA:
            busy += per_step(dev)
            if "nccl" in key or "allreduce" in key:
                nccl_dev += per_step(dev)
        elif "nccl" in key or "c10d" in key:
            ops[e.key[:80]] = dict(calls_per_step=e.count / DP_PROFILE_STEPS,
                                   host_ms_per_step=per_step(e.cpu_time_total))
    return summary, launched, reduces, dict(
        traced_step_ms=1e3 * sum(traced["step_s"]) / DP_PROFILE_STEPS,
        device_busy_ms_per_step=busy,
        all_reduce_device_ms_per_step=nccl_dev, collective_ops=ops)


def dp_check(torch, np, configs, train, conv1d_brgemm):
    """Phase 15: data parallelism.  (a, b) DP_RANKS gloo ranks sharing the
    one card (NCCL refuses two ranks on one GPU): the full AtacWorks
    gradient at the global batch DP_BATCH x DP_SEQ, split, against the
    one-process gradient at the global batch on the kernels and through
    the plain version, unchunked and with ``grad_reduce_chunks=DP_CHUNKS``,
    the kernels at the path's shapes against their plain versions
    (``_dp_kernel_rows``), and the sharded ops; (c) the
    launcher over an NCCL group of one rank, DP_NCCL_STEPS steps beside
    the plain launcher's in this call, and the all-reduce's device time
    from ``torch.profiler``."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh
    from repro_torch.train.data_parallel import make_sharded_grad_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("atacworks")
    model = _seeded_model(torch, blocks, cfg, seed=5)
    batch = _batch(torch, synthetic, cfg, DP_BATCH, DP_SEQ, 7)
    names = [n for n, _ in model.named_parameters()]
    (loss1, _), grads1 = make_sharded_grad_fn(cfg, None)(model, batch)
    grads1 = [g.detach().cpu() for g in grads1]
    # the one-process gradient through the plain version (autograd over
    # ``ref``), which every gradient below is also held to
    loss_p, _ = blocks.loss_fn(model, cfg, batch, backend="ref")
    grads_p = [g.detach().cpu() for g in torch.autograd.grad(
        loss_p, [p for _, p in model.named_parameters()])]
    loss_p = float(loss_p.detach())
    del model, batch

    def vs_plain(label, loss, grads):
        """The loss within LOSS_RTOL and each leaf within GRAD_TOL of its
        largest plain value; the worst leaf's max|diff| / max|plain|."""
        rel = abs(loss - loss_p) / abs(loss_p)
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"{label}: loss {loss} vs plain {loss_p}")
        return max((_check_close(f"{label} grad {name} vs plain", g, gp,
                                 GRAD_TOL)[1], name)
                   for name, g, gp in zip(names, grads, grads_p))

    one_vs_plain = vs_plain("one-process dp", float(loss1), grads1)
    kernel_rows = _dp_kernel_rows(torch, conv1d_brgemm)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        st = dict(device=DEVICE, world=DP_RANKS, batch=DP_BATCH, seq=DP_SEQ,
                  chunks=DP_CHUNKS, timed=DP_TIMED, store=f"{tmp}/store",
                  out=tmp, dw_channels=DW_CHANNELS, dw_seq=DW_SEQ)
        t0 = time.perf_counter()
        mp.start_processes(_dp_rank, args=(st,), nprocs=DP_RANKS,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(DP_RANKS)]
        stats = dict(card=_card_line(), ranks=DP_RANKS, backend="gloo",
                     batch=DP_BATCH,
                     seq=DP_SEQ, chunks=DP_CHUNKS, grad_tol=DP_TOL,
                     grad_tol_plain=GRAD_TOL, loss_one_process=float(loss1),
                     loss_plain=loss_p,
                     one_process_worst_grad_rel_to_max_plain=one_vs_plain[0],
                     one_process_worst_grad_plain=one_vs_plain[1],
                     kernel_rows=kernel_rows, ranks_wall_s=ranks_s)
        for chunks in (1, DP_CHUNKS):
            worst, worst_p = (0.0, ""), (0.0, "")
            for r, out in enumerate(res):
                o = out[chunks]
                rel = abs(o["loss"] - float(loss1)) / abs(float(loss1))
                if not rel <= LOSS_RTOL:
                    raise AssertionError(
                        f"dp loss (rank {r}, chunks {chunks}) {o['loss']} "
                        f"vs one process {float(loss1)}")
                for name, g, g1 in zip(names, o["grads"], grads1):
                    _, got, use = _check_elementwise(
                        f"dp grad {name} (rank {r}, chunks {chunks})", g,
                        g1, 0.0, DP_TOL)
                    worst = max(worst, (got, name))
                worst_p = max(worst_p, vs_plain(
                    f"dp (rank {r}, chunks {chunks})", o["loss"],
                    o["grads"]))
                _check_dp_counts(o, chunks, r, out["sharded"])
                if r and any(not torch.equal(a, b) for a, b in
                             zip(o["grads"], res[0][chunks]["grads"])):
                    raise AssertionError(f"ranks 0 and {r} hold different "
                                         f"gradients (chunks {chunks})")
            o = res[0][chunks]
            stats[f"chunks{chunks}"] = dict(
                loss=o["loss"], worst_grad_rel_to_max=worst[0],
                worst_grad=worst[1],
                worst_grad_rel_to_max_plain=worst_p[0],
                worst_grad_plain=worst_p[1],
                launches_per_rank_step=o["launches"],
                all_reduces_per_rank_step=o["all_reduces"],
                grad_ms_per_rank=[out[chunks]["grad_ms"] for out in res],
                grad_p50_ms=float(np.median([t for out in res
                                             for t in out[chunks]["grad_ms"]])))
        stats["sharded"] = [row for out in res for row in out["sharded"]]

        # (c) the plain launcher, then the launcher over NCCL, in turn
        plain = train.run(["--arch", "atacworks", "--steps",
                           str(DP_NCCL_STEPS), "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ)])
        summary, launched, reduces, prof = _dp_nccl_run(
            torch, train, conv1d_brgemm, mesh, f"{tmp}/nccl", DP_NCCL_STEPS)
    losses = summary["losses"]
    if len(losses) != DP_NCCL_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"NCCL launcher losses {losses}")
    _check_nccl_counts(summary["dp"], launched, reduces)
    if losses != plain["losses"]:
        raise AssertionError(f"NCCL launcher losses {losses} differ from "
                             f"the plain launcher's {plain['losses']}")
    warm = train.WARMUP_STEPS
    calls = max([o["calls_per_step"] for k, o in
                 prof["collective_ops"].items()
                 if "allreduce" in k.lower() or "all_reduce" in k.lower()],
                default=0)
    if calls < 25:
        raise AssertionError(f"the trace shows {calls} all-reduces a step: "
                             f"{prof['collective_ops']}")
    stats["nccl"] = dict(
        steps=DP_NCCL_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        step_p50_ms=float(np.median(summary["step_s"][warm:]) * 1e3),
        plain_step_p50_ms=float(np.median(plain["step_s"][warm:]) * 1e3),
        samples_per_s=summary["samples_per_s"],
        plain_samples_per_s=plain["samples_per_s"],
        launches_per_step={k: v / DP_NCCL_STEPS for k, v in launched.items()},
        all_reduces_per_step=reduces / DP_NCCL_STEPS, **prof)
    print("dp " + json.dumps(stats), flush=True)
    return stats


def _check_nccl_counts(dp, launched, reduces):
    """The launcher over one NCCL rank: 49 forward and 25 bwd-weight
    launches and 25 all-reduces a step."""
    n = DP_NCCL_STEPS
    if dp != 1 or launched != dict(conv1d_fwd=49 * n,
                                   conv1d_bwd_weight=25 * n) \
            or reduces != 25 * n:
        raise AssertionError(f"NCCL launcher: dp {dp}, {launched} launches, "
                             f"{reduces} all-reduces in {n} steps; expected "
                             "49, 25 and 25 a step")


def _check_dp_counts(o, chunks, rank, sharded_rows):
    """A rank's step: 25 bwd-weight passes, each run over ``chunks`` width
    ranges (one launch each) and each range's (dw, dbias) one all-reduce;
    49 ``conv1d_fwd`` launches; no reduce left in flight.  Each sharded op:
    one forward and one bwd-weight launch."""
    want = dict(conv1d_fwd=49, conv1d_bwd_weight=25 * chunks)
    if o["launches"] != want or o["all_reduces"] != 25 * chunks \
            or o["pending_after"]:
        raise AssertionError(
            f"rank {rank}, chunks {chunks}: launches {o['launches']}, "
            f"{o['all_reduces']} all-reduces, {o['pending_after']} pending; "
            f"expected {want} and {25 * chunks} all-reduces")
    for row in sharded_rows:
        if sorted(row["launches"].values()) != [1, 1]:
            raise AssertionError(f"sharded {row['op']} launched "
                                 f"{row['launches']}; expected one forward "
                                 "and one bwd-weight")


def _tp_collectives(mesh, sharded, zero=False):
    """The tensor-parallel path's collective counters: parameter sums
    (``GradReducer``), dx sums (``ModelReducer``) and all-gathers
    (``ModelConcat``); set to 0 first with ``zero``."""
    if zero:
        mesh.GradReducer.launches = mesh.ModelReducer.launches = 0
        sharded.ModelConcat.launches = 0
    return dict(param_reduces=mesh.GradReducer.launches,
                dx_reduces=mesh.ModelReducer.launches,
                gathers=sharded.ModelConcat.launches)


def _tp_want(chunks):
    """A rank's gradient, counted from the code (``blocks._mp_apply``,
    ``ops._data_grad``, ``ops._param_grads``, ``sharded.ShardParam``):
    ``conv1d_fwd`` 25 forward launches (every layer) + 22 x chunks
    bwd-data launches (the 22 body layers, one a column range; the stem's
    input is data) + 2 (the unsharded heads); 25 ``conv1d_bwd_weight``;
    23 all-gathers (stem and body), 22 x chunks dx sums, and 71 parameter
    sums: every layer's fused (dw, dbias) over the data group (25, one
    width range each), then the 23 sharded layers' zero-padded w and b
    blocks over the model group (46)."""
    return (dict(conv1d_fwd=25 + 22 * chunks + 2, conv1d_bwd_weight=25),
            dict(param_reduces=25 + 2 * 23, dx_reduces=22 * chunks,
                 gathers=23))


def _tp_grads(torch, fn, model, batch, counters, mesh, sharded, timed):
    """One gradient of ``fn``, its kernels and collectives counted (every
    count set to 0 just before), then ``timed`` more on the host clock."""
    _tp_collectives(mesh, sharded, zero=True)
    ((loss, _), grads), launched = _counted(counters,
                                            lambda: fn(model, batch))
    out = dict(loss=float(loss), grads=[g.detach().cpu() for g in grads],
               launches=launched,
               collectives=_tp_collectives(mesh, sharded),
               pending_after=fn.reducer.pending)
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["grad_ms"] = times
    return out


def _tp_layer(torch, ops, mesh, model_group):
    """Phase 16 (b), in one rank: one 16->16 layer (b + relu, SAME) at
    TRAIN_BATCH x TRAIN_SEQ, K-sharded (this rank's 8 filter rows) with dx
    summed over the model group, against the unsharded layer on the
    kernels: dx within TP_DX_TOL of its largest value, TP_CHUNKS column
    ranges bitwise the unchunked dx."""
    gen = torch.Generator().manual_seed(29)
    N, C, S, d, Q = TRAIN_BATCH, 16, 51, 8, TRAIN_SEQ
    x = torch.randn((N, C, Q), generator=gen).to(DEVICE)
    w = (torch.randn((S, C, C), generator=gen) * (C * S) ** -0.5).to(DEVICE)
    b = (0.1 * torch.randn((C,), generator=gen)).to(DEVICE)
    g = torch.randn((N, C, Q), generator=gen).to(DEVICE)
    k = C // TP_MP
    rows = slice(mesh.mp_rank(model_group) * k,
                 (mesh.mp_rank(model_group) + 1) * k)

    def dx_of(ww, bb, gg, **kw):
        xx = x.clone().requires_grad_()
        y = ops.conv1d(xx, ww.contiguous(), bias=bb.contiguous(),
                       activation="relu", dilation=d, padding="SAME", **kw)
        (y * gg).sum().backward()
        return xx.grad

    one = dx_of(w, b, g)
    dx = {c: dx_of(w[:, rows], b[rows], g[:, rows], model_reduce=model_group,
                   model_reduce_chunks=c) for c in (1, TP_CHUNKS)}
    _, rel = _check_close("K-sharded layer dx vs one process", dx[1], one,
                          TP_DX_TOL)
    if not torch.equal(dx[TP_CHUNKS], dx[1]):
        raise AssertionError(f"dx in {TP_CHUNKS} column ranges differs from "
                             "the unchunked dx")
    return dict(shape=f"16->16 b+relu N={N} Q={Q}", dx_rel_to_max=rel,
                dx_bitwise_one_process=bool(torch.equal(dx[1], one)),
                chunked_bitwise=True)


def _tp_depthwise(torch, ops, sharded, mesh, data, model_group,
                  conv1d_brgemm):
    """Phase 16 (g), in one rank: ``model_sharded_depthwise_conv1d`` at the
    Mamba2 conv layer (DW_BATCH x DW_CHANNELS x DW_SEQ, S=DW_TAPS, fp32,
    bias + silu, CAUSAL), this rank's channel group against the unsharded
    kernel call: the output and the x, w and bias gradients bitwise, and
    no model collective on any pass."""
    gen = torch.Generator().manual_seed(31)
    xs = (DW_BATCH, DW_CHANNELS, DW_SEQ)
    x = torch.randn(xs, generator=gen).to(DEVICE)
    w0 = (0.1 * torch.randn((DW_TAPS, DW_CHANNELS), generator=gen)).to(DEVICE)
    b0 = (0.1 * torch.randn((DW_CHANNELS,), generator=gen)).to(DEVICE)
    g = torch.randn(xs, generator=gen).to(DEVICE)
    c = DW_CHANNELS // TP_MP
    blk = slice(mesh.mp_rank(model_group) * c,
                (mesh.mp_rank(model_group) + 1) * c)

    def run(fn, gg, **kw):
        xx = x.clone().requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(xx, w, bias=b, activation="silu", padding="CAUSAL", **kw)
        (y * gg).sum().backward()
        return y.detach(), xx.grad, w.grad, b.grad

    _tp_collectives(mesh, sharded, zero=True)
    got, launched = _counted(
        (conv1d_brgemm.depthwise_conv1d_fwd,
         conv1d_brgemm.depthwise_conv1d_bwd_weight),
        lambda: run(sharded.model_sharded_depthwise_conv1d,
                    g[:, blk].contiguous(), group=data,
                    model_group=model_group))
    coll = _tp_collectives(mesh, sharded)
    if coll["gathers"] or coll["dx_reduces"]:
        raise AssertionError(f"model_sharded_depthwise_conv1d ran model "
                             f"collectives: {coll}")
    want = run(ops.depthwise_conv1d, g)
    parts = (want[0][:, blk], want[1][:, blk], want[2][:, blk],
             want[3][blk])
    for name, a, p in zip(("y", "dx", "dw", "dbias"), (
            got[0], got[1][:, blk], got[2][:, blk], got[3][blk]), parts):
        if not torch.equal(a, p):
            raise AssertionError(f"model_sharded_depthwise_conv1d {name} "
                                 "differs from the unsharded kernel's")
    rest = torch.ones(DW_CHANNELS, dtype=torch.bool)
    rest[blk] = False
    if got[1][:, rest].abs().max() or got[2][:, rest].abs().max():
        raise AssertionError("the depthwise gradients leave the channel "
                             "group")
    return dict(shape=f"{DW_BATCH}x{DW_CHANNELS}x{DW_SEQ} S={DW_TAPS}",
                channels_per_rank=c, bitwise=True, launches=launched,
                collectives=coll)


def _tp_launcher(torch, st, rank, conv1d_brgemm):
    """Phase 16 (f), in one rank: ``repro_torch.launch.train`` with
    ``--model-parallel TP_MP`` over TP_MP gloo ranks started from
    torchrun's variables (``env://`` on a localhost port), TP_LAUNCH_STEPS
    steps of atacworks-bf16 at TRAIN_BATCH x TRAIN_SEQ; its summary and
    kernel launches."""
    from repro_torch.launch import mesh, train

    os.environ.update(WORLD_SIZE=str(TP_MP), RANK=str(rank), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(st["port"]))
    try:
        summary, launched = _counted(
            (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight),
            lambda: train.run(["--arch", TP_ARCH, "--steps",
                               str(TP_LAUNCH_STEPS), "--batch",
                               str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                               "--model-parallel", str(TP_MP),
                               "--dist-backend", "gloo"]))
    finally:
        mesh.destroy()
    return dict(summary=summary, launches=launched)


def _tp_rank(rank, st):
    """Phase 16, one of ``st["world"]`` gloo ranks sharing the card, laid
    out as (world / TP_MP, TP_MP): the forward (fp32) and the gradients
    of atacworks-bf16's widths at this rank's data shard, K-sharded over
    its model group (fp32 unchunked and in TP_CHUNKS column ranges, bf16
    unchunked) and, in bf16, over the data group alone; on (1, TP_MP)
    also the K-sharded layer, the sharded depthwise op and the launcher.
    Results go to a file the parent reads."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    from repro_torch.kernels import conv1d_brgemm, ops, sharded
    from repro_torch.launch import mesh
    from repro_torch.train.data_parallel import (make_sharded_grad_fn,
                                                 shard_batch)

    global DEVICE
    DEVICE = st["device"]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = st["world"]
    pair = world == TP_MP
    counters = (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight)
    mesh.init_data_group("gloo", f"file://{st['store']}", world, rank)
    out = {}
    try:
        data, model_group = mesh.init_mesh(world // TP_MP, TP_MP)
        out["layout"] = [mesh.dp_rank(data), mesh.mp_rank(model_group)]
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get(TP_ARCH), dtype=dtype)
            model = _seeded_model(torch, blocks, cfg, seed=5)
            batch = shard_batch(_batch(torch, synthetic, cfg, st["batch"],
                                       st["seq"], 7), data)
            if dtype == "float32":
                with torch.no_grad():
                    out["forward"] = [t.cpu() for t in blocks.forward(
                        model, cfg, batch["noisy"],
                        model_group=model_group)]
            for chunks in (1, TP_CHUNKS) if dtype == "float32" else (1,):
                fn = make_sharded_grad_fn(cfg, data, model_group=model_group,
                                          model_reduce_chunks=chunks)
                out[f"{dtype}/{chunks}"] = _tp_grads(
                    torch, fn, model, batch, counters, mesh, sharded,
                    st["timed"] if dtype == "float32" else 0)
            if dtype == "bfloat16":
                out["bfloat16/data"] = _tp_grads(
                    torch, make_sharded_grad_fn(cfg, data), model, batch,
                    counters, mesh, sharded, 0)
            del model, batch
        if pair:
            out["layer"] = _tp_layer(torch, ops, mesh, model_group)
            out["depthwise"] = _tp_depthwise(torch, ops, sharded, mesh, data,
                                             model_group, conv1d_brgemm)
    finally:
        mesh.destroy()
    if pair:
        out["launcher"] = _tp_launcher(torch, st, rank, conv1d_brgemm)
    torch.save(out, os.path.join(st["out"], f"rank{rank}.pt"))


def _tp_tiles(torch, conv1d_brgemm, x, w, b, d, label):
    """Device ms of ``conv1d_fwd`` with each of its tiles pinned that the
    kernel's rule lets run this shape (the default's choice included):
    whether a tile of KT <= K would serve K = 8 better than the default
    the shape gets.  Each pinned call is bitwise the default's."""
    S, K, C = w.shape
    base = conv1d_brgemm.conv1d_fwd(x, w, bias=b, activation="relu",
                                    dilation=d)
    out = {}
    for tile in conv1d_brgemm.fwd_tiles(K):
        if conv1d_brgemm.fwd_tile(x.shape[0], C, K, S, x.shape[-1], d,
                                  tile=tile) is None:
            continue

        def run(tile=tile):
            return conv1d_brgemm.conv1d_fwd(x, w, bias=b, activation="relu",
                                            dilation=d, tile=tile)
        if not torch.equal(run(), base):
            raise AssertionError(f"{label}: tile {tile} changed the result")
        out[str(tile)] = _device_ms(run)
    return out


def _bf16_ulps(torch, got, want):
    """How a bf16 result departs from its plain version: the share of
    outputs that differ and the largest difference in bf16 ulps of the
    plain value (one ulp at |v| is 2^(floor(log2 |v|) - 7))."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    return dict(differ_share=(g != w).float().mean().item(),
                max_ulps=((g - w).abs() / ulp).max().item())


def _tp_kernel_rows(torch, conv1d_brgemm):
    """Phase 16 (e): the dense kernels at the local shapes of a (1, TP_MP)
    rank of atacworks-bf16's widths (batch TRAIN_BATCH x TRAIN_SEQ, K =
    16 / TP_MP = 8 filters), in fp32 and in bf16 (the trained config's
    dtype; bwd-data takes bf16 operands and stores fp32, the partial dx
    the model sum reads), against their plain versions within BWD_TOL
    of the largest plain value (as phase 4; the bf16 forward also
    elementwise within TOL, as phase 2, and its departures counted in
    ulps), timed beside the bound and the library call, with the tile
    or body each takes: the forward 16->8 and the stem 1->8, bwd-data
    8->16 on the whole width and on the first of TP_CHUNKS column ranges
    (its columns bitwise the whole call's; the range's copy timed on its
    own), bwd-weight 16->8 and 1->8.  Bounds count each input read once
    and each output written once, at the peak of the operands' type."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=DEVICE).manual_seed(23)
    N, Q, S, d, C = TRAIN_BATCH, TRAIN_SEQ, 51, 8, 16
    K, span = C // TP_MP, (S - 1) * d
    W = Q + span
    lo, hi = ops._chunk_ranges(W, TP_CHUNKS)[0]
    rows = []

    def add(name, label, dt, kern, plain, lib, flops, nbytes, kind, knob):
        tol = BWD_TOL[dt]
        got, want = kern(), plain()
        if isinstance(got, tuple):
            errs = [_check_close(f"{label} {part}", a, p_, tol)
                    for part, a, p_ in zip(("dw", "dbias"), got, want)]
            max_abs, max_rel = (max(e[0] for e in errs),
                                max(e[1] for e in errs))
        else:
            max_abs, max_rel = _check_close(label, got, want, tol)
        row = dict(shape=label, pass_=name, dtype=dt, max_abs_err=max_abs,
                   max_rel_diff=max_rel, tol_rel_to_max_plain=tol,
                   kernel_ms=_device_ms(kern),
                   plain_ms=_device_ms(plain, per_graph=2),
                   library_ms=_device_ms(lib), **knob)
        if name == "fwd" and dt == "bfloat16":
            atol, rtol = TOL[dt]
            diff = (got.float() - want.float()).abs()
            if not bool((diff <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(f"{label}: an output is over {atol} + "
                                     f"{rtol} x |plain| from plain")
            row.update(atol=atol, rtol=rtol, **_bf16_ulps(torch, got, want))
        row["bound_ms"], row["bound_by"] = roofline.bound(flops, nbytes,
                                                          kind)
        _rates(row, flops=flops)
        rows.append(row)
        return got

    for dt in ("float32", "bfloat16"):
        dtype, tag16 = getattr(torch, dt), "" if dt == "float32" else " bf16"
        for c_in, tag in ((C, "16->8"), (1, "stem 1->8")):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=DEVICE)

            x = rnd(N, c_in, W).to(dtype)
            w = (rnd(S, K, c_in) * (c_in * S) ** -0.5).to(dtype)
            b = (0.1 * rnd(K)).to(dtype)
            g = rnd(N, K, Q).to(dtype)
            e = x.element_size()
            w_kcs = w.permute(1, 2, 0).contiguous()
            fwd_bytes = (N * c_in * W + S * K * c_in + K + N * K * Q) * e
            add("fwd", f"tp fwd {tag} b+relu N={N} Q={Q}{tag16}", dt,
                lambda: conv1d_brgemm.conv1d_fwd(x, w, bias=b,
                                                 activation="relu",
                                                 dilation=d),
                lambda: ref.conv1d_fused_ref(x, w, bias=b, activation="relu",
                                             dilation=d),
                lambda: F.conv1d(x, w_kcs, b, dilation=d),
                2.0 * N * K * c_in * S * Q, fwd_bytes, dt,
                dict(tile=_fwd_tile(conv1d_brgemm, N, c_in, K, S, W, d)))
            if dt == "float32":
                rows[-1]["pinned_tiles_ms"] = _tp_tiles(
                    torch, conv1d_brgemm, x, w, b, d, rows[-1]["shape"])
            add("bwd_weight", f"tp bwd_weight {tag} N={N} Q={Q}{tag16}", dt,
                lambda: conv1d_brgemm.conv1d_bwd_weight(x, g, S=S,
                                                        dilation=d,
                                                        with_dbias=True),
                lambda: (ref.conv1d_bwd_weight_ref(x, g, dilation=d),
                         ref.conv1d_dbias_ref(g)),
                lambda: torch.nn.grad.conv1d_weight(x, (K, c_in, S), g,
                                                    dilation=d),
                roofline.tf32_flops(N, c_in, K, S, Q) if dt == "float32"
                else 2.0 * N * K * c_in * S * Q,
                (N * c_in * W + N * K * Q) * e + (S * K * c_in + K) * 4,
                "tf32" if dt == "float32" else dt,
                dict(body=conv1d_brgemm.bwd_weight_body(N, c_in, K, S, W, d)))
            if c_in == 1:
                continue
            # bwd-data: the forward kernel on the padded cotangent (K = 8
            # channels in) against the flipped, transposed taps (16
            # filters), stored in fp32 (the partial dx the model sum reads)
            g_pad = F.pad(g, (span, span))
            w_t = w.flip(0).transpose(1, 2).contiguous()
            w_t_kcs = w_t.permute(1, 2, 0).contiguous()
            gc = g_pad[:, :, lo:hi + span].contiguous()
            f32 = torch.float32
            bd_flops = 2.0 * N * C * K * S * W
            whole = add(
                "bwd_data", f"tp bwd_data 8->16 N={N} Q={Q}{tag16}", dt,
                lambda: conv1d_brgemm.conv1d_fwd(g_pad, w_t, dilation=d,
                                                 out_dtype=f32),
                lambda: ref.conv1d_fused_ref(g_pad, w_t, dilation=d,
                                             out_dtype=f32),
                lambda: torch.nn.grad.conv1d_input((N, C, W), w_kcs, g,
                                                   dilation=d),
                bd_flops, (N * K * Q + S * K * C) * e + N * C * W * 4, dt,
                dict(tile=_fwd_tile(conv1d_brgemm, N, K, C, S, W + span, d)))
            part = add(
                "bwd_data chunk", f"tp bwd_data 8->16 chunk N={N} "
                f"cols={hi - lo}{tag16}", dt,
                lambda: conv1d_brgemm.conv1d_fwd(gc, w_t, dilation=d,
                                                 out_dtype=f32),
                lambda: ref.conv1d_fused_ref(gc, w_t, dilation=d,
                                             out_dtype=f32),
                lambda: F.conv1d(gc, w_t_kcs, dilation=d),
                bd_flops * (hi - lo) / W,
                (N * K * (hi - lo + span) + S * K * C) * e
                + N * C * (hi - lo) * 4, dt,
                dict(tile=_fwd_tile(conv1d_brgemm, N, K, C, S,
                                    hi - lo + span, d)))
            if not torch.equal(part, whole[:, :, lo:hi]):
                raise AssertionError("bwd-data on a column range differs "
                                     "from the same columns of the whole "
                                     "call")
            rows[-1]["bitwise_whole_columns"] = True
            rows[-1]["copy_ms"] = _device_ms(
                lambda: g_pad[:, :, lo:hi + span].contiguous())
    torch.cuda.synchronize()
    for row in rows:
        print("tp-kernel " + json.dumps(row), flush=True)
    return rows


def _loss_grads(torch, blocks, model, cfg, batch, backend=None):
    """The AtacWorks loss and its 50 gradients on ``backend``."""
    loss, _ = blocks.loss_fn(model, cfg, batch, backend=backend)
    return float(loss.detach()), [g.detach().cpu() for g in
                                  torch.autograd.grad(loss, list(
                                      model.parameters()))]


def _bf16_vs_fp32(label, got, ref_bf16, fp32, names):
    """A bf16 (loss, gradients) ``got`` held to the fp32 ones of the same
    weights: per leaf (and for the loss), ``got``'s distance from fp32,
    relative to the leaf's largest fp32 value, within TP_BF16_FACTOR x
    ``ref_bf16``'s plus BF16_ULP.  Returns the worst leaf, its share of
    its limit, both distances, the largest distance between ``got``
    and ``ref_bf16``, and (reported, not held) the leaf with the largest
    normwise distance ||got - fp32|| / ||fp32|| beside the reference's."""
    def dist(a, b):
        return (a.float() - b.float()).abs().max().item()

    def norm_rel(a, b):  # reported only: ||a - b|| / ||b||
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    norms = max((norm_rel(g, t), norm_rel(r, t), n) for n, g, r, t in
                zip(names, got[1], ref_bf16[1], fp32[1]))
    worst, between = (0.0, "", 0.0, 0.0), 0.0
    items = [("loss", abs(got[0] - fp32[0]), abs(ref_bf16[0] - fp32[0]),
              abs(got[0] - ref_bf16[0]), abs(fp32[0]))]
    items += [(n, dist(g, t), dist(r, t), dist(g, r),
               t.float().abs().max().item())
              for n, g, r, t in zip(names, got[1], ref_bf16[1], fp32[1])]
    for name, d_g, d_r, d_gr, scale in items:
        scale = max(scale, 1e-30)
        e_g, e_r = d_g / scale, d_r / scale
        limit = TP_BF16_FACTOR * e_r + BF16_ULP
        if not e_g <= limit:
            raise AssertionError(
                f"{label}: {name} is {e_g} of its largest value from the "
                f"fp32 one, over {TP_BF16_FACTOR} x the reference bf16 "
                f"path's {e_r} + {BF16_ULP}")
        worst = max(worst, (e_g / limit, name, e_g, e_r))
        between = max(between, d_gr / scale)
    print(f"{label}: worst {worst[1]} at {worst[0]:.3f} of its limit "
          f"({worst[2]:.3e} from fp32; the reference bf16 path "
          f"{worst[3]:.3e})", flush=True)
    return dict(worst_share_of_limit=worst[0], worst=worst[1],
                worst_vs_fp32=worst[2], reference_bf16_vs_fp32=worst[3],
                max_rel_diff_to_reference_bf16=between,
                worst_norm_rel_vs_fp32=dict(leaf=norms[2], got=norms[0],
                                            reference_bf16=norms[1]),
                factor=TP_BF16_FACTOR, ulp=BF16_ULP)


def _tp_one_process(torch, np, configs, blocks, synthetic, train,
                    counters):
    """Phase 16 (a): atacworks-bf16 in one process, its first training on
    the card: the launcher TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_SEQ
    (finite losses, 49 + 25 launches a step, step p50, samples/s, peak
    memory), and the whole bf16 gradient at GRAD_BATCH x GRAD_SEQ
    through the kernels held to the fp32 gradient (autograd over the
    plain version in fp32, on the bf16 weights widened) no further than
    the plain bf16 version's (``_bf16_vs_fp32``)."""
    torch.cuda.reset_peak_memory_stats()
    summary, launched = _counted(
        counters, lambda: train.run(["--arch", TP_ARCH, "--steps",
                                     str(TRAIN_STEPS), "--batch",
                                     str(TRAIN_BATCH), "--seq",
                                     str(TRAIN_SEQ)]))
    losses = summary["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{TP_ARCH} training losses {losses}")
    if launched != dict(conv1d_fwd=49 * TRAIN_STEPS,
                        conv1d_bwd_weight=25 * TRAIN_STEPS):
        raise AssertionError(f"{TP_ARCH}: {launched} launches in "
                             f"{TRAIN_STEPS} steps; expected 49 and 25 a step")
    times = np.asarray(summary["step_s"][train.WARMUP_STEPS:])
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 losses=losses, step_s=summary["step_s"],
                 step_p50_ms=float(np.median(times) * 1e3),
                 samples_per_s=summary["samples_per_s"],
                 launches_per_step={k: v / TRAIN_STEPS
                                    for k, v in launched.items()},
                 skipped_steps=summary["skipped_steps"],
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    stats.update(_model_rate(TP_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                             stats["step_p50_ms"]))
    cfg = configs.get(TP_ARCH)
    model = _seeded_model(torch, blocks, cfg, seed=5)
    batch = _batch(torch, synthetic, cfg, GRAD_BATCH, GRAD_SEQ, 7)
    (loss_k, grads_k), glaunched = _counted(
        counters, lambda: _loss_grads(torch, blocks, model, cfg, batch))
    if glaunched != dict(conv1d_fwd=49, conv1d_bwd_weight=25):
        raise AssertionError(f"{TP_ARCH} gradient: {glaunched} launches")
    stats["grad"] = dict(batch=GRAD_BATCH, seq=GRAD_SEQ, **_bf16_vs_fp32(
        f"{TP_ARCH} gradient through the kernels", (loss_k, grads_k),
        _loss_grads(torch, blocks, model, cfg, batch, "ref"),
        _loss_grads(torch, blocks, copy.deepcopy(model).float(), cfg, batch,
                    "ref"), [n for n, _ in model.named_parameters()]))
    print("tp-one-process " + json.dumps(stats), flush=True)
    return stats


def _free_port() -> int:
    """A free TCP port on localhost, for ``env://``'s MASTER_PORT."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_tp_rank(o, chunks, label):
    """A rank's counted gradient against ``_tp_want``; nothing in flight."""
    launches, coll = _tp_want(chunks)
    if o["launches"] != launches or o["collectives"] != coll \
            or o["pending_after"]:
        raise AssertionError(
            f"{label}: launches {o['launches']}, collectives "
            f"{o['collectives']}, {o['pending_after']} pending; expected "
            f"{launches} and {coll}")


def tp_check(torch, np, configs, train, conv1d_brgemm):
    """Phase 16: tensor parallelism on atacworks-bf16's widths.  (a) one
    process in bf16 (``_tp_one_process``); the one-process references at
    TRAIN_BATCH x TRAIN_SEQ: the fp32 forward and gradient on the kernels
    and through the plain version, the bf16 gradient on the kernels;
    (e) the kernels at the local shapes (``_tp_kernel_rows``); the
    one-process launcher TP_LAUNCH_STEPS steps; then gloo ranks sharing
    the one card (NCCL refuses two ranks on one GPU): (b, c, f, g) TP_MP
    ranks as (1, TP_MP) and (d) 2 x TP_MP as (2, TP_MP) (``_tp_rank``),
    held here against the references and the counts of ``_tp_want``."""
    import dataclasses
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    from repro_torch.train.data_parallel import make_sharded_grad_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight)
    stats = dict(card=_card_line(), arch=TP_ARCH, mp=TP_MP,
                 chunks=TP_CHUNKS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 bf16_factor=TP_BF16_FACTOR, bf16_ulp=BF16_ULP,
                 bf16_tol=TP_BF16_TOL, dx_tol=TP_DX_TOL, dp_tol=DP_TOL,
                 bwd_tol=BWD_TOL["float32"], grad_tol_plain=GRAD_TOL,
                 launch_held_steps=TP_LAUNCH_HELD,
                 launch_rtol=TP_LAUNCH_RTOL)
    stats["one_process"] = _tp_one_process(torch, np, configs, blocks,
                                           synthetic, train, counters)
    cfg16 = configs.get(TP_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    model = _seeded_model(torch, blocks, cfg32, seed=5)
    batch = _batch(torch, synthetic, cfg32, TRAIN_BATCH, TRAIN_SEQ, 7)
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        fwd1 = [t.cpu() for t in blocks.forward(model, cfg32, batch["noisy"])]
    (loss1, _), grads1 = make_sharded_grad_fn(cfg32, None)(model, batch)
    loss1, grads1 = float(loss1), [g.detach().cpu() for g in grads1]
    loss_p, _ = blocks.loss_fn(model, cfg32, batch, backend="ref")
    grads_p = [g.detach().cpu() for g in torch.autograd.grad(
        loss_p, [p for _, p in model.named_parameters()])]
    loss_p = float(loss_p.detach())
    # bf16: the one-process gradient through the kernels
    model = _seeded_model(torch, blocks, cfg16, seed=5)
    one16 = _loss_grads(torch, blocks, model, cfg16, batch)
    del model, batch
    stats["kernel_rows"] = _tp_kernel_rows(torch, conv1d_brgemm)
    one_launcher = train.run(["--arch", TP_ARCH, "--steps",
                              str(TP_LAUNCH_STEPS), "--batch",
                              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    torch.cuda.empty_cache()

    def vs(label, got, want, tol, plain=False):
        """Each leaf within ``tol`` of its largest value; the worst leaf
        and how many are bitwise."""
        worst = max((_check_close(f"{label} {n}", g, w_, tol)[1], n)
                    for n, g, w_ in zip(names, got, want))
        return dict(worst_rel_to_max=worst[0], worst=worst[1],
                    bitwise_leaves=sum(bool(torch.equal(g, w_))
                                       for g, w_ in zip(got, want)))

    res, walls = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for world in (TP_MP, 2 * TP_MP):
            st = dict(device=DEVICE, world=world, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, store=f"{tmp}/store{world}",
                      out=f"{tmp}/w{world}", port=_free_port(),
                      timed=TP_TIMED)
            os.makedirs(st["out"])
            t0 = time.perf_counter()
            mp.start_processes(_tp_rank, args=(st,), nprocs=world,
                               start_method="spawn")
            walls[world] = time.perf_counter() - t0
            res[world] = [torch.load(os.path.join(st["out"], f"rank{r}.pt"))
                          for r in range(world)]
    stats["ranks_wall_s"] = walls
    for world, ranks in res.items():
        layout = f"(data {world // TP_MP}, model {TP_MP})"
        cell = stats[f"dp{world // TP_MP}_mp{TP_MP}"] = {}
        share = TRAIN_BATCH // (world // TP_MP)
        for r, o in enumerate(ranks):
            if o["layout"] != [r // TP_MP, r % TP_MP]:
                raise AssertionError(f"rank {r} sits at {o['layout']}")
            rows = slice(r // TP_MP * share, (r // TP_MP + 1) * share)
            for i, (a, b) in enumerate(zip(o["forward"],
                                           (t[rows] for t in fwd1))):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{layout} rank {r}: the K-sharded fp32 forward "
                        f"(output {i}) is not bitwise the one-process "
                        f"forward (max diff {(a - b).abs().max().item()})")
            for chunks in (1, TP_CHUNKS):
                g = o[f"float32/{chunks}"]
                label = f"{layout} rank {r} chunks {chunks}"
                _check_tp_rank(g, chunks, label)
                for ref_loss, what in ((loss1, "one process"),
                                       (loss_p, "plain")):
                    if not abs(g["loss"] - ref_loss) <= LOSS_RTOL * abs(
                            ref_loss):
                        raise AssertionError(f"{label}: loss {g['loss']} "
                                             f"vs {what} {ref_loss}")
                if world == TP_MP:
                    one = vs(f"{label} grad vs one process", g["grads"],
                             grads1, BWD_TOL["float32"])
                else:
                    worst = (0.0, "")
                    for n, a, b in zip(names, g["grads"], grads1):
                        _, rel, _ = _check_elementwise(
                            f"{label} grad {n} vs one process", a, b, 0.0,
                            DP_TOL)
                        worst = max(worst, (rel, n))
                    one = dict(worst_rel_to_max=worst[0], worst=worst[1])
                plain = vs(f"{label} grad vs plain", g["grads"], grads_p,
                           GRAD_TOL)
                if chunks != 1 and any(
                        not torch.equal(a, b) for a, b in
                        zip(g["grads"], o["float32/1"]["grads"])):
                    raise AssertionError(f"{label}: the chunked dx sums "
                                         "changed the gradient")
                if r and any(not torch.equal(a, b) for a, b in zip(
                        g["grads"], ranks[0][f"float32/{chunks}"]["grads"])):
                    raise AssertionError(f"{label}: ranks 0 and {r} hold "
                                         "different gradients")
                if r == 0:
                    cell[f"chunks{chunks}"] = dict(
                        loss=g["loss"], vs_one_process=one, vs_plain=plain,
                        launches_per_rank_step=g["launches"],
                        collectives_per_rank_step=g["collectives"],
                        grad_ms_per_rank=[x[f"float32/{chunks}"]["grad_ms"]
                                          for x in ranks],
                        grad_p50_ms=float(np.median(
                            [t for x in ranks
                             for t in x[f"float32/{chunks}"]["grad_ms"]])))
            g = o["bfloat16/1"]
            label = f"{layout} rank {r} bf16"
            _check_tp_rank(g, 1, label)
            if not abs(g["loss"] - one16[0]) <= LOSS_RTOL * abs(one16[0]):
                raise AssertionError(f"{label}: loss {g['loss']} vs one "
                                     f"process {one16[0]}")
            bf16 = vs(f"{label} grad vs one process", g["grads"], one16[1],
                      TP_BF16_TOL)
            for n, a, b in zip(names, g["grads"],
                               o["bfloat16/data"]["grads"]):
                if n in TP_NO_DX_SUM and not torch.equal(a, b):
                    raise AssertionError(
                        f"{label}: {n}, whose cotangent passes no dx sum, "
                        "is not bitwise the data-parallel bf16 gradient")
            if r and any(not torch.equal(a, b) for a, b in zip(
                    g["grads"], ranks[0]["bfloat16/1"]["grads"])):
                raise AssertionError(f"{label}: ranks 0 and {r} hold "
                                     "different gradients")
            if r == 0:
                cell["bf16"] = dict(loss=g["loss"], loss_one=one16[0],
                                    vs_one_process=bf16,
                                    no_dx_sum_bitwise_data_parallel=True)
        if world == TP_MP:
            cell["layer"] = [o["layer"] for o in ranks]
            cell["depthwise"] = [o["depthwise"] for o in ranks]
            lsum = ranks[0]["launcher"]["summary"]
            got, want = lsum["losses"], one_launcher["losses"]
            if len(got) != TP_LAUNCH_STEPS or any(
                    not abs(a - b) <= TP_LAUNCH_RTOL * abs(b)
                    for a, b in zip(got[:TP_LAUNCH_HELD],
                                    want[:TP_LAUNCH_HELD])):
                raise AssertionError(f"--model-parallel {TP_MP} launcher "
                                     f"losses {got} vs one process {want} "
                                     f"(the first {TP_LAUNCH_HELD} held)")
            launched = ranks[0]["launcher"]["launches"]
            if launched != dict(conv1d_fwd=49 * TP_LAUNCH_STEPS,
                                conv1d_bwd_weight=25 * TP_LAUNCH_STEPS):
                raise AssertionError(f"--model-parallel launcher launched "
                                     f"{launched}")
            warm = train.WARMUP_STEPS
            cell["launcher"] = dict(
                steps=TP_LAUNCH_STEPS, losses=got, one_process_losses=want,
                loss_rel_diff=[abs(a - b) / abs(b)
                               for a, b in zip(got, want)],
                grad_norms=lsum["grad_norms"],
                mp=lsum["mp"], dp=lsum["dp"],
                step_p50_ms=float(np.median(lsum["step_s"][warm:]) * 1e3),
                one_process_step_p50_ms=float(np.median(
                    one_launcher["step_s"][warm:]) * 1e3),
                launches_per_step={k: v / TP_LAUNCH_STEPS
                                   for k, v in launched.items()})
    print("tp " + json.dumps(stats), flush=True)
    return stats

def _tel_train(torch, np, configs, train, counters, tmp, bwd_rows):
    """Phase 17 (a): the AtacWorks training cell through the launcher,
    without and then with ``--telemetry`` (same seed)."""
    from repro_torch import obs
    from repro_torch.obs import report, trace_export

    argv = ["--arch", "atacworks", "--steps", str(TEL_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    plain, plain_n = _counted(counters, lambda: train.run(argv))
    # the probe step's conv cell through "auto", launched once alone
    _, probe_n = _counted(counters, lambda: train._telemetry_conv_probe(
        configs.get("atacworks"), torch.device(DEVICE)))
    path = os.path.join(tmp, "train.jsonl")
    told, told_n = _counted(
        counters, lambda: train.run(argv + ["--telemetry", path]))
    for k in ("losses", "grad_norms"):
        if told[k] != plain[k]:
            raise AssertionError(f"telemetry moved the {k}: {told[k]} vs "
                                 f"{plain[k]}")
    want = dict(conv1d_fwd=49 * TEL_STEPS, conv1d_bwd_weight=25 * TEL_STEPS)
    if plain_n != want or told_n != {k: want[k] + probe_n[k] for k in want}:
        raise AssertionError(f"launches {plain_n} without and {told_n} with "
                             f"telemetry (the probe alone {probe_n}); "
                             f"expected {want} and the probe's")
    recs = obs.read_events(path)  # strict: every record validated
    spans = [r for r in recs if r["kind"] == "span"]
    steps = [r for r in spans if r["name"] == "train.step"]
    passes = {p: [r for r in spans if r["name"] == f"conv1d.{p}"
                  and r["attrs"]["N"] == TRAIN_BATCH]
              for p in ("fwd", "bwd_data", "bwd_weight")}
    per_step = dict(fwd=25, bwd_data=24, bwd_weight=25)
    counts = {p: len(v) for p, v in passes.items()}
    if len(steps) != TEL_STEPS or counts != {
            p: n * TEL_STEPS for p, n in per_step.items()}:
        raise AssertionError(f"{len(steps)} train.step spans and pass spans "
                             f"{counts}; expected {TEL_STEPS} and "
                             f"{per_step} a step")
    effs = [r["attrs"].get("efficiency") for v in passes.values() for r in v]
    if not all(e is not None and 0 < e <= TEL_EFF_MAX for e in effs):
        raise AssertionError(f"pass efficiencies out of (0, {TEL_EFF_MAX}]: "
                             f"{sorted(e for e in effs if e is not None)[-3:]}"
                             f", {effs.count(None)} missing")
    if not all(r["attrs"].get("clock") == "cuda_event"
               for v in passes.values() for r in v):
        raise AssertionError("a pass span was not timed by CUDA events")
    phase4 = {r["pass_"]: r for r in bwd_rows
              if (r.get("layer"), r["dtype"]) == ("conv", "float32")}
    cell = {}
    for p, v in passes.items():
        durs = sorted(r["dur"] * 1e3 for r in v
                      if (r["attrs"]["C"], r["attrs"]["K"]) == (15, 15))
        floor = TEL_DUR_MIN * phase4[p]["kernel_ms"]
        if len(durs) != 22 * TEL_STEPS or durs[0] < floor:
            raise AssertionError(f"{p}: {len(durs)} 15->15 spans, the "
                                 f"shortest {durs[0]:.4f} ms, under "
                                 f"{TEL_DUR_MIN} x phase 4's "
                                 f"{phase4[p]['kernel_ms']:.4f} ms")
        effs15 = sorted(r["attrs"]["efficiency"] for r in v
                        if (r["attrs"]["C"], r["attrs"]["K"]) == (15, 15))
        cell[p] = dict(spans=len(durs), p50_ms=float(np.median(durs)),
                       min_ms=durs[0], max_ms=durs[-1],
                       efficiency_p50=float(np.median(effs15)),
                       peak=v[0]["attrs"]["peak"],
                       phase4_device_ms=phase4[p]["kernel_ms"],
                       phase4_call_ms=phase4[p]["kernel_call_ms"])
    agg = report.aggregate(recs)
    missing = report.check(agg)
    phases = {ph: s["p50_s"] * 1e3 for ph, s in agg["steps"]["phases"].items()}
    if missing or set(phases) != {"forward", "backward", "optimizer"}:
        raise AssertionError(f"report.check: {missing}; phases {phases}")
    roll = {r["name"]: r["attrs"] for r in recs if r["name"] in (
        "train.health.rollup", "train.straggler.rollup")}
    if roll["train.health.rollup"]["events"] \
            or roll["train.straggler.rollup"]["stragglers"]:
        raise AssertionError(f"monitors not ok: {roll}")
    out = os.path.join(tmp, "trace.json")
    trace_export.export(path, out)
    with open(out) as f:
        trace = json.load(f)
    n_x = sum(e["ph"] == "X" for e in trace["traceEvents"])
    if n_x != len(spans):
        raise AssertionError(f"trace: {n_x} X events for {len(spans)} spans")
    p50 = {k: float(np.median(r["step_s"][train.WARMUP_STEPS:]) * 1e3)
           for k, r in (("off", plain), ("on", told))}
    stats = dict(steps=TEL_STEPS, launches=told_n, probe_launches=probe_n,
                 pass_spans=counts, cell_15_15=cell, step_p50_ms=p50,
                 phase_p50_ms=phases, records=len(recs),
                 trace_events=len(trace["traceEvents"]),
                 cost_model=agg["cost_model"], tuner=agg["tuner"],
                 log_bytes=os.path.getsize(path))
    for p, c in cell.items():
        print(f"telemetry 15->15 {p}: span p50 {c['p50_ms']:.4f} ms "
              f"(min {c['min_ms']:.4f}), efficiency {c['efficiency_p50']:.3f}"
              f" of {c['peak']}; phase 4 device {c['phase4_device_ms']:.4f} "
              f"ms, call {c['phase4_call_ms']:.4f} ms", flush=True)
    print(f"telemetry train: step p50 {p50['off']:.2f} ms off, "
          f"{p50['on']:.2f} ms on; phases " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in phases.items()), flush=True)
    return stats


def _tel_serve(torch, np, configs, blocks, serve, tmp):
    """Phase 17 (b): the serving cell with TEL_STREAMS streams, without
    and with telemetry."""
    from repro_torch import obs
    from repro_torch.obs import report

    cfg, model = _serve_model(torch, configs, blocks)

    def run():
        server = _make_server(np, serve, model, cfg, TEL_STREAMS)
        return server, [np.stack(r.result()) for r in server.run()]

    _, plain = run()
    path = obs.enable(os.path.join(tmp, "serve.jsonl"))
    try:
        server, told = run()
    finally:
        obs.disable()
    if len(told) != TEL_STREAMS or not all(
            np.array_equal(a, b) for a, b in zip(told, plain)):
        raise AssertionError("served outputs differ with telemetry on")
    recs = obs.read_events(path)  # strict: every record validated
    agg = report.aggregate(recs)
    chunks = sum(r["name"] == "serve.conv.chunk" for r in recs)
    missing = report.check_serving(agg)
    if chunks != server.chunks_run or missing:
        raise AssertionError(f"{chunks} serve.conv.chunk spans for "
                             f"{server.chunks_run} steps; {missing}")
    stats = dict(streams=TEL_STREAMS, chunks_run=server.chunks_run,
                 serving=agg["serving"])
    print("telemetry serve " + json.dumps(stats), flush=True)
    return stats


def _tel_tune(tmp):
    """Phase 17 (c): one fig4 problem tuned into a fresh cache under
    telemetry, then looked up again."""
    from repro_torch import obs, tune
    from repro_torch.obs import report

    prob = next(tune.presets.figset_shapes("fig4"))
    cache = tune.TuneCache(os.path.join(tmp, "tune.json"))
    path = obs.enable(os.path.join(tmp, "tune.jsonl"))
    try:
        tune.tune(**prob, device=DEVICE, cache=cache, iters=SWEEP_ITERS)
        tune.get_config(**prob, device=DEVICE, cache=cache)
    finally:
        obs.disable()
    recs = obs.read_events(path)  # strict: every record validated
    [search] = [r for r in recs if r["name"] == "tune.search"]
    cands = [r["attrs"] for r in recs if r["name"] == "tune.search.candidate"]
    agg = report.aggregate(recs)
    if len(cands) != search["attrs"]["candidates"] or not all(
            c["predicted_s"] > 0 and c["measured_s"] > 0 for c in cands) \
            or agg["tuner"]["hits"] != 1:
        raise AssertionError(f"tuner: {len(cands)} candidate events of "
                             f"{search['attrs']['candidates']}, "
                             f"{agg['tuner']}")
    stats = dict(problem=prob, candidates=cands, cost_model=agg["cost_model"],
                 tuner=agg["tuner"], traced_passes=sum(
                     r["name"].endswith(".trace") for r in recs))
    print("telemetry tune " + json.dumps(stats), flush=True)
    return stats


def _tel_rank(rank, st):
    """Phase 17 (d), one of TP_MP gloo ranks sharing the card: the
    launcher with ``--model-parallel TP_MP --telemetry`` on atacworks-bf16,
    both ranks writing one log."""
    import torch

    from repro_torch.launch import mesh, train

    if st["device"] == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    mesh.init_data_group("gloo", f"file://{st['store']}", TP_MP, rank)
    try:
        train.run(["--arch", TP_ARCH, "--steps", str(TEL_TP_STEPS),
                   "--batch", str(TEL_TP_BATCH), "--seq", str(TEL_TP_SEQ),
                   "--model-parallel", str(TP_MP), "--dist-backend", "gloo",
                   "--device", st["device"], "--telemetry", st["log"]])
    finally:
        mesh.destroy()


def _tel_tp(tmp):
    """Phase 17 (d): the tensor-parallel launcher's shared log."""
    import torch.multiprocessing as mp

    from repro_torch import obs
    from repro_torch.obs import report

    st = dict(device=DEVICE, store=os.path.join(tmp, "store"),
              log=os.path.join(tmp, "tp.jsonl"))
    mp.start_processes(_tel_rank, args=(st,), nprocs=TP_MP,
                       start_method="spawn")
    recs = obs.read_events(st["log"])
    agg = report.aggregate(recs)
    missing = report.check_model_parallel(agg)
    pids = sorted({r["pid"] for r in recs})
    if missing or pids != list(range(TP_MP)):
        raise AssertionError(f"tensor-parallel log: {missing}, pids {pids}")
    stats = dict(mesh=agg["mesh"], pids=pids, model_psum=agg["model_psum"],
                 steps=agg["steps"]["count"])
    print("telemetry tp " + json.dumps(stats), flush=True)
    return stats


def _tel_disabled(torch, ops, rows):
    """Phase 17 (e): the disabled hooks' host cost, and the host time of a
    stream step's 25 ``ops.conv1d`` calls with telemetry off beside
    phase 2's reading of the same."""
    import timeit

    import torch.nn.functional as F

    from repro_torch import obs

    dev = torch.device(DEVICE)
    hooks = dict(counter=lambda: obs.counter("c"),
                 gauge=lambda: obs.gauge("g", 1.0),
                 span=lambda: obs.span("s"),
                 device_span=lambda: obs.device_span("s", dev))
    ns = {k: min(timeit.repeat(h, number=TEL_HOOK_CALLS, repeat=5))
          / TEL_HOOK_CALLS * 1e9 for k, h in hooks.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    S, d, N, Q = 51, 8, SLOTS, CHUNK
    span = (S - 1) * d
    layers = dict(stem=(1, 15, "relu", False, False),
                  conv1=(15, 15, "relu", False, False),
                  conv2=(15, 15, "relu", True, False),
                  head_signal=(15, 1, "relu", False, True),
                  head_peak=(15, 1, None, False, True))
    host = {}
    for name, (C, K, act, res, f32out) in layers.items():
        xp = F.pad(torch.randn((N, C, Q), generator=gen, device=DEVICE),
                   (span, 0)).contiguous()
        w = torch.randn((S, K, C), generator=gen, device=DEVICE) * 0.1
        b = torch.randn((K,), generator=gen, device=DEVICE) * 0.1
        r = (torch.randn((N, K, Q), generator=gen, device=DEVICE)
             if res else None)

        def via_ops():
            return ops.conv1d(xp, w, bias=b, residual=r, activation=act,
                              dilation=d, padding="VALID",
                              out_dtype=torch.float32 if f32out else None)

        with torch.inference_mode():
            host[name] = _host_us(via_ops)
    phase2 = {r["shape"].split()[0]: r["ops_host_us"] for r in rows
              if "ops_host_us" in r}

    def step(t):
        return (t["stem"] + 11 * t["conv1"] + 11 * t["conv2"]
                + t["head_signal"] + t["head_peak"])

    stats = dict(disabled_hook_ns=ns, step_ops_host_us=step(host),
                 phase2_step_ops_host_us=step(phase2), per_layer_us=host)
    print("telemetry disabled " + json.dumps(stats), flush=True)
    return stats


def telemetry_check(torch, np, configs, blocks, serve, train, ops,
                    conv1d_brgemm, rows, bwd_rows):
    """Phase 17: the port's telemetry (``repro_torch.obs``) on the card.
    (a) The training cell TEL_STEPS steps through the launcher without and
    with ``--telemetry`` (tune cache a fresh file): losses and gradient
    norms bitwise equal; 49 + 25 launches a step, plus the probe cell's
    own with telemetry; the log validates; TEL_STEPS ``train.step``
    spans and 25 / 24 / 25 fwd / bwd-data / bwd-weight spans a step in
    the batch-8 cells, each timed by CUDA events with ``efficiency`` in
    (0, TEL_EFF_MAX]; no 15->15 span shorter than TEL_DUR_MIN x phase 4's
    device time of its pass; the three phases; health and straggler
    rollups clean; ``report.check`` == []; one trace ``X`` event a span.
    (b) TEL_STREAMS streams served with telemetry, bitwise the outputs
    without it; a ``serve.conv.chunk`` span a step; ``check_serving`` ==
    []. (c) A fig4 problem tuned into a fresh cache: one candidate event
    a timed candidate (predicted and measured seconds > 0) under a
    ``tune.search`` span, one hit on the repeat lookup; the cost-model
    ratio. (d) The ``--model-parallel TP_MP`` launcher on TP_MP gloo ranks
    sharing one log: ``check_model_parallel`` == [], both ranks' pids.
    (e) The disabled hooks' ns a call and the host time of a stream
    step's 25 ``ops.conv1d`` calls with telemetry off, beside phase 2's."""
    import tempfile

    from repro_torch import tune
    from repro_torch.tune.cache import ENV_CACHE_PATH

    t0 = time.perf_counter()
    counters = (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight)
    stats = {}
    before = os.environ.get(ENV_CACHE_PATH)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        os.environ[ENV_CACHE_PATH] = os.path.join(tmp, "auto.json")
        tune.reset_default_cache()
        try:
            stats["train"] = _tel_train(torch, np, configs, train, counters,
                                        tmp, bwd_rows)
        finally:
            if before is None:
                os.environ.pop(ENV_CACHE_PATH)
            else:
                os.environ[ENV_CACHE_PATH] = before
            tune.reset_default_cache()
        torch.cuda.empty_cache()
        stats["serve"] = _tel_serve(torch, np, configs, blocks, serve, tmp)
        stats["tune"] = _tel_tune(tmp)
        stats["tp"] = _tel_tp(tmp)
    stats["disabled"] = _tel_disabled(torch, ops, rows)
    stats["seconds"] = time.perf_counter() - t0
    print(f"telemetry: phase 17 in {stats['seconds']:.1f} s", flush=True)
    return stats


def _el_drills(tmp):
    """Phase 18's runs, in order: (name, argv)."""
    base = ["--arch", "atacworks", "--batch", str(EL_BATCH), "--seq",
            str(EL_SEQ), "--device", DEVICE, "--dist-backend", "gloo"]
    ten = base + ["--steps", str(EL_STEPS)]
    ck = os.path.join(tmp, "ck")
    return [
        ("A", ten + ["--ckpt-dir", ck + "A", "--ckpt-every", "100"]),
        ("B", ten + ["--ckpt-dir", ck + "B", "--ckpt-every", "2",
                     "--faults", "device_loss@5:2",
                     "--telemetry", os.path.join(tmp, "elastic.jsonl")]),
        ("C", ten + ["--ckpt-dir", ck + "C", "--ckpt-every", "4",
                     "--faults", "preempt@5"]),
        ("D", ten + ["--ckpt-dir", ck + "C", "--resume"]),
        ("E", base + ["--steps", str(EL_STRAGGLE_STEPS), "--ckpt-dir",
                      ck + "E", "--ckpt-every", "2",
                      "--faults", "straggle@5:1x6"])]


def _el_rank(rank, st):
    """Phase 18, one of EL_RANKS gloo ranks sharing the card: every drill
    through ``launch.train.run``, each over a generation 0 of all the
    ranks started from its own file store; each run's summary, printed
    lines and the two dense kernels' launches (the telemetry probe's
    counted apart)."""
    import contextlib
    import io
    import pickle

    import torch

    from repro_torch.kernels import conv1d_brgemm
    from repro_torch.launch import mesh, train
    from repro_torch.tune.cache import ENV_CACHE_PATH

    if st["device"] == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    os.environ[ENV_CACHE_PATH] = os.path.join(st["tmp"], f"tune{rank}.json")
    counters = (conv1d_brgemm.conv1d_fwd, conv1d_brgemm.conv1d_bwd_weight)
    probe_n = dict.fromkeys((c.__name__ for c in counters), 0)
    probe = train._telemetry_conv_probe

    def counted_probe(*a, **k):
        before = {c.__name__: c.launches for c in counters}
        probe(*a, **k)
        for c in counters:
            probe_n[c.__name__] += c.launches - before[c.__name__]

    train._telemetry_conv_probe = counted_probe
    out = {}
    try:
        for name, argv in st["drills"]:
            mesh.destroy()
            mesh.init_data_group("gloo", "file://" + os.path.join(
                st["tmp"], f"store{name}"), EL_RANKS, rank)
            probe_n.update(dict.fromkeys(probe_n, 0))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                summary, n = _counted(counters, lambda: train.run(argv))
            out[name] = dict(summary=summary, out=buf.getvalue(),
                             launches={k: n[k] - probe_n[k] for k in n},
                             probe_launches=dict(probe_n))
    finally:
        mesh.destroy()
    with open(os.path.join(st["tmp"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _el_micro_steps(run, lead, steps):
    """Microbatch steps (steps x accum) one rank ran in a drill: every
    rank runs generation 0 up to the fault's step, the tainted step
    included; the next generation's ranks run on from the restore."""
    hist = lead["mesh_history"]
    rec = lead["recoveries"]
    last = rec[0]["fault_step"] if rec else run["last_step"]
    n = (last + 1 - hist[0]["from_step"]) * hist[0]["accum"]
    if rec and run["status"] == "done":
        n += (steps - rec[0]["restore_step"]) * hist[1]["accum"]
    return n


def _el_arrays(np, path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def elastic_check(torch, np, train):
    """Phase 18: the elastic drill on EL_RANKS gloo ranks sharing the card
    (the full atacworks config, fp32, a global EL_BATCH x EL_SEQ).  A: an
    uninterrupted run.  B: ``device_loss@5:2`` with checkpoints every 2
    steps and telemetry: launch ranks 2 and 3 leave, the survivors re-plan
    dp 4 -> 2 at mp 1 with accumulation 1 -> 2, regroup, restore step 4
    and replay; ``check_elastic`` of its log == []; its losses before the
    restore point bitwise A's, the rest within EL_RTOL / EL_ATOL, its
    final parameters within PARAM_ATOL of A's but for PARAM_FLIP_FRAC of
    them.  C: ``preempt@5`` drains at step 5; D: ``--resume`` from it,
    its losses and final checkpoint bitwise A's.  E: ``straggle@5:1x6``
    over EL_STRAGGLE_STEPS steps: launch rank 1 rotated out, 3 healthy
    ranks plan dp 2, launch rank 3 idle.  Every rank launched 49
    ``conv1d_fwd`` and 25 ``conv1d_bwd_weight`` kernels a microbatch
    step it ran (the telemetry probe's apart).  NCCL regrouping across
    cards is not run: one card holds no two NCCL ranks."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch import obs
    from repro_torch.obs import report

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        st = dict(device=DEVICE, tmp=tmp, drills=_el_drills(tmp))
        mp.start_processes(_el_rank, args=(st,), nprocs=EL_RANKS,
                           start_method="spawn")
        res = []
        for r in range(EL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        lead = {name: res[0][name]["summary"] for name in "ABCDE"}
        status = {name: [r[name]["summary"]["status"] for r in res]
                  for name in "ABCDE"}
        want = dict(A=["done"] * 4, B=["done", "done", "lost", "lost"],
                    C=["preempted"] * 4, D=["done"] * 4,
                    E=["done", "lost", "done", "idle"])
        if status != want:
            raise AssertionError(f"elastic statuses {status}, want {want}")
        keys = ("kind", "fault_step", "restore_step", "dp_from", "dp_to",
                "mp", "accum")
        b_rec = [{k: r[k] for k in keys} for r in lead["B"]["recoveries"]]
        if b_rec != [dict(kind="device_loss", fault_step=5, restore_step=4,
                          dp_from=4, dp_to=2, mp=1, accum=2)] or [
                g["accum"] for g in lead["B"]["mesh_history"]] != [1, 2]:
            raise AssertionError(f"device-loss recovery {b_rec}, layouts "
                                 f"{lead['B']['mesh_history']}")
        e_rec = lead["E"]["recoveries"]
        if len(e_rec) != 1 or e_rec[0]["kind"] != "straggle" or not (
                e_rec[0]["dp_from"] == 4 and e_rec[0]["dp_to"] < 4
                and e_rec[0]["mp"] == 1):
            raise AssertionError(f"straggle recovery {e_rec}")
        missing = report.check_elastic(report.aggregate(obs.read_events(
            os.path.join(tmp, "elastic.jsonl"))))
        if missing:
            raise AssertionError(f"check_elastic: {missing}")
        a, b, c, d = (lead[k]["losses"] for k in "ABCD")
        r = b_rec[0]["restore_step"]
        if len(a) != EL_STEPS or not np.isfinite(a).all():
            raise AssertionError(f"uninterrupted losses {a}")
        if b[:r] != a[:r] or c != a[:6] or d != a[6:] \
                or lead["D"]["first_step"] != 6:
            raise AssertionError(f"losses not bitwise the uninterrupted "
                                 f"run's: A {a}, B {b}, C {c}, D {d}")
        if not np.allclose(b[r:], a[r:], rtol=EL_RTOL, atol=EL_ATOL):
            raise AssertionError(f"replayed losses {b[r:]} vs {a[r:]}")
        final = {k: _el_arrays(np, os.path.join(
            tmp, f"ck{k}", f"step_{EL_STEPS:08d}", "arrays.npz"))
            for k in "ABC"}
        if any(not np.array_equal(final["C"][k], v)
               for k, v in final["A"].items()):
            raise AssertionError("the resumed run's final checkpoint is "
                                 "not bitwise the uninterrupted run's")
        diffs = np.concatenate([
            np.abs(final["B"][k].astype(np.float64) - v).ravel()
            for k, v in final["A"].items() if k.startswith(".params/")])
        beyond = int((diffs > PARAM_ATOL).sum())
        if beyond > PARAM_FLIP_FRAC * diffs.size:
            raise AssertionError(
                f"{beyond} of {diffs.size} parameters after the recovery "
                f"differ by more than {PARAM_ATOL} (max {diffs.max()})")
        launches = {}
        for name, steps in zip("ABCDE", [EL_STEPS] * 4 + [EL_STRAGGLE_STEPS]):
            for rank, rr in enumerate(res):
                n = _el_micro_steps(rr[name]["summary"], lead[name], steps)
                got = rr[name]["launches"]
                if got != dict(conv1d_fwd=49 * n, conv1d_bwd_weight=25 * n):
                    raise AssertionError(
                        f"drill {name} rank {rank}: launches {got} in {n} "
                        "microbatch steps; expected 49 and 25 a step")
                launches[f"{name}{rank}"] = dict(got, micro_steps=n)
        recs = {k: lead[k]["recoveries"] for k in "BE"}
        stats = dict(
            ranks=EL_RANKS, batch=EL_BATCH, seq=EL_SEQ, statuses=status,
            recoveries=recs,
            mesh_history={k: lead[k]["mesh_history"] for k in "BE"},
            losses={k: lead[k]["losses"] for k in "ABDE"},
            replay_loss_max_rel_diff=max(
                abs(x - y) / abs(y) for x, y in zip(b[r:], a[r:])),
            param_max_abs_diff=float(diffs.max()),
            params_beyond_atol=beyond, params=int(diffs.size),
            launches=launches,
            probe_launches=res[0]["B"]["probe_launches"],
            out={k: res[0][k]["out"] for k in "ABCDE"})
    stats["seconds"] = time.perf_counter() - t0
    for k, rec in recs.items():
        rec = rec[0]
        print(f"elastic {k}: {rec['kind']} at step {rec['fault_step']}, dp "
              f"{rec['dp_from']} -> {rec['dp_to']} (accum {rec['accum']}), "
              f"restored step {rec['restore_step']}; time_to_detect_s "
              f"{rec['time_to_detect_s']:.4f}, time_to_restore_s "
              f"{rec['time_to_restore_s']:.4f}; step p50 pre-fault "
              f"{rec['pre_fault_step_s']:.4f} s, post-recovery "
              f"{rec['post_recovery_step_s']:.4f} s, post_shrink_efficiency "
              f"{rec['post_shrink_efficiency']:.4f}", flush=True)
    print("elastic " + json.dumps({k: v for k, v in stats.items()
                                   if k not in ("out", "losses",
                                                "launches")}), flush=True)
    micro = sum(v["micro_steps"] for v in launches.values())
    print(f"elastic: 49 conv1d_fwd and 25 conv1d_bwd_weight launches a "
          f"rank a microbatch step in every drill ({micro} rank microbatch "
          "steps)", flush=True)
    print(f"elastic: phase 18 in {stats['seconds']:.1f} s", flush=True)
    return stats


def _wh_frontend(torch, ref, conv1d_brgemm, whisper, model, counters):
    """Phase 19 (a): Whisper's conv frontend (128 -> 1280 and 1280 -> 1280,
    S=3, d=1, SAME, bias + gelu) on seeded bf16 mel (WH_MEL_BATCH, 128,
    WH_MEL_T) through ``whisper.conv_frontend`` (2 ``conv1d_fwd``
    launches) against the plain version, each element within TOL; each
    convolution alone on the same input, checked and timed beside
    ``F.conv1d`` and two bounds (the bf16 operands at the tensor cores'
    peak; the fp32 FMAs the kernel's body runs at 67 TFLOP/s); then the
    frontend's gradient in fp32 at WH_GRAD_MEL_BATCH x WH_MEL_T through
    ``Conv1dFunction`` (gelu preact, bwd-data through ``conv1d_fwd``,
    ``conv1d_bwd_weight`` with dbias, a launch a channel range where the
    channels do not fit its shared memory at once) against autograd over
    the plain version, each within BWD_TOL of its largest value; and
    ``conv1d_bwd_weight`` at those two layers timed beside the plain
    version, ``torch.nn.grad.conv1d_weight`` and phase 4's two bounds."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(192)
    N, M, T, D = WH_MEL_BATCH, whisper.N_MELS, WH_MEL_T, cfg.d_model
    p = {k: t.detach() for k, t in model.frontend.named_parameters()}
    mel = torch.randn((N, M, T), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    atol, rtol = TOL["bfloat16"]

    def within_tol(label, got, want):
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"{label}: an output is over {atol} + "
                                 f"{rtol} x |plain| from plain")
        scale = max(want.float().abs().max().item(), 1e-30)
        return dict(max_abs_err=diff.max().item(),
                    max_rel_diff=diff.max().item() / scale, atol=atol,
                    rtol=rtol, **_bf16_ulps(torch, got, want))

    with torch.no_grad():
        got, launched = _counted(
            counters, lambda: whisper.conv_frontend(p, mel, cfg))
        want = whisper.conv_frontend(p, mel, cfg, backend="ref")
    torch.cuda.synchronize()
    if launched != {**{k: 0 for k in launched}, "conv1d_fwd": 2}:
        raise AssertionError(f"conv_frontend launched {launched}; "
                             "expected 2 conv1d_fwd")
    if tuple(got.shape) != (N, T // 2, D) or got.dtype != mel.dtype:
        raise AssertionError(f"frames {tuple(got.shape)} {got.dtype}")
    out = dict(shape=f"frontend mel N={N} M={M} T={T} bf16",
               launches=launched, **within_tol("frontend", got, want))
    del got, want
    rows, x = [], mel
    for name, w, b in (("conv1", p["conv1_w"], p["conv1_b"]),
                       ("conv2", p["conv2_w"], p["conv2_b"])):
        S, K, C = w.shape
        xp = F.pad(x, (1, 1)).contiguous()
        w_kcs = w.permute(1, 2, 0).contiguous()

        def kern(xp=xp, w=w, b=b):
            return conv1d_brgemm.conv1d_fwd(xp, w, bias=b, activation="gelu")

        def plain(xp=xp, w=w, b=b):
            return ref.conv1d_fused_ref(xp, w, bias=b, activation="gelu")

        def library(xp=xp, w_kcs=w_kcs, b=b):
            return F.conv1d(xp, w_kcs, b)

        y = kern()
        label = f"whisper {name} b+gelu {C}->{K} S={S} N={N} Q={T} bf16"
        row = dict(shape=label, **within_tol(label, y, plain()),
                   tile=_fwd_tile(conv1d_brgemm, N, C, K, S, T + 2, 1),
                   kernel_ms=_device_ms(kern),
                   plain_ms=_device_ms(plain, per_graph=2),
                   library_ms=_device_ms(library), call_ms=_call_ms(kern))
        flop = 2.0 * N * K * C * S * T
        nbytes = (N * C * (T + 2) + S * K * C + K + N * K * T) * 2
        row["bound_ms"], row["bound_by"] = roofline.bound(flop, nbytes,
                                                          "bfloat16")
        row["fma_bound_ms"], row["fma_bound_by"] = roofline.bound(
            flop, nbytes, "float32")
        _rates(row, flops=flop)
        row["fma_bound_share"] = row["fma_bound_ms"] / row["kernel_ms"]
        rows.append(row)
        print("whisper-frontend-kernel " + json.dumps(row), flush=True)
        x = y
    del x, y
    out["rows"] = rows

    p32 = {k: t.float().requires_grad_() for k, t in p.items()}
    Ng = WH_GRAD_MEL_BATCH
    mel32 = torch.randn((Ng, M, T), generator=gen,
                        device=DEVICE).requires_grad_()
    cot = torch.randn((Ng, T // 2, D), generator=gen, device=DEVICE)
    leaves = {"mel": mel32, **p32}

    def grads(backend):
        y = whisper.conv_frontend(p32, mel32, cfg, backend=backend)
        return torch.autograd.grad((y * cot).sum(), list(leaves.values()))

    got, launched = _counted(counters, lambda: grads(None))
    want = grads("ref")
    torch.cuda.synchronize()
    # conv1d_bwd_weight stages every channel of a column tile: where they
    # do not fit, the wrapper takes the channels in ranges, a launch each
    ranges = {name: conv1d_brgemm.channel_ranges(
        C, lambda c, C=C: conv1d_brgemm.bwd_weight_body(
            Ng, c, D, 3, T + 2, 1) is not None)
        for name, C in (("conv1", M), ("conv2", D))}
    n_bw = sum(len(r) for r in ranges.values())
    if launched != {**{k: 0 for k in launched}, "conv1d_fwd": 4,
                    "conv1d_bwd_weight": n_bw}:
        raise AssertionError(f"the frontend's gradient launched {launched};"
                             " expected 4 conv1d_fwd (2 forward, 2 "
                             f"bwd-data) and {n_bw} conv1d_bwd_weight (the "
                             f"channel ranges {ranges})")
    tol = BWD_TOL["float32"]
    errs = {k: _check_close(f"frontend grad {k}", g, w, tol)
            for k, g, w in zip(leaves, got, want)}
    out["grad"] = dict(shape=f"frontend grad N={Ng} T={T} fp32",
                       launches=launched, bwd_weight_channel_ranges=ranges,
                       tol_rel_to_max_plain=tol,
                       max_abs_err={k: e[0] for k, e in errs.items()},
                       max_rel_diff={k: e[1] for k, e in errs.items()})
    del got, want, grads, leaves, p32, mel32
    # conv1d_bwd_weight (with dbias) at the gradient's two layers, timed
    # beside the plain version, cuDNN's weight gradient and both bounds
    # (phase 4's: three TF32 terms of the GEMM, and fp32 FMAs)
    bw_rows = []
    for name, C in (("conv1", M), ("conv2", D)):
        x = torch.randn((Ng, C, T + 2), generator=gen, device=DEVICE)
        g = torch.randn((Ng, D, T), generator=gen, device=DEVICE)

        def kern(x=x, g=g):
            return conv1d_brgemm.conv1d_bwd_weight(x, g, S=3, dilation=1,
                                                   with_dbias=True)

        def plain(x=x, g=g):
            return (ref.conv1d_bwd_weight_ref(x, g, dilation=1),
                    ref.conv1d_dbias_ref(g))

        def library(x=x, g=g, C=C):
            return torch.nn.grad.conv1d_weight(x, (D, C, 3), g)

        label = f"whisper {name} bwd_weight {C}->{D} S=3 N={Ng} Q={T} fp32"
        e = [_check_close(f"{label} {part}", a, b, tol)
             for part, a, b in zip(("dw", "dbias"), kern(), plain())]
        row = dict(shape=label, channel_ranges=len(ranges[name]),
                   max_abs_err=max(v[0] for v in e),
                   max_rel_diff=max(v[1] for v in e),
                   tol_rel_to_max_plain=tol, kernel_ms=_device_ms(kern),
                   plain_ms=_device_ms(plain, per_graph=2),
                   library_ms=_device_ms(library))
        flop = 2.0 * Ng * C * D * 3 * T
        nbytes = (Ng * C * (T + 2) + Ng * D * T + 3 * D * C + D) * 4
        row["bound_ms"], row["bound_by"] = roofline.bound(
            roofline.tf32_flops(Ng, C, D, 3, T), nbytes, "tf32")
        row["fma_bound_ms"], row["fma_bound_by"] = roofline.bound(
            flop, nbytes, "float32")
        _rates(row, flops=flop)
        row["fma_bound_share"] = row["fma_bound_ms"] / row["kernel_ms"]
        bw_rows.append(row)
        print("whisper-frontend-kernel " + json.dumps(row), flush=True)
    out["bwd_weight_rows"] = bw_rows
    print("whisper-frontend " + json.dumps(out), flush=True)
    return out


def _wh_serve(torch, serve, model, counters):
    """Phase 19 (b): ``serve_lm`` on the model (``--smoke``: the fused
    prefill held to the decode's logits within ``serve.prefill_tol``),
    launches counted around ``fill_cross_cache`` (32 ``flash_fwd``: the
    encoder), the fused prefill (64: encoder and decoder) and the rest
    (the decode steps: none); encode time, decode p50/p99, tokens/s, peak
    memory and the decode step's bound."""
    cfg = model.cfg
    args = serve.parse_args([
        "--arch", WH_ARCH, "--batch", str(WH_SERVE_BATCH), "--prompt-len",
        str(WH_PROMPT), "--gen", str(WH_GEN), "--seed", "193", "--smoke"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model_bytes = sum(t.numel() * t.element_size() for t in
                      (*model.parameters(), *model.buffers()))
    marks = {}

    def marked(key, fn):
        def run(*a, **k):
            before = {c.__name__: c.launches for c in counters}
            result = fn(*a, **k)
            marks[key] = {c.__name__: c.launches - before[c.__name__]
                          for c in counters}
            marks[key + "_result"] = result
            return result
        return run

    real = serve.fill_cross_cache, serve.prefill_gap
    serve.fill_cross_cache = marked("fill", real[0])
    serve.prefill_gap = marked("prefill", real[1])
    try:
        stats, launched = _counted(counters,
                                   lambda: serve.serve_lm(args, cfg, model))
    finally:
        serve.fill_cross_cache, serve.prefill_gap = real
    peak = (torch.cuda.max_memory_allocated() - held + model_bytes) / 1e9
    decode = {k: n - marks["fill"][k] - marks["prefill"][k]
              for k, n in launched.items()}
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    for key, got, n in (("fill_cross_cache", marks["fill"], Le),
                        ("fused prefill", marks["prefill"], Le + L),
                        ("decode steps", decode, 0)):
        if got != {**{k: 0 for k in got}, "flash_fwd": n}:
            raise AssertionError(f"whisper {key} launched {got}; expected "
                                 f"{n} flash_fwd and nothing else")
    if not bool(torch.isfinite(stats["prompt_logits"]).all()):
        raise AssertionError("whisper: non-finite logits")
    gap = marks["prefill_result"]
    kv_len = WH_PROMPT + WH_GEN // 2  # the generated steps' middle
    bound = _decode_bound(cfg, WH_SERVE_BATCH, kv_len,
                          serve.lm_cache_dtype(cfg))
    out = dict(arch=WH_ARCH, batch=WH_SERVE_BATCH, prompt_len=WH_PROMPT,
               gen=WH_GEN, frames=list(stats["frames"].shape),
               dtype=cfg.dtype, cache_dtype=stats["cache_dtype"],
               encode_s=stats["encode_s"],
               sequential_prefill_s=stats["prefill_s"],
               step_p50_ms=stats["step_p50_ms"],
               step_p99_ms=stats["step_p99_ms"],
               tokens_per_s=stats["tokens_per_s"],
               fill_launches=marks["fill"],
               prefill_launches=marks["prefill"], decode_launches=decode,
               prefill_vs_decode=gap, peak_memory_gb=peak,
               model_gb=model_bytes / 1e9, decode_bound_at_kv_len=kv_len,
               **bound,
               decode_bound_share=bound["bound_ms"] / stats["step_p50_ms"])
    print("whisper-serve " + json.dumps(out), flush=True)
    return out


def _wh_flash_rows(torch, fa, ref, cfg):
    """Phase 19 (d): ``flash_fwd`` and ``flash_bwd`` at the encoder's
    attention (``cfg``'s 1,500 frames, 20 heads over 20 KV heads of 64,
    bf16, non-causal; G = 1, the last key tile ragged), each against its
    plain version by ``flash_kernel_checks``' rule; the forward timed at
    batch WH_FA_FWD_B, the backward at WH_FA_BWD_B, beside SDPA and the
    bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(197)
    rows = []
    T, H, hd = cfg.encoder_width, cfg.n_heads, cfg.head_dim
    for B, passes in ((WH_FA_FWD_B, ("fwd",)), (WH_FA_BWD_B, ("bwd",))):
        _flash_check(torch, fa, ref, gen, rows,
                     f"whisper encoder B={B} T={T} H={H} KV={H} hd={hd} "
                     "bf16 non-causal", B, T, H, 1, torch.bfloat16, False,
                     timed=passes, hd=hd)
    return rows


def whisper_check(torch, np, configs, init_model, serve, train, synthetic,
                  losses, ref, conv1d_brgemm, fa):
    """Phase 19: Whisper-large-v3 on the card (see WH_*): the model built
    once (bf16, flash), the frontend (``_wh_frontend``), serving
    (``_wh_serve``), then training through the launcher (128 + 64 flash
    launches a step: 64 forward, 64 remat recompute, 64 backward), the
    2 + 2-layer fp32 gradient and the encoder's flash rows."""
    import dataclasses

    from repro_torch.models import whisper

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    cfg = dataclasses.replace(configs.get(WH_ARCH), attn_impl="flash")
    model = _lm_model(torch, cfg, init_model, seed=191)
    out = dict(init_s=time.perf_counter() - t0)
    out["frontend"] = _wh_frontend(torch, ref, conv1d_brgemm, whisper, model,
                                   counters)
    out["serve"] = _wh_serve(torch, serve, model, counters)
    del model
    torch.cuda.empty_cache()
    n = cfg.n_layers + cfg.n_encoder_layers
    out["train"] = _train_check(
        np, train, "whisper",
        ["--arch", WH_ARCH, "--attn-impl", "flash", "--steps",
         str(WH_STEPS), "--batch", str(WH_BATCH), "--seq", str(WH_SEQ)],
        WH_STEPS, counters, (0, 0, 0, 0, 2 * n, n), LM_MEMORY_LIMIT_GB)
    out["breakdown"] = _train_breakdown(
        torch, train, "whisper",
        ["--arch", WH_ARCH, "--attn-impl", "flash", "--steps",
         str(BREAKDOWN_STEPS), "--batch", str(WH_BATCH), "--seq",
         str(WH_SEQ)], BREAKDOWN_STEPS,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_"))
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    gcfg = dataclasses.replace(cfg, n_layers=WH_GRAD_LAYERS,
                               n_encoder_layers=WH_GRAD_LAYERS,
                               dtype="float32")
    gmodel = _lm_model(torch, gcfg, init_model, seed=195)
    batch = _batch(torch, synthetic, gcfg, WH_GRAD_BATCH, WH_GRAD_SEQ, 196)

    def run(attn_impl):
        def logits(tokens):
            gmodel.cfg = dataclasses.replace(gcfg, attn_impl=attn_impl)
            return gmodel(tokens, frames=batch["frames"])
        return logits

    g = 2 * WH_GRAD_LAYERS
    out["grad"] = _model_grad_check(
        torch, losses, "whisper", gcfg, gmodel, batch, run("flash"),
        run("chunked"), (fa.flash_fwd, fa.flash_bwd), (2 * g, g),
        "encoder and decoder forward and remat recompute; backward", 52,
        scale_of=WH_ZERO_GRAD)
    del gmodel, batch
    torch.cuda.empty_cache()
    out["flash_rows"] = _wh_flash_rows(torch, fa, ref, cfg)
    out["seconds"] = time.perf_counter() - t0
    s, t, f = out["serve"], out["train"], out["frontend"]["rows"]
    print(f"whisper: phase 19 in {out['seconds']:.1f} s (model built in "
          f"{out['init_s']:.1f} s); frontend conv1 {f[0]['kernel_ms']:.4f}"
          f" ms, conv2 {f[1]['kernel_ms']:.4f} ms (F.conv1d "
          f"{f[0]['library_ms']:.4f}, {f[1]['library_ms']:.4f}); serving: "
          f"encode {s['encode_s']:.3f} s, decode p50 "
          f"{s['step_p50_ms']:.3f} ms, p99 {s['step_p99_ms']:.3f} ms, "
          f"{s['tokens_per_s']:.1f} tokens/s, peak {s['peak_memory_gb']:.2f}"
          f" GB, bound {s['bound_ms']:.4f} ms; training: step p50 "
          f"{t['step_p50_ms']:.1f} ms, {t['tokens_per_s']:.0f} tokens/s, "
          f"{t['model_tflops_per_s']:.1f} TFLOP/s, peak "
          f"{t['peak_memory_gb']:.2f} GB", flush=True)
    return out


def _zb_flash_rows(torch, fa, ref, cfg):
    """Phase 20 (a): ``flash_fwd`` and ``flash_bwd`` at Zamba2's shared
    attention in its training cell (ZB_BATCH x ZB_SEQ, 32 heads over 32
    KV heads of 112, bf16, causal), timed beside SDPA and the bound, and
    in fp32 at ZB_FA_F32, each against its plain version by
    ``flash_kernel_checks``' rule."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(207)
    rows = []
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _flash_check(torch, fa, ref, gen, rows,
                 f"zamba2 B={ZB_BATCH} T={ZB_SEQ} H={H} KV={KV} hd={hd} "
                 "bf16 causal", ZB_BATCH, ZB_SEQ, KV, H // KV,
                 torch.bfloat16, True, timed=True, hd=hd)
    B, T, kv, G = ZB_FA_F32
    _flash_check(torch, fa, ref, gen, rows,
                 f"zamba2 B={B} T={T} H={kv * G} KV={kv} hd={hd} fp32 "
                 "causal", B, T, kv, G, torch.float32, True, hd=hd)
    return rows


def _zb_serve(torch, serve, cfg, model, counters):
    """Phase 20 (b): ``serve_lm`` on Zamba2-7B cut to ZB_SERVE_LAYERS
    layers (``--smoke``: the
    fused prefill held to the decode's logits within
    ``serve.prefill_tol``), launches counted around the fused prefill (a
    ``depthwise_conv1d_fwd`` a layer, a ``flash_fwd`` an application of
    the shared block) and the rest (the decode steps: none); decode
    p50/p99, tokens/s, the sequential prefill's seconds, the fused
    prefill's call time, peak memory, the decode's device busy share and
    a decode step's bound."""
    from repro_torch.models import zamba2

    argv = ["--arch", ZB_ARCH, "--batch", str(ZB_SERVE_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN), "--seed",
            "203"]
    args = serve.parse_args(argv + ["--smoke"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model_bytes = sum(t.numel() * t.element_size() for t in
                      (*model.parameters(), *model.buffers()))
    marks = {}
    real = serve.prefill_gap

    def prefill_gap(*a, **k):
        before = {c.__name__: c.launches for c in counters}
        marks["gap"] = real(*a, **k)
        marks["prefill"] = {c.__name__: c.launches - before[c.__name__]
                            for c in counters}
        return marks["gap"]

    serve.prefill_gap = prefill_gap
    try:
        stats, launched = _counted(counters,
                                   lambda: serve.serve_lm(args, cfg, model))
    finally:
        serve.prefill_gap = real
    peak = (torch.cuda.max_memory_allocated() - held + model_bytes) / 1e9
    decode = {k: n - marks["prefill"][k] for k, n in launched.items()}
    n_app = zamba2.n_shared_applications(cfg)
    want = {**{k: 0 for k in launched},
            "depthwise_conv1d_fwd": cfg.n_layers, "flash_fwd": n_app}
    if marks["prefill"] != want:
        raise AssertionError(f"zamba2: one fused prefill launched "
                             f"{marks['prefill']}; expected {want}")
    if any(decode.values()):
        raise AssertionError(f"zamba2: the decode steps launched {decode}")
    if not bool(torch.isfinite(stats["prompt_logits"]).all()):
        raise AssertionError("zamba2: non-finite logits")
    step = serve.make_prefill_step(cfg)
    prompt = {"tokens": stats["prompt"]}
    prefill_call_ms = _call_ms(lambda: step(model, prompt), reps=3)
    # the decode's busy share: ZB_TRACE_PROMPT + ZB_TRACE_GEN - 1 steps
    small = serve.parse_args(argv[:2] + [
        "--batch", str(ZB_SERVE_BATCH), "--prompt-len",
        str(ZB_TRACE_PROMPT), "--gen", str(ZB_TRACE_GEN)])
    n = ZB_TRACE_PROMPT + ZB_TRACE_GEN - 1
    traced, dkernels, _ = _trace(
        torch, lambda: serve.serve_lm(small, cfg, model), (), n)
    traced_step_ms = (traced["prefill_s"] + sum(traced["step_s"])) * 1e3 / n
    busy = sum(k["ms_per_step"] for k in dkernels)
    kv_len = LM_PROMPT + LM_GEN // 2  # the generated steps' middle
    bound = _decode_bound(cfg, ZB_SERVE_BATCH, kv_len,
                          serve.lm_cache_dtype(cfg))
    out = dict(arch=ZB_ARCH, layers=cfg.n_layers, shared_applications=n_app,
               batch=ZB_SERVE_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
               dtype=cfg.dtype, cache_dtype=stats["cache_dtype"],
               sequential_prefill_s=stats["prefill_s"],
               step_p50_ms=stats["step_p50_ms"],
               step_p99_ms=stats["step_p99_ms"],
               tokens_per_s=stats["tokens_per_s"],
               prefill_launches=marks["prefill"], decode_launches=decode,
               prefill_vs_decode=marks["gap"],
               prefill_call_ms=prefill_call_ms, peak_memory_gb=peak,
               model_gb=model_bytes / 1e9,
               decode_traced_step_ms=traced_step_ms,
               decode_device_busy_ms=busy,
               decode_device_busy_share=busy / traced_step_ms,
               decode_kernels_per_step=sum(k["calls"] for k in dkernels) / n,
               decode_bound_at_kv_len=kv_len, **bound,
               decode_bound_share=bound["bound_ms"] / stats["step_p50_ms"],
               decode_top=dkernels[:8])
    print("zamba2-serve " + json.dumps(out), flush=True)
    return out


def zamba2_check(torch, np, configs, init_model, serve, train, synthetic,
                 losses, ref, conv1d_brgemm, fa):
    """Phase 20: Zamba2-7B on the card (see ZB_*): the depthwise and flash
    kernels at its training shapes (``dw_kernel_checks``,
    ``_zb_flash_rows``), the model cut to ZB_SERVE_LAYERS layers built
    once (bf16, flash) and served (``_zb_serve``), then the 12-layer cut trained through the
    launcher (3 L + L depthwise and 2 + 1 flash launches an application
    a step: forward, remat recompute, backward) and its fp32 copy's whole
    gradient against the plain attention and conv."""
    import dataclasses

    from repro_torch.models import mamba2, zamba2

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    cfg = dataclasses.replace(configs.get(ZB_ARCH), n_layers=ZB_SERVE_LAYERS,
                              attn_impl="flash")
    _, _, conv_dim = mamba2.dims(cfg)
    out = dict(dw_rows=dw_kernel_checks(
        torch, conv1d_brgemm, ref, "zamba2", (ZB_BATCH, conv_dim, ZB_SEQ),
        more=False))
    out["flash_rows"] = _zb_flash_rows(torch, fa, ref, cfg)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = _lm_model(torch, cfg, init_model, seed=201)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["params"] = sum(p.numel() for p in model.parameters())
    print(f"zamba2: {out['params']} parameters drawn and moved to the card "
          f"in {out['init_s']:.1f} s", flush=True)
    out["serve"] = _zb_serve(torch, serve, cfg, model, counters)
    # kept on the host for the fp32 gradient copy: the same 12 layers
    # cast, not drawn again (a draw takes 13-16 s of host time)
    served = type(model)(cfg, {k: t.cpu() for k, t in
                               model.state_dict().items()})
    del model
    torch.cuda.empty_cache()
    tcfg = configs.register(dataclasses.replace(
        configs.get(ZB_ARCH), name=ZB_TRAIN_ARCH, n_layers=ZB_TRAIN_LAYERS))
    L, n_app = tcfg.n_layers, zamba2.n_shared_applications(tcfg)
    per_step = (0, 0, 3 * L, L, 2 * n_app, n_app)
    out["train"] = _train_check(
        np, train, "zamba2",
        ["--arch", ZB_TRAIN_ARCH, "--attn-impl", "flash", "--steps",
         str(ZB_STEPS), "--batch", str(ZB_BATCH), "--seq", str(ZB_SEQ)],
        ZB_STEPS, counters, per_step, LM_MEMORY_LIMIT_GB)
    out["breakdown"] = _train_breakdown(
        torch, train, "zamba2",
        ["--arch", ZB_TRAIN_ARCH, "--attn-impl", "flash", "--steps",
         str(BREAKDOWN_STEPS), "--batch", str(ZB_BATCH), "--seq",
         str(ZB_SEQ)], BREAKDOWN_STEPS,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_", "dw_fwd_kernel",
         "dw_bwd_weight_partial", "dw_reduce_partials"))
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gcfg = dataclasses.replace(tcfg, dtype="float32", attn_impl="flash")
    gmodel = _as_fp32(served, gcfg).to(DEVICE)
    del served
    batch = _batch(torch, synthetic, gcfg, ZB_GRAD_BATCH, ZB_GRAD_SEQ, 206)

    def run(attn_impl, backend):
        def logits(tokens):
            gmodel.cfg = dataclasses.replace(gcfg, attn_impl=attn_impl)
            return gmodel(tokens, backend=backend)
        return logits

    out["grad"] = _model_grad_check(
        torch, losses, "zamba2", gcfg, gmodel, batch, run("flash", None),
        run("chunked", "ref"), counters[2:], per_step[2:],
        "depthwise forward, remat recompute and bwd-data; bwd-weight; "
        "flash forward and recompute an application; backward", 21)
    del gmodel, batch
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    s, tr = out["serve"], out["train"]
    fl, dw = out["flash_rows"][0], {r["pass_"]: r for r in out["dw_rows"]}
    print(f"zamba2: phase 20 in {out['seconds']:.1f} s (the "
          f"{cfg.n_layers}-layer model drawn in {out['init_s']:.1f} s); "
          f"flash hd {cfg.head_dim} fwd "
          f"{fl['fwd_kernel_ms']:.3f} ms (SDPA {fl['fwd_library_ms']:.3f}, "
          f"bound {fl['fwd_bound_ms']:.3f}), bwd {fl['bwd_kernel_ms']:.3f} "
          f"ms (SDPA {fl['bwd_library_ms']:.3f}, bound "
          f"{fl['bwd_bound_ms']:.3f}); depthwise fwd "
          f"{dw['fwd']['kernel_ms']:.3f} ms, bwd-data "
          f"{dw['bwd_data']['kernel_ms']:.3f} ms, bwd-weight "
          f"{dw['bwd_weight']['kernel_ms']:.3f} ms; serving: decode p50 "
          f"{s['step_p50_ms']:.3f} ms, p99 {s['step_p99_ms']:.3f} ms, "
          f"{s['tokens_per_s']:.1f} tokens/s, fused prefill "
          f"{s['prefill_call_ms']:.1f} ms, peak {s['peak_memory_gb']:.2f} "
          f"GB, bound {s['bound_ms']:.4f} ms, decode busy "
          f"{s['decode_device_busy_share']:.3f}; training {L} layers: step "
          f"p50 {tr['step_p50_ms']:.1f} ms, {tr['tokens_per_s']:.0f} "
          f"tokens/s, {tr['model_tflops_per_s']:.1f} TFLOP/s, peak "
          f"{tr['peak_memory_gb']:.2f} GB", flush=True)
    return out


def _zb_entries(zb, dw_fwd_entry, dw_bw_entry, flash_entries, head_dims):
    """Phase 20's numbers in the kernels line: Zamba2's conv layer (7,296
    channels) under the two depthwise kernels and its shared attention
    (head_dim 112) under the two flash kernels, each with its launches a
    training step, a fused prefill and a decode step."""
    keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err")
    launches = zb["train"]["launches_per_step"]
    prefill, decode = (zb["serve"]["prefill_launches"],
                       zb["serve"]["decode_launches"])
    dw = {r["pass_"]: r for r in zb["dw_rows"]}
    for entry, pas in ((dw_fwd_entry, "fwd"), (dw_bw_entry, "bwd_weight")):
        entry["zamba2"] = dict(
            launches_per_train_step=launches[entry["name"]],
            **{k: dw[pas][k] for k in keys + ("gb_per_s",)})
    dw_fwd_entry["zamba2"].update(
        launches_per_prefill=prefill["depthwise_conv1d_fwd"],
        launches_in_decode=decode["depthwise_conv1d_fwd"],
        bwd_data={k: dw["bwd_data"][k] for k in keys})
    cell = zb["flash_rows"][0]
    for entry, pas, errs in zip(flash_entries, ("fwd", "bwd"),
                                (("o", "lse"), ("dq", "dk", "dv"))):
        entry["head_dims"] = list(head_dims)
        entry["zamba2"] = dict(
            launches_per_train_step=launches[entry["name"]],
            max_abs_err=max(r["max_abs_err"][e] for r in zb["flash_rows"]
                            for e in errs),
            **{k: cell.get(f"{pas}_{k}", cell.get(k)) for k in (
                "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_share", "tflops")})
    flash_entries[0]["zamba2"].update(
        launches_per_prefill=prefill["flash_fwd"],
        launches_in_decode=decode["flash_fwd"])


def _syncs(torch, fn):
    """``fn()`` and the synchronizing CUDA calls it made (a copy to the
    host, an ``item``), counted by torch's sync debug mode, which warns at
    each."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _mn_flash_rows(torch, fa, ref, cfg):
    """Phase 21 (a): ``flash_fwd`` and ``flash_bwd`` at Moonlight's
    attention in its training cell (MN_BATCH x MN_SEQ, 16 heads over 16
    KV heads of 128, bf16, causal), timed beside SDPA and the bound, and
    in fp32 at MN_FA_F32, each against its plain version by
    ``flash_kernel_checks``' rule."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(211)
    rows = []
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _flash_check(torch, fa, ref, gen, rows,
                 f"moonlight B={MN_BATCH} T={MN_SEQ} H={H} KV={KV} hd={hd} "
                 "bf16 causal", MN_BATCH, MN_SEQ, KV, H // KV,
                 torch.bfloat16, True, timed=True, hd=hd)
    B, T, kv, G = MN_FA_F32
    _flash_check(torch, fa, ref, gen, rows,
                 f"moonlight B={B} T={T} H={kv * G} KV={kv} hd={hd} fp32 "
                 "causal", B, T, kv, G, torch.float32, True, hd=hd)
    return rows


def _touched_bound(torch, cfg, batch, kv_len, routing, cache_dtype):
    """A decode step's least bytes counting only the experts its
    selections touch: every weight a token uses outside the routed experts
    (the batch's embedding rows), each MoE layer's distinct selected
    experts (the mean over the decode steps ``routing`` recorded), and
    the cache; with its time at the card's rates."""
    from repro_torch.roofline import flops as counts
    m = cfg.moe
    expert = 2 * 3 * cfg.d_model * m.d_ff_expert  # bytes, bf16
    shape = counts.StepShape("decode", kv_len + 1, batch)
    routed = (cfg.n_layers - m.first_dense_layers) * m.top_k * expert
    distinct = []
    for layer in routing.layers():
        experts, _ = routing.selection(layer)  # (B, T, k)
        T = experts.shape[1]
        present = torch.zeros((T, m.n_experts), dtype=torch.bool,
                              device=experts.device)
        present.scatter_(1, experts.transpose(0, 1).reshape(T, -1), True)
        distinct.append(present.sum(1).float().mean().item())
    nbytes = (counts.hbm_bytes_decode(cfg, shape, cache_dtype.itemsize)
              - routed + expert * sum(distinct))
    ms, by = roofline.bound(counts.model_flops(cfg, shape), nbytes,
                            "bfloat16")
    return dict(touched_bound_ms=ms, touched_bound_by=by,
                touched_bytes=nbytes,
                distinct_experts_per_layer_mean=sum(distinct) / len(distinct),
                distinct_experts_per_layer_min=min(distinct),
                distinct_experts_per_layer_max=max(distinct))


def _moe_serve(torch, serve, label, arch, cfg, model, counters, batch):
    """Phases 21 (b) and 22 (b): ``serve_lm`` on ``arch`` at ``batch``
    (``--smoke``: the fused prefill held to the decode's logits within
    ``serve.prefill_tol`` with the decode's expert selection replayed,
    and run with its own, whose flips per layer, smallest margin and
    largest score difference are reported); the decode steps launch no
    kernel, the check's two prefills 2 x L ``flash_fwd`` and one fused
    prefill L; decode p50/p99, tokens/s, the sequential prefill's
    seconds, the fused prefill's call time, peak memory, the syncs of one
    decode step, the decode's busy share and kernels a step, and its
    bound two ways: the roofline's count (every weight a token uses, the
    batch's embedding rows; JAX's reads the whole table) and the experts
    the batch's selections touch.  Returns the numbers and the prompt."""
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--seed", "213"]
    args = serve.parse_args(argv + ["--smoke"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model_bytes = sum(t.numel() * t.element_size() for t in
                      (*model.parameters(), *model.buffers()))
    marks = {}
    real = serve.prefill_gap

    def prefill_gap(*a, **k):
        before = {c.__name__: c.launches for c in counters}
        marks["gap"] = real(*a, **k)
        marks["gap_launches"] = {c.__name__: c.launches - before[c.__name__]
                                 for c in counters}
        marks["routing"] = k["routing"]
        return marks["gap"]

    serve.prefill_gap = prefill_gap
    try:
        stats, launched = _counted(counters,
                                   lambda: serve.serve_lm(args, cfg, model))
    finally:
        serve.prefill_gap = real
    peak = (torch.cuda.max_memory_allocated() - held + model_bytes) / 1e9
    decode = {k: n - marks["gap_launches"][k] for k, n in launched.items()}
    if any(decode.values()):
        raise AssertionError(f"{label}: the decode steps launched {decode}")
    if not bool(torch.isfinite(stats["prompt_logits"]).all()):
        raise AssertionError(f"{label}: non-finite logits")
    step = serve.make_prefill_step(cfg)
    prompt = {"tokens": stats["prompt"]}
    _, prefill = _counted(counters, lambda: step(model, prompt))
    want = {**{k: 0 for k in prefill}, "flash_fwd": cfg.n_layers}
    if prefill != want or marks["gap_launches"] != {
            k: 2 * n for k, n in want.items()}:
        raise AssertionError(f"{label}: a fused prefill launched "
                             f"{prefill}, the check's two "
                             f"{marks['gap_launches']}; expected {want}")
    prefill_call_ms = _call_ms(lambda: step(model, prompt), reps=3)
    cache_dtype = serve.lm_cache_dtype(cfg)
    cache = serve.make_cache(cfg, batch, 2, dtype=cache_dtype, device=DEVICE)
    decode_step = serve.make_serve_step(cfg)
    tok = stats["prompt"][:, :1]
    decode_step(model, cache, tok, 0)
    _, syncs = _syncs(torch, lambda: decode_step(model, cache, tok, 1))
    del cache
    # the decode's busy share: MN_TRACE_PROMPT + MN_TRACE_GEN - 1 steps
    small = serve.parse_args(argv[:2] + [
        "--batch", str(batch), "--prompt-len", str(MN_TRACE_PROMPT),
        "--gen", str(MN_TRACE_GEN)])
    n = MN_TRACE_PROMPT + MN_TRACE_GEN - 1
    traced, dkernels, _ = _trace(
        torch, lambda: serve.serve_lm(small, cfg, model), (), n)
    traced_step_ms = (traced["prefill_s"] + sum(traced["step_s"])) * 1e3 / n
    busy = sum(k["ms_per_step"] for k in dkernels)
    kv_len = LM_PROMPT + LM_GEN // 2  # the generated steps' middle
    bound = _decode_bound(cfg, batch, kv_len, cache_dtype)
    touched = _touched_bound(torch, cfg, batch, kv_len, marks["routing"],
                             cache_dtype)
    gap = marks["gap"]
    r = gap["routing"]
    out = dict(arch=arch, layers=cfg.n_layers, batch=batch,
               prompt_len=LM_PROMPT, gen=LM_GEN, dtype=cfg.dtype,
               cache_dtype=stats["cache_dtype"],
               sequential_prefill_s=stats["prefill_s"],
               step_p50_ms=stats["step_p50_ms"],
               step_p99_ms=stats["step_p99_ms"],
               tokens_per_s=stats["tokens_per_s"],
               prefill_launches=prefill, decode_launches=decode,
               prefill_vs_decode_replayed=gap["gap"],
               prefill_vs_decode_own_selection=gap["free_gap"],
               prefill_tol=gap["tol"], flips_per_layer=r["flips"],
               total_flips=r["total_flips"],
               selections=batch * LM_PROMPT * len(r["flips"]),
               min_selection_margin=r["min_margin"],
               max_selection_score_diff=r["max_score_diff"],
               rows_with_clear_margin=gap["rows_with_clear_margin"],
               prefill_call_ms=prefill_call_ms, peak_memory_gb=peak,
               model_gb=model_bytes / 1e9, syncs_per_decode_step=syncs,
               decode_traced_step_ms=traced_step_ms,
               decode_device_busy_ms=busy,
               decode_device_busy_share=busy / traced_step_ms,
               decode_kernels_per_step=sum(k["calls"] for k in dkernels) / n,
               decode_bound_at_kv_len=kv_len, **bound, **touched,
               jax_count_bound_ms=roofline.bound(
                   0.0, bound["param_bytes"] + bound["cache_bytes"]
                   + 2 * (cfg.vocab_size - batch) * cfg.d_model,
                   "bfloat16")[0],
               decode_bound_share=bound["bound_ms"] / stats["step_p50_ms"],
               decode_top=dkernels[:8])
    print(f"{label}-serve " + json.dumps(out), flush=True)
    return out, stats["prompt"]


def _moe_grad(torch, losses, synthetic, init_model, moe, label, tcfg,
              counters, per_step, batch_size, seq, seed, n_grads):
    """Phases 21 (c) and 22 (c), last part: an fp32 copy of the cut's
    whole gradient at ``batch_size`` x ``seq`` through the flash kernels
    against the plain attention (phase 11's rule, the total loss with the
    load-balance term), TF32 off.  First both paths' expert selections,
    recorded: a flip fails the check (its smallest margin and largest
    score difference are printed either way); then the syncs of one
    gradient (its MoE layers' group sizes, forward and remat
    recompute)."""
    import dataclasses

    from repro_torch.train.data_parallel import param_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gcfg = dataclasses.replace(tcfg, dtype="float32", attn_impl="flash")
    gmodel = _lm_model(torch, gcfg, init_model, seed=seed)
    batch = _batch(torch, synthetic, gcfg, batch_size, seq, seed + 1)

    def run(attn_impl):
        def logits(tokens):
            gmodel.cfg = dataclasses.replace(gcfg, attn_impl=attn_impl)
            return gmodel(tokens)
        return logits

    logs = {}
    with torch.no_grad():
        for impl in ("flash", "chunked"):
            gmodel.routing = logs[impl] = moe.RoutingLog()
            run(impl)(batch["tokens"])
    gmodel.routing = None
    routing = moe.compare_routing(logs["chunked"], logs["flash"])
    print(f"{label}-grad-routing " + json.dumps(routing), flush=True)
    if routing["total_flips"]:
        raise AssertionError(f"{label}: the kernel and plain paths select "
                             f"different experts: {routing}")
    out = _model_grad_check(
        torch, losses, label, gcfg, gmodel, batch, run("flash"),
        run("chunked"), counters[4:], per_step[4:],
        "forward and remat recompute; backward", n_grads)
    gmodel.cfg = gcfg
    params = [p for _, p in gmodel.named_parameters()]
    _, syncs = _syncs(torch, lambda: param_grads(
        losses.make_loss_fn(gcfg)(gmodel, batch)[0], params))
    out.update(routing=routing, syncs_per_gradient=syncs)
    return out


def moonlight_check(torch, np, configs, init_model, serve, train, synthetic,
                    losses, ref, conv1d_brgemm, fa):
    """Phase 21: Moonlight-16B-A3B on the card (see MN_*): the flash
    kernels at its attention (``_mn_flash_rows``), the 12-layer cut built
    once (bf16, flash) and served (``_moe_serve``), then the 6-layer cut
    trained through the launcher (2 L + L flash launches a step: forward,
    remat recompute, backward) and traced, and its fp32 copy's whole
    gradient against the plain attention (``_moe_grad``)."""
    import dataclasses

    from repro_torch.models import moe

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    cfg = dataclasses.replace(configs.register(dataclasses.replace(
        configs.get(MN_ARCH), name=MN_SERVE_ARCH,
        n_layers=MN_SERVE_LAYERS)), attn_impl="flash")
    out = dict(flash_rows=_mn_flash_rows(torch, fa, ref, cfg))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = _lm_model(torch, cfg, init_model, seed=215)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["params"] = sum(p.numel() for p in model.parameters())
    print(f"moonlight: {out['params']} parameters drawn and moved to the "
          f"card in {out['init_s']:.1f} s", flush=True)
    out["serve"], _ = _moe_serve(torch, serve, "moonlight", MN_SERVE_ARCH,
                                 cfg, model, counters, MN_SERVE_BATCH)
    del model
    torch.cuda.empty_cache()
    tcfg = configs.register(dataclasses.replace(
        configs.get(MN_ARCH), name=MN_TRAIN_ARCH, n_layers=MN_TRAIN_LAYERS,
        xent_chunk=MN_XENT_CHUNK))
    L = tcfg.n_layers
    per_step = (0, 0, 0, 0, 2 * L, L)
    argv = ["--arch", MN_TRAIN_ARCH, "--attn-impl", "flash", "--batch",
            str(MN_BATCH), "--seq", str(MN_SEQ)]
    out["train"] = _train_check(np, train, "moonlight",
                                argv + ["--steps", str(MN_STEPS)], MN_STEPS,
                                counters, per_step, LM_MEMORY_LIMIT_GB)
    out["breakdown"] = _train_breakdown(
        torch, train, "moonlight",
        argv + ["--steps", str(BREAKDOWN_STEPS)], BREAKDOWN_STEPS,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_"))
    torch.cuda.empty_cache()
    out["grad"] = _moe_grad(torch, losses, synthetic, init_model, moe,
                            "moonlight", tcfg, counters, per_step,
                            MN_GRAD_BATCH, MN_GRAD_SEQ, 217, 26)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    s, tr, fl = out["serve"], out["train"], out["flash_rows"][0]
    print(f"moonlight: phase 21 in {out['seconds']:.1f} s (the "
          f"{cfg.n_layers}-layer model drawn in {out['init_s']:.1f} s); "
          f"flash hd {cfg.head_dim} G=1 fwd {fl['fwd_kernel_ms']:.3f} ms "
          f"(SDPA {fl['fwd_library_ms']:.3f}, bound "
          f"{fl['fwd_bound_ms']:.3f}), bwd {fl['bwd_kernel_ms']:.3f} ms "
          f"(SDPA {fl['bwd_library_ms']:.3f}, bound "
          f"{fl['bwd_bound_ms']:.3f}); serving: decode p50 "
          f"{s['step_p50_ms']:.3f} ms, p99 {s['step_p99_ms']:.3f} ms, "
          f"{s['tokens_per_s']:.1f} tokens/s, {s['syncs_per_decode_step']} "
          f"syncs a step, fused prefill {s['prefill_call_ms']:.1f} ms, peak "
          f"{s['peak_memory_gb']:.2f} GB, bound {s['bound_ms']:.4f} ms "
          f"(touched experts {s['touched_bound_ms']:.4f}), decode busy "
          f"{s['decode_device_busy_share']:.3f}, prefill flips "
          f"{s['total_flips']} of {s['selections']}; training {L} layers: "
          f"step p50 {tr['step_p50_ms']:.1f} ms, {tr['tokens_per_s']:.0f} "
          f"tokens/s, {tr['model_tflops_per_s']:.1f} TFLOP/s, peak "
          f"{tr['peak_memory_gb']:.2f} GB", flush=True)
    return out


def _mn_entries(mn, flash_entries):
    """Phase 21's numbers in the kernels line: Moonlight's attention (16
    heads of 128, G = 1) under the two flash kernels, with their launches
    a training step, a fused prefill and a decode step."""
    launches = mn["train"]["launches_per_step"]
    cell = mn["flash_rows"][0]
    for entry, pas, errs in zip(flash_entries, ("fwd", "bwd"),
                                (("o", "lse"), ("dq", "dk", "dv"))):
        entry["moonlight"] = dict(
            launches_per_train_step=launches[entry["name"]],
            max_abs_err=max(r["max_abs_err"][e] for r in mn["flash_rows"]
                            for e in errs),
            **{k: cell.get(f"{pas}_{k}", cell.get(k)) for k in (
                "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_share", "tflops")})
    flash_entries[0]["moonlight"].update(
        launches_per_prefill=mn["serve"]["prefill_launches"]["flash_fwd"],
        launches_in_decode=mn["serve"]["decode_launches"]["flash_fwd"])


def _ds_flash_rows(torch, fa, ref, cfg):
    """Phase 22 (a): ``flash_fwd`` and ``flash_bwd`` at head_dim 192 as
    DeepSeek-V3's MLA runs them in its training cell (DS_BATCH x DS_SEQ,
    128 heads of their own (G = 1), q and k of nope + rope = 192 columns,
    v of 128 padded with zeros to 192, bf16, causal), timed beside SDPA on
    the same q, k and padded v and beside the bound of the useful work
    (v at 128); then in fp32 at DS_FA_F32 with the padded v and with v of
    192 real columns; each against its plain version by
    ``flash_kernel_checks``' rule."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(221)
    a, H = cfg.mla, cfg.n_heads
    hd, vd = a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
    rows = []
    _flash_check(torch, fa, ref, gen, rows,
                 f"deepseek B={DS_BATCH} T={DS_SEQ} H={H} KV={H} hd={hd} "
                 f"v={vd} bf16 causal", DS_BATCH, DS_SEQ, H, 1,
                 torch.bfloat16, True, timed=True, hd=hd, vd=vd)
    B, T, kv, G = DS_FA_F32
    for v in (vd, hd):
        _flash_check(torch, fa, ref, gen, rows,
                     f"deepseek B={B} T={T} H={kv * G} KV={kv} hd={hd} "
                     f"v={v} fp32 causal", B, T, kv, G, torch.float32, True,
                     hd=hd, vd=v)
    return rows


def _ds_absorb(torch, serve, moe, cfg, model, prompt, counters):
    """Phase 22 (b), last part: the absorbed decode
    (``make_serve_step(cfg, absorb=True)``) against the plain decode on
    the same cache and tokens: at each of the prompt's first
    DS_ABSORB_STEPS positions the plain step runs on the cache, recording
    its expert selection, and the absorbed step on a copy of the cache
    taken just before, replaying that selection; its logits within
    ``serve.prefill_tol`` of the plain step's largest, no kernel
    launched; both steps' host-clock times (to a synchronize)."""
    plain = serve.make_serve_step(cfg)
    absorbed = serve.make_serve_step(cfg, absorb=True)
    B, V = prompt.shape[0], cfg.vocab_size
    cache = serve.make_cache(cfg, B, DS_ABSORB_STEPS,
                             dtype=serve.lm_cache_dtype(cfg), device=DEVICE)
    tol = serve.prefill_tol(cfg, next(model.parameters()).dtype)
    log = moe.RoutingLog()
    gaps, times, launched = [], {"plain": [], "absorbed": []}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t)
        return out

    try:
        for t in range(DS_ABSORB_STEPS):
            tok = prompt[:, t:t + 1]
            other = {k: {n: c.clone() for n, c in v.items()}
                     for k, v in cache.items()}
            model.routing = log
            _, cache, want = timed("plain",
                                   lambda: plain(model, cache, tok, t))
            model.routing = moe.RoutingLog(replay=log)
            (_, _, got), launched = _counted(counters, lambda: timed(
                "absorbed", lambda: absorbed(model, other, tok, t)))
            if any(launched.values()):
                raise AssertionError(f"deepseek: an absorbed decode step "
                                     f"launched {launched}")
            want, got = want[..., :V].float(), got[..., :V].float()
            gaps.append(((got - want).abs().max() / want.abs().max()).item())
            if not torch.isfinite(got).all():
                raise AssertionError("deepseek: non-finite absorbed logits")
    finally:
        model.routing = None
    out = dict(steps=DS_ABSORB_STEPS, batch=B, max_gap=max(gaps), tol=tol,
               gap_per_step=gaps,
               plain_step_p50_ms=float(sorted(times["plain"])[
                   len(times["plain"]) // 2] * 1e3),
               absorbed_step_p50_ms=float(sorted(times["absorbed"])[
                   len(times["absorbed"]) // 2] * 1e3))
    print("deepseek-absorb " + json.dumps(out), flush=True)
    if not max(gaps) <= tol:
        raise AssertionError(f"deepseek: the absorbed decode is "
                             f"{max(gaps)} of the largest logit from the "
                             f"plain one, tol {tol}")
    return out


def _ds_train_cfg(configs):
    """DS_TRAIN_ARCH, registered: DeepSeek-V3 at every width cut to
    DS_TRAIN_LAYERS layers (1 dense, 1 MoE) of DS_TRAIN_EXPERTS routed
    experts, the streamed cross-entropy over DS_XENT_CHUNK positions."""
    import dataclasses
    full = configs.get(DS_ARCH)
    return configs.register(dataclasses.replace(
        full, name=DS_TRAIN_ARCH, n_layers=DS_TRAIN_LAYERS,
        moe=dataclasses.replace(full.moe, n_experts=DS_TRAIN_EXPERTS,
                                first_dense_layers=1),
        xent_chunk=DS_XENT_CHUNK))


def deepseek_check(torch, np, configs, init_model, serve, train, synthetic,
                   losses, ref, conv1d_brgemm, fa):
    """Phase 22: DeepSeek-V3's MLA on the card (see DS_*): the flash
    kernels at head_dim 192 (``_ds_flash_rows``); the 4-layer cut at every
    published width built once (bf16, flash) and served
    (``_moe_serve``), its absorbed decode held to the plain one
    (``_ds_absorb``); then the 2-layer, 16-expert cut trained through the
    launcher (2 L + L flash launches a step: forward, remat recompute,
    backward) and traced, and its fp32 copy's whole gradient against the
    plain attention (``_moe_grad``)."""
    import dataclasses

    from repro_torch.models import moe

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    full = configs.get(DS_ARCH)
    cfg = dataclasses.replace(configs.register(dataclasses.replace(
        full, name=DS_SERVE_ARCH, n_layers=DS_SERVE_LAYERS)),
        attn_impl="flash")
    out = dict(flash_rows=_ds_flash_rows(torch, fa, ref, cfg))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = _lm_model(torch, cfg, init_model, seed=221)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["params"] = sum(p.numel() for p in model.parameters())
    print(f"deepseek: {out['params']} parameters drawn and moved to the "
          f"card in {out['init_s']:.1f} s", flush=True)
    out["serve"], prompt = _moe_serve(torch, serve, "deepseek",
                                      DS_SERVE_ARCH, cfg, model, counters,
                                      DS_SERVE_BATCH)
    out["absorb"] = _ds_absorb(torch, serve, moe, cfg, model, prompt,
                               counters)
    del model, prompt
    torch.cuda.empty_cache()
    tcfg = _ds_train_cfg(configs)
    L = tcfg.n_layers
    per_step = (0, 0, 0, 0, 2 * L, L)
    argv = ["--arch", DS_TRAIN_ARCH, "--attn-impl", "flash", "--batch",
            str(DS_BATCH), "--seq", str(DS_SEQ)]
    out["train"] = _train_check(np, train, "deepseek",
                                argv + ["--steps", str(DS_STEPS)], DS_STEPS,
                                counters, per_step, LM_MEMORY_LIMIT_GB)
    out["breakdown"] = _train_breakdown(
        torch, train, "deepseek",
        argv + ["--steps", str(BREAKDOWN_STEPS)], BREAKDOWN_STEPS,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_"))
    torch.cuda.empty_cache()
    out["grad"] = _moe_grad(torch, losses, synthetic, init_model, moe,
                            "deepseek", tcfg, counters, per_step,
                            DS_GRAD_BATCH, DS_GRAD_SEQ, 223, 32)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    s, ab, tr, fl = (out["serve"], out["absorb"], out["train"],
                     out["flash_rows"][0])
    print(f"deepseek: phase 22 in {out['seconds']:.1f} s (the "
          f"{cfg.n_layers}-layer model drawn in {out['init_s']:.1f} s); "
          f"flash hd 192 (v 128) G=1 fwd {fl['fwd_kernel_ms']:.3f} ms "
          f"(SDPA {fl['fwd_library_ms']:.3f}, bound "
          f"{fl['fwd_bound_ms']:.3f}), bwd {fl['bwd_kernel_ms']:.3f} ms "
          f"(SDPA {fl['bwd_library_ms']:.3f}, bound "
          f"{fl['bwd_bound_ms']:.3f}); serving: decode p50 "
          f"{s['step_p50_ms']:.3f} ms, p99 {s['step_p99_ms']:.3f} ms, "
          f"{s['tokens_per_s']:.1f} tokens/s, {s['syncs_per_decode_step']} "
          f"syncs a step, fused prefill {s['prefill_call_ms']:.1f} ms, peak "
          f"{s['peak_memory_gb']:.2f} GB, bound {s['bound_ms']:.4f} ms "
          f"(touched experts {s['touched_bound_ms']:.4f}); absorbed decode "
          f"{ab['max_gap']:.2e} of the largest logit from the plain one "
          f"(tol {ab['tol']:.2e}), step p50 {ab['absorbed_step_p50_ms']:.1f}"
          f" ms against {ab['plain_step_p50_ms']:.1f}; training {L} "
          f"layers of {DS_TRAIN_EXPERTS} experts: step p50 "
          f"{tr['step_p50_ms']:.1f} ms, {tr['tokens_per_s']:.0f} tokens/s, "
          f"{tr['model_tflops_per_s']:.1f} TFLOP/s, peak "
          f"{tr['peak_memory_gb']:.2f} GB", flush=True)
    return out


def _ds_entries(ds, flash_entries):
    """Phase 22's numbers in the kernels line: DeepSeek-V3's MLA attention
    (128 heads, G = 1, head_dim 192, v 128 padded) under the two flash
    kernels, with their launches a training step, a fused prefill and a
    decode step."""
    launches = ds["train"]["launches_per_step"]
    cell = ds["flash_rows"][0]
    for entry, pas, errs in zip(flash_entries, ("fwd", "bwd"),
                                (("o", "lse"), ("dq", "dk", "dv"))):
        entry["deepseek_v3"] = dict(
            launches_per_train_step=launches[entry["name"]],
            max_abs_err=max(r["max_abs_err"][e] for r in ds["flash_rows"]
                            for e in errs),
            **{k: cell.get(f"{pas}_{k}", cell.get(k)) for k in (
                "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_share", "tflops")})
    flash_entries[0]["deepseek_v3"].update(
        launches_per_prefill=ds["serve"]["prefill_launches"]["flash_fwd"],
        launches_in_decode=ds["serve"]["decode_launches"]["flash_fwd"])


def _vl_flash_rows(torch, fa, ref, cfg):
    """Phase 23 (a): ``flash_fwd`` and ``flash_bwd`` at InternVL2-2B's
    attention in its training cell (VL_BATCH x VL_SEQ, 16 heads over 8 KV
    heads of 128, G = 2, bf16, causal), and at its image prefill's shape
    (VL_SERVE_BATCH x (256 + LM_PROMPT), ragged against the tile; the
    forward timed), timed beside SDPA and the bound; then in fp32 at
    VL_FA_F32; each against its plain version by ``flash_kernel_checks``'
    rule."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(231)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T_pre = cfg.n_image_tokens + LM_PROMPT
    rows = []
    _flash_check(torch, fa, ref, gen, rows,
                 f"internvl2 B={VL_BATCH} T={VL_SEQ} H={H} KV={KV} hd={hd} "
                 "bf16 causal", VL_BATCH, VL_SEQ, KV, H // KV,
                 torch.bfloat16, True, timed=True, hd=hd)
    _flash_check(torch, fa, ref, gen, rows,
                 f"internvl2 prefill B={VL_SERVE_BATCH} T={T_pre} H={H} "
                 f"KV={KV} hd={hd} bf16 causal", VL_SERVE_BATCH, T_pre, KV,
                 H // KV, torch.bfloat16, True, timed=("fwd",), hd=hd)
    B, T, kv, G = VL_FA_F32
    _flash_check(torch, fa, ref, gen, rows,
                 f"internvl2 B={B} T={T} H={kv * G} KV={kv} hd={hd} fp32 "
                 "causal", B, T, kv, G, torch.float32, True, hd=hd)
    return rows


def _vl_image_prefill(torch, serve, cfg, model, prompt, counters, seed):
    """Phase 23 (b): the fused prefill of ``prompt`` behind
    ``cfg.n_image_tokens`` image embeddings (``serve.image_prefill``:
    ``vlm_batch``'s draw from ``seed``, finite logits) through flash,
    counted (one ``flash_fwd`` a layer, nothing else), against the same prefill through the plain attention
    (``model.cfg`` switched to ``attn_impl="chunked"``): the last logits
    within ``serve.prefill_tol`` of the plain ones' largest, the greedy
    tokens equal wherever the plain top-2 margin exceeds twice the
    tolerance; the flash prefill's call time."""
    import dataclasses
    B, T = prompt.shape
    res, launched = _counted(counters, lambda: serve.image_prefill(
        model, cfg, prompt, seed))
    got, batch = res["image_logits"], {"tokens": prompt,
                                       "patches": res["patches"]}
    step = serve.make_prefill_step(cfg)
    want_launches = {**{k: 0 for k in launched}, "flash_fwd": cfg.n_layers}
    if launched != want_launches:
        raise AssertionError(f"internvl2: an image prefill launched "
                             f"{launched}; expected {want_launches}")
    try:
        model.cfg = dataclasses.replace(cfg, attn_impl="chunked")
        _, want = step(model, batch)
    finally:
        model.cfg = cfg
    V = cfg.vocab_size
    got, want = got[:, -1, :V].float(), want[:, -1, :V].float()
    scale = want.abs().max()
    rel = serve.prefill_tol(cfg, next(model.parameters()).dtype)
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * rel * scale
    same = got.argmax(-1) == want.argmax(-1)
    out = dict(batch=B, image_tokens=cfg.n_image_tokens, text_tokens=T,
               dtype=cfg.dtype,
               gap=((got - want).abs().max() / scale).item(), tol=rel,
               tokens_equal=bool((same | ~clear).all()),
               rows_with_clear_margin=int(clear.sum()),
               finite=bool(torch.isfinite(got).all()), launches=launched)
    if not (out["finite"] and out["gap"] <= rel and out["tokens_equal"]):
        raise AssertionError(f"internvl2: the image prefill through flash "
                             f"against the plain attention: {out}")
    if cfg.dtype == "bfloat16":
        out["call_ms"] = _call_ms(lambda: step(model, batch), reps=5)
    return out


def _vl_serve(torch, serve, init_model, cfg, model, counters):
    """Phase 23 (b): ``_serve_lm_cell`` (``serve_lm``, the text prefill
    against the decode, the traces, the decode's bound), the image
    prefill (``_vl_image_prefill``), then a LM_FP32_LAYERS-layer fp32 copy
    held both ways, TF32 off."""
    import dataclasses
    out = _serve_lm_cell(torch, serve, counters, VL_ARCH, cfg, model,
                         VL_SERVE_BATCH)
    want = {**{k: 0 for k in out["prefill_launches"]},
            "flash_fwd": cfg.n_layers}
    if out["prefill_launches"] != want:
        raise AssertionError(f"internvl2: a text prefill launched "
                             f"{out['prefill_launches']}; expected {want}")
    gen = torch.Generator().manual_seed(233)
    prompt = torch.randint(0, cfg.vocab_size, (VL_SERVE_BATCH, LM_PROMPT),
                           generator=gen, dtype=torch.int32).to(DEVICE)
    out["image_prefill"] = _vl_image_prefill(torch, serve, cfg, model,
                                             prompt, counters, 234)
    print("internvl2-image-prefill " + json.dumps(out["image_prefill"]),
          flush=True)
    out["fp32_text"] = _fp32_prefill_check(torch, serve, init_model, cfg,
                                           VL_ARCH, 235, counters)
    c = dataclasses.replace(cfg, n_layers=LM_FP32_LAYERS, dtype="float32")
    small = _lm_model(torch, c, init_model, 236)
    out["fp32_image"] = _vl_image_prefill(torch, serve, c, small,
                                          prompt[:LM_FP32_BATCH], counters,
                                          237)
    print("internvl2-fp32-image-prefill " + json.dumps(out["fp32_image"]),
          flush=True)
    del small
    torch.cuda.empty_cache()
    return out


def _vl_grad(torch, losses, synthetic, init_model, cfg, counters):
    """Phase 23 (d): an fp32 copy cut to LM_FP32_LAYERS layers at every
    width: the text loss and every gradient at VL_GRAD_BATCH x VL_GRAD_SEQ
    (256 image embeddings, then the text) through flash against the plain
    attention, TF32 off (phase 11's rule)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gcfg = dataclasses.replace(cfg, n_layers=LM_FP32_LAYERS, dtype="float32",
                               attn_impl="flash")
    model = _lm_model(torch, gcfg, init_model, seed=238)
    b = synthetic.make_batch(gcfg, VL_GRAD_BATCH, VL_GRAD_SEQ, seed=239)
    batch = {k: torch.as_tensor(v).to(DEVICE) for k, v in b.items()}
    n_img = gcfg.n_image_tokens

    def run(attn_impl):
        def logits(tokens):
            model.cfg = dataclasses.replace(gcfg, attn_impl=attn_impl)
            return model(tokens, extra_embeds=batch["patches"])[:, n_img:]
        return logits

    L = gcfg.n_layers
    out = _model_grad_check(
        torch, losses, "internvl2", gcfg, model, batch, run("flash"),
        run("chunked"), counters[4:], (2 * L, L),
        "forward and remat recompute; backward", 12)
    out.update(image_tokens=n_img, text_tokens=VL_GRAD_SEQ - n_img)
    del model, batch
    torch.cuda.empty_cache()
    return out


def _vl_dots(torch, np, configs, train, init_model, synthetic, losses, cfg,
             counters):
    """Phase 23 (e): ``remat_policy="dots"`` against "nothing" at full
    depth: the launcher VL_DOTS_STEPS steps each from the same seed at
    VL_DOTS_BATCH x VL_SEQ (losses and gradient norms bitwise equal, the
    same flash launches: the kernels run in the recompute under both), then
    one batch's loss and every gradient under each policy on one model,
    bitwise equal; each policy's peak memory and gradient time (host clock
    to a synchronize, the median of 3 after one warm-up), the device
    memory it takes above what was held before it, the host's time to
    enqueue the forward alone and its time to the forward's end, and one
    traced gradient's device busy time and matrix products' time
    (PRODUCT_KERNELS): "dots" runs fewer products, and its selective
    checkpoint handles every op of the forward on the host."""
    import dataclasses

    from repro_torch.train.data_parallel import param_grads

    configs.register(dataclasses.replace(configs.get(VL_ARCH),
                                         name=VL_DOTS_ARCH,
                                         remat_policy="dots"))
    L = cfg.n_layers
    runs = {}
    for policy, arch in (("nothing", VL_ARCH), ("dots", VL_DOTS_ARCH)):
        torch.cuda.empty_cache()
        argv = ["--arch", arch, "--attn-impl", "flash", "--batch",
                str(VL_DOTS_BATCH), "--seq", str(VL_SEQ), "--steps",
                str(VL_DOTS_STEPS)]
        runs[policy] = _train_check(np, train, f"internvl2-{policy}", argv,
                                    VL_DOTS_STEPS, counters,
                                    (0, 0, 0, 0, 2 * L, L),
                                    LM_MEMORY_LIMIT_GB)
    a, b = runs["nothing"], runs["dots"]
    if a["losses"] != b["losses"] or a["grad_norms"] != b["grad_norms"]:
        raise AssertionError(f"internvl2: 'dots' losses {b['losses']} and "
                             f"norms {b['grad_norms']} against 'nothing' "
                             f"{a['losses']}, {a['grad_norms']}")
    torch.cuda.empty_cache()
    model = _lm_model(torch, dataclasses.replace(cfg, attn_impl="flash"),
                      init_model, seed=241)
    names, params = zip(*model.named_parameters())
    nb = synthetic.make_batch(cfg, VL_DOTS_BATCH, VL_SEQ, seed=242)
    batch = {k: torch.as_tensor(v).to(DEVICE) for k, v in nb.items()}
    grads, stats = {}, {}
    for policy in ("nothing", "dots"):
        pcfg = dataclasses.replace(cfg, attn_impl="flash",
                                   remat_policy=policy)
        loss_fn = losses.make_loss_fn(pcfg)
        model.cfg = pcfg

        def step():
            loss, _ = loss_fn(model, batch)
            return loss.detach(), param_grads(loss, params)

        times, out = [], None
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()  # the model, earlier gradients
        torch.cuda.reset_peak_memory_stats()
        for _ in range(4):
            out = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        grads[policy] = out
        peak = torch.cuda.max_memory_allocated() - held
        del out
        # the forward alone: the host's time to enqueue it, and to its end
        t = time.perf_counter()
        loss, _ = loss_fn(model, batch)
        enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        fwd = time.perf_counter() - t
        del loss
        _, kernels, _ = _trace(torch, lambda: step() and None, (), 1)
        stats[policy] = dict(
            grad_peak_over_held_gb=peak / 1e9,
            grad_p50_ms=float(np.median(times[1:]) * 1e3),
            forward_enqueue_ms=enqueue * 1e3, forward_ms=fwd * 1e3,
            device_busy_ms=sum(k["ms_per_step"] for k in kernels),
            products_ms=sum(k["ms_per_step"] for k in kernels if any(
                n in k["name"] for n in PRODUCT_KERNELS)),
            kernels=sum(k["calls"] for k in kernels),
            launcher_step_p50_ms=runs[policy]["step_p50_ms"],
            peak_memory_gb=runs[policy]["peak_memory_gb"])
    model.cfg = cfg
    (l0, g0), (l1, g1) = grads["nothing"], grads["dots"]
    differ = [n for n, x, y in zip(names, g0, g1) if not torch.equal(x, y)]
    if not torch.equal(l0, l1) or differ:
        raise AssertionError(f"internvl2: 'dots' against 'nothing': loss "
                             f"{l1.item()} vs {l0.item()}, gradients that "
                             f"differ {differ}")
    out = dict(batch=VL_DOTS_BATCH, seq=VL_SEQ, layers=L,
               launcher_losses=a["losses"], loss=l0.item(),
               n_grads=len(names), bitwise=True, **{
                   p: stats[p] for p in stats},
               saved_product_gb=(2 * VL_DOTS_BATCH * VL_SEQ * L * (
                   2 * cfg.d_model + 2 * cfg.n_kv_heads * cfg.head_dim
                   + 2 * cfg.d_ff + cfg.d_model)) / 1e9)
    print("internvl2-dots " + json.dumps(out), flush=True)
    del model, batch, grads
    torch.cuda.empty_cache()
    return out


def vlm_check(torch, np, configs, init_model, serve, train, synthetic,
              losses, ref, conv1d_brgemm, fa):
    """Phase 23: InternVL2-2B on the card (see VL_*): the flash kernels at
    its shapes (``_vl_flash_rows``), the full model built once (bf16,
    flash) and served (``_vl_serve``), trained through the launcher (2 L
    + L flash launches a step: forward, remat recompute, backward) and
    traced, its fp32 copy's whole gradient against the plain attention
    (``_vl_grad``), and the "dots" remat policy against "nothing"
    (``_vl_dots``)."""
    import dataclasses

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    cfg = dataclasses.replace(configs.get(VL_ARCH), attn_impl="flash")
    out = dict(flash_rows=_vl_flash_rows(torch, fa, ref, cfg))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = _lm_model(torch, cfg, init_model, seed=231)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["params"] = sum(p.numel() for p in model.parameters())
    print(f"internvl2: {out['params']} parameters drawn and moved to the "
          f"card in {out['init_s']:.1f} s", flush=True)
    out["serve"] = _vl_serve(torch, serve, init_model, cfg, model, counters)
    del model
    torch.cuda.empty_cache()
    L = cfg.n_layers
    per_step = (0, 0, 0, 0, 2 * L, L)
    argv = ["--arch", VL_ARCH, "--attn-impl", "flash", "--batch",
            str(VL_BATCH), "--seq", str(VL_SEQ)]
    out["train"] = _train_check(np, train, "internvl2",
                                argv + ["--steps", str(VL_STEPS)], VL_STEPS,
                                counters, per_step, LM_MEMORY_LIMIT_GB)
    out["breakdown"] = _train_breakdown(
        torch, train, "internvl2",
        argv + ["--steps", str(BREAKDOWN_STEPS)], BREAKDOWN_STEPS,
        ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_"))
    torch.cuda.empty_cache()
    out["grad"] = _vl_grad(torch, losses, synthetic, init_model, cfg,
                           counters)
    out["dots"] = _vl_dots(torch, np, configs, train, init_model, synthetic,
                           losses, cfg, counters)
    out["seconds"] = time.perf_counter() - t0
    s, tr, fl, d = (out["serve"], out["train"], out["flash_rows"][0],
                    out["dots"])
    ip = s["image_prefill"]
    print(f"internvl2: phase 23 in {out['seconds']:.1f} s (the "
          f"{cfg.n_layers}-layer model drawn in {out['init_s']:.1f} s); "
          f"flash hd {cfg.head_dim} G=2 fwd {fl['fwd_kernel_ms']:.3f} ms "
          f"(SDPA {fl['fwd_library_ms']:.3f}, bound "
          f"{fl['fwd_bound_ms']:.3f}), bwd {fl['bwd_kernel_ms']:.3f} ms "
          f"(SDPA {fl['bwd_library_ms']:.3f}, bound "
          f"{fl['bwd_bound_ms']:.3f}); serving: decode p50 "
          f"{s['step_p50_ms']:.3f} ms, p99 {s['step_p99_ms']:.3f} ms, "
          f"{s['tokens_per_s']:.1f} tokens/s, bound {s['bound_ms']:.4f} ms, "
          f"decode busy {s['decode_device_busy_share']:.3f}, text prefill "
          f"gap {s['prefill_vs_decode']['gap']:.2e}, image prefill gap "
          f"{ip['gap']:.2e} (tol {ip['tol']:.2e}), "
          f"{ip['call_ms']:.1f} ms; training: step p50 "
          f"{tr['step_p50_ms']:.1f} ms, {tr['tokens_per_s']:.0f} tokens/s, "
          f"{tr['model_tflops_per_s']:.1f} TFLOP/s, peak "
          f"{tr['peak_memory_gb']:.2f} GB; dots at batch {d['batch']}: "
          f"peak {d['dots']['peak_memory_gb']:.2f} GB against "
          f"{d['nothing']['peak_memory_gb']:.2f}, gradient "
          f"{d['dots']['grad_p50_ms']:.1f} ms against "
          f"{d['nothing']['grad_p50_ms']:.1f} (device busy "
          f"{d['dots']['device_busy_ms']:.1f} against "
          f"{d['nothing']['device_busy_ms']:.1f}, forward enqueued in "
          f"{d['dots']['forward_enqueue_ms']:.1f} against "
          f"{d['nothing']['forward_enqueue_ms']:.1f}), bitwise", flush=True)
    return out


def _vl_entries(vl, flash_entries):
    """Phase 23's numbers in the kernels line: InternVL2-2B's attention (16
    over 8 heads of 128, G = 2) under the two flash kernels, with their
    launches a training step, a fused prefill (text, and behind the image)
    and a decode step, and the image prefill's forward row."""
    launches = vl["train"]["launches_per_step"]
    cell, pre = vl["flash_rows"][0], vl["flash_rows"][1]
    keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_share", "tflops")
    for entry, pas, errs in zip(flash_entries, ("fwd", "bwd"),
                                (("o", "lse"), ("dq", "dk", "dv"))):
        entry["internvl2"] = dict(
            launches_per_train_step=launches[entry["name"]],
            max_abs_err=max(r["max_abs_err"][e] for r in vl["flash_rows"]
                            for e in errs),
            **{k: cell.get(f"{pas}_{k}", cell.get(k)) for k in keys})
    serve_ = vl["serve"]
    flash_entries[0]["internvl2"].update(
        launches_per_prefill=serve_["prefill_launches"]["flash_fwd"],
        launches_per_image_prefill=serve_["image_prefill"]["launches"][
            "flash_fwd"],
        launches_in_decode=serve_["decode_launches"]["flash_fwd"],
        image_prefill={k: pre.get(f"fwd_{k}", pre.get(k)) for k in keys})


def _served(torch, serve, counters, cfg, model, argv, routing=None):
    """``serve.serve_lm`` from ``argv`` on ``model`` (one process's, on
    the card; or a tensor-parallel rank's whole model on the host, which
    the launcher narrows to its blocks), this process's peak memory (the
    most the call allocated, plus ``model``'s parameters where they lie
    on the card; what earlier work left allocated is not counted), and
    the kernels' launches split between an encoder-decoder's
    ``fill_cross_cache``, the fused prefill (the one under ``--smoke``,
    ``serve.prefill_gap``) and the rest (the decode steps)."""
    marks = {}
    real = serve.prefill_gap, serve.fill_cross_cache

    def marked(key, fn):
        def run(*a, **k):
            before = {c.__name__: c.launches for c in counters}
            t = time.perf_counter()
            marks[key + "_result"] = fn(*a, **k)
            marks[key + "_s"] = time.perf_counter() - t
            marks[key] = {c.__name__: c.launches - before[c.__name__]
                          for c in counters}
            return marks[key + "_result"]
        return run

    serve.prefill_gap = marked("prefill", real[0])
    serve.fill_cross_cache = marked("fill", real[1])
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    on_card = sum(p.numel() * p.element_size() for p in model.parameters()
                  if p.is_cuda)
    torch.cuda.reset_peak_memory_stats()
    try:
        stats, launched = _counted(counters, lambda: serve.serve_lm(
            serve.parse_args(argv), cfg, model, routing=routing))
    finally:
        serve.prefill_gap, serve.fill_cross_cache = real
    prefill = marks.get("prefill", {k: 0 for k in launched})
    fill = marks.get("fill", {k: 0 for k in launched})
    out = dict(step_p50_ms=stats["step_p50_ms"],
               step_p99_ms=stats["step_p99_ms"],
               tokens_per_s=stats["tokens_per_s"],
               sequential_prefill_s=stats["prefill_s"],
               peak_memory_gb=(torch.cuda.max_memory_allocated() - held
                               + on_card) / 1e9,
               tokens=stats["tokens"],
               prompt_logits=stats["prompt_logits"].float().cpu(),
               prompt=stats["prompt"], prefill_launches=prefill,
               fill_launches=fill,
               decode_launches={k: n - prefill[k] - fill[k]
                                for k, n in launched.items()},
               prefill_gap=marks.get("prefill_result"),
               smoke_prefill_s=marks.get("prefill_s"))
    out.update({k: stats[k] for k in ("weights_bytes", "cache_bytes",
                                      "collectives", "draw_s", "coords",
                                      "encode_s", "row_tokens_per_s")
                if k in stats})
    return out


def _ts_argv(arch, batch, prompt, gen, seed, mp=1, smoke=False):
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen", str(gen), "--seed", str(seed)]
    if mp > 1:
        argv += ["--model-parallel", str(mp), "--dist-backend", "gloo"]
    return argv + (["--smoke"] if smoke else [])


def _ts_cfgs(configs):
    """Phase 24's models (bf16, flash): StarCoder2-3B cut to
    TS_SC2_LAYERS layers, DeepSeek-V3's DS_TRAIN_ARCH, Mamba2-370M,
    Zamba2-7B's ZB_TRAIN_ARCH and Whisper-large-v3 cut to TS_WH_LAYERS
    encoder and TS_WH_LAYERS decoder layers; each one's fp32
    copy (StarCoder2's LM_FP32_LAYERS layers drawn, the others the bf16
    weights cast and cut, ``_as_fp32``)."""
    import dataclasses
    sc2 = dataclasses.replace(configs.get(TS_SC2), n_layers=TS_SC2_LAYERS,
                              attn_impl="flash")
    ds = dataclasses.replace(_ds_train_cfg(configs), attn_impl="flash")
    m2 = configs.get("mamba2-370m")
    zb = dataclasses.replace(configs.get(ZB_ARCH), name=ZB_TRAIN_ARCH,
                             n_layers=ZB_TRAIN_LAYERS, attn_impl="flash")
    wh = dataclasses.replace(configs.get(WH_ARCH), n_layers=TS_WH_LAYERS,
                             n_encoder_layers=TS_WH_LAYERS,
                             attn_impl="flash")
    f32 = functools.partial(dataclasses.replace, dtype="float32")
    return dict(
        starcoder2=sc2, deepseek=ds, mamba2=m2, zamba2=zb, whisper=wh,
        starcoder2_f32=f32(sc2, n_layers=LM_FP32_LAYERS),
        deepseek_f32=f32(ds), mamba2_f32=f32(m2, n_layers=TS_F32_LAYERS),
        zamba2_f32=f32(zb, n_layers=TS_ZB_F32_LAYERS),
        whisper_f32=f32(wh, n_layers=TS_F32_LAYERS,
                        n_encoder_layers=TS_F32_LAYERS))


def _ts_runs():
    """(name, batch, prompt tokens, generated tokens, weights' seed
    (None: the previous run's weights cast to fp32), prompt's seed,
    whether the ranks serve it with ``--smoke``).  The fp32 copies take
    at most TS_PROMPT tokens: DeepSeek-V3's longer prompt is for its bf16
    run's fused prefill only."""
    runs = []
    for i, (name, prompt) in enumerate((
            ("starcoder2", TS_PROMPT), ("deepseek", TS_DS_PROMPT),
            ("mamba2", TS_PROMPT), ("zamba2", TS_PROMPT),
            ("whisper", WH_PROMPT))):
        seed = 241 + 4 * i
        runs += [(name, TS_BATCH, prompt, TS_GEN, seed, seed + 1, True),
                 (f"{name}_f32", LM_FP32_BATCH, min(prompt, TS_PROMPT), 4,
                  seed + 2 if name == "starcoder2" else None, seed + 3,
                  False)]
    return runs


# the layer stacks an fp32 copy cuts, and the config field of each depth
_STACK_DEPTH = {"layers.": "n_layers", "dec_layers.": "n_layers",
                "enc_layers.": "n_encoder_layers"}


def _as_fp32(model, cfg):
    """A copy of ``model`` in fp32 under ``cfg`` (its weights the same
    values: a second seeded draw of an fp32 copy would take as long as the
    first), each layer stack cut to its first layers where ``cfg`` is
    shallower than the model (``_STACK_DEPTH``)."""
    def leaf(key, t):
        for prefix, depth in _STACK_DEPTH.items():
            if key.startswith(prefix):
                t = t[:getattr(cfg, depth)]
        out = t.float()  # one copy: a bf16 leaf's cast, an fp32 one cloned
        return out.clone() if out is t else out

    return type(model)(cfg, {k: leaf(k, t)
                             for k, t in model.state_dict().items()})


def _ts_prompt_only(moe, log, prompt):
    """``log``'s selections at the first ``prompt`` positions, the
    prompt's (teacher-forced, so both sides' inputs agree there)."""
    out = moe.RoutingLog()
    out.entries = {k: v for k, v in log.entries.items() if k[1] < prompt}
    return out


def _host_model(torch, cfg, init_model, seed):
    """``_lm_model``'s weights drawn on the host (the same bits in every
    process), left there."""
    return _lm_model(torch, cfg, init_model, seed, device="cpu")


def _saved_model(torch, cfg, path):
    """The model of ``cfg`` whose state dict the parent drew on the host
    (``_host_model``) and saved at ``path``, read back memory-mapped: the
    ranks do not draw it again (two concurrent draws of Zamba2's 12
    layers alone take about 15 s of host time each)."""
    from repro_torch.models import get_model
    cls = {"ssm": "Mamba2", "hybrid": "Zamba2",
           "encdec": "Whisper"}.get(cfg.family, "Transformer")
    return getattr(get_model(cfg), cls)(cfg, torch.load(
        path, mmap=True, weights_only=True))


def _ts_rank(rank, st):
    """Phase 24, one of TS_MP gloo ranks sharing the card, started while
    the one process serves: the launcher from torchrun's variables (a
    localhost port) with ``--model-parallel TS_MP`` on each of
    ``_ts_runs``' models once the one process's go file for it is written,
    whole on the host (read back from the parent's draw, ``_saved_model``)
    and narrowed to the rank's blocks by the launcher; an MoE run first with
    the one process's expert selection replayed, then free; the flash
    and depthwise inputs' shapes recorded; then DeepSeek-V3's absorbed
    decode against the plain one on the rank's blocks (``_ds_absorb``).
    Results go to a file the parent reads."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import conv1d_brgemm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, serve
    from repro_torch.models import common as cm
    from repro_torch.models import local_model, mla, moe

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 copies
    os.environ.update(WORLD_SIZE=str(TS_MP), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(st["port"]))
    counters = _counters(conv1d_brgemm, fa)
    shapes, dw_shapes = [], []
    for mod in (cm, mla):  # the flash inputs a rank's attention passes
        def recorded(q, *a, real=mod.flash_attention, **k):
            shapes.append(tuple(q.shape))
            return real(q, *a, **k)
        mod.flash_attention = recorded

    def dw_recorded(x, *a, real=ops.depthwise_conv1d, **k):
        dw_shapes.append(tuple(x.shape))  # a rank's Mamba2 conv, (B, C, T)
        return real(x, *a, **k)

    ops.depthwise_conv1d = dw_recorded
    cfgs = _ts_cfgs(configs)
    out = {}
    try:
        mesh.init_data_group("gloo")
        full = None
        for name, batch, prompt, gen, seed, pseed, smoke in _ts_runs():
            cfg = cfgs[name]
            while seed and not os.path.exists(st[f"{name}_go"]):
                time.sleep(0.1)  # the one process's draw and selection
            t0 = time.perf_counter()
            full = (_saved_model(torch, cfg, st[f"{name}_weights"]) if seed
                    else _as_fp32(full, cfg))
            argv = _ts_argv(cfg.name, batch, prompt, gen, pseed, TS_MP,
                            smoke)
            del shapes[:], dw_shapes[:]
            if cfg.moe is None:
                r = _served(torch, serve, counters, cfg, full, argv)
            else:
                one = moe.RoutingLog()
                one.entries = {k: tuple(t.to(DEVICE) for t in v) for k, v in
                               torch.load(st[f"{name}_routing"]).items()}
                r = _served(torch, serve, counters, cfg, full, argv,
                            routing=moe.RoutingLog(replay=one))
                # the free run over the prompt (its inputs the one
                # process's; past it each side feeds its own tokens)
                free = moe.RoutingLog()
                r["free"] = _served(torch, serve, counters, cfg, full,
                                    _ts_argv(cfg.name, batch, prompt, 2,
                                             pseed, TS_MP), routing=free)
                r["free"]["flips"] = moe.compare_routing(
                    _ts_prompt_only(moe, one, prompt),
                    _ts_prompt_only(moe, free, prompt))
                r["free"]["selection"] = {
                    i: free.selection(i)[0].cpu() for i in free.layers()}
                for k in ("prompt", "tokens"):
                    r["free"].pop(k)
            r["flash_shapes"], r["dw_shapes"] = list(shapes), list(dw_shapes)
            r["run_s"] = time.perf_counter() - t0
            if cfg.mla:
                _, group = mesh.init_mesh(1, TS_MP)
                shape, coords = mesh.make_host_mesh(model=TS_MP)
                local = local_model(full, shape, coords, group,
                                    device=DEVICE)
                r["absorb"] = _ts_absorb(torch, serve, moe, cfg, local,
                                         r["prompt"], one, counters)
                del local
            r.pop("prompt")
            out[name] = r
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(st["out"], f"rank{rank}.pt"))


def _ts_absorb(torch, serve, moe, cfg, model, prompt, replay, counters):
    """DeepSeek-V3's plain and absorbed decodes (``make_serve_step(cfg,
    absorb=)``) over the prompt's first TS_ABSORB_STEPS positions, each
    on a cache of its own, both replaying ``replay``'s expert selection
    (the one process's decode, so a rank and the one process route
    alike); the logits of each step on the host, the largest absorbed
    vs plain gap, no kernel launched."""
    B, V = prompt.shape[0], cfg.vocab_size
    out = {}
    try:
        for absorb in (False, True):
            step = serve.make_serve_step(cfg, absorb=absorb)
            cache = serve.make_cache(cfg, B, TS_ABSORB_STEPS,
                                     dtype=serve.lm_cache_dtype(cfg),
                                     device=DEVICE,
                                     mp=getattr(model.tp, "size", 1))
            model.routing = moe.RoutingLog(replay=replay)
            logits = []
            for t in range(TS_ABSORB_STEPS):
                (_, cache, lg), launched = _counted(
                    counters, lambda: step(model, cache, prompt[:, t:t + 1],
                                           t))
                if any(launched.values()):
                    raise AssertionError(f"deepseek: a decode step "
                                         f"(absorb={absorb}) launched "
                                         f"{launched}")
                logits.append(lg[:, -1, :V].float().cpu())
            out["absorbed" if absorb else "plain"] = torch.stack(logits)
    finally:
        model.routing = None
    out["absorbed_vs_plain"] = max(
        _ts_rel(a, p, V) for a, p in zip(out["absorbed"], out["plain"]))
    return out


def _ts_flash_row(torch, fa, ref, label, B, T, KV, G, hd, vd, causal=True):
    """``flash_fwd`` at a tensor-parallel rank's prefill shape (bf16,
    causal unless said; MLA's v padded from ``vd`` to ``hd``) against its
    plain version by phase 10's rule, timed beside SDPA and the bound of
    the useful work (q.k at hd, p.v at vd)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(92)
    q, k, v, _ = _flash_operands(torch, gen, B, T, KV, G, hd,
                                 torch.bfloat16, vd=vd)
    H = KV * G
    bq = min(256, T)  # the model's query tile, min(attn_chunk, T)

    def fl():
        return fa.flash_fwd(q, k, v, causal=causal, bq=bq)

    (o, lse), (o_p, lse_p) = fl(), ref.flash_fwd_ref(q, k, v, causal=causal)
    errs = _flash_errs(f"tp {label} flash", {"o": (o, o_p)}, lse, lse_p,
                       True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q.reshape(B, T, H, hd), k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    nbytes = _flash_fwd_bytes(B * T * H, B * T * KV, hd, vd, 2)
    row = dict(shape=f"tp prefill {label} B={B} T={T} H={H} KV={KV} "
               f"hd={hd} v={vd} bf16 "
               + ("causal" if causal else "non-causal"),
               **_flash_err_fields(errs, True),
               kernel_ms=_device_ms(fl), plain_ms=_device_ms(
                   lambda: ref.flash_fwd_ref(q, k, v, causal=causal)),
               library_ms=_device_ms(sdpa), call_ms=_call_ms(fl),
               library_call_ms=_call_ms(sdpa))
    row["bound_ms"], row["bound_by"] = _attn_bound(
        B, T, H, hd + vd, causal, "bfloat16", nbytes)
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    print("tp-serve-kernel " + json.dumps(row), flush=True)
    return row


def _ts_dw_row(torch, conv1d_brgemm, ref, label, N, C, Q, kind="tp"):
    """``depthwise_conv1d_fwd`` at a tensor-parallel rank's fused-prefill
    shape (N x C channels x Q columns after DW_TAPS - 1 of causal
    padding; bf16 in, bias + silu, fp32 out, as Mamba2's block runs it)
    against its plain version within DW_TOL_F32 of the largest value,
    timed beside ``F.conv1d(groups=C)`` and the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(93)
    bf16, f32, S = torch.bfloat16, torch.float32, DW_TAPS
    Wp = Q + S - 1
    x = torch.randn((N, C, Wp), generator=gen, device=DEVICE).to(bf16)
    w = (S ** -0.5 * torch.randn((S, C), generator=gen, device=DEVICE)
         ).to(bf16)
    b = (0.1 * torch.randn((C,), generator=gen, device=DEVICE)).to(bf16)
    w_c1s = w.t().unsqueeze(1).contiguous()

    def dw():
        return conv1d_brgemm.depthwise_conv1d_fwd(
            x, w, bias=b, activation="silu", out_dtype=f32)

    def plain():
        return ref.depthwise_conv1d_fused_ref(x, w, bias=b,
                                              activation="silu",
                                              out_dtype=f32)

    def library():
        return F.conv1d(x, w_c1s, b, groups=C)

    max_abs, rel = _check_close(f"{kind} {label} dw", dw(), plain(),
                                DW_TOL_F32)
    nbytes = N * C * Wp * 2 + (S * C + C) * 2 + N * C * Q * 4
    row = dict(shape=f"{kind} prefill {label} N={N} C={C} Q={Q} S={S} bf16 "
               "silu fp32-out", max_abs_err=max_abs, max_rel_diff=rel,
               kernel_ms=_device_ms(dw), plain_ms=_device_ms(plain),
               library_ms=_device_ms(library), call_ms=_call_ms(dw),
               library_call_ms=_call_ms(library))
    row["bound_ms"], row["bound_by"] = roofline.bound(
        2.0 * N * C * S * Q, nbytes, "float32")
    _rates(row, nbytes=nbytes)
    print(f"{kind}-serve-kernel " + json.dumps(row), flush=True)
    return row


def _ts_rel(got, want, V):
    """max|got - want| over max|want|, the real vocabulary's columns."""
    got, want = got[..., :V].float(), want[..., :V].float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _ts_check(torch, serve, name, cfg, one, res, tol):
    """A run's ranks against the one process: each rank's decode logits
    at the prompt's last position within ``tol`` of the one process's
    largest logit, the greedy tokens equal in every row whose top-2
    margin exceeds twice that (``serve.prefill_gap``'s rule), the ranks'
    logits, tokens (and an MoE model's free selections) bitwise equal,
    none of the kernels launched in a decode step; the summary."""
    V = cfg.vocab_size
    want = one["prompt_logits"][:, -1, :V].float()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * want.abs().max()
    gaps = []
    for r, o in enumerate(res):
        gaps.append(_ts_rel(o["prompt_logits"][:, -1], want, V))
        same = o["prompt_logits"][:, -1, :V].argmax(-1) == want.argmax(-1)
        if not gaps[-1] <= tol or not bool((same | ~clear).all()):
            raise AssertionError(
                f"tp-serve {name}: rank {r}'s logits {gaps[-1]} of the "
                f"largest from one process's (tol {tol}), tokens equal "
                f"where clear: {bool((same | ~clear).all())}")
        if any(o["decode_launches"].values()):
            raise AssertionError(f"tp-serve {name}: rank {r}'s decode "
                                 f"launched {o['decode_launches']}")
    a, b = res
    if not (torch.equal(a["prompt_logits"], b["prompt_logits"])
            and (a["tokens"] == b["tokens"]).all()):
        raise AssertionError(f"tp-serve {name}: the ranks' logits or "
                             "tokens differ")
    if "free" in a and any(not torch.equal(a["free"]["selection"][i],
                                           b["free"]["selection"][i])
                           for i in a["free"]["selection"]):
        raise AssertionError(f"tp-serve {name}: the ranks' free "
                             "selections differ")
    keys = ("step_p50_ms", "step_p99_ms", "tokens_per_s",
            "sequential_prefill_s", "peak_memory_gb", "weights_bytes",
            "cache_bytes", "collectives", "draw_s", "prefill_launches",
            "fill_launches", "encode_s", "prefill_gap", "run_s")
    out = dict(tol=tol, rank_gaps=gaps, rows_with_clear_margin=int(
        clear.sum()), tokens_equal_one_process=[
        float((o["tokens"] == one["tokens"]).mean()) for o in res],
        one_process={k: v for k, v in one.items() if k in keys},
        ranks=[{k: v for k, v in o.items() if k in keys}
               for o in res])
    if "free" in a:
        out["free"] = [dict(flips=o["free"]["flips"],
                            rank_gap=_ts_rel(o["free"]["prompt_logits"][
                                :, -1], want, V),
                            step_p50_ms=o["free"]["step_p50_ms"])
                       for o in res]
    if "absorb" in a:
        # the absorbed decode on a rank against the one process's, the
        # same selection replayed on both: gated in fp32, where rounding
        # leaves ~1e-6; in bf16 its gap is reported (at 2 layers it sits
        # past prefill_tol's 2-layer allowance, as the absorbed decode's
        # gap to the plain one does on either side, which phase 22 gates
        # at 4 layers); its gap to the plain decode reported on both sides
        V = cfg.vocab_size
        want = one["absorb"]["absorbed"]
        gaps = [max(_ts_rel(g, w, V) for g, w in zip(o["absorb"][
            "absorbed"], want)) for o in res]
        gated = cfg.dtype == "float32"
        if (gated and not max(gaps) <= tol) or not torch.equal(
                a["absorb"]["absorbed"], b["absorb"]["absorbed"]):
            raise AssertionError(
                f"tp-serve {name}: the ranks' absorbed decode {gaps} of the "
                f"largest logit from one process's (tol {tol}), or the "
                "ranks differ")
        out["absorb"] = dict(
            steps=TS_ABSORB_STEPS, rank_gaps=gaps, gated=gated,
            absorbed_vs_plain_one_process=one["absorb"]["absorbed_vs_plain"],
            absorbed_vs_plain_ranks=[o["absorb"]["absorbed_vs_plain"]
                                     for o in res])
    return out


def _ts_want(cfgs):
    """What each bf16 run's ranks must launch: the kernels' launches a
    rank's fused prefill (and ``fill_cross_cache``), and the ``flash_fwd``
    and depthwise input shapes over the whole run, in order (the fill's,
    then the prefill's): a rank's heads and conv channels."""
    from repro_torch.models import mamba2, sharding, zamba2
    sc2, ds, m2, zb, wh = (cfgs[k] for k in ("starcoder2", "deepseek",
                                             "mamba2", "zamba2", "whisper"))
    B, T = TS_BATCH, TS_PROMPT

    def conv(cfg):
        return (B, sharding.ssm_local_width(cfg, "conv", TS_MP), T)

    def heads(cfg, T, hd):
        kv = cfg.n_kv_heads // TS_MP
        return (B, T, kv, cfg.n_heads // cfg.n_kv_heads, hd)

    ds_layers = 2 * ds.n_layers  # the prefill replayed and free
    n_app = zamba2.n_shared_applications(zb)
    L, Le = wh.n_layers, wh.n_encoder_layers
    enc = heads(wh, wh.encoder_width, wh.head_dim)
    assert mamba2.dims(m2)[0] // TS_MP + 2 * m2.ssm.d_state == conv(m2)[1]
    return {
        "starcoder2": dict(prefill={"flash_fwd": sc2.n_layers},
                           flash=[heads(sc2, T, sc2.head_dim)]
                           * sc2.n_layers),
        "deepseek": dict(prefill={"flash_fwd": ds_layers},
                         flash=[(B, TS_DS_PROMPT, ds.n_heads // TS_MP, 1,
                                 ds.mla.qk_nope_head_dim
                                 + ds.mla.qk_rope_head_dim)] * ds_layers),
        "mamba2": dict(prefill={"depthwise_conv1d_fwd": m2.n_layers},
                       dw=[conv(m2)] * m2.n_layers),
        "zamba2": dict(prefill={"depthwise_conv1d_fwd": zb.n_layers,
                                "flash_fwd": n_app},
                       flash=[heads(zb, T, zb.head_dim)] * n_app,
                       dw=[conv(zb)] * zb.n_layers),
        "whisper": dict(fill={"flash_fwd": Le},
                        prefill={"flash_fwd": Le + L},
                        flash=[enc] * (2 * Le)
                        + [heads(wh, WH_PROMPT, wh.head_dim)] * L)}


def _ts_launch_gate(name, counters, want, ranks):
    """Each rank's launches and kernel input shapes against ``want``
    (``_ts_want``'s entry); the entry, for the summary."""
    zero = {c.__name__: 0 for c in counters}
    for r, o in enumerate(ranks):
        for key in ("prefill", "fill"):
            if o[f"{key}_launches"] != {**zero, **want.get(key, {})}:
                raise AssertionError(
                    f"tp-serve {name}: rank {r}'s {key} launched "
                    f"{o[f'{key}_launches']}; expected {want.get(key, {})}")
        for key in ("flash", "dw"):
            if o[f"{key}_shapes"] != want.get(key, []):
                raise AssertionError(
                    f"tp-serve {name}: rank {r}'s {key} inputs "
                    f"{sorted(set(o[f'{key}_shapes']))} "
                    f"({len(o[f'{key}_shapes'])}); expected "
                    f"{sorted(set(want.get(key, [])))} "
                    f"({len(want.get(key, []))})")
    return {k: (v if isinstance(v, dict) else dict(
        shape=v[-1], launches_per_rank_run=len(v))) for k, v in want.items()}


def _ts_one_process(torch, serve, init_model, cfgs, counters, st, one, t0,
                    out, ranks):
    """Phase 24's one process: each of ``_ts_runs``' models served on the
    card into ``one`` (each drawn model drawn on the host and saved where
    ``st`` names, an MoE model's selection saved too), then its go file
    for the waiting ``ranks``, which serve it (and the fp32 copy cast from
    it) while the one process goes on with the next; their results."""
    from repro_torch.models import moe, sharding
    model = None
    for name, batch, prompt, gen, seed, pseed, _ in _ts_runs():
        cfg = cfgs[name]
        t = time.perf_counter()
        if seed:  # drawn once on the host; the ranks read it back
            model = _host_model(torch, cfg, init_model, seed)
            torch.save(model.state_dict(), st[f"{name}_weights"])
            model = model.to(DEVICE)
        else:
            model = _as_fp32(model, cfg)
        draw_s = time.perf_counter() - t
        log = moe.RoutingLog() if cfg.moe else None
        one[name] = _served(torch, serve, counters, cfg, model,
                            _ts_argv(cfg.name, batch, prompt, gen, pseed),
                            routing=log)
        one[name].update(draw_s=draw_s, weights_bytes=sum(
            p.numel() * p.element_size() for p in model.parameters()),
            cache_bytes=serve._nbytes(sharding.tree_leaves(
                serve.make_cache(cfg, batch, prompt + gen,
                                 dtype=serve.lm_cache_dtype(cfg),
                                 device="meta"))))
        if cfg.mla:
            one[name]["absorb"] = _ts_absorb(
                torch, serve, moe, cfg, model, one[name]["prompt"], log,
                counters)
        one[name]["run_s"] = time.perf_counter() - t
        if log is not None:
            torch.save({k: tuple(t.cpu() for t in v)
                        for k, v in log.entries.items()},
                       st[f"{name}_routing"])
        del log
        torch.cuda.empty_cache()
        if seed:  # its ranks may serve it now
            open(st[f"{name}_go"], "w").close()
            out.setdefault("ranks_from", time.perf_counter())
    del model
    torch.cuda.empty_cache()
    out["one_process_s"] = time.perf_counter() - t0
    while not ranks.join():
        pass
    out["ranks_wall_s"] = time.perf_counter() - out.pop("ranks_from")
    return [torch.load(os.path.join(st["out"], f"rank{r}.pt"),
                       weights_only=False) for r in range(TS_MP)]


def tp_serve_check(torch, np, configs, init_model, serve, ref,
                   conv1d_brgemm, fa):
    """Phase 24: tensor-parallel serving (see TS_*).  One process serves
    each of ``_ts_runs``' models on the card (the MoE runs recording
    their expert selection over the whole decode; ``_ts_one_process``)
    while TS_MP gloo ranks start up; then the ranks serve them through
    the launcher with ``--model-parallel`` (``_ts_rank``) and each is
    held to the one process (``_ts_check``);
    the bf16 runs' fused prefills launch ``flash_fwd`` and
    ``depthwise_conv1d_fwd`` on each rank's heads and conv channels
    (``_ts_want``), at the shapes ``_ts_flash_row`` and ``_ts_dw_row``
    time."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    cfgs = _ts_cfgs(configs)
    sc2, ds, zb, wh = (cfgs[k] for k in ("starcoder2", "deepseek", "zamba2",
                                         "whisper"))
    out = dict(card=_card_line(), ranks=TS_MP, backend="gloo")
    want = _ts_want(cfgs)
    out["flash_rows"] = [
        _ts_flash_row(torch, fa, ref, "starcoder2", TS_BATCH, TS_PROMPT,
                      *want["starcoder2"]["flash"][0][2:], sc2.head_dim),
        _ts_flash_row(torch, fa, ref, "deepseek", TS_BATCH, TS_DS_PROMPT,
                      *want["deepseek"]["flash"][0][2:],
                      ds.mla.v_head_dim),
        _ts_flash_row(torch, fa, ref, "zamba2", TS_BATCH, TS_PROMPT,
                      *want["zamba2"]["flash"][0][2:], zb.head_dim),
        _ts_flash_row(torch, fa, ref, "whisper encoder", TS_BATCH,
                      wh.encoder_width, *want["whisper"]["flash"][0][2:],
                      wh.head_dim, causal=False)]
    out["dw_rows"] = [
        _ts_dw_row(torch, conv1d_brgemm, ref, name, TS_BATCH,
                   want[name]["dw"][0][1], TS_PROMPT)
        for name in ("mamba2", "zamba2")]
    one = {}
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 copies
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # the ranks start up while the one process serves, then wait for
        # its draws and selections (files at paths named here)
        st = dict(out=tmp, port=_free_port())
        for name, *_, seed, _, _ in _ts_runs():
            if seed:
                st[f"{name}_weights"] = os.path.join(tmp, f"{name}.pt")
                st[f"{name}_go"] = os.path.join(tmp, f"go_{name}")
            if cfgs[name].moe:
                st[f"{name}_routing"] = os.path.join(tmp,
                                                     f"{name}_routing.pt")
        procs = mp.start_processes(_ts_rank, args=(st,), nprocs=TS_MP,
                                   start_method="spawn", join=False)
        try:
            res = _ts_one_process(torch, serve, init_model, cfgs, counters,
                                  st, one, t0, out, procs)
        finally:  # a failed one process leaves no rank waiting
            for proc in procs.processes:
                if proc.is_alive():
                    proc.terminate()
    for name, *_ in _ts_runs():
        cfg = cfgs[name]
        dtype = getattr(torch, cfg.dtype)
        tol = TS_F32_TOL if dtype == torch.float32 else serve.prefill_tol(
            cfg, dtype)
        ranks = [r[name] for r in res]
        out[name] = _ts_check(torch, serve, name, cfg, one[name], ranks,
                              tol)
        if name in want:
            out[name]["kernels_per_rank"] = _ts_launch_gate(
                name, counters, want[name], ranks)
        print(f"tp-serve-{name} " + json.dumps(out[name], default=str),
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"tp-serve: phase 24 in {out['seconds']:.1f} s ({out['card']}; "
          f"one process {out['one_process_s']:.1f} s, the ranks "
          f"{out['ranks_wall_s']:.1f} s) at mp {TS_MP}:", flush=True)
    for name in want:
        a = out[name]
        c = a["ranks"][0]["collectives"]
        flips = [f["flips"]["total_flips"] for f in a.get("free", ())]
        print(f"tp-serve:   {name}: decode p50 "
              f"{a['ranks'][0]['step_p50_ms']:.2f} ms against one process's "
              f"{a['one_process']['step_p50_ms']:.2f} ({c['sums']:.0f} sums "
              f"and {c['gathers']:.0f} gathers a step, "
              f"{c['seconds'] * 1e3:.2f} ms of host time), logits "
              f"{max(a['rank_gaps']):.2e} of the largest (tol {a['tol']:.2e})"
              f", fp32 copy {max(out[name + '_f32']['rank_gaps']):.2e}"
              + (f", free flips {flips}" if flips else ""), flush=True)
    return out


def _ts_entries(ts, dw_fwd_entry, flash_entries):
    """Phase 24's numbers in the kernels line: ``flash_fwd`` and
    ``depthwise_conv1d_fwd`` on a tensor-parallel rank's heads and conv
    channels in the fused prefill (launches a rank, the shape, its
    row)."""
    keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err")

    def entry(name, kernel, row):
        per = ts[name]["kernels_per_rank"]
        return dict(ranks=ts["ranks"],
                    launches_per_rank_prefill=per["prefill"][kernel],
                    **{k: row[k] for k in keys})

    flash_entries[0]["tp_serve"] = {
        name: entry(name, "flash_fwd", row) for name, row in zip(
            ("starcoder2", "deepseek", "zamba2", "whisper"),
            ts["flash_rows"])}
    flash_entries[0]["tp_serve"]["whisper"][
        "launches_per_rank_fill_cross_cache"] = ts["whisper"][
            "kernels_per_rank"]["fill"]["flash_fwd"]
    dw_fwd_entry["tp_serve"] = {
        name: entry(name, "depthwise_conv1d_fwd", row)
        for name, row in zip(("mamba2", "zamba2"), ts["dw_rows"])}


def _fs_cfgs(configs):
    """Phase 25's models: name -> the launched config (StarCoder2-3B cut
    to FS_SC2_LAYERS layers, registered as FS_SC2_ARCH, with flash;
    Mamba2-370M whole), the launcher's argv, the global batch and
    sequence, and its fp32 copy cut to LM_FP32_LAYERS layers."""
    import dataclasses
    sc2 = configs.register(dataclasses.replace(
        configs.get("starcoder2-3b"), name=FS_SC2_ARCH,
        n_layers=FS_SC2_LAYERS))
    out = {}
    for name, cfg, batch, seq, impl in (
            ("starcoder2", sc2, FS_SC2_BATCH, LM_SEQ, "flash"),
            ("mamba2", configs.get("mamba2-370m"), M2_BATCH, M2_SEQ, None)):
        run = dataclasses.replace(cfg, attn_impl=impl) if impl else cfg
        out[name] = dict(
            cfg=run, batch=batch, seq=seq,
            argv=["--arch", cfg.name, "--steps", str(FS_STEPS), "--batch",
                  str(batch), "--seq", str(seq), "--seed", str(FS_SEED)]
            + (["--attn-impl", impl] if impl else []),
            f32=dataclasses.replace(run, n_layers=LM_FP32_LAYERS,
                                    dtype="float32"))
    return out


def _fs_f32(torch, synthetic, model, cfg):
    """Gate (d): ``model``'s weights (on the host) cast to fp32 and each
    layer stack cut to ``cfg``'s layers, then FS_F32_STEPS steps of
    ``make_train_step`` on FS_F32_BATCH x FS_F32_SEQ batches from FS_SEED,
    TF32 off, in one process (no group) and FSDP over the started data
    group on this rank's share: the losses both ways, and each leaf's
    largest gap between the rank's blocks and the one process's, over the
    one process's largest parameter."""
    import torch.distributed as dist

    from repro_torch.models import fsdp_model
    from repro_torch.train.data_parallel import shard_batch
    from repro_torch.train.train_step import init_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stacks = ("layers.", "dense_layers.")

    def leaf(key, t):
        out = (t[:cfg.n_layers] if key.startswith(stacks) else t).float()
        return out.clone() if out is t else out

    base = type(model)(cfg, {k: leaf(k, t)
                             for k, t in model.state_dict().items()})
    batches = [{k: torch.as_tensor(v).to(DEVICE) for k, v in
                synthetic.make_batch(cfg, FS_F32_BATCH, FS_F32_SEQ,
                                     seed=FS_SEED + 1 + i).items()}
               for i in range(FS_F32_STEPS)]
    runs = []
    for group in (None, dist.group.WORLD):
        state = init_state(fsdp_model(base, group, DEVICE) if group else
                           type(base)(cfg, {k: t.to(DEVICE, copy=True) for
                                            k, t in base.state_dict().items()}))
        step = make_train_step(cfg, group=group, peak_lr=3e-4,
                               warmup_steps=2, total_steps=FS_F32_STEPS)
        losses = []
        for b in batches:
            state, m = step(state, b if group is None else shard_batch(
                b, group))
            losses.append(float(m["loss"]))
        runs.append((losses, state.params))
        del state
    (one_losses, one), (losses, ranks) = runs
    whole = dict(one.named_parameters())
    scale = max(float(p.detach().abs().max()) for p in whole.values())
    return dict(one_losses=one_losses, losses=losses, largest=scale, gaps={
        k: float((p.detach() - ranks.ds.block(k, whole[k].detach())).abs()
                 .max()) / scale for k, p in ranks.named_parameters()})


def _fs_summary(summary, launches):
    """A launcher run's numbers that phase 25 reads."""
    steps = summary["step_s"][1:]  # the first is not timed
    out = dict(losses=summary["losses"], grad_norms=summary["grad_norms"],
               skipped=summary["skipped_steps"], step_s=summary["step_s"],
               step_p50_ms=float(sorted(steps)[len(steps) // 2] * 1e3),
               path=summary["path"], state_bytes=summary["state_bytes"],
               peak_memory_gb=summary.get("peak_memory_gb"),
               launches=launches)
    if "fsdp" in summary:
        out["collectives"] = summary["fsdp"]
    return out


def _fs_first_grads(record):
    """Within it, every gradient function the train step makes records,
    into ``record``, its first call's batch and reduced gradients (copied
    to the host: the first step is not timed, and the card's memory stays
    the run's)."""
    from repro_torch.train import train_step

    real = train_step.make_sharded_grad_fn

    def make(*a, **k):
        fn = real(*a, **k)

        def grad_fn(model, batch, probe=None):
            out = fn(model, batch, probe=probe)
            if not record:
                record.update(batch={n: v.cpu() for n, v in batch.items()},
                              grads=[g.cpu() for g in out[1]],
                              loss=float(out[0][0]))
            return out

        grad_fn.reducer = fn.reducer
        return grad_fn

    train_step.make_sharded_grad_fn = make
    return real


def _fs_rank(rank, st):
    """Phase 25, one of FS_DP gloo ranks sharing the card, its models read
    from the one process's draws (``_saved_model``): for each of
    ``_fs_cfgs``' models (b, c, e, f) the launcher from torchrun's
    variables, its kernels counted, (a) its first step's reduced gradient
    blocks against the whole-parameter data-parallel gradient of the same
    batch on the whole model, (d) its fp32 copy in one process and FSDP
    (``_fs_f32``).  Results go to a file the parent reads."""
    import torch

    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.kernels import conv1d_brgemm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh, train
    from repro_torch.models import sharding
    from repro_torch.train import train_step

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(4)
    os.environ.update(WORLD_SIZE=str(FS_DP), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(st["port"]))
    counters = _counters(conv1d_brgemm, fa)

    def init_model(cfg, *, seed=0, device="cpu"):
        return _saved_model(torch, cfg, st["weights"][repr(cfg), seed]).to(
            device)

    train.init_model = init_model
    out = {}
    try:
        group = mesh.init_data_group("gloo")
        while not os.path.exists(st["ready"]):  # the one process's draws
            time.sleep(0.1)
        for name, c in _fs_cfgs(configs).items():
            cfg, r, first = c["cfg"], {}, {}
            t = time.perf_counter()
            real = _fs_first_grads(first)
            try:
                r["launcher"] = _fs_summary(*_counted(
                    counters, lambda: train.run(
                        c["argv"] + ["--dist-backend", "gloo"])))
            finally:
                train_step.make_sharded_grad_fn = real
            r["launcher_s"] = time.perf_counter() - t
            t = time.perf_counter()
            whole = init_model(cfg, seed=FS_SEED, device=DEVICE)
            ds = sharding.DataShards(group, whole)
            (lw, _), gw = real(cfg, group)(whole, {
                k: v.to(DEVICE) for k, v in first["batch"].items()})
            names = [k for k, _ in whole.named_parameters()]
            r["bitwise"] = dict(
                mismatch=[k for k, a, b in zip(names, gw, first["grads"])
                          if not torch.equal(ds.block(k, a.cpu()), b)],
                losses=(float(lw), first["loss"]))
            r["blocks_bytes"] = sum(
                math.prod(ds.block_shape(k)) * (p.element_size() + 8)
                for k, p in whole.named_parameters())
            del whole, gw, first
            r["bitwise_s"] = time.perf_counter() - t
            t = time.perf_counter()
            r["f32"] = _fs_f32(torch, synthetic, init_model(
                cfg, seed=FS_SEED), c["f32"])
            r["f32_s"] = time.perf_counter() - t
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
            out[name] = r
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(st["out"], f"rank{rank}.pt"))


def _fs_want(cfg):
    """The kernels' launches a rank a step, and the gathers and scatters:
    StarCoder2's flash forward twice a layer (forward, remat recompute)
    and its backward once; Mamba2's depthwise forward three times a layer
    (forward, recompute, bwd-data) and its weight gradient once; a layer's
    gather in the forward and the recompute, its scatter in the backward,
    and the tables' (a tied embedding once, an untied one and the
    unembedding each once) once each way."""
    L = cfg.n_layers
    launches = ({"flash_fwd": 2 * L, "flash_bwd": L} if cfg.family == "dense"
                else {"depthwise_conv1d_fwd": 3 * L,
                      "depthwise_conv1d_bwd_weight": L})
    tables = 1 if cfg.tie_embeddings else 2
    return launches, 2 * L + tables, L + tables


def _fs_gates(torch, name, c, one, ranks, counters):
    """Phase 25's gates (a)-(f) for one model, and its report."""
    cfg = c["cfg"]
    launches, gathers, scatters = _fs_want(cfg)
    zero = {k.__name__: 0 for k in counters}
    want = {**zero, **{k: n * FS_STEPS for k, n in launches.items()}}
    if one["launches"] != want:
        raise AssertionError(f"fsdp {name}: one process launched "
                             f"{one['launches']}; expected {want}")
    if ranks[0]["launcher"]["losses"] != ranks[1]["launcher"]["losses"]:
        raise AssertionError(f"fsdp {name}: the ranks' losses differ")
    base = one["losses"]
    for r, o in enumerate(ranks):
        b, run = o["bitwise"], o["launcher"]
        if b["mismatch"] or b["losses"][0] != b["losses"][1]:  # (a)
            raise AssertionError(
                f"fsdp {name}: rank {r}'s gradient blocks differ from the "
                f"whole-parameter path's at {b['mismatch']} (losses "
                f"{b['losses']})")
        losses = run["losses"]
        if (run["path"] != "fsdp" or run["skipped"]
                or len(losses) != FS_STEPS):
            raise AssertionError(f"fsdp {name}: rank {r}'s run {run}")
        gaps = [abs(a - w) / abs(w) for a, w in zip(losses, base)]
        if gaps[0] > FS_LOSS_RTOL or max(gaps[1:]) > FS_LATER_RTOL:  # (b, c)
            raise AssertionError(
                f"fsdp {name}: losses {losses} against the one process's "
                f"{base} (relative gaps {gaps}; tolerances {FS_LOSS_RTOL} "
                f"first, {FS_LATER_RTOL} later)")
        f32 = max(o["f32"]["gaps"].values())
        if f32 > FS_F32_TOL:  # (d)
            worst = max(o["f32"]["gaps"], key=o["f32"]["gaps"].get)
            raise AssertionError(
                f"fsdp {name}: fp32 copy's {worst} {f32:.3e} of the one "
                f"process's largest parameter from its value after "
                f"{FS_F32_STEPS} steps")
        if run["state_bytes"] != o["blocks_bytes"]:  # (e)
            raise AssertionError(
                f"fsdp {name}: rank {r} holds {run['state_bytes']} bytes "
                f"of parameters and moments; its blocks are "
                f"{o['blocks_bytes']}")
        if run["launches"] != want:  # (f)
            raise AssertionError(f"fsdp {name}: rank {r} launched "
                                 f"{run['launches']}; expected {want}")
        col = run["collectives"]
        if (col["gathers"], col["scatters"]) != (gathers * FS_STEPS,
                                                 scatters * FS_STEPS):
            raise AssertionError(f"fsdp {name}: rank {r}'s launcher ran "
                                 f"{col}; expected {gathers} gathers and "
                                 f"{scatters} scatters a step")
    r0 = ranks[0]["launcher"]
    tokens = c["batch"] * c["seq"]
    return dict(
        one_process=one, ranks=ranks, loss_gaps=[
            abs(a - w) / abs(w) for a, w in zip(r0["losses"], base)],
        f32_max_gap=max(max(o["f32"]["gaps"].values()) for o in ranks),
        step_p50_ms=r0["step_p50_ms"],
        tokens_per_s_rank=tokens / FS_DP / (r0["step_p50_ms"] / 1e3),
        one_tokens_per_s=tokens / (one["step_p50_ms"] / 1e3),
        state_bytes_rank=r0["state_bytes"],
        state_bytes_one=one["state_bytes"],
        state_share=r0["state_bytes"] / one["state_bytes"],
        peak_memory_gb_rank=r0["peak_memory_gb"],
        peak_memory_gb_one=one["peak_memory_gb"],
        gathers_per_step=gathers, scatters_per_step=scatters,
        collective_host_s_per_step=r0["collectives"]["seconds"] / FS_STEPS,
        launches_per_rank_step=launches)


def fsdp_check(torch, configs, train, synthetic, ref, conv1d_brgemm, fa):
    """Phase 25: FSDP training of the language models (see FS_*).  The
    kernels at a rank's shapes against their plain versions (flash at
    StarCoder2's attention on FS_SC2_BATCH / FS_DP sequences, depthwise
    at Mamba2's layer on M2_BATCH / FS_DP); one process trains each model
    through the launcher and saves its draw while FS_DP spawned gloo ranks
    (``_fs_rank``) start up; then the ranks do the same FSDP and are held
    to it (``_fs_gates``)."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    counters = _counters(conv1d_brgemm, fa)
    cfgs = _fs_cfgs(configs)
    out = dict(card=_card_line(), ranks=FS_DP, backend="gloo")
    sc2 = cfgs["starcoder2"]["cfg"]
    B, KV = FS_SC2_BATCH // FS_DP, sc2.n_kv_heads
    G = sc2.n_heads // KV
    rows = []
    _flash_check(torch, fa, ref, torch.Generator(device=DEVICE).manual_seed(
        251), rows, f"fsdp rank B={B} T={LM_SEQ} KV={KV} G={G} bf16 causal",
        B, LM_SEQ, KV, G, torch.bfloat16, True, timed=True, hd=sc2.head_dim)
    out["flash_row"] = rows[0]
    out["dw_rows"] = dw_kernel_checks(
        torch, conv1d_brgemm, ref, model="mamba2 fsdp rank",
        shape=(M2_BATCH // FS_DP, DW_CHANNELS, M2_SEQ), more=False)
    out["kernel_rows_s"] = time.perf_counter() - t0
    one = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # the ranks start up while the one process trains, then wait for
        # its draws (saved state dicts, read back by ``_saved_model``)
        st = dict(out=tmp, port=_free_port(), ready=os.path.join(tmp, "go"),
                  weights={(repr(c["cfg"]), FS_SEED): os.path.join(
                      tmp, f"{name}.pt") for name, c in cfgs.items()})
        ranks = mp.start_processes(_fs_rank, args=(st,), nprocs=FS_DP,
                                   start_method="spawn", join=False)
        try:
            for name, c in cfgs.items():
                torch.cuda.empty_cache()
                one[name] = _fs_summary(*_counted(
                    counters, lambda: train.run(c["argv"])))
                torch.save(train.init_model(c["cfg"], seed=FS_SEED)
                           .state_dict(), st["weights"][repr(c["cfg"]),
                                                        FS_SEED])
                torch.cuda.empty_cache()
            open(st["ready"], "w").close()
            out["one_process_s"] = time.perf_counter() - t0 - out[
                "kernel_rows_s"]
            t = time.perf_counter()
            while not ranks.join():
                pass
            out["ranks_wall_s"] = time.perf_counter() - t
        finally:  # a failed one process leaves no rank waiting
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.terminate()
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(FS_DP)]
    for name, c in cfgs.items():
        out[name] = _fs_gates(torch, name, c, one[name],
                              [r[name] for r in res], counters)
        print(f"fsdp-{name} " + json.dumps(out[name], default=str),
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"fsdp: phase 25 in {out['seconds']:.1f} s ({out['card']}; "
          f"kernel rows {out['kernel_rows_s']:.1f} s, one process "
          f"{out['one_process_s']:.1f} s, the ranks "
          f"{out['ranks_wall_s']:.1f} s) at dp {FS_DP}:", flush=True)
    for name in cfgs:
        a = out[name]
        print(f"fsdp:   {name}: step p50 {a['step_p50_ms']:.1f} ms a rank "
              f"({a['tokens_per_s_rank']:.0f} tokens/s a rank; one process "
              f"{a['one_process']['step_p50_ms']:.1f} ms, "
              f"{a['one_tokens_per_s']:.0f} tokens/s), parameters and "
              f"moments {a['state_bytes_rank'] / 1e9:.3f} GB a rank of "
              f"{a['state_bytes_one'] / 1e9:.3f} GB, peak "
              f"{a['peak_memory_gb_rank']:.2f} GB against "
              f"{a['peak_memory_gb_one']:.2f} GB, {a['gathers_per_step']} "
              f"gathers and {a['scatters_per_step']} scatters a step "
              f"({a['collective_host_s_per_step']:.2f} s of host time), "
              f"loss gaps {['%.2e' % g for g in a['loss_gaps']]}, fp32 "
              f"copy {a['f32_max_gap']:.2e}", flush=True)
    return out


def _fs_entries(fs, dw_fwd_entry, dw_bw_entry, flash_entries):
    """Phase 25's numbers in the kernels line: each kernel's launches a
    rank a FSDP step and its row at a rank's shape."""
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share")
    row = fs["flash_row"]
    for entry, pas in zip(flash_entries, ("fwd", "bwd")):
        entry["fsdp"] = dict(
            ranks=fs["ranks"], shape=row["shape"],
            launches_per_rank_step=fs["starcoder2"][
                "launches_per_rank_step"][entry["name"]],
            **{k: row[f"{pas}_{k}"] for k in keys})
    dw = {r["pass_"]: r for r in fs["dw_rows"] if "kernel_ms" in r}
    per = fs["mamba2"]["launches_per_rank_step"]
    for entry, pas in ((dw_fwd_entry, "fwd"), (dw_bw_entry, "bwd_weight")):
        entry["fsdp"] = dict(
            ranks=fs["ranks"], shape=dw[pas]["shape"],
            launches_per_rank_step=per[entry["name"]],
            **{k: dw[pas][k] for k in keys})


def _dps_cfgs(configs):
    """Phase 26's models: StarCoder2-3B (bf16, flash) cut to
    DPS_SC2_LAYERS layers, Mamba2-370M, and each one's fp32 copy cut to
    LM_FP32_LAYERS layers."""
    import dataclasses
    sc2 = dataclasses.replace(configs.get(TS_SC2), n_layers=DPS_SC2_LAYERS,
                              attn_impl="flash")
    m2 = configs.get("mamba2-370m")
    f32 = functools.partial(dataclasses.replace, dtype="float32",
                            n_layers=LM_FP32_LAYERS)
    return dict(starcoder2=sc2, mamba2=m2, starcoder2_f32=f32(sc2),
                mamba2_f32=f32(m2))


def _dps_runs(layout):
    """(name, prompt tokens, generated tokens, weights' seed (None: the
    previous run's weights cast to fp32), prompt's seed, ``--smoke``) of
    each model a layout serves: StarCoder2-3B on both, Mamba2-370M on (2,
    1)."""
    names = ("starcoder2", "mamba2") if layout == (2, 1) else (
        "starcoder2",)
    runs = []
    for i, name in enumerate(names):
        seed = 271 + 4 * i
        runs += [(name, DPS_PROMPT, DPS_GEN, seed, seed + 1, True),
                 (f"{name}_f32", DPS_F32_PROMPT, DPS_F32_GEN, None,
                  seed + 3, False)]
    return runs


def _dps_argv(cfg, prompt, gen, seed, mp, smoke):
    return (_ts_argv(cfg.name, DPS_BATCH, prompt, gen, seed, smoke=smoke)
            + ["--model-parallel", str(mp), "--dist-backend", "gloo"])


def _dps_rank(rank, st):
    """Phase 26, one of dp x mp gloo ranks sharing the card (``st``: its
    layout, port, the one process's saved draws): the launcher from
    torchrun's variables on each of ``_dps_runs``' models, whole on the
    host and narrowed to the rank's 2-D blocks by the launcher; the flash
    and depthwise inputs' shapes recorded; the bytes of the rank's blocks
    from the leaves' shapes (``_dps_blocks_bytes``).
    Waits for the parent's go file before it serves.  Results go to a
    file the parent reads."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import conv1d_brgemm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, serve
    from repro_torch.models import common as cm
    from repro_torch.models import sharding

    dp, mp = st["layout"]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 copies
    os.environ.update(WORLD_SIZE=str(dp * mp), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(st["port"]))
    counters = _counters(conv1d_brgemm, fa)
    shapes, dw_shapes = [], []

    def recorded(q, *a, real=cm.flash_attention, **k):
        shapes.append(tuple(q.shape))  # a data row's heads (B, T, KV, G, hd)
        return real(q, *a, **k)

    def dw_recorded(x, *a, real=ops.depthwise_conv1d, **k):
        dw_shapes.append(tuple(x.shape))  # a data row's conv (B, C, T)
        return real(x, *a, **k)

    cm.flash_attention, ops.depthwise_conv1d = recorded, dw_recorded
    cfgs = _dps_cfgs(configs)
    out = {}
    try:
        mesh.init_data_group("gloo")
        out["ready_at"] = time.time()
        while not os.path.exists(st["go"]):  # the one process's draws
            time.sleep(0.1)
        full = None
        for name, prompt, gen, seed, pseed, smoke in _dps_runs((dp, mp)):
            cfg = cfgs[name]
            t0 = time.perf_counter()
            full = (_saved_model(torch, cfg, st[f"{name}_weights"]) if seed
                    else _as_fp32(full, cfg))
            load_s = time.perf_counter() - t0
            del shapes[:], dw_shapes[:]
            r = _served(torch, serve, counters, cfg, full,
                        _dps_argv(cfg, prompt, gen, pseed, mp, smoke))
            r["load_s"] = load_s
            r["flash_shapes"], r["dw_shapes"] = list(shapes), list(dw_shapes)
            r["blocks_bytes"] = _dps_blocks_bytes(
                sharding, full, cfg, *mesh.make_host_mesh(model=mp))
            r["run_s"] = time.perf_counter() - t0
            r.pop("prompt")
            out[name] = r
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(st["out"], f"rank{rank}.pt"))


def _dps_blocks_bytes(sharding, model, cfg, mesh, coords) -> int:
    """The bytes of the 2-D blocks of ``model``'s leaves that the device
    at ``coords`` holds, from the leaves' shapes and the specs (an SSM
    model's fused leaves at their segment-aligned width on 'model')."""
    specs = sharding.param_pspecs(model, mesh)
    total = 0
    for key, t in model.state_dict().items():
        name, spec = key.split(".")[-1], specs[key]
        ssm = cfg.ssm is not None and name in sharding.SSM_SEGMENTS
        shape = list(sharding.local_shape(
            t.shape, (*spec[:-1], None) if ssm else spec, mesh))
        if ssm:
            shape[-1] = sharding.ssm_local_width(cfg, name,
                                                 mesh.shape["model"])
        total += math.prod(shape) * t.element_size()
    return total


def _dps_peak_parts(sharding, model, cfg, layout) -> dict:
    """The bytes a rank of ``layout`` holds at its peak in a decode step
    beyond its blocks and cache, from ``model``'s (whole) leaves: a
    gather (``DataShards._all_gather``) holds at once the flat copy of
    the rank's blocks of its leaves, the gathered buffer and the
    reassembled leaves (``staging``: the blocks plus twice the column
    block); a tied model keeps the gathered table (``table_held``) from
    the embedding to the unembedding, over its layers' gathers.  ``peak``
    is the most of: a table's staging, and a layer's beside the held
    table."""
    from repro_torch.models import leaf_shapes
    mesh = sharding.MeshShape(("data", "model"), layout)
    shapes = leaf_shapes(cfg)
    specs, dims = sharding.fsdp_dims(shapes, mesh)
    sizes = {k: t.element_size() for k, t in model.state_dict().items()}
    layer, tables = 0, {}
    for k, shape in shapes.items():
        if dims[k] is None:
            continue
        whole = math.prod(sharding.model_block_shape(
            k, shape, specs[k], mesh, cfg)) * sizes[k]
        staged = whole // layout[0] + 2 * whole
        if k.split(".")[0].endswith("layers"):  # a layer's slice of a stack
            layer += staged // shape[0]
        else:
            tables[k] = (whole, staged)
    held = tables["embed.tok"][0] if cfg.tie_embeddings else 0
    return dict(table_held=held, layer_staging=layer,
                table_staging=max(st for _, st in tables.values()),
                peak=max(max(st for _, st in tables.values()),
                         held + layer))


def _dps_want(cfgs, layout):
    """What a rank of ``layout`` must show for each bf16 run: its fused
    prefill's launches, the kernels' input shapes (a data row's DPS_BATCH
    / dp rows, its model column's heads and conv channels), and a decode
    step's data gathers (a layer's column block each, then the tables)
    and model-group sums (2 a layer and the embedding's, at mp > 1)."""
    from repro_torch.models import sharding
    dp, mp = layout
    B, T = DPS_BATCH // dp, DPS_PROMPT
    out = {}
    for name in ("starcoder2", "mamba2"):
        cfg = cfgs[name]
        L = cfg.n_layers
        w = dict(data_gathers=L + (1 if cfg.tie_embeddings else 2),
                 sums=2 * L + 1 if mp > 1 else 0, gathers=int(mp > 1))
        if cfg.family == "dense":
            w.update(prefill={"flash_fwd": L}, flash=[
                (B, T, cfg.n_kv_heads // mp, cfg.n_heads // cfg.n_kv_heads,
                 cfg.head_dim)] * L, dw=[])
        else:
            w.update(prefill={"depthwise_conv1d_fwd": L}, flash=[], dw=[
                (B, sharding.ssm_local_width(cfg, "conv", mp), T)] * L)
        for f32 in (False, True):
            L32 = LM_FP32_LAYERS if f32 else L
            out[name + ("_f32" if f32 else "")] = dict(
                w, data_gathers=L32 + (1 if cfg.tie_embeddings else 2),
                sums=2 * L32 + 1 if mp > 1 else 0)
    return out


def _dps_gate(torch, serve, name, cfg, layout, one, ranks, want, counters):
    """A run's ranks against the one process and ``want``: the fp32
    copies' prompt logits within DPS_F32_TOL of the one process's largest
    logit and every token equal; a bf16 run's within ``prefill_tol``,
    tokens equal where the top-2 margin is clear (``serve.prefill_gap``'s
    rule); every rank's gathered logits and tokens bitwise rank 0's (each
    data row's rows come from its model row); a rank's weight bytes its
    blocks'; the collectives a decode step; no launch in a decode step,
    the fused prefill's launches and the kernels' input shapes; the
    summary."""
    V = cfg.vocab_size
    f32 = cfg.dtype == "float32"
    tol = DPS_F32_TOL if f32 else serve.prefill_tol(cfg, torch.bfloat16)
    want_l = one["prompt_logits"][:, -1, :V].float()
    top2 = want_l.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * want_l.abs().max()
    zero = {c.__name__: 0 for c in counters}
    gaps = []
    for r, o in enumerate(ranks):
        where = f"dp-serve {layout} {name} rank {r}"
        gaps.append(_ts_rel(o["prompt_logits"][:, -1], want_l, V))
        same = o["prompt_logits"][:, -1, :V].argmax(-1) == want_l.argmax(-1)
        if not gaps[-1] <= tol or not bool((same | (
                torch.zeros_like(clear) if f32 else ~clear)).all()):
            raise AssertionError(f"{where}: logits {gaps[-1]:.3e} of the "
                                 f"largest from one process's (tol {tol})"
                                 f", greedy tokens {same.tolist()}")
        if f32 and not (o["tokens"] == one["tokens"]).all():
            raise AssertionError(f"{where}: tokens differ from one "
                                 "process's")
        if not (torch.equal(o["prompt_logits"], ranks[0]["prompt_logits"])
                and (o["tokens"] == ranks[0]["tokens"]).all()):
            raise AssertionError(f"{where}: its logits or tokens differ "
                                 "from rank 0's")
        if o["weights_bytes"] != o["blocks_bytes"]:
            raise AssertionError(f"{where}: holds {o['weights_bytes']} "
                                 f"bytes of weights; its blocks are "
                                 f"{o['blocks_bytes']}")
        c = o["collectives"]
        got = dict(data_gathers=c["data_gathers"], sums=c["sums"],
                   gathers=c["gathers"])
        if got != {k: want[k] for k in got}:
            raise AssertionError(f"{where}: a decode step ran {got}; "
                                 f"expected {want}")
        if any(o["decode_launches"].values()):
            raise AssertionError(f"{where}: a decode step launched "
                                 f"{o['decode_launches']}")
        if "prefill" in want and not f32:
            if o["prefill_launches"] != {**zero, **want["prefill"]}:
                raise AssertionError(f"{where}: the fused prefill launched "
                                     f"{o['prefill_launches']}; expected "
                                     f"{want['prefill']}")
            for key in ("flash", "dw"):
                if o[f"{key}_shapes"] != want[key]:
                    raise AssertionError(
                        f"{where}: {key} inputs {set(o[f'{key}_shapes'])} "
                        f"({len(o[f'{key}_shapes'])}); expected "
                        f"{set(want[key])} ({len(want[key])})")
    r0 = ranks[0]
    return dict(
        tol=tol, rank_gaps=gaps, rows_with_clear_margin=int(clear.sum()),
        tokens_equal_one_process=[float((o["tokens"] == one[
            "tokens"]).mean()) for o in ranks],
        step_p50_ms=r0["step_p50_ms"], step_p99_ms=r0["step_p99_ms"],
        tokens_per_s=r0["tokens_per_s"],
        row_tokens_per_s=r0["row_tokens_per_s"],
        one_step_p50_ms=one["step_p50_ms"],
        one_step_p99_ms=one["step_p99_ms"],
        one_tokens_per_s=one["tokens_per_s"],
        collectives=r0["collectives"], weights_bytes=[
            o["weights_bytes"] for o in ranks],
        one_weights_bytes=one["weights_bytes"], cache_bytes=[
            o["cache_bytes"] for o in ranks],
        peak_memory_gb=[o["peak_memory_gb"] for o in ranks],
        one_peak_memory_gb=one["peak_memory_gb"],
        prefill_gap=[o["prefill_gap"] and o["prefill_gap"]["gap"]
                     for o in ranks],
        prefill_launches=r0["prefill_launches"],
        sequential_prefill_s=r0["sequential_prefill_s"],
        smoke_prefill_s=r0["smoke_prefill_s"], load_s=r0["load_s"],
        draw_s=r0["draw_s"], run_s=[o["run_s"] for o in ranks])


def dp_serve_check(torch, configs, init_model, serve, ref, conv1d_brgemm,
                   fa):
    """Phase 26: serving on the (world / mp, mp) mesh (see DPS_*).  The
    kernels at a data row's prefill shapes against their plain versions;
    one process serves each model on the card and saves its draw while
    the ranks of both layouts (``_dps_rank``) start up; then the (2, 1)
    ranks serve, then the (2, 2) ones, each held to the one process
    (``_dps_gate``)."""
    import tempfile

    import torch.multiprocessing as mp_

    from repro_torch.models import sharding

    t0, wall0 = time.perf_counter(), time.time()
    counters = _counters(conv1d_brgemm, fa)
    cfgs = _dps_cfgs(configs)
    sc2 = cfgs["starcoder2"]
    out = dict(card=_card_line(), backend="gloo")
    wants = {lay: _dps_want(cfgs, lay) for lay in DPS_LAYOUTS}
    out["flash_rows"], out["dw_rows"] = {}, {}
    for lay in DPS_LAYOUTS:
        w = wants[lay]["starcoder2"]["flash"][0]
        out["flash_rows"]["%dx%d" % lay] = _ts_flash_row(
            torch, fa, ref, f"dp-serve {lay} starcoder2", w[0], w[1], w[2],
            w[3], w[4], sc2.head_dim)
    w = wants[(2, 1)]["mamba2"]["dw"][0]
    out["dw_rows"]["2x1"] = _ts_dw_row(
        torch, conv1d_brgemm, ref, "dp-serve (2, 1) mamba2", w[0], w[1], w[2])
    out["kernel_rows_s"] = time.perf_counter() - t0
    one = {}
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 copies
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        sts, procs = {}, {}
        weights = {f"{name}_weights": os.path.join(tmp, f"{name}.pt")
                   for name, *_, seed, _, _ in _dps_runs((2, 1)) if seed}
        for lay in DPS_LAYOUTS:  # they start up while the one process runs
            sts[lay] = dict(out=os.path.join(tmp, "x".join(map(str, lay))),
                            layout=lay, port=_free_port(),
                            go=os.path.join(tmp, f"go{lay[0]}{lay[1]}"),
                            **weights)
            os.makedirs(sts[lay]["out"])
            procs[lay] = mp_.start_processes(
                _dps_rank, args=(sts[lay],), nprocs=lay[0] * lay[1],
                start_method="spawn", join=False)
        res = {}
        try:
            model = None
            for name, prompt, gen, seed, pseed, _ in _dps_runs((2, 1)):
                cfg = cfgs[name]
                if seed:  # drawn once on the host; the ranks read it back
                    model = _host_model(torch, cfg, init_model, seed)
                    torch.save(model.state_dict(), weights[f"{name}_weights"])
                    model = model.to(DEVICE)
                else:
                    model = _as_fp32(model, cfg)
                t = time.time() - wall0
                one[name] = _served(torch, serve, counters, cfg, model,
                                    _ts_argv(cfg.name, DPS_BATCH, prompt,
                                             gen, pseed))
                one[name]["served_at"] = (t, time.time() - wall0)
                one[name]["weights_bytes"] = serve._nbytes(
                    model.parameters())
                one[name]["peak_parts"] = {
                    lay: _dps_peak_parts(sharding, model, cfg, lay)
                    for lay in DPS_LAYOUTS}
                torch.cuda.empty_cache()
            del model
            torch.cuda.empty_cache()
            out["one_process_s"] = time.perf_counter() - t0 - out[
                "kernel_rows_s"]
            for lay in DPS_LAYOUTS:  # one layout at a time on the card
                st = sts[lay]
                t = time.perf_counter()
                open(st["go"], "w").close()
                while not procs[lay].join():
                    pass
                out[f"ranks_{lay[0]}x{lay[1]}_s"] = time.perf_counter() - t
                res[lay] = [torch.load(os.path.join(st["out"],
                                                    f"rank{r}.pt"),
                                       weights_only=False)
                            for r in range(lay[0] * lay[1])]
                out[f"ranks_{lay[0]}x{lay[1]}_ready_at"] = max(
                    r["ready_at"] for r in res[lay]) - wall0
        finally:  # a failed run leaves no rank waiting
            for ctx in procs.values():
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
    for lay in DPS_LAYOUTS:
        for name, *_ in _dps_runs(lay):
            key = f"{lay[0]}x{lay[1]} {name}"
            out[key] = _dps_gate(torch, serve, name, cfgs[name], lay,
                                 one[name], [r[name] for r in res[lay]],
                                 wants[lay][name], counters)
            parts = one[name]["peak_parts"][lay]
            out[key].update(peak_parts=parts, peak_predicted_gb=[
                (o[name]["blocks_bytes"] + o[name]["cache_bytes"]
                 + parts["peak"]) / 1e9 for o in res[lay]])
            print(f"dp-serve-{key} " + json.dumps(out[key], default=str),
                  flush=True)
    out["blocks_share"] = {
        key: out[key]["weights_bytes"][0] / out[key]["one_weights_bytes"]
        for key in out if key.endswith(("starcoder2", "mamba2"))}
    served = [one[name]["served_at"] for name in one]
    out["one_process_served_at"] = (served[0][0], served[-1][1])
    out["one_overlaps_rank_startup"] = any(
        out[f"ranks_{a}x{b}_ready_at"] > served[0][0]
        for a, b in DPS_LAYOUTS)
    out["seconds"] = time.perf_counter() - t0
    print(f"dp-serve: phase 26 in {out['seconds']:.1f} s ({out['card']}; "
          f"kernel rows {out['kernel_rows_s']:.1f} s, one process "
          f"{out['one_process_s']:.1f} s, ranks (2, 1) "
          f"{out['ranks_2x1_s']:.1f} s, (2, 2) {out['ranks_2x2_s']:.1f} s)",
          flush=True)
    print(f"dp-serve: one process served at +{served[0][0]:.1f} to "
          f"+{served[-1][1]:.1f} s; the ranks ready at +"
          f"{out['ranks_2x1_ready_at']:.1f} (2, 1) and +"
          f"{out['ranks_2x2_ready_at']:.1f} s (2, 2): the one process's "
          + ("times overlap the ranks' start-up"
             if out["one_overlaps_rank_startup"] else
             "times follow the ranks' start-up"), flush=True)
    for key in out:
        if not key.endswith(("starcoder2", "mamba2")):
            continue
        a = out[key]
        c = a["collectives"]
        print(f"dp-serve:   {key}: decode p50 {a['step_p50_ms']:.1f} ms, "
              f"p99 {a['step_p99_ms']:.1f} a rank, "
              f"{a['tokens_per_s']:.1f} tokens/s the batch, "
              f"{a['row_tokens_per_s']:.1f} a data row (one process "
              f"{a['one_step_p50_ms']:.1f} ms, {a['one_tokens_per_s']:.1f} "
              f"tokens/s); {c['data_gathers']:.0f} data gathers a step "
              f"({c['data_seconds'] * 1e3:.1f} ms of host time), "
              f"{c['sums']:.0f} model sums ({c['seconds'] * 1e3:.1f} ms); "
              f"weights {a['weights_bytes'][0] / 1e9:.3f} GB a rank of "
              f"{a['one_weights_bytes'] / 1e9:.3f}, peak "
              f"{max(a['peak_memory_gb']):.3f} GB a rank (its blocks "
              f"{a['weights_bytes'][0] / 1e9:.3f}, cache "
              f"{a['cache_bytes'][0] / 1e9:.3f}, the gathers' staging "
              f"{a['peak_parts']['peak'] / 1e9:.3f}, of it a held table "
              f"{a['peak_parts']['table_held'] / 1e9:.3f}: "
              f"{max(a['peak_predicted_gb']):.3f} predicted) against "
              f"{a['one_peak_memory_gb']:.3f} one process; logits "
              f"{max(a['rank_gaps']):.2e} of the largest (tol "
              f"{a['tol']:.2e})", flush=True)
    return out


def _dps_entries(dps, dw_fwd_entry, flash_entries):
    """Phase 26's numbers in the kernels line: ``flash_fwd`` and
    ``depthwise_conv1d_fwd`` at a data row's fused-prefill shapes
    (launches a rank, the shape, its row)."""
    keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err")
    flash_entries[0]["dp_serve"] = {
        lay: dict(launches_per_rank_prefill=dps[f"{lay} starcoder2"][
            "prefill_launches"]["flash_fwd"], **{k: row[k] for k in keys})
        for lay, row in dps["flash_rows"].items()}
    dw_fwd_entry["dp_serve"] = {
        lay: dict(launches_per_rank_prefill=dps[f"{lay} mamba2"][
            "prefill_launches"]["depthwise_conv1d_fwd"],
            **{k: row[k] for k in keys})
        for lay, row in dps["dw_rows"].items()}


def _hl_cfgs(configs):
    """Phase 27's models (bf16, flash, every width): Qwen2-7B and
    StarCoder2-3B cut to HL_LAYERS layers, Whisper-large-v3 to HL_LAYERS
    encoder and HL_LAYERS decoder layers, and each one's fp32 copy."""
    import dataclasses
    cut = dict(n_layers=HL_LAYERS, attn_impl="flash")
    out = dict(qwen2=dataclasses.replace(configs.get("qwen2-7b"), **cut),
               whisper=dataclasses.replace(configs.get(WH_ARCH),
                                           n_encoder_layers=HL_LAYERS, **cut),
               starcoder2=dataclasses.replace(configs.get(TS_SC2), **cut))
    out.update({f"{k}_f32": dataclasses.replace(v, dtype="float32")
                for k, v in list(out.items())})
    return out


def _hl_runs():
    """(name, batch, prompt tokens, generated tokens, weights' seed (None:
    the previous run's weights cast to fp32), prompt's seed, ``--smoke``)
    of each run, in order: each model in bf16, then its fp32 copy."""
    runs = []
    for i, name in enumerate(HL_LAYOUTS):
        seed = 311 + 4 * i
        prompt = WH_PROMPT if name == "whisper" else HL_PROMPT
        runs += [(name, HL_BATCH, prompt, HL_GEN, seed, seed + 1, True),
                 (f"{name}_f32", LM_FP32_BATCH, min(prompt, HL_F32_PROMPT),
                  HL_F32_GEN, None, seed + 3, False)]
    return runs


def _hl_layout(name):
    return HL_LAYOUTS[name.removesuffix("_f32")]


def _hl_argv(name, cfg, batch, prompt, gen, seed, smoke):
    return (_ts_argv(cfg.name, batch, prompt, gen, seed, smoke=smoke)
            + ["--model-parallel", str(_hl_layout(name)[1]),
               "--dist-backend", "gloo"])


def _hl_rank(rank, st):
    """Phase 27, one of HL_WORLD gloo ranks sharing the card (``st``: its
    port and the one process's saved draws, both dtypes): the launcher
    from torchrun's variables on each of ``_hl_runs``' models once the
    parent's go file for it is written, whole on the host (read back
    memory-mapped) and narrowed to the rank's head-aligned blocks by the
    launcher, at its model's layout; the flash inputs' shapes recorded.
    Results go to a file the parent reads."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import conv1d_brgemm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh, serve
    from repro_torch.models import common as cm

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 copies
    os.environ.update(WORLD_SIZE=str(HL_WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(st["port"]))
    counters = _counters(conv1d_brgemm, fa)
    shapes = []

    def recorded(q, *a, real=cm.flash_attention, **k):
        shapes.append(tuple(q.shape))  # the rank's heads (B, T, KV, G, hd)
        return real(q, *a, **k)

    cm.flash_attention = recorded
    cfgs = _hl_cfgs(configs)
    out = {}
    try:
        mesh.init_data_group("gloo")
        out["ready_at"] = time.time()
        for name, batch, prompt, gen, _, pseed, smoke in _hl_runs():
            cfg = cfgs[name]
            go = st[f"{name.removesuffix('_f32')}_go"]
            while not os.path.exists(go):  # the one process's draws
                time.sleep(0.1)
            t0 = time.perf_counter()
            full = _saved_model(torch, cfg, st[f"{name}_weights"])
            del shapes[:]
            r = _served(torch, serve, counters, cfg, full, _hl_argv(
                name, cfg, batch, prompt, gen, pseed, smoke))
            del full
            r["flash_shapes"] = list(shapes)
            r["run_s"] = time.perf_counter() - t0
            r["started_at"] = time.time() - r["run_s"]
            r.pop("prompt")
            out[name] = r
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(st["out"], f"rank{rank}.pt"))


def _hl_blocks_bytes(sharding, cfg, shapes, sizes, layout, heads) -> int:
    """The bytes of the blocks a rank of ``layout`` holding ``heads``
    ((query heads, KV heads) counts) executes, from the leaves' whole
    ``shapes`` and element ``sizes`` under JAX's specs: each ``'data'``
    dimension split evenly; the ``'model'`` dimension of an attention leaf
    as many heads' slices as the rank holds (the query heads' of ``wq``,
    ``bq``, ``wo`` and Whisper's cross-attention, the KV heads' of the
    self-attention's ``wk``, ``wv``, ``bk``, ``bv``: the whole columns of
    a KV head the rank shares), any other split evenly."""
    mesh = sharding.MeshShape(("data", "model"), layout)
    specs = sharding.param_pspecs(shapes, mesh)
    total = 0
    for key, shape in shapes.items():
        names = key.split(".")
        dims = []
        for n, e in zip(shape, specs[key]):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            if "model" in axes and names[-1] in ("wq", "bq", "wo", "wk",
                                                 "wv", "bk", "bv"):
                kv = names[-1] in ("wk", "wv", "bk", "bv") and (
                    "cross" not in names)
                n = n // (cfg.n_kv_heads if kv else cfg.n_heads) * heads[kv]
                axes = tuple(a for a in axes if a != "model")
            dims.append(n // math.prod(mesh.shape[a] for a in axes))
        total += math.prod(dims) * sizes[key]
    return total


def _hl_cache_bytes(cfg, batch, prompt, gen, layout, heads) -> int:
    """A rank's cache bytes from its heads: each layer's K and V of its
    data row's rows over prompt + gen positions and its KV heads, and an
    encoder-decoder's cross K/V over the frames and its query heads, in
    the launcher's cache dtype (the model's)."""
    es = 4 if cfg.dtype == "float32" else 2
    rows = batch // layout[0] if batch % layout[0] == 0 else batch
    out = 2 * cfg.n_layers * rows * (prompt + gen) * heads[1] * cfg.head_dim
    if cfg.family == "encdec":
        out += 2 * cfg.n_layers * rows * cfg.encoder_width * heads[0] * (
            cfg.head_dim)
    return out * es


def _hl_want(cfgs):
    """What each run's rank m must show: a decode step's collectives
    (model sums: 2 a layer and the embedding's, Whisper's decoder 3 a
    layer; one logit gather; a data row's gathers at dp > 1: one a layer
    and the tied table), and for a bf16 run its fused prefill's and
    ``fill_cross_cache``'s ``flash_fwd`` launches and input shapes at the
    rank's heads (fill first, then the prefill: the encoder's, then the
    decoder's)."""
    want = {}
    for name, batch, prompt, *_ in _hl_runs():
        cfg = cfgs[name]
        dp, mp = _hl_layout(name)
        L = cfg.n_layers
        enc = cfg.family == "encdec"
        base = dict(sums=(3 if enc else 2) * L + 1, gathers=1,
                    data_gathers=L + (1 if cfg.tie_embeddings else 2)
                    if dp > 1 else 0)
        ranks = []
        for m in range(mp):
            q, kv = HL_HEADS[name.removesuffix("_f32")][m]
            w = dict(base, heads=(q, kv))
            if cfg.dtype != "float32":
                rows = batch // dp
                dec = (rows, prompt, kv, q // kv, cfg.head_dim)
                if enc:
                    e = (rows, cfg.encoder_width, kv, 1, cfg.head_dim)
                    w.update(fill={"flash_fwd": L},
                             prefill={"flash_fwd": 2 * L},
                             flash=[e] * (2 * L) + [dec] * L)
                else:
                    w.update(prefill={"flash_fwd": L}, flash=[dec] * L)
            elif enc:
                w.update(fill={"flash_fwd": L})
            ranks.append(w)
        want[name] = ranks
    return want


def _hl_gate(torch, sharding, serve, name, cfg, one, ranks, want, counters,
             shapes, sizes):
    """A run's HL_WORLD ranks against the one process and ``want``: the
    fp32 copies' prompt logits within HL_F32_TOL of the one process's
    largest logit and every token equal; a bf16 run's within
    ``prefill_tol``, tokens equal where the top-2 margin is clear; every
    rank's logits and tokens bitwise rank 0's (at (2, 4) each data row's
    rows gathered from its model row); each rank's heads, weight bytes
    (``_hl_blocks_bytes``) and cache bytes (``_hl_cache_bytes``); the
    collectives a decode step; no launch in a decode step; the fused
    prefill's and the fill's launches and flash inputs; the summary."""
    V = cfg.vocab_size
    layout = _hl_layout(name)
    f32 = cfg.dtype == "float32"
    tol = HL_F32_TOL if f32 else serve.prefill_tol(cfg, torch.bfloat16)
    want_l = one["prompt_logits"][:, -1, :V].float()
    top2 = want_l.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * want_l.abs().max()
    zero = {c.__name__: 0 for c in counters}
    blocks = [(len(q), len(kv)) for q, kv in sharding.head_blocks(
        cfg, layout[1])]
    gaps = []
    for r, o in enumerate(ranks):
        where = f"head-layouts {layout} {name} rank {r}"
        w = want[r % layout[1]]
        if blocks[r % layout[1]] != w["heads"]:
            raise AssertionError(f"{where}: head_blocks gives it "
                                 f"{blocks[r % layout[1]]}; expected "
                                 f"{w['heads']}")
        gaps.append(_ts_rel(o["prompt_logits"][:, -1], want_l, V))
        same = o["prompt_logits"][:, -1, :V].argmax(-1) == want_l.argmax(-1)
        if not gaps[-1] <= tol or not bool((same | (
                torch.zeros_like(clear) if f32 else ~clear)).all()):
            raise AssertionError(f"{where}: logits {gaps[-1]:.3e} of the "
                                 f"largest from one process's (tol {tol})"
                                 f", greedy tokens {same.tolist()}")
        if f32 and not (o["tokens"] == one["tokens"]).all():
            raise AssertionError(f"{where}: tokens differ from one "
                                 "process's")
        if not (torch.equal(o["prompt_logits"], ranks[0]["prompt_logits"])
                and (o["tokens"] == ranks[0]["tokens"]).all()):
            raise AssertionError(f"{where}: its logits or tokens differ "
                                 "from rank 0's")
        blk = _hl_blocks_bytes(sharding, cfg, shapes, sizes, layout,
                               w["heads"])
        cache = _hl_cache_bytes(cfg, one["batch"], one["prompt_len"],
                                one["gen"], layout, w["heads"])
        if (o["weights_bytes"], o["cache_bytes"]) != (blk, cache):
            raise AssertionError(
                f"{where}: holds {o['weights_bytes']} bytes of weights and "
                f"{o['cache_bytes']} of cache; its heads' blocks are {blk} "
                f"and their cache {cache}")
        c = o["collectives"]
        got = dict(sums=c["sums"], gathers=c["gathers"],
                   data_gathers=c["data_gathers"])
        if got != {k: w[k] for k in got}:
            raise AssertionError(f"{where}: a decode step ran {got}; "
                                 f"expected {w}")
        if any(o["decode_launches"].values()):
            raise AssertionError(f"{where}: a decode step launched "
                                 f"{o['decode_launches']}")
        for key in ("prefill", "fill"):
            if o[f"{key}_launches"] != {**zero, **w.get(key, {})}:
                raise AssertionError(f"{where}: its {key} launched "
                                     f"{o[f'{key}_launches']}; expected "
                                     f"{w.get(key, {})}")
        if o["flash_shapes"] != w.get("flash", o["flash_shapes"]):
            raise AssertionError(
                f"{where}: flash inputs {sorted(set(o['flash_shapes']))} "
                f"({len(o['flash_shapes'])}); expected "
                f"{sorted(set(w['flash']))} ({len(w['flash'])})")
    r0 = ranks[0]
    return dict(
        layout=layout, tol=tol, rank_gaps=gaps,
        rows_with_clear_margin=int(clear.sum()),
        tokens_equal_one_process=[float((o["tokens"] == one[
            "tokens"]).mean()) for o in ranks],
        heads=blocks, step_p50_ms=[o["step_p50_ms"] for o in ranks],
        step_p99_ms=[o["step_p99_ms"] for o in ranks],
        tokens_per_s=r0["tokens_per_s"],
        one_step_p50_ms=one["step_p50_ms"],
        one_step_p99_ms=one["step_p99_ms"],
        one_tokens_per_s=one["tokens_per_s"], collectives=r0["collectives"],
        weights_bytes=[o["weights_bytes"] for o in ranks],
        one_weights_bytes=one["weights_bytes"],
        cache_bytes=[o["cache_bytes"] for o in ranks],
        one_cache_bytes=one["cache_bytes"],
        peak_memory_gb=[o["peak_memory_gb"] for o in ranks],
        one_peak_memory_gb=one["peak_memory_gb"],
        prefill_gap=[o["prefill_gap"] and o["prefill_gap"]["gap"]
                     for o in ranks],
        prefill_launches=r0["prefill_launches"],
        fill_launches=r0["fill_launches"], encode_s=r0.get("encode_s"),
        sequential_prefill_s=r0["sequential_prefill_s"],
        smoke_prefill_s=r0["smoke_prefill_s"], draw_s=r0["draw_s"],
        run_s=[o["run_s"] for o in ranks])


def head_layouts_check(torch, configs, init_model, serve, ref,
                       conv1d_brgemm, fa):
    """Phase 27: tensor-parallel serving where the heads or KV heads do
    not divide the model axis (see HL_*).  ``flash_fwd`` at each new rank
    prefill shape against its plain version (``_ts_flash_row``); one
    process serves each model on the card and saves its draws (bf16 and
    the fp32 copy) while HL_WORLD gloo ranks start up (``_hl_rank``);
    then the ranks serve each through the launcher at its layout, each
    run held to the one process (``_hl_gate``)."""
    import tempfile

    import torch.multiprocessing as mp_

    from repro_torch.models import leaf_shapes, sharding

    t0, wall0 = time.perf_counter(), time.time()
    counters = _counters(conv1d_brgemm, fa)
    cfgs = _hl_cfgs(configs)
    want = _hl_want(cfgs)
    out = dict(card=_card_line(), backend="gloo", world=HL_WORLD)
    wh = cfgs["whisper"]
    rows = {}
    for name, label, m, T, causal in (
            ("qwen2", "qwen2 G 4", 0, HL_PROMPT, True),
            ("qwen2", "qwen2 G 3", 1, HL_PROMPT, True),
            ("starcoder2", "starcoder2 G 6", 0, HL_PROMPT, True),
            ("whisper", "whisper encoder 3 heads", 0, wh.encoder_width,
             False),
            ("whisper", "whisper encoder 2 heads", -1, wh.encoder_width,
             False),
            ("whisper", "whisper decoder 3 heads", 0, WH_PROMPT, True),
            ("whisper", "whisper decoder 2 heads", -1, WH_PROMPT, True)):
        cfg = cfgs[name]
        q, kv = HL_HEADS[name][m]
        rows[label] = _ts_flash_row(
            torch, fa, ref, f"head-layouts {label}",
            HL_BATCH // _hl_layout(name)[0], T, kv, q // kv, cfg.head_dim,
            cfg.head_dim, causal=causal)
    out["flash_rows"] = rows
    out["kernel_rows_s"] = time.perf_counter() - t0
    one = {}
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 copies
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        st = dict(out=tmp, port=_free_port(),
                  **{f"{name}_weights": os.path.join(tmp, f"{name}.pt")
                     for name, *_ in _hl_runs()},
                  **{f"{name}_go": os.path.join(tmp, f"go_{name}")
                     for name in HL_LAYOUTS})
        procs = mp_.start_processes(_hl_rank, args=(st,), nprocs=HL_WORLD,
                                    start_method="spawn", join=False)
        try:
            model = None
            for name, batch, prompt, gen, seed, pseed, _ in _hl_runs():
                cfg = cfgs[name]
                t = time.perf_counter()
                if seed:  # drawn once on the host
                    model = _host_model(torch, cfg, init_model, seed)
                    torch.save(model.state_dict(), st[f"{name}_weights"])
                    model = model.to(DEVICE)
                else:  # the bf16 weights cast, saved for the ranks
                    model = _as_fp32(model, cfg)
                    torch.save({k: v.cpu() for k, v in
                                model.state_dict().items()},
                               st[f"{name}_weights"])
                save_s = time.perf_counter() - t
                one[name] = _served(torch, serve, counters, cfg, model,
                                    _ts_argv(cfg.name, batch, prompt, gen,
                                             pseed))
                one[name].update(
                    save_s=save_s, batch=batch, prompt_len=prompt, gen=gen,
                    weights_bytes=serve._nbytes(model.parameters()),
                    cache_bytes=serve._nbytes(sharding.tree_leaves(
                        serve.make_cache(cfg, batch, prompt + gen,
                                         dtype=serve.lm_cache_dtype(cfg),
                                         device="meta"))),
                    shapes=leaf_shapes(cfg), sizes={
                        k: v.element_size()
                        for k, v in model.state_dict().items()})
                if cfg.dtype == "float32":  # its ranks may serve it now
                    del model
                    model = None
                    open(st[f"{name.removesuffix('_f32')}_go"], "w").close()
                    out[f"{name}_go_at"] = time.time() - wall0
                torch.cuda.empty_cache()
            out["one_process_s"] = time.perf_counter() - t0 - out[
                "kernel_rows_s"]
            while not procs.join():
                pass
            out["ranks_s"] = time.time() - wall0 - out[
                f"{next(iter(HL_LAYOUTS))}_f32_go_at"]
            res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                              weights_only=False) for r in range(HL_WORLD)]
        finally:  # a failed run leaves no rank waiting
            for proc in procs.processes:
                if proc.is_alive():
                    proc.terminate()
    out["ranks_ready_at"] = max(r["ready_at"] for r in res) - wall0
    for name, *_ in _hl_runs():
        o = one[name]
        out[name] = _hl_gate(torch, sharding, serve, name, cfgs[name], o,
                             [r[name] for r in res], want[name], counters,
                             o.pop("shapes"), o.pop("sizes"))
        out[name].update(save_s=o["save_s"], started_at=min(
            r[name]["started_at"] for r in res) - wall0)
        print(f"head-layouts-{name} " + json.dumps(out[name], default=str),
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"head-layouts: phase 27 in {out['seconds']:.1f} s ({out['card']}; "
          f"kernel rows {out['kernel_rows_s']:.1f} s, one process "
          f"{out['one_process_s']:.1f} s, {HL_WORLD} ranks ready at +"
          f"{out['ranks_ready_at']:.1f} s, serving from the first go file "
          f"for {out['ranks_s']:.1f} s; the go files at " + ", ".join(
              f"+{out[k]:.1f}" for k in out if k.endswith("_go_at"))
          + " s, the ranks' runs from " + ", ".join(
              f"+{out[n]['started_at']:.1f}" for n, *_ in _hl_runs())
          + " s)", flush=True)
    for name, *_ in _hl_runs():
        a = out[name]
        c = a["collectives"]
        print(f"head-layouts:   {name} {a['layout']}: heads {a['heads']}; "
              f"decode p50 {max(a['step_p50_ms']):.1f} ms, p99 "
              f"{max(a['step_p99_ms']):.1f} the slowest rank (one process "
              f"{a['one_step_p50_ms']:.1f} ms); {c['sums']:.0f} sums, "
              f"{c['gathers']:.0f} gathers and {c['data_gathers']:.0f} data "
              f"gathers a step ({c['seconds'] * 1e3:.1f} + "
              f"{c['data_seconds'] * 1e3:.1f} ms of host time); weights "
              f"{min(a['weights_bytes']) / 1e9:.3f}-"
              f"{max(a['weights_bytes']) / 1e9:.3f} GB a rank of "
              f"{a['one_weights_bytes'] / 1e9:.3f}, cache "
              f"{max(a['cache_bytes']) / 1e9:.4f} of "
              f"{a['one_cache_bytes'] / 1e9:.4f}, peak "
              f"{max(a['peak_memory_gb']):.3f} GB a rank (one process "
              f"{a['one_peak_memory_gb']:.3f}); logits "
              f"{max(a['rank_gaps']):.2e} of the largest (tol "
              f"{a['tol']:.2e})", flush=True)
    return out


def _hl_entries(hl, flash_entries):
    """Phase 27's numbers in the kernels line: ``flash_fwd`` at each new
    rank prefill shape (launches a rank's fused prefill, the row)."""
    keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err")
    flash_entries[0]["head_layouts"] = {
        label: dict(launches_per_rank_prefill=hl[label.split()[0]][
            "prefill_launches"]["flash_fwd"], **{k: row[k] for k in keys})
        for label, row in hl["flash_rows"].items()}


def _dr_flash_row(torch, fa, ref, B, T, KV, G, hd):
    """``flash_fwd`` at the dry-run rank's StarCoder2-3B prefill (bf16,
    causal) against its plain version taken DR_Q_CHUNK queries at a time
    against every key, by phase 10's per-element rule; timed beside SDPA
    and the bound (the plain version by events around a call: its host
    work is small beside its device time at this size)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(94)
    q, k, v, _ = _flash_operands(torch, gen, B, T, KV, G, hd,
                                 torch.bfloat16)
    H = KV * G

    def fl():
        return fa.flash_fwd(q, k, v, causal=True, bq=min(256, T))

    def plain():
        parts = [ref.flash_fwd_ref(q[:, i:i + DR_Q_CHUNK], k, v,
                                   causal=True, q_offset=i)
                 for i in range(0, T, DR_Q_CHUNK)]
        return (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts], 1))

    (o, lse), (o_p, lse_p) = fl(), plain()
    errs = _flash_errs("dryrun flash", {"o": (o, o_p)}, lse, lse_p, True)
    del o, lse, o_p, lse_p
    qt, kt, vt = (t.transpose(1, 2) for t in (q.reshape(B, T, H, hd), k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    nbytes = _flash_fwd_bytes(B * T * H, B * T * KV, hd, hd, 2)
    row = dict(shape=f"dryrun prefill B={B} T={T} H={H} KV={KV} hd={hd} "
               "bf16 causal", **_flash_err_fields(errs, True),
               kernel_ms=_device_ms(fl, per_graph=2, reps=3),
               plain_ms=_call_ms(plain, reps=2),
               library_ms=_device_ms(sdpa, per_graph=2, reps=3),
               call_ms=_call_ms(fl, reps=5))
    row["bound_ms"], row["bound_by"] = _attn_bound(
        B, T, H, 2 * hd, True, "bfloat16", nbytes)
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    print("dryrun-kernel " + json.dumps(row), flush=True)
    return row


def _dr_card(torch, specs, cfg, shape, mesh, counters):
    """One rank of the cell on the card (``specs.build_cell(...,
    device=, seed=)``: its blocks drawn there, counting groups): the
    step's launches, the parameter and argument bytes, the peak bytes
    allocated from before the build, the logits' checks, and the step's
    time (events around a call; host work included where longer)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell = specs.build_cell(cfg, shape, mesh, device=DEVICE, seed=DR_SEED)
    model = cell.args[0]
    (_, logits), launches = _counted(counters, lambda: cell.fn(*cell.args))
    torch.cuda.synchronize()
    out = dict(
        launches={k: n for k, n in launches.items() if n},
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        arg_bytes=roofline.tensor_bytes(cell.args),
        peak_bytes=torch.cuda.max_memory_allocated() - base,
        logits_shape=list(logits.shape))
    real = logits[..., :cfg.vocab_size].float()
    if tuple(logits.shape) != (cell.meta["rows"][1] - cell.meta["rows"][0],
                               1, cfg.padded_vocab) \
            or not bool(torch.isfinite(real).all()):
        raise AssertionError(f"dryrun {cfg.name}: logits of "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(real).all())}")
    del logits, real
    out["step_ms"] = _call_ms(lambda: cell.fn(*cell.args), reps=3)
    del cell, model
    torch.cuda.empty_cache()
    return out


def dryrun_check(torch, configs, ref, conv1d_brgemm, fa):
    """Phase 28: the dry-run's count of one rank against the card
    (module docstring, DR_*)."""
    import dataclasses

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import flops as rflops
    mesh = make_production_mesh()
    shape = configs.SHAPES[DR_SHAPE]
    counters = _counters(conv1d_brgemm, fa)
    res = {}
    for label, (arch, over) in DR_CELLS.items():
        cfg = dataclasses.replace(configs.get(arch), n_layers=DR_LAYERS,
                                  **over)
        t0 = time.perf_counter()
        pred, meta = dryrun.count_cell(cfg, shape, mesh)
        dry_s = time.perf_counter() - t0
        terms = roofline.roofline_terms(
            pred, mesh.size, rflops.model_flops(cfg, shape),
            rflops.model_bytes(cfg, shape), mesh=mesh)
        card = _dr_card(torch, specs, cfg, shape, mesh, counters)
        want_launches = {k: v["calls"] for k, v in pred["kernels"].items()}
        predicted = pred["arg_bytes"] + pred["peak_bytes"]
        r = dict(arch=arch, layers=DR_LAYERS, meta=meta, dryrun_s=dry_s,
                 predicted=dict(
                     launches=want_launches, param_bytes=pred["param_bytes"],
                     arg_bytes=pred["arg_bytes"],
                     peak_beyond_args=pred["peak_bytes"],
                     peak_bytes=predicted, flops=pred["flops"],
                     dot_flops=pred["dot_flops"], bytes=pred["bytes"],
                     coll_bytes=pred["coll_bytes"],
                     coll_by_axis=pred["coll_by_axis"]),
                 terms=terms, card=card,
                 peak_rel_diff=card["peak_bytes"] / predicted - 1.0)
        step_s = card["step_ms"] / 1e3
        r["card_roofline_fraction"] = max(
            terms["ideal_compute_s"], terms["ideal_memory_s"]) / step_s
        r["count_bound_share"] = max(terms["compute_s"],
                                     terms["memory_s"]) / step_s
        print(f"dryrun {label}: " + json.dumps(r), flush=True)
        if card["launches"] != want_launches:
            raise AssertionError(f"dryrun {label}: launches on the card "
                                 f"{card['launches']}, counted "
                                 f"{want_launches}")
        if card["param_bytes"] != pred["param_bytes"]:
            raise AssertionError(f"dryrun {label}: {card['param_bytes']} "
                                 "parameter bytes on the card, counted "
                                 f"{pred['param_bytes']}")
        if abs(r["peak_rel_diff"]) > DR_PEAK_TOL:
            raise AssertionError(f"dryrun {label}: peak {card['peak_bytes']}"
                                 f" bytes on the card, predicted {predicted}"
                                 f" (beyond {DR_PEAK_TOL:.0%})")
        res[label] = r
    q, kv = res["starcoder2"]["meta"]["heads"]
    rows = res["starcoder2"]["meta"]["rows"]
    res["flash_row"] = _dr_flash_row(
        torch, fa, ref, rows[1] - rows[0], shape.seq_len, kv, q // kv,
        configs.get(DR_CELLS["starcoder2"][0]).head_dim)
    m2 = configs.get(DR_CELLS["mamba2"][0])
    from repro_torch.models import sharding
    rows = res["mamba2"]["meta"]["rows"]
    res["dw_row"] = _ts_dw_row(
        torch, conv1d_brgemm, ref, "rank 32k", rows[1] - rows[0],
        sharding.ssm_local_width(m2, "conv_w", mesh.shape["model"]),
        shape.seq_len, kind="dryrun")
    return res


def _dr_entries(dr, dw_fwd_entry, flash_entries):
    """Phase 28's numbers in the kernels line: ``flash_fwd`` and
    ``depthwise_conv1d_fwd`` at the 32k rank shapes (launches a rank's
    fused prefill of DR_LAYERS layers, the row)."""
    keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err")
    for entry, label, row, name in (
            (flash_entries[0], "starcoder2", dr["flash_row"], "flash_fwd"),
            (dw_fwd_entry, "mamba2", dr["dw_row"], "depthwise_conv1d_fwd")):
        entry["dryrun_32k"] = dict(
            launches_per_rank_prefill=dr[label]["card"]["launches"][name],
            counted=dr[label]["predicted"]["launches"][name],
            **{k: row[k] for k in keys})


def _build_all(conv1d_brgemm, flash_attention, build):
    """Build the six kernels' libraries at once (one nvcc each, started
    together), timed; and ptxas' lines naming each kernel, its registers
    and spills, and any warning."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(6) as pool:
        t0 = time.perf_counter()
        futs = {name: pool.submit(timed, fn) for name, fn in
                (("conv1d_fwd", conv1d_brgemm._lib),
                 ("conv1d_bwd_weight", conv1d_brgemm._bwd_lib),
                 ("depthwise_conv1d_fwd", conv1d_brgemm._dw_lib),
                 ("depthwise_conv1d_bwd_weight",
                  conv1d_brgemm._dw_bwd_lib),
                 ("flash_fwd", flash_attention._fwd_lib),
                 ("flash_bwd", flash_attention._bwd_lib))}
        each = {name: f.result() for name, f in futs.items()}
        total = time.perf_counter() - t0
    ptxas = {}
    for name in each:
        log = next(build.BUILD_DIR.glob(f"{name}-*.log"), None)
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if any(w in ln for w in ("entry function",
                                                 "registers", "spill",
                                                 "arning", "(C75"))]
                       if log else [])
    return total, each, ptxas


def _check_no_spills(ptxas, names):
    """Raise if ptxas reports a spill store or load in any kernel of the
    libraries ``names`` (the register-tiled bodies must hold their tiles
    in registers)."""
    import re
    for name in names:
        for ln in ptxas[name]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and (int(m[1]) or int(m[2])):
                raise AssertionError(f"{name} spills: {ln}")


def _check_wgmma_not_serialized(ptxas, names):
    """Raise if ptxas serializes the wgmma instructions of any kernel of
    the libraries ``names`` (notices C7513 and C7520: a register an
    in-flight wgmma reads is rewritten, or a wgmma sits under a branch
    that warpgroups take differently)."""
    for name in names:
        for ln in ptxas[name]:
            if "(C7513)" in ln or "(C7520)" in ln:
                raise AssertionError(f"{name} serializes wgmma: {ln}")


def _kernel_name(mangled):
    """``flash_fwd_wgmma_kernel<128>``, ``flash_bwd_dkv_wgmma_kernel<192,
    1>``, ``flash_fwd_kernel<float, 64>`` or ``bwd_weight_partial_taps<
    float, false>`` from a mangled name of the flash or bwd-weight
    sources; else the name itself."""
    import re
    m = re.search(r"\d+(flash_\w*?kernel)I(f?)Li(\d+)E(?:Li(\d+)E)?",
                  mangled)
    if m:
        return (f"{m[1]}<{'float, ' if m[2] else ''}{m[3]}"
                f"{', ' + m[4] if m[4] else ''}>")
    m = re.search(r"\d+(bwd_weight_partial\w*?)I(f|13__nv_bfloat16)"
                  r"((?:L[bi]\d+E)*)E", mangled)
    if m:
        args = ["float" if m[2] == "f" else "bf16"] + [
            ("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([bi])(\d+)E", m[3])]
        return f"{m[1]}<{', '.join(args)}>"
    return mangled


_SASS: dict = {}  # library file -> {kernel name: its SASS}


def _sass_functions(build, lib):
    """{kernel name: its SASS} of a loaded library (``cuobjdump -sass``),
    disassembled once a library."""
    if lib._name not in _SASS:
        tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        _SASS[lib._name] = {_kernel_name(fn.split()[0]): fn
                            for fn in sass.split("Function :")[1:]}
    return _SASS[lib._name]


def _disassemble(build, libs):
    """``_sass_functions`` of each of ``libs``, the disassemblers run at
    once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: _sass_functions(build, lib), libs))


def _loops(fn):
    """The opcodes of each loop of a kernel's SASS: a backward branch and
    the code it jumps back over."""
    import re
    ops = [(int(a, 16), [w for w in t.split() if not w.startswith("@")])
           for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    for a, t in ops:
        if t and t[0].startswith("BRA") and t[-1].startswith("0x") and (
                int(t[-1], 16) < a):
            yield [u[0].split(".")[0] for b, u in ops
                   if int(t[-1], 16) <= b <= a and u]


def hgmma_counts(build, flash_attention, conv1d_brgemm):
    """HGMMA instructions (wgmma in SASS) of each flash and each
    conv1d_bwd_weight kernel.  Raises unless all FLASH_WGMMA_KERNELS bf16
    flash kernels (``*_wgmma_kernel``: the forward and dQ at head_dim 64,
    112, 128 and 192; the fused dK/dV at 64, 112 and 128 and its dV and
    dK passes at 192) and every ``bwd_weight_partial`` kernel have some:
    the proof that their products run on the tensor cores."""
    counts = {}
    for lib in (flash_attention._fwd_lib(), flash_attention._bwd_lib(),
                conv1d_brgemm._bwd_lib()):
        for name, fn in _sass_functions(build, lib).items():
            counts[name] = fn.count("HGMMA")
    bf16 = {k: n for k, n in counts.items() if "wgmma" in k}
    if len(bf16) != FLASH_WGMMA_KERNELS or not all(bf16.values()):
        raise AssertionError(f"flash kernels' HGMMA counts {counts}: each "
                             f"of the {FLASH_WGMMA_KERNELS} bf16 kernels "
                             "must have some")
    bw = {k: n for k, n in counts.items()
          if k.startswith("bwd_weight_partial")}
    if not any("<float" in k for k in bw) or not all(bw.values()):
        raise AssertionError(f"conv1d_bwd_weight's HGMMA counts {bw}: each "
                             "bwd_weight_partial kernel must have some")
    return counts


def conv_loop_mix(build, conv1d_brgemm):
    """The instruction mix of each ``conv1d_fwd`` kernel's main loop from
    ``cuobjdump -sass``: of the loops with no MUFU (the epilogue's exp and
    tanh), the one with the largest share of FFMA.  {"conv1d_fwd_kernel<J,
    KT>": {"instructions": n, "FFMA": a, "LDS": b}}, loads of any width
    counted as one LDS each."""
    import re
    mix = {}
    for name, fn in _sass_functions(build, conv1d_brgemm._lib()).items():
        m = re.search(r"conv1d_fwd_kernelILi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        best = {"instructions": 1, "FFMA": 0, "LDS": 0}
        for body in _loops(fn):
            if "MUFU" in body:
                continue
            if body.count("FFMA") / len(body) > (best["FFMA"]
                                                  / best["instructions"]):
                best = {"instructions": len(body), "FFMA": body.count("FFMA"),
                        "LDS": body.count("LDS")}
        mix[f"conv1d_fwd_kernel<{m[1]}, {m[2]}>"] = best
    return mix


def bwd_loop_mix(build, conv1d_brgemm):
    """The main loop of each ``bwd_weight_partial`` kernel from
    ``cuobjdump -sass``: of its loops with HGMMA, the one with the largest
    share of HGMMA.  {name: {"instructions": n, "HGMMA": h, "LDS": l}}."""
    mix = {}
    for name, fn in _sass_functions(build, conv1d_brgemm._bwd_lib()).items():
        if not name.startswith("bwd_weight_partial"):
            continue
        best = {"instructions": 1, "HGMMA": 0, "LDS": 0}
        for body in _loops(fn):
            if body.count("HGMMA") / len(body) > (best["HGMMA"]
                                                   / best["instructions"]):
                best = {"instructions": len(body),
                        "HGMMA": body.count("HGMMA"),
                        "LDS": body.count("LDS")}
        mix[name] = best
    return mix


def _dp_row(r):
    """A kernel's row at a data-parallel shape, for the kernels line."""
    return {k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "max_abs_err",
                              "bound_share", "slice_copies_ms") if k in r}


def _prefill_entry(lm_serve, key, name, row):
    """A kernel's fused-prefill numbers for the kernels line: its launches
    in one prefill of the phase-14 cell and its row at the prefill's
    shape."""
    r = lm_serve["prefill_kernels"][row]
    return dict(launches_per_prefill=lm_serve[key]["prefill_launches"][name],
                **{k: r[k] for k in ("shape", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "call_ms", "library_call_ms",
                                     "max_abs_err", "bound_share")})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every result as JSON to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from repro_torch import configs
    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    from repro_torch.kernels import (build, conv1d_brgemm, flash_attention,
                                     ops, ref)
    from repro_torch.kernels import epilogue as ep
    from repro_torch.launch import serve, train
    from repro_torch.models import init_model
    from repro_torch.optim import adamw
    from repro_torch.train import losses
    from repro_torch.tune import sweep

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    phase_s = {}  # phase -> seconds of its calls, printed at the end

    def phase(n, fn, *a):
        t = time.perf_counter()
        with _drawn_once(torch, train):  # one draw a phase's launcher runs
            out = fn(*a)
        phase_s[n] = phase_s.get(n, 0.0) + time.perf_counter() - t
        return out

    print(f"device: {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build_s, build_each, ptxas = _build_all(conv1d_brgemm, flash_attention,
                                            build)
    print(f"built the six kernels in {build_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in build_each.items()) + ")", flush=True)
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    _check_no_spills(ptxas, ("conv1d_fwd", "depthwise_conv1d_fwd",
                             "conv1d_bwd_weight", "flash_fwd", "flash_bwd"))
    _check_wgmma_not_serialized(ptxas, ("conv1d_bwd_weight", "flash_fwd",
                                        "flash_bwd"))
    _disassemble(build, (flash_attention._fwd_lib(),
                         flash_attention._bwd_lib(), conv1d_brgemm._lib(),
                         conv1d_brgemm._bwd_lib()))
    hgmma = hgmma_counts(build, flash_attention, conv1d_brgemm)
    print("hgmma " + json.dumps(hgmma), flush=True)
    loop_mix = conv_loop_mix(build, conv1d_brgemm)
    print("conv1d_fwd main loops " + json.dumps(loop_mix), flush=True)
    bwd_mix = bwd_loop_mix(build, conv1d_brgemm)
    print("bwd_weight_partial main loops " + json.dumps(bwd_mix), flush=True)
    phase_s[1] = time.perf_counter() - t_start

    rows = phase(2, kernel_checks, torch, conv1d_brgemm, ops, ref, ep)
    stats = phase(3, serve_check, torch, np, configs, blocks, serve,
                  conv1d_brgemm)
    bwd_rows = phase(4, bwd_kernel_checks, torch, conv1d_brgemm, ref)
    grad_stats = phase(5, model_grad_check, torch, configs, blocks,
                       synthetic, adamw, conv1d_brgemm)
    train_stats = phase(6, train_check, torch, np, train, conv1d_brgemm)
    profile_stats = phase(6, train_profile, torch, train)
    dw_rows = phase(7, dw_kernel_checks, torch, conv1d_brgemm, ref)
    m2_grad = phase(8, mamba2_grad_check, torch, configs, init_model,
                    synthetic, losses, conv1d_brgemm)
    m2_layers = configs.get("mamba2-370m").n_layers
    m2_train, m2_profile = phase(9, lambda: (
        mamba2_train_check(torch, np, train, conv1d_brgemm, m2_layers),
        mamba2_profile(torch, train)))
    fa_rows = phase(10, flash_kernel_checks, torch, flash_attention, ref)
    lm_grad = phase(11, lm_grad_check, torch, configs, init_model,
                    synthetic, losses, flash_attention)
    lm_layers = configs.get("starcoder2-3b").n_layers
    lm_train, lm_prof = phase(12, lambda: (
        lm_train_check(torch, np, train, flash_attention, lm_layers),
        lm_profile(torch, train)))
    sweep_res = phase(13, sweep_check, sweep)
    lm_serve = phase(14, lm_serve_check, torch, configs, init_model, serve,
                     ops, ref, conv1d_brgemm, flash_attention)
    dp = phase(15, dp_check, torch, np, configs, train, conv1d_brgemm)
    tp = phase(16, tp_check, torch, np, configs, train, conv1d_brgemm)
    tel = phase(17, telemetry_check, torch, np, configs, blocks, serve,
                train, ops, conv1d_brgemm, rows, bwd_rows)
    elastic = phase(18, elastic_check, torch, np, train)
    model_args = (torch, np, configs, init_model, serve, train, synthetic,
                  losses, ref, conv1d_brgemm, flash_attention)
    wh = phase(19, whisper_check, *model_args)
    zb = phase(20, zamba2_check, *model_args)
    mn = phase(21, moonlight_check, *model_args)
    ds = phase(22, deepseek_check, *model_args)
    vl = phase(23, vlm_check, *model_args)
    ts = phase(24, tp_serve_check, torch, np, configs, init_model, serve,
               ref, conv1d_brgemm, flash_attention)
    fs = phase(25, fsdp_check, torch, configs, train, synthetic, ref,
               conv1d_brgemm, flash_attention)
    dps = phase(26, dp_serve_check, torch, configs, init_model, serve, ref,
                conv1d_brgemm, flash_attention)
    hl = phase(27, head_layouts_check, torch, configs, init_model, serve,
               ref, conv1d_brgemm, flash_attention)
    dr = phase(28, dryrun_check, torch, configs, ref, conv1d_brgemm,
               flash_attention)
    tp_rows = {r["pass_"].replace(" ", "_") + (
        "_stem" if "stem" in r["shape"] else "") + (
        "_bf16" if r["dtype"] == "bfloat16" else ""): _dp_row(r) | {
            k: r[k] for k in ("tile", "body", "copy_ms", "differ_share",
                              "max_ulps") if k in r}
        for r in tp["kernel_rows"]}
    tp_rank = tp[f"dp1_mp{TP_MP}"]

    main_row = next(r for r in rows if r["shape"] == MAIN_SHAPE)
    # device time of the 25 kernels of one stream step, from the per-layer
    # device times above, against the host-clock chunk time
    per_layer = {r["shape"].split()[0]: r["kernel_ms"] for r in rows
                 if r.get("kernel_ms") is not None
                 and r["shape"].endswith("stream")}
    step_kernel_ms = (per_layer["stem"] + 11 * per_layer["conv1"]
                      + 11 * per_layer["conv2"] + per_layer["head_signal"]
                      + per_layer["head_peak"])
    stats["step_kernel_ms"] = step_kernel_ms
    # host time ops.conv1d adds over the wrapper, summed over a step's 25
    added = {r["shape"].split()[0]: r["ops_added_host_us"] for r in rows
             if "ops_added_host_us" in r}
    stats["step_ops_added_host_us"] = (
        added["stem"] + 11 * added["conv1"] + 11 * added["conv2"]
        + added["head_signal"] + added["head_peak"])
    stats["kernel_share_of_chunk_p50"] = step_kernel_ms / stats["chunk_p50_ms"]
    print(f"stream step: kernels {step_kernel_ms:.4f} ms of device time, "
          f"chunk p50 {stats['chunk_p50_ms']:.4f} ms on the host clock; "
          f"ops.conv1d adds {stats['step_ops_added_host_us']:.1f} us of "
          "host time over the bare wrapper calls", flush=True)

    # device time of one training step's kernels, from the per-shape
    # device times above: 25 forward (stem, 22 conv, 2 heads), 24 bwd-data
    # (22 conv; the heads' is the 1->15 shape) and 25 bwd-weight passes
    t = {(r["pass_"], r["layer"]): r["kernel_ms"] for r in bwd_rows
         if r.get("kernel_ms") is not None}
    fwd_ms = t["fwd", "stem"] + 22 * t["fwd", "conv"] + 2 * t["fwd", "head"]
    bd_ms = 22 * t["bwd_data", "conv"] + 2 * t["bwd_data", "head"]
    bw_ms = (t["bwd_weight", "stem"] + 22 * t["bwd_weight", "conv"]
             + 2 * t["bwd_weight", "head"])
    train_stats.update(step_fwd_kernel_ms=fwd_ms,
                       step_bwd_data_kernel_ms=bd_ms,
                       step_bwd_weight_kernel_ms=bw_ms,
                       step_kernel_ms=fwd_ms + bd_ms + bw_ms)
    train_stats["kernel_share_of_step_p50"] = (
        train_stats["step_kernel_ms"] / train_stats["step_p50_ms"])
    print(f"train step: kernels {train_stats['step_kernel_ms']:.3f} ms of "
          f"device time (fwd {fwd_ms:.3f}, bwd-data {bd_ms:.3f}, "
          f"bwd-weight {bw_ms:.3f}), step p50 "
          f"{train_stats['step_p50_ms']:.3f} ms, "
          f"{train_stats['samples_per_s']:.2f} samples/s", flush=True)

    fp32_bwd = [r for r in bwd_rows if r["dtype"] == "float32"]
    conv_fwd = next(r for r in bwd_rows
                    if (r["pass_"], r["layer"], r["dtype"])
                    == ("fwd", "conv", "float32"))
    conv_bd = next(r for r in bwd_rows
                   if (r["pass_"], r["layer"], r["dtype"])
                   == ("bwd_data", "conv", "float32"))
    conv_bw = next(r for r in bwd_rows
                   if (r["pass_"], r["layer"], r["dtype"])
                   == ("bwd_weight", "conv", "float32"))
    fwd_entry = dict(
        name="conv1d_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/conv1d_fwd.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:492",
        launches=train_stats["conv1d_fwd_launches"],
        max_abs_err=max([r["max_abs_err"] for r in rows
                         if r["dtype"] == "float32"]
                        + [r["max_abs_err"] for r in fp32_bwd
                           if r["pass_"] != "bwd_weight"]),
        ms=conv_fwd["kernel_ms"], plain_ms=conv_fwd["plain_ms"],
        bound_ms=conv_fwd["bound_ms"], bound_by=conv_fwd["bound_by"],
        library_ms=conv_fwd["library_ms"], shape=conv_fwd["shape"],
        tile=conv_fwd["tile"], gflop_per_s=conv_fwd["gflop_per_s"],
        bound_share=conv_fwd["bound_share"],
        launches_per_step=train_stats["fwd_launches_per_step"],
        bwd_data={k: conv_bd[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "tile", "gflop_per_s",
            "bound_share")},
        dp=dict(launches_per_rank_step={
            c: dp[f"chunks{c}"]["launches_per_rank_step"]["conv1d_fwd"]
            for c in (1, DP_CHUNKS)},
            nccl_launches_per_step=dp["nccl"]["launches_per_step"][
                "conv1d_fwd"],
            **{r["pass_"]: _dp_row(r) for r in dp["kernel_rows"]
               if r["pass_"] in ("fwd", "bwd_data")}),
        tp=dict(launches_per_rank_step={
            c: tp_rank[f"chunks{c}"]["launches_per_rank_step"]["conv1d_fwd"]
            for c in (1, TP_CHUNKS)},
            **{k: v for k, v in tp_rows.items()
               if k.startswith(("fwd", "bwd_data"))}),
        serve=dict(shape=MAIN_SHAPE, launches=stats["launches"],
                   launches_per_step=stats["launches_per_step"],
                   ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
                   bound_ms=main_row["bound_ms"],
                   bound_by=main_row["bound_by"],
                   library_ms=main_row["library_ms"],
                   tile=main_row["tile"],
                   gflop_per_s=main_row["gflop_per_s"],
                   bound_share=main_row["bound_share"],
                   max_rel_diff=max(r["max_rel_diff"] for r in rows)))
    # bound_ms: the three-term TF32 bound; fma_bound_ms: the fp32 FMA one
    bw_keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_by", "bound_share", "fma_bound_ms", "fma_bound_by",
               "fma_bound_share", "gflop_per_s")
    bw_entry = dict(
        name="conv1d_bwd_weight", route="cuda",
        source="src/repro_torch/kernels/csrc/conv1d_bwd_weight.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:688",
        launches=train_stats["conv1d_bwd_weight_launches"],
        max_abs_err=max(r["max_abs_err"] for r in fp32_bwd
                        if r["pass_"] == "bwd_weight"),
        ms=conv_bw["kernel_ms"], plain_ms=conv_bw["plain_ms"],
        bound_ms=conv_bw["bound_ms"], bound_by=conv_bw["bound_by"],
        library_ms=conv_bw["library_ms"], shape=conv_bw["shape"],
        bound_share=conv_bw["bound_share"],
        fma_bound_ms=conv_bw["fma_bound_ms"],
        fma_bound_share=conv_bw["fma_bound_share"],
        gflop_per_s=conv_bw["gflop_per_s"],
        layers={layer: {k: r[k] for k in bw_keys}
                for r in bwd_rows for layer in ("stem", "head")
                if (r["pass_"], r.get("layer"), r["dtype"])
                == ("bwd_weight", layer, "float32")},
        hgmma={k: n for k, n in hgmma.items()
               if k.startswith("bwd_weight_partial")},
        main_loops=bwd_mix,
        launches_per_step=train_stats["bwd_weight_launches_per_step"],
        dp={**{f"chunks{c}": dict(
            launches_per_rank_step=dp[f"chunks{c}"]["launches_per_rank_step"][
                "conv1d_bwd_weight"],
            all_reduces_per_rank_step=dp[f"chunks{c}"][
                "all_reduces_per_rank_step"]) for c in (1, DP_CHUNKS)},
            **{r["pass_"].replace(" ", "_"): _dp_row(r)
               for r in dp["kernel_rows"]
               if r["pass_"].startswith("bwd_weight")}},
        tp=dict(launches_per_rank_step=tp_rank["chunks1"][
            "launches_per_rank_step"]["conv1d_bwd_weight"],
            **{k: v for k, v in tp_rows.items()
               if k.startswith("bwd_weight")}))
    # the depthwise pair: times at the Mamba2 layer shape, launches from
    # the Mamba2 training run, and the device time of one step's launches
    dw = {r["pass_"]: r for r in dw_rows if "kernel_ms" in r}
    m2_train.update(
        step_dw_fwd_kernel_ms=2 * m2_layers * dw["fwd"]["kernel_ms"],
        step_dw_bwd_data_kernel_ms=m2_layers * dw["bwd_data"]["kernel_ms"],
        step_dw_bwd_weight_kernel_ms=m2_layers * dw["bwd_weight"][
            "kernel_ms"],
        step_dw_bound_ms=m2_layers * (2 * dw["fwd"]["bound_ms"]
                                      + dw["bwd_data"]["bound_ms"]
                                      + dw["bwd_weight"]["bound_ms"]))
    m2_train["step_dw_kernel_ms"] = (m2_train["step_dw_fwd_kernel_ms"]
                                     + m2_train["step_dw_bwd_data_kernel_ms"]
                                     + m2_train[
                                         "step_dw_bwd_weight_kernel_ms"])
    print(f"mamba2 train step: depthwise kernels "
          f"{m2_train['step_dw_kernel_ms']:.3f} ms of device time (bound "
          f"{m2_train['step_dw_bound_ms']:.3f} ms), step p50 "
          f"{m2_train['step_p50_ms']:.1f} ms, "
          f"{m2_train['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{m2_train['peak_memory_gb']:.2f} GB", flush=True)
    dw_fwd_entry = dict(
        name="depthwise_conv1d_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/depthwise_conv1d_fwd.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:843",
        launches=m2_train["launches"]["depthwise_conv1d_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in dw_rows
                        if r["pass_"] in ("fwd", "bwd_data")),
        ms=dw["fwd"]["kernel_ms"], plain_ms=dw["fwd"]["plain_ms"],
        bound_ms=dw["fwd"]["bound_ms"], bound_by=dw["fwd"]["bound_by"],
        library_ms=dw["fwd"]["library_ms"], shape=dw["fwd"]["shape"],
        tile=dw["fwd"]["tile"], gb_per_s=dw["fwd"]["gb_per_s"],
        bound_share=dw["fwd"]["bound_share"],
        launches_per_step=m2_train["launches_per_step"][
            "depthwise_conv1d_fwd"],
        prefill=_prefill_entry(lm_serve, "mamba2", "depthwise_conv1d_fwd",
                               0),
        stream=lm_serve["stream"],
        bwd_data={k: dw["bwd_data"][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "tile", "gb_per_s",
            "bound_share")})
    dw_bw_entry = dict(
        name="depthwise_conv1d_bwd_weight", route="cuda",
        source="src/repro_torch/kernels/csrc/depthwise_conv1d_bwd_weight.cu",
        replaces="src/repro/kernels/conv1d_brgemm.py:998",
        launches=m2_train["launches"]["depthwise_conv1d_bwd_weight"],
        max_abs_err=max(r["max_abs_err"] for r in dw_rows
                        if r["pass_"] == "bwd_weight"),
        ms=dw["bwd_weight"]["kernel_ms"],
        plain_ms=dw["bwd_weight"]["plain_ms"],
        bound_ms=dw["bwd_weight"]["bound_ms"],
        bound_by=dw["bwd_weight"]["bound_by"],
        library_ms=dw["bwd_weight"]["library_ms"],
        shape=dw["bwd_weight"]["shape"],
        launches_per_step=m2_train["launches_per_step"][
            "depthwise_conv1d_bwd_weight"])
    # the flash pair: times at the cell's attention shape, launches from
    # the StarCoder2 training run, and the device time of one step's
    cell = fa_rows[0]
    lm_train.update(
        step_flash_fwd_kernel_ms=2 * lm_layers * cell["fwd_kernel_ms"],
        step_flash_bwd_kernel_ms=lm_layers * cell["bwd_kernel_ms"],
        step_flash_bound_ms=lm_layers * (2 * cell["fwd_bound_ms"]
                                         + cell["bwd_bound_ms"]))
    lm_train["step_flash_kernel_ms"] = (lm_train["step_flash_fwd_kernel_ms"]
                                        + lm_train["step_flash_bwd_kernel_ms"])
    print(f"starcoder2 train step: flash kernels "
          f"{lm_train['step_flash_kernel_ms']:.1f} ms of device time (bound "
          f"{lm_train['step_flash_bound_ms']:.2f} ms), step p50 "
          f"{lm_train['step_p50_ms']:.1f} ms, "
          f"{lm_train['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{lm_train['peak_memory_gb']:.2f} GB", flush=True)
    flash_entries = []
    for name, line, pas, errs in (
            ("flash_fwd", 60, "fwd", ("o", "lse")),
            ("flash_bwd", 142, "bwd", ("dq", "dk", "dv"))):
        flash_entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            launches=lm_train["launches"][name],
            max_abs_err=max(r["max_abs_err"][e] for r in fa_rows
                            for e in errs if e in r["max_abs_err"]),
            max_rel_diff=max(r["max_rel_diff"][e] for r in fa_rows
                             for e in errs if e in r["max_rel_diff"]),
            ms=cell[f"{pas}_kernel_ms"], call_ms=cell[f"{pas}_kernel_call_ms"],
            plain_ms=cell[f"{pas}_plain_ms"],
            bound_ms=cell[f"{pas}_bound_ms"],
            bound_by=cell[f"{pas}_bound_by"],
            library_ms=cell[f"{pas}_library_ms"], shape=cell["shape"],
            tflops=cell[f"{pas}_tflops"],
            bound_share=cell[f"{pas}_bound_share"],
            hgmma={k: n for k, n in hgmma.items() if k.startswith(name)},
            launches_per_step=lm_train["launches_per_step"][name]))
    flash_entries[0]["prefill"] = _prefill_entry(lm_serve, "starcoder2",
                                                 "flash_fwd", 1)
    # phase 19: Whisper's frontend convs and its encoder's attention
    row_keys = ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_share", "max_abs_err")
    wh_front = wh["frontend"]
    fwd_entry["whisper"] = dict(
        launches_per_frontend=wh_front["launches"]["conv1d_fwd"],
        launches_per_frontend_grad=wh_front["grad"]["launches"][
            "conv1d_fwd"],
        **{r["shape"].split()[1]: {k: r[k] for k in row_keys + (
            "fma_bound_ms", "fma_bound_share", "tile", "call_ms",
            "differ_share", "max_ulps")} for r in wh_front["rows"]})
    bw_entry["whisper"] = dict(
        launches_per_frontend_grad=wh_front["grad"]["launches"][
            "conv1d_bwd_weight"],
        max_rel_diff=max(v for k, v in wh_front["grad"][
            "max_rel_diff"].items() if k.endswith("_w")),
        **{r["shape"].split()[1]: {k: r[k] for k in row_keys + (
            "fma_bound_ms", "fma_bound_share", "channel_ranges")}
           for r in wh_front["bwd_weight_rows"]})
    launches_wh = wh["train"]["launches_per_step"]
    for entry, pas in zip(flash_entries, ("fwd", "bwd")):
        r = next(r for r in wh["flash_rows"] if f"{pas}_kernel_ms" in r)
        entry["whisper"] = dict(
            launches_per_train_step=launches_wh[entry["name"]],
            **{k: r.get(f"{pas}_{k}", r.get(k)) for k in (
                "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_share", "tflops")})
    flash_entries[0]["whisper"].update(
        launches_per_fill_cross_cache=wh["serve"]["fill_launches"][
            "flash_fwd"],
        launches_per_prefill=wh["serve"]["prefill_launches"]["flash_fwd"],
        launches_in_decode=wh["serve"]["decode_launches"]["flash_fwd"])
    _zb_entries(zb, dw_fwd_entry, dw_bw_entry, flash_entries,
                flash_attention._HEAD_DIMS)
    _mn_entries(mn, flash_entries)
    _ds_entries(ds, flash_entries)
    _vl_entries(vl, flash_entries)
    _ts_entries(ts, dw_fwd_entry, flash_entries)
    _fs_entries(fs, dw_fwd_entry, dw_bw_entry, flash_entries)
    _dps_entries(dps, dw_fwd_entry, flash_entries)
    _hl_entries(hl, flash_entries)
    _dr_entries(dr, dw_fwd_entry, flash_entries)
    kernels = [fwd_entry, bw_entry, dw_fwd_entry, dw_bw_entry,
               *flash_entries]
    print(f"phase times in {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{n} {v:.1f}" for n, v in phase_s.items()),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           build_each_s=build_each, ptxas=ptxas,
                           hgmma=hgmma, conv1d_fwd_loops=loop_mix,
                           bwd_weight_loops=bwd_mix,
                           kernel_checks=rows, serve=stats,
                           bwd_checks=bwd_rows, model_grad=grad_stats,
                           train=train_stats, train_profile=profile_stats,
                           dw_checks=dw_rows, mamba2_grad=m2_grad,
                           mamba2_train=m2_train, mamba2_profile=m2_profile,
                           flash_checks=fa_rows, starcoder2_grad=lm_grad,
                           starcoder2_train=lm_train,
                           starcoder2_profile=lm_prof, sweep=sweep_res,
                           lm_serve=lm_serve, dp=dp, tp=tp, telemetry=tel,
                           elastic=elastic, whisper=wh, zamba2=zb,
                           moonlight=mn, deepseek_v3=ds, internvl2=vl,
                           tp_serve=ts, fsdp=fs, dp_serve=dps,
                           head_layouts=hl, dryrun=dr,
                           phase_s=phase_s,
                           kernels=kernels),
                      f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

1. Setup: card name and power limit, torch and nvcc versions; builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
   all started together) and times the build; ptxas's registers and
   spills per entry function, and no kernel of the flash, flash backward,
   wkv6 backward and RG-LRU libraries may spill. TF32 is off for matmuls and
   cuDNN.
2. Attention kernels: each against its plain PyTorch version, fp32 and
   bf16 (flash: the split-TF32 and the wgmma route, both on the tensor
   cores), at the sweep, ragged, empty-band and tile-edge shapes (the bf16
   kernel's tiles and the fp32 kernel's, ``cases.FLASH_TF32_TILES``) of
   ``repro_torch/kernels/cases.py``, at every shape the yi-6b path gives
   it and at every call of the dense and MoE archs served in steps 10-12
   (the MoE archs' calls are nemotron-4-15b's, held once) and of
   llama3-70b's heads: turn 1, turn 2's suffix, the cold engine's prefill
   and the last decode step of each, the long-context prefill, forward and
   step, and the prefill's last 1,024 rows as a hit's call, and every call
   of steps 13-15: qwen2-vl-2b's conversation, its vision phase's prefill,
   forward and four steps, and the enc-dec phase's encoder, self- and
   cross-attention calls (not causal, Sq != Sk, G = 1 at hd 64) and its two
   decode steps (16 kv heads) (``repro_torch.launch.shapes``, from the
   configs and the turns), with
   the tolerance stated there (2e-5 fp32, 2e-2 bf16, the absolute term
   scaled to the output). Then, at full width, the last rows of a cold
   flash call must equal a hit's call from the first of them bit for bit,
   in bf16 and (at ``cases.FLASH_IDENTITY``) in fp32:
   yi-6b's (1,32,4,2560,2560,128) and Griffin's (1,10,1,2560,2560,256,
   window 2048) from 2,048 (``cases.FLASH_IDENTITY``), and each dense
   arch's and qwen2-vl-2b's cold prefill from its turn-2 hit (danube's
   4,608 rows under the window from 3,584) and the long-context prefill
   (1,32,8,10240,10240,128, window 8192) from 9,216. For each
   timed shape: kernel time, plain time,
   ``library_ms`` (``F.scaled_dot_product_attention`` on the same masked GQA
   problem, a yardstick only: the port never calls it) and the least time
   the card could take, max(operations / peak rate, bytes / 3.35 TB/s),
   with the term that binds (fp32 flash: its products at 495 / 3 = 165
   TFLOP/s in split TF32, the CUDA cores' 67 TFLOP/s bound logged beside
   it as ``cuda_cores_bound_ms``). Times rotate over copies of the inputs that
   together exceed the 50 MB L2 cache, as each layer of the model reads its
   own inputs. Each decode row also gives device time per call from the
   profiler over the same rotated loop (the calls queued behind a spin
   kernel, and read from a window whose every kernel ran a whole multiple
   of the calls), for the kernel, for SDPA and for SDPA
   given the additive mask it otherwise builds from the boolean one on
   every call (every device kernel a call launches, summed; the SDPA
   kernels by name at the main-path and floor rows), and checks that the
   kernel's 50 calls ran 50 launches of ``decode_mma_kernel`` (bf16, hd <=
   256) or ``decode_partial_kernel``. The floor row
   (``cases.DECODE_FLOOR``: one kv head, W = 64, one valid slot) gives the
   fixed cost of a call that does almost no work. Then, at the two
   main-path decode shapes and the dense archs', the bf16 kernel's device
   time per call under 16, 8, 4 and 1 chunks and under the most chunks
   whose clusters the card holds at once (the kernel's occupancy query),
   beside the plan ``split_plan`` picks, each with its clusters and how
   many the card holds at once, each plan's result held against the plain
   version.
3. yi-6b engine: full width in bf16 on random weights (``torch.Generator``
   seed 0), ``max_len`` 4096: a 2,048-token context, then the same context
   plus the 8 generated and 504 new tokens, which must reuse 2,048 tokens
   and prefill 512. Launch counters are set to 0 just before and read just
   after. A cold engine on the turn-2 prompt must give the same greedy
   tokens, and last-position logits within the bf16 kernel tolerance scaled
   by the largest logit it measures. Then a profile of a replay of turn 2,
   which must show 32 launches of ``flash_mma_kernel`` (one per layer) and
   none of the fp32 route's kernels, and 256 of ``decode_mma_kernel``
   (8 tokens x 32 layers) and none of ``decode_partial_kernel<bf16>``.
   Every profiled replay (here and in steps 6, 9 and 10) opens its
   session with ``PROFILE_LEAD`` small kernels and a spin of about 5 ms
   and is read between that spin and one after it; a window short of the launches it must show lost device
   events and is discarded, up to ``REPLAY_TRIES`` replays (each from a
   freshly stored prefix or state), and the last is judged.
4. wkv6 kernel: against ``wkv6_ref`` at every ``WKV6_*`` case (the step
   kernel's ``WKV6_STEP``, ``WKV6_FLOOR``, the time loop's slice and
   staging-chunk edges ``WKV6_SLICE``, bf16 and fp32 r/k/v) and at the
   rwkv6-1.6b path's two shapes, (1,32,1,64) per engine step and
   (1,32,2048,64) per layer of a 2,048-token prefill, both read in place
   from the model's (B,S,H,hd) layout with bf16 r/k/v as the model passes
   them (and in fp32, as earlier slices timed them), at ``|out - want| <=
   1e-4 (scale + |want|)``. Kernel, plain and bound times (bytes (2|4)·3BHS·hd
   + 4(2BHS·hd + 2BH·hd² + H·hd) at 3.35 TB/s, operations 6BHS·hd² at 67
   TFLOP/s fp32); no PyTorch call computes the recurrence, so no library
   time. Each timed row also gives device time per call (``device_ms``, as
   the decode rows: the calls behind a spin kernel, whole windows only),
   with the state cold: each call of a window reads a copy no earlier call
   of it touched, out of copies that exceed twice the L2 cache; the window
   must hold only ``wkv6_step_kernel`` (S = 1) or ``wkv6_kernel`` launches,
   ``wkv6.fwd_plan``'s one per call.
   The floor row (``WKV6_FLOOR``, one head of 32) gives a step call's fixed
   cost.
5. rwkv6-1.6b model, full width in fp32: prefill of 2,048 tokens plus one
   ``decode_step`` against a prefill of the 2,049, last-position logits
   within 5e-4; 24 wkv6 launches per call. Then the time of a bf16 prefill
   of 2,048 tokens.
6. rwkv6-1.6b engine, full width in bf16, seed 0, state-snapshot route: a
   512-token context and 8 decoded tokens, then that context, the 8 and 56
   new tokens, which must reuse 512 and feed 64; exactly (520 + 72) × 24 =
   14,208 wkv6 launches and no attention launch. A cold engine must give
   turn 2's tokens, last-position logits within 2e-2 × max |logit|. Peak
   memory, and a profile of a replay of turn 2 from the stored state, which
   must show 72 × 24 = 1,728 ``wkv6_step_kernel`` launches and no
   ``wkv6_kernel``, and logs device kernels per fed or decoded token.
7. rglru kernels: the scan in fp32 against ``rglru_scan_ref`` at every
   ``RGLRU_*`` scan case (the reference's sweep, D 2,560 at S 1 and 2,560,
   D 77, two channel blocks, strided rows, the forward's 128-step chunk
   edges ``RGLRU_CHUNK``, S 0, the floor) and at the training shape
   (1,8192,2560), at ``|out - want| <= 1e-5 (scale + |want|)``, the timed
   rows two calls the same bits; the fused step against
   ``rglru_step_ref`` at every ``RGLRU_STEP`` case, ``h'`` at 1e-5 and ``y``
   at 1e-5 (fp32) or 2e-2 (bf16). Kernel, plain, bound and device times (as
   wkv6's, state cold) of the scan at (1,2560,2560) per recurrent layer of a
   2,560-token prefill, at (1,1,2560), at the floor (1,1,32) and at the
   training shape (1,8192,2560) (bytes 4(3BSD + 2BD) at 3.35 TB/s; the
   device window holds ``rglru.scan_plan``'s kernels a call,
   ``rglru_fwd_carry_kernel`` past one chunk and ``rglru_fwd_kernel``,
   split by kernel); of the fused step at (1,2560) bf16 per
   recurrent layer and engine step and at (1,32) (bytes 4(7BD) + 2·2BD),
   beside the device time of its plain version, the PyTorch chain it
   replaces on the step. No PyTorch call computes either, so no library
   time.
   Griffin's attention shapes (10 query heads on one kv head of 256, window
   2048) run in phase 2 (``FLASH_GRIFFIN``, ``DECODE_GRIFFIN`` and the
   engine's last decode step).
8. recurrentgemma-2b model, full width in fp32 (26 layers: 8 units of rec,
   rec, local attention and 2 tail rec layers): prefill of 2,560 tokens
   plus one ``decode_step`` against a ``forward`` of the 2,561,
   last-position logits within 5e-4. 2,560 passes the 2,048 window, so the
   window masks keys in flash, the ring wraps and the step reads a wrapped
   ring. Exactly 18 rglru scan and 8 flash launches per prefill or forward,
   18 fused rglru steps and 8 decode launches per step. Then the time of a
   bf16 prefill of 2,560 tokens.
9. recurrentgemma-2b engine, full width in bf16, seed 0, state-snapshot
   route, ``max_len`` 1024: as step 6, with exactly (520 + 72) × 18 =
   10,656 fused rglru steps (``rglru_step``) and (520 + 72) × 8 = 4,736
   decode-attention launches and no flash, rglru scan or wkv6 launch; a
   cold engine, peak memory, the snapshot's bytes and a profiled replay of
   turn 2, which must show (64 + 8) x 8 = 576 launches of
   ``decode_mma_kernel`` and none of ``decode_partial_kernel<bf16>``, 72 ×
   18 = 1,296 of ``rglru_step_kernel`` and none of the scan's
   ``rglru_fwd_*`` kernels, and
   logs device kernels per fed or decoded token.
10. Dense engines, after the recurrent ones, as step 3, each freed before
   the next, with its peak memory: llama3-8b (rope theta 500,000; 32/8
   heads) and h2o-danube-1.8b (32/8 heads of 80, window 4096; 3,584 context
   tokens, then those + 8 + 1,016, ``max_len`` 8192: the ring holds 4,096
   slots, turn 2 reuses 3,584, and its 4,608-token prompt passes the
   window, so the window masks keys in the suffix prefill and the decode
   reads a wrapped ring) with the profiled replay; minitron-8b and
   nemotron-4-15b (squared-ReLU MLPs, not gated; 48/8 heads) without it.
   llama3-70b does not fit the card and runs only as kernel rows.
11. MoE phases, dbrx-132b (16 experts top-4, d_ff 10,752) then
   grok-1-314b (8 top-2, d_ff 32,768, tanh gelu), each at every published
   width with its depth cut to ``serve.FULL_DEPTH`` (8 of 40 and 5 of 64
   layers: 54.6 and 52.4 GB of bf16 weights), seed 0, TF32 off for the
   fp32 router product, no profiled replay. (a) One layer's ``moe_ffn`` on
   a seeded (1,512,6144) bf16 input at capacity factor E/K, where nothing
   drops (|dropped_frac| <= 1e-6), against ``moe_ffn_ref`` within 2e-2 x
   max |y_ref|; its drops and times at the published 1.25 and for one
   token. (b) nemotron-4-15b's conversation at the published capacity:
   reuse 2,048 / 512, exactly 2·L flash and 2·8·L decode launches, finite
   logits; each prefill's drops (mean and max over layers), peak memory
   and times; a cold engine on the same weights, logged and not held to
   the hit (a hit's suffix prefill drops other assignments than the cold
   prefill, in the reference too). (c) The same weights at capacity factor
   E/K: nothing drops, and hit and cold must give the same tokens and
   last-position logits within step 3's limit.
12. llama3-8b long-context model phase, full width in bf16, then on the
   same weights in fp32: ``prefill(..., long_context=True)`` of 10,240 tokens with
   ``max_len`` 12,288 into a ring of 8,192 slots, one ``decode_step(...,
   long_context=True)`` on the wrapped ring, held against ``forward(...,
   long_context=True)`` on the 10,241 tokens, last-position logits within
   2e-2 x max |logit| in bf16 (step 3's limit) and 5e-4 in fp32 (steps 5
   and 8's); exactly 32 flash launches per prefill and forward and 32
   decode launches per step. In bf16 both sides round every GEMM and
   attention output to bf16 in other orders (M = 1 against 10,241), which
   moves the logits by about that limit on its own (logged: each bf16 side
   against the fp32 forward); the fp32 run is the sharper check.
13. qwen2-vl-2b engine (28 layers, d_model 1536, 12/2 heads of 128), full
   width in bf16, seed 0, yi-6b's conversation on the token path, as the
   reference's engine serves it: as step 3, with exactly 56 flash and 448
   decode launches and no profiled replay; the log says whether the cold
   engine's logits equal the hit's bit for bit.
14. qwen2-vl-2b vision model phase, full width in bf16, then on the same
   weights in fp32: ``patches`` (1, 1024, 1536) at scale 0.02 (numpy, seed
   1) and 2,048 text tokens, M-RoPE ids in Qwen2-VL's layout for one image
   of 32 x 32 patches (patch i at (0, i // 32, i % 32), text token j at 32
   + j in all three; ``shapes.vision_positions``); ``prefill`` (``max_len``
   4096), then 4 ``decode_step``s with the layout's ids passed explicitly,
   the last held against ``forward`` on the 3,076-token batch: within 2e-2 x
   max |logit| in bf16 and 5e-4 in fp32 (step 12's limits), each bf16 side
   logged against the fp32 forward; exactly 28 flash launches per prefill
   and forward and 28 decode launches per step.
15. seamless-m4t-large-v2 model phase (12 encoder and 12 decoder layers,
   d_model 1024, 16/16 heads of 64), full width in bf16 then fp32:
   ``frames`` (1, 1024, 1024) at scale 0.02 and 512 target tokens,
   ``max_len`` 1024; ``prefill``, 8 ``decode_step``s, the last against
   ``forward`` on the 520 tokens, as step 14; exactly 36 flash launches per
   prefill and forward (12 encoder, 12 self, 12 cross) and 24 decode
   launches per step (12 self over the ring, 12 cross over every frame).
   The engine serves no enc-dec model, as the reference's cannot.
16. Flash backward kernels (after step 7, before any engine), fp32 and
   bf16: the training entry (``ops.flash_attention_train``) at every
   ``cases.FLASH_BWD``, ``cases.FLASH_IDENTITY`` and
   ``cases.FLASH_BWD_TRAIN`` case, its output equal
   to the serving entry's bit for bit and its lse within ``cases.TOL`` of
   the plain version's (``check_flash_train``); ``check_flash_bwd`` at every
   ``cases.FLASH_BWD`` case (the forward's sweep, ragged, empty-band and
   tile-edge cases, and the edges of the backward's own tiles) and at the
   training shapes ``cases.FLASH_BWD_TRAIN`` (h2o-danube-1.8b
   (1,32,8,8192,8192,80, window 4096), yi-6b (1,32,4,4096,4096,128), the
   100M twin's (4,4,4,256,256,192), an enc-dec cross-attention
   (1,16,16,512,1024,64, not causal), recurrentgemma-2b's
   (1,10,1,8192,8192,256, window 2048)): dq, dk and dv through autograd of
   ``ops.flash_attention`` against ``ref.flash_attention_bwd_ref`` within
   ``cases.TOL``; and at all of them two backward calls on the same inputs
   give the same bits (``check_flash_bwd_repeat``). At the training shapes
   also the backward entry's time (``ops.flash_attention_bwd`` alone, on
   the training entry's output and lse), the plain version's, SDPA's
   backward (``enable_gqa``, the mask explicit; a yardstick only) and the
   bound: five products of 2·hd flops per visible pair (and 2·hd·Sk per
   empty-band row) at the dtype's peak, or q, k, v, out and dout read and
   dq, dk, dv written once at 3.35 TB/s; and the training entry's time
   beside its own bound (two products; q, k, v read, the output and lse
   written) and SDPA's forward (``enable_gqa``, the mask explicit, no
   grad; a yardstick only: ``train_fwd_library_ms``; in fp32 the products
   at 165 TFLOP/s, the 67 TFLOP/s bound beside it as
   ``train_fwd_cuda_cores_bound_ms``). At the 100M twin's and the enc-dec
   cross's shapes, right after those rows (before any profile with host
   activity: a run that read these windows after the training phases'
   profiles recorded nothing in ten sessions), a profiler window of five fp32 training-entry calls must hold only
   ``flash_tf32_split_kernel`` and ``flash_tf32_kernel`` launches, one
   each a call; its device time per call and that of a window of SDPA's
   fp32 forward join the shape's row (``train_fwd_device_ms``,
   ``train_fwd_library_device_ms``): at these shapes the event times are
   the host's. bf16 runs on the
   tensor cores at every hd: ``flash_bwd_dq_mma_kernel`` and
   ``flash_bwd_dkdv_mma_kernel`` up to hd 128, ``flash_bwd_dq_wide_kernel``
   and ``flash_bwd_dkdv_wide_kernel`` above (recurrentgemma-2b's hd 256,
   the 100M twin's 192); fp32 on the tensor cores in split-TF32 products at
   every hd, ``flash_bwd_dq_tf32_kernel`` and ``flash_bwd_dkdv_tf32_kernel``,
   whose bound takes the products at 495 / 3 = 165 TFLOP/s (three TF32
   products each; the 67 TFLOP/s of fp32 FMA logged beside it, the bound
   before the route moved). Where ``bwd_blocks`` has
   a dK/dV block that ``bwd_keys`` did not choose for the mask (hd <= 128),
   it is held against the plain version and timed too, beside the chosen
   one.
17. The 100M twin (``repro_torch.launch.train_100m``, after step 15): yi-6b
   reduced to 12 layers of d_model 768, batch 4 x 256, fp32, 300 steps; the
   mean of the last 10 losses must be below that of the first 10, with
   exactly 12 x 2 flash launches (the forward and remat's recompute) and 12
   backward calls per step.
18. h2o-danube-1.8b training at every published width and full depth: bf16
   weights from ``init_train_state`` (seed 0), batch 1 x 8,192 tokens from
   ``batch_iterator`` (the window binds in the forward and the backward),
   three steps; finite loss and grad norm, the weights moved, exactly 48
   flash and 24 backward launches per step, time per step and peak memory.
   Step 1 runs under the profiler, one whole window (step 2 if step 1's
   window did not record every flash kernel): device time by class of
   kernel (flash forward, flash backward, GEMMs by name, the optimizer's
   kernels, those ``adamw_update`` launched, and the rest) and the idle
   share; the bf16 backward must show as ``flash_bwd_dq_mma_kernel`` and
   ``flash_bwd_dkdv_mma_kernel``.
19. One h2o-danube-1.8b attention layer at 8,192 tokens in fp32: the
   gradients of its weights and input through the kernels, then through
   the plain versions (``ops.flash_attention`` swapped for
   ``ref.flash_attention_ref`` for that call only: the oracle, not the
   path), each within ``LAYER_GRAD_TOL`` x its largest entry.
20. wkv6 backward (after step 16, before any engine): the training entry
   (``ops.wkv6_train``) at every ``WKV6_*`` forward case and at rwkv6-1.6b's
   training shape ``cases.WKV6_BWD_TRAIN`` (1,32,4096,64, bf16 r/k/v), its
   y and s_n the serving entry's bit for bit and its checkpoints within
   ``WKV6_TOL`` of ``ref.wkv6_train_ref``'s, and the serving entry's y and
   s_n within ``WKV6_TOL`` of the plain version's at the training shape;
   at every ``cases.WKV6_BWD``
   case and the training shape, dr, dk, dv, dw, du and ds0 through autograd
   of ``ops.wkv6`` against ``ref.wkv6_bwd_ref`` (fp32 gradients within
   ``WKV6_TOL``, bf16 ones within ``TOL[bf16]``), and two backward calls
   the same bits. At the training shape: the backward entry's time alone,
   the plain version's, the device time per call with the inputs cold, and
   the bound (14·hd² fp32 operations per (b, h, t) at 67 TFLOP/s, or the
   bytes at 3.35 TB/s); the training entry's time and bound (the serving
   entry's bytes and the checkpoints, or 6·hd² operations per (b, h, t))
   beside the serving entry's time. No PyTorch call computes this
   gradient: no library time. The device time is split by kernel
   (``wkv6.bwd_plan`` launches a call: ``wkv6_bwd_kernel``, slices
   of rows, then ``wkv6_bwd_dv_kernel``, the sum of dv's partials).
21. rglru backward (after step 20): ``ops.rglru_scan_bwd`` through
   autograd of ``ops.rglru_scan`` against ``ref.rglru_scan_bwd_ref`` at
   every ``cases.RGLRU_BWD`` case and at ``RGLRU_BWD_TRAIN`` (1,8192,2560),
   within ``RGLRU_TOL``, two calls the same bits; at the training shape the
   same times and bound (bytes 4·(5·BSD + 2·BD) at 3.35 TB/s), the device
   time split by kernel (``rglru.bwd_plan`` launches a call: the
   carry pass ``rglru_bwd_carry_kernel`` past one chunk, then
   ``rglru_bwd_kernel``), and the scan's time and bound at that shape.
22. rwkv6-1.6b training at every published width and full depth (after
   step 19), as step 18: bf16 weights from ``init_train_state`` (seed 0),
   batch 1 x 4,096 tokens, three steps; finite loss and grad norm, the
   weights moved, exactly 48 wkv6 training-entry launches (the forward and
   remat's recompute) and 24 ``wkv6_bwd`` calls per step, peak memory
   under 80 GB; step 1 profiled, with the ``wkv6 backward`` (both of its
   kernels, two device launches a call) and ``wkv6 forward`` classes.
23. recurrentgemma-2b training, the same at 1 x 8,192 tokens (its 2,048
   window binds): exactly 36 rglru scans, 18 ``rglru_scan_bwd``, 16 flash
   and 8 flash backward calls per step (at hd 256 the backward runs the
   wide tensor-core kernels ``flash_bwd_dq_wide_kernel`` and
   ``flash_bwd_dkdv_wide_kernel``); the ``rglru backward`` class (both of
   its kernels, two device launches a call) and the ``rglru scan`` class
   (``rglru_fwd_carry_kernel`` and ``rglru_fwd_kernel``, two a call) in
   the profile. No bf16 step may show an fp32 backward kernel
   (``flash_bwd_dq_tf32_kernel``, ``flash_bwd_dkdv_tf32_kernel``).
24. One layer's gradients through the kernels against the plain versions,
   fp32, as step 19: an rwkv6-1.6b time-mix at 4,096 tokens
   (``ops.wkv6`` swapped for ``ref.wkv6_ref``) and a Griffin recurrent
   block at 8,192 (``ops.rglru_scan`` for ``ref.rglru_scan_ref``).
25. GreenCache profile and solve: the simulator's profile-and-solve path
   (host NumPy code, no kernel: every kernel's count must stay 0) at
   ``repro/launch/serve.py``'s paper settings. ``run_profiler`` measures
   the simulated llama3-70b (``SERVING_MODELS``) serving chat and
   documents (Zipf 0.4) at rates 0.2-1.6 req/s, caches of 0-16 TB, warm-up
   12,000 prompts; ``solve_cache_schedule`` sizes the cache for the 24
   hours of ``azure_rate_trace(1.6, seed=3)`` and ``ci_trace("FR",
   seed=4)`` against the task's ``SLOS`` entry with the exact DP
   (``solver=dp``, as the reference's wherever ``pulp`` is absent). It
   fails unless (a) the vectorised ``_solve_dp`` equals the loop
   ``_solve_dp_reference`` bit for bit on the day's tables, exhaustive and
   pruned, (b) every chosen size is on the grid, (c) a feasible schedule
   meets sum n F >= rho sum n - sum n / 400 (the DP's bucket), (d) every
   size-0 cell has a hit rate of 0, and (e) the cell (1.0, 8 TB) profiled
   again gives the same bits. It logs the hourly sizes, the objective,
   hit rate and SLO share at 0, 4 and 16 TB at rate 1.0, and each
   profile's and solve's wall time on the host beside the card line.
26. Prints a ``kernels`` JSON line (every kernel's entry; decode's with
   ``library_device_ms`` and ``library_premasked_device_ms``; decode's,
   wkv6's, the rglru kernels' and the two recurrent backwards' with
   ``device_ms``; the fused step's with ``plain_device_ms``), the card
   line, and last ``{"ok": true, "device": {...}}``. Every kernel must
   have launched on its main path: flash, decode on yi-6b; wkv6 on
   rwkv6-1.6b's engine; the fused rglru step on recurrentgemma-2b's engine;
   the rglru scan in that model's prefill and forward (the engine feeds
   every token by steps); the flash backward in h2o-danube-1.8b's training;
   ``wkv6_bwd`` in rwkv6-1.6b's and ``rglru_scan_bwd`` in
   recurrentgemma-2b's training.

Steps 4, 7, 16, 20 and 21 run right after step 2, before any engine: after
the yi-6b replay's profile (host and device activity), every profiler
window of the wkv6 rows lost one launch.

Any failure raises and exits non-zero. Without a card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES = 3.35e12                      # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core bf16
            torch.float32: 67e12}         # fp32 outside the tensor cores
# the fp32 flash forward's and backward's products: three TF32 products each
# on the tensor cores (495 TFLOP/s dense TF32)
PEAK_SPLIT_TF32 = 495e12 / 3
PROFILE_LEAD = 64                         # small kernels ahead of a profiled window
L2_BYTES = 50e6
DTYPES = (torch.float32, torch.bfloat16)
SOURCES = {"flash_attention": "src/repro/kernels/flash_attention.py:106",
           "decode_attention": "src/repro/kernels/decode_attention.py:77",
           "rglru_scan": "src/repro/kernels/rglru.py:38",
           # the same Pallas kernel at S = 1, with the step's elementwise
           # chain (repro/models/griffin.py::rglru_step) fused in
           "rglru_step": "src/repro/kernels/rglru.py:38",
           "wkv6": "src/repro/kernels/wkv6.py:55",
           # no Pallas kernel: the reference takes this gradient by autodiff
           # of its jnp attention (repro/models/common.py, _attend)
           "flash_attention_bwd": "src/repro/models/common.py:167",
           # no Pallas kernel: autodiff of the reference's scans (its model
           # path's wkv_scan, and the associative_scan of its rglru_scan)
           "wkv6_bwd": "src/repro/models/rwkv6.py:91",
           "rglru_scan_bwd": "src/repro/models/griffin.py:67"}
CSRC = {"flash_attention": "flash_attention.cu", "decode_attention": "decode_attention.cu",
        "rglru_scan": "rglru_scan.cu", "rglru_step": "rglru_scan.cu", "wkv6": "wkv6.cu",
        "flash_attention_bwd": "flash_attention_bwd.cu", "wkv6_bwd": "wkv6_bwd.cu",
        "rglru_scan_bwd": "rglru_scan.cu"}
PORT_KERNELS = ("flash_mma_kernel", "flash_tf32_split_kernel", "flash_tf32_kernel",
                "decode_mma_kernel",
                "decode_partial_kernel", "rglru_fwd_carry_kernel", "rglru_fwd_kernel",
                "rglru_step_kernel",
                "wkv6_kernel", "wkv6_step_kernel", "flash_bwd_dq_tf32_kernel",
                "flash_bwd_dkdv_tf32_kernel", "flash_bwd_dq_mma_kernel",
                "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_wide_kernel",
                "flash_bwd_dkdv_wide_kernel", "wkv6_bwd_kernel",
                "wkv6_bwd_dv_kernel", "rglru_bwd_kernel",
                "rglru_bwd_carry_kernel")   # device names
REPLAY_TRIES = 3                          # profiled replays, the first whole window read
# the flash backward's device kernels by route; a bf16 call never runs the
# fp32 ones (the C entry refuses the split-TF32 route for bf16)
BWD_KERNELS = {"bf16, hd <= 128": ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel"),
               "bf16, hd 129-256": ("flash_bwd_dq_wide_kernel", "flash_bwd_dkdv_wide_kernel"),
               "fp32": ("flash_bwd_dq_tf32_kernel", "flash_bwd_dkdv_tf32_kernel")}
BF16_NEVER = BWD_KERNELS["fp32"]
# the classes of a training step's device time, by kernel name (first match)
STEP_CLASSES = (("flash backward", re.compile(r"flash_bwd_")),
                ("flash forward", re.compile(r"flash_mma_kernel|flash_tf32_")),
                ("wkv6 backward", re.compile(r"wkv6_bwd_")),
                ("wkv6 forward", re.compile(r"wkv6_kernel|wkv6_step_kernel")),
                ("rglru backward", re.compile(r"rglru_bwd_")),
                ("rglru scan", re.compile(r"rglru_fwd_")),
                ("GEMMs", re.compile(r"gemm|xmma|nvjet|cutlass", re.I)))
DECODE_BF16_OLD = "decode_partial_kernel<__nv_bfloat16"   # bf16 decode must not run it
RWKV = "rwkv6-1.6b"
RWKV_PREFILL = 2048                       # tokens of the model phase's prefill
GRIFFIN = "recurrentgemma-2b"
GRIFFIN_PREFILL = 2560                    # past the 2,048 window: the ring wraps
# the dense archs (``shapes.DENSE``) whose engine phase profiles a replay of
# turn 2; the others run without it
DENSE_PROFILED = ("llama3-8b", "h2o-danube-1.8b")
MOE_TOKENS = 512                          # tokens of the MoE module check
TRAIN = "h2o-danube-1.8b"                 # trains at full width and depth
TRAIN_TOKENS = 8192                       # batch 1: past the 4,096 window
TRAIN_STEPS = 3
RWKV_TRAIN_TOKENS = 4096                  # rwkv6-1.6b's training batch, 1 x 4,096
GRIFFIN_TRAIN_TOKENS = 8192               # recurrentgemma-2b's: past its 2,048 window
# one layer's gradients through the kernels against the plain versions, each
# within this times its largest entry: the fp32 model tolerance of the
# reference's test_prefill_decode_consistency (5e-4), scaled to the gradient
LAYER_GRAD_TOL = 5e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def rotated_ms(fn, sets, iters: int) -> float:
    """Mean ms of ``fn(*s)`` by CUDA events, cycling over the input sets."""
    for s in sets[:3]:
        fn(*s)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, sets, iters: int):
    """``repro_torch.launch.device_time.device_ms``: device ms per call of
    ``fn(*s)`` over the rotated sets, from whole profiler windows only."""
    from repro_torch.launch.device_time import device_ms as window_ms
    return window_ms(fn, sets, iters, log=log)


def copies(tensors, limit: int = 16):
    """Clones of the inputs, enough of them to exceed twice the L2 cache
    (at most ``limit``). A clone keeps its tensor's strides."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, min(limit, math.ceil(2 * L2_BYTES / nbytes)))
    return [tensors] + [[t.clone() for t in tensors] for _ in range(n - 1)]


def cold_device_ms(fn, inputs, want=None, iters: int = 20, kernels: int = 1,
                   split=None) -> float:
    """Device ms per call of ``fn`` on ``inputs`` with its inputs cold: a
    ``device_ms`` window of ``iters`` calls, each on a copy that no call of
    the window touched before, out of copies that exceed twice the L2 cache
    (up to 2,048 of them: the floor rows' copies stay in L2). The window is
    short enough for the host to queue every call behind the spin kernel.
    With ``want``, the window must hold ``kernels`` launches per call, all
    of kernels whose name holds it; ``split``, a dict, receives each
    kernel's (launches, ms per call)."""
    sets = copies(inputs, limit=2048)
    dev, calls = device_ms(fn, sets, iters)
    if want is not None and (sum(c for c, _ in calls.values()) != kernels * iters
                             or not all(want in n for n in calls)):
        raise AssertionError(f"device launches {calls}, want {kernels * iters} of {want}")
    if split is not None:
        split.update(calls)
    return dev


def zero_counts(ops):
    for name in SOURCES:
        getattr(ops, name).launches = 0


def read_counts(ops):
    return {name: getattr(ops, name).launches for name in SOURCES}


def launched(ops, fn):
    """(fn(), the launches it made by kernel)."""
    before = read_counts(ops)
    out = fn()
    return out, {n: c - before[n] for n, c in read_counts(ops).items()}


def per_token(cfg):
    """Launches per fed or decoded token through ``decode_step``."""
    from repro_torch.models.transformer import griffin_layout
    if cfg.family == "ssm":
        return dict({n: 0 for n in SOURCES}, wkv6=cfg.num_layers)
    units, tail = griffin_layout(cfg)
    return dict({n: 0 for n in SOURCES}, decode_attention=units, rglru_step=2 * units + tail)


def tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(t) for t in tree.values())
    return tree.numel() * tree.element_size()


def entry_spills(ptxas_log: str):
    """{entry function: (spill store bytes, spill load bytes)} from ptxas -v."""
    spills, fn = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
    return spills


def bound(ops_n: float, nbytes: float, dtype, peak=None):
    t_ops, t_bytes = ops_n / (peak or PEAK_OPS[dtype]), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def flash_bounds(ops_n: float, nbytes: float, dtype, prefix: str = ""):
    """A flash route's bound as {prefix + "bound_ms", prefix + "bound_by"}:
    fp32 products at the split-TF32 rate, with the CUDA cores' bound (the
    one before the fp32 routes moved to the tensor cores) beside it as
    prefix + "cuda_cores_bound_ms"."""
    split = dtype == torch.float32
    ms, by = bound(ops_n, nbytes, dtype, PEAK_SPLIT_TF32 if split else None)
    out = {"bound_ms": ms, "bound_by": by}
    if split:
        out["cuda_cores_bound_ms"] = bound(ops_n, nbytes, dtype)[0]
    return {prefix + k: v for k, v in out.items()}


def bound_text(r, prefix: str = "") -> str:
    """The log's words for ``flash_bounds``' entries in ``r``."""
    text = f"bound {r[prefix + 'bound_ms']:.6f} ms ({r[prefix + 'bound_by']}"
    if prefix + "cuda_cores_bound_ms" in r:
        text += (f"; products at {PEAK_SPLIT_TF32 / 1e12:.0f} TFLOP/s in split TF32, "
                 f"{r[prefix + 'cuda_cores_bound_ms']:.6f} ms at "
                 f"{PEAK_OPS[torch.float32] / 1e12:.0f} TFLOP/s of fp32 FMA")
    return text + ")"


# --------------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------------- #

def flash_mask(case):
    """The (Sq, Sk) boolean mask of a flash case, for SDPA."""
    from repro_torch.kernels import ref
    B, H, KV, Sq, Sk, hd, off, win, causal = case
    return ref.flash_mask(Sq, Sk, off, causal, win, "cuda")


def flash_row(ops, ref, cases, case, dtype):
    err, (q, k, v) = cases.check_flash(case, dtype, "cuda")
    B, H, KV, Sq, Sk, hd, off, win, causal = case
    mask = flash_mask(case)
    kw = dict(q_offset=off, window=win, causal=causal)
    sets = copies([q, k, v])
    ms = rotated_ms(lambda *t: ops.flash_attention(*t, **kw), sets, 20)
    plain = rotated_ms(lambda *t: ref.flash_attention_ref(*t, **kw), sets, 10)
    lib = rotated_ms(lambda *t: F.scaled_dot_product_attention(
        *t, attn_mask=mask, enable_gqa=True), sets, 20)
    pairs, empty = cases.flash_visible(case)
    ops_n = B * H * (4 * hd * pairs + 2 * hd * Sk * empty)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                **flash_bounds(ops_n, nbytes, dtype))


def decode_row(ops, ref, cases, case, dtype):
    err, (q, k, v, valid) = cases.check_decode(case, dtype, "cuda")
    B, H, KV, W, hd, nvalid, _ = case[:7]
    mask = valid.bool()[None, None, None, :]
    # the additive mask SDPA builds from the boolean one on every call
    addmask = torch.zeros(mask.shape, dtype=dtype, device="cuda").masked_fill(
        ~mask, float("-inf"))
    sets = copies([q, k, v, valid])

    def sdpa(q_, k_, v_, _):
        return F.scaled_dot_product_attention(q_[:, :, None], k_, v_, attn_mask=mask,
                                              enable_gqa=True)

    def sdpa_premasked(q_, k_, v_, _):
        return F.scaled_dot_product_attention(q_[:, :, None], k_, v_, attn_mask=addmask,
                                              enable_gqa=True)

    # SDPA's fused kernels take no view that starts off a 16-byte boundary
    # (cases.DECODE_RAGGED's storage offset 1): it gets clones (same strides)
    lib_sets = [[t.clone() for t in sets[0]]] + sets[1:]
    ms = rotated_ms(ops.decode_attention, sets, 50)
    plain = rotated_ms(ref.decode_attention_ref, sets, 20)
    lib = rotated_ms(sdpa, lib_sets, 50)
    dev, calls = device_ms(ops.decode_attention, sets, 50)
    lib_dev, lib_calls = device_ms(sdpa, lib_sets, 50)
    pre_dev, pre_calls = device_ms(sdpa_premasked, lib_sets, 50)
    # one device kernel per call: the tensor-core kernel for bf16 up to hd 256
    want = "decode_mma_kernel" if dtype == torch.bfloat16 and hd <= 256 else \
        "decode_partial_kernel"
    if sum(c for c, _ in calls.values()) != 50 or not all(want in n for n in calls):
        raise AssertionError(f"decode {case} {dtype}: device launches {calls}, want "
                             f"50 of {want}")
    slots = nvalid or W                   # no valid slot: the mean of all W
    ops_n = B * H * (4 if nvalid else 2) * hd * slots
    nbytes = q.element_size() * (2 * q.numel() + 2 * B * KV * slots * hd) + 4 * W
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, device_ms=dev,
                library_device_ms=lib_dev, library_premasked_device_ms=pre_dev,
                library_kernels={"sdpa": lib_calls, "sdpa premasked": pre_calls},
                **dict(zip(("bound_ms", "bound_by"), bound(ops_n, nbytes, dtype))))


def plan_sweep(cases, dmod, shapes):
    """Device ms per call of the bf16 kernel at each main-path decode shape
    (``shapes``: the dense archs' too) under every plan a cluster allows
    with 16, 8, 4 and 1 chunks and the most chunks whose clusters the card
    holds at once (``dmod.occupancy``), beside the plan ``split_plan``
    picks, each with the call's clusters and how many the card holds at
    once; each plan's result held against the plain version. The plan is
    forced by standing in for ``split_plan``."""
    pick = dmod.split_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for case in shapes:
            B, H, KV, W = case[:4]
            q, k, v, valid = cases.decode_inputs(case, torch.bfloat16, "cuda", seed=5)
            want = dmod.ref.decode_attention_ref(q, k, v, valid)
            sets = copies([q, k, v, valid])
            tiles = -(-W // dmod.TILE)
            plans = {n: (-(-tiles // -(-tiles // n)), -(-tiles // n) * dmod.TILE)
                     for n in range(16, 0, -1)}

            def fits(plan):
                clusters, at_once = dmod.occupancy(q, k, *plan)
                return clusters <= at_once

            widest = next(p for p in plans.values() if p[0] == 1 or fits(p))
            picked = pick(B, KV, W, sms)
            for nsplit, chunk in sorted({plans[n] for n in (16, 8, 4, 1)} | {widest},
                                        reverse=True):
                dmod.split_plan = lambda *_: (nsplit, chunk)
                cases.held("decode plan", case, dmod.decode_attention(q, k, v, valid), want)
                dev, _ = device_ms(dmod.decode_attention, sets, 50)
                clusters, at_once = dmod.occupancy(q, k, nsplit, chunk)
                mark = " (split_plan's)" if picked == (nsplit, chunk) else ""
                log(f"decode bfloat16 {case} plan {nsplit} x {chunk} slots{mark}: "
                    f"{clusters} clusters, {at_once} at once; device per call {dev:.5f} ms")
    finally:
        dmod.split_plan = pick


def kernels_phase(ops, ref, cases, flash_main, decode_main):
    """All rows, keyed by (kernel, dtype, label)."""
    rows = {}
    for dtype in DTYPES:
        for group, table in (("sweep", cases.FLASH_SWEEP), ("ragged", cases.FLASH_RAGGED),
                             ("empty band", cases.FLASH_EMPTY_BAND),
                             ("griffin", cases.FLASH_GRIFFIN), ("tiles", cases.FLASH_TILES),
                             ("tf32 tiles", cases.FLASH_TF32_TILES)):
            for i, case in enumerate(table):
                rows[("flash_attention", dtype, f"{group} {i}")] = (
                    case, flash_row(ops, ref, cases, case, dtype))
        for label, case in flash_main.items():
            rows[("flash_attention", dtype, label)] = (
                case, flash_row(ops, ref, cases, case, dtype))
        for group, table in (("sweep", cases.DECODE_SWEEP), ("ragged", cases.DECODE_RAGGED),
                             ("griffin", cases.DECODE_GRIFFIN), ("floor", cases.DECODE_FLOOR)):
            for i, case in enumerate(table):
                rows[("decode_attention", dtype, f"{group} {i}")] = (
                    case, decode_row(ops, ref, cases, case, dtype))
        for label, case in decode_main.items():
            rows[("decode_attention", dtype, label)] = (
                case, decode_row(ops, ref, cases, case, dtype))
    for (name, dtype, label), (case, r) in rows.items():
        device = ""
        if "device_ms" in r:
            device = (f"; device per call: kernel {r['device_ms']:.5f} ms, "
                      f"sdpa {r['library_device_ms']:.5f} ms, sdpa with its mask "
                      f"precomputed {r['library_premasked_device_ms']:.5f} ms")
        log(f"{name} {str(dtype)[6:]} {label} {case}: max |err| {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"sdpa {r['library_ms']:.5f} ms, {bound_text(r)}{device}")
        if name == "decode_attention" and dtype == torch.bfloat16 and \
                (label.startswith("floor") or case in decode_main.values()):
            for which, calls in r["library_kernels"].items():
                for kname, (n, kms) in calls.items():
                    log(f"  {which}: {n} launches, {kms:.5f} ms per call  {kname[:90]}")
    return rows


def flash_bwd_row(ops, ref, cases, case, dtype):
    """The backward at a training shape: held (``check_flash_bwd``), two
    calls the same bits (``check_flash_bwd_repeat``), then timed by events
    on the training entry's output and lse: the backward entry alone, the
    plain version, SDPA's backward; on the tensor-core route also the entry
    with the dK/dV block of ``bwd_blocks`` that ``bwd_keys`` did not
    choose, where there is one, held and timed; the training entry and
    SDPA's forward."""
    from repro_torch.kernels.flash_attention import bwd_blocks, bwd_keys, bwd_route
    err, (q, k, v, _, dout) = cases.check_flash_bwd(case, dtype, "cuda")
    cases.check_flash_bwd_repeat(case, dtype, "cuda")
    B, H, KV, Sq, Sk, hd, off, win, causal = case
    kw = dict(q_offset=off, window=win, causal=causal)
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    sets = copies([q, k, v, out, dout], limit=4)
    ms = rotated_ms(lambda *t: ops.flash_attention_bwd(*t, lse=lse, **kw), sets, 5)
    plain = rotated_ms(lambda q, k, v, out, dout: ref.flash_attention_bwd_ref(
        q, k, v, dout, **kw), sets[:1], 2)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=flash_mask(case), enable_gqa=True)
    lib = rotated_ms(lambda g: torch.autograd.grad(o, leaves, g, retain_graph=True),
                     [[dout]], 5)
    del o, leaves
    other = {}
    others = [n for n in bwd_blocks(hd) if n != bwd_keys(causal, win, hd)]
    if bwd_route(dtype, hd) == "tensor cores" and others:   # the block bwd_keys did not choose
        keys = others[0]
        other = dict(other_keys=keys, other_err=cases.check_flash_bwd_keys(case, keys, "cuda"),
                     other_ms=rotated_ms(lambda *t: ops.flash_attention_bwd(
                         *t, lse=lse, keys=keys, **kw), sets, 5))
    pairs, empty = cases.flash_visible(case)
    ops_n = B * H * (5 * 2 * hd * pairs + 2 * hd * Sk * empty)
    nbytes = q.element_size() * 4 * (q.numel() + k.numel())   # in: q k v out dout; out: dq dk dv
    # the training entry (the forward that saves lse) at the same shape: two
    # products, q, k, v read and the output and lse written once
    fwd_ms = rotated_ms(lambda q, k, v, *_: ops.flash_attention_train(q, k, v, **kw), sets, 5)
    mask = flash_mask(case)
    with torch.no_grad():
        fwd_lib = rotated_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), sets, 5)
    fwd_ops = B * H * (4 * hd * pairs + 2 * hd * Sk * empty)
    fwd_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * Sq
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **other,
                train_fwd_ms=fwd_ms, train_fwd_library_ms=fwd_lib,
                **flash_bounds(fwd_ops, fwd_bytes, dtype, "train_fwd_"),
                **flash_bounds(ops_n, nbytes, dtype))


def fwd_device_phase(ops, cases, rows, iters: int = 5):
    """Step 16's fp32 training-entry windows, run before any profile with
    host activity: at the 100M twin's and the enc-dec cross's shapes a profiler
    window of ``iters`` fp32 training-entry calls must hold ``iters``
    launches each of ``flash_tf32_split_kernel`` and ``flash_tf32_kernel``
    and no other kernel (no bf16 flash kernel), as ``check_decode_calls``
    checks decode. Its device time per call, and that of a window of SDPA's
    fp32 forward on the same inputs, join the shape's fp32 row in ``rows``."""
    for label in ("100M twin", "enc-dec cross"):
        case = cases.FLASH_BWD_TRAIN[label]
        q, k, v = cases.flash_inputs(case, torch.float32, "cuda")
        kw = dict(q_offset=case[6], window=case[7], causal=case[8])
        mask = flash_mask(case)
        dev, calls = device_ms(lambda q, k, v: ops.flash_attention_train(q, k, v, **kw),
                               [[q, k, v]], iters)
        for want in ("flash_tf32_split_kernel", "flash_tf32_kernel<"):
            if sum(c for n, (c, _) in calls.items() if want in n) != iters:
                raise AssertionError(f"flash_attention_train float32 {case}: device launches "
                                     f"{calls}, want {iters} of {want}")
        if sum(c for c, _ in calls.values()) != 2 * iters:
            raise AssertionError(f"flash_attention_train float32 {case}: device launches "
                                 f"{calls}, want only the two fp32 kernels")
        with torch.no_grad():
            lib_dev, _ = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), [[q, k, v]], iters)
        rows[(torch.float32, label)].update(train_fwd_device_ms=dev,
                                            train_fwd_library_device_ms=lib_dev)
        log(f"flash_attention_train float32 {label} {case}: a profiler window of {iters} calls "
            f"ran only the fp32 route's kernels; device per call {dev:.5f} ms ("
            + ", ".join(f"{n[:48]} {c} launches {t:.5f} ms" for n, (c, t) in calls.items())
            + f"), sdpa forward {lib_dev:.5f} ms")


def flash_bwd_phase(ops, ref, cases):
    """Step 16: the training entry and every backward case checked, the
    training shapes timed."""
    from repro_torch.kernels.flash_attention import bwd_route
    rows = {}
    for dtype in DTYPES:
        for case in (cases.FLASH_BWD + [c for c, _ in cases.FLASH_IDENTITY]
                     + list(cases.FLASH_BWD_TRAIN.values())):
            err = cases.check_flash_train(case, dtype, "cuda")
            torch.cuda.empty_cache()
            log(f"flash_attention_train {str(dtype)[6:]} {case}: the serving entry's output "
                f"bit for bit; lse max |err| {err:.3e}")
        for case in cases.FLASH_BWD:
            err, _ = cases.check_flash_bwd(case, dtype, "cuda")
            cases.check_flash_bwd_repeat(case, dtype, "cuda")
            log(f"flash_attention_bwd {str(dtype)[6:]} {case} ({bwd_route(dtype, case[5])}): "
                f"max |err| {err:.3e}; two calls the same bits")
        for label, case in cases.FLASH_BWD_TRAIN.items():
            r = rows[(dtype, label)] = flash_bwd_row(ops, ref, cases, case, dtype)
            torch.cuda.empty_cache()
            log(f"flash_attention_bwd {str(dtype)[6:]} {label} {case}: max |err| "
                f"{r['max_abs_err']:.3e}, kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} "
                f"ms, sdpa backward {r['library_ms']:.5f} ms, {bound_text(r)}; training "
                f"forward {r['train_fwd_ms']:.5f} ms, sdpa forward "
                f"{r['train_fwd_library_ms']:.5f} ms, {bound_text(r, 'train_fwd_')}"
                + (f"; {r['other_keys']}-key dK/dV blocks (not chosen): "
                                        f"{r['other_ms']:.5f} ms, max |err| "
                                        f"{r['other_err']:.3e}" if "other_ms" in r else ""))
    return rows


def identity_phase(cases, pairs):
    """Cold rows against a cache hit's, bit for bit, at full width: bf16 at
    every pair, fp32 also at ``cases.FLASH_IDENTITY``'s."""
    for case, first in pairs:
        for dtype in DTYPES if (case, first) in cases.FLASH_IDENTITY else (torch.bfloat16,):
            cases.check_flash_hit_rows(case, first, dtype, "cuda", seed=3)
            torch.cuda.empty_cache()
            log(f"flash {str(dtype)[6:]} {case}: rows {first}-{case[3] - 1} of the cold call "
                f"equal the hit's from q_offset {first} bit for bit")


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #

def engine_phase(serve, ops, cases, arch="yi-6b", profile=True):
    """A dense arch's two-turn conversation through the KV-prefix route at
    full width: reuse and launch counts, a cold engine against the hit, and
    with ``profile`` a profiled replay of turn 2."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, eng = serve.build_engine(arch, device="cuda")
    torch.cuda.synchronize()
    log(f"{arch} full width: {describe(cfg)}; {str(eng.dtype)[6:]} weights drawn in "
        f"{time.perf_counter() - t0:.3f} s")

    zero_counts(ops)
    ctx2, r1, r2 = serve.two_turns(cfg, eng, False)
    launches = read_counts(ops)
    check_two_turns(serve, arch, cfg, eng, ctx2, r1, r2, launches)
    log(f"{arch} peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    _, cold = serve.build_engine(arch, device="cuda", params=eng.params)
    rc = cold.generate("cold", ctx2, num_new=serve.FULL_TURNS[arch][2])
    hit_vs_cold(cases, arch, r2, rc)
    del cold, rc
    if profile:
        profile_turn2(serve, arch, eng.params, ctx2)
    return launches


def check_two_turns(serve, arch, cfg, eng, ctx2, r1, r2, launches):
    """The KV-prefix route's conversation: exact reuse and launch counts,
    finite logits and ``num_new`` tokens per turn; logs each turn."""
    ctx_len, new_len, num_new, _ = serve.FULL_TURNS[arch]
    L = cfg.num_layers
    if cfg.window_size:
        log(f"{arch} turn-2 prompt: {len(ctx2)} tokens, window {cfg.window_size}, "
            f"ring {eng.width} slots")
        if len(ctx2) <= cfg.window_size:
            raise AssertionError(f"{arch}: turn 2's prompt does not pass the window")
    if r1.reused_tokens != 0 or r2.reused_tokens != ctx_len \
            or r2.prefill_tokens_computed != num_new + new_len:
        raise AssertionError(f"reuse: turn 1 {r1.reused_tokens}, turn 2 "
                             f"{r2.reused_tokens}/{r2.prefill_tokens_computed}")
    # one flash launch per layer and prefill, one decode launch per layer and token
    if launches != seq_counts(flash=2 * L, decode=2 * num_new * L):
        raise AssertionError(f"launch counts {launches}")
    for i, r in ((1, r1), (2, r2)):
        if len(r.tokens) != num_new or r.last_logits.shape != (cfg.vocab_size,) \
                or not bool(torch.isfinite(r.last_logits).all()):
            raise AssertionError(f"turn {i}: bad output")
        log(f"{arch} turn {i}: prefill {r.prefill_tokens_computed} tokens "
            f"(reused {r.reused_tokens}) in {r.prefill_time_s * 1e3:.3f} ms; "
            f"decode {num_new} tokens in {r.decode_time_s * 1e3:.3f} ms "
            f"({r.decode_time_s / num_new * 1e3:.3f} ms/token) -> {r.tokens}")
    log(f"{arch} launches on the main path: {launches}")


def hit_vs_cold(cases, label, r2, rc):
    """A cold engine's run of the turn-2 prompt against the hit's: the same
    greedy tokens, last-position logits within the bf16 kernel tolerance
    scaled to the logits."""
    if rc.reused_tokens != 0:
        raise AssertionError("cold engine hit its empty store")
    # Hit and cold compute the same function on the same weights; they differ
    # in the kernels' shapes (Sq 512 against 2,560, so another order of fp32
    # sums) and in the cuBLAS kernels the two GEMM shapes pick, each rounding
    # to bf16. Hold them to the bf16 kernel tolerance, scaled to the logits.
    scale = float(rc.last_logits.abs().max())
    tol = cases.TOL[torch.bfloat16] * scale
    err = float((rc.last_logits - r2.last_logits).abs().max())
    same = "equal" if torch.equal(rc.last_logits, r2.last_logits) else "not equal"
    log(f"{label} hit vs cold, last-position logits: max |err| {err:.6f} (limit {tol:.6f} "
        f"= 2e-2 x max |logit| {scale:.4f}), {same} bit for bit; cold prefill "
        f"{rc.prefill_time_s * 1e3:.3f} ms for {rc.prefill_tokens_computed} tokens; "
        f"tokens {rc.tokens}")
    if rc.tokens != r2.tokens or not err <= tol:
        raise AssertionError(f"{label}: hit path and cold path disagree")


# --------------------------------------------------------------------------- #
# the MoE archs: the module at full width, the engines at the published and
# at a no-drop capacity
# --------------------------------------------------------------------------- #

def recorded_drops(moe, fn):
    """(fn(), the ``dropped_frac`` of every ``moe_ffn`` call of more than
    one token that fn made, in order: one per layer and prefill). Stands in
    for ``moe.moe_ffn`` while fn runs and reads the values after it."""
    real, drops = moe.moe_ffn, []

    def recording(params, x, cfg):
        y, aux = real(params, x, cfg)
        if x.shape[0] * x.shape[1] > 1:
            drops.append(aux["dropped_frac"])
        return y, aux

    moe.moe_ffn = recording
    try:
        out = fn()
    finally:
        moe.moe_ffn = real
    return out, [float(t) for t in drops]


def drop_line(drops) -> str:
    return f"dropped {sum(drops) / len(drops):.6f} mean, {max(drops):.6f} max over layers"


def moe_module_check(moe, tt, cases, cfg, params, nodrop: float):
    """One layer's ``moe_ffn`` at full width on a seeded (1, MOE_TOKENS, d)
    bf16 input: at capacity factor ``nodrop`` nothing drops and it must
    agree with ``moe_ffn_ref`` within 2e-2 x max |y_ref|; then the drops
    and the times at the published capacity, and of one token."""
    p = tt.layer_params(params["layers"], 0)["moe"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen, device="cuda").bfloat16()
    at = dataclasses.replace(cfg, moe_capacity_factor=nodrop)
    with torch.inference_mode():
        y, aux = moe.moe_ffn(p, x, at)
        want = moe.moe_ffn_ref(p, x, at)
        _, pub = moe.moe_ffn(p, x, cfg)
        ms = rotated_ms(lambda t: moe.moe_ffn(p, t, cfg), [[x]], 5)
        ms1 = rotated_ms(lambda t: moe.moe_ffn(p, t, cfg), [[x[:, :1]]], 20)
    dropped = float(aux["dropped_frac"])
    scale = float(want.float().abs().max())
    err = float((y.float() - want.float()).abs().max())
    tol = cases.TOL[torch.bfloat16] * scale
    log(f"{cfg.name} moe_ffn (1,{MOE_TOKENS},{cfg.d_model}) bf16 at capacity factor "
        f"{nodrop:g} (C {moe.moe_capacity(at, MOE_TOKENS)}): dropped {dropped:.3e}; vs "
        f"moe_ffn_ref max |err| {err:.6f} (limit {tol:.6f} = 2e-2 x max |y_ref| "
        f"{scale:.4f}); at the published {cfg.moe_capacity_factor:g} (C "
        f"{moe.moe_capacity(cfg, MOE_TOKENS)}): dropped {float(pub['dropped_frac']):.6f}, "
        f"{ms:.3f} ms per call, one token {ms1:.3f} ms")
    if not abs(dropped) <= 1e-6 or not err <= tol or not math.isfinite(scale):
        raise AssertionError(f"{cfg.name}: moe_ffn disagrees with moe_ffn_ref")


def moe_phase(serve, ops, cases, tt, moe, arch):
    """A MoE arch at every published width with its depth cut to
    ``serve.FULL_DEPTH``, bf16, seed-0 weights: the module check; the
    two-turn conversation at the published capacity (exact reuse and launch
    counts, each prefill's drops logged) and a cold engine, logged and not
    gated (a hit's suffix prefill drops other assignments than a cold
    prefill, in the reference too); then hit against cold at a capacity
    where nothing drops, held to the dense archs' rule. Returns the
    launches of the published-capacity conversation."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the router product must run in fp32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, eng = serve.build_engine(arch, device="cuda")
    torch.cuda.synchronize()
    log(f"{arch}: {describe(cfg)}; bfloat16 weights drawn in "
        f"{time.perf_counter() - t0:.3f} s, peak memory allocated at init "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    L, num_new = cfg.num_layers, serve.FULL_TURNS[arch][2]
    nodrop = cfg.num_experts / cfg.experts_per_token      # C >= T: nothing drops
    moe_module_check(moe, tt, cases, cfg, eng.params, nodrop)

    zero_counts(ops)
    (ctx2, r1, r2), drops = recorded_drops(moe, lambda: serve.two_turns(cfg, eng, False))
    launches = read_counts(ops)
    check_two_turns(serve, arch, cfg, eng, ctx2, r1, r2, launches)
    for i in (1, 2):
        log(f"{arch} turn {i} prefill at capacity factor {cfg.moe_capacity_factor:g}: "
            f"{drop_line(drops[(i - 1) * L:i * L])}")
    log(f"{arch} peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _, cold = serve.build_engine(arch, device="cuda", params=eng.params)
    rc, cold_drops = recorded_drops(moe, lambda: cold.generate("cold", ctx2, num_new=num_new))
    err = float((rc.last_logits - r2.last_logits).abs().max())
    log(f"{arch} cold engine at capacity factor {cfg.moe_capacity_factor:g} (not held to "
        f"the hit): prefill {rc.prefill_tokens_computed} tokens in "
        f"{rc.prefill_time_s * 1e3:.3f} ms, {drop_line(cold_drops)}; tokens {rc.tokens} "
        f"against the hit's {r2.tokens}; last-position logits max |hit - cold| {err:.6f}")
    del cold, rc

    _, hit = serve.build_engine(arch, device="cuda", params=eng.params,
                                moe_capacity_factor=nodrop)
    (ctx2, _, n2), hit_drops = recorded_drops(
        moe, lambda: serve.two_turns(hit.cfg, hit, False))
    _, cold = serve.build_engine(arch, device="cuda", params=eng.params,
                                 moe_capacity_factor=nodrop)
    nc, cold_drops = recorded_drops(moe, lambda: cold.generate("cold", ctx2, num_new=num_new))
    log(f"{arch} at capacity factor E/K = {nodrop:g}: hit prefills "
        f"{drop_line(hit_drops)}, cold {drop_line(cold_drops)}; turn 2 prefill "
        f"{n2.prefill_time_s * 1e3:.3f} ms, decode {n2.decode_time_s / num_new * 1e3:.3f} "
        f"ms/token")
    if max(abs(d) for d in hit_drops + cold_drops) > 1e-6:
        raise AssertionError(f"{arch}: assignments dropped at capacity factor {nodrop:g}")
    hit_vs_cold(cases, f"{arch} at capacity factor E/K = {nodrop:g}", n2, nc)
    return launches


def profile_turn2(serve, arch, params, ctx2):
    """A replay of turn 2 (turn 1 served unprofiled first, so turn 2
    hits), unprofiled and then profiled."""
    cfg, eng = serve.build_engine(arch, device="cuda", params=params)
    ctx_len, _, num_new, _ = serve.FULL_TURNS[arch]
    eng.generate("replay", ctx2[:ctx_len], num_new=num_new)
    t0 = time.perf_counter()
    r = eng.generate("replay", ctx2, num_new=num_new)
    log(f"{arch} unprofiled replay of turn 2: {(time.perf_counter() - t0) * 1e3:.3f} ms "
        f"(prefill {r.prefill_time_s * 1e3:.3f}, decode {r.decode_time_s * 1e3:.3f})")
    r, calls = whole_replay(
        f"{arch} turn 2", lambda i: eng.generate(f"prof{i}", ctx2[:ctx_len], num_new=num_new),
        lambda i: eng.generate(f"prof{i}", ctx2, num_new=num_new),
        {"flash_mma_kernel": cfg.num_layers, "decode_mma_kernel": num_new * cfg.num_layers})
    if r.reused_tokens != ctx_len:
        raise AssertionError(f"{arch}: profiled replay of turn 2 missed the cache")
    # the suffix prefill: one bf16 (wgmma) flash launch per layer, no fp32 one
    mma = sum(c for n, c in calls.items() if "flash_mma_kernel" in n)
    fp32 = sum(c for n, c in calls.items() if "flash_tf32_" in n)
    log(f"{arch} profiled replay: {mma} flash_mma_kernel launches, {fp32} of the fp32 "
        "route's (flash_tf32_split_kernel, flash_tf32_kernel)")
    if mma != cfg.num_layers or fp32:
        raise AssertionError(f"{arch} profiled replay: {mma} flash_mma_kernel and "
                             f"{fp32} fp32 flash launches, want {cfg.num_layers} and 0")
    # the decode: one tensor-core decode launch per layer and token
    check_decode_calls(arch, calls, num_new * cfg.num_layers)


def long_context_phase(ops, tt, cases, shapes, cfg):
    """Full width, ``long_context=True``: a prefill of ``shapes.LONG_PREFILL``
    tokens into a ring of 8,192 slots and one ``decode_step`` on the wrapped
    ring, against ``forward`` of one token more (``step_vs_forward_phase``).
    In bf16 both sides round every GEMM and attention output to bf16 at
    other shapes (M = 1 against 10,241; decode against flash), which moves
    the logits by about the bf16 limit on its own; the fp32 run is the
    sharper check."""
    S, L, max_len = shapes.LONG_PREFILL, cfg.num_layers, shapes.LONG_MAX_LEN
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    window = tt.attn_window(cfg, long_context=True)

    def wrapped_ring(cache):
        ring = cache["k"].shape[2]
        log(f"{cfg.name} long context: prefill of {S} (max_len {max_len}) into a ring of "
            f"{ring} slots, window {window}")
        if ring != min(max_len, window) or S <= ring:
            raise AssertionError(f"{cfg.name}: ring of {ring} slots, want a wrapped ring "
                                 f"of {min(max_len, window)}")

    return step_vs_forward_phase(
        ops, tt, cases, cfg, f"{cfg.name} long context", {"tokens": toks[:, :S]}, max_len,
        [(toks[:, S:], S, {})], {"tokens": toks},
        {"prefill": seq_counts(flash=L), "step": seq_counts(decode=L),
         "forward": seq_counts(flash=L)},
        kw={"long_context": True}, check_cache=wrapped_ring)


def step_vs_forward_phase(ops, tt, cases, cfg, label, prefill_batch, max_len, steps,
                          forward_batch, want, kw=None, check_cache=None):
    """A model phase on seed-0 weights in bf16, then on the same weights in
    fp32: ``prefill`` of ``prefill_batch``, a ``decode_step`` for each of
    ``steps`` ((tokens, pos, keyword arguments)), the last step's logits
    held against ``forward`` of ``forward_batch``'s last row, with exact
    launch counts per call (``want``: prefill, step and forward's counts by
    kernel). ``kw`` goes to all three functions; ``check_cache`` is called
    on the prefill's cache. The limits: in bf16 the hit-vs-cold limit, the
    bf16 kernel tolerance scaled to the logits (both sides round every GEMM
    and attention output to bf16 at other shapes); in fp32 5e-4, the
    reference's ``test_prefill_decode_consistency``. Logs each bf16 side
    against the fp32 forward, times and peak memory. Returns the launches
    made."""
    kw = kw or {}
    t0 = time.perf_counter()
    params = tt.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            torch.bfloat16)
    torch.cuda.synchronize()
    log(f"{label}: {describe(cfg)}; bfloat16 weights drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    total = {n: 0 for n in SOURCES}

    def run(params, dtype):
        """(last-position logits of the last step, of forward) in fp32."""
        ms, bad = {}, []

        def timed(call, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, got = launched(ops, fn)
            torch.cuda.synchronize()
            ms[call] = ms.get(call, 0.0) + (time.perf_counter() - t0) * 1e3
            if got != want[call]:
                bad.append((call, got))
            for n, c in got.items():
                total[n] += c
            return out

        with torch.inference_mode():
            _, cache = timed("prefill", lambda: tt.prefill(params, cfg, prefill_batch,
                                                           max_len, **kw))
            if check_cache is not None:
                check_cache(cache)
            for tokens, pos, step_kw in steps:
                step = timed("step", lambda: tt.decode_step(params, cfg, cache, tokens,
                                                            pos, **kw, **step_kw))
                step = step[0][0, 0].float()
            full = timed("forward", lambda: tt.forward(params, cfg, forward_batch, **kw))
            full = full[0, -1].float()
        scale = float(full.abs().max())
        tol = cases.TOL[dtype] * scale if dtype == torch.bfloat16 else 5e-4
        err = float((step - full).abs().max())
        log(f"{label} {str(dtype)[6:]}: prefill in {ms['prefill']:.3f} ms, {len(steps)} "
            f"decode_steps in {ms['step']:.3f} ms, forward in {ms['forward']:.3f} ms; "
            f"last step vs forward, last-position logits: max |err| {err:.6f} (limit "
            f"{tol:.6f}; max |logit| {scale:.4f}); greedy {int(step.argmax())} / "
            f"{int(full.argmax())}; peak memory allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if bad:
            raise AssertionError(f"{label}: launch counts {bad}, want {want}")
        if not err <= tol or not math.isfinite(scale):
            raise AssertionError(f"{label}: decode_step disagrees with forward")
        return step, full

    torch.cuda.reset_peak_memory_stats()
    zero_counts(ops)
    step16, full16 = run(params, torch.bfloat16)
    params = tree_map(params, lambda t: t.float())        # the same values in fp32
    _, full32 = run(params, torch.float32)
    log(f"{label}, each bf16 side against fp32 forward on the same weights: step max "
        f"|err| {float((step16 - full32).abs().max()):.6f}, forward "
        f"{float((full16 - full32).abs().max()):.6f}")
    return total


def seq_counts(flash=0, decode=0):
    return dict({n: 0 for n in SOURCES}, flash_attention=flash, decode_attention=decode)


def vision_phase(ops, tt, cases, shapes, cfg):
    """qwen2-vl-2b at full width with one image of ``cfg.vision_tokens``
    patches (a square grid) and ``shapes.VISION_TEXT`` text tokens, in
    Qwen2-VL's position layout; ``shapes.VISION_STEPS`` decode steps with
    the layout's ids passed explicitly."""
    V, text, n, L = cfg.vision_tokens, shapes.VISION_TEXT, shapes.VISION_STEPS, \
        cfg.num_layers
    grid = math.isqrt(V)
    rng = np.random.default_rng(1)
    patches = torch.from_numpy((rng.standard_normal((1, V, cfg.d_model)) * 0.02)
                               .astype(np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, text + n))).cuda()
    ids = shapes.vision_positions(grid, grid, text + n, "cuda")
    S = V + text
    return step_vs_forward_phase(
        ops, tt, cases, cfg, f"{cfg.name} vision model phase",
        {"tokens": toks[:, :text], "patches": patches, "positions": ids[:, :S]},
        shapes.VISION_MAX_LEN,
        [(toks[:, text + i:text + i + 1], S + i,
          {"mrope_positions": ids[:, S + i:S + i + 1]}) for i in range(n)],
        {"tokens": toks, "patches": patches, "positions": ids},
        {"prefill": seq_counts(flash=L), "step": seq_counts(decode=L),
         "forward": seq_counts(flash=L)})


def encdec_phase(ops, tt, cases, shapes, cfg):
    """seamless-m4t-large-v2 at full width: ``cfg.source_len`` frames,
    ``shapes.ENCDEC_TARGET`` target tokens and ``shapes.ENCDEC_STEPS``
    decode steps."""
    T, n = shapes.ENCDEC_TARGET, shapes.ENCDEC_STEPS
    rng = np.random.default_rng(1)
    frames = torch.from_numpy((rng.standard_normal((1, cfg.source_len, cfg.d_model))
                               * 0.02).astype(np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, T + n))).cuda()
    seq = seq_counts(flash=cfg.encoder_layers + 2 * cfg.num_layers)
    return step_vs_forward_phase(
        ops, tt, cases, cfg, f"{cfg.name} model phase",
        {"tokens": toks[:, :T], "frames": frames}, shapes.ENCDEC_MAX_LEN,
        [(toks[:, T + i:T + i + 1], T + i, {}) for i in range(n)],
        {"tokens": toks, "frames": frames},
        {"prefill": seq, "step": seq_counts(decode=2 * cfg.num_layers), "forward": seq})


def check_decode_calls(label, calls, want):
    """A profiled replay ran ``want`` launches of ``decode_mma_kernel`` and
    none of the bf16 CUDA-core decode or of a separate merge."""
    mma = sum(c for n, c in calls.items() if "decode_mma_kernel" in n)
    old = sum(c for n, c in calls.items()
              if DECODE_BF16_OLD in n or "decode_merge_kernel" in n)
    log(f"{label} profiled replay: {mma} decode_mma_kernel launches, {old} "
        f"decode_partial_kernel<bf16> or decode_merge_kernel")
    if mma != want or old:
        raise AssertionError(f"{label} profiled replay: {mma} decode_mma_kernel and {old} "
                             f"older decode launches, want {want} and 0")


def whole_replay(label, prepare, replay, want):
    """``profiled(label, lambda: replay(i))`` after an unprofiled
    ``prepare(i)``, for i = 0, 1, ... until a window holds at least
    ``want``'s launches ({device name fragment: launches}, counted over the
    names that hold the fragment). A window short of them lost device events
    (``launch/device_time.py``: a session can lose its start) and is logged
    and discarded, as ``device_ms`` discards a window that is not whole;
    the last of ``REPLAY_TRIES`` windows is returned whatever it holds, and
    the caller's checks judge it. Returns (replay's result, calls)."""
    for i in range(REPLAY_TRIES):
        prepare(i)
        r, calls = profiled(label, lambda: replay(i))
        got = {k: sum(c for n, c in calls.items() if k in n) for k in want}
        if all(got[k] >= n for k, n in want.items()):
            break
        log(f"profile of {label}: window discarded ({got}, want {want})")
    return r, calls


def profiled(label, fn):
    """Run ``fn()`` under the profiler; log the window, the device's busy
    time and idle share, and device time by kernel. Returns fn's result and
    the device calls by kernel name. A session can lose its first device
    operations (``launch/device_time.py``): behind 3 small kernels and a
    50 us spin, every try of a recurrentgemma-2b replay window lost one
    ``rglru_step_kernel`` launch in two runs on an H100. So a session opens
    with ``PROFILE_LEAD`` small kernels and a spin as long as ``device_ms``'s
    (about 5 ms), and fn's device work is read between that spin and one
    after fn, as ``device_ms`` reads its windows; a session that lost the
    opening spin too is logged (its window is then all it recorded)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.device_time import SPIN_CYCLES, _device_events

    lead = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            lead.add_(1)
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        wall_us = (time.perf_counter() - t0) * 1e6
        torch.cuda._sleep(SPIN_CYCLES // 100)
        torch.cuda.synchronize()
    spins, us = _device_events(prof)
    if spins < 2:
        log(f"profile of {label}: the session recorded {spins} of its 2 spins (lost its start)")
    by_name = {n: sum(t) for n, t in us.items()}
    calls = {n: len(t) for n, t in us.items()}
    busy = sum(by_name.values())
    if not busy:
        log(f"profile of {label}: the profiler saw no device time (not measured)")
        return result, calls
    log(f"profile of {label}: window {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in ranked[10:] if any(k in kv[0] for k in PORT_KERNELS)]
    for name, us in ranked[:10] + ours:
        log(f"  {us / 1e3:9.3f} ms {us / wall_us:7.2%} {calls[name]:6d} calls  {name[:100]}")
    return result, calls


def profiled_step(label, fn, whole):
    """The training phases' profile of ``fn()``, one training step, on a
    whole profiler window: device time by ``STEP_CLASSES``, the optimizer's
    (the kernels that ``adamw_update`` launched, seen through a
    ``record_function`` range around it) and the rest's, and the idle
    share. Returns fn's result and the split in ms, or None (the window
    discarded) unless the window recorded every kernel of the step that
    ``whole`` counts: {class: device launches}, e.g. 2 x layers flash
    forward launches and as many backward kernels (dQ and dK/dV per
    layer). A session can lose its first device records: on an H100 every
    profiled step of one run lost one flash forward (danube) or one rglru
    scan (recurrentgemma-2b), of which the first runs near the step's
    start. So the session opens as ``profiled``'s does, with
    ``PROFILE_LEAD`` small kernels and a spin, and the step is read after
    that spin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.device_time import SPIN_CYCLES
    from repro_torch.train import steps
    real = steps.adamw_update

    def traced(*a, **kw):
        with record_function("adamw_update"):
            return real(*a, **kw)

    steps.adamw_update = traced
    lead = torch.zeros(1, device="cuda")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):       # what a session's lost start takes
                lead.add_(1)
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        steps.adamw_update = real

    def klass(name):
        return next((c for c, pat in STEP_CLASSES if pat.search(name)), None)

    def subtree(e):
        return list(e.kernels) + [k for ch in e.cpu_children for k in subtree(ch)]

    events = prof.events()
    # the step's device work runs after the lead's spin (all of it if the
    # session lost the spin too)
    spins = [e.time_range.end for e in events
             if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name]
    if not spins:
        log(f"profile of {label}: the session lost its opening spin")
    lo = min(spins, default=-1)
    us = {c: 0.0 for c, _ in STEP_CLASSES}
    calls = {c: 0 for c, _ in STEP_CLASSES}
    by_name = {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == "adamw_update"
                or e.time_range.start < lo or "spin_kernel" in e.name):
            continue
        t = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + t
        c = klass(e.name)
        if c is not None:
            us[c] += t
            calls[c] += 1
    us["optimizer"] = sum(k.duration for e in events
                          if e.device_type == DeviceType.CPU and e.name == "adamw_update"
                          for k in subtree(e)
                          if k.name != "adamw_update" and klass(k.name) is None)
    busy = sum(by_name.values())
    if not busy:
        log(f"profile of {label}: the profiler saw no device time; window discarded")
        return result, None
    us["the rest"] = busy - sum(us.values())
    seen = {c: calls[c] for c in whole}
    log(f"profile of {label}: window {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
        f"idle share {1 - busy / wall_us:.4f}; " + ", ".join(
            f"{c} {t / 1e3:.3f} ms ({t / busy:.2%})" for c, t in us.items())
        + f"; kernels seen by class: {seen}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {t / 1e3:9.3f} ms {t / busy:7.2%}  {name[:100]}")
    if seen != whole:
        log(f"profile of {label}: window discarded (want {whole})")
        return result, None
    return result, dict({c: t / 1e3 for c, t in us.items()}, window=wall_us / 1e3,
                        busy=busy / 1e3, idle_share=1 - busy / wall_us,
                        names=sorted(by_name))


# --------------------------------------------------------------------------- #
# rwkv6-1.6b: the wkv6 kernel, the model, the engine
# --------------------------------------------------------------------------- #

def wkv6_row(ops, ref, cases, case, timed: bool):
    """The kernel against its plain version on ``case``; with ``timed``,
    kernel, plain, bound and device times too."""
    err, inputs = cases.check_wkv6(case, "cuda")
    row = dict(max_abs_err=err)
    if timed:
        B, H, S, hd = case[:4]
        sets = copies(inputs, limit=256)
        row["ms"] = rotated_ms(ops.wkv6, sets, 50 if S < 64 else 10)
        row["plain_ms"] = rotated_ms(ref.wkv6_ref, sets, 20 if S < 64 else 2)
        from repro_torch.kernels import wkv6
        row["device_ms"] = cold_device_ms(
            ops.wkv6, inputs, "wkv6_step_kernel" if S == 1 else "wkv6_kernel<",
            iters=20 if S == 1 else 10, kernels=wkv6.fwd_plan(B, H, S, hd)[0])
        nbytes = (3 * inputs[0].element_size() * B * H * S * hd
                  + 4 * (2 * B * H * S * hd + 2 * B * H * hd * hd + H * hd))
        row.update(zip(("bound_ms", "bound_by"),
                       bound(6 * B * H * S * hd * hd, nbytes, torch.float32)))
        row["library_ms"] = None            # no PyTorch call computes WKV6
    return row


def wkv6_phase(ops, ref, cases, cfg):
    """Every WKV6 case, then the rwkv6-1.6b path's two shapes (r, k, v in
    bf16 as the model passes them, and in fp32) and the floor, timed."""
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    main = {"engine step": (1, H, 1, hd, None, 0.1, "bshd", "bf16"),
            "engine step fp32": (1, H, 1, hd, None, 0.1, "bshd", "fp32"),
            "floor": cases.WKV6_FLOOR[0],
            "prefill": (1, H, RWKV_PREFILL, hd, None, 0.1, "bshd", "fp32"),
            "prefill bf16": (1, H, RWKV_PREFILL, hd, None, 0.1, "bshd", "bf16")}
    if main["engine step"] != cases.WKV6_STEP[0]:
        raise AssertionError(f"the engine's wkv6 step {main['engine step']} is not "
                             f"cases.WKV6_STEP[0] {cases.WKV6_STEP[0]}")
    rows = {}
    for group, table in (("sweep", cases.WKV6_SWEEP), ("edge", cases.WKV6_EDGE),
                         ("slice", cases.WKV6_SLICE), ("no token", cases.WKV6_NO_TOKEN),
                         ("step", cases.WKV6_STEP),
                         ("bf16", cases.WKV6_BF16)):
        for i, case in enumerate(table):
            rows[f"{group} {i}"] = (case, wkv6_row(ops, ref, cases, case, False))
    for label, case in main.items():
        rows[label] = (case, wkv6_row(ops, ref, cases, case, True))
    for label, (case, r) in rows.items():
        times = ""
        if "ms" in r:
            times = (f", kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
                     f"library none, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
                     f"device per call {r['device_ms']:.6f} ms")
        rkv = "bfloat16" if case[7:] == ("bf16",) else "float32"
        log(f"wkv6 r/k/v {rkv} {label} {case}: max |err| {r['max_abs_err']:.3e}{times}")
    return rows


def rwkv_model_phase(ops, tt, cfg):
    """Full width in fp32: prefill(S) + decode_step against prefill(S + 1);
    then the time of a bf16 prefill of S tokens."""
    S = RWKV_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tt.init_params(gen, cfg, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        zero_counts(ops)
        _, cache = tt.prefill(params, cfg, {"tokens": toks[:, :S]}, max_len=S + 1)
        n_prefill = ops.wkv6.launches
        step, _ = tt.decode_step(params, cfg, cache, toks[:, S:], S)
        n_step = ops.wkv6.launches - n_prefill
        full, _ = tt.prefill(params, cfg, {"tokens": toks}, max_len=S + 1)
        counts = read_counts(ops)
        err = float((step[0, 0] - full[0, -1]).abs().max())
        scale = float(full[0, -1].abs().max())
    L = cfg.num_layers
    log(f"{RWKV} fp32 prefill of {S} + decode_step vs prefill of {S + 1}: last-position "
        f"logits max |err| {err:.3e} (limit 5e-4; max |logit| {scale:.4f}); wkv6 "
        f"launches {n_prefill} prefill, {n_step} step; counts {counts}")
    if not err <= 5e-4 or not math.isfinite(scale):
        raise AssertionError(f"{RWKV}: prefill + step disagrees with prefill")
    if (n_prefill, n_step) != (L, L) or counts != dict({n: 0 for n in SOURCES}, wkv6=3 * L):
        raise AssertionError(f"{RWKV}: launch counts {counts}")
    del params, cache, step, full
    bf16_prefill_ms(tt, cfg, toks[:, :S])
    return counts


def bf16_prefill_ms(tt, cfg, toks):
    """Log three timed bf16 prefills of ``toks`` after a warm-up, on seed-0
    weights."""
    params = tt.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            torch.bfloat16)
    with torch.inference_mode():
        batch = {"tokens": toks}
        tt.prefill(params, cfg, batch, max_len=toks.shape[1])    # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.prefill(params, cfg, batch, max_len=toks.shape[1])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    log(f"{cfg.name} bf16 prefill of {toks.shape[1]} tokens: "
        f"{', '.join(f'{t:.3f}' for t in times)} ms")


# --------------------------------------------------------------------------- #
# recurrentgemma-2b: the rglru kernel, the model (the engine is shared above)
# --------------------------------------------------------------------------- #

def rglru_row(ops, ref, cases, case, timed: bool):
    """The scan against its plain version on ``case``; with ``timed``,
    kernel, plain, bound and device times too."""
    err, inputs = cases.check_rglru(case, "cuda")
    row = dict(max_abs_err=err)
    if timed:
        B, S, D = case[:3]
        sets = copies(inputs, limit=256)
        row["ms"] = rotated_ms(ops.rglru_scan, sets, 50 if S < 64 else 10)
        row["plain_ms"] = rotated_ms(ref.rglru_scan_ref, sets, 20 if S < 64 else 2)
        from repro_torch.kernels import rglru
        split = {}
        row["device_ms"] = cold_device_ms(ops.rglru_scan, inputs, "rglru_fwd_",
                                          iters=20 if S == 1 else 10,
                                          kernels=rglru.scan_plan(B, S, D)[0], split=split)
        row["device_split"] = {n: t for n, (_, t) in split.items()}
        nbytes = 4 * (3 * B * S * D + 2 * B * D)
        row.update(zip(("bound_ms", "bound_by"),
                       bound(2 * B * S * D, nbytes, torch.float32)))
        row["library_ms"] = None            # no PyTorch call computes the scan
    return row


def rglru_step_row(ops, ref, cases, case, timed: bool):
    """The fused step against its plain version on ``case``; with
    ``timed``, kernel, plain, bound and device times too, and the device
    time of the plain version, the PyTorch chain the kernel replaces."""
    err, inputs = cases.check_rglru_step(case, "cuda")
    row = dict(max_abs_err=err)
    if timed:
        B, D = case[:2]
        sets = copies(inputs, limit=256)
        row["ms"] = rotated_ms(ops.rglru_step, sets, 50)
        row["plain_ms"] = rotated_ms(ref.rglru_step_ref, sets, 50)
        row["device_ms"] = cold_device_ms(ops.rglru_step, inputs, "rglru_step_kernel",
                                          iters=20)
        row["plain_device_ms"] = cold_device_ms(ref.rglru_step_ref, inputs, iters=10)
        # gx_a, gx_x, h in and h' out (B,D), ba, bx, lam (D,) in fp32; x in, y out
        nbytes = 4 * (4 * B * D + 3 * D) + 2 * inputs[5].element_size() * B * D
        row.update(zip(("bound_ms", "bound_by"),
                       bound(20 * B * D, nbytes, torch.float32)))
        row["library_ms"] = None            # no PyTorch call computes the step
    return row


def rglru_phase(ops, ref, cases, cfg):
    """Every RG-LRU scan and step case, then the recurrentgemma-2b path's
    shapes and the floors, timed: the scan per layer of the model phase's
    prefill, at one step and at the floor; the fused step per layer and
    engine step, and at its floor."""
    D = cfg.rnn_width
    main = {"prefill": (1, GRIFFIN_PREFILL, D, "bsd"), "one step": (1, 1, D, "bsd"),
            "floor": cases.RGLRU_FLOOR[0],
            "training shape": cases.RGLRU_BWD_TRAIN[GRIFFIN][:4]}
    step_main = {"engine step": (1, D, "bf16", "bd"), "floor": cases.RGLRU_STEP[-1]}
    if step_main["engine step"] != cases.RGLRU_STEP[0]:
        raise AssertionError(f"the engine's rglru step {step_main['engine step']} is not "
                             f"cases.RGLRU_STEP[0] {cases.RGLRU_STEP[0]}")
    rows, step_rows = {}, {}
    for group, table in (("sweep", cases.RGLRU_SWEEP), ("edge", cases.RGLRU_EDGE),
                         ("chunk", cases.RGLRU_CHUNK), ("no token", cases.RGLRU_NO_TOKEN)):
        for i, case in enumerate(table):
            rows[f"{group} {i}"] = (case, rglru_row(ops, ref, cases, case, False))
    for label, case in main.items():
        rows[label] = (case, rglru_row(ops, ref, cases, case, True))
        cases.check_rglru_repeat(case, "cuda")
    for i, case in enumerate(cases.RGLRU_STEP):
        step_rows[f"case {i}"] = (case, rglru_step_row(ops, ref, cases, case, False))
    for label, case in step_main.items():
        step_rows[label] = (case, rglru_step_row(ops, ref, cases, case, True))
    for kind, table in (("rglru_scan", rows), ("rglru_step", step_rows)):
        for label, (case, r) in table.items():
            times = ""
            if "ms" in r:
                times = (f", kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
                         f"library none, bound {r['bound_ms']:.7f} ms ({r['bound_by']}); "
                         f"device per call {r['device_ms']:.6f} ms")
                if "plain_device_ms" in r:
                    times += f", plain chain {r['plain_device_ms']:.6f} ms"
                if "device_split" in r:
                    times += f" ({kernel_split(r['device_split'])}); two calls the same bits"
            log(f"{kind} {label} {case}: max |err| {r['max_abs_err']:.3e}{times}")
    return rows, step_rows


def kernel_split(split) -> str:
    """'name ms, ...' of a call's device time by kernel, the names cut to the
    kernel's own."""
    named = {re.search(r"(\w+_kernel)", n).group(1): t for n, t in split.items()}
    return ", ".join(f"{n} {t:.6f}" for n, t in sorted(named.items()))


def wkv6_bwd_row(ops, ref, cases, case):
    """The wkv6 backward at a training shape: held and repeated, then timed
    by events (the backward entry alone, on the training entry's
    checkpoints; the plain version, once), its device time per call with
    the inputs cold, and its bound; the training entry's time and bound
    beside the serving entry's time."""
    err, (inputs, dy, dsn) = cases.check_wkv6_bwd(case, "cuda")
    cases.check_wkv6_bwd_repeat(case, "cuda")
    B, H, S, hd = case[:4]
    _, _, ckpt = ops.wkv6_train(*inputs)
    args = inputs + [ckpt, dy]
    fn = lambda *t: ops.wkv6_bwd(*t, dsn)       # noqa: E731
    sets = copies(args, limit=4)
    ms = rotated_ms(fn, sets, 5)
    plain = rotated_ms(lambda *t: ref.wkv6_bwd_ref(*t, dsn), sets[:1], 1)
    from repro_torch.kernels import wkv6
    split = {}
    dev = cold_device_ms(fn, args, "wkv6_bwd_", iters=5, kernels=wkv6.bwd_plan(B, H, S, hd)[0],
                         split=split)
    fwd_sets = [s[:6] for s in sets]
    train_ms = rotated_ms(ops.wkv6_train, fwd_sets, 5)
    serve_ms = rotated_ms(ops.wkv6, fwd_sets, 5)
    # per (b, h, t): the states' recompute 3·hd², the four sums 2·hd² each,
    # G's update 3·hd²; r, k, v, w, dy, the checkpoints (and ds_n) read, the
    # gradients written once
    elt = inputs[0].element_size()
    n = B * H * S * hd
    nbytes = (2 * 3 * elt * n + 4 * 3 * n + 4 * (ckpt.numel() + 2 * H * hd + B * H * hd * hd)
              + (0 if dsn is None else 4 * dsn.numel()))
    # the training entry: the serving entry's bytes (csrc/wkv6.cu) and the
    # checkpoints written, 6·hd² operations per (b, h, t)
    fwd_bytes = (3 * elt * n + 4 * (2 * n + 2 * B * H * hd * hd + H * hd)
                 + 4 * ckpt.numel())
    fwd_bound = bound(6 * B * H * S * hd * hd, fwd_bytes, torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, device_ms=dev,
                device_split={n: t for n, (_, t) in split.items()},
                train_fwd_ms=train_ms, serving_fwd_ms=serve_ms,
                train_fwd_bound_ms=fwd_bound[0], train_fwd_bound_by=fwd_bound[1],
                **dict(zip(("bound_ms", "bound_by"),
                           bound(14 * B * H * S * hd * hd, nbytes, torch.float32))))


def wkv6_bwd_phase(ops, ref, cases):
    """Step 20: the training entry at every forward case and the training
    shape, the backward at every ``cases.WKV6_BWD`` case, the training
    shape held and timed."""
    for case in (cases.WKV6_SWEEP + cases.WKV6_EDGE + cases.WKV6_SLICE + cases.WKV6_NO_TOKEN
                 + cases.WKV6_STEP + cases.WKV6_FLOOR + cases.WKV6_BF16
                 + list(cases.WKV6_BWD_TRAIN.values())):
        err = cases.check_wkv6_train(case, "cuda")
        log(f"wkv6_train {case}: the serving entry's y and s_n bit for bit; checkpoints max "
            f"|err| {err:.3e}")
    for case in cases.WKV6_BWD_TRAIN.values():
        err, _ = cases.check_wkv6(case[:8], "cuda")
        log(f"wkv6 {case[:8]}: y and s_n against the plain version, max |err| {err:.3e}")
    for case in cases.WKV6_BWD:
        err, _ = cases.check_wkv6_bwd(case, "cuda")
        cases.check_wkv6_bwd_repeat(case, "cuda")
        log(f"wkv6_bwd {case}: max |err| {err:.3e}; two calls the same bits")
    rows = {}
    for label, case in cases.WKV6_BWD_TRAIN.items():
        r = rows[label] = wkv6_bwd_row(ops, ref, cases, case)
        torch.cuda.empty_cache()
        log(f"wkv6_bwd {label} {case}: max |err| {r['max_abs_err']:.3e}, kernel "
            f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library none, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}); device per call {r['device_ms']:.6f} "
            f"ms ({kernel_split(r['device_split'])}); training forward "
            f"{r['train_fwd_ms']:.5f} ms, bound "
            f"{r['train_fwd_bound_ms']:.6f} ms ({r['train_fwd_bound_by']}), serving forward "
            f"{r['serving_fwd_ms']:.5f} ms")
    return rows


def rglru_bwd_row(ops, ref, cases, case):
    """The scan's backward at a training shape: held and repeated, timed
    (events; the plain version; device time with the inputs cold, by
    kernel: ``rglru.bwd_plan`` launches a call) beside its bound; the
    scan's time and bound at the same shape."""
    from repro_torch.kernels import rglru
    err, ((a, b, h0), dy, dh) = cases.check_rglru_bwd(case, "cuda")
    cases.check_rglru_bwd_repeat(case, "cuda")
    B, S, D = case[:3]
    y, _ = ops.rglru_scan(a, b, h0)
    args = [a, h0, y, dy]
    fn = lambda *t: ops.rglru_scan_bwd(*t, dh)     # noqa: E731
    sets = copies(args, limit=4)
    ms = rotated_ms(fn, sets, 10)
    plain = rotated_ms(lambda *t: ref.rglru_scan_bwd_ref(*t, dh), sets[:1], 1)
    split = {}
    dev = cold_device_ms(fn, args, "rglru_bwd_", iters=10, kernels=rglru.bwd_plan(B, S, D)[0],
                         split=split)
    scan_ms = rotated_ms(ops.rglru_scan, [[s[0], b, s[1]] for s in sets], 10)
    # a, y, dy in and da, db out (B,S,D); h0 in, dh0 out (and dh_S in); the
    # scan: a, b in and y out, h0 in and h_S out
    nbytes = 4 * (5 * B * S * D + (2 if dh is None else 3) * B * D)
    scan_bound = bound(2 * B * S * D, 4 * (3 * B * S * D + 2 * B * D), torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, device_ms=dev,
                device_split={n: ms for n, (_, ms) in split.items()},
                scan_ms=scan_ms, scan_bound_ms=scan_bound[0], scan_bound_by=scan_bound[1],
                **dict(zip(("bound_ms", "bound_by"),
                           bound(3 * B * S * D, nbytes, torch.float32))))


def rglru_bwd_phase(ops, ref, cases):
    """Step 21: the scan's backward at every ``cases.RGLRU_BWD`` case, the
    training shape held and timed."""
    for case in cases.RGLRU_BWD:
        err, _ = cases.check_rglru_bwd(case, "cuda")
        cases.check_rglru_bwd_repeat(case, "cuda")
        log(f"rglru_scan_bwd {case}: max |err| {err:.3e}; two calls the same bits")
    rows = {}
    for label, case in cases.RGLRU_BWD_TRAIN.items():
        r = rows[label] = rglru_bwd_row(ops, ref, cases, case)
        log(f"rglru_scan_bwd {label} {case}: max |err| {r['max_abs_err']:.3e}, kernel "
            f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library none, bound "
            f"{r['bound_ms']:.7f} ms ({r['bound_by']}); device per call {r['device_ms']:.6f} "
            f"ms ({kernel_split(r['device_split'])}); the scan {r['scan_ms']:.5f} ms, bound "
            f"{r['scan_bound_ms']:.6f} ms "
            f"({r['scan_bound_by']})")
    return rows


def griffin_model_phase(ops, tt, cfg):
    """Full width in fp32: prefill(S) + decode_step against forward(S + 1),
    with exact launch counts per call; then the time of a bf16 prefill of S
    tokens. Returns the launches made."""
    S = GRIFFIN_PREFILL
    step_want = per_token(cfg)        # a prefill runs flash where a step runs decode
    seq_want = dict(step_want, flash_attention=step_want["decode_attention"],
                    decode_attention=0, rglru_scan=step_want["rglru_step"], rglru_step=0)
    want = {"prefill": seq_want, "step": step_want, "forward": seq_want}
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tt.init_params(gen, cfg, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    got = {}
    with torch.inference_mode():
        zero_counts(ops)
        (_, cache), got["prefill"] = launched(
            ops, lambda: tt.prefill(params, cfg, {"tokens": toks[:, :S]}, max_len=S + 1))
        (step, _), got["step"] = launched(
            ops, lambda: tt.decode_step(params, cfg, cache, toks[:, S:], S))
        full, got["forward"] = launched(
            ops, lambda: tt.forward(params, cfg, {"tokens": toks}))
        err = float((step[0, 0] - full[0, -1]).abs().max())
        scale = float(full[0, -1].abs().max())
    ring = cache["units"]["k"].shape[2]
    log(f"{GRIFFIN} fp32 prefill of {S} + decode_step vs forward of {S + 1} (ring "
        f"{ring} slots, window {cfg.local_window}): last-position logits max |err| "
        f"{err:.3e} (limit 5e-4; max |logit| {scale:.4f}); launches {got}")
    if not err <= 5e-4 or not math.isfinite(scale):
        raise AssertionError(f"{GRIFFIN}: prefill + step disagrees with forward")
    if got != want:
        raise AssertionError(f"{GRIFFIN}: launch counts {got}, want {want}")
    del params, cache, step, full
    bf16_prefill_ms(tt, cfg, toks[:, :S])
    return {n: sum(g[n] for g in got.values()) for n in SOURCES}


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

def train_100m_phase(ops, train_100m):
    """Step 17: the 100M twin on the card, its counts per step exact."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ops)
    t0 = time.perf_counter()
    losses = train_100m.main(["--device", "cuda"])
    dt = time.perf_counter() - t0
    counts = read_counts(ops)
    steps, L = len(losses), train_100m.LAYERS
    want = dict({n: 0 for n in SOURCES}, flash_attention=2 * L * steps,
                flash_attention_bwd=L * steps)
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    log(f"100M twin: {steps} fp32 steps in {dt:.3f} s ({dt / steps * 1e3:.3f} ms per step, "
        f"the checkpoint's write included); loss, mean of the first 10 {first:.4f}, of the "
        f"last 10 {last:.4f}; launches {counts}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not last < first:
        raise AssertionError("100M twin: the loss did not fall")
    if counts != want:
        raise AssertionError(f"100M twin: launch counts {counts}, want {want}")
    return counts


def train_spec(cfg):
    """(tokens, launches per step, {class: device launches} of a whole
    profiled step, kernels the profile must show, {name: slice of the
    weights to watch move}) of a training phase at full width and depth. A
    few small slices of matrices: a norm's scale of 1 keeps its bf16 value
    under updates below half its ulp."""
    from repro_torch.kernels import rglru, wkv6
    from repro_torch.models.transformer import griffin_layout
    L = cfg.num_layers
    probes = {"embed": lambda p: p["embed"][:64], "unembed": lambda p: p["unembed"][:, :64]}
    if cfg.family == "ssm":          # the forward and remat's recompute, one backward a layer
        probes.update({"layers/tmix/wr": lambda p: p["layers"]["tmix"]["wr"][0, :64],
                       "layers/cmix/wv": lambda p: p["layers"]["cmix"]["wv"][-1, :64]})
        return (RWKV_TRAIN_TOKENS, dict(wkv6=2 * L, wkv6_bwd=L),
                {"wkv6 forward": 2 * L, "wkv6 backward": L * wkv6.bwd_plan(
                    1, cfg.num_rwkv_heads, RWKV_TRAIN_TOKENS, cfg.rwkv_head_dim)[0]},
                ("wkv6_kernel", "wkv6_bwd_kernel", "wkv6_bwd_dv_kernel"), probes)
    if cfg.family == "hybrid":       # per unit: two scans and one attention, remat per unit
        units, tail = griffin_layout(cfg)
        rec = 2 * units + tail
        probes.update({"units/rec1/rg/wa": lambda p: p["units"]["rec1"]["rg"]["wa"][0, :64],
                       "units/attn/attn/wq": lambda p: p["units"]["attn"]["attn"]["wq"][0, :64],
                       "tail/mlp/w_down": lambda p: p["tail"]["mlp"]["w_down"][-1, :64]})
        return (GRIFFIN_TRAIN_TOKENS,
                dict(rglru_scan=2 * rec, rglru_scan_bwd=rec, flash_attention=2 * units,
                     flash_attention_bwd=units),
                {"rglru scan": 2 * rec * rglru.scan_plan(
                    1, GRIFFIN_TRAIN_TOKENS, cfg.rnn_width)[0],
                 "rglru backward": rec * rglru.bwd_plan(
                     1, GRIFFIN_TRAIN_TOKENS, cfg.rnn_width)[0],
                 "flash forward": 2 * units, "flash backward": 2 * units},
                ("rglru_fwd_kernel", "rglru_fwd_carry_kernel", "rglru_bwd_kernel",
                 "rglru_bwd_carry_kernel", "flash_bwd_dq_wide_kernel",
                 "flash_bwd_dkdv_wide_kernel"), probes)
    probes.update({"layers/attn/wq": lambda p: p["layers"]["attn"]["wq"][0, :64],
                   "layers/mlp/w_down": lambda p: p["layers"]["mlp"]["w_down"][-1, :64]})
    return (TRAIN_TOKENS, dict(flash_attention=2 * L, flash_attention_bwd=L),
            {"flash forward": 2 * L, "flash backward": 2 * L},
            ("flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel"), probes)


def train_phase(ops, cfg):
    """Steps 18, 22 and 23: full width and depth, bf16, TRAIN_STEPS steps of
    ``train_spec``'s tokens, exact counts per step, step 1 profiled."""
    from repro_torch.launch.serve import train_bytes
    from repro_torch.train.data import batch_iterator, batch_to
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    tokens, counts, whole, must_run, probes = train_spec(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_train_state(0, cfg, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"{cfg.name} training, full width: {describe(cfg)}; bf16 weights and fp32 moments "
        f"drawn in {time.perf_counter() - t0:.3f} s; train_bytes {train_bytes(cfg) / 1e9:.3f} "
        f"GB; allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    before = {k: f(params).detach().clone() for k, f in probes.items()}
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS))
    it = batch_iterator(cfg, 1, tokens, seed=0)
    want = dict({n: 0 for n in SOURCES}, **counts)
    total = {n: 0 for n in SOURCES}
    split = None
    for i in range(TRAIN_STEPS):
        batch = batch_to(next(it), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def run():
            return launched(ops, lambda: step(params, opt, batch))

        profiling = i > 0 and split is None      # step 1, or 2 if 1's window is discarded
        if profiling:
            ((params, opt, m), got), split = profiled_step(
                f"{cfg.name} training step {i}", run, whole)
        else:
            (params, opt, m), got = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        log(f"{cfg.name} training step {i}{' (profiled)' if profiling else ''}: "
            f"{tokens} tokens in {dt * 1e3:.3f} ms; loss "
            f"{loss:.4f}, grad norm {gnorm:.4f}, lr {float(m['lr']):.3e}; launches {got}; "
            f"peak memory allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if got != want:
            raise AssertionError(f"{cfg.name} training: launch counts {got}, want {want}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{cfg.name} training: loss {loss}, grad norm {gnorm}")
        for n, c in got.items():
            total[n] += c
    with torch.no_grad():
        moved = {k: float((f(params).float() - before[k].float()).abs().max())
                 for k, f in probes.items()}
    log(f"{cfg.name} training: largest change of each probed slice {moved}")
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"{cfg.name} training: weights did not move: {moved}")
    if torch.cuda.max_memory_allocated() >= 80e9:
        raise AssertionError(f"{cfg.name} training: peak memory past one card's 80 GB")
    if split is None:
        raise AssertionError(f"{cfg.name} training: no profiled step recorded every kernel "
                             f"of {whole}")
    missing = [n for n in must_run if not any(n in name for name in split["names"])]
    if missing:
        raise AssertionError(f"{cfg.name} training: the profiled step ran no {missing}")
    cuda_cores = [name for name in split["names"] if any(n in name for n in BF16_NEVER)]
    if cuda_cores:
        raise AssertionError(f"{cfg.name} training: a bf16 step ran {cuda_cores}")
    return total


def grads_against_plain(ops, label, fwd, layer, x, dy, swap, want):
    """The gradients of ``fwd(layer, x)`` against ``dy``, of the layer's
    leaves and of ``x``, through the kernels, then with ``ops.<name>``
    swapped for its plain version (``swap``: (name, plain); the oracle, for
    that call only), each within ``LAYER_GRAD_TOL`` x its largest entry; the
    kernels' launches must be ``want`` (the rest 0)."""
    from repro_torch.train import tree
    names = [k for k, _ in tree.items(layer)] + ["x"]

    def grads():
        leaves = tree.leaves(layer) + [x]
        return torch.autograd.grad(fwd(layer, x), leaves, dy)

    t0 = time.perf_counter()
    got, counts = launched(ops, grads)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    name, plain = swap
    real = getattr(ops, name)
    setattr(ops, name, plain)
    try:
        t0 = time.perf_counter()
        want_grads = grads()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        setattr(ops, name, real)
    worst = 0.0
    for n, a, b in zip(names, got, want_grads):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        worst = max(worst, err / scale)
        if not (err <= LAYER_GRAD_TOL * scale and math.isfinite(scale)):
            raise AssertionError(f"{label}: d{n} max |err| {err:.3e}, max |grad| {scale:.3e}")
    log(f"{label}, fp32: {len(names)} gradients through the kernels ({t_kernel * 1e3:.3f} ms; "
        f"launches {counts}) against the plain versions ({t_plain * 1e3:.3f} ms): largest "
        f"max |err| / max |grad| {worst:.3e} (limit {LAYER_GRAD_TOL:g})")
    if counts != dict({n: 0 for n in SOURCES}, **want):
        raise AssertionError(f"{label}: launches {counts}, want {want}")


def layer_grad_phase(ops, ref, tt, cfg):
    """Steps 19 and 24: one layer's gradients through the kernels against
    the plain versions, fp32, at the training tokens: an h2o-danube-1.8b
    attention layer (``cfg`` dense), an rwkv6-1.6b time-mix (``ssm``) or a
    Griffin recurrent block (``hybrid``)."""
    from repro_torch.models import griffin as gr
    from repro_torch.models import rwkv6 as rw
    from repro_torch.train import tree
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2)
    one = dataclasses.replace(cfg, num_layers=1)
    params = tt.init_params(gen, one, torch.float32)
    tokens = train_spec(cfg)[0]
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device="cuda", requires_grad=True)
    dy = torch.randn((1, tokens, cfg.d_model), generator=gen, device="cuda")
    if cfg.family == "ssm":
        layer = tt.layer_params(params["layers"], 0)["tmix"]
        zero = tt._rwkv_empty_state(cfg, 1, torch.float32, "cuda")
        fwd = lambda p, x: rw.time_mix(p, cfg, x, zero["x_tm"], zero["wkv"])[0]   # noqa: E731
        label, swap, want = (f"{cfg.name} one time-mix layer, {tokens} tokens",
                             ("wkv6", ref.wkv6_ref), dict(wkv6=1, wkv6_bwd=1))
    elif cfg.family == "hybrid":
        layer = tt.layer_params(params["tail"], 0)["rg"]
        zero = gr.init_recurrent_state(cfg, 1, torch.float32, "cuda")
        fwd = lambda p, x: gr.rglru_block(p, x, zero)[0]      # noqa: E731
        label, swap, want = (f"{cfg.name} one recurrent block, {tokens} tokens",
                             ("rglru_scan", ref.rglru_scan_ref),
                             dict(rglru_scan=1, rglru_scan_bwd=1))
    else:
        layer = tt.layer_params(params["layers"], 0)
        fwd = lambda p, x: tt._attn_layer_fwd(p, cfg, x, window=tt.attn_window(cfg))  # noqa: E731
        label, swap, want = (f"{cfg.name} one attention layer, {tokens} tokens",
                             ("flash_attention", ref.flash_attention_ref),
                             dict(flash_attention=1, flash_attention_bwd=1))
    layer = tree.map_leaves(layer, lambda t: t.detach().clone().requires_grad_(True))
    grads_against_plain(ops, label, fwd, layer, x, dy, swap, want)


def describe(cfg) -> str:
    if cfg.family == "ssm":
        mixer = f"{cfg.num_rwkv_heads} wkv heads of {cfg.rwkv_head_dim}"
    elif cfg.family in ("dense", "moe", "vlm", "encdec"):
        mlp = "gated" if cfg.gated_mlp else "plain"
        if cfg.family == "moe":
            mlp += (f" experts, {cfg.num_experts} top-{cfg.experts_per_token}, capacity "
                    f"factor {cfg.moe_capacity_factor:g}")
        else:
            mlp += " MLP"
        mixer = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, window "
                 f"{cfg.window_size}, rope theta {cfg.rope_theta:g}, {cfg.activation} "
                 f"{mlp}")
        if cfg.family == "vlm":
            mixer += f", M-RoPE {cfg.mrope}, {cfg.vision_tokens} vision tokens"
        elif cfg.family == "encdec":
            mixer += (f", {cfg.encoder_layers} encoder layers over {cfg.source_len} "
                      "frames")
    else:
        mixer = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, rnn "
                 f"{cfg.rnn_width}, conv {cfg.conv_width}, window {cfg.local_window}")
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, {mixer}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}")


def snapshot_engine_phase(serve, ops, cases, arch):
    """The two-turn conversation through the state-snapshot route."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, eng = serve.build_engine(arch, device="cuda")
    torch.cuda.synchronize()
    log(f"{arch} full width: {describe(cfg)}; {str(eng.dtype)[6:]} weights drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    ctx, extra, num_new = serve.conversation(cfg, False)

    zero_counts(ops)
    r1 = eng.generate("conv-0", ctx, num_new=num_new)
    snap1 = eng.store.entries["conv-0"].payload       # the state after turn 1's prompt
    ctx2 = ctx + r1.tokens + extra
    r2 = eng.generate("conv-0", ctx2, num_new=num_new)
    launches = read_counts(ops)

    steps = (len(ctx) + num_new) + (len(ctx2) - len(ctx) + num_new)
    if r1.reused_tokens != 0 or r2.reused_tokens != len(ctx) \
            or r2.prefill_tokens_computed != num_new + len(extra):
        raise AssertionError(f"reuse: turn 1 {r1.reused_tokens}, turn 2 "
                             f"{r2.reused_tokens}/{r2.prefill_tokens_computed}")
    # for every fed and every decoded token: rwkv6 one wkv6 launch per layer;
    # griffin one fused rglru step per recurrent layer, one decode per unit
    if launches != {n: steps * c for n, c in per_token(cfg).items()}:
        raise AssertionError(f"launch counts {launches}")
    for i, r in ((1, r1), (2, r2)):
        if len(r.tokens) != num_new or r.last_logits.shape != (cfg.vocab_size,) \
                or not bool(torch.isfinite(r.last_logits).all()):
            raise AssertionError(f"turn {i}: bad output")
        fed = r.prefill_tokens_computed
        log(f"{arch} turn {i}: fed {fed} tokens (reused {r.reused_tokens}) in "
            f"{r.prefill_time_s * 1e3:.3f} ms ({r.prefill_time_s / fed * 1e3:.3f} ms/token); "
            f"decode {num_new} tokens in {r.decode_time_s * 1e3:.3f} ms "
            f"({r.decode_time_s / num_new * 1e3:.3f} ms/token) -> {r.tokens}")
    log(f"{arch} launches on the main path ({steps} steps x {per_token(cfg)}): {launches}")
    log(f"{arch} peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"{arch} stored snapshot: {tree_bytes(snap1[1])} bytes; the store accounts "
        f"{eng.store.entries['conv-0'].size_bytes:.0f} bytes for {len(ctx2)} tokens")

    _, cold = serve.build_engine(arch, device="cuda", params=eng.params)
    rc = cold.generate("cold", ctx2, num_new=num_new)
    if rc.reused_tokens != 0:
        raise AssertionError("cold engine hit its empty store")
    # The same kernels at the same shapes on the same state: 0 is expected.
    scale = float(rc.last_logits.abs().max())
    tol = cases.TOL[torch.bfloat16] * scale
    err = float((rc.last_logits - r2.last_logits).abs().max())
    log(f"{arch} hit vs cold, last-position logits: max |err| {err:.6f} (limit {tol:.6f} "
        f"= 2e-2 x max |logit| {scale:.4f}); cold: fed {rc.prefill_tokens_computed} tokens "
        f"in {rc.prefill_time_s * 1e3:.3f} ms; tokens {rc.tokens}")
    if rc.tokens != r2.tokens or not err <= tol:
        raise AssertionError("hit path and cold path disagree")

    # replays of turn 2 from turn 1's stored state, unprofiled then profiled
    _, rep = serve.build_engine(arch, device="cuda", params=eng.params)
    rep.store.insert("replay", len(ctx), time.time(), payload=snap1)
    t0 = time.perf_counter()
    r = rep.generate("replay", ctx2, num_new=num_new)
    log(f"{arch} unprofiled replay of turn 2: {(time.perf_counter() - t0) * 1e3:.3f} ms "
        f"(feed {r.prefill_time_s * 1e3:.3f}, decode {r.decode_time_s * 1e3:.3f})")
    # every fed and decoded token of turn 2: one decode launch per unit, one
    # step kernel per recurrent layer
    steps2 = len(ctx2) - len(ctx) + num_new
    r, calls = whole_replay(
        f"{arch} turn 2",
        lambda i: rep.store.insert(f"prof{i}", len(ctx), time.time(), payload=snap1),
        lambda i: rep.generate(f"prof{i}", ctx2, num_new=num_new),
        {"decode_mma_kernel": steps2 * per_token(cfg)["decode_attention"],
         "wkv6_step_kernel" if cfg.family == "ssm" else "rglru_step_kernel":
             steps2 * (per_token(cfg)["wkv6"] + per_token(cfg)["rglru_step"])})
    if r.reused_tokens != len(ctx) or r.tokens != r2.tokens:
        raise AssertionError("replay of turn 2 differs from turn 2")
    check_decode_calls(arch, calls, steps2 * per_token(cfg)["decode_attention"])
    check_recurrence_calls(arch, cfg, calls, steps2)
    return launches


def check_recurrence_calls(arch, cfg, calls, steps):
    """A profiled replay of ``steps`` fed or decoded tokens ran the
    recurrence in the step kernels only, one launch per recurrent layer and
    token; logs device kernels (and copies and fills) per token."""
    new, old = (("wkv6_step_kernel", "wkv6_kernel<") if cfg.family == "ssm"
                else ("rglru_step_kernel", "rglru_fwd_"))
    want = steps * (per_token(cfg)["wkv6"] + per_token(cfg)["rglru_step"])
    got = sum(c for n, c in calls.items() if new in n)
    stale = sum(c for n, c in calls.items() if old in n)
    kernels = sum(c for n, c in calls.items() if not n.startswith(("Memcpy", "Memset")))
    log(f"{arch} profiled replay: {got} {new} launches, {stale} {old}; per fed or "
        f"decoded token {kernels / steps:.2f} device kernels and "
        f"{(sum(calls.values()) - kernels) / steps:.2f} copies or fills")
    if got != want or stale:
        raise AssertionError(f"{arch} profiled replay: {got} {new} and {stale} {old} "
                             f"launches, want {want} and 0")


# step 25, GreenCache's profile-and-solve path at repro/launch/serve.py's
# paper settings (its defaults: llama3-70b, a one-l40 plan, FR)
GC_MODEL = "llama3-70b"
GC_RATES = (0.2, 0.6, 1.0, 1.3, 1.6)      # req/s per server
GC_SIZES_TB = (0, 1, 2, 4, 8, 12, 16)
GC_WARMUP = 12000                         # prompts before each cell's window
GC_ZIPF = 0.4                             # the document task's skew
GC_GRID = "FR"
GC_CELL = (1.0, 8)                        # profiled twice: the same bits
GC_SHOWN_TB = (0, 4, 16)                  # hit rate and SLO share logged at GC_CELL's rate
DP_BUCKETS = 400                          # the DP's satisfied-request buckets


def greencache_phase(card, rates=GC_RATES, sizes_tb=GC_SIZES_TB, warmup=GC_WARMUP):
    """Step 25: profile both tasks and solve their 24-hour schedules; checks
    (a)-(e) raise. Returns each task's hourly sizes, solver, objective,
    feasibility and wall times."""
    import repro_torch.core.solver as solver
    from repro_torch.core.carbon import CarbonModel
    from repro_torch.core.profiler import run_profiler
    from repro_torch.serving.perfmodel import SERVING_MODELS, SLOS
    from repro_torch.workloads import (ConversationWorkload, DocumentWorkload,
                                       azure_rate_trace, ci_trace)

    model, carbon = SERVING_MODELS[GC_MODEL], CarbonModel()
    tasks = {"conversation": ("chat", lambda s: ConversationWorkload(seed=s)),
             "document": ("doc", lambda s: DocumentWorkload(seed=s, zipf_alpha=GC_ZIPF))}
    day_rates = [float(r) for r in azure_rate_trace(rates[-1], seed=3)]
    day_cis = [float(c) for c in ci_trace(GC_GRID, seed=4)]
    sizes = list(sizes_tb)
    out = {}
    for task, (kind, factory) in tasks.items():
        t0 = time.perf_counter()
        prof = run_profiler(model, task, factory, carbon, rates=list(rates), sizes_tb=sizes,
                            warmup_prompts=warmup)
        profile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = solver.solve_cache_schedule(prof, day_rates, day_cis, SLOS[(GC_MODEL, kind)],
                                          carbon)
        solve_s = time.perf_counter() - t0
        ed = res.explain_data
        C, Fr, n, rho = ed["C"], ed["F"], ed["n"], ed["rho"]
        # (a) the vectorised DP is its loop twin, bit for bit
        fields = ("sizes_tb", "objective_g", "feasible", "solver")
        loop = solver._solve_dp_reference(C, Fr, n, sizes, rho, 0.0, buckets=DP_BUCKETS)
        for prune in (False, True):
            vec = solver._solve_dp(C, Fr, n, sizes, rho, 0.0, buckets=DP_BUCKETS, prune=prune)
            if any(getattr(vec, f) != getattr(loop, f) for f in fields):
                raise AssertionError(f"GreenCache {task}: _solve_dp (prune={prune}) "
                                     f"{vec} != _solve_dp_reference {loop}")
        if res.solver == "dp" and any(getattr(res, f) != getattr(loop, f) for f in fields):
            raise AssertionError(f"GreenCache {task}: the solve {res} is not the DP's {loop}")
        # (b) every chosen size on the grid, one an hour
        if len(res.sizes_tb) != len(day_rates) or any(s not in sizes for s in res.sizes_tb):
            raise AssertionError(f"GreenCache {task}: sizes {res.sizes_tb} off the grid {sizes}")
        # (c) the SLO constraint, to the DP's bucket
        choice = [sizes.index(s) for s in res.sizes_tb]
        met = float(sum(n[t] * Fr[t, c] for t, c in enumerate(choice)))
        need = rho * float(n.sum()) - float(n.sum()) / DP_BUCKETS
        if res.feasible and met < need:
            raise AssertionError(f"GreenCache {task}: sum n F = {met} < {need}")
        # (d) no hit without a cache
        zero = {r: prof.cells[(r, 0)].hit_rate for r in rates} if 0 in sizes else {}
        if any(h != 0.0 for h in zero.values()):
            raise AssertionError(f"GreenCache {task}: size-0 hit rates {zero}")
        # (e) one cell profiled again: the same bits
        t0 = time.perf_counter()
        again = run_profiler(model, task, factory, carbon, rates=[GC_CELL[0]],
                             sizes_tb=[GC_CELL[1]], warmup_prompts=warmup).cells[GC_CELL]
        cell_s = time.perf_counter() - t0
        if dataclasses.asdict(again) != dataclasses.asdict(prof.cells[GC_CELL]):
            raise AssertionError(f"GreenCache {task}: cell {GC_CELL} profiled again "
                                 f"{again} != {prof.cells[GC_CELL]}")
        log(f"GreenCache {task} ({GC_MODEL}, {GC_GRID}): profile of {len(prof.cells)} cells "
            f"{profile_s:.3f} s, 24-hour solve {solve_s * 1e3:.3f} ms, cell {GC_CELL} again "
            f"{cell_s:.3f} s, host wall time (card: {card})")
        log(f"  hourly sizes, TB: {res.sizes_tb}")
        log(f"  solver={res.solver} objective={res.objective_g!r} g feasible={res.feasible}; "
            f"sum n F = {met!r} {'>=' if met >= need else '<'} rho sum n - sum n / "
            f"{DP_BUCKETS} = {need!r}; "
            f"_solve_dp == _solve_dp_reference, exhaustive and pruned")
        rate = GC_CELL[0]
        log(f"  rate {rate}: " + "; ".join(
            f"{s} TB hit rate {prof.cells[(rate, s)].hit_rate!r} SLO share "
            f"{prof.cells[(rate, s)].slo_frac!r}" for s in GC_SHOWN_TB if s in sizes))
        out[task] = {"sizes_tb": res.sizes_tb, "solver": res.solver,
                     "objective_g": res.objective_g, "feasible": res.feasible,
                     "profile_s": profile_s, "solve_ms": solve_s * 1e3}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, cases, ops, ref
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.launch import serve, shapes, train_100m
    from repro_torch.models import moe
    from repro_torch.models import transformer as tt

    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    spills = {f: n for lib in ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd",
                               "rglru_scan")
              for f, n in entry_spills(build.build_logs.get(lib, "")).items()}
    if any(n != (0, 0) for n in spills.values()):
        raise AssertionError(f"kernels spill: {spills}")

    flash_main, decode_main = shapes.main_path_shapes(get_config("yi-6b"))
    decode_main["griffin turn 2"] = shapes.griffin_decode_shape(get_config(GRIFFIN))
    if list(decode_main.values()) != cases.DECODE_MAIN:
        raise AssertionError(f"main-path decode shapes {decode_main} are not "
                             f"cases.DECODE_MAIN {cases.DECODE_MAIN}")
    dense_flash, dense_decode, dense_identity = shapes.dense_shapes()
    flash_main.update({f"dense: {k}": v for k, v in dense_flash.items()})
    decode_main.update({f"dense: {k}": v for k, v in dense_decode.items()})
    fam_flash, fam_decode, fam_identity = shapes.family_shapes()
    flash_main.update({f"vlm, encdec: {k}": v for k, v in fam_flash.items()})
    decode_main.update({f"vlm, encdec: {k}": v for k, v in fam_decode.items()})
    t0 = time.perf_counter()
    rows = kernels_phase(ops, ref, cases, flash_main, decode_main)
    plan_sweep(cases, dmod, cases.DECODE_MAIN + list(dense_decode.values()))
    identity_phase(cases, cases.FLASH_IDENTITY + dense_identity + fam_identity)
    log(f"kernels phase: {time.perf_counter() - t0:.3f} s")
    # the recurrent kernels' rows before any profile with host activity: after
    # the yi-6b replay's, every profiler window of the wkv6 rows lost a launch
    rwkv, griffin = get_config(RWKV), get_config(GRIFFIN)
    t0 = time.perf_counter()
    wkv_rows = wkv6_phase(ops, ref, cases, rwkv)
    log(f"wkv6 kernel phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    rg_rows, rg_step_rows = rglru_phase(ops, ref, cases, griffin)
    log(f"rglru kernel phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    bwd_rows = flash_bwd_phase(ops, ref, cases)
    log(f"flash backward kernel phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    fwd_device_phase(ops, cases, bwd_rows)
    log(f"fp32 training-entry windows: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    wkv_bwd_rows = wkv6_bwd_phase(ops, ref, cases)
    log(f"wkv6 backward kernel phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    rg_bwd_rows = rglru_bwd_phase(ops, ref, cases)
    log(f"rglru backward kernel phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    by_path = {"yi-6b": engine_phase(serve, ops, cases)}
    log(f"yi-6b engine phase: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    by_path[f"{RWKV} model phase"] = rwkv_model_phase(ops, tt, rwkv)
    log(f"{RWKV} model phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    by_path[RWKV] = snapshot_engine_phase(serve, ops, cases, RWKV)
    log(f"{RWKV} engine phase: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    by_path[f"{GRIFFIN} model phase"] = griffin_model_phase(ops, tt, griffin)
    log(f"{GRIFFIN} model phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    by_path[GRIFFIN] = snapshot_engine_phase(serve, ops, cases, GRIFFIN)
    log(f"{GRIFFIN} engine phase: {time.perf_counter() - t0:.3f} s")

    for arch in shapes.DENSE:
        t0 = time.perf_counter()
        by_path[arch] = engine_phase(serve, ops, cases, arch,
                                     profile=arch in DENSE_PROFILED)
        log(f"{arch} engine phase: {time.perf_counter() - t0:.3f} s, peak memory "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for arch in shapes.MOE:
        t0 = time.perf_counter()
        by_path[arch] = moe_phase(serve, ops, cases, tt, moe, arch)
        log(f"{arch} MoE phase: {time.perf_counter() - t0:.3f} s, peak memory "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    by_path[f"{shapes.LONG} long-context model phase"] = long_context_phase(
        ops, tt, cases, shapes, get_config(shapes.LONG))
    log(f"{shapes.LONG} long-context model phase: {time.perf_counter() - t0:.3f} s, peak "
        f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    by_path[shapes.VLM] = engine_phase(serve, ops, cases, shapes.VLM, profile=False)
    log(f"{shapes.VLM} engine phase: {time.perf_counter() - t0:.3f} s, peak memory "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, phase, arch in (("vision model phase", vision_phase, shapes.VLM),
                              ("model phase", encdec_phase, shapes.ENCDEC)):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        by_path[f"{arch} {name}"] = phase(ops, tt, cases, shapes, get_config(arch))
        log(f"{arch} {name}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    by_path["100M twin training"] = train_100m_phase(ops, train_100m)
    log(f"100M twin training phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    by_path[f"{TRAIN} training"] = train_phase(ops, get_config(TRAIN))
    log(f"{TRAIN} training phase: {time.perf_counter() - t0:.3f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    layer_grad_phase(ops, ref, tt, get_config(TRAIN))
    log(f"{TRAIN} one-layer gradient phase: {time.perf_counter() - t0:.3f} s")
    for arch in (RWKV, GRIFFIN):
        t0 = time.perf_counter()
        by_path[f"{arch} training"] = train_phase(ops, get_config(arch))
        log(f"{arch} training phase: {time.perf_counter() - t0:.3f} s, peak memory allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for arch in (RWKV, GRIFFIN):
        t0 = time.perf_counter()
        layer_grad_phase(ops, ref, tt, get_config(arch))
        log(f"{arch} one-layer gradient phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    zero_counts(ops)
    greencache_phase(card_line())
    if any(read_counts(ops).values()):
        raise AssertionError(f"the simulator launched kernels: {read_counts(ops)}")
    log(f"GreenCache profile and solve: {time.perf_counter() - t0:.3f} s")
    log(f"launches by path: {by_path}")
    log(f"whole run: {time.perf_counter() - t_start:.3f} s")

    main_rows = {"flash_attention": rows[("flash_attention", torch.bfloat16, "turn 2")][1],
                 "decode_attention": rows[("decode_attention", torch.bfloat16, "turn 2")][1],
                 "rglru_scan": rg_rows["prefill"][1],
                 "rglru_step": rg_step_rows["engine step"][1],
                 "wkv6": wkv_rows["engine step"][1],
                 "flash_attention_bwd": bwd_rows[(torch.bfloat16, TRAIN)],
                 "wkv6_bwd": wkv_bwd_rows[RWKV],
                 "rglru_scan_bwd": rg_bwd_rows[GRIFFIN]}
    # the engine feeds every token by steps, so the scan's path is the model's
    # prefill and forward
    main_path = {"flash_attention": "yi-6b", "decode_attention": "yi-6b",
                 "rglru_scan": f"{GRIFFIN} model phase", "rglru_step": GRIFFIN,
                 "wkv6": RWKV, "flash_attention_bwd": f"{TRAIN} training",
                 "wkv6_bwd": f"{RWKV} training", "rglru_scan_bwd": f"{GRIFFIN} training"}
    kernels = []
    for name, replaces in SOURCES.items():
        r = main_rows[name]
        launches = by_path[main_path[name]][name]
        if not launches:
            raise AssertionError(f"{name} did not launch on its main path {main_path[name]}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{CSRC[name]}",
            "replaces": replaces, "launches": launches,
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in ("device_ms", "plain_device_ms", "library_device_ms",
                                       "library_premasked_device_ms") if key in r}})
    # the flash backward's device kernels, and its rows at every training
    # shape, bf16 and fp32 (the forward's training entry and SDPA's forward
    # beside them; fp32 with the bound at the CUDA cores' rate too)
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "train_fwd_ms",
              "train_fwd_library_ms", "train_fwd_bound_ms", "cuda_cores_bound_ms",
              "train_fwd_cuda_cores_bound_ms", "train_fwd_device_ms",
              "train_fwd_library_device_ms")
    kernels[list(SOURCES).index("flash_attention_bwd")].update(
        device_kernels=BWD_KERNELS,
        **{key: {label: {f: r[f] for f in fields if f in r}
                 for (dtype, label), r in bwd_rows.items() if dtype == want}
           for key, want in (("training_shapes", torch.bfloat16),
                             ("training_shapes_fp32", torch.float32))})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

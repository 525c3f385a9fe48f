#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py    # every phase, one card

Phases, each fatal on failure (non-zero exit, no result line):

  1. card      — require CUDA, print the card's name and power limit
                 (nvidia-smi), turn TF32 off for the float32 phases.
  2. build     — compile every CUDA source of the port with nvcc (one
                 process per source, all started together) and print
                 ptxas's report, with one line per instantiation of K1/K2's
                 bf16 Hopper body (registers, spills, dynamic shared
                 memory), one per put kernel K3/K4 (registers, spills,
                 static and dynamic shared memory, tile plan), one per
                 instantiation of the WKV kernel K5 (registers, spills,
                 shared memory at the model's dtypes) and one per entry
                 of K1b (its bf16 Hopper body's delta_bf16, bounds,
                 dkdv_hopper, reduce_dkdv and dq_hopper kernels with the
                 dynamic shared memory they launch with, and the f32
                 delta, dkdv and dq kernels) and one per entry of K5b (the
                 WKV gradient: its states' launch wkv_bwd_chain per value
                 split, its chunk gradients wkv_bwd_chunk, with the
                 dynamic shared memory each launches with, and its du sum
                 wkv_bwd_du); a spill in any of them, or an entry missing
                 from the report, fails the phase.
  3. k1        — the flash_mqkv kernel (K1) against its plain PyTorch
                 version on the same card tensors: the CPU test shapes in
                 float32 and bfloat16 (GQA, padding, causal/window, carried
                 state, unfinalized output) and the flux-12b shapes, where
                 the finalized o and the unfinalized (o', l, m) are held to
                 limits on both the largest error and the error's norm.
  4. k2        — the fused ring step (K2) on the same cases and on the
                 shapes the SP path gives it: (o, l, m) bitwise equal to
                 K1's on the same inputs and within FLUX_TOL of the plain
                 version, the forwarded chunk bitwise equal to the input,
                 the completion word set.
  5. k3/k4     — the put kernels on the reference's uneven shapes and on
                 the serve shapes, float32 and bfloat16, over a 16-rank
                 shift and a Ulysses stage perm: bitwise delivery, every
                 signal word at the put's epoch.  Then the PUT_EDGES cases:
                 offset views at 2- and 4-byte alignment (nothing written
                 outside a view), entries of very different sizes and of
                 sizes no multiple of 16 bytes in one launch, 96 entries,
                 and three puts back to back on one side stream and one
                 set of words; every arrive word back at 0.
  6. block     — one flux-12b DiT block at full width (d 3072, 24 x 128
                 heads, d_ff 12288), perturbed weights, L = 1280, float32 on
                 the card through K1, against the same block in float32 on
                 the CPU through the plain path.
  7. sp-block  — the same block under swift_torus (comm_backend "pallas",
                 kernel_interpret False) on 16 virtual ranks: mesh (pod 2,
                 model 8), which launches K1, K2 and K4, then mesh (model
                 16), which launches K3 instead of K4; against the CPU
                 block, with the launch counts the schedule implies.
  8. serve     — DiTServer on flux-12b at full width and depth (96 layers,
                 bfloat16, random weights from a seed with the zero-init
                 tensors perturbed) at SP degree 1: two 4096-latent
                 requests batched and one 1024-latent request, STEPS steps,
                 no guidance.  Outputs must be finite and moved from their
                 noise, and K1's launch count must equal 96 x steps x
                 forwards.  Every DiTServer and ARServer of the script
                 serves captured (serving/graphs.py: step 0 of a bucket is
                 its eager warm-up, step 1 its capture and first replay,
                 the rest replays) unless it is an eager oracle; each
                 captured server prints one line per graph (capture and
                 instantiation host seconds, replays, launches per
                 replay).
  9. serve-sp  — the same server, requests and weights (the first
                 SERVE_SP_LAYERS layers; PR 19 ran all 96) under
                 swift_torus on mesh (pod 2, model 8): finite, moved latents, K1/K2/K4
                 launch counts as the schedule implies, and latents within
                 SERVE_SP_TOL of a degree-1 server's at the same depth.  Then the 1024-latent
                 request on mesh (model 16) (K3; at SERVE_SP_ROUTE_LAYERS
                 against a degree-1 server of that depth), and once more on (pod 2,
                 model 8) with one KV chunk of every attention dropped,
                 which must break SERVE_SP_TOL.
 10. k5        — the RWKV6 WKV kernel (K5) against its plain version on the
                 same card tensors: the reference test's (L, N, chunk) sweep in
                 float32, bfloat16 and the model's mix (r, k, v, u bfloat16,
                 w float32), and the rwkv6-1.6b shapes (H 32, N 64, chunk 64)
                 of the prefill phase, held to WKV_TOL on both the largest
                 error and the error's norm; and the model's mix at N 64
                 on the rows that make the wrapper split a row's value
                 columns over 1, 2 and 4 blocks.
 11. lm-block  — one rwkv6-1.6b layer at full width (d 2048, 32 x 64 heads,
                 d_ff 7168), perturbed weights, L 1024, B 1, float32 on the
                 card through K5 (launched exactly once) against the same
                 layer in float32 on the CPU through the plain path.
 12. lm-prefill— rwkv6-1.6b at full width and depth (24 layers, bfloat16,
                 weights from seed 0 with the zero-init tensors perturbed):
                 last-position logits of B 4 x L 4096 and B 1 x L 1024
                 prompts, finite, with K5 launched 24 x forwards.  Then in
                 float32 at B 2, L 256, every layer's prefill output (through
                 K5) against the same layer decoded token by token from the
                 same input (rwkv6_decode_step, no kernel) within LM_TOL, and
                 a negative control — every K5 call split at L/2 into two,
                 so the second half loses its carried state — that must
                 exceed LM_TOL ten times over; the end-to-end logits of the
                 two paths are reported.  Prompt lengths are multiples of
                 the WKV chunk 64, as the scan requires for L > 64.
 13. serve-lm  — ARServer on the bfloat16 model: 4 slots, 6 requests of
                 16-64 prompt tokens and 16 new tokens each, by aged
                 priority; every request completes, every token lies in
                 [0, vocab), the tracker's counters agree.
 14. numbers   — K1's time per call at the four flux shapes and at the ring
                 shapes of the SP path (with TFLOP/s and the share of the
                 bound), K2/K3/K4's at the serve shapes (K3/K4 also at the
                 1024-latent put, [1, 80, 3, 128]), each beside its
                 bound, its plain version (K1 at the flux shapes) and one
                 PyTorch call that computes the same function
                 (scaled_dot_product_attention, Tensor.copy_; yardsticks the
                 port never calls); one bf16 layer at the serve shape, at
                 degree 1 and under swift_torus, traced by torch.profiler
                 (host wall clock, device busy time and idle share); K5's
                 time at B 4 x L 4096 and B 1 x L 1024 beside its bound (the
                 operations at the CUDA-core and the TF32 rate, and the
                 bytes) and its plain version (no single PyTorch call
                 computes the WKV scan), and one traced rwkv6-1.6b prefill
                 with K5's share.

Phases 15 to 21 run after serve-sp (20 right after it):

 15. paper-attn — K1 at the paper's workloads (configs/shapes.py) at degree
                 1: flux_3072 (BH 24, L 37,120, D 128) and cogvideox_20s (BH
                 24, L 49,408, D 64), bf16, not causal, against its plain
                 version on the first PAPER_ROWS query rows (the whole score
                 matrix does not fit); K2 at their Pull-KV ring step on mesh
                 (pod 2, model 8) against its plain version; each timed
                 beside its bound and SDPA.
 16. layer-paper— the breakdown of one bf16 layer (B 1) of each workload,
                 at degree 1 and under swift_torus on mesh (pod 2, model 8):
                 wall clock, device time, idle share, top kernels.
 17. serve-cogvideox — the fp32 cogvideox-5b block (d 3072, 24 x 64 heads)
                 card vs CPU at L 1280, then DiTServer at degree 1 on
                 cogvideox-5b at full width and depth (42 layers, bf16), one
                 request of 49,152 latent tokens, COGVIDEO_STEPS steps:
                 finite, moved latents, K1 launched 42 x forwards.
 18. serve-hybrid — DiTServer on the same weights (the first HYBRID_LAYERS
                 layers; PR 17 ran all 42) over mesh (cfg 2, pipe 2,
                 data 1, model 4): swift_torus on the model axis (K1 and the
                 direct put K3), the CFG pair (guidance 4) on the cfg axis,
                 the displaced pipeline (pp 2, 4 patches) with its hand-offs
                 through K3; one request of 12,288 latent tokens, STEPS
                 steps.  Gates (a)-(d) of ``serve_hybrid``: all-warm latents
                 within SERVE_SP_TOL of the degree-1 server's sequential
                 CFG; the displaced run finite, drifting, within
                 DISPLACED_SHARE of the all-warm run yet not equal to it; a
                 displaced forward on a warm state equal to the warm forward
                 within DISPLACED_FWD_TOL (and not so with the stale segment
                 dropped); the launch counts the schedule implies.
 19. hier      — the hierarchical all-to-all on one flux-12b layer at the
                 serve shape (B 2, L 4352, bf16), kernel path: swift_torus
                 on mesh (pod 2, model 8) with hier_a2a bitwise equal to
                 the flat layer, with 18 K4 launches per layer against 21
                 and K1/K2 unchanged; ulysses on mesh (pod 2, model 4)
                 hierarchical vs flat, bitwise; the fp8 wires (e4m3, e5m2)
                 engaged and within FP8_TOL of exact beside a control with
                 one Push-O chunk dropped, one inter put's payload and
                 scale from the card equal to the CPU codec's, and K4 on
                 that fp8 payload plus its 0-d float32 scale bitwise as the
                 plain landing copy (timed); each variant's wall clock,
                 device time and put time.
 20. profile   — run right after serve-sp, on its weights:
                 DiTServer(profile=True) on flux-12b at full width and
                 PROFILE_LAYERS layers on mesh (pod 2, model 8), one 1024-latent request,
                 PROFILE_STEPS steps (an eager warm-up, the capture and its
                 replay, a replay): latents bitwise those of profile=False,
                 the spans' JSONL passing ``python -m
                 repro_torch.launch.trace_report --check``, the overlap rows
                 of the torus hops, the ring shifts and the Push-O puts, for
                 the warm-up and for the replays apart, and the step wall
                 clock with and without the profiler.
 21. commcheck — ``python -m repro_torch.launch.commcheck --profile`` on the
                 card: six comm.trace lines OK, exit 0, its spans passing
                 the trace report's check.

Phase 22, capture, holds each captured server bitwise to the same server
with capture=False, on the same requests in the same run: degree 1 at full
depth (after serve-sp), swift_torus on mesh (pod 2, model 8) and (model
16) at CAPTURE_LAYERS layers with launches per replay equal to the eager
step's and every signal word the steps' puts write at its epoch after a
replay onto zeroed words, a captured batch parked after step 1 and
restarted against the unparked run; the hybrid warm/displaced graphs in
float32 at HYBRID_CAPTURE_LAYERS layers (end of serve-hybrid); ARServer's
tokens (end of serve-lm).  It prints each step's wall clock captured
against eager.  layer-paper and numbers add one captured swift_torus layer
(wall clock, device time, idle share).  Phase 23, serve-cli (after
commcheck), runs ``python -m repro_torch.launch.serve`` on the card:
flux-12b at degree 1 (16 of its 96 layers) and on --mesh pod (8), and
rwkv6-1.6b.

Phases 24 to 27 (after serve-lm) and the numbers phase serve the dense and
vision-language attention LMs:

 24. dense-block — one full-width float32 layer of each of qwen2-1.5b,
                 stablelm-3b (partial rotary, LayerNorm, head dim 80, which
                 K1 runs zero-padded to 128), starcoder2-7b (window 4096,
                 GELU, GQA 9), chatglm3-6b (rope2d, GQA 16) and qwen2-vl-2b
                 (M-RoPE) through K1 on the card against the CPU's plain
                 path at L DENSE_BLOCK_L within LM_BLOCK_TOL; starcoder2 at
                 L WINDOW_BLOCK_L against K1's plain version on the card
                 (the CPU would take minutes) and against its unwindowed
                 layer, which must differ; one K1 launch per layer.
 25. dense-prefill — qwen2-1.5b at full width and depth (28 layers, bf16),
                 last-position logits of B 4 x L 4096: finite, K1 launched
                 28 times, wall clock, device time and idle share (traced);
                 then SP prefill on mesh (pod 2, data 2, model 2) (swift
                 over (pod, model), the batch over data: P_u 2 x P_r 2) at
                 full width, 4 layers, float32, against degree 1 within
                 DENSE_SP_TOL, with the K1/K2/K4 launches of the plan.
 26. dense-decode — teacher-forced bundle.step (core/decode.py, the KV
                 cache sharded on L) against bundle.apply (K1), float32:
                 qwen2-1.5b at 4 layers over 256 positions at degree 1 and
                 on mesh (pod 2, model 8); starcoder2-7b at 2 layers over
                 the 64 positions past its window, with the unwindowed
                 prefill as the control.
 27. serve-dense — ARServer on the bf16 qwen2-1.5b (bf16 KV caches), 4
                 slots, 6 requests of 16 new tokens; captured tokens bitwise
                 the capture=False twin's; tick wall clock both ways.
The numbers phase adds K1 at the dense prefill shapes (qwen2's causal GQA,
starcoder2's window, stablelm's head dim 80) beside the bound over the
visible pairs, its plain version and SDPA; serve-cli adds qwen2-1.5b at
degree 1 and on --mesh pod.

Phases 28 to 34 (after serve-dense) settle the bf16 parting of the
launcher's SP decode and serve the hybrid and MoE LMs:

 28. decode-gap — the launcher's qwen2-1.5b decode at full depth (its
                 weights and requests) at degree 1 and on mesh (pod 2,
                 model 8),
                 token by token: where the runs' tokens part, the top-2
                 logit gap, the runs' logit difference and bf16's spacing;
                 in float32 the runs must agree, and every bf16 parting
                 must be a near-tie within the runs' logit difference.
 29. hymba-block — one full-width float32 hymba-1.5b layer (attention and
                 the SSD branch, mean-combined) through K1 on the card
                 against the CPU's plain path at L HYMBA_BLOCK_L, as a
                 global layer (window 1 << 30) and as a windowed one (2048),
                 one K1 each, within LM_BLOCK_TOL; the two must differ.
 30. hymba-prefill — hymba-1.5b at full width and depth (32 layers, bf16),
                 B 4 x L 4096, last_only: 32 K1 launches, wall clock,
                 device time, idle share, top kernels, K1's share; then SP
                 prefill on (pod 2, data 2, model 2) at 4 layers, float32,
                 within FAMILY_SP_TOL of degree 1, with its launches.
 31. serve-hymba — ARServer on it (4 slots, bf16 caches): captured tokens
                 bitwise the eager server's; tick wall clock both ways.
 32. moe-block — qwen2-moe-a2.7b's MoE layer at full width, float32,
                 capacity 8.0: EP 1 and EP 4 on mesh (model 4) (the
                 dispatch's three exchanges as 9 K3, or 9 K4, launches)
                 within MOE_TOL of the dense function and of each other.
 33. moe-prefill — qwen2-moe-a2.7b at full width and depth (24 layers, 60
                 routed + 4 shared experts, bf16), B 4 x L 4096, last_only:
                 24 K1, wall clock, device time, idle share, top kernels,
                 the shares of the expert products and of routing +
                 dispatch + combine; SP prefill on (pod 2, data 2, model 2)
                 at 2 layers, float32, capacity 8.0 (experts over model: 6
                 K3) within FAMILY_SP_TOL of degree 1.
 34. serve-moe — ARServer on it: tokens bitwise, tick wall clock captured
                 and eager against the weight-read floor.
 35. train-layer — one full-width float32 layer plus the loss (embeddings
                 cut to 4096 rows), B 1 x L 1024, remat "full", of each of
                 qwen2-1.5b, rwkv6-1.6b, hymba-1.5b and qwen2-moe-a2.7b:
                 every parameter's gradient on the card (K1 twice and K1b
                 once, or K5 twice and K5b once) against the CPU's
                 (rwkv6: the card's without K5/K5b, see train_layer)
                 within TRAIN_TOL of its max|grad|, and the gradient gate
                 (none missing, none all zero: what a kernel output
                 without an autograd graph breaks).
 36. train     — python -m repro_torch.launch.train --arch qwen2-1.5b
                 --steps 5 --seq 1024 --batch 4 in a subprocess, full width
                 and depth, bf16: every loss finite, 56 K1 and 28 K1b
                 launches per step, parameters moved from the seed's init,
                 the checkpoint loads and saves back bit for bit; median
                 step time, tokens/s and peak memory.
 36b. train-breakdown — one such step in process, traced: wall, device
                 busy and idle share, the device ms of K1b, the GEMMs, K1
                 and the rest; AdamW alone timed with CUDA events.
 37. train-curve — Trainer on the reduced qwen2-1.5b (float32) at the CPU
                 test's config on the card: the loss falls by more than 0.2
                 in 40 steps.
 38. whisper   — whisper-tiny at full width, B 4, 1536 frames, decoder L
                 448: float32 logits card vs CPU within TRAIN_TOL,
                 teacher-forced decode with caches against the prefill,
                 one bf16 train step with the gradient gate.
 39. train-rwkv6, train-hymba — the launcher as in phase 36 on
                 rwkv6-1.6b (24 layers: 48 K5 and 24 K5b launches per
                 step) and hymba-1.5b (32 layers: 64 K1 and 32 K1b), full
                 width and depth, bf16, B 4 x L 1024, 5 steps from the
                 seed's fresh init: finite losses, step time, tokens/s,
                 peak memory.
 40. train-moe — Trainer in process on qwen2-moe-a2.7b at full width and
                 4 of its 24 layers (all 24 with their float32 moments
                 need more than one card holds), bf16, B 4 x L 1024, 5
                 steps: finite losses, 8 K1 and 4 K1b launches per step
                 (EP 1: no put kernel), step time, tokens/s, peak memory
                 above what earlier phases left allocated.
 41. train-sp  — training over the virtual mesh (pod 2, model 2), SP over
                 both axes, swift_torus (P_u 2 x P_r 2), comm_backend
                 "pallas": the backward of the SP schedule
                 (core/sp_grad.py: K1b per KV chunk, K4 for every
                 transfer).  One fp32 qwen2-1.5b layer plus the loss: its
                 gradients within 1e-4 of degree 1 on the card, the
                 gradient gate, the launches the schedule implies, a
                 negative control (one ring step's dK/dV dropped) that
                 must break the gate, K1b's zeros on a fully hidden chunk;
                 then qwen2-1.5b at full width and depth in bf16, B 4 x L
                 1024, Trainer in process: the gradient gate, one warm-up
                 and 3 timed steps, finite losses, step 0 within 2e-2 of
                 the degree-1 loss, K1/K2/K1b/K3/K4 launches per step as
                 the schedule implies; step time, tokens/s and peak memory
                 beside the train phase's.
 42. examples  — the four examples of src/repro_torch/examples in process
                 on the card at their own sizes: quickstart (every SP
                 strategy on the virtual mesh (pod 2, data 2, model 2)
                 against the oracle, within the float32 TOL of max|ref|
                 with TF32 off), serve_dit (6 mixed-resolution requests
                 on the hybrid mesh (cfg 2, pipe 2, model 2), then the
                 burst of part two: 10 requests, every latent finite),
                 generate_text (6 prompts x 8 tokens through ARServer on
                 (pod 2, data 2, model 2)) and train_lm (the ~95M
                 qwen2-family model, 30 steps of batch 32, the loss
                 falling); K1, K2, K3 and K4 each launched by quickstart
                 or serve_dit.  Budget EXAMPLES_BUDGET_S, printed.
 43. serve-procs — the process mesh (launch/procs.py): four worker
                 processes on the one card, one rank each, every put into a
                 peer process's buffers mapped over CUDA IPC: sp_attention
                 at the 4096-bucket flux shape on (pod 2, model 2) (K1, K4;
                 under ring K1, K2) and (model 4) (K1, K3) bitwise the
                 virtual mesh's shards,
                 with its per-rank share of launches and a wrong-route
                 negative control; DiTServer led by process 0 on (pod 2,
                 model 2) at 2 of 96 layers within PROCS_HYBRID_TOL of the
                 virtual-mesh server, its 1024 request served again with
                 every Ulysses hop to the sender as a negative control;
                 ``launch.serve --procs 4`` (K3) beside the workers.
                 Runs after profile.  Budget SERVE_PROCS_BUDGET_S, printed.
 44. serve-procs-hybrid — the hybrid mesh over a process mesh: eight
                 worker processes, two of the 16 ranks of (cfg 2, pipe 2,
                 data 1, model 4) each; DiTServer led by process 0 on
                 cogvideox-5b (full width, bf16, 4 of 42 layers), one
                 request of 12,288 latents, guidance 4 with a branch per
                 cfg coordinate (velocities exchanged by K3 over cfg), the
                 displaced pipeline (hand-offs by K3 to the next pipe
                 rank's process, the warm step's layer KV gathered by K3
                 over model), 3 steps, within PROCS_HYBRID_TOL (inside
                 SERVE_SP_TOL) of the virtual-mesh twin; each process's launches against the
                 schedule's share and its slab's high-water mark; as
                 negative controls the served run with every cfg exchange
                 put to its own branch, and a hand-off by the flat-rank
                 owner rule; ``launch.serve --mesh multipod --procs 4``
                 beside the workers.  The phase fails past
                 PROCS_HYBRID_BUDGET_S.
 45. serve-procs-lm — the language models over a process mesh: four
                 worker processes, a rank each, each running its batch
                 slice and sequence shard; at full width, 4 layers,
                 prefill B 2 x L 4096: qwen2-1.5b (bf16) under
                 swift_torus on (pod 2, model 2) (K1, K2, K4) and ring on
                 (model 4), hymba-1.5b (fp32), rwkv6-1.6b (K5 per
                 shard; token shifts and state passes as puts) and
                 qwen2-moe-a2.7b (bf16, each process holding its EP
                 ranks' experts, the EP exchange by K3, ring on (model
                 4) and swift_torus on (pod 2, model 2)), each
                 process's logits rows within PROCS_HYBRID_TOL of the
                 virtual-mesh twin's (bitwise logged), launches against
                 the twin's share (hymba in bf16 too: its error logged),
                 qwen2-moe's aux equal and its expert bytes 1/EP of the
                 twin's; arctic-480b's token-gather decode (published
                 widths, 8 of its 128 experts, fp32) within
                 PROCS_ARCTIC_TOL; whisper-tiny fp32 (Lq !=
                 Lk; K3) within PROCS_WHISPER_TOL; ARServer led by
                 process 0 on qwen2 and on qwen2-moe with its tokens
                 equal to the twin's (the decode merge's gathers by K4,
                 the MoE sums' by K3); negative controls: misrouted
                 Ulysses hops, token shifts, state passes and EP
                 exchange hops; ``launch.serve --arch qwen2-moe-a2.7b
                 --procs 4`` at full depth (24 layers), alone on the
                 card after the workers.  The phase fails past
                 PROCS_LM_BUDGET_S.
The numbers phase also prints the first whole-step shares of the card's
peak: the dry-run's counted FLOPs (launch/dryrun.py on the meta device)
of the train phase's qwen2-1.5b step and of the serve phase's degree-1
flux-12b step, over (the measured step time x 989e12), and the mfu that
launch/calibrate.py fits to the serve phase's degree-1 captured step
times (one card: no wire term).  These are printed lines, not gates.
K5b (rwkv6_wkv_bwd, the gradient of K5) is checked right after K1b: the
k5b phase holds it against its plain version at rwkv6-1.6b's training
shape (B 4 x L 1024, H 32, N 64) and at L 32 (below the chunk), in
float32 and with the model's bf16 r, k, v, u, bitwise on repeat, with a
negative control (the state's gradient dropped between chunks) that
must break the float32 gate; the numbers phase times it there beside
its bound and its plain version.
K1b (flash_mqkv_bwd, the gradient of K1) is checked right after K5: the
k1b phase holds it against its plain version at the train path's shapes
(qwen2 causal GQA, whisper's cross-attention, flux, stablelm's padded
head dim 80, starcoder2's window, padding with a fully masked row,
train-hymba's GQA group of 5 under its window and train-moe's MHA) in
float32 (the CUDA-core parity body) and bf16 (the Hopper body: wgmma
products from TMA tiles, under kernels/flash_mqkv.py's bwd_tile_plan,
printed per case), bitwise on repeat, with two negative controls (the
mask off at the qwen2 shape) that must break the float32 and the bf16
gates.
The numbers phase adds K1b at the qwen2 training and whisper cross-
attention shapes (beside its bound, its plain version and SDPA's
backward), and K1 at hymba's window and global shapes and at
qwen2-moe's causal shape (beside SDPA, the bound over the visible pairs and
its plain version) and K3/K4 on the EP dispatch put (beside one copy_);
serve-cli adds hymba-1.5b and qwen2-moe-a2.7b at degree 1 and on --mesh
pod.

A kernel's "launches" in the kernels line come from the serve-sp run on
mesh (pod 2, model 8) — the counts are set to 0 just before it and read
just after — except K3's, which come from the same kind of run on mesh
(model 16), the route that takes the direct put, and K5's, which come
from the lm-prefill run, and K1b's and K5b's, which the train and
train-rwkv6 phases' launchers count from 0 in their own processes and
print.  K1b's, K3's and K4's add the launches of train-sp's timed steps
(counted from 0 after its warm-up step).  K1-K4's add serve-procs' (each
counted from 0 in every worker process, summed over the four): K2's from
its ring sp_attention, K3's from its (model 4) one, K1's and K4's from its
served run; K1's and K3's also serve-procs-hybrid's served run (summed
over its eight processes); K1-K5's also serve-procs-lm's prefills (K3's
and K4's their MoE exchanges and aux gathers, and its served runs'
decode gathers too), summed over its four processes.  The line before the
last is the kernels JSON; the last line is {"ok": true, "device": {...}}.
Kernels are built from this checkout into build/repro_torch/ on first use.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
L2_BYTES = 50 * 2**20  # H100 L2 cache
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # K1 vs plain, relative to max|ref|
# K1 vs plain at the flux shapes, bfloat16, per output:
# (max|d| / max|ref|, ||d|| / ||ref||), 2-10x the largest seen on an H100
# (o 5.2e-3 / 2.5e-3, o' 1.6e-3 / 1.6e-3, l 1.3e-6 / 5.2e-7, m 4.8e-7 /
# 1.6e-7); one dropped 64-key tile at L 4352 gives ~0.12 on o, 1.5e-2 on l
FLUX_TOL = {"o": (1e-2, 5e-3), "o'": (5e-3, 5e-3), "l": (1e-5, 5e-6),
            "m": (5e-6, 5e-6)}
BLOCK_TOL = 1e-4  # block, card vs CPU, relative to max|out|
FLUX_SHAPES = ((24, 1280), (48, 1280), (24, 4352), (48, 4352))  # (BH, L)
STEPS = 4  # sampler steps of the serve phases
# serve-sp's and profile's depth of flux-12b's 96 layers (PR 19 ran them at
# 96: ~30 s to capture and instantiate each SP graph).  serve-sp's negative
# control (one KV chunk of every attention dropped) shrinks with depth: on
# an H100 it read 6.0e-2 at 96 layers and 3.4e-2 at 32 against
# SERVE_SP_TOL 0.03
SERVE_SP_LAYERS = 32
# serve-sp's depth on mesh (model 16), the K3 route: no control there
# shrinks with depth, so it runs at half of SERVE_SP_LAYERS against a
# degree-1 server of its own depth (PR 32; 28.7 s at 32 layers)
SERVE_SP_ROUTE_LAYERS = 16
ROTATE = 8  # distinct input sets of a timed K2/K3/K4 call (see rotating)
SOURCES = ("flash_mqkv", "ring_flash", "one_sided", "rwkv6_wkv",
           "flash_mqkv_bwd", "rwkv6_wkv_bwd")  # csrc/<name>.cu
# serve-sp latents vs the degree-1 serve, as ||x_sp - x_1|| / ||x_1 - noise||
# (the error relative to what the model moved the latents), bfloat16
# (2.8x the largest value seen, 1.085e-2, on an H100 80GB HBM3 at 700 W;
# one KV chunk of every attention dropped gave 6.0e-2 there)
SERVE_SP_TOL = 0.03
# q and k weights scaled so that the random model's attention is peaked
# (logit spread ~ ATTN_SHARPEN**2 times that of the modulated input): see
# perturb_zero_init
ATTN_SHARPEN = 2.0
# the SP configurations: 16 virtual ranks, P_u 8 x P_r 2 for 24 heads
SP_MESHES = {
    "pod2xmodel8": ((2, 8), ("pod", "model"), ("pod", "model"), "landing_copy"),
    "model16": ((16,), ("model",), ("model",), "remote_put"),
}
P_U, P_R, RANKS = 8, 2, 16
# per layer and forward, over all ranks: every ring circulation (stage 0,
# P_u - 1 Pull-Q, P_u - 1 Pull-KV) is P_r - 1 K2 steps and one K1 step per
# rank; every torus put (P_u - 1 each of Pull-Q, Pull-KV, Push-O) is ONE
# K3 or K4 launch, which covers all ranks
CIRCULATIONS = 1 + 2 * (P_U - 1)
K1_PER_LAYER = RANKS * CIRCULATIONS
K2_PER_LAYER = RANKS * CIRCULATIONS * (P_R - 1)
PUTS_PER_LAYER = 3 * (P_U - 1)

PEAK_F32 = 67e12  # H100 SXM float32 FLOP/s on the CUDA cores (data sheet)
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
# K5 vs plain on the same card tensors, (max|d| / max|ref|, ||d|| / ||ref||):
# ~5x the largest values the first run saw on an H100 80GB HBM3 at 700 W
# (9.65e-07 and 5.56e-07 over the sweep and the model's shapes; the two
# differ by summation order only)
WKV_TOL = (5e-6, 3e-6)
# the reference test's (L, N, chunk) sweep of the WKV kernel
WKV_SWEEP = ((32, 8, 8), (64, 16, 16), (128, 64, 64), (64, 32, 64))
# (r, k, v, w, u) dtypes of the sweep: float32, bfloat16, the model's mix
WKV_DTYPES = {"f32": ("float32",) * 5, "bf16": ("bfloat16",) * 5,
              "model": ("bfloat16",) * 3 + ("float32", "bfloat16")}
WKV_SETS = 3  # input sets of a timed K5 call, at least (~470 MB each at B 4 x L 4096)
LM_BLOCK_TOL = 1e-4  # lm-block, card vs CPU, relative to max|out|
# prefill vs teacher-forced decode, max|d| of each layer's output: the
# reference's own 5e-4 (tests/test_decode_consistency.py, on the logits of
# the 2-layer reduced config).  At full depth the logits cannot be held: on
# an H100 (700 W) they differed by 1.18 at max|logit| 5.2 (float32 rounding
# amplified through 24 random layers) against 7.4 for the dropped-state
# control, so each layer is held from the same input instead.
LM_TOL = 5e-4
# lm-prefill prompts (B, L): L a multiple of the WKV chunk 64
LM_PREFILL = ((4, 4096), (1, 1024))
# serve-lm requests: (rid, prompt tokens, priority); 16 new tokens each
LM_REQUESTS = ((0, 16, 0.0), (1, 64, 0.0), (2, 32, 1.0), (3, 48, 0.0),
               (4, 24, 2.0), (5, 56, 0.0))
LM_NEW_TOKENS = 16
# the dense and vlm attention LMs (phases 24-27)
DENSE_BLOCK_L = 1024  # dense-block, card vs CPU
WINDOW_BLOCK_L = 4608  # starcoder2's layer: above its window of 4096
DENSE_PREFILL = (4, 4096)  # dense-prefill (B, L), qwen2-1.5b at full depth
# SP prefill on examples/generate_text.py's mesh: swift over (pod, model),
# the batch over data; qwen2-1.5b's 12 / 2 heads plan P_u 2 x P_r 2
DENSE_SP_MESH = ((2, 2, 2), ("pod", "data", "model"))
DENSE_SP_LAYERS = 4
DENSE_SP_BL = (2, 1024)
DENSE_SP_TOL = 1e-4  # SP vs degree 1, fp32, relative to max|logits|
DENSE_DECODE_LAYERS = 4
# qwen2 decode positions (8 per rank on 16 ranks; 256 before they were
# halved to make room for serve-procs-hybrid)
DENSE_DECODE_POS = 128
WINDOW_DECODE_POS = 64  # starcoder2 positions decoded past its window


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _finite_pair(a, b):
    """a and b at the finite entries of b, or None unless the non-finite
    entries (-inf maxima of fully masked rows) agree exactly."""
    import torch
    a, b = a.float(), b.float()
    fin = torch.isfinite(b)
    if (not torch.equal(fin, torch.isfinite(a))
            or not torch.equal(a[~fin], b[~fin])):
        return None
    return a[fin], b[fin]


def rel_err(a, b, floor: float = 1.0) -> float:
    """max|a - b| / max(floor, max|b|) over finite entries (see
    _finite_pair; inf when the non-finite entries disagree)."""
    pair = _finite_pair(a, b)
    if pair is None:
        return float("inf")
    a, b = pair
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max()) / max(floor, float(b.abs().max()))


def norm_err(a, b) -> float:
    """||a - b|| / ||b|| over finite entries: every entry counts, so a
    dropped KV tile or a swapped row shows however small each value is."""
    pair = _finite_pair(a, b)
    if pair is None:
        return float("inf")
    a, b = pair
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def time_call(fn, reps: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call.  A sleep kernel of ~1 ms per rep
    holds the device while the host enqueues the timed launches, so the
    events bracket back-to-back device work even where a call costs the
    host more than it costs the device; the host time is that of the
    enqueue loop."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 2_000_000)  # cycles: ~1 ms per rep
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    return time_call(fn, reps, warmup)[0]


def rotating(calls):
    """One callable that runs ``calls`` in turn, each on its own inputs:
    with ROTATE sets that together touch well over the 50 MB L2, every
    timed call finds its inputs in HBM, as the serve path does."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_inputs(gen, bh, bhkv, lq, lk, d, dtype):
    import torch
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return mk(bh, lq, d), mk(bhkv, lk, d), mk(bhkv, lk, d)


def k1_cases():
    """(label, bh, bhkv, lq, lk, d, kwargs): the shape sweep and GQA groups
    of tests/test_torch_kernels.py, plus a ragged case whose edges the
    kernel must mask from bounds."""
    cases = []
    for (b, lq, lk, hq, hkv, d) in ((1, 16, 16, 1, 1, 16), (2, 64, 64, 4, 2, 32),
                                    (1, 128, 256, 8, 8, 64),
                                    (2, 48, 80, 6, 3, 128)):
        for causal, window in ((False, None), (True, None), (True, 20)):
            lk_ = lq if causal else lk
            cases.append((f"sweep{(b, lq, lk_, hq, hkv, d)} causal={causal} "
                          f"window={window}", b * hq, b * hkv, lq, lk_, d,
                          dict(group=hq // hkv, causal=causal,
                               window=window)))
    for g in (1, 2, 4):
        cases.append((f"gqa group={g}", 2 * 2 * g, 2 * 2, 32, 32, 32,
                      dict(group=g, causal=True)))
    cases.append(("ragged lq=37 lk=91 window=9", 6, 3, 37, 91, 64,
                  dict(group=2, causal=True, window=9)))
    return cases


def check_k1(results: dict) -> None:
    import torch
    from repro_torch.kernels import flash_mqkv as fm

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for label, bh, bhkv, lq, lk, d, kw in k1_cases():
            q, k, v = k1_inputs(gen, bh, bhkv, lq, lk, d, dtype)
            qp = torch.arange(lq, dtype=torch.int32, device="cuda")
            kp = torch.arange(lk, dtype=torch.int32, device="cuda")
            got = fm.flash_mqkv(q, k, v, qp, kp, **kw)
            ref = fm.flash_mqkv_plain(q, k, v, qp, kp, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(got[0], ref[0]), rel_err(got[1], ref[1]),
                    rel_err(got[2], ref[2])]
            worst[name] = max(worst.get(name, 0.0), max(errs))
            if max(errs) > tol:
                fail(f"K1 {name} {label}: o/l/m err {errs} > {tol}")
        # padding: k_pos = -1 slots hold garbage that must not leak
        q, k, v = k1_inputs(gen, 4, 4, 16, 48, 32, dtype)
        qp = torch.arange(16, dtype=torch.int32, device="cuda")
        kp = torch.where(torch.arange(48, device="cuda") < 40,
                         torch.arange(48, device="cuda"), -1).to(torch.int32)
        k[:, 40:] = 999.0
        v[:, 40:] = 999.0
        pad = fm.flash_mqkv(q, k, v, qp, kp)[0]
        cut = fm.flash_mqkv(q, k[:, :40].contiguous(), v[:, :40].contiguous(),
                            qp, kp[:40].contiguous())[0]
        e = rel_err(pad, cut)
        if e > tol:
            fail(f"K1 {name} padding leak {e}")
        # carried state over two segments == one call; unfinalized triple
        q, k, v = k1_inputs(gen, 4, 2, 32, 64, 64, dtype)
        qp = torch.arange(32, dtype=torch.int32, device="cuda") + 32
        kp = torch.arange(64, dtype=torch.int32, device="cuda")
        kw = dict(group=2, causal=True)
        st = fm.flash_mqkv(q, k[:, :32].contiguous(), v[:, :32].contiguous(),
                           qp, kp[:32].contiguous(), finalize=False, **kw)
        st_ref = fm.flash_mqkv_plain(q, k[:, :32], v[:, :32], qp, kp[:32],
                                     finalize=False, **kw)
        two = fm.flash_mqkv(q, k[:, 32:].contiguous(), v[:, 32:].contiguous(),
                            qp, kp[32:].contiguous(), state=st, **kw)[0]
        one = fm.flash_mqkv_plain(q, k, v, qp, kp, **kw)[0]
        errs = [rel_err(a, b) for a, b in zip(st, st_ref)] + [rel_err(two, one)]
        if max(errs) > tol:
            fail(f"K1 {name} state carry / unfinalized errs {errs}")
        # rows with no visible key: o = 0, l = 0, m = -inf
        q, k, v = k1_inputs(gen, 2, 2, 16, 16, 16, dtype)
        future = torch.arange(16, dtype=torch.int32, device="cuda") + 100
        o, l, m = fm.flash_mqkv(q, k, v, future - 100, future, causal=True,
                                finalize=False)
        if not (bool((o == 0).all()) and bool((l == 0).all())
                and bool(torch.isneginf(m).all())):
            fail(f"K1 {name} fully masked rows are not (0, 0, -inf)")
        log(f"k1 {name}: {len(k1_cases())} sweep cases + padding + state "
            f"carry + masked rows OK, worst rel err {worst[name]:.3e} "
            f"(tol {tol})")
    # the flux-12b shapes of the main path, bfloat16: the finalized output
    # the server uses and the unfinalized (o', l, m) state
    for bh, l in FLUX_SHAPES:
        q, k, v = k1_inputs(gen, bh, bh, l, l, 128, torch.bfloat16)
        pos = torch.arange(l, dtype=torch.int32, device="cuda")
        got = fm.flash_mqkv(q, k, v, pos, pos)[0]
        ref = fm.flash_mqkv_plain(q, k, v, pos, pos)[0]
        errs = {"o": (rel_err(got, ref, floor=0.0), norm_err(got, ref))}
        results.setdefault("flux_err", {})[(bh, l)] = float(
            (got.float() - ref.float()).abs().max())
        del got, ref
        got = fm.flash_mqkv(q, k, v, pos, pos, finalize=False)
        ref = fm.flash_mqkv_plain(q, k, v, pos, pos, finalize=False)
        for name, a, b in zip(("o'", "l", "m"), got, ref):
            errs[name] = (rel_err(a, b, floor=0.0), norm_err(a, b))
        log(f"k1 flux BH={bh} L={l} D=128 bf16: max abs err of o "
            f"{results['flux_err'][(bh, l)]:.3e}; max|d|/max|ref|, "
            f"|d|/|ref| per output: "
            + ", ".join(f"{n} {e[0]:.2e} {e[1]:.2e}" for n, e in errs.items()))
        for name, (e_max, e_norm) in errs.items():
            lim_max, lim_norm = FLUX_TOL[name]
            if not (e_max <= lim_max and e_norm <= lim_norm):
                fail(f"K1 flux shape BH={bh} L={l} {name}: max err "
                     f"{e_max} (limit {lim_max}), norm err {e_norm} "
                     f"(limit {lim_norm})")
        del q, k, v, got, ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: K2 against K1 and its plain version
# ---------------------------------------------------------------------------

# (label, BH, Lq, Lk): the ring steps of the serve-sp path (B 2 x 3 heads
# per Ulysses rank; L 4352 and 1280 over 16 ranks give shards of 272 and
# 80, gathered Q of 2176 and 640, passed to K1 and K2 unpadded) and the
# Ulysses-gathered shape of the monolithic strategies
K2_SHAPES = (("4096 stage0/pull-q", 6, 272, 272),
             ("4096 pull-kv", 6, 2176, 272),
             ("1024 stage0/pull-q", 6, 80, 80),
             ("1024 pull-kv", 6, 640, 80),
             ("ulysses-gathered", 6, 2176, 2176))
K2_MAIN = "4096 pull-kv"
# ring shapes at which K1 is timed too: the SP path launches K1 at each
SP_K1_SHAPES = K2_SHAPES[:4]


def k2_inputs(gen, bh, lq, lk, dtype):
    """q, k, v and positions of one ring step: the queries' shard, then a
    KV chunk of a later shard."""
    import torch
    q, k, v = k1_inputs(gen, bh, bh, lq, lk, 128, dtype)
    qp = torch.arange(lq, dtype=torch.int32, device="cuda")
    kp = torch.arange(lk, dtype=torch.int32, device="cuda") + 272
    return q, k, v, qp, kp


def run_k2(q, k, v, qp, kp, epoch, **kw):
    """K2 with fresh forward buffers and completion word; fails unless the
    chunk landed bitwise and the word reads ``epoch``."""
    import torch
    from repro_torch.kernels import ring_flash as rf
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    arrive = torch.zeros_like(flag)
    out, (kf, vf) = rf.ring_flash_step(q, k, v, qp, kp, flag=flag,
                                       arrive=arrive, epoch=epoch, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(kf, k) and torch.equal(vf, v)):
        fail("K2 forwarded chunk differs from its input")
    if int(flag) != epoch or int(arrive) != 0:
        fail(f"K2 completion word {int(flag)} (want {epoch}), arrive "
             f"{int(arrive)}")
    return out


def check_k2(results: dict) -> None:
    import torch
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels import ring_flash as rf

    gen = torch.Generator(device="cuda").manual_seed(4)
    epoch = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst = 0.0
        for label, bh, bhkv, lq, lk, d, kw in k1_cases():
            q, k, v = k1_inputs(gen, bh, bhkv, lq, lk, d, dtype)
            qp = torch.arange(lq, dtype=torch.int32, device="cuda")
            kp = torch.arange(lk, dtype=torch.int32, device="cuda")
            for finalize in (True, False):
                epoch += 1
                got = run_k2(q, k, v, qp, kp, epoch, finalize=finalize, **kw)
                k1 = fm.flash_mqkv(q, k, v, qp, kp, finalize=finalize, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, k1)):
                    fail(f"K2 {name} {label}: (o, l, m) differ from K1's")
                ref = rf.ring_flash_step_plain(
                    q, k, v, qp, kp, k_dst=torch.empty_like(k),
                    v_dst=torch.empty_like(v), finalize=finalize,
                    scale=d ** -0.5, **kw)
                worst = max(worst, *(rel_err(a, b) for a, b in zip(got, ref)))
        if worst > TOL[name]:
            fail(f"K2 {name} sweep: worst rel err {worst} > {TOL[name]}")
        log(f"k2 {name}: {2 * len(k1_cases())} sweep cases bitwise equal to "
            f"K1, forwarded chunk bitwise, completion word set; worst rel "
            f"err vs plain {worst:.3e} (tol {TOL[name]})")
    for label, bh, lq, lk in K2_SHAPES:
        q, k, v, qp, kp = k2_inputs(gen, bh, lq, lk, torch.bfloat16)
        errs = {}
        for finalize in (True, False):
            epoch += 1
            got = run_k2(q, k, v, qp, kp, epoch, finalize=finalize)
            k1 = fm.flash_mqkv(q, k, v, qp, kp, finalize=finalize)
            if not all(torch.equal(a, b) for a, b in zip(got, k1)):
                fail(f"K2 {label}: (o, l, m) differ from K1's")
            ref = fm.flash_mqkv_plain(q, k, v, qp, kp, finalize=finalize,
                                      scale=128 ** -0.5)
            names = ("o", "l", "m") if finalize else ("o'", "l", "m")
            for n, a, b in list(zip(names, got, ref))[:1 if finalize else 3]:
                errs[n] = (rel_err(a, b, floor=0.0), norm_err(a, b))
            if not finalize and label == K2_MAIN:
                results["k2_err"] = float((got[0] - ref[0]).abs().max())
        log(f"k2 {label} BH={bh} Lq={lq} Lk={lk} bf16: "
            "bitwise equal to K1; max|d|/max|ref|, |d|/|ref| vs plain: "
            + ", ".join(f"{n} {e[0]:.2e} {e[1]:.2e}" for n, e in errs.items()))
        for n, (e_max, e_norm) in errs.items():
            lim_max, lim_norm = FLUX_TOL[n]
            if not (e_max <= lim_max and e_norm <= lim_norm):
                fail(f"K2 {label} {n}: max err {e_max} (limit {lim_max}), "
                     f"norm err {e_norm} (limit {lim_norm})")
        del q, k, v
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: K3 and K4
# ---------------------------------------------------------------------------

UNEVEN_SHAPES = ((3, 5), (7, 3, 2), (1, 13))  # tests/test_comm_backends.py
SERVE_PUT_SHAPE = (2, 272, 3, 128)  # one rank's Q/K/V/O chunk, 4096 bucket
SMALL_PUT_SHAPE = (1, 80, 3, 128)  # the same chunk of the 1024 bucket
# The cases a tiled body can get wrong, each K3 and K4 over a random
# permutation: (dtype, ranks, shapes of one rank's tensors, (src, dst)
# element offsets into flat buffers, puts back to back on one side stream
# and one set of signal and arrive words, with no synchronisation between)
PUT_EDGES = {
    # views at 2- and 4-byte alignment, equal mod 16 bytes (bulk body
    # behind a head) or not (word path)
    **{f"{dt} offsets ({so}, {do})": (dt, RANKS, (SERVE_PUT_SHAPE,),
                                      (so, do), 1)
       for dt, so, do in (("bfloat16", 1, 0), ("bfloat16", 0, 1),
                          ("bfloat16", 1, 1), ("bfloat16", 2, 0),
                          ("bfloat16", 2, 2), ("bfloat16", 1, 3),
                          ("float32", 1, 0), ("float32", 1, 1),
                          ("float32", 0, 3))},
    "mixed sizes": ("bfloat16", RANKS, ((13,), SERVE_PUT_SHAPE), (0, 0), 1),
    "sizes no multiple of 16 B": (
        "bfloat16", RANKS, ((5, 4099), (7, 3, 2), (1,), SMALL_PUT_SHAPE),
        (0, 0), 1),
    "96 entries": ("bfloat16", 48, (SMALL_PUT_SHAPE,) * 2, (0, 0), 1),
    "three puts back to back": ("bfloat16", RANKS, (SERVE_PUT_SHAPE,) * 2,
                                (0, 0), 3),
}


def run_put(name, src, dst, perm, signal, arrive, epoch) -> list:
    """K3 over ``perm`` or K4; returns each source rank's destination."""
    from repro_torch.comm import kernel_backend as kb
    if name == "remote_put":
        kb.remote_put(src, dst, perm, signal=signal, arrive=arrive,
                      epoch=epoch)
        return list(perm)
    kb.landing_copy(src, dst, signal=signal, arrive=arrive, epoch=epoch)
    return list(range(len(src)))


def judge_put(label, src, dst, to, err: float) -> float:
    """Fails unless every dst[to[r]][i] equals src[r][i] bit for bit;
    returns err raised to the largest |dst - src| seen."""
    import torch
    for r, row in enumerate(src):
        for i, sent in enumerate(row):
            got = dst[to[r]][i]
            err = max(err, float((got.float() - sent.float()).abs().max()))
            if not torch.equal(got, sent):
                fail(f"{label}: rank {r} tensor {i} not bitwise")
    return err


def judge_words(label, signal, arrive, epoch) -> None:
    if not (bool((signal == epoch).all()) and bool((arrive == 0).all())):
        fail(f"{label}: signal words {signal.tolist()} (want {epoch}), "
             f"arrive words {arrive.tolist()} (want 0)")


def put_words(n):
    import torch
    signal = torch.zeros(n, dtype=torch.int32, device="cuda")
    return signal, torch.zeros_like(signal)


def flat_views(flat, off, shapes):
    """Views of ``shapes`` at element ``off`` of each rank's flat buffers."""
    return [[f[off:off + math.prod(s)].view(s) for f, s in zip(row, shapes)]
            for row in flat]


def check_put_edges(gen, err: dict) -> int:
    """Every PUT_EDGES case through K3 and K4: bitwise, no byte outside a
    destination view written, every signal word at the last put's epoch
    and every arrive word at 0.  Returns the number of puts."""
    import random
    import torch

    n_puts = 0
    for label, (dt, ranks, shapes, (so, do), puts) in PUT_EDGES.items():
        dtype = getattr(torch, dt)
        numels = [math.prod(s) for s in shapes]
        perm = list(range(ranks))
        random.Random(ranks).shuffle(perm)
        for name in ("remote_put", "landing_copy"):
            sets = []
            for _ in range(puts):
                src = flat_views([[torch.randn(n + 8, generator=gen,
                                               device="cuda").to(dtype)
                                   for n in numels] for _ in range(ranks)],
                                 so, shapes)
                flat = [[torch.full((n + 8,), float("nan"), device="cuda")
                         .to(dtype) for n in numels] for _ in range(ranks)]
                sets.append((src, flat, flat_views(flat, do, shapes)))
            signal, arrive = put_words(ranks * len(shapes))
            side = torch.cuda.Stream()
            torch.cuda.synchronize()
            with torch.cuda.stream(side):
                tos = [run_put(name, src, dst, perm, signal, arrive, 20 + n)
                       for n, (src, _, dst) in enumerate(sets)]
            torch.cuda.synchronize()
            for (src, flat, dst), to in zip(sets, tos):
                err[name] = judge_put(f"{name} {label}", src, dst, to,
                                      err[name])
                for row in flat:
                    for f, n in zip(row, numels):
                        if not (bool(f[:do].isnan().all())
                                and bool(f[do + n:].isnan().all())):
                            fail(f"{name} {label}: wrote outside the view")
            judge_words(f"{name} {label}", signal, arrive, 19 + puts)
            n_puts += puts
    return n_puts


def check_put_kernels(results: dict) -> None:
    """Bitwise delivery; records the largest |dst - src| each kernel left
    (the kernels line's max_abs_err)."""
    import torch
    from repro_torch.core.collectives import GroupLayout

    layout = GroupLayout(("pod", "model"), P_U, P_R, ulysses_outer=True)
    perms = {"shift": [(r + 1) % RANKS for r in range(RANKS)],
             "ulysses stage 3": [d for _, d in layout.ulysses_stage_perm(3)]}
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_cases = 0
    err = results.setdefault("put_err", {"remote_put": 0.0,
                                         "landing_copy": 0.0})
    for dtype in (torch.float32, torch.bfloat16):
        for shape in UNEVEN_SHAPES + (SERVE_PUT_SHAPE,):
            for perm_name, perm in perms.items():
                for tensors in (1, 2):
                    src = [[torch.randn(shape, generator=gen, device="cuda")
                            .to(dtype) for _ in range(tensors)]
                           for _ in range(RANKS)]
                    for name in ("remote_put", "landing_copy"):
                        dst = [[torch.full(shape, float("nan"), device="cuda")
                                .to(dtype) for _ in range(tensors)]
                               for _ in range(RANKS)]
                        signal, arrive = put_words(RANKS * tensors)
                        epoch = 1000 + n_cases
                        label = f"{name} {dtype} {shape} {perm_name}"
                        to = run_put(name, src, dst, perm, signal, arrive,
                                     epoch)
                        torch.cuda.synchronize()
                        err[name] = judge_put(label, src, dst, to, err[name])
                        judge_words(label, signal, arrive, epoch)
                        n_cases += 1
    log(f"k3/k4: {n_cases} puts (f32/bf16, shapes {list(UNEVEN_SHAPES)} and "
        f"{SERVE_PUT_SHAPE}, 16-rank shift and Ulysses stage perms, 1 and 2 "
        "tensors) delivered bitwise, every signal word at its epoch")
    n_edges = check_put_edges(gen, err)
    log(f"k3/k4: {n_edges} more puts delivered bitwise, nothing written "
        "outside a destination view, every signal word at its epoch and "
        f"every arrive word at 0: {', '.join(PUT_EDGES)}; max |dst - src| "
        f"{err}")


# ---------------------------------------------------------------------------
# phases 6 to 9: the model
# ---------------------------------------------------------------------------

def perturb_zero_init(params, gen, scale: float = 1.0) -> None:
    """Replace the adaLN-zero and output-projection zeros with fan-in
    normals, so attention reaches the output (a fresh DiT is the
    identity), and sharpen attention by ATTN_SHARPEN: with fan-in q and k
    weights the logits are ~N(0, 1), the softmax over thousands of keys is
    nearly uniform, and a lost KV chunk barely moves the mean of V."""
    import torch

    def fill(p):
        w = p["w"]
        p["w"] = (torch.randn(w.shape, generator=gen, device=w.device,
                              dtype=w.dtype) * (scale * w.shape[0] ** -0.5))

    for lp in params["layers"]:
        fill(lp["ada"])
        for name in ("wq", "wk"):
            lp["attn"][name]["w"] = lp["attn"][name]["w"] * ATTN_SHARPEN
    if "ada_f" in params:
        fill(params["ada_f"])
        fill(params["proj_out"])


def cast_(tree, dtype) -> None:
    """Convert every tensor of a tree of dicts and lists to ``dtype`` in
    place (each leaf is freed as its copy is made)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            cast_(v, dtype)
        else:
            tree[k] = v.to(dtype)


def _cast(tree, **kw):
    """``Tensor.to(**kw)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _cast(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, **kw) for v in tree]
    return tree.to(**kw)


def reset_counts() -> None:
    from repro_torch.comm import kernel_backend as kb
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels import ring_flash as rf
    fm.reset_launch_count()
    rf.reset_launch_count()
    kb.reset_launch_count()


def read_counts() -> dict:
    from repro_torch.comm import kernel_backend as kb
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels import ring_flash as rf
    return {"flash_mqkv": fm.launch_count(), "ring_flash_step": rf.launch_count(),
            "remote_put": kb.launch_count("remote_put"),
            "landing_copy": kb.launch_count("landing_copy")}


def expected_counts(put: str, layers_x_forwards: int) -> dict:
    """Launches the swift_torus schedule implies (see K1_PER_LAYER)."""
    other = "landing_copy" if put == "remote_put" else "remote_put"
    return {"flash_mqkv": K1_PER_LAYER * layers_x_forwards,
            "ring_flash_step": K2_PER_LAYER * layers_x_forwards,
            put: PUTS_PER_LAYER * layers_x_forwards, other: 0}


def sp_config(sp_axes):
    from repro_torch.core import SPConfig
    return SPConfig(strategy="swift_torus", sp_axes=sp_axes,
                    machine_axis="pod", comm_backend="pallas",
                    kernel_interpret=False)


def check_block(arch: str = "flux-12b") -> dict:
    """One full-width fp32 block of ``arch`` at L 1280 on the card through
    K1 against the same block on the CPU through the plain path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.models.blocks import ParallelContext, _rope_angles
    from repro_torch.models.dit import dit_block, init_dit

    cfg = dataclasses.replace(get_config(arch), n_layers=1, dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = init_dit(cfg, gen, device="cpu")
    perturb_zero_init(params, gen)
    lp = params["layers"][0]
    l = 1280
    x = torch.randn((1, l, cfg.d_model), generator=gen)
    t_emb = torch.randn((1, cfg.d_model), generator=gen)
    pos = torch.arange(l)[None]
    sp = SPConfig(strategy="full")
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = dit_block(lp, cfg, ParallelContext(sp, device=torch.device("cpu")),
                        x, t_emb, pos)
    t_cpu = time.perf_counter() - t0
    dev = torch.device("cuda")
    lp_d = _cast(lp, device=dev)
    before = fm.launch_count()
    with torch.inference_mode():
        out = dit_block(lp_d, cfg, ParallelContext(sp, device=dev),
                        x.to(dev), t_emb.to(dev), pos.to(dev))
    torch.cuda.synchronize()
    launches = fm.launch_count() - before
    e = float((out.cpu() - ref).abs().max()) / float(ref.abs().max())
    attn_share = float((ref - x).abs().max())
    # the rope table is float64 rounded to f32 on either side, so that the
    # device's f32 transcendentals do not enter the comparison
    tables = [_rope_angles(pos.to(d), cfg.resolved_head_dim, cfg.rope_theta)
              for d in (torch.device("cpu"), dev)]
    rope_d = max(float((a - b.cpu()).abs().max()) for a, b in zip(*tables))
    log(f"block {arch} d={cfg.d_model} heads {cfg.n_heads} x "
        f"{cfg.resolved_head_dim} L={l} fp32: card vs CPU max|d|/max|ref| = "
        f"{e:.3e} (tol {BLOCK_TOL}), K1 launches {launches}, max|block-x| "
        f"{attn_share:.3f}, rope table card vs CPU max|d| {rope_d:.3e}, "
        f"CPU block {t_cpu:.2f} s")
    if launches != 1 or not e <= BLOCK_TOL:
        fail(f"block {arch}: err {e} launches {launches}")
    return dict(cfg=cfg, lp=lp_d, x=x, t_emb=t_emb, pos=pos, ref=ref)


def check_sp_block(blk: dict) -> None:
    """The block of phase 6 under swift_torus on 16 virtual ranks."""
    import torch
    from repro_torch.launch import make_mesh
    from repro_torch.models.blocks import ParallelContext
    from repro_torch.models.dit import dit_block

    dev = torch.device("cuda")
    cfg, ref = blk["cfg"], blk["ref"]
    for mesh_name, (shape, axes, sp_axes, put) in SP_MESHES.items():
        ctx = ParallelContext(sp_config(sp_axes),
                              mesh=make_mesh(shape, axes, device=dev))
        args = (blk["x"].to(dev), blk["t_emb"].to(dev), blk["pos"].to(dev))
        reset_counts()
        with torch.inference_mode():
            out = dit_block(blk["lp"], cfg, ctx, *args)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expected_counts(put, 1)
        e = float((out.cpu() - ref).abs().max()) / float(ref.abs().max())
        log(f"sp-block {mesh_name} ({ctx.sp_degree} virtual ranks, "
            f"P_u {P_U} x P_r {P_R}) fp32: card vs CPU degree 1 max|d|/max|ref| "
            f"= {e:.3e} (tol {BLOCK_TOL}); launches {counts} (expected {want})")
        if not e <= BLOCK_TOL:
            fail(f"sp-block {mesh_name}: err {e}")
        if counts != want:
            fail(f"sp-block {mesh_name}: launches {counts} != {want}")


REQUESTS = ((0, 4096), (1, 4096), (2, 1024))  # (rid, latent tokens)


def run_server(params, cfg, conds, requests, sp, mesh=None, sampler=None,
               capture=None, max_batch=4, park=None):
    """Serve ``requests`` with fresh counts (by default STEPS unguided
    steps, each bucket's step captured as a CUDA graph unless ``capture``
    is False); returns the results by rid, the wall time, the launch
    counts, the steps run (admissions x steps) and the server.  ``park``
    (an admission's step index) parks the first admission once, after
    that step."""
    import torch
    from repro_torch.serving import (DiTRequest, DiTServer, RecordingTracker,
                                     SamplerConfig)

    # a server is a reference cycle (its steps close over it) and holds
    # its graphs' pool and a pipelined bucket's KV-state buffers: collect
    # the last one before making the next
    gc.collect()
    torch.cuda.empty_cache()
    sampler = sampler or SamplerConfig(num_steps=STEPS)
    srv = DiTServer(params, cfg, sp, sampler=sampler,
                    max_batch=max_batch, tracker=RecordingTracker(), mesh=mesh,
                    device=None if mesh is not None else "cuda",
                    capture=capture)
    if park is not None:
        parked = []

        def once(adm, step, num_steps, step_times):
            if parked or step != park:
                return False
            parked.append(step)
            return True

        srv._should_park = once
    for rid, seq in requests:
        srv.submit(DiTRequest(rid=rid, seq_len=seq, cond=conds[rid]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = srv.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if sorted(r.rid for r in out) != sorted(rid for rid, _ in requests):
        fail(f"served rids {[r.rid for r in out]}")
    # one forward per step per admitted batch (unguided, or cfg-parallel);
    # a parked batch's steps ran too
    forwards = srv.scheduler.admissions * sampler.num_steps
    if park is not None:
        forwards += park + 1 - sampler.num_steps
    return {r.rid: r for r in out}, wall, counts, forwards, srv


def check_latents(label: str, out: dict, srv, card: str,
                  requests=REQUESTS) -> None:
    """Finite, of the right shape, and moved from their noise."""
    import torch
    from repro_torch.serving import DiTRequest
    for rid, r in sorted(out.items()):
        seq = dict(requests)[rid]
        noise = srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1, seq)[0]
        moved = float((r.latents.float() - noise.float()).abs().max())
        finite = bool(torch.isfinite(r.latents).all())
        log(f"{label} rid={rid} seq={seq}: shape {tuple(r.latents.shape)} "
            f"finite={finite} max|x-noise|={moved:.3f} latency "
            f"{r.latency:.2f} s step times "
            f"{[round(t, 4) for t in r.step_times]} [{card}]")
        if tuple(r.latents.shape) != (seq, 64) or not finite or moved == 0.0:
            fail(f"{label} rid {rid}: bad result")


def latent_err(a, b, noise) -> float:
    """||a - b|| / ||b - noise||: the error beside what the model moved."""
    a, b, noise = a.float(), b.float(), noise.float()
    return float((a - b).norm()) / max(float((b - noise).norm()), 1e-30)


def rss_gib() -> float:
    """The process's resident host memory, GiB (Linux /proc)."""
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


class DeviceMemory:
    """The most device memory in use on card 0, by every process on it
    (``torch.cuda.mem_get_info``), sampled every ``period`` s on a thread
    while the block runs: what processes run side by side take
    together."""

    def __init__(self, period: float = 0.1):
        self.period, self.peak = period, 0
        self._done = None

    def _sample(self) -> None:
        import torch
        while not self._done.wait(self.period):
            free, total = torch.cuda.mem_get_info(0)
            self.peak = max(self.peak, total - free)

    def __enter__(self) -> "DeviceMemory":
        import threading
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join()


def log_graphs(label: str, srv, card: str) -> list:
    """One line per step of ``srv``: its capture and instantiation host
    seconds, replays and launches per replay.  Returns the steps."""
    steps = srv.captured_steps()
    for st in steps:
        if st.graph is None:
            log(f"{label} graph {st.name}: not captured ({st.calls} calls)")
            continue
        log(f"{label} graph {st.name}: capture {st.capture_s:.3f} s, "
            f"instantiation {st.instantiate_s:.3f} s (host), {st.replays} "
            f"replays, launches per replay {st.launches} [{card}]")
    return steps


def check_signal_words(label: str, steps, checks: list) -> None:
    """Zero the heap's signal words, replay each captured step, and hold
    every word its puts write to the epoch the capture gave it."""
    import torch
    from repro_torch.comm import kernel_backend as kb
    heap = kb.heap_for(torch.device("cuda"))
    words = bad = 0
    for st in steps:
        if st.graph is None or not st.signal_words:
            continue
        heap.signals.zero_()
        st.graph.replay()
        torch.cuda.synchronize()
        got = heap.signals.cpu()
        for (row, w), epoch in st.signal_words.items():
            words += 1
            bad += int(got[row, w]) != epoch
    log(f"{label}: signal words after a replay onto zeroed words: "
        f"{words - bad} of {words} hold their epoch")
    checks.append((words > 0 and bad == 0,
                   f"{label}: {bad} of {words} signal words stale"))


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def serve(results: dict, card: str, params, cfg, conds) -> dict:
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.serving import DiTRequest

    out, wall, counts, forwards, srv = run_server(
        params, cfg, conds, REQUESTS, SPConfig(strategy="full"))
    expect = cfg.n_layers * forwards
    log(f"serve: {len(out)} requests in {wall:.2f} s, K1 launches "
        f"{counts['flash_mqkv']} (expected {cfg.n_layers} layers x {STEPS} "
        f"steps x {srv.scheduler.admissions} forwards = {expect}), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if counts != {"flash_mqkv": expect, "ring_flash_step": 0,
                  "remote_put": 0, "landing_copy": 0}:
        fail(f"serve launches {counts}, expected {expect} K1 only")
    check_latents("serve", out, srv, card)
    log_graphs("serve", srv, card)
    for rid, r in out.items():
        results.setdefault("step_times", {})[dict(REQUESTS)[rid]] = r.step_times
    results["launches_degree1"] = counts["flash_mqkv"]
    results["counts_degree1"] = counts
    noise = {rid: srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1, seq)[0]
             for rid, seq in REQUESTS}
    return {"latents": {rid: r.latents for rid, r in out.items()},
            "noise": noise}


def degree1_latents(params, cfg, conds, requests=REQUESTS) -> dict:
    """The captured degree-1 server's latents on ``requests``, with their
    noise and step wall clocks: the oracle of a cut-depth SP run."""
    from repro_torch.core import SPConfig
    from repro_torch.serving import DiTRequest

    out, _, _, _, srv = run_server(params, cfg, conds, requests,
                                   SPConfig(strategy="full"))
    return {"latents": {rid: r.latents for rid, r in out.items()},
            "noise": {rid: srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1,
                                      seq)[0] for rid, seq in requests},
            "step_times": {dict(requests)[rid]: r.step_times
                           for rid, r in out.items()}}


def serve_sp(results: dict, card: str, params, cfg, conds) -> None:
    """Phase 9 at SERVE_SP_LAYERS of flux-12b's 96 layers (``params`` and
    ``cfg`` cut to that depth), against a degree-1 server of the same
    depth."""
    import torch
    from repro_torch.core import torus
    from repro_torch.core.softmax import empty_partial
    from repro_torch.launch import make_mesh

    deg1 = degree1_latents(params, cfg, conds)

    def mesh_of(name):
        shape, axes, sp_axes, put = SP_MESHES[name]
        return make_mesh(shape, axes, device="cuda"), sp_config(sp_axes), put

    def errors(out):
        return {rid: latent_err(r.latents, deg1["latents"][rid],
                                deg1["noise"][rid])
                for rid, r in out.items()}

    # the main path: three requests on mesh (pod 2, model 8)
    mesh, sp, put = mesh_of("pod2xmodel8")
    rss0 = rss_gib()
    out, wall, counts, forwards, srv = run_server(params, cfg, conds,
                                                  REQUESTS, sp, mesh)
    rss1 = rss_gib()
    want = expected_counts(put, cfg.n_layers * forwards)
    log_graphs("serve-sp pod2xmodel8", srv, card)
    log(f"serve-sp pod2xmodel8: host memory {rss0:.2f} -> {rss1:.2f} GiB "
        f"with the two {cfg.n_layers}-layer graphs held")
    errs = errors(out)
    log(f"serve-sp pod2xmodel8: {len(out)} requests in {wall:.2f} s on "
        f"{srv.ctx.sp_degree} virtual ranks, launches {counts} (expected "
        f"{want} for {cfg.n_layers} layers x {forwards} forwards), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check_latents("serve-sp", out, srv, card)
    for rid, r in sorted(out.items()):
        seq = dict(REQUESTS)[rid]
        log(f"serve-sp rid={rid}: latents vs degree 1 ||d||/||x1-noise|| = "
            f"{errs[rid]:.3e} (tol {SERVE_SP_TOL}); step wall clock "
            f"{[round(t, 4) for t in r.step_times]} s vs degree 1 "
            f"{[round(t, 4) for t in deg1['step_times'][seq]]} s at "
            f"{cfg.n_layers} layers [{card}]")
        results.setdefault("sp_step_times", {})[seq] = r.step_times
    # every measurement of the phase is printed before any limit is checked
    checks = [(counts == want, f"serve-sp launches {counts} != {want}"),
              (max(errs.values()) <= SERVE_SP_TOL,
               f"serve-sp latents differ from degree 1: {errs}")]
    results["launches"] = counts
    results["serve_sp_err"] = errs

    # the single-axis route: the 1024-latent request on mesh (model 16), at
    # SERVE_SP_ROUTE_LAYERS
    mesh, sp, put = mesh_of("model16")
    small = (REQUESTS[2],)
    n = SERVE_SP_ROUTE_LAYERS
    route = dict(params, layers=params["layers"][:n])
    cfg_route = dataclasses.replace(cfg, n_layers=n)
    deg1_route = degree1_latents(route, cfg_route, conds, small)
    out, wall, counts, forwards, srv = run_server(route, cfg_route, conds,
                                                  small, sp, mesh)
    want = expected_counts(put, n * forwards)
    errs = {2: latent_err(out[2].latents, deg1_route["latents"][2],
                          deg1_route["noise"][2])}
    log(f"serve-sp model16: rid 2 at {n} layers in {wall:.2f} s, launches "
        f"{counts} (expected {want}); latents vs degree 1 at {n} layers "
        f"{errs[2]:.3e} (tol {SERVE_SP_TOL})")
    check_latents("serve-sp model16", out, srv, card)
    checks.append((counts == want and errs[2] <= SERVE_SP_TOL,
                   f"serve-sp model16: launches {counts}, err {errs[2]}"))
    results["launches_model16"] = counts

    # negative control: drop the first Pull-KV chunk of every attention
    real = torus.ring_attention
    calls = [0]

    def dropping(q, *args, **kw):
        parts = real(q, *args, **kw)
        calls[0] += 1
        if calls[0] % CIRCULATIONS == P_U + 1:  # stage 0, P_u - 1 Pull-Q
            return [empty_partial(*x.shape, device=x.device) for x in q]
        return parts

    mesh, sp, _ = mesh_of("pod2xmodel8")
    torus.ring_attention = dropping
    try:
        out, *_ = run_server(params, cfg, conds, small, sp, mesh)
    finally:
        torus.ring_attention = real
    err = errors(out)[2]
    log(f"serve-sp negative control: one KV chunk of every attention "
        f"dropped -> latents vs degree 1 {err:.3e} (must exceed "
        f"{SERVE_SP_TOL})")
    checks.append((err > SERVE_SP_TOL,
                   f"a dropped KV chunk passes the serve-sp check ({err})"))
    results["drop_err"] = err
    for ok, msg in checks:
        if not ok:
            fail(msg)


def capture_dit(results: dict, card: str, params, cfg, conds,
                deg1: dict) -> None:
    """Phase 22 (flux-12b part): each captured server held bitwise to the
    same server with capture=False, on the same requests in the same run.
    Degree 1 at full depth (the serve phase's captured latents against an
    eager server); swift_torus on mesh (pod 2, model 8) and (model 16) at
    CAPTURE_LAYERS of the 96 layers, with launches per replay equal to the
    eager step's (so the runs' totals agree) and every signal word the
    steps' puts write holding its epoch after a replay onto zeroed words;
    a captured batch parked after its second step and restarted, against
    the unparked captured run.  Prints each step's wall clock, captured
    (replays) against eager."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh

    checks = []

    def bitwise(a, b):
        return sorted(a) == sorted(b) and all(
            torch.equal(a[rid].latents, b[rid].latents) for rid in a)

    def steps_line(label, cap, eag):
        """``cap`` / ``eag``: step wall clocks by rid."""
        for rid in sorted(cap):
            c, e = cap[rid], eag[rid]
            log(f"capture {label} rid={rid}: step wall clock captured "
                f"{[round(t, 4) for t in c]} s (warm-up, capture + replay, "
                f"replays), eager {[round(t, 4) for t in e]} s; median "
                f"replay {median(c[2:]):.4f} s vs eager {median(e[1:]):.4f} "
                f"s [{card}]")

    # degree 1, full depth: the serve phase ran captured
    eager, wall, counts, _, _ = run_server(params, cfg, conds, REQUESTS,
                                           SPConfig(strategy="full"),
                                           capture=False)
    same = all(torch.equal(eager[rid].latents, deg1["latents"][rid])
               for rid in eager)
    log(f"capture degree 1 ({cfg.n_layers} layers): captured latents "
        f"bitwise the eager server's {same}; launches captured "
        f"{results['counts_degree1']} eager {counts} [{card}]")
    steps_line("degree 1", {0: results["step_times"][4096],
                            2: results["step_times"][1024]},
               {rid: eager[rid].step_times for rid in (0, 2)})
    checks += [(same, "capture degree 1: captured != eager"),
               (counts == results["counts_degree1"],
                f"capture degree 1: launches {counts} != "
                f"{results['counts_degree1']}")]
    results["capture_deg1"] = {seq: eager[rid].step_times
                               for rid, seq in ((0, 4096), (2, 1024))}

    sub = dict(params, layers=params["layers"][:CAPTURE_LAYERS])
    cfg_s = dataclasses.replace(cfg, n_layers=CAPTURE_LAYERS)
    for name, requests in (("pod2xmodel8", REQUESTS),
                           ("model16", (REQUESTS[2],))):
        shape, axes, sp_axes, put = SP_MESHES[name]
        mesh = make_mesh(shape, axes, device="cuda")
        sp = sp_config(sp_axes)
        cap, cwall, ccounts, forwards, csrv = run_server(
            sub, cfg_s, conds, requests, sp, mesh)
        eag, ewall, ecounts, _, _ = run_server(sub, cfg_s, conds, requests,
                                               sp, mesh, capture=False)
        want = expected_counts(put, CAPTURE_LAYERS * forwards)
        same = bitwise(cap, eag)
        log(f"capture swift_torus {name} ({CAPTURE_LAYERS} layers): captured "
            f"bitwise the eager server's {same}; {cwall:.2f} s captured vs "
            f"{ewall:.2f} s eager; launches captured {ccounts} eager "
            f"{ecounts} (expected {want}) [{card}]")
        steps = log_graphs(f"capture {name}", csrv, card)
        steps_line(f"swift_torus {name}",
                   {rid: r.step_times for rid, r in cap.items()},
                   {rid: r.step_times for rid, r in eag.items()})
        checks += [(same, f"capture {name}: captured != eager"),
                   (ccounts == ecounts == want,
                    f"capture {name}: launches {ccounts} / {ecounts} != "
                    f"{want}")]
        check_signal_words(f"capture {name}", steps, checks)
        results.setdefault("capture_sp", {})[name] = {
            rid: (cap[rid].step_times, eag[rid].step_times) for rid in cap}
        if name != "pod2xmodel8":
            continue
        del csrv
        parked, _, pcounts, pforwards, psrv = run_server(
            sub, cfg_s, conds, requests, sp, mesh, park=1)
        same = bitwise(parked, cap)
        log(f"capture park: the first admission parked after step 1 and "
            f"restarted ({psrv.preemptions} park): latents bitwise the "
            f"unparked captured run's {same}; launches {pcounts} (expected "
            f"{expected_counts(put, CAPTURE_LAYERS * pforwards)}); "
            f"{psrv.plan_cache.traces} builds, {psrv.captures} "
            f"captures [{card}]")
        checks += [(same and psrv.preemptions == 1,
                    "capture park: restarted latents differ"),
                   (pcounts == expected_counts(put, CAPTURE_LAYERS * pforwards),
                    f"capture park: launches {pcounts}")]
    for ok, msg in checks:
        if not ok:
            fail(msg)


# ---------------------------------------------------------------------------
# phases 15 to 18: the paper's workloads and the hybrid DiT path
# ---------------------------------------------------------------------------

# the paper's DiT workloads (configs/shapes.py) and their models
PAPER_WORKLOADS = (("flux_3072", "flux-12b"), ("cogvideox_20s", "cogvideox-5b"))
PAPER_ROWS = 512  # query rows on which the plain version checks K1 there
COGVIDEO_STEPS = 2  # sampler steps of serve-cogvideox
# serve-hybrid: mesh (cfg, pipe, data, model), one request, guidance 4, the
# displaced pipeline over two stages; STEPS steps
HYBRID_MESH = (2, 2, 1, 4)
HYBRID_LATENTS = 12_288
HYBRID_LAYERS = 8  # serve-hybrid's depth of cogvideox-5b's 42 layers
HYBRID_PIPE = dict(pp=2, num_patches=4)
GUIDANCE = 4.0
# displaced latents vs the all-warm run: the reference's bound, 0.05 of
# max|ref| (tests/test_pipefusion.py, tests/multidevice/test_hybrid.py)
DISPLACED_SHARE = 0.05
# one displaced forward on the state of a warm pass at the same (x, t)
# against that warm forward, ||v_d - v_w|| / ||v_w||, bfloat16: serve-sp's
# limit; the negative control (the stale segment dropped) must break it
DISPLACED_FWD_TOL = SERVE_SP_TOL
# cogvideox-5b's output projection scaled down from fan-in.  A random model
# at fan-in scale predicts |v| ~ 1, so each of 4 Euler steps moves the
# latents by ~25 %: far from the inter-step similarity the displaced
# pipeline relies on (a trained model's late steps, or a sampler of a few
# dozen steps).  Smaller still, the bf16 rounding of the latents grows
# beside what the model moved them, which gate (a) measures.  0.2 keeps
# both: on the reduced model on the CPU, (a) 1.5e-2 of 0.03 and (b) 0.4 of
# its bound, where 1.0 gave 3.5x the (b) bound
VELOCITY_SCALE = 0.2


# serve-procs (phase 43): one process per rank on the one card
PROCS = 4
PROCS_MESHES = {"pod": ((2, 2), ("pod", "model")), "model": ((4,), ("model",))}
# (mesh, strategy, the kernels it runs): for flux's 24 heads on 4 ranks the
# planner gives swift_torus P_u 4 x P_r 1, no ring step, so K2 across
# processes runs under the ring strategy (P_r 4) on the same mesh and shape
PROCS_CASES = (("pod", "swift_torus", "K1, K4"), ("pod", "ring", "K1, K2"),
               ("model", "swift_torus", "K1, K3"))
PROCS_SHAPE = (2, 4352, 24, 24, 128)  # B, L, Hq, Hkv, D: the 4096 bucket
# of flux-12b's 96 (8 before serve-procs-hybrid; its gates are bitwise)
SERVE_PROCS_LAYERS = 2
SERVE_PROCS_STEPS = 2
SERVE_PROCS_BUDGET_S = 60
# the limit on latent_err of a served run over processes against its
# virtual-mesh twin (serve-procs, serve-procs-hybrid; serve-procs-lm holds
# logits to it), inside SERVE_SP_TOL: the two compute the same operations
# (bitwise in every run so far), and 0.03 cannot see a cfg exchange put to
# the wrong branch (2.26e-2 at serve-procs-hybrid's depth: guidance is
# lost, the branches' velocities barely differ under seeded weights)
PROCS_HYBRID_TOL = 1e-3
# serve-procs' misrouted served run: one request, the 1024 bucket
SERVE_PROCS_WRONG = [(2, 1024)]
PROCS_DEADLINE_S = 300  # the launcher's watchdog: a hung worker fails here
PROCS_CLI = ["--arch", "flux-12b", "--procs", "4", "--mesh", "host",
             "--model", "4", "--eager", "--layers", "1", "--seq", "1024",
             "--requests", "1", "--steps", "1"]


def procs_sp(mesh, strategy: str = "swift_torus") -> dict:
    return dict(strategy=strategy, sp_axes=mesh[1], batch_axes=None,
                comm_backend="pallas", kernel_interpret=False)


def procs_share(virtual: dict) -> dict:
    """One process's launches of a twin's schedule, one rank a process:
    a quarter of K1, K2 and K5 (each rank's own), every K3 and K4 (one a
    put: the twin's one launch covers every rank)."""
    return {name: n // PROCS if name in ("flash_mqkv", "ring_flash_step",
                                         "rwkv6_wkv") else n
            for name, n in virtual.items()}


def serve_procs(results: dict, card: str) -> None:
    """Phase 43, serve-procs: the process mesh (launch/procs.py), four
    worker processes on the one card, each owning one rank, every put
    written into a peer process's buffers mapped over CUDA IPC.

    (a) ``sp_attention`` at the 4096-bucket flux shape (B 2, L 4352, 24 x
    128, bf16), PROCS_CASES: swift_torus on (pod 2, model 2) through K1
    and K4, ring on it through K1 and K2, swift_torus on (model 4) through
    K1 and K3: each process's output shard bitwise the same rows of the
    mesh of virtual ranks in this process; its launches the virtual
    mesh's per-rank share (K1, K2: a quarter; K3, K4: one launch per put,
    as the virtual mesh's one launch covers every rank).  A negative
    control, every Ulysses hop put along the wrong route (to the sender
    itself), must break the bitwise check.  (b) DiTServer under
    swift_torus on (pod 2, model 2), process 0 leading: REQUESTS for
    SERVE_PROCS_STEPS steps at SERVE_PROCS_LAYERS of the 96 layers (full
    width), each request's latents within PROCS_HYBRID_TOL (latent_err)
    of the virtual-mesh eager server's, the launches per process a
    quarter of its K1 and all of its K4; its negative control, the
    SERVE_PROCS_WRONG request served with every Ulysses hop put to the
    sender itself (serve_job's ``wrong_route``), must exceed that limit.
    (c) ``python -m
    repro_torch.launch.serve --procs 4`` on (model 4), run beside the
    worker launch (the most device memory the processes use together is
    printed).  A worker's failure
    or a timeout fails the phase; the wall times are four time-sliced
    contexts on one card: no speed figure, and no prediction of NVLink."""
    import torch
    from repro_torch.core import SPConfig, sp_attention
    from repro_torch.launch import make_mesh, procs
    from repro_torch.serving import DiTRequest, SamplerConfig

    t_phase = time.perf_counter()
    cases = [dict(mesh=PROCS_MESHES[m], sp=procs_sp(PROCS_MESHES[m], st),
                  shape=PROCS_SHAPE, seed=41, dtype="bfloat16")
             for m, st, _ in PROCS_CASES]
    cases.append(dict(cases[0], wrong_route=True))
    pod = PROCS_MESHES["pod"]
    spec = dict(arch="flux-12b", cfg={"n_layers": SERVE_PROCS_LAYERS},
                seed=43, mesh=pod, steps=SERVE_PROCS_STEPS,
                requests=list(REQUESTS), sp=procs_sp(pod))
    # (c) runs beside the workers: each is mostly its processes' start
    t0 = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *PROCS_CLI],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        with DeviceMemory() as mem:
            res = procs.launch(procs.chain_job, PROCS, [
                (procs.sp_attention_job, (cases,)),
                (procs.serve_job, (spec,)),
                (procs.serve_job, (dict(spec, requests=SERVE_PROCS_WRONG,
                                        wrong_route=True),))],
                device="cuda", deadline=PROCS_DEADLINE_S)
            cli_out, cli_err = cli.communicate(timeout=PROCS_DEADLINE_S)
    except Exception as err:  # a worker failed, died or timed out
        cli.kill()
        cli.communicate()
        fail(f"serve-procs: {err}")
    launch_s = time.perf_counter() - t0
    log(f"serve-procs: one launch of {PROCS} worker processes (spawn, CUDA "
        f"IPC of the slabs, sp_attention x {len(cases)}, served run) beside "
        f"the (c) launcher's 4: {launch_s:.1f} s, device memory in use at "
        f"most {mem.peak / 2**30:.2f} GiB [{card}]")

    dev = torch.device("cuda")
    checks = []
    results["procs_launches"] = {}
    for n, (name, strategy, kernels) in enumerate(PROCS_CASES):
        mesh = PROCS_MESHES[name]
        q, k, v = procs._sp_inputs(cases[n], dev)
        reset_counts()
        want = sp_attention(q, k, v, cfg=SPConfig(**cases[n]["sp"]),
                            mesh=make_mesh(*mesh, device=dev))
        torch.cuda.synchronize()
        virtual = read_counts()
        want = want.cpu()
        share = procs_share(virtual)
        for r, worker in enumerate(res):
            got = worker[0][n]
            lo, hi = got["rows"]
            same = torch.equal(got["shards"][0], want[:, lo:hi])
            log(f"serve-procs sp_attention {strategy} ({name}, through "
                f"{kernels}) process {r} rows [{lo}, {hi}): bitwise {same}, "
                f"launches "
                f"{got['counts']} (the virtual mesh's per-rank share "
                f"{share}), {got['seconds'] * 1e3:.1f} ms with its warm-up, "
                f"{got['heap_bytes'] / 2**20:.1f} MiB of its slab [{card}]")
            checks.append(same and got["counts"] == share)
        if n == 0:
            wrong = []
            for w in res:
                bad = w[0][len(PROCS_CASES)]
                wrong.append(torch.equal(
                    bad["shards"][0], want[:, bad["rows"][0]:bad["rows"][1]]))
            log(f"serve-procs negative control (every Ulysses hop to the "
                f"sender itself): bitwise per process {wrong} (must break)")
            checks.append(not all(wrong))
        for kernel in ("ring_flash_step", "remote_put"):
            results["procs_launches"][kernel] = results["procs_launches"].get(
                kernel, 0) + sum(w[0][n]["counts"][kernel] for w in res)
    del q, k, v

    cfg, params = procs._dit_params(spec, dev)
    conds = {}
    for rid, _ in REQUESTS:
        gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 2 + rid)
        conds[rid] = torch.randn((256, cfg.d_model), generator=gen,
                                 device=dev).to(torch.bfloat16)
    out, wall, virtual, _, srv = run_server(
        params, cfg, conds, REQUESTS, SPConfig(**spec["sp"]),
        mesh=make_mesh(*pod, device=dev),
        sampler=SamplerConfig(num_steps=SERVE_PROCS_STEPS), capture=False)
    got = res[0][1]["latents"]
    for rid, seq in REQUESTS:
        noise = srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1, seq)[0]
        x = got[rid].to(dev)
        err = latent_err(x, out[rid].latents, noise)
        finite = bool(torch.isfinite(x).all())
        log(f"serve-procs served rid={rid} seq={seq}: shape "
            f"{tuple(x.shape)} finite={finite} latent_err {err:.4e} against "
            f"the virtual-mesh server (limit {PROCS_HYBRID_TOL})"
            + (" - bitwise equal" if err == 0.0 else "") + f" [{card}]")
        checks.append(finite and tuple(x.shape) == (seq, 64)
                      and err <= PROCS_HYBRID_TOL)
    for rid, seq in SERVE_PROCS_WRONG:
        noise = srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1, seq)[0]
        bad = latent_err(res[0][2]["latents"][rid].to(dev), out[rid].latents,
                         noise)
        log(f"serve-procs served run negative control rid={rid}, every "
            f"Ulysses hop put to the sender itself: latent_err {bad:.4e} "
            f"against the virtual-mesh server (must exceed "
            f"{PROCS_HYBRID_TOL}) [{card}]")
        checks.append(bad > PROCS_HYBRID_TOL)
    share = procs_share(virtual)
    for r, worker in enumerate(res):
        c = worker[1]["counts"]
        log(f"serve-procs served run process {r}: launches {c} (share "
            f"{share}), {worker[1]['seconds']:.2f} s of serving; the "
            f"virtual-mesh eager server {wall:.2f} s in this process "
            f"[{card}]")
        checks.append(c == share)
    for name in ("flash_mqkv", "landing_copy"):
        results["procs_launches"][name] = sum(w[1]["counts"][name]
                                              for w in res)
    del params, srv, out
    gc.collect()
    torch.cuda.empty_cache()

    lines = cli_out.splitlines()
    for line in lines:
        log(f"serve-procs cli: {line}")
    cli_ok = (cli.returncode == 0
              and any(x.startswith("process mesh: 4 processes")
                      for x in lines)
              and any(x.startswith("request 0: latents (1024, 64)")
                      for x in lines))
    log(f"serve-procs cli {' '.join(PROCS_CLI)}: rc {cli.returncode} "
        f"[{card}]")
    if not cli_ok:
        fail(f"serve-procs cli: rc {cli.returncode}: {cli_err[-1500:]}")
    phase_s = time.perf_counter() - t_phase
    log(f"serve-procs: {phase_s:.1f} s (budget {SERVE_PROCS_BUDGET_S} s) "
        f"[{card}]")
    if not all(checks):
        fail("serve-procs: a process-mesh check failed (see above)")


# serve-procs-hybrid (phase 44): the hybrid mesh over processes
PROCS_HYBRID = 8  # processes: 2 of HYBRID_MESH's 16 ranks each
PROCS_HYBRID_LAYERS = 4  # of cogvideox-5b's 42
PROCS_HYBRID_STEPS = 3  # 1 warm, 2 displaced
PROCS_HYBRID_BUDGET_S = 50
# the negative control's hand-off: (cfg 1, pipe 2, data 4, model 1) over 8
# processes, where the flat-rank rule (the (data, pipe) list's index read
# as the flat rank) is a wrong permutation of the processes: every put lands,
# at the wrong process
PROCS_HANDOFF_MESH = ((1, 2, 4, 1), ("cfg", "pipe", "data", "model"))
PROCS_HYBRID_CLI = ["--arch", "flux-12b", "--mesh", "multipod", "--procs",
                    "4", "--eager", "--layers", "1"]


def procs_hybrid_counts(lay, warm: int, displaced: int, layers: int,
                        patches: int, pp: int, blocks: int) -> tuple:
    """The launches of the hybrid served run: (the virtual mesh's, one
    process's).  The virtual mesh runs each warm layer's swift_torus on
    every (branch, SP rank), ``ranks`` of them, one K3 a put for all, and
    each displaced forward once for both branches (two K1 a (patch,
    layer), one K3 a hand-off).  A process owns ``per`` ranks of one
    (branch, pipe) pair: a quarter of the warm K1 (the pipe replica
    doubles the virtual mesh's work), one K3 a put per owned source (the
    torus puts; the KV gather's and the output gather's blocks - 1 puts,
    one a layer and one a step; the cfg exchange, one a step), and the
    whole displaced forward of its branch (both pipe stages: the replica
    runs every stage), one K3 a hand-off and one for the cfg exchange."""
    ranks = 2 * lay.size
    circ = 1 + 2 * (lay.p_ulysses - 1)
    per = lay.size // blocks
    torus_puts = 3 * (lay.p_ulysses - 1)
    virtual = {"flash_mqkv": warm * layers * ranks * circ
               + displaced * 2 * patches * layers,
               "ring_flash_step": 0,
               "remote_put": warm * layers * torus_puts
               + displaced * patches * (pp - 1),
               "landing_copy": 0}
    process = {"flash_mqkv": warm * layers * per * circ
               + displaced * 2 * patches * layers,
               "ring_flash_step": 0,
               "remote_put": warm * (layers * (torus_puts + blocks - 1) * per
                                     + (blocks - 1) * per + 1)
               + displaced * (patches * (pp - 1) + 1),
               "landing_copy": 0}
    return virtual, process


def serve_procs_hybrid(results: dict, card: str) -> None:
    """Phase 44, serve-procs-hybrid: the hybrid mesh over a process mesh,
    PROCS_HYBRID worker processes on the one card, each owning two of
    HYBRID_MESH's ranks (cfg 2, pipe 2, data 1, model 4), so that every
    axis crosses a process boundary and SP also stays inside a process.

    (a) DiTServer led by process 0 on cogvideox-5b at full width, bf16, at
    PROCS_HYBRID_LAYERS of its 42 layers: one request of HYBRID_LATENTS,
    guidance GUIDANCE on the cfg axis (each process one branch, the
    branches' velocities exchanged by K3 over the cfg axis), HYBRID_PIPE's
    displaced pipeline (hand-offs by K3 to the next pipe rank's
    process), PROCS_HYBRID_STEPS steps (1 warm, whose layer KV is
    gathered over the SP axes by K3, then displaced): its latents within
    PROCS_HYBRID_TOL (latent_err; inside SERVE_SP_TOL) of the
    virtual-mesh twin's at the same depth.  (b) Each process's K1, K3 and K4 launches against the counts
    the schedule gives one process beside the virtual mesh's, and its
    slab's high-water mark.  Negative controls: the served run again with
    every cfg exchange put to the sender's own branch (serve_job's
    ``wrong_route``) fails (a)'s limit; a hand-off on PROCS_HANDOFF_MESH
    routed by the flat-rank owner rule reaches the wrong processes (the
    owner map's reaches the right ones).  (c) ``python -m
    repro_torch.launch.serve`` PROCS_HYBRID_CLI, run beside the worker
    launch, exits 0; the most device memory the processes use together is
    printed.  The phase fails past PROCS_HYBRID_BUDGET_S.  The wall times
    are time-sliced contexts on one card: no speed figure."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.core.strategy import resolve_layout
    from repro_torch.launch import make_mesh, procs
    from repro_torch.serving import DiTRequest

    t_phase = time.perf_counter()
    mesh = (HYBRID_MESH, ("cfg", "pipe", "data", "model"))
    sp = dict(strategy="swift_torus", sp_axes=("model",),
              batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
              comm_backend="pallas", kernel_interpret=False)
    sampler = dict(num_steps=PROCS_HYBRID_STEPS, guidance_scale=GUIDANCE,
                   cfg_parallel=True, pipeline=dict(warmup_steps=1,
                                                    **HYBRID_PIPE))
    spec = dict(arch="cogvideox-5b", cfg={"n_layers": PROCS_HYBRID_LAYERS},
                seed=47, mesh=mesh, sp=sp, sampler=sampler,
                requests=[(0, HYBRID_LATENTS)])
    hand = [dict(mesh=PROCS_HANDOFF_MESH, batch_axes=("data",)),
            dict(mesh=PROCS_HANDOFF_MESH, batch_axes=("data",),
                 old_owner=True)]
    # (c) runs beside the workers: each is mostly its processes' start
    t0 = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *PROCS_HYBRID_CLI],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        with DeviceMemory() as mem:
            res = procs.launch(procs.chain_job, PROCS_HYBRID, [
                (procs.handoff_job, (hand,)), (procs.serve_job, (spec,)),
                (procs.serve_job, (dict(spec, wrong_route=True),))],
                device="cuda", deadline=PROCS_DEADLINE_S)
            cli_out, cli_err = cli.communicate(timeout=PROCS_DEADLINE_S)
    except Exception as err:  # a worker failed, died or timed out
        cli.kill()
        cli.communicate()
        fail(f"serve-procs-hybrid: {err}")
    both_s = time.perf_counter() - t0
    log(f"serve-procs-hybrid: one launch of {PROCS_HYBRID} worker processes "
        f"(hand-offs, served run, misrouted served run) beside the (c) "
        f"launcher's 4: {both_s:.1f} s, device memory in use at most "
        f"{mem.peak / 2**30:.2f} GiB [{card}]")
    checks = []

    # the negative control first: who each process heard from
    pipe = PROCS_HANDOFF_MESH[1].index("pipe")
    for n, label in enumerate(("owner map", "flat-rank rule")):
        right = []
        for w in res:
            want = list(w[0][n]["coords"])
            want[pipe] = (want[pipe] - 1) % PROCS_HANDOFF_MESH[0][pipe]
            sender = next(r for r, x in enumerate(res)
                          if x[0][n]["coords"] == tuple(want))
            right.append(float(w[0][n]["got"][0, 0]) == sender)
        log(f"serve-procs-hybrid hand-off on {PROCS_HANDOFF_MESH[0]} by the "
            f"{label}: each process received its peer's slice {right}"
            + (" (must break)" if n else ""))
        checks.append(all(right) if n == 0 else not all(right))

    dev = torch.device("cuda")
    cfg, params = procs._dit_params(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 2)
    cond = torch.randn((256, cfg.d_model), generator=gen,
                       device=dev).to(torch.bfloat16)
    out, wall, virtual, _, srv = run_server(
        params, cfg, {0: cond}, spec["requests"], SPConfig(**sp),
        mesh=make_mesh(*mesh, device=dev), sampler=procs._sampler(spec),
        capture=False)
    (choice,) = srv.plan_cache.plans.values()
    patches = srv._bucket_sampler(choice).pipeline.patches
    noise = srv._noise([DiTRequest(rid=0, seq_len=HYBRID_LATENTS)], 1,
                       HYBRID_LATENTS)[0]
    got = res[0][1]["latents"][0].to(dev)
    err = latent_err(got, out[0].latents, noise)
    finite = bool(torch.isfinite(got).all())
    log(f"serve-procs-hybrid (a) cogvideox-5b {PROCS_HYBRID_LAYERS} layers "
        f"bf16, {HYBRID_LATENTS} latents, {patches} patches: shape "
        f"{tuple(got.shape)} finite={finite} latent_err {err:.4e} against "
        f"the virtual-mesh twin (limit {PROCS_HYBRID_TOL})"
        + (" - bitwise equal" if err == 0.0 else "") + f" [{card}]")
    checks.append(finite and tuple(got.shape) == (HYBRID_LATENTS, 64)
                  and err <= PROCS_HYBRID_TOL)
    bad = latent_err(res[0][2]["latents"][0].to(dev), out[0].latents, noise)
    log(f"serve-procs-hybrid (a) negative control, every cfg exchange put "
        f"to the sender's own branch: latent_err {bad:.4e} against the "
        f"twin (must exceed {PROCS_HYBRID_TOL}; SERVE_SP_TOL "
        f"{SERVE_SP_TOL} would " + ("" if bad > SERVE_SP_TOL else "not ")
        + "see it)")
    checks.append(bad > PROCS_HYBRID_TOL)

    vmesh = make_mesh(*mesh, device=dev)
    lay = resolve_layout(SPConfig(**sp), vmesh, cfg.n_heads, cfg.n_kv_heads)
    per_process = math.prod(HYBRID_MESH) // PROCS_HYBRID
    want_v, want_p = procs_hybrid_counts(
        lay, 1, PROCS_HYBRID_STEPS - 1, PROCS_HYBRID_LAYERS, patches,
        HYBRID_PIPE["pp"], lay.size // per_process)
    log(f"serve-procs-hybrid (b) the virtual-mesh twin: launches {virtual} "
        f"(the schedule's {want_v}), {wall:.2f} s in this process, "
        f"swift_torus P_u {lay.p_ulysses} x P_r {lay.p_ring} [{card}]")
    checks.append(virtual == want_v)
    for r, w in enumerate(res):
        c = w[1]["counts"]
        log(f"serve-procs-hybrid (b) process {r}: launches {c} (one "
            f"process's share by the schedule {want_p}), "
            f"{w[1]['seconds']:.2f} s of serving, slab high-water mark "
            f"{w[1]['heap_bytes'] / 2**20:.1f} MiB of "
            f"{procs.SLAB_BYTES['cuda'] / 2**20:.0f} MiB [{card}]")
        checks.append(c == want_p)
    for name in ("flash_mqkv", "remote_put"):
        results["procs_launches"][name] += sum(w[1]["counts"][name]
                                               for w in res)
    del params, srv, out
    gc.collect()
    torch.cuda.empty_cache()

    lines = cli_out.splitlines()
    for line in lines:
        log(f"serve-procs-hybrid cli: {line}")
    log(f"serve-procs-hybrid (c) cli {' '.join(PROCS_HYBRID_CLI)}: rc "
        f"{cli.returncode} [{card}]")
    if cli.returncode != 0 or not any(
            x.startswith("process mesh: 4 processes, 8 of 32 ranks each")
            for x in lines):
        fail(f"serve-procs-hybrid cli: rc {cli.returncode}: "
             f"{cli_err[-1500:]}")
    phase_s = time.perf_counter() - t_phase
    log(f"serve-procs-hybrid: {phase_s:.1f} s (budget "
        f"{PROCS_HYBRID_BUDGET_S} s) [{card}]")
    checks.append(phase_s <= PROCS_HYBRID_BUDGET_S)
    if not all(checks):
        fail("serve-procs-hybrid: a process-mesh check failed (see above)")


# serve-procs-lm (phase 45): the LMs over processes, one rank a process
PROCS_LM_LAYERS = 4  # of qwen2-1.5b's 28, hymba-1.5b's 32, rwkv6-1.6b's 24
PROCS_LM_BL = (2, 4096)  # prefill (B, L)
PROCS_LM_SEED = 49
PROCS_LM_MESHES = {"pod": ((2, 2), ("pod", "model")),
                   "model": ((4,), ("model",))}
# (label, arch, mesh, strategy, wrong_route, dtype): the twin is the
# unmisrouted case of the same arch, mesh and dtype (None: the config's)
PROCS_LM_CASES = (
    ("qwen2 swift_torus", "qwen2-1.5b", "pod", "swift_torus", None, None),
    ("qwen2 ring", "qwen2-1.5b", "model", "ring", None, None),
    ("hymba fp32 swift_torus", "hymba-1.5b", "pod", "swift_torus", None,
     "float32"),
    ("hymba bf16 swift_torus", "hymba-1.5b", "pod", "swift_torus", None,
     None),
    ("rwkv6", "rwkv6-1.6b", "model", "swift_torus", None, None),
    ("qwen2 every Ulysses hop to the sender", "qwen2-1.5b", "pod",
     "swift_torus", "ulysses", None),
    ("rwkv6 every token shift to the sender", "rwkv6-1.6b", "model",
     "swift_torus", "shift", None),
    ("rwkv6 every WKV state pass to the sender", "rwkv6-1.6b", "model",
     "swift_torus", "state", None),
    ("hymba fp32 every SSD state pass to the sender", "hymba-1.5b", "pod",
     "swift_torus", "state", "float32"),
    ("hymba bf16 every SSD state pass to the sender", "hymba-1.5b", "pod",
     "swift_torus", "state", None),
)
# hymba's item is gated in float32: its SSD's in_dt product (1600 -> 25)
# takes another cuBLAS path at a shard's 2,048 rows than at the twin's
# 8,192 (bf16: 1.6e-3 apart in that product alone, 1.43e-2 in the logits
# at 4 layers, the SSD's exp of cumulative decays amplifying it; float32:
# 1.6e-5), a product's rounding, not the process mesh's puts.  Its bf16
# run and bf16 control are logged, their launches gated, their error not
PROCS_LM_LOGGED = ("hymba bf16 swift_torus",
                   "hymba bf16 every SSD state pass to the sender")
PROCS_LM_AR = dict(slots=4, max_len=1024, requests=[
    (0, [1, 2, 3], 8), (1, [4, 5, 6, 7], 8), (2, [8, 9, 10, 11, 12], 8)])
PROCS_WHISPER = (4, 448, 1536)  # B, decoder tokens, frames (encoder_seq)
PROCS_WHISPER_TOL = 1e-5  # fp32 logits, of max|logits|
# (f) qwen2-moe-a2.7b over processes, each process holding its EP ranks'
# experts (bf16, PROCS_LM_LAYERS layers): (label, mesh, strategy,
# wrong_route); the twin is the unmisrouted case of the same mesh
PROCS_MOE_CASES = (
    ("qwen2-moe ring EP 4", "model", "ring", None),
    ("qwen2-moe swift_torus EP 2", "pod", "swift_torus", None),
    ("qwen2-moe every EP exchange hop to the sender", "model", "ring", "ep"),
)
# (f) arctic-480b's token-gather decode at its published widths (d_model
# 7168, moe_d_ff 4864) with PROCS_ARCTIC_EXPERTS of its 128 experts: the
# expert count acts as depth here (a layer's 128 are 53.5 GB in fp32, 8 are
# 3.3 GB, which this process builds once and each worker cuts its half
# from over CUDA IPC)
PROCS_ARCTIC_EXPERTS = 8
PROCS_ARCTIC_MESH = ((2, 2), ("data", "model"))
PROCS_ARCTIC_TOL = 1e-5  # fp32 y, of max|y|
PROCS_LM_BUDGET_S = 90
# (g) the launcher at full depth: 24 layers whose routed experts are 26.6
# GB, four processes holding a quarter each, every layer cut as it is
# built (init_lm(..., mesh=))
PROCS_LM_CLI = ["--arch", "qwen2-moe-a2.7b", "--procs", "4", "--mesh",
                "host", "--model", "4", "--eager"]


def procs_lm_spec(arch: str, mesh: str, strategy: str,
                  dtype: str | None = None, **kw) -> dict:
    """A serve-procs-lm case for launch/procs.py's LM jobs."""
    layers = {"n_layers": PROCS_LM_LAYERS} if arch != "whisper-tiny" else {}
    if dtype is not None:
        layers["dtype"] = dtype
    m = PROCS_LM_MESHES[mesh]
    return dict(arch=arch, cfg=dict(layers, **kw.pop("cfg", {})),
                seed=PROCS_LM_SEED, mesh=m, sp=procs_sp(m, strategy),
                shape=PROCS_LM_BL, **kw)


def procs_lm_twin(spec: dict, dev) -> dict:
    """The case on the mesh of virtual ranks in this process (its
    ``twin``): the whole batch's logits and the launches; a MoE model's
    aux and routed-expert bytes beside them."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh, procs
    from repro_torch.models import ParallelContext, get_model, lm_forward
    from repro_torch.models.moe import expert_bytes

    cfg, params = procs._lm_params(spec, dev)
    inputs = procs.lm_inputs(spec, cfg, dev)
    ctx = ParallelContext(SPConfig(**spec["sp"]), "prefill",
                          mesh=make_mesh(*spec["mesh"], device=dev))
    torch.cuda.synchronize()
    reset_counts()
    wkv_module().reset_launch_count()
    twin = {}
    with torch.inference_mode():
        if cfg.family == "moe":
            logits, twin["aux"], _ = lm_forward(params, cfg, ctx,
                                                tokens=inputs["tokens"])
            twin["expert_bytes"] = expert_bytes(params)
        else:
            logits = get_model(cfg).apply(params, inputs, cfg, ctx)
    torch.cuda.synchronize()
    return dict(twin, logits=logits, counts=dict(
        read_counts(), rwkv6_wkv=wkv_module().launch_count()))


def procs_arctic(dev):
    """(f)'s arctic-480b token-gather decode (published widths,
    PROCS_ARCTIC_EXPERTS experts, fp32) on PROCS_ARCTIC_MESH: the
    moe_block_job case (one MoE layer's seeded experts, whole, and a
    decode step's 4 tokens) and its twin's y on the mesh of virtual
    ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext
    from repro_torch.models.blocks import ParamBuilder
    from repro_torch.models.moe import init_moe, moe_block

    over = dict(dtype="float32", sharding_overrides=())
    moe = dict(n_experts=PROCS_ARCTIC_EXPERTS)
    cfg = dataclasses.replace(get_config("arctic-480b"), **over)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    gen = torch.Generator(device=dev).manual_seed(PROCS_LM_SEED)
    b = ParamBuilder(gen, torch.float32, dev)
    init_moe(b, cfg)
    layer = b.params["moe"]
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device=dev)
    sp = dict(strategy="full", sp_axes=("model",), batch_axes=("data",),
              comm_backend="pallas", kernel_interpret=False)
    ctx = ParallelContext(SPConfig(**sp), "decode", ep_token_gather=True,
                          mesh=make_mesh(*PROCS_ARCTIC_MESH, device=dev))
    with torch.inference_mode():
        y, _ = moe_block(x, layer, cfg, ctx)
    return dict(arch="arctic-480b", cfg=over, moe=moe, layer=layer, x=x,
                mesh=PROCS_ARCTIC_MESH, sp=sp, mode="decode",
                ep_token_gather=True), y


def serve_procs_lm(results: dict, card: str) -> None:
    """Phase 45, serve-procs-lm: the language models over a process mesh,
    PROCS worker processes on the one card, one rank each, at full
    published width and seeded, perturbed weights (launch/procs.py
    ``perturb_lm``).  Each process runs its batch slice and its sequence
    shard; the token shifts, the state passes, the decode merge's gather
    and the MoE exchange are puts into the peers' slabs.  Each item is
    held against its twin on the mesh of virtual ranks in this process
    (made first: the workers read it over CUDA IPC and hold their rows
    against it), each process's launches against its share of the twin's
    (procs_share).

    (a) qwen2-1.5b at PROCS_LM_LAYERS of 28 layers, bf16, prefill
    PROCS_LM_BL: swift_torus on (pod 2, model 2) (K1, K2, K4) and ring on
    (model 4) (K1, K2, K3); each process's logits rows within
    PROCS_HYBRID_TOL of the twin's, relative to max|logits| (bitwise
    logged).  (b) hymba-1.5b, 4 of 32 layers (global and windowed
    attention, the SSD state passes), swift_torus on (pod 2, model 2): in
    fp32 the same gate; in bf16 (K1 and K2's bf16 bodies) the launches
    gated and the error logged (PROCS_LM_LOGGED).  (c) rwkv6-1.6b, 4 of
    24 layers, on (model 4): K5 once a layer on each process's shard (L
    1024), the token shifts and the WKV state passes as puts ("xla"
    lowering: copies into the peer's slab); the same gate.  Negative
    controls, put to the sender itself: (a) with every Ulysses hop, (c)
    with every token shift and with every WKV state pass, fp32 (b) with
    every SSD state pass, (f) with every stage hop of the EP exchange:
    each must exceed the gate (bf16 (b)'s control logged).  (d) ARServer
    on (a)'s qwen2 on (pod 2, model 2) and on (f)'s qwen2-moe on (model
    4), eager: PROCS_LM_AR's requests, each's tokens equal to the
    virtual-mesh server's; a process's K4 (qwen2) or K3 (qwen2-moe:
    the attention merge's and the experts' sums) launches three gather
    puts a layer and tick each.  (e) whisper-tiny (4 + 4 layers, d 384),
    fp32, B 4 x 1536 frames x 448 tokens on (model 4) (Lq 112, Lk 384 a
    rank): logits within PROCS_WHISPER_TOL of the twin's.  (f)
    qwen2-moe-a2.7b, PROCS_LM_LAYERS of 24 layers, bf16, each process
    holding its EP ranks' experts (``init_lm(..., mesh=)``): ring on (model
    4) (EP 4) and swift_torus on (pod 2, model 2) (EP 2), the gate of (a),
    the aux equal to the twin's, the expert bytes 1/EP of the twin's, the
    launches the twin's share plus the aux gather's PROCS - 1 puts a layer
    (K3 on one axis, K4 on two); arctic-480b's token-gather decode at its
    published widths with PROCS_ARCTIC_EXPERTS of its experts
    (PROCS_ARCTIC_MESH, fp32) within PROCS_ARCTIC_TOL.  (g) ``python -m
    repro_torch.launch.serve`` PROCS_LM_CLI (qwen2-moe at full width and
    depth), alone on the card once the workers are gone, exits 0 with its
    request lines; the most device memory in use while it runs is
    printed.
    Every process allocates the same heap offsets; the slabs' high-water
    marks are printed.  The phase fails past PROCS_LM_BUDGET_S.  The wall
    times are time-sliced contexts on one card: no speed figure."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh, procs
    from repro_torch.models import torch_dtype
    from repro_torch.models.moe import expert_bytes
    from repro_torch.serving import ARRequest, ARServer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cases = list(PROCS_LM_CASES) + [
        (label, "qwen2-moe-a2.7b", mesh, strategy, wrong, None)
        for label, mesh, strategy, wrong in PROCS_MOE_CASES]
    twins, specs = {}, []
    for label, arch, mesh, strategy, wrong, dtype in cases:
        key = (arch, mesh, dtype)
        spec = procs_lm_spec(arch, mesh, strategy, dtype)
        if key not in twins:
            twins[key] = procs_lm_twin(spec, dev)
        specs.append(dict(spec, twin=twins[key]["logits"], wrong_route=wrong))
    wspec = procs_lm_spec("whisper-tiny", "model", "swift_torus", "float32")
    wspec["shape"] = PROCS_WHISPER
    wtwin = procs_lm_twin(wspec, dev)
    wspec["twin"] = wtwin["logits"]
    arctic, arctic_y = procs_arctic(dev)
    ars = {"qwen2-1.5b": procs_lm_spec("qwen2-1.5b", "pod", "swift_torus",
                                       **PROCS_LM_AR),
           "qwen2-moe-a2.7b": procs_lm_spec("qwen2-moe-a2.7b", "model",
                                            "ring", **PROCS_LM_AR)}
    twin_s = time.perf_counter() - t_phase
    try:
        with DeviceMemory() as mem:
            res = procs.launch(procs.chain_job, PROCS, [
                (procs.lm_prefill_job, (specs + [wspec],)),
                (procs.moe_block_job, ([arctic],))] + [
                (procs.ar_serve_job, (ar,)) for ar in ars.values()],
                device="cuda", deadline=PROCS_DEADLINE_S)
    except Exception as err:  # a worker failed, died or timed out
        fail(f"serve-procs-lm: {err}")
    launch_s = time.perf_counter() - t_phase - twin_s
    log(f"serve-procs-lm: twins {twin_s:.1f} s, then one launch of {PROCS} "
        f"worker processes ({len(specs)} prefill cases, whisper, arctic's "
        f"token-gather decode, two served runs): {launch_s:.1f} s, device "
        f"memory in use at most {mem.peak / 2**30:.2f} GiB [{card}]")
    checks = []
    launches = results["procs_launches"]

    def hold(label, got, twin, tol, wrong, mesh):
        errs = [g["err"] for g in got]
        same = [g["bitwise"] for g in got]
        logged = label in PROCS_LM_LOGGED
        limit = "logged, not gated" if logged else f"limit {tol}"
        if wrong:
            log(f"serve-procs-lm negative control, {label}: err per process "
                f"{[f'{e:.3e}' for e in errs]} ("
                + (limit if logged else f"must exceed {tol}") + f") [{card}]")
            checks.append(logged or max(errs) > tol)
            return
        share = procs_share(twin["counts"])
        moe = "aux" in twin
        if moe:  # the aux gather: PROCS - 1 puts a layer, K3 on one axis
            put = "remote_put" if len(mesh[1]) == 1 else "landing_copy"
            share[put] += PROCS_LM_LAYERS * (PROCS - 1)
            ep = dict(zip(mesh[1], mesh[0]))["model"]
        for r, g in enumerate(got):
            extra = ""
            ok = True
            if moe:
                aux_ok = torch.equal(g["aux"], twin["aux"].cpu())
                held_ok = g["expert_bytes"] * ep == twin["expert_bytes"]
                extra = (f", aux {float(g['aux']):.9g} (twin "
                         f"{float(twin['aux']):.9g}, equal {aux_ok}), "
                         f"experts {g['expert_bytes'] / 2**30:.3f} GiB "
                         f"(the twin's / {ep}: {held_ok})")
                ok = aux_ok and held_ok
            log(f"serve-procs-lm {label} process {r} rows {g['rows']}: "
                f"bitwise {same[r]}, err {errs[r]:.3e} of max|logits| "
                f"({limit}), launches {g['counts']} (share of the twin's "
                f"{twin['counts']}: {share}){extra}, {g['seconds']:.2f} s "
                f"with its warm-up, slab high-water mark "
                f"{g['heap_bytes'] / 2**20:.1f} MiB [{card}]")
            checks.append((math.isfinite(errs[r]) if logged
                           else errs[r] <= tol) and g["counts"] == share
                          and ok)
        offsets = [g["offsets"] for g in got]
        checks.append(all(o == offsets[0] for o in offsets))
        for name in share:
            launches[name] = launches.get(name, 0) + sum(
                g["counts"][name] for g in got)

    for n, (label, arch, mesh, _, wrong, dtype) in enumerate(cases):
        hold(label, [w[0][n] for w in res], twins[(arch, mesh, dtype)],
             PROCS_HYBRID_TOL, wrong, PROCS_LM_MESHES[mesh])
    hold("whisper-tiny fp32 (model 4)", [w[0][len(specs)] for w in res],
         wtwin, PROCS_WHISPER_TOL, None, PROCS_LM_MESHES["model"])
    scale = float(arctic_y.abs().max())
    arctic_bytes = expert_bytes({"layers": [{"moe": arctic["layer"]}]})
    for r, w in enumerate(res):
        g = w[1][0]
        b0, b1 = g["batch"]
        err = float((g["y"] - arctic_y[b0:b1].cpu()).abs().max()) / scale
        log(f"serve-procs-lm (f) arctic-480b token-gather decode, d_model "
            f"7168, moe_d_ff 4864, {PROCS_ARCTIC_EXPERTS} of 128 experts "
            f"(cut: the expert count is its depth), fp32, "
            f"{PROCS_ARCTIC_MESH}: process {r} batch {g['batch']} bitwise "
            f"{torch.equal(g['y'], arctic_y[b0:b1].cpu())}, err {err:.3e} "
            f"of max|y| (limit {PROCS_ARCTIC_TOL}), puts {len(g['puts'])}, "
            f"experts {g['expert_bytes'] / 2**30:.3f} GiB (the whole "
            f"layer's {arctic_bytes / 2**30:.3f} GiB) [{card}]")
        checks.append(err <= PROCS_ARCTIC_TOL
                      and 2 * g["expert_bytes"] == arctic_bytes)
    checks.append(all(w[1][0]["offsets"] == res[0][1][0]["offsets"]
                      for w in res))
    twins.clear()
    del specs, wspec, wtwin, arctic, arctic_y
    gc.collect()
    torch.cuda.empty_cache()

    for n, (arch, ar) in enumerate(ars.items(), start=2):
        cfg, params = procs._lm_params(ar, dev)
        srv = ARServer(params, cfg, SPConfig(**ar["sp"]),
                       batch_slots=ar["slots"], max_len=ar["max_len"],
                       cache_dtype=torch_dtype(cfg.dtype), capture=False,
                       mesh=make_mesh(*ar["mesh"], device=dev))
        for rid, prompt, new in ar["requests"]:
            srv.submit(ARRequest(rid=rid, prompt=torch.tensor(prompt),
                                 max_new_tokens=new))
        want = srv.serve()
        ticks = int(srv.tracker.counter("ar.ticks"))
        got = res[0][n]["tokens"]
        log(f"serve-procs-lm (d) ARServer {arch} {PROCS_LM_LAYERS} layers "
            f"over processes: {got} ({ticks} ticks); the virtual mesh's "
            f"{want}: equal {got == want} [{card}]")
        checks.append(got == want)
        # three gather puts a layer and tick: the attention merge's (K4 on
        # (pod, model), K3 on (model)), and the MoE sum's (K3)
        moe = cfg.family == "moe"
        put = "remote_put" if moe else "landing_copy"
        want_puts = ticks * PROCS_LM_LAYERS * (PROCS - 1) * (2 if moe else 1)
        for r, w in enumerate(res):
            c = w[n]["counts"]
            log(f"serve-procs-lm (d) {arch} process {r}: launches {c} "
                f"({put} {want_puts}), {w[n]['seconds']:.2f} s of serving, "
                f"experts {w[n]['expert_bytes'] / 2**30:.3f} GiB, slab "
                f"high-water mark {w[n]['heap_bytes'] / 2**20:.1f} MiB "
                f"[{card}]")
            checks.append(c[put] == want_puts and c["flash_mqkv"] == 0)
            launches[put] += c[put]
        del params, srv
        gc.collect()
        torch.cuda.empty_cache()

    # (g) alone on the card: at full depth its four processes must fit
    free, total = torch.cuda.mem_get_info(0)
    t_cli = time.perf_counter()
    with DeviceMemory() as cli_mem:
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *PROCS_LM_CLI],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        try:
            cli_out, cli_err = cli.communicate(timeout=PROCS_DEADLINE_S)
        except subprocess.TimeoutExpired:
            cli.kill()
            cli.communicate()
            fail(f"serve-procs-lm cli: no exit in {PROCS_DEADLINE_S} s")
    lines = cli_out.splitlines()
    for line in lines:
        log(f"serve-procs-lm cli: {line}")
    log(f"serve-procs-lm (g) cli {' '.join(PROCS_LM_CLI)} (24 layers): rc "
        f"{cli.returncode}, {time.perf_counter() - t_cli:.1f} s, device "
        f"memory in use at most {cli_mem.peak / 2**30:.2f} GiB "
        f"({(total - free) / 2**30:.2f} GiB of it in use before it "
        f"started) [{card}]")
    if cli.returncode != 0 or sum(x.startswith("request ")
                                  for x in lines) != 4:
        fail(f"serve-procs-lm cli: rc {cli.returncode}: {cli_err[-1500:]}")
    phase_s = time.perf_counter() - t_phase
    log(f"serve-procs-lm: {phase_s:.1f} s (budget {PROCS_LM_BUDGET_S} s) "
        f"[{card}]")
    checks.append(phase_s <= PROCS_LM_BUDGET_S)
    if not all(checks):
        fail("serve-procs-lm: a process-mesh check failed (see above)")


def paper_attn(card: str) -> None:
    """K1 at the paper's two workloads at degree 1 (B 1, every head, not
    causal, bf16) and K2 at their Pull-KV ring step on mesh (pod 2, model
    8) (P_u 8 x P_r 2: BH 24 / P_u, the gathered Q of P_u shards against
    one shard).  Each is held against its plain version — K1 on PAPER_ROWS
    query rows against the full KV, since the whole score matrix does not
    fit on the card — and timed beside its bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import DIT_SHAPES, get_config
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels import ring_flash as rf
    from repro_torch.models.dit import COND_TOKENS

    gen = torch.Generator(device="cuda").manual_seed(9)
    checks = []
    epoch = 1000
    for name, arch in PAPER_WORKLOADS:
        cfg = get_config(arch)
        h, d = cfg.n_heads, cfg.resolved_head_dim
        l = COND_TOKENS + DIT_SHAPES[name].seq_len
        q, k, v = k1_inputs(gen, h, h, l, l, d, torch.bfloat16)
        pos = torch.arange(l, dtype=torch.int32, device="cuda")
        rows = slice(0, PAPER_ROWS)
        got = fm.flash_mqkv(q, k, v, pos, pos)[0][:, rows]
        ref = fm.flash_mqkv_plain(q[:, rows], k, v, pos[rows], pos)[0]
        err = (rel_err(got, ref, floor=0.0), norm_err(got, ref))
        del got, ref
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fm.flash_mqkv(q, k, v, pos, pos), reps=5,
                     warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            *(t.view(1, h, l, d) for t in (q, k, v))), reps=5, warmup=1)
        # q, k, v read once, o written once
        bound_ms, bound_by, flops = attention_bound(h, l, l,
                                                    4.0 * h * l * d * 2, d)
        plan = fm.tile_plan(h, l, l, d)
        log(f"paper-attn k1 {name} ({arch}) BH={h} L={l} D={d} bf16 (BQ "
            f"{plan.bq}): {rate_line(ms, bound_ms, flops)}, bound "
            f"{bound_ms:.3f} ms ({bound_by}), sdpa {lib_ms:.3f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s), K1 / sdpa "
            f"{ms / lib_ms:.3f}; o vs plain on {PAPER_ROWS} query rows: "
            f"max|d|/max|ref| {err[0]:.2e}, |d|/|ref| {err[1]:.2e} [{card}]")
        checks.append((err[0] <= FLUX_TOL["o"][0] and err[1] <= FLUX_TOL["o"][1],
                       f"K1 {name}: o err {err} (limits {FLUX_TOL['o']})"))
        del q, k, v

        shard = l // RANKS
        lq, bh = P_U * shard, h // P_U
        sets = [k1_inputs(gen, bh, bh, lq, shard, d, torch.bfloat16)
                for _ in range(ROTATE)]
        qp = torch.arange(lq, dtype=torch.int32, device="cuda")
        kp = torch.arange(shard, dtype=torch.int32, device="cuda") + shard
        q, k, v = sets[0]
        epoch += 1
        got = run_k2(q, k, v, qp, kp, epoch, finalize=False)
        ref = fm.flash_mqkv_plain(q, k, v, qp, kp, finalize=False)
        errs = {n: (rel_err(a, b, floor=0.0), norm_err(a, b))
                for n, a, b in zip(("o'", "l", "m"), got, ref)}
        del got, ref
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        arrive = torch.zeros_like(flag)
        dst = [(torch.empty_like(k), torch.empty_like(v))
               for _, k, v in sets]
        ms, host = time_call(rotating([
            lambda q=q, k=k, v=v, kd=kd, vd=vd: rf.ring_flash_step(
                q, k, v, qp, kp, k_dst=kd, v_dst=vd, flag=flag,
                arrive=arrive, epoch=1, finalize=False)
            for (q, k, v), (kd, vd) in zip(sets, dst)]), reps=50)
        plain_ms = cuda_ms(rotating([
            lambda q=q, k=k, v=v, kd=kd, vd=vd: rf.ring_flash_step_plain(
                q, k, v, qp, kp, k_dst=kd, v_dst=vd, finalize=False,
                scale=d ** -0.5)
            for (q, k, v), (kd, vd) in zip(sets, dst)]), reps=3, warmup=1)
        lib_ms = cuda_ms(rotating([
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.view(1, bh, lq, d), k.view(1, bh, shard, d),
                v.view(1, bh, shard, d))
            for q, k, v in sets]), reps=50)
        nbytes = (2 * bh * (lq + 2 * shard) * d  # q, k, v read once (bf16)
                  + 4 * bh * lq * d + 8 * bh * lq  # o' (f32), l, m written
                  + 2 * 2 * bh * shard * d)  # forwarded k and v written
        bound_ms, bound_by, flops = attention_bound(bh, lq, shard, nbytes, d)
        log(f"paper-attn k2 {name} pull-kv on pod2xmodel8 BH={bh} Lq={lq} "
            f"Lk={shard} D={d} bf16, {ROTATE} input sets in turn: "
            f"{rate_line(ms, bound_ms, flops)} on the device ({host:.4f} ms "
            f"of host time per call), bound {bound_ms:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, K2 / sdpa "
            f"{ms / lib_ms:.3f}; vs plain max|d|/max|ref|, |d|/|ref|: "
            + ", ".join(f"{n} {e[0]:.2e} {e[1]:.2e}" for n, e in errs.items())
            + f" [{card}]")
        for n, (e_max, e_norm) in errs.items():
            lim = FLUX_TOL[n]
            checks.append((e_max <= lim[0] and e_norm <= lim[1],
                           f"K2 {name} {n}: errs {e_max}, {e_norm} (limits "
                           f"{lim})"))
        del sets, dst, q, k, v
        torch.cuda.empty_cache()
    for ok, msg in checks:
        if not ok:
            fail(msg)


def layer_paper(card: str) -> None:
    """One bf16 layer of each paper workload (B 1), at degree 1 and under
    swift_torus on mesh (pod 2, model 8): is the SP layer still host-bound
    where attention outgrows the GEMMs?"""
    from repro_torch.configs import DIT_SHAPES
    from repro_torch.models.dit import COND_TOKENS
    for name, arch in PAPER_WORKLOADS:
        layer_breakdown(card, arch, 1, COND_TOKENS + DIT_SHAPES[name].seq_len)


def serve_cogvideox(results: dict, card: str):
    """DiTServer at degree 1 on cogvideox-5b at full width and depth (bf16,
    random weights from a seed, zero-init tensors perturbed): one request
    of cogvideox_20s's latent tokens, COGVIDEO_STEPS steps.  First the
    card-vs-CPU parity of one full-width fp32 block.  Returns the weights
    for serve-hybrid."""
    import torch
    from repro_torch.configs import DIT_SHAPES, get_config
    from repro_torch.core import SPConfig
    from repro_torch.models import init_dit
    from repro_torch.models.dit import COND_TOKENS
    from repro_torch.serving import SamplerConfig

    check_block("cogvideox-5b")
    cfg = get_config("cogvideox-5b")
    gen = torch.Generator(device="cuda").manual_seed(10)
    t0 = time.perf_counter()
    params = init_dit(cfg, gen, device="cuda")
    perturb_zero_init(params, gen)
    params["proj_out"]["w"] *= VELOCITY_SCALE
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve-cogvideox: cogvideox-5b {cfg.n_layers} layers d={cfg.d_model} "
        f"heads {cfg.n_heads} x {cfg.resolved_head_dim} bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} "
        f"s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    requests = ((0, DIT_SHAPES["cogvideox_20s"].seq_len),)
    conds = {0: torch.randn((COND_TOKENS, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)}
    torch.cuda.reset_peak_memory_stats()
    out, wall, counts, forwards, srv = run_server(
        params, cfg, conds, requests, SPConfig(strategy="full"),
        sampler=SamplerConfig(num_steps=COGVIDEO_STEPS))
    expect = {"flash_mqkv": cfg.n_layers * forwards, "ring_flash_step": 0,
              "remote_put": 0, "landing_copy": 0}
    log(f"serve-cogvideox: 1 request of {requests[0][1]} latent tokens (L "
        f"{COND_TOKENS + requests[0][1]}) in {wall:.2f} s, launches {counts} "
        f"(expected {cfg.n_layers} layers x {forwards} forwards of K1), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    check_latents("serve-cogvideox", out, srv, card, requests)
    if counts != expect:
        fail(f"serve-cogvideox launches {counts} != {expect}")
    results["cogvideox_step_times"] = out[0].step_times
    return params, cfg


def serve_hybrid(results: dict, card: str, params, cfg) -> None:
    """DiTServer on cogvideox-5b (full width and depth, bf16) over the
    hybrid mesh (cfg 2, pipe 2, data 1, model 4): swift_torus on the model
    axis through K1 and the direct put K3, the CFG pair on the cfg axis,
    the displaced pipeline over the pipe axis (hand-offs through K3).  One
    request of HYBRID_LATENTS, STEPS steps, guidance GUIDANCE.  Gates:
    (a) all warm, the latents are within SERVE_SP_TOL of the degree-1
    server's sequential CFG, in float32 (the bfloat16 error is printed),
    and with one KV chunk of every attention dropped they are not; (b) with one warm step the run is finite, its
    kv_drift 0 at the warm step and > 0 after, its latents within
    DISPLACED_SHARE of max|all-warm| yet not equal to them; (c) a
    displaced forward on the state of a warm pass at the same (x, t)
    equals that warm forward within DISPLACED_FWD_TOL, and with the stale
    segment dropped it does not; (d) the launch counts the schedule
    implies."""
    import torch
    from repro_torch.core import PipelineConfig, SPConfig, torus
    from repro_torch.core.softmax import empty_partial
    from repro_torch.core.strategy import resolve_layout
    from repro_torch.launch import make_hybrid_mesh
    from repro_torch.models import ParallelContext, blocks
    from repro_torch.models.dit import (COND_TOKENS, dit_forward,
                                        dit_forward_displaced)
    from repro_torch.serving import DiTRequest, SamplerConfig
    from repro_torch.serving.sampler import _stack_cfg_branches

    mesh = make_hybrid_mesh(*HYBRID_MESH, device="cuda")
    sp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                  batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
                  comm_backend="pallas", kernel_interpret=False)
    gen = torch.Generator(device="cuda").manual_seed(11)
    requests = ((0, HYBRID_LATENTS),)
    cond = torch.randn((COND_TOKENS, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)
    pp, n_layers = HYBRID_PIPE["pp"], cfg.n_layers

    def sampler(warmup):
        return SamplerConfig(num_steps=STEPS, guidance_scale=GUIDANCE,
                             cfg_parallel=True, pipeline=PipelineConfig(
                                 warmup_steps=warmup, **HYBRID_PIPE))

    # launches per layer of a warm forward: every slice of the batch (the
    # CFG pair on the cfg axis) runs swift_torus on its own model ranks;
    # a ring circulation (stage 0, P_u - 1 Pull-Q, P_u - 1 Pull-KV) is
    # P_r - 1 K2 and one K1 per rank, and every torus put is ONE K3 for
    # all ranks of all slices (a single-axis route)
    lay = resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
    ranks = mesh.axes_size(sp.effective_batch_axes(mesh)) * lay.size
    circ = 1 + 2 * (lay.p_ulysses - 1)
    warm_layer = {"flash_mqkv": ranks * circ,
                  "ring_flash_step": ranks * circ * (lay.p_ring - 1),
                  "remote_put": 3 * (lay.p_ulysses - 1), "landing_copy": 0}

    def expected(warm: int, displaced: int, patches: int) -> dict:
        """Launches of ``warm`` warm and ``displaced`` displaced forwards:
        a displaced forward attends each (patch, layer) in two K1 launches
        (fresh rows, then stale rows; both CFG branches ride one batch)
        and hands each patch over each of the pp - 1 stage boundaries in
        one K3."""
        c = {k: v * n_layers * warm for k, v in warm_layer.items()}
        c["flash_mqkv"] += displaced * 2 * patches * n_layers
        c["remote_put"] += displaced * patches * (pp - 1)
        return c

    log(f"serve-hybrid: mesh (cfg, pipe, data, model) {HYBRID_MESH}, "
        f"swift_torus P_u {lay.p_ulysses} x P_r {lay.p_ring} on model over "
        f"{ranks} virtual ranks; per warm layer {warm_layer}")

    def degree1(tag: str):
        """The degree-1 server's sequential CFG: (latents, noise)."""
        one, wall, _, _, srv = run_server(
            params, cfg, {0: cond}, requests, SPConfig(strategy="full"),
            sampler=SamplerConfig(num_steps=STEPS, guidance_scale=GUIDANCE))
        log(f"serve-hybrid {tag} degree 1 (sequential CFG): {wall:.2f} s, "
            f"step wall clock {[round(t, 4) for t in one[0].step_times]} s "
            f"[{card}]")
        return one[0].latents, srv._noise(
            [DiTRequest(rid=0, seq_len=HYBRID_LATENTS)], 1, HYBRID_LATENTS)[0]

    def all_warm(tag: str, ref, drop_kv: bool = False):
        """The all-warm hybrid run (with ``drop_kv``, with the first
        Pull-KV chunk of every attention dropped): its result and its
        latents' error beside the degree-1 ``ref`` (latents, noise)."""
        real = torus.ring_attention
        calls = [0]

        def dropping(q, *args, **kw):
            parts = real(q, *args, **kw)
            calls[0] += 1
            if calls[0] % circ == lay.p_ulysses + 1:  # the first Pull-KV
                return [empty_partial(*x.shape, device=x.device) for x in q]
            return parts

        torus.ring_attention = dropping if drop_kv else real
        try:
            warm, wall, counts, forwards, srv = run_server(
                params, cfg, {0: cond}, requests, sp, mesh, sampler(STEPS))
        finally:
            torus.ring_attention = real
        check_latents(f"serve-hybrid {tag} all-warm", warm, srv, card,
                      requests)
        err = latent_err(warm[0].latents, *ref)
        want = expected(forwards, 0, 0)
        log(f"serve-hybrid {tag} all-warm{' (KV chunk dropped)' * drop_kv}: "
            f"{wall:.2f} s, latents vs degree 1 ||d||/||x1-noise|| = "
            f"{err:.3e}; step wall clock "
            f"{[round(t, 4) for t in warm[0].step_times]} s; launches "
            f"{counts} (expected {want}) [{card}]")
        checks.append((counts == want, f"serve-hybrid {tag} all-warm "
                                       f"launches {counts} != {want}"))
        return warm[0], err

    checks = []
    # bfloat16: the all-warm run is gate (b)'s reference
    x_one, noise = degree1("bf16")
    warm, err_bf16 = all_warm("bf16", (x_one, noise))
    x_warm = warm.latents
    results["hybrid_warm_step_times"] = warm.step_times

    # (b) warmup 1, then displaced
    disp, wall, counts, forwards, srv = run_server(
        params, cfg, {0: cond}, requests, sp, mesh, sampler(1))
    check_latents("serve-hybrid displaced", disp, srv, card, requests)
    r = disp[0]
    (choice,) = srv.plan_cache.plans.values()
    patches = srv._bucket_sampler(choice).pipeline.patches
    want = expected(1, forwards - 1, patches)
    diff = float((r.latents.float() - x_warm.float()).abs().max())
    bound = DISPLACED_SHARE * float(x_warm.float().abs().max())
    log(f"serve-hybrid displaced (pp {pp}, {patches} patches, warmup 1): "
        f"{wall:.2f} s, step wall clock {[round(t, 4) for t in r.step_times]}"
        f" s (step 0 warm), kv_drift {[f'{d:.3e}' for d in r.kv_drift]}, "
        f"max|x - x_warm| {diff:.3e} (bound {bound:.3e}), launches {counts} "
        f"(expected {want}) [{card}]")
    finite = bool(torch.isfinite(r.latents).all())
    drift_ok = (r.kv_drift[0] == 0.0 and all(
        0.0 < d < float("inf") for d in r.kv_drift[1:]))
    checks += [(finite and drift_ok and 0.0 < diff < bound,
                f"serve-hybrid (b): finite {finite}, kv_drift {r.kv_drift}, "
                f"diff {diff} (bound {bound})"),
               (counts == want, f"serve-hybrid displaced launches {counts} "
                                f"!= {want}")]
    results["hybrid_disp_step_times"] = r.step_times
    results["hybrid_launches"] = counts
    del srv, disp, warm

    # phase 22 (hybrid part, bf16, full depth): three admissions of the
    # bucket one after another: the first one's steps are the graphs'
    # eager warm-ups (warm, then displaced), the third one only replays
    reqs = tuple((rid, HYBRID_LATENTS) for rid in range(3))
    rep, wall, _, _, _ = run_server(params, cfg, {rid: cond for rid, _ in reqs},
                                    reqs, sp, mesh, sampler(1), max_batch=1)
    first, *_, last = sorted(rep.values(), key=lambda r: r.latency)
    warm_e, disp_e = first.step_times[0], median(first.step_times[1:3])
    warm_c, disp_c = last.step_times[0], median(last.step_times[1:])
    log(f"capture hybrid bf16 ({n_layers} layers, 3 admissions, {wall:.2f} "
        f"s): warm step {warm_c:.4f} s replayed vs {warm_e:.4f} s eager, "
        f"displaced {disp_c:.4f} s replayed vs {disp_e:.4f} s eager; step "
        f"wall clocks {[[round(t, 4) for t in r.step_times] for r in (first, last)]}"
        f" [{card}]")
    results["hybrid_replay"] = (warm_c, warm_e, disp_c, disp_e)
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one displaced forward on a warm pass's state at the same (x, t)
    ctx = ParallelContext(sp, mesh=mesh)
    lat, cnd = _stack_cfg_branches(noise[None], cond[None], 2)
    tt = torch.full((2,), 1.0 - 1.0 / STEPS, device="cuda")
    kw = dict(latents=lat, cond=cnd, timesteps=tt)
    pipe_kw = dict(num_patches=HYBRID_PIPE["num_patches"], pp=pp)
    real = blocks.displaced_attention
    with torch.inference_mode():
        v_w, state = dit_forward(params, cfg, ctx, return_layer_kv=True, **kw)
        reset_counts()
        v_d, new = dit_forward_displaced(params, cfg, ctx, kv_state=state,
                                         **pipe_kw, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        del new
        blocks.displaced_attention = (
            lambda q, kf, vf, ks, vs: real(q, kf, vf, ks[:, :0], vs[:, :0]))
        try:
            v_x, new = dit_forward_displaced(params, cfg, ctx,
                                             kv_state=state, **pipe_kw, **kw)
        finally:
            blocks.displaced_attention = real
        del new, state
    err = latent_err(v_d, v_w, torch.zeros_like(v_w))
    drop = latent_err(v_x, v_w, torch.zeros_like(v_w))
    want = expected(0, 1, HYBRID_PIPE["num_patches"])
    log(f"serve-hybrid one displaced forward on a warm state: ||v_d - v_w|| "
        f"/ ||v_w|| = {err:.3e} (tol {DISPLACED_FWD_TOL}); stale segment "
        f"dropped: {drop:.3e} (must exceed it); launches {counts} (expected "
        f"{want})")
    checks += [(err <= DISPLACED_FWD_TOL < drop,
                f"serve-hybrid (c): err {err}, dropped {drop}"),
               (counts == want, f"serve-hybrid (d): one displaced forward "
                                f"launched {counts} != {want}")]

    # (a) in float32, the weights converted in place: in bfloat16 the
    # guidance (4 v_c - 3 v_u) amplifies the ~1e-2 by which two equal
    # bf16 forwards differ (gate (c)) past SERVE_SP_TOL, whatever the path
    cast_(params, torch.float32)
    cfg = dataclasses.replace(cfg, dtype="float32")
    cond = cond.float()
    ref = degree1("fp32")
    _, err = all_warm("fp32", ref)
    _, dropped = all_warm("fp32", ref, drop_kv=True)
    log(f"serve-hybrid (a): all-warm latents vs degree 1, fp32 {err:.3e} "
        f"(tol {SERVE_SP_TOL}; one KV chunk of every attention dropped "
        f"{dropped:.3e}, must exceed it); bf16 {err_bf16:.3e} (not gated)")
    checks.append((err <= SERVE_SP_TOL < dropped,
                   f"serve-hybrid (a): fp32 err {err}, dropped {dropped}"))
    results["hybrid_err"] = (err, dropped, err_bf16)
    gc.collect()
    torch.cuda.empty_cache()
    capture_hybrid(results, card, params, cfg, cond, sp, mesh, sampler,
                   checks)
    for ok, msg in checks:
        if not ok:
            fail(msg)


def capture_hybrid(results: dict, card: str, params, cfg, cond, sp, mesh,
                   sampler, checks: list) -> None:
    """Phase 22 (hybrid part): the captured hybrid server against the same
    server with capture=False, in float32, at HYBRID_CAPTURE_LAYERS
    layers: three requests of HYBRID_LATENTS served one at a time (warm
    step 0, then displaced), so that the third admission replays all four
    graphs of the bucket; latents and kv_drift bitwise, launches equal,
    the K3 signal words re-written by a replay."""
    import torch

    sub = dict(params, layers=params["layers"][:HYBRID_CAPTURE_LAYERS])
    cfg_s = dataclasses.replace(cfg, n_layers=HYBRID_CAPTURE_LAYERS)
    reqs = tuple((rid, HYBRID_LATENTS) for rid in range(3))
    conds = {rid: cond for rid, _ in reqs}
    cap, cwall, ccounts, _, csrv = run_server(
        sub, cfg_s, conds, reqs, sp, mesh, sampler(1), max_batch=1)
    eag, ewall, ecounts, _, _ = run_server(
        sub, cfg_s, conds, reqs, sp, mesh, sampler(1), capture=False,
        max_batch=1)
    same = all(torch.equal(cap[r].latents, eag[r].latents)
               and cap[r].kv_drift == eag[r].kv_drift for r in cap)
    log(f"capture hybrid ({HYBRID_CAPTURE_LAYERS} layers, fp32, 3 "
        f"admissions): captured latents and kv_drift bitwise the eager "
        f"server's {same}; {cwall:.2f} s vs {ewall:.2f} s; launches "
        f"captured {ccounts} eager {ecounts} [{card}]")
    steps = log_graphs("capture hybrid", csrv, card)
    last = max(cap, key=lambda r: cap[r].latency)  # admitted last
    for rid in sorted(cap):
        log(f"capture hybrid rid={rid}: step wall clock captured "
            f"{[round(t, 4) for t in cap[rid].step_times]} s, eager "
            f"{[round(t, 4) for t in eag[rid].step_times]} s (step 0 warm)")
    c, e = cap[last].step_times, eag[last].step_times
    log(f"capture hybrid: the third admission's replays: warm step "
        f"{c[0]:.4f} s vs eager {e[0]:.4f} s, displaced median "
        f"{median(c[1:]):.4f} s vs eager {median(e[1:]):.4f} s [{card}]")
    results["capture_hybrid"] = (c, e)
    checks += [(same, "capture hybrid: captured != eager"),
               (ccounts == ecounts and ccounts["remote_put"] > 0,
                f"capture hybrid: launches {ccounts} != {ecounts}"),
               # warmup 1: the warm step is always step 0 (parity 0)
               (sum(st.replays > 0 for st in steps) == 3,
                "capture hybrid: warm0, displaced0 and displaced1 must "
                "each replay")]
    check_signal_words("capture hybrid", steps, checks)


# ---------------------------------------------------------------------------
# phases 19 to 21: the hierarchical all-to-all, the span profiler and the
# schedule gate of the comm layer
# ---------------------------------------------------------------------------

# fp8 wire vs exact, max|d| / max|O| of the attention output: the
# reference's roundtrip bounds for one quantisation (tests/test_compress.py;
# e4m3 keeps 3 mantissa bits, a relative step of 2^-3, e5m2 2 bits).  The
# negative control (one Push-O chunk of every rank dropped) must exceed it.
FP8_TOL = {"float8_e4m3fn": 0.08, "float8_e5m2": 0.15}
# K4 launches per layer on mesh (pod 2, model 8), P_u 8 = 2 machines x 4:
# 7 Pull-Q + 7 Pull-KV + 7 Push-O flat; the hierarchical Push-O is 3 intra
# puts (of 2-chunk bundles) and 1 inter put (of a 4-chunk bundle)
HIER_PUTS = {False: 3 * (P_U - 1), True: 2 * (P_U - 1) + (P_U // 2 - 1) + 1}
# depth of the capture phase's swift_torus oracle (8, then 4, each cut to
# make room for a process-mesh phase; its gates are bitwise)
# 1 layer since PR 30 (2 before): its gates (bitwise the eager server,
# launches per replay the eager count) do not depend on depth
CAPTURE_LAYERS = 1
# depth of its fp32 hybrid oracle (cogvideox-5b): one layer a pipe stage
HYBRID_CAPTURE_LAYERS = 2
PROFILE_LATENTS = 1024  # the profile phase's one request
PROFILE_STEPS = 3  # an eager warm-up, a capture + replay, a replay
# the profile phase's depth of flux-12b's 96 layers (its checks do not
# depend on depth; at SERVE_SP_LAYERS it took ~41 s, at 16 22.5 s; PR 29
# cut it from 16 to 8 to make room for serve-procs, then PR 30 to 2)
PROFILE_LAYERS = 2


def _layer_times(fn, label: str, card: str) -> dict:
    """Three calls of ``fn`` (a layer, already warm) untraced, then one
    traced by torch.profiler: the median wall ms, device busy ms, and the
    put kernels' and the copies' device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):  # the host clock of one layer is noisy: a median
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k4 = sum(e.self_device_time_total for e in kernels
             if "landing_copy" in e.key) / 1e3
    copies = sum(e.self_device_time_total for e in kernels
                 if "copy" in e.key.lower() and "landing_copy" not in e.key
                 ) / 1e3
    out = dict(wall=wall, busy=busy, k4=k4, copies=copies)
    log(f"hier {label}: wall {wall:.1f} ms (median of "
        f"{[round(w, 1) for w in walls]}), device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall:.3f}), K4 {k4:.3f} ms, copy kernels "
        f"{copies:.3f} ms [{card}]")
    return out


def hier(results: dict, card: str) -> None:
    """Phase 19: the hierarchical all-to-all on one flux-12b layer at the
    serve shape (B 2, L 4352, bf16), kernel path.  (a) swift_torus on mesh
    (pod 2, model 8) with and without hier_a2a: bitwise equal, K4 18
    against 21 per layer, K1/K2 unchanged; (b) ulysses on mesh (pod 2,
    model 4), hierarchical against flat: bitwise equal; (c) the fp8 wires:
    engaged, within FP8_TOL of exact beside the dropped-chunk control, and
    one inter put's payload and scale from the card equal to the CPU
    codec's, then delivered by K4 bitwise as the plain landing copy does;
    (d) each variant's wall clock and device time."""
    import torch
    from repro_torch.comm import compress
    from repro_torch.comm import kernel_backend as kb
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig, sp_attention, torus
    from repro_torch.launch import make_mesh
    from repro_torch.models.blocks import ParallelContext
    from repro_torch.models.dit import dit_block, init_dit

    cfg = dataclasses.replace(get_config("flux-12b"), n_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    params = init_dit(cfg, gen, device="cuda")
    perturb_zero_init(params, gen)
    lp = params["layers"][0]
    b, l = 2, 4352
    x = torch.randn((b, l, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t_emb = torch.randn((b, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    meshes = {"pod2xmodel8": make_mesh((2, 8), ("pod", "model"), "cuda"),
              "pod2xmodel4": make_mesh((2, 4), ("pod", "model"), "cuda")}

    def spc(strategy, hier_a2a, wire=None):
        return SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                        machine_axis="pod", comm_backend="pallas",
                        kernel_interpret=False, hier_a2a=hier_a2a,
                        a2a_wire_dtype=wire)

    checks, times, outs = [], {}, {}
    variants = (("swift_torus", "pod2xmodel8", False, None),
                ("swift_torus", "pod2xmodel8", True, None),
                ("swift_torus", "pod2xmodel8", True, "float8_e4m3fn"),
                ("swift_torus", "pod2xmodel8", True, "float8_e5m2"),
                ("ulysses", "pod2xmodel4", False, None),
                ("ulysses", "pod2xmodel4", True, None))
    for strategy, mesh_name, hier_a2a, wire in variants:
        label = (f"{strategy} {mesh_name} "
                 f"{'hier' if hier_a2a else 'flat'}"
                 f"{' ' + wire if wire else ''}")
        ctx = ParallelContext(spc(strategy, hier_a2a, wire),
                              mesh=meshes[mesh_name])
        with torch.inference_mode():
            reset_counts()
            outs[label] = dit_block(lp, cfg, ctx, x, t_emb, pos)
            torch.cuda.synchronize()
            counts = read_counts()
            times[label] = _layer_times(
                lambda: dit_block(lp, cfg, ctx, x, t_emb, pos), label, card)
        log(f"hier {label}: launches per layer {counts}")
        if strategy == "swift_torus":
            want = {"flash_mqkv": K1_PER_LAYER,
                    "ring_flash_step": K2_PER_LAYER, "remote_put": 0,
                    "landing_copy": HIER_PUTS[hier_a2a]}
        else:  # P_u 8 x P_r 1: one K1 per rank; four all-to-alls of 7
            # staged puts, or of 3 intra and 1 inter put
            want = {"flash_mqkv": 8, "ring_flash_step": 0, "remote_put": 0,
                    "landing_copy": 4 * (4 if hier_a2a else 7)}
        checks.append((counts == want,
                       f"hier {label}: launches {counts} != {want}"))
    for flat, two_level in (("swift_torus pod2xmodel8 flat",
                             "swift_torus pod2xmodel8 hier"),
                            ("ulysses pod2xmodel4 flat",
                             "ulysses pod2xmodel4 hier")):
        same = torch.equal(outs[flat], outs[two_level])
        log(f"hier (a/b) {two_level} vs flat: bitwise equal {same}")
        checks.append((same, f"{two_level} differs from the flat layer"))
    base = times["swift_torus pod2xmodel8 flat"]
    for label, t in times.items():
        dev = (f"{t['busy']:.2f} ms ({t['busy'] / base['busy']:.3f} x)"
               if base["busy"] > 0 else "not measured (no device time seen)")
        log(f"hier (d) {label}: wall {t['wall']:.1f} ms "
            f"({t['wall'] / base['wall']:.3f} x flat swift_torus), device "
            f"{dev}, K4 {t['k4']:.3f} ms, copy kernels {t['copies']:.3f} ms "
            f"[{card}]")
    results["hier_times"] = times

    # (c) the fp8 wire on the attention output itself
    q, k, v = (torch.randn((b, l, cfg.n_heads, cfg.resolved_head_dim),
                           generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mesh = meshes["pod2xmodel8"]
    with torch.inference_mode():
        exact = sp_attention(q, k, v, cfg=spc("swift_torus", True),
                             mesh=mesh).float()
        real_scatter = torus.scatter_o

        def dropping(o, layout, **kw):
            # every rank's chunk for its ulysses peer u + 1 is lost
            for p, part in enumerate(o):
                u = layout.coords(p)[0]
                j = (u + 1) % layout.p_ulysses
                rows = part.shape[1] // layout.p_ulysses
                part[:, j * rows:(j + 1) * rows] = 0
            return real_scatter(o, layout, **kw)

        torus.scatter_o = dropping
        try:
            dropped = sp_attention(q, k, v, cfg=spc("swift_torus", True),
                                   mesh=mesh).float()
        finally:
            torus.scatter_o = real_scatter
        o_max = float(exact.abs().max())
        control = float((dropped - exact).abs().max()) / o_max
        for wire, tol in FP8_TOL.items():
            seen = []
            real_q = compress.quantize

            def capture(xq, wd, seen=seen, real_q=real_q):
                wire_t, scale = real_q(xq, wd)
                if not seen:
                    seen.append((xq.clone(), wire_t.clone(), scale.clone()))
                return wire_t, scale

            compress.quantize = capture
            try:
                got = sp_attention(q, k, v, mesh=mesh,
                                   cfg=spc("swift_torus", True, wire)).float()
            finally:
                compress.quantize = real_q
            err = float((got - exact).abs().max()) / o_max
            xq, card_wire, card_scale = seen[0]
            cpu_wire, cpu_scale = compress.quantize(xq.cpu(), wire)
            codec_ok = (torch.equal(card_wire.cpu().view(torch.uint8),
                                    cpu_wire.view(torch.uint8))
                        and card_scale.item() == cpu_scale.item())
            log(f"hier (c) {wire}: max|d|/max|O| vs exact {err:.4e} (tol "
                f"{tol}; one Push-O chunk dropped: {control:.4e}); one inter "
                f"bundle {tuple(xq.shape)} {xq.dtype}: card payload and scale "
                f"== CPU codec's: {codec_ok} (scale {card_scale.item():.6e})")
            checks += [(err > 0.0, f"{wire}: the fp8 wire did not engage"),
                       (err <= tol < control,
                        f"{wire}: err {err}, tol {tol}, control {control}"),
                       (codec_ok, f"{wire}: card codec != CPU codec")]
            if wire == "float8_e4m3fn":
                checks.append(fp8_landing_copy(card_wire, card_scale, gen,
                                               results, card))
    del params
    torch.cuda.empty_cache()
    for ok, msg in checks:
        if not ok:
            fail(msg)


def fp8_landing_copy(wire, scale, gen, results: dict, card: str):
    """K4 on the inter put of the fp8 Push-O: 16 ranks x (an fp8 bundle
    like ``wire`` and a 0-d float32 scale), bitwise as the plain landing
    copy, timed beside it and one copy_ of the same bytes."""
    import torch
    from repro_torch.comm import kernel_backend as kb

    def rank_set():
        return [[(torch.randn(wire.shape, generator=gen, device="cuda")
                  * 64).to(wire.dtype),
                 torch.rand((), generator=gen, device="cuda")]
                for _ in range(RANKS)]

    src = [[wire, scale]] + rank_set()[1:]
    dst = [[torch.empty_like(t) for t in r] for r in src]
    ref = [[torch.empty_like(t) for t in r] for r in src]
    signal, arrive = put_words(2 * RANKS)
    kb.landing_copy(src, dst, signal=signal, arrive=arrive, epoch=5)
    kb.landing_copy_plain(src, ref, torch.zeros_like(signal), 5)
    torch.cuda.synchronize()
    same = all(torch.equal(a.reshape(-1).view(torch.uint8),
                           c.reshape(-1).view(torch.uint8))
               for ra, rc in zip(dst, ref) for a, c in zip(ra, rc))
    judge_words("k4 fp8 + scale", signal, arrive, 5)
    nbytes = sum(t.numel() * t.element_size() for r in src for t in r)
    n_sets = max(ROTATE, -(-4 * L2_BYTES // (2 * nbytes)))
    sets = [rank_set() for _ in range(n_sets)]
    outs = [[[torch.empty_like(t) for t in r] for r in s] for s in sets]
    ms = cuda_ms(rotating([lambda s=s, d=d: kb.landing_copy(
        s, d, signal=signal, arrive=arrive, epoch=6)
        for s, d in zip(sets, outs)]), reps=50)
    plain_ms = cuda_ms(rotating([lambda s=s, d=d: kb.landing_copy_plain(
        s, d, signal, 6) for s, d in zip(sets, outs)]), reps=20)
    flats = [(torch.cat([t.reshape(-1).view(torch.uint8) for r in s
                         for t in r]),) for s in sets]
    flats = [(f, torch.empty_like(f)) for (f,) in flats]
    lib_ms = cuda_ms(rotating([lambda a=a, c=c: c.copy_(a)
                               for a, c in flats]), reps=50)
    bound_ms = 2 * nbytes / HBM_BPS * 1e3
    results["k4_fp8"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms)
    log(f"hier (c) K4 on the fp8 inter put, 16 ranks x ({tuple(wire.shape)} "
        f"{wire.dtype} + 0-d float32 scale), {nbytes / 2**20:.3f} MiB: "
        f"bitwise as the plain landing copy {same}; {ms:.4f} ms on the "
        f"device, bound {bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms, "
        f"one copy_ {lib_ms:.4f} ms [{card}]")
    return same, "K4 on an fp8 payload + 0-d scale differs from plain"


def profile_phase(results: dict, card: str, params, cfg, conds) -> None:
    """Phase 20: DiTServer(profile=True) on flux-12b at full width and
    PROFILE_LAYERS layers, mesh (pod 2, model 8), swift_torus, one PROFILE_LATENTS-latent
    request, PROFILE_STEPS steps: latents bitwise those of profile=False,
    the spans' JSONL passes ``launch.trace_report --check``, the overlap
    table's rows of the torus hops, the ring shifts and the Push-O puts,
    and the profiler's cost (step wall clock with and without it)."""
    import os
    import tempfile

    import torch
    from repro_torch.launch import make_mesh, trace_report
    from repro_torch.serving import (DiTRequest, DiTServer, JsonlTracker,
                                     RecordingTracker, SamplerConfig)

    mesh = make_mesh((2, 8), ("pod", "model"), device="cuda")
    sp = sp_config(("pod", "model"))
    rid = 2
    path = pathlib.Path(tempfile.mkdtemp()) / "serve_profile.jsonl"

    def run(profile_on):
        tracker = JsonlTracker(path) if profile_on else RecordingTracker()
        srv = DiTServer(params, cfg, sp, mesh=mesh, tracker=tracker,
                        sampler=SamplerConfig(num_steps=PROFILE_STEPS),
                        profile=profile_on, max_batch=1)
        srv.submit(DiTRequest(rid=rid, seq_len=PROFILE_LATENTS,
                              cond=conds[rid]))
        reset_counts()
        (res,) = srv.serve()
        torch.cuda.synchronize()
        counts = read_counts()
        tracker.close()
        return res, counts

    plain, _ = run(False)
    prof, counts = run(True)
    same = torch.equal(prof.latents, plain.latents)
    log(f"profile: flux-12b {cfg.n_layers} layers, 1 x {PROFILE_LATENTS} "
        f"latents, {PROFILE_STEPS} steps on mesh (pod 2, model 8): latents "
        f"bitwise equal to profile=False {same}; step wall clock "
        f"{[round(t, 4) for t in prof.step_times]} s profiled vs "
        f"{[round(t, 4) for t in plain.step_times]} s without (cost "
        f"{sum(prof.step_times) / sum(plain.step_times) - 1:+.3f}); "
        f"launches {counts} [{card}]")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report", str(path),
         "--check"], capture_output=True, text=True, timeout=300,
        env=dict(__import__("os").environ,
                 PYTHONPATH=str(ROOT / "src")))
    log(f"profile: trace_report --check rc {proc.returncode}: "
        f"{proc.stderr.strip()[-300:]}")
    spans = trace_report.load_spans(path)
    steps = sorted((r for r in spans if r.name == "engine.step"),
                   key=lambda r: r.t_start)
    # step 0 is the eager warm-up, step 1 the capture and first replay,
    # the rest replays: read the replays' legs apart from the warm-up's
    t_replay = steps[2].t_start if len(steps) > 2 else float("inf")
    for label, part in (
            ("eager warm-up", [r for r in spans if r.t_start < steps[1].t_start]),
            ("replays", [r for r in spans if r.t_start >= t_replay])):
        rows = trace_report.overlap_table(part)
        for row in rows:
            if row["stream"] not in ("torus", "ring", "a2a.inv"):
                continue
            exposed_ms = row["exposed_s"] * 1e3
            log(f"profile overlap ({label}) {row['stream']}/"
                f"{row['channel']}/s{row['stage']}: n {row['n']}, mean "
                f"{row['mean_us']:.1f} us, hidden {row['hidden_frac']:.3f}, "
                f"exposed {exposed_ms:.3f} ms in all "
                f"({exposed_ms / row['n']:.4f} ms each), under compute "
                f"{row['compute_overlap_frac']:.3f}, intended "
                f"{row['intended_hidden']} [{card}]")
    rows = trace_report.overlap_table(spans)
    legs = [r for r in spans if r.name == "comm.leg"]
    log(f"profile: {len(spans)} spans ({len(legs)} comm legs, {len(steps)} "
        f"engine.step) in {path}")
    results["profile"] = dict(rows=rows, plain=plain.step_times,
                              profiled=prof.step_times)
    if not same:
        fail("profile: profiled latents differ from profile=False")
    if proc.returncode != 0 or not legs or len(steps) != PROFILE_STEPS:
        fail(f"profile: trace_report rc {proc.returncode}, {len(legs)} legs, "
             f"{len(steps)} step spans")
    if counts["landing_copy"] <= 0 or counts["ring_flash_step"] <= 0:
        fail(f"profile: the put kernels did not run: {counts}")


def commcheck_phase(card: str) -> None:
    """Phase 21: ``python -m repro_torch.launch.commcheck`` on the card, its
    spans checked by the trace report: every comm.trace line OK, exit 0."""
    import os
    import tempfile

    path = pathlib.Path(tempfile.mkdtemp()) / "commcheck.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.commcheck", "--profile",
         str(path)], capture_output=True, text=True, timeout=600, env=env)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("comm.trace")]
    for line in proc.stdout.splitlines():
        log(f"commcheck: {line}")
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report", str(path),
         "--check"], capture_output=True, text=True, timeout=300, env=env)
    log(f"commcheck: rc {proc.returncode}, {len(lines)} comm.trace lines, "
        f"trace_report --check rc {rep.returncode} "
        f"({rep.stderr.strip()[-200:]}), {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    if (proc.returncode != 0 or len(lines) != 6
            or not all(" OK" in x for x in lines) or rep.returncode != 0):
        fail(f"commcheck: rc {proc.returncode}: {proc.stderr[-1500:]}")


SERVE_CLI_AT_ONCE = 3  # concurrent launcher runs (9 in a row took ~125 s)
SERVE_CLI = (
    # 16 and 8 of the 96 layers (96 and 16 until PR 29, which cut them to
    # make room for serve-procs; PR 30 cut degree 1 from 32 to 16): a
    # 96-layer SP graph alone takes ~50 s to capture and instantiate, and
    # the serve phase already runs all 96
    ("flux-12b degree 1", ["--arch", "flux-12b", "--requests", "2",
                           "--seq", "1024", "--steps", "3", "--layers",
                           "16"]),
    ("flux-12b mesh pod", ["--arch", "flux-12b", "--mesh", "pod",
                           "--requests", "1", "--seq", "256", "--steps",
                           "3", "--layers", "8"]),
    ("rwkv6-1.6b", ["--arch", "rwkv6-1.6b", "--requests", "4"]),
    # the attention LMs at 4 of their layers (all of them until PR 29): the
    # prefill and serve phases run them at full depth
    ("qwen2-1.5b degree 1", ["--arch", "qwen2-1.5b", "--requests", "4",
                             "--layers", "4"]),
    ("qwen2-1.5b mesh pod", ["--arch", "qwen2-1.5b", "--mesh", "pod",
                             "--requests", "4", "--layers", "4"]),
    ("hymba-1.5b degree 1", ["--arch", "hymba-1.5b", "--requests", "2",
                             "--layers", "4"]),
    ("hymba-1.5b mesh pod", ["--arch", "hymba-1.5b", "--mesh", "pod",
                             "--requests", "2", "--layers", "4"]),
    ("qwen2-moe-a2.7b degree 1", ["--arch", "qwen2-moe-a2.7b",
                                  "--requests", "2", "--layers", "4"]),
    ("qwen2-moe-a2.7b mesh pod", ["--arch", "qwen2-moe-a2.7b", "--mesh",
                                  "pod", "--requests", "2", "--layers", "4"]),
)


def serve_cli_phase(card: str) -> None:
    """Phase 23: ``python -m repro_torch.launch.serve`` on the card, at full
    width with random weights: flux-12b at degree 1 (16 of its 96 layers)
    and on the paper's mesh (pod 2, model 8) at 8 (``--layers``),
    rwkv6-1.6b, and at 4 layers each qwen2-1.5b, hymba-1.5b and
    qwen2-moe-a2.7b at degree 1 and with the KV cache sharded over (pod 2,
    model 8) (the experts over model 8); each run prints its requests,
    the DiT runs their scheduler line, and every run its captured
    graphs.  The runs go SERVE_CLI_AT_ONCE at a time: each is mostly its
    process's start, and no gate reads a wall time."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            capture_output=True, text=True, timeout=600, env=env)
        return proc, time.perf_counter() - t0

    import torch
    held = torch.cuda.memory_reserved(0)
    with DeviceMemory() as mem, concurrent.futures.ThreadPoolExecutor(
            SERVE_CLI_AT_ONCE) as pool:
        runs = list(pool.map(run, [argv for _, argv in SERVE_CLI]))
    log(f"serve-cli: device memory in use at most {mem.peak / 2**30:.2f} "
        f"GiB with {SERVE_CLI_AT_ONCE} runs at once, this process's allocator "
        f"reserving {held / 2**30:.2f} GiB of it [{card}]")
    for (label, _), (proc, seconds) in zip(SERVE_CLI, runs):
        lines = proc.stdout.splitlines()
        for line in lines:
            log(f"serve-cli {label}: {line}")
        dit = label.startswith("flux")
        ok = (proc.returncode == 0
              and any(x.startswith("request 0:") for x in lines)
              and any(x.startswith("graphs:") and " captured," in x
                      for x in lines)
              and (not dit or any(x.startswith("scheduler:") for x in lines)))
        log(f"serve-cli {label}: rc {proc.returncode}, {seconds:.1f} s "
            f"({SERVE_CLI_AT_ONCE} runs at once) [{card}]")
        if not ok:
            fail(f"serve-cli {label}: rc {proc.returncode}: "
                 f"{proc.stderr[-1500:]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: numbers
# ---------------------------------------------------------------------------

def attention_bound(bh, lq, lk, nbytes, d=128) -> tuple[float, str, float]:
    """(bound ms, what bounds it, FLOP) of one attention call at head dim
    d: 4·BH·Lq·Lk·D operations at the bf16 peak against ``nbytes`` at the
    HBM rate."""
    flops = 4.0 * bh * lq * lk * d
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def rate_line(ms, bound_ms, flops) -> str:
    return (f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f} % of the bound)")


def k1_numbers(card: str) -> dict:
    """K1 at the flux shapes of degree 1 (one input set: each call is far
    longer than a pass over the L2) and at the ring shapes of the SP path
    (ROTATE input sets in turn, so the data comes from HBM)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_mqkv as fm

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for bh, l in FLUX_SHAPES:
        q, k, v = k1_inputs(gen, bh, bh, l, l, 128, torch.bfloat16)
        pos = torch.arange(l, dtype=torch.int32, device="cuda")
        ms = cuda_ms(lambda: fm.flash_mqkv(q, k, v, pos, pos), reps=20)
        plain_ms = cuda_ms(lambda: fm.flash_mqkv_plain(q, k, v, pos, pos),
                           reps=3, warmup=1)
        b = bh // 24
        q4, k4, v4 = (t.view(b, 24, l, 128) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                         reps=20)
        # q, k, v read once, o written once
        bound_ms, bound_by, flops = attention_bound(bh, l, l,
                                                    4.0 * bh * l * 128 * 2)
        rows[(bh, l)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        plan = fm.tile_plan(bh, l, l, 128)
        log(f"k1 time BH={bh} L={l} D=128 bf16 (BQ {plan.bq}): "
            f"{rate_line(ms, bound_ms, flops)}, bound {bound_ms:.4f} ms "
            f"({bound_by}), plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s) [{card}]")
        del q, k, v
    for label, bh, lq, lk in SP_K1_SHAPES:
        sets = [k2_inputs(gen, bh, lq, lk, torch.bfloat16)
                for _ in range(ROTATE)]
        ms = cuda_ms(rotating([
            lambda q=q, k=k, v=v, qp=qp, kp=kp: fm.flash_mqkv(
                q, k, v, qp, kp, finalize=False)
            for q, k, v, qp, kp in sets]), reps=50)
        lib_ms = cuda_ms(rotating([
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.view(2, 3, lq, 128), k.view(2, 3, lk, 128),
                v.view(2, 3, lk, 128))
            for q, k, v, *_ in sets]), reps=50)
        # q, k, v read (bf16), o' (f32), l and m written
        bound_ms, bound_by, flops = attention_bound(
            bh, lq, lk, 2 * bh * (lq + 2 * lk) * 128 + 4 * bh * lq * 130)
        rows[label] = dict(ms=ms, library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        plan = fm.tile_plan(bh, lq, lk, 128)
        log(f"k1 time {label} BH={bh} Lq={lq} Lk={lk} bf16 unfinalized "
            f"(BQ {plan.bq}), {ROTATE} input sets in turn: "
            f"{rate_line(ms, bound_ms, flops)}, bound {bound_ms:.4f} ms "
            f"({bound_by}), sdpa {lib_ms:.4f} ms [{card}]")
        del sets
    torch.cuda.empty_cache()
    return rows


def k2_numbers(card: str) -> dict:
    """K2 at the main ring shape of the serve-sp path (Pull-KV, 4096
    bucket, first ring step: no carried state, unfinalized)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ring_flash as rf

    label, bh, lq, lk = next(c for c in K2_SHAPES if c[0] == K2_MAIN)
    gen = torch.Generator(device="cuda").manual_seed(6)
    sets = []
    for _ in range(ROTATE):
        q, k, v, qp, kp = k2_inputs(gen, bh, lq, lk, torch.bfloat16)
        sets.append((q, k, v, qp, kp, torch.empty_like(k), torch.empty_like(v)))
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    arrive = torch.zeros_like(flag)
    ms, host = time_call(rotating([
        lambda q=q, k=k, v=v, qp=qp, kp=kp, kd=kd, vd=vd: rf.ring_flash_step(
            q, k, v, qp, kp, k_dst=kd, v_dst=vd, flag=flag, arrive=arrive,
            epoch=1, finalize=False)
        for q, k, v, qp, kp, kd, vd in sets]), reps=50)
    plain_ms = cuda_ms(rotating([
        lambda q=q, k=k, v=v, qp=qp, kp=kp, kd=kd, vd=vd:
        rf.ring_flash_step_plain(q, k, v, qp, kp, k_dst=kd, v_dst=vd,
                                 finalize=False, scale=128 ** -0.5)
        for q, k, v, qp, kp, kd, vd in sets]), reps=5, warmup=1)
    # SDPA on the same chunk: B 2 x 3 heads
    lib_ms = cuda_ms(rotating([
        lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q.view(2, 3, lq, 128), k.view(2, 3, lk, 128),
            v.view(2, 3, lk, 128))
        for q, k, v, *_ in sets]), reps=50)
    nbytes = (2 * bh * (lq + 2 * lk) * 128  # q, k, v read once (bf16)
              + 4 * bh * lq * 128 + 8 * bh * lq  # o' (f32), l, m written
              + 2 * 2 * bh * lk * 128)  # forwarded k and v written
    bound_ms, bound_by, flops = attention_bound(bh, lq, lk, nbytes)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"k2 time {label} BH={bh} Lq={lq} Lk={lk} bf16, {ROTATE} input sets "
        f"in turn: {rate_line(ms, bound_ms, flops)} on the device "
        f"({host:.4f} ms of host time per call), bound {bound_ms:.4f} ms "
        f"({bound_by}), plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms "
        f"[{card}]")
    return row


def put_numbers(card: str) -> dict:
    """K3 and K4 on the largest torus put of the serve-sp path, Pull-KV of
    the 4096 bucket (K and V of 16 ranks), and on the same put of the 1024
    bucket, each beside its plain version and one copy_ of the same bytes.
    Each timed call copies one of at least ROTATE input sets that together
    touch four times the L2, so source and destination come from HBM.
    Returns the kernels line's rows, at the serve shape."""
    import torch
    from repro_torch.comm import kernel_backend as kb

    gen = torch.Generator(device="cuda").manual_seed(7)
    perm = [(r + 1) % RANKS for r in range(RANKS)]
    signal, arrive = put_words(2 * RANKS)
    rows = {}
    for shape in (SERVE_PUT_SHAPE, SMALL_PUT_SHAPE):
        nbytes = 2 * RANKS * 2 * math.prod(shape)
        # as many sets as touch four times the L2 (ROTATE at the serve shape)
        n_sets = max(ROTATE, -(-4 * L2_BYTES // (2 * nbytes)))
        sets = []
        for _ in range(n_sets):
            src = [[torch.randn(shape, generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)]
                   for _ in range(RANKS)]
            dst = [[torch.empty_like(t) for t in r] for r in src]
            flat = torch.cat([t.reshape(-1) for r in src for t in r])
            sets.append((src, dst, flat, torch.empty_like(flat)))
        lib_ms = cuda_ms(rotating([lambda a=a, b=b: b.copy_(a)
                                   for _, _, a, b in sets]), reps=50)
        bound_ms = 2 * nbytes / HBM_BPS * 1e3
        put = f"16 ranks x 2 x {shape} bf16 ({nbytes / 2**20:.2f} MiB)"
        log(f"copy_ of {put}, {n_sets} sets in turn: {lib_ms:.4f} ms "
            f"({2 * nbytes / (lib_ms * 1e-3) / 1e9:.0f} GB/s read + "
            f"written), {lib_ms / bound_ms:.3f} x the byte bound "
            f"{bound_ms:.4f} ms"
            f"{'' if lib_ms >= bound_ms else ' (BELOW the bound: cached?)'} "
            f"[{card}]")
        for name in ("remote_put", "landing_copy"):
            if name == "remote_put":
                fn = [lambda s=s_, d=d_: kb.remote_put(
                    s, d, perm, signal=signal, arrive=arrive, epoch=1)
                    for s_, d_, *_ in sets]
                plain = [lambda s=s_, d=d_: kb.remote_put_plain(
                    s, d, perm, signal, 1) for s_, d_, *_ in sets]
            else:
                fn = [lambda s=s_, d=d_: kb.landing_copy(
                    s, d, signal=signal, arrive=arrive, epoch=1)
                    for s_, d_, *_ in sets]
                plain = [lambda s=s_, d=d_: kb.landing_copy_plain(
                    s, d, signal, 1) for s_, d_, *_ in sets]
            ms, host = time_call(rotating(fn), reps=50)
            plain_ms = cuda_ms(rotating(plain), reps=20)
            if shape == SERVE_PUT_SHAPE:
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound_ms, bound_by="bytes")
            log(f"{name} time {put}, {n_sets} sets in turn: {ms:.4f} ms on "
                f"the device ({2 * nbytes / (ms * 1e-3) / 1e9:.0f} GB/s read "
                f"+ written, {bound_ms / ms:.3f} of the bound, "
                f"{ms / lib_ms:.2f} x one copy_; {host:.4f} ms of host time "
                f"per call), bound {bound_ms:.4f} ms (bytes), plain "
                f"{plain_ms:.4f} ms, one copy_ {lib_ms:.4f} ms [{card}]")
        del sets
    return rows


def layer_breakdown(card: str, arch: str = "flux-12b", b: int = 2,
                    l: int = 4352) -> None:
    """Where one layer's time goes (bf16, B ``b``, L ``l``; by default the
    serve shape): one block of ``arch`` at degree 1 and under swift_torus
    on mesh (pod 2, model 8), eagerly and captured as a CUDA graph, each
    traced once by torch.profiler after a warm-up.  Prints the host wall clock, the device's busy time (the sum
    of kernel times) and its idle share, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models.blocks import ParallelContext
    from repro_torch.models.dit import dit_block, init_dit
    from repro_torch.serving.graphs import CapturedStep

    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = init_dit(cfg, gen, device="cuda")
    perturb_zero_init(params, gen)
    lp = params["layers"][0]
    x = torch.randn((b, l, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t_emb = torch.randn((b, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    shape, axes, sp_axes, _ = SP_MESHES["pod2xmodel8"]
    sp_ctx = ParallelContext(sp_config(sp_axes),
                             mesh=make_mesh(shape, axes, device="cuda"))
    block = lambda ctx: (lambda: dit_block(lp, cfg, ctx, x, t_emb, pos))
    captured = CapturedStep(block(sp_ctx), "cuda", name="sp layer")
    for label, fn in (
            ("degree 1", block(ParallelContext(SPConfig(strategy="full"),
                                               device=torch.device("cuda")))),
            ("swift_torus pod2xmodel8", block(sp_ctx)),
            ("swift_torus pod2xmodel8 captured", captured)):
        with torch.inference_mode():
            fn()  # warm-up (the captured layer: its eager warm-up, then
            fn()  # its capture and first replay)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            untraced = (time.perf_counter() - t0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            span = ev[0].elapsed_time(ev[1])
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        # kernel events only (an aten op also reports its kernels' time)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        if fn is captured:
            log(f"breakdown {label}: capture {captured.capture_s:.3f} s, "
                f"instantiation {captured.instantiate_s:.3f} s (host), "
                f"launches per replay {captured.launches}; CUDA events "
                f"around one replay {span:.2f} ms [{card}]")
        if busy == 0.0:
            log(f"breakdown {label} {arch} L {l}: wall {untraced:.1f} ms; the "
                "profiler saw no device time (device busy share not "
                "measured)")
            continue
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log(f"breakdown {label} (one {arch} layer, bf16, B {b}, L {l}): wall "
            f"{untraced:.1f} ms untraced, {wall:.1f} ms traced; device busy "
            f"{busy:.2f} ms, idle share {1 - busy / untraced:.3f} of the "
            f"untraced wall; top kernels: "
            + "; ".join(f"{e.key[:60]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.2f} ms"
                        for e in top) + f" [{card}]")
    del captured
    del params
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# phases 10 to 13: K5 and the rwkv6 language model
# ---------------------------------------------------------------------------

def wkv_module():
    """kernels/rwkv6_wkv.py (the package exports its function under the
    module's name)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.rwkv6_wkv")


def rwkv_decays(gen, shape, device):
    """w = exp(-exp(w0)) with w0 ~ U[-6, -1], RWKV6's decay initialisation
    range (Finch, arXiv 2404.05892): w in [0.69, 0.998].  The reference's
    chunk form underflows (ROADMAP F3) only below a mean decay of ~0.25
    over a chunk of 64, far outside this range."""
    import torch
    w0 = torch.rand(shape, generator=gen, device=device) * 5.0 - 6.0
    return torch.exp(-torch.exp(w0))


def wkv_work(b, l, h, n, c, itemsizes):
    """(FLOPs, bytes) of one WKV call on [B, L, H, N] at chunk c: per
    chunk and row, the strictly lower att = (r·D₋)(k/D)^T and att·v
    (2 · c(c-1)/2 · N each), the bonus diagonal and its product (5 c N),
    (r·D₋)·S and the state's increment (2 · 2 c N²), S's decay (2 N²) and
    the scalings of r, k and the cumulative sum (3 c N).  Bytes: r, k, v,
    w read once in their own types (``itemsizes``), u, and o (float32)
    written once."""
    per_chunk = (2 * 2 * c * (c - 1) // 2 * n + 5 * c * n
                 + 2 * 2 * c * n * n + 2 * n * n + 3 * c * n)
    flops = float(per_chunk) * (l // c) * b * h
    nbytes = (float(b * l * h * n) * (sum(itemsizes[:4]) + 4)
              + h * n * itemsizes[4])
    return flops, nbytes


def check_k5(results: dict) -> None:
    import torch
    from repro_torch.kernels.ref import rwkv6_wkv_ref
    wkv = wkv_module()

    gen = torch.Generator(device="cuda").manual_seed(12)

    def judge(label, got, ref):
        e = (rel_err(got, ref, floor=0.0), norm_err(got, ref))
        if not (e[0] <= WKV_TOL[0] and e[1] <= WKV_TOL[1]):
            fail(f"K5 {label}: max|d|/max|ref| {e[0]}, |d|/|ref| {e[1]} "
                 f"(limits {WKV_TOL})")
        return e

    for name, dts in WKV_DTYPES.items():
        worst = (0.0, 0.0)
        for l, n, chunk in WKV_SWEEP:
            shape = (3, l, n)
            mk = lambda: torch.randn(shape, generator=gen, device="cuda")
            # the reference test's decays, sigmoid(N(0, 1)) / 2 + 1/2
            raw = (mk(), mk(), mk(), torch.sigmoid(mk()) * 0.5 + 0.5,
                   torch.randn((3, n), generator=gen, device="cuda") * 0.1)
            args = [t.to(getattr(torch, dt)) for t, dt in zip(raw, dts)]
            got = wkv.rwkv6_wkv(*args, chunk=chunk)
            ref = rwkv6_wkv_ref(*args, chunk=chunk)
            torch.cuda.synchronize()
            e = judge(f"{name} sweep {(l, n, chunk)}", got, ref)
            worst = tuple(max(a, b) for a, b in zip(worst, e))
        log(f"k5 {name}: {len(WKV_SWEEP)} sweep shapes, worst max|d|/max|ref| "
            f"{worst[0]:.2e}, |d|/|ref| {worst[1]:.2e} (limits {WKV_TOL})")
    # the model's shapes: r, k, v, u bf16 and w f32, [B, L, H, N] read in
    # place through their strides, the decays of RWKV6's range; on an H100
    # (132 SMs) their 128, 32 and 64 rows make the wrapper split each row's
    # value columns over 1, 4 and 2 blocks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = set()
    for b, l in LM_PREFILL + ((2, 256),):
        h, n = 32, 64
        mk = lambda: torch.randn((b, l, h, n), generator=gen,
                                 device="cuda").to(torch.bfloat16)
        r, k, v = mk(), mk(), mk()
        w = rwkv_decays(gen, (b, l, h, n), "cuda")
        u = (torch.randn((h, n), generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16)
        got = wkv.rwkv6_wkv_heads(r, k, v, w, u)
        ref = wkv.rwkv6_wkv_heads_plain(r, k, v, w, u)
        torch.cuda.synchronize()
        e = judge(f"model shape B={b} L={l}", got, ref)
        err = float((got - ref).abs().max())
        results.setdefault("k5_err", {})[(b, l)] = err
        split = wkv.value_split(b * h, n, sms)
        splits.add(split)
        log(f"k5 model shape B={b} L={l} H={h} N={n} chunk 64, split {split} "
            f"(bf16 r/k/v/u, "
            f"f32 w in [{float(w.min()):.3f}, {float(w.max()):.4f}]): max|d| "
            f"{err:.3e} at max|ref| {float(ref.abs().max()):.2f}; "
            f"max|d|/max|ref| {e[0]:.2e}, |d|/|ref| {e[1]:.2e}")
        del r, k, v, w, got, ref
    torch.cuda.empty_cache()
    if sms >= 128 and splits != set(wkv.SPLITS):
        fail(f"K5 model shapes covered the value-column splits {splits}, "
             f"not {wkv.SPLITS}")


def perturb_rwkv(params, gen) -> None:
    """Draw the rwkv6 tensors that init_lm leaves at zero (in place), from
    ranges RWKV6 itself initialises them in: the decay base w0 from
    U[-6, -1] (see rwkv_decays; the LoRA term stays ~0.01, so w stays in
    about [0.68, 0.998]), every token-shift mix mu_* from U[0, 1], the
    bonus u from N(0, 0.5^2), wlora_b small.  At init w = 1/e everywhere,
    the bonus adds nothing and the token shift is unused."""
    import torch
    for lp in params["layers"]:
        tm, cm = lp["tm"], lp["cm"]
        like = lambda t, x: x.to(device=t.device, dtype=t.dtype)
        rand = lambda t: torch.rand(t.shape, generator=gen, device=t.device)
        tm["w0"] = like(tm["w0"], rand(tm["w0"]) * 5.0 - 6.0)
        for mix in (tm, cm):
            for name in [k for k in mix if k.startswith("mu_")]:
                mix[name] = like(mix[name], rand(mix[name]))
        tm["u"] = like(tm["u"], torch.randn(tm["u"].shape, generator=gen,
                                            device=tm["u"].device) * 0.5)
        wb = tm["wlora_b"]["w"]  # [lora, d]
        tm["wlora_b"]["w"] = like(wb, torch.randn(
            wb.shape, generator=gen, device=wb.device) * (0.01 / wb.shape[0] ** 0.5))


def check_lm_block() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.models import ParallelContext, init_lm
    from repro_torch.models import lm as lm_mod
    wkv = wkv_module()

    # one layer; the vocab is cut because the block needs no embedding
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=1,
                              dtype="float32", vocab=256)
    gen = torch.Generator().manual_seed(11)
    params = init_lm(cfg, gen, device="cpu")
    perturb_rwkv(params, gen)
    lp = params["layers"][0]
    x = torch.randn((1, 1024, cfg.d_model), generator=gen)
    sp = SPConfig(strategy="full")
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = lm_mod._layer(x, lp, cfg, ParallelContext(sp, device=torch.device("cpu")),
                            None)[0]
    t_cpu = time.perf_counter() - t0
    dev = torch.device("cuda")
    before = wkv.launch_count()
    with torch.inference_mode():
        out = lm_mod._layer(x.to(dev), _cast(lp, device=dev), cfg,
                            ParallelContext(sp, device=dev), None)[0]
    torch.cuda.synchronize()
    launches = wkv.launch_count() - before
    e = float((out.cpu() - ref).abs().max()) / float(ref.abs().max())
    h = cfg.ssm.n_ssm_heads
    log(f"lm-block rwkv6-1.6b d={cfg.d_model} H={h} N={cfg.d_model // h} "
        f"d_ff={cfg.d_ff} L=1024 "
        f"fp32: card vs CPU max|d|/max|ref| = {e:.3e} (tol {LM_BLOCK_TOL}), K5 "
        f"launches {launches}, max|layer-x| {float((ref - x).abs().max()):.3f}, "
        f"CPU layer {t_cpu:.2f} s")
    if launches != 1 or not e <= LM_BLOCK_TOL:
        fail(f"lm-block: err {e} launches {launches}")


def lm_prefill(results: dict, card: str):
    """Returns the bfloat16 model (params, cfg) for serve-lm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.models import ParallelContext, get_model, init_lm
    from repro_torch.models import lm as lm_mod
    wkv = wkv_module()

    cfg = get_config("rwkv6-1.6b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device=dev)
    perturb_rwkv(params, gen)
    torch.cuda.synchronize()
    log(f"lm-prefill: rwkv6-1.6b {cfg.n_layers} layers d={cfg.d_model} bf16, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    bundle = get_model(cfg)
    ctx = ParallelContext(SPConfig(strategy="full"), "prefill", dev)
    prompts = {bl: torch.randint(0, cfg.vocab, bl, generator=gen, device=dev)
               for bl in LM_PREFILL}

    def forward(bl):
        with torch.inference_mode():
            return bundle.apply(params, {"tokens": prompts[bl]}, cfg, ctx,
                                last_only=True)

    for bl in LM_PREFILL:  # warm-up (cuBLAS handles, library load)
        forward(bl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wkv.reset_launch_count()
    times = {}
    for bl in LM_PREFILL:
        t0 = time.perf_counter()
        logits = forward(bl)
        torch.cuda.synchronize()
        times[bl] = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        log(f"lm-prefill B={bl[0]} L={bl[1]}: logits {tuple(logits.shape)} "
            f"finite={finite}, {times[bl] * 1e3:.1f} ms [{card}]")
        if tuple(logits.shape) != (bl[0], 1, cfg.vocab) or not finite:
            fail(f"lm-prefill {bl}: bad logits")
    launches = wkv.launch_count()
    other = read_counts()
    want = cfg.n_layers * len(LM_PREFILL)
    log(f"lm-prefill: K5 launches {launches} (expected {cfg.n_layers} layers x "
        f"{len(LM_PREFILL)} forwards = {want}), other kernels {other}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if launches != want or any(other.values()):
        fail(f"lm-prefill launches: K5 {launches} (want {want}), {other}")
    results["lm_launches"] = launches
    results["lm_prefill_s"] = times

    # float32 at B 2, L 256: prefill through K5 against teacher-forced
    # decode (rwkv6_decode_step, no kernel), layer by layer — each layer's
    # prefill output against the same layer decoded token by token from the
    # same input — and end to end on the logits, which is reported only:
    # 24 random layers amplify float32 rounding ~1e5-fold (see LM_TOL)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _cast(params, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (2, 256), generator=gen, device=dev)
    real_layer, real_wkv = lm_mod._layer, lm_mod.rwkv6_wkv_heads
    seen = []

    def capture(x, lp, cfg_, ctx_, cache):
        y, nc = real_layer(x, lp, cfg_, ctx_, cache)
        seen.append((x, y))
        return y, nc

    def split(r, k, v, w, u, **kw):
        """K5 on each half of the sequence: the second half starts from
        S = 0 instead of the state the first half carried."""
        h = r.shape[1] // 2
        return torch.cat([real_wkv(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, **kw),
                          real_wkv(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, **kw)],
                         dim=1)

    dctx = ParallelContext(SPConfig(strategy="full"), "decode", dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        lm_mod._layer = capture
        try:
            full = bundle.apply(p32, {"tokens": tokens}, cfg32, ctx)
        finally:
            lm_mod._layer = real_layer
        errs, cut_errs = [], []
        for (x, y), lp in zip(seen, p32["layers"]):
            cache = {k: c[0] for k, c in bundle.init_caches(
                dataclasses.replace(cfg32, n_layers=1), 2, 256, torch.float32,
                dev).items()}
            dec = []
            for t in range(256):
                out, cache = real_layer(x[:, t:t + 1], lp, cfg32, dctx, cache)
                dec.append(out)
            dec = torch.cat(dec, dim=1)
            errs.append(float((y - dec).abs().max()))
            lm_mod.rwkv6_wkv_heads = split
            try:
                cut = real_layer(x, lp, cfg32, ctx, None)[0]
            finally:
                lm_mod.rwkv6_wkv_heads = real_wkv
            cut_errs.append(float((cut - dec).abs().max()))
        caches = bundle.init_caches(cfg32, 2, 256, torch.float32, dev)
        steps = []
        for t in range(256):
            logit, caches = bundle.step(p32, {"tokens": tokens[:, t:t + 1]},
                                        caches, t, cfg32, dctx)
            steps.append(logit)
        logits_err = float((full - torch.stack(steps, dim=1)).abs().max())
    torch.cuda.synchronize()
    err, cut_err = max(errs), min(cut_errs)
    log(f"lm-prefill fp32 B=2 L=256, per layer: prefill (K5) vs teacher-forced "
        f"decode max|d| {err:.3e} (tol {LM_TOL}; by layer "
        f"{[float(f'{e:.2e}') for e in errs]}) at max|layer out| "
        f"{max(float(y.abs().max()) for _, y in seen):.2f}; negative control "
        f"(state dropped at L/2) min over layers {cut_err:.3e} (must exceed "
        f"{10 * LM_TOL}); end to end, logits max|d| {logits_err:.3e} at "
        f"max|logit| {float(full.abs().max()):.2f} (reported, not held: depth "
        f"amplifies rounding); {time.perf_counter() - t0:.1f} s")
    results["lm_decode_err"] = err
    if not err <= LM_TOL:
        fail(f"lm-prefill: prefill vs decode {err} > {LM_TOL}")
    if not cut_err > 10 * LM_TOL:
        fail(f"a dropped WKV state passes the lm-prefill check ({cut_err})")
    del p32, full, seen, steps, caches
    torch.cuda.empty_cache()
    return params, cfg


def run_ar_server(params, cfg, capture, cache_dtype, seed: int):
    """ARServer on the card with 4 slots and max_len 128, serving
    LM_REQUESTS (prompts drawn from ``seed``) of LM_NEW_TOKENS each:
    (server, results, wall seconds, each tick's seconds)."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.serving import ARRequest, ARServer, RecordingTracker

    gen = torch.Generator().manual_seed(seed)
    srv = ARServer(params, cfg, SPConfig(strategy="full"), batch_slots=4,
                   max_len=128, cache_dtype=cache_dtype,
                   tracker=RecordingTracker(), device="cuda", capture=capture)
    for rid, n, prio in LM_REQUESTS:
        srv.submit(ARRequest(rid=rid, prompt=torch.randint(
            0, cfg.vocab, (n,), generator=gen),
            max_new_tokens=LM_NEW_TOKENS, priority=prio))
    ticks = []  # each tick ends in a host read of its tokens
    t0 = time.perf_counter()
    while srv.queue or any(s.req for s in srv.slots):
        t1 = time.perf_counter()
        srv.tick()
        ticks.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    return srv, dict(srv.results), time.perf_counter() - t0, ticks


def serve_lm(results: dict, card: str, params, cfg) -> None:
    """ARServer on the bfloat16 model, its tick captured as a CUDA graph,
    then (phase 22, AR part) the same requests with capture=False: the
    same tokens, and each tick's wall clock captured against eager."""
    import torch
    wkv = wkv_module()
    run = lambda capture: run_ar_server(params, cfg, capture, torch.float32,
                                        seed=13)
    before = wkv.launch_count()
    srv, out, wall, ticks = run(None)
    tr = srv.tracker
    counts = {n: tr.counter_total(f"ar.{n}")
              for n in ("submitted", "admitted", "ticks", "completed")}
    waits = {tags["rid"]: st.mean
             for tags, st in tr.series_items("ar.queue_wait_ticks")}
    lens = {rid: len(v) for rid, v in sorted(out.items())}
    log(f"serve-lm: {len(out)} requests, {counts['ticks']:.0f} ticks in "
        f"{wall:.2f} s ({wall / max(counts['ticks'], 1) * 1e3:.1f} ms per "
        f"tick of 4 slots), tokens per request {lens}, queue waits (ticks) "
        f"{waits}, counters {counts}, K5 launches {wkv.launch_count() - before}"
        f" [{card}]")
    n = len(LM_REQUESTS)
    ok = (sorted(out) == [r for r, *_ in LM_REQUESTS]
          and all(v == LM_NEW_TOKENS for v in lens.values())
          and all(0 <= t < cfg.vocab for v in out.values() for t in v)
          and counts["submitted"] == counts["admitted"] == counts["completed"] == n
          and counts["ticks"] == srv._ticks and len(waits) == n)
    if not ok:
        fail(f"serve-lm: results {out}, counters {counts}, waits {waits}")
    step = srv._step
    log(f"serve-lm graph: captured at tick {step.calls - step.replays} "
        f"(the caches' dtypes settle over the first ticks), capture "
        f"{step.capture_s:.3f} s, instantiation {step.instantiate_s:.3f} s "
        f"(host), {step.replays} replays [{card}]")
    replayed = ticks[len(ticks) - step.replays + 1:]  # after the capture
    del srv, step
    _, eager, ewall, eticks = run(False)
    same = eager == out
    log(f"capture serve-lm: captured tokens equal the eager server's {same}; "
        f"tick wall clock median {median(replayed) * 1e3:.2f} ms captured "
        f"(replays) vs {median(eticks) * 1e3:.2f} ms eager; {wall:.2f} s vs "
        f"{ewall:.2f} s in all [{card}]")
    if not same:
        fail("capture serve-lm: captured tokens differ from eager")
    results["serve_lm"] = (wall, counts["ticks"])
    results["capture_lm"] = (median(replayed), median(eticks))


def k5_numbers(card: str, results: dict) -> dict:
    """K5 at the main path's two prefill calls, B 4 x L 4096 (BH 128) and
    B 1 x L 1024 (BH 32) (N 64, chunk 64; r, k, v, u bf16, w f32), each
    timed call on one of at least WKV_SETS input sets that together touch
    4x the L2 or more, so the inputs come from HBM.  The bound is the
    larger of the bytes and the operations at the TF32 tensor-core rate
    (the products run there); the operations at the CUDA-core float32 rate
    are printed beside them.  Returns the B 4 x L 4096 row."""
    import torch
    wkv = wkv_module()

    h, n = 32, 64
    gen = torch.Generator(device="cuda").manual_seed(14)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for b, l in LM_PREFILL:
        flops, nbytes = wkv_work(b, l, h, n, 64, (2, 2, 2, 4, 2))
        sets = []
        for _ in range(max(WKV_SETS, math.ceil(4 * L2_BYTES / nbytes))):
            mk = lambda: torch.randn((b, l, h, n), generator=gen,
                                     device="cuda").to(torch.bfloat16)
            sets.append((mk(), mk(), mk(),
                         rwkv_decays(gen, (b, l, h, n), "cuda"),
                         (torch.randn((h, n), generator=gen, device="cuda")
                          * 0.5).to(torch.bfloat16)))
        ms, host = time_call(rotating([lambda a=a: wkv.rwkv6_wkv_heads(*a)
                                       for a in sets]), reps=20)
        plain_ms = cuda_ms(rotating([lambda a=a: wkv.rwkv6_wkv_heads_plain(*a)
                                     for a in sets]), reps=3, warmup=1)
        t_f32, t_tf32, t_bytes = (flops / PEAK_F32, flops / PEAK_TF32,
                                  nbytes / HBM_BPS)
        bound = max(t_tf32, t_bytes)
        rows[(b, l)] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                            bound_ms=bound * 1e3,
                            bound_by="operations" if t_tf32 >= t_bytes
                            else "bytes")
        log(f"k5 time B={b} L={l} H={h} N={n} chunk 64 (bf16 r/k/v/u, f32 w; "
            f"split {wkv.value_split(b * h, n, sms)} on {sms} SMs), "
            f"{len(sets)} input sets in turn: {ms:.4f} ms on the device "
            f"({flops / ms / 1e9:.2f} TFLOP/s, {nbytes / (ms * 1e-3) / 1e9:.0f}"
            f" GB/s; {host:.4f} ms of host time per call); bound "
            f"{bound * 1e3:.4f} ms ({rows[(b, l)]['bound_by']}), "
            f"{bound / (ms * 1e-3):.2f} of it reached; terms: "
            f"{flops / 1e9:.2f} GFLOP -> {t_f32 * 1e3:.4f} ms at 67 TFLOP/s "
            f"on the CUDA cores, {t_tf32 * 1e3:.4f} ms at 495 TFLOP/s TF32 "
            f"(at most {3 * t_tf32 * 1e3:.4f} ms as 3xTF32), {nbytes / 1e6:.0f} MB -> "
            f"{t_bytes * 1e3:.4f} ms at 3.35 TB/s; plain {plain_ms:.3f} ms; no "
            f"PyTorch call computes the WKV scan [{card}]")
        del sets
        torch.cuda.empty_cache()
    steps = ", ".join(f"B {bl[0]} x L {bl[1]} {t * 1e3:.1f} ms"
                      for bl, t in results["lm_prefill_s"].items())
    log(f"k5: rwkv6-1.6b prefill wall clock: {steps} [{card}]")
    return rows[LM_PREFILL[0]]


def lm_breakdown(card: str, params, cfg) -> None:
    """Where one rwkv6-1.6b prefill's time goes (bf16, B 4, L 4096, last
    position only): traced once by torch.profiler after a warm-up; the
    host wall clock, the device's busy time and idle share, K5's share and
    the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import SPConfig
    from repro_torch.models import ParallelContext, get_model

    dev = torch.device("cuda")
    bundle = get_model(cfg)
    ctx = ParallelContext(SPConfig(strategy="full"), "prefill", dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    tokens = torch.randint(0, cfg.vocab, (4, 4096), generator=gen, device=dev)
    fwd = lambda: bundle.apply(params, {"tokens": tokens}, cfg, ctx,
                               last_only=True)
    with torch.inference_mode():
        fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        log(f"lm breakdown: wall {untraced:.1f} ms; the profiler saw no device "
            "time (device busy share not measured)")
        return
    wkv_ms = sum(e.self_device_time_total for e in kernels
                 if "wkv_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"lm breakdown (rwkv6-1.6b prefill, bf16, B 4, L 4096, last_only): "
        f"wall {untraced:.1f} ms untraced, {wall:.1f} ms traced; device busy "
        f"{busy:.2f} ms, idle share {1 - busy / untraced:.3f} of the untraced "
        f"wall; K5 {wkv_ms:.2f} ms ({wkv_ms / busy:.3f} of busy); top kernels: "
        + "; ".join(f"{e.key[:60]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.2f} ms" for e in top)
        + f" [{card}]")


# ---------------------------------------------------------------------------
# phases 24 to 27: the dense and vlm attention LMs
# ---------------------------------------------------------------------------

def perturb_dense(tree, gen) -> None:
    """Draw the tensors init_lm and init_whisper leave constant (in place,
    over a tree of dicts and lists): every linear bias and LayerNorm bias
    from N(0, 0.1^2), every norm scale from 1 + N(0, 0.1^2), so that QKV
    biases and norm affines take part."""
    import torch
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for name, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            perturb_dense(leaf, gen)
        elif name in ("b", "bias", "scale"):
            noise = torch.randn(leaf.shape, generator=gen,
                                device=leaf.device) * 0.1
            tree[name] = (noise + (name == "scale")).to(leaf.dtype)


def dense_positions(cfg, b: int, l: int, device):
    """[B, L] positions, or qwen2-vl's [3, B, L] (t, h, w of a 32-wide
    patch grid: the three components differ)."""
    import torch
    t = torch.arange(l, device=device)
    if cfg.rope == "mrope":
        return torch.stack([t, t // 32, t % 32])[:, None].expand(3, b, l)
    return t[None].expand(b, l)


def check_dense_blocks(results: dict) -> None:
    """Phase 24, dense-block: one full-width float32 layer of each dense
    and vlm config through K1 on the card against the same layer on the
    CPU through the plain path (L DENSE_BLOCK_L), within LM_BLOCK_TOL of
    max|out|; starcoder2-7b at L WINDOW_BLOCK_L, so that its window of 4096
    masks keys, against the same layer on the card with K1's plain
    version (float32, TF32 off: the CPU takes minutes there), and against
    the unwindowed layer, which must differ.  K1 launches once per
    layer (stablelm-3b's head dim 80 runs zero-padded to 128)."""
    import torch
    from repro_torch.configs import DENSE_ARCHS, get_config
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels import ops
    from repro_torch.models import ParallelContext, init_lm
    from repro_torch.models import lm as lm_mod

    dev = torch.device("cuda")
    sp = SPConfig(strategy="full")
    errs = {}
    for arch in DENSE_ARCHS:
        # one layer; the vocab is cut because the layer needs no embedding
        cfg = dataclasses.replace(get_config(arch), n_layers=1,
                                  dtype="float32", vocab=256)
        gen = torch.Generator().manual_seed(21)
        params = init_lm(cfg, gen, device="cpu")
        perturb_dense(params, gen)
        lp = params["layers"][0]
        l = WINDOW_BLOCK_L if cfg.window else DENSE_BLOCK_L
        x = torch.randn((1, l, cfg.d_model), generator=gen)
        layer = lambda x, lp, device, cfg=cfg: lm_mod._attention_layer(
            x, lp, cfg, ParallelContext(sp, device=torch.device(device)),
            dense_positions(cfg, 1, l, device), cfg.window, None, None)[0]
        lp_card, x_card = _cast(lp, device=dev), x.to(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            before = fm.launch_count()
            out = layer(x_card, lp_card, dev)
            torch.cuda.synchronize()
            launches = fm.launch_count() - before
            if cfg.window:
                oracle, where = "card plain", dev
                real = ops.flash_mqkv
                ops.flash_mqkv = fm.flash_mqkv_plain
                try:
                    ref = layer(x_card, lp_card, dev)
                finally:
                    ops.flash_mqkv = real
                wide = dataclasses.replace(cfg, window=None)
                unwindowed = lm_mod._attention_layer(
                    x_card, lp_card, wide, ParallelContext(sp, device=dev),
                    dense_positions(cfg, 1, l, dev), None, None, None)[0]
            else:
                oracle, where = "CPU", "cpu"
                ref = layer(x, lp, "cpu")
        ref = ref.to(dev)
        e = float((out - ref).abs().max()) / float(ref.abs().max())
        errs[arch] = e
        hd = cfg.resolved_head_dim
        extra = ""
        if cfg.window:
            w_err = float((unwindowed - ref).abs().max()) / float(
                ref.abs().max())
            extra = (f"; the unwindowed layer differs by {w_err:.3e} (must "
                     f"exceed {10 * LM_BLOCK_TOL})")
            if not w_err > 10 * LM_BLOCK_TOL:
                fail(f"dense-block {arch}: the window does not bite ({w_err})")
        log(f"dense-block {arch} d={cfg.d_model} H={cfg.n_heads}/"
            f"{cfg.n_kv_heads}x{hd} d_ff={cfg.d_ff} {cfg.act} {cfg.norm} "
            f"rope={cfg.rope} pct={cfg.rope_pct} window={cfg.window} L={l} "
            f"fp32: card vs {oracle} max|d|/max|ref| = {e:.3e} (tol "
            f"{LM_BLOCK_TOL}), K1 launches {launches} (kernel head dim "
            f"{fm.kernel_head_dim(hd)}), {time.perf_counter() - t0:.1f} s"
            + extra)
        if launches != 1 or not e <= LM_BLOCK_TOL:
            fail(f"dense-block {arch}: err {e} launches {launches}")
        del params, lp, lp_card, out, ref
        torch.cuda.empty_cache()
    results["dense_block_err"] = errs


def _traced_forward(fwd, label: str, card: str) -> dict:
    """One call of ``fwd`` (already warm) on the host clock, then one
    traced by torch.profiler: wall ms, device busy ms, the idle share and
    K1's device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        log(f"{label}: wall {wall:.1f} ms; the profiler saw no device time "
            f"(device busy share not measured) [{card}]")
        return dict(wall=wall, busy=None)
    k1 = sum(e.self_device_time_total for e in kernels
             if "flash_hopper_kernel" in e.key or "flash_f32_kernel" in e.key
             ) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"{label}: wall {wall:.1f} ms; device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall:.3f}; K1 {k1:.2f} ms ({k1 / busy:.3f} of busy); "
        "top kernels: " + "; ".join(
            f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
            for e in top) + f" [{card}]")
    return dict(wall=wall, busy=busy, k1=k1)


def dense_prefill(results: dict, card: str):
    """Phase 25, dense-prefill: qwen2-1.5b at full width and depth (28
    layers, bf16, weights from seed 0, biases and norms perturbed),
    last-position logits of B x L = DENSE_PREFILL, finite, K1 launched 28
    times per forward; the wall clock, device time and idle share of one
    forward.  Then SP prefill on DENSE_SP_MESH (swift over (pod, model),
    kernel route) at full width, DENSE_SP_LAYERS layers, float32, against
    degree 1 within DENSE_SP_TOL, with the K1/K2/K4 launches its plan
    implies.  Returns the bf16 model (params, cfg)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.core.strategy import resolve_layout
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, get_model, init_lm

    cfg = get_config("qwen2-1.5b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device=dev)
    perturb_dense(params, gen)
    torch.cuda.synchronize()
    log(f"dense-prefill: qwen2-1.5b {cfg.n_layers} layers d={cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads bf16, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    bundle = get_model(cfg)
    ctx = ParallelContext(SPConfig(strategy="full"), "prefill", dev)
    b, l = DENSE_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, l), generator=gen, device=dev)
    fwd = lambda: bundle.apply(params, {"tokens": tokens}, cfg, ctx,
                               last_only=True)
    with torch.inference_mode():
        fwd()  # warm-up (cuBLAS handles, library load)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits = fwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        finite = bool(torch.isfinite(logits).all())
        log(f"dense-prefill B={b} L={l}: logits {tuple(logits.shape)} "
            f"finite={finite}, {wall * 1e3:.1f} ms, launches {counts} "
            f"(expected K1 = {cfg.n_layers}) [{card}]")
        if (tuple(logits.shape) != (b, 1, cfg.vocab) or not finite
                or counts != {"flash_mqkv": cfg.n_layers, "ring_flash_step": 0,
                              "remote_put": 0, "landing_copy": 0}):
            fail(f"dense-prefill: logits {tuple(logits.shape)} finite "
                 f"{finite} launches {counts}")
        results["dense_prefill"] = dict(wall=wall, k1=counts["flash_mqkv"])
        results["dense_trace"] = _traced_forward(
            fwd, f"dense-prefill breakdown (qwen2-1.5b, bf16, B {b}, L {l}, "
            "last_only)", card)
        del logits

    # SP prefill at full width, float32, against degree 1
    cfg32 = dataclasses.replace(cfg, n_layers=DENSE_SP_LAYERS, dtype="float32")
    p32 = _cast({k: v for k, v in params.items() if k != "layers"},
                dtype=torch.float32)
    p32["layers"] = _cast(params["layers"][:DENSE_SP_LAYERS],
                          dtype=torch.float32)
    b, l = DENSE_SP_BL
    tokens = torch.randint(0, cfg.vocab, (b, l), generator=gen, device=dev)
    shape, axes = DENSE_SP_MESH
    sp = SPConfig(strategy="swift", sp_axes=("pod", "model"),
                  batch_axes=("data",), machine_axis="pod",
                  comm_backend="pallas", kernel_interpret=False)
    mesh = make_mesh(shape, axes, device=dev)
    lay = resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
    ranks = mesh.axes_size(("pod", "data", "model"))
    want = {"flash_mqkv": ranks * DENSE_SP_LAYERS,
            "ring_flash_step": ranks * (lay.p_ring - 1) * DENSE_SP_LAYERS,
            "remote_put": 0,
            "landing_copy": 4 * (lay.p_ulysses - 1) * DENSE_SP_LAYERS}
    with torch.inference_mode():
        one = bundle.apply(p32, {"tokens": tokens}, cfg32, ctx)
        reset_counts()
        t0 = time.perf_counter()
        got = bundle.apply(p32, {"tokens": tokens}, cfg32,
                           ParallelContext(sp, "prefill", mesh=mesh))
        torch.cuda.synchronize()
        t_sp = time.perf_counter() - t0
    counts = read_counts()
    e = float((got - one).abs().max()) / float(one.abs().max())
    log(f"dense-prefill SP: qwen2-1.5b {DENSE_SP_LAYERS} layers fp32 B={b} "
        f"L={l} on mesh {dict(zip(axes, shape))}, swift over (pod, model), "
        f"plan P_u {lay.p_ulysses} x P_r {lay.p_ring} (ulysses outer "
        f"{lay.ulysses_outer}); logits vs degree 1 max|d|/max|ref| = {e:.3e} "
        f"(tol {DENSE_SP_TOL}); launches {counts} (expected {want}); "
        f"{t_sp:.2f} s eager [{card}]")
    if not e <= DENSE_SP_TOL or counts != want:
        fail(f"dense-prefill SP: err {e}, launches {counts} (want {want})")
    results["dense_sp"] = dict(err=e, launches=counts)
    del p32, one, got
    torch.cuda.empty_cache()
    return params, cfg


def _teacher_forced(bundle, params, cfg, ctx, tokens, caches_len):
    """Decode logits [B, L, V] of ``tokens`` step by step."""
    import torch
    caches = bundle.init_caches(cfg, tokens.shape[0], caches_len,
                                torch.float32, ctx.device)
    steps = []
    for t in range(tokens.shape[1]):
        logit, caches = bundle.step(params, {"tokens": tokens[:, t:t + 1]},
                                    caches, t, cfg, ctx)
        steps.append(logit)
    return torch.stack(steps, dim=1)


def dense_decode(results: dict, card: str, params, cfg) -> None:
    """Phase 26, dense-decode: bundle.step (core/decode.py: the KV cache
    sharded on L over the SP ranks, plain torch) against bundle.apply (K1)
    on the same tokens, float32, TF32 off, within LM_TOL of max|logits|:
    qwen2-1.5b at full width, DENSE_DECODE_LAYERS layers, over
    DENSE_DECODE_POS positions at degree 1 and on mesh (pod 2, model 8);
    starcoder2-7b at full width, 2 layers, its last WINDOW_DECODE_POS
    positions past its window of 4096, where the unwindowed prefill must
    differ."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, get_model, init_lm

    dev = torch.device("cuda")
    bundle = get_model(cfg)
    pre = ParallelContext(SPConfig(strategy="full"), "prefill", dev)
    cfg32 = dataclasses.replace(cfg, n_layers=DENSE_DECODE_LAYERS,
                                dtype="float32")
    p32 = _cast({k: v for k, v in params.items() if k != "layers"},
                dtype=torch.float32)
    p32["layers"] = _cast(params["layers"][:DENSE_DECODE_LAYERS],
                          dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(22)
    tokens = torch.randint(0, cfg.vocab, (2, DENSE_DECODE_POS), generator=gen,
                           device=dev)
    sp16 = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                    batch_axes=None, machine_axis="pod")
    errs = {}
    with torch.inference_mode():
        full = bundle.apply(p32, {"tokens": tokens}, cfg32, pre)
        for label, ctx in (
                ("degree 1", ParallelContext(SPConfig(strategy="full"),
                                             "decode", dev)),
                ("mesh (pod 2, model 8)", ParallelContext(
                    sp16, "decode", mesh=make_mesh((2, 8), ("pod", "model"),
                                                   device=dev)))):
            t0 = time.perf_counter()
            dec = _teacher_forced(bundle, p32, cfg32, ctx, tokens,
                                  DENSE_DECODE_POS)
            torch.cuda.synchronize()
            e = float((dec - full).abs().max()) / float(full.abs().max())
            errs[label] = e
            log(f"dense-decode qwen2-1.5b {DENSE_DECODE_LAYERS} layers fp32 "
                f"B=2, {DENSE_DECODE_POS} positions, {label}: decode vs "
                f"prefill (K1) max|d|/max|logits| = {e:.3e} (tol {LM_TOL}) at "
                f"max|logit| {float(full.abs().max()):.2f}, "
                f"{time.perf_counter() - t0:.1f} s eager [{card}]")
            if not e <= LM_TOL:
                fail(f"dense-decode qwen2 {label}: {e} > {LM_TOL}")
        del full, dec, p32

        sc = dataclasses.replace(get_config("starcoder2-7b"), n_layers=2,
                                 dtype="float32")
        sparams = init_lm(sc, gen, device=dev)
        perturb_dense(sparams, gen)
        sb = get_model(sc)
        n = sc.window + WINDOW_DECODE_POS
        tokens = torch.randint(0, sc.vocab, (1, n), generator=gen, device=dev)
        t0 = time.perf_counter()
        dec = _teacher_forced(
            sb, sparams, sc, ParallelContext(SPConfig(strategy="full"),
                                             "decode", dev), tokens, n)
        tail = slice(sc.window, n)
        full = sb.apply(sparams, {"tokens": tokens}, sc, pre)[:, tail]
        wide = sb.apply(sparams, {"tokens": tokens},
                        dataclasses.replace(sc, window=None), pre)[:, tail]
        torch.cuda.synchronize()
        dec = dec[:, tail]
        e = float((dec - full).abs().max()) / float(full.abs().max())
        ctrl = float((dec - wide).abs().max()) / float(full.abs().max())
        log(f"dense-decode starcoder2-7b 2 layers fp32, window {sc.window}: "
            f"positions {sc.window}..{n - 1} decoded vs prefill (K1) "
            f"max|d|/max|logits| = {e:.3e} (tol {LM_TOL}); against the "
            f"unwindowed prefill {ctrl:.3e} (must exceed {10 * LM_TOL}); "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        if not e <= LM_TOL or not ctrl > 10 * LM_TOL:
            fail(f"dense-decode starcoder2: err {e}, control {ctrl}")
        errs["starcoder2 window"] = e
    results["dense_decode"] = errs
    del sparams, dec, full, wide
    torch.cuda.empty_cache()


def serve_dense(results: dict, card: str, params, cfg) -> None:
    """Phase 27, serve-dense: ARServer on the bf16 qwen2-1.5b (28 layers)
    through serve_ar."""
    serve_ar(results, card, params, cfg, "serve-dense", seed=23)


# (label, B, Hq, Hkv, L, D, window): K1 on the attention LMs' prefill
# shapes (hymba's global layers pass the reference's window 1 << 30)
DENSE_K1_SHAPES = (
    ("qwen2-1.5b causal GQA", 4, 12, 2, 4096, 128, None),
    ("starcoder2-7b window", 1, 36, 4, WINDOW_BLOCK_L, 128, 4096),
    ("stablelm-3b D 80", 1, 32, 32, 4096, 80, None),
    ("hymba-1.5b window", 4, 25, 5, 4096, 64, 2048),
    ("hymba-1.5b global", 4, 25, 5, 4096, 64, 1 << 30),
    ("qwen2-moe-a2.7b causal", 4, 16, 16, 4096, 128, None),
)


def visible_pairs(l: int, window: int | None) -> int:
    """(query, key) pairs a causal mask, and a window, leave visible."""
    if window is None or window >= l:
        return l * (l + 1) // 2
    return window * (window + 1) // 2 + (l - window) * window


def dense_numbers(card: str) -> dict:
    """K1 at the attention LMs' prefill shapes (causal, bf16): ms per call
    beside the bound over the visible pairs (K1 skips no masked tile: it
    computes the whole square), its plain version and SDPA (is_causal with
    enable_gqa where no window cuts the square; a boolean mask for a
    window; head dim 80 unpadded)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_mqkv as fm

    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = {}
    for label, b, hq, hkv, l, d, window in DENSE_K1_SHAPES:
        mk = lambda h: torch.randn((b * h, l, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        pos = torch.arange(l, dtype=torch.int32, device="cuda")
        kw = dict(group=hq // hkv, causal=True, window=window)
        ms = cuda_ms(lambda: fm.flash_mqkv(q, k, v, pos, pos, **kw), reps=20)
        # the same call unmasked: what the mask itself costs K1
        open_ms = cuda_ms(lambda: fm.flash_mqkv(q, k, v, pos, pos,
                                                group=hq // hkv), reps=20)
        plain_ms = cuda_ms(lambda: fm.flash_mqkv_plain(q, k, v, pos, pos,
                                                       **kw),
                           reps=3, warmup=1)
        q4, k4, v4 = (t.view(b, -1, l, d) for t in (q, k, v))
        if window is None or window >= l:
            sdpa = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=hq != hkv)
        else:
            i = torch.arange(l, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            sdpa = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=hq != hkv)
        lib_ms = cuda_ms(sdpa, reps=20)
        got = fm.flash_mqkv(q, k, v, pos, pos, **kw)[0]
        err = rel_err(got, sdpa().reshape(b * hq, l, d), floor=0.0)
        plain_err = rel_err(got, fm.flash_mqkv_plain(q, k, v, pos, pos,
                                                     **kw)[0], floor=0.0)
        del got
        pairs = visible_pairs(l, window)
        flops = 4.0 * b * hq * pairs * d
        nbytes = 2.0 * d * l * b * (2 * hq + 2 * hkv)  # q, k, v read, o written
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BPS
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           unmasked_ms=open_ms)
        log(f"k1 time {label}: B={b} Hq={hq} Hkv={hkv} L={l} D={d} (kernel "
            f"D {fm.kernel_head_dim(d)}) window={window} causal bf16: "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s over the "
            f"{pairs / l ** 2:.3f} L^2 visible pairs, {100 * bound_ms / ms:.1f}"
            f" % of the bound), bound {bound_ms:.4f} ms ({bound_by}), "
            f"unmasked K1 {open_ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms (K1 / sdpa "
            f"{ms / lib_ms:.2f}), max|d|/max|ref| of K1 vs sdpa {err:.2e}, "
            f"vs plain {plain_err:.2e} [{card}]")
        if not err <= TOL["bfloat16"]:
            fail(f"k1 {label}: {err} from sdpa")
        if not plain_err <= TOL["bfloat16"]:
            fail(f"k1 {label}: {plain_err} from its plain version")
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    rows["k2"] = dense_k2_numbers(card, gen)
    return rows


def dense_k2_numbers(card: str, gen) -> dict:
    """K2 at the first ring step of qwen2-1.5b's SP prefill, bf16, B 4 x L
    4096 on DENSE_SP_MESH: each rank's batch slice of 2 holds the Ulysses
    group's gathered 2048 positions (two discontiguous 1024-blocks) of 6 q
    heads and 1 KV head; causal over those positions, unfinalized, the
    chunk forwarded.  Held against its plain version (dense_k2_check),
    then timed: ROTATE input sets in turn; SDPA on the same chunk with the
    positions' boolean mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.collectives import GroupLayout
    from repro_torch.core.ulysses import group_positions
    from repro_torch.kernels import ring_flash as rf

    b, hq, hkv, ls, d = 2, 6, 1, 1024, 128
    lay = GroupLayout(("pod", "model"), 2, 2, ulysses_outer=True)
    pos = group_positions(lay, ls, 0, "cuda").to(torch.int32)
    l = pos.numel()
    mk = lambda h: torch.randn((b * h, l, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
    sets = [(mk(hq), mk(hkv), mk(hkv)) for _ in range(ROTATE)]
    dst = [(torch.empty_like(k), torch.empty_like(v)) for _, k, v in sets]
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    arrive = torch.zeros_like(flag)
    kw = dict(group=hq // hkv, causal=True, finalize=False)
    dense_k2_check(*sets[0], pos, group_positions(lay, ls, 1, "cuda").to(
        torch.int32), flag, arrive, kw)
    ms = cuda_ms(rotating([
        lambda q=q, k=k, v=v, kd=kd, vd=vd: rf.ring_flash_step(
            q, k, v, pos, pos, k_dst=kd, v_dst=vd, flag=flag, arrive=arrive,
            epoch=1, **kw)
        for (q, k, v), (kd, vd) in zip(sets, dst)]), reps=50)
    plain_ms = cuda_ms(rotating([
        lambda q=q, k=k, v=v, kd=kd, vd=vd: rf.ring_flash_step_plain(
            q, k, v, pos, pos, k_dst=kd, v_dst=vd, scale=d ** -0.5, **kw)
        for (q, k, v), (kd, vd) in zip(sets, dst)]), reps=5, warmup=1)
    mask = pos[None, :] <= pos[:, None]
    lib_ms = cuda_ms(rotating([
        lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q.view(b, hq, l, d), k.view(b, hkv, l, d), v.view(b, hkv, l, d),
            attn_mask=mask, enable_gqa=True)
        for q, k, v in sets]), reps=50)
    pairs = int(mask.sum())
    flops = 4.0 * b * hq * pairs * d
    nbytes = (2 * b * (hq + 2 * hkv) * l * d  # q, k, v read once (bf16)
              + 4 * b * hq * l * d + 8 * b * hq * l  # o' (f32), l, m
              + 2 * 2 * b * hkv * l * d)  # the forwarded chunk written
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BPS
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"k2 time qwen2-1.5b SP ring step (B 4 x L 4096 on (pod 2, data 2, "
        f"model 2)): BH={b * hq} BHkv={b * hkv} Lq=Lk={l} D={d} causal over "
        f"discontiguous positions ({pairs / l ** 2:.3f} of the pairs "
        f"visible), bf16, {ROTATE} input sets in turn: {ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms:.3f} "
        f"ms, sdpa {lib_ms:.4f} ms [{card}]")
    del sets, dst
    torch.cuda.empty_cache()
    return row


def dense_k2_check(q, k, v, pos, pos_other, flag, arrive, kw) -> None:
    """K2 against its plain version on qwen2-1.5b's SP ring chunks, per
    output within FLUX_TOL, the forwarded chunk bitwise: the step the path
    runs (the rank's own chunk), the other ring rank's chunk fresh (its
    first 1024 query rows see no key there: (0, 0, -inf), the l == 0
    guard) and merged into the own step's state (the -inf merge), and the
    path's last ring step (K1 on the other chunk with that state)."""
    import torch
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels import ring_flash as rf

    scale = q.shape[-1] ** -0.5

    def step(label, kp, state=None, state_ref=None, fused=True):
        if fused:
            kd, vd = torch.empty_like(k), torch.empty_like(v)
            got, _ = rf.ring_flash_step(q, k, v, pos, kp, k_dst=kd, v_dst=vd,
                                        flag=flag, arrive=arrive, epoch=1,
                                        state=state, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(kd, k) and torch.equal(vd, v)):
                fail(f"k2 qwen2 SP {label}: forwarded chunk differs")
        else:
            got = fm.flash_mqkv(q, k, v, pos, kp, state=state, **kw)
        ref = fm.flash_mqkv_plain(q, k, v, pos, kp, state=state_ref,
                                  scale=scale, **kw)
        errs = {n: (rel_err(a, b, floor=0.0), norm_err(a, b))
                for n, a, b in zip(("o'", "l", "m"), got, ref)}
        log(f"k2 qwen2 SP {label} vs plain, max|d|/max|ref|, |d|/|ref|: "
            + ", ".join(f"{n} {e[0]:.2e} {e[1]:.2e}" for n, e in errs.items()))
        for n, (e_max, e_norm) in errs.items():
            lim_max, lim_norm = FLUX_TOL[n]
            if not (e_max <= lim_max and e_norm <= lim_norm):
                fail(f"k2 qwen2 SP {label} {n}: max err {e_max} (limit "
                     f"{lim_max}), norm err {e_norm} (limit {lim_norm})")
        return got, ref

    own, own_ref = step("own chunk (K2)", pos)
    fresh, _ = step("other chunk, fresh (K2)", pos_other)
    blind = pos < pos_other.min()  # query rows before every key
    o, l, m = fresh
    if not (bool(blind.any()) and bool((o[:, blind] == 0).all())
            and bool((l[:, blind] == 0).all())
            and bool(torch.isneginf(m[:, blind]).all())):
        fail(f"k2 qwen2 SP: the {int(blind.sum())} rows with no visible key "
             "are not (0, 0, -inf)")
    step("other chunk into the own state (K2)", pos_other, own, own_ref)
    step("last ring step (K1)", pos_other, own, own_ref, fused=False)


# ---------------------------------------------------------------------------
# phases 28 to 34: decode-gap, and the hybrid (hymba-1.5b) and MoE
# (qwen2-moe-a2.7b) LMs
# ---------------------------------------------------------------------------

HYMBA_BLOCK_L = 2560  # hymba-block: above hymba's window of 2048
HYMBA_PREFILL = (4, 4096)  # hymba-prefill (B, L), 32 layers
MOE_BLOCK_BL = (2, 1024)  # moe-block's tokens (B, L), float32
MOE_EP = 4  # moe-block's EP degree: mesh (model 4)
# moe_block vs the dense function and EP 4 vs EP 1, max|d| / max|ref|
# (the reference's 2e-4 of tests/test_moe.py)
MOE_TOL = 2e-4
MOE_PREFILL = (4, 4096)  # moe-prefill (B, L), 24 layers
# SP prefill of each family on examples/generate_text.py's mesh, float32,
# at reduced depth, against degree 1 (moe at capacity 8.0: a shard's
# capacity follows its token count, so only an undropped run is the same
# function on every mesh)
FAMILY_SP_LAYERS = {"hymba-1.5b": 4, "qwen2-moe-a2.7b": 2}
FAMILY_SP_BL = (2, 1024)
FAMILY_SP_TOL = 1e-5
# the EP dispatch put of qwen2-moe's prefill at B 4 x L 4096 on (model 4):
# each of 4 ranks puts one peer's chunk of cap_send = 4096 tokens x top-4
# / 4 x 1.25 = 5120 rows of d 2048 (bf16) per stage
EP_PUT = (MOE_EP, 5120, 2048)
# the serve-cli decode runs' requests (launch/serve.py): prompts
# arange(1, 4 + i), 8 new tokens, 4 slots, cache length 64
CLI_PROMPTS = tuple(tuple(range(1, 4 + i)) for i in range(4))
CLI_NEW, CLI_LEN = 8, 64
BF16_ULP = 2.0 ** -8  # bf16's spacing relative to a value in [1, 2)


def perturb_lm(params, gen) -> None:
    """perturb_dense, and the SSD branch's constants: norm_scale from
    1 + N(0, 0.1^2), a_log from N(0, 0.5^2) (decay rates around 1)."""
    import torch
    perturb_dense(params, gen)
    for lp in params["layers"]:
        ssd = lp.get("ssd")
        if ssd is None:
            continue
        for name, mean, std in (("norm_scale", 1.0, 0.1), ("a_log", 0.0, 0.5)):
            leaf = ssd[name]
            ssd[name] = (torch.randn(leaf.shape, generator=gen,
                                     device=leaf.device) * std
                         + mean).to(leaf.dtype)


def hymba_block(results: dict) -> None:
    """Phase 29, hymba-block: one full-width float32 hymba-1.5b layer (d
    1600, 25 x 64 heads over 5 KV heads, the SSD branch of 25 heads and
    state 16, d_ff 5504), perturbed, at L HYMBA_BLOCK_L, through K1 on the
    card against the same layer on the CPU through the plain path, within
    LM_BLOCK_TOL of max|out|: as a global layer (window 1 << 30, the
    reference's GLOBAL_WINDOW) and as a windowed layer (2048), one K1
    launch each; the two layers' outputs must differ (the window bites)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.models import ParallelContext, init_lm
    from repro_torch.models import lm as lm_mod

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=1,
                              dtype="float32", vocab=256)
    gen = torch.Generator().manual_seed(31)
    params = init_lm(cfg, gen, device="cpu")
    perturb_lm(params, gen)
    lp = params["layers"][0]
    l = HYMBA_BLOCK_L
    x = torch.randn((1, l, cfg.d_model), generator=gen)
    sp = SPConfig(strategy="full")
    dev = torch.device("cuda")
    lp_card, x_card = _cast(lp, device=dev), x.to(dev)

    def layer(x, lp, device, window):
        return lm_mod._attention_layer(
            x, lp, cfg, ParallelContext(sp, device=torch.device(device)),
            dense_positions(cfg, 1, l, device), window, None, None)[0]

    errs, refs = {}, {}
    for label, window in (("global", lm_mod.GLOBAL_WINDOW),
                          ("windowed", cfg.window)):
        t0 = time.perf_counter()
        with torch.inference_mode():
            before = fm.launch_count()
            out = layer(x_card, lp_card, dev, window)
            torch.cuda.synchronize()
            launches = fm.launch_count() - before
            ref = layer(x, lp, "cpu", window)
        e = float((out.cpu() - ref).abs().max()) / float(ref.abs().max())
        errs[label], refs[label] = e, ref
        log(f"hymba-block {label} (window {window}) d={cfg.d_model} "
            f"H={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} SSD "
            f"{cfg.ssm.n_ssm_heads} heads state {cfg.ssm.state_size} L={l} "
            f"fp32: card vs CPU max|d|/max|ref| = {e:.3e} (tol "
            f"{LM_BLOCK_TOL}), K1 launches {launches}, "
            f"{time.perf_counter() - t0:.1f} s")
        if launches != 1 or not e <= LM_BLOCK_TOL:
            fail(f"hymba-block {label}: err {e} launches {launches}")
    ctrl = float((refs["windowed"] - refs["global"]).abs().max()) / float(
        refs["global"].abs().max())
    log(f"hymba-block: the windowed layer differs from the global one by "
        f"{ctrl:.3e} (must exceed {10 * LM_BLOCK_TOL})")
    if not ctrl > 10 * LM_BLOCK_TOL:
        fail(f"hymba-block: the window does not bite ({ctrl})")
    results["hymba_block_err"] = errs


def lm_prefill_run(results: dict, card: str, key: str, arch: str, bl):
    """The full-width, full-depth bf16 model of ``arch`` (weights from seed
    0, constants perturbed), last-position logits of B x L = ``bl``:
    finite, K1 launched once per layer and no other kernel, wall clock,
    then one traced forward.  Returns (params, cfg, fwd)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.models import ParallelContext, get_model, init_lm

    cfg = get_config(arch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device=dev)
    perturb_lm(params, gen)
    torch.cuda.synchronize()
    log(f"{key}: {arch} {cfg.n_layers} layers d={cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads bf16, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    bundle = get_model(cfg)
    ctx = ParallelContext(SPConfig(strategy="full"), "prefill", dev)
    b, l = bl
    tokens = torch.randint(0, cfg.vocab, (b, l), generator=gen, device=dev)
    fwd = lambda: bundle.apply(params, {"tokens": tokens}, cfg, ctx,
                               last_only=True)
    want = {"flash_mqkv": cfg.n_layers, "ring_flash_step": 0,
            "remote_put": 0, "landing_copy": 0}
    with torch.inference_mode():
        fwd()  # warm-up (cuBLAS handles, library load)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        logits = fwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        finite = bool(torch.isfinite(logits).all())
        log(f"{key} B={b} L={l}: logits {tuple(logits.shape)} finite="
            f"{finite}, {wall * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches "
            f"{counts} (expected {want}) [{card}]")
        if (tuple(logits.shape) != (b, 1, cfg.vocab) or not finite
                or counts != want):
            fail(f"{key}: logits {tuple(logits.shape)} finite {finite} "
                 f"launches {counts}")
        del logits
        trace = _traced_forward(fwd, f"{key} breakdown ({arch}, bf16, B {b},"
                                f" L {l}, last_only)", card)
    results[key] = dict(trace, launches=counts, timed_wall=wall * 1e3)
    return params, cfg, fwd


def hymba_prefill(results: dict, card: str):
    """Phase 30, hymba-prefill: hymba-1.5b at full width and depth (32
    layers: 3 global, 29 windowed), bf16, B x L = HYMBA_PREFILL,
    last_only: 32 K1 launches per forward (the SSD scan is plain torch, as
    in the reference), wall clock, device time, idle share, top kernels
    and K1's share.  Returns (params, cfg)."""
    params, cfg, _ = lm_prefill_run(results, card, "hymba-prefill",
                                    "hymba-1.5b", HYMBA_PREFILL)
    return params, cfg


def family_sp_prefill(results: dict, card: str, params, cfg) -> None:
    """Phases 30 and 33 (SP part): prefill on FAMILY_SP_MESH (swift over
    (pod, model), the batch over data, the put kernels' route) at full
    width, FAMILY_SP_LAYERS layers, float32, against degree 1 within
    FAMILY_SP_TOL of max|logits|, with the launches the plan implies: K1
    once per rank and layer, K2 P_r - 1 times, K4 for the attention's
    all-to-alls (a two-axis route), and for the moe family K3 for the
    expert exchange over model (a one-axis route: 3 exchanges of EP - 1
    puts per layer)."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.core.strategy import resolve_layout
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, get_model

    dev = torch.device("cuda")
    layers = FAMILY_SP_LAYERS[cfg.arch_id]
    moe = cfg.family == "moe"
    cfg32 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    if moe:
        cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    p32 = _cast({k: v for k, v in params.items() if k != "layers"},
                dtype=torch.float32)
    p32["layers"] = _cast(params["layers"][:layers], dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(33)
    b, l = FAMILY_SP_BL
    tokens = torch.randint(0, cfg.vocab, (b, l), generator=gen, device=dev)
    shape, axes = DENSE_SP_MESH
    sp = SPConfig(strategy="swift", sp_axes=("pod", "model"),
                  batch_axes=("data",), machine_axis="pod",
                  comm_backend="pallas", kernel_interpret=False)
    mesh = make_mesh(shape, axes, device=dev)
    lay = resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
    ranks = mesh.size
    ep = mesh.shape["model"] if moe else 1
    want = {"flash_mqkv": ranks * layers,
            "ring_flash_step": ranks * (lay.p_ring - 1) * layers,
            "remote_put": 3 * (ep - 1) * layers,
            "landing_copy": 4 * (lay.p_ulysses - 1) * layers}
    bundle = get_model(cfg32)
    with torch.inference_mode():
        one = bundle.apply(p32, {"tokens": tokens}, cfg32,
                           ParallelContext(SPConfig(strategy="full"),
                                           "prefill", dev))
        reset_counts()
        t0 = time.perf_counter()
        got = bundle.apply(p32, {"tokens": tokens}, cfg32,
                           ParallelContext(sp, "prefill", mesh=mesh))
        torch.cuda.synchronize()
        t_sp = time.perf_counter() - t0
    counts = read_counts()
    e = float((got - one).abs().max()) / float(one.abs().max())
    log(f"{cfg.arch_id} SP prefill: {layers} layers fp32 B={b} L={l} on mesh "
        f"{dict(zip(axes, shape))}, swift over (pod, model) plans P_u "
        f"{lay.p_ulysses} x P_r {lay.p_ring}"
        + (f", experts over model (EP {ep}, capacity 8.0)" if moe else "")
        + f"; logits vs degree 1 max|d|/max|ref| = {e:.3e} (tol "
        f"{FAMILY_SP_TOL}); launches {counts} (expected {want}); "
        f"{t_sp:.2f} s eager [{card}]")
    if not e <= FAMILY_SP_TOL or counts != want:
        fail(f"{cfg.arch_id} SP prefill: err {e}, launches {counts} "
             f"(want {want})")
    results.setdefault("family_sp", {})[cfg.arch_id] = dict(err=e,
                                                            launches=counts)
    del p32, one, got
    torch.cuda.empty_cache()


def dense_moe(x2d, p, cfg):
    """All experts on all tokens (tests/test_moe.py's dense reference):
    the router in float64, the expert products in x's dtype."""
    import torch
    import torch.nn.functional as F
    m = cfg.moe
    probs = torch.softmax(x2d.double() @ p["router"]["w"].double(), dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :m.top_k], ids[:, :m.top_k]
    wts = (wts / wts.sum(-1, keepdim=True)).to(x2d.dtype)
    y = torch.zeros_like(x2d)
    for e in range(m.n_experts):
        h = F.silu(x2d @ p["wi_gate"][e]) * (x2d @ p["wi_up"][e])
        w_e = (wts * (ids == e)).sum(-1, keepdim=True)
        y = y + w_e * (h @ p["wo"][e])
    return y


def moe_block_phase(results: dict, card: str) -> None:
    """Phase 32, moe-block: qwen2-moe-a2.7b's MoE layer at full width (d
    2048, 60 experts of d_ff 1408, top 4), float32, TF32 off, at capacity
    8.0 (nothing dropped), B x L = MOE_BLOCK_BL: at EP 1 and at EP MOE_EP on
    mesh (model 4) of virtual ranks, where the three exchanges of the
    dispatch run as puts over model (3 x (EP - 1) launches: K3 with
    kernel_interpret False, K4 with True), each within MOE_TOL of the
    dense function (every expert on every token) and EP 4 of EP 1."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, init_lm
    from repro_torch.models import moe as moe_mod

    base = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, n_layers=1, dtype="float32", vocab=256,
                              moe=dataclasses.replace(base.moe,
                                                      capacity_factor=8.0))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    p = init_lm(cfg, gen, device=dev, ep_degree=MOE_EP)["layers"][0]["moe"]
    b, l = MOE_BLOCK_BL
    x = torch.randn((b, l, cfg.d_model), generator=gen, device=dev)
    mesh = make_mesh((MOE_EP,), ("model",), device=dev)
    checks, outs = [], {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        y1, aux1 = moe_mod.moe_block(x, p, cfg, ParallelContext(
            SPConfig(strategy="full"), "prefill", dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter() - t0
        dense = dense_moe(x.reshape(-1, cfg.d_model), p, cfg).reshape(x.shape)
        e1 = float((y1 - dense).abs().max()) / float(dense.abs().max())
        log(f"moe-block EP 1: {b * l} tokens, d={cfg.d_model}, "
            f"{cfg.moe.n_experts} experts of {cfg.moe.moe_d_ff}, top "
            f"{cfg.moe.top_k}, fp32 capacity 8.0: vs the dense function "
            f"max|d|/max|ref| = {e1:.3e} (tol {MOE_TOL}) at max|y| "
            f"{float(dense.abs().max()):.3f}, aux {float(aux1):.4f}, "
            f"{t1 * 1e3:.1f} ms eager [{card}]")
        checks.append((e1 <= MOE_TOL, f"moe-block EP 1: {e1}"))
        for interp, put in ((False, "remote_put"), (True, "landing_copy")):
            sp = SPConfig(strategy="full", sp_axes=("model",),
                          batch_axes=("data",), comm_backend="pallas",
                          kernel_interpret=interp)
            reset_counts()
            t0 = time.perf_counter()
            y4, aux4 = moe_mod.moe_block(x, p, cfg, ParallelContext(
                sp, "prefill", mesh=mesh))
            torch.cuda.synchronize()
            t4 = time.perf_counter() - t0
            counts = read_counts()
            want = {"flash_mqkv": 0, "ring_flash_step": 0, "remote_put": 0,
                    "landing_copy": 0, put: 3 * (MOE_EP - 1)}
            e4 = float((y4 - dense).abs().max()) / float(dense.abs().max())
            e41 = float((y4 - y1).abs().max()) / float(y1.abs().max())
            log(f"moe-block EP {MOE_EP} on mesh (model {MOE_EP}), "
                f"kernel_interpret {interp}: vs the dense function "
                f"{e4:.3e}, vs EP 1 {e41:.3e} (tol {MOE_TOL}), aux "
                f"{float(aux4):.4f}, launches {counts} (expected {want}), "
                f"{t4 * 1e3:.1f} ms eager [{card}]")
            checks += [(e4 <= MOE_TOL and e41 <= MOE_TOL,
                        f"moe-block EP {MOE_EP}: {e4}, {e41}"),
                       (counts == want, f"moe-block EP {MOE_EP} launches "
                                        f"{counts} != {want}")]
            outs[put] = counts
    results["moe_block"] = dict(err=e1, launches=outs)
    del p, x, y1, y4, dense
    torch.cuda.empty_cache()
    for ok, msg in checks:
        if not ok:
            fail(msg)


def _moe_event_times(fwd) -> tuple[float, float]:
    """One forward with CUDA events around every expert product call
    (``_expert_ffn``) and every prefill MoE block: (ms in the expert
    products, ms in the rest of the blocks: routing, dispatch, exchange
    and combine)."""
    import torch
    from repro_torch.models import moe as moe_mod

    spans = {"ffn": [], "block": []}
    real = {"ffn": moe_mod._expert_ffn, "block": moe_mod._moe_prefill}

    def timed(key):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[key](*args, **kw)
            end.record()
            spans[key].append((start, end))
            return out
        return call

    moe_mod._expert_ffn, moe_mod._moe_prefill = timed("ffn"), timed("block")
    try:
        with torch.inference_mode():
            fwd()
        torch.cuda.synchronize()
    finally:
        moe_mod._expert_ffn, moe_mod._moe_prefill = real["ffn"], real["block"]
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    return ms["ffn"], ms["block"] - ms["ffn"]


def moe_prefill(results: dict, card: str):
    """Phase 33, moe-prefill: qwen2-moe-a2.7b at full width and depth (24
    layers, 60 routed experts + 4 shared, bf16, ~14.3 B parameters),
    B x L = MOE_PREFILL, last_only, at degree 1 (every expert on the
    card): 24 K1 launches, no put; wall clock, device time, idle share,
    top kernels, and the shares of the expert products and of the rest of
    the MoE blocks (routing, dispatch, exchange, combine), from CUDA
    events around them in one more forward.  Returns (params, cfg)."""
    params, cfg, fwd = lm_prefill_run(results, card, "moe-prefill",
                                      "qwen2-moe-a2.7b", MOE_PREFILL)
    ffn, dispatch = _moe_event_times(fwd)
    busy = results["moe-prefill"].get("busy")
    share = (lambda t: f"{t / busy:.3f} of busy") if busy else (
        lambda t: "share not measured")
    log(f"moe-prefill: expert products {ffn:.2f} ms ({share(ffn)}), routing "
        f"+ dispatch + combine {dispatch:.2f} ms ({share(dispatch)}) of one "
        f"forward (CUDA events) [{card}]")
    results["moe-prefill"].update(ffn=ffn, dispatch=dispatch)
    return params, cfg


def weight_read_floor_ms(params) -> float:
    """The least time a decode tick takes on the card: every weight it
    reads (all but the embedding table, of which it gathers a row per
    slot) read once at the HBM rate."""
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    emb = params["embed"]
    return (total - emb.numel() * emb.element_size()) / HBM_BPS * 1e3


def serve_ar(results: dict, card: str, params, cfg, key: str, seed: int,
             floor_ms: float | None = None) -> None:
    """Phases 27, 31 and 34 (serve-dense, serve-hymba, serve-moe): ARServer
    on a bf16 attention LM (bf16 KV caches: the reference's cache update
    takes the model's dtype) with 4 slots, the LM_REQUESTS,
    LM_NEW_TOKENS new tokens each; its tick captured as a CUDA graph, then
    the same requests with capture=False: the tokens bitwise equal, each
    tick's wall clock captured against eager (and against ``floor_ms``,
    the weight-read floor, where given)."""
    import torch
    run = lambda capture: run_ar_server(params, cfg, capture, torch.bfloat16,
                                        seed=seed)
    srv, out, wall, ticks = run(None)
    tr = srv.tracker
    counts = {n: tr.counter_total(f"ar.{n}")
              for n in ("submitted", "admitted", "ticks", "completed")}
    lens = {rid: len(v) for rid, v in sorted(out.items())}
    n = len(LM_REQUESTS)
    ok = (sorted(out) == [r for r, *_ in LM_REQUESTS]
          and all(v == LM_NEW_TOKENS for v in lens.values())
          and all(0 <= t < cfg.vocab for v in out.values() for t in v)
          and counts["submitted"] == counts["admitted"] == counts["completed"] == n)
    step = srv._step
    if not ok or step.graph is None:
        fail(f"{key}: results {out}, counters {counts}, graph {step.graph}")
    log(f"{key}: {cfg.arch_id} {cfg.n_layers} layers bf16, {len(out)} "
        f"requests, {counts['ticks']:.0f} ticks in {wall:.2f} s, tokens per "
        f"request {lens}, counters {counts}; graph captured after "
        f"{step.calls - step.replays} eager tick, capture {step.capture_s:.3f} s, "
        f"instantiation {step.instantiate_s:.3f} s (host), {step.replays} "
        f"replays [{card}]")
    replayed = ticks[len(ticks) - step.replays + 1:]  # after the capture
    del srv, step
    _, eager, ewall, eticks = run(False)
    same = eager == out
    floor = ("" if floor_ms is None else
             f"; the weight-read floor {floor_ms:.2f} ms (captured tick "
             f"{median(replayed) * 1e3 / floor_ms:.2f} x it)")
    log(f"capture {key}: captured tokens equal the eager server's "
        f"{same}; tick wall clock median {median(replayed) * 1e3:.2f} ms "
        f"captured (replays) vs {median(eticks) * 1e3:.2f} ms eager; "
        f"{wall:.2f} s vs {ewall:.2f} s in all{floor} [{card}]")
    if not same:
        fail(f"capture {key}: captured tokens differ from eager")
    results[key] = (median(replayed), median(eticks))


def _greedy_cli(params, cfg, ctx, cache_dtype):
    """The serve-cli decode run (CLI_PROMPTS, 4 slots admitted together,
    one shared position per tick, as ARServer runs them): per request its
    greedy tokens and, per token, the top-2 logit gap and the logits."""
    import torch
    from repro_torch.models import get_model

    bundle = get_model(cfg)
    dev = ctx.device
    caches = bundle.init_caches(cfg, len(CLI_PROMPTS), CLI_LEN, cache_dtype,
                                dev)
    toks = [[] for _ in CLI_PROMPTS]
    gaps = [[] for _ in CLI_PROMPTS]
    rows = [[] for _ in CLI_PROMPTS]
    with torch.inference_mode():
        for t in range(max(len(p) for p in CLI_PROMPTS) + CLI_NEW - 1):
            feed = [p[t] if t < len(p) else (g[-1] if g else 0)
                    for p, g in zip(CLI_PROMPTS, toks)]
            tok = torch.tensor(feed, dtype=torch.int32, device=dev)[:, None]
            logits, caches = bundle.step(params, {"tokens": tok}, caches, t,
                                         cfg, ctx)
            nxt = torch.argmax(logits, dim=-1).tolist()
            top = torch.topk(logits.float(), 2, dim=-1).values
            for i, p in enumerate(CLI_PROMPTS):
                if t >= len(p) - 1 and len(toks[i]) < CLI_NEW:
                    toks[i].append(nxt[i])
                    gaps[i].append(float(top[i, 0] - top[i, 1]))
                    rows[i].append(logits[i].float().cpu())
    return toks, gaps, rows


def decode_gap(results: dict, card: str) -> None:
    """Phase 28, decode-gap (ROADMAP Queue 3's unconfirmed fault): the
    launcher's qwen2-1.5b decode at full depth (its weights: seed 0, as
    initialised; its 4 requests; bf16) at degree 1 and with the KV cache
    over mesh (pod 2, model 8), token by token.  Where a request's tokens
    part: the top-2 logit gap of each run there, the largest difference of
    the two runs' logits there, and bf16's spacing at the top logit.  Then
    the same decode with the model and caches in float32, where the two
    runs' tokens must agree; in bf16 every parting must sit on a top-2 gap
    no wider than the runs' logit difference (a near-tie flipped by
    rounding)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, init_lm

    dev = torch.device("cuda")
    cfg = get_config("qwen2-1.5b")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sp16 = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                    batch_axes=("data",), machine_axis="pod",
                    comm_backend="pallas", kernel_interpret=False)
    ctxs = {"degree 1": ParallelContext(SPConfig(strategy="full"), "decode",
                                        dev),
            "mesh pod": ParallelContext(sp16, "decode", mesh=make_mesh(
                (2, 8), ("pod", "model"), device=dev))}
    out, flips = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else _cast(params, dtype=dtype)
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
        runs = {k: _greedy_cli(p, c, ctx, dtype) for k, ctx in ctxs.items()}
        (t1, g1, r1), (tp, gp, rp) = runs["degree 1"], runs["mesh pod"]
        parts = {}
        for i in range(len(CLI_PROMPTS)):
            log(f"decode-gap {c.dtype} request {i}: degree 1 {t1[i]}, mesh "
                f"pod {tp[i]}")
            j = next((j for j, (a, b) in enumerate(zip(t1[i], tp[i]))
                      if a != b), None)
            if j is None:
                continue
            top = float(r1[i][j].abs().max())
            spacing = BF16_ULP * 2.0 ** math.floor(math.log2(top))
            diff = float((r1[i][j] - rp[i][j]).abs().max())
            log(f"decode-gap {c.dtype} request {i} parts at new token {j}: "
                f"top-2 gap degree 1 {g1[i][j]:.4f}, mesh pod {gp[i][j]:.4f}; "
                f"max|logits_1 - logits_pod| there {diff:.4f}; bf16 spacing "
                f"at the top logit {top:.2f}: {spacing:.4f} [{card}]")
            parts[i] = dict(token=j, gap1=g1[i][j], gap_pod=gp[i][j],
                            diff=diff, spacing=spacing)
            flips.append(max(g1[i][j], gp[i][j]) <= diff)
        out[c.dtype] = dict(parts=parts, same=t1 == tp)
        del p, runs
        torch.cuda.empty_cache()
    results["decode_gap"] = out
    log(f"decode-gap: float32 tokens equal across the meshes "
        f"{out['float32']['same']}; bf16 {out['bfloat16']['same']}, its "
        f"partings on near-ties within the runs' logit difference "
        f"{all(flips)}")
    if not out["float32"]["same"] or not all(flips):
        fail(f"decode-gap: float32 equal {out['float32']['same']}, bf16 "
             f"partings {out['bfloat16']['parts']}")


def ep_put_numbers(card: str) -> dict:
    """K3 and K4 on the EP dispatch put (stage 1 of the exchange: rank r
    puts its chunk for rank r + 1) at qwen2-moe's prefill shape EP_PUT,
    bf16, beside the plain versions and one copy_ of the same bytes, each
    timed call on one of n input sets that together touch four times the
    L2.  Returns {name: row}."""
    import torch
    from repro_torch.comm import kernel_backend as kb

    ranks, n_rows, d = EP_PUT
    gen = torch.Generator(device="cuda").manual_seed(34)
    perm = [(r + 1) % ranks for r in range(ranks)]
    signal, arrive = put_words(ranks)
    nbytes = ranks * n_rows * d * 2
    n_sets = max(ROTATE, -(-4 * L2_BYTES // (2 * nbytes)))
    sets = []
    for _ in range(n_sets):
        src = [[torch.randn((n_rows, d), generator=gen, device="cuda")
                .to(torch.bfloat16)] for _ in range(ranks)]
        dst = [[torch.empty_like(t) for t in r] for r in src]
        flat = torch.cat([r[0].reshape(-1) for r in src])
        sets.append((src, dst, flat, torch.empty_like(flat)))
    lib_ms = cuda_ms(rotating([lambda a=a, b=b: b.copy_(a)
                               for _, _, a, b in sets]), reps=50)
    bound_ms = 2 * nbytes / HBM_BPS * 1e3
    put = (f"{ranks} ranks x [{n_rows}, {d}] bf16 ({nbytes / 2**20:.1f} MiB), "
           f"{n_sets} sets in turn")
    rows = {}
    for name in ("remote_put", "landing_copy"):
        if name == "remote_put":
            fn = [lambda s=s_, d=d_: kb.remote_put(
                s, d, perm, signal=signal, arrive=arrive, epoch=1)
                for s_, d_, *_ in sets]
            plain = [lambda s=s_, d=d_: kb.remote_put_plain(s, d, perm,
                                                            signal, 1)
                     for s_, d_, *_ in sets]
        else:
            fn = [lambda s=s_, d=d_: kb.landing_copy(
                s, d, signal=signal, arrive=arrive, epoch=1)
                for s_, d_, *_ in sets]
            plain = [lambda s=s_, d=d_: kb.landing_copy_plain(s, d, signal, 1)
                     for s_, d_, *_ in sets]
        ms, host = time_call(rotating(fn), reps=50)
        plain_ms = cuda_ms(rotating(plain), reps=20)
        ok = all(torch.equal(dst[perm[r] if name == "remote_put" else r][0],
                             src[r][0])
                 for src, dst, *_ in sets[:1] for r in range(ranks))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by="bytes")
        log(f"{name} time on the EP dispatch put, {put}: {ms:.4f} ms on the "
            f"device ({bound_ms / ms:.3f} of the bound, {ms / lib_ms:.2f} x "
            f"one copy_; {host:.4f} ms of host time per call), bound "
            f"{bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms, one copy_ "
            f"{lib_ms:.4f} ms; delivered bitwise {ok} [{card}]")
        if not ok:
            fail(f"{name} on the EP dispatch put: delivery differs")
    del sets
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: K1b, a full-width layer's gradients, the launcher, whisper
# ---------------------------------------------------------------------------

# (label, BH, BHkv, Lq, Lk, D, causal, window, padded keys, a fully masked
# row, chunk): the shapes the train path gives K1b, and its edges.  chunk
# None: the rows' keys are the call's keys; else (offset, keys): the rows
# see positions [0, keys), (o, m, l) come from all of them, and the call
# gets the Lk keys from ``offset``, as a ring step of the SP backward does
K1B_CASES = (
    ("qwen2-train", 48, 8, 1024, 1024, 128, True, None, 0, False, None),
    ("whisper-cross", 24, 24, 448, 1536, 64, False, None, 0, False, None),
    ("flux", 24, 24, 4352, 4352, 128, False, None, 0, False, None),
    ("stablelm-d80", 32, 32, 1024, 1024, 80, True, None, 0, False, None),
    ("starcoder2-window", 36, 4, 4608, 4608, 128, True, 4096, 0, False,
     None),
    ("pad-masked-row", 8, 2, 200, 300, 64, True, None, 17, True, None),
    # train-hymba's (GQA group 5, window 2048) and train-moe's (group 1)
    ("hymba-train", 100, 20, 1024, 1024, 64, True, 2048, 0, False, None),
    ("qwen2moe-train", 64, 64, 1024, 1024, 128, True, None, 0, False, None),
    # train-sp's ring steps (P_u 2 x P_r 2, group 6) for the rows of ring
    # rank 1: the past chunk, fully visible, and the diagonal one, each
    # with the rows' statistics over both chunks
    ("train-sp-past", 24, 4, 512, 512, 128, True, None, 0, False, (0, 1024)),
    ("train-sp-diagonal", 24, 4, 512, 512, 128, True, None, 0, False,
     (512, 1024)),
)
TRAIN_TOL = 1e-4  # train-layer and whisper, card vs twin, of max|ref|
TRAIN_LAYER_L = 1024  # train-layer's tokens (B 1)
TRAIN_LAYER_VOCAB = 4096  # its tied embedding, cut: the layer is full width
TRAIN_BL = (4, 1024)  # train: the launcher's --batch and --seq
TRAIN_STEPS = 5
CURVE_STEPS = 40  # train-curve: tests/test_torch_train.py's config
WHISPER_BL = (4, 448)  # whisper: batch, decoder tokens (encoder_seq 1536)
# (B, Hq, Hkv) of the numbers phase's K1b shapes, for SDPA's [B, H, L, D]
K1B_SDPA = {"qwen2-train": (4, 12, 2), "whisper-cross": (4, 6, 6)}
# the device kernels of a bf16 K1b call (csrc/flash_mqkv_bwd.cu) as the
# profiler names them
K1B_KERNELS = ("::delta_bf16_kernel<", "::bounds_kernel(", "::dkdv_hopper_kernel<",
               "::reduce_dkdv_kernel(", "::dq_hopper_kernel<")


# K5b (rwkv6_wkv_bwd, the gradient of K5): (label, B, L, H, N) at chunk 64,
# rwkv6-1.6b's training shape and one shorter than the chunk
K5B_CASES = (("rwkv6-train", 4, 1024, 32, 64), ("short-L", 2, 32, 32, 64))
K5B_SETS = 2  # input sets of a timed K5b call (~134 MB each at the train shape)
# K5b's time at the training shape in its first design (one block of 256
# threads per row, float32 products on the CUDA cores), on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md): the figure the numbers phase prints beside
K5B_ONE_BLOCK_A_ROW_MS = 1.2861
# train-rwkv6 / train-hymba: the launcher at full width and depth; per arch
# its (K1, K1b, K5, K5b) launches per step (remat "full": every layer's
# forward runs again in the backward)
TRAIN_FAMILIES = {"rwkv6-1.6b": (0, 0, 48, 24), "hymba-1.5b": (64, 32, 0, 0)}
TRAIN_MOE_LAYERS = 4  # train-moe: qwen2-moe-a2.7b at 4 of its 24 layers
# train-layer: one full-width float32 layer of each, its weights and tokens
# from TRAIN_LAYER_SEED, and its (K1, K1b, K5, K5b) launches (the forward,
# its recomputation and one backward)
TRAIN_LAYER_SEED = 31
# train-sp: qwen2-1.5b over the virtual mesh (pod 2, model 2), SP over both
# axes (swift_torus plans P_u 2 x P_r 2 for its 12 / 2 heads, so the
# backward has Ulysses and ring legs); all 28 layers, one warm-up step and
# TRAIN_SP_STEPS timed steps; the phase fails past TRAIN_SP_BUDGET_S
TRAIN_SP_MESH = ((2, 2), ("pod", "model"))
TRAIN_SP_STEPS = 3
# examples: train_lm's steps and batch on the card (at its default batch
# of 8 the loss does not fall within 30 steps: 9.849 -> 9.899)
EXAMPLE_TRAIN = (30, 32)
EXAMPLES_BUDGET_S = 45
TRAIN_SP_LOSS_TOL = 2e-2  # step 0's loss, bf16, SP vs degree 1, relative
TRAIN_SP_BUDGET_S = 45
# train-sp-families: the four families over TRAIN_SP_MESH.  (a) a float32
# layer of each against degree 1; the MoE at a capacity that drops no token
# and without its load-balance loss: over a mesh that loss is averaged over
# the ranks' shards (the reference's pmean), not taken over the whole
# batch, which moves the router's gradient by ~1e-2 of its max at full
# width (1.396e-2 on the card; 9.3e-4 on the CPU's reduced config, where
# tests/test_torch_train_sp_state.py holds it to the reference's own SP
# gradient).  (b) bf16 steps at these depths: rwkv6 whole, qwen2-moe at 2
# of 24 layers (time and memory: 24 need ~14.3 B parameters)
TRAIN_SP_FAMILIES = ("rwkv6-1.6b", "hymba-1.5b", "qwen2-moe-a2.7b",
                     "whisper-tiny")
TRAIN_SP_NO_DROP = 8.0
TRAIN_SP_FAMILY_LAYERS = {"rwkv6-1.6b": 24, "qwen2-moe-a2.7b": 2}
TRAIN_SP_FAMILIES_BUDGET_S = 60
TRAIN_LAYER_ARCHS = {"qwen2-1.5b": (2, 1, 0, 0), "rwkv6-1.6b": (0, 0, 2, 1),
                     "hymba-1.5b": (2, 1, 0, 0),
                     "qwen2-moe-a2.7b": (2, 1, 0, 0)}


def k5b_inputs(gen, b, l, h, n, dtype):
    """K5b's inputs at [B, L, H, N]: r, k, v and u in ``dtype`` (bf16 as
    the model's, or float32), w float32 from RWKV6's range, dO float32
    (K5's output dtype)."""
    import torch
    mk = lambda: torch.randn((b, l, h, n), generator=gen, device="cuda")
    r, k, v = (mk().to(dtype) for _ in range(3))
    w = rwkv_decays(gen, (b, l, h, n), "cuda")
    u = (torch.randn((h, n), generator=gen, device="cuda") * 0.5).to(dtype)
    return r, k, v, w, u, mk()


def check_k5b(results: dict) -> None:
    """Phase k5b: K5b against its plain version (kernels/ref.py's explicit
    chunked backward) on the same card tensors at K5B_CASES, float32 (TF32
    off) within TOL["float32"] and with the model's bf16 r, k, v, u within
    TOL["bfloat16"] of each gradient's max|ref|; two runs bitwise equal;
    every gradient finite.  Negative control: the kernel with dS dropped
    between chunks must break the float32 gate at the training shape."""
    import torch
    wkv = wkv_module()

    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = {}
    for label, b, l, h, n in K5B_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            args = k5b_inputs(gen, b, l, h, n, dtype)
            got = wkv.rwkv6_wkv_heads_bwd(*args)
            again = wkv.rwkv6_wkv_heads_bwd(*args)
            want = wkv.rwkv6_wkv_heads_bwd_plain(*args)
            torch.cuda.synchronize()
            err = max(rel_err(g, w, floor=0.0) for g, w in zip(got, want))
            bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            log(f"k5b {label} B={b} L={l} H={h} N={n} chunk 64 {name}: max "
                f"over dr, dk, dv, dw, du of max|d|/max|ref| {err:.3e} (tol "
                f"{TOL[name]}), repeat bitwise {bitwise}, finite {finite}")
            if not (err <= TOL[name] and bitwise and finite):
                fail(f"k5b {label} {name}: err {err} bitwise {bitwise} "
                     f"finite {finite}")
            if name == "bfloat16":
                errs[label] = err
            del args, got, again, want
    args = k5b_inputs(gen, *K5B_CASES[0][1:], torch.float32)
    got = wkv.rwkv6_wkv_heads_bwd(*args, carry=False)
    want = wkv.rwkv6_wkv_heads_bwd_plain(*args)
    err = max(rel_err(g, w, floor=0.0) for g, w in zip(got, want))
    log(f"k5b negative control float32: the kernel with dS dropped between "
        f"chunks against the plain backward: {err:.3e} (must exceed "
        f"{TOL['float32']})")
    if not err > TOL["float32"]:
        fail(f"k5b negative control passed the gate ({err})")
    del args, got, want
    torch.cuda.empty_cache()
    results["k5b_err"] = errs


def k5b_work(b, l, h, n, c, itemsizes):
    """(FLOPs, bytes) of one K5b call on [B, L, H, N] at chunk c: per chunk
    and row, five strictly lower products of c(c-1)/2 x N terms (A, dA, Aᵀ
    dO, dA k_sc, dAᵀ r_sc), five of c x N x N (the forward sweep's state
    increment, (k_sc a) dS, dO S_inᵀ, v dSᵀ, r_scᵀ dO), the decays of S
    and dS and da's row sum (3 x 2 N²) and ~30 operations an element for
    the decays, the row sums, the log-decay scan and the epilogue.  Bytes:
    r, k, v, w, dO read once and dr, dk, dv, dw written once in their
    types (``itemsizes``: r, k, v, w, dO), u read and du written."""
    per_chunk = (5 * c * (c - 1) * n + 5 * 2 * c * n * n + 6 * n * n
                 + 30 * c * n)
    flops = float(per_chunk) * (l // c) * b * h
    nbytes = (float(b * l * h * n) * (2 * sum(itemsizes[:4]) + itemsizes[4])
              + 2 * h * n * itemsizes[0])
    return flops, nbytes


def k5b_numbers(card: str) -> dict:
    """K5b at rwkv6-1.6b's training shape (B 4 x L 1024, H 32, N 64, chunk
    64; r, k, v, u bf16, w and dO float32), each timed call on one of
    K5B_SETS input sets, beside its bound (the larger of the bytes at the
    HBM rate and the operations at the TF32 tensor-core rate, as K5's) and
    its plain version; no PyTorch call computes the WKV scan's gradient.
    Its three launches one by one: scripts/wkv_bwd_ab.py."""
    import torch
    wkv = wkv_module()

    label, b, l, h, n = K5B_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(15)
    sets = [k5b_inputs(gen, b, l, h, n, torch.bfloat16)
            for _ in range(K5B_SETS)]
    ms = cuda_ms(rotating([lambda a=a: wkv.rwkv6_wkv_heads_bwd(*a)
                           for a in sets]), reps=20)
    plain_ms = cuda_ms(rotating([lambda a=a: wkv.rwkv6_wkv_heads_bwd_plain(*a)
                                 for a in sets]), reps=3, warmup=1)
    flops, nbytes = k5b_work(b, l, h, n, 64, (2, 2, 2, 4, 4))
    t_f32, t_tf32, t_bytes = (flops / PEAK_F32, flops / PEAK_TF32,
                              nbytes / HBM_BPS)
    bound = max(t_tf32, t_bytes)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound * 1e3,
               bound_by="operations" if t_tf32 >= t_bytes else "bytes")
    log(f"k5b time {label} B={b} L={l} H={h} N={n} chunk 64 (bf16 r/k/v/u, "
        f"f32 w and dO), {len(sets)} input sets in turn: {ms:.4f} ms on the "
        f"device ({flops / ms / 1e9:.2f} TFLOP/s, "
        f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s); bound {bound * 1e3:.4f} ms "
        f"({row['bound_by']}), {bound / (ms * 1e-3):.3f} of it reached; "
        f"terms: {flops / 1e9:.2f} GFLOP -> {t_f32 * 1e3:.4f} ms at 67 "
        f"TFLOP/s on the CUDA cores, {t_tf32 * 1e3:.4f} ms at 495 TFLOP/s "
        f"TF32, {nbytes / 1e6:.0f} MB -> {t_bytes * 1e3:.4f} ms at 3.35 TB/s; "
        f"plain {plain_ms:.3f} ms; no PyTorch call computes it; "
        f"{K5B_ONE_BLOCK_A_ROW_MS} ms in the one-block-a-row design "
        f"({K5B_ONE_BLOCK_A_ROW_MS / ms:.2f}x) [{card}]")
    del sets
    torch.cuda.empty_cache()
    return row


def k1b_inputs(gen, case, dtype):
    """K1b's inputs for ``case``: q, k, v and dO, and the (o, l, m) of K1's
    forward on them (on all the rows' keys when the case names a chunk;
    k and v are then the chunk's)."""
    import torch
    from repro_torch.kernels import flash_mqkv as fm
    _, bh, bhkv, lq, lk, d, causal, window, pad, dead, chunk = case
    off, keys = chunk or (0, lk)
    q, k, v = k1_inputs(gen, bh, bhkv, lq, keys, d, dtype)
    q_pos = torch.arange(keys - lq, keys, dtype=torch.int32, device="cuda")
    k_pos = torch.arange(keys, dtype=torch.int32, device="cuda")
    if pad:
        k_pos[-pad:] = -1
    if dead:  # row 0 sees only keys at positions <= 0, and those are padding
        k_pos[:4] = -1
        q_pos[0] = 0
    kw = dict(group=bh // bhkv, scale=d ** -0.5, causal=causal, window=window)
    with torch.no_grad():
        o, l, m = fm.flash_mqkv(q, k, v, q_pos, k_pos, **kw)
    k, v = (t[:, off:off + lk].contiguous() for t in (k, v))
    k_pos = k_pos[off:off + lk].contiguous()
    do = torch.randn((bh, lq, d), generator=gen, device="cuda").to(dtype)
    return (q, k, v, o, do, m, l, q_pos, k_pos), kw


def check_k1b(results: dict) -> None:
    """Phase k1b: K1b against its plain version (the explicit FA2 backward,
    kernels/ref.py) on the same card tensors at K1B_CASES, float32 (TF32
    off) within TOL["float32"] and bfloat16 within TOL["bfloat16"] of each
    gradient's max|ref|; two runs bitwise equal; the fully masked rows'
    gradients zero; train-sp's KV chunks with the rows' statistics over
    all their keys.  Negative controls: the kernel with the causal mask
    off must break the float32 and the bfloat16 gates at the qwen2
    training shape."""
    import torch
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels.ref import flash_mqkv_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for case in K1B_CASES:
        label, bh, bhkv, lq, lk, d = case[:6]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            args, kw = k1b_inputs(gen, case, dtype)
            got = fm.flash_mqkv_bwd(*args, **kw)
            again = fm.flash_mqkv_bwd(*args, **kw)
            want = flash_mqkv_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            err = max(rel_err(g, w, floor=0.0) for g, w in zip(got, want))
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            dead_ok = True
            if case[9]:
                dead = args[6] == 0
                dead_ok = bool(dead.any()) and bool((got[0][dead] == 0).all())
            plan = ""
            if name == "bfloat16":
                p = fm.bwd_tile_plan(bh, bh // bhkv, lq, lk, d, kw["causal"])
                plan = (f" (plan: {p.kv_wg} dK/dV warpgroups, {p.splits} "
                        f"shares, paired {p.pair})")
            log(f"k1b {label} BH={bh}/{bhkv} Lq={lq} Lk={lk} D={d} "
                f"causal={kw['causal']} window={kw['window']} {name}{plan}: "
                f"max over dq, dk, dv of max|d|/max|ref| {err:.3e} (tol "
                f"{TOL[name]}), repeat bitwise {bitwise}, finite {finite}"
                + (f", masked rows zero {dead_ok}" if case[9] else "")
                + (f", the chunk of keys {int(args[8][0])}..{int(args[8][-1])}"
                   f" with (o, m, l) over {case[10][1]}" if case[10] else ""))
            if not (err <= TOL[name] and bitwise and finite and dead_ok):
                fail(f"k1b {label} {name}: err {err} bitwise {bitwise} "
                     f"finite {finite} masked rows {dead_ok}")
            if name == "bfloat16":
                errs[label] = err
            del args, got, again, want
            torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        args, kw = k1b_inputs(gen, K1B_CASES[0], dtype)
        got = fm.flash_mqkv_bwd(*args, **dict(kw, causal=False))
        want = flash_mqkv_bwd_plain(*args, **kw)
        err = max(rel_err(g, w, floor=0.0) for g, w in zip(got, want))
        log(f"k1b negative control {name}: the kernel without the causal "
            f"mask against the masked plain backward: {err:.3e} (must "
            f"exceed {TOL[name]})")
        if not err > TOL[name]:
            fail(f"k1b negative control {name} passed the gate ({err})")
        del args, got, want
    results["k1b_err"] = errs


def _grads(bundle, params, batch, cfg, device, remat="full", mesh=None,
           sp=None):
    """(loss, [(name, gradient or None)]) of ``bundle.loss`` in train mode
    on ``device`` (over ``mesh`` under ``sp`` when given), every parameter
    a leaf that requires grad."""
    import torch
    from repro_torch.core import SPConfig
    from repro_torch.models import ParallelContext
    from repro_torch.train.optimizer import tree_leaves

    p = _cast(params, device=device)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    ctx = ParallelContext(sp or SPConfig(strategy="full"), "train", device,
                          mesh=mesh, remat=remat)
    b = {k: v.to(device) for k, v in batch.items()}
    loss, _ = bundle.loss(p, b, cfg, ctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return p, loss.detach(), list(grads)


def gradient_gate(label: str, grads) -> None:
    """Every parameter has a gradient, not None and not all zero: what a
    kernel output without an autograd graph would break."""
    import torch
    missing = sum(g is None for g in grads)
    zero = sum(g is not None and not bool(torch.any(g != 0)) for g in grads)
    log(f"{label}: {len(grads)} parameters, {missing} without a gradient, "
        f"{zero} with an all-zero gradient")
    if missing or zero:
        fail(f"{label}: {missing} gradients missing, {zero} all zero")


def train_layer(results: dict) -> None:
    """Phase train-layer: for each of TRAIN_LAYER_ARCHS, one full-width
    float32 layer plus the loss (embeddings cut to TRAIN_LAYER_VOCAB rows,
    B 1 x L TRAIN_LAYER_L, remat "full"; the constant leaves drawn, the
    rwkv6 decays from RWKV6's range, all from TRAIN_LAYER_SEED): every
    parameter's gradient on the card (K1 or K5, then K1b or K5b) within
    TRAIN_TOL of that tensor's max|grad| of its twin without the kernels;
    the gradient gate; the kernels launched as TRAIN_LAYER_ARCHS says (the
    forward and its recomputation, one backward).

    The twin is the CPU's run (the plain versions), except for rwkv6:
    there it is the same layer on the card with the WKV scan through K5's
    plain version and autograd (``plain_wkv``), and the CPU's run is
    printed beside it.  The rwkv6 layer's group norm (eps 1e-5) is
    ill-conditioned at t = 0, where the WKV output is the bonus term
    (r·u·k) v alone: where a head's r·u·k cancels to ~0 the norm divides
    float32 rounding by ~sqrt(eps), and the card's plain run and the CPU's
    then differ by ~1e-3 of some gradients' max (seed 31 does this) with
    no kernel between them.  The card's two runs share every operation but
    the kernels, so only the kernels' error is held to TRAIN_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.models import get_model, init_lm
    from repro_torch.train import SyntheticStream
    wkv = wkv_module()

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    worst_all = 0.0
    for arch, expected in TRAIN_LAYER_ARCHS.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=1,
                                  dtype="float32", vocab=TRAIN_LAYER_VOCAB)
        gen = torch.Generator().manual_seed(TRAIN_LAYER_SEED)
        params = init_lm(cfg, gen, device="cpu")
        if cfg.family == "ssm":
            perturb_rwkv(params, gen)
        perturb_lm(params, gen)
        batch = SyntheticStream(cfg, InputShape("t", TRAIN_LAYER_L, 1,
                                                "training"),
                                seed=TRAIN_LAYER_SEED).batch(0, "cpu")
        bundle = get_model(cfg)
        t0 = time.perf_counter()
        for mod in (fm, wkv):
            mod.reset_launch_count()
            mod.reset_bwd_launch_count()
        _, loss, grads = _grads(bundle, params, batch, cfg, cuda)
        torch.cuda.synchronize()
        counts = (fm.launch_count(), fm.bwd_launch_count(),
                  wkv.launch_count(), wkv.bwd_launch_count())
        gradient_gate(f"train-layer {arch} card", grads)
        _, loss_cpu, on_cpu = _grads(bundle, params, batch, cfg, cpu)
        vs_cpu = max(rel_err(g.cpu(), w, floor=0.0)
                     for g, w in zip(grads, on_cpu))
        if cfg.family == "ssm":
            with plain_wkv():
                _, loss_ref, want = _grads(bundle, params, batch, cfg, cuda)
            plain_vs_cpu = max(rel_err(g.cpu(), w, floor=0.0)
                               for g, w in zip(want, on_cpu))
            twin = "the card without K5/K5b"
            log(f"train-layer {arch} against the CPU (not the gate: the t = "
                f"0 group norm's rounding): with K5/K5b {vs_cpu:.3e}, the "
                f"card's plain WKV {plain_vs_cpu:.3e}")
        else:
            loss_ref, want, twin = loss_cpu, on_cpu, "the CPU"
        worst = max(rel_err(g, w.to(g.device), floor=0.0)
                    for g, w in zip(grads, want))
        loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
        log(f"train-layer {arch} 1 layer d={cfg.d_model} fp32 L="
            f"{TRAIN_LAYER_L}: loss {float(loss):.6f} ({twin} "
            f"{float(loss_ref):.6f}, rel {loss_err:.2e}), worst gradient "
            f"max|d|/max|ref| against {twin} {worst:.3e} over {len(grads)} "
            f"tensors (tol {TRAIN_TOL}), launches K1 {counts[0]}, K1b "
            f"{counts[1]}, K5 {counts[2]}, K5b {counts[3]}, "
            f"{time.perf_counter() - t0:.1f} s")
        if not (worst <= TRAIN_TOL and loss_err <= TRAIN_TOL
                and counts == expected):
            fail(f"train-layer {arch}: worst {worst} loss {loss_err} "
                 f"launches {counts} (expected {expected})")
        worst_all = max(worst_all, worst)
        del params, grads, want, on_cpu
    results["train_layer_err"] = worst_all


@contextlib.contextmanager
def plain_wkv():
    """The rwkv6 layers' WKV scan through K5's plain version
    (``rwkv6_wkv_heads_plain``, differentiated by autograd) on any device,
    in place of ``rwkv6_wkv_heads`` (K5 forward, K5b backward): the card's
    twin of a layer without its kernels.  Degree 1 only."""
    from repro_torch.models import lm
    wkv = wkv_module()
    real = lm.rwkv6_wkv_heads
    lm.rwkv6_wkv_heads = wkv.rwkv6_wkv_heads_plain
    try:
        yield
    finally:
        lm.rwkv6_wkv_heads = real


def run_launcher(arch: str, extra: list) -> dict:
    """``python -m repro_torch.launch.train --arch <arch> --steps
    TRAIN_STEPS --seq L --batch B --log-every 1 <extra>`` of TRAIN_BL in a
    subprocess on the card: its losses, median step ms, tokens/s, peak GiB,
    (K1, K1b, K5, K5b) launches per step and wall seconds.  Fails unless
    it exits 0 and prints every line."""
    import re
    b, l = TRAIN_BL
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--steps", str(TRAIN_STEPS), "--seq", str(l), "--batch", str(b),
           "--log-every", "1", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        fail(f"train {arch}: the launcher exited {proc.returncode}")
    losses = [float(x) for x in re.findall(r"step +\d+ loss (\S+)",
                                           proc.stdout)]
    summary = re.search(r"median step ([\d.]+) ms .* ([\d.]+) tokens/s, "
                        r"peak memory ([\d.]+) GiB", proc.stdout)
    kern = re.search(r"flash_mqkv ([\d.]+) and flash_mqkv_bwd ([\d.]+), "
                     r"rwkv6_wkv ([\d.]+) and rwkv6_wkv_bwd ([\d.]+) "
                     r"launches per step", proc.stdout)
    if (len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses))
            or summary is None or kern is None):
        fail(f"train {arch}: losses {losses}, summary {summary}, kernels "
             f"{kern}")
    return dict(losses=losses, step_ms=float(summary.group(1)),
                tokens_s=float(summary.group(2)),
                peak_gib=float(summary.group(3)),
                counts=tuple(float(x) for x in kern.groups()), wall=wall)


def train_launcher(results: dict, card: str) -> None:
    """Phase train: ``python -m repro_torch.launch.train --arch qwen2-1.5b
    --steps 5 --seq 1024 --batch 4`` in a subprocess, at full width and
    depth in bf16 (remat "full"), every step logged: every loss finite;
    56 K1 and 28 K1b launches per step (28 layers, each forward run again
    in the backward); the checkpoint loads into the model's tree, holds
    parameters that moved from the seed-0 init, and saves back to the same
    arrays bit for bit."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import tree_leaves

    b, l = TRAIN_BL
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(pathlib.Path(tmp) / "ck")
        run = run_launcher("qwen2-1.5b", ["--ckpt", ck])
        k1, k1b, k5, k5b = run["counts"]
        cfg = get_config("qwen2-1.5b")
        init = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
        back = checkpoint.load(ck, {"params": init, "step": 0})
        moved = sum(not torch.equal(a, c) for a, c in
                    zip(tree_leaves(init), tree_leaves(back["params"])))
        checkpoint.save(ck + "2", back)
        first, second = np.load(ck + ".npz"), np.load(ck + "2.npz")
        same = (sorted(first.files) == sorted(second.files) and all(
            np.array_equal(first[f], second[f]) for f in first.files))
        n = len(tree_leaves(init))
        del init, back
    torch.cuda.empty_cache()
    log(f"train qwen2-1.5b {cfg.n_layers} layers bf16 B={b} L={l}: losses "
        f"{[round(x, 4) for x in run['losses']]}, median step "
        f"{run['step_ms']} ms, {run['tokens_s']:.0f} tokens/s, peak "
        f"{run['peak_gib']} GiB, K1 {k1:g} and K1b {k1b:g} launches per "
        f"step, {moved} of {n} parameter tensors moved, checkpoint round "
        f"trip bitwise {same}, subprocess {run['wall']:.1f} s [{card}]")
    if (k1 != 2 * cfg.n_layers or k1b != cfg.n_layers or k5 or k5b
            or not moved or not same):
        fail(f"train: launches {run['counts']} moved {moved} round trip "
             f"{same}")
    results["train_k1b_launches"] = round(k1b * TRAIN_STEPS)
    results["train_run"] = run


def train_family(results: dict, card: str, arch: str) -> None:
    """Phases train-rwkv6 and train-hymba: ``python -m
    repro_torch.launch.train --arch <arch> --steps 5 --seq 1024 --batch 4``
    in a subprocess, at full width and depth in bf16 (remat "full"), from
    the seed's fresh init: every loss finite, the (K1, K1b, K5, K5b)
    launches per step of TRAIN_FAMILIES; median step time, tokens/s and
    peak memory."""
    from repro_torch.configs import get_config

    b, l = TRAIN_BL
    cfg = get_config(arch)
    run = run_launcher(arch, [])
    log(f"train-{arch.split('-')[0]} {arch} {cfg.n_layers} layers d="
        f"{cfg.d_model} bf16 B={b} L={l}: losses "
        f"{[round(x, 4) for x in run['losses']]}, median step "
        f"{run['step_ms']} ms, {run['tokens_s']:.0f} tokens/s, peak "
        f"{run['peak_gib']} GiB, launches per step K1 {run['counts'][0]:g}, "
        f"K1b {run['counts'][1]:g}, K5 {run['counts'][2]:g}, K5b "
        f"{run['counts'][3]:g}, subprocess {run['wall']:.1f} s [{card}]")
    if run["counts"] != TRAIN_FAMILIES[arch]:
        fail(f"train {arch}: launches per step {run['counts']}, expected "
             f"{TRAIN_FAMILIES[arch]}")
    if arch == "rwkv6-1.6b":
        results["train_k5b_launches"] = round(run["counts"][3] * TRAIN_STEPS)
    results.setdefault("train_degree1", {})[arch] = dict(
        phase=f"train-{arch.split('-')[0]}", step_ms=run["step_ms"],
        tokens_s=run["tokens_s"], peak_gib=run["peak_gib"])


def train_moe(results: dict, card: str) -> None:
    """Phase train-moe: ``Trainer`` (make_train_step, AdamW in place) on
    qwen2-moe-a2.7b at full width (60 routed experts top 4 + 4 shared, d
    2048, untied embeddings) and TRAIN_MOE_LAYERS of its 24 layers (all 24
    need ~14.3 B parameters x 12 B of parameters, gradients and float32
    moments: no one card holds them), bf16, B 4 x L 1024, TRAIN_STEPS
    steps in process: every loss finite, K1 twice and K1b once per layer
    per step (at EP 1 the expert exchange is the identity: no put kernel);
    median step time, tokens/s, peak memory above what was allocated at
    the phase's start (the phase runs in process, after the others)."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train.optimizer import tree_leaves

    b, l = TRAIN_BL
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              n_layers=TRAIN_MOE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, None, SPConfig(strategy="full", sp_axes=("model",),
                                     batch_axes=("data",)),
                 InputShape("cli", l, b, "training"),
                 opt_cfg=AdamWConfig(total_steps=TRAIN_STEPS), device="cuda")
    fm.reset_launch_count()
    fm.reset_bwd_launch_count()
    t0 = time.perf_counter()
    params, history = tr.run(TRAIN_STEPS, log_every=1)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in history]
    step_s = statistics.median(tr.step_seconds[1:])
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    k1, k1b = fm.launch_count() / TRAIN_STEPS, fm.bwd_launch_count() / TRAIN_STEPS
    log(f"train-moe qwen2-moe-a2.7b {cfg.n_layers} of 24 layers d="
        f"{cfg.d_model} bf16, {n_params / 1e9:.3f} B params, B={b} L={l}: "
        f"losses {[round(x, 4) for x in losses]}, median step "
        f"{step_s * 1e3:.1f} ms, {b * l / step_s:.0f} tokens/s, peak "
        f"{peak:.2f} GiB of its own (over the {base / 2**30:.2f} GiB that "
        f"earlier phases held at its start), launches per step K1 {k1:g}, "
        f"K1b {k1b:g}, "
        f"{wall:.1f} s with the init [{card}]")
    if (len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses))
            or k1 != 2 * cfg.n_layers or k1b != cfg.n_layers):
        fail(f"train-moe: losses {losses} K1 {k1} K1b {k1b}")
    results.setdefault("train_degree1", {})["qwen2-moe-a2.7b"] = dict(
        phase=f"train-moe, {cfg.n_layers} of 24 layers",
        step_ms=round(step_s * 1e3, 1), tokens_s=b * l / step_s,
        peak_gib=round(peak, 2))
    del params, tr
    gc.collect()
    torch.cuda.empty_cache()


def train_sp_counts(layout, ranks: int, n_layers: int) -> dict:
    """Launches that one training step over ``n_layers`` layers implies
    under swift_torus (Pull-Q unfused) on ``layout`` with ``ranks`` virtual
    ranks and remat "full" (each layer's forward runs twice, the backward
    once), every put a K4 (two SP axes).  A forward: every ring
    circulation (stage 0, P_u - 1 Pull-Q, P_u - 1 Pull-KV) is P_r - 1 K2
    steps and one K1 step per rank; 3 (P_u - 1) puts (Pull-Q, Pull-KV,
    Push-O).  The backward (core/sp_grad.py): P_r K1b calls per rank; the
    five gathers (q, k, v, o, dO) and three scatters (dq, dk, dv) of
    P_u - 1 puts each, P_r - 1 KV hops and P_r (dK, dV) hops (none at
    P_r 1: the accumulators never leave their owner)."""
    p_u, p_r = layout.p_ulysses, layout.p_ring
    circ = 1 + 2 * (p_u - 1)
    puts = (2 * 3 * (p_u - 1) + 8 * (p_u - 1) + (p_r - 1)
            + (p_r if p_r > 1 else 0))
    return {"flash_mqkv": n_layers * 2 * ranks * circ,
            "ring_flash_step": n_layers * 2 * ranks * circ * (p_r - 1),
            "flash_mqkv_bwd": n_layers * ranks * p_r,
            "remote_put": 0, "landing_copy": n_layers * puts}


def train_sp(results: dict, card: str) -> None:
    """Phase train-sp: training over the virtual mesh TRAIN_SP_MESH, SP
    over both axes, swift_torus, comm_backend "pallas" (every put a K4):
    the backward of the SP schedule (core/sp_grad.py) through K1b per KV
    chunk and K4 for every transfer.

    (a) One full-width float32 qwen2-1.5b layer plus the loss (vocab cut to
    TRAIN_LAYER_VOCAB, B 1 x L TRAIN_LAYER_L, seed TRAIN_LAYER_SEED as
    train-layer): every parameter's gradient over the mesh within
    TRAIN_TOL of that tensor's max|grad| at degree 1 on the card, the
    gradient gate, the launches ``train_sp_counts`` implies; then a
    negative control, one ring step's (dK, dV) dropped in every backward,
    that must break TRAIN_TOL.  (K1b at these ring steps' shapes and
    statistics: K1B_CASES in phase k1b.)
    (b) qwen2-1.5b at full width and depth, bf16, B 4 x L 1024,
    Trainer in process from the seed's init: the gradient gate on step
    0's parameters and batch, one warm-up step, TRAIN_SP_STEPS timed
    steps; every loss finite, step 0's within TRAIN_SP_LOSS_TOL of the
    degree-1 loss on the same parameters and batch, the launches per step
    ``train_sp_counts`` implies; step time, tokens/s and peak memory
    beside the degree-1 train phase's; the phase within TRAIN_SP_BUDGET_S."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SPConfig, sp_grad
    from repro_torch.core.strategy import resolve_layout
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, get_model, init_lm
    from repro_torch.train import AdamWConfig, SyntheticStream, Trainer
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    mesh = make_mesh(*TRAIN_SP_MESH, device="cuda")
    sp = sp_config(TRAIN_SP_MESH[1])
    ranks = mesh.axes_size(sp.sp_axes)

    def counts_now():
        c = read_counts()
        c["flash_mqkv_bwd"] = fm.bwd_launch_count()
        return c

    def reset_all():
        reset_counts()
        fm.reset_bwd_launch_count()

    # (a) one fp32 layer: over the mesh against degree 1, both on the card
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=1,
                              dtype="float32", vocab=TRAIN_LAYER_VOCAB)
    layout = resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
    log(f"train-sp mesh {dict(mesh.shape)} of virtual ranks, SP over "
        f"{sp.sp_axes}: swift_torus P_u {layout.p_ulysses} x P_r "
        f"{layout.p_ring} for {cfg.n_heads} / {cfg.n_kv_heads} heads")
    if layout.p_ulysses < 2 or layout.p_ring < 2:
        fail(f"train-sp: layout {layout} lacks a Ulysses or a ring leg")
    gen = torch.Generator().manual_seed(TRAIN_LAYER_SEED)
    params = init_lm(cfg, gen, device="cpu")
    perturb_lm(params, gen)
    batch = SyntheticStream(cfg, InputShape("t", TRAIN_LAYER_L, 1, "training"),
                            seed=TRAIN_LAYER_SEED).batch(0, "cpu")
    bundle = get_model(cfg)
    _, loss1, want = _grads(bundle, params, batch, cfg, cuda)
    reset_all()
    _, loss_sp, got = _grads(bundle, params, batch, cfg, cuda, mesh=mesh,
                             sp=sp)
    torch.cuda.synchronize()
    counts, expected = counts_now(), train_sp_counts(layout, ranks, 1)
    gradient_gate("train-sp layer", got)
    worst = max(rel_err(g, w, floor=0.0) for g, w in zip(got, want))
    loss_err = abs(float(loss_sp) - float(loss1)) / abs(float(loss1))

    real, calls = sp_grad.flash_mqkv_bwd, [0]

    def dropping(*args, **kw):  # zero ring step 1's (dK, dV) of each call
        dq, dk, dv = real(*args, **kw)
        step = calls[0] // ranks % layout.p_ring
        calls[0] += 1
        if step == 1:
            return dq, torch.zeros_like(dk), torch.zeros_like(dv)
        return dq, dk, dv

    sp_grad.flash_mqkv_bwd = dropping
    try:
        _, _, dropped = _grads(bundle, params, batch, cfg, cuda, mesh=mesh,
                               sp=sp)
    finally:
        sp_grad.flash_mqkv_bwd = real
    control = max(rel_err(g, w, floor=0.0) for g, w in zip(dropped, want))
    log(f"train-sp layer qwen2-1.5b 1 layer d={cfg.d_model} fp32 B=1 L="
        f"{TRAIN_LAYER_L} over {ranks} ranks: loss {float(loss_sp):.6f} "
        f"(degree 1 {float(loss1):.6f}, rel {loss_err:.2e}), worst gradient "
        f"max|d|/max|ref| against degree 1 on the card {worst:.3e} over "
        f"{len(got)} tensors (tol {TRAIN_TOL}); negative control (ring step "
        f"1's dK/dV dropped) {control:.3e} (must exceed {TRAIN_TOL}); "
        f"launches {counts} (expected {expected})")
    if not (worst <= TRAIN_TOL and loss_err <= TRAIN_TOL
            and control > TRAIN_TOL and counts == expected):
        fail(f"train-sp layer: worst {worst}, loss {loss_err}, control "
             f"{control}, launches {counts} (expected {expected})")
    del params, got, want, dropped
    results["train_sp_layer_err"] = worst

    # (b) full width, bf16, in process
    b, l = TRAIN_BL
    cfg = get_config("qwen2-1.5b")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, mesh, sp, InputShape("cli", l, b, "training"),
                 opt_cfg=AdamWConfig(total_steps=1 + TRAIN_SP_STEPS))
    params, opt = tr.setup()
    bundle = get_model(cfg)
    batch0 = tr.stream.batch(0, cuda)
    with torch.no_grad():
        loss1, _ = bundle.loss(params, batch0, cfg, ParallelContext(
            SPConfig(strategy="full"), "train", cuda))
    loss_gate, _ = bundle.loss(params, batch0, cfg,
                               ParallelContext(sp, "train", mesh=mesh))
    gradient_gate("train-sp", torch.autograd.grad(
        loss_gate, tree_leaves(params), allow_unused=True))
    losses, times = [], []
    for step in range(1 + TRAIN_SP_STEPS):  # step 0: the warm-up
        if step == 1:
            reset_all()
        ts = time.perf_counter()
        params, opt, metrics = tr.step_fn(params, opt,
                                          tr.stream.batch(step, cuda))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(float(metrics["loss"]))
    counts = {k: n / TRAIN_SP_STEPS for k, n in counts_now().items()}
    expected = train_sp_counts(layout, ranks, cfg.n_layers)
    step_s = statistics.median(times[1:])
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    loss0_err = abs(losses[0] - float(loss1)) / abs(float(loss1))
    deg1 = results["train_run"]
    log(f"train-sp qwen2-1.5b {cfg.n_layers} layers d={cfg.d_model} bf16 B={b} "
        f"L={l} over {ranks} ranks (P_u {layout.p_ulysses} x P_r "
        f"{layout.p_ring}): losses {[round(x, 4) for x in losses]} (step 0 "
        f"{losses[0]:.6f}, degree 1 on the same parameters and batch "
        f"{float(loss1):.6f}, rel {loss0_err:.2e}, tol {TRAIN_SP_LOSS_TOL}), "
        f"median step {step_s * 1e3:.1f} ms over {TRAIN_SP_STEPS} steps "
        f"(warm-up {times[0]:.2f} s), {b * l / step_s:.0f} tokens/s, peak "
        f"{peak:.2f} GiB of its own; degree 1 (train): {deg1['step_ms']} ms, "
        f"{deg1['tokens_s']:.0f} tokens/s, {deg1['peak_gib']} GiB [{card}]")
    phase_s = time.perf_counter() - t_phase
    log(f"train-sp launches per step {counts} (expected {expected}); phase "
        f"{phase_s:.1f} s (budget {TRAIN_SP_BUDGET_S} s)")
    if (not all(map(math.isfinite, losses)) or loss0_err > TRAIN_SP_LOSS_TOL
            or counts != expected or phase_s > TRAIN_SP_BUDGET_S):
        fail(f"train-sp: losses {losses}, step 0 vs degree 1 {loss0_err}, "
             f"launches {counts} (expected {expected}), phase {phase_s} s")
    results["train_sp_launches"] = {k: round(n * TRAIN_SP_STEPS)
                                    for k, n in counts.items()}
    del params, opt, tr
    gc.collect()
    torch.cuda.empty_cache()


def train_sp_family_counts(cfg, layout, ranks: int, ep: int) -> dict:
    """Launches that one training step of ``cfg`` (remat "full": each
    layer's forward runs twice, the backward once) implies over ``ranks``
    virtual ranks, every put of SP attention a K4 (two SP axes): per
    attention call (none for rwkv6; one per hymba or moe layer; whisper's
    encoder self-attention and decoder self- and cross-attention) what
    ``train_sp_counts`` says; for rwkv6, K5 per rank and forward and K5b
    per rank; for the moe family at EP ``ep``, the expert exchange on
    'model' (one axis: K3), ep - 1 puts for each of its three exchanges
    (tokens, expert ids, outputs) per forward and for the backward of the
    two that carry a gradient (tokens, outputs).  The token shifts and
    the state passes of rwkv6 and hymba are plain copies (the reference's
    ``lax.ppermute``), forward and backward: no put kernel."""
    layers = cfg.n_layers
    calls = {"ssm": 0, "audio": cfg.encoder_layers + 2 * layers}.get(
        cfg.family, layers)
    counts = (train_sp_counts(layout, ranks, calls) if calls else
              dict.fromkeys(("flash_mqkv", "ring_flash_step",
                             "flash_mqkv_bwd", "remote_put",
                             "landing_copy"), 0))
    ssm = cfg.family == "ssm"
    counts["rwkv6_wkv"] = 2 * ranks * layers if ssm else 0
    counts["rwkv6_wkv_bwd"] = ranks * layers if ssm else 0
    if cfg.family == "moe":
        counts["remote_put"] = (2 * 3 + 2) * (ep - 1) * layers
    return counts


def leaf_names(tree, prefix: str = "") -> list:
    """Paths of ``tree_leaves(tree)``, in its order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def family_grad_gap(cfg, names, got, want) -> tuple[float, str]:
    """(the largest max|d| / max|ref| over the leaves, its leaf).  Without
    rotary positions (whisper) a K bias's gradient is 0 in exact
    arithmetic (it shifts a row of scores by a constant), so both sides
    hold rounding there: that leaf's max|d| is taken over the largest
    max|ref| of any leaf, as tests/test_torch_train_sp.py does."""
    top = max(float(w.abs().max()) for w in want)
    worst = (0.0, "")
    for name, g, w in zip(names, got, want):
        if cfg.rope in ("none", "sinusoidal") and name.endswith("wk/b"):
            e = float((g - w).abs().max()) / top
        else:
            e = rel_err(g, w, floor=0.0)
        worst = max(worst, (e, name))
    return worst


@contextlib.contextmanager
def detached_puts():
    """Every channel put outside SP attention (whose forward runs without
    a gradient and whose backward is its own) delivers buffers without a
    gradient function: what the put kernels gave before a put had a
    gradient (comm/grad.py)."""
    import torch
    from repro_torch.comm import grad as put_grad
    real = put_grad.put_with_grad

    def detached(channel, issue, tensors):
        with torch.no_grad():
            return issue(tuple(tensors))

    put_grad.put_with_grad = detached
    try:
        yield
    finally:
        put_grad.put_with_grad = real


def _family_layer(arch: str):
    """(cfg, params on the CPU, batch on the CPU) of train-sp-families'
    float32 layer of ``arch``: one layer (whisper: one encoder and one
    decoder layer) at full width, the LMs' vocabulary cut to
    TRAIN_LAYER_VOCAB, the MoE at capacity TRAIN_SP_NO_DROP without its
    load-balance loss (see TRAIN_SP_FAMILIES), constants
    perturbed, the rwkv6 decays from RWKV6's range, all from
    TRAIN_LAYER_SEED; B 1 x TRAIN_LAYER_L tokens, whisper B 1 x its 1536
    frames x WHISPER_BL[1] tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.models import init_lm, init_whisper
    from repro_torch.train import SyntheticStream

    gen = torch.Generator().manual_seed(TRAIN_LAYER_SEED)
    cfg = dataclasses.replace(get_config(arch), n_layers=1, dtype="float32")
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_layers=1)
        params = init_whisper(cfg, gen, device="cpu")
        perturb_dense(params, gen)
        l = WHISPER_BL[1]
        tokens = torch.randint(0, cfg.vocab, (1, l), generator=gen)
        batch = {"frames": torch.randn((1, cfg.encoder_seq, cfg.d_model),
                                       generator=gen) * 0.5,
                 "tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
        return cfg, params, batch
    cfg = dataclasses.replace(cfg, vocab=TRAIN_LAYER_VOCAB)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=TRAIN_SP_NO_DROP, router_aux_coef=0.0))
    ep = TRAIN_SP_MESH[0][TRAIN_SP_MESH[1].index("model")]
    params = init_lm(cfg, gen, device="cpu",
                     ep_degree=ep if cfg.family == "moe" else 1)
    if cfg.family == "ssm":
        perturb_rwkv(params, gen)
    perturb_lm(params, gen)
    batch = SyntheticStream(cfg, InputShape("t", TRAIN_LAYER_L, 1, "training"),
                            seed=TRAIN_LAYER_SEED).batch(0, "cpu")
    return cfg, params, batch


def train_sp_families(results: dict, card: str) -> None:
    """Phase train-sp-families: rwkv6-1.6b, hymba-1.5b, qwen2-moe-a2.7b and
    whisper-tiny trained over the virtual mesh TRAIN_SP_MESH, SP over both
    axes, swift_torus, comm_backend "pallas": SP attention through
    core/sp_grad.py (K1/K2 forward, K1b backward, K4 puts), and every
    other transfer a differentiable put (comm/grad.py): the token shifts
    and state passes of rwkv6 and hymba, plain copies both ways, and the
    MoE's expert exchange at EP 2 over 'model', K3 both ways.

    (a) One full-width float32 layer of each (``_family_layer``): every
    parameter's gradient over the mesh within TRAIN_TOL of that tensor's
    max|grad| at degree 1 on the card (whisper's K biases, 0 in exact
    arithmetic, of the largest: ``family_grad_gap``)
    (K5/K5b on both sides for rwkv6), the loss too; the gradient gate; the
    launches ``train_sp_family_counts`` implies; for rwkv6, hymba and the
    MoE a negative control, every put outside SP attention detached
    (``detached_puts``), that must break that tolerance.
    (b) rwkv6-1.6b at full width and depth and qwen2-moe-a2.7b at
    TRAIN_SP_FAMILY_LAYERS of its 24 layers (EP 2), bf16, B 4 x L 1024,
    remat "full", Trainer in process from the seed's init (rwkv6's
    zero-initialised tensors drawn as ``perturb_rwkv`` draws them: at the
    fresh init wlora_a has no gradient): the gradient
    gate on step 0's parameters and batch, one warm-up step,
    TRAIN_SP_STEPS timed steps; every loss finite, step 0's within
    TRAIN_SP_LOSS_TOL of the degree-1 loss on the same parameters and
    batch, the launches per step the counts imply; step time, tokens/s
    and peak memory beside train-rwkv6's and train-moe's degree 1.  The
    phase fails past TRAIN_SP_FAMILIES_BUDGET_S."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SPConfig
    from repro_torch.core.strategy import resolve_layout
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, get_model
    from repro_torch.models.moe import ep_degree
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train.optimizer import tree_leaves, tree_map
    wkv = wkv_module()

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    mesh = make_mesh(*TRAIN_SP_MESH, device="cuda")
    sp = sp_config(TRAIN_SP_MESH[1])
    ranks, ep = mesh.axes_size(sp.sp_axes), ep_degree(mesh)

    def counts_now():
        c = read_counts()
        c["flash_mqkv_bwd"] = fm.bwd_launch_count()
        c["rwkv6_wkv"] = wkv.launch_count()
        c["rwkv6_wkv_bwd"] = wkv.bwd_launch_count()
        return c

    def reset_all():
        reset_counts()
        for mod in (fm, wkv):
            mod.reset_bwd_launch_count()
        wkv.reset_launch_count()

    def expected(cfg):
        layout = (resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
                  if cfg.family != "ssm" else None)
        return train_sp_family_counts(cfg, layout, ranks, ep), layout

    # (a) one float32 layer of each family: over the mesh against degree 1
    total = dict.fromkeys(counts_now(), 0)
    for arch in TRAIN_SP_FAMILIES:
        t0 = time.perf_counter()
        cfg, params, batch = _family_layer(arch)
        bundle = get_model(cfg)
        names = leaf_names(params)
        want_counts, layout = expected(cfg)
        _, loss1, want = _grads(bundle, params, batch, cfg, cuda)
        reset_all()
        _, loss_sp, got = _grads(bundle, params, batch, cfg, cuda, mesh=mesh,
                                 sp=sp)
        torch.cuda.synchronize()
        counts = counts_now()
        total = {k: total[k] + n for k, n in counts.items()}
        gradient_gate(f"train-sp-families {arch}", got)
        tol = TRAIN_TOL
        worst, where = family_grad_gap(cfg, names, got, want)
        loss_err = abs(float(loss_sp) - float(loss1)) / abs(float(loss1))
        control = None
        if cfg.family != "audio":
            with detached_puts():
                _, _, dropped = _grads(bundle, params, batch, cfg, cuda,
                                       mesh=mesh, sp=sp)
            control, _ = family_grad_gap(cfg, names, dropped, want)
            del dropped
        plan = ("" if layout is None else f", swift_torus P_u "
                f"{layout.p_ulysses} x P_r {layout.p_ring}")
        depth = (f"{cfg.encoder_layers} + {cfg.n_layers} layers"
                 if cfg.family == "audio" else "1 layer")
        log(f"train-sp-families {arch} {depth} d={cfg.d_model} fp32 over "
            f"{ranks} ranks{plan}"
            + (f", EP {ep} capacity {TRAIN_SP_NO_DROP}, no load-balance "
               "loss" if cfg.family == "moe" else "")
            + f": loss {float(loss_sp):.6f} (degree 1 {float(loss1):.6f}, "
            f"rel {loss_err:.2e}), worst gradient max|d|/max|ref| against "
            f"degree 1 on the card {worst:.3e} ({where}) over {len(got)} "
            f"tensors (tol {tol})"
            + ("" if control is None else
               f"; negative control (puts outside SP attention detached) "
               f"{control:.3e} (must exceed {tol})")
            + f"; launches {counts} (expected {want_counts}); "
            f"{time.perf_counter() - t0:.1f} s")
        if not (worst <= tol and loss_err <= tol and counts == want_counts
                and (control is None or control > tol)):
            fail(f"train-sp-families {arch}: worst {worst}, loss {loss_err}, "
                 f"control {control}, launches {counts} (expected "
                 f"{want_counts})")
        results.setdefault("train_sp_families_err", {})[arch] = worst
        del params, got, want
    # every kernel of the path ran in (a)
    idle = [k for k, n in total.items() if n <= 0]
    if idle:
        fail(f"train-sp-families: {idle} never launched")
    results["train_sp_families_launches"] = total

    # (b) bf16 steps through the Trainer, in process
    b, l = TRAIN_BL
    runs = {}
    for arch, layers in TRAIN_SP_FAMILY_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, mesh, sp, InputShape("cli", l, b, "training"),
                     opt_cfg=AdamWConfig(total_steps=1 + TRAIN_SP_STEPS))
        params, opt = tr.setup()
        if cfg.family == "ssm":
            # at the fresh init the LoRA's wlora_b is 0, so wlora_a has no
            # gradient: draw the tensors init leaves at zero, in place
            drawn = tree_map(lambda t: t.detach().clone(), params)
            perturb_rwkv(drawn, torch.Generator(device=cuda).manual_seed(
                TRAIN_LAYER_SEED))
            with torch.no_grad():
                for t, d in zip(tree_leaves(params), tree_leaves(drawn)):
                    t.copy_(d)
            del drawn
        bundle = get_model(cfg)
        batch0 = tr.stream.batch(0, cuda)
        with torch.no_grad():
            loss1, _ = bundle.loss(params, batch0, cfg, ParallelContext(
                SPConfig(strategy="full"), "train", cuda))
        loss_gate, _ = bundle.loss(params, batch0, cfg,
                                   ParallelContext(sp, "train", mesh=mesh))
        gradient_gate(f"train-sp-families {arch}", torch.autograd.grad(
            loss_gate, tree_leaves(params), allow_unused=True))
        del loss_gate
        losses, times = [], []
        for step in range(1 + TRAIN_SP_STEPS):  # step 0: the warm-up
            if step == 1:
                reset_all()
            ts = time.perf_counter()
            params, opt, metrics = tr.step_fn(params, opt,
                                              tr.stream.batch(step, cuda))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - ts)
            losses.append(float(metrics["loss"]))
        counts = {k: n / TRAIN_SP_STEPS for k, n in counts_now().items()}
        want_counts, layout = expected(cfg)
        step_s = statistics.median(times[1:])
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        loss0_err = abs(losses[0] - float(loss1)) / abs(float(loss1))
        deg1 = results["train_degree1"][arch]
        cut = (f"{layers} of {get_config(arch).n_layers} layers"
               if layers < get_config(arch).n_layers else f"{layers} layers")
        log(f"train-sp-families {arch} {cut} d={cfg.d_model} bf16 B={b} "
            f"L={l} over {ranks} ranks"
            + (f" (EP {ep})" if cfg.family == "moe" else "")
            + f": losses {[round(x, 4) for x in losses]} (step 0 "
            f"{losses[0]:.6f}, degree 1 on the same parameters and batch "
            f"{float(loss1):.6f}, rel {loss0_err:.2e}, tol "
            f"{TRAIN_SP_LOSS_TOL}), median step {step_s * 1e3:.1f} ms over "
            f"{TRAIN_SP_STEPS} steps (warm-up {times[0]:.2f} s), "
            f"{b * l / step_s:.0f} tokens/s, peak {peak:.2f} GiB of its own; "
            f"degree 1 ({deg1['phase']}): {deg1['step_ms']} ms, "
            f"{deg1['tokens_s']:.0f} tokens/s, {deg1['peak_gib']} GiB; "
            f"launches per step {counts} (expected {want_counts}) [{card}]")
        if (not all(map(math.isfinite, losses))
                or loss0_err > TRAIN_SP_LOSS_TOL or counts != want_counts):
            fail(f"train-sp-families {arch}: losses {losses}, step 0 vs "
                 f"degree 1 {loss0_err}, launches {counts} (expected "
                 f"{want_counts})")
        runs[arch] = dict(step_ms=round(step_s * 1e3, 1), peak_gib=peak)
        del params, opt, tr, batch0
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"train-sp-families phase {phase_s:.1f} s (budget "
        f"{TRAIN_SP_FAMILIES_BUDGET_S} s)")
    if phase_s > TRAIN_SP_FAMILIES_BUDGET_S:
        fail(f"train-sp-families: phase {phase_s} s over its budget")
    results["train_sp_families_runs"] = runs


def train_breakdown(card: str, arch: str = "qwen2-1.5b",
                    n_layers: int | None = None, mesh_shape=None) -> None:
    """Phase train-breakdown: one training step of ``arch`` (qwen2-1.5b in
    the phase; scripts/train_trace.py passes the others) as the train
    phases run it (full width, all layers or ``n_layers``, bf16, B 4 x L
    1024, remat "full"; over the virtual mesh ``mesh_shape`` (shape,
    axes) as train-sp runs it when given), in process after two warm
    steps, traced by torch.profiler: wall ms, device busy ms and the idle
    share, and the device ms of K1 (K2 too: they share the kernel), K1b
    (every launch of its bf16 body), K5, K5b, K3/K4, the GEMMs and the
    rest, and the top kernels; then AdamW alone on the step's gradients
    (CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SPConfig
    from repro_torch.launch import make_mesh
    from repro_torch.models import ParallelContext, get_model
    from repro_torch.train import (AdamWConfig, SyntheticStream, adamw_update,
                                   init_adamw, make_train_step)
    from repro_torch.train.optimizer import tree_leaves, tree_map

    b, l = TRAIN_BL
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    bundle = get_model(cfg)
    params = bundle.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS)
    opt = init_adamw(params)
    mesh = (make_mesh(*mesh_shape, device=dev) if mesh_shape is not None
            else None)
    sp = (sp_config(mesh_shape[1]) if mesh_shape is not None
          else SPConfig(strategy="full"))
    step = make_train_step(cfg, mesh, sp, opt_cfg, device=dev)
    batch = SyntheticStream(cfg, InputShape("t", l, b, "training")).batch(
        0, dev)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    ms = lambda names: sum(e.self_device_time_total for e in kernels
                           if any(n in e.key for n in names)) / 1e3
    busy = ms(("",))
    label = f"{arch} ({cfg.n_layers} layers" + (
        f", mesh {dict(mesh.shape)})" if mesh is not None else ")")
    if busy == 0.0:
        log(f"train-breakdown {label}: wall {wall:.1f} ms; the profiler saw "
            f"no device time (shares not measured) [{card}]")
    else:
        k1 = ms(("flash_hopper_kernel", "flash_f32_kernel"))
        k1b = ms(K1B_KERNELS)
        # K5b's three entries wkv_bwd_chain<, wkv_bwd_chunk<, wkv_bwd_du
        k5, k5b = ms(("wkv_kernel<",)), ms(("wkv_bwd_",))
        gemm = ms(("gemm", "Gemm", "nvjet", "cutlass", "xmma"))
        puts = ms(("remote_put_kernel", "landing_copy_kernel"))
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        parts = (("K1b", k1b), ("K5b", k5b), ("GEMMs", gemm), ("K1", k1),
                 ("K5", k5), ("K3/K4", puts))
        log(f"train-breakdown {label} bf16 B={b} L={l}: step wall "
            f"{wall:.1f} ms; device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall:.3f}; " + ", ".join(
                f"{name} {t:.2f} ms ({t / busy:.3f})" for name, t in parts)
            + f", the rest {busy - sum(t for _, t in parts):.2f} ms; "
            "top kernels: " + "; ".join(
                f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f}"
                f" ms" for e in top) + f" [{card}]")
    # AdamW alone, on gradients of the step's shapes
    loss, _ = bundle.loss(params, batch, cfg, ParallelContext(
        sp, "train", dev, mesh=mesh))
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    grads = tree_map(lambda _: next(grads), params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    adamw_update(opt_cfg, grads, opt, params)
    end.record()
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"train-breakdown AdamW over {n / 1e9:.3f} B parameters (bf16, "
        f"float32 moments): {start.elapsed_time(end):.2f} ms [{card}]")
    del params, opt, grads, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_curve(results: dict, card: str) -> None:
    """Phase train-curve: Trainer on the reduced qwen2-1.5b (float32) at
    the CPU test's config on the card: CURVE_STEPS steps, lr 3e-3, warmup
    5; the last loss below the first by more than 0.2."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.train import AdamWConfig, Trainer

    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), dtype="float32",
                              sharding_overrides=())
    tr = Trainer(cfg, None, SPConfig(strategy="full"),
                 InputShape("tiny_train", 64, 4, "training"),
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
                 device="cuda")
    fm.reset_launch_count()
    fm.reset_bwd_launch_count()
    t0 = time.perf_counter()
    _, history = tr.run(CURVE_STEPS, log_every=10)
    wall = time.perf_counter() - t0
    first, last = history[0]["loss"], history[-1]["loss"]
    k1, k1b = fm.launch_count(), fm.bwd_launch_count()
    log(f"train-curve qwen2-1.5b reduced fp32: loss {first:.4f} -> "
        f"{last:.4f} in {CURVE_STEPS} steps (must fall by > 0.2), K1 {k1}, "
        f"K1b {k1b} launches, median step "
        f"{1e3 * median(tr.step_seconds[1:]):.2f} ms, {wall:.1f} s [{card}]")
    if not (math.isfinite(last) and last < first - 0.2
            and k1b == CURVE_STEPS * cfg.n_layers):
        fail(f"train-curve: {first} -> {last}, K1b {k1b}")


def whisper_phase(results: dict, card: str) -> None:
    """Phase whisper: whisper-tiny at full width (encoder_seq 1536, d 384,
    4 + 4 layers), B 4 x decoder L 448, perturbed biases and norms:
    (a) float32 logits on the card (K1 in the encoder, the decoder's self-
    and cross-attention) against the CPU's within TRAIN_TOL of max|logits|;
    (b) teacher-forced decode on the card through bundle.step with caches
    against the card's prefill, within TRAIN_TOL; (c) one bf16 train step
    on the card: the gradient gate, a finite loss, 12 K1b launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.models import ParallelContext, get_model, init_whisper
    from repro_torch.models import whisper as wh
    from repro_torch.train import AdamWConfig, adamw_update, init_adamw
    from repro_torch.train.optimizer import tree_map

    b, l = WHISPER_BL
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
    bundle = get_model(cfg)
    gen = torch.Generator().manual_seed(41)
    params = init_whisper(cfg, gen, device="cpu")
    perturb_dense(params, gen)
    batch = {"frames": torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                   generator=gen) * 0.5,
             "tokens": torch.randint(0, cfg.vocab, (b, l), generator=gen)}
    sp = SPConfig(strategy="full")
    t0 = time.perf_counter()
    pc = _cast(params, device=dev)
    bc = {k: v.to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        fm.reset_launch_count()
        card_logits = bundle.apply(pc, bc, cfg, ParallelContext(sp, device=dev))
        torch.cuda.synchronize()
        k1 = fm.launch_count()
        cpu_logits = bundle.apply(params, batch, cfg,
                                  ParallelContext(sp, device="cpu"))
        err = rel_err(card_logits.cpu(), cpu_logits, floor=0.0)
        del cpu_logits
        memory = wh.encode(pc, bc["frames"], cfg, ParallelContext(sp,
                                                                  device=dev))
        ctx = ParallelContext(sp, "decode", dev)
        caches = wh.init_whisper_caches(cfg, b, l, torch.float32, dev)
        steps = []
        t1 = time.perf_counter()
        for t in range(l):
            logit, caches = bundle.step(pc, {"tokens": bc["tokens"][:, t:t + 1],
                                             "encoder_out": memory},
                                        caches, t, cfg, ctx)
            steps.append(logit)
        dec_err = rel_err(torch.stack(steps, 1), card_logits, floor=0.0)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
    log(f"whisper-tiny d={cfg.d_model} {cfg.encoder_layers}+{cfg.n_layers} "
        f"layers fp32 B={b} frames={cfg.encoder_seq} L={l}: card vs CPU "
        f"max|d|/max|ref| {err:.3e} (tol {TRAIN_TOL}), K1 launches {k1}; "
        f"teacher-forced decode ({l} steps, {dec_s:.1f} s) vs prefill "
        f"{dec_err:.3e} (tol {TRAIN_TOL}) [{card}]")
    if not (err <= TRAIN_TOL and dec_err <= TRAIN_TOL
            and k1 == cfg.encoder_layers + 2 * cfg.n_layers):
        fail(f"whisper: card vs CPU {err}, decode {dec_err}, K1 {k1}")
    del pc, memory, caches, steps, card_logits
    # (c) a bf16 train step at the same shape
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    batch16 = dict(frames=bc["frames"].to(torch.bfloat16), tokens=bc["tokens"],
                   labels=torch.roll(bc["tokens"], -1, dims=1))
    params16 = _cast(params, device=dev, dtype=torch.bfloat16)
    fm.reset_bwd_launch_count()
    p, loss, grads = _grads(bundle, params16, batch16, cfg16, dev)
    torch.cuda.synchronize()
    k1b = fm.bwd_launch_count()
    gradient_gate("whisper train step", grads)
    it = iter(grads)
    opt = AdamWConfig()
    _, state, metrics = adamw_update(opt, tree_map(lambda _: next(it), p),
                                     init_adamw(p, opt), p)
    gnorm = float(metrics["grad_norm"])
    log(f"whisper train step bf16: loss {float(loss):.4f}, grad norm "
        f"{gnorm:.4f}, K1b launches {k1b}, {time.perf_counter() - t0:.1f} s "
        f"in the phase [{card}]")
    if not (math.isfinite(float(loss)) and math.isfinite(gnorm)
            and k1b == cfg.encoder_layers + 2 * cfg.n_layers):
        fail(f"whisper train step: loss {float(loss)} gnorm {gnorm} K1b {k1b}")
    del p, grads, state, params16
    torch.cuda.empty_cache()


def k1b_numbers(card: str) -> dict:
    """K1b (bf16) at the qwen2 training shape and the whisper cross-
    attention shape: ms per call beside its bound (5 products of 2·D
    operations per visible pair at the bf16 peak, against reading q, k, v,
    o, dO, m, l and writing dq, dk, dv once at the HBM rate), its plain
    version and SDPA's backward (the gradient of one SDPA forward, the
    forward excluded)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.kernels.ref import flash_mqkv_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for case in K1B_CASES[:2]:
        label, bh, bhkv, lq, lk, d, causal, window = case[:8]
        args, kw = k1b_inputs(gen, case, torch.bfloat16)
        q, k, v, o, do, m, l, q_pos, k_pos = args
        ms = cuda_ms(lambda: fm.flash_mqkv_bwd(*args, **kw), reps=20)
        plain_ms = cuda_ms(lambda: flash_mqkv_bwd_plain(*args, **kw),
                           reps=3, warmup=1)
        b, hq, hkv = K1B_SDPA[label]
        leaf = lambda t, h: t.view(b, h, -1, d).detach().requires_grad_()
        q4, k4, v4 = leaf(q, hq), leaf(k, hkv), leaf(v, hkv)
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                             enable_gqa=hq != hkv)
        do4 = do.view(b, hq, lq, d)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), do4, retain_graph=True), reps=20)
        vis = (k_pos[None, :] >= 0).expand(lq, lk)
        if causal:
            vis = vis & (q_pos[:, None] >= k_pos[None, :])
        pairs = float(vis.sum()) * bh
        flops = 5 * 2.0 * d * pairs
        nbytes = 2.0 * d * (4 * bh * lq + 4 * bhkv * lk) + 8.0 * bh * lq
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BPS
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        log(f"k1b time {label}: BH={bh}/{bhkv} Lq={lq} Lk={lk} D={d} "
            f"causal={causal} bf16: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s over {pairs / bh / (lq * lk):.3f} of the pairs, "
            f"{100 * bound_ms / ms:.1f} % of the bound), bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, sdpa "
            f"backward {lib_ms:.4f} ms (K1b / sdpa {ms / lib_ms:.2f}) [{card}]")
        del args, q4, k4, v4, out
        torch.cuda.empty_cache()
    return rows


def examples_phase(card: str) -> None:
    """Phase examples: the four examples of src/repro_torch/examples, in
    process on the card at their own sizes (train_lm for EXAMPLE_TRAIN's
    steps at its batch).  Fails on a quickstart strategy off the
    oracle by more than the float32 TOL of max|ref|, a non-finite latent,
    fewer requests or tokens than asked, a loss that did not fall, or one
    of K1-K4 launched by neither quickstart nor serve_dit."""
    import torch
    from repro_torch.examples import (generate_text, quickstart, serve_dit,
                                      train_lm)

    t0 = time.perf_counter()
    reset_counts()
    quick = quickstart.main([])
    q_counts = read_counts()
    bad = {s: e for s, e in quick["errors"].items()
           if not e <= TOL["float32"] * quick["max_ref"]}
    log(f"examples quickstart: max|d| vs oracle "
        f"{ {s: f'{e:.2e}' for s, e in quick['errors'].items()} } (max|ref| "
        f"{quick['max_ref']:.3f}, tol {TOL['float32']} of it), launches "
        f"{q_counts} [{card}]")
    if bad or len(quick["errors"]) != 5:
        fail(f"examples quickstart: {bad or quick['errors']}")
    gc.collect()
    reset_counts()
    dit = serve_dit.main([])
    d_counts = read_counts()
    served = sorted(dit["results"])
    log(f"examples serve_dit: {len(served)} requests {served}, finite "
        f"{all(dit['finite'].values())}, preemptions {dit['preemptions']}, "
        f"refits {dit['refits']}, launches {d_counts} [{card}]")
    if served != [0, 1, 2, 3, 4, 5, 100, 101, 200, 201] or not all(
            dit["finite"].values()):
        fail(f"examples serve_dit: served {served}, finite {dit['finite']}")
    never = [k for k in q_counts if q_counts[k] + d_counts[k] == 0]
    if never:
        fail(f"examples: {never} launched by neither quickstart nor "
             f"serve_dit")
    del dit
    gc.collect()
    gen = generate_text.main([])["tokens"]
    n_tok = {rid: len(t) for rid, t in gen.items()}
    log(f"examples generate_text: tokens per request {n_tok} [{card}]")
    if sorted(gen) != sorted(generate_text.PROMPTS) or any(
            n != generate_text.NEW_TOKENS for n in n_tok.values()):
        fail(f"examples generate_text: {n_tok}")
    t1 = time.perf_counter()
    n_steps, batch = EXAMPLE_TRAIN
    hist = train_lm.main(["--steps", str(n_steps), "--batch", str(batch),
                          "--log-every", "10"])
    losses = [h["loss"] for h in hist["history"]]
    steps = hist["step_seconds"]
    log(f"examples train_lm: {n_steps} steps of batch {batch}, losses "
        f"{[round(x, 4) for x in losses]}, median step "
        f"{median(steps[1:]) * 1e3:.1f} ms, {time.perf_counter() - t1:.1f} "
        f"s [{card}]")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f"examples train_lm: losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    log(f"examples: {took:.1f} s (budget {EXAMPLES_BUDGET_S} s) [{card}]")


def step_shares(results: dict, card: str) -> None:
    """Numbers: the whole-step shares of the card's peak (989e12 dense
    bf16 FLOP/s): the dry-run's FLOPs (launch/dryrun.py, counted on the
    meta device at degree 1) of the train phase's qwen2-1.5b step (B 4 x
    L 1024, remat full) and of the serve phase's flux-12b step (the 4096
    bucket: B 2, unguided), over the measured step; then the mfu that
    launch/calibrate.py fits to the serve phase's degree-1 captured step
    times (median replays of the 4096 and 1024 buckets).  Printed, not
    gated."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SPConfig
    from repro_torch.launch import calibrate, dryrun
    from repro_torch.launch.roofline import PEAK_FLOPS

    def counted(arch, shape):
        fn, args, _ = dryrun.build_step(get_config(arch), shape, None,
                                        SPConfig(strategy="full"))
        return dryrun.count_step(fn, args, None).flops

    b, l = TRAIN_BL
    train_ms = results["train_run"]["step_ms"]
    f_train = counted("qwen2-1.5b", InputShape("train", l, b, "training"))
    log(f"numbers: share of peak qwen2-1.5b train step (B {b} x L {l}, "
        f"bf16, remat full): {f_train:.4e} counted FLOPs / ({train_ms} ms "
        f"x {PEAK_FLOPS:.3e}) = {f_train / (train_ms / 1e3 * PEAK_FLOPS):.4f}"
        f" [{card}]")
    replay = {seq: median(results["step_times"][seq][2:])
              for seq in (4096, 1024)}
    f_serve = counted("flux-12b", InputShape("serve", 4096, 2, "prefill"))
    log(f"numbers: share of peak flux-12b degree-1 serve step (B 2 x 4096 "
        f"latents + 256 cond, bf16, captured): {f_serve:.4e} counted FLOPs "
        f"/ ({replay[4096] * 1e3:.2f} ms x {PEAK_FLOPS:.3e}) = "
        f"{f_serve / (replay[4096] * PEAK_FLOPS):.4f} [{card}]")
    cfg = get_config("flux-12b")
    recs = [{"name": f"flux-12b-deg1-{seq}", "n_machines": 1,
             "m_per_machine": 1, "guided": False,
             "workload": {"batch": rows, "seq": seq, "heads": cfg.n_heads,
                          "head_dim": cfg.resolved_head_dim,
                          "n_layers": cfg.n_layers},
             "plan": {"cfg": 1, "pp": 1, "p_ulysses": 1, "p_ring": 1,
                      "num_patches": None},
             "measured_step_us": replay[seq] * 1e6}
            for seq, rows in ((4096, 2), (1024, 1))]
    net, report = calibrate.fit(recs)
    log(f"numbers: calibrate fit of {len(recs)} degree-1 captured flux-12b "
        f"step records: mfu {net.mfu:.4f} (the comm model's compute term is "
        f"attention FLOPs alone; ratio to nominal "
        f"{report['ratio_vs_nominal']['mfu']:.4f}, rms rel error "
        f"{report['rms_rel_error']:.4f}) [{card}]")


def ptxas_report(text: str) -> dict:
    """{mangled entry: (registers, spill store bytes, spill load bytes,
    static shared-memory bytes)} from nvcc's -Xptxas -v output."""
    import re
    out, entry, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = (int(m.group(1)), *spills,
                          int(smem.group(1)) if smem else 0)
            entry, spills = None, (0, 0)
    return out


def source_constants(name: str) -> dict:
    """The ``constexpr int NAME = value;`` constants of csrc/<name>.cu."""
    import re
    text = (ROOT / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def build_all() -> None:
    """One nvcc per source, all started together; ptxas's report of the
    bf16 Hopper body (registers, spills, and the dynamic shared memory it
    launches with), of the put kernels K3/K4 and of every instantiation of
    K5, none of which may spill."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_mqkv as fm

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        reps = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    for name, rep in reps.items():
        log(f"build {name}: {rep['seconds']:.1f} s -> {rep['path']}")
        for line in rep["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill",
                                       "arning")):
                log(f"  {line.strip()}")
    log(f"build total {time.perf_counter() - t0:.1f} s")
    for name in ("flash_mqkv", "ring_flash"):
        for entry, (regs, st, ld, _) in ptxas_report(reps[name]["log"]).items():
            m = re.search(r"flash_hopper_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          entry)
            if m is None:
                continue
            d, bq = int(m.group(1)), int(m.group(2))
            smem = fm.smem_bytes(fm.TilePlan(bq, bq, fm.STAGES), d)
            log(f"ptxas {name} flash_hopper_kernel<D={d}, BQ={bq}, "
                f"FWD={m.group(3)}>: {regs} registers, {st} + {ld} bytes "
                f"spilled (stores + loads), {smem} bytes of dynamic shared "
                f"memory")
            if st or ld:
                fail(f"flash_hopper_kernel<{d}, {bq}> spills registers")
    put = source_constants("one_sided")
    for entry, (regs, st, ld, smem) in ptxas_report(
            reps["one_sided"]["log"]).items():
        kernel = re.search(r"(remote_put|landing_copy)_kernel", entry)
        if kernel:
            log(f"ptxas one_sided {kernel.group(0)}: {regs} registers, {st} + "
                f"{ld} bytes spilled (stores + loads), {smem} bytes of static "
                f"and {put['STAGES'] * put['TILE']} of dynamic shared memory "
                f"({put['STAGES']} stages x {put['TILE']} B tiles, "
                f"{put['THREADS']} threads, {put['BLOCKS_PER_SM']} blocks per "
                "SM)")
            if st or ld:
                fail(f"one_sided {kernel.group(0)} spills registers")
    bwd = fm._bound_bwd_library()
    bwd_rep = ptxas_report(reps["flash_mqkv_bwd"]["log"])
    for entry, (regs, st, ld, _) in bwd_rep.items():
        # the bf16 Hopper body: <D, warpgroups> (dK/dV, dQ), <D> (delta),
        # or none; the f32 parity body: <float[, D]>
        m = (re.search(r"\d(dkdv_hopper_kernel|dq_hopper_kernel)ILi(\d+)ELi(\d+)E",
                       entry)
             or re.search(r"\d(delta_bf16_kernel)ILi(\d+)E()", entry)
             or re.search(r"\d(bounds_kernel|reduce_dkdv_kernel)E()()", entry))
        if m is not None:
            kernel, d, wg = m.groups()
            smem = (bwd.flash_mqkv_bwd_smem_bytes(
                int(kernel == "dq_hopper_kernel"), int(d)) if wg else 0)
            args = ", ".join(f"{k}={v}" for k, v in (("D", d), ("WG", wg)) if v)
            label = f"{kernel}<{args}>" if args else kernel
            extra = f", {smem} bytes of dynamic shared memory (bf16 body)"
        else:
            m = re.search(r"\d(delta_kernel|dkdv_kernel|dq_kernel)If(?:Li(\d+)E)?E",
                          entry)
            if m is None:
                continue
            label = (f"{m.group(1)}<f32"
                     + (f", D={m.group(2)}>" if m.group(2) else ">"))
            extra = " (f32 body)"
        log(f"ptxas flash_mqkv_bwd {label}: {regs} registers, {st} + {ld} "
            f"bytes spilled (stores + loads){extra}")
        if st or ld:
            fail(f"flash_mqkv_bwd {label} spills registers")
    for kernel in ("delta_bf16_kernel", "bounds_kernel", "dkdv_hopper_kernel",
                   "reduce_dkdv_kernel", "dq_hopper_kernel"):
        if not any(kernel in entry for entry in bwd_rep):
            fail(f"flash_mqkv_bwd: no ptxas report of {kernel}")
    wkv = wkv_module()
    for entry, (regs, st, ld, _) in ptxas_report(
            reps["rwkv6_wkv"]["log"]).items():
        m = re.search(r"wkv_kernelILi(\d+)ELi(\d+)ELi(\d+)E", entry)
        if m is None:
            continue
        c, n, tv = (int(x) for x in m.groups())
        plan = wkv.smem_plan(c, n, n // tv, bf16=0b0111)
        log(f"ptxas rwkv6_wkv wkv_kernel<C={c}, N={n}, TV={tv}>: {regs} "
            f"registers, {st} + {ld} bytes spilled (stores + loads), "
            f"{plan['bytes']} bytes of dynamic shared memory at the model's "
            f"dtypes ({plan['stages']} TMA stages)")
        if st or ld:
            fail(f"rwkv6_wkv wkv_kernel<{c}, {n}, {tv}> spills registers")
    bwd = wkv._bound_bwd_library()
    k5b_rep = ptxas_report(reps["rwkv6_wkv_bwd"]["log"])
    seen = set()
    for entry, (regs, st, ld, _) in k5b_rep.items():
        m = re.search(r"(wkv_bwd_chain|wkv_bwd_chunk|wkv_bwd_du)"
                      r"(?:ILi(\d+)ELi(\d+)E(?:Li(\d+)E)?)?", entry)
        if m is None:
            continue
        kernel, c, n, tv = m.groups()
        seen.add(kernel)
        if kernel == "wkv_bwd_du":
            label, smem = kernel, 0
        elif kernel == "wkv_bwd_chain":
            label = f"{kernel}<C={c}, N={n}, TV={tv}>"
            smem = bwd.rwkv6_wkv_bwd_smem(0, int(c), int(n), int(n) // int(tv))
        else:
            label = f"{kernel}<C={c}, N={n}>"
            smem = bwd.rwkv6_wkv_bwd_smem(1, int(c), int(n), 1)
        log(f"ptxas rwkv6_wkv_bwd {label}: {regs} registers, {st} + {ld} "
            f"bytes spilled (stores + loads), {smem} bytes of dynamic shared "
            f"memory")
        if st or ld:
            fail(f"rwkv6_wkv_bwd {label} spills registers")
    for kernel in ("wkv_bwd_chain", "wkv_bwd_chunk", "wkv_bwd_du"):
        if kernel not in seen:
            fail(f"rwkv6_wkv_bwd: no ptxas report of {kernel}")


def kernel_row(name, source, replaces, launches, err, row) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def main() -> int:
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_all()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after build_all")
    results: dict = {}
    check_k1(results)
    check_k2(results)
    check_put_kernels(results)
    check_k5(results)
    check_k1b(results)
    check_k5b(results)
    check_sp_block(check_block())
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after check_sp_block")
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    from repro_torch.models import init_dit
    cfg = get_config("flux-12b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_dit(cfg, gen, device="cuda")
    perturb_zero_init(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: flux-12b {cfg.n_layers} layers d={cfg.d_model} bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    conds = {rid: torch.randn((256, cfg.d_model), generator=gen,
                              device="cuda").to(torch.bfloat16)
             for rid, _ in REQUESTS}
    torch.cuda.reset_peak_memory_stats()
    deg1 = serve(results, card, params, cfg, conds)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve")
    # the SP server phases run at SERVE_SP_LAYERS of the 96 layers: a
    # 96-layer SP graph costs ~30 s to capture and instantiate
    sub = dict(params, layers=params["layers"][:SERVE_SP_LAYERS])
    cfg_sp = dataclasses.replace(cfg, n_layers=SERVE_SP_LAYERS)
    serve_sp(results, card, sub, cfg_sp, conds)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_sp")
    capture_dit(results, card, params, cfg, conds, deg1)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after capture_dit")
    profile_phase(results, card,
                  dict(sub, layers=sub["layers"][:PROFILE_LAYERS]),
                  dataclasses.replace(cfg_sp, n_layers=PROFILE_LAYERS), conds)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after profile_phase")
    del params, sub, deg1
    gc.collect()  # the servers' reference cycles hold the flux weights
    torch.cuda.empty_cache()
    serve_procs(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_procs")
    serve_procs_hybrid(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after "
        "serve_procs_hybrid")
    serve_procs_lm(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_procs_lm")

    paper_attn(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after paper_attn")
    layer_paper(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after layer_paper")
    cv_params, cv_cfg = serve_cogvideox(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_cogvideox")
    # serve-hybrid at HYBRID_LAYERS of the 42 (its fp32 gate (a) serves
    # three full requests)
    serve_hybrid(results, card,
                 dict(cv_params, layers=cv_params["layers"][:HYBRID_LAYERS]),
                 dataclasses.replace(cv_cfg, n_layers=HYBRID_LAYERS))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_hybrid")
    del cv_params
    gc.collect()
    torch.cuda.empty_cache()
    hier(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after hier")
    commcheck_phase(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after commcheck_phase")
    serve_cli_phase(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_cli_phase")

    check_lm_block()
    lm_params, lm_cfg = lm_prefill(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after lm_prefill")
    serve_lm(results, card, lm_params, lm_cfg)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_lm")
    check_dense_blocks(results)
    dn_params, dn_cfg = dense_prefill(results, card)
    dense_decode(results, card, dn_params, dn_cfg)
    serve_dense(results, card, dn_params, dn_cfg)
    del dn_params
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_dense")
    decode_gap(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after decode_gap")
    gc.collect()
    torch.cuda.empty_cache()

    hymba_block(results)
    hy_params, hy_cfg = hymba_prefill(results, card)
    family_sp_prefill(results, card, hy_params, hy_cfg)
    serve_ar(results, card, hy_params, hy_cfg, "serve-hymba", seed=35)
    del hy_params
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_hymba")
    gc.collect()
    torch.cuda.empty_cache()
    moe_block_phase(results, card)
    moe_params, moe_cfg = moe_prefill(results, card)
    family_sp_prefill(results, card, moe_params, moe_cfg)
    serve_ar(results, card, moe_params, moe_cfg, "serve-moe", seed=36,
             floor_ms=weight_read_floor_ms(moe_params))
    del moe_params
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after serve_moe")
    gc.collect()
    torch.cuda.empty_cache()

    train_layer(results)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after train_layer")
    train_launcher(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after train_launcher")
    train_breakdown(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after train_breakdown")
    train_curve(results, card)
    whisper_phase(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after whisper_phase")
    gc.collect()
    torch.cuda.empty_cache()
    for arch in TRAIN_FAMILIES:
        train_family(results, card, arch)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s after train "
            f"{arch}")
    train_moe(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after train_moe")
    train_sp(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after train_sp")
    train_sp_families(results, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after "
        "train_sp_families")
    examples_phase(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after examples")

    k1 = k1_numbers(card)
    dense_numbers(card)
    k2 = k2_numbers(card)
    puts = put_numbers(card)
    ep_put_numbers(card)
    layer_breakdown(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after layer_breakdown")
    k1b = k1b_numbers(card)
    k5b = k5b_numbers(card)
    k5 = k5_numbers(card, results)
    lm_breakdown(card, lm_params, lm_cfg)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after lm_breakdown")
    del lm_params
    step_shares(results, card)

    main_shape = (48, 4352)
    launches = results["launches"]
    sp_train = results["train_sp_launches"]
    # the (a) part of train-sp-families: each family's one-layer step
    fam = results["train_sp_families_launches"]
    kernels = [
        kernel_row("flash_mqkv", "src/repro_torch/csrc/flash_mqkv.cu",
                   "src/repro/kernels/flash_mqkv.py:104",
                   launches["flash_mqkv"], results["flux_err"][main_shape],
                   k1[main_shape]),
        kernel_row("ring_flash_step", "src/repro_torch/csrc/ring_flash.cu",
                   "src/repro/kernels/ring_flash.py:79",
                   launches["ring_flash_step"], results["k2_err"], k2),
        kernel_row("remote_put", "src/repro_torch/csrc/one_sided.cu",
                   "src/repro/comm/pallas_backend.py:134",
                   results["launches_model16"]["remote_put"]
                   + fam["remote_put"],
                   results["put_err"]["remote_put"], puts["remote_put"]),
        kernel_row("landing_copy", "src/repro_torch/csrc/one_sided.cu",
                   "src/repro/comm/pallas_backend.py:83",
                   launches["landing_copy"] + sp_train["landing_copy"]
                   + fam["landing_copy"],
                   results["put_err"]["landing_copy"], puts["landing_copy"]),
        kernel_row("rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
                   "src/repro/kernels/rwkv6_wkv.py:81",
                   results["lm_launches"] + fam["rwkv6_wkv"],
                   results["k5_err"][LM_PREFILL[0]], k5),
        # K1b replaces no Pallas kernel: the reference differentiates plain
        # attention with XLA
        kernel_row("flash_mqkv_bwd", "src/repro_torch/csrc/flash_mqkv_bwd.cu",
                   "src/repro/core/softmax.py:199",
                   results["train_k1b_launches"]
                   + sp_train["flash_mqkv_bwd"] + fam["flash_mqkv_bwd"],
                   results["k1b_err"]["qwen2-train"], k1b["qwen2-train"]),
        # K5b replaces no Pallas kernel either: the reference differentiates
        # its plain chunked scan with XLA
        kernel_row("rwkv6_wkv_bwd", "src/repro_torch/csrc/rwkv6_wkv_bwd.cu",
                   "src/repro/models/ssm.py:50",
                   results["train_k5b_launches"] + fam["rwkv6_wkv_bwd"],
                   results["k5b_err"]["rwkv6-train"], k5b),
    ]
    # the process mesh's launches (serve-procs: K1 and K4 from the served
    # run, K2 from ring and K3 from (model 4); serve-procs-hybrid: K1 and
    # K3 from its served run; serve-procs-lm: K1-K5 from its prefills,
    # K4 from its served run), summed over its processes
    for row in kernels:
        row["launches"] += results["procs_launches"].get(row["name"], 0)
    for row in kernels:
        if row["launches"] <= 0:
            fail(f"{row['name']} was never launched on its path")
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

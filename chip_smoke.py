#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

Run from the repository root, with one CUDA device visible::

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. the card's name and power limit, then the build of the kernel library
   from ``apex_tpu_torch/csrc`` with its time;
2. each kernel against its plain PyTorch version, with its device time
   (CUDA events, median of 30 launches, L2 flushed before each), the
   plain version's, one PyTorch library call's as a yardstick, and the
   least time the card could take (``bound_ms``); K1, L1, N1 and N2 also
   with ``floor_ms``, the same launch with nothing to do (every length 0;
   every slot out of range; 8 rows), the fixed cost of a launch in this
   harness:
   - the serving kernels K1-K3 at GPT-124M serving shapes (8 slots, 12
     heads of 64, 16-token blocks, 1024-token context, a 128-token
     prefill chunk, hidden 768; plus a grouped-query case); K3 at 8, 40
     and 1024 rows (the decode step, the k + 1 verify, a prefill chunk)
     with bf16 x over a bf16 or fp32 residual and in fp32, each with
     ``floor_ms`` (one row), ``chain_ms`` (the reference's unfused
     lowering on the card, the separate ops K3 replaces) and the dense
     projection that makes x alone and followed by K3; then, unmeasured,
     at ``NORM_EDGES`` (hidden 100, 1500 and 8192, a misaligned x, 0
     rows, no skip bias, fp16, parameters in x's dtype, fp32 x over a
     bf16 residual), each called twice, the second call bit for bit the
     first and the new residual bit for bit plain's;
   - the flash kernels F1-F3 at the training shape (batch 8, 12 heads of
     64, sequence 1024, causal) in bf16 and fp32, with packed segment ids
     and with attention dropout (0.1 and 0.3); then, unmeasured, at the
     ragged shapes of ``FLASH_EDGES`` (lengths off the tile, sq != sk,
     offsets that leave rows no key, head dims 16 to 128, bf16 at 24, 64,
     80 and 128);
   - F1, F2, F3 and K2 each have two routes: bf16 takes the tensor-core
     kernel ("tc": wgmma, TMA, an mbarrier ring), fp32 the CUDA-core
     kernel ("simt"); K1 too: bf16 q over a bf16 or int8 cache takes the
     split-context kernel ("split"), fp32 the first one ("simt"); every
     check counts the launches per route, and each bf16 check also holds
     and times the simt route on the same operands, so the kernels line
     carries both records; K1's split route is also held, twice in a row,
     at the edges of ``DECODE_EDGES`` (a length mid-page, at a span
     boundary, the whole table, all 0, one slot of 1, 3 query heads per
     KV head over int8, head dim 128); the tc route of F2/F3 is
     held against an fp64 evaluation of the same gradient (no farther from
     it than plain, see ``flash_close``), the simt route against plain as
     before; the bf16 ``FLASH_EDGES`` run F2/F3 on both routes; K2's tc
     route is also held at the ragged ``PAGED_EDGES`` (T x heads per group
     over two 64-row tiles, the last ragged); ``ptxas -v``'s registers,
     shared memory and spills of every tc kernel, of K1's split kernel, of
     N1/N2's row kernel, of L1's cluster kernel and of K3's row kernel
     are printed, and a spill byte fails;
   - the row norms N1 (LayerNorm) and N2 (RMSNorm) at GPT-124M's training
     activation (8192 rows of 768) with bf16 x over fp32 parameters, in
     fp32, and in bf16 throughout, beside ``F.layer_norm`` /
     ``F.rms_norm``; then, unmeasured, at the shapes of
     ``ROW_NORM_EDGES`` (hidden 1 to 32768, 0, 1 and 70 rows, a 1-D, a
     strided and a misaligned x, fp16), and a row wider than the kernels
     take raises;
3. the serving engine at GPT-124M width (random weights from a seed,
   bf16 compute) serving 16 staggered requests of 64-600 prompt tokens
   and 32 greedy tokens each, once with a bf16 and once with an int8 KV
   cache; the launch counts show the kernels carried the run, every K2
   launch on the tc route and every K1 launch on the split route; the
   bf16 wave once more with ``fuse_epilogue=False`` (the reference's A/B
   of K3: no K3 launch, every other count as in the fused wave, the
   streams equal up to bf16 near ties); then the bf16 wave under
   ``torch.profiler``, fused and unfused, for the device busy share, the
   kernels that take the device's time and the epilogue's device time;
4. three of those requests in fp32 on the card and on the CPU, for
   GPT-124M and for a small rope + grouped-query + SwiGLU model: the
   greedy streams must agree (a divergence passes only where the CPU's
   two best logits are within 1e-3 of each other); K1 and K2 on the simt
   route;
5. GPT-124M training at the widths of ``bench.py``'s flash step (hidden
   768, 12 layers, 12 heads of 64, vocabulary 50304, sequence 1024,
   batch 8, bf16 compute, fp32 parameters, flash attention, FusedAdam at
   lr 1e-4) on one fixed batch: 2 warm-up and 8 timed steps, the loss
   finite and falling, F1, F2 and F3 launched 12 times per step (from
   their counters), F1, F2 and F3 always on the tc route; then one more
   step under ``torch.profiler``;
6. three training steps in fp32 (TF32 off) on the card and on the CPU
   from the same weights, for GPT-124M at batch 1 x 128 tokens and for
   the small rope + grouped-query + SwiGLU model: each step's loss within
   1e-4 and gradient norm within 1e-3 (relative); F1, F2 and F3 on the
   simt route;
7. speculative decoding and multi-LoRA serving at GPT-124M width (bf16
   compute and cache, fp32 parameters and adapter arena, as in the
   serving phases): in phase 2 beside the other kernels,
   L1 (the gathered LoRA delta) at the four projections' (in, out) pairs
   and S = 1, 5 and 128 through the route ``lora_route`` names ("cluster":
   the first product once per row tile; the first kernel, the "simt"
   route, held and timed on the same operands), then, twice in a row and the
   second call bit for bit the first, at ``LORA_EDGES`` (S of 1, 17 and
   129, out off the column tile and off the 16-byte chunk, in 3072 at
   ranks 4 and 16, a misaligned strided x, every slot the zero adapter,
   a slot out of range, rank 12 on simt), and K2 at the verify width
   (T = k + 1 = 5, draft
   counts 0..4, bf16 and int8 caches); then a wave of 16 motif prompts
   (a random motif of 4-16 tokens repeated to 64-600 tokens, a 4-token
   suffix) decoding 64 greedy tokens, with k = 4 drafting and without:
   drafts proposed and accepted, K1 never and K2 12 times per call, the
   two engines' streams equal up to near ties, every K2 launch on the tc
   route (here and in the LoRA waves); a LoRA wave (rank 8, four
   adapters, requests cycling over them and no adapter, a hot swap after
   the first tick, an LRU eviction after the drain): L1 48 times per
   call, every launch on the cluster route, the same wave again through
   ``LoRAConfig(fused=False)`` (no L1 launch, its no-adapter streams bit
   for bit the L1 wave's, the adapter streams' parting points and top-2
   gaps printed), the no-adapter streams bit for bit a bare engine's,
   the arena's books closed; the same with k = 4 drafting and an int8
   cache; four requests with drafting and two adapters in fp32 on the
   card through L1, on the card through ``LoRAConfig(fused=False)`` (no
   L1 launch) and on the CPU, L1 against the CPU and the unfused streams
   against L1 equal up to near ties of 1e-3, the three's first-step
   logits printed; eight drafting LoRA requests under ``torch.profiler``, with L1's
   device time per kernel instance (8-row tiles: the verify; 16: prefill);
8. the norm path: ``pallas_layer_norm`` and ``pallas_rms_norm`` forward
   and backward at ``[8, 1024, 768]``, 10 passes each, bf16 x and fp32
   parameters all requiring gradients, a seeded cotangent: N1 (N2) once
   per forward and never in a backward, the gradients bit for bit those
   of the same Function over the plain forward; the same in fp32 on the
   card and on the CPU (y, dx, dw, db within 1e-5 of each one's RMS);
   ``FusedRMSNorm``, ``MixedFusedLayerNorm`` and a non-affine
   ``FusedLayerNorm``, with ``memory_efficient`` off and on, card vs CPU
   in fp32 at the same limit;
9. single-device training, completed: GPT-124M at phase 5's widths, weights
   and batch through the default (fused-softmax) attention core, 2
   warm-up and 4 timed steps: no flash launch, the losses finite and
   falling, the first within 2e-2 (relative) of phase 5's first loss;
   then one profiled step; three fp32 steps of a 2-layer default-core
   model on the card and on the CPU (batch 2 x 128, ``compare_traces``'
   defaults); then GPT-124M under O2 over the flash core (bf16
   parameters but the LayerNorms' fp32, FusedAdam with fp32 masters,
   ``DynamicLossScale(init_scale=2**16, growth_interval=4)``, driven by
   ``l1.amp_train_step``), 2 warm-up and 8 timed steps: F1-F3 12 times a
   step on the tc route, no overflow, the scale doubling at every 4th
   clean step; then an inf in one gradient: the step is skipped with
   parameters, masters, moments and step count bit for bit, and the
   scale halves;
10. fp8 with delayed scaling (``apex_tpu_torch.amp.fp8``; its GEMMs are
   ``torch._scaled_mm`` on the fp8 tensor cores, not a kernel of this
   repository, so they are not in the kernels line): ``fp8_matmul_t``'s
   card route against its plain version (fp32 on the card) at GPT-124M's
   four projections and 8192 tokens, bf16 x over fp32 weights and metas
   whose scales are not 1: forward, dx and dw each with the RMS of the
   difference within 1e-3 of the plain output's RMS and no element more
   than 1e-2 of it beyond one step of the output dtype, then at
   ``FP8_EDGES``
   (hidden 100, 9 tokens, fp16 x), with the card GEMMs' times (forward,
   dx, dw), the plain forward's, ``torch.matmul`` in bf16 at the same
   shape and one operand's quantize passes (amax, scale, clip, cast)
   beside ``bound_ms`` at 1,979 TFLOP/s fp8 or 3.35 TB/s; then GPT-124M
   at phase 5's widths, weights and batch with ``fp8=True`` (2 warm-up and
   8 timed steps): 48 forward and 96 backward fp8 GEMMs and 12 launches
   each of F1-F3 (tc) a step, losses finite and falling, the first within
   2e-2 of phase 5's, every scale finite and positive, an ``eval()``
   forward leaving every meta bit for bit, one profiled step with the fp8
   kernels' device time; then ``gpt_fp8`` (fp32) for its ten steps on the
   card and on the CPU from the same weights, within ``FP8_TRACE_TOL``
   and the final scales within ``FP8_SCALE_RTOL`` (fp8 rounding grows
   one-ulp differences of the fp32 sums; the limits come from the JAX
   package's own spread);
11. tensor, sequence and data parallelism (``apex_tpu_torch.parallel``,
   ``transformer.tensor_parallel``) at world size 1 over a real NCCL
   process group (one card: two NCCL ranks cannot share it; the
   multi-rank parity runs on gloo CPU ranks in the tests): every function
   of ``parallel/collectives.py`` and every mapping region, forward and
   backward, on CUDA tensors, each giving back its input bit for bit with
   its collectives counted; ``vocab_parallel_cross_entropy`` at
   GPT-124M's LM-head shape (8192 x 50304 bf16 logits, smoothing 0 and
   0.1) against ``softmax_cross_entropy_loss`` at the reference's
   smoothing ``s * V / (V - 1)`` (loss within 1e-5 relative, gradient
   within 1e-5 of its RMS), with the forward + backward device times of
   both and of ``F.cross_entropy``; then GPT-124M at phase 5's widths,
   weights and batch with ``tensor_axis="tp"``, ``sequence_parallel=True``
   and the flash core through ``DistributedDataParallel`` and FusedAdam
   (``l1.parallel_train_step``), 2 warm-up and 8 timed steps: F1-F3 12
   times a step on tc, one DDP all-reduce a step and no other collective,
   losses finite and falling, the first within 2e-2 of phase 5's, the step
   time beside phase 5's, and both steps again in alternating blocks
   (plain, parallel, parallel, plain; four rounds of four steps) for
   medians on one host clock; one profiled step with NCCL's device time;
12. the pipeline (``transformer.pipeline_parallel``, through
   ``gpt_parallel_train.build_gpt_3d``) at world size 1 over NCCL: GPT-124M
   at phase 5's widths, weights and batch with pp = 1, the 12 layers as 12
   virtual chunks and 4 microbatches of 2 x 1024, each tick's stage
   recomputed in the backward; 2 warm-up and 8 timed steps: F1 96 and F2,
   F3 48 times a step (12 x 4 ticks, F1 again in each recomputation), all
   on tc, no collective (pp, tp and dp of one rank skip the rotation, the
   regions and the reductions), losses finite and falling, the first
   within 1e-3 of phase 5's (the difference printed); one profiled
   pipelined step and one of phase 5's (device busy ms, resident and peak
   GiB); both steps in alternating blocks as in phase 11; one
   ``remat_ticks=True`` step (F1 144 times: each group recomputed, then
   each tick in it; its loss within 1e-6 of the pipelined first loss) and
   one ``packed_inputs`` + ``block_diagonal`` step with full-coverage
   segments (every F1, F2 and F3 call with the segment ids, its loss
   within 1e-3), each with one more step's peak memory;
13. context parallelism and the Switch mixture of experts at world size
   1 over NCCL, GPT-124M at phase 5's widths, weights and batch: the cp
   axis's one-rank permute and all-to-all (identities, their NCCL device
   time printed); (a) ``gpt_cp_train.build_gpt_cp`` with ring attention,
   2 warm-up and 8 timed steps: F1, F2 and F3 12 times a step on tc
   through the ring's calls (the diagonal case at cp = 1), no collective,
   losses finite and falling, the first within 1e-5 of the serial twin's
   (the same modules without ``context_axis`` on the same weights and
   objective; the difference printed), the step in alternating blocks
   against phase 5's and one profiled step; (b) the same with Ulysses and
   ``attention_dropout=0.1``, 2 + 4 steps, every F1-F3 call with a
   dropout seed, the first loss within 2e-2 of (a)'s; (c) phase 5's
   ``GPTModel`` (flash core) with ``num_experts=8`` and capacity factor
   1.25, 2 + 8 steps on ``loss + 1e-2 * collect_moe_aux``: losses finite
   and falling, aux >= 1, F1-F3 12 a step, the tokens each layer dropped,
   one profiled step (device busy ms, top rows, peak GiB) and the
   dispatch/combine einsums' forward + backward device time at the step's
   shapes; (d) one ``build_gpt_3d`` step with those experts
   (``expert_axis="dp"``) at pp = 1, 12 chunks and 4 microbatches: F1 96
   and F2, F3 48, its loss finite;
14. serving over a one-rank tp grid and the rest of the engine, at world
   size 1 over NCCL, phase 3's GPT-124M engine and bf16 wave: (a) the
   engine with ``mesh=`` (``initialize_model_parallel(1, 1)``): K1-K3 12
   a call on their routes, no collective, the streams bit for bit phase
   3's no-mesh wave's, tokens/s, the pool's peak occupancy, device busy
   ms of one profiled wave; (b) ``fused_attention=False``: no K1 or K2
   launch, K3 12 a call, the streams equal (a)'s up to bf16 near ties,
   tokens/s and busy ms beside (a)'s (the reference's ``vs_unfused``
   A/B), and GPT-124M in fp32 with and without it: the first step's
   logits within 1e-4; (c) ``admission="reserve"``: the streams bit for
   bit (a)'s, no preemption, tokens/s and peak occupancy; (d) a request
   exported after 8 tokens from one card engine and imported into
   another, the bytes and ms of each side: in fp32 the continued stream
   bit for bit the uninterrupted twin's, in bf16 equal up to near ties;
   (e) ``introspect()["mfu"]`` a number, and the wave's host time with
   the telemetry off (a registry that records nothing, no recorder) and
   on (the metric registry and an armed flight recorder) in alternating
   blocks, with the armed wave's timeline event counts, and one more
   armed wave with the host time inside the telemetry's calls summed;
15. the serving fleet: replicas as spawned processes, each with its own
   CUDA context, sharing the card, GPT-124M from ``init_fn(0)`` with
   phase 3's serving shape, every stream held against one in-process
   engine on the same weights (fp32 bit for bit, bf16 up to near ties):
   (a) two ``ReplicaProcess`` replicas (fp32, traced) behind a
   ``FleetRouter`` serve phase 3's 16 prompts, 32 tokens each, both
   taking work, with each replica's ready time, the fleet's tokens/s
   beside the in-process engine's and the router's TTFT/TPOT p50/p99;
   (b) the replica serving the first request SIGKILLed after its third
   relayed token, the rest replayed on the survivor, the time from the
   kill to the last replayed token; the autopilot (``min_replicas=2``)
   respawns it; (e) one replica drained by SIGTERM mid-wave (``drained``,
   exit 0, only what it gave back requeued), and the spills merged into
   one fully attributed trace per request; (c)/(d) a prefill and a decode
   replica over ``SocketTransport`` through ``fleet_replica_target`` (the
   prefill link behind a ``ChaosProxy`` that drops it once: a reconnect,
   no failover), in bf16, 16 requests in rounds of 8 (the decode
   replica's slots), every request's KV migrated (blocks, MB, router ms,
   engine-side export and import ms from the replicas' ``/metrics``), the
   slabs crossing as ``uint16``; the children's launches from after
   their warm-up: K1 on split and K2 on tc, 12 a call of the child
   engine's decode and prefill calls, K3 12 a call of either kind, no
   simt or L1 launch, added to the kernels line's counts; and the same
   pair in fp32 over ``start_replica_server``, 8 requests; both pairs'
   routers demote a link as slow only past the 30 s heartbeat timeout,
   so that every request migrates;
16. checkpoints, crash/resume and the serving restores at GPT-124M width
   (``checkpoint_phase``; a temporary directory removed at the end, its
   free space checked first): (a) ``apex_tpu_torch.testing.crash_resume``
   as children on the card (``build_gpt_3d`` at pp = 1, 12 chunks, 2
   microbatches of 2 x 1024, bf16 compute, fp32 parameters, the flash
   core, FusedAdam at lr 1e-4, the dynamic-scale sentinel, deterministic
   algorithms; an async sharded ``CheckpointManager`` save every 2 steps,
   ``keep=2``): an uninterrupted 6-step run (F1 48 and F2, F3 24 a step,
   all tc, from its summary line) and a run SIGKILLed after step 4's
   commit, side by side; its ``--resume`` logs the uninterrupted run's
   hex losses for steps 1-6 bit for bit and its final ``--fingerprint``
   equals the uninterrupted one's; then ``corrupt_checkpoint`` flips a
   bit in step 6 and a second resume falls back to step 4 (fallback depth
   1) and ends bit for bit again; (b) beside the first resume, a run sent
   SIGTERM after its third step exits 0 with that step committed (the
   ``PreemptionGuard`` drain and final save) and verified; then, in this
   process, the train state's GB and its sync save, async submit,
   verify and restore ms and GB/s; (c) ``restore_gpt_for_serving`` of
   the resumed run: the served params bit for bit the step-6 params
   restored by ``restore_latest``, and phase 3's bf16 wave from each set
   (K1 on split, K2 on tc, K3, 12 a call) with the streams bit for bit;
   (d) four rank-8 adapters saved, a newer step torn, each restored past
   it by ``restore_adapter_for_serving`` and served (8 requests over
   them, L1 48 a call on cluster) bit for bit the same adapters from
   memory; (e) a ``ReplicaProcess`` with ``ckpt_dir`` reports the newest
   intact step past a corrupt one in its ready handshake, is rolled by
   ``FleetRouter.rollout`` onto a newer committed step and reports it,
   and serves 4 fp32 requests bit for bit an in-process engine on the
   same restored weights; every timing printed with the card's name and
   power limit;
17. ResNet-50 training, the BASELINE workload (``resnet_phase``; no TPU
   kernel lies on this path, and none of the nine launches in it): (a)
   ``bench.py``'s recipe, 1000 classes, 224 x 224, batch 128, amp O2 (bf16
   compute, fp32 masters), ``FusedSGD(lr=0.1, momentum=0.9,
   weight_decay=1e-4)``, channels-last, seeded weights, batches from
   ``synthetic_image_batches`` normalized on the card inside the step
   (``normalize_on_device``), cuDNN's autotuned algorithms: 2 warm-up and
   8 timed steps, the losses finite with the first within 0.5 of ln 1000,
   images/s, resident and peak GiB, and one profiled step's device busy
   ms, busy share, device launches and top rows; (b) ``FusedLAMB(lr=1e-3,
   weight_decay=1e-2)`` (flat) with SyncBatchNorm over dp under
   ``DistributedDataParallel`` at world size 1 over NCCL, and its twin
   with local BN and no process group, both with cuDNN's deterministic
   algorithms: the same timings, and the two loss series bit for bit;
   (c) ``rn50_O0`` and ``rn50_O2_dynamic`` at the L1 size (8 x 32 x 32, 10
   classes; TF32 off, deterministic algorithms): the port's CPU trace's
   state before each of its ten steps replayed as one step on the card,
   fp32 within ``compare_traces``' default tolerances of the CPU step,
   bf16 within a factor ``RN50_BF16_RMS_RATIO``, either way, of the CPU's
   bf16 step's distance from the fp32 evaluation of the same weights,
   the loss-scale series exactly.

The lines before the last hold a ``{"fp8_gemms": {...}}``, a
``{"parallel": {...}}``, a ``{"pipeline": {...}}``, a
``{"context_moe": {...}}``, a ``{"serving_tp": {...}}``, a
``{"checkpoint": {...}}``, a ``{"resnet": {...}}`` and a
``{"kernels": [...]}`` JSON object and
the ``nvidia-smi`` name/power line; the last line is the JSON result.
Exits at once, with no result, when ``torch.cuda.is_available()`` is
false.
"""

import dataclasses
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
# dense tensor-core bf16 and fp8; fp32 FMA
PEAK_OPS = {"bf16": 989e12, "fp8": 1979e12, "fp32": 67e12}
B, N_HEADS, HEAD_DIM, BLOCK, MAX_SEQ, CHUNK, HIDDEN = 8, 12, 64, 16, 1024, 128, 768
TRAIN_BATCH, SEQ = 8, 1024          # bench.py's flash training step
WARMUP_STEPS, TIMED_STEPS = 2, 8
LENGTHS = [0, 1, 17, 100, 333, 512, 777, 1024]
REPS = 30
SPEC_K, SPEC_NEW = 4, 64            # drafts per tick; tokens per request
RANK, ADAPTERS = 8, 4
# the (in, out) pair of each GPT-124M projection an adapter updates
LORA_PAIRS = {"qkv": (768, 2304), "dense": (768, 768), "fc1": (768, 3072),
              "fc2": (3072, 768)}
LORA_SLOTS = [0, 1, 2, 0, 3, 3, 4, 1]   # the zero adapter and repeats
# the largest top-2 logit gap at which the bf16 engines with and without
# drafting may part: the verify's GEMMs have k + 1 times the rows of the
# decode step's, so cuBLAS sums them in another order, and a bf16 logit
# of magnitude 1-2 moves in steps of 2**-6; card readings 0, 0.0156 and
# 0.0156, the limit four such steps
BF16_TIE = 0.0625


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    """A failed check ends the run (kept under ``python -O``, unlike
    ``assert``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# the kernels whose ptxas report is printed and held to no spill: the
# tensor-core kernels (with their dynamic shared memory), K1's split route,
# N1/N2's row kernel, L1's cluster route and K3's row kernel (static shared
# memory only)
PTXAS_KERNELS = ("flash_fwd_tc_kernel", "paged_prefill_tc_kernel",
                 "flash_dq_tc_kernel", "flash_dkv_tc_kernel",
                 "paged_decode_split_kernel", "rows_norm_kernel",
                 "lora_cluster_kernel", "residual_norm_kernel")
# Itanium-mangled template arguments of those instances: an int, a bool,
# a type, or a substitution (a repeat of an earlier type)
MANGLED_ARG = re.compile(r"Li(-?\d+)E?|Lb([01])E?|(13__nv_bfloat16|6__half|f|a)|S\d*_")
MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32",
                 "a": "int8"}


def template_args(args):
    """``"I13__nv_bfloat16Li8ELi1"`` -> ``"bf16, 8, 1"`` (best effort)."""
    out, types, i = [], [], args.find("I") + 1
    while 0 < i < len(args):
        m = MANGLED_ARG.match(args, i)
        if m is None:
            out.append(args[i:])
            break
        if m.group(1) is not None:
            out.append(m.group(1))
        elif m.group(2) is not None:
            out.append("true" if m.group(2) == "1" else "false")
        else:
            types.append(MANGLED_TYPES[m.group(3)] if m.group(3) else types[-1])
            out.append(types[-1])
        i = m.end()
    return ", ".join(out)


def check_ptxas(build_log, lib):
    """Print what ``ptxas -v`` reported for each instance of
    ``PTXAS_KERNELS`` (registers, static shared memory, spills), with the
    tensor-core kernels' dynamic shared memory, and fail on a spill
    byte."""
    entries, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in PTXAS_KERNELS if k in line), None)
            name = None
            if kernel is None:
                continue
            args = line.split(kernel)[1].split("EE")[0]
            if kernel == "paged_prefill_tc_kernel":
                d = int(args.split("Li")[-1])
                int8 = "Lb1" in args
                smem = lib.apex_paged_prefill_tc_smem(2 if int8 else 1, d)
                name = f"{kernel}<{'int8' if int8 else 'bf16'} cache, D={d}>"
                entries[name] = [f"{smem} bytes dynamic shared memory"]
            elif kernel.endswith("_tc_kernel"):   # apex_flash_{fwd,dq,dkv}_tc_smem
                d = int(args.split("Li")[-1])
                smem = getattr(lib, "apex_" + kernel.replace("_kernel", "_smem"))(d)
                name = f"{kernel}<D={d}>"
                entries[name] = [f"{smem} bytes dynamic shared memory"]
            else:
                name = f"{kernel}<{template_args(args)}>"
                while name in entries:     # a substitution read as the wrong type
                    name += "'"
                entries[name] = []
        elif name is not None and ("Used" in line or "spill" in line):
            entries[name].append(line.split(":", 1)[-1].strip())
    check(all(any(k in n for n in entries) for k in PTXAS_KERNELS),
          f"ptxas reported every listed kernel: {sorted(entries)}")
    spilled = []
    for n, lines in sorted(entries.items()):
        log(f"ptxas {n}: {'; '.join(lines)}")
        spills = [ln for ln in lines if "spill" in ln]
        if not (spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                               for ln in spills)):
            spilled.append(n)
    check(not spilled, f"no spill bytes: {spilled} spill")
    return entries


def device_rows(torch, prof):
    """``(rows, busy_us)`` of a profile: ``(device us, count, name)`` of
    each kernel (and copy, memset) on the card, and their sum.  A user
    annotation (``Optimizer.step#...``) also carries device time, the span
    of the work launched inside it, idle gaps included; it is logged and
    left out of the rows and the sum, which it would count twice."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        row = (getattr(e, "self_device_time_total", 0), e.count, e.key)
        if getattr(e, "is_user_annotation", False):
            log(f"  annotation {e.key[:60]}: spans {row[0] / 1e3:.3f} ms of "
                f"device time")
        else:
            rows.append(row)
    return rows, sum(r[0] for r in rows)


# ------------------------------------------------------------ timing


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each.

    A spin kernel (about 2 ms) runs ahead of the start event, so the host
    has enqueued the whole call before the card reaches it: the interval
    holds device time only, not the wrapper's Python and launch cost."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            self.flush.zero_()
            torch.cuda._sleep(4_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(n_bytes, n_ops, kind):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ------------------------------------------------- phase 2: the kernels


def paged_inputs(torch, q_dtype, cache_dtype, T, seed, groups,
                 lengths=LENGTHS, d=HEAD_DIM):
    """Operands of K1 (T is None) or K2 at the serving shapes, with
    ``groups`` KV heads: a slot of each of ``lengths`` (mixed, including
    0), distinct live blocks per slot and in-range garbage past them."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, mb = len(lengths), MAX_SEQ // BLOCK
    nb = b * mb
    tables = torch.randint(0, nb, (b, mb), generator=gen, device=dev,
                           dtype=torch.int32)
    perm = torch.randperm(nb, generator=gen, device=dev).int()
    nxt = 0
    for i, n in enumerate(lengths):
        live = -(-n // BLOCK)
        tables[i, :live] = perm[nxt:nxt + live]
        nxt += live
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    shape = (nb, BLOCK, groups, d)
    kw = {}
    if cache_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
        kw = {name: torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3
              for name in ("k_scales", "v_scales")}
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(cache_dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(cache_dtype)
    if T is None:
        q = torch.randn((b, N_HEADS, d), generator=gen, device=dev)
        return q.to(q_dtype), k, v, tables, lengths, None, kw
    q = torch.randn((b, T, N_HEADS, d), generator=gen, device=dev)
    limits = torch.zeros((b, T), dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths.tolist()):
        chunk = min(n, T - 16 * (i % 2))       # odd slots end in padding rows
        limits[i, :chunk] = torch.arange(n - chunk + 1, n + 1, device=dev)
    return q.to(q_dtype), k, v, tables, lengths, limits, kw


def paged_cost(q, k, tables, lengths, limits, kw):
    """Bytes each input/output needs once, and the operations, for this
    run's data: live K/V rows only (K2: up to each slot's largest limit)."""
    g, d = k.shape[2], k.shape[3]
    lens = lengths.tolist()
    if limits is None:
        rows_per_slot = lens
        attended = sum(lens) * q.shape[1]
        extra = lengths.numel() * 4
    else:
        maxlim = limits.amax(dim=1).tolist()
        rows_per_slot = [min(n, m) for n, m in zip(lens, maxlim)]
        attended = int(limits.long().sum()) * q.shape[2]
        extra = lengths.numel() * 4 + limits.numel() * 4
    rows = sum(rows_per_slot)
    blocks = sum(-(-r // BLOCK) for r in rows_per_slot)
    n_bytes = (2 * q.numel() * q.element_size()            # q in, out
               + 2 * rows * g * d * k.element_size()        # live K and V
               + (2 * rows * g * 4 if kw else 0)            # int8 row scales
               + blocks * 4 + extra)                        # live table entries
    n_ops = 4 * d * attended                                # QK^T and PV
    return n_bytes, n_ops


def check_paged(torch, F, pa, timer, q_dtype, cache_dtype, T,
                groups=N_HEADS):
    """Kernel vs plain on the card; returns the kernel's record."""
    q, k, v, tables, lengths, limits, kw = paged_inputs(
        torch, q_dtype, cache_dtype, T, seed=7 if T is None else 8,
        groups=groups)
    if T is None:
        kernel = lambda: pa.paged_attention_decode(q, k, v, tables, lengths, **kw)  # noqa: E731
        plain = lambda: pa.paged_attention_decode_plain(q, k, v, tables, lengths, **kw)  # noqa: E731
    else:
        kernel = lambda: pa.paged_prefill_attention(  # noqa: E731
            q, k, v, tables, lengths, limits, **kw)
        plain = lambda: pa.paged_prefill_attention_plain(  # noqa: E731
            q, k, v, tables, lengths, limits, **kw)
    if T is None:
        route, counts, what = pa.decode_route(q, k, v), decode_counts, "K1"
    else:
        route, counts, what = pa.prefill_route(q, k, v), route_counts, "K2"
    before = counts(pa)
    out = kernel()
    torch.cuda.synchronize()
    check_one_launch(counts(pa), before, route,
                     f"{what} {q_dtype}/{cache_dtype}")
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (dict(atol=1e-4, rtol=1e-4) if q_dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    zero_rows = (lengths == 0) if T is None else (limits == 0)
    check(not out[zero_rows].any(), "length/limit 0 gives exact zeros")
    simt = None
    if route == "tc":
        simt = simt_record(torch, timer, ref, tol, lambda: pa._launch_prefill(
            "simt", q, k, v, tables, lengths, limits, kw.get("k_scales"),
            kw.get("v_scales"), None))
    elif route == "split":
        simt = simt_record(torch, timer, ref, tol, lambda: pa._launch_decode(
            "simt", q, k, v, tables, lengths, kw.get("k_scales"),
            kw.get("v_scales"), None))

    # yardstick: one SDPA call over the K/V gathered beforehand (not timed)
    kg, vg, s = pa._gathered_kv(k, v, tables, kw.get("k_scales"),
                                kw.get("v_scales"), N_HEADS // groups)
    kg = kg.to(q_dtype).permute(0, 2, 1, 3).contiguous()   # [B, n, S, d]
    vg = vg.to(q_dtype).permute(0, 2, 1, 3).contiguous()
    cols = torch.arange(s, device="cuda")
    if T is None:
        ql = q[:, :, None, :]
        mask = (cols[None, :] < lengths[:, None])[:, None, None, :]
    else:
        ql = q.permute(0, 2, 1, 3).contiguous()
        mask = (cols[None, None, :] < limits[:, :, None])[:, None]
    library = lambda: F.scaled_dot_product_attention(ql, kg, vg, attn_mask=mask)  # noqa: E731
    n_bytes, n_ops = paged_cost(q, k, tables, lengths, limits, kw)
    b_ms, b_by = bound(n_bytes, n_ops,
                       "fp32" if q_dtype == torch.float32 else "bf16")
    rec = dict(max_abs_err=err, ms=timer(kernel), plain_ms=timer(plain),
               library_ms=timer(library), bound_ms=b_ms, bound_by=b_by,
               kernel_route=route)
    if simt is not None:
        rec["simt"] = simt
    if T is None:             # the same launch with every length 0
        idle = torch.zeros_like(lengths)
        rec["floor_ms"] = timer(lambda: pa.paged_attention_decode(
            q, k, v, tables, idle, **kw))
    return rec


def route_counts(pa):
    return pa.PREFILL_TC_LAUNCHES, pa.PREFILL_SIMT_LAUNCHES


def decode_counts(pa):
    return pa.DECODE_SPLIT_LAUNCHES, pa.DECODE_SIMT_LAUNCHES


def check_one_launch(now, before, route, what):
    """One launch between the per-route counts ``before`` and ``now``
    (the fast route, tc or split, then simt), on ``route``."""
    fast, simt = (a - b for a, b in zip(now, before))
    check((fast, simt) == ((0, 1) if route == "simt" else (1, 0)),
          f"{what}: one launch on the {route} route (fast route {fast}, "
          f"simt {simt})")


def simt_record(torch, timer, ref, tol, simt):
    """The simt route's record on the same operands as a tc check: its
    largest difference from plain (held to the same tolerance) and its
    time."""
    out = simt()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    return dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
                ms=timer(simt))


def paged_edge_inputs(torch, T, groups, cache_dtype, seed):
    """K2 operands at the serving shapes with ``T`` query tokens: limits
    ending at each slot's length, odd slots ending in padding rows."""
    q, k, v, tables, lengths, _, kw = paged_inputs(
        torch, torch.bfloat16, cache_dtype, None, seed=seed, groups=groups)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((B, T, N_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    limits = torch.zeros((B, T), dtype=torch.int32, device="cuda")
    for i, n in enumerate(LENGTHS):
        chunk = min(n, T - 3 * (i % 2))
        limits[i, :chunk] = torch.arange(n - chunk + 1, n + 1, device="cuda")
    return q, k, v, tables, lengths, limits, kw


# the ragged edges of K2's tc route: (T, KV groups, cache); T x (heads per
# group) spans two 64-row tiles with a ragged last one
PAGED_EDGES = ((100, N_HEADS, "bf16"), (37, 4, "int8"), (23, 4, "bf16"))


def check_paged_edges(torch, pa):
    """K2 (tc route) against plain at ``PAGED_EDGES`` (correctness only)."""
    for i, (T, groups, cache) in enumerate(PAGED_EDGES):
        cache_dtype = torch.int8 if cache == "int8" else torch.bfloat16
        q, k, v, tables, lengths, limits, kw = paged_edge_inputs(
            torch, T, groups, cache_dtype, seed=60 + i)
        rows = T * (N_HEADS // groups)
        check(pa._PREFILL_ROWS < rows < 2 * pa._PREFILL_ROWS
              and rows % pa._PREFILL_ROWS, f"K2 edge T={T}: two row tiles, "
              f"the last ragged ({rows} rows)")
        before = route_counts(pa)
        out = pa.paged_prefill_attention(q, k, v, tables, lengths, limits, **kw)
        torch.cuda.synchronize()
        check_one_launch(route_counts(pa), before, "tc",
                         f"K2 edge T={T} {cache}")
        ref = pa.paged_prefill_attention_plain(q, k, v, tables, lengths,
                                               limits, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        check(not out[limits == 0].any(), "limit 0 gives exact zeros")
        log(f"kernel paged_prefill_attention edge [T={T}, {groups} KV groups, "
            f"{rows} rows, {cache} cache]: max |kernel - plain| "
            f"{(out.float() - ref.float()).abs().max().item():.3g}")


# the edges of K1's split route (correctness only): (label, lengths, KV
# groups, cache, head dim); 12 query heads, 16-token pages, 64 pages a slot
DECODE_EDGES = (
    ("ends mid-page", [37, 5, 1000, 129, 250, 0, 3, 500], N_HEADS, "bf16", 64),
    ("at a split boundary", [128, 256, 384, 896, 127, 129, 255, 257],
     N_HEADS, "bf16", 64),
    ("the whole table", [1024, 1024, 1023, 0, 1024, 1, 1024, 512],
     N_HEADS, "int8", 64),
    ("all lengths 0", [0] * 8, N_HEADS, "bf16", 64),
    ("one slot of 1", [1], N_HEADS, "bf16", 64),
    ("hpg 3 over int8", LENGTHS, 4, "int8", 64),
    ("head dim 128", LENGTHS, N_HEADS, "bf16", 128),
)


def check_decode_edges(torch, pa):
    """K1's split route against plain at ``DECODE_EDGES``, each called
    twice in a row: the second call (after the tickets' reset) must equal
    the first bit for bit; a length of 0 gives exact zeros."""
    for i, (label, lengths, groups, cache, d) in enumerate(DECODE_EDGES):
        cache_dtype = torch.int8 if cache == "int8" else torch.bfloat16
        q, k, v, tables, lens, _, kw = paged_inputs(
            torch, torch.bfloat16, cache_dtype, None, seed=80 + i,
            groups=groups, lengths=lengths, d=d)
        check(pa.decode_route(q, k, v) == "split",
              f"K1 edge {label}: takes the split route")
        outs = []
        for _ in range(2):
            before = decode_counts(pa)
            outs.append(pa.paged_attention_decode(q, k, v, tables, lens, **kw))
            torch.cuda.synchronize()
            check_one_launch(decode_counts(pa), before, "split",
                             f"K1 edge {label}")
        ref = pa.paged_attention_decode_plain(q, k, v, tables, lens, **kw)
        torch.testing.assert_close(outs[0].float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        check(torch.equal(outs[0], outs[1]),
              f"K1 edge {label}: a second call equals the first")
        check(not outs[0][lens == 0].any(), "length 0 gives exact zeros")
        log(f"kernel paged_attention_decode edge [{label}: lengths {lengths}, "
            f"{groups} KV groups, {cache} cache, d {d}]: max |kernel - plain| "
            f"{(outs[0].float() - ref.float()).abs().max().item():.3g}")


# K3's cases: (label, x dtype, residual dtype, parameter dtype) at the rows
# of the decode step, the k + 1 verify and a prefill chunk
NORM_CASES = (("bf16", "bf16", "bf16", "fp32"), ("bf16/fp32", "bf16", "fp32", "fp32"),
              ("fp32", "fp32", "fp32", "fp32"))
NORM_ROWS = (B, B * (SPEC_K + 1), B * CHUNK)
DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}


def norm_inputs(torch, rows, hidden, x_dtype, r_dtype, w_dtype, seed,
                bias=True):
    """K3's operands: x, the residual, the skip bias, w, b (on the card)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = {k: getattr(torch, v) for k, v in DTYPES.items()}
    x = torch.randn((rows, hidden), generator=gen, device="cuda").to(dt[x_dtype])
    res = (3 * torch.randn((rows, hidden), generator=gen, device="cuda")).to(dt[r_dtype])
    b = torch.randn((hidden,), generator=gen, device="cuda").to(dt[x_dtype])
    w = (torch.rand((hidden,), generator=gen, device="cuda") + 0.5).to(dt[w_dtype])
    beta = (0.1 * torch.randn((hidden,), generator=gen, device="cuda")).to(dt[w_dtype])
    return x, res, (b if bias else None), w, beta


def norm_close(torch, fo, what, x, res, bias, w, beta):
    """K3 against ``residual_norm_plain`` on the same operands: the normed
    row as ``row_norm_close`` holds N1 (fp32 within 1e-5 of its RMS,
    bf16/fp16 within one step), the new residual bit for bit (the same
    fp32 adds in the same order), and a second call bit for bit the
    first.  Returns the largest difference."""
    before = fo.RESIDUAL_NORM_LAUNCHES
    y, r = fo.fused_residual_norm(x, res, w, beta, bias=bias)
    y2, r2 = fo.fused_residual_norm(x, res, w, beta, bias=bias)
    torch.cuda.synchronize()
    rows = x.numel() // x.shape[-1]
    check(fo.RESIDUAL_NORM_LAUNCHES == before + (2 if rows else 0),
          f"K3 {what}: one launch a call, none for 0 rows")
    check(y.dtype == x.dtype and r.dtype == res.dtype and y.shape == x.shape
          and r.shape == x.shape, f"K3 {what}: x's and the residual's dtypes")
    y_ref, r_ref = fo.residual_norm_plain(x, res, w, beta, bias=bias)
    check(same_bits(torch, y, y2) and same_bits(torch, r, r2),
          f"K3 {what}: a second call equals the first")
    check(same_bits(torch, r, r_ref), f"K3 {what}: the new residual is exact")
    return row_norm_close(torch, f"K3 {what}", y, y_ref)


def check_norm(torch, F, fo, timer, x_dtype, r_dtype, w_dtype, rows):
    """K3 against plain at a serving width, with its times: ``library_ms``
    is ``F.layer_norm`` on the pre-summed row (it does neither add),
    ``chain_ms`` the reference's unfused lowering on the card (the
    separate ops K3 replaces), ``floor_ms`` the same call on one row, and
    ``matmul_ms`` / ``after_matmul_ms`` the dense projection that makes x
    (``ctx @ W^T``, bf16 or fp32 as x) alone and followed by K3."""
    x, res, bias, w, beta = norm_inputs(torch, rows, HIDDEN, x_dtype, r_dtype,
                                        w_dtype, seed=rows)
    err = norm_close(torch, fo, f"{x_dtype}/{r_dtype}/{w_dtype} {rows} rows",
                     x, res, bias, w, beta)
    kernel = lambda: fo.fused_residual_norm(x, res, w, beta, bias=bias)  # noqa: E731
    plain = lambda: fo.residual_norm_plain(x, res, w, beta, bias=bias)  # noqa: E731
    chain = lambda: fo.residual_norm_unfused(x, res, w, beta, bias=bias)  # noqa: E731
    summed = (x.float() + bias.float() + res.float()).to(x.dtype)
    wl, bl = w.to(x.dtype), beta.to(x.dtype)
    library = lambda: F.layer_norm(summed, (HIDDEN,), wl, bl)  # noqa: E731
    one = lambda: fo.fused_residual_norm(x[:1], res[:1], w, beta, bias=bias)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(rows + 1)
    ctx = torch.randn((rows, HIDDEN), generator=gen, device="cuda").to(x.dtype)
    dense = (torch.randn((HIDDEN, HIDDEN), generator=gen, device="cuda")
             / HIDDEN ** 0.5).to(x.dtype)
    matmul = lambda: torch.matmul(ctx, dense.t())  # noqa: E731
    after = lambda: fo.fused_residual_norm(  # noqa: E731
        torch.matmul(ctx, dense.t()), res, w, beta, bias=bias)
    ex, er, ew = x.element_size(), res.element_size(), w.element_size()
    # x, the residual, y and the new residual; the skip bias, w and b
    n_bytes = 2 * rows * HIDDEN * (ex + er) + HIDDEN * (ex + 2 * ew)
    b_ms, b_by = bound(n_bytes, 10 * rows * HIDDEN, "fp32")
    return dict(max_abs_err=err, ms=timer(kernel), plain_ms=timer(plain),
                library_ms=timer(library), bound_ms=b_ms, bound_by=b_by,
                floor_ms=timer(one), chain_ms=timer(chain),
                matmul_ms=timer(matmul), after_matmul_ms=timer(after))


# unmeasured edges of K3: (rows, hidden, x, residual, parameter dtype,
# layout, skip bias); the warp path up to 1024 values a row, the CTA path
# above, and the same two on single values where a row start is not 16-byte
# aligned (hidden 100 and 1500 bf16, the "offset" view)
NORM_EDGES = (
    (40, 100, "bf16", "bf16", "fp32", "contiguous", True),
    (4, 1500, "bf16", "fp32", "fp32", "contiguous", True),
    (8, 8192, "bf16", "bf16", "fp32", "contiguous", True),
    (8, 8192, "fp32", "fp32", "fp32", "contiguous", True),
    (33, 768, "bf16", "bf16", "fp32", "offset", True),
    (0, 768, "bf16", "bf16", "fp32", "contiguous", True),
    (40, 768, "bf16", "bf16", "fp32", "contiguous", False),
    (40, 768, "fp16", "fp16", "fp32", "contiguous", True),
    (40, 768, "fp16", "fp32", "fp16", "contiguous", True),
    (40, 768, "bf16", "bf16", "bf16", "contiguous", True),
    (40, 768, "fp32", "bf16", "fp32", "contiguous", True),
    (1, 1024, "bf16", "fp32", "bf16", "contiguous", False),
)


def check_norm_edges(torch, fo):
    for i, (rows, hidden, xd, rd, wd, layout, with_bias) in enumerate(NORM_EDGES):
        x, res, bias, w, beta = norm_inputs(torch, rows, hidden, xd, rd, wd,
                                            seed=60 + i, bias=with_bias)
        if layout == "offset":      # contiguous, one element off 16 bytes
            flat = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
            x = flat[1:x.numel() + 1].view(x.shape).copy_(x)
            check(x.is_contiguous() and x.data_ptr() % 16,
                  "the edge's x is contiguous and misaligned")
        what = (f"edge {rows} x {hidden} {xd}/{rd}/{wd} {layout}"
                f"{'' if with_bias else ', no bias'}")
        err = norm_close(torch, fo, what, x, res, bias, w, beta)
        log(f"kernel fused_residual_norm {what}: max |kernel - plain| {err:.3g}")


# --------------------------------- phase 2 and 8: the row norms N1/N2


def row_norm_close(torch, what, out, ref):
    """N1/N2 against plain: fp32 within 1e-5 of the plain output's RMS;
    bf16 and fp16 within one step of the type at the element's own
    magnitude (2**-7 of it for bf16, 2**-10 for fp16) beyond that, since
    both round fp32 rows that differ in their last bits once each.
    Returns the largest difference."""
    if not out.numel():
        return 0.0
    diff = (out.float() - ref.float()).abs()
    rms = ref.float().square().mean().sqrt().item()
    err = diff.max().item()
    floor = 1e-5 * rms
    if out.dtype == torch.float32:
        check(err <= floor, f"{what}: max |kernel - plain| {err:.3g} within "
              f"{floor:.3g} (rms {rms:.3g})")
    else:
        step = 2.0 ** -7 if out.dtype == torch.bfloat16 else 2.0 ** -10
        limit = floor + step * ref.float().abs()
        check(bool((diff <= limit).all()), f"{what}: |kernel - plain| "
              f"within one step (max {err:.3g}, rms {rms:.3g})")
    return err


def row_norm_inputs(torch, shape, x_dtype, w_dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hidden = shape[-1]
    x = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(x_dtype)
    w = (torch.rand((hidden,), generator=gen, device="cuda") + 0.5).to(w_dtype)
    b = (0.1 * torch.randn((hidden,), generator=gen, device="cuda")).to(w_dtype)
    return x, w, b


def row_norm_calls(pn, kind, x, w, b):
    """(kernel, plain) callables of N1 (``kind`` "ln") or N2."""
    if kind == "ln":
        return (lambda: pn.pallas_layer_norm(x, w, b),
                lambda: pn.layer_norm_plain(x, w, b))
    return (lambda: pn.pallas_rms_norm(x, w), lambda: pn.rms_norm_plain(x, w))


def launches_of(pn, kind):
    return pn.LAYER_NORM_LAUNCHES if kind == "ln" else pn.RMS_NORM_LAUNCHES


def check_row_norm(torch, F, pn, timer, kind, x_dtype, w_dtype):
    """N1 or N2 against its plain version at the norm path's rows, with
    its times; the yardstick is ``F.layer_norm`` / ``F.rms_norm`` with
    the parameters cast to x's dtype."""
    rows, hidden = TRAIN_BATCH * SEQ, HIDDEN
    x, w, b = row_norm_inputs(torch, (rows, hidden), x_dtype, w_dtype,
                              seed=31 if kind == "ln" else 32)
    kernel, plain = row_norm_calls(pn, kind, x, w, b)
    before = launches_of(pn, kind)
    out = kernel()
    torch.cuda.synchronize()
    check(launches_of(pn, kind) == before + 1, f"{kind} launched its kernel")
    err = row_norm_close(torch, f"{kind} {x_dtype}/{w_dtype}", out, plain())
    wl, bl = w.to(x_dtype), b.to(x_dtype)
    if kind == "ln":
        library = lambda: F.layer_norm(x, (hidden,), wl, bl, 1e-5)  # noqa: E731
    elif hasattr(F, "rms_norm"):
        library = lambda: F.rms_norm(x, (hidden,), wl, 1e-5)  # noqa: E731
    else:
        library = None
    n_params = 2 if kind == "ln" else 1
    n_bytes = 2 * x.numel() * x.element_size() + n_params * hidden * w.element_size()
    n_ops = (8 if kind == "ln" else 4) * x.numel()
    b_ms, b_by = bound(n_bytes, n_ops, "fp32")
    few = row_norm_calls(pn, kind, x[:B], w, b)[0]     # the same call on 8 rows
    return dict(max_abs_err=err, ms=timer(kernel), plain_ms=timer(plain),
                library_ms=None if library is None else timer(library),
                bound_ms=b_ms, bound_by=b_by, floor_ms=timer(few))


# unmeasured edges of N1/N2: (x shape, x dtype, parameter dtype, layout);
# N2 takes its warp path at eight CTAs an SM (up to 96 16-byte chunks a
# row) and at fewer (up to 512), its CTA path above that, and the same two
# on single elements where a row start is not 16-byte aligned (hidden 1
# fp32, 1500 bf16, the "offset" view)
ROW_NORM_EDGES = (
    ((64, 96), "bf16", "fp32", "contiguous"),
    ((64, 100), "fp32", "fp32", "contiguous"),
    ((64, 1024), "bf16", "bf16", "contiguous"),
    ((16, 12288), "fp32", "fp32", "contiguous"),
    ((4, 32768), "bf16", "fp32", "contiguous"),
    ((1, 768), "fp32", "fp32", "contiguous"),
    ((70, 768), "fp16", "fp16", "contiguous"),
    ((70, 768), "fp16", "fp32", "contiguous"),
    ((768,), "bf16", "fp32", "contiguous"),
    ((3, 70, 768), "fp32", "bf16", "transposed"),
    ((0, 768), "bf16", "fp32", "contiguous"),
    ((8, 1), "fp32", "fp32", "contiguous"),
    ((32, 2048), "bf16", "bf16", "contiguous"),
    ((4, 1500), "bf16", "fp32", "contiguous"),
    ((33, 768), "bf16", "fp32", "offset"),
)


def check_row_norm_edges(torch, pn):
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "fp16": torch.float16}
    for i, (shape, xd, wd, layout) in enumerate(ROW_NORM_EDGES):
        x, w, b = row_norm_inputs(torch, shape, dtypes[xd], dtypes[wd], 40 + i)
        if layout == "transposed":          # [3, 768, 70] seen as [3, 70, 768]
            x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
            check(not x.is_contiguous(), "the edge's x is a strided view")
        elif layout == "offset":            # contiguous, one element off 16 bytes
            flat = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
            x = flat[1:x.numel() + 1].view(shape).copy_(x)
            check(x.is_contiguous() and x.data_ptr() % 16,
                  "the edge's x is contiguous and misaligned")
        rows = x.numel() // shape[-1]
        for kind in ("ln", "rms"):
            kernel, plain = row_norm_calls(pn, kind, x, w, b)
            before = launches_of(pn, kind)
            out = kernel()
            torch.cuda.synchronize()
            check(launches_of(pn, kind) == before + (1 if rows else 0),
                  f"{kind} {shape}: one launch per call, none for 0 rows")
            check(out.shape == x.shape and out.dtype == x.dtype,
                  f"{kind} {shape}: x's shape and dtype")
            err = row_norm_close(torch, f"{kind} edge {shape} {xd}/{wd} "
                                 f"{layout}", out, plain())
            log(f"kernel {kind} edge {shape} {xd}/{wd} {layout}: max "
                f"|kernel - plain| {err:.3g}")
    wide = torch.zeros((2, pn.MAX_HIDDEN + 1), device="cuda")
    try:
        pn.pallas_rms_norm(wide, torch.ones(pn.MAX_HIDDEN + 1, device="cuda"))
    except ValueError as e:
        log(f"kernel rms hidden {pn.MAX_HIDDEN + 1}: raises ({e})")
    else:
        check(False, "a row wider than MAX_HIDDEN raises")


NORM_SHAPE = (TRAIN_BATCH, SEQ, HIDDEN)     # GPT-124M's training activation
NORM_PASSES = 10


def norm_path_leaves(torch, dtype, device, seed=21):
    """x, weight, bias and the cotangent of the norm path, drawn on the
    CPU from ``seed`` (so the card and the CPU get the same values)."""
    gen = torch.Generator().manual_seed(seed)
    x = 2.0 * torch.randn(NORM_SHAPE, generator=gen) + 0.5
    w = torch.rand((HIDDEN,), generator=gen) + 0.5
    b = 0.1 * torch.randn((HIDDEN,), generator=gen)
    g = torch.randn(NORM_SHAPE, generator=gen)
    x, g = (t.to(dtype).to(device) for t in (x, g))
    w, b = (t.to(device) for t in (w, b))
    return [t.requires_grad_() for t in (x, w, b)], g


def norm_grads(torch, kind, fn, leaves, g):
    """``[y, dx, dw(, db)]`` of ``fn(x, w, b)`` (N2 takes no bias)."""
    used = leaves if kind == "ln" else leaves[:2]
    y = fn(*leaves)
    return [y] + list(torch.autograd.grad(y, used, g))


def within_rms(what, got, want, frac=1e-5):
    """``got`` within ``frac`` of ``want``'s RMS; returns the ratio."""
    err = (got.detach().float().cpu() - want.detach().float().cpu()).abs().max().item()
    rms = want.detach().float().square().mean().sqrt().item()
    log(f"  {what}: max |card - CPU| {err:.3g} = {err / rms:.3g} of rms {rms:.3g}")
    check(err <= frac * rms, f"{what}: within {frac} of the RMS")
    return err / rms


def norm_path_phase(torch, pn, tn):
    """``pallas_layer_norm`` and ``pallas_rms_norm`` forward and backward
    at GPT-124M's training activation, 10 passes each, bf16 x over fp32
    parameters: N1/N2 once per forward and never in a backward; gradients
    bit for bit those of the same Function over the plain forward; then
    fp32 card vs CPU, and the norm modules card vs CPU."""
    entries = {
        "ln": (lambda x, w, b: pn.pallas_layer_norm(x, w, b),
               lambda x, w, b: pn.LayerNormKernelFunction.apply(
                   x, w, b, 1e-5, pn.layer_norm_plain)),
        "rms": (lambda x, w, b: pn.pallas_rms_norm(x, w),
                lambda x, w, b: pn.RMSNormKernelFunction.apply(
                    x, w, 1e-5, pn.rms_norm_plain)),
    }
    leaves, g = norm_path_leaves(torch, torch.bfloat16, "cuda")
    for kind, (fn, _) in entries.items():     # warm-up, not counted
        norm_grads(torch, kind, fn, leaves, g)
    torch.cuda.synchronize()
    pn.LAYER_NORM_LAUNCHES = pn.RMS_NORM_LAUNCHES = 0
    walls = {"ln": [], "rms": []}
    outs = {}
    for _ in range(NORM_PASSES):
        for kind, (fn, _) in entries.items():
            t0 = time.perf_counter()
            before = launches_of(pn, kind)
            y = fn(*leaves)
            check(launches_of(pn, kind) == before + 1,
                  f"{kind}: one launch per forward")
            grads = torch.autograd.grad(
                y, leaves if kind == "ln" else leaves[:2], g)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            check(launches_of(pn, kind) == before + 1,
                  f"{kind}: no launch in the backward")
            outs[kind] = [y] + list(grads)
    counts = {"pallas_layer_norm": pn.LAYER_NORM_LAUNCHES,
              "pallas_rms_norm": pn.RMS_NORM_LAUNCHES}
    check(counts == {"pallas_layer_norm": NORM_PASSES,
                     "pallas_rms_norm": NORM_PASSES},
          f"N1/N2 launched once per forward: {counts}")
    for kind, (_, plain_fn) in entries.items():
        ref = norm_grads(torch, kind, plain_fn, leaves, g)
        torch.cuda.synchronize()
        y, *grads = outs[kind]
        row_norm_close(torch, f"norm path {kind} y", y, ref[0])
        for name, got, want in zip(("dx", "dw", "db"), grads, ref[1:]):
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"norm path {kind} {name}: bit for bit the plain forward's")
        log(f"norm path[{kind}, {list(NORM_SHAPE)} bf16 x, fp32 params]: "
            f"forward + backward {statistics.median(walls[kind]) * 1e3:.3f} ms "
            f"(median of {NORM_PASSES}, host clock); dx, dw, db bit for bit "
            f"the plain forward's; dtypes {[str(t.dtype) for t in grads]}")

    log("norm path card vs CPU (fp32, same seed):")
    for kind, (fn, _) in entries.items():
        card = norm_grads(torch, kind, fn,
                          *norm_path_leaves(torch, torch.float32, "cuda"))
        cpu = norm_grads(torch, kind, fn,
                         *norm_path_leaves(torch, torch.float32, "cpu"))
        for name, a, c in zip(("y", "dx", "dw", "db"), card, cpu):
            within_rms(f"{kind} {name}", a, c)
    modules = (("FusedRMSNorm", dict()), ("MixedFusedLayerNorm", dict()),
               ("FusedLayerNorm", dict(elementwise_affine=False)))
    for name, kw in modules:
        for memory_efficient in (False, True):
            results = []
            for device in ("cuda", "cpu"):
                (x, w, b), g = norm_path_leaves(torch, torch.float32, device)
                mod = getattr(tn, name)(HIDDEN, memory_efficient=memory_efficient,
                                        device=device, **kw)
                with torch.no_grad():
                    for p, v in zip(mod.parameters(), (w, b)):
                        p.copy_(v)
                params = list(mod.parameters())
                y = mod(x)
                results.append([y] + list(torch.autograd.grad(y, [x] + params, g)))
            for what, a, c in zip(("y", "dx", "dscale", "dbias"), *results):
                within_rms(f"{name}({kw}, memory_efficient={memory_efficient}) "
                           f"{what}", a, c)
    return counts


def verify_limits(torch, lengths):
    """Per-position limits of a k+1 verify over slots of ``lengths``
    (the draft rows included): slot i drafts min(i % 5, length - 1)
    tokens, position t sees up to ``pos + t + 1``, the rest is padding
    (limit 0); a slot of length 0 is inactive."""
    limits = torch.zeros((len(lengths), SPEC_K + 1), dtype=torch.int32,
                         device="cuda")
    for i, n in enumerate(lengths):
        if n:
            w = min(i % (SPEC_K + 1), n - 1) + 1
            limits[i, :w] = torch.arange(n - w + 1, n + 1, device="cuda")
    return limits


def check_verify(torch, F, pa, timer, cache_dtype):
    """K2 at the verify width through the decode entry point (4-D q and
    limits): fewer query rows than its 16-row tile, padding rows exact
    zeros."""
    _, k, v, tables, lengths, _, kw = paged_inputs(
        torch, torch.bfloat16, cache_dtype, None, seed=9, groups=N_HEADS)
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn((B, SPEC_K + 1, N_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    limits = verify_limits(torch, LENGTHS)
    kernel = lambda: pa.paged_attention_decode(  # noqa: E731
        q, k, v, tables, lengths, limits=limits, **kw)
    plain = lambda: pa.paged_prefill_attention_plain(  # noqa: E731
        q, k, v, tables, lengths, limits, **kw)
    before = pa.PREFILL_LAUNCHES
    routes = route_counts(pa)
    out = kernel()
    torch.cuda.synchronize()
    check(pa.PREFILL_LAUNCHES == before + 1, "the verify launched K2")
    check_one_launch(route_counts(pa), routes, "tc", "K2 verify")
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    tol = dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    check(int((limits == 0).sum()) > B and not out[limits == 0].any(),
          "verify padding rows (limit 0) give exact zeros")
    simt = simt_record(torch, timer, ref, tol, lambda: pa._launch_prefill(
        "simt", q, k, v, tables, lengths, limits, kw.get("k_scales"),
        kw.get("v_scales"), None))
    kg, vg, s = pa._gathered_kv(k, v, tables, kw.get("k_scales"),
                                kw.get("v_scales"), 1)
    kg = kg.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    vg = vg.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    cols = torch.arange(s, device="cuda")
    mask = (cols[None, None, :] < limits[:, :, None])[:, None]
    ql = q.permute(0, 2, 1, 3).contiguous()
    library = lambda: F.scaled_dot_product_attention(ql, kg, vg, attn_mask=mask)  # noqa: E731
    b_ms, b_by = bound(*paged_cost(q, k, tables, lengths, limits, kw), "bf16")
    return dict(max_abs_err=err, ms=timer(kernel), plain_ms=timer(plain),
                library_ms=timer(library), bound_ms=b_ms, bound_by=b_by,
                kernel_route="tc", simt=simt)


def lora_inputs(torch, x_dtype, w_dtype, proj, S, strided):
    """x [S, 8, in] (a sequence-major view of a [8, S, in] tensor when
    ``strided``), the arena's A [5, in, 8] and pre-scaled B [5, 8, out]
    with slot 0 the zero adapter, and the slot vector."""
    n_in, n_out = LORA_PAIRS[proj]
    gen = torch.Generator(device="cuda").manual_seed(n_in + n_out + S)
    n_slots = ADAPTERS + 1
    if strided:
        x = torch.randn((B, S, n_in), generator=gen, device="cuda")
        x = x.to(x_dtype).transpose(0, 1)
    else:
        x = torch.randn((S, B, n_in), generator=gen, device="cuda").to(x_dtype)
    a = 0.25 * torch.randn((n_slots, n_in, RANK), generator=gen, device="cuda")
    b = 0.5 * torch.randn((n_slots, RANK, n_out), generator=gen, device="cuda")
    a[0] = 0.0
    b[0] = 0.0
    slots = torch.tensor(LORA_SLOTS, dtype=torch.int32, device="cuda")
    return x, a.to(w_dtype), b.to(w_dtype), slots


def lora_counts(lo):
    return lo.CLUSTER_LAUNCHES, lo.SIMT_LAUNCHES


def lora_close(torch, what, out, ref, n_in):
    """L1 against its plain version: fp32 within 1e-5 of the output's RMS
    times sqrt(in / 768) (both sum ``in`` products of the first product
    in another order, so their difference grows with the square root of
    its length; card readings 1.2e-5 of the RMS at in = 3072, 0.8e-5 at
    768); bf16 within 0.01 of the RMS plus one bf16 step at the element's
    own magnitude (2**-7 of it: both round fp32 sums that differ in the
    last bits once each, so an element near a rounding boundary may land
    one step apart, and a step at 4 RMS is 0.03 RMS; card readings up to
    0.015 of the RMS).  Returns the largest difference and its ratio to
    the RMS."""
    diff = (out.float() - ref.float()).abs()
    rms = ref.float().square().mean().sqrt().item()
    err = diff.max().item()
    if out.dtype == torch.float32:
        limit = 1e-5 * rms * (n_in / 768) ** 0.5
        check(err <= limit, f"{what} fp32: max |kernel - plain| {err:.3g} "
              f"within {limit:.3g} (rms {rms:.3g})")
    else:
        limit = 0.01 * rms + 2.0 ** -7 * ref.float().abs()
        check(bool((diff <= limit).all()), f"{what} bf16: max |kernel - "
              f"plain| {err:.3g} (rms {rms:.3g})")
    return err, err / rms if rms else 0.0


def check_lora(torch, lo, timer, x_dtype, w_dtype, proj, S, timed=True):
    """L1 through the route ``lora_route`` names against its plain
    version (``lora_close``; the plain version through ``lora_delta(...,
    fused=False)``, which launches nothing), the zero adapter's rows
    exactly 0; a
    cluster-route check also holds and times the simt route on the same
    operands (``rec["simt"]``).  ``floor_ms`` is the same launch with
    nothing to do: every slot out of range, so each CTA reads its slot and
    writes NaN rows, and no x, A or B is read."""
    x, a, b, slots = lora_inputs(torch, x_dtype, w_dtype, proj, S,
                                 strided=S == SPEC_K + 1)
    n_in, n_out = LORA_PAIRS[proj]
    route = lo.lora_route(x, a, b)
    kernel = lambda: lo.lora_delta(x, a, b, slots)  # noqa: E731
    plain = lambda: lo.lora_delta_plain(x, a, b, slots)  # noqa: E731
    before = lora_counts(lo)
    out = kernel()
    torch.cuda.synchronize()
    check_one_launch(lora_counts(lo), before, route, f"L1 {proj} S={S}")
    before = lora_counts(lo)
    ref = lo.lora_delta(x, a, b, slots, fused=False)
    torch.cuda.synchronize()
    check(lora_counts(lo) == before, f"L1 {proj} S={S}: lora_delta("
          f"fused=False) launches nothing")
    err, rel = lora_close(torch, f"L1 {proj} S={S}", out, ref, n_in)
    zero = slots == 0
    check(not out[:, zero].any(), f"L1 {proj} S={S}: zero-slot rows are 0")
    rec = dict(max_abs_err=err, err_over_rms=rel, kernel_route=route,
               share_unequal=float((out != ref).float().mean()))
    simt = None
    if route != "simt":
        simt = lambda: lo._launch("simt", x, a, b, slots)  # noqa: E731
        s_out = simt()
        torch.cuda.synchronize()
        s_err, _ = lora_close(torch, f"L1 simt {proj} S={S}", s_out, ref, n_in)
        rec["simt"] = dict(max_abs_err=s_err)
    if not timed:
        return rec
    ag_idx = slots.long()

    def library():
        ag = a.index_select(0, ag_idx)
        bg = b.index_select(0, ag_idx)
        return torch.bmm(torch.bmm(x.transpose(0, 1).to(a.dtype), ag), bg)

    distinct = len(set(LORA_SLOTS))
    n_bytes = (x.numel() * x.element_size() + out.numel() * out.element_size()
               + distinct * RANK * (n_in + n_out) * a.element_size()
               + slots.numel() * 4)
    n_ops = 2 * S * B * RANK * (n_in + n_out)
    b_ms, b_by = bound(n_bytes, n_ops,
                       "fp32" if x_dtype == torch.float32 else "bf16")
    if simt is not None:
        rec["simt"]["ms"] = timer(simt)
    idle = torch.full_like(slots, -1)
    rec.update(ms=timer(kernel), plain_ms=timer(plain),
               library_ms=timer(library), bound_ms=b_ms, bound_by=b_by,
               floor_ms=timer(lambda: lo.lora_delta(x, a, b, idle)))
    return rec


# unmeasured edges of L1: (label, x dtype, arena dtype, S, in, r, out,
# x layout, slots, route); "offset" is a sequence-major view of a
# [B, S, in + 1] buffer one element past a 16-byte boundary, so no x row
# is aligned; slots "mixed" are LORA_SLOTS, "zero" all the zero adapter,
# "bad" LORA_SLOTS with slot 2 out of range (its rows NaN)
LORA_EDGES = (
    ("S=1", "bf16", "fp32", 1, 768, 8, 2304, "contiguous", "mixed", "cluster"),
    ("S=17", "bf16", "fp32", 17, 768, 8, 768, "contiguous", "mixed", "cluster"),
    ("S=129", "bf16", "bf16", 129, 768, 8, 3072, "contiguous", "mixed", "cluster"),
    ("S=129 fp32", "fp32", "fp32", 129, 3072, 8, 768, "contiguous", "mixed",
     "cluster"),
    ("out 1000, off the column tile", "bf16", "fp32", 5, 768, 8, 1000,
     "contiguous", "mixed", "cluster"),
    ("out 1001, unaligned rows", "bf16", "fp32", 5, 768, 8, 1001,
     "contiguous", "mixed", "cluster"),
    ("in 3072, r 4", "bf16", "fp32", 5, 3072, 4, 768, "contiguous", "mixed",
     "cluster"),
    ("in 3072, r 16", "bf16", "fp32", 128, 3072, 16, 768, "contiguous",
     "mixed", "cluster"),
    ("in 770, out 24", "fp32", "bf16", 5, 770, 8, 24, "contiguous", "mixed",
     "cluster"),
    ("strided misaligned x", "bf16", "fp32", 5, 768, 8, 768, "offset",
     "mixed", "cluster"),
    ("every slot the zero adapter", "bf16", "fp32", 5, 768, 8, 2304,
     "contiguous", "zero", "cluster"),
    ("a slot out of range", "bf16", "fp32", 5, 768, 8, 768, "contiguous",
     "bad", "cluster"),
    ("r 12", "bf16", "fp32", 5, 768, 12, 768, "contiguous", "mixed", "simt"),
)


def same_bits(torch, p, q):
    """Bit for bit equal (NaN rows included)."""
    ints = torch.int32 if p.element_size() == 4 else torch.int16
    return p.dtype == q.dtype and torch.equal(p.view(ints), q.view(ints))


def check_lora_edges(torch, lo):
    """L1 at ``LORA_EDGES`` on the route each names, each called twice in
    a row: the second call bit for bit the first; against plain within
    ``lora_close``; the zero adapter's rows exact zeros, an out-of-range
    slot's rows NaN."""
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    for e, (label, xd, wd, S, n_in, r, n_out, layout, kind,
            route) in enumerate(LORA_EDGES):
        gen = torch.Generator(device="cuda").manual_seed(90 + e)
        n_slots = ADAPTERS + 1
        x = torch.randn((B, S, n_in), generator=gen, device="cuda")
        if layout == "offset":
            flat = torch.empty(B * S * (n_in + 1) + 1, device="cuda",
                               dtype=dtypes[xd])
            view = flat[1:].view(B, S, n_in + 1)[..., :n_in]
            view.copy_(x)
            x = view.transpose(0, 1)
            check(x.data_ptr() % 16 and x.stride(2) == 1,
                  "the edge's x is a misaligned strided view")
        else:
            x = x.to(dtypes[xd]).transpose(0, 1).contiguous()
        a = 0.25 * torch.randn((n_slots, n_in, r), generator=gen, device="cuda")
        b = 0.5 * torch.randn((n_slots, r, n_out), generator=gen, device="cuda")
        a[0] = 0.0
        b[0] = 0.0
        a, b = a.to(dtypes[wd]), b.to(dtypes[wd])
        picked = {"zero": [0] * B, "bad": [n_slots if s == 2 else s
                                           for s in LORA_SLOTS]}.get(kind, LORA_SLOTS)
        slots = torch.tensor(picked, dtype=torch.int32, device="cuda")
        check(lo.lora_route(x, a, b) == route, f"L1 edge {label}: takes the "
              f"{route} route")
        outs = []
        for _ in range(2):
            before = lora_counts(lo)
            outs.append(lo.lora_delta(x, a, b, slots))
            torch.cuda.synchronize()
            check_one_launch(lora_counts(lo), before, route, f"L1 edge {label}")
        check(same_bits(torch, outs[0], outs[1]),
              f"L1 edge {label}: a second call is bit for bit the first")
        out = outs[0]
        good = slots < n_slots
        ref = lo.lora_delta_plain(x, a, b, torch.where(good, slots, 0))
        check(bool(out[:, ~good].isnan().all()),
              f"L1 edge {label}: out-of-range slots give NaN rows")
        check(not out[:, slots == 0].any(),
              f"L1 edge {label}: zero-slot rows are 0")
        err, _ = lora_close(torch, f"L1 edge {label}", out[:, good],
                            ref[:, good], n_in)
        log(f"kernel lora_delta edge [{label}: x/arena {xd}/{wd}, S={S}, in "
            f"{n_in}, r {r}, out {n_out}, {layout} x, {kind} slots, {route}]: "
            f"max |kernel - plain| {err:.3g}")


# ----------------------------------------- phase 2: the flash kernels


def flash_inputs(torch, dtype, seed, segments):
    """q, k, v, do at the training shape; with ``segments``, 4 packed
    documents per sequence at random boundaries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (TRAIN_BATCH, N_HEADS, SEQ, HEAD_DIM)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    seg = None
    if segments:
        cuts = torch.sort(torch.randint(1, SEQ, (TRAIN_BATCH, 3),
                                        generator=gen, device="cuda")).values
        pos = torch.arange(SEQ, device="cuda")
        seg = (pos[None, :, None] >= cuts[:, None, :]).sum(-1).int()
    return q, k, v, do, seg


def causal_mask(torch, seg):
    """The [b or 1, 1, s, s] boolean mask the kernels apply (True =
    attend)."""
    pos = torch.arange(SEQ, device="cuda")
    mask = (pos[:, None] >= pos[None, :])[None, None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
    return mask


def flash_costs(q, seg_bytes, pairs):
    """Bytes each input/output needs once, and the operations, of F1, F2
    and F3 for this run's data (``pairs``: the (row, col) pairs the masks
    leave, all heads; each is a 2*d multiply-add row per product)."""
    n = q.numel() * q.element_size()
    rows = q.numel() // q.shape[-1] * 4          # one fp32 per row
    d = q.shape[-1]
    return {"fwd": (4 * n + rows + seg_bytes, pairs * 4 * d),      # QK, PV
            "dq": (5 * n + 2 * rows + seg_bytes, pairs * 6 * d),   # QK, dO V, dS K
            "dkv": (6 * n + 2 * rows + seg_bytes, pairs * 8 * d)}  # + P dO, dS Q


FLASH_NAMES = ("out", "lse", "dq", "dk", "dv")
# bf16 out and dq: the largest |kernel - plain| allowed, times the plain
# tensor's RMS (about twice the largest card reading, see flash_close)
BF16_RMS_LIMIT = {"out": 0.08, "dq": 0.02}


def exact_bwd(torch, fa, q, k, v, do, lse, delta, seg_q, seg_k, seed, *,
              causal, q_offset=0, kv_offset=0, dropout_rate=0.0):
    """``{"dq", "dk", "dv"}`` of F2/F3 summed in fp64, with the kernels'
    bf16 rounding points (dS before dS K and dS^T Q, the dropped P before
    P^T dO) taken on the fp64 values: the gradient the fp32 sums of every
    route approximate."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    row_g = q_offset + torch.arange(sq, device="cuda")
    col_g = kv_offset + torch.arange(sk, device="cuda")
    mask = torch.ones((1, 1, sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        mask = mask & (row_g[:, None] >= col_g[None, :])
    if seg_q is not None:
        mask = mask & (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    lse_safe = torch.where(lse <= fa.NEG_INF * 0.5, 0.0, lse).double()
    p = torch.where(mask, torch.exp(q64 @ k64.transpose(-1, -2) * scale
                                    - lse_safe[..., None]), 0.0)
    dp = do64 @ v64.transpose(-1, -2)
    p_drop = p
    if dropout_rate:
        keep = fa._block_keep(seed, b, h, row_g, col_g, dropout_rate)
        p_drop = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
    ds = (p * (dp - delta.double()[..., None]) * scale).to(
        torch.bfloat16).double()
    p_drop = p_drop.to(torch.bfloat16).double()
    return {"dq": ds @ k64, "dk": ds.transpose(-1, -2) @ q64,
            "dv": p_drop.transpose(-1, -2) @ do64}


def flash_close(torch, what, got, want, dkv_exact=True, exact=None):
    """Kernel ``(out, lse, dq, dk, dv)`` against plain; logs and returns
    each one's largest difference.

    - fp32 results (all of an fp32 run, and lse always) agree to 1e-4
      absolute and relative (card readings: 1e-6 or less);
    - in bf16, dk and dv must be bit-identical to plain (every card
      reading, bench shape and ragged edges: 0), so a rounding point of
      F3 (dS to Q's type, the dropped P to dO's) that moved would show;
    - in bf16, out and dq differ from plain by at most ``BF16_RMS_LIMIT``
      times the plain tensor's RMS, its typical magnitude.  The RMS of
      out is about 0.12 at the bench shape and 0.18 with packed segments,
      of dq about 0.11 and 0.14; the largest card readings were 3.9e-3
      and 7.8e-3 (0.032 and 0.044 of the RMS) for out, 9.8e-4 (0.0092)
      for dq.  The kernel's 64-key tiles round P against another running
      max than plain's 512-key blocks, and its fp32 sums run in another
      order; out moves most in the early rows, whose few terms are of
      order 1.
    - ``dkv_exact=False`` (the bf16 edges at head dims 80 and 24): dk and
      dv within one bf16 step at each element's magnitude (2**-7 of it).
      Bit-identity needs plain's fp32 GEMM to sum the query rows in F3's
      order; at sq 200 and head dim 80 cuBLAS sums them in another, and
      one element of dv landed one step (9.5e-7 at magnitude 2e-4) from
      plain (card reading; F3 is the same code as at the other shapes).
    - ``exact`` (the tensor-core route of F2/F3, given :func:`exact_bwd`'s
      fp64 gradient): bf16 dq, dk and dv no farther from the fp64 gradient
      than plain is, plus one bf16 step at the gradient's largest element
      (2**-7 of it).  The tc route's fp32 sums (the tensor cores' order, and
      __expf) differ from plain's by about 1e-6 relative, and a P or dS
      term that lands beside a bf16 rounding boundary then rounds one step
      the other way: a term of order 1 times a dO or Q of order 3 moves an
      output by up to 0.016.  So neither bit-identity nor a bound against
      plain's RMS holds (card readings at the bench shapes: up to 0.106 of
      the RMS for dv, 0.073 for dk, 0.035 for dq), while plain itself lies
      up to 0.118, 0.073 and 0.110 of the RMS from the fp64 gradient, and
      the tc route exactly as far."""
    err, rms = [], []
    for g, w in zip(got, want):
        err.append((g.float() - w.float()).abs().max().item())
        rms.append(w.float().square().mean().sqrt().item())
    log(f"kernel flash F1-F3 {what}: max |kernel - plain| "
        + ", ".join(f"{n} {e:.3g} ({e / max(r, 1e-30):.3g} of rms {r:.3g})"
                    for n, e, r in zip(FLASH_NAMES, err, rms)))
    for name, g, w, e, r in zip(FLASH_NAMES, got, want, err, rms):
        if g.dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        elif exact is not None and name in exact:
            x = exact[name]
            e_k = (g.double() - x).abs().max().item()
            e_p = (w.double() - x).abs().max().item()
            slack = 2.0 ** -7 * x.abs().max().item()
            log(f"  {what} {name}: max |kernel - fp64| {e_k:.4g}, max |plain - "
                f"fp64| {e_p:.4g}, one step at the largest {slack:.3g}")
            check(e_k <= e_p + slack, f"{what}: bf16 {name} as close to the "
                  f"fp64 gradient as plain ({e_k:.4g} > {e_p:.4g} + {slack:.3g})")
        elif name in ("dk", "dv") and dkv_exact:
            check(torch.equal(g, w), f"{what}: bf16 {name} bit-identical "
                  f"to plain (max |diff| {e:.3g})")
        elif name in ("dk", "dv"):
            step = 2.0 ** -7 * w.float().abs()
            check(bool(((g.float() - w.float()).abs() <= step).all()),
                  f"{what}: bf16 {name} within one step of plain (max "
                  f"|diff| {e:.3g})")
        else:
            limit = BF16_RMS_LIMIT[name] * r
            check(e <= limit, f"{what}: bf16 {name} within {limit:.3g} of "
                  f"plain (max |diff| {e:.3g})")
    return err


# the ragged edges of F1-F3: lengths off the 64-row tile, sq != sk, global
# offsets (the third case leaves its first 17 query rows no key), head
# dims below, between and at the compiled 64 and 128 columns
FLASH_EDGES = (
    (1, 2, 37, 37, 16, "fp32", dict(causal=False)),
    (1, 2, 130, 70, 32, "fp32", dict(causal=True, q_offset=10, kv_offset=40)),
    (1, 2, 37, 70, 16, "fp32", dict(causal=True, q_offset=3, kv_offset=20)),
    (2, 2, 100, 100, 64, "bf16", dict(causal=True, segments=True,
                                      dropout_rate=0.3)),
    (1, 2, 200, 200, 128, "bf16", dict(causal=True)),
    (1, 2, 200, 130, 80, "fp32", dict(causal=False)),
    (1, 2, 200, 130, 80, "bf16", dict(causal=False, dkv_exact=False)),
    (1, 2, 130, 70, 24, "bf16", dict(causal=True, q_offset=10, kv_offset=40,
                                     dkv_exact=False)),
)


def check_flash_edges(torch, fa):
    """F1, F2 and F3 against their plain versions at the shapes of
    ``FLASH_EDGES`` (correctness only, no timing); a bf16 case runs F2/F3
    on both routes."""
    for i, (b, h, sq, sk, d, kind, case) in enumerate(FLASH_EDGES):
        kw = dict(case)
        dkv_exact = kw.pop("dkv_exact", True)
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, do = (torch.randn((b, h, sq, d), generator=gen,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((b, h, sk, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        seg_q = seg_k = seed = None
        if kw.pop("segments", False):
            seg_q = (torch.arange(sq, device="cuda") * 3 // sq).repeat(b, 1).int()
            seg_k = (torch.arange(sk, device="cuda") * 3 // sk).repeat(b, 1).int()
        if kw.get("dropout_rate"):
            seed = torch.tensor([4321], dtype=torch.int32, device="cuda")
        skw = dict(kw, segment_ids_q=seg_q, segment_ids_kv=seg_k,
                   dropout_seed=seed)
        route = fa.fwd_route(q, k, v)
        check(route == ("tc" if kind == "bf16" else "simt")
              and fa.bwd_route(q, k, v, do) == route,
              f"flash edge {i}: {kind} takes the {route} route")
        before = fwd_route_counts(fa)
        with torch.no_grad():
            out, lse = fa.flash_attention_with_lse(q, k, v, **skw)
            check_one_launch(fwd_route_counts(fa), before, route,
                             f"flash edge {i}")
            ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, seg_q, seg_k,
                                                  seed, **kw)
            delta = (do.float() * ref_out.float()).sum(-1)
            args = (q, k, v, do, ref_lse, delta)
            before = bwd_route_counts(fa)
            dq = fa.dq_chunk(*args, **skw)
            dk, dv = fa.dkv_chunk(*args, **skw)
            check_bwd_launches(bwd_route_counts(fa), before, route,
                               f"flash edge {i}")
            ref_dq = fa.flash_dq_plain(*args, seg_q, seg_k, seed, **kw)
            ref_dk, ref_dv = fa.flash_dkv_plain(*args, seg_q, seg_k, seed,
                                                **kw)
            grads = {"kernel": (dq, dk, dv)}
            exact = None
            if route == "tc":
                exact = exact_bwd(torch, fa, *args, seg_q, seg_k, seed, **kw)
                bkw = dict(dict(scale=None, q_offset=0, kv_offset=0,
                                dropout_rate=0.0), **kw)
                bargs = (*args, seg_q, seg_k, seed)
                grads["simt route"] = (fa._dq(*bargs, route="simt", **bkw),
                                       *fa._dkv(*bargs, route="simt", **bkw))
        torch.cuda.synchronize()
        label = f"edge [b{b} h{h} sq{sq} sk{sk} d{d} {kind} {case}]"
        refs = (ref_out, ref_lse, ref_dq, ref_dk, ref_dv)
        flash_close(torch, f"{label} ({route} route)", (out, lse, dq, dk, dv),
                    refs, dkv_exact, exact)
        if "simt route" in grads:
            flash_close(torch, f"{label} (F2/F3 simt route)",
                        (out, lse, *grads["simt route"]), refs, dkv_exact)
        blind = kw.get("kv_offset", 0) - kw.get("q_offset", 0)
        if kw.get("causal") and blind > 0:
            check(not out[:, :, :blind].any()
                  and all(not g[0][:, :, :blind].any() for g in grads.values())
                  and bool((lse[:, :, :blind] == fa.NEG_INF).all()),
                  "rows that see no key give output 0, lse -1e30, dq 0")


def fwd_route_counts(fa):
    return fa.FWD_TC_LAUNCHES, fa.FWD_SIMT_LAUNCHES


def bwd_route_counts(fa):
    return (fa.DQ_TC_LAUNCHES, fa.DQ_SIMT_LAUNCHES, fa.DKV_TC_LAUNCHES,
            fa.DKV_SIMT_LAUNCHES)


def check_bwd_launches(now, before, route, what):
    """One F2 and one F3 launch between the per-route counts ``before``
    and ``now``, both on ``route``."""
    check_one_launch(now[:2], before[:2], route, f"{what} F2")
    check_one_launch(now[2:], before[2:], route, f"{what} F3")


def check_flash(torch, F, fa, timer, label, dtype, segments=False,
                dropout=0.0):
    """F1, F2 and F3 against their plain versions on the card; returns
    each kernel's record.  F2/F3 take the plain forward's lse and delta,
    so each kernel is held alone.  A bf16 case also holds and times the
    simt route of each on the same operands."""
    q, k, v, do, seg = flash_inputs(torch, dtype, 11, segments)
    seed = (torch.tensor([1234], dtype=torch.int32, device="cuda")
            if dropout else None)
    kw = dict(causal=True, dropout_rate=dropout)
    skw = dict(kw, segment_ids_q=seg, segment_ids_kv=seg, dropout_seed=seed)
    bkw = dict(kw, scale=None, q_offset=0, kv_offset=0)
    with torch.no_grad():
        fwd = lambda: fa.flash_attention_with_lse(q, k, v, **skw)  # noqa: E731
        fwd_plain = lambda: fa.flash_fwd_plain(q, k, v, seg, seg, seed, **kw)  # noqa: E731
        route = fa.fwd_route(q, k, v)
        check(route == ("simt" if dtype == torch.float32 else "tc")
              and fa.bwd_route(q, k, v, do) == route,
              f"{label}: F1-F3 take the {route} route")
        before = fwd_route_counts(fa)
        out, lse = fwd()
        torch.cuda.synchronize()
        check_one_launch(fwd_route_counts(fa), before, route, label)
        ref_out, ref_lse = fwd_plain()
        delta = (do.float() * ref_out.float()).sum(-1)
        args = (q, k, v, do, ref_lse, delta)
        dq_k = lambda: fa.dq_chunk(*args, **skw)  # noqa: E731
        dkv_k = lambda: fa.dkv_chunk(*args, **skw)  # noqa: E731
        dq_p = lambda: fa.flash_dq_plain(*args, seg, seg, seed, **kw)  # noqa: E731
        dkv_p = lambda: fa.flash_dkv_plain(*args, seg, seg, seed, **kw)  # noqa: E731
        before = bwd_route_counts(fa)
        dq, (dk, dv) = dq_k(), dkv_k()
        torch.cuda.synchronize()
        check_bwd_launches(bwd_route_counts(fa), before, route, label)
        ref_dq, (ref_dk, ref_dv) = dq_p(), dkv_p()
        exact = (exact_bwd(torch, fa, *args, seg, seg, seed, **kw)
                 if route == "tc" else None)
    refs = (ref_out, ref_lse, ref_dq, ref_dk, ref_dv)
    err = flash_close(torch, label, (out, lse, dq, dk, dv), refs,
                      exact=exact)
    del exact
    simt = {}
    if route == "tc":                  # the simt routes on the same operands
        sargs = (q, k, v, seg, seg, seed)
        simt_fwd = lambda: fa._fwd(*sargs, route="simt", **bkw)  # noqa: E731
        bargs = (*args, seg, seg, seed)
        simt_dq = lambda: fa._dq(*bargs, route="simt", **bkw)  # noqa: E731
        simt_dkv = lambda: fa._dkv(*bargs, route="simt", **bkw)  # noqa: E731
        with torch.no_grad():
            s_out, s_lse = simt_fwd()
            s_dq, (s_dk, s_dv) = simt_dq(), simt_dkv()
            torch.cuda.synchronize()
            s_err = flash_close(torch, f"{label} (simt route)",
                                (s_out, s_lse, s_dq, s_dk, s_dv), refs)
            simt = {"flash_fwd": dict(max_abs_err=max(s_err[:2]),
                                      ms=timer(simt_fwd)),
                    "flash_dq": dict(max_abs_err=s_err[2], ms=timer(simt_dq)),
                    "flash_dkv": dict(max_abs_err=max(s_err[3:]),
                                      ms=timer(simt_dkv))}

    # yardstick: SDPA with the same mask (not with dropout: its mask is
    # another function), forward and backward (dq, dk, dv together)
    library = library_bwd = None
    if not dropout:
        mask = causal_mask(torch, seg) if segments else None
        sdpa_kw = (dict(attn_mask=mask) if segments else dict(is_causal=True))
        library = lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw)  # noqa: E731
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
        library_bwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, do, retain_graph=True)
    pairs = int(causal_mask(torch, seg).sum()) * N_HEADS * (
        1 if segments else TRAIN_BATCH)
    seg_bytes = 2 * seg.numel() * 4 if segments else 0
    kind = "fp32" if dtype == torch.float32 else "bf16"
    costs = flash_costs(q, seg_bytes, pairs)
    lib_bwd_ms = None if library_bwd is None else timer(library_bwd)
    recs = {}
    for name, kernel, plain, e, lib in (
            ("flash_fwd", fwd, fwd_plain, max(err[:2]),
             None if library is None else timer(library)),
            ("flash_dq", dq_k, dq_p, err[2], lib_bwd_ms),
            ("flash_dkv", dkv_k, dkv_p, max(err[3:]), lib_bwd_ms)):
        b_ms, b_by = bound(*costs[name.split("_")[1]], kind)
        with torch.no_grad():
            recs[name] = dict(max_abs_err=e, ms=timer(kernel),
                              plain_ms=timer(plain), library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by)
    for name, rec in recs.items():
        rec["kernel_route"] = route
        if name in simt:
            rec["simt"] = simt[name]
    return recs


# --------------------------------------------- phase 3/4: the engine


def gpt124m(torch, dtype):
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )
    return TransformerConfig(
        hidden_size=768, num_layers=12, num_attention_heads=12,
        padded_vocab_size=50304, max_position_embeddings=MAX_SEQ, dtype=dtype)


def wave(np, n=16, seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 601, n)
    lens[0], lens[1] = 600, 64
    return [rng.integers(1, 50257, int(m)).tolist() for m in lens]


def motif_wave(np, n=16, seed=1):
    """Template-heavy prompts: a random motif of 4-16 tokens repeated to
    64-600 tokens, then a 4-token random suffix."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        motif = rng.integers(1, 50257, int(rng.integers(4, 17))).tolist()
        total = int(rng.integers(64, 601))
        body = (motif * (total // len(motif) + 1))[:total]
        prompts.append(body + rng.integers(1, 50257, 4).tolist())
    return prompts


def serve(engine, prompts, n_new, stagger=True, samplings=None,
          after_first_tick=None):
    """Submit 4 up front and one more every second tick (each with its
    entry of ``samplings``); run ``after_first_tick`` once the first tick
    is done; drain."""
    reqs, pending, step = [], list(prompts), 0
    samplings = list(samplings or [None] * len(prompts))
    t0 = time.perf_counter()
    while pending or not engine.scheduler.idle:
        if not stagger:
            take = len(pending)
        else:
            take = 4 if step == 0 else int(step % 2 == 0)
        for _ in range(min(take, len(pending))):
            reqs.append(engine.submit(pending.pop(0), n_new,
                                      sampling=samplings.pop(0)))
        engine.step()
        if step == 0 and after_first_tick is not None:
            after_first_tick()
        step += 1
        check(step < 10_000, "the wave drains")
    return reqs, time.perf_counter() - t0


def zero_counts(pa, fo, lo):
    pa.DECODE_LAUNCHES = pa.PREFILL_LAUNCHES = 0
    pa.DECODE_SPLIT_LAUNCHES = pa.DECODE_SIMT_LAUNCHES = 0
    pa.PREFILL_TC_LAUNCHES = pa.PREFILL_SIMT_LAUNCHES = 0
    fo.RESIDUAL_NORM_LAUNCHES = 0
    lo.LAUNCHES = lo.CLUSTER_LAUNCHES = lo.SIMT_LAUNCHES = 0


def check_prefill_routes(pa, route, what):
    """Every K2 launch since the counts were set to 0 took ``route``."""
    on = pa.PREFILL_TC_LAUNCHES if route == "tc" else pa.PREFILL_SIMT_LAUNCHES
    check(pa.PREFILL_LAUNCHES > 0 and on == pa.PREFILL_LAUNCHES,
          f"{what}: all {pa.PREFILL_LAUNCHES} K2 launches on the {route} "
          f"route (tc {pa.PREFILL_TC_LAUNCHES}, simt "
          f"{pa.PREFILL_SIMT_LAUNCHES})")


def read_counts(pa, fo, lo):
    return {"paged_attention_decode": pa.DECODE_LAUNCHES,
            "paged_attention_decode/split": pa.DECODE_SPLIT_LAUNCHES,
            "paged_attention_decode/simt": pa.DECODE_SIMT_LAUNCHES,
            "paged_prefill_attention": pa.PREFILL_LAUNCHES,
            "fused_residual_norm": fo.RESIDUAL_NORM_LAUNCHES,
            "lora_delta": lo.LAUNCHES,
            "lora_delta/cluster": lo.CLUSTER_LAUNCHES,
            "lora_delta/simt": lo.SIMT_LAUNCHES}


def calls_of(eng, base=(0, 0)):
    """(prefill calls, decode calls) since ``base``."""
    return eng.prefill_calls - base[0], eng.decode_calls - base[1]


def check_path_counts(counts, calls, L, spec, lora, decode_route="split",
                      lora_route="cluster", epilogue=True):
    """The kernels the path must have launched, once per layer per call
    of the kind that runs them; every K1 launch on ``decode_route``,
    every L1 launch on ``lora_route``; K3 none without ``epilogue``
    (``fuse_epilogue=False``)."""
    prefill, decode = calls
    k1 = 0 if spec else L * decode
    k2 = L * (prefill + (decode if spec else 0))
    l1 = 4 * L * (prefill + decode) if lora else 0
    want = {"paged_attention_decode": k1,
            "paged_attention_decode/split": k1 if decode_route == "split" else 0,
            "paged_attention_decode/simt": k1 if decode_route == "simt" else 0,
            "paged_prefill_attention": k2,
            "fused_residual_norm": L * (prefill + decode) if epilogue else 0,
            "lora_delta": l1,
            "lora_delta/cluster": l1 if lora_route == "cluster" else 0,
            "lora_delta/simt": l1 if lora_route == "simt" else 0}
    check(counts == want, f"launches {counts} == {want} for {prefill} "
          f"prefill + {decode} decode calls")


def engine_phase(torch, np, pa, fo, lo, params, cache_dtype, prompts,
                 fuse_epilogue=True):
    """One wave of ``prompts``; returns the launch counts, the engine, its
    requests and tokens/s."""
    from apex_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = gpt124m(torch, torch.bfloat16)
    eng = ServingEngine(cfg, ServingConfig(
        max_batch=B, block_size=BLOCK, max_seq=MAX_SEQ, prefill_len=CHUNK,
        cache_dtype=cache_dtype, fuse_epilogue=fuse_epilogue), params)
    serve(eng, [prompts[1][:64]], 4, stagger=False)      # warm-up, not counted
    base = (eng.prefill_calls, eng.decode_calls, eng.tokens_generated,
            len(eng.tpot_ms))
    zero_counts(pa, fo, lo)
    reqs, wall = serve(eng, prompts, 32)
    counts = read_counts(pa, fo, lo)
    prefill_calls = eng.prefill_calls - base[0]
    decode_calls = eng.decode_calls - base[1]
    tokens = eng.tokens_generated - base[2]
    tpot = np.asarray(eng.tpot_ms[base[3]:])
    for req in reqs:
        check(req.state.value == "finished" and len(req.output_tokens) == 32,
              f"request {req.rid} finished with its 32 tokens")
        check(all(0 <= t < cfg.padded_vocab_size for t in req.output_tokens),
              f"request {req.rid}'s tokens lie in the vocabulary")
    check(prefill_calls > 0 and decode_calls > 0, "both calls ran")
    check_path_counts(counts, (prefill_calls, decode_calls), cfg.num_layers,
                      spec=False, lora=False, epilogue=fuse_epilogue)
    name = str(cache_dtype).replace("torch.", "") + " cache"
    if not fuse_epilogue:
        name += ", fuse_epilogue=False"
    check_prefill_routes(pa, "tc", f"engine[{name}]")
    log(f"engine[{name}]: {len(reqs)} requests, {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; TPOT p50 "
        f"{np.percentile(tpot, 50):.3f} ms p99 {np.percentile(tpot, 99):.3f} ms; "
        f"{prefill_calls} prefill + {decode_calls} decode calls; "
        f"preemptions {eng.scheduler.preemptions}; launches {counts}")
    return counts, eng, reqs, tokens / wall


EPILOGUE = "serving.epilogue"


def epilogue_device_us(torch, prof, rows):
    """``(k3_us, ops_us, calls)`` of the layers' epilogue in a profile:
    K3's device time from its kernel rows (it is launched through ctypes,
    not by a torch op), the device time of the torch ops' kernels inside
    the ``EPILOGUE`` ranges (the separate ops), and the number of
    ranges."""
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in prof.events()
              if e.name == EPILOGUE and e.device_type == cpu]
    k3 = sum(us for us, _, key in rows if "residual_norm_kernel" in key)
    ops = sum(getattr(e, "device_time_total", 0) for e in ranges)
    return k3, ops, len(ranges)


def profile_engine(torch, np, params, prompts):
    """Where the time of the bf16-cache wave goes: device busy share and
    the kernels with the most device time (torch.profiler); then the same
    wave with ``fuse_epilogue=False``, with the device time of the
    layers' epilogue both ways (K3, or the separate ops it replaces),
    printed only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from apex_tpu_torch.serving import ServingConfig, ServingEngine
    from apex_tpu_torch.serving import model as serving_model

    def annotated(fn):
        def call(*args, **kw):
            with record_function(EPILOGUE):
                return fn(*args, **kw)
        return call

    patched = {name: getattr(serving_model, name) for name in
               ("fused_residual_norm", "residual_norm_unfused")}
    try:
        for name, fn in patched.items():
            setattr(serving_model, name, annotated(fn))
        for fuse in (True, False):
            eng = ServingEngine(gpt124m(torch, torch.bfloat16), ServingConfig(
                max_batch=B, block_size=BLOCK, max_seq=MAX_SEQ,
                prefill_len=CHUNK, cache_dtype=torch.bfloat16,
                fuse_epilogue=fuse), params)
            serve(eng, [prompts[1][:64]], 4, stagger=False)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = serve(eng, prompts, 32)
            rows, busy_us = device_rows(torch, prof)
            k3_us, ops_us, calls = epilogue_device_us(torch, prof, rows)
            label = "bf16 cache wave" + ("" if fuse else ", fuse_epilogue=False")
            log(f"profile[{label}]: wall {wall * 1e3:.1f} ms, device busy "
                f"{busy_us / 1e3:.1f} ms = {busy_us / (wall * 1e6):.3f} of the "
                f"wall (the profiler's own cost included); the epilogue's "
                f"{calls} calls: K3 {k3_us / 1e3:.3f} ms, torch ops "
                f"{ops_us / 1e3:.3f} ms of device time")
            for us, count, key in sorted(rows, reverse=True)[:10 if fuse else 5]:
                log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    finally:
        for name, fn in patched.items():
            setattr(serving_model, name, fn)


def top2_gap(torch, model, tokens, adapters=None, adapter_slot=0):
    """The model's gap between its two best logits after ``tokens`` (on
    the model's device; with ``adapters``, under arena slot
    ``adapter_slot``)."""
    from apex_tpu_torch.serving import init_kv_arena

    n = len(tokens)
    bs = model.cache.block_size
    nb = -(-n // bs)
    dev = model.device
    arenas = init_kv_arena(model.cache, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.long, device=dev)
    tables = torch.zeros((1, model.cache.max_blocks_per_request), **i32)
    tables[0, :nb] = torch.arange(nb, **i32)
    pos = torch.arange(n, **i64)[None]
    kw = {}
    if adapters is not None:
        kw = dict(adapters=adapters,
                  adapter_slots=torch.tensor([adapter_slot], **i32))
    _, logits = model.prefill(
        arenas, torch.tensor([tokens], **i64), pos, tables,
        torch.tensor([n], **i32), (pos + 1).int(), pos // bs, pos % bs,
        torch.tensor([n - 1], **i64), torch.zeros(1, device=dev),
        torch.zeros(1, **i64), torch.ones(1, device=dev),
        torch.zeros(1, **i64), torch.zeros(1, **i64), **kw)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])



def compare_streams(torch, label, got, want, model, bound, adapters=None,
                    slots=None):
    """Streams ``got`` against ``want``: identical, or parting first where
    ``model`` (the engine that produced ``want``) sees its two best
    logits within ``bound``."""
    same = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.output_tokens == w.output_tokens:
            same += 1
            continue
        at = next(j for j, (a, b) in enumerate(zip(g.output_tokens,
                                                   w.output_tokens)) if a != b)
        gap = top2_gap(torch, model, list(map(int, w.prompt))
                       + w.output_tokens[:at], adapters,
                       0 if slots is None else slots[i])
        log(f"{label}: request {i} parts at token {at} ({g.output_tokens[at]}"
            f" vs {w.output_tokens[at]}); top-2 logit gap {gap:.3g}")
        check(gap <= bound, f"{label}: streams part only at near ties "
              f"(gap {gap:.3g} <= {bound})")
    log(f"{label}: agreement {same} of {len(want)} streams identical, the "
        f"rest part at near ties")


def modern(torch):
    """A small rope + grouped-query + SwiGLU model (2 KV groups of 4
    heads of 32), for the architecture options GPT-124M leaves off."""
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )
    return TransformerConfig(
        hidden_size=256, num_layers=2, num_attention_heads=8,
        num_query_groups=2, padded_vocab_size=4096,
        position_embedding_type="rope", swiglu=True, dtype=torch.float32)


def card_vs_cpu(torch, cfg, params, prompts, label):
    """The same requests in fp32 on the card and on the CPU; K2 on the
    card takes its simt route (exact fp32)."""
    from apex_tpu_torch.serving import ServingConfig, ServingEngine
    from apex_tpu_torch.serving import fused_ops as fo
    from apex_tpu_torch.serving import lora as lo
    from apex_tpu_torch.serving import paged_attention as pa

    shape = ServingConfig(max_batch=3, block_size=BLOCK, max_seq=MAX_SEQ,
                          prefill_len=CHUNK, cache_dtype=torch.float32)
    three = sorted(prompts, key=len)[:3]
    gpu = ServingEngine(cfg, shape, params)
    cpu_params = type(params)(*(_to_cpu(part) for part in params))
    cpu = ServingEngine(cfg, shape, cpu_params, device="cpu")
    zero_counts(pa, fo, lo)
    g_reqs, _ = serve(gpu, three, 32, stagger=False)
    check_path_counts(read_counts(pa, fo, lo), calls_of(gpu), cfg.num_layers,
                      spec=False, lora=False, decode_route="simt")
    check_prefill_routes(pa, "simt", f"card vs CPU [{label}]")
    c_reqs, _ = serve(cpu, three, 32, stagger=False)
    compare_streams(torch, f"card vs CPU [{label}, fp32, TF32 off]", g_reqs,
                    c_reqs, cpu.model, 1e-3)
    log(f"card vs CPU [{label}]: {len(three)} streams of 32 tokens, prompts "
        f"{[len(p) for p in three]}")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


# ------------------------------------ phase 7: speculation and LoRA


class CountingProposer:
    """The engine's proposer, counting the ticks that drafted (each
    reports one verify outcome)."""

    def __init__(self, inner):
        self.inner = inner
        self.ticks = 0

    def propose(self, req, max_k):
        return self.inner.propose(req, max_k)

    def observe(self, req, proposed, accepted):
        self.ticks += 1
        self.inner.observe(req, proposed, accepted)


def serving_shape(torch, **kw):
    """The serving shape of the engine phases, a bf16 KV cache unless
    ``kw`` names another."""
    from apex_tpu_torch.serving import ServingConfig

    kw.setdefault("cache_dtype", torch.bfloat16)
    return ServingConfig(max_batch=B, block_size=BLOCK, max_seq=MAX_SEQ,
                         prefill_len=CHUNK, **kw)


def spec_phase(torch, np, pa, fo, lo, params, prompts):
    """The motif wave with k = 4 drafting and without (bf16)."""
    from apex_tpu_torch.serving import ServingEngine, SpeculativeConfig

    cfg = gpt124m(torch, torch.bfloat16)
    runs, launches = {}, {}
    for label, spec in (("plain", None), ("k=4", SpeculativeConfig(k=SPEC_K))):
        eng = ServingEngine(cfg, serving_shape(torch, speculative=spec), params)
        serve(eng, [prompts[1][:64]], 4, stagger=False)      # warm-up
        base = calls_of(eng)
        tokens0, prop0, acc0 = (eng.tokens_generated, eng.spec_proposed,
                                eng.spec_accepted)
        if spec is not None:
            eng.proposer = CountingProposer(eng.proposer)
        zero_counts(pa, fo, lo)
        reqs, wall = serve(eng, prompts, SPEC_NEW)
        counts = read_counts(pa, fo, lo)
        calls = calls_of(eng, base)
        check_path_counts(counts, calls, cfg.num_layers, spec is not None,
                          False)
        check_prefill_routes(pa, "tc", f"spec[{label}]")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for req in reqs:
            check(req.state.value == "finished"
                  and len(req.output_tokens) == SPEC_NEW,
                  f"request {req.rid} finished with its {SPEC_NEW} tokens")
        tokens = eng.tokens_generated - tokens0
        line = (f"spec[{label}]: {len(reqs)} requests, {tokens} tokens in "
                f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; "
                f"{calls[0]} prefill + {calls[1]} decode calls")
        if spec is not None:
            proposed = eng.spec_proposed - prop0
            accepted = eng.spec_accepted - acc0
            ticks = eng.proposer.ticks
            check(proposed > 0 and accepted > 0,
                  f"drafts proposed ({proposed}) and accepted ({accepted})")
            line += (f"; {proposed} drafted, {accepted} accepted = "
                     f"acceptance {accepted / proposed:.3f}; mean accepted "
                     f"length {accepted / ticks:.3f} over {ticks} drafting "
                     f"slot-ticks")
        log(line)
        runs[label] = (eng, reqs)
    plain_eng, plain = runs["plain"]
    compare_streams(torch, "spec vs plain (bf16)", runs["k=4"][1], plain,
                    plain_eng.model, BF16_TIE)
    return launches


def lora_phase(torch, np, pa, fo, lo, params, prompts, spec_int8=False):
    """The LoRA wave (bf16 cache, or k = 4 drafting over an int8 cache):
    requests cycle over t0-t3 and no adapter, t2 is hot-swapped after the
    first tick, t4 evicts the coldest adapter after the drain; the
    no-adapter streams must equal a bare engine's bit for bit."""
    from apex_tpu_torch.serving import (
        LoRAConfig,
        SamplingParams,
        ServingEngine,
        SpeculativeConfig,
    )

    cfg = gpt124m(torch, torch.bfloat16)
    extra = (dict(speculative=SpeculativeConfig(k=SPEC_K),
                  cache_dtype=torch.int8) if spec_int8 else {})
    label = "lora+spec+int8" if spec_int8 else "lora"
    lora_cfg = LoRAConfig(rank=RANK, max_adapters=ADAPTERS, alpha=16)
    tuned = ServingEngine(cfg, serving_shape(torch, lora=lora_cfg, **extra), params)
    bare = ServingEngine(cfg, serving_shape(torch, **extra), params)
    ids = [f"t{i}" for i in range(ADAPTERS)]
    for aid in ids:
        tuned.register_adapter(aid)
    for eng in (tuned, bare):
        serve(eng, [prompts[1][:64]], 4, stagger=False)      # warm-up
    cycle = ids + [None]
    samplings = [SamplingParams(adapter_id=cycle[i % len(cycle)])
                 for i in range(len(prompts))]
    base = calls_of(tuned)
    zero_counts(pa, fo, lo)
    reqs, wall = serve(
        tuned, prompts, SPEC_NEW, samplings=samplings,
        after_first_tick=lambda: tuned.register_adapter("t2", seed=1234))
    counts = read_counts(pa, fo, lo)
    calls = calls_of(tuned, base)
    check_path_counts(counts, calls, cfg.num_layers, spec_int8, True)
    check_prefill_routes(pa, "tc", label)
    arena = tuned.adapter_arena
    check(arena.active == 0, "no adapter left pinned after the wave")
    arena.check()
    if not spec_int8:
        unfused_lora_wave(torch, pa, fo, lo, cfg, params, prompts, samplings,
                          reqs, tuned)
    slot = tuned.register_adapter("t4")
    check(arena.evictions == 1 and arena.resident("t4")
          and len(arena) == ADAPTERS, f"t4 (slot {slot}) evicted one adapter")
    base_late = calls_of(tuned)
    zero_counts(pa, fo, lo)
    late, _ = serve(tuned, prompts[:1], SPEC_NEW, stagger=False,
                    samplings=[SamplingParams(adapter_id="t4")])
    late_counts = read_counts(pa, fo, lo)
    check_path_counts(late_counts, calls_of(tuned, base_late),
                      cfg.num_layers, spec_int8, True)
    check_prefill_routes(pa, "tc", f"{label} (t4)")
    check(late[0].state.value == "finished" and arena.active == 0,
          "the request on the new adapter finished and unpinned")
    arena.check()
    for k, v in late_counts.items():
        counts[k] += v
    bare_base = calls_of(bare)
    bare_reqs, bare_wall = serve(bare, prompts, SPEC_NEW)
    bare_calls = calls_of(bare, bare_base)
    nones = [i for i, sp in enumerate(samplings) if sp.adapter_id is None]
    for i in nones:
        check(reqs[i].output_tokens == bare_reqs[i].output_tokens,
              f"{label}: request {i} without an adapter is bit for bit the "
              f"bare engine's")
    moved = sum(reqs[i].output_tokens != bare_reqs[i].output_tokens
                for i in range(len(reqs)) if i not in nones)
    check(moved > 0, f"{label}: the adapters change the streams")
    tokens = sum(len(r.output_tokens) for r in reqs)
    log(f"{label}: {len(reqs)} requests ({len(nones)} without an adapter, "
        f"identical to the bare engine's), {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tokens/s (bare engine {tokens / bare_wall:.1f});"
        f" {calls[0]} prefill + {calls[1]} decode calls (bare engine "
        f"{bare_calls[0]} + {bare_calls[1]}); adapter streams "
        f"moved by their adapter {moved}/{len(reqs) - len(nones)}; hot swap "
        f"of t2, eviction for t4 ({arena.evictions}); launches {counts}")
    return counts


def unfused_lora_wave(torch, pa, fo, lo, cfg, params, prompts, samplings,
                      fused, tuned):
    """The LoRA wave again through ``LoRAConfig(fused=False)`` (the
    reference's A/B switch): the same adapters, hot swap and requests;
    no L1 launch, every other kernel as in the fused wave, the requests
    without an adapter bit for bit the fused wave's (``fused``,
    ``tuned``: the fused wave's requests and engine).  Where an adapter
    stream parts from the fused wave's, the fused engine's top-2 logit
    gap there is printed, not held: L1 and the plain lowering add their
    fp32 products in other orders, so some elements round to bf16 one
    step apart (``check_lora`` counts them), and a step at the fixture's
    deltas of tens moves the logits by more than ``BF16_TIE``.  The A/B
    is held in fp32 (``card_vs_cpu_lora``)."""
    from apex_tpu_torch.serving import LoRAConfig, ServingEngine

    unfused = ServingEngine(cfg, serving_shape(torch, lora=LoRAConfig(
        rank=RANK, max_adapters=ADAPTERS, alpha=16, fused=False)), params)
    for i in range(ADAPTERS):
        unfused.register_adapter(f"t{i}")
    serve(unfused, [prompts[1][:64]], 4, stagger=False)      # warm-up
    base = calls_of(unfused)
    zero_counts(pa, fo, lo)
    reqs, wall = serve(
        unfused, prompts, SPEC_NEW, samplings=samplings,
        after_first_tick=lambda: unfused.register_adapter("t2", seed=1234))
    counts = read_counts(pa, fo, lo)
    check_path_counts(counts, calls_of(unfused, base), cfg.num_layers,
                      False, False)
    check(lo.LAUNCHES == 0, "LoRAConfig(fused=False) launches no L1")
    parts = []
    for i, (g, w) in enumerate(zip(reqs, fused)):
        aid = samplings[i].adapter_id
        if aid is None:
            check(g.output_tokens == w.output_tokens,
                  f"lora fused=False: request {i} without an adapter is bit "
                  f"for bit the L1 wave's")
        elif g.output_tokens != w.output_tokens:
            at = next(j for j, (a, b) in enumerate(
                zip(g.output_tokens, w.output_tokens)) if a != b)
            gap = top2_gap(torch, tuned.model, list(map(int, w.prompt))
                           + w.output_tokens[:at], tuned.adapters,
                           tuned.adapter_arena.slot_of(aid))
            parts.append(f"{aid}@{at}:{gap:.3g}")
    tokens = sum(len(r.output_tokens) for r in reqs)
    n_tagged = sum(s.adapter_id is not None for s in samplings)
    log(f"lora fused=False: {len(reqs)} requests, {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; launches {counts}; "
        f"no-adapter streams bit for bit the L1 wave's; "
        f"{n_tagged - len(parts)} of {n_tagged} adapter streams identical, "
        f"the rest parting at (adapter@token:top-2 gap of the L1 engine, "
        f"t2 read after its hot swap) {parts}")


def card_vs_cpu_lora(torch, params, prompts):
    """Four requests with k = 4 drafting and two adapters, 16 tokens
    each, in fp32 on the card through L1, on the card through
    ``LoRAConfig(fused=False)`` (C.8's A/B: no L1 launch) and on the CPU;
    the card's L1 streams against the CPU's and the unfused streams
    against L1's, equal up to near ties of 1e-3.  The first step's logits
    of the three are printed beside each other."""
    from apex_tpu_torch.serving import (
        LoRAConfig,
        SamplingParams,
        ServingEngine,
        SpeculativeConfig,
    )

    from apex_tpu_torch.serving import fused_ops as fo
    from apex_tpu_torch.serving import lora as lo
    from apex_tpu_torch.serving import paged_attention as pa

    cfg = gpt124m(torch, torch.float32)
    four = sorted(prompts, key=len)[:4]
    ids = ["t0", "t1", None, "t0"]
    engines, logits = {}, {}
    for label, device, fused in (("card L1", "cuda", True),
                                 ("card unfused", "cuda", False),
                                 ("CPU", "cpu", True)):
        p = params if device == "cuda" else type(params)(
            *(_to_cpu(part) for part in params))
        shape = serving_shape(
            torch, cache_dtype=torch.float32,
            speculative=SpeculativeConfig(k=SPEC_K),
            lora=LoRAConfig(rank=RANK, max_adapters=ADAPTERS, alpha=16,
                            fused=fused))
        eng = ServingEngine(cfg, shape, p, device=device)
        for aid in ("t0", "t1"):
            eng.register_adapter(aid)
        zero_counts(pa, fo, lo)
        reqs, _ = serve(eng, four, 16, stagger=False,
                        samplings=[SamplingParams(adapter_id=a) for a in ids])
        if device == "cuda":
            check_prefill_routes(pa, "simt", f"card vs CPU [spec + LoRA, "
                                 f"{label}]")
            check_path_counts(read_counts(pa, fo, lo), calls_of(eng),
                              cfg.num_layers, spec=True, lora=fused)
        slots = [eng.adapter_arena.slot_of(a) if a else 0 for a in ids]
        logits[label] = [t.cpu() for t in first_step_logits(
            torch, eng.model, [p[:CHUNK] for p in four],
            adapters=eng.adapters, adapter_slots=torch.tensor(
                slots, dtype=torch.int32, device=eng.device))]
        engines[label] = (eng, reqs, slots)
    l1, l1_reqs, l1_slots = engines["card L1"]
    cpu, c_reqs, c_slots = engines["CPU"]
    compare_streams(torch, "card vs CPU [spec + LoRA, fp32, TF32 off]",
                    l1_reqs, c_reqs, cpu.model, 1e-3,
                    adapters=cpu.adapters, slots=c_slots)
    compare_streams(torch, "LoRA fused=False vs L1 on the card [spec, fp32, "
                    "TF32 off]", engines["card unfused"][1], l1_reqs,
                    l1.model, 1e-3, adapters=l1.adapters, slots=l1_slots)
    for a, b in (("card L1", "CPU"), ("card unfused", "CPU"),
                 ("card unfused", "card L1")):
        pre, dec = ((x - y).abs().amax(-1).tolist()
                    for x, y in zip(logits[a], logits[b]))
        log(f"first-step logits [spec + LoRA, fp32, adapters {ids}], {a} "
            f"vs {b}: per-request max |diff| prefill "
            f"{[f'{v:.3g}' for v in pre]}, decode {[f'{v:.3g}' for v in dec]}"
            f" (largest logit {float(logits[b][0].abs().max()):.3f})")
    log(f"card vs CPU [spec + LoRA]: 4 streams of 16 tokens, "
        f"prompts {[len(p) for p in four]}, adapters {ids}; card drafted "
        f"{l1.spec_proposed}, accepted {l1.spec_accepted}")


def profile_spec_lora(torch, params, prompts):
    """Where the time of a drafting LoRA wave goes (torch.profiler, device
    activity only: eight requests of 32 tokens, since sorting the host
    events of the whole wave takes the profiler about a minute)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import (
        LoRAConfig,
        SamplingParams,
        ServingEngine,
        SpeculativeConfig,
    )

    eng = ServingEngine(gpt124m(torch, torch.bfloat16), serving_shape(
        torch, speculative=SpeculativeConfig(k=SPEC_K),
        lora=LoRAConfig(rank=RANK, max_adapters=ADAPTERS, alpha=16)), params)
    ids = [f"t{i}" for i in range(ADAPTERS)]
    for aid in ids:
        eng.register_adapter(aid)
    serve(eng, [prompts[1][:64]], 4, stagger=False)
    cycle = ids + [None]
    eight = prompts[:8]
    samplings = [SamplingParams(adapter_id=cycle[i % len(cycle)])
                 for i in range(len(eight))]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = serve(eng, eight, 32, samplings=samplings)
        torch.cuda.synchronize()
    rows, busy_us = device_rows(torch, prof)
    check(busy_us > 0, "the profiler saw device time")
    log(f"profile[spec k=4 + LoRA wave, 8 x 32 tokens, bf16]: wall "
        f"{wall * 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.1f} ms = {busy_us / (wall * 1e6):.3f} of the "
        f"wall (the profiler's own cost included)")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    # L1 by kernel instance: the route, and on the cluster route the rows
    # per tile (8: the k + 1 verify; 16: prefill chunks)
    l1 = [(us, count, key[key.index("lora_"):].split("(")[0])
          for us, count, key in rows if "lora_" in key]
    check(l1, "the profile holds L1's launches")
    log(f"  L1 device total {sum(r[0] for r in l1) / 1e3:.3f} ms over "
        f"{sum(r[1] for r in l1)} launches:")
    for us, count, name in sorted(l1, reverse=True):
        log(f"    {us / 1e3:9.3f} ms {count:6d}x {name} "
            f"({us / count:.2f} us each)")


# ----------------------------------------------- phase 5/6: training


def gpt124m_train(torch, dtype):
    """``bench.py``'s flash training configuration (dropout off)."""
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )
    return TransformerConfig(
        hidden_size=768, num_layers=12, num_attention_heads=12,
        padded_vocab_size=50304, max_position_embeddings=SEQ,
        hidden_dropout=0.0, attention_dropout=0.0, use_flash_attention=True,
        dtype=dtype)


def flash_counts(fa):
    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
            "flash_dkv": fa.DKV_LAUNCHES}


def zero_flash_counts(fa):
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fa.FWD_TC_LAUNCHES = fa.FWD_SIMT_LAUNCHES = 0
    fa.DQ_TC_LAUNCHES = fa.DQ_SIMT_LAUNCHES = 0
    fa.DKV_TC_LAUNCHES = fa.DKV_SIMT_LAUNCHES = 0


def flash_route_counts(fa):
    """Launches per route of F1, F2 and F3: ``{route: (F1, F2, F3)}``."""
    return {"tc": (fa.FWD_TC_LAUNCHES, fa.DQ_TC_LAUNCHES, fa.DKV_TC_LAUNCHES),
            "simt": (fa.FWD_SIMT_LAUNCHES, fa.DQ_SIMT_LAUNCHES,
                     fa.DKV_SIMT_LAUNCHES)}


def trainer(torch, cfg, seed, device="cuda", params=None):
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel

    model = GPTModel(cfg, device=device)
    model.load_params(params if params is not None
                      else init_gpt_params(cfg, seed, device=device))
    return model, FusedAdam(model.parameters(), lr=1e-4)


def train_tokens(torch):
    """The fixed batch of the GPT-124M training phases."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    return torch.randint(0, 50257, (TRAIN_BATCH, SEQ), generator=gen,
                         device="cuda")


def train_phase(torch, fa):
    """GPT-124M training steps on one fixed batch; returns the flash
    launch counts of the run, the (model, opt, tokens) for the profile,
    the losses and the step time (s)."""
    from apex_tpu_torch.testing.l1 import train_step

    cfg = gpt124m_train(torch, torch.bfloat16)
    model, opt = trainer(torch, cfg, seed=0)
    tokens = train_tokens(torch)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    losses = [train_step(model, opt, tokens) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [train_step(model, opt, tokens) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts(fa)
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(x) for x in losses]
    check(all(c == cfg.num_layers * steps for c in counts.values()),
          f"F1/F2/F3 launched {cfg.num_layers} times per step: {counts}")
    routes = flash_route_counts(fa)
    check(routes == {"tc": (cfg.num_layers * steps,) * 3,
                     "simt": (0, 0, 0)},
          f"every F1, F2 and F3 launch of the bf16 step on the tc route "
          f"(launches per route, F1/F2/F3: {routes})")
    check(all(x == x and abs(x) < 1e4 for x in losses),
          f"the losses are finite: {losses}")
    check(losses[-1] < losses[0], f"the loss falls: {losses}")
    tokens_per_step = TRAIN_BATCH * SEQ
    log(f"train[GPT-124M, {n_params} parameters, batch {TRAIN_BATCH} x "
        f"{SEQ}, bf16 compute]: step {wall / TIMED_STEPS * 1e3:.3f} ms = "
        f"{tokens_per_step * TIMED_STEPS / wall:.1f} tokens/s over "
        f"{TIMED_STEPS} timed steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({losses}); launches {counts}")
    return counts, (model, opt, tokens), losses, wall / TIMED_STEPS


def profile_train(torch, model, opt, tokens, label="GPT-124M train step"):
    """Where one training step's time goes: device busy share and the
    kernels with the most device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.testing.l1 import train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy_us = device_rows(torch, prof)
    check(busy_us > 0, "the profiler saw device time")
    log(f"profile[{label}]: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.1f} ms = {busy_us / (wall * 1e6):.3f} of the "
        f"wall (the profiler's own cost included)")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    return prof


def train_card_vs_cpu(torch, cfg, label, batch, seq):
    """Three fp32 training steps on the card and on the CPU from the same
    weights and batch: loss within 1e-4, grad norm within 1e-3."""
    from apex_tpu_torch.testing.l1 import compare_traces, global_grad_norm
    from apex_tpu_torch.testing.l1 import train_step
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )

    params = init_gpt_params(cfg, seed=5)
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.padded_vocab_size, (batch, seq),
                           generator=gen)
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    traces = {}
    for device in ("cuda", "cpu"):
        model, opt = trainer(torch, cfg, 5, device=device, params=params)
        t = tokens.to(device)
        trace = {"loss": [], "grad_norm": []}
        zero_flash_counts(fa)
        for _ in range(3):
            trace["loss"].append(float(train_step(model, opt, t)))
            trace["grad_norm"].append(
                float(global_grad_norm(model.parameters())))
        if device == "cuda":
            routes = flash_route_counts(fa)
            n = 3 * cfg.num_layers if cfg.use_flash_attention else 0
            check(routes == {"tc": (0, 0, 0), "simt": (n,) * 3},
                  f"train card vs CPU [{label}]: every F1, F2 and F3 launch "
                  f"on the simt route, {n} each (F1/F2/F3: {routes})")
        traces[device] = trace
    problems = compare_traces(traces["cuda"], traces["cpu"])
    log(f"train card vs CPU [{label}] (fp32, TF32 off, batch {batch} x "
        f"{seq}): card {traces['cuda']}, CPU {traces['cpu']}")
    check(not problems, f"card and CPU training agree: {problems}")


# ------------------------- phase 9: single-device training, completed

O2_STEPS = 8                 # timed O2 steps, after WARMUP_STEPS
DEFAULT_CORE_STEPS = 4       # timed default-core steps, after WARMUP_STEPS


def default_core_phase(torch, fa, flash_first_loss, flash_step):
    """GPT-124M through the default (fused-softmax) core from the flash
    phase's weights and batch: no flash launch, finite and falling losses,
    the first loss the flash step's (the same function: causal attention,
    no dropout); then one profiled step."""
    from apex_tpu_torch.testing.l1 import train_step

    cfg = dataclasses.replace(gpt124m_train(torch, torch.bfloat16),
                              use_flash_attention=False)
    model, opt = trainer(torch, cfg, seed=0)
    tokens = train_tokens(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    losses = [train_step(model, opt, tokens) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [train_step(model, opt, tokens)
               for _ in range(DEFAULT_CORE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts(fa)
    check(counts == {k: 0 for k in counts},
          f"the default core launches no flash kernel: {counts}")
    losses = [float(x) for x in losses]
    check(all(x == x and abs(x) < 1e4 for x in losses),
          f"default core: the losses are finite: {losses}")
    check(losses[-1] < losses[0], f"default core: the loss falls: {losses}")
    rel = abs(losses[0] - flash_first_loss) / abs(flash_first_loss)
    check(rel <= 2e-2,
          f"default core: the first loss {losses[0]:.6f} within 2e-2 of the "
          f"flash step's {flash_first_loss:.6f} (relative {rel:.2e})")
    step = wall / DEFAULT_CORE_STEPS
    log(f"train[GPT-124M, default core, batch {TRAIN_BATCH} x {SEQ}, bf16 "
        f"compute]: step {step * 1e3:.3f} ms = "
        f"{TRAIN_BATCH * SEQ / step:.1f} tokens/s over {DEFAULT_CORE_STEPS} "
        f"timed steps (flash step {flash_step * 1e3:.3f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first loss "
        f"{losses[0]:.6f} (flash {flash_first_loss:.6f}, relative "
        f"{rel:.2e}); losses {losses}")
    profile_train(torch, model, opt, tokens, "GPT-124M default-core step")
    # the softmax's share of the step: its forward and backward alone at
    # one layer's score shape, as the causal core calls it
    from apex_tpu_torch.ops.softmax import AttnMaskType, FusedScaleMaskSoftmax

    softmax = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal,
                                    scale=2.0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((TRAIN_BATCH, N_HEADS, SEQ, SEQ), generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    dy = torch.randn_like(x)
    ms = Timer(torch)(lambda: torch.autograd.grad(softmax(x, None), x, dy))
    log(f"softmax[FusedScaleMaskSoftmax, causal, bf16, {tuple(x.shape)}]: "
        f"forward + backward {ms:.3f} ms; x {cfg.num_layers} layers = "
        f"{ms * cfg.num_layers:.1f} ms of the default-core step's "
        f"{step * 1e3:.1f} ms")


def optimizer_snapshot(torch, model, opt):
    """Copies of every parameter and of the optimizer's masters and
    moments, and of each parameter group's step count."""
    params = [p.detach().clone() for p in model.parameters()]
    state = [{k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in opt.state[p].items()} for p in model.parameters()]
    state += [{"step": torch.as_tensor(g["step"]).clone()}
              for g in opt.param_groups]
    return params, state


def o2_phase(torch, fa, flash_step):
    """GPT-124M under O2 over the flash core: parameters cast by
    ``policy("O2")``, FusedAdam with fp32 masters, dynamic loss scaling
    from 2**16 growing every 4 clean steps, driven by
    ``l1.amp_train_step``; then one overflow forced by an inf in one
    gradient.  Returns the flash launches of the O2 steps."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.testing.l1 import amp_train_step, apply_policy

    cfg = gpt124m_train(torch, torch.bfloat16)
    model, _ = trainer(torch, cfg, seed=0)
    apply_policy(model, amp.O2)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    check(all((dt == torch.float32) == ("layernorm" in n)
              for n, dt in dtypes.items()),
          "O2: every LayerNorm parameter fp32, every other bf16")
    opt = FusedAdam(model.parameters(), lr=1e-4, master_weights=True)
    scaler = amp.DynamicLossScale(init_scale=2.0 ** 16, growth_interval=4)
    state = scaler.init()
    tokens = train_tokens(torch)
    steps = WARMUP_STEPS + O2_STEPS
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    losses, states = [], []
    for i in range(steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, norm, state = amp_train_step(model, opt, tokens, scaler, state)
        losses.append(loss)
        states.append(state)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / O2_STEPS
    counts = flash_counts(fa)
    routes = flash_route_counts(fa)
    check(all(c == cfg.num_layers * steps for c in counts.values())
          and routes == {"tc": (cfg.num_layers * steps,) * 3,
                         "simt": (0, 0, 0)},
          f"O2: F1/F2/F3 launched {cfg.num_layers} times per step, all on "
          f"the tc route: {counts}, {routes}")
    losses = [float(x) for x in losses]
    scales = [float(s.scale) for s in states]
    check(all(x == x and abs(x) < 1e4 for x in losses) and
          losses[-1] < losses[0], f"O2: the losses are finite and fall: "
          f"{losses}")
    check(not any(bool(s.found_inf) for s in states),
          "O2: no step overflowed")
    want = [2.0 ** (16 + (i + 1) // 4) for i in range(steps)]
    check(scales == want, f"O2: the scale doubles at every 4th clean step: "
          f"{scales} (expected {want})")
    # one overflow: an inf in one gradient skips the step bit for bit
    first = next(model.parameters())
    before_params, before_state = optimizer_snapshot(torch, model, opt)

    def poison(g):
        g = g.clone()
        g.view(-1)[0] = float("inf")
        return g

    hook = first.register_hook(poison)
    try:
        _, norm, after = amp_train_step(model, opt, tokens, scaler, state)
    finally:
        hook.remove()
    after_params, after_state = optimizer_snapshot(torch, model, opt)
    same = all(torch.equal(a, b) for a, b in zip(after_params,
                                                 before_params))
    same_state = all(
        set(a) == set(b) and all(torch.equal(torch.as_tensor(a[k]),
                                             torch.as_tensor(b[k]))
                                 for k in a)
        for a, b in zip(after_state, before_state))
    check(bool(after.found_inf) and not bool(torch.isfinite(norm)),
          "O2: the forced overflow is found")
    check(same, "O2: the skipped step leaves every parameter bit for bit")
    check(same_state, "O2: the skipped step leaves every master, moment "
          "and step count bit for bit")
    n_steps = int(opt.param_groups[0]["step"])
    check(n_steps == steps, f"O2: the step count stays {steps}: {n_steps}")
    check(float(after.scale) == scales[-1] / 2,
          f"O2: the scale halves on the overflow: {scales[-1]} -> "
          f"{float(after.scale)}")
    log(f"train[GPT-124M, O2 + dynamic loss scale, flash core, batch "
        f"{TRAIN_BATCH} x {SEQ}]: step {step * 1e3:.3f} ms = "
        f"{TRAIN_BATCH * SEQ / step:.1f} tokens/s over {O2_STEPS} timed "
        f"steps (phase 5's plain bf16 step {flash_step * 1e3:.3f} ms); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; scales {scales}; forced "
        f"overflow: scale {scales[-1]} -> {float(after.scale)}, step count "
        f"{n_steps}; launches {counts}")
    return counts


def training_completed_phase(torch, fa, flash_first_loss, flash_step):
    """Phase 9: the default core on GPT-124M and against the CPU, then O2
    with dynamic loss scaling; returns the O2 steps' flash launches."""
    t0 = time.perf_counter()
    default_core_phase(torch, fa, flash_first_loss, flash_step)
    small = dataclasses.replace(gpt124m_train(torch, torch.float32),
                                num_layers=2, use_flash_attention=False)
    train_card_vs_cpu(torch, small, "default core, 2 layers", 2, 128)
    counts = o2_phase(torch, fa, flash_step)
    log(f"phase 9 (single-device training, completed): "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------------------------------- phase 10: fp8

FP8_TOKENS = TRAIN_BATCH * SEQ      # the training step's [1024, 8] rows
FP8_TOL = 1e-3        # the difference's RMS, of the plain output's RMS
FP8_OUTLIER = 1e-2    # any element beyond one output step, of that RMS
# (label, tokens, in, out, x dtype): ragged widths and token counts,
# padded to the GEMM's multiples of 16 inside the card route, and fp16
FP8_EDGES = (("hidden 100", 64, 100, 300, "bf16"),
             ("hidden 100, fc2", 64, 300, 100, "bf16"),
             ("9 tokens", 9, 768, 2304, "bf16"),
             ("fp16 x", 512, 768, 768, "fp16"))
# the fp32 card-vs-CPU gpt_fp8 trace: fp8 rounding turns one-ulp
# differences of fp32 sums into whole fp8 steps, and those grow over the
# steps; the JAX package against itself, with every initial weight moved
# by at most one ulp, parts by 2.0e-4 (loss), 8.4e-3 (gradient norm) and
# 3.0e-2 (final scales) over the ten steps (tests/test_torch_training.py);
# the limits are those of its stored-baseline test, above that spread
FP8_TRACE_TOL = dict(loss_rtol=5e-4, grad_rtol=5e-2)
FP8_SCALE_RTOL = 1e-1


def fp8_counts(fp8):
    return fp8.FWD_GEMMS, fp8.BWD_GEMMS


def zero_fp8_counts(fp8):
    fp8.FWD_GEMMS = fp8.BWD_GEMMS = 0


def fp8_operands(torch, fp8, n, d_in, d_out, x_dtype, seed):
    """Seeded bf16 (or fp16) ``x [n, in]`` over fp32 ``w [out, in]``, the
    cotangent, and metas whose scales are not 1: x's from an amax 0.9 of
    its own (its largest values clip), w's from 1.25 of its own."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((n, d_in), generator=gen, device="cuda") * 2.0).to(
        x_dtype)
    w = torch.randn((d_out, d_in), generator=gen, device="cuda") * 0.02
    g = (torch.randn((n, d_out), generator=gen, device="cuda") * 1e-3).to(
        x_dtype)
    init = fp8.Fp8Meta.init(device="cuda")
    xm = fp8.update_meta(init, x.float().abs().amax() * 0.9)
    wm = fp8.update_meta(init, w.abs().amax() * 1.25)
    return x, w, g, xm, wm


def fp8_route(torch, fp8, route, x, w, g, xm, wm):
    """(y, dx, dw) of ``fp8_matmul_t`` on ``route``."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fp8._fp8_matmul_t(x, w, xm, wm, route)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    return y.detach(), dx, dw


def fp8_close(torch, what, got, want):
    """The card's product against the plain one on the same operands: the
    RMS of the difference at most ``FP8_TOL`` of the plain output's RMS,
    and no element farther than ``FP8_OUTLIER`` of it beyond one step of
    the output dtype (each side rounds its fp32 sum to bf16 or fp16 once,
    and the fp8 tensor cores sum in reduced precision between cuBLAS's
    promotions to fp32, so single elements part by about 1e-3 of the RMS
    where the sums over all elements agree far closer).  Returns the
    readings (fractions of the RMS)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs())
    step = torch.ldexp(torch.full_like(w, torch.finfo(got.dtype).eps), e - 1)
    diff = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    rel = diff.square().mean().sqrt().item() / rms
    excess = (diff - step).clamp_min(0).max().item() / rms
    log(f"    {what}: RMS of the difference {rel:.3g} of the RMS; largest "
        f"beyond one {got.dtype} step {excess:.3g} (max |card - plain| "
        f"{diff.max().item() / rms:.3g}; RMS {rms:.3g})")
    check(rel <= FP8_TOL and excess <= FP8_OUTLIER,
          f"fp8 {what}: the difference's RMS within {FP8_TOL} and every "
          f"element within {FP8_OUTLIER} beyond one step, of the RMS")
    return {"rms": float(f"{rel:.3g}"), "max": float(f"{excess:.3g}")}


def check_fp8_gemm(torch, fp8, timer, label, n, d_in, d_out, x_dtype,
                   seed, timed):
    """The card route of ``fp8_matmul_t`` against its plain version (fp32
    on the card, TF32 off) on the same operands: forward, dx and dw; at
    the projection shapes also the times."""
    x, w, g, xm, wm = fp8_operands(torch, fp8, n, d_in, d_out, x_dtype, seed)
    card = fp8_route(torch, fp8, "card", x, w, g, xm, wm)
    plain = fp8_route(torch, fp8, "plain", x, w, g, xm, wm)
    log(f"  fp8 GEMM[{label}: {n} x {d_in} -> {d_out}, x {x.dtype}, w "
        f"{w.dtype}, scales x {xm.scale.item():.4g} w {wm.scale.item():.4g}]")
    errs = {name: fp8_close(torch, name, a, b)
            for name, a, b in zip(("y", "dx", "dw"), card, plain)}
    check(card[0].dtype == x.dtype and card[1].dtype == x.dtype
          and card[2].dtype == w.dtype, "fp8: y and dx in x's dtype, dw in "
          "w's")
    if not timed:
        return errs
    xq = fp8._quantize(x, xm.scale, fp8.E4M3)
    wq = fp8._quantize(w, wm.scale, fp8.E4M3)
    inv_x, inv_w = xm.scale.reciprocal(), wm.scale.reciprocal()
    gs = fp8._jit_scale(g)
    gq, inv_g = fp8._quantize(g, gs, fp8.E5M2), gs.reciprocal()
    wq_t, gq_t, xq_t = fp8._t(wq), fp8._t(gq), fp8._t(xq)
    wb = w.to(x_dtype)
    ms = {
        "fwd": timer(lambda: fp8._scaled_mm_t(xq, wq, inv_x, inv_w, x.dtype)),
        "dx": timer(lambda: fp8._scaled_mm_t(gq, wq_t, inv_g, inv_w,
                                             torch.float32)),
        "dw": timer(lambda: fp8._scaled_mm_t(gq_t, xq_t, inv_g, inv_x,
                                             torch.float32)),
        "plain_fwd": timer(lambda: fp8._fp8_matmul_t(x, w, xm, wm, "plain")),
        "bf16_matmul": timer(lambda: torch.matmul(x, wb.t())),
        "quantize_x": timer(lambda: fp8.update_meta(
            xm, fp8.fp8_quantize(x, xm)[1])),
    }
    # fp8 operands read once, the bf16 product written once; 2 n in out
    # fp8 operations
    by, kind = bound(n * d_in + d_out * d_in + n * d_out * 2,
                     2 * n * d_in * d_out, "fp8")
    rec = {k: round(v, 4) for k, v in ms.items()}
    rec.update(bound_ms=round(by, 5), bound_by=kind,
               err=errs)
    log(f"  fp8 GEMM[{label}] ms: {json.dumps(rec)}")
    return rec


def fp8_train(torch, fa, fp8, flash_first_loss, flash_step):
    """GPT-124M with fp8 transformer GEMMs over the flash core: phase 5's
    widths, weights, batch and optimizer; returns the flash launches and
    the step time (s)."""
    from apex_tpu_torch.testing.l1 import train_step

    cfg = dataclasses.replace(gpt124m_train(torch, torch.bfloat16), fp8=True)
    model, opt = trainer(torch, cfg, seed=0)
    tokens = train_tokens(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    zero_fp8_counts(fp8)
    losses = [train_step(model, opt, tokens) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [train_step(model, opt, tokens) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / TIMED_STEPS
    steps = WARMUP_STEPS + TIMED_STEPS
    counts, gemms = flash_counts(fa), fp8_counts(fp8)
    L = cfg.num_layers
    check(all(c == L * steps for c in counts.values())
          and flash_route_counts(fa) == {"tc": (L * steps,) * 3,
                                         "simt": (0, 0, 0)},
          f"fp8: F1/F2/F3 launched {L} times per step, all on the tc "
          f"route: {counts}, {flash_route_counts(fa)}")
    check(gemms == (4 * L * steps, 8 * L * steps),
          f"fp8: {4 * L} forward and {8 * L} backward fp8 GEMMs per step: "
          f"{gemms} over {steps} steps")
    losses = [float(x) for x in losses]
    check(all(x == x and abs(x) < 1e4 for x in losses)
          and losses[-1] < losses[0],
          f"fp8: the losses are finite and fall: {losses}")
    rel = abs(losses[0] - flash_first_loss) / abs(flash_first_loss)
    check(rel <= 2e-2, f"fp8: the first loss {losses[0]:.6f} within 2e-2 of "
          f"phase 5's {flash_first_loss:.6f} (relative {rel:.2e})")
    scales = torch.stack([v for k, v in model.fp8_meta_state().items()
                          if k.endswith(".scale")])
    check(len(scales) == 8 * L and bool(torch.isfinite(scales).all())
          and bool((scales > 0).all()),
          f"fp8: all {8 * L} scales finite and positive: "
          f"{scales.min().item():.4g} to {scales.max().item():.4g}")
    log(f"train[GPT-124M fp8, flash core, batch {TRAIN_BATCH} x {SEQ}, bf16 "
        f"compute]: step {step * 1e3:.3f} ms = {TRAIN_BATCH * SEQ / step:.1f}"
        f" tokens/s over {TIMED_STEPS} timed steps (phase 5's bf16 step "
        f"{flash_step * 1e3:.3f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first loss "
        f"{losses[0]:.6f} (phase 5 {flash_first_loss:.6f}, relative "
        f"{rel:.2e}); losses {losses}; launches {counts}; fp8 GEMMs "
        f"{gemms}; scales {scales.min().item():.4g} to "
        f"{scales.max().item():.4g}")
    # an eval() forward leaves every meta as it was, bit for bit
    before = {k: v.clone() for k, v in model.fp8_meta_state().items()}
    model.eval()
    with torch.no_grad():
        model(tokens, labels=tokens)
    model.train()
    after = model.fp8_meta_state()
    check(all(torch.equal(before[k], after[k]) for k in before),
          "fp8: an eval() forward leaves every meta bit for bit")
    # the profiled step, with each fp8 stage in a profiler range (the
    # functions are wrapped for this step only)
    stages = {"_scaled_mm_t": "fp8 GEMMs", "_quantize": "fp8 quantize",
              "_amax": "fp8 amax", "update_meta": "fp8 roll"}
    originals = {name: getattr(fp8, name) for name in stages}

    def ranged(label, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run

    zero_fp8_counts(fp8)
    for name, label in stages.items():
        setattr(fp8, name, ranged(label, originals[name]))
    try:
        prof = profile_train(torch, model, opt, tokens, "GPT-124M fp8 step")
    finally:
        for name, fn in originals.items():
            setattr(fp8, name, fn)
    check(fp8_counts(fp8) == (4 * L, 8 * L), "fp8: the profiled step's GEMMs")
    cpu = torch.autograd.DeviceType.CPU
    spent = {e.key: (e.device_time_total, e.count)
             for e in prof.key_averages()
             if e.device_type == cpu and e.key in stages.values()}
    log("  fp8 stages in the profiled step (device time of the kernels "
        "each launched): " + ", ".join(
            f"{k} {us / 1e3:.3f} ms over {n} calls"
            for k, (us, n) in sorted(spent.items())))
    return counts, step


def fp8_card_vs_cpu(torch):
    """``gpt_fp8`` (fp32, fused-softmax core, fp8 GEMMs) for its ten steps
    on the card and on the CPU from the same weights and tokens."""
    from apex_tpu_torch.testing import l1
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )

    cfg = l1.trace_config("gpt_fp8")
    params = init_gpt_params(cfg, seed=5)
    tokens = torch.randint(0, cfg.padded_vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(6))
    runs = {d: l1.run_trace("gpt_fp8", device=d, params=params,
                            tokens=tokens, with_fp8_meta=True)
            for d in ("cuda", "cpu")}
    (card, card_m), (cpu, cpu_m) = runs["cuda"], runs["cpu"]
    problems = l1.compare_traces(card, cpu, **FP8_TRACE_TOL)
    worst = {key: max(abs(a - b) / abs(b) for a, b in zip(card[key],
                                                            cpu[key]))
             for key in ("loss", "grad_norm")}
    scale_rel = max(((card_m[k].cpu() - v).abs() / v.abs()).max().item()
                    for k, v in cpu_m.items() if k.endswith(".scale"))
    log(f"train card vs CPU [gpt_fp8, fp32, TF32 off]: worst relative loss "
        f"{worst['loss']:.3g}, grad norm {worst['grad_norm']:.3g}, final "
        f"scale {scale_rel:.3g}; card {card}, CPU {cpu}")
    check(not problems, f"gpt_fp8 card and CPU agree: {problems}")
    check(scale_rel <= FP8_SCALE_RTOL,
          f"gpt_fp8: the final scales within {FP8_SCALE_RTOL}: {scale_rel}")


def fp8_phase(torch, fa, flash_first_loss, flash_step):
    """Phase 10: the fp8 GEMM card against plain, GPT-124M's fp8 step, and
    ``gpt_fp8`` card against CPU; returns the fp8 step's flash launches."""
    from apex_tpu_torch.amp import fp8

    t0 = time.perf_counter()
    timer = Timer(torch)
    table = {}
    for i, (proj, (d_in, d_out)) in enumerate(LORA_PAIRS.items()):
        table[proj] = check_fp8_gemm(torch, fp8, timer, proj, FP8_TOKENS,
                                     d_in, d_out, torch.bfloat16, 40 + i,
                                     timed=True)
    for i, (label, n, d_in, d_out, dt) in enumerate(FP8_EDGES):
        check_fp8_gemm(torch, fp8, timer, label, n, d_in, d_out,
                       getattr(torch, DTYPES[dt]), 50 + i, timed=False)
    counts, step = fp8_train(torch, fa, fp8, flash_first_loss, flash_step)
    fp8_card_vs_cpu(torch)
    log(json.dumps({"fp8_gemms": table}))
    log(f"phase 10 (fp8): {time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------ phase 11: parallel at world size 1

PAR_ROWS = TRAIN_BATCH * SEQ        # GPT-124M's LM-head rows
PAR_VOCAB = 50304
PAR_XENT_TOL = 1e-5                 # loss (relative); gradient, of its RMS
# the collectives each mapping region issues: (forward, backward)
REGION_CALLS = {
    "copy_to_tensor_model_parallel_region": ({}, {"all_reduce": 1}),
    "reduce_from_tensor_model_parallel_region": ({"all_reduce": 1}, {}),
    "scatter_to_tensor_model_parallel_region": ({}, {"all_gather": 1}),
    "gather_from_tensor_model_parallel_region": ({"all_gather": 1}, {}),
    "scatter_to_sequence_parallel_region": ({}, {"all_gather": 1}),
    "gather_from_sequence_parallel_region": (
        {"all_gather": 1}, {"reduce_scatter": 1}),
    "reduce_scatter_to_sequence_parallel_region": (
        {"reduce_scatter": 1}, {"all_gather": 1}),
}


def calls_since(cc, before):
    return {k: v - before.get(k, 0) for k, v in cc.CALLS.items()
            if v != before.get(k, 0)}


def check_collectives(torch, cc):
    """Every function of ``parallel/collectives.py`` on CUDA tensors over
    a one-rank NCCL group: each gives back its input bit for bit, and
    each kind's counter moves."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1024, HIDDEN, generator=gen, device="cuda").to(
        torch.bfloat16)
    tp, dp = "tp", ("dcn", "dp")
    cc.zero_counts()
    outs = {
        "all_reduce sum": (cc.all_reduce(x, tp), x),
        "all_reduce mean": (cc.all_reduce(x, dp, "mean"), x),
        "all_reduce max": (cc.all_reduce(x, tp, "max"), x),
        "all_reduce min": (cc.all_reduce(x.float(), dp, "min"), x.float()),
        "all_gather tiled": (cc.all_gather(x, tp, concat_axis=1), x),
        "all_gather stacked": (cc.all_gather(x, dp, tiled=False), x[None]),
        "reduce_scatter": (cc.reduce_scatter(x, tp, scatter_axis=1), x),
        "broadcast": (cc.broadcast(x, dp, root=0), x),
        "ppermute": (cc.ppermute(x, tp, [(0, 0)]), x),
        "send_recv_next": (cc.send_recv_next(x, tp), x),
        "send_recv_prev": (cc.send_recv_prev(x, dp), x),
        "all_to_all": (cc.all_to_all(x, tp, split_axis=0, concat_axis=1), x),
        "ring_chunks": (cc.ring_chunks(x, tp, dim=0), x[None]),
    }
    torch.cuda.synchronize()
    calls = dict(cc.CALLS)
    for name, (got, want) in outs.items():
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"collective {name} gives back its input bit for bit at one "
              f"rank")
    check(calls == {"all_reduce": 4, "all_gather": 2, "reduce_scatter": 1,
                    "broadcast": 1, "ppermute": 3, "all_to_all": 1},
          f"every collective issued, once a call: {calls}")
    sizes = (cc.axis_index(tp), cc.axis_size(tp), cc.axis_size(dp),
             cc.bound_axis_size(tp), cc.bound_axis_size(None))
    check(sizes == (0, 1, 1, 1, 1), f"axis index and sizes: {sizes}")
    log(f"parallel: {len(outs)} collectives bit for bit over NCCL at one "
        f"rank; calls {calls}")
    return calls


def check_mappings(torch, cc, tp):
    """The seven regions forward and backward on CUDA tensors: values and
    gradients bit for bit, each region's collectives counted."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    x0 = torch.randn(SEQ, TRAIN_BATCH, HIDDEN, generator=gen, device="cuda")
    g = torch.randn(x0.shape, generator=gen, device="cuda")
    n = 0
    for name, (fwd_calls, bwd_calls) in REGION_CALLS.items():
        fn = getattr(tp, name)
        cases = [((), fwd_calls, bwd_calls)]
        if name == "gather_from_sequence_parallel_region":
            cases.append(((False,), fwd_calls, {}))
        for extra, want_fwd, want_bwd in cases:
            x = x0.clone().requires_grad_(True)
            before = dict(cc.CALLS)
            y = fn(x, "tp", *extra)
            fwd = calls_since(cc, before)
            before = dict(cc.CALLS)
            y.backward(g)
            bwd = calls_since(cc, before)
            what = f"{name}{extra}"
            check(torch.equal(y, x0) and torch.equal(x.grad, g),
                  f"{what}: value and gradient bit for bit at one rank")
            check((fwd, bwd) == (want_fwd, want_bwd),
                  f"{what}: collectives forward {fwd}, backward {bwd}")
            n += 1
    log(f"parallel: {n} mapping region calls forward and backward bit for "
        f"bit, each with its collectives")


def check_vocab_parallel_xent(torch, timer, F):
    """``vocab_parallel_cross_entropy`` at GPT-124M's LM-head shape (bf16
    logits) over the one-rank tensor axis against
    ``softmax_cross_entropy_loss`` at the reference's smoothing ``s * V /
    (V - 1)``; the forward + backward device times of both and of
    ``F.cross_entropy`` (the same loss, in one library call)."""
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    logits = (2 * torch.randn(PAR_ROWS, PAR_VOCAB, generator=gen,
                              device="cuda")).to(torch.bfloat16)
    target = torch.randint(0, PAR_VOCAB, (PAR_ROWS,), generator=gen,
                           device="cuda")
    rec = {}
    for s in (0.0, 0.1):
        s_ref = s * PAR_VOCAB / (PAR_VOCAB - 1)
        a = logits.clone().requires_grad_(True)
        b = logits.clone().requires_grad_(True)
        la = vocab_parallel_cross_entropy(a, target, "tp", s)
        lb = softmax_cross_entropy_loss(b, target, s_ref, -1, True)
        la.mean().backward()
        lb.mean().backward()
        loss_rel = ((la - lb).abs() / lb.abs()).max().item()
        rms = b.grad.float().pow(2).mean().sqrt()
        grad_err = ((a.grad.float() - b.grad.float()).abs().max()
                    / rms).item()
        check(loss_rel <= PAR_XENT_TOL and grad_err <= PAR_XENT_TOL,
              f"vocab-parallel CE (smoothing {s}) against the fused one: "
              f"loss {loss_rel:.3g} relative, gradient {grad_err:.3g} of "
              f"its RMS")
        bitwise = torch.equal(la, lb) and torch.equal(a.grad, b.grad)
        del a, b, la, lb

        def run(fn, leaf):
            leaf.grad = None
            fn(leaf).mean().backward()

        leaf = logits.clone().requires_grad_(True)
        times = {
            "vocab_parallel_ms": timer(lambda: run(
                lambda v: vocab_parallel_cross_entropy(v, target, "tp", s),
                leaf)),
            "fused_xentropy_ms": timer(lambda: run(
                lambda v: softmax_cross_entropy_loss(v, target, s_ref, -1,
                                                     True), leaf)),
            "F.cross_entropy_ms": timer(lambda: run(
                lambda v: F.cross_entropy(v, target, reduction="none",
                                          label_smoothing=s), leaf)),
        }
        del leaf
        rec[f"smoothing {s}"] = dict(loss_rel=loss_rel, grad_err=grad_err,
                                     bitwise=bitwise, **times)
        log(f"parallel: vocab-parallel CE [{PAR_ROWS} x {PAR_VOCAB} bf16, "
            f"smoothing {s}, forward + backward]: {json.dumps(rec[f'smoothing {s}'])}")
    return rec


def parallel_train(torch, fa, cc, flash_first_loss, flash_step):
    """GPT-124M at phase 5's widths, weights and batch with
    ``tensor_axis="tp"``, ``sequence_parallel=True`` and the flash core,
    through ``DistributedDataParallel`` and FusedAdam on the one-rank
    grid; returns the flash launches and the step time (s)."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.testing.l1 import parallel_train_step
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel

    cfg = dataclasses.replace(gpt124m_train(torch, torch.bfloat16),
                              tensor_axis="tp", sequence_parallel=True)
    model = GPTModel(cfg, device="cuda")
    model.load_params(init_gpt_params(cfg, 0, device="cuda"))
    ddp = parallel.DistributedDataParallel(model)
    opt = FusedAdam(model.parameters(), lr=1e-4)
    batch = parallel.dp_shard_batch(train_tokens(torch))
    check(batch.shape == (TRAIN_BATCH, SEQ), "one rank's batch is all of it")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    cc.zero_counts()
    losses = [parallel_train_step(ddp, opt, batch)
              for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [parallel_train_step(ddp, opt, batch)
               for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / TIMED_STEPS
    steps = WARMUP_STEPS + TIMED_STEPS
    counts, calls = flash_counts(fa), dict(cc.CALLS)
    L = cfg.num_layers
    check(all(c == L * steps for c in counts.values())
          and flash_route_counts(fa) == {"tc": (L * steps,) * 3,
                                         "simt": (0, 0, 0)},
          f"parallel: F1/F2/F3 launched {L} times per step, all on the tc "
          f"route: {counts}, {flash_route_counts(fa)}")
    check(calls == {**{k: 0 for k in cc.CALLS}, "all_reduce": steps},
          f"parallel: one DDP all-reduce (the fp32 gradients' bucket) per "
          f"step and no other collective at one rank: {calls}")
    losses = [float(x) for x in losses]
    check(all(x == x and abs(x) < 1e4 for x in losses)
          and losses[-1] < losses[0],
          f"parallel: the losses are finite and fall: {losses}")
    rel = abs(losses[0] - flash_first_loss) / abs(flash_first_loss)
    check(rel <= 2e-2, f"parallel: the first loss {losses[0]:.6f} within 2e-2 "
          f"of phase 5's {flash_first_loss:.6f} (relative {rel:.2e})")
    log(f"train[GPT-124M tp+sp at one rank, DDP, flash core, batch "
        f"{TRAIN_BATCH} x {SEQ}, bf16 compute]: step {step * 1e3:.3f} ms = "
        f"{TRAIN_BATCH * SEQ / step:.1f} tokens/s over {TIMED_STEPS} timed "
        f"steps (phase 5's step {flash_step * 1e3:.3f} ms, "
        f"{(step / flash_step - 1) * 100:+.1f}%); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first loss "
        f"{losses[0]:.6f} (phase 5 {flash_first_loss:.6f}, relative "
        f"{rel:.2e}); losses {losses}; launches {counts}; collectives "
        f"{calls}")
    ab = step_ab(torch, "parallel",
                 lambda: parallel_train_step(ddp, opt, batch), batch)
    prof = profile_parallel(torch, ddp, opt, batch)
    return counts, step, dict(prof, ab=ab)


AB_ROUNDS, AB_STEPS = 4, 4


def step_ab(torch, name, step, batch):
    """Phase 5's step and ``step`` (one step of the path ``name``) in
    alternating blocks of ``AB_STEPS`` (plain, ``name``, ``name``, plain
    per round), so the host clock's drift falls on both: the blocks' ms a
    step and the medians."""
    from apex_tpu_torch.testing.l1 import train_step

    model, plain_opt = trainer(torch, gpt124m_train(torch, torch.bfloat16),
                               seed=0)

    def block(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AB_STEPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / AB_STEPS * 1e3

    plain = lambda: train_step(model, plain_opt, batch)  # noqa: E731
    block(plain)
    block(step)
    times = {"plain": [], name: []}
    for _ in range(AB_ROUNDS):
        for key, fn in (("plain", plain), (name, step), (name, step),
                        ("plain", plain)):
            times[key].append(block(fn))
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"step A/B [phase 5's step, the {name} step; {AB_ROUNDS} rounds "
        f"of plain, {name}, {name}, plain blocks of {AB_STEPS} steps]: "
        f"medians {med['plain']:.3f} / {med[name]:.3f} ms "
        f"({(med[name] / med['plain'] - 1) * 100:+.1f}%); blocks "
        f"{json.dumps(times)}")
    del model, plain_opt
    return {"median_ms": med, "blocks_ms": times}


def profile_parallel(torch, ddp, opt, batch):
    """One profiled parallel step: the device time of NCCL's kernels and
    of the gradient bucket's copies beside the step's."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.testing.l1 import parallel_train_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        parallel_train_step(ddp, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy_us = device_rows(torch, prof)
    check(busy_us > 0, "the profiler saw device time")
    nccl = [r for r in rows if "nccl" in r[2].lower()]
    nccl_us = sum(r[0] for r in nccl)
    log(f"profile[GPT-124M tp+sp step at one rank]: wall {wall * 1e3:.1f} "
        f"ms, device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / (wall * 1e6):.3f} of the wall; NCCL kernels "
        f"{nccl_us / 1e3:.3f} ms over {sum(r[1] for r in nccl)} launches")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    for us, count, key in nccl:
        log(f"  nccl {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
            "nccl_ms": nccl_us / 1e3}


def parallel_phase(torch, fa, F, flash_first_loss, flash_step):
    """Phase 11: ``apex_tpu_torch.parallel`` at world size 1 over a real
    NCCL process group; returns the GPT step's flash launches."""
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import collectives as cc
    from apex_tpu_torch.parallel import launch
    from apex_tpu_torch.transformer import tensor_parallel as tp

    t0 = time.perf_counter()
    launch.initialize_distributed(f"127.0.0.1:{launch.free_port()}", 1, 0,
                                  backend="nccl")
    try:
        check(dist.get_backend() == "nccl", "an NCCL process group")
        parallel.initialize_model_parallel(1, 1)
        calls = check_collectives(torch, cc)
        check_mappings(torch, cc, tp)
        xent = check_vocab_parallel_xent(torch, Timer(torch), F)
        counts, step, prof = parallel_train(torch, fa, cc, flash_first_loss,
                                            flash_step)
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()
    log(json.dumps({"parallel": {
        "collectives": calls, "vocab_parallel_xent": xent,
        "step_ms": step * 1e3, "phase5_step_ms": flash_step * 1e3,
        "profile": prof}}))
    log(f"phase 11 (parallel at world size 1): "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------ phase 12: the pipeline at world size 1

PIPE_CHUNKS, PIPE_MICROBATCHES = 12, 4   # pp = 1: each layer a chunk
PIPE_LOSS_TOL = 1e-3                     # first loss against phase 5's


def pipeline_build(torch, **kw):
    """``build_gpt_3d`` at phase 5's widths (bf16 compute, the flash core)
    on the one-rank grid: its parameters are ``init_fn(0)``, phase 5's
    weights; FusedAdam at phase 5's rate.  Returns ``(params, step)``."""
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )

    init_fn, _, make_train_step = build_gpt_3d(
        gpt124m_train(torch, torch.bfloat16), num_chunks=PIPE_CHUNKS,
        num_microbatches=PIPE_MICROBATCHES, **kw)
    params, specs = init_fn(0)
    opt = FusedAdam(tree_leaves(params), lr=1e-4)
    return params, make_train_step(opt, specs)


def pipeline_launches(steps, forwards=2):
    """F1-F3 launches of ``steps`` pipelined steps: each tick (a layer on
    a microbatch; pp = 1 has no bubble) runs F1 in its forward and again
    in each recomputation (``forwards``: 2 with remat, 3 when the tick's
    group is recomputed too), F2 and F3 once in the backward."""
    per = PIPE_CHUNKS * PIPE_MICROBATCHES * steps
    return {"flash_fwd": forwards * per, "flash_dq": per, "flash_dkv": per}


def check_pipeline_launches(fa, want, what):
    counts = flash_counts(fa)
    check(counts == want and flash_route_counts(fa) == {
        "tc": tuple(want.values()), "simt": (0, 0, 0)},
        f"pipeline: {what}: F1/F2/F3 launched {counts} (want {want}), all "
        f"on the tc route ({flash_route_counts(fa)})")
    return counts


def profile_step(torch, label, step, kinds=None):
    """One step under ``torch.profiler`` after ``reset_peak_memory_stats``:
    wall and device busy ms, the resident and peak GiB, the top rows; with
    ``kinds`` (name -> substrings of a kernel's name, the first match
    wins, "other" the rest) also the device ms of each kind."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rows, busy_us = device_rows(torch, prof)
    check(busy_us > 0, "the profiler saw device time")
    rec = {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
           "resident_gib": resident / 2**30, "peak_gib": peak / 2**30,
           "step_peak_gib": (peak - resident) / 2**30,
           "device_launches": sum(r[1] for r in rows)}
    if kinds:
        by_kind = dict.fromkeys([*kinds, "other"], 0.0)
        for us, _, key in rows:
            kind = next((k for k, subs in kinds.items()
                         if any(sub in key for sub in subs)), "other")
            by_kind[kind] += us / 1e3
        rec["device_ms_by_kind"] = by_kind
    log(f"profile[{label}]: {json.dumps(rec)}")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    return rec


def pipeline_train(torch, fa, cc, flash_first_loss):
    """The main path: 2 + 8 pipelined steps; returns the F1-F3 launches,
    the step time (s), the losses and the trainer."""
    params, step = pipeline_build(torch)
    tokens = train_tokens(torch)
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    cc.zero_counts()
    losses = [step(params, tokens) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(params, tokens) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    counts = check_pipeline_launches(
        fa, pipeline_launches(WARMUP_STEPS + TIMED_STEPS),
        f"{WARMUP_STEPS + TIMED_STEPS} steps of {PIPE_MICROBATCHES} "
        f"microbatches x {PIPE_CHUNKS} chunks, remat")
    calls = dict(cc.CALLS)
    check(not any(calls.values()),
          f"pipeline: no collective at world size 1 (pp, tp and dp of one "
          f"rank skip the rotation, the regions and the reductions): "
          f"{calls}")
    losses = [float(x) for x in losses]
    check(all(x == x and abs(x) < 1e4 for x in losses)
          and losses[-1] < losses[0],
          f"pipeline: the losses are finite and fall: {losses}")
    diff = losses[0] - flash_first_loss
    rel = abs(diff) / abs(flash_first_loss)
    check(rel <= PIPE_LOSS_TOL,
          f"pipeline: the first loss {losses[0]:.6f} within "
          f"{PIPE_LOSS_TOL} of phase 5's {flash_first_loss:.6f} (difference "
          f"{diff:+.3e}, relative {rel:.3e})")
    log(f"train[GPT-124M pipelined, pp 1, {PIPE_CHUNKS} chunks, "
        f"{PIPE_MICROBATCHES} microbatches, batch {TRAIN_BATCH} x {SEQ}, "
        f"bf16 compute]: step {step_s * 1e3:.3f} ms = "
        f"{TRAIN_BATCH * SEQ / step_s:.1f} tokens/s over {TIMED_STEPS} timed "
        f"steps; first loss {losses[0]:.6f} (phase 5 {flash_first_loss:.6f}, "
        f"difference {diff:+.3e}, relative {rel:.3e}); losses {losses}; "
        f"launches {counts}")
    return counts, step_s, losses, rel, (params, step, tokens)


def pipeline_variant(torch, fa, label, first_loss, tokens, tol, forwards,
                     batch=None, **kw):
    """One step of a pipeline variant from phase 5's weights: its loss
    against the plain pipelined first loss, its launches, then one more
    step's peak above the resident state."""
    params, step = pipeline_build(torch, **kw)
    batch = tokens if batch is None else batch
    zero_flash_counts(fa)
    loss = float(step(params, batch))
    counts = check_pipeline_launches(fa, pipeline_launches(1, forwards),
                                     f"one {label} step")
    rel = abs(loss - first_loss) / abs(first_loss)
    check(rel <= tol, f"pipeline: the {label} step's loss {loss:.6f} within "
          f"{tol} of the pipelined step's {first_loss:.6f} (relative "
          f"{rel:.3e})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step(params, batch)
    torch.cuda.synchronize()
    rec = {"loss": loss, "rel": rel,
           "step_peak_gib": (torch.cuda.max_memory_allocated() - resident)
           / 2**30}
    log(f"pipeline[{label}]: {json.dumps(rec)}; launches {counts}")
    return counts, rec


def pipeline_phase(torch, fa, flash_first_loss, flash_step):
    """Phase 12: ``build_gpt_3d``'s pipelined step at world size 1 over a
    real NCCL process group; returns its flash launches."""
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import collectives as cc
    from apex_tpu_torch.parallel import launch
    from apex_tpu_torch.testing.l1 import train_step

    t0 = time.perf_counter()
    launch.initialize_distributed(f"127.0.0.1:{launch.free_port()}", 1, 0,
                                  backend="nccl")
    try:
        check(dist.get_backend() == "nccl", "an NCCL process group")
        parallel.initialize_model_parallel(1, 1)
        counts, step_s, losses, rel, (params, step, tokens) = \
            pipeline_train(torch, fa, cc, flash_first_loss)
        launches = dict(counts)
        pipe_prof = profile_step(torch, "GPT-124M pipelined step",
                                 lambda: step(params, tokens))
        ab = step_ab(torch, "pipelined", lambda: step(params, tokens),
                     tokens)
        del params, step
        model, opt = trainer(torch, gpt124m_train(torch, torch.bfloat16),
                             seed=0)
        for _ in range(WARMUP_STEPS):
            train_step(model, opt, tokens)
        plain_prof = profile_step(torch, "phase 5's step",
                                  lambda: train_step(model, opt, tokens))
        del model, opt

        seg = {"fwd": 0, "bwd": 0, "calls": 0}

        def spy(name, key, index):
            orig = getattr(fa, name)

            def call(*a, **k):
                seg["calls"] += key == "fwd"
                seg[key] += a[index] is not None
                return orig(*a, **k)
            return orig, call

        variants = {}
        for label, tol, forwards, kw in (
                ("remat_ticks", 1e-6, 3, dict(remat_ticks=True)),
                ("packed block-diagonal", PIPE_LOSS_TOL, 2,
                 dict(packed_inputs=True, block_diagonal=True))):
            batch = None
            spies = {}
            if kw.get("block_diagonal"):
                # full-coverage segments: one document a row
                batch = (tokens, torch.ones_like(tokens, dtype=torch.int32))
                for name, key, index in (("_fwd", "fwd", 3),
                                         ("_dq", "bwd", 6),
                                         ("_dkv", "bwd", 6)):
                    spies[name], call = spy(name, key, index)
                    setattr(fa, name, call)
            try:
                c, variants[label] = pipeline_variant(
                    torch, fa, label, losses[0], tokens, tol, forwards,
                    batch=batch, **kw)
            finally:
                for name, orig in spies.items():
                    setattr(fa, name, orig)
            for k, v in c.items():
                launches[k] += v
        per = PIPE_CHUNKS * PIPE_MICROBATCHES * 2        # two steps
        check(seg == {"fwd": 2 * per, "bwd": 2 * per, "calls": 2 * per},
              f"pipeline: every flash call of the packed steps took the "
              f"segment ids ({seg})")
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()
    rec = {"step_ms": step_s * 1e3, "phase5_step_ms": flash_step * 1e3,
           "first_loss_rel": rel, "launches_per_step": pipeline_launches(1),
           "profile": pipe_prof, "phase5_profile": plain_prof, "ab": ab,
           **variants}
    log(json.dumps({"pipeline": rec}))
    log(f"phase 12 (pipeline at world size 1): "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# -------------- phase 13: context parallelism and MoE at world size 1

CP_LOSS_TOL = 1e-5            # the ring step's first loss against its twin
ULYSSES_LOSS_TOL = 2e-2       # the Ulysses step with dropout against (a)
CP_DROPOUT = 0.1
ULYSSES_STEPS = 4             # timed Ulysses steps, after WARMUP_STEPS
MOE_EXPERTS, MOE_CAPACITY, MOE_AUX_COEFF = 8, 1.25, 1e-2


def cp_config(torch, impl, **kw):
    """Phase 5's model with ``context_axis="cp"`` (no tensor axis)."""
    return dataclasses.replace(gpt124m_train(torch, torch.bfloat16),
                               tensor_axis=None, context_axis="cp",
                               context_impl=impl, **kw)


def moe_config(torch, **kw):
    return dataclasses.replace(gpt124m_train(torch, torch.bfloat16),
                               num_experts=MOE_EXPERTS,
                               expert_capacity_factor=MOE_CAPACITY, **kw)


def check_cp_identities(torch, cc):
    """The cp axis's rotation (a self-permutation) and all-to-all at one
    rank: each gives its input back; the kernels of one profiled call
    (an empty list where the profiler recorded no device activity) and
    the CUDA-event time of a call, over 10.  (``context_parallel`` skips
    both at cp = 1.)"""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(TRAIN_BATCH, N_HEADS, SEQ, HEAD_DIM, device="cuda",
                    dtype=torch.bfloat16)
    rec = {}
    for name, fn in (
            ("ppermute_many", lambda: cc.ppermute_many([x], "cp",
                                                       [(0, 0)])[0]),
            ("all_to_all", lambda: cc.all_to_all(x, "cp", split_axis=1,
                                                 concat_axis=2))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            y = fn()
            torch.cuda.synchronize()
        check(torch.equal(y, x), f"cp at one rank: {name} gives its input "
              f"back")
        rows, busy = device_rows(torch, prof)
        nccl = [r for r in rows if "nccl" in r[2].lower()]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        rec[name] = {"device_us": busy, "nccl_launches": sum(
            r[1] for r in nccl), "kernels": [r[2][:60] for r in rows],
            "event_us": start.elapsed_time(end) * 100}
    log(f"cp at one rank: {json.dumps(rec)}")
    return rec


def seed_spy(fa, seen):
    """Wrap F1-F3's wrappers to count the calls made with and without a
    dropout seed; returns the originals to put back."""
    origs = {}
    for name, index in (("_fwd", 5), ("_dq", 8), ("_dkv", 8)):
        orig = getattr(fa, name)

        def call(*a, _orig=orig, _name=name, _i=index, **k):
            seen[_name, a[_i] is not None] = \
                seen.get((_name, a[_i] is not None), 0) + 1
            return _orig(*a, **k)
        origs[name] = orig
        setattr(fa, name, call)
    return origs


def ring_spy(cpl, seen):
    """Wrap the flash entry points that ``context_parallel`` calls to count
    each with its causal flag (the ring's case: ``True`` is the diagonal
    chunk); returns the originals to put back."""
    origs = {}
    for name in ("flash_attention_with_lse", "dq_chunk", "dkv_chunk"):
        orig = getattr(cpl, name)

        def call(*a, _orig=orig, _name=name, **k):
            causal = k["causal"] if "causal" in k else a[3]
            seen[_name, causal] = seen.get((_name, causal), 0) + 1
            return _orig(*a, **k)
        origs[name] = orig
        setattr(cpl, name, call)
    return origs


def serial_twin_loss(torch, cfg, tokens):
    """The serial model's loss on phase 5's weights: the same modules
    without ``context_axis``, the whole sequence, the next-token mean."""
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel

    serial = dataclasses.replace(cfg, context_axis=None)
    model = GPTModel(serial, device="cuda")
    model.load_params(init_gpt_params(serial, 0, device="cuda"))
    with torch.no_grad():
        loss = float(model(tokens, labels=tokens).mean())
    del model
    return loss


def cp_train(torch, fa, cc, impl, steps, generator=None, **kw):
    """``build_gpt_cp`` from phase 5's weights: ``WARMUP_STEPS + steps``
    steps; returns the losses, the step time (s), the flash launches and
    the collectives, and the step."""
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.gpt_cp_train import build_gpt_cp

    init_fn, _, make_train_step = build_gpt_cp(cp_config(torch, impl, **kw))
    params, specs = init_fn(0)
    step = make_train_step(FusedAdam(tree_leaves(params), lr=1e-4), specs)
    tokens = train_tokens(torch)
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    cc.zero_counts()
    losses = [step(params, tokens, generator) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(params, tokens, generator) for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    n = WARMUP_STEPS + steps
    counts = flash_counts(fa)
    L = 12
    check(counts == {k: L * n for k in counts}
          and flash_route_counts(fa) == {"tc": (L * n,) * 3,
                                         "simt": (0, 0, 0)},
          f"cp[{impl}]: F1/F2/F3 launched {L} times a step, all on tc: "
          f"{counts}, {flash_route_counts(fa)}")
    calls = dict(cc.CALLS)
    check(not any(calls.values()),
          f"cp[{impl}]: no collective at cp = dp = 1: {calls}")
    losses = [float(x) for x in losses]
    check(all(x == x and abs(x) < 1e4 for x in losses)
          and losses[-1] < losses[0],
          f"cp[{impl}]: the losses are finite and fall: {losses}")
    return losses, step_s, counts, (lambda: step(params, tokens, generator))


def moe_dropped(torch, model, tokens):
    """Tokens each Switch layer dropped in one forward (its routing
    recomputed from the layer's input, so the step itself is untouched)."""
    from apex_tpu_torch.transformer.moe import SwitchMLP, switch_route

    dropped, hooks = [], []

    def hook(m, inputs, _out):
        x = inputs[0].reshape(-1, m.hidden_size)
        d, _, _ = switch_route(x.float() @ m.router.float(),
                               m.capacity(x.shape[0]))
        dropped.append(x.shape[0] - int(d.sum()))

    for m in model.modules():
        if isinstance(m, SwitchMLP):
            hooks.append(m.register_forward_hook(hook))
    with torch.no_grad():
        model(tokens)
    for h in hooks:
        h.remove()
    return dropped


def moe_einsum_ms(torch, timer):
    """Forward + backward device ms of one layer's dispatch and combine
    (``moe.dispatch_tokens``/``combine_tokens``, the reference's one-hot
    einsums) at the MoE step's shapes (the ``[T, E*C]`` bf16 mask)."""
    from apex_tpu_torch.transformer import moe

    T = TRAIN_BATCH * SEQ
    m = moe.SwitchMLP(HIDDEN, 4 * HIDDEN, MOE_EXPERTS,
                      capacity_factor=MOE_CAPACITY, device="cuda")
    C = m.capacity(T)
    gen = torch.Generator(device="cuda").manual_seed(9)
    idx = torch.randint(0, MOE_EXPERTS * C, (T,), generator=gen,
                        device="cuda")
    dd = torch.nn.functional.one_hot(idx, MOE_EXPERTS * C).to(
        torch.bfloat16)
    flat = torch.randn(T, HIDDEN, device="cuda", dtype=torch.bfloat16,
                       requires_grad=True)
    out = torch.randn(MOE_EXPERTS * C, HIDDEN, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(T, HIDDEN, device="cuda", dtype=torch.bfloat16)

    def both():
        e_in = moe.dispatch_tokens(dd, flat)
        y = moe.combine_tokens(dd, out)
        torch.autograd.backward([e_in, y], [e_in.detach(), g])

    ms = timer(both)
    # two products forward and one each backward (the mask takes none)
    flops = 4 * 2 * T * MOE_EXPERTS * C * HIDDEN
    bound_ms, by = bound(0, flops, "bf16")
    return {"ms": ms, "capacity": C, "gflop": flops / 1e9,
            "bound_ms": bound_ms, "bound_by": by}


def moe_train(torch, fa, cc, timer):
    """(c): the MoE GPT, 2 + 8 steps on ``loss + 1e-2 * aux``."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.moe import SwitchMLP, collect_moe_aux
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel

    cfg = moe_config(torch, tensor_axis=None)
    model = GPTModel(cfg, device="cuda")
    model.load_params(init_gpt_params(cfg, 0, device="cuda"))
    opt = FusedAdam(model.parameters(), lr=1e-4)
    tokens = train_tokens(torch)
    n_params = sum(p.numel() for p in model.parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        ce = model(tokens, labels=tokens).mean()
        aux = collect_moe_aux(model)
        (ce + MOE_AUX_COEFF * aux).backward()
        opt.step()
        return (ce + MOE_AUX_COEFF * aux).detach(), aux.detach()

    dropped0 = moe_dropped(torch, model, tokens)
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    cc.zero_counts()
    out = [step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out += [step() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    n = WARMUP_STEPS + TIMED_STEPS
    counts = flash_counts(fa)
    check(counts == {k: 12 * n for k in counts}
          and flash_route_counts(fa)["simt"] == (0, 0, 0),
          f"moe: F1/F2/F3 launched 12 times a step, all on tc: {counts}")
    calls = dict(cc.CALLS)
    check(not any(calls.values()), f"moe: no collective: {calls}")
    losses = [float(x) for x, _ in out]
    auxes = [float(a) for _, a in out]
    check(all(x == x and abs(x) < 1e4 for x in losses)
          and losses[-1] < losses[0],
          f"moe: the losses are finite and fall: {losses}")
    per_layer = [float(m.last_aux.detach()) for m in model.modules()
                 if isinstance(m, SwitchMLP)]
    check(len(per_layer) == 12 and all(a >= 1.0 - 1e-5 for a in per_layer),
          f"moe: each layer's aux loss is at least 1 (the 12 summed: "
          f"{auxes}); last step's per layer {per_layer}")
    dropped = moe_dropped(torch, model, tokens)
    prof = profile_step(torch, "GPT-124M MoE step", step)
    einsum = moe_einsum_ms(torch, timer)
    rec = {"parameters": n_params, "step_ms": step_s * 1e3,
           "losses": losses, "aux": auxes, "aux_per_layer": per_layer,
           "dropped_first": dropped0,
           "dropped_last": dropped, "profile": prof,
           "dispatch_combine": dict(
               einsum, step_ms=einsum["ms"] * 12,
               busy_share=einsum["ms"] * 12 / max(prof["busy_ms"], 1e-9))}
    log(f"train[GPT-124M MoE, {MOE_EXPERTS} experts, capacity factor "
        f"{MOE_CAPACITY}, {n_params} parameters, batch {TRAIN_BATCH} x "
        f"{SEQ}, bf16 compute]: step {step_s * 1e3:.3f} ms = "
        f"{TRAIN_BATCH * SEQ / step_s:.1f} tokens/s; {json.dumps(rec)}; "
        f"launches {counts}")
    del model, opt
    return counts, rec


def moe_3d_step(torch, fa, cc):
    """(d): one ``build_gpt_3d`` step with the experts at pp = 1."""
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
    )

    init_fn, _, make_train_step = build_gpt_3d(
        moe_config(torch, expert_axis="dp"), num_chunks=PIPE_CHUNKS,
        num_microbatches=PIPE_MICROBATCHES)
    params, specs = init_fn(0)
    step = make_train_step(FusedAdam(tree_leaves(params), lr=1e-4), specs)
    tokens = train_tokens(torch)
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    cc.zero_counts()
    t0 = time.perf_counter()
    loss = float(step(params, tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = check_pipeline_launches(fa, pipeline_launches(1),
                                     "one MoE 3D step")
    calls = dict(cc.CALLS)
    check(loss == loss and abs(loss) < 1e4 and not any(calls.values()),
          f"moe 3D: the loss {loss} is finite, no collective ({calls})")
    rec = {"loss": loss, "first_step_ms": wall * 1e3}
    log(f"train[GPT-124M MoE through build_gpt_3d, pp 1, {PIPE_CHUNKS} "
        f"chunks, {PIPE_MICROBATCHES} microbatches]: {json.dumps(rec)}; "
        f"launches {counts}")
    return counts, rec


def context_moe_phase(torch, fa, flash_step):
    """Phase 13: context parallelism and MoE at world size 1 over NCCL;
    returns the phase's flash launches."""
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import collectives as cc
    from apex_tpu_torch.parallel import launch
    from apex_tpu_torch.transformer import context_parallel as cpl

    t0 = time.perf_counter()
    launch.initialize_distributed(f"127.0.0.1:{launch.free_port()}", 1, 0,
                                  backend="nccl")
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    try:
        check(dist.get_backend() == "nccl", "an NCCL process group")
        parallel.initialize_model_parallel(context_parallel_size=1)
        identities = check_cp_identities(torch, cc)
        tokens = train_tokens(torch)

        # (a) ring attention
        twin = serial_twin_loss(torch, cp_config(torch, "ring"), tokens)
        seen = {}
        origs = ring_spy(cpl, seen)
        try:
            losses, step_s, counts, step = cp_train(torch, fa, cc, "ring",
                                                    TIMED_STEPS)
        finally:
            for name, orig in origs.items():
                setattr(cpl, name, orig)
        add(counts)
        n = 12 * (WARMUP_STEPS + TIMED_STEPS)
        check(seen == {("flash_attention_with_lse", True): n,
                       ("dq_chunk", True): n, ("dkv_chunk", True): n},
              f"cp[ring]: every F1, F2 and F3 launch came through the ring's "
              f"calls, the diagonal chunk's (causal): {seen}")
        diff = losses[0] - twin
        rel = abs(diff) / abs(twin)
        check(rel <= CP_LOSS_TOL,
              f"cp[ring]: the first loss {losses[0]:.6f} within "
              f"{CP_LOSS_TOL} of the serial twin's {twin:.6f} (difference "
              f"{diff:+.3e}, relative {rel:.3e})")
        ring = {"step_ms": step_s * 1e3, "phase5_step_ms": flash_step * 1e3,
                "losses": losses, "twin_loss": twin, "first_loss_rel": rel,
                "ab": step_ab(torch, "cp ring", step, tokens),
                "profile": profile_step(torch, "GPT-124M cp ring step",
                                        step)}
        log(f"train[GPT-124M cp ring at cp 1, batch {TRAIN_BATCH} x {SEQ}]: "
            f"step {step_s * 1e3:.3f} ms; first loss {losses[0]:.6f} (serial "
            f"twin {twin:.6f}, difference {diff:+.3e}); losses {losses}; "
            f"launches {counts}")
        del step

        # (b) Ulysses with attention dropout
        seen = {}
        origs = seed_spy(fa, seen)
        try:
            gen = torch.Generator(device="cuda").manual_seed(11)
            u_losses, u_step, counts, step = cp_train(
                torch, fa, cc, "ulysses", ULYSSES_STEPS, generator=gen,
                attention_dropout=CP_DROPOUT)
        finally:
            for name, orig in origs.items():
                setattr(fa, name, orig)
        add(counts)
        n = 12 * (WARMUP_STEPS + ULYSSES_STEPS)
        check(seen == {("_fwd", True): n, ("_dq", True): n,
                       ("_dkv", True): n},
              f"cp[ulysses]: every F1, F2 and F3 call carried a dropout "
              f"seed: {seen}")
        u_rel = abs(u_losses[0] - losses[0]) / abs(losses[0])
        check(u_rel <= ULYSSES_LOSS_TOL,
              f"cp[ulysses]: the first loss {u_losses[0]:.6f} with dropout "
              f"{CP_DROPOUT} within {ULYSSES_LOSS_TOL} of the ring's "
              f"{losses[0]:.6f} (relative {u_rel:.3e})")
        ulysses = {"step_ms": u_step * 1e3, "losses": u_losses,
                   "first_loss_rel_to_ring": u_rel}
        log(f"train[GPT-124M cp Ulysses at cp 1, attention dropout "
            f"{CP_DROPOUT}]: {json.dumps(ulysses)}; launches {counts}")
        del step

        # (c) the MoE GPT, (d) the MoE 3D step
        counts, moe = moe_train(torch, fa, cc, Timer(torch))
        add(counts)
        counts, moe_3d = moe_3d_step(torch, fa, cc)
        add(counts)
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()
    log(json.dumps({"context_moe": {
        "identities": identities, "ring": ring, "ulysses": ulysses,
        "moe": moe, "moe_3d": moe_3d, "launches": launches}}))
    log(f"phase 13 (context parallelism and MoE at world size 1): "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------- phase 14: serving over a one-rank tp grid, the rest of the engine

TELEMETRY_ROUNDS = 2          # (off, on, on, off) blocks of waves
UNFUSED_LOGIT_TOL = 1e-4      # the CPU tests' fused-against-unfused limit
EXPORT_AFTER = 8              # tokens served before the export


class _NullMetric:
    def inc(self, n=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


class _TimedMetric:
    """A metric whose calls add their host seconds to ``spent[0]``."""

    def __init__(self, metric, spent):
        self.metric, self.spent = metric, spent

    def _call(self, name, v):
        t0 = time.perf_counter()
        getattr(self.metric, name)(v)
        self.spent[0] += time.perf_counter() - t0

    def inc(self, n=1.0):
        self._call("inc", n)

    def set(self, v):
        self._call("set", v)

    def observe(self, v):
        self._call("observe", v)


class TimedRegistry:
    """A metric registry that adds the host seconds of every call, its
    lookups included, to ``spent[0]``."""

    def __init__(self, inner, spent):
        self.inner, self.spent = inner, spent

    def _get(self, kind, name, **kw):
        t0 = time.perf_counter()
        metric = getattr(self.inner, kind)(name, **kw)
        self.spent[0] += time.perf_counter() - t0
        return _TimedMetric(metric, self.spent)

    def counter(self, name):
        return self._get("counter", name)

    def gauge(self, name):
        return self._get("gauge", name)

    def histogram(self, name, *, keep_samples=0):
        return self._get("histogram", name, keep_samples=keep_samples)


class NullRegistry:
    """A registry that records nothing: the baseline of the telemetry
    A/B (with no recorder armed, the engine's telemetry costs nothing
    more than these calls)."""

    _metric = _NullMetric()

    def counter(self, name):
        return self._metric

    def gauge(self, name):
        return self._metric

    def histogram(self, name, *, keep_samples=0):
        return self._metric


def tp_engine(torch, params, dtype=None, mesh=None, registry=None, **kw):
    """Phase 1's engine (GPT-124M, bf16 compute and cache unless ``dtype``
    says otherwise), over ``mesh`` when given."""
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.serving import ServingEngine

    dtype = dtype or torch.bfloat16
    kw.setdefault("cache_dtype", dtype)
    eng = ServingEngine(gpt124m(torch, dtype), serving_shape(torch, **kw),
                        params, mesh=mesh,
                        registry=registry if registry is not None
                        else MetricRegistry())
    serve(eng, [[7] * 64], 4, stagger=False)          # warm-up, not counted
    return eng


def tp_wave(torch, np, pa, fo, lo, eng, prompts, label, peak=False):
    """One wave of ``prompts`` (32 tokens each) on ``eng``: its requests,
    launch counts, calls, tokens/s and, with ``peak``, the pool's peak
    occupancy after any step."""
    base = calls_of(eng)
    tokens0 = eng.tokens_generated
    highest = [0.0]
    step = eng.step
    if peak:
        def watched():
            step()
            highest[0] = max(highest[0], eng.scheduler.kv_occupancy())
        eng.step = watched
    zero_counts(pa, fo, lo)
    try:
        reqs, wall = serve(eng, prompts, 32)
    finally:
        eng.step = step
    for req in reqs:
        check(req.state.value == "finished" and len(req.output_tokens) == 32,
              f"{label}: request {req.rid} finished with its 32 tokens")
    rec = {"calls": calls_of(eng, base), "counts": read_counts(pa, fo, lo),
           "tokens_per_s": (eng.tokens_generated - tokens0) / wall,
           "wall_ms": wall * 1e3}
    if peak:
        rec["peak_occupancy"] = highest[0]
    return reqs, rec


def tp_busy(torch, eng, prompts):
    """Device busy ms of one profiled wave, and its wall ms.  The card's
    activity only, summed over the raw events: recording every host op
    too, or ``key_averages()`` over a wave's tens of thousands of kernels,
    took 10-50 s."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = serve(eng, prompts, 32)
    busy_ns = sum(e.duration_ns()
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and not e.is_user_annotation())
    check(busy_ns > 0, "the profiled wave recorded device time")
    return busy_ns / 1e6, wall * 1e3


def first_step_logits(torch, model, prompts, **kw):
    """Prefill ``prompts`` (one per slot, up to a chunk each) and decode
    one token: the prefill logits at each last prompt position and the
    decode step's, fp32 (``kw``: the adapters and their slots).  Each
    slot owns the blocks of a chunk and one more, where the decoded
    token of a full chunk lands."""
    from apex_tpu_torch.serving import init_kv_arena

    dev, bs, T = model.device, model.cache.block_size, CHUNK
    nb = T // bs + 1        # the decoded token of a full chunk opens one
    S = len(prompts)
    check(S * nb <= model.cache.n_blocks and all(len(p) <= T for p in
                                                 prompts),
          f"first-step logits: {S} prompts of up to {T} tokens fit the cache")
    arenas = init_kv_arena(model.cache, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.long, device=dev)
    tables = torch.zeros((S, model.cache.max_blocks_per_request), **i32)
    tokens = torch.zeros((S, T), **i64)
    pos = torch.zeros((S, T), **i64)
    limits = torch.zeros((S, T), **i32)
    lengths = torch.zeros((S,), **i32)
    dest_b = torch.full((S, T), model.cache.n_blocks, **i64)
    dest_o = torch.zeros((S, T), **i64)
    last = torch.zeros((S,), **i64)
    for s, p in enumerate(prompts):
        n = len(p)
        tables[s, :nb] = torch.arange(s * nb, (s + 1) * nb, **i32)
        tokens[s, :n] = torch.tensor(p, **i64)
        pos[s, :n] = torch.arange(n, **i64)
        limits[s, :n] = torch.arange(1, n + 1, **i32)
        lengths[s] = n
        dest_b[s, :n] = torch.tensor([s * nb + t // bs for t in range(n)],
                                     **i64)
        dest_o[s, :n] = torch.arange(n, **i64) % bs
        last[s] = n - 1
    zeros = torch.zeros(S, device=dev), torch.zeros(S, **i64)
    policy = (zeros[0], zeros[1], torch.ones(S, device=dev), zeros[1],
              zeros[1])
    nxt, logits = model.prefill(arenas, tokens, pos, tables, lengths, limits,
                                dest_b, dest_o, last, *policy, **kw)
    pre = logits[torch.arange(S, device=dev), last].float()
    _, _, dec = model.decode_step(
        arenas, nxt[:, None], lengths.long(), tables,
        torch.ones(S, dtype=torch.bool, device=dev), *policy, **kw)
    return pre, dec[:, 0].float()


def unfused_logits_check(torch, params, prompts):
    """GPT-124M in fp32 (K1 and K2 on their simt routes) with and without
    ``fused_attention``: the first step's logits within the CPU tests'
    limit."""
    from apex_tpu_torch.serving import DecodeModel, KVCacheConfig

    cfg = gpt124m(torch, torch.float32)
    cache = KVCacheConfig(n_layers=12, n_blocks=3 * (CHUNK // BLOCK + 1),
                          block_size=BLOCK, kv_heads=N_HEADS,
                          head_dim=HEAD_DIM, max_seq=MAX_SEQ,
                          dtype=torch.float32)
    out = {}
    for fused in (True, False):
        model = DecodeModel(cfg, cache, fused_attention=fused)
        model.load_params(params)
        out[fused] = first_step_logits(torch, model, prompts)
        del model
    err = max(float((a - b).abs().max()) for a, b in zip(out[True],
                                                         out[False]))
    scale = float(out[True][0].abs().max())
    check(err <= UNFUSED_LOGIT_TOL,
          f"fused_attention=False: the first step's logits within "
          f"{UNFUSED_LOGIT_TOL} of K1/K2's in fp32 (largest difference "
          f"{err:.3e}, largest logit {scale:.3f})")
    return err


def export_check(torch, np, params, dtype, prompt, twin, label):
    """Serve ``prompt`` to EXPORT_AFTER tokens on one card engine, export
    it, import it into another and finish there; the stitched stream
    against ``twin`` (a request of the uninterrupted engine), the bytes
    and the ms of each side."""
    from types import SimpleNamespace

    src = tp_engine(torch, params, dtype=dtype)
    dst = tp_engine(torch, params, dtype=dtype)
    req = src.submit(prompt, 32)
    while len(req.output_tokens) < EXPORT_AFTER:
        src.step()
    head = list(req.output_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta, payloads = src.export_request(req)
    export_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    moved = dst.import_request(list(prompt) + head, 32 - len(head),
                               cache_len=meta["cache_len"], payloads=payloads)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    dst.run_until_drained()
    check(len(src.exports) == 1, f"{label}: the run pinned until the ack")
    src.release_export(req.rid, ok=True)
    check(len(src.exports) == 0, f"{label}: the pin released")
    for eng in (src, dst):
        eng.scheduler.allocator.check()
    stitched = SimpleNamespace(output_tokens=head + moved.output_tokens,
                               prompt=prompt)
    same = stitched.output_tokens == twin.output_tokens
    if dtype == torch.float32:
        check(same, f"{label}: the continued stream bit for bit the "
              f"uninterrupted twin's")
    else:
        compare_streams(torch, label, [stitched], [twin], src.model,
                        BF16_TIE)
    rec = {"bytes": meta["bytes"], "blocks": meta["n_blocks"],
           "cache_len": meta["cache_len"], "export_ms": export_ms,
           "import_ms": import_ms, "identical": same}
    log(f"{label}: {json.dumps(rec)}")
    return rec


def telemetry_ab(torch, np, pa, fo, lo, eng, prompts):
    """The wave's host time with the telemetry off (a registry that
    records nothing, no recorder) and on (the metric registry and an
    armed flight recorder), in alternating blocks; the armed waves'
    timeline event counts."""
    from apex_tpu_torch.observability import FlightRecorder, MetricRegistry
    from apex_tpu_torch.observability import timeline

    walls = {"off": [], "on": []}
    kinds, registry = {}, eng.registry
    for _ in range(TELEMETRY_ROUNDS):
        for mode in ("off", "on", "on", "off"):
            rec = None
            if mode == "on":
                registry = MetricRegistry()
                rec = timeline.arm(FlightRecorder(ring=1 << 16))
            eng.registry = registry if mode == "on" else NullRegistry()
            try:
                _, wave_rec = tp_wave(torch, np, pa, fo, lo, eng, prompts,
                                      f"telemetry {mode}")
            finally:
                timeline.disarm()
            walls[mode].append(wave_rec["wall_ms"])
            if rec is not None:
                kinds = {}
                for e in rec.events():
                    kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    # one more armed wave, the host time inside the telemetry's own calls
    # summed (an upper bound: the timing wrappers cost a little too)
    spent = [0.0]
    eng.registry = TimedRegistry(MetricRegistry(), spent)
    rec = timeline.arm(FlightRecorder(ring=1 << 16))
    emit = rec.emit

    def timed_emit(*args, **kw):
        t0 = time.perf_counter()
        out = emit(*args, **kw)
        spent[0] += time.perf_counter() - t0
        return out

    rec.emit = timed_emit
    try:
        _, wave_rec = tp_wave(torch, np, pa, fo, lo, eng, prompts,
                              "telemetry timed")
    finally:
        timeline.disarm()
    eng.registry = registry
    med = {m: statistics.median(w) for m, w in walls.items()}
    return {"wall_ms": walls, "median_ms": med,
            "ratio": med["on"] / med["off"], "events": kinds,
            "counters": registry.snapshot_typed()["counters"],
            "telemetry_ms": spent[0] * 1e3,
            "telemetry_share": spent[0] * 1e3 / wave_rec["wall_ms"],
            "timed_wall_ms": wave_rec["wall_ms"]}


def serving_tp_phase(torch, np, pa, fo, lo, params, prompts, plain):
    """Phase 14: the engine through a one-rank NCCL grid and the rest of
    its surface; returns the phase's K1, K2, K3 and L1 launches.
    ``plain`` is phase 3's bf16 wave of the engine without a mesh."""
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import collectives as cc
    from apex_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    L = 12
    out = {"seconds": {}}

    def mark(part):
        out["seconds"][part] = time.perf_counter() - t0

    launch.initialize_distributed(f"127.0.0.1:{launch.free_port()}", 1, 0,
                                  backend="nccl")
    try:
        check(dist.get_backend() == "nccl", "an NCCL process group")
        mesh = parallel.initialize_model_parallel(1, 1)

        # (a) the engine over the one-rank tp grid
        mark("grid")
        eng = tp_engine(torch, params, mesh=mesh)
        mark("a engine")
        check(eng.mesh is mesh and eng.tp == 1, "(a): an engine over tp 1")
        cc.zero_counts()
        reqs, a = tp_wave(torch, np, pa, fo, lo, eng, prompts, "(a)",
                          peak=True)
        check(all(v == 0 for v in cc.CALLS.values()),
              f"(a): no collective at tp 1 ({cc.CALLS})")
        check_path_counts(a["counts"], a["calls"], L, spec=False, lora=False)
        check_prefill_routes(pa, "tc", "(a) mesh engine")
        check([r.output_tokens for r in reqs]
              == [r.output_tokens for r in plain],
              "(a): the streams bit for bit the no-mesh engine's (phase 3)")
        add(a["counts"])
        snap = eng.introspect()
        check(isinstance(snap["mfu"], float) and 0.0 < snap["mfu"] < 1.0,
              f"(e): introspect's MFU a number on the card "
              f"({snap['mfu']}, {snap['mfu_reason']})")
        a["mfu"] = snap["mfu"]
        a["last_decode_ms"] = snap["last_decode_ms"]
        mark("a wave")
        a["busy_ms"], a["profiled_wall_ms"] = tp_busy(torch, eng, prompts)
        log(f"serving_tp (a) mesh tp 1: {json.dumps(a)}")
        out["a"] = a
        mark("a")

        # (b) fused_attention=False: the reference's vs_unfused A/B
        ueng = tp_engine(torch, params, fused_attention=False)
        ureqs, b = tp_wave(torch, np, pa, fo, lo, ueng, prompts, "(b)")
        prefill, decode = b["calls"]
        want = dict.fromkeys(b["counts"], 0)
        want["fused_residual_norm"] = L * (prefill + decode)
        check(b["counts"] == want,
              f"(b): no K1 or K2 launch, K3 {L} a call: {b['counts']}")
        add(b["counts"])
        compare_streams(torch, "(b) fused_attention=False vs (a)", ureqs,
                        reqs, eng.model, BF16_TIE)
        mark("b wave")
        b["busy_ms"], b["profiled_wall_ms"] = tp_busy(torch, ueng, prompts)
        del ueng
        mark("b profile")
        b["fp32_first_step_logit_err"] = unfused_logits_check(
            torch, params, [prompts[1][:64], prompts[2][:CHUNK],
                            prompts[3][:CHUNK]])
        log(f"serving_tp (b) fused_attention=False: {json.dumps(b)}")
        out["b"] = b
        mark("b")

        # (c) worst-case reservation
        reng = tp_engine(torch, params, admission="reserve")
        rreqs, c = tp_wave(torch, np, pa, fo, lo, reng, prompts, "(c)",
                           peak=True)
        check_path_counts(c["counts"], c["calls"], L, spec=False, lora=False)
        add(c["counts"])
        check([r.output_tokens for r in rreqs]
              == [r.output_tokens for r in reqs],
              "(c): the reserve streams bit for bit (a)'s")
        check(reng.scheduler.preemptions == 0
              and reng.scheduler.prefix_cache is None,
              "(c): no preemption, no prefix cache")
        del reng
        log(f"serving_tp (c) admission=reserve: {json.dumps(c)}")
        out["c"] = c
        mark("c")

        # (d) KV export and import between two card engines
        zero_counts(pa, fo, lo)
        out["d"] = {"bf16": export_check(
            torch, np, params, torch.bfloat16, prompts[2], reqs[2],
            "(d) export/import, bf16")}
        twin = tp_engine(torch, params, dtype=torch.float32)
        (twin_req,), _ = serve(twin, [prompts[2]], 32, stagger=False)
        del twin
        out["d"]["fp32"] = export_check(
            torch, np, params, torch.float32, prompts[2], twin_req,
            "(d) export/import, fp32")
        add(read_counts(pa, fo, lo))
        mark("d")

        # (e) the telemetry's cost and the timeline of a wave
        zero_counts(pa, fo, lo)
        e = telemetry_ab(torch, np, pa, fo, lo, eng, prompts)
        add(read_counts(pa, fo, lo))
        check(e["events"].get("request_finish") == len(prompts)
              and e["events"].get("request_submit") == len(prompts),
              f"(e): the armed wave's lifecycle events {e['events']}")
        check(e["counters"]["serving/tokens_generated"] == 32 * len(prompts),
              "(e): the registry counted the wave's tokens")
        e["mfu"] = eng.introspect()["mfu"]
        log(f"serving_tp (e) telemetry: {json.dumps(e)}")
        out["e"] = e
        mark("e")
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()
    out["launches"] = launches
    log(json.dumps({"serving_tp": out}))
    log(f"phase 14 (serving over a one-rank tp grid, the rest of the "
        f"engine): {time.perf_counter() - t0:.1f} s")
    return launches



# --------------------------------------------- phase 15: the serving fleet

FLEET_SEED = 0
FLEET_NEW = 32              # tokens per request, as phase 3's wave
FLEET_KILL_AT = 3           # relayed tokens before the SIGKILL
FLEET_READY_S = 300.0       # a replica's start: torch, CUDA, the library
FLEET_WAVE_S = 300.0        # the longest a fleet wave may take
FLEET_SILENT_S = 30.0       # a socket replica's longest silence


def fleet_replica_target(spec, name, addr_q, counts_path):
    """Spawn target of phase 15's socket replicas: the port's
    ``replica_serve`` in this child, the launch counts set to 0 once the
    replica has warmed up; once its server stops, the child's counts
    (``read_counts``, K2's tc launches) and its engine's prefill and
    decode calls since then written to ``counts_path``."""
    from apex_tpu_torch.serving import fused_ops as fo
    from apex_tpu_torch.serving import lora as lo
    from apex_tpu_torch.serving import paged_attention as pa
    from apex_tpu_torch.serving import transport

    warm = {}

    def on_ready(engine):
        warm["engine"], warm["base"] = engine, calls_of(engine)
        zero_counts(pa, fo, lo)

    try:
        transport.replica_serve(spec, name, ready_hook=addr_q.put,
                                on_ready=on_ready)
    finally:
        if warm:
            with open(counts_path, "w") as f:
                json.dump({"counts": read_counts(pa, fo, lo),
                           "prefill_tc": pa.PREFILL_TC_LAUNCHES,
                           "calls": calls_of(warm["engine"], warm["base"])},
                          f)


def fleet_spec(torch, dtype, **kw):
    """GPT-124M at full width from ``init_fn(FLEET_SEED)``, phase 3's
    serving shape; a bf16 model keeps a bf16 cache, an fp32 one fp32."""
    from apex_tpu_torch.serving import ReplicaSpec

    return ReplicaSpec(config=gpt124m(torch, dtype),
                       serving=serving_shape(torch, cache_dtype=dtype),
                       seed=FLEET_SEED, **kw)


def fleet_reference(torch, spec, prompts):
    """The wave through one in-process engine on the replicas' weights
    (``_build_engine`` of the spec, here): its requests, tokens/s and
    model."""
    from apex_tpu_torch.observability.metrics import MetricRegistry
    from apex_tpu_torch.serving.replica import _build_engine

    eng, _ = _build_engine(spec, MetricRegistry(rank=0, world=1), None)
    serve(eng, [prompts[1][:64]], 4, stagger=False)      # warm-up
    reqs, wall = serve(eng, prompts, FLEET_NEW)
    tokens = sum(len(r.output_tokens) for r in reqs)
    return reqs, tokens / wall, eng.model


class FleetLog:
    """Every event the router polls, per replica (a client's ``poll``
    wrapped), so the phase can read what crossed the wire."""

    def __init__(self):
        self.events = []

    def tee(self, client):
        poll = client.poll

        def tee():
            evs = poll()
            self.events.extend((client.name, ev) for ev in evs)
            return evs
        client.poll = tee
        return client

    def kinds(self, kind, name=None):
        return [ev for n, ev in self.events
                if ev[0] == kind and (name is None or n == name)]


def fleet_wave(router, prompts, *, during=None):
    """Phase 3's stagger over the router: 4 requests up front, then one
    every 20 ms; ``during(reqs)`` runs each pump; pump to idle.  Returns
    the requests and the wall time."""
    reqs, pending = [], list(prompts)
    t0 = time.perf_counter()
    next_at = t0
    while pending or not router.idle():
        now = time.perf_counter()
        if pending and now >= next_at:
            for _ in range(4 if not reqs else 1):
                if pending:
                    reqs.append(router.submit(pending.pop(0), FLEET_NEW))
            next_at = now + 0.02
        router.pump()
        if during is not None:
            during(reqs)
        check(time.perf_counter() - t0 < FLEET_WAVE_S,
              "the fleet wave drains")
        time.sleep(0.0005)
    return reqs, time.perf_counter() - t0


def fleet_streams(torch, label, got, want, model, bound):
    """Every request finished with its 32 tokens; the streams equal the
    in-process engine's, bit for bit (``bound`` 0) or up to near ties."""
    for r in got:
        check(r.state.value == "finished" and len(r.output_tokens)
              == FLEET_NEW, f"{label}: request {r.rid} finished with its "
              f"{FLEET_NEW} tokens")
    if bound == 0:
        same = sum(g.output_tokens == w.output_tokens
                   for g, w in zip(got, want))
        check(same == len(want), f"{label}: {same} of {len(want)} streams "
              f"bit for bit the in-process engine's")
        log(f"{label}: all {len(want)} streams bit for bit the in-process "
            f"engine's")
    else:
        compare_streams(torch, label, got, want, model, bound)


def fleet_latency(router):
    snap = router.registry.snapshot()
    parts = []
    for name in ("fleet/ttft_ms", "fleet/tpot_ms"):
        h = snap.get(name) or {}
        parts.append(f"{name.split('/')[1]} p50 {h.get('p50')} p99 "
                     f"{h.get('p99')}")
    return "; ".join(parts)


def fleet_ready(clients, t_start):
    """Wait for each client's handshake; print each replica's ready
    time since ``t_start`` (its spawn)."""
    out = {}
    for c in clients:
        c.wait_ready(timeout=FLEET_READY_S)
        out[c.name] = round(time.perf_counter() - t_start[c.name], 3)
    return out


def start_counted(torch, spec, name, counts_path):
    """One socket replica through ``fleet_replica_target``; returns the
    process and its listening address."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    addr_q = ctx.Queue()
    proc = ctx.Process(target=fleet_replica_target,
                       args=(spec, name, addr_q, counts_path),
                       daemon=False, name=f"fleet-{name}")
    proc.start()
    deadline = time.monotonic() + FLEET_READY_S
    while True:
        try:
            host, port = addr_q.get(timeout=0.5)
            return proc, (host, int(port))
        except queue.Empty:
            check(proc.is_alive(), f"replica {name} is alive before binding")
            check(time.monotonic() < deadline, f"replica {name} binds")


def child_metric(port, name):
    """A histogram's mean from a replica's ``/metrics`` (its debug
    server)."""
    import urllib.request

    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()
    flat = "apex_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    vals = {}
    for line in body.splitlines():
        for key in ("_sum", "_count"):
            if line.startswith(flat + key + "{"):
                vals[key] = float(line.rsplit(" ", 1)[1])
    return vals["_sum"] / vals["_count"] if vals.get("_count") else None


def fleet_queue_part(torch, np, prompts, trace_dir, ref32):
    """(a) two ``ReplicaProcess`` replicas (fp32, traced) behind a
    ``FleetRouter`` serve the wave; (b) one is SIGKILLed after its third
    relayed token and the survivor replays; the autopilot respawns it;
    (e) one is drained by SIGTERM mid-wave; the spills merge into one
    attributed trace per request."""
    from apex_tpu_torch.data._producer import reap_process
    from apex_tpu_torch.observability import trace as tr
    from apex_tpu_torch.observability.metrics import MetricRegistry
    from apex_tpu_torch.observability import timeline
    from apex_tpu_torch.serving import (
        AutopilotConfig,
        FleetAutopilot,
        FleetRouter,
        ReplicaProcess,
    )
    from apex_tpu_torch.testing.faults import simulate_sigterm

    spec = fleet_spec(torch, torch.float32, timeline_dir=trace_dir,
                      timeline_tick_every=1)
    ref_reqs, ref_tps, ref_model = ref32
    t_start, procs, spawned = {}, {}, []
    for name in ("q0", "q1"):
        t_start[name] = time.perf_counter()
        procs[name] = ReplicaProcess(spec, name)
        spawned.append(procs[name])
    ready = fleet_ready(procs.values(), t_start)
    flog = FleetLog()
    for p in procs.values():
        flog.tee(p)
    tr.arm_process(trace_dir, "router", "router")
    # 12 in flight a replica: 8 running and 4 queued in its engine, what
    # a drain gives back
    router = FleetRouter(list(procs.values()),
                         registry=MetricRegistry(rank=0, world=1),
                         heartbeat_timeout_s=30.0, replica_queue_limit=12)
    try:
        reqs, wall = fleet_wave(router, prompts)
        fleet_streams(torch, "fleet (a) [2 queue replicas, fp32]", reqs,
                      ref_reqs, ref_model, 0)
        took = {r.replica for r in reqs}
        check(took == {"q0", "q1"}, f"both replicas took work ({took})")
        tokens = sum(len(r.output_tokens) for r in reqs)
        log(f"fleet (a): ready s {ready}; {len(reqs)} requests, {tokens} "
            f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s (one "
            f"in-process engine {ref_tps:.1f}); {fleet_latency(router)}; "
            f"per replica {sorted((n, sum(r.replica == n for r in reqs)) for n in took)}")

        # (b) SIGKILL the replica holding the first request at its 3rd token
        killed = {}

        def kill_at_k(live):
            if killed or not live or len(live[0].output_tokens) < FLEET_KILL_AT:
                return
            victim = procs[live[0].replica]
            victim.kill()
            killed.update(name=victim.name, t=time.monotonic(),
                          held=sum(r.replica == victim.name and not r.done
                                   for r in live))
        before = router.registry.snapshot()
        reqs, wall = fleet_wave(router, prompts[:8], during=kill_at_k)
        check(bool(killed), "a replica was killed mid-wave")
        fleet_streams(torch, "fleet (b) [failover, fp32]", reqs,
                      ref_reqs[:8], ref_model, 0)
        replayed = [r for r in reqs if r.replays]
        check(replayed and all(r.replica != killed["name"] for r in replayed),
              "the killed replica's requests replayed on the survivor")
        check(router._views[killed["name"]].down, "the killed replica is down")
        last = max(r.t_last_token for r in replayed)
        snap = router.registry.snapshot()
        log(f"fleet (b): killed {killed['name']} holding {killed['held']} "
            f"requests after {FLEET_KILL_AT} relayed tokens; "
            f"{len(replayed)} replayed; kill to last replayed token "
            f"{(last - killed['t']) * 1e3:.1f} ms; failovers "
            f"{snap['fleet/failovers'] - before.get('fleet/failovers', 0)}")

        # the autopilot repairs the min pool: one respawn
        def spawn(name):
            t_start[name] = time.perf_counter()
            procs[name] = flog.tee(ReplicaProcess(spec, name))
            spawned.append(procs[name])
            return procs[name]
        ap = FleetAutopilot(router, spawn=spawn,
                            config=AutopilotConfig(min_replicas=2))
        t0 = time.perf_counter()
        while not any(d.get("verdict") == "joined" for d in ap.decisions):
            router.pump()
            ap.tick()
            check(time.perf_counter() - t0 < FLEET_READY_S,
                  "the autopilot's respawn joins")
            time.sleep(0.01)
        snap = router.registry.snapshot()
        check(snap.get("fleet/autopilot/respawns") == 1,
              "the autopilot respawned one replica")
        log(f"fleet (e) autopilot: respawned {killed['name']}, joined in "
            f"{time.perf_counter() - t0:.3f} s")

        # (e) SIGTERM one replica mid-wave: it drains and exits 0
        drained = {}

        def sigterm(live):
            busy = [r.replica for r in live if r.replica and not r.done]
            if drained or not busy or sum(
                    len(r.output_tokens) for r in live) < B:
                return
            simulate_sigterm(procs[busy[-1]].pid)
            drained["name"] = busy[-1]
        before = router.registry.snapshot()
        n_events = len(flog.events)
        reqs, wall = fleet_wave(router, prompts, during=sigterm)
        check(bool(drained), "a replica was sent SIGTERM mid-wave")
        fleet_streams(torch, "fleet (e) [SIGTERM drain, fp32]", reqs,
                      ref_reqs, ref_model, 0)
        gone = procs[drained["name"]]
        gone._proc.join(60)
        check(gone.exitcode == 0, f"the drained replica exited 0 "
              f"({gone.exitcode})")
        check(flog.kinds("drained", drained["name"]), "it sent drained")
        snap = router.registry.snapshot()
        # what the draining replica gave back: its queue, cancelled, and
        # what reached it after the drain began, refused
        back = [ev for n, ev in flog.events[n_events:]
                if n == drained["name"] and ev[0] in ("cancelled", "rejected")]
        resched = (snap.get("fleet/reschedules", 0)
                   - before.get("fleet/reschedules", 0))
        check(resched == len(back) and snap.get("fleet/failovers", 0)
              == before.get("fleet/failovers", 0),
              f"the router requeued only what the drain gave back "
              f"({resched} reschedules, {len(back)} cancelled or refused)")
        log(f"fleet (e): SIGTERM to {drained['name']} mid-wave; drained, "
            f"exit 0; {len(back)} queued requests given back and requeued")
    finally:
        router.close()
        timeline.disarm()
        for p in spawned:
            reap_process(p._proc, 30, "replica")
    merged = tr.merge_dir(trace_dir)
    traces = merged["traces"]
    n_submitted = len(router.requests)
    check(len(traces) == n_submitted, f"one trace per request "
          f"({len(traces)} of {n_submitted})")
    for tid, rec in traces.items():
        check(rec["state"] == "finished" and rec["unattributed_s"] == 0.0
              and rec["overcommit_s"] == 0.0,
              f"trace {tid} fully attributed ({rec['state']}, "
              f"unattributed {rec['unattributed_s']}, overcommit "
              f"{rec['overcommit_s']})")
    summary = tr.summarize_traces(traces)
    log(f"fleet (e) traces: {len(traces)} requests, states "
        f"{summary['states']}; hop seconds {json.dumps(summary['hop_totals_s'])}")


def fleet_socket_part(torch, np, prompts, dtype, ref, counted, per_round):
    """(c)/(d) a prefill and a decode replica over ``SocketTransport``:
    every request migrates its KV and the decode replica continues its
    stream.  ``counted``: through ``fleet_replica_target`` with the
    prefill replica behind a ``ChaosProxy`` that drops the link once
    (a reconnect, no failover), the children's launch counts returned.
    ``per_round``: requests a wave, each wave pumped to idle."""
    from apex_tpu_torch.data._producer import reap_process
    from apex_tpu_torch.observability.metrics import MetricRegistry
    from apex_tpu_torch.serving import (
        FleetRouter,
        SocketTransport,
        start_replica_server,
    )
    from apex_tpu_torch.testing.faults import ChaosProxy

    label = "bf16" if dtype == torch.bfloat16 else "fp32"
    ref_reqs, _, ref_model = ref
    t_start, procs, addrs, paths = {}, {}, {}, {}
    for role in ("prefill", "decode"):
        spec = fleet_spec(torch, dtype, role=role)
        t_start[role] = time.perf_counter()
        if counted:
            paths[role] = f"build/fleet_counts.{role}.json"
            procs[role], addrs[role] = start_counted(torch, spec, role,
                                                     paths[role])
        else:
            procs[role], addrs[role] = start_replica_server(spec, role)
    proxy = ChaosProxy(addrs["prefill"]) if counted else None
    if proxy is not None:
        addrs["prefill"] = proxy.address
    flog = FleetLog()
    clients = [flog.tee(SocketTransport(r, addrs[r], backoff_initial_s=0.01,
                                        ping_every_s=0.05))
               for r in ("prefill", "decode")]
    ready = fleet_ready(clients, t_start)
    # every request first lands on the prefill replica (the router sends
    # one to a decode replica only when no prefill replica has room, or
    # when the prefill replica's link is demoted as slow: its pongs wait
    # behind the KV it is exporting, 13-29 MB a request, which took them
    # past the default 1 s and sent requests to the decode replica
    # unmigrated, so the demotion threshold is the heartbeat timeout)
    router = FleetRouter(clients, registry=MetricRegistry(rank=0, world=1),
                         heartbeat_timeout_s=FLEET_SILENT_S,
                         link_degraded_rtt_s=FLEET_SILENT_S,
                         replica_queue_limit=B)
    dropped = []

    def drop_once(live):
        if proxy is not None and not dropped and sum(
                len(r.output_tokens) for r in live) >= 2 * B:
            proxy.drop_connections()
            dropped.append(time.monotonic())
    try:
        # rounds of at most B requests: the decode replica has B slots,
        # and the router refuses an import with no slot free (it
        # degrades to a re-prefill on the prefill replica)
        reqs, wall = [], 0.0
        for i in range(0, len(prompts), per_round):
            got, dt = fleet_wave(router, prompts[i:i + per_round],
                                 during=drop_once)
            reqs += got
            wall += dt
        fleet_streams(torch, f"fleet (d) [prefill/decode over the socket, "
                      f"{label}]", reqs, ref_reqs, ref_model,
                      BF16_TIE if dtype == torch.bfloat16 else 0)
        snap = router.registry.snapshot()
        n = len(reqs)
        metas = flog.kinds("kv_meta")
        check(all(m[2]["slab_dtypes"] == [DTYPES[label]] * 2 for m in metas),
              "the KV slabs' dtypes ride kv_meta")
        slabs = [a for ev in flog.kinds("kv_block") for a in ev[3]]
        wire = "uint16" if dtype == torch.bfloat16 else "float32"
        check(slabs and all(a.dtype == np.dtype(wire) for a in slabs),
              f"the {label} slabs cross as {wire} numpy arrays")
        mig = snap.get("fleet/kv_migrate_ms") or {}
        blocks = snap["fleet/kv_migrate_blocks"] / n
        n_bytes = snap["fleet/kv_migrate_bytes"] / n
        ports = {c.name: (c.meta or {}).get("debug_port") for c in clients}
        export_ms = child_metric(ports["prefill"], "serving/kv_export_ms")
        import_ms = child_metric(ports["decode"], "serving/kv_import_ms")
        tokens = sum(len(r.output_tokens) for r in reqs)
        backlog = {c.name: round(c.send_backlog_max_s, 3) for c in clients}
        # the race a migration runs: the source decodes on until the
        # router's export_kv lands, so n_out is how near it came to
        # finishing in place
        n_out = {m[1]: m[2]["n_out"] for m in metas}
        left = sorted(FLEET_NEW - v for v in n_out.values())
        unmigrated = sorted(r.rid for r in reqs if r.rid not in n_out)
        if proxy is not None:
            check(bool(dropped) and snap.get("fleet/reconnects", 0) >= 1
                  and not snap.get("fleet/failovers"),
                  f"the dropped link cost a reconnect "
                  f"({snap.get('fleet/reconnects')}) and no failover")
        log(f"fleet (d) [{label}]: ready s {ready}; {n} requests, {tokens} "
            f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
            f"{fleet_latency(router)}; per migration {blocks:.1f} blocks, "
            f"{n_bytes / 1e6:.3f} MB, {mig.get('mean'):.3f} ms mean (p50 "
            f"{mig.get('p50')}, p99 {mig.get('p99')}) from the router's "
            f"migrate start to its commit; engine-side export "
            f"{export_ms:.3f} ms and import {import_ms:.3f} ms (means); "
            f"reconnects {snap.get('fleet/reconnects', 0)}; tokens left "
            f"to decode at export {left[:4]} (fewest first), never "
            f"exported {unmigrated}, failed "
            f"{snap.get('fleet/kv_migrate_failed', 0)}; longest send "
            f"backlog {backlog} s of the {clients[0].send_timeout_s} s "
            f"send timeout")
        check(snap.get("fleet/kv_migrate_completed") == n
              and not snap.get("fleet/kv_migrate_failed"),
              f"every request migrated its KV ({snap.get('fleet/kv_migrate_completed')} of {n})")
        check(all(r.replica == "decode" for r in reqs),
              "the decode replica finished every stream")
    finally:
        router.close()
        if proxy is not None:
            proxy.close()
        for p in procs.values():
            reap_process(p, 30, "replica")
    if not counted:
        return None
    counts = {}
    for role, path in paths.items():
        with open(path) as f:
            counts[role] = json.load(f)
    return counts


def fleet_phase(torch, np, prompts):
    """Phase 15: the serving fleet at GPT-124M width, replicas as spawned
    processes sharing the card; returns the children's K1-K3 launches."""
    import os
    import shutil

    trace_dir = "build/fleet_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    t0 = time.perf_counter()
    refs = {dtype: fleet_reference(torch, fleet_spec(torch, dtype), prompts)
            for dtype in (torch.float32, torch.bfloat16)}
    fleet_queue_part(torch, np, prompts, trace_dir, refs[torch.float32])
    counts = fleet_socket_part(torch, np, prompts, torch.bfloat16,
                               refs[torch.bfloat16], counted=True,
                               per_round=B)
    # fp32 one request at a time: its 23-29 MB a request on the source's
    # ordered event stream put a later request's tokens behind the
    # earlier exports for up to the whole of its decode, and 1-2 of 8
    # finished in place (the router's fallback), not migrated
    fleet_socket_part(torch, np, prompts[:8], torch.float32,
                      (refs[torch.float32][0][:8],) + refs[torch.float32][1:],
                      counted=False, per_round=1)
    total = {}
    layers = gpt124m(torch, torch.bfloat16).num_layers
    for role, c in counts.items():
        got, calls = c["counts"], c["calls"]
        check_path_counts(got, calls, layers, spec=False, lora=False)
        check(got["paged_prefill_attention"] > 0
              and c["prefill_tc"] == got["paged_prefill_attention"],
              f"replica {role}: every bf16 K2 launch on tc ({c})")
        log(f"fleet (c) replica {role}, after its warm-up: K1 "
            f"{got['paged_attention_decode']} on split for {calls[1]} decode "
            f"calls, K2 {got['paged_prefill_attention']} on tc for "
            f"{calls[0]} prefill calls, K3 {got['fused_residual_norm']}")
        for key, n in got.items():
            total[key] = total.get(key, 0) + n
    log(f"fleet phase: {time.perf_counter() - t0:.1f} s")
    return total


# the checkpoint phase (16): crash/resume children, the serving restores
CKPT_STEPS, CKPT_SAVE_EVERY, CKPT_KILL_AFTER = 6, 2, 4
CKPT_FREE_GB = 16.0        # two keep=2 runs of a 1.49 GB state, and more
CKPT_CHILD_S = 600.0       # the longest a crash/resume child may take
# F1-F3 launches a step of the crash/resume trainer: pp = 1, 12 chunks,
# 2 microbatches, each tick's stage recomputed in the backward
CKPT_FLASH_PER_STEP = {"flash_fwd": 2 * 12 * 2, "flash_dq": 12 * 2,
                       "flash_dkv": 12 * 2}


def ckpt_child(root, name, ckpt_dir, *extra):
    """One ``testing/crash_resume.py`` child (GPT-124M on the card), its
    output in ``<root>/<name>.log``; returns the process."""
    import os

    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    out = open(os.path.join(root, f"{name}.log"), "wb")
    args = [sys.executable, "-m", "apex_tpu_torch.testing.crash_resume",
            "--config", "gpt124m", "--device", "cuda",
            "--steps", str(CKPT_STEPS), "--save-every", str(CKPT_SAVE_EVERY),
            "--keep", "2", "--ckpt-dir", ckpt_dir,
            "--losses", os.path.join(root, f"{name}.losses"), *extra]
    proc = subprocess.Popen(args, env=env, stdout=out,
                            stderr=subprocess.STDOUT, cwd=here)
    out.close()
    proc.log_path = os.path.join(root, f"{name}.log")
    return proc


def ckpt_wait(proc, what, rc=0):
    """Wait for a child; check its exit code; its summary line (or None)."""
    try:
        got = proc.wait(timeout=CKPT_CHILD_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        got = None
    with open(proc.log_path) as f:
        text = f.read()
    check(got == rc, f"{what}: exit code {got}, want {rc}; its output's "
          f"tail:\n{text[-3000:]}")
    summary = None
    for line in text.splitlines():
        if line.startswith('{"crash_resume"'):
            summary = json.loads(line)["crash_resume"]
    return summary, text


def ckpt_lines(path):
    with open(path) as f:
        return f.read().splitlines()


def ckpt_bytes(mgr, step):
    """The bytes of one step's stored arrays (its manifest's leaves)."""
    import numpy as np

    dt = {"float32": 4, "int32": 4, "bool": 1, "bfloat16": 2, "int64": 8}
    return sum(int(np.prod(rec["shape"])) * dt[rec["dtype"]]
               for rec in mgr._manifest(step)["leaves"])


def crash_resume_part(torch, root, card):
    """(a) and (b): the trainer's runs as children, in two rounds of
    processes side by side on the card: an uninterrupted run, a run
    SIGKILLed after step 4's commit and one preempted by SIGTERM; then
    the killed run's resume, and a resume of the uninterrupted run's
    directory past its step 6 corrupted.  Returns the uninterrupted
    run's F1-F3 launches, the directories and the record."""
    import os
    import shutil
    import signal

    from apex_tpu_torch.resilience import CheckpointManager
    from apex_tpu_torch.testing import faults

    dirs = {n: os.path.join(root, n) for n in ("uninterrupted", "killed",
                                               "sigterm")}
    t0 = time.perf_counter()
    full = ckpt_child(root, "uninterrupted", dirs["uninterrupted"],
                      "--fingerprint", os.path.join(root, "full.fp"))
    killed = ckpt_child(root, "killed", dirs["killed"],
                        "--step-delay", "0.5")
    term = ckpt_child(root, "sigterm", dirs["sigterm"], "--step-delay",
                      "0.5", "--save-every", str(2 * CKPT_STEPS))
    term_losses = os.path.join(root, "sigterm.losses")
    commit = os.path.join(dirs["killed"], f"step_{CKPT_KILL_AFTER:08d}",
                          "manifest.json")
    t_kill = t_term = None
    while t_kill is None or t_term is None:
        check(time.perf_counter() - t0 < CKPT_CHILD_S,
              f"step {CKPT_KILL_AFTER} of the run to kill commits and the "
              f"run to preempt logs its third step")
        if t_kill is None and os.path.exists(commit):
            killed.send_signal(signal.SIGKILL)
            t_kill = time.perf_counter() - t0
        if t_term is None and os.path.exists(term_losses) \
                and len(ckpt_lines(term_losses)) >= 3:
            faults.simulate_sigterm(term.pid)
            t_term = time.perf_counter() - t0
        for proc, what in ((killed, "kill"), (term, "preempt")):
            check(proc.poll() is None or (proc is killed and t_kill)
                  or (proc is term and t_term),
                  f"the run to {what} exited early ({proc.returncode}): "
                  f"{open(proc.log_path).read()[-2000:]}")
        time.sleep(0.01)
    killed.wait()
    check(killed.returncode == -signal.SIGKILL, "the run was SIGKILLed")
    summary, _ = ckpt_wait(full, "the uninterrupted run")
    _, term_text = ckpt_wait(term, "the SIGTERMed run (exit 0)")
    want = ckpt_lines(os.path.join(root, "uninterrupted.losses"))
    check([ln.split()[0] for ln in want]
          == [str(i) for i in range(1, CKPT_STEPS + 1)],
          f"the uninterrupted run logged steps 1-{CKPT_STEPS}")
    for name in ("killed", "sigterm"):
        got = ckpt_lines(os.path.join(root, f"{name}.losses"))
        check(got == want[:len(got)],
              f"the {name} run's {len(got)} losses are the uninterrupted "
              f"run's bit for bit (runs of the same steps agree)")
    launches = {}
    for name, per in CKPT_FLASH_PER_STEP.items():
        tc, simt = summary["launches"][name]
        check(tc == per * CKPT_STEPS and simt == 0,
              f"{name}: {per} a step on tc over {CKPT_STEPS} steps "
              f"(tc {tc}, simt {simt})")
        launches[name] = tc
    stopped = int(ckpt_lines(term_losses)[-1].split()[0])
    tmgr = CheckpointManager(dirs["sigterm"], sharded=True)
    committed = [s for s in tmgr.all_steps() if tmgr._is_committed(s)]
    check(committed == [stopped] and stopped < CKPT_STEPS,
          f"SIGTERM at step {stopped}: exit 0 with that step committed "
          f"({committed}; {term_text.strip().splitlines()[-1]})")
    tmgr.verify(stopped)
    t_first = time.perf_counter() - t0

    # the resume, past any save the kill cut short (an uncommitted step),
    # and beside it a resume of the uninterrupted run's directory with
    # its newest step corrupted
    t1 = time.perf_counter()
    kmgr = CheckpointManager(dirs["killed"], sharded=True)
    artifacts = [s for s in kmgr.all_steps()
                 if s > CKPT_KILL_AFTER and not kmgr._is_committed(s)]
    resumed = ckpt_child(root, "killed", dirs["killed"], "--resume",
                         "--fingerprint", os.path.join(root, "resumed.fp"))
    umgr = CheckpointManager(dirs["uninterrupted"], sharded=True)
    newest = umgr.all_steps()[-1]
    faults.corrupt_checkpoint(umgr.step_path(newest))
    shutil.copy(os.path.join(root, "uninterrupted.losses"),
                os.path.join(root, "fallback.losses"))
    again = ckpt_child(root, "fallback", dirs["uninterrupted"], "--resume",
                       "--fingerprint", os.path.join(root, "fallback.fp"))
    summary_r, _ = ckpt_wait(resumed, "the resumed run")
    summary_f, _ = ckpt_wait(again, "the resume past a corrupt step")
    check(summary_r["start"] == CKPT_KILL_AFTER + 1
          and summary_r["fallback_depth"] == len(artifacts),
          f"the resume went on from step {CKPT_KILL_AFTER}, past the "
          f"uncommitted steps {artifacts} ({summary_r})")
    check(ckpt_lines(os.path.join(root, "killed.losses")) == want,
          "the resumed loss curve is the uninterrupted one bit for bit")
    check(ckpt_lines(os.path.join(root, "resumed.fp"))
          == ckpt_lines(os.path.join(root, "full.fp")),
          "the resumed final checkpoint's fingerprint is the "
          "uninterrupted one's")
    check(summary_f["fallback_depth"] == 1
          and summary_f["start"] == newest - CKPT_SAVE_EVERY + 1,
          f"the resume fell back one step past corrupt step {newest} "
          f"({summary_f})")
    check(ckpt_lines(os.path.join(root, "fallback.losses")) == want
          and ckpt_lines(os.path.join(root, "fallback.fp"))
          == ckpt_lines(os.path.join(root, "full.fp")),
          "after the fallback the losses and the final fingerprint are the "
          "uninterrupted run's bit for bit")
    t_second = time.perf_counter() - t1
    rec = {"kill_after_s": t_kill, "uncommitted_at_kill": artifacts,
           "first_round_s": t_first, "second_round_s": t_second,
           "sigterm_at_step": stopped, "fallback_depth": 1,
           "losses": want}
    log(f"checkpoint (a) crash/resume [GPT-124M, {CKPT_STEPS} steps, "
        f"saves every {CKPT_SAVE_EVERY}]: SIGKILL after step "
        f"{CKPT_KILL_AFTER}'s commit at {t_kill:.1f} s (uncommitted then: "
        f"{artifacts}); the resume from step {CKPT_KILL_AFTER} and, past a "
        f"corrupt step {newest} of the uninterrupted run, from step "
        f"{newest - CKPT_SAVE_EVERY} (fallback depth 1) log the "
        f"uninterrupted losses bit for bit {want}; fingerprints equal; "
        f"rounds {t_first:.1f} / {t_second:.1f} s; {card}")
    log(f"checkpoint (b) SIGTERM at step {stopped} ({t_term:.1f} s): exit "
        f"0, step {stopped} committed and verified; {card}")
    return launches, dirs, rec


def timed_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def save_breakdown(torch, root, state, spec):
    """Where a sharded save's host time goes, each part timed alone on
    the same state: the copy to the host, the manifest's crc32s, the npz
    write (zipfile computes its own CRC-32 too), the fsync; and reading
    every array back (the zip CRC checked) as verify and restore do."""
    import json as _json
    import os

    import numpy as np

    from apex_tpu_torch import checkpoint as ckpt

    out = {}
    (arrays, manifest, _), out["snapshot"] = timed_ms(
        torch, lambda: ckpt._sharded_snapshot(state, 0, spec,
                                              copy_host_leaves=True))
    _, out["crc32"] = timed_ms(torch, lambda: {
        k: ckpt._checksum(v) for k, v in arrays.items()})
    path = os.path.join(root, "parts.npz")
    f = open(path, "wb")
    _, out["npz_write"] = timed_ms(torch, lambda: np.savez(
        f, __manifest__=_json.dumps(manifest), **arrays))
    _, out["fsync"] = timed_ms(torch, lambda: (f.flush(),
                                               os.fsync(f.fileno())))
    f.close()

    def read_all():
        with np.load(path, allow_pickle=False) as data:
            for k in data.files:
                data[k]
    _, out["npz_read"] = timed_ms(torch, read_all)
    os.unlink(path)
    return {k: round(v, 1) for k, v in out.items()}


def checkpoint_timings(torch, root, dirs, card):
    """The host costs of a GPT-124M train state in this process: sync
    save, async submit, verify, restore; returns the record and the
    uninterrupted run's step-6 train state (restored here)."""
    import os

    from apex_tpu_torch.resilience import CheckpointManager
    from apex_tpu_torch.testing import crash_resume as cr

    pack, _, spec, opt, _ = cr.build_trainer("gpt124m", "cuda")
    src = CheckpointManager(dirs["uninterrupted"], sharded=True, spec=spec)
    nbytes = ckpt_bytes(src, CKPT_STEPS)
    (state, at), restore_ms = timed_ms(
        torch, lambda: src.restore_latest(pack, verify=False))
    check(at == CKPT_STEPS, f"the uninterrupted run's newest step is "
          f"{CKPT_STEPS} ({at})")
    _, verify_ms = timed_ms(torch, lambda: src.verify(CKPT_STEPS))
    mgr = CheckpointManager(os.path.join(root, "timed"), sharded=True,
                            keep=1, spec=spec)
    _, save_ms = timed_ms(torch, lambda: mgr.save(state, 1))
    _, submit_ms = timed_ms(torch, lambda: mgr.save_async(state, 2))
    _, drain_ms = timed_ms(torch, mgr.wait)
    parts = save_breakdown(torch, root, state, spec)
    gb = nbytes / 1e9
    rec = {"state_gb": gb, "sync_save_ms": save_ms, "save_parts_ms": parts,
           "async_submit_ms": submit_ms, "async_drain_ms": drain_ms,
           "verify_ms": verify_ms, "verify_gb_s": gb / (verify_ms / 1e3),
           "restore_ms": restore_ms, "restore_gb_s": gb / (restore_ms / 1e3)}
    log(f"checkpoint timings [GPT-124M train state {gb:.3f} GB, sharded, "
        f"one rank]: sync save {save_ms:.1f} ms; async submit "
        f"{submit_ms:.1f} ms (then {drain_ms:.1f} ms to drain); verify "
        f"{verify_ms:.1f} ms = {rec['verify_gb_s']:.2f} GB/s; restore "
        f"(verify off) {restore_ms:.1f} ms = {rec['restore_gb_s']:.2f} GB/s; "
        f"a save's parts (ms): {parts}; {card}")
    del pack, opt
    return rec, state


def serving_restore_part(torch, np, pa, fo, lo, root, dirs, state, prompts,
                         card):
    """(c) ``restore_gpt_for_serving`` of the resumed run, bit for bit the
    step-6 state, and phase 3's bf16 wave from it against an engine on
    the in-memory params; (d) four adapters restored past a corrupt step
    against the same in memory, through L1.  Returns the launches and
    the record."""
    import os

    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.resilience import CheckpointManager
    from apex_tpu_torch.serving import (
        LoRAConfig,
        SamplingParams,
        ServingEngine,
        restore_adapter_for_serving,
        restore_gpt_for_serving,
    )
    from apex_tpu_torch.serving.lora import init_adapter_weights
    from apex_tpu_torch.testing import faults

    cfg = gpt124m(torch, torch.bfloat16)
    mem = state["params"]
    nbytes = ckpt_bytes(CheckpointManager(dirs["killed"], sharded=True),
                        CKPT_STEPS)
    (params, _, step), ms = timed_ms(torch, lambda: restore_gpt_for_serving(
        dirs["killed"], cfg, with_step=True))
    check(step == CKPT_STEPS, f"the serving restore took step {step}")
    for a, b in zip(tree_leaves(params), tree_leaves(mem)):
        check(a.shape == b.shape and torch.equal(a, b),
              "the served params are the step-6 params bit for bit")
    launches = {}
    waves = {}
    for label, p in (("restored", params), ("in memory", mem)):
        counts, _, reqs, tps = engine_phase(torch, np, pa, fo, lo, p,
                                            torch.bfloat16, prompts)
        waves[label] = [r.output_tokens for r in reqs]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    check(waves["restored"] == waves["in memory"],
          "the restored engine's streams are the in-memory engine's bit for "
          "bit")
    rec = {"serving_restore_ms": ms,
           "serving_restore_gb_s": nbytes / 1e9 / (ms / 1e3)}
    log(f"checkpoint (c) serving restore: restore_gpt_for_serving of the "
        f"resumed run (step {step}, {nbytes / 1e9:.3f} GB read and "
        f"verified) {ms:.1f} ms = {rec['serving_restore_gb_s']:.2f} GB/s; "
        f"params bit for bit; the bf16 wave's {len(prompts)} streams bit "
        f"for bit the in-memory engine's; {card}")

    # (d) adapters: step 1 the four, step 2 others, then torn
    lora = LoRAConfig(rank=RANK, max_adapters=ADAPTERS, alpha=16)
    ids = [f"t{i}" for i in range(ADAPTERS)]
    mem_w = {aid: init_adapter_weights(cfg, lora, seed=100 + i)
             for i, aid in enumerate(ids)}

    def tree(weights):
        return {"adapters": {aid: {proj: {"a": torch.from_numpy(a),
                                          "b": torch.from_numpy(b)}
                                   for proj, (a, b) in w.items()}
                             for aid, w in weights.items()}}

    amgr = CheckpointManager(os.path.join(root, "adapters"), sharded=True)
    amgr.save(tree(mem_w), 1)
    amgr.save(tree({aid: init_adapter_weights(cfg, lora, seed=200 + i)
                    for i, aid in enumerate(ids)}), 2)
    faults.corrupt_checkpoint(amgr.step_path(2))
    got_w = {}
    for aid in ids:
        got_w[aid], at = restore_adapter_for_serving(
            amgr.directory, cfg, lora, key=f"adapters/{aid}", with_step=True)
        check(at == 1, f"adapter {aid} fell back to step 1 past the torn "
              f"step 2 ({at})")
    sampling = [SamplingParams(adapter_id=ids[i % ADAPTERS])
                for i in range(B)]
    lora_waves = {}
    for label, weights in (("restored", got_w), ("in memory", mem_w)):
        eng = ServingEngine(cfg, serving_shape(torch, lora=lora), params)
        for aid in ids:
            eng.register_adapter(aid, weights=weights[aid])
        serve(eng, [prompts[1][:64]], 4, stagger=False)      # warm-up
        base = calls_of(eng)
        zero_counts(pa, fo, lo)
        reqs, _ = serve(eng, prompts[:B], 32, samplings=sampling)
        counts = read_counts(pa, fo, lo)
        check_path_counts(counts, calls_of(eng, base), cfg.num_layers,
                          spec=False, lora=True)
        check_prefill_routes(pa, "tc", f"adapters ({label})")
        lora_waves[label] = [r.output_tokens for r in reqs]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    check(lora_waves["restored"] == lora_waves["in memory"],
          "the restored adapters' streams are the in-memory adapters' bit "
          "for bit")
    log(f"checkpoint (d) adapters: four rank-{RANK} adapters restored past "
        f"a torn newest step (fallback to step 1), {B} requests over them "
        f"through L1 bit for bit the in-memory adapters' streams; {card}")
    return launches, rec


def fleet_restore_part(torch, np, root, state, prompts, card):
    """(e) a ``ReplicaProcess`` from a checkpoint directory reports the
    newest intact step (past a corrupt newest), is rolled onto a newer
    step by ``FleetRouter.rollout`` and reports it, and serves fp32
    streams bit for bit an in-process engine's on the same weights."""
    import os

    from apex_tpu_torch.amp._tree import tree_map
    from apex_tpu_torch.observability.metrics import MetricRegistry
    from apex_tpu_torch.resilience import CheckpointManager
    from apex_tpu_torch.serving import FleetRouter, ReplicaProcess
    from apex_tpu_torch.testing import faults

    fdir = os.path.join(root, "fleet")
    mgr = CheckpointManager(fdir, sharded=True, keep=3)
    params = state["params"]
    mgr.save({"params": params}, 10)
    mgr.save({"params": tree_map(lambda t: t * 0.5, params)}, 11)
    faults.corrupt_checkpoint(mgr.step_path(11))
    spec = fleet_spec(torch, torch.float32, ckpt_dir=fdir)
    t0 = time.perf_counter()
    rep = ReplicaProcess(spec, "c0")
    meta = rep.wait_ready(timeout=FLEET_READY_S)
    ready_s = time.perf_counter() - t0
    check(meta["ckpt_step"] == 10, f"the replica serves step 10, the newest "
          f"intact ({meta['ckpt_step']})")
    router = FleetRouter([rep], registry=MetricRegistry(rank=0, world=1),
                         heartbeat_timeout_s=30.0)
    started = [rep]
    try:
        mgr.save({"params": tree_map(lambda t: t * 0.75, params)}, 12)

        def factory(name):
            started.append(ReplicaProcess(spec, name))
            return started[-1]
        t1 = time.perf_counter()
        router.rollout(factory, ready_timeout_s=FLEET_READY_S)
        roll_s = time.perf_counter() - t1
        step2 = router.introspect()["replicas"]["c0"]["ckpt_step"]
        check(step2 == 12, f"after the rollout the replica serves step 12 "
              f"({step2})")
        reqs, _ = fleet_wave(router, prompts[:4])
        ref_reqs, _, ref_model = fleet_reference(torch, spec, prompts[:4])
        fleet_streams(torch, "checkpoint (e) [rolled replica, fp32]", reqs,
                      ref_reqs, ref_model, 0)
    finally:
        router.close()
        for p in started:
            p.close()
    log(f"checkpoint (e) fleet: a replica from a checkpoint directory "
        f"ready in {ready_s:.3f} s serving step 10 (past a corrupt step 11); "
        f"rolled onto step 12 in {roll_s:.3f} s; 4 fp32 streams bit for bit "
        f"an in-process engine's on the restored weights; {card}")
    return {"replica_ready_s": ready_s, "rollout_s": roll_s}


def checkpoint_phase(torch, np, pa, fo, lo, prompts):
    """Phase 16: checkpoints, crash/resume and the serving restores at
    GPT-124M width on the card; returns the launches of its main path."""
    import os
    import shutil
    import tempfile

    t0 = time.perf_counter()
    card = card_line()
    root = tempfile.mkdtemp(prefix="apex_ckpt_phase_")
    try:
        free = shutil.disk_usage(root).free / 1e9
        check(free >= CKPT_FREE_GB, f"checkpoint phase: {free:.1f} GB free "
              f"under {root}, {CKPT_FREE_GB} GB needed (two keep=2 runs of "
              f"a 1.49 GB train state, a SIGTERM run, the fleet's)")
        launches, dirs, rec = crash_resume_part(torch, root, card)
        timing, state = checkpoint_timings(torch, root, dirs, card)
        counts, serving = serving_restore_part(torch, np, pa, fo, lo, root,
                                               dirs, state, prompts, card)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        fleet = fleet_restore_part(torch, np, root, state, prompts, card)
        del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec.update(timing, **serving, **fleet, card=card,
               seconds=time.perf_counter() - t0)
    rec.pop("losses")
    log(json.dumps({"checkpoint": rec}))
    log(f"phase 16 (checkpoints and the serving restores): "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------- phase 17: ResNet-50 training

RN50_BATCH, RN50_SIZE, RN50_CLASSES = 128, 224, 1000   # bench.py's recipe
RN50_BF16_RMS_RATIO = 2.5      # bf16: distance from fp32, card to CPU
# the profiled step's device time by kind of kernel: cuDNN's convolutions
# (and the head's GEMM), the reductions of the BN statistics and norms,
# the multi-tensor (foreach) optimizer kernels, copies and casts
RN50_KINDS = {"conv_gemm": ("xmma", "implicit", "conv", "cudnn", "gemm",
                            "cutlass", "sm90"),
              "reduce": ("reduce_kernel", "segment"),
              "optimizer_foreach": ("multi_tensor", "foreach"),
              "copy_cast": ("copy", "Memcpy", "Memset")}


def rn50_batches(torch, np, n, seed=0):
    """``n`` synthetic ImageNet batches (uint8 NHWC, int labels) on the
    card, drawn by ``synthetic_image_batches`` as the reference draws
    them."""
    from apex_tpu_torch.data import synthetic_image_batches

    stream = synthetic_image_batches(RN50_BATCH, RN50_SIZE, RN50_CLASSES,
                                     seed=seed)
    out = []
    for _ in range(n):
        x, y = next(stream)
        out.append((torch.from_numpy(x).cuda(),
                    torch.from_numpy(y).long().cuda()))
    torch.cuda.synchronize()
    return out


def rn50_train(torch, label, tr, batches):
    """``WARMUP_STEPS`` + ``TIMED_STEPS`` steps of the trainer ``tr`` on
    ``batches`` (uint8 on the card, normalized on the card inside each
    step) and one profiled step; returns the losses (floats) and the
    record."""
    from apex_tpu_torch.data import normalize_on_device

    def step(i):
        x, y = batches[i % len(batches)]
        return tr.step(tr.images(normalize_on_device(x)), y)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    losses = [step(i) for i in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(i) for i in range(WARMUP_STEPS,
                                      WARMUP_STEPS + TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          f"{label}: the losses are finite: {losses}")
    first = abs(losses[0] - math.log(RN50_CLASSES))
    check(first <= 0.5, f"{label}: the first loss {losses[0]:.4f} within "
          f"0.5 of ln {RN50_CLASSES} ({first:.4f} away)")
    prof = profile_step(torch, label, lambda: step(0), kinds=RN50_KINDS)
    card = card_line()
    rec = {"step_ms": dt * 1e3, "images_per_s": RN50_BATCH / dt,
           "losses": losses, "resident_gib": resident / 2**30,
           "peak_gib": peak / 2**30, "profile": prof,
           "busy_share": prof["busy_ms"] / prof["wall_ms"], "card": card}
    log(f"train[{label}, batch {RN50_BATCH} x {RN50_SIZE}^2, "
        f"{RN50_CLASSES} classes, channels-last]: step {dt * 1e3:.2f} ms = "
        f"{RN50_BATCH / dt:.1f} images/s over {TIMED_STEPS} timed steps; "
        f"resident {resident / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; "
        f"profiled step busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} "
        f"ms ({rec['busy_share']:.3f}), {prof['device_launches']} device "
        f"launches; losses {losses}; card {card}")
    return losses, rec


def rn50_replay(torch, tr, snaps):
    """Each snapshot replayed as one step of the trainer ``tr`` (on its
    device; an O0 trainer gives the fp32 evaluation of a bf16 cell's
    weights): ``[(loss, grad norm, scale)]``."""
    from apex_tpu_torch.testing import l1

    x_np, y_np = l1.rn50_batch()
    x, y = tr.images(x_np), torch.as_tensor(y_np, device=tr.device)
    rows = []
    for snap in snaps:
        tr.restore(dict(snap, scaler=snap["scaler"] if tr.scaler else None))
        loss, grad_norm = tr.step(x, y)
        rows.append((float(loss), float(grad_norm),
                     float(tr.sstate.scale) if tr.scaler else None))
    return rows


def rn50_card_vs_cpu(torch, np):
    """(c): ``rn50_O0`` and ``rn50_O2_dynamic`` at the L1 size: the CPU
    trace's state before each step replayed as one step on the card (TF32
    off, deterministic algorithms), held to the CPU step: fp32 at
    ``compare_traces``' defaults, bf16 by its RMS distance from the fp32
    evaluation (within a factor ``RN50_BF16_RMS_RATIO`` of the CPU's,
    either way: a bf16 step that computed in fp32 sits near 0), the
    loss-scale
    series exactly.  The ten-step trace is chaotic (one ulp of the
    weights moves the loss by 1e-1 within two steps), so the steps are
    compared from the same state, not run free."""
    from apex_tpu_torch.testing import l1

    out = {}
    for name in ("rn50_O0", "rn50_O2_dynamic"):
        trace, snaps = l1.run_trace(name, device="cpu", snapshots=True)
        card = rn50_replay(torch, l1.RN50Trainer(name, device="cuda",
                                                 seed=None), snaps)
        got = {"loss": [r[0] for r in card], "grad_norm": [r[1] for r in card]}
        if name == "rn50_O2_dynamic":
            scales = [r[2] for r in card]
            check(scales == trace["loss_scale"],
                  f"card vs CPU {name}: the loss-scale series {scales} is "
                  f"the CPU's {trace['loss_scale']}")
            fp32 = rn50_replay(torch, l1.RN50Trainer(
                "rn50_O0", device="cpu", seed=None), snaps)
            rec = {}
            for k, key in enumerate(("loss", "grad_norm")):
                f = np.asarray([r[k] for r in fp32])
                rms = lambda a: float(np.sqrt(np.mean(np.square(  # noqa
                    (np.asarray(a) - f) / f))))
                rec[key] = {"card_rms": rms(got[key]),
                            "cpu_rms": rms(trace[key])}
                check(rec[key]["cpu_rms"] / RN50_BF16_RMS_RATIO
                      <= rec[key]["card_rms"] <= RN50_BF16_RMS_RATIO
                      * rec[key]["cpu_rms"],
                      f"card vs CPU {name} {key}: RMS distance from fp32 "
                      f"{rec[key]}")
        else:
            problems = l1.compare_traces(got, trace)
            check(not problems, f"card vs CPU {name}: {problems}")
            rec = {key: max(abs(a - b) / abs(b) for a, b in zip(
                got[key], trace[key])) for key in ("loss", "grad_norm")}
        out[name] = dict(rec, cpu=trace, card=got)
        log(f"card vs CPU[{name}, 8 x 32^2, 10 classes, replayed steps]: "
            f"{json.dumps(rec)}; card {card_line()}")
    return out


def resnet_phase(torch, np, fa, pa, fo, lo, pn):
    """Phase 17: ResNet-50 training at ImageNet width (the BASELINE
    workload): (a) amp O2 + FusedSGD, (b) FusedLAMB + SyncBatchNorm
    under DDP at world size 1 over NCCL, bit for bit its local-BN twin,
    (c) the L1 cells card against CPU.  No TPU kernel lies on this path:
    the nine kernels are checked to launch no time in it."""
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import launch
    from apex_tpu_torch.testing import l1

    t0 = time.perf_counter()
    zero_counts(pa, fo, lo)
    zero_flash_counts(fa)
    pn.LAYER_NORM_LAUNCHES = pn.RMS_NORM_LAUNCHES = 0
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    batches = rn50_batches(torch, np, 4)
    rec = {"card": card_line()}
    try:
        # (a) bench.py's recipe: cuDNN picks its fastest algorithms
        cudnn.benchmark, cudnn.deterministic = True, False
        tr = l1.RN50Trainer("rn50_smoke", device="cuda",
                            num_classes=RN50_CLASSES,
                            optimizer_kw=dict(lr=0.1))
        _, rec["o2_sgd"] = rn50_train(torch, "RN50 O2 FusedSGD", tr,
                                      batches)
        del tr
        # (b) deterministic algorithms, so that the two runs may agree in
        # every bit
        cudnn.benchmark, cudnn.deterministic = False, True
        twin = l1.RN50Trainer(("O2", None, False, "lamb"), device="cuda",
                              num_classes=RN50_CLASSES)
        local, rec["lamb_local"] = rn50_train(
            torch, "RN50 O2 FusedLAMB local BN (deterministic)", twin,
            batches)
        del twin
        launch.initialize_distributed(f"127.0.0.1:{launch.free_port()}", 1,
                                      0, backend="nccl")
        try:
            check(dist.get_backend() == "nccl", "an NCCL process group")
            parallel.initialize_model_parallel(1, 1)
            tr = l1.RN50Trainer(("O2", None, True, "lamb"), device="cuda",
                                num_classes=RN50_CLASSES)
            check(tr.ddp is not None and tr.model.bn_init.axis_name == "dp",
                  "SyncBN over dp under DistributedDataParallel")
            synced, rec["lamb_syncbn"] = rn50_train(
                torch, "RN50 O2 FusedLAMB SyncBN + DDP at one NCCL rank "
                "(deterministic)", tr, batches)
            del tr
        finally:
            parallel.destroy_model_parallel()
            dist.destroy_process_group()
        check(synced == local, f"LAMB + SyncBN at one rank: the losses "
              f"{synced} are bit for bit the local-BN twin's {local}")
        # (c) TF32 is off for the whole script
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            rec["card_vs_cpu"] = rn50_card_vs_cpu(torch, np)
        finally:
            torch.use_deterministic_algorithms(False)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    counts = {**read_counts(pa, fo, lo), **flash_counts(fa),
              "pallas_layer_norm": pn.LAYER_NORM_LAUNCHES,
              "pallas_rms_norm": pn.RMS_NORM_LAUNCHES}
    check(not any(counts.values()),
          f"the ResNet path launches none of the nine kernels: {counts}")
    rec["seconds"] = time.perf_counter() - t0
    log(json.dumps({"resnet": rec}))
    log(f"phase 17 (ResNet-50 training): {rec['seconds']:.1f} s")
    return {}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch import _build
    from apex_tpu_torch import normalization as tn
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    from apex_tpu_torch.ops import pallas_norm as pn
    from apex_tpu_torch.serving import fused_ops as fo
    from apex_tpu_torch.serving import lora as lo
    from apex_tpu_torch.serving import paged_attention as pa
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        init_gpt_params,
    )

    # every fp32 comparison below runs in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    log(f"build and load: {time.perf_counter() - t0:.1f} s")
    for line in _build.last_build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("  " + line.strip())
    check_ptxas(_build.last_build_log, _build.library())

    timer = Timer(torch)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    results = {}
    # the GPT-124M shapes (12 KV heads), and grouped-query attention with
    # 4 KV groups of 3 query heads each
    for label, q_dtype, cache_dtype, groups in (
            ("bf16", bf16, bf16, N_HEADS), ("int8", bf16, i8, N_HEADS),
            ("fp32", f32, f32, N_HEADS), ("bf16 gqa", bf16, bf16, 4)):
        for kname, T in (("paged_attention_decode", None),
                         ("paged_prefill_attention", CHUNK)):
            rec = check_paged(torch, F, pa, timer, q_dtype, cache_dtype, T,
                              groups)
            results[(kname, label)] = rec
            log(f"kernel {kname}[{label} cache]: {json.dumps(rec)}")
    for label, cache_dtype in (("bf16", bf16), ("int8", i8)):
        rec = check_verify(torch, F, pa, timer, cache_dtype)
        results[("paged_prefill_attention", f"{label} verify")] = rec
        log(f"kernel paged_prefill_attention[{label} cache, verify T="
            f"{SPEC_K + 1} through the decode entry]: {json.dumps(rec)}")
    check_paged_edges(torch, pa)
    check_decode_edges(torch, pa)
    # (x, arena): bf16 and fp32 throughout, and the serving phases' bf16
    # activations over the fp32 arena (the arena is in param_dtype)
    for label, x_dtype, w_dtype in (("bf16", bf16, bf16), ("fp32", f32, f32),
                                    ("bf16/fp32", bf16, f32)):
        for proj in LORA_PAIRS:
            for S in (1, SPEC_K + 1, CHUNK):
                rec = check_lora(torch, lo, timer, x_dtype, w_dtype, proj, S)
                results[("lora_delta", f"{label} {proj} S={S}")] = rec
                log(f"kernel lora_delta[x/arena {label}, {proj} "
                    f"{LORA_PAIRS[proj]}, S={S}, B={B}, rank {RANK}]: "
                    f"{json.dumps(rec)}")
    rec = check_lora(torch, lo, timer, f32, bf16, "fc2", CHUNK, timed=False)
    log(f"kernel lora_delta[x/arena fp32/bf16, fc2, S={CHUNK}]: "
        f"{json.dumps(rec)}")
    check_lora_edges(torch, lo)
    for label, x_dtype, r_dtype, w_dtype in NORM_CASES:
        for rows in NORM_ROWS:
            rec = check_norm(torch, F, fo, timer, x_dtype, r_dtype, w_dtype,
                             rows)
            results[("fused_residual_norm", f"{label} rows={rows}")] = rec
            log(f"kernel fused_residual_norm[x/residual/params {x_dtype}/"
                f"{r_dtype}/{w_dtype}, {rows} x {HIDDEN}]: {json.dumps(rec)}")
    check_norm_edges(torch, fo)
    for label, x_dtype, w_dtype in (("bf16/fp32", bf16, f32), ("fp32", f32, f32),
                                    ("bf16", bf16, bf16)):
        for name, kind in (("pallas_layer_norm", "ln"), ("pallas_rms_norm", "rms")):
            rec = check_row_norm(torch, F, pn, timer, kind, x_dtype, w_dtype)
            results[(name, f"{label} rows={TRAIN_BATCH * SEQ}")] = rec
            log(f"kernel {name}[x/params {label}, {TRAIN_BATCH * SEQ} x "
                f"{HIDDEN}]: {json.dumps(rec)}")
    check_row_norm_edges(torch, pn)
    for label, dtype, kw in (("bf16", bf16, {}), ("fp32", f32, {}),
                             ("bf16 segments", bf16, dict(segments=True)),
                             ("bf16 dropout 0.1", bf16, dict(dropout=0.1)),
                             ("bf16 dropout 0.3", bf16, dict(dropout=0.3))):
        for name, rec in check_flash(torch, F, fa, timer, label, dtype,
                                     **kw).items():
            results[(name, label)] = rec
            log(f"kernel {name}[{label}, b{TRAIN_BATCH} h{N_HEADS} s{SEQ} "
                f"d{HEAD_DIM} causal]: {json.dumps(rec)}")
    check_flash_edges(torch, fa)

    cfg = gpt124m(torch, torch.bfloat16)
    params = init_gpt_params(cfg, seed=0)
    prompts = wave(np)
    launches, waves = {}, {}
    for cache_dtype, fuse in ((bf16, True), (i8, True), (bf16, False)):
        waves[cache_dtype, fuse] = engine_phase(
            torch, np, pa, fo, lo, params, cache_dtype, prompts,
            fuse_epilogue=fuse)
        for k, v in waves[cache_dtype, fuse][0].items():
            launches[k] = launches.get(k, 0) + v
    # the reference's A/B of K3: the same bf16 wave with the epilogue as
    # separate ops; every other kernel's count as in the fused wave
    fused_counts, fused_eng, fused, fused_tps = waves[bf16, True]
    counts, _, unfused, tps = waves[bf16, False]
    check(counts == dict(fused_counts, fused_residual_norm=0),
          f"the unfused wave's launches {counts}: the fused wave's "
          f"{fused_counts} less K3's")
    compare_streams(torch, "fuse_epilogue=False vs the K3 wave (bf16)",
                    unfused, fused, fused_eng.model, BF16_TIE)
    log(f"epilogue A/B (bf16 cache wave): tokens/s {fused_tps:.1f} with K3, "
        f"{tps:.1f} with separate ops")
    profile_engine(torch, np, params, prompts)
    card_vs_cpu(torch, gpt124m(torch, torch.float32), params, prompts,
                "GPT-124M")
    small = modern(torch)
    card_vs_cpu(torch, small, init_gpt_params(small, seed=2),
                [[t % small.padded_vocab_size for t in p] for p in prompts],
                "rope + GQA + SwiGLU")

    counts, (model, opt, tokens), flash_losses, flash_step = train_phase(
        torch, fa)
    launches.update(counts)
    profile_train(torch, model, opt, tokens)
    del model, opt, tokens
    train_card_vs_cpu(torch, gpt124m_train(torch, torch.float32), "GPT-124M",
                      1, 128)
    train_card_vs_cpu(torch, dataclasses.replace(
        small, hidden_dropout=0.0, attention_dropout=0.0,
        use_flash_attention=True), "rope + GQA + SwiGLU", 2, 64)

    motifs = motif_wave(np)
    for counts in (spec_phase(torch, np, pa, fo, lo, params, motifs),
                   lora_phase(torch, np, pa, fo, lo, params, motifs),
                   lora_phase(torch, np, pa, fo, lo, params, motifs,
                              spec_int8=True)):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    card_vs_cpu_lora(torch, params, motifs)
    profile_spec_lora(torch, params, motifs)

    launches.update(norm_path_phase(torch, pn, tn))

    for k, v in training_completed_phase(torch, fa, flash_losses[0],
                                         flash_step).items():
        launches[k] += v
    for k, v in fp8_phase(torch, fa, flash_losses[0], flash_step).items():
        launches[k] += v
    for k, v in parallel_phase(torch, fa, F, flash_losses[0],
                               flash_step).items():
        launches[k] += v
    for k, v in pipeline_phase(torch, fa, flash_losses[0],
                               flash_step).items():
        launches[k] += v
    for k, v in context_moe_phase(torch, fa, flash_step).items():
        launches[k] += v
    for k, v in serving_tp_phase(torch, np, pa, fo, lo, params, prompts,
                                 fused).items():
        launches[k] += v
    for k, v in fleet_phase(torch, np, prompts).items():
        launches[k] += v
    for k, v in checkpoint_phase(torch, np, pa, fo, lo, prompts).items():
        launches[k] += v
    resnet_phase(torch, np, fa, pa, fo, lo, pn)

    flash_source = "apex_tpu_torch/csrc/flash_attention.cu"
    meta = {
        "paged_attention_decode": ("apex_tpu_torch/csrc/paged_attention.cu",
                                   "apex_tpu/serving/paged_attention.py:114",
                                   "bf16"),
        "paged_prefill_attention": ("apex_tpu_torch/csrc/paged_attention.cu",
                                    "apex_tpu/serving/paged_attention.py:342",
                                    "bf16"),
        "fused_residual_norm": ("apex_tpu_torch/csrc/fused_residual_norm.cu",
                                "apex_tpu/serving/fused_ops.py:41",
                                f"bf16 rows={B}"),
        "flash_fwd": (flash_source, "apex_tpu/ops/flash_attention.py:265",
                      "bf16"),
        "flash_dq": (flash_source, "apex_tpu/ops/flash_attention.py:369",
                     "bf16"),
        "flash_dkv": (flash_source, "apex_tpu/ops/flash_attention.py:438",
                      "bf16"),
        "lora_delta": ("apex_tpu_torch/csrc/lora_delta.cu",
                       "apex_tpu/serving/lora.py:445", "bf16/fp32 qkv S=1"),
        "pallas_layer_norm": ("apex_tpu_torch/csrc/row_norm.cu",
                              "apex_tpu/ops/pallas_norm.py:50",
                              f"bf16/fp32 rows={TRAIN_BATCH * SEQ}"),
        "pallas_rms_norm": ("apex_tpu_torch/csrc/row_norm.cu",
                            "apex_tpu/ops/pallas_norm.py:60",
                            f"bf16/fp32 rows={TRAIN_BATCH * SEQ}"),
    }
    check(len(meta) == 9, "the kernels line lists all nine kernels")
    kernels = []
    for name, (source, replaces, variant) in meta.items():
        rec = {k: v for k, v in results[(name, variant)].items()
               if k != "err_over_rms"}
        if name == "paged_prefill_attention":      # and at the verify width
            rec["verify"] = results[(name, "bf16 verify")]
        if name == "paged_attention_decode":       # and per route
            rec["launches_by_route"] = {
                r: launches[f"{name}/{r}"] for r in ("split", "simt")}
        if name == "fused_residual_norm":          # every case and width
            rec["widths"] = {
                f"{label} rows={rows}": results[(name, f"{label} rows={rows}")]
                for label, *_ in NORM_CASES for rows in NORM_ROWS}
        if name == "lora_delta":                   # per route, and wider
            rec["launches_by_route"] = {
                r: launches[f"{name}/{r}"] for r in ("cluster", "simt")}
            rec["widths"] = {
                f"{proj} S={S}": {k: v for k, v in results[
                    (name, f"bf16/fp32 {proj} S={S}")].items()
                    if k != "err_over_rms"}
                for proj in LORA_PAIRS for S in (SPEC_K + 1, CHUNK)}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rec})
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

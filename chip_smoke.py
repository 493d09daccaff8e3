#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-ab PARENT   # phase 8, PARENT's checkout and this in turns
    python3 chip_smoke.py --allreduce-ab PARENT   # phase 13's f32 sums, the same way
    python3 chip_smoke.py --phase 26   # phase 1's build, then phase 26 alone

Drives ``flextree_tpu_torch`` (never JAX) on the card, in phases; any
failure raises and exits non-zero:

1. device and build — the card's name and power limit (``nvidia-smi``),
   and every CUDA kernel built from ``flextree_tpu_torch/csrc``; the bf16
   flash forward, dq and dk/dv have ``HMMA`` (``mma.sync``) in their SASS
   and no register spills at head dim 64 (128's are reported);
2. kernel parity — the paged-decode kernel against its plain versions
   (the plain stream, the plain split-K and the gather oracle) at the
   flagship decode shape (S=8 slots, H=8, D=64, bs=16, P=64, N=257) on
   two rows of boundary lengths (a block's and a split's edges), four
   draws each: within ``FUSED_DECODE_ATOL`` in float32; in bfloat16 each
   element within ``PAGED_BF16_PEAK`` of max(|ref|, rms(ref)) and the rms
   error within ``PAGED_BF16_RMS`` of rms(ref); bitwise unchanged when the
   null block is poisoned, the inactive slot exactly v_new, two calls
   bitwise equal;
3. serving — ``ServingEngine`` at the flagship width (vocab 8192,
   d_model 512, 8 heads, 4 layers, d_ff 2048, bf16) with the kernel:
   16 requests, prompts uniform over 16..256, 64 new tokens each.  Every
   request completes, and the kernel's launch count over the run equals
   decode rounds x layers;
4. times — the kernel, its plain stream and
   ``F.scaled_dot_product_attention`` on the pre-gathered view (a
   yardstick only; the port never calls it) on the inputs of the heaviest
   decode round of phase 3, each launch with a cold L2 and a ~0.5 ms head
   start (:func:`time_launches`), beside the least time the card could
   take (bytes over the memory rate);
5. profile — 8 more requests through the same engine under
   ``torch.profiler``: the device's busy share of the wall time and the
   kernels that take it;
6. float32 token identity — the kernel engine, the gather-oracle engine
   and the contiguous-cache ``generate`` give the same greedy tokens;
7. flash parity — each flash kernel (forward, dq, dk/dv) against its
   plain version on the same inputs, float32 and bfloat16, at the
   training shape (B=8, T=1024, H=8, D=64), at one rank's share of
   phase 16's dp=8 step (B=1), at B=4, T=4096, H=16, D=128 and on edge
   cases (ragged Tq, Tq != Tk with offsets, non-causal, rows
   that see no key, an lse cotangent): out within 2e-5 and grads within
   1e-4 in float32; in bfloat16, where both round at the same points,
   each element within 2**-5 of max(|ref|, rms(ref)) and the rms error
   within 2e-4 of rms(ref); the lse within 1e-4; rows that see no key
   exactly 0; every ``variant`` runs the one forward kernel; the bf16
   flash kernels (tensor-core kernels) and the paged kernel refuse an
   input view that is not 16-byte aligned;
8. training — ``trainer.main`` at the flagship width (bf16 compute,
   flash attention, batch 8 x 1024 tokens, 30 steps, warmup-cosine,
   clipping, a checkpoint every 10 steps): the loss is finite and falls,
   each flash kernel launches steps x layers times, the saved checkpoint
   restores bitwise; then steady step time, tokens/s, peak memory and a
   ``torch.profiler`` breakdown of three more steps (the device time a
   step).  ``--train-ab PARENT`` runs only this phase, for the checkout at
   PARENT and this one in turns, each in a process of its own;
9. float32 end to end — three train steps at full width (batch 2 x 1024)
   with flash and with reference attention from one state: losses within
   rtol 1e-5 and gradients within atol 1e-5; the parameters against atol
   1e-5 printed, each miss beside its step-1 gradient and gradient gap,
   and beside a witness (reference attention on the batch rows reversed);
10. flash times — each flash kernel, its plain version and the SDPA
    yardstick (forward; backward through ``torch.autograd.grad``) at the
    training shape, each launch with a cold L2 and a ~0.5 ms head start
    (CUDA-event medians, :func:`time_launches`), beside the least time
    the card could take, with TFLOP/s and the ratio to SDPA;
11. fold and copy parity — the fold kernel against its plain versions,
    bitwise, for every op x dtype of the registry, W in {2, 3, 8}, a
    16-byte-aligned and a ragged L, ``sources_tile`` 1 and 4, NaN rows in
    float max/min: ``reduce_stacked`` (and into a misaligned ``out``), and
    ``reduce_sources`` on batches of 1 and 8 folds, in place and with a
    misaligned source (the kernel's element body; aligned folds run its
    bulk-copy body), against its plain version and ``reduce_stacked`` on
    the same sources stacked; the
    aliasing it refuses; the copy kernel against ``clone``, bitwise;
12. fold times — ``bench.harness.run_reduce_bench`` (the ``--bench
    reduce`` path, the stacked entry) at the heaviest fold of each
    phase-13 shape: kernel, plain, ``torch.sum``/``amax`` and the copy
    kernel (with ``clone`` and ``copy_``) at the same bytes; then
    ``reduce_sources`` at each shape's heaviest stage, every rank's fold in
    one launch, beside the same folds as stacked launches, the copy kernel at the same bytes and, at W=2,
    ``torch._foreach_add``; each launch with a cold L2 and started only
    once enqueued, beside the byte bound;
13. the FlexTree allreduce — ``bench.harness.run_allreduce_bench`` on an
    in-process mesh of 8 ranks (7 for ``"3,2+1"``) on the card at the
    flagship's parameter count (16,781,824 per rank), shapes ``(8,)``,
    ``(4,2)``, ``(2,2,2)``, the ring and ``"3,2+1"``; f32 and bf16 sum,
    int32 band and f32 max: correct, and the fold kernel's launch count
    equal to the count derived from the topology (one launch a fold
    stage, no stacked fold); each case again on
    seeded random data, every rank identical and bitwise the group-fold
    oracle (integers also the simulator), nine more op/dtype cases at
    1,000,003, the tail path at the count + 5; per shape the median ms,
    bus GB/s, the fold kernel's share and the launches a call by kind
    under ``torch.profiler`` (the copies must be the gather phase's
    alone).  ``--allreduce-ab PARENT`` runs only the f32 sums, for the
    checkout at PARENT and this one in turns, each in its own process;
14. distributed — four processes on the card over gloo (host staging),
    every rank bitwise the in-process mesh; NCCL at world size 1 returns
    its input bitwise;
15. IR families and the planner — ``swing``, ``gen:4,2@2``, ``gen:8@7``
    and ``gen:2,2,2@1`` on 8 in-process ranks and ``swing`` on 7 (fold and
    restore hops, a tail) at the flagship's parameter count: every rank's
    row identical and bitwise the same executor on a CPU mesh, int32 and
    integer-valued f32 sums exact, the fold kernel's launches equal to
    ``call_shape``'s count, each timed in place by
    ``run_allreduce_bench`` beside phase 13's shapes; a corrupted program
    refused with ``IRViolationError`` before any fold or copy.  Then the
    cost model's constants fitted on the card over
    ``tools.calibrate_host``'s matrix (the card's work, and for the record
    the wall time), saved, loaded back, refused under another
    fingerprint, with the Spearman rho of predicted against measured at
    least 0.8; the planner's winner over every shape and IR family run
    correct, its time beside the fastest measured (printed, not gated);
16. the bucketed DP sync and the DP train step — (a) the flagship's
    gradient (34 leaves, seeded values) on 8 in-process ranks with
    ``8``, ``4,2``, ``2,2,2`` and the ring, ``chunks=2`` on ``4,2``, on 7
    with ``"3,2+1"``, and a small tree of float32 and bfloat16 leaves with
    tails: every rank's leaves bitwise equal, the bucketed sync bitwise
    the per-leaf sync, the fold kernel's launches those the plan derives
    (``parallel.bucketing.sync_fold_stages``), one ``ft_bucket*`` range a
    bucket under ``torch.profiler`` and the ``SpanLedger``'s bytes the
    tree's, and the bucketed sync bitwise the same sync on host copies of
    the trees, where the fold is the kernel's plain version; the plan
    printed and ``run_grad_sync_bench`` (per-leaf
    against fused, in turns; printed, not gated); (b) ``trainer.main
    --mesh 8,1,1`` at the flagship width (bf16, flash, batch 8 x 1024, 20
    steps, a checkpoint every 10): the loss finite and falling, the
    checkpoint bitwise the live state, each flash kernel's launches
    steps x layers x 8, the fold kernel's steps x the plan's; the steady
    step and tokens/s beside the dp=1 step on the same global batch, in
    turns (printed, not gated); (c) float32 at full width, one dp=8 step
    against the dp=1 step on the same batch: the loss within rtol 1e-5 and
    the synced gradients within atol 1e-5 and 2**-12 of the largest
    gradient (checked, with the gradients' max and rms printed), the
    ranks' gradients summed in rank order without the sync within that
    bar and the same sum with a rank dropped or taken in bfloat16 outside
    it (checked), the parameters' gap printed;
17. compressed collectives and error feedback — (a) the int8 and bf16
    ``compressed_allreduce`` of seeded buffers at the gradient's count on
    8 in-process ranks with ``8``, ``4,2``, ``2,2,2``, the ring,
    ``chunks=2`` on ``2,2,2``, ``"3,2+1"`` on 7 and a tail at the count
    + 5: every rank's result bitwise rank 0's, the error against the
    float64 sum within ``Codec.error_bound``, the fold kernel's launches
    those ``parallel.bucketing.sync_fold_stages`` derives, and at
    ``HOST_COUNT`` the same call on host copies bitwise (result and
    residual: the fold kernel and the encode against their plain
    versions; every fold there but the tail's takes the kernel's
    bulk-copy body, as at the gradient's count, and the script prints
    which body each fold took); on a block-aligned buffer the halves
    (``compressed_reduce_scatter`` then ``compressed_all_gather``)
    bitwise the allreduce and the wire residual bitwise
    ``local_residual``; two controls that must fail: the sum with the
    last rank dropped outside the bound, and rounding to floor (no
    stochastic term) outside the bias bar |mean error| <= 6 rms/sqrt(n)
    that the int8 sync passes; the int8 wire bytes against float32's;
    (b) ``run_grad_sync_bench`` with the ``ours_fused_bf16`` and
    ``ours_fused_int8`` rows (each within its bound; printed, not gated),
    the DP step's int8 and bf16 syncs (its specs, axes and lossy plan) of
    seeded gradients bitwise the same syncs on host copies with the card's
    plan, result and residual (the fold kernel against its plain version
    at the DP codec path's shapes, the body of each fold printed),
    one ``ftq_bucket*`` range a bucket of an int8 sync under
    ``torch.profiler``, and the int8 encode and decode alone (GB/s, the
    cost model's ``codec_bw_GBps``); (c) ``trainer.main --mesh 8,1,1
    --codec int8`` (20 steps, a checkpoint) and ``--codec bf16`` (4): the
    loss finite and falling, the checkpoint bitwise the live state with
    the first rank's ``ef``, every rank's ``ef`` non-zero and each element
    within one quantization step of its block (the sync's inputs and
    residuals recorded), flash launches steps x layers x 8, fold launches
    steps x the lossy plan's; the int8 and f32-codec steps in turns
    (printed, not gated); (d) the JAX EF test at 2^20 elements on 8
    ranks: the single-shot error within the bound, the running mean's
    after 24 steps below 1/8 of step 1's and bound/10;
18. readiness-ordered overlap — the plan (``parallel.overlap.plan_overlap``:
    labels, boundaries, bytes, compute, the predicted total and exposed
    µs) printed; (a) ``trainer.main --mesh 8,1,1 --overlap`` at the
    flagship width (bf16, flash, batch 8 x 1024, 20 steps, a checkpoint
    every 10): the loss finite and falling, the checkpoint bitwise the
    live state, each flash kernel's launches steps x layers x 8, the fold
    kernel's steps x the fired buckets' inner plans'; (b) at full width,
    one float32 step of the overlapped step, its serialized twin and the
    production step bitwise equal, and two int8 steps of the overlapped
    step and its twin bitwise equal with every rank's ``ef``, each
    non-zero; (c) two overlapped steps under ``torch.profiler``: every
    fold launch on another stream than the flash backward's, and the ms
    of folds and of the fold's stream that ran under a flash backward
    kernel (printed, not gated); (d) ``run_train_step_bench`` at the
    flagship width on 8 ranks, six rows in turns: each row's step, sync,
    exposed and hidden ms (printed, not gated; every step bitwise the
    per-leaf one); (e) the backward of one rank's share (B=1, T=1024) in
    CUDA events behind a head start, its ``segment_flops`` over that time
    beside ``parallel/overlap.py``'s constant.
19. ZeRO-1 on 8 ranks — the sharded plan (``plan_buckets(sharded=True)``,
    its fold stages and the block permutation) printed; (a)
    ``trainer.main --mesh 8,1,1 --shard-optimizer`` at the flagship width
    (bf16, flash, batch 8 x 1024, 20 steps, a checkpoint every 10): the
    loss finite and falling, each flash kernel's launches steps x layers x
    8, the fold kernel's steps x ``sync_fold_stages(sharded=True)``'s, the
    checkpoint bitwise the live state consolidated, a resume from it, the
    live moment bytes a rank equal to ``zero_shard_bytes``, and the peak
    memory beside phase 16's; (b) at full width, three float32 steps of
    the replicated, the sharded and the overlapped sharded step bitwise
    (losses, params, the consolidated moments), every fired reduce-scatter
    under the sync debug mode "error", and four steps of ``trainer.main
    --shard-optimizer --codec int8 --overlap`` with every rank's ``ef``
    and every master block non-zero; (c) the step's
    f32 and int8 reduce-scatter of seeded gradients (and the f32 one on
    ``2,2,2``, whose ranks own their blocks out of order) on the card bitwise
    the same on host copies with the card's plan (blocks, tails,
    residual), each fold's body, W and L printed, and the heaviest fold
    stage timed against its plain version, ``torch.sum`` and its bound;
    (d) ``run_train_step_bench(sharded=True)`` on 8 ranks in turns, with
    the optimizer-state ratios (printed, not gated; the live bytes a rank
    equal to ``zero_shard_bytes``); (e) the shard topology's
    reduce-scatter and all-gather programs model-checked;
20. prefill/decode disaggregation — (a) in process, at the flagship width
    in float32: phase 3's 16 requests prefilled on one kernel engine
    (``prefill_for_migration``: export, ``pack_kv``) and admitted on
    another (``admit_migrated``: ``unpack_kv``, ``write_imported``) with
    the f32 codec, tokens equal to a colocated kernel engine's, the
    kernel's launches decode rounds x layers, one recorded round's layer-0
    call held against the plain stream within ``FUSED_DECODE_ATOL``; the
    int8 codec within ``migration_error_bound`` on every payload, each
    request's first diverging token printed; ``pack_kv``/``unpack_kv``
    GB/s; the round feedback's predicted and measured µs; phase 3's bf16
    run with the feedback off and on in turns; (b) across processes: a
    ``replica_main --role prefill`` and a ``--role decode`` process on the
    card behind a ``FrontDoor`` that migrates the longer half of the
    prompts (the planner's crossover printed): every request completes
    exactly once with the oracle's tokens, each long prompt migrated or
    counted as a fallback, the decode replica's kernel launches (from its
    metrics file) decode rounds x layers, and a SIGTERM drain of both that
    exits 0 and retires their endpoint files.
21. the in-process replica pool — (a) two kernel engines at the flagship
    width in float32 under a ``ReplicaPool`` with a 1 s step watchdog, fed
    ``build_spike_workload``'s open-loop spike (62 requests), replica 1
    killed in ``"hang"`` mode mid-spike: every request completes exactly
    once, at least one is re-routed, every request's tokens equal the
    single-engine kernel oracle's, the kernel's launches equal both
    replicas' decode rounds x layers, and one of the survivor's rounds
    holds the kernel against the plain stream within
    ``FUSED_DECODE_ATOL``; then the same pool and traffic in bf16 with
    ``parallel_rounds`` off and on in turns (tok/s, TTFT, not gated); (b)
    ``tools/bench_serving``'s A/B at ``--smoke`` size: its bitwise and
    degrade floors, its throughput ratio printed; (c) (a)'s run recorded
    with each replica on a track of its own: the merged timeline valid, a
    re-routed request's flow spanning both replica tracks, ``python -m
    flextree_tpu_torch.obs metrics DIR --prom`` printing the TTFT window's
    p99 gauge; (d) the protocol models clean, each mutation caught.
22. sequence and tensor parallelism on a (2, 2, 2) dp/sp/tp mesh — (a)
    each flash kernel against its plain version at the path's shapes
    (phase 7's bars): a ring hop (B=4, T=512, H=4, D=64; the resident
    block causal, a past block not, both with an lse cotangent), the
    zigzag's half-shard chunks (T=256) the same way, the Ulysses inner
    attention (T=1024, H=2); the fold kernel at the tensor-parallel
    combine (bf16, W=2, 4 x 512 x 512, forward and backward) and at the
    bucketed sync of seeded slices, each bitwise the same on host copies
    (the sync: the per-leaf sync's plain folds), its bodies printed; (b)
    ``trainer.main --mesh 2,2,2 --sp-impl {ring, zigzag, ulysses}`` and
    ``--mesh 8,1,1`` at the flagship width (bf16, flash, batch 8 x 1024,
    4 steps): the loss finite and falling, each flash kernel's and the
    fold kernel's launches the counts the code gives, then the steady step
    of each in turns, the ring run's device time and busy share under
    ``torch.profiler`` (one profile for the family) and the peak memory
    (printed, not gated); (c)
    float32 at full width, each sp_impl on (2, 2, 2) against one rank, 3
    steps on the same batches: losses within rtol 1e-5, the step-1 synced
    gradient within 1e-5, the parameters within 1e-5 except on AdamW's
    ill-conditioned elements (picked as ``tests/test_torch_overlap.py``
    picks them), which are held to 2 lr a step.
23. pipeline and expert parallelism on (1, 2, 2, 2) meshes — (a) the
    flash kernels at this path's hop (a pipeline microbatch and an MoE
    block: B=4, T=512, H=4, D=64, asserted to be phase 22(a)'s ring
    case, held there); the fold kernel at the expert combine (bf16, W=2,
    4 x 2048 x 512, forward and backward) and at each model's bucketed
    sync of seeded slices, bitwise the same on host copies (the sync: the
    per-leaf sync's plain folds), its bodies printed; (b) ``trainer.main
    --model pipeline --microbatches 2`` and ``--model moe --n-experts 8
    --top-k 2 --capacity-factor 2.0`` at the flagship width (bf16, flash,
    batch 8 x 1024, 4 steps): the loss finite and falling, each flash
    kernel's and the fold kernel's launches the counts the code gives
    (``pm_flash_launches``, ``pm_fold_launches``), the checkpoint bitwise
    the live state; then the steady step of both and of phase 22's dense
    ring step in turns, the two models' device time and busy share under
    ``torch.profiler`` (the dense ring's is 22(b)'s), peak memory and
    MoE's aux (printed, not gated);
    (c) float32 at full width, 3 steps on the same batches: the pipeline
    against one rank's dense step from the same parameters, MoE
    (capacity factor n_experts / top_k, no aux) against the MoE step on
    one rank, to phase 22(c)'s bars.
24. lossy codecs, ZeRO-1 and overlap on the wide meshes (dense (2, 2,
    2), pipeline and MoE (1, 2, 2, 2)) — (a) the fold kernel at this
    path's new lengths: the ZeRO-1 reduce-scatter with its secondary-axis
    block allreduces (float32 on each mesh, int8 on the dense one) and the
    compressed walks over the tp, sp, pp and ep groups (int8 on the dense
    and pipeline meshes, bf16 on MoE's) of seeded slices, each bitwise the
    same on host copies (blocks, tails, residuals), its launches the
    code's count (``bucketing.mesh_fold_launches``) and its bodies
    checked; the heaviest secondary-axis fold stage timed beside its
    bound and ``torch.sum(x, 1)``; (b) ``trainer.main`` at the flagship
    width (bf16, flash, batch 8 x 1024, 4 steps, warmup-cosine, clipping)
    with ``--codec int8``, ``--shard-optimizer``, ``--overlap`` (and, on
    the dense mesh, both) on each family: the loss finite and falling,
    the flash and fold launches the code's count, the checkpoint bitwise
    the live state as the trainer packs it, a sharded run's optimizer
    bytes a rank ``zero_shard_bytes``'; then each family's runs and its
    replicated step in turns (steady step), the family's first run's
    device time and busy share under ``torch.profiler`` and each run's
    peak memory (printed, not gated); (c) float32 at full width (B=2, 3 steps) on each family: the
    sharded step, clipping off, bitwise the replicated one (the
    consolidated moments too), the overlapped step bitwise the replicated
    one, the int8 overlapped step bitwise its serialized twin, ``ef``
    included;
25. the supervised training run — (a) ``planner.autotune.autotune_plan``
    on the card (8 ranks, the flagship gradient, f32, top 3, 3 rounds,
    the trainer knob's call) with a fresh cache: the first call measures,
    the winner no slower than the analytic argmin, the second call a cache
    hit that launches no fold; the winner's allreduce bitwise its host
    copies (fold bodies printed); ``trainer.main --mesh 8,1,1 --autotune``
    (3 steps) on the cached winner, its fold launches the plan's; (b)
    ``python -m flextree_tpu_torch.trainer`` (dp=1, flagship, 8 steps) in
    a process of its own, SIGTERMed mid-run: checkpointed within one step
    of the signal, the preempted line, exit 0; the relaunch resumes and
    ends bitwise where a straight-through process ends; (c) ``fit`` over
    dp=4 (global batch 12 x 1024) with a heartbeat roster of 4, ranks 1-3
    beaten by peer processes, ``FT_LEASE`` 1.5 s: one peer SIGKILLed,
    membership epochs 4 -> 3 with the replanned topology, the newest
    checkpoint restored, the dp=3 step from ``on_shrink``, the loss
    finite, launches the code's count; the survivors' sync at its new
    lengths bitwise its host copies; (d) a dp=1 ``fit`` whose step stalls
    once on the host: timed out, retried, bitwise an undisturbed run; a
    ``BackgroundSaver`` checkpoint bitwise the live state; the bench's
    ``ours_fused_supervised`` and ``ours_fused_recorded`` rows at the
    flagship over dp=8, in turns (printed);
26. the closed-loop planner feedback (``planner.feedback``) at the
    flagship gradient over dp=8 — (a) ``default_probe_points(8, ...)``
    (``8``, ``2,2,2`` and the ring at 4 MiB and 512 KiB) through the
    controller's own timer: each probe's allreduce bitwise its host
    copies, the fold launches the code's count, measured beside
    predicted; (b) ``trainer.main --mesh 8,1,1 --feedback-every 2`` (7
    steps) from a skewed calibration whose plan is not the default
    constants', with a seeded plan-cache entry: one swapped replan, the
    refit (``source="feedback"``, its sample count) in the run-local
    file, the seeded entry gone, the host's file bitwise unchanged, the
    steps' synced buckets the skewed plan's before the replan and the
    refit plan's after it (each bucket length bitwise its host copies),
    the launches the steps' plans' plus the ticks' probes', the
    checkpoint the live state bitwise, the loss falling, the step on
    either plan timed in turns (printed); (c) ``fit`` at
    dp=8 with the probe-free controller from the skewed calibration, its
    probe timer raising and its compute floor the sync-free twin's (no
    span): rotations, a probe-free refit with per-phase scales, fold
    launches exactly the steps' syncs' (no probe), each rotated bucket
    length bitwise its host copies, the final state bitwise the same run
    with rotation off; (d) with no recorder the armed controller never
    ticks and the steps launch only their syncs' folds, the hook's host
    cost a step timed directly; (e) ``python -m flextree_tpu_torch.obs
    fleet`` over (b)'s and (c)'s records.
27. the coordinated control plane and the chip arbiter — (a) the arbiter
    spike (``tools.arbiter_spike.run_spike``) at the flagship width: the
    ZeRO-1 dense step (bf16, flash, global batch 12 x 1024) on an
    in-process dp-3 mesh under ``fit(arbiter=TrainLeaseClient)`` with a
    checkpoint dir, a pool of flagship f32 kernel engines (a baseline and
    two warmed burst engines), the rates and the SLO derived from the
    baseline replica's capacity measured while training runs (a burst of
    1.7 times it); the arbiter's events in order on their lane of a valid
    merged timeline, the lease epochs 3 -> 1 -> 3 each a bitwise resume
    with no step skipped, every request completed exactly once and its
    f32 tokens one kernel engine's, the flash, fold and paged launches the
    code's count (steps by world, the sharded plan's folds a step, decode
    rounds), a single-replica round of the baseline kernel against the
    plain stream, then the dp-3 reduce-scatter and all-gather of the
    flagship gradient bitwise their host copies, the fold bodies printed;
    the p99 before, during and after, breach -> grant, each resize's wall
    and the dp-3 step before and after printed, not gated; (b)
    ``tools.coord_chaos``'s smoke set: the coordinator killed at ack-wait,
    a torn ledger and a coordinated resize on three host processes, and three processes on the card over gloo at
    the flagship gradient's length switching to the chunked twin at one
    agreed step: every floor, each rank's output bitwise the unfaulted
    twin's and its host copies, its fold launches the code's count.

The kernels line gives each kernel's launches by path
(``launches_by_path``: serve, train, dp_train, allreduce, ir_families,
reduce_bench, codec for phase 17(a) and (d), codec_sync for phase 17(b),
dp_codec for phase 17(c)'s int8 run, dp_overlap for phase 18(a), dp_zero
for phase 19(a), disagg for phase 20: the in-process decode engine's f32
run plus the decode replica process's, pool for phase 21(a)'s f32 run,
sp_ring, sp_zigzag and sp_ulysses for phase 22(b)'s three runs, pp_train
and moe_train for phase 23(b)'s two, and ``wide_<option>_<family>`` for
each of phase 24(b)'s ten runs, e.g. wide_int8_dense or wide_zero_moe;
autotune, shrink and supervised_watchdog for phase 25(a), (c) and (d);
feedback_probe, feedback_train and feedback_probe_free for phase 26(a),
(b) and (c); arbiter_train and arbiter_serve for phase 27(a)'s trainer
and pool, coord_gloo for phase 27(b)'s gloo ranks, summed) and their sum
(``launches``).

Prints each phase's seconds, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# flagship model (the JAX package's single-chip flagship) and its cache
MODEL = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048)
CACHE = dict(num_blocks=257, block_size=16, blocks_per_seq=64)
SLOTS = 8
N_REQUESTS = 16
PROMPT_RANGE = (16, 256)
MAX_NEW = 64
SEED = 0

# memory rate (bytes/s), float32 non-tensor-core peak and bf16 tensor-core
# peak (FLOP/s) by card name, from NVIDIA's data sheets (dense, full power
# limit)
_CARDS = (
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100", 3.35e12, 67e12, 989e12),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, *peaks in _CARDS:
        if key in name:
            return peaks
    raise RuntimeError(f"no peak rates recorded for card {name!r}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def boundary_inputs(dtype, gen, dev, lengths, S=8, H=8, D=64, N=257, bs=16,
                    P=64):
    """q, k_new, v_new, pools, tables, lengths at the flagship decode
    shape; each row owns ``length // bs + 1`` private blocks (block 0, the
    null block, pads every table row)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    q, kn, vn = rnd(S, H, D), rnd(S, H, D), rnd(S, H, D)
    kp, vp = rnd(N, bs, H, D), rnd(N, bs, H, D)
    tables = torch.zeros((S, P), dtype=torch.int32)
    nxt = 1
    for s, length in enumerate(lengths):
        n = min(length // bs + 1, P)
        tables[s, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    if nxt > N:
        raise ValueError("boundary rows need more blocks than the pool has")
    return (q, kn, vn, kp, vp, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


# paged decode, bfloat16: kernel and plain versions round at the same
# points (each score to bf16, the output once) and differ in float32
# summation order, which flips a rare output rounding by one bf16 ulp (at
# most 2**-7 of the element).  Over PAGED_DRAWS draws of a row, each
# element within PAGED_BF16_PEAK of max(|ref|, rms(ref)), and the rms of
# the difference within PAGED_BF16_RMS of rms(ref): a flip at the largest
# element moves the rms by ~3e-4 of rms(ref) at one draw (4096 outputs),
# ~1.4e-4 over four; rounding the score or the partials elsewhere moves it
# by ~1.1-1.4e-3 (chip_flash_mutants.py, PERF.md)
PAGED_BF16_PEAK = 2 ** -6
PAGED_BF16_RMS = 5e-4
PAGED_DRAWS = 4


def paged_rows():
    """Phase 2's rows of lengths at the flagship decode shape: length 0,
    either side of a block's and of a split's edge, a full table row."""
    bs, P = CACHE["block_size"], CACHE["blocks_per_seq"]
    span = bs * 4  # KERNEL_BLOCKS_PER_SPLIT blocks
    return ([0, 1, bs - 1, bs, bs + 1, P * bs - 1, 300, 700],
            [0, span - 1, span, span + 1, 2 * span - 1, 2 * span,
             2 * span + 1, 1000])


def paged_compare(pa, dtype, lengths, dev, gen):
    """The paged kernel against the plain stream, the plain split-K and
    the gather oracle on one row of lengths, over :data:`PAGED_DRAWS`
    draws of the inputs: ``(errors, failures)``.  Errors map each
    reference to ``{"abs": max |got - ref|}`` over the draws (bfloat16 adds
    ``peak`` and ``rms``, :func:`bf16_errors` of all draws' outputs
    together); failures list each bar broken, and an inactive slot that is
    not v_new exactly, a poisoned null block that moves the output, or two
    calls that differ in a bit."""
    outs, refs, failures = [], {"stream": [], "split": [], "gather": []}, []
    for _ in range(PAGED_DRAWS):
        args = boundary_inputs(dtype, gen, dev, lengths)
        q, kn, vn, kp, vp, tables, lens = args
        got = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        refs["stream"].append(pa.paged_attention(*args, impl="torch"))
        refs["split"].append(pa.paged_attention_split_plain(
            *args, scale=q.shape[-1] ** -0.5))
        refs["gather"].append(pa.paged_attention_gather(*args))
        pk, pv = kp.clone(), vp.clone()
        pk[0] = 1e30
        pv[0] = 1e30
        poisoned = pa.paged_attention(q, kn, vn, pk, pv, tables, lens)
        torch.cuda.synchronize()
        if not torch.equal(got[0], vn[0]):
            failures.append("inactive slot != v_new")
        if not torch.equal(poisoned, got):
            failures.append("poisoned null block moved the output")
        if not torch.equal(again, got):
            failures.append("two calls differ")
        outs.append(got)
    got = torch.cat(outs)
    errs = {}
    for name, parts in refs.items():
        ref = torch.cat(parts)
        e = {"abs": (got.float() - ref.float()).abs().max().item()}
        if dtype == torch.float32:
            ok = e["abs"] <= pa.FUSED_DECODE_ATOL
        else:
            e["peak"], e["rms"] = bf16_errors(got, ref)
            ok = e["peak"] <= PAGED_BF16_PEAK and e["rms"] <= PAGED_BF16_RMS
        if not ok:  # also NaN
            failures.append(f"vs {name} {e}")
        errs[name] = e
    return errs, sorted(set(failures))


def phase_parity(dev, pa):
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for lengths in paged_rows():
            errs, failures = paged_compare(pa, dtype, lengths, dev, gen)
            if failures:
                raise AssertionError(f"paged parity {name} {lengths}: "
                                     + "; ".join(failures))
            for ref, e in errs.items():
                worst = out.setdefault(name, {}).setdefault(ref, {})
                for key, x in e.items():
                    worst[key] = max(worst.get(key, 0.0), x)
            log(f"phase 2 parity {name} lengths {lengths} ({PAGED_DRAWS} "
                f"draws): kernel vs " + describe_errors(errs)
                + "; poisoned null block bitwise equal; inactive slot == "
                "v_new; two calls bitwise equal")
    bar = (f"f32 abs {pa.FUSED_DECODE_ATOL}; bf16 peak {PAGED_BF16_PEAK:.3g}, "
           f"rms {PAGED_BF16_RMS:.3g}")
    log(f"phase 2 parity worst ({bar}): " + "; ".join(
        f"{name} " + describe_errors(w) for name, w in out.items()))
    return out


def make_requests(Request):
    rng = np.random.default_rng(SEED)
    return [
        Request(
            rid=i,
            prompt=rng.integers(
                0, MODEL["vocab_size"],
                (int(rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1)),),
            ).astype(np.int32),
            max_new_tokens=MAX_NEW,
        )
        for i in range(N_REQUESTS)
    ]


def run_engine(serving, params, cfg, pcfg, fused, dev, record_rounds=None):
    eng = serving.ServingEngine(
        params, cfg, pcfg, serving.BatcherConfig(slots=SLOTS), fused=fused,
        decode_impl="cuda", device=dev,
    )
    if record_rounds is not None:
        inner = eng._decode

        def recording(p, pools, tables, lengths, tokens):
            record_rounds.append((tables.clone(), lengths.clone()))
            return inner(p, pools, tables, lengths, tokens)

        eng._decode = recording
    eng.warmup()
    return eng


def drive(eng, reqs, pa):
    """Submit every request and run to idle, with the launch count set
    to 0 just before and read just after."""
    pa.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.rid} rejected: "
                                 f"{eng.batcher.rejected}")
    eng.run_until_idle()
    torch.cuda.synchronize()
    makespan = time.monotonic() - t0
    return makespan, pa.paged_attention.launches


# GPU cycles (~0.5 ms) the card spins before each timed launch, as
# bench/harness.py's reduce bench does: the launch is enqueued while the
# card is busy, so its events time the kernel and not the wrapper's Python
HEAD_START_CYCLES = 1_000_000


def time_launches(fn, n, flush, warmup=3):
    """Median ms of ``fn()`` over ``n`` launches timed with CUDA events,
    after ``warmup`` untimed ones; each timed launch follows an L2 flush
    (a cold L2) and a ~0.5 ms spin of the card (the head start)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def phase_times(dev, pa, pools, rounds, bw, fp32_peak):
    """Kernel, plain stream and SDPA yardstick on the heaviest phase-3
    round's tables and lengths (the engine's bf16 layer-0 pools)."""
    tables, lengths = max(rounds, key=lambda r: int(r[1].sum()))
    S, H, D = SLOTS, MODEL["n_heads"], MODEL["d_model"] // MODEL["n_heads"]
    kp, vp = pools["k"][0], pools["v"][0]
    gen = torch.Generator().manual_seed(SEED + 1)
    q, kn, vn = (torch.randn((S, H, D), generator=gen).to(dev, kp.dtype)
                 for _ in range(3))
    args = (q, kn, vn, kp, vp, tables, lengths)
    got = pa.paged_attention(*args)
    plain = pa.paged_attention(*args, impl="torch")
    err = (got.float() - plain.float()).abs().max().item()
    peak, rms = bf16_errors(got, plain)
    if not (peak <= PAGED_BF16_PEAK and rms <= PAGED_BF16_RMS):
        raise AssertionError(f"main-path inputs: kernel vs plain peak {peak}"
                             f", rms {rms} (bar {PAGED_BF16_PEAK}, "
                             f"{PAGED_BF16_RMS})")
    # the yardstick: SDPA over the pre-gathered, spliced view
    bs = kp.shape[1]
    view_k = kp[tables.long()].reshape(S, -1, H, D)
    view_v = vp[tables.long()].reshape(S, -1, H, D)
    rows = torch.arange(S, device=dev)
    view_k[rows, lengths.long()] = kn
    view_v[rows, lengths.long()] = vn
    vk, vv = view_k.transpose(1, 2), view_v.transpose(1, 2)  # (S, H, L, D)
    pos = torch.arange(vk.shape[2], device=dev)
    mask = (pos[None, :] <= lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, vk, vv, attn_mask=mask)[:, :, 0]
    lib_err = (lib.float() - plain.float()).abs().max().item()
    if lib_err > 0.05:
        raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    saved = pa.paged_attention.launches
    ms = time_launches(lambda: pa.paged_attention(*args), 200, flush)
    pa.paged_attention.launches = saved  # timing launches do not count
    plain_ms = time_launches(
        lambda: pa.paged_attention(*args, impl="torch"), 30, flush)
    library_ms = time_launches(
        lambda: F.scaled_dot_product_attention(q4, vk, vv, attn_mask=mask),
        200, flush)
    # least work: each row's K/V positions < length read once, the new
    # token's K/V, q and the output once, its table entries and length
    elem = kp.element_size()
    lens = lengths.long().cpu()
    positions = int(lens.sum())
    kv_bytes = 2 * positions * H * D * elem
    table_bytes = int(((lens + bs - 1) // bs).sum()) * 4 + S * 4
    io_bytes = 4 * S * H * D * elem
    n_bytes = kv_bytes + table_bytes + io_bytes
    flops = 4 * (positions + S) * H * D  # q.k and p.v multiply-adds
    t_bytes, t_ops = n_bytes / bw * 1e3, flops / fp32_peak * 1e3
    return {
        "lengths": [int(x) for x in lens],
        "max_abs_err": err,
        "sdpa_vs_plain": lib_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bytes": n_bytes,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


FLASH_REPLACES = (
    ("flash_fwd", "flextree_tpu/ops/pallas_attention.py:79 and :212"),
    ("flash_bwd_dq", "flextree_tpu/ops/pallas_attention.py:524"),
    ("flash_bwd_dkv", "flextree_tpu/ops/pallas_attention.py:601"),
)

# flash parity cases: (name, B, Tq, Tk, H, D, causal, q_offset, k_offset,
# with an lse cotangent)
FLASH_TRAIN = (8, 1024, 8, 64)  # B, T, H, D of one layer of the train step
FLASH_CASES = (
    ("train", 8, 1024, 1024, 8, 64, True, 0, 0, False),
    # one rank's share of phase 16's dp=8 step
    ("dp_rank", 1, 1024, 1024, 8, 64, True, 0, 0, False),
    ("long", 4, 4096, 4096, 16, 128, True, 0, 0, False),
    ("ragged", 2, 100, 100, 4, 64, True, 0, 0, False),
    ("cross", 2, 96, 200, 4, 64, True, 104, 0, False),
    ("noncausal", 2, 100, 160, 4, 128, False, 0, 0, False),
    ("masked_rows", 2, 128, 128, 4, 64, True, 0, 64, False),
    ("lse_grad", 2, 192, 192, 4, 40, True, 0, 0, True),
)
# float32: max |kernel - plain| on out and on the grads (the JAX package's
# own tolerances for its kernels); the lse within LSE_TOL in both dtypes
F32_TOL = {"out": 2e-5, "grad": 1e-4}
LSE_TOL = 1e-4
# bfloat16, where kernel and plain round at the same points and differ in
# float32 summation order: each element within BF16_PEAK of max(|ref|,
# rms(ref)), and the rms of the difference within BF16_RMS of rms(ref).
# Set from the measured errors; removing one rounding point of the TPU
# kernels breaks them (chip_flash_mutants.py, PERF.md)
BF16_PEAK = 2 ** -5
BF16_RMS = 2e-4


def flash_counts(fa):
    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def zero_flash_counts(fa):
    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def flash_inputs(case, dtype, dev, gen):
    """q, k, v, do and the lse cotangent (or None) of a parity case."""
    _, b, tq, tk, h, d, _, _, _, with_glse = case

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    glse = (torch.randn((b, h, tq), generator=gen).to(dev)
            if with_glse else None)
    return rnd(b, tq, h, d), rnd(b, tk, h, d), rnd(b, tk, h, d), \
        rnd(b, tq, h, d), glse


def by_batch(fn, *tensors, **kw):
    """``fn`` one batch element at a time (every tensor is batch-first),
    results concatenated: the plain versions form (H, Tq, Tk) matrices,
    and at the long shape a whole batch of them would be ~17 GB each."""
    outs = []
    for i in range(tensors[0].shape[0]):
        outs.append(fn(*(None if t is None else t[i:i + 1] for t in tensors),
                       **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def bf16_errors(got, ref):
    """``(peak, rms)`` of a bfloat16 result against its plain version: the
    largest ``|got - ref| / max(|ref|, rms(ref))`` over the elements, and
    ``rms(got - ref) / rms(ref)``."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    rms = r.square().mean().sqrt().clamp_min(1e-30)
    peak = (diff / torch.maximum(r.abs(), rms)).max()
    return peak.item(), (diff.square().mean().sqrt() / rms).item()


def flash_compare(fa, case, dtype, dev, gen):
    """One parity case through the three kernels and their plain versions
    on the same inputs.  Returns ``(errors, failures, note, kernel
    run)``: errors maps out/lse/dq/dk/dv to ``{"abs": max |got - ref|}``
    (bfloat16 adds ``peak`` and ``rms``, :func:`bf16_errors`), failures
    lists each bar or exact-zero rule broken, note counts the rows that
    see no key and the keys no row sees, and the run is ``(q, k, v,
    out)``."""
    _, _, tq, tk, _, d, causal, qo, ko, _ = case
    q, k, v, do, glse = flash_inputs(case, dtype, dev, gen)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    p_out, p_lse = by_batch(fa.flash_fwd_plain, q, k, v, **kw)
    dq = fa.flash_bwd_dq(q, k, v, out, do, lse, glse, **kw)
    p_dq = by_batch(fa.flash_bwd_dq_plain, q, k, v, out, do, lse, glse, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, out, do, lse, glse, **kw)
    p_dk, p_dv = by_batch(fa.flash_bwd_dkv_plain, q, k, v, out, do, lse,
                          glse, **kw)
    torch.cuda.synchronize()
    errs, failures = {}, []
    for key, got, ref in (("out", out, p_out), ("lse", lse, p_lse),
                          ("dq", dq, p_dq), ("dk", dk, p_dk),
                          ("dv", dv, p_dv)):
        e = {"abs": (got.float() - ref.float()).abs().max().item()}
        if key == "lse":
            ok = e["abs"] <= LSE_TOL
        elif dtype == torch.float32:
            ok = e["abs"] <= F32_TOL["out" if key == "out" else "grad"]
        else:
            e["peak"], e["rms"] = bf16_errors(got, ref)
            ok = e["peak"] <= BF16_PEAK and e["rms"] <= BF16_RMS
        if not ok:  # also NaN
            failures.append(f"{key} {e}")
        errs[key] = e
    # rows that see no key: exactly 0 out and dq, the +1e30 sentinel;
    # keys that no row sees: exactly 0 dk and dv
    qpos = qo + torch.arange(tq, device=dev)
    kpos = ko + torch.arange(tk, device=dev)
    vis = (qpos[:, None] >= kpos[None, :]) if causal else \
        torch.ones(tq, tk, dtype=torch.bool, device=dev)
    dead_q, dead_k = ~vis.any(1), ~vis.any(0)
    if dead_q.any() and not ((out[:, dead_q] == 0).all()
                             and (dq[:, dead_q] == 0).all()
                             and (lse[:, :, dead_q] == 1e30).all()):
        failures.append("rows that see no key are not exactly 0")
    if dead_k.any() and not ((dk[:, dead_k] == 0).all()
                             and (dv[:, dead_k] == 0).all()):
        failures.append("keys no row sees have nonzero grads")
    note = (f"{int(dead_q.sum())} dead rows, {int(dead_k.sum())} dead keys "
            f"exact")
    return errs, failures, note, (q, k, v, out)


def describe_case(case, tname):
    name, b, tq, tk, h, d, causal, qo, ko, with_glse = case
    return (f"{name} {tname} (B={b} Tq={tq} Tk={tk} H={h} D={d} "
            f"causal={causal} offsets={qo},{ko}{' g_lse' if with_glse else ''})")


def describe_errors(errs):
    return ", ".join(
        f"{key} {e['abs']:.3g}" + (f" (peak {e['peak']:.3g}, rms "
                                   f"{e['rms']:.3g})" if "peak" in e else "")
        for key, e in errs.items())


def phase_flash_parity(dev, fa, pa):
    """Each flash kernel against its plain version on the same inputs, in
    float32 and bfloat16, at the training shape, the long shape and the
    edge cases (:func:`flash_compare`); at the training shape
    ``flash_attention`` gives the kernel's output bitwise for each
    ``variant``.  Returns each kernel's largest absolute error at the
    training shape."""
    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for case in FLASH_CASES:
        for tname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            errs, failures, note, run = flash_compare(fa, case, dtype, dev,
                                                      gen)
            if failures:
                raise AssertionError(f"flash parity {describe_case(case, tname)}"
                                     f": " + "; ".join(failures))
            if case[0] == "train":
                # every JAX forward schedule runs this one kernel
                q, k, v, out = run
                for variant in fa.VARIANTS:
                    got = fa.flash_attention(q, k, v, causal=True,
                                             variant=variant)
                    if not torch.equal(got, out):
                        raise AssertionError(f"flash variant {variant!r} "
                                             f"differs from the kernel")
                for name, keys in (("flash_fwd", ("out",)),
                                   ("flash_bwd_dq", ("dq",)),
                                   ("flash_bwd_dkv", ("dk", "dv"))):
                    worst[name] = max([worst[name]]
                                      + [errs[k_]["abs"] for k_ in keys])
            log(f"phase 7 flash parity {describe_case(case, tname)}: "
                f"{describe_errors(errs)}; {note}")
            del run
            torch.cuda.empty_cache()
    check_misaligned(fa, pa, dev)
    return worst


def check_misaligned(fa, pa, dev):
    """The bfloat16 flash kernels and the paged kernel read their inputs
    16 bytes at a time (``cp.async`` and vector loads): a contiguous view
    that starts 2 bytes past a 16-byte boundary must be refused by the
    wrapper, not launched."""
    b, t, h, d = 1, 64, 2, 64
    n = b * t * h * d
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    ok = buf[:n].view(b, t, h, d)
    bad = buf[1:n + 1].view(b, t, h, d)
    lse = torch.zeros((b, h, t), device=dev)
    kw = dict(causal=True, scale=d ** -0.5)
    # the paged kernel at (S, H, D) = (1, 2, 64), four 16-row blocks
    pool, bad_pool = ok.view(4, 16, h, d), bad.view(4, 16, h, d)
    row = buf[:h * d].view(1, h, d)
    tables = torch.arange(1, 3, dtype=torch.int32, device=dev)[None]
    lens = torch.full((1,), 20, dtype=torch.int32, device=dev)
    saved = flash_counts(fa), pa.paged_attention.launches
    for name, call in (
            ("flash_fwd", lambda: fa.flash_fwd(ok, bad, ok, **kw)),
            ("flash_bwd_dq",
             lambda: fa.flash_bwd_dq(ok, ok, ok, bad, ok, lse, **kw)),
            ("flash_bwd_dkv",
             lambda: fa.flash_bwd_dkv(ok, ok, ok, ok, bad, lse, **kw)),
            ("paged_attention",
             lambda: pa.paged_attention(row, row, row, pool, bad_pool,
                                        tables, lens))):
        try:
            call()
        except ValueError as err:
            log(f"phase 7 misaligned {name}: refused ({err})")
        else:
            raise AssertionError(f"{name} launched on a misaligned input")
    if (flash_counts(fa), pa.paged_attention.launches) != saved:
        raise AssertionError("a refused call counted a launch")


def flash_work(b, t, h, d, elem):
    """(flops, bytes) of each flash kernel for one causal layer of
    (B, T, H, D): products over the visible (i, j) pairs — 2 per
    multiply-add, 2 products of D in the forward (q.k, p.v), 3 in dq
    (q.k, do.v, ds.k), 4 in dk/dv (q.k, do.v, p^T do, ds^T q) — and each
    input read once, each output written once (lse and its row vectors
    float32)."""
    pairs = b * h * t * (t + 1) // 2
    x = b * t * h * d * elem  # one (B, T, H, D) tensor
    rows = b * h * t * 4  # one float32 (B, H, T) vector
    return {
        "flash_fwd": (4 * pairs * d, 3 * x + x + rows),
        "flash_bwd_dq": (6 * pairs * d, 5 * x + rows + x),
        "flash_bwd_dkv": (8 * pairs * d, 5 * x + rows + 2 * x),
    }


def phase_flash_times(dev, fa, bw, bf16_peak):
    """Each flash kernel, its plain version and the SDPA yardstick at the
    training shape in bf16, causal: medians of :func:`time_launches`
    (each launch with a cold L2 and the head start), beside the bound from
    the data sheet.  SDPA's backward computes dq, dk and dv in one call;
    both backward rows carry that one time, and its rate counts the work
    of both backward kernels."""
    b, t, h, d = FLASH_TRAIN
    gen = torch.Generator().manual_seed(SEED + 3)
    dtype = torch.bfloat16
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
                   for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, out, do, lse, **kw),
            lambda: fa.flash_bwd_dq_plain(q, k, v, out, do, lse, **kw)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, out, do, lse, **kw),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, out, do, lse, **kw)),
    }
    # the yardstick, on (B, H, T, D) views; never called by the port
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = (sdpa_out.transpose(1, 2).float() - out.float()).abs().max()
    if not lib_err.item() <= 0.05:
        raise AssertionError(f"SDPA yardstick disagrees: {lib_err.item()}")
    dot = do.transpose(1, 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lib_fwd = time_launches(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 50, flush)
    lib_bwd = time_launches(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True), 50, flush)
    work = flash_work(b, t, h, d, q.element_size())
    bwd_flops = work["flash_bwd_dq"][0] + work["flash_bwd_dkv"][0]
    log(f"phase 10 times SDPA (B={b} T={t} H={h} D={d} bf16 causal): "
        f"forward {lib_fwd:.4f} ms = "
        f"{work['flash_fwd'][0] / lib_fwd / 1e9:.1f} TFLOP/s, backward "
        f"(dq, dk, dv) {lib_bwd:.4f} ms = {bwd_flops / lib_bwd / 1e9:.1f} "
        f"TFLOP/s")
    out_rows = {}
    for name, (kern, plain) in runs.items():
        ms = time_launches(kern, 50, flush)
        plain_ms = time_launches(plain, 20, flush)
        flops, n_bytes = work[name]
        t_bytes = n_bytes / bw * 1e3
        t_ops = flops / bf16_peak * 1e3
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        out_rows[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
            "flops": flops, "bytes": n_bytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log(f"phase 10 times {name} (B={b} T={t} H={h} D={d} bf16 causal): "
            f"kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{ms / lib:.2f}x SDPA's {lib:.4f} ms; plain {plain_ms:.4f} ms; "
            f"bound {out_rows[name]['bound_ms']:.4f} ms "
            f"({out_rows[name]['bound_by']}: {flops / 1e9:.2f} GFLOP, "
            f"{n_bytes / 1e6:.1f} MB)")
    return out_rows


TRAIN_STEPS = 30
TRAIN_ARGV = [
    "--model", "dense", "--vocab", str(MODEL["vocab_size"]),
    "--d-model", str(MODEL["d_model"]), "--n-heads", str(MODEL["n_heads"]),
    "--n-layers", str(MODEL["n_layers"]), "--d-ff", str(MODEL["d_ff"]),
    "--dtype", "bfloat16", "--attn-impl", "flash",
    "--batch", str(FLASH_TRAIN[0]), "--seq-len", str(FLASH_TRAIN[1]),
    "--corpus-tokens", "1000000", "--seed", str(SEED),
    "--steps", str(TRAIN_STEPS), "--schedule", "warmup_cosine",
    "--warmup-steps", "5", "--grad-clip", "1.0", "--ckpt-every", "10",
    "--log-every", "1",
]


def device_profile(run, tag, top: bool = True):
    """``run()`` under ``torch.profiler``: the wall time, the device's busy
    share of it (kernel and copy time summed; one stream, so no overlap;
    the ``comm_span`` ranges the profiler also lays on the device's
    timeline are user annotations over those kernels, not work, and are
    left out) and, with ``top``, the kernels that take the most.  Without
    ``top`` only the card is traced, which reads back in a fraction of the
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if top:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own rows (kernels, copies): operator rows carry their
    # kernels' time too, and counting both would count it twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(device_us(e) for e in rows)
    out = {
        "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6 if rows else None,
        "device_busy_share": busy_us / 1e6 / wall_s if rows else None,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": device_us(e) / 1e3} for e in
                sorted(rows, key=device_us, reverse=True)[:10 if top else 0]],
    }
    if rows:
        log(f"{tag}: wall {wall_s:.3f} s, device busy "
            f"{out['device_busy_s']:.3f} s = "
            f"{100 * out['device_busy_share']:.1f}% (under the profiler)")
        for t in out["top"]:
            log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    else:
        log(f"{tag}: the profiler recorded no device time (not measured)")
    return out


def phase_train(dev, fa, trainer, ckpt, train_mod):
    """The flagship train run through ``trainer.main``, the normal entry
    point, with the flash launch counts set to 0 just before and read
    just after; then, after that read, steady-state step times and a
    profile of a few more steps from the trained state."""
    import tempfile

    b, t = FLASH_TRAIN[:2]
    layers = MODEL["n_layers"]
    with tempfile.TemporaryDirectory(prefix="ft-train-") as ckpt_dir:
        out: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(fa)
        t0 = time.monotonic()
        trainer.main(TRAIN_ARGV + ["--ckpt-dir", ckpt_dir], out=out)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = flash_counts(fa)
        peak_bytes = torch.cuda.max_memory_allocated()
        res = out["result"]
        losses = [loss for _, loss in res.losses]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"train losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train loss did not fall: {losses[0]} -> "
                                 f"{losses[-1]}")
        want = TRAIN_STEPS * layers
        if any(n != want for n in launches.values()):
            raise AssertionError(f"flash launches {launches} != steps x "
                                 f"layers = {want}")
        if res.report.skipped_steps:
            raise AssertionError(f"skipped steps {res.report.skipped_steps}")
        saved = ckpt.restore_train_state(ckpt_dir, dev)
        live = train_mod.tree_leaves(res.state)
        back = train_mod.tree_leaves(saved)
        if len(live) != len(back) or not all(
            a.dtype == b_.dtype and torch.equal(a, b_)
            for a, b_ in zip(live, back)
        ):
            raise AssertionError("the saved checkpoint does not restore "
                                 "bitwise to the live state")
    hist = res.report.metrics["histograms"]["train.step_ms"]
    # steady state: more steps from the trained state, host-timed to
    # the device's end, one at a time
    step = train_mod.make_train_step(out["model_cfg"], out["train_cfg"],
                                     device=dev)
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    state = res.state
    step_s = []
    for i in range(12):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        state, metrics = step(state, data[0], data[1])
        float(metrics["loss"])
        step_s.append(time.monotonic() - t1)
    steady_ms = float(np.median(step_s[2:])) * 1e3

    def three_steps():
        s = state
        for _ in range(3):
            s, m = step(s, data[0], data[1])
        float(m["loss"])

    prof = device_profile(three_steps, "phase 8 profile (3 train steps)")
    summary = {
        "steps": TRAIN_STEPS, "wall_s": wall_s,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches, "peak_mem_bytes": peak_bytes,
        "registry_step_ms_p50": hist["p50"],
        "registry_step_ms_min": hist["min"],
        "steady_step_ms_median": steady_ms,
        "tokens_per_s": b * t / (steady_ms / 1e3),
        "profile": prof,
    }
    log(f"phase 8 train (flagship, bf16, flash, B={b} T={t}): {TRAIN_STEPS} "
        f"steps in {wall_s:.3f} s via trainer.main; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; flash launches {launches} = {TRAIN_STEPS} steps x "
        f"{layers} layers; checkpoint restores bitwise; steady step "
        f"{steady_ms:.3f} ms (median of 10) = {summary['tokens_per_s']:.0f} "
        f"tokens/s; registry step_ms p50 {hist['p50']}; peak memory "
        f"{peak_bytes / 2**30:.3f} GiB; device "
        + (f"{prof['device_busy_s'] * 1e3 / 3:.3f} ms a step (the profile)"
           if prof["device_busy_s"] is not None else "time not measured"))
    return summary


F32_STEPS = 3
F32_BATCH = 2


def named_leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a dict/list tree, in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def f32_run(models, train_mod, cfg, init, batches, dev):
    """Train steps from ``init`` over ``batches``: ``(losses, [(name,
    final param)], [each step's gradients])``."""
    step = train_mod.make_train_step(cfg, train_mod.TrainConfig(),
                                     device=dev)
    state, losses, grads = init, [], []
    for tokens, targets in batches:
        params = train_mod.tree_map(
            lambda p: p.detach().requires_grad_(), state["params"])
        logits = models.forward(params, torch.as_tensor(
            tokens, device=dev).long(), cfg)
        loss_sum, _ = models.cross_entropy_loss(
            logits, torch.as_tensor(targets, device=dev))
        grads.append(torch.autograd.grad(loss_sum / tokens.size,
                                         train_mod.tree_leaves(params)))
        del params, logits, loss_sum
        state, metrics = step(state, tokens, targets)
        losses.append(float(metrics["loss"]))
    return losses, named_leaves(state["params"]), grads


def f32_gaps(run, base):
    """How far ``run`` lands from ``base``: the largest relative loss gap,
    the largest gradient gap over the steps, the largest parameter gap,
    and one line per parameter leaf with elements more than 1e-5 apart,
    giving at those elements the step-1 gradient and its gap."""
    (l_run, p_run, g_run), (l_base, p_base, g_base) = run, base
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_run, l_base))
    grad_abs = max((a - b).abs().max().item()
                   for gs_run, gs_base in zip(g_run, g_base)
                   for a, b in zip(gs_run, gs_base))
    param_abs, misses = 0.0, []
    for i, ((name, a), (_, b)) in enumerate(zip(p_run, p_base)):
        gap = (a - b).abs()
        param_abs = max(param_abs, gap.max().item())
        over = gap > 1e-5
        if over.any():
            g1 = g_base[0][i][over].abs()
            dg1 = (g_run[0][i][over] - g_base[0][i][over]).abs()
            misses.append(
                f"{name}: {int(over.sum())}/{gap.numel()} over, gap "
                f"{gap.max().item():.3g}; step-1 |g| there "
                f"{g1.min().item():.3g}..{g1.max().item():.3g}, its gap "
                f"{dg1.min().item():.3g}..{dg1.max().item():.3g} (largest "
                f"gap/|g| {(dg1 / g1.clamp_min(1e-30)).max().item():.3g})")
    return loss_rel, grad_abs, param_abs, misses


def phase_f32_train(dev, models, train_mod, data_mod):
    """Flash against reference attention, float32 compute at full width,
    from one initial state over the same batches: each step's loss within
    rtol 1e-5 and each step's gradients within atol 1e-5, checked; each
    parameter against the JAX package's atol 1e-5, printed.  A parameter
    can miss that bar while its gradients agree: AdamW's first step moves
    a parameter by ``lr * g / (|g| + eps)``, so where |g| is near eps =
    1e-8 a gradient gap of the size of g moves it by up to ~lr (PERF.md).
    Each miss is printed with its step-1 gradient and gradient gap; and a
    second witness, reference attention on the same batches with their
    rows reversed (the same loss, a different float32 summation order),
    is held against the reference the same way."""
    dataset = data_mod.LMDataset(
        data_mod.synthetic_tokens(200_000, MODEL["vocab_size"], seed=SEED),
        batch=F32_BATCH, seq_len=FLASH_TRAIN[1], seed=SEED)
    batches = [dataset.batch_at(i) for i in range(F32_STEPS)]
    reversed_rows = [(np.ascontiguousarray(t[::-1]),
                      np.ascontiguousarray(g[::-1])) for t, g in batches]
    init = train_mod.init_train_state(
        models.TransformerConfig(**MODEL),
        torch.Generator().manual_seed(SEED), device=dev)

    def cfg(impl):
        return models.TransformerConfig(**MODEL, dtype=torch.float32,
                                        attn_impl=impl)

    ref = f32_run(models, train_mod, cfg("reference"), init, batches, dev)
    flash = f32_run(models, train_mod, cfg("flash"), init, batches, dev)
    witness = f32_run(models, train_mod, cfg("reference"), init,
                      reversed_rows, dev)
    loss_rel, grad_abs, param_abs, misses = f32_gaps(flash, ref)
    w_loss, w_grad, w_param, w_misses = f32_gaps(witness, ref)
    log(f"phase 9 f32 train, flash vs reference ({F32_STEPS} steps, B="
        f"{F32_BATCH} T={FLASH_TRAIN[1]}, full width): losses {flash[0]} vs "
        f"{ref[0]}; max loss rel gap {loss_rel:.3g} (bar 1e-5); max grad "
        f"abs gap {grad_abs:.3g} (bar 1e-5); max param abs gap "
        f"{param_abs:.3g} (JAX bar 1e-5; {len(misses)} leaves miss it)")
    for m in misses:
        log(f"  param over the bar: {m}")
    log(f"phase 9 witness, reference with the batch rows reversed vs "
        f"reference: max loss rel gap {w_loss:.3g}; max grad abs gap "
        f"{w_grad:.3g}; max param abs gap {w_param:.3g} ({len(w_misses)} "
        f"leaves over 1e-5)")
    for m in w_misses:
        log(f"  witness param over 1e-5: {m}")
    if not (loss_rel <= 1e-5 and grad_abs <= 1e-5):
        raise AssertionError(f"f32 flash vs reference: loss rel {loss_rel}, "
                             f"grad abs {grad_abs} (bar 1e-5 each)")
    return {"loss_rel_gap": loss_rel, "grad_abs_gap": grad_abs,
            "param_abs_gap": param_abs, "param_misses": misses,
            "witness_param_abs_gap": w_param, "witness_misses": w_misses}


def phase_profile(eng, reqs):
    """Run ``reqs`` again (fresh ids) under ``torch.profiler``."""
    def run():
        for r in reqs:
            eng.submit(dataclasses.replace(r, rid=r.rid + 10_000,
                                           arrival_s=0.0))
        eng.run_until_idle()

    return device_profile(run, "phase 5 profile")


# ------------------------------------------------ the FlexTree collectives

# the flagship model's parameter count (tied embedding): the gradient the
# train step of phases 8-9 would sync, read from init_params in phase 13
FOLD_LENGTHS = (1_000_048, 100_003)  # 16-byte rows (bulk copies); ragged
FOLD_WIDTHS = (2, 3, 8)
FOLD_TILES = (1, 4)
# reduce_sources in phase 11: folds a batch, in place
FOLD_BATCH = 8
FOLD_BATCH_CASES = ((1, False), (FOLD_BATCH, False), (FOLD_BATCH, True))
COLLECTIVE_SHAPES = (("8", 8), ("4,2", 8), ("2,2,2", 8), ("1", 8),
                     ("3,2+1", 7))
MAIN_CASES = (("sum", "float32"), ("sum", "bfloat16"), ("band", "int32"),
              ("max", "float32"))
OTHER_CASES = (("prod", "float32"), ("min", "float32"), ("sum", "int32"),
               ("bor", "int32"), ("bxor", "int32"), ("min", "uint64"),
               ("prod", "bfloat16"), ("sum", "float16"), ("max", "int8"))
OTHER_COUNT = 1_000_003
DIST_COUNT = 4_194_304
DIST_SPECS = ("4", "2,2", "1", "3+1")


def device_rows(w, length, dtype, gen, dev):
    """A seeded (w, length) input made on the card: normals for floats,
    random bits over the whole width for integers, random bools."""
    if dtype.is_floating_point:
        return torch.randn((w, length), generator=gen, device=dev).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, (w, length), generator=gen,
                             device=dev).bool()
    bits = torch.iinfo(dtype).bits
    signed = {8: torch.int8, 16: torch.int16, 32: torch.int32,
              64: torch.int64}[bits]
    raw = torch.randint(-2 ** 62, 2 ** 62, (w, length), generator=gen,
                        device=dev, dtype=torch.int64)
    return raw.to(signed).view(dtype) if bits < 64 else raw.view(dtype)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def check_batch(rs, x, name, st, batch, in_place):
    """``reduce_sources`` over the first ``batch`` folds of ``x`` (R, W, L),
    sources in reversed row order, into new outputs or in place (each
    fold's output its source 0): bitwise ``reduce_sources_plain`` and
    ``reduce_stacked`` of the same sources stacked; returns the cases."""
    w = x.shape[1]
    order = list(reversed(range(w)))
    src = x[:batch].clone() if in_place else x
    folds = [([src[f, j] for j in order],
              src[f, order[0]] if in_place else torch.empty_like(x[f, 0]))
             for f in range(batch)]
    want = rs.reduce_sources_plain(
        [([x[f, j] for j in order], None) for f in range(batch)], name, st)
    got = rs.reduce_sources(folds, name, st)
    for f in range(batch):
        # the sources stacked, gathered as bytes (PyTorch has no CUDA
        # indexing kernel for uint16/32/64)
        stacked = x[f].view(torch.uint8)[order].view(x.dtype)
        if not (same_bits(got[f], want[f]) and same_bits(
                got[f], rs.reduce_stacked(stacked, name, st))):
            raise AssertionError(
                f"reduce_sources != plain or stacked: {name} {x.dtype} "
                f"W={w} L={x.shape[2]} sources_tile={st} fold {f} of "
                f"{batch}{', in place' if in_place else ''}")
    return batch


def check_refusals(rs, dev):
    """The aliasing ``reduce_sources`` must refuse on the card."""
    a = torch.zeros(4, 1024, device=dev)
    bad = {
        "output partly over a source": [([a[0], a[1]],
                                         a.view(-1)[512:1536])],
        "output equal to source 1": [([a[0], a[1]], a[1])],
        "output over another fold's source": [([a[0], a[1]], a[2]),
                                              ([a[2], a[3]], a[3])],
        "two outputs overlapping": [([a[0], a[1]], a[2]),
                                    ([a[0], a[1]], a[2])],
    }
    for what, folds in bad.items():
        try:
            rs.reduce_sources(folds, "sum")
        except ValueError:
            continue
        raise AssertionError(f"reduce_sources took {what}")
    return len(bad)


def phase_fold_parity(dev, rs, registry, harness):
    """Phase 11: the fold kernel against its plain version, bitwise, for
    every op x dtype of the registry, W in FOLD_WIDTHS, a 16-byte-aligned
    and a ragged L, sources_tile 1 and 4, with NaNs in the float max/min
    inputs: through ``reduce_stacked``, into a misaligned ``out`` view too,
    and through ``reduce_sources`` (batches of 1 and 8 folds, in place, a
    misaligned source) against its plain version and
    ``reduce_stacked`` on the same sources stacked; the refused aliasing;
    the copy kernel against ``clone``, bitwise, aligned, ragged and
    misaligned."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    nan = float("nan")
    cases = sources_cases = 0
    for name, rop in registry.SUPPORTED_OPS.items():
        for dt_name in rop.dtypes:
            dtype = harness.torch_dtype(dt_name)
            for w in FOLD_WIDTHS:
                for length in FOLD_LENGTHS:
                    x = device_rows(FOLD_BATCH * w, length, dtype, gen,
                                    dev).view(FOLD_BATCH, w, length)
                    if dtype.is_floating_point and name in ("max", "min"):
                        x[:, 1, ::7] = nan
                        x[:, w - 1, 3::11] = nan
                    for st in FOLD_TILES:
                        got = rs.reduce_stacked(x[0], name, st)
                        plain = rs.reduce_stacked_plain(x[0], name, st)
                        if not same_bits(got, plain):
                            raise AssertionError(
                                f"fold kernel != plain: {name} {dt_name} "
                                f"W={w} L={length} sources_tile={st}")
                        cases += 1
                        for batch, in_place in FOLD_BATCH_CASES:
                            sources_cases += check_batch(
                                rs, x, name, st, batch, in_place)
                x = x[0]
                buf = torch.empty(FOLD_LENGTHS[1] + 1, dtype=dtype, device=dev)
                out = buf[1:]
                rs.reduce_stacked(x, name, out=out)
                if not same_bits(out, rs.reduce_stacked_plain(x, name)):
                    raise AssertionError(f"fold kernel into a misaligned out: "
                                         f"{name} {dt_name} W={w}")
                cases += 1
                out.view(torch.uint8).copy_(x[1].view(torch.uint8))
                sources = [x[0], out] + list(x[2:])  # source 1 misaligned
                got = rs.reduce_sources([(sources, torch.empty_like(x[0]))],
                                        name)
                if not same_bits(got[0], rs.reduce_stacked_plain(x, name)):
                    raise AssertionError(f"reduce_sources with a misaligned "
                                         f"source: {name} {dt_name} W={w}")
                sources_cases += 1
    refused = check_refusals(rs, dev)
    torch.cuda.synchronize()
    raw = device_rows(1, 4 * FOLD_LENGTHS[0] + 8, torch.uint8, gen, dev)[0]
    for src in (raw[:4 * FOLD_LENGTHS[0]].view(torch.float32),
                raw[:FOLD_LENGTHS[1]], raw[1:FOLD_LENGTHS[1] + 1]):
        if not same_bits(harness.hbm_copy(src), harness.hbm_copy_plain(src)):
            raise AssertionError(f"copy kernel != clone at {src.numel()} "
                                 f"elements, offset {src.storage_offset()}")
    log(f"phase 11 fold parity: reduce_stacked == plain bitwise in all "
        f"{cases} cases ({len(registry.SUPPORTED_OPS)} ops over the "
        f"registry's dtypes, W {FOLD_WIDTHS}, L {FOLD_LENGTHS}, sources_tile "
        f"{FOLD_TILES}, NaN rows for float max/min, a misaligned out); "
        f"reduce_sources == its plain version == reduce_stacked on the same "
        f"sources stacked, bitwise, in all {sources_cases} folds (batches of "
        f"1 and {FOLD_BATCH}, in place, a misaligned source: both kernel "
        f"bodies); {refused} aliasing cases refused; copy kernel == clone "
        f"bitwise (aligned, ragged, misaligned)")
    return {"cases": cases + sources_cases, "max_abs_err": 0.0}


def fold_shapes(spec, n, count, ar, max_pointers):
    """The fold kernel's launches in one allreduce call, by ``(W, L)``, from
    the topology (``parallel.allreduce.call_shape``): a stage of R folds is
    one launch of ``reduce_sources`` for every ``max_pointers // (W + 1)``
    folds."""
    shapes: dict = {}
    for r, w, length in ar.call_shape(n, spec, count).folds:
        per = max_pointers // (w + 1)
        shapes[(w, length)] = shapes.get((w, length), 0) + -(-r // per)
    return shapes


def group_fold_oracle(x, spec, rop, stages):
    """Phase 13's oracle, in plain PyTorch on the card: per tree stage each
    group folds its members' rows in group order and every member gets the
    result; a lonely shape folds rank m+i into buddy i first; the ring
    walks the reference's 2(N-1) steps on the divisible head; the tail
    folds over all ranks in rank order."""
    n, count = x.shape
    topo = stages.Topology.resolve(n, spec)
    lonely = isinstance(topo, stages.LonelyTopology)
    tree = topo.tree if lonely else topo
    owners = tree.num_nodes
    head = count // owners * owners
    out = torch.empty_like(x)
    if head and topo.is_ring:
        v = [x[r, :head].clone().view(n, -1) for r in range(n)]
        for step in range(n - 1):
            sent = [v[r][(r - step) % n].clone() for r in range(n)]
            for r in range(n):
                b = (r - step - 1) % n
                v[r][b] = rop.fold(v[r][b], sent[(r - 1) % n])
        for step in range(n - 1):
            sent = [v[r][(r + 1 - step) % n].clone() for r in range(n)]
            for r in range(n):
                v[r][(r - step) % n] = sent[(r - 1) % n]
        for r in range(n):
            out[r, :head] = v[r].view(-1)
    elif head:
        rows = [x[r, :head] for r in range(n)]
        for i in range(topo.lonely if lonely else 0):
            rows[i] = rop.fold(rows[i], rows[owners + i])
        for i in range(tree.num_stages):
            for grp in tree.groups(i):
                acc = rows[grp[0]]
                for r in grp[1:]:
                    acc = rop.fold(acc, rows[r])
                for r in grp:
                    rows[r] = acc
        for r in range(n):
            out[r, :head] = rows[r if r < owners else r - owners]
    if head < count:
        acc = x[0, head:]
        for r in range(1, n):
            acc = rop.fold(acc, x[r, head:])
        out[:, head:] = acc
    return out


def phase_fold_times(dev, harness, param_count):
    """Phase 12: ``bench.harness.run_reduce_bench`` (the ``--bench reduce``
    path, the stacked entry) at the heaviest fold of each phase-13 shape,
    f32 sum, and f32 max at a ring step, with the copy kernel's and the
    stacked fold's launch counts set to 0 just before and read just
    after."""
    c = param_count
    shapes = ((8, c // 8), (4, c // 4), (2, c // 2), (2, c // 8))
    harness.hbm_copy.launches = harness.reduce_stacked.launches = 0
    doc = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=shapes, dtype="float32", op="sum", device=str(dev)))
    doc_max = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=((2, c // 8),), dtype="float32", op="max", device=str(dev)))
    copy_launches = harness.hbm_copy.launches
    stacked_launches = harness.reduce_stacked.launches
    if copy_launches == 0 or stacked_launches == 0:
        raise AssertionError("the reduce bench launched no copy or stacked "
                             "fold kernel")
    rows = doc["rows"] + doc_max["rows"]
    for r in rows:
        log(f"phase 12 fold {r['op']} W={r['W']} L={r['L']} f32 "
            f"({r['bytes'] / 1e6:.1f} MB): kernel {r['ms']:.4f} ms = "
            f"{r['GBps']:.0f} GB/s, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms = {r['library_GBps']:.0f} GB/s, bound "
            f"{r['bound_ms']:.4f} ms (bytes); copy kernel {r['copy_ms']:.4f} "
            f"ms = {r['copy_GBps']:.0f} GB/s, clone {r['copy_plain_ms']:.4f} "
            f"ms, copy_ {r['copy_library_ms']:.4f} ms (cold L2)")
    return rows, copy_launches, stacked_launches


def stage_times(dev, harness, rs, ar, param_count, bw):
    """Phase 12, the stage-wide fold: ``reduce_sources`` at the heaviest
    fold stage of each phase-13 shape (f32 sum), one launch for every
    rank's fold, beside its byte bound
    Σ(W+1)·L·4 over the memory rate, the same folds as R launches of
    ``reduce_stacked`` on stacks, the plain version, the copy kernel at the
    same bytes and, for W=2, ``torch._foreach_add`` (one PyTorch call for
    the stage); then one ring-step fold against ``torch.add(a, b,
    out=o)``.  Each launch with a cold L2 and a head start."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    seen, rows = set(), []
    for spec, n in COLLECTIVE_SHAPES:
        r, w, length = max(ar.call_shape(n, spec, param_count).folds,
                           key=lambda t: t[0] * (t[1] + 1) * t[2])
        if (r, w, length) in seen:
            continue
        seen.add((r, w, length))
        x = torch.randn((r, w, length), generator=gen, device=dev)
        outs = torch.empty((r, length), device=dev)
        folds = [(list(x[f]), outs[f]) for f in range(r)]
        rs.reduce_sources(folds, "sum")
        for f in range(r):
            if not same_bits(outs[f], rs.reduce_stacked(x[f], "sum")):
                raise AssertionError(f"stage fold {spec} != reduce_stacked")
        n_bytes = r * (w + 1) * length * 4
        src = torch.empty(n_bytes // 2, dtype=torch.uint8, device=dev)
        row = {
            "shape": spec, "R": r, "W": w, "L": length, "bytes": n_bytes,
            "ms": time_launches(lambda: rs.reduce_sources(folds, "sum"), 20,
                                flush),
            "stacked_ms": time_launches(
                lambda: [rs.reduce_stacked(x[f], "sum", out=outs[f])
                         for f in range(r)], 20, flush),
            "plain_ms": time_launches(
                lambda: rs.reduce_sources_plain(folds, "sum"), 10, flush),
            "copy_ms": time_launches(lambda: harness.hbm_copy(src), 20,
                                     flush),
            "library_ms": time_launches(
                lambda: torch._foreach_add(list(x[:, 0]), list(x[:, 1])), 20,
                flush) if w == 2 else None,
            "bound_ms": n_bytes / bw * 1e3,
        }
        rows.append(row)
        lib = row["library_ms"]
        log(f"phase 12 stage fold {spec}: {r} x (W={w}, L={length}) f32 sum "
            f"({n_bytes / 1e6:.1f} MB), one launch: kernel {row['ms']:.4f} ms"
            f" = {n_bytes / row['ms'] / 1e6:.0f} GB/s "
            f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound "
            f"{row['bound_ms']:.4f} ms); {r} stacked launches {row['stacked_ms']:.4f} ms; copy kernel "
            f"{row['copy_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms"
            + (f"; torch._foreach_add {lib:.4f} ms" if lib is not None
               else "") + " (cold L2)")
        del x, outs, folds, src
        torch.cuda.empty_cache()
    ring = next(r for r in rows if r["shape"] == "1")
    length = ring["L"]
    a, b, o = (torch.randn(length, generator=gen, device=dev)
               for _ in range(3))
    one = {
        "kernel": time_launches(lambda: rs.reduce_sources([([a, b], o)]),
                                20, flush),
        "torch.add": time_launches(lambda: torch.add(a, b, out=o), 20, flush),
        "bound": 3 * length * 4 / bw * 1e3,
    }
    log(f"phase 12 one ring-step fold (W=2, L={length}) f32 sum: "
        f"reduce_sources {one['kernel']:.4f} ms, torch.add(a, b, out=o) "
        f"{one['torch.add']:.4f} ms, bound {one['bound']:.4f} ms (cold L2)")
    return rows


def check_result(out, x, spec, name, rop, stages, sim):
    """Every row identical, bitwise the group-fold oracle, and integers
    bitwise the simulator (on the host); returns a short note."""
    n = x.shape[0]
    for r in range(1, n):
        if not same_bits(out[r], out[0]):
            raise AssertionError(f"{spec} {name}: rank {r} != rank 0")
    if not same_bits(out, group_fold_oracle(x, spec, rop, stages)):
        raise AssertionError(f"{spec} {name}: not the group-fold oracle")
    if x.dtype.is_floating_point:
        return "rows identical, == oracle"
    want = sim.simulate_allreduce(x.cpu().numpy(), spec, rop.name)
    if not same_bits(out[0].cpu(), torch.from_numpy(want[0])):
        raise AssertionError(f"{spec} {name}: not the simulator")
    return "rows identical, == oracle, == simulator"


def fold_share(run, warm):
    """``run()`` under ``torch.profiler``, after ``warm()`` in its warm-up
    step (the tracer misses the first launches after it starts): the fold
    kernel's device time, the device's busy time, the wall time, and the
    device's launches by kind (``fold``, ``copy``: ``copy_``'s memcpy and
    copy kernels, ``other``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.step()
    fold_us = busy_us = 0.0
    counts = {"fold": 0, "copy": 0, "other": 0}
    for e in prof.key_averages():
        # the step's own row spans the whole step: not a launch
        if e.device_type != DeviceType.CUDA or \
                e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        busy_us += us
        if "fold_kernel" in e.key:
            fold_us += us
            counts["fold"] += e.count
        elif "memcpy" in e.key.lower() or "copy" in e.key.lower():
            counts["copy"] += e.count
        else:
            counts["other"] += e.count
    return fold_us / 1e6, busy_us / 1e6, wall, counts


def phase_allreduce(dev, harness, stages, ar, registry, sim,
                    allreduce_over_mesh, flat_mesh, rs, param_count):
    """Phase 13: the FlexTree allreduce through
    ``bench.harness.run_allreduce_bench`` on an in-process mesh on the
    card, every shape and main case at the flagship's parameter count,
    with the fold kernel's count set to 0 before and read after each run;
    then each case on seeded random data held to the contracts."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    launches = 0
    shape_launches: dict = {}
    per_shape = {}
    for spec, n in COLLECTIVE_SHAPES:
        mesh = flat_mesh(n, dev)
        per_call = fold_shapes(spec, n, param_count, ar, rs.MAX_POINTERS)
        for name, dt in MAIN_CASES:
            cfg = harness.BenchConfig(size=param_count, repeat=10, topo=spec,
                                      devices=n, dtype=dt, op=name,
                                      device=str(dev))
            rs.reduce_sources.launches = rs.reduce_stacked.launches = 0
            report = harness.run_allreduce_bench(cfg)
            got = rs.reduce_sources.launches
            want = sum(per_call.values()) * report.calls
            if not report.correct:
                raise AssertionError(f"bench {spec} {name} {dt}: incorrect")
            if got != want or rs.reduce_stacked.launches:
                raise AssertionError(
                    f"bench {spec} {name} {dt}: fold launches {got} != "
                    f"{want} from the topology, or a stacked fold "
                    f"({rs.reduce_stacked.launches})")
            launches += got
            for key, k in per_call.items():
                shape_launches[key] = shape_launches.get(key, 0) + k * report.calls
            if (name, dt) == ("sum", "float32"):
                per_shape[spec] = report
            dtype = harness.torch_dtype(dt)
            x = device_rows(n, param_count, dtype, gen, dev)
            out = allreduce_over_mesh(x, mesh, spec, name)
            note = check_result(out, x, spec, f"{name} {dt}",
                                registry.get_op(name), stages, sim)
            log(f"phase 13 {spec} on {n} ranks, {name} {dt}, {param_count} "
                f"per rank: bench median {report.result.median_s * 1e3:.3f} "
                f"ms, correct; fold launches {got} = {sum(per_call.values())} "
                f"a call x {report.calls} calls; random data: {note}")
            del x, out
        for name, dt in OTHER_CASES:
            x = device_rows(n, OTHER_COUNT, harness.torch_dtype(dt), gen, dev)
            check_result(allreduce_over_mesh(x, mesh, spec, name), x, spec,
                         f"{name} {dt}", registry.get_op(name), stages, sim)
        log(f"phase 13 {spec}: {len(OTHER_CASES)} more op/dtype cases at "
            f"{OTHER_COUNT} per rank held to the same contracts")
        torch.cuda.empty_cache()
    # the tail path at full size (the parameter count + 5)
    for name, dt in (("sum", "float32"), ("band", "int32")):
        x = device_rows(8, param_count + 5, harness.torch_dtype(dt), gen, dev)
        out = allreduce_over_mesh(x, flat_mesh(8, dev), "4,2", name)
        note = check_result(out, x, "4,2", f"{name} {dt}",
                            registry.get_op(name), stages, sim)
        log(f"phase 13 tail: 4,2 {name} {dt} at {param_count + 5} per rank: "
            f"{note}")
        del x, out
    # per shape: time, fold share, launches and bus bandwidth of the f32
    # sum, profiled on the bench's timed path (in place)
    summary = {}
    for spec, n in COLLECTIVE_SHAPES:
        report = per_shape[spec]
        mesh = flat_mesh(n, dev)
        x = device_rows(n, param_count, torch.float32, gen, dev)
        folds = sum(fold_shapes(spec, n, param_count, ar,
                                rs.MAX_POINTERS).values())
        copies = ar.call_shape(n, spec, param_count).copies
        # the tracer can drop launches from a window (on an H100, 65 of
        # 190 in one window of 25): a window that misses is taken again;
        # a staging copy would show in every one
        for attempt in range(1, 4):
            fold_s, busy_s, wall_s, counts = fold_share(
                lambda: [allreduce_over_mesh(x, mesh, spec, "sum",
                                             in_place=True)
                         for _ in range(3)],
                lambda: allreduce_over_mesh(x, mesh, spec, "sum",
                                            in_place=True))
            if counts["fold"] == 3 * folds and counts["copy"] == 3 * copies:
                break
            log(f"phase 13 {spec}: profiled window {attempt} counted "
                f"{counts} over 3 calls, want {folds} folds and {copies} "
                f"copies a call")
        else:
            raise AssertionError(
                f"{spec}: {counts} under the profiler over 3 calls, want "
                f"{folds} folds and {copies} copies (the gather phase and "
                f"the tail's snapshot) a call")
        summary[spec] = {
            "ranks": n, "median_ms": report.result.median_s * 1e3,
            "min_ms": report.result.min_s * 1e3,
            "bus_GBps": report.bus_bw_GBps,
            "fold_share_of_busy": fold_s / busy_s if busy_s else None,
            "device_busy_share": busy_s / wall_s,
            "launches_per_call": {k: v / 3 for k, v in counts.items()},
        }
        log(f"phase 13 times {spec} on {n} ranks, f32 sum, {param_count} per "
            f"rank (in-process mesh, HBM copies, not a network): median "
            f"{summary[spec]['median_ms']:.3f} ms, min "
            f"{summary[spec]['min_ms']:.3f} ms, bus "
            f"{report.bus_bw_GBps:.1f} GB/s; fold kernel "
            f"{fold_s * 1e3 / 3:.3f} ms a call = "
            f"{100 * (summary[spec]['fold_share_of_busy'] or 0):.1f}% of the "
            f"device's busy time, busy {100 * busy_s / wall_s:.1f}% of the "
            f"wall (under the profiler); launches a call "
            f"{sum(counts.values()) / 3:g}: {counts['fold'] / 3:g} fold, "
            f"{counts['copy'] / 3:g} copy (the gather phase and any tail "
            f"snapshot: the fold stages copy nothing), "
            f"{counts['other'] / 3:g} other")
        del x
    top = max(shape_launches, key=shape_launches.get)
    log(f"phase 13 fold launches {launches} over the bench runs; most "
        f"launched shape W={top[0]} L={top[1]} ({shape_launches[top]})")
    return launches, top, summary


def phase_dist(dev, harness, launch, allreduce_mod, flat_mesh):
    """Phase 14: four processes on the one card over gloo (host staging),
    each checking bitwise agreement with the in-process mesh; NCCL at
    world size 1."""
    cases = [(spec, DIST_COUNT, name, dt, SEED + k, 1)
             for k, spec in enumerate(DIST_SPECS)
             for name, dt in (("sum", "float32"), ("bxor", "int32"))]
    t0 = time.monotonic()
    got = launch.spawn(harness.dist_allreduce_cases, 4, (cases, str(dev)),
                       backend="gloo", timeout=600)
    spawn_s = time.monotonic() - t0
    mesh = flat_mesh(4, dev)
    for k, (spec, count, name, dt, seed, _) in enumerate(cases):
        x = harness.seeded_rows(4, count, harness.torch_dtype(dt), seed).to(dev)
        full = allreduce_mod.allreduce(list(x), mesh, spec, name)
        shards = allreduce_mod.reduce_scatter(list(x), mesh, spec, name)
        for r in range(4):
            full_d, shard_d, back_d, launches = got[r][k]
            if not (full_d == back_d == harness.digest(full[r])
                    and shard_d == harness.digest(shards[r])):
                raise AssertionError(f"dist rank {r} {spec} {name} {dt}: "
                                     f"differs from the in-process mesh")
            if launches <= 0:
                raise AssertionError(f"dist rank {r} {spec}: no fold launch")
    log(f"phase 14 dist: 4 processes on {dev}, gloo with host staging, "
        f"{len(cases)} cases ({', '.join(DIST_SPECS)} x f32 sum, int32 bxor "
        f"at {DIST_COUNT} per rank): every rank's allreduce, shard and "
        f"gathered shard bitwise the in-process mesh's, fold launches > 0 on "
        f"every rank; {spawn_s:.1f} s with spawn")
    from flextree_tpu_torch.parallel.launch import ClusterConfig

    launch.init_distributed(
        ClusterConfig(f"127.0.0.1:{launch.free_port()}", 1, 0),
        backend="nccl", device=dev, timeout=120, retries=0, merge_env=False)
    try:
        x = harness.seeded_row(0, DIST_COUNT, torch.float32, SEED).to(dev)
        y = allreduce_mod.allreduce(x, None, "1", "sum")
        back = allreduce_mod.all_gather(
            allreduce_mod.reduce_scatter(x, None, None, "sum"), None, None,
            out_shape=(DIST_COUNT,))
        if not (same_bits(y, x) and same_bits(back, x)):
            raise AssertionError("NCCL world of one changed its input")
    finally:
        launch.shutdown_distributed()
    log("phase 14 NCCL at world size 1: allreduce and all_gather of "
        "reduce_scatter return the input bitwise")


# phase 15: the IR families at the gradient's size (plus a few elements,
# for a tail), and the planner
IR_SHAPES = (("swing", 8, 0), ("gen:4,2@2", 8, 0), ("gen:8@7", 8, 0),
             ("gen:2,2,2@1", 8, 0), ("swing", 7, 3))
# the JAX package's bar for a fitted model (tests/test_calibration.py)
SPEARMAN_BAR = 0.8


def corrupted_swing(sir, n):
    """``swing_ir(n)`` with every transfer of its second stage sent to the
    peer two ranks on (the JAX package's seeded corruption)."""
    prog = sir.swing_ir(n, count=n * n)
    st = prog.stages[1]
    bad = tuple(dataclasses.replace(x, dst=(x.dst + 2) % n) for x in st.xfers)
    return dataclasses.replace(
        prog, stages=prog.stages[:1] + (dataclasses.replace(st, xfers=bad),)
        + prog.stages[2:])


def check_ir_family(spec, n, count, gen, dev, flat_mesh,
                    allreduce_over_mesh):
    """One IR family on ``n`` ranks at ``count`` a rank: random f32 rows
    identical and bitwise the same executor on a CPU mesh (the plain fold
    in the same order), int32 and integer-valued f32 sums bitwise the exact
    sum."""
    mesh = flat_mesh(n, dev)
    x = device_rows(n, count, torch.float32, gen, dev)
    out = allreduce_over_mesh(x, mesh, spec, "sum")
    for r in range(1, n):
        if not same_bits(out[r], out[0]):
            raise AssertionError(f"{spec} on {n}: rank {r} != rank 0")
    cpu = allreduce_over_mesh(x.cpu(), flat_mesh(n, "cpu"), spec, "sum")
    if not same_bits(out.cpu(), cpu):
        raise AssertionError(f"{spec} on {n}: not its CPU executor")
    del x, out, cpu
    xi = device_rows(n, count, torch.int32, gen, dev)
    if not same_bits(allreduce_over_mesh(xi, mesh, spec, "sum"),
                     xi.sum(0, dtype=torch.int32).expand(n, -1)):
        raise AssertionError(f"{spec} on {n}: int32 sum not exact")
    del xi
    xf = torch.randint(-8, 8, (n, count), generator=gen, device=dev).float()
    if not same_bits(allreduce_over_mesh(xf, mesh, spec, "sum"),
                     xf.sum(0).expand(n, -1)):
        raise AssertionError(f"{spec} on {n}: integer-valued f32 sum not "
                             f"exact")


def phase_ir_families(dev, harness, ar, rs, flat_mesh, allreduce_over_mesh,
                      param_count, shape_times):
    """Phase 15: the IR families (swing, generalized) at the gradient's
    size, held to their CPU executor and exact sums, their fold launches
    to ``call_shape``, a corrupted program refused before any launch;
    then the planner's constants fitted on the card, saved, reloaded and
    refused under another fingerprint, and the planner's winner run."""
    from flextree_tpu_torch.planner import calibrate as cal
    from flextree_tpu_torch.planner import choose_topology
    from flextree_tpu_torch.schedule import ir as sir
    from flextree_tpu_torch.tools import calibrate_host

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    launches = 0
    times = dict(shape_times)
    for spec, n, extra in IR_SHAPES:
        count = param_count + extra
        check_ir_family(spec, n, count, gen, dev, flat_mesh,
                        allreduce_over_mesh)
        per_call = sum(fold_shapes(spec, n, count, ar,
                                   rs.MAX_POINTERS).values())
        shape = ar.call_shape(n, spec, count)
        rs.reduce_sources.launches = 0
        report = harness.run_allreduce_bench(harness.BenchConfig(
            size=count, repeat=10, topo=spec, devices=n, device=str(dev)))
        got = rs.reduce_sources.launches
        if not report.correct or got != per_call * report.calls:
            raise AssertionError(
                f"{spec} on {n}: correct={report.correct}, fold launches "
                f"{got} != {per_call} a call x {report.calls} calls")
        launches += got
        times[spec, n] = report.result.median_s * 1e3
        log(f"phase 15 {spec} on {n} ranks, {count} f32 per rank: "
            f"rows identical and bitwise its CPU executor, int32 and "
            f"integer-valued f32 sums exact; bench median "
            f"{report.result.median_s * 1e3:.3f} ms, bus "
            f"{report.bus_bw_GBps:.1f} GB/s, correct; fold launches {got} = "
            f"{per_call} a call x {report.calls} calls ({len(shape.folds)} "
            f"fold stages, {shape.messages} gather messages a call)")
    # a corrupted program is refused before anything runs
    x = device_rows(8, 1 << 12, torch.float32, gen, dev)
    out = torch.full_like(x, float("nan"))
    rs.reduce_sources.launches = 0
    try:
        ar.allreduce(list(x), flat_mesh(8, dev), corrupted_swing(sir, 8),
                     out=list(out))
    except sir.IRViolationError as err:
        refusal = f"{len(err.violations)} violations"
    else:
        raise AssertionError("a corrupted swing program ran")
    if rs.reduce_sources.launches or not torch.isnan(out).all():
        raise AssertionError("the corrupted program launched or copied")
    log(f"phase 15 corrupted swing (stage 1 peers moved by 2): refused with "
        f"IRViolationError ({refusal}) before any fold or copy")
    log(f"phase 15 times at {param_count} f32 per rank (swing on 7: + 3; "
        f"median ms of run_allreduce_bench): " + ", ".join(
            f"{spec} on {n} {ms:.3f}" for (spec, n), ms in
            sorted(times.items(), key=lambda kv: kv[1])))

    # the planner's constants, fitted on the card
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"ft_calibration_{os.getpid()}.json")
    try:
        wall = calibrate_host.calibrate(path, device=str(dev), wall=True)
        fit = calibrate_host.calibrate(path, device=str(dev))
        params = cal.load_calibration(path, backend=fit["backend"],
                                      fingerprint=fit["fingerprint"])
        other = cal.load_calibration(
            path, backend=fit["backend"],
            fingerprint=fit["fingerprint"].replace("|r8|", "|r4|"))
    finally:
        if os.path.exists(path):
            os.remove(path)
    if params is None or cal._params_to_dict(params) != fit["params"]:
        raise AssertionError("the saved calibration does not load back")
    if other is not None:
        raise AssertionError("a calibration loaded under another fingerprint")
    for p in fit["points"]:
        log(f"phase 15 calibration point {'*'.join(map(str, p['widths']))} "
            f"at {p['nbytes']} bytes: measured {p['measured_us']:.1f} us "
            f"(noise {p['noise_us']:.1f}), predicted "
            f"{p['predicted_us']:.1f} us")
    log(f"phase 15 calibration ({fit['fingerprint']}): "
        f"{json.dumps(fit['params'])}; Spearman rho {fit['spearman']:.4f} "
        f"(bar {SPEARMAN_BAR}), over the card's work; the wall-time fit "
        f"(host dispatch included) has rho {wall['spearman']:.4f}; saved, "
        f"loaded back equal, a miss under another fingerprint")
    if not fit["spearman"] >= SPEARMAN_BAR:
        raise AssertionError(f"Spearman rho {fit['spearman']} < "
                             f"{SPEARMAN_BAR}")

    # plan with the fitted constants and run the winner
    plan = choose_topology(8, param_count * 4, params,
                           ir_families=("swing", "generalized"))
    log("phase 15 plan:\n" + plan.summary())
    report = harness.run_allreduce_bench(harness.BenchConfig(
        size=param_count, repeat=10, topo=plan.to_ft_topo(), devices=8,
        device=str(dev)))
    if not report.correct:
        raise AssertionError(f"the planner's winner {plan.to_ft_topo()} is "
                             f"not correct")
    eight = {spec: ms for (spec, n), ms in times.items() if n == 8}
    best = min(eight, key=eight.get)
    won = report.result.median_s * 1e3
    log(f"phase 15 planner winner {plan.to_ft_topo()}: "
        f"{plan.candidates[0].total_us:.1f} us predicted, measured median "
        f"{won:.3f} ms, correct; the fastest measured on 8 ranks is {best} "
        f"at {eight[best]:.3f} ms (gap {won / eight[best]:.3f}x, printed, "
        f"not gated)")
    return launches, {"times_ms": times, "fit": fit, "wall_rho":
                      wall["spearman"], "winner": plan.to_ft_topo(),
                      "winner_ms": won, "best": best}


# phase 16: the bucketed DP sync and the DP train step
SYNC_CASES = (("8", 8, 1), ("4,2", 8, 1), ("2,2,2", 8, 1), ("1", 8, 1),
              ("4,2", 8, 2), ("3,2+1", 7, 1))  # (topology, ranks, chunks)
# float32 and bfloat16 leaves, with tails on 8 ranks
SMALL_TREE = (((1003,), torch.float32), ((7, 9), torch.bfloat16),
              ((512,), torch.float32), ((5,), torch.bfloat16),
              ((33, 4), torch.bfloat16), ((1,), torch.float32))
DP = 8
DP_STEPS = 20
DP_ARGV = TRAIN_ARGV + ["--mesh", f"{DP},1,1"]
DP_ARGV[DP_ARGV.index("--steps") + 1] = str(DP_STEPS)
DP_TIMED = 6  # steady steps of each of dp=8 and dp=1, in turns


def stage_launches(stages, max_pointers) -> int:
    """Fold-kernel launches of ``(R, W, L)`` fold stages: one
    ``reduce_sources`` call a stage, one launch for every
    ``max_pointers // (W + 1)`` folds."""
    return sum(-(-r // (max_pointers // (w + 1))) for r, w, _ in stages)


def trees_identical(a_trees, b_trees, leaves) -> bool:
    return all(same_bits(x, y) for ta, tb in zip(a_trees, b_trees)
               for x, y in zip(leaves(ta), leaves(tb)))


def check_sync(trees, spec, chunks, dev, flat_mesh, tm, bk, rs, spans):
    """Phase 16(a), one case: per-leaf and bucketed syncs of the per-rank
    ``trees``, the fold kernel's count set to 0 before and read after
    each, the bucketed one under ``torch.profiler`` and a ``SpanLedger``;
    then the bucketed sync again on CPU copies of the trees with the same
    plan, where ``reduce_sources`` takes its plain fold, held bitwise.
    Returns the plan, both launch counts and the tree's bytes a rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(trees)
    mesh = flat_mesh(n, dev, "dp")
    axes = ("dp",)
    topos = tm.resolve_axis_topos(mesh, axes, spec)
    leaves = tm.tree_leaves(trees[0])
    nbytes = sum(g.numel() * g.element_size() for g in leaves)
    buckets = bk.plan_buckets(leaves, [None] * len(leaves), axes,
                              topos=topos, axis_sizes={"dp": n})
    numels = [g.numel() for g in leaves]
    want = (stage_launches(bk.sync_fold_stages(numels, n, topos["dp"]),
                           rs.MAX_POINTERS),
            stage_launches(bk.sync_fold_stages(numels, n, topos["dp"],
                                               buckets, chunks),
                           rs.MAX_POINTERS))
    torch.cuda.synchronize()
    rs.reduce_sources.launches = 0
    per_leaf = tm.sync_grads(trees, None, axes, topos, bucket_bytes=0,
                             comm=mesh)
    torch.cuda.synchronize()
    got = [rs.reduce_sources.launches]
    rs.reduce_sources.launches = 0
    with spans.span_ledger() as ledger, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused = tm.sync_grads(trees, None, axes, topos, bucket_bytes=None,
                              chunks=chunks, comm=mesh)
        torch.cuda.synchronize()
    got.append(rs.reduce_sources.launches)
    ranges = sum(1 for e in prof.events() if e.name.startswith("ft_bucket")
                 and e.device_type == DeviceType.CPU)
    what = f"{spec} on {n} ranks, chunks={chunks}"
    if not trees_identical(per_leaf, [per_leaf[0]] * n, tm.tree_leaves):
        raise AssertionError(f"{what}: the per-leaf sync's ranks differ")
    if not trees_identical(fused, per_leaf, tm.tree_leaves):
        raise AssertionError(f"{what}: the bucketed sync is not bitwise the "
                             f"per-leaf sync")
    if tuple(got) != want:
        raise AssertionError(f"{what}: fold launches per-leaf and bucketed "
                             f"{got}, the plan derives {want}")
    if ranges != len(buckets) or len(ledger.names) != len(buckets) or \
            ledger.total_bytes("ft_bucket") != nbytes:
        raise AssertionError(
            f"{what}: {ranges} ft_bucket ranges and spans {ledger.names} "
            f"({ledger.total_bytes('ft_bucket')} B) for {len(buckets)} "
            f"buckets of {nbytes} B")
    # the kernel against its plain version at the buckets' shapes: the
    # same sync on the host, the cap set to the card plan's largest bucket
    # so the greedy packing makes the same plan
    host = [tm.tree_map(lambda g: g.cpu(), t) for t in trees]
    cap = max(b.nbytes for b in buckets)
    if bk.plan_buckets(tm.tree_leaves(host[0]), [None] * len(leaves), axes,
                       topos=topos, axis_sizes={"dp": n},
                       bucket_bytes=cap) != buckets:
        raise AssertionError(f"{what}: the host plan differs from the card's")
    plain = tm.sync_grads(host, None, axes, topos, bucket_bytes=cap,
                          chunks=chunks, comm=flat_mesh(n, "cpu", "dp"))
    if not trees_identical([tm.tree_map(lambda g: g.cpu(), t) for t in fused],
                           plain, tm.tree_leaves):
        raise AssertionError(f"{what}: the bucketed sync on the fold kernel "
                             f"is not bitwise its plain fold on the host")
    return buckets, got, nbytes


def dp_sync_checks(dev, shapes, flat_mesh, tm, bk, rs, spans):
    """Phase 16(a): every sync case on seeded per-rank copies of the
    flagship's gradient, then the small two-dtype tree."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    def rank_trees(tree, n):
        return [tm.tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device=dev).to(p.dtype), tree)
            for _ in range(n)]

    plans = {}
    for spec, n, chunks in SYNC_CASES:
        trees = rank_trees(shapes, n)
        buckets, (per, fused), nbytes = check_sync(
            trees, spec, chunks, dev, flat_mesh, tm, bk, rs, spans)
        plans[spec, n, chunks] = buckets
        log(f"phase 16 sync {spec} on {n} ranks, chunks={chunks}, the "
            f"flagship's gradient ({len(tm.tree_leaves(shapes))} leaves, "
            f"{nbytes} B a rank): every rank's leaves bitwise equal, "
            f"bucketed == per-leaf bitwise; plan {len(buckets)} buckets of "
            f"{[b.nbytes for b in buckets]} B, "
            f"{[len(b.indices) for b in buckets]} leaves; fold launches "
            f"per-leaf {per}, bucketed {fused}, as the plan derives; "
            f"{len(buckets)} ft_bucket ranges under the profiler, the "
            f"ledger's bytes the tree's; bitwise the same sync's plain fold "
            f"on the host")
        del trees
        torch.cuda.empty_cache()
    small = {f"leaf{i}": torch.empty(shape, dtype=dt, device=dev)
             for i, (shape, dt) in enumerate(SMALL_TREE)}
    buckets, (per, fused), nbytes = check_sync(
        rank_trees(small, 8), "4,2", 1, dev, flat_mesh, tm, bk, rs, spans)
    if sorted({b.dtype for b in buckets}) != ["bfloat16", "float32"]:
        raise AssertionError(f"small tree: buckets {buckets}")
    log(f"phase 16 sync 4,2 on 8 ranks, a small float32 + bfloat16 tree with "
        f"tails ({nbytes} B a rank): bitwise as above, and the plain fold "
        f"on the host; {len(buckets)} "
        f"buckets by dtype {[(b.dtype, b.indices) for b in buckets]}; fold "
        f"launches per-leaf {per}, bucketed {fused}")
    return plans


# phase 16(c)'s gradient bar: the JAX bar, or this share of the largest
# dp=1 gradient where that is smaller; a sum with a rank dropped or taken
# in bfloat16 must fail it
GRAD_ATOL = 1e-5
GRAD_REL = 2.0 ** -12


def dp_grad_controls(tm, cfg, tc, dev, params, tokens, targets) -> dict:
    """The DP step's gradient summed without the sync: each rank's rows
    through the one-rank step (its loss over its own tokens), scaled by
    1/dp (a power of two, so exactly its share of the global mean's
    gradient), then summed leaf by leaf in rank order in float32, with
    the last rank dropped, and in bfloat16."""
    one_rank = tm.make_loss_and_grads(cfg, tc, device=dev)
    rows = tokens.shape[0] // DP
    shares = []
    for r in range(DP):
        cut = slice(r * rows, (r + 1) * rows)
        _, g, _ = one_rank(params, tokens[cut], targets[cut])
        shares.append([x / DP for x in tm.tree_leaves(g)])
        del g

    def rank_sum(parts, dtype):
        out = []
        for i in range(len(parts[0])):
            acc = parts[0][i].to(dtype)
            for p in parts[1:]:
                acc = acc + p[i].to(dtype)
            out.append(acc.float())
        return out

    return {"plain rank-order sum": rank_sum(shares, torch.float32),
            "last rank dropped": rank_sum(shares[:-1], torch.float32),
            "bfloat16 sum": rank_sum(shares, torch.bfloat16)}


def phase_dp(dev, fa, trainer, ckpt):
    """Phase 16: (a) :func:`dp_sync_checks` and the per-leaf/fused bench;
    (b) the DP train run through ``trainer.main --mesh 8,1,1``, the flash
    and fold counts set to 0 just before and read just after, then its
    steady step in turns with the dp=1 step; (c) float32 dp=8 against
    dp=1, gated on the loss and the synced gradients, with sums that drop
    a rank or add in bfloat16 shown to fail the gradient bar.  Returns the
    launches of (b), the main path, and its peak memory."""
    import tempfile

    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch.bench import harness
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_specs,
    )
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel.mesh import flat_mesh
    from flextree_tpu_torch.utils import profiling as spans

    cfg = TransformerConfig(**MODEL)
    shapes = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device=dev)
    leaf_shapes = tuple(tuple(g.shape) for g in tm.tree_leaves(shapes))
    dp_sync_checks(dev, shapes, flat_mesh, tm, bk, rs, spans)
    bench = harness.run_grad_sync_bench(harness.GradSyncBenchConfig(
        shapes=leaf_shapes, devices=DP, repeat=10, device=str(dev)))
    rows = bench["rows"]
    log(f"phase 16 grad-sync bench (flagship gradient, {DP} ranks, "
        f"{bench['topo']}, {bench['n_buckets']} buckets of "
        f"{bench['bucket_bytes']} B, in turns, {bench['config']['repeat']} "
        f"rounds; printed, not gated): " + "; ".join(
            f"{k} median {r['median_ms']:.3f} ms, min {r['min_ms']:.3f} ms"
            for k, r in rows.items())
        + f"; fused {rows['per_leaf']['median_ms'] / rows['ours_fused']['median_ms']:.2f}x "
        f"per-leaf by the medians; all three bitwise equal")
    torch.cuda.empty_cache()

    # ---- (b) the DP train run through trainer.main, the main path
    b, t = FLASH_TRAIN[:2]
    layers = MODEL["n_layers"]
    mesh = flat_mesh(DP, dev, "dp")
    axes = tm.AXIS_NAMES
    sizes = {"dp": DP, "sp": 1, "tp": 1}
    topos = tm.resolve_axis_topos(sizes, axes, None)
    leaves = tm.tree_leaves(shapes)
    plan = bk.plan_buckets(leaves, bk.spec_leaves(shapes, param_specs(cfg)),
                           axes, topos=topos, axis_sizes=sizes)
    per_step = stage_launches(bk.sync_fold_stages(
        [g.numel() for g in leaves], DP, topos["dp"], plan), rs.MAX_POINTERS)
    with tempfile.TemporaryDirectory(prefix="ft-dp-") as ckpt_dir:
        out: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(fa)
        rs.reduce_sources.launches = 0
        t0 = time.monotonic()
        trainer.main(DP_ARGV + ["--ckpt-dir", ckpt_dir], out=out)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = flash_counts(fa)
        launches["reduce_sources"] = rs.reduce_sources.launches
        peak = torch.cuda.max_memory_allocated()
        res = out["result"]
        losses = [loss for _, loss in res.losses]
        if len(losses) != DP_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"dp train losses not finite and falling: "
                                 f"{losses}")
        want = DP_STEPS * layers * DP
        if any(launches[k] != want for k in flash_counts(fa)):
            raise AssertionError(f"flash launches {launches} != steps x "
                                 f"layers x dp = {want}")
        if launches["reduce_sources"] != DP_STEPS * per_step:
            raise AssertionError(
                f"fold launches {launches['reduce_sources']} != {DP_STEPS} "
                f"steps x {per_step} (the plan's)")
        saved = ckpt.restore_train_state(ckpt_dir, dev)
        if not all(a.dtype == b_.dtype and torch.equal(a, b_) for a, b_ in
                   zip(tm.tree_leaves(res.state), tm.tree_leaves(saved))):
            raise AssertionError("the DP checkpoint does not restore bitwise")
    # steady steps of dp=8 and dp=1 on the same global batch, in turns
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    steps = {"dp=8": tm.make_train_step(out["model_cfg"], out["train_cfg"],
                                        comm=mesh),
             "dp=1": tm.make_train_step(out["model_cfg"], out["train_cfg"],
                                        device=dev)}
    times = {k: [] for k in steps}
    state = res.state
    for i in range(DP_TIMED + 2):
        for name, step in (list(steps.items()) if i % 2 else
                           list(steps.items())[::-1]):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            _, m = step(state, data[0], data[1])
            float(m["loss"])
            times[name].append(time.monotonic() - t1)
    med = {k: float(np.median(v[2:])) * 1e3 for k, v in times.items()}
    log(f"phase 16 dp train (flagship, bf16, flash, global batch {b} x {t}, "
        f"{DP} in-process ranks, {len(plan)} buckets of "
        f"{[p.nbytes for p in plan]} B, grad_topo {topos['dp']}): "
        f"{DP_STEPS} steps in {wall_s:.3f} s via trainer.main; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; flash launches "
        f"{ {k: launches[k] for k in flash_counts(fa)} } = {DP_STEPS} steps x "
        f"{layers} layers x {DP} ranks; fold launches "
        f"{launches['reduce_sources']} = {DP_STEPS} x {per_step} (the "
        f"plan's); checkpoint restores bitwise; peak memory "
        f"{peak / 2**30:.3f} GiB; steady step (median of {DP_TIMED}, in "
        f"turns) dp=8 {med['dp=8']:.3f} ms = "
        f"{b * t / med['dp=8'] * 1e3:.0f} tokens/s, dp=1 {med['dp=1']:.3f} "
        f"ms = {b * t / med['dp=1'] * 1e3:.0f} tokens/s (printed, not "
        f"gated)")
    # where a dp=8 step's device time goes: the fold kernel, copy kernels
    # (the gather phase, the buckets' packing and the model's dtype
    # casts), the rest (the ranks' compute and AdamW)
    fold_s, busy_s, prof_wall, counts = fold_share(
        lambda: [steps["dp=8"](state, data[0], data[1])[1]["loss"].item()
                 for _ in range(2)],
        lambda: steps["dp=8"](state, data[0], data[1])[1]["loss"].item())
    log(f"phase 16 dp=8 profile (2 steps, under torch.profiler): device "
        f"busy {busy_s * 1e3 / 2:.3f} ms a step = "
        f"{100 * busy_s / prof_wall:.1f}% of the wall; the fold kernel "
        f"{fold_s * 1e3 / 2:.3f} ms a step ({counts['fold'] / 2:g} "
        f"launches); launches a step: {counts['copy'] / 2:g} copy (the "
        f"gather phase, the packing, dtype casts), {counts['other'] / 2:g} "
        f"other")
    del state, steps, res, out
    torch.cuda.empty_cache()

    # ---- (c) float32 at full width: dp=8 against dp=1 on one batch
    f32 = TransformerConfig(**MODEL, dtype=torch.float32, attn_impl="flash")
    tc = tm.TrainConfig()
    dataset = data_mod.LMDataset(
        data_mod.synthetic_tokens(200_000, MODEL["vocab_size"], seed=SEED),
        batch=b, seq_len=t, seed=SEED)
    tokens, targets = dataset.batch_at(0)
    init = tm.init_train_state(TransformerConfig(**MODEL),
                               torch.Generator().manual_seed(SEED),
                               device=dev)
    got = {}
    for name, comm in (("dp=8", mesh), ("dp=1", None)):
        loss, grads, _ = tm.make_loss_and_grads(f32, tc, device=dev,
                                                comm=comm)(
            init["params"], tokens, targets)
        new, _ = tm.make_train_step(f32, tc, device=dev, comm=comm)(
            init, tokens, targets)
        # f32_gaps' layout: (losses, named params, each step's gradients)
        got[name] = ([float(loss)], named_leaves(new["params"]),
                     [tm.tree_leaves(grads)])
        del grads, new
    loss_rel, grad_abs, param_abs, misses = f32_gaps(got["dp=8"],
                                                     got["dp=1"])
    synced, base = got["dp=8"][2][0], got["dp=1"][2][0]
    gmax = max(g.abs().max().item() for g in base)
    grms = (sum(g.square().sum().item() for g in base)
            / sum(g.numel() for g in base)) ** 0.5
    bar = min(GRAD_ATOL, GRAD_REL * gmax)
    controls = dp_grad_controls(tm, f32, tc, dev, init["params"], tokens,
                                targets)
    ctl_gaps = {k: max((a - b_).abs().max().item()
                       for a, b_ in zip(c, base))
                for k, c in controls.items()}
    plain_bits = all(same_bits(a, b_) for a, b_ in
                     zip(synced, controls["plain rank-order sum"]))
    log(f"phase 16 f32 dp=8 vs dp=1 (one step, flash, global batch {b} x "
        f"{t}, full width): loss {got['dp=8'][0]} vs {got['dp=1'][0]}, rel "
        f"gap {loss_rel:.3g} (bar 1e-5); synced gradients: dp=1's max |g| "
        f"{gmax:.4g}, rms {grms:.4g}; max abs gap {grad_abs:.3g} = "
        f"{grad_abs / gmax:.3g} of max |g| (bar {bar:.3g}: {GRAD_ATOL:g}, "
        f"the JAX bar, or {GRAD_REL:.3g} x max |g| if smaller); the ranks' "
        f"gradients summed without the sync: "
        + ", ".join(f"{k} gap {v:.3g} ({v / gmax:.3g} of max |g|)"
                    for k, v in ctl_gaps.items())
        + f"; the dp=8 sync is {'bitwise' if plain_bits else 'NOT bitwise'}"
        f" the plain rank-order sum; after one AdamW step param max abs gap "
        f"{param_abs:.3g} (the JAX bar 1e-5, printed: {len(misses)} leaves "
        f"miss it; AdamW amplifies gaps where |g| is near eps)")
    for m in misses:
        log(f"  param over the bar: {m}")
    if not (loss_rel <= 1e-5 and grad_abs <= bar
            and ctl_gaps["plain rank-order sum"] <= bar):
        raise AssertionError(
            f"f32 dp=8 vs dp=1: loss rel {loss_rel} (bar 1e-5), grad abs "
            f"{grad_abs}, the plain rank-order sum {ctl_gaps} (bar {bar})")
    for k in ("last rank dropped", "bfloat16 sum"):
        if not ctl_gaps[k] > bar:
            raise AssertionError(f"the gradient bar {bar} passes a wrong "
                                 f"sum ({k}: gap {ctl_gaps[k]})")
    return launches, peak


# phase 17: compressed collectives and error feedback
# (topology, ranks, chunks, elements past the gradient's count: a tail)
CODEC_CASES = (("8", 8, 1, 0), ("4,2", 8, 1, 0), ("2,2,2", 8, 1, 0),
               ("1", 8, 1, 0), ("2,2,2", 8, 2, 0), ("3,2+1", 7, 1, 0),
               ("4,2", 8, 1, 5))
CODEC_STEP = 7
# the host check's count a rank: a CPU run at the gradient's count takes
# tens of seconds a case.  2^20 + 128 = 192 * 5462: every tile and ring
# block of every case is a whole number of 16-byte packs (the count over
# 8, 16 and 6 is a multiple of 8), so the fold kernel takes its bulk-copy
# body there as at the gradient's count, and the tiles are off the block
# (padding); the case's tail adds to it
HOST_COUNT = (1 << 20) + 128
# csrc/reduce_stacked.cu's launch(): the bulk-copy (TMA) body needs the
# length's bytes and every pointer 16-byte aligned and 16 bytes of each of
# the W sources in a stage of this size, else it takes the element body
TMA_STAGE_BYTES = 24 * 1024
# a block-aligned buffer (2^24 f32 a rank): every tree tile is whole
# blocks, so the halves compose bitwise and the wire residual is the local
# map's
ALIGNED_COUNT = 1 << 24
# the bias bar: |mean signed error| <= BIAS_SIGMAS * rms error / sqrt(count)
BIAS_SIGMAS = 6
EF_COUNT = 1 << 20
EF_STEPS = 24
DP_CODEC_STEPS = 20
DP_BF16_STEPS = 4
DP_CODEC_ARGV = DP_ARGV + ["--codec", "int8"]
DP_CODEC_ARGV[DP_CODEC_ARGV.index("--steps") + 1] = str(DP_CODEC_STEPS)
DP_BF16_ARGV = DP_ARGV + ["--codec", "bf16"]
DP_BF16_ARGV[DP_BF16_ARGV.index("--steps") + 1] = str(DP_BF16_STEPS)


def codec_bound(cm, codec, n, spec, amax) -> float:
    """``Codec.error_bound`` of one allreduce of data with max |x| = amax
    over ``spec`` on ``n`` ranks."""
    from flextree_tpu_torch.schedule.stages import LonelyTopology, Topology

    t = Topology.resolve(n, spec)
    widths, lonely = (t.tree.widths, t.lonely) \
        if isinstance(t, LonelyTopology) else (t.widths, 0)
    return cm.get_codec(codec).error_bound(amax, n, widths, lonely)


def exact_sum(xs):
    """The ranks' buffers summed in float64."""
    out = torch.zeros(xs[0].shape, dtype=torch.float64, device=xs[0].device)
    for x in xs:
        out += x.double()
    return out


def bias_stats(out, exact):
    """(mean signed error, rms error) of ``out`` against ``exact``."""
    e = out.double() - exact
    return float(e.mean()), float(e.square().mean().sqrt())


def unbiased(mean, rms, count) -> bool:
    return abs(mean) <= BIAS_SIGMAS * rms / count ** 0.5


def codec_case(spec, n, chunks, count, codec, gen, dev, flat_mesh, cm, bk,
               rs):
    """Phase 17(a), one case on the card: the compressed allreduce of
    seeded buffers, the fold kernel's launches counted, every rank's
    result bitwise rank 0's, the error against the float64 sum within the
    bound, and (a control) the sum with the last rank dropped outside it.
    Returns the numbers."""
    from flextree_tpu_torch.schedule.stages import Topology

    xs = [torch.randn(count, generator=gen, device=dev) for _ in range(n)]
    mesh = flat_mesh(n, dev)
    topo = Topology.resolve(n, spec)
    want = stage_launches(bk.sync_fold_stages([count], n, topo, None, chunks,
                                              codec), rs.MAX_POINTERS)
    torch.cuda.synchronize()
    before = rs.reduce_sources.launches
    t0 = time.monotonic()
    out = cm.compressed_allreduce(xs, mesh, spec, codec, chunks, CODEC_STEP)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    launches = rs.reduce_sources.launches - before
    what = f"{codec} {spec} on {n} ranks, chunks={chunks}, {count} f32"
    if not all(torch.equal(out[0], o) for o in out[1:]):
        raise AssertionError(f"{what}: the ranks' results differ")
    if launches != want:
        raise AssertionError(f"{what}: fold launches {launches}, the plan "
                             f"derives {want}")
    exact = exact_sum(xs)
    amax = max(float(x.abs().max()) for x in xs)
    bound = codec_bound(cm, codec, n, spec, amax)
    err = float((out[0].double() - exact).abs().max())
    dropped = float((out[0].double() - exact + xs[-1].double()).abs().max())
    mean, rms = bias_stats(out[0], exact)
    if not err <= bound:
        raise AssertionError(f"{what}: error {err} over the bound {bound}")
    if not dropped > bound:
        raise AssertionError(f"{what}: the bound {bound} passes a sum with "
                             f"the last rank dropped ({dropped})")
    if codec == "int8" and not unbiased(mean, rms, count):
        raise AssertionError(f"{what}: biased, mean error {mean}, rms {rms}")
    return {"launches": launches, "err": err, "bound": bound,
            "dropped": dropped, "mean": mean, "rms": rms, "wall_ms": wall_ms}


@contextlib.contextmanager
def fold_bodies(rs, *modules):
    """Count the fold kernel's launches from the ``reduce_sources`` calls
    of ``modules`` by the body ``csrc/reduce_stacked.cu`` takes for each
    (its ``launch()`` rule: ``"tma"``, the bulk-copy body, or
    ``"element"``), W, dtype and length.  Yields the counter; the calls
    go through unchanged."""
    seen: collections.Counter = collections.Counter()
    real = rs.reduce_sources

    def probe(folds, op="sum", sources_tile=1):
        folds = [(list(sources), out) for sources, out in folds]
        w, out0 = len(folds[0][0]), folds[0][1]
        per = rs.MAX_POINTERS // (w + 1)
        nbytes = out0.numel() * out0.element_size()
        for b in range(0, len(folds) if out0.is_cuda and nbytes else 0, per):
            ptrs = [t.data_ptr() for sources, out in folds[b:b + per]
                    for t in (*sources, out)]
            tma = nbytes % 16 == 0 and TMA_STAGE_BYTES // w >= 16 and \
                all(p % 16 == 0 for p in ptrs)
            seen["tma" if tma else "element", w,
                 str(out0.dtype).removeprefix("torch."), out0.numel()] += 1
        return real(folds, op, sources_tile)

    saved = [m.reduce_sources for m in modules]
    for m in modules:
        m.reduce_sources = probe
    try:
        yield seen
    finally:
        for m, fn in zip(modules, saved):
            m.reduce_sources = fn


def describe_bodies(seen) -> str:
    """The counter of :func:`fold_bodies` as ``body W=.. dtype L=.. xN``."""
    return ", ".join(f"{body} W={w} {dt} L={length} x{k}" for
                     (body, w, dt, length), k in sorted(seen.items()))


def check_bodies(seen, what, tail) -> None:
    """Every launch on more than ``tail`` elements took the bulk-copy
    body (the sub-N tail's fold may take the element one)."""
    slow = [key for key in seen if key[0] == "element" and key[3] > tail]
    if slow:
        raise AssertionError(f"{what}: the fold kernel took its element "
                             f"body for {slow}")


def host_case(spec, n, chunks, count, codec, gen, dev, flat_mesh, cm, rs):
    """The same allreduce on the card and on host copies of its inputs
    (``reduce_sources`` there takes its plain fold, the encode runs on the
    CPU): bitwise, result and residual.  Returns the card run's fold
    launches by body (:func:`fold_bodies`); every one but the tail's took
    the bulk-copy body."""
    from flextree_tpu_torch.parallel import allreduce as ar

    xs = [torch.randn(count, generator=gen, device=dev) for _ in range(n)]
    with fold_bodies(rs, cm, ar) as seen:
        got = cm.compressed_allreduce(xs, flat_mesh(n, dev), spec, codec,
                                      chunks, CODEC_STEP,
                                      return_residual=True)
    host = cm.compressed_allreduce([x.cpu() for x in xs],
                                   flat_mesh(n, "cpu"), spec, codec, chunks,
                                   CODEC_STEP, return_residual=True)
    what = f"{codec} {spec} on {n} ranks, chunks={chunks}, {count} f32"
    if not all(same_bits(a.cpu(), b) for part, hpart in zip(got, host)
               for a, b in zip(part, hpart)):
        raise AssertionError(f"{what}: the card is not bitwise the host "
                             f"copies")
    check_bodies(seen, what, n)
    return seen


def phase_codec_collectives(dev, param_count, flat_mesh, cm, bk, rs):
    """Phase 17(a): every case of ``CODEC_CASES`` in both codecs at the
    gradient's count, the host check at ``HOST_COUNT``, the halves and the
    wire residual on a block-aligned buffer, and the floor-rounding
    control."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    for codec in ("int8", "bf16"):
        for spec, n, chunks, extra in CODEC_CASES:
            r = codec_case(spec, n, chunks, param_count + extra, codec, gen,
                           dev, flat_mesh, cm, bk, rs)
            bodies = host_case(spec, n, chunks, HOST_COUNT + extra, codec,
                               gen, dev, flat_mesh, cm, rs)
            log(f"phase 17 {codec} {spec} on {n} ranks, chunks={chunks}, "
                f"{param_count + extra} f32 a rank: ranks bitwise equal; "
                f"max error {r['err']:.4g} <= bound {r['bound']:.4g} "
                f"({r['err'] / r['bound']:.3f} of it); the last rank dropped "
                f"{r['dropped']:.4g} > bound; mean error {r['mean']:.3g}, "
                f"rms {r['rms']:.4g}"
                + (f" (unbiased at {BIAS_SIGMAS} sigma)" if codec == "int8"
                   else "") + "; fold "
                f"launches {r['launches']} as derived; wall "
                f"{r['wall_ms']:.3f} ms (one call, cold); at "
                f"{HOST_COUNT + extra} f32 bitwise the same call on host "
                f"copies (result and residual), the card's folds "
                f"{describe_bodies(bodies)}")
            torch.cuda.empty_cache()
    # the halves and the wire residual on a block-aligned buffer
    mesh = flat_mesh(8, dev)
    xs = [torch.randn(ALIGNED_COUNT, generator=gen, device=dev)
          for _ in range(8)]
    for spec in ("4,2", "8"):
        full, res = cm.compressed_allreduce(xs, mesh, spec, "int8", 1,
                                            CODEC_STEP, return_residual=True)
        shard = cm.compressed_reduce_scatter(xs, mesh, spec, "int8",
                                             CODEC_STEP)
        back = cm.compressed_all_gather(shard, mesh, spec, (ALIGNED_COUNT,),
                                        "int8", CODEC_STEP)
        if not all(torch.equal(a, b) for a, b in zip(full, back)):
            raise AssertionError(f"{spec}: all_gather(reduce_scatter(x)) is "
                                 f"not bitwise the allreduce")
        if not all(same_bits(r, cm.local_residual(x, "int8", CODEC_STEP))
                   for r, x in zip(res, xs)):
            raise AssertionError(f"{spec}: the wire residual is not bitwise "
                                 f"the local map's")
        log(f"phase 17 {spec} on 8 ranks, {ALIGNED_COUNT} f32 (block-"
            f"aligned): compressed_all_gather(compressed_reduce_scatter(x)) "
            f"bitwise compressed_allreduce(x) on every rank; the wire "
            f"residual bitwise local_residual(x)")
        del full, res, shard, back
    del xs
    torch.cuda.empty_cache()
    # the control: rounding to floor (no u) on the flat tree
    import flextree_tpu_torch.parallel.compressed as cmod

    xs = [torch.randn(param_count, generator=gen, device=dev)
          for _ in range(8)]
    exact = exact_sum(xs)
    real_u = cmod._uniform01
    stats = {}
    for name, u in (("stochastic", real_u),
                    ("floor", lambda n, step, salt, device: torch.zeros(
                        n, device=device))):
        cmod._uniform01 = u
        try:
            out = cm.compressed_allreduce(xs, mesh, "8", "int8", 1,
                                          CODEC_STEP)
        finally:
            cmod._uniform01 = real_u
        stats[name] = bias_stats(out[0], exact)
    if not unbiased(*stats["stochastic"], param_count) or \
            unbiased(*stats["floor"], param_count):
        raise AssertionError(f"bias check: {stats}")
    wire = cm.get_codec("int8").wire_bytes(param_count)
    f32 = cm.get_codec("f32").wire_bytes(param_count)
    log(f"phase 17 bias (8 on 8 ranks, {param_count} f32): stochastic "
        f"rounding mean error {stats['stochastic'][0]:.3g}, rms "
        f"{stats['stochastic'][1]:.4g}: within {BIAS_SIGMAS} rms/sqrt(count)"
        f" = {BIAS_SIGMAS * stats['stochastic'][1] / param_count ** 0.5:.3g}"
        f"; the floor control mean {stats['floor'][0]:.4g}, rms "
        f"{stats['floor'][1]:.4g}: fails it, as it must; wire bytes a rank "
        f"int8 {wire} against f32 {f32} (ratio {wire / f32:.4f})")


def check_codec_sync(codec, shapes, dev, flat_mesh, tm, bk, cm, rs):
    """Phase 17(b), one codec: the DP train step's lossy sync (its specs,
    axes and planned buckets, ``return_residual``) of seeded per-rank
    gradients on the card, then on host copies with the card's plan (the
    cap set to its largest bucket), where ``reduce_sources`` takes its
    plain fold and the encode runs on the CPU: result and residual
    bitwise.  Returns the plan and the card's fold launches by body."""
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        param_specs,
    )
    from flextree_tpu_torch.parallel import allreduce as ar

    gen = torch.Generator(device=dev).manual_seed(SEED + 172)
    pspecs = param_specs(TransformerConfig(**MODEL), tm.AXIS_NAMES[-1])
    leaves = tm.tree_leaves(shapes)
    specs = bk.spec_leaves(shapes, pspecs)
    sizes = {"dp": DP, "sp": 1, "tp": 1}
    topos = tm.resolve_axis_topos(sizes, tm.AXIS_NAMES, None)
    plan = bk.plan_buckets(leaves, specs, tm.AXIS_NAMES, topos=topos,
                           axis_sizes=sizes, codec=codec)
    trees = [tm.tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                               device=dev), shapes)
             for _ in range(DP)]
    kw = dict(codec=codec, step=CODEC_STEP, return_residual=True)
    with fold_bodies(rs, cm, ar) as seen:
        got = tm.sync_grads(trees, pspecs, tm.AXIS_NAMES, topos,
                            bucket_bytes=None, comm=flat_mesh(DP, dev, "dp"),
                            **kw)
    host = [tm.tree_map(lambda g: g.cpu(), t) for t in trees]
    del trees
    cap = max(b.nbytes for b in plan)
    what = f"{codec} sync of the flagship gradient on {DP} ranks"
    if bk.plan_buckets(tm.tree_leaves(host[0]), specs, tm.AXIS_NAMES,
                       topos=topos, axis_sizes=sizes, bucket_bytes=cap,
                       codec=codec) != plan:
        raise AssertionError(f"{what}: the host plan differs from the card's")
    plain = tm.sync_grads(host, pspecs, tm.AXIS_NAMES, topos,
                          bucket_bytes=cap, comm=flat_mesh(DP, "cpu", "dp"),
                          **kw)
    if not all(trees_identical([tm.tree_map(lambda g: g.cpu(), t)
                                for t in part], hpart, tm.tree_leaves)
               for part, hpart in zip(got, plain)):
        raise AssertionError(f"{what}: the card is not bitwise the host "
                             f"copies (result or residual)")
    check_bodies(seen, what, DP)
    return plan, seen


def phase_codec_sync(dev, shapes, flat_mesh, tm, bk, harness, cm, rs):
    """Phase 17(b): the grad-sync bench with both codecs' fused rows; the
    DP step's int8 and bf16 syncs bitwise on host copies; the int8
    bucketed sync under ``torch.profiler`` (one ``ftq_bucket*`` range a
    bucket); encode and decode alone on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flextree_tpu_torch.ops.quantize import decode_int8, encode_int8

    leaves = tm.tree_leaves(shapes)
    bench = harness.run_grad_sync_bench(harness.GradSyncBenchConfig(
        shapes=tuple(tuple(g.shape) for g in leaves), devices=DP, repeat=10,
        device=str(dev), codecs=("bf16", "int8")))
    rows = bench["rows"]
    for codec in ("bf16", "int8"):
        if not rows[f"ours_fused_{codec}"]["err_over_bound"] <= 1:
            raise AssertionError(f"{codec} fused sync over its bound")
    log(f"phase 17 grad-sync bench (flagship gradient, {DP} ranks, "
        f"{bench['topo']}, in turns, {bench['config']['repeat']} rounds; "
        f"printed, not gated): " + "; ".join(
            f"{k} median {r['median_ms']:.3f} ms, min {r['min_ms']:.3f} ms"
            + (f", err/bound {r['err_over_bound']:.3f}"
               if "err_over_bound" in r else "")
            for k, r in rows.items()))
    # the fold kernel against its plain version at the DP codec path's
    # shapes
    for codec in ("int8", "bf16"):
        plan, bodies = check_codec_sync(codec, shapes, dev, flat_mesh, tm,
                                        bk, cm, rs)
        log(f"phase 17 {codec} sync as the DP step runs it (flagship "
            f"gradient, {DP} ranks, {len(plan)} buckets of "
            f"{[b.nbytes for b in plan]} B): result and residual bitwise "
            f"the same sync on host copies with the card's plan; the card's "
            f"folds {describe_bodies(bodies)}")
        torch.cuda.empty_cache()
    # one int8 bucketed sync under the profiler
    gen = torch.Generator(device=dev).manual_seed(SEED + 171)
    trees = [tm.tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                               device=dev), shapes)
             for _ in range(DP)]
    mesh = flat_mesh(DP, dev, "dp")
    topos = tm.resolve_axis_topos(mesh, ("dp",), None)
    plan = bk.plan_buckets(leaves, [None] * len(leaves), ("dp",),
                           topos=topos, axis_sizes={"dp": DP}, codec="int8")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tm.sync_grads(trees, None, ("dp",), topos, bucket_bytes=None,
                      codec="int8", step=CODEC_STEP, comm=mesh)
        torch.cuda.synchronize()
    ranges = sum(1 for e in prof.events() if e.name.startswith("ftq_bucket")
                 and e.device_type == DeviceType.CPU)
    if ranges != len(plan):
        raise AssertionError(f"{ranges} ftq_bucket ranges for {len(plan)} "
                             f"buckets")
    del trees
    # encode and decode alone, at the gradient's count
    count = sum(g.numel() for g in leaves)
    x = torch.randn(count, generator=gen, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    q, s = encode_int8(x, CODEC_STEP)
    enc_ms = time_launches(lambda: encode_int8(x, CODEC_STEP), 10, flush)
    dec_ms = time_launches(lambda: decode_int8(q, s, count), 10, flush)
    rt_ms = time_launches(lambda: decode_int8(*encode_int8(x, CODEC_STEP),
                                              count), 10, flush)
    rate = 2 * 4 * count / (rt_ms * 1e-3) / 1e9
    log(f"phase 17 int8 codec alone ({count} f32, a cold L2, CUDA events): "
        f"encode {enc_ms:.4f} ms, decode {dec_ms:.4f} ms, encode+decode "
        f"{rt_ms:.4f} ms = {rate:.2f} GB/s a pass over the f32 bytes (two "
        f"passes, the cost model's codec_bw_GBps); {len(plan)} int8 buckets "
        f"of {[b.nbytes for b in plan]} B, one ftq_bucket range each under "
        f"the profiler")


def block_steps(x, rows: int, block: int):
    """One quantization step of each element's block where the wire's
    stage-0 encode puts it: the head of ``x`` as ``rows`` rows, each
    padded to whole blocks; ``amax / 127`` of its block."""
    head = (x.numel() // rows) * rows
    v = x[:head].view(rows, -1)
    width = v.shape[1]
    amax = F.pad(v.abs(), (0, (-width) % block)).view(rows, -1, block) \
        .amax(-1)
    return (amax / 127).repeat_interleave(block, 1)[:, :width].reshape(-1)


def phase_dp_codec(dev, fa, trainer, ckpt, flat_mesh, tm, bk, rs):
    """Phase 17(c): the DP train step with the int8 codec through
    ``trainer.main --mesh 8,1,1 --codec int8`` (then bf16 for a few
    steps), the flash and fold counts set to 0 just before each run and
    read just after; each bucket's last inputs and residuals recorded to
    hold the residuals to one quantization step of their block; then the
    int8 and f32 steps in turns.  Returns the int8 run's launches."""
    import tempfile

    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_specs,
    )

    cfg = TransformerConfig(**MODEL)
    shapes = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device=dev)
    leaves = tm.tree_leaves(shapes)
    axes = tm.AXIS_NAMES
    sizes = {"dp": DP, "sp": 1, "tp": 1}
    topos = tm.resolve_axis_topos(sizes, axes, None)
    specs = bk.spec_leaves(shapes, param_specs(cfg))
    b, t = FLASH_TRAIN[:2]
    layers = MODEL["n_layers"]
    out_launches = None
    for codec, argv, steps in (("int8", DP_CODEC_ARGV, DP_CODEC_STEPS),
                               ("bf16", DP_BF16_ARGV, DP_BF16_STEPS)):
        # place a probe on the sync's collective: the last call of each
        # bucket's input and residual, the step's grad + ef and new ef
        plan = bk.plan_buckets(leaves, specs, axes, topos=topos,
                               axis_sizes=sizes, codec=codec)
        per_step = stage_launches(bk.sync_fold_stages(
            [g.numel() for g in leaves], DP, topos["dp"], plan, codec=codec),
            rs.MAX_POINTERS)
        calls = []
        real = bk.compressed_allreduce

        def probe(x, comm, **kw):
            got = real(x, comm, **kw)
            if kw.get("return_residual"):
                calls.append((x, got[1]))
                del calls[:-len(plan)]
            return got

        with tempfile.TemporaryDirectory(prefix="ft-dpq-") as ckpt_dir:
            out: dict = {}
            bk.compressed_allreduce = probe
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_flash_counts(fa)
                rs.reduce_sources.launches = 0
                t0 = time.monotonic()
                trainer.main(argv + ["--ckpt-dir", ckpt_dir], out=out)
                torch.cuda.synchronize()
                wall_s = time.monotonic() - t0
                launches = flash_counts(fa)
                launches["reduce_sources"] = rs.reduce_sources.launches
            finally:
                bk.compressed_allreduce = real
            peak = torch.cuda.max_memory_allocated()
            res = out["result"]
            losses = [loss for _, loss in res.losses]
            what = f"dp {codec}"
            if len(losses) != steps or not all(np.isfinite(losses)) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"{what}: losses not finite and "
                                     f"falling: {losses}")
            want = steps * layers * DP
            if any(launches[k] != want for k in flash_counts(fa)):
                raise AssertionError(f"{what}: flash launches {launches} != "
                                     f"steps x layers x dp = {want}")
            if launches["reduce_sources"] != steps * per_step:
                raise AssertionError(
                    f"{what}: fold launches {launches['reduce_sources']} != "
                    f"{steps} steps x {per_step} (the lossy plan's)")
            efs = res.state["ef"]
            saved = ckpt.restore_train_state(ckpt_dir, dev)
            live = dict(res.state, ef=efs[0])
            if set(saved) != set(live) or not all(
                    a.dtype == b_.dtype and torch.equal(a, b_) for a, b_ in
                    zip(tm.tree_leaves(live), tm.tree_leaves(saved))):
                raise AssertionError(f"{what}: the checkpoint is not the live "
                                     f"state (ef: the first rank's) bitwise")
            if len(efs) != DP or not all(
                    any(e.any() for e in tm.tree_leaves(ef)) for ef in efs):
                raise AssertionError(f"{what}: a rank's residual is zero")
            if len(calls) != len(plan):
                raise AssertionError(f"{what}: {len(calls)} recorded bucket "
                                     f"calls for {len(plan)} buckets")
            worst = 0.0
            for xs, rs_ in calls:
                for x, e in zip(xs, rs_):
                    # int8: the wire's stage-0 blocks (the tail is exact);
                    # bf16: the cast's half ulp, every element
                    bar = block_steps(x, DP, 1024) if codec == "int8" else \
                        x.abs() * 2.0 ** -8
                    head = bar.numel()
                    if not (e[:head].abs() <= bar).all() or e[head:].any():
                        raise AssertionError(f"{what}: a residual over one "
                                             f"quantization step")
                    worst = max(worst, float((e[:head].abs() /
                                              bar.clamp(min=1e-30)).max()))
            del calls
        log(f"phase 17 dp {codec} (flagship, bf16, flash, global batch {b} x "
            f"{t}, {DP} in-process ranks, {len(plan)} buckets of "
            f"{[p.nbytes for p in plan]} B, grad_topo {topos['dp']}): {steps} "
            f"steps in {wall_s:.3f} s via trainer.main; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; flash launches "
            f"{ {k: launches[k] for k in flash_counts(fa)} } = {steps} steps "
            f"x {layers} layers x {DP} ranks; fold launches "
            f"{launches['reduce_sources']} = {steps} x {per_step} (the lossy "
            f"plan's); checkpoint = live state bitwise, ef the first rank's; "
            f"every rank's ef non-zero, each element within one quantization "
            f"step of its block (worst {worst:.4f} of it); peak memory "
            f"{peak / 2**30:.3f} GiB")
        if codec == "int8":
            out_launches, state = launches, res.state
            model_cfg, tc = out["model_cfg"], out["train_cfg"]
        del res, out, efs, saved, live
        torch.cuda.empty_cache()
    # steady steps, int8 and the f32 codec, on the same global batch, in
    # turns
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    mesh = flat_mesh(DP, dev, "dp")
    steps = {"int8": tm.make_train_step(model_cfg, tc, comm=mesh),
             "f32": tm.make_train_step(model_cfg, dataclasses.replace(
                 tc, codec="f32"), comm=mesh)}
    states = {"int8": state, "f32": {k: v for k, v in state.items()
                                     if k != "ef"}}
    times = {k: [] for k in steps}
    for i in range(DP_TIMED + 2):
        for name, step in (list(steps.items()) if i % 2 else
                           list(steps.items())[::-1]):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            _, m = step(states[name], data[0], data[1])
            float(m["loss"])
            times[name].append(time.monotonic() - t1)
    med = {k: float(np.median(v[2:])) * 1e3 for k, v in times.items()}
    log(f"phase 17 dp=8 steady step (median of {DP_TIMED}, in turns; printed,"
        f" not gated): int8 {med['int8']:.3f} ms = "
        f"{b * t / med['int8'] * 1e3:.0f} tokens/s, f32 codec "
        f"{med['f32']:.3f} ms = {b * t / med['f32'] * 1e3:.0f} tokens/s")
    del steps, states, state
    torch.cuda.empty_cache()
    return out_launches


def phase_ef(dev, flat_mesh, cm):
    """Phase 17(d): the JAX ``test_constant_gradient_running_mean_converges``
    on the card, 8 ranks with ``8``, at ``EF_COUNT`` elements."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 173)
    g = torch.randn(EF_COUNT, generator=gen, device=dev)
    n = 8
    exact = n * g.double()
    bound = codec_bound(cm, "int8", n, "8", float(g.abs().max()))
    mesh = flat_mesh(n, dev)
    e = torch.zeros_like(g)
    acc = torch.zeros_like(exact)
    errs = {}
    for step in range(1, EF_STEPS + 1):
        x = g + e
        out, res = cm.compressed_allreduce([x] * n, mesh, "8", "int8", 1,
                                           step, return_residual=True)
        acc += out[0].double()
        e = res[0]
        errs[step] = float((acc / step - exact).abs().max())
        if not float(e.abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6:
            raise AssertionError(f"EF step {step}: a residual over one step")
    if not (errs[1] <= bound + 1e-5 and errs[EF_STEPS] < errs[1] / 8
            and errs[EF_STEPS] < bound / 10):
        raise AssertionError(f"EF does not converge: {errs}, bound {bound}")
    log(f"phase 17 EF ({EF_COUNT} f32, 8 on 8 ranks, {EF_STEPS} steps of a "
        f"constant gradient): single-shot error {errs[1]:.4g} <= bound "
        f"{bound:.4g}; the running mean's error {errs[EF_STEPS]:.4g} < "
        f"1/8 of step 1's and < bound/10")


def phase_codec(dev, fa, trainer, ckpt):
    """Phase 17: (a) the compressed collectives, (b) the sync and the
    bench, (c) the DP train step with error feedback, (d) EF convergence.
    Returns the fold kernel's launches by path: ``codec`` over (a) and
    (d), the compressed collectives; ``codec_sync`` over (b), the bench's
    rows (float32 and both codecs, in turns) and the lossy bucketed
    syncs; and (c)'s int8 run's launches by kernel (``dp_codec``)."""
    from flextree_tpu_torch.bench import harness
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    shapes = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device=dev)
    param_count = sum(g.numel() for g in tm.tree_leaves(shapes))
    launches = {}
    torch.cuda.synchronize()
    rs.reduce_sources.launches = 0
    clock = time.monotonic()
    phase_codec_collectives(dev, param_count, flat_mesh, cm, bk, rs)
    torch.cuda.synchronize()
    launches["codec"] = rs.reduce_sources.launches
    log(f"phase 17(a): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    rs.reduce_sources.launches = 0
    phase_codec_sync(dev, shapes, flat_mesh, tm, bk, harness, cm, rs)
    torch.cuda.synchronize()
    launches["codec_sync"] = rs.reduce_sources.launches
    log(f"phase 17(b): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    rs.reduce_sources.launches = 0
    phase_ef(dev, flat_mesh, cm)
    torch.cuda.synchronize()
    launches["codec"] += rs.reduce_sources.launches
    log(f"phase 17(d): {time.monotonic() - clock:.1f} s")
    del shapes
    torch.cuda.empty_cache()
    clock = time.monotonic()
    dp_launches = phase_dp_codec(dev, fa, trainer, ckpt, flat_mesh, tm, bk,
                                 rs)
    log(f"phase 17(c): {time.monotonic() - clock:.1f} s")
    return launches, dp_launches


# phase 18: readiness-ordered backward/comm overlap
OVL_ARGV = DP_ARGV + ["--overlap"]  # 20 steps, a checkpoint every 10
OVL_INT8_STEPS = 2
OVL_BENCH_REPEAT = 5
OVL_RATE_REPS = 10
# GPU cycles (~50 ms) the card spins before the timed backward of 18(e):
# the host enqueues the whole backward while the card is busy, so the
# events time the card's work and not the host's dispatch
BWD_HEAD_START_CYCLES = 100_000_000


def overlap_fold_launches(ov, bk, tm, rs, plan, params, pspecs, topos,
                          sizes, codec=None) -> int:
    """Fold-kernel launches of one overlapped step's sync: over its fired
    buckets (:func:`fired_payloads`), each bucket's inner plan, planned as
    ``bucketed_sync_grads`` plans it."""
    total = 0
    for tree, specs in zip(ov.fired_payloads(plan, params),
                           ov.fired_payloads(plan, pspecs)):
        leaves = tm.tree_leaves(tree)
        inner = bk.plan_buckets(leaves, bk.spec_leaves(tree, specs),
                                tm.AXIS_NAMES, topos=topos, axis_sizes=sizes,
                                codec=codec)
        total += stage_launches(bk.sync_fold_stages(
            [g.numel() for g in leaves], DP, topos["dp"], inner,
            codec=codec), rs.MAX_POINTERS)
    return total


def check_fired_syncs(ov, tm, bk, cm, rs, plan, shapes, pspecs, topos,
                      sizes, tc, dev, flat_mesh, codec=None):
    """Phase 18(b), one codec: every fired bucket's sync as the overlapped
    step runs it (``_sync_fired_bucket`` on the bucket's payload,
    :func:`fired_payloads`, under the step's train config) on seeded
    per-rank gradients (and, lossy, residuals) on the card, its folds
    counted by body (:func:`fold_bodies`); then on host copies with the
    card's inner plan (the cap set to its largest bucket), where
    ``reduce_sources`` takes its plain fold and the encode runs on the CPU:
    result and residual bitwise, and every fold on more than DP elements
    in the bulk-copy body.  Returns each bucket's bytes, inner plan and
    folds by body."""
    from flextree_tpu_torch.parallel import allreduce as ar

    gen = torch.Generator(device=dev).manual_seed(SEED + 182)

    def rank_trees(scale):
        return [tm.tree_map(lambda p: scale * torch.randn(
            p.shape, generator=gen, device=dev), shapes) for _ in range(DP)]

    tc = dataclasses.replace(tc, codec=codec or "f32")
    grads = [ov.fired_payloads(plan, g) for g in rank_trees(1.0)]
    efs = [ov.fired_payloads(plan, e) for e in rank_trees(1e-3)] \
        if codec else None
    mesh, host_mesh = flat_mesh(DP, dev, "dp"), flat_mesh(DP, "cpu", "dp")
    out = []
    for bi, specs in enumerate(ov.fired_payloads(plan, pspecs)):
        trees = [g[bi] for g in grads]
        ef = [e[bi] for e in efs] if codec else None
        leaves = tm.tree_leaves(trees[0])
        nbytes = sum(g.numel() * g.element_size() for g in leaves)
        inner = bk.plan_buckets(leaves, bk.spec_leaves(trees[0], specs),
                                tm.AXIS_NAMES, topos=topos, axis_sizes=sizes,
                                bucket_bytes=tc.bucket_bytes, codec=codec)
        name = f"ft_overlap_bucket{bi}_check_{nbytes}B"
        what = (f"{codec or 'f32'} fired bucket {bi} "
                f"({list(plan.boundaries[bi])}, {nbytes} B a rank)")
        with fold_bodies(rs, cm, ar) as seen:
            got = ov._sync_fired_bucket(trees, specs, tm.AXIS_NAMES, topos,
                                        tc, CODEC_STEP, ef, name, comm=mesh)
        want = stage_launches(bk.sync_fold_stages(
            [g.numel() for g in leaves], DP, topos["dp"], inner,
            codec=codec), rs.MAX_POINTERS)
        if sum(seen.values()) != want:
            raise AssertionError(f"{what}: {sum(seen.values())} fold "
                                 f"launches, its inner plan derives {want}")
        cpu = [tm.tree_map(lambda g: g.cpu(), t) for t in trees]
        cap = max(b.nbytes for b in inner)
        if bk.plan_buckets(tm.tree_leaves(cpu[0]),
                           bk.spec_leaves(cpu[0], specs), tm.AXIS_NAMES,
                           topos=topos, axis_sizes=sizes, bucket_bytes=cap,
                           codec=codec) != inner:
            raise AssertionError(f"{what}: the host plan differs from the "
                                 f"card's")
        plain = ov._sync_fired_bucket(
            cpu, specs, tm.AXIS_NAMES, topos,
            dataclasses.replace(tc, bucket_bytes=cap), CODEC_STEP,
            None if ef is None else
            [tm.tree_map(lambda g: g.cpu(), e) for e in ef],
            name, comm=host_mesh)
        parts = [p for p in zip(got, plain) if p[0] is not None]
        if len(parts) != (2 if codec else 1) or not all(
                trees_identical([tm.tree_map(lambda g: g.cpu(), t)
                                 for t in card], host, tm.tree_leaves)
                for card, host in parts):
            raise AssertionError(f"{what}: the card is not bitwise the host "
                                 f"copies (result or residual)")
        check_bodies(seen, what, DP)
        out.append((nbytes, inner, seen))
        del trees, ef, got, cpu, plain, parts
    return out


def describe_plan(plan) -> str:
    return (f"labels {list(plan.labels)}, boundaries "
            f"{[list(b) for b in plan.boundaries]}, seg_bytes "
            f"{list(plan.seg_bytes)}, seg_compute_us "
            f"{[round(u, 3) for u in plan.seg_compute_us]}, predicted total "
            f"{plan.predicted_total_us:.3f} us, exposed "
            f"{plan.predicted_exposed_us:.3f} us")


def stream_overlap(trace_path, steps: int):
    """From a chrome trace of ``steps`` train steps: the streams of the
    fold kernel's and the flash backward's launches; the ms of fold
    launches, and of every launch on the fold's streams (the fired
    buckets' folds, copies and packing), that overlap a flash backward
    launch in time; and for each step (the launches split evenly in time
    order) how long its first fold started before its last flash backward
    launch started (``lead_ms``) and after that launch ended
    (``after_ms``): an overlapped step fires its first bucket while its
    backward still runs, the serialized twin after it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    bwd = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev
                 if "flash_bwd" in e["name"])
    folds = [e for e in dev if "fold_kernel" in e["name"]]
    fold_streams = {e["args"]["stream"] for e in folds}
    bwd_streams = {e["args"]["stream"] for e in dev
                   if "flash_bwd" in e["name"]}
    merged: list = []
    for a, b in bwd:  # the union of the flash backward's intervals
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])

    def under(e):
        a, b = e["ts"], e["ts"] + e["dur"]
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)

    fold_starts = sorted(e["ts"] for e in folds)
    nb, nf = len(bwd) // steps, len(fold_starts) // steps
    if nb * steps != len(bwd) or nf * steps != len(fold_starts) or not nb:
        raise AssertionError(f"{len(bwd)} flash backward and "
                             f"{len(fold_starts)} fold launches do not split "
                             f"into {steps} steps")
    lead = [(bwd[(k + 1) * nb - 1][0] - fold_starts[k * nf]) / 1e3
            for k in range(steps)]
    after = [(fold_starts[k * nf] - bwd[(k + 1) * nb - 1][1]) / 1e3
             for k in range(steps)]
    side = [e for e in dev if e["args"].get("stream") in fold_streams]
    return {"folds": len(folds), "fold_streams": sorted(fold_streams),
            "bwd_streams": sorted(bwd_streams),
            "fold_ms": sum(e["dur"] for e in folds) / 1e3,
            "fold_under_ms": sum(under(e) for e in folds) / 1e3,
            "side_ms": sum(e["dur"] for e in side) / 1e3,
            "side_under_ms": sum(under(e) for e in side) / 1e3,
            "lead_ms": lead, "after_ms": after}


def phase_overlap(dev, fa, trainer, ckpt, smi):
    """Phase 18: (a) ``trainer.main --mesh 8,1,1 --overlap``, the flash and
    fold counts set to 0 just before and read just after; (b) the
    overlapped step, its twin and the production step bitwise in float32,
    the int8 overlapped step and its twin bitwise with every rank's ef,
    and each fired bucket's f32 and int8 sync bitwise its plain fold on
    host copies; (c) two overlapped steps and two of the twin under
    ``torch.profiler``: every fold on another stream than the flash
    backward, the overlapped step's first fold before its backward's last
    launch and the twin's after its end, and how much runs under it;
    (d) ``run_train_step_bench`` with its six rows; (e) the backward's
    rate against ``parallel/overlap.py``'s constant.  Returns (a)'s
    launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch.bench import harness
    from flextree_tpu_torch.models import transformer as tt
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import overlap as ov
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    cfg = tt.TransformerConfig(**MODEL)
    pspecs = tt.param_specs(cfg)
    b, t = FLASH_TRAIN[:2]
    layers = MODEL["n_layers"]
    mesh = flat_mesh(DP, dev, "dp")
    sizes = {"dp": DP, "sp": 1, "tp": 1}
    topos = tm.resolve_axis_topos(sizes, tm.AXIS_NAMES, None)
    init = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    plan = ov.plan_overlap(init["params"], pspecs, tm.AXIS_NAMES, topos,
                           sizes, n_tokens=b // DP * t, t_local=t,
                           d_model=cfg.d_model)
    per_step = overlap_fold_launches(ov, bk, tm, rs, plan, init["params"],
                                     pspecs, topos, sizes)
    log(f"phase 18 plan ({DP} ranks, grad_topo {topos['dp']}, bwd_GFLOPs "
        f"{ov.resolve_bwd_GFLOPs(None, dev):g}): {describe_plan(plan)}; "
        f"{per_step} fold launches a step")

    # ---- (a) the main path: trainer.main --mesh 8,1,1 --overlap
    clock = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="ft-ovl-") as ckpt_dir:
        out: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(fa)
        rs.reduce_sources.launches = 0
        t0 = time.monotonic()
        trainer.main(OVL_ARGV + ["--ckpt-dir", ckpt_dir], out=out)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = flash_counts(fa)
        launches["reduce_sources"] = rs.reduce_sources.launches
        peak = torch.cuda.max_memory_allocated()
        res = out["result"]
        losses = [loss for _, loss in res.losses]
        if len(losses) != DP_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"overlap: losses not finite and falling: "
                                 f"{losses}")
        if not out["train_cfg"].overlap:
            raise AssertionError("overlap: the trainer ran without it")
        want = DP_STEPS * layers * DP
        if any(launches[k] != want for k in flash_counts(fa)):
            raise AssertionError(f"overlap: flash launches {launches} != "
                                 f"steps x layers x dp = {want}")
        if launches["reduce_sources"] != DP_STEPS * per_step:
            raise AssertionError(
                f"overlap: fold launches {launches['reduce_sources']} != "
                f"{DP_STEPS} steps x {per_step} (the plan's)")
        saved = ckpt.restore_train_state(ckpt_dir, dev)
        if not all(a.dtype == b_.dtype and torch.equal(a, b_) for a, b_ in
                   zip(tm.tree_leaves(res.state), tm.tree_leaves(saved))):
            raise AssertionError("overlap: the checkpoint does not restore "
                                 "bitwise")
    state, model_cfg, tc = res.state, out["model_cfg"], out["train_cfg"]
    log(f"phase 18(a) overlap train (flagship, bf16, flash, global batch "
        f"{b} x {t}, {DP} in-process ranks, grad_topo {topos['dp']}): "
        f"{DP_STEPS} steps in {wall_s:.3f} s via trainer.main --overlap; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; flash launches "
        f"{ {k: launches[k] for k in flash_counts(fa)} } = {DP_STEPS} steps "
        f"x {layers} layers x {DP} ranks; fold launches "
        f"{launches['reduce_sources']} = {DP_STEPS} x {per_step} (the "
        f"plan's {plan.n_buckets} fired buckets); checkpoint restores "
        f"bitwise; peak memory {peak / 2**30:.3f} GiB; "
        f"{time.monotonic() - clock:.1f} s")
    del res, out, saved
    torch.cuda.empty_cache()

    # ---- (b) bits on the card
    clock = time.monotonic()
    dataset = data_mod.LMDataset(
        data_mod.synthetic_tokens(200_000, MODEL["vocab_size"], seed=SEED),
        batch=b, seq_len=t, seed=SEED)
    batches = [dataset.batch_at(i) for i in range(OVL_INT8_STEPS)]
    f32 = tt.TransformerConfig(**MODEL, dtype=torch.float32,
                               attn_impl="flash")
    prod_tc = tm.TrainConfig()
    ovl_tc = dataclasses.replace(prod_tc, overlap=True)
    # every fired sync runs where any host synchronization raises: a
    # blocking read would serialize the comm stream with the backward
    real_fire, fires = ov._sync_fired_bucket, []

    def no_host_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fires.append(True)
            return real_fire(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    got = {}
    ov._sync_fired_bucket = no_host_sync
    try:
        for name, tc_, ser in (("production", prod_tc, False),
                               ("overlapped", ovl_tc, False),
                               ("twin", ovl_tc, True)):
            got[name], _ = tm.make_train_step(f32, tc_, comm=mesh,
                                              serialize_overlap=ser)(
                init, *batches[0])
    finally:
        ov._sync_fired_bucket = real_fire
    for name in ("overlapped", "twin"):
        if not trees_identical([got["production"]], [got[name]],
                               tm.tree_leaves):
            raise AssertionError(f"f32 {name} step is not the production "
                                 f"step bitwise")
    del got
    int8_tc = dataclasses.replace(tc, codec="int8")
    lossy = {}
    ov._sync_fired_bucket = no_host_sync
    try:
        for name, ser in (("overlapped", False), ("twin", True)):
            st = tm.init_train_state(model_cfg, torch.Generator().manual_seed(
                SEED), int8_tc, device=dev)
            step = tm.make_train_step(model_cfg, int8_tc, comm=mesh,
                                      serialize_overlap=ser)
            for tokens, targets in batches:
                st, _ = step(st, tokens, targets)
            lossy[name] = st
    finally:
        ov._sync_fired_bucket = real_fire
    efs = lossy["overlapped"]["ef"]
    if not trees_identical([lossy["overlapped"]], [lossy["twin"]],
                           tm.tree_leaves):
        raise AssertionError("int8 overlapped step and its twin differ "
                             "(params or a rank's ef)")
    if len(efs) != DP or not all(any(e.any() for e in tm.tree_leaves(ef))
                                 for ef in efs):
        raise AssertionError("int8 overlap: a rank's residual is zero")
    log(f"phase 18(b) bits (full width, global batch {b} x {t}, {DP} "
        f"ranks): f32 flash, one step: overlapped = twin = production "
        f"bitwise (params, moments, step); int8 (bf16 compute, flash, "
        f"{OVL_INT8_STEPS} steps): overlapped = twin bitwise, every rank's "
        f"ef included, every rank's ef non-zero; {len(fires)} fired syncs, "
        f"none synchronized the host (sync debug mode 'error'); "
        f"{time.monotonic() - clock:.1f} s")
    del lossy, efs
    torch.cuda.empty_cache()
    # the fold kernel against its plain version at the fired buckets' own
    # shapes: each bucket's sync on the card and on host copies
    clock = time.monotonic()
    for codec in (None, "int8"):
        # the step plans the int8 buckets with the codec's wire prices
        cplan = plan if codec is None else ov.plan_overlap(
            init["params"], pspecs, tm.AXIS_NAMES, topos, sizes,
            n_tokens=b // DP * t, t_local=t, d_model=cfg.d_model,
            codec=codec)
        fired = check_fired_syncs(ov, tm, bk, cm, rs, cplan, init["params"],
                                  pspecs, topos, sizes, tc, dev, flat_mesh,
                                  codec)
        log(f"phase 18(b) {codec or 'f32'} fired syncs as the overlapped "
            f"step runs them (seeded gradients{', residuals' if codec else ''}"
            f", {DP} ranks, step {CODEC_STEP}): each bucket's result"
            f"{' and residual' if codec else ''} bitwise the same sync on "
            f"host copies with the card's inner plan (the plain fold); "
            + "; ".join(f"bucket {bi} {list(cplan.boundaries[bi])} "
                        f"({nbytes} B, {len(inner)} inner buckets): "
                        f"{describe_bodies(seen)}"
                        for bi, (nbytes, inner, seen) in enumerate(fired))
            + f"; {time.monotonic() - clock:.1f} s")
        del fired
        torch.cuda.empty_cache()

    # ---- (c) streams: two overlapped steps under torch.profiler, then
    # two of the twin
    clock = time.monotonic()
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)

    def traced(serialize):
        step = tm.make_train_step(model_cfg, tc, comm=mesh,
                                  serialize_overlap=serialize)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            step(state, data[0], data[1])[1]["loss"].item()
            prof.step()
            s = state
            for _ in range(2):
                s, m = step(s, data[0], data[1])
            float(m["loss"])
            torch.cuda.synchronize()
            prof.step()
        with tempfile.TemporaryDirectory(prefix="ft-ovl-trace-") as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            return stream_overlap(path, 2)

    so, twin = traced(False), traced(True)
    for what, got in (("overlapped", so), ("twin", twin)):
        if got["folds"] != 2 * per_step:
            raise AssertionError(f"streams, {what}: {got['folds']} fold "
                                 f"launches traced for 2 steps x {per_step}")
        if not got["bwd_streams"] or set(got["fold_streams"]) & \
                set(got["bwd_streams"]):
            raise AssertionError(f"streams, {what}: folds on "
                                 f"{got['fold_streams']}, the flash backward "
                                 f"on {got['bwd_streams']}")
    if not all(x > 0 for x in so["lead_ms"]):
        raise AssertionError(f"streams: an overlapped step's first fold did "
                             f"not start before its last flash backward "
                             f"launch: leads {so['lead_ms']} ms")
    if not all(x >= 0 for x in twin["after_ms"]):
        raise AssertionError(f"streams: the twin's first fold started before "
                             f"its backward ended: {twin['after_ms']} ms")
    log(f"phase 18(c) streams (2 overlapped steps, then 2 of the twin, under "
        f"torch.profiler): {so['folds']} fold launches, all on stream(s) "
        f"{so['fold_streams']}, the flash backward on {so['bwd_streams']}; "
        f"each overlapped step's first fold started "
        f"{[round(x, 3) for x in so['lead_ms']]} ms before its last flash "
        f"backward launch, each twin step's "
        f"{[round(x, 3) for x in twin['after_ms']]} ms after its backward's "
        f"end; overlapped: fold kernels {so['fold_ms']:.3f} ms, of it "
        f"{so['fold_under_ms']:.3f} ms under a flash backward kernel; "
        f"everything on the fold's stream (folds, copies, packing) "
        f"{so['side_ms']:.3f} ms, of it {so['side_under_ms']:.3f} ms under "
        f"one (a measurement, not a bar); {time.monotonic() - clock:.1f} s")
    del state
    torch.cuda.empty_cache()

    # ---- (d) the train-step bench, six rows in turns
    clock = time.monotonic()
    bench = harness.run_train_step_bench(harness.TrainStepBenchConfig(
        n_layers=layers, d_model=MODEL["d_model"], d_ff=MODEL["d_ff"],
        n_heads=MODEL["n_heads"], vocab_size=MODEL["vocab_size"], batch=b,
        seq_len=t, devices=DP, repeat=OVL_BENCH_REPEAT, overlap=True,
        device=str(dev)))
    rows = bench["rows"]
    ovl_row = rows["ours_overlapped"]
    log(f"phase 18(d) train-step bench (flagship, bf16, flash, {DP} ranks, "
        f"{OVL_BENCH_REPEAT} rounds in turns; {smi}; printed, not gated; "
        f"all steps bitwise the per-leaf step): " + "; ".join(
            f"{k} median {r['train_step_median_ms']:.3f} ms (min "
            f"{r['train_step_ms']:.3f})"
            + (f", sync {r['sync_ms']:.3f} ms, exposed "
               f"{r['exposed_comm_ms']:.3f} ms, hidden "
               f"{r['hidden_comm_ms']:.3f} ms" if "sync_ms" in r else "")
            for k, r in rows.items())
        + f"; the twin's exposure {rows['ours_overlap_serialized']['exposed_comm_ms']:.3f}"
        f" ms = {ovl_row['exposed_vs_serialized']:.3f}x the overlapped "
        f"row's; {time.monotonic() - clock:.1f} s")
    torch.cuda.empty_cache()

    # ---- (e) the backward's rate, one rank's share
    clock = time.monotonic()
    tokens = torch.as_tensor(data[0][:b // DP], device=dev)
    targets = torch.as_tensor(data[1][:b // DP], device=dev)
    params = init["params"]
    flops = sum(ov.segment_flops(path, params, tokens.numel(),
                                 MODEL["d_model"], t)
                for _, path in ov.readiness_segments(params))
    times = []
    for i in range(OVL_RATE_REPS + 2):
        with torch.enable_grad():
            leaves = tm.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
            loss_sum, _ = tt.cross_entropy_loss(
                tt.forward(leaves, tokens.long(), model_cfg), targets)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BWD_HEAD_START_CYCLES)
        start.record()
        torch.autograd.grad(loss_sum / (b * t), tm.tree_leaves(leaves))
        end.record()
        if start.query():
            raise AssertionError("18(e): the head start ended before the "
                                 "backward was enqueued")
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    bwd_ms = float(np.median(times[2:]))
    rate = flops / (bwd_ms / 1e3) / 1e9
    log(f"phase 18(e) backward of one rank's share (B={b // DP}, T={t}, "
        f"bf16, flash; CUDA events, median of {OVL_RATE_REPS}): "
        f"{bwd_ms:.4f} ms for {flops / 1e9:.3f} GFLOP of segment_flops = "
        f"{rate:.1f} GFLOP/s; parallel/overlap.py's constant "
        f"{ov._BWD_GFLOPS_DEFAULTS['cuda']:g} GFLOP/s; {smi}; "
        f"{time.monotonic() - clock:.1f} s")
    return launches


# phase 19: ZeRO-1, the sharded optimizer, on 8 ranks
ZERO_ARGV = DP_ARGV + ["--shard-optimizer"]  # 20 steps, a checkpoint every 10
ZERO_BITS_STEPS = 3
ZERO_INT8_STEPS = 4
ZERO_BENCH_REPEAT = 3


def zero_plan(bk, tm, rs, leaves, specs, topos, sizes, codec=None, n=DP):
    """The ZeRO-1 sync's bucket plan (``plan_buckets(sharded=True)``, as
    ``zero_reduce_scatter_grads`` plans it) and its fold stages and
    fold-kernel launches a step, over ``n`` data-parallel ranks."""
    plan = bk.plan_buckets(leaves, specs, tm.AXIS_NAMES, topos=topos,
                           axis_sizes=sizes, codec=codec, sharded=True)
    stages = bk.sync_fold_stages([g.numel() for g in leaves], n,
                                 topos["dp"], plan, codec=codec,
                                 sharded=True)
    return plan, stages, stage_launches(stages, rs.MAX_POINTERS)


def shards_identical(a_trees, b_trees, leaves) -> bool:
    """Every rank's :class:`ZeroShard` trees bitwise: blocks and tails."""
    return all(same_bits(x.tile.cpu(), y.tile) and same_bits(x.tail.cpu(),
                                                              y.tail)
               for ta, tb in zip(a_trees, b_trees)
               for x, y in zip(leaves(ta), leaves(tb)))


def check_zero_syncs(zero, tm, bk, cm, rs, shapes, pspecs, topos, sizes,
                     dev, flat_mesh, codec=None, n=DP):
    """Phase 19(c), one codec: the step's sharded reduce-scatter
    (``zero_reduce_scatter_grads`` with the step's plan) of seeded per-rank
    gradients on the card, its folds counted by body
    (:func:`fold_bodies`) against the plan's launches; then on host copies
    with the card's plan (the cap set to its largest bucket), where
    ``reduce_sources`` takes its plain fold and the encode runs on the
    CPU: every rank's blocks and tails, and under int8 its residual,
    bitwise.  ``n`` data-parallel ranks.  Returns the plan, its stages and
    the folds by body."""
    from flextree_tpu_torch.parallel import allreduce as ar

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    trees = [tm.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=dev), shapes) for _ in range(n)]
    leaves = tm.tree_leaves(trees[0])
    specs = bk.spec_leaves(trees[0], pspecs)
    plan, stages, want = zero_plan(bk, tm, rs, leaves, specs, topos, sizes,
                                   codec, n)
    kw = dict(codec=codec or "f32", step=CODEC_STEP,
              return_residual=codec is not None)
    with fold_bodies(rs, cm, ar) as seen:
        got = zero.zero_reduce_scatter_grads(
            trees, pspecs, tm.AXIS_NAMES, topos,
            comm=flat_mesh(n, dev, "dp"), **kw)
    what = f"{codec or 'f32'} sharded reduce-scatter"
    if sum(seen.values()) != want:
        raise AssertionError(f"{what}: {sum(seen.values())} fold launches, "
                             f"its plan derives {want}")
    host = [tm.tree_map(lambda g: g.cpu(), t) for t in trees]
    cap = max(b.nbytes for b in plan)
    if bk.plan_buckets(tm.tree_leaves(host[0]), specs, tm.AXIS_NAMES,
                       topos=topos, axis_sizes=sizes, bucket_bytes=cap,
                       codec=codec, sharded=True) != plan:
        raise AssertionError(f"{what}: the host plan differs from the card's")
    plain = zero.zero_reduce_scatter_grads(
        host, pspecs, tm.AXIS_NAMES, topos, comm=flat_mesh(n, "cpu", "dp"),
        bucket_bytes=cap, **kw)
    if codec is None:
        got, plain = (got, None), (plain, None)
    if not shards_identical(got[0], plain[0], tm.tree_leaves) or (
            codec and not trees_identical(
                [tm.tree_map(lambda g: g.cpu(), t) for t in got[1]],
                plain[1], tm.tree_leaves)):
        raise AssertionError(f"{what}: the card is not bitwise the host "
                             f"copies (blocks, tails or residual)")
    return plan, stages, seen


def phase_zero(dev, fa, trainer, ckpt, smi, dp_peak, bw):
    """Phase 19: (a) ``trainer.main --mesh 8,1,1 --shard-optimizer``, the
    flash and fold counts set to 0 just before and read just after, its
    consolidated checkpoint against the live state consolidated, a resume,
    and the live moment buffers' bytes a rank against
    ``zero_shard_bytes``; (b) float32 at full width, the replicated, the
    sharded and the overlapped sharded step bitwise (loss, params, the
    consolidated moments), every fired reduce-scatter under the sync debug
    mode "error", and ``trainer.main --shard-optimizer --codec int8
    --overlap`` with a non-zero ``ef`` and master; (c) the step's f32 and int8 reduce-scatter, and the f32 one
    on ``2,2,2``, on the card against host copies, bitwise, each fold's
    body printed, and the heaviest fold stage timed; (d)
    ``run_train_step_bench(sharded=True)``'s rows and the optimizer-state
    ratios, printed; (e) the phase programs of the shard topology checked.
    Returns (a)'s launches."""
    import tempfile

    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch.analysis import schedule_check as sc
    from flextree_tpu_torch.bench import harness
    from flextree_tpu_torch.models import transformer as tt
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import overlap as ov
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel import zero
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    cfg = tt.TransformerConfig(**MODEL)
    pspecs = tt.param_specs(cfg)
    b, t = FLASH_TRAIN[:2]
    layers = MODEL["n_layers"]
    mesh = flat_mesh(DP, dev, "dp")
    sizes = {"dp": DP, "sp": 1, "tp": 1}
    topos = tm.resolve_axis_topos(sizes, tm.AXIS_NAMES, None)
    shard_topo = zero.shard_topo(topos["dp"], DP)
    init = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    leaves = tm.tree_leaves(init["params"])
    plan, stages, per_step = zero_plan(
        bk, tm, rs, leaves, bk.spec_leaves(init["params"], pspecs), topos,
        sizes)
    layout = tm.zero_layout_for(mesh, init["params"], pspecs)
    log(f"phase 19 plan ({DP} ranks, shard topology {shard_topo}, block "
        f"permutation {layout.perm_for(topos, 'dp')}): {len(plan)} buckets "
        f"of {[p.nbytes for p in plan]} B, "
        f"{[len(p.indices) for p in plan]} leaves; fold stages a step "
        f"{stages} (R folds, W, L) = {per_step} launches")

    # ---- (a) the main path: trainer.main --mesh 8,1,1 --shard-optimizer
    clock = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="ft-zero-") as ckpt_dir:
        out: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(fa)
        rs.reduce_sources.launches = 0
        t0 = time.monotonic()
        trainer.main(ZERO_ARGV + ["--ckpt-dir", ckpt_dir], out=out)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = flash_counts(fa)
        launches["reduce_sources"] = rs.reduce_sources.launches
        peak = torch.cuda.max_memory_allocated()
        res = out["result"]
        losses = [loss for _, loss in res.losses]
        if len(losses) != DP_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"zero: losses not finite and falling: "
                                 f"{losses}")
        if not out["train_cfg"].shard_optimizer:
            raise AssertionError("zero: the trainer ran without it")
        want = DP_STEPS * layers * DP
        if any(launches[k] != want for k in flash_counts(fa)):
            raise AssertionError(f"zero: flash launches {launches} != "
                                 f"steps x layers x dp = {want}")
        if launches["reduce_sources"] != DP_STEPS * per_step:
            raise AssertionError(
                f"zero: fold launches {launches['reduce_sources']} != "
                f"{DP_STEPS} steps x {per_step} (the plan's)")
        pack, _ = trainer.sharded_hooks(mesh, out["model_cfg"],
                                        res.state["params"], out["train_cfg"])
        saved = ckpt.restore_train_state(ckpt_dir, dev)
        if set(saved) != {"params", "mu", "nu", "step"} or \
                not trees_identical([pack(res.state)], [saved],
                                    tm.tree_leaves):
            raise AssertionError("zero: the checkpoint is not the live state "
                                 "consolidated, bitwise")
        again: dict = {}
        argv = list(ZERO_ARGV)
        argv[argv.index("--steps") + 1] = str(DP_STEPS + 1)
        trainer.main(argv + ["--ckpt-dir", ckpt_dir], out=again)
        if again["result"].resumed_from != DP_STEPS or \
                again["result"].steps_run != 1:
            raise AssertionError("zero: the checkpoint did not resume")
    # the moment buffers a rank holds: its block of each shard buffer and
    # the whole tails
    live = sum(x.numel() * 4 // (DP if k.endswith("_shard") else 1)
               for k in ("mu_shard", "mu_tail", "nu_shard", "nu_tail")
               for x in tm.tree_leaves(res.state[k]))
    acct = zero.zero_shard_bytes(layout)
    if live != acct["sharded_bytes_per_rank"]:
        raise AssertionError(f"zero: {live} B of moments a rank live, "
                             f"zero_shard_bytes says {acct}")
    state, model_cfg, tc = res.state, out["model_cfg"], out["train_cfg"]
    log(f"phase 19(a) ZeRO-1 train (flagship, bf16, flash, global batch "
        f"{b} x {t}, {DP} in-process ranks): {DP_STEPS} steps in "
        f"{wall_s:.3f} s via trainer.main --shard-optimizer; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; flash launches "
        f"{ {k: launches[k] for k in flash_counts(fa)} } = {DP_STEPS} steps "
        f"x {layers} layers x {DP} ranks; fold launches "
        f"{launches['reduce_sources']} = {DP_STEPS} x {per_step} (the "
        f"sharded plan's); the checkpoint is the live state consolidated, "
        f"bitwise, and resumes (1 more step from step {DP_STEPS}); moments "
        f"a rank {live} B live = zero_shard_bytes' "
        f"{acct['sharded_bytes_per_rank']} B, against the replicated "
        f"{acct['replicated_bytes']} B (ratio {acct['ratio']:.4f}); peak "
        f"memory {peak / 2**30:.3f} GiB against phase 16's replicated "
        f"run's {dp_peak / 2**30:.3f} GiB (printed, not gated); "
        f"{time.monotonic() - clock:.1f} s")
    del res, out, again, saved, state
    torch.cuda.empty_cache()

    # ---- (b) bits at full width
    clock = time.monotonic()
    dataset = data_mod.LMDataset(
        data_mod.synthetic_tokens(200_000, MODEL["vocab_size"], seed=SEED),
        batch=b, seq_len=t, seed=SEED)
    batches = [dataset.batch_at(i) for i in range(ZERO_BITS_STEPS)]
    f32 = tt.TransformerConfig(**MODEL, dtype=torch.float32,
                               attn_impl="flash")
    real_fire, fires = ov._sync_fired_bucket, []

    def no_host_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fires.append(True)
            return real_fire(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    rep_tc = tm.TrainConfig()
    sh_tc = dataclasses.replace(rep_tc, shard_optimizer=True)
    got = {}
    ov._sync_fired_bucket = no_host_sync
    try:
        for name, tc_ in (("replicated", rep_tc), ("sharded", sh_tc),
                          ("sharded+overlap",
                           dataclasses.replace(sh_tc, overlap=True))):
            st = tm.init_train_state(f32, torch.Generator().manual_seed(SEED),
                                     tc_, device=dev, comm=mesh)
            step = tm.make_train_step(f32, tc_, comm=mesh)
            ls = []
            for tokens, targets in batches:
                st, m = step(st, tokens, targets)
                ls.append(m["loss"])
            got[name] = (st, ls)
    finally:
        ov._sync_fired_bucket = real_fire
    rep, rep_losses = got.pop("replicated")
    pack, _ = trainer.sharded_hooks(mesh, f32, rep["params"], sh_tc)
    for name, (st, ls) in got.items():
        if not all(same_bits(x, y) for x, y in zip(ls, rep_losses)):
            raise AssertionError(f"f32 {name}: losses are not the replicated "
                                 f"step's bitwise")
        if not trees_identical([pack(st)], [rep], tm.tree_leaves):
            raise AssertionError(f"f32 {name}: params or consolidated "
                                 f"moments are not the replicated step's "
                                 f"bitwise")
    if not fires:
        raise AssertionError("zero: the overlapped step fired nothing")
    del got, rep
    torch.cuda.empty_cache()
    # the int8 wires with overlap, through the trainer
    argv = list(ZERO_ARGV)
    argv[argv.index("--steps") + 1] = str(ZERO_INT8_STEPS)
    out = {}
    n_fires = len(fires)
    ov._sync_fired_bucket = no_host_sync
    try:
        trainer.main(argv + ["--codec", "int8", "--overlap"], out=out)
    finally:
        ov._sync_fired_bucket = real_fire
    st = out["result"].state
    int8_losses = [loss for _, loss in out["result"].losses]
    efs = st["ef"]
    if len(int8_losses) != ZERO_INT8_STEPS or len(fires) == n_fires or \
            not all(np.isfinite(int8_losses)) or len(efs) != DP or not all(
            any(e.any() for e in tm.tree_leaves(ef)) for ef in efs) or not \
            all(m_.any() for m_ in tm.tree_leaves(st["master_shard"])):
        raise AssertionError(f"int8 sharded: losses {int8_losses}, or an "
                             f"ef or master buffer is zero")
    log(f"phase 19(b) bits (full width, global batch {b} x {t}, {DP} "
        f"ranks): f32 flash, {ZERO_BITS_STEPS} steps: sharded = "
        f"sharded+overlap = replicated bitwise (losses, params, moments "
        f"consolidated); {n_fires} fired reduce-scatters, none "
        f"synchronized the host (sync debug mode 'error'); trainer.main "
        f"--shard-optimizer --codec int8 --overlap (bf16 compute, flash, "
        f"{ZERO_INT8_STEPS} steps, its {len(fires) - n_fires} fires under "
        f"the same mode): losses "
        f"{[round(x, 4) for x in int8_losses]}, every rank's ef and every "
        f"master block non-zero; {time.monotonic() - clock:.1f} s")
    del st, efs, out
    torch.cuda.empty_cache()

    # ---- (c) the fold kernel against its plain version at this path's
    # lengths, and the heaviest fold stage timed
    clock = time.monotonic()
    # the step's topology, and 2,2,2, whose ranks own their blocks out of
    # order (three W=2 stages)
    t222 = tm.resolve_axis_topos(sizes, tm.AXIS_NAMES, "2,2,2")
    for codec, ctopos in ((None, topos), (None, t222), ("int8", topos)):
        cplan, cstages, seen = check_zero_syncs(
            zero, tm, bk, cm, rs, init["params"], pspecs, ctopos, sizes, dev,
            flat_mesh, codec)
        log(f"phase 19(c) {codec or 'f32'} sharded reduce-scatter as the "
            f"step runs it on {zero.shard_topo(ctopos['dp'], DP)} (block "
            f"permutation {layout.perm_for(ctopos, 'dp')}; seeded gradients, "
            f"{DP} ranks, step {CODEC_STEP},"
            f" {len(cplan)} buckets of {[p.nbytes for p in cplan]} B): every "
            f"rank's blocks and tails{' and residual' if codec else ''} "
            f"bitwise the same sync on host copies with the card's plan (the"
            f" plain fold); fold stages {cstages}; launches by body: "
            f"{describe_bodies(seen)}")
        torch.cuda.empty_cache()
    r, w, length = max(stages, key=lambda s: s[0] * (s[1] + 1) * s[2])
    gen = torch.Generator(device=dev).manual_seed(SEED + 191)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x = torch.randn((r, w, length), generator=gen, device=dev)
    outs = torch.empty((r, length), device=dev)
    folds = [(list(x[f]), outs[f]) for f in range(r)]
    n_bytes = r * (w + 1) * length * 4
    fold = {
        "R": r, "W": w, "L": length,
        "ms": time_launches(lambda: rs.reduce_sources(folds, "sum"), 20,
                            flush),
        "plain_ms": time_launches(
            lambda: rs.reduce_sources_plain(folds, "sum"), 10, flush),
        "library_ms": time_launches(lambda: torch.sum(x, 1), 20, flush),
        "bound_ms": n_bytes / bw * 1e3,
    }
    log(f"phase 19(c) heaviest sharded fold stage: {r} x (W={w}, L={length})"
        f" f32 sum ({n_bytes / 1e6:.1f} MB), one launch: kernel "
        f"{fold['ms']:.4f} ms ({100 * fold['bound_ms'] / fold['ms']:.1f}% "
        f"of the bound {fold['bound_ms']:.4f} ms); plain "
        f"{fold['plain_ms']:.4f} ms; torch.sum(x, 1) over the stacked "
        f"sources {fold['library_ms']:.4f} ms (cold L2); {smi}; "
        f"{time.monotonic() - clock:.1f} s")
    del x, outs, folds, flush
    torch.cuda.empty_cache()

    # ---- (d) the train-step bench's sharded rows, in turns
    clock = time.monotonic()
    bench = harness.run_train_step_bench(harness.TrainStepBenchConfig(
        n_layers=layers, d_model=MODEL["d_model"], d_ff=MODEL["d_ff"],
        n_heads=MODEL["n_heads"], vocab_size=MODEL["vocab_size"], batch=b,
        seq_len=t, devices=DP, repeat=ZERO_BENCH_REPEAT, sharded=True,
        device=str(dev)))
    for name, acct in bench["opt_state_bytes"].items():
        if acct["live_bytes_per_rank"] != acct["sharded_bytes_per_rank"]:
            raise AssertionError(f"{name}: live bytes a rank {acct}")
    log(f"phase 19(d) train-step bench (flagship, bf16, flash, {DP} ranks, "
        f"{ZERO_BENCH_REPEAT} rounds in turns; {smi}; printed, not gated; "
        f"ours_sharded bitwise the per-leaf step): " + "; ".join(
            f"{k} median {r_['train_step_median_ms']:.3f} ms (min "
            f"{r_['train_step_ms']:.3f})"
            + (f", optimizer state a rank {r_['opt_state_bytes_ratio']:.4f} "
               f"of the replicated" if "opt_state_bytes_ratio" in r_ else "")
            for k, r_ in bench["rows"].items())
        + "; live moment (and master) bytes a rank = zero_shard_bytes: "
        + ", ".join(f"{k} {a['live_bytes_per_rank']} B"
                    for k, a in bench["opt_state_bytes"].items())
        + f"; {time.monotonic() - clock:.1f} s")
    del bench
    torch.cuda.empty_cache()

    # ---- (e) the phase programs of the shard topology
    head = sum(leaves[i].numel() for i in plan[0].indices)
    found = []
    for phase in ("rs", "ag"):
        prog = sc.build_phase_program(shard_topo, phase, count=head)
        found += sc.check_phase_program(prog, shard_topo)
    if found:
        raise AssertionError(f"phase programs of {shard_topo}: {found}")
    log(f"phase 19(e) the reduce-scatter and all-gather programs of the "
        f"shard topology {shard_topo} (bucket 0's {head} elements): clean "
        f"(symmetry, deadlock, ownership and closure)")
    return launches


# ---------------------------------------------------------------------------
# phase 20: prefill/decode disaggregation
# ---------------------------------------------------------------------------

# the decode round (0-based) whose layer-0 paged-attention call phase 20(a)
# records and holds against the plain stream: by then every slot is full
DISAGG_RECORD_ROUND = 8
DISAGG_CODEC_REPS = 5
# phase 3's bf16 run with the per-round cost feedback off and on, in turns
FEEDBACK_TURNS = (False, True, True, False, False, True, True, False)
REPLICA_START_S = 120.0
REPLICA_RUN_S = 180.0


def first_divergence(got, want):
    """Index of the first token where ``got`` differs from ``want``, or
    None."""
    n = min(len(got), len(want))
    diff = np.nonzero(np.asarray(got[:n]) != np.asarray(want[:n]))[0]
    if diff.size:
        return int(diff[0])
    return None if len(got) == len(want) else n


def drive_migrated(pre, dec, reqs, codec, on_export=None):
    """Every request through ``pre.prefill_for_migration`` (its KV packed
    with ``codec``) and ``dec.admit_migrated`` (unpacked, verified,
    imported), each export released on the admission, and ``dec`` stepped
    to idle; a request ``dec`` refuses for capacity waits, its export
    held, until a round frees a slot.  Returns the wall seconds."""
    pending = list(reqs)
    held = None
    t0 = time.monotonic()
    while pending or held is not None or not dec.idle:
        while pending or held is not None:
            if held is None:
                r = pending.pop(0)
                out = pre.prefill_for_migration(r, codec=codec)
                if out is None:
                    raise AssertionError(f"request {r.rid}: export blocked")
                if on_export is not None:
                    on_export(r, out)
                held = (r, out)
            r, out = held
            if dec.admit_migrated(r, out["first_token"], out["meta"],
                                  out["blob"]) is None:
                if dec.idle:
                    raise AssertionError(f"request {r.rid} refused by an "
                                         "idle decode engine")
                break
            if not pre.release_exported(r.rid, acked=True):
                raise AssertionError(f"request {r.rid}: no export held")
            held = None
        if not dec.idle:
            dec.step()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def codec_rates(migration, host_kv, reps):
    """``pack_kv``/``unpack_kv`` GB/s of each codec on one export (float32
    bytes of the K/V over the median host time of ``reps`` calls)."""
    nbytes = sum(a.nbytes for kind in ("k", "v") for a in host_kv[kind])
    out = {}
    for codec in ("f32", "int8"):
        pack, unpack = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            meta, blob = migration.pack_kv(host_kv, codec=codec)
            t1 = time.perf_counter()
            migration.unpack_kv(meta, blob)
            t2 = time.perf_counter()
            pack.append(t1 - t0)
            unpack.append(t2 - t1)
        out[codec] = {
            "bytes": nbytes, "wire_bytes": len(blob),
            "pack_GBps": nbytes / float(np.median(pack)) / 1e9,
            "unpack_GBps": nbytes / float(np.median(unpack)) / 1e9,
        }
    return out


class RoundRecorder:
    """Wraps the paged-attention function the decode step calls: at decode
    round ``round_index`` (counted by layer-0 calls) it keeps clones of
    layer 0's inputs and the kernel's output, for a check against the
    plain stream after the run."""

    def __init__(self, inner, n_layers, round_index):
        self.inner, self.n_layers = inner, n_layers
        self.round_index, self.calls, self.saved = round_index, 0, None

    def __call__(self, q, k_new, v_new, k_pool, v_pool, tables, lengths,
                 **kw):
        take = self.calls == self.round_index * self.n_layers
        if take:
            args = [t.clone() for t in (q, k_new, v_new, k_pool, v_pool,
                                        tables, lengths)]
        out = self.inner(q, k_new, v_new, k_pool, v_pool, tables, lengths,
                         **kw)
        if take:
            self.saved = (args, out.clone())
        self.calls += 1
        return out


def replica_flags(pcfg, prompt_lens):
    return [
        "--vocab", str(MODEL["vocab_size"]), "--d-model",
        str(MODEL["d_model"]), "--n-heads", str(MODEL["n_heads"]),
        "--n-layers", str(MODEL["n_layers"]), "--d-ff", str(MODEL["d_ff"]),
        "--blocks", str(pcfg.num_blocks), "--block-size",
        str(pcfg.block_size), "--blocks-per-seq", str(pcfg.blocks_per_seq),
        "--slots", str(SLOTS), "--seed", str(SEED), "--fused-decode",
        "--warmup-prompt-lens", ",".join(str(t) for t in prompt_lens),
        "--warmup-max-new", str(MAX_NEW),
    ]


def disagg_processes(cfg, pcfg, reqs, oracle, dev):
    """Phase 20(b): a ``--role prefill`` and a ``--role decode`` replica
    process on the card behind a ``FrontDoor`` that migrates the longer
    half of the prompts; then a SIGTERM drain of both."""
    import shutil
    import signal
    import tempfile

    from flextree_tpu_torch.runtime import read_control_json
    from flextree_tpu_torch.serving.costs import migration_crossover_tokens
    from flextree_tpu_torch.serving.frontdoor import (
        FrontDoor,
        FrontDoorConfig,
    )
    from flextree_tpu_torch.serving.replica_main import ENDPOINT_FMT

    cross = {codec: migration_crossover_tokens(cfg, pcfg, codec, device=dev)
             for codec in ("f32", "int8")}
    lens = sorted(r.prompt_len for r in reqs)
    threshold = lens[len(lens) // 2]
    n_long = sum(t >= threshold for t in lens)
    log(f"phase 20(b) the planner's migrate-vs-recompute crossover on {dev} "
        f"(the port's default cost constants): f32 {cross['f32']} tokens, "
        f"int8 {cross['int8']}; migrate_min_prompt_len {threshold} (the "
        f"median prompt), so {n_long} of {len(reqs)} prompts migrate")
    ctrl = tempfile.mkdtemp(prefix="ft-disagg-")
    env = dict(os.environ, PYTHONPATH=HERE)
    flags = replica_flags(pcfg, sorted(set(lens)))
    procs, logs, fd = [], [], None
    t_start = time.monotonic()
    try:
        for rank, role in ((0, "prefill"), (1, "decode")):
            logs.append(open(os.path.join(ctrl, f"replica_{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "flextree_tpu_torch.serving.replica_main", "--rank",
                 str(rank), "--dir", ctrl, "--role", role, *flags],
                cwd=HERE, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + REPLICA_START_S
        for rank in (0, 1):
            path = os.path.join(ctrl, ENDPOINT_FMT.format(rank=rank))
            while read_control_json(path) is None:
                for p in procs:
                    if p.poll() is not None:
                        raise AssertionError(f"a replica exited with "
                                             f"{p.returncode} at start-up")
                if time.monotonic() > deadline:
                    raise AssertionError("replicas did not start in "
                                         f"{REPLICA_START_S} s")
                time.sleep(0.05)
        startup_s = time.monotonic() - t_start
        fd = FrontDoor(ctrl, FrontDoorConfig(
            migrate_min_prompt_len=threshold, migrate_codec="f32",
            max_hedges=0, request_timeout_s=REPLICA_RUN_S,
            attempt_timeout_s=REPLICA_RUN_S / 2, affinity_span=0,
            # a dispatcher a decode slot: the replica's batch can fill, and
            # a migrating request always finds a free slot (the decode side
            # refuses a handoff it cannot seat, and the request then falls
            # back to a colocated generate)
            dispatchers=SLOTS,
        )).start()
        t0 = time.monotonic()
        for r in reqs:
            if not fd.submit(r.rid, r.prompt, r.max_new_tokens):
                raise AssertionError(f"request {r.rid} shed at intake")
        if not fd.wait_idle(timeout_s=REPLICA_RUN_S):
            raise AssertionError("front door not idle in time")
        makespan = time.monotonic() - t0
        counters = fd.metrics.snapshot()["counters"]
        if fd.failed or sorted(fd.completed) != sorted(r.rid for r in reqs):
            raise AssertionError(f"front door: failed {fd.failed}, "
                                 f"completed {sorted(fd.completed)}")
        if counters.get("serve.duplicate_results", 0):
            raise AssertionError("a request was delivered twice")
        migrated = sum(res.migrated for res in fd.completed.values())
        fallback = int(counters.get("serve.migration_fallback", 0))
        for r in reqs:
            res = fd.completed[r.rid]
            if not np.array_equal(res.tokens, oracle[r.rid]):
                raise AssertionError(
                    f"request {r.rid}: replica tokens differ from the "
                    f"colocated oracle at {first_divergence(res.tokens, oracle[r.rid])}")
            if res.migrated and r.prompt_len < threshold:
                raise AssertionError(f"request {r.rid}: a short prompt "
                                     "migrated")
        if migrated + fallback != n_long or not migrated or counters.get(
                "serve.migrations", 0) != migrated:
            raise AssertionError(
                f"migrations: {migrated} migrated + {fallback} fallbacks "
                f"for {n_long} long prompts; counters {counters}")
        tokens = sum(len(res.tokens) for res in fd.completed.values())
        ttft = np.array([res.ttft_s for res in fd.completed.values()]) * 1e3
        fd.close()
        fd = None
        # SIGTERM: each drains, exits 0 and retires its endpoint file
        t0 = time.monotonic()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for rank, p in enumerate(procs):
            rc = p.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"replica {rank} exited {rc} on SIGTERM")
            if os.path.exists(os.path.join(ctrl,
                                           ENDPOINT_FMT.format(rank=rank))):
                raise AssertionError(f"replica {rank} left its endpoint")
        drain_s = time.monotonic() - t0
        snaps = {}
        for rank in (0, 1):
            with open(os.path.join(ctrl, f"metrics_{rank:05d}.json")) as f:
                snaps[rank] = json.load(f)
        g = snaps[1]["gauges"]
        launches = int(g["serve.paged_attention_launches"])
        rounds = int(g["serve.decode_steps"])
        if launches != rounds * MODEL["n_layers"] or launches == 0:
            raise AssertionError(f"decode replica: kernel launches "
                                 f"{launches} != {rounds} rounds x layers")
        mig_in = int(snaps[1]["counters"].get("serve.migrations_in", 0))
        acked = int(snaps[0]["counters"].get("serve.migration_acked", 0))
        if mig_in != migrated or acked != migrated:
            raise AssertionError(f"replicas count {mig_in} migrations in, "
                                 f"{acked} acked; front door {migrated}")
        if snaps[0]["gauges"]["serve.paged_attention_launches"] != 0:
            raise AssertionError("the prefill replica ran a decode round")
        log(f"phase 20(b) replicas: prefill + decode processes up in "
            f"{startup_s:.1f} s; {len(reqs)} requests "
            f"completed exactly once, tokens == the colocated oracle; "
            f"{migrated} migrated ({fallback} fallbacks), "
            f"{len(reqs) - n_long} colocated on the decode replica; "
            f"{tokens} tokens in {makespan:.3f} s = "
            f"{tokens / makespan:.1f} tok/s, TTFT p50 "
            f"{np.percentile(ttft, 50):.2f} ms p99 "
            f"{np.percentile(ttft, 99):.2f} ms; the decode replica logged "
            f"{launches} paged_attention launches = {rounds} rounds x "
            f"{MODEL['n_layers']} layers; SIGTERM drain: both exited 0, "
            f"endpoints retired, in {drain_s:.2f} s")
        return {"launches": launches, "migrated": migrated,
                "tok_per_s": tokens / makespan, "startup_s": startup_s}
    finally:
        if fd is not None:
            fd.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
        for rank in range(len(procs)):
            path = os.path.join(ctrl, f"replica_{rank}.log")
            with open(path) as f:
                tail = f.read()[-1500:]
            log(f"phase 20(b) replica {rank} log tail:\n{tail}")
        shutil.rmtree(ctrl, ignore_errors=True)


def phase_disagg(dev, smi) -> int:
    """Phase 20: prefill/decode disaggregation.  Returns the paged
    kernel's launches on the disaggregated path (the in-process decode
    engine's plus the decode replica process's)."""
    from flextree_tpu_torch import serving
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.obs import flight_recorder
    from flextree_tpu_torch.ops import paged_attention as pa
    from flextree_tpu_torch.serving import kv_cache, migration

    log(f"phase 20 on {smi}")
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    pcfg = serving.PagedCacheConfig(**CACHE)
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device=dev)
    reqs = make_requests(serving.Request)

    # ---- (a) in process, float32: the colocated oracle
    col = run_engine(serving, params, cfg, pcfg, True, dev)
    drive(col, reqs, pa)
    oracle = {rid: d.tokens for rid, d in col.completed.items()}
    del col

    def engine():
        e = serving.ServingEngine(
            params, cfg, pcfg, serving.BatcherConfig(slots=SLOTS),
            fused=True, decode_impl="cuda", device=dev,
        )
        e.warmup()
        return e

    # f32 migration, the decode engine's launches counted and one round's
    # layer-0 call recorded
    pre, dec = engine(), engine()
    rec = RoundRecorder(kv_cache.paged_attention, MODEL["n_layers"],
                        DISAGG_RECORD_ROUND)
    kv_cache.paged_attention = rec
    sample = {}

    def keep_largest(r, out):
        if r.prompt_len > sample.get("len", 0):
            layers = MODEL["n_layers"]
            kv = kv_cache.export_blocks(pre.pools, pre._exported[r.rid])
            host = torch.stack(kv["k"] + kv["v"]).float().cpu().numpy()
            sample.update(len=r.prompt_len, kv={"k": list(host[:layers]),
                                                "v": list(host[layers:])})

    try:
        with flight_recorder(None, source="serve") as flight:
            pa.paged_attention.launches = 0
            torch.cuda.synchronize()
            wall = drive_migrated(pre, dec, reqs, "f32",
                                  keep_largest)
            launches = pa.paged_attention.launches
    finally:
        kv_cache.paged_attention = pa.paged_attention
    done = dec.completed
    if sorted(done) != sorted(r.rid for r in reqs):
        raise AssertionError(f"migrated: {len(done)}/{len(reqs)} completed")
    diverged = {r.rid: first_divergence(done[r.rid].tokens, oracle[r.rid])
                for r in reqs}
    bad = {rid: i for rid, i in diverged.items() if i is not None}
    if bad:
        raise AssertionError(f"f32 migrated tokens differ from the colocated "
                             f"engine's (rid: first token): {bad}")
    want = dec.decode_steps * MODEL["n_layers"]
    if launches != want:
        raise AssertionError(f"migrated decode: kernel launches {launches} "
                             f"!= {dec.decode_steps} rounds x layers")
    if rec.saved is None:
        raise AssertionError("no decode round was recorded")
    args, got = rec.saved
    plain = pa.paged_attention(*args, impl="torch")
    err = (got.float() - plain.float()).abs().max().item()
    if not err <= pa.FUSED_DECODE_ATOL:
        raise AssertionError(f"recorded round: kernel vs plain stream {err}")
    active = int((args[6] > 0).sum().item())
    tokens = sum(d.n_tokens for d in done.values())
    log(f"phase 20(a) f32 migration (flagship, float32, kernel decode): "
        f"{len(reqs)}/{len(reqs)} requests prefilled on one engine, packed, "
        f"unpacked and admitted on another; tokens == the colocated kernel "
        f"engine's on all {len(reqs)}; {tokens} tokens in {wall:.3f} s; "
        f"kernel launches {launches} = {dec.decode_steps} decode rounds x "
        f"{MODEL['n_layers']} layers; round {DISAGG_RECORD_ROUND} layer 0 "
        f"({active} active slots, lengths up to "
        f"{int(args[6].max().item())}): kernel vs plain stream max abs "
        f"{err:.3g} (bar {pa.FUSED_DECODE_ATOL})")
    measured = np.array([e["measured_us"] for e in flight.events
                         if e["kind"] == "serve_round_measured"])
    predicted = np.array([e["predicted_us"] for e in flight.events
                          if e["kind"] == "serve_round_measured"])
    if len(measured) != dec.decode_steps:
        raise AssertionError(f"{len(measured)} round samples for "
                             f"{dec.decode_steps} decode rounds")
    resid = np.abs(predicted - measured) / measured
    hist = dec.report()["histograms"]["serve.round_residual"]
    log(f"phase 20(a) round feedback ({dec.decode_steps} decode rounds): "
        f"measured median {np.median(measured):.1f} us p90 "
        f"{np.percentile(measured, 90):.1f}; predicted median "
        f"{np.median(predicted):.1f} us p90 "
        f"{np.percentile(predicted, 90):.1f}; |pred - meas| / meas median "
        f"{np.median(resid):.4f} p90 {np.percentile(resid, 90):.4f} "
        f"(serve.round_residual: {hist['count']} samples, bucket p50 "
        f"{hist['p50']:.3g})")
    del pre, dec

    # int8: the round trip within its bound at the flagship geometry, and
    # each request's first token that differs from the oracle's, if any
    pre, dec = engine(), engine()
    worst = {"err": 0.0, "ratio": 0.0}

    def check_int8(r, out):
        kv = kv_cache.export_blocks(pre.pools, pre._exported[r.rid])
        exact = torch.stack(kv["k"] + kv["v"]).float().cpu().numpy()
        back = migration.unpack_kv(out["meta"], out["blob"])
        got = np.stack(back["k"] + back["v"])
        err = float(np.abs(got - exact).max())
        bound = migration.migration_error_bound(out["meta"])
        if not err <= bound:
            raise AssertionError(f"request {r.rid}: int8 error {err} over "
                                 f"its bound {bound}")
        worst["err"] = max(worst["err"], err)
        worst["ratio"] = max(worst["ratio"], err / bound)

    pa.paged_attention.launches = 0
    wall8 = drive_migrated(pre, dec, reqs, "int8", check_int8)
    launches8 = pa.paged_attention.launches
    if launches8 != dec.decode_steps * MODEL["n_layers"]:
        raise AssertionError(f"int8 migrated decode: launches {launches8}")
    div8 = {r.rid: first_divergence(dec.completed[r.rid].tokens,
                                    oracle[r.rid]) for r in reqs}
    same8 = sum(i is None for i in div8.values())
    log(f"phase 20(a) int8 migration: every payload within "
        f"migration_error_bound (worst {worst['err']:.4g}, "
        f"{worst['ratio']:.3f} of its bound); {same8}/{len(reqs)} requests "
        f"token-identical to the oracle; first diverging token by rid "
        f"(None = identical): {div8}; {wall8:.3f} s; kernel launches "
        f"{launches8}")
    del pre, dec

    rates = codec_rates(migration, sample["kv"], DISAGG_CODEC_REPS)
    for codec, r in rates.items():
        log(f"phase 20(a) {codec} codec on the {sample['len']}-token "
            f"prompt's export ({r['bytes']} float32 bytes, {r['wire_bytes']}"
            f" on the wire): pack_kv {r['pack_GBps']:.3f} GB/s, unpack_kv "
            f"{r['unpack_GBps']:.3f} GB/s (host)")

    # phase 3's bf16 run, the round feedback off and on in turns
    cfg16 = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    rate = {False: [], True: []}
    for on in FEEDBACK_TURNS:
        e = run_engine(serving, params, cfg16, pcfg, True, dev)
        if not on:
            e._round_feedback = lambda *a: None
        makespan, _ = drive(e, reqs, pa)
        rate[on].append(sum(d.n_tokens for d in e.completed.values())
                        / makespan)
        del e
    log(f"phase 20(a) phase 3's bf16 serving in turns "
        f"{'/'.join('on' if on else 'off' for on in FEEDBACK_TURNS)}: "
        f"round feedback off {', '.join(f'{x:.1f}' for x in rate[False])} "
        f"tok/s, on {', '.join(f'{x:.1f}' for x in rate[True])} tok/s")
    del params

    # ---- (b) across processes
    procs = disagg_processes(cfg, pcfg, reqs, oracle, dev)
    log(f"phase 20 paged_attention launches on the disaggregated path: "
        f"{launches} in process (f32 run) + {procs['launches']} in the decode "
        f"replica")
    return launches + procs["launches"]


# ---------------------------------------------------------------------------
# phase 21: the in-process replica pool
# ---------------------------------------------------------------------------

# the open-loop spike (serving/workload.py): 20 rps for 0.5 s, 100 rps for
# 0.4 s, 20 rps for 0.5 s; the generator's prompt lengths (4, 6, 8) x 16 and
# outputs (16, 32, 48) x 2, so a request's 64-224 tokens sit inside the
# flagship's 1024-token table row as the generator's sit inside its model's
POOL_SEED = 21
POOL_RATES = (20.0, 100.0)
POOL_PHASES_S = (0.5, 0.4, 0.5)
POOL_PROMPT_LENS = (64, 96, 128)
POOL_OUT_LENS = (32, 64, 96)
POOL_STEP_TIMEOUT_S = 1.0
# the engines' TTFT SLO window: (c) reads the dumped metrics files in a
# fresh process after (a)'s checks, and the window must still hold the
# run's samples then; with the engine's 10 s default a loaded host read
# the files more than 10 s after the last sample and saw it drained
POOL_SLO_WINDOW_S = 120.0
# the bf16 pool with parallel_rounds off and on, in turns (no kill)
POOL_TURNS = (False, True)  # (off, on, on, off) before phase 27


def pool_engines(serving, params, cfg, pcfg, dev, recorders=()):
    """Two kernel engines; with ``recorders``, each engine's rounds record
    under its own (``use_recorder`` on the thread that steps it), as a
    replica process records under its own rank."""
    from flextree_tpu_torch.obs import use_recorder

    engines = [serving.ServingEngine(
        params, cfg, pcfg, serving.BatcherConfig(slots=SLOTS), fused=True,
        decode_impl="cuda", device=dev, slo_window_s=POOL_SLO_WINDOW_S)
        for _ in range(2)]
    for eng, rec in zip(engines, recorders):
        inner = eng.step

        def step(inner=inner, rec=rec):
            with use_recorder(rec):
                return inner()

        eng.step = step
    return engines


def drive_pool(pool, reqs, kill_at=None, on_round=None):
    """Submit ``reqs`` at their open-loop arrival offsets and step the pool
    until every request is done; replica 1 is killed in ``"hang"`` mode at
    ``kill_at`` seconds.  Returns ``(wall seconds, kill monotonic time)``."""
    pending = collections.deque(sorted(reqs, key=lambda r: r.arrival_s))
    t0 = time.monotonic()
    killed = None
    while pending or not pool.idle:
        now = time.monotonic() - t0
        while pending and pending[0].arrival_s <= now:
            r = pending.popleft()
            pool.submit(dataclasses.replace(r, arrival_s=t0 + r.arrival_s))
        if kill_at is not None and killed is None and now >= kill_at:
            pool.kill(1, mode="hang")
            killed = time.monotonic()
        if pool.idle and pending:
            time.sleep(min(1e-3, pending[0].arrival_s - now))
            continue
        pool.step()
        if on_round is not None:
            on_round()
    torch.cuda.synchronize()
    return time.monotonic() - t0, killed


def pool_rates(completed, wall):
    ttft = np.array([d.ttft_s * 1e3 for d in completed.values()])
    tokens = sum(d.n_tokens for d in completed.values())
    return (tokens / wall, float(np.percentile(ttft, 50)),
            float(np.percentile(ttft, 99)))


def pool_timeline(obs_dir, rerouted, timeline):
    """Phase 21(c): the merged trace is valid, a re-routed request's flow
    goes from replica 1's track to replica 0's, and the obs CLI renders
    the replicas' metrics with the TTFT window's p99 gauge."""
    doc = timeline.merge_dir(obs_dir)
    bad = timeline.validate_trace(doc)
    if bad:
        raise AssertionError(f"phase 21(c): merged trace invalid: {bad[:5]}")
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "request" and e["id"] in rerouted:
            spans.setdefault(e["id"], []).append((e["ph"], e["pid"]))
    both = sorted(rid for rid, pts in spans.items()
                  if {p for _, p in pts} >= {0, 1})
    if not both:
        raise AssertionError(f"phase 21(c): no re-routed request's flow "
                             f"spans both replica tracks: {spans}")
    out = subprocess.run(
        [sys.executable, "-m", "flextree_tpu_torch.obs", "metrics", obs_dir,
         "--prom"], capture_output=True, text=True, timeout=120, cwd=HERE)
    gauges = [ln for ln in out.stdout.splitlines()
              if "_window_p99{" in ln]
    if out.returncode != 0 or not gauges:
        counts = [ln for ln in out.stdout.splitlines()
                  if "_window_count{" in ln]
        raise AssertionError(f"phase 21(c): obs metrics --prom rc "
                             f"{out.returncode}, no window p99 gauge "
                             f"(window counts {counts}): "
                             f"{out.stderr[-2000:]}")
    log(f"phase 21(c) timeline: {doc['otherData']['events']} events on "
        f"tracks {doc['otherData']['ranks']} (replicas 0, 1; the pool 2), "
        f"{len(doc['traceEvents'])} trace events, validate_trace clean; "
        f"{len(both)} of {len(rerouted)} re-routed requests' flows span "
        f"both replica tracks (rid {both[0]}: "
        f"{' '.join(f'{ph}@{pid}' for ph, pid in spans[both[0]])}); "
        f"`python -m flextree_tpu_torch.obs metrics --prom` rc 0, "
        f"{gauges[0]}")


def phase_pool(dev, smi) -> int:
    """Phase 21: the in-process replica pool.  Returns the paged kernel's
    launches on the pool's path (phase 21(a)'s float32 run)."""
    import tempfile

    from flextree_tpu_torch import serving
    from flextree_tpu_torch.analysis import run_protocol_check
    from flextree_tpu_torch.analysis.protocol_check import explore
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.obs import FlightRecorder, flight_recorder
    from flextree_tpu_torch.obs import timeline
    from flextree_tpu_torch.ops import paged_attention as pa
    from flextree_tpu_torch.serving import kv_cache, rpc_model
    from flextree_tpu_torch.serving.workload import build_spike_workload
    from flextree_tpu_torch.tools import bench_serving

    log(f"phase 21 on {smi}")
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    pcfg = serving.PagedCacheConfig(**CACHE)
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device=dev)
    reqs, spike_start, spike_end = build_spike_workload(
        POOL_SEED, POOL_RATES[0], POOL_RATES[1], *POOL_PHASES_S,
        prompt_lens=POOL_PROMPT_LENS, out_lens=POOL_OUT_LENS,
        vocab=MODEL["vocab_size"])
    kill_at = (spike_start + spike_end) / 2
    warm = (sorted({r.prompt_len for r in reqs}),
            {pcfg.blocks_for(r.prompt_len + r.max_new_tokens) for r in reqs})
    tokens_in = sum(r.max_new_tokens for r in reqs)
    log(f"phase 21 traffic: build_spike_workload(seed {POOL_SEED}, "
        f"{POOL_RATES[0]} rps for {POOL_PHASES_S[0]} s, {POOL_RATES[1]} rps "
        f"for {POOL_PHASES_S[1]} s, {POOL_RATES[0]} rps for "
        f"{POOL_PHASES_S[2]} s; prompts {POOL_PROMPT_LENS}, outputs "
        f"{POOL_OUT_LENS}): {len(reqs)} requests, {tokens_in} tokens to "
        f"generate; spike {spike_start:.2f}-{spike_end:.2f} s, replica 1 "
        f"killed (hang) at {kill_at:.2f} s")

    # ---- (a) float32: the single-engine kernel oracle, then the pool
    oracle_eng = run_engine(serving, params, cfg, pcfg, True, dev)
    drive(oracle_eng, [dataclasses.replace(r, arrival_s=0.0) for r in reqs],
          pa)
    oracle = {rid: d.tokens for rid, d in oracle_eng.completed.items()}
    del oracle_eng

    with tempfile.TemporaryDirectory(prefix="ft-pool-") as tmp:
        obs_dir = os.path.join(tmp, "obs")
        rec = RoundRecorder(kv_cache.paged_attention, MODEL["n_layers"], -1)
        kv_cache.paged_attention = rec
        try:
            with flight_recorder(obs_dir, rank=2, source="pool") as prec:
                recs = [FlightRecorder(obs_dir, rank, source="serve")
                        for rank in range(2)]
                engines = pool_engines(serving, params, cfg, pcfg, dev, recs)
                pool = serving.ReplicaPool(engines, serving.PoolConfig(
                    heartbeat_dir=os.path.join(tmp, "hb"),
                    step_timeout_s=POOL_STEP_TIMEOUT_S, lease_s=5.0,
                    interval_s=0.05, max_suspect_strikes=3))
                with pool:
                    pool.warmup(*warm)

                    def arm():
                        # after the drain only the survivor steps: record
                        # its layer-0 call two rounds on
                        if rec.round_index < 0 and not pool.replicas[1].alive:
                            rec.round_index = rec.calls // MODEL["n_layers"] + 2

                    pa.paged_attention.launches = 0
                    torch.cuda.synchronize()
                    wall, killed = drive_pool(pool, reqs, kill_at, arm)
                    launches = pa.paged_attention.launches
                    report = pool.report()
                    rounds = [e.decode_steps for e in engines]
                for r, eng in enumerate(engines):
                    with open(os.path.join(obs_dir,
                                           f"metrics_{r:05d}.json"), "w") as f:
                        json.dump(eng.metrics.snapshot(), f)
                for r in recs:
                    r.close()
            pool_events = list(prec.events)
        finally:
            kv_cache.paged_attention = pa.paged_attention
        drains = [e for e in pool_events if e["kind"] == "drain"]
        done = pool.completed
        if sorted(done) != sorted(r.rid for r in reqs) or not (
                report["completed"] == report["submitted"] == len(reqs)):
            raise AssertionError(f"phase 21(a): {report['completed']}/"
                                 f"{report['submitted']} completed of "
                                 f"{len(reqs)}")
        if report["reroutes"] < 1 or len(drains) != 1:
            raise AssertionError(f"phase 21(a): reroutes "
                                 f"{report['reroutes']}, drains {drains}")
        diverged = {r.rid: first_divergence(done[r.rid].tokens,
                                            oracle[r.rid]) for r in reqs}
        bad = {rid: i for rid, i in diverged.items() if i is not None}
        if bad:
            raise AssertionError(f"phase 21(a): f32 pool tokens differ from "
                                 f"the single-engine oracle's (rid: first "
                                 f"token): {bad}")
        if launches != sum(rounds) * MODEL["n_layers"]:
            raise AssertionError(f"phase 21(a): kernel launches {launches} "
                                 f"!= rounds {rounds} x layers")
        if rec.saved is None:
            raise AssertionError("phase 21(a): no survivor round recorded")
        args, got = rec.saved
        plain = pa.paged_attention(*args, impl="torch")
        err = (got.float() - plain.float()).abs().max().item()
        if not err <= pa.FUSED_DECODE_ATOL:
            raise AssertionError(f"phase 21(a): recorded round: kernel vs "
                                 f"plain stream {err}")
        rerouted = drains[0]["rerouted"]
        drain_s = drains[0]["ts"] - next(e["ts"] for e in pool_events
                                         if e["kind"] == "kill")
        rate, p50, p99 = pool_rates(done, wall)
        log(f"phase 21(a) f32 pool (2 kernel engines, step_timeout_s "
            f"{POOL_STEP_TIMEOUT_S}): {len(done)}/{len(reqs)} completed "
            f"exactly once; replica 1 drained ({drains[0]['why']}) "
            f"{drain_s:.3f} s after its kill, {len(rerouted)} requests "
            f"re-routed to the survivor; tokens == the single-engine kernel "
            f"oracle's on all {len(reqs)}; kernel launches {launches} = "
            f"decode rounds {rounds[0]} + {rounds[1]} x {MODEL['n_layers']} "
            f"layers; the survivor's round {rec.round_index} layer 0 "
            f"({int((args[6] > 0).sum().item())} active slots, lengths up "
            f"to {int(args[6].max().item())}): kernel vs plain stream max "
            f"abs {err:.3g} (bar {pa.FUSED_DECODE_ATOL}); {rate:.1f} tok/s "
            f"over {wall:.3f} s, TTFT p50 {p50:.2f} ms p99 {p99:.2f} ms")
        del engines, pool

        # ---- (c) the timeline of (a)
        pool_timeline(obs_dir, set(rerouted), timeline)

    # ---- (a) bf16, parallel_rounds off and on in turns, no kill
    cfg16 = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    seen = {False: [], True: []}
    with tempfile.TemporaryDirectory(prefix="ft-pool16-") as tmp:
        for i, par in enumerate(POOL_TURNS):
            engines = pool_engines(serving, params, cfg16, pcfg, dev)
            pool = serving.ReplicaPool(engines, serving.PoolConfig(
                heartbeat_dir=os.path.join(tmp, f"hb{i}"),
                step_timeout_s=POOL_STEP_TIMEOUT_S, lease_s=5.0,
                interval_s=0.05, parallel_rounds=par))
            with pool:
                pool.warmup(*warm)
                pa.paged_attention.launches = 0
                wall, _ = drive_pool(pool, reqs)
                n = pa.paged_attention.launches
                rounds = sum(e.decode_steps for e in engines)
                if len(pool.completed) != len(reqs):
                    raise AssertionError(f"phase 21(a) bf16: "
                                         f"{len(pool.completed)} completed")
            seen[par].append(pool_rates(pool.completed, wall)
                             + (n == rounds * MODEL["n_layers"],))
            del engines, pool
    for par, runs in seen.items():
        log(f"phase 21(a) bf16 pool, parallel_rounds {'on' if par else 'off'}"
            f" (turns {'/'.join('on' if p else 'off' for p in POOL_TURNS)}):"
            f" " + "; ".join(f"{r:.1f} tok/s, TTFT p50 {a:.2f} ms p99 "
                             f"{b:.2f} ms, launches == rounds x layers {ok}"
                             for r, a, b, ok in runs))
    del params

    # ---- (b) the port's serving bench at --smoke size
    doc = bench_serving.run_bench(smoke=True, seed=SEED, width="flagship",
                                  device=dev,
                                  log=lambda m: log(f"phase 21(b) {m}"))
    floors = doc["floors"]
    if not (floors["bitwise_ok"] and floors["replica_kill"]["ok"]):
        raise AssertionError(f"phase 21(b): bench floors failed: "
                             f"bitwise {floors['bitwise_ok']}, degrade "
                             f"{floors['replica_kill']['ok']}")
    log(f"phase 21(b) bench_serving --smoke (flagship, float32, gather "
        f"path): bitwise {floors['bitwise_checked']} checked, "
        f"{floors['paged_bitwise_violations']} violations; degrade ok "
        f"({floors['replica_kill']['completed']}/"
        f"{floors['replica_kill']['submitted']}, "
        f"{floors['replica_kill']['reroutes']} re-routed); continuous "
        f"{doc['continuous']['throughput_tok_s']} tok/s vs static "
        f"{doc['static']['throughput_tok_s']} tok/s: ratio "
        f"{floors['throughput_ratio']} (floor "
        f"{floors['min_throughput_ratio']} not enforced at --smoke); p99 "
        f"TTFT ratio {floors['p99_ttft_ratio']}; {doc['elapsed_s']} s")

    # ---- (d) the protocol models
    violations, detail = run_protocol_check()
    truncated = [n for n, m in detail["models"].items() if m["truncated"]]
    if violations or truncated:
        raise AssertionError(f"phase 21(d): {violations} {truncated}")
    caught = {}
    for model, kind in (
            (rpc_model.RpcModel(mutation="replay_miss"),
             "completed-rid-reexecuted"),
            (rpc_model.MigrationModel(mutation="skip_release"),
             "migration-block-leak")):
        found = explore(model).violations
        if kind not in found:
            raise AssertionError(f"phase 21(d): {model.name} reached "
                                 f"{sorted(found)}, not {kind}")
        caught[model.name] = kind
    log(f"phase 21(d) protocol check: " + "; ".join(
        f"{n} {m['states']} states, {m['transitions']} transitions"
        for n, m in detail["models"].items())
        + f", 0 violations, none truncated; mutations caught: {caught}")
    return launches


SP_MESH = (2, 2, 2)  # (dp, sp, tp), the JAX trainer's --devices 8
SP_IMPLS = ("ring", "zigzag", "ulysses")
SP_STEPS = 4  # 10 before phase 24, 6 before phase 27 needed the time
SP_ARGV = TRAIN_ARGV + ["--mesh", ",".join(map(str, SP_MESH))]
SP_ARGV[SP_ARGV.index("--steps") + 1] = str(SP_STEPS)
SP_DP_ARGV = TRAIN_ARGV + ["--mesh", f"{DP},1,1"]
SP_DP_ARGV[SP_DP_ARGV.index("--steps") + 1] = str(SP_STEPS)
SP_F32_STEPS = 3
SP_F32_BATCH = 2
SP_TIMED = 2  # steady steps of each run, in turns (4 before phase 27)
PROFILED_SP = "ring"  # 22(b)'s one profile of the dense sp/tp family


def sp_flash_cases():
    """The flash parity cases of the sp/tp path's shapes at the flagship on
    ``SP_MESH``: one rank's ring hop (its T/sp shard, H/tp heads; the
    resident block causal, a past block not, both with an lse
    cotangent), the zigzag's half-shard chunks the same way, and the
    Ulysses inner attention (the whole sequence, H/(tp sp) heads)."""
    dp, sp, tp = SP_MESH
    b, t, h, d = FLASH_TRAIN
    bl, tl, hl = b // dp, t // sp, h // tp
    return (
        ("ring_diag", bl, tl, tl, hl, d, True, 0, 0, True),
        ("ring_past", bl, tl, tl, hl, d, False, 0, 0, True),
        ("zigzag_diag", bl, tl // 2, tl // 2, hl, d, True, 0, 0, True),
        ("zigzag_past", bl, tl // 2, tl // 2, hl, d, False, 0, 0, True),
        ("ulysses", bl, t, t, hl // sp, d, True, 0, 0, False),
    )


def sp_flash_launches(impl: str, shape, layers: int) -> int:
    """Each flash kernel's launches a step, from the code: each forward
    call has one dq and one dk/dv.  The causal ring calls the kernel on
    the resident block and on each block from an earlier rank of its sp
    group (``n + n(n-1)/2`` a group and layer; a future block launches
    nothing); the zigzag on both chunk pairs at the first hop plus the
    late-vs-early pair, then one visible pair and the late-vs-early pair
    a hop (``2n + 1`` a rank); Ulysses once a rank."""
    dp, sp, tp = shape
    world = dp * sp * tp
    if sp == 1 or impl == "ulysses":
        per_layer = world
    elif impl == "ring":
        per_layer = world // sp * (sp + sp * (sp - 1) // 2)
    else:
        per_layer = world * (2 * sp + 1)
    return layers * per_layer


def sp_fold_launches(shape, leaves, specs, ar, bk, tm, rs):
    """The fold kernel's launches a step on ``shape``, from the code: the
    tensor-parallel combine (two a layer, forward and backward, on every
    tp group; each one allreduce of B/dp x T/sp x d elements) and the
    bucketed sync (each bucket on each of its axes, once a group along the
    axis; ``sync_fold_stages``).  ``leaves``/``specs``: a rank's slices
    and their specs."""
    dp, sp, tp = shape
    world = dp * sp * tp
    sizes = dict(zip(tm.AXIS_NAMES, shape))
    b, t = FLASH_TRAIN[:2]
    combine = 0
    if tp > 1:
        count = b // dp * (t // sp) * MODEL["d_model"]
        combine = 2 * 2 * MODEL["n_layers"] * (world // tp) * stage_launches(
            ar.call_shape(tp, None, count).folds, rs.MAX_POINTERS)
    topos = tm.resolve_axis_topos(sizes, tm.AXIS_NAMES, None)
    plan = bk.plan_buckets(leaves, specs, tm.AXIS_NAMES, topos=topos,
                           axis_sizes=sizes)
    numels = [g.numel() for g in leaves]
    sync = sum(world // sizes[ax] * stage_launches(
        bk.sync_fold_stages(numels, sizes[ax], topos[ax], [bkt]),
        rs.MAX_POINTERS) for bkt in plan for ax in bkt.axes)
    return combine, sync, plan


def combine_check(dev, rs, cm, ar, spmd, mesh, host, shape, tag):
    """The tensor-parallel combine (the FlexTree allreduce over each tp
    group of ``mesh``, forward and its backward, bf16) of seeded tensors of
    ``shape`` on the card, bitwise the same on host copies (``host``: the
    mesh's shape on the CPU), where the fold is its plain version; every
    fold on the bulk-copy body.  Returns the bodies' counter."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)

    def combine(xs, gs, m):
        xs = [x.detach().requires_grad_() for x in xs]
        ys = spmd.axis(m, "tp").allreduce(xs)
        return ys, torch.autograd.grad(ys, xs, grad_outputs=gs)

    xs = [torch.randn(shape, generator=gen, device=dev).bfloat16()
          for _ in range(mesh.size)]
    gs = [torch.randn(shape, generator=gen, device=dev).bfloat16()
          for _ in range(mesh.size)]
    with fold_bodies(rs, cm, ar) as seen:
        ys, dxs = combine(xs, gs, mesh)
        torch.cuda.synchronize()
    hys, hdxs = combine([x.cpu() for x in xs], [g.cpu() for g in gs], host)
    if not all(same_bits(a.cpu(), b_) for a, b_ in zip(ys + list(dxs),
                                                       hys + list(hdxs))):
        raise AssertionError(f"{tag}: the combine on the fold kernel is "
                             f"not bitwise its plain fold on the host")
    check_bodies(seen, f"{tag} combine", 0)
    return seen


def mesh_sync_check(dev, tm, bk, ar, rs, cm, mesh, host, shards, pspecs,
                    tag):
    """The bucketed sync of seeded slices shaped like ``shards`` (every
    rank's tree) over ``mesh`` bitwise the per-leaf sync on the card and
    the host's per-leaf sync on ``host`` (plain folds); the bodies the
    kernel took printed.  Returns the bucket plan."""
    axes = mesh.axis_names
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    trees = [tm.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=dev), s) for s in shards]
    sizes = dict(zip(axes, mesh.shape))
    topos = tm.resolve_axis_topos(sizes, axes, None)
    leaves = tm.tree_leaves(trees[0])
    specs = bk.spec_leaves(trees[0], pspecs)
    plan = bk.plan_buckets(leaves, specs, axes, topos=topos,
                           axis_sizes=sizes)
    with fold_bodies(rs, cm, ar) as seen:
        fused = tm.sync_grads(trees, pspecs, axes, topos, bucket_bytes=None,
                              comm=mesh)
        torch.cuda.synchronize()
    per_leaf = tm.sync_grads(trees, pspecs, axes, topos, bucket_bytes=0,
                             comm=mesh)
    if not trees_identical(fused, per_leaf, tm.tree_leaves):
        raise AssertionError(f"{tag}: the bucketed sync is not bitwise the "
                             f"per-leaf sync on the mesh")
    # the host's per-leaf sync (plain folds) is the oracle: the plan of
    # the bucketed sync has no bearing on its bits
    cpu = [tm.tree_map(lambda g: g.cpu(), tr) for tr in trees]
    del trees, per_leaf
    plain = tm.sync_grads(cpu, pspecs, axes, topos, bucket_bytes=0,
                          comm=host)
    if not trees_identical([tm.tree_map(lambda g: g.cpu(), tr)
                            for tr in fused], plain, tm.tree_leaves):
        raise AssertionError(f"{tag}: the sync on the fold kernel is not "
                             f"bitwise the per-leaf sync's plain folds on "
                             f"the host")
    log(f"{tag} sync of seeded slices on "
        f"{dict(zip(axes, mesh.shape))}: plan "
        f"{[(bkt.axes, len(bkt.indices), bkt.nbytes) for bkt in plan]}; "
        f"bucketed == per-leaf bitwise, == the host's per-leaf plain folds "
        f"bitwise; bodies {describe_bodies(seen)}")
    return plan


def sp_fold_checks(dev, tm, bk, ar, rs, spmd, cm, shards, pspecs):
    """Phase 22(a), the fold kernel: the tensor-parallel combine (forward
    and its backward, bf16, the combine's length, W=2) on the card bitwise
    the same on host copies, where the fold is its plain version; the
    bucketed sync of seeded slices on ``SP_MESH`` bitwise the per-leaf
    sync on the card and on host copies (whose bits no bucket plan moves);
    the bodies the kernel took are printed."""
    from flextree_tpu_torch.parallel.mesh import Mesh

    world = math.prod(SP_MESH)
    mesh = Mesh((dev,) * world, tm.AXIS_NAMES, SP_MESH)
    host = Mesh(("cpu",) * world, tm.AXIS_NAMES, SP_MESH)
    dp, sp, tp = SP_MESH
    b, t = FLASH_TRAIN[:2]
    shape = (b // dp, t // sp, MODEL["d_model"])
    seen = combine_check(dev, rs, cm, ar, spmd, mesh, host, shape,
                         "phase 22(a)")
    log(f"phase 22(a) tp combine {tuple(shape)} bf16 on {world} ranks "
        f"({len(spmd.axis(mesh, 'tp').groups)} groups of {tp}), forward and "
        f"backward: bitwise the plain fold on host copies; bodies "
        f"{describe_bodies(seen)}")
    mesh_sync_check(dev, tm, bk, ar, rs, cm, mesh, host, shards, pspecs,
                    "phase 22(a)")


def sp_train_run(trainer, argv, fa, rs):
    """One ``trainer.main`` run, every count set to 0 just before and read
    just after: ``(out, launches, peak bytes, wall s)``."""
    out: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    rs.reduce_sources.launches = 0
    t0 = time.monotonic()
    trainer.main(argv, out=out)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(flash_counts(fa), reduce_sources=rs.reduce_sources.launches)
    return out, launches, torch.cuda.max_memory_allocated(), wall


def phase_sp_tp(dev, smi):
    """Phase 22: sequence and tensor parallelism over a (2, 2, 2) mesh.
    (a) the flash kernels at the path's hop shapes against their plain
    versions (phase 7's bars), the fold at the combine's and the sync's
    shapes bitwise its plain fold on the host; (b) ``trainer.main --mesh
    2,2,2 --sp-impl {ring, zigzag, ulysses}`` at the flagship width (bf16,
    flash, batch 8 x 1024, 6 steps) beside ``--mesh 8,1,1``: the loss
    finite and falling, each kernel's launches the code's count, then the
    steady step of each in turns, the busy share and the peak memory
    (printed, not gated); (c) float32 at full width, each sp_impl on (2, 2,
    2) against one rank, 3 steps on the same batches
    (:func:`sp_f32_equivalence`).  Returns each kernel's launches by
    path."""
    from flextree_tpu_torch import trainer
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_specs,
    )
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as ar
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import spmd
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel.mesh import Mesh, flat_mesh

    # ---- (a) the kernels at this path's shapes
    clock = time.monotonic()
    gen = torch.Generator().manual_seed(SEED + 22)
    for case in sp_flash_cases():
        for tname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            errs, failures, note, _ = flash_compare(fa, case, dtype, dev, gen)
            if failures:
                raise AssertionError(f"phase 22(a) flash "
                                     f"{describe_case(case, tname)}: "
                                     + "; ".join(failures))
            log(f"phase 22(a) flash {describe_case(case, tname)}: "
                f"{describe_errors(errs)}; {note}")
    torch.cuda.empty_cache()
    cfg = TransformerConfig(**MODEL)
    pspecs = param_specs(cfg)
    world = math.prod(SP_MESH)
    full = init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
    shards = spmd.shard_tree(full, pspecs, Mesh((dev,) * world,
                                                tm.AXIS_NAMES, SP_MESH))
    sp_fold_checks(dev, tm, bk, ar, rs, spmd, cm, shards, pspecs)
    leaves = tm.tree_leaves(shards[0])
    specs = bk.spec_leaves(shards[0], pspecs)
    dp_leaves, dp_specs = tm.tree_leaves(full), bk.spec_leaves(full, pspecs)
    del shards
    torch.cuda.empty_cache()

    log(f"phase 22(a): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    # ---- (b) the trainer on (2, 2, 2) by sp_impl, and dp=8 beside it
    layers = MODEL["n_layers"]
    runs, by_path = {}, {}
    for impl in SP_IMPLS + ("dp8",):
        argv = SP_DP_ARGV if impl == "dp8" else SP_ARGV + ["--sp-impl", impl]
        shape = (DP, 1, 1) if impl == "dp8" else SP_MESH
        out, launches, peak, wall = sp_train_run(trainer, argv, fa, rs)
        res = out["result"]
        losses = [loss for _, loss in res.losses]
        if len(losses) != SP_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"phase 22(b) {impl}: losses not finite "
                                 f"and falling: {losses}")
        flash_want = SP_STEPS * sp_flash_launches(
            "ring" if impl == "dp8" else impl, shape, layers)
        combine, sync, plan = sp_fold_launches(
            shape, *((dp_leaves, dp_specs) if impl == "dp8" else
                     (leaves, specs)), ar, bk, tm, rs)
        fold_want = SP_STEPS * (combine + sync)
        if any(launches[k] != flash_want for k in flash_counts(fa)) or \
                launches["reduce_sources"] != fold_want:
            raise AssertionError(
                f"phase 22(b) {impl}: launches {launches}; the code gives "
                f"flash {flash_want} each and folds {fold_want} ({SP_STEPS} "
                f"steps x (combine {combine} + sync {sync}))")
        hist = res.report.metrics["histograms"]["train.step_ms"]
        runs[impl] = dict(out=out, shape=shape, peak=peak, wall=wall,
                          losses=losses, launches=launches, p50=hist["p50"])
        if impl != "dp8":
            by_path[f"sp_{impl}"] = launches
        log(f"phase 22(b) {impl} on mesh {dict(zip(tm.AXIS_NAMES, shape))} "
            f"(flagship, bf16, flash, B=8 T=1024, {SP_STEPS} steps via "
            f"trainer.main): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"launches {launches} = the code's (flash {flash_want}; folds "
            f"{SP_STEPS} x (combine {combine} + sync {sync}), sync plan "
            f"{[(bkt.axes, len(bkt.indices)) for bkt in plan]}); registry "
            f"step_ms p50 {hist['p50']}; peak memory {peak / 2**30:.3f} GiB; "
            f"{wall:.1f} s")
        torch.cuda.empty_cache()
    # steady steps of every run from its trained state, in turns
    b, t = FLASH_TRAIN[:2]
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    steps = {}
    for impl, r in runs.items():
        comm = flat_mesh(DP, dev, "dp") if impl == "dp8" else \
            Mesh((dev,) * world, tm.AXIS_NAMES, SP_MESH)
        steps[impl] = (tm.make_train_step(r["out"]["model_cfg"],
                                          r["out"]["train_cfg"], comm=comm),
                       r["out"]["result"].state)
    times = {k: [] for k in steps}
    order = list(steps)
    for i in range(SP_TIMED + 1):
        for impl in (order if i % 2 else order[::-1]):
            step, state = steps[impl]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = step(state, data[0], data[1])
            float(m["loss"])
            if i:  # the first round warms each step up
                times[impl].append(time.monotonic() - t0)
            steps[impl] = (step, state)
    for impl in order:
        step, state = steps[impl]

        def two_steps(step=step, state=state):
            s = state
            for _ in range(2):
                s, m = step(s, data[0], data[1])
            float(m["loss"])

        # one profile for the family (the ring run), the others' device
        # time not measured (the cut phase 27 needed)
        prof = device_profile(two_steps, f"phase 22(b) profile {impl} "
                              f"(2 steps)", top=False) if impl == PROFILED_SP \
            else {"device_busy_s": None, "device_busy_share": None}
        r = runs[impl]
        r["step_ms"] = float(np.median(times[impl])) * 1e3
        r["busy_share"] = prof["device_busy_share"]
        r["device_ms"] = None if prof["device_busy_s"] is None else \
            prof["device_busy_s"] * 1e3 / 2
    base = runs["dp8"]["step_ms"]
    for impl in order:
        r = runs[impl]
        log(f"phase 22(b) steady {impl}: median step {r['step_ms']:.3f} ms "
            f"({SP_TIMED} steps in turns; {r['step_ms'] / base:.2f}x dp=8's "
            f"{base:.3f}), {b * t / r['step_ms'] * 1e3:.0f} tokens/s; device "
            + ("not measured" if r["device_ms"] is None else
               f"{r['device_ms']:.3f} ms a step, busy "
               f"{100 * r['busy_share']:.1f}% of the wall (torch.profiler)")
            + f"; peak memory {r['peak'] / 2**30:.3f} GiB; {smi}")
    del steps, runs, full, dp_leaves
    torch.cuda.empty_cache()
    log(f"phase 22(b): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    sp_f32_equivalence(dev, cfg, tm)
    log(f"phase 22(c): {time.monotonic() - clock:.1f} s")
    return by_path


def sp_f32_equivalence(dev, cfg, tm):
    """Phase 22(c): float32 at full width, each sp_impl on ``SP_MESH``
    against one rank, ``SP_F32_STEPS`` steps from one state on the same
    batches, flash attention, held to :func:`f32_equivalent`'s bars."""
    from flextree_tpu_torch.data import LMDataset, synthetic_tokens
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel.mesh import Mesh

    t = FLASH_TRAIN[1]
    world = math.prod(SP_MESH)
    dataset = LMDataset(synthetic_tokens(200_000, MODEL["vocab_size"],
                                         seed=SEED),
                        batch=SP_F32_BATCH, seq_len=t, seed=SEED)
    batches = [dataset.batch_at(i) for i in range(SP_F32_STEPS)]
    init = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    lr = tm.TrainConfig().lr
    mesh = Mesh((dev,) * world, tm.AXIS_NAMES, SP_MESH)

    def f32_steps(impl, comm):
        c = TransformerConfig(**MODEL, attn_impl="flash", sp_impl=impl)
        step = tm.make_train_step(c, tm.TrainConfig(), device=dev, comm=comm)
        grads = tm.make_loss_and_grads(c, tm.TrainConfig(), device=dev,
                                       comm=comm)
        state, losses, gs = init, [], []
        for tokens, targets in batches:
            gs.append([g.cpu() for g in tm.tree_leaves(
                grads(state["params"], tokens, targets)[1])])
            state, m = step(state, tokens, targets)
            losses.append(float(m["loss"]))
        return losses, [p.cpu() for p in tm.tree_leaves(state["params"])], gs

    want = f32_steps("ring", None)
    for impl in SP_IMPLS:
        f32_equivalent(f"phase 22(c) f32 {impl} on {SP_MESH} vs one rank "
                       f"({SP_F32_STEPS} steps, B={SP_F32_BATCH} T={t}, full "
                       f"width, flash)", f32_steps(impl, mesh), want, lr,
                       SP_F32_STEPS)


def f32_equivalent(tag, got, want, lr, steps, every_step=False):
    """``got`` against ``want``, each ``(losses, parameter leaves, each
    step's synced gradient leaves)`` of float32 runs from one state on the
    same batches: the losses within rtol 1e-5 and the step-1 gradient
    (``every_step``: every step's) within atol 1e-5, checked; the
    parameters within atol 1e-5 except on
    the elements where AdamW's update is ill-conditioned, picked from
    ``want``'s gradients as ``tests/test_torch_overlap.py`` picks them
    (|g1| < 1e-6 or |(g1, g2)| < 1e-5), which are held to the most the
    updates can move a parameter, 2 lr a step."""
    losses, params, gs = got
    tiny_masks = [(g1.abs() < 1e-6) | (torch.hypot(g1, g2) < 1e-5)
                  for g1, g2 in zip(want[2][0], want[2][1])]
    bound = 2 * lr * steps
    loss_rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(losses, want[0]))
    grad_abs = max((a - b_).abs().max().item()
                   for g, w in list(zip(gs, want[2]))[
                       :steps if every_step else 1]
                   for a, b_ in zip(g, w))
    plain_abs, tiny_abs, n_tiny, worst = 0.0, 0.0, 0, None
    for i, (a, b_, tiny) in enumerate(zip(params, want[1], tiny_masks)):
        gap = (a - b_).abs()
        n_tiny += int(tiny.sum())
        if (~tiny).any() and gap[~tiny].max().item() > plain_abs:
            plain_abs = gap[~tiny].max().item()
            j = torch.where(~tiny, gap, 0).argmax()
            worst = (i, [g[i].reshape(-1)[j].item() for g in want[2]],
                     [(g[i] - h[i]).reshape(-1)[j].item()
                      for g, h in zip(gs, want[2])])
        if tiny.any():
            tiny_abs = max(tiny_abs, gap[tiny].max().item())
    log(f"{tag}: losses {losses} vs {want[0]}, max rel gap {loss_rel:.3g} "
        f"(bar 1e-5); {'every step' if every_step else 'step-1'} synced "
        f"grad max abs gap {grad_abs:.3g} (bar 1e-5); params max abs gap {plain_abs:.3g} (bar 1e-5; the worst at "
        f"leaf {worst and worst[0]}, the reference's grads "
        f"{worst and worst[1]}, the gaps {worst and worst[2]}) and, on the "
        f"{n_tiny} ill-conditioned elements, {tiny_abs:.3g} (AdamW's bound "
        f"{bound:g})")
    if not (loss_rel <= 1e-5 and grad_abs <= 1e-5 and plain_abs <= 1e-5
            and tiny_abs <= bound):
        raise AssertionError(f"{tag}: out of the bars")


# ---------------------------------------------------------------------------
# phase 23: pipeline and expert parallelism

PM_MESH = (1, 2, 2, 2)  # (dp, pp|ep, sp, tp), the JAX trainer's examples
PM_MICRO = 2  # GPipe microbatches a rank
# MoEConfig's defaults: 4 local experts a rank on ep=2, router_aux_weight 1e-2
PM_MOE = dict(n_experts=8, top_k=2, capacity_factor=2.0)
PM_STEPS = 4  # as SP_STEPS (6 before phase 27)
PM_F32_STEPS = 3
PM_F32_BATCH = 2


def pm_argv(model: str) -> list:
    """``trainer.main``'s flags for phase 23(b): phase 22's run with
    ``--model pipeline|moe`` on ``PM_MESH``."""
    argv = TRAIN_ARGV + ["--mesh", ",".join(map(str, PM_MESH))]
    argv[argv.index("--model") + 1] = model
    argv[argv.index("--steps") + 1] = str(PM_STEPS)
    if model == "pipeline":
        return argv + ["--microbatches", str(PM_MICRO)]
    return argv + ["--n-experts", str(PM_MOE["n_experts"]), "--top-k",
                   str(PM_MOE["top_k"]), "--capacity-factor",
                   str(PM_MOE["capacity_factor"])]


def pm_hop(model, shape, batch, seq, heads, micro):
    """``(rows, T_local, heads)`` of one rank's attention: a pipeline
    microbatch (the local rows over ``micro``), or an MoE rank's block
    (the rows over dp x ep)."""
    dp, second, sp, tp = shape
    rows = batch // dp // micro if model == "pipeline" else \
        batch // (dp * second)
    return rows, seq // sp, heads // tp


def pm_flash_launches(model, shape, layers, micro) -> dict:
    """Each flash kernel's launches a step, from the code.  Every rank's
    attention is the causal ring over its sp group
    (:func:`sp_flash_launches`' count a layer).  MoE: every layer once.
    Pipeline: each of the ``micro + pp - 1`` ticks runs every rank's
    ``layers / pp`` stage layers forward, bubbles included; only a stage's
    ``micro`` valid ticks reach a loss, so only they run backward (a
    bubble's output has no cotangent and autograd never reaches it)."""
    dp, second, sp, tp = shape
    per_layer = sp_flash_launches(
        "ring", (math.prod(shape) // (sp * tp), sp, tp), 1)
    if model == "moe":
        return dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             layers * per_layer)
    stage = layers // second
    fwd = (micro + second - 1) * stage * per_layer
    bwd = micro * stage * per_layer
    return {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd}


def pm_fold_launches(model, cfg, shape, batch, seq, micro, leaves, specs,
                     axes, ar, bk, tm, rs):
    """The fold kernel's launches a step, from the code: ``(combine, sync,
    plan)``.  The combine: each tp group's allreduce of a block's
    attention and FFN partials, forward and backward (a pipeline stage
    forward at every tick, backward at its ``micro`` valid ones; an MoE
    layer's expert partials ``(E/ep, ep C, d)``); the sync: each bucket on
    each of its axes, once a group along the axis
    (``sync_fold_stages``)."""
    from flextree_tpu_torch.models.moe import expert_capacity

    dp, second, sp, tp = shape
    world = math.prod(shape)
    sizes = dict(zip(axes, shape))
    d = cfg.d_model

    def folds(count):
        if tp == 1:
            return 0
        return stage_launches(ar.call_shape(tp, None, count).folds,
                              rs.MAX_POINTERS)

    rows, t_local, _ = pm_hop(model, shape, batch, seq, cfg.n_heads, micro)
    block = folds(rows * t_local * d)
    if model == "pipeline":
        ticks = micro + second - 1
        combine = (ticks + micro) * (cfg.n_layers // second) * 2 * \
            (world // tp) * block
    else:
        cap = expert_capacity(rows * t_local, cfg)
        expert = folds(cfg.n_experts // second * second * cap * d)
        combine = 2 * (world // tp) * sum(
            block + (expert if cfg.is_moe_layer(i) else block)
            for i in range(cfg.n_layers))
    topos = tm.resolve_axis_topos(sizes, axes, None)
    plan = bk.plan_buckets(leaves, specs, axes, topos=topos,
                           axis_sizes=sizes)
    numels = [g.numel() for g in leaves]
    sync = sum(world // sizes[ax] * stage_launches(
        bk.sync_fold_stages(numels, sizes[ax], topos[ax], [bkt]),
        rs.MAX_POINTERS) for bkt in plan for ax in bkt.axes)
    return combine, sync, plan


def pm_models(dev):
    """Phase 23's model configs, meshes and parameter specs: ``{model:
    (cfg, mesh, host mesh, pspecs, full params)}`` at the flagship width
    (bf16, flash), the params from seed ``SEED``."""
    from flextree_tpu_torch.models.moe import MoEConfig, moe_param_specs
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import moe_train, pipeline
    from flextree_tpu_torch.parallel.mesh import Mesh

    out = {}
    for model, axes in (("pipeline", pipeline.PIPELINE_AXES),
                        ("moe", moe_train.MOE_AXES)):
        common = dict(MODEL, dtype=torch.bfloat16, attn_impl="flash")
        gen = torch.Generator().manual_seed(SEED)
        if model == "pipeline":
            cfg = TransformerConfig(**common)
            params = pipeline.init_pipeline_train_state(
                cfg, gen, device=dev)["params"]
            pspecs = pipeline.pipeline_param_specs(cfg)
        else:
            cfg = MoEConfig(**common, **PM_MOE)
            params = moe_train.init_moe_train_state(
                cfg, gen, device=dev)["params"]
            pspecs = moe_param_specs(cfg)
        mesh = pipeline.make_mesh_4d(shape=PM_MESH, axis_names=axes,
                                     device=dev)
        host = Mesh(("cpu",) * mesh.size, axes, PM_MESH)
        out[model] = (cfg, mesh, host, pspecs, params)
    return out


def pm_kernel_checks(dev, models, tm, bk, ar, rs, spmd, cm) -> dict:
    """Phase 23(a): the flash kernels at this path's hop shapes (phase
    22(a)'s ring case, asserted the same), the fold at the expert
    combine's shape (bf16, W=2, forward and backward) bitwise its host
    copies, and each model's bucketed sync of seeded slices on
    ``PM_MESH`` bitwise the per-leaf sync and the host's plain folds.
    Returns each model's ``(leaves, specs)`` of one rank's slices."""
    b, t, h, _ = FLASH_TRAIN
    ring = next(c for c in sp_flash_cases() if c[0] == "ring_diag")
    for model in models:
        hop = pm_hop(model, PM_MESH, b, t, h, PM_MICRO)
        if hop != (ring[1], ring[2], ring[4]):
            raise AssertionError(f"phase 23(a): the {model} hop {hop} is "
                                 f"not phase 22(a)'s ring case {ring}")
    log(f"phase 23(a) flash: the pipeline microbatch's and the MoE block's "
        f"ring hop (B={ring[1]} T={ring[2]} H={ring[4]} D={ring[5]}, causal "
        f"resident and past blocks with an lse cotangent) is phase 22(a)'s "
        f"ring case, held there to phase 7's bars")
    from flextree_tpu_torch.models.moe import expert_capacity

    cfg, mesh, host, _, _ = models["moe"]
    rows, t_local, _ = pm_hop("moe", PM_MESH, b, t, h, PM_MICRO)
    ep = PM_MESH[1]
    cap = expert_capacity(rows * t_local, cfg)
    shape = (cfg.n_experts // ep, ep * cap, cfg.d_model)
    seen = combine_check(dev, rs, cm, ar, spmd, mesh, host, shape,
                         "phase 23(a)")
    log(f"phase 23(a) expert combine {shape} bf16 on {mesh.size} ranks "
        f"({len(spmd.axis(mesh, 'tp').groups)} groups of {PM_MESH[3]}; C = "
        f"{cap}), forward and backward: bitwise the plain fold on host "
        f"copies; bodies {describe_bodies(seen)}")
    torch.cuda.empty_cache()
    slices = {}
    for model, (cfg, mesh, host, pspecs, params) in models.items():
        shards = spmd.shard_tree(params, pspecs, mesh)
        mesh_sync_check(dev, tm, bk, ar, rs, cm, mesh, host, shards, pspecs,
                        f"phase 23(a) {model}")
        slices[model] = (tm.tree_leaves(shards[0]),
                         bk.spec_leaves(shards[0], pspecs))
        del shards
        torch.cuda.empty_cache()
    return slices


def pm_train_runs(dev, smi, models, slices, trainer, ckpt, fa, rs, ar, bk,
                  tm):
    """Phase 23(b): ``trainer.main --model pipeline|moe --mesh 1,2,2,2`` at
    the flagship width (bf16, flash, batch 8 x 1024, ``PM_STEPS`` steps,
    warmup-cosine, clipping): the loss finite and falling, each kernel's
    launches the code's count, the checkpoint bitwise the live state;
    then the steady step of both and of phase 22's dense ring run on (2,
    2, 2) in turns, device ms and busy share under ``torch.profiler``,
    peak memory and MoE's aux (printed, not gated).  Returns the launches
    by path."""
    import tempfile

    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import moe_train, pipeline
    from flextree_tpu_torch.parallel.mesh import Mesh

    b, t = FLASH_TRAIN[:2]
    runs, by_path = {}, {}
    for model, (cfg, mesh, _, _, _) in models.items():
        with tempfile.TemporaryDirectory(prefix=f"ft-{model}-") as ckpt_dir:
            out, launches, peak, wall = sp_train_run(
                trainer, pm_argv(model) + ["--ckpt-dir", ckpt_dir], fa, rs)
            res = out["result"]
            saved = ckpt.restore_train_state(ckpt_dir, dev)
            live, back = tm.tree_leaves(res.state), tm.tree_leaves(saved)
            if len(live) != len(back) or not all(
                    a.dtype == b_.dtype and torch.equal(a, b_)
                    for a, b_ in zip(live, back)):
                raise AssertionError(f"phase 23(b) {model}: the checkpoint "
                                     f"does not restore bitwise to the live "
                                     f"state")
        losses = [loss for _, loss in res.losses]
        if len(losses) != PM_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0] or res.report.skipped_steps:
            raise AssertionError(f"phase 23(b) {model}: losses not finite "
                                 f"and falling: {losses}")
        if out["model_cfg"] != cfg or out["comm"] != mesh:
            raise AssertionError(f"phase 23(b) {model}: the trainer built "
                                 f"{out['model_cfg']} on {out['comm']}")
        flash_want = {k: PM_STEPS * n for k, n in pm_flash_launches(
            model, PM_MESH, cfg.n_layers, PM_MICRO).items()}
        combine, sync, plan = pm_fold_launches(
            model, cfg, PM_MESH, b, t, PM_MICRO, *slices[model],
            mesh.axis_names, ar, bk, tm, rs)
        fold_want = PM_STEPS * (combine + sync)
        if {k: launches[k] for k in flash_want} != flash_want or \
                launches["reduce_sources"] != fold_want:
            raise AssertionError(
                f"phase 23(b) {model}: launches {launches}; the code gives "
                f"flash {flash_want} and folds {fold_want} ({PM_STEPS} steps "
                f"x (combine {combine} + sync {sync}))")
        hist = res.report.metrics["histograms"]["train.step_ms"]
        runs[model] = dict(out=out, peak=peak, p50=hist["p50"])
        by_path["pp_train" if model == "pipeline" else "moe_train"] = \
            launches
        log(f"phase 23(b) {model} on mesh "
            f"{dict(zip(mesh.axis_names, PM_MESH))} (flagship, bf16, flash, "
            f"B={b} T={t}, {PM_STEPS} steps via trainer.main): loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches} = the "
            f"code's (flash {flash_want}; folds {PM_STEPS} x (combine "
            f"{combine} + sync {sync}), sync plan "
            f"{[(bkt.axes, len(bkt.indices)) for bkt in plan]}); checkpoint "
            f"restores bitwise; registry step_ms p50 {hist['p50']}; peak "
            f"memory {peak / 2**30:.3f} GiB; {wall:.1f} s")
        torch.cuda.empty_cache()
    # steady steps of both runs from their trained states and of phase
    # 22's dense ring step from a fresh state, in turns
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    steps = {}
    for model, r in runs.items():
        o = r["out"]
        make = pipeline.make_pipeline_train_step if model == "pipeline" \
            else moe_train.make_moe_train_step
        kw = dict(n_microbatches=PM_MICRO) if model == "pipeline" else {}
        steps[model] = (make(o["model_cfg"], o["train_cfg"], comm=o["comm"],
                             **kw), o["result"].state)
    dense = TransformerConfig(**MODEL, dtype=torch.bfloat16,
                              attn_impl="flash", sp_impl="ring")
    tc = runs["pipeline"]["out"]["train_cfg"]
    steps["dense_ring"] = (
        tm.make_train_step(dense, tc, comm=Mesh(
            (dev,) * math.prod(SP_MESH), tm.AXIS_NAMES, SP_MESH)),
        tm.init_train_state(dense, torch.Generator().manual_seed(SEED),
                            device=dev))
    times = {k: [] for k in steps}
    aux = []
    order = list(steps)
    for i in range(SP_TIMED + 1):
        for name in (order if i % 2 else order[::-1]):
            step, state = steps[name]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = step(state, data[0], data[1])
            float(m["loss"])
            if i:  # the first round warms each step up
                times[name].append(time.monotonic() - t0)
            if "aux" in m:
                aux.append(float(m["aux"]))
            steps[name] = (step, state)
    for name in order:
        step, state = steps[name]

        def two_steps(step=step, state=state):
            s = state
            for _ in range(2):
                s, m = step(s, data[0], data[1])
            float(m["loss"])

        # one profile a family: the dense ring's is 22(b)'s
        prof = device_profile(two_steps, f"phase 23(b) profile {name} "
                              f"(2 steps)", top=False) if name in runs \
            else {"device_busy_s": None, "device_busy_share": None}
        ms = float(np.median(times[name])) * 1e3
        dev_ms = None if prof["device_busy_s"] is None else \
            prof["device_busy_s"] * 1e3 / 2
        peak = runs[name]["peak"] if name in runs else None
        log(f"phase 23(b) steady {name}: median step {ms:.3f} ms "
            f"({SP_TIMED} steps in turns), {b * t / ms * 1e3:.0f} tokens/s; "
            f"device "
            + ("not measured" if dev_ms is None else
               f"{dev_ms:.3f} ms a step, busy "
               f"{100 * prof['device_busy_share']:.1f}% of the wall "
               f"(torch.profiler)")
            + ("" if peak is None else
               f"; trainer run's peak memory {peak / 2**30:.3f} GiB")
            + f"; {smi}")
    log(f"phase 23(b) moe aux (router balance, 1.0 = even) over the timed "
        f"steps: {aux}")
    del steps, runs
    torch.cuda.empty_cache()
    return by_path


def pm_f32_equivalence(dev, tm):
    """Phase 23(c): float32 at full width, ``PM_F32_STEPS`` steps from one
    state on the same batches (B=2, T=1024, flash), held to
    :func:`f32_equivalent`'s bars: the pipeline on ``PM_MESH`` against
    one rank's dense step from the same (unstacked) parameters; MoE on
    ``PM_MESH`` against the MoE step on one rank, with ``capacity_factor
    = n_experts / top_k`` (C is a shard's token count, so no shard drops a
    token: the JAX module's condition for the sharded run to equal the
    oracle), ``router_aux_weight = 0`` (the aux is a per-rank mean) and
    AdamW's eps 1e-3.  Both also hold every step's synced gradient to
    atol 1e-5."""
    from flextree_tpu_torch.data import LMDataset, synthetic_tokens
    from flextree_tpu_torch.models.moe import MoEConfig
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import moe_train, pipeline

    t = FLASH_TRAIN[1]
    dataset = LMDataset(synthetic_tokens(200_000, MODEL["vocab_size"],
                                         seed=SEED),
                        batch=PM_F32_BATCH, seq_len=t, seed=SEED)
    batches = [dataset.batch_at(i) for i in range(PM_F32_STEPS)]
    tc = tm.TrainConfig()

    def run(step, grads, init, leaves):
        state, losses, gs = init, [], []
        for tokens, targets in batches:
            gs.append([g.cpu() for g in leaves(
                grads(state["params"], tokens, targets)[1])])
            state, m = step(state, tokens, targets)
            losses.append(float(m["loss"]))
        return losses, [p.cpu() for p in leaves(state["params"])], gs

    cfg = TransformerConfig(**MODEL, attn_impl="flash")
    init = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    want = run(tm.make_train_step(cfg, tc, device=dev),
               tm.make_loss_and_grads(cfg, tc, device=dev), init,
               tm.tree_leaves)
    mesh = pipeline.make_mesh_4d(shape=PM_MESH, device=dev)
    stacked = dict(init, **{k: pipeline.stack_layer_params(init[k])
                            for k in ("params", "mu", "nu")})
    got = run(pipeline.make_pipeline_train_step(cfg, tc, PM_MICRO,
                                                comm=mesh),
              pipeline.make_pipeline_loss_and_grads(cfg, tc, PM_MICRO,
                                                    comm=mesh),
              stacked,
              lambda tree: tm.tree_leaves(pipeline.unstack_layer_params(tree)))
    f32_equivalent(f"phase 23(c) f32 pipeline on {PM_MESH} (M={PM_MICRO}) "
                   f"vs one rank's dense step ({PM_F32_STEPS} steps, "
                   f"B={PM_F32_BATCH} T={t}, full width, flash)", got, want,
                   tc.lr, PM_F32_STEPS, every_step=True)
    del want, got, init, stacked
    torch.cuda.empty_cache()
    mcfg = MoEConfig(**MODEL, attn_impl="flash", n_experts=PM_MOE["n_experts"],
                     top_k=PM_MOE["top_k"],
                     capacity_factor=PM_MOE["n_experts"] / PM_MOE["top_k"],
                     router_aux_weight=0.0)
    init = moe_train.init_moe_train_state(
        mcfg, torch.Generator().manual_seed(SEED), device=dev)
    # AdamW's eps as the JAX package's MoE equivalence test sets it
    # (tests/test_train_features.py:189-193): the experts' many tiny
    # gradients sit in AdamW's g / (|g| + eps) sign regime at eps 1e-8,
    # where it magnifies float reordering's ~1e-7 gradient gaps ~10^4-fold;
    # at 1e-3 the update is Lipschitz in the gradient, so the parameter
    # bar holds steps 2-3's gradients as the gradient bar holds step 1's
    tc = tm.TrainConfig(eps=1e-3)
    want, got = (run(moe_train.make_moe_train_step(mcfg, tc, device=dev,
                                                   comm=comm),
                     moe_train.make_moe_loss_and_grads(mcfg, tc, device=dev,
                                                       comm=comm),
                     init, tm.tree_leaves)
                 for comm in (None, moe_train.make_mesh_moe(
                     shape=PM_MESH, device=dev)))
    f32_equivalent(f"phase 23(c) f32 moe on {PM_MESH} vs one rank "
                   f"({PM_F32_STEPS} steps, B={PM_F32_BATCH} T={t}, full "
                   f"width, flash, capacity_factor "
                   f"{mcfg.capacity_factor}, no aux, AdamW eps {tc.eps:g})",
                   got, want, tc.lr, PM_F32_STEPS, every_step=True)


def phase_pp_moe(dev, smi):
    """Phase 23: pipeline and expert parallelism on (1, 2, 2, 2) meshes,
    (a) :func:`pm_kernel_checks`, (b) :func:`pm_train_runs`, (c)
    :func:`pm_f32_equivalence`.  Returns each kernel's launches by
    path."""
    from flextree_tpu_torch import trainer
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as ar
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import spmd
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.utils import checkpoint as ckpt

    clock = time.monotonic()
    models = pm_models(dev)
    slices = pm_kernel_checks(dev, models, tm, bk, ar, rs, spmd, cm)
    log(f"phase 23(a): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    by_path = pm_train_runs(dev, smi, models, slices, trainer, ckpt, fa, rs,
                            ar, bk, tm)
    del models
    torch.cuda.empty_cache()
    log(f"phase 23(b): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    pm_f32_equivalence(dev, tm)
    log(f"phase 23(c): {time.monotonic() - clock:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 24: lossy codecs, ZeRO-1 and overlap on the wide meshes

WIDE_STEPS = 4  # trainer steps a run: warmup-cosine over them, clipping
# (3 steps end on a harder batch than the first: the loss need not fall)
WIDE_TIMED = 2  # steady steps of each run, in turns with the replicated
# (3 before phase 27)
WIDE_F32_STEPS = 3
WIDE_F32_BATCH = 2
# 24(b)'s runs: (family, option, trainer flags)
WIDE_RUNS = (
    ("dense", "int8", ["--codec", "int8"]),
    ("dense", "zero", ["--shard-optimizer"]),
    ("dense", "overlap", ["--overlap"]),
    ("dense", "zero_overlap", ["--shard-optimizer", "--overlap"]),
    ("pipeline", "int8", ["--codec", "int8"]),
    ("pipeline", "zero", ["--shard-optimizer"]),
    ("pipeline", "overlap", ["--overlap"]),
    ("moe", "int8", ["--codec", "int8"]),
    ("moe", "zero", ["--shard-optimizer"]),
    ("moe", "overlap", ["--overlap"]),
)
# 24(a)'s syncs of seeded slices on the card against host copies:
# (family, "zero" (the sharded reduce-scatter) or "sync" (the replicated
# sync), codec)
WIDE_SYNC_CHECKS = (
    ("dense", "zero", None), ("dense", "zero", "int8"),
    ("pipeline", "zero", None), ("moe", "zero", None),
    ("dense", "sync", "int8"), ("pipeline", "sync", "int8"),
    ("moe", "sync", "bf16"),
)


def wide_argv(family: str, flags: list) -> list:
    """``trainer.main``'s flags for a 24(b) run: phase 22's ring run on
    ``SP_MESH`` or phase 23's run on ``PM_MESH``, ``WIDE_STEPS`` steps
    (the warmup one step: the cosine then decays over the rest), plus
    ``flags``."""
    argv = list(SP_ARGV + ["--sp-impl", "ring"] if family == "dense"
                else pm_argv(family))
    argv[argv.index("--steps") + 1] = str(WIDE_STEPS)
    argv[argv.index("--warmup-steps") + 1] = "1"
    return argv + flags


def wide_models(dev) -> dict:
    """Phase 24's families at the flagship width (bf16, flash): ``{family:
    (cfg, mesh, host mesh, pspecs, full params)}``, phase 23's two models
    and phase 22's dense ring model on ``SP_MESH``."""
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_specs,
    )
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel.mesh import Mesh

    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16, attn_impl="flash",
                            sp_impl="ring")
    world = math.prod(SP_MESH)
    out = {"dense": (cfg, Mesh((dev,) * world, tm.AXIS_NAMES, SP_MESH),
                     Mesh(("cpu",) * world, tm.AXIS_NAMES, SP_MESH),
                     param_specs(cfg),
                     init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device=dev))}
    out.update(pm_models(dev))
    return out


def wide_sizes(mesh, tm):
    axes = mesh.axis_names
    sizes = dict(zip(axes, mesh.shape))
    return axes, sizes, tm.resolve_axis_topos(sizes, axes, None)


@contextlib.contextmanager
def card_plan(plan, *modules):
    """Every ``plan_buckets`` of ``modules`` returns ``plan``: the host
    copies of a sync run the card's buckets (a lossy codec's packing sets
    its block scales, so the host must pack as the card did)."""
    saved = [m.plan_buckets for m in modules]
    for m in modules:
        m.plan_buckets = lambda *a, **k: plan
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.plan_buckets = fn


def wide_sync_check(dev, family, kind, codec, models, tm, bk, ar, rs, cm,
                    spmd, zero):
    """One 24(a) case: the sync of seeded slices shaped like one step's
    gradient on ``family``'s mesh on the card (the ZeRO-1 reduce-scatter
    with its secondary-axis block allreduces, or the replicated sync's
    compressed walks), its fold launches counted by body
    (:func:`fold_bodies`) against ``bucketing.mesh_fold_launches``; then
    the same on host copies with the card's plan (:func:`card_plan`), where
    ``reduce_sources``
    takes its plain fold: every rank's result (blocks and tails) and, under
    a codec, residual bitwise; every fold past the tails on the bulk-copy
    body.  Returns the heaviest secondary-axis fold stage ``(R, W, L)`` of
    a ZeRO case (None otherwise)."""
    cfg, mesh, host, pspecs, params = models[family]
    axes, sizes, topos = wide_sizes(mesh, tm)
    shards = spmd.shard_tree(params, pspecs, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    trees = [tm.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=dev), s) for s in shards]
    del shards
    leaves = tm.tree_leaves(trees[0])
    specs = bk.spec_leaves(trees[0], pspecs)
    sharded = kind == "zero"
    plan = bk.plan_buckets(leaves, specs, axes, topos=topos,
                           axis_sizes=sizes, codec=codec, sharded=sharded)
    want = bk.mesh_fold_launches(leaves, specs, axes, sizes, topos,
                                 codec=codec, sharded=sharded)
    kw = dict(codec=codec or "f32", step=CODEC_STEP,
              return_residual=codec is not None)

    def run(xs, comm, cap):
        if sharded:
            return zero.zero_reduce_scatter_grads(
                xs, pspecs, axes, topos, comm=comm, bucket_bytes=cap, **kw)
        return tm.sync_grads(xs, pspecs, axes, topos, bucket_bytes=cap,
                             comm=comm, **kw)

    what = (f"phase 24(a) {family} {codec or 'f32'} "
            f"{'sharded reduce-scatter' if sharded else 'sync'} on "
            f"{dict(sizes)}")
    t0 = time.monotonic()
    with fold_bodies(rs, cm, ar) as seen:
        got = run(trees, mesh, None)
        torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    if sum(seen.values()) != want:
        raise AssertionError(f"{what}: {sum(seen.values())} fold launches, "
                             f"the code derives {want}")
    cpu = [tm.tree_map(lambda g: g.cpu(), t) for t in trees]
    del trees
    t0 = time.monotonic()
    with card_plan(plan, bk, zero):  # the host's cap would plan otherwise
        plain = run(cpu, host, None)
    host_s = time.monotonic() - t0
    del cpu
    got, plain = (got, plain) if codec else ((got, None), (plain, None))
    if sharded:
        same = shards_identical(got[0], plain[0], tm.tree_leaves)
    else:
        same = trees_identical([tm.tree_map(lambda g: g.cpu(), t)
                                for t in got[0]], plain[0], tm.tree_leaves)
    if not same or (codec and not trees_identical(
            [tm.tree_map(lambda g: g.cpu(), t) for t in got[1]], plain[1],
            tm.tree_leaves)):
        raise AssertionError(f"{what}: the card is not bitwise the host "
                             f"copies (result or residual)")
    tail = len(leaves) * max(sizes.values())
    check_bodies(seen, what, tail)
    heaviest = None
    if sharded:
        numels = [g.numel() for g in leaves]
        for b in plan:
            for ax in b.axes[1:]:
                for st in bk.sync_fold_stages(
                        numels, sizes[ax], topos[ax], [b], codec=codec,
                        shard_n=sizes[b.axes[0]]):
                    if heaviest is None or st[2] > heaviest[2]:
                        heaviest = st
    log(f"{what}: plan {[(b.axes, len(b.indices), b.nbytes) for b in plan]}"
        f"; {want} fold launches = the code's; every rank's "
        f"{'blocks and tails' if sharded else 'result'}"
        f"{' and residual' if codec else ''} bitwise the host copies' plain "
        f"folds; bodies {describe_bodies(seen)}; card {card_s:.2f} s, host "
        f"{host_s:.2f} s")
    del got, plain
    torch.cuda.empty_cache()
    return heaviest


def wide_stage_time(dev, rs, stage, bw, flush, smi) -> dict:
    """The fold stage ``(R, W, L)`` (float32 sum) timed as phase 19(c)
    times the reduce-scatter's: the kernel (one launch), its plain version
    and ``torch.sum(x, 1)`` over the stacked sources, beside the bound
    (each source read once, each fold written once, over the memory
    rate)."""
    r, w, length = stage
    gen = torch.Generator(device=dev).manual_seed(SEED + 241)
    x = torch.randn((r, w, length), generator=gen, device=dev)
    outs = torch.empty((r, length), device=dev)
    folds = [(list(x[f]), outs[f]) for f in range(r)]
    n_bytes = r * (w + 1) * length * 4
    row = {
        "R": r, "W": w, "L": length,
        "ms": time_launches(lambda: rs.reduce_sources(folds, "sum"), 20,
                            flush),
        "plain_ms": time_launches(
            lambda: rs.reduce_sources_plain(folds, "sum"), 10, flush),
        "library_ms": time_launches(lambda: torch.sum(x, 1), 20, flush),
        "bound_ms": n_bytes / bw * 1e3,
    }
    log(f"phase 24(a) heaviest secondary-axis fold stage (the ZeRO-1 "
        f"block allreduce): {r} x (W={w}, L={length}) f32 sum "
        f"({n_bytes / 1e6:.1f} MB), one launch: kernel {row['ms']:.4f} ms "
        f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound "
        f"{row['bound_ms']:.4f} ms); plain {row['plain_ms']:.4f} ms; "
        f"torch.sum(x, 1) {row['library_ms']:.4f} ms (cold L2); {smi}")
    return row


def wide_fold_launches(family, option, models, tm, bk, ar, rs):
    """``(combine, sync)``: the fold kernel's launches a step of a 24(b)
    run, from the code.  The combine is the replicated step's (phase 22's
    or 23's count); the sync is ``train.step_sync_fold_launches`` under
    the option."""
    cfg, mesh, _, pspecs, params = models[family]
    axes = mesh.axis_names
    b, t = FLASH_TRAIN[:2]
    slices = tm.shard_tree(params, pspecs, mesh)[0]
    leaves = tm.tree_leaves(slices)
    specs = bk.spec_leaves(slices, pspecs)
    if family == "dense":
        combine = sp_fold_launches(SP_MESH, leaves, specs, ar, bk, tm, rs)[0]
    else:
        combine = pm_fold_launches(family, cfg, PM_MESH, b, t, PM_MICRO,
                                   leaves, specs, axes, ar, bk, tm, rs)[0]
    tc = tm.TrainConfig(codec="int8" if option == "int8" else "f32",
                        shard_optimizer=option.startswith("zero"),
                        overlap=option.endswith("overlap"))
    sync = tm.step_sync_fold_launches(cfg, tc, params, pspecs, mesh, axes,
                                      (b, t), pipeline=family == "pipeline")
    return combine, sync


def wide_state_bytes(state, layout, zero) -> int:
    """The optimizer-state bytes one rank holds in a sharded state: its
    slot of each ``*_shard`` buffer, its model position's tails, the
    local slice of each unsharded leaf's ``*_rep`` (and the master's
    slots); what ``zero_shard_bytes`` accounts."""
    total = 0
    keys = [k for k in ("mu", "nu", "master") if f"{k}_shard" in state]
    for plan in layout.leaves:
        m = zero._n_model(layout, plan)
        for k in keys:
            if plan.sharded:
                sh = zero.tree_leaves(state[f"{k}_shard"])[plan.index].numel()
                tl = zero.tree_leaves(state[f"{k}_tail"])[plan.index].numel()
                total += 4 * (sh // (plan.n * m) + tl // m)
            elif k != "master":
                total += 4 * plan.size
    return total


def wide_train_runs(dev, smi, models, trainer, ckpt, fa, rs, ar, bk, tm,
                    zero):
    """Phase 24(b): each of ``WIDE_RUNS`` through ``trainer.main`` at the
    flagship width (bf16, flash, batch 8 x 1024, ``WIDE_STEPS`` steps,
    warmup-cosine, clipping) with a checkpoint: the loss finite and
    falling, each flash kernel's and the fold kernel's launches the code's
    count, the checkpoint bitwise the live state (packed as the trainer
    packs it); the optimizer-state bytes a rank of the sharded runs
    against ``zero_shard_bytes`` and the replicated state's; then, per
    family, the steady step of each run and of the replicated step in
    turns, and each run's device time and busy share under
    ``torch.profiler``, and the peak memory (printed, not gated).
    Returns the launches by path."""
    import tempfile

    from flextree_tpu_torch.parallel import moe_train, pipeline

    b, t = FLASH_TRAIN[:2]
    runs, by_path = {}, {}
    for family, option, flags in WIDE_RUNS:
        cfg, mesh, _, pspecs, _ = models[family]
        name = f"wide_{option}_{family}"
        with tempfile.TemporaryDirectory(prefix=f"ft-{name}-") as ckpt_dir:
            out, launches, peak, wall = sp_train_run(
                trainer, wide_argv(family, flags) + ["--ckpt-dir", ckpt_dir],
                fa, rs)
            res = out["result"]
            pack, _ = trainer.sharded_hooks(out["comm"], out["model_cfg"],
                                            res.state["params"],
                                            out["train_cfg"], family)
            live = pack(res.state) if pack else res.state
            saved = ckpt.restore_train_state(ckpt_dir, dev)
            if set(saved) != set(live) or not trees_identical(
                    [live], [saved], tm.tree_leaves):
                raise AssertionError(f"phase 24(b) {name}: the checkpoint "
                                     f"is not the live state (packed), "
                                     f"bitwise")
            del saved, live
        losses = [loss for _, loss in res.losses]
        if len(losses) != WIDE_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0] or res.report.skipped_steps:
            raise AssertionError(f"phase 24(b) {name}: losses not finite "
                                 f"and falling: {losses}")
        tc = out["train_cfg"]
        if (tc.codec, tc.shard_optimizer, tc.overlap) != (
                "int8" if option == "int8" else "f32",
                option.startswith("zero"), option.endswith("overlap")):
            raise AssertionError(f"phase 24(b) {name}: the trainer ran {tc}")
        if family == "dense":
            flash = sp_flash_launches("ring", SP_MESH, cfg.n_layers)
            flash_want = dict.fromkeys(flash_counts(fa), WIDE_STEPS * flash)
        else:
            flash_want = {k: WIDE_STEPS * n for k, n in pm_flash_launches(
                family, PM_MESH, cfg.n_layers, PM_MICRO).items()}
        combine, sync = wide_fold_launches(family, option, models, tm, bk,
                                           ar, rs)
        fold_want = WIDE_STEPS * (combine + sync)
        if {k: launches[k] for k in flash_want} != flash_want or \
                launches["reduce_sources"] != fold_want:
            raise AssertionError(
                f"phase 24(b) {name}: launches {launches}; the code gives "
                f"flash {flash_want} and folds {fold_want} ({WIDE_STEPS} "
                f"steps x (combine {combine} + sync {sync}))")
        state_note = ""
        if tc.shard_optimizer:
            layout = tm.zero_layout_for(out["comm"], res.state["params"],
                                        pspecs, out["comm"].axis_names)
            acct = zero.zero_shard_bytes(layout)
            live_b = wide_state_bytes(res.state, layout, zero)
            if live_b != acct["sharded_bytes_per_rank"]:
                raise AssertionError(f"phase 24(b) {name}: {live_b} B of "
                                     f"moments a rank live, zero_shard_bytes "
                                     f"says {acct}")
            state_note = (f"; optimizer state a rank {live_b} B = "
                          f"zero_shard_bytes', against the replicated "
                          f"{acct['replicated_bytes']} B (ratio "
                          f"{acct['ratio']:.4f})")
        hist = res.report.metrics["histograms"]["train.step_ms"]
        runs[name] = dict(out=out, family=family, peak=peak,
                          p50=hist["p50"])
        by_path[name] = launches
        log(f"phase 24(b) {name} on mesh "
            f"{dict(zip(mesh.axis_names, mesh.shape))} (flagship, bf16, "
            f"flash, B={b} T={t}, {WIDE_STEPS} steps via trainer.main "
            f"{' '.join(flags)}): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"launches {launches} = the code's (flash {flash_want}; folds "
            f"{WIDE_STEPS} x (combine {combine} + sync {sync})); checkpoint "
            f"bitwise the live state{state_note}; registry step_ms p50 "
            f"{hist['p50']}; peak memory {peak / 2**30:.3f} GiB; "
            f"{wall:.1f} s")
        del res
        torch.cuda.empty_cache()
    # steady steps, per family: each run's step from its trained state and
    # the replicated step from a fresh state, in turns
    data = np.random.default_rng(SEED).integers(
        0, MODEL["vocab_size"], (2, b, t)).astype(np.int32)
    for family in ("dense", "pipeline", "moe"):
        cfg, mesh, _, pspecs, _ = models[family]
        names = [n for n, r in runs.items() if r["family"] == family]
        rep_tc = dataclasses.replace(runs[names[0]]["out"]["train_cfg"],
                                     codec="f32", shard_optimizer=False,
                                     overlap=False)
        gen = torch.Generator().manual_seed(SEED)

        def make(tc_, family=family, cfg=cfg, mesh=mesh):
            if family == "pipeline":
                return pipeline.make_pipeline_train_step(
                    cfg, tc_, PM_MICRO, comm=mesh)
            if family == "moe":
                return moe_train.make_moe_train_step(cfg, tc_, comm=mesh)
            return tm.make_train_step(cfg, tc_, comm=mesh)

        if family == "pipeline":
            rep_state = pipeline.init_pipeline_train_state(cfg, gen,
                                                           device=dev)
        elif family == "moe":
            rep_state = moe_train.init_moe_train_state(cfg, gen, device=dev)
        else:
            rep_state = tm.init_train_state(cfg, gen, device=dev)
        steps = {"replicated": (make(rep_tc), rep_state)}
        for n in names:
            o = runs[n]["out"]
            steps[n] = (make(o["train_cfg"]), o["result"].state)
        times = {k: [] for k in steps}
        order = list(steps)
        for i in range(WIDE_TIMED + 1):
            for k in (order if i % 2 else order[::-1]):
                step, state = steps[k]
                torch.cuda.synchronize()
                t0 = time.monotonic()
                state, m = step(state, data[0], data[1])
                float(m["loss"])
                if i:  # the first round warms each step up
                    times[k].append(time.monotonic() - t0)
                steps[k] = (step, state)
        base = float(np.median(times["replicated"])) * 1e3
        for k in order:
            ms = float(np.median(times[k])) * 1e3
            prof = {"device_busy_s": None}
            # one profile a family (its first run), the cut phase 27 needed
            if k == names[0]:
                step, state = steps[k]

                def one_step(step=step, state=state):
                    float(step(state, data[0], data[1])[1]["loss"])

                prof = device_profile(one_step, f"phase 24(b) profile {k} "
                                      f"(1 step)", top=False)
            dev_ms = None if prof["device_busy_s"] is None else \
                prof["device_busy_s"] * 1e3
            log(f"phase 24(b) steady {family} {k}: median step {ms:.3f} ms "
                f"({WIDE_TIMED} steps in turns; {ms / base:.3f}x the "
                f"replicated step's {base:.3f}), {b * t / ms * 1e3:.0f} "
                f"tokens/s; device "
                + ("not measured" if dev_ms is None else
                   f"{dev_ms:.3f} ms a step, busy "
                   f"{100 * prof['device_busy_share']:.1f}% of the wall "
                   f"(torch.profiler)")
                + ("" if k == "replicated" else
                   f"; trainer run's peak memory "
                   f"{runs[k]['peak'] / 2**30:.3f} GiB")
                + f"; {smi}")
        del steps
        torch.cuda.empty_cache()
    del runs
    torch.cuda.empty_cache()
    return by_path


def wide_f32_bits(dev, tm):
    """Phase 24(c): float32 at full width (flash, B=2, T=1024),
    ``WIDE_F32_STEPS`` steps from one state on the same batches, for each
    family on its mesh: the sharded step bitwise the replicated one
    (clipping off: the loss, the parameters, and the consolidated moments
    the replicated ``mu``/``nu``); the overlapped step bitwise the
    replicated one; the int8 overlapped step bitwise its serialized twin,
    every rank's ``ef`` included."""
    from flextree_tpu_torch.data import LMDataset, synthetic_tokens
    from flextree_tpu_torch.models.moe import MoEConfig, moe_param_specs
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        param_specs,
    )
    from flextree_tpu_torch.parallel import moe_train, pipeline, zero
    from flextree_tpu_torch.parallel.mesh import Mesh

    t = FLASH_TRAIN[1]
    dataset = LMDataset(synthetic_tokens(200_000, MODEL["vocab_size"],
                                         seed=SEED),
                        batch=WIDE_F32_BATCH, seq_len=t, seed=SEED)
    batches = [dataset.batch_at(i) for i in range(WIDE_F32_STEPS)]
    for family in ("dense", "pipeline", "moe"):
        clock = time.monotonic()
        if family == "moe":
            cfg = MoEConfig(**MODEL, attn_impl="flash", **PM_MOE)
            mesh = moe_train.make_mesh_moe(shape=PM_MESH, device=dev)
            pspecs, axes = moe_param_specs(cfg), moe_train.MOE_AXES

            def init(tc_, cfg=cfg, mesh=mesh):
                return moe_train.init_moe_train_state(
                    cfg, torch.Generator().manual_seed(SEED), tc_,
                    device=dev, comm=mesh)

            def make(tc_, serialize=False, cfg=cfg, mesh=mesh):
                return moe_train.make_moe_train_step(
                    cfg, tc_, comm=mesh, serialize_overlap=serialize)
        elif family == "pipeline":
            cfg = TransformerConfig(**MODEL, attn_impl="flash")
            mesh = pipeline.make_mesh_4d(shape=PM_MESH, device=dev)
            pspecs = pipeline.pipeline_param_specs(cfg)
            axes = pipeline.PIPELINE_AXES

            def init(tc_, cfg=cfg, mesh=mesh):
                return pipeline.init_pipeline_train_state(
                    cfg, torch.Generator().manual_seed(SEED), tc_,
                    device=dev, comm=mesh)

            def make(tc_, serialize=False, cfg=cfg, mesh=mesh):
                return pipeline.make_pipeline_train_step(
                    cfg, tc_, PM_MICRO, comm=mesh,
                    serialize_overlap=serialize)
        else:
            cfg = TransformerConfig(**MODEL, attn_impl="flash",
                                    sp_impl="ring")
            mesh = Mesh((dev,) * math.prod(SP_MESH), tm.AXIS_NAMES, SP_MESH)
            pspecs, axes = param_specs(cfg), tm.AXIS_NAMES

            def init(tc_, cfg=cfg, mesh=mesh):
                return tm.init_train_state(
                    cfg, torch.Generator().manual_seed(SEED), tc_,
                    device=dev, comm=mesh)

            def make(tc_, serialize=False, cfg=cfg, mesh=mesh):
                return tm.make_train_step(cfg, tc_, comm=mesh,
                                          serialize_overlap=serialize)

        def run(tc_, serialize=False):
            state, losses, step = init(tc_), [], make(tc_, serialize)
            for tokens, targets in batches:
                state, m = step(state, tokens, targets)
                losses.append(float(m["loss"]))
            return state, losses

        def same(a, b_):
            return trees_identical([a], [b_], tm.tree_leaves)

        base = tm.TrainConfig()
        rep, rep_losses = run(base)
        sh, sh_losses = run(dataclasses.replace(base, shard_optimizer=True))
        cons = zero.make_consolidate_fn(
            mesh, pspecs, tm.zero_layout_for(mesh, sh["params"], pspecs,
                                             axes), None, False)(sh)
        if sh_losses != rep_losses or not same(sh["params"], rep["params"]) \
                or not same(cons["mu"], rep["mu"]) or \
                not same(cons["nu"], rep["nu"]):
            raise AssertionError(f"phase 24(c) {family}: the sharded step is "
                                 f"not the replicated step bitwise")
        del sh, cons
        ovl, ovl_losses = run(dataclasses.replace(base, overlap=True))
        if ovl_losses != rep_losses or not same(ovl, rep):
            raise AssertionError(f"phase 24(c) {family}: the overlapped step "
                                 f"is not the replicated step bitwise")
        del ovl, rep
        int8 = dataclasses.replace(base, codec="int8", overlap=True)
        a, _ = run(int8)
        twin, _ = run(int8, serialize=True)
        if not same({k: v for k, v in a.items() if k != "ef"},
                    {k: v for k, v in twin.items() if k != "ef"}) or \
                not trees_identical(a["ef"], twin["ef"], tm.tree_leaves):
            raise AssertionError(f"phase 24(c) {family}: the int8 overlapped "
                                 f"step is not its serialized twin bitwise")
        nonzero = sum(int((x != 0).sum()) for e in a["ef"]
                      for x in tm.tree_leaves(e))
        del a, twin
        torch.cuda.empty_cache()
        log(f"phase 24(c) f32 {family} on {dict(zip(axes, mesh.shape))} "
            f"({WIDE_F32_STEPS} steps, B={WIDE_F32_BATCH} T={t}, full width, "
            f"flash): sharded = replicated bitwise (losses {rep_losses}, "
            f"params, consolidated moments); overlapped = replicated "
            f"bitwise; int8 overlapped = its serialized twin bitwise, "
            f"{nonzero} non-zero ef elements over the ranks included; "
            f"{time.monotonic() - clock:.1f} s")


def phase_wide(dev, smi, bw):
    """Phase 24: lossy codecs, ZeRO-1 and overlap on the wide meshes
    (dense (2, 2, 2), pipeline and MoE (1, 2, 2, 2)): (a)
    :func:`wide_sync_check` on each of ``WIDE_SYNC_CHECKS`` and the
    heaviest secondary-axis fold stage timed (:func:`wide_stage_time`);
    (b) :func:`wide_train_runs`; (c) :func:`wide_f32_bits`.  Returns
    ``(launches by path, the stage's times)``."""
    from flextree_tpu_torch import trainer
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as ar
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import spmd
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel import zero
    from flextree_tpu_torch.utils import checkpoint as ckpt

    clock = time.monotonic()
    models = wide_models(dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    heaviest = None
    for family, kind, codec in WIDE_SYNC_CHECKS:
        st = wide_sync_check(dev, family, kind, codec, models, tm, bk, ar,
                             rs, cm, spmd, zero)
        if st is not None and codec is None and (
                heaviest is None or st[0] * (st[1] + 1) * st[2] >
                heaviest[0] * (heaviest[1] + 1) * heaviest[2]):
            heaviest = st
    stage = wide_stage_time(dev, rs, heaviest, bw, flush, smi)
    del flush
    torch.cuda.empty_cache()
    log(f"phase 24(a): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    by_path = wide_train_runs(dev, smi, models, trainer, ckpt, fa, rs, ar,
                              bk, tm, zero)
    del models
    torch.cuda.empty_cache()
    log(f"phase 24(b): {time.monotonic() - clock:.1f} s")
    clock = time.monotonic()
    wide_f32_bits(dev, tm)
    log(f"phase 24(c): {time.monotonic() - clock:.1f} s")
    return by_path, stage


# phase 25: the supervised training run
AT_STEPS = 3  # trainer.main --autotune steps at dp=8
SIG_STEPS = 8  # the SIGTERM run's steps, each run a process of its own
SIG_AT = 3  # the logged step that triggers the signal
SIG_LINE = "I flextree_tpu_torch.train] step "
SHRINK_WORLD = 4  # dp ranks before the shrink; 3 after
SHRINK_BATCH = 12  # global rows: a multiple of 4 and of 3
SHRINK_STEPS = 8
SHRINK_KILL = 3  # the step during which a peer process is SIGKILLed
SHRINK_LEASE_S = 1.5  # FT_LEASE of the roster (FT_STRAGGLER half of it)
WD_STEPS = 4
WD_STALL = 2  # the step that stalls on the host, once
WD_TIMEOUT_S = 3.0
SUP_BENCH_REPEAT = 5
# a heartbeat peer: beats as rank argv[2] into argv[1] until killed
PEER_CODE = """
import sys, time
sys.path.insert(0, '.')
from flextree_tpu_torch.runtime import Supervisor, SupervisorConfig
Supervisor(SupervisorConfig.from_env(rank=int(sys.argv[2]),
                                     dir=sys.argv[1])).start()
time.sleep(900)
"""


@contextlib.contextmanager
def env_vars(**values):
    """``os.environ`` with ``values`` set for the block, then as it was."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_fold_launches(tm, cfg, tc, params, n, dev, batch):
    """The fold kernel's launches of one dp=``n`` step's sync, from the
    code (``train.step_sync_fold_launches``)."""
    from flextree_tpu_torch.models.transformer import param_specs
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    return tm.step_sync_fold_launches(cfg, tc, params, param_specs(cfg),
                                      flat_mesh(n, dev, "dp"),
                                      tm.AXIS_NAMES, batch)


def autotune_checks(dev, trainer, fa, rs, tm, cm, params, cache):
    """Phase 25(a): the autotuner on the card, its cache hit, the winner's
    allreduce bitwise its host copies, and ``trainer.main --mesh 8,1,1
    --autotune`` on the cached winner.  Returns the trainer run's
    launches."""
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel.mesh import flat_mesh
    from flextree_tpu_torch.planner import autotune as at

    nbytes = sum(p.numel() * p.element_size() for p in tm.tree_leaves(params))
    # the call the trainer's knob makes (ir_families=(): the train sync
    # runs legacy topologies), so its cache entry is the trainer's
    kw = dict(codecs=("f32",), top_k=3, repeat=3, cache_path=cache,
              ir_families=(), device=dev)
    torch.cuda.synchronize()
    rs.reduce_sources.launches = 0
    t0 = time.monotonic()
    plan = at.autotune_plan(DP, nbytes, **kw)
    torch.cuda.synchronize()
    tune_s, tune_launches = time.monotonic() - t0, rs.reduce_sources.launches
    if plan.source != "measured" or not tune_launches:
        raise AssertionError(f"the first autotune did not measure: "
                             f"{plan.source}, {tune_launches} fold launches")
    rs.reduce_sources.launches = 0
    t0 = time.monotonic()
    hit = at.autotune_plan(DP, nbytes, **kw)
    hit_s, hit_launches = time.monotonic() - t0, rs.reduce_sources.launches
    if hit.source != "cache" or hit_launches or \
            hit.to_ft_topo() != plan.to_ft_topo():
        raise AssertionError(f"the second autotune is not a pure cache hit: "
                             f"{hit.source}, {hit_launches} fold launches, "
                             f"{hit.to_ft_topo()} vs {plan.to_ft_topo()}")

    def rows(table):
        return [(w if isinstance(w, str) else tuple(w), lon, c, p, m)
                for w, lon, c, p, m in table]

    # the winner is the fastest measured row by construction; what can
    # fail is the cache: its entry must hold the measured table exactly
    if rows(hit.table) != rows(plan.table) or \
            (hit.predicted_us, hit.measured_us) != \
            (plan.predicted_us, plan.measured_us):
        raise AssertionError(f"the cache entry's table {hit.table} is not "
                             f"the measured one {plan.table}")
    spec = plan.to_ft_topo()
    log(f"phase 25(a) autotune ({DP} ranks, the flagship gradient, {nbytes} "
        f"B f32, top 3, 3 rounds in turns): " + "; ".join(
            f"{'*'.join(map(str, w)) if not isinstance(w, str) else w}"
            f"{'+' + str(lon) if lon else ''} predicted {p:.1f} us, "
            f"measured {m:.1f} us" for w, lon, _, p, m in plan.table)
        + f"; winner {spec} ({plan.measured_us:.1f} us, the fastest row "
        f"by construction; the analytic argmin's {plan.table[0][4]:.1f} us) "
        f"in {tune_s:.2f} s with {tune_launches} fold launches; the second "
        f"call a cache hit in {hit_s * 1e3:.2f} ms with {hit_launches} "
        f"launches, its table the measured one")
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    seen = host_case(spec, DP, 1, nbytes // 4, "f32", gen, dev, flat_mesh,
                     cm, rs)
    log(f"phase 25(a) the winner's allreduce ({spec}, {DP} ranks, "
        f"{nbytes // 4} f32) on the card is bitwise its host copies; fold "
        f"bodies: {describe_bodies(seen)}")
    torch.cuda.empty_cache()
    with env_vars(FLEXTREE_PLAN_CACHE=cache):
        out, launches, peak, wall = sp_train_run(
            trainer, TRAIN_ARGV + ["--mesh", f"{DP},1,1", "--steps",
                                   str(AT_STEPS), "--autotune"], fa, rs)
    tc = out["train_cfg"]
    if tc.grad_topo != {"dp": spec} or tc.autotune:
        raise AssertionError(f"trainer --autotune ran grad_topo "
                             f"{tc.grad_topo}, the cached winner is {spec}")
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16, attn_impl="flash")
    per_step = dp_fold_launches(tm, cfg, tc, params, DP, dev,
                                FLASH_TRAIN[:2])
    want = AT_STEPS * MODEL["n_layers"] * DP
    if launches["reduce_sources"] != AT_STEPS * per_step or any(
            launches[k] != want for k in flash_counts(fa)):
        raise AssertionError(f"trainer --autotune launches {launches}: fold "
                             f"{AT_STEPS} x {per_step}, flash {want}")
    losses = [loss for _, loss in out["result"].losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"trainer --autotune losses {losses}")
    log(f"phase 25(a) trainer.main --mesh {DP},1,1 --autotune: grad_topo "
        f"{tc.grad_topo} (the cached winner), {AT_STEPS} steps in "
        f"{wall:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; fold "
        f"launches {launches['reduce_sources']} = {AT_STEPS} x {per_step} "
        f"(sync_fold_stages of the plan); flash {want} each")
    return launches


def trainer_process(args, ckpt_dir, signal_at=None):
    """``python -m flextree_tpu_torch.trainer`` in a process of its own:
    ``(exit code, stdout, stderr lines, wall time of the SIGTERM)``, the
    signal sent once step ``signal_at`` is logged (None: never)."""
    import signal

    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("FT_RANK", None)  # the log lines keep the unranked format
    proc = subprocess.Popen(
        [sys.executable, "-m", "flextree_tpu_torch.trainer", *args,
         "--ckpt-dir", ckpt_dir], cwd=HERE, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines, sent = [], None
    try:
        for line in proc.stderr:
            lines.append(line)
            at = line.find(SIG_LINE)
            if signal_at is not None and sent is None and at >= 0 and int(
                    line[at + len(SIG_LINE):].split()[0]) >= signal_at:
                sent = time.time()
                proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, lines, sent


def logged_after(lines, sent) -> list:
    """The step numbers of ``lines`` logged after wall time ``sent``."""
    import datetime

    steps = []
    for line in lines:
        at = line.find(SIG_LINE)
        if at > 0:
            stamp = datetime.datetime.strptime(
                line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
            if stamp > sent:
                steps.append(int(line[at + len(SIG_LINE):].split()[0]))
    return steps


def sigterm_checks(ckpt, tm, tmp):
    """Phase 25(b): the dp=1 flagship trainer, a process of its own,
    signalled mid-run: a checkpoint within one step of the signal, the
    preempted line and exit 0; a relaunch resumes and ends bitwise where a
    straight-through run of the same steps ends."""
    args = TRAIN_ARGV + ["--steps", str(SIG_STEPS), "--ckpt-every", "1000"]

    def final(d):
        return ckpt.restore_train_state(d, "cpu")

    def timed(*a):
        clock = time.monotonic()
        return trainer_process(*a), time.monotonic() - clock

    # the straight-through run and the signalled one start together
    straight = os.path.join(tmp, "straight")
    ck = os.path.join(tmp, "preempted")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        first = ex.submit(timed, args, straight)
        rc, out, lines, sent = trainer_process(args, ck, SIG_AT)
        (src, _, slines, _), straight_s = first.result()
    if src:
        raise AssertionError(f"the straight-through run exited {src}: "
                             f"{''.join(slines[-10:])}")
    last = out.strip().splitlines()[-1] if out.strip() else ""
    if rc or sent is None or "checkpointed)" not in last:
        raise AssertionError(f"the signalled run exited {rc}, last line "
                             f"{last!r}: {''.join(lines[-10:])}")
    at = int(last.rsplit("preempted at step ", 1)[1].split(",")[0])
    after = logged_after(lines, sent)
    saved = ckpt.latest_checkpoint(ck)
    if len(after) > 1 or not saved.endswith(f"ckpt_{at:08d}.npz") or \
            at >= SIG_STEPS:
        raise AssertionError(f"preempted at {at} ({saved}), steps logged "
                             f"after the signal {after}")
    rc, out, lines, _ = trainer_process(args, ck)
    if rc or f"(resumed from {at})" not in out:
        raise AssertionError(f"the relaunch exited {rc}: {out[-500:]}")
    got, want = final(ck), final(straight)
    same = int(got["step"]) == SIG_STEPS and all(
        same_bits(a, b) for a, b in zip(tm.tree_leaves(got),
                                        tm.tree_leaves(want)))
    if not same:
        again = os.path.join(tmp, "straight2")
        trainer_process(args, again)
        twin = all(same_bits(a, b) for a, b in zip(
            tm.tree_leaves(final(again)), tm.tree_leaves(want)))
        raise AssertionError(
            f"the resumed run is not bitwise the straight-through run; two "
            f"straight-through runs are {'' if twin else 'NOT '}bitwise "
            f"equal")
    log(f"phase 25(b) SIGTERM (dp=1 flagship trainer processes, {SIG_STEPS} "
        f"steps): signalled after step {SIG_AT} was logged, checkpointed "
        f"and exited 0 at step {at} (steps logged after the signal: "
        f"{after}); the relaunch resumed from {at} and its step-"
        f"{SIG_STEPS} state is bitwise the straight-through run's "
        f"(that process {straight_s:.1f} s, beside the signalled one)")


def shrink_checks(dev, fa, rs, tm, bk, ckpt, params, tmp):
    """Phase 25(c): ``fit`` over dp=4 in-process ranks with a heartbeat
    roster of 4 (ranks 1-3 beaten by peer processes); one peer SIGKILLed,
    the lease runs out, the survivors shrink to dp=3 (the replanned
    topology, the newest checkpoint restored, the dp=3 step from
    ``on_shrink``) and finish; launches the code's count; the survivors'
    sync at its new lengths bitwise its host copies.  Returns the run's
    launches."""
    import signal

    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel.loop import FitConfig, Supervision, fit
    from flextree_tpu_torch.parallel.mesh import flat_mesh
    from flextree_tpu_torch.planner.choose import replan_for_survivors
    from flextree_tpu_torch.runtime import (
        MembershipView,
        Supervisor,
        SupervisorConfig,
    )
    from flextree_tpu_torch.utils import profiling as spans

    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16, attn_impl="flash")
    tc = tm.TrainConfig(grad_clip_norm=1.0)
    nbytes = sum(p.numel() * p.element_size() for p in tm.tree_leaves(params))
    hb = os.path.join(tmp, "hb")
    os.makedirs(hb)
    lease = dict(FT_LEASE=str(SHRINK_LEASE_S),
                 FT_STRAGGLER=str(SHRINK_LEASE_S / 2))
    env = dict(os.environ, PYTHONPATH=HERE, **lease)
    peers = {r: subprocess.Popen([sys.executable, "-c", PEER_CODE, hb,
                                  str(r)], cwd=HERE, env=env)
             for r in range(1, SHRINK_WORLD)}
    ran = collections.Counter()  # steps run by each world size
    topos: list = []

    def counted(step, n, before=None):
        def run(state, tokens, targets):
            if before is not None:
                before(int(state["step"]))
            ran[n] += 1
            return step(state, tokens, targets)
        return run

    def kill(at):
        if at == SHRINK_KILL and peers[3].poll() is None:
            peers[3].send_signal(signal.SIGKILL)
            time.sleep(SHRINK_LEASE_S + 1.0)  # the lease runs out

    def on_shrink(n_alive, plan):
        topos.append(plan.to_ft_topo())
        comm = flat_mesh(n_alive, dev, "dp")
        tc3 = dataclasses.replace(tc, grad_topo=plan.to_ft_topo())
        return counted(tm.make_train_step(cfg, tc3, comm=comm), n_alive), \
            comm, None

    try:
        deadline = time.monotonic() + 120
        while not all(os.path.exists(os.path.join(hb, f"hb_{r:05d}.json"))
                      for r in peers):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in peers.values()):
                raise AssertionError("the heartbeat peers did not start")
            time.sleep(0.2)
        dataset = data_mod.LMDataset(
            data_mod.synthetic_tokens(1_000_000, MODEL["vocab_size"],
                                      seed=SEED),
            batch=SHRINK_BATCH, seq_len=FLASH_TRAIN[1], seed=SEED)
        state = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                                    tc, device=dev)
        step4 = tm.make_train_step(cfg, tc, comm=flat_mesh(SHRINK_WORLD, dev,
                                                           "dp"))
        with env_vars(**lease):
            sup_cfg = SupervisorConfig.from_env(rank=0, dir=hb)
            sup = Supervision(
                supervisor=Supervisor(sup_cfg),
                membership=MembershipView.for_config(
                    sup_cfg, configured=SHRINK_WORLD),
                configured_world=SHRINK_WORLD, on_shrink=on_shrink,
                nbytes_hint=nbytes)
            torch.cuda.synchronize()
            zero_flash_counts(fa)
            rs.reduce_sources.launches = 0
            t0 = time.monotonic()
            res = fit(state, counted(step4, SHRINK_WORLD, kill), dataset,
                      FitConfig(num_steps=SHRINK_STEPS,
                                ckpt_dir=os.path.join(tmp, "shrink"),
                                ckpt_every=2, log_every=1),
                      supervision=sup)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = dict(flash_counts(fa),
                            reduce_sources=rs.reduce_sources.launches)
    finally:
        for p in peers.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    epochs = res.report.membership_epochs
    replan = replan_for_survivors(SHRINK_WORLD - 1, nbytes,
                                  configured=SHRINK_WORLD).to_ft_topo()
    if [e["alive"] for e in epochs] != [SHRINK_WORLD, SHRINK_WORLD - 1] or \
            epochs[1]["dead"] != [3] or topos != [epochs[1]["topo"]] or \
            epochs[1]["topo"] != replan:
        raise AssertionError(f"membership epochs {epochs}, on_shrink topos "
                             f"{topos}, the replan {replan}")
    restored = SHRINK_STEPS - ran[SHRINK_WORLD - 1]
    if restored != epochs[1]["step"] // 2 * 2 or \
            ran[SHRINK_WORLD] != SHRINK_KILL + 1:
        raise AssertionError(f"steps by world {dict(ran)}: the dp=3 run did "
                             f"not start from the newest checkpoint before "
                             f"step {epochs[1]['step']}")
    losses = [loss for _, loss in res.losses]
    if not all(np.isfinite(losses)) or res.steps_run != SHRINK_STEPS:
        raise AssertionError(f"shrink run losses {losses}, "
                             f"{res.steps_run} steps")
    batch = (SHRINK_BATCH, FLASH_TRAIN[1])
    per = {n: dp_fold_launches(tm, cfg, dataclasses.replace(
        tc, grad_topo=None if n == SHRINK_WORLD else topos[0]), params, n,
        dev, batch) for n in ran}
    want_fold = sum(ran[n] * per[n] for n in ran)
    want_flash = sum(ran[n] * n for n in ran) * MODEL["n_layers"]
    if launches["reduce_sources"] != want_fold or any(
            launches[k] != want_flash for k in flash_counts(fa)):
        raise AssertionError(f"shrink run launches {launches}: fold "
                             f"{want_fold} ({dict(ran)} steps x {per}), "
                             f"flash {want_flash}")
    log(f"phase 25(c) live shrink (fit, flagship bf16 flash, global batch "
        f"{SHRINK_BATCH} x {FLASH_TRAIN[1]}, roster of {SHRINK_WORLD}, "
        f"FT_LEASE {SHRINK_LEASE_S} s): peer 3 SIGKILLed in step "
        f"{SHRINK_KILL}; membership epochs "
        + " -> ".join(f"{e['alive']} at step {e['step']} (topo {e['topo']})"
                      for e in epochs)
        + f"; restored step {restored}; steps by world {dict(ran)}; "
        f"{SHRINK_STEPS} steps in {wall:.2f} s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; fold launches {launches['reduce_sources']} = "
        f"{' + '.join(f'{ran[n]} x {per[n]}' for n in sorted(ran))}; flash "
        f"{want_flash} each")
    # the survivors' sync at its new lengths against its host copies
    gen = torch.Generator(device=dev).manual_seed(SEED + 253)
    trees = [tm.tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                               device=dev), params)
             for _ in range(SHRINK_WORLD - 1)]
    buckets, got, tree_bytes = check_sync(trees, topos[0], 1, dev, flat_mesh,
                                          tm, bk, rs, spans)
    log(f"phase 25(c) the survivors' sync ({SHRINK_WORLD - 1} ranks, topo "
        f"{topos[0]}, {len(buckets)} buckets of {tree_bytes} B a rank): "
        f"per-leaf and bucketed bitwise, fold launches {got} the code's, "
        f"bitwise its host copies")
    return launches


def watchdog_checks(dev, fa, tm, ckpt, tmp):
    """Phase 25(d): a dp=1 flagship ``fit`` whose step stalls once on the
    host: timed out, retried and bitwise an undisturbed run, the stalled
    worker's step released and finished afterwards; the periodic saves on
    a ``BackgroundSaver``, and one of its checkpoints bitwise the live
    state while later steps run.  Returns the supervised run's launches
    (the abandoned step's included)."""
    import threading

    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel.loop import FitConfig, Supervision, fit
    from flextree_tpu_torch.runtime import BackgroundSaver

    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16, attn_impl="flash")
    tc = tm.TrainConfig(grad_clip_norm=1.0)
    dataset = data_mod.LMDataset(
        data_mod.synthetic_tokens(1_000_000, MODEL["vocab_size"], seed=SEED),
        batch=FLASH_TRAIN[0], seq_len=FLASH_TRAIN[1], seed=SEED)
    init = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED), tc,
                               device=dev)
    step = tm.make_train_step(cfg, tc, device=dev)
    plain = fit(init, step, dataset, FitConfig(num_steps=WD_STEPS,
                                               log_every=0))
    release, finished, stalled = threading.Event(), threading.Event(), []

    def stalling(state, tokens, targets):
        if int(state["step"]) == WD_STALL and not stalled:
            stalled.append(threading.current_thread().name)
            release.wait(300)  # a host stall, past the deadline
            try:
                return step(state, tokens, targets)
            finally:
                torch.cuda.synchronize()
                finished.set()
        return step(state, tokens, targets)

    saver = BackgroundSaver(os.path.join(tmp, "wd"))
    try:
        torch.cuda.synchronize()
        zero_flash_counts(fa)
        t0 = time.monotonic()
        res = fit(init, stalling, dataset,
                  FitConfig(num_steps=WD_STEPS,
                            ckpt_dir=os.path.join(tmp, "wd"), ckpt_every=2,
                            log_every=0),
                  supervision=Supervision(step_timeout_s=WD_TIMEOUT_S,
                                          max_step_retries=1,
                                          background_saver=saver))
        wall = time.monotonic() - t0
        release.set()
        if not finished.wait(300):
            raise AssertionError("the abandoned step never finished")
        launches = flash_counts(fa)
    finally:
        release.set()
        saver.close()
    rep = res.report
    same = all(same_bits(a, b) for a, b in zip(tm.tree_leaves(res.state),
                                               tm.tree_leaves(plain.state)))
    want = (WD_STEPS + 1) * MODEL["n_layers"]
    if (rep.step_timeouts, rep.step_retries) != (1, 1) or not same or \
            rep.background_saves < 1 or any(v != want
                                            for v in launches.values()):
        raise AssertionError(
            f"watchdog run: {rep.step_timeouts} timeouts, {rep.step_retries} "
            f"retries, bitwise {same}, {rep.background_saves} background "
            f"saves, flash launches {launches} (want {want})")
    # a background checkpoint of the live state while later steps run
    live = res.state
    with BackgroundSaver(os.path.join(tmp, "bg")) as bg:
        bg.submit(live)
        st = live
        tokens, targets = dataset.batch_at(WD_STEPS)
        for _ in range(2):
            st, _m = step(st, tokens, targets)
        if not bg.drain(120):
            raise AssertionError("the background save did not land")
    saved = ckpt.restore_train_state(os.path.join(tmp, "bg"), "cpu")
    if not all(same_bits(a.cpu(), b) for a, b in
               zip(tm.tree_leaves(live), tm.tree_leaves(saved))):
        raise AssertionError("the background checkpoint is not bitwise the "
                             "live state")
    log(f"phase 25(d) watchdog (dp=1 flagship fit, {WD_STEPS} steps, "
        f"deadline {WD_TIMEOUT_S} s): step {WD_STALL} stalled on the host, "
        f"timed out and retried ({rep.step_timeouts} timeout, "
        f"{rep.step_retries} retry) in {wall:.2f} s; the run is bitwise the "
        f"undisturbed one; the abandoned step finished after it; flash "
        f"launches {want} each = {WD_STEPS + 1} steps x "
        f"{MODEL['n_layers']} layers; {rep.background_saves} background "
        f"saves; a background checkpoint taken while 2 more steps ran is "
        f"bitwise the live state")
    return launches


def supervision_bench(dev, smi):
    """Phase 25(d): the train-step bench's supervised and recorded rows at
    the flagship width over dp=8, timed in turns (printed, not gated)."""
    from flextree_tpu_torch.bench.harness import (
        TrainStepBenchConfig,
        run_train_step_bench,
    )

    out = run_train_step_bench(TrainStepBenchConfig(
        n_layers=MODEL["n_layers"], d_model=MODEL["d_model"],
        d_ff=MODEL["d_ff"], n_heads=MODEL["n_heads"],
        vocab_size=MODEL["vocab_size"], batch=FLASH_TRAIN[0],
        seq_len=FLASH_TRAIN[1], devices=DP, repeat=SUP_BENCH_REPEAT,
        supervised=True, recorder=True, device=str(dev)))
    rows = out["rows"]
    fused = rows["ours_fused"]
    sup, rec = rows["ours_fused_supervised"], rows["ours_fused_recorded"]
    log(f"phase 25(d) bench ({smi}; flagship bf16 flash, dp={DP}, "
        f"{SUP_BENCH_REPEAT} rounds in turns; printed, not gated): "
        f"ours_fused min {fused['train_step_ms']:.3f} ms (median "
        f"{fused['train_step_median_ms']:.3f}); ours_fused_supervised min "
        f"{sup['train_step_ms']:.3f} ms (median "
        f"{sup['train_step_median_ms']:.3f}), supervision_overhead "
        f"{sup['supervision_overhead']:.4f}; ours_fused_recorded min "
        f"{rec['train_step_ms']:.3f} ms (median "
        f"{rec['train_step_median_ms']:.3f}), recorder_overhead "
        f"{rec['recorder_overhead']:.4f}; all bitwise the per-leaf step")
    return rows


def phase_supervised(dev, smi):
    """Phase 25: the supervised training run — (a) :func:`autotune_checks`,
    (b) :func:`sigterm_checks`, (c) :func:`shrink_checks`, (d)
    :func:`watchdog_checks` and :func:`supervision_bench`.  Returns the
    launches by path (``autotune``, ``shrink``, ``supervised_watchdog``)."""
    import tempfile

    from flextree_tpu_torch import trainer
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.utils import checkpoint as ckpt

    params = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device=dev)
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="ft-sup-") as tmp:
        for part, run in (
            ("a", lambda: by_path.update(autotune=autotune_checks(
                dev, trainer, fa, rs, tm, cm, params,
                os.path.join(tmp, "plans.json")))),
            ("b", lambda: sigterm_checks(ckpt, tm, tmp)),
            ("c", lambda: by_path.update(shrink=shrink_checks(
                dev, fa, rs, tm, bk, ckpt, params, tmp))),
            ("d", lambda: (by_path.update(
                supervised_watchdog=watchdog_checks(dev, fa, tm, ckpt, tmp)),
                supervision_bench(dev, smi))),
        ):
            clock = time.monotonic()
            run()
            torch.cuda.empty_cache()
            log(f"phase 25({part}): {time.monotonic() - clock:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 26: the closed-loop planner feedback
FB_EVERY = 2  # trainer --feedback-every of 26(b): ticks at steps 2, 4, 6
FB_STEPS = 7  # the refit comes at the second tick (6 probes a tick, 8 due)
FB_PF_EVERY = 4  # 26(c): a tick every 4 steps ...
FB_PF_TICKS = 2  # ... 2 ticks a rotated plan (8 steps, 7 of them sampled)
FB_PF_CYCLES = 2  # passes over (4 MiB, the cap, the base size)
# the detection tick, 3 plans x 2 cycles x 2 ticks, the fit's tick, a tail
FB_PF_STEPS = FB_PF_EVERY * (1 + 3 * FB_PF_CYCLES * FB_PF_TICKS + 3)
FB_FLOOR_STEPS = 3  # timed steps of the sync-free twin
FB_HOOK_CALLS = 100_000
FB_TURNS = 4  # rounds of 26(b)'s skewed and refit steps in turns
FB_OFF_STEPS = 3


def probe_fold_launches(bk, rs, probes, n) -> dict:
    """Each probe's fold launches in one allreduce, from the code
    (``sync_fold_stages`` of one leaf of the probe's length)."""
    from flextree_tpu_torch.schedule.stages import Topology

    return {p: stage_launches(bk.sync_fold_stages(
        [p.nbytes // 4], n, Topology.resolve(
            n, "1" if p.spec == "ring" else p.spec)), rs.MAX_POINTERS)
        for p in probes}


def probe_checks(dev, fb, rs, bk, cm, flat_mesh, nbytes):
    """Phase 26(a): the flagship gradient's default probes at dp=8 through
    the controller's own timer: launches the code's count, each probe's
    allreduce bitwise the plain fold of its host copies, measured beside
    predicted.  Returns the fold launches."""
    ctl = fb.FeedbackController(DP, nbytes, fb.FeedbackConfig(), device=dev)
    probes = ctl.probes
    if [(p.spec, p.nbytes) for p in probes] != [
            (s, nb) for s in ("8", "2,2,2", "ring")
            for nb in (4 << 20, 512 << 10)]:
        raise AssertionError(f"the flagship's probe points are {probes}")
    per = probe_fold_launches(bk, rs, probes, DP)
    torch.cuda.synchronize()
    rs.reduce_sources.launches = 0
    secs = ctl._default_timer(probes, DP)
    torch.cuda.synchronize()
    launches = rs.reduce_sources.launches
    want = sum(per.values()) * (1 + ctl.cfg.repeat)
    if launches != want:
        raise AssertionError(f"the probe timer launched the fold {launches} "
                             f"times, the code's count is {want}")
    for p in probes:
        rows = ctl._inputs[(DP, p.nbytes // 4)]
        got = ctl._fns[p]()
        host = cm.compressed_allreduce([r.cpu() for r in rows],
                                       flat_mesh(DP, "cpu"),
                                       "1" if p.spec == "ring" else p.spec)
        if not all(same_bits(a.cpu(), b) for a, b in zip(got, host)):
            raise AssertionError(f"probe {p}: the card is not bitwise the "
                                 f"plain fold of its host copies")
    log("phase 26(a) the probe timer (flagship gradient at dp=8, "
        f"{ctl.cfg.repeat} rounds in turns; each allreduce bitwise its host "
        f"copies; {launches} fold launches = the code's, "
        f"{sum(per.values())} a round x {1 + ctl.cfg.repeat}): " + "; ".join(
            f"{p.spec} {p.nbytes} B measured {s * 1e6:.1f} us, predicted "
            f"{fb.predict_spec_us(p.spec, DP, p.nbytes, ctl.params):.1f} us"
            for p, s in zip(probes, secs)))
    return launches


def flight_events(obs_dir):
    from flextree_tpu_torch.obs.timeline import read_dir

    return read_dir(obs_dir)[0]


def steps_buckets(events) -> dict:
    """``{step: [bucket bytes in order]}`` of a recorded run's
    ``bucket_planned`` spans between each step's start and end."""
    out, cur = {}, None
    for ev in events:
        if ev["kind"] == "step_start":
            cur = out.setdefault(ev["step"], [])
        elif ev["kind"] == "step_end":
            cur = None
        elif ev["kind"] == "bucket_planned" and cur is not None:
            cur.append(ev["nbytes"])
    return out


def plan_of(bk, tm, params, cfg, cost_params=None, bucket_bytes=None):
    """The flagship sync's bucket bytes at dp=8 on the card."""
    from flextree_tpu_torch.models.transformer import param_specs

    sizes = {"dp": DP, "sp": 1, "tp": 1}
    return [b.nbytes for b in bk.plan_buckets(
        tm.tree_leaves(params), bk.spec_leaves(params, param_specs(cfg)),
        tm.AXIS_NAMES, topos=tm.resolve_axis_topos(sizes, tm.AXIS_NAMES,
                                                   None),
        axis_sizes=sizes, params=cost_params, bucket_bytes=bucket_bytes)]


def bucket_host_checks(lengths, dev, flat_mesh, cm, rs, seed) -> str:
    """Each distinct bucket length's allreduce on the card bitwise the
    plain fold of its host copies."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    seen = collections.Counter()
    for count in sorted(set(lengths)):
        seen.update(host_case("8", DP, 1, count, "f32", gen, dev, flat_mesh,
                              cm, rs))
    return describe_bodies(seen)


def convergence_checks(dev, fa, rs, bk, tm, cm, ckpt, flat_mesh, params,
                       cfg, tmp):
    """Phase 26(b): ``trainer.main --mesh 8,1,1 --feedback-every`` from a
    skewed calibration.  Returns the run's launches and its steady step
    (ms)."""
    from flextree_tpu_torch import trainer
    from flextree_tpu_torch.planner import autotune as at
    from flextree_tpu_torch.planner import calibrate as cal
    from flextree_tpu_torch.planner import feedback as fb
    from flextree_tpu_torch.planner.cost_model import TpuCostParams
    from flextree_tpu_torch.tools.feedback_convergence import skew_params

    nbytes = sum(p.numel() * p.element_size() for p in tm.tree_leaves(params))
    skew = skew_params()
    skew_plan = plan_of(bk, tm, params, cfg, skew)
    if skew_plan == plan_of(bk, tm, params, cfg, TpuCostParams()):
        raise AssertionError("the skewed constants plan the oracle's buckets: "
                             "the scenario proves nothing")
    host = os.path.join(tmp, "CALIBRATION.json")
    cal.save_calibration(host, skew, backend="cuda",
                         fingerprint=cal.backend_fingerprint(dev))
    with open(host, "rb") as f:
        host_bytes = f.read()
    cache = os.path.join(tmp, "plans.json")
    obs, ck = os.path.join(tmp, "obs_b"), os.path.join(tmp, "ck_b")
    os.environ.pop("FLEXTREE_CALIBRATION_BACKEND", None)
    with env_vars(FLEXTREE_CALIBRATION=host, FLEXTREE_PLAN_CACHE=cache):
        seeded = at.autotune_plan(DP, nbytes, codecs=("f32",), top_k=2,
                                  repeat=2, cache_path=cache, ir_families=(),
                                  device=dev)
        with open(cache) as f:
            (key,) = json.load(f)["entries"]
        argv = TRAIN_ARGV + ["--mesh", f"{DP},1,1", "--steps", str(FB_STEPS),
                             "--feedback-every", str(FB_EVERY), "--obs-dir",
                             obs, "--ckpt-dir", ck]
        out, launches, peak, wall = sp_train_run(trainer, argv, fa, rs)
        if os.environ["FLEXTREE_CALIBRATION"] != host or \
                "FLEXTREE_CALIBRATION_BACKEND" in os.environ:
            raise AssertionError("trainer.main left the calibration "
                                 "variables repointed")
        skew_per_step = dp_fold_launches(tm, cfg, out["train_cfg"], params,
                                         DP, dev, FLASH_TRAIN[:2])
    with open(host, "rb") as f:
        if f.read() != host_bytes:
            raise AssertionError("a refit wrote the host's calibration file")
    rep = out["result"].report
    events = flight_events(obs)
    replans = [e for e in events if e["kind"] == "feedback_replan"]
    ticks = [e for e in events if e["kind"] == "feedback_tick"]
    if rep.feedback_replans < 1 or not replans or \
            not all(e["swapped"] for e in replans):
        raise AssertionError(f"no swapped replan: report {rep.feedback_refits}"
                             f" refits, {rep.feedback_replans} replans, "
                             f"{rep.feedback_refusals} refusals; {replans}")
    with open(os.path.join(obs, "CALIBRATION.feedback.json")) as f:
        sec = json.load(f)["cuda"]
    if sec["source"] != "feedback" or not sec["meta"].get("samples"):
        raise AssertionError(f"the refit section: {sec}")
    with open(cache) as f:
        if key in json.load(f)["entries"]:
            raise AssertionError("the seeded plan-cache entry survived the "
                                 "refit")
    refit = cal._params_from_dict(sec["params"])
    at_step = replans[0]["step"]
    refit_plan = plan_of(bk, tm, params, cfg, refit)
    by_step = steps_buckets(events)
    before = {s: b for s, b in by_step.items() if s < at_step}
    after = {s: b for s, b in by_step.items() if s >= at_step}
    if len(replans) != 1 or any(b != skew_plan for b in before.values()) or \
            any(b != refit_plan for b in after.values()) or not after:
        raise AssertionError(f"the synced buckets: before the replan at "
                             f"{at_step} {before}, after {after}; the skewed "
                             f"plan {skew_plan}, the refit's {refit_plan}")
    bodies = bucket_host_checks([nb // 4 for nb in refit_plan], dev,
                                flat_mesh, cm, rs, SEED + 26)
    with env_vars(FLEXTREE_CALIBRATION=os.path.join(
            obs, "CALIBRATION.feedback.json"),
            FLEXTREE_CALIBRATION_BACKEND="cuda"):
        refit_per_step = dp_fold_launches(tm, cfg, out["train_cfg"], params,
                                          DP, dev, FLASH_TRAIN[:2])
    fb_probes = probe_fold_launches(
        bk, rs, fb.default_probe_points(DP, nbytes), DP)
    probe_launches = sum(fb_probes.values()) * (1 + 3 * len(ticks))
    want_fold = skew_per_step * at_step + \
        refit_per_step * (FB_STEPS - at_step) + probe_launches
    want_flash = FB_STEPS * MODEL["n_layers"] * DP
    if launches["reduce_sources"] != want_fold or any(
            launches[k] != want_flash for k in flash_counts(fa)):
        raise AssertionError(
            f"launches {launches}: fold {skew_per_step} x {at_step} + "
            f"{refit_per_step} x {FB_STEPS - at_step} + probes "
            f"{probe_launches} = {want_fold}, flash {want_flash}")
    saved = ckpt.restore_train_state(ck, dev)
    state = out["result"].state
    if not all(same_bits(a, b) for a, b in zip(tm.tree_leaves(state),
                                               tm.tree_leaves(saved))):
        raise AssertionError("the checkpoint is not the live state bitwise")
    losses = [loss for _, loss in out["result"].losses]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the losses {losses}")
    turns = plan_turns(dev, tm, cfg, out, {
        "skewed": host, "refit": os.path.join(obs,
                                              "CALIBRATION.feedback.json")})
    log(f"phase 26(b) trainer.main --mesh {DP},1,1 --feedback-every "
        f"{FB_EVERY} ({FB_STEPS} steps, flagship bf16 flash) from a skewed "
        f"calibration (plan {len(skew_plan)} buckets; the seeded cache entry "
        f"{seeded.source}): ticks at {[e['step'] for e in ticks]} taking "
        f"{[e['elapsed_ms'] for e in ticks]} ms, "
        f"refit and swapped replan at step {at_step} (topo "
        f"{replans[0]['topo']}, {replans[0]['invalidated']} cache entries "
        f"dropped; {sec['meta']['samples']} samples, fit "
        f"{sec['meta']['fit'].get('drifted_phase')}); the refit plan "
        f"{len(refit_plan)} buckets {refit_plan}, each bitwise its host "
        f"copies ({bodies}); fold launches {launches['reduce_sources']} = "
        f"{skew_per_step} x {at_step} + {refit_per_step} x "
        f"{FB_STEPS - at_step} + probes {probe_launches}, flash {want_flash} "
        f"each; the host's file unchanged; the checkpoint the live state "
        f"bitwise; loss {losses[0]:.4f} -> {losses[-1]:.4f}; the step on the "
        f"skewed plan and on the refit plan in turns ({FB_TURNS} rounds, the "
        f"run's final state; printed, not gated): " + ", ".join(
            f"{k} min {r['min_ms']:.3f} ms, median {r['median_ms']:.3f}"
            for k, r in turns.items())
        + f", {turns['skewed']['median_ms'] / turns['refit']['median_ms']:.3f}"
        f"x; peak {peak / 2**30:.3f} GiB; {wall:.2f} s")
    return launches, turns["refit"]["median_ms"]


def plan_turns(dev, tm, cfg, out, calibrations) -> dict:
    """The trainer run's step on its final state under each of
    ``calibrations`` (the sync plans its buckets from the one in force),
    timed in turns (``bench.harness._interleaved_times``)."""
    from flextree_tpu_torch.bench.harness import _interleaved_times

    step = tm.make_train_step(cfg, out["train_cfg"], device=dev,
                              comm=out["comm"])
    gen = torch.Generator().manual_seed(SEED + 28)
    toks, tgts = (torch.randint(0, MODEL["vocab_size"], FLASH_TRAIN[:2],
                                generator=gen) for _ in range(2))
    state = out["result"].state

    def pinned(path):
        def call():
            with env_vars(FLEXTREE_CALIBRATION=path,
                          FLEXTREE_CALIBRATION_BACKEND="cuda"):
                step(state, toks, tgts)

        call()  # warm, outside the timed rounds
        return call

    return _interleaved_times({k: pinned(p) for k, p in calibrations.items()},
                              FB_TURNS, dev)


def probe_free_checks(dev, fa, rs, bk, tm, cm, flat_mesh, params, cfg, tmp):
    """Phase 26(c): ``fit`` at dp=8 with the probe-free controller from a
    skewed calibration, its probe timer raising; then the same run with
    rotation off.  Returns the run's launches."""
    from flextree_tpu_torch.bench.harness import make_nosync_train_step
    from flextree_tpu_torch.data import LMDataset, synthetic_tokens
    from flextree_tpu_torch.obs import flight_recorder
    from flextree_tpu_torch.parallel.loop import FitConfig, Supervision, fit
    from flextree_tpu_torch.planner import calibrate as cal
    from flextree_tpu_torch.planner import feedback as fb
    from flextree_tpu_torch.tools.feedback_convergence import skew_params
    from flextree_tpu_torch.tools.probe_free_feedback import CountedSteps
    from flextree_tpu_torch.utils.profiling import span_ledger

    nbytes = sum(p.numel() * p.element_size() for p in tm.tree_leaves(params))
    comm = flat_mesh(DP, dev, "dp")
    tc = tm.TrainConfig(grad_clip_norm=1.0)
    data = LMDataset(synthetic_tokens(1_000_000, MODEL["vocab_size"],
                                      seed=SEED), batch=FLASH_TRAIN[0],
                     seq_len=FLASH_TRAIN[1], seed=SEED)

    def state0():
        return tm.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                                   tc, device=dev, comm=comm)

    # the compute floor: the sync-free twin, which enters no span
    nosync = make_nosync_train_step(cfg, tc, device=dev, comm=comm)
    st, (toks, tgts) = state0(), data.batch_at(0)
    times = []
    with span_ledger() as ledger:
        for _ in range(FB_FLOOR_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nosync(st, toks, tgts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    if ledger.names:
        raise AssertionError(f"the sync-free twin entered spans "
                             f"{ledger.names[:4]}")
    floor_us = min(times[1:]) * 1e6
    del st, nosync

    def forbidden(probes, n):
        raise AssertionError("the probe timer ran in the probe-free run")

    def run(rotate: bool):
        live = os.path.join(tmp, f"pf_{rotate}.json")
        cal.save_calibration(live, skew_params(), backend="cuda",
                             fingerprint=cal.backend_fingerprint(dev))
        steps = CountedSteps(
            lambda c: tm.make_train_step(cfg, c, device=dev, comm=comm),
            cfg, params, comm, dev)
        rotations = []

        def on_rotate(bb):
            rotations.append(int(bb))
            return (steps(dataclasses.replace(tc, bucket_bytes=int(bb))),
                    comm, None)

        ctl = fb.FeedbackController(
            DP, nbytes, fb.FeedbackConfig(
                every_k=FB_PF_EVERY, band=0.5, probe_free=True,
                compute_floor_us=floor_us, rotation_ticks=FB_PF_TICKS,
                rotation_cycles=FB_PF_CYCLES, calibration_path=live,
                plan_cache_path=os.path.join(tmp, "pf_plans.json"),
                on_rotate=on_rotate if rotate else None,
                on_replan=lambda plan, p: (steps(tc), comm, None),
                run_id="chip_smoke"),
            params=skew_params(), timer=forbidden, device=dev)
        obs = os.path.join(tmp, f"obs_c_{rotate}")
        torch.cuda.synchronize()
        zero_flash_counts(fa)
        rs.reduce_sources.launches = 0
        t0 = time.monotonic()
        with env_vars(FLEXTREE_CALIBRATION=live,
                      FLEXTREE_CALIBRATION_BACKEND="cuda"), \
                flight_recorder(obs, 0):
            res = fit(state0(), steps(tc), data,
                      FitConfig(num_steps=FB_PF_STEPS, log_every=0,
                                prefetch=0),
                      supervision=Supervision(feedback=ctl))
        torch.cuda.synchronize()
        launches = dict(flash_counts(fa),
                        reduce_sources=rs.reduce_sources.launches)
        with open(live) as f:
            sec = json.load(f)["cuda"]
        return dict(res=res, ctl=ctl, launches=launches,
                    expected=steps.expected, rotations=rotations, sec=sec,
                    obs=obs, wall=time.monotonic() - t0)

    a = run(True)
    rep, ctl = a["res"].report, a["ctl"]
    events = flight_events(a["obs"])
    probes = [e for e in events if e["kind"] == "feedback_tick"
              and e.get("probes")]
    errors = [e for e in events if e["kind"] == "feedback_error"]
    want_flash = FB_PF_STEPS * MODEL["n_layers"] * DP
    if a["launches"]["reduce_sources"] != a["expected"] or probes or \
            errors or any(a["launches"][k] != want_flash
                          for k in flash_counts(fa)):
        raise AssertionError(
            f"the probe-free run: launches {a['launches']}, its steps' syncs "
            f"{a['expected']}, flash {want_flash}; probing ticks {probes}, "
            f"errors {errors}")
    fit_meta = a["sec"]["meta"].get("fit", {})
    refusals = [e.get("reason") for e in events
                if e["kind"] == "feedback_refused"]
    if not a["rotations"] or rep.feedback_refits < 1 or \
            a["sec"]["source"] != "feedback" or \
            fit_meta.get("mode") != "probe-free" or \
            not fit_meta.get("phase_scales"):
        raise AssertionError(
            f"no probe-free refit: rotations {a['rotations']}, "
            f"{rep.feedback_refits} refits, {rep.feedback_refusals} "
            f"refusals ({refusals}); "
            f"the section {a['sec']['source']} {fit_meta}")
    lengths = [nb // 4 for bb in sorted(set(a["rotations"]))
               for nb in plan_of(bk, tm, params, cfg, bucket_bytes=bb)]
    bodies = bucket_host_checks(lengths, dev, flat_mesh, cm, rs, SEED + 27)
    b = run(False)
    if b["rotations"] or b["res"].report.feedback_refits or \
            b["launches"]["reduce_sources"] != b["expected"]:
        raise AssertionError(f"the run with rotation off rotated or refit: "
                             f"{b['rotations']}, {b['res'].report}")
    if not all(same_bits(x, y) for x, y in zip(
            tm.tree_leaves(a["res"].state), tm.tree_leaves(b["res"].state))):
        raise AssertionError("the rotated run's final state is not bitwise "
                             "the run with rotation off")
    rows = fit_meta.get("plan_rows", {})
    log(f"phase 26(c) probe-free fit at dp={DP} ({FB_PF_STEPS} steps, "
        f"flagship bf16 flash, a tick every {FB_PF_EVERY} steps) from a "
        f"skewed calibration, the probe timer raising: compute floor "
        f"{floor_us / 1e3:.3f} ms (the sync-free twin, {FB_FLOOR_STEPS} "
        f"steps, no span); rotations through bucket sizes {a['rotations']}, "
        f"{rep.feedback_refits} probe-free refit(s) ({fit_meta.get('submode')}"
        f", phase scales {fit_meta.get('phase_scales')}, drift "
        f"{fit_meta.get('drifted_phase')}, implied floor "
        f"{fit_meta.get('floor_implied_us')} us), plans " + "; ".join(
            f"{r['fixed_us']} us fixed, {r['steps']} steps, min "
            f"{r['step_us'] / 1e3:.3f} ms" for r in rows.values())
        + f"; 0 probe launches: fold {a['launches']['reduce_sources']} = "
        f"the steps' syncs' by the code, flash {want_flash} each; each "
        f"rotated bucket length bitwise its host copies ({bodies}); the "
        f"final state bitwise the run with rotation off; "
        f"{a['wall']:.2f} s and {b['wall']:.2f} s")
    return a["launches"], a["obs"]


def recorder_off_checks(dev, fa, rs, tm, flat_mesh, params, cfg, step_ms):
    """Phase 26(d): with no recorder the armed controller never ticks and
    launches no probe fold; its hook's host cost a step, timed directly."""
    from flextree_tpu_torch.data import LMDataset, synthetic_tokens
    from flextree_tpu_torch.parallel.loop import FitConfig, Supervision, fit
    from flextree_tpu_torch.planner import feedback as fb

    def exploding(probes, n):
        raise AssertionError("the probe timer ran with the recorder off")

    nbytes = sum(p.numel() * p.element_size() for p in tm.tree_leaves(params))
    ctl = fb.FeedbackController(DP, nbytes, fb.FeedbackConfig(every_k=1),
                                timer=exploding, device=dev)
    t0 = time.perf_counter()
    for i in range(FB_HOOK_CALLS):
        ctl.maybe_tick(i)
    hook_us = (time.perf_counter() - t0) / FB_HOOK_CALLS * 1e6
    comm = flat_mesh(DP, dev, "dp")
    tc = tm.TrainConfig()
    state = tm.init_train_state(cfg, torch.Generator().manual_seed(SEED), tc,
                                device=dev, comm=comm)
    data = LMDataset(synthetic_tokens(200_000, MODEL["vocab_size"],
                                      seed=SEED), batch=FLASH_TRAIN[0],
                     seq_len=FLASH_TRAIN[1], seed=SEED)
    torch.cuda.synchronize()
    rs.reduce_sources.launches = 0
    fit(state, tm.make_train_step(cfg, tc, device=dev, comm=comm), data,
        FitConfig(num_steps=FB_OFF_STEPS, log_every=0, prefetch=0),
        supervision=Supervision(feedback=ctl))
    torch.cuda.synchronize()
    want = FB_OFF_STEPS * dp_fold_launches(tm, cfg, tc, params, DP, dev,
                                           FLASH_TRAIN[:2])
    if ctl.ticks or rs.reduce_sources.launches != want:
        raise AssertionError(f"recorder off: {ctl.ticks} ticks, "
                             f"{rs.reduce_sources.launches} fold launches "
                             f"(the steps' syncs {want})")
    log(f"phase 26(d) recorder off: the armed hook never ticked; "
        f"{FB_OFF_STEPS} steps launched the fold {want} times, the syncs' "
        f"own; the hook costs {hook_us:.4f} us a step on the host "
        f"({FB_HOOK_CALLS} calls), "
        f"{hook_us / (step_ms * 1e3):.2e} of the {step_ms:.3f} ms step")


def fleet_checks(dirs):
    """Phase 26(e): ``python -m flextree_tpu_torch.obs fleet`` over the
    phase's obs dirs."""
    import io

    from flextree_tpu_torch.obs.__main__ import main as obs_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_cli(["fleet", *dirs, "--json"])
    doc = json.loads(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"obs fleet fitted nothing: {doc}")
    log("phase 26(e) obs fleet over " + ", ".join(
        os.path.basename(d) for d in dirs) + ": runs " + "; ".join(
        f"{os.path.basename(r['dir'])} {r['samples']} samples "
        f"{r['mode'] or 'refused'} condition {r['condition']}"
        for r in doc["runs"]) + "; pooled " + "; ".join(
        f"{fp}: {e['samples']} samples from {e['runs']} runs, {e['mode']}, "
        f"condition {e['condition']}, drift {e['drifted_phase']}"
        for fp, e in doc["pooled"].items()))


def phase_feedback(dev, smi):
    """Phase 26: the closed-loop planner feedback — (a)
    :func:`probe_checks`, (b) :func:`convergence_checks`, (c)
    :func:`probe_free_checks`, (d) :func:`recorder_off_checks`, (e)
    :func:`fleet_checks`.  Returns the launches by path
    (``feedback_probe``, ``feedback_train``, ``feedback_probe_free``)."""
    import tempfile

    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel.mesh import flat_mesh
    from flextree_tpu_torch.planner import feedback as fb
    from flextree_tpu_torch.utils import checkpoint as ckpt

    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16, attn_impl="flash")
    params = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device=dev)
    nbytes = sum(p.numel() * p.element_size() for p in tm.tree_leaves(params))
    by_path = {}
    log(f"phase 26 ({smi}): the flagship gradient {nbytes} B a rank at "
        f"dp={DP}")
    with tempfile.TemporaryDirectory(prefix="ft-feedback-") as tmp:
        clock = time.monotonic()
        by_path["feedback_probe"] = {"reduce_sources": probe_checks(
            dev, fb, rs, bk, cm, flat_mesh, nbytes)}
        log(f"phase 26(a): {time.monotonic() - clock:.1f} s")
        clock = time.monotonic()
        by_path["feedback_train"], step_ms = convergence_checks(
            dev, fa, rs, bk, tm, cm, ckpt, flat_mesh, params, cfg, tmp)
        torch.cuda.empty_cache()
        log(f"phase 26(b): {time.monotonic() - clock:.1f} s")
        clock = time.monotonic()
        by_path["feedback_probe_free"], obs_c = probe_free_checks(
            dev, fa, rs, bk, tm, cm, flat_mesh, params, cfg, tmp)
        torch.cuda.empty_cache()
        log(f"phase 26(c): {time.monotonic() - clock:.1f} s")
        clock = time.monotonic()
        recorder_off_checks(dev, fa, rs, tm, flat_mesh, params, cfg, step_ms)
        fleet_checks([os.path.join(tmp, "obs_b"), obs_c])
        log(f"phase 26(d, e): {time.monotonic() - clock:.1f} s")
    return by_path


# phase 27: the coordinated control plane and the chip arbiter
SPIKE_BATCH = 12  # global rows a step: divides by 3 and by 1 (phase 25's)
SPIKE_SLOTS = SLOTS  # a replica's slots (the JAX tool's 2 gave one
# flagship replica ~3 requests/s beside the trainer: too few TTFTs a
# window to breach)
SPIKE_CACHE = dict(num_blocks=41, block_size=16, blocks_per_seq=4)
SPIKE_PHASES = (4.0, 8.0, 8.0)  # baseline, burst, tail (s)
SPIKE_POST_STEPS = 3  # dp-3 steps after the chips came home
# the trainer's pause between steps, outside its timed step: the host
# time a trainer of its own cards would not take from serving (the JAX
# tool's 0.03 s with its small model; a flagship dp-3 step is ~130 ms
# of host launches)
SPIKE_TRAIN_PACE_S = 0.1


class BaselineRecorder:
    """Wraps the paged-attention function the decode step calls: keeps
    clones of the newest layer-0 call of ``engine`` (its layer-0 K pool)
    made while ``armed()``, for a check against the plain stream after the
    run.  Each replica round runs on a thread of its own; the pool, not a
    call count, tells the engine and the layer."""

    def __init__(self, inner, engine, armed):
        self.inner, self.pool0, self.armed = inner, engine.pools["k"][0], armed
        self.saved, self.phase = None, None

    def __call__(self, q, k_new, v_new, k_pool, v_pool, tables, lengths,
                 **kw):
        phase = self.armed() if k_pool is self.pool0 else None
        if phase:
            args = [t.clone() for t in (q, k_new, v_new, k_pool, v_pool,
                                        tables, lengths)]
        out = self.inner(q, k_new, v_new, k_pool, v_pool, tables, lengths,
                         **kw)
        if phase and int(lengths.max()) > 0:
            self.saved, self.phase = (args, out.clone()), phase
        return out


def spike_fold_checks(dev, tm, bk, cm, rs, zero, ar, params, pspecs, topo):
    """Phase 27(a): the fold kernel at the dp-3 ZeRO-1 sync of the
    flagship gradient: the sharded reduce-scatter as the step runs it
    (:func:`check_zero_syncs` over 3 ranks), and the all-gather of the
    packed gradient's shards, each bitwise its host copies."""
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    sizes = {"dp": 3, "sp": 1, "tp": 1}
    topos = tm.resolve_axis_topos(sizes, tm.AXIS_NAMES, topo)
    plan, stages, seen = check_zero_syncs(
        zero, tm, bk, cm, rs, params, pspecs, topos, sizes, dev, flat_mesh,
        n=3)
    log(f"phase 27(a) the dp-3 sharded reduce-scatter as the step runs it "
        f"(topo {topos['dp']}, {len(plan)} buckets of "
        f"{[b.nbytes for b in plan]} B): every rank's blocks and tails "
        f"bitwise the host copies; fold stages {stages}; launches by body: "
        f"{describe_bodies(seen)}")
    count = sum(p.numel() for p in tm.tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    x = torch.randn((3, count), generator=gen, device=dev)
    mesh = flat_mesh(3, dev, "dp")
    shards = ar.reduce_scatter(list(x), mesh, topos["dp"], "sum")
    with fold_bodies(rs, cm, ar) as seen:
        back = ar.all_gather(shards, mesh, topos["dp"], out_shape=(count,))
    hx = x.cpu()
    hmesh = flat_mesh(3, "cpu", "dp")
    hshards = ar.reduce_scatter(list(hx), hmesh, topos["dp"], "sum")
    hback = ar.all_gather(hshards, hmesh, topos["dp"], out_shape=(count,))
    if not all(same_bits(a.cpu(), b) for a, b in zip(shards, hshards)) or \
            not all(same_bits(a.cpu(), b) for a, b in zip(back, hback)):
        raise AssertionError("phase 27(a): the dp-3 reduce-scatter or "
                             "all-gather is not bitwise its host copies")
    log(f"phase 27(a) the dp-3 all-gather of the flagship gradient's shards "
        f"({count} f32 a rank, topo {topos['dp']}): each rank's gathered "
        f"buffer and the shards bitwise the host copies; fold launches "
        f"{sum(seen.values())} (a gather folds nothing)")
    return topos


def spike_flash_checks(dev, fa, worlds):
    """Phase 27(a): the three flash kernels against their plain versions
    in bfloat16 at one rank's layer of each training world the spike ran
    (``(SPIKE_BATCH / n, T, H, D)`` at dp-n), under phase 7's bars."""
    _, t, h, d = FLASH_TRAIN
    gen = torch.Generator().manual_seed(SEED + 270)
    for n in sorted(worlds):
        case = (f"arbiter_dp{n}", SPIKE_BATCH // n, t, t, h, d, True, 0, 0,
                False)
        errs, failures, note, run = flash_compare(fa, case, torch.bfloat16,
                                                  dev, gen)
        if failures:
            raise AssertionError(f"phase 27(a) flash parity "
                                 f"{describe_case(case, 'bf16')}: "
                                 + "; ".join(failures))
        log(f"phase 27(a) flash parity {describe_case(case, 'bf16')} (one "
            f"rank's layer at dp-{n}): {describe_errors(errs)}; {note}")
        del run
        torch.cuda.empty_cache()


def spike_oracle(serving, run, reqs, dev):
    """The pool's greedy tokens against one kernel engine's on the same
    prompts (float32, as phase 21(a)): ``{rid: first diverging token}``
    of the requests that differ."""
    eng = serving.ServingEngine(
        run["sparams"], run["scfg"], run["pcfg"],
        serving.BatcherConfig(slots=SPIKE_SLOTS), fused=True,
        decode_impl="cuda", device=dev)
    for r in reqs:
        if not eng.submit(dataclasses.replace(r, arrival_s=0.0)):
            raise AssertionError(f"phase 27(a): oracle rejected {r.rid}")
    eng.run_until_idle()
    done = run["completed"]
    bad = {r.rid: first_divergence(done[r.rid].tokens,
                                   eng.completed[r.rid].tokens)
           for r in reqs}
    return {rid: i for rid, i in bad.items() if i is not None}


def phase_spike(dev, smi) -> dict:
    """Phase 27(a): the arbiter spike (``tools.arbiter_spike``) at the
    flagship width.  Returns the launches by path."""
    import tempfile

    from flextree_tpu_torch import serving
    from flextree_tpu_torch.models.transformer import param_specs
    from flextree_tpu_torch.obs import flight_recorder
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import paged_attention as pa
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as ar
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import compressed as cm
    from flextree_tpu_torch.parallel import train as tm
    from flextree_tpu_torch.parallel import zero
    from flextree_tpu_torch.serving import kv_cache
    from flextree_tpu_torch.tools import arbiter_spike as sp

    cfg = sp.SpikeConfig(
        device=str(dev), smoke=True, train_model=MODEL,
        train_dtype="bfloat16", train_attn="flash", train_batch=SPIKE_BATCH,
        train_seq=FLASH_TRAIN[1], serve_model=MODEL,
        cache=SPIKE_CACHE, slots=SPIKE_SLOTS, phases=SPIKE_PHASES,
        post_steps=SPIKE_POST_STEPS,
        train_pace_s=SPIKE_TRAIN_PACE_S, deadline_s=150.0, seed=SEED + 27)
    recorder = {}

    def on_start():
        # every count to 0 just before the path runs
        torch.cuda.synchronize()
        zero_flash_counts(fa)
        rs.reduce_sources.launches = 0
        pa.paged_attention.launches = 0

    real_paged = kv_cache.paged_attention
    with tempfile.TemporaryDirectory(prefix="ft-spike-") as wd:
        obs_dir = os.path.join(wd, "obs")
        state = {"pool": None}

        def armed():
            pool = state["pool"]
            if pool is None or len(pool.alive_replicas) != 1:
                return None
            return "after the return" if any(
                r.released for r in pool.replicas) else "before the grant"

        def on_pool(pool, engines):
            state["pool"] = pool
            recorder["rec"] = rec = BaselineRecorder(real_paged, engines[0],
                                                     armed)
            kv_cache.paged_attention = rec

        try:
            with flight_recorder(obs_dir, rank=0):
                doc = sp.run_spike(cfg, wd, on_start=on_start,
                                   on_pool=on_pool,
                                   log=lambda m: log(f"phase 27(a) {m}"))
            torch.cuda.synchronize()
            launches = dict(flash_counts(fa),
                            reduce_sources=rs.reduce_sources.launches,
                            paged_attention=pa.paged_attention.launches)
        finally:
            kv_cache.paged_attention = real_paged
        run = doc.pop("_run")
        sp.check_timeline(doc, obs_dir)
    if doc["violations"]:
        trail = [(d["t"], d["action"], d["p99_ms"], d["samples"])
                 for d in doc["decisions"]]
        raise AssertionError(f"phase 27(a): {doc['violations']}; capacity "
                             f"{doc['capacity']}; the arbiter's readings "
                             f"(s, action, p99 ms, samples): {trail}")
    tr = doc["training"]
    ran = {int(n): k for n, k in tr["steps_by_world"].items()}
    layers = MODEL["n_layers"]
    flash_want = sum(k * n for n, k in ran.items()) * layers
    worlds = run["worlds"]
    # the plan's bucket cap is the leaves' device's: count on the card's
    params = tm.tree_map(lambda t: t.to(dev), worlds.shapes)
    per = {n: dp_fold_launches(
        tm, worlds.model_cfg, dataclasses.replace(
            worlds.base_tc, grad_topo=run["plans"][n]), params, n,
        dev, (SPIKE_BATCH, FLASH_TRAIN[1])) for n in ran}
    fold_want = sum(ran[n] * per[n] for n in ran)
    rounds = [e.decode_steps - d0 for e, d0 in zip(run["engines"],
                                                   run["decode0"])]
    paged_want = sum(rounds) * layers
    if any(launches[k] != flash_want for k in flash_counts(fa)) or \
            launches["reduce_sources"] != fold_want or \
            launches["paged_attention"] != paged_want:
        raise AssertionError(
            f"phase 27(a): launches {launches}; the code gives flash "
            f"{flash_want} (steps by world {ran} x world x {layers} layers),"
            f" folds {fold_want} ({' + '.join(f'{ran[n]} x {per[n]}' for n in sorted(ran))}),"
            f" paged {paged_want} (decode rounds {rounds} x {layers})")
    spike_flash_checks(dev, fa, ran)
    bad = spike_oracle(serving, run, run["requests"], dev)
    if bad:
        raise AssertionError(f"phase 27(a): the pool's f32 tokens differ "
                             f"from one kernel engine's (rid: first token): "
                             f"{bad}")
    rec = recorder.get("rec")
    if rec is None or rec.saved is None:
        raise AssertionError("phase 27(a): no single-replica round recorded")
    args, got = rec.saved
    plain = pa.paged_attention(*args, impl="torch")
    err = (got.float() - plain.float()).abs().max().item()
    if not err <= pa.FUSED_DECODE_ATOL:
        raise AssertionError(f"phase 27(a): the recorded round, kernel vs "
                             f"plain stream {err}")
    epochs = tr["lease_epochs"]
    arb = doc["arbiter"]
    p99 = doc["serving"]["p99_ms"]

    def ms(v):
        return "none" if v is None else f"{v:.1f} ms"

    log(f"phase 27(a) arbiter spike (training: flagship bf16 flash ZeRO-1 "
        f"on the in-process dp-3 mesh, global batch {SPIKE_BATCH} x "
        f"{FLASH_TRAIN[1]}; serving: a pool of flagship f32 kernel engines, "
        f"a baseline and 2 warmed burst engines, {SPIKE_SLOTS} slots; chips "
        f"are logical slots of one card; {smi}): capacity "
        f"{doc['capacity']['rps']:.2f} requests/s -> rates "
        f"{doc['phases']['base_rate_rps']:.2f} / "
        f"{doc['phases']['spike_rate_rps']:.2f} requests/s over "
        f"{SPIKE_PHASES} s, SLO {arb['slo_p99_ms']:.1f} ms, window "
        f"{sp.WINDOW_S} s, the trainer paced {SPIKE_TRAIN_PACE_S} s a "
        f"step; arbiter events {doc['timeline']['arbiter_order']}"
        f" ({doc['timeline']['arbiter_lane']} on the arbiter lane of a valid "
        f"merged timeline of {doc['timeline']['events']} events); lease "
        f"epochs " + " -> ".join(
            f"{len(e['chips'])} at step {e['step']} (topo {e['topo']}, "
            f"bitwise {e['bitwise_resume']})" for e in epochs)
        + f"; {doc['serving']['completed']}/{doc['serving']['submitted']} "
        f"requests completed exactly once, f32 tokens == one kernel "
        f"engine's; launches {launches} = the code's (steps by world "
        f"{ran}; fold a step {per}; decode rounds {rounds}); the baseline's "
        f"round {rec.phase} (layer 0, {int((args[6] > 0).sum())} active "
        f"slots): kernel vs plain stream {err:.3g} (bar "
        f"{pa.FUSED_DECODE_ATOL}); {doc['run_s']:.1f} s")
    log(f"phase 27(a) printed, not gated: windowed p99 before "
        f"{ms(p99['before'])}, during {ms(p99['during'])}, after "
        f"{ms(p99['after'])}; breach -> grant "
        f"{arb['breach_to_grant_s'] or float('nan'):.3f} s; each resize's "
        f"wall {[round(s, 3) for s in tr['resize_s']]} s; step at dp-3 before "
        f"{ms(tr['pre_spike_step_ms'])} and after "
        f"{ms(tr['post_reclaim_step_ms'])}; recovery "
        f"{doc['recovery']['recovery_windows']} windows past max(grant, "
        f"burst end)")
    topos = spike_fold_checks(dev, tm, bk, cm, rs, zero, ar, params,
                              param_specs(worlds.model_cfg), run["plans"][3])
    del run, topos, params
    torch.cuda.empty_cache()
    return {"arbiter_train": {k: launches[k] for k in (
                *flash_counts(fa), "reduce_sources")},
            "arbiter_serve": {"paged_attention":
                              launches["paged_attention"]}}


def phase_coord(dev, smi) -> dict:
    """Phase 27(b): ``tools.coord_chaos``'s smoke set: the matrix world
    on the host toy step, the gloo world at the flagship gradient's
    length on the card.  Returns the launches by path."""
    from flextree_tpu_torch.tools import coord_chaos as cc

    results = cc.run_matrix(cc.SMOKE, str(dev), cc.GLOO_COUNT,
                            log=lambda m: log(f"phase 27(b) {m}"))
    bad = [r["scenario"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 27(b): scenarios failed: {bad}: "
                             + json.dumps([r for r in results
                                           if not r["ok"]])[:3000])
    gloo = next(r for r in results if r["scenario"] == "gloo_group_replan")
    per_rank = gloo["checks"]["fold_launches"]
    want = cc.gloo_fold_launches(cc.WORLD, str(cc.WORLD), cc.GLOO_COUNT, 1)
    log(f"phase 27(b) coord_chaos --smoke ({smi}): "
        + "; ".join(f"{r['scenario']} ok ({r['seconds']:.1f} s)"
                    for r in results)
        + f"; the gloo world ({cc.WORLD} processes, {cc.GLOO_COUNT} f32 a "
        f"rank on {dev}, {cc.GLOO_STEPS} steps, the replan applied at step "
        f"{gloo['checks']['applied'][0][0]['step']} on every rank): each "
        f"rank's output bitwise the unfaulted twin's and its host copies at "
        f"steps {cc.GLOO_HOST_CHECKS}; fold launches a rank {per_rank} = the "
        f"code's ({want} a step unchunked, chunked after the flip)")
    return {"coord_gloo": {"reduce_sources": sum(per_rank)}}


def phase_control(dev, smi) -> dict:
    """Phase 27: (a) the arbiter spike, (b) the coordination chaos."""
    t0 = time.monotonic()
    out = phase_spike(dev, smi)
    log(f"phase 27(a): {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    out.update(phase_coord(dev, smi))
    log(f"phase 27(b): {time.monotonic() - t0:.1f} s")
    return out


def collective_phases(dev, bw) -> list:
    """Phases 11-15 (the FlexTree collectives); returns their rows of the
    kernels line (``reduce_sources`` and ``reduce_stacked``, the fold
    kernel's two entry points, and ``copy``)."""
    from flextree_tpu_torch.backends import simulator as sim
    from flextree_tpu_torch.bench import harness
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import reduce as registry
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as allreduce_mod
    from flextree_tpu_torch.parallel import launch
    from flextree_tpu_torch.parallel.mesh import (
        allreduce_over_mesh,
        flat_mesh,
    )
    from flextree_tpu_torch.parallel.train import tree_leaves
    from flextree_tpu_torch.schedule import stages

    params = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device=dev)
    param_count = sum(p.numel() for p in tree_leaves(params))
    del params
    log(f"flagship parameter count (the gradient a train step syncs): "
        f"{param_count}")
    out = {}
    for phase, run in (
        (11, lambda: phase_fold_parity(dev, rs, registry, harness)),
        (12, lambda: (phase_fold_times(dev, harness, param_count),
                      stage_times(dev, harness, rs, allreduce_mod,
                                  param_count, bw))),
        (13, lambda: phase_allreduce(dev, harness, stages, allreduce_mod,
                                     registry, sim, allreduce_over_mesh,
                                     flat_mesh, rs, param_count)),
        (14, lambda: phase_dist(dev, harness, launch, allreduce_mod,
                                flat_mesh)),
        (15, lambda: phase_ir_families(
            dev, harness, allreduce_mod, rs, flat_mesh, allreduce_over_mesh,
            param_count, {(spec, r["ranks"]): r["median_ms"]
                          for spec, r in out[13][2].items()})),
    ):
        t0 = time.monotonic()
        out[phase] = run()
        log(f"phase {phase}: {time.monotonic() - t0:.1f} s")
        torch.cuda.empty_cache()
    parity, ((times, copy_launches, stacked_launches), stage_rows), \
        (launches, top, _), (ir_launches, _) = out[11], out[12], out[13], \
        out[15]
    row = next(r for r in times if (r["W"], r["L"]) == top and r["op"] == "sum")
    stage = next(r for r in stage_rows if r["shape"] == "1")
    return [{
        "name": "reduce_sources",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/reduce_stacked.cu",
        "replaces": "flextree_tpu/ops/pallas_reduce.py:33",
        "launches": launches + ir_launches,
        "launches_by_path": {"allreduce": launches,
                             "ir_families": ir_launches},
        "max_abs_err": parity["max_abs_err"],
        "ms": stage["ms"],
        "plain_ms": stage["plain_ms"],
        "bound_ms": stage["bound_ms"],
        "bound_by": "bytes",
        "library_ms": stage["library_ms"],
    }, {
        "name": "reduce_stacked",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/reduce_stacked.cu",
        "replaces": "flextree_tpu/ops/pallas_reduce.py:33",
        "launches": stacked_launches,
        "launches_by_path": {"reduce_bench": stacked_launches},
        "max_abs_err": parity["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": row["library_ms"],
    }, {
        "name": "copy",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/copy.cu",
        "replaces": "tools/roofline_reduce.py:101",
        "launches": copy_launches,
        "launches_by_path": {"reduce_bench": copy_launches},
        "max_abs_err": 0.0,
        "ms": row["copy_ms"],
        "plain_ms": row["copy_plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": row["copy_library_ms"],
    }]


def model_phases(dev, bw, fp32_peak, bf16_peak) -> list:
    """Phases 2-10 (serving and training); returns their rows of the
    kernels line."""
    from flextree_tpu_torch import data as data_mod
    from flextree_tpu_torch import models, serving, trainer
    from flextree_tpu_torch.models.generate import generate
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.ops import paged_attention as pa
    from flextree_tpu_torch.parallel import train as train_mod
    from flextree_tpu_torch.utils import checkpoint as ckpt

    clock = [time.monotonic()]

    def lap(phase):
        now = time.monotonic()
        log(f"phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    # ---- phase 2: kernel parity at the flagship decode shape
    phase_parity(dev, pa)

    lap(2)

    # ---- phase 3: serving at flagship width, bf16, through the kernel
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    pcfg = serving.PagedCacheConfig(**CACHE)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
    reqs = make_requests(serving.Request)
    rounds: list = []
    eng = run_engine(serving, params, cfg, pcfg, True, dev, rounds)
    makespan, launches = drive(eng, reqs, pa)
    done = eng.completed
    if len(done) != N_REQUESTS or any(
        d.n_tokens != MAX_NEW for d in done.values()
    ):
        raise AssertionError(f"{len(done)}/{N_REQUESTS} requests completed")
    for d in done.values():
        if not ((d.tokens >= 0) & (d.tokens < MODEL["vocab_size"])).all():
            raise AssertionError(f"request {d.rid}: token out of range")
    want = eng.decode_steps * MODEL["n_layers"]
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != decode rounds "
                             f"{eng.decode_steps} x layers")
    tokens = sum(d.n_tokens for d in done.values())
    ttft = np.array([d.ttft_s for d in done.values()]) * 1e3
    per_tok = np.array([d.per_token_s for d in done.values()]) * 1e3
    serve = {
        "requests": N_REQUESTS, "completed": len(done), "tokens": tokens,
        "decode_rounds": eng.decode_steps, "kernel_launches": launches,
        "makespan_s": makespan, "tok_per_s": tokens / makespan,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "per_token_ms_mean": float(per_tok.mean()),
        "round_ms_p50": eng.report()["histograms"]["serve.round_ms"]["p50"],
    }
    log(f"phase 3 serving: {len(done)}/{N_REQUESTS} completed, {tokens} "
        f"tokens in {makespan:.3f} s = {serve['tok_per_s']:.1f} tok/s; TTFT "
        f"p50 {serve['ttft_ms_p50']:.2f} ms p99 {serve['ttft_ms_p99']:.2f} "
        f"ms; per-token {serve['per_token_ms_mean']:.3f} ms; kernel launches "
        f"{launches} = {eng.decode_steps} rounds x {MODEL['n_layers']} layers")

    lap(3)

    # ---- phase 4: times, on phase 3's inputs
    times = phase_times(dev, pa, eng.pools, rounds, bw, fp32_peak)
    log(f"phase 4 times (lengths {times['lengths']}): kernel "
        f"{times['ms']:.4f} ms ({times['ms'] / times['library_ms']:.2f}x "
        f"SDPA), plain {times['plain_ms']:.4f} ms, SDPA "
        f"{times['library_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms "
        f"({times['bound_by']})")

    lap(4)

    # ---- phase 5: where a serving run's time goes
    phase_profile(eng, reqs[:8])
    del eng

    lap(5)

    # ---- phase 6: float32 greedy token identity
    cfg32 = TransformerConfig(**MODEL, dtype=torch.float32)
    tokens32 = {}
    for fused in (True, False):
        e = run_engine(serving, params, cfg32, pcfg, fused, dev)
        drive(e, reqs, pa)
        tokens32[fused] = {rid: d.tokens for rid, d in e.completed.items()}
        del e
    same = all(np.array_equal(tokens32[True][r.rid], tokens32[False][r.rid])
               for r in reqs)
    if not same:
        raise AssertionError("f32 kernel engine and gather engine disagree")
    for r in reqs[:4]:
        ref = generate(
            params, torch.as_tensor(r.prompt, dtype=torch.long,
                                    device=dev)[None],
            cfg32, max_new_tokens=MAX_NEW, max_len=pcfg.max_len,
        )[0].cpu().numpy()
        if not np.array_equal(ref, tokens32[True][r.rid]):
            raise AssertionError(f"request {r.rid}: engine != generate")
    log(f"phase 6 f32: kernel engine == gather engine on all {N_REQUESTS} "
        f"requests; == generate on 4")
    del params

    lap(6)

    # ---- phase 7: each flash kernel against its plain version
    worst = phase_flash_parity(dev, fa, pa)

    lap(7)

    # ---- phase 8: the flagship train run through trainer.main
    train = phase_train(dev, fa, trainer, ckpt, train_mod)

    lap(8)

    # ---- phase 9: float32 flash vs reference train steps
    phase_f32_train(dev, models, train_mod, data_mod)

    lap(9)

    # ---- phase 10: flash kernel times at the training shape
    ftimes = phase_flash_times(dev, fa, bw, bf16_peak)
    lap(10)

    return [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "flextree_tpu_torch/csrc/paged_attention.cu",
        "replaces": "flextree_tpu/ops/paged_attention.py:183",
        "launches": launches,
        "launches_by_path": {"serve": launches},
        "max_abs_err": times["max_abs_err"],
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"flextree_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": train["launches"][name],
        "launches_by_path": {"train": train["launches"][name]},
        "max_abs_err": worst[name],
        "ms": ftimes[name]["ms"],
        "plain_ms": ftimes[name]["plain_ms"],
        "bound_ms": ftimes[name]["bound_ms"],
        "bound_by": ftimes[name]["bound_by"],
        "library_ms": ftimes[name]["library_ms"],
    } for name, replaces in FLASH_REPLACES]


# the flash kernels whose bf16 path runs on the tensor cores
MMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def ptxas_report(kernels, name, dm):
    """ptxas' registers and spills of kernel ``name``'s tensor-core
    instantiation at head dim ``dm``, from this run's build, or None when
    the library came from an earlier build."""
    if name not in kernels.build_log:
        return None
    lines = kernels.build_log[name]["ptxas"].splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry function" in ln and f"mma_kernelILi{dm}E" in ln]
    if len(at) != 1:
        raise AssertionError(f"{name}: no DM={dm} tensor-core kernel in the "
                             f"ptxas report")
    return [ln.split(":", 1)[-1].strip()
            for ln in lines[at[0] + 1:at[0] + 4]
            if "spill" in ln or "registers" in ln]


def check_tensor_cores(kernels, paths):
    """The bf16 flash kernels (forward, dq, dk/dv) run their products on
    the tensor cores: ``HMMA`` (``mma.sync``) in their SASS
    (``cuobjdump``), and ptxas reports no register spills for their DM=64
    instantiation, the training shape's; DM=128's registers and spills are
    reported (a little spill is allowed there)."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    for name in MMA_KERNELS:
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hmma = sass.count("HMMA")
        if not hmma:
            raise AssertionError(f"{name}: no HMMA in its SASS")
        report = {dm: ptxas_report(kernels, name, dm) for dm in (64, 128)}
        if report[64] is None:
            note = "cached build, no ptxas report in this run"
        else:
            if not any("0 bytes spill stores, 0 bytes spill loads" in ln
                       for ln in report[64]):
                raise AssertionError(f"{name}: DM=64 spills registers "
                                     f"({'; '.join(report[64])})")
            note = "; ".join(f"DM={dm}: " + "; ".join(r)
                             for dm, r in report.items())
        log(f"phase 1 tensor cores {name}: {hmma} HMMA in the SASS; "
            f"bf16 {note}")


def train_ab(parent: str) -> int:
    """Phase 8's train run (:func:`phase_train`) of the checkout at
    ``parent`` and of this one in turns (parent, this, this, parent), each
    in a process of its own that imports its own checkout's package and
    builds its kernels: the steady step ms and the device time a step
    (``torch.profiler`` over three steps) of each run."""
    code = (
        "import json, sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke as cs\n"
        "from flextree_tpu_torch import trainer\n"
        "from flextree_tpu_torch.ops import flash_attention as fa\n"
        "from flextree_tpu_torch.parallel import train as train_mod\n"
        "from flextree_tpu_torch.utils import checkpoint as ckpt\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "s = cs.phase_train(torch.device('cuda', 0), fa, trainer, ckpt, "
        "train_mod)\n"
        "busy = s['profile']['device_busy_s']\n"
        "print('train_ab ' + json.dumps({'steady_step_ms': "
        "s['steady_step_ms_median'], 'device_ms_per_step': None if busy is "
        "None else busy * 1e3 / 3, 'top': s['profile']['top'][:6]}))\n"
    )
    runs = []
    for tag, where in (("parent", parent), ("this", HERE), ("this", HERE),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", code], cwd=where,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"train run of {tag} ({where}) exited "
                                 f"{proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("train_ab ")][-1]
        res = json.loads(line[len("train_ab "):])
        runs.append((tag, res))
        dev_ms = res["device_ms_per_step"]
        log(f"phase 8 A/B {tag} ({where}): steady step "
            f"{res['steady_step_ms']:.3f} ms; device "
            + ("time not measured" if dev_ms is None else
               f"{dev_ms:.3f} ms a step (torch.profiler, 3 steps)")
            + "; top: " + ", ".join(
                f"{r['name'][:40]} {r['device_ms'] / 3:.3f}"
                for r in res["top"]))
    print(json.dumps({"train_ab": runs}))
    return 0


# one checkout's allreduce run for --allreduce-ab: phase 13's f32-sum bench
# (the bench's in-place timed path) and three in-place calls under
# torch.profiler, per shape; the same code measures both checkouts
ALLREDUCE_AB_CODE = """
import json, sys, time, torch
sys.path.insert(0, '.')
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
from flextree_tpu_torch.bench import harness
from flextree_tpu_torch.parallel.mesh import allreduce_over_mesh, flat_mesh
count, shapes = json.loads(sys.argv[1])
dev = torch.device('cuda', 0)
out = {}
for spec, n in shapes:
    report = harness.run_allreduce_bench(harness.BenchConfig(
        size=count, repeat=20, topo=spec, devices=n, dtype='float32',
        op='sum', device=str(dev)))
    assert report.correct, spec
    x = torch.randn((n, count), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    mesh = flat_mesh(n, dev)
    # the tracer misses the first launches after it starts: one call in
    # its warm-up step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        allreduce_over_mesh(x, mesh, spec, 'sum', in_place=True)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        for _ in range(3):
            allreduce_over_mesh(x, mesh, spec, 'sum', in_place=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.step()
    busy = launches = 0
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        if e.device_type == DeviceType.CUDA and us > 0 and \
                not e.key.startswith('ProfilerStep'):
            busy += us / 1e6
            launches += e.count
    out[spec] = {'median_ms': report.result.median_s * 1e3,
                 'min_ms': report.result.min_s * 1e3,
                 'launches_per_call': launches / 3,
                 'device_ms_per_call': busy * 1e3 / 3,
                 'busy_share': busy / wall}
print('allreduce_ab ' + json.dumps(out))
"""


def allreduce_ab(parent: str) -> int:
    """Phase 13's five f32-sum shapes at the flagship's parameter count, for
    the checkout at ``parent`` and this one in turns (parent, this, this,
    parent), each in a process of its own that imports its own checkout's
    package and builds its kernels: per shape the bench's median ms a call
    and, over three more calls under ``torch.profiler``, the device's
    launches a call and its busy share of the wall."""
    sys.path.insert(0, HERE)
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.parallel.train import tree_leaves

    params = init_params(TransformerConfig(**MODEL),
                         torch.Generator().manual_seed(SEED), device="cpu")
    count = sum(p.numel() for p in tree_leaves(params))
    arg = json.dumps([count, COLLECTIVE_SHAPES])
    runs = []
    for tag, where in (("parent", parent), ("this", HERE), ("this", HERE),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", ALLREDUCE_AB_CODE, arg],
                              cwd=where, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"allreduce run of {tag} ({where}) exited "
                                 f"{proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("allreduce_ab ")][-1]
        res = json.loads(line[len("allreduce_ab "):])
        runs.append((tag, res))
        for spec, r in res.items():
            log(f"phase 13 A/B {tag} {spec}: median {r['median_ms']:.3f} ms "
                f"(min {r['min_ms']:.3f}), {r['launches_per_call']:g} "
                f"launches a call, device {r['device_ms_per_call']:.3f} ms a "
                f"call, busy {100 * r['busy_share']:.1f}% of the wall")
    print(json.dumps({"allreduce_ab": runs}))
    return 0


def one_phase(argv) -> int:
    """``--phase 26`` or ``--phase 27``: phase 1's build, then that phase
    alone; prints its launches by path and no result line."""
    phases = {"26": phase_feedback, "27": phase_control}
    if len(argv) != 1 or argv[0] not in phases:
        print(f"usage: chip_smoke.py --phase {{{','.join(phases)}}}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from flextree_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{smi}")
    t0 = time.monotonic()
    kernels.build()
    log(f"phase 1 build total: {time.monotonic() - t0:.2f} s")
    t0 = time.monotonic()
    launches = phases[argv[0]](torch.device("cuda", 0), smi)
    log(f"phase {argv[0]}: {time.monotonic() - t0:.1f} s")
    print(json.dumps({"launches_by_path": launches}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    ab = {"--train-ab": train_ab, "--allreduce-ab": allreduce_ab}
    if sys.argv[1:2] == ["--phase"]:
        return one_phase(sys.argv[2:])
    if sys.argv[1:2] and sys.argv[1] in ab:
        if len(sys.argv) != 3:
            print("usage: chip_smoke.py [--train-ab | --allreduce-ab "
                  "PARENT_CHECKOUT]", file=sys.stderr)
            return 2
        print(smi_line())
        return ab[sys.argv[1]](os.path.abspath(sys.argv[2]))
    sys.path.insert(0, HERE)
    from flextree_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.monotonic()

    # ---- phase 1: device and build
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    bw, fp32_peak, bf16_peak = card_peaks(kind)
    log(f"phase 1 device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.monotonic()
    paths = kernels.build()
    build_s = time.monotonic() - t0
    for name, info in kernels.build_log.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        log(f"phase 1 build {name}: {info['seconds']:.2f} s; "
            f"{' | '.join(regs[:4])}{' | ...' if len(regs) > 4 else ''}")
    log(f"phase 1 build total: {build_s:.2f} s")
    check_tensor_cores(kernels, paths)

    t0 = time.monotonic()
    rows = model_phases(dev, bw, fp32_peak, bf16_peak)
    log(f"phases 2-10: {time.monotonic() - t0:.1f} s")
    rows += collective_phases(dev, bw)
    from flextree_tpu_torch import trainer
    from flextree_tpu_torch.ops import flash_attention as fa
    from flextree_tpu_torch.utils import checkpoint as ckpt

    t0 = time.monotonic()
    dp_launches, dp_peak = phase_dp(dev, fa, trainer, ckpt)
    log(f"phase 16: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    codec_launches, dp_codec_launches = phase_codec(dev, fa, trainer, ckpt)
    log(f"phase 17: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ovl_launches = phase_overlap(dev, fa, trainer, ckpt, smi)
    log(f"phase 18: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    zero_launches = phase_zero(dev, fa, trainer, ckpt, smi, dp_peak, bw)
    log(f"phase 19: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    disagg_launches = phase_disagg(dev, smi)
    log(f"phase 20: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    pool_launches = phase_pool(dev, smi)
    log(f"phase 21: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sp_launches = phase_sp_tp(dev, smi)
    log(f"phase 22: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sp_launches.update(phase_pp_moe(dev, smi))
    log(f"phase 23: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    wide_launches, _ = phase_wide(dev, smi, bw)
    sp_launches.update(wide_launches)
    log(f"phase 24: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sp_launches.update(phase_supervised(dev, smi))
    log(f"phase 25: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sp_launches.update(phase_feedback(dev, smi))
    log(f"phase 26: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sp_launches.update(phase_control(dev, smi))
    log(f"phase 27: {time.monotonic() - t0:.1f} s")
    log(f"phases 1-27: {time.monotonic() - t_all:.1f} s")
    # each path's launches beside their sum
    for row in rows:
        if row["name"] in dp_launches:
            row["launches_by_path"]["dp_train"] = dp_launches[row["name"]]
        if row["name"] in ovl_launches:
            row["launches_by_path"]["dp_overlap"] = ovl_launches[row["name"]]
        if row["name"] in zero_launches:
            row["launches_by_path"]["dp_zero"] = zero_launches[row["name"]]
        if row["name"] in dp_codec_launches:
            row["launches_by_path"]["dp_codec"] = \
                dp_codec_launches[row["name"]]
        if row["name"] == "reduce_sources":
            row["launches_by_path"].update(codec_launches)
        for path, counts in sp_launches.items():
            if row["name"] in counts:
                row["launches_by_path"][path] = counts[row["name"]]
        if row["name"] == "paged_attention":
            row["launches_by_path"]["disagg"] = disagg_launches
            row["launches_by_path"]["pool"] = pool_launches
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

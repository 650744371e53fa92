#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's kernels from the sources
in ``src/repro_torch/kernels/csrc`` and drives the port's main paths at
``weathermixer-1b``'s, ``mamba2-130m``'s, ``h2o-danube-1.8b``'s,
``gemma3-27b``'s, ``phi3.5-moe-42b-a6.6b``'s,
``jamba-1.5-large-398b``'s and ``whisper-small``'s full published widths
(gemma3 and phi3.5 cut in depth, jamba to one period and half its
experts), through the entry points a user calls: the Mamba-2 forward and
greedy generation, the dense transformer's forward and generation (fused
prefill, graphed decode on rolling and local:global KV caches), the MoE
transformer's and the hybrid's forward and generation, whisper's
encoder-decoder forward and generation, language-model training
(``TrainEngine`` on token batches: mamba2-130m, h2o-danube-1.8b and
whisper-small whole, phi3.5-moe cut in depth, jamba reduced; h2o whole
on a 1-D Jigsaw model mesh of two ranks sharing the card, and
mamba2-130m, phi3.5-moe, whisper-small and jamba there too),
forecast serving, one-GPU training (and its preemption, supervised
relaunch and resume), the 2-D Jigsaw (Cannon) training step
at q = 1 and on a 2x2 mesh of four ranks sharing the card, the 1-D
Jigsaw (ring) training step on two ranks sharing the card, and both
schemes' model groups replicated over a data axis of two (ZeRO-1, the
1-D FSDP hybrid).  Phases, each printed as a JSON line:

  1. the card (``nvidia-smi``) and the kernel builds (block_matmul.cu,
     wx.cu, ring.cu, cannon.cu, ssd_chunk.cu and ssd_chunk_bwd.cu, one
     nvcc each, started together);
  2. the block_matmul kernel against its plain PyTorch version on the card:
     small ragged shapes in f32 and bf16 with every epilogue, then the six
     GEMM shapes of a weathermixer-1b forecast step (bucket 1) in bf16 and
     tok_fc1 in f32, and the five GEMM shapes of a mamba2-130m forward
     (8,192 rows) and of its decode step (4 rows) in bf16, each timed
     beside the plain version, one PyTorch library call computing the same
     function (never used by the port) and the card's bound; each row with
     its route (the Hopper loop, or the WMMA loop where M or N is under
     64), load paths, registers, spills, shared bytes, tiles, waves and
     the per-call padding's time, and every Hopper-loop result held bit for
     bit against the WMMA loop's on the same operands (timed too);
  2b. the ssd_chunk kernel (``ssd_shape``) against its plain version: small
     ragged chunks in f32 and bf16 (the TMA route), an odd width (Q = 37,
     N = 5, P = 3: the element-load route) and a chunk whose decay
     overflows exp above the diagonal (the output must be finite), then
     the [G, Q, N] entry at mamba2-130m's groups at sequence 2048 (batch 1)
     and 4096 (batch 2) in f32, and the heads entry at one layer's own
     layout (sequence 4096, batch 2: bit for bit the [G, Q, N] entry on the
     groups arrangement of repeats and copies) and at jamba's SSM slot
     (sequence 2048, batch 1, 256 heads in 8 groups, state 128; the same
     checks), each timed beside
     the plain version, the closest library composition (bmm, where, *
     dt, bmm; at the model's layout after the same copies), the bound and,
     for the model row, the groups arrangement; each row with its route,
     registers, spills, shared bytes, stages and blocks per SM;
  2b'. the SSD term's backward kernel ssd_chunk_bwd (``ssd_bwd_shape``)
     against its plain version (``ref.ssd_intra_heads_bwd_ref``) in f32
     and in float64: ragged chunks (Q = 37 at N = 5, P = 3, and Q = 64)
     with one and two groups, a chunk whose decay overflows exp above the
     diagonal, mamba2-130m's layer and jamba's SSM slot as in 2b; every
     gradient finite and two launches bit for bit; each row timed beside
     the plain version, the closest library composition (autograd's
     backward of the groups copies, bmm, where, * dt, bmm with the
     exponent masked) and the bytes bound, with registers, spills, shared
     bytes, blocks per SM and waves;
  2c. ``mamba_forward``: the full-width mamba2-130m forward (24 layers,
     random bf16 weights from seed 0) at sequence 4096 and batch 2 on
     ``TokenDataset`` rows, 24 ssd launches (all on the heads entry's
     TMA route) and 97 block_matmul launches, logits finite, its time,
     tokens/s and the 24 ssd launches' time inside a forward; then, on the
     same weights in f32, the
     forward against the same with the plain SSD term and with
     ``kernel="xla"``, and the bf16 logits against the f32 ones;
  2d. ``mamba_generate``: ``serve.step.generate`` at batch 4 (64-token
     prompts, 32 new tokens; token-wise prefill, then decode steps) through
     the captured decode step (``graph_serve_step``, captured before the
     counted run), then eagerly (``graph=False``): the tokens equal, no ssd
     launch and 97 block_matmul launches per step in both (the graphed
     ones counted by replay), tokens in range, the token-wise logits at
     every prompt position against the teacher-forced forward (judged in
     f32, printed in bf16), a decode step's device (CUDA events) and host
     time, graphed and eager;
  2e. ``mamba_train``: ``TrainEngine("mamba2-130m", reduced=False)`` whole
     under the config's own dtypes (bf16 weights) with remat, batch 2 x
     4,096 ``TokenBatchSource`` tokens, three steps: step 0 in f32 (the
     weights up-cast) against the same step with the plain SSD term
     (plain forward and backward) and with ``kernel="xla"``: loss, grad
     norm and every leaf's gradient, beside the control the bounds must
     refuse (the tied embedding zeroed); then the run, 48 ssd, 24
     ssd_chunk_bwd and 387 block_matmul launches a step (by layout:
     forward and recompute 193, dx 97, dw 97), losses finite, the weights
     moved, ``mfu``, ms a step and tokens/s with ``data_wait`` apart, the
     peak memory; one more step's parts by CUDA events (the SSD forward
     and backward launches, the chunked scans' forwards) and one under
     ``torch.profiler`` (device-busy ms, kernels launched, the top
     kernels);
  2f. ``hybrid_train``: ``jamba-1.5-large-398b`` reduced (d_model 256,
     one period of an SSM slot and an attention slot with 4 experts, f32,
     remat: the published period's weights do not fit one card in
     training), one step at batch 2 x 512 on the card: 2 ssd, 1
     ssd_chunk_bwd and 51 block_matmul launches, its gradients against
     the port's CPU step on the same weights and batch, and its loss and
     grad norm against the CPU ``TrainEngine``'s;
  3. full-width serving under the bf16 policy: the engine's per-bucket CUDA
     graphs (buckets 1, 2, 4, captured by ``warmup()``, 14 launches each),
     then an eager engine (``graphs=False``) on the same weights, each
     serving the same seven requests admitted before and during a rollout:
     0 setups or captures after warmup, 14 kernel launches per device step
     (counted by replay), outputs finite and the two runs' bit for bit, one
     lead-1 forecast against the plain forecast step, every request
     bitwise equal to its solo bucket-1 rollout; a step's device and host
     ms per mode and bucket, ms per request-step, the graphs' pool and the
     peak memory;
  3b. ``serve_data`` (run after ``train_2d_mesh``'s save, see 9):
     ``ForecastEngine(mesh_data=2)``, this file re-run as two rank
     processes sharing the card (``--serve-data-rank``), each rebuilding
     the serve phase's weights from seed 0: rank 0's outputs of the same
     seven requests (bucket 1 whole on both ranks, 2 and 4 split) bit for
     bit the serve phase's, 14 launches a step on each rank, 0 setups
     after warmup; then both ranks restore the 2x2 mesh's checkpoint, its
     lead-1 forecast bit for bit the one-device restore's; printed: ms per
     step, the bytes through host memory per admit and per peel, the
     restore seconds per rank;
  4. the legacy path (the config's own dtypes: bf16 weights, f32
     activations, f32 kernel; ``launch/serve.py`` without ``--precision``)
     for one step against the plain version; then its device time per
     step beside the plain step's, its 14 f32 kernel launches alone and
     the same 14 products by torch.matmul (f32, TF32 off) at its shapes,
     and the f32 bound of its GEMMs;
  5. the backward GEMMs of the six shapes (bucket 1): dx = dz @ w and
     dw = dz.T @ x through the kernel's transposed-operand variants,
     against the plain version, each timed beside the plain version, the
     library's product and the bound, with the rows of phase 2; dw of
     tok_fc1 in f32 too;
  6. the wx kernel (the transposed-Cannon step of the 2-D token mix) at
     the full-width token-mix shapes of q = 1 and of a 2x2 rank, batch 1
     and 2: the forward in bf16 with a non-zero f32 accumulator, and dx
     from the bf16 w (read across its rows) and an f32 dy, once bf16-exact
     (one split term, the 2-D path's) and once not (three terms), each
     against its plain version, dx also against a float64 oracle and the
     term count the card recorded, timed beside the plain version, the
     closest PyTorch library call, the bound and, for dx, the f32 FMA
     kernel that took it before and the split pass;
  7. the ring step kernels (``ring_shape``) at the six full-width 1-D
     linear shapes for p = 2 and 4 ranks held in one process (rank r
     writes rank r+1's slot; the order of the launches is the barrier), in
     bf16, and tok_fc1 in f32: the forward against the ring of
     block_matmul's products and its plain version, the backward's dw
     against block_matmul's dw of the gathered cotangent and its dx
     accumulator against the plain one and, in bf16, bit for bit against
     the wx step loop; rank 0's launches timed (with the per-call padding
     of the operands TMA cannot take, also timed alone; the backward also
     with dx off) beside the plain steps, cuBLAS chunk products with the
     adds, and the bound, each row with every operand's load path (the
     bf16 TMA plans of both steps), the kernels' registers, local and
     shared bytes, and both steps' tiles and waves;
  8. the Cannon kernel (``cannon_shape``) at the two full-width token-mix
     shapes of a 2x2 rank, batch 1 and 2 in bf16, and tok_fc1 in f32, the
     four ranks held in one process (rank (i, j) writes the slots of
     (i, j-1) and (i-1, j); the order of the launches is the barrier):
     every rank bit for bit the step loop (one wx launch per step) and
     within the wx tolerance of the plain Cannon; rank 0's q launches timed
     beside the plain steps, torch.baddbmm per step and the bound, each
     row with the operands' load paths, the kernel's registers, local and
     shared bytes, tiles and waves; then q = 3 at a small size;
  9. full-width training (``TrainEngine``, bf16 policy, batch 2, two
     steps at rollouts 1 and 2): the first step's loss, grad norm and per-leaf gradients
     against the same step with ``kernel="xla"``; on the same weights and
     batch, one 2-D (``scheme="2d"``, the 1x1 mesh) forward and backward,
     with its 18 r wx and 5 + 30 r block_matmul launches, every dx launch
     at one split term, held against the ``scheme="none"`` step
     (``train_2d``); one 1-D (``scheme="1d"``,
     ``impl="ring_fused"``) forward and backward on two ranks, this file
     re-run as two processes (``--train-1d-rank``) that share the card
     under gloo and reach each other's ring slots through CUDA IPC, with
     (2 + 24 r) p ring_fwd and (2 + 12 r) p ring_bwd launches per rank and
     no block_matmul, held against the same none step and, bit for bit in
     its loss, against ``impl="ring_chunked"`` (``train_1d``); one 2-D
     forward and backward on a 2x2 mesh, this file re-run as four
     processes (``--train-2d-rank``) sharing the card under gloo, each
     reading only its block of the batch (``pipeline="sharded"``, 1/4 of
     the bytes, bit for bit ``field_block`` of the whole batch) and
     reaching its predecessors' Cannon slots through CUDA IPC, with 24 r
     cannon, 12 r + 12 r wx (every dx at one split term) and 10 + 60 r
     block_matmul launches per rank, held against the none step and, bit for bit in loss and grad norm,
     against the step with ``fused_cannon_t`` forced to the step loop
     (``train_2d_mesh``), after which the four ranks save a checkpoint
     (``eng.save(..., block=True)``: each rank's bytes about a quarter of
     the total, the sum every leaf exactly once) that this process serves
     on one device (``ForecastEngine(ckpt=)``, bf16), its lead-1 forecast
     bit for bit that of the same seed-0 weights handed in whole (ckpt
     part (b)) and two serving ranks restore (``serve_data``); then the
     run, with 5 + 54 r kernel launches per step of rollout r, finite
     losses, peak memory under 80 GB, every step record's ``mfu`` in (0,
     1], ``achieved_tflops`` and ``comm_fraction`` (the cost model's, at
     the H100's datasheet peaks), ``trace_report``'s ``--check`` passing
     on the run's JSONL and its verdict, the cost model's FLOPs per
     sample-step beside this file's floor count; then a second run of the
     same seed with the chaos hook after step 0 (``preempt_at_step=0``:
     a final synchronous save ``ck-0``, then ``Preempted``), whose step-0
     loss, grad norm and lr must equal the first run's bit for bit, and a
     fresh ``TrainEngine(resume=ck-0)`` (step 1, cursor 1) whose one step
     (5 + 54 r block_matmul launches) equals the first run's step 1 bit
     for bit and whose final params and optimizer state are the first
     run's bit for bit (``bit_fingerprint``; ckpt part (a)); the ``ckpt``
     line prints the bytes a save, the final save's submit and write
     seconds and GB/s, the resumed engine's construction seconds (the
     restore included), one
     step's synchronised wall time on the first batch without and with an
     async save of the first run's engine in flight
     (``steps_beside_a_write``; that checkpoint, written while the steps
     update the state in place, is then restored to the card, timed by
     itself, and must hold the state at the save bit for bit), and the
     card.  The checkpoint directories
     live under
     ``out/chip_smoke_ckpt`` (free disk checked first: too little fails)
     and are removed when each part ends;
  9a. ``preempt``, the resilience path, with the train phase's engines
     freed: ``resilience.Supervisor`` runs the training CLI
     (``repro_torch.launch.train.main``: ``--full --precision bf16``, the
     train phase's seed 0, batch 2, rollout up to 2, lr 1e-4 and 2 steps,
     ``--ckpt``) as child processes, this file re-run with
     ``--preempt-child`` so each reports its launches and its tracer's
     events, under ``REPRO_PREEMPT_AT_STEP=0``: child 0 signals itself
     after step 0, takes a final synchronous save at ``ck-0`` and exits
     75; the supervisor relaunches at once with ``--resume ck-0``; child
     1 runs step 1 and saves ``ck``.  Checks: attempts [75, 0],
     resumes [None, ck-0], no backoff, the children's logged steps [0]
     and [1], their (loss, lr, grad_norm) the train phase's history
     bit for bit, ``ck-0`` complete and outranked by ``ck``, 5 + 54 r
     block_matmul launches per step in each child; printed: the bytes a
     save, the final save's seconds, the seconds from the signal to child
     0's exit and from the relaunch to child 1's first step (two 14 GB
     saves under ``out/chip_smoke_ckpt/preempt``, removed after);
  9b. the data axis, with this process's engines freed, each phase this
     file re-run as rank processes sharing the card (``--train-data-rank``)
     on the train phase's weights (seed 0) and first batch of two, each
     rank reading its one row (``pipeline="sharded"``), one ``dispatch``
     step at r = 1 in each of two runs in the same processes:
     ``train_data_2d``, ``TrainEngine(mesh_model=1, mesh_data=2,
     scheme="2d")`` at full width and depth, without ZeRO-1 and then with
     it: the paper's headline layout (data-parallel copies of a model
     group) at the size a card holds twice, and ZeRO-1 where it halves the
     12 GB of masters and moments a rank; ``train_data_1d``,
     ``TrainEngine(mesh_model=2, mesh_data=2, scheme="1d",
     impl="ring_fused")`` with ZeRO-1, without the FSDP hybrid and then
     with it (``shard_params_over_data``): two model groups' rings on one
     card, each with its own IPC slots, and the weights cut over data.
     Checks: each rank reads 1/2 (1/4) of the batch's bytes, bit for bit
     its rows and block of the whole batch; a step's launches per rank are
     ``train_2d``'s (18 r wx, every dx at one split term, 5 + 30 r
     block_matmul) or ``train_1d``'s ((2 + 24 r) p ring_fwd, (2 + 12 r) p
     ring_bwd, no block_matmul); step 1's loss and grad norm within 5e-2
     of the train phase's scheme="none" step on the same batch; the two
     runs' losses, grad norms and final parameters bit for bit; with
     ZeRO-1 a rank's optimizer-state bytes at most half of those without
     plus the leaves it keeps whole; under the FSDP hybrid half the weight
     bytes; each run's summed peak under 80 GB; printed: the device time
     per sample-step beside its bound, the data all-reduces' time and the
     bytes through host memory, and the batch read's ``data_wait``;
  10. ``dense_forward``, with the training and data phases' memory
     freed: ``h2o-danube-1.8b`` whole (24 layers, random bf16 weights from
     seed 0) at sequence 4608 and batch 2 on ``TokenDataset`` rows, so its
     4,096-token sliding window masks the last 512 positions: 169
     block_matmul launches (24 x 7 + the head), all on the Hopper loop,
     logits finite, the forward's ms and tokens/s beside
     ``launch/analysis.py``'s FLOP floor at the bf16 peak; on the same
     weights in f32, ``kernel="pallas"`` against ``kernel="xla"``, the bf16
     logits against the f32 ones, and the f32 forward with
     ``sliding_window=None``: its logits inside the window as the
     windowed forward's, every position past it changed; then
     block_matmul at the forward's 8 GEMM shapes (9,216 rows), timed
     beside its plain version, ``F.linear`` and the bound;
  11. ``dense_generate``: ``serve.step.generate`` on the same weights at
     batch 4 from 4,160-token prompts (past the window) with 32 new
     tokens: the fused prefill, then the decode step captured before the
     counted run (``graph_serve_step``) replayed on the 4,096-slot
     rolling cache; then eagerly (``graph=False``): the tokens equal, 169
     block_matmul launches a step (the prefill's forward one step; the
     graphed ones counted by replay, the decode steps on the WMMA loop),
     no capture in the counted run; in f32 the decode logits along the
     generated tokens (from a fused f32 prefill) against the
     teacher-forced forward of prompt + output, and the fused prefill of
     64-token prompts against the token-wise one; a decode step's device
     (CUDA events) and host ms, graphed and eager; block_matmul at the
     step's 4-row shapes beside ``F.linear`` and the bound, and the step's
     bound (weights and KV cache at the memory rate);
  12. ``gemma3_generate``: ``gemma3-27b`` at its published width cut in
     depth to 8 layers (one 5:1 local:global period and the 2-layer
     leftover, for the published 62 = 10 * 6 + 2; seed-0 bf16 weights),
     ``generate`` at batch 2 from 64-token prompts prefilled token by
     token through the captured step (a local:global stack has no fused
     prefill), 16 new tokens; then eagerly: the tokens equal, 49
     block_matmul launches a step (8 x 6 + the head), no capture in the
     counted run; in f32 the token-wise logits at every prompt position
     against the teacher-forced forward; the step's times, and
     block_matmul at its 2-row shapes, as in 11;
  13. ``moe_forward``: ``phi3.5-moe-42b-a6.6b`` at its published width
     cut in depth from 32 layers to 4 (all 16 experts, top-2; seed-0 bf16
     weights) at sequence 4096 and batch 2 (8 groups of 1,024 tokens,
     capacity 160 an expert and group): 21 block_matmul launches (q, k, v,
     o and the f32 router a layer, the head), logits and aux finite, the
     share of (token, k) slots dropped, the aux loss, ms and tokens/s
     beside the FLOP floor; on the same weights in f32, ``kernel="pallas"``
     against ``"xla"``: every layer's routes equal (a flip only at a near
     tie, printed with its probability gap) and the logits within 1e-3
     before any flip; bf16 against f32; block_matmul at the forward's
     shapes;
  14. ``moe_generate``: ``generate`` on the same weights at batch 4 from
     1,024-token prompts (the fused prefill at capacity factor 1.25, then
     decode steps at n_experts) with 32 new tokens, graphed then eager:
     the tokens equal, 21 launches a step (by replay); in f32 at
     capacity_factor = n_experts, decode along 16 prompt tokens after a
     fused 64-token prefill against the teacher-forced forward, and the
     fused prefill of 64-token prompts against the token-wise one; a
     decode step's device and host ms, graphed and eager, against its
     bytes bound (every expert's weights, since the dispatch runs every
     expert, the linears' and the KV cache at the memory rate);
     block_matmul at the step's 4-row shapes;
  15. ``hybrid_forward`` and ``hybrid_generate``:
     ``jamba-1.5-large-398b`` at its published width cut to one period (8
     layers: SSM slots 0-3 and 5-7, attention at 4, MoE on the odd slots;
     the reference asserts whole periods) and 8 of its 16 experts (top-2),
     51.8 GB of seed-0 bf16 weights: the forward at sequence 2048, batch
     1, with 7 ssd (heads entry) and 49 block_matmul launches, logits
     finite, held against ``kernel="xla"`` on the same weights and both
     against the same forward in f32 with the weights up-cast one slot at
     a time (``HYBRID_XLA_FACTOR``); then ``generate`` at batch 2 from
     64-token prompts prefilled token by token through the captured step
     on the nested per-slot cache, 16 new tokens, graphed then eager: the
     tokens equal, 49 launches a step and no ssd launch (by replay); the
     step's times and bound as in 14; block_matmul at the forward's and
     the step's shapes;
  16. ``audio_forward``: ``whisper-small`` whole (12 encoder and 12
     decoder layers, random bf16 weights from seed 0) at batch 4 x 1,500
     frames x 448 decoder tokens: 193 block_matmul launches (6 an encoder
     layer, 10 a decoder layer, the head), all on the Hopper loop, logits
     finite, ms and tokens/s beside the FLOP floor, the encoder's ms; on
     the same weights in f32, ``kernel="pallas"`` against ``"xla"`` and
     the bf16 logits against the f32 ones, each as a share of the mean
     magnitude; block_matmul at the forward's shapes;
  17. ``audio_generate``: ``generate`` on the same weights at batch 4 from
     4-token prompts with the frames as ``extra_batch``, 64 new tokens:
     the encoder once, the prompt token by token through the captured
     step (whose static cache takes the encoder's states), then the
     decode steps; graphed then eager: the tokens equal, 121 launches a
     step by replay and 72 for the encoder; in f32 the token-wise logits
     along prompt + output against the teacher-forced forward; a decode
     step's device and host ms, graphed and eager, against its bytes
     bound (the cross k and v recomputed from the encoder's 6,000 rows
     every step, as the reference's), and the encoder's ms apart;
  18. ``lm_train``: ``TrainEngine("h2o-danube-1.8b", reduced=False)``
     whole under the bf16 policy with remat, batch 2 x 1,024 tokens of
     ``TokenBatchSource`` rows, four steps: step 0's loss, grad norm and
     every leaf's gradient against ``kernel="xla"`` on the same weights
     and batch (``LM_TRAIN_TOL``, the leaves ``LM_LEAF_TOL``), beside
     the noise floor (kernel="xla" with the input embedding one bf16
     step off) and the same step with the LM head zeroed as the control
     those bounds must refuse; the
     run's block_matmul launches by layout (forward and recompute, dx,
     dw: 675 a step), losses finite, the weights moved, every step
     record's ``mfu``, ms a step and tokens/s with ``data_wait`` apart,
     the peak memory; block_matmul at the step's shapes in its three
     layouts;
  19. ``audio_train``: whisper-small whole, two steps at batch 2 x 448
     tokens with its frames (795 launches a step, the GELU recomputes
     among them); ``moe_train``: ``phi3.5-moe-42b-a6.6b`` at its published
     width cut from 32 layers to 2 (all 16 experts), one step at batch 2
     x 1,024 under the config's own dtypes, its router on block_matmul's
     f32 route forward and in its VJP (4 launches a layer), ``aux`` in
     the metrics; for each, the checks of 18;
  19b. ``lm_1d``: h2o-danube-1.8b whole on a (data 1, model 2) 1-D mesh of
     two rank processes sharing the card (``--lm-1d-rank``: gloo between
     them, the ring's slots and the vocab-parallel head's all-gather
     mapped by CUDA IPC), ``TrainEngine(mesh_model=2, scheme="1d",
     impl="ring_fused")`` under lm_train's settings, two steps: step 0's
     loss, grad norm and four named leaves (the first layer's wk, the last
     layer's down, the head, the final norm) against lm_train's
     one-device step 0 (handed over in a file) within ``LM_TRAIN_TOL`` /
     ``LM_LEAF_TOL``; ring_chunked's step-0 loss bit for bit
     ring_fused's; the run's ring_fwd, ring_bwd and block_matmul launches
     equal to ``lm_1d_calls`` (672, 336 and 3 a rank and step); ms a step
     on each rank, tokens/s, the peak a rank with the ring's slots, the
     bytes through host and through the IPC slots, the bound from the
     cost model's FLOPs; then h2o cut to 4 layers at 2 x 512 in f32 on
     the two ranks against the one-device f32 forward (``DENSE_F32_TOL``).
     ``ring_shape`` (7) holds the ring kernels at h2o's per-rank shapes
     too (``LM_RING_SHAPES``);
  19c. ``lm_1d_zoo``: the moe, ssm, hybrid and audio families on the same
     mesh (``--lm-1d-zoo-rank``), one step each under its one-device
     phase's settings and first batch, ``impl="ring_fused"``, each
     engine freed before the next: mamba2-130m whole (its 24 heads, 12 a
     rank; its conv channels re-laid to the heads through the IPC
     slots), phi3.5-moe at its published width cut to 2 layers (8 of its
     16 experts a rank: the features all-gathered, the partial outputs
     reduce-scattered through the IPC slots), whisper-small whole and
     jamba reduced; step 0 in f32 (the weights up-cast): its loss, grad
     norm, aux and two named leaves each (``ZOO_LEAVES``) against the
     one-device phase's step 0 in f32 (handed over in a file by
     ``zoo_handoff``, with its noise floors and the MoE's routes, whose
     flips are printed) within ``ZOO_TOL`` / ``ZOO_LEAF_TOL``; the
     launches equal to ``lm_1d_zoo_calls``; ms a
     step on each rank, tokens/s, the peak a rank, the bytes through
     host and through the IPC slots, the cost model's bound.
     ``ring_shape`` (7) holds the ring kernels at the three full-width
     models' per-rank shapes (``ZOO_RING_SHAPES``, in_dt's chunks of 12
     columns among them), ``ssd_shape`` (4) and ``ssd_bwd_shape`` the SSD
     kernels at 12 heads of one group and at jamba's 4 of 4 groups, and
     block_matmul the heads' and phi3.5's router's per-rank shapes;
  19d. ``lm_1d_serve``: serving every family on the same mesh
     (``--lm-1d-serve-rank``), ``serve/step.py::generate`` with each
     rank's block of the cache laid out by the reference's
     ``cache_specs``, impl="ring_fused", each model freed before the
     next: h2o-danube-1.8b whole in the heads mode (4 of its 8 kv heads a
     rank; batch 4, a 128-token prompt through the fused prefill, 16
     greedy tokens), h2o cut to 4 layers with kv_shard="seq" (the
     window's cache slots cut over the ranks), mamba2-130m whole (12 of
     24 heads a rank), whisper-small whole (the encoder's states cut on
     D), phi3.5 at its published width cut to 2 layers (8 of 16 experts
     a rank) and jamba reduced.  Each in f32 (the weights up-cast):
     the prefill's and 2-6 teacher-forced decode steps' logits against
     the one-device ``decode_step`` on the same weights within
     ``SERVE_TOL``; then in its own dtypes the mesh's greedy tokens
     (``prefill`` and ``make_serve_step``'s steps, as ``generate`` runs
     them), how many agree with the one-device ``generate``'s, the
     launches of a decode step equal to ``lm_1d_serve_calls`` (and the
     run's to it times the steps), ms
     of the prefill and a token on each rank beside the one-device graphed
     figure of PERF.md §5, the peak a rank with the ring's slots, the
     bytes a step moves through host and through the IPC slots, and the
     step's bytes bound at the rank's shapes.  block_matmul at the decode
     steps' per-rank shapes first (the heads, phi3.5's router), and
     ``ring_shape`` (7) holds ring_fwd at the decode steps' per-rank
     shapes (``LM_SERVE_RING_SHAPES``: M = 4 rows, the forward alone);
  20. the ``kernels`` line, the card's name and power limit, and the last
     line ``{"ok": true, "device": {...}}``.

Every phase line carries ``elapsed_s``, the seconds since the start.

Any failed check exits non-zero before the last line.  Without CUDA, or
run outside a checkout, it exits non-zero and prints no result.

Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise):
  * bf16 GEMMs 3e-2 / 3e-2: the output is rounded to bf16 (2^-8 relative)
    and a different summation order flips some roundings (the bf16
    tolerance of the repository's kernel tests);
  * f32 GEMMs 1e-4 / 1e-4: exact f32 FMA, but K runs to 16,380 in an order
    other than cuBLAS's (~sqrt(K) * 2^-24 relative);
  * wx: the bf16 forward 1e-3 / 1e-3 (its f32 output is not rounded and
    bf16 products are exact in f32, so the error is the summation order's:
    1.2e-4 at most at these shapes, where a bf16 rounding of the
    accumulator, a or the output would show up to 1.6e-2), dx 1e-4 / 1e-4
    (every product of the bf16 w and a split term of dy is exact in f32)
    and 1e-4 max-normalised against a float64 oracle (``WX_DX_F64_TOL``);
  * block_matmul's Hopper loop: bit for bit its WMMA loop;
  * whole forecast step, max|a - b| / max|b|: bf16 policy 5e-2 (the plain
    step rounds each GEMM to bf16 before its bias and activation, the
    kernel after, through 3 blocks of bf16 residual stream); legacy f32
    1e-4;
  * first training step against ``kernel="xla"``, and the 2-D step and
    the data phases' first steps against the ``scheme="none"`` step: loss
    and grad norm relative, each gradient leaf max|a - b| / max|b| (not
    in the data phases), all 5e-2 (the reference's bf16
    loss-parity bound; the same rounding difference as the forecast step,
    through the backward too: the 2-D branch rounds each GEMM to bf16
    before its bias and GELU, the none path after);
  * ring forward: bit for bit the ring of block_matmul's products (the same
    K order, the same cast points); against the plain version bf16 3e-2 /
    3e-2 (every hop rounds to bf16), f32 1e-4 / 1e-4; ring backward: dw bit
    for bit block_matmul's, dx's f32 accumulator 1e-4 max-normalised
    against the plain one (another order over m) and, in bf16, bit for bit
    the wx step loop (the kernel it replaces ran the same WMMA loop and
    epilogue), dx that accumulator rounded;
  * the 1-D step against the none step: loss 1e-3 and grad norm 5e-3
    relative, the worst gradient leaf 5e-2 max-normalised (the 1-D path
    rounds each linear's partial sums to bf16 at every hop and adds the
    bias after the reduce); the 2x2 step the same bounds (each Cannon
    linear rounds its product to bf16 before its bias, as under q = 1);
    h2o's 1-D step 0 against its one-device step 0: lm_train's bounds
    against kernel="xla" (loss and grad norm 1e-2, the leaves 0.1), the
    same kind of rounding difference;
  * the Cannon kernel: bit for bit the step loop (wx's main loop, K order
    and epilogue); against the plain Cannon the wx tolerances;
  * the ssd kernel: f32 2e-4 / 2e-4 (the reference's own kernel tolerance:
    sums of N = 128 and Q = 64 terms in another order), bf16 3e-2 / 3e-2
    (att and y rounded to bf16); its heads entry bit for bit its [G, Q, N]
    entry (the same fmaf chains);
  * the ssd backward kernel: each gradient max|a - b| / max|b| 1e-4
    against the plain backward in f32 and in float64 (``SSD_BWD_TOL``);
    mamba2-130m's training step 0 in f32: against the plain SSD term
    1e-3 on the loss, the grad norm and every leaf, against
    ``kernel="xla"`` 1e-3 on the loss and grad norm and 1e-2 on the
    leaves (``MAMBA_TRAIN_TOL``, ``MAMBA_XLA_LEAF_TOL``); jamba reduced,
    the card's step against the CPU's, 1e-3 (``HYBRID_TRAIN_TOL``);
  * mamba2-130m logits, judged in f32 (the seed's weights up-cast, where
    only summation orders differ): max|a - b| / max|b| 1e-3 against the
    plain SSD term and against ``kernel="xla"``; token-wise decode against
    the teacher-forced forward 5e-3 / 5e-3 elementwise (the reference's
    own); the bf16 forward against the f32 one by mean|a - b| / mean|b|
    0.3, a gross-fault check only: the random-weight bf16 residual stream
    amplifies rounding through 24 layers (``MAMBA_BF16_TOL``);
  * the transformer phases (``DENSE_*_TOL``), judged in f32 likewise:
    pallas against xla 1e-3 max-normalised; token-wise decode against the
    teacher-forced forward 5e-3 / 5e-3; the fused prefill against the
    token-wise one: the next tokens equal, the f32 caches rtol 5e-3 /
    atol 1e-4 (the reference's ``test_fused_prefill_parity``); the bf16
    forward against the f32 one 0.1 of the mean (a gross-fault check);
    past the window every position's logits change by more than ten
    times the largest difference inside it (where the two forwards are
    the same arithmetic);
  * the moe phases likewise (a route that flips between the f32 pallas
    and xla forwards must be a near tie, ``MOE_TIE_GAP``); the hybrid's
    bf16 forward against ``kernel="xla"`` on the same weights, by
    mean|a - b| / mean|f32|, at most twice the xla forward's distance from
    the f32 one (``HYBRID_XLA_FACTOR``: both round the same products to
    bf16 and differ only in the order of the f32 sums, so neither is
    farther from the exact forward than the other).
The plain versions run with ``torch.backends.cuda.matmul.allow_tf32 =
False``, so their f32 products are full f32.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                   # HBM3, bytes/s
GEMM_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
STEP_TOL = {"bf16": 5e-2, "legacy": 1e-4}
TRAIN_TOL = 5e-2
TRAIN_STEPS = 2           # seed 0's rollout schedule: r = 1, 2
TRAIN_BATCH = 2
TRAIN_ROLLOUT = 2
PEAK_MEM_LIMIT = 80e9
# the checkpoint directories (out/ is ignored by git); each part's is
# removed when it ends
CKPT_ROOT = ROOT / "out" / "chip_smoke_ckpt"
# the start of this process: every phase line carries the seconds since
T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(**kw):
    """One JSON line; a phase line also carries ``elapsed_s``, the seconds
    since this process started."""
    if "phase" in kw:
        kw["elapsed_s"] = time.perf_counter() - T0
    print(json.dumps(kw), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch
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


def gemm_bound_ms(m, n, k, dtype_name, bias, batch=1, mn_bytes=None):
    """Least time on the card: FLOPs over the peak rate for the operand
    type, or bytes (each input read once, the output written once) over
    the memory rate, whichever is larger.  ``batch`` products share the
    [m, k] operand (wx's w); ``mn_bytes`` is what each of the batch's
    [m, n] elements moves: the output in the operand type unless given
    (wx: its f32 output, plus the f32 accumulator ``a`` it reads)."""
    es = 4 if dtype_name == "float32" else 2
    mn_bytes = es if mn_bytes is None else mn_bytes
    flops = 2.0 * batch * m * n * k
    nbytes = (es * (m * k + batch * n * k) + batch * m * n * mn_bytes
              + es * (n if bias else 0))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gemm_errors(y, r, dtype_name):
    tol = GEMM_TOL[dtype_name]
    y, r = y.float(), r.float()
    err = (y - r).abs()
    ok = bool((err <= tol + tol * r.abs()).all())
    return float(err.max()), ok


def sm_count(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def blocks_per_sm(attrs):
    """Blocks of a kernel that fit on one SM at once, by its registers
    (allocated in steps of 8 a thread), its shared bytes (plus 1 KiB the
    runtime reserves) and its threads: the divisor of a one-block-per-tile
    launch's waves."""
    regs = -(-attrs["registers"] // 8) * 8
    shared = (attrs["static_shared_bytes"] + attrs["dynamic_shared_bytes"]
              + 1024)
    return max(1, min(65536 // (regs * attrs["threads"]), 233472 // shared,
                      2048 // attrs["threads"]))


def bm_route_fields(torch, BM, SM90, x, w, m, n, k, epi, x_t, w_t):
    """What a block_matmul launch at this shape runs: its route, its
    kernel's registers, spills and shared bytes, its operands' load paths,
    its tiles and waves, and the device time of the per-call padding of
    operands whose rows TMA cannot take (0 where none is padded)."""
    path = BM.route(m, n, x.dtype)
    if path != "sm90":
        if path == "wmma":
            vb = BM.vec_bytes(x, w)
            loads = f"{vb} B"
        else:       # 16 B where the contiguous side is a multiple of 4
            vb = 16
            loads = {name: "16 B" if side % 4 == 0 else "4 B"
                     for name, side in (("x", m if x_t else k),
                                        ("w", n if w_t else k))}
        attrs = BM.kernel_attrs(path, x_t, w_t, epi, vb)
        blocks = -(-m // 128) * -(-n // 128)
        return dict(route=path, loads=loads, kernel=attrs, tiles=blocks,
                    grid=blocks, blocks_per_sm=blocks_per_sm(attrs),
                    waves=blocks / (blocks_per_sm(attrs) * sm_count(torch)),
                    pad_ms=0.0)
    ops = SM90.tma_operands_block_matmul(m, n, k, x_t, w_t)
    tiles = SM90.sm90_tiles(m, n)
    grid = SM90.persistent_grid(tiles, False, sm_count(torch))
    padded = [t for t in (x, w) if SM90.pad_rows(t) is not t]
    return dict(route=path,
                loads={name: op.describe() for name, op in ops.items()},
                kernel=BM.kernel_attrs(path, x_t, w_t, epi),
                tiles=tiles, grid=grid, waves=tiles / grid,
                pad_ms=(cuda_ms(lambda: [SM90.pad_rows(t) for t in padded])
                        if padded else 0.0))


def check_routes_agree(torch, BM, y, args, kw, what):
    """A bf16 result of the Hopper loop against the WMMA loop's on the same
    operands, bit for bit (the same k16 steps in the same K order, the
    same epilogue); returns the WMMA launch's device time."""
    y_w = BM.block_matmul(*args, route_name="wmma", **kw)
    torch.cuda.synchronize()
    check(torch.equal(y, y_w), f"{what}: the Hopper loop's result is not "
          "bit for bit the WMMA loop's")
    return cuda_ms(lambda: BM.block_matmul(*args, route_name="wmma", **kw))


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

# weathermixer-1b at batch 1: d = 4320, T = 16380 tokens, patch dim 4416.
# (label, M, K, N, epilogue, dtype name, launches per forecast step,
#  launches per training sample-step at rollout 1: forward, the remat
#  recompute and, for the GELU layers, the pre-activation recompute)
_D, _T, _PD = 4320, 16380, 4416
SHAPES = [("encoder", _T, _PD, _D, "none", "bfloat16", 1, 1),
          ("tok_fc1", _D, _T, 8640, "gelu", "bfloat16", 3, 9),
          ("tok_fc2", _D, 8640, _T, "none", "bfloat16", 3, 6),
          ("ch_fc1", _T, _D, 4320, "gelu", "bfloat16", 3, 9),
          ("ch_fc2", _T, 4320, _D, "none", "bfloat16", 3, 6),
          ("decoder", _T, _D, _PD, "none", "bfloat16", 1, 1),
          ("tok_fc1_f32", _D, _T, 8640, "gelu", "float32", 0, 0)]

# mamba2-130m (d_model 768, d_inner 1536, conv_dim 1536 + 2 * 128, 24 heads,
# vocab 50,432), its forward at sequence 4096 and batch 2 (M = 8192 rows)
# and its decode step at batch 4 (M = 4): (label, M, K, N, launches per
# forward or decode step); no bias, no epilogue
MAMBA_SEQ, MAMBA_BATCH, MAMBA_LAYERS = 4096, 2, 24
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 64, 32
_MM = MAMBA_SEQ * MAMBA_BATCH
MAMBA_SHAPES = [(f"{tag}.{name}", m, k, n, per)
                for tag, m in (("fwd", _MM), ("decode", GEN_BATCH))
                for name, k, n, per in (("in_z", 768, 1536, MAMBA_LAYERS),
                                        ("in_xbc", 768, 1792, MAMBA_LAYERS),
                                        ("in_dt", 768, 24, MAMBA_LAYERS),
                                        ("out_proj", 1536, 768, MAMBA_LAYERS),
                                        ("head", 768, 50432, 1))]

def lm_gemm_rows(torch, BM, SM90, ref, gen, shapes):
    """block_matmul at a language model's GEMM shapes, no bias: (label, M,
    K, N, epilogue, launches per path[, dtype name]; bf16 unless named:
    the MoE router is f32) each against its plain version, timed beside
    it, the library call (``F.linear``, with the tanh GELU where the
    epilogue has it) and the bound; each row with its route fields and, on
    the Hopper loop, bit for bit the WMMA loop."""
    import torch.nn.functional as F
    rows, worst = [], 0.0
    for label, m, k, n, epi, per_path, *dt in shapes:
        name = dt[0] if dt else "bfloat16"
        dtype = getattr(torch, name)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        y = BM.block_matmul(x, w, None, epi)
        torch.cuda.synchronize()
        err, ok = gemm_errors(y, ref.block_matmul_ref(x, w, None, epi),
                              name)
        check(ok, f"{label} {(m, k, n)}: max err {err:.3e}")
        worst = max(worst, err)
        if epi == "gelu":
            def library():
                return F.gelu(F.linear(x, w), approximate="tanh")
        else:
            def library():
                return F.linear(x, w)
        bound, bound_by = gemm_bound_ms(m, n, k, name, False)
        row = dict(shape=label, m=m, n=n, k=k, dtype=name,
                   epilogue=epi, per_path=per_path,
                   **bm_route_fields(torch, BM, SM90, x, w, m, n, k, epi,
                                     False, False),
                   max_abs_err=err, tol=GEMM_TOL[name],
                   kernel_ms=cuda_ms(lambda: BM.block_matmul(x, w, None,
                                                             epi), 10),
                   library_ms=cuda_ms(library, 10),
                   plain_ms=cuda_ms(lambda: ref.block_matmul_ref(
                       x, w, None, epi), 3),
                   bound_ms=bound, bound_by=bound_by)
        if row["route"] == "sm90":
            row["wmma_ms"] = check_routes_agree(torch, BM, y,
                                                (x, w, None, epi), {}, label)
            row["bitwise_wmma"] = True
        row["tflops"] = 2e-9 * m * n * k / row["kernel_ms"]
        emit(phase="kernel_shape", **row)
        rows.append(row)
        del x, w, y
    torch.cuda.empty_cache()
    return rows, worst


def kernel_phase(torch, BM, SM90, ref):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(m, k, n, dtype, bias):
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        b = ((0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
             if bias else None)
        return x, w, b

    worst = 0.0
    n_small = n_bitwise = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for m, k, n in [(1, 1, 1), (7, 13, 5), (300, 700, 130),
                        (129, 97, 257), (200, 16380, 72)]:
            for epi in ("none", "gelu", "silu"):
                for bias in (True, False):
                    x, w, b = inputs(m, k, n, dtype, bias)
                    y = BM.block_matmul(x, w, b, epi)
                    torch.cuda.synchronize()
                    err, ok = gemm_errors(y, ref.block_matmul_ref(x, w, b,
                                                                  epi), name)
                    what = f"small {name} {(m, k, n)} {epi} bias={bias}"
                    check(ok, f"{what}: max err {err:.3e}")
                    if BM.route(m, n, dtype) == "sm90":
                        check_routes_agree(torch, BM, y, (x, w, b, epi), {},
                                           what)
                        n_bitwise += 1
                    worst = max(worst, err)
                    n_small += 1
    emit(phase="kernel_small", cases=n_small, max_abs_err=worst,
         bitwise_wmma_cases=n_bitwise, ok=True)

    rows = []
    for label, m, k, n, epi, name, per_step, per_train in SHAPES:
        dtype = getattr(torch, name)
        x, w, b = inputs(m, k, n, dtype, True)
        y = BM.block_matmul(x, w, b, epi)
        torch.cuda.synchronize()
        err, ok = gemm_errors(y, ref.block_matmul_ref(x, w, b, epi), name)
        check(ok, f"{label} {(m, k, n)} {name}: max err {err:.3e}")
        worst = max(worst, err)
        if epi == "gelu":
            def library():
                return F.gelu(F.linear(x, w, b), approximate="tanh")
        else:
            def library():
                return F.linear(x, w, b)
        bound, bound_by = gemm_bound_ms(m, n, k, name, True)
        row = dict(shape=label, m=m, n=n, k=k, dtype=name, epilogue=epi,
                   per_step=per_step, per_train_step=per_train,
                   **bm_route_fields(torch, BM, SM90, x, w, m, n, k, epi,
                                     False, False),
                   max_abs_err=err, tol=GEMM_TOL[name],
                   kernel_ms=cuda_ms(lambda: BM.block_matmul(x, w, b, epi)),
                   library_ms=cuda_ms(library),
                   plain_ms=cuda_ms(lambda: ref.block_matmul_ref(x, w, b,
                                                                 epi), 3),
                   bound_ms=bound, bound_by=bound_by)
        if row["route"] == "sm90":
            row["wmma_ms"] = check_routes_agree(torch, BM, y, (x, w, b, epi),
                                                {}, label)
            row["bitwise_wmma"] = True
        row["tflops"] = 2e-9 * m * n * k / row["kernel_ms"]
        emit(phase="kernel_shape", **row)
        rows.append(row)
        del x, w, b, y
        torch.cuda.empty_cache()

    mamba_rows, mamba_worst = lm_gemm_rows(
        torch, BM, SM90, ref, gen, [(label, m, k, n, "none", per)
                                    for label, m, k, n, per in MAMBA_SHAPES])
    worst = max(worst, mamba_worst)
    torch.cuda.empty_cache()
    return rows, mamba_rows, worst


# ---------------------------------------------------------------------------
# phases 2b-2d: the ssm family (mamba2-130m): the ssd kernel, forward, generate
# ---------------------------------------------------------------------------

SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SSD_Q, SSD_N, SSD_P, SSD_HEADS = 64, 128, 64, 24
# G = batch x chunks x heads of the two forwards
SSD_SHAPES = [("seq2048.b1", 2048 // SSD_Q * SSD_HEADS),
              ("seq4096.b2", 2 * MAMBA_SEQ // SSD_Q * SSD_HEADS)]
# mamba2-130m logits.  Judged in f32 (the seed's weights up-cast), where
# only the summation orders differ: max|a - b| / max|b| against the plain
# SSD term and against kernel="xla", and token-wise decode against the
# teacher-forced forward elementwise at the reference's own 5e-3
# (tests/test_decode_consistency.py).  The bf16 forward (the config's own
# dtypes) against the f32 one by mean|a - b| / mean|b|: a random-weight
# bf16 residual stream through 24 layers amplifies rounding (on the CPU, 1%
# of the linears' outputs moved by one bf16 step moves the logits by 15 % of
# their mean, and bf16 against f32 is 16-18 %), so only a gross fault
# (zeros, a wrong layout: ~100 %) is caught there.
MAMBA_F32_TOL = 1e-3
MAMBA_DECODE_TOL = 5e-3
MAMBA_BF16_TOL = 0.3


def ssd_inputs(torch, gen, g, q, n, p, dtype, decay=None):
    """c, b, x in ``dtype``; dt = softplus(N(0, 1)); dac the within-chunk
    cumsum of dt * A with the model's initial A = -linspace(1, 16, 24) by
    head (g % 24), or -decay.  Above the diagonal exp(dac_i - dac_j)
    overflows to inf for the faster heads at Q = 64."""
    c = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda")).to(dtype)
    b = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda")).to(dtype)
    x = torch.randn(g, q, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(g, q, generator=gen, device="cuda"))
    if decay is None:
        a = -torch.linspace(1.0, 16.0, SSD_HEADS, device="cuda").repeat(
            (g + SSD_HEADS - 1) // SSD_HEADS)[:g, None]
    else:
        a = torch.full((g, 1), -decay, device="cuda")
    return c, b, x, dt, torch.cumsum(dt * a, dim=1)


def ssd_bound_ms(g, q, n, p, dtype_name):
    """Each input read once (c, b, x in the operand type, dt and dac f32),
    y written once; the operations the causal half needs, 2 (N + P) per
    (i, j <= i) pair, at the operand type's peak."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = g * (es * q * (2 * n + 2 * p) + 8 * q)
    ops = g * (n + p) * q * (q + 1)
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_heads_bound_ms(bsz, s, h, p, g, n, q, dtype_name):
    """The model's layout: x read and y written once (operand type), dt and
    dac read once (f32), B and C read once (not once per head); s once per
    (batch, chunk, group), 2 n per (i, j <= i) pair, and y per head, 2 p
    per pair, at the operand type's peak."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = es * (2 * bsz * s * h * p + 2 * bsz * s * g * n) + 8 * bsz * s * h
    ops = (bsz * s // q) * q * (q + 1) * (g * n + h * p)
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# an odd width (N = 5, P = 3: rows of 20 and 12 bytes) that TMA
# cannot take: the kernel's scalar route
SSD_ODD = (37, 5, 3)
# mamba2-130m's layer at sequence 4096, batch 2: (batch, seq, heads, head
# width, groups, state)
SSD_LAYER = (MAMBA_BATCH, MAMBA_SEQ, SSD_HEADS, SSD_P, 1, SSD_N)
# jamba-1.5-large-398b's SSM slot in the hybrid forward (sequence 2048,
# batch 1): 256 heads of 64 in 8 groups (32 heads a group), state 128
SSD_JAMBA_LAYER = (1, 2048, 256, SSD_P, 8, SSD_N)
# the same layers at one rank of lm_1d_zoo's two: mamba2-130m's 12 heads
# of one group, and reduced jamba's SSM slot (hybrid_train: sequence 512,
# batch 2, state 32) at 4 heads of 4 groups
SSD_RANK_LAYER = (MAMBA_BATCH, MAMBA_SEQ, SSD_HEADS // 2, SSD_P, 1, SSD_N)
SSD_JAMBA_RANK_LAYER = (2, 512, 4, SSD_P, 4, 32)


def ssd_heads_inputs(torch, gen, bsz, s, h, p, g, n, dtype, q=SSD_Q):
    """x [b, s, h, p], dt [b, s, h] = softplus(N(0, 1)), dac its
    within-chunk (``q``) cumsum of dt * A (the model's initial A by head),
    B, C [b, s, g, n]: contiguous, as the bf16 forward hands them over."""
    x = torch.randn(bsz, s, h, p, generator=gen, device="cuda").to(dtype)
    bm = (0.3 * torch.randn(bsz, s, g, n, generator=gen, device="cuda")
          ).to(dtype)
    cm = (0.3 * torch.randn(bsz, s, g, n, generator=gen, device="cuda")
          ).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, s, h, generator=gen, device="cuda"))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    dac = torch.cumsum((dt * a).unflatten(1, (-1, q)), dim=2).flatten(1, 2)
    return x, dt, dac, bm, cm


def ssd_groups(x, dt, dac, bm, cm, q):
    """The heads layout as ``_ssd_chunked`` laid it out for the [G, Q, N]
    entry before the heads entry existed: B and C repeated over the heads,
    every operand copied into (batch, chunk, head) groups."""
    bsz, s, h, _ = x.shape
    rep = h // bm.shape[2]

    def groups(t):
        t = t.reshape((bsz, s // q, q) + t.shape[2:]).movedim(3, 2)
        return t.reshape((bsz * (s // q) * h, q) + t.shape[4:]).contiguous()
    return (groups(cm.repeat_interleave(rep, 2)),
            groups(bm.repeat_interleave(rep, 2)), groups(x), groups(dt),
            groups(dac))


def ssd_route(SSD, fn):
    """The route of one launch of ``fn`` (route_launches cleared before)."""
    SSD.ssd_intra_chunk.route_launches.clear()
    out = fn()
    (key, n), = SSD.ssd_intra_chunk.route_launches.items()
    check(n == 1, f"ssd: {n} launches in one call")
    return out, key.split(".")[1]


def ssd_kernel_fields(torch, SSD, dtype, n, p, heads_per_item, items):
    attrs = SSD.kernel_attrs(dtype, n, p, heads_per_item)
    return dict(kernel=attrs, blocks_per_sm=blocks_per_sm(attrs),
                items=items, grid=min(items, sm_count(torch)))


def ssd_phase(torch, SSD, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def errors(y, r, name):
        tol = SSD_TOL[name]
        y, r = y.float(), r.float()
        err = (y - r).abs()
        return float(err.max()), bool((err <= tol + tol * r.abs()).all())

    worst = 0.0
    n_small = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        cases = [(q, n, p) for q in (64, 37) for n in (32, 128)
                 for p in (16, 64)] + [SSD_ODD]
        for q, n, p in cases:
            args = ssd_inputs(torch, gen, 6, q, n, p, dtype, decay=0.1)
            y, rt = ssd_route(SSD, lambda: SSD.ssd_intra_chunk(*args))
            torch.cuda.synchronize()
            want = "scalar" if (q, n, p) == SSD_ODD else "tma"
            check(rt == want, f"ssd small {name} Q={q} N={n} P={p}: route "
                              f"{rt}, want {want}")
            err, ok = errors(y, ref.ssd_intra_ref(*args), name)
            check(ok, f"ssd small {name} Q={q} N={n} P={p}: max err "
                      f"{err:.3e}")
            worst = max(worst, err)
            n_small += 1
        # dac decaying fast enough that exp overflows above the diagonal
        args = ssd_inputs(torch, gen, 4, 64, 128, 64, dtype, decay=16.0)
        dac = args[4]
        check(bool(torch.isinf(torch.exp(dac[:, :, None]
                                         - dac[:, None, :])).any()),
              "the overflow case does not overflow")
        y = SSD.ssd_intra_chunk(*args)
        torch.cuda.synchronize()
        err, ok = errors(y, ref.ssd_intra_ref(*args), name)
        check(ok and bool(torch.isfinite(y).all()),
              f"ssd overflow case {name}: max err {err:.3e}, finite "
              f"{bool(torch.isfinite(y).all())}")
        worst = max(worst, err)
        n_small += 1
    emit(phase="ssd_small", cases=n_small, max_abs_err=worst, ok=True)

    rows = []
    q, n, p = SSD_Q, SSD_N, SSD_P
    tri = torch.ones((q, q), dtype=torch.bool, device="cuda").tril()
    for label, g in SSD_SHAPES:
        c, b, x, dt, dac = args = ssd_inputs(torch, gen, g, q, n, p,
                                             torch.float32)
        y, rt = ssd_route(SSD, lambda: SSD.ssd_intra_chunk(*args))
        torch.cuda.synchronize()
        err, ok = errors(y, ref.ssd_intra_ref(*args), "float32")
        check(ok and bool(torch.isfinite(y).all()),
              f"ssd {label} G={g}: max err {err:.3e}")
        worst = max(worst, err)

        def library():
            s = torch.bmm(c, b.transpose(1, 2))
            att = torch.where(tri, s * torch.exp(dac[:, :, None]
                                                 - dac[:, None, :]), 0.0)
            return torch.bmm(att * dt[:, None, :], x)
        bound, bound_by = ssd_bound_ms(g, q, n, p, "float32")
        row = dict(shape=label, g=g, q=q, n=n, p=p, dtype="float32",
                   route=rt, max_abs_err=err, tol=SSD_TOL["float32"],
                   kernel_ms=cuda_ms(lambda: SSD.ssd_intra_chunk(*args), 20),
                   library_ms=cuda_ms(library, 10),
                   plain_ms=cuda_ms(lambda: ref.ssd_intra_ref(*args), 10),
                   bound_ms=bound, bound_by=bound_by,
                   **ssd_kernel_fields(torch, SSD, torch.float32, n, p, 1, g))
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit(phase="ssd_shape", **row)
        rows.append(row)
        del c, b, x, dt, dac, args, y
    torch.cuda.empty_cache()

    # the models' layouts (mamba2-130m's layer, jamba's SSM slot): the heads
    # entry on _ssd_chunked's tensors as they lie, bit for bit the
    # [G, Q, N] entry on the groups arrangement (repeat, groups() copies),
    # whose time is its yardstick
    for tag, (bsz, s, h, p, g, n) in (
            ("model_layout", SSD_LAYER), ("jamba_layout", SSD_JAMBA_LAYER),
            ("mamba_rank_layout", SSD_RANK_LAYER),
            ("jamba_rank_layout", SSD_JAMBA_RANK_LAYER)):
        args = ssd_heads_inputs(torch, gen, bsz, s, h, p, g, n,
                                torch.float32)
        y, rt = ssd_route(SSD, lambda: SSD.ssd_intra_heads(*args, q))
        torch.cuda.synchronize()

        def arrangement():
            yg = SSD.ssd_intra_chunk(*ssd_groups(*args, q))
            return yg.reshape(bsz, s // q, h, q, p).movedim(2, 3).reshape(
                bsz, s, h, p)
        check(torch.equal(y, arrangement()), f"ssd heads entry at {tag} is "
              "not bit for bit the [G, Q, N] entry on the copied groups")
        err, ok = errors(y, ref.ssd_intra_heads_ref(*args, q), "float32")
        check(ok and bool(torch.isfinite(y).all()),
              f"ssd {tag}: max err {err:.3e}")
        worst = max(worst, err)

        def library():
            c, b, x, dt, dac = ssd_groups(*args, q)
            sm = torch.bmm(c, b.transpose(1, 2))
            att = torch.where(tri, sm * torch.exp(dac[:, :, None]
                                                  - dac[:, None, :]), 0.0)
            return torch.bmm(att * dt[:, None, :], x)
        bound, bound_by = ssd_heads_bound_ms(bsz, s, h, p, g, n, q,
                                             "float32")
        triples = bsz * (s // q) * g
        shares = SSD.head_shares(triples, h // g, sm_count(torch))
        row = dict(shape=f"{tag}.seq{s}.b{bsz}", batch=bsz, seq=s,
                   heads=h, groups=g, q=q, n=n, p=p, dtype="float32",
                   route=rt, max_abs_err=err, tol=SSD_TOL["float32"],
                   kernel_ms=cuda_ms(lambda: SSD.ssd_intra_heads(*args, q),
                                     20),
                   arrangement_ms=cuda_ms(arrangement, 10),
                   copies_ms=cuda_ms(lambda: ssd_groups(*args, q), 10),
                   library_ms=cuda_ms(library, 10),
                   plain_ms=cuda_ms(lambda: ref.ssd_intra_heads_ref(*args,
                                                                    q), 10),
                   bound_ms=bound, bound_by=bound_by, head_shares=shares,
                   **ssd_kernel_fields(torch, SSD, torch.float32, n, p,
                                       -(-(h // g) // shares),
                                       triples * shares))
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit(phase="ssd_shape", **row)
        rows.append(row)
        del args, y
        torch.cuda.empty_cache()
    return rows, worst


# the SSD term's backward (csrc/ssd_chunk_bwd.cu): each of dx, ddt, ddac,
# dB and dC against the plain backward (ref.ssd_intra_heads_bwd_ref) in
# f32 and in float64, max|a - b| / max|b| (the same measure and bound as
# WX_DX_F64_TOL): the kernel sums up to 64 heads' [Q, Q] terms into dB
# and dC, and ddac is a difference of a row sum and a column sum, in
# another order than the plain version's products
SSD_BWD_TOL = 1e-4
# (batch, seq, heads, head width, groups, state, chunk): ragged chunks of
# 37 at an odd width (N 5, P 3) and of 64, one and two groups; then
# mamba2-130m's layer and jamba's SSM slot as in ssd_shape.  Every row at
# the models' decays (A from -1 to -16 by head), where exp overflows
# above the diagonal in the chunks of 64
SSD_BWD_SMALL = [("q37.g1", (1, 74, 2, 3, 1, 5, 37)),
                 ("q37.g2", (1, 74, 4, 3, 2, 5, 37)),
                 ("q64.g1", (2, 128, 4, 64, 1, 128, 64)),
                 ("q64.g2", (2, 128, 4, 64, 2, 32, 64)),
                 ("overflow", (1, 128, 8, 64, 1, 128, 64))]


def ssd_bwd_bound_ms(bsz, s, h, p, g, n, q):
    """x and dy read and dx written (f32), dt and dac read and ddt and
    ddac written, B and C read and dB and dC written, each once; the
    causal half's operations: per (batch, chunk, group) s and the two
    products into dB and dC, 6 n per (i, j <= i) pair, and per head datt
    and dx, 4 p per pair, at the f32 peak."""
    nbytes = 4 * (3 * bsz * s * h * p + 4 * bsz * s * h + 4 * bsz * s * g * n)
    ops = (bsz * s // q) * q * (q + 1) // 2 * (g * 6 * n + h * 4 * p)
    t_ops, t_bytes = ops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_bwd_errors(got, want):
    """The worst of the five outputs by max|a - b| / max|b| (``rel_err``),
    and the largest absolute difference, in float64."""
    pairs = [(a.double(), b.double()) for a, b in zip(got, want)]
    return (max(rel_err(a, b) for a, b in pairs),
            max(float((a - b).abs().max()) for a, b in pairs))


def ssd_bwd_phase(torch, SSDB, ref):
    """``ssd_bwd_shape``: the backward kernel against the plain backward
    on the card (f32 and float64), finite and bit for bit across two
    launches, at small ragged chunks, an overflowing chunk, mamba2-130m's
    layer and jamba's SSM slot; each row timed beside the plain version,
    the closest library composition (autograd's backward of the groups
    copies, bmm, where, * dt, bmm with the exponent masked) and the bytes
    bound, with registers, spills, shared bytes and blocks per SM."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, worst = [], 0.0
    shapes = SSD_BWD_SMALL + [
        ("model_layout", SSD_LAYER + (SSD_Q,)),
        ("jamba_layout", SSD_JAMBA_LAYER + (SSD_Q,)),
        ("mamba_rank_layout", SSD_RANK_LAYER + (SSD_Q,)),
        ("jamba_rank_layout", SSD_JAMBA_RANK_LAYER + (SSD_Q,))]
    for tag, (bsz, s, h, p, g, n, q) in shapes:
        x, dt, dac, bm, cm = ssd_heads_inputs(torch, gen, bsz, s, h, p, g,
                                              n, torch.float32, q=q)
        dy = torch.randn(bsz, s, h, p, generator=gen, device="cuda")
        args = (x, dt, dac, bm, cm, dy)
        if q == SSD_Q:
            seg = dac.unflatten(1, (-1, q))
            check(bool(torch.isinf(torch.exp(
                seg[:, :, :, None] - seg[:, :, None, :])).any()),
                f"ssd_bwd {tag}: the decays do not overflow exp")
        got = SSDB.ssd_intra_heads_bwd(*args, q)
        again = SSDB.ssd_intra_heads_bwd(*args, q)
        torch.cuda.synchronize()
        plain = ref.ssd_intra_heads_bwd_ref(*args, q)
        rel32, ab = ssd_bwd_errors(got, plain)
        del plain
        rel64, _ = ssd_bwd_errors(got, ref.ssd_intra_heads_bwd_ref(
            *(t.double() for t in args), q))
        check(all(bool(torch.isfinite(t).all()) for t in got)
              and all(torch.equal(a, b) for a, b in zip(got, again))
              and rel32 <= SSD_BWD_TOL and rel64 <= SSD_BWD_TOL,
              f"ssd_bwd {tag}: f32 {rel32:.3e}, f64 {rel64:.3e} (tol "
              f"{SSD_BWD_TOL}), finite and repeatable: "
              f"{[bool(torch.isfinite(t).all()) for t in got]}, "
              f"{[torch.equal(a, b) for a, b in zip(got, again)]}")
        worst = max(worst, ab)
        del got, again

        # the library composition: the forward's groups copies and bmm,
        # where, * dt, bmm (the exponent masked), its backward alone timed
        tri = torch.ones((q, q), dtype=torch.bool, device="cuda").tril()
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, dac, bm,
                                                            cm)]
        c_, b_, x_, dt_, dac_ = ssd_groups(*leaves, q)
        sm_ = torch.bmm(c_, b_.transpose(1, 2))
        seg_ = torch.where(tri, dac_[:, :, None] - dac_[:, None, :],
                           -float("inf"))
        y_ = torch.bmm(torch.where(tri, sm_ * torch.exp(seg_), 0.0)
                       * dt_[:, None, :], x_)
        dyg = ssd_groups(dy, dt, dac, bm, cm, q)[2]

        def library():
            return torch.autograd.grad(y_, leaves, dyg, retain_graph=True)
        bound, bound_by = ssd_bwd_bound_ms(bsz, s, h, p, g, n, q)
        attrs = SSDB.kernel_attrs(n, p)
        items = bsz * (s // q) * g
        row = dict(shape=f"{tag}.seq{s}.b{bsz}", batch=bsz, seq=s, heads=h,
                   groups=g, q=q, n=n, p=p, dtype="float32",
                   max_abs_err=ab, max_rel_err_f32=rel32,
                   max_rel_err_f64=rel64, tol=SSD_BWD_TOL,
                   kernel_ms=cuda_ms(lambda: SSDB.ssd_intra_heads_bwd(
                       *args, q), 10),
                   library_ms=cuda_ms(library, 5),
                   plain_ms=cuda_ms(lambda: ref.ssd_intra_heads_bwd_ref(
                       *args, q), 5),
                   bound_ms=bound, bound_by=bound_by, kernel=attrs,
                   blocks_per_sm=blocks_per_sm(attrs), items=items,
                   waves=-(-items // (sm_count(torch)
                                      * blocks_per_sm(attrs))))
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit(phase="ssd_bwd_shape", **row)
        rows.append(row)
        del args, x, dt, dac, bm, cm, dy, leaves, y_, dyg, sm_, seg_
        torch.cuda.empty_cache()
    return rows, worst


def zero_counts(kernels):
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches.clear()


def read_counts(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


def read_routes(kernels):
    """block_matmul's launches by route since ``zero_counts``."""
    bm = next(fn for fn in kernels if fn.__name__ == "block_matmul")
    return dict(bm.route_launches)


# mamba2-130m's block_matmul routes: in_dt (N = 24) and, in the decode
# step, every GEMM (M = 4) run the WMMA loop; the rest the Hopper loop
MAMBA_FWD_ROUTES = {"sm90": 3 * MAMBA_LAYERS + 1, "wmma": MAMBA_LAYERS}


@contextmanager
def plain_ssd(ref):
    """The model with the SSD term's plain forward and backward
    (``ref.ssd_intra_heads_ref``, ``ref.ssd_intra_heads_bwd_ref``) in place
    of the two kernels: the module attributes that
    ``ops.ssd_intra_heads``'s autograd Function calls, and the only
    difference from the kernels' forward and step."""
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import ssd_chunk_bwd as SSDB
    saved = SSD.ssd_intra_heads, SSDB.ssd_intra_heads_bwd
    SSD.ssd_intra_heads = ref.ssd_intra_heads_ref
    SSDB.ssd_intra_heads_bwd = ref.ssd_intra_heads_bwd_ref
    try:
        yield
    finally:
        SSD.ssd_intra_heads, SSDB.ssd_intra_heads_bwd = saved


@contextmanager
def timed_ssd(torch, ops, spans):
    """Record a CUDA event pair around every call of ``ops.ssd_intra_heads``
    (the intra term's launch inside a forward) into ``spans``."""
    real = ops.ssd_intra_heads

    def timed(*args):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        y = real(*args)
        b.record()
        spans.append((a, b))
        return y
    ops.ssd_intra_heads = timed
    try:
        yield
    finally:
        ops.ssd_intra_heads = real


def mamba_setup(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import JigsawConfig
    from repro_torch.models import registry as M
    cfg = get_config("mamba2-130m")
    # the reference's one-device engine runs scheme="none"
    jcfg = JigsawConfig(scheme="none", kernel="pallas")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit(phase="mamba_setup", params=cfg.param_count(),
         param_dtype=cfg.param_dtype, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab_padded=cfg.vocab_padded,
         init_s=time.perf_counter() - t0)
    return cfg, jcfg, params


def token_rows(torch, cfg, seq, batch, step):
    from repro_torch.data.tokens import TokenDataConfig, TokenDataset
    rows = TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]
    return torch.from_numpy(rows).cuda()


def mean_rel(a, b):
    return float((a - b).abs().mean() / b.abs().mean())


def mamba_f32(torch, cfg, params):
    """The same weights in f32, and the config that runs them so (every
    GEMM then runs the kernel's exact f32 FMA variant)."""
    from repro_torch.core import tree as ptree
    return (cfg.replace(param_dtype="float32", compute_dtype="float32"),
            ptree.map(lambda t: t.float(), params))


def mamba_forward_phase(torch, kernels, ops, ref, cfg, jcfg, params):
    from repro_torch.models import registry as M
    batch = {"tokens": token_rows(torch, cfg, MAMBA_SEQ, MAMBA_BATCH, 0)}
    cfg32, params32 = mamba_f32(torch, cfg, params)
    with torch.no_grad():
        # -- the main path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        logits, _ = M.apply(params, batch, cfg, jcfg)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        routes = read_routes(kernels)
        ssd_routes = dict(next(fn for fn in kernels if fn.__name__
                               == "ssd_intra_chunk").route_launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # ------------------------------------------------------------------
        check(routes == MAMBA_FWD_ROUTES, f"mamba forward block_matmul "
              f"routes {routes}, want {MAMBA_FWD_ROUTES}")
        check(ssd_routes == {"heads.tma": MAMBA_LAYERS},
              f"mamba forward ssd routes {ssd_routes}, want "
              f"{MAMBA_LAYERS} heads-entry launches on the TMA route")
        check(launches["ssd_intra_chunk"] == MAMBA_LAYERS
              and launches["block_matmul"] == 4 * MAMBA_LAYERS + 1,
              f"mamba forward launches {launches} (want {MAMBA_LAYERS} ssd, "
              f"{4 * MAMBA_LAYERS + 1} block_matmul)")
        check(tuple(logits.shape) == (MAMBA_BATCH, MAMBA_SEQ,
                                      cfg.vocab_padded)
              and bool(torch.isfinite(logits).all()),
              f"mamba logits {tuple(logits.shape)} not finite or misshapen")
        ms = cuda_ms(lambda: M.apply(params, batch, cfg, jcfg), 3)
        # the intra term's launches inside one more forward
        spans = []
        with timed_ssd(torch, ops, spans):
            M.apply(params, batch, cfg, jcfg)
        torch.cuda.synchronize()
        ssd_ms = sum(a.elapsed_time(b) for a, b in spans)

        # f32: the kernel forward against the plain SSD term (the only
        # difference) and against kernel="xla"; bf16 against f32
        ref32, _ = M.apply(params32, batch, cfg32, jcfg)
        bf16_err = mean_rel(logits.float(), ref32)
        bf16_top1 = float((logits.float().argmax(-1)
                           == ref32.argmax(-1)).float().mean())
        del logits
        with plain_ssd(ref):
            plain, _ = M.apply(params32, batch, cfg32, jcfg)
        ssd_err = rel_err(ref32, plain)
        del plain
        xla, _ = M.apply(params32, batch, cfg32, jcfg.replace(kernel="xla"))
        xla_err = rel_err(ref32, xla)
        del xla, ref32
        check(ssd_err <= MAMBA_F32_TOL,
              f"mamba f32 logits, ssd kernel vs plain: {ssd_err:.3e}")
        check(xla_err <= MAMBA_F32_TOL,
              f"mamba f32 logits, pallas vs xla: {xla_err:.3e}")
        check(bf16_err <= MAMBA_BF16_TOL,
              f"mamba bf16 logits vs f32: {bf16_err:.3e} of the mean")
        ms32 = cuda_ms(lambda: M.apply(params32, batch, cfg32, jcfg), 2)
        # the same f32 forward with every GEMM a cuBLAS call (TF32 off)
        xla_ms32 = cuda_ms(lambda: M.apply(params32, batch, cfg32,
                                           jcfg.replace(kernel="xla")), 2)
    torch.cuda.empty_cache()
    tokens = MAMBA_SEQ * MAMBA_BATCH
    emit(phase="mamba_forward", seq=MAMBA_SEQ, batch=MAMBA_BATCH,
         launches=launches, block_matmul_routes=routes,
         ssd_routes=ssd_routes, ms_per_forward=ms,
         tokens_per_s=tokens / (ms / 1e3), ssd_ms_in_forward=ssd_ms,
         peak_mem_gb=peak_gb,
         f32_ms_per_forward=ms32, f32_xla_ms_per_forward=xla_ms32,
         f32_vs_plain_ssd=ssd_err, f32_vs_xla=xla_err, tol_f32=MAMBA_F32_TOL,
         bf16_vs_f32_mean=bf16_err, tol_bf16_mean=MAMBA_BF16_TOL,
         bf16_vs_f32_top1_agree=bf16_top1)
    return launches, ssd_routes, ssd_ms


def decode_logits(torch, M, params, prompts, cfg, jcfg, cache_dtype):
    """Token-wise logits at every prompt position, from a fresh cache."""
    cache = M.init_cache(cfg, prompts.shape[0], prompts.shape[1],
                         dtype=cache_dtype, device="cuda")
    got = []
    for t in range(prompts.shape[1]):
        logits, cache = M.decode_step(params, cache, prompts[:, t:t + 1],
                                      cfg, jcfg)
        got.append(logits[:, 0])
    return torch.stack(got, 1), cache


def decode_step_times(torch, fn, reps=10):
    """A decode step's device ms (CUDA events over ``reps``) and host wall
    ms (each step synchronised)."""
    dev = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return dev, 1e3 * (time.perf_counter() - t0) / reps


def mamba_generate_phase(torch, kernels, cfg, jcfg, params):
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    prompts = token_rows(torch, cfg, GEN_PROMPT, GEN_BATCH, 1)
    max_len = GEN_PROMPT + GEN_STEPS
    # the decode step's graph, captured before the counted run (its eager
    # warm-up step launches too)
    t0 = time.perf_counter()
    S.graph_serve_step(params, cfg, jcfg, M.init_cache(
        cfg, GEN_BATCH, max_len, dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    out = S.generate(params, prompts, cfg, jcfg, steps=GEN_STEPS,
                     max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    routes = read_routes(kernels)
    # ----------------------------------------------------------------------
    zero_counts(kernels)
    t0 = time.perf_counter()
    out_eager = S.generate(params, prompts, cfg, jcfg, steps=GEN_STEPS,
                           max_len=max_len, graph=False)
    torch.cuda.synchronize()
    wall_eager = time.perf_counter() - t0
    launches_eager = read_counts(kernels)
    n_steps = GEN_PROMPT + GEN_STEPS - 1      # token-wise prefill + decode
    per_step = 4 * MAMBA_LAYERS + 1
    check(routes == {"wmma": launches["block_matmul"]},
          f"generate's block_matmul routes {routes}: M = {GEN_BATCH} takes "
          "the WMMA loop")
    for mode, n in (("graphed", launches), ("eager", launches_eager)):
        check(n["ssd_intra_chunk"] == 0,
              f"{n['ssd_intra_chunk']} ssd launches on the {mode} decode "
              "path")
        check(n["block_matmul"] == n_steps * per_step,
              f"{mode} generate launches {n} (want {per_step} block_matmul "
              f"per step, {n_steps} steps)")
    check(tuple(out.shape) == (GEN_BATCH, GEN_STEPS)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"generated tokens {tuple(out.shape)} out of range")
    check(torch.equal(out, out_eager), "generate: the graphed tokens "
          f"{out[0, :8].tolist()} differ from the eager ones "
          f"{out_eager[0, :8].tolist()}")
    cfg32, params32 = mamba_f32(torch, cfg, params)
    with torch.no_grad():
        # decode consistency: token-wise logits at every prompt position
        # against the teacher-forced forward (the kernel path), judged in
        # f32 and printed in bf16
        want32, _ = M.apply(params32, {"tokens": prompts}, cfg32, jcfg)
        got32, _ = decode_logits(torch, M, params32, prompts, cfg32, jcfg,
                                 torch.float32)
        err32 = (got32 - want32).abs()
        decode_ok = bool((err32 <= MAMBA_DECODE_TOL
                          + MAMBA_DECODE_TOL * want32.abs()).all())
        want, _ = M.apply(params, {"tokens": prompts}, cfg, jcfg)
        got, cache = decode_logits(torch, M, params, prompts, cfg, jcfg,
                                   torch.bfloat16)
        bf16_abs = float((got.float() - want.float()).abs().max())
        bf16_mean = mean_rel(got.float(), want.float())
        check(decode_ok, f"mamba f32 decode vs teacher-forced: max abs "
                         f"{float(err32.max()):.3e}")
        step = S.make_serve_step(cfg, jcfg)
        nxt = out[:, -1:]
        eager_ms = decode_step_times(torch, lambda: step(params, cache, nxt))
        g = S.graph_serve_step(params, cfg, jcfg, cache)
        g.tokens_in.copy_(nxt)
        graph_ms = decode_step_times(torch, g.replay)
    S.clear_graphs()
    emit(phase="mamba_generate", batch=GEN_BATCH, prompt=GEN_PROMPT,
         new_tokens=GEN_STEPS, launches=launches,
         launches_eager=launches_eager, block_matmul_routes=routes,
         block_matmul_per_step=launches["block_matmul"] / n_steps,
         graphed_equals_eager=True, capture_s=capture_s,
         wall_s=wall, wall_s_eager=wall_eager,
         host_ms_per_step=1e3 * wall / n_steps,
         host_ms_per_step_eager=1e3 * wall_eager / n_steps,
         device_ms_per_decode_step=graph_ms[0],
         host_ms_per_decode_step=graph_ms[1],
         device_ms_per_decode_step_eager=eager_ms[0],
         host_ms_per_decode_step_eager=eager_ms[1],
         f32_decode_max_abs_err=float(err32.max()), tol=MAMBA_DECODE_TOL,
         bf16_decode_max_abs_err=bf16_abs, bf16_decode_mean_rel=bf16_mean,
         first_tokens=out[0, :8].tolist())
    return {k: launches[k] + launches_eager[k] for k in launches}, \
        launches, launches_eager


# ---------------------------------------------------------------------------
# phases 3 and 4: the served model
# ---------------------------------------------------------------------------

def perturb_(params, torch, seed=1):
    """Move biases, LayerNorm parameters and the blend off their init
    values (in place), so the epilogue's bias path and the blend matter."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key in ("b", "bias", "scale", "blend"):
            noise = 0.1 * torch.randn(node.shape, generator=gen,
                                      device=node.device)
            node.add_(noise.to(node.dtype))

    walk(params)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def sha(a):
    """SHA-256 (16 hex digits) of an array's bytes."""
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


# (sample, lead) of the served requests: samples cycle 0,1,2 and leads
# 3,1,2; the first runs alone for one step, the rest join it mid-rollout
SERVE_PLAN = [(i % 3, (i + 2) % 3 + 1) for i in range(7)]
SERVE_BUCKETS = (1, 2, 4)


def serve_requests(eng, fields):
    """SERVE_PLAN through ``eng`` (rank 0 of a mesh too): the first request
    alone for one step, the rest joining it; returns the requests."""
    s, lead = SERVE_PLAN[0]
    reqs = [eng.submit(fields[s], lead)]
    check(eng.step_once() == "step", "first step did not run")
    reqs += [eng.submit(fields[s], lead) for s, lead in SERVE_PLAN[1:]]
    eng.drain()
    return reqs


def serve_hashes(reqs):
    """[{lead: sha}] of every request's outputs, in submit order."""
    return [{str(k): sha(v) for k, v in sorted(r.outputs.items())}
            for r in reqs]


def step_times(torch, eng, fields, reps=3):
    """Per bucket: a step's device ms (CUDA events over ``reps`` steps),
    its host wall ms (each step synchronised), and ms per request-step, on
    the bucket's buffer filled with the samples."""
    import numpy as np
    out = {}
    for b in SERVE_BUCKETS:
        eng._form(b)
        eng._state.copy_(torch.from_numpy(np.stack(
            [fields[i % len(fields)] for i in range(b)])))
        dev = cuda_ms(eng._step, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng._step()
            torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0) / reps
        out[b] = dict(device_ms=dev, host_ms=host,
                      ms_per_request_step=dev / b)
    eng._state.zero_()
    return out


def serve_phase(torch, BM, handoff):
    """Forecast serving at full width under the bf16 policy: the seven
    requests of SERVE_PLAN through the engine's per-bucket CUDA graphs
    (captured by ``warmup()``), then through an eager engine
    (``graphs=False``) on the same weights; the samples and the graphed
    outputs' hashes go to ``handoff`` for ``serve_data``."""
    import numpy as np
    from repro_torch.data.weather import WeatherDataConfig, WeatherDataset
    from repro_torch.models import registry as M
    from repro_torch.serve.engine import ForecastEngine, ServeConfig

    t0 = time.perf_counter()
    scfg = ServeConfig(buckets=SERVE_BUCKETS, precision="bf16", seed=0)
    eng = ForecastEngine("weathermixer-1b", reduced=False, device="cuda",
                         config=scfg)
    perturb_(eng.params, torch)
    cfg = eng.cfg
    ds = WeatherDataset(WeatherDataConfig(lat=cfg.wm_lat, lon=cfg.wm_lon,
                                          channels=cfg.wm_channels, seed=0))
    n_samples = 3
    with ThreadPoolExecutor(n_samples) as pool:
        fields = list(pool.map(lambda i: ds.sample_fields(i, 1)[0],
                               range(n_samples)))
    setup_s = time.perf_counter() - t0
    warm = eng.warmup()
    check(eng.graphs and sorted(eng._graphs) == list(SERVE_BUCKETS)
          and all(g.launches_of() == 14 for g in eng._graphs.values()),
          f"serve: graphs {sorted(eng._graphs)} with block_matmul launches "
          f"{[g.launches_of() for g in eng._graphs.values()]} (want one "
          "per bucket, 14 each)")
    eager = ForecastEngine("weathermixer-1b", reduced=False, device="cuda",
                           params=eng.params,
                           config=scfg.replace(graphs=False))
    check(eager.params["encoder"]["w"] is eng.params["encoder"]["w"],
          "serve: the eager engine does not share the weights")
    warm_eager = eager.warmup()
    emit(phase="serve_setup", params=cfg.param_count(),
         param_dtype=cfg.param_dtype, field_shape=list(eng.field_shape),
         setup_s=setup_s, warmup_s=eng.stats["warmup_s"],
         warm_setups=warm, graphs_captured=len(eng._graphs),
         graph_pool_bytes=eng.stats["graph_pool_bytes"],
         eager_warmup_s=eager.stats["warmup_s"])

    runs = {}
    for mode, e in (("graphed", eng), ("eager", eager)):
        # -- the main path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        BM.block_matmul.launches = 0
        steps0 = e.stats["device_steps"]
        t_start = time.perf_counter()
        reqs = serve_requests(e, fields)
        wall = time.perf_counter() - t_start
        launches = BM.block_matmul.launches
        steps = e.stats["device_steps"] - steps0
        # ------------------------------------------------------------------
        runs[mode] = dict(reqs=reqs, wall=wall, launches=launches,
                          steps=steps,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          reserved_gb=torch.cuda.memory_reserved() / 1e9)
        check(all(r.done() for r in reqs), f"serve {mode}: not every "
              "request was delivered")
        check(launches == 14 * steps, f"serve {mode}: {launches} kernel "
              f"launches for {steps} device steps (want 14 per step)")
        check(e.sched.counters["grown"] >= 1, f"serve {mode}: no request "
              "joined mid-rollout")
        for r in reqs:
            for lead, out in r.outputs.items():
                check(out.shape == eng.field_shape and bool(
                    torch.isfinite(torch.from_numpy(out)).all()),
                    f"serve {mode}: request {r.rid} lead {lead}: bad output")
    check(eng.stats["compiles"] == warm, "serve: graphs or buffers set up "
          f"after warmup ({eng.stats['compiles']} setups, {warm} at warmup)")
    check(eager.stats["compiles"] == warm_eager, "serve eager: set up "
          "after warmup")
    reqs = runs["graphed"]["reqs"]
    hashes = serve_hashes(reqs)
    check(hashes == serve_hashes(runs["eager"]["reqs"]),
          "serve: the graphed outputs differ from the eager ones")

    # every request (all but the first admitted mid-rollout, the first
    # carried through two grows) against its solo bucket-1 rollout, bitwise
    def solo(f, lead):
        state = torch.from_numpy(f)[None].to("cuda")
        for _ in range(lead):
            state = eng._forecast(state)
        return state[0].cpu().numpy()

    mismatched = [r.rid for r in reqs
                  if not np.array_equal(r.result(), solo(r.fields,
                                                         r.max_lead))]
    check(not mismatched, f"mid-rollout requests {mismatched} differ from "
          "their solo rollouts")

    # one lead-1 forecast against the plain forecast step (kernel="xla")
    lead1 = next(r for r in reqs if 1 in r.outputs)
    x = torch.from_numpy(lead1.fields)[None].to("cuda")
    with torch.no_grad():
        plain = M.forecast_step(eng.params, x, cfg,
                                eng.jcfg.replace(kernel="xla"))[0]
    step_err = rel_err(torch.from_numpy(lead1.output(1)).cuda(), plain)
    check(step_err <= STEP_TOL["bf16"],
          f"bf16 forecast step vs plain: {step_err:.3e}")

    # a step's time at each bucket, graphed and eager
    times = {mode: step_times(torch, e, fields)
             for mode, e in (("graphed", eng), ("eager", eager))}
    np.save(handoff / "fields.npy", np.stack(fields))
    (handoff / "serve.json").write_text(json.dumps(dict(
        plan=SERVE_PLAN, hashes=hashes, steps=runs["graphed"]["steps"])))
    s = eng.summary(reqs)
    emit(phase="serve", requests=len(reqs),
         device_steps=runs["graphed"]["steps"],
         kernel_launches={m: r["launches"] for m, r in runs.items()},
         launches_per_step=runs["graphed"]["launches"]
         / runs["graphed"]["steps"],
         wall_s={m: r["wall"] for m, r in runs.items()},
         req_per_s={m: len(reqs) / r["wall"] for m, r in runs.items()},
         p50_s=s["p50_s"], p95_s=s["p95_s"], formed=s["formed"],
         grown=s["grown"], compiles_after_warmup=s["compiles"] - warm,
         graphed_equals_eager_bitwise=True,
         step_span_mean_s=eng.tracer.span_summary()["serve.step"]["mean_s"],
         step_span_mean_s_eager=eager.tracer.span_summary()[
             "serve.step"]["mean_s"],
         step_ms_by_mode_and_bucket=times,
         ms_per_request_step_bucket4=times["graphed"][4]["device_ms"] / 4,
         bound_ms_per_request_step=1e3 * gemm_flops_per_request(cfg)
         / PEAK_FLOPS["bfloat16"],
         graph_pool_bytes=eng.stats["graph_pool_bytes"],
         peak_mem_gb={m: r["peak_gb"] for m, r in runs.items()},
         reserved_gb={m: r["reserved_gb"] for m, r in runs.items()},
         midrollout_bitwise=True,
         step_vs_plain_rel_err=step_err, step_tol=STEP_TOL["bf16"])
    del eager
    torch.cuda.empty_cache()
    return eng, fields, {m: r["launches"] for m, r in runs.items()}


def serve_data_phase(torch, handoff, ck, restore_sha, card):
    """``ForecastEngine(mesh_data=2)``: this file re-run as two rank
    processes sharing the card (``--serve-data-rank``, gloo between them),
    each with the whole weathermixer-1b under bf16, rebuilt from seed 0 and
    the same ``perturb_(seed=1)`` as the serve phase (no weights handed
    over; the samples are).  Rank 0 serves SERVE_PLAN (bucket 1 whole on
    both ranks, buckets 2 and 4 split) and its outputs must be the serve
    phase's bit for bit; then both ranks restore the 2x2 mesh's checkpoint
    ``ck`` (``ForecastEngine(ckpt=, mesh_data=2)``), whose lead-1 forecast
    must be the one-device restore's (``restore_sha``) bit for bit."""
    meta = json.loads((handoff / "serve.json").read_text())
    meta.update(ckpt=str(ck), restore_sha=restore_sha)
    (handoff / "serve_data.json").write_text(json.dumps(meta))
    res, wall = run_ranks("--serve-data-rank", handoff, 2)
    r0 = res[0]
    check(r0["hashes"] == meta["hashes"], "serve_data: rank 0's outputs "
          "differ from the one-device engine's")
    check(r0["restore_sha"] == restore_sha,
          "serve_data: the 2x2 checkpoint's lead-1 forecast on two ranks "
          "differs from the one-device restore's")
    for r, x in enumerate(res):
        check(x["compiles_after_warmup"] == 0, f"serve_data rank {r} set "
              "something up after warmup")
        check(x["launches"] == 14 * x["device_steps"]
              and x["device_steps"] == meta["steps"],
              f"serve_data rank {r}: {x['launches']} launches in "
              f"{x['device_steps']} steps (want 14 a step, "
              f"{meta['steps']} steps)")
        check(x["graphs"] == 3, f"serve_data rank {r}: {x['graphs']} graphs")

    def per(what):
        n = r0["through_host"].get(f"{what}/serve", 0)
        return r0["through_host_bytes"].get(f"{what}/serve", 0) / n \
            if n else 0
    stats = dict(ranks=2, card=card, requests=len(meta["plan"]),
                 device_steps=r0["device_steps"],
                 launches_per_rank=[x["launches"] for x in res],
                 bitwise_one_device=True, restore_bitwise_one_device=True,
                 rows_per_rank={"1": 1, "2": 1, "4": 2},
                 step_ms_per_rank=[x["step_ms"] for x in res],
                 wall_s_per_rank=[x["serve_s"] for x in res],
                 through_host=[x["through_host"] for x in res],
                 through_host_bytes=[x["through_host_bytes"] for x in res],
                 bytes_per_admit_rank0=per("admit"),
                 bytes_per_peel_rank0=per("peel"),
                 graph_pool_bytes=[x["graph_pool_bytes"] for x in res],
                 peak_mem_gb=[x["peak_mem_gb"] for x in res],
                 setup_s=[x["setup_s"] for x in res],
                 restore_s_per_rank=[x["restore_s"] for x in res],
                 wall_s=wall)
    emit(phase="serve_data", **stats)
    return stats


def serve_data_worker(rank, tmp):
    """One rank of ``serve_data_phase`` (this file run with
    ``--serve-data-rank``); results to rank<r>.json."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core import comm
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.serve.engine import ForecastEngine, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    meta = json.loads((tmp / "serve_data.json").read_text())
    t0 = time.perf_counter()
    eng = ForecastEngine("weathermixer-1b", reduced=False, device="cuda",
                         mesh_data=2, config=ServeConfig(
                             buckets=SERVE_BUCKETS, precision="bf16",
                             seed=0))
    perturb_(eng.params, torch)
    warm = eng.warmup()
    out = dict(setup_s=time.perf_counter() - t0, graphs=len(eng._graphs),
               graph_pool_bytes=eng.stats["graph_pool_bytes"])
    fields = np.load(tmp / "fields.npy") if rank == 0 else None
    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    comm.through_host.clear()
    comm.through_host_bytes.clear()
    t0 = time.perf_counter()
    if rank == 0:
        reqs = serve_requests(eng, fields)
        eng.close()
        out["hashes"] = serve_hashes(reqs)
    else:
        eng.serve_worker()
    torch.cuda.synchronize()
    out.update(serve_s=time.perf_counter() - t0,
               launches=BM.block_matmul.launches,
               device_steps=eng.stats["device_steps"],
               compiles_after_warmup=eng.stats["compiles"] - warm,
               step_ms=1e3 * eng.tracer.span_summary()["serve.step"][
                   "mean_s"],
               through_host=dict(comm.through_host),
               through_host_bytes=dict(comm.through_host_bytes),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    # ----------------------------------------------------------------------
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = ForecastEngine("weathermixer-1b", reduced=False, device="cuda",
                            ckpt=meta["ckpt"], mesh_data=2,
                            config=ServeConfig(buckets=(1,),
                                               precision="bf16", seed=0))
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    served.warmup()
    if rank == 0:
        x = np.random.default_rng(0).standard_normal(
            served.field_shape, dtype=np.float32)
        r = served.submit(x, 1)
        served.drain()
        served.close()
        out["restore_sha"] = sha(r.outputs[1])
    else:
        served.serve_worker()
        out["restore_sha"] = None
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def gemm_flops_per_request(cfg):
    """2*M*N*K summed over the GEMMs of one forecast step, one request."""
    t = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    d, pd = cfg.d_model, cfg.wm_patch ** 2 * cfg.wm_channels
    per_block = 2 * (d * cfg.wm_d_tok * t) + 2 * (t * cfg.wm_d_ch * d)
    return 2.0 * (2 * t * pd * d + cfg.n_layers * per_block)


def legacy_phase(torch, BM, eng, fields):
    """The legacy path (what ``launch/serve.py`` runs without
    ``--precision``: bf16 weights, f32 activations, 14 f32 kernel launches
    a step) for one step against the plain step; then the device time of a
    step, of the plain step (its GEMMs cuBLAS f32 calls), of the step's 14
    kernel launches alone at its shapes and of the same 14 products by
    torch.matmul in f32 (TF32 off), beside the f32 bound of its GEMMs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.models import registry as M

    cfg = get_config("weathermixer-1b").replace(scheme="none", impl="rs")
    jcfg = jigsaw_for(cfg)
    check(jcfg.compute_dtype is None and cfg.param_dtype == "bfloat16",
          "legacy config is not bf16 weights / f32 activations")
    x = torch.from_numpy(fields[0])[None].to("cuda")
    BM.block_matmul.launches = 0
    with torch.no_grad():
        out = M.forecast_step(eng.params, x, cfg, jcfg)
        torch.cuda.synchronize()
        launches = BM.block_matmul.launches
        plain = M.forecast_step(eng.params, x, cfg,
                                jcfg.replace(kernel="xla"))
        check(launches == 14, f"legacy step launched the kernel {launches} "
              "times (want 14)")
        check(bool(torch.isfinite(out).all()),
              "legacy step: non-finite output")
        err = rel_err(out, plain)
        check(err <= STEP_TOL["legacy"],
              f"legacy f32 step vs plain: {err:.3e}")
        out_dtype = str(out.dtype)
        del out, plain
        step_ms = cuda_ms(lambda: M.forecast_step(eng.params, x, cfg, jcfg),
                          2)
        plain_ms = cuda_ms(lambda: M.forecast_step(
            eng.params, x, cfg, jcfg.replace(kernel="xla")), 2)
    gen = torch.Generator(device="cuda").manual_seed(8)
    gemm_ms = library_ms = 0.0
    for label, m, k, n, epi, name, per_step, _ in SHAPES:
        if not per_step:
            continue
        a = torch.randn(m, k, generator=gen, device="cuda")
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(torch.bfloat16).float()
        b = 0.1 * torch.randn(n, generator=gen, device="cuda")
        gemm_ms += per_step * cuda_ms(lambda: BM.block_matmul(a, w, b, epi),
                                      3)
        library_ms += per_step * cuda_ms(lambda: torch.matmul(a, w.t()), 3)
        del a, w, b
    torch.cuda.empty_cache()
    row = dict(launches=launches, out_dtype=out_dtype,
               step_vs_plain_rel_err=err, step_tol=STEP_TOL["legacy"],
               step_ms=step_ms, plain_step_ms=plain_ms, gemm_ms=gemm_ms,
               library_ms=library_ms,
               bound_ms=1e3 * gemm_flops_per_request(cfg)
               / PEAK_FLOPS["float32"])
    emit(phase="legacy_f32", **row)
    return row


# ---------------------------------------------------------------------------
# phase 5: the backward GEMMs against their plain versions
# ---------------------------------------------------------------------------

# launches of dx and of dw per training sample-step at rollout 1 (the
# encoder's input is data: no dx)
BWD_COUNTS = {"encoder": (0, 1), "tok_fc1": (3, 3), "tok_fc2": (3, 3),
              "ch_fc1": (3, 3), "ch_fc2": (3, 3), "decoder": (1, 1),
              "tok_fc1_f32": (0, 0)}


def kernel_bwd_phase(torch, BM, SM90, ref):
    """dx = dz @ w (w read as w.T) and dw = dz.T @ x (dz and x read across
    their rows) for each forward shape; dw only for the f32 row."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, worst = [], 0.0
    for label, m, k, n, _, name, *_ in SHAPES:
        dtype = getattr(torch, name)
        x = (torch.randn(m, k, generator=gen, device="cuda")
             / m ** 0.5).to(dtype)
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        dz = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
        n_dx, n_dw = BWD_COUNTS[label]
        cases = [("dw", dz, x, True, (n, k, m), n_dw,
                  lambda: torch.matmul(dz.t(), x))]
        if name == "bfloat16":
            cases.insert(0, ("dx", dz, w, False, (m, k, n), n_dx,
                             lambda: torch.matmul(dz, w)))
        for kind, a, b, x_t, (om, on, ok_), count, library in cases:
            def kernel(a=a, b=b, x_t=x_t):
                return BM.block_matmul(a, b, x_t=x_t, w_t=True)

            def plain(a=a, b=b, x_t=x_t):
                return ref.block_matmul_ref(a, b, x_t=x_t, w_t=True)
            y = kernel()
            torch.cuda.synchronize()
            err, ok = gemm_errors(y, plain(), name)
            check(ok, f"{label}.{kind} {(om, on, ok_)} {name}: max err "
                      f"{err:.3e}")
            worst = max(worst, err)
            bound, bound_by = gemm_bound_ms(om, on, ok_, name, False)
            row = dict(shape=f"{label}.{kind}", m=om, n=on, k=ok_,
                       dtype=name, x_t=x_t, w_t=True, per_train_step=count,
                       **bm_route_fields(torch, BM, SM90, a, b, om, on, ok_,
                                         "none", x_t, True),
                       max_abs_err=err, tol=GEMM_TOL[name],
                       kernel_ms=cuda_ms(kernel), library_ms=cuda_ms(library),
                       plain_ms=cuda_ms(plain, 3), bound_ms=bound,
                       bound_by=bound_by)
            if row["route"] == "sm90":
                row["wmma_ms"] = check_routes_agree(
                    torch, BM, y, (a, b), dict(x_t=x_t, w_t=True),
                    f"{label}.{kind}")
                row["bitwise_wmma"] = True
            row["tflops"] = 2e-9 * om * on * ok_ / row["kernel_ms"]
            emit(phase="kernel_bwd_shape", **row)
            rows.append(row)
            del y
        del x, w, dz
        torch.cuda.empty_cache()
    return rows, worst



# ---------------------------------------------------------------------------
# phase 6: the wx kernel against its plain version
# ---------------------------------------------------------------------------

# the token-mix Cannon steps at full width: (label, m, t, c) of w [m, t] @
# x [L, t, c], and the launches of one 2-D training sample-step at r = 1
# (3 blocks, remat): forward-layout launches (forward and rerun, one per
# Cannon step), dx launches.  q = 1 is this card's path; the 2x2 rank
# blocks are what each rank of a four-card mesh runs (q = 2 steps each).
WX_SHAPES = [("q1.tok_fc1", 8640, 16380, 4320, (6, 3)),
             ("q1.tok_fc2", 16380, 8640, 4320, (6, 3)),
             ("2x2.tok_fc1", 4320, 8190, 2160, (12, 6)),
             ("2x2.tok_fc2", 8190, 4320, 2160, (12, 6))]
# wx's output is f32 under both operand types, and bf16 products are exact
# in f32, so plain and kernel differ only in summation order (max 1.2e-4
# at these shapes): a kernel that rounds its accumulator, a or its output
# to bf16 (up to 1.6e-2 at |v| 4-8) must fail.  dx (bf16 w, f32 dy split
# into bf16 terms, every product exact in f32) 1e-4 likewise.
WX_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# dx against a float64 oracle, max|dx - oracle| / max|oracle|: f32
# accumulation of exact products over K <= 16,380 terms errs ~1e-5 of the
# max at most; a dx that dropped the second and third terms of an inexact
# dy would err by bf16's rounding of dy, ~1e-3 of the max
WX_DX_F64_TOL = 1e-4


def wx_bound_ms(ll, m, n, k, x_bytes, out_bytes, terms=1):
    """Least time of one wx launch: ``terms`` bf16 products [m, k] @ [k, n]
    per batch element over the bf16 peak, or the bytes (w in bf16 once, x
    at ``x_bytes`` an element, each [m, n] output element ``out_bytes``:
    written, plus the accumulator read where there is one) over the memory
    rate."""
    flops = 2.0 * terms * ll * m * n * k
    nbytes = 2 * m * k + x_bytes * ll * k * n + out_bytes * ll * m * n
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def wx_phase(torch, WX, SM90, ref):
    """Per shape and batch: the forward a + w @ x[l] in bf16 (the Cannon
    step) against ref.wx_ref; and dx = w.T @ dy[l] from the bf16 w (read
    across its rows) and an f32 dy, twice: dy the f32 image of a bf16
    cotangent (the 2-D path's: one term) and an inexact dy (three terms),
    each against ref.wx_ref, a float64 oracle and the term count the card
    recorded.  Timed beside the plain version, the library (torch.matmul(w,
    x) + a: cuBLAS bf16, rounded to bf16, then the f32 add; for dx
    torch.matmul(w.float().t(), dy), cuBLAS f32, TF32 off), the f32 FMA
    kernel that took dx before (``fma_ms``), the split pass alone and the
    per-call padding of w; each row names the operands' load paths, the
    kernel's registers, spills and shared bytes, its tiles and waves."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, worst = [], 0.0
    sms = sm_count(torch)
    for label, m, t, c, (n_fwd, n_dx) in WX_SHAPES:
        w = (torch.randn(m, t, generator=gen, device="cuda")
             / t ** 0.5).to(torch.bfloat16)
        w32 = w.float()
        pad_ms = (cuda_ms(lambda: SM90.pad_rows(w))
                  if SM90.pad_rows(w) is not w else 0.0)
        for ll in (1, 2):
            x = torch.randn(ll, t, c, generator=gen,
                            device="cuda").to(torch.bfloat16)
            a = torch.randn(ll, m, c, generator=gen, device="cuda")
            dy3 = torch.randn(ll, m, c, generator=gen, device="cuda")
            dy1 = dy3.to(torch.bfloat16).float()
            cases = [("fwd", None, (m, c, t), n_fwd,
                      lambda: WX.wx(w, x, a), lambda: ref.wx_ref(w, x, a),
                      lambda: torch.matmul(w, x) + a)]
            for terms, dy in ((1, dy1), (3, dy3)):
                cases.append((
                    "dx", terms, (t, c, m), n_dx if terms == 1 else 0,
                    lambda dy=dy: WX.wx(w, dy, None, w_t=True),
                    lambda dy=dy: ref.wx_ref(w, dy, None, w_t=True),
                    lambda dy=dy: torch.matmul(w32.t(), dy)))
            for kind, terms, (gm, gn, gk), count, kernel, plain, lib in cases:
                WX.reset_dx_terms()
                y = kernel()
                torch.cuda.synchronize()
                got_terms = WX.dx_terms()
                r = plain()
                tol = WX_TOL["float32" if kind == "dx" else "bfloat16"]
                what = f"wx {label}.{kind} L={ll}" + (
                    f" {terms} term(s)" if terms else "")
                err = float((y - r).abs().max())
                check(bool(((y - r).abs() <= tol + tol * r.abs()).all()),
                      f"{what}: max err {err:.3e}")
                worst = max(worst, err)
                del r
                row = dict(shape=f"{label}.{kind}", batch=ll, m=gm, n=gn,
                           k=gk, w_t=kind == "dx", per_train_step=count)
                if kind == "dx":
                    want = {1: int(terms == 1), 3: int(terms == 3)}
                    check(got_terms == want, f"{what}: the card's term "
                          f"counts {got_terms}, want {want}")
                    dy = dy1 if terms == 1 else dy3
                    oracle = torch.matmul(w.double().t(), dy.double())
                    f64_err = rel_err(y.double(), oracle)
                    del oracle
                    check(f64_err <= WX_DX_F64_TOL, f"{what}: against the "
                          f"float64 oracle {f64_err:.3e}")
                    bound, bound_by = wx_bound_ms(ll, gm, gn, gk, 4, 4,
                                                  terms)
                    row.update(dtype="bfloat16 w, float32 dy", terms=terms,
                               f64_rel_err=f64_err, f64_tol=WX_DX_F64_TOL,
                               split_ms=cuda_ms(lambda: WX.split_terms(dy)),
                               fma_ms=cuda_ms(lambda: WX.wx(
                                   w32, dy, None, w_t=True), 2),
                               fma_kernel=WX.kernel_attrs("f32", True))
                else:
                    bound, bound_by = wx_bound_ms(ll, gm, gn, gk, 2, 8)
                    row.update(dtype="bfloat16")
                del y
                ops = SM90.tma_operands_wx(ll, gm, gn, gk, kind == "dx")
                tiles = ll * SM90.sm90_tiles(gm, gn)
                grid = SM90.persistent_grid(tiles, False, sms)
                row.update(
                    route="sm90",
                    loads={name: op.describe() for name, op in ops.items()},
                    kernel=WX.kernel_attrs("sm90", kind == "dx"),
                    tiles=tiles, grid=grid, waves=tiles / grid,
                    pad_ms=pad_ms, max_abs_err=err, tol=tol,
                    kernel_ms=cuda_ms(kernel), library_ms=cuda_ms(lib),
                    plain_ms=cuda_ms(plain, 3), bound_ms=bound,
                    bound_by=bound_by)
                row["tflops"] = (2e-9 * (terms or 1) * ll * gm * gn * gk
                                 / row["kernel_ms"])
                emit(phase="wx_shape", **row)
                rows.append(row)
            del x, a, dy1, dy3
            torch.cuda.empty_cache()
        del w, w32
        torch.cuda.empty_cache()
    emit(phase="wx_split", kernel=WX.kernel_attrs("split"))
    return rows, worst

# ---------------------------------------------------------------------------
# phase 7: the ring step kernels against their plain versions
# ---------------------------------------------------------------------------

# the six 1-D linears of weathermixer-1b at batch 1: (label, rows, d, m) of
# x [rows, d] @ w [m, d].T, each rank holding d/p of x's and w's columns;
# forward ring calls per training sample-step at r = 1 (the forward and,
# for the mixing linears, the checkpoint's rerun) and backward calls
RING_SHAPES = [("encoder", _T, _PD, _D, 1, 1),
               ("tok_fc1", _D, _T, 8640, 6, 3),
               ("tok_fc2", _D, 8640, _T, 6, 3),
               ("ch_fc1", _T, _D, 4320, 6, 3),
               ("ch_fc2", _T, 4320, _D, 6, 3),
               ("decoder", _T, _D, _PD, 1, 1)]
RING_PS = (2, 4)
# the forward rounds to the wire dtype at every hop (bf16: a summation
# order other than the plain version's flips some roundings, the GEMM
# bound); dx's f32 accumulator differs from the plain one in order only
RING_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
RING_DX_TOL = 1e-4


def ring_bound_ms(rows, d_l, m, p, dtype_name, bwd, dx=True):
    """Least time of one rank's p launches of a ring call: its GEMM work
    (the forward x [rows, d/p] @ w [m, d/p].T; the backward dw and, with
    ``dx``, dx: twice that) over the peak, or the bytes (x, w and the
    output read or written once, each of the p - 1 hops read and written
    once; the backward also dw and the f32 dx accumulator, read and
    written) over the memory rate."""
    es = 4 if dtype_name == "float32" else 2
    mc = m // p
    flops = 2.0 * rows * m * d_l * (1 + int(bwd and dx))
    hop = rows * mc * es
    nbytes = es * (rows * d_l + m * d_l) + 2 * (p - 1) * hop
    nbytes += (rows * mc * es + es * m * d_l + int(dx) * 8 * rows * d_l
               if bwd else rows * mc * es)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ring_phase(torch, BM, RING, WX, ref, only_serve=False):
    """p ranks held in one process (rank r's destination is rank r+1's
    slot; the order of the launches on one stream is the barrier), at each
    full-width 1-D linear for p = 2 and 4 in bf16, and tok_fc1 at p = 2 in
    f32: the forward bit for bit against the ring of block_matmul's
    products and within RING_TOL of the plain version; dw bit for bit
    against block_matmul's dw of the gathered cotangent; dx's f32
    accumulator within RING_DX_TOL (max-normalised) of the plain one and,
    in bf16, bit for bit the wx step loop that the kernel replaces (acc =
    wx(cur_s, w_j[None], acc): the WMMA loop, the same epilogue); dx that
    accumulator rounded.  Then rank 0's p launches timed, forward and
    backward (with their per-call padding of x and w, and dy, whose time
    the row also gives alone; the backward also with dx off: dw alone),
    beside the plain steps, the library's (torch.matmul chunk products and
    the adds) and the bound; each row names every operand's load path
    (the bf16 TMA plans), each kernel's registers, local and shared bytes,
    and both steps' tiles and waves.  On one card a hop is
    a store into device memory, not an NVLink write.  The decode steps'
    shapes (``LM_SERVE_RING_SHAPES``, M = 4 rows: serving has no
    backward) hold and time the forward alone; ``only_serve`` runs only
    them."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(p, shape, "bfloat16") for p in RING_PS for shape in RING_SHAPES]
    cases.append((2, RING_SHAPES[1], "float32"))
    # h2o-danube-1.8b's ring linears at a rank of lm_1d's two, and
    # mamba2-130m's, phi3.5's and whisper's at a rank of lm_1d_zoo's two
    cases += [(LM_1D_P, shape, "bfloat16") for shape in LM_RING_SHAPES]
    cases += [(ZOO_P, shape, "bfloat16") for shape in ZOO_RING_SHAPES]
    serve = [(SERVE_P, shape, "bfloat16") for shape in LM_SERVE_RING_SHAPES]
    cases = serve if only_serve else cases + serve
    rows_out, worst = [], {"fwd": 0.0, "bwd": 0.0}
    for p, (label, rows, d, m, n_fwd, n_bwd), name in cases:
        dtype = getattr(torch, name)
        dl, mc = d // p, m // p
        xs = [torch.randn(rows, dl, generator=gen, device="cuda").to(dtype)
              for _ in range(p)]
        ws = [(torch.randn(m, dl, generator=gen, device="cuda")
               / d ** 0.5).to(dtype) for _ in range(p)]
        dys = [torch.randn(rows, mc, generator=gen, device="cuda").to(dtype)
               for _ in range(p)]
        outs = RING.ring_fwd_all(xs, ws)
        torch.cuda.synchronize()
        parts = [BM.block_matmul(x, w) for x, w in zip(xs, ws)]
        ring = ref.ring_walk_all(lambda r, j: parts[r][:, j * mc:(j + 1)
                                                       * mc],
                                 p, dtype, torch.float32)
        check(all(torch.equal(a, b) for a, b in zip(outs, ring)),
              f"ring_fwd {label} p={p} {name}: not bit for bit the ring of "
              "block_matmul's products")
        del parts, ring
        plain = ref.ring_fwd_all_ref(xs, ws, torch.float32)
        tol = RING_TOL[name]
        fwd_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(outs, plain))
        check(all(bool(((a.float() - b.float()).abs()
                        <= tol + tol * b.float().abs()).all())
                  for a, b in zip(outs, plain)),
              f"ring_fwd {label} p={p} {name} vs plain: {fwd_err:.3e}")
        del outs, plain
        if not n_bwd:
            # a decode step's other row counts (batch 1 and 8): the same
            # ring of block_matmul's products, bit for bit
            for few in (1, 8):
                xf = [torch.randn(few, dl, generator=gen,
                                  device="cuda").to(dtype) for _ in xs]
                parts = [BM.block_matmul(x, w) for x, w in zip(xf, ws)]
                check(all(torch.equal(a, b) for a, b in zip(
                    RING.ring_fwd_all(xf, ws), ref.ring_walk_all(
                        lambda r, j: parts[r][:, j * mc:(j + 1) * mc], p,
                        dtype, torch.float32))),
                      f"ring_fwd {label} p={p} {name} at {few} rows: not "
                      "bit for bit the ring of block_matmul's products")
                del xf, parts
        dx_err = dx_abs = None
        if n_bwd:
            dxs, dws, accs = RING.ring_bwd_all(xs, ws, dys)
            torch.cuda.synchronize()
            gathered = torch.cat(dys, dim=1)
            check(all(torch.equal(dw, BM.block_matmul(gathered, x, x_t=True,
                                                      w_t=True))
                      for dw, x in zip(dws, xs)),
                  f"ring_bwd {label} p={p} {name}: dw not bit for bit "
                  "block_matmul's")
            check(all(torch.equal(dx, a.to(dtype))
                      for dx, a in zip(dxs, accs)),
                  f"ring_bwd {label} p={p} {name}: dx is not its accumulator "
                  "rounded")
            del gathered, dxs, dws
            _, _, paccs = ref.ring_bwd_all_ref(xs, ws, dys)
            dx_err = max(rel_err(a, b) for a, b in zip(accs, paccs))
            dx_abs = max(float((a - b).abs().max())
                         for a, b in zip(accs, paccs))
            check(dx_err <= RING_DX_TOL,
                  f"ring_bwd {label} p={p} {name}: dx accumulator vs plain "
                  f"{dx_err:.3e}")
            del paccs
            if name == "bfloat16":
                for r in range(p):
                    loop = None
                    for s in range(p):
                        j = (r - s) % p
                        loop = WX.wx(dys[j], ws[r][j * mc:(j + 1) * mc][None],
                                     loop)
                    check(torch.equal(accs[r], loop[0]),
                          f"ring_bwd {label} p={p} {name}: dx accumulator of "
                          f"rank {r} not bit for bit the wx step loop")
                    del loop
            del accs
        torch.cuda.empty_cache()
        worst["fwd"] = max(worst["fwd"], fwd_err)
        if n_bwd:
            worst["bwd"] = max(worst["bwd"], dx_abs)

        # rank 0's p launches of one ring call, as the ring runs them
        x, w, dy = xs[0], ws[0], dys[0]
        slots = [torch.empty(rows, mc, dtype=dtype, device="cuda")
                 for _ in range(2)]
        out = torch.empty(rows, mc, dtype=dtype, device="cuda")
        acc = torch.empty(rows, dl, dtype=torch.float32, device="cuda")
        dx = torch.empty(rows, dl, dtype=dtype, device="cuda")
        dw = torch.empty(m, dl, dtype=dtype, device="cuda")
        need_dx = label != "encoder"        # the encoder's input is data

        def fwd_kernel():
            # as fused_ring._card_forward: x and w padded once per call
            xp, wp = RING.pad_rows(x), RING.pad_rows(w)
            for s in range(p):
                RING.ring_fwd(xp, wp, (-1 - s) % p,
                              None if s == 0 else slots[(s - 1) % 2],
                              out if s == p - 1 else slots[s % 2])

        def fwd_plain():
            y = None
            for s in range(p):
                j = (-1 - s) % p
                y = ref.ring_fwd_step_ref(x, w[j * mc:(j + 1) * mc], y,
                                          torch.float32)
            return y

        def fwd_library():
            y = None
            for s in range(p):
                j = (-1 - s) % p
                z = torch.matmul(x, w[j * mc:(j + 1) * mc].t())
                y = z if y is None else (y.float() + z.float()).to(dtype)
            return y

        bwd_slots = [RING.empty_rows_like(RING.pad_rows(dy))
                     for _ in range(2)]

        def bwd_kernel(with_dx=need_dx):
            # as fused_ring._card_backward: x, w and dy padded once per call
            xp, wp, dyp = (RING.pad_rows(t) for t in (x, w, dy))
            for s in range(p):
                RING.ring_bwd(xp, wp, (-s) % p,
                              dyp if s == 0 else bwd_slots[(s - 1) % 2],
                              bwd_slots[s % 2] if s < p - 1 else None, dw,
                              acc if with_dx else None,
                              dx if with_dx else None, first=s == 0,
                              last=s == p - 1)

        def bwd_plain():
            a = None
            for s in range(p):
                j = (-s) % p
                dw[j * mc:(j + 1) * mc], a = ref.ring_bwd_step_ref(
                    x, w[j * mc:(j + 1) * mc], dy, a)
            return a

        def bwd_library():
            for s in range(p):
                j = (-s) % p
                dw[j * mc:(j + 1) * mc] = torch.matmul(dy.t(), x)
                if need_dx:
                    z = torch.matmul(dy, w[j * mc:(j + 1) * mc]).float()
                    acc.copy_(z) if s == 0 else acc.add_(z)

        bf16 = name == "bfloat16"
        sms = sm_count(torch)
        n_dw, n_dx = RING.ring_bwd_tiles(rows, dl, mc, need_dx)
        grid = RING.persistent_grid(n_dw + n_dx, p > 1, sms)
        if bf16:
            # both steps read through TMA, each operand at its own stride
            fwd_tiles = RING.sm90_tiles(rows, mc)
            fwd_grid = RING.persistent_grid(fwd_tiles, False, sms)
            fwd_loads = {k: op.describe() for k, op in
                         RING.tma_operands_ring_fwd(rows, dl, mc).items()}
            bwd_loads = {k: op.describe() for k, op in
                         RING.tma_operands_ring_bwd(rows, dl, mc,
                                                    need_dx).items()}
        else:
            # one [128 x 128] tile a block, blocks_per_sm of them at once
            fwd_tiles = -(-rows // 128) * -(-mc // 128)
            fwd_grid = blocks_per_sm(RING.kernel_attrs(3)) * sms
            fwd_loads = bwd_loads = "f32 FMA loop: 16 B (rows % 4 == 0)"

        def pad_ms(*ts):
            padded = [t for t in ts if RING.pad_rows(t) is not t]
            return (cuda_ms(lambda: [RING.pad_rows(t) for t in padded])
                    if padded else 0.0)

        row = dict(shape=label, p=p, rows=rows, d=d, m=m, dtype=name,
                   fwd_calls_per_train_step=n_fwd if n_bwd else 0,
                   bwd_calls_per_train_step=n_bwd,
                   calls_per_decode_step=0 if n_bwd else n_fwd,
                   fwd_route="sm90" if bf16 else "f32",
                   fwd_loads=fwd_loads, bwd_loads=bwd_loads,
                   fwd_kernel=RING.kernel_attrs(2 if bf16 else 3),
                   bwd_kernel=RING.kernel_attrs(0 if bf16 else 1),
                   fwd_tiles=fwd_tiles, fwd_grid=fwd_grid,
                   fwd_waves=fwd_tiles / fwd_grid,
                   fwd_pad_ms=pad_ms(x, w), bwd_pad_ms=pad_ms(x, w, dy),
                   bwd_tiles={"dw": n_dw, "dx": n_dx}, bwd_grid=grid,
                   bwd_waves=(n_dw + n_dx) / grid,
                   fwd_max_abs_err=fwd_err, fwd_tol=tol,
                   dx_acc_rel_err=dx_err, dx_acc_max_abs_err=dx_abs,
                   dx_tol=RING_DX_TOL,
                   dx_acc_bitwise_wx_step_loop=bf16)
        for kind, kernel, plain_fn, lib in (
                ("fwd", fwd_kernel, fwd_plain, fwd_library),
                ("bwd", bwd_kernel, bwd_plain, bwd_library))[:1 + bool(
                    n_bwd)]:
            bound, bound_by = ring_bound_ms(rows, dl, m, p, name,
                                            kind == "bwd", need_dx)
            row.update({f"{kind}_kernel_ms": cuda_ms(kernel),
                        f"{kind}_plain_ms": cuda_ms(plain_fn, 3),
                        f"{kind}_library_ms": cuda_ms(lib),
                        f"{kind}_bound_ms": bound,
                        f"{kind}_bound_by": bound_by})
            work = 2e-9 * rows * m * dl * (1 + int(kind == "bwd"
                                                   and need_dx))
            row[f"{kind}_tflops"] = work / row[f"{kind}_kernel_ms"]
        if need_dx and n_bwd:
            row["bwd_dw_only_ms"] = cuda_ms(lambda: bwd_kernel(False))
        emit(phase="ring_shape", **row)
        rows_out.append(row)
        del xs, ws, dys, x, w, dy, slots, bwd_slots, out, acc, dx, dw
        torch.cuda.empty_cache()
    return rows_out, worst


# ---------------------------------------------------------------------------
# phase 8: the Cannon kernel against the step loop and its plain version
# ---------------------------------------------------------------------------

# the token-mix Cannon loops of a 2x2 rank at full width: (label, m, t, c)
# of w [m, t] @ x [L, t, c], and the loops per training sample-step at
# r = 1 (3 blocks: the forward and the checkpoint's rerun), q launches each
CANNON_Q = 2
CANNON_SHAPES = [("2x2.tok_fc1", 4320, 8190, 2160, 6),
                 ("2x2.tok_fc2", 8190, 4320, 2160, 6)]


def cannon_bound_ms(ll, m, t, c, q, dtype_name):
    """Least time of one rank's q launches of a Cannon loop: its q GEMMs
    over the peak, or the bytes (each step's w and x read, the f32
    accumulator written at the first step and read and written after, the
    q - 1 hops of w and x written) over the memory rate."""
    es = 4 if dtype_name == "float32" else 2
    flops = 2.0 * q * ll * m * t * c
    ops = es * (m * t + ll * t * c)
    nbytes = (q * ops + (q - 1) * ops + 4 * ll * m * c
              + (q - 1) * 8 * ll * m * c)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cannon_phase(torch, CANNON, WX, RING, ref):
    """The q x q ranks of a mesh held in one process (rank r's step s writes
    its predecessors' slots s % 2, tensors here; the launch order on one
    stream is the barrier) at the two token-mix shapes of a 2x2 rank, batch
    1 and 2, bf16, and tok_fc1 in f32 at batch 1: every rank's result bit
    for bit the step loop (one wx launch per step, the blocks rotated the
    same way), and within WX_TOL of the plain Cannon; then rank 0's q
    launches timed (with the per-loop padding of w and x where their rows
    need it) beside the plain steps, the library's (torch.baddbmm per
    step, no hops) and the bound; each row names every operand's load
    path, the kernel's registers, local and shared bytes, and its tiles
    and waves.  Then q = 3 at a small size, both checks.  On one card a
    hop is a store into HBM, not an NVLink write."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = CANNON_Q
    cases = [(shape, ll, "bfloat16") for shape in CANNON_SHAPES
             for ll in (1, 2)]
    cases.append((CANNON_SHAPES[0], 1, "float32"))
    rows, worst = [], 0.0

    def blocks(q, ll, m, t, c, dtype):
        ws = [(torch.randn(m, t, generator=gen, device="cuda") / t ** 0.5
               ).to(dtype) for _ in range(q * q)]
        xs = [torch.randn(ll, t, c, generator=gen, device="cuda").to(dtype)
              for _ in range(q * q)]
        return ws, xs

    def checked(ws, xs, q, name, what):
        got = CANNON.cannon_fwd_all(ws, xs, q)
        torch.cuda.synchronize()
        loop = ref.cannon_walk_all(lambda w, x, a: WX.wx(w, x, a), ws, xs,
                                   q)
        check(all(torch.equal(a, b) for a, b in zip(got, loop)),
              f"cannon {what}: not bit for bit the step loop")
        del loop
        tol = WX_TOL[name]
        err = 0.0
        for a, b in zip(got, ref.cannon_ref(ws, xs, q)):
            check(bool(((a - b).abs() <= tol + tol * b.abs()).all()),
                  f"cannon {what} vs plain: max err "
                  f"{float((a - b).abs().max()):.3e}")
            err = max(err, float((a - b).abs().max()))
        return err

    for (label, m, t, c, calls), ll, name in cases:
        dtype = getattr(torch, name)
        ws, xs = blocks(q, ll, m, t, c, dtype)
        err = checked(ws, xs, q, name, f"{label} L={ll} {name}")
        worst = max(worst, err)
        # rank (0, 0)'s q launches of one loop: at step s it holds the
        # blocks of ranks (0, s) (w) and (s, 0) (x)
        w0, x0 = ws[0], xs[0]
        w_slots = [RING.empty_rows_like(RING.pad_rows(w0)) for _ in range(2)]
        x_slots = [RING.empty_rows_like(RING.pad_rows(x0)) for _ in range(2)]
        out = torch.empty(ll, m, c, device="cuda")
        steps = [(ws[s], xs[s * q]) for s in range(q)]

        def kernel():
            # as fused_ring._card_cannon: the blocks padded once per loop
            wp, xp = RING.pad_rows(w0), RING.pad_rows(x0)
            for s in range(q):
                last = s == q - 1
                CANNON.cannon_step(
                    wp if s == 0 else w_slots[(s - 1) % 2],
                    xp if s == 0 else x_slots[(s - 1) % 2], out,
                    first=s == 0, w_dest=None if last else w_slots[s % 2],
                    x_dest=None if last else x_slots[s % 2])

        def plain():
            acc = None
            for w, x in steps:
                acc = ref.wx_ref(w, x, acc)
            return acc

        def library():
            acc = torch.zeros(ll, m, c, dtype=dtype, device="cuda")
            for w, x in steps:
                acc = torch.baddbmm(acc, w.expand(ll, m, t), x)
            return acc

        bound, bound_by = cannon_bound_ms(ll, m, t, c, q, name)
        bf16 = name == "bfloat16"
        attrs = CANNON.kernel_attrs(f32=not bf16)
        if bf16:
            tiles = ll * RING.sm90_tiles(m, c)
            grid = RING.persistent_grid(tiles, True, sm_count(torch))
        else:       # one [128 x 128] tile a block, blocks_per_sm at once
            tiles = ll * -(-m // 128) * -(-c // 128)
            grid = blocks_per_sm(attrs) * sm_count(torch)
        row = dict(shape=label, q=q, batch=ll, m=m, t=t, c=c, dtype=name,
                   calls_per_train_step=calls,
                   loads=({k: op.describe() for k, op in
                           RING.tma_operands_cannon(ll, m, c, t).items()}
                          if bf16 else "f32 FMA loop: 16 B (rows % 4 == 0)"),
                   kernel=attrs, tiles=tiles, grid=grid, waves=tiles / grid,
                   bitwise_step_loop=True, max_abs_err=err,
                   tol=WX_TOL[name], kernel_ms=cuda_ms(kernel),
                   plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library),
                   bound_ms=bound, bound_by=bound_by,
                   bound_ms_per_launch=bound / q)
        row["tflops"] = 2e-9 * q * ll * m * t * c / row["kernel_ms"]
        emit(phase="cannon_shape", **row)
        rows.append(row)
        del ws, xs, w0, x0, w_slots, x_slots, out, steps
        torch.cuda.empty_cache()
    for name in ("bfloat16", "float32"):
        ws, xs = blocks(3, 2, 300, 129, 70, getattr(torch, name))
        err = checked(ws, xs, 3, name, f"q=3 {name}")
        worst = max(worst, err)
        emit(phase="cannon_q3", dtype=name, shape=[2, 300, 129, 70],
             bitwise_step_loop=True, max_abs_err=err, tol=WX_TOL[name])
    return rows, worst


# ---------------------------------------------------------------------------
# phase 9: full-width training
# ---------------------------------------------------------------------------

def train_flops_per_sample(cfg, rollout):
    """2*M*N*K over the 5 + 54 r GEMM launches of one training sample-step
    (3 blocks, remat): forward, remat recompute, dw and dx (the encoder's
    input needs none) of every linear, and the pre-activation recompute of
    the two GELU linears of each block."""
    t = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    d, pd = cfg.d_model, cfg.wm_patch ** 2 * cfg.wm_channels
    enc = 2.0 * t * pd * d                   # encoder = decoder
    tok = 2.0 * d * cfg.wm_d_tok * t         # tok_fc1 = tok_fc2
    ch = 2.0 * t * cfg.wm_d_ch * d           # ch_fc1 = ch_fc2
    block = 2 * tok + 2 * ch
    return 5 * enc + rollout * cfg.n_layers * (4 * block + tok + ch)


def train_2d_bound_ms_per_sample(cfg, rollout, q=1):
    """The least device time of one 2-D training sample-step (3 blocks,
    remat), per rank of a q x q mesh: per block and pass, the token mix's
    8 GEMMs (forward, rerun, dw and dx of both linears; at q > 1 two more,
    the fused Cannon's VJP recomputing the forward), the channel mix's 8
    (forward, rerun, dx, dw), and 5 encoder/decoder GEMMs, all over the
    bf16 peak: dx too, which on this path is one bf16 product (the
    cotangent is bf16-exact: wx's dx route contracts one split term); a
    rank does 1/q**2 of it."""
    t = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    d, pd = cfg.d_model, cfg.wm_patch ** 2 * cfg.wm_channels
    enc = 2.0 * t * pd * d
    tok = 2.0 * d * cfg.wm_d_tok * t
    ch = 2.0 * t * cfg.wm_d_ch * d
    passes = rollout * cfg.n_layers
    flops = 5 * enc + passes * ((8 if q == 1 else 10) * tok + 8 * ch)
    return 1e3 * flops / PEAK_FLOPS["bfloat16"] / q ** 2


def fwd_bwd_ms(torch, params, batch, cfg, jcfg, rollout):
    """Device time of one forward (to the loss) and of its backward (CUDA
    events around each)."""
    from repro_torch.core import tree as ptree
    from repro_torch.train.step import loss_fn
    live = [p.detach().requires_grad_(True) for p in ptree.leaves(params)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    with torch.enable_grad():
        ev[0].record()
        loss, _ = loss_fn(ptree.unflatten(params, live), batch, cfg, jcfg,
                          rollout)
        ev[1].record()
        torch.autograd.grad(loss, live)
        ev[2].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def leaf_rel_err(torch, got, want):
    from repro_torch.core import tree as ptree
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(ptree.leaves(got), ptree.leaves(want)))


def leaf_errs(torch, got, want):
    """The worst leaf of ``got`` against ``want`` by two measures, each
    with its path: the largest difference over the largest magnitude (as
    ``leaf_rel_err``), and the difference's norm over the leaf's norm."""
    from repro_torch.core import tree as ptree
    worst = {"max_leaf_rel_err": (0.0, None),
             "max_leaf_norm_err": (0.0, None)}
    for (path, a), b in zip(ptree.leaves_with_path(got),
                            ptree.leaves(want)):
        b = b.float()
        d = a.float() - b
        errs = {"max_leaf_rel_err":
                float(d.abs().max() / b.abs().max().clamp_min(1e-30)),
                "max_leaf_norm_err":
                float(d.norm() / b.norm().clamp_min(1e-30))}
        for k, e in errs.items():
            if e > worst[k][0]:
                worst[k] = (e, "/".join(map(str, path)))
        del b, d
    out = {}
    for k, (e, at) in worst.items():
        out.update({k: e, f"{k}_at": at})
    return out


def train_2d_phase(torch, BM, WX, eng, batch0, r0, none_metrics,
                   none_grads):
    """One 2-D forward and backward (scheme="2d" on the 1x1 mesh: each rank
    of a q x q mesh runs this code on its blocks, with rotations between
    the Cannon steps) on the train phase's weights and first batch, held
    against the scheme="none" step's loss, grad norm and gradients."""
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import value_and_grad
    cfg2 = eng.cfg.replace(scheme="2d")
    jcfg2 = eng.jcfg.replace(scheme="2d")
    # -- the 2-D path: counts to 0 just before, read just after -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    WX.wx.launches = 0
    WX.wx.layout_launches.clear()
    WX.reset_dx_terms()
    m2, g2 = value_and_grad(eng.params, batch0, cfg2, jcfg2, r0)
    torch.cuda.synchronize()
    bm_launches, wx_launches = BM.block_matmul.launches, WX.wx.launches
    wx_dx = WX.wx.layout_launches[True]
    dx_terms = WX.dx_terms()
    peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------
    check((bm_launches, wx_launches, wx_dx) == (5 + 30 * r0, 18 * r0, 6 * r0),
          f"2-D step at r={r0}: {bm_launches} block_matmul and "
          f"{wx_launches} wx launches ({wx_dx} dx); want {5 + 30 * r0}, "
          f"{18 * r0} ({6 * r0})")
    # the cotangent that reaches dx is a bf16 one cast up: every dx launch
    # contracts one split term
    check(dx_terms == {1: wx_dx, 3: 0}, f"2-D step: dx launches by term "
          f"count {dx_terms}, want all {wx_dx} at one term")
    l2, ln = float(m2["loss"]), float(none_metrics["loss"])
    n2, nn = float(global_norm(g2)), float(global_norm(none_grads))
    leaf_err = leaf_rel_err(torch, g2, none_grads)
    stats = dict(rollout=r0, loss=l2, loss_none=ln,
                 loss_rel_err=abs(l2 - ln) / abs(ln), grad_norm=n2,
                 grad_norm_none=nn, grad_norm_rel_err=abs(n2 - nn) / nn,
                 max_leaf_rel_err=leaf_err, tol=TRAIN_TOL,
                 block_matmul_launches=bm_launches, wx_launches=wx_launches,
                 wx_dx_launches=wx_dx, wx_dx_terms=dx_terms,
                 peak_mem_gb=peak / 1e9)
    check(stats["loss_rel_err"] <= TRAIN_TOL
          and stats["grad_norm_rel_err"] <= TRAIN_TOL
          and leaf_err <= TRAIN_TOL, f"2-D step vs scheme='none': {stats}")
    del g2
    torch.cuda.empty_cache()
    # device time of a forward and its backward, both schemes (after the
    # checked run, which warmed them up; not part of it)
    f2, b2 = fwd_bwd_ms(torch, eng.params, batch0, cfg2, jcfg2, r0)
    f0, b0 = fwd_bwd_ms(torch, eng.params, batch0, eng.cfg, eng.jcfg, r0)
    stats.update(device_fwd_ms=f2, device_bwd_ms=b2,
                 device_fwd_bwd_ms=f2 + b2, none_device_fwd_ms=f0,
                 none_device_bwd_ms=b0, none_device_fwd_bwd_ms=f0 + b0,
                 batch=TRAIN_BATCH,
                 device_fwd_bwd_ms_per_sample=(f2 + b2) / TRAIN_BATCH,
                 bound_ms_per_sample=train_2d_bound_ms_per_sample(eng.cfg,
                                                                  r0))
    emit(phase="train_2d", **stats)
    torch.cuda.empty_cache()
    return stats


TRAIN_1D_P = 2
# against the scheme="none" step on the same weights and batch: the 1-D
# path rounds each linear's partial sums to bf16 at every hop and adds the
# bias after the reduce (the none path fuses bias and GELU into one
# rounding), so it agrees to bf16's precision, not bit for bit
TRAIN_1D_TOL = {"loss": 1e-3, "grad_norm": 5e-3, "leaf": 5e-2}


def train_1d_bound_ms_per_sample(p):
    """The least device time of one 1-D training sample-step on the card
    (both ranks' work; 3 blocks, remat, r = 1): every ring call's GEMMs
    (2 + 24 forward calls, 2 + 12 backward ones of dw and, but for the
    encoder, dx) over the bf16 peak.  Each rank does 1/p of it."""
    flops = 0.0
    for label, rows, d, m, n_fwd, n_bwd in RING_SHAPES:
        gemm = 2.0 * rows * m * d
        flops += gemm * (n_fwd + n_bwd * (1 if label == "encoder" else 2))
    return 1e3 * flops / PEAK_FLOPS["bfloat16"]


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def train_1d_phase(torch, eng, batch0, r0, none_metrics, none_grads):
    """One 1-D (scheme="1d", impl="ring_fused") forward and backward on
    TRAIN_1D_P ranks, one process each, sharing this card (gloo between
    them; each rank's ring slots mapped into its predecessor by CUDA IPC),
    through the TrainEngine on the train phase's weights (the same seed)
    and first batch (handed over in a file), held against this process's
    scheme="none" step on them; then the same step under
    impl="ring_chunked", whose loss must be the same bits."""
    import shutil
    import tempfile
    from repro_torch.convert import shard_params_1d
    from repro_torch.core import tree as ptree
    from repro_torch.optim.adam import global_norm
    p = TRAIN_1D_P
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_1d_"))
    try:
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in batch0.items()},
                   tmp / "batch.pt")
        for r in range(p):
            shard = shard_params_1d(none_grads, r, p)
            fingerprint = [float(t.double().sum()) for t in
                           ptree.leaves(shard_params_1d(eng.params, r, p))]
            torch.save({"grads": ptree.map(lambda t: t.cpu(), shard),
                        "fingerprint": fingerprint}, tmp / f"none{r}.pt")
            del shard
        (tmp / "meta.json").write_text(json.dumps(dict(rollout=r0)))
        torch.cuda.empty_cache()
        handoff_s = time.perf_counter() - t0
        res, wall = run_ranks("--train-1d-rank", tmp, p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want_fwd, want_bwd = (2 + 24 * r0) * p, (2 + 12 * r0) * p
    for r, x in enumerate(res):
        check((x["ring_fwd_launches"], x["ring_bwd_launches"],
               x["block_matmul_launches"]) == (want_fwd, want_bwd, 0),
              f"train_1d rank {r}: {x['ring_fwd_launches']} ring_fwd, "
              f"{x['ring_bwd_launches']} ring_bwd and "
              f"{x['block_matmul_launches']} block_matmul launches; want "
              f"{want_fwd}, {want_bwd} and 0")
    ln = float(none_metrics["loss"])
    nn = float(global_norm(none_grads))
    loss, norm = res[0]["loss"], res[0]["grad_norm"]
    check(all(x["loss"] == loss and x["grad_norm"] == norm for x in res),
          "train_1d: the ranks report different losses or norms")
    leaf = max(max(x["leaf_diff"][i] for x in res)
               / max(max(x["leaf_ref"][i] for x in res), 1e-30)
               for i in range(len(res[0]["leaf_diff"])))
    stats = dict(ranks=p, rollout=r0, impl="ring_fused", loss=loss,
                 loss_none=ln, loss_rel_err=abs(loss - ln) / abs(ln),
                 grad_norm=norm, grad_norm_none=nn,
                 grad_norm_rel_err=abs(norm - nn) / nn,
                 max_leaf_rel_err=leaf, tol=TRAIN_1D_TOL,
                 loss_ring_chunked=res[0]["loss_ring_chunked"],
                 ring_fwd_launches=[x["ring_fwd_launches"] for x in res],
                 ring_bwd_launches=[x["ring_bwd_launches"] for x in res],
                 peak_mem_gb=[x["peak_mem_gb"] for x in res],
                 ring_slots_gb=[x["ring_slots_gb"] for x in res],
                 collectives_through_host=[x["through_host"] for x in res],
                 gb_through_host=[x["through_host_gb"] for x in res],
                 device_fwd_ms=[x["fwd_ms"] for x in res],
                 device_bwd_ms=[x["bwd_ms"] for x in res],
                 batch=TRAIN_BATCH,
                 device_fwd_bwd_ms_per_sample=max(
                     x["fwd_ms"] + x["bwd_ms"] for x in res) / TRAIN_BATCH,
                 bound_ms_per_sample=train_1d_bound_ms_per_sample(p),
                 handoff_s=handoff_s, wall_s=wall,
                 setup_s=[x["setup_s"] for x in res])
    check(stats["loss_rel_err"] <= TRAIN_1D_TOL["loss"]
          and stats["grad_norm_rel_err"] <= TRAIN_1D_TOL["grad_norm"]
          and leaf <= TRAIN_1D_TOL["leaf"],
          f"1-D step vs scheme='none': {stats}")
    check(all(x["loss_ring_chunked"] == x["loss"] for x in res),
          f"train_1d: ring_chunked's loss {res[0]['loss_ring_chunked']!r} "
          f"is not ring_fused's {loss!r} bit for bit")
    emit(phase="train_1d", **stats)
    return stats


def train_1d_worker(rank, tmp):
    """One rank of ``train_1d_phase`` (this file run with
    ``--train-1d-rank``): the process group from the environment, the
    engine on the (data=1, model=TRAIN_1D_P) mesh, one forward and backward
    with its launches counted, the comparison against this rank's shard of
    the none step's gradients, the timed forward and backward, and the
    ring_chunked step; results to rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import ring as RING
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    r0 = json.loads((tmp / "meta.json").read_text())["rollout"]
    t0 = time.perf_counter()
    eng = TrainEngine("weathermixer-1b", reduced=False,
                      mesh_model=TRAIN_1D_P, scheme="1d", impl="ring_fused",
                      device="cuda",
                      config=EngineConfig(steps=1, batch=TRAIN_BATCH,
                                          precision="bf16", lr=1e-4, seed=0,
                                          pipeline="sync-full", prefetch=0,
                                          telemetry=False))
    none = torch.load(tmp / f"none{rank}.pt")
    check([float(t.double().sum()) for t in ptree.leaves(eng.params)]
          == none["fingerprint"], "train_1d: the engine's weights are not "
          "the train phase's")
    batch = {k: v.to(eng.device) for k, v in
             torch.load(tmp / "batch.pt").items()}
    cfg, jcfg = eng.cfg, eng.jcfg
    check(cfg.remat and cfg.kernel == "pallas" and jcfg.impl == "ring_fused"
          and dist.get_backend() == "gloo", "unexpected 1-D config")
    setup_s = time.perf_counter() - t0

    # -- the 1-D path: counts to 0 just before, read just after -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RING.ring_fwd.launches = RING.ring_bwd.launches = 0
    BM.block_matmul.launches = 0
    comm.through_host.clear()
    comm.through_host_bytes.clear()
    metrics, grads = value_and_grad(eng.params, batch, cfg, jcfg, r0)
    torch.cuda.synchronize()
    res = dict(ring_fwd_launches=RING.ring_fwd.launches,
               ring_bwd_launches=RING.ring_bwd.launches,
               block_matmul_launches=BM.block_matmul.launches,
               through_host=dict(comm.through_host),
               through_host_gb=sum(comm.through_host_bytes.values()) / 1e9,
               # the ring's slots are raw cudaMallocs, outside torch's
               # allocator: their bytes are added to its peak
               ring_slots_gb=RING.workspace_bytes() / 1e9,
               peak_mem_gb=(torch.cuda.max_memory_allocated()
                            + RING.workspace_bytes()) / 1e9)
    # ----------------------------------------------------------------------
    res["loss"] = float(metrics["loss"])
    res["grad_norm"] = float(global_norm(grads, **_norm_args(eng.params, cfg,
                                                             jcfg)))
    res["leaf_diff"], res["leaf_ref"] = [], []
    for a, b in zip(ptree.leaves(grads), ptree.leaves(none["grads"])):
        b = b.to(a.device).float()
        res["leaf_diff"].append(float((a.float() - b).abs().max()))
        res["leaf_ref"].append(float(b.abs().max()))
    del grads, none
    torch.cuda.empty_cache()
    res["fwd_ms"], res["bwd_ms"] = fwd_bwd_ms(torch, eng.params, batch, cfg,
                                              jcfg, r0)
    mc, _ = value_and_grad(eng.params, batch, cfg,
                           jcfg.replace(impl="ring_chunked"), r0)
    res["loss_ring_chunked"] = float(mc["loss"])
    res["setup_s"] = setup_s
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    eng.close()
    dist.destroy_process_group()
    return 0


TRAIN_2D_Q = 2


def _step_loop(wl, xl, *, model_group, **kw):
    """fused_cannon_t forced to the step loop (one wx launch per step,
    rotations through comm.rotate): the variant the 2x2 step must equal."""
    from repro_torch.kernels import fused_ring
    return fused_ring.cannon_t_loop(wl, xl, **kw)


def run_ranks(flag, tmp, n, timeout=600):
    """This file re-run as n rank processes (``flag r tmp``) sharing the
    card, joined through ``env://`` on a free port; returns their
    rank<r>.json results and the wall seconds."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n))
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag, str(r),
             str(tmp)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        outs = [pr.communicate(timeout=timeout) for pr in procs]
        wall = time.perf_counter() - t0
        for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
            check(pr.returncode == 0, f"{flag} {r} failed "
                  f"({pr.returncode}):\n{err[-4000:]}")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
            for r in range(n)], wall


def train_2d_mesh_phase(torch, eng, batch0, r0, none_metrics, none_grads,
                        ckpt_need, card, serve_handoff):
    """One 2-D (scheme="2d") forward and backward on a 2x2 mesh of four
    rank processes sharing this card (gloo between them; each rank's
    Cannon slots mapped into its predecessors by CUDA IPC), through the
    TrainEngine with per-rank reads (pipeline="sharded") on the train
    phase's weights (the same seed) and first step's batch, held against
    this process's scheme="none" step and, bit for bit, against the same
    step with fused_cannon_t forced to the step loop.  Then the ranks save
    a checkpoint (``eng.save(..., block=True)``), which this process
    serves on one device (``ckpt_serve_part``) and two serving ranks
    restore (``serve_data_phase``); returns (stats, the ckpt part's
    numbers, serve_data's)."""
    import shutil
    import tempfile
    from repro_torch.convert import shard_params_2d
    from repro_torch.core import tree as ptree
    from repro_torch.optim.adam import global_norm
    q, n = TRAIN_2D_Q, TRAIN_2D_Q ** 2
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_2d_"))
    ck, _ = ckpt_dir("2x2", ckpt_need)
    try:
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in batch0.items()},
                   tmp / "batch.pt")
        for r in range(n):
            i, j = divmod(r, q)
            shard = shard_params_2d(none_grads, i, j, q)
            fingerprint = [float(t.double().sum()) for t in
                           ptree.leaves(shard_params_2d(eng.params, i, j,
                                                        q))]
            torch.save({"grads": ptree.map(lambda t: t.cpu(), shard),
                        "fingerprint": fingerprint}, tmp / f"none{r}.pt")
            del shard
        (tmp / "meta.json").write_text(json.dumps(dict(
            rollout=r0, ckpt=str(ck / "ck"))))
        torch.cuda.empty_cache()
        handoff_s = time.perf_counter() - t0
        res, wall = run_ranks("--train-2d-rank", tmp, n)
        ckpt_b = ckpt_serve_part(torch, eng, ck / "ck", res, card)
        serve_data = serve_data_phase(torch, serve_handoff, ck / "ck",
                                      ckpt_b["forecast_sha"], card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        ckpt_drop(ck)

    want = dict(cannon=24 * r0, wx_fwd=12 * r0, wx_dx=12 * r0,
                block_matmul=10 + 60 * r0, ring=0)
    for r, x in enumerate(res):
        check(x["launches"] == want, f"train_2d_mesh rank {r}: launches "
              f"{x['launches']}, want {want} (counted on the CPU)")
        check(x["dx_terms"] == {"1": want["wx_dx"], "3": 0},
              f"train_2d_mesh rank {r}: dx launches by term count "
              f"{x['dx_terms']}, want all {want['wx_dx']} at one term")
        check(x["block_equal"], f"train_2d_mesh rank {r}: its batch is not "
              "field_block of the whole batch")
        check(x["read_share"] == 1 / n, f"train_2d_mesh rank {r} read "
              f"{x['read_share']} of the batch's bytes, want 1/{n}")
        check(x["loss"] == x["loss_step_loop"]
              and x["grad_norm"] == x["grad_norm_step_loop"],
              f"train_2d_mesh rank {r}: loss {x['loss']!r} / norm "
              f"{x['grad_norm']!r} differ from the step loop's "
              f"{x['loss_step_loop']!r} / {x['grad_norm_step_loop']!r}")
    ln = float(none_metrics["loss"])
    nn = float(global_norm(none_grads))
    loss, norm = res[0]["loss"], res[0]["grad_norm"]
    check(all(x["loss"] == loss and x["grad_norm"] == norm for x in res),
          "train_2d_mesh: the ranks report different losses or norms")
    leaf = max(max(x["leaf_diff"][i] for x in res)
               / max(max(x["leaf_ref"][i] for x in res), 1e-30)
               for i in range(len(res[0]["leaf_diff"])))
    peaks = [x["peak_mem_gb"] for x in res]
    stats = dict(ranks=n, mesh=f"{q}x{q}", rollout=r0, pipeline="sharded",
                 loss=loss, loss_none=ln,
                 loss_rel_err=abs(loss - ln) / abs(ln), grad_norm=norm,
                 grad_norm_none=nn, grad_norm_rel_err=abs(norm - nn) / nn,
                 max_leaf_rel_err=leaf, tol=TRAIN_1D_TOL,
                 loss_step_loop=res[0]["loss_step_loop"],
                 grad_norm_step_loop=res[0]["grad_norm_step_loop"],
                 launches=[x["launches"] for x in res],
                 wx_dx_terms=[x["dx_terms"] for x in res],
                 read_bytes=[x["read_bytes"] for x in res],
                 read_share=[x["read_share"] for x in res],
                 read_s=[x["read_s"] for x in res],
                 peak_mem_gb=peaks, peak_mem_gb_sum=sum(peaks),
                 cannon_slots_gb=[x["cannon_slots_gb"] for x in res],
                 collectives_through_host=[x["through_host"] for x in res],
                 gb_through_host=[x["through_host_gb"] for x in res],
                 device_fwd_ms=[x["fwd_ms"] for x in res],
                 device_bwd_ms=[x["bwd_ms"] for x in res],
                 batch=TRAIN_BATCH,
                 device_fwd_bwd_ms_per_sample=max(
                     x["fwd_ms"] + x["bwd_ms"] for x in res) / TRAIN_BATCH,
                 bound_ms_per_sample=train_2d_bound_ms_per_sample(
                     eng.cfg, r0, q),
                 handoff_s=handoff_s, wall_s=wall,
                 setup_s=[x["setup_s"] for x in res])
    check(stats["loss_rel_err"] <= TRAIN_1D_TOL["loss"]
          and stats["grad_norm_rel_err"] <= TRAIN_1D_TOL["grad_norm"]
          and leaf <= TRAIN_1D_TOL["leaf"],
          f"2x2 step vs scheme='none': {stats}")
    check(sum(peaks) < PEAK_MEM_LIMIT, f"train_2d_mesh: the four ranks' "
          f"peaks sum to {sum(peaks):.2f} GB")
    emit(phase="train_2d_mesh", **stats)
    return stats, ckpt_b, serve_data


def train_2d_worker(rank, tmp):
    """One rank of ``train_2d_mesh_phase`` (this file run with
    ``--train-2d-rank``): the engine on the 2x2 mesh with per-rank reads,
    its block of the first batch held against field_block of the whole
    one, one forward and backward with its launches counted, the
    comparison against this rank's shard of the none step's gradients,
    the timed forward and backward, and the step-loop variant; results to
    rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import cannon as CANNON
    from repro_torch.kernels import fused_ring
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ring as RING
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import wx as WX
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.models import weathermixer as W
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    meta = json.loads((tmp / "meta.json").read_text())
    r0 = meta["rollout"]
    t0 = time.perf_counter()
    eng = TrainEngine("weathermixer-1b", reduced=False,
                      mesh_model=TRAIN_2D_Q ** 2, scheme="2d",
                      device="cuda",
                      config=EngineConfig(steps=1, batch=TRAIN_BATCH,
                                          precision="bf16", lr=1e-4, seed=0,
                                          pipeline="sharded", prefetch=0,
                                          telemetry=False))
    none = torch.load(tmp / f"none{rank}.pt")
    check([float(t.double().sum()) for t in ptree.leaves(eng.params)]
          == none["fingerprint"], "train_2d_mesh: the engine's weights are "
          "not the train phase's")
    cfg, jcfg = eng.cfg, eng.jcfg
    check(cfg.remat and cfg.kernel == "pallas" and jcfg.mesh.q == TRAIN_2D_Q
          and dist.get_backend() == "gloo", "unexpected 2-D config")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = eng.pipeline.get(0, r0)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    whole = torch.load(tmp / "batch.pt")
    block_equal = all(torch.equal(batch[k].cpu(),
                                  W.field_block(whole[k], cfg, jcfg))
                      for k in whole)
    read_bytes = {k: v[eng.pipeline.rank]
                  for k, v in eng.pipeline.stats.rank_bytes.items()}
    read_share = read_bytes["fields"] / (whole["fields"].numel() * 4)
    del whole

    # -- the 2x2 path: counts to 0 just before, read just after ------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in (CANNON.cannon_step, WX.wx, BM.block_matmul, RING.ring_fwd,
              RING.ring_bwd):
        f.launches = 0
    WX.wx.layout_launches.clear()
    WX.reset_dx_terms()
    comm.through_host.clear()
    comm.through_host_bytes.clear()
    metrics, grads = value_and_grad(eng.params, batch, cfg, jcfg, r0)
    torch.cuda.synchronize()
    res = dict(dx_terms=WX.dx_terms(),
               launches=dict(cannon=CANNON.cannon_step.launches,
                             wx_fwd=WX.wx.layout_launches[False],
                             wx_dx=WX.wx.layout_launches[True],
                             block_matmul=BM.block_matmul.launches,
                             ring=RING.ring_fwd.launches
                             + RING.ring_bwd.launches),
               through_host=dict(comm.through_host),
               through_host_gb=sum(comm.through_host_bytes.values()) / 1e9,
               # the Cannon's slots are raw cudaMallocs, outside torch's
               # allocator: their bytes are added to its peak
               cannon_slots_gb=RING.workspace_bytes() / 1e9,
               peak_mem_gb=(torch.cuda.max_memory_allocated()
                            + RING.workspace_bytes()) / 1e9)
    # ----------------------------------------------------------------------
    check(res["launches"]["wx_fwd"] + res["launches"]["wx_dx"]
          == WX.wx.launches, "wx launches outside the two layouts")
    # the slots are the fused Cannon's footprint at the token mix's largest
    # blocks (tok_fc1: w [d_tok/q, T/q], x [B, T/q, d/q])
    q = TRAIN_2D_Q
    slots = fused_ring.cannon_footprint_bytes(
        TRAIN_BATCH, cfg.wm_d_tok // q, W.n_tokens(cfg) // q,
        cfg.d_model // q, torch.bfloat16)
    check(RING.workspace_bytes() == slots, f"train_2d_mesh: "
          f"{RING.workspace_bytes()} bytes of slots, want {slots}")
    res.update(block_equal=block_equal, read_bytes=read_bytes,
               read_share=read_share, read_s=read_s, setup_s=setup_s)
    norm_args = _norm_args(eng.params, cfg, jcfg)
    res["loss"] = float(metrics["loss"])
    res["grad_norm"] = float(global_norm(grads, **norm_args))
    res["leaf_diff"], res["leaf_ref"] = [], []
    for a, b in zip(ptree.leaves(grads), ptree.leaves(none["grads"])):
        b = b.to(a.device).float()
        res["leaf_diff"].append(float((a.float() - b).abs().max()))
        res["leaf_ref"].append(float(b.abs().max()))
    del grads, none
    torch.cuda.empty_cache()
    res["fwd_ms"], res["bwd_ms"] = fwd_bwd_ms(torch, eng.params, batch, cfg,
                                              jcfg, r0)
    real = fused_ring.fused_cannon_t
    fused_ring.fused_cannon_t = _step_loop
    try:
        m2, g2 = value_and_grad(eng.params, batch, cfg, jcfg, r0)
    finally:
        fused_ring.fused_cannon_t = real
    res["loss_step_loop"] = float(m2["loss"])
    res["grad_norm_step_loop"] = float(global_norm(g2, **norm_args))
    del g2
    # the ckpt phase's part (b): every rank saves its blocks (no update
    # was made: the weights are seed 0's); rank 0 merges the manifest
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.save(meta["ckpt"], block=True)
    res["ckpt_save_s"] = time.perf_counter() - t0
    res["ckpt_bytes"] = eng.last_save.bytes_per_rank[eng.mesh.rank]
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    eng.close()
    dist.destroy_process_group()
    return 0


TRAIN_DATA = 2          # data ranks of the data-parallel phases


def data_handoff(torch, eng, batch0):
    """What the data-parallel phases take from the train phase, written
    before its run moves the weights: the first batch (on the host) and
    each 1-D model rank's shard fingerprint of the seed-0 weights (the 2-D
    data ranks hold them whole)."""
    import tempfile
    from repro_torch.convert import shard_params_1d
    from repro_torch.core import tree as ptree
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    torch.save({k: v.cpu() for k, v in batch0.items()}, tmp / "batch.pt")

    def sums(tree):
        return [float(t.double().sum()) for t in ptree.leaves(tree)]
    prints = {"2d": sums(eng.params)}
    for r in range(TRAIN_1D_P):
        prints[f"1d{r}"] = sums(shard_params_1d(eng.params, r, TRAIN_1D_P))
    (tmp / "fingerprints.json").write_text(json.dumps(prints))
    return tmp


def train_data_phase(torch, kind, tmp, r0, none_loss, none_norm, cfg):
    """One of the data-parallel phases: ``TrainEngine`` on TRAIN_DATA
    copies of a model group, this file re-run as its rank processes
    sharing the card (``--train-data-rank``), each reading its row of the
    train phase's first batch of two (``pipeline="sharded"``), one
    ``dispatch`` step at r = 1 in each of two runs in the same processes:
    kind "2d" at (data 2, 1x1) without ZeRO-1 and then with it; kind "1d"
    at (data 2, p 2), ``impl="ring_fused"`` with ZeRO-1, without the FSDP
    hybrid and then with it.  Checks: reads, launches, step 1 against the
    train phase's scheme="none" step, the two runs bit for bit, optimizer
    or weight bytes, the summed peaks."""
    p = 1 if kind == "2d" else TRAIN_1D_P
    n = TRAIN_DATA * p
    (tmp / "meta.json").write_text(json.dumps(dict(kind=kind, rollout=r0)))
    res, wall = run_ranks("--train-data-rank", tmp, n)
    if kind == "2d":
        want = dict(wx=18 * r0, wx_dx=6 * r0, block_matmul=5 + 30 * r0,
                    ring_fwd=0, ring_bwd=0)
    else:
        want = dict(wx=0, wx_dx=0, block_matmul=0,
                    ring_fwd=(2 + 24 * r0) * p, ring_bwd=(2 + 12 * r0) * p)
    for r, x in enumerate(res):
        for run in x["runs"]:
            check(run["launches"] == want, f"train_data_{kind} rank {r}: "
                  f"launches {run['launches']}, want {want}")
            if kind == "2d":
                check(run["dx_terms"] == {"1": want["wx_dx"], "3": 0},
                      f"train_data_2d rank {r}: dx launches by term count "
                      f"{run['dx_terms']}, want all at one term")
        check(x["block_equal"], f"train_data_{kind} rank {r}: its batch is "
              "not its rows and block of the whole batch")
        check(x["read_share"] == 1 / n, f"train_data_{kind} rank {r} read "
              f"{x['read_share']} of the batch's bytes, want 1/{n}")
        a, b = x["runs"]
        check(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
              and x["params_equal"], f"train_data_{kind} rank {r}: the two "
              f"runs differ: {a['loss']} {b['loss']} {a['grad_norm']} "
              f"{b['grad_norm']} params equal {x['params_equal']}")
    loss, norm = res[0]["runs"][0]["loss"], res[0]["runs"][0]["grad_norm"]
    check(all(run["loss"] == loss and run["grad_norm"] == norm
              for x in res for run in x["runs"]),
          f"train_data_{kind}: the ranks report different histories")
    peaks = [[x["runs"][i]["peak_mem_gb"] for x in res] for i in range(2)]
    first = dict(loss=loss[0], loss_none=none_loss,
                 loss_rel_err=abs(loss[0] - none_loss) / abs(none_loss),
                 grad_norm=norm[0], grad_norm_none=none_norm,
                 grad_norm_rel_err=abs(norm[0] - none_norm) / none_norm,
                 tol=TRAIN_TOL)
    check(first["loss_rel_err"] <= TRAIN_TOL
          and first["grad_norm_rel_err"] <= TRAIN_TOL,
          f"train_data_{kind} step 1 vs scheme='none': {first}")
    for i in range(2):
        check(sum(peaks[i]) < PEAK_MEM_LIMIT, f"train_data_{kind} run {i}: "
              f"the ranks' peaks sum to {sum(peaks[i]):.2f} GB")
    opt = [[x["runs"][i]["opt_bytes"] for x in res] for i in range(2)]
    weights = [[x["runs"][i]["weight_bytes"] for x in res] for i in range(2)]
    if kind == "2d":
        for x in res:
            a, b = x["runs"]
            check(b["opt_bytes"] <= a["opt_bytes"] / 2 + b["residue_bytes"]
                  and b["opt_bytes"] < a["opt_bytes"],
                  f"train_data_2d: ZeRO-1 keeps {b['opt_bytes']} bytes of "
                  f"optimizer state against {a['opt_bytes']} without "
                  f"(residue {b['residue_bytes']})")
    else:
        for x in res:
            a, b = x["runs"]
            ratio = b["weight_bytes"] / a["weight_bytes"]
            check(abs(ratio - 0.5) < 0.01, f"train_data_1d: the FSDP "
                  f"hybrid keeps {ratio:.4f} of the weight bytes")
    # the ranks run at once on the one card, which works through the
    # batch's two samples in the slowest rank's time (as train_2d_mesh)
    device_ms = max(x["fwd_ms"] + x["bwd_ms"] for x in res) / TRAIN_BATCH
    stats = dict(
        ranks=n, mesh=f"data {TRAIN_DATA}, " + ("1x1" if kind == "2d"
                                                else f"p {p}"),
        rollout=r0, pipeline="sharded",
        runs=(["zero1=False", "zero1=True"] if kind == "2d" else
              ["zero1, fsdp=False", "zero1, fsdp=True"]),
        loss=loss, grad_norm=norm, first_step_vs_none=first,
        runs_bitwise_equal=True,
        launches_per_rank=[[r["launches"] for r in x["runs"]] for x in res],
        read_bytes=[x["read_bytes"] for x in res],
        read_share=[x["read_share"] for x in res],
        opt_state_bytes=opt, opt_residue_bytes=[[
            r["residue_bytes"] for r in x["runs"]] for x in res],
        weight_bytes=weights,
        peak_mem_gb=peaks, peak_mem_gb_sum=[sum(v) for v in peaks],
        slots_gb=[[r["slots_gb"] for r in x["runs"]] for x in res],
        collectives_through_host=[x["runs"][0]["through_host"] for x in res],
        gb_through_host=[x["runs"][0]["through_host_gb"] for x in res],
        step_s=[[r["step_s"] for r in x["runs"]] for x in res],
        cost_model_metrics=[[r["cost"] for r in x["runs"]] for x in res],
        device_fwd_ms=[x["fwd_ms"] for x in res],
        device_bwd_ms=[x["bwd_ms"] for x in res],
        batch=TRAIN_BATCH, rows_per_rank=TRAIN_BATCH // TRAIN_DATA,
        device_fwd_bwd_ms_per_sample=device_ms,
        bound_ms_per_sample=(train_2d_bound_ms_per_sample(cfg, r0)
                             if kind == "2d" else
                             train_1d_bound_ms_per_sample(p)),
        data_wait_s=[x["read_s"] for x in res],
        data_wait_share=[x["read_s"] / (x["read_s"] + sum(
            sum(r["step_s"]) for r in x["runs"])) for x in res],
        wall_s=wall, setup_s=[[r["setup_s"] for r in x["runs"]]
                              for x in res])
    if kind == "2d":
        stats.update(
            data_all_reduce_ms=[x["all_reduce_ms"] for x in res],
            data_all_reduce_gb=[x["all_reduce_gb"] for x in res])
    emit(phase=f"train_data_{kind}", **stats)
    return stats


def train_data_worker(rank, tmp):
    """One rank of ``train_data_phase`` (this file run with
    ``--train-data-rank``): the engine on the data mesh, its rows and block
    of the first batch held against the whole batch, and two runs of one
    dispatch step each, its launches counted; then the
    forward and backward timed and, for kind "2d", the data all-reduces of
    one step; results to rank<r>.json."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_config
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import ring as RING
    from repro_torch.kernels import wx as WX
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.models import weathermixer as W
    from repro_torch.train import step as STEP
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    meta = json.loads((tmp / "meta.json").read_text())
    kind, r0 = meta["kind"], meta["rollout"]
    p = 1 if kind == "2d" else TRAIN_1D_P
    runs = ([dict(zero1=False), dict(zero1=True)] if kind == "2d"
            else [dict(zero1=True, fsdp=False), dict(zero1=True, fsdp=True)])
    whole = torch.load(tmp / "batch.pt")
    prints = json.loads((tmp / "fingerprints.json").read_text())
    out = dict(runs=[])
    batch = kept = None
    for i, run in enumerate(runs):
        t0 = time.perf_counter()
        eng = TrainEngine(
            "weathermixer-1b", reduced=False, mesh_model=p,
            mesh_data=TRAIN_DATA, scheme=kind,
            impl="ring_fused" if kind == "1d" else None, device="cuda",
            config_override=get_config("weathermixer-1b").replace(
                shard_params_over_data=run.get("fsdp", False)),
            config=EngineConfig(steps=2, batch=TRAIN_BATCH,
                                precision="bf16", lr=1e-4, seed=0,
                                pipeline="sharded", prefetch=0,
                                telemetry=False, zero1=run["zero1"]))
        setup_s = time.perf_counter() - t0
        mesh, cfg, jcfg = eng.mesh, eng.cfg, eng.jcfg
        check(cfg.remat and cfg.kernel == "pallas" and cfg.n_layers == 3
              and mesh.data_size == TRAIN_DATA and mesh.model_size == p
              and jcfg.fsdp == run.get("fsdp", False)
              and dist.get_backend() == "gloo", "unexpected data config")
        if i == 0:
            key = "2d" if kind == "2d" else f"1d{mesh.r}"
            check([float(t.double().sum()) for t in ptree.leaves(eng.params)]
                  == prints[key], "train_data: the engine's weights are not "
                  "the train phase's")
            t1 = time.perf_counter()
            batch = eng.pipeline.get(0, r0)
            torch.cuda.synchronize()
            out["read_s"] = time.perf_counter() - t1
            out["block_equal"] = all(
                torch.equal(batch[k].cpu(), W.field_block(whole[k], cfg,
                                                          jcfg))
                for k in whole)
            out["read_bytes"] = eng.pipeline.stats.rank_bytes["fields"][
                mesh.rank]
            out["read_share"] = out["read_bytes"] / (
                whole["fields"].numel() * 4)
            del whole

        # -- the data path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in (BM.block_matmul, WX.wx, RING.ring_fwd, RING.ring_bwd):
            f.launches = 0
        WX.wx.layout_launches.clear()
        WX.reset_dx_terms()
        comm.through_host.clear()
        comm.through_host_bytes.clear()
        t1 = time.perf_counter()
        m1 = eng.dispatch(batch, r0)
        torch.cuda.synchronize()
        step_s = [time.perf_counter() - t1]
        rec = dict(launches=dict(wx=WX.wx.launches,
                                 wx_dx=WX.wx.layout_launches[True],
                                 block_matmul=BM.block_matmul.launches,
                                 ring_fwd=RING.ring_fwd.launches,
                                 ring_bwd=RING.ring_bwd.launches),
                   dx_terms=WX.dx_terms(),
                   through_host=dict(comm.through_host),
                   through_host_gb=sum(comm.through_host_bytes.values())
                   / 1e9)
        # ------------------------------------------------------------------
        leaves = ptree.leaves(eng.params)
        dims = (ptree.leaves(eng.zero1.dims) if eng.zero1 is not None
                else [None] * len(leaves))
        rec.update(
            loss=[float(m1["loss"])], grad_norm=[float(m1["grad_norm"])],
            step_s=step_s, setup_s=setup_s,
            # what a step record of these steps carries
            cost=[eng.cost_model.metrics(t, r0) for t in step_s],
            # the IPC slots are raw cudaMallocs, outside torch's allocator
            slots_gb=RING.workspace_bytes() / 1e9,
            peak_mem_gb=(torch.cuda.max_memory_allocated()
                         + RING.workspace_bytes()) / 1e9,
            opt_bytes=eng.opt_state_bytes(),
            residue_bytes=sum(
                t.numel() * t.element_size()
                for k in ("mu", "nu", "master") if k in eng.opt_state
                for t, dim in zip(ptree.leaves(eng.opt_state[k]), dims)
                if dim is None),
            weight_bytes=sum(
                t.numel() * t.element_size() for path, t in _paths(eng.params)
                if path[-1] == "w"))
        out["runs"].append(rec)
        if i == 0:
            # the forward and backward (every rank at once: the loss is
            # reduced over all of them) and, 2-D, the data all-reduces of
            # a step
            out["fwd_ms"], out["bwd_ms"] = fwd_bwd_ms(torch, eng.params,
                                                      batch, cfg, jcfg, r0)
            if kind == "2d":
                out["all_reduce_ms"], out["all_reduce_gb"] = \
                    timed_all_reduces(torch, comm, STEP, eng, batch, r0)
            kept = [t.cpu() for t in leaves]
        else:
            def same(a, b):
                if a.shape != b.shape:      # the FSDP hybrid's block of a
                    n = b.shape[0]
                    a = a.narrow(0, mesh.data_index * n, n)
                return torch.equal(a, b.cpu())
            out["params_equal"] = all(same(a, b)
                                      for a, b in zip(kept, leaves))
        eng.close()
        del eng, m1, leaves
        gc.collect()
        torch.cuda.empty_cache()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def _paths(tree):
    from repro_torch.core import tree as ptree
    found = []
    ptree.map_with_path(lambda path, t: found.append((path, t)), tree)
    return found


def timed_all_reduces(torch, comm, STEP, eng, batch, r0):
    """The host time of every all-reduce of one step's gradients and loss
    (each synchronised before and after; the step's own forward and
    backward not counted), and the bytes they sum."""
    real = comm.all_reduce_
    spent = [0.0, 0]

    def timed(x, *groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(x, *groups)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += x.numel() * x.element_size()
        return out
    comm.all_reduce_ = timed
    try:
        STEP.value_and_grad(eng.params, batch, eng.cfg, eng.jcfg, r0,
                            eng.param_specs)
    finally:
        comm.all_reduce_ = real
    return 1e3 * spent[0], spent[1] / 1e9


def ckpt_bytes(eng):
    """The bytes of a checkpoint of a one-device engine's params and
    optimizer state (every leaf once, the int32 step too)."""
    from repro_torch.core import tree as ptree
    from repro_torch.optim.adam import state_bytes
    return (sum(t.numel() * t.element_size()
                for t in ptree.leaves(eng.params))
            + state_bytes(eng.opt_state) + 4)


def ckpt_dir(part, need):
    """A fresh directory for one part of the ckpt phase under CKPT_ROOT,
    after checking that the disk has ``need`` bytes free (too little room
    fails the phase); returns (path, free bytes)."""
    import shutil
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    path = CKPT_ROOT / part
    shutil.rmtree(path, ignore_errors=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    check(free >= need, f"ckpt {part}: {free / 1e9:.1f} GB free under "
          f"{CKPT_ROOT}, the part writes {need / 1e9:.1f} GB")
    path.mkdir()
    return path, free


def ckpt_drop(path):
    """Remove a part's directory (and CKPT_ROOT once empty)."""
    import shutil
    shutil.rmtree(path, ignore_errors=True)
    try:
        CKPT_ROOT.rmdir()
    except OSError:
        pass


def manifest_bytes(path):
    """Every leaf's bytes in a checkpoint's manifest, each counted once."""
    import math
    from repro_torch.checkpoint import load_manifest
    from repro_torch.checkpoint.manifest import dtype_entry
    man = load_manifest(str(path))
    return sum(math.prod(e.shape) * dtype_entry(e.dtype)[1].itemsize
               for g in man.groups.values() for e in g.values())


def span_times(tracer, name):
    """[(start us, duration us)] of a tracer's spans named ``name``."""
    return [(e["ts"], e["dur"]) for e in tracer.chrome_events()
            if e.get("ph") == "X" and e["name"] == name]


def ckpt_serve_part(torch, eng, path, ranks, card):
    """Part (b) of the ckpt phase: the 2x2 mesh's checkpoint (its four
    ranks saved after their forward and backward, no update) served on
    one device by ``ForecastEngine(ckpt=)`` under the bf16 policy; its
    lead-1 forecast must equal, bit for bit, the forecast from the same
    seed-0 weights handed in whole (the train engine's, not yet
    updated)."""
    import numpy as np
    from repro_torch.serve.engine import ForecastEngine, ServeConfig
    total = manifest_bytes(path)
    per = [x["ckpt_bytes"] for x in ranks]
    check(sum(per) == total, f"ckpt 2x2: the ranks wrote {per} bytes, "
          f"the leaves hold {total}")
    check(all(abs(b - total / 4) <= 0.05 * total / 4 for b in per),
          f"ckpt 2x2: per-rank bytes {per} are not about {total / 4:.0f}")
    scfg = ServeConfig(buckets=(1,), precision="bf16", seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = ForecastEngine("weathermixer-1b", reduced=False, ckpt=str(path),
                            device="cuda", config=scfg)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(served.restored_step == 0, f"ckpt 2x2: restored step "
          f"{served.restored_step}, want 0")
    handed = ForecastEngine("weathermixer-1b", reduced=False,
                            params=eng.params, device="cuda", config=scfg)
    x = np.random.default_rng(0).standard_normal(
        served.field_shape, dtype=np.float32)
    outs = []
    for e in (served, handed):
        r = e.submit(x, 1)
        e.drain()
        outs.append(torch.from_numpy(r.outputs[1]))
    check(bool(torch.isfinite(outs[0]).all())
          and torch.equal(outs[0], outs[1]),
          "ckpt 2x2: the served checkpoint's lead-1 forecast differs from "
          "the forecast of the same weights handed in whole")
    del served, handed
    torch.cuda.empty_cache()
    return dict(card=card, bytes=total, bytes_per_rank=per,
                save_s_per_rank=[x["ckpt_save_s"] for x in ranks],
                write_gb_s=total / 1e9 / max(x["ckpt_save_s"]
                                             for x in ranks),
                serving_restore_s=restore_s, forecast_bitwise_equal=True,
                forecast_sha=sha(outs[0].numpy()))


def ckpt_inflight_steps(torch, eng, batch, r, need, reps=5):
    """One training step's wall time (host and device, synchronised) on
    the same batch without and with an async checkpoint write of the
    engine in flight (``eng.save``, 14 GB streamed by the writer thread
    while the steps run and update the params and optimizer state in
    place); then that checkpoint, restored to the card by itself (timed),
    must hold the state at the save bit for bit (``bit_fingerprint``) and
    its step.  The directory is removed at the end."""
    from repro_torch.checkpoint import io as ckio
    from repro_torch.checkpoint import load_manifest
    path, _ = ckpt_dir("inflight", need)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.dispatch(batch, r)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    try:
        idle = [timed() for _ in range(reps)]
        torch.cuda.synchronize()
        want = bit_fingerprint(torch, {"params": eng.params,
                                       "opt_state": eng.opt_state})
        step = eng.step_idx
        t0 = time.perf_counter()
        eng.save(str(path / "ck"), block=False)
        submit_s = time.perf_counter() - t0
        busy = []
        while len(busy) < reps and eng._writer.in_flight:
            busy.append(timed())
        eng.wait_checkpoints()
        write_s = time.perf_counter() - t0 - submit_s
        check(busy, "ckpt: the write ended before a step could run "
              "beside it")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = ckio.restore(str(path / "ck"),
                                      like_params=eng.params,
                                      like_opt=eng.opt_state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = bit_fingerprint(torch, {"params": params, "opt_state": opt})
        saved_step = load_manifest(str(path / "ck")).step
        del params, opt
        torch.cuda.empty_cache()
    finally:
        ckpt_drop(path)
    check(got == want and saved_step == step, f"ckpt: the checkpoint "
          f"written while {len(busy)} steps ran (step {saved_step}, want "
          f"{step}) does not restore the state at the save bit for bit")
    restored = ckpt_bytes(eng)
    return dict(rollout=r, step_s_idle=idle, step_s_write_in_flight=busy,
                ckpt_submit_s=submit_s, submit_to_written_s=write_s,
                steps_during_write=len(busy), restore_s=restore_s,
                restore_gb_s=restored / 1e9 / restore_s,
                restored_bitwise_equal=True)


def bit_fingerprint(torch, tree):
    """Each leaf's bits as two integers (the sum of its elements' bit
    patterns, and their sum weighted by position): equal trees give equal
    fingerprints, and a changed bit changes both sums.  Integer leaves as
    they are."""
    from repro_torch.core import tree as ptree
    out = []
    for t in ptree.leaves(tree):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        view = torch.int16 if t.element_size() == 2 else torch.int32
        bits = t.detach().contiguous().view(view).reshape(-1).to(torch.int64)
        pos = torch.arange(bits.numel(), device=bits.device) % 1000003 + 1
        out.append((int(bits.sum()), int((bits * pos).sum())))
        del bits, pos
    return out


def ckpt_resume_part(torch, BM, engine, hist, final, path, card):
    """Part (a) of the ckpt phase: the train phase's second run, with the
    chaos hook after step 0 (``preempt_at_step=0``), takes its final
    synchronous save at ``ck-0`` and stops (``Preempted``); its step 0
    must repeat the first run's bit for bit.  A fresh
    ``TrainEngine(resume=ck-0)`` (step 1, cursor 1) runs step 1, whose
    record must equal the first run's step 1 bit for bit, and ends with
    the first run's params and optimizer state bit for bit (``final``:
    their ``bit_fingerprint``)."""
    from repro_torch.checkpoint import checkpoint_complete
    from repro_torch.launch import resilience
    keys = ("loss", "grad_norm", "lr")
    eng2 = engine(ckpt=str(path / "ck"), preempt_at_step=0)
    try:
        eng2.run()
        check(False, "ckpt: the second run was not preempted after step 0")
    except resilience.Preempted as p:
        check(p.checkpoint == str(path / "ck-0"), f"ckpt: preempted with "
              f"{p.checkpoint}, want ck-0")
    torch.cuda.synchronize()
    hist2 = eng2.history
    same = ([tuple(h[k] for k in keys) for h in hist[:1]]
            == [tuple(h[k] for k in keys) for h in hist2])
    check(same, f"two runs of one seed differ (the second saving a "
          f"checkpoint): {hist[:1]} vs {hist2}")
    emit(phase="train_repeat", bitwise_equal=True,
         loss=[h["loss"] for h in hist2])
    check(checkpoint_complete(str(path / "ck-0")), "ckpt: ck-0 incomplete")
    saved = eng2.last_save.total_bytes
    submit = [d / 1e6 for _, d in span_times(eng2.tracer, "ckpt_submit")]
    writes = span_times(eng2.tracer, "ckpt.write")
    check(len(submit) == 1 and len(writes) == 1, f"ckpt: {len(submit)} "
          f"submits and {len(writes)} writes, want 1 each")
    del eng2
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng3 = engine(resume=str(path / "ck-0"))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(eng3.step_idx == 1 and eng3.pipeline.state() == {"cursor": 1}
          and eng3.opt_state["step"] == 1, f"resumed at step "
          f"{eng3.step_idx}, cursor {eng3.pipeline.state()}")
    # the resumed step: counts to 0 just before, read just after
    BM.block_matmul.launches = 0
    hist3 = eng3.run()
    torch.cuda.synchronize()
    launches = BM.block_matmul.launches
    r1 = int(eng3.r_sched[1])
    check(launches == 5 + 54 * r1, f"the resumed step made {launches} "
          f"block_matmul launches, want {5 + 54 * r1}")
    check(len(hist3) == 1 and all(hist3[0][k] == hist[1][k] for k in keys),
          f"resumed step 1 {hist3} differs from the first run's {hist[1]}")
    got = bit_fingerprint(torch, {"params": eng3.params,
                                  "opt_state": eng3.opt_state})
    check(got == final, "the resumed run's params and optimizer state "
          "differ from the first run's")
    del eng3
    torch.cuda.empty_cache()
    writes_s = [d / 1e6 for _, d in writes]
    return dict(card=card, bytes_per_save=saved, saves=1,
                final_save_submit_s=submit, final_save_write_s=writes_s,
                write_gb_s=[saved / 1e9 / w for w in writes_s],
                # the resumed engine's construction, the restore included
                # (the restore alone: steps_beside_a_write's restore_s)
                resume_engine_s=resume_s,
                resumed_rollout=r1,
                resumed_block_matmul_launches=launches,
                resumed_step_bitwise_equal=True,
                final_state_bitwise_equal=True)


PREEMPT_AT = 0          # the chaos hook's step: the first child stops after it


def preempt_child(out, argv):
    """One child of the preempt phase (this file run with
    ``--preempt-child out args...``): the training CLI,
    ``repro_torch.launch.train.main(args)``, then its exit code, its
    block_matmul launches (counted from 0 in this fresh process), and its
    tracer's step spans and preemption events with the exit's time, on
    the host's monotonic clock (``perf_counter_ns``, shared by the
    processes of one machine), into the JSON file ``out``."""
    sys.path.insert(0, str(SRC))
    from repro_torch import telemetry
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.launch import train
    code = 0
    try:
        train.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    exit_ns = time.perf_counter_ns()
    tr = telemetry.get_tracer()
    events = [dict(name=e["name"], t_ns=tr.t0_ns + int(e["ts"] * 1e3),
                   dur_ns=int(e.get("dur", 0) * 1e3), args=e.get("args"))
              for e in tr.chrome_events() if e.get("ph") in ("X", "i")
              and (e["name"] == "step" or e["name"].startswith("preempt."))]
    Path(out).write_text(json.dumps(dict(
        code=code, block_matmul_launches=BM.block_matmul.launches,
        exit_ns=exit_ns, events=events)))
    return code


def preempt_phase(torch, hist, sched, path, card):
    """The resilience path at full width: ``resilience.Supervisor`` runs
    the training CLI (``--full --precision bf16``, the train phase's
    seed, batch, rollout, lr and steps) as child processes with
    ``REPRO_PREEMPT_AT_STEP=0``.  Child 0 signals itself after step 0,
    takes a final synchronous save at ``ck-0`` and exits 75; the
    supervisor relaunches at once with ``--resume ck-0``; child 1 runs
    the remaining steps and saves ``ck``.  The children's (loss, lr,
    grad_norm) must equal the train phase's history bit for bit."""
    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import checkpoint_complete, latest_checkpoint
    from repro_torch.launch import resilience
    env = dict(os.environ, **{resilience.PREEMPT_ENV: str(PREEMPT_AT)})
    launched_ns = []

    def build(resume, attempt):
        return ([sys.executable, str(Path(__file__).resolve()),
                 "--preempt-child", str(path / f"c{attempt}.json"),
                 "--full", "--precision", "bf16", "--batch", str(TRAIN_BATCH),
                 "--rollout", str(TRAIN_ROLLOUT), "--lr", "1e-4",
                 "--log-every", "1", "--seed", "0", "--steps",
                 str(TRAIN_STEPS), "--ckpt", str(path / "ck"),
                 "--metrics-out", str(path / f"m{attempt}.jsonl")]
                + (["--resume", resume] if resume else []))

    def run_cmd(argv):
        n = len(launched_ns)
        with open(path / f"c{n}.log", "w") as log:
            launched_ns.append(time.perf_counter_ns())
            return subprocess.call(argv, env=env, stdout=log,
                                   stderr=subprocess.STDOUT, timeout=900)

    def logs():
        return "".join((path / f"c{n}.log").read_text()[-3000:]
                       for n in range(len(launched_ns)))

    t0 = time.perf_counter()
    sup = resilience.Supervisor(build, ckpt_root=str(path), prefix="ck",
                                max_restarts=1, env=env, run_cmd=run_cmd)
    rc = sup.run()
    wall = time.perf_counter() - t0
    check(rc == 0 and sup.attempts == [resilience.RESUMABLE_EXIT_CODE, 0],
          f"preempt: exit codes {sup.attempts}, want [75, 0]:\n{logs()}")
    check(sup.resumes == [None, str(path / f"ck-{PREEMPT_AT}")]
          and sup.backoffs == [], f"preempt: resumes {sup.resumes}, "
          f"backoffs {sup.backoffs}")
    kids = [json.loads((path / f"c{n}.json").read_text()) for n in (0, 1)]
    logged = [[json.loads(x) for x in (path / f"m{n}.jsonl").read_text()
               .splitlines() if x.strip()] for n in (0, 1)]
    want_steps = [[0], list(range(1, TRAIN_STEPS))]
    check([[h["step"] for h in m] for m in logged] == want_steps,
          f"preempt: the children logged steps "
          f"{[[h['step'] for h in m] for m in logged]}, want {want_steps}")
    keys = ("loss", "lr", "grad_norm")
    got = [tuple(h[k] for k in keys) for h in logged[0] + logged[1]]
    want = [tuple(h[k] for k in keys) for h in hist]
    check(got == want, f"preempt: the supervised history {got} is not the "
          f"train phase's {want} bit for bit")
    ck0 = path / f"ck-{PREEMPT_AT}"
    check(checkpoint_complete(str(ck0))
          and latest_checkpoint(str(path), prefix="ck") == str(path / "ck"),
          "preempt: ck-0 incomplete or not outranked by the final ck")
    launches = [k["block_matmul_launches"] for k in kids]
    want_l = [5 + 54 * sched[0], sum(5 + 54 * r for r in sched[1:])]
    check(launches == want_l, f"preempt: the children made {launches} "
          f"block_matmul launches, want {want_l}")

    def first(kid, name):
        return next(e for e in kid["events"] if e["name"] == name)
    sigterm = first(kids[0], "preempt.chaos_sigterm")
    final = first(kids[0], "preempt.final_save")
    step1 = first(kids[1], "step")
    return dict(
        card=card, wall_s=wall, attempts=sup.attempts,
        resumes=[r and Path(r).name for r in sup.resumes],
        history_bitwise_equal=True, bytes_per_save=manifest_bytes(ck0),
        final_save_s=final["args"]["dur_s"],
        signal_to_exit_s=(kids[0]["exit_ns"] - sigterm["t_ns"]) / 1e9,
        relaunch_to_first_step_s=(step1["t_ns"] + step1["dur_ns"]
                                  - launched_ns[1]) / 1e9,
        child_wall_s=[(k["exit_ns"] - t) / 1e9
                      for k, t in zip(kids, launched_ns)],
        block_matmul_launches=launches)


RECORD_KEYS = ("step", "rollout", "dur_s", "data_wait_s", "mfu",
               "achieved_tflops", "comm_fraction", "through_host_bytes")


def train_cost_part(eng, recs, cfg):
    """The train run's step records (``mfu``, ``achieved_tflops``,
    ``comm_fraction`` from the engine's cost model), ``trace_report``'s
    ``--check`` and verdict on its JSONL, and the cost model's FLOPs
    beside this file's own floor count."""
    import shutil
    import tempfile
    from repro_torch.launch import trace_report as TR
    check(recs and all(0 < r["mfu"] <= 1 and r["achieved_tflops"] > 0
                       and 0 <= r["comm_fraction"] <= 1 for r in recs),
          f"train step records' derived fields: {recs}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    try:
        path = str(tmp / "train.trace.jsonl")
        eng.tracer.export_jsonl(path)
        meta, steps, *_ = TR.split_records(TR.load_records(path))
        fails = TR.check(meta, steps)
        verdict = TR.verdict(TR.attribution(meta, steps))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not fails, f"trace_report --check on the train run: {fails}")
    cm = eng.cost_model
    return dict(
        records=[{k: r.get(k) for k in RECORD_KEYS} for r in recs],
        trace_check="OK", verdict=verdict,
        peak_flops=cm.peak_flops, link_bw=cm.link_bw,
        flops_per_sample_step=cm.flops_per_step / cm.batch,
        floor_flops_per_sample_step=train_flops_per_sample(cfg, 1),
        # the cost model (the reference's) counts 4 forwards of every
        # linear: forward, backward twice, the remat re-forward, the
        # encoder and decoder too, and dx of the encoder's input; the
        # floor counts the launches the path runs: remat per block only,
        # no dx of the input, and each block's two GELU pre-activation
        # recomputes: + 3 encoder-sized GEMMs, - 3 (tok_fc + ch_fc)
        difference="+3 encoder GEMMs (remat of encoder and decoder, dx "
                   "of the input) - 3 x (tok + ch GELU recomputes)")


def train_phase(torch, BM, WX, card, serve_handoff):
    import dataclasses
    import math
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import value_and_grad

    # lr: the paper's base rate (optim/schedule.py's default)
    ecfg = EngineConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                        rollout=TRAIN_ROLLOUT, precision="bf16", lr=1e-4,
                        log_every=1, seed=0)

    def engine(**kw):
        return TrainEngine("weathermixer-1b", reduced=False, device="cuda",
                           config=dataclasses.replace(ecfg, **kw))

    t0 = time.perf_counter()
    eng = engine()
    setup_s = time.perf_counter() - t0
    cfg = eng.cfg
    check(cfg.remat and cfg.kernel == "pallas" and cfg.n_layers == 3,
          f"unexpected training config: remat={cfg.remat} "
          f"kernel={cfg.kernel} n_layers={cfg.n_layers}")

    # the first step against kernel="xla" on the same batch and weights
    r0 = int(eng.r_sched[0])
    t0 = time.perf_counter()
    batch0 = eng.pipeline.get(0, r0)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    mk, gk = value_and_grad(eng.params, batch0, cfg, eng.jcfg, r0)
    mx, gx = value_and_grad(eng.params, batch0, cfg,
                            eng.jcfg.replace(kernel="xla"), r0)
    lk, lx = float(mk["loss"]), float(mx["loss"])
    nk, nx = float(global_norm(gk)), float(global_norm(gx))
    leaf_err = leaf_rel_err(torch, gk, gx)
    first = dict(rollout=r0, loss=lk, loss_xla=lx,
                 loss_rel_err=abs(lk - lx) / abs(lx), grad_norm=nk,
                 grad_norm_xla=nx, grad_norm_rel_err=abs(nk - nx) / nx,
                 max_leaf_rel_err=leaf_err, tol=TRAIN_TOL)
    check(first["loss_rel_err"] <= TRAIN_TOL
          and first["grad_norm_rel_err"] <= TRAIN_TOL
          and leaf_err <= TRAIN_TOL,
          f"first training step vs kernel='xla': {first}")
    del gx
    torch.cuda.empty_cache()
    # the 2-D path on the same weights and batch, before the run moves them
    stats_2d = train_2d_phase(torch, BM, WX, eng, batch0, r0, mk, gk)
    stats_1d = train_1d_phase(torch, eng, batch0, r0, mk, gk)
    need = 1.05 * ckpt_bytes(eng)
    stats_2dm, ckpt_b, serve_data = train_2d_mesh_phase(
        torch, eng, batch0, r0, mk, gk, need, card, serve_handoff)
    handoff = data_handoff(torch, eng, batch0)
    none_loss, none_norm = float(mk["loss"]), float(global_norm(gk))
    del gk
    torch.cuda.empty_cache()

    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    BM.block_matmul.layout_launches.clear()
    BM.block_matmul.route_launches.clear()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BM.block_matmul.launches
    by_layout = dict(BM.block_matmul.layout_launches)
    routes = dict(BM.block_matmul.route_launches)
    peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------
    # the run's final state, before the timing steps below move it
    final = bit_fingerprint(torch, {"params": eng.params,
                                    "opt_state": eng.opt_state})

    sched = [int(r) for r in eng.r_sched]
    want = sum(5 + 54 * r for r in sched) * ecfg.accum
    check(launches == want, f"{launches} kernel launches in training steps "
          f"with rollouts {sched} (want {want}: 5 + 54 r per step)")
    # forward + remat + GELU recompute 2 + 30 r, dx 1 + 12 r, dw 2 + 12 r
    layouts = {"x,w": by_layout.get((False, False), 0),
               "x,w.T (dx)": by_layout.get((False, True), 0),
               "x.T,w.T (dw)": by_layout.get((True, True), 0)}
    want_layouts = {"x,w": sum(2 + 30 * r for r in sched) * ecfg.accum,
                    "x,w.T (dx)": sum(1 + 12 * r for r in sched) * ecfg.accum,
                    "x.T,w.T (dw)": sum(2 + 12 * r for r in sched)
                    * ecfg.accum}
    check(layouts == want_layouts and sum(by_layout.values()) == launches,
          f"training launches by operand layout {by_layout}, want "
          f"{want_layouts}")
    check(routes == {"sm90": launches}, f"training launches by route "
          f"{routes}: every GEMM of the step is at least 64 wide")
    check(peak < PEAK_MEM_LIMIT, f"training peak memory {peak / 1e9:.2f} GB")
    check(len(hist) == TRAIN_STEPS
          and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                  for h in hist), f"bad training history {hist}")
    recs = eng.tracer.step_records()
    cost = train_cost_part(eng, recs, cfg)
    wait_s = sum(r["data_wait_s"] for r in recs)
    step_ms = {}
    for r in sorted(set(sched)):
        got = [1e3 * (x["dur_s"] - x["data_wait_s"]) for x in recs
               if x["rollout"] == r]
        step_ms[r] = sum(got) / len(got)
    # device time of one step at each rollout length (CUDA events; these
    # updates come after the run and are not part of it)
    device_ms = {r: cuda_ms(lambda r=r: eng.dispatch(batch0, r), 1)
                 for r in range(1, TRAIN_ROLLOUT + 1)}
    # of which forward + backward (the rest: grad norm, clip, Adam)
    fwd_bwd_ms = {r: cuda_ms(lambda r=r: value_and_grad(
        eng.params, batch0, cfg, eng.jcfg, r), 1)
        for r in range(1, TRAIN_ROLLOUT + 1)}
    bound_ms = {r: 1e3 * train_flops_per_sample(cfg, r)
                / PEAK_FLOPS["bfloat16"] for r in device_ms}
    inflight = ckpt_inflight_steps(torch, eng, batch0, r0, need)
    stats = dict(
        params=cfg.param_count(), batch=TRAIN_BATCH, steps=TRAIN_STEPS,
        rollout_schedule=sched, setup_s=setup_s, batch_host_s=batch_s,
        first_step_vs_xla=first, wall_s=wall, kernel_launches=launches,
        launches_per_step=[5 + 54 * r for r in sched],
        launches_by_layout=layouts, launches_by_route=routes,
        loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        lr=[h["lr"] for h in hist],
        step_ms_by_rollout=step_ms, device_step_ms_by_rollout=device_ms,
        device_fwd_bwd_ms_by_rollout=fwd_bwd_ms,
        device_ms_per_sample_step={r: v / TRAIN_BATCH
                                   for r, v in device_ms.items()},
        bound_ms_per_sample_step=bound_ms,
        data_wait_s=wait_s,
        data_wait_share=wait_s / sum(r["dur_s"] for r in recs),
        peak_mem_gb=peak / 1e9, cost_model=cost)
    emit(phase="train", **stats)
    del eng, batch0
    torch.cuda.empty_cache()

    # the same seed again, stopped after step 0 with a checkpoint: step 0
    # must repeat bit for bit; then the resume from that checkpoint
    path, free = ckpt_dir("resume", need)
    try:
        ckpt_a = ckpt_resume_part(torch, BM, engine, hist, final, path,
                                  card)
    finally:
        ckpt_drop(path)
    emit(phase="ckpt", disk_free_gb=free / 1e9, resume=ckpt_a,
         steps_beside_a_write=inflight, serve_2x2=ckpt_b)
    torch.cuda.empty_cache()

    # the supervised, preempted and resumed run in child processes
    path, free = ckpt_dir("preempt", 2 * need)
    try:
        pre = preempt_phase(torch, hist, sched, path, card)
    finally:
        ckpt_drop(path)
    emit(phase="preempt", disk_free_gb=free / 1e9, **pre)

    # the data-parallel phases, with this process's engines freed
    import shutil
    try:
        t0 = time.perf_counter()
        stats_d = {kind: train_data_phase(torch, kind, handoff, r0,
                                          none_loss, none_norm, cfg)
                   for kind in ("2d", "1d")}
        emit(phase="train_data", wall_s=time.perf_counter() - t0)
    finally:
        shutil.rmtree(handoff, ignore_errors=True)
    return (launches, stats, stats_2d, stats_1d, stats_2dm, stats_d, ckpt_a,
            pre, serve_data)


# ---------------------------------------------------------------------------
# phases 10-12: the transformer family (dense): h2o-danube-1.8b whole, and
# gemma3-27b at full width cut in depth
# ---------------------------------------------------------------------------

# h2o-danube-1.8b as published (24 layers, d_model 2560, 32 heads of 80, 8
# KV heads, SwiGLU d_ff 6912, vocab 32,000, untied head, sliding window
# 4096 on every layer; 1,831,201,280 parameters, 3.7 GB in bf16): the
# forward at sequence 4608 and batch 2, so the window masks the last 512
# positions; generate at batch 4 from 4,160-token prompts (past the
# window: the rolling cache's 4,096 slots wrap) with 32 new tokens; the
# fused prefill against the token-wise one on 64-token prompts
DENSE_ARCH, DENSE_SEQ, DENSE_BATCH = "h2o-danube-1.8b", 4608, 2
DENSE_GEN_BATCH, DENSE_GEN_PROMPT, DENSE_GEN_STEPS = 4, 4160, 32
DENSE_PARITY_PROMPT = 64
# gemma3-27b at its published width (d_model 5376, 32 heads of 128, 16 KV
# heads, qk_norm, GELU FFN 21,504, local window 1024, tied 262,144 vocab),
# cut in depth from 62 layers to 8: one whole 5:1 local:global period and
# the 2-layer leftover, standing for the published 62 = 10 * 6 + 2 (about
# 3.8 B parameters, 7.6 GB in bf16).  Batch 2, 64-token prompts prefilled
# token by token through the captured step (the reference has no fused
# prefill for a local:global stack), 16 new tokens
GEMMA_ARCH, GEMMA_LAYERS = "gemma3-27b", 8
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_STEPS = 2, 64, 16
# Tolerances, judged in f32 (the seed's bf16 weights up-cast, TF32 off):
# the forward's logits kernel="pallas" against kernel="xla" max|a - b| /
# max|b| 1e-3 (as mamba's: only summation orders differ); token-wise
# decode against the teacher-forced forward elementwise at the
# reference's 5e-3 (tests/test_decode_consistency.py); the fused prefill
# against the token-wise one at the reference's test_fused_prefill_parity
# bounds (the next tokens equal, the f32 caches rtol 5e-3 / atol 1e-4).
# The bf16 forward against the f32 one by mean|a - b| / mean|b| 0.1, a
# gross-fault check: a random-weight bf16 residual stream amplifies
# rounding through the layers (1.7 % for h2o's 24 layers and 0.8 % for
# gemma3's 8 at narrower widths on the CPU; zeros or a wrong layout give
# ~100 %).
DENSE_F32_TOL = 1e-3
DENSE_DECODE_TOL = 5e-3
DENSE_BF16_TOL = 0.1
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-4


def _ffn_shapes(cfg, d):
    """(name, K, N, epilogue, dtype name) of a dense FFN's linears."""
    if cfg.ffn_kind == "swiglu":
        return [("gate", d, cfg.d_ff, "none", "bfloat16"),
                ("up", d, cfg.d_ff, "none", "bfloat16"),
                ("down", cfg.d_ff, d, "none", "bfloat16")]
    return [("fc1", d, cfg.d_ff, "gelu", "bfloat16"),
            ("fc2", cfg.d_ff, d, "none", "bfloat16")]


def lm_gemm_shapes(cfg, tag, m):
    """(label, M, K, N, epilogue, launches per forward or decode step,
    dtype name) of a language model's block_matmul launches at M rows: a
    transformer layer's q, k, v, o and its FFN's linears, or a MoE layer's
    router (f32: the reference routes ``x.astype(float32)`` on f32 router
    weights, and the configs' legacy policy casts nothing); a hybrid
    period's slots (an SSM slot's in_z, in_xbc, in_dt and out_proj, the
    attention slot's q, k, v, o, then each slot's dense FFN or router)
    over the periods; and the head.  Shapes shared by several slots are
    one row with their launches summed.  Whisper's (audio) are those of a
    decode step at M rows (``audio_gemm_shapes``)."""
    if cfg.family == "audio":
        return audio_gemm_shapes(cfg, tag, m, 1)
    d, hd = cfg.d_model, cfg.d_head
    qo, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = [("q", d, qo, "none", "bfloat16"), ("k", d, kv, "none", "bfloat16"),
            ("v", d, kv, "none", "bfloat16"), ("o", qo, d, "none", "bfloat16")]
    router = [("router", d, cfg.n_experts, "none", "float32")]
    if cfg.family == "hybrid":
        di = cfg.ssm_d_inner
        ssm = [("in_z", d, di, "none", "bfloat16"),
               ("in_xbc", d, di + 2 * cfg.ssm_groups * cfg.ssm_state, "none",
                "bfloat16"),
               ("in_dt", d, cfg.ssm_heads, "none", "bfloat16"),
               ("out_proj", di, d, "none", "bfloat16")]
        per = {}
        for j in range(cfg.attn_every):
            mixer = attn if cfg.is_attn_layer(j) else ssm
            ffn = router if cfg.is_moe_layer(j) else _ffn_shapes(cfg, d)
            for shape in mixer + ffn:
                per[shape] = per.get(shape, 0) + cfg.n_layers // cfg.attn_every
        per = list(per.items())
    else:
        ffn = router if cfg.is_moe_layer(0) else _ffn_shapes(cfg, d)
        per = [(shape, cfg.n_layers) for shape in attn + ffn]
    out = [(f"{tag}.{name}", m, k, n, epi, count, dt)
           for (name, k, n, epi, dt), count in per]
    return out + [(f"{tag}.head", m, d, cfg.vocab_padded, "none", 1,
                   "bfloat16")]


def lm_per_step(cfg):
    """block_matmul launches of one forward or decode step."""
    return sum(r[5] for r in lm_gemm_shapes(cfg, "", 1))


def lm_routes(cfg, m):
    """block_matmul's launches by route of one forward or decode step at M
    rows (the MoE router's M: the tokens, padded to whole groups)."""
    import torch
    from repro_torch.kernels import block_matmul as BM
    out = {}
    for _, mm, _, n, _, count, dt in lm_gemm_shapes(cfg, "", m):
        rt = BM.route(mm, n, getattr(torch, dt))
        out[rt] = out.get(rt, 0) + count
    return out


def per_rows(rows, key):
    """The sum over a path's GEMM rows of ``key`` times the row's launches
    per path (the WMMA loop's rows have no ``wmma_ms``: their own time)."""
    return sum(r.get(key, r["kernel_ms"]) * r["per_path"] for r in rows)


def dense_setup(torch, arch, f32=True, **over):
    """The config (``over`` replacing fields of the published one), the
    one-device kernel config, seed-0 bf16 weights on the card, and (where
    ``f32``) the same weights in f32 with their config (else None,
    None)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import JigsawConfig
    from repro_torch.models import registry as M
    cfg = get_config(arch).replace(**over)
    jcfg = JigsawConfig(scheme="none", kernel="pallas")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg32, params32 = mamba_f32(torch, cfg, params) if f32 else (None, None)
    extra = {}
    if cfg.n_experts:
        extra.update(n_experts=cfg.n_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor)
    if cfg.family == "hybrid":
        extra.update(attn_every=cfg.attn_every, attn_offset=cfg.attn_offset,
                     moe_every=cfg.moe_every, ssm_heads=cfg.ssm_heads,
                     ssm_groups=cfg.ssm_groups, ssm_state=cfg.ssm_state)
    emit(phase=f"{cfg.family}_setup", arch=arch, params=cfg.param_count(),
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
         n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
         vocab_padded=cfg.vocab_padded, param_dtype=cfg.param_dtype,
         windows=sorted(set(map(str, (cfg.layer_window(i)
                                      for i in range(cfg.n_layers))))),
         cut=over, f32_copy=f32, **extra, init_s=init_s,
         mem_gb=torch.cuda.memory_allocated() / 1e9)
    return cfg, jcfg, params, cfg32, params32


def dense_forward_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                        cfg32, params32):
    """h2o-danube-1.8b's forward: 169 block_matmul launches, all on the
    Hopper loop; then in f32 pallas against xla, bf16 against f32, and
    the window against no window."""
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16, flops_forward
    from repro_torch.models import registry as M
    batch = {"tokens": token_rows(torch, cfg, DENSE_SEQ, DENSE_BATCH, 0)}
    per = lm_per_step(cfg)
    with torch.no_grad():
        # -- the main path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        logits, _ = M.apply(params, batch, cfg, jcfg)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        routes = read_routes(kernels)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # ------------------------------------------------------------------
        check(launches["block_matmul"] == per
              and sum(launches.values()) == per,
              f"dense forward launches {launches} (want {per} block_matmul)")
        check(routes == {"sm90": per}, f"dense forward routes {routes}")
        check(tuple(logits.shape) == (DENSE_BATCH, DENSE_SEQ,
                                      cfg.vocab_padded)
              and bool(torch.isfinite(logits).all()),
              f"dense logits {tuple(logits.shape)} not finite or misshapen")
        ms = cuda_ms(lambda: M.apply(params, batch, cfg, jcfg), 3)

        # f32: pallas against xla; bf16 against f32; the window's effect
        ref32, _ = M.apply(params32, batch, cfg32, jcfg)
        bf16_err = mean_rel(logits.float(), ref32)
        bf16_top1 = float((logits.float().argmax(-1)
                           == ref32.argmax(-1)).float().mean())
        del logits
        xla, _ = M.apply(params32, batch, cfg32, jcfg.replace(kernel="xla"))
        xla_err = rel_err(ref32, xla)
        del xla
        full, _ = M.apply(params32, batch,
                          cfg32.replace(sliding_window=None), jcfg)
        w = cfg.sliding_window
        # inside the window the two forwards are the same arithmetic; per
        # position past it, the largest change over the vocab
        inside = float((full[:, :w] - ref32[:, :w]).abs().max())
        moved = (full[:, w:] - ref32[:, w:]).abs().amax(dim=-1)
        del full, ref32
    torch.cuda.empty_cache()
    check(xla_err <= DENSE_F32_TOL,
          f"dense f32 logits, pallas vs xla: {xla_err:.3e}")
    check(bf16_err <= DENSE_BF16_TOL,
          f"dense bf16 logits vs f32: {bf16_err:.3e} of the mean")
    check(bool((moved > 10 * inside).all()),
          f"dense f32 logits past position {w}: "
          f"{int((moved <= 10 * inside).sum())} positions within ten times "
          f"the inside difference ({inside:.3e}) of the unwindowed "
          "forward's (the window took no effect)")
    flops = flops_forward(cfg, DENSE_BATCH, DENSE_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "h2o.fwd", DENSE_BATCH * DENSE_SEQ))
    tokens = DENSE_SEQ * DENSE_BATCH
    out = dict(seq=DENSE_SEQ, batch=DENSE_BATCH, launches=launches,
               block_matmul_routes=routes, ms_per_forward=ms,
               tokens_per_s=tokens / (ms / 1e3), peak_mem_gb=peak_gb,
               flops=flops, flops_total=sum(flops.values()),
               floor_ms=1e3 * sum(flops.values()) / PEAK_FLOPS_BF16,
               block_matmul_ms=per_rows(rows, "kernel_ms"),
               block_matmul_bound_ms=per_rows(rows, "bound_ms"),
               block_matmul_library_ms=per_rows(rows, "library_ms"),
               block_matmul_plain_ms=per_rows(rows, "plain_ms"),
               f32_vs_xla=xla_err, tol_f32=DENSE_F32_TOL,
               bf16_vs_f32_mean=bf16_err, tol_bf16_mean=DENSE_BF16_TOL,
               bf16_vs_f32_top1_agree=bf16_top1, window=w,
               window_inside_max_abs=inside,
               window_min_change_past=float(moved.min()))
    emit(phase="dense_forward", arch=cfg.arch_id, **out)
    return out, rows, worst


def lm_graph_runs(torch, kernels, cfg, jcfg, params, prompts, steps,
                  max_len, fused, what, extra_batch=None):
    """``generate`` through the captured decode step (captured before the
    counted run), then eagerly: the tokens equal, ``lm_per_step``
    launches a step in both (a fused prefill's forward is one step; the
    graphed steps counted by replay) on the routes ``lm_routes`` gives
    (the decode steps' M = batch rows, a fused prefill's M = batch x
    prompt), no capture in the counted run.  With ``extra_batch`` (the
    audio family's frames) each ``generate`` also runs the encoder once,
    eagerly, on the Hopper loop.
    Returns the tokens and a dict of counts and times."""
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    b, s = prompts.shape
    t0 = time.perf_counter()
    g0 = S.graph_serve_step(params, cfg, jcfg, M.init_cache(
        cfg, b, max_len, dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    out = S.generate(params, prompts, cfg, jcfg, steps=steps,
                     max_len=max_len, extra_batch=extra_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    routes = read_routes(kernels)
    # ----------------------------------------------------------------------
    graphs = list(S._GRAPHS.values())
    zero_counts(kernels)
    t0 = time.perf_counter()
    out_eager = S.generate(params, prompts, cfg, jcfg, steps=steps,
                           max_len=max_len, extra_batch=extra_batch,
                           graph=False)
    torch.cuda.synchronize()
    wall_eager = time.perf_counter() - t0
    launches_eager = read_counts(kernels)
    per = lm_per_step(cfg)
    n_steps = steps if fused else s + steps - 1
    enc = audio_encode_launches(cfg) if extra_batch is not None else 0
    check(graphs == [g0], f"{what}: {len(graphs)} captured steps after the "
          "counted run, want the one captured before it")
    for mode, n in (("graphed", launches), ("eager", launches_eager)):
        check(n["block_matmul"] == n_steps * per + enc
              and sum(n.values()) == n_steps * per + enc,
              f"{what} {mode} launches {n} (want {per} block_matmul a "
              f"step, {n_steps} steps, {enc} for the encoder)")
    want_routes = {rt: n * (n_steps - fused)
                   for rt, n in lm_routes(cfg, b).items()}
    if enc:
        want_routes["sm90"] = want_routes.get("sm90", 0) + enc
    if fused:
        for rt, n in lm_routes(cfg, b * s).items():
            want_routes[rt] = want_routes.get(rt, 0) + n
    check(routes == want_routes, f"{what} routes {routes}, want "
          f"{want_routes}")
    check(tuple(out.shape) == (b, steps)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{what} tokens {tuple(out.shape)} out of range")
    check(torch.equal(out, out_eager), f"{what}: the graphed tokens "
          f"{out[0, :8].tolist()} differ from the eager ones "
          f"{out_eager[0, :8].tolist()}")
    return out, dict(launches=launches, launches_eager=launches_eager,
                     block_matmul_routes=routes,
                     block_matmul_per_step=(launches["block_matmul"] - enc)
                     / n_steps, steps_counted=n_steps,
                     graphed_equals_eager=True, captures=len(graphs),
                     capture_s=capture_s, wall_s=wall,
                     wall_s_eager=wall_eager)


def lm_step_times(torch, cfg, jcfg, params, cache, nxt):
    """A decode step's device and host ms, eager, then graphed, on
    ``cache`` (written in place by both)."""
    from repro_torch.serve import step as S
    with torch.no_grad():
        step = S.make_serve_step(cfg, jcfg)
        eager = decode_step_times(torch, lambda: step(params, cache, nxt))
        g = S.graph_serve_step(params, cfg, jcfg, cache)
        g.tokens_in.copy_(nxt)
        graphed = decode_step_times(torch, g.replay)
    return dict(device_ms_per_decode_step=graphed[0],
                host_ms_per_decode_step=graphed[1],
                device_ms_per_decode_step_eager=eager[0],
                host_ms_per_decode_step_eager=eager[1])


def decode_bound(torch, cfg, cache, rows, expert_bytes=0):
    """A decode step's least time: its linears' weights (the GEMM rows'
    bounds: bytes at M = batch rows), the experts' weights of its MoE
    layers (``expert_bytes``: every expert's, since the capacity dispatch
    runs every expert) and the cache read once at the card's memory rate,
    and block_matmul's part of it."""
    from repro_torch.core import tree as ptree
    leaves = [("/".join(map(str, path)), t)
              for path, t in ptree.leaves_with_path(cache)
              if path != ("pos",)]
    cache_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    gemm = per_rows(rows, "bound_ms")
    out = dict(cache_shapes={k: list(t.shape) for k, t in leaves},
               kv_cache_bytes=cache_bytes,
               step_bound_ms=gemm + 1e3 * (cache_bytes + expert_bytes)
               / PEAK_BYTES,
               block_matmul_ms=per_rows(rows, "kernel_ms"),
               block_matmul_bound_ms=gemm,
               block_matmul_library_ms=per_rows(rows, "library_ms"),
               block_matmul_plain_ms=per_rows(rows, "plain_ms"))
    if expert_bytes:
        out["expert_bytes"] = expert_bytes
    return out


def dense_generate_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                         cfg32, params32):
    """h2o-danube-1.8b's ``generate``: the fused prefill of 4,160-token
    prompts, then the captured decode step on the 4,096-slot rolling
    cache; eager; the decode logits against the teacher-forced forward
    (f32); the fused prefill against the token-wise one (f32)."""
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    prompts = token_rows(torch, cfg, DENSE_GEN_PROMPT, DENSE_GEN_BATCH, 1)
    max_len = DENSE_GEN_PROMPT + DENSE_GEN_STEPS
    out, runs = lm_graph_runs(torch, kernels, cfg, jcfg, params, prompts,
                              DENSE_GEN_STEPS, max_len, True,
                              "dense generate")
    with torch.no_grad():
        # the decode logits along the generated tokens, from a fused f32
        # prefill, against the teacher-forced f32 forward of prompt +
        # output
        logits, cache = M.prefill_cache(params32, {"tokens": prompts},
                                        cfg32, jcfg, max_len,
                                        dtype=torch.float32)
        got = [logits[:, -1]]
        del logits
        for i in range(1, DENSE_GEN_STEPS):
            lg, cache = M.decode_step(params32, cache, out[:, i - 1:i],
                                      cfg32, jcfg)
            got.append(lg[:, 0])
        del cache
        got = torch.stack(got, 1)
        seq = torch.cat([prompts, out[:, :-1]], dim=1)
        want, _ = M.apply(params32, {"tokens": seq}, cfg32, jcfg)
        want = want[:, DENSE_GEN_PROMPT - 1:].contiguous()
        err32 = (got - want).abs()
        decode_ok = bool((err32 <= DENSE_DECODE_TOL
                          + DENSE_DECODE_TOL * want.abs()).all())
        decode_err = float(err32.max())
        del got, want, err32
        torch.cuda.empty_cache()
        check(decode_ok, f"dense f32 decode vs teacher-forced: max abs "
                         f"{decode_err:.3e}")
        # the fused prefill against the token-wise one (64-token prompts)
        short = prompts[:, :DENSE_PARITY_PROMPT]
        n_f, c_f = S.prefill(params32, short, cfg32, jcfg,
                             2 * DENSE_PARITY_PROMPT,
                             cache_dtype=torch.float32, fused=True)
        n_t, c_t = S.prefill_tokenwise(params32, short, cfg32, jcfg,
                                       2 * DENSE_PARITY_PROMPT,
                                       cache_dtype=torch.float32)
        parity = {k: float((c_f[k] - c_t[k]).abs().max()) for k in "kv"}
        parity_ok = torch.equal(n_f, n_t) and torch.equal(
            c_f["pos"], c_t["pos"]) and all(
            torch.allclose(c_f[k], c_t[k], rtol=PARITY_RTOL,
                           atol=PARITY_ATOL) for k in "kv")
        del c_f, c_t
        check(parity_ok, f"dense fused prefill vs token-wise: next tokens "
              f"equal {torch.equal(n_f, n_t)}, cache max abs {parity}")
        # a decode step's time, on the bf16 cache of a fused prefill
        nxt, cache = S.prefill(params, prompts, cfg, jcfg, max_len)
        times = lm_step_times(torch, cfg, jcfg, params, cache, nxt)
    gen = torch.Generator(device="cuda").manual_seed(26)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "h2o.decode", DENSE_GEN_BATCH))
    bound = decode_bound(torch, cfg, cache, rows)
    del cache
    S.clear_graphs()
    torch.cuda.empty_cache()
    res = dict(runs, **times, **bound, batch=DENSE_GEN_BATCH,
               prompt=DENSE_GEN_PROMPT, new_tokens=DENSE_GEN_STEPS,
               rolling_slots=cfg.sliding_window,
               f32_decode_max_abs_err=decode_err, tol=DENSE_DECODE_TOL,
               parity_prompt=DENSE_PARITY_PROMPT,
               parity_cache_max_abs=parity, parity_next_equal=True,
               first_tokens=out[0, :8].tolist())
    emit(phase="dense_generate", arch=cfg.arch_id, **res)
    return res, rows, worst


def gemma3_generate_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                          cfg32, params32):
    """gemma3-27b (8 layers) ``generate``: 64-token prompts prefilled token
    by token through the captured step, 16 new tokens; eager; the
    token-wise logits at every prompt position against the teacher-forced
    forward (f32)."""
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    prompts = token_rows(torch, cfg, GEMMA_PROMPT, GEMMA_BATCH, 2)
    max_len = GEMMA_PROMPT + GEMMA_STEPS
    out, runs = lm_graph_runs(torch, kernels, cfg, jcfg, params, prompts,
                              GEMMA_STEPS, max_len, False, "gemma3 generate")
    with torch.no_grad():
        want, _ = M.apply(params32, {"tokens": prompts}, cfg32, jcfg)
        got, _ = decode_logits(torch, M, params32, prompts, cfg32, jcfg,
                               torch.float32)
        err32 = (got - want).abs()
        decode_ok = bool((err32 <= DENSE_DECODE_TOL
                          + DENSE_DECODE_TOL * want.abs()).all())
        decode_err = float(err32.max())
        del got, want, err32
        check(decode_ok, f"gemma3 f32 decode vs teacher-forced: max abs "
                         f"{decode_err:.3e}")
        nxt, cache = S.prefill(params, prompts, cfg, jcfg, max_len)
        times = lm_step_times(torch, cfg, jcfg, params, cache, nxt)
    gen = torch.Generator(device="cuda").manual_seed(27)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "gemma3.decode", GEMMA_BATCH))
    bound = decode_bound(torch, cfg, cache, rows)
    del cache
    S.clear_graphs()
    torch.cuda.empty_cache()
    res = dict(runs, **times, **bound, batch=GEMMA_BATCH,
               prompt=GEMMA_PROMPT, new_tokens=GEMMA_STEPS,
               n_layers=cfg.n_layers, published_layers=62,
               f32_decode_max_abs_err=decode_err, tol=DENSE_DECODE_TOL,
               first_tokens=out[0, :8].tolist())
    emit(phase="gemma3_generate", arch=cfg.arch_id, **res)
    return res, rows, worst


def transformer_phases(torch, BM, SM90, ref):
    """The three transformer phases, each phase's weights freed before the
    next; returns their results and GEMM rows, and the worst GEMM error."""
    from repro_torch.kernels.graphs import counted_kernels
    kernels = counted_kernels()
    torch.cuda.empty_cache()
    cfg, jcfg, params, cfg32, params32 = dense_setup(torch, DENSE_ARCH)
    fwd, fwd_rows, w1 = dense_forward_phase(torch, kernels, BM, SM90, ref,
                                            cfg, jcfg, params, cfg32,
                                            params32)
    gen, gen_rows, w2 = dense_generate_phase(torch, kernels, BM, SM90, ref,
                                             cfg, jcfg, params, cfg32,
                                             params32)
    del params, params32
    torch.cuda.empty_cache()
    cfg, jcfg, params, cfg32, params32 = dense_setup(
        torch, GEMMA_ARCH, n_layers=GEMMA_LAYERS)
    gem, gem_rows, w3 = gemma3_generate_phase(torch, kernels, BM, SM90, ref,
                                              cfg, jcfg, params, cfg32,
                                              params32)
    del params, params32
    torch.cuda.empty_cache()
    return (fwd, gen, gem), (fwd_rows, gen_rows, gem_rows), max(w1, w2, w3)


# ---------------------------------------------------------------------------
# phases 13-15: the moe family (phi3.5-moe-42b-a6.6b cut in depth) and the
# hybrid (jamba-1.5-large-398b: one period, half its experts)
# ---------------------------------------------------------------------------

# phi3.5-moe-42b-a6.6b at its published width (d_model 4096, 32 heads of
# 128, 8 KV heads, 16 SwiGLU experts of 6,400, top-2, vocab 32,064, untied
# head), cut in depth from 32 layers to 4 (5.47 B parameters, 10.9 GB in
# bf16; with its f32 copy for the checks, 32.8 GB): the forward at 2 x
# 4,096 tokens (8 groups of 1,024, capacity 160 an expert and group);
# generate at batch 4 from 1,024-token prompts (the fused prefill), 32 new
# tokens; in f32 at capacity_factor = n_experts (the reference's decode
# convention), decode along 16 prompt tokens after a 64-token prefill
# against the teacher-forced forward, and the fused prefill of 64-token
# prompts against the token-wise one
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 4
MOE_SEQ, MOE_BATCH = 4096, 2
MOE_GEN_BATCH, MOE_GEN_PROMPT, MOE_GEN_STEPS = 4, 1024, 32
MOE_PARITY_PROMPT, MOE_PARITY_NEXT = 64, 16
# jamba-1.5-large-398b at its published width (d_model 8192, 64 heads of
# 128, 8 KV heads, no RoPE; Mamba-2 slots of 256 heads of 64 in 8 groups,
# state 128; SwiGLU d_ff 24,576; vocab 65,536, untied head), cut to one
# period of its 8 layers (the reference asserts whole periods: SSM slots
# 0-3 and 5-7, attention at 4, MoE on the odd slots) and to 8 of its 16
# experts (top-2 kept): one period at 16 experts is 45.25 B parameters,
# 90.5 GB in bf16, more than the card; at 8 it is 25.92 B, 51.8 GB.  The
# forward at 1 x 2,048 tokens; generate at batch 2 from 64-token prompts
# prefilled token by token through the captured step (the reference's
# hybrid has no fused prefill), 16 new tokens
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_EXPERTS = "jamba-1.5-large-398b", 8, 8
HYBRID_SEQ, HYBRID_BATCH = 2048, 1
HYBRID_GEN_BATCH, HYBRID_GEN_PROMPT, HYBRID_GEN_STEPS = 2, 64, 16
# A route that flips between two f32 forwards (kernel="pallas" against
# "xla": only summation orders differ, the router's inputs agree to ~1e-6
# relative) is a near tie: the first run's probabilities of the two
# experts within MOE_TIE_GAP.  A flip at a wider gap is a fault.  The
# logits are then held at every position before a row's first flip (a
# flipped token changes its own later layers, through attention every
# later position of its row, and through the capacity order the later
# tokens of its group, which lie in the same row here).
MOE_TIE_GAP = 1e-4
# The hybrid's bf16 forward against kernel="xla" on the same bf16 weights
# (no f32 copy fits beside them): the two differ only in the order of each
# GEMM's f32 sums before the same bf16 rounding, so each is as far from
# the exact forward as the other.  The exact forward is the same one in
# f32, its weights up-cast one slot at a time; by the triangle inequality
# the two bf16 forwards are then at most twice the library's distance
# from it apart: mean|pallas - xla| <= HYBRID_XLA_FACTOR * mean|xla -
# f32| (each over mean|f32|).  The bf16 forward against the f32 one is
# held to DENSE_BF16_TOL of the mean, a gross-fault check.
HYBRID_XLA_FACTOR = 2.0


@contextmanager
def recorded_routes(L, rec):
    """Every ``moe_route`` call's (probs, gate_vals, gate_idx, pos, keep)
    appended to ``rec`` (``moe_apply`` calls it through the module)."""
    real = L.moe_route

    def recording(*args, **kw):
        out = real(*args, **kw)
        rec.append(out)
        return out
    L.moe_route = recording
    try:
        yield
    finally:
        L.moe_route = real


def dropped_share(rec):
    """The share of (token, k) slots past their expert's capacity, over
    the recorded layers."""
    return float(sum((~r[4]).sum() for r in rec)
                 / sum(r[4].numel() for r in rec))


def route_flips(rec_a, rec_b, seq):
    """Every (token, k) whose expert differs between two recorded runs:
    its layer, row, position, k, the two experts and the first run's
    probability gap between them; ``primary`` where no flip at an earlier
    layer sits at or before its position in its row (a later flip there
    may follow from that one).  And each row's first flipped position."""
    flips, first = [], {}
    for layer, (ra, rb) in enumerate(zip(rec_a, rec_b)):
        probs, ia, ib = ra[0], ra[2], rb[2]
        gs = ia.shape[1]
        for g, t, k in (ia != ib).nonzero().tolist():
            a, b = int(ia[g, t, k]), int(ib[g, t, k])
            token = g * gs + t
            row, pos = divmod(token, seq)
            flips.append(dict(layer=layer, row=row, pos=pos, k=k,
                              experts=[a, b], prob_gap=float(
                                  (probs[g, t, a] - probs[g, t, b]).abs())))
    for f in flips:
        f["primary"] = not any(o["row"] == f["row"] and o["layer"]
                               < f["layer"] and o["pos"] <= f["pos"]
                               for o in flips)
        first[f["row"]] = min(first.get(f["row"], f["pos"]), f["pos"])
    return flips, first


def held_rel_err(a, b, first):
    """max|a - b| / max|b| over the positions before each row's first
    flipped route (all of a row without one)."""
    num = den = 0.0
    for r in range(a.shape[0]):
        n = first.get(r, a.shape[1])
        if n:
            num = max(num, float((a[r, :n] - b[r, :n]).abs().max()))
            den = max(den, float(b[r, :n].abs().max()))
    return num / den


def expert_bytes(params):
    from repro_torch.core import tree as ptree
    blocks = params.get("layers") or [blk for pp in params["periods"]
                                      for blk in pp.values()]
    return sum(t.numel() * t.element_size() for blk in blocks if "moe" in blk
               for t in ptree.leaves(blk["moe"]["experts"]))


def moe_forward_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                      cfg32, params32):
    """phi3.5-moe (4 layers)'s forward: 21 block_matmul launches (q, k, v,
    o and the router a layer, the head), the drops and the aux loss; in
    f32 the routes and the logits of kernel="pallas" against "xla", and
    bf16 against f32."""
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16, flops_forward
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M
    batch = {"tokens": token_rows(torch, cfg, MOE_SEQ, MOE_BATCH, 0)}
    per = lm_per_step(cfg)
    want_routes = lm_routes(cfg, MOE_BATCH * MOE_SEQ)
    rec = []
    with torch.no_grad():
        with recorded_routes(L, rec):
            # -- the main path: counts to 0 just before, read just after ---
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(kernels)
            logits, aux = M.apply(params, batch, cfg, jcfg)
            torch.cuda.synchronize()
            launches = read_counts(kernels)
            routes = read_routes(kernels)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # --------------------------------------------------------------
        check(launches["block_matmul"] == per
              and sum(launches.values()) == per,
              f"moe forward launches {launches} (want {per} block_matmul)")
        check(routes == want_routes, f"moe forward routes {routes}, want "
              f"{want_routes}")
        check(tuple(logits.shape) == (MOE_BATCH, MOE_SEQ, cfg.vocab_padded)
              and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(aux)),
              f"moe logits {tuple(logits.shape)} or aux not finite")
        check(len(rec) == cfg.n_layers, f"moe forward: {len(rec)} routings")
        dropped, aux = dropped_share(rec), float(aux)
        groups, gs = rec[0][2].shape[:2]
        capacity = max(1, int(cfg.capacity_factor * cfg.top_k * gs
                              / cfg.n_experts))
        del rec
        ms = cuda_ms(lambda: M.apply(params, batch, cfg, jcfg), 3)

        # f32: the routes and logits of pallas against xla; bf16 against f32
        rec_p, rec_x = [], []
        with recorded_routes(L, rec_p):
            ref32, aux32 = M.apply(params32, batch, cfg32, jcfg)
        bf16_err = mean_rel(logits.float(), ref32)
        bf16_top1 = float((logits.float().argmax(-1)
                           == ref32.argmax(-1)).float().mean())
        del logits
        with recorded_routes(L, rec_x):
            xla, aux_x = M.apply(params32, batch, cfg32,
                                 jcfg.replace(kernel="xla"))
        flips, first = route_flips(rec_p, rec_x, MOE_SEQ)
        xla_err = held_rel_err(ref32, xla, first)
        aux_err = abs(float(aux32) - float(aux_x)) / abs(float(aux_x))
        dropped32 = dropped_share(rec_p)
        del xla, ref32, rec_p, rec_x
    torch.cuda.empty_cache()
    wide = [f for f in flips if f["primary"] and f["prob_gap"] > MOE_TIE_GAP]
    check(not wide, f"moe f32 routes, pallas vs xla: {len(wide)} flipped "
          f"at a probability gap above {MOE_TIE_GAP}: {wide[:4]}")
    check(xla_err <= DENSE_F32_TOL, f"moe f32 logits, pallas vs xla: "
          f"{xla_err:.3e} (before each row's first flipped route {first})")
    check(bf16_err <= DENSE_BF16_TOL,
          f"moe bf16 logits vs f32: {bf16_err:.3e} of the mean")
    flops = flops_forward(cfg, MOE_BATCH, MOE_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(28)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "phi3.5.fwd", MOE_BATCH * MOE_SEQ))
    tokens = MOE_SEQ * MOE_BATCH
    out = dict(seq=MOE_SEQ, batch=MOE_BATCH, n_layers=cfg.n_layers,
               published_layers=32, groups=groups, group_size=gs,
               capacity=capacity, launches=launches,
               block_matmul_routes=routes, ms_per_forward=ms,
               tokens_per_s=tokens / (ms / 1e3), peak_mem_gb=peak_gb,
               dropped_share=dropped, aux=aux, flops=flops,
               flops_total=sum(flops.values()),
               floor_ms=1e3 * sum(flops.values()) / PEAK_FLOPS_BF16,
               block_matmul_ms=per_rows(rows, "kernel_ms"),
               block_matmul_bound_ms=per_rows(rows, "bound_ms"),
               block_matmul_library_ms=per_rows(rows, "library_ms"),
               block_matmul_plain_ms=per_rows(rows, "plain_ms"),
               f32_dropped_share=dropped32, f32_vs_xla=xla_err,
               tol_f32=DENSE_F32_TOL, f32_aux_vs_xla=aux_err,
               f32_route_flips=len(flips), f32_flips=flips[:8],
               tie_gap=MOE_TIE_GAP, bf16_vs_f32_mean=bf16_err,
               tol_bf16_mean=DENSE_BF16_TOL, bf16_vs_f32_top1_agree=bf16_top1)
    emit(phase="moe_forward", arch=cfg.arch_id, **out)
    return out, rows, worst


def moe_generate_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                       cfg32, params32):
    """phi3.5-moe (4 layers)'s ``generate``: the fused prefill of
    1,024-token prompts, then the captured decode step; eager; in f32 at
    capacity_factor = n_experts, decode against teacher-forced and the
    fused prefill against the token-wise one."""
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    prompts = token_rows(torch, cfg, MOE_GEN_PROMPT, MOE_GEN_BATCH, 1)
    max_len = MOE_GEN_PROMPT + MOE_GEN_STEPS
    out, runs = lm_graph_runs(torch, kernels, cfg, jcfg, params, prompts,
                              MOE_GEN_STEPS, max_len, True, "moe generate")
    cfgn = cfg32.replace(capacity_factor=float(cfg.n_experts))
    n, m = MOE_PARITY_PROMPT, MOE_PARITY_NEXT
    with torch.no_grad():
        # decode along the prompts' next m tokens after a fused f32 prefill
        # of n, against the teacher-forced f32 forward of n + m
        seq = prompts[:, :n + m]
        logits, cache = M.prefill_cache(params32, {"tokens": seq[:, :n]},
                                        cfgn, jcfg, n + m,
                                        dtype=torch.float32)
        got = [logits[:, -1]]
        for i in range(m):
            lg, cache = M.decode_step(params32, cache, seq[:, n + i:n + i + 1],
                                      cfgn, jcfg)
            got.append(lg[:, 0])
        got = torch.stack(got, 1)
        want, _ = M.apply(params32, {"tokens": seq}, cfgn, jcfg)
        want = want[:, n - 1:]
        err32 = (got - want).abs()
        decode_ok = bool((err32 <= DENSE_DECODE_TOL
                          + DENSE_DECODE_TOL * want.abs()).all())
        decode_err = float(err32.max())
        del got, want, err32, cache
        check(decode_ok, f"moe f32 decode vs teacher-forced: max abs "
                         f"{decode_err:.3e}")
        # the fused prefill against the token-wise one
        n_f, c_f = S.prefill(params32, seq[:, :n], cfgn, jcfg, 2 * n,
                             cache_dtype=torch.float32, fused=True)
        n_t, c_t = S.prefill_tokenwise(params32, seq[:, :n], cfgn, jcfg,
                                       2 * n, cache_dtype=torch.float32)
        parity = {k: float((c_f[k] - c_t[k]).abs().max()) for k in "kv"}
        parity_ok = torch.equal(n_f, n_t) and torch.equal(
            c_f["pos"], c_t["pos"]) and all(
            torch.allclose(c_f[k], c_t[k], rtol=PARITY_RTOL,
                           atol=PARITY_ATOL) for k in "kv")
        del c_f, c_t
        check(parity_ok, f"moe fused prefill vs token-wise: next tokens "
              f"equal {torch.equal(n_f, n_t)}, cache max abs {parity}")
        # a decode step's time, on the bf16 cache of a fused prefill
        nxt, cache = S.prefill(params, prompts, cfg, jcfg, max_len)
        times = lm_step_times(torch, cfg, jcfg, params, cache, nxt)
    gen = torch.Generator(device="cuda").manual_seed(29)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "phi3.5.decode", MOE_GEN_BATCH))
    bound = decode_bound(torch, cfg, cache, rows, expert_bytes(params))
    del cache
    S.clear_graphs()
    torch.cuda.empty_cache()
    res = dict(runs, **times, **bound, batch=MOE_GEN_BATCH,
               prompt=MOE_GEN_PROMPT, new_tokens=MOE_GEN_STEPS,
               n_layers=cfg.n_layers, published_layers=32,
               decode_capacity_factor=float(cfg.n_experts),
               f32_capacity_factor=float(cfg.n_experts),
               f32_decode_max_abs_err=decode_err, tol=DENSE_DECODE_TOL,
               parity_prompt=n, parity_cache_max_abs=parity,
               parity_next_equal=True, first_tokens=out[0, :8].tolist())
    emit(phase="moe_generate", arch=cfg.arch_id, **res)
    return res, rows, worst


def hybrid_f32_forward(torch, params, batch, cfg, jcfg):
    """The hybrid's forward in f32 with every linear a cuBLAS call (TF32
    off), its weights up-cast one slot at a time (an f32 copy of the whole
    does not fit beside the bf16 weights): the exact forward the bf16 ones
    are measured against."""
    from repro_torch.core import tree as ptree
    from repro_torch.models import hybrid as H
    from repro_torch.models import layers as L
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    jx = jcfg.replace(kernel="xla")

    def up(tree):
        return ptree.map(lambda t: t.float(), tree)
    x = L.embed_apply(params["embed"], batch["tokens"]).float()
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pp in params["periods"]:
        for j in range(cfg.attn_every):
            x, _, aux = H._slot_apply(up(pp[f"slot{j}"]), x, j, cfg32, jx,
                                      positions, aux)
    head = {k: up(params[k]) for k in ("final_norm", "lm_head", "embed")
            if k in params and (k != "embed" or cfg.tie_embeddings)}
    return H._lm_head(head, x, cfg32, jx)


def hybrid_generate_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params):
    """jamba (one period, 8 experts): the bf16 forward at 1 x 2,048 tokens
    (7 ssd and 49 block_matmul launches) against kernel="xla" and the
    slot-wise f32 forward; then ``generate`` from 64-token prompts
    prefilled token by token through the captured step, 16 new tokens,
    graphed and eager (no ssd launch in decode)."""
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16, flops_forward
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    batch = {"tokens": token_rows(torch, cfg, HYBRID_SEQ, HYBRID_BATCH, 0)}
    per = lm_per_step(cfg)
    n_ssm = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    want_routes = lm_routes(cfg, HYBRID_BATCH * HYBRID_SEQ)
    rec_p, rec_x = [], []
    with torch.no_grad():
        with recorded_routes(L, rec_p):
            # -- the main path: counts to 0 just before, read just after ---
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(kernels)
            logits, aux = M.apply(params, batch, cfg, jcfg)
            torch.cuda.synchronize()
            launches = read_counts(kernels)
            routes = read_routes(kernels)
            ssd_routes = dict(next(fn for fn in kernels if fn.__name__
                                   == "ssd_intra_chunk").route_launches)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # --------------------------------------------------------------
        check(launches["block_matmul"] == per
              and launches["ssd_intra_chunk"] == n_ssm
              and sum(launches.values()) == per + n_ssm,
              f"hybrid forward launches {launches} (want {per} block_matmul,"
              f" {n_ssm} ssd)")
        check(routes == want_routes, f"hybrid forward routes {routes}, want "
              f"{want_routes}")
        check(sum(v for k, v in ssd_routes.items() if k.startswith("heads."))
              == n_ssm, f"hybrid forward ssd routes {ssd_routes}, want "
              f"{n_ssm} heads-entry launches")
        check(tuple(logits.shape) == (HYBRID_BATCH, HYBRID_SEQ,
                                      cfg.vocab_padded)
              and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(aux)),
              f"hybrid logits {tuple(logits.shape)} or aux not finite")
        dropped, aux = dropped_share(rec_p), float(aux)
        ms = cuda_ms(lambda: M.apply(params, batch, cfg, jcfg), 2)
        with recorded_routes(L, rec_x):
            xla, _ = M.apply(params, batch, cfg, jcfg.replace(kernel="xla"))
        flips, _ = route_flips(rec_p, rec_x, HYBRID_SEQ)
        del rec_p, rec_x
        ref32 = hybrid_f32_forward(torch, params, batch, cfg, jcfg)
        pf, xf = logits.float(), xla.float()
        d_px, d_xf, d_pf = mean_rel(pf, xf), mean_rel(xf, ref32), \
            mean_rel(pf, ref32)
        top1 = float((pf.argmax(-1) == ref32.argmax(-1)).float().mean())
        del logits, xla, ref32, pf, xf
    torch.cuda.empty_cache()
    check(d_px <= HYBRID_XLA_FACTOR * d_xf,
          f"hybrid bf16 logits, pallas vs xla: {d_px:.3e} of the mean, "
          f"bound {HYBRID_XLA_FACTOR} x {d_xf:.3e} (xla vs f32)")
    check(d_pf <= DENSE_BF16_TOL,
          f"hybrid bf16 logits vs f32: {d_pf:.3e} of the mean")
    flops = flops_forward(cfg, HYBRID_BATCH, HYBRID_SEQ)
    fwd = dict(seq=HYBRID_SEQ, batch=HYBRID_BATCH, launches=launches,
               block_matmul_routes=routes, ssd_routes=ssd_routes,
               ms_per_forward=ms,
               tokens_per_s=HYBRID_SEQ * HYBRID_BATCH / (ms / 1e3),
               peak_mem_gb=peak_gb, dropped_share=dropped, aux=aux,
               flops_total=sum(flops.values()),
               floor_ms=1e3 * sum(flops.values()) / PEAK_FLOPS_BF16,
               bf16_vs_xla_mean=d_px, xla_vs_f32_mean=d_xf,
               bound_vs_xla=HYBRID_XLA_FACTOR * d_xf, bf16_vs_f32_mean=d_pf,
               tol_bf16_mean=DENSE_BF16_TOL, bf16_vs_f32_top1_agree=top1,
               route_flips_vs_xla=len(flips), flips=flips[:8])
    emit(phase="hybrid_forward", arch=cfg.arch_id, **fwd)

    prompts = token_rows(torch, cfg, HYBRID_GEN_PROMPT, HYBRID_GEN_BATCH, 2)
    max_len = HYBRID_GEN_PROMPT + HYBRID_GEN_STEPS
    out, runs = lm_graph_runs(torch, kernels, cfg, jcfg, params, prompts,
                              HYBRID_GEN_STEPS, max_len, False,
                              "hybrid generate")
    with torch.no_grad():
        nxt, cache = S.prefill(params, prompts, cfg, jcfg, max_len)
        times = lm_step_times(torch, cfg, jcfg, params, cache, nxt)
    gen = torch.Generator(device="cuda").manual_seed(30)
    n_expert_bytes = expert_bytes(params)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "jamba.decode", HYBRID_GEN_BATCH))
    bound = decode_bound(torch, cfg, cache, rows, n_expert_bytes)
    del cache
    S.clear_graphs()
    torch.cuda.empty_cache()
    res = dict(runs, **times, **bound, batch=HYBRID_GEN_BATCH,
               prompt=HYBRID_GEN_PROMPT, new_tokens=HYBRID_GEN_STEPS,
               first_tokens=out[0, :8].tolist())
    emit(phase="hybrid_generate", arch=cfg.arch_id, **res)
    return fwd, res, rows, worst


def moe_hybrid_phases(torch, BM, SM90, ref):
    """The moe and hybrid phases, each model's weights freed before the
    next; returns their results and GEMM rows, and the worst GEMM
    error."""
    from repro_torch.kernels.graphs import counted_kernels
    kernels = counted_kernels()
    torch.cuda.empty_cache()
    cfg, jcfg, params, cfg32, params32 = dense_setup(
        torch, MOE_ARCH, n_layers=MOE_LAYERS)
    mfwd, mfwd_rows, w1 = moe_forward_phase(torch, kernels, BM, SM90, ref,
                                            cfg, jcfg, params, cfg32,
                                            params32)
    mgen, mgen_rows, w2 = moe_generate_phase(torch, kernels, BM, SM90, ref,
                                             cfg, jcfg, params, cfg32,
                                             params32)
    del params, params32
    torch.cuda.empty_cache()
    cfg, jcfg, params, _, _ = dense_setup(
        torch, HYBRID_ARCH, f32=False, n_layers=HYBRID_LAYERS,
        n_experts=HYBRID_EXPERTS)
    hfwd, hgen, hgen_rows, w3 = hybrid_generate_phase(
        torch, kernels, BM, SM90, ref, cfg, jcfg, params)
    del params
    torch.cuda.empty_cache()
    # the hybrid forward's GEMM shapes, with its weights freed
    gen = torch.Generator(device="cuda").manual_seed(31)
    hfwd_rows, w4 = lm_gemm_rows(torch, BM, SM90, ref, gen, lm_gemm_shapes(
        cfg, "jamba.fwd", HYBRID_BATCH * HYBRID_SEQ))
    sums = dict(block_matmul_ms=per_rows(hfwd_rows, "kernel_ms"),
                block_matmul_bound_ms=per_rows(hfwd_rows, "bound_ms"),
                block_matmul_library_ms=per_rows(hfwd_rows, "library_ms"),
                block_matmul_plain_ms=per_rows(hfwd_rows, "plain_ms"))
    hfwd.update(sums)
    emit(phase="hybrid_forward_gemms", arch=cfg.arch_id, **sums)
    return ((mfwd, mgen, hfwd, hgen),
            (mfwd_rows, mgen_rows, hfwd_rows, hgen_rows), max(w1, w2, w3, w4))


# ---------------------------------------------------------------------------
# phases 16-20: whisper-small (the audio family) whole, serving and
# training, and language-model training: h2o-danube-1.8b whole and
# phi3.5-moe-42b-a6.6b cut in depth
# ---------------------------------------------------------------------------

# whisper-small as published (12 encoder and 12 decoder layers, d_model
# 768, 12 heads of 64, GELU FFN 3,072, vocab 51,865 padded to 51,968, tied
# head, 1,500 stub frames; 0.241 B parameters, 0.48 GB in bf16): the
# forward at batch 4 x 1,500 frames x 448 decoder tokens (whisper's own
# ceiling); generate at batch 4 from 4-token prompts with the frames as
# extra_batch, 64 new tokens (the token-wise prefill: the reference has
# no fused one for the enc-dec family)
AUDIO_ARCH = "whisper-small"
AUDIO_BATCH, AUDIO_TOKENS = 4, 448
AUDIO_GEN_BATCH, AUDIO_GEN_PROMPT, AUDIO_GEN_STEPS = 4, 4, 64
# judged in f32 (the seed's weights up-cast), each as a share of the mean
# magnitude: kernel="pallas" against "xla" 1e-3 (only summation orders
# differ; the dense phases' bound), bf16 against f32 0.1 (a gross-fault
# check, as DENSE_BF16_TOL); token-wise decode against the teacher-forced
# forward elementwise at the reference's 5e-3 (DENSE_DECODE_TOL)
AUDIO_F32_TOL = 1e-3
# training, under the bf16 policy (bf16 weights and compute, f32 masters
# and moments) with remat: h2o-danube-1.8b whole at batch 2 x 1,024
# tokens, four steps; whisper-small whole at batch 2 x 448 tokens with its
# frames, two steps; phi3.5-moe-42b-a6.6b cut from 32 layers to 2 (all 16
# experts; 2.86 B parameters) at batch 2 x 1,024 tokens, one step, under
# the config's own dtypes (bf16 weights and moments, no masters), so that
# its router runs the reference's f32 product (``x.astype(float32)`` on
# f32 weights) on block_matmul's f32 route, forward and VJP
LM_TRAIN_ARCH, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = \
    "h2o-danube-1.8b", 2, 1024, 4
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_STEPS = 2, 2
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 2, 1024
# h2o's step 0 under kernel="pallas" against "xla" (same bf16 weights and
# batch): the loss and the grad norm within LM_TRAIN_TOL relative, every
# leaf's gradient within LM_LEAF_TOL (both the norm of its difference over
# its norm and its largest difference over its largest magnitude); the
# same step with the LM head zeroed is the control the bounds must refuse.
# The leaves' bound is the looser: at random init the attention's k and q
# gradients come from a softmax's centred differences, which a rounding
# more or less moves by some percent (the smoke prints that noise floor)
LM_TRAIN_TOL = 1e-2
LM_LEAF_TOL = 1e-1


def audio_gemm_shapes(cfg, tag, b, s):
    """(label, M, K, N, epilogue, launches, dtype name) of whisper's
    block_matmul launches for ``b`` rows of ``s`` decoder tokens: with
    s > 1 the forward (the encoder at b x n_frames rows, the decoder at b x
    s), with s == 1 a decode step (the decoder at b rows; every layer's
    cross k and v projected anew from the encoder's b x n_frames states, as
    the reference's).  Shapes shared by several linears are one row."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    me, md = b * cfg.n_frames, b * s
    rows = {}

    def add(name, m, k, n, epi, count):
        key = (m, k, n, epi)
        label, c = rows.get(key, (name, 0))
        rows[key] = (label, c + count)
    if s > 1:
        e = cfg.n_enc_layers
        add("enc.qkvo", me, d, d, "none", 4 * e)
        add("enc.fc1", me, d, f, "gelu", e)
        add("enc.fc2", me, f, d, "none", e)
    add("dec.qkvo", md, d, d, "none", 6 * L)          # self q k v o, cross q o
    add("dec.cross_kv", me, d, d, "none", 2 * L)
    add("dec.fc1", md, d, f, "gelu", L)
    add("dec.fc2", md, f, d, "none", L)
    add("head", md, d, cfg.vocab_padded, "none", 1)
    return [(f"{tag}.{label}", m, k, n, epi, c, "bfloat16")
            for (m, k, n, epi), (label, c) in rows.items()]


def audio_encode_launches(cfg):
    """block_matmul launches of one ``encode``: q, k, v, o, fc1, fc2 a
    layer."""
    return 6 * cfg.n_enc_layers


def audio_routes(cfg, b, s):
    import torch
    from repro_torch.kernels import block_matmul as BM
    out = {}
    for _, m, _, n, _, count, _ in audio_gemm_shapes(cfg, "", b, s):
        rt = BM.route(m, n, torch.bfloat16)
        out[rt] = out.get(rt, 0) + count
    return out


def audio_frames(torch, cfg, b, seed):
    """Stub frame embeddings [b, n_frames, d_model], f32 normal draws."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, cfg.n_frames, cfg.d_model), generator=gen,
                       device="cuda")


def audio_forward_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                        cfg32, params32):
    """whisper-small's forward: 193 block_matmul launches (6 an encoder
    layer, 10 a decoder layer, the head), all on the Hopper loop; then in
    f32 pallas against xla and bf16 against f32."""
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16, flops_forward
    from repro_torch.models import encdec as E
    from repro_torch.models import registry as M
    frames32 = audio_frames(torch, cfg, AUDIO_BATCH, 41)
    tokens = token_rows(torch, cfg, AUDIO_TOKENS, AUDIO_BATCH, 0)
    batch = {"frames": frames32.bfloat16(), "tokens": tokens}
    per = sum(r[5] for r in audio_gemm_shapes(cfg, "", AUDIO_BATCH,
                                              AUDIO_TOKENS))
    want_routes = audio_routes(cfg, AUDIO_BATCH, AUDIO_TOKENS)
    with torch.no_grad():
        # -- the main path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        logits, aux = M.apply(params, batch, cfg, jcfg)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        routes = read_routes(kernels)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # ------------------------------------------------------------------
        check(launches["block_matmul"] == per
              and sum(launches.values()) == per,
              f"audio forward launches {launches} (want {per} block_matmul)")
        check(routes == want_routes, f"audio forward routes {routes}, want "
              f"{want_routes}")
        check(tuple(logits.shape) == (AUDIO_BATCH, AUDIO_TOKENS,
                                      cfg.vocab_padded)
              and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
              f"audio logits {tuple(logits.shape)} not finite or misshapen")
        ms = cuda_ms(lambda: M.apply(params, batch, cfg, jcfg), 3)
        enc_ms = cuda_ms(lambda: E.encode(params, batch["frames"], cfg,
                                          jcfg), 3)
        # f32: pallas against xla; bf16 against f32
        b32 = {"frames": frames32, "tokens": tokens}
        ref32, _ = M.apply(params32, b32, cfg32, jcfg)
        bf16_err = mean_rel(logits.float(), ref32)
        del logits
        xla, _ = M.apply(params32, b32, cfg32, jcfg.replace(kernel="xla"))
        xla_err = mean_rel(ref32, xla)
        xla_max = rel_err(ref32, xla)
        del xla, ref32
    torch.cuda.empty_cache()
    check(xla_err <= AUDIO_F32_TOL,
          f"audio f32 logits, pallas vs xla: {xla_err:.3e} of the mean")
    check(bf16_err <= DENSE_BF16_TOL,
          f"audio bf16 logits vs f32: {bf16_err:.3e} of the mean")
    flops = flops_forward(cfg, AUDIO_BATCH, AUDIO_TOKENS)
    gen = torch.Generator(device="cuda").manual_seed(42)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, audio_gemm_shapes(
        cfg, "whisper.fwd", AUDIO_BATCH, AUDIO_TOKENS))
    out = dict(batch=AUDIO_BATCH, frames=cfg.n_frames, tokens=AUDIO_TOKENS,
               launches=launches, block_matmul_routes=routes,
               ms_per_forward=ms, encode_ms=enc_ms,
               tokens_per_s=AUDIO_BATCH * AUDIO_TOKENS / (ms / 1e3),
               frames_per_s=AUDIO_BATCH * cfg.n_frames / (ms / 1e3),
               peak_mem_gb=peak_gb,
               # launch/analysis.py's FLOP model (the reference's) counts
               # the decoder's self-attention stack and head only; the
               # GEMM rows' bound below counts every launch
               analysis_flops_total=sum(flops.values()),
               analysis_floor_ms=1e3 * sum(flops.values()) / PEAK_FLOPS_BF16,
               block_matmul_ms=per_rows(rows, "kernel_ms"),
               block_matmul_bound_ms=per_rows(rows, "bound_ms"),
               block_matmul_library_ms=per_rows(rows, "library_ms"),
               block_matmul_plain_ms=per_rows(rows, "plain_ms"),
               f32_vs_xla_mean=xla_err, f32_vs_xla_max=xla_max,
               tol_f32_mean=AUDIO_F32_TOL, bf16_vs_f32_mean=bf16_err,
               tol_bf16_mean=DENSE_BF16_TOL)
    emit(phase="audio_forward", arch=cfg.arch_id, **out)
    return out, rows, worst


def audio_generate_phase(torch, kernels, BM, SM90, ref, cfg, jcfg, params,
                         cfg32, params32):
    """whisper-small's ``generate`` with the frames as ``extra_batch``:
    the encoder once, the 4-token prompts token by token through the
    captured step (its static cache loaded with the encoder's states),
    then the decode steps; eagerly; in f32 the token-wise logits along
    prompt + output against the teacher-forced forward; the step's times
    and the encoder's apart."""
    from repro_torch.models import encdec as E
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    prompts = token_rows(torch, cfg, AUDIO_GEN_PROMPT, AUDIO_GEN_BATCH, 1)
    frames32 = audio_frames(torch, cfg, AUDIO_GEN_BATCH, 43)
    extra = {"frames": frames32.bfloat16()}
    max_len = AUDIO_GEN_PROMPT + AUDIO_GEN_STEPS
    out, runs = lm_graph_runs(torch, kernels, cfg, jcfg, params, prompts,
                              AUDIO_GEN_STEPS, max_len, False,
                              "audio generate", extra_batch=extra)
    with torch.no_grad():
        seq = torch.cat([prompts, out[:, :-1]], dim=1)
        want, _ = M.apply(params32, {"frames": frames32, "tokens": seq},
                          cfg32, jcfg)
        cache = S.start_cache(params32, seq, cfg32, jcfg, seq.shape[1],
                              torch.float32, {"frames": frames32})
        got = []
        for t in range(seq.shape[1]):
            lg, cache = M.decode_step(params32, cache, seq[:, t:t + 1],
                                      cfg32, jcfg)
            got.append(lg[:, 0])
        del cache
        got = torch.stack(got, 1)
        err32 = (got - want).abs()
        decode_ok = bool((err32 <= DENSE_DECODE_TOL
                          + DENSE_DECODE_TOL * want.abs()).all())
        decode_err = float(err32.max())
        del got, want, err32
        torch.cuda.empty_cache()
        check(decode_ok, f"audio f32 decode vs teacher-forced: max abs "
                         f"{decode_err:.3e}")
        enc_ms = cuda_ms(lambda: E.encode(params, extra["frames"], cfg,
                                          jcfg), 3)
        nxt, cache = S.prefill(params, prompts, cfg, jcfg, max_len,
                               extra_batch=extra)
        times = lm_step_times(torch, cfg, jcfg, params, cache, nxt)
    gen = torch.Generator(device="cuda").manual_seed(44)
    rows, worst = lm_gemm_rows(torch, BM, SM90, ref, gen, audio_gemm_shapes(
        cfg, "whisper.decode", AUDIO_GEN_BATCH, 1))
    bound = decode_bound(torch, cfg, cache, rows)
    # the cross k and v recomputed from the encoder's states every step,
    # every layer (the reference's arithmetic): their share of the step's
    # block_matmul time
    kv = [r for r in rows if r["shape"].endswith("cross_kv")]
    del cache
    S.clear_graphs()
    torch.cuda.empty_cache()
    res = dict(runs, **times, **bound, batch=AUDIO_GEN_BATCH,
               prompt=AUDIO_GEN_PROMPT, new_tokens=AUDIO_GEN_STEPS,
               encode_ms=enc_ms,
               encode_launches=audio_encode_launches(cfg),
               cross_kv_ms_per_step=per_rows(kv, "kernel_ms"),
               cross_kv_bound_ms_per_step=per_rows(kv, "bound_ms"),
               f32_decode_max_abs_err=decode_err, tol=DENSE_DECODE_TOL,
               first_tokens=out[0, :8].tolist())
    emit(phase="audio_generate", arch=cfg.arch_id, **res)
    return res, rows, worst


def lm_train_calls(cfg):
    """block_matmul launches of one remat training step, by kind: the
    forward, the remat recompute (every layer's, not the head's), dx, dw
    (every linear's) and the GELU pre-activation recomputes of the FFNs'
    first linear; and the SSD launches of the SSM layers: the forward and
    its recompute (ssd_chunk) and the backward (ssd_chunk_bwd), one each a
    layer (``tests/test_torch_lm_train.py`` and
    ``tests/test_torch_ssm_train.py`` count the same on the CPU).  A
    Mamba-2 layer has 4 linears; a hybrid slot its mixer's 4 and its
    FFN's 3 or its MoE router's 1."""
    ssm = gelu = 0
    if cfg.family == "audio":
        per = 6 * cfg.n_enc_layers + 10 * cfg.n_layers
        gelu = cfg.n_enc_layers + cfg.n_layers
    elif cfg.family == "ssm":
        per, ssm = 4 * cfg.n_layers, cfg.n_layers
    elif cfg.family == "hybrid":
        slots = [j % cfg.attn_every for j in range(cfg.n_layers)]
        per = sum(4 + (1 if cfg.is_moe_layer(j) else 3) for j in slots)
        ssm = sum(not cfg.is_attn_layer(j) for j in slots)
    else:
        per = (5 if cfg.n_experts else 7) * cfg.n_layers
    return dict(forward=per + 1, remat=per, dx=per + 1, dw=per + 1,
                gelu=gelu, ssd_forward=2 * ssm, ssd_backward=ssm)


def lm_bwd_rows(torch, BM, SM90, ref, gen, shapes):
    """dx = dz @ w (w read as w.T) and dw = dz.T @ x (both read across
    their rows) at a language model's forward shapes (``lm_gemm_shapes``
    rows: label, M, K, N, epilogue, launches, dtype), each against its
    plain version, timed beside it, ``torch.matmul`` and the bound."""
    rows, worst = [], 0.0
    for label, m, k, n, _, per_path, name in shapes:
        dtype = getattr(torch, name)
        x = (torch.randn(m, k, generator=gen, device="cuda")
             / m ** 0.5).to(dtype)
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        dz = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
        for kind, a, b, x_t, (om, on, ok_), library in (
                ("dx", dz, w, False, (m, k, n), lambda: torch.matmul(dz, w)),
                ("dw", dz, x, True, (n, k, m),
                 lambda: torch.matmul(dz.t(), x))):
            def kernel(a=a, b=b, x_t=x_t):
                return BM.block_matmul(a, b, x_t=x_t, w_t=True)

            def plain(a=a, b=b, x_t=x_t):
                return ref.block_matmul_ref(a, b, x_t=x_t, w_t=True)
            y = kernel()
            torch.cuda.synchronize()
            err, ok = gemm_errors(y, plain(), name)
            check(ok, f"{label}.{kind} {(om, on, ok_)} {name}: max err "
                      f"{err:.3e}")
            worst = max(worst, err)
            bound, bound_by = gemm_bound_ms(om, on, ok_, name, False)
            row = dict(shape=f"{label}.{kind}", m=om, n=on, k=ok_,
                       dtype=name, x_t=x_t, w_t=True, per_path=per_path,
                       route=BM.route(om, on, dtype), max_abs_err=err,
                       tol=GEMM_TOL[name], kernel_ms=cuda_ms(kernel, 3),
                       library_ms=cuda_ms(library, 3),
                       plain_ms=cuda_ms(plain, 1), bound_ms=bound,
                       bound_by=bound_by)
            row["tflops"] = 2e-9 * om * on * ok_ / row["kernel_ms"]
            emit(phase="kernel_bwd_shape", **row)
            rows.append(row)
            del y
        del x, w, dz
    torch.cuda.empty_cache()
    return rows, worst


def _moved(torch, before, params):
    """Whether every sampled leaf changed (``before``: path -> copy)."""
    from repro_torch.core import tree as ptree
    now = dict(ptree.leaves_with_path(params))
    return all(not torch.equal(now[p], t) for p, t in before.items())


def _sample_leaves(params, n=4):
    """Copies of a few weight leaves spread over the tree, by path."""
    from repro_torch.core import tree as ptree
    leaves = [(p, t) for p, t in ptree.leaves_with_path(params)
              if t.ndim >= 2]
    step = max(1, len(leaves) // n)
    return {p: t.clone() for p, t in leaves[::step]}


def lm_train_run(torch, BM, arch, cfg_over, ecfg, what, compare=False,
                 first_step=None, reduced=False, init_params=None,
                 after=None, handoff=None, zoo=None):
    """``TrainEngine(arch, kernel="pallas")`` on its token batches, at the
    published width (``reduced``: the reduced config, remat on, from
    ``init_params``): optionally step 0 against ``kernel="xla"`` on the
    same weights and batch (``compare``), or ``first_step(eng)``'s checks;
    then the run, its launches by layout and route counted from 0 just
    before it; losses finite, the sampled weights moved, the step records'
    ``mfu``; one step's device time after it, then ``after(eng)``.
    With ``compare``, ``handoff`` (a path) gets step 0 for ``lm_1d``;
    ``zoo`` (a directory) gets it for ``lm_1d_zoo`` (``zoo_handoff``).
    Returns the stats and the engine's config."""
    import math
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.engine import TrainEngine
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import value_and_grad
    cfg0 = get_config(arch)
    cfg0 = (cfg0.reduced() if reduced else cfg0).replace(**cfg_over)
    t0 = time.perf_counter()
    eng = TrainEngine(arch, reduced=False, kernel="pallas", device="cuda",
                      config_override=cfg0, config=ecfg,
                      init_params=init_params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = eng.cfg
    check(cfg.remat and cfg.kernel == "pallas" and cfg.scheme == "none",
          f"{what}: unexpected config remat={cfg.remat} "
          f"kernel={cfg.kernel} scheme={cfg.scheme}")
    checks = None if first_step is None else first_step(eng)
    if zoo is not None:
        zoo_handoff(torch, eng, zoo / f"{arch}.pt", arch)
    first = None
    if compare:
        batch0 = eng.pipeline.get(0)
        mx, gx = value_and_grad(eng.params, batch0, cfg,
                                eng.jcfg.replace(kernel="xla"))
        nx = float(global_norm(gx))

        def versus_xla(m, g):
            lk, lx, nk = float(m["loss"]), float(mx["loss"]), \
                float(global_norm(g))
            return dict(loss=lk, loss_xla=lx,
                        loss_rel_err=abs(lk - lx) / abs(lx), grad_norm=nk,
                        grad_norm_xla=nx,
                        grad_norm_rel_err=abs(nk - nx) / nx,
                        **leaf_errs(torch, g, gx))
        mk, gk = value_and_grad(eng.params, batch0, cfg, eng.jcfg)
        first = versus_xla(mk, gk)
        if handoff is not None:
            lm_1d_handoff(torch, eng, batch0, mk, gk, handoff)
        del gk

        def altered(change, jcfg):
            """The step with ``change(True)`` made to the weights, then
            ``change(False)`` putting them back bit for bit."""
            change(True)
            try:
                m, g = value_and_grad(eng.params, batch0, cfg, jcfg)
            finally:
                change(False)
            out = versus_xla(m, g)
            del g
            return out
        # the noise floor: kernel="xla" again with every element of the
        # input embedding one bf16 step off (its lowest bit flipped, which
        # a second flip undoes), i.e. what one rounding more or less in
        # the inputs moves
        table = eng.params["embed"]["table"]
        bits = table.view(torch.int16 if table.element_size() == 2
                          else torch.int32)
        noise = altered(lambda _: bits.bitwise_xor_(1),
                        eng.jcfg.replace(kernel="xla"))
        # the control, which the bounds must refuse: the LM head's weight
        # zeroed (every logit 0, the loss ln V)
        head = (table if cfg.tie_embeddings else eng.params["lm_head"]["w"])
        keep = head.clone()
        control = altered(lambda on: head.zero_() if on else head.copy_(keep),
                          eng.jcfg)
        del gx, keep, batch0
        torch.cuda.empty_cache()
        first.update(tol=LM_TRAIN_TOL, leaf_tol=LM_LEAF_TOL,
                     noise_one_bf16_step=noise, control_zero_head=control)

        def passes(r):
            return (r["loss_rel_err"] <= LM_TRAIN_TOL
                    and r["grad_norm_rel_err"] <= LM_TRAIN_TOL
                    and r["max_leaf_norm_err"] <= LM_LEAF_TOL
                    and r["max_leaf_rel_err"] <= LM_LEAF_TOL)
        check(passes(first), f"{what} step 0 vs kernel='xla': {first}")
        check(not passes(control), f"{what}: the zeroed-head control "
              f"passes the bounds: {control}")
    before = _sample_leaves(eng.params)
    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counted())
    BM.block_matmul.layout_launches.clear()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counted())
    routes = dict(BM.block_matmul.route_launches)
    by_layout = dict(BM.block_matmul.layout_launches)
    peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------
    steps = ecfg.steps
    calls = lm_train_calls(cfg)
    layouts = {"x,w": by_layout.get((False, False), 0),
               "x,w.T (dx)": by_layout.get((False, True), 0),
               "x.T,w.T (dw)": by_layout.get((True, True), 0)}
    want_layouts = {"x,w": steps * (calls["forward"] + calls["remat"]
                                    + calls["gelu"]),
                    "x,w.T (dx)": steps * calls["dx"],
                    "x.T,w.T (dw)": steps * calls["dw"]}
    total = sum(want_layouts.values())
    want_ssd = {"ssd_intra_chunk": steps * calls["ssd_forward"],
                "ssd_intra_heads_bwd": steps * calls["ssd_backward"]}
    check(launches["block_matmul"] == total
          and all(launches[k] == v for k, v in want_ssd.items())
          and sum(launches.values()) == total + sum(want_ssd.values())
          and layouts == want_layouts,
          f"{what}: launches {launches} by layout {layouts}, want "
          f"{want_layouts} and {want_ssd}")
    check(len(hist) == steps and all(
        math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
        for h in hist), f"{what}: bad history {hist}")
    check(_moved(torch, before, eng.params), f"{what}: the weights did "
          "not move")
    check(peak < PEAK_MEM_LIMIT, f"{what}: peak memory {peak / 1e9:.2f} GB")
    recs = eng.tracer.step_records()
    check(len(recs) == steps and all(0 < r["mfu"] <= 1 for r in recs),
          f"{what}: step records' mfu {[r.get('mfu') for r in recs]}")
    tokens = ecfg.batch * ecfg.seq_len
    # the steps after the first (its time holds the first launches' set-up)
    later = recs[1:] or recs
    step_s = sum(r["dur_s"] - r["data_wait_s"] for r in later) / len(later)
    batch = eng.pipeline.get(steps)
    device_ms = cuda_ms(lambda: eng.dispatch(batch), 1)
    if after is not None:
        after(eng)
    stats = dict(
        arch=arch, params=cfg.param_count(), n_layers=cfg.n_layers,
        precision=eng.policy.name, batch=ecfg.batch, seq_len=ecfg.seq_len,
        steps=steps, setup_s=setup_s, wall_s=wall, first_step_vs_xla=first,
        first_step=checks,
        loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        metrics_keys=sorted(hist[0]), launches=launches,
        launches_by_layout=layouts, launches_by_route=routes,
        launches_per_step=calls, step_ms=1e3 * step_s,
        tokens_per_s=tokens / step_s, device_step_ms=device_ms,
        device_tokens_per_s=tokens / (device_ms / 1e3),
        data_wait_s=[r["data_wait_s"] for r in recs],
        mfu=[r["mfu"] for r in recs],
        achieved_tflops=[r["achieved_tflops"] for r in recs],
        peak_mem_gb=peak / 1e9, opt_state_gb=eng.opt_state_bytes() / 1e9,
        params_moved=True, reduced=reduced)
    if "aux" in hist[0]:
        stats["aux"] = [h["aux"] for h in hist]
    eng.close()
    del eng, batch
    torch.cuda.empty_cache()
    return stats, cfg


# ---------------------------------------------------------------------------
# lm_1d: h2o-danube-1.8b whole on a 1-D model mesh of two ranks
# ---------------------------------------------------------------------------

# h2o-danube-1.8b whole (24 layers, d_model 2560, GQA 32/8, SwiGLU 6,912,
# untied 32,000 vocab) on a (data 1, model 2) 1-D Jigsaw mesh of two rank
# processes sharing the card, under lm_train's settings (bf16 policy,
# remat, batch 2 x 1,024 tokens, seed 0, lr 1e-4), impl="ring_fused": two
# steps.  Step 0 against lm_train's one-device step 0 on the same weights
# and batch (handed over in a file): the loss and the grad norm within
# LM_TRAIN_TOL relative and the named leaves (LM_1D_LEAVES) within
# LM_LEAF_TOL by both measures, the bounds lm_train derived from its
# noise floor for kernel="pallas" against "xla": the 1-D step differs from
# the one-device step by the same kind of rounding (each ring linear's
# partial sums rounded to bf16 at the hop, the head's dx summed over the
# ranks), so a loss or norm 1e-2 apart, or a leaf 0.1 apart, is a fault.
# ring_chunked's loss is ring_fused's bit for bit (the same products and
# cast points).  Then h2o cut to LM_1D_F32_LAYERS layers at 2 x 512 in f32
# (the seed's bf16 weights up-cast) on the two ranks against the
# one-device f32 forward, max-normalised within DENSE_F32_TOL.
LM_1D_P, LM_1D_STEPS = 2, 2
LM_1D_F32_LAYERS, LM_1D_F32_SEQ, LM_1D_F32_BATCH = 4, 512, 2
LM_1D_LEAVES = (("layers", 0, "attn", "wk", "w"),
                ("layers", -1, "ffn", "down", "w"),
                ("lm_head", "w"), ("final_norm", "scale"))
# h2o's ring linears at one rank of p = 2: (label, rows, d, m, forward
# calls, backward calls) a training step (the forward and the remat
# recompute of each of the 24 layers, one backward), as RING_SHAPES;
# wq and wo, wk and wv, gate and up share a shape (rows 2,048 = 2 x 1,024)
LM_1D_ROWS = LM_TRAIN_BATCH * LM_TRAIN_SEQ
LM_RING_SHAPES = [("h2o.wq_wo", LM_1D_ROWS, 2560, 2560, 96, 48),
                  ("h2o.wk_wv", LM_1D_ROWS, 2560, 640, 96, 48),
                  ("h2o.gate_up", LM_1D_ROWS, 2560, 6912, 96, 48),
                  ("h2o.down", LM_1D_ROWS, 6912, 2560, 48, 24)]


def lm_1d_calls(cfg, p):
    """One rank's launches of a ring_fused training step of a dense LM on
    p ranks, from the code: each of a layer's ring linears (q, k, v, o and
    the FFN's: 3 SwiGLU, 2 GELU) is one ring call in the layer's forward
    and one in its remat recompute (``transformer.apply`` checkpoints every
    layer), each p ring_fwd launches (``fused_ring._card_forward``), and
    one in the backward, p ring_bwd launches; the head is one block_matmul
    forward (outside the checkpoints) and two in its VJP (dx, dw)."""
    linears = 4 + (3 if cfg.ffn_kind == "swiglu" else 2)
    calls = linears * cfg.n_layers
    return {"ring_fwd": 2 * calls * p, "ring_bwd": calls * p,
            "block_matmul": 3}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def lm_1d_handoff(torch, eng, batch0, metrics, grads, path):
    """lm_train's one-device step 0 for lm_1d: the batch, the loss, the
    grad norm and the named leaves' gradients, to ``path``."""
    from repro_torch.optim.adam import global_norm
    torch.save({"tokens": batch0["tokens"].cpu(),
                "labels": batch0["labels"].cpu(),
                "loss": float(metrics["loss"]),
                "grad_norm": float(global_norm(grads)),
                "leaves": {"/".join(map(str, p)): _leaf(grads, p).cpu()
                           for p in LM_1D_LEAVES}}, path)


def lm_1d_phase(torch, handoff, head_rows):
    """``lm_1d``: the two ranks (``--lm-1d-rank``) on lm_train's handoff;
    returns the phase's stats (launches per rank among them, and the sums
    over ``head_rows``, block_matmul at the head's per-rank shapes)."""
    import math
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16
    from repro_torch.telemetry import build_cost_model
    tmp = handoff.parent
    (tmp / "meta.json").write_text(json.dumps({"handoff": str(handoff)}))
    res, wall = run_ranks("--lm-1d-rank", tmp, LM_1D_P)
    one = torch.load(handoff)
    cfg = get_config(LM_TRAIN_ARCH)
    want = {k: LM_1D_STEPS * v for k, v in lm_1d_calls(cfg, LM_1D_P).items()}
    for r, x in enumerate(res):
        got = {k: x["launches"][k] for k in want}
        check(got == want and sum(x["launches"].values()) == sum(
            want.values()), f"lm_1d rank {r}: launches {x['launches']}, "
            f"want {want} ({LM_1D_STEPS} steps of lm_1d_calls)")
    loss, norm = res[0]["loss"], res[0]["grad_norm"]
    check(all(x["loss"] == loss and x["grad_norm"] == norm for x in res),
          "lm_1d: the ranks report different step-0 losses or norms")
    leaves = {}
    for name in one["leaves"]:
        d2 = sum(x["leaves"][name]["diff_sq"] for x in res)
        b2 = sum(x["leaves"][name]["ref_sq"] for x in res)
        dmax = max(x["leaves"][name]["diff_max"] for x in res)
        bmax = max(x["leaves"][name]["ref_max"] for x in res)
        leaves[name] = {"rel_err": dmax / max(bmax, 1e-30),
                        "norm_err": math.sqrt(d2 / max(b2, 1e-60))}
    first = dict(loss=loss, loss_one_device=one["loss"],
                 loss_rel_err=abs(loss - one["loss"]) / abs(one["loss"]),
                 grad_norm=norm, grad_norm_one_device=one["grad_norm"],
                 grad_norm_rel_err=abs(norm - one["grad_norm"])
                 / one["grad_norm"], leaves=leaves, tol=LM_TRAIN_TOL,
                 leaf_tol=LM_LEAF_TOL)
    check(first["loss_rel_err"] <= LM_TRAIN_TOL
          and first["grad_norm_rel_err"] <= LM_TRAIN_TOL
          and all(v["rel_err"] <= LM_LEAF_TOL and v["norm_err"]
                  <= LM_LEAF_TOL for v in leaves.values()),
          f"lm_1d step 0 vs the one-device step: {first}")
    check(all(x["loss_ring_chunked"] == x["loss"] for x in res),
          f"lm_1d: ring_chunked's loss {res[0]['loss_ring_chunked']!r} is "
          f"not ring_fused's {loss!r} bit for bit")
    check(all(math.isfinite(v) for x in res for v in x["history_loss"]),
          f"lm_1d: losses {[x['history_loss'] for x in res]}")
    f32 = res[0]["f32"]
    check(f32["rel_err"] <= DENSE_F32_TOL, f"lm_1d f32 forward: {f32}")
    cm = build_cost_model(cfg, n_model=LM_1D_P, batch=LM_TRAIN_BATCH,
                          seq_len=LM_TRAIN_SEQ)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    step_ms = max(x["step_ms"] for x in res)
    stats = dict(
        arch=LM_TRAIN_ARCH, params=cfg.param_count(), n_layers=cfg.n_layers,
        mesh={"data": 1, "model": LM_1D_P}, impl="ring_fused",
        precision="bf16", batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
        steps=LM_1D_STEPS, first_step_vs_one_device=first,
        loss_ring_chunked=res[0]["loss_ring_chunked"],
        history_loss=res[0]["history_loss"],
        history_grad_norm=res[0]["history_grad_norm"],
        launches_per_rank=[x["launches"] for x in res],
        launches_per_step=lm_1d_calls(cfg, LM_1D_P),
        step_ms=[x["step_ms"] for x in res],
        device_step_ms=[x["device_step_ms"] for x in res],
        tokens_per_s=tokens / (step_ms / 1e3),
        device_tokens_per_s=tokens / (max(x["device_step_ms"]
                                          for x in res) / 1e3),
        # the cost model's FLOPs of a step (both ranks' work, which the
        # one card does) over the bf16 peak
        bound_ms=1e3 * cm.flops_per_step / PEAK_FLOPS_BF16,
        peak_mem_gb=[x["peak_mem_gb"] for x in res],
        ring_slots_gb=[x["ring_slots_gb"] for x in res],
        collectives_through_host=[x["through_host"] for x in res],
        gb_through_host=[x["through_host_gb"] for x in res],
        gb_through_host_by_op=[x["through_host_gb_by_op"] for x in res],
        gb_ipc_by_op=[x["ipc_gb_by_op"] for x in res],
        mfu=[x["mfu"] for x in res], f32_forward=f32,
        # the head's block_matmul launches of one rank's step (forward,
        # dx, dw), timed at their shapes beside the plain version, the
        # library call and the bound
        head_block_matmul_ms=per_rows(head_rows, "kernel_ms"),
        head_block_matmul_plain_ms=per_rows(head_rows, "plain_ms"),
        head_block_matmul_bound_ms=per_rows(head_rows, "bound_ms"),
        head_block_matmul_library_ms=per_rows(head_rows, "library_ms"),
        head_rows=head_rows,
        setup_s=[x["setup_s"] for x in res], wall_s=wall)
    emit(phase="lm_1d", **{k: v for k, v in stats.items()
                           if k != "head_rows"})
    return stats


def lm_1d_worker(rank, tmp):
    """One rank of ``lm_1d_phase`` (this file run with ``--lm-1d-rank``):
    the engine on the (data 1, model LM_1D_P) mesh, step 0 against the
    handoff on this rank's blocks, ring_chunked's step-0 loss, the run
    with its launches counted from 0 just before it, the step's device
    time, then the f32 forward (rank 0 compares); results to
    rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import shard_params_1d
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import fused_ring
    from repro_torch.kernels import ring as RING
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.models import registry as M
    from repro_torch.models import transformer
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    one = torch.load(json.loads((tmp / "meta.json").read_text())["handoff"])
    t0 = time.perf_counter()
    eng = TrainEngine(LM_TRAIN_ARCH, reduced=False, mesh_model=LM_1D_P,
                      scheme="1d", impl="ring_fused", kernel="pallas",
                      device="cuda", config=EngineConfig(
                          steps=LM_1D_STEPS, batch=LM_TRAIN_BATCH,
                          seq_len=LM_TRAIN_SEQ, precision="bf16", lr=1e-4,
                          log_every=1, seed=0, prefetch=1))
    cfg, jcfg, mesh = eng.cfg, eng.jcfg, eng.mesh
    check(cfg.remat and cfg.scheme == "1d" and jcfg.impl == "ring_fused"
          and cfg.kernel == "pallas" and dist.get_backend() == "gloo",
          "unexpected lm_1d config")
    batch0 = eng.pipeline.get(0)
    check(torch.equal(batch0["tokens"].cpu(), one["tokens"])
          and torch.equal(batch0["labels"].cpu(), one["labels"]),
          "lm_1d: the first batch is not lm_train's")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # step 0 on this rank's blocks against the one-device step's
    m, g = value_and_grad(eng.params, batch0, cfg, jcfg)
    res = dict(loss=float(m["loss"]),
               grad_norm=float(global_norm(g, **_norm_args(eng.params, cfg,
                                                           jcfg))),
               leaves={}, setup_s=setup_s)
    specs = dict(ptree.leaves_with_path(eng.param_specs))
    for path in LM_1D_LEAVES:
        key = "/".join(map(str, path))
        full = tuple(cfg.n_layers - 1 if k == -1 else k for k in path)
        b = mesh.block(one["leaves"][key].cuda(), specs[full]).float()
        d = _leaf(g, path).float() - b
        res["leaves"][key] = {"diff_sq": float((d * d).sum()),
                              "ref_sq": float((b * b).sum()),
                              "diff_max": float(d.abs().max()),
                              "ref_max": float(b.abs().max())}
    del g, d, b
    mc, gc = value_and_grad(eng.params, batch0, cfg,
                            jcfg.replace(impl="ring_chunked"))
    res["loss_ring_chunked"] = float(mc["loss"])
    del gc
    torch.cuda.empty_cache()

    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counted())
    comm.through_host.clear()
    comm.through_host_bytes.clear()
    fused_ring.ipc_bytes.clear()
    hist = eng.run()
    torch.cuda.synchronize()
    res.update(launches=read_counts(counted()),
               through_host=dict(comm.through_host),
               through_host_gb=sum(comm.through_host_bytes.values()) / 1e9,
               through_host_gb_by_op={k: v / 1e9 for k, v in
                                      comm.through_host_bytes.items()},
               ipc_gb_by_op={k: v / 1e9 for k, v in
                             fused_ring.ipc_bytes.items()},
               ring_slots_gb=RING.workspace_bytes() / 1e9,
               peak_mem_gb=(torch.cuda.max_memory_allocated()
                            + RING.workspace_bytes()) / 1e9)
    # ----------------------------------------------------------------------
    recs = eng.tracer.step_records()
    res.update(history_loss=[h["loss"] for h in hist],
               history_grad_norm=[h["grad_norm"] for h in hist],
               mfu=[r["mfu"] for r in recs],
               # the step after the first (its time holds set-up)
               step_ms=1e3 * (recs[-1]["dur_s"] - recs[-1]["data_wait_s"]))
    batch = eng.pipeline.get(LM_1D_STEPS)
    res["device_step_ms"] = cuda_ms(lambda: eng.dispatch(batch), 1)
    del batch, batch0
    eng.close()
    del eng
    torch.cuda.empty_cache()

    # the f32 forward: h2o cut in depth, the seed's bf16 weights up-cast
    cfg4 = get_config(LM_TRAIN_ARCH).replace(n_layers=LM_1D_F32_LAYERS)
    whole = ptree.map(lambda t: t.float(), M.init(cfg4, seed=0,
                                                  device="cuda"))
    cfg32 = cfg4.replace(param_dtype="float32", compute_dtype="float32",
                         remat=False)
    batch = {"tokens": token_rows(torch, cfg4, LM_1D_F32_SEQ,
                                  LM_1D_F32_BATCH, 0)}
    c1 = cfg32.replace(scheme="1d", impl="ring_fused", kernel="pallas")
    with torch.no_grad():
        out, _ = M.apply(shard_params_1d(whole, mesh.r, mesh.p,
                                         spec=transformer.param_spec_1d),
                         batch, c1, jigsaw_for(c1).replace(mesh=mesh))
        got = torch.cat(comm.all_gather_list(out.contiguous(),
                                             mesh.tp_group), dim=-1)
        del out
        if rank == 0:
            c0 = cfg32.replace(scheme="none", kernel="pallas")
            want, _ = M.apply(whole, batch, c0, jigsaw_for(c0))
            res["f32"] = dict(
                layers=LM_1D_F32_LAYERS, batch=LM_1D_F32_BATCH,
                seq=LM_1D_F32_SEQ, finite=bool(torch.isfinite(got).all()),
                rel_err=rel_err(got, want), mean_rel_err=mean_rel(got, want),
                tol=DENSE_F32_TOL)
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    fused_ring.ipc_bytes.clear()
    RING.release_workspaces()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# lm_1d_zoo: the moe, ssm, hybrid and audio families on a 1-D model mesh
# ---------------------------------------------------------------------------

# Four language models on a (data 1, model 2) 1-D Jigsaw mesh of two rank
# processes sharing the card, impl="ring_fused", each under its one-device
# training phase's own settings and first batch, one step: mamba2-130m
# whole (mamba_train: 2 x 4,096, the config's bf16 weights), phi3.5-moe at
# its published width cut to 2 layers (moe_train: all 16 experts, 8 a
# rank, 2 x 1,024), whisper-small whole (audio_train: 2 x 448 tokens with
# its 1,500 frames, the bf16 policy) and jamba reduced (hybrid_train: f32,
# 2 x 512; one full-width period at 8 experts holds 51.8 GB of weights,
# and two ranks sharing the card hold the same bytes as one).  Each
# engine is freed before the next.  Step 0 is judged in f32 (the engine's
# weights up-cast, no compute dtype), as mamba_train judges it: at random
# init a bf16 model's gradients move by up to their own size for one
# rounding more or less (on an H100, mamba2-130m's first in_xbc and
# conv_w moved by 1.8 and 1.1 of their largest magnitude with every
# element of the bf16 embedding one bf16 step off), so only f32 sees the
# mesh's arithmetic.  Against that phase's one-device step 0 in
# f32 (handed over in a file, ``zoo_handoff``): the loss, the grad norm
# and the aux within ZOO_TOL relative, and the named leaves (ZOO_LEAVES)
# within ZOO_LEAF_TOL by both measures, mamba_train's f32 bounds for a
# step whose GEMMs and sums run in another order (MAMBA_TRAIN_TOL,
# MAMBA_XLA_LEAF_TOL); the handoff also carries the noise floors (the
# f32 step with its embedding one f32 step off, and the bf16 step one
# bf16 step off), printed beside the errors, and the MoE models' routes,
# whose flips the phase prints (``route_flips``).
ZOO_P = 2
ZOO_TOL, ZOO_LEAF_TOL = 1e-3, 1e-2
ZOO_MODELS = ("mamba2-130m", "phi3.5-moe-42b-a6.6b", "whisper-small",
              "jamba-1.5-large-398b")
ZOO_LEAVES = {
    "mamba2-130m": (("layers", 0, "mixer", "in_xbc", "w"),
                    ("layers", 0, "mixer", "conv_w")),
    "phi3.5-moe-42b-a6.6b": (("layers", 0, "moe", "router", "w"),
                             ("layers", 0, "moe", "experts", "down")),
    "whisper-small": (("dec_layers", 0, "cross", "wk", "w"), ("dec_pos",)),
    "jamba-1.5-large-398b": (("periods", 0, "slot1", "moe", "router", "w"),
                             ("periods", 0, "slot0", "ssm", "A_log"))}
# the ring linears of the three full-width models at one rank of p = 2:
# (label, rows, d, m, forward calls, backward calls) a training step, as
# LM_RING_SHAPES (every layer checkpointed: its forward and its remat
# recompute, one backward).  mamba2-130m (2 x 4,096 rows, 24 layers):
# in_z, in_xbc, in_dt (24 heads: chunks of 12 columns) and out_proj;
# phi3.5 (2 x 1,024 rows, 2 layers): wq and wo, wk and wv; whisper (2 x
# 1,500 encoder rows, 2 x 448 decoder rows, 12 + 12 layers): the encoder's
# attention and the cross attention's k and v on the encoder rows, the
# decoder's self attention and the cross attention's q and o on its rows,
# and each side's GELU FFN
_ZM, _ZE, _ZD = MAMBA_BATCH * MAMBA_SEQ, 2 * 1500, 2 * 448
ZOO_RING_SHAPES = [
    ("mamba.in_z", _ZM, 768, 1536, 48, 24),
    ("mamba.in_xbc", _ZM, 768, 1792, 48, 24),
    ("mamba.in_dt", _ZM, 768, 24, 48, 24),
    ("mamba.out_proj", _ZM, 1536, 768, 48, 24),
    ("phi.wq_wo", MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 4096, 4096, 8, 4),
    ("phi.wk_wv", MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 4096, 1024, 8, 4),
    ("whisper.enc_attn", _ZE, 768, 768, 144, 72),
    ("whisper.dec_attn", _ZD, 768, 768, 144, 72),
    ("whisper.enc_fc1", _ZE, 768, 3072, 24, 12),
    ("whisper.enc_fc2", _ZE, 3072, 768, 24, 12),
    ("whisper.dec_fc1", _ZD, 768, 3072, 24, 12),
    ("whisper.dec_fc2", _ZD, 3072, 768, 24, 12)]
ZOO_RING_PREFIXES = ("mamba.", "phi.", "whisper.")
# the ring linears of a decode step at one rank of lm_1d_serve's two, M =
# the batch's 4 rows: (label, rows, d, m, calls a decode step, 0: no
# backward).  h2o-danube-1.8b's (24 layers): wq and wo, wk and wv, gate
# and up, down; mamba2-130m's (24 layers): in_z, in_xbc, in_dt (24 heads:
# chunks of 12 columns) and out_proj
SERVE_ROWS = 4
LM_SERVE_RING_SHAPES = [
    ("serve.h2o.wq_wo", SERVE_ROWS, 2560, 2560, 48, 0),
    ("serve.h2o.wk_wv", SERVE_ROWS, 2560, 640, 48, 0),
    ("serve.h2o.gate_up", SERVE_ROWS, 2560, 6912, 48, 0),
    ("serve.h2o.down", SERVE_ROWS, 6912, 2560, 24, 0),
    ("serve.mamba.in_z", SERVE_ROWS, 768, 1536, 24, 0),
    ("serve.mamba.in_xbc", SERVE_ROWS, 768, 1792, 24, 0),
    ("serve.mamba.in_dt", SERVE_ROWS, 768, 24, 24, 0),
    ("serve.mamba.out_proj", SERVE_ROWS, 1536, 768, 24, 0)]
ZOO_KERNELS = ("block_matmul", "ring_fwd", "ring_bwd", "ssd_intra_chunk",
               "ssd_intra_heads_bwd")


def lm_1d_zoo_calls(cfg, p):
    """One rank's launches of a ring_fused training step on p ranks, from
    the code: every linear of a layer is one ring call in the layer's
    forward and one in its remat recompute (each layer, or the hybrid's
    each period, is checkpointed), each p ring_fwd launches, and one in
    the backward, p ring_bwd launches.  A Mamba-2 mixer has 4 linears
    (in_z, in_xbc, in_dt, out_proj), attention 4 (q, k, v, o), whisper's
    cross attention 4, a dense FFN 3 (SwiGLU) or 2 (GELU), a MoE none (its
    experts are einsums); block_matmul runs the vocab-parallel head (its
    forward outside the checkpoints, dx and dw) and each MoE layer's f32
    router (forward, recompute, dx, dw); ssd_chunk runs each Mamba-2 layer
    twice (forward, recompute) and ssd_chunk_bwd once."""
    ffn = 3 if cfg.ffn_kind == "swiglu" else 2
    if cfg.family == "ssm":
        linears, moe, ssm = 4 * cfg.n_layers, 0, cfg.n_layers
    elif cfg.family == "audio":
        linears = (4 + ffn) * cfg.n_enc_layers + (8 + ffn) * cfg.n_layers
        moe = ssm = 0
    elif cfg.family == "hybrid":
        slots = [j % cfg.attn_every for j in range(cfg.n_layers)]
        linears = sum(4 + (0 if cfg.is_moe_layer(j) else ffn) for j in slots)
        moe = sum(bool(cfg.is_moe_layer(j)) for j in slots)
        ssm = sum(not cfg.is_attn_layer(j) for j in slots)
    else:
        linears, moe, ssm = 4 * cfg.n_layers, cfg.n_layers, 0
    return {"ring_fwd": 2 * linears * p, "ring_bwd": linears * p,
            "block_matmul": 3 + 4 * moe, "ssd_intra_chunk": 2 * ssm,
            "ssd_intra_heads_bwd": ssm}


def zoo_engine_args(arch):
    """(TrainEngine keyword arguments, the MoE layers) of ``arch``'s
    one-device training phase, which lm_1d_zoo repeats on the mesh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.engine import EngineConfig
    base = dict(lr=1e-4, log_every=1, seed=0, prefetch=1)
    cfg = get_config(arch)
    init = None
    if arch == "mamba2-130m":
        ecfg = EngineConfig(steps=MAMBA_TRAIN_STEPS, batch=MAMBA_TRAIN_BATCH,
                            seq_len=MAMBA_TRAIN_SEQ, **base)
    elif arch == MOE_ARCH:
        cfg = cfg.replace(n_layers=MOE_TRAIN_LAYERS)
        ecfg = EngineConfig(steps=1, batch=MOE_TRAIN_BATCH,
                            seq_len=MOE_TRAIN_SEQ, **base)
    elif arch == AUDIO_ARCH:
        ecfg = EngineConfig(steps=AUDIO_TRAIN_STEPS, batch=AUDIO_TRAIN_BATCH,
                            seq_len=AUDIO_TOKENS, precision="bf16", **base)
    else:
        from repro_torch.models import registry as M
        cfg = cfg.reduced().replace(remat=True, kernel="pallas")
        init = M.init(cfg, seed=0, device="cpu")
        ecfg = EngineConfig(steps=1, batch=HYBRID_TRAIN_BATCH,
                            seq_len=HYBRID_TRAIN_SEQ,
                            **dict(base, prefetch=0))
    moe = sum(bool(cfg.is_moe_layer(i)) for i in range(cfg.n_layers)) \
        if cfg.n_experts else 0
    return dict(reduced=False, kernel="pallas", config_override=cfg,
                config=ecfg, init_params=init), moe


def zoo_f32(torch, eng):
    """The engine's parameters (whole, or the rank's shards) up-cast to
    f32, and its JigsawConfig with no compute dtype, which runs them so:
    lm_1d_zoo judges step 0 in f32, as mamba_train does (a random-weight
    bf16 model's gradients move by up to their own size for one rounding
    more or less: the noise floor)."""
    from repro_torch.core import tree as ptree
    return (ptree.map(lambda t: t.float(), eng.params),
            eng.jcfg.replace(compute_dtype=None))


def zoo_step0(torch, eng, params, jcfg, batch0, n_moe, L):
    """Step 0 of ``eng``'s model at ``params`` under ``jcfg`` on
    ``batch0``: (metrics, grads, the first ``n_moe`` routes, each (probs,
    None, gate_idx, None, keep) on the host)."""
    from repro_torch.train.step import value_and_grad
    rec = []
    with recorded_routes(L, rec):
        m, g = value_and_grad(params, batch0, eng.cfg, jcfg)
    routes = [(r[0].float().cpu(), None, r[2].cpu(), None, r[4].cpu())
              for r in rec[:n_moe]]
    return m, g, routes


def zoo_handoff(torch, eng, path, arch):
    """A one-device training phase's step 0 for lm_1d_zoo, in f32
    (``zoo_f32``): the batch, the loss, the grad norm and the aux, the
    named leaves' gradients (ZOO_LEAVES), the MoE's routes; and two noise
    floors: the same step with every element of the f32 embedding one f32
    step off (its lowest bit flipped), and the engine's own step (its
    dtypes: bf16 for all but jamba) with its embedding one step of that
    dtype off, each against its unperturbed step."""
    from repro_torch.models import layers as L
    from repro_torch.optim.adam import global_norm
    _, n_moe = zoo_engine_args(arch)
    batch0 = eng.pipeline.get(0)
    params32, jcfg32 = zoo_f32(torch, eng)
    m, g, routes = zoo_step0(torch, eng, params32, jcfg32, batch0, n_moe, L)
    leaves = {p: _leaf(g, p).float().cpu() for p in ZOO_LEAVES[arch]}
    norm = float(global_norm(g))
    del g
    noise = {"f32": zoo_noise(torch, eng, params32, jcfg32, batch0, m,
                              norm, leaves)}
    del params32
    torch.cuda.empty_cache()
    m0, g0, _ = zoo_step0(torch, eng, eng.params, eng.jcfg, batch0, 0, L)
    own = {p: _leaf(g0, p).float().cpu() for p in ZOO_LEAVES[arch]}
    norm0 = float(global_norm(g0))
    del g0
    noise["own_dtypes"] = zoo_noise(torch, eng, eng.params, eng.jcfg,
                                    batch0, m0, norm0, own)
    torch.save({"tokens": batch0["tokens"].cpu(),
                "labels": batch0["labels"].cpu(),
                "loss": float(m["loss"]), "grad_norm": norm,
                "aux": float(m["aux"]),
                "leaves": {"/".join(map(str, p)): v
                           for p, v in leaves.items()},
                "routes": routes, "noise": noise}, path)
    torch.cuda.empty_cache()


def zoo_noise(torch, eng, params, jcfg, batch0, m, norm, leaves):
    """Step 0 at ``params`` under ``jcfg`` with every element of the
    embedding one step of its dtype off (its lowest bit flipped, which a
    second flip undoes), against the unperturbed step's metrics ``m``,
    grad norm and named leaves."""
    from repro_torch.models import layers as L
    from repro_torch.optim.adam import global_norm
    table = params["embed"]["table"]
    bits = table.view(torch.int16 if table.element_size() == 2
                      else torch.int32)
    bits.bitwise_xor_(1)
    try:
        mn, gn, _ = zoo_step0(torch, eng, params, jcfg, batch0, 0, L)
    finally:
        bits.bitwise_xor_(1)
    out = dict(loss_rel_err=abs(float(mn["loss"]) - float(m["loss"]))
               / abs(float(m["loss"])),
               grad_norm_rel_err=abs(float(global_norm(gn)) - norm) / norm,
               leaves={"/".join(map(str, p)): zoo_leaf_errs(
                   _leaf(gn, p).float().cpu(), v)
                   for p, v in leaves.items()})
    del gn
    torch.cuda.empty_cache()
    return out


def zoo_leaf_errs(got, want):
    """max|a - b| / max|b| and |a - b| / |b| of two leaves (f32)."""
    d = got - want
    return {"rel_err": float(d.abs().max() / want.abs().max().clamp_min(
        1e-30)), "norm_err": float(d.norm() / want.norm().clamp_min(1e-30))}


def lm_1d_zoo_phase(torch, zoo):
    """``lm_1d_zoo``: the two ranks (``--lm-1d-zoo-rank``) on the four
    one-device phases' handoffs in ``zoo``; returns the phase's stats, by
    model, with the launches per rank."""
    import math
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16
    from repro_torch.telemetry import build_cost_model
    t0 = time.perf_counter()
    res, wall = run_ranks("--lm-1d-zoo-rank", zoo, ZOO_P)
    models = {}
    for arch in ZOO_MODELS:
        one = torch.load(zoo / f"{arch}.pt")
        xs = [x[arch] for x in res]
        kw, _ = zoo_engine_args(arch)
        cfg, ecfg = kw["config_override"], kw["config"]
        want = {k: v for k, v in lm_1d_zoo_calls(cfg, ZOO_P).items() if v}
        for r, x in enumerate(xs):
            check(x["launches"] == want,
                  f"lm_1d_zoo {arch} rank {r}: launches {x['launches']}, "
                  f"want {want} (one step of lm_1d_zoo_calls)")
        loss, norm, aux = xs[0]["loss"], xs[0]["grad_norm"], xs[0]["aux"]
        check(all(x["loss"] == loss and x["grad_norm"] == norm
                  and x["aux"] == aux for x in xs),
              f"lm_1d_zoo {arch}: the ranks report different step-0 "
              "losses, norms or aux")
        leaves = {}
        for name in one["leaves"]:
            d2 = sum(x["leaves"][name]["diff_sq"] for x in xs)
            b2 = sum(x["leaves"][name]["ref_sq"] for x in xs)
            leaves[name] = {
                "rel_err": max(x["leaves"][name]["diff_max"] for x in xs)
                / max(max(x["leaves"][name]["ref_max"] for x in xs), 1e-30),
                "norm_err": math.sqrt(d2 / max(b2, 1e-60))}

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)
        first = dict(loss=loss, loss_one_device=one["loss"],
                     loss_rel_err=rel(loss, one["loss"]), grad_norm=norm,
                     grad_norm_one_device=one["grad_norm"],
                     grad_norm_rel_err=rel(norm, one["grad_norm"]), aux=aux,
                     aux_one_device=one["aux"],
                     aux_rel_err=rel(aux, one["aux"]) if one["aux"] else
                     abs(aux), leaves=leaves, tol=ZOO_TOL,
                     leaf_tol=ZOO_LEAF_TOL, noise_one_step=one["noise"],
                     route_flips=xs[0]["route_flips"])
        check(first["loss_rel_err"] <= ZOO_TOL
              and first["grad_norm_rel_err"] <= ZOO_TOL
              and first["aux_rel_err"] <= ZOO_TOL
              and all(v["rel_err"] <= ZOO_LEAF_TOL
                      and v["norm_err"] <= ZOO_LEAF_TOL
                      for v in leaves.values()),
              f"lm_1d_zoo {arch} step 0 vs the one-device step: {first}")
        check(all(math.isfinite(x["history_loss"]) for x in xs),
              f"lm_1d_zoo {arch}: loss {[x['history_loss'] for x in xs]}")
        tokens = ecfg.batch * ecfg.seq_len
        step_ms = max(x["device_step_ms"] for x in xs)
        cm = build_cost_model(cfg.replace(scheme="1d"), n_model=ZOO_P,
                              batch=ecfg.batch, seq_len=ecfg.seq_len)
        models[arch] = dict(
            params=cfg.param_count(), n_layers=cfg.n_layers,
            d_model=cfg.d_model, precision=xs[0]["precision"],
            batch=ecfg.batch, seq_len=ecfg.seq_len,
            first_step_vs_one_device=first,
            launches_per_rank=[x["launches"] for x in xs],
            launches_per_step=want,
            device_step_ms=[x["device_step_ms"] for x in xs],
            tokens_per_s=tokens / (step_ms / 1e3),
            # the cost model's FLOPs of a step (both ranks' work, which
            # the one card does) over the bf16 peak
            bound_ms=1e3 * cm.flops_per_step / PEAK_FLOPS_BF16,
            peak_mem_gb=[x["peak_mem_gb"] for x in xs],
            ring_slots_gb=[x["ring_slots_gb"] for x in xs],
            gb_through_host_by_op=[x["through_host_gb_by_op"] for x in xs],
            gb_ipc_by_op=[x["ipc_gb_by_op"] for x in xs],
            setup_s=[x["setup_s"] for x in xs],
            seconds=[x["seconds"] for x in xs])
        emit(phase="lm_1d_zoo_model", arch=arch, **models[arch])
    stats = dict(mesh={"data": 1, "model": ZOO_P}, impl="ring_fused",
                 models=models, wall_s=wall,
                 seconds=time.perf_counter() - t0,
                 launches_per_rank=[{k: sum(x[a]["launches"].get(k, 0)
                                            for a in ZOO_MODELS)
                                     for k in ZOO_KERNELS} for x in res])
    emit(phase="lm_1d_zoo", mesh=stats["mesh"], impl="ring_fused",
         wall_s=wall, launches_per_rank=stats["launches_per_rank"])
    return stats


def lm_1d_zoo_worker(rank, tmp):
    """One rank of ``lm_1d_zoo_phase`` (this file run with
    ``--lm-1d-zoo-rank``): for each model in turn, the engine on the (data
    1, model ZOO_P) mesh under its one-device phase's settings, step 0
    against the handoff on this rank's blocks (the routes' flips), one
    step with its launches counted from 0 just before it, the step's
    device time; the engine freed before the next; results to
    rank<r>.json."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import fused_ring
    from repro_torch.kernels import ring as RING
    from repro_torch.launch.engine import TrainEngine
    from repro_torch.models import layers as L
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    out = {}
    for arch in ZOO_MODELS:
        t0 = time.perf_counter()
        one = torch.load(tmp / f"{arch}.pt")
        kw, n_moe = zoo_engine_args(arch)
        # one step: step 0's loss and gradients do not read the schedule
        kw["config"] = dataclasses.replace(kw["config"], steps=1)
        eng = TrainEngine(arch, mesh_model=ZOO_P, scheme="1d",
                          impl="ring_fused", device="cuda", **kw)
        cfg, jcfg, mesh = eng.cfg, eng.jcfg, eng.mesh
        check(cfg.scheme == "1d" and jcfg.impl == "ring_fused"
              and cfg.kernel == "pallas" and cfg.remat
              and dist.get_backend() == "gloo",
              f"unexpected lm_1d_zoo config for {arch}")
        batch0 = eng.pipeline.get(0)
        check(torch.equal(batch0["tokens"].cpu(), one["tokens"])
              and torch.equal(batch0["labels"].cpu(), one["labels"]),
              f"lm_1d_zoo {arch}: the first batch is not the one-device "
              "phase's")
        torch.cuda.synchronize()
        res = dict(setup_s=time.perf_counter() - t0,
                   precision=eng.policy.name)

        # step 0 on this rank's blocks against the one-device step's, both
        # in f32
        params32, jcfg32 = zoo_f32(torch, eng)
        m, g, routes = zoo_step0(torch, eng, params32, jcfg32, batch0,
                                 n_moe, L)
        res.update(loss=float(m["loss"]), aux=float(m["aux"]),
                   grad_norm=float(global_norm(
                       g, **_norm_args(params32, cfg, jcfg32))), leaves={})
        flips, _ = route_flips(one["routes"], routes, eng.config.seq_len)
        res["route_flips"] = {"count": len(flips), "primary": [
            f for f in flips if f["primary"]][:8]}
        specs = dict(ptree.leaves_with_path(eng.param_specs))
        for path in ZOO_LEAVES[arch]:
            key = "/".join(map(str, path))
            b = mesh.block(one["leaves"][key].cuda(), specs[path]).float()
            d = _leaf(g, path).float() - b
            res["leaves"][key] = {"diff_sq": float((d * d).sum()),
                                  "ref_sq": float((b * b).sum()),
                                  "diff_max": float(d.abs().max()),
                                  "ref_max": float(b.abs().max())}
        del m, g, d, b, routes, params32
        torch.cuda.empty_cache()

        # -- the main path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counted())
        comm.through_host_bytes.clear()
        fused_ring.ipc_bytes.clear()
        hist = eng.run()
        torch.cuda.synchronize()
        res.update(launches={k: v for k, v in
                             read_counts(counted()).items() if v},
                   through_host_gb_by_op={k: v / 1e9 for k, v in
                                          comm.through_host_bytes.items()},
                   ipc_gb_by_op={k: v / 1e9 for k, v in
                                 fused_ring.ipc_bytes.items()},
                   ring_slots_gb=RING.workspace_bytes() / 1e9,
                   peak_mem_gb=(torch.cuda.max_memory_allocated()
                                + RING.workspace_bytes()) / 1e9,
                   history_loss=hist[0]["loss"])
        # ------------------------------------------------------------------
        batch = eng.pipeline.get(1)
        res["device_step_ms"] = cuda_ms(lambda: eng.dispatch(batch), 1)
        eng.close()
        del eng, batch, batch0, hist
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    RING.release_workspaces()
    dist.destroy_process_group()
    return 0


# ``lm_1d_serve``: serving every LM family on a (data 1, model SERVE_P)
# 1-D mesh of two rank processes sharing the card (``--lm-1d-serve-rank``:
# gloo between them, the ring's slots and the features' hops mapped by
# CUDA IPC), impl="ring_fused", kernel="pallas", one model's weights and
# caches freed before the next.  Each case: (label, arch, the config's
# changes, reduced, batch, prompt length, f32 teacher-forced steps, bf16
# greedy tokens).  h2o whole in the heads mode (its 8 kv heads, 4 a rank),
# h2o cut to 4 layers with kv_shard="seq" (the sliding window's cache
# slots cut over the ranks), mamba2-130m whole (12 of its 24 heads a rank,
# its conv channels re-laid to the heads through the IPC slots),
# whisper-small whole (the encoder's states cut on D), phi3.5 at its
# published width cut to 2 layers (8 of its 16 experts a rank) and jamba
# reduced.  For each, in f32 (the weights up-cast, the cache f32): the
# prompt's prefill (fused for the dense and moe archs, token by token for
# the others, as ``serve/step.py``) and the teacher-forced decode steps
# on the mesh against the one-device ``prefill_cache`` / ``decode_step``
# on the same weights (rank 0), the logits max-normalised within
# SERVE_TOL of the family (the CPU tests' bounds,
# ``tests/test_torch_lm_mesh_serve.py``) beside two one-device controls
# (``serve_f32_errors``); then, under the config's own dtypes, the greedy
# serving loop on the mesh as ``generate`` runs it (``serve/step.py``'s
# ``prefill``, then ``make_serve_step``'s steps: its launches counted from
# 0 just before it, equal to ``lm_1d_serve_calls``'s a step times the
# steps, and the first decode step's equal to it; ``generate`` itself,
# eager on a mesh, gives the same tokens in SERVE_GENERATE's cases), its
# greedy tokens beside the one-device ``generate``'s (graphed) and how
# many agree; ms of the prefill and a decode token on each rank, the peak
# a rank with the ring's slots, the bytes the first decode step moves
# through host memory and through the IPC slots, and a step's bytes bound
# at the rank's shapes (its weight shards and cache block read once);
# beside them the one-device graphed ms a token of PERF.md §5
# (SERVE_ONE_DEVICE_MS: other cuts of some of the models).
SERVE_P = 2
SERVE_CASES = [
    ("h2o_heads", "h2o-danube-1.8b", {}, False, 4, 128, 2, 16),
    ("h2o_seq", "h2o-danube-1.8b", {"n_layers": 4, "kv_shard": "seq"},
     False, 4, 128, 6, 8),
    ("mamba", "mamba2-130m", {}, False, 4, 2, 2, 4),
    ("whisper", "whisper-small", {}, False, 4, 2, 2, 4),
    ("phi", "phi3.5-moe-42b-a6.6b", {"n_layers": 2}, False, 4, 128, 6, 8),
    ("jamba", "jamba-1.5-large-398b", {}, True, 4, 8, 6, 8)]
SERVE_TOL = {"ssm": 1e-4, "hybrid": 1e-4}      # else 1e-5
# the cases whose tokens generate itself also makes on the mesh (those of
# cheap steps: each step is host-bound)
SERVE_GENERATE = ("h2o_seq", "phi", "jamba")
# PERF.md §5's one-device graphed decode steps (batch 4; h2o from a
# 4,160-token prompt, phi3.5 at 4 layers, jamba at one full-width period of
# 8 experts), ms a token, printed beside the mesh's (H100 80GB HBM3, 700 W)
SERVE_ONE_DEVICE_MS = {"h2o-danube-1.8b": 41.32, "mamba2-130m": 5.35,
                       "whisper-small": 7.37, "phi3.5-moe-42b-a6.6b": 9.91,
                       "jamba-1.5-large-398b": 35.46}
SERVE_KERNELS = ("block_matmul", "ring_fwd")


def lm_1d_serve_calls(cfg, p):
    """One rank's launches of a ring_fused decode step (and of a fused
    prefill, the same linears once each) on p ranks, from the code: every
    linear of a layer is one ring call, p ring_fwd launches (attention's
    q, k, v, o; a Mamba-2 mixer's in_z, in_xbc, in_dt, out_proj; whisper's
    cross attention's q, k, v, o beside its self attention; a dense FFN's
    3 (SwiGLU) or 2 (GELU); a MoE layer's experts are einsums); the
    vocab-parallel head is one block_matmul launch and each MoE layer's f32
    router one more.  Also ``encode``: the ring launches of whisper's
    encoder (``start_cache``, once a prompt)."""
    ffn = 3 if cfg.ffn_kind == "swiglu" else 2
    encode = 0
    if cfg.family == "ssm":
        linears, moe = 4 * cfg.n_layers, 0
    elif cfg.family == "audio":
        linears, moe = (8 + ffn) * cfg.n_layers, 0
        encode = (4 + ffn) * cfg.n_enc_layers * p
    elif cfg.family == "hybrid":
        slots = [j % cfg.attn_every for j in range(cfg.n_layers)]
        linears = sum(4 + (0 if cfg.is_moe_layer(j) else ffn) for j in slots)
        moe = sum(bool(cfg.is_moe_layer(j)) for j in slots)
    else:
        moe = sum(bool(cfg.is_moe_layer(i)) for i in range(cfg.n_layers)) \
            if cfg.n_experts else 0
        linears = 4 * cfg.n_layers + ffn * (cfg.n_layers - moe)
    return {"ring_fwd": linears * p, "block_matmul": 1 + moe}, encode


def serve_case_cfg(arch, over, reduced):
    """A case's config on the mesh (scheme 1d, ring_fused, pallas) and on
    one device."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    cfg = (cfg.reduced() if reduced else cfg).replace(kernel="pallas",
                                                      **over)
    return (cfg.replace(scheme="1d", impl="ring_fused"),
            cfg.replace(scheme="none"))


def serve_gemm_shapes():
    """block_matmul's launches of lm_1d_serve's decode steps at one rank's
    shapes (M = the batch's rows): each full-width model's vocab-parallel
    head (the gathered features against the rank's vocab rows) and
    phi3.5's f32 router (whole on every rank), as ``lm_gemm_rows`` takes
    them, with their launches a decode step."""
    out = []
    for label, arch, over, reduced, b, *_ in SERVE_CASES:
        cfg, _ = serve_case_cfg(arch, over, reduced)
        if reduced or label == "h2o_seq":
            continue
        out.append((f"serve.{label}.head_1d", b, cfg.d_model,
                    cfg.vocab_padded // SERVE_P, "none", 1, "bfloat16"))
        if cfg.n_experts:
            out.append((f"serve.{label}.router", b, cfg.d_model,
                        cfg.n_experts, "none", cfg.n_layers, "float32"))
    return out


def lm_1d_serve_phase(torch, BM, SM90, ref):
    """``lm_1d_serve``: block_matmul at the decode steps' per-rank shapes
    (``serve_gemm_shapes``), then the two ranks
    (``--lm-1d-serve-rank``); checks their reports and returns the
    phase's stats by case, with the launches per rank, the block_matmul
    rows and their worst error."""
    import shutil
    import tempfile
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(46)
    gemm_rows, gemm_worst = lm_gemm_rows(torch, BM, SM90, ref, gen,
                                         serve_gemm_shapes())
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve1d_"))
    t0 = time.perf_counter()
    try:
        res, wall = run_ranks("--lm-1d-serve-rank", tmp, SERVE_P)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cases = {}
    for label, arch, over, reduced, b, s, n32, n16 in SERVE_CASES:
        xs = [x[label] for x in res]
        cfg, _ = serve_case_cfg(arch, over, reduced)
        per_step, encode = lm_1d_serve_calls(cfg, SERVE_P)
        tokenwise = cfg.family in ("ssm", "hybrid", "audio")
        n_steps = (s if tokenwise else 1) + n16 - 1
        want_gen = {k: v * n_steps + (encode if k == "ring_fwd" else 0)
                    for k, v in per_step.items()}
        for r, x in enumerate(xs):
            check(x["step_launches"] == per_step,
                  f"lm_1d_serve {label} rank {r}: a decode step's launches "
                  f"{x['step_launches']}, want {per_step} "
                  "(lm_1d_serve_calls)")
            check(x["launches"] == want_gen,
                  f"lm_1d_serve {label} rank {r}: the prefill's and the "
                  f"decode steps' launches {x['launches']}, want {want_gen}")
            check(x["tokens"] == xs[0]["tokens"],
                  f"lm_1d_serve {label}: the ranks' greedy tokens differ")
            check(x.get("generate_same_tokens", True),
                  f"lm_1d_serve {label} rank {r}: generate's tokens are not "
                  "the prefill's and the decode steps'")
        f32 = xs[0]["f32"]
        check(f32["ok"], f"lm_1d_serve {label}: the f32 logits on the mesh "
              f"vs one device: {f32}")
        cases[label] = dict(
            card=card, arch=arch, changes=over, reduced=reduced,
            params=cfg.param_count(), n_layers=cfg.n_layers,
            d_model=cfg.d_model, batch=b, prompt=s,
            prefill="token by token" if tokenwise else "fused",
            kv_layout=xs[0]["kv_layout"], f32_vs_one_device=f32,
            tokens=xs[0]["tokens"],
            one_device_tokens=xs[0]["one_device_tokens"],
            tokens_agree=xs[0]["tokens_agree"],
            tokens_total=b * n16,
            launches_per_decode_step=per_step,
            launches_per_rank=[x["launches"] for x in xs],
            prefill_ms=[x["prefill_ms"] for x in xs],
            ms_per_token=[x["ms_per_token"] for x in xs],
            one_device_graphed_ms_per_token_perf_md=SERVE_ONE_DEVICE_MS.get(
                arch),
            peak_mem_gb=[x["peak_mem_gb"] for x in xs],
            ring_slots_gb=[x["ring_slots_gb"] for x in xs],
            step_bytes_through_host=[x["through_host_bytes"] for x in xs],
            step_bytes_ipc=[x["ipc_bytes"] for x in xs],
            step_bound_ms=[x["bound_ms"] for x in xs],
            seconds=[x["seconds"] for x in xs])
        emit(phase="lm_1d_serve_case", case=label, **cases[label])
    stats = dict(card=card, mesh={"data": 1, "model": SERVE_P},
                 impl="ring_fused", cases=cases, wall_s=wall,
                 seconds=time.perf_counter() - t0,
                 block_matmul_rows=gemm_rows, block_matmul_worst=gemm_worst,
                 launches_per_rank=[{k: sum(x[c]["launches"].get(k, 0)
                                            for c in x)
                                     for k in SERVE_KERNELS} for x in res])
    emit(phase="lm_1d_serve", card=card, mesh=stats["mesh"],
         impl="ring_fused", wall_s=wall, seconds=stats["seconds"],
         launches_per_rank=stats["launches_per_rank"])
    return stats


def _serve_prefill(S, M, params, prompts, cfg, jcfg, max_len, dtype,
                   frames, teacher):
    """The prefill and the teacher-forced decode steps as serving runs
    them (the fused prefill where the family has one, else token by
    token, in a cache of ``dtype``); returns the logits of the prefill's
    last position and of each step (on a mesh, the rank's vocab
    block)."""
    extra = None if frames is None else {"frames": frames}
    if M.has_fused_prefill(cfg) and cfg.local_global_ratio == 0:
        logits, cache = M.prefill_cache(params, {"tokens": prompts}, cfg,
                                        jcfg, max_len, dtype=dtype)
        logits = logits[:, -1:]
    else:
        from repro_torch.models import layers as L
        cache = S.start_cache(params, prompts, cfg, jcfg, max_len, dtype,
                              extra)
        rows = L.rows_block(prompts, L.mesh_1d(jcfg))
        for t in range(prompts.shape[1]):
            logits, cache = M.decode_step(params, cache, rows[:, t:t + 1],
                                          cfg, jcfg)
    out = [logits]
    for i in range(teacher.shape[1]):
        logits, cache = M.decode_step(params, cache, teacher[:, i:i + 1],
                                      cfg, jcfg)
        out.append(logits)
    return out


def serve_f32_errors(y, z, zn, zx, tol):
    """The f32 logits of the mesh (``y``: the prefill's last position and
    each step, gathered over the vocab) against the one-device run's
    (``z``) and, beside them, two one-device controls against ``z``: its
    embedding one f32 step off (``zn``, the noise floor) and its products
    in torch.matmul's order (``zx``, kernel="xla": the noise of another
    summation order): max |a - b|, max-normalised (over max |b|, the
    logits' scale), and elementwise within tol + tol |b|.  Judged
    max-normalised within ``tol`` (the CPU tests' numbers): at these full
    widths the xla control alone leaves tol + tol |b| elementwise, so that
    form cannot tell a fault from a summation order here."""
    def errs(a_s):
        d = max(float((a - c).abs().max()) for a, c in zip(a_s, z))
        scale = max(float(c.abs().max()) for c in z)
        return dict(max_abs_err=d, max_norm_err=d / max(scale, 1e-30),
                    elementwise_ok=all(bool(((a - c).abs()
                                             <= tol + tol * c.abs()).all())
                                       for a, c in zip(a_s, z)))
    out = dict(tol=tol, steps=len(y), **errs(y),
               logits_scale=max(float(c.abs().max()) for c in z),
               noise_floor=errs(zn), xla_order=errs(zx))
    out["ok"] = out["max_norm_err"] <= tol
    return out


def lm_1d_serve_worker(rank, tmp):
    """One rank of ``lm_1d_serve_phase`` (this file run with
    ``--lm-1d-serve-rank``): each case of SERVE_CASES in turn, as the
    phase's comment says; results to rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.convert import shard_params_1d
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import fused_ring
    from repro_torch.kernels import ring as RING
    from repro_torch.launch.mesh import make_ring_mesh
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_ring_mesh(SERVE_P, 1, device="cuda")
    check(dist.get_backend() == "gloo", "lm_1d_serve: not gloo")
    out = {}
    for label, arch, over, reduced, b, s, n32, n16 in SERVE_CASES:
        t0 = time.perf_counter()
        cfg, cfg1 = serve_case_cfg(arch, over, reduced)
        jcfg = jigsaw_for(cfg).replace(mesh=mesh)
        jcfg1 = jigsaw_for(cfg1)
        max_len = s + max(n32, n16) + 8
        whole = M.init(cfg1, seed=0, device="cuda")
        params = shard_params_1d(whole, mesh.r, SERVE_P,
                                 spec=M.param_rule(cfg, "1d"))
        if rank:
            del whole
        gen = torch.Generator().manual_seed(17)
        prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                dtype=torch.int32).cuda()
        teacher = torch.randint(0, cfg.vocab_size, (b, n32), generator=gen,
                                dtype=torch.int32).cuda()
        frames = None
        if cfg.family == "audio":
            frames = torch.randn(b, cfg.n_frames, cfg.d_model,
                                 generator=gen).cuda()
        res = dict(kv_layout=None)

        # f32: the mesh against one device, on the same (up-cast) weights
        with torch.no_grad():
            up = ptree.map(lambda t: t.float(), params)
            y = _serve_prefill(S, M, up, prompts, cfg,
                               jcfg.replace(compute_dtype=None), max_len,
                               torch.float32, frames, teacher)
            y = [comm.all_gather(t.contiguous(), mesh.tp_group, -1)
                 for t in y]
            del up
            if cfg.n_kv_heads:
                res["kv_layout"] = L.kv_mode(cfg, SERVE_P)
            if rank == 0:
                up = ptree.map(lambda t: t.float(), whole)
                j32 = jcfg1.replace(compute_dtype=None)
                z = _serve_prefill(S, M, up, prompts, cfg1, j32,
                                   max_len, torch.float32, frames, teacher)
                # the noise floor: the one-device run with every element
                # of the f32 embedding one f32 step off (its lowest bit
                # flipped)
                bits = up["embed"]["table"].view(torch.int32)
                bits.bitwise_xor_(1)
                try:
                    zn = _serve_prefill(S, M, up, prompts, cfg1, j32,
                                        max_len, torch.float32, frames,
                                        teacher)
                finally:
                    bits.bitwise_xor_(1)      # (up may be whole itself)
                # and with every product in torch.matmul's order
                zx = _serve_prefill(S, M, up, prompts,
                                    cfg1.replace(kernel="xla"),
                                    jigsaw_for(cfg1.replace(kernel="xla"))
                                    .replace(compute_dtype=None), max_len,
                                    torch.float32, frames, teacher)
                del up, bits
                res["f32"] = serve_f32_errors(y, z, zn, zx,
                                              SERVE_TOL.get(cfg.family,
                                                            1e-5))
                del z, zn, zx
            del y
        torch.cuda.empty_cache()

        # bf16 (the config's own dtypes): the prefill and the decode steps
        # through serve/step.py's entry points, as generate runs them
        extra = None if frames is None else {"frames": frames}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()                # rank 0's one-device runs are done
        step = S.make_serve_step(cfg, jcfg)
        with torch.no_grad():
            zero_counts(counted())
            # -- the main path: counts to 0 just before, read just after ---
            t1 = time.perf_counter()
            nxt, cache = S.prefill(params, prompts, cfg, jcfg, max_len,
                                   extra_batch=extra)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            before = read_counts(counted())
            comm.through_host_bytes.clear()
            fused_ring.ipc_bytes.clear()
            toks = [nxt]
            for i in range(n16 - 1):
                nxt, cache = step(params, cache, nxt)
                toks.append(nxt)
                if i == 0:            # the first decode step's own
                    torch.cuda.synchronize()
                    res["step_launches"] = {
                        k: v - before[k] for k, v in
                        read_counts(counted()).items() if v - before[k]}
                    res["through_host_bytes"] = dict(
                        comm.through_host_bytes)
                    res["ipc_bytes"] = dict(fused_ring.ipc_bytes)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            res["launches"] = {k: v for k, v in
                               read_counts(counted()).items() if v}
            # --------------------------------------------------------------
        tokens = torch.cat(toks, dim=1)
        res["tokens"] = tokens.cpu().tolist()
        res.update(prefill_ms=1e3 * (t2 - t1),
                   ms_per_token=1e3 * (t3 - t2) / max(n16 - 1, 1),
                   ring_slots_gb=RING.workspace_bytes() / 1e9,
                   peak_mem_gb=(torch.cuda.max_memory_allocated()
                                + RING.workspace_bytes()) / 1e9)
        if label in SERVE_GENERATE:
            # generate itself (graph=None: the eager loop on a mesh), the
            # same tokens
            res["generate_same_tokens"] = torch.equal(S.generate(
                params, prompts, cfg, jcfg, steps=n16, max_len=max_len,
                extra_batch=extra), tokens)
        shard_bytes = sum(t.numel() * t.element_size()
                          for t in ptree.leaves(params))
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in ptree.leaves(cache))
        res["bound_ms"] = 1e3 * (shard_bytes + cache_bytes) / PEAK_BYTES
        del cache, nxt
        if rank == 0:
            one = S.generate(whole, prompts, cfg1, jcfg1, steps=n16,
                             max_len=max_len, extra_batch=extra)
            res["one_device_tokens"] = one.cpu().tolist()
            res["tokens_agree"] = int((one == tokens).sum())
            del one, whole
            S.clear_graphs()
        else:
            res["one_device_tokens"], res["tokens_agree"] = None, None
        del params, tokens
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[label] = res
        dist.barrier()
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))
    RING.release_workspaces()
    dist.destroy_process_group()
    return 0


# mamba2-130m training: TrainEngine whole (24 layers, full width) under the
# config's own dtypes (bf16 weights) with remat, batch 2 x 4,096 tokens,
# three steps.  Step 0 is judged in f32 (the engine's weights up-cast), as
# mamba_forward judges the logits: the kernels' step against the same
# step with the plain SSD term (the plain forward and backward,
# ref.ssd_intra_heads_ref and ref.ssd_intra_heads_bwd_ref) and against
# kernel="xla": the loss and the grad norm relative within
# MAMBA_TRAIN_TOL, and every leaf's gradient by max|a - b| / max|b| and
# by the norm of its difference over its norm: against the plain SSD term
# within MAMBA_TRAIN_TOL (only the term's summation order differs: 5.7e-5
# measured), against kernel="xla" within MAMBA_XLA_LEAF_TOL (every GEMM's
# order differs, through 24 layers' backward: 1.1e-3 measured at layer
# 3's in_xbc weight, 4.4e-4 by norm); the zeroed-embedding control gives
# ~1 by both
MAMBA_TRAIN_STEPS, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 3, 2, 4096
MAMBA_TRAIN_TOL = 1e-3
MAMBA_XLA_LEAF_TOL = 1e-2
# jamba-1.5-large-398b's reduced config (d_model 256, one period of an SSM
# slot of 8 heads in 8 groups with a dense FFN and an attention slot with
# 4 experts top-2), remat on, f32: one step on the card against the port's
# own CPU step from the same weights and batch: loss and grad norm
# relative, every leaf's gradient max|a - b| / max|b| (HYBRID_TRAIN_TOL:
# f32 on both devices, the orders differ)
HYBRID_TRAIN_SEQ, HYBRID_TRAIN_BATCH = 512, 2
HYBRID_TRAIN_TOL = 1e-3


def grad_parity(torch, m, g, m_ref, g_ref):
    """Loss and grad norm relative, and the worst gradient leaf
    (``leaf_errs``), of (m, g) against (m_ref, g_ref)."""
    from repro_torch.optim.adam import global_norm
    lk, lr_ = float(m["loss"]), float(m_ref["loss"])
    nk, nr = float(global_norm(g)), float(global_norm(g_ref))
    return dict(loss=lk, loss_ref=lr_, loss_rel_err=abs(lk - lr_) / abs(lr_),
                grad_norm=nk, grad_norm_ref=nr,
                grad_norm_rel_err=abs(nk - nr) / nr,
                **leaf_errs(torch, g, g_ref))


def parity_passes(r, tol, leaf_tol=None):
    leaf_tol = tol if leaf_tol is None else leaf_tol
    return (r["loss_rel_err"] <= tol and r["grad_norm_rel_err"] <= tol
            and r["max_leaf_rel_err"] <= leaf_tol
            and r["max_leaf_norm_err"] <= leaf_tol)


def mamba_first_step(torch, ref, eng):
    """Step 0 of the engine's weights and batch, in f32: the kernels'
    against the plain SSD term and against kernel="xla", beside the
    control the bound must refuse (the tied embedding and head zeroed)."""
    from repro_torch.core import tree as ptree
    from repro_torch.train.step import value_and_grad
    batch0 = eng.pipeline.get(0)
    cfg32, params32 = mamba_f32(torch, eng.cfg, eng.params)

    def vg(jcfg):
        return value_and_grad(params32, batch0, cfg32, jcfg)
    mk, gk = vg(eng.jcfg)
    with plain_ssd(ref):
        mp, gp = vg(eng.jcfg)
    vs_plain = grad_parity(torch, mk, gk, mp, gp)
    del gp
    mx, gx = vg(eng.jcfg.replace(kernel="xla"))
    vs_xla = grad_parity(torch, mk, gk, mx, gx)
    finite = all(bool(torch.isfinite(t).all()) for t in ptree.leaves(gk))
    del gx
    params32["embed"]["table"].zero_()
    mc, gc = vg(eng.jcfg)
    control = grad_parity(torch, mc, gc, mk, gk)
    del gc, gk, params32
    torch.cuda.empty_cache()
    check(finite and parity_passes(vs_plain, MAMBA_TRAIN_TOL)
          and parity_passes(vs_xla, MAMBA_TRAIN_TOL, MAMBA_XLA_LEAF_TOL),
          f"mamba_train step 0 in f32: finite {finite}, vs the plain SSD "
          f"term {vs_plain}, vs kernel='xla' {vs_xla}")
    check(not parity_passes(control, MAMBA_TRAIN_TOL, MAMBA_XLA_LEAF_TOL),
          f"mamba_train: the zeroed-embedding control passes the bounds: "
          f"{control}")
    return dict(tol=MAMBA_TRAIN_TOL, xla_leaf_tol=MAMBA_XLA_LEAF_TOL,
                grads_finite=finite,
                f32_vs_plain_ssd=vs_plain, f32_vs_xla=vs_xla,
                control_zero_embedding=control)


def mamba_step_breakdown(torch, eng, L, SSD, SSDB):
    """One more training step of the engine, its parts timed by CUDA
    events around each call (the SSD forward launches, the recompute's
    among them; the SSD backward launches; the whole chunked scans'
    forwards, ``_ssd_chunked``), then one step under ``torch.profiler``:
    the device-busy time, the idle share, the kernels launched and the
    kernels with the most device time."""
    batch = eng.pipeline.get(0)
    spans = {}
    wrapped = [(SSD, "ssd_intra_heads", "ssd_forward"),
               (SSDB, "ssd_intra_heads_bwd", "ssd_backward"),
               (L, "_ssd_chunked", "ssd_chunked_forward")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]

    def timed(real, label):
        def fn(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = real(*a, **k)
            e1.record()
            spans.setdefault(label, []).append((e0, e1))
            return out
        if hasattr(real, "launches"):
            # a wrapper counts through its module name: the stand-in
            # carries the count while it stands there
            fn.launches = real.launches
        return fn
    for (mod, name, label), (_, _, real) in zip(wrapped, saved):
        setattr(mod, name, timed(real, label))
    try:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        eng.dispatch(batch)
        e1.record()
        torch.cuda.synchronize()
    finally:
        for mod, name, real in saved:
            if hasattr(real, "launches"):
                real.launches = getattr(mod, name).launches
            setattr(mod, name, real)
    step_ms = e0.elapsed_time(e1)
    parts = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in
             spans.items()}
    calls = {k: len(v) for k, v in spans.items()}
    # the device's activity only: the host's ops of a step of ~35,000
    # launches would cost the smoke seconds to record
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.dispatch(batch)
        torch.cuda.synchronize()
    rows = prof.key_averages()

    def dev_ms(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name) / 1e3
        return 0.0
    kernels = [e for e in rows if dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in kernels)
    by_name = {tag: sum(dev_ms(e) for e in kernels if tag in e.key)
               for tag in ("ssd_bwd_kernel", "ssd_intra_kernel", "gemm")}
    return dict(
        step_ms=step_ms, parts_ms=parts, parts_calls=calls,
        ssd_chunked_less_intra_forward_ms=parts.get("ssd_chunked_forward",
                                                    0.0)
        - parts.get("ssd_forward", 0.0),
        profiled_device_busy_ms=busy,
        idle_share=1.0 - busy / step_ms,
        profiled_kernel_launches=sum(e.count for e in kernels),
        profiled_device_ms_by_name=by_name,
        profiled_top_kernels=[
            {"kernel": e.key[:80], "calls": e.count,
             "device_ms": dev_ms(e)}
            for e in sorted(kernels, key=lambda e: -dev_ms(e))[:8]])


def ssm_train_phases(torch, BM, SSD, SSDB, ref, zoo):
    """``mamba_train`` (mamba2-130m whole, three steps, step 0 judged in
    f32 against the plain SSD term and kernel="xla", the step's parts) and
    ``hybrid_train`` (jamba reduced, one step, against the port's CPU
    step); each hands its step 0 over to lm_1d_zoo in ``zoo``.  Returns
    their stats."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as ptree
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M
    from repro_torch.train.step import value_and_grad
    torch.cuda.empty_cache()
    base = dict(lr=1e-4, log_every=1, seed=0, prefetch=1)
    breakdown = {}

    def mamba_checks(eng):
        t0 = time.perf_counter()
        out = mamba_first_step(torch, ref, eng)
        out["seconds"] = time.perf_counter() - t0
        return out

    def mamba_after(eng):
        t0 = time.perf_counter()
        breakdown.update(mamba_step_breakdown(torch, eng, L, SSD, SSDB),
                         seconds=time.perf_counter() - t0)
    mt, _ = lm_train_run(torch, BM, "mamba2-130m", {}, EngineConfig(
        steps=MAMBA_TRAIN_STEPS, batch=MAMBA_TRAIN_BATCH,
        seq_len=MAMBA_TRAIN_SEQ, **base), "mamba_train",
        first_step=mamba_checks, after=mamba_after, zoo=zoo)
    mt["breakdown"] = breakdown
    emit(phase="mamba_train", **mt)

    cfg = get_config(HYBRID_ARCH).reduced().replace(remat=True,
                                                    kernel="pallas")
    init = M.init(cfg, seed=0, device="cpu")
    ecfg = EngineConfig(steps=1, batch=HYBRID_TRAIN_BATCH,
                        seq_len=HYBRID_TRAIN_SEQ, **dict(base, prefetch=0))

    def hybrid_checks(eng):
        """Step 0's gradients on the card against the CPU's."""
        batch0 = eng.pipeline.get(0)
        m, g = value_and_grad(eng.params, batch0, eng.cfg, eng.jcfg)
        cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in batch0.items()}
        mc, gc = value_and_grad(init, cpu, eng.cfg, eng.jcfg)
        res = grad_parity(torch, m, ptree.map(lambda t: t.cpu(), g), mc, gc)
        check(parity_passes(res, HYBRID_TRAIN_TOL), f"hybrid_train step 0, "
              f"card vs CPU: {res}")
        return dict(tol=HYBRID_TRAIN_TOL, card_vs_cpu=res)
    ht, hcfg = lm_train_run(torch, BM, HYBRID_ARCH, {"remat": True}, ecfg,
                            "hybrid_train", first_step=hybrid_checks,
                            reduced=True, init_params=init, zoo=zoo)
    cpu = TrainEngine(HYBRID_ARCH, reduced=False, kernel="pallas",
                      device="cpu", config_override=cfg, config=ecfg,
                      init_params=init)
    hist = cpu.run()
    rel = {k: abs(ht[k][0] - hist[0][k]) / abs(hist[0][k])
           for k in ("loss", "grad_norm")}
    check(all(v <= HYBRID_TRAIN_TOL for v in rel.values()),
          f"hybrid_train: the card's step against the CPU engine's: {rel}")
    ht.update(cpu_engine_rel_err=rel, d_model=hcfg.d_model,
              ssm_heads=hcfg.ssm_heads, ssm_groups=hcfg.ssm_groups,
              n_experts=hcfg.n_experts)
    emit(phase="hybrid_train", label="reduced (jamba-1.5-large-398b"
         ".reduced(), d_model 256, remat)", **ht)
    return mt, ht


def counted():
    from repro_torch.kernels.graphs import counted_kernels
    return counted_kernels()


def lm_train_phases(torch, BM, SM90, ref, zoo):
    """``lm_train`` (h2o whole, four steps, step 0 against kernel="xla",
    block_matmul at the step's shapes in its three layouts),
    ``audio_train``, ``moe_train``, ``lm_1d`` (h2o on two ranks, step 0
    against lm_train's) and ``lm_1d_zoo`` (four models on two ranks, step
    0 against their one-device phases' handed over in ``zoo``); returns
    their stats, the GEMM rows and the worst GEMM error."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm1d_"))
    try:
        return _lm_train_phases(torch, BM, SM90, ref, tmp / "step0.pt", zoo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _lm_train_phases(torch, BM, SM90, ref, handoff, zoo):
    from repro_torch.launch.engine import EngineConfig
    torch.cuda.empty_cache()
    base = dict(lr=1e-4, log_every=1, seed=0, prefetch=1)
    lm, cfg = lm_train_run(torch, BM, LM_TRAIN_ARCH, {}, EngineConfig(
        steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
        precision="bf16", **base), "lm_train", compare=True,
        handoff=handoff)
    gen = torch.Generator(device="cuda").manual_seed(45)
    m = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    shapes = lm_gemm_shapes(cfg, "h2o.train", m)
    fwd_rows, w1 = lm_gemm_rows(torch, BM, SM90, ref, gen, [
        # forward and the remat recompute (the head: forward only)
        (lbl, mm, k, n, epi, c if lbl.endswith("head") else 2 * c, dt)
        for lbl, mm, k, n, epi, c, dt in shapes])
    bwd_rows, w2 = lm_bwd_rows(torch, BM, SM90, ref, gen, shapes)
    rows = fwd_rows + bwd_rows
    lm.update(block_matmul_ms=per_rows(rows, "kernel_ms"),
              block_matmul_bound_ms=per_rows(rows, "bound_ms"),
              block_matmul_library_ms=per_rows(rows, "library_ms"),
              block_matmul_plain_ms=per_rows(rows, "plain_ms"))
    emit(phase="lm_train", **lm)
    audio, _ = lm_train_run(torch, BM, AUDIO_ARCH, {}, EngineConfig(
        steps=AUDIO_TRAIN_STEPS, batch=AUDIO_TRAIN_BATCH,
        seq_len=AUDIO_TOKENS, precision="bf16", **base), "audio_train",
        zoo=zoo)
    emit(phase="audio_train", **audio)
    moe, mcfg = lm_train_run(torch, BM, MOE_ARCH,
                             {"n_layers": MOE_TRAIN_LAYERS}, EngineConfig(
                                 steps=1, batch=MOE_TRAIN_BATCH,
                                 seq_len=MOE_TRAIN_SEQ, **base), "moe_train",
                             zoo=zoo)
    check(moe["launches_by_route"].get("f32") == 4 * mcfg.n_layers
          and moe["aux"][0] > 0, f"moe_train: the router's f32 launches "
          f"{moe['launches_by_route']} (want {4 * mcfg.n_layers}: forward, "
          f"remat, dx, dw a layer), aux {moe['aux']}")
    emit(phase="moe_train", published_layers=32, **moe)
    # lm_1d's vocab-parallel head at one rank's shape: the gathered
    # features (M 2,048, K 2,560) against the rank's vocab rows
    # (vocab_padded / LM_1D_P); its forward, dx and dw, one launch each a
    # step and rank
    head = [("h2o.head_1d", m, cfg.d_model, cfg.vocab_padded // LM_1D_P,
             "none", 1, "bfloat16")]
    head_fwd, w3 = lm_gemm_rows(torch, BM, SM90, ref, gen, head)
    head_bwd, w4 = lm_bwd_rows(torch, BM, SM90, ref, gen, head)
    torch.cuda.empty_cache()
    lm1d = lm_1d_phase(torch, handoff, head_fwd + head_bwd)
    # lm_1d_zoo's block_matmul launches at their per-rank shapes: the
    # vocab-parallel heads (the gathered features against the rank's vocab
    # rows; forward, dx, dw) of the three full-width models and phi3.5's
    # f32 router on the gathered features (forward and remat, dx, dw, each
    # of its 2 layers)
    zoo_rows = [
        ("zoo.mamba.head_1d", _ZM, 768, 50432 // ZOO_P, "none", 1,
         "bfloat16"),
        ("zoo.phi.head_1d", MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 4096,
         32256 // ZOO_P, "none", 1, "bfloat16"),
        ("zoo.whisper.head_1d", _ZD, 768, 51968 // ZOO_P, "none", 1,
         "bfloat16"),
        ("zoo.phi.router", MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 4096, 16,
         "none", 2 * MOE_TRAIN_LAYERS, "float32")]
    zoo_fwd, w5 = lm_gemm_rows(torch, BM, SM90, ref, gen, zoo_rows)
    zoo_bwd, w6 = lm_bwd_rows(torch, BM, SM90, ref, gen, [
        r[:5] + (r[5] // 2 if "router" in r[0] else r[5], r[6])
        for r in zoo_rows])
    torch.cuda.empty_cache()
    zoo_stats = lm_1d_zoo_phase(torch, zoo)
    zoo_stats["block_matmul_rows"] = zoo_fwd + zoo_bwd
    return (lm, audio, moe, lm1d, zoo_stats), rows, max(w1, w2, w3, w4, w5,
                                                         w6)


def audio_phases(torch, BM, SM90, ref):
    """The two whisper serving phases on one set of weights."""
    from repro_torch.kernels.graphs import counted_kernels
    kernels = counted_kernels()
    torch.cuda.empty_cache()
    cfg, jcfg, params, cfg32, params32 = dense_setup(torch, AUDIO_ARCH)
    fwd, fwd_rows, w1 = audio_forward_phase(torch, kernels, BM, SM90, ref,
                                            cfg, jcfg, params, cfg32,
                                            params32)
    gen, gen_rows, w2 = audio_generate_phase(torch, kernels, BM, SM90, ref,
                                             cfg, jcfg, params, cfg32,
                                             params32)
    del params, params32
    torch.cuda.empty_cache()
    return (fwd, gen), (fwd_rows, gen_rows), max(w1, w2)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a "
              "GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import cannon as CANNON
    from repro_torch.kernels import ref
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ring as RING
    from repro_torch.kernels import sm90 as SM90
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import ssd_chunk_bwd as SSDB
    from repro_torch.kernels import wx as WX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False)
    t0 = time.perf_counter()
    libs = (BM, WX, RING, CANNON, SSD, SSDB)
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source,
        built = list(pool.map(lambda lib: lib.build(), libs))   # together
    emit(phase="build", built=built, seconds=time.perf_counter() - t0,
         nvcc_seconds=[lib.build_info.get("seconds") for lib in libs],
         libraries=[lib.build_info["library"] for lib in libs])

    rows, mamba_rows, worst = kernel_phase(torch, BM, SM90, ref)
    ssd_rows, ssd_worst = ssd_phase(torch, SSD, ref)
    ssd_bwd_rows, ssd_bwd_worst = ssd_bwd_phase(torch, SSDB, ref)
    counted = (BM.block_matmul, SSD.ssd_intra_chunk,
               SSDB.ssd_intra_heads_bwd, WX.wx, RING.ring_fwd, RING.ring_bwd,
               CANNON.cannon_step)
    mcfg, mjcfg, mparams = mamba_setup(torch)
    fwd_launches, fwd_ssd_routes, fwd_ssd_ms = mamba_forward_phase(
        torch, counted, OPS, ref, mcfg, mjcfg, mparams)
    gen_launches, gen_graphed, gen_eager = mamba_generate_phase(
        torch, counted, mcfg, mjcfg, mparams)
    del mparams
    torch.cuda.empty_cache()
    import shutil
    import tempfile
    # the one-device training phases' step 0 for lm_1d_zoo
    zoo = Path(tempfile.mkdtemp(prefix="chip_smoke_zoo_"))
    handoff = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        mtrain, htrain = ssm_train_phases(torch, BM, SSD, SSDB, ref, zoo)
        ssm = (ssd_bwd_rows, ssd_bwd_worst, mtrain, htrain, zoo)
        eng, fields, serve_launches = serve_phase(torch, BM, handoff)
        legacy = legacy_phase(torch, BM, eng, fields)
        del eng, fields
        torch.cuda.empty_cache()
        return after_serve(torch, BM, WX, RING, CANNON, SSD, SM90, ref, card,
                           handoff, rows, mamba_rows, worst, ssd_rows,
                           ssd_worst, fwd_launches, fwd_ssd_routes,
                           fwd_ssd_ms, gen_launches, gen_graphed, gen_eager,
                           serve_launches, legacy, ssm)
    finally:
        shutil.rmtree(handoff, ignore_errors=True)
        shutil.rmtree(zoo, ignore_errors=True)


def after_serve(torch, BM, WX, RING, CANNON, SSD, SM90, ref, card, handoff,
                rows, mamba_rows, worst, ssd_rows, ssd_worst, fwd_launches,
                fwd_ssd_routes, fwd_ssd_ms, gen_launches, gen_graphed,
                gen_eager, serve_launches, legacy, ssm):
    """The phases after serving (``serve_data`` reads ``handoff``), and
    the ``kernels`` line (``ssm``: the ssd_bwd rows and worst error, the
    ``mamba_train`` and ``hybrid_train`` stats, and the directory of the
    step-0 handoffs for ``lm_1d_zoo``)."""
    ssd_bwd_rows, ssd_bwd_worst, mt, ht, zoo = ssm
    bwd_rows, bwd_worst = kernel_bwd_phase(torch, BM, SM90, ref)
    wx_rows, wx_worst = wx_phase(torch, WX, SM90, ref)
    ring_rows, ring_worst = ring_phase(torch, BM, RING, WX, ref)
    cannon_rows, cannon_worst = cannon_phase(torch, CANNON, WX, RING, ref)
    train_launches, train, t2, t1, t2m, td, ck, pre, sd = train_phase(
        torch, BM, WX, card, handoff)
    (dfwd, dgen, gem), (dfwd_rows, dgen_rows, gem_rows), lm_worst = \
        transformer_phases(torch, BM, SM90, ref)
    (mfwd, mgen, hfwd, hgen), (mfwd_rows, mgen_rows, hfwd_rows,
                               hgen_rows), mh_worst = \
        moe_hybrid_phases(torch, BM, SM90, ref)
    (afwd, agen), (afwd_rows, agen_rows), au_worst = audio_phases(
        torch, BM, SM90, ref)
    (lmt, aut, mot, l1d, zoo1d), lmt_rows, lt_worst = lm_train_phases(
        torch, BM, SM90, ref, zoo)
    torch.cuda.empty_cache()
    serve1d = lm_1d_serve_phase(torch, BM, SM90, ref)
    mesh_launches = {k: [x[k] for x in t2m["launches"]]
                     for k in t2m["launches"][0]}
    # the data phases' launches per rank (each run's first step)
    data_launches = {kind: {k: [sum(r[k] for r in x) for x in
                                td[kind]["launches_per_rank"]]
                            for k in ("wx", "block_matmul", "ring_fwd",
                                      "ring_bwd")}
                     for kind in td}

    step = [r for r in rows if r["per_step"]]

    # a row's key, or (wmma_ms of a row that runs the WMMA loop anyway) its
    # kernel time
    def get(r, key):
        return r.get(key, r["kernel_ms"])

    def per_step(key):
        return sum(get(r, key) * r["per_step"] for r in step)

    def per_train_step(key):
        return sum(get(r, key) * r["per_train_step"] for r in rows + bwd_rows)

    def per_wx_step(key):
        # the q = 1 rows at batch 1 (dx at one term, as the path runs it):
        # this card's path, per sample-step
        return sum(r.get(key, 0.0) * r["per_train_step"] for r in wx_rows
                   if r["batch"] == 1 and r["shape"].startswith("q1."))

    def ring_path(r):
        return ("lm_1d" if r["shape"].startswith("h2o.") else "lm_1d_zoo"
                if r["shape"].startswith(ZOO_RING_PREFIXES) else
                "lm_1d_serve" if r["shape"].startswith("serve.")
                else "train_1d")

    def per_decode_step(model, key):
        # one rank's ring_fwd launches of a decode step of lm_1d_serve's
        # ``model`` (h2o-danube-1.8b whole or mamba2-130m) at batch 4
        return sum(r[f"fwd_{key}"] * r["calls_per_decode_step"]
                   for r in ring_rows
                   if r["shape"].startswith(f"serve.{model}."))

    def per_ring_step(kind, key, path="train_1d"):
        # the p = 2 bf16 rows (batch 1): one rank of the 1-D step, per
        # training sample-step at r = 1; of path "lm_1d" h2o's rows, one
        # rank of lm_1d's training step; of "lm_1d_zoo" the three
        # full-width models' rows, one rank of each model's step, summed
        return sum(r[f"{kind}_{key}"] * r[f"{kind}_calls_per_train_step"]
                   for r in ring_rows
                   if r["p"] == TRAIN_1D_P and r["dtype"] == "bfloat16"
                   and ring_path(r) == path)

    def per_zoo(rows_, key):
        # lm_1d_zoo's launches at one rank's layouts: mamba2-130m's
        # (``mamba_rank_layout``, launches per step ``n``) and reduced
        # jamba's
        out = 0.0
        for r in rows_:
            for tag, arch in (("mamba_rank", "mamba2-130m"),
                              ("jamba_rank", "jamba-1.5-large-398b")):
                if r["shape"].startswith(tag):
                    n = zoo1d["models"][arch]["launches_per_step"].get(
                        "ssd_intra_heads_bwd" if rows_ is ssd_bwd_rows
                        else "ssd_intra_chunk", 0)
                    out += r[key] * n
        return out

    def per_cannon_step(key):
        # the bf16 rows at batch 1: one rank of the 2x2 step, per training
        # sample-step at r = 1
        return sum(r[key] * r["calls_per_train_step"] for r in cannon_rows
                   if r["batch"] == 1 and r["dtype"] == "bfloat16")

    def per_mamba(tag, key):
        # the block_matmul launches of one mamba2-130m forward (tag "fwd",
        # sequence 4096, batch 2) or one decode step (tag "decode", batch 4)
        return per_rows([r for r in mamba_rows
                         if r["shape"].startswith(tag + ".")], key)

    # the ssd launches of one mamba2-130m forward (sequence 4096, batch 2):
    # one per layer at the model's layout (the main path), and the [G, Q, N]
    # entry at the same groups (G = 3072)
    ssd_fwd = next(r for r in ssd_rows if r["shape"].startswith("model_"))
    ssd_grp = next(r for r in ssd_rows if r["shape"] == "seq4096.b2")
    ssd_jamba = next(r for r in ssd_rows
                     if r["shape"].startswith("jamba_layout"))
    n_jamba_ssd = hfwd["launches"]["ssd_intra_chunk"]
    bwd_model = next(r for r in ssd_bwd_rows
                     if r["shape"].startswith("model_layout"))
    bwd_jamba = next(r for r in ssd_bwd_rows
                     if r["shape"].startswith("jamba_layout"))

    def ring_entry(kind, line):
        launches = t1[f"ring_{kind}_launches"]
        data = data_launches["1d"][f"ring_{kind}"]
        lm1d = [x[f"ring_{kind}"] for x in l1d["launches_per_rank"]]
        zoo = [x[f"ring_{kind}"] for x in zoo1d["launches_per_rank"]]
        serve = [x.get(f"ring_{kind}", 0)
                 for x in serve1d["launches_per_rank"]]
        out = {
            "name": f"ring_{kind}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ring.cu",
            "replaces": f"src/repro/kernels/fused_ring.py:{line}",
            "launches": sum(launches) + sum(data) + sum(lm1d) + sum(zoo)
            + sum(serve),
            "launches_by_path": {"train_1d": launches,
                                 "train_data_1d": data, "lm_1d": lm1d,
                                 "lm_1d_zoo": zoo, "lm_1d_serve": serve},
            "max_abs_err": ring_worst[kind],
            # times: one rank's launches of a 1-D training sample-step at
            # p = 2, r = 1 (batch 1): forward 2 + 24 ring calls, backward
            # 2 + 12, each p launches; a hop is an HBM store on one card
            "ms": per_ring_step(kind, "kernel_ms"),
            "plain_ms": per_ring_step(kind, "plain_ms"),
            "bound_ms": per_ring_step(kind, "bound_ms"),
            "bound_by": ("operations" if all(
                r[f"{kind}_bound_by"] == "operations" for r in ring_rows
                if f"{kind}_bound_by" in r) else "bytes"),
            # torch.matmul chunk products plus the adds
            "library_ms": per_ring_step(kind, "library_ms"),
            # one rank's launches of an h2o-danube-1.8b training step on
            # lm_1d's two ranks (batch 2 x 1,024): 7 ring calls a layer,
            # the forward and the remat recompute, one backward
            "lm_1d_ms": per_ring_step(kind, "kernel_ms", "lm_1d"),
            "lm_1d_plain_ms": per_ring_step(kind, "plain_ms", "lm_1d"),
            "lm_1d_bound_ms": per_ring_step(kind, "bound_ms", "lm_1d"),
            "lm_1d_library_ms": per_ring_step(kind, "library_ms", "lm_1d"),
            # one rank's launches of one lm_1d_zoo training step of each of
            # mamba2-130m, phi3.5 (2 layers) and whisper, summed (jamba's
            # reduced f32 linears are not timed)
            "lm_1d_zoo_ms": per_ring_step(kind, "kernel_ms", "lm_1d_zoo"),
            "lm_1d_zoo_plain_ms": per_ring_step(kind, "plain_ms",
                                                "lm_1d_zoo"),
            "lm_1d_zoo_bound_ms": per_ring_step(kind, "bound_ms",
                                                "lm_1d_zoo"),
            "lm_1d_zoo_library_ms": per_ring_step(kind, "library_ms",
                                                  "lm_1d_zoo"),
        }
        if kind == "fwd":
            # one rank's launches of a decode step at batch 4 on
            # lm_1d_serve's two ranks (M = 4 rows): h2o-danube-1.8b whole
            # (168 ring calls) and mamba2-130m (96), each p launches
            for model in ("h2o", "mamba"):
                for key in ("kernel_ms", "plain_ms", "bound_ms",
                            "library_ms"):
                    out[f"lm_1d_serve_{model}_decode_"
                        f"{key.replace('kernel_', '')}"] = \
                        per_decode_step(model, key)
        return out

    emit(kernels=[{
        "name": "block_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul.py:37",
        "launches": sum(serve_launches.values())
        + sum(sd["launches_per_rank"]) + train_launches
        + t2["block_matmul_launches"] + sum(mesh_launches["block_matmul"])
        + sum(data_launches["2d"]["block_matmul"])
        + fwd_launches["block_matmul"] + gen_launches["block_matmul"]
        + ck["resumed_block_matmul_launches"]
        + sum(pre["block_matmul_launches"])
        + dfwd["launches"]["block_matmul"]
        + sum(x[k]["block_matmul"] for x in (dgen, gem)
              for k in ("launches", "launches_eager"))
        + mfwd["launches"]["block_matmul"] + hfwd["launches"]["block_matmul"]
        + sum(x[k]["block_matmul"] for x in (mgen, hgen, agen)
              for k in ("launches", "launches_eager"))
        + afwd["launches"]["block_matmul"]
        + sum(x["launches"]["block_matmul"] for x in (lmt, aut, mot, mt,
                                                      ht))
        + sum(x["block_matmul"] for x in l1d["launches_per_rank"])
        + sum(x["block_matmul"] for x in zoo1d["launches_per_rank"])
        + sum(x["block_matmul"] for x in serve1d["launches_per_rank"]),
        "launches_by_path": {"serve": serve_launches["graphed"],
                             "serve_eager": serve_launches["eager"],
                             "serve_data": sd["launches_per_rank"],
                             "train": train_launches,
                             "ckpt_resume":
                             ck["resumed_block_matmul_launches"],
                             "preempt": pre["block_matmul_launches"],
                             "train_2d": t2["block_matmul_launches"],
                             "train_2d_mesh": mesh_launches["block_matmul"],
                             "train_data_2d":
                             data_launches["2d"]["block_matmul"],
                             "mamba_forward": fwd_launches["block_matmul"],
                             "mamba_generate": gen_graphed["block_matmul"],
                             "mamba_generate_eager":
                             gen_eager["block_matmul"],
                             "dense_forward":
                             dfwd["launches"]["block_matmul"],
                             "dense_generate":
                             dgen["launches"]["block_matmul"],
                             "dense_generate_eager":
                             dgen["launches_eager"]["block_matmul"],
                             "gemma3_generate":
                             gem["launches"]["block_matmul"],
                             "gemma3_generate_eager":
                             gem["launches_eager"]["block_matmul"],
                             "moe_forward": mfwd["launches"]["block_matmul"],
                             "moe_generate":
                             mgen["launches"]["block_matmul"],
                             "moe_generate_eager":
                             mgen["launches_eager"]["block_matmul"],
                             "hybrid_forward":
                             hfwd["launches"]["block_matmul"],
                             "hybrid_generate":
                             hgen["launches"]["block_matmul"],
                             "hybrid_generate_eager":
                             hgen["launches_eager"]["block_matmul"],
                             "audio_forward":
                             afwd["launches"]["block_matmul"],
                             "audio_generate":
                             agen["launches"]["block_matmul"],
                             "audio_generate_eager":
                             agen["launches_eager"]["block_matmul"],
                             "lm_train": lmt["launches"]["block_matmul"],
                             "audio_train": aut["launches"]["block_matmul"],
                             "moe_train": mot["launches"]["block_matmul"],
                             "mamba_train": mt["launches"]["block_matmul"],
                             "hybrid_train":
                             ht["launches"]["block_matmul"],
                             "lm_1d_zoo": [x["block_matmul"] for x in
                                           zoo1d["launches_per_rank"]],
                             "lm_1d": [x["block_matmul"] for x in
                                       l1d["launches_per_rank"]],
                             "lm_1d_serve": [x["block_matmul"] for x in
                                             serve1d["launches_per_rank"]]},
        "lm_train_launches_by_layout": {
            x["arch"]: x["launches_by_layout"] for x in (lmt, aut, mot, mt)},
        "lm_train_launches_by_route": {
            x["arch"]: x["launches_by_route"] for x in (lmt, aut, mot, mt)},
        "train_launches_by_layout": train["launches_by_layout"],
        "train_launches_by_route": train["launches_by_route"],
        "max_abs_err": max(worst, bwd_worst, lm_worst, mh_worst, au_worst,
                           lt_worst, serve1d["block_matmul_worst"]),
        # times: the 14 GEMMs of one bf16 forecast step at bucket 1 (the
        # kernel's with its per-call padding, of which pad_ms; wmma_ms the
        # WMMA loop's on the same operands, bit for bit the same result)
        "ms": per_step("kernel_ms"),
        "pad_ms": per_step("pad_ms"),
        "wmma_ms": per_step("wmma_ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in step) else "bytes"),
        "library_ms": per_step("library_ms"),
        # the legacy path (f32 activations, 14 f32 launches a step): the
        # step, its 14 launches alone, the same products by torch.matmul
        # in f32, and their f32 bound
        "legacy_step_ms": legacy["step_ms"],
        "legacy_ms": legacy["gemm_ms"],
        "legacy_library_ms": legacy["library_ms"],
        "legacy_bound_ms": legacy["bound_ms"],
        # the 59 GEMMs of one training sample-step at rollout 1 (batch 1):
        # forward, remat and GELU recomputes, dx and dw
        "train_ms": per_train_step("kernel_ms"),
        "train_pad_ms": per_train_step("pad_ms"),
        "train_wmma_ms": per_train_step("wmma_ms"),
        "train_plain_ms": per_train_step("plain_ms"),
        "train_bound_ms": per_train_step("bound_ms"),
        "train_library_ms": per_train_step("library_ms"),
        # the 97 GEMMs of one mamba2-130m forward (sequence 4096, batch 2)
        # and of one of its decode steps (batch 4)
        "mamba_forward_ms": per_mamba("fwd", "kernel_ms"),
        "mamba_forward_wmma_ms": per_mamba("fwd", "wmma_ms"),
        "mamba_forward_plain_ms": per_mamba("fwd", "plain_ms"),
        "mamba_forward_bound_ms": per_mamba("fwd", "bound_ms"),
        "mamba_forward_library_ms": per_mamba("fwd", "library_ms"),
        "mamba_decode_step_ms": per_mamba("decode", "kernel_ms"),
        "mamba_decode_step_plain_ms": per_mamba("decode", "plain_ms"),
        "mamba_decode_step_bound_ms": per_mamba("decode", "bound_ms"),
        "mamba_decode_step_library_ms": per_mamba("decode", "library_ms"),
        # the 169 GEMMs of one h2o-danube-1.8b forward (sequence 4608, batch
        # 2) and of one of its decode steps (batch 4), the 49 of one
        # gemma3-27b (8 layers) decode step (batch 2); plain: ref.py in
        # f32; library: F.linear (with the tanh GELU for gemma3's fc1)
        "dense_forward_ms": per_rows(dfwd_rows, "kernel_ms"),
        "dense_forward_wmma_ms": per_rows(dfwd_rows, "wmma_ms"),
        "dense_forward_plain_ms": per_rows(dfwd_rows, "plain_ms"),
        "dense_forward_bound_ms": per_rows(dfwd_rows, "bound_ms"),
        "dense_forward_library_ms": per_rows(dfwd_rows, "library_ms"),
        "dense_decode_step_ms": per_rows(dgen_rows, "kernel_ms"),
        "dense_decode_step_plain_ms": per_rows(dgen_rows, "plain_ms"),
        "dense_decode_step_bound_ms": per_rows(dgen_rows, "bound_ms"),
        "dense_decode_step_library_ms": per_rows(dgen_rows, "library_ms"),
        "gemma3_decode_step_ms": per_rows(gem_rows, "kernel_ms"),
        "gemma3_decode_step_plain_ms": per_rows(gem_rows, "plain_ms"),
        "gemma3_decode_step_bound_ms": per_rows(gem_rows, "bound_ms"),
        "gemma3_decode_step_library_ms": per_rows(gem_rows, "library_ms"),
        # the 21 GEMMs of one phi3.5-moe (4 layers) forward (sequence 4096,
        # batch 2; the 4 routers in f32) and of one of its decode steps
        # (batch 4); the 49 of one jamba (one period, 8 experts) forward
        # (sequence 2048, batch 1) and decode step (batch 2)
        "moe_forward_ms": per_rows(mfwd_rows, "kernel_ms"),
        "moe_forward_plain_ms": per_rows(mfwd_rows, "plain_ms"),
        "moe_forward_bound_ms": per_rows(mfwd_rows, "bound_ms"),
        "moe_forward_library_ms": per_rows(mfwd_rows, "library_ms"),
        "moe_decode_step_ms": per_rows(mgen_rows, "kernel_ms"),
        "moe_decode_step_plain_ms": per_rows(mgen_rows, "plain_ms"),
        "moe_decode_step_bound_ms": per_rows(mgen_rows, "bound_ms"),
        "moe_decode_step_library_ms": per_rows(mgen_rows, "library_ms"),
        "hybrid_forward_ms": per_rows(hfwd_rows, "kernel_ms"),
        "hybrid_forward_plain_ms": per_rows(hfwd_rows, "plain_ms"),
        "hybrid_forward_bound_ms": per_rows(hfwd_rows, "bound_ms"),
        "hybrid_forward_library_ms": per_rows(hfwd_rows, "library_ms"),
        "hybrid_decode_step_ms": per_rows(hgen_rows, "kernel_ms"),
        "hybrid_decode_step_plain_ms": per_rows(hgen_rows, "plain_ms"),
        "hybrid_decode_step_bound_ms": per_rows(hgen_rows, "bound_ms"),
        "hybrid_decode_step_library_ms": per_rows(hgen_rows, "library_ms"),
        # the 193 GEMMs of one whisper-small forward (batch 4, 1,500
        # frames, 448 tokens) and the 121 of one of its decode steps
        # (batch 4: the cross k and v of every layer projected anew from
        # the 6,000 encoder rows); the 675 of one h2o-danube-1.8b training
        # step (batch 2 x 1,024, remat: forward and recompute, dx, dw;
        # plain: ref.py in f32; library: F.linear, torch.matmul)
        "audio_forward_ms": per_rows(afwd_rows, "kernel_ms"),
        "audio_forward_plain_ms": per_rows(afwd_rows, "plain_ms"),
        "audio_forward_bound_ms": per_rows(afwd_rows, "bound_ms"),
        "audio_forward_library_ms": per_rows(afwd_rows, "library_ms"),
        "audio_decode_step_ms": per_rows(agen_rows, "kernel_ms"),
        "audio_decode_step_plain_ms": per_rows(agen_rows, "plain_ms"),
        "audio_decode_step_bound_ms": per_rows(agen_rows, "bound_ms"),
        "audio_decode_step_library_ms": per_rows(agen_rows, "library_ms"),
        "lm_train_step_ms": per_rows(lmt_rows, "kernel_ms"),
        "lm_train_step_plain_ms": per_rows(lmt_rows, "plain_ms"),
        "lm_train_step_bound_ms": per_rows(lmt_rows, "bound_ms"),
        "lm_train_step_library_ms": per_rows(lmt_rows, "library_ms"),
        # the 3 of one rank's lm_1d step (h2o's vocab-parallel head at M
        # 2,048, K 2,560, N 16,000: forward, dx, dw)
        "lm_1d_ms": l1d["head_block_matmul_ms"],
        "lm_1d_plain_ms": l1d["head_block_matmul_plain_ms"],
        "lm_1d_bound_ms": l1d["head_block_matmul_bound_ms"],
        "lm_1d_library_ms": l1d["head_block_matmul_library_ms"],
        "shapes": rows,
        "shapes_bwd": bwd_rows,
        "shapes_mamba": mamba_rows,
        "shapes_dense": dfwd_rows + dgen_rows + gem_rows,
        "shapes_moe_hybrid": mfwd_rows + mgen_rows + hfwd_rows + hgen_rows,
        "shapes_audio": afwd_rows + agen_rows,
        "shapes_lm_train": lmt_rows,
        # one rank's of one lm_1d_zoo step of each of mamba2-130m, phi3.5
        # (2 layers) and whisper, summed: the vocab-parallel heads'
        # forward, dx and dw, and phi3.5's f32 router (forward and remat,
        # dx, dw, each layer); jamba's reduced f32 GEMMs are not timed
        "lm_1d_zoo_ms": per_rows(zoo1d["block_matmul_rows"], "kernel_ms"),
        "lm_1d_zoo_plain_ms": per_rows(zoo1d["block_matmul_rows"],
                                       "plain_ms"),
        "lm_1d_zoo_bound_ms": per_rows(zoo1d["block_matmul_rows"],
                                       "bound_ms"),
        "lm_1d_zoo_library_ms": per_rows(zoo1d["block_matmul_rows"],
                                         "library_ms"),
        # one decode step of each full-width lm_1d_serve model at one
        # rank's shapes (batch 4), summed: the vocab-parallel heads and
        # phi3.5's two f32 routers
        "lm_1d_serve_ms": per_rows(serve1d["block_matmul_rows"],
                                   "kernel_ms"),
        "lm_1d_serve_plain_ms": per_rows(serve1d["block_matmul_rows"],
                                         "plain_ms"),
        "lm_1d_serve_bound_ms": per_rows(serve1d["block_matmul_rows"],
                                         "bound_ms"),
        "lm_1d_serve_library_ms": per_rows(serve1d["block_matmul_rows"],
                                           "library_ms"),
        "shapes_lm_1d": l1d["head_rows"],
        "shapes_lm_1d_zoo": zoo1d["block_matmul_rows"],
        "shapes_lm_1d_serve": serve1d["block_matmul_rows"],
    }, {
        "name": "wx",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wx.cu",
        "replaces": "src/repro/kernels/fused_ring.py:521",
        "launches": t2["wx_launches"] + sum(mesh_launches["wx_fwd"])
        + sum(mesh_launches["wx_dx"]) + sum(data_launches["2d"]["wx"]),
        "launches_by_path": {
            "train_2d": t2["wx_launches"],
            "train_2d_mesh": [a + b for a, b in zip(mesh_launches["wx_fwd"],
                                                    mesh_launches["wx_dx"])],
            "train_data_2d": data_launches["2d"]["wx"]},
        "max_abs_err": wx_worst,
        "dx_terms_by_path": {"train_2d": t2["wx_dx_terms"],
                             "train_2d_mesh": t2m["wx_dx_terms"]},
        # times: the 18 wx launches of one 2-D training sample-step at q = 1
        # and r = 1 (batch 1): the 12 forward-layout launches (forward and
        # the checkpoint's rerun) and the 6 dx launches (one split term,
        # as the path runs them), each with its per-call padding of w (of
        # which pad_ms) and, dx, its split pass (split_ms); fma_dx_ms the
        # f32 FMA kernel that took dx before, on the same operands
        "ms": per_wx_step("kernel_ms"),
        "pad_ms": per_wx_step("pad_ms"),
        "split_ms": per_wx_step("split_ms"),
        "fma_dx_ms": per_wx_step("fma_ms"),
        "plain_ms": per_wx_step("plain_ms"),
        "bound_ms": per_wx_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in wx_rows) else "bytes"),
        # torch.matmul (+ the f32 add of the accumulator, forward rows;
        # f32 for dx)
        "library_ms": per_wx_step("library_ms"),
        "shapes": wx_rows,
    }, dict(ring_entry("fwd", 214), shapes=ring_rows),
        ring_entry("bwd", 314), {
        "name": "cannon",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cannon.cu",
        "replaces": "src/repro/kernels/fused_ring.py:650",
        "launches": sum(mesh_launches["cannon"]),
        "launches_by_path": {"train_2d_mesh": mesh_launches["cannon"]},
        "max_abs_err": cannon_worst,
        # times: one rank's 24 Cannon launches of a 2-D training
        # sample-step on the 2x2 mesh at r = 1 (batch 1): 12 loops of q = 2
        # steps, 6 of each token-mix linear (forward and the checkpoint's
        # rerun); a hop is an HBM store on one card
        "ms": per_cannon_step("kernel_ms"),
        "plain_ms": per_cannon_step("plain_ms"),
        "bound_ms": per_cannon_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in cannon_rows) else "bytes"),
        # torch.baddbmm per step (no hops)
        "library_ms": per_cannon_step("library_ms"),
        "shapes": cannon_rows,
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk.py:25",
        "launches": fwd_launches["ssd_intra_chunk"]
        + gen_launches["ssd_intra_chunk"]
        + hfwd["launches"]["ssd_intra_chunk"]
        + sum(hgen[k]["ssd_intra_chunk"]
              for k in ("launches", "launches_eager"))
        + mt["launches"]["ssd_intra_chunk"]
        + ht["launches"]["ssd_intra_chunk"]
        + sum(x["ssd_intra_chunk"] for x in zoo1d["launches_per_rank"]),
        "launches_by_path": {
            "lm_1d_zoo": [x["ssd_intra_chunk"] for x in
                          zoo1d["launches_per_rank"]],
            "mamba_forward": fwd_launches["ssd_intra_chunk"],
            "mamba_generate": gen_launches["ssd_intra_chunk"],
            "mamba_train": mt["launches"]["ssd_intra_chunk"],
            "hybrid_train": ht["launches"]["ssd_intra_chunk"],
            "hybrid_forward": hfwd["launches"]["ssd_intra_chunk"],
            "hybrid_generate": hgen["launches"]["ssd_intra_chunk"],
            "hybrid_generate_eager":
            hgen["launches_eager"]["ssd_intra_chunk"]},
        "max_abs_err": ssd_worst,
        "launches_by_route": {"mamba_forward": fwd_ssd_routes,
                              "hybrid_forward": hfwd["ssd_routes"]},
        # one rank's launches of one lm_1d_zoo training step of
        # mamba2-130m (48 at 12 heads of one group) and of reduced jamba (2
        # at 4 heads of 4 groups), at their per-rank layouts
        "lm_1d_zoo_ms": per_zoo(ssd_rows, "kernel_ms"),
        "lm_1d_zoo_plain_ms": per_zoo(ssd_rows, "plain_ms"),
        "lm_1d_zoo_bound_ms": per_zoo(ssd_rows, "bound_ms"),
        "lm_1d_zoo_library_ms": per_zoo(ssd_rows, "library_ms"),
        # times: the 24 launches of one mamba2-130m forward (sequence 4096,
        # batch 2) at the model's layout, the main path's entry (plain: the
        # groups arrangement and ref.ssd_intra_ref; library: the same
        # copies, torch.bmm, torch.where, * dt, torch.bmm, TF32 off;
        # arrangement: the copies and the [G, Q, N] launch that took the
        # term before); in_forward: the 24 launches timed inside a forward
        "ms": MAMBA_LAYERS * ssd_fwd["kernel_ms"],
        "plain_ms": MAMBA_LAYERS * ssd_fwd["plain_ms"],
        "bound_ms": MAMBA_LAYERS * ssd_fwd["bound_ms"],
        "bound_by": ssd_fwd["bound_by"],
        "library_ms": MAMBA_LAYERS * ssd_fwd["library_ms"],
        "arrangement_ms": MAMBA_LAYERS * ssd_fwd["arrangement_ms"],
        "in_forward_ms": fwd_ssd_ms,
        # the [G, Q, N] entry at the same groups (G = 3072 a launch)
        "groups_ms": MAMBA_LAYERS * ssd_grp["kernel_ms"],
        "groups_plain_ms": MAMBA_LAYERS * ssd_grp["plain_ms"],
        "groups_bound_ms": MAMBA_LAYERS * ssd_grp["bound_ms"],
        "groups_library_ms": MAMBA_LAYERS * ssd_grp["library_ms"],
        # the 7 launches of one jamba forward (one period, sequence 2048,
        # batch 1) at its SSM slots' layout (H 256, G 8, N 128, P 64)
        "hybrid_forward_ms": n_jamba_ssd * ssd_jamba["kernel_ms"],
        "hybrid_forward_plain_ms": n_jamba_ssd * ssd_jamba["plain_ms"],
        "hybrid_forward_bound_ms": n_jamba_ssd * ssd_jamba["bound_ms"],
        "hybrid_forward_library_ms": n_jamba_ssd * ssd_jamba["library_ms"],
        "shapes": ssd_rows,
    }, {
        "name": "ssd_chunk_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        # the VJP of that kernel's function: the reference has no TPU
        # kernel for it and differentiates its plain term
        # (src/repro/models/layers.py:483) by autodiff
        "replaces": "src/repro/kernels/ssd_chunk.py:25",
        "launches": mt["launches"]["ssd_intra_heads_bwd"]
        + ht["launches"]["ssd_intra_heads_bwd"]
        + sum(x["ssd_intra_heads_bwd"] for x in zoo1d["launches_per_rank"]),
        "launches_by_path": {
            "mamba_train": mt["launches"]["ssd_intra_heads_bwd"],
            "hybrid_train": ht["launches"]["ssd_intra_heads_bwd"],
            "lm_1d_zoo": [x["ssd_intra_heads_bwd"] for x in
                          zoo1d["launches_per_rank"]]},
        # one rank's launches of one lm_1d_zoo training step (mamba2-130m
        # 24, jamba reduced 1) at their per-rank layouts
        "lm_1d_zoo_ms": per_zoo(ssd_bwd_rows, "kernel_ms"),
        "lm_1d_zoo_plain_ms": per_zoo(ssd_bwd_rows, "plain_ms"),
        "lm_1d_zoo_bound_ms": per_zoo(ssd_bwd_rows, "bound_ms"),
        "lm_1d_zoo_library_ms": per_zoo(ssd_bwd_rows, "library_ms"),
        "max_abs_err": ssd_bwd_worst,
        # times: the 24 launches of one mamba2-130m training step (batch 2
        # x 4,096, one a layer) at the model's layout (plain:
        # ref.ssd_intra_heads_bwd_ref; library: autograd's backward of the
        # groups copies, bmm, where, * dt, bmm, TF32 off); in_step_ms: the
        # 24 launches timed inside a training step
        "ms": MAMBA_LAYERS * bwd_model["kernel_ms"],
        "plain_ms": MAMBA_LAYERS * bwd_model["plain_ms"],
        "bound_ms": MAMBA_LAYERS * bwd_model["bound_ms"],
        "bound_by": bwd_model["bound_by"],
        "library_ms": MAMBA_LAYERS * bwd_model["library_ms"],
        "in_step_ms": mt["breakdown"]["parts_ms"].get("ssd_backward"),
        # one launch at jamba's full-width SSM slot (sequence 2048, batch
        # 1, 256 heads in 8 groups)
        "jamba_layout_ms": bwd_jamba["kernel_ms"],
        "jamba_layout_plain_ms": bwd_jamba["plain_ms"],
        "jamba_layout_bound_ms": bwd_jamba["bound_ms"],
        "jamba_layout_library_ms": bwd_jamba["library_ms"],
        "shapes": ssd_bwd_rows,
    }])
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--train-1d-rank"]:
            sys.exit(train_1d_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--lm-1d-rank"]:
            sys.exit(lm_1d_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--lm-1d-zoo-rank"]:
            sys.exit(lm_1d_zoo_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--lm-1d-serve-rank"]:
            sys.exit(lm_1d_serve_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--train-2d-rank"]:
            sys.exit(train_2d_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--train-data-rank"]:
            sys.exit(train_data_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--serve-data-rank"]:
            sys.exit(serve_data_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--preempt-child"]:
            sys.exit(preempt_child(sys.argv[2], sys.argv[3:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

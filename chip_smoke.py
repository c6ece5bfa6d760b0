#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel), print ``ptxas``'s registers and spill
   stores of each tensor-core kernel (the attention kernels' mma instances,
   K1q's among them, and K2's wgmma and stream instances), of every
   attention instance at head dim 256 (the f32 FMA ones too), of K6's vector
   kernels, of K7's FFT kernels, of K4's fused Strassen kernels and of K5's
   scan kernels (any spill in these fails the run; K2's kernels carry its
   batched products too) and of K2's other kernels, and the tensor-core
   instructions (HMMA, HGMMA) in each
   library's SASS (``cuobjdump -sass``; the attention libraries must have
   some, each of K1q's tensor-core kernels, one per head dim 16-256, HMMA,
   and K2's HGMMA), and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, within the tolerances printed beside each case.
3. Serve the ``qwen3-1.7b`` smoke config at f32 with one set of parameters
   on the card and on the CPU (plain versions): identical greedy tokens;
   likewise the smoke configs of ``qwen3-moe-30b-a3b``, ``olmoe-1b-7b``,
   ``qwen2.5-14b`` and ``qwen3-32b`` through the ``Engine`` (and
   ``qwen2.5-14b`` through the ``Server``), and ``gemma3-1b``'s (windows
   of 8, prompts past them) through the ``Engine`` with both caches and
   through the ``Server``.
4. Serve ``qwen3-1.7b`` at full width in bf16 from a seeded init: 4
   requests, prompts of 16-64 tokens, 16 new tokens each, a 256-slot cache.
   Every kernel's launch count is set to 0 just before the run and read
   just after; each must be > 0.
5. Time each kernel, its plain version and the PyTorch library call for the
   same function at phase 4's shapes, beside the least time the card could
   take (bytes over 3.35 TB/s or operations over the bf16 peak of
   989 TFLOP/s, whichever is larger; the H100 SXM data sheet).  Each row
   names the instance it ran, as ``flash_attention.fwd_path`` and
   ``hbp_matmul.path`` give it (``mma``: K1's tensor cores by ``mma.sync``;
   K2's ``wgmma`` for more than 16 rows and ``stream`` for at most 16;
   ``fma``: f32 FMA), and K2's rows its plan (tile width / splits).
6. Train ``qwen3-1.7b`` at full width in bf16 from a seeded init through
   ``repro_torch.launch.train.train``: batch 4 x 128 tokens, 3 AdamW steps.
   Prints each step's loss, grad norm and host ms, the peak memory and the
   launches per step; the counts are set to 0 just before and read just
   after, and must equal 3 x the launches one step makes by construction.
7. Time the attention backward (K3) and each backward product of K2 at
   phase 6's shapes as in phase 5 (library: autograd's backward of one
   ``scaled_dot_product_attention`` call, and ``torch.matmul``), and one
   whole training step on the device (captured in a CUDA graph, replayed)
   against its host wall time in phase 6; count the device operations of
   one step in a ``torch.profiler`` trace, ours by kernel name.
8. Serve ``qwen3-1.7b`` at full width in bf16 through the continuous-batching
   ``Engine``: 8 slots, a 512-slot cache, chunk 64, 16 requests (prompts of
   16-192 tokens, 8-48 new tokens, seed 0), once with the bf16 cache and
   once with the int8 cache (``attention=pallas:kv_dtype=int8``).  Every
   request must complete with finite logits and no launch may be flagged
   a straggler or shed a slot, and every decode step must launch K1q
   (``flash_attention_int8``) once per layer and K1 never with the int8
   cache (the reverse with bf16).  Prints decode ms per step, ms
   per prefill chunk, tok/s, the telemetry, and the share of requests whose
   tokens agree between the two caches (not a gate).
9. Time K1q per call as in phase 5 at phase 8's decode shape and mid-run
   lanes, and at a 64-row continuation chunk at those lanes' offsets,
   beside its bound, its plain version, the library's two calls (dequantize
   to bf16, then ``scaled_dot_product_attention``) and K1 at the same shape
   over a bf16 cache (K1q's yardstick) with K1's own library call
   (``scaled_dot_product_attention`` over that cache); each row names K1q's
   instance and cluster split (``flash_attention.fwd_path``, ``kv_splits``).
10. Run the kernel registry (``repro_torch.kernels.registry.dispatch``, the
   default policy) at sizes past the 50 MB L2: the scan (K5, one launch of
   the chained scan) on f32 and bf16 (64, 2^20), the transpose (K6) on f32
   8192^2 (a Morton grid of bt tiles) and bf16 4096x16384 and 6144x10240
   (row-major grids), the FFT (K7, two CUDA passes) on complex64 (256,
   65536) and on one row of 2^25, past the 4096-line pass (pass 1, a nested
   K7 call for pass 2, a K6 readout), and 8192^2 products in f32, which the
   planner sends to Strassen (K4: one fused launch, no K2), and in bf16
   (Strassen over 49 K2 wgmma leaves).  Prints the device parameters the
   planner reads and each plan; the launch counts are set to 0 just before
   the run and read just after and must be those the calls make by
   construction; holds each result against its plain version within the
   tolerances printed, and the scans and the f32 product to the same bits
   on a second call; times each op, its plain version and the library call
   (``torch.cumsum``, ``x.t().contiguous()``, ``torch.fft.fft``,
   ``torch.matmul``) beside its bound and its share of it (each transpose
   and scan with its instance), the two scans against their bound; and
   prints the host microseconds of one ``dispatch`` beside a direct K2
   call.  Phases 4, 6 and 8 must launch none of K4-K7.
11. The MoE path at full width: ``qwen3-moe-30b-a3b`` (48 layers, 128
   experts top-8, untied head, bf16, nothing cut; 61 GB of weights drawn
   once on the card from a CUDA generator, after the earlier phases freed
   theirs) through the ``Engine`` with phase 8's traffic, bf16 and then
   int8 cache, and through the lockstep ``Server.run_batch`` with phase 4's
   traffic.  Every request completes with finite logits, no straggler and
   no shed slot, and every decode step launches the batched K2 144 times
   (3 x 48: one launch per expert product), the 2-D K2 193 times and the
   layer's attention kernel 48 times.  Prints decode ms per step (wall)
   and on the device (CUDA graph replay) beside the weights' floor, and
   the batched K2 timed alone per
   decode step beside its bound, its plain version and ``torch.bmm``.
   Then ``olmoe-1b-7b`` at full width and depth through the ``Engine`` (bf16
   cache, the same gates), and ``qwen2.5-14b`` and ``qwen3-32b`` at full
   width with 2 layers through the ``Server`` (finite logits, their launch
   counts).
12. ``gemma3-1b`` at full width and depth (26 layers, d 1152, 4 query heads
   over 1 KV head at hd 256, windows of 512 on 22 layers, a 262,144-token
   tied vocab; 1.0e9 parameters, 2.0 GB, drawn on the card after phase 11
   freed its memory) through the ``Engine`` with the bf16 and the int8
   cache (8 slots, 2048 positions, chunk 64, 16 requests of 64-1536 prompt
   and 8-48 new tokens: the windows bind), through ``Server.run_batch``
   with phase 4's traffic, and trained for 3 AdamW steps at 2 x 1024
   tokens.  Gates as in phase 11: completion, finite logits, no straggler
   or shed slot, exactly 183 K2 and 26 K1 or K1q launches a decode step;
   finite loss and grad norm, the training launches by construction.
   Times K1 and K1q per decode step (26 calls at the runs' halfway lanes,
   each layer its own cache and window) and K3 per training step beside
   their bounds, plain versions and ``scaled_dot_product_attention`` with
   a boolean mask for the windowed layers (naming the backend it ran), and
   both steps on the device (CUDA graph replay).
13. ``olmoe-1b-7b`` trained at full width (d 2048, 64 experts top-8, hd 128,
   untied 50,304-token head; bf16, seeded weights drawn on the card) at the
   depth that leaves at least 8 GB of the card free at peak (16 bytes of
   training state a parameter: the depth is cut, printed as such): 3 AdamW
   steps at 4 x 128 tokens through ``launch.train.train`` under its
   ``FaultTolerantRunner``, with step 1's first attempt failing by an
   injected error raised after its backward and before its update, and
   retried.  Gates: loss and grad norm finite; the losses those of an
   unfaulted run of the same steps (step 0 the same bits; then within the
   tolerance printed, since the backward of the dispatch's gathers sums by
   atomics); the launches of every attempt by construction (12 batched K2
   a layer: 3 forward, 3 recomputed, 6 backward, ``dA`` and ``dB`` of each
   expert product; 16 2-D K2 a layer and 4 for the head); no 3-D product
   outside K2 (no ``aten::bmm`` or ``aten::baddbmm`` in a ``torch.profiler``
   trace of a step); peak memory.  Prints one step's device time (the
   trace) beside its host wall time, and the batched backward timed alone
   per step (each layer's weights, by CUDA graph replay past the L2)
   beside its bound, its plain version and ``torch.bmm``.
   13b. The checkpoint round trip at full width and 1 layer (8.8 GB of
   parameters and AdamW state on disk, in a temporary directory whose free
   bytes are printed first, too little room failing the phase, removed
   afterwards): 2 steps saving every step, the restored state equal to the
   saved one bit for bit, then a fresh ``train()`` on the same directory
   that resumes at step 2 and takes step 3, whose loss must be the
   uninterrupted run's within phase 13's tolerance.
14. The recurrent-state families at full width and depth, bf16, seeded
   weights drawn on the card after phase 13 freed its memory.
   ``recurrentgemma-2b`` (26 layers: 8 superblocks of two RG-LRU blocks and
   one local-attention block, 2 tail RG-LRU blocks; d 2560, 10 query heads
   over 1 KV head at hd 256, windows of 2048, a 256,000-token tied vocab)
   through the ``Engine`` (8 slots, 4096 positions, chunk 256, 16 requests
   of 64-3072 prompt and 8-48 new tokens: the window binds), through a
   ``Server`` built on the engine's weights for each layout,
   ``Server.run_batch`` with the linear cache and with the ring cache
   (``windowed_decode_cache``: 2048 slots; 4 prompts of 2100-2600 tokens, 32
   new, so every ring wraps), and trained for 3 AdamW steps at 2 x 1024;
   then ``mamba2-370m`` (48 layers, SSD state 128) through the ``Engine``
   with the same slots and requests, chunk 256 (its SSD chunk), and trained
   at 4 x 1024.  Gates: completion, finite logits, no straggler or shed
   slot; exactly 111 K2 and 8 K1 launches a hybrid decode step and 1 K2 a
   mamba one; the Server's launches by construction in both layouts; the
   first decode step's logits of the ring layout against the linear one
   (at f32 within ``RING_F32_ATOL``, in bf16 within twice the bf16 linear
   layout's distance from f32, and the same bf16 greedy token in every
   row); finite loss and grad norm, the training
   launches by construction.  Prints each decode step's host wall and
   device time (CUDA graph replay) and one step's device operations, each
   training step's, the peak memory, K1 per hybrid decode step and K3 per
   hybrid training step beside their bounds, plain versions and
   ``scaled_dot_product_attention``, and the RG-LRU recurrence (plain
   PyTorch) per prefill chunk and per training step beside its bytes
   bound.
15. The cross-attention families, bf16, seeded weights drawn on the card
   after phase 14 freed its memory.  ``seamless-m4t-large-v2`` at full
   width and depth (24 encoder and 24 decoder layers, d 1024, 16/16 heads at
   hd 64, d_ff 8192, an untied 256,206-token head; 2.03e9 values, 4.07 GB)
   through the ``Engine`` (8 slots, 2048 positions: 512 frames a row; chunk
   256; 16 requests of 64-1536 prompt and 8-48 new tokens, each with its own
   seeded ``audio_frames``) and through a ``Server`` built on the engine's
   weights (4 prompts of 64-512 tokens, 16 new, the frames it draws), and
   trained for 3 AdamW steps at 4 x 1024 tokens (256 frames); then
   ``llama-3.2-vision-90b`` at full width and 10 of its 100 layers (two
   superblocks of 4 self and 1 gated cross layer; d 8192, 64/8 heads at hd
   128, d_ff 28672, 1601 image tokens, an untied 128,256-token head; 21.3 GB,
   its 175 GB at full depth do not fit one card), its gates drawn N(0, 1),
   through the same ``Engine`` traffic with its own seeded ``image_embeds``
   a request and the same ``Server`` traffic.  Gates: completion, finite
   logits, no straggler or shed slot; exactly 217 K2 and 48 K1 launches a
   seamless decode step and 67 K2 and 10 K1 a VLM one (the phase's
   docstring derives them); the Servers' launches by construction; no
   ``aten::scaled_dot_product_attention``, ``aten::mm``, ``aten::bmm`` (nor
   ``addmm``, ``baddbmm``, ``matmul``) in a seamless decode step or first
   chunk; finite loss and grad norm and the training launches by
   construction (72 K3 a step; 4 launches of K2's ``wmma`` instance, the
   head's ``dA`` and ``dB`` of each logits chunk); the first decode logits
   of one VLM row move when its image is redrawn and every other row's keep
   their bits.  Prints each decode step's device time (CUDA graph replay)
   and host wall beside its weight floor (the bytes of the weights a step
   reads over 3.35 TB/s), the peak memory, and K1 per decode step's
   cross-attention calls, K3 per seamless training step and the ``wmma``
   head backward per training step beside their bounds, plain versions and
   ``scaled_dot_product_attention`` (no mask) / ``torch.matmul``.
16. The fleet: ``qwen3-1.7b`` at full width and depth, bf16, seeded weights
   drawn on the card, behind the ``Router`` (``repro_torch.launch.router``):
   2 replicas of 4 slots (512 positions, chunk 64, a row snapshot every 4
   tokens) serve phase 8's 16 requests by ``pws``, by ``rws`` (seed 5), with
   a rebalance threshold that drains decoding slots to the other replica,
   and with a replica joined and replica 0 removed mid-run; a second fleet
   runs ``pws`` under ``|decode@6=raise:99``: replica 1 dies and a
   replacement restarts from the 3.44 GB fleet checkpoint (the disk room
   checked first, the checkpoints removed after).  Gates: completion,
   finite logits, K1 and K2 launched and nothing else; 1 death, a restart
   and a migration; a slot migration; 1 join and 1 leave; every
   checkpoint-streamed replica's params and first-chunk logits bit-equal
   to replica 0's; every request that never moved gets a clean single
   engine's (4 slots, replica 0's params) tokens bit for bit.  Moved
   requests' matches are printed.  Prints both fleet clocks, each
   replica's ``busy_s``, the checkpoint's save and each restart's seconds
   and the router's host ms a round.  Then phase 8's engine traffic with
   ``RunOptions(fused_qkv=True)`` beside the unfused run on the same
   weights: exactly 56 fewer K2 launches a decode step (one QKV product a
   layer for three), layer 0's fused QKV product within phase 2's bf16
   tolerance of the three products, and the first decode logits at most
   twice as far from the unfused run's as those are from the f32 model's;
   the token match share and each run's device ms a decode step printed.
17. The measured autotune (``repro_torch.kernels.autotune``) on the card:
   ``autotune.search`` on every distinct K2 product of one ``qwen3-1.7b``
   engine decode step (``stream``) and one 64-token chunk step (``wgmma``),
   phase 8's configuration at full width, recorded off the engine's own
   dispatches, on phase 9's int8 K1q decode call (its cluster split) and
   on phase 10's scan, transpose, FFT and f32 and bf16 Strassen shapes;
   each winner is held against its plain version (phase 2's tolerance for
   K2 and K1q, phase 10's for the registry ops) and one line
   ``{"autotune": [...]}`` lists each key, analytic plan and µs, best plan
   and µs, and candidate count.  Then phase 8's engine traffic under
   ``RunOptions(autotune="replay")`` on that table beside the analytic
   plans (``"off"``), the same weights: every request completes with
   finite logits, ``7 L + 1`` K2 launches a decode step, and the replayed
   first decode logits at most twice as far from the analytic run's as
   those are from the f32 model's (phase 16's rule); each run's decode
   step on the device (CUDA graph replay) and the host µs of one
   ``dispatch`` printed.  ``python3 tools/autotune.py`` runs it alone.
18. The simulator core (``repro_torch.core``): ``algorithms_torch`` on the
   card against torch oracles (prefix sums of 2^24, ``mt_bi`` at 4096^2,
   ``strassen`` at 2048^2, ``fft_six_step`` of 2^20), then one simulator
   run of each HBP program under ``PWS`` at the paper demo's ``p, M, B``
   (host only), its stats printed, at most p-1 steals a priority.
19. Multi-device planning on the one-card mesh (``launch/mesh.py``,
   ``core/planner.py``, ``runtime/elastic.py``, ``launch/trace_analysis.py``,
   ``launch/dryrun.py``): ``qwen3-1.7b`` trained at full width and depth
   (phase 6's 4 x 128, 3 steps, analytic plans) through ``train`` on
   ``make_debug_mesh()`` (a ``(1, 1)`` ``DeviceMesh`` over a world-size-1
   process group), parameters, AdamW state and batches placed by the plan:
   losses bit-equal to the same run without a mesh, phase 6's K1 / K2 / K3
   launches a step, the checkpoint manifest's ``mesh_shape`` ``{"data": 1,
   "model": 1}``; that checkpoint restored by ``elastic_restore`` onto the
   mesh, bit for bit; ``Engine.restart`` on the mesh from a checkpoint of
   phase 8's seeded weights over phase 8's first ``MESH_REQUESTS`` requests,
   tokens equal to phase 8's; ``trace_analysis`` of one training step and
   one engine decode step (FLOPs, bytes, collectives: none, the roofline
   terms at the card's peaks) beside its device time from a
   ``torch.profiler`` trace; and the dry run of ``MESH_DRYRUN_CELLS`` (each
   cell's per-device bytes against the card's 80 GB; host only, run in
   subprocesses while the card works).  ``python3 tools/mesh_plan.py`` runs
   it alone.
20. Sharded execution (``launch/mesh.py``'s ``spawn``,
   ``core/collectives.py``, ``models/common.py``): ``SHARD_RANKS`` ranks
   share the card over gloo on the ``(2, 2)`` mesh, the kernels built once
   here before they start.  K1, K2 and K3 are first held to their plain
   versions at the shard shapes of ``qwen3-1.7b`` on ``(2, 2)`` (8 query
   heads over 4 KV heads; 1024 / 512 / 3072 columns; the tied head's
   75,968 vocabulary rows).  Then (a) the smoke config at f32: the
   ``Server``'s and the ``Engine``'s greedy tokens equal this process's
   one-device tokens of the same seeded model, and two training steps'
   losses are within ``SHARD_F32_RTOL``; (b) ``qwen3-1.7b`` in bf16 at full
   width and depth: the ``Server``'s prefill logits no farther from the
   f32 model's than ``SHARD_F32_DISTANCE`` times the one-device bf16
   server's (their distance from the one-device logits printed beside
   phase 2's bf16 tolerance, not gated), then ``BATCH`` requests of
   ``SHARD_NEW`` new tokens (token agreement printed, not gated), a decode
   step's wall, its collectives by kind, each rank's peak memory and the
   kernels' shard shapes; (c) bf16 training at full width and
   ``SHARD_TRAIN_LAYERS`` layers (depth cut for time), two steps against
   the same depth on one device: losses within ``SHARD_BF16_LOSS_RTOL``,
   grad norms finite, each rank's peak memory beside the one-device run's.
   A rank that fails fails the run.  ``python3 tools/sharded_smoke.py`` runs
   it alone.

The run keeps its tuned tables in a temporary ``REPRO_TUNE_DIR`` of its own,
removed at the end: no phase replays a table an earlier run left, and the
servers and engines of phases 1-16, which replay by default, run the
analytic plans their numbers came from (the table is empty until phase
17).  Phase 3 searches and replays its own table in a directory apart.

Each phase prints its seconds in a summary line before the kernels line.

Phase 2 also holds K1 and K2 at phase 6's shapes (512 token rows: every
forward product, the logits, every ``g Wᵀ``), K3 and K2's transposed-A
products (the backward's ``aᵀ g``) against their plain versions at the
training shapes and at harder ones, K1 and K3 in bf16 at the tensor-core
tiles' edges (hd 64 and 128, sequences of 57, 65 and 129, a window across a
K/V tile, a 64-row chunk and decode against 512 slots with an empty lane),
two K3 calls on the same inputs (bit-identical), a bf16 ``q`` whose head
stride is not a whole number of 16-byte steps (K1 and K3 must raise), and
K1q at phase 8's decode and continuation-chunk shapes (bf16 ``q`` on the
tensor cores, f32 ``q`` on the FMA template; an int8 cache whose head
stride is no whole 16-byte step must raise), the batched K2 at phase 11's
expert products (one launch each) in bf16 and f32, its backward (``dA = g
Bᵀ`` and ``dB = Aᵀ g``, one batched launch each) at ``olmoe-1b-7b``'s three
expert products at capacities 80 (phase 13), 320 and 40 in bf16 and f32
with nonzero data in every slab, and K1 and K1q at the
GQA ratios of the other dense-family configs (32/4, 64/8, 40/8, 16/16
heads), and K1, K1q and K3 at ``gemma3-1b``'s hd 256 in bf16 and f32
(4 over 1 heads, its window and global: decode lanes and a 64-row chunk
over phase 12's 2048-slot cache, the 2 x 1024 training shape, sequences of
57, 65 and 129; K3 twice, bit-identical), and K1 and K3 at
``recurrentgemma-2b``'s 10 over 1 heads at hd 256 in bf16 and f32 (decode
lanes over a 2048-slot ring, wrapped ones at ``q_offset`` past ``sk`` with
``kv_len = C``, and over the 4096-slot linear cache with its window; the
2 x 1024 training shape, window 2048), and K2 at phase 14's shapes in bf16
and f32 (``recurrentgemma-2b``'s attention-block and MLP products at the
decode, chunk, 14b prefill and training rows, their backward products, and
the tied logits of ``recurrentgemma-2b`` (256,000 rows) and ``mamba2-370m``
(50,280 rows, a ragged last tile), forward and backward), and at phase 15's
shapes K1 non-causal with ``sq != sk`` and no lanes (decode and a 64-row
chunk over 1601 image keys at 64/8 heads, hd 128; decode and a 256-row
chunk over 512 frames at 16/16 heads, hd 64; 17 keys), K3 non-causal (1024
queries over 256 frames, the encoder's 256 x 256, 1601 keys at hd 128, 65
keys) and K2 at ``seamless-m4t-large-v2``'s 256,206-column head (the
logits at 8 and 512 rows, ``stream`` and ``wgmma``, and both backward
products of a 512-row chunk on ``wmma``), bf16 and f32, and K2 at the fused
QKV width of phase 16 (2048 x 4096 at 8 and 512 rows, bf16 and f32); phase
3 also serves the smoke config through the ``Router`` on the card and on
the CPU (``pws``, ``rws`` and a replica's death: card == CPU == a single
engine's tokens, the same placements and counters), takes
one f32 training step of the smoke config, and of ``olmoe-1b-7b``'s (its
expert products' backward on the batched ``fma`` instance),
``recurrentgemma-2b``'s and ``mamba2-370m``'s, on the card and
on the CPU from the same parameters and compares the loss, every gradient
and the updated parameters, serves the two recurrent smoke configs
through the ``Engine`` and the ``Server`` (the hybrid with both caches):
card == CPU tokens, and serves
the smoke config through the ``Engine`` with the fp and the int8 cache:
card == CPU == lockstep tokens, and a run under an injected fault plan
gives the clean run's tokens; and serves the smoke config at f32 on the
card under ``RunOptions(autotune="search")`` (each product searched on the
card into a table of its own), under ``"replay"`` of that table and with
``fused_qkv=True`` (on the card and on the CPU): card == CPU tokens.

The line before the last is a JSON object with one entry per kernel (and
the attention kernels' at hd 256 per ``gemma3-1b`` and per
``recurrentgemma-2b`` step, K1's cross-attention per ``seamless-m4t-large-v2``
and per ``llama-3.2-vision-90b`` decode step, K3 per
``seamless-m4t-large-v2`` training step and K2's ``wmma`` instance over its
head's backward); the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX or
of the ``repro`` package.
"""
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
ARCH = "qwen3-1.7b"
# phase 2's default tolerances against the plain versions, (atol, rtol)
COMPARE_TOL = {"bfloat16": (1e-2, 2 ** -7), "float32": (1e-4, 1e-4)}
BATCH, MAX_NEW, MAX_LEN = 4, 16, 256
# phase 8: the engine at full width
SLOTS, ENGINE_LEN, CHUNK, ENGINE_REQUESTS = 8, 512, 64, 16
# phase 16: the fleet (phase 8's requests, max_len and chunk) and its runs:
# (c) replica 1's sixth decode launch fails through every retry; (d) the
# work-remaining skew past which a round migrates work (queue depth 0, so
# the donor's decoding slots move once the queue drains); (e) the rounds
# before the join and between the join and replica 0's leave
FLEET_REPLICAS, FLEET_SLOTS, FLEET_SNAPSHOT = 2, 4, 4
FLEET_DEATH = "|decode@6=raise:99"
FLEET_REBALANCE = 24
FLEET_JOIN_AT, FLEET_LEAVE_AT = 4, 8
INT8 = dict(impl={"attention": "pallas"}, variants={"attention": {"kv_dtype": "int8"}})
# the rest of the dense family (phases 2, 3 and 11): two MoE configs, QKV
# bias, untied output heads, GQA ratios 8, 16/16 and 5
MOE_ARCH, OLMOE_ARCH = "qwen3-moe-30b-a3b", "olmoe-1b-7b"
FAMILY_ARCHS = (MOE_ARCH, OLMOE_ARCH, "qwen2.5-14b", "qwen3-32b")
WIDE_LAYERS, WIDE_NEW = 2, 4  # qwen2.5-14b and qwen3-32b at full width, 2 layers
# gemma3-1b (phases 2, 3 and 12): head dim 256, 4 query heads over 1 KV
# head, 512-key windows on 5 of every 6 layers; the engine's 2048-position
# cache (prompts of 64-1536 tokens) and training at 2 x 1024 tokens, where
# the windows bind
GEMMA_ARCH = "gemma3-1b"
GEMMA_LEN, GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ = 2048, 2, 1024
FAULT_PLAN = "decode@3=raise,slot@1=nan_logits"
# phase 3's fleet: replica 1's third decode launch fails through every retry
SMOKE_FLEET_DEATH = "|decode@3=raise:99"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 3  # the JAX trainer's CLI defaults
# phase 13: olmoe-1b-7b trained at full width.  Training state is 16 bytes a
# parameter (bf16 weight and gradient, f32 master, m and v); the depth is
# the largest that leaves FREE_AT_PEAK of the card free with TRANSIENT more
# for activations, the AdamW update's f32 temporaries of the largest leaf and
# the allocator's slack (measured on an H100 80GB at 10 layers: 2.8 GB
# allocated and 4.0 GB reserved past the state; phase 13 prints it).  Losses of two
# runs of the same steps: step 0 the same bits (nothing random, no atomics in
# the forward); later steps within MOE_STEP_RTOL, because the backward of the
# dispatch's gathers is a scatter_add that sums each token's eight expert
# contributions by bf16 atomics in no fixed order, so the two runs' gradients
# and updates part by bf16 roundings (AdamW steps each weight by ~lr
# whatever the gradient's size, so the losses move by far less)
FREE_AT_PEAK, TRANSIENT = 8e9, 6e9
MOE_STEP_RTOL = 1e-3
CKPT_KEEP = 1  # phase 13b's checkpoints kept: at most two on disk during a save
# phase 14: the recurrent-state families at full width and depth.
# recurrentgemma-2b (8 superblocks of rec, rec, attn and 2 tail rec blocks;
# 10 query heads over 1 KV head at hd 256, windows of 2048) through the
# Engine (8 slots, 4096 positions, chunk 256, 16 requests of 64-3072 prompt
# and 8-48 new tokens, so the window binds) and the Server in both layouts
# (4 prompts of 2100-2600 tokens, 32 new tokens: every 2048-slot ring
# wraps), trained at 2 x 1024; mamba2-370m through the Engine with the same
# slots and requests, chunk 256 (its ssm_chunk), trained at 4 x 1024.
REC_ARCH, SSM_ARCH = "recurrentgemma-2b", "mamba2-370m"
REC_LEN, REC_CHUNK, REC_PROMPTS = 4096, 256, (64, 3072)
RING_BATCH, RING_PROMPTS, RING_NEW = 4, (2100, 2600), 32
REC_TRAIN_BATCH, SSM_TRAIN_BATCH, REC_TRAIN_SEQ = 2, 4, 1024
# 14b's ring-vs-linear gate on the first decode step's logits, from the same
# prefill tokens and the same next token.  At f32 the two layouts differ only
# in the order K1 meets each row's 2048 keys (the ring's slot order): within
# RING_F32_ATOL, far above 26 layers' f32 rounding and far below what a wrong
# slot mapping moves.  At bf16 the model's own rounding dominates (P rounded
# to bf16 against another running max, a residual stream in bf16, bf16
# logits): the ring may differ from the linear layout by at most twice the
# linear layout's distance from the f32 model on the same weights and tokens,
# since each layout carries its own rounding.
RING_F32_ATOL = 1e-3
# phase 15: the cross-attention families.  seamless-m4t-large-v2 at full
# width and depth through the Engine (8 slots, 2048 positions: 512 frames a
# row; chunk 256; 16 requests of 64-1536 prompt and 8-48 new tokens, each
# with its own seeded audio_frames) and the Server (4 prompts of 64-512
# tokens, 16 new), trained at 4 x 1024 (256 frames); llama-3.2-vision-90b at
# full width and 10 of its 100 layers (two superblocks; 175 GB of bf16
# weights at full depth), its gates drawn non-zero, through the same Engine
# traffic with 1601 image tokens a request and the same Server traffic
SEAMLESS_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
X_LEN, X_CHUNK, X_PROMPTS = 2048, 256, (64, 1536)
X_SERVER_BATCH, X_SERVER_PROMPTS, X_SERVER_NEW = 4, (64, 512), 16
X_TRAIN_BATCH, X_TRAIN_SEQ = 4, 1024
VLM_LAYERS = 10
# library products and attention that the port's paths must not dispatch
LIBRARY_OPS = ("aten::scaled_dot_product_attention", "aten::mm", "aten::bmm", "aten::addmm",
               "aten::baddbmm", "aten::matmul")
# the registry's kernels (phase 10); no model path runs them
REGISTRY_KERNELS = ("bp_scan", "bi_transpose", "bi_fft", "strassen_matmul")
# phase 19: the dry-run cells it runs (host only, one process each, started at
# the phase's start and collected at its end), and phase 8's requests that
# Engine.restart serves on the one-card mesh
MESH_DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k", "single"),
                     ("olmoe-1b-7b", "train_4k", "single"),
                     ("llama-3.2-vision-90b", "decode_32k", "multi"))
MESH_REQUESTS = 4
MESH_DRYRUN_TIMEOUT_S = 300
# phase 20: four ranks share the card over gloo on the (2, 2) mesh.  (a) the
# f32 smoke config: tokens equal, two training steps' losses within
# SHARD_F32_RTOL (two layers of products summed in other orders, as the CPU
# tests hold the port to JAX); (b) phase 4's requests at SHARD_NEW new
# tokens; (c) training at full width and SHARD_TRAIN_LAYERS layers (cut for
# time), phase 6's 4 x 128 batch: the bf16 losses of two steps within
# SHARD_BF16_LOSS_RTOL of one device's (each row-parallel product's f32
# partial sums are all-reduced over other ranks' in another order)
SHARD_RANKS, SHARD_TP, SHARD_NEW = 4, 2, 8
SHARD_TRAIN_LAYERS, SHARD_TRAIN_STEPS = 4, 2
SHARD_F32_RTOL, SHARD_BF16_LOSS_RTOL = 1e-5, 1e-2
# (b)'s gate on the bf16 prefill logits, as phase 16 gates fused QKV: the
# sharded logits' distance from the f32 model's (the same seeded weights at
# f32 on one device) at most this many times the one-device bf16 logits'.
# Splitting a contraction over ranks, and the rows over data ranks, changes
# the f32 sums' order, so bf16 roundings move at 28 layers as they do with
# the product's width (ROADMAP.md queue 3); the f32 run (a) is exact.
# ``tools/sharded_smoke.py`` also reads the gate on a layout fault.
SHARD_F32_DISTANCE = 2.0
SHARD_SLOTS, SHARD_LEN, SHARD_CHUNK = 4, 64, 8
# card vs CPU at f32: loss, gradients (as the CPU tests hold the port to
# JAX), and parameters after one AdamW step.  The first step moves an
# element by lr * (u(g) + wd * p) with u(g) = g / (|g| + eps), whose slope is
# at most 1 / (|g| + eps), so the two sides' clipped gradients a and b bound
# the gap in u by |a - b| / (m + eps), m = min(|a|, |b|) where their signs
# agree and 0 where they do not.  Each element is held to that gap times lr
# plus 1% of lr (3e-6) for rounding.
SMOKE_LOSS_RTOL, SMOKE_GRAD_TOL, SMOKE_PARAM_ATOL = 1e-5, (1e-5, 5e-3), 3e-6
# phase 10: the registry's ops past the L2.  The f32 sum's slack per unit of
# sum |x| (~16 f32 ulps); normwise tolerances of the FFT against its plain
# version (which rounds as the kernel does, a pass past the cap included)
# and against torch.fft.fft (f32 twiddle tables, four radix-4 stages a pass
# at 256 x 256), and of the Strassen product against its plain version and
# against the classical f32 product (two levels of combinations).
STRASSEN_N = 8192
SCAN_SLACK = 1e-6
FFT_TOL = (1e-5, 1e-4)
MM_TOL = (1e-4, 1e-3)
# bf16 Strassen (the composition over K2), normwise: against its plain
# version 2^-7, as the card's tests hold it; against torch.matmul in bf16 8e-2,
# tests/test_strassen.py's bf16 rtol against the classical product (the
# operand combinations round to bf16 at each level)
MM_TOL_BF16 = (2 ** -7, 8e-2)
# host µs of one direct K2 call at phase 10's decode product before the
# wrapper memoized its plan and the SM count (this script, on that card)
K2_HOST_US_BEFORE, K2_HOST_US_CARD = 65.13, "NVIDIA H100 80GB HBM3, 700.00 W"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def comparer(max_err, failures):
    """``compare(kernel, label, got, want, dtype, atol=None, rtol=None)``:
    prints one case against its tolerance (by default ``COMPARE_TOL`` of
    its dtype: ``|got - want| <= atol + rtol |want|`` elementwise), keeps
    the kernel's largest error in ``max_err`` and appends a failed case to
    ``failures``."""
    def compare(kernel, label, got, want, dtype, atol=None, rtol=None):
        a_tol, r_tol = COMPARE_TOL[dtype] if atol is None else (atol, rtol)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= a_tol + r_tol * want.float().abs()).all())
        max_err[kernel] = max(max_err.get(kernel, 0.0), err)
        print(f"    {kernel:19s} {label:52s} max_abs_err {err:.3e} "
              f"(atol {a_tol:g} + rtol {r_tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {label}")
    return compare


def bound_ms(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, arg_sets, reps=5, stream=None, iters=None):
    """Device milliseconds per call: calls cycling through ``arg_sets``
    (sized past the L2 cache where the real caller finds its operands cold)
    are captured in one CUDA graph and replayed, timed with CUDA events, so
    the host's cost of launching each call is left out.  ``stream``: the
    capture stream (a backward is captured on the stream its forward ran
    on); ``iters``: calls per graph (default at least 20)."""
    iters = iters or max(20, len(arg_sets))
    for args in arg_sets:  # warm-up outside the capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def graph_ms(torch, fn, reps=3):
    """Device ms of one ``fn()`` (a whole step, in place) by CUDA graph
    replay: a warm-up call on a side stream, one captured call, ``reps``
    replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def copies_past_l2(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def int8_cache_hd(b, kv_heads, hd, positions, dev, g):
    """An int8 K and V cache of ``positions`` slots quantized as the model
    quantizes it (per-(row, KV head) absmax scales of N(0, 1) keys and
    values), and the two scales."""
    import torch

    from repro_torch.models.common import kv_scale, quantize_kv

    fp = [torch.randn(b, positions, kv_heads, hd, device=dev, generator=g) for _ in "kv"]
    scales = [kv_scale(x) for x in fp]
    return [quantize_kv(x, sc) for x, sc in zip(fp, scales)] + scales


def kernel_name(mangled):
    """An attention, K2, K4, K5, K6 or K7 kernel's mangled name as ``name<args>``, from
    the template ints and bools it carries and its float or int8 types (K1q's
    tensor-core kernel is ``flash_fwd_mma_kernel<hd,1>``, the f32 K1 decode
    instance ``flash_fwd_kernel<float,float,hd,1>``); any other name unchanged."""
    m = re.search(r"\d+((?:flash|mm|transpose|fft|scan|add)_\w+?_kernel|strassen_kernel)"
                  r"I((?:[fa]|L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = [{"f": "float", "a": "int8"}.get(t, n)
            for n, t in re.findall(r"L[ib](\d+)E|([fa])", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_entries(log):
    """(kernel, registers, bytes of spill stores) for each entry function
    in an ``nvcc -Xptxas=-v`` log, named by :func:`kernel_name`."""
    out = []
    for chunk in log.split("Compiling entry function")[1:]:
        mangled = re.search(r"'(\S+)'", chunk).group(1)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((kernel_name(mangled), int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def sass_counts(lib):
    """Tensor-core instructions in a built library's SASS (``cuobjdump
    -sass``): HMMA (mma.sync, WMMA) and HGMMA (wgmma), in all and in each
    kernel (by :func:`kernel_name`)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    ops = ("HMMA", "HGMMA")
    per_kernel = {}
    for chunk in sass.split("Function : ")[1:]:
        name = kernel_name(chunk.split(None, 1)[0])
        per_kernel[name] = {op: len(re.findall(rf"\b{op}\b", chunk)) for op in ops}
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}, per_kernel


def device_breakdown(torch, fn, top=8):
    """The device operations of one call of ``fn`` in a ``torch.profiler``
    trace: K2's and the attention kernels' share (ours, by kernel name) and
    the rest (PyTorch's kernels, copies and sets) with its ``top`` costliest
    names; ``None`` when the trace shows no device operation."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    own = re.compile(r"\b(mm_\w+_kernel|splitk_reduce|flash_\w+_kernel)\b")
    by_name, ours = {}, {}
    for e in events:
        hit = own.search(e.name)
        key = hit.group(1) if hit else e.name[:60]
        table = ours if hit else by_name
        n, us = table.get(key, (0, 0.0))
        table[key] = (n + 1, us + e.time_range.elapsed_us())
    rest = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(n=len(events), ours=ours, ours_ms=sum(us for _, us in ours.values()) / 1e3,
                rest_n=sum(n for n, _ in by_name.values()),
                rest_ms=sum(us for _, us in by_name.values()) / 1e3, top=rest[:top])


def engine_run(torch, engine, workload, label, cache_kind, counts, reset_counts, trace,
               per_step_want, smi, profile=False):
    """Serve ``workload`` (``(prompt, max_new)`` or ``(prompt, max_new,
    extras)`` a request) through ``engine`` (phases 11, 12, 14 and 15) with
    the ``cache_kind`` cache: every request complete with finite logits, no
    straggler flagged and no slot shed, and each decode step launching
    ``per_step_want``; prints the walls and one decode step's device time
    (and with ``profile`` its device operations by kind).  Returns the run's
    launches, the device and the wall ms per step."""
    from repro_torch.kernels import policy
    from repro_torch.launch.serve import Request

    trace.update(decode=[], prefill=[], pos=[],
                 finite=torch.ones((), dtype=torch.bool, device=engine.device))
    reqs = [Request(i, w[0], max_new=w[1], extras=w[2] if len(w) > 2 else None)
            for i, w in enumerate(workload)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with policy.apply(**(INT8 if cache_kind == "int8" else {})):
        out = engine.run(reqs)
    run_launches = counts()
    steps, chunks = out["decode_steps"], out["prefill_chunks"]
    per_step = trace["decode"]
    wall_ms = 1e3 * out["decode_s"] / max(steps, 1)
    kv = (next(engine.cache[k] for k in ("kv", "self") if k in engine.cache)
          if isinstance(engine.cache, dict) else engine.cache)
    kind = f"{type(kv).__name__} {kv.k.dtype}" if hasattr(kv, "k") else type(kv).__name__
    print(f"    {label}, {cache_kind} cache ({kind}): completed "
          f"{len(out['completed'])}/{len(reqs)}; logits finite {bool(trace['finite'])}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"    decode {wall_ms:.3f} ms/step over {steps} steps (host wall); prefill "
          f"{1e3 * out['prefill_s'] / max(chunks, 1):.3f} ms/chunk over {chunks} chunk "
          f"launches; {out['tok_per_s']:.1f} tok/s ({out['tokens']} tokens in "
          f"{out['wall_s']:.3f} s)")
    print(f"    launches in the run {run_launches}; per decode step "
          f"{sorted({tuple(sorted(c.items())) for c in per_step})}")
    check(all(len(r.out) == r.max_new for r in reqs) and len(out["completed"]) == len(reqs),
          f"{label} {cache_kind}: requests not completed: {out['completed']}")
    tel = out["telemetry"]
    check(bool(trace["finite"]) and tel["slots_poisoned"] == 0 and tel["retries"] == 0,
          f"{label} {cache_kind}: non-finite logits or a failed launch ({tel})")
    print(f"    telemetry: stragglers {tel['stragglers']}, degradations {tel['degradations']}; "
          f"watchdog {out['stats']['watchdog']}")
    check(tel["stragglers"] == 0 and tel["degradations"] == 0,
          f"{label} {cache_kind}: the unfaulted run flagged stragglers or shed slots ({tel})")
    check(steps == len(per_step) > 0, f"{label}: {steps} decode steps, {len(per_step)} traced")
    for c in per_step:
        check(all(c[k] == n for k, n in per_step_want.items()),
              f"{label} {cache_kind} decode step launched {c}; expected {per_step_want}")
    mid_pos = trace["pos"][len(trace["pos"]) // 2]
    tok = torch.zeros((engine.max_batch, 1), dtype=torch.int32, device=engine.device)
    dev_ms = time_ms(torch, lambda: type(engine.model).decode_step(
        engine.model, tok, mid_pos, engine.cache), [()], reps=2)
    print(f"    decode step on the device (CUDA graph replay, halfway lanes "
          f"{mid_pos.tolist()}): {dev_ms:.4f} ms; device busy {100 * dev_ms / wall_ms:.1f}% of "
          f"the {wall_ms:.3f} ms wall per step ({smi})")
    if profile:
        bd = device_breakdown(torch, lambda: type(engine.model).decode_step(
            engine.model, tok, mid_pos, engine.cache))
        if bd is None:
            print("    profiler trace of one decode step: no device operations seen "
                  "(not measured)")
        else:
            print(f"    profiler trace of one decode step: {bd['n']} device operations; ours "
                  f"{sum(n for n, _ in bd['ours'].values())} in {bd['ours_ms']:.4f} ms "
                  f"({ {k: (n, round(us / 1e3, 4)) for k, (n, us) in bd['ours'].items()} }); "
                  f"PyTorch's {bd['rest_n']} in {bd['rest_ms']:.4f} ms, the costliest (count, "
                  f"ms): { {k: (n, round(us / 1e3, 4)) for k, (n, us) in bd['top']} }")
    return run_launches, dev_ms, wall_ms


def phase_11(torch, np, dev, g, smi, workload, prompts, counts, reset_counts, trace, counted,
             finite_logits, registry_kernels):
    """The MoE path at full width (phase 11): ``qwen3-moe-30b-a3b`` (48 layers,
    128 experts top-8, untied head, bf16, nothing cut) built once on the card
    from a CUDA generator, served through the Engine (bf16, then int8 cache)
    and the lockstep Server; the batched K2 timed alone per decode step;
    ``olmoe-1b-7b`` at full width and depth through the Engine;
    ``qwen2.5-14b`` and ``qwen3-32b`` at full width with 2 layers through the
    Server.  Returns the batched K2's entry for the kernels line."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.moe_layer import gapped_capacity

    cfg = get_config(MOE_ARCH)
    L, d, E, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    print(f"[11] {MOE_ARCH} at full width and depth, bf16 ({L} layers, d={d}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim_}, {E} experts top-"
          f"{cfg.experts_per_token}, expert d_ff={f}, vocab={cfg.vocab_size}, untied head; "
          f"{cfg.param_count() / 1e9:.3f}e9 parameters) ({smi})")
    print(f"    memory held before the build: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=ENGINE_LEN, chunk=CHUNK)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    print(f"    weights built on the card from a CUDA generator in "
          f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.3f}e9 values, "
          f"{w_bytes / 1e9:.2f} GB; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(n_params == cfg.param_count(), f"{n_params} parameters, param_count "
          f"{cfg.param_count()}")
    trace_engine(engine, counted, finite_logits)
    # the bytes one decode step must read: every weight but the input
    # embedding (one row a token) once
    step_bytes = w_bytes - engine.model.embed.numel() * 2
    expert_bytes = sum(getattr(lyr, n).numel() * 2 for lyr in engine.model.layers
                       for n in ("e_gate", "e_up", "e_down"))
    floor_ms = 1e3 * step_bytes / HBM_BYTES_PER_S
    print(f"    {len(workload)} requests, {SLOTS} slots, {ENGINE_LEN} positions, chunk {CHUNK}; "
          f"a decode step reads {step_bytes / 1e9:.2f} GB of weights ({expert_bytes / 1e9:.2f} "
          f"GB of experts): >= {floor_ms:.2f} ms at 3.35 TB/s")
    zero = {k: 0 for k in registry_kernels}
    walls = {}
    for cache_kind, attn, other in (("bf16", "flash_attention", "flash_attention_int8"),
                                    ("int8", "flash_attention_int8", "flash_attention")):
        want = {"hbp_matmul_batched": 3 * L, "hbp_matmul": 4 * L + 1, attn: L, other: 0,
                "flash_attention_bwd": 0, **zero}
        launches, dev_ms, wall_ms = engine_run(
            torch, engine, workload, MOE_ARCH, cache_kind, counts, reset_counts, trace, want, smi,
            profile=cache_kind == "bf16")
        walls[cache_kind] = (dev_ms, wall_ms)
        if cache_kind == "bf16":
            moe_launches = launches["hbp_matmul_batched"]
        print(f"    {cache_kind}: device {dev_ms:.4f} ms per decode step against the "
              f"{floor_ms:.2f} ms floor ({100 * floor_ms / dev_ms:.1f}% of it); no per-expert "
              f"K2 launch: {3 * L} batched and {4 * L + 1} 2-D K2 launches a step")

    # the lockstep Server's path (Server.run_batch, which the Engine inherits)
    # over the same model: phase 4's traffic, into a 512-slot cache
    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    reset_counts()
    out = Server.run_batch(engine, reqs)
    launches = counts()
    steps = out["decode_steps"]
    print(f"    lockstep Server (phase 4's traffic: {BATCH} prompts of {[len(p) for p in prompts]} "
          f"tokens, {MAX_NEW} new): completed {out['completed']}; logits finite "
          f"{out['logits_finite']}; prefill {1e3 * out['prefill_s']:.3f} ms; decode "
          f"{1e3 * out['decode_s'] / max(steps, 1):.3f} ms/step over {steps} steps; launches "
          f"{launches}")
    check(all(len(r.out) == MAX_NEW for r in reqs) and out["logits_finite"],
          f"{MOE_ARCH} lockstep: {out['completed']}, finite {out['logits_finite']}")
    check(launches["hbp_matmul_batched"] == 3 * L * (1 + steps)
          and launches["hbp_matmul"] == (4 * L + 1) * (1 + steps),
          f"{MOE_ARCH} lockstep launches {launches} over a prefill and {steps} steps")

    # the batched K2 alone at the decode step's products, each layer's own
    # experts (403 MB a product, past the L2), beside its bound, its plain
    # version and torch.bmm over the same slabs
    cap = gapped_capacity(SLOTS, E, cfg.experts_per_token, cfg.capacity_factor)
    bf = torch.bfloat16
    layers = engine.model.layers
    shapes = (("gate/up", d, "e_gate", 2), ("down", f, "e_down", 1))
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    for name, k_in, weight, per_layer in shapes:
        sets = [(torch.randn(E, cap, k_in, device=dev, generator=g).to(bf),
                 getattr(lyr, weight)) for lyr in layers]
        n_out = sets[0][1].shape[-1]
        t_k = time_ms(torch, hbp_matmul, sets, reps=3)
        t_p = time_ms(torch, matmul_ref, sets, reps=1)
        t_l = time_ms(torch, torch.bmm, sets, reps=3)
        nbytes = (E * cap * k_in + E * k_in * n_out + E * cap * n_out) * 2
        ops = 2 * E * cap * k_in * n_out
        b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
        calls = per_layer * L
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms),
                       ("bytes", nbytes), ("ops", ops)):
            tot[key] += calls * v
        print(f"    batched K2 {name} ({E}x{cap}x{k_in} @ {E}x{k_in}x{n_out}, "
              f"{mm_path(*sets[0])}): {t_k:.4f} ms a call (bound {b_ms:.4f} by {b_by}, "
              f"{100 * b_ms / t_k:.1f}% of it); plain {t_p:.4f}; torch.bmm {t_l:.4f}; "
              f"{calls} calls a decode step")
        del sets
    print(f"    batched K2 per decode step ({3 * L} launches): {tot['ms']:.4f} ms against its "
          f"{tot['bound_ms']:.4f} ms bound ({100 * tot['bound_ms'] / tot['ms']:.1f}%); plain "
          f"{tot['plain_ms']:.4f}; torch.bmm {tot['library_ms']:.4f} ({smi})")
    print(f"    of the bf16 engine's {walls['bf16'][0]:.4f} ms device step: batched K2 "
          f"{tot['ms']:.4f} ms (timed alone), the rest {walls['bf16'][0] - tot['ms']:.4f} ms")
    del engine, layers
    gc.collect()
    torch.cuda.empty_cache()

    # olmoe-1b-7b at full width and depth through the engine (bf16 cache)
    ocfg = get_config(OLMOE_ARCH)
    orng = np.random.default_rng(0)
    oload = [(orng.integers(3, ocfg.vocab_size, int(orng.integers(16, 193))).astype(np.int32),
              int(orng.integers(8, 49))) for _ in range(ENGINE_REQUESTS)]
    t0 = time.perf_counter()
    engine = Engine(ocfg, device="cuda", max_batch=SLOTS, max_len=ENGINE_LEN, chunk=CHUNK)
    torch.cuda.synchronize()
    o_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    o_experts = sum(getattr(lyr, n).numel() * 2 for lyr in engine.model.layers
                    for n in ("e_gate", "e_up", "e_down"))
    OL = ocfg.n_layers
    print(f"[11] {OLMOE_ARCH} at full width and depth, bf16 ({OL} layers, d={ocfg.d_model}, "
          f"{ocfg.n_heads}/{ocfg.n_kv_heads} heads, {ocfg.n_experts} experts top-"
          f"{ocfg.experts_per_token}): {o_bytes / 1e9:.2f} GB built in "
          f"{time.perf_counter() - t0:.2f} s; experts {o_experts / 1e9:.2f} GB a decode step: "
          f">= {1e3 * o_experts / HBM_BYTES_PER_S:.2f} ms ({smi})")
    trace_engine(engine, counted, finite_logits)
    want = {"hbp_matmul_batched": 3 * OL, "hbp_matmul": 4 * OL + 1, "flash_attention": OL,
            "flash_attention_int8": 0, "flash_attention_bwd": 0, **zero}
    engine_run(torch, engine, oload, OLMOE_ARCH, "bf16", counts, reset_counts, trace,
                   want, smi, profile=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # qwen2.5-14b (QKV bias, GQA 40/8) and qwen3-32b (GQA 64/8) at full width,
    # 2 layers, through the lockstep Server
    for arch in ("qwen2.5-14b", "qwen3-32b"):
        wcfg = reduced(get_config(arch), n_layers=WIDE_LAYERS)
        wrng = np.random.default_rng(0)
        wreqs = [Request(i, wrng.integers(3, wcfg.vocab_size, int(n)).astype(np.int32),
                         max_new=WIDE_NEW) for i, n in enumerate(wrng.integers(16, 65, BATCH))]
        srv = Server(wcfg, device="cuda", max_batch=BATCH, max_len=MAX_LEN)
        reset_counts()
        out = srv.run_batch(wreqs)
        launches = counts()
        steps = out["decode_steps"]
        per = {"hbp_matmul": 7 * WIDE_LAYERS + 1, "flash_attention": WIDE_LAYERS,
               "hbp_matmul_batched": 0}
        print(f"[11] {arch} at full width, {WIDE_LAYERS} of {get_config(arch).n_layers} layers "
              f"(d={wcfg.d_model}, {wcfg.n_heads}/{wcfg.n_kv_heads} heads, d_ff={wcfg.d_ff}, "
              f"vocab={wcfg.vocab_size}, qkv_bias {wcfg.qkv_bias}, untied head) through the "
              f"Server: completed {out['completed']}; logits finite {out['logits_finite']}; "
              f"decode {1e3 * out['decode_s'] / max(steps, 1):.3f} ms/step over {steps} steps; "
              f"launches {launches} ({smi})")
        check(all(len(r.out) == WIDE_NEW for r in wreqs) and out["logits_finite"],
              f"{arch}: {out['completed']}, finite {out['logits_finite']}")
        check(all(launches[k] == n * (1 + steps) for k, n in per.items()),
              f"{arch}: launches {launches} over a prefill and {steps} steps, expected {per} each")
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    return dict(launches=moe_launches, **tot)


def sdpa_backend(torch, sdpa_args):
    """The backend PyTorch's dispatcher picks for one
    ``scaled_dot_product_attention`` call on ``sdpa_args`` (q, k, v in the
    model's layout, the boolean mask or None, is_causal), by name."""
    q, k, v, mask, causal = sdpa_args
    try:
        from torch.nn.attention import SDPBackend

        names = {int(m.value): n for n, m in SDPBackend.__members__.items()}
        idx = torch._fused_sdp_choice(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      attn_mask=mask, is_causal=causal, enable_gqa=True)
        return names.get(int(idx), str(idx))
    except Exception as e:  # noqa: BLE001 — an internal call; report what failed
        return f"not determined ({type(e).__name__})"


def time_attention_decode(torch, dev, g, b, sk, heads, calls, causal=False, window=0,
                          lanes=None):
    """K1 over one decode step's ``calls`` attentions of ``b`` rows of one
    query over ``sk`` keys (bf16, a k/v set a layer and past the L2),
    against its plain version and ``scaled_dot_product_attention``.
    ``lanes``: the rows' ``(q_offset, kv_len)`` lists, which the library
    call gets as a boolean mask; without them every key is visible (no
    mask).  Returns the step's ms, plain_ms, library_ms, bound_ms, bound_by,
    bytes (each row's visible k/v, q, out and lse, the lanes), ops (two
    products over each visible key), the kernel's path and SDPA's backend."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, fwd_path

    h, kvh, hd = heads
    bf, es = torch.bfloat16, 2
    qo_t = kl_t = mask = None
    seen = b * sk  # keys visible to the step's rows
    if lanes is not None:
        qo_t, kl_t = (torch.tensor(x, dtype=torch.int32, device=dev) for x in lanes)
        kpos = torch.arange(sk, device=dev)
        ok = (kpos[None, :] < kl_t[:, None]) & (kpos[None, :] <= qo_t[:, None])
        if window:
            ok &= kpos[None, :] > qo_t[:, None] - window
        mask = ok[:, None, None, :]
        seen = sum(min(n, window) if window else n for n in lanes[1])
    sets = [(torch.randn(b, 1, h, hd, device=dev, generator=g).to(bf),
             *(torch.randn(b, sk, kvh, hd, device=dev, generator=g).to(bf) for _ in "kv"))
            for _ in range(max(calls, copies_past_l2(2 * b * sk * kvh * hd * es)))]
    kw = dict(causal=causal, window=window, q_offset=qo_t, kv_len=kl_t)
    t_k = calls * time_ms(torch, lambda q, k, v: flash_attention(q, k, v, **kw), sets)
    t_p = calls * time_ms(torch, lambda q, k, v: flash_attention_ref(q, k, v, **kw), sets)
    t_l = calls * time_ms(torch, lambda q, k, v: sdpa(q, k, v, mask, False), sets)
    nbytes = calls * (2 * kvh * hd * es * seen + 2 * b * h * hd * es + b * h * 4
                      + (0 if lanes is None else 2 * b * 4))
    ops = calls * 4 * hd * h * seen
    b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, ops=ops, path=fwd_path(sets[0][0]),
                backend=sdpa_backend(torch, (*sets[0], mask, False)))


def time_attention_bwd(torch, dev, g, b, sq, sk, heads, causal, window=0, mask=None):
    """K3 at one call's shape (bf16, input sets past the L2), against its
    plain version and autograd's backward of one
    ``scaled_dot_product_attention`` call (``mask``: its boolean mask;
    without one its ``is_causal`` is ``causal``), timed alone.  Returns one
    call's ms, plain_ms, library_ms, bound_ms, bound_by, bytes (read q, k,
    v, out, lse and dO; write dq, dk and dv), ops (the five products S, dP,
    dq, dk and dv over each visible (query, key) pair), the kernel's path
    and SDPA's backend."""
    from repro_torch.kernels.flash_attention import (bwd_path, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref)

    h, kvh, hd = heads
    bf, es = torch.bfloat16, 2
    q_bytes, kv_bytes = b * sq * h * hd * es, b * sk * kvh * hd * es
    lib_causal = causal and mask is None
    sets, lib_sets = [], []
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    for _ in range(copies_past_l2(4 * q_bytes + 4 * kv_bytes)):
        q, go = (torch.randn(b, sq, h, hd, device=dev, generator=g).to(bf) for _ in "qg")
        k, v = (torch.randn(b, sk, kvh, hd, device=dev, generator=g).to(bf) for _ in "kv")
        o, lse = flash_attention(q, k, v, causal=causal, window=window)
        sets.append((q, k, v, o, lse, go))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        with torch.cuda.stream(lib_stream):
            lib_out = sdpa(*leaves, mask, lib_causal)
        lib_sets.append((lib_out, leaves, go.transpose(1, 2)))
    kw = dict(causal=causal, window=window)
    t_k = time_ms(torch, lambda *a: flash_attention_bwd(*a, **kw), sets)
    t_p = time_ms(torch, lambda *a: flash_attention_bwd_ref(*a, **kw), sets)
    torch.cuda.current_stream().wait_stream(lib_stream)
    t_l = time_ms(torch, lambda o, leaves, go: torch.autograd.grad(o, leaves, go,
                                                                  retain_graph=True),
                  lib_sets, stream=lib_stream)
    w = window or sq
    pairs = b * h * (sum(min(i + 1, w) for i in range(sq)) if causal else sq * sk)
    nbytes = 4 * q_bytes + 4 * kv_bytes + b * h * sq * 4
    b_ms, b_by = bound_ms(nbytes, 10 * hd * pairs, "bfloat16")
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, ops=10 * hd * pairs, path=bwd_path(q),
                backend=sdpa_backend(torch, (q, k, v, mask, lib_causal)))


def add_calls(tot, part, calls):
    """``tot`` += ``calls`` x ``part`` in the summed keys of a timing."""
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops"):
        tot[key] = tot.get(key, 0) + calls * part[key]
    return tot


def train_and_time(torch, dev, smi, cfg, batch, seq, per_step, label, counts, reset_counts):
    """3 AdamW steps of ``cfg`` at ``batch`` x ``seq`` tokens through
    ``launch.train.train`` from a seeded init (phases 12 and 14): loss and
    grad norm finite, the launches ``per_step`` by construction; prints the
    peak memory, each step's host wall, one step on the device (CUDA graph
    replay) and one step's device operations.  Returns (launches, device
    ms a step)."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    data_cfg = DataConfig(global_batch=batch, seq_len=seq)
    run = train(cfg, steps=TRAIN_STEPS, data_cfg=data_cfg, device="cuda", log_every=0)
    launches = counts()
    print(f"    {label} trained, batch {batch} x {seq}, {TRAIN_STEPS} AdamW steps from a seeded "
          f"init (remat full); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for i, (loss, gn, sec) in enumerate(zip(run["losses"], run["grad_norms"], run["step_s"])):
        print(f"    step {i}: loss {loss:.4f}, grad norm {gn:.4f}, {1e3 * sec:.3f} ms (host wall)")
    print(f"    launches in the run {launches}; expected per step {per_step}")
    check(all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]),
          f"{label}: non-finite loss or grad norm in training")
    for name, n in per_step.items():
        check(launches[name] == TRAIN_STEPS * n,
              f"{label} training: {name} launched {launches[name]}, expected "
              f"{TRAIN_STEPS} x {n}")
    train_step = make_train_step(run["model"])
    b = {key: torch.from_numpy(x).to(dev)
         for key, x in SyntheticLMDataset(data_cfg, cfg).batch_at(0).items()}
    dev_ms = graph_ms(torch, lambda: train_step(run["opt_state"], b))
    wall_ms = 1e3 * sum(run["step_s"][1:]) / max(len(run["step_s"]) - 1, 1)
    print(f"    training step: {dev_ms:.4f} ms on the device (CUDA graph replay), "
          f"{wall_ms:.3f} ms of host wall (steps 1-{TRAIN_STEPS - 1}): device busy "
          f"{100 * dev_ms / wall_ms:.1f}% ({smi})")
    bd = device_breakdown(torch, lambda: train_step(run["opt_state"], b), top=10)
    if bd is None:
        print("    profiler trace of one training step: no device operations seen "
              "(not measured)")
    else:
        print(f"    profiler trace of one training step: {bd['n']} device operations; ours "
              f"{sum(n for n, _ in bd['ours'].values())} in {bd['ours_ms']:.4f} ms; "
              f"PyTorch's {bd['rest_n']} in {bd['rest_ms']:.4f} ms, the costliest (count, "
              f"ms): { {k: (n, round(us / 1e3, 4)) for k, (n, us) in bd['top']} }")
    del run, b, train_step
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dev_ms


def phase_12(torch, np, dev, g, smi, prompts, counts, reset_counts, trace, counted,
             finite_logits, registry_kernels, sdpa, lane):
    """``gemma3-1b`` at full width and depth (phase 12): 26 layers, d 1152, 4
    query heads over 1 KV head at hd 256, windows of 512 on 22 layers, a
    262,144-token tied vocab, bf16, drawn on the card from a CUDA generator
    after phase 11 freed its memory.  Served through the Engine (bf16, then
    int8 cache: 8 slots, 2048 positions, chunk 64, 16 requests of 64-1536
    prompt and 8-48 new tokens) and the lockstep Server (phase 4's traffic),
    then trained for 3 AdamW steps at 2 x 1024 tokens.  Times K1 and K1q per
    decode step and K3 per training step beside their bounds, plain
    versions and ``scaled_dot_product_attention``, and both steps on the
    device.  Returns the hd-256 entries' sums for the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_ref,
                                                     fwd_path, kv_splits, mma_kv_tile)
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.dense import layer_windows

    cfg = get_config(GEMMA_ARCH)
    L, d, h, kvh, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim_, cfg.vocab_size)
    windows = [w or 0 for w in layer_windows(cfg)]
    bf, es = torch.bfloat16, 2
    print(f"[12] {GEMMA_ARCH} at full width and depth, bf16 ({L} layers, d={d}, {h}/{kvh} heads, "
          f"hd={hd}, d_ff={cfg.d_ff}, vocab={V}, tied, windows of {cfg.sliding_window} on "
          f"{sum(map(bool, windows))} layers; {cfg.param_count() / 1e9:.3f}e9 parameters) ({smi})")
    print(f"    memory held before the build: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=GEMMA_LEN, chunk=CHUNK)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    print(f"    weights built on the card from a CUDA generator in "
          f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.3f}e9 values, "
          f"{w_bytes / 1e9:.2f} GB")
    check(n_params == cfg.param_count(), f"{n_params} parameters, param_count {cfg.param_count()}")
    trace_engine(engine, counted, finite_logits)
    rng = np.random.default_rng(0)
    workload = [(rng.integers(3, V, int(rng.integers(64, 1537))).astype(np.int32),
                 int(rng.integers(8, 49))) for _ in range(ENGINE_REQUESTS)]
    lens = [len(p) for p, _ in workload]
    print(f"    {ENGINE_REQUESTS} requests, {SLOTS} slots, {GEMMA_LEN} positions, chunk {CHUNK}; "
          f"prompts {lens} ({sum(n > cfg.sliding_window for n in lens)} past the window), "
          f"max_new {[m for _, m in workload]}")
    zero = {k: 0 for k in registry_kernels}
    runs = {}
    for cache_kind, attn, other in (("bf16", "flash_attention", "flash_attention_int8"),
                                    ("int8", "flash_attention_int8", "flash_attention")):
        want = {"hbp_matmul": 7 * L + 1, "hbp_matmul_batched": 0, attn: L, other: 0,
                "flash_attention_bwd": 0, **zero}
        launches, dev_ms, wall_ms = engine_run(
            torch, engine, workload, GEMMA_ARCH, cache_kind, counts, reset_counts, trace, want,
            smi, profile=cache_kind == "bf16")
        mid = trace["pos"][len(trace["pos"]) // 2].tolist()
        runs[cache_kind] = dict(launches=launches, dev_ms=dev_ms, wall_ms=wall_ms, mid=mid)
        print(f"    {cache_kind}: {7 * L + 1} K2 and {L} {attn} launches a decode step; device "
              f"{dev_ms:.4f} ms a step, {wall_ms:.3f} ms of host wall")

    # the lockstep Server's path over the same model: phase 4's traffic
    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    reset_counts()
    out = Server.run_batch(engine, reqs)
    launches = counts()
    steps = out["decode_steps"]
    print(f"    lockstep Server (phase 4's traffic: {BATCH} prompts of {[len(p) for p in prompts]} "
          f"tokens, {MAX_NEW} new): completed {out['completed']}; logits finite "
          f"{out['logits_finite']}; decode {1e3 * out['decode_s'] / max(steps, 1):.3f} ms/step "
          f"over {steps} steps; launches {launches}")
    check(all(len(r.out) == MAX_NEW for r in reqs) and out["logits_finite"],
          f"{GEMMA_ARCH} lockstep: {out['completed']}, finite {out['logits_finite']}")
    check(launches["hbp_matmul"] == (7 * L + 1) * (1 + steps)
          and launches["flash_attention"] == L * (1 + steps),
          f"{GEMMA_ARCH} lockstep launches {launches} over a prefill and {steps} steps")
    del engine, reqs
    gc.collect()
    torch.cuda.empty_cache()

    # K1 and K1q per decode step: every layer's own cache (2048 positions)
    # and window, at the engine runs' halfway lanes
    kpos = torch.arange(GEMMA_LEN, device=dev)
    tot = {}
    print(f"    attention per decode step at hd {hd} ({L} calls: {sum(map(bool, windows))} "
          f"windowed, {windows.count(0)} global), times in ms ({smi})")
    for cache_kind, name in (("bf16", "flash_attention_hd256"),
                             ("int8", "flash_attention_int8_hd256")):
        qo = runs[cache_kind]["mid"]
        kl = [min(p + 1, GEMMA_LEN) for p in qo]
        qo_t, kl_t = lane(qo), lane(kl)
        sets, lib_sets = [], []
        nbytes = ops = 0
        for w in windows:
            qd = torch.randn(SLOTS, 1, h, hd, device=dev, generator=g).to(bf)
            ok = (kpos[None, :] < kl_t[:, None]) & (kpos[None, :] <= qo_t[:, None])
            if w:
                ok &= kpos[None, :] > qo_t[:, None] - w
            mask = ok[:, None, None, :]
            if cache_kind == "bf16":
                k, v = (torch.randn(SLOTS, GEMMA_LEN, kvh, hd, device=dev, generator=g).to(bf)
                        for _ in "kv")
                sets.append((qd, k, v, None, None, qo_t, kl_t, w))
                lib_sets.append((qd, k, v, mask, False))
                kv_es = es
            else:
                k8, v8, ks, vs = int8_cache_hd(SLOTS, kvh, hd, GEMMA_LEN, dev, g)
                sets.append((qd, k8, v8, ks, vs, qo_t, kl_t, w))
                lib_sets.append((qd, k8, v8, ks, vs, mask))
                kv_es = 1
            seen = sum(min(n, w) if w else n for n in kl)  # keys each row's window holds
            nbytes += (2 * kvh * hd * kv_es * seen + 2 * SLOTS * h * hd * es + SLOTS * h * 4
                       + 2 * SLOTS * 4 + (2 * SLOTS * kvh * 4 if kv_es == 1 else 0))
            ops += 4 * hd * h * seen
        kern = lambda qd, k, v, ks, vs, qo, kl, w: flash_attention(  # noqa: E731
            qd, k, v, causal=True, window=w, q_offset=qo, kv_len=kl, k_scale=ks, v_scale=vs)
        plain = lambda qd, k, v, ks, vs, qo, kl, w: flash_attention_ref(  # noqa: E731
            qd, k, v, causal=True, window=w, q_offset=qo, kv_len=kl, k_scale=ks, v_scale=vs)
        t_k = L * time_ms(torch, kern, sets)
        t_p = L * time_ms(torch, plain, sets)
        if cache_kind == "bf16":
            lib_name = "scaled_dot_product_attention"
            t_l = L * time_ms(torch, sdpa, lib_sets)
            backend = sdpa_backend(torch, lib_sets[0])
        else:
            lib_name = "dequantize to bf16, then scaled_dot_product_attention"

            def lib(qd, k8, v8, ks, vs, mask):
                kb, vb = ((x.float() * sc[:, None, :, None]).to(bf)
                          for x, sc in ((k8, ks), (v8, vs)))
                return sdpa(qd, kb, vb, mask, False)

            t_l = L * time_ms(torch, lib, lib_sets)
            kb, vb = ((x.float() * sc[:, None, :, None]).to(bf)
                      for x, sc in ((sets[0][1], sets[0][3]), (sets[0][2], sets[0][4])))
            backend = sdpa_backend(torch, (sets[0][0], kb, vb, lib_sets[0][5], False))
        b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
        splits = kv_splits(SLOTS, 1, h, kvh, GEMMA_LEN,
                           torch.cuda.get_device_properties(dev).multi_processor_count,
                           mma_kv_tile(hd))
        inst = fwd_path(sets[0][0]) + (f", {splits} splits" if cache_kind == "int8" else "")
        tot[name] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bytes=nbytes,
                         ops=ops, launches=runs[cache_kind]["launches"][
                             "flash_attention" if cache_kind == "bf16" else "flash_attention_int8"])
        print(f"    {name} ({inst}) over the {cache_kind} cache, lanes kv_len {kl}: {t_k:.4f} ms "
              f"a step (bound {b_ms:.4f} by {b_by}, {100 * b_ms / t_k:.1f}% of it; "
              f"{nbytes / 1e6:.3f} MB); plain {t_p:.4f}; {lib_name} {t_l:.4f} (backend "
              f"{backend} with the boolean mask); {t_k / runs[cache_kind]['dev_ms'] * 100:.1f}% "
              f"of the device step")
        del sets, lib_sets

    # training at 2 x 1024, where the windows bind
    n_chunks = GEMMA_TRAIN_SEQ // min(512, GEMMA_TRAIN_SEQ)  # RunOptions.ce_chunk 512
    per_train_step = {"hbp_matmul": L * 7 * 4 + n_chunks * 4,
                      "flash_attention": 2 * L, "flash_attention_bwd": L}
    train_launches, train_ms = train_and_time(
        torch, dev, smi, cfg, GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ, per_train_step, GEMMA_ARCH,
        counts, reset_counts)

    # K3 per training step: the windowed and the global layers' calls
    B, S = GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ
    pos = torch.arange(S, device=dev)
    bwd = dict(launches=train_launches["flash_attention_bwd"])
    for w in sorted(set(windows)):
        calls = windows.count(w)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w) if w else None
        t = time_attention_bwd(torch, dev, g, B, S, S, (h, kvh, hd), True, window=w, mask=band)
        add_calls(bwd, t, calls)
        print(f"    flash_attention_bwd_hd256 ({t['path']}) {B}x{S}x{h}x{hd}, "
              f"{'window ' + str(w) if w else 'global'}: {t['ms']:.4f} ms a call (bound "
              f"{t['bound_ms']:.4f} by {t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of "
              f"it); plain {t['plain_ms']:.4f}; autograd backward of "
              f"scaled_dot_product_attention {t['library_ms']:.4f} (backend {t['backend']}"
              f"{' with the boolean band mask' if w else ', is_causal'}); {calls} calls a step")
    print(f"    K3 per training step ({L} calls): {bwd['ms']:.4f} ms (bound {bwd['bound_ms']:.4f}, "
          f"plain {bwd['plain_ms']:.4f}, library {bwd['library_ms']:.4f}); "
          f"{100 * bwd['ms'] / train_ms:.1f}% of the {train_ms:.4f} ms device step ({smi})")
    tot["flash_attention_bwd_hd256"] = bwd
    torch.cuda.empty_cache()
    return tot


def engine_tracers(torch, counts):
    """``(trace, counted, finite_logits)``: the engine's own launches,
    wrapped on the instance by ``counted(kind, fn)`` to record what each
    launch ran (kernel launches per decode step and per prefill chunk, and
    the decode lanes, device tensors read after the run), and the model's
    steps by ``finite_logits(fn)`` to record whether every logit was finite
    (a device flag, so the run gains no host sync), into ``trace``."""
    trace = {}

    def counted(kind, fn):
        def wrapper(*args):
            before = counts()
            result = fn(*args)
            trace[kind].append({k: n - before[k] for k, n in counts().items()})
            if kind == "decode":
                trace["pos"].append(args[1].clone())
            return result
        return wrapper

    def finite_logits(fn):
        def wrapper(*args, **kw):
            logits, cache = fn(*args, **kw)
            trace["finite"] &= torch.isfinite(logits).all()
            return logits, cache
        return wrapper

    return trace, counted, finite_logits


def trace_engine(engine, counted, finite_logits):
    """Wrap ``engine``'s launches with ``counted`` and its model's steps
    with ``finite_logits`` (:func:`engine_tracers`), on the instance."""
    engine._decode_rows = counted("decode", engine._decode_rows)
    engine._chunk_first = counted("prefill", engine._chunk_first)
    engine._chunk_cont = counted("prefill", engine._chunk_cont)
    engine.model.decode_step = finite_logits(engine.model.decode_step)
    engine.model.prefill_chunk = finite_logits(engine.model.prefill_chunk)


def launch_counters():
    """``(kernels, reset_counts, counts)``: every kernel wrapper by name, a
    function that sets their launch counts to 0, and one that reads them.
    ``counts()`` splits K2's in two, ``hbp_matmul`` its 2-D products and
    ``hbp_matmul_batched`` its batched ones (one launch for all the experts
    of a product), of which ``hbp_matmul_batched_bwd`` counts those of
    batched backwards; ``hbp_matmul_wmma`` counts those of K2's ``wmma``
    instance among all of them."""
    from repro_torch.kernels.bi_fft import bi_fft
    from repro_torch.kernels.bi_transpose import bi_transpose
    from repro_torch.kernels.bp_scan import bp_scan
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_int8)
    from repro_torch.kernels.hbp_matmul import hbp_matmul
    from repro_torch.kernels.strassen_matmul import matmul, strassen_matmul

    kernels = {"hbp_matmul": hbp_matmul, "flash_attention": flash_attention,
               "flash_attention_bwd": flash_attention_bwd,
               "flash_attention_int8": flash_attention_int8,
               "bp_scan": bp_scan, "bi_transpose": bi_transpose, "bi_fft": bi_fft,
               "strassen_matmul": strassen_matmul}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0
        hbp_matmul.batched_launches = 0
        hbp_matmul.wmma_launches = 0
        matmul.batched_backward_launches = 0

    def counts():
        c = {name: k.launches for name, k in kernels.items()}
        c["hbp_matmul_batched"] = hbp_matmul.batched_launches
        c["hbp_matmul"] -= c["hbp_matmul_batched"]
        c["hbp_matmul_batched_bwd"] = matmul.batched_backward_launches
        c["hbp_matmul_wmma"] = hbp_matmul.wmma_launches
        return c

    return kernels, reset_counts, counts


def moe_depth(torch, cfg):
    """Phase 13's depth: the most layers of ``cfg`` whose training state
    (16 bytes a parameter) leaves FREE_AT_PEAK of the card free, with
    TRANSIENT more for the step's temporaries; the layer's and the rest's
    parameters from the config's analytic count."""
    from repro_torch.configs import reduced

    one = reduced(cfg, n_layers=1).param_count()
    per_layer = (cfg.param_count() - one) / (cfg.n_layers - 1)
    rest = one - per_layer
    free, total = torch.cuda.mem_get_info()
    depth = int((free - FREE_AT_PEAK - TRANSIENT - 16 * rest) // (16 * per_layer))
    return max(1, min(cfg.n_layers, depth)), per_layer, rest, free, total


def phase_13(torch, np, dev, g, smi, counts, reset_counts, registry_kernels):
    """``olmoe-1b-7b`` trained at full width under the fault-tolerant runner
    (phase 13), then the checkpoint round trip at 1 layer (13b).  Returns
    the batched backward's entry for the kernels line."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models.moe_layer import gapped_capacity
    from repro_torch.runtime.fault_tolerance import InjectedFault

    cfg = get_config(OLMOE_ARCH)
    L_full, d, E, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    depth, per_layer, rest, free, total = moe_depth(torch, cfg)
    tcfg = reduced(cfg, n_layers=depth)
    T = TRAIN_BATCH * TRAIN_SEQ
    cap = gapped_capacity(T, E, cfg.experts_per_token, cfg.capacity_factor)
    data_cfg = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    print(f"[13] {OLMOE_ARCH} trained at full width, bf16 (d={d}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, hd={cfg.head_dim_}, {E} experts top-"
          f"{cfg.experts_per_token}, expert d_ff={f}, vocab={cfg.vocab_size}, untied head); "
          f"depth cut to {depth} of {L_full} layers: {16 * per_layer / 1e9:.3f} GB of training "
          f"state a layer and {16 * rest / 1e9:.3f} GB for the rest, {free / 1e9:.2f} GB free "
          f"of {total / 1e9:.2f} GB ({held / 1e9:.2f} GB held by PyTorch's allocator, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of it allocated), "
          f"{FREE_AT_PEAK / 1e9:g} GB to stay free and {TRANSIENT / 1e9:g} GB for temporaries "
          f"({smi})")
    print(f"    {TRAIN_STEPS} AdamW steps at {TRAIN_BATCH} x {TRAIN_SEQ} tokens (expert capacity "
          f"{cap}) through train() under its FaultTolerantRunner; step 1's first attempt "
          "fails after its backward, before its update")
    attempts = []

    def inject(step):
        attempts.append(step)
        if step == 1 and attempts.count(1) == 1:
            raise InjectedFault("injected: step 1, after its backward, before its update")

    n_chunks = TRAIN_SEQ // min(512, TRAIN_SEQ)  # RunOptions.ce_chunk 512
    # launches one attempt of a step makes by construction (remat full): each
    # expert product forward, recomputed and twice backward (dA, dB), the
    # attention's four 2-D products likewise, the head's per chunk; K1 twice
    # and K3 once a layer
    per_attempt = {"hbp_matmul_batched": 12 * depth, "hbp_matmul_batched_bwd": 6 * depth,
                   "hbp_matmul": 16 * depth + 4 * n_chunks, "flash_attention": 2 * depth,
                   "flash_attention_bwd": depth, "flash_attention_int8": 0,
                   **{k: 0 for k in registry_kernels}}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train(tcfg, steps=TRAIN_STEPS, data_cfg=data_cfg, device="cuda", log_every=0,
                before_update=inject)
    launches = counts()
    peak_alloc, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    free_at_peak = free - (peak_reserved - held)
    n_params = sum(p.numel() for p in run["model"].parameters())
    print(f"    {n_params / 1e9:.3f}e9 parameters; peak memory {peak_alloc / 1e9:.2f} GB "
          f"allocated, {peak_reserved / 1e9:.2f} GB reserved: {free_at_peak / 1e9:.2f} GB of "
          f"the card free at peak")
    for i, (loss, gn, sec) in enumerate(zip(run["losses"], run["grad_norms"], run["step_s"])):
        print(f"    step {i}: loss {loss:.6f}, grad norm {gn:.6f}, {1e3 * sec:.3f} ms (host wall"
              f"{', both attempts' if i == 1 else ''})")
    print(f"    attempts {attempts}, retries {run['retries']}, stragglers {run['stragglers']}; "
          f"launches in the run {launches}; expected per attempt {per_attempt}")
    check(n_params == tcfg.param_count(), f"{n_params} parameters, param_count "
          f"{tcfg.param_count()}")
    check(attempts == [0, 1, 1, 2] and run["retries"] == 1,
          f"{OLMOE_ARCH}: attempts {attempts}, retries {run['retries']}")
    check(all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]),
          f"{OLMOE_ARCH}: non-finite loss or grad norm in training")
    for name, n in per_attempt.items():
        check(launches[name] == len(attempts) * n,
              f"{OLMOE_ARCH} training: {name} launched {launches[name]}, expected "
              f"{len(attempts)} x {n}")
    check(free_at_peak >= FREE_AT_PEAK,
          f"{OLMOE_ARCH} at {depth} layers left {free_at_peak / 1e9:.2f} GB free")
    faulted = dict(losses=run["losses"], grad_norms=run["grad_norms"])
    bwd_launches = launches["hbp_matmul_batched_bwd"]
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps, unfaulted
    clean = train(tcfg, steps=TRAIN_STEPS, data_cfg=data_cfg, device="cuda", log_every=0)
    gaps = [abs(a - b) / abs(b) for a, b in zip(faulted["losses"], clean["losses"])]
    print(f"    unfaulted run: losses {[round(x, 6) for x in clean['losses']]}, grad norms "
          f"{[round(x, 6) for x in clean['grad_norms']]}; relative loss gaps to the faulted "
          f"run {[f'{x:.2e}' for x in gaps]} (step 0 the same bits; then rtol "
          f"{MOE_STEP_RTOL:g})")
    check(faulted["losses"][0] == clean["losses"][0] and max(gaps) <= MOE_STEP_RTOL,
          f"{OLMOE_ARCH}: the retried run's losses {faulted['losses']} differ from the "
          f"unfaulted run's {clean['losses']}")
    wall_ms = 1e3 * sum(clean["step_s"][1:]) / max(len(clean["step_s"]) - 1, 1)

    # one step's device operations (torch.profiler), and the products it ran
    model, opt_state = clean["model"], clean["opt_state"]
    train_step = make_train_step(model)
    batch = {key: torch.from_numpy(x).to(dev)
             for key, x in SyntheticLMDataset(data_cfg, tcfg).batch_at(0).items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(opt_state, batch)
        torch.cuda.synchronize()
    events = prof.events()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    products = {}
    for e in events:
        if e.name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul"):
            products[e.name] = products.get(e.name, 0) + 1
    own = re.compile(r"\b(mm_\w+_kernel|splitk_reduce|flash_\w+_kernel)\b")
    dev_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    ours_ms = sum(e.time_range.elapsed_us() for e in on_device if own.search(e.name)) / 1e3
    if on_device:
        print(f"    one step on the device (torch.profiler): {len(on_device)} operations in "
              f"{dev_ms:.4f} ms, ours {ours_ms:.4f}; {wall_ms:.3f} ms of host wall (the "
              f"unfaulted run's steps 1-{TRAIN_STEPS - 1}): device busy "
              f"{100 * dev_ms / wall_ms:.1f}%")
    else:
        print("    one step on the device: the trace shows no device operation (not measured)")
    print(f"    PyTorch matrix products in the step: {products} (2-D: the routers' f32 "
          f"(N, d) @ (d, E), its recomputation and its two gradients, {4 * depth} in all)")
    check(not products.get("aten::bmm") and not products.get("aten::baddbmm"),
          f"{OLMOE_ARCH}: a 3-D product ran outside K2: {products}")
    check(not on_device or products.get("aten::mm", 0) == 4 * depth,
          f"{OLMOE_ARCH}: PyTorch products {products}; expected only the routers' {4 * depth}")

    # the batched backward alone: each layer's own experts (268 MB a product,
    # past the L2), dA = g Wᵀ and dB = Xᵀ g, beside its bound, its plain
    # version and torch.bmm over the same slabs
    bf = torch.bfloat16
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    for name, k_in, n_out, weight in (("gate", d, f, "e_gate"), ("up", d, f, "e_up"),
                                      ("down", f, d, "e_down")):
        sets = [(torch.randn(E, cap, k_in, device=dev, generator=g).to(bf),
                 getattr(lyr, weight).detach(),
                 torch.randn(E, cap, n_out, device=dev, generator=g).to(bf))
                for lyr in model.layers]
        t_k = time_ms(torch, lambda x, w, gy: (hbp_matmul(gy, w.mT), hbp_matmul(x.mT, gy)),
                      sets, reps=3)
        t_p = time_ms(torch, lambda x, w, gy: (matmul_ref(gy, w.mT), matmul_ref(x.mT, gy)),
                      sets, reps=1)
        t_l = time_ms(torch, lambda x, w, gy: (torch.bmm(gy, w.mT), torch.bmm(x.mT, gy)),
                      sets, reps=3)
        x, w, gy = sets[0]
        # dA reads g and W and writes dA; dB reads X and g and writes dB
        nbytes = 2 * (E * cap * n_out + E * k_in * n_out + E * cap * k_in) * 2
        ops = 2 * 2 * E * cap * k_in * n_out
        b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms),
                       ("bytes", nbytes), ("ops", ops)):
            tot[key] += depth * v
        print(f"    batched backward {name} (dA {mm_path(gy, w.mT)} {E}x{cap}x{n_out} @ "
              f"{E}x{n_out}x{k_in}, dB {mm_path(x.mT, gy)} {E}x{k_in}x{cap} @ "
              f"{E}x{cap}x{n_out}): {t_k:.4f} ms a layer (bound {b_ms:.4f} by {b_by}, "
              f"{100 * b_ms / t_k:.1f}% of it); plain {t_p:.4f}; torch.bmm {t_l:.4f}")
        del sets, x, w, gy
    print(f"    batched backward per step ({6 * depth} launches): {tot['ms']:.4f} ms against "
          f"its {tot['bound_ms']:.4f} ms bound ({100 * tot['bound_ms'] / tot['ms']:.1f}%); "
          f"plain {tot['plain_ms']:.4f}; torch.bmm {tot['library_ms']:.4f}; "
          f"{100 * tot['ms'] / dev_ms if on_device else float('nan'):.1f}% of the device "
          f"step ({smi})")
    tot["launches"] = bwd_launches
    del clean, model, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase_13b(torch, cfg, data_cfg, smi)
    return tot


def phase_13b(torch, cfg, data_cfg, smi):
    """The checkpoint round trip at full width and 1 layer (phase 13b)."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import reduced
    from repro_torch.launch.train import train

    one = reduced(cfg, n_layers=1)
    # params bf16 (2 bytes), master, m and v f32 (12): one checkpoint
    ckpt_bytes = 14 * one.param_count()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        room = shutil.disk_usage(tmp).free
        need = (CKPT_KEEP + 1) * ckpt_bytes
        print(f"[13b] {OLMOE_ARCH} checkpoint round trip at full width, 1 layer "
              f"({one.param_count() / 1e9:.4f}e9 parameters, {ckpt_bytes / 1e9:.2f} GB a "
              f"checkpoint); {tmp}: {room / 1e9:.2f} GB free, {need / 1e9:.2f} GB needed "
              f"({CKPT_KEEP} kept and one being written)")
        check(room >= need, f"phase 13b: {room / 1e9:.2f} GB free under {tmp}, "
              f"{need / 1e9:.2f} GB needed for the checkpoints")
        t0 = time.perf_counter()
        first = train(one, steps=2, data_cfg=data_cfg, device="cuda", log_every=0,
                      ckpt_dir=str(tmp), save_every=1, keep=CKPT_KEEP)
        t_first = time.perf_counter() - t0
        steps_on_disk = sorted(p.name for p in tmp.iterdir())
        like = {"params": dict(first["model"].named_parameters()),
                "opt_state": first["opt_state"]}
        t0 = time.perf_counter()
        step, restored = load_checkpoint(tmp, like)
        t_load = time.perf_counter() - t0
        same = {"params": all(torch.equal(restored["params"][n], p)
                              for n, p in like["params"].items()),
                "step": torch.equal(restored["opt_state"]["step"], first["opt_state"]["step"])}
        for key in ("master", "m", "v"):
            same[key] = all(torch.equal(restored["opt_state"][key][n], t)
                            for n, t in first["opt_state"][key].items())
        n_leaves = len(like["params"]) * 4 + 1
        print(f"    2 steps saving every step: losses {[round(x, 6) for x in first['losses']]} "
              f"in {t_first:.2f} s (three saves: steps 0, 1 and the final one); on disk "
              f"{steps_on_disk}; step {step} restored in {t_load:.2f} s ({n_leaves} tensors "
              f"from the JAX tree's leaves, checksums checked): equal bit for bit {same}")
        check(step == 1 and steps_on_disk == ["step_1"] and all(same.values()),
              f"phase 13b: restored step {step}, on disk {steps_on_disk}, equal {same}")
        del first, like, restored
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = train(one, steps=3, data_cfg=data_cfg, device="cuda", log_every=0,
                        ckpt_dir=str(tmp), keep=CKPT_KEEP)
        t_resumed = time.perf_counter() - t0
        resumed_losses, start = resumed["losses"], resumed["start"]
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        whole = train(one, steps=3, data_cfg=data_cfg, device="cuda", log_every=0)
        gap = abs(resumed_losses[0] - whole["losses"][2]) / abs(whole["losses"][2])
        print(f"    a fresh train() on the directory resumed at step {start} in "
              f"{t_resumed:.2f} s (restore, one step, the final save): step 2 loss "
              f"{resumed_losses[0]:.6f}; the uninterrupted run's {whole['losses'][2]:.6f} "
              f"(losses {[round(x, 6) for x in whole['losses']]}): relative gap {gap:.2e} "
              f"(rtol {MOE_STEP_RTOL:g}); on disk {sorted(p.name for p in tmp.iterdir())}")
        check(start == 2 and len(resumed_losses) == 1 and gap <= MOE_STEP_RTOL,
              f"phase 13b: resumed at {start}, losses {resumed_losses} against "
              f"{whole['losses']}")
        del whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_14(torch, np, dev, g, smi, counts, reset_counts, trace, counted, finite_logits,
             registry_kernels):
    """The recurrent-state families at full width and depth (phase 14):
    ``recurrentgemma-2b`` through the Engine (14a) and through the Server
    with the linear and the ring cache (14b), trained (14c), and
    ``mamba2-370m`` through the Engine and trained (14d); bf16, seeded
    weights drawn on the card.  Returns the kernels line's entries for K1
    over a hybrid decode step and K3 over a hybrid training step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import RunOptions
    from repro_torch.models.hybrid import rglru_scan

    bf, es = torch.bfloat16, 2
    zero = {k: 0 for k in registry_kernels}
    no_attn = {"flash_attention": 0, "flash_attention_int8": 0, "flash_attention_bwd": 0}
    lane = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
    n_chunks = REC_TRAIN_SEQ // min(512, REC_TRAIN_SEQ)  # RunOptions.ce_chunk 512
    # one request shape for both families: lengths first, tokens per vocab
    rng = np.random.default_rng(0)
    shape = [(int(rng.integers(REC_PROMPTS[0], REC_PROMPTS[1] + 1)), int(rng.integers(8, 49)))
             for _ in range(ENGINE_REQUESTS)]

    def workload(vocab):
        r = np.random.default_rng(1)
        return [(r.integers(3, vocab, n).astype(np.int32), m) for n, m in shape]

    # -- 14a: recurrentgemma-2b through the Engine -------------------------------
    cfg = get_config(REC_ARCH)
    L, d, h, kvh, hd, V, W = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim_, cfg.vocab_size, cfg.sliding_window)
    n_attn = L // len(cfg.block_pattern)
    n_rec = L - n_attn
    k2_step = 3 * n_rec + 7 * n_attn + 1  # rec MLPs; QKV, out, MLP; the logits
    print(f"[14] {REC_ARCH} at full width and depth, bf16 ({n_rec} rec and {n_attn} local "
          f"attention blocks, d={d}, LRU width {cfg.lru_width}, {h}/{kvh} heads, hd={hd}, "
          f"window {W}, d_ff={cfg.d_ff}, vocab={V}, tied; param_count "
          f"{cfg.param_count() / 1e9:.4f}e9) ({smi})")
    print(f"    memory held before the build: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=REC_LEN, chunk=REC_CHUNK)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    print(f"    weights built on the card from a CUDA generator in "
          f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.4f}e9 values, "
          f"{w_bytes / 1e9:.2f} GB (the analytic param_count counts each LRU gate as one "
          f"vector of the width, the model holds its block-diagonal matrices, as JAX's)")
    trace_engine(engine, counted, finite_logits)
    work = workload(V)
    lens = [len(p) for p, _ in work]
    print(f"    {ENGINE_REQUESTS} requests, {SLOTS} slots, {REC_LEN} positions, chunk "
          f"{REC_CHUNK}; prompts {lens} ({sum(n > W for n in lens)} past the window), "
          f"max_new {[m for _, m in work]}")
    want = {"hbp_matmul": k2_step, "hbp_matmul_batched": 0, **no_attn,
            "flash_attention": n_attn, **zero}
    launches, rec_dev_ms, rec_wall_ms = engine_run(
        torch, engine, work, REC_ARCH, "bf16", counts, reset_counts, trace, want, smi,
        profile=True)
    mid = trace["pos"][len(trace["pos"]) // 2].tolist()
    print(f"    {k2_step} K2 and {n_attn} K1 launches a decode step; device {rec_dev_ms:.4f} ms "
          f"a step, {rec_wall_ms:.3f} ms of host wall")
    out = {"launches_decode": launches["flash_attention"]}

    # -- 14b: the lockstep Server, linear and ring layouts -------------------------
    # one Server a layout, built through its constructor on the engine's
    # weights (RunOptions.windowed_decode_cache picks the layout); then the
    # same at f32 (the bf16 weights widened; K1 and K2 on their f32
    # instances): the layouts' own difference, and the bf16 noise floor
    params = engine.model.state_dict()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    prompts = ring_prompts(np, V)
    plen = max(map(len, prompts))
    toks = np.zeros((RING_BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p  # left-pad, as Server.run_batch
    tokens = torch.from_numpy(toks).to(dev)
    at = torch.tensor(plen, dtype=torch.int32, device=dev)
    nxt = None
    first = {}
    for dtype in ("bf16", "f32"):
        for layout, ring in (("linear", False), ("ring", True)):
            server = Server(cfg if dtype == "bf16" else dataclasses.replace(cfg, dtype="float32"),
                            device="cuda", params=params, max_batch=RING_BATCH,
                            max_len=REC_LEN, opts=RunOptions(windowed_decode_cache=ring))
            logits, cache = server.prefill(tokens)
            if nxt is None:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            with torch.no_grad():
                first[dtype, layout], cache = server.model.decode_step(nxt, at, cache)
            kv = cache["kv"]
            del logits, cache
            if dtype == "bf16":
                reqs = [Request(i, p, max_new=RING_NEW) for i, p in enumerate(prompts)]
                reset_counts()
                res = server.run_batch(reqs)
                got = counts()
                steps = res["decode_steps"]
                print(f"    lockstep Server, {layout} cache ({type(kv).__name__}, {kv.capacity} "
                      f"slots): {RING_BATCH} prompts of {[len(p) for p in prompts]} tokens, "
                      f"{RING_NEW} new: completed {res['completed']}; logits finite "
                      f"{res['logits_finite']}; decode {1e3 * res['decode_s'] / max(steps, 1):.3f} "
                      f"ms/step over {steps} steps (host wall); prefill "
                      f"{1e3 * res['prefill_s']:.3f} ms; launches {got}")
                check(all(len(q.out) == RING_NEW for q in reqs) and res["logits_finite"],
                      f"{REC_ARCH} lockstep {layout}: {res['completed']}, finite "
                      f"{res['logits_finite']}")
                check(got["hbp_matmul"] == k2_step * (1 + steps)
                      and got["flash_attention"] == n_attn * (1 + steps),
                      f"{REC_ARCH} lockstep {layout} launches {got} over a prefill and {steps} "
                      "steps")
                check((kv.capacity == W and min(map(len, prompts)) > W) if ring
                      else kv.capacity == REC_LEN,
                      f"{REC_ARCH} {layout}: a {kv.capacity}-slot cache for prompts of "
                      f"{[len(p) for p in prompts]}")
            del server, kv
            gc.collect()
            torch.cuda.empty_cache()
    del params
    dist = lambda a, b: (first[a] - first[b]).abs().max().item()  # noqa: E731
    d32 = dist(("f32", "ring"), ("f32", "linear"))
    d16 = dist(("bf16", "ring"), ("bf16", "linear"))
    noise = dist(("bf16", "linear"), ("f32", "linear"))
    same_top = (first["bf16", "ring"].argmax(-1) == first["bf16", "linear"].argmax(-1)).tolist()
    ring_ok = d32 <= RING_F32_ATOL and d16 <= 2 * noise and all(same_top)
    print(f"    first decode step's logits, ring vs linear: f32 max abs diff {d32:.4e} "
          f"(atol {RING_F32_ATOL:g}); bf16 {d16:.4e} against twice the bf16 linear "
          f"layout's distance from f32, 2 x {noise:.4e} (bf16 ring from f32 "
          f"{dist(('bf16', 'ring'), ('f32', 'linear')):.4e}; |logits| up to "
          f"{first['f32', 'linear'].abs().max().item():.3f}); the same bf16 greedy token in "
          f"rows {same_top} {'ok' if ring_ok else 'FAIL'}")
    check(ring_ok, f"{REC_ARCH}: ring and linear first-step logits differ by {d32:.4e} (f32), "
          f"{d16:.4e} (bf16, noise {noise:.4e}); same bf16 greedy token in rows {same_top}")
    del first

    # K1 per decode step: the 8 attention layers' own caches (4096 positions,
    # window 2048) at the engine run's halfway lanes
    kl = [min(p + 1, REC_LEN) for p in mid]
    t = time_attention_decode(torch, dev, g, SLOTS, REC_LEN, (h, kvh, hd), n_attn, causal=True,
                              window=W, lanes=(mid, kl))
    print(f"    flash_attention ({t['path']}) per decode step, {n_attn} calls of "
          f"{SLOTS}x1x{h}x{hd} over {REC_LEN} slots, window {W}, lanes kv_len {kl}: "
          f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} by {t['bound_by']}, "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of it; {t['bytes'] / 1e6:.3f} MB); plain "
          f"{t['plain_ms']:.4f}; scaled_dot_product_attention {t['library_ms']:.4f} (backend "
          f"{t['backend']} with the boolean mask); {100 * t['ms'] / rec_dev_ms:.1f}% of the "
          f"device step ({smi})")
    out["k1"] = dict(t, launches=launches["flash_attention"])

    # the RG-LRU recurrence per prefill chunk: a, b and h0 of the chunk's
    # 8 x 256 rows, 18 rec blocks
    w = cfg.lru_width

    def scan_sets(b, s, grad=False):
        n = copies_past_l2(3 * b * s * w * 4)
        out_sets = []
        for _ in range(n):
            a = 0.5 + 0.5 * torch.rand(b, s, w, device=dev, generator=g)
            x = torch.randn(b, s, w, device=dev, generator=g)
            out_sets.append((a.requires_grad_(grad), x.requires_grad_(grad)))
        return out_sets

    h0 = torch.randn(SLOTS, w, device=dev, generator=g)
    t_chunk = time_ms(torch, lambda a, x: rglru_scan(a, x, h0), scan_sets(SLOTS, REC_CHUNK))
    c_bytes = 3 * SLOTS * REC_CHUNK * w * 4
    c_bound, _ = bound_ms(c_bytes, 0, "float32")
    print(f"    RG-LRU recurrence (rglru_scan, plain PyTorch: the associative scan's "
          f"{math.ceil(math.log2(REC_CHUNK))} levels) per prefill chunk ({SLOTS}x{REC_CHUNK}x{w} "
          f"f32): {t_chunk:.4f} ms a call, {n_rec * t_chunk:.4f} ms a chunk ({n_rec} calls) "
          f"against a bytes bound of {c_bound:.4f} a call ({n_rec * c_bound:.4f} a chunk; "
          f"reads a and b, writes h: {c_bytes / 1e6:.2f} MB) ({smi})")
    out["scan_chunk"] = dict(ms=n_rec * t_chunk, bound_ms=n_rec * c_bound)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14c: recurrentgemma-2b trained ----------------------------------------------
    per_step = {"hbp_matmul": 4 * (k2_step - 1) + 4 * n_chunks, "hbp_matmul_batched": 0,
                **no_attn, "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
                **zero}
    train_launches, train_ms = train_and_time(torch, dev, smi, cfg, REC_TRAIN_BATCH,
                                              REC_TRAIN_SEQ, per_step, REC_ARCH, counts,
                                              reset_counts)
    # K3 per training step: the 8 attention layers at 2 x 1024, window 2048
    # (past the sequence: causal), against SDPA's causal backward
    B, S = REC_TRAIN_BATCH, REC_TRAIN_SEQ
    t = time_attention_bwd(torch, dev, g, B, S, S, (h, kvh, hd), True, window=W)
    print(f"    flash_attention_bwd ({t['path']}) per training step, {n_attn} calls "
          f"of {B}x{S}x{h}x{hd}, window {W}: {n_attn * t['ms']:.4f} ms (bound "
          f"{n_attn * t['bound_ms']:.4f} by {t['bound_by']}, "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of it); plain {n_attn * t['plain_ms']:.4f}; "
          f"autograd backward of scaled_dot_product_attention {n_attn * t['library_ms']:.4f} "
          f"(backend {t['backend']}, is_causal); {100 * n_attn * t['ms'] / train_ms:.1f}% of "
          f"the {train_ms:.4f} ms device step ({smi})")
    out["k3"] = add_calls(dict(launches=train_launches["flash_attention_bwd"]), t, n_attn)
    # the RG-LRU recurrence per training step: each rec block's scan runs
    # forward twice (remat) and backward once
    t_fwd = time_ms(torch, rglru_scan, scan_sets(B, S))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    bwd_sets = []
    with torch.cuda.stream(side):
        for a, x in scan_sets(B, S, grad=True):
            hs = rglru_scan(a, x)
            bwd_sets.append((hs, (a, x), torch.randn_like(hs)))
    torch.cuda.current_stream().wait_stream(side)
    t_bwd = time_ms(torch, lambda hs, leaves, go: torch.autograd.grad(
        hs, leaves, go, retain_graph=True), bwd_sets, stream=side)
    del bwd_sets
    t_bytes = B * S * w * 4
    f_bound, _ = bound_ms(3 * t_bytes, 0, "float32")
    bw_bound, _ = bound_ms(5 * t_bytes, 0, "float32")
    step_ms = n_rec * (2 * t_fwd + t_bwd)
    step_bound = n_rec * (2 * f_bound + bw_bound)
    print(f"    RG-LRU recurrence per training step ({B}x{S}x{w} f32, {n_rec} rec blocks, "
          f"forward twice under remat and backward once): forward {t_fwd:.4f} ms a call "
          f"(bound {f_bound:.4f}: reads a and b, writes h), backward {t_bwd:.4f} (bound "
          f"{bw_bound:.4f}: reads dh, a and h, writes da and db); {step_ms:.4f} ms a step "
          f"against {step_bound:.4f}, {100 * step_ms / train_ms:.1f}% of the device step ({smi})")
    out["scan_train"] = dict(ms=step_ms, bound_ms=step_bound)
    out["rec"] = dict(dev_ms=rec_dev_ms, wall_ms=rec_wall_ms, train_ms=train_ms)

    # -- 14d: mamba2-370m through the Engine, then trained ------------------------------
    cfg = get_config(SSM_ARCH)
    print(f"[14] {SSM_ARCH} at full width and depth, bf16 ({cfg.n_layers} layers, d="
          f"{cfg.d_model}, inner {cfg.ssm_d_inner}, {cfg.ssm_n_heads} heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, SSD chunk {cfg.ssm_chunk}, vocab "
          f"{cfg.vocab_size}, tied; param_count {cfg.param_count() / 1e9:.4f}e9) ({smi})")
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=REC_LEN, chunk=cfg.ssm_chunk)
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"    weights built on the card: {n_params / 1e9:.4f}e9 values; state per slot "
          f"{sum(t[:, 0].numel() * t.element_size() for t in engine.cache.states.values()) / 1e6:.2f} MB")
    trace_engine(engine, counted, finite_logits)
    want = {"hbp_matmul": 1, "hbp_matmul_batched": 0, **no_attn, **zero}
    _, ssm_dev_ms, ssm_wall_ms = engine_run(
        torch, engine, workload(cfg.vocab_size), SSM_ARCH, "bf16", counts, reset_counts, trace,
        want, smi, profile=True)
    print(f"    1 K2 launch and no attention a decode step; device {ssm_dev_ms:.4f} ms a step, "
          f"{ssm_wall_ms:.3f} ms of host wall")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {"hbp_matmul": 4 * n_chunks, "hbp_matmul_batched": 0, **no_attn, **zero}
    _, ssm_train_ms = train_and_time(torch, dev, smi, cfg, SSM_TRAIN_BATCH, REC_TRAIN_SEQ,
                                     per_step, SSM_ARCH, counts, reset_counts)
    out["ssm"] = dict(dev_ms=ssm_dev_ms, wall_ms=ssm_wall_ms, train_ms=ssm_train_ms)
    print(f"[14] summary ({smi}): {REC_ARCH} decode step {rec_dev_ms:.4f} ms device / "
          f"{rec_wall_ms:.3f} ms wall, training step {train_ms:.4f} ms device; {SSM_ARCH} "
          f"decode step {ssm_dev_ms:.4f} / {ssm_wall_ms:.3f}, training step "
          f"{ssm_train_ms:.4f} ms device")
    return out


def aten_ops(torch, fn):
    """The names of the operators one call of ``fn`` dispatched, from a
    ``torch.profiler`` trace of the host side."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def spec_rows(cfg, key, seq_len):
    """Rows of one request's modality input ``key`` at ``seq_len``
    positions, from the model's own ``batch_extras_specs`` (built on the
    meta device: no memory)."""
    from repro_torch.models import build_model

    return build_model(cfg, device="meta").batch_extras_specs(1, seq_len)[key].shape[1]


def cross_kernel_checks(torch, dev, g, compare, failures):
    """Phase 2's cases for phase 15, at the shapes phase 15 runs, bf16 and
    f32.  K1 non-causal with no lanes: ``llama-3.2-vision-90b``'s 64/8
    heads at hd 128 over its 1601 image tokens (decode, a 64-row chunk, the
    engine's 8 x 256 first chunk, the Server's prefill of 4 x 512);
    ``seamless-m4t-large-v2``'s 16/16 heads at hd 64 over 512 encoder
    frames (decode, the engine's 8 x 256 chunk, the encoder's 8 x 512 x
    512 self-attention) and 17 keys, below one tile.  K3 non-causal (the
    encoder-decoder's training: 1024 queries over 256 frames and the
    encoder's 256 x 256; 1601 keys at hd 128; 65 keys, one into a tile).
    K2 at the 256,206-column head: the logits through the transposed
    ``lm_head`` view at 8, 512 and 2048 rows (``stream``, ``wgmma``), and
    the backward products ``dA = g W`` and ``dB = hᵀ g`` of a 512-row chunk
    and of the training step's 4 x 512-row chunk, whose gradient's row
    pitch TMA cannot describe (``wmma``).  The gradient is drawn N(0,
    1/64): the products' entries are ~1.3 (``dA``, sums of 256,206 terms)
    and ~3-6 (``dB``), so each tolerance's atol is under 1% of a typical
    entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (bwd_path, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref, fwd_path)
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path

    scfg, vcfg = get_config(SEAMLESS_ARCH), get_config(VLM_ARCH)
    s_heads = (scfg.n_heads, scfg.n_kv_heads, scfg.head_dim_)
    v_heads = (vcfg.n_heads, vcfg.n_kv_heads, vcfg.head_dim_)
    enc, n_img = spec_rows(scfg, "audio_frames", X_LEN), spec_rows(vcfg, "image_embeds", X_LEN)
    enc_train = spec_rows(scfg, "audio_frames", X_TRAIN_SEQ)
    ce_rows = X_TRAIN_BATCH * min(512, X_TRAIN_SEQ)  # a training logits chunk (ce_chunk 512)
    prefill = X_SERVER_PROMPTS[1]
    print(f"[2] cross-attention and the ragged head ({VLM_ARCH}: {n_img} image keys, heads "
          f"{v_heads}; {SEAMLESS_ARCH}: {enc} frames, heads {s_heads}, vocab "
          f"{scfg.vocab_size})")
    vlm, sml = "flash_attention_cross_vlm", "flash_attention_cross_seamless"
    fwd = [  # (entry, label, b, sq, sk, (h, kvh, hd))
        (vlm, f"decode {SLOTS}x1 vs {n_img}", SLOTS, 1, n_img, v_heads),
        (vlm, f"chunk {SLOTS}x64 vs {n_img}", SLOTS, 64, n_img, v_heads),
        (vlm, f"first chunk {SLOTS}x{X_CHUNK} vs {n_img}", SLOTS, X_CHUNK, n_img, v_heads),
        (vlm, f"prefill {X_SERVER_BATCH}x{prefill} vs {n_img}", X_SERVER_BATCH, prefill, n_img,
         v_heads),
        (sml, f"decode {SLOTS}x1 vs {enc}", SLOTS, 1, enc, s_heads),
        (sml, f"chunk {SLOTS}x{X_CHUNK} vs {enc}", SLOTS, X_CHUNK, enc, s_heads),
        (sml, f"encoder {SLOTS}x{enc} vs {enc}", SLOTS, enc, enc, s_heads),
        (sml, "chunk 2x33 vs 17", 2, 33, 17, s_heads),
    ]
    bwd = [  # (label, b, sq, sk, (h, kvh, hd))
        (f"cross {X_TRAIN_BATCH}x{X_TRAIN_SEQ} vs {enc_train} (training)", X_TRAIN_BATCH,
         X_TRAIN_SEQ, enc_train, s_heads),
        (f"encoder {X_TRAIN_BATCH}x{enc_train} (training)", X_TRAIN_BATCH, enc_train, enc_train,
         s_heads),
        (f"cross 1x64 vs {n_img}", 1, 64, n_img, v_heads),
        ("cross 2x100 vs 65", 2, 100, 65, s_heads),
    ]
    V, d = scfg.vocab_size, scfg.d_model
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        f32 = dtype == "float32"
        for entry, label, b, sq, sk, (h, kvh, hd) in fwd:
            q = torch.randn(b, sq, h, hd, device=dev, generator=g).to(dt)
            k, v = (torch.randn(b, sk, kvh, hd, device=dev, generator=g).to(dt) for _ in "kv")
            out, lse = flash_attention(q, k, v, causal=False)
            r_out, r_lse = flash_attention_ref(q, k, v, causal=False)
            tag = f"{dtype} {fwd_path(q)} non-causal {label}, hd {hd}"
            compare(entry, f"{tag} out", out, r_out, dtype, *((1e-5, 0.0) if f32 else (None, None)))
            compare(entry, f"{tag} lse", lse, r_lse, dtype, 1e-4, 1e-5)
            del q, k, v, out, lse, r_out, r_lse
        for label, b, sq, sk, (h, kvh, hd) in bwd:
            q, go = (torch.randn(b, sq, h, hd, device=dev, generator=g).to(dt) for _ in "qg")
            k, v = (torch.randn(b, sk, kvh, hd, device=dev, generator=g).to(dt) for _ in "kv")
            out, lse = flash_attention(q, k, v, causal=False)
            got = flash_attention_bwd(q, k, v, out, lse, go, causal=False)
            want = flash_attention_bwd_ref(q, k, v, out, lse, go, causal=False)
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                compare("flash_attention_bwd_cross",
                        f"{dtype} {bwd_path(q)} non-causal {label}, hd {hd} {name}", x, w, dtype)
            del q, go, k, v, out, lse, got, want
        head = (0.02 * torch.randn(V, d, device=dev, generator=g)).to(dt)
        for rows in (SLOTS, 512, ce_rows):
            x = torch.randn(rows, d, device=dev, generator=g).to(dt)
            compare("hbp_matmul", f"{dtype} logits ({rows}x{d} @ ({V}x{d})^T view) "
                    f"{mm_path(x, head.T)}", hbp_matmul(x, head.T), matmul_ref(x, head.T), dtype)
            if rows == SLOTS:
                continue
            gr = (torch.randn(rows, V, device=dev, generator=g) / 8).to(dt)
            for label, a, b_ in (("dA = g W", gr, head), ("dB = hᵀ g", x.T, gr)):
                inst = mm_path(a, b_)
                if inst != ("fma" if f32 else "wmma"):
                    failures.append(f"hbp_matmul {dtype} {label}: instance {inst}")
                compare("hbp_matmul_wmma", f"{dtype} head {label} ({tuple(a.shape)} @ "
                        f"{tuple(b_.shape)}) {inst}", hbp_matmul(a, b_), matmul_ref(a, b_), dtype)
            del gr
        del head, x
    torch.cuda.empty_cache()


def phase_15(torch, np, dev, g, smi, counts, reset_counts, trace, counted, finite_logits,
             registry_kernels):
    """The cross-attention families (phase 15), bf16, seeded weights drawn
    on the card after phase 14 freed its memory: ``seamless-m4t-large-v2``
    at full width and depth through the Engine (15a) and the Server (15b),
    trained (15c); ``llama-3.2-vision-90b`` at full width and 10 of its 100
    layers, its gates drawn non-zero, through the Engine (15d) and the
    Server (15e).

    Launches a decode step, by construction.  ``seamless-m4t-large-v2``:
    each of the 24 decoder layers projects q, k, v and o of its
    self-attention, q and o of its cross-attention (the cross k/v are the
    request's frozen cache) and three MLP products, and the head one
    product: 9 x 24 + 1 = 217 K2; it attends its self cache and the frames'
    k/v: 2 x 24 = 48 K1.  ``llama-3.2-vision-90b`` at 10 layers (2
    superblocks of 4 self layers and 1 cross layer): a self layer 7 K2 (q,
    k, v, o, three MLP), a cross layer 5 (q, o, three MLP; the image k/v
    are cached), the head 1: 7 x 8 + 5 x 2 + 1 = 67 K2, and 8 + 2 = 10 K1.
    A training step of ``seamless-m4t-large-v2`` (remat: each forward twice,
    then both backward products): 4 K2 for each of the 24 x 7 encoder and
    24 x 11 decoder products (the cross k/v of the encoder output are
    projected in each layer) and for each of the 2 logits chunks (the
    cross-entropy's 512 positions); 2 of those 4 for a chunk, ``dA`` and
    ``dB`` of the 256,206-column head, run K2's ``wmma`` instance; K1 twice
    and K3 once for each of 24 encoder, 24 decoder self and 24 cross
    attentions.  Returns the kernels line's entries."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request, Server

    bf, es = torch.bfloat16, 2
    zero = {k: 0 for k in registry_kernels}
    no_attn = {"flash_attention": 0, "flash_attention_int8": 0, "flash_attention_bwd": 0}
    out = {}
    rng = np.random.default_rng(0)
    shape = [(int(rng.integers(X_PROMPTS[0], X_PROMPTS[1] + 1)), int(rng.integers(8, 49)))
             for _ in range(ENGINE_REQUESTS)]

    def workload(cfg, key, rows):
        """The engine's requests, each with its own seeded modality rows."""
        r = np.random.default_rng(1)
        return [(r.integers(3, cfg.vocab_size, n).astype(np.int32), m,
                 {key: r.standard_normal((rows, cfg.d_model), dtype=np.float32)})
                for n, m in shape]

    def server_prompts(vocab):
        r = np.random.default_rng(2)
        return [r.integers(3, vocab, int(n)).astype(np.int32)
                for n in r.integers(X_SERVER_PROMPTS[0], X_SERVER_PROMPTS[1] + 1,
                                    X_SERVER_BATCH)]

    def floor(model, skip):
        """The bytes of the weights a decode step reads (no encoder, no
        embedding table past its rows, no cached k/v projection) and of all
        of them."""
        params = dict(model.named_parameters())
        total = sum(p.numel() * p.element_size() for p in params.values())
        read = sum(p.numel() * p.element_size() for n, p in params.items()
                   if not (n.startswith(skip)
                           or re.search(r"cross_(attn|layers\.\d+)\.w[kv]$", n)))
        return read, total

    def server_run(cfg, params, k2_first, k1_first, k2_step, k1_step):
        """``Server.run_batch`` on the engine's weights: completion, finite
        logits, the launches of a prefill (``k2_first``/``k1_first``) and of
        each decode step."""
        server = Server(cfg, device="cuda", params=params, max_batch=X_SERVER_BATCH,
                        max_len=X_LEN)
        prompts = server_prompts(cfg.vocab_size)
        reqs = [Request(i, p, max_new=X_SERVER_NEW) for i, p in enumerate(prompts)]
        reset_counts()
        res = server.run_batch(reqs)
        got = counts()
        steps = res["decode_steps"]
        print(f"    lockstep Server: {X_SERVER_BATCH} prompts of {[len(p) for p in prompts]} "
              f"tokens with the extras it draws, {X_SERVER_NEW} new: completed "
              f"{res['completed']}; logits finite {res['logits_finite']}; decode "
              f"{1e3 * res['decode_s'] / max(steps, 1):.3f} ms/step over {steps} steps (host "
              f"wall); prefill {1e3 * res['prefill_s']:.3f} ms; launches {got}")
        check(all(len(q.out) == X_SERVER_NEW for q in reqs) and res["logits_finite"],
              f"{cfg.name} lockstep: {res['completed']}, finite {res['logits_finite']}")
        check(got["hbp_matmul"] == k2_first + k2_step * steps
              and got["flash_attention"] == k1_first + k1_step * steps
              and got["hbp_matmul_batched"] == 0 and got["flash_attention_int8"] == 0,
              f"{cfg.name} lockstep launches {got} over a prefill and {steps} steps")
        del server
        gc.collect()
        torch.cuda.empty_cache()

    def k1_cross(label, b, sk, heads, calls, launches, dev_ms):
        """K1 over one decode step's ``calls`` cross-attentions (``b`` rows of
        one query over ``sk`` keys, non-causal, no lanes)."""
        h, _, hd = heads
        t = time_attention_decode(torch, dev, g, b, sk, heads, calls)
        print(f"    flash_attention ({t['path']}) cross-attention per decode step, {calls} calls "
              f"of {b}x1x{h}x{hd} over {sk} keys (non-causal, no lanes): {t['ms']:.4f} ms "
              f"(bound {t['bound_ms']:.4f} by {t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it; {t['bytes'] / 1e6:.3f} MB); plain "
              f"{t['plain_ms']:.4f}; scaled_dot_product_attention {t['library_ms']:.4f} "
              f"(backend {t['backend']}, no mask); {100 * t['ms'] / dev_ms:.1f}% of the device "
              f"step ({label}; {smi})")
        return dict(t, launches=launches)

    # -- 15a: seamless-m4t-large-v2 through the Engine ------------------------------
    cfg = get_config(SEAMLESS_ARCH)
    L, E, d, V = cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.vocab_size
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    k2_step, k1_step = 9 * L + 1, 2 * L
    print(f"[15] {SEAMLESS_ARCH} at full width and depth, bf16 ({E} encoder and {L} decoder "
          f"layers, d={d}, heads {heads[0]}/{heads[1]} at hd {heads[2]}, d_ff={cfg.d_ff}, "
          f"untied vocab {V}; param_count {cfg.param_count() / 1e9:.4f}e9) ({smi})")
    print(f"    memory held before the build: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=X_LEN, chunk=X_CHUNK)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    read, total = floor(engine.model, ("encoder.", "enc_norm", "embed"))
    s_floor = 1e3 * read / HBM_BYTES_PER_S
    enc = engine.model.enc_len(X_LEN)
    print(f"    weights built on the card from a CUDA generator in "
          f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.4f}e9 values, {total / 1e9:.2f} "
          f"GB; a decode step reads {read / 1e9:.3f} GB of them (the decoder without its "
          f"cached cross k/v projections, and the head): weight floor {s_floor:.4f} ms")
    trace_engine(engine, counted, finite_logits)
    work = workload(cfg, "audio_frames", enc)
    print(f"    {ENGINE_REQUESTS} requests, {SLOTS} slots, {X_LEN} positions ({enc} frames a "
          f"row), chunk {X_CHUNK}; prompts {[len(p) for p, *_ in work]}, max_new "
          f"{[m for _, m, _ in work]}, each with its own seeded audio_frames")
    want = {"hbp_matmul": k2_step, "hbp_matmul_batched": 0, **no_attn,
            "flash_attention": k1_step, **zero}
    launches, s_dev_ms, s_wall_ms = engine_run(
        torch, engine, work, SEAMLESS_ARCH, "bf16", counts, reset_counts, trace, want, smi,
        profile=True)
    mid_pos = trace["pos"][len(trace["pos"]) // 2]
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    frames = torch.randn(SLOTS, enc, d, device=dev, generator=g)
    chunk_lens = torch.full((SLOTS,), X_CHUNK, dtype=torch.int32, device=dev)
    seen = (aten_ops(torch, lambda: engine.model.decode_step(tok, mid_pos, engine.cache))
            | aten_ops(torch, lambda: engine.model.prefill_chunk(
                tok.expand(SLOTS, X_CHUNK).contiguous(), torch.zeros_like(chunk_lens),
                engine.cache, first=True, lens=chunk_lens, extras={"audio_frames": frames})))
    bad = sorted(seen & set(LIBRARY_OPS))
    print(f"    library products or attention in a decode step and a first chunk (encoder "
          f"included): {bad or 'none'} (of {list(LIBRARY_OPS)})")
    check(not bad, f"{SEAMLESS_ARCH}: the path dispatched {bad}")
    print(f"    {k2_step} K2 and {k1_step} K1 launches a decode step; device {s_dev_ms:.4f} ms a "
          f"step against its weight floor {s_floor:.4f} ms; host wall {s_wall_ms:.3f} ms")
    out["k1_seamless"] = k1_cross(SEAMLESS_ARCH, SLOTS, enc, heads, L,
                                  launches["flash_attention"], s_dev_ms)
    params = engine.model.state_dict()
    del engine, frames
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15b: the lockstep Server on the engine's weights ----------------------------
    server_run(cfg, params, 7 * E + 2 * L + k2_step, E + k1_step, k2_step, k1_step)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15c: seamless-m4t-large-v2 trained ----------------------------------------------
    n_chunks = X_TRAIN_SEQ // min(512, X_TRAIN_SEQ)  # RunOptions.ce_chunk 512
    n_attn = E + 2 * L
    per_step = {"hbp_matmul": 4 * (7 * E + 11 * L) + 4 * n_chunks,
                "hbp_matmul_wmma": 2 * n_chunks, "hbp_matmul_batched": 0, **no_attn,
                "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn, **zero}
    train_launches, s_train_ms = train_and_time(torch, dev, smi, cfg, X_TRAIN_BATCH,
                                                X_TRAIN_SEQ, per_step, SEAMLESS_ARCH, counts,
                                                reset_counts)
    # K3 per training step: the encoder's self-attention (256 frames), the
    # decoder's causal self-attention and its cross-attention over the frames
    B, S = X_TRAIN_BATCH, X_TRAIN_SEQ
    F_ = spec_rows(cfg, "audio_frames", S)
    tot = dict(launches=train_launches["flash_attention_bwd"])
    parts = []
    for label, sq, sk, causal, calls in (("encoder", F_, F_, False, E),
                                         ("decoder self", S, S, True, L),
                                         ("cross", S, F_, False, L)):
        t = time_attention_bwd(torch, dev, g, B, sq, sk, heads, causal)
        add_calls(tot, t, calls)
        parts.append(f"{label} {calls} x {B}x{sq} over {sk} "
                     f"({'causal' if causal else 'non-causal'}) {calls * t['ms']:.4f} / plain "
                     f"{calls * t['plain_ms']:.4f} / library {calls * t['library_ms']:.4f} "
                     f"(bound {calls * t['bound_ms']:.4f} by {t['bound_by']})")
    print(f"    flash_attention_bwd ({t['path']}) per training step, {n_attn} calls: "
          f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f}, "
          f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it); plain {tot['plain_ms']:.4f}; "
          f"autograd backward of scaled_dot_product_attention {tot['library_ms']:.4f}; "
          f"{'; '.join(parts)} ms; {100 * tot['ms'] / s_train_ms:.1f}% of the "
          f"{s_train_ms:.4f} ms device step ({smi})")
    out["k3"] = tot
    # K2's wmma instance per training step: dA = g W and dB = hᵀ g of each
    # logits chunk (B x 512 rows), the gradient's row pitch 512,412 bytes
    rows = B * min(512, S)
    head = (0.02 * torch.randn(V, d, device=dev, generator=g)).to(bf)
    g_bytes = rows * V * es
    mm_sets = [((torch.randn(rows, V, device=dev, generator=g) / rows).to(bf),
                torch.randn(rows, d, device=dev, generator=g).to(bf))
               for _ in range(copies_past_l2(g_bytes))]
    da = [(gr, head) for gr, _ in mm_sets]
    db = [(x.T, gr) for gr, x in mm_sets]
    insts = {mm_path(*da[0]), mm_path(*db[0])}
    check(insts == {"wmma"}, f"{SEAMLESS_ARCH} head backward ran {insts}, not wmma")
    t_k = n_chunks * (time_ms(torch, hbp_matmul, da) + time_ms(torch, hbp_matmul, db))
    t_p = n_chunks * (time_ms(torch, matmul_ref, da) + time_ms(torch, matmul_ref, db))
    t_l = n_chunks * (time_ms(torch, torch.matmul, da) + time_ms(torch, torch.matmul, db))
    nbytes = n_chunks * ((g_bytes + V * d * es + rows * d * es)
                         + (rows * d * es + g_bytes + d * V * es))
    ops = n_chunks * 2 * (2 * rows * d * V)
    b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
    print(f"    hbp_matmul (wmma) per training step, the head's dA = g W ({rows}x{V} @ {V}x{d}) "
          f"and dB = hᵀ g ({d}x{rows} @ {rows}x{V}) of {n_chunks} chunks: {t_k:.4f} ms (bound "
          f"{b_ms:.4f} by {b_by}, {100 * b_ms / t_k:.1f}% of it); plain {t_p:.4f}; torch.matmul "
          f"{t_l:.4f}; {100 * t_k / s_train_ms:.1f}% of the device step ({smi})")
    out["wmma"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bytes=nbytes,
                       ops=ops, launches=train_launches["hbp_matmul_wmma"])
    del head, mm_sets, da, db
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15d: llama-3.2-vision-90b at 10 layers through the Engine --------------------
    full = get_config(VLM_ARCH)
    cfg = reduced(full, n_layers=VLM_LAYERS)
    n_sb, n_self = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    n_img = cfg.n_image_tokens
    k2_step, k1_step = 7 * n_sb * n_self + 5 * n_sb + 1, n_sb * (n_self + 1)
    print(f"[15] {VLM_ARCH} at full width, {cfg.n_layers} of its {full.n_layers} layers "
          f"({n_sb} superblocks of {n_self} self and 1 gated cross layer), bf16 "
          f"(d={cfg.d_model}, heads {heads[0]}/{heads[1]} at hd {heads[2]}, d_ff={cfg.d_ff}, "
          f"{n_img} image tokens, untied vocab {cfg.vocab_size}) ({smi})")
    print(f"    memory held before the build: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=X_LEN, chunk=X_CHUNK)
    model = engine.model
    with torch.no_grad():  # the gates start at zero: the image would change nothing
        for layer in model.cross_layers:
            layer.xgate_attn.normal_(generator=g)
            layer.xgate_ffn.normal_(generator=g)
    torch.cuda.synchronize()
    gates = [(round(c.xgate_attn.item(), 4), round(c.xgate_ffn.item(), 4))
             for c in model.cross_layers]
    n_params = sum(p.numel() for p in model.parameters())
    per_sb = sum(p.numel() for p in (*model.self_layers[0].parameters(),
                                     *model.cross_layers[0].parameters()))
    full_values = n_params + (full.n_layers // full.cross_attn_every - n_sb) * per_sb
    read, total = floor(model, ("embed",))
    v_floor = 1e3 * read / HBM_BYTES_PER_S
    print(f"    weights built on the card from a CUDA generator in "
          f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.4f}e9 values, {total / 1e9:.2f} "
          f"GB ({1e3 * total / HBM_BYTES_PER_S:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"{full_values / 1e9:.4f}e9 values, {2 * full_values / 1e9:.1f} GB, at full depth, "
          f"more than one card holds); a "
          f"decode step reads {read / 1e9:.3f} GB of them (no embedding table, no cached "
          f"image k/v projection): weight floor {v_floor:.4f} ms; gates (attn, ffn) drawn "
          f"N(0, 1): {gates}")
    check(all(a != 0 and f != 0 for a, f in gates), f"{VLM_ARCH}: a gate is zero: {gates}")
    trace_engine(engine, counted, finite_logits)
    work = workload(cfg, "image_embeds", n_img)
    want = {"hbp_matmul": k2_step, "hbp_matmul_batched": 0, **no_attn,
            "flash_attention": k1_step, **zero}
    launches, v_dev_ms, v_wall_ms = engine_run(
        torch, engine, work, VLM_ARCH, "bf16", counts, reset_counts, trace, want, smi,
        profile=True)
    print(f"    {k2_step} K2 and {k1_step} K1 launches a decode step; device {v_dev_ms:.4f} ms a "
          f"step against its weight floor {v_floor:.4f} ms; host wall {v_wall_ms:.3f} ms")
    # one request's image redrawn: its first decode logits move, no other
    # row's do (each row's products and attention read its own rows only)
    r = 3
    toks = torch.randint(3, cfg.vocab_size, (SLOTS, 32), device=dev, generator=g,
                         dtype=torch.int32)
    img = torch.randn(SLOTS, n_img, cfg.d_model, device=dev, generator=g).to(bf)
    moved = img.clone()
    moved[r] = torch.randn(n_img, cfg.d_model, device=dev, generator=g).to(bf)
    first = []
    for im in (img, moved):
        logits, cache = model.prefill({"tokens": toks, "image_embeds": im}, 64)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        dec, _ = model.decode_step(nxt, torch.tensor(32, dtype=torch.int32, device=dev), cache)
        first.append(dec)
        del logits, cache
    moved_by = (first[1] - first[0]).abs().amax(dim=-1).tolist()
    same = [i for i in range(SLOTS) if i != r and moved_by[i] == 0]
    print(f"    row {r}'s image redrawn: first decode logits moved by (max abs, per row) "
          f"{[round(x, 4) for x in moved_by]}: row {r} moved, {len(same)} of {SLOTS - 1} other "
          "rows the same bits")
    check(moved_by[r] > 1e-3 and len(same) == SLOTS - 1,
          f"{VLM_ARCH}: redrawing row {r}'s image moved the rows by {moved_by}")
    out["k1_vlm"] = k1_cross(VLM_ARCH, SLOTS, n_img, heads, n_sb, launches["flash_attention"],
                             v_dev_ms)
    params = model.state_dict()
    del engine, model, img, moved, first, toks
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15e: the lockstep Server on the engine's weights ----------------------------
    server_run(cfg, params, 2 * n_sb + k2_step, k1_step, k2_step, k1_step)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[15] summary ({smi}): {SEAMLESS_ARCH} decode step {s_dev_ms:.4f} ms device (weight "
          f"floor {s_floor:.4f}) / {s_wall_ms:.3f} ms wall, training step {s_train_ms:.4f} ms "
          f"device; {VLM_ARCH} ({VLM_LAYERS} layers) decode step {v_dev_ms:.4f} ms device "
          f"(weight floor {v_floor:.4f}) / {v_wall_ms:.3f} ms wall")
    return out


def fused_qkv_checks(torch, dev, g, compare):
    """Phase 2's cases for phase 16: K2 at the fused QKV width of
    ``qwen3-1.7b`` (d x (q + 2 kv) = 2048 x 4096, ``RunOptions(fused_qkv=True)``)
    at the engine's decode rows and a 512-row chunk (``SLOTS`` x ``CHUNK``),
    bf16 and f32, against its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path

    cfg = get_config(ARCH)
    d, n = cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim
    print(f"[2] K2 at the fused QKV width ({d}x{n}) vs its plain version")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        w = (torch.randn(d, n, device=dev, generator=g) / math.sqrt(d)).to(dt)
        for T in (SLOTS, SLOTS * CHUNK):
            x = torch.randn(T, d, device=dev, generator=g).to(dt)
            compare("hbp_matmul", f"{dtype} fused wqkv ({T}x{d} @ {d}x{n}) {mm_path(x, w)}",
                    hbp_matmul(x, w), matmul_ref(x, w), dtype)


def engine_workload(np, vocab):
    """Phase 8's requests (and phase 16's): prompts of 16-192 tokens, 8-48 new."""
    erng = np.random.default_rng(0)
    return [(erng.integers(3, vocab, int(erng.integers(16, 193))).astype(np.int32),
             int(erng.integers(8, 49))) for _ in range(ENGINE_REQUESTS)]


def first_divergence(a, b):
    """The first index where token lists ``a`` and ``b`` differ (None: equal)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_16(torch, np, dev, smi, counts, reset_counts, trace, counted, finite_logits,
             registry_kernels, cfg=None):
    """The fleet (phase 16): ``qwen3-1.7b`` at full width and depth, bf16,
    seeded weights drawn on the card, behind the ``Router``: 2 replicas of
    ``FLEET_SLOTS`` slots (``ENGINE_LEN`` positions, chunk ``CHUNK``,
    ``snapshot_every`` ``FLEET_SNAPSHOT``) serve phase 8's 16 requests (a)
    by ``pws``, (b) by ``rws`` seed 5, (d) by ``pws`` with the rebalance
    threshold ``FLEET_REBALANCE`` (queue depth 0), which drains decoding
    slots to the other replica, and (e) with a replica joined after
    ``FLEET_JOIN_AT`` rounds and replica 0 removed ``FLEET_LEAVE_AT``
    rounds later, all on one fleet; (c) a second fleet under
    ``FLEET_DEATH``: replica 1 dies and a replacement restarts from the
    full-width checkpoint.  The reference is one clean ``Engine`` of
    ``FLEET_SLOTS`` slots with replica 0's params (the same shapes).

    Gates: every request gets its ``max_new`` tokens with finite logits;
    (c) 1 death, at least 1 restart and 1 migration; (d) at least 1 slot
    migration; (e) 1 join and 1 leave; each checkpoint-streamed replica's
    params and first-chunk logits on a fixed prompt bit-equal to replica
    0's; every request placed once (never moved) gets the single engine's
    tokens bit for bit; every run launches K1 and K2 and nothing else.
    Requests that moved are printed, not gated: their tail replays through
    a chunk launch (another K2 instance than the decode step's) or from a
    snapshot.  Then phase 8's engine traffic (``SLOTS`` slots) with
    ``RunOptions(fused_qkv=True)`` beside the unfused run on the same
    weights: exactly ``2 L`` fewer K2 launches a decode step (one QKV
    product a layer where there were three); layer 0's fused QKV product
    within phase 2's bf16 tolerance of the three products; the first
    decode step's logits at most twice as far from the unfused run's as
    the unfused run's are from the f32 model's on the same weights and
    tokens (K2's split-K plan changes with the product's width, so bf16
    roundings move and grow over 28 layers, as two cache layouts' do in
    phase 14); the token match share and the device ms a decode step
    printed.  Returns the phase's numbers.  ``cfg`` (default
    the full config) lets a rehearsal run the phase at a small size."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import policy
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.router import Router
    from repro_torch.launch.serve import Request
    from repro_torch.models import RunOptions, build_model, common
    from repro_torch.runtime import FaultInjector

    cfg = cfg or get_config(ARCH)
    L, V = cfg.n_layers, cfg.vocab_size
    work = engine_workload(np, V)
    kw = dict(max_batch=FLEET_SLOTS, max_len=ENGINE_LEN, chunk=CHUNK,
              snapshot_every=FLEET_SNAPSHOT)
    want = {"flash_attention_int8": 0, "flash_attention_bwd": 0, "hbp_matmul_batched": 0,
            **{k: 0 for k in registry_kernels}}
    out = {}
    fixed = torch.from_numpy(np.random.default_rng(2).integers(
        3, V, (FLEET_SLOTS, CHUNK)).astype(np.int32)).to(dev)

    @torch.no_grad()
    def first_chunk_logits(engine):
        """One first chunk of ``fixed`` on a fresh cache of ``engine``'s shape."""
        cache = engine.model.init_cache(FLEET_SLOTS, ENGINE_LEN)
        zeros = torch.zeros(FLEET_SLOTS, dtype=torch.int32, device=dev)
        lens = torch.full((FLEET_SLOTS,), CHUNK, dtype=torch.int32, device=dev)
        logits, _ = engine.model.prefill_chunk(fixed, zeros, cache, first=True, lens=lens)
        return logits

    def same_replica(rep, ref, ref_logits):
        """``rep``'s params and first-chunk logits bit-equal to ``ref``'s."""
        mine = rep.engine.model.state_dict()
        params_eq = all(torch.equal(t, mine[k]) for k, t in ref.items())
        logits_eq = torch.equal(first_chunk_logits(rep.engine), ref_logits)
        print(f"    replica {rep.rid} ({rep.spawned_from}, up in {rep.spawn_s:.3f} s): params "
              f"bit-equal to replica 0's {params_eq}, first-chunk logits bit-equal {logits_eq}")
        check(params_eq and logits_eq, f"replica {rep.rid} restored params or logits differ "
              "from replica 0's")

    def requests():
        return [Request(i, p, max_new=m) for i, (p, m) in enumerate(work)]

    def fleet_run(router, label, steer=None):
        """One fleet run (``steer(router)`` runs it when given), its gates,
        and its line of numbers."""
        cls = type(router.replicas[0].engine.model)
        plain = cls.decode_step, cls.prefill_chunk
        cls.decode_step, cls.prefill_chunk = (finite_logits(f) for f in plain)
        trace.update(finite=torch.ones((), dtype=torch.bool, device=dev))
        reqs = requests()
        reset_counts()
        try:
            if steer is None:
                res = router.run(reqs)
            else:
                res = steer(router, reqs)
            launches = counts()
        finally:
            cls.decode_step, cls.prefill_chunk = plain
        c = res["counters"]
        tokens = [r.out for r in reqs]
        placed = {}
        for uid, _ in res["placements"]:
            placed[uid] = placed.get(uid, 0) + 1
        moved = sorted(u for u, n in placed.items() if n > 1)
        still = [u for u in range(len(reqs)) if u not in moved]
        same = [u for u in still if tokens[u] == ref_tokens[u]]
        m_same = [u for u in moved if tokens[u] == ref_tokens[u]]
        diverge = {u: first_divergence(tokens[u], ref_tokens[u]) for u in moved
                   if u not in m_same}
        faults = [row["faults"] for row in res["replicas"]]
        print(f"    ({label}) {res['tokens']} tokens: fleet {res['fleet_tok_per_s']:.1f} tok/s "
              f"(makespan {res['fleet_busy_s']:.3f} s), sequential {res['tok_per_s']:.1f} "
              f"tok/s ({res['wall_s']:.3f} s); busy_s "
              f"{ {row['rid']: round(row['busy_s'], 3) for row in res['replicas']} }; router "
              f"host {1e3 * res['router_host_s'] / max(res['rounds'], 1):.3f} ms a round over "
              f"{res['rounds']} rounds ({smi})")
        print(f"        counters {c}")
        print(f"        launches {launches}; logits finite {bool(trace['finite'])}; unmoved "
              f"requests == single engine {len(same)}/{len(still)}; moved {moved}: "
              f"{len(m_same)} match, first divergent index {diverge} (bf16, not gated)")
        check(all(len(r.out) == r.max_new for r in reqs),
              f"fleet ({label}): requests not completed: {[len(r.out) for r in reqs]}")
        check(bool(trace["finite"]) and all(f["slots_poisoned"] == 0 for f in faults),
              f"fleet ({label}): non-finite logits ({faults})")
        check(launches["flash_attention"] > 0 and launches["hbp_matmul"] > 0
              and all(launches[k] == n for k, n in want.items()),
              f"fleet ({label}): launches {launches}")
        check(len(same) == len(still), f"fleet ({label}): unmoved requests "
              f"{[u for u in still if u not in same]} differ from the single engine")
        return {"counters": c, "fleet_tok_per_s": res["fleet_tok_per_s"],
                "tok_per_s": res["tok_per_s"], "busy_s": [row["busy_s"] for row in res["replicas"]],
                "router_host_ms_per_round": 1e3 * res["router_host_s"] / max(res["rounds"], 1),
                "moved": len(moved), "moved_match": len(m_same)}

    def join_leave(router, reqs):
        router.begin(reqs)
        for _ in range(FLEET_JOIN_AT):
            router.step_round()
        joiner = router.add_replica()
        for _ in range(FLEET_LEAVE_AT):
            router.step_round()
        router.remove_replica(0)
        while not router.done():
            router.step_round()
        res = router.finish(reqs)
        res["joiner"] = joiner
        return res

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        # -- 16a, b, d, e: one fleet ------------------------------------------------------
        ckpt_bytes = 2 * cfg.param_count()
        room = shutil.disk_usage(tmp).free
        print(f"[16] {ARCH} fleet: {FLEET_REPLICAS} replicas x {FLEET_SLOTS} slots, max_len "
              f"{ENGINE_LEN}, chunk {CHUNK}, snapshot every {FLEET_SNAPSHOT}; phase 8's "
              f"{len(work)} requests; fleet checkpoint {ckpt_bytes / 1e9:.2f} GB, {tmp}: "
              f"{room / 1e9:.2f} GB free")
        check(room >= 2 * ckpt_bytes, f"phase 16: {room / 1e9:.2f} GB free under {tmp}, "
              f"{2 * ckpt_bytes / 1e9:.2f} GB needed for the fleet checkpoints")
        router = Router(cfg, device=dev, n_replicas=FLEET_REPLICAS, ckpt_dir=tmp / "a", **kw)
        rep0 = router.replicas[0]
        params = rep0.engine.model.state_dict()
        ref_logits = first_chunk_logits(rep0.engine)
        print(f"    fleet checkpoint written in {router.ckpt_save_s:.3f} s (host clock)")
        out["ckpt_save_s"] = router.ckpt_save_s
        same_replica(router.replicas[1], params, ref_logits)
        out["restart_s"] = [router.replicas[1].spawn_s]
        single = Engine(cfg, device=dev, params=params, injector=FaultInjector(""), **kw)
        reqs = requests()
        t0 = time.perf_counter()
        single.run(reqs)
        ref_tokens = [r.out for r in reqs]
        print(f"    single engine ({FLEET_SLOTS} slots, replica 0's params): "
              f"{sum(map(len, ref_tokens))} tokens in {time.perf_counter() - t0:.3f} s")
        del single
        out["a"] = fleet_run(router, "a: pws")
        router.route, router.seed = "rws", 5
        out["b"] = fleet_run(router, "b: rws, seed 5")
        router.route, router.seed = "pws", 0
        router.rebalance_threshold, router.queue_depth = FLEET_REBALANCE, 0
        out["d"] = fleet_run(router, f"d: pws, rebalance threshold {FLEET_REBALANCE}, "
                             "queue depth 0")
        check(out["d"]["counters"]["slot_migrations"] >= 1,
              f"fleet (d): no slot migration ({out['d']['counters']})")
        router.rebalance_threshold, router.queue_depth = None, 1
        out["e"] = fleet_run(router, f"e: pws, a replica joined after {FLEET_JOIN_AT} rounds, "
                             f"replica 0 removed {FLEET_LEAVE_AT} rounds later", join_leave)
        c = out["e"]["counters"]
        check(c["joins"] == 1 and c["leaves"] == 1, f"fleet (e): joins and leaves {c}")
        same_replica(router.replicas[-1], params, ref_logits)
        out["restart_s"].append(router.replicas[-1].spawn_s)
        del router, rep0
        shutil.rmtree(tmp / "a")
        gc.collect()
        torch.cuda.empty_cache()

        # -- 16c: a replica dies and restarts from the checkpoint ---------------------------
        router = Router(cfg, device=dev, n_replicas=FLEET_REPLICAS, ckpt_dir=tmp / "c",
                        params=params, fleet_faults=FLEET_DEATH, **kw)
        out["c"] = fleet_run(router, f"c: pws under '{FLEET_DEATH}'")
        c = out["c"]["counters"]
        check(c["replica_deaths"] == 1 and c["replica_restarts"] >= 1 and c["migrations"] >= 1,
              f"fleet (c): deaths, restarts and migrations {c}")
        for rep in router.replicas[1:]:
            if rep.state == "live":
                same_replica(rep, params, ref_logits)
                out["restart_s"].append(rep.spawn_s)
        del router
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 16f: phase 8's engine traffic with fused QKV ----------------------------------------
    fused_opts = RunOptions(fused_qkv=True)
    fused_scope = policy.from_run_options(fused_opts)
    a_tol, r_tol = COMPARE_TOL["bfloat16"]
    # one attention block's QKV products, fused (one K2 launch) against
    # unfused (three), on layer 0's weights at the decode and chunk rows:
    # within phase 2's bf16 tolerance, as each is of its plain version
    w3 = [params[f"layers.0.{k}"] for k in ("wq", "wk", "wv")]
    qkv_err = 0.0
    for T in (SLOTS, SLOTS * CHUNK):
        x = torch.randn(T, cfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(T)).to(w3[0].dtype)
        three = common.qkv_project(x, *w3)
        with policy.apply(**fused_scope):
            one = common.qkv_project(x, *w3)
        for got, want in zip(one, three):
            err = (got.float() - want.float()).abs()
            qkv_err = max(qkv_err, err.max().item())
            check(bool((err <= a_tol + r_tol * want.float().abs()).all()),
                  f"fused QKV product at {T} rows differs from the three products by "
                  f"{err.max().item()}")
    print(f"    (f) layer 0's QKV products fused vs unfused at {SLOTS} and {SLOTS * CHUNK} rows: "
          f"max_abs_err {qkv_err:.3e} (atol {a_tol:g} + rtol {r_tol:g}) ok")
    runs = {}
    for name, opts in (("unfused", None), ("fused", fused_opts)):
        engine = Engine(cfg, device=dev, params=params, max_batch=SLOTS, max_len=ENGINE_LEN,
                        chunk=CHUNK, opts=opts)
        trace_engine(engine, counted, finite_logits)
        trace.update(decode=[], prefill=[], pos=[],
                     finite=torch.ones((), dtype=torch.bool, device=dev))
        reqs = requests()
        reset_counts()
        res = engine.run(reqs)
        per_step = trace["decode"]
        k2 = sorted({c["hbp_matmul"] for c in per_step})
        mid_pos = trace["pos"][len(trace["pos"]) // 2]
        tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
        with policy.apply(**(fused_scope if opts else {})):
            dev_ms = time_ms(torch, lambda: type(engine.model).decode_step(
                engine.model, tok, mid_pos, engine.cache), [()])
        # the first decode step's logits on a fixed batch, after one prefill
        with torch.no_grad():
            prompt = fixed[:, :CHUNK].repeat(SLOTS // FLEET_SLOTS, 1)[:SLOTS]
            logits, cache = engine.model.prefill({"tokens": prompt}, 2 * CHUNK)
            if name == "unfused":
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            first, _ = engine.model.decode_step(nxt, torch.tensor(CHUNK, dtype=torch.int32,
                                                                  device=dev), cache)
        runs[name] = dict(tokens=[r.out for r in reqs], k2=k2, dev_ms=dev_ms, first=first,
                          wall_ms=1e3 * res["decode_s"] / max(res["decode_steps"], 1))
        print(f"    (f) {name} QKV, phase 8's traffic ({SLOTS} slots): completed "
              f"{len(res['completed'])}/{len(reqs)}, logits finite {bool(trace['finite'])}; K2 "
              f"launches a decode step {k2}; decode step {dev_ms:.4f} ms on the device (CUDA "
              f"graph replay), {runs[name]['wall_ms']:.3f} ms host wall ({smi})")
        check(all(len(r.out) == r.max_new for r in reqs) and bool(trace["finite"]),
              f"{name} QKV engine: requests not completed or non-finite logits")
        check(all(c["flash_attention"] == L for c in per_step),
              f"{name} QKV engine: attention launches {per_step[:1]}")
        del engine, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    # the same first decode step of the f32 model on the same weights: the
    # distance bf16 rounding alone puts between a bf16 model and its f32
    # self, the yardstick of the fused run's distance from the unfused one
    wide = build_model(reduced(cfg, dtype="float32"), device=dev)
    wide.load_state_dict(params)
    with torch.no_grad():
        _, cache = wide.prefill({"tokens": prompt}, 2 * CHUNK)
        f32_first, _ = wide.decode_step(nxt, torch.tensor(CHUNK, dtype=torch.int32,
                                                          device=dev), cache)
    del wide, cache
    fewer = [u - f for u, f in zip(runs["unfused"]["k2"], runs["fused"]["k2"])]
    want_l, got_l = runs["unfused"]["first"], runs["fused"]["first"]
    gap = (got_l - want_l).abs().max().item()
    noise = (want_l - f32_first).abs().max().item()
    agree = sum(a == b for a, b in zip(runs["unfused"]["tokens"], runs["fused"]["tokens"]))
    print(f"    (f) fused QKV: {fewer} fewer K2 launches a decode step (want {2 * L}); first "
          f"decode logits {gap:.3e} max abs from the unfused run's, which is {noise:.3e} from "
          f"the f32 model's (gate: at most twice that) {'ok' if gap <= 2 * noise else 'FAIL'}; "
          f"requests with the same tokens {agree}/{len(work)}; decode step "
          f"{runs['fused']['dev_ms']:.4f} ms fused, {runs['unfused']['dev_ms']:.4f} ms unfused "
          f"on the device (not a claim)")
    check(runs["unfused"]["k2"] == [7 * L + 1] and runs["fused"]["k2"] == [5 * L + 1],
          f"K2 launches a decode step: unfused {runs['unfused']['k2']}, fused "
          f"{runs['fused']['k2']}; want {7 * L + 1} and {5 * L + 1}")
    check(gap <= 2 * noise, f"fused QKV first decode logits are {gap} from the unfused run's, "
          f"more than twice the unfused run's {noise} from the f32 model's")
    out["fused"] = {"k2_fewer": fewer[0], "qkv_err": qkv_err, "first_logits_gap": gap,
                    "bf16_noise": noise, "token_match": agree,
                    "dev_ms": runs["fused"]["dev_ms"], "unfused_dev_ms": runs["unfused"]["dev_ms"]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def smoke_autotune_checks(torch, small, params, prompts, want, tune_dir):
    """Phase 3's autotune and fused-QKV cases at f32: the smoke ``Server``
    on the card under ``RunOptions(autotune="search")`` (every product it
    meets searched on the card and recorded in a table under ``tune_dir``,
    its own directory, so no later phase replays it), then under
    ``"replay"`` of that table with each entry's plan moved to the last of
    its call's candidates (the search keeps the analytic plan within its
    noise, so the replay would otherwise run the analytic plans), then with
    ``fused_qkv=True`` on the card and on the CPU: every run's greedy tokens
    equal ``want``, the CPU's (the fused runs: the fused CPU run's)."""
    from repro_torch.kernels import autotune, planner
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import RunOptions

    prev = os.environ["REPRO_TUNE_DIR"]
    os.environ["REPRO_TUNE_DIR"] = str(tune_dir)
    autotune.clear_cache()

    def serve(where, opts):
        srv = Server(small, device=where, params=params, max_batch=BATCH, max_len=64,
                     opts=opts)
        reqs = [Request(i, p, max_new=12) for i, p in enumerate(prompts)]
        srv.run_batch(reqs)
        return [r.out for r in reqs]

    kind = planner.device_params(torch.device("cuda")).kind
    far = {}
    real_search = autotune.search

    def search(op, *args, **kw):
        far[autotune.entry_key(op, *args, kwargs=kw)] = autotune.candidates(
            op, *args, kwargs=kw)[-1]
        return real_search(op, *args, **kw)

    autotune.search = search
    try:
        got = {"search": serve("cuda", RunOptions(autotune="search"))}
        autotune.search = real_search
        table = autotune.load_table(kind)
        for key, plan in far.items():
            table[key] = {**table[key], "plan": plan}
        autotune.save_table(kind)
        autotune.clear_cache()
        got["replay"] = serve("cuda", RunOptions(autotune="replay"))
        table = autotune.load_table(kind)
        moved = sum(e["plan"] != e["analytic_plan"] for e in table.values())
        fused = {where: serve(where, RunOptions(fused_qkv=True)) for where in ("cuda", "cpu")}
    finally:
        autotune.search = real_search
        os.environ["REPRO_TUNE_DIR"] = prev
        autotune.clear_cache()
        autotune.set_mode(None)
    print(f"[3] smoke f32 under the autotune on the card: search (table of {len(table)} "
          f"entries) tokens == cpu {got['search'] == want}, replay of that table moved to "
          f"the last candidates ({moved} off the analytic plan) == cpu "
          f"{got['replay'] == want}; fused QKV cuda == cpu "
          f"{fused['cuda'] == fused['cpu']}")
    check(table and all(k.startswith(("matmul|", "attention|")) for k in table),
          f"the searched smoke table holds {sorted(table)}")
    check(moved > 0, "the replayed smoke table holds no plan off the analytic one")
    for mode, toks in got.items():
        check(toks == want, f"{mode} cuda tokens {toks} != cpu tokens {want}")
    check(fused["cuda"] == fused["cpu"],
          f"fused QKV cuda tokens {fused['cuda']} != cpu tokens {fused['cpu']}")


def phase_17(torch, np, dev, smi, reset_counts, trace, counted, finite_logits, cfg=None):
    """The measured autotune on the card (phase 17), ``qwen3-1.7b`` at full
    width (``cfg``: another config, for a rehearsal at a small size), bf16,
    seeded weights, phase 8's ``Engine`` configuration.

    (a) ``autotune.search`` on every distinct K2 product of one engine
    decode step (8 rows: the ``stream`` instance) and one 64-token chunk
    step (512 rows: ``wgmma``), recorded off the engine's own dispatches;
    on phase 9's int8 K1q decode call (its cluster split); and on phase
    10's scan, transpose, FFT and f32 and bf16 Strassen products.  Each
    winner is held against its plain version at the tolerance its phase
    gates it with (phase 2's for K2 and K1q, phase 10's for the registry
    ops), as is every other candidate it ran, and each search's key, analytic and best plan and µs and
    candidate count go into one ``{"autotune": [...]}`` line.  (b) Phase
    8's engine traffic through an engine under ``RunOptions(autotune=
    "replay")`` on that table beside one under ``"off"`` (the analytic
    plans), the same weights: every request completes with finite logits,
    both make ``7 L + 1`` K2 launches a decode step, and the replayed
    engine's first decode logits on a fixed batch are at most twice as far
    from the analytic run's as those are from the f32 model's (phase 16's
    rule: K2's split-K changes bf16 roundings).  Prints each run's decode
    step on the device (CUDA graph replay) and the host µs of one
    ``dispatch`` of a decode product under each mode (the memoized
    overlay's cost).  Returns the search rows and the run's numbers.  With
    ``cfg`` given (a rehearsal at a small size) the registry ops shrink
    too."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import autotune, planner, policy, registry
    from repro_torch.kernels.bi_fft import bi_fft_plain
    from repro_torch.kernels.bi_transpose import transpose_ref
    from repro_torch.kernels.bp_scan import bp_scan_plain
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.hbp_matmul import matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path
    from repro_torch.kernels.strassen_matmul import strassen_matmul_plain
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request
    from repro_torch.models import RunOptions, build_model
    from repro_torch.models.common import kv_scale, quantize_kv

    full = cfg is None
    cfg = cfg or get_config(ARCH)
    L, V = cfg.n_layers, cfg.vocab_size
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kind = planner.device_params(dev).kind
    scan_n, tr_n, fft_n, mm_n = (2 ** 20, 8192, 2 ** 16, STRASSEN_N) if full else \
        (2 ** 12, 256, 2 ** 10, 256)
    g = torch.Generator(device=dev).manual_seed(17)
    rows = []

    # -- 17a. the products of one decode step and one chunk step --------------------------
    engine = Engine(cfg, device=dev, max_batch=SLOTS, max_len=ENGINE_LEN, chunk=CHUNK,
                    opts=RunOptions(autotune="off"))
    params = engine.model.state_dict()
    calls = {}
    real = registry.dispatch

    def record(name, *args, **kw):
        if name == "matmul":
            calls.setdefault(autotune.entry_key(name, *args, kwargs=kw),
                             ([a.detach().clone() for a in args], kw))
        return real(name, *args, **kw)

    prompt = np.random.default_rng(3).integers(3, V, CHUNK).astype(np.int32)
    registry.dispatch = record
    try:
        engine.run([Request(0, prompt, max_new=2)])  # one chunk step, one decode step
    finally:
        registry.dispatch = real

    def normwise(got, want):
        got, want = (t if t.is_complex() else t.float() for t in (got, want))
        return ((got - want).abs().max() / want.abs().max()).item()

    def held(op, args, kw, plan):
        """(max abs err of the winner against its plain version, ok, rule)."""
        got = registry.get(op).kernel(*args, **kw, **plan)
        if op == "matmul" and args[0].dim() == 2 and args[0].shape[0] == args[0].shape[1] \
                == args[1].shape[1] == mm_n:
            want = (strassen_matmul_plain(*args, cutoff=plan.get("cutoff"))
                    if plan.get("backend") == "strassen" else matmul_ref(*args))
            tol = MM_TOL[0] if args[0].dtype == torch.float32 else MM_TOL_BF16[0]
            e = normwise(got, want)
            return e, e <= tol, f"normwise {tol:g}"
        if op in ("matmul", "attention"):
            want = (matmul_ref(*args) if op == "matmul" else
                    flash_attention_ref(*args, **kw)[0])
            a_tol, r_tol = COMPARE_TOL[str(args[0].dtype).removeprefix("torch.")]
            diff = (got.float() - want.float()).abs()
            return (diff.max().item(), bool((diff <= a_tol + r_tol * want.float().abs()).all()),
                    f"atol {a_tol:g} + rtol {r_tol:g}")
        x = args[0]
        if op == "scan":
            want = bp_scan_plain(x, plan.get("block", x.shape[-1])).float()
            diff = (got.float() - want).abs()
            slack = SCAN_SLACK * torch.cumsum(x.float().abs(), dim=-1) + SCAN_SLACK
            return diff.max().item(), bool((diff <= slack).all()), \
                f"{SCAN_SLACK:g} * cumsum|x| + {SCAN_SLACK:g}"
        if op == "transpose":
            return 0.0 if torch.equal(got, transpose_ref(x)) else float("inf"), \
                torch.equal(got, transpose_ref(x)), "exact"
        e = normwise(got, bi_fft_plain(x, n1=plan.get("n1")))
        return e, e <= FFT_TOL[0], f"normwise {FFT_TOL[0]:g}"

    def search(label, op, args, kw=None):
        kw = kw or {}
        t0 = time.perf_counter()
        entry = autotune.search(op, *args, **kw)
        took = time.perf_counter() - t0
        # the winner, and every other candidate the search ran, against the
        # plain version: a plan another shape may replay is a checked one
        cands = autotune.candidates(op, *args, kwargs=kw)
        with torch.no_grad():
            err, ok, rule = held(op, args, kw, entry["plan"])
            bad = [p for p in cands if not held(op, args, kw, p)[1]]
        check(not bad, f"autotune {label}: candidates {bad} disagree with the plain version")
        key = autotune.entry_key(op, *args, kwargs=kw)
        rows.append({"key": key, "analytic_plan": entry["analytic_plan"],
                     "analytic_us": entry["analytic_us"], "plan": entry["plan"],
                     "us": entry["us"], "candidates": entry["candidates"]})
        print(f"    {label}: analytic {entry['analytic_plan']} {entry['analytic_us']} us, best "
              f"{entry['plan']} {entry['us']} us ({entry['analytic_us'] / entry['us']:.3f}x) of "
              f"{entry['candidates']} candidates in {took:.2f} s, each within tolerance of "
              f"the plain version; winner vs plain {err:.3e} ({rule}) {'ok' if ok else 'FAIL'}")
        check(ok, f"autotune {label}: the winner {entry['plan']} disagrees with its plain "
              f"version ({err} against {rule})")

    print(f"[17] the measured autotune on the card ({smi}); table {autotune.table_path(kind)}")
    print(f"    {len(calls)} distinct K2 products in one decode and one {CHUNK}-token chunk "
          f"step of phase 8's engine:")
    for key, (args, kw) in calls.items():
        a, b = args
        search(f"{key} [{mm_path(a, b)}]", "matmul", args, kw)
    # phase 9's K1q decode call: bf16 q over phase 8's int8 cache at seeded lanes
    qo = torch.from_numpy(np.random.default_rng(4).integers(
        16, ENGINE_LEN - 1, SLOTS).astype(np.int32)).to(dev)
    fp = [torch.randn(SLOTS, ENGINE_LEN, kvh, hd, device=dev, generator=g) for _ in "kv"]
    scales = [kv_scale(x) for x in fp]
    k8, v8 = (quantize_kv(x, sc) for x, sc in zip(fp, scales))
    del fp
    q = torch.randn(SLOTS, 1, h, hd, device=dev, generator=g).to(torch.bfloat16)
    search(f"K1q decode {SLOTS}x1 vs int8 {ENGINE_LEN}", "attention", (q, k8, v8),
           dict(causal=True, q_offset=qo, kv_len=qo + 1, k_scale=scales[0],
                v_scale=scales[1]))
    del q, k8, v8
    # phase 10's registry ops past the L2
    reg = [(f"scan f32 64x{scan_n}", "scan",
            (torch.randn(64, scan_n, device=dev, generator=g),)),
           (f"transpose f32 {tr_n}x{tr_n}", "transpose",
            (torch.randn(tr_n, tr_n, device=dev, generator=g),)),
           (f"fft complex64 256x{fft_n}", "fft",
            (torch.randn(256, fft_n, dtype=torch.complex64, device=dev, generator=g),)),
           (f"matmul f32 {mm_n}^2", "matmul",
            tuple(torch.randn(mm_n, mm_n, device=dev, generator=g) for _ in "ab")),
           (f"matmul bf16 {mm_n}^2", "matmul",
            tuple(torch.randn(mm_n, mm_n, device=dev, generator=g).to(torch.bfloat16)
                  for _ in "ab"))]
    for label, op, args in reg:
        search(label, op, args)
    del reg
    gc.collect()
    torch.cuda.empty_cache()
    table = autotune.load_table(kind)
    print(json.dumps({"autotune": rows}))
    check(len(table) == len(rows), f"the table holds {len(table)} entries for {len(rows)} "
          "searches")

    # -- 17b. phase 8's traffic replayed on the table, beside the analytic plans ------------
    work = engine_workload(np, V)
    fixed = torch.from_numpy(np.random.default_rng(2).integers(
        3, V, (SLOTS, CHUNK)).astype(np.int32)).to(dev)
    dec_a = torch.randn(SLOTS, cfg.d_model, device=dev, generator=g).to(torch.bfloat16)
    w_dec = params["layers.0.w_gate"] if "layers.0.w_gate" in params else next(
        t for t in params.values() if t.dim() == 2)

    def host_us(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / n

    runs = {}
    del engine
    gc.collect()
    for mode in ("off", "replay"):
        eng = Engine(cfg, device=dev, params=params, max_batch=SLOTS, max_len=ENGINE_LEN,
                     chunk=CHUNK, opts=RunOptions(autotune=mode))
        trace_engine(eng, counted, finite_logits)
        trace.update(decode=[], prefill=[], pos=[],
                     finite=torch.ones((), dtype=torch.bool, device=dev))
        reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(work)]
        reset_counts()
        res = eng.run(reqs)
        k2 = sorted({c["hbp_matmul"] for c in trace["decode"]})
        mid_pos = trace["pos"][len(trace["pos"]) // 2]
        tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
        with policy.apply(autotune=mode), torch.no_grad():
            dev_ms = time_ms(torch, lambda: type(eng.model).decode_step(
                eng.model, tok, mid_pos, eng.cache), [()])
            logits, cache = eng.model.prefill({"tokens": fixed}, 2 * CHUNK)
            if mode == "off":
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            first, _ = eng.model.decode_step(nxt, torch.tensor(CHUNK, dtype=torch.int32,
                                                               device=dev), cache)
        runs[mode] = dict(tokens=[r.out for r in reqs], first=first, dev_ms=dev_ms, k2=k2,
                          wall_ms=1e3 * res["decode_s"] / max(res["decode_steps"], 1))
        print(f"    (b) autotune {mode}: phase 8's traffic completed {len(res['completed'])}/"
              f"{len(reqs)}, logits finite {bool(trace['finite'])}; K2 launches a decode step "
              f"{k2}; decode step {dev_ms:.4f} ms on the device (CUDA graph replay), "
              f"{runs[mode]['wall_ms']:.3f} ms host wall ({smi})")
        check(all(len(r.out) == r.max_new for r in reqs) and bool(trace["finite"]),
              f"autotune {mode} engine: requests not completed or non-finite logits")
        check(k2 == [7 * L + 1] or dev.type != "cuda",  # a CPU rehearsal launches none
              f"autotune {mode} engine: K2 launches a decode step {k2}")
        del eng, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    # the host's cost of one dispatch of a decode product under each mode,
    # alternated (the host's spread between runs is wide), and how often
    # the overlay was computed (not taken from its memo) in those calls
    computed = [0]
    real_overlay = autotune._overlay

    def counted_overlay(*a, **kw):
        computed[0] += 1
        return real_overlay(*a, **kw)

    autotune._overlay = counted_overlay
    host = {"off": [], "replay": []}
    try:
        with torch.no_grad():
            for _ in range(3):
                for mode in host:
                    with policy.apply(autotune=mode):
                        host[mode].append(host_us(lambda: registry.dispatch(
                            "matmul", dec_a, w_dec)))
    finally:
        autotune._overlay = real_overlay
    for mode, v in host.items():
        runs[mode]["us"] = sorted(v)[1]
    print(f"    (b) host us per dispatch of a {SLOTS}x{cfg.d_model} @ {tuple(w_dec.shape)} "
          f"product, 3 alternated rounds of 2000 calls: off {[round(u, 2) for u in host['off']]}, "
          f"replay {[round(u, 2) for u in host['replay']]} (medians {runs['off']['us']:.2f}, "
          f"{runs['replay']['us']:.2f}); the overlay computed {computed[0]} times in "
          f"{3 * 2001} replayed calls")
    check(computed[0] <= 1, f"the dispatch overlay was computed {computed[0]} times for one "
          "call signature: its memo misses")
    wide = build_model(reduced(cfg, dtype="float32"), device=dev)
    wide.load_state_dict(params)
    with torch.no_grad():
        _, cache = wide.prefill({"tokens": fixed}, 2 * CHUNK)
        f32_first, _ = wide.decode_step(nxt, torch.tensor(CHUNK, dtype=torch.int32,
                                                          device=dev), cache)
    del wide, cache, params
    gap = (runs["replay"]["first"] - runs["off"]["first"]).abs().max().item()
    noise = (runs["off"]["first"] - f32_first).abs().max().item()
    agree = sum(a == b for a, b in zip(runs["off"]["tokens"], runs["replay"]["tokens"]))
    print(f"    (b) replayed first decode logits {gap:.3e} max abs from the analytic run's, "
          f"which is {noise:.3e} from the f32 model's (gate: at most twice that) "
          f"{'ok' if gap <= 2 * noise else 'FAIL'}; requests with the same tokens "
          f"{agree}/{len(work)}; decode step {runs['replay']['dev_ms']:.4f} ms replayed, "
          f"{runs['off']['dev_ms']:.4f} ms analytic on the device; host wall per decode step "
          f"{runs['replay']['wall_ms']:.3f} ms replayed, {runs['off']['wall_ms']:.3f} ms "
          f"analytic; dispatch host us {runs['replay']['us']:.2f} replayed, "
          f"{runs['off']['us']:.2f} analytic")
    check(gap <= 2 * noise, f"replayed first decode logits are {gap} from the analytic run's, "
          f"more than twice the analytic run's {noise} from the f32 model's")
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "first_logits_gap": gap, "bf16_noise": noise, "token_match": agree,
            **{f"{k}_{m}": runs[m][k] for m in runs for k in ("dev_ms", "us", "wall_ms")}}


# phase 18's simulator runs at the demo's machine (examples/hbp_paper_demo_torch.py)
SIM_P, SIM_M, SIM_B = 8, 512, 16


def phase_18(torch, dev, g, smi):
    """The simulator core and the value-level algorithms (phase 18).
    ``algorithms_torch`` on the card at real sizes against torch oracles:
    prefix sums of 2^24 f32 against ``torch.cumsum`` in f64 (within
    ``SCAN_SLACK`` times the running sum of |x|), ``mt_bi`` of a 4096^2
    BI-layout matrix against the BI layout of ``m.t()`` (exact),
    ``strassen`` at 2048 (leaves of 64) against ``torch.matmul`` (f32, TF32
    off; normwise ``MM_TOL[1]``) and ``fft_six_step`` of 2^20 against
    ``torch.fft.fft`` (normwise ``FFT_TOL[1]``).  Then one run of each
    simulator program on ``Machine(SIM_P, SIM_M, SIM_B)`` under ``PWS``
    (host only), its stats printed; gates: work done, and at most p-1
    steals of any priority (Obs. 4.3)."""
    import time

    from repro_torch.core import algorithms, algorithms_torch
    from repro_torch.core.hbp import Memory
    from repro_torch.core.machine import Machine
    from repro_torch.core.pws import PWS

    print(f"[18] the simulator core: algorithms_torch on the card ({smi})")

    def normwise(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    x = torch.randn(2 ** 24, device=dev, generator=g)
    t0 = time.perf_counter()
    got = algorithms_torch.prefix_sums(x)
    torch.cuda.synchronize()
    t_ps = time.perf_counter() - t0
    diff = (got.double() - torch.cumsum(x.double(), 0)).abs()
    slack = SCAN_SLACK * torch.cumsum(x.double().abs(), 0) + SCAN_SLACK
    ok_ps = bool((diff <= slack).all())
    print(f"    prefix_sums 2^24 f32: max abs err vs f64 cumsum {diff.max().item():.3e} "
          f"({SCAN_SLACK:g} * cumsum|x| + {SCAN_SLACK:g}) {'ok' if ok_ps else 'FAIL'} "
          f"({t_ps:.3f} s)")
    del x, got, diff, slack
    n = 4096
    m = torch.randn(n, n, device=dev, generator=g)
    t0 = time.perf_counter()
    got = algorithms_torch.mt_bi(algorithms_torch.rm_to_bi(m), n)
    torch.cuda.synchronize()
    t_mt = time.perf_counter() - t0
    ok_mt = torch.equal(got, algorithms_torch.rm_to_bi(m.t().contiguous())) and torch.equal(
        algorithms_torch.bi_to_rm(got, n), m.t())
    print(f"    mt_bi {n}^2 (BI in, BI out): equal to the BI layout of m.t() "
          f"{'ok' if ok_mt else 'FAIL'} ({t_mt:.3f} s with rm_to_bi)")
    del m, got
    a, b = (torch.randn(2048, 2048, device=dev, generator=g) for _ in "ab")
    t0 = time.perf_counter()
    got = algorithms_torch.strassen(a, b)
    torch.cuda.synchronize()
    t_st = time.perf_counter() - t0
    e_st = normwise(got, torch.matmul(a, b))
    print(f"    strassen 2048^2 (leaves of 64) f32: normwise err vs torch.matmul {e_st:.3e} "
          f"(tol {MM_TOL[1]:g}) {'ok' if e_st <= MM_TOL[1] else 'FAIL'} ({t_st:.3f} s)")
    del a, b, got
    x = torch.randn(2 ** 20, dtype=torch.complex64, device=dev, generator=g)
    t0 = time.perf_counter()
    got = algorithms_torch.fft_six_step(x)
    torch.cuda.synchronize()
    t_ff = time.perf_counter() - t0
    e_ff = normwise(got, torch.fft.fft(x))
    print(f"    fft_six_step 2^20: normwise err vs torch.fft.fft {e_ff:.3e} (tol "
          f"{FFT_TOL[1]:g}) {'ok' if e_ff <= FFT_TOL[1] else 'FAIL'} ({t_ff:.3f} s)")
    del x, got
    check(ok_ps and ok_mt and e_st <= MM_TOL[1] and e_ff <= FFT_TOL[1],
          "algorithms_torch disagrees with its torch oracles")

    progs = {
        "MSum 2^14": lambda: algorithms.MSum(1 << 14, Memory(SIM_B)),
        "prefix sums 2^12": lambda: algorithms.prefix_sums_programs(1 << 12, Memory(SIM_B)),
        "MTBI 64": lambda: algorithms.MTBI(64, Memory(SIM_B)),
        "RMtoBI 64": lambda: algorithms.RMtoBI(64, Memory(SIM_B)),
        "BItoRMDirect 64": lambda: algorithms.BItoRMDirect(64, Memory(SIM_B)),
        "BItoRM gapped 64": lambda: algorithms.bi_to_rm_gapped_programs(64, Memory(SIM_B)),
        "strassen 16": lambda: algorithms.strassen_program(16, Memory(SIM_B), base=4),
        "fft 2^10": lambda: algorithms.fft_program(1 << 10, Memory(SIM_B)),
        "list ranking 2^14": lambda: algorithms.list_ranking_phase_programs(1 << 14,
                                                                            Memory(SIM_B)),
    }
    print(f"    simulated multicore p={SIM_P}, M={SIM_M} words, B={SIM_B} (host), PWS:")
    for label, make in progs.items():
        t0 = time.perf_counter()
        ps = make()
        mach = Machine(SIM_P, SIM_M, SIM_B, scheduler=PWS())
        st = mach.run_sequence(ps) if isinstance(ps, list) else mach.run(ps)
        spp = st.steals_per_priority()
        print(f"      {label:18s} accesses {st.accesses} cache misses "
              f"{st.total_cache_misses()} block misses {st.total_block_misses()} steals "
              f"{len(st.steals)} (max {max(spp.values(), default=0)} a priority) idle "
              f"{st.idle_time:.0f} makespan {st.finish_time:.0f} usurpations "
              f"{st.usurpations} ({time.perf_counter() - t0:.2f} s)")
        check(st.accesses > 0 and max(spp.values(), default=0) <= SIM_P - 1,
              f"simulator {label}: {st.accesses} accesses, steals per priority {spp}")


def phase_19(torch, np, dev, smi, counts, reset_counts, workload, engine_tokens, cfg=None,
             cells=MESH_DRYRUN_CELLS):
    """Multi-device planning on the one-card mesh (phase 19; see the module
    docstring).  ``workload`` and ``engine_tokens``: phase 8's requests and
    its bf16 run's tokens; ``cfg`` (default ``ARCH``'s) and ``cells`` may be
    cut for a rehearsal on the CPU (``dev`` the CPU: no profiler trace).
    Returns the phase's numbers."""
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch import dryrun, trace_analysis
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import axis_sizes, make_debug_mesh, mesh_device
    from repro_torch.launch.serve import Request
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import RunOptions, build_model
    from repro_torch.runtime import elastic

    cfg = cfg or get_config(ARCH)
    on_card = dev.type == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    # (d) the dry-run cells, host only, one process each while the card works
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs = [(cell, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
         cell[1], "--mesh", cell[2], "--out-dir", str(tmp / "dryrun")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        for cell in cells]
    out = {}
    try:
        mesh = make_debug_mesh(device=dev.type)
        print(f"[19] multi-device planning on the one-card mesh {axis_sizes(mesh)} "
              f"({type(mesh).__name__}, device {mesh_device(mesh)}), {cfg.name} "
              f"({smi})")
        check(axis_sizes(mesh) == {"data": 1, "model": 1},
              f"make_debug_mesh() on one card: {axis_sizes(mesh)}")

        # (a) training on the mesh against the same run without one
        L = cfg.n_layers
        n_chunks = TRAIN_SEQ // min(512, TRAIN_SEQ)
        per_step = {"hbp_matmul": L * 7 * 4 + n_chunks * 4, "flash_attention": 2 * L,
                    "flash_attention_bwd": L}
        data = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        opts = RunOptions(autotune="off")
        plain = train(cfg, steps=TRAIN_STEPS, data_cfg=data, opts=opts, device=dev.type,
                      log_every=0)["losses"]
        gc.collect()
        reset_counts()
        t0 = time.perf_counter()
        run = train(cfg, steps=TRAIN_STEPS, data_cfg=data, opts=opts, mesh=mesh, log_every=0,
                    ckpt_dir=str(tmp / "train"), save_every=TRAIN_STEPS + 1, keep=1)
        t_train = time.perf_counter() - t0
        launches = counts()
        manifest = json.loads((tmp / "train" / f"step_{TRAIN_STEPS - 1}" /
                               "manifest.json").read_text())
        print(f"    (a) {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} on the mesh in "
              f"{t_train:.2f} s (the final save included): losses {run['losses']}; without "
              f"a mesh {plain}; bit-equal {run['losses'] == plain}; launches {launches}; "
              f"manifest mesh_shape {manifest['mesh_shape']}")
        check(run["losses"] == plain, f"phase 19: losses on the mesh {run['losses']} against "
              f"{plain} without one")
        check(manifest["mesh_shape"] == {"data": 1, "model": 1},
              f"phase 19: manifest mesh_shape {manifest['mesh_shape']}")
        for name, n in per_step.items():  # a CPU rehearsal launches none
            check(not on_card or launches[name] == TRAIN_STEPS * n,
                  f"phase 19: {name} launched {launches[name]} times in training, expected "
                  f"{TRAIN_STEPS} x {n}")

        # (b) the checkpoint back onto the mesh, bit for bit
        like = {"params": dict(run["model"].named_parameters()), "opt_state": run["opt_state"]}
        t0 = time.perf_counter()
        step, state = elastic.elastic_restore(CheckpointManager(tmp / "train"), like, mesh)
        t_restore = time.perf_counter() - t0
        same = {"params": all(torch.equal(state["params"][n], p)
                              for n, p in like["params"].items()),
                "step": torch.equal(state["opt_state"]["step"], like["opt_state"]["step"])}
        for key in ("master", "m", "v"):
            same[key] = all(torch.equal(state["opt_state"][key][n], t)
                            for n, t in like["opt_state"][key].items())
        on_mesh = all(t.device == mesh_device(mesh) for t in state["params"].values())
        print(f"    (b) elastic_restore onto the mesh: step {step} in {t_restore:.2f} s, "
              f"equal bit for bit {same}, every leaf on {mesh_device(mesh)} {on_mesh}")
        check(step == TRAIN_STEPS - 1 and all(same.values()) and on_mesh,
              f"phase 19: restored step {step}, equal {same}, on the mesh {on_mesh}")
        del state, like
        gc.collect()

        # (c) one training step, analysed and on the device's clock
        ds = SyntheticLMDataset(data, cfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(TRAIN_STEPS).items()}
        step_fn = make_train_step(run["model"])
        stats = trace_analysis.analyze(step_fn, run["opt_state"], batch)
        out["train"] = _trace_row(torch, trace_analysis, dryrun, stats, on_card, step_fn,
                                  run["opt_state"], batch)
        print(f"    (c) trace_analysis of one training step: {out['train']['line']}")
        check(stats.collective_bytes == 0 and stats.flops > 0,
              f"phase 19: training step {stats.as_dict()}")
        del run, step_fn, batch
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # (b) Engine.restart on the mesh from phase 8's weights
        model = build_model(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))  # the Engine's own init
        save_checkpoint(tmp / "serve", 0, {"params": model.state_dict()},
                        mesh_shape=axis_sizes(mesh))
        del model
        gc.collect()
        t0 = time.perf_counter()
        # phase 8 ran the analytic plans (its table was empty); phase 17 has
        # written one since
        engine = Engine.restart(cfg, tmp / "serve", mesh=mesh, max_batch=SLOTS,
                                max_len=ENGINE_LEN, chunk=CHUNK, opts=opts)
        t_restart = time.perf_counter() - t0
        reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(workload[:MESH_REQUESTS])]
        reset_counts()
        res = engine.run(reqs)
        served = counts()
        same_tokens = [r.out for r in reqs] == engine_tokens[:MESH_REQUESTS]
        print(f"    (b) Engine.restart on the mesh in {t_restart:.2f} s; phase 8's first "
              f"{MESH_REQUESTS} requests: completed {len(res['completed'])}, tokens equal to "
              f"phase 8's {same_tokens}; launches {served}")
        check(same_tokens, f"phase 19: restarted engine's tokens {[r.out for r in reqs]} "
              f"against phase 8's {engine_tokens[:MESH_REQUESTS]}")
        check(not on_card or (served["hbp_matmul"] > 0 and served["flash_attention"] > 0),
              f"phase 19: the restarted engine's launches {served}")
        tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
        pos = engine.cache.pos.clone()
        with torch.no_grad():
            stats = trace_analysis.analyze(engine.model.decode_step, tok, pos, engine.cache)
            out["decode"] = _trace_row(torch, trace_analysis, dryrun, stats, on_card,
                                       engine.model.decode_step, tok, pos, engine.cache)
        print(f"    (c) trace_analysis of one engine decode step (lanes {pos.tolist()}): "
              f"{out['decode']['line']}")
        check(stats.collective_bytes == 0 and stats.flops > 0,
              f"phase 19: decode step {stats.as_dict()}")
        del engine
        gc.collect()

        # (d) the dry run's cells
        out["dryrun"] = []
        for cell, t_start, proc in procs:
            try:
                _, err = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            path = tmp / "dryrun" / f"{dryrun.cell_id(*cell)}.json"
            check(proc.returncode == 0 and path.exists(),
                  f"phase 19: dry run of {cell} exited {proc.returncode}: {err[-2000:]}")
            rec = json.loads(path.read_text())
            mem = rec["memory"]
            row = dict(cell=cell, gb=mem["peak_bytes_est"] / 1e9,
                       argument_gb=mem["argument_bytes"] / 1e9, temp_gb=mem["temp_bytes"] / 1e9,
                       dominant=rec["roofline"]["dominant"], seconds=rec["seconds"])
            out["dryrun"].append(row)
            print(f"    (d) dry run {' '.join(cell)} ({rec['n_devices']} devices, opts "
                  f"{rec['opts']}): {row['gb']:.2f} GB a device (arguments "
                  f"{row['argument_gb']:.2f}, temp {row['temp_gb']:.2f}; the card holds 80), "
                  f"dominant {row['dominant']}, {rec['seconds']:.1f} s")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def _trace_row(torch, trace_analysis, dryrun, stats, on_card, fn, *args):
    """A step's analysis beside its device time (a ``torch.profiler`` trace
    of one more call; not measured off the card) and its roofline terms at
    the card's peaks."""
    roof = trace_analysis.roofline(stats, PEAK_OPS["bfloat16"], HBM_BYTES_PER_S,
                                   dryrun.NVLINK_BW)
    dev_ms = None
    if on_card:
        prof = trace_analysis.profile_device(fn, *args)
        dev_ms = prof["device_ms"] if prof["n"] else None
    line = (f"{stats.flops:.6e} FLOPs ({stats.kernel_flops:.6e} in the kernels), "
            f"{stats.hbm_bytes:.6e} bytes, collectives {stats.collectives or 'none'}; "
            f"roofline compute {1e3 * roof['compute_s']:.4f} ms, memory "
            f"{1e3 * roof['memory_s']:.4f} ms, collective {1e3 * roof['collective_s']:.4f} ms "
            f"({roof['dominant']}); device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (torch.profiler)")
    return dict(flops=stats.flops, hbm_bytes=stats.hbm_bytes, roofline=roof,
                device_ms=dev_ms, line=line)


def ring_prompts(np, vocab):
    """14b's prompts (phase 2 checks K2 at the rows of their prefill)."""
    r = np.random.default_rng(2)
    return [r.integers(3, vocab, int(n)).astype(np.int32)
            for n in r.integers(RING_PROMPTS[0], RING_PROMPTS[1] + 1, RING_BATCH)]


def sdpa(q, k, v, mask, causal):
    """``scaled_dot_product_attention`` on the model's (b, s, heads, hd)
    layout, grouped heads and all."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=causal, enable_gqa=True)


class _ShapeRecorder:
    """A kernel entry that records the shapes of each call's tensors by the
    kernel's name and calls through; attributes (its ``launches``
    counters) read and write the entry's own."""

    def __init__(self, name, fn, seen):
        object.__setattr__(self, "_entry", (name, fn, seen))

    def __call__(self, *args, **kwargs):
        name, fn, seen = self._entry
        seen.add((name, tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))))
        return fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._entry[1], attr)

    def __setattr__(self, attr, value):
        setattr(self._entry[1], attr, value)


def record_kernel_shapes(seen):
    """Patch K2's, K1's and K3's entries to record their calls' shapes into
    ``seen``; returns the function that undoes it."""
    from importlib import import_module

    mm = import_module("repro_torch.kernels.hbp_matmul")
    fa = import_module("repro_torch.kernels.flash_attention")
    patched = [(mm, "hbp_matmul"), (fa, "flash_attention"), (fa, "flash_attention_bwd")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in patched]
    for mod, attr, fn in saved:
        setattr(mod, attr, _ShapeRecorder(attr, fn, seen))

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def shard_rank(spec):
    """One rank of phase 20 (run by ``launch.mesh.spawn``): the (a)-(c)
    cases on the ``(2, 2)`` mesh; returns its numbers.  ``spec``: the
    device type, the configs' names and cuts, phase 4's prompts, the
    engine's workload."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config, reduced
    from repro_torch.core import collectives
    from repro_torch.data import DataConfig
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import axis_sizes, make_debug_mesh, mesh_device
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.train import train

    torch.backends.cuda.matmul.allow_tf32 = False
    dev_type = spec["device"]
    rank = dist.get_rank()
    mesh = make_debug_mesh(SHARD_RANKS, tp=SHARD_TP, device=dev_type)
    dev = mesh_device(mesh)
    _, reset_counts, counts = launch_counters()
    out = {"rank": rank, "mesh": axis_sizes(mesh), "coord": list(mesh.get_coordinate()),
           "device": str(dev), "backend": dist.get_backend()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def peak_reset():
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # (a) the f32 smoke config
    small = reduced(get_smoke_config(ARCH), dtype="float32")
    server = Server(small, mesh=mesh, max_batch=SHARD_SLOTS, max_len=SHARD_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(spec["small_prompts"])]
    server.run_batch(reqs)
    out["a_server"] = [r.out for r in reqs]
    engine = Engine(small, mesh=mesh, max_batch=SHARD_SLOTS, max_len=SHARD_LEN,
                    chunk=SHARD_CHUNK)
    reqs = [Request(i, p, max_new=n) for i, (p, n) in enumerate(spec["small_workload"])]
    engine.run(reqs)
    out["a_engine"] = [r.out for r in reqs]
    res = train(small, steps=SHARD_TRAIN_STEPS, data_cfg=DataConfig(**spec["small_data"]),
                mesh=mesh, log_every=0)
    out["a_losses"] = res["losses"]
    del server, engine, res
    gc.collect()

    # (b) the full model in bf16
    cfg = get_config(spec["arch"]) if spec["full"] else get_smoke_config(spec["arch"])
    peak_reset()
    t0 = time.perf_counter()
    server = Server(cfg, mesh=mesh, max_batch=BATCH, max_len=MAX_LEN)
    sync()
    out["b_build_s"] = time.perf_counter() - t0
    out["b_build_peak"] = peak()  # the init draws each whole tensor in f32
    peak_reset()
    prompts = spec["prompts"]
    plen = max(map(len, prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    tokens = torch.from_numpy(toks).to(dev)
    logits, cache = server.prefill(tokens)
    if rank == 0:
        out["b_logits"] = logits.float().cpu()
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.full((), plen, dtype=torch.int32, device=dev)
    walls = []
    for step in range(3):  # the first is a warm-up; the last two are timed
        sync()
        collectives.reset_counts()
        t0 = time.perf_counter()
        nxt, cache = server.decode(nxt[:, None], pos + step, cache)
        sync()
        walls.append(time.perf_counter() - t0)
        out["b_step_collectives"] = collectives.counts()
    out["b_decode_ms"] = [1e3 * w for w in walls[1:]]
    del cache, logits
    seen = set()
    undo = record_kernel_shapes(seen)
    reset_counts()
    try:
        reqs = [Request(i, p, max_new=SHARD_NEW) for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        res = server.run_batch(reqs)
        sync()
        out["b_run_s"] = time.perf_counter() - t0
    finally:
        undo()
    out["b_launches"] = counts()
    out["b_tokens"] = [r.out for r in reqs]
    out["b_finite"] = res["logits_finite"]
    out["b_decode_steps"] = res["decode_steps"]
    out["b_peak"] = peak()
    out["b_weight_bytes"] = sum(p.numel() * p.element_size()
                                for p in server.model.parameters())
    del server
    gc.collect()

    # (c) training at full width, cut depth
    tcfg = reduced(cfg, n_layers=spec["train_layers"])
    peak_reset()
    reset_counts()
    undo = record_kernel_shapes(seen)
    try:
        t0 = time.perf_counter()
        res = train(tcfg, steps=SHARD_TRAIN_STEPS, data_cfg=DataConfig(**spec["train_data"]),
                    mesh=mesh, log_every=0)
        sync()
        out["c_s"] = time.perf_counter() - t0
    finally:
        undo()
    out["c_launches"] = counts()
    out["c_losses"], out["c_grad_norms"] = res["losses"], res["grad_norms"]
    out["c_step_s"] = res["step_s"]
    out["c_peak"] = peak()
    out["c_state_bytes"] = sum(p.numel() * p.element_size()
                               for p in res["model"].parameters()) + sum(
        t.numel() * t.element_size() for k in ("master", "m", "v")
        for t in res["opt_state"][k].values())
    out["shapes"] = sorted(seen)
    del res
    gc.collect()
    dist.barrier()
    return out


def phase_20(torch, np, dev, smi, compare, failures, arch=ARCH, full=True,
             train_layers=SHARD_TRAIN_LAYERS):
    """Sharded execution on ``SHARD_RANKS`` ranks that share ``dev`` (see
    the module docstring); ``full=False`` takes ``arch``'s smoke config for
    (b) and (c), a rehearsal on the CPU.  Returns the phase's numbers."""
    from repro_torch.configs import get_config, get_smoke_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.train import train

    t_phase = time.perf_counter()
    cfg = get_config(arch) if full else get_smoke_config(arch)
    tp, dp = SHARD_TP, SHARD_RANKS // SHARD_TP
    d, hd = cfg.d_model, cfg.head_dim_
    h, kvh = cfg.n_heads // tp, cfg.n_kv_heads // tp
    cols = {"wq": cfg.q_dim // tp, "wk, wv": cfg.kv_dim // tp,
            "w_gate, w_up": cfg.d_ff // tp}
    rows_in = {"wo": cfg.q_dim // tp, "w_down": cfg.d_ff // tp}
    v_rows = cfg.vocab_size // tp
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(16, 65, BATCH)]
    plen = max(map(len, prompts))
    print(f"[20] sharded execution: {SHARD_RANKS} ranks share {dev} over gloo on the "
          f"({dp}, {tp}) mesh; {cfg.name} shard shapes: {h} query heads over {kvh} KV heads, "
          f"columns {cols}, row-parallel contractions {rows_in}, {v_rows} vocabulary rows "
          f"of the tied head ({smi})")
    g = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        b_l = BATCH // dp
        for dtype in ("bfloat16",):
            dt = getattr(torch, dtype)
            for T in (b_l, b_l * plen, TRAIN_BATCH // dp * TRAIN_SEQ):
                x = torch.randn(T, d, device=dev, generator=g).to(dt)
                for name, n in cols.items():
                    w = (torch.randn(d, n, device=dev, generator=g) / math.sqrt(d)).to(dt)
                    compare("hbp_matmul", f"{dtype} shard {name} ({T}x{d} @ {d}x{n}) "
                            f"{mm_path(x, w)}", hbp_matmul(x, w), matmul_ref(x, w), dtype)
                for name, k in rows_in.items():
                    xk = torch.randn(T, k, device=dev, generator=g).to(dt)
                    w = (torch.randn(k, d, device=dev, generator=g) / math.sqrt(k)).to(dt)
                    compare("hbp_matmul", f"{dtype} shard {name} ({T}x{k} @ {k}x{d}) "
                            f"{mm_path(xk, w)}", hbp_matmul(xk, w), matmul_ref(xk, w), dtype)
                table = (0.02 * torch.randn(v_rows, d, device=dev, generator=g)).to(dt)
                compare("hbp_matmul", f"{dtype} shard logits ({T}x{d} @ ({v_rows}x{d})^T)",
                        hbp_matmul(x, table.T), matmul_ref(x, table.T), dtype)
                del table
            for b, sq in ((b_l, plen), (TRAIN_BATCH // dp, TRAIN_SEQ)):
                q, go = (torch.randn(b, sq, h, hd, device=dev, generator=g).to(dt)
                         for _ in "qg")
                k, v = (torch.randn(b, sq, kvh, hd, device=dev, generator=g).to(dt)
                        for _ in "kv")
                out, lse = flash_attention(q, k, v, causal=True)
                r_out, _ = flash_attention_ref(q, k, v, causal=True)
                compare("flash_attention", f"{dtype} shard causal {b}x{sq}, {h}/{kvh} heads",
                        out, r_out, dtype)
                got = flash_attention_bwd(q, k, v, out, lse, go, causal=True)
                want = flash_attention_bwd_ref(q, k, v, out, lse, go, causal=True)
                for name, x_, w_ in zip(("dq", "dk", "dv"), got, want):
                    compare("flash_attention_bwd", f"{dtype} shard {b}x{sq} {name}", x_, w_,
                            dtype)
            cache = [torch.randn(b_l, MAX_LEN, kvh, hd, device=dev, generator=g).to(dt)
                     for _ in "kv"]
            q1 = torch.randn(b_l, 1, h, hd, device=dev, generator=g).to(dt)
            lanes = torch.tensor([plen, plen - 7][:b_l], dtype=torch.int32, device=dev)
            kw = dict(causal=True, q_offset=lanes, kv_len=lanes + 1)
            compare("flash_attention", f"{dtype} shard decode {b_l}x1 over {MAX_LEN}, "
                    f"{h}/{kvh} heads", flash_attention(q1, *cache, **kw)[0],
                    flash_attention_ref(q1, *cache, **kw)[0], dtype)
            del cache, q1

    # this process's one-device references
    small = reduced(get_smoke_config(arch), dtype="float32")
    srng = np.random.default_rng(7)
    small_prompts = [srng.integers(3, small.vocab_size, n).astype(np.int32)
                     for n in (5, 11, 8, 3)]
    small_workload = [(srng.integers(3, small.vocab_size, int(srng.integers(4, 20)))
                       .astype(np.int32), int(srng.integers(2, 9))) for _ in range(6)]
    small_data = dict(global_batch=4, seq_len=16)
    one = {}
    server = Server(small, device=dev, max_batch=SHARD_SLOTS, max_len=SHARD_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(small_prompts)]
    server.run_batch(reqs)
    one["a_server"] = [r.out for r in reqs]
    engine = Engine(small, device=dev, max_batch=SHARD_SLOTS, max_len=SHARD_LEN,
                    chunk=SHARD_CHUNK)
    reqs = [Request(i, p, max_new=n) for i, (p, n) in enumerate(small_workload)]
    engine.run(reqs)
    one["a_engine"] = [r.out for r in reqs]
    one["a_losses"] = train(small, steps=SHARD_TRAIN_STEPS, device=dev, log_every=0,
                            data_cfg=DataConfig(**small_data))["losses"]
    del server, engine
    server = Server(cfg, device=dev, max_batch=BATCH, max_len=MAX_LEN)
    toks = np.zeros((BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    one["b_logits"] = server.prefill(torch.from_numpy(toks).to(dev))[0].float().cpu()
    # the same rows in the blocks each data rank prefills (K2's plan, and so
    # its bf16 roundings, follow a product's row count)
    per = BATCH // dp
    one["b_logits_blocks"] = torch.cat([
        server.prefill(torch.from_numpy(toks[i:i + per]).to(dev))[0].float().cpu()
        for i in range(0, BATCH, per)])
    reqs = [Request(i, p, max_new=SHARD_NEW) for i, p in enumerate(prompts)]
    server.run_batch(reqs)
    one["b_tokens"] = [r.out for r in reqs]
    del server
    gc.collect()
    server = Server(reduced(cfg, dtype="float32"), device=dev, max_batch=BATCH, max_len=MAX_LEN)
    one["b_logits_f32"] = server.prefill(torch.from_numpy(toks).to(dev))[0].float().cpu()
    del server
    gc.collect()
    train_data = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res = train(reduced(cfg, n_layers=train_layers), steps=SHARD_TRAIN_STEPS, device=dev,
                data_cfg=DataConfig(**train_data), log_every=0)
    one["c_losses"] = res["losses"]
    one["c_peak"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    spec = {"device": dev.type, "arch": arch, "full": full, "train_layers": train_layers,
            "prompts": prompts, "small_prompts": small_prompts,
            "small_workload": small_workload, "small_data": small_data,
            "train_data": train_data}
    t0 = time.perf_counter()
    ranks = spawn(shard_rank, SHARD_RANKS, spec, device=dev.type)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"    ranks: {[(r['rank'], r['coord'], r['device'], r['backend']) for r in ranks]}, "
          f"mesh {r0['mesh']}; spawned, ran and joined in {spawn_s:.1f} s")
    for key in ("a_server", "a_engine", "b_tokens"):
        check(all(r[key] == r0[key] for r in ranks), f"phase 20: ranks disagree on {key}")
    ok_a = r0["a_server"] == one["a_server"] and r0["a_engine"] == one["a_engine"]
    print(f"    (a) f32 smoke config: Server tokens equal to one device's "
          f"{r0['a_server'] == one['a_server']}, Engine tokens "
          f"{r0['a_engine'] == one['a_engine']}; losses {r0['a_losses']} against "
          f"{one['a_losses']} (rtol {SHARD_F32_RTOL:g})")
    check(ok_a, "phase 20 (a): sharded f32 tokens differ from one device's")
    check(np.allclose(r0["a_losses"], one["a_losses"], rtol=SHARD_F32_RTOL, atol=0),
          "phase 20 (a): sharded f32 losses differ from one device's")
    a_tol, r_tol = COMPARE_TOL["bfloat16"]

    def dist(a, b):
        return (a - b).abs().max().item()

    print(f"    (b) prefill logits' max distances: sharded - one device "
          f"{dist(r0['b_logits'], one['b_logits']):.3e}, sharded - one device in the data "
          f"ranks' row blocks {dist(r0['b_logits'], one['b_logits_blocks']):.3e}, one device "
          f"- one device in row blocks {dist(one['b_logits'], one['b_logits_blocks']):.3e}; "
          f"from the f32 model: sharded {dist(r0['b_logits'], one['b_logits_f32']):.3e}, "
          f"one device {dist(one['b_logits'], one['b_logits_f32']):.3e}")
    diff = (r0["b_logits"] - one["b_logits"]).abs()
    within = bool((diff <= a_tol + r_tol * one["b_logits"].abs()).all())
    d_shard, d_one = (dist(x, one["b_logits_f32"]) for x in (r0["b_logits"], one["b_logits"]))
    ok_b = d_shard <= SHARD_F32_DISTANCE * d_one
    agree = sum(a == b for a, b in zip(r0["b_tokens"], one["b_tokens"]))
    print(f"    (b) {cfg.name} bf16, {cfg.n_layers} layers: prefill logits of {BATCH} x {plen} "
          f"{d_shard:.3e} from the f32 model's, one device's {d_one:.3e} (gate: at most "
          f"{SHARD_F32_DISTANCE:g}x) {'ok' if ok_b else 'FAIL'}; against one device's "
          f"max_abs_err {diff.max().item():.3e} (phase 2's atol {a_tol:g} + rtol {r_tol:g}: "
          f"{'within' if within else 'beyond'}, not gated); {BATCH} requests x {SHARD_NEW} "
          f"new: completed, logits finite {r0['b_finite']}, tokens agree with one device's "
          f"on {agree} of {BATCH} (not gated); model built in "
          f"{max(r['b_build_s'] for r in ranks):.1f} s, the wave {r0['b_run_s']:.2f} s")
    check(ok_b, "phase 20 (b): sharded bf16 logits farther from the f32 model's than "
                f"{SHARD_F32_DISTANCE:g}x one device's")
    check(all(r["b_finite"] for r in ranks), "phase 20 (b): non-finite logits")
    check(all(len(t) == SHARD_NEW for t in r0["b_tokens"]), "phase 20 (b): incomplete requests")
    coll = r0["b_step_collectives"]
    print(f"    (b) a decode step: {[round(x, 3) for r in ranks for x in r['b_decode_ms']]} ms "
          f"of host wall (ranks x 2 steps, synchronised); its collectives on each rank: "
          + ", ".join(f"{k} {v['calls']} calls / {v['bytes'] / 1e6:.3f} MB"
                      for k, v in coll.items()))
    check(all(r["b_step_collectives"] == coll for r in ranks),
          "phase 20 (b): the ranks' collectives differ")
    print(f"    (b) peak memory a rank serving: {[round(r['b_peak'] / 1e9, 3) for r in ranks]} "
          f"GB, building {[round(r['b_build_peak'] / 1e9, 3) for r in ranks]} GB (its weight "
          f"blocks {r0['b_weight_bytes'] / 1e9:.3f} GB); launches on rank 0: "
          f"{ {k: v for k, v in r0['b_launches'].items() if v} }")
    ok_c = np.allclose(r0["c_losses"], one["c_losses"], rtol=SHARD_BF16_LOSS_RTOL, atol=0)
    finite = all(math.isfinite(x) for r in ranks for x in r["c_grad_norms"])
    print(f"    (c) {cfg.name} bf16 at {train_layers} layers (depth cut for time), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {r0['c_losses']} against one device's "
          f"{one['c_losses']} (rtol {SHARD_BF16_LOSS_RTOL:g}) {'ok' if ok_c else 'FAIL'}; "
          f"grad norms {r0['c_grad_norms']} finite {finite}; step host s "
          f"{[round(x, 3) for x in r0['c_step_s']]}")
    print(f"    (c) peak memory a rank: {[round(r['c_peak'] / 1e9, 3) for r in ranks]} GB "
          f"against one device's {one['c_peak'] / 1e9:.3f} GB; each rank's training state "
          f"(weights, master, m, v) {r0['c_state_bytes'] / 1e9:.3f} GB; launches on rank 0: "
          f"{ {k: v for k, v in r0['c_launches'].items() if v} }")
    check(ok_c and finite, "phase 20 (c): sharded bf16 training differs from one device's")
    shapes = sorted(set(s for r in ranks for s in r["shapes"]))
    mm_cols = sorted({sh[1][1] for sh in shapes if sh[0] == "hbp_matmul"
                      and len(sh[1]) == 2 and len(sh[1][1]) == 2})
    heads = sorted({(sh[1][0][2], sh[1][1][2]) for sh in shapes
                    if sh[0].startswith("flash_attention") and len(sh[1][0]) == 4})
    print(f"    the kernels' shard shapes: K2 operand B shapes {mm_cols}; K1 / K3 "
          f"(query heads, KV heads) {heads}")
    want_b = {(d, n) for n in (cfg.q_dim // tp, cfg.kv_dim // tp, cfg.d_ff // tp)} | {
        (cfg.q_dim // tp, d), (cfg.d_ff // tp, d), (d, v_rows)}
    check(want_b <= set(mm_cols), f"phase 20: K2 missed shard shapes {want_b - set(mm_cols)}")
    check(heads == [(h, kvh)], f"phase 20: K1 / K3 ran on heads {heads}, not ({h}, {kvh})")
    check(dev.type != "cuda" or all(
        r["b_launches"]["hbp_matmul"] and r["b_launches"]["flash_attention"]
        and r["c_launches"]["flash_attention_bwd"] for r in ranks),
        "phase 20: a rank launched no K1, K2 or K3")
    print(f"    phase 20: {time.perf_counter() - t_phase:.1f} s")
    return {"ranks": ranks, "one": one, "spec": spec}


def main():
    """The run, in a tune directory of its own (``REPRO_TUNE_DIR``, removed
    at the end): no phase replays a table an earlier run left, and phases
    1-16 run the analytic plans their numbers came from."""
    tune = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TUNE_DIR"] = tune
    try:
        return run()
    finally:
        shutil.rmtree(tune, ignore_errors=True)


def run():
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 1
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.configs import get_config, get_smoke_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import _build, planner, policy, registry
    from repro_torch.kernels.bi_fft import MAX_PASS, bi_fft, bi_fft_plain
    from repro_torch.kernels.bi_fft import split as fft_split
    from repro_torch.kernels.bi_transpose import bi_transpose, transpose_ref
    from repro_torch.kernels.bi_transpose import path as k6_path
    from repro_torch.kernels.bp_scan import bp_scan, bp_scan_plain
    from repro_torch.kernels.bp_scan import path as k5_path
    from repro_torch.kernels.bp_scan import tile as k5_tile
    from repro_torch.kernels.morton import supports_morton as morton_order
    from repro_torch.kernels.flash_attention import (HEAD_DIMS, bwd_path, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_int8,
                                                     flash_attention_ref, fwd_path)
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.kernels.hbp_matmul import path as mm_path
    from repro_torch.kernels.hbp_matmul import plan as mm_plan
    from repro_torch.launch.engine import Engine, check_lockstep_parity
    from repro_torch.launch.router import Router
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import RunOptions, build_model
    from repro_torch.kernels.strassen_matmul import matmul as matmul_entry
    from repro_torch.models.moe_layer import gapped_capacity
    from repro_torch.kernels.strassen_matmul import path as k4_path
    from repro_torch.kernels.strassen_matmul import strassen_matmul, strassen_matmul_plain
    from repro_torch.models.common import project
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime.fault_tolerance import FaultInjector

    # f32 products on the card stay full f32 (the plain versions' reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels, reset_counts, counts = launch_counters()
    serving_kernels = ("hbp_matmul", "flash_attention")
    # phase 12's entries of the kernels line: the attention kernels at hd 256
    HD256 = ("flash_attention_hd256", "flash_attention_int8_hd256", "flash_attention_bwd_hd256")
    # phase 14's entries: K1 and K3 at hd 256 with 10 query heads over 1 KV head
    REC_HD256 = ("flash_attention_hd256_recurrentgemma", "flash_attention_bwd_hd256_recurrentgemma")
    # phase 15's entries: K1 over the cross-attention of a seamless-m4t-large-v2
    # and of a llama-3.2-vision-90b decode step, K3 over a seamless training
    # step (non-causal encoder and cross-attention), K2's wmma instance over
    # its head's backward
    CROSS = ("flash_attention_cross_seamless", "flash_attention_cross_vlm",
             "flash_attention_bwd_cross", "hbp_matmul_wmma")
    registry_kernels = REGISTRY_KERNELS

    t_start = time.perf_counter()
    phase_s, running = {}, [None, t_start]

    def mark(n):
        """Stop the running phase's clock and start phase ``n``'s (None: no
        phase)."""
        now = time.perf_counter()
        if running[0] is not None:
            phase_s[running[0]] = phase_s.get(running[0], 0.0) + now - running[1]
        running[:] = [n, now]

    # -- 1. build ------------------------------------------------------------
    mark(1)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[1] built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    mma_spills = []
    for name, log in logs.items():  # ptxas -v, one line per source
        entries = ptxas_entries(log)
        print(f"    {name}: {len(entries)} kernels, at most "
              f"{max((r for _, r, _ in entries), default=0)} registers, "
              f"{sum(sp for _, _, sp in entries)} bytes of spill stores in all")
        # the tensor-core instances (K1, K1q, K3), every attention instance at
        # hd 256 (the f32 FMA ones too), K2's kernels, K6's vector one, K7's,
        # K4's and K5's
        gated = ("mm_wgmma", "mm_stream", "transpose_vec", "fft_", "strassen_", "scan_",
                 "add_offsets")
        for kern, regs, spill in entries:
            hd256 = re.match(r"flash_\w+<(?:\w+,)*256[,>]", kern)
            if hd256 or "_mma_kernel" in kern or kern.startswith(("mm_", "transpose_vec") + gated):
                print(f"      {kern}: {regs} registers, {spill} bytes of spill stores")
            if spill and (hd256 or "_mma_kernel" in kern or kern.startswith(gated)):
                mma_spills.append(kern)
    for name in _build.sources():  # tensor-core instructions in each library
        counts_, per_kernel = sass_counts(_build.library_path(name))
        print(f"    {name}: SASS has {counts_['HMMA']} HMMA and {counts_['HGMMA']} HGMMA")
        if name.startswith("flash_attention"):
            check(counts_["HMMA"] + counts_["HGMMA"] > 0,
                  f"{name}: no tensor-core instruction in its SASS")
        if name == "flash_attention":  # K1q's tensor-core kernels, one per hd
            k1q = {k: c["HMMA"] for k, c in per_kernel.items()
                   if re.fullmatch(r"flash_fwd_mma_kernel<\d+,1>", k)}
            print(f"      K1q's kernels' HMMA: {k1q}")
            check(len(k1q) == len(HEAD_DIMS) and all(k1q.values()),
                  f"flash_attention: K1q's tensor-core kernels' HMMA counts {k1q}")
        if name == "hbp_matmul":
            check(counts_["HGMMA"] > 0, "hbp_matmul: no HGMMA (wgmma) in its SASS")
    check(not mma_spills, f"the tensor-core and vector kernels spill: {mma_spills}")
    print(smi)

    # -- 2. kernels against their plain versions ------------------------------
    mark(2)
    cfg = get_config(ARCH)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    weights = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim), "wv": (d, cfg.kv_dim),
               "wo": (cfg.q_dim, d), "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = {name: 0.0 for name in (*kernels, "hbp_matmul_batched", "hbp_matmul_batched_bwd",
                                      *HD256, *REC_HD256, *CROSS)}
    failures = []
    compare = comparer(max_err, failures)

    # phase 4's prompts, drawn here so that phase 2 checks its exact shapes too
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, V, n).astype(np.int32) for n in rng.integers(16, 65, BATCH)]
    plen = max(map(len, prompts))

    T_train = TRAIN_BATCH * TRAIN_SEQ
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[2] kernels vs plain versions on the card ({ARCH} shapes; phase 4 "
          f"prefills {BATCH} x {plen} tokens, phase 6 trains on {T_train} token rows)")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for T in (4, SLOTS, 256, BATCH * plen, T_train):  # SLOTS: the engine's decode
            x = {kk: torch.randn(T, kk, device=dev, generator=g).to(dt) for kk in (d, ff)}
            for name, (kk, n) in weights.items():
                w = (torch.randn(kk, n, device=dev, generator=g) / math.sqrt(kk)).to(dt)
                compare("hbp_matmul", f"{dtype} {name} ({T}x{kk} @ {kk}x{n}) "
                        f"{mm_path(x[kk], w)}", hbp_matmul(x[kk], w), matmul_ref(x[kk], w),
                        dtype)
        table = (0.02 * torch.randn(V, d, device=dev, generator=g)).to(dt)
        for T in (4, SLOTS, T_train):
            xs = torch.randn(T, d, device=dev, generator=g).to(dt)
            compare("hbp_matmul", f"{dtype} logits ({T}x{d} @ ({V}x{d})^T view) "
                    f"{mm_path(xs, table.T)}", hbp_matmul(xs, table.T),
                    matmul_ref(xs, table.T), dtype)
        del table, xs

        for b, sq in ((BATCH, 64), (BATCH, plen), (TRAIN_BATCH, TRAIN_SEQ)):
            q = torch.randn(b, sq, h, hd, device=dev, generator=g).to(dt)
            kv = [torch.randn(b, sq, kvh, hd, device=dev, generator=g).to(dt) for _ in "kv"]
            out, lse = flash_attention(q, *kv, causal=True)
            r_out, r_lse = flash_attention_ref(q, *kv, causal=True)
            compare("flash_attention", f"{dtype} causal {b}x{sq}x{sq} out", out, r_out,
                    dtype, *((1e-5, 0.0) if dtype == "float32" else (None, None)))
            compare("flash_attention", f"{dtype} causal {b}x{sq}x{sq} lse", lse, r_lse,
                    dtype, 1e-4, 1e-5)
        q1 = torch.randn(BATCH, 1, h, hd, device=dev, generator=g).to(dt)
        cache = [torch.randn(BATCH, MAX_LEN, kvh, hd, device=dev, generator=g).to(dt)
                 for _ in "kv"]
        lane = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
        decode_cases = [
            ("decode scalar kv_len", 0, lane([100]), lane([101]), []),
            ("decode (b,) lanes, kv_len 0 lane", 0, lane([17, 255, 0, 40]),
             lane([18, 256, 0, 41]), [2]),
            ("decode window 16, fully masked row", 16, lane([100, 50, 30, 200]),
             lane([101, 51, 0, 60]), [2, 3]),
        ]
        for label, window, qo, kl, dead in decode_cases:
            out, lse = flash_attention(q1, *cache, causal=True, window=window,
                                       q_offset=qo, kv_len=kl)
            r_out, r_lse = flash_attention_ref(q1, *cache, causal=True, window=window,
                                               q_offset=qo, kv_len=kl)
            compare("flash_attention", f"{dtype} {label} out", out, r_out, dtype,
                    *((1e-5, 0.0) if dtype == "float32" else (None, None)))
            compare("flash_attention", f"{dtype} {label} lse", lse, r_lse, dtype, 1e-4, 1e-5)
            for row in dead:
                if torch.count_nonzero(out[row]).item() != 0:
                    failures.append(f"flash_attention {dtype} {label}: row {row} not exact zeros")
            if dead:
                print(f"    {'flash_attention':19s} rows {dead} exact zeros: "
                      f"{all(torch.count_nonzero(out[r]).item() == 0 for r in dead)}")

    fused_qkv_checks(torch, dev, g, compare)

    # the training path's kernels: K3, and K2 reading A as a transposed view
    print(f"[2] training kernels vs plain versions (phase 6 runs {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: {T_train} token rows)")
    # (label, b, sq, sk, window, q_offset lanes, kv_len lanes, lanes that see nothing)
    bwd_cases = [
        (f"causal {TRAIN_BATCH}x{TRAIN_SEQ} (training)", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
         0, None, None, []),
        ("causal 2x512", 2, 512, 512, 0, None, None, []),
        ("causal ragged 3x57", 3, 57, 57, 0, None, None, []),
        ("causal window 16, 2x128", 2, 128, 128, 16, None, None, []),
        ("64 rows vs 256 slots, (b,) lanes, kv_len 0 lane", 4, 64, 256, 0,
         [0, 100, 0, 150], [64, 164, 0, 214], [2]),
        ("window 16, kv_len 0 lane, fully masked rows", 4, 64, 256, 16,
         [100, 50, 30, 200], [164, 114, 0, 60], [2, 3]),
    ]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)

        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(*shape, device=dev, generator=g)).to(dt)

        for label, b, sq, sk, window, qo, kl, dead in bwd_cases:
            q, go = rnd(b, sq, h, hd), rnd(b, sq, h, hd)
            k, v = rnd(b, sk, kvh, hd), rnd(b, sk, kvh, hd)
            kw = dict(causal=True, window=window, q_offset=None if qo is None else lane(qo),
                      kv_len=None if kl is None else lane(kl))
            out, lse = flash_attention(q, k, v, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, go, **kw)
            want = flash_attention_bwd_ref(q, k, v, out, lse, go, **kw)
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                compare("flash_attention_bwd", f"{dtype} {label} {name}", x, w, dtype)
            if dead:
                zero = all(torch.count_nonzero(x[row]).item() == 0 for x in got for row in dead)
                print(f"    {'flash_attention_bwd':19s} lanes {dead}: dq, dk, dv exact zeros: {zero}")
                if not zero:
                    failures.append(f"flash_attention_bwd {dtype} {label}: lanes {dead} not zeros")
        # dW = xᵀ g: A is the transposed view of the (tokens, d_in) activation
        for label, d_in, n in (("dW wq, wo: xᵀ g", d, cfg.q_dim), ("dW wk, wv", d, cfg.kv_dim),
                               ("dW w_gate, w_up", d, ff), ("dW w_down", ff, d),
                               ("d embedᵀ (tied logits): hᵀ g", d, V)):
            act, gr = rnd(T_train, d_in), rnd(T_train, n, scale=T_train ** -0.5)
            compare("hbp_matmul", f"{dtype} {label} ({d_in}x{T_train} @ {T_train}x{n})",
                    hbp_matmul(act.T, gr), matmul_ref(act.T, gr), dtype)
            del act, gr
        # dX = g Wᵀ: B is the transposed view of the (d_in, n) weight; dH = g E
        for label, d_in, n in (("dX wq: g Wᵀ", d, cfg.q_dim), ("dX wo", cfg.q_dim, d),
                               ("dX wk, wv", d, cfg.kv_dim), ("dX w_gate, w_up", d, ff),
                               ("dX w_down", ff, d)):
            gr, w = rnd(T_train, n), rnd(d_in, n, scale=n ** -0.5)
            compare("hbp_matmul", f"{dtype} {label} ({T_train}x{n} @ ({d_in}x{n})ᵀ view)",
                    hbp_matmul(gr, w.T), matmul_ref(gr, w.T), dtype)
        gr, table = rnd(T_train, V), rnd(V, d, scale=V ** -0.5)
        compare("hbp_matmul", f"{dtype} dH (tied logits): g E ({T_train}x{V} @ {V}x{d}) "
                f"{mm_path(gr, table)}, {mm_plan(T_train, d, V, mm_path(gr, table), sms).splits} "
                "K splits",
                hbp_matmul(gr, table), matmul_ref(gr, table), dtype)
        del gr, table

    # K2 at the recurrent families' shapes (phase 14).  recurrentgemma-2b:
    # the attention blocks' and MLPs' products (the rec blocks' own are plain
    # torch, as JAX's einsums) at 14b's lockstep decode and prefill rows, the
    # engine's decode and chunk rows (SLOTS x REC_CHUNK, as many as 14c's
    # training rows), and its 256,000-row tied logits at the decode rows and
    # a cross-entropy chunk's; 14c's backward products.  mamba2-370m: its
    # 50,280-row tied logits (ragged past the last 128-row tile), forward and
    # backward at 14d's rows.
    rc, sc = get_config(REC_ARCH), get_config(SSM_ARCH)
    ring_rows = RING_BATCH * max(map(len, ring_prompts(np, rc.vocab_size)))
    rec_t = REC_TRAIN_BATCH * REC_TRAIN_SEQ
    ce = min(512, REC_TRAIN_SEQ)  # RunOptions.ce_chunk
    rec_weights = {"wq, wo": (rc.d_model, rc.q_dim), "wk, wv": (rc.d_model, rc.kv_dim),
                   "w_gate, w_up": (rc.d_model, rc.d_ff), "w_down": (rc.d_ff, rc.d_model)}
    tied = (  # (arch, config, forward rows, a cross-entropy chunk's rows)
        (REC_ARCH, rc, (RING_BATCH, SLOTS, SLOTS * REC_CHUNK), REC_TRAIN_BATCH * ce),
        (SSM_ARCH, sc, (SLOTS, SSM_TRAIN_BATCH * REC_TRAIN_SEQ), SSM_TRAIN_BATCH * ce))
    print(f"[2] K2 at {REC_ARCH}'s and {SSM_ARCH}'s shapes (phase 14: {REC_ARCH}'s "
          f"projections at rows {RING_BATCH}, {SLOTS}, {SLOTS * REC_CHUNK} and {ring_rows}, "
          f"trained at {rec_t} rows; tied logits of {rc.vocab_size} and {sc.vocab_size} rows)")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)

        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(*shape, device=dev, generator=g)).to(dt)

        for name, (kk, n) in rec_weights.items():
            w = rnd(kk, n, scale=kk ** -0.5)
            for T in (RING_BATCH, SLOTS, SLOTS * REC_CHUNK, ring_rows):
                x = rnd(T, kk)
                compare("hbp_matmul", f"{dtype} {REC_ARCH} {name} ({T}x{kk} @ {kk}x{n}) "
                        f"{mm_path(x, w)}", hbp_matmul(x, w), matmul_ref(x, w), dtype)
            act, gr = rnd(rec_t, kk), rnd(rec_t, n, scale=rec_t ** -0.5)
            compare("hbp_matmul", f"{dtype} {REC_ARCH} dW {name} ({kk}x{rec_t} @ {rec_t}x{n})",
                    hbp_matmul(act.T, gr), matmul_ref(act.T, gr), dtype)
            gr, wt = rnd(rec_t, n), rnd(kk, n, scale=n ** -0.5)
            compare("hbp_matmul", f"{dtype} {REC_ARCH} dX {name} ({rec_t}x{n} @ ({kk}x{n})ᵀ "
                    "view)", hbp_matmul(gr, wt.T), matmul_ref(gr, wt.T), dtype)
            del w, x, act, gr, wt
        for arch, c, rows, t_ce in tied:
            d_, V_ = c.d_model, c.vocab_size
            table = rnd(V_, d_, scale=0.02)
            for T in (*rows, t_ce):
                xs = rnd(T, d_)
                compare("hbp_matmul", f"{dtype} {arch} logits ({T}x{d_} @ ({V_}x{d_})^T view) "
                        f"{mm_path(xs, table.T)}", hbp_matmul(xs, table.T),
                        matmul_ref(xs, table.T), dtype)
            act, gr = rnd(t_ce, d_), rnd(t_ce, V_, scale=t_ce ** -0.5)
            compare("hbp_matmul", f"{dtype} {arch} d embedᵀ: hᵀ g ({d_}x{t_ce} @ {t_ce}x{V_})",
                    hbp_matmul(act.T, gr), matmul_ref(act.T, gr), dtype)
            gr, table = rnd(t_ce, V_), rnd(V_, d_, scale=V_ ** -0.5)
            compare("hbp_matmul", f"{dtype} {arch} dH: g E ({t_ce}x{V_} @ {V_}x{d_}) "
                    f"{mm_path(gr, table)}, {mm_plan(t_ce, d_, V_, mm_path(gr, table), sms).splits} "
                    "K splits", hbp_matmul(gr, table), matmul_ref(gr, table), dtype)
            del table, xs, act, gr

    # bf16 K1 and K3 (the tensor-core instances) where their tiles are
    # ragged: sequences that end inside a 16-row warp tile or a 64-key K/V
    # tile, a window that crosses a K/V tile, the engine's 64-row chunk and
    # decode against 512 slots with empty lanes; hd 64 and 128, GQA 16/8
    print(f"[2] bf16 K1 and K3 at the tensor-core tiles' edges (64-key K/V tiles, 16-row "
          f"query warps, 16-key dk/dv blocks; {h}/{kvh} heads)")
    edge_cases = [  # (label, b, sq, sk, hd, window, q_offset lanes, kv_len lanes, dead lanes)
        *[(f"causal 2x{sq}, hd {hd_}", 2, sq, sq, hd_, 0, None, None, [])
          for hd_ in (64, 128) for sq in (57, 65, 129)],
        ("window 40 across a K/V tile, 2x129", 2, 129, 129, hd, 40, None, None, []),
        ("64 rows vs 512 slots, q_offset 0/100/448, kv_len 0 lane", 4, 64, 512, hd, 0,
         [0, 100, 448, 0], [64, 164, 512, 0], [3]),
        ("decode vs 512 slots, kv_len 0 lane", 4, 1, 512, hd, 0, [0, 100, 511, 7],
         [1, 101, 512, 0], [3]),
    ]
    bf = torch.bfloat16
    for label, b, sq, sk, hd_, window, qo, kl, dead in edge_cases:
        q, go = (torch.randn(b, sq, h, hd_, device=dev, generator=g).to(bf) for _ in "qg")
        k, v = (torch.randn(b, sk, kvh, hd_, device=dev, generator=g).to(bf) for _ in "kv")
        kw = dict(causal=True, window=window, q_offset=None if qo is None else lane(qo),
                  kv_len=None if kl is None else lane(kl))
        out, lse = flash_attention(q, k, v, **kw)
        r_out, r_lse = flash_attention_ref(q, k, v, **kw)
        compare("flash_attention", f"bfloat16 {label} out", out, r_out, "bfloat16")
        compare("flash_attention", f"bfloat16 {label} lse", lse, r_lse, "bfloat16", 1e-4, 1e-5)
        got = flash_attention_bwd(q, k, v, out, lse, go, **kw) if sq > 1 else ()
        if got:
            want = flash_attention_bwd_ref(q, k, v, out, lse, go, **kw)
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                compare("flash_attention_bwd", f"bfloat16 {label} {name}", x, w, "bfloat16")
        if dead:
            zero = all(torch.count_nonzero(x[row]).item() == 0
                       for x in (out, *got) for row in dead)
            print(f"    {'flash_attention':19s} lanes {dead}: out{', dq, dk, dv' if got else ''} "
                  f"exact zeros: {zero}")
            if not zero:
                failures.append(f"bf16 {label}: lanes {dead} not exact zeros")
    # K3 twice on the same inputs: the same bits (one writer per element,
    # the dk/dv warps' partial sums added in a fixed order)
    q, go = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, h, hd, device=dev, generator=g).to(bf)
             for _ in "qg")
    k, v = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, kvh, hd, device=dev, generator=g).to(bf)
            for _ in "kv")
    out, lse = flash_attention(q, k, v, causal=True)
    first = flash_attention_bwd(q, k, v, out, lse, go, causal=True)
    second = flash_attention_bwd(q, k, v, out, lse, go, causal=True)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"    {'flash_attention_bwd':19s} bf16 {TRAIN_BATCH}x{TRAIN_SEQ} twice: dq, dk, dv "
          f"bit-identical: {same}")
    if not same:
        failures.append("flash_attention_bwd: two calls on the same inputs differ")
    # a head stride that is not a whole number of 16-byte steps must raise
    odd = torch.randn(2, 32, h, hd + 1, device=dev, generator=g).to(bf)[..., :hd]
    raised = []
    for what, call in (("flash_attention", lambda: flash_attention(odd, k[:2, :32], v[:2, :32])),
                       ("flash_attention_bwd", lambda: flash_attention_bwd(
                           odd, k[:2, :32], v[:2, :32], odd, lse[:2, :, :32], odd))):
        try:
            call()
        except ValueError as e:
            raised.append(what)
            print(f"    {what:19s} bf16 q with head stride {odd.stride(2)} raises: {e}")
    missing = sorted({"flash_attention", "flash_attention_bwd"} - set(raised))
    if missing:
        failures.append(f"misaligned bf16 q did not raise in {missing}")
    del q, go, k, v, out, lse, first, second, odd

    # K1q over an int8 cache quantized as the model does (per-(row, kv head)
    # scales over the slab), at phase 8's shapes
    print(f"[2] K1q vs its plain version ({SLOTS} slots, an int8 cache of "
          f"{ENGINE_LEN} positions, phase 8's decode and {CHUNK}-token chunks)")

    def int8_cache(b, kv_heads=kvh):
        return int8_cache_hd(b, kv_heads, hd, ENGINE_LEN, dev, g)

    k8, v8, ks, vs = int8_cache(SLOTS)
    decode_kl = [1, 77, 128, 255, 256, 400, ENGINE_LEN, 0]
    chunk_qo = [CHUNK * i for i in range(SLOTS)]
    q8_cases = [  # (label, sq, window, q_offset lanes, kv_len lanes, lanes that see nothing)
        ("decode (b,) lanes 1..512, kv_len 0 lane", 1, 0,
         [max(n - 1, 0) for n in decode_kl], decode_kl, [7]),
        (f"continuation chunk {CHUNK} rows, per-row q_offset", CHUNK, 0, chunk_qo,
         [o + CHUNK for o in chunk_qo], []),
        ("decode window 16, kv_len 0 lane", 1, 16, [max(n - 1, 0) for n in decode_kl],
         decode_kl, [7]),
    ]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for label, sq, window, qo, kl, dead in q8_cases:
            q = torch.randn(SLOTS, sq, h, hd, device=dev, generator=g).to(dt)
            kw = dict(causal=True, window=window, q_offset=lane(qo), kv_len=lane(kl))
            out, lse = flash_attention_int8(q, k8, v8, ks, vs, **kw)
            r_out, r_lse = flash_attention_ref(q, k8, v8, k_scale=ks, v_scale=vs, **kw)
            label = f"{fwd_path(q)} {label}"
            compare("flash_attention_int8", f"{dtype} {label} out", out, r_out, dtype)
            compare("flash_attention_int8", f"{dtype} {label} lse", lse, r_lse, dtype,
                    1e-4, 1e-5)
            if dead:
                zero = all(torch.count_nonzero(out[r]).item() == 0 for r in dead)
                print(f"    {'flash_attention_int8':19s} rows {dead} exact zeros: {zero}")
                if not zero:
                    failures.append(f"flash_attention_int8 {dtype} {label}: rows {dead}")
    # an int8 cache whose head stride (hd + 8) is no whole 16-byte step: the
    # tensor-core instance must raise
    wide8 = torch.zeros(SLOTS, CHUNK, kvh, hd + 8, dtype=torch.int8, device=dev)[..., :hd]
    try:
        flash_attention_int8(torch.zeros(SLOTS, 1, h, hd, dtype=bf, device=dev), wide8, wide8,
                             ks, vs)
        failures.append("flash_attention_int8: a misaligned int8 cache did not raise")
    except ValueError as e:
        print(f"    {'flash_attention_int8':19s} int8 cache with head stride {wide8.stride(2)} "
              f"raises: {e}")
    del k8, v8, wide8

    # the batched K2: the MoE experts' products, every expert's slab in one
    # launch, at phase 11's shapes (qwen3-moe-30b-a3b's 8-row decode slabs and
    # its 512-row chunk's 40-row slabs, olmoe-1b-7b's 80-row chunk slabs) and
    # at slab and row counts that match no tile
    batched_cases = [  # (label, slabs, rows, k, n)
        (f"{MOE_ARCH} decode gate/up", 128, 8, 2048, 768),
        (f"{MOE_ARCH} decode down", 128, 8, 768, 2048),
        (f"{MOE_ARCH} 512-row chunk gate/up", 128, 40, 2048, 768),
        (f"{MOE_ARCH} 512-row chunk down", 128, 40, 768, 2048),
        (f"{OLMOE_ARCH} 512-row chunk gate/up", 64, 80, 2048, 1024),
        ("ragged slabs", 3, 13, 72, 104), ("ragged slabs", 5, 37, 136, 72),
        ("ragged slabs, b's pitch 100", 3, 13, 72, 100)]
    print("[2] batched K2 vs its plain version (C[e] = A[e] @ B[e], one launch)")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for label, e, m, k, n in batched_cases:
            a = torch.randn(e, m, k, device=dev, generator=g).to(dt)
            b = (torch.randn(e, k, n, device=dev, generator=g) / math.sqrt(k)).to(dt)
            before = (hbp_matmul.launches, hbp_matmul.batched_launches)
            got = hbp_matmul(a, b)
            if (hbp_matmul.launches - before[0], hbp_matmul.batched_launches - before[1]) != (1, 1):
                failures.append(f"hbp_matmul_batched {label}: not one batched launch")
            compare("hbp_matmul_batched", f"{dtype} {label} ({e}x{m}x{k} @ {e}x{k}x{n}) "
                    f"{mm_path(a, b)}", got, matmul_ref(a, b), dtype)
            del a, b, got

    # the batched K2's backward: dA = g Bᵀ and dB = Aᵀ g per slab, one batched
    # launch each on transposed slab views, at olmoe-1b-7b's three expert
    # products and the capacities of phase 13's 4 x 128 tokens (80), of 2 x
    # 1024 (320) and of the 40-row prefill slabs.  dB contracts over the
    # capacity, which no K step of 64 divides but 320; every slab holds
    # nonzero data, so a last K step that read the next slab's rows shows.
    ocfg = get_config(OLMOE_ARCH)
    o_e, o_d, o_f = ocfg.n_experts, ocfg.d_model, ocfg.expert_d_ff
    caps = [gapped_capacity(TRAIN_BATCH * TRAIN_SEQ, o_e, ocfg.experts_per_token,
                            ocfg.capacity_factor),
            gapped_capacity(2 * 1024, o_e, ocfg.experts_per_token, ocfg.capacity_factor), 40]
    print(f"[2] batched K2 backward vs its plain version ({OLMOE_ARCH}: {o_e} experts, "
          f"d {o_d}, expert d_ff {o_f}; capacities {caps})")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for c_ in caps:
            for name, k, n in (("gate", o_d, o_f), ("up", o_d, o_f), ("down", o_f, o_d)):
                a = torch.randn(o_e, c_, k, device=dev, generator=g).to(dt).requires_grad_()
                b = (torch.randn(o_e, k, n, device=dev, generator=g) / math.sqrt(k)).to(dt)
                b.requires_grad_()
                gy = torch.randn(o_e, c_, n, device=dev, generator=g).to(dt)
                y = matmul_entry(a, b)
                before = (hbp_matmul.batched_launches, matmul_entry.batched_backward_launches)
                y.backward(gy)
                if (hbp_matmul.batched_launches - before[0],
                        matmul_entry.batched_backward_launches - before[1]) != (2, 2):
                    failures.append(f"hbp_matmul_batched_bwd {name} C{c_}: not two batched "
                                    "launches")
                with torch.no_grad():
                    shape = f"{o_e}x{c_}x{k} @ {o_e}x{k}x{n}"
                    compare("hbp_matmul_batched_bwd", f"{dtype} {name} C{c_} dA ({shape}) "
                            f"{mm_path(gy, b.mT)}", a.grad, matmul_ref(gy, b.mT), dtype)
                    compare("hbp_matmul_batched_bwd", f"{dtype} {name} C{c_} dB "
                            f"{mm_path(a.mT, gy)}", b.grad, matmul_ref(a.mT, gy), dtype)
                del a, b, gy, y

    # K1 and K1q at the dense family's other GQA ratios (query / KV heads:
    # 32/4, 64/8, 40/8, 16/16), at phase 8's decode lanes and continuation
    # chunks, hd 128
    ratios = sorted({(get_config(a).n_heads, get_config(a).n_kv_heads) for a in FAMILY_ARCHS})
    print(f"[2] K1 and K1q at the GQA ratios of {', '.join(FAMILY_ARCHS)}: heads {ratios}, "
          f"{SLOTS} slots, caches of {ENGINE_LEN}")
    for h_, kvh_ in ratios:
        k8, v8, ks, vs = int8_cache(SLOTS, kvh_)
        kf = [torch.randn(SLOTS, ENGINE_LEN, kvh_, hd, device=dev, generator=g) for _ in "kv"]
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            kb, vb = (x.to(dt) for x in kf)
            for label, sq, _, qo, kl, _ in q8_cases[:2]:
                q = torch.randn(SLOTS, sq, h_, hd, device=dev, generator=g).to(dt)
                kw = dict(causal=True, q_offset=lane(qo), kv_len=lane(kl))
                tag = f"{dtype} {h_}/{kvh_} heads {fwd_path(q)} {label}"
                out, lse = flash_attention(q, kb, vb, **kw)
                r_out, r_lse = flash_attention_ref(q, kb, vb, **kw)
                compare("flash_attention", f"{tag} out", out, r_out, dtype,
                        *((1e-5, 0.0) if dtype == "float32" else (None, None)))
                compare("flash_attention", f"{tag} lse", lse, r_lse, dtype, 1e-4, 1e-5)
                out, lse = flash_attention_int8(q, k8, v8, ks, vs, **kw)
                r_out, r_lse = flash_attention_ref(q, k8, v8, k_scale=ks, v_scale=vs, **kw)
                compare("flash_attention_int8", f"{tag} out", out, r_out, dtype)
                compare("flash_attention_int8", f"{tag} lse", lse, r_lse, dtype, 1e-4, 1e-5)
        del k8, v8, kf, kb, vb

    # K1, K1q and K3 at gemma3-1b's head dim 256 (32-key K/V tiles, Q read
    # from shared memory at each k-step, K3's dq and dk/dv in column halves),
    # 4 query heads over 1 KV head, its 512-key window and its global layers:
    # decode lanes over phase 12's 2048-position cache with kv_len past the
    # window (and a kv_len 0 lane), a 64-row continuation chunk, the training
    # shape and sequences that end inside a tile
    gcfg = get_config(GEMMA_ARCH)
    gh, gkvh, ghd, gwin = gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim_, gcfg.sliding_window
    print(f"[2] K1, K1q and K3 at hd {ghd} ({GEMMA_ARCH}: {gh}/{gkvh} heads, window {gwin} "
          f"and global; {SLOTS} slots over {GEMMA_LEN} positions, training "
          f"{GEMMA_TRAIN_BATCH} x {GEMMA_TRAIN_SEQ})")
    g_qo = [0, 511, 700, 1500, GEMMA_LEN - 1, 100, 1023, 0]
    g_kl = [p + 1 for p in g_qo[:-1]] + [0]
    g_cq = [0, 448, 900, GEMMA_LEN - CHUNK, 64, 1200, 1600, 0]
    g_fwd = [  # (label, sq, q_offset lanes, kv_len lanes, dead lanes)
        (f"decode {SLOTS}x1 vs {GEMMA_LEN}, kv_len 0 lane", 1, g_qo, g_kl, [7]),
        (f"chunk {SLOTS}x{CHUNK} vs {GEMMA_LEN}, kv_len 0 lane", CHUNK, g_cq,
         [p + CHUNK for p in g_cq[:-1]] + [0], [7]),
    ]
    g_bwd = [  # (label, b, sq, window)
        *[(f"training {GEMMA_TRAIN_BATCH}x{GEMMA_TRAIN_SEQ} window {w}", GEMMA_TRAIN_BATCH,
           GEMMA_TRAIN_SEQ, w) for w in (gwin, 0)],
        *[(f"ragged 2x{sq}", 2, sq, 0) for sq in (57, 65, 129)],
        ("ragged 2x129 window 40 across a K/V tile", 2, 129, 40),
    ]
    gk8, gv8, gks, gvs = int8_cache_hd(SLOTS, gkvh, ghd, GEMMA_LEN, dev, g)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        f32 = dtype == "float32"
        kf = [torch.randn(SLOTS, GEMMA_LEN, gkvh, ghd, device=dev, generator=g).to(dt)
              for _ in "kv"]
        for label, sq, qo, kl, dead in g_fwd:
            q = torch.randn(SLOTS, sq, gh, ghd, device=dev, generator=g).to(dt)
            for window in (gwin, 0):
                kw = dict(causal=True, window=window, q_offset=lane(qo), kv_len=lane(kl))
                tag = f"{dtype} {fwd_path(q)} {label}, window {window}"
                out, lse = flash_attention(q, *kf, **kw)
                r_out, r_lse = flash_attention_ref(q, *kf, **kw)
                compare("flash_attention_hd256", f"{tag} out", out, r_out, dtype,
                        *((1e-5, 0.0) if f32 else (None, None)))
                compare("flash_attention_hd256", f"{tag} lse", lse, r_lse, dtype, 1e-4, 1e-5)
                q8_out, q8_lse = flash_attention_int8(q, gk8, gv8, gks, gvs, **kw)
                r_out8, r_lse8 = flash_attention_ref(q, gk8, gv8, k_scale=gks, v_scale=gvs, **kw)
                compare("flash_attention_int8_hd256", f"{tag} out", q8_out, r_out8, dtype)
                compare("flash_attention_int8_hd256", f"{tag} lse", q8_lse, r_lse8, dtype,
                        1e-4, 1e-5)
                for x in (out, q8_out):
                    if any(torch.count_nonzero(x[r]).item() for r in dead):
                        failures.append(f"hd {ghd} {tag}: lanes {dead} not exact zeros")
        del kf
        for label, b, sq, window in g_bwd:
            q, go = (torch.randn(b, sq, gh, ghd, device=dev, generator=g).to(dt) for _ in "qg")
            k, v = (torch.randn(b, sq, gkvh, ghd, device=dev, generator=g).to(dt) for _ in "kv")
            kw = dict(causal=True, window=window)
            out, lse = flash_attention(q, k, v, **kw)
            r_out, r_lse = flash_attention_ref(q, k, v, **kw)
            tag = f"{dtype} {label}"
            compare("flash_attention_hd256", f"{tag} out", out, r_out, dtype,
                    *((1e-5, 0.0) if f32 else (None, None)))
            compare("flash_attention_hd256", f"{tag} lse", lse, r_lse, dtype, 1e-4, 1e-5)
            got = flash_attention_bwd(q, k, v, out, lse, go, **kw)
            want = flash_attention_bwd_ref(q, k, v, out, lse, go, **kw)
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                compare("flash_attention_bwd_hd256", f"{tag} {bwd_path(q)} {name}", x, w, dtype)
            if dtype == "bfloat16" and sq == GEMMA_TRAIN_SEQ and window:
                again = flash_attention_bwd(q, k, v, out, lse, go, **kw)
                same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
                print(f"    {'flash_attention_bwd_hd256':26s} {tag} twice: dq, dk, dv "
                      f"bit-identical: {same}")
                if not same:
                    failures.append(f"flash_attention_bwd hd {ghd}: two calls differ")
            del q, go, k, v, out, lse, got, want
    del gk8, gv8, gks, gvs

    # K1 and K3 at recurrentgemma-2b's shapes (phase 14): 10 query heads over 1
    # KV head at hd 256 (two-head groups in the tensor-core instances, five of
    # them), decode lanes over a 2048-slot ring (wrapped rows at q_offset
    # past sk with kv_len = C, unwrapped rows, an empty lane; no window mask,
    # as the model attends a ring) and over the linear 4096-slot cache with
    # the 2048-key window, and the 2 x 1024 training shape with window 2048
    rcfg = get_config(REC_ARCH)
    rh, rkvh, rhd, rwin = rcfg.n_heads, rcfg.n_kv_heads, rcfg.head_dim_, rcfg.sliding_window
    print(f"[2] K1 and K3 at hd {rhd} ({REC_ARCH}: {rh}/{rkvh} heads; a {rwin}-slot ring, "
          f"the {REC_LEN}-slot linear cache with window {rwin}, training "
          f"{REC_TRAIN_BATCH} x {REC_TRAIN_SEQ})")
    r_pos = [2100, REC_LEN - 1, rwin - 1, 0, 3000, 100, rwin, 0]
    r_fwd = [  # (label, cache slots, window, q_offset lanes, kv_len lanes, dead lanes)
        (f"decode {SLOTS}x1 vs a {rwin}-slot ring (wrapped: q_offset past sk), kv_len 0 lane",
         rwin, 0, r_pos, [min(p + 1, rwin) for p in r_pos[:-1]] + [0], [7]),
        (f"decode {SLOTS}x1 vs {REC_LEN} slots, window {rwin}, kv_len 0 lane", REC_LEN, rwin,
         r_pos, [p + 1 for p in r_pos[:-1]] + [0], [7]),
    ]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        f32 = dtype == "float32"
        for label, slots, window, qo, kl, dead in r_fwd:
            q = torch.randn(SLOTS, 1, rh, rhd, device=dev, generator=g).to(dt)
            kf = [torch.randn(SLOTS, slots, rkvh, rhd, device=dev, generator=g).to(dt)
                  for _ in "kv"]
            kw = dict(causal=True, window=window, q_offset=lane(qo), kv_len=lane(kl))
            tag = f"{dtype} {fwd_path(q)} {label}"
            out, lse = flash_attention(q, *kf, **kw)
            r_out, r_lse = flash_attention_ref(q, *kf, **kw)
            compare("flash_attention_hd256_recurrentgemma", f"{tag} out", out, r_out, dtype,
                    *((1e-5, 0.0) if f32 else (None, None)))
            compare("flash_attention_hd256_recurrentgemma", f"{tag} lse", lse, r_lse, dtype,
                    1e-4, 1e-5)
            if any(torch.count_nonzero(out[r]).item() for r in dead):
                failures.append(f"{REC_ARCH} {tag}: lanes {dead} not exact zeros")
            del q, kf
        B, S = REC_TRAIN_BATCH, REC_TRAIN_SEQ
        q, go = (torch.randn(B, S, rh, rhd, device=dev, generator=g).to(dt) for _ in "qg")
        k, v = (torch.randn(B, S, rkvh, rhd, device=dev, generator=g).to(dt) for _ in "kv")
        kw = dict(causal=True, window=rwin)
        out, lse = flash_attention(q, k, v, **kw)
        r_out, r_lse = flash_attention_ref(q, k, v, **kw)
        tag = f"{dtype} training {B}x{S} window {rwin}"
        compare("flash_attention_hd256_recurrentgemma", f"{tag} out", out, r_out, dtype,
                *((1e-5, 0.0) if f32 else (None, None)))
        got = flash_attention_bwd(q, k, v, out, lse, go, **kw)
        want = flash_attention_bwd_ref(q, k, v, out, lse, go, **kw)
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            compare("flash_attention_bwd_hd256_recurrentgemma", f"{tag} {bwd_path(q)} {name}",
                    x, w, dtype)
        del q, go, k, v, out, lse, got, want
    cross_kernel_checks(torch, dev, g, compare, failures)
    torch.cuda.synchronize()
    check(not failures, f"kernels disagree with their plain versions: {failures}")

    # -- 3. small parity: cuda vs cpu, f32 smoke config ------------------------
    mark(3)
    small = reduced(get_smoke_config(ARCH), dtype="float32")
    host_model = build_model(small, device="cpu")
    host_model.init(torch.Generator().manual_seed(0))
    params = host_model.state_dict()
    small_rng = np.random.default_rng(1)
    small_prompts = [small_rng.integers(3, small.vocab_size, n).astype(np.int32)
                     for n in (5, 9, 12, 7)]
    tokens = {}
    for where in ("cuda", "cpu"):
        srv = Server(small, device=where, params=params, max_batch=BATCH, max_len=64)
        reqs = [Request(i, p, max_new=12) for i, p in enumerate(small_prompts)]
        srv.run_batch(reqs)
        tokens[where] = [r.out for r in reqs]
    print(f"[3] smoke f32 greedy tokens cuda == cpu: {tokens['cuda'] == tokens['cpu']} "
          f"({sum(map(len, tokens['cuda']))} tokens)")
    check(tokens["cuda"] == tokens["cpu"],
          f"cuda tokens {tokens['cuda']} != cpu tokens {tokens['cpu']}")
    smoke_autotune_checks(torch, small, params, small_prompts, tokens["cpu"],
                          Path(os.environ["REPRO_TUNE_DIR"]) / "phase3")

    # one f32 training step of the smoke config, card vs CPU, same params; then
    # of olmoe-1b-7b's (routers, the sort dispatch's gathers, the expert
    # products' backward on the batched fma instance)
    osmall = reduced(get_smoke_config(OLMOE_ARCH), dtype="float32")
    omodel = build_model(osmall, device="cpu")
    omodel.init(torch.Generator().manual_seed(0))
    # and of the recurrent families' (phase 14's paths: the RG-LRU scan, the
    # conv, K1 and K3 at the hybrid's local attention; the SSD chunks)
    rec_small = {}
    for arch in (REC_ARCH, SSM_ARCH):
        rcfg = reduced(get_smoke_config(arch), dtype="float32")
        rmodel = build_model(rcfg, device="cpu")
        rmodel.init(torch.Generator().manual_seed(0))
        rec_small[arch] = (rcfg, rmodel.state_dict())
    del rmodel
    for arch, tcfg, tparams in ((ARCH, small, params), (OLMOE_ARCH, osmall, omodel.state_dict()),
                                *((a, c, p) for a, (c, p) in rec_small.items())):
        smoke_batch = SyntheticLMDataset(DataConfig(global_batch=4, seq_len=32),
                                         tcfg).batch_at(0)
        runs = {}
        for where in ("cuda", "cpu"):
            m = build_model(tcfg, device=where)
            m.load_state_dict(tparams)
            b = {key: torch.from_numpy(x).to(where) for key, x in smoke_batch.items()}
            reset_counts()
            loss = m.loss(b)
            loss.backward()
            bwd_launches = counts()["hbp_matmul_batched_bwd"]
            grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
            m.zero_grad(set_to_none=True)
            _, metrics = make_train_step(m)(adamw_init(dict(m.named_parameters())), b)
            runs[where] = dict(loss=loss.item(), grads=grads, step_loss=metrics["loss"].item(),
                               params={n: p.detach().cpu() for n, p in m.named_parameters()},
                               bwd_launches=bwd_launches)
        c, h_ = runs["cuda"], runs["cpu"]
        g_atol, g_rtol = SMOKE_GRAD_TOL
        grad_err = max((c["grads"][n] - x).abs().max().item() for n, x in h_["grads"].items())
        grads_ok = all(torch.allclose(c["grads"][n], x, rtol=g_rtol, atol=g_atol)
                       for n, x in h_["grads"].items())
        opt = AdamWConfig()
        clip = {key: min(1.0, opt.grad_clip / math.sqrt(sum(x.double().square().sum().item()
                                                            for x in r["grads"].values())))
                for key, r in (("cuda", c), ("cpu", h_))}
        param_err, param_ok, n_elems, n_small, n_loose, n_vacuous = 0.0, True, 0, 0, 0, 0
        for n, x in h_["params"].items():
            ga, gb = c["grads"][n] * clip["cuda"], h_["grads"][n] * clip["cpu"]
            m = torch.where(ga * gb > 0, torch.minimum(ga.abs(), gb.abs()), 0.0)
            grad_term = opt.lr * (ga - gb).abs() / (m + opt.eps)
            diff = (c["params"][n] - x).abs()
            param_err = max(param_err, diff.max().item())
            param_ok &= bool((diff <= SMOKE_PARAM_ATOL + grad_term).all())
            n_elems += x.numel()
            n_small += int((h_["grads"][n].abs() <= 100 * opt.eps).sum())
            n_loose += int((grad_term > SMOKE_PARAM_ATOL).sum())
            n_vacuous += int((grad_term >= 2 * opt.lr).sum())
        loss_ok = all(abs(c[key] - h_[key]) <= SMOKE_LOSS_RTOL * abs(h_[key])
                      for key in ("loss", "step_loss"))
        want_bwd = 6 * tcfg.n_layers if tcfg.n_experts else 0  # 3 products, dA and dB
        print(f"[3] smoke f32 {arch} training step cuda vs cpu: loss {c['loss']:.7f} vs "
              f"{h_['loss']:.7f} (rtol {SMOKE_LOSS_RTOL:g}) {'ok' if loss_ok else 'FAIL'}; "
              f"{len(h_['grads'])} grads, max abs err {grad_err:.3e} (atol {g_atol:g} + rtol "
              f"{g_rtol:g}) {'ok' if grads_ok else 'FAIL'}; params after one AdamW step max "
              f"abs err {param_err:.3e} (each within {SMOKE_PARAM_ATOL:g} + lr |a - b| / "
              f"(m + eps)) {'ok' if param_ok else 'FAIL'}; batched backward launches "
              f"{c['bwd_launches']} (expected {want_bwd})")
        print(f"    of {n_elems} parameters: {n_small} with |g| <= {100 * opt.eps:g} on the CPU; "
              f"{n_loose} held to more than {SMOKE_PARAM_ATOL:g} by their gradient gap, "
              f"{n_vacuous} of them to 2 lr or more (no bound)")
        check(loss_ok and grads_ok and param_ok and c["bwd_launches"] == want_bwd,
              f"the {arch} smoke training step disagrees between the card and the CPU")
    del omodel

    # the continuous-batching engine on the smoke config, fp and int8 caches:
    # card == CPU == each request alone through the lockstep path, and a run
    # under an injected fault plan == the clean run.  chunk >= the longest
    # prompt for int8, so the engine calibrates its scales on the whole
    # prompt as the lockstep prefill does.
    def smoke_requests(n):
        r = np.random.default_rng(0)
        return [Request(i, r.integers(3, small.vocab_size, int(r.integers(4, 20))).astype(np.int32),
                        max_new=int(r.integers(2, 9))) for i in range(n)]

    for cache_kind, chunk, n_req in (("fp", 8, 6), ("int8", 24, 4)):
        with policy.apply(**(INT8 if cache_kind == "int8" else {})):
            got = {}
            for where, plan in (("cuda", ""), ("cpu", ""), ("cuda faults", FAULT_PLAN)):
                eng = Engine(small, device=where.split()[0], params=params, max_batch=3,
                             max_len=64, chunk=chunk, injector=FaultInjector(plan))
                reqs = smoke_requests(n_req)
                out = eng.run(reqs)
                got[where] = [r.out for r in reqs]
                if where == "cuda":
                    check(eng.cache.quantized == (cache_kind == "int8"),
                          f"the {cache_kind} engine built the wrong cache")
                    lockstep = check_lockstep_parity(eng, reqs)
                if plan:
                    faults = out["stats"]["faults"]
        ok = got["cuda"] == got["cpu"] == got["cuda faults"] and lockstep
        print(f"[3] smoke f32 engine, {cache_kind} cache (chunk {chunk}, {n_req} requests, "
              f"3 slots): cuda == cpu {got['cuda'] == got['cpu']}, == lockstep on cuda "
              f"{lockstep}, == cuda under '{FAULT_PLAN}' {got['cuda'] == got['cuda faults']} "
              f"(retries {faults['retries']}, slots poisoned {faults['slots_poisoned']}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok and faults["retries"] == 1 and faults["slots_poisoned"] == 1,
              f"smoke engine ({cache_kind} cache): tokens {got}, lockstep parity {lockstep}, "
              f"faults {faults}")

    # the fleet Router on the smoke config at f32 (2 replicas of 2 slots,
    # chunk 8, snapshot every 2): both arms and the death plan, each on the
    # card and on the CPU, replica 0 holding ``params``; card == CPU == a
    # clean single engine's tokens, and the same placements and counters
    fleet_kw = dict(max_batch=2, max_len=64, chunk=8, snapshot_every=2)
    single = Engine(small, device="cuda", params=params, injector=FaultInjector(""), **fleet_kw)
    reqs = smoke_requests(6)
    single.run(reqs)
    alone = [r.out for r in reqs]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_router_") as tmp:
        for label, rkw in (("pws", {}), ("rws", dict(route="rws", seed=5)),
                           ("death", dict(fleet_faults=SMOKE_FLEET_DEATH))):
            got = {}
            for where in ("cuda", "cpu"):
                router = Router(small, device=where, n_replicas=2, params=params,
                                ckpt_dir=f"{tmp}/{label}_{where}", **rkw, **fleet_kw)
                reqs = smoke_requests(6)
                res = router.run(reqs)
                got[where] = ([r.out for r in reqs], res["placements"], res["counters"])
            c = got["cuda"][2]
            ok = (got["cuda"][0] == got["cpu"][0] == alone and got["cuda"][1:] == got["cpu"][1:]
                  and (label != "death" or (c["replica_deaths"], c["replica_restarts"]) == (1, 1)))
            print(f"[3] smoke f32 Router ({label}): cuda == cpu == single engine tokens "
                  f"{got['cuda'][0] == got['cpu'][0] == alone}, same placements and counters "
                  f"{got['cuda'][1:] == got['cpu'][1:]} (deaths {c['replica_deaths']}, restarts "
                  f"{c['replica_restarts']}, migrations {c['migrations']}) {'ok' if ok else 'FAIL'}")
            check(ok, f"smoke Router ({label}): {got}, single engine {alone}")
    del single, router

    # the rest of the dense family's smoke configs at f32: one set of
    # parameters, card == CPU tokens through the Engine (the MoE configs'
    # expert products on the batched fma instance), and through the lockstep
    # Server for qwen2.5-14b (QKV bias, untied head)
    for arch in FAMILY_ARCHS:
        fam = reduced(get_smoke_config(arch), dtype="float32")
        fam_model = build_model(fam, device="cpu")
        fam_model.init(torch.Generator().manual_seed(0))
        fam_params = fam_model.state_dict()
        got = {}
        for where in ("cuda", "cpu"):
            eng = Engine(fam, device=where, params=fam_params, max_batch=3, max_len=64,
                         chunk=8)
            reqs = smoke_requests(6)
            eng.run(reqs)
            got[where] = [r.out for r in reqs]
            if arch == "qwen2.5-14b":
                srv = Server(fam, device=where, params=fam_params, max_batch=BATCH, max_len=64)
                reqs = [Request(i, p, max_new=12) for i, p in enumerate(small_prompts)]
                srv.run_batch(reqs)
                got[f"{where} lockstep"] = [r.out for r in reqs]
        ok = all(got[key] == got[key.replace("cuda", "cpu")] for key in got if "cuda" in key)
        print(f"[3] smoke f32 {arch} ({fam.n_experts or 'no'} experts, qkv_bias "
              f"{fam.qkv_bias}, untied head): cuda == cpu through the Engine "
              f"{got['cuda'] == got['cpu']}"
              + (f", through the Server {got['cuda lockstep'] == got['cpu lockstep']}"
                 if "cuda lockstep" in got else "")
              + f" ({sum(map(len, got['cuda']))} tokens) {'ok' if ok else 'FAIL'}")
        check(ok, f"smoke {arch}: card and CPU tokens differ: {got}")
    del fam_model, fam_params, eng

    # gemma3-1b's smoke config at f32 (windows of 8 on 2 of every 3 layers, a
    # local RoPE theta, scaled embeddings): card == CPU tokens through the
    # Engine with the fp and the int8 cache (chunk 5, which does not divide
    # the window) and through the Server, prompts past the window
    gsmall = reduced(get_smoke_config(GEMMA_ARCH), dtype="float32")
    gmodel = build_model(gsmall, device="cpu")
    gmodel.init(torch.Generator().manual_seed(0))
    gparams = gmodel.state_dict()
    g_prompts = [small_rng.integers(3, gsmall.vocab_size, n).astype(np.int32)
                 for n in (12, 9, 17, 10)]
    got = {}
    for where in ("cuda", "cpu"):
        for cache_kind in ("fp", "int8"):
            with policy.apply(**(INT8 if cache_kind == "int8" else {})):
                eng = Engine(gsmall, device=where, params=gparams, max_batch=3, max_len=64,
                             chunk=5)
                reqs = smoke_requests(6)
                eng.run(reqs)
            got[f"{where} {cache_kind}"] = [r.out for r in reqs]
        srv = Server(gsmall, device=where, params=gparams, max_batch=BATCH, max_len=64)
        reqs = [Request(i, p, max_new=12) for i, p in enumerate(g_prompts)]
        srv.run_batch(reqs)
        got[f"{where} lockstep"] = [r.out for r in reqs]
    same = {key: got[f"cuda {key}"] == got[f"cpu {key}"] for key in ("fp", "int8", "lockstep")}
    past = sum(len(r.prompt) > gsmall.sliding_window for r in smoke_requests(6))
    print(f"[3] smoke f32 {GEMMA_ARCH} (hd {gsmall.head_dim_}, window {gsmall.sliding_window}, "
          f"global every {gsmall.global_every}; {past}/6 engine prompts and prompts "
          f"{[len(p) for p in g_prompts]} past the window): cuda == cpu through the Engine, "
          f"fp cache {same['fp']}, int8 cache {same['int8']}; through the Server "
          f"{same['lockstep']} ({sum(map(len, got['cuda fp']))} + "
          f"{sum(map(len, got['cuda lockstep']))} tokens) {'ok' if all(same.values()) else 'FAIL'}")
    check(all(same.values()), f"smoke {GEMMA_ARCH}: card and CPU tokens differ: {got}")
    del gmodel, gparams, eng, srv

    # the recurrent families' smoke configs at f32: card == CPU tokens through
    # the Engine (the hybrid at chunk 5 against windows of 8, the SSM at its
    # SSD chunk of 8) and the Server (the hybrid with the linear cache and
    # with the 8-slot ring, which the prompts wrap)
    for arch, (rcfg, rparams) in rec_small.items():
        hybrid = rcfg.family == "hybrid"
        layouts = [("linear", None)] + ([("ring", RunOptions(windowed_decode_cache=True))]
                                        if hybrid else [])
        got = {}
        for where in ("cuda", "cpu"):
            eng = Engine(rcfg, device=where, params=rparams, max_batch=3, max_len=64,
                         chunk=5 if hybrid else rcfg.ssm_chunk)
            reqs = smoke_requests(6)
            eng.run(reqs)
            got[f"{where} engine"] = [r.out for r in reqs]
            for layout, opts in layouts:
                srv = Server(rcfg, device=where, params=rparams, max_batch=BATCH, max_len=64,
                             opts=opts)
                reqs = [Request(i, p, max_new=12) for i, p in enumerate(g_prompts)]
                srv.run_batch(reqs)
                got[f"{where} {layout}"] = [r.out for r in reqs]
        same = {key.split()[1]: got[key] == got[key.replace("cuda", "cpu")]
                for key in got if key.startswith("cuda")}
        print(f"[3] smoke f32 {arch} ({rcfg.family}): cuda == cpu through the Engine "
              f"{same['engine']}, through the Server "
              f"{ {k: v for k, v in same.items() if k != 'engine'} } "
              f"({sum(map(len, got['cuda engine']))} + {sum(map(len, got['cuda linear']))} "
              f"tokens) {'ok' if all(same.values()) else 'FAIL'}")
        check(all(same.values()), f"smoke {arch}: card and CPU tokens differ: {got}")
    del rec_small, eng, srv

    # -- 4. full width ----------------------------------------------------------
    mark(4)
    t0 = time.perf_counter()
    server = Server(cfg, device="cuda", max_batch=BATCH, max_len=MAX_LEN)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.zeros((BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    toks = torch.from_numpy(toks).to(dev)

    # launches per prefill and per decode step (also the warm-up)
    reset_counts()
    logits, kvc = server.model.prefill({"tokens": toks}, MAX_LEN)
    per_prefill = counts()
    reset_counts()
    server.model.decode_step(logits.argmax(-1).to(torch.int32)[:, None],
                             torch.tensor(plen, dtype=torch.int32, device=dev), kvc)
    per_step = counts()
    torch.cuda.synchronize()
    del logits, kvc

    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = server.run_batch(reqs)
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[4] {ARCH} full width bf16 ({cfg.n_layers} layers, d={d}, {h}/{kvh} heads, "
          f"hd={hd}, d_ff={ff}, vocab={V}); init {init_s:.2f} s; prompts "
          f"{[len(p) for p in prompts]}; max_len {MAX_LEN}")
    print(f"    completed {out['completed']}; logits finite {out['logits_finite']}; "
          f"peak memory {peak_gb:.2f} GB")
    print(f"    launches in the run {launches}; per prefill {per_prefill}; "
          f"per decode step {per_step}")
    print(f"    prefill {1e3 * out['prefill_s']:.3f} ms; decode "
          f"{1e3 * out['decode_s'] / max(out['decode_steps'], 1):.3f} ms/step over "
          f"{out['decode_steps']} steps; {out['tok_per_s']:.1f} tok/s "
          f"({out['tokens']} tokens in {out['wall_s']:.3f} s)")
    check(all(len(r.out) == MAX_NEW for r in reqs), f"short requests: {out['completed']}")
    check(out["logits_finite"], "non-finite logits in the full-width run")
    for name in serving_kernels:
        check(launches[name] > 0, f"{name} was not launched on the serving path")
    check(launches["flash_attention_bwd"] == 0, "the serving path launched a backward kernel")
    check(all(launches[k] == 0 for k in registry_kernels),
          f"the serving path launched a registry-only kernel: {launches}")
    steps = out["decode_steps"]
    for name in serving_kernels:
        check(launches[name] == per_prefill[name] + steps * per_step[name],
              f"{name}: {launches[name]} launches, expected "
              f"{per_prefill[name]} + {steps} x {per_step[name]}")
    # the decode step's cache depth halfway through the run, for phase 5
    mid_pos = plen + steps // 2
    wall_step_ms = 1e3 * out["decode_s"] / max(steps, 1)

    # -- 5. times at phase 4's shapes -------------------------------------------
    mark(5)
    print(f"[5] times in ms at phase 4's shapes, bf16, ({smi})")
    bf = torch.bfloat16
    es = 2
    rows = []

    def time_matmul(label, m, k, n, trans, calls, path, trans_a=False):
        """a (m, k) @ b (k, n), each row-major or the transposed view of a
        row-major matrix (``trans_a``; ``trans`` for b)."""
        sets = []
        for _ in range(copies_past_l2((m * k + k * n) * es)):
            a = torch.randn(k, m, device=dev, generator=g).to(bf).T if trans_a else \
                torch.randn(m, k, device=dev, generator=g).to(bf)
            w = torch.randn(n, k, device=dev, generator=g).to(bf)
            sets.append((a, w.T if trans else w.T.contiguous()))
        t_k = time_ms(torch, hbp_matmul, sets)
        t_p = time_ms(torch, matmul_ref, sets)
        t_l = time_ms(torch, torch.matmul, sets)
        nbytes = (m * k + k * n + m * n) * es
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, "bfloat16")
        inst = mm_path(*sets[0])
        p = mm_plan(m, n, k, inst, sms)
        rows.append(dict(kernel="hbp_matmul", label=label, calls=calls, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=b_ms, bytes=nbytes, ops=2 * m * n * k,
                         bound_by=b_by, path=path, instance=inst,
                         tile=f"{p.tile_n}/{p.splits}"))
        del sets

    L = cfg.n_layers
    T_prefill = BATCH * plen
    for phase, T in (("decode", BATCH), ("prefill", T_prefill)):
        for name, (kk, n) in weights.items():
            time_matmul(f"{phase} {name} {T}x{kk}@{kk}x{n}", T, kk, n, False, L, phase)
    time_matmul(f"logits {BATCH}x{d}@({V}x{d})^T", BATCH, d, V, True, 1, "decode")

    def time_attention(label, sq, kv_lens, calls, path):
        sk = MAX_LEN if sq == 1 else sq
        sets, lib_sets = [], []
        for _ in range(L):  # one cache per layer, as the decode step reads them
            q = torch.randn(BATCH, sq, h, hd, device=dev, generator=g).to(bf)
            k = torch.randn(BATCH, sk, kvh, hd, device=dev, generator=g).to(bf)
            v = torch.randn(BATCH, sk, kvh, hd, device=dev, generator=g).to(bf)
            if sq == 1:
                kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
                mask = (torch.arange(sk, device=dev)[None, :] < kl[:, None])[:, None, None, :]
                sets.append((q, k, v, kl, kl - 1))
                lib_sets.append((q, k, v, mask, False))
            else:
                sets.append((q, k, v, None, None))
                lib_sets.append((q, k, v, None, True))
        kern = lambda q, k, v, kl, qo: flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl)  # noqa: E731
        plain = lambda q, k, v, kl, qo: flash_attention_ref(q, k, v, causal=True, q_offset=qo, kv_len=kl)  # noqa: E731
        t_k = time_ms(torch, kern, sets)
        t_p = time_ms(torch, plain, sets)
        t_l = time_ms(torch, sdpa, lib_sets)
        if sq == 1:
            pairs = h * sum(kv_lens)
            kv_bytes = 2 * kvh * hd * es * sum(kv_lens)
        else:
            pairs = BATCH * h * sq * (sq + 1) // 2
            kv_bytes = 2 * BATCH * sk * kvh * hd * es
        nbytes = 2 * BATCH * sq * h * hd * es + kv_bytes + BATCH * h * sq * 4
        b_ms, b_by = bound_ms(nbytes, 4 * hd * pairs, "bfloat16")
        rows.append(dict(kernel="flash_attention", label=label, calls=calls, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bytes=nbytes,
                         ops=4 * hd * pairs, bound_by=b_by, path=path,
                         instance=fwd_path(sets[0][0])))

    def print_rows(path):
        print(f"    {'kernel':19s} {'inst':6s} {'tile/sk':7s} {'shape':42s} {'calls':>5s} "
              f"{'ms':>9s} {'plain_ms':>9s} {'library':>9s} {'bound_ms':>9s} {'by':>10s} "
              f"{'% bound':>8s}")
        for r in rows:
            if r["path"] in path:
                print(f"    {r['kernel']:19s} {r['instance']:6s} {r.get('tile', ''):7s} "
                      f"{r['label']:42s} "
                      f"{r['calls']:5d} {r['ms']:9.4f} {r['plain_ms']:9.4f} "
                      f"{r['library_ms']:9.4f} {r['bound_ms']:9.4f} {r['bound_by']:>10s} "
                      f"{100 * r['bound_ms'] / r['ms']:7.1f}%")

    time_attention(f"decode 4x1x{h}x{hd} vs cache {MAX_LEN}, kv_len {mid_pos + 1}",
                   1, [mid_pos + 1] * BATCH, L, "decode")
    time_attention(f"prefill causal 4x{plen}x{h}x{hd}", plen, None, L, "prefill")
    print_rows(("decode", "prefill"))

    # one whole decode step on the device: every kernel and elementwise op,
    # captured in a CUDA graph and replayed back to back (no host gaps)
    logits, kvc = server.model.prefill({"tokens": toks}, MAX_LEN)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    pos = torch.tensor(mid_pos, dtype=torch.int32, device=dev)
    step_ms = time_ms(torch, lambda: server.model.decode_step(tok, pos, kvc), [()])
    kernel_step_ms = sum(r["ms"] * r["calls"] for r in rows if r["path"] == "decode")
    print(f"    decode step: {step_ms:.4f} ms on the device (CUDA graph replay), "
          f"{kernel_step_ms:.4f} ms of it in the two kernels (timed alone, cold L2); "
          f"{wall_step_ms:.3f} ms per step in phase 4's run: device busy "
          f"{100 * step_ms / wall_step_ms:.1f}% of the wall time")
    del server, logits, kvc
    torch.cuda.empty_cache()

    # -- 6. full-width training -------------------------------------------------
    mark(6)
    T_train = TRAIN_BATCH * TRAIN_SEQ
    n_chunks = TRAIN_SEQ // min(512, TRAIN_SEQ)  # RunOptions.ce_chunk 512
    # launches one step makes by construction: each layer's 7 products run
    # forward twice (the forward and the per-layer recomputation) and twice
    # backward (dA, dB); the logits likewise per cross-entropy chunk; each
    # layer's attention runs K1 twice and K3 once
    per_train_step = {"hbp_matmul": L * 7 * 4 + n_chunks * 4,
                      "flash_attention": 2 * L, "flash_attention_bwd": L}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train(cfg, steps=TRAIN_STEPS,
                data_cfg=DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                device="cuda", log_every=0)
    train_launches = counts()
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[6] {ARCH} full-width training, bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{TRAIN_STEPS} AdamW steps from a seeded init (remat full); peak memory "
          f"{peak_train_gb:.2f} GB")
    for i, (loss, gn, sec) in enumerate(zip(run["losses"], run["grad_norms"], run["step_s"])):
        print(f"    step {i}: loss {loss:.4f}, grad norm {gn:.4f}, {1e3 * sec:.3f} ms (host wall)")
    print(f"    launches in the run {train_launches}; per step "
          f"{ {k: n / TRAIN_STEPS for k, n in train_launches.items()} }")
    check(all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]),
          "non-finite loss or grad norm in the full-width training run")
    for name, n in per_train_step.items():
        check(train_launches[name] == TRAIN_STEPS * n,
              f"{name}: {train_launches[name]} launches in training, expected "
              f"{TRAIN_STEPS} x {n}")
    check(all(train_launches[k] == 0 for k in registry_kernels),
          f"training launched a registry-only kernel: {train_launches}")

    # -- 7. times at phase 6's shapes -------------------------------------------
    mark(7)
    print(f"[7] times in ms at phase 6's shapes, bf16, ({smi})")
    shapes = {}  # weight shape -> how many of the 7 weights have it
    for kk, n in weights.values():
        shapes[(kk, n)] = shapes.get((kk, n), 0) + 1
    for (kk, n), count in shapes.items():
        names = "/".join(w for w, sh in weights.items() if sh == (kk, n))
        time_matmul(f"fwd {names} {T_train}x{kk}@{kk}x{n}", T_train, kk, n, False,
                    2 * L * count, "train")
        time_matmul(f"dX {names} {T_train}x{n}@({kk}x{n})^T", T_train, n, kk, True,
                    L * count, "train")
        time_matmul(f"dW {names} ({T_train}x{kk})^T@{T_train}x{n}", kk, T_train, n, False,
                    L * count, "train", trans_a=True)
    time_matmul(f"fwd logits {T_train}x{d}@({V}x{d})^T", T_train, d, V, True,
                2 * n_chunks, "train")
    time_matmul(f"dH logits {T_train}x{V}@{V}x{d}", T_train, V, d, False, n_chunks, "train")
    time_matmul(f"dE^T logits ({T_train}x{d})^T@{T_train}x{V}", d, T_train, V, False,
                n_chunks, "train", trans_a=True)
    time_attention(f"fwd causal 4x{TRAIN_SEQ}x{h}x{hd}", TRAIN_SEQ, None, 2 * L, "train")

    # K3 at the training shape; the library is autograd's backward of one
    # scaled_dot_product_attention call, timed alone
    t = time_attention_bwd(torch, dev, g, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, (h, kvh, hd), True)
    rows.append(dict(kernel="flash_attention_bwd", label=f"causal 4x{TRAIN_SEQ}x{h}x{hd}",
                     calls=L, path="train", instance=t["path"],
                     **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes",
                                          "ops", "bound_by")}))
    print_rows(("train",))
    for name in ("hbp_matmul", "flash_attention", "flash_attention_bwd"):
        rs = [r for r in rows if r["kernel"] == name and r["path"] == "train"]
        print(f"    {name}: one training step = {sum(r['calls'] for r in rs)} calls, "
              f"{sum(r['ms'] * r['calls'] for r in rs):.4f} ms (bound "
              f"{sum(r['bound_ms'] * r['calls'] for r in rs):.4f} ms, plain "
              f"{sum(r['plain_ms'] * r['calls'] for r in rs):.4f} ms, library "
              f"{sum(r['library_ms'] * r['calls'] for r in rs):.4f} ms)")

    # one whole training step on the device: captured in a CUDA graph after
    # a warm-up step on the capture's side stream, replayed back to back
    model, opt_state = run["model"], run["opt_state"]
    train_step = make_train_step(model)
    batch = {key: torch.from_numpy(x).to(dev) for key, x in SyntheticLMDataset(
        DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ), cfg).batch_at(0).items()}
    train_step_ms = graph_ms(torch, lambda: train_step(opt_state, batch))
    wall_train_ms = 1e3 * sum(run["step_s"][1:]) / max(len(run["step_s"]) - 1, 1)
    kernel_train_ms = sum(r["ms"] * r["calls"] for r in rows if r["path"] == "train")
    print(f"    training step: {train_step_ms:.4f} ms on the device (CUDA graph replay), "
          f"{kernel_train_ms:.4f} ms of it in K1, K2 and K3 (timed alone, cold L2); "
          f"{wall_train_ms:.3f} ms per step in phase 6's run (steps 1-{TRAIN_STEPS - 1}): "
          f"device busy {100 * train_step_ms / wall_train_ms:.1f}% of the wall time")
    # what the device ran in one step, by the profiler's trace: every kernel,
    # copy and set, ours and PyTorch's
    bd = device_breakdown(torch, lambda: train_step(opt_state, batch))
    if bd is None:
        print("    profiler trace of one step: no device operations seen (not measured)")
    else:
        ours = sum(n for n, _ in bd["ours"].values())
        print(f"    our device operations in the trace, by kernel: "
              f"{ {k: n for k, (n, _) in sorted(bd['ours'].items())} }")
        print(f"    profiler trace of one step: {bd['n']} device operations ({ours} of them K1, "
              f"K2 (with its split-K reductions) or K3; {bd['rest_n']} PyTorch kernels, copies "
              f"and sets), {bd['ours_ms'] + bd['rest_ms']:.4f} ms of device time in them")
    # the optimizer alone: one AdamW update of every parameter from bf16 grads
    params = dict(model.named_parameters())
    grads = {n: torch.randn(p.shape, device=dev, generator=g).to(p.dtype) * 1e-3
             for n, p in params.items()}
    opt_ms = time_ms(torch, lambda: adamw_update(params, grads, opt_state, AdamWConfig()),
                     [()], reps=2)
    n_params = sum(p.numel() for p in params.values())
    print(f"    of which AdamW (every parameter, {n_params / 1e9:.3f}e9 values): {opt_ms:.4f} ms "
          f"(one fused pass reading bf16 grads and f32 master/m/v and writing them and the "
          f"bf16 params would move {28 * n_params / 1e9:.1f} GB: "
          f"{1e3 * 28 * n_params / HBM_BYTES_PER_S:.4f} ms); the rest (norms, RoPE, SwiGLU, "
          f"casts, residuals, embedding, cross-entropy; by difference) "
          f"{train_step_ms - kernel_train_ms - opt_ms:.4f} ms")
    del model, opt_state, run, params, grads
    torch.cuda.empty_cache()

    # -- 8. the continuous-batching engine at full width --------------------------
    mark(8)
    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=ENGINE_LEN, chunk=CHUNK)
    workload = engine_workload(np, V)
    trace, counted, finite_logits = engine_tracers(torch, counts)
    trace_engine(engine, counted, finite_logits)
    print(f"[8] {ARCH} full width bf16 through the Engine: {SLOTS} slots, max_len "
          f"{ENGINE_LEN}, chunk {CHUNK}; {ENGINE_REQUESTS} requests, prompts "
          f"{[len(p) for p, _ in workload]}, max_new {[m for _, m in workload]}")
    engine_runs = {}
    for cache_kind in ("bf16", "int8"):
        trace.update(decode=[], prefill=[], pos=[],
                     finite=torch.ones((), dtype=torch.bool, device=dev))
        reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(workload)]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with policy.apply(**(INT8 if cache_kind == "int8" else {})):
            out = engine.run(reqs)
        run_launches = counts()
        per_step = trace["decode"]
        steps, chunks = out["decode_steps"], out["prefill_chunks"]
        engine_runs[cache_kind] = dict(tokens=[r.out for r in reqs], out=out,
                                       launches=run_launches, pos=trace["pos"])
        tel = out["telemetry"]
        print(f"    {cache_kind} cache ({engine.cache.k.dtype}): completed "
              f"{len(out['completed'])}/{ENGINE_REQUESTS}; logits finite "
              f"{bool(trace['finite'])}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(f"    decode {1e3 * out['decode_s'] / max(steps, 1):.3f} ms/step over {steps} "
              f"steps (host wall, each ended by its host read); prefill "
              f"{1e3 * out['prefill_s'] / max(chunks, 1):.3f} ms/chunk over {chunks} chunk "
              f"launches ({out['prefill_chunk_rows']} chunk rows); {out['tok_per_s']:.1f} "
              f"tok/s ({out['tokens']} tokens in {out['wall_s']:.3f} s)")
        print(f"    telemetry {tel}")
        print(f"    launches in the run {run_launches}; per decode step "
              f"{sorted({tuple(sorted(c.items())) for c in per_step})}; per prefill chunk "
              f"{sorted({tuple(sorted(c.items())) for c in trace['prefill']})}")
        check(all(len(r.out) == r.max_new for r in reqs) and len(out["completed"]) == len(reqs),
              f"{cache_kind} engine: requests not completed: {out['completed']}")
        check(bool(trace["finite"]) and tel["slots_poisoned"] == 0 and tel["retries"] == 0,
              f"{cache_kind} engine: non-finite logits or a failed launch ({tel})")
        print(f"    watchdog {out['stats']['watchdog']}")
        check(tel["stragglers"] == 0 and tel["degradations"] == 0,
              f"{cache_kind} engine: the unfaulted run flagged stragglers or shed slots ({tel})")
        attn, other = (("flash_attention_int8", "flash_attention") if cache_kind == "int8"
                       else ("flash_attention", "flash_attention_int8"))
        for c in per_step:
            check(c[attn] == L and c[other] == 0 and c["hbp_matmul"] == 7 * L + 1
                  and c["flash_attention_bwd"] == 0
                  and all(c[k] == 0 for k in registry_kernels),
                  f"{cache_kind} engine decode step launched {c}; expected {attn} {L}, "
                  f"{other} 0, hbp_matmul {7 * L + 1}")
        check(steps == len(per_step) > 0, f"{cache_kind} engine: {steps} decode steps, "
              f"{len(per_step)} traced")
        # one decode step on the device at the run's halfway lanes, captured
        # in a CUDA graph and replayed (the model's own method, not the
        # tracing wrapper); it writes into the finished run's cache
        mid_pos = trace["pos"][len(trace["pos"]) // 2]
        tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
        dev_ms = time_ms(torch, lambda: type(engine.model).decode_step(
            engine.model, tok, mid_pos, engine.cache), [()])
        wall_ms = 1e3 * out["decode_s"] / max(steps, 1)
        print(f"    decode step on the device (CUDA graph replay, halfway lanes "
              f"{mid_pos.tolist()}): {dev_ms:.4f} ms; device busy {100 * dev_ms / wall_ms:.1f}% "
              f"of the {wall_ms:.3f} ms wall per step")
    agree = sum(a == b for a, b in zip(engine_runs["bf16"]["tokens"],
                                       engine_runs["int8"]["tokens"]))
    print(f"    requests whose tokens agree between the int8 and the bf16 cache: "
          f"{agree}/{ENGINE_REQUESTS} ({100 * agree / ENGINE_REQUESTS:.1f}%; not a gate)")
    # the int8 run's decode lanes halfway through, for phase 9
    mid = engine_runs["int8"]["pos"][len(engine_runs["int8"]["pos"]) // 2]
    mid_qo = mid.tolist()
    mid_kl = [min(p + 1, ENGINE_LEN) for p in mid_qo]
    del engine
    torch.cuda.empty_cache()

    # -- 9. K1q's time at phase 8's decode and chunk shapes ----------------------
    mark(9)
    # decode at the int8 run's halfway lanes; a continuation chunk of CHUNK
    # rows at those lanes' offsets (clamped to fit the cache)
    chunk_at = [min(p, ENGINE_LEN - CHUNK) for p in mid_qo]
    q8_shapes = [("decode", 1, mid_qo, mid_kl),
                 ("chunk", CHUNK, chunk_at, [p + CHUNK for p in chunk_at])]
    print(f"[9] K1q per call at phase 8's shapes: q {SLOTS}xSQx{h}x{hd} bf16, int8 cache "
          f"{SLOTS}x{ENGINE_LEN}x{kvh}x{hd}; decode (SQ 1) at the int8 run's halfway lanes "
          f"(kv_len {mid_kl}), a {CHUNK}-row chunk (SQ {CHUNK}) at q_offset {chunk_at}; "
          f"each beside K1 over the same cache in bf16 ({smi})")
    fa_mod = sys.modules[flash_attention.__module__]

    def lib_two_calls(qd, k8, v8, ks, vs, mask):
        kb, vb = ((x.float() * sc[:, None, :, None]).to(bf) for x, sc in ((k8, ks), (v8, vs)))
        return sdpa(qd, kb, vb, mask, False)

    for shape, sq, qo, kl in q8_shapes:
        q8_sets, k1_sets, lib_sets, k1_lib_sets = [], [], [], []
        qo_t, kl_t = lane(qo), lane(kl)
        # which key each row sees: kpos < kv_len and kpos <= q_offset + row
        kpos = torch.arange(ENGINE_LEN, device=dev)
        mask = ((kpos[None, None, :] < kl_t[:, None, None])
                & (kpos[None, None, :] <= qo_t[:, None, None]
                   + torch.arange(sq, device=dev)[None, :, None]))[:, None]
        for _ in range(L):  # one cache per layer, as the decode step reads them
            qd = torch.randn(SLOTS, sq, h, hd, device=dev, generator=g).to(bf)
            k8, v8, ks, vs = int8_cache(SLOTS)
            q8_sets.append((qd, k8, v8, ks, vs, qo_t, kl_t))
            kb, vb = ((x.float() * sc[:, None, :, None]).to(bf) for x, sc in ((k8, ks), (v8, vs)))
            k1_sets.append((qd, kb, vb, qo_t, kl_t))
            lib_sets.append((qd, k8, v8, ks, vs, mask))
            k1_lib_sets.append((qd, kb, vb, mask))
        t_q8 = time_ms(torch, lambda qd, k8, v8, ks, vs, qo, kl: flash_attention_int8(
            qd, k8, v8, ks, vs, causal=True, q_offset=qo, kv_len=kl), q8_sets)
        t_plain = time_ms(torch, lambda qd, k8, v8, ks, vs, qo, kl: flash_attention_ref(
            qd, k8, v8, causal=True, q_offset=qo, kv_len=kl, k_scale=ks, v_scale=vs), q8_sets)
        t_lib = time_ms(torch, lib_two_calls, lib_sets)
        t_k1 = time_ms(torch, lambda qd, kb, vb, qo, kl: flash_attention(
            qd, kb, vb, causal=True, q_offset=qo, kv_len=kl), k1_sets)
        # K1's library call over the same bf16 cache: one masked
        # scaled_dot_product_attention
        t_k1_lib = time_ms(torch, lambda qd, kb, vb, m: sdpa(qd, kb, vb, m, False), k1_lib_sets)
        splits = fa_mod.kv_splits(SLOTS, sq, h, kvh, ENGINE_LEN, sms, fa_mod.mma_kv_tile(hd))
        instance = f"{fwd_path(q8_sets[0][0])}, {splits} split{'s' * (splits > 1)}"
        # read the valid int8 k and v once, q, the scales and the lanes; write
        # out and lse.  Work: q.kᵀ and p.v over every (row, key) pair a row
        # sees, for every head
        valid = sum(kl)
        pairs = int(mask.sum())
        io = 2 * SLOTS * sq * h * hd * es + SLOTS * sq * h * 4 + 2 * SLOTS * 4
        q8_bytes = 2 * kvh * hd * valid + io + 2 * SLOTS * kvh * 4
        q8_ops = 4 * hd * h * pairs
        b_ms, b_by = bound_ms(q8_bytes, q8_ops, "bfloat16")
        k1_bound, _ = bound_ms(es * 2 * kvh * hd * valid + io, q8_ops, "bfloat16")
        rows.append(dict(kernel="flash_attention_int8",
                         label=f"{shape} {SLOTS}x{sq} vs int8 {ENGINE_LEN}", calls=L, ms=t_q8,
                         plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms, bytes=q8_bytes,
                         ops=q8_ops, bound_by=b_by,
                         path="engine" if shape == "decode" else "engine chunk",
                         instance=instance))
        print(f"    {shape} {SLOTS}x{sq}: K1q ({instance}) {t_q8:.4f} ms (bound {b_ms:.4f} ms "
              f"by {b_by}, {100 * b_ms / t_q8:.1f}% of it; {q8_bytes / 1e6:.3f} MB); plain "
              f"{t_plain:.4f} ms; library, two calls (dequantize to bf16, then "
              f"scaled_dot_product_attention) {t_lib:.4f} ms; K1 ({fwd_path(k1_sets[0][0])}) "
              f"over the bf16 cache {t_k1:.4f} ms (its bound {k1_bound:.4f} ms; "
              f"scaled_dot_product_attention over it {t_k1_lib:.4f} ms); K1q / K1 "
              f"{t_q8 / t_k1:.3f}")
        print(f"    {shape}: {L} calls (one per layer): K1q {L * t_q8:.4f} ms, K1 over bf16 "
              f"{L * t_k1:.4f} ms, scaled_dot_product_attention over bf16 {L * t_k1_lib:.4f} ms")
        del q8_sets, k1_sets, lib_sets, k1_lib_sets

    # -- 10. the kernel registry at sizes past the L2 --------------------------------
    mark(10)
    # Everything through registry.dispatch under the default policy, seeded
    # inputs.  Gates against the plain versions: the scan in f32 within
    # SCAN_SLACK times the running sum of |x| (the kernel and torch.cumsum sum
    # a 2^20-element leaf in other orders; that is ~16 f32 ulps of the sum's
    # magnitude bound), in bf16 within one bf16 ulp plus that f32 slack (a
    # last-bit difference of the f32 sums can move the rounding); transposes
    # exact; the FFT and the Strassen product normwise: the largest error
    # within a stated fraction of the largest output.
    dp = planner.device_params(dev)
    rg = torch.Generator(device=dev).manual_seed(10)
    n_mm = STRASSEN_N
    mm_plan = planner.plan_matmul_backend(n_mm, n_mm, n_mm, "float32", dp)
    levels, edge = 0, n_mm
    while mm_plan["backend"] == "strassen" and edge > mm_plan["cutoff"] and edge % 2 == 0:
        edge, levels = edge // 2, levels + 1
    bf_plan = planner.plan_matmul_backend(n_mm, n_mm, n_mm, "bfloat16", dp)
    bf_levels, bf_edge = 0, n_mm
    while bf_plan["backend"] == "strassen" and bf_edge > bf_plan["cutoff"] and bf_edge % 2 == 0:
        bf_edge, bf_levels = bf_edge // 2, bf_levels + 1
    print(f"[10] the kernel registry past the L2 ({smi}); the planner reads {dp}: budget "
          f"M/3 = {dp.fast_bytes // 3} bytes; Strassen cutoff f32 "
          f"{planner.strassen_cutoff('float32', dp)}, bf16 {planner.strassen_cutoff('bfloat16', dp)}")
    reg_cases = [  # (label, op, tensors)
        ("scan f32 64x2^20", "scan", (torch.randn(64, 2 ** 20, device=dev, generator=rg),)),
        ("scan bf16 64x2^20", "scan",
         (torch.randn(64, 2 ** 20, device=dev, generator=rg).to(torch.bfloat16),)),
        ("transpose f32 8192x8192", "transpose",
         (torch.randn(8192, 8192, device=dev, generator=rg),)),
        ("transpose bf16 4096x16384", "transpose",
         (torch.randn(4096, 16384, device=dev, generator=rg).to(torch.bfloat16),)),
        ("transpose bf16 6144x10240", "transpose",
         (torch.randn(6144, 10240, device=dev, generator=rg).to(torch.bfloat16),)),
        ("fft complex64 256x65536", "fft",
         (torch.randn(256, 2 ** 16, dtype=torch.complex64, device=dev, generator=rg),)),
        ("fft complex64 1x2^25", "fft",  # past the pass cap: pass 2 a bi_fft of its own
         (torch.randn(1, 2 ** 25, dtype=torch.complex64, device=dev, generator=rg),)),
        (f"matmul f32 {n_mm}x{n_mm} @ {n_mm}x{n_mm}", "matmul",
         tuple(torch.randn(n_mm, n_mm, device=dev, generator=rg) for _ in "ab")),
        (f"matmul bf16 {n_mm}x{n_mm} @ {n_mm}x{n_mm}", "matmul",
         tuple(torch.randn(n_mm, n_mm, device=dev, generator=rg).to(torch.bfloat16)
               for _ in "ab")),
    ]
    for label, op, args in reg_cases:
        x = args[0]
        plan = registry.get(op).plan(*args)
        extra = ""
        if op == "transpose":
            nm, nn = x.shape[0] // min(plan["bt"], x.shape[0]), x.shape[1] // min(plan["bt"], x.shape[1])
            extra = (f": a {nm}x{nn} grid of bt tiles, "
                     f"{'Morton' if morton_order(nm, nn) else 'row-major'} order")
        print(f"    {label}: plan {plan}{extra}")
    check(mm_plan["backend"] == "strassen" and levels > 0 and bf_levels > 0,
          f"the planner does not pick Strassen for {n_mm}^2: f32 {mm_plan}, bf16 {bf_plan}")
    torch.cuda.synchronize()
    reset_counts()
    reg_out = [registry.dispatch(op, *args) for _, op, args in reg_cases]
    torch.cuda.synchronize()
    reg_launches = counts()
    # one launch a scan and a transpose; a K7 call (two kernels) an FFT whose
    # passes fit the cap, and past it pass 1, the nested call and one K6
    # readout a row; the fused K4 once an f32 Strassen call of up to two
    # levels and no K2; bf16 Strassen 7^levels K2 leaves
    want_launches = dict.fromkeys(counts(), 0)
    fft_lines = []
    for _, op, args in reg_cases:
        x = args[0]
        if op == "scan":
            want_launches["bp_scan"] += 1
        elif op == "transpose":
            want_launches["bi_transpose"] += 1
        elif op == "fft":
            n1_, n2_ = fft_split(x.shape[1])
            past = max(n1_, n2_) > MAX_PASS
            want_launches["bi_fft"] += 2 if past else 1
            want_launches["bi_transpose"] += x.shape[0] if past else 0
            fft_lines.append(f"{x.shape[1]} at {n1_} x {n2_}" + (
                f": pass 1, then a bi_fft of {n2_} at {fft_split(n2_)[0]} x "
                f"{fft_split(n2_)[1]} and {x.shape[0]} K6 readout" if past else ""))
        elif x.dtype == torch.float32:
            want_launches["strassen_matmul"] += 7 ** max(levels - 2, 0)
        else:
            want_launches["hbp_matmul"] += 7 ** bf_levels
    print(f"    launches in the run {reg_launches}; per f32 Strassen call: the fused K4 "
          f"once ({levels} levels, cutoff {mm_plan['cutoff']}, {k4_path(*reg_cases[-2][2])}), "
          f"K2 0; per bf16 Strassen call K2 {7 ** bf_levels} = 7^{bf_levels}; per FFT call K2 0, "
          f"K7 at the plan's split: {'; '.join(fft_lines)}")
    check(reg_launches == want_launches,
          f"registry run launched {reg_launches}, expected {want_launches}")

    def normwise(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    reg_fail = []
    for (label, op, args), got in zip(reg_cases, reg_out):
        x = args[0]
        if op == "scan":
            block = planner.plan_scan(x.shape, x.dtype, dp)["block"]
            want = bp_scan_plain(x, block).float()
            slack = SCAN_SLACK * torch.cumsum(x.float().abs(), dim=-1) + SCAN_SLACK
            diff = (got.float() - want).abs()
            if x.dtype == torch.bfloat16:
                mag = torch.maximum(got.float().abs(), want.abs()).clamp_min(2.0 ** -126)
                ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                ok = bool((diff <= ulp + slack).all())
                note = (f"{int((diff > ulp).sum())} of {diff.numel()} elements beyond one "
                        f"ulp alone (within the f32 slack)")
                del mag, ulp
            else:
                ok, note = bool((diff <= slack).all()), "within the f32 slack"
            err = diff.max().item()
            max_err["bp_scan"] = max(max_err["bp_scan"], err)
            del want, slack, diff
            tol_text = ("1 bf16 ulp + " if x.dtype == torch.bfloat16 else "") + \
                f"{SCAN_SLACK:g} * cumsum|x| + {SCAN_SLACK:g}"
            same = torch.equal(registry.dispatch("scan", x), got)
            ok = ok and same
            print(f"    {label}: leaf {block}, {k5_path(x, block)} instance, tile "
                  f"{k5_tile(x.dtype)}; max abs err vs plain "
                  f"{err:.3e} ({tol_text}); {note}; a second call bitwise equal {same} "
                  f"{'ok' if ok else 'FAIL'}")
        elif op == "transpose":
            want = transpose_ref(x)
            ok = torch.equal(got, want)
            max_err["bi_transpose"] = max(max_err["bi_transpose"],
                                          (got.float() - want.float()).abs().max().item())
            del want
            print(f"    {label}: exact {'ok' if ok else 'FAIL'}")
        elif op == "fft":
            want = bi_fft_plain(x)
            e_plain = normwise(got, want)
            max_err["bi_fft"] = max(max_err["bi_fft"], (got - want).abs().max().item())
            del want
            e_lib = normwise(got, torch.fft.fft(x, dim=-1))
            ok = e_plain <= FFT_TOL[0] and e_lib <= FFT_TOL[1]
            print(f"    {label}: normwise err vs plain version {e_plain:.3e} (tol "
                  f"{FFT_TOL[0]:g}), vs torch.fft.fft {e_lib:.3e} (tol {FFT_TOL[1]:g}) "
                  f"{'ok' if ok else 'FAIL'}")
        elif x.dtype == torch.float32:
            want = strassen_matmul_plain(*args)
            e_plain = normwise(got, want)
            max_err["strassen_matmul"] = (got - want).abs().max().item()
            del want
            e_lib = normwise(got, torch.matmul(*args))
            same = torch.equal(registry.dispatch("matmul", *args), got)
            ok = e_plain <= MM_TOL[0] and e_lib <= MM_TOL[1] and same
            print(f"    {label}: normwise err vs plain Strassen {e_plain:.3e} (tol "
                  f"{MM_TOL[0]:g}), vs torch.matmul f32 (TF32 off) {e_lib:.3e} (tol "
                  f"{MM_TOL[1]:g}); a second call bitwise equal {same} {'ok' if ok else 'FAIL'}")
        else:
            e_plain = normwise(got.float(), strassen_matmul_plain(*args).float())
            e_lib = normwise(got.float(), torch.matmul(*args).float())
            ok = e_plain <= MM_TOL_BF16[0] and e_lib <= MM_TOL_BF16[1]
            print(f"    {label} (over K2 {mm_path(*args)}): normwise err vs plain Strassen "
                  f"{e_plain:.3e} (tol {MM_TOL_BF16[0]:g}), vs torch.matmul bf16 {e_lib:.3e} "
                  f"(tol {MM_TOL_BF16[1]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            reg_fail.append(label)
    del reg_out
    torch.cuda.synchronize()
    check(not reg_fail, f"registry kernels disagree with their plain versions: {reg_fail}")

    # device times per call (CUDA-graph replay; each input is 128 MB or
    # more, past the 50 MB L2)
    print(f"    times in ms per call ({smi})")
    reg_rows = []
    for label, op, args in reg_cases:
        x = args[0]
        es = x.element_size()
        if op == "scan":
            block = planner.plan_scan(x.shape, x.dtype, dp)["block"]
            plain = lambda x, b=block: bp_scan_plain(x, b)  # noqa: E731
            lib, lib_name = (lambda x: torch.cumsum(x, dim=-1)), "torch.cumsum"
            nbytes, ops, peak = 2 * x.numel() * es, x.numel(), "float32"
            name, iters = "bp_scan", None
            instance = f"{k5_path(x, block)}, one launch"
        elif op == "transpose":
            plain = transpose_ref
            lib, lib_name = (lambda x: x.t().contiguous()), "x.t().contiguous()"
            nbytes, ops, peak = 2 * x.numel() * es, 0, "float32"
            name, iters = "bi_transpose", None
            instance = k6_path(x, registry.get(op).plan(x)["bt"])
        elif op == "fft":
            plain = bi_fft_plain
            lib, lib_name = (lambda x: torch.fft.fft(x, dim=-1)), "torch.fft.fft"
            rows_, n_ = x.shape
            nbytes, ops, peak = 2 * x.numel() * es, 5 * n_ * math.log2(n_) * rows_, "float32"
            # the row past the pass cap is timed and gated, and kept out of
            # K7's entry, which stays at the (256, 65536) of earlier runs
            past = max(fft_split(n_)) > MAX_PASS
            name, iters = ("bi_fft past cap", 2) if past else ("bi_fft", None)
        elif x.dtype == torch.bfloat16:
            plain = strassen_matmul_plain
            lib, lib_name = torch.matmul, "torch.matmul bf16"
            ops = 7 ** bf_levels * 2 * bf_edge ** 3 + sum(
                7 ** lv * 18 * (n_mm >> (lv + 1)) ** 2 for lv in range(bf_levels))
            nbytes, peak = 3 * n_mm * n_mm * 2, "bfloat16"
            name, iters = "strassen bf16", 2
        else:
            plain = strassen_matmul_plain
            lib, lib_name = torch.matmul, "torch.matmul f32, TF32 off"
            # the Strassen schedule's own work: 7^levels leaf products of
            # edge^3 multiply-adds, and at each level's 7^l nodes 18 f32 sums
            # of (half-edge)^2 (10 operand, 8 output combinations)
            ops = 7 ** levels * 2 * edge ** 3 + sum(
                7 ** lv * 18 * (n_mm >> (lv + 1)) ** 2 for lv in range(levels))
            nbytes, peak = 3 * n_mm * n_mm * 4, "float32"
            name, iters = "strassen_matmul", 2
        t_k = time_ms(torch, lambda *a, o=op: registry.dispatch(o, *a), [args],
                      reps=2 if iters else 5, iters=iters)
        t_p = time_ms(torch, plain, [args], reps=2 if iters else 5, iters=iters)
        t_l = time_ms(torch, lib, [args], reps=2 if iters else 5, iters=iters)
        b_ms, b_by = bound_ms(nbytes, ops, peak)
        reg_rows.append(dict(kernel=name, label=label, ms=t_k, plain_ms=t_p, library_ms=t_l,
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops))
        inst = f" [{instance}]" if op in ("transpose", "scan") else ""
        print(f"    {name:15s} {label:32s} {t_k:9.4f}{inst} (bound {b_ms:.4f} by {b_by}, "
              f"{100 * b_ms / t_k:5.1f}% of it); plain {t_p:9.4f}; {lib_name} {t_l:9.4f}")
        if op == "fft":  # each pass reads and writes the data
            passes = 4 if past else 2
            floor = passes * nbytes / 2 / HBM_BYTES_PER_S
            print(f"    {'':15s} the {passes} passes move {passes * nbytes / 2:.4e} bytes: >= "
                  f"{1e3 * floor:.4f} ms at 3.35 TB/s, {100e3 * floor / t_k:5.1f}% of K7's time"
                  + (" (pass 1, the nested call's two, the K6 readout)" if past else ""))
        if name == "strassen_matmul":
            t_c = time_ms(torch, lambda a, b: registry.dispatch("matmul", a, b,
                                                                backend="classical"),
                          [args], reps=2, iters=2)
            c_ms, c_by = bound_ms(nbytes, 2 * n_mm ** 3, "float32")
            print(f"    {'':15s} the Strassen bound counts {ops:.4e} f32 FLOP ({7 ** levels} "
                  f"leaves of {edge}^3 and the combinations)")
            print(f"    {'':15s} backend='classical' (one K2 fma call) {t_c:9.4f} (bound "
                  f"{c_ms:.4f} by {c_by}: 2n^3 = {2 * n_mm ** 3:.4e} FLOP, {100 * c_ms / t_c:5.1f}% "
                  f"of it); classical K2 / fused Strassen time {t_c / t_k:.3f}; the leaves at "
                  f"{7 ** levels * 2 * edge ** 3 / t_k / 1e9:.2f} TFLOP/s")
    scans = [r for r in reg_rows if r["kernel"] == "bp_scan"]
    t_scans, b_scans = sum(r["ms"] for r in scans), sum(r["bound_ms"] for r in scans)
    print(f"    K5, the two scans: {t_scans:.4f} ms against their {b_scans:.4f} ms bound, "
          f"{100 * b_scans / t_scans:.1f}% of it; torch.cumsum "
          f"{sum(r['library_ms'] for r in scans):.4f}")
    del reg_cases
    torch.cuda.empty_cache()

    # the host's cost of one dispatch (what a model product pays on top of
    # the wrapper), at a decode step's 4 x 2048 @ 2048 x 2048 bf16 product
    a_h = torch.randn(4, d, device=dev, generator=rg).to(torch.bfloat16)
    w_h = torch.randn(d, d, device=dev, generator=rg).to(torch.bfloat16)

    def host_us(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / n

    a_w = torch.randn(32, d, device=dev, generator=rg).to(torch.bfloat16)
    with torch.no_grad():
        us = {"hbp_matmul": host_us(lambda: hbp_matmul(a_h, w_h)),
              "wgmma": host_us(lambda: hbp_matmul(a_w, w_h)),
              "entry": host_us(lambda: matmul_entry(a_h, w_h, backend="classical")),
              "dispatch": host_us(lambda: registry.dispatch("matmul", a_h, w_h)),
              "project": host_us(lambda: project(a_h, w_h))}
    print(f"    host us per call (4x{d} @ {d}x{d} bf16, 2000 calls, no grad): hbp_matmul "
          f"{us['hbp_matmul']:.2f} ({mm_path(a_h, w_h)}; {K2_HOST_US_BEFORE:.2f} before the "
          f"wrapper memoized its plan and the SM count, {K2_HOST_US_CARD}), at 32 rows "
          f"{us['wgmma']:.2f} ({mm_path(a_w, w_h)}: two tensor maps encoded per call); "
          f"its autograd entry (strassen_matmul.matmul, classical) "
          f"{us['entry']:.2f}; registry.dispatch {us['dispatch']:.2f}; the models' project "
          f"(one dispatch) {us['project']:.2f}")

    # -- 11. the MoE path at full width ----------------------------------------------
    mark(11)
    del a_h, w_h, a_w, args, x, got
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_11(torch, np, dev, g, smi, workload, prompts, counts, reset_counts, trace,
                   counted, finite_logits, registry_kernels)

    # -- 12. gemma3-1b at full width and depth --------------------------------------
    mark(12)
    gc.collect()
    torch.cuda.empty_cache()
    hd256 = phase_12(torch, np, dev, g, smi, prompts, counts, reset_counts, trace, counted,
                     finite_logits, registry_kernels, sdpa, lane)

    # -- 13. olmoe-1b-7b trained at full width; 13b the checkpoint round trip ------------
    mark(13)
    gc.collect()
    torch.cuda.empty_cache()
    moe_bwd = phase_13(torch, np, dev, g, smi, counts, reset_counts, registry_kernels)

    # -- 14. the recurrent-state families at full width and depth --------------------
    mark(14)
    gc.collect()
    torch.cuda.empty_cache()
    rec = phase_14(torch, np, dev, g, smi, counts, reset_counts, trace, counted, finite_logits,
                   registry_kernels)

    # -- 15. the cross-attention families -------------------------------------------------
    mark(15)
    gc.collect()
    torch.cuda.empty_cache()
    cross = phase_15(torch, np, dev, g, smi, counts, reset_counts, trace, counted, finite_logits,
                     registry_kernels)

    # -- 16. the fleet ------------------------------------------------------------------------
    mark(16)
    gc.collect()
    torch.cuda.empty_cache()
    phase_16(torch, np, dev, smi, counts, reset_counts, trace, counted, finite_logits,
             registry_kernels)

    # -- 17. the measured autotune on the card ---------------------------------------------------
    mark(17)
    gc.collect()
    torch.cuda.empty_cache()
    phase_17(torch, np, dev, smi, reset_counts, trace, counted, finite_logits)

    # -- 18. the simulator core -------------------------------------------------------------------
    mark(18)
    phase_18(torch, dev, g, smi)

    # -- 19. multi-device planning on the one-card mesh ------------------------------------------
    mark(19)
    gc.collect()
    torch.cuda.empty_cache()
    phase_19(torch, np, dev, smi, counts, reset_counts, workload,
             engine_runs["bf16"]["tokens"])

    # -- 20. sharded execution: four ranks share the card over gloo ---------------------------
    mark(20)
    gc.collect()
    torch.cuda.empty_cache()
    phase_20(torch, np, dev, smi, compare, failures)
    check(not failures, f"phase 20 failed: {failures}")
    mark(None)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; {time.perf_counter() - t_start:.1f} in all")

    # one entry per kernel: K1 and K2 summed over one decode step's calls
    # (their launches from phase 4's run), K3 over one training step's calls
    # (its launches from phase 6's run), K1q over one int8 engine decode
    # step's calls (its launches from phase 8's int8 run)
    replaces = {"hbp_matmul": "src/repro/kernels/hbp_matmul.py:33",
                "flash_attention": "src/repro/kernels/flash_attention.py:137",
                "flash_attention_bwd": "src/repro/kernels/flash_attention.py:207",
                "flash_attention_int8": "src/repro/kernels/flash_attention.py:141"}
    sources = {"flash_attention_int8": "flash_attention"}
    path_of = {"hbp_matmul": "decode", "flash_attention": "decode",
               "flash_attention_bwd": "train", "flash_attention_int8": "engine"}
    launches_of = {"decode": launches, "train": train_launches,
                   "engine": engine_runs["int8"]["launches"]}
    entries = []
    for name in path_of:
        rs = [r for r in rows if r["kernel"] == name and r["path"] == path_of[name]]
        tot = {key: sum(r[key] * r["calls"] for r in rs)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name],
            "launches": launches_of[path_of[name]][name],
            "max_abs_err": max_err[name], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes"] / HBM_BYTES_PER_S
                         >= tot["ops"] / PEAK_OPS["bfloat16"] else "operations"),
            "library_ms": tot["library_ms"],
        })
    # K5, K6, K7 and K4 summed over phase 10's calls (and their launches
    # there): K7 at (256, 65536), K4 the f32 product
    reg_replaces = {"bp_scan": "src/repro/kernels/bp_scan.py:26",
                    "bi_transpose": "src/repro/kernels/bi_transpose.py:24",
                    "bi_fft": "src/repro/kernels/bi_fft.py:51",
                    "strassen_matmul": "src/repro/kernels/strassen_matmul.py:58"}
    for name in registry_kernels:
        rs = [r for r in reg_rows if r["kernel"] == name]
        tot = {key: sum(r[key] for r in rs)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": reg_replaces[name], "launches": reg_launches[name],
            "max_abs_err": max_err[name], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes"] / HBM_BYTES_PER_S
                         >= tot["ops"] / PEAK_OPS["float32"] else "operations"),
            "library_ms": tot["library_ms"],
        })
    # the batched K2 over one qwen3-moe-30b-a3b decode step's 144 calls, its
    # launches from phase 11's bf16 engine run
    entries.append({
        "name": "hbp_matmul_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hbp_matmul.cu",
        "replaces": "src/repro/kernels/hbp_matmul.py:33", "launches": moe["launches"],
        "max_abs_err": max_err["hbp_matmul_batched"], "ms": moe["ms"],
        "plain_ms": moe["plain_ms"], "bound_ms": moe["bound_ms"],
        "bound_by": ("bytes" if moe["bytes"] / HBM_BYTES_PER_S
                     >= moe["ops"] / PEAK_OPS["bfloat16"] else "operations"),
        "library_ms": moe["library_ms"],
    })
    # the attention kernels at hd 256 (phase 12): K1 and K1q over one
    # gemma3-1b decode step's 26 calls (their launches from the bf16 and the
    # int8 engine run), K3 over one training step's (its launches from the
    # training run)
    hd256_source = {"flash_attention_hd256": ("flash_attention", "flash_attention"),
                    "flash_attention_int8_hd256": ("flash_attention", "flash_attention_int8"),
                    "flash_attention_bwd_hd256": ("flash_attention_bwd", "flash_attention_bwd")}
    for name in HD256:
        t, (src, kernel) = hd256[name], hd256_source[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces[kernel], "launches": t["launches"],
            "max_abs_err": max_err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / PEAK_OPS["bfloat16"] else "operations"),
            "library_ms": t["library_ms"],
        })
    # K1 over one recurrentgemma-2b decode step's 8 calls (its launches from
    # phase 14's engine run), K3 over one training step's 8 (its launches
    # from phase 14's training run)
    for name, key, kernel in (("flash_attention_hd256_recurrentgemma", "k1", "flash_attention"),
                              ("flash_attention_bwd_hd256_recurrentgemma", "k3",
                               "flash_attention_bwd")):
        t = rec[key]
        entries.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{kernel}.cu",
            "replaces": replaces[kernel], "launches": t["launches"],
            "max_abs_err": max_err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / PEAK_OPS["bfloat16"] else "operations"),
            "library_ms": t["library_ms"],
        })
    # the batched K2's backward over one phase-13 step's 6 x depth calls, its
    # launches from phase 13's run (every attempt of every step)
    entries.append({
        "name": "hbp_matmul_batched_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hbp_matmul.cu",
        "replaces": "src/repro/kernels/hbp_matmul.py:33", "launches": moe_bwd["launches"],
        "max_abs_err": max_err["hbp_matmul_batched_bwd"], "ms": moe_bwd["ms"],
        "plain_ms": moe_bwd["plain_ms"], "bound_ms": moe_bwd["bound_ms"],
        "bound_by": ("bytes" if moe_bwd["bytes"] / HBM_BYTES_PER_S
                     >= moe_bwd["ops"] / PEAK_OPS["bfloat16"] else "operations"),
        "library_ms": moe_bwd["library_ms"],
    })
    # phase 15: K1 over one seamless-m4t-large-v2 decode step's 24 and one
    # llama-3.2-vision-90b (10-layer) decode step's 2 cross-attention calls
    # (their launches from the engine runs), K3 over one seamless training
    # step's 72 calls and K2's wmma instance over its head's 4 backward
    # products (their launches from the training run)
    for name, key, kernel, src in (
            ("flash_attention_cross_seamless", "k1_seamless", "flash_attention",
             "flash_attention"),
            ("flash_attention_cross_vlm", "k1_vlm", "flash_attention", "flash_attention"),
            ("flash_attention_bwd_cross", "k3", "flash_attention_bwd", "flash_attention_bwd"),
            ("hbp_matmul_wmma", "wmma", "hbp_matmul", "hbp_matmul")):
        t = cross[key]
        entries.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces[kernel], "launches": t["launches"],
            "max_abs_err": max_err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / PEAK_OPS["bfloat16"] else "operations"),
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
